// Philox4x32-10, the counter-based generator every dropout site of the port
// draws its keep mask from (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC 2011; the constants of Random123's philox4x32).
//
// The TPU kernels reseed the core's own generator per tile (ops/
// fused_attention.py:_keep_mask, ops/fused_dropout.py:_tile_keep). Here a
// keep bit is a pure function of a 64-bit seed and the element's own
// coordinates, so kernels that tile the same tensor differently (the
// attention forward, dq and dk/dv kernels) and the plain PyTorch version
// (ops/philox.py, the same function on int64 tensors) draw the same mask,
// bit for bit, with nothing mask-shaped stored.
//
// Keep means word >= threshold, compared as uint32, with threshold =
// min(int(rate * 2^32), 2^32 - 1) computed by the wrapper.
//
// Counters (each call gives four 32-bit words):
//   attention element (b, h, q, k): counter (k >> 1, q >> 1, h, b), word
//     2 * (q & 1) + (k & 1): one call covers a 2x2 quad of (q, k), which
//     two lanes of an mma fragment share (attn_keep_rows / _cols below);
//   flat element i of a dropout tensor: counter (i >> 2 low word, i >> 2
//     high word, 0, 0), word i & 3.

#pragma once

#include <stdint.h>

namespace bllm {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The attention kernels hold scores in mma fragments: a lane holds rows r
// and r + 8 of a 16-row tile at two neighbouring columns, and lane ^ 4 holds
// rows r ^ 1 and (r + 8) ^ 1 at the same columns. Each 2x2 quad of the
// counter (rows 2a, 2a + 1; columns 2c, 2c + 1) therefore lies across those
// two lanes. They split the work: the lane of the even row draws the quad of
// its first row, the lane of the odd row the quad of its second, and each
// hands the other the two words of its row by one shuffle each. One Philox
// call per quad; the bits are those of keep(b, h, q, k) above.

// fragment rows are queries q0 (even or odd: `odd`) and q0 + 8, columns the
// keys k and k + 1 (k even): keep[rr][e] for (q0 + 8 rr, k + e)
__device__ __forceinline__ void attn_keep_rows(bool (&keep)[2][2], uint32_t s0, uint32_t s1,
                                               uint32_t threshold, int b, int h, int q0, int k,
                                               bool odd) {
  const int qc = odd ? q0 + 8 : q0;
  const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(k >> 1),
                                           static_cast<uint32_t>(qc >> 1),
                                           static_cast<uint32_t>(h),
                                           static_cast<uint32_t>(b)),
                                s0, s1);
  // the even query of a quad takes words x, y; the odd one z, w
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 4);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 4);
  keep[0][0] = (odd ? got0 : r.x) >= threshold;
  keep[0][1] = (odd ? got1 : r.y) >= threshold;
  keep[1][0] = (odd ? r.z : got0) >= threshold;
  keep[1][1] = (odd ? r.w : got1) >= threshold;
}

// fragment rows are keys k0 (`odd` or even) and k0 + 8, columns the queries
// q and q + 1 (q even), as in the dk/dv kernels' transposed scores:
// keep[rr][e] for (q + e, k0 + 8 rr)
__device__ __forceinline__ void attn_keep_cols(bool (&keep)[2][2], uint32_t s0, uint32_t s1,
                                               uint32_t threshold, int b, int h, int q, int k0,
                                               bool odd) {
  const int kc = odd ? k0 + 8 : k0;
  const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(kc >> 1),
                                           static_cast<uint32_t>(q >> 1),
                                           static_cast<uint32_t>(h),
                                           static_cast<uint32_t>(b)),
                                s0, s1);
  // the even key of a quad takes words x (query q), z (q + 1); the odd y, w
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.y, 4);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.z : r.w, 4);
  keep[0][0] = (odd ? got0 : r.x) >= threshold;
  keep[0][1] = (odd ? got1 : r.z) >= threshold;
  keep[1][0] = (odd ? r.y : got0) >= threshold;
  keep[1][1] = (odd ? r.w : got1) >= threshold;
}

// the four words of flat elements 4 * group ... 4 * group + 3
__device__ __forceinline__ uint4 flat_bits(uint32_t s0, uint32_t s1, uint64_t group) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(group >> 32), 0u, 0u),
                       s0, s1);
}

}  // namespace bllm
