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
//     2 * (q & 1) + (k & 1), so a pair of neighbouring keys of one query row
//     (the forward and dq fragments) and a pair of neighbouring queries of
//     one key row (the dk/dv fragments) each take one call;
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

// keep bits of the attention elements (b, h, q, k) and (b, h, q, k + 1), k
// even: the forward's and dq's pair along a query row
__device__ __forceinline__ void attn_keep_keys(bool (&keep)[2], uint32_t s0, uint32_t s1,
                                               uint32_t threshold, int b, int h, int q, int k) {
  const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(k >> 1),
                                           static_cast<uint32_t>(q >> 1),
                                           static_cast<uint32_t>(h),
                                           static_cast<uint32_t>(b)),
                                s0, s1);
  const int w = 2 * (q & 1);
  keep[0] = philox_word(r, w) >= threshold;
  keep[1] = philox_word(r, w + 1) >= threshold;
}

// keep bits of (b, h, q, k) and (b, h, q + 1, k), q even: dk/dv's pair
// along a key row
__device__ __forceinline__ void attn_keep_queries(bool (&keep)[2], uint32_t s0, uint32_t s1,
                                                  uint32_t threshold, int b, int h, int q,
                                                  int k) {
  const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(k >> 1),
                                           static_cast<uint32_t>(q >> 1),
                                           static_cast<uint32_t>(h),
                                           static_cast<uint32_t>(b)),
                                s0, s1);
  keep[0] = philox_word(r, k & 1) >= threshold;
  keep[1] = philox_word(r, 2 + (k & 1)) >= threshold;
}

// the four words of flat elements 4 * group ... 4 * group + 3
__device__ __forceinline__ uint4 flat_bits(uint32_t s0, uint32_t s1, uint64_t group) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(group >> 32), 0u, 0u),
                       s0, s1);
}

}  // namespace bllm
