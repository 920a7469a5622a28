// Shared pieces of the fp32 flash-attention kernels for Hopper (sm_90a):
// attn_fwd_f32_sm90.cu (B1), attn_dq_f32_sm90.cu (B2a), attn_dkv_f32_sm90.cu
// (B2b). The function is the one written in fused_attention.cu's header.
//
// fp32-grade products on the tensor cores (3xTF32). Every fp32 operand x is
// split into hi = cvt.rna.tf32(x) (10 mantissa bits, nearest, ties away)
// and lo = cvt.rna.tf32(x - hi), and each product is taken as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first, into fp32 sums:
// what is left out, lo_a.lo_b and the rounding of lo, is ~2^-21 of the
// product, where one TF32 product (1xTF32) keeps ~2^-11
// (ops/fused_attention.py:tf32_split_plain is the CPU model;
// tests/test_torch_tf32x3.py holds both against JAX's exact attention).
//
// Operand layout decides the route to the tensor cores:
//   * products whose operands are both K-major in the model's layout
//     (S = Q.K^T, dP = dO.V^T; S^T = K.Q^T and dP^T = V.dO^T in the dk/dv
//     kernel) run on wgmma m64nNk8 .tf32 with both operands in 128B-swizzled
//     shared memory (wgmma reads .tf32 operands K-major only: the transpose
//     bits exist for 16-bit types alone). The tiles arrive by TMA; three
//     "split" warps of the producer warpgroup round each tile to hi in place
//     and write its lo into a twin tile of the same layout, then release it
//     to the consumers (fence.proxy.async + an mbarrier), so the consumers
//     issue three wgmma chains (lo.hi, hi.lo, hi.hi) and convert nothing;
//   * the products whose right operand is row-major in the model's layout
//     (P.V, dS.K, P^T.dO, dS^T.Q) take their left operand from the
//     accumulator of the previous wgmma, in place: in each 8-column chunk an
//     accumulator thread holds columns 2t and 2t + 1, where the k8 A
//     fragment wants t and t + 4, so the chunk's reduction index is permuted
//     (A column t <- 2t, t + 4 <- 2t + 1) and the right operand's rows are
//     taken in the same order. Two ways, chosen by timed design calls
//     (PERF.md): (a) wgmma with A in registers over a K-major transpose of
//     the right operand that the split warps write, permuted and split
//     (split_transpose; B1's P.V and B2a's dS.K at D 64); (b) mma.sync
//     m16n8k8 .tf32 with the B fragments read straight from the swizzled
//     row-major tile, rows 8c + 2t and 8c + 2t + 1, column 8n + g
//     (conflict-free: the lanes' eight chunks are distinct after the
//     swizzle), hi and lo from the split tiles or from a cvt in registers
//     (B2b, and B1 / B2a at D 128, whose rings have no room for the
//     transposed tiles).
//
// Block shape: kWG consumer warpgroups (64 rows each) and one producer
// warpgroup: its first warp's first lane keeps the TMA loads in flight
// through a ring of stages, its other three warps split the tiles.
// Barriers per stage: full (TMA bytes arrived), ready (split done, 96
// arrivals), empty (every consumer warp done).

#pragma once

#include <math.h>
#include <stdint.h>

#include "attn_sm90.cuh"

namespace bllm {
namespace attn {
namespace f32 {

using namespace sm90;

using sm90k::exp2_approx;
using sm90k::kLn2;
using sm90k::kLog2e;
using sm90k::launch;
using sm90k::smem_base;
using sm90k::zero;

constexpr int kSplitThreads = 96;   // warps 1-3 of the producer warpgroup

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (16x8, fp32) += a (16x8) . b (8x8), TF32 operands
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 on one k8 step into n-tile nt of an accumulator in the wgmma
// fragment layout (elements 4 nt .. 4 nt + 3). The tensor cores add into
// their fp32 accumulator rounding toward zero, a bias that grows with the
// length of the chain: over the 3 T G / 8 steps of a long dk/dv sum it
// reached 6.6e-5 of the result (T 2048, G 4), over the 5e-5 bound. So each
// step's three products go into a fresh accumulator, which is added into
// the running sum on the CUDA cores (rounded to nearest).
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N], int nt, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
  mma_tf32(t0, t1, t2, t3, al, bh0, bh1);
  mma_tf32(t0, t1, t2, t3, ah, bl0, bl1);
  mma_tf32(t0, t1, t2, t3, ah, bh0, bh1);
  d[4 * nt] += t0;
  d[4 * nt + 1] += t1;
  d[4 * nt + 2] += t2;
  d[4 * nt + 3] += t3;
}

// 8-column chunk c of an accumulator (64 x N, this warp's 16 rows) as the
// (hi, lo) k8 A fragments, columns permuted: A column t <- 2t, t + 4 <- 2t + 1
template <int NA>
__device__ __forceinline__ void acc_to_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                         const float (&d)[NA], int c) {
  const float x[4] = {d[4 * c], d[4 * c + 2], d[4 * c + 1], d[4 * c + 3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ah[e] = tf32_hi(x[e]);
    al[e] = tf32_lo(x[e], ah[e]);
  }
}

// byte offset of element (r, col) of a ROWS-row fp32 tile in 128B-swizzled
// panels of 32 columns (the panel ROWS x 128 bytes; the 16-byte chunk index
// XOR the row's low three bits)
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int col) {
  return static_cast<uint32_t>((col >> 5) * ROWS * 128 + r * 128 +
                               ((((col >> 2) & 7) ^ (r & 7)) << 4) + (col & 3) * 4);
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(p + off);
}

// ROWS consecutive positions of head h of batch row b, all D fp32 columns,
// as D / 32 swizzled panels of ROWS x 128 bytes
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int t0, int b) {
#pragma unroll
  for (int p = 0; p < D / 32; ++p) tma_load_4d(dst + p * ROWS * 128, map, bar, p * 32, h, t0, b);
}

// descriptor of k-step kk (8 fp32 columns of the reduction dim) of a K-major
// tile of ROWS rows from row r0 (a multiple of 8): four k-steps a panel
template <int ROWS>
__device__ __forceinline__ uint64_t kstep(const unsigned char* tile, int r0, int kk) {
  return desc_kmajor(tile + (kk >> 2) * ROWS * 128 + r0 * 128 + (kk & 3) * 32);
}

// split warps: round `bytes` of a landed tile to TF32 in place (hi) and
// write lo at the same offsets of `lo`, then make both visible to wgmma
__device__ __forceinline__ void split_tile(unsigned char* tile, unsigned char* lo, uint32_t bytes,
                                           int tid) {
  uint4* x4 = reinterpret_cast<uint4*>(tile);
  uint4* l4 = reinterpret_cast<uint4*>(lo);
  for (uint32_t w = tid; w < bytes / 16; w += kSplitThreads) {
    const uint4 x = x4[w];
    uint4 h, l;
    h.x = tf32_hi(__uint_as_float(x.x));
    h.y = tf32_hi(__uint_as_float(x.y));
    h.z = tf32_hi(__uint_as_float(x.z));
    h.w = tf32_hi(__uint_as_float(x.w));
    l.x = tf32_lo(__uint_as_float(x.x), h.x);
    l.y = tf32_lo(__uint_as_float(x.y), h.y);
    l.z = tf32_lo(__uint_as_float(x.z), h.z);
    l.w = tf32_lo(__uint_as_float(x.w), h.w);
    x4[w] = h;
    l4[w] = l;
  }
}

// a barrier of the split warps alone (named barrier 1): a transpose must
// have read every raw word of a tile before any split warp rounds it in place
__device__ __forceinline__ void split_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSplitThreads) : "memory");
}

// the split warps' release of a stage: every split thread fences its own
// writes into the async proxy and arrives (the barrier counts 96)
__device__ __forceinline__ void split_done(uint64_t* ready) {
  fence_proxy_async();
  mbar_arrive(ready);
}

// D (+)= A . B on wgmma with A in registers (the tf32 A fragment of each
// warp's 16 rows is mma.sync m16n8k8's) and B K-major in shared memory
template <int N> struct WgmmaRSTF32;

// D(64x64) (+)= A(64x8, registers) . B(8x64, shared, K-major), TF32
template <> struct WgmmaRSTF32<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// D (64 x N, this warpgroup's rows r0 .. r0 + 63 of A) = A . B^T, 3xTF32:
// A / B hi in aH / bH (split in place), lo in aL / bL; the three chains
// lo.hi, hi.lo, hi.hi over the D / 8 k-steps are issued, the caller commits
// and waits
template <int D, int AROWS, int N>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[N / 2], const unsigned char* aH,
                                             const unsigned char* aL, int r0,
                                             const unsigned char* bH, const unsigned char* bL) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    WgmmaTF32<N>::run(d, kstep<AROWS>(aL, r0, kk), kstep<N>(bH, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    WgmmaTF32<N>::run(d, kstep<AROWS>(aH, r0, kk), kstep<N>(bL, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    WgmmaTF32<N>::run(d, kstep<AROWS>(aH, r0, kk), kstep<N>(bH, 0, kk), 1);
}

// acc (16 x D per warp, the wgmma fragment layout) += A (this warp's 16
// rows x the tile's BR reduction rows, an accumulator `a`, columns permuted)
// . B (BR x D, the row-major swizzled tile bH, lo in bL or, when bL is
// null, taken in registers), 3xTF32 on mma.sync
template <int D, int BR>
__device__ __forceinline__ void mma_acc_tile(float (&acc)[D / 2], const float (&a)[BR / 2],
                                             const unsigned char* bH, const unsigned char* bL) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < BR / 8; ++c) {
    uint32_t ah[4], al[4];
    acc_to_a(ah, al, a, c);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const uint32_t o0 = swz<BR>(8 * c + 2 * t, 8 * nt + g);
      const uint32_t o1 = swz<BR>(8 * c + 2 * t + 1, 8 * nt + g);
      uint32_t bh0 = ld_u32(bH, o0), bh1 = ld_u32(bH, o1), bl0, bl1;
      if (bL != nullptr) {
        bl0 = ld_u32(bL, o0);
        bl1 = ld_u32(bL, o1);
      } else {
        const float x0 = __uint_as_float(bh0), x1 = __uint_as_float(bh1);
        bh0 = tf32_hi(x0);
        bh1 = tf32_hi(x1);
        bl0 = tf32_lo(x0, bh0);
        bl1 = tf32_lo(x1, bh1);
      }
      mma_3xtf32(acc, nt, ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// split warps: the K-major transpose of a landed row-major tile X (BR rows
// of D columns) for the accumulator-as-A products: XT[n][8c + x] =
// X[8c + perm(x)][n] with perm(x) = 2x (x < 4), 2 (x - 4) + 1, rounded to
// hi (th) and lo (tl), each D rows of BR columns in 128B-swizzled panels. A
// lane takes one column of XT: its 16-byte reads cover the eight chunk
// slots (four lanes each), its writes one XT row's 32 consecutive words.
template <int D, int BR>
__device__ __forceinline__ void split_transpose(const unsigned char* x, unsigned char* th,
                                               unsigned char* tl, int tid) {
  const int lane = tid & 31, w = tid >> 5;
  static_assert(BR % 32 == 0, "XT rows are whole 128-byte panels");
  for (int item = w; item < (BR / 32) * (D / 4); item += kSplitThreads / 32) {
    const int p = item / (D / 4), d4 = item % (D / 4);
    const int kp = 32 * p + lane, e8 = kp & 7;
    const int r = (kp & ~7) + (e8 < 4 ? 2 * e8 : 2 * (e8 - 4) + 1);
    const uint4 v = *reinterpret_cast<const uint4*>(x + swz<BR>(r, 4 * d4));
    const uint32_t e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = __uint_as_float(e4[e]);
      const uint32_t h = tf32_hi(f);
      const uint32_t off = swz<D>(4 * d4 + e, kp);
      *reinterpret_cast<uint32_t*>(th + off) = h;
      *reinterpret_cast<uint32_t*>(tl + off) = tf32_lo(f, h);
    }
  }
}

// acc (64 x D, the warpgroup's) += A (64 x BR, an accumulator `a`, columns
// permuted) . X (BR x D) on wgmma, 3xTF32, X given as its split K-major
// transpose (split_transpose): A from registers, X^T hi / lo from shared
// memory; the products go straight into acc (a chain of 3 BR / 8 steps a
// tile: the forward's and dq's sums, where the tensor cores' rounding
// toward zero stays near 1e-6 of the result at T 2048). Waits for them.
template <int D, int BR>
__device__ __forceinline__ void wgmma_acc_rs(float (&acc)[D / 2], const float (&a)[BR / 2],
                                             const unsigned char* th, const unsigned char* tl) {
  uint32_t ah[BR / 8][4], al[BR / 8][4];
#pragma unroll
  for (int c = 0; c < BR / 8; ++c) acc_to_a(ah[c], al[c], a, c);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < BR / 8; ++c) WgmmaRSTF32<D>::run(acc, al[c], kstep<D>(th, 0, c), 1);
#pragma unroll
  for (int c = 0; c < BR / 8; ++c) WgmmaRSTF32<D>::run(acc, ah[c], kstep<D>(tl, 0, c), 1);
#pragma unroll
  for (int c = 0; c < BR / 8; ++c) WgmmaRSTF32<D>::run(acc, ah[c], kstep<D>(th, 0, c), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(ah);
  fence_regs(al);
}

// write a warpgroup's (64 x D) fp32 fragments, times mul[rr], as fp32 rows:
// fragment row rr of this thread goes to dst + rr * 8 * row_stride
template <int D>
__device__ __forceinline__ void store_rows(const float (&d)[D / 2], const float (&mul)[2],
                                           float* __restrict__ dst, size_t row_stride) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* row = dst + rr * 8 * row_stride;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8 + 2 * t) =
          make_float2(d[4 * nt + 2 * rr] * mul[rr], d[4 * nt + 2 * rr + 1] * mul[rr]);
  }
}

}  // namespace f32
}  // namespace attn
}  // namespace bllm
