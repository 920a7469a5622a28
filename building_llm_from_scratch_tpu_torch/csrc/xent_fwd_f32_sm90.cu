// B4 for fp32 on Hopper (sm_90a): the vocab-streamed cross-entropy forward,
// its products 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel of building_llm_from_scratch_tpu/ops/
// xent_fwd_pallas.py (_kernel, called through xent_fwd) for fp32, the
// trainer's default dtype; bf16 and fp16 go to xent_fwd_sm90.cu, whose
// function this is: for hidden states x (N, D), the head W (D, V) and
// targets (N,), the fp32 logits x.W tile by tile, columns past V masked to
// -1e30, an online max and sum of exp per row, the target logit picked; only
// (nll, lse) per row reach device memory, never the (N, V) logits.
//
// What bounds it: operations. At GPT-2-124M's B 8 x T 1024 (N 8192, D 768,
// V 50257) the product is 2 N D V = 632 GFLOP; at fp32 grade the tensor
// cores give a third of their TF32 rate (495 / 3 = 165 TFLOP/s), 3.83 ms,
// over ~180 MB of fp32 inputs.
//
// Design:
//   * 3xTF32 as in the fp32 flash kernels (hopper.cuh): hi =
//     cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), each product lo.hi +
//     hi.lo + hi.hi, the small terms first.
//   * wgmma reads .tf32 operands K-major only. x (N, D) is K-major; W (D, V)
//     is not. A split pass writes, once per call, W's transpose split into
//     hi and lo, (2, V, D), and x split, (2, N, D), so that every element is
//     rounded once: split warps inside the product kernel would round each
//     element of W once per row block (64 times at N 8192) and each element
//     of x once per vocab tile. The rows of W's transpose are D * 4 bytes
//     apart, a pitch TMA takes at any V, so W is never padded; the rows past
//     V (and past N) are TMA's zero fill, masked in the epilogue.
//   * The product kernel has xent_fwd_sm90.cu's shape: a block owns 128 rows
//     and one share of the vocabulary's kBN-column tiles; a producer warp
//     streams, per tile and per 32-deep slice of D, four 128B-swizzled
//     panels by TMA (x hi, x lo: 128 rows; W^T hi, lo: kBN rows) into a ring
//     of stages; two consumer warpgroups of 64 rows each issue the three
//     chains on wgmma m64nNk8 .tf32 into a 64 x kBN fp32 accumulator. The
//     ring takes 192 KB, so one block an SM; its plan
//     (ops/xent_fwd.f32_plan) keeps the grid within one wave.
//   * The tensor cores add into fp32 rounding toward zero; here a tile's sum
//     is a chain of 3 D / 8 steps (288 at D 768), whose bias stays near
//     1e-6 of the logits, well inside lse's 1e-5 bound (the dk/dv sum of the
//     fp32 flash kernels, ten times longer, needed fresh accumulators).
//   * Epilogue and partials as in xent_fwd_sm90.cu (mask, online max and
//     exp2 sum per thread, the target logit, the 4 lanes of a row merged at
//     the end); its combine finishes the rows (xent_combine.cuh).
//   Timed at GPT-2's shape (scripts/train_kernel_timing.py on an H100):
//   5.6-5.8 ms a call, the split pass 0.21 of it; 128 x 256 tiles (two
//   stages fit) 7.4; x split inside this kernel by three warps of the
//   producer warpgroup 6.0-6.1: their shared-memory traffic joins wgmma's
//   operand reads, which already take most of the SM's shared-memory rate.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after its launches, 100000 for what it does not take,
// 100001 if the driver refuses a tensor map.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "xent_combine.cuh"

namespace {

using namespace bllm::sm90;
using bllm::xent::kNegBig;

constexpr int kUnsupported = 100000;
constexpr int kNoTensorMap = 100001;
constexpr int kThreads = 288;          // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarp = 8;
constexpr int kBM = 128;               // rows of a block
constexpr int kBN = 128;               // vocab columns of a tile
constexpr int kBK = 32;                // depth of a slice: one 128-byte panel
constexpr uint32_t kXBytes = kBM * kBK * 4;            // x hi or lo panel
constexpr uint32_t kWBytes = kBN * kBK * 4;            // W^T hi or lo panel
constexpr uint32_t kStageBytes = 2 * kXBytes + 2 * kWBytes;
constexpr int kStages = (192 * 1024) / kStageBytes;
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSplitThreads = 256;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x (n4 float4s) -> hi, lo of the same layout
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float4* __restrict__ x, float4* __restrict__ hi, float4* __restrict__ lo,
             long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kSplitThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kSplitThreads) {
    const float4 v = x[i];
    const uint32_t h[4] = {tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w)};
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(tf32_lo(v.x, h[0])), __uint_as_float(tf32_lo(v.y, h[1])),
                        __uint_as_float(tf32_lo(v.z, h[2])), __uint_as_float(tf32_lo(v.w, h[3])));
  }
}

// W (D, V) -> W^T's hi and lo, (V, D): a block moves a 32 x 32 tile through
// shared memory, reading rows of W and writing rows of W^T, 128 bytes a warp
__global__ void __launch_bounds__(256)
split_transpose_kernel(const float* __restrict__ w, float* __restrict__ hi,
                       float* __restrict__ lo, int D, int V) {
  __shared__ float tile[32][33];
  const int v0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = v0 + tx < V ? w[static_cast<size_t>(d0 + i) * V + v0 + tx] : 0.f;
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    if (v0 + i < V) {
      const float f = tile[tx][i];
      const uint32_t h = tf32_hi(f);
      const size_t at = static_cast<size_t>(v0 + i) * D + d0 + tx;
      hi[at] = __uint_as_float(h);
      lo[at] = __uint_as_float(tf32_lo(f, h));
    }
  }
}

// k-step kk (8 fp32 columns) of a K-major panel from row r0 (a multiple of 8)
__device__ __forceinline__ uint64_t kstep(const unsigned char* panel, int r0, int kk) {
  return desc_kmajor(panel + r0 * 128 + kk * 32);
}

__global__ void __launch_bounds__(kThreads, 1)
xent_f32_kernel(const __grid_constant__ CUtensorMap tmXh, const __grid_constant__ CUtensorMap tmXl,
                const __grid_constant__ CUtensorMap tmWh, const __grid_constant__ CUtensorMap tmWl,
                const long long* __restrict__ targets, float* __restrict__ m_part,
                float* __restrict__ s_part, float* __restrict__ tl, int N, int D, int V,
                int n_tiles, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int rbase = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);
  const int n_k = D / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    if (lane == 0) {
      int it = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile) {
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          unsigned char* st = ring + s * kStageBytes;
          tma_load_2d(st, &tmXh, &full[s], ks * kBK, rbase);
          tma_load_2d(st + kXBytes, &tmXl, &full[s], ks * kBK, rbase);
          tma_load_2d(st + 2 * kXBytes, &tmWh, &full[s], ks * kBK, tile * kBN);
          tma_load_2d(st + 2 * kXBytes + kWBytes, &tmWl, &full[s], ks * kBK, tile * kBN);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = rbase + wg * 64 + 16 * (warp & 3) + g;   // fragment row rr = 0; rr = 1 is + 8
  long long tgt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) tgt[rr] = row0 + 8 * rr < N ? targets[row0 + 8 * rr] : -1;
  // this thread's running max and sum over its own columns
  float m[2] = {kNegBig, kNegBig}, sum[2] = {0.f, 0.f};

  int it = 0;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int ks = 0; ks < n_k; ++ks, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* xh = ring + s * kStageBytes;
      const unsigned char* xl = xh + kXBytes;
      const unsigned char* wh = xh + 2 * kXBytes;
      const unsigned char* wl = wh + kWBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        WgmmaTF32<kBN>::run(acc, kstep(xl, wg * 64, kk), kstep(wh, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        WgmmaTF32<kBN>::run(acc, kstep(xh, wg * 64, kk), kstep(wl, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        WgmmaTF32<kBN>::run(acc, kstep(xh, wg * 64, kk), kstep(wh, 0, kk), 1);
      wgmma_commit();
      wgmma_wait_one();   // the previous slice's products are done: free its stage
      fence_regs(acc);
      if (ks > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: fragment i is row 8 ((i >> 1) & 1) + row0, column
    // 8 (i >> 2) + 2 t + (i & 1) of the tile
    const int c0 = tile * kBN;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegBig;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& z = acc[4 * nt + 2 * rr + e];
          if (c0 + nt * 8 + 2 * t + e >= V) z = kNegBig;   // past the vocabulary
          mx = fmaxf(mx, z);
        }
      const float m_new = fmaxf(m[rr], mx);
      const float mb = m_new * kLog2e;
      float ssum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
        ssum += exp2_approx(fmaf(acc[4 * nt + 2 * rr], kLog2e, -mb)) +
                exp2_approx(fmaf(acc[4 * nt + 2 * rr + 1], kLog2e, -mb));
      sum[rr] = fmaf(sum[rr], exp2_approx((m[rr] - m_new) * kLog2e), ssum);
      m[rr] = m_new;

      // the lane holding the target column writes its logit (constant
      // fragment indices only, so acc stays in registers)
      const long long local = tgt[rr] - c0;
      if (local >= 0 && local < kBN && ((local >> 1) & 3) == t) {
        const int nt = static_cast<int>(local >> 3);
        const bool odd = (local & 1) != 0;
#pragma unroll
        for (int n2 = 0; n2 < kBN / 8; ++n2)
          if (n2 == nt) tl[row0 + 8 * rr] = odd ? acc[4 * n2 + 2 * rr + 1] : acc[4 * n2 + 2 * rr];
      }
    }
  }

  // merge the 4 lanes of each row (a lane whose columns were all masked has
  // m = -1e30 and weighs nothing), then write the block's partial
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float M = m[rr];
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 1));
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
    float S = sum[rr] * exp2_approx((m[rr] - M) * kLog2e);
    S += __shfl_xor_sync(0xffffffffu, S, 1);
    S += __shfl_xor_sync(0xffffffffu, S, 2);
    const int row = row0 + 8 * rr;
    if (t == 0 && row < N) {
      m_part[static_cast<size_t>(split) * N + row] = M;
      s_part[static_cast<size_t>(split) * N + row] = S;
    }
  }
}

}  // namespace

extern "C" {

// x (N, D) and w (D, V) in float32, contiguous, x 16-byte aligned,
// D % 32 == 0; xs (2, N, D) and wt (2, V, D) fp32 scratch (the split pass
// writes them); targets (N,) int64; m_part, s_part (splits, N) fp32
// scratch; tl (N,) fp32 filled with -1e30 by the caller; nll, lse (N,) fp32
// outputs. ``splits`` must be the number of vocab shares of
// ceil(ceil(V / 128) / splits) tiles each (ops/xent_fwd.f32_plan).
int bllm_xent_fwd_f32_sm90(int N, int D, int V, int splits, const void* x, const void* w,
                           void* xs, void* wt, const void* targets, void* m_part, void* s_part,
                           void* tl, void* nll, void* lse, void* stream) {
  if (N < 1 || D < kBK || D % kBK != 0 || V < 1 || splits < 1 || splits > 65535 ||
      D / 32 > 65535)
    return kUnsupported;
  const int n_tiles = (V + kBN - 1) / kBN;
  const int per = (n_tiles + splits - 1) / splits;
  if ((n_tiles + per - 1) / per != splits) return kUnsupported;   // every split owns a tile
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xh = static_cast<float*>(xs);
  float* xl = xh + static_cast<size_t>(N) * D;
  float* wh = static_cast<float*>(wt);
  float* wl = wh + static_cast<size_t>(V) * D;

  const long long n4 = static_cast<long long>(N) * D / 4;
  long long blocks = (n4 + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  split_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0, s>>>(
      static_cast<const float4*>(x), reinterpret_cast<float4*>(xh), reinterpret_cast<float4*>(xl),
      n4);
  split_transpose_kernel<<<dim3((V + 31) / 32, D / 32), 256, 0, s>>>(static_cast<const float*>(w),
                                                                    wh, wl, D, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr CUtensorMapDataType f = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap txh, txl, twh, twl;
  if (!make_2d_map(&txh, f, 4, xh, N, D, kBM) || !make_2d_map(&txl, f, 4, xl, N, D, kBM) ||
      !make_2d_map(&twh, f, 4, wh, V, D, kBN) || !make_2d_map(&twl, f, 4, wl, V, D, kBN))
    return kNoTensorMap;
  err = cudaFuncSetAttribute(xent_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_f32_kernel<<<dim3((N + kBM - 1) / kBM, splits), kThreads, kSmem, s>>>(
      txh, txl, twh, twl, static_cast<const long long*>(targets), static_cast<float*>(m_part),
      static_cast<float*>(s_part), static_cast<float*>(tl), N, D, V, n_tiles, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return bllm::xent::combine(static_cast<float*>(m_part), static_cast<float*>(s_part),
                             static_cast<float*>(tl), static_cast<float*>(nll),
                             static_cast<float*>(lse), N, splits, s);
}

}  // extern "C"
