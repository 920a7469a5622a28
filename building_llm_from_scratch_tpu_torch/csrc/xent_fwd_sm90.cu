// B4 for 16-bit types on Hopper (sm_90a): the vocab-streamed cross-entropy
// forward on TMA and wgmma.
//
// Replaces the TPU kernel of building_llm_from_scratch_tpu/ops/
// xent_fwd_pallas.py (_kernel, called through xent_fwd) for bf16 and fp16;
// fp32 goes to xent_fwd_f32_sm90.cu (3xTF32). The function: for hidden states
// x (N, D), the head W (D, V) and targets (N,), the fp32 logits x.W tile by
// tile, columns past V masked to -1e30, an online max and sum of exp in
// fp32 per row, the target logit picked; only (nll, lse) per row reach
// device memory, never the (N, V) logits.
//
// What bounds it: operations. At GPT-2-124M's B 8 x T 1024 (N 8192, D 768,
// V 50257) the product is 2 N D V = 632 GFLOP, 0.639 ms at 989 TFLOP/s,
// over ~90 MB of inputs; the epilogue adds ~412 M exponentials (MUFU).
//
// Design:
//   * W is made TMA-legal by the wrapper (ops/xent_fwd.py): its columns are
//     padded to Vp, a multiple of 8, so the row pitch is a multiple of 16
//     bytes. The mask keeps col >= V, the true V; TMA's zero fill covers
//     the ragged last tile and the rows past N.
//   * A block owns 128 rows and one share of the vocabulary's 128-column
//     tiles (grid (N / 128, splits), the plan keeping every block resident
//     at two blocks an SM). A producer warp streams, per tile and per
//     64-deep slice of D, x's K-major 128 x 64 panel and W's MN-major
//     64 x 128 slab (two 64-column panels) by TMA, 128-byte swizzled, into
//     a 3-stage mbarrier ring. x (12.6 MB at GPT-2) does not fit beside a
//     ring, so its panels are streamed with W's and come from L2.
//   * Two consumer warpgroups of 64 rows each run wgmma m64n128k16 into a
//     64 x 128 fp32 accumulator, W read MN-major through the descriptor
//     (nothing is transposed); one slice's products are in flight while the
//     previous slice's stage is released.
//   * Epilogue per tile, from the accumulator fragments: mask, the thread's
//     running max over its columns, and the exp sum with log2(e) folded
//     into one FMA of each exponent (ex2.approx); the lane holding the
//     target column writes its logit. Each thread keeps its own (max, sum);
//     the 4 lanes of a row merge once, at the end, into the block's partial.
//   * The partials (splits, N) go through the combine below
//     (xent_combine.cuh), which the fp32 kernel shares.
//   Two blocks share an SM (288 threads, at most 112 registers a thread;
//   ptxas reports 96 and no spills, so no register hand-over is needed),
//   so one block's epilogue runs under the other's products.
//
// Known gaps: at 128 x 128 tiles every block re-reads its x panels for each
// vocab tile and every row block reads all of W, ~9.7 GB from L2 at GPT-2's
// shape; larger tiles (n256, or two-block clusters multicasting W) would
// cut that traffic.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after its launches, 100000 for what it does not take,
// 100001 if the driver refuses a tensor map.

#include <math.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kBK = 64;                // depth of a slice
constexpr int kStages = 3;
constexpr uint32_t kXBytes = kBM * kBK * 2;            // one 128 x 64 panel
constexpr uint32_t kWPanel = kBK * 64 * 2;             // 64 deep x 64 columns
constexpr uint32_t kStageBytes = kXBytes + 2 * kWPanel;
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
xent_sm90_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW,
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
          tma_load_2d(st, &tmX, &full[s], ks * kBK, rbase);
          tma_load_2d(st + kXBytes, &tmW, &full[s], tile * kBN, ks * kBK);
          tma_load_2d(st + kXBytes + kWPanel, &tmW, &full[s], tile * kBN + 64, ks * kBK);
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
      const unsigned char* st = ring + s * kStageBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaSSMN<T, kBN>::run(acc, desc_kmajor(st + wg * 64 * 128 + kk * 32),
                               desc_mnmajor(st + kXBytes + kk * 2048, kWPanel), 1);
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
          if (c0 + nt * 8 + 2 * t + e >= V) z = kNegBig;   // padded vocab
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

__global__ void xent_combine_kernel(const float* __restrict__ m_part,
                                    const float* __restrict__ s_part,
                                    const float* __restrict__ tl, float* __restrict__ nll,
                                    float* __restrict__ lse, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float M = kNegBig;
  for (int j = 0; j < splits; ++j) M = fmaxf(M, m_part[static_cast<size_t>(j) * N + row]);
  float S = 0.f;
  for (int j = 0; j < splits; ++j)
    S += s_part[static_cast<size_t>(j) * N + row] *
         expf(m_part[static_cast<size_t>(j) * N + row] - M);
  const float l = M + logf(S);
  lse[row] = l;
  nll[row] = l - tl[row];
}

template <typename T>
int run(const void* x, const void* w, const long long* targets, float* m_part, float* s_part,
        float* tl, float* nll, float* lse, int N, int D, int V, int Vp, int splits,
        cudaStream_t stream) {
  const int n_tiles = (Vp + kBN - 1) / kBN;
  const int per = (n_tiles + splits - 1) / splits;
  if ((n_tiles + per - 1) / per != splits) return kUnsupported;   // every split owns a tile
  const CUtensorMapDataType ty = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tx, tw;
  if (!make_2d_map(&tx, ty, 2, x, N, D, kBM) || !make_2d_map(&tw, ty, 2, w, D, Vp, kBK))
    return kNoTensorMap;
  auto kernel = xent_sm90_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + kBM - 1) / kBM, splits), kThreads, kSmem, stream>>>(
      tx, tw, targets, m_part, s_part, tl, N, D, V, n_tiles, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return bllm::xent::combine(m_part, s_part, tl, nll, lse, N, splits, stream);
}

}  // namespace

int bllm::xent::combine(const float* m_part, const float* s_part, const float* tl, float* nll,
                        float* lse, int N, int splits, cudaStream_t stream) {
  xent_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(m_part, s_part, tl, nll, lse, N,
                                                           splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// x (N, D) and w (D, Vp) of one 16-bit dtype (1 = float16, 2 = bfloat16),
// contiguous and 16-byte aligned, D % 64 == 0, w's columns padded to Vp (a
// multiple of 8, V <= Vp < V + 8); targets (N,) int64; m_part, s_part
// (splits, N) fp32 scratch; tl (N,) fp32 filled with -1e30 by the caller;
// nll, lse (N,) fp32 outputs. ``splits`` must be the number of vocab shares
// of ceil(ceil(Vp / 128) / splits) tiles each (ops/xent_fwd.sm90_plan).
int bllm_xent_fwd_sm90(int dtype, int N, int D, int V, int Vp, int splits, const void* x,
                       const void* w, const void* targets, void* m_part, void* s_part,
                       void* tl, void* nll, void* lse, void* stream) {
  if (N < 1 || D < kBK || D % kBK != 0 || V < 1 || Vp % 8 != 0 ||
      Vp < V || Vp >= V + 8 || splits < 1 || splits > 65535)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tg = static_cast<const long long*>(targets);
  float *mp = static_cast<float*>(m_part), *sp = static_cast<float*>(s_part),
        *t = static_cast<float*>(tl), *nl = static_cast<float*>(nll),
        *ls = static_cast<float*>(lse);
  switch (dtype) {
    case 1: return run<__half>(x, w, tg, mp, sp, t, nl, ls, N, D, V, Vp, splits, s);
    case 2: return run<__nv_bfloat16>(x, w, tg, mp, sp, t, nl, ls, N, D, V, Vp, splits, s);
    default: return kUnsupported;
  }
}

}  // extern "C"
