// Vocab-streamed cross-entropy forward for Hopper (sm_90a): B4.
//
// Replaces the TPU kernel of building_llm_from_scratch_tpu/ops/
// xent_fwd_pallas.py (_kernel, called through xent_fwd): for hidden states
// x (N, D), the head W (D, V) and targets (N,), the fp32 logits x.W are made
// tile by tile, padded vocab columns are masked to -1e30, an online max and
// sum of exponentials is kept in fp32 per row, and the target logit is
// picked; only (nll, lse) per row reach device memory, never the (N, V)
// logits.
//
// What bounds it: operations. At GPT-2-124M's B 8 x T 1024 (N 8192, D 768,
// V 50257) the logits product is 2 N D V = 632 GFLOP, about 0.64 ms at the
// bf16 dense peak, over ~90 MB of inputs.
//
// Design (a first, simple kernel): the TPU kernel keeps all N rows resident
// and walks the vocabulary in one sequential grid. Here a block of 8 warps
// owns 128 rows and one contiguous share of the vocabulary (the grid's
// second axis splits it, so enough blocks fill the 132 SMs), and walks its
// share in 128-column tiles. Each tile is a 128 x 128 product over D in
// 32-deep slices staged in shared memory (x row-major, W transposed while
// it is copied in, zeros past V and past N), computed with the mma.sync
// routine of warp_mma.cuh (FMAs in fp32); the online max and sum are updated
// from the fragments, reduced over the 4 lanes that share a row. Each block
// writes its rows' partial (max, sum); the thread holding a row's target
// column writes the target logit. A second kernel combines the partials of
// each row: lse = M + log(sum_j s_j exp(m_j - M)), nll = lse - target logit.
// Known gaps, for a later PR: no cp.async/TMA double buffering, scalar
// loads of W (its rows are not 16-byte aligned for odd V), no wgmma.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). Each entry returns
// cudaGetLastError() after its launches, or 100000 for what it does not take.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bllm::pad;

constexpr int kThreads = 256;   // 8 warps of 16 rows
constexpr int kBM = 128;        // rows of a block
constexpr int kBN = 128;        // vocab columns of a tile
constexpr int kBK = 32;         // depth of a staged slice
constexpr int kUnsupported = 100000;
constexpr float kNegBig = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const long long* __restrict__ targets, float* __restrict__ m_part,
                    float* __restrict__ s_part, float* __restrict__ tl, int N, int D, int V,
                    int tiles_per_split) {
  constexpr int LD = kBK + pad<T>();
  constexpr int NT = kBN / 8;
  __shared__ __align__(16) T sX[kBM * LD];
  __shared__ __align__(16) T sW[kBN * LD];   // [vocab column][d]

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int rbase = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int n_tiles = (V + kBN - 1) / kBN;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, n_tiles);

  long long tgt[2];
  float m[2] = {kNegBig, kNegBig}, s[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rbase + row0 + g + 8 * rr;
    tgt[rr] = row < N ? targets[row] : -1;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int c0 = tile * kBN;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      __syncthreads();   // the previous slice is no longer read
      constexpr int VEC = 16 / sizeof(T);
      constexpr int CPR = kBK / VEC;
      for (int c = threadIdx.x; c < kBM * CPR; c += kThreads) {
        const int r = c / CPR, d0 = (c - r * CPR) * VEC;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (rbase + r < N)
          raw = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(rbase + r) * D + k0 + d0);
        *reinterpret_cast<uint4*>(sX + r * LD + d0) = raw;
      }
      for (int c = threadIdx.x; c < kBK * kBN; c += kThreads) {
        const int kk = c / kBN, n = c - kk * kBN;
        const int col = c0 + n;
        sW[n * LD + kk] = col < V ? w[static_cast<size_t>(k0 + kk) * V + col]
                                  : bllm::from_f<T>(0.f);
      }
      __syncthreads();
      bllm::warp_gemm<T, NT, kBK>(acc, sX, LD, row0, sW, LD);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegBig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float z = acc[nt][2 * rr + e];
          if (c0 + nt * 8 + 2 * t + e >= V) z = kNegBig;   // padded vocab
          acc[nt][2 * rr + e] = z;
          mx = fmaxf(mx, z);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sum += expf(acc[nt][2 * rr] - m_new) +
                                             expf(acc[nt][2 * rr + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      s[rr] = s[rr] * expf(m[rr] - m_new) + sum;
      m[rr] = m_new;

      // the lane holding the target column writes its logit (constant
      // fragment indices only, so acc stays in registers)
      const long long local = tgt[rr] - c0;
      if (local >= 0 && local < kBN && ((local >> 1) & 3) == t) {
        const int nt = static_cast<int>(local >> 3);
        const bool odd = (local & 1) != 0;
#pragma unroll
        for (int n2 = 0; n2 < NT; ++n2)
          if (n2 == nt)
            tl[rbase + row0 + g + 8 * rr] = odd ? acc[n2][2 * rr + 1] : acc[n2][2 * rr];
      }
    }
  }

  if (t == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rbase + row0 + g + 8 * rr;
      if (row < N) {
        m_part[static_cast<size_t>(split) * N + row] = m[rr];
        s_part[static_cast<size_t>(split) * N + row] = s[rr];
      }
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
        float* tl, float* nll, float* lse, int N, int D, int V, int splits,
        cudaStream_t stream) {
  const int n_tiles = (V + kBN - 1) / kBN;
  const int per = (n_tiles + splits - 1) / splits;
  const int used = (n_tiles + per - 1) / per;
  if (used != splits) return kUnsupported;   // every split must own a tile
  dim3 grid((N + kBM - 1) / kBM, splits);
  xent_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, m_part, s_part, tl, N, D, V,
      per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(m_part, s_part, tl, nll, lse, N,
                                                           splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (N, D) and w (D, V) of one dtype (0 = float32, 1 = float16,
// 2 = bfloat16), contiguous, D % 32 == 0, x 16-byte aligned; targets (N,)
// int64; m_part, s_part (splits, N) fp32 scratch; tl (N,) fp32 filled with
// -1e30 by the caller; nll, lse (N,) fp32 outputs. ``splits`` must be the
// number of vocab shares of ceil(ceil(V / 128) / splits) tiles each.
int bllm_xent_fwd(int dtype, int N, int D, int V, int splits, const void* x, const void* w,
                  const void* targets, void* m_part, void* s_part, void* tl, void* nll,
                  void* lse, void* stream) {
  if (N < 1 || D < kBK || D % kBK != 0 || V < 1 || splits < 1) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tg = static_cast<const long long*>(targets);
  float *mp = static_cast<float*>(m_part), *sp = static_cast<float*>(s_part),
        *t = static_cast<float*>(tl), *nl = static_cast<float*>(nll),
        *ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return run<float>(x, w, tg, mp, sp, t, nl, ls, N, D, V, splits, s);
    case 1: return run<__half>(x, w, tg, mp, sp, t, nl, ls, N, D, V, splits, s);
    case 2: return run<__nv_bfloat16>(x, w, tg, mp, sp, t, nl, ls, N, D, V, splits, s);
    default: return kUnsupported;
  }
}

}  // extern "C"
