// Causal flash attention for Hopper (sm_90a): forward (B1), dq (B2a) and
// per-query-head dk/dv (B2b).
//
// Replaces the TPU kernels of building_llm_from_scratch_tpu/ops/
// fused_attention.py: _fwd (_fwd_kernel), and _bwd's two calls (_dq_kernel,
// _dkv_kernel), with their in-kernel attention dropout. The function is the
// JAX kernels', not their blocks:
//   forward   s = q.k * scale (fp32), causal mask, online softmax in fp32
//             (running max m, running sum l of the fp32 exp terms), the exp
//             terms times the keep mask M rounded to the value dtype before
//             P.V (fp32 sums; the mask does not touch l);
//             out = acc / l * 1/(1-p) in the model dtype, lse = m + log(l).
//   dq        p = exp(s - lse), dp = dO.v, dp~ = M * dp / (1-p),
//             dS = p * (dp~ - delta) * scale, dq = sum dS.k with dS rounded
//             to the model dtype.
//   dk, dv    the same p, dp~ and dS per (key tile, QUERY head): dv = sum
//             (M p / (1-p))^T.dO, dk = sum dS^T.q (both rounded to the model
//             dtype first); the wrapper sums the G query heads of a kv head
//             (GQA), as the JAX wrapper does.
// Query head h reads kv head h / G; K and V are never repeated. delta =
// rowsum(dO * out) over the dropped output is computed by the wrapper.
//
// Dropout (rate > 0, threshold != 0; each kernel is instantiated with and
// without it, so the no-dropout path carries no dropout code): the keep bit
// of element (b, h, q, k)
// is a pure function of the seed and those coordinates (csrc/philox.cuh),
// never of a tile or of launch order, so the three kernels, which tile the
// scores differently (64-row forward and dq tiles, 64-key dk/dv blocks over
// 64- or 32-row query tiles), regenerate the same mask, and nothing T^2-sized
// is stored. Each thread draws one Philox call per pair of its fragment's
// elements.
//
// Layout: the model's own (B, T, H, D), read through row strides (no
// transposes in device memory); lse and delta are (B, Hq, T) fp32.
//
// What bounds it: operations (the Philox draws add integer work, about 50
// instructions an element, that no bound below counts). At LLaMA-3.2-1B's training shape (B 4, Hq 32,
// Hkv 8, T 1024, D 64) the forward does ~17 GFLOP of causal products over
// ~42 MB, about 400 operations a byte, above the card's ~295 for bf16.
//
// Design (a first, simple kernel; each block is independent):
//   * One block of 4 warps per (64-row tile, query head, batch row). Each
//     warp owns 16 rows of the tile. The forward and dq kernels loop over
//     the kv tiles up to the diagonal (causal tile skip); the dk/dv kernel
//     owns a 64-key tile and loops over the query tiles from the diagonal
//     to the end.
//   * Every product is a warp tile product A (16 x K, row-major in shared
//     memory) times B^T (B stored [n][k] in shared memory). For bf16/fp16 it
//     runs on the tensor cores with mma.sync m16n8k16 (fp32 accumulation),
//     fragments read with 32-bit shared-memory loads; for fp32 the same
//     fragment layout is computed with FMAs (the exact reference path).
//   * Tiles come in with 16-byte loads; operands needed with the other
//     orientation (V for P.V, K for dS.K, Q and dO in dk/dv) are stored
//     transposed while they are copied in. P and dS go through shared
//     memory in the model dtype (the rounding the JAX kernels apply).
//   * Rows are padded by 16 bytes so the fragment loads are free of bank
//     conflicts.
// Known gaps, for a later PR: no cp.async/TMA double buffering (each tile
// load waits on device memory with nothing in flight), no ldmatrix, no
// wgmma; the mask test runs on every element of the diagonal tile.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). Each entry
// returns cudaGetLastError() after its launch, or 100000 for a dtype, head
// dim or shape it is not instantiated for (see bllm_error_string).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"
#include "warp_mma.cuh"

namespace {

using bllm::from_f;
using bllm::pad;
using bllm::warp_gemm;

constexpr int kThreads = 128;       // 4 warps
constexpr int kRows = 64;           // rows of a block's own tile, 16 per warp
constexpr int kUnsupported = 100000;

// exp of the softmax terms: the fast hardware exp for the 16-bit paths (the
// terms are rounded to 8 or 11 bits anyway), the accurate one for fp32
template <typename T> __device__ __forceinline__ float exp_f(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return expf(x);
  } else {
    return __expf(x);
  }
}

// the dropout parameters of a launch: keep = Philox word >= threshold (no
// mask at all when threshold is 0), kept terms scaled by inv_keep = 1/(1-p)
struct Drop {
  uint32_t threshold, seed_lo, seed_hi;
  float inv_keep;
};

// Copy R rows of D elements (global row stride gstride) into shared memory
// with 16-byte loads: row-major into sX (ld), and/or transposed into sXt
// (sXt[d * ldt + r]) when the pointer is not null.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ sX, int ld, T* __restrict__ sXt,
                                          int ldt, const T* __restrict__ gsrc,
                                          size_t gstride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int c = threadIdx.x; c < R * CPR; c += kThreads) {
    const int r = c / CPR;
    const int d0 = (c - r * CPR) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(gsrc + r * gstride + d0);
    if (sX != nullptr) *reinterpret_cast<uint4*>(sX + r * ld + d0) = raw;
    if (sXt != nullptr) {
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sXt[(d0 + e) * ldt + r] = vals[e];
    }
  }
}

// Write a warp's 16 x D fp32 fragment tile, divided by div[rr] (1 for
// none) and then multiplied by mul, as model-dtype rows: row r of the tile
// goes to dst + r * gstride.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], const float (&div)[2],
                                           float mul, T* __restrict__ dst, size_t gstride,
                                           int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* row = dst + (row0 + g + 8 * rr) * gstride;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      row[nt * 8 + 2 * t] = from_f<T>(acc[nt][2 * rr] / div[rr] * mul);
      row[nt * 8 + 2 * t + 1] = from_f<T>(acc[nt][2 * rr + 1] / div[rr] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// B1: forward. Grid (T / 64, Hq, B).
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (2 * kRows * (D + pad<T>()) + (D + kRows) * (kRows + pad<T>())) * sizeof(T);
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int seq, int Hq, int Hkv,
                float scale, Drop drop) {
  constexpr int LD = D + pad<T>();        // [row][d] tiles
  constexpr int LDT = kRows + pad<T>();   // [d][key] and [row][key] tiles
  constexpr int NS = kRows / 8;           // n-tiles of a score tile
  constexpr int NO = D / 8;               // n-tiles of an output tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;
  T* sVt = sK + kRows * LD;
  T* sP = sVt + D * LDT;

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t qs = static_cast<size_t>(Hq) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = (static_cast<size_t>(b) * seq + static_cast<size_t>(i) * kRows) * qs +
                      static_cast<size_t>(h) * D;
  load_tile<T, kRows, D>(sQ, LD, nullptr, 0, q + qoff, qs);

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j <= i; ++j) {
    __syncthreads();   // the previous tile's sK / sVt / sP are no longer read
    const size_t koff = (static_cast<size_t>(b) * seq + static_cast<size_t>(j) * kRows) * ks +
                        static_cast<size_t>(hk) * D;
    load_tile<T, kRows, D>(sK, LD, nullptr, 0, k + koff, ks);
    load_tile<T, kRows, D>(nullptr, 0, sVt, LDT, v + koff, ks);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    warp_gemm<T, NS, D>(s, sQ, LD, row0, sK, LD);

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = row0 + g + 8 * rr;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nt][2 * rr + e] * scale;
          if (j == i && nt * 8 + 2 * t + e > r) x = -INFINITY;   // causal, diagonal tile
          s[nt][2 * rr + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float corr = exp_f<T>(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        bool keep[2] = {true, true};
        if (kDrop)
          bllm::attn_keep_keys(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h,
                               i * kRows + r, j * kRows + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp_f<T>(s[nt][2 * rr + e] - m_new);
          sum += p;       // l sums every term: dropout scales the normalised weights
          sP[r * LDT + nt * 8 + 2 * t + e] = from_f<T>(keep[e] ? p : 0.f);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = l[rr] * corr + sum;
      m[rr] = m_new;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        acc[nt][2 * rr] *= corr;
        acc[nt][2 * rr + 1] *= corr;
      }
    }
    __syncwarp();      // each warp reads back only its own 16 rows of sP
    warp_gemm<T, NO, kRows>(acc, sP, LDT, row0, sVt, LDT);
  }

  store_rows<T, NO>(acc, l, kDrop ? drop.inv_keep : 1.f, out + qoff, qs, row0);
  if (t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * seq + static_cast<size_t>(i) * kRows;
    lrow[row0 + g] = m[0] + logf(l[0]);
    lrow[row0 + g + 8] = m[1] + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// B2a: dq. Grid (T / 64, Hq, B).
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dq_smem() {
  return (4 * kRows * (D + pad<T>()) + (D + kRows) * (kRows + pad<T>())) * sizeof(T);
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int seq, int Hq, int Hkv,
               float scale, Drop drop) {
  constexpr int LD = D + pad<T>();
  constexpr int LDT = kRows + pad<T>();
  constexpr int NS = kRows / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kRows * LD;
  T* sK = sdO + kRows * LD;
  T* sV = sK + kRows * LD;
  T* sKt = sV + kRows * LD;
  T* sdS = sKt + D * LDT;

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t qs = static_cast<size_t>(Hq) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = (static_cast<size_t>(b) * seq + static_cast<size_t>(i) * kRows) * qs +
                      static_cast<size_t>(h) * D;
  load_tile<T, kRows, D>(sQ, LD, nullptr, 0, q + qoff, qs);
  load_tile<T, kRows, D>(sdO, LD, nullptr, 0, dout + qoff, qs);
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * seq + static_cast<size_t>(i) * kRows;
  const float lse_r[2] = {lse[roff + row0 + g], lse[roff + row0 + g + 8]};
  const float delta_r[2] = {delta[roff + row0 + g], delta[roff + row0 + g + 8]};

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int j = 0; j <= i; ++j) {
    __syncthreads();
    const size_t koff = (static_cast<size_t>(b) * seq + static_cast<size_t>(j) * kRows) * ks +
                        static_cast<size_t>(hk) * D;
    load_tile<T, kRows, D>(sK, LD, sKt, LDT, k + koff, ks);
    load_tile<T, kRows, D>(sV, LD, nullptr, 0, v + koff, ks);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    warp_gemm<T, NS, D>(s, sQ, LD, row0, sK, LD);
    warp_gemm<T, NS, D>(dp, sdO, LD, row0, sV, LD);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = row0 + g + 8 * rr;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        bool keep[2] = {true, true};
        if (kDrop)
          bllm::attn_keep_keys(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h,
                               i * kRows + r, j * kRows + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float p = (j == i && col > r)
                              ? 0.f
                              : exp_f<T>(s[nt][2 * rr + e] * scale - lse_r[rr]);
          float dpv = dp[nt][2 * rr + e];
          if (kDrop) dpv = keep[e] ? dpv * drop.inv_keep : 0.f;
          const float ds = p * (dpv - delta_r[rr]) * scale;
          sdS[r * LDT + col] = from_f<T>(ds);
        }
      }
    }
    __syncwarp();
    warp_gemm<T, NO, kRows>(acc, sdS, LDT, row0, sKt, LDT);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, NO>(acc, one, 1.f, dq + qoff, qs, row0);
}

// ---------------------------------------------------------------------------
// B2b: dk, dv per query head. Grid (T / 64, Hq, B); the block owns 64 keys
// and loops over BQ-row query tiles from the diagonal on.
// ---------------------------------------------------------------------------

template <int D> __host__ __device__ constexpr int dkv_bq() { return D <= 64 ? 64 : 32; }

template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = dkv_bq<D>();
  return (2 * (kRows + BQ) * (D + pad<T>()) + 2 * (D + kRows) * (BQ + pad<T>())) * sizeof(T) +
         2 * BQ * sizeof(float);
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int seq,
                int Hq, int Hkv, float scale, Drop drop) {
  constexpr int BQ = dkv_bq<D>();
  constexpr int LD = D + pad<T>();
  constexpr int LDQ = BQ + pad<T>();
  constexpr int NQ = BQ / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sdO = sQ + BQ * LD;
  T* sQt = sdO + BQ * LD;
  T* sdOt = sQt + D * LDQ;
  T* sPt = sdOt + D * LDQ;
  T* sdSt = sPt + kRows * LDQ;
  float* sL = reinterpret_cast<float*>(sdSt + kRows * LDQ);
  float* sDl = sL + BQ;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t qs = static_cast<size_t>(Hq) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = (static_cast<size_t>(b) * seq + static_cast<size_t>(j) * kRows) * ks +
                      static_cast<size_t>(hk) * D;
  load_tile<T, kRows, D>(sK, LD, nullptr, 0, k + koff, ks);
  load_tile<T, kRows, D>(sV, LD, nullptr, 0, v + koff, ks);

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }

  const int n_q = seq / BQ;
  for (int i = (j * kRows) / BQ; i < n_q; ++i) {
    __syncthreads();
    const size_t qoff = (static_cast<size_t>(b) * seq + static_cast<size_t>(i) * BQ) * qs +
                        static_cast<size_t>(h) * D;
    load_tile<T, BQ, D>(sQ, LD, sQt, LDQ, q + qoff, qs);
    load_tile<T, BQ, D>(sdO, LD, sdOt, LDQ, dout + qoff, qs);
    const size_t roff = (static_cast<size_t>(b) * Hq + h) * seq + static_cast<size_t>(i) * BQ;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      sL[r] = lse[roff + r];
      sDl[r] = delta[roff + r];
    }
    __syncthreads();

    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
    warp_gemm<T, NQ, D>(st, sK, LD, row0, sQ, LD);     // S^T = K Q^T
    warp_gemm<T, NQ, D>(dpt, sV, LD, row0, sdO, LD);   // dP^T = V dO^T
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kr = row0 + g + 8 * rr;
      const int kpos = j * kRows + kr;
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        bool keep[2] = {true, true};
        if (kDrop)
          bllm::attn_keep_queries(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h,
                                  i * BQ + nt * 8 + 2 * t, kpos);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float p = (kpos > i * BQ + col)
                              ? 0.f
                              : exp_f<T>(st[nt][2 * rr + e] * scale - sL[col]);
          float pt = p, dpv = dpt[nt][2 * rr + e];
          if (kDrop) {
            pt = keep[e] ? p * drop.inv_keep : 0.f;
            dpv = keep[e] ? dpv * drop.inv_keep : 0.f;
          }
          const float ds = p * (dpv - sDl[col]) * scale;
          sPt[kr * LDQ + col] = from_f<T>(pt);
          sdSt[kr * LDQ + col] = from_f<T>(ds);
        }
      }
    }
    __syncwarp();
    warp_gemm<T, NO, BQ>(dva, sPt, LDQ, row0, sdOt, LDQ);   // dV += P^T dO
    warp_gemm<T, NO, BQ>(dka, sdSt, LDQ, row0, sQt, LDQ);   // dK += dS^T Q
  }

  const float one[2] = {1.f, 1.f};
  const size_t doff = (static_cast<size_t>(b) * seq + static_cast<size_t>(j) * kRows) * qs +
                      static_cast<size_t>(h) * D;
  store_rows<T, NO>(dka, one, 1.f, dk + doff, qs, row0);
  store_rows<T, NO>(dva, one, 1.f, dv + doff, qs, row0);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  int B, seq, Hq, Hkv;
  float scale;
  Drop drop;
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  cudaStream_t stream;
};

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, dim3 grid, void** params) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), params,
                         smem, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
struct Fwd {
  static int run(const Args& a) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    T* out = static_cast<T*>(a.out0);
    float* lse = static_cast<float*>(a.out1);
    int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv;
    float scale = a.scale;
    Drop drop = a.drop;
    void* params[] = {&q, &k, &v, &out, &lse, &seq, &Hq, &Hkv, &scale, &drop};
    const dim3 grid(a.seq / kRows, a.Hq, a.B);
    return drop.threshold != 0u
               ? launch(attn_fwd_kernel<T, D, true>, fwd_smem<T, D>(), a, grid, params)
               : launch(attn_fwd_kernel<T, D, false>, fwd_smem<T, D>(), a, grid, params);
  }
};

template <typename T, int D>
struct Dq {
  static int run(const Args& a) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const float* lse = static_cast<const float*>(a.lse);
    const float* delta = static_cast<const float*>(a.delta);
    T* dq = static_cast<T*>(a.out0);
    int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv;
    float scale = a.scale;
    Drop drop = a.drop;
    void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &seq, &Hq, &Hkv, &scale, &drop};
    const dim3 grid(a.seq / kRows, a.Hq, a.B);
    return drop.threshold != 0u
               ? launch(attn_dq_kernel<T, D, true>, dq_smem<T, D>(), a, grid, params)
               : launch(attn_dq_kernel<T, D, false>, dq_smem<T, D>(), a, grid, params);
  }
};

template <typename T, int D>
struct Dkv {
  static int run(const Args& a) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const float* lse = static_cast<const float*>(a.lse);
    const float* delta = static_cast<const float*>(a.delta);
    T* dk = static_cast<T*>(a.out0);
    T* dv = static_cast<T*>(a.out1);
    int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv;
    float scale = a.scale;
    Drop drop = a.drop;
    void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &seq, &Hq, &Hkv, &scale,
                      &drop};
    const dim3 grid(a.seq / kRows, a.Hq, a.B);
    return drop.threshold != 0u
               ? launch(attn_dkv_kernel<T, D, true>, dkv_smem<T, D>(), a, grid, params)
               : launch(attn_dkv_kernel<T, D, false>, dkv_smem<T, D>(), a, grid, params);
  }
};

template <template <typename, int> class Kernel>
int dispatch(int dtype, int hd, const Args& a) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.seq < kRows || a.seq % kRows != 0)
    return kUnsupported;
  if (hd != 64 && hd != 128) return kUnsupported;
  switch (dtype) {
    case 0: return hd == 64 ? Kernel<float, 64>::run(a) : Kernel<float, 128>::run(a);
    case 1: return hd == 64 ? Kernel<__half, 64>::run(a) : Kernel<__half, 128>::run(a);
    case 2:
      return hd == 64 ? Kernel<__nv_bfloat16, 64>::run(a) : Kernel<__nv_bfloat16, 128>::run(a);
    default: return kUnsupported;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous:
// q, out (B, T, Hq, hd); k, v (B, T, Hkv, hd); lse (B, Hq, T) fp32.
// Dropout: keep = Philox word >= threshold (threshold 0: no dropout), kept
// terms times inv_keep = 1/(1-p); the seed is (seed_hi << 32) | seed_lo.
int bllm_attn_fwd(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                  unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                  const void* q, const void* k, const void* v, void* out, void* lse,
                  void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep}, q, k, v,
         nullptr, nullptr, nullptr, out, lse, static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, hd, a);
}

// dout, dq (B, T, Hq, hd); lse, delta (B, Hq, T) fp32.
int bllm_attn_bwd_dq(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                     unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                     const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep}, q, k, v, dout,
         lse, delta, dq, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, hd, a);
}

// dk, dv per QUERY head: (B, T, Hq, hd) each.
int bllm_attn_bwd_dkv(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                      unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                      const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep}, q, k, v, dout,
         lse, delta, dk, dv, static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, hd, a);
}

}  // extern "C"
