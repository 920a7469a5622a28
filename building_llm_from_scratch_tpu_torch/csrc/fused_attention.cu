// Causal flash attention for Hopper (sm_90a): forward (B1), dq (B2a) and
// per-query-head dk/dv (B2b).
//
// Replaces the TPU kernels of building_llm_from_scratch_tpu/ops/
// fused_attention.py with dropout off: _fwd (_fwd_kernel), and _bwd's two
// calls (_dq_kernel, _dkv_kernel). The function is the JAX kernels', not
// their blocks:
//   forward   s = q.k * scale (fp32), causal mask, online softmax in fp32
//             (running max m, running sum l of the fp32 exp terms), the exp
//             terms rounded to the value dtype before P.V (fp32 sums);
//             out = acc / l in the model dtype, lse = m + log(l) in fp32.
//   dq        p = exp(s - lse), dp = dO.v, dS = p * (dp - delta) * scale,
//             dq = sum dS.k with dS rounded to the model dtype.
//   dk, dv    the same p and dS per (key tile, QUERY head): dv = sum p^T.dO,
//             dk = sum dS^T.q (p, dS rounded to the model dtype); the
//             wrapper sums the G query heads of a kv head (GQA), as the JAX
//             wrapper does.
// Query head h reads kv head h / G; K and V are never repeated. delta =
// rowsum(dO * out) is computed by the wrapper.
//
// Layout: the model's own (B, T, H, D), read through row strides (no
// transposes in device memory); lse and delta are (B, Hq, T) fp32.
//
// What bounds it: operations. At LLaMA-3.2-1B's training shape (B 4, Hq 32,
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kRows = 64;           // rows of a block's own tile, 16 per warp
constexpr int kUnsupported = 100000;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// exp of the softmax terms: the fast hardware exp for the 16-bit paths (the
// terms are rounded to 8 or 11 bits anyway), the accurate one for fp32
template <typename T> __device__ __forceinline__ float exp_f(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return expf(x);
  } else {
    return __expf(x);
  }
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// acc[nt] += A[row0 : row0 + 16, 0 : K] . B[nt*8 : nt*8 + 8, 0 : K]^T
// A is row-major (lda), B is stored [n][k] (ldb), both in shared memory.
// acc[nt][e] is the mma.sync C fragment: row row0 + g + 8*(e >> 1), column
// nt*8 + 2*t + (e & 1), with g = lane / 4 and t = lane % 4.
template <typename T, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* __restrict__ sA,
                                          int lda, int row0, const T* __restrict__ sB,
                                          int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    const float* a_lo = sA + (row0 + g) * lda;
    const float* a_hi = a_lo + 8 * lda;
    const float* b_lo = sB + 2 * t * ldb;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = b_lo[nt * 8 * ldb + k];
        const float b1 = b_lo[(nt * 8 + 1) * ldb + k];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  } else {
    const T* a_lo = sA + (row0 + g) * lda + 2 * t;
    const T* a_hi = a_lo + 8 * lda;
    const T* b_base = sB + g * ldb + 2 * t;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t a[4] = {ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 8),
                             ld32(a_hi + k0 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* bp = b_base + nt * 8 * ldb + k0;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma16816<T>(acc[nt], a, b);
      }
    }
  }
}

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
// none), as model-dtype rows: row r of the tile goes to dst + r * gstride.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], const float (&div)[2],
                                           T* __restrict__ dst, size_t gstride, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* row = dst + (row0 + g + 8 * rr) * gstride;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      row[nt * 8 + 2 * t] = from_f<T>(acc[nt][2 * rr] / div[rr]);
      row[nt * 8 + 2 * t + 1] = from_f<T>(acc[nt][2 * rr + 1] / div[rr]);
    }
  }
}

template <typename T> __host__ __device__ constexpr int pad() { return 16 / sizeof(T); }

// ---------------------------------------------------------------------------
// B1: forward. Grid (T / 64, Hq, B).
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (2 * kRows * (D + pad<T>()) + (D + kRows) * (kRows + pad<T>())) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int seq, int Hq, int Hkv,
                float scale) {
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp_f<T>(s[nt][2 * rr + e] - m_new);
          sum += p;
          sP[r * LDT + nt * 8 + 2 * t + e] = from_f<T>(p);
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

  store_rows<T, NO>(acc, l, out + qoff, qs, row0);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int seq, int Hq, int Hkv,
               float scale) {
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float p = (j == i && col > r)
                              ? 0.f
                              : exp_f<T>(s[nt][2 * rr + e] * scale - lse_r[rr]);
          const float ds = p * (dp[nt][2 * rr + e] - delta_r[rr]) * scale;
          sdS[r * LDT + col] = from_f<T>(ds);
        }
      }
    }
    __syncwarp();
    warp_gemm<T, NO, kRows>(acc, sdS, LDT, row0, sKt, LDT);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, NO>(acc, one, dq + qoff, qs, row0);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int seq,
                int Hq, int Hkv, float scale) {
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float p = (kpos > i * BQ + col)
                              ? 0.f
                              : exp_f<T>(st[nt][2 * rr + e] * scale - sL[col]);
          const float ds = p * (dpt[nt][2 * rr + e] - sDl[col]) * scale;
          sPt[kr * LDQ + col] = from_f<T>(p);
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
  store_rows<T, NO>(dka, one, dk + doff, qs, row0);
  store_rows<T, NO>(dva, one, dv + doff, qs, row0);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  int B, seq, Hq, Hkv;
  float scale;
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
    void* params[] = {&q, &k, &v, &out, &lse, &seq, &Hq, &Hkv, &scale};
    return launch(attn_fwd_kernel<T, D>, fwd_smem<T, D>(), a, dim3(a.seq / kRows, a.Hq, a.B),
                  params);
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
    void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dq, &seq, &Hq, &Hkv, &scale};
    return launch(attn_dq_kernel<T, D>, dq_smem<T, D>(), a, dim3(a.seq / kRows, a.Hq, a.B),
                  params);
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
    void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &seq, &Hq, &Hkv, &scale};
    return launch(attn_dkv_kernel<T, D>, dkv_smem<T, D>(), a, dim3(a.seq / kRows, a.Hq, a.B),
                  params);
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
int bllm_attn_fwd(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale, const void* q,
                  const void* k, const void* v, void* out, void* lse, void* stream) {
  Args a{B, T, Hq, Hkv, scale, q, k, v, nullptr, nullptr, nullptr, out, lse,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, hd, a);
}

// dout, dq (B, T, Hq, hd); lse, delta (B, Hq, T) fp32.
int bllm_attn_bwd_dq(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                     const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* stream) {
  Args a{B, T, Hq, Hkv, scale, q, k, v, dout, lse, delta, dq, nullptr,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, hd, a);
}

// dk, dv per QUERY head: (B, T, Hq, hd) each.
int bllm_attn_bwd_dkv(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                      const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, void* stream) {
  Args a{B, T, Hq, Hkv, scale, q, k, v, dout, lse, delta, dk, dv,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, hd, a);
}

}  // extern "C"
