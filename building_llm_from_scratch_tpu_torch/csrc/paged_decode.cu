// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/decode_step.py
// (paged_decode_attention -> _paged_kernel): for every slot s and kv head h
// it attends the G = Hq/Hkv query rows of that head over the slot's logical
// positions [0, t], t = lengths[s], where logical position p lives in
// physical page table[s, p / P] of the shared pools (N, Hkv, P, hd), at row
// p % P. Page ids are clipped to [0, N-1] as the TPU kernel's index map
// does. Scale 1/sqrt(hd), fp32 scores, an fp32 softmax and fp32
// accumulators; only the output is rounded to the q dtype. The caller has
// already scattered the new token's k/v into its page (no append here).
//
// What bounds it: memory bandwidth. Each (slot, head) reads t + 1 rows of K
// and V from the pool (2 (t + 1) hd elements) for 4 G hd operations per
// row, far below the card's operations-per-byte line, so the least time is
// the bytes of the valid rows over the memory rate.
//
// Design, and what it does about that bound:
//   * B5's layout (csrc/decode_step.cu, revision r3): one block per (slot,
//     kv head), NW = 8 warps; warp w takes the 32-position tiles starting
//     at 32 w, 32 (w + NW), ...; lane j owns position base + j for the
//     scores and reads its K row whole with 16-byte loads; P.V reads the
//     tile's V rows whole (lane l holds elements [l E, l E + E), E = hd/32),
//     8 rows in flight; the warps merge their partial softmaxes through
//     shared memory at the end.
//   * The loop ends at the row's own length: the TPU grid walks all M table
//     columns and masks the pages past the frontier; here they are never
//     read. On finite pools the result is the same.
//   * Page ids: in each 32-position tile, only the lane holding the first
//     position of a page (or lane 0, for the page the tile starts in) reads
//     the table; the others take the id by a warp shuffle. Each lane turns
//     it into a pool row index once, and P.V takes the row of position
//     base + j from lane j by shuffle, so the table is read once per page
//     and tile, and any page size P >= 1 works.
//
// Known gaps (as B5): S * Hkv blocks under-fill the 132 SMs at small batch
// (64 blocks at S = 8 for LLaMA-3.2-1B), and each warp waits on memory
// several times per tile with nothing else in flight. Split-KV and
// asynchronous copies (cp.async / TMA) of whole pages are the next step.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after the launch, or kUnsupported for a dtype / head
// dim it is not instantiated for.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnsupported = 100000;   // the same code as decode_step.cu's

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ K, const T* __restrict__ V,
                    const int* __restrict__ table, const int* __restrict__ lengths,
                    T* __restrict__ out, int Hq, int Hkv, int P, int N, int M, float scale) {
  constexpr int E = HD / 32;            // output elements per lane (P.V pass)
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int NV = HD / VEC;          // 16-byte loads per row
  constexpr int BATCH = 8;              // V rows in flight per warp
  __shared__ float sm_q[GT][HD];
  __shared__ float sm_p[kWarps][GT][32];
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][HD];

  const int bh = blockIdx.x;          // s * Hkv + h
  const int s = bh / Hkv;
  const int h = bh - s * Hkv;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int t = lengths[s];
  const int last = M * P - 1;         // the row's logical extent
  t = t < 0 ? 0 : (t > last ? last : t);
  const int* tab = table + static_cast<size_t>(s) * M;

  for (int g0 = 0; g0 < G; g0 += GT) {
    for (int i = threadIdx.x; i < GT * HD; i += blockDim.x) {
      const int g = i / HD;
      sm_q[g][i - g * HD] =
          (g0 + g < G) ? to_f(q[(static_cast<size_t>(s) * Hq + h * G + g0) * HD + i]) : 0.f;
    }
    __syncthreads();

    float m[GT], l[GT], acc[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }

    for (int base = warp * 32; base <= t; base += kWarps * 32) {
      const int p = base + lane;
      const bool valid = p <= t;
      // the pool row of position p: the first lane of each page in this
      // tile reads the page id, the others take it by shuffle
      const int col = p / P;
      const int off = p - col * P;
      int page = 0;
      if (valid && (off == 0 || lane == 0)) page = tab[col];
      page = __shfl_sync(0xffffffffu, page, lane >= off ? lane - off : 0);
      page = page < 0 ? 0 : (page > N - 1 ? N - 1 : page);
      const int row = (page * Hkv + h) * P + off;

      // scores: lane j owns position base + j and reads its K row whole
      float sc[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[g] = 0.f;
      if (valid) {
        const uint4* krow = reinterpret_cast<const uint4*>(K + static_cast<size_t>(row) * HD);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const uint4 raw = krow[c];
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float kf = to_f(kv[j]);
#pragma unroll
            for (int g = 0; g < GT; ++g) sc[g] = fmaf(sm_q[g][c * VEC + j], kf, sc[g]);
          }
        }
      }
      // online softmax over the tile: two warp reductions per query row
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sg = valid ? sc[g] * scale : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float pe = expf(sg - m_new);
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(pe);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        sm_p[warp][g][lane] = pe;
      }
      __syncwarp();
      // P.V: the warp reads the tile's V rows whole (lane l: elements l*E..)
      const int n = min(32, t - base + 1);
      for (int j0 = 0; j0 < n; j0 += BATCH) {
        float vv[BATCH][E];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int rj = __shfl_sync(0xffffffffu, row, j0 + u);
          if (j0 + u < n) {
            const T* vrow = V + static_cast<size_t>(rj) * HD;
#pragma unroll
            for (int e = 0; e < E; ++e) vv[u][e] = to_f(vrow[lane * E + e]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) vv[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (j0 + u < n) {
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              const float pg = sm_p[warp][g][j0 + u];
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vv[u][e], acc[g][e]);
            }
          }
        }
      }
      __syncwarp();   // sm_p is rewritten by the next tile
    }

    // merge the warps' partial softmaxes
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GT * HD; i += blockDim.x) {
      const int g = i / HD;
      const int d = i - g * HD;
      if (g0 + g >= G) continue;
      float Mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) Mx = fmaxf(Mx, sm_m[w][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        // a warp that saw no position has m = -inf and contributes exp(-inf) = 0
        const float c = expf(sm_m[w][g] - Mx);
        L = fmaf(sm_l[w][g], c, L);
        O = fmaf(sm_acc[w][g][d], c, O);
      }
      out[(static_cast<size_t>(s) * Hq + h * G + g0 + g) * HD + d] = from_f<T>(O / L);
    }
    __syncthreads();   // shared memory is reused by the next group chunk
  }
}

struct Args {
  int S, Hq, Hkv, P, N, M;
  const void *q, *K, *V;
  const int *table, *lengths;
  void* out;
  cudaStream_t stream;
};

template <typename T, int HD, int GT>
int launch(const Args& a) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  paged_decode_kernel<T, HD, GT><<<a.S * a.Hkv, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.K), static_cast<const T*>(a.V),
      a.table, a.lengths, static_cast<T*>(a.out), a.Hq, a.Hkv, a.P, a.N, a.M, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_group(const Args& a) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<T, HD, 1>(a);
  if (G <= 2) return launch<T, HD, 2>(a);
  if (G <= 4) return launch<T, HD, 4>(a);
  return launch<T, HD, 8>(a);
}

template <typename T>
int dispatch_hd(int hd, const Args& a) {
  if (hd == 64) return dispatch_group<T, 64>(a);
  if (hd == 128) return dispatch_group<T, 128>(a);
  return kUnsupported;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous:
// q/out (S, 1, Hq, hd), K/V pools (N, Hkv, P, hd), table (S, M) int32 and
// lengths (S,) int32, all on the device.
int bllm_paged_decode(int dtype, int hd, int S, int Hq, int Hkv, int P, int N, int M,
                      const void* q, const void* K, const void* V, const void* table,
                      const void* lengths, void* out, void* stream) {
  if (S < 1 || Hkv < 1 || Hq % Hkv != 0 || P < 1 || N < 1 || M < 1) return kUnsupported;
  const Args a{S, Hq, Hkv, P, N, M, q, K, V,
               static_cast<const int*>(table), static_cast<const int*>(lengths), out,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, a);
    case 1: return dispatch_hd<__half>(hd, a);
    case 2: return dispatch_hd<__nv_bfloat16>(hd, a);
    default: return kUnsupported;
  }
}

}  // extern "C"
