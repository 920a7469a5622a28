// Fused single-token decode step for Hopper (sm_90a): append + attend.
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/decode_step.py
// (fused_decode_step -> _kernel): for every slot b and kv head h it writes
// the new k/v row into the caches at position t = lengths[b], in place, and
// attends the G = Hq/Hkv query rows of that kv head over positions [0, t]
// with scale 1/sqrt(hd), fp32 scores, an fp32 softmax and fp32 accumulators;
// the output is written in the q dtype.
//
// What bounds it: memory bandwidth. Each (slot, head) pane reads t rows of K
// and V (2*t*hd elements) for 4*G*hd operations per row, far below the
// card's operations-per-byte line, so the least time is the K/V bytes of the
// valid prefix over the memory rate.
//
// Design, and what it does about that bound:
//   * Only positions [0, t] are read. The TPU kernel streams the whole
//     (Tmax, hd) pane because masking is free in VMEM; here the loop ends at
//     the row's own length, read on the device (no host sync).
//   * Position t takes the new k/v from the k_new/v_new inputs. The cache
//     row this launch writes is never read back by the launch, so no
//     ordering between the write and the reads is needed.
//   * One block per (slot, kv head), NW = 8 warps. Warp w takes the
//     32-position tiles starting at 32*w, 32*(w + NW), ... Scores: lane j
//     owns position base + j, reads its K row whole with 16-byte loads and
//     dots it with the G query rows held in shared memory (fp32), so a
//     score costs no shuffles; the tile's online-softmax update takes two
//     warp reductions per query row. P.V: the probabilities go through
//     shared memory and the warp reads the tile's V rows whole (lane l
//     holds elements [l*E, l*E + E), E = hd/32), 8 rows in flight. Each
//     warp keeps its own running max, denominator and accumulators
//     (registers); the warps merge through shared memory at the end.
//     (Revision history, measured in PERF.md: r1 kept one row load in
//     flight per warp, r2 eight, each with a warp reduction per score; r4,
//     reverted, staged the K tile through shared memory.)
//   * Query groups are processed GT at a time (GT = 1, 2, 4 or 8, the
//     smallest that covers G, at most 8); G > 8 loops over group chunks.
//
// Known gaps: the grid has S*Hkv blocks (64 at S=8 for LLaMA-3.2-1B), which
// under-fills the card's 132 SMs, and each warp waits on device memory
// several times per 32-position tile (its K rows, then its V rows in
// batches of 8) with nothing else in flight. Split-KV flash-decoding and
// asynchronous copies (cp.async / TMA) double-buffering the K/V tiles are
// the next step.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after the launch, or kUnsupported for a dtype / head dim
// it is not instantiated for.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnsupported = 100000;

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

template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane, float (&out)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f(row[lane * E + e]);
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kWarps * 32)
fused_decode_step_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, T* __restrict__ K, T* __restrict__ V,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int Hq, int Hkv, int Tmax, float scale) {
  constexpr int E = HD / 32;            // output elements per lane (P.V pass)
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int NV = HD / VEC;          // 16-byte loads per row
  constexpr int BATCH = 8;              // V rows in flight per warp
  __shared__ float sm_q[GT][HD];
  __shared__ float sm_p[kWarps][GT][32];
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][HD];

  const int bh = blockIdx.x;          // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int t = lengths[b];
  t = t < 0 ? 0 : (t > Tmax - 1 ? Tmax - 1 : t);

  const size_t pane = static_cast<size_t>(bh) * Tmax * HD;
  const T* kn = k_new + static_cast<size_t>(bh) * HD;
  const T* vn = v_new + static_cast<size_t>(bh) * HD;
  T* Kp = K + pane;
  T* Vp = V + pane;

  // the append: the row at t is written here and read by nobody in this launch
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    Kp[static_cast<size_t>(t) * HD + d] = kn[d];
    Vp[static_cast<size_t>(t) * HD + d] = vn[d];
  }

  for (int g0 = 0; g0 < G; g0 += GT) {
    for (int i = threadIdx.x; i < GT * HD; i += blockDim.x) {
      const int g = i / HD;
      sm_q[g][i - g * HD] =
          (g0 + g < G) ? to_f(q[(static_cast<size_t>(b) * Hq + h * G + g0) * HD + i]) : 0.f;
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

    // warp w takes the 32-position tiles starting at 32*w, 32*(w + NW), ...
    for (int base = warp * 32; base <= t; base += kWarps * 32) {
      // scores: lane j owns position base + j and reads its K row whole
      const int p = base + lane;
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) s[g] = 0.f;
      if (p <= t) {
        const uint4* krow = reinterpret_cast<const uint4*>(
            p == t ? kn : Kp + static_cast<size_t>(p) * HD);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const uint4 raw = krow[c];
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float kf = to_f(kv[j]);
#pragma unroll
            for (int g = 0; g < GT; ++g) s[g] = fmaf(sm_q[g][c * VEC + j], kf, s[g]);
          }
        }
      }
      // online softmax over the tile: two warp reductions per query row
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sg = (p <= t) ? s[g] * scale : -INFINITY;
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
          const int pj = base + j0 + u;
          if (j0 + u < n) {
            load_row<T, E>(pj == t ? vn : Vp + static_cast<size_t>(pj) * HD, lane, vv[u]);
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
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        // a warp that saw no position has m = -inf and contributes exp(-inf) = 0
        const float c = expf(sm_m[w][g] - M);
        L = fmaf(sm_l[w][g], c, L);
        O = fmaf(sm_acc[w][g][d], c, O);
      }
      out[(static_cast<size_t>(b) * Hq + h * G + g0 + g) * HD + d] = from_f<T>(O / L);
    }
    __syncthreads();   // shared memory is reused by the next group chunk
  }
}

template <typename T, int HD, int GT>
int launch(int S, int Hq, int Hkv, int Tmax, const void* q, const void* k_new,
           const void* v_new, void* K, void* V, const int* lengths, void* out,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  fused_decode_step_kernel<T, HD, GT><<<S * Hkv, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(K), static_cast<T*>(V), lengths, static_cast<T*>(out), Hq, Hkv, Tmax,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_group(int S, int Hq, int Hkv, int Tmax, const void* q, const void* k_new,
                   const void* v_new, void* K, void* V, const int* lengths, void* out,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G <= 1) return launch<T, HD, 1>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
  if (G <= 2) return launch<T, HD, 2>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
  if (G <= 4) return launch<T, HD, 4>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
  return launch<T, HD, 8>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
}

template <typename T>
int dispatch_hd(int hd, int S, int Hq, int Hkv, int Tmax, const void* q, const void* k_new,
                const void* v_new, void* K, void* V, const int* lengths, void* out,
                cudaStream_t stream) {
  if (hd == 64)
    return dispatch_group<T, 64>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
  if (hd == 128)
    return dispatch_group<T, 128>(S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, lengths, out, stream);
  return kUnsupported;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous:
// q/out (S, 1, Hq, hd), k_new/v_new (S, 1, Hkv, hd), K/V (S, Hkv, Tmax, hd),
// lengths (S,) int32 on the device.
int bllm_fused_decode_step(int dtype, int hd, int S, int Hq, int Hkv, int Tmax,
                           const void* q, const void* k_new, const void* v_new, void* K,
                           void* V, const void* lengths, void* out, void* stream) {
  if (S < 1 || Hkv < 1 || Hq % Hkv != 0 || Tmax < 1) return kUnsupported;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, len, out, st);
    case 1: return dispatch_hd<__half>(hd, S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, len, out, st);
    case 2:
      return dispatch_hd<__nv_bfloat16>(hd, S, Hq, Hkv, Tmax, q, k_new, v_new, K, V, len, out, st);
    default: return kUnsupported;
  }
}

const char* bllm_error_string(int err) {
  if (err == kUnsupported) return "unsupported dtype, head dim or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
