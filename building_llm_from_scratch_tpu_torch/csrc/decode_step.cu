// Fused single-token decode step for Hopper (sm_90a): append + attend, as
// split-KV flash-decoding (B5).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/decode_step.py
// (fused_decode_step -> _kernel): for every slot b and kv head h it writes
// the new k/v row into the caches at position t = lengths[b], in place, and
// attends the G = Hq/Hkv query rows of that kv head over positions [0, t]
// with scale 1/sqrt(hd), fp32 scores, an fp32 softmax and fp32 accumulators;
// the output is rounded once, to the q dtype.
//
// What bounds it: memory bandwidth. Each (slot, kv head) pane reads t + 1
// rows of K and of V for 4*G*hd operations a row (4 per byte at G 4 in
// bf16), far under the card's operations-per-byte line, so the least time
// is the K/V bytes of the valid prefix over 3.35 TB/s.
//
// Design:
//   * The cache axis is split so the card fills: the grid is (n_splits,
//     Hkv * group chunks, S) and a block owns C consecutive positions of
//     one (slot, kv head) pane. C and n_splits come from the host plan
//     (ops/decode_step.split_kv_plan): C = 64 KB / (2 * hd * element size)
//     (256 positions at hd 64 in 16 bits, 128 at hd 128 or in fp32, 64 at
//     hd 128 in fp32), so a split's K and V always fit shared memory and
//     all of its loads are in flight at once; no ring is needed. The plan
//     depends on Tmax, hd and dtype only, never on S or a row's length, so
//     a row's output has the same bits alone or co-batched. A block whose
//     split starts past lengths[b] returns at once; lengths stay on the
//     device.
//   * Warp w of a block owns the 32 positions C0 + 32 w ...: its lane 0
//     issues TMA loads of those K and V rows (a 2-D tensor map over the
//     (S * Hkv * Tmax, hd) view, 128-byte swizzled panels) on its own
//     mbarrier, only if its first position is <= t. Scores: lane j owns
//     position C0 + 32 w + j and reads its K row from shared memory (the
//     swizzle makes eight consecutive rows hit eight different banks), dot
//     it with the group's query rows (fp32, broadcast from shared memory);
//     one warp max and one warp sum per query row; P.V: lane l accumulates
//     output elements [l * E, l * E + E) (E = hd / 32) over the warp's
//     valid rows, the probabilities broadcast from shared memory. The warps
//     merge their (m, l, o) in shared memory (over the tiles, which they no
//     longer need), and the block writes its split's partial (m, l, o[hd])
//     in fp32 to the workspace (S, Hq, n_splits, hd + 2).
//   * The append: the warp whose rows hold t, after its loads have landed,
//     writes k_new/v_new over row t in shared memory and (group chunk 0
//     only) into the caches; no block uses the cache's old row t.
//   * A second, small kernel merges splits 0 .. t / C of each (slot, query
//     head): thread (group, d) folds the splits j = group, group + NG, ...
//     online (its loads do not wait on each other), then column d merges
//     the NG groups in order: deterministic, no atomics. It rounds the
//     output to the q dtype. It is launched programmatically dependent
//     (PDL): the split blocks trigger it once they have issued their loads
//     and it waits for the split pass in griddepcontrol.wait, so its launch
//     latency hides under the split pass.
//   * Group chunks: up to 8 query rows a block (GT = 1, 2, 4 or 8, the
//     smallest that covers G); G > 8 takes more blocks on the grid's y axis.
//   Registers (nvcc -Xptxas -v on the H100 machine's toolchain, printed by
//   chip_smoke.py phase 2): the split kernel 37-96 a thread over its 24
//   instantiations (54 at bf16, hd 64, GT 4; 80-96 at GT 8), the merge 32;
//   no spills. At 54 registers and ~70 KB of shared memory, three blocks
//   share an SM.
//
// Known gaps (scripts/decode_step_timing.py, PERF.md): every block loads
// its whole split before it computes, so each wave of blocks pays the full
// load latency and at 32,768-long caches the split pass reaches about half
// the memory rate; persistent blocks streaming splits through a ring would
// overlap one split's compute with the next one's loads.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after the launches, kUnsupported for a dtype, head dim
// or plan it is not instantiated for, kNoTensorMap if the driver refuses a
// tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace bllm::sm90;

constexpr int kUnsupported = 100000;
constexpr int kNoTensorMap = 100001;
constexpr int kRows = 32;              // positions of one warp
constexpr int kPanelBytes = kRows * 128;
constexpr int kSplitBytes = 65536;     // K and V bytes of one split
constexpr int kCombineThreads = 1024;
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename T, int HD> struct Geom {
  static constexpr int kSplit = kSplitBytes / (2 * HD * static_cast<int>(sizeof(T)));  // C
  static constexpr int kWarps = kSplit / kRows;
  static constexpr int kPanels = HD * static_cast<int>(sizeof(T)) / 128;
  static constexpr int kTileBytes = kPanels * kPanelBytes;   // K (or V) rows of one warp
  static constexpr int kChunks = HD * static_cast<int>(sizeof(T)) / 16;   // 16 B a row
  static_assert(kWarps >= 1 && kWarps <= 8 && kChunks <= 32, "plan out of range");
  static constexpr size_t smem(int gt) {
    return 1024 + static_cast<size_t>(kWarps) * 2 * kTileBytes +
           static_cast<size_t>(gt) * HD * 4 + static_cast<size_t>(kWarps) * gt * kRows * 4 +
           kWarps * 8;
  }
};

// byte offset of byte `byte` of row r in a warp's tile of 128-byte swizzled
// panels (the 16-byte chunk index is XORed with r mod 8)
__device__ __forceinline__ int swz(int r, int byte) {
  return (byte >> 7) * kPanelBytes + r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// lane's E elements of row r of a V tile: bytes [lane * E * size, ...)
template <typename T, int E>
__device__ __forceinline__ void load_v(const unsigned char* tile, int r, int lane,
                                       float (&v)[E]) {
  constexpr int B = E * static_cast<int>(sizeof(T));
  const unsigned char* src = tile + swz(r, lane * B);
  if constexpr (B == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(src);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = to_f(x[e]);
  } else if constexpr (B == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = to_f(x[e]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = to_f(x[e]);
  }
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(Geom<T, HD>::kWarps * 32)
decode_split_kernel(const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                    const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, T* __restrict__ K, T* __restrict__ V,
                    const int* __restrict__ lengths, float* __restrict__ ws, int Hq, int Hkv,
                    int Tmax, int n_splits, float scale_log2) {
  using Gm = Geom<T, HD>;
  constexpr int NW = Gm::kWarps;
  constexpr int E = HD / 32;                    // output elements of a lane
  constexpr int VEC = 16 / sizeof(T);           // elements of a 16-byte chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* sm_q = reinterpret_cast<float*>(tiles + NW * 2 * Gm::kTileBytes);
  float* sm_p = sm_q + GT * HD;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm_p + NW * GT * kRows);

  const int G = Hq / Hkv;
  const int n_gc = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int h = blockIdx.y / n_gc;
  const int gc = blockIdx.y - h * n_gc;
  const int b = blockIdx.z;
  const int g0 = gc * GT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int t = lengths[b];
  t = t < 0 ? 0 : (t > Tmax - 1 ? Tmax - 1 : t);
  const int c0 = split * Gm::kSplit;
  if (c0 > t) return;                           // past the row: no work, no partial
  const int p0 = c0 + warp * kRows;             // the warp's first position
  const bool active = p0 <= t;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  unsigned char* sK = tiles + warp * 2 * Gm::kTileBytes;
  unsigned char* sV = sK + Gm::kTileBytes;

  if (active && lane == 0) {
    mbar_init(&bar[warp], 1);
    mbar_fence_init();
    mbar_expect_tx(&bar[warp], 2 * Gm::kTileBytes);
    const int row = static_cast<int>(bh * Tmax) + p0;
    constexpr int kPanelCols = 128 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int p = 0; p < Gm::kPanels; ++p) {
      tma_load_2d(sK + p * kPanelBytes, &tmK, &bar[warp], p * kPanelCols, row);
      tma_load_2d(sV + p * kPanelBytes, &tmV, &bar[warp], p * kPanelCols, row);
    }
  }
  // the merge launch (PDL) may start once every block has issued its loads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int i = threadIdx.x; i < GT * HD; i += NW * 32) {
    const int g = i / HD;
    sm_q[i] = (g0 + g < G) ? to_f(q[(static_cast<size_t>(b) * Hq + h * G + g0) * HD + i]) : 0.f;
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

  if (active) {
    mbar_wait(&bar[warp], 0);
    if (t - p0 < kRows) {
      // the append: row t takes k_new/v_new, in shared memory and the caches
      const int r = t - p0;
      if (lane < Gm::kChunks) {
        const uint4 kc = reinterpret_cast<const uint4*>(k_new + bh * HD)[lane];
        const uint4 vc = reinterpret_cast<const uint4*>(v_new + bh * HD)[lane];
        *reinterpret_cast<uint4*>(sK + swz(r, lane * 16)) = kc;
        *reinterpret_cast<uint4*>(sV + swz(r, lane * 16)) = vc;
        if (gc == 0) {
          reinterpret_cast<uint4*>(K + (bh * Tmax + t) * HD)[lane] = kc;
          reinterpret_cast<uint4*>(V + (bh * Tmax + t) * HD)[lane] = vc;
        }
      }
      __syncwarp();
    }

    // scores: lane j owns position p0 + j
    const bool valid = p0 + lane <= t;
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < Gm::kChunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(sK + swz(lane, c * 16));
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j4 = 0; j4 < VEC; j4 += 4) {
          const float k0 = to_f(kv[j4]), k1 = to_f(kv[j4 + 1]);
          const float k2 = to_f(kv[j4 + 2]), k3 = to_f(kv[j4 + 3]);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float4 qv = *reinterpret_cast<const float4*>(sm_q + g * HD + c * VEC + j4);
            s[g] = fmaf(qv.x, k0, s[g]);
            s[g] = fmaf(qv.y, k1, s[g]);
            s[g] = fmaf(qv.z, k2, s[g]);
            s[g] = fmaf(qv.w, k3, s[g]);
          }
        }
      }
    }
    // softmax over the warp's rows, in the exp2 domain (lane 0 is valid)
    float* wp = sm_p + warp * GT * kRows;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float sg = valid ? s[g] * scale_log2 : -INFINITY;
      m[g] = warp_max(sg);
      const float pe = valid ? exp2f(sg - m[g]) : 0.f;
      l[g] = warp_sum(pe);
      wp[g * kRows + lane] = pe;
    }
    __syncwarp();

    // P.V over the valid rows (rows past t are never read)
    const int n = min(kRows, t - p0 + 1);
    for (int j0 = 0; j0 < n; j0 += 4) {
      float4 pv[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) pv[g] = *reinterpret_cast<const float4*>(wp + g * kRows + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u < n) {
          float vv[E];
          load_v<T, E>(sV, j0 + u, lane, vv);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float pg = u == 0 ? pv[g].x : (u == 1 ? pv[g].y : (u == 2 ? pv[g].z : pv[g].w));
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vv[e], acc[g][e]);
          }
        }
      }
    }
  }

  // merge the warps' partials over the tiles (no warp reads them any more)
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(tiles);
  float* sm_l = sm_m + NW * GT;
  float* sm_acc = sm_l + NW * GT;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp * GT + g] = m[g];
      sm_l[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[(warp * GT + g) * HD + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  float* part = ws + ((static_cast<size_t>(b) * Hq + h * G + g0) * n_splits + split) * (HD + 2);
  for (int i = threadIdx.x; i < GT * HD; i += NW * 32) {
    const int g = i / HD, d = i - g * HD;
    if (g0 + g >= G) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w * GT + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      // a warp past t has m = -inf and weighs exp2(-inf) = 0
      const float c = exp2f(sm_m[w * GT + g] - M);
      L = fmaf(sm_l[w * GT + g], c, L);
      O = fmaf(sm_acc[(w * GT + g) * HD + d], c, O);
    }
    float* pg = part + static_cast<size_t>(g) * n_splits * (HD + 2);
    pg[2 + d] = O;
    if (d == 0) {
      pg[0] = M;
      pg[1] = L;
    }
  }
}

// out[b, hq] = sum_j o_j 2^(m_j - M) / sum_j l_j 2^(m_j - M) over the splits
// j = 0 .. t / C: one block per (query head, slot). Thread (grp, d) merges
// the splits j = grp, grp + NG, ... online (one round trip to L2: its loads
// do not wait on each other), then column d merges the NG groups in order.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                      T* __restrict__ out, int Hq, int Tmax, int split_len, int n_splits) {
  constexpr int NG = kCombineThreads / HD;   // the splits' partition: j = grp mod NG
  constexpr int P = HD + 2;
  __shared__ float grp_m[NG], grp_l[NG];
  __shared__ float grp_o[NG][HD];
  const int hq = blockIdx.x, b = blockIdx.y;
  const int grp = threadIdx.x / HD, d = threadIdx.x - grp * HD;
  int t = lengths[b];
  t = t < 0 ? 0 : (t > Tmax - 1 ? Tmax - 1 : t);
  const int n = t / split_len + 1;
  const float* base = ws + (static_cast<size_t>(b) * Hq + hq) * n_splits * P;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the split pass is done

  float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll 8
  for (int j = grp; j < n; j += NG) {
    const float* pj = base + static_cast<size_t>(j) * P;
    const float mj = pj[0];
    const float m_new = fmaxf(m, mj);
    const float c_old = exp2f(m - m_new), c_j = exp2f(mj - m_new);   // exp2(-inf) = 0
    l = fmaf(l, c_old, pj[1] * c_j);
    o = fmaf(o, c_old, pj[2 + d] * c_j);
    m = m_new;
  }
  grp_o[grp][d] = o;
  if (d == 0) {
    grp_m[grp] = m;
    grp_l[grp] = l;
  }
  __syncthreads();
  if (grp == 0) {
    float M = grp_m[0];
#pragma unroll
    for (int k = 1; k < NG; ++k) M = fmaxf(M, grp_m[k]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float c = exp2f(grp_m[k] - M);   // a group with no split weighs 0
      L = fmaf(grp_l[k], c, L);
      O = fmaf(grp_o[k][d], c, O);
    }
    out[(static_cast<size_t>(b) * Hq + hq) * HD + d] = from_f<T>(O / L);
  }
}

struct Call {
  int S, Hq, Hkv, Tmax, split_len, n_splits;
  const void *q, *k_new, *v_new;
  void *K, *V;
  const int* lengths;
  float* ws;
  void* out;
  cudaStream_t stream;
};

template <typename T> constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int HD, int GT>
int launch(const Call& a) {
  using Gm = Geom<T, HD>;
  if (a.split_len != Gm::kSplit || a.n_splits != (a.Tmax + Gm::kSplit - 1) / Gm::kSplit)
    return kUnsupported;
  const unsigned long long rows = static_cast<unsigned long long>(a.S) * a.Hkv * a.Tmax;
  CUtensorMap tk, tv;
  if (!make_2d_map(&tk, map_type<T>(), sizeof(T), a.K, rows, HD, kRows) ||
      !make_2d_map(&tv, map_type<T>(), sizeof(T), a.V, rows, HD, kRows))
    return kNoTensorMap;
  const size_t smem = Gm::smem(GT);
  auto kernel = decode_split_kernel<T, HD, GT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_gc = (a.Hq / a.Hkv + GT - 1) / GT;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  kernel<<<dim3(a.n_splits, a.Hkv * n_gc, a.S), Gm::kWarps * 32, smem, a.stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), static_cast<T*>(a.K), static_cast<T*>(a.V), a.lengths,
      a.ws, a.Hq, a.Hkv, a.Tmax, a.n_splits, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge is launched programmatically dependent (PDL): its blocks are
  // set up while the split pass runs and wait for it in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hq, a.S);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, HD>, static_cast<const float*>(a.ws),
                           a.lengths, static_cast<T*>(a.out), a.Hq, a.Tmax, a.split_len,
                           a.n_splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_group(const Call& a) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<T, HD, 1>(a);
  if (G <= 2) return launch<T, HD, 2>(a);
  if (G <= 4) return launch<T, HD, 4>(a);
  return launch<T, HD, 8>(a);
}

template <typename T>
int dispatch_hd(int hd, const Call& a) {
  if (hd == 64) return dispatch_group<T, 64>(a);
  if (hd == 128) return dispatch_group<T, 128>(a);
  return kUnsupported;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous and
// 16-byte aligned: q/out (S, 1, Hq, hd), k_new/v_new (S, 1, Hkv, hd), K/V
// (S, Hkv, Tmax, hd), lengths (S,) int32 on the device; ws the fp32
// workspace (S, Hq, n_splits, hd + 2). split_len and n_splits are the host
// plan's (ops/decode_step.split_kv_plan), checked against the kernel's.
int bllm_fused_decode_step(int dtype, int hd, int S, int Hq, int Hkv, int Tmax, int split_len,
                           int n_splits, const void* q, const void* k_new, const void* v_new,
                           void* K, void* V, const void* lengths, void* ws, void* out,
                           void* stream) {
  if (S < 1 || S > 65535 || Hkv < 1 || Hq % Hkv != 0 || Tmax < 1 ||
      static_cast<long long>(S) * Hkv * Tmax >= (1ll << 31))
    return kUnsupported;
  const Call a{S,     Hq,    Hkv,   Tmax, split_len, n_splits, q, k_new, v_new, K, V,
               static_cast<const int*>(lengths), static_cast<float*>(ws), out,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, a);
    case 1: return dispatch_hd<__half>(hd, a);
    case 2: return dispatch_hd<__nv_bfloat16>(hd, a);
    default: return kUnsupported;
  }
}

const char* bllm_error_string(int err) {
  if (err == kUnsupported) return "unsupported dtype, head dim or shape";
  if (err == kNoTensorMap) return "cuTensorMapEncodeTiled failed (no tensor map)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
