// The split-KV decode pass shared by B5 (csrc/decode_step.cu: contiguous
// slot caches, with the append) and B7 (csrc/paged_decode.cu: a shared page
// pool read through a page table). Only their load stages differ; what a
// warp does once its 32 K and V rows have landed in shared memory, how a
// block merges its warps into a split's partial, and the merge kernel over
// the splits are here, so the two kernels give the same bits on the same
// logical rows.
//
// Layout: a block owns C = kSplitBytes / (2 hd elt) consecutive positions
// of one (slot, kv head) pane and GT query rows of its group (the host plan
// ops/decode_step.split_kv_plan); warp w owns the 32 positions C0 + 32 w ...
// Each warp's K and V rows sit in shared memory as 128-byte panels written
// by TMA with the 128-byte swizzle (the 16-byte chunk index XORed with the
// row mod 8), so eight consecutive rows hit eight different banks. The
// block writes its split's partial (m, l, o[hd]) in fp32 to the workspace
// (S, Hq, n_splits, hd + 2): m the max of the scores in the exp2 domain, l
// the sum of 2^(s - m), o the unnormalised sum of 2^(s - m) v. The merge
// kernel folds splits 0 .. t / C of each (slot, query head) and rounds the
// output once, to the q dtype.

#pragma once

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

template <typename T> constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int HD> struct Geom {
  static constexpr int kSplit = kSplitBytes / (2 * HD * static_cast<int>(sizeof(T)));  // C
  static constexpr int kWarps = kSplit / kRows;
  static constexpr int kPanels = HD * static_cast<int>(sizeof(T)) / 128;
  static constexpr int kPanelCols = 128 / static_cast<int>(sizeof(T));
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

// The block's place in the grid (n_splits, Hkv * group chunks, S) and its
// shared memory: per warp a K and a V tile (1024-aligned, as the 128-byte
// swizzle wants), then the group's query rows in fp32, the warps'
// probabilities and one mbarrier a warp.
template <typename T, int HD, int GT> struct SplitBlock {
  using Gm = Geom<T, HD>;
  int G, split, h, gc, b, g0, warp, lane;
  unsigned char* tiles;
  float *sm_q, *sm_p;
  uint64_t* bar;

  __device__ __forceinline__ SplitBlock(unsigned char* smem_raw, int Hq, int Hkv) {
    tiles = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    sm_q = reinterpret_cast<float*>(tiles + Gm::kWarps * 2 * Gm::kTileBytes);
    sm_p = sm_q + GT * HD;
    bar = reinterpret_cast<uint64_t*>(sm_p + Gm::kWarps * GT * kRows);
    G = Hq / Hkv;
    const int n_gc = (G + GT - 1) / GT;
    split = blockIdx.x;
    h = blockIdx.y / n_gc;
    gc = blockIdx.y - h * n_gc;
    b = blockIdx.z;
    g0 = gc * GT;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
  }
  __device__ __forceinline__ unsigned char* k_tile() const {
    return tiles + warp * 2 * Gm::kTileBytes;
  }
  __device__ __forceinline__ unsigned char* v_tile() const { return k_tile() + Gm::kTileBytes; }

  // the group's query rows into shared memory, in fp32
  __device__ __forceinline__ void load_q(const T* __restrict__ q, int Hq) const {
    for (int i = threadIdx.x; i < GT * HD; i += Gm::kWarps * 32) {
      const int g = i / HD;
      sm_q[i] = (g0 + g < G) ? to_f(q[(static_cast<size_t>(b) * Hq + h * G + g0) * HD + i]) : 0.f;
    }
  }
};

// One warp over its rows p0 .. min(p0 + 31, t), whose K and V have landed
// in its tiles: lane j owns position p0 + j for the scores (its K row read
// whole from shared memory, dotted with the group's query rows in fp32);
// one warp max and one warp sum per query row, in the exp2 domain; P.V with
// lane l accumulating output elements [l E, l E + E) (E = hd / 32) over the
// valid rows, the probabilities broadcast from shared memory. Rows past t
// are never read.
template <typename T, int HD, int GT>
__device__ __forceinline__ void attend_warp(const unsigned char* sK, const unsigned char* sV,
                                            const float* sm_q, float* wp, int p0, int t,
                                            int lane, float scale_log2, float (&m)[GT],
                                            float (&l)[GT], float (&acc)[GT][HD / 32]) {
  using Gm = Geom<T, HD>;
  constexpr int E = HD / 32;
  constexpr int VEC = 16 / sizeof(T);           // elements of a 16-byte chunk
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
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float sg = valid ? s[g] * scale_log2 : -INFINITY;
    m[g] = warp_max(sg);
    const float pe = valid ? exp2f(sg - m[g]) : 0.f;
    l[g] = warp_sum(pe);
    wp[g * kRows + lane] = pe;
  }
  __syncwarp();

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

// The block's warps merged into its split's partial (m, l, o[hd]) in the
// workspace, over the tiles (no warp reads them any more). Every thread of
// the block runs it.
template <typename T, int HD, int GT>
__device__ __forceinline__ void store_partial(const SplitBlock<T, HD, GT>& blk, float* ws, int Hq,
                                              int n_splits, const float (&m)[GT],
                                              const float (&l)[GT],
                                              const float (&acc)[GT][HD / 32]) {
  constexpr int NW = Geom<T, HD>::kWarps;
  constexpr int E = HD / 32;
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(blk.tiles);
  float* sm_l = sm_m + NW * GT;
  float* sm_acc = sm_l + NW * GT;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (blk.lane == 0) {
      sm_m[blk.warp * GT + g] = m[g];
      sm_l[blk.warp * GT + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[(blk.warp * GT + g) * HD + blk.lane * E + e] = acc[g][e];
  }
  __syncthreads();
  float* part = ws + ((static_cast<size_t>(blk.b) * Hq + blk.h * blk.G + blk.g0) * n_splits +
                      blk.split) * (HD + 2);
  for (int i = threadIdx.x; i < GT * HD; i += NW * 32) {
    const int g = i / HD, d = i - g * HD;
    if (blk.g0 + g >= blk.G) continue;
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
// do not wait on each other), then column d merges the NG groups in order:
// deterministic, no atomics. Launched programmatically dependent on the
// split pass, which it waits for in griddepcontrol.wait.
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

// Launches the merge programmatically dependent (PDL) on the split pass
// just queued on `stream`: its blocks are set up while the split pass runs.
template <typename T, int HD>
int launch_combine(const float* ws, const int* lengths, void* out, int S, int Hq, int Tmax,
                   int split_len, int n_splits, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, S);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, HD>, ws, lengths,
                                       static_cast<T*>(out), Hq, Tmax, split_len, n_splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Runs launch<T, HD, GT>(a) for the dtype code (0 fp32, 1 fp16, 2 bf16),
// the head dim (64 or 128) and the smallest group chunk GT of 1, 2, 4, 8
// that covers G = Hq / Hkv (G > 8 takes more blocks on the grid's y axis).
template <template <typename, int, int> class Launch, typename Args>
int dispatch_split(int dtype, int hd, int G, const Args& a) {
  auto by_group = [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int HD = decltype(h)::value;
    if (G <= 1) return Launch<T, HD, 1>::run(a);
    if (G <= 2) return Launch<T, HD, 2>::run(a);
    if (G <= 4) return Launch<T, HD, 4>::run(a);
    return Launch<T, HD, 8>::run(a);
  };
  auto by_hd = [&](auto t) {
    if (hd == 64) return by_group(t, std::integral_constant<int, 64>());
    if (hd == 128) return by_group(t, std::integral_constant<int, 128>());
    return kUnsupported;
  };
  switch (dtype) {
    case 0: return by_hd(float());
    case 1: return by_hd(__half());
    case 2: return by_hd(__nv_bfloat16());
    default: return kUnsupported;
  }
}

}  // namespace
