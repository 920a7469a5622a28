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
//   * The warp's scores, softmax and P.V, the block's merge of its warps
//     and the merge kernel live in decode_split.cuh, shared with B7
//     (paged_decode.cu), which differs only in how its rows are loaded.
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

#include "decode_split.cuh"

namespace {

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(Geom<T, HD>::kWarps * 32)
decode_split_kernel(const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                    const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, T* __restrict__ K, T* __restrict__ V,
                    const int* __restrict__ lengths, float* __restrict__ ws, int Hq, int Hkv,
                    int Tmax, int n_splits, float scale_log2) {
  using Gm = Geom<T, HD>;
  constexpr int E = HD / 32;                    // output elements of a lane
  extern __shared__ unsigned char smem_raw[];
  const SplitBlock<T, HD, GT> blk(smem_raw, Hq, Hkv);
  const int b = blk.b, h = blk.h, warp = blk.warp, lane = blk.lane;

  int t = lengths[b];
  t = t < 0 ? 0 : (t > Tmax - 1 ? Tmax - 1 : t);
  const int c0 = blk.split * Gm::kSplit;
  if (c0 > t) return;                           // past the row: no work, no partial
  const int p0 = c0 + warp * kRows;             // the warp's first position
  const bool active = p0 <= t;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  unsigned char* sK = blk.k_tile();
  unsigned char* sV = blk.v_tile();
  uint64_t* bar = &blk.bar[warp];

  // the warp's 32 contiguous rows of the (S * Hkv * Tmax, hd) cache view
  if (active && lane == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 2 * Gm::kTileBytes);
    const int row = static_cast<int>(bh * Tmax) + p0;
#pragma unroll
    for (int p = 0; p < Gm::kPanels; ++p) {
      tma_load_2d(sK + p * kPanelBytes, &tmK, bar, p * Gm::kPanelCols, row);
      tma_load_2d(sV + p * kPanelBytes, &tmV, bar, p * Gm::kPanelCols, row);
    }
  }
  // the merge launch (PDL) may start once every block has issued its loads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  blk.load_q(q, Hq);
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
    mbar_wait(bar, 0);
    if (t - p0 < kRows) {
      // the append: row t takes k_new/v_new, in shared memory and the caches
      const int r = t - p0;
      if (lane < Gm::kChunks) {
        const uint4 kc = reinterpret_cast<const uint4*>(k_new + bh * HD)[lane];
        const uint4 vc = reinterpret_cast<const uint4*>(v_new + bh * HD)[lane];
        *reinterpret_cast<uint4*>(sK + swz(r, lane * 16)) = kc;
        *reinterpret_cast<uint4*>(sV + swz(r, lane * 16)) = vc;
        if (blk.gc == 0) {
          reinterpret_cast<uint4*>(K + (bh * Tmax + t) * HD)[lane] = kc;
          reinterpret_cast<uint4*>(V + (bh * Tmax + t) * HD)[lane] = vc;
        }
      }
      __syncwarp();
    }
    attend_warp<T, HD, GT>(sK, sV, blk.sm_q, blk.sm_p + warp * GT * kRows, p0, t, lane,
                           scale_log2, m, l, acc);
  }
  store_partial<T, HD, GT>(blk, ws, Hq, n_splits, m, l, acc);
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

// the split pass then the merge, for one dtype, head dim and group chunk
template <typename T, int HD, int GT> struct Launch {
  static int run(const Call& a) {
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
    return launch_combine<T, HD>(a.ws, a.lengths, a.out, a.S, a.Hq, a.Tmax, a.split_len,
                                 a.n_splits, a.stream);
  }
};

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
  return dispatch_split<Launch>(dtype, hd, Hq / Hkv, a);
}

const char* bllm_error_string(int err) {
  if (err == kUnsupported) return "unsupported dtype, head dim or shape";
  if (err == kNoTensorMap) return "cuTensorMapEncodeTiled failed (no tensor map)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
