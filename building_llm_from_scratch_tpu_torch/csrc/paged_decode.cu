// Paged single-token decode attention for Hopper (sm_90a), as split-KV
// flash-decoding over a page table (B7).
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
// Design: B5's split pass (csrc/decode_step.cu), with only the load stage
// changed.
//   * The plan is B5's, split_kv_plan(M * P, hd, dtype): the table's logical
//     extent M * P stands for Tmax, so the plan never looks at S or the
//     lengths. The grid is (n_splits, Hkv * group chunks, S); a block whose
//     split starts past lengths[s] returns at once; table and lengths stay
//     on the device.
//   * Load stage: warp w of a block owns 32 logical positions p0 ...
//     p0 + 31. Its 32 rows are read as boxes of b rows, b the largest power
//     of two that divides both P and 32 (ops/decode_step.paged_box_rows), so
//     every box lies inside one page for any page size P >= 1: lane j issues
//     the TMA loads of box j (rows p0 + j b ...) from a 2-D tensor map over
//     the pool seen as (N * Hkv * P, hd), with B5's 128-byte swizzle, after
//     reading its own table entry. Boxes that start past t are not loaded,
//     so pages past a row's frontier are never read. The rows land where
//     B5's contiguous load puts them (the swizzle follows the shared-memory
//     address), so the scores, softmax, P.V and the block merge are B5's
//     own code (decode_split.cuh), and at equal rows the output is B5's bit
//     for bit.
//   * The merge is B5's merge kernel, launched programmatically dependent.
//   * Host cost: the two tensor maps (K and V pools) are encoded once per
//     (pool pointer, shape, box) and kept in a small table in this file, so
//     a serving tick does not encode them again for every layer and call.
//     A map holds only the pointer, the dims and the box, so a kept map is
//     right for any pool that has them.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after the launches, kUnsupported for a dtype, head
// dim, box or plan it is not instantiated for, kNoTensorMap if the driver
// refuses a tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <mutex>

#include "decode_split.cuh"

namespace {

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(Geom<T, HD>::kWarps * 32)
paged_split_kernel(const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                   const T* __restrict__ q, const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ ws, int Hq, int Hkv,
                   int P, int N, int M, int box, int n_splits, float scale_log2) {
  using Gm = Geom<T, HD>;
  constexpr int E = HD / 32;
  extern __shared__ unsigned char smem_raw[];
  const SplitBlock<T, HD, GT> blk(smem_raw, Hq, Hkv);
  const int b = blk.b, h = blk.h, warp = blk.warp, lane = blk.lane;

  const int Tmax = M * P;                       // the row's logical extent
  int t = lengths[b];
  t = t < 0 ? 0 : (t > Tmax - 1 ? Tmax - 1 : t);
  const int c0 = blk.split * Gm::kSplit;
  if (c0 > t) return;                           // past the row: no work, no partial
  const int p0 = c0 + warp * kRows;
  const bool active = p0 <= t;
  unsigned char* sK = blk.k_tile();
  unsigned char* sV = blk.v_tile();
  uint64_t* bar = &blk.bar[warp];

  if (active) {
    // boxes of `box` rows; those starting past t are not loaded
    const int n_box = min(kRows / box, (t - p0) / box + 1);
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect_tx(bar, static_cast<uint32_t>(n_box * box) * 128u * Gm::kPanels * 2u);
    }
    __syncwarp();
    if (lane < n_box) {
      const int first = p0 + lane * box;
      const int col = first / P;
      int page = table[static_cast<size_t>(b) * M + col];
      page = page < 0 ? 0 : (page > N - 1 ? N - 1 : page);
      const int row = (page * Hkv + h) * P + (first - col * P);
      const int at = lane * box * 128;
#pragma unroll
      for (int p = 0; p < Gm::kPanels; ++p) {
        tma_load_2d(sK + p * kPanelBytes + at, &tmK, bar, p * Gm::kPanelCols, row);
        tma_load_2d(sV + p * kPanelBytes + at, &tmV, bar, p * Gm::kPanelCols, row);
      }
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
    attend_warp<T, HD, GT>(sK, sV, blk.sm_q, blk.sm_p + warp * GT * kRows, p0, t, lane,
                           scale_log2, m, l, acc);
  }
  store_partial<T, HD, GT>(blk, ws, Hq, n_splits, m, l, acc);
}

// tensor maps kept across calls, keyed by everything a map holds
struct MapKey {
  const void* base;
  unsigned long long rows;
  int hd, elt, type, box;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && hd == o.hd && elt == o.elt && type == o.type &&
           box == o.box;
  }
};
struct KeptMap {
  MapKey key;
  CUtensorMap map;
};
constexpr int kKeptMaps = 128;
std::mutex g_maps_mu;
KeptMap g_maps[kKeptMaps];
int g_n_maps = 0, g_next_map = 0;

bool pool_map(CUtensorMap* out, CUtensorMapDataType type, int elt, const void* base,
              unsigned long long rows, int hd, int box) {
  const MapKey key{base, rows, hd, elt, static_cast<int>(type), box};
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_n_maps; ++i) {
    if (g_maps[i].key == key) {
      *out = g_maps[i].map;
      return true;
    }
  }
  if (!make_2d_map(out, type, elt, base, rows, hd, box)) return false;
  KeptMap& slot = g_maps[g_next_map];
  slot.key = key;
  slot.map = *out;
  g_next_map = (g_next_map + 1) % kKeptMaps;
  if (g_n_maps < kKeptMaps) ++g_n_maps;
  return true;
}

struct Args {
  int S, Hq, Hkv, P, N, M, box, split_len, n_splits;
  const void *q, *K, *V;
  const int *table, *lengths;
  float* ws;
  void* out;
  cudaStream_t stream;
};

// the split pass then the merge, for one dtype, head dim and group chunk
template <typename T, int HD, int GT> struct Launch {
  static int run(const Args& a) {
    using Gm = Geom<T, HD>;
    const int Tmax = a.M * a.P;
    if (a.split_len != Gm::kSplit || a.n_splits != (Tmax + Gm::kSplit - 1) / Gm::kSplit)
      return kUnsupported;
    const unsigned long long rows = static_cast<unsigned long long>(a.N) * a.Hkv * a.P;
    CUtensorMap tk, tv;
    if (!pool_map(&tk, map_type<T>(), sizeof(T), a.K, rows, HD, a.box) ||
        !pool_map(&tv, map_type<T>(), sizeof(T), a.V, rows, HD, a.box))
      return kNoTensorMap;
    const size_t smem = Gm::smem(GT);
    auto kernel = paged_split_kernel<T, HD, GT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_gc = (a.Hq / a.Hkv + GT - 1) / GT;
    const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
    kernel<<<dim3(a.n_splits, a.Hkv * n_gc, a.S), Gm::kWarps * 32, smem, a.stream>>>(
        tk, tv, static_cast<const T*>(a.q), a.table, a.lengths, a.ws, a.Hq, a.Hkv, a.P, a.N, a.M,
        a.box, a.n_splits, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_combine<T, HD>(a.ws, a.lengths, a.out, a.S, a.Hq, Tmax, a.split_len,
                                 a.n_splits, a.stream);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous,
// q, the pools and out 16-byte aligned: q/out (S, 1, Hq, hd), K/V pools
// (N, Hkv, P, hd), table (S, M) int32 and lengths (S,) int32, all on the
// device; ws the fp32 workspace (S, Hq, n_splits, hd + 2). box is the
// rows of one TMA box (a power of two dividing both P and 32); split_len
// and n_splits the host plan's (ops/decode_step.split_kv_plan(M * P, ...)),
// checked against the kernel's.
int bllm_paged_decode(int dtype, int hd, int S, int Hq, int Hkv, int P, int N, int M, int box,
                      int split_len, int n_splits, const void* q, const void* K, const void* V,
                      const void* table, const void* lengths, void* ws, void* out,
                      void* stream) {
  if (S < 1 || S > 65535 || Hkv < 1 || Hq % Hkv != 0 || P < 1 || N < 1 || M < 1 ||
      static_cast<long long>(N) * Hkv * P >= (1ll << 31) ||
      static_cast<long long>(M) * P >= (1ll << 31) || box < 1 || box > kRows ||
      (box & (box - 1)) != 0 || P % box != 0)
    return kUnsupported;
  const Args a{S,        Hq,       Hkv, P, N, M, box, split_len, n_splits, q, K, V,
               static_cast<const int*>(table), static_cast<const int*>(lengths),
               static_cast<float*>(ws), out, static_cast<cudaStream_t>(stream)};
  return dispatch_split<Launch>(dtype, hd, Hq / Hkv, a);
}

}  // extern "C"
