// Batched gathered LoRA delta (BGMV) for Hopper (sm_90a), as a grouped,
// split-D shrink pass and an expand pass (B6).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/decode_step.py
// (lora_bgmv -> _bgmv_kernel): for every row s of a single-token decode
// batch, with i = ids[s],
//
//   out[s] = 0                                        if i < 0 (base model)
//   out[s] = scales[i] * round_T(x[s] @ A[i]) @ B[i]  otherwise
//
// where x (S, D), the pool panes A[i] (D, r) and B[i] (r, O) share the
// dtype T, both products accumulate in fp32, the rank-r intermediate is
// rounded to T between them (the TPU kernel's xa.astype(b.dtype)), and the
// output is fp32 (S, O). Ids are clamped to [0, N-1] for reading, as the TPU
// kernel's index map does; a row with id < 0 reads nothing.
//
// What bounds it: memory latency, then bandwidth. Each pane element is read
// for two operations per row that uses it, far below the card's
// operations-per-byte line, so tensor cores would buy nothing: the least
// time is the bytes of the distinct adapters' panes, x and the output over
// the memory rate (under half a microsecond at the served shapes), well
// under the few microseconds a launch and one DRAM round trip take. So the
// design cuts round trips that wait on each other and keeps every pane
// byte read once, by as many blocks as the card can hold.
//
// Design:
//   * The plan (ops/decode_step.bgmv_plan(D, r, O, dtype), checked here) is
//     a function of D, r, O and the dtype only, never of S, the ids or N,
//     so a row's bits do not depend on its batch. With rp the least power
//     of two >= r: a D-split of Dc = (256 / rp) * (16 / elt) rows, whose
//     slice of a pane is one contiguous run of at most 4 KB; an O-tile of
//     Ot = min(2048, 16 KB / (rp * elt)) columns.
//   * Grouping: a row *leads* its adapter if it is the first row whose id
//     is >= 0 and clamps to the same pool row. Only leaders' blocks work;
//     the rest exit at once. Ids stay on the device (no host sync): each
//     block reads them into shared memory.
//   * Shrink pass, grid (D-splits, S), 256 threads: the leader's block
//     reads A's slice [j Dc, j Dc + Dc) x r once, one 16-byte load a
//     thread, and while it is in flight finds the group's first rows and
//     loads their x slices (one 16-byte load a thread and row), so a block
//     waits on one DRAM round trip after reading the ids. Thread (ty, k)
//     keeps the 16 / elt slice rows ty * 16 / elt ... of column k in
//     registers and dots them with each row's x, four rows at a time; the
//     partial sums over ty meet by warp shuffles and shared memory in a
//     fixed order, and the split's fp32 partial (r values) goes to the
//     workspace (S, n_splits, r).
//   * Expand pass, grid (O-tiles, S), launched programmatically dependent
//     (PDL) on the shrink: before it waits for the shrink, the leader's
//     block reads B's (r, tile) slice once (all its 16-byte loads in
//     flight) into shared memory, and a base row's block writes its zeros;
//     it also finds the group's rows then, so that after the wait it only
//     folds each row's partials (thread (row, k) loads up to 64 partials
//     at once, then adds them in the order j = 0, 1, ...), rounds
//     the sum to T (xa) and writes scale * xa @ B for the tile, one output
//     column a thread (k in order).
//   * Each row's sums run in one order whatever the size of its group, so
//     its output is bit-equal alone and co-batched.
//   * Rows with id < 0 are written as exact zeros; their panes are never
//     read. Pools are addressed through a row stride, so a layer's
//     (N, D, r) slice of the stacked (N, L, D, r) pool is read in place.
//   * Pointers or widths that are not 16-byte aligned take the same kernels
//     with element loads (VEC = false).
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry makes
// both launches and returns cudaGetLastError() after them, or kUnsupported
// for a dtype, shape or plan it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 256;
constexpr int kSliceBytes = 4096;      // A's slice of a split at r = rp
constexpr int kTileBytes = 16384;      // B's slice of an O-tile at r = rp
constexpr int kMaxTile = 2048;         // columns of an O-tile
constexpr int kRowChunk = 4;           // group rows a shrink pass holds at once
constexpr int kIdCache = 1024;         // ids kept in shared memory
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

int next_pow2(int r) {
  int rp = 1;
  while (rp < r) rp <<= 1;
  return rp;
}

// The rows' ids (the first kIdCache of them from shared memory) and the
// groups: row u belongs to pool row i's group if its id is >= 0 and clamps
// to i.
struct Ids {
  const int* ids;
  const int* cache;
  int N;
  __device__ __forceinline__ int operator()(int u) const { return u < kIdCache ? cache[u] : ids[u]; }
  __device__ __forceinline__ bool member(int u, int i) const {
    const int v = (*this)(u);
    return v >= 0 && (v < N ? v : N - 1) == i;
  }
};

__device__ __forceinline__ void cache_ids(int* sid, const int* ids, int S) {
  for (int u = threadIdx.x; u < S && u < kIdCache; u += kThreads) sid[u] = ids[u];
  __syncthreads();
}

// true (in every thread) if an earlier row belongs to pool row i's group
__device__ __forceinline__ bool has_leader_before(const Ids& id, int s, int i) {
  bool earlier = false;
  for (int u = threadIdx.x; u < s; u += kThreads) earlier |= id.member(u, i);
  return __syncthreads_or(earlier) != 0;
}

// thread 0 gathers the next rows of pool row i's group, from `cur` on, in
// row order (the leader first)
__device__ __forceinline__ void next_rows(const Ids& id, int i, int S, int most, int& cur,
                                          int* rows, int* n_rows) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (; cur < S && n < most; ++cur)
      if (id.member(cur, i)) rows[n++] = cur;
    *n_rows = n;
  }
  __syncthreads();
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
bgmv_shrink_kernel(const T* __restrict__ x, const T* __restrict__ A, const int* __restrict__ ids,
                   float* __restrict__ ws, int S, int D, int r, int rp, int N, int split_len,
                   int n_splits, long long a_stride) {
  constexpr int KT = 16 / static_cast<int>(sizeof(T));   // slice rows of a thread
  __shared__ __align__(16) T sA[kSliceBytes / sizeof(T)];
  __shared__ float red[kRowChunk][kThreads];
  __shared__ int sid[kIdCache];
  __shared__ int rows[kRowChunk];
  __shared__ int n_rows;
  // the expand launch (PDL) may start at once: it reads no partial before
  // it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int j = blockIdx.x, s = blockIdx.y;
  cache_ids(sid, ids, S);
  const Ids id{ids, sid, N};
  const int v = id(s);
  if (v < 0) return;
  const int i = v < N ? v : N - 1;
  if (has_leader_before(id, s, i)) return;

  // A's slice, rows [d0, d0 + dc) of pane i, is one contiguous run of at
  // most kSliceBytes: one 16-byte load a thread, left in flight while the
  // group's first rows are found and their x loaded
  const int d0 = j * split_len;
  const int dc = min(split_len, D - d0);
  const int n_el = dc * r;
  const T* a = A + static_cast<long long>(i) * a_stride + static_cast<long long>(d0) * r;
  const int nv = VEC ? n_el * static_cast<int>(sizeof(T)) / 16 : 0;
  uint4 araw = make_uint4(0u, 0u, 0u, 0u);
  if (static_cast<int>(threadIdx.x) < nv) araw = reinterpret_cast<const uint4*>(a)[threadIdx.x];
  for (int e = nv * KT + threadIdx.x; e < n_el; e += kThreads) sA[e] = a[e];

  // thread (ty, k) owns column k of the slice rows ty * KT ... ty * KT + KT - 1
  const int k = threadIdx.x % rp, ty = threadIdx.x / rp;
  const int dt = ty * KT;
  const int stride = rp > 32 ? rp : 32;         // entries of one column in red
  float xv[kRowChunk][KT];
  auto load_x = [&](int nr) {
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c) {
#pragma unroll
      for (int u = 0; u < KT; ++u) xv[c][u] = 0.f;
      if (c < nr && dt < dc) {
        const T* xs = x + static_cast<long long>(rows[c]) * D + d0 + dt;
        if (VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xs);
          const T* xe = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < KT; ++u) xv[c][u] = to_f(xe[u]);
        } else {
#pragma unroll
          for (int u = 0; u < KT; ++u)
            if (dt + u < dc) xv[c][u] = to_f(xs[u]);
        }
      }
    }
  };

  int cur = s;                                  // thread 0's scan of the rows
  next_rows(id, i, S, kRowChunk, cur, rows, &n_rows);
  int nr = n_rows;                              // >= 1: the leader
  load_x(nr);
  if (static_cast<int>(threadIdx.x) < nv) reinterpret_cast<uint4*>(sA)[threadIdx.x] = araw;
  __syncthreads();
  float av[KT];
#pragma unroll
  for (int u = 0; u < KT; ++u)
    av[u] = (k < r && dt + u < dc) ? to_f(sA[(dt + u) * r + k]) : 0.f;

  while (true) {
#pragma unroll
    for (int c = 0; c < kRowChunk; ++c) {
      float p = 0.f;
#pragma unroll
      for (int u = 0; u < KT; ++u) p = fmaf(xv[c][u], av[u], p);
      // the ty of one warp (rp < 32) meet by shuffles, the same order in
      // every lane of a column
      for (int off = 16; off >= rp; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      red[c][threadIdx.x] = p;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * rp; e += kThreads) {
      const int c = e / rp, kk = e - c * rp;
      if (kk < r) {
        float sum = 0.f;
        for (int w = kk; w < kThreads; w += stride) sum += red[c][w];
        ws[(static_cast<long long>(rows[c]) * n_splits + j) * r + kk] = sum;
      }
    }
    if (nr < kRowChunk) break;                    // the group had no more rows
    __syncthreads();                              // red and rows are rewritten next
    next_rows(id, i, S, kRowChunk, cur, rows, &n_rows);
    nr = n_rows;
    if (nr == 0) break;
    load_x(nr);
  }
}

// sum_j pw[j r] over j = 0 .. n - 1 in that order, n <= NS, its loads all
// in flight at once
template <int NS>
__device__ __forceinline__ float fold(const float* __restrict__ pw, int n, int r) {
  float pv[NS];
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) pv[jj] = jj < n ? pw[jj * r] : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < NS; ++jj)
    if (jj < n) sum += pv[jj];
  return sum;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
bgmv_expand_kernel(const T* __restrict__ B, const int* __restrict__ ids,
                   const float* __restrict__ scales, const float* __restrict__ ws,
                   float* __restrict__ out, int S, int r, int rp, int O, int N, int n_splits,
                   int tile, long long b_stride) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));   // elements of a 16-byte load
  constexpr int kLoads = kTileBytes / 16 / kThreads;      // B's 16-byte loads a thread
  __shared__ __align__(16) T sB[kTileBytes / sizeof(T)];
  __shared__ float sxa[kThreads];
  __shared__ int sid[kIdCache];
  __shared__ int rows[kThreads];
  __shared__ int n_rows;
  const int o0 = blockIdx.x * tile, s = blockIdx.y;
  const int ow = min(tile, O - o0);
  cache_ids(sid, ids, S);
  const Ids id{ids, sid, N};
  const int v = id(s);
  if (v < 0) {                                    // base-model row: exact zeros, no reads
    for (int c = threadIdx.x; c < ow; c += kThreads)
      out[static_cast<long long>(s) * O + o0 + c] = 0.f;
    return;
  }
  const int i = v < N ? v : N - 1;
  if (has_leader_before(id, s, i)) return;

  // Before the wait for the shrink: B's (r, ow) slice of pane i (all its
  // 16-byte loads in flight) into shared memory, and the group's first rows
  const T* b = B + static_cast<long long>(i) * b_stride + o0;
  if (VEC) {
    const int cw = ow / VE;                       // 16-byte loads of a row
    uint4 braw[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = threadIdx.x + q * kThreads;
      const int kk = c / cw, cc = c - kk * cw;
      if (c < r * cw) braw[q] = reinterpret_cast<const uint4*>(b + static_cast<long long>(kk) * O)[cc];
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = threadIdx.x + q * kThreads;
      const int kk = c / cw, cc = c - kk * cw;
      if (c < r * cw) reinterpret_cast<uint4*>(sB + kk * tile)[cc] = braw[q];
    }
  } else {
    for (int c = threadIdx.x; c < r * ow; c += kThreads) {
      const int kk = c / ow, cc = c - kk * ow;
      sB[kk * tile + cc] = b[static_cast<long long>(kk) * O + cc];
    }
  }
  const float sc = scales[i];
  const int per = kThreads / rp;                  // rows folded at once
  int cur = s;                                    // thread 0's scan of the rows
  next_rows(id, i, S, per, cur, rows, &n_rows);
  int nr = n_rows;                                // >= 1: the leader
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the shrink pass is done

  while (true) {
    // xa of each row: thread (c, k) folds row c's partials of column k in
    // the order j = 0, 1, ..., all its loads in flight at once, and rounds
    // the sum to T
    if (static_cast<int>(threadIdx.x) < nr * rp) {
      const int c = threadIdx.x / rp, kk = threadIdx.x - c * rp;
      float sum = 0.f;
      if (kk < r) {
        const float* pw = ws + static_cast<long long>(rows[c]) * n_splits * r + kk;
        if (n_splits <= 16) sum = fold<16>(pw, n_splits, r);
        else if (n_splits <= 32) sum = fold<32>(pw, n_splits, r);
        else if (n_splits <= 64) sum = fold<64>(pw, n_splits, r);
        else
#pragma unroll 16
          for (int jj = 0; jj < n_splits; ++jj) sum += pw[static_cast<long long>(jj) * r];
      }
      sxa[threadIdx.x] = to_f(from_f<T>(sum));
    }
    __syncthreads();
    for (int c = 0; c < nr; ++c) {
      const float* xa = sxa + c * rp;
      float* orow = out + static_cast<long long>(rows[c]) * O + o0;
      for (int col = threadIdx.x; col < ow; col += kThreads) {
        float acc = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < r; ++kk) acc = fmaf(xa[kk], to_f(sB[kk * tile + col]), acc);
        orow[col] = acc * sc;
      }
    }
    if (nr < per) break;                          // the group had no more rows
    __syncthreads();                              // sxa and rows are rewritten next
    next_rows(id, i, S, per, cur, rows, &n_rows);
    nr = n_rows;
    if (nr == 0) break;
  }
}

struct Call {
  int S, D, r, O, N, split_len, n_splits, tile, n_tiles;
  long long a_stride, b_stride;
  const void *x, *A, *B;
  const int* ids;
  const float* scales;
  float *ws, *out;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool VEC>
int launch_vec(const Call& a, int rp) {
  bgmv_shrink_kernel<T, VEC><<<dim3(a.n_splits, a.S), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.A), a.ids, a.ws, a.S, a.D, a.r, rp,
      a.N, a.split_len, a.n_splits, a.a_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the expand pass is launched programmatically dependent (PDL): its
  // blocks load B and write the base rows' zeros while the shrink runs
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_tiles, a.S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bgmv_expand_kernel<T, VEC>, static_cast<const T*>(a.B), a.ids,
                           a.scales, static_cast<const float*>(a.ws), a.out, a.S, a.r, rp, a.O,
                           a.N, a.n_splits, a.tile, a.b_stride);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Call& a) {
  constexpr int elt = static_cast<int>(sizeof(T));
  const int rp = next_pow2(a.r);
  const int split_len = (kThreads / rp) * (16 / elt);
  int tile = kTileBytes / (rp * elt);
  tile = tile < kMaxTile ? tile : kMaxTile;
  if (a.split_len != split_len || a.n_splits != (a.D + split_len - 1) / split_len ||
      a.tile != tile || a.n_tiles != (a.O + tile - 1) / tile)
    return kUnsupported;
  const bool vec = aligned16(a.x) && aligned16(a.A) && aligned16(a.B) &&
                   (static_cast<long long>(a.D) * elt) % 16 == 0 &&
                   (static_cast<long long>(a.O) * elt) % 16 == 0 &&
                   (a.a_stride * elt) % 16 == 0 && (a.b_stride * elt) % 16 == 0;
  return vec ? launch_vec<T, true>(a, rp) : launch_vec<T, false>(a, rp);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, A and B). x (S, D) and
// out (S, O) fp32 contiguous; pool row i of A starts at A + i * a_stride
// elements and holds a contiguous (D, r) pane, of B at B + i * b_stride a
// contiguous (r, O) pane; ids (S,) int32 and scales (N,) fp32, all on the
// device; ws the fp32 workspace (S, n_splits, r). split_len, n_splits, tile
// and n_tiles are the host plan's (ops/decode_step.bgmv_plan), checked
// against the kernel's. 1 <= r <= 256, S <= 65535.
int bllm_lora_bgmv(int dtype, int S, int D, int r, int O, int N, int split_len, int n_splits,
                   int tile, int n_tiles, long long a_stride, long long b_stride, const void* x,
                   const void* A, const void* B, const void* ids, const void* scales, void* ws,
                   void* out, void* stream) {
  if (S < 1 || S > 65535 || D < 1 || r < 1 || r > kMaxRank || O < 1 || N < 1) return kUnsupported;
  const Call a{S, D, r, O, N, split_len, n_splits, tile, n_tiles, a_stride, b_stride, x, A, B,
               static_cast<const int*>(ids), static_cast<const float*>(scales),
               static_cast<float*>(ws), static_cast<float*>(out),
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch<float>(a);
    case 1: return launch<__half>(a);
    case 2: return launch<__nv_bfloat16>(a);
    default: return kUnsupported;
  }
}

}  // extern "C"
