// Batched gathered LoRA delta (BGMV) for Hopper (sm_90a).
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
// What bounds it: memory bandwidth, and at the served shapes launch
// latency. A row reads its adapter's panes, D r + r O elements, for
// 2 (D r + r O) operations: one operation per element read, far below the
// card's operations-per-byte line. The least time is the bytes of the
// distinct adapters' panes, x and the output over the memory rate (about
// 0.4 us for the LLaMA-3.2-1B gate projection with three adapters), well
// under the few microseconds a launch takes.
//
// Design (a simple kernel first; PERF.md has its time beside the bound):
//   * One block of 1024 threads per (row, 1024-wide output tile). The block
//     reduces the row's xa = x @ A[i] (r <= 256 values) itself: thread
//     (ty, tx) of an RP x (1024 / RP) layout, RP the smallest power of two
//     >= r, sums x[d] A[d, tx] over d = ty, ty + 1024/RP, ...; neighbouring
//     threads read neighbouring A elements, so a warp reads whole rows of
//     the pane, and eight iterations are unrolled so that each thread has
//     eight loads in flight. The partial sums meet in shared memory and xa
//     stays there. The pane is read again by each output tile of the row;
//     after the first it comes from L2. (r1 had 256 threads and four loads
//     in flight: the reduction over D = 8192 waited on memory 128 times
//     per thread; PERF.md has both revisions' times.)
//   * Each thread then owns one output column o: sum_k xa[k] B[k, o] over
//     the rank, reading B row by row (coalesced across the warp), times the
//     row's fp32 scale.
//   * Rows with id < 0 write their zeros and return before reading A or B.
//   * Pools are addressed through a row stride, so a layer's (N, D, r)
//     slice of the stacked (N, L, D, r) pool is read in place, with no copy.
//
// Known gaps: rows that share an adapter each read its panes (no
// deduplication), every output tile recomputes its row's xa, loads are one
// element a thread (no 16-byte vectors), and a grid of S x ceil(O / 1024)
// blocks leaves most SMs idle at S = 8. Grouping rows by adapter, a split-D
// shrink pass and cp.async / TMA are the next steps.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). The entry returns
// cudaGetLastError() after the launch, or kUnsupported for a dtype or shape
// it does not take.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 1024;         // also the output tile width
constexpr int kMaxRank = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const T* __restrict__ x, const T* __restrict__ A, const T* __restrict__ B,
            const int* __restrict__ ids, const float* __restrict__ scales,
            float* __restrict__ out, int D, int r, int O, int N, int rp,
            long long a_stride, long long b_stride) {
  __shared__ float part[kThreads];
  __shared__ float xa[kMaxRank];
  const int s = blockIdx.y;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  const int id = ids[s];
  float* orow = out + static_cast<long long>(s) * O;
  if (id < 0) {                        // base-model row: exact zero, no reads
    if (o < O) orow[o] = 0.f;
    return;
  }
  const int i = id < N ? id : N - 1;

  // xa = x[s] @ A[i]: thread (ty, tx) sums rows d = ty, ty + ny, ... of
  // column tx; the ny partial sums of each column meet in shared memory
  const int tx = threadIdx.x % rp, ty = threadIdx.x / rp, ny = kThreads / rp;
  const T* xs = x + static_cast<long long>(s) * D;
  const T* a = A + static_cast<long long>(i) * a_stride;
  float acc = 0.f;
  if (tx < r) {
    int d = ty;
#pragma unroll 8
    for (; d < D; d += ny) acc = fmaf(to_f(xs[d]), to_f(a[static_cast<long long>(d) * r + tx]), acc);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < r) {
    float v = 0.f;
    for (int y = 0; y < ny; ++y) v += part[y * rp + threadIdx.x];
    xa[threadIdx.x] = to_f(from_f<T>(v));   // rounded to B's dtype
  }
  __syncthreads();
  if (o >= O) return;

  // out[s, o] = scales[i] * sum_k xa[k] B[i][k, o]
  const T* b = B + static_cast<long long>(i) * b_stride + o;
  float acc2 = 0.f;
#pragma unroll 16
  for (int k = 0; k < r; ++k) acc2 = fmaf(xa[k], to_f(b[static_cast<long long>(k) * O]), acc2);
  orow[o] = acc2 * scales[i];
}

template <typename T>
int launch(int S, int D, int r, int O, int N, long long a_stride, long long b_stride,
           const void* x, const void* A, const void* B, const int* ids, const float* scales,
           float* out, cudaStream_t stream) {
  int rp = 1;
  while (rp < r) rp <<= 1;
  const dim3 grid((O + kThreads - 1) / kThreads, S);
  bgmv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(A), static_cast<const T*>(B), ids,
      scales, out, D, r, O, N, rp, a_stride, b_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x, A and B). x (S, D) and
// out (S, O) fp32 contiguous; pool row i of A starts at A + i * a_stride
// elements and holds a contiguous (D, r) pane, of B at B + i * b_stride a
// contiguous (r, O) pane; ids (S,) int32 and scales (N,) fp32, all on the
// device. 1 <= r <= 256, S <= 65535.
int bllm_lora_bgmv(int dtype, int S, int D, int r, int O, int N, long long a_stride,
                   long long b_stride, const void* x, const void* A, const void* B,
                   const void* ids, const void* scales, void* out, void* stream) {
  if (S < 1 || S > 65535 || D < 1 || r < 1 || r > kMaxRank || O < 1 || N < 1)
    return kUnsupported;
  const int* id = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(S, D, r, O, N, a_stride, b_stride, x, A, B, id, sc, o, st);
    case 1: return launch<__half>(S, D, r, O, N, a_stride, b_stride, x, A, B, id, sc, o, st);
    case 2:
      return launch<__nv_bfloat16>(S, D, r, O, N, a_stride, b_stride, x, A, B, id, sc, o, st);
    default: return kUnsupported;
  }
}

}  // extern "C"
