// Fused residual and embedding dropout for Hopper (sm_90a): B3.
//
// Replaces the TPU kernels of building_llm_from_scratch_tpu/ops/
// fused_dropout.py: _fwd_kernel / _fwd_kernel_add (dropout(h) and
// x + dropout(h), called through _call_fwd) and _bwd_kernel (the
// regenerated-mask backward, through _call_bwd). The arithmetic is the
// Pallas kernels':
//   forward    out = [x +] (keep ? h * inv : 0), inv = 1/(1-p) rounded to
//              h's dtype by the wrapper, each product and sum rounded to
//              the dtype;
//   backward   dh = keep ? g * inv : 0 (and dx = g, taken by the wrapper).
// The keep bit of flat element i is word i & 3 of Philox4x32-10 at counter
// i >> 2 (csrc/philox.cuh), regenerated in the backward from the seed, so
// nothing mask-shaped is ever stored. A Layout maps the tensor's group g to
// the group (g / chunk) * stride + offset + g % chunk of a larger tensor it
// is a block of (a sequence-parallel rank's T block of (B, T, D): its
// elements draw the whole tensor's bits); chunk 0 is the identity. The TPU kernel seeds per 512-row tile;
// the mask here depends on the element alone.
//
// What bounds it: bytes. fused_dropout_add at GPT-2-124M's (8 x 1024, 768)
// bf16 reads x and h and writes the output, 37.7 MB, about 0.011 ms at
// 3.35 TB/s. Beside the bytes, one Philox call (ten rounds of integer
// multiplies, about 100 instructions) per four elements: 1.57 M calls at
// that shape, integer work that no bound counts and that the schedule has
// to hide under the loads.
//
// Design (the grid is ops/fused_dropout.dropout_plan's):
//   * a thread moves 16-byte vectors: 8 elements in bf16 / fp16 (two Philox
//     calls), 4 in fp32 (one);
//   * a pass of a thread takes kUnroll vectors, (threads in the grid) apart,
//     so the lanes of a warp read 512 contiguous bytes per vector; the
//     pass's loads are issued before its Philox chains, which then run while
//     the loads are in flight;
//   * the grid is at most one wave of resident blocks (kBlocksPerSM of
//     kThreads an SM), the fewest blocks whose threads make the same number
//     of full passes, walking the tensor pass by pass;
//   * the elements past the last whole vector (4 at most, in the 16-bit
//     types) are one Philox group, taken by the first thread.
// kUnroll 1 at 8 blocks an SM (2048 threads, 30 registers) was the fastest
// of the schedules timed at (8 x 1024, 768) (scripts/train_kernel_timing.py
// on an H100): 2 or 4 vectors a pass need the registers of 2-6 blocks an SM
// and were up to 13% slower (twice as slow where they spilled); here the
// threads hide the latency. Every schedule timed ran within a few percent
// of a copy of the same bytes (the copy-only floor), none near the bound.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). Each entry returns
// cudaGetLastError() after its launch, or 100000 for what it does not take.

#include <cuda_runtime.h>

#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

// The two floors scripts/train_kernel_timing.py --floors times, each built
// apart from the library with -DBLLM_DROPOUT_FLOOR: 1 keeps the loads and
// stores and draws nothing (every element kept), 2 draws the Philox words
// and moves nothing (the words folded into one a thread, stored only if
// the fold equals the threshold). The library is built with 0.
#ifndef BLLM_DROPOUT_FLOOR
#define BLLM_DROPOUT_FLOOR 0
#endif

namespace {

constexpr int kThreads = 256;       // ops/fused_dropout._THREADS
constexpr int kUnroll = 1;          // vectors a pass: ops/fused_dropout._UNROLL
constexpr int kBlocksPerSM = 8;     // ops/fused_dropout._BLOCKS_PER_SM
constexpr int kUnsupported = 100000;
constexpr bool kMove = BLLM_DROPOUT_FLOOR != 2;
constexpr bool kDraw = BLLM_DROPOUT_FLOOR != 1;

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// the group of the whole tensor that a block's group g is (see the top)
struct Layout {
  long long chunk, stride, offset;
};

__device__ __forceinline__ uint64_t global_group(uint64_t g, const Layout& lay) {
  if (lay.chunk == 0) return g;
  const uint64_t c = static_cast<uint64_t>(lay.chunk);
  return (g / c) * static_cast<uint64_t>(lay.stride) + static_cast<uint64_t>(lay.offset) +
         g % c;
}

// [x +] (keep ? h * inv : 0) in T, rounded as the Pallas kernel rounds
template <typename T, bool kAdd>
__device__ __forceinline__ T drop(T h, T x, bool keep, float inv) {
  const T y = keep ? bllm::from_f<T>(bllm::to_f(h) * inv) : bllm::from_f<T>(0.f);
  return kAdd ? bllm::from_f<T>(bllm::to_f(x) + bllm::to_f(y)) : y;
}

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dropout_kernel(const T* __restrict__ x, const T* __restrict__ h, T* __restrict__ out,
               long long n_vec, int tail, uint32_t threshold, float inv, uint32_t seed_lo,
               uint32_t seed_hi, Layout lay) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCalls = kVec / 4;              // Philox calls a vector
  const float inv_f = bllm::to_f(bllm::from_f<T>(inv));   // exact: inv is a value of T
  const Vec16<T>* hv = reinterpret_cast<const Vec16<T>*>(h);
  const Vec16<T>* xv = reinterpret_cast<const Vec16<T>*>(x);
  Vec16<T>* ov = reinterpret_cast<Vec16<T>*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  uint32_t fold = 0;

  for (long long base = first; base < n_vec; base += kUnroll * stride) {
    Vec16<T> hr[kUnroll], xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * stride;
      if (kMove && v < n_vec) {
        hr[u] = hv[v];
        if (kAdd) xr[u] = xv[v];
      }
    }
    // the pass's counters go through an empty asm that the loads above may
    // not sink below (a memory clobber), so no Philox multiply is scheduled
    // ahead of them
    long long pass = base;
    asm volatile("" : "+l"(pass) : : "memory");
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = pass + u * stride;
      if (v >= n_vec) continue;
      Vec16<T> o;
#pragma unroll
      for (int c = 0; c < kCalls; ++c) {
        const uint4 r = kDraw ? bllm::flat_bits(seed_lo, seed_hi,
                                                global_group(static_cast<uint64_t>(v) * kCalls + c,
                                                             lay))
                              : make_uint4(~0u, ~0u, ~0u, ~0u);
        if (kMove) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o.v[4 * c + e] = drop<T, kAdd>(hr[u].v[4 * c + e], kAdd ? xr[u].v[4 * c + e] : T(),
                                           bllm::philox_word(r, e) >= threshold, inv_f);
        } else {
          fold ^= r.x ^ r.y ^ r.z ^ r.w;
        }
      }
      if (kMove) ov[v] = o;
    }
  }
  if (!kMove && fold == threshold) out[0] = bllm::from_f<T>(0.f);

  if (tail != 0 && first == 0) {                // the last group of four
    const long long g = n_vec * kCalls;
    const Vec4<T> ht = reinterpret_cast<const Vec4<T>*>(h)[g];
    const Vec4<T> xt = kAdd ? reinterpret_cast<const Vec4<T>*>(x)[g] : Vec4<T>{};
    const uint4 r = bllm::flat_bits(seed_lo, seed_hi, global_group(static_cast<uint64_t>(g), lay));
    Vec4<T> o;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o.v[e] = drop<T, kAdd>(ht.v[e], xt.v[e], bllm::philox_word(r, e) >= threshold, inv_f);
    reinterpret_cast<Vec4<T>*>(out)[g] = o;
  }
}

template <typename T>
int run(const void* x, const void* h, void* out, long long n, int blocks, unsigned threshold,
        float inv, unsigned seed_lo, unsigned seed_hi, Layout lay, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  const int tail = static_cast<int>(n - n_vec * kVec);
  const T* xp = static_cast<const T*>(x);
  const T* hp = static_cast<const T*>(h);
  T* op = static_cast<T*>(out);
  if (x != nullptr)
    dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xp, hp, op, n_vec, tail, threshold,
                                                             inv, seed_lo, seed_hi, lay);
  else
    dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xp, hp, op, n_vec, tail,
                                                              threshold, inv, seed_lo, seed_hi,
                                                              lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = [x +] dropout(h) over n elements (n % 4 == 0; x may be null), or
// the backward dh = dropout(g) with h = g and x = null; all 16-byte aligned.
// dtype: 0 = float32, 1 = float16, 2 = bfloat16; ``blocks`` of 256 threads
// (ops/fused_dropout.dropout_plan); inv = 1/(1-p) as a value of the dtype;
// the seed is (seed_hi << 32) | seed_lo; chunk, stride, offset: the Layout
// (in groups of four elements; chunk 0 for a whole tensor).
int bllm_dropout(int dtype, long long n, int blocks, unsigned threshold, float inv,
                 unsigned seed_lo, unsigned seed_hi, long long chunk, long long stride,
                 long long offset, const void* x, const void* h, void* out, void* stream) {
  if (n < 0 || n % 4 != 0 || blocks < 1 || chunk < 0) return kUnsupported;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay{chunk, stride, offset};
  switch (dtype) {
    case 0: return run<float>(x, h, out, n, blocks, threshold, inv, seed_lo, seed_hi, lay, s);
    case 1: return run<__half>(x, h, out, n, blocks, threshold, inv, seed_lo, seed_hi, lay, s);
    case 2:
      return run<__nv_bfloat16>(x, h, out, n, blocks, threshold, inv, seed_lo, seed_hi, lay, s);
    default: return kUnsupported;
  }
}

}  // extern "C"
