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
// nothing mask-shaped is ever stored. The TPU kernel seeds per 512-row tile;
// the mask here depends on the element alone.
//
// What bounds it: bytes. fused_dropout_add at GPT-2-124M's (8 x 1024, 768)
// bf16 reads x and h and writes the output, 37.7 MB, about 0.011 ms at
// 3.35 TB/s; one Philox call (about 100 integer instructions) serves four
// elements.
//
// Design: a grid-stride loop, one thread per four consecutive elements (one
// Philox call), vector loads and stores of the four (8 bytes in bf16/fp16,
// 16 in fp32).
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). Each entry returns
// cudaGetLastError() after its launch, or 100000 for what it does not take.

#include <cuda_runtime.h>

#include <stdint.h>

#include "philox.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnsupported = 100000;

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, const T* __restrict__ h, T* __restrict__ out,
               long long n_groups, uint32_t threshold, float inv, uint32_t seed_lo,
               uint32_t seed_hi) {
  const T inv_t = bllm::from_f<T>(inv);   // exact: inv is a value of T
  const float inv_f = bllm::to_f(inv_t);
  for (long long gi = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       gi < n_groups; gi += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 r = bllm::flat_bits(seed_lo, seed_hi, static_cast<uint64_t>(gi));
    const Vec4<T> hv = reinterpret_cast<const Vec4<T>*>(h)[gi];
    Vec4<T> o;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool keep = bllm::philox_word(r, e) >= threshold;
      o.v[e] = keep ? bllm::from_f<T>(bllm::to_f(hv.v[e]) * inv_f) : bllm::from_f<T>(0.f);
    }
    if (x != nullptr) {
      const Vec4<T> xv = reinterpret_cast<const Vec4<T>*>(x)[gi];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o.v[e] = bllm::from_f<T>(bllm::to_f(xv.v[e]) + bllm::to_f(o.v[e]));
    }
    reinterpret_cast<Vec4<T>*>(out)[gi] = o;
  }
}

template <typename T>
int run(const void* x, const void* h, void* out, long long n, unsigned threshold, float inv,
        unsigned seed_lo, unsigned seed_hi, cudaStream_t stream) {
  const long long groups = n / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<T*>(out), groups,
      threshold, inv, seed_lo, seed_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = [x +] dropout(h) over n elements (n % 4 == 0; x may be null), or
// the backward dh = dropout(g) with h = g and x = null. dtype: 0 = float32,
// 1 = float16, 2 = bfloat16; inv = 1/(1-p) as a value of the dtype; the
// seed is (seed_hi << 32) | seed_lo.
int bllm_dropout(int dtype, long long n, unsigned threshold, float inv, unsigned seed_lo,
                 unsigned seed_hi, const void* x, const void* h, void* out, void* stream) {
  if (n < 0 || n % 4 != 0) return kUnsupported;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(x, h, out, n, threshold, inv, seed_lo, seed_hi, s);
    case 1: return run<__half>(x, h, out, n, threshold, inv, seed_lo, seed_hi, s);
    case 2: return run<__nv_bfloat16>(x, h, out, n, threshold, inv, seed_lo, seed_hi, s);
    default: return kUnsupported;
  }
}

}  // extern "C"
