// Warp-level tile products and dtype conversions shared by the port's
// kernels (the fp32 vocab-streamed cross entropy, the fused dropout):
// mma.sync m16n8k16 with fp32 accumulation for bf16/fp16, and the same
// fragment layout computed with FMAs for fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace bllm {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// acc[nt] += A[row0 : row0 + 16, 0 : K] . B[nt*8 : nt*8 + 8, 0 : K]^T
// A is row-major (lda), B is stored [n][k] (ldb), both in shared memory.
// acc[nt][e] is the mma.sync C fragment: row row0 + g + 8*(e >> 1), column
// nt*8 + 2*t + (e & 1), with g = lane / 4 and t = lane % 4.
template <typename T, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* __restrict__ sA,
                                          int lda, int row0, const T* __restrict__ sB,
                                          int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    const float* a_lo = sA + (row0 + g) * lda;
    const float* a_hi = a_lo + 8 * lda;
    const float* b_lo = sB + 2 * t * ldb;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = b_lo[nt * 8 * ldb + k];
        const float b1 = b_lo[(nt * 8 + 1) * ldb + k];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  } else {
    const T* a_lo = sA + (row0 + g) * lda + 2 * t;
    const T* a_hi = a_lo + 8 * lda;
    const T* b_base = sB + g * ldb + 2 * t;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t a[4] = {ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 8),
                             ld32(a_hi + k0 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* bp = b_base + nt * 8 * ldb + k0;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma16816<T>(acc[nt], a, b);
      }
    }
  }
}

template <typename T> __host__ __device__ constexpr int pad() { return 16 / sizeof(T); }

}  // namespace bllm
