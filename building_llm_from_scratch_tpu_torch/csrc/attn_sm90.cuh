// Shared pieces of the causal flash-attention kernels (csrc/fused_attention.cu,
// the 16-bit Hopper kernels attn_fwd_sm90.cu, attn_dq_sm90.cu,
// attn_dkv_sm90.cu, and the fp32 ones attn_{fwd,dq,dkv}_f32_sm90.cu): the
// launch arguments, the dropout parameters, and the tile plumbing of the
// warp-specialised 16-bit kernels.
//
// The 16-bit kernels share one block shape: two consumer warpgroups (warps
// 0-7), each owning 64 rows of the block's 128-row tile, and one producer
// warpgroup (warps 8-11) whose first lane keeps TMA loads in flight in a
// ring of shared-memory stages guarded by mbarriers ("full": the stage's
// bytes have arrived; "empty": all eight consumer warps are done with it).
// The producer gives its registers to the consumers (setmaxnreg: 32 and
// 232 a thread), so the accumulators of the backward kernels fit without
// spilling.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace bllm {
namespace attn {

// the dropout parameters of a launch: keep = Philox word >= threshold (no
// mask at all when threshold is 0), kept terms scaled by inv_keep = 1/(1-p);
// h0 is the global index of the launch's first query head (a tensor-parallel
// rank's heads draw the whole model's masks)
struct Drop {
  uint32_t threshold, seed_lo, seed_hi;
  float inv_keep;
  uint32_t h0;
};

struct Args {
  int B, seq, Hq, Hkv;
  float scale;
  Drop drop;
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  cudaStream_t stream;
};

constexpr int kUnsupported = 100000;   // dtype, head dim or shape not instantiated
constexpr int kNoTensorMap = 100001;   // cuTensorMapEncodeTiled refused the map

// the 16-bit kernels (dtype 1 = float16, 2 = bfloat16; head dim 64 or 128)
int fwd_sm90(int dtype, int hd, const Args& a);
int dq_sm90(int dtype, int hd, const Args& a);
int dkv_sm90(int dtype, int hd, const Args& a);
// the fp32 kernels (3xTF32 on the tensor cores; head dim 64 or 128)
int fwd_f32_sm90(int hd, const Args& a);
int dq_f32_sm90(int hd, const Args& a);
int dkv_f32_sm90(int hd, const Args& a);

namespace sm90k {

constexpr int kThreads = 384;          // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarp = 8;       // the first warp of the producer warpgroup
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the dynamic shared memory, rounded up to the 1024-byte boundary the
// 128-byte swizzle repeats on (the launch asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = sm90::smem_u32(raw);
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

// ROWS consecutive positions of head h of batch row b, all D columns, as
// D / 64 swizzled panels of ROWS x 128 bytes
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int t0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) sm90::tma_load_4d(dst + p * ROWS * 128, map, bar, p * 64, h, t0, b);
}

// descriptor of k-step kk (16 columns of the reduction dim) of a K-major
// tile of ROWS rows, starting at row r0 (a multiple of 8)
template <int ROWS>
__device__ __forceinline__ uint64_t kstep_kmajor(const unsigned char* tile, int r0, int kk) {
  return sm90::desc_kmajor(tile + (kk >> 2) * ROWS * 128 + r0 * 128 + (kk & 3) * 32);
}

// descriptor of k-step c (16 rows of the reduction dim) of an MN-major tile
// of ROWS rows (all D output columns, panels ROWS x 128 bytes apart)
template <int ROWS>
__device__ __forceinline__ uint64_t kstep_mnmajor(const unsigned char* tile, int c) {
  return sm90::desc_mnmajor(tile + c * 2048, ROWS * 128);
}

// an accumulator fragment (64 x N) rounded to T as register A operands of
// the next product: chunk c covers columns 16c .. 16c + 15
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      a[nt >> 1][(nt & 1) * 2 + rr] = sm90::pack2<T>(d[4 * nt + 2 * rr], d[4 * nt + 2 * rr + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// write a warpgroup's (64 x D) fp32 fragments, times mul[rr], as rows of T:
// fragment row rr of this thread goes to dst + rr * 8 * row_stride
template <typename T, int D>
__device__ __forceinline__ void store_frags(const float (&d)[D / 2], const float (&mul)[2],
                                            T* __restrict__ dst, size_t row_stride) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* row = dst + rr * 8 * row_stride;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * t) =
          sm90::pack2<T>(d[4 * nt + 2 * rr] * mul[rr], d[4 * nt + 2 * rr + 1] * mul[rr]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int grid, cudaStream_t stream, void** params,
           int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads),
                         params, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90k
}  // namespace attn
}  // namespace bllm
