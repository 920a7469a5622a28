// Causal flash attention: forward (B1), dq (B2a) and dk/dv summed over each
// kv head's query heads (B2b), with in-kernel attention dropout; the C entry
// points of the family and the function every kernel of it computes. The
// kernels are Hopper designs (TMA, mbarriers, wgmma): bf16 and fp16 in
// attn_fwd_sm90.cu, attn_dq_sm90.cu and attn_dkv_sm90.cu, fp32 (3xTF32 on
// the tensor cores) in attn_fwd_f32_sm90.cu, attn_dq_f32_sm90.cu and
// attn_dkv_f32_sm90.cu; the entry points below send each dtype there.
//
// Replaces the TPU kernels of building_llm_from_scratch_tpu/ops/
// fused_attention.py: _fwd (_fwd_kernel), and _bwd's two calls (_dq_kernel,
// _dkv_kernel) with its GQA group sum. The function is the JAX kernels',
// not their blocks:
//   forward   s = q.k * scale (fp32), causal mask, online softmax in fp32
//             (running max m, running sum l of the fp32 exp terms), the exp
//             terms times the keep mask M rounded to the value dtype before
//             P.V (fp32 sums; the mask does not touch l);
//             out = acc / l * 1/(1-p) in the model dtype, lse = m + log(l).
//   dq        p = exp(s - lse), dp = dO.v, dp~ = M * dp / (1-p),
//             dS = p * (dp~ - delta) * scale, dq = sum dS.k with dS rounded
//             to the model dtype.
//   dk, dv    the same p, dp~ and dS per (key tile, query head): dv_h = sum
//             (M p / (1-p))^T.dO, dk_h = sum dS^T.q (both rounded to the
//             model dtype first), each head's result rounded to the model
//             dtype and summed over the G query heads of the kv head in fp32
//             (GQA), written once as (B, T, Hkv, D).
// Query head h reads kv head h / G; K and V are never repeated. delta =
// rowsum(dO * out) over the dropped output is computed by the wrapper.
//
// Dropout (rate > 0, threshold != 0; each kernel is instantiated with and
// without it, so the no-dropout path carries no dropout code): the keep bit
// of element (b, h, q, k) is a pure function of the seed and those
// coordinates (csrc/philox.cuh), never of a tile or of launch order, so
// kernels that tile the scores differently regenerate the same mask, and
// nothing T^2-sized is stored. One Philox call covers a 2x2 quad of (q, k),
// shared by the two fragment lanes that hold it.
//
// Layout: the model's own (B, T, H, D), read through row strides (no
// transposes in device memory); lse and delta are (B, Hq, T) fp32.
//
// Plain C interface, loaded with ctypes (ops/_kernels.py). Each entry
// returns cudaGetLastError() after its launch, 100000 for a dtype, head dim
// or shape it is not instantiated for, or 100001 when a tensor map cannot be
// encoded (see bllm_error_string).

#include <cuda_runtime.h>

#include "attn_sm90.cuh"

namespace {

using bllm::attn::Args;
using bllm::attn::Drop;
using bllm::attn::kUnsupported;

// fp32 to the 3xTF32 kernels, bf16 / fp16 to the 16-bit ones
int dispatch(int (*f32)(int, const Args&), int (*sm90)(int, int, const Args&), int dtype, int hd,
             const Args& a) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.seq < 128 || a.seq % 128 != 0)
    return kUnsupported;
  if (hd != 64 && hd != 128) return kUnsupported;
  if (dtype == 0) return f32(hd, a);
  if (dtype == 1 || dtype == 2) return sm90(dtype, hd, a);
  return kUnsupported;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. All tensors contiguous:
// q, out (B, T, Hq, hd); k, v (B, T, Hkv, hd); lse (B, Hq, T) fp32.
// Dropout: keep = Philox word >= threshold (threshold 0: no dropout), kept
// terms times inv_keep = 1/(1-p); the seed is (seed_hi << 32) | seed_lo;
// h0: the global index of query head 0 (the mask's head counter is h0 + h).
int bllm_attn_fwd(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                  unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                  unsigned h0, const void* q, const void* k, const void* v, void* out,
                  void* lse, void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep, h0}, q, k, v,
         nullptr, nullptr, nullptr, out, lse, static_cast<cudaStream_t>(stream)};
  return dispatch(bllm::attn::fwd_f32_sm90, bllm::attn::fwd_sm90, dtype, hd, a);
}

// dout, dq (B, T, Hq, hd); lse, delta (B, Hq, T) fp32.
int bllm_attn_bwd_dq(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                     unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                     unsigned h0, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep, h0}, q, k, v, dout,
         lse, delta, dq, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch(bllm::attn::dq_f32_sm90, bllm::attn::dq_sm90, dtype, hd, a);
}

// dk, dv summed over each kv head's query heads: (B, T, Hkv, hd) each.
// work: unused (every kernel sums the heads in place); pass null.
int bllm_attn_bwd_dkv(int dtype, int hd, int B, int T, int Hq, int Hkv, float scale,
                      unsigned threshold, float inv_keep, unsigned seed_lo, unsigned seed_hi,
                      unsigned h0, const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, void* work,
                      void* stream) {
  Args a{B, T, Hq, Hkv, scale, Drop{threshold, seed_lo, seed_hi, inv_keep, h0}, q, k, v, dout,
         lse, delta, dk, dv, static_cast<cudaStream_t>(stream)};
  (void)work;
  return dispatch(bllm::attn::dkv_f32_sm90, bllm::attn::dkv_sm90, dtype, hd, a);
}

}  // extern "C"
