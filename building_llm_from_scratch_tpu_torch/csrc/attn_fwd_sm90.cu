// B1 for 16-bit types on Hopper (sm_90a): the causal flash-attention
// forward with optional attention dropout.
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _fwd_kernel (called from _fwd); the function is fused_attention.cu's (its
// header states it): fp32 online softmax, the exp terms times the keep mask
// rounded to the model dtype before P.V, l summed over every term,
// out = acc / l * 1/(1-p), lse = m + log(l).
//
// What bounds it: operations. At LLaMA-3.2-1B's training shape (B 4, Hq 32,
// Hkv 8, T 1024, D 64) the causal products are ~17 GFLOP over ~42 MB, about
// 400 operations a byte, above the card's ~295 for bf16; with dropout the
// Philox draws add integer work that the tensor-core bound does not count.
//
// Design:
//   * One block per (128 query rows, query head, batch row), tiles walked
//     longest first (the block index counts down the causal diagonal).
//     Two consumer warpgroups own 64 rows each; a producer warp loads Q
//     once and streams 64-key K and V tiles by TMA, through a 4-D tensor map
//     over the model's (B, T, H, D) layout, into a ring of 3 (D 64) or 2
//     (D 128) stages with mbarriers, so the next tiles are in flight while
//     this one computes.
//   * S = Q.K^T is a wgmma with both operands in 128B-swizzled shared
//     memory (K-major). The softmax runs on the accumulator fragments in
//     registers, in the exp2 domain: the row max is taken on the raw
//     scores and scale * log2(e) is folded into the exponent's one FMA; the
//     causal mask on the diagonal tile only. P is rounded to
//     the model dtype in registers and is the register A operand of the
//     P.V wgmma, whose B operand is V read MN-major through the descriptor:
//     nothing is transposed and P never touches shared memory.
//   * Dropout: one Philox call per 2x2 quad of (query, key), shared by the
//     two lanes that hold it (philox.cuh, attn_keep_rows).
//   * Occupancy: without dropout at D 64 the consumers fit in ~96
//     registers, so two blocks share an SM and one's Q load and epilogue
//     hide under the other's loop (scripts/flash_attention_timing.py on an
//     H100: 0.068 against 0.087 ms at LLaMA-3.2-1B's training shape). The
//     dropout and D 128 variants spill at that budget and run one block an
//     SM, with the producer warpgroup's registers handed to the consumers
//     (setmaxnreg).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_sm90.cuh"

namespace bllm {
namespace attn {
namespace {

using namespace sm90;
using namespace sm90k;

template <int D, bool kDrop> struct FwdGeom {
  // Without dropout at D 64 a consumer needs ~96 registers: two blocks
  // share an SM (one's Q load and epilogue overlap the other's loop), with a
  // producer warp. Otherwise one block an SM, whose producer warpgroup
  // hands its registers to the consumers.
  static constexpr bool kTwoPerSM = D == 64 && !kDrop;
  static constexpr int kThreads = kTwoPerSM ? 288 : sm90k::kThreads;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kQBytes = 128 * D * 2;   // 128 query rows
  static constexpr uint32_t kKVBytes = 64 * D * 2;   // 64 keys of K or of V
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * 2 * kKVBytes + (1 + 2 * kStages) * 8;
};

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(FwdGeom<D, kDrop>::kThreads, FwdGeom<D, kDrop>::kTwoPerSM ? 2 : 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV, T* __restrict__ out,
                     float* __restrict__ lse, int seq, int Hq, int Hkv, int B, float scale_log2,
                     Drop drop) {
  using G = FwdGeom<D, kDrop>;
  constexpr int S = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_base(smem_raw);
  unsigned char* sKV = sQ + G::kQBytes;   // stage s: K, then V
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sKV + S * 2 * G::kKVBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int per = Hq * B;
  const int i = seq / 128 - 1 - static_cast<int>(blockIdx.x) / per;   // longest first
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int h = rem % Hq, b = rem / Hq;
  const int hk = h / (Hq / Hkv);
  const int n_kv = 2 * i + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    if constexpr (!G::kTwoPerSM) regs_dealloc<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, G::kQBytes);
      load_tile<D, 128>(sQ, &tmQ, qbar, h, i * 128, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * G::kKVBytes);
        unsigned char* sK = sKV + s * 2 * G::kKVBytes;
        load_tile<D, 64>(sK, &tmK, &full[s], hk, j * 64, b);
        load_tile<D, 64>(sK + G::kKVBytes, &tmV, &full[s], hk, j * 64, b);
      }
    }
    return;
  }

  if constexpr (!G::kTwoPerSM) regs_alloc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;          // fragment row rr = 0 in the warpgroup
  const int row0 = i * 128 + wg * 64 + rloc;     // its query position; rr = 1 is + 8
  const int last = 2 * i + wg;                   // the warpgroup's diagonal kv tile

  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j <= last) {
      const unsigned char* sK = sKV + s * 2 * G::kKVBytes;
      const unsigned char* sV = sK + G::kKVBytes;
      float sc[32];
      zero(sc);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<T, 64>::run(sc, kstep_kmajor<128>(sQ, wg * 64, kk), kstep_kmajor<64>(sK, 0, kk),
                            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in the exp2 domain (m is the running max of
      // s * scale * log2(e); the max is taken on the raw scores, whose
      // order the positive scale keeps); the mask on the diagonal tile only
      const bool diag = j == last;
      float mx[2] = {-INFINITY, -INFINITY};
      if (diag) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (nt * 8 + 2 * t + e > rloc + 8 * rr) sc[4 * nt + 2 * rr + e] = -INFINITY;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          mx[rr] = fmaxf(mx[rr], fmaxf(sc[4 * nt + 2 * rr], sc[4 * nt + 2 * rr + 1]));
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        mx[rr] = fmaxf(m[rr], mx[rr] * scale_log2);
        corr[rr] = exp2_approx(m[rr] - mx[rr]);
        m[rr] = mx[rr];
        l[rr] *= corr[rr];    // this thread's share; the quad is summed at the end
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          o[4 * nt + 2 * rr] *= corr[rr];
          o[4 * nt + 2 * rr + 1] *= corr[rr];
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        bool keep[2][2] = {{true, true}, {true, true}};
        if (kDrop)
          attn_keep_rows(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h + static_cast<int>(drop.h0), row0,
                         j * 64 + nt * 8 + 2 * t, g & 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(fmaf(sc[4 * nt + 2 * rr + e], scale_log2, -m[rr]));
            l[rr] += p;     // l sums every term: dropout scales the normalised weights
            sc[4 * nt + 2 * rr + e] = keep[rr][e] ? p : 0.f;
          }
      }
      uint32_t pa[4][4];
      to_a_frags<T, 64>(pa, sc);

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) WgmmaRS<T, D>::run(o, pa[c], kstep_mnmajor<64>(sV, c), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float mul[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    mul[rr] = (kDrop ? drop.inv_keep : 1.f) / l[rr];
  }
  const size_t qs = static_cast<size_t>(Hq) * D;
  store_frags<T, D>(o, mul, out + (static_cast<size_t>(b) * seq + row0) * qs + h * D, qs);
  if (t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * seq + row0;
    lrow[0] = m[0] * kLn2 + logf(l[0]);
    lrow[8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <typename T, int D, bool kDrop>
int run(const Args& a) {
  const bool bf = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  if (!make_bthd_map(&tq, bf, a.q, a.B, a.seq, a.Hq, D, 128) ||
      !make_bthd_map(&tk, bf, a.k, a.B, a.seq, a.Hkv, D, 64) ||
      !make_bthd_map(&tv, bf, a.v, a.B, a.seq, a.Hkv, D, 64))
    return kNoTensorMap;
  T* out = static_cast<T*>(a.out0);
  float* lse = static_cast<float*>(a.out1);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  float scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq, &tk, &tv, &out, &lse, &seq, &Hq, &Hkv, &B, &scale_log2, &drop};
  using G = FwdGeom<D, kDrop>;
  return launch(attn_fwd_sm90_kernel<T, D, kDrop>, G::kSmem, (a.seq / 128) * a.Hq * a.B, a.stream,
                params, G::kThreads);
}

template <typename T, int D>
int run_drop(const Args& a) {
  return a.drop.threshold != 0u ? run<T, D, true>(a) : run<T, D, false>(a);
}

}  // namespace

int fwd_sm90(int dtype, int hd, const Args& a) {
  if (a.seq % 128 != 0 || (hd != 64 && hd != 128)) return kUnsupported;
  if (dtype == 1) return hd == 64 ? run_drop<__half, 64>(a) : run_drop<__half, 128>(a);
  if (dtype == 2)
    return hd == 64 ? run_drop<__nv_bfloat16, 64>(a) : run_drop<__nv_bfloat16, 128>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
