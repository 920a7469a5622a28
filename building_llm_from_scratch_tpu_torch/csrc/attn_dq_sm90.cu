// B2a for 16-bit types on Hopper (sm_90a): dq of the causal flash attention,
// with optional attention dropout.
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _dq_kernel (first call in _bwd): p = exp(s - lse), dp = dO.v,
// dp~ = M * dp / (1-p), dS = p * (dp~ - delta) * scale rounded to the model
// dtype, dq = sum dS.k (fp32 sums). No atomics: one block owns its rows' dq,
// so the result is the same run to run.
//
// What bounds it: operations (three 64-deep products per score element:
// S = Q.K^T, dP = dO.V^T, dq += dS.K), ~26 GFLOP at LLaMA-3.2-1B's training
// shape over ~60 MB.
//
// Design: the forward's (attn_fwd_sm90.cu). One block per (128 query rows,
// query head, batch row), longest tiles first; two consumer warpgroups of 64
// rows; a producer warp loads Q and dO once and streams 64-key K and V
// tiles by TMA into a ring of stages. S and dP are wgmmas from swizzled
// shared memory (K-major); dS is formed in registers and is the register A
// operand of dq += dS.K, whose B operand is K read MN-major through the
// descriptor, so no operand is transposed and dS never touches shared
// memory. Dropout: one Philox call per 2x2 quad (attn_keep_rows).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_sm90.cuh"

namespace bllm {
namespace attn {
namespace {

using namespace sm90;
using namespace sm90k;

template <int D> struct DqGeom {
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = 128 * D * 2;   // 128 rows of Q or of dO
  static constexpr uint32_t kKVBytes = 64 * D * 2;   // 64 keys of K or of V
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + kStages * 2 * kKVBytes + (1 + 2 * kStages) * 8;
};

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
attn_dq_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmdO, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int seq, int Hq,
                    int Hkv, int B, float scale, float scale_log2, Drop drop) {
  using G = DqGeom<D>;
  constexpr int S = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_base(smem_raw);
  unsigned char* sdO = sQ + G::kQBytes;
  unsigned char* sKV = sdO + G::kQBytes;   // stage s: K, then V
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
    regs_dealloc<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(qbar, 2 * G::kQBytes);
      load_tile<D, 128>(sQ, &tmQ, qbar, h, i * 128, b);
      load_tile<D, 128>(sdO, &tmdO, qbar, h, i * 128, b);
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

  regs_alloc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;
  const int row0 = i * 128 + wg * 64 + rloc;
  const int last = 2 * i + wg;
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * seq + row0;
  const float lse2[2] = {lse[roff] * kLog2e, lse[roff + 8] * kLog2e};
  const float dl[2] = {delta[roff], delta[roff + 8]};

  float acc[D / 2];
  zero(acc);
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j <= last) {
      const unsigned char* sK = sKV + s * 2 * G::kKVBytes;
      const unsigned char* sV = sK + G::kKVBytes;
      float sc[32], dp[32];
      zero(sc);
      zero(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        WgmmaSS<T, 64>::run(sc, kstep_kmajor<128>(sQ, wg * 64, kk), kstep_kmajor<64>(sK, 0, kk),
                            kk > 0);
        WgmmaSS<T, 64>::run(dp, kstep_kmajor<128>(sdO, wg * 64, kk), kstep_kmajor<64>(sV, 0, kk),
                            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool diag = j == last;
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
            const int k = 4 * nt + 2 * rr + e;
            const float p = (diag && nt * 8 + 2 * t + e > rloc + 8 * rr)
                                ? 0.f
                                : exp2_approx(sc[k] * scale_log2 - lse2[rr]);
            float dpv = dp[k];
            if (kDrop) dpv = keep[rr][e] ? dpv * drop.inv_keep : 0.f;
            sc[k] = p * (dpv - dl[rr]) * scale;
          }
      }
      uint32_t da[4][4];
      to_a_frags<T, 64>(da, sc);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) WgmmaRS<T, D>::run(acc, da[c], kstep_mnmajor<64>(sK, c), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  const size_t qs = static_cast<size_t>(Hq) * D;
  store_frags<T, D>(acc, one, dq + (static_cast<size_t>(b) * seq + row0) * qs + h * D, qs);
}

template <typename T, int D, bool kDrop>
int run(const Args& a) {
  const bool bf = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_bthd_map(&tq, bf, a.q, a.B, a.seq, a.Hq, D, 128) ||
      !make_bthd_map(&tk, bf, a.k, a.B, a.seq, a.Hkv, D, 64) ||
      !make_bthd_map(&tv, bf, a.v, a.B, a.seq, a.Hkv, D, 64) ||
      !make_bthd_map(&tdo, bf, a.dout, a.B, a.seq, a.Hq, D, 128))
    return kNoTensorMap;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  T* dq = static_cast<T*>(a.out0);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  float scale = a.scale, scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq,  &tk,  &tv, &tdo, &lse,   &delta,      &dq,
                    &seq, &Hq, &Hkv, &B,   &scale, &scale_log2, &drop};
  return launch(attn_dq_sm90_kernel<T, D, kDrop>, DqGeom<D>::kSmem, (a.seq / 128) * a.Hq * a.B,
                a.stream, params);
}

template <typename T, int D>
int run_drop(const Args& a) {
  return a.drop.threshold != 0u ? run<T, D, true>(a) : run<T, D, false>(a);
}

}  // namespace

int dq_sm90(int dtype, int hd, const Args& a) {
  if (a.seq % 128 != 0 || (hd != 64 && hd != 128)) return kUnsupported;
  if (dtype == 1) return hd == 64 ? run_drop<__half, 64>(a) : run_drop<__half, 128>(a);
  if (dtype == 2)
    return hd == 64 ? run_drop<__nv_bfloat16, 64>(a) : run_drop<__nv_bfloat16, 128>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
