// B2b for 16-bit types on Hopper (sm_90a): dk and dv of the causal flash
// attention, summed over each kv head's query heads (GQA) in the kernel,
// with optional attention dropout.
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _dkv_kernel (second call in _bwd) together with _bwd's group sum: per
// query head h, dv_h = sum (M p / (1-p))^T.dO and dk_h = sum dS^T.q, with
// P M / (1-p) and dS rounded to the model dtype before their products; each
// head's dk_h / dv_h is rounded to the model dtype (the JAX kernel's output
// dtype) and added into an fp32 sum over the G heads of the kv head, which
// is rounded once and written as (B, T, Hkv, D) (the JAX wrapper's
// reshape-sum). The per-query-head (B, T, Hq, D) buffers and the eager
// group-sum passes are gone. No atomics: one block owns its keys' dk/dv.
//
// What bounds it: operations (four 64-deep products per score element:
// S^T = K.Q^T, dP^T = V.dO^T, dv += P^T.dO, dk += dS^T.Q), ~34 GFLOP at
// LLaMA-3.2-1B's training shape.
//
// Design:
//   * One block per (128 keys, kv head, batch row), heavy key tiles (low
//     index, the most query tiles below the diagonal) first. Two consumer
//     warpgroups own 64 keys each; K and V are loaded once by TMA and stay
//     in shared memory while the block walks the G query heads of its kv
//     head and, for each, the query tiles from the diagonal on.
//   * The producer warp streams each (head, query tile) stage by TMA: Q
//     and dO (64 rows at D 64, 32 at D 128, which keeps the four
//     accumulators in registers), and the tile's lse and delta rows by a
//     bulk copy, into a double-buffered ring with mbarriers.
//   * S^T and dP^T are wgmmas from swizzled shared memory (K-major); P^T and
//     dS^T are formed in registers and are the register A operands of
//     dv += P^T.dO and dk += dS^T.Q, whose B operands are the same dO and Q
//     tiles read MN-major through the descriptor: no transposed copies.
//   * The fp32 group sum lives in shared memory, one slot per thread and
//     fragment element (only that thread reads or writes it), so the
//     registers hold just the head's accumulators.
//   * Dropout: one Philox call per 2x2 quad (attn_keep_cols).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_sm90.cuh"

namespace bllm {
namespace attn {
namespace {

using namespace sm90;
using namespace sm90k;

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

template <int D> struct DkvGeom {
  static constexpr int kBQ = D == 64 ? 64 : 32;        // query rows of a stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kKBytes = 128 * D * 2;     // the block's 128 keys of K or V
  static constexpr uint32_t kQBytes = kBQ * D * 2;     // one stage's Q or dO
  static constexpr uint32_t kStatBytes = kBQ * 4;      // one stage's lse or delta
  static constexpr size_t kSumBytes = 2 * (D / 2) * (kConsumerWarps * 32) * 4;
  static constexpr size_t smem(bool grouped) {
    return 1024 + 2 * kKBytes + kStages * 2 * kQBytes + kStages * 2 * kStatBytes +
           (grouped ? kSumBytes : 0) + (1 + 2 * kStages) * 8;
  }
};

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
attn_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const __grid_constant__ CUtensorMap tmdO, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq, int Hq, int Hkv, int B, float scale, float scale_log2, Drop drop) {
  using G = DkvGeom<D>;
  constexpr int S = G::kStages;
  constexpr int BQ = G::kBQ;
  constexpr int NA = D / 2;   // accumulator fragments of dk (and of dv)
  const int GQ = Hq / Hkv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_base(smem_raw);
  unsigned char* sV = sK + G::kKBytes;
  unsigned char* sQd = sV + G::kKBytes;                 // stage s: Q, then dO
  float* sStat = reinterpret_cast<float*>(sQd + S * 2 * G::kQBytes);   // stage s: lse, delta
  float* sSum = sStat + S * 2 * BQ;                     // G > 1: [2 NA][256] fp32
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(sSum) + (GQ > 1 ? G::kSumBytes : 0));
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  const int per = Hkv * B;
  const int jt = static_cast<int>(blockIdx.x) / per;     // heavy key tiles first
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int hk = rem % Hkv, b = rem / Hkv;
  const int i0 = jt * 128 / BQ;                         // the first query tile to reach a key
  const int n_q = seq / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
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
      mbar_expect_tx(kvbar, 2 * G::kKBytes);
      load_tile<D, 128>(sK, &tmK, kvbar, hk, jt * 128, b);
      load_tile<D, 128>(sV, &tmV, kvbar, hk, jt * 128, b);
      int n = 0;
      for (int hh = 0; hh < GQ; ++hh) {
        const int h = hk * GQ + hh;
        const size_t soff = (static_cast<size_t>(b) * Hq + h) * seq;
        for (int i = i0; i < n_q; ++i, ++n) {
          const int s = n % S;
          mbar_wait(&empty[s], ((n / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * G::kQBytes + 2 * G::kStatBytes);
          unsigned char* sQ = sQd + s * 2 * G::kQBytes;
          load_tile<D, BQ>(sQ, &tmQ, &full[s], h, i * BQ, b);
          load_tile<D, BQ>(sQ + G::kQBytes, &tmdO, &full[s], h, i * BQ, b);
          bulk_load(sStat + s * 2 * BQ, lse + soff + i * BQ, G::kStatBytes, &full[s]);
          bulk_load(sStat + s * 2 * BQ + BQ, delta + soff + i * BQ, G::kStatBytes, &full[s]);
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;          // fragment row (key) rr = 0 in the warpgroup
  const int kstart = jt * 128 + wg * 64;         // the warpgroup's first key
  const int kpos0 = kstart + rloc;               // key of rr = 0; rr = 1 is + 8

  float dka[NA], dva[NA];
  zero(dka);
  zero(dva);
  mbar_wait(kvbar, 0);

  int n = 0;
  for (int hh = 0; hh < GQ; ++hh) {
    const int h = hk * GQ + hh;
    for (int i = i0; i < n_q; ++i, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      const int q0 = i * BQ;
      if (q0 + BQ - 1 >= kstart) {               // some query of the tile sees a key
        const unsigned char* sQ = sQd + s * 2 * G::kQBytes;
        const unsigned char* sdO = sQ + G::kQBytes;
        const float* sL = sStat + s * 2 * BQ;
        const float* sDl = sL + BQ;
        float st[BQ / 2], dpt[BQ / 2];
        zero(st);
        zero(dpt);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          WgmmaSS<T, BQ>::run(st, kstep_kmajor<128>(sK, wg * 64, kk),
                              kstep_kmajor<BQ>(sQ, 0, kk), kk > 0);
          WgmmaSS<T, BQ>::run(dpt, kstep_kmajor<128>(sV, wg * 64, kk),
                              kstep_kmajor<BQ>(sdO, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        const bool masked = q0 < kstart + 63;    // the tile crosses the diagonal
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          bool keep[2][2] = {{true, true}, {true, true}};
          if (kDrop)
            attn_keep_cols(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h + static_cast<int>(drop.h0),
                           q0 + nt * 8 + 2 * t, kpos0, g & 1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * t + e;
            const float lq = sL[col] * kLog2e, dq = sDl[col];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int k = 4 * nt + 2 * rr + e;
              const float p = (masked && kpos0 + 8 * rr > q0 + col)
                                  ? 0.f
                                  : exp2_approx(st[k] * scale_log2 - lq);
              float pt = p, dpv = dpt[k];
              if (kDrop) {
                pt = keep[rr][e] ? p * drop.inv_keep : 0.f;
                dpv = keep[rr][e] ? dpv * drop.inv_keep : 0.f;
              }
              st[k] = pt;
              dpt[k] = p * (dpv - dq) * scale;
            }
          }
        }
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
        to_a_frags<T, BQ>(pa, st);
        to_a_frags<T, BQ>(dsa, dpt);

        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < BQ / 16; ++c) {
          WgmmaRS<T, D>::run(dva, pa[c], kstep_mnmajor<BQ>(sdO, c), 1);
          WgmmaRS<T, D>::run(dka, dsa[c], kstep_mnmajor<BQ>(sQ, c), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (GQ > 1) {
      // this head's dk/dv rounded to the model dtype, added into the fp32 sum
      float* mine = sSum + threadIdx.x;
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        const float a = round_to<T>(dka[e]), c = round_to<T>(dva[e]);
        mine[e * 256] = hh == 0 ? a : mine[e * 256] + a;
        mine[(NA + e) * 256] = hh == 0 ? c : mine[(NA + e) * 256] + c;
        dka[e] = 0.f;
        dva[e] = 0.f;
      }
    }
  }

  if (GQ > 1) {
    const float* mine = sSum + threadIdx.x;
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      dka[e] = mine[e * 256];
      dva[e] = mine[(NA + e) * 256];
    }
  }
  const float one[2] = {1.f, 1.f};
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t off = (static_cast<size_t>(b) * seq + kpos0) * ks + hk * D;
  store_frags<T, D>(dka, one, dk + off, ks);
  store_frags<T, D>(dva, one, dv + off, ks);
}

template <typename T, int D, bool kDrop>
int run(const Args& a) {
  using G = DkvGeom<D>;
  const bool bf = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_bthd_map(&tq, bf, a.q, a.B, a.seq, a.Hq, D, G::kBQ) ||
      !make_bthd_map(&tk, bf, a.k, a.B, a.seq, a.Hkv, D, 128) ||
      !make_bthd_map(&tv, bf, a.v, a.B, a.seq, a.Hkv, D, 128) ||
      !make_bthd_map(&tdo, bf, a.dout, a.B, a.seq, a.Hq, D, G::kBQ))
    return kNoTensorMap;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  float scale = a.scale, scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq, &tk,  &tv,  &tdo, &lse,  &delta,      &dk,  &dv,
                    &seq, &Hq, &Hkv, &B,   &scale, &scale_log2, &drop};
  return launch(attn_dkv_sm90_kernel<T, D, kDrop>, G::smem(a.Hq > a.Hkv),
                (a.seq / 128) * a.Hkv * a.B, a.stream, params);
}

template <typename T, int D>
int run_drop(const Args& a) {
  return a.drop.threshold != 0u ? run<T, D, true>(a) : run<T, D, false>(a);
}

}  // namespace

int dkv_sm90(int dtype, int hd, const Args& a) {
  if (a.seq % 128 != 0 || (hd != 64 && hd != 128)) return kUnsupported;
  if (dtype == 1) return hd == 64 ? run_drop<__half, 64>(a) : run_drop<__half, 128>(a);
  if (dtype == 2)
    return hd == 64 ? run_drop<__nv_bfloat16, 64>(a) : run_drop<__nv_bfloat16, 128>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
