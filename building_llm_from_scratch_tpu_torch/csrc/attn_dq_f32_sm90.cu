// B2a for fp32 on Hopper (sm_90a): dq of the causal flash attention, with
// optional attention dropout, its products 3xTF32 on the tensor cores
// (attn_f32_sm90.cuh).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _dq_kernel (first call in _bwd) for fp32: p = exp(s - lse), dp = dO.v,
// dp~ = M * dp / (1-p), dS = p * (dp~ - delta) * scale, dq = sum dS.k (fp32
// sums). No atomics: one block owns its rows' dq, so the result is the same
// run to run.
//
// What bounds it: operations (three 64-deep products per score element),
// ~26 GFLOP at LLaMA-3.2-1B's training shape over ~118 MB.
//
// Design: one block per (query rows, query head, batch row), longest tiles
// first: 128 rows (two consumer warpgroups) and 32-key stages at D 64; 64
// rows and 16-key stages at D 128, where Q, dO and their lo tiles alone
// take 128 KB. Q and dO come once by TMA, K and V tiles through a ring of
// stages; the split warps round all four to TF32 and write their lo tiles.
// S = Q.K^T and dP = dO.V^T are three wgmma chains each; dS is formed in
// the S accumulator and is the left operand of dq += dS.K (columns
// permuted): on wgmma over K^T split by the split warps at D 64 (two
// stages; 0.440 against 0.490 ms on mma.sync at LLaMA-3.2-1B's training
// shape, scripts/flash_attention_timing.py on an H100), on mma.sync with
// K's hi / lo read from the split tiles at D 128 (three stages).

#include "attn_f32_sm90.cuh"

namespace bllm {
namespace attn {
namespace f32 {
namespace {

template <int D> struct DqGeom {
  // D 64: dS.K on wgmma over a K-major K^T (stage: K, K lo, V, V lo, K^T hi,
  // K^T lo); D 128, whose 16-key K^T would not fill a 128-byte panel row:
  // dS.K on mma.sync from the K tiles
  static constexpr bool kKT = D == 64;
  static constexpr int kWG = D == 64 ? 2 : 1;
  static constexpr int kCW = 4 * kWG;
  static constexpr int kBM = 64 * kWG;
  static constexpr int kBN = D == 64 ? 32 : 16;
  static constexpr int kStages = kKT ? 2 : 3;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kBM * D * 4;     // Q or dO (or a lo tile)
  static constexpr uint32_t kKVBytes = kBN * D * 4;    // K or V (or a lo tile)
  static constexpr uint32_t kStageBytes = (kKT ? 6 : 4) * kKVBytes;
  static constexpr size_t kSmem = 1024 + 4 * kQBytes + kStages * kStageBytes + (2 + 3 * kStages) * 8;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(DqGeom<D>::kThreads, 1)
attn_dq_f32_kernel(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmdO, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq, int seq, int Hq,
                   int Hkv, int B, float scale, float scale_log2, Drop drop) {
  using G = DqGeom<D>;
  constexpr int S = G::kStages, BN = G::kBN, BM = G::kBM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_base(smem_raw);
  unsigned char* sQlo = sQ + G::kQBytes;
  unsigned char* sdO = sQlo + G::kQBytes;
  unsigned char* sdOlo = sdO + G::kQBytes;
  unsigned char* sStage = sdOlo + G::kQBytes;     // stage s: K, K lo, V, V lo[, K^T hi, lo]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sStage + S * G::kStageBytes);
  uint64_t* qready = qbar + 1;
  uint64_t* full = qready + 1;
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  const int per = Hq * B;
  const int i = seq / BM - 1 - static_cast<int>(blockIdx.x) / per;   // longest first
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int h = rem % Hq, b = rem / Hq;
  const int hk = h / (Hq / Hkv);
  const int n_kv = (i + 1) * BM / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(qready, kSplitThreads);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitThreads);
      mbar_init(&empty[s], G::kCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= G::kCW) {
    if (warp == G::kCW) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * G::kQBytes);
        load_tile_f32<D, BM>(sQ, &tmQ, qbar, h, i * BM, b);
        load_tile_f32<D, BM>(sdO, &tmdO, qbar, h, i * BM, b);
        for (int j = 0; j < n_kv; ++j) {
          const int s = j % S;
          mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * G::kKVBytes);
          unsigned char* sK = sStage + s * G::kStageBytes;
          load_tile_f32<D, BN>(sK, &tmK, &full[s], hk, j * BN, b);
          load_tile_f32<D, BN>(sK + 2 * G::kKVBytes, &tmV, &full[s], hk, j * BN, b);
        }
      }
    } else {
      const int tid = static_cast<int>(threadIdx.x) - (G::kCW + 1) * 32;
      mbar_wait(qbar, 0);
      split_tile(sQ, sQlo, G::kQBytes, tid);
      split_tile(sdO, sdOlo, G::kQBytes, tid);
      split_done(qready);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        mbar_wait(&full[s], (j / S) & 1);
        unsigned char* sK = sStage + s * G::kStageBytes;
        if constexpr (G::kKT) {   // from the raw K, before it is rounded in place
          split_transpose<D, BN>(sK, sK + 4 * G::kKVBytes, sK + 5 * G::kKVBytes, tid);
          split_sync();
        }
        split_tile(sK, sK + G::kKVBytes, G::kKVBytes, tid);
        split_tile(sK + 2 * G::kKVBytes, sK + 3 * G::kKVBytes, G::kKVBytes, tid);
        split_done(&ready[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;
  const int rmin = i * BM + wg * 64;
  const int row0 = rmin + rloc;
  const int last = (rmin + 63) / BN;
  const size_t roff = (static_cast<size_t>(b) * Hq + h) * seq + row0;
  const float lse2[2] = {lse[roff] * kLog2e, lse[roff + 8] * kLog2e};
  const float dl[2] = {delta[roff], delta[roff + 8]};

  float acc[D / 2];
  zero(acc);
  mbar_wait(qbar, 0);
  mbar_wait(qready, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    mbar_wait(&ready[s], (j / S) & 1);
    if (j <= last) {
      const unsigned char* sK = sStage + s * G::kStageBytes;
      const unsigned char* sKlo = sK + G::kKVBytes;
      const unsigned char* sV = sKlo + G::kKVBytes;
      const unsigned char* sVlo = sV + G::kKVBytes;
      float sc[BN / 2], dp[BN / 2];
      zero(sc);
      zero(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      wgmma_3xtf32<D, BM, BN>(sc, sQ, sQlo, wg * 64, sK, sKlo);
      wgmma_3xtf32<D, BM, BN>(dp, sdO, sdOlo, wg * 64, sV, sVlo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool diag = (j + 1) * BN - 1 > rmin;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        bool keep[2][2] = {{true, true}, {true, true}};
        if (kDrop)
          attn_keep_rows(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h + static_cast<int>(drop.h0), row0,
                         j * BN + nt * 8 + 2 * t, g & 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * nt + 2 * rr + e;
            const float p = (diag && j * BN + nt * 8 + 2 * t + e > row0 + 8 * rr)
                                ? 0.f
                                : exp2_approx(sc[k] * scale_log2 - lse2[rr]);
            float dpv = dp[k];
            if (kDrop) dpv = keep[rr][e] ? dpv * drop.inv_keep : 0.f;
            sc[k] = p * (dpv - dl[rr]) * scale;
          }
      }
      if constexpr (G::kKT)
        wgmma_acc_rs<D, BN>(acc, sc, sK + 4 * G::kKVBytes, sK + 5 * G::kKVBytes);
      else
        mma_acc_tile<D, BN>(acc, sc, sK, sKlo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  const size_t qs = static_cast<size_t>(Hq) * D;
  store_rows<D>(acc, one, dq + (static_cast<size_t>(b) * seq + row0) * qs + h * D, qs);
}

template <int D, bool kDrop>
int run(const Args& a) {
  using G = DqGeom<D>;
  constexpr CUtensorMapDataType f = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_bthd_map_of(&tq, f, 4, a.q, a.B, a.seq, a.Hq, D, G::kBM) ||
      !make_bthd_map_of(&tk, f, 4, a.k, a.B, a.seq, a.Hkv, D, G::kBN) ||
      !make_bthd_map_of(&tv, f, 4, a.v, a.B, a.seq, a.Hkv, D, G::kBN) ||
      !make_bthd_map_of(&tdo, f, 4, a.dout, a.B, a.seq, a.Hq, D, G::kBM))
    return kNoTensorMap;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  float* dq = static_cast<float*>(a.out0);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  float scale = a.scale, scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq,  &tk,  &tv, &tdo, &lse,   &delta,      &dq,
                    &seq, &Hq, &Hkv, &B,   &scale, &scale_log2, &drop};
  return launch(attn_dq_f32_kernel<D, kDrop>, G::kSmem, (a.seq / G::kBM) * a.Hq * a.B, a.stream,
                params, G::kThreads);
}

}  // namespace
}  // namespace f32

int dq_f32_sm90(int hd, const Args& a) {
  if (a.seq % 128 != 0) return kUnsupported;
  const bool drop = a.drop.threshold != 0u;
  if (hd == 64) return drop ? f32::run<64, true>(a) : f32::run<64, false>(a);
  if (hd == 128) return drop ? f32::run<128, true>(a) : f32::run<128, false>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
