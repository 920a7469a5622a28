// B1 for fp32 on Hopper (sm_90a): the causal flash-attention forward with
// optional attention dropout, its products 3xTF32 on the tensor cores
// (attn_f32_sm90.cuh).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _fwd_kernel (called from _fwd) for fp32, the trainer's default dtype; the
// function is fused_attention.cu's: fp32 online softmax, the exp terms times
// the keep mask before P.V, l summed over every term, out = acc / l *
// 1/(1-p), lse = m + log(l).
//
// What bounds it: operations. At LLaMA-3.2-1B's training shape (B 4, Hq 32,
// Hkv 8, T 1024, D 64) the causal products are ~17 GFLOP over ~84 MB; at
// fp32 grade the tensor cores give a third of their TF32 rate (495 / 3 =
// 165 TFLOP/s), ~200 operations a byte against the card's ~50.
//
// Design: one block per (128 query rows, query head, batch row), longest
// tiles first. Two consumer warpgroups own 64 rows each. Q comes once by
// TMA, K and V tiles (64 keys at D 64, 32 at D 128) through a ring of two
// stages; the split warps round Q and each K tile to TF32 and write their
// lo tiles. S = Q.K^T is three wgmma chains; the softmax runs on the
// accumulator in the exp2 domain as in attn_fwd_sm90.cu; P.V takes P
// straight from the accumulator (columns permuted). At D 64 the split warps
// also write V^T, permuted and split, and P.V is wgmma with P in registers;
// at D 128, where the ring has no room for V^T, P.V is mma.sync with V's hi
// and lo taken in registers from the TMA tile. Timed at LLaMA-3.2-1B's
// training shape (scripts/flash_attention_timing.py on an H100): 0.286 ms
// with V^T, 0.404 with V split into hi / lo tiles for mma.sync, 0.443 with
// V split in registers.

#include "attn_f32_sm90.cuh"

namespace bllm {
namespace attn {
namespace f32 {
namespace {

template <int D> struct FwdGeom {
  // D 64: P.V on wgmma over a K-major V^T (stage: K, K lo, V, V^T hi, V^T
  // lo); D 128, where the ring has no room for V^T: P.V on mma.sync with V
  // split in registers (stage: K, K lo, V)
  static constexpr bool kVT = D == 64;
  static constexpr int kWG = 2;                      // consumer warpgroups
  static constexpr int kCW = 4 * kWG;                // consumer warps
  static constexpr int kBM = 64 * kWG;               // query rows of a block
  static constexpr int kBN = D == 64 ? 64 : 32;      // keys of a stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kBM * D * 4;
  static constexpr uint32_t kKVBytes = kBN * D * 4;
  static constexpr uint32_t kStageBytes = (kVT ? 5 : 3) * kKVBytes;
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + kStages * kStageBytes + (2 + 3 * kStages) * 8;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(FwdGeom<D>::kThreads, 1)
attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV, float* __restrict__ out,
                    float* __restrict__ lse, int seq, int Hq, int Hkv, int B, float scale_log2,
                    Drop drop) {
  using G = FwdGeom<D>;
  constexpr int S = G::kStages, BN = G::kBN, BM = G::kBM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_base(smem_raw);
  unsigned char* sQlo = sQ + G::kQBytes;
  unsigned char* sStage = sQlo + G::kQBytes;      // stage s: K, K lo, V[, V^T hi, V^T lo]
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
        mbar_expect_tx(qbar, G::kQBytes);
        load_tile_f32<D, BM>(sQ, &tmQ, qbar, h, i * BM, b);
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
      split_done(qready);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        mbar_wait(&full[s], (j / S) & 1);
        unsigned char* sK = sStage + s * G::kStageBytes;
        split_tile(sK, sK + G::kKVBytes, G::kKVBytes, tid);
        if constexpr (G::kVT)
          split_transpose<D, BN>(sK + 2 * G::kKVBytes, sK + 3 * G::kKVBytes,
                                 sK + 4 * G::kKVBytes, tid);
        split_done(&ready[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;          // fragment row rr = 0 in the warpgroup
  const int rmin = i * BM + wg * 64;             // the warpgroup's first query
  const int row0 = rmin + rloc;                  // its query position; rr = 1 is + 8
  const int last = (rmin + 63) / BN;             // the warpgroup's last kv tile

  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
      float sc[BN / 2];
      zero(sc);
      fence_regs(sc);
      wgmma_fence();
      wgmma_3xtf32<D, BM, BN>(sc, sQ, sQlo, wg * 64, sK, sKlo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in the exp2 domain (max on the raw scores), the
      // causal mask on tiles that reach past the warpgroup's first query
      if ((j + 1) * BN - 1 > rmin) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (j * BN + nt * 8 + 2 * t + e > row0 + 8 * rr) sc[4 * nt + 2 * rr + e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
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
      for (int nt = 0; nt < BN / 8; ++nt) {
        bool keep[2][2] = {{true, true}, {true, true}};
        if (kDrop)
          attn_keep_rows(keep, drop.seed_lo, drop.seed_hi, drop.threshold, b, h + static_cast<int>(drop.h0), row0,
                         j * BN + nt * 8 + 2 * t, g & 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2_approx(fmaf(sc[4 * nt + 2 * rr + e], scale_log2, -m[rr]));
            l[rr] += p;     // l sums every term: dropout scales the normalised weights
            sc[4 * nt + 2 * rr + e] = keep[rr][e] ? p : 0.f;
          }
      }
      if constexpr (!G::kVT) {
        mma_acc_tile<D, BN>(o, sc, sV, nullptr);
      } else {
        wgmma_acc_rs<D, BN>(o, sc, sV + G::kKVBytes, sV + 2 * G::kKVBytes);
      }
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
  store_rows<D>(o, mul, out + (static_cast<size_t>(b) * seq + row0) * qs + h * D, qs);
  if (t == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * seq + row0;
    lrow[0] = m[0] * kLn2 + logf(l[0]);
    lrow[8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int D, bool kDrop>
int run(const Args& a) {
  using G = FwdGeom<D>;
  CUtensorMap tq, tk, tv;
  if (!make_bthd_map_of(&tq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.q, a.B, a.seq, a.Hq, D, G::kBM) ||
      !make_bthd_map_of(&tk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.k, a.B, a.seq, a.Hkv, D, G::kBN) ||
      !make_bthd_map_of(&tv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.v, a.B, a.seq, a.Hkv, D, G::kBN))
    return kNoTensorMap;
  float* out = static_cast<float*>(a.out0);
  float* lse = static_cast<float*>(a.out1);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  float scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq, &tk, &tv, &out, &lse, &seq, &Hq, &Hkv, &B, &scale_log2, &drop};
  return launch(attn_fwd_f32_kernel<D, kDrop>, G::kSmem, (a.seq / G::kBM) * a.Hq * a.B, a.stream,
                params, G::kThreads);
}

}  // namespace
}  // namespace f32

int fwd_f32_sm90(int hd, const Args& a) {
  if (a.seq % 128 != 0) return kUnsupported;
  const bool drop = a.drop.threshold != 0u;
  if (hd == 64) return drop ? f32::run<64, true>(a) : f32::run<64, false>(a);
  if (hd == 128) return drop ? f32::run<128, true>(a) : f32::run<128, false>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
