// B2b for fp32 on Hopper (sm_90a): dk and dv of the causal flash attention,
// summed over each kv head's query heads (GQA) in the kernel, with optional
// attention dropout, its products 3xTF32 on the tensor cores
// (attn_f32_sm90.cuh).
//
// Replaces the TPU kernel building_llm_from_scratch_tpu/ops/fused_attention.py
// _dkv_kernel (second call in _bwd) together with _bwd's group sum, for
// fp32: per query head h, dv_h = sum (M p / (1-p))^T.dO and dk_h = sum
// dS^T.q; the G heads of a kv head are summed in fp32 (rounding a head's
// result to fp32 is the identity) and written once as (B, T, Hkv, D). No
// workspace, no second kernel, no atomics: one block walks the G heads of
// its key tile in order, or, when the key tiles alone do not fill the card,
// the C blocks of a thread-block cluster share a key tile, each takes G / C
// of its query heads, and after a cluster barrier each block sums one slice
// of the C partial results out of the others' shared memory in rank order;
// two calls are bit-equal. (At LLaMA-3.2-1B's T 256 reference shape the
// key tiles make 16 blocks: 0.153 ms walking the heads, 0.052 with C 4; at
// its training shape, 256 blocks, 0.706 walking them against 0.843 with
// C 4: scripts/flash_attention_timing.py on an H100.)
//
// What bounds it: operations (four 64-deep products per score element),
// ~34 GFLOP at LLaMA-3.2-1B's training shape.
//
// Design: one cluster of C blocks per (keys, kv head, batch row), heavy key
// tiles (low index) first, each block taking G / C of the query heads: 128
// keys (two consumer warpgroups) with 32-row query stages at D 64; 64 keys
// and 16-row stages at D 128, where K, V and their lo tiles alone take 128
// KB. K and V come once by TMA and the split warps round them and write
// their lo tiles; the producer then streams each (head, query tile) stage,
// Q and dO by TMA and the tile's lse and delta rows by a bulk copy, through
// a double-buffered ring, and the split warps split Q and dO.
// S^T = K.Q^T and dP^T = V.dO^T are three wgmma chains each; P^T and dS^T
// are formed in the accumulators and dV += P^T.dO, dK += dS^T.Q are
// mma.sync with the left operand straight from the accumulator (query
// columns permuted) and dO's / Q's hi and lo read from the split tiles.
// (wgmma over split Q^T / dO^T tiles, as B1 and B2a do, needs eight tiles a
// stage: 64 keys a block and one consumer warpgroup to fit, which timed
// 0.851 against 0.699 ms at LLaMA-3.2-1B's training shape,
// scripts/flash_attention_timing.py on an H100.)

#include "attn_f32_sm90.cuh"

namespace bllm {
namespace attn {
namespace f32 {
namespace {

template <int D> struct DkvGeom {
  static constexpr int kWG = D == 64 ? 2 : 1;
  static constexpr int kCW = 4 * kWG;
  static constexpr int kBK = 64 * kWG;                  // keys of a block
  static constexpr int kBQ = D == 64 ? 32 : 16;         // query rows of a stage
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kKBytes = kBK * D * 4;      // K or V (or a lo tile)
  static constexpr uint32_t kQBytes = kBQ * D * 4;      // Q or dO (or a lo tile)
  static constexpr uint32_t kStageBytes = 4 * kQBytes;  // Q, Q lo, dO, dO lo
  static constexpr uint32_t kStatBytes = kBQ * 4;       // one stage's lse or delta
  static constexpr size_t kSmem = 1024 + 4 * kKBytes + kStages * (kStageBytes + 2 * kStatBytes) +
                                  (2 + 3 * kStages) * 8;
};

// the cluster: a barrier of every thread of its blocks, and a float of
// another block's shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(DkvGeom<D>::kThreads, 1)
attn_dkv_f32_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmdO, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int seq, int Hq, int Hkv, int B, int C, float scale,
                    float scale_log2, Drop drop) {
  using G = DkvGeom<D>;
  constexpr int S = G::kStages, BQ = G::kBQ, BK = G::kBK;
  constexpr int NT = G::kCW * 32;                       // consumer threads
  const int GQ = Hq / Hkv;
  const int HB = GQ / C;                                // query heads of this block
  const int crank = static_cast<int>(blockIdx.x) % C;  // its rank in the cluster
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_base(smem_raw);
  unsigned char* sKlo = sK + G::kKBytes;
  unsigned char* sV = sKlo + G::kKBytes;
  unsigned char* sVlo = sV + G::kKBytes;
  unsigned char* sStage = sVlo + G::kKBytes;             // stage s: Q, Q lo, dO, dO lo
  float* sStat = reinterpret_cast<float*>(sStage + S * G::kStageBytes);   // stage s: lse, delta
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sStat + S * 2 * BQ);
  uint64_t* kvready = kvbar + 1;
  uint64_t* full = kvready + 1;
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;

  const int per = Hkv * B;
  const int cl = static_cast<int>(blockIdx.x) / C;
  const int jt = cl / per;                               // heavy key tiles first
  const int rem = cl % per;
  const int hk = rem % Hkv, b = rem / Hkv;
  const int i0 = jt * BK / BQ;                           // the first query tile to reach a key
  const int n_q = seq / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    mbar_init(kvready, kSplitThreads);
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
        mbar_expect_tx(kvbar, 2 * G::kKBytes);
        load_tile_f32<D, BK>(sK, &tmK, kvbar, hk, jt * BK, b);
        load_tile_f32<D, BK>(sV, &tmV, kvbar, hk, jt * BK, b);
        int n = 0;
        for (int hh = 0; hh < HB; ++hh) {
          const int h = hk * GQ + crank * HB + hh;
          const size_t soff = (static_cast<size_t>(b) * Hq + h) * seq;
          for (int i = i0; i < n_q; ++i, ++n) {
            const int s = n % S;
            mbar_wait(&empty[s], ((n / S) & 1) ^ 1);
            mbar_expect_tx(&full[s], 2 * G::kQBytes + 2 * G::kStatBytes);
            unsigned char* sQ = sStage + s * G::kStageBytes;
            load_tile_f32<D, BQ>(sQ, &tmQ, &full[s], h, i * BQ, b);
            load_tile_f32<D, BQ>(sQ + 2 * G::kQBytes, &tmdO, &full[s], h, i * BQ, b);
            bulk_load(sStat + s * 2 * BQ, lse + soff + i * BQ, G::kStatBytes, &full[s]);
            bulk_load(sStat + s * 2 * BQ + BQ, delta + soff + i * BQ, G::kStatBytes, &full[s]);
          }
        }
      }
    } else {
      const int tid = static_cast<int>(threadIdx.x) - (G::kCW + 1) * 32;
      mbar_wait(kvbar, 0);
      split_tile(sK, sKlo, G::kKBytes, tid);
      split_tile(sV, sVlo, G::kKBytes, tid);
      split_done(kvready);
      const int n_all = HB * (n_q - i0);
      for (int n = 0; n < n_all; ++n) {
        const int s = n % S;
        mbar_wait(&full[s], (n / S) & 1);
        unsigned char* sQ = sStage + s * G::kStageBytes;
        split_tile(sQ, sQ + G::kQBytes, G::kQBytes, tid);
        split_tile(sQ + 2 * G::kQBytes, sQ + 3 * G::kQBytes, G::kQBytes, tid);
        split_done(&ready[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rloc = 16 * (warp & 3) + g;          // fragment row (key) rr = 0 in the warpgroup
  const int kstart = jt * BK + wg * 64;          // the warpgroup's first key
  const int kpos0 = kstart + rloc;               // key of rr = 0; rr = 1 is + 8

  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  mbar_wait(kvbar, 0);
  mbar_wait(kvready, 0);

  int n = 0;
  for (int hh = 0; hh < HB; ++hh) {
    const int h = hk * GQ + crank * HB + hh;
    for (int i = i0; i < n_q; ++i, ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      mbar_wait(&ready[s], (n / S) & 1);
      const int q0 = i * BQ;
      if (q0 + BQ - 1 >= kstart) {               // some query of the tile sees a key
        const unsigned char* sQ = sStage + s * G::kStageBytes;
        const unsigned char* sQlo = sQ + G::kQBytes;
        const unsigned char* sdO = sQlo + G::kQBytes;
        const unsigned char* sdOlo = sdO + G::kQBytes;
        const float* sL = sStat + s * 2 * BQ;
        const float* sDl = sL + BQ;
        float st[BQ / 2], dpt[BQ / 2];
        zero(st);
        zero(dpt);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        wgmma_3xtf32<D, BK, BQ>(st, sK, sKlo, wg * 64, sQ, sQlo);     // S^T = K Q^T
        wgmma_3xtf32<D, BK, BQ>(dpt, sV, sVlo, wg * 64, sdO, sdOlo);  // dP^T = V dO^T
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
        mma_acc_tile<D, BQ>(dva, st, sdO, sdOlo);    // dV += P^T dO
        mma_acc_tile<D, BQ>(dka, dpt, sQ, sQlo);     // dK += dS^T Q
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  const size_t ks = static_cast<size_t>(Hkv) * D;
  if (C == 1) {
    const float one[2] = {1.f, 1.f};
    const size_t off = (static_cast<size_t>(b) * seq + kpos0) * ks + hk * D;
    store_rows<D>(dka, one, dk + off, ks);
    store_rows<D>(dva, one, dv + off, ks);
    return;
  }
  // the partial sums, [dk | dv][fragment element][consumer thread], over K
  // and K lo once both warpgroups are done with them
  asm volatile("bar.sync 2, %0;\n" ::"n"(NT) : "memory");
  float* sSum = reinterpret_cast<float*>(sK);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    sSum[e * NT + threadIdx.x] = dka[e];
    sSum[(D / 2 + e) * NT + threadIdx.x] = dva[e];
  }
  cluster_sync();
  // this block's slice of the C partials, summed in rank order
  const int slice = D * NT / C;
  for (int x = crank * slice + static_cast<int>(threadIdx.x); x < (crank + 1) * slice; x += NT) {
    float acc = 0.f;
    for (int r = 0; r < C; ++r) acc += ld_cluster(sSum + x, r);
    const int th = x % NT, e = (x / NT) % (D / 2);
    const int w = th >> 5, ln = th & 31;
    const int row = jt * BK + (w >> 2) * 64 + 16 * (w & 3) + (ln >> 2) + 8 * ((e >> 1) & 1);
    const int col = 8 * (e >> 2) + 2 * (ln & 3) + (e & 1);
    float* dst = x < D / 2 * NT ? dk : dv;
    dst[(static_cast<size_t>(b) * seq + row) * ks + hk * D + col] = acc;
  }
  cluster_sync();   // no block leaves while another reads its shared memory
}

template <int D, bool kDrop>
int run(const Args& a) {
  using G = DkvGeom<D>;
  constexpr CUtensorMapDataType f = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_bthd_map_of(&tq, f, 4, a.q, a.B, a.seq, a.Hq, D, G::kBQ) ||
      !make_bthd_map_of(&tk, f, 4, a.k, a.B, a.seq, a.Hkv, D, G::kBK) ||
      !make_bthd_map_of(&tv, f, 4, a.v, a.B, a.seq, a.Hkv, D, G::kBK) ||
      !make_bthd_map_of(&tdo, f, 4, a.dout, a.B, a.seq, a.Hq, D, G::kBQ))
    return kNoTensorMap;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  float* dk = static_cast<float*>(a.out0);
  float* dv = static_cast<float*>(a.out1);
  int seq = a.seq, Hq = a.Hq, Hkv = a.Hkv, B = a.B;
  // the cluster: one block walks the G heads (C 1) when the key tiles fill
  // the card; else the heads are split over the smallest C (a power of two
  // dividing G, up to the portable 8) whose blocks do. The plan depends on
  // the shape only, so two calls are bit-equal.
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = (a.seq / G::kBK) * a.Hkv * a.B, GQ = a.Hq / a.Hkv;
  int C = 1;
  while (tiles * C < sms && 2 * C <= 8 && GQ % (2 * C) == 0) C *= 2;
  float scale = a.scale, scale_log2 = a.scale * kLog2e;
  Drop drop = a.drop;
  void* params[] = {&tq, &tk,  &tv,  &tdo, &lse,   &delta,      &dk,  &dv,
                    &seq, &Hq, &Hkv, &B,   &C,   &scale, &scale_log2, &drop};
  const void* kernel = reinterpret_cast<const void*>(attn_dkv_f32_kernel<D, kDrop>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace f32

int dkv_f32_sm90(int hd, const Args& a) {
  if (a.seq % 128 != 0) return kUnsupported;
  const bool drop = a.drop.threshold != 0u;
  if (hd == 64) return drop ? f32::run<64, true>(a) : f32::run<64, false>(a);
  if (hd == 128) return drop ? f32::run<128, true>(a) : f32::run<128, false>(a);
  return kUnsupported;
}

}  // namespace attn
}  // namespace bllm
