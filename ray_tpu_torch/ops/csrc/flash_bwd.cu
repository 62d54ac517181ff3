// Flash-attention backward for Hopper (sm_90a) over [B, T, H, D].
//
// Replaces: ray_tpu/ops/flash_attention.py::_fa_nl_bwd_dkdv_kernel (dK, dV)
// and ::_fa_nl_bwd_dq_kernel (dQ), launched by _flash_nl_backward (the
// native-layout family; entry points rtt_flash_bwd_dkdv, rtt_flash_bwd_dq),
// and ::_fa_bwd_dkdv_kernel and ::_fa_bwd_dq_kernel, launched by
// _flash_backward (the head-major family; the same entry points).  The two
// families compute the same function and differ only in the layout the TPU
// tiles need (flash_common.cuh); these kernels read [B, T, H, D] by
// strides for both.
// Given the forward's row log-sum-exp LSE, the output's cotangent dO and
// delta = rowsum(dO * O) (computed outside, as the JAX package computes it
// outside its Pallas kernels):
//
//   P  = exp(scale * Q K^T - LSE)   LSE clamped to 0 where <= -1e30 / 2
//   dV = P~^T dO                    P~ = P rounded to dO's dtype
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dK = dS~^T Q,  dQ = dS~ K       dS~ = dS rounded to the input dtype
//
// with the causal mask aligned top-left (key k visible to query q iff
// k <= q).  Masked pairs and rows past a ragged end give P = 0 exactly.
//
// Bound: at the GPT-2 training shape [32, 1024, 12, 64] bf16 causal there
// are 201 M visible (query, key) pairs.  dK/dV does 8 * D flops per pair
// (103 GFLOP, 104 us at 989 TFLOP/s) against q, k, v, dO read and dK, dV
// written once (302 MB, 90 us at 3.35 TB/s); dQ does 6 * D flops per pair
// (77 GFLOP, 78 us) against five tensors (252 MB, 75 us).  At GPT-2 XL's
// [8, 1024, 25, 64] operations bound both (dK/dV 54 us, dQ 41 us).  Both sit
// near where the two bounds meet, so the design keeps every [T, T] intermediate
// (S, P, dP, dS) in registers and reads each tensor tile once per block.
//
// Design.  Two kernels, no atomics, deterministic.
//
// dK/dV (bf16; Hopper: TMA, mbarriers, wgmma, helpers in hopper.cuh): one
// block per (batch * head, 128-key tile), three warpgroups.  A producer
// warpgroup (setmaxnreg 24) loads the block's K and V once by TMA and
// streams 64-query tiles of Q and dO through a ring of shared-memory
// stages, with the tile's LSE (in log2 units) and delta written beside
// them by the producer's warp (a 1-D bulk copy would need 16-byte aligned
// rows, which T = 101 breaks).  Each stage has a "full" and an "empty"
// mbarrier.  Two consumer warpgroups (setmaxnreg 240) own 64 keys each
// and loop over the query tiles; with causal the loop starts at the tile
// holding the block's first key, so tiles wholly above the diagonal are
// never loaded.  Per tile, four wgmma products:
//   S^T = K Q^T and dP^T = V dO^T  (m64n64k16, both operands K-major in
//                                   shared memory)
//   dV += P~^T dO and dK += dS~^T Q (A from registers: the S^T and dP^T
//                                   accumulators, rounded to bf16, are
//                                   already A fragments; dO and Q read
//                                   MN-major from the same stage)
// so one swizzled Q tile and one dO tile serve as both K-major and
// MN-major operands, through two descriptors.  LSE and delta are per
// query, a column of S^T: each thread reads its columns' values from the
// stage.  A stage is released after the wait for the products that read
// it.  dK and dV (64 x D f32 each per warpgroup, 128 registers a thread at
// D = 128) stay in registers for the whole loop and are written once, in
// bf16, over the consumer's own K and V rows and out by TMA.  TMA zero-fills
// positions past T; rows past tq are masked, keys past tk are not written.
//
// dQ (bf16; the same tools): persistent, one block per SM walking work
// items (batch * head, 128-query tile) two at a time in the forward's
// order (work_head_tile_pairs: a causal head's tiles k and n-1-k
// together; a dQ item has exactly the forward's work).  A producer
// warpgroup (setmaxnreg 24): one thread loads each item's Q and dO by TMA
// into one of two item buffers and streams K and V tiles (128 keys; 64 at
// D = 128) through a ring of stages, K and V each with full/empty
// mbarriers; a second thread stores each item's dQ.  Two consumer
// warpgroups (setmaxnreg 240) own 64 queries each and take turns on two
// named barriers, as the forward's do: in its turn a consumer issues the
// previous tile's dQ += dS~ K (A from registers; K read MN-major from its
// stage, one wgmma per 64-column box) and this tile's S = Q K^T and
// dP = dO V^T (SS, K-major), waits, and releases V, and K a turn later.
// Between its turns it forms P = 2^(S scale log2 e - LSE log2 e) and
// dS = P (dP - delta) scale from the accumulators and rounds dS into the
// next turn's A fragments, while the other consumer's products run.  LSE
// and delta are per query, one accumulator row: each thread reads its two
// rows' values once per item.  dQ stays in registers for the item and is
// written once, in bf16, over the consumer's own Q rows, which the second
// producer thread stores by TMA (positions past tq are not written); the
// buffer then takes item k + 2's Q and dO.
//
// f32 inputs take plain FMA kernels (no tensor cores, so no TF32 rounding) for
// the tight comparison with the plain version and for f32 models: lane j
// of a warp scores query (dK/dV) or key (dQ) j of a 32-wide tile, and
// owns gradient columns j, j + 32, ...
//
// Head sizes: built for 32, 64 and 128; any multiple of 8 up to 128 runs
// on the next of those, its extra columns zeros (flash_common.cuh,
// by_head_dim).  Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ float clamp_lse(float x) {
  return x <= kNegInf / 2 ? 0.f : x;
}

// ---------------------------------------------------------------- bf16 --

namespace hp = hopper;

constexpr int kBwdBN = 128, kBwdBM = 64;  // keys per block, queries per tile
constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kBwdThreads = 3 * kWg;      // consumers 0, 1; producer 2

// Shared memory: K, V, the Q/dO stages, the stages' LSE/delta, mbarriers.
template <int D>
struct DkdvSmem {
  using L = hp::Swz<D>;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr uint32_t kKBox = kBwdBN * L::kRowBytes;
  static constexpr uint32_t kK = L::kBoxes * kKBox;  // K or V
  static constexpr uint32_t kQBox = kBwdBM * L::kRowBytes;
  static constexpr uint32_t kQ = L::kBoxes * kQBox;  // one Q or dO tile
  static constexpr uint32_t kStage = 2 * kQ;
  static constexpr uint32_t kStats = 2 * kK + kStages * kStage;
  static constexpr uint32_t kStatBytes = 2 * kBwdBM * 4;  // LSE, delta
  static constexpr uint32_t kBars = kStats + kStages * kStatBytes;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap dkmap,
                     const __grid_constant__ CUtensorMap dvmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int heads, int tq,
                     int tk, float scale, int causal) {
  using L = hp::Swz<D>;
  using SM = DkdvSmem<D>;
  constexpr int BN = kBwdBN, BM = kBwdBM, NS = SM::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + SM::kK;
  const uint32_t stage_s = v_s + SM::kK;  // stage i: Q, then dO
  const uint32_t stats_s = k_s + SM::kStats;
  const uint32_t kv_full = k_s + SM::kBars;
  auto full = [&](int i) { return kv_full + 8 * (1 + i); };
  auto empty = [&](int i) { return kv_full + 8 * (1 + NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg, lane = tid % 32;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * BN;
  const int m_begin = causal ? n0 / BM : 0;
  const int m_end = (tq + BM - 1) / BM;

  if (tid == 0) {
    hp::mbar_init(kv_full, 1);
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(full(i), 32);  // the producer's warp
      hp::mbar_init(empty(i), 2 * kWg);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: its first warp
    hp::regs_dec<24>();
    if (tid >= 2 * kWg + 32) return;
    if (lane == 0) {
      hp::mbar_arrive_tx(kv_full, 2 * SM::kK);
      for (int half = 0; half < 2; ++half)
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          const uint32_t off = bx * SM::kKBox + half * 64 * L::kRowBytes;
          hp::tma_load(k_s + off, &kmap, kv_full, bx * L::kCols, h,
                       n0 + half * 64, b);
          hp::tma_load(v_s + off, &vmap, kv_full, bx * L::kCols, h,
                       n0 + half * 64, b);
        }
    }
    const float* lse_b = lse + ((size_t)b * heads + h) * tq;
    const float* delta_b = delta + ((size_t)b * heads + h) * tq;
    for (int mt = m_begin; mt < m_end; ++mt) {
      const int it = mt - m_begin, st = it % NS, m0 = mt * BM;
      hp::mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
      const uint32_t stats = stats_s + st * SM::kStatBytes;
      for (int r = lane; r < BM; r += 32) {
        const bool ok = m0 + r < tq;
        hp::st_shared(stats + 4 * r, __float_as_uint(
            ok ? clamp_lse(lse_b[m0 + r]) * kLog2e : 0.f));
        hp::st_shared(stats + 4 * (BM + r),
                      __float_as_uint(ok ? delta_b[m0 + r] : 0.f));
      }
      if (lane == 0) {
        const uint32_t qs = stage_s + st * SM::kStage;
        hp::mbar_arrive_tx(full(st), SM::kStage);
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          hp::tma_load(qs + bx * SM::kQBox, &qmap, full(st), bx * L::kCols,
                       h, m0, b);
          hp::tma_load(qs + SM::kQ + bx * SM::kQBox, &domap, full(st),
                       bx * L::kCols, h, m0, b);
        }
      } else {
        hp::mbar_arrive(full(st));
      }
    }
    return;
  }

  // consumer warpgroup wg: keys n0 + wg * 64 ...
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int first_key = n0 + wg * 64;
  const int key[2] = {first_key + warp * 16 + g, first_key + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;  // scores in log2 units
  const uint32_t ka = k_s + wg * 64 * L::kRowBytes;
  const uint32_t va = v_s + wg * 64 * L::kRowBytes;

  float dka[L::kBoxes][L::kCols / 2], dva[L::kBoxes][L::kCols / 2];
#pragma unroll
  for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
    for (int e = 0; e < L::kCols / 2; ++e) dka[bx][e] = dva[bx][e] = 0.f;

  hp::mbar_wait(kv_full, 0);
  for (int mt = m_begin; mt < m_end; ++mt) {
    const int it = mt - m_begin, st = it % NS, m0 = mt * BM;
    const uint32_t qs = stage_s + st * SM::kStage, dos = qs + SM::kQ;
    const uint32_t stats = stats_s + st * SM::kStatBytes;
    hp::mbar_wait(full(st), (it / NS) & 1);

    // S^T = K Q^T, then dP^T = V dO^T, two groups; element 4j + e of each
    // is (key[e >> 1], query m0 + 8j + 2t + (e & 1)).
    float sT[32], dpt[32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
      hp::mma_ss_n64(sT, hp::desc_k<D>(ka + bx * SM::kKBox + kb),
                     hp::desc_k<D>(qs + bx * SM::kQBox + kb), kk > 0);
    }
    hp::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
      hp::mma_ss_n64(dpt, hp::desc_k<D>(va + bx * SM::kKBox + kb),
                     hp::desc_k<D>(dos + bx * SM::kQBox + kb), kk > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    hp::fence_regs(sT);

    // P^T in place of S^T while dP^T runs
    const bool masked = m0 + BM > tq || (causal && first_key + 63 > m0);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 l2 = hp::ld_shared_f2(stats + 4 * (8 * j + 2 * t));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(sT[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x));
        if (masked) {
          const int qpos = m0 + 8 * j + 2 * t + (e & 1);
          if (qpos >= tq || (causal && key[e >> 1] > qpos)) p = 0.f;
        }
        sT[4 * j + e] = p;
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 d2 = hp::ld_shared_f2(stats + 4 * (BM + 8 * j + 2 * t));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = sT[4 * j + e] *
                         (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }

    // dV += P~^T dO and dK += dS~^T Q: the accumulators of 8-query groups
    // 2kk and 2kk+1 are the A fragment of query slice kk; dO and Q are the
    // MN-major B operands.
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_f32(sT[8 * kk + 2 * r], sT[8 * kk + 2 * r + 1]);
        dsa[kk][r] = pack_f32(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        const uint32_t off = bx * SM::kQBox + kk * 16 * L::kRowBytes;
        hp::mma_rs_box<D>(dva[bx], pa[kk],
                          hp::desc_mn<D>(dos + off, SM::kQBox));
        hp::mma_rs_box<D>(dka[bx], dsa[kk],
                          hp::desc_mn<D>(qs + off, SM::kQBox));
      }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      hp::fence_regs(pa[kk]);
      hp::fence_regs(dsa[kk]);
    }
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx) {
      hp::fence_regs(dka[bx]);
      hp::fence_regs(dva[bx]);
    }
    hp::mbar_arrive(empty(st));
  }

  // dK and dV in bf16 over this warpgroup's own K and V rows, then by TMA
#pragma unroll
  for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
    for (int c = 0; c < L::kCols / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off =
            bx * SM::kKBox + hp::swizzled<D>(warp * 16 + g + 8 * i,
                                             8 * c + 2 * t);
        hp::st_shared(ka + off, pack_f32(dka[bx][4 * c + 2 * i],
                                         dka[bx][4 * c + 2 * i + 1]));
        hp::st_shared(va + off, pack_f32(dva[bx][4 * c + 2 * i],
                                         dva[bx][4 * c + 2 * i + 1]));
      }
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, kWg);
  if (tid % kWg == 0) {
    for (int bx = 0; bx < L::kBoxes; ++bx) {
      hp::tma_store(&dkmap, ka + bx * SM::kKBox, bx * L::kCols, h, first_key,
                    b);
      hp::tma_store(&dvmap, va + bx * SM::kKBox, bx * L::kCols, h, first_key,
                    b);
    }
    hp::tma_commit();
    hp::tma_wait_read();
  }
}

constexpr int kDqBM = 128;  // queries per item, 64 per consumer
constexpr int kTurnBar = 1;  // named barriers 1 + w: consumer w's turn

// Shared memory: two item buffers (Q, then dO; the item's dQ is staged
// over its Q), the K/V stages, the mbarriers.
template <int D>
struct DqSmem {
  using L = hp::Swz<D>;
  // keys per stage: at D = 128 a consumer thread holds S, dP (BN / 2 f32
  // each) and dQ (D / 2), so 128 keys would not fit its 240 registers
  static constexpr int kBN = D == 128 ? 64 : 128;
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr uint32_t kQBox = kDqBM * L::kRowBytes;
  static constexpr uint32_t kQ = L::kBoxes * kQBox;  // Q, dO or dQ of an item
  static constexpr uint32_t kItem = 2 * kQ;
  static constexpr uint32_t kKVBox = kBN * L::kRowBytes;
  static constexpr uint32_t kKV = L::kBoxes * kKVBox;  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kStages0 = 2 * kItem;
  static constexpr uint32_t kBars = kStages0 + kStages * kStage;
  // per item buffer: Q and dO landed, dQ staged, dQ stored (the buffer is
  // free); per stage: K full, V full, K empty, V empty
  static constexpr int kNumBars = 6 + 4 * kStages;
  // + 1024: the base is aligned up to the swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
};

// Persistent: block c takes the work items 2u and 2u + 1 (in the order of
// work_head_tile_pairs, as the forward) for u = c, c + gridDim.x, ...
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const __grid_constant__ CUtensorMap dqmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int batch, int heads,
                   int tq, int tk, float scale, int causal) {
  using L = hp::Swz<D>;
  using SM = DqSmem<D>;
  constexpr int BM = kDqBM, BN = SM::kBN, NS = SM::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t item_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = item_s + SM::kStages0;  // stage i: K, then V
  const uint32_t bars = item_s + SM::kBars;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto dq_full = [&](int i) { return bars + 8 * (2 + i); };
  auto q_empty = [&](int i) { return bars + 8 * (4 + i); };
  auto k_full = [&](int i) { return bars + 8 * (6 + i); };
  auto v_full = [&](int i) { return bars + 8 * (6 + NS + i); };
  auto k_empty = [&](int i) { return bars + 8 * (6 + 2 * NS + i); };
  auto v_empty = [&](int i) { return bars + 8 * (6 + 3 * NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg;
  const unsigned n_bh = (unsigned)batch * heads;
  const unsigned n_qt = (tq + BM - 1) / BM;
  const unsigned n_work = n_bh * n_qt;
  // this block's items: lin = 2u, 2u + 1 for u = blockIdx.x + j gridDim.x
  auto item = [&](unsigned k) {
    return 2 * (blockIdx.x + (k / 2) * gridDim.x) + (k & 1);
  };
  auto work = [&](unsigned lin) {  // all three roles agree on both
    return work_head_tile_pairs(lin, n_bh, n_qt);
  };
  auto key_tiles_of = [&](int m0) {  // the loop stops at the diagonal
    return key_tiles(m0, BM, BN, tq, tk, causal);
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hp::mbar_init(q_full(i), 1);
      hp::mbar_init(dq_full(i), 2 * kWg);
      hp::mbar_init(q_empty(i), 1);
    }
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(k_full(i), 1);
      hp::mbar_init(v_full(i), 1);
      hp::mbar_init(k_empty(i), 2 * kWg);
      hp::mbar_init(v_empty(i), 2 * kWg);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread loads, one stores
    hp::regs_dec<24>();
    if (tid == 2 * kWg) {
      unsigned kv_it = 0;  // K/V tiles streamed, over all items
      for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
        const Work w = work(lin);
        const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
        // Q and dO into buffer k & 1 once item k - 2's dQ has left it
        const int qb = k & 1;
        const uint32_t qs = item_s + qb * SM::kItem;
        hp::mbar_wait(q_empty(qb), ((k >> 1) & 1) ^ 1);
        hp::mbar_arrive_tx(q_full(qb), SM::kItem);
        for (int half = 0; half < 2; ++half)
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            const uint32_t off = bx * SM::kQBox + half * 64 * L::kRowBytes;
            hp::tma_load(qs + off, &qmap, q_full(qb), bx * L::kCols, h,
                         m0 + half * 64, b);
            hp::tma_load(qs + SM::kQ + off, &domap, q_full(qb),
                         bx * L::kCols, h, m0 + half * 64, b);
          }
        const int n_tiles = key_tiles_of(m0);
        for (int it = 0; it < n_tiles; ++it, ++kv_it) {
          const int st = kv_it % NS;
          const uint32_t free_parity = ((kv_it / NS) & 1) ^ 1;
          const uint32_t ks = kv_s + st * SM::kStage;
          hp::mbar_wait(k_empty(st), free_parity);
          hp::mbar_arrive_tx(k_full(st), SM::kKV);
          for (int bx = 0; bx < L::kBoxes; ++bx)
            hp::tma_load(ks + bx * SM::kKVBox, &kmap, k_full(st),
                         bx * L::kCols, h, it * BN, b);
          hp::mbar_wait(v_empty(st), free_parity);
          hp::mbar_arrive_tx(v_full(st), SM::kKV);
          for (int bx = 0; bx < L::kBoxes; ++bx)
            hp::tma_load(ks + SM::kKV + bx * SM::kKVBox, &vmap, v_full(st),
                         bx * L::kCols, h, it * BN, b);
        }
      }
    } else if (tid == 2 * kWg + 32) {
      // each item's dQ by TMA once both consumers staged it (positions
      // past tq are not written), then its buffer is free
      for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
        const Work w = work(lin);
        const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
        const int qb = k & 1;
        const uint32_t qs = item_s + qb * SM::kItem;
        hp::mbar_wait(dq_full(qb), (k >> 1) & 1);
        for (int half = 0; half < 2; ++half)
          for (int bx = 0; bx < L::kBoxes; ++bx)
            hp::tma_store(&dqmap,
                          qs + bx * SM::kQBox + half * 64 * L::kRowBytes,
                          bx * L::kCols, h, m0 + half * 64, b);
        hp::tma_commit();
        hp::tma_wait_read();
        hp::mbar_arrive(q_empty(qb));
      }
    }
    return;
  }

  // consumer warpgroup wg: queries m0 + wg * 64 ... of each item
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const float sl2 = scale * kLog2e;  // scores in log2 units
  // Turns, as in the forward: a consumer issues all its products of a
  // turn (the previous tile's dQ += dS~ K and this tile's S and dP)
  // between a wait on its own named barrier and an arrival on the
  // other's, so one's exp2 and dS run while the other's products do.
  // Consumer 0 takes the first turn; both take one turn per key tile plus
  // one per item.
  if (wg == 1) hp::named_arrive(kTurnBar, 2 * kWg);
  unsigned kv0 = 0;  // K/V tiles of the earlier items
  for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
    const Work w = work(lin);
    const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
    const int n_tiles = key_tiles_of(m0);
    const int first_row = m0 + wg * 64;
    const int row[2] = {first_row + warp * 16 + g,
                        first_row + warp * 16 + g + 8};
    const uint32_t qa = item_s + (k & 1) * SM::kItem + wg * 64 * L::kRowBytes;
    const uint32_t da = qa + SM::kQ;  // this warpgroup's dO rows

    // LSE (log2 units, clamped) and delta of this thread's two rows
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row[i] < tq;
      const size_t idx = ((size_t)b * heads + h) * tq + row[i];
      lse2[i] = ok ? clamp_lse(lse[idx]) * kLog2e : 0.f;
      dl[i] = ok ? delta[idx] : 0.f;
    }

    float dq[L::kBoxes][L::kCols / 2];
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
      for (int e = 0; e < L::kCols / 2; ++e) dq[bx][e] = 0.f;
    // S and dP: element 4j + e is (row[e >> 1], key n0 + 8j + 2t +
    // (e & 1)).  dS~: the accumulators of 8-key groups 2kk and 2kk+1,
    // rounded to bf16, are the wgmma A fragment of key slice kk.
    float s[BN / 2], dp[BN / 2];
    uint32_t dsa[BN / 16][4];

    // One turn: dQ += dS~ K of tile it - 1 (K MN-major, from its stage)
    // and S = Q K^T, dP = dO V^T of tile it (all K-major), as the flags
    // say; then wait for all and release what they read.  K is released
    // a turn after V.
    auto turn = [&](int it, auto with_dq, auto with_s) {
      constexpr bool kDQ = decltype(with_dq)::value;
      constexpr bool kS = decltype(with_s)::value;
      const unsigned cur = kv0 + it, prev = cur - 1;
      const uint32_t ks = kv_s + (cur % NS) * SM::kStage, vs = ks + SM::kKV;
      const uint32_t kp = kv_s + (prev % NS) * SM::kStage;
      if constexpr (kS) {
        hp::mbar_wait(k_full(cur % NS), (cur / NS) & 1);
        hp::mbar_wait(v_full(cur % NS), (cur / NS) & 1);
      }
      hp::named_sync(kTurnBar + wg, 2 * kWg);
      hp::wgmma_fence();
      if constexpr (kDQ) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx)
            hp::mma_rs_box<D>(
                dq[bx], dsa[kk],
                hp::desc_mn<D>(kp + bx * SM::kKVBox + kk * 16 * L::kRowBytes,
                               SM::kKVBox));
      }
      if constexpr (kS) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
          hp::mma_ss<BN>(s, hp::desc_k<D>(qa + bx * SM::kQBox + kb),
                         hp::desc_k<D>(ks + bx * SM::kKVBox + kb), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
          hp::mma_ss<BN>(dp, hp::desc_k<D>(da + bx * SM::kQBox + kb),
                         hp::desc_k<D>(vs + bx * SM::kKVBox + kb), kk > 0);
        }
      }
      hp::wgmma_commit();
      hp::named_arrive(kTurnBar + (wg ^ 1), 2 * kWg);
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      hp::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hp::fence_regs(dsa[kk]);
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) hp::fence_regs(dq[bx]);
      if constexpr (kDQ) hp::mbar_arrive(k_empty(prev % NS));
      if constexpr (kS) hp::mbar_arrive(v_empty(cur % NS));
    };

    // dS~ of tile it into dsa: P = 2^(S sl2 - LSE log2 e), 0 where
    // masked; dS = P (dP - delta) scale.
    auto grad = [&](int it) {
      const int n0 = it * BN;
      const bool masked =
          n0 + BN > tk || (causal && n0 + BN - 1 > first_row);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = hp::exp2(fmaf(s[4 * j + e], sl2, -lse2[i]));
          if (masked) {
            const int kpos = n0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= tk || (causal && kpos > row[i])) p = 0.f;
          }
          s[4 * j + e] = p * (dp[4 * j + e] - dl[i]) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dsa[kk][r] = pack_f32(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    hp::mbar_wait(q_full(k & 1), (k >> 1) & 1);
    turn(0, std::false_type{}, std::true_type{});
    grad(0);
    for (int it = 1; it < n_tiles; ++it) {
      turn(it, std::true_type{}, std::true_type{});
      grad(it);
    }
    turn(n_tiles, std::true_type{}, std::false_type{});
    kv0 += n_tiles;

    // dQ in bf16 over this warpgroup's Q rows (its last S is done), for
    // the producer's store
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
      for (int c = 0; c < L::kCols / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::st_shared(qa + bx * SM::kQBox +
                            hp::swizzled<D>(warp * 16 + g + 8 * i,
                                            8 * c + 2 * t),
                        pack_f32(dq[bx][4 * c + 2 * i],
                                 dq[bx][4 * c + 2 * i + 1]));
    hp::fence_proxy_async();
    hp::mbar_arrive(dq_full(k & 1));
  }
  // consumer 1's arrival after its last turn
  if (wg == 0) hp::named_sync(kTurnBar, 2 * kWg);
}

// ----------------------------------------------------------------- f32 --

// Copy rows [r0, r0 + ROWS) of one head into a shared tile with row
// stride LD, zero past row `limit` and past column `dim` (by_head_dim).
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int limit, int dim,
                                          size_t rs, int tid) {
  for (int c = tid; c < ROWS * D; c += kThreads) {
    const int r = c / D, d = c % D;
    dst[r * LD + d] = r0 + r < limit && d < dim
                          ? src[(size_t)(r0 + r) * rs + d]
                          : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_f32_smem() {  // ks, vs [16][D]; qs, dos [32][D + 1]
  return (2 * 16 * D + 2 * 32 * (D + 1) + 2 * 32) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kF32MinBlocks)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int heads, int dim, int tq,
                    int tk, float scale, int causal) {
  constexpr int KPW = 4, BN = KPW * kThreads / 32, BM = 32, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [BN][D]
  float* vs = ks + BN * D;                     // [BN][D]
  float* qs = vs + BN * D;                     // [BM][D + 1]: lane j reads
  float* dos = qs + BM * (D + 1);              // row j conflict-free
  float* lse_s = dos + BM * (D + 1);           // [BM]
  float* delta_s = lse_s + BM;                 // [BM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * BN;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const size_t koff = slice_base(b, h, heads, tk, dim);
  const float* lse_b = lse + ((size_t)b * heads + h) * tq;
  const float* delta_b = delta + ((size_t)b * heads + h) * tq;

  stage_f32<D, BN, D>(ks, k + koff, n0, tk, dim, rs, tid);
  stage_f32<D, BN, D>(vs, v + koff, n0, tk, dim, rs, tid);

  float dka[KPW][DPL], dva[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.f;

  const int m_tiles = (tq + BM - 1) / BM;
  for (int mt = causal ? n0 / BM : 0; mt < m_tiles; ++mt) {
    const int m0 = mt * BM;
    __syncthreads();
    stage_f32<D, BM, D + 1>(qs, q + qoff, m0, tq, dim, rs, tid);
    stage_f32<D, BM, D + 1>(dos, dout + qoff, m0, tq, dim, rs, tid);
    if (tid < BM) {
      const bool ok = m0 + tid < tq;
      lse_s[tid] = ok ? clamp_lse(lse_b[m0 + tid]) : 0.f;
      delta_s[tid] = ok ? delta_b[m0 + tid] : 0.f;
    }
    __syncthreads();

    // lane j: query m0 + j against each of this warp's KPW keys
    float s[KPW], dpt[KPW];
#pragma unroll
    for (int r = 0; r < KPW; ++r) s[r] = dpt[r] = 0.f;
    // unrolled by 4: a full unroll spilled registers at D = 64
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[lane * (D + 1) + d];
      const float dd = dos[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        s[r] = fmaf(ks[(warp * KPW + r) * D + d], qd, s[r]);
        dpt[r] = fmaf(vs[(warp * KPW + r) * D + d], dd, dpt[r]);
      }
    }
    const int qpos = m0 + lane;
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int kpos = n0 + warp * KPW + r;
      float p = expf(s[r] * scale - lse_s[lane]);
      if (qpos >= tq || kpos >= tk || (causal && kpos > qpos)) p = 0.f;
      s[r] = p;
      dpt[r] = p * (dpt[r] - delta_s[lane]) * scale;
    }

    // dV += P^T dO, dK += dS^T Q: lane owns columns lane + 32 i
    for (int j = 0; j < BM; ++j) {
      float qj[DPL], dj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        qj[i] = qs[j * (D + 1) + lane + 32 * i];
        dj[i] = dos[j * (D + 1) + lane + 32 * i];
      }
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
        const float dsj = __shfl_sync(0xffffffffu, dpt[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          dva[r][i] = fmaf(pj, dj[i], dva[r][i]);
          dka[r][i] = fmaf(dsj, qj[i], dka[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int kpos = n0 + warp * KPW + r;
    if (kpos >= tk) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      if (lane + 32 * i >= dim) continue;
      dk[koff + kpos * rs + lane + 32 * i] = dka[r][i];
      dv[koff + kpos * rs + lane + 32 * i] = dva[r][i];
    }
  }
}

template <int D>
constexpr size_t dq_f32_smem() {  // qs, dos [16][D]; ks, vs [32][D + 1]
  return (2 * 16 * D + 2 * 32 * (D + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kF32MinBlocks)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int heads, int dim, int tq, int tk, float scale,
                  int causal) {
  constexpr int RPW = 4, BM = RPW * kThreads / 32, BN = 32, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [BM][D]
  float* dos = qs + BM * D;                    // [BM][D]
  float* ks = dos + BM * D;                    // [BN][D + 1]
  float* vs = ks + BN * (D + 1);               // [BN][D + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Work w = work_longest_first();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * BM;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const size_t koff = slice_base(b, h, heads, tk, dim);

  stage_f32<D, BM, D>(qs, q + qoff, m0, tq, dim, rs, tid);
  stage_f32<D, BM, D>(dos, dout + qoff, m0, tq, dim, rs, tid);
  float lse_r[RPW], delta_r[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = m0 + warp * RPW + r;
    const size_t idx = ((size_t)b * heads + h) * tq + qpos;
    lse_r[r] = qpos < tq ? clamp_lse(lse[idx]) : 0.f;
    delta_r[r] = qpos < tq ? delta[idx] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();
    stage_f32<D, BN, D + 1>(ks, k + koff, n0, tk, dim, rs, tid);
    stage_f32<D, BN, D + 1>(vs, v + koff, n0, tk, dim, rs, tid);
    __syncthreads();

    // lane j: key n0 + j against each of this warp's RPW queries
    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d];
      const float vd = vs[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        s[r] = fmaf(qs[(warp * RPW + r) * D + d], kd, s[r]);
        dp[r] = fmaf(dos[(warp * RPW + r) * D + d], vd, dp[r]);
      }
    }
    const int kpos = n0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = m0 + warp * RPW + r;
      float p = expf(s[r] * scale - lse_r[r]);
      if (qpos >= tq || kpos >= tk || (causal && kpos > qpos)) p = 0.f;
      s[r] = p * (dp[r] - delta_r[r]) * scale;
    }

    // dQ += dS K: lane owns columns lane + 32 i
    for (int j = 0; j < BN; ++j) {
      float kj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) kj[i] = ks[j * (D + 1) + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(dsj, kj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = m0 + warp * RPW + r;
    if (qpos >= tq) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (lane + 32 * i < dim) dq[qoff + qpos * rs + lane + 32 * i] = acc[r][i];
  }
}

using bf16 = __nv_bfloat16;

int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int batch,
         int tq, int tk, int heads, int head_dim, float scale, int causal,
         int dtype, void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return (int)by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(bwd_dkdv_f32_kernel<D>,
                    dim3(batch * heads, (tk + 15) / 16), dkdv_f32_smem<D>(), s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), l, dl,
                    static_cast<float*>(dk), static_cast<float*>(dv), heads,
                    head_dim, tq, tk, scale, causal);
    CUtensorMap qm, km, vm, dom, dkm, dvm;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, kBwdBM) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, 64) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, 64) ||
        !hp::encode_map<D>(&dom, dout, batch, tq, heads, head_dim, kBwdBM) ||
        !hp::encode_map<D>(&dkm, dk, batch, tk, heads, head_dim, 64) ||
        !hp::encode_map<D>(&dvm, dv, batch, tk, heads, head_dim, 64))
      return cudaErrorInvalidValue;
    return launch_block(bwd_dkdv_bf16_kernel<D>,
                        dim3(batch * heads, (tk + kBwdBN - 1) / kBwdBN),
                        kBwdThreads, DkdvSmem<D>::kBytes, s, qm, km, vm, dom,
                        dkm, dvm, l, dl, heads, tq, tk, scale, causal);
  });
}

int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int batch, int tq,
       int tk, int heads, int head_dim, float scale, int causal, int dtype,
       void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return (int)by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(bwd_dq_f32_kernel<D>,
                    dim3(batch * heads, (tq + 15) / 16), dq_f32_smem<D>(), s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout), l, dl,
                    static_cast<float*>(dq_out), heads, head_dim, tq, tk,
                    scale, causal);
    CUtensorMap qm, km, vm, dom, dqm;
    constexpr int BN = DqSmem<D>::kBN;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, 64) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, BN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, BN) ||
        !hp::encode_map<D>(&dom, dout, batch, tq, heads, head_dim, 64) ||
        !hp::encode_map<D>(&dqm, dq_out, batch, tq, heads, head_dim, 64))
      return cudaErrorInvalidValue;
    int blocks = 0;
    const cudaError_t e = persistent_blocks(
        (long)batch * heads * ((tq + kDqBM - 1) / kDqBM), &blocks);
    if (e != cudaSuccess) return e;
    return launch_block(bwd_dq_bf16_kernel<D>, dim3(blocks), kBwdThreads,
                        DqSmem<D>::kBytes, s, qm, km, vm, dom, dqm, l, dl,
                        batch, heads, tq, tk, scale, causal);
  });
}

}  // namespace

// q, dout [B, Tq, H, D], k, v [B, Tk, H, D] contiguous; lse, delta
// [B, H, Tq] f32; dk, dv like k; head_dim a multiple of 8 up to 128.  dtype:
// 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int rtt_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int batch, int tq,
                                  int tk, int heads, int head_dim,
                                  float scale, int causal, int dtype,
                                  void* stream) {
  return dkdv(q, k, v, dout, lse, delta, dk, dv, batch, tq, tk, heads,
              head_dim, scale, causal, dtype, stream);
}

// As rtt_flash_bwd_dkdv; dq like q.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq_out, int batch,
                                int tq, int tk, int heads, int head_dim,
                                float scale, int causal, int dtype,
                                void* stream) {
  return dq(q, k, v, dout, lse, delta, dq_out, batch, tq, tk, heads,
            head_dim, scale, causal, dtype, stream);
}

// As rtt_flash_fwd_attrs, for the bf16 dK/dV kernel (kernel 0) or the
// bf16 dQ kernel (kernel 1).
extern "C" int rtt_flash_bwd_attrs(int kernel, int head_dim, int* out) {
  if (kernel != 0 && kernel != 1) return (int)cudaErrorInvalidValue;
  return (int)by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return kernel == 0 ? func_attrs(bwd_dkdv_bf16_kernel<D>, out)
                       : func_attrs(bwd_dq_bf16_kernel<D>, out);
  });
}
