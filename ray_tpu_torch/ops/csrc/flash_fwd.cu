// Flash-attention forward for Hopper (sm_90a) over [B, T, H, D].
//
// Replaces: ray_tpu/ops/flash_attention.py::_fa_nl_kernel (the native-layout
// family, launched by _flash_nl_forward) and ::_fa_kernel (the head-major
// family, launched by _flash_forward).  Both compute O = softmax(scale *
// Q K^T) V with the causal mask aligned top-left (key k visible to query q
// iff k <= q), online softmax in f32, and the row log-sum-exp
// LSE = m + log(l).  A row with no visible key gives O = 0 and LSE = -1e30,
// as the TPU kernels' epilogues do.  They differ only in the layout the TPU
// tiles need (flash_common.cuh); this kernel reads [B, T, H, D] by strides
// for both, and the port's wrappers count their launches apart.
//
// Bound: at the Llama-2-7B prefill shape [4, 1024, 32, 128] bf16 causal
// the two bounds nearly meet: 134 MB of q/k/v/o (each read or written
// once), ~40 us at 3.35 TB/s, and 4 * D flops per visible (query, key)
// pair, ~34 GFLOP, ~35 us at 989 TFLOP/s.  At GPT-2 XL's [8, 1024, 25, 64]
// the bytes bound it (106 MB, ~32 us).  Longer sequences are
// operation-bound (flops grow as T^2, bytes as T), so the design keeps
// the tensor cores fed and every intermediate out of device memory.
//
// Design.  The K/V tiles are walked by a loop inside the block (the TPU's
// sequential grid axis); with causal the loop stops at the diagonal, so
// tiles above it are never loaded.  Only the tile straddling the diagonal
// (or the ragged end of the sequence) is masked.  The TPU kernels' 128-lane
// head packing, their DMA index clamps and the head-major wrapper's
// transposes are TPU matters: the kernel reads [B, T, H, D] by strides.
//
// bf16 (Hopper: TMA, mbarriers, wgmma; helpers in hopper.cuh).  A work
// item is (batch * head, query tile).  The kernel is persistent: one
// block per SM walks its share of the items, two at a time, in the order
// of work_head_tile_pairs (a causal head's tiles k and n-1-k together,
// the same work for every k; a head's pairs on neighbouring blocks, which
// share its K/V tiles in L2).  Warpgroups, each 128 threads:
//  * a producer warpgroup gives up its registers (setmaxnreg 24); one of
//    its threads loads each item's Q tile into one of two buffers (the
//    next item's Q lands while this one runs) and streams 128-key K and V
//    tiles through a ring of shared-memory stages by TMA.  K and V each
//    have a "full" mbarrier (TMA bytes landed) and an "empty" one (both
//    consumers done with it) per stage, as does each Q buffer;
//  * two consumer warpgroups (setmaxnreg 240) own 64 query rows each.
//    S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//    K-major.  The online softmax runs on the S accumulator in f32 (exp2
//    of the scores with scale * log2(e) folded into its argument; the LSE
//    is converted back to natural log): the four threads of a row meet by
//    shuffles.  P is rounded to bf16 (the TPU kernels' p.astype(v.dtype))
//    into wgmma A fragments, which have the mma.sync layout, and O += P V
//    is wgmma with A from registers and V read MN-major from the stage.
// The consumers take turns (two named barriers): in its turn a consumer
// issues the previous tile's P V and this tile's S together, then waits
// for both, so one consumer's softmax runs while the other's products do
// and the tensor cores see the products of the two in alternation.  No
// register of a product in flight is read or written before its wait
// (ptxas serialises every wgmma otherwise: C7514).  K is released after
// its S, V after its P V.  TMA zero-fills rows past T (per batch:
// the maps are 4-D over (D, H, T, B)), so the ragged end needs no bounds
// checks; keys past tk still score 0, so they are masked.  Tiles are
// swizzled (128 bytes; 64 at D = 32) and a D = 128 row is two 64-column
// boxes.  The epilogue writes O / l into a staging tile of its own and
// stores it by TMA (positions past tq are not written) while the next
// item starts.  Shared memory at D = 128: 2 x Q 32 KB + 2 stages x (K 32
// KB + V 32 KB) + O 32 KB; at D = 64: 2 x Q 16 KB + 4 x 32 KB + O 16 KB.
//
// f32: a plain FMA kernel (no tensor cores, so no TF32 rounding): four
// warps, each owning 4 query rows; lane j scores key j of a 32-key tile,
// the softmax statistics are warp reductions, and lane j owns output
// columns j, j + 32, ...  It exists for the tight comparison with the
// plain version and for f32 models; bf16 is the serving path.
//
// Head sizes: 32, 64 and 128.  Launches on the caller's stream; allocates
// nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace hp = hopper;

// ---------------------------------------------------------------- bf16 --

constexpr int kFwdBM = 128, kFwdBN = 128;  // query rows, keys per tile
constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kFwdThreads = 3 * kWg;       // consumers 0, 1; producer 2
constexpr int kTurnBar = 3;  // named barriers 3 + w: consumer w's turn

// Shared memory: two Q buffers, the stages (K, V), O's staging tile, the
// mbarriers.
template <int D>
struct FwdSmem {
  using L = hp::Swz<D>;
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr uint32_t kQBox = kFwdBM * L::kRowBytes;
  static constexpr uint32_t kKVBox = kFwdBN * L::kRowBytes;
  static constexpr uint32_t kQ = L::kBoxes * kQBox;  // one Q buffer, and O
  static constexpr uint32_t kKV = L::kBoxes * kKVBox;  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kStages0 = 2 * kQ;
  static constexpr uint32_t kO = kStages0 + kStages * kStage;
  static constexpr uint32_t kBars = kO + kQ;
  // Q full and empty per buffer; K full, V full, K empty, V empty per stage
  static constexpr int kNumBars = 4 + 4 * kStages;
  // + 1024: the base is aligned up to the swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
};

// Persistent: block c takes the work items 2u and 2u + 1 (in the order of
// work_head_tile_pairs) for u = c, c + gridDim.x, ...
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      float* __restrict__ lse, int batch, int heads, int tq,
                      int tk, float scale, int causal) {
  using L = hp::Swz<D>;
  using SM = FwdSmem<D>;
  constexpr int BM = kFwdBM, BN = kFwdBN, NS = SM::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + SM::kStages0;  // stage i: K, then V
  const uint32_t o_s = q_s + SM::kO;
  const uint32_t bars = q_s + SM::kBars;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (2 + i); };
  auto k_full = [&](int i) { return bars + 8 * (4 + i); };
  auto v_full = [&](int i) { return bars + 8 * (4 + NS + i); };
  auto k_empty = [&](int i) { return bars + 8 * (4 + 2 * NS + i); };
  auto v_empty = [&](int i) { return bars + 8 * (4 + 3 * NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg;
  const unsigned n_bh = (unsigned)batch * heads;
  const unsigned n_qt = (tq + BM - 1) / BM;
  const unsigned n_work = n_bh * n_qt;
  // this block's items: lin = 2u, 2u + 1 for u = blockIdx.x + j gridDim.x
  auto item = [&](unsigned k) {
    return 2 * (blockIdx.x + (k / 2) * gridDim.x) + (k & 1);
  };
  auto work = [&](unsigned lin) {  // producer and consumers agree on both
    return work_head_tile_pairs(lin, n_bh, n_qt);
  };
  auto key_tiles_of = [&](int m0) {  // the loop stops at the diagonal
    return key_tiles(m0, BM, BN, tq, tk, causal);
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hp::mbar_init(q_full(i), 1);
      hp::mbar_init(q_empty(i), 2 * kWg);
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

  if (wg == 2) {  // producer
    hp::regs_dec<24>();
    if (tid != 2 * kWg) return;
    unsigned kv_it = 0;  // K/V tiles streamed, over all items
    for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
      const Work w = work(lin);
      const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
      // Q into buffer k & 1 once item k - 2's scores are done with it
      const int qb = k & 1;
      hp::mbar_wait(q_empty(qb), ((k >> 1) & 1) ^ 1);
      hp::mbar_arrive_tx(q_full(qb), SM::kQ);
      for (int half = 0; half < 2; ++half)
        for (int bx = 0; bx < L::kBoxes; ++bx)
          hp::tma_load(q_s + qb * SM::kQ + bx * SM::kQBox +
                           half * 64 * L::kRowBytes,
                       &qmap, q_full(qb), bx * L::kCols, h, m0 + half * 64, b);
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
    return;
  }

  // consumer warpgroup wg: query rows m0 + wg * 64 ... of each item
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const float sl2 = scale * 1.4426950408889634f;  // log2 units, scale > 0
  const uint32_t oa = o_s + wg * 64 * L::kRowBytes;
  // Turns: a consumer issues all its products of a turn (the previous
  // tile's P V and this tile's S) between a wait on its own named barrier
  // and an arrival on the other's, so the two alternate and one's softmax
  // runs while the other's products do.  Consumer 0 takes the first turn,
  // and both take one turn per key tile plus one per item.
  if (wg == 1) hp::named_arrive(kTurnBar, 2 * kWg);
  unsigned kv0 = 0;  // K/V tiles of the earlier items
  for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
    const Work w = work(lin);
    const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
    const int n_tiles = key_tiles_of(m0);
    const int first_row = m0 + wg * 64;
    const int row[2] = {first_row + warp * 16 + g,
                        first_row + warp * 16 + g + 8};
    const uint32_t qa = q_s + (k & 1) * SM::kQ + wg * 64 * L::kRowBytes;

    float o[L::kBoxes][L::kCols / 2];
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
      for (int e = 0; e < L::kCols / 2; ++e) o[bx][e] = 0.f;
    // the running max in raw score units; this thread's share of the sum
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    // S: element 4j + e is (row[e >> 1], key n0 + 8j + 2t + (e & 1)).  P:
    // the S accumulators of 8-key groups 2kk and 2kk+1, rounded to bf16,
    // are the wgmma A fragment of key slice kk.
    float s[64];
    uint32_t pa[BN / 16][4];

    // One turn: P V of tile it - 1 (with V MN-major) and S = Q K^T of
    // tile it (both K-major), as the flags say; then wait for both and
    // release what they read.
    auto turn = [&](int it, auto with_pv, auto with_s) {
      constexpr bool kPV = decltype(with_pv)::value;
      constexpr bool kS = decltype(with_s)::value;
      const unsigned cur = kv0 + it, prev = cur - 1;
      const uint32_t ks = kv_s + (cur % NS) * SM::kStage;
      const uint32_t vs = kv_s + (prev % NS) * SM::kStage + SM::kKV;
      if constexpr (kS) hp::mbar_wait(k_full(cur % NS), (cur / NS) & 1);
      if constexpr (kPV) hp::mbar_wait(v_full(prev % NS), (prev / NS) & 1);
      hp::named_sync(kTurnBar + wg, 2 * kWg);
      hp::wgmma_fence();
      if constexpr (kPV) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx)
            hp::mma_rs_box<D>(
                o[bx], pa[kk],
                hp::desc_mn<D>(vs + bx * SM::kKVBox + kk * 16 * L::kRowBytes,
                               SM::kKVBox));
      }
      if constexpr (kS) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
          hp::mma_ss_n128(s, hp::desc_k<D>(qa + bx * SM::kQBox + kb),
                          hp::desc_k<D>(ks + bx * SM::kKVBox + kb), kk > 0);
        }
      }
      hp::wgmma_commit();
      hp::named_arrive(kTurnBar + (wg ^ 1), 2 * kWg);
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hp::fence_regs(pa[kk]);
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) hp::fence_regs(o[bx]);
      if constexpr (kPV) hp::mbar_arrive(v_empty(prev % NS));
      if constexpr (kS) {
        hp::mbar_arrive(k_empty(cur % NS));
        if (it == n_tiles - 1) hp::mbar_arrive(q_empty(k & 1));  // Q done
      }
    };

    // The online softmax of tile it's scores, in f32: the running max
    // and sum, O rescaled (its P V is done), P into pa.  The scale is
    // folded into exp2's argument: p = 2^(s sl2 - m sl2).
    auto softmax = [&](int it) {
      const int n0 = it * BN;
      const bool masked =
          n0 + BN > tk || (causal && n0 + BN - 1 > first_row);
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked) {
            const int kpos = n0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= tk || (causal && kpos > row[e >> 1]))
              s[4 * j + e] = kNegInf;
          }
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the four threads t = 0..3 hold one row between them
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float m_new = fmaxf(m_run[i], tmax[i]);
        const float ms = m_new <= kNegInf / 2 ? 0.f : m_new * sl2;
        const float corr = m_run[i] <= kNegInf / 2
                               ? 0.f
                               : hp::exp2(fmaf(m_run[i], sl2, -ms));
        m_run[i] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // a masked score gives exp2(-1e30 sl2 - ms), exactly 0
            const float pv = hp::exp2(fmaf(s[4 * j + 2 * i + c], sl2, -ms));
            s[4 * j + 2 * i + c] = pv;
            psum += pv;
          }
        l_run[i] = l_run[i] * corr + psum;
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
          for (int c = 0; c < L::kCols / 8; ++c) {
            o[bx][4 * c + 2 * i] *= corr;
            o[bx][4 * c + 2 * i + 1] *= corr;
          }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_f32(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    hp::mbar_wait(q_full(k & 1), (k >> 1) & 1);
    turn(0, std::false_type{}, std::true_type{});
    softmax(0);
    for (int it = 1; it < n_tiles; ++it) {
      turn(it, std::true_type{}, std::true_type{});
      softmax(it);
    }
    turn(n_tiles, std::true_type{}, std::false_type{});
    kv0 += n_tiles;

    // O / l into this warpgroup's rows of the staging tile, once the
    // previous item's store has read it, then out by TMA while the next
    // item runs.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = l == 0.f ? 1.f : l;
      inv[i] = 1.f / l_safe;
      if (t == 0 && row[i] < tq)
        lse[((size_t)b * heads + h) * tq + row[i]] =
            m_run[i] <= kNegInf / 2
                ? kNegInf
                : fmaf(m_run[i], sl2, log2f(l_safe)) * 0.6931471805599453f;
    }
    if (tid % kWg == 0) hp::tma_wait_read();
    hp::named_sync(1 + wg, kWg);
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
      for (int c = 0; c < L::kCols / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::st_shared(oa + bx * SM::kQBox +
                            hp::swizzled<D>(warp * 16 + g + 8 * i,
                                            8 * c + 2 * t),
                        pack_f32(o[bx][4 * c + 2 * i] * inv[i],
                                 o[bx][4 * c + 2 * i + 1] * inv[i]));
    hp::fence_proxy_async();
    hp::named_sync(1 + wg, kWg);
    if (tid % kWg == 0) {
      for (int bx = 0; bx < L::kBoxes; ++bx)
        hp::tma_store(&omap, oa + bx * SM::kQBox, bx * L::kCols, h,
                      first_row, b);
      hp::tma_commit();
    }
  }
  // consumer 1's arrival after its last turn
  if (wg == 0) hp::named_sync(kTurnBar, 2 * kWg);
  if (tid % kWg == 0) hp::tma_wait_read();
}

// ----------------------------------------------------------------- f32 --

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int tq, int tk,
                     float scale, int causal) {
  constexpr int RPW = 4, BM = RPW * kThreads / 32, BN = 32, DPL = D / 32;
  __shared__ float qs[BM][D];
  __shared__ float ks[BN][D + 1];  // padded: lane j reads row j conflict-free
  __shared__ float vs[BN][D];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * BM;
  const size_t rs = (size_t)heads * D;
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const float* qb = q + qoff;
  const float* kb = k + slice_base<D>(b, h, heads, tk);
  const float* vb = v + slice_base<D>(b, h, heads, tk);

  for (int c = tid; c < BM * D; c += kThreads) {
    const int r = c / D, d = c % D;
    qs[r][d] = m0 + r < tq ? qb[(m0 + r) * rs + d] : 0.f;
  }

  float m_run[RPW], l_run[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();
    for (int c = tid; c < BN * D; c += kThreads) {
      const int r = c / D, d = c % D;
      const bool ok = n0 + r < tk;
      ks[r][d] = ok ? kb[(n0 + r) * rs + d] : 0.f;
      vs[r][d] = ok ? vb[(n0 + r) * rs + d] : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qs[warp * RPW + r][d], kd, s[r]);
    }

    const int kpos = n0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = m0 + warp * RPW + r;
      float x = s[r] * scale;
      if (kpos >= tk || (causal && kpos > qpos)) x = kNegInf;
      float tmax = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[r], tmax);
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr =
          m_run[r] <= kNegInf / 2 ? 0.f : expf(m_run[r] - safe);
      const float p = expf(x - safe);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[r] = l_run[r] * corr + psum;
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      s[r] = p;
    }

    for (int j = 0; j < BN; ++j) {
      float vj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vj[i] = vs[j][lane + 32 * i];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = m0 + warp * RPW + r;
    if (qpos >= tq) continue;
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
    float* orow = o + qoff + qpos * rs;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[r][i] / l_safe;
    if (lane == 0)
      lse[((size_t)b * heads + h) * tq + qpos] =
          m_run[r] <= kNegInf / 2 ? kNegInf : m_run[r] + logf(l_safe);
  }
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int batch, int tq, int tk, int heads, int head_dim, float scale,
        int causal, int dtype, void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(flash_fwd_f32_kernel<D>,
                    dim3(batch * heads, (tq + 15) / 16), 0, s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), l,
                    heads, tq, tk, scale, causal);
    CUtensorMap qm, km, vm, om;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, 64) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, kFwdBN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, kFwdBN) ||
        !hp::encode_map<D>(&om, o, batch, tq, heads, 64))
      return cudaErrorInvalidValue;
    int blocks = 0;
    const cudaError_t e = persistent_blocks(
        (long)batch * heads * ((tq + kFwdBM - 1) / kFwdBM), &blocks);
    if (e != cudaSuccess) return e;
    return launch_block(flash_fwd_bf16_kernel<D>, dim3(blocks),
                        kFwdThreads, FwdSmem<D>::kBytes, s, qm, km, vm, om, l,
                        batch, heads, tq, tk, scale, causal);
  });
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D] contiguous, o like q, lse [B, H, Tq]
// f32; head_dim 32, 64 or 128.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int tq, int tk,
                             int heads, int head_dim, float scale, int causal,
                             int dtype, void* stream) {
  return fwd(q, k, v, o, lse, batch, tq, tk, heads, head_dim, scale, causal,
             dtype, stream);
}

// The bf16 kernel at head_dim as the runtime holds it (func_attrs: out[0]
// registers, out[1] static and out[2] dynamic shared bytes, the latter
// as its last launch set them).  Returns a cudaError_t.
extern "C" int rtt_flash_fwd_attrs(int head_dim, int* out) {
  return (int)by_head_dim(head_dim, [&](auto d) {
    return func_attrs(flash_fwd_bf16_kernel<decltype(d)::value>, out);
  });
}
