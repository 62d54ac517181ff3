// Flash-attention dK/dV and dQ for Hopper (sm_90a) at head_dim 257 to
// 1024, bf16 inputs, over [B, T, H, D].
//
// Replaces, for head_dim 257-1024 and bf16 inputs: ray_tpu/ops/
// flash_attention.py::_fa_bwd_dkdv_kernel (dK, dV) and ::_fa_bwd_dq_kernel
// (dQ), both launched by _flash_backward, whose blocks span any head_dim.
// They compute what flash_bwd.cu and flash_wide.cu compute, under the same
// contract: the causal mask aligned top-left, f32 LSE and delta (the LSE
// clamped to 0 for a row that saw no key), P rounded to bf16 before dV, dS
// before dK and dQ, Tq and Tk free when not causal; outputs in bf16 or, the
// chunk mode of ring attention (F32O), in f32 from bf16 inputs.  f32
// inputs above 128 stay on flash_generic.cu.
//
// Bound: at [8, 1024, 16, 512] causal dK/dV does 8 * D flops per visible
// (query, key) pair (275 GFLOP, 278 us at 989 TFLOP/s) against 805 MB (240
// us at 3.35 TB/s), dQ 6 * D (206 GFLOP, 209 us) against 671 MB (200 us);
// at 1024 twice that.  The two bounds meet, so, as flash_wide.cu does at
// 256, the design keeps the tensor cores fed and every [T, T]
// intermediate out of device memory.
//
// Why not flash_wide.cu widened: its dK/dV holds 64 keys' dK and dV in
// registers (64 + 64 f32 a consumer thread at 256); at 512 that tile is 64
// x 512 x 2 f32 = 256 KB, the whole register file of an SM.  So the
// outputs' columns are split across blocks: the head_dim is cut into G
// column groups of GC columns (GC = 192 and G = 2 on the 384 build, GC =
// 256 and G = 2, 3 or 4 on the 512, 768 and 1024 builds), one block a
// group, and the G blocks of one key tile (dK/dV) or query tile (dQ) form a
// thread block cluster.  Each block holds only its group's columns of K,
// V, Q and dO, computes the partial S and dP over them, and adds all the
// groups' partials through distributed shared memory in rank order, so
// that every block holds the same S and dP to the bit (the same products
// added in the same order); each owns its group's columns of dK and dV (or
// dQ).  The flops are the work's own, 8 D a pair for dK/dV and 6 D for dQ
// (the alternative, every group recomputing S over the whole head_dim,
// would need K, V, Q and dO at full width in every block: at 512 that is
// 128 KB of K/V plus 128 KB a 64-query Q/dO stage, which does not fit).
// One width: the widest group a block holds (flash_wide.cu's 256 budget).
// Narrower groups would add blocks, but the exchange reads G partials a
// tile, its bytes a flop growing as D / GC^2, and at the timed shapes the
// 256-wide launch already spans one to several waves of the clusters the
// card holds at once (rtt_flash_xwide_bwd_attrs reports both).
//
// dK/dV (xbwd_dkdv_kernel): a block owns 64 keys of one (batch, head) and
// one column group; a producer warpgroup (setmaxnreg 24) loads K_g and V_g
// once and streams 32-query tiles of Q_g and dO_g by TMA through 3 stages,
// the tile's LSE (log2 units) and delta written beside them by its first
// warp.  Per tile, the two consumer warpgroups (setmaxnreg 240):
//  1. consumer 0 computes the partial S^T = K_g Q_g^T, consumer 1 the
//     partial dP^T = V_g dO_g^T (64 keys x 32 queries, m64n32k16, both
//     operands K-major), each into its own half of this block's exchange
//     buffer;
//  2. after every block's partials are in, consumer w adds, for its 16
//     queries, the G blocks' S^T and dP^T in rank order, forms P^T and dS^T
//     and writes P~^T and dS~^T (bf16, keys as rows, 64-byte swizzle) into
//     one of two shared buffers; the consumers meet on a named barrier;
//  3. dV_g += P~^T dO_g and dK_g += dS~^T Q_g, each consumer owning half of
//     the group's boxes (m64n128k16 at GC = 256; at 192 consumer 0 two
//     boxes, 1 one): a thread holds 64 + 64 accumulators at 256.
// The steps overlap across tiles: a consumer posts tile i's partial,
// then finishes tile i - 1 (steps 2-3) and issues tile i + 1's partial
// while the peers' partials of tile i arrive.  dQ (xbwd_dq_kernel) mirrors
// it: a block owns 64 queries and one group; Q_g and dO_g are loaded once
// and 32-key tiles of K_g and V_g streamed; consumer 0 computes the partial
// S = Q_g K_g^T, consumer 1 dP = dO_g V_g^T; consumer w adds them for its
// 16 keys, forms P = 2^(S scale log2 e - LSE log2 e) and dS = P (dP -
// delta) scale elementwise (each thread holding its two rows' LSE and
// delta) and writes dS~ (queries as rows); then dQ_g += dS~ K_g over each
// consumer's half of the boxes.
//
// The exchange.  Each block has two exchange buffers (by tile parity; 16
// KB each: [S or dP][4 float4][128 threads], each consumer thread writing
// and reading its own accumulator fragment, so no access conflicts), read
// by the peers through distributed shared memory (mapa).  The signal is
// the cluster barrier, split: a consumer thread arrives (release) when it
// has written its partial, and waits (acquire) just before it reads the
// peers'.  Every thread of the cluster takes every phase, the TMA producer
// warpgroup too: it takes tile i's phase before it loads tile i + 2, the
// load that reuses tile i - 1's stage, which the consumers free only after
// that phase, so the phase holds no load back.  One phase a tile also
// frees the buffers: a thread arrives on tile i + 1's phase only after it
// read tile i - 1's partials, so tile i + 1's writes find the buffer read.
// A last phase keeps every block until its peers are done with it.  An
// mbarrier exchange (one remote arrival a consumer warpgroup and block on
// a full and an empty barrier a buffer, with release and acquire at
// cluster scope) took 1.3-1.7x the cluster barrier's time on an H100
// (PERF.md, PR 13).  What holds the design back is the exchange itself
// (every block reads G partials a tile across the cluster, and waits on
// the slowest peer) more than the tensor cores.
//
// Shared memory at GC = 256: dK/dV: K_g 32 + V_g 32 + 3 stages x (Q_g 16 +
// dO_g 16) + 2 x (P~^T 4 + dS~^T 4) + 2 x 16 exchange KB + the stats =
// 214,840 bytes of 232,448; dQ: Q_g 32 + dO_g 32 + 3 x (K_g 16 + V_g 16) +
// 2 x dS~ 4 + 2 x 16 KB = 205,880.  With 64-row tiles the exchange alone
// would be 64 KB double-buffered, which leaves no room for a second stage.
//
// Order: the clusters of a head lie together, its longest causal blocks
// first (dK/dV: key tile 0 first; dQ: the last query tile first).  After
// the last tile K_g and V_g (dK/dV) or Q_g (dQ) are free: the outputs are
// written over them in bf16 and stored by TMA (rows past the sequence
// clipped), or, with F32O, stored from the registers as float2 pairs.  A
// head_dim that is a multiple of 8 from 264 to 1024 runs on the next
// build; boxes wholly past head_dim are zeroed once in shared memory and
// never loaded or stored, a box partly past it is zero-filled by TMA.
//
// Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace hp = hopper;

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kXbThreads = 3 * kWg;      // consumers 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;   // keys (dK/dV) or queries (dQ) a block
constexpr int kTile = 32;   // queries (dK/dV) or keys (dQ) a streamed tile
// at least 3: a consumer issues tile i + 1's partial before it frees tile
// i - 1's stage
constexpr int kStages = 3;
static_assert(kStages >= 3, "the next tile's partial needs a third stage");
constexpr int kPBar = 1;    // named barrier: both consumers' halves written
// named barriers 2 + w: consumer w's warpgroup
constexpr int kBoxBytes = 64 * 2;  // a 64-column box row: 128 bytes
constexpr int kMaxGroups = 4;      // G of the 1024 build

template <int GC>
using GroupCols = std::integral_constant<int, GC>;

// The builds: fn(GroupCols<GC>{}, G) for the group width and count of the
// smallest build (384, 512, 768, 1024) at or above head_dim, a multiple of
// 8 from 264 to 1024; any other size is cudaErrorInvalidValue.
template <typename Fn>
cudaError_t by_xbwd_head_dim(int head_dim, Fn&& fn) {
  if (head_dim <= 256 || head_dim > 1024 || head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  if (head_dim <= 384) return fn(GroupCols<192>{}, 2);
  if (head_dim <= 512) return fn(GroupCols<256>{}, 2);
  if (head_dim <= 768) return fn(GroupCols<256>{}, 3);
  return fn(GroupCols<256>{}, 4);
}

// What the two kernels share: a block's resident operands (64 rows x the
// group's boxes, twice), the stages (two 32-row tiles each), the P~^T /
// dS~^T (or dS~) buffers and the exchange buffers.
template <int GC>
struct XbSmem {
  static constexpr int kGBoxes = GC / 64;
  static constexpr int kBoxes0 = (kGBoxes + 1) / 2;  // consumer 0's
  static constexpr uint32_t kRBox = kRows * kBoxBytes;   // a resident box
  static constexpr uint32_t kTBox = kTile * kBoxBytes;   // a tile's box
  static constexpr uint32_t kR = kGBoxes * kRBox;  // one resident operand
  static constexpr uint32_t kT = kGBoxes * kTBox;  // one streamed operand
  static constexpr uint32_t kStage = 2 * kT;
  static constexpr uint32_t kP = kRows * kTile * 2;  // a bf16 64 x 32 tile
  static constexpr uint32_t kX = 2 * 4 * kWg * 16;   // one exchange buffer
  static constexpr uint32_t kStagesAt = 2 * kR;
  static constexpr uint32_t kPs = kStagesAt + kStages * kStage;
};

// dK/dV: + 2 x (P~^T, dS~^T), 2 exchange buffers, the stages' LSE and
// delta, the mbarriers (K/V full; full, empty a stage).
template <int GC>
struct XbDkdvSmem : XbSmem<GC> {
  using B = XbSmem<GC>;
  static constexpr uint32_t kXs = B::kPs + 4 * B::kP;
  static constexpr uint32_t kStats = kXs + 2 * B::kX;
  static constexpr uint32_t kStatBytes = 2 * kTile * 4;  // LSE, delta
  static constexpr uint32_t kBars = kStats + kStages * kStatBytes;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

// dQ: + 2 dS~ buffers, 2 exchange buffers, the mbarriers (Q/dO full; full,
// empty a stage).
template <int GC>
struct XbDqSmem : XbSmem<GC> {
  using B = XbSmem<GC>;
  static constexpr uint32_t kXs = B::kPs + 2 * B::kP;
  static constexpr uint32_t kBars = kXs + 2 * B::kX;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

// The exchange of one tile, for the consumer thread `tl` of warpgroup `wg`
// (0: S or S^T, 1: dP or dP^T), through buffer x (this block's, of the
// tile's parity) and the cluster barrier's phase of the tile.
struct Exchange {
  uint32_t x;
  int groups, wg, tl;

  // `part`, the m64n32 accumulator of this consumer's partial over the
  // group's columns, into the buffer; then this thread's arrival.  The
  // buffer is free: every thread of the cluster arrived on the last
  // tile's phase after it had read this buffer's previous use.
  __device__ __forceinline__ void post(const float (&part)[16]) const {
#pragma unroll
    for (int qd = 0; qd < 4; ++qd)
      hp::st_shared_f4(x + ((wg * 4 + qd) * kWg + tl) * 16, part[4 * qd],
                       part[4 * qd + 1], part[4 * qd + 2], part[4 * qd + 3]);
    hp::cluster_arrive();
  }

  // Once every block posted: in s and dp the sums over the cluster's G
  // blocks, in rank order, of the elements 4j + e, j = 2 wg, 2 wg + 1 (the
  // 16 columns of the tile this consumer finishes).
  __device__ __forceinline__ void gather(float (&s)[8],
                                         float (&dp)[8]) const {
    hp::cluster_wait();
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxGroups; ++r) {
      if (r >= groups) break;
      const uint32_t src = hp::mapa(x, r);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int qd = 2 * wg + jj;
        const float4 a = hp::ld_cluster_f4(src + (qd * kWg + tl) * 16);
        const float4 c = hp::ld_cluster_f4(src + ((4 + qd) * kWg + tl) * 16);
        s[4 * jj] += a.x;
        s[4 * jj + 1] += a.y;
        s[4 * jj + 2] += a.z;
        s[4 * jj + 3] += a.w;
        dp[4 * jj] += c.x;
        dp[4 * jj + 1] += c.y;
        dp[4 * jj + 2] += c.z;
        dp[4 * jj + 3] += c.w;
      }
    }
  }
};

// The producer warpgroup's share of the cluster barrier: every thread of
// the cluster takes every phase, one a tile and a last one before exit.
// The producer takes tile i's phase before it loads tile i + kStages - 1
// (the stage it reuses is freed only after the consumers passed that
// phase) and the phases its loop left after it, so it never holds back a
// load it could issue.
__device__ __forceinline__ void producer_phase(int it) {
  if (it >= kStages - 1) hp::cluster_sync();
}
__device__ __forceinline__ void producer_last_phases(int n) {
  for (int k = max(n - (kStages - 1), 0); k <= n; ++k) hp::cluster_sync();
}

// A block's mbarriers and zeroed boxes: thread 0 initialises the
// mbarriers; every thread zeroes the boxes [nb, kGBoxes) of the resident
// operands (at r0, two) and of every stage's two tiles; then a cluster
// barrier phase, which every block of the cluster has started once it
// passes (distributed shared memory may be read after it).
template <int GC, typename Init>
__device__ __forceinline__ void start_cluster(uint32_t r0, uint32_t stages,
                                              int nb, Init&& init) {
  using SM = XbSmem<GC>;
  const int tid = threadIdx.x;
  if (tid == 0) {
    init();
    hp::fence_barrier_init();
  }
  if (nb < SM::kGBoxes) {
    for (int op = 0; op < 2; ++op)
      for (uint32_t a = nb * SM::kRBox + 4 * tid; a < SM::kR;
           a += 4 * kXbThreads)
        hp::st_shared(r0 + op * SM::kR + a, 0u);
    for (int op = 0; op < 2 * kStages; ++op)
      for (uint32_t a = nb * SM::kTBox + 4 * tid; a < SM::kT;
           a += 4 * kXbThreads)
        hp::st_shared(stages + op * SM::kT + a, 0u);
    hp::fence_proxy_async();
  }
  hp::cluster_sync();
}

// Issue, as one wgmma group, the partial m64n32 product over the group's
// columns: A (64 rows, a resident operand at a_s) times B^T (32 rows, a
// stage's tile at b_s), both K-major.
template <int GC>
__device__ __forceinline__ void partial_product(float (&part)[16],
                                                uint32_t a_s, uint32_t b_s) {
  using SM = XbSmem<GC>;
  using L = hp::Swz<GC>;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < GC / 16; ++kk) {
    const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
    hp::mma_ss<32>(part, hp::desc_k<GC>(a_s + bx * SM::kRBox + kb),
                   hp::desc_k<GC>(b_s + bx * SM::kTBox + kb), kk > 0);
  }
  hp::wgmma_commit();
  hp::fence_regs(part);
}

// ------------------------------------------------------------- dK/dV --

// F32O: dK and dV in f32 through dk32 and dv32 (dkmap, dvmap unused).
template <int GC, bool F32O>
__global__ void __launch_bounds__(kXbThreads, 1)
xbwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dkmap,
                 const __grid_constant__ CUtensorMap dvmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk32,
                 float* __restrict__ dv32, int heads, int dim, int tq,
                 int tk, float scale, int causal, int groups) {
  using SM = XbDkdvSmem<GC>;
  constexpr int BN = kRows, BM = kTile, NS = kStages, GB = SM::kGBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + SM::kR;
  const uint32_t stage_s = k_s + SM::kStagesAt;  // stage i: Q_g, then dO_g
  const uint32_t p_s = k_s + SM::kPs;  // buffer i: P~^T, then dS~^T
  const uint32_t x_s = k_s + SM::kXs;  // exchange buffer i
  const uint32_t stats_s = k_s + SM::kStats;
  const uint32_t kv_full = k_s + SM::kBars;
  auto full = [&](int i) { return kv_full + 8 * (1 + i); };
  auto empty = [&](int i) { return kv_full + 8 * (1 + NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg, lane = tid % 32;
  // the cluster is the key tile's groups: blockIdx.x % groups is both the
  // group and the rank
  const GroupWork w = work_group_tiles_adjacent(groups);
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * BN;  // key tile 0, the longest, first
  const int m_begin = causal ? n0 / BM : 0;
  const int m_end = (tq + BM - 1) / BM;
  const int c0 = w.group * GB;  // the group's first box of the head
  const int nb = min(max((dim + 63) / 64 - c0, 0), GB);  // boxes with data

  const int n_tiles = m_end - m_begin;

  start_cluster<GC>(k_s, stage_s, nb, [&] {
    hp::mbar_init(kv_full, 1);
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(full(i), 32);  // the producer's warp
      hp::mbar_init(empty(i), 2 * kWg);
    }
  });

  if (wg == 2) {  // producer: its first warp loads, all take the phases
    hp::regs_dec<24>();
    const bool loader = tid < 2 * kWg + 32;
    if (tid == 2 * kWg) {
      hp::mbar_arrive_tx(kv_full, 2 * nb * SM::kRBox);
      for (int bx = 0; bx < nb; ++bx) {
        hp::tma_load(k_s + bx * SM::kRBox, &kmap, kv_full, (c0 + bx) * 64, h,
                     n0, b);
        hp::tma_load(v_s + bx * SM::kRBox, &vmap, kv_full, (c0 + bx) * 64, h,
                     n0, b);
      }
    }
    const float* lse_b = lse + ((size_t)b * heads + h) * tq;
    const float* delta_b = delta + ((size_t)b * heads + h) * tq;
    for (int mt = m_begin; mt < m_end; ++mt) {
      const int it = mt - m_begin, st = it % NS, m0 = mt * BM;
      producer_phase(it);
      if (!loader) continue;
      hp::mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
      const uint32_t stats = stats_s + st * SM::kStatBytes;
      {
        const int r = lane;  // BM = 32 rows: one a lane
        const bool ok = m0 + r < tq;
        const float l = ok ? lse_b[m0 + r] : 0.f;
        hp::st_shared(stats + 4 * r,
                      __float_as_uint(l <= kNegInf / 2 ? 0.f : l * kLog2e));
        hp::st_shared(stats + 4 * (BM + r),
                      __float_as_uint(ok ? delta_b[m0 + r] : 0.f));
      }
      if (lane == 0) {
        const uint32_t qs = stage_s + st * SM::kStage;
        hp::mbar_arrive_tx(full(st), 2 * nb * SM::kTBox);
        for (int bx = 0; bx < nb; ++bx) {
          hp::tma_load(qs + bx * SM::kTBox, &qmap, full(st), (c0 + bx) * 64,
                       h, m0, b);
          hp::tma_load(qs + SM::kT + bx * SM::kTBox, &domap, full(st),
                       (c0 + bx) * 64, h, m0, b);
        }
      } else {
        hp::mbar_arrive(full(st));
      }
    }
    producer_last_phases(n_tiles);
    return;
  }

  // consumer warpgroup wg: the partial S^T (0) or dP^T (1), then P^T and
  // dS^T of queries 16 wg ... 16 wg + 15 of each tile, then dK and dV
  // columns of the group's boxes [box0, box0 + NB)
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32, tl = tid % kWg;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int key[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;  // scores in log2 units

  auto consume = [&](auto n_boxes, int box0) {
    constexpr int NB = decltype(n_boxes)::value, N = NB * 64;
    // element 4c + 2i + e: (key[i], column (c0 + box0) 64 + 8c + 2t + e)
    float dka[N / 2], dva[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dka[e] = dva[e] = 0.f;

    // this consumer's partial of tile i: S^T = K_g Q_g^T or dP^T = V_g
    // dO_g^T over the stage's tile
    auto partial = [&](float(&part)[16], int i) {
      const int st = i % NS;
      const uint32_t qs = stage_s + st * SM::kStage;
      hp::mbar_wait(full(st), (i / NS) & 1);
      partial_product<GC>(part, wg == 0 ? k_s : v_s,
                          wg == 0 ? qs : qs + SM::kT);
    };
    // tile i's P^T and dS^T from the sums of its partials (sT, dpt: j = 2
    // wg + jj of the tile at 4 jj + e), into the buffers, then its dV_g +=
    // P~^T dO_g and dK_g += dS~^T Q_g over this consumer's boxes (A the
    // buffer, K-major; B the stage's dO_g and Q_g, MN-major), issued
    float sT[8], dpt[8];
    auto finish = [&](int i) {
      const int st = i % NS, m0 = (m_begin + i) * BM;
      const uint32_t qs = stage_s + st * SM::kStage, dos = qs + SM::kT;
      const uint32_t stats = stats_s + st * SM::kStatBytes;
      const uint32_t pt = p_s + (i & 1) * 2 * SM::kP, dst = pt + SM::kP;
      const bool masked = m0 + BM > tq || (causal && n0 + BN - 1 > m0);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * wg + jj;
        const float2 l2 = hp::ld_shared_f2(stats + 4 * (8 * j + 2 * t));
        const float2 d2 = hp::ld_shared_f2(stats + 4 * (BM + 8 * j + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = hp::exp2(fmaf(sT[4 * jj + e], sl2, -((e & 1) ? l2.y
                                                                  : l2.x)));
          if (masked) {
            const int qpos = m0 + 8 * j + 2 * t + (e & 1);
            if (qpos >= tq || (causal && key[e >> 1] > qpos)) pv = 0.f;
          }
          sT[4 * jj + e] = pv;
          dpt[4 * jj + e] =
              pv * (dpt[4 * jj + e] - ((e & 1) ? d2.y : d2.x)) * scale;
        }
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const uint32_t off =
              hp::swizzled<32>(warp * 16 + g + 8 * i2, 8 * j + 2 * t);
          hp::st_shared(pt + off, pack_f32(sT[4 * jj + 2 * i2],
                                           sT[4 * jj + 2 * i2 + 1]));
          hp::st_shared(dst + off, pack_f32(dpt[4 * jj + 2 * i2],
                                            dpt[4 * jj + 2 * i2 + 1]));
        }
      }
      hp::fence_proxy_async();
      hp::named_sync(kPBar, 2 * kWg);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t off = box0 * SM::kTBox + kk * 16 * kBoxBytes;
        hp::mma_ss<N, 1>(dva, hp::desc_k<32>(pt + kk * 32),
                         hp::desc_mn<GC>(dos + off, SM::kTBox), 1);
        hp::mma_ss<N, 1>(dka, hp::desc_k<32>(dst + kk * 32),
                         hp::desc_mn<GC>(qs + off, SM::kTBox), 1);
      }
      hp::wgmma_commit();
      hp::fence_regs(dka);
      hp::fence_regs(dva);
    };
    // element 4j + e of part: (key[e >> 1], query m0 + 8j + 2t + (e & 1))
    float part[16];
    hp::mbar_wait(kv_full, 0);
    partial(part, 0);
    hp::wgmma_wait<0>();
    hp::fence_regs(part);
    // Step it: post tile it's partial; finish tile it - 1 and issue tile
    // it + 1's partial while the peers' partials of tile it arrive; gather
    // them; wait for the products, which frees tile it - 1's stage.  The
    // stage tile it + 1 loads into was tile it - 2's, freed a step before.
    for (int it = 0; it <= n_tiles; ++it) {
      const Exchange x{x_s + (it & 1) * SM::kX, groups, wg, tl};
      if (it < n_tiles) x.post(part);
      if (it > 0) finish(it - 1);
      float next[16];  // a fresh array: part's registers are free after post
      if (it + 1 < n_tiles) partial(next, it + 1);
      if (it < n_tiles) x.gather(sT, dpt);
      hp::wgmma_wait<0>();
      hp::fence_regs(next);
      hp::fence_regs(dka);
      hp::fence_regs(dva);
      if (it > 0) hp::mbar_arrive(empty((it - 1) % NS));
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = next[e];
    }

    if constexpr (F32O) {
      const size_t rs = (size_t)heads * dim;
      const size_t base = slice_base(b, h, heads, tk, dim);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (key[i] >= tk) continue;
        const size_t at = base + (size_t)key[i] * rs;
#pragma unroll
        for (int c = 0; c < N / 8; ++c) {
          const int col = (c0 + box0) * 64 + 8 * c + 2 * t;
          if (col >= dim) continue;  // dim is a multiple of 8
          *reinterpret_cast<float2*>(dk32 + at + col) =
              make_float2(dka[4 * c + 2 * i], dka[4 * c + 2 * i + 1]);
          *reinterpret_cast<float2*>(dv32 + at + col) =
              make_float2(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]);
        }
      }
    } else {
      // dK_g and dV_g in bf16 over this consumer's boxes of K_g and V_g
      // (both consumers passed the last tile's barrier, after which
      // neither reads K_g or V_g), then by TMA
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t off =
              (box0 + c / 8) * SM::kRBox +
              hp::swizzled<GC>(warp * 16 + g + 8 * i, 8 * (c % 8) + 2 * t);
          hp::st_shared(k_s + off, pack_f32(dka[4 * c + 2 * i],
                                            dka[4 * c + 2 * i + 1]));
          hp::st_shared(v_s + off, pack_f32(dva[4 * c + 2 * i],
                                            dva[4 * c + 2 * i + 1]));
        }
      hp::fence_proxy_async();
      hp::named_sync(2 + wg, kWg);
      if (tl == 0) {
        for (int bx = box0; bx < box0 + NB && bx < nb; ++bx) {
          hp::tma_store(&dkmap, k_s + bx * SM::kRBox, (c0 + bx) * 64, h, n0,
                        b);
          hp::tma_store(&dvmap, v_s + bx * SM::kRBox, (c0 + bx) * 64, h, n0,
                        b);
        }
        hp::tma_commit();
        hp::tma_wait_read();
      }
    }
    // no block exits while a peer may still read its buffers
    hp::cluster_sync();
  };
  constexpr int B0 = SM::kBoxes0, B1 = GB - SM::kBoxes0;
  if (wg == 0)
    consume(std::integral_constant<int, B0>{}, 0);
  else
    consume(std::integral_constant<int, B1>{}, B0);
}

// ---------------------------------------------------------------- dQ --

// F32O: dQ in f32 through dq32 (dqmap unused).
template <int GC, bool F32O>
__global__ void __launch_bounds__(kXbThreads, 1)
xbwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap dqmap,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq32,
               int heads, int dim, int tq, int tk, float scale, int causal,
               int groups) {
  using SM = XbDqSmem<GC>;
  constexpr int BM = kRows, BN = kTile, NS = kStages, GB = SM::kGBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + SM::kR;
  const uint32_t stage_s = q_s + SM::kStagesAt;  // stage i: K_g, then V_g
  const uint32_t ds_s = q_s + SM::kPs;           // dS~ buffer i
  const uint32_t x_s = q_s + SM::kXs;            // exchange buffer i
  const uint32_t q_full = q_s + SM::kBars;
  auto full = [&](int i) { return q_full + 8 * (1 + i); };
  auto empty = [&](int i) { return q_full + 8 * (1 + NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg, lane = tid % 32;
  const GroupWork w = work_group_tiles_adjacent(groups);
  const int b = w.bh / heads, h = w.bh % heads;
  // a head's query tiles last first: the longest causal ones start first
  const int m0 = (gridDim.y - 1 - w.tile) * BM;
  // the key loop stops at the diagonal
  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  const int c0 = w.group * GB;
  const int nb = min(max((dim + 63) / 64 - c0, 0), GB);

  start_cluster<GC>(q_s, stage_s, nb, [&] {
    hp::mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(full(i), 1);
      hp::mbar_init(empty(i), 2 * kWg);
    }
  });

  if (wg == 2) {  // producer: one thread loads, all take the phases
    hp::regs_dec<24>();
    const bool loader = tid == 2 * kWg;
    if (loader) {
      hp::mbar_arrive_tx(q_full, 2 * nb * SM::kRBox);
      for (int bx = 0; bx < nb; ++bx) {
        hp::tma_load(q_s + bx * SM::kRBox, &qmap, q_full, (c0 + bx) * 64, h,
                     m0, b);
        hp::tma_load(do_s + bx * SM::kRBox, &domap, q_full, (c0 + bx) * 64,
                     h, m0, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      const uint32_t ks = stage_s + st * SM::kStage;
      producer_phase(it);
      if (!loader) continue;
      hp::mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
      hp::mbar_arrive_tx(full(st), 2 * nb * SM::kTBox);
      for (int bx = 0; bx < nb; ++bx) {
        hp::tma_load(ks + bx * SM::kTBox, &kmap, full(st), (c0 + bx) * 64, h,
                     it * BN, b);
        hp::tma_load(ks + SM::kT + bx * SM::kTBox, &vmap, full(st),
                     (c0 + bx) * 64, h, it * BN, b);
      }
    }
    producer_last_phases(n_tiles);
    return;
  }

  // consumer warpgroup wg: the partial S (0) or dP (1), then P and dS of
  // keys 16 wg ... 16 wg + 15 of each tile, then dQ columns of the group's
  // boxes [box0, box0 + NB)
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32, tl = tid % kWg;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;  // scores in log2 units
  // LSE (log2 units, clamped) and delta of this thread's two rows
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < tq;
    const size_t idx = ((size_t)b * heads + h) * tq + row[i];
    const float l = ok ? lse[idx] : 0.f;
    lse2[i] = l <= kNegInf / 2 ? 0.f : l * kLog2e;
    dl[i] = ok ? delta[idx] : 0.f;
  }

  auto consume = [&](auto n_boxes, int box0) {
    constexpr int NB = decltype(n_boxes)::value, N = NB * 64;
    // element 4c + 2i + e: (row[i], column (c0 + box0) 64 + 8c + 2t + e)
    float dqa[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dqa[e] = 0.f;

    // this consumer's partial of tile i: S = Q_g K_g^T or dP = dO_g V_g^T
    // over the stage's tile
    auto partial = [&](float(&part)[16], int i) {
      const int st = i % NS;
      const uint32_t ks = stage_s + st * SM::kStage;
      hp::mbar_wait(full(st), (i / NS) & 1);
      partial_product<GC>(part, wg == 0 ? q_s : do_s,
                          wg == 0 ? ks : ks + SM::kT);
    };
    // tile i's P and dS from the sums of its partials (s, dp: j = 2 wg +
    // jj of the tile at 4 jj + e), dS~ into the buffer, then its dQ_g +=
    // dS~ K_g over this consumer's boxes (A the buffer, K-major; B the
    // stage's K_g, MN-major), issued
    float s[8], dp[8];
    auto finish = [&](int i) {
      const int st = i % NS, n0 = i * BN;
      const uint32_t ks = stage_s + st * SM::kStage;
      const uint32_t dsb = ds_s + (i & 1) * SM::kP;
      const bool masked = n0 + BN > tk || (causal && n0 + BN - 1 > m0);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * wg + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          float pv = hp::exp2(fmaf(s[4 * jj + e], sl2, -lse2[i2]));
          if (masked) {
            const int kpos = n0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= tk || (causal && kpos > row[i2])) pv = 0.f;
          }
          dp[4 * jj + e] = pv * (dp[4 * jj + e] - dl[i2]) * scale;
        }
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2)
          hp::st_shared(dsb + hp::swizzled<32>(warp * 16 + g + 8 * i2,
                                               8 * j + 2 * t),
                        pack_f32(dp[4 * jj + 2 * i2],
                                 dp[4 * jj + 2 * i2 + 1]));
      }
      hp::fence_proxy_async();
      hp::named_sync(kPBar, 2 * kWg);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hp::mma_ss<N, 1>(dqa, hp::desc_k<32>(dsb + kk * 32),
                         hp::desc_mn<GC>(ks + box0 * SM::kTBox +
                                             kk * 16 * kBoxBytes,
                                         SM::kTBox),
                         1);
      hp::wgmma_commit();
      hp::fence_regs(dqa);
    };
    // element 4j + e of part: (row[e >> 1], key n0 + 8j + 2t + (e & 1))
    float part[16];
    hp::mbar_wait(q_full, 0);
    partial(part, 0);
    hp::wgmma_wait<0>();
    hp::fence_regs(part);
    // Step it, as dK/dV's: post tile it, finish tile it - 1 and issue tile
    // it + 1's partial, gather tile it, wait for the products.
    for (int it = 0; it <= n_tiles; ++it) {
      const Exchange x{x_s + (it & 1) * SM::kX, groups, wg, tl};
      if (it < n_tiles) x.post(part);
      if (it > 0) finish(it - 1);
      float next[16];  // as dK/dV's
      if (it + 1 < n_tiles) partial(next, it + 1);
      if (it < n_tiles) x.gather(s, dp);
      hp::wgmma_wait<0>();
      hp::fence_regs(next);
      hp::fence_regs(dqa);
      if (it > 0) hp::mbar_arrive(empty((it - 1) % NS));
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = next[e];
    }

    if constexpr (F32O) {
      const size_t rs = (size_t)heads * dim;
      const size_t base = slice_base(b, h, heads, tq, dim);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= tq) continue;
        const size_t at = base + (size_t)row[i] * rs;
#pragma unroll
        for (int c = 0; c < N / 8; ++c) {
          const int col = (c0 + box0) * 64 + 8 * c + 2 * t;
          if (col >= dim) continue;  // dim is a multiple of 8
          *reinterpret_cast<float2*>(dq32 + at + col) =
              make_float2(dqa[4 * c + 2 * i], dqa[4 * c + 2 * i + 1]);
        }
      }
    } else {
      // dQ_g in bf16 over this consumer's boxes of Q_g (both consumers
      // passed the last tile's barrier, after which neither reads Q_g),
      // then by TMA; rows past tq are not written
#pragma unroll
      for (int c = 0; c < N / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::st_shared(q_s + (box0 + c / 8) * SM::kRBox +
                            hp::swizzled<GC>(warp * 16 + g + 8 * i,
                                             8 * (c % 8) + 2 * t),
                        pack_f32(dqa[4 * c + 2 * i], dqa[4 * c + 2 * i + 1]));
      hp::fence_proxy_async();
      hp::named_sync(2 + wg, kWg);
      if (tl == 0) {
        for (int bx = box0; bx < box0 + NB && bx < nb; ++bx)
          hp::tma_store(&dqmap, q_s + bx * SM::kRBox, (c0 + bx) * 64, h, m0,
                        b);
        hp::tma_commit();
        hp::tma_wait_read();
      }
    }
    // no block exits while a peer may still read its buffers
    hp::cluster_sync();
  };
  constexpr int B0 = SM::kBoxes0, B1 = GB - SM::kBoxes0;
  if (wg == 0)
    consume(std::integral_constant<int, B0>{}, 0);
  else
    consume(std::integral_constant<int, B1>{}, B0);
}

// ------------------------------------------------------------ launches --

// A launch of one of the kernels: grid (batch * heads * G, row tiles), one
// cluster a tile's G groups, the kernel's dynamic shared memory (its limit
// set first, as it must be above 48 KB).
struct XbLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];

  template <typename Kernel>
  cudaError_t init(Kernel kernel, size_t smem, int batch, int heads,
                   int groups, int seq, cudaStream_t s) {
    cfg.gridDim = dim3(batch * heads * groups, (seq + kRows - 1) / kRows);
    cfg.blockDim = dim3(kXbThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = groups;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
};

bool bad_xbwd_args(int batch, int tq, int tk, int heads, int dtype,
                   int out_dtype) {
  return bad_args(batch, tq, tk, heads, dtype, out_dtype) || dtype != 1;
}

// fn(kernel, smem bytes, the tile count's sequence) for the dK/dV (Part
// 0) or dQ (Part 1) kernel of group width GC with bf16 or f32 outputs.
template <int Part, int GC, typename Fn>
cudaError_t by_kernel(bool f32o, int tq, int tk, Fn&& fn) {
  if constexpr (Part == 0)
    return f32o ? fn(xbwd_dkdv_kernel<GC, true>, XbDkdvSmem<GC>::kBytes, tk)
                : fn(xbwd_dkdv_kernel<GC, false>, XbDkdvSmem<GC>::kBytes, tk);
  else
    return f32o ? fn(xbwd_dq_kernel<GC, true>, XbDqSmem<GC>::kBytes, tq)
                : fn(xbwd_dq_kernel<GC, false>, XbDqSmem<GC>::kBytes, tq);
}

int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int batch,
         int tq, int tk, int heads, int head_dim, float scale, int causal,
         int dtype, int out_dtype, void* stream) {
  if (bad_xbwd_args(batch, tq, tk, heads, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_xbwd_head_dim(head_dim, [&](auto gc, int groups) {
    constexpr int GC = decltype(gc)::value;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, dom, dkm, dvm;
    if (!hp::encode_map<GC>(&qm, q, batch, tq, heads, head_dim, kTile) ||
        !hp::encode_map<GC>(&km, k, batch, tk, heads, head_dim, kRows) ||
        !hp::encode_map<GC>(&vm, v, batch, tk, heads, head_dim, kRows) ||
        !hp::encode_map<GC>(&dom, dout, batch, tq, heads, head_dim, kTile) ||
        (!f32o &&
         (!hp::encode_map<GC>(&dkm, dk, batch, tk, heads, head_dim, kRows) ||
          !hp::encode_map<GC>(&dvm, dv, batch, tk, heads, head_dim, kRows))))
      return cudaErrorInvalidValue;
    if (f32o) {  // unused: f32 dK and dV leave from the registers
      dkm = km;
      dvm = vm;
    }
    return by_kernel<0, GC>(f32o, tq, tk, [&](auto kernel, size_t smem,
                                              int seq) {
      XbLaunch l;
      cudaError_t e = l.init(kernel, smem, batch, heads, groups, seq, s);
      if (e == cudaSuccess)
        e = cudaLaunchKernelEx(&l.cfg, kernel, qm, km, vm, dom, dkm, dvm,
                               static_cast<const float*>(lse),
                               static_cast<const float*>(delta),
                               static_cast<float*>(dk),
                               static_cast<float*>(dv), heads, head_dim, tq,
                               tk, scale, causal, groups);
      return e != cudaSuccess ? e : cudaGetLastError();
    });
  });
}

int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int batch, int tq,
       int tk, int heads, int head_dim, float scale, int causal, int dtype,
       int out_dtype, void* stream) {
  if (bad_xbwd_args(batch, tq, tk, heads, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_xbwd_head_dim(head_dim, [&](auto gc, int groups) {
    constexpr int GC = decltype(gc)::value;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, dom, dqm;
    if (!hp::encode_map<GC>(&qm, q, batch, tq, heads, head_dim, kRows) ||
        !hp::encode_map<GC>(&km, k, batch, tk, heads, head_dim, kTile) ||
        !hp::encode_map<GC>(&vm, v, batch, tk, heads, head_dim, kTile) ||
        !hp::encode_map<GC>(&dom, dout, batch, tq, heads, head_dim, kRows) ||
        (!f32o &&
         !hp::encode_map<GC>(&dqm, dq_out, batch, tq, heads, head_dim, kRows)))
      return cudaErrorInvalidValue;
    if (f32o) dqm = qm;  // unused: f32 dQ leaves from the registers
    return by_kernel<1, GC>(f32o, tq, tk, [&](auto kernel, size_t smem,
                                              int seq) {
      XbLaunch l;
      cudaError_t e = l.init(kernel, smem, batch, heads, groups, seq, s);
      if (e == cudaSuccess)
        e = cudaLaunchKernelEx(&l.cfg, kernel, qm, km, vm, dom, dqm,
                               static_cast<const float*>(lse),
                               static_cast<const float*>(delta),
                               static_cast<float*>(dq_out), heads, head_dim,
                               tq, tk, scale, causal, groups);
      return e != cudaSuccess ? e : cudaGetLastError();
    });
  });
}

}  // namespace

// As rtt_flash_bwd_dkdv (flash_bwd.cu), for bf16 inputs (dtype 1) and
// head_dim a multiple of 8 from 264 to 1024; anything else is
// cudaErrorInvalidValue.
extern "C" int rtt_flash_xwide_bwd_dkdv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int batch, int tq,
                                        int tk, int heads, int head_dim,
                                        float scale, int causal, int dtype,
                                        int out_dtype, void* stream) {
  return dkdv(q, k, v, dout, lse, delta, dk, dv, batch, tq, tk, heads,
              head_dim, scale, causal, dtype, out_dtype, stream);
}

// As rtt_flash_bwd_dq (flash_bwd.cu), with rtt_flash_xwide_bwd_dkdv's
// limits.
extern "C" int rtt_flash_xwide_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq_out, int batch, int tq, int tk,
                                      int heads, int head_dim, float scale,
                                      int causal, int dtype, int out_dtype,
                                      void* stream) {
  return dq(q, k, v, dout, lse, delta, dq_out, batch, tq, tk, heads,
            head_dim, scale, causal, dtype, out_dtype, stream);
}

// The kernel a launch of dK/dV (kernel 0) or dQ (kernel 1) at (batch, tq,
// tk, heads, head_dim) with bf16 or f32 outputs takes: out[0] registers per
// thread, out[1] static shared bytes, out[2] the dynamic shared bytes its
// launch sets, out[3] its group width GC, out[4] how many of its clusters
// the card holds at once, out[5] how many clusters the launch has (one a
// key or query tile).
extern "C" int rtt_flash_xwide_bwd_attrs(int kernel, int batch, int tq,
                                         int tk, int heads, int head_dim,
                                         int f32_out, int* out) {
  if (kernel < 0 || kernel > 1 || batch <= 0 || tq <= 0 || tk <= 0 ||
      heads <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)by_xbwd_head_dim(head_dim, [&](auto gc, int groups) {
    constexpr int GC = decltype(gc)::value;
    auto attrs = [&](auto kern, size_t smem, int seq) {
      XbLaunch l;
      cudaError_t e = l.init(kern, smem, batch, heads, groups, seq, nullptr);
      if (e == cudaSuccess) e = func_attrs(kern, out);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveClusters(&out[4], kern, &l.cfg);
      out[3] = GC;
      out[5] = (int)(l.cfg.gridDim.x / groups * l.cfg.gridDim.y);
      return e;
    };
    return kernel == 0 ? by_kernel<0, GC>(f32_out != 0, tq, tk, attrs)
                       : by_kernel<1, GC>(f32_out != 0, tq, tk, attrs);
  });
}
