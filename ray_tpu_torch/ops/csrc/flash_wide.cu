// Flash-attention forward, dK/dV and dQ for Hopper (sm_90a) at head_dim
// 129 to 256, bf16 inputs, over [B, T, H, D].
//
// Replaces, for head_dim 129-256 and bf16 inputs: ray_tpu/ops/
// flash_attention.py::_fa_kernel (the head-major forward, launched by
// _flash_forward), ::_fa_bwd_dkdv_kernel (dK, dV) and ::_fa_bwd_dq_kernel
// (dQ, both launched by _flash_backward).  The Pallas kernels span any
// head_dim; the Hopper kernels of flash_fwd.cu and flash_bwd.cu are built
// for 32, 64 and 128, flash_xwide.cu's forward and flash_xwide_bwd.cu's
// dK/dV and dQ for 384 to 1024, flash_fma.cu takes the f32 forward above
// 128 and flash_generic.cu's SIMT dK/dV and dQ the f32 backward.  These
// compute what flash_fwd.cu and flash_bwd.cu compute, under the same
// contract: the causal mask aligned top-left, f32 LSE and delta (the LSE
// clamped to 0 for a row that saw no key), P rounded to bf16 before P V
// and dV, dS before dK and dQ; a row with no visible key gives O = 0 and
// LSE = -1e30; outputs in bf16 or, the chunk mode of ring attention
// (F32O), in f32 from bf16 inputs.
//
// Bound: at [8, 1024, 16, 256] causal the forward does 4 * D flops per
// visible (query, key) pair (69 GFLOP, 70 us at 989 TFLOP/s) against 268
// MB of q, k, v, o (80 us at 3.35 TB/s); dK/dV does 8 * D flops per pair
// (138 GFLOP, 139 us) against 403 MB (120 us); dQ 6 * D (103 GFLOP, 104
// us) against 336 MB (100 us).  All sit where the two bounds meet, so, as
// at 128, the design keeps the tensor cores fed and every [T, T]
// intermediate out of device memory.
//
// A file of its own: flash_fwd.cu and flash_bwd.cu spend their shared
// memory and registers at 128 (the forward takes 230,496 of 232,448
// bytes), and the width changes both kernels' tiling (below); their
// 32/64/128 builds keep their code as it was.  Built for D = 192 and 256
// (tiles of three or four 64-column boxes, 128-byte swizzle; hopper.cuh);
// any multiple of 8 from 136 to 256 runs on the next of the two, its
// columns past head_dim zeros (TMA fills them on load and clips them on
// store, as flash_common.cuh's by_head_dim does for 32/64/128).
//
// Forward (wide_fwd_kernel): flash_fwd.cu's bf16 skeleton.  Persistent, one
// block per SM taking items (batch * head, 128-query tile) two at a time in
// work_head_tile_pairs order; a producer warpgroup (setmaxnreg 24) whose
// one thread loads Q and streams K/V tiles through a ring of stages by
// TMA; two consumer warpgroups (setmaxnreg 240), 64 query rows each, that
// take turns on named barriers: in its turn a consumer issues the previous
// tile's O += P V and this tile's S = Q K^T, so one's softmax runs while
// the other's products do.  What the width changes:
//  * 64 keys a tile, not 128: a consumer thread holds O (64 x D f32, D / 2
//    registers: 128 at 256), S (32) and P as bf16 A fragments (16); at 128
//    keys S and P would take 96, 224 with O, leaving 16 of setmaxnreg's 240
//    for the softmax state and the addresses.
//  * One Q buffer, reused as O's staging tile (two Q buffers would take 128
//    KB at 256).  Shared memory at 256: Q 64 KB + 2 stages x (K 32 KB + V
//    32 KB) = 192 KB; at 192: Q 48 KB + 3 stages x 48 KB = 192 KB.  A
//    consumer writes O over its own 64 Q rows once its last S is done,
//    stores them by TMA and frees the buffer when the store has read
//    them; the next item's Q lands then.  With F32O each thread stores
//    float2 pairs from its registers (guarding rows past tq and columns
//    past head_dim) and the buffer is freed after the last S.
//  * O += P V is one m64nDk16 per 16 keys (A from registers, V read
//    MN-major across its boxes); S = Q K^T is D / 16 m64n64k16 (both
//    K-major).
//
// dK/dV (wide_dkdv_kernel): flash_bwd.cu's layout (one block per 128 keys,
// a consumer owning 64 keys' dK and dV) would hold 2 x D / 2 accumulator
// registers a thread, 256 at D = 256.  Here a block owns 64 keys of one
// (batch, head); a producer warpgroup loads K and V once and streams
// 64-query tiles of Q and dO by TMA (2 stages at 256, 3 at 192), the
// tile's LSE (log2 units) and delta written beside them by its warp.  Per
// tile, the two consumers:
//  1. split S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries) by query
//     halves: m64n32k16, both operands K-major; P^T and dS^T in f32;
//  2. write P~^T and dS~^T (bf16, 8 KB each, 128-byte swizzle, keys as rows)
//     into one of two shared buffers, and meet on a named barrier;
//  3. dV += P~^T dO and dK += dS~^T Q with each consumer owning half of the
//     head's boxes (m64n128k16 at 256; at 192 consumer 0 two boxes, 1 one):
//     A is the P~^T / dS~^T tile (K-major), B the stage's dO / Q read
//     MN-major.  A thread holds 64 + 64 accumulator registers at 256.
// The buffers alternate, so one barrier a tile orders everything: a
// consumer writes buffer i & 1 after the barrier of tile i - 1, which the
// other passed only after its products of tile i - 2 had read it.  Shared
// memory at 256: K 32 + V 32 + 2 x (Q 32 + dO 32) + 2 x (P~^T 8 + dS~^T 8) KB
// + the stats = 231,464 bytes of 232,448.  After the last tile K and V are
// free (both consumers passed its barrier): dK and dV are written over
// them in bf16 and stored by TMA (keys past tk are not written), or, with
// F32O, stored from the registers.  With causal the query loop starts at
// the block's diagonal tile; rows past tq and keys above the diagonal are
// masked to P = 0.
//
// dQ (wide_dq_kernel): flash_bwd.cu's persistent dQ does not fit at 256.
// Its items of 128 queries take Q + dO 128 KB, and a 64-key K/V stage is 64
// KB, so one item buffer and two stages are already 256 KB of the block's
// 227 KB.  So dQ mirrors dK/dV: a block owns 64 queries of one (batch,
// head), a head's blocks adjacent (its K/V tiles shared in L2); a producer
// warpgroup loads Q and dO once (64 KB at 256) and streams 64-key tiles of
// K and V (64 KB a stage; 2 stages at 256, 3 at 192).  Per key tile, the
// two consumers:
//  1. split S = Q K^T and dP = dO V^T (64 queries x 64 keys) by key
//     halves: m64n32k16, both operands K-major; P = 2^(S scale log2 e -
//     LSE log2 e), elementwise given the row's LSE, so no reduction
//     crosses the consumers, and dS = P (dP - delta) scale, each thread
//     reading its two rows' LSE and delta once;
//  2. write dS~ (bf16, 8 KB, 128-byte swizzle, queries as rows) into one
//     of two shared buffers, and meet on a named barrier;
//  3. dQ += dS~ K with each consumer owning half of the head's boxes
//     (m64n128k16 at 256; at 192 consumer 0 two boxes, 1 one): A is the
//     dS~ tile (K-major), B the stage's K read MN-major across its boxes.
//     A thread holds S 16 + dP 16 + dQ 64 registers.
// The buffers alternate under the same argument as dK/dV's.  Shared
// memory at 256: Q 32 + dO 32 + 2 x (K 32 + V 32) + 2 x dS~ 8 KB = 214,056
// bytes with the mbarriers; at 192: 214,072 (3 stages).  After the last
// tile's barrier neither consumer reads Q again: dQ is written over Q's
// boxes in bf16 and stored by TMA (rows past tq are not written), or, with
// F32O, stored from the registers as float2 pairs.  With causal the key
// loop stops at the block's diagonal tile; keys past tk and above the
// diagonal are masked to P = 0.
//
// Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace hp = hopper;

constexpr int kWg = 128;              // threads of a warpgroup
constexpr int kWideThreads = 3 * kWg;  // consumers 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;

// The wide kernels are built for D = 192 and 256: fn(HeadDim<D>{}) for the
// smaller one at or above head_dim, a multiple of 8 from 136 to 256 (its
// extra columns zeros); any other size is cudaErrorInvalidValue.
template <typename Fn>
cudaError_t by_wide_head_dim(int head_dim, Fn&& fn) {
  if (head_dim <= 128 || head_dim > 256 || head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  if (head_dim <= 192) return fn(HeadDim<192>{});
  return fn(HeadDim<256>{});
}

// ----------------------------------------------------------- forward --

constexpr int kFwdBM = 128, kFwdBN = 64;  // query rows, keys per tile
constexpr int kTurnBar = 3;  // named barriers 3 + w: consumer w's turn

// Shared memory: the Q buffer (O's staging tile too), the stages (K, V),
// the mbarriers.
template <int D>
struct WideFwdSmem {
  using L = hp::Swz<D>;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr uint32_t kQBox = kFwdBM * L::kRowBytes;
  static constexpr uint32_t kKVBox = kFwdBN * L::kRowBytes;
  static constexpr uint32_t kQ = L::kBoxes * kQBox;
  static constexpr uint32_t kKV = L::kBoxes * kKVBox;  // one K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kBars = kQ + kStages * kStage;
  // Q full, Q empty; K full, V full, K empty, V empty per stage
  static constexpr int kNumBars = 2 + 4 * kStages;
  // + 1024: the base is aligned up to the swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
};

// Persistent: block c takes the work items 2u and 2u + 1 (in the order of
// work_head_tile_pairs) for u = c, c + gridDim.x, ...
// F32O: O in f32 through o32 (omap unused), else in bf16 through omap.
template <int D, bool F32O>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                float* __restrict__ lse, float* __restrict__ o32, int batch,
                int heads, int dim, int tq, int tk, float scale,
                int causal) {
  using L = hp::Swz<D>;
  using SM = WideFwdSmem<D>;
  constexpr int BM = kFwdBM, BN = kFwdBN, NS = SM::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + SM::kQ;  // stage i: K, then V
  const uint32_t bars = q_s + SM::kBars;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int i) { return bars + 8 * (2 + i); };
  auto v_full = [&](int i) { return bars + 8 * (2 + NS + i); };
  auto k_empty = [&](int i) { return bars + 8 * (2 + 2 * NS + i); };
  auto v_empty = [&](int i) { return bars + 8 * (2 + 3 * NS + i); };

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
    hp::mbar_init(q_full, 1);
    hp::mbar_init(q_empty, 2 * kWg);
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
      // Q once item k - 1's O has left the buffer
      hp::mbar_wait(q_empty, (k & 1) ^ 1);
      hp::mbar_arrive_tx(q_full, SM::kQ);
      for (int half = 0; half < 2; ++half)
        for (int bx = 0; bx < L::kBoxes; ++bx)
          hp::tma_load(q_s + bx * SM::kQBox + half * 64 * L::kRowBytes,
                       &qmap, q_full, bx * L::kCols, h, m0 + half * 64, b);
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
  const float sl2 = scale * kLog2e;  // log2 units, scale > 0
  const uint32_t qa = q_s + wg * 64 * L::kRowBytes;  // this wg's Q rows
  // Turns, as in flash_fwd.cu: consumer 0 takes the first; both take one
  // turn per key tile plus one per item.
  if (wg == 1) hp::named_arrive(kTurnBar, 2 * kWg);
  unsigned kv0 = 0;  // K/V tiles of the earlier items
  for (unsigned k = 0, lin; (lin = item(k)) < n_work; ++k) {
    const Work w = work(lin);
    const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
    const int n_tiles = key_tiles_of(m0);
    const int first_row = m0 + wg * 64;
    const int row[2] = {first_row + warp * 16 + g,
                        first_row + warp * 16 + g + 8};

    // O: element 4c + 2i + e is (row[i], column 8c + 2t + e)
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // raw score units
    float l_run[2] = {0.f, 0.f};          // this thread's share of the sum
    // S: element 4j + e is (row[e >> 1], key n0 + 8j + 2t + (e & 1)).  P:
    // the S accumulators of 8-key groups 2kk and 2kk+1, rounded to bf16,
    // are the wgmma A fragment of key slice kk.
    float s[BN / 2];
    uint32_t pa[BN / 16][4];

    // One turn: P V of tile it - 1 and S = Q K^T of tile it, as the flags
    // say; then wait for both and release what they read.
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
          hp::mma_rs<D>(o, pa[kk],
                        hp::desc_mn<D>(vs + kk * 16 * L::kRowBytes,
                                       SM::kKVBox));
      }
      if constexpr (kS) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
          hp::mma_ss<BN>(s, hp::desc_k<D>(qa + bx * SM::kQBox + kb),
                         hp::desc_k<D>(ks + bx * SM::kKVBox + kb), kk > 0);
        }
      }
      hp::wgmma_commit();
      hp::named_arrive(kTurnBar + (wg ^ 1), 2 * kWg);
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hp::fence_regs(pa[kk]);
      hp::fence_regs(o);
      if constexpr (kPV) hp::mbar_arrive(v_empty(prev % NS));
      if constexpr (kS) {
        hp::mbar_arrive(k_empty(cur % NS));
        // F32O stages nothing: Q is done with its last S
        if (F32O && it == n_tiles - 1) hp::mbar_arrive(q_empty);
      }
    };

    // The online softmax of tile it's scores, as in flash_fwd.cu.
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
            const float pv = hp::exp2(fmaf(s[4 * j + 2 * i + c], sl2, -ms));
            s[4 * j + 2 * i + c] = pv;
            psum += pv;
          }
        l_run[i] = l_run[i] * corr + psum;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c + 2 * i] *= corr;
          o[4 * c + 2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_f32(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    hp::mbar_wait(q_full, k & 1);
    turn(0, std::false_type{}, std::true_type{});
    softmax(0);
    for (int it = 1; it < n_tiles; ++it) {
      turn(it, std::true_type{}, std::true_type{});
      softmax(it);
    }
    turn(n_tiles, std::true_type{}, std::false_type{});
    kv0 += n_tiles;

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
    if constexpr (F32O) {
      const size_t rs = (size_t)heads * dim;
      float* ob = o32 + slice_base(b, h, heads, tq, dim);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= tq) continue;
        float* orow = ob + (size_t)row[i] * rs;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < dim)  // dim is a multiple of 8: col + 1 < dim too
            *reinterpret_cast<float2*>(orow + col) = make_float2(
                o[4 * c + 2 * i] * inv[i], o[4 * c + 2 * i + 1] * inv[i]);
        }
      }
    } else {
      // O / l over this warpgroup's Q rows (its last S is done), out by
      // TMA; the buffer is free for the next Q once the store has read it
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::st_shared(qa + (c / 8) * SM::kQBox +
                            hp::swizzled<D>(warp * 16 + g + 8 * i,
                                            8 * (c % 8) + 2 * t),
                        pack_f32(o[4 * c + 2 * i] * inv[i],
                                 o[4 * c + 2 * i + 1] * inv[i]));
      hp::fence_proxy_async();
      hp::named_sync(1 + wg, kWg);
      if (tid % kWg == 0) {
        for (int bx = 0; bx < L::kBoxes; ++bx)
          hp::tma_store(&omap, qa + bx * SM::kQBox, bx * L::kCols, h,
                        first_row, b);
        hp::tma_commit();
        hp::tma_wait_read();
      }
      hp::named_sync(1 + wg, kWg);
      hp::mbar_arrive(q_empty);
    }
  }
  // consumer 1's arrival after its last turn
  if (wg == 0) hp::named_sync(kTurnBar, 2 * kWg);
}

// ------------------------------------------------------------- dK/dV --

constexpr int kBwdBN = 64, kBwdBM = 64;  // keys per block, queries per tile
// named barrier: both halves of P~^T and dS~^T (dK/dV) or of dS~ (dQ)
// written
constexpr int kPBar = 1;

// Shared memory: K, V, the Q/dO stages, two P~^T/dS~^T buffers, the
// stages' LSE/delta, the mbarriers.
template <int D>
struct WideDkdvSmem {
  using L = hp::Swz<D>;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr uint32_t kBox = 64 * L::kRowBytes;  // 64 rows of a box
  static constexpr uint32_t kT = L::kBoxes * kBox;  // a K, V, Q or dO tile
  static constexpr uint32_t kStage = 2 * kT;          // Q, then dO
  static constexpr uint32_t kStages0 = 2 * kT;        // after K and V
  static constexpr uint32_t kP = kBwdBN * kBwdBM * 2;  // P~^T or dS~^T
  static constexpr uint32_t kPs = kStages0 + kStages * kStage;
  static constexpr uint32_t kStats = kPs + 4 * kP;
  static constexpr uint32_t kStatBytes = 2 * kBwdBM * 4;  // LSE, delta
  static constexpr uint32_t kBars = kStats + kStages * kStatBytes;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  // consumer 0 owns boxes [0, kBoxes0) of dK and dV, consumer 1 the rest
  static constexpr int kBoxes0 = (L::kBoxes + 1) / 2;
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

// F32O: dK and dV in f32 through dk32 and dv32 (dkmap, dvmap unused).
template <int D, bool F32O>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dkmap,
                 const __grid_constant__ CUtensorMap dvmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk32,
                 float* __restrict__ dv32, int heads, int dim, int tq,
                 int tk, float scale, int causal) {
  using L = hp::Swz<D>;
  using SM = WideDkdvSmem<D>;
  constexpr int BN = kBwdBN, BM = kBwdBM, NS = SM::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + SM::kT;
  const uint32_t stage_s = k_s + SM::kStages0;  // stage i: Q, then dO
  const uint32_t p_s = k_s + SM::kPs;  // buffer i: P~^T, then dS~^T
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
      hp::mbar_arrive_tx(kv_full, 2 * SM::kT);
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        hp::tma_load(k_s + bx * SM::kBox, &kmap, kv_full, bx * L::kCols, h,
                     n0, b);
        hp::tma_load(v_s + bx * SM::kBox, &vmap, kv_full, bx * L::kCols, h,
                     n0, b);
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
        const float l = ok ? lse_b[m0 + r] : 0.f;
        hp::st_shared(stats + 4 * r, __float_as_uint(
            l <= kNegInf / 2 ? 0.f : l * kLog2e));
        hp::st_shared(stats + 4 * (BM + r),
                      __float_as_uint(ok ? delta_b[m0 + r] : 0.f));
      }
      if (lane == 0) {
        const uint32_t qs = stage_s + st * SM::kStage;
        hp::mbar_arrive_tx(full(st), SM::kStage);
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          hp::tma_load(qs + bx * SM::kBox, &qmap, full(st), bx * L::kCols, h,
                       m0, b);
          hp::tma_load(qs + SM::kT + bx * SM::kBox, &domap, full(st),
                       bx * L::kCols, h, m0, b);
        }
      } else {
        hp::mbar_arrive(full(st));
      }
    }
    return;
  }

  // consumer warpgroup wg: queries qh ... qh + 31 of each tile for S^T and
  // dP^T, then dK and dV columns of boxes [box0, box0 + NB)
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int key[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;  // scores in log2 units
  const int qh = 32 * wg;

  auto consume = [&](auto n_boxes, int box0) {
    constexpr int NB = decltype(n_boxes)::value, N = NB * L::kCols;
    // element 4c + 2i + e: (key[i], column box0 kCols + 8c + 2t + e)
    float dka[N / 2], dva[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dka[e] = dva[e] = 0.f;

    hp::mbar_wait(kv_full, 0);
    for (int mt = m_begin; mt < m_end; ++mt) {
      const int it = mt - m_begin, st = it % NS, m0 = mt * BM;
      const uint32_t qs = stage_s + st * SM::kStage, dos = qs + SM::kT;
      const uint32_t stats = stats_s + st * SM::kStatBytes;
      const uint32_t pt = p_s + (it & 1) * 2 * SM::kP, dst = pt + SM::kP;
      hp::mbar_wait(full(st), (it / NS) & 1);

      // S^T = K Q^T, then dP^T = V dO^T over this consumer's 32 queries,
      // two groups; element 4j + e of each is (key[e >> 1], query
      // m0 + qh + 8j + 2t + (e & 1)).
      float sT[16], dpt[16];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
        hp::mma_ss<32>(
            sT, hp::desc_k<D>(k_s + bx * SM::kBox + kb),
            hp::desc_k<D>(qs + bx * SM::kBox + qh * L::kRowBytes + kb),
            kk > 0);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
        hp::mma_ss<32>(
            dpt, hp::desc_k<D>(v_s + bx * SM::kBox + kb),
            hp::desc_k<D>(dos + bx * SM::kBox + qh * L::kRowBytes + kb),
            kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sT);

      // P^T in place of S^T while dP^T runs
      const bool masked = m0 + BM > tq || (causal && n0 + BN - 1 > m0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = hp::ld_shared_f2(stats + 4 * (qh + 8 * j + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sT[4 * j + e] * sl2 - ((e & 1) ? l2.y : l2.x));
          if (masked) {
            const int qpos = m0 + qh + 8 * j + 2 * t + (e & 1);
            if (qpos >= tq || (causal && key[e >> 1] > qpos)) p = 0.f;
          }
          sT[4 * j + e] = p;
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 d2 =
            hp::ld_shared_f2(stats + 4 * (BM + qh + 8 * j + 2 * t));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = sT[4 * j + e] *
                           (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }

      // P~^T and dS~^T, keys as rows and this consumer's queries as
      // columns, into the buffer; the other consumer writes the other half
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t off =
              hp::swizzled<64>(warp * 16 + g + 8 * i, qh + 8 * j + 2 * t);
          hp::st_shared(pt + off,
                        pack_f32(sT[4 * j + 2 * i], sT[4 * j + 2 * i + 1]));
          hp::st_shared(dst + off, pack_f32(dpt[4 * j + 2 * i],
                                            dpt[4 * j + 2 * i + 1]));
        }
      hp::fence_proxy_async();
      hp::named_sync(kPBar, 2 * kWg);

      // dV += P~^T dO and dK += dS~^T Q over this consumer's boxes: A the
      // buffer (K-major), B the stage's dO and Q (MN-major)
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t off = box0 * SM::kBox + kk * 16 * L::kRowBytes;
        hp::mma_ss<N, 1>(dva, hp::desc_k<64>(pt + kk * 32),
                         hp::desc_mn<D>(dos + off, SM::kBox), 1);
        hp::mma_ss<N, 1>(dka, hp::desc_k<64>(dst + kk * 32),
                         hp::desc_mn<D>(qs + off, SM::kBox), 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dka);
      hp::fence_regs(dva);
      hp::mbar_arrive(empty(st));
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
          const int col = box0 * L::kCols + 8 * c + 2 * t;
          if (col >= dim) continue;  // dim is a multiple of 8
          *reinterpret_cast<float2*>(dk32 + at + col) =
              make_float2(dka[4 * c + 2 * i], dka[4 * c + 2 * i + 1]);
          *reinterpret_cast<float2*>(dv32 + at + col) =
              make_float2(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]);
        }
      }
      return;
    }
    // dK and dV in bf16 over this consumer's boxes of K and V (both
    // consumers passed the last tile's barrier, so neither reads K or V
    // again), then by TMA
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off =
            (box0 + c / 8) * SM::kBox +
            hp::swizzled<D>(warp * 16 + g + 8 * i, 8 * (c % 8) + 2 * t);
        hp::st_shared(k_s + off,
                      pack_f32(dka[4 * c + 2 * i], dka[4 * c + 2 * i + 1]));
        hp::st_shared(v_s + off,
                      pack_f32(dva[4 * c + 2 * i], dva[4 * c + 2 * i + 1]));
      }
    hp::fence_proxy_async();
    hp::named_sync(2 + wg, kWg);
    if (tid % kWg == 0) {
      for (int bx = box0; bx < box0 + NB; ++bx) {
        hp::tma_store(&dkmap, k_s + bx * SM::kBox, bx * L::kCols, h, n0, b);
        hp::tma_store(&dvmap, v_s + bx * SM::kBox, bx * L::kCols, h, n0, b);
      }
      hp::tma_commit();
      hp::tma_wait_read();
    }
  };
  constexpr int B0 = SM::kBoxes0, B1 = L::kBoxes - SM::kBoxes0;
  if (wg == 0)
    consume(std::integral_constant<int, B0>{}, 0);
  else
    consume(std::integral_constant<int, B1>{}, B0);
}

// ---------------------------------------------------------------- dQ --

constexpr int kDqBM = 64, kDqBN = 64;  // queries per block, keys per tile

// Shared memory: Q, dO, the K/V stages, two dS~ buffers, the mbarriers.
template <int D>
struct WideDqSmem {
  using L = hp::Swz<D>;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr uint32_t kBox = 64 * L::kRowBytes;  // 64 rows of a box
  static constexpr uint32_t kT = L::kBoxes * kBox;  // a Q, dO, K or V tile
  static constexpr uint32_t kStage = 2 * kT;          // K, then V
  static constexpr uint32_t kStages0 = 2 * kT;        // after Q and dO
  static constexpr uint32_t kDs = kDqBM * kDqBN * 2;  // one dS~ buffer
  static constexpr uint32_t kDss = kStages0 + kStages * kStage;
  static constexpr uint32_t kBars = kDss + 2 * kDs;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
  // consumer 0 owns boxes [0, kBoxes0) of dQ, consumer 1 the rest
  static constexpr int kBoxes0 = (L::kBoxes + 1) / 2;
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

// F32O: dQ in f32 through dq32 (dqmap unused).
template <int D, bool F32O>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_dq_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap dqmap,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq32,
               int heads, int dim, int tq, int tk, float scale,
               int causal) {
  using L = hp::Swz<D>;
  using SM = WideDqSmem<D>;
  constexpr int BM = kDqBM, BN = kDqBN, NS = SM::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + SM::kT;
  const uint32_t stage_s = q_s + SM::kStages0;  // stage i: K, then V
  const uint32_t ds_s = q_s + SM::kDss;  // buffer i: dS~ of tiles i, i + 2..
  const uint32_t q_full = q_s + SM::kBars;
  auto full = [&](int i) { return q_full + 8 * (1 + i); };
  auto empty = [&](int i) { return q_full + 8 * (1 + NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg, lane = tid % 32;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * BM;
  // the key loop stops at the diagonal
  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(full(i), 1);
      hp::mbar_init(empty(i), 2 * kWg);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread
    hp::regs_dec<24>();
    if (tid != 2 * kWg) return;
    hp::mbar_arrive_tx(q_full, 2 * SM::kT);
    for (int bx = 0; bx < L::kBoxes; ++bx) {
      hp::tma_load(q_s + bx * SM::kBox, &qmap, q_full, bx * L::kCols, h, m0,
                   b);
      hp::tma_load(do_s + bx * SM::kBox, &domap, q_full, bx * L::kCols, h,
                   m0, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      const uint32_t ks = stage_s + st * SM::kStage;
      hp::mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
      hp::mbar_arrive_tx(full(st), SM::kStage);
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        hp::tma_load(ks + bx * SM::kBox, &kmap, full(st), bx * L::kCols, h,
                     it * BN, b);
        hp::tma_load(ks + SM::kT + bx * SM::kBox, &vmap, full(st),
                     bx * L::kCols, h, it * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys kh ... kh + 31 of each tile for S and dP,
  // then dQ columns of boxes [box0, box0 + NB)
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;  // scores in log2 units
  const int kh = 32 * wg;
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
    constexpr int NB = decltype(n_boxes)::value, N = NB * L::kCols;
    // element 4c + 2i + e: (row[i], column box0 kCols + 8c + 2t + e)
    float dqa[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dqa[e] = 0.f;

    hp::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS, n0 = it * BN;
      const uint32_t ks = stage_s + st * SM::kStage, vs = ks + SM::kT;
      const uint32_t dsb = ds_s + (it & 1) * SM::kDs;
      hp::mbar_wait(full(st), (it / NS) & 1);

      // S = Q K^T, then dP = dO V^T over this consumer's 32 keys; element
      // 4j + e of each is (row[e >> 1], key n0 + kh + 8j + 2t + (e & 1)).
      float s[16], dp[16];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
        hp::mma_ss<32>(
            s, hp::desc_k<D>(q_s + bx * SM::kBox + kb),
            hp::desc_k<D>(ks + bx * SM::kBox + kh * L::kRowBytes + kb),
            kk > 0);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
        hp::mma_ss<32>(
            dp, hp::desc_k<D>(do_s + bx * SM::kBox + kb),
            hp::desc_k<D>(vs + bx * SM::kBox + kh * L::kRowBytes + kb),
            kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(s);

      // P in place of S while dP runs
      const bool masked = n0 + BN > tk || (causal && n0 + BN - 1 > m0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = hp::exp2(fmaf(s[4 * j + e], sl2, -lse2[i]));
          if (masked) {
            const int kpos = n0 + kh + 8 * j + 2 * t + (e & 1);
            if (kpos >= tk || (causal && kpos > row[i])) p = 0.f;
          }
          s[4 * j + e] = p;
        }
      hp::wgmma_wait<0>();
      hp::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]) * scale;

      // dS~, queries as rows and this consumer's keys as columns, into
      // the buffer; the other consumer writes the other half
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hp::st_shared(dsb + hp::swizzled<64>(warp * 16 + g + 8 * i,
                                               kh + 8 * j + 2 * t),
                        pack_f32(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]));
      hp::fence_proxy_async();
      hp::named_sync(kPBar, 2 * kWg);

      // dQ += dS~ K over this consumer's boxes: A the buffer (K-major), B
      // the stage's K (MN-major)
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hp::mma_ss<N, 1>(dqa, hp::desc_k<64>(dsb + kk * 32),
                         hp::desc_mn<D>(ks + box0 * SM::kBox +
                                            kk * 16 * L::kRowBytes,
                                        SM::kBox),
                         1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dqa);
      hp::mbar_arrive(empty(st));
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
          const int col = box0 * L::kCols + 8 * c + 2 * t;
          if (col >= dim) continue;  // dim is a multiple of 8
          *reinterpret_cast<float2*>(dq32 + at + col) =
              make_float2(dqa[4 * c + 2 * i], dqa[4 * c + 2 * i + 1]);
        }
      }
      return;
    }
    // dQ in bf16 over this consumer's boxes of Q (both consumers passed
    // the last tile's barrier after their last S, so neither reads Q
    // again), then by TMA; rows past tq are not written
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        hp::st_shared(q_s + (box0 + c / 8) * SM::kBox +
                          hp::swizzled<D>(warp * 16 + g + 8 * i,
                                          8 * (c % 8) + 2 * t),
                      pack_f32(dqa[4 * c + 2 * i], dqa[4 * c + 2 * i + 1]));
    hp::fence_proxy_async();
    hp::named_sync(2 + wg, kWg);
    if (tid % kWg == 0) {
      for (int bx = box0; bx < box0 + NB; ++bx)
        hp::tma_store(&dqmap, q_s + bx * SM::kBox, bx * L::kCols, h, m0, b);
      hp::tma_commit();
      hp::tma_wait_read();
    }
  };
  constexpr int B0 = SM::kBoxes0, B1 = L::kBoxes - SM::kBoxes0;
  if (wg == 0)
    consume(std::integral_constant<int, B0>{}, 0);
  else
    consume(std::integral_constant<int, B1>{}, B0);
}

// ------------------------------------------------------------- entries --

bool bad_wide_args(int batch, int tq, int tk, int heads, int dtype,
                   int out_dtype) {
  return bad_args(batch, tq, tk, heads, dtype, out_dtype) || dtype != 1;
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int batch, int tq, int tk, int heads, int head_dim, float scale,
        int causal, int dtype, int out_dtype, void* stream) {
  if (bad_wide_args(batch, tq, tk, heads, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_wide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, om;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, 64) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, kFwdBN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, kFwdBN) ||
        (!f32o && !hp::encode_map<D>(&om, o, batch, tq, heads, head_dim, 64)))
      return cudaErrorInvalidValue;
    if (f32o) om = qm;  // unused: f32 O leaves from the registers
    int blocks = 0;
    const cudaError_t e = persistent_blocks(
        (long)batch * heads * ((tq + kFwdBM - 1) / kFwdBM), &blocks);
    if (e != cudaSuccess) return e;
    auto go = [&](auto kernel) {
      return launch_block(kernel, dim3(blocks), kWideThreads,
                          WideFwdSmem<D>::kBytes, s, qm, km, vm, om,
                          static_cast<float*>(lse), static_cast<float*>(o),
                          batch, heads, head_dim, tq, tk, scale, causal);
    };
    return f32o ? go(wide_fwd_kernel<D, true>) : go(wide_fwd_kernel<D, false>);
  });
}

int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int batch,
         int tq, int tk, int heads, int head_dim, float scale, int causal,
         int dtype, int out_dtype, void* stream) {
  if (bad_wide_args(batch, tq, tk, heads, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_wide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, dom, dkm, dvm;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, kBwdBM) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, kBwdBN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, kBwdBN) ||
        !hp::encode_map<D>(&dom, dout, batch, tq, heads, head_dim, kBwdBM) ||
        (!f32o &&
         (!hp::encode_map<D>(&dkm, dk, batch, tk, heads, head_dim, kBwdBN) ||
          !hp::encode_map<D>(&dvm, dv, batch, tk, heads, head_dim, kBwdBN))))
      return cudaErrorInvalidValue;
    if (f32o) {  // unused: f32 dK and dV leave from the registers
      dkm = km;
      dvm = vm;
    }
    auto go = [&](auto kernel) {
      return launch_block(
          kernel, dim3(batch * heads, (tk + kBwdBN - 1) / kBwdBN),
          kWideThreads, WideDkdvSmem<D>::kBytes, s, qm, km, vm, dom, dkm, dvm,
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), heads, head_dim,
          tq, tk, scale, causal);
    };
    return f32o ? go(wide_dkdv_kernel<D, true>)
                : go(wide_dkdv_kernel<D, false>);
  });
}

int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int batch, int tq,
       int tk, int heads, int head_dim, float scale, int causal, int dtype,
       int out_dtype, void* stream) {
  if (bad_wide_args(batch, tq, tk, heads, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_wide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, dom, dqm;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, kDqBM) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, kDqBN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, kDqBN) ||
        !hp::encode_map<D>(&dom, dout, batch, tq, heads, head_dim, kDqBM) ||
        (!f32o &&
         !hp::encode_map<D>(&dqm, dq_out, batch, tq, heads, head_dim, kDqBM)))
      return cudaErrorInvalidValue;
    if (f32o) dqm = qm;  // unused: f32 dQ leaves from the registers
    auto go = [&](auto kernel) {
      return launch_block(
          kernel, dim3(batch * heads, (tq + kDqBM - 1) / kDqBM),
          kWideThreads, WideDqSmem<D>::kBytes, s, qm, km, vm, dom, dqm,
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dq_out), heads, head_dim, tq, tk, scale,
          causal);
    };
    return f32o ? go(wide_dq_kernel<D, true>) : go(wide_dq_kernel<D, false>);
  });
}

}  // namespace

// As rtt_flash_fwd (flash_fwd.cu), for bf16 inputs (dtype 1) and head_dim
// a multiple of 8 from 136 to 256; anything else is cudaErrorInvalidValue.
extern "C" int rtt_flash_wide_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int batch, int tq,
                                  int tk, int heads, int head_dim,
                                  float scale, int causal, int dtype,
                                  int out_dtype, void* stream) {
  return fwd(q, k, v, o, lse, batch, tq, tk, heads, head_dim, scale, causal,
             dtype, out_dtype, stream);
}

// As rtt_flash_bwd_dkdv (flash_bwd.cu), with rtt_flash_wide_fwd's limits.
extern "C" int rtt_flash_wide_bwd_dkdv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int batch, int tq,
                                       int tk, int heads, int head_dim,
                                       float scale, int causal, int dtype,
                                       int out_dtype, void* stream) {
  return dkdv(q, k, v, dout, lse, delta, dk, dv, batch, tq, tk, heads,
              head_dim, scale, causal, dtype, out_dtype, stream);
}

// As rtt_flash_bwd_dq (flash_bwd.cu), with rtt_flash_wide_fwd's limits.
extern "C" int rtt_flash_wide_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq_out, int batch, int tq, int tk,
                                     int heads, int head_dim, float scale,
                                     int causal, int dtype, int out_dtype,
                                     void* stream) {
  return dq(q, k, v, dout, lse, delta, dq_out, batch, tq, tk, heads,
            head_dim, scale, causal, dtype, out_dtype, stream);
}

// As rtt_flash_bwd_attrs, for the forward (kernel 0), dK/dV (kernel 1) or
// dQ (kernel 2).
extern "C" int rtt_flash_wide_attrs(int kernel, int head_dim, int f32_out,
                                    int* out) {
  if (kernel < 0 || kernel > 2) return (int)cudaErrorInvalidValue;
  return (int)by_wide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (kernel == 0)
      return f32_out ? func_attrs(wide_fwd_kernel<D, true>, out)
                     : func_attrs(wide_fwd_kernel<D, false>, out);
    if (kernel == 1)
      return f32_out ? func_attrs(wide_dkdv_kernel<D, true>, out)
                     : func_attrs(wide_dkdv_kernel<D, false>, out);
    return f32_out ? func_attrs(wide_dq_kernel<D, true>, out)
                   : func_attrs(wide_dq_kernel<D, false>, out);
  });
}
