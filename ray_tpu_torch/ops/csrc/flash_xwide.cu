// Flash-attention forward for Hopper (sm_90a) at head_dim 257 to 1024,
// bf16 inputs, over [B, T, H, D].
//
// Replaces, for head_dim 257-1024 and bf16 inputs: ray_tpu/ops/
// flash_attention.py::_fa_kernel (the head-major forward, launched by
// _flash_forward), whose blocks span any head_dim.  It computes what
// flash_fwd.cu and flash_wide.cu compute, under the same contract: the
// causal mask aligned top-left, f32 LSE, P rounded to bf16 before P V, a
// row with no visible key giving O = 0 and LSE = -1e30; O in bf16 or, the
// chunk mode of ring attention (F32O), in f32 from bf16 inputs.  dK/dV and
// dQ above 256 run on flash_xwide_bwd.cu; f32 inputs above 128 on
// flash_fma.cu (the forward) and flash_fma_bwd.cu.
//
// Bound: at [8, 1024, 16, 512] causal the forward does 4 * D flops per
// visible (query, key) pair (138 GFLOP, 139 us at 989 TFLOP/s) against 537
// MB of q, k, v, o (160 us at 3.35 TB/s); at 1024, 275 GFLOP (278 us)
// against 1.07 GB (320 us).  The two bounds meet, so, as at 128 and 256,
// the design keeps the tensor cores fed and every [T, T] intermediate out
// of device memory.
//
// A file of its own: flash_wide.cu's tiling is spent at 256.  At D = 512
// one warpgroup cannot hold O: its 64 rows are 256 f32 a thread, over the
// 255-register limit, and wgmma's N stops at 256.  So O's columns are split
// between the two consumer warpgroups, which own the same 64 queries: each
// holds a quarter or a half of a block's columns.  Of the designs that
// split O so, this one has each consumer compute the whole S = Q K^T
// itself (no exchange between the consumers):
//  * one consumer computing S and sharing P~ through shared memory would
//    leave the other idle for half of every tile;
//  * partial scores over each consumer's own columns, added through shared
//    memory (8 KB of f32 a consumer a tile), would need a barrier a tile
//    and double-buffered scratch that the tiles leave no room for.
// Both consumers issue the same products on the same operands in the same
// order, so their S, P, running max and sum are bit-identical and each row
// is normalised the same way in both halves of O; consumer 0 writes the
// LSE.
//
// Above 512 (the 768 and 1024 builds) two consumers cannot hold O's whole
// width either (512-1024 f32 a thread), so the grid splits O's columns
// into two groups of D / 2, a block each (work_group_tiles_adjacent: a
// query tile's two groups adjacent, then a head's tiles, so they read
// their K tiles from L2).  Every block computes the whole S with the same
// products in the same order, so every group normalises its columns as the
// other does; group 0 writes the LSE.  A block loads Q and K across the
// whole head_dim (S contracts over it) and V only over its group's boxes.
// Flops: each pair costs 2 D for S in each of the four consumers of a
// query tile and 2 D for P V, 10 D against the 4 D of the work (2.5x);
// 1.5x (6 D) at 384 and 512.
//
// Tiles: 64 queries a block (the rows both consumers share) and 32 keys a
// tile.  Shared memory at 512: Q 64 KB (O's staging tile too, as in
// flash_wide.cu) + 2 stages x (K 32 KB + V 32 KB) = 192 KB; at 384: Q 48
// KB + 3 stages x 48 KB = 192 KB; at 1024: Q 128 KB + one stage of K 64 KB
// + V 32 KB = 224 KB; at 768: Q 96 KB + one stage of 48 + 24 KB = 168 KB.
// With one stage the producer loads a tile's K once both consumers' S of
// the last tile is done, and its V once their P V of it is, so those loads
// are not hidden behind a second stage; 16-key tiles, which leave room for
// two at 1024, ran 13-23% slower on an H100 (scripts/
// compare_kernels_torch.py): their S products (N = 16) read Q's 2 KB from
// shared memory for every 16 keys, twice as often.  A consumer thread
// holds O (96 or 128 f32), S (16 f32) and P as bf16 A fragments (8).  A
// producer warpgroup (setmaxnreg 24) whose one thread loads Q once and
// streams K/V tiles through the stages by TMA; two consumer warpgroups
// (setmaxnreg 240) that take turns on named barriers, as flash_wide.cu's
// forward does: in its turn a consumer issues the previous tile's O += P~
// V over its columns (one RS m64n{192,256}k16 per 16 keys, V read MN-major
// across its three or four boxes) and this tile's S (D / 16 m64n32k16,
// both operands K-major), so one's softmax runs while the other's
// products do.
//
// Builds for D = 384, 512, 768 and 1024 (6 to 16 boxes of 64 columns);
// any multiple of 8 from 264 to 1024 runs on the next of them, its columns
// past head_dim zeros.  TMA fills a box's columns past head_dim with zeros
// on load and clips them on store; the boxes that lie wholly past head_dim
// (at 264-320 on the 384 build, 392-448 on 512, 520-704 on 768, 776-960 on
// 1024) are never loaded or stored: they are zeroed once in shared memory
// at the start, so they add nothing to S, and the O columns they give are
// never written.
//
// Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace hp = hopper;

constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kXThreads = 3 * kWg;     // consumers 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64, kBN = 32;  // query rows, keys per tile
constexpr int kTurnBar = 3;  // named barriers 3 + w: consumer w's turn
constexpr int kDoneBar = 5;  // both consumers' last S done: Q is free

// Built for D = 384, 512, 768 and 1024: fn(HeadDim<D>{}) for the smallest
// at or above head_dim, a multiple of 8 from 264 to 1024 (its extra
// columns zeros); any other size is cudaErrorInvalidValue.
template <typename Fn>
cudaError_t by_xwide_head_dim(int head_dim, Fn&& fn) {
  if (head_dim <= 256 || head_dim > 1024 || head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  if (head_dim <= 384) return fn(HeadDim<384>{});
  if (head_dim <= 512) return fn(HeadDim<512>{});
  if (head_dim <= 768) return fn(HeadDim<768>{});
  return fn(HeadDim<1024>{});
}

// The build's tiling and shared memory: the Q buffer (O's staging tile
// too), the stages (K over the whole head_dim, then V over the group's
// boxes), the mbarriers.
template <int D>
struct XwideFwdSmem {
  using L = hp::Swz<D>;
  static constexpr int kGroups = D > 512 ? 2 : 1;  // of O's columns, grid
  static constexpr int kStages = D > 512 ? 1 : D == 512 ? 2 : 3;
  static constexpr int kGBoxes = L::kBoxes / kGroups;  // V, O boxes a block
  static constexpr int kHalf = kGBoxes / 2;  // boxes of O a consumer owns
  static constexpr uint32_t kQBox = kBM * L::kRowBytes;
  static constexpr uint32_t kKVBox = kBN * L::kRowBytes;
  static constexpr uint32_t kQ = L::kBoxes * kQBox;
  static constexpr uint32_t kK = L::kBoxes * kKVBox;  // one K tile
  static constexpr uint32_t kV = kGBoxes * kKVBox;    // one V tile
  static constexpr uint32_t kStage = kK + kV;
  static constexpr uint32_t kBars = kQ + kStages * kStage;
  // Q full; K full, V full, K empty, V empty per stage
  static constexpr int kNumBars = 1 + 4 * kStages;
  // + 1024: the base is aligned up to the swizzle's 1024 bytes
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

// F32O: O in f32 through o32 (omap unused), else in bf16 through omap.
template <int D, bool F32O>
__global__ void __launch_bounds__(kXThreads, 1)
xwide_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap,
                 float* __restrict__ lse, float* __restrict__ o32,
                 int heads, int dim, int tq, int tk, float scale,
                 int causal) {
  using L = hp::Swz<D>;
  using SM = XwideFwdSmem<D>;
  constexpr int BM = kBM, BN = kBN, NS = SM::kStages;
  constexpr int NC = SM::kHalf * L::kCols;  // O columns a consumer owns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + SM::kQ;  // stage i: K, then V
  const uint32_t bars = q_s + SM::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int i) { return bars + 8 * (1 + i); };
  auto v_full = [&](int i) { return bars + 8 * (1 + NS + i); };
  auto k_empty = [&](int i) { return bars + 8 * (1 + 2 * NS + i); };
  auto v_empty = [&](int i) { return bars + 8 * (1 + 3 * NS + i); };

  const int tid = threadIdx.x, wg = tid / kWg;
  const GroupWork w = work_group_tiles_adjacent(SM::kGroups);
  const int b = w.bh / heads, h = w.bh % heads, m0 = w.tile * BM;
  // the key loop stops at the diagonal
  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  // boxes with a column below head_dim: TMA fills these, the rest of
  // every tile stays zero; of V's, those of this block's group (from
  // box v0 on)
  const int n_box = (dim + L::kCols - 1) / L::kCols;
  const int v0 = w.group * SM::kGBoxes;
  const int n_vbox = min(max(n_box - v0, 0), SM::kGBoxes);

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      hp::mbar_init(k_full(i), 1);
      hp::mbar_init(v_full(i), 1);
      hp::mbar_init(k_empty(i), 2 * kWg);
      hp::mbar_init(v_empty(i), 2 * kWg);
    }
    hp::fence_barrier_init();
  }
  if (n_box < L::kBoxes) {
    for (uint32_t a = n_box * SM::kQBox + 4 * tid; a < SM::kQ;
         a += 4 * kXThreads)
      hp::st_shared(q_s + a, 0u);
    for (int i = 0; i < NS; ++i) {  // K and V of every stage
      const uint32_t st = kv_s + i * SM::kStage;
      for (uint32_t a = n_box * SM::kKVBox + 4 * tid; a < SM::kK;
           a += 4 * kXThreads)
        hp::st_shared(st + a, 0u);
      for (uint32_t a = n_vbox * SM::kKVBox + 4 * tid; a < SM::kV;
           a += 4 * kXThreads)
        hp::st_shared(st + SM::kK + a, 0u);
    }
    hp::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    hp::regs_dec<24>();
    if (tid != 2 * kWg) return;
    hp::mbar_arrive_tx(q_full, n_box * SM::kQBox);
    for (int bx = 0; bx < n_box; ++bx)
      hp::tma_load(q_s + bx * SM::kQBox, &qmap, q_full, bx * L::kCols, h, m0,
                   b);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      const uint32_t free_parity = ((it / NS) & 1) ^ 1;
      const uint32_t ks = kv_s + st * SM::kStage;
      hp::mbar_wait(k_empty(st), free_parity);
      hp::mbar_arrive_tx(k_full(st), n_box * SM::kKVBox);
      for (int bx = 0; bx < n_box; ++bx)
        hp::tma_load(ks + bx * SM::kKVBox, &kmap, k_full(st), bx * L::kCols,
                     h, it * BN, b);
      hp::mbar_wait(v_empty(st), free_parity);
      hp::mbar_arrive_tx(v_full(st), n_vbox * SM::kKVBox);
      for (int bx = 0; bx < n_vbox; ++bx)
        hp::tma_load(ks + SM::kK + bx * SM::kKVBox, &vmap, v_full(st),
                     (v0 + bx) * L::kCols, h, it * BN, b);
    }
    return;
  }

  // consumer warpgroup wg: all 64 query rows, O columns of the group's
  // boxes [c0, c0 + kHalf) (boxes v0 + c0 ... of the head)
  hp::regs_inc<240>();
  const int warp = (tid % kWg) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const float sl2 = scale * kLog2e;  // log2 units, scale > 0
  const int c0 = wg * SM::kHalf;
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  // O: element 4c + 2i + e is (row[i], column (v0 + c0) kCols + 8c + 2t +
  // e)
  float o[NC / 2];
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) o[e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // raw score units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the sum
  // S: element 4j + e is (row[e >> 1], key n0 + 8j + 2t + (e & 1)).  P:
  // the S accumulators of 8-key groups 2kk and 2kk+1, rounded to bf16, are
  // the wgmma A fragment of key slice kk.
  float s[BN / 2];
  uint32_t pa[BN / 16][4];

  // Turns, as in flash_wide.cu's forward: consumer 0 takes the first; both
  // take one turn per key tile plus one.  In a turn: P~ V of tile it - 1
  // and S = Q K^T of tile it, as the flags say; then wait for both and
  // release what they read.
  if (wg == 1) hp::named_arrive(kTurnBar, 2 * kWg);
  auto turn = [&](int it, auto with_pv, auto with_s) {
    constexpr bool kPV = decltype(with_pv)::value;
    constexpr bool kS = decltype(with_s)::value;
    const int prev = kPV ? it - 1 : 0;
    const uint32_t ks = kv_s + (it % NS) * SM::kStage;
    const uint32_t vs = kv_s + (prev % NS) * SM::kStage + SM::kK;
    if constexpr (kS) hp::mbar_wait(k_full(it % NS), (it / NS) & 1);
    if constexpr (kPV) hp::mbar_wait(v_full(prev % NS), (prev / NS) & 1);
    hp::named_sync(kTurnBar + wg, 2 * kWg);
    hp::wgmma_fence();
    if constexpr (kPV) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hp::mma_rs<NC>(o, pa[kk],
                       hp::desc_mn<D>(vs + c0 * SM::kKVBox +
                                          kk * 16 * L::kRowBytes,
                                      SM::kKVBox));
    }
    if constexpr (kS) {
      // KU k-steps unrolled at a time: all of them up to 512; above, 8, so
      // that ptxas does not keep every step's descriptors live (the whole
      // loop unrolled spilled 152 bytes at 1024 with 16-key tiles)
      constexpr int KU = D > 512 ? 8 : D / 16;
#pragma unroll 1
      for (int k0 = 0; k0 < D / 16; k0 += KU) {
#pragma unroll
        for (int ku = 0; ku < KU; ++ku) {
          const int kk = k0 + ku;
          const int bx = kk / L::kKSteps, kb = (kk % L::kKSteps) * 32;
          hp::mma_ss<BN>(s, hp::desc_k<D>(q_s + bx * SM::kQBox + kb),
                         hp::desc_k<D>(ks + bx * SM::kKVBox + kb), kk > 0);
        }
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
    if constexpr (kS) hp::mbar_arrive(k_empty(it % NS));
  };

  // The online softmax of tile it's scores, as in flash_wide.cu.
  auto softmax = [&](int it) {
    const int n0 = it * BN;
    const bool masked = n0 + BN > tk || (causal && n0 + BN - 1 > m0);
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
      for (int c = 0; c < NC / 8; ++c) {
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

  hp::mbar_wait(q_full, 0);
  turn(0, std::false_type{}, std::true_type{});
  softmax(0);
  for (int it = 1; it < n_tiles; ++it) {
    turn(it, std::true_type{}, std::true_type{});
    softmax(it);
  }
  turn(n_tiles, std::true_type{}, std::false_type{});
  // consumer 1's arrival after its last turn
  if (wg == 0) hp::named_sync(kTurnBar, 2 * kWg);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    inv[i] = 1.f / l_safe;
    if (wg == 0 && w.group == 0 && t == 0 && row[i] < tq)
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
      for (int c = 0; c < NC / 8; ++c) {
        const int col = (v0 + c0) * L::kCols + 8 * c + 2 * t;
        if (col < dim)  // dim is a multiple of 8: col + 1 < dim too
          *reinterpret_cast<float2*>(orow + col) = make_float2(
              o[4 * c + 2 * i] * inv[i], o[4 * c + 2 * i + 1] * inv[i]);
      }
    }
  } else {
    // O / l over this consumer's boxes of Q once neither consumer reads Q
    // again, out by TMA (boxes wholly past head_dim are not stored, and
    // rows past tq are not written)
    hp::named_sync(kDoneBar, 2 * kWg);
#pragma unroll
    for (int c = 0; c < NC / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        hp::st_shared(q_s + (c0 + c / 8) * SM::kQBox +
                          hp::swizzled<D>(warp * 16 + g + 8 * i,
                                          8 * (c % 8) + 2 * t),
                      pack_f32(o[4 * c + 2 * i] * inv[i],
                               o[4 * c + 2 * i + 1] * inv[i]));
    hp::fence_proxy_async();
    hp::named_sync(1 + wg, kWg);
    if (tid % kWg == 0) {
      for (int bx = c0; bx < c0 + SM::kHalf && bx < n_vbox; ++bx)
        hp::tma_store(&omap, q_s + bx * SM::kQBox, (v0 + bx) * L::kCols, h,
                      m0, b);
      hp::tma_commit();
      hp::tma_wait_read();
    }
  }
}

}  // namespace

// As rtt_flash_fwd (flash_fwd.cu), for bf16 inputs (dtype 1) and head_dim
// a multiple of 8 from 264 to 1024, on the build by_xwide_head_dim picks
// (above 512 with O's columns in two groups across the grid); anything
// else is cudaErrorInvalidValue.
extern "C" int rtt_flash_xwide_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int batch, int tq, int tk, int heads,
                                   int head_dim, float scale, int causal,
                                   int dtype, int out_dtype, void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype, out_dtype) || dtype != 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_xwide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    using SM = XwideFwdSmem<D>;
    const bool f32o = out_dtype == 0;
    CUtensorMap qm, km, vm, om;
    if (!hp::encode_map<D>(&qm, q, batch, tq, heads, head_dim, kBM) ||
        !hp::encode_map<D>(&km, k, batch, tk, heads, head_dim, kBN) ||
        !hp::encode_map<D>(&vm, v, batch, tk, heads, head_dim, kBN) ||
        (!f32o && !hp::encode_map<D>(&om, o, batch, tq, heads, head_dim, kBM)))
      return cudaErrorInvalidValue;
    if (f32o) om = qm;  // unused: f32 O leaves from the registers
    auto go = [&](auto kernel) {
      return launch_block(kernel,
                          dim3(batch * heads * SM::kGroups,
                               (tq + kBM - 1) / kBM),
                          kXThreads, SM::kBytes, s, qm, km, vm, om,
                          static_cast<float*>(lse), static_cast<float*>(o),
                          heads, head_dim, tq, tk, scale, causal);
    };
    return f32o ? go(xwide_fwd_kernel<D, true>)
                : go(xwide_fwd_kernel<D, false>);
  });
}

// As rtt_flash_fwd_attrs, for this forward's build at head_dim (264 to
// 1024).
extern "C" int rtt_flash_xwide_attrs(int head_dim, int f32_out, int* out) {
  return (int)by_xwide_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return f32_out ? func_attrs(xwide_fwd_kernel<D, true>, out)
                   : func_attrs(xwide_fwd_kernel<D, false>, out);
  });
}
