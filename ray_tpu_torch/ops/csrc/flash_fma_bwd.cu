// Flash-attention dK/dV and dQ for f32 inputs at head_dim 129 to 1024, on
// the FMA units (sm_90a), over [B, T, H, D].
//
// Replaces, for head_dim above 128 and f32 inputs: ray_tpu/ops/
// flash_attention.py::_fa_bwd_dkdv_kernel (dK, dV) and ::_fa_bwd_dq_kernel
// (dQ), both launched by _flash_backward.  For a key tile the first walks
// the query tiles: S = Q K^T scale, masked top-left when causal; P =
// exp(S - LSE), the LSE clamped to 0 where a row saw no key; dV += P^T dO;
// dP = dO V^T; dS = P (dP - delta) scale; dK += dS^T Q.  The second is its
// mirror, dQ += dS K over a query tile's key tiles.  Every product there
// is f32 (the casts to the f32 input dtype are no-ops), and the port holds
// its f32 kernels to 2e-5 of the plain version (chip_smoke.ROW_TOL) and an
// f32 training step to the CPU's: so, as in flash_fma.cu, every product
// here is an exact f32 FFMA (TF32 keeps about three decimal digits), and
// every sum is taken in a fixed order (no atomics, whose order changes from
// run to run).  Contract as the other backward kernels: f32 LSE and delta
// [B, H, Tq], Tq and Tk free when not causal.  f32 in, f32 out: the chunk
// mode of ring attention takes bf16 inputs, so no f32-out variant.
//
// Bound: dK/dV does 8 * D flops per visible (query, key) pair (S^T, dP^T,
// dV, dK), dQ 6 * D (S, dP, dQ), at an H100 SXM's 67 TFLOP/s (f32 FMA):
// at [8, 1024, 16, 256] causal 2.054 and 1.540 ms, against 0.20 and 0.17
// ms to move their bytes at 3.35 TB/s.  So, as the forward does, the design keeps the FMA units busy:
// each thread's operands come from shared memory in 16-byte loads (8 FMAs
// a load in the score products, 10.7 in dK/dV's accumulation at 128
// columns), and no [T, T] intermediate leaves the chip.
//
// dK/dV (fma_dkdv_kernel).  A block of 256 threads owns 64 keys of one
// (batch, head) and one group of the outputs' columns, GC = 64 or 128
// wide, and holds that group of dK and dV in registers (keys ty + 16 i,
// columns 4 tx + 64 s + e; tx = tid % 16, ty = tid / 16).  The G =
// ceil(head_dim / GC) blocks of a key tile form a thread block cluster (at
// most 8, a portable one) and walk its query tiles (64 queries; causal:
// from the diagonal on) in rounds of G, query tile r G + o of round r
// owned by group o:
//  1. the owner computes S^T = K Q^T and dP^T = V dO^T over the whole
//     head_dim, each thread a 4 x 4 micro-tile of each (keys ty + 16 i,
//     queries tx + 16 j), from 32-column chunks of K, Q, V and dO (64 rows
//     each) staged in shared memory by cp.async, and writes P^T and dS^T
//     into its shared memory (a row a query, each thread's four keys side
//     by side), one buffer of two (by round parity);
//  2. the cluster barrier: each thread arrives (release) once it wrote,
//     and waits (acquire) before it reads;
//  3. every group, for each tile of the round in order, copies the
//     owner's P^T and dS^T through distributed shared memory (its own
//     tile it reads in place) and adds dV += P^T dO and dK += dS^T Q over
//     32-query chunks of dO and Q x its GC columns.
// Why owners and not each group's share of the head_dim with the partial
// sums added (flash_fma.cu's forward, the first build of these kernels):
// dS = P (dP - delta) cancels where one key dominates a row (a causal
// query 0 sees only key 0, where dP = delta exactly), so dQ's row there is
// rounding noise, and the port holds the kernels row by row to the plain
// version (chip_smoke.row_scaled_err, floored at 1% of the tensor's RMS).
// cuBLAS, under the plain version's einsums, sums each S and dP in one FMA
// chain along the head_dim; so does an owner, so the two agree to the bit
// where the partial sums, added in another order, read up to 5e-3 (dQ) and
// 2.7e-5 (dK, at head_dim 1000) against the 2e-5 limit (H100 80GB HBM3,
// 700 W).  The
// accumulations run in the einsums' order too (queries, or keys, in turn).
// The flops stay the work's own, each tile's S and dP computed once, and a
// block reads each peer tile once (2 x 16 KB) where the partials cost G
// reads of 32 KB.  GC stops at 128: at 256, dK and dV alone would take 128
// registers a thread.
//
// dQ (fma_dq_kernel) is the mirror: a block owns 64 queries (a head's
// tiles last first, so the longest causal ones start first) and a GC = 64,
// 128 or 256 wide group of dQ in registers; the cluster walks the key tiles
// up to the diagonal in rounds, the owner computes S = Q K^T and dP = dO V^T
// and writes dS^T (each thread's rows' LSE and delta loaded once), and every
// group adds dQ += dS K over 32-key chunks of K.
//
// Buffer r & 1 is free when round r writes it: every thread of the cluster
// copied round r - 2's tiles before it arrived on round r - 1's phase,
// which the writer waited for.  A last phase keeps every block until its
// peers are done reading it.  A round's last tiles may leave groups
// without one: they arrive and wait all the same.  The group width follows
// flash_fma.cu's rule (fma_group_cols, flash_fma.cuh), at most 128 wide for
// dK/dV and 256 for dQ.
//
// Widths: those bad_fma_dim (flash_fma.cuh) accepts; granules past
// head_dim, rows past the sequence and columns past the group are zero-
// filled (src-size 0), so they add nothing to S or dP and give no output.
//
// Shared memory: dK/dV 3 ring slots x 36 KB (64 rows x 36 floats of K, Q,
// V and dO; a 32-row chunk of dO and Q takes at most 32 KB) + P^T and dS^T
// twice (2 x 64 x 68 floats a round parity) + a peer's copy = 215,040
// bytes of 232,448; dQ 4 slots + dS^T three times = 199,680.
//
// Launches on the caller's stream; allocates nothing.

#include "flash_fma.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace hp = hopper;

constexpr int kBThreads = 256;
constexpr int kBDK = 32;              // head-dim columns of a score chunk
constexpr int kBPitch = kBDK + 4;     // floats a staged score-chunk row
constexpr int kBAcc = 32;             // rows of an accumulation chunk
constexpr int kBTPitch = kFmaRows + 4;  // floats a row of P^T or dS^T
constexpr int kBT = kFmaRows * kBTPitch;  // floats of one such tile

// A kernel's shared memory: Stages ring slots, each a score chunk (K, Q, V
// and dO, or Q, K, dO and V: 64 rows x kBPitch floats each) or an
// accumulation chunk (AccOps operands of kBAcc rows x GC columns), then NT
// transposed tiles a round parity and NT for a peer's copy.
template <int GC, int Stages, int AccOps, int NT>
struct BwdSmem {
  static constexpr int kOp = kFmaRows * kBPitch;  // one staged operand
  static constexpr int kAcc = AccOps * kBAcc * GC;
  static constexpr int kSlot = 4 * kOp > kAcc ? 4 * kOp : kAcc;
  static constexpr int kStages = Stages;
  static constexpr int kOut = Stages * kSlot;  // + (r & 1) * NT * kBT
  static constexpr int kIn = kOut + 2 * NT * kBT;
  static constexpr size_t kBytes = (size_t)(kIn + NT * kBT) * 4;
  static_assert(kBytes <= 232448, "over the block's shared memory");
};
template <int GC>
using DkdvSmem = BwdSmem<GC, 3, 2, 2>;  // dO and Q chunks; P^T, dS^T
template <int GC>
using DqSmem = BwdSmem<GC, 4, 1, 1>;  // K chunks; dS^T

// Chunk `chunk` (kBDK head-dim columns) of the 64 rows at a0 of a1 and a2
// (rows at or past a_lim zero-filled) and of those at b0 of b1 and b2 into
// `slot` as [a1 | b1 | a2 | b2]; granules past dim zero-filled.  a1 b1^T
// and a2 b2^T are then the chunk's share of the scores.
__device__ __forceinline__ void stage_scores(uint32_t slot, const float* a1,
                                             const float* a2, int a0,
                                             int a_lim, const float* b1,
                                             const float* b2, int b0,
                                             int b_lim, int chunk, int dim,
                                             size_t rs) {
  constexpr uint32_t kOpBytes = 4 * kFmaRows * kBPitch;
#pragma unroll
  for (int u = 0; u < kFmaRows * kBDK / 4 / kBThreads; ++u) {
    const int e = threadIdx.x + u * kBThreads;
    const int r = e / (kBDK / 4), c = 4 * (e % (kBDK / 4));
    const int col = chunk * kBDK + c;
    const bool aok = col < dim && a0 + r < a_lim;
    const bool bok = col < dim && b0 + r < b_lim;
    const size_t ao = (size_t)(a0 + r) * rs + col;
    const size_t bo = (size_t)(b0 + r) * rs + col;
    const uint32_t at = slot + 4 * (r * kBPitch + c);
    cp_async16(at, aok ? a1 + ao : a1, aok);
    cp_async16(at + kOpBytes, bok ? b1 + bo : b1, bok);
    cp_async16(at + 2 * kOpBytes, aok ? a2 + ao : a2, aok);
    cp_async16(at + 3 * kOpBytes, bok ? b2 + bo : b2, bok);
  }
}

// p += A B^T over a staged chunk (as, bs: 64 rows x kBPitch floats), p[i][j]
// being (row ty + 16 i of A, row tx + 16 j of B): one FMA chain along the
// head_dim a score, the columns in order.
__device__ __forceinline__ void chunk_product(const float* as, const float* bs,
                                              float (&p)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < kBDK; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lds4(as + (ty + 16 * i) * kBPitch + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = lds4(bs + (tx + 16 * j) * kBPitch + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(a[i].x, b[j].x, p[i][j]);
        p[i][j] = fmaf(a[i].y, b[j].y, p[i][j]);
        p[i][j] = fmaf(a[i].z, b[j].z, p[i][j]);
        p[i][j] = fmaf(a[i].w, b[j].w, p[i][j]);
      }
  }
}

// Both products of a score chunk staged by stage_scores.
__device__ __forceinline__ void score_chunk(const float* slot,
                                            float (&p1)[4][4],
                                            float (&p2)[4][4]) {
  constexpr int kOp = kFmaRows * kBPitch;
  chunk_product(slot, slot + kOp, p1);
  chunk_product(slot + 2 * kOp, slot + 3 * kOp, p2);
}

__device__ __forceinline__ float clamp_lse(float x) {
  return x <= kNegInf / 2 ? 0.f : x;
}

// P = exp(S scale - LSE), its product rounded before the subtraction as
// the plain version rounds it (no FMA), or 0 where masked.
__device__ __forceinline__ float prob(float s, float scale, float lse,
                                      bool masked) {
  return masked ? 0.f : expf(__fmul_rn(s, scale) - lse);
}

// p[i][j] (row ty + 16 i, column tx + 16 j) into t: t[(tx + 16 j) *
// kBTPitch + 4 ty + i], a row a column of p, the thread's four rows side
// by side; then p zeroed.
__device__ __forceinline__ void store_transposed(float* t, float (&p)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(t + (tx + 16 * j) * kBTPitch + 4 * ty) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i][j] = 0.f;
  }
}

// The NT transposed tiles at `own` in block `rank` of the cluster (the same
// offset there) into `dst`: each thread's float4s loaded first, then
// stored, so the remote loads are in flight together.
template <int NT>
__device__ __forceinline__ void copy_from_peer(float* dst, const float* own,
                                               int rank) {
  constexpr int kRow4 = kFmaRows / 4;  // float4s a row
  constexpr int kPer = NT * kFmaRows * kRow4 / kBThreads;
  const uint32_t src = hp::mapa(hp::smem_u32(own), rank);
  float4 x[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kBThreads;
    const int at = e / (kFmaRows * kRow4) * kBT +
                   e / kRow4 % kFmaRows * kBTPitch + 4 * (e % kRow4);
    x[u] = hp::ld_cluster_f4(src + 4 * at);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kBThreads;
    const int at = e / (kFmaRows * kRow4) * kBT +
                   e / kRow4 % kFmaRows * kBTPitch + 4 * (e % kRow4);
    *reinterpret_cast<float4*>(dst + at) = x[u];
  }
}

// acc[i][4 s + e] += sum over the kBAcc rows n of a chunk of t's row k0 + n
// (element i of the thread's float4) times row n of x (GC columns, the
// thread's 4 tx + 64 s + e), the rows in order.
template <int GC>
__device__ __forceinline__ void accumulate(const float* t, int k0,
                                           const float* x,
                                           float (&acc)[4][GC / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int n = 0; n < kBAcc; ++n) {
    const float4 p = lds4(t + (k0 + n) * kBTPitch + 4 * ty);
    const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int sg = 0; sg < GC / 64; ++sg) {
      const float4 y = lds4(x + n * GC + 4 * tx + 64 * sg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * sg] = fmaf(pr[i], y.x, acc[i][4 * sg]);
        acc[i][4 * sg + 1] = fmaf(pr[i], y.y, acc[i][4 * sg + 1]);
        acc[i][4 * sg + 2] = fmaf(pr[i], y.z, acc[i][4 * sg + 2]);
        acc[i][4 * sg + 3] = fmaf(pr[i], y.w, acc[i][4 * sg + 3]);
      }
    }
  }
}

// Stage kBAcc rows at r0 (rows at or past `limit` zero-filled) x the GC
// columns at col0 (past dim zero-filled) of x into shared `dst`, GC floats
// a row.
template <int GC>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* x,
                                           int r0, int limit, int col0,
                                           int dim, size_t rs) {
#pragma unroll
  for (int u = 0; u < kBAcc * GC / 4 / kBThreads; ++u) {
    const int e = threadIdx.x + u * kBThreads;
    const int r = e / (GC / 4), c = 4 * (e % (GC / 4));
    const bool ok = col0 + c < dim && r0 + r < limit;
    cp_async16(dst + 4 * (r * GC + c),
               ok ? x + (size_t)(r0 + r) * rs + col0 + c : x, ok);
  }
}

// acc (rows ty + 16 i, columns 4 tx + 64 s + e of the group at col0) into
// the rows r0.. of out, the rows at or past `limit` and columns past dim
// left out (dim is a multiple of 4: a float4 is in or out whole).
template <int GC>
__device__ __forceinline__ void store_rows(float* out, int r0, int limit,
                                           int col0, int dim, size_t rs,
                                           const float (&acc)[4][GC / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= limit) continue;
#pragma unroll
    for (int sg = 0; sg < GC / 64; ++sg) {
      const int col = col0 + 4 * tx + 64 * sg;
      if (col < dim)
        *reinterpret_cast<float4*>(out + (size_t)row * rs + col) =
            make_float4(acc[i][4 * sg], acc[i][4 * sg + 1],
                        acc[i][4 * sg + 2], acc[i][4 * sg + 3]);
    }
  }
}

// The cluster's walk over its n_tiles tiles in rounds of `groups`: item it
// of a block is in round r, whose `tiles` tiles are r * groups + o, o <
// tiles; the block's first `mine` items of the round are its own tile's
// score chunks (all n_chunks, or none where the round has no tile for it),
// the 2 * tiles after them the accumulation chunks, two a tile, in order.
struct Rounds {
  int n_tiles, groups, group, n_chunks;

  __device__ __forceinline__ int full() const {
    return n_chunks + 2 * groups;
  }
  __device__ __forceinline__ int items() const {
    const int rounds = (n_tiles + groups - 1) / groups;
    if (rounds == 0) return 0;
    const int last = n_tiles - (rounds - 1) * groups;
    return (rounds - 1) * full() + (group < last ? n_chunks : 0) + 2 * last;
  }
  struct Item {
    int r, mine, idx;  // idx: the item's place in its round
  };
  __device__ __forceinline__ Item at(int it) const {
    const int r = it / full();
    const int tiles = min(groups, n_tiles - r * groups);
    return {r, group < tiles ? n_chunks : 0, it - r * full()};
  }
};

// ------------------------------------------------------------- dK/dV --

template <int GC>
__global__ void __launch_bounds__(kBThreads, 1)
fma_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int heads, int dim, int tq, int tk,
                float scale, int causal, int groups) {
  using SM = DkdvSmem<GC>;
  constexpr int BM = kFmaRows, BN = kFmaRows;  // queries a tile, keys a block
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  // + (r & 1) * 2 * kBT: this block's P^T, then dS^T, of its tile of round
  // r; `in`: a peer's, copied
  float* out = sm + SM::kOut;
  float* in = sm + SM::kIn;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the cluster is the key tile's groups (gridDim.x is a multiple of
  // groups, so blockIdx.x % groups is both the group and the rank)
  const GroupWork w = work_group_tiles_adjacent(groups);
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * BN;  // key tile 0, the longest causal one, first
  const int col0 = w.group * GC;  // the group's first output column
  const size_t rs = (size_t)heads * dim;
  const float* qb = q + slice_base(b, h, heads, tq, dim);
  const float* dob = dout + slice_base(b, h, heads, tq, dim);
  const size_t koff = slice_base(b, h, heads, tk, dim);
  const float* lse_b = lse + ((size_t)b * heads + h) * tq;
  const float* delta_b = delta + ((size_t)b * heads + h) * tq;
  // the query tiles, from the diagonal on when causal
  const int m_begin = causal ? n0 / BM : 0;
  const int m_end = (tq + BM - 1) / BM;
  const Rounds rounds{max(m_end - m_begin, 0), groups, w.group,
                      (dim + kBDK - 1) / kBDK};
  const int n_items = rounds.items();

  // Item it's copies into ring slot it % kStages, as one cp.async group
  // (empty past the last item, so the waits below count alike).
  auto issue = [&](int it) {
    if (it < n_items) {
      const Rounds::Item x = rounds.at(it);
      const uint32_t slot =
          hp::smem_u32(ring + (it % SM::kStages) * SM::kSlot);
      if (x.idx < x.mine) {
        const int m0 = (m_begin + x.r * groups + w.group) * BM;
        stage_scores(slot, k + koff, v + koff, n0, tk, qb, dob, m0, tq,
                     x.idx, dim, rs);
      } else {  // kBAcc queries of dO and of Q x the group's columns
        const int a = x.idx - x.mine;
        const int mq = (m_begin + x.r * groups + a / 2) * BM + a % 2 * kBAcc;
        stage_rows<GC>(slot, dob, mq, tq, col0, dim, rs);
        stage_rows<GC>(slot + 4 * kBAcc * GC, qb, mq, tq, col0, dim, rs);
      }
    }
    cp_commit();
  };

  float acc_v[4][GC / 16], acc_k[4][GC / 16];  // dV, dK: as store_rows
  float st[4][4], dpt[4][4];  // S^T, dP^T: (key ty + 16 i, query tx + 16 j)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll
    for (int e = 0; e < GC / 16; ++e) acc_v[i][e] = acc_k[i][e] = 0.f;
  }

  // Item it waits for its slot, frees the slot item it - 1 read (the
  // barrier), refills it with item it + kStages - 1, and runs: a score
  // chunk of the block's own tile (the last one writes P^T and dS^T and
  // arrives) or an accumulation chunk (the round's first waits).
  for (int it = 0; it < SM::kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_items; ++it) {
    cp_wait<SM::kStages - 2>();
    __syncthreads();
    issue(it + SM::kStages - 1);
    const float* slot = ring + (it % SM::kStages) * SM::kSlot;
    const Rounds::Item x = rounds.at(it);
    float* mine = out + (x.r & 1) * 2 * kBT;
    if (x.idx < x.mine) {
      score_chunk(slot, st, dpt);
      if (x.idx == x.mine - 1) {
        const int m0 = (m_begin + x.r * groups + w.group) * BM;
        float lse_q[4], delta_q[4];  // of queries m0 + tx + 16 j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = m0 + tx + 16 * j;
          lse_q[j] = qpos < tq ? clamp_lse(lse_b[qpos]) : 0.f;
          delta_q[j] = qpos < tq ? delta_b[qpos] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kpos = n0 + ty + 16 * i, qpos = m0 + tx + 16 * j;
            const float p =
                prob(st[i][j], scale, lse_q[j],
                     qpos >= tq || kpos >= tk || (causal && kpos > qpos));
            st[i][j] = p;
            dpt[i][j] = p * (dpt[i][j] - delta_q[j]) * scale;
          }
        store_transposed(mine, st);
        store_transposed(mine + kBT, dpt);
        if (groups > 1) hp::cluster_arrive();
      }
    } else {
      const int a = x.idx - x.mine, o = a / 2;
      if (a == 0 && groups > 1) {  // every tile of the round is written
        if (x.mine == 0) hp::cluster_arrive();
        hp::cluster_wait();
      }
      const float* t = mine;
      if (o != w.group) {
        t = in;
        if (a % 2 == 0) {
          copy_from_peer<2>(in, mine, o);
          __syncthreads();
        }
      }
      accumulate<GC>(t, a % 2 * kBAcc, slot, acc_v);
      accumulate<GC>(t + kBT, a % 2 * kBAcc, slot + kBAcc * GC, acc_k);
    }
  }
  cp_wait<0>();

  store_rows<GC>(dk + koff, n0, tk, col0, dim, rs, acc_k);
  store_rows<GC>(dv + koff, n0, tk, col0, dim, rs, acc_v);
  // no block leaves while a peer may still read its tiles
  if (groups > 1) hp::cluster_sync();
}

// ---------------------------------------------------------------- dQ --

template <int GC>
__global__ void __launch_bounds__(kBThreads, 1)
fma_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int heads, int dim, int tq, int tk,
              float scale, int causal, int groups) {
  using SM = DqSmem<GC>;
  constexpr int BM = kFmaRows, BN = kFmaRows;  // queries a block, keys a tile
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  // + (r & 1) * kBT: this block's dS^T (a row a key) of its tile of round
  // r; `in`: a peer's, copied
  float* out = sm + SM::kOut;
  float* in = sm + SM::kIn;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the cluster is the query tile's groups
  const GroupWork w = work_group_tiles_adjacent(groups);
  const int b = w.bh / heads, h = w.bh % heads;
  // a head's query tiles last first: the longest causal ones start first
  const int m0 = (gridDim.y - 1 - w.tile) * BM;
  const int col0 = w.group * GC;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const float* kb = k + slice_base(b, h, heads, tk, dim);
  const float* vb = v + slice_base(b, h, heads, tk, dim);
  // the key loop stops at the diagonal
  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  const Rounds rounds{n_tiles, groups, w.group, (dim + kBDK - 1) / kBDK};
  const int n_items = rounds.items();

  auto issue = [&](int it) {
    if (it < n_items) {
      const Rounds::Item x = rounds.at(it);
      const uint32_t slot =
          hp::smem_u32(ring + (it % SM::kStages) * SM::kSlot);
      if (x.idx < x.mine) {
        const int n0 = (x.r * groups + w.group) * BN;
        stage_scores(slot, q + qoff, dout + qoff, m0, tq, kb, vb, n0, tk,
                     x.idx, dim, rs);
      } else {  // kBAcc keys of K x the group's columns
        const int a = x.idx - x.mine;
        stage_rows<GC>(slot, kb, (x.r * groups + a / 2) * BN + a % 2 * kBAcc,
                       tk, col0, dim, rs);
      }
    }
    cp_commit();
  };

  // this thread's rows' LSE (clamped) and delta: queries m0 + ty + 16 i
  float lse_r[4], delta_r[4];
  const size_t stat = ((size_t)b * heads + h) * tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = m0 + ty + 16 * i;
    lse_r[i] = qpos < tq ? clamp_lse(lse[stat + qpos]) : 0.f;
    delta_r[i] = qpos < tq ? delta[stat + qpos] : 0.f;
  }
  float acc[4][GC / 16];  // dQ: as store_rows
  float s[4][4], dp[4][4];  // S, dP: (query ty + 16 i, key tx + 16 j)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int e = 0; e < GC / 16; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < SM::kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_items; ++it) {
    cp_wait<SM::kStages - 2>();
    __syncthreads();
    issue(it + SM::kStages - 1);
    const float* slot = ring + (it % SM::kStages) * SM::kSlot;
    const Rounds::Item x = rounds.at(it);
    float* mine = out + (x.r & 1) * kBT;
    if (x.idx < x.mine) {
      score_chunk(slot, s, dp);
      if (x.idx == x.mine - 1) {
        const int n0 = (x.r * groups + w.group) * BN;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qpos = m0 + ty + 16 * i, kpos = n0 + tx + 16 * j;
            const float p =
                prob(s[i][j], scale, lse_r[i],
                     qpos >= tq || kpos >= tk || (causal && kpos > qpos));
            dp[i][j] = p * (dp[i][j] - delta_r[i]) * scale;
            s[i][j] = 0.f;
          }
        store_transposed(mine, dp);
        if (groups > 1) hp::cluster_arrive();
      }
    } else {
      const int a = x.idx - x.mine, o = a / 2;
      if (a == 0 && groups > 1) {
        if (x.mine == 0) hp::cluster_arrive();
        hp::cluster_wait();
      }
      const float* t = mine;
      if (o != w.group) {
        t = in;
        if (a % 2 == 0) {
          copy_from_peer<1>(in, mine, o);
          __syncthreads();
        }
      }
      accumulate<GC>(t, a % 2 * kBAcc, slot, acc);
    }
  }
  cp_wait<0>();

  store_rows<GC>(dq + qoff, m0, tq, col0, dim, rs, acc);
  if (groups > 1) hp::cluster_sync();
}

// ---------------------------------------------------------- launchers --

// fn(GroupCols<GC>{}) for dK/dV's group width (at most 128) at this
// shape (items: its key tiles), or dQ's (at most 256; its query tiles).
template <typename Fn>
cudaError_t by_dkdv_group_cols(int batch, int tk, int heads, int head_dim,
                               Fn&& fn) {
  return by_group_cols<128>(
      (long)batch * heads * ((tk + kFmaRows - 1) / kFmaRows), head_dim, fn);
}
template <typename Fn>
cudaError_t by_dq_group_cols(int batch, int tq, int heads, int head_dim,
                             Fn&& fn) {
  return by_group_cols<256>(
      (long)batch * heads * ((tq + kFmaRows - 1) / kFmaRows), head_dim, fn);
}

template <int GC>
cudaError_t init_dkdv(ClusterLaunch& l, int batch, int tk, int heads,
                      int head_dim, cudaStream_t s) {
  return l.init(fma_dkdv_kernel<GC>, GC, batch * heads,
                (tk + kFmaRows - 1) / kFmaRows, head_dim,
                DkdvSmem<GC>::kBytes, s);
}
template <int GC>
cudaError_t init_dq(ClusterLaunch& l, int batch, int tq, int heads,
                    int head_dim, cudaStream_t s) {
  return l.init(fma_dq_kernel<GC>, GC, batch * heads,
                (tq + kFmaRows - 1) / kFmaRows, head_dim, DqSmem<GC>::kBytes,
                s);
}

bool bad_bwd_args(int batch, int tq, int tk, int heads, int head_dim, int dtype,
         int out_dtype) {
  return bad_args(batch, tq, tk, heads, dtype, out_dtype) || dtype != 0 ||
         bad_fma_dim(head_dim);
}

}  // namespace

// As rtt_flash_bwd_dkdv (flash_bwd.cu), for f32 inputs and outputs (dtype
// and out_dtype 0) and head_dim a multiple of 4 from 132 to 1024; anything
// else is cudaErrorInvalidValue.
extern "C" int rtt_flash_fma_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int tq,
                                      int tk, int heads, int head_dim,
                                      float scale, int causal, int dtype,
                                      int out_dtype, void* stream) {
  if (bad_bwd_args(batch, tq, tk, heads, head_dim, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_dkdv_group_cols(batch, tk, heads, head_dim, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    ClusterLaunch l;
    cudaError_t e = init_dkdv<GC>(l, batch, tk, heads, head_dim, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(
        &l.cfg, fma_dkdv_kernel<GC>, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk),
        static_cast<float*>(dv), heads, head_dim, tq, tk, scale, causal,
        l.groups);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// As rtt_flash_bwd_dq (flash_bwd.cu), with rtt_flash_fma_bwd_dkdv's
// limits.
extern "C" int rtt_flash_fma_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int batch, int tq, int tk,
                                    int heads, int head_dim, float scale,
                                    int causal, int dtype, int out_dtype,
                                    void* stream) {
  if (bad_bwd_args(batch, tq, tk, heads, head_dim, dtype, out_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_dq_group_cols(batch, tq, heads, head_dim, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    ClusterLaunch l;
    cudaError_t e = init_dq<GC>(l, batch, tq, heads, head_dim, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(
        &l.cfg, fma_dq_kernel<GC>, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), heads,
        head_dim, tq, tk, scale, causal, l.groups);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// The kernel (0 = dK/dV, 1 = dQ) a launch at (batch, tq, tk, heads,
// head_dim) takes: out[0] registers per thread, out[1] static shared
// bytes, out[2] the dynamic shared bytes its launch sets, out[3] its group
// width GC, out[4] how many of its clusters the card holds at once, out[5]
// how many clusters the launch has (one a key tile in dK/dV, a query tile
// in dQ).
extern "C" int rtt_flash_fma_bwd_attrs(int kernel, int batch, int tq, int tk,
                                       int heads, int head_dim, int* out) {
  if (bad_bwd_args(batch, tq, tk, heads, head_dim, 0, 0) ||
      (kernel != 0 && kernel != 1))
    return (int)cudaErrorInvalidValue;
  auto attrs = [&](ClusterLaunch& l, auto kern, int gc) {
    cudaError_t e = func_attrs(kern, out);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&out[4], kern, &l.cfg);
    out[3] = gc;
    out[5] = l.clusters();
    return e;
  };
  if (kernel == 0)
    return (int)by_dkdv_group_cols(batch, tk, heads, head_dim, [&](auto gc) {
      constexpr int GC = decltype(gc)::value;
      ClusterLaunch l;
      const cudaError_t e = init_dkdv<GC>(l, batch, tk, heads, head_dim,
                                          nullptr);
      return e != cudaSuccess ? e : attrs(l, fma_dkdv_kernel<GC>, GC);
    });
  return (int)by_dq_group_cols(batch, tq, heads, head_dim, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    ClusterLaunch l;
    const cudaError_t e = init_dq<GC>(l, batch, tq, heads, head_dim, nullptr);
    return e != cudaSuccess ? e : attrs(l, fma_dq_kernel<GC>, GC);
  });
}
