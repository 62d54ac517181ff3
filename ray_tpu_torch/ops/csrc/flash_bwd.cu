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
// dK/dV: one block per (batch * head, 64-key tile); the Q tiles are walked
// by a loop inside the block (the TPU's sequential grid axis).  With causal
// the loop starts at the Q tile holding the block's first key, so tiles
// entirely above the diagonal are never loaded; only the straddling tile
// and the ragged end are masked.  Each of four warps owns 16 keys and
// computes the transposed scores S^T = K Q^T and dP^T = V dO^T: their
// mma.sync accumulators are already the A-fragment layout of
// dV += P~^T dO and dK += dS~^T Q (the trick flash_fwd.cu uses for P V), so
// P and dS never leave registers.  LSE and delta are per query, a column
// here: they are staged in shared memory per Q tile.  K and V stay in
// shared memory and their fragments are read per use, because at D = 128
// the registers go to the two 16 x 128 f32 accumulators; the Q tile is 32
// queries for the same reason.  dK and dV are written once, in the input
// dtype.
//
// dQ: one block per (batch * head, 64-query tile), looping over K tiles up
// to the diagonal.  Each warp owns 16 queries: S = Q K^T, P, dP = dO V^T
// and dS in registers, then dQ += dS~ K with K read column-wise from shared
// memory the way flash_fwd.cu reads V.  dQ is accumulated in registers
// across the loop and written once.
//
// bf16 runs on mma.sync.m16n8k16 (bf16 inputs, f32 accumulation).  f32
// inputs take plain FMA kernels (no tensor cores, so no TF32 rounding) for
// the tight comparison with the plain version and for f32 models: lane j
// of a warp scores query (dK/dV) or key (dQ) j of a 32-wide tile, and
// owns gradient columns j, j + 32, ...
//
// Head sizes: 32, 64 and 128.
//
// Simple first: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation.  Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ float clamp_lse(float x) {
  return x <= kNegInf / 2 ? 0.f : x;
}

// ---------------------------------------------------------------- bf16 --

// A fragment of the 16x16 slice at (r0, c0) of a row-major shared tile
// with row stride LD: (row g, k 0-7), (row g+8, k 0-7), (row g, k 8-15),
// (row g+8, k 8-15).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * LD + c0 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (k = rows kr..kr+1 and kr+8..kr+9, n = column dc) of a
// row-major shared tile read column-wise: B[k][n] = tile[k][n].
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile,
                                            int kr, int dc) {
  const __nv_bfloat16* p = tile + kr * LD + dc;
  b0 = pack_bf16(p[0], p[LD]);
  b1 = pack_bf16(p[8 * LD], p[9 * LD]);
}

// The 16 x 16 A fragment of key/query slice kk, from the accumulators of
// n-tiles 2kk and 2kk+1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// Copy rows [r0, r0 + ROWS) of one head (positions `rs` apart) into a
// shared tile with row stride D + 8, zero past row `limit`.
template <int D, int ROWS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int limit, size_t rs, int tid) {
  constexpr int LD = D + 8, VEC = D / 8;
  for (int c = tid; c < ROWS * VEC; c += kThreads) {
    const int r = c / VEC, cc = (c % VEC) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * rs + cc);
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = x;
  }
}

template <int D>
constexpr size_t dkdv_bf16_smem() {
  return (2 * 64 + 2 * 32) * (D + 8) * sizeof(__nv_bfloat16) +
         2 * 32 * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int heads, int tq,
                     int tk, float scale, int causal) {
  constexpr int BN = 64, BM = 32, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [BN][LD]
  __nv_bfloat16* vs = ks + BN * LD;                            // [BN][LD]
  __nv_bfloat16* qs = vs + BN * LD;                            // [BM][LD]
  __nv_bfloat16* dos = qs + BM * LD;                           // [BM][LD]
  float* lse_s = reinterpret_cast<float*>(dos + BM * LD);      // [BM]
  float* delta_s = lse_s + BM;                                 // [BM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * BN;
  const size_t rs = (size_t)heads * D;  // between positions
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const size_t koff = slice_base<D>(b, h, heads, tk);
  const float* lse_b = lse + ((size_t)b * heads + h) * tq;
  const float* delta_b = delta + ((size_t)b * heads + h) * tq;
  const int key[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};

  stage_bf16<D, BN>(ks, k + koff, n0, tk, rs, tid);
  stage_bf16<D, BN>(vs, v + koff, n0, tk, rs, tid);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  const int m_tiles = (tq + BM - 1) / BM;
  for (int mt = causal ? n0 / BM : 0; mt < m_tiles; ++mt) {
    const int m0 = mt * BM;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D, BM>(qs, q + qoff, m0, tq, rs, tid);
    stage_bf16<D, BM>(dos, dout + qoff, m0, tq, rs, tid);
    if (tid < BM) {
      const bool ok = m0 + tid < tq;
      lse_s[tid] = ok ? clamp_lse(lse_b[m0 + tid]) : 0.f;
      delta_s[tid] = ok ? delta_b[m0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys and the BM
    // queries: B[k][n] = Q[n][k], two adjacent elements of one Q row.
    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, ks, warp * 16, kk * 16, g, t);
      load_a<LD>(va, vs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        const __nv_bfloat16* qr = qs + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const __nv_bfloat16* dr = dos + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(st[nt], ka, ld32(qr), ld32(qr + 8));
        mma_bf16(dpt[nt], va, ld32(dr), ld32(dr + 8));
      }
    }

    // P^T and dS^T in place; element e of n-tile nt is (key[e >> 1],
    // query m0 + nt * 8 + t * 2 + (e & 1)).
    const bool masked = m0 + BM > tq || (causal && n0 + BN - 1 > m0);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + t * 2 + (e & 1);
        float p = expf(st[nt][e] * scale - lse_s[ql]);
        if (masked) {
          const int qpos = m0 + ql;
          if (qpos >= tq || (causal && key[e >> 1] > qpos)) p = 0.f;
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[ql]) * scale;
      }

    // dV += P~^T dO and dK += dS~^T Q: the accumulators of n-tiles 2kk and
    // 2kk+1 are the A fragment of query slice kk; dO and Q are read
    // column-wise.
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
      const int qr = kk * 16 + t * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, dos, qr, nd * 8 + g);
        mma_bf16(dva[nd], pa, b0, b1);
        load_b_cols<LD>(b0, b1, qs, qr, nd * 8 + g);
        mma_bf16(dka[nd], dsa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    __nv_bfloat16* dkr = dk + koff + key[i] * rs;
    __nv_bfloat16* dvr = dv + koff + key[i] * rs;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(dkr + nd * 8 + t * 2) =
          pack_f32(dka[nd][2 * i], dka[nd][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvr + nd * 8 + t * 2) =
          pack_f32(dva[nd][2 * i], dva[nd][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_bf16_smem() {
  return 4 * 64 * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int heads, int tq, int tk,
                   float scale, int causal) {
  constexpr int BM = 64, BN = 64, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LD]
  __nv_bfloat16* dos = qs + BM * LD;                           // [BM][LD]
  __nv_bfloat16* ks = dos + BM * LD;                           // [BN][LD]
  __nv_bfloat16* vs = ks + BN * LD;                            // [BN][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const Work w = work_longest_first();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * BM;
  const size_t rs = (size_t)heads * D;
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const size_t koff = slice_base<D>(b, h, heads, tk);
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < tq;
    const size_t idx = ((size_t)b * heads + h) * tq + row[i];
    lse_r[i] = ok ? clamp_lse(lse[idx]) : 0.f;
    delta_r[i] = ok ? delta[idx] : 0.f;
  }

  stage_bf16<D, BM>(qs, q + qoff, m0, tq, rs, tid);
  stage_bf16<D, BM>(dos, dout + qoff, m0, tq, rs, tid);

  float dqa[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;

  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D, BN>(ks, k + koff, n0, tk, rs, tid);
    stage_bf16<D, BN>(vs, v + koff, n0, tk, rs, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: B[k][n] = K[n][k] (or V), two adjacent
    // elements of one row.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, qs, warp * 16, kk * 16, g, t);
      load_a<LD>(da, dos, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const __nv_bfloat16* vr = vs + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[nt], qa, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], da, ld32(vr), ld32(vr + 8));
      }
    }

    // dS in place of S; element e of n-tile nt is (row[e >> 1], key
    // n0 + nt * 8 + t * 2 + (e & 1)).
    const bool masked = n0 + BN > tk || (causal && n0 + BN - 1 > m0);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = expf(s[nt][e] * scale - lse_r[i]);
        if (masked) {
          const int kpos = n0 + nt * 8 + t * 2 + (e & 1);
          if (kpos >= tk || (causal && kpos > row[i])) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - delta_r[i]) * scale;
      }

    // dQ += dS~ K: K read column-wise, B[k][n] = K[k][n].
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t dsa[4];
      acc_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, ks, kk * 16 + t * 2, nd * 8 + g);
        mma_bf16(dqa[nd], dsa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= tq) continue;
    __nv_bfloat16* dqr = dq + qoff + row[i] * rs;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dqr + nd * 8 + t * 2) =
          pack_f32(dqa[nd][2 * i], dqa[nd][2 * i + 1]);
  }
}

// ----------------------------------------------------------------- f32 --

// Copy rows [r0, r0 + ROWS) of one head into a shared tile with row
// stride LD, zero past row `limit`.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int limit, size_t rs,
                                          int tid) {
  for (int c = tid; c < ROWS * D; c += kThreads) {
    const int r = c / D, d = c % D;
    dst[r * LD + d] = r0 + r < limit ? src[(size_t)(r0 + r) * rs + d] : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_f32_smem() {  // ks, vs [16][D]; qs, dos [32][D + 1]
  return (2 * 16 * D + 2 * 32 * (D + 1) + 2 * 32) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int heads, int tq, int tk,
                    float scale, int causal) {
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
  const size_t rs = (size_t)heads * D;
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const size_t koff = slice_base<D>(b, h, heads, tk);
  const float* lse_b = lse + ((size_t)b * heads + h) * tq;
  const float* delta_b = delta + ((size_t)b * heads + h) * tq;

  stage_f32<D, BN, D>(ks, k + koff, n0, tk, rs, tid);
  stage_f32<D, BN, D>(vs, v + koff, n0, tk, rs, tid);

  float dka[KPW][DPL], dva[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.f;

  const int m_tiles = (tq + BM - 1) / BM;
  for (int mt = causal ? n0 / BM : 0; mt < m_tiles; ++mt) {
    const int m0 = mt * BM;
    __syncthreads();
    stage_f32<D, BM, D + 1>(qs, q + qoff, m0, tq, rs, tid);
    stage_f32<D, BM, D + 1>(dos, dout + qoff, m0, tq, rs, tid);
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
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int heads, int tq, int tk, float scale, int causal) {
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
  const size_t rs = (size_t)heads * D;
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const size_t koff = slice_base<D>(b, h, heads, tk);

  stage_f32<D, BM, D>(qs, q + qoff, m0, tq, rs, tid);
  stage_f32<D, BM, D>(dos, dout + qoff, m0, tq, rs, tid);
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
    stage_f32<D, BN, D + 1>(ks, k + koff, n0, tk, rs, tid);
    stage_f32<D, BN, D + 1>(vs, v + koff, n0, tk, rs, tid);
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
      dq[qoff + qpos * rs + lane + 32 * i] = acc[r][i];
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
                    tq, tk, scale, causal);
    return launch(bwd_dkdv_bf16_kernel<D>,
                  dim3(batch * heads, (tk + 63) / 64), dkdv_bf16_smem<D>(), s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  l, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads,
                  tq, tk, scale, causal);
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
                    static_cast<float*>(dq_out), heads, tq, tk, scale, causal);
    return launch(bwd_dq_bf16_kernel<D>,
                  dim3(batch * heads, (tq + 63) / 64), dq_bf16_smem<D>(), s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  l, dl, static_cast<bf16*>(dq_out), heads, tq, tk, scale,
                  causal);
  });
}

}  // namespace

// q, dout [B, Tq, H, D], k, v [B, Tk, H, D] contiguous; lse, delta
// [B, H, Tq] f32; dk, dv like k; head_dim 32, 64 or 128.  dtype:
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
