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
// Design.  One block per (batch * head, 64-query tile); the K/V tiles are
// walked by a loop inside the block (the TPU's sequential grid axis), and
// with causal the loop stops at the diagonal, so tiles above it are never
// loaded.  Only the tile straddling the diagonal (or the ragged end of the
// sequence) is masked.  The TPU kernels' 128-lane head packing, their DMA
// index clamps and the head-major wrapper's transposes are TPU matters:
// the kernel reads [B, T, H, D] by strides.
//
// bf16: four warps, each owning 16 query rows.  Q lives in registers as
// mma.sync A fragments for the whole loop; each 64-key K/V tile is staged
// in shared memory (rows padded by 16 bytes: conflict-free fragment
// reads).  S = Q K^T and O += P V are mma.sync.m16n8k16 with bf16 inputs
// and f32 accumulation; the S accumulator is already in the A-fragment
// layout of the P V product, so P never leaves registers.  P is rounded to
// V's dtype before P V, as the TPU kernels do (p.astype(v.dtype)); the
// running max, running sum and O accumulator stay f32.
//
// f32: a plain FMA kernel (no tensor cores, so no TF32 rounding): four
// warps, each owning 4 query rows; lane j scores key j of a 32-key tile,
// the softmax statistics are warp reductions, and lane j owns output
// columns j, j + 32, ...  It exists for the tight comparison with the
// plain version and for f32 models; bf16 is the serving path.
//
// Head sizes: 32, 64 and 128.
//
// Simple first: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation.  Launches on the caller's stream; allocates nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------- bf16 --

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int heads, int tq, int tk, float scale, int causal) {
  constexpr int BM = 64, BN = 64, LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BN][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BN][LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * BM;
  const size_t rs = (size_t)heads * D;  // between positions
  const size_t qoff = slice_base<D>(b, h, heads, tq);
  const __nv_bfloat16* qb = q + qoff;
  const __nv_bfloat16* kb = k + slice_base<D>(b, h, heads, tk);
  const __nv_bfloat16* vb = v + slice_base<D>(b, h, heads, tk);
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  // Q as A fragments: [kk][0..3] = (row g, k 0-7), (row g+8, k 0-7),
  // (row g, k 8-15), (row g+8, k 8-15) of the kk-th 16-wide slice.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row[i] < tq;
      qa[kk][i] = ok ? ld32(qb + row[i] * rs + c) : 0u;
      qa[kk][i + 2] = ok ? ld32(qb + row[i] * rs + c + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BN * D / 8; c += kThreads) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (n0 + r < tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (n0 + r) * rs + cc);
        vv = *reinterpret_cast<const uint4*>(vb + (n0 + r) * rs + cc);
      }
      *reinterpret_cast<uint4*>(&ks[r][cc]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][cc]) = vv;
    }
    __syncthreads();

    // S = Q K^T: B[k][n] = K[n][k], so a B fragment is two adjacent
    // elements of one K row.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    const bool masked = n0 + BN > tk || (causal && n0 + BN - 1 > m0);
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (masked) {
          const int kpos = n0 + nt * 8 + t * 2 + (e & 1);
          if (kpos >= tk || (causal && kpos > row[e >> 1])) x = kNegInf;
        }
        s[nt][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads t = 0..3 hold one row between them
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr =
          m_run[i] <= kNegInf / 2 ? 0.f : expf(m_run[i] - safe);
      m_run[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        // a masked score exp(-1e30 - safe) underflows to exactly 0
        const float p0 = expf(s[nt][2 * i] - safe);
        const float p1 = expf(s[nt][2 * i + 1] - safe);
        s[nt][2 * i] = p0;
        s[nt][2 * i + 1] = p1;
        psum += p0 + p1;
      }
      l_run[i] = l_run[i] * corr + psum;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][2 * i] *= corr;
        acc[nd][2 * i + 1] *= corr;
      }
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of key slice kk; B[k][n] = V[k][n] is read column-wise.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kr = kk * 16 + t * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int dc = nd * 8 + g;
        mma_bf16(acc[nd], pa, pack_bf16(vs[kr][dc], vs[kr + 1][dc]),
                 pack_bf16(vs[kr + 8][dc], vs[kr + 9][dc]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= tq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + qoff + row[i] * rs;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + t * 2) =
          pack_f32(acc[nd][2 * i] / l_safe, acc[nd][2 * i + 1] / l_safe);
    if (t == 0)
      lse[((size_t)b * heads + h) * tq + row[i]] =
          m_run[i] <= kNegInf / 2 ? kNegInf : m_run[i] + logf(l_safe);
  }
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
  using bf16 = __nv_bfloat16;
  return (int)by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(flash_fwd_f32_kernel<D>,
                    dim3(batch * heads, (tq + 15) / 16), 0, s,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), l,
                    heads, tq, tk, scale, causal);
    return launch(flash_fwd_bf16_kernel<D>,
                  dim3(batch * heads, (tq + 63) / 64), 0, s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), l, heads,
                  tq, tk, scale, causal);
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
