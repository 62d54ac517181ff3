// Flash-attention forward for Hopper (sm_90a), native [B, T, H, D] layout.
//
// Replaces: ray_tpu/ops/flash_attention.py::_fa_nl_kernel (Pallas,
// launched by _flash_nl_forward).  Computes O = softmax(scale * Q K^T) V
// with the causal mask aligned top-left (key k visible to query q iff
// k <= q), online softmax in f32, and the row log-sum-exp
// LSE = m + log(l).  A row with no visible key gives O = 0 and
// LSE = -1e30, as the TPU kernel's epilogue does.
//
// Bound: at the Llama-2-7B prefill shape [4, 1024, 32, 128] bf16 causal
// the two bounds nearly meet: 134 MB of q/k/v/o (each read or written
// once), ~40 us at 3.35 TB/s, and 4 * D flops per visible (query, key)
// pair, ~34 GFLOP, ~35 us at 989 TFLOP/s.  Longer sequences are
// operation-bound (flops grow as T^2, bytes as T), so the design keeps
// the tensor cores fed and every intermediate out of device memory.
//
// Design.  One block per (64-query tile, batch * head); the K/V tiles are
// walked by a loop inside the block (the TPU's sequential grid axis), and
// with causal the loop stops at the diagonal, so tiles above it are never
// loaded.  Only the tile straddling the diagonal (or the ragged end of the
// sequence) is masked.  The TPU kernel's 128-lane head packing and its DMA
// index clamps are TPU workarounds and have no counterpart here: the
// kernel reads [B, T, H, D] by strides.
//
// bf16: four warps, each owning 16 query rows.  Q lives in registers as
// mma.sync A fragments for the whole loop; each 64-key K/V tile is staged
// in shared memory (rows padded by 16 bytes: conflict-free fragment
// reads).  S = Q K^T and O += P V are mma.sync.m16n8k16 with bf16 inputs
// and f32 accumulation; the S accumulator is already in the A-fragment
// layout of the P V product, so P never leaves registers.  P is rounded to
// V's dtype before P V, as the TPU kernel does (p.astype(v.dtype)); the
// running max, running sum and O accumulator stay f32.
//
// f32: a plain FMA kernel (no tensor cores, so no TF32 rounding): four
// warps, each owning 4 query rows; lane j scores key j of a 32-key tile,
// the softmax statistics are warp reductions, and lane j owns output
// columns j, j + 32, ...  It exists for the tight comparison with the
// plain version and for f32 models; bf16 is the serving path.
//
// Simple first: no cp.async/TMA pipelining, no wgmma, no warp
// specialisation.  Launches on the caller's stream; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

// Index of the first key tile that need not be visited.
__device__ __forceinline__ int key_tiles(int m0, int bm, int bn, int tq,
                                         int tk, int causal) {
  int n = (tk + bn - 1) / bn;
  if (causal) {
    const int last_q = min(m0 + bm, tq) - 1;
    n = min(n, last_q / bn + 1);
  }
  return n;
}

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * BM;
  const size_t rs = (size_t)heads * D;  // stride between sequence positions
  const __nv_bfloat16* qb = q + ((size_t)b * tq * heads + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * tk * heads + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * tk * heads + h) * D;
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
    __nv_bfloat16* orow = o + ((size_t)b * tq * heads + h) * D + row[i] * rs;
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
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * BM;
  const size_t rs = (size_t)heads * D;
  const float* qb = q + ((size_t)b * tq * heads + h) * D;
  const float* kb = k + ((size_t)b * tk * heads + h) * D;
  const float* vb = v + ((size_t)b * tk * heads + h) * D;

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
    float* orow = o + ((size_t)b * tq * heads + h) * D + qpos * rs;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[r][i] / l_safe;
    if (lane == 0)
      lse[((size_t)b * heads + h) * tq + qpos] =
          m_run[r] <= kNegInf / 2 ? kNegInf : m_run[r] + logf(l_safe);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int batch, int tq, int tk, int heads, float scale, int causal,
            int dtype, cudaStream_t s) {
  if (dtype == 0) {
    dim3 grid((tq + 15) / 16, batch * heads);
    flash_fwd_f32_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), heads, tq, tk, scale, causal);
  } else {
    dim3 grid((tq + 63) / 64, batch * heads);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), heads, tq,
        tk, scale, causal);
  }
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D] contiguous, o like q, lse [B, H, Tq]
// f32.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int tq, int tk,
                             int heads, int head_dim, float scale, int causal,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 ||
      batch * heads > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    launch<64>(q, k, v, o, lse, batch, tq, tk, heads, scale, causal, dtype, s);
  else if (head_dim == 128)
    launch<128>(q, k, v, o, lse, batch, tq, tk, heads, scale, causal, dtype,
                s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
