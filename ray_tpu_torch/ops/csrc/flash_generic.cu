// Flash attention for head sizes above 128 (sm_90a), over [B, T, H, D].
//
// Replaces, for head_dim above 128: ray_tpu/ops/flash_attention.py::
// _fa_kernel (the head-major forward, launched by _flash_forward),
// ::_fa_bwd_dkdv_kernel and ::_fa_bwd_dq_kernel (launched by
// _flash_backward).  The Pallas kernels take any head_dim: their blocks
// span it whole.  The Hopper kernels of flash_fwd.cu and flash_bwd.cu are
// built for 32, 64 and 128 (their shared memory and registers are spent
// at 128), and the wrapper zero-pads a head_dim below 128 that is no
// multiple of 8 onto them; above 128 it launches these three.  They
// compute what the others compute, with the same contract: the causal
// mask aligned top-left, f32 LSE and delta, bf16 or f32 in and out, P
// rounded to the input dtype before P V and dV, dS before dK and dQ;
// a row with no visible key gives O = 0 and LSE = -1e30.
//
// Bound: at [8, 1024, 16, 256] bf16 causal the forward does 4 * D flops
// per visible (query, key) pair (69 GFLOP, 70 us on the tensor cores)
// against 268 MB of q/k/v/o (80 us); these kernels run on the FMA units
// (67 TFLOP/s in f32), about 1 ms at best.  They are written to be right
// and simple first (a later PR makes them fast): a SIMT design with no
// tensor cores, no TMA and no asynchronous copies.
//
// Design.  A block owns R rows (queries in the forward and dQ, keys in
// dK/dV) of one (batch, head) and loops over the other side's tiles of R
// rows, as the Pallas kernels' sequential grid axis does.  R is chosen by
// head_dim (64 up to 256, 32 up to 512, 16 up to 1024) so that the
// block's f32 accumulators, R x head_dim each (O; dQ; dK and dV), fit in
// shared memory.  A score tile S = A B^T (R x R) is summed in registers
// over the head dim in chunks of 32 columns, each chunk of A's and B's
// rows staged in shared memory, transposed and padded so that neither
// the staging stores nor the reads conflict; each of the 256 threads
// holds (R / 16)^2 scores.  The softmax or gradient of the tile passes
// through shared memory, and the accumulators are updated chunk by chunk
// with the third operand's chunk staged the same way.  Causal blocks skip
// the tiles wholly above the diagonal.  The loads read 32 consecutive
// elements of a row, so no alignment is needed: any head_dim, any
// stride.  The launch bound asks for one resident block (its shared
// memory allows no more at 256 columns): with the thread count alone,
// ptxas held some instantiations to 32-64 registers and spilled.  Upper limit: head_dim 1024 (kMaxHeadDim; above it the wrapper
// raises on any device).  Launches on the caller's stream; allocates
// nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kGThreads = 256;
constexpr int kChunk = 32;  // head-dim columns per pass
constexpr int kMaxHeadDim = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (P~, dS~), kept as f32 for the sum.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float clamp_lse(float x) {
  return x <= kNegInf / 2 ? 0.f : x;
}

__host__ __device__ constexpr int padded_dim(int dim) {
  return (dim + kChunk - 1) / kChunk * kChunk;
}

// acc[i][j] += sum over columns c < dim of A[a0 + ty + 16 i][c] *
// B[b0 + tx + 16 j][c], with tx = tid % 16, ty = tid / 16; rows at or
// past a_lim / b_lim read as 0.  as and bs are [kChunk][R + 1].  Begins
// and ends each chunk with a barrier, so the caller's shared tiles are
// free to be rewritten once it returns.
template <typename T, int R>
__device__ __forceinline__ void rows_product(
    const T* __restrict__ a, int a0, int a_lim, const T* __restrict__ b,
    int b0, int b_lim, int dim, size_t rs, float* as, float* bs,
    float (&acc)[R / 16][R / 16]) {
  constexpr int P = R / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    __syncthreads();
#pragma unroll 2
    for (int e = tid; e < R * kChunk; e += kGThreads) {
      const int r = e / kChunk, c = e % kChunk;
      const bool col = c0 + c < dim;
      as[c * (R + 1) + r] = col && a0 + r < a_lim
                                ? to_f(a[(size_t)(a0 + r) * rs + c0 + c])
                                : 0.f;
      bs[c * (R + 1) + r] = col && b0 + r < b_lim
                                ? to_f(b[(size_t)(b0 + r) * rs + c0 + c])
                                : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float av[P], bv[P];
#pragma unroll
      for (int i = 0; i < P; ++i) av[i] = as[c * (R + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < P; ++j) bv[j] = bs[c * (R + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + kChunk) of one head into
// dst [R][kChunk], zero past row `limit` and column `dim`.
template <typename T, int R>
__device__ __forceinline__ void stage_chunk(float* dst, const T* __restrict__ src,
                                            int r0, int limit, int c0,
                                            int dim, size_t rs) {
#pragma unroll 2
  for (int e = threadIdx.x; e < R * kChunk; e += kGThreads) {
    const int r = e / kChunk, c = e % kChunk;
    dst[e] = r0 + r < limit && c0 + c < dim
                 ? to_f(src[(size_t)(r0 + r) * rs + c0 + c])
                 : 0.f;
  }
}

template <int R>
constexpr size_t tiles_bytes(int n_acc, int n_sq, int n_rows, int dp) {
  return ((size_t)n_acc * R * dp + 2 * kChunk * (R + 1) +
          (size_t)n_sq * R * (R + 1) + (size_t)n_rows * R) *
         sizeof(float);
}

// ------------------------------------------------------------- forward --

template <typename T, int R>
__global__ void __launch_bounds__(kGThreads, 1)
fwd_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, int heads, int dim, int tq,
                   int tk, float scale, int causal) {
  constexpr int P = R / 16, RPW = R / 8;
  const int dp = padded_dim(dim);
  extern __shared__ __align__(16) float sm[];
  float* acc = sm;                    // [R][dp]: O, unnormalised
  float* as = acc + R * dp;           // [kChunk][R + 1]
  float* bs = as + kChunk * (R + 1);  // [kChunk][R + 1]; V's chunk
  float* ps = bs + kChunk * (R + 1);  // [R][R + 1]: scores, then P~
  float* m_s = ps + R * (R + 1);      // [R] running max
  float* l_s = m_s + R;               // [R] running sum
  float* c_s = l_s + R;               // [R] this tile's correction

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * R;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const T* kb = k + slice_base(b, h, heads, tk, dim);
  const T* vb = v + slice_base(b, h, heads, tk, dim);

  for (int e = tid; e < R * dp; e += kGThreads) acc[e] = 0.f;
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int n_tiles = key_tiles(m0, R, R, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * R;
    float s[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) s[i][j] = 0.f;
    rows_product<T, R>(q + qoff, m0, tq, kb, n0, tk, dim, rs, as, bs, s);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const int kpos = n0 + col;
        const bool masked = kpos >= tk || (causal && kpos > m0 + row);
        ps[row * (R + 1) + col] = masked ? kNegInf : s[i][j] * scale;
      }
    __syncthreads();

    // online softmax, a warp per row: the statistics from P, P~ for P V
    for (int row = warp; row < R; row += kGThreads / 32) {
      float x[R / 32 > 0 ? R / 32 : 1];
      float tmax = kNegInf;
#pragma unroll
      for (int u = 0; u * 32 < R; ++u) {
        const int col = lane + 32 * u;
        x[u] = col < R ? ps[row * (R + 1) + col] : kNegInf;
        tmax = fmaxf(tmax, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, tmax);
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u * 32 < R; ++u) {
        const int col = lane + 32 * u;
        const float p = expf(x[u] - safe);  // masked: exactly 0
        psum += p;
        if (col < R) ps[row * (R + 1) + col] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = m_old <= kNegInf / 2 ? 0.f : expf(m_old - safe);
        l_s[row] = l_s[row] * corr + psum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }

    // O = O corr + P~ V, a chunk of columns at a time: lane owns column
    // c0 + lane of rows warp, warp + 8, ...
    for (int c0 = 0; c0 < dp; c0 += kChunk) {
      __syncthreads();
      stage_chunk<T, R>(bs, vb, n0, tk, c0, dim, rs);
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < RPW; ++i) {
        const int row = warp + 8 * i;
        float a = 0.f;
#pragma unroll 4
        for (int n = 0; n < R; ++n)
          a = fmaf(ps[row * (R + 1) + n], bs[n * kChunk + lane], a);
        float* dst = acc + row * dp + c0 + lane;
        *dst = *dst * c_s[row] + a;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < R * dp; e += kGThreads) {
    const int row = e / dp, c = e % dp;
    if (m0 + row >= tq || c >= dim) continue;
    const float l = l_s[row];
    o[qoff + (size_t)(m0 + row) * rs + c] =
        from_f<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
  if (tid < R && m0 + tid < tq) {
    const float l = l_s[tid], m = m_s[tid];
    lse[((size_t)b * heads + h) * tq + m0 + tid] =
        m <= kNegInf / 2 ? kNegInf : m + logf(l == 0.f ? 1.f : l);
  }
}

// --------------------------------------------------------------- dK/dV --

template <typename T, int R>
__global__ void __launch_bounds__(kGThreads, 1)
dkdv_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int heads, int dim, int tq, int tk,
                    float scale, int causal) {
  constexpr int P = R / 16, RPW = R / 8;
  const int dp = padded_dim(dim);
  extern __shared__ __align__(16) float sm[];
  float* dka = sm;                     // [R][dp]
  float* dva = dka + R * dp;           // [R][dp]
  float* as = dva + R * dp;            // [kChunk][R + 1]; dO's chunk
  float* bs = as + kChunk * (R + 1);   // [kChunk][R + 1]; Q's chunk
  float* pt = bs + kChunk * (R + 1);   // [R][R + 1]: P~^T (key rows)
  float* dst = pt + R * (R + 1);       // [R][R + 1]: dS~^T
  float* lse_s = dst + R * (R + 1);    // [R]
  float* delta_s = lse_s + R;          // [R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const Work w = work_head_tiles_adjacent();
  const int b = w.bh / heads, h = w.bh % heads;
  const int n0 = w.tile * R;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const size_t koff = slice_base(b, h, heads, tk, dim);
  const T* qb = q + qoff;
  const T* dob = dout + qoff;
  const float* lse_b = lse + ((size_t)b * heads + h) * tq;
  const float* delta_b = delta + ((size_t)b * heads + h) * tq;

  for (int e = tid; e < R * dp; e += kGThreads) dka[e] = dva[e] = 0.f;

  const int m_tiles = (tq + R - 1) / R;
  for (int mt = causal ? n0 / R : 0; mt < m_tiles; ++mt) {
    const int m0 = mt * R;
    __syncthreads();
    if (tid < R) {
      const bool ok = m0 + tid < tq;
      lse_s[tid] = ok ? clamp_lse(lse_b[m0 + tid]) : 0.f;
      delta_s[tid] = ok ? delta_b[m0 + tid] : 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T: key rows, query columns
    float st[P][P], dpt[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) st[i][j] = dpt[i][j] = 0.f;
    rows_product<T, R>(k + koff, n0, tk, qb, m0, tq, dim, rs, as, bs, st);
    rows_product<T, R>(v + koff, n0, tk, dob, m0, tq, dim, rs, as, bs, dpt);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const int kpos = n0 + row, qpos = m0 + col;
        float p = expf(st[i][j] * scale - lse_s[col]);
        if (qpos >= tq || kpos >= tk || (causal && kpos > qpos)) p = 0.f;
        pt[row * (R + 1) + col] = round_to<T>(p);
        dst[row * (R + 1) + col] =
            round_to<T>(p * (dpt[i][j] - delta_s[col]) * scale);
      }

    // dV += P~^T dO, dK += dS~^T Q, a chunk of columns at a time
    for (int c0 = 0; c0 < dp; c0 += kChunk) {
      __syncthreads();
      stage_chunk<T, R>(as, dob, m0, tq, c0, dim, rs);
      stage_chunk<T, R>(bs, qb, m0, tq, c0, dim, rs);
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < RPW; ++i) {
        const int row = warp + 8 * i;
        float av = 0.f, ak = 0.f;
#pragma unroll 4
        for (int m = 0; m < R; ++m) {
          av = fmaf(pt[row * (R + 1) + m], as[m * kChunk + lane], av);
          ak = fmaf(dst[row * (R + 1) + m], bs[m * kChunk + lane], ak);
        }
        dva[row * dp + c0 + lane] += av;
        dka[row * dp + c0 + lane] += ak;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < R * dp; e += kGThreads) {
    const int row = e / dp, c = e % dp;
    if (n0 + row >= tk || c >= dim) continue;
    const size_t at = koff + (size_t)(n0 + row) * rs + c;
    dk[at] = from_f<T>(dka[e]);
    dv[at] = from_f<T>(dva[e]);
  }
}

// ------------------------------------------------------------------ dQ --

template <typename T, int R>
__global__ void __launch_bounds__(kGThreads, 1)
dq_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  int heads, int dim, int tq, int tk, float scale,
                  int causal) {
  constexpr int P = R / 16, RPW = R / 8;
  const int dp = padded_dim(dim);
  extern __shared__ __align__(16) float sm[];
  float* acc = sm;                     // [R][dp]
  float* as = acc + R * dp;            // [kChunk][R + 1]; K's chunk
  float* bs = as + kChunk * (R + 1);   // [kChunk][R + 1]
  float* dss = bs + kChunk * (R + 1);  // [R][R + 1]: dS~ (query rows)
  float* lse_s = dss + R * (R + 1);    // [R]
  float* delta_s = lse_s + R;          // [R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const Work w = work_longest_first();
  const int b = w.bh / heads, h = w.bh % heads;
  const int m0 = w.tile * R;
  const size_t rs = (size_t)heads * dim;
  const size_t qoff = slice_base(b, h, heads, tq, dim);
  const T* kb = k + slice_base(b, h, heads, tk, dim);
  const T* vb = v + slice_base(b, h, heads, tk, dim);

  for (int e = tid; e < R * dp; e += kGThreads) acc[e] = 0.f;
  if (tid < R) {
    const bool ok = m0 + tid < tq;
    const size_t idx = ((size_t)b * heads + h) * tq + m0 + tid;
    lse_s[tid] = ok ? clamp_lse(lse[idx]) : 0.f;
    delta_s[tid] = ok ? delta[idx] : 0.f;
  }

  const int n_tiles = key_tiles(m0, R, R, tq, tk, causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int n0 = kt * R;
    float s[P][P], dpv[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) s[i][j] = dpv[i][j] = 0.f;
    rows_product<T, R>(q + qoff, m0, tq, kb, n0, tk, dim, rs, as, bs, s);
    rows_product<T, R>(dout + qoff, m0, tq, vb, n0, tk, dim, rs, as, bs,
                       dpv);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const int qpos = m0 + row, kpos = n0 + col;
        float p = expf(s[i][j] * scale - lse_s[row]);
        if (qpos >= tq || kpos >= tk || (causal && kpos > qpos)) p = 0.f;
        dss[row * (R + 1) + col] =
            round_to<T>(p * (dpv[i][j] - delta_s[row]) * scale);
      }

    // dQ += dS~ K, a chunk of columns at a time
    for (int c0 = 0; c0 < dp; c0 += kChunk) {
      __syncthreads();
      stage_chunk<T, R>(as, kb, n0, tk, c0, dim, rs);
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < RPW; ++i) {
        const int row = warp + 8 * i;
        float a = 0.f;
#pragma unroll 4
        for (int n = 0; n < R; ++n)
          a = fmaf(dss[row * (R + 1) + n], as[n * kChunk + lane], a);
        acc[row * dp + c0 + lane] += a;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < R * dp; e += kGThreads) {
    const int row = e / dp, c = e % dp;
    if (m0 + row >= tq || c >= dim) continue;
    dq[qoff + (size_t)(m0 + row) * rs + c] = from_f<T>(acc[e]);
  }
}

// ------------------------------------------------------------ launchers --

template <int R>
using Rows = std::integral_constant<int, R>;

// fn(Rows<R>{}, T{}) for the block's rows at head_dim and the dtype
// (0 = float32, 1 = bfloat16); any head_dim from 1 to kMaxHeadDim.
template <typename Fn>
cudaError_t by_rows(int head_dim, int dtype, Fn&& fn) {
  if (head_dim <= 0 || head_dim > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  auto typed = [&](auto rows) {
    return dtype == 0 ? fn(rows, float{}) : fn(rows, bf16{});
  };
  if (head_dim <= 256) return typed(Rows<64>{});
  if (head_dim <= 512) return typed(Rows<32>{});
  return typed(Rows<16>{});
}

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int batch, int tq, int tk, int heads, int head_dim, float scale,
        int causal, int dtype, void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_rows(head_dim, dtype, [&](auto rows, auto t) {
    constexpr int R = decltype(rows)::value;
    using T = decltype(t);
    return launch_block(fwd_generic_kernel<T, R>,
                        dim3(batch * heads, (tq + R - 1) / R), kGThreads,
                        tiles_bytes<R>(1, 1, 3, padded_dim(head_dim)), s,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<T*>(o),
                        static_cast<float*>(lse), heads, head_dim, tq, tk,
                        scale, causal);
  });
}

int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int batch,
         int tq, int tk, int heads, int head_dim, float scale, int causal,
         int dtype, void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_rows(head_dim, dtype, [&](auto rows, auto t) {
    constexpr int R = decltype(rows)::value;
    using T = decltype(t);
    return launch_block(dkdv_generic_kernel<T, R>,
                        dim3(batch * heads, (tk + R - 1) / R), kGThreads,
                        tiles_bytes<R>(2, 2, 2, padded_dim(head_dim)), s,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v),
                        static_cast<const T*>(dout),
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta),
                        static_cast<T*>(dk), static_cast<T*>(dv), heads,
                        head_dim, tq, tk, scale, causal);
  });
}

int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int batch, int tq,
       int tk, int heads, int head_dim, float scale, int causal, int dtype,
       void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_rows(head_dim, dtype, [&](auto rows, auto t) {
    constexpr int R = decltype(rows)::value;
    using T = decltype(t);
    return launch_block(dq_generic_kernel<T, R>,
                        dim3(batch * heads, (tq + R - 1) / R), kGThreads,
                        tiles_bytes<R>(1, 1, 2, padded_dim(head_dim)), s,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v),
                        static_cast<const T*>(dout),
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta),
                        static_cast<T*>(dq_out), heads, head_dim, tq, tk,
                        scale, causal);
  });
}

}  // namespace

// As rtt_flash_fwd (flash_fwd.cu), for head_dim 1 to 1024 (the wrapper
// sends those above 128 here).  Returns the launch's cudaError_t.
extern "C" int rtt_flash_generic_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int batch, int tq, int tk, int heads,
                                     int head_dim, float scale, int causal,
                                     int dtype, void* stream) {
  return fwd(q, k, v, o, lse, batch, tq, tk, heads, head_dim, scale, causal,
             dtype, stream);
}

// As rtt_flash_bwd_dkdv (flash_bwd.cu), for head_dim 1 to 1024.
extern "C" int rtt_flash_generic_bwd_dkdv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int batch,
                                          int tq, int tk, int heads,
                                          int head_dim, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  return dkdv(q, k, v, dout, lse, delta, dk, dv, batch, tq, tk, heads,
              head_dim, scale, causal, dtype, stream);
}

// As rtt_flash_bwd_dq (flash_bwd.cu), for head_dim 1 to 1024.
extern "C" int rtt_flash_generic_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq_out, int batch, int tq,
                                        int tk, int heads, int head_dim,
                                        float scale, int causal, int dtype,
                                        void* stream) {
  return dq(q, k, v, dout, lse, delta, dq_out, batch, tq, tk, heads,
            head_dim, scale, causal, dtype, stream);
}
