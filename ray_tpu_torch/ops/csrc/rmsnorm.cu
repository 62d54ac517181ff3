// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/fused.py::_rmsnorm_kernel (Pallas, launched by
// _rmsnorm).  Per row: y = x * rsqrt(mean(x^2) + eps) * w, in f32, stored
// in x's dtype; w is f32.
//
// Bound: device-memory bytes.  The kernel does ~4 flops per element and
// moves 2 * rows * cols * sizeof(x) bytes (read x, write y); at the
// Llama-2-7B prefill shape [4*1024, 4096] bf16 that is 67 MB, ~20 us at
// 3.35 TB/s.  Nothing here is compute-limited: the time goes to keeping
// enough bytes in flight and touching each of them once.
//
// Design (rmsnorm_rows_kernel): a row goes to WPR = 1, 2, 4 or 8 warps
// of a block, and each thread holds its share of the row in registers: up
// to NV = 8 16-byte vectors (8 bf16 or 4 f32), neighbouring lanes on
// neighbouring vectors, all loaded before the sum of squares, so x is
// read once, from device memory only (not kept in L1; L2 fetches 256
// bytes at a time).  WPR is the fewest warps that hold the row (2 at 4096
// bf16: 32 warps of 4 KB each in flight per SM), doubled while the rows
// are too few to give every SM two blocks (a decode step's 4 rows: 8
// warps a row, each thread loading its weights beside x, so both come in
// one round trip).  The sum is f32: shuffles within the warp, then for
// WPR > 1 one step through shared memory behind a named barrier of the
// row's warps (no block-wide barrier).  The row scale is one rsqrtf; the
// weight stays f32 as in the TPU kernel and is read as 16-byte vectors
// (it stays in L1/L2 across rows).  The grid is persistent: as many
// 256-thread blocks as the SMs hold at once (or fewer if the rows need
// fewer), striding over rows, so no partial last wave.  Eight warps hold
// up to 16384 bf16 or 8192 f32; a wider row takes rmsnorm_wide_kernel
// (one block per row, two passes over x, the second from L1/L2).  A width
// that is no multiple of a vector, or a pointer off 16 bytes, takes the
// same kernels with one element per access.  Launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNV = 8;  // 16-byte vectors a thread holds, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// VEC elements of T per access: 16 bytes when the row allows it, else 1.
// The alignment is what lets the compiler emit one 128-bit access.
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// The VEC weights of vector i: 16-byte loads where VEC allows.
template <int VEC>
__device__ __forceinline__ void load_w(float (&wv)[VEC],
                                       const float* __restrict__ w, int i) {
  if constexpr (VEC % 4 == 0) {
    const float4* p = reinterpret_cast<const float4*>(w + (size_t)i * VEC);
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 f = __ldg(p + k);
      wv[4 * k] = f.x;
      wv[4 * k + 1] = f.y;
      wv[4 * k + 2] = f.z;
      wv[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wv[j] = __ldg(w + (size_t)i * VEC + j);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> scale_vec(const Vec<T, VEC>& xv,
                                                 const float (&wv)[VEC],
                                                 float r) {
  Vec<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    out.v[j] = from_f32<T>(to_f32(xv.v[j]) * r * wv[j]);
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const Vec<T, VEC>& xv, float ss) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f32(xv.v[j]);
    ss += f * f;
  }
  return ss;
}

// x as rmsnorm_rows_kernel reads it: once, so not kept in L1, and with L2
// asked to fetch 256 bytes at a time (0.0297 -> 0.0287 ms at [4096, 4096] bf16
// on an H100 80GB HBM3 at 700 W; scripts/compare_kernels_torch.py).
template <typename V>
__device__ __forceinline__ V load_x(const V* p) {
  if constexpr (sizeof(V) == 16) {
    V v;
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
        : "l"(p));
    return v;
  } else {
    return *p;
  }
}

// Hide a vector's value from the compiler, so that it converts x to f32
// again for the scale rather than keep every converted value of the sum
// of squares live (twice the registers for bf16).
template <typename T, int VEC>
__device__ __forceinline__ void opaque(Vec<T, VEC>& xv) {
  if constexpr (sizeof(xv) % 4 == 0) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&xv);
#pragma unroll
    for (int k = 0; k < (int)sizeof(xv) / 4; ++k)
      asm volatile("" : "+r"(u[k]));
  } else {
    uint16_t* u = reinterpret_cast<uint16_t*>(&xv);
#pragma unroll
    for (int k = 0; k < (int)sizeof(xv) / 2; ++k)
      asm volatile("" : "+h"(u[k]));
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows of up to WPR * 32 * NV vectors, WPR warps each, held in registers.
// With NV < kMaxNV (a few rows spread over many warps) the weights are
// loaded beside x, so both come in one round trip.
template <typename T, int VEC, int NV, int WPR>
__global__ void __launch_bounds__(kThreads, NV == kMaxNV ? 4 : 2)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
            T* __restrict__ y, int rows, int cols, float eps) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  constexpr bool kEarlyW = NV < kMaxNV;
  using V = Vec<T, VEC>;
  __shared__ float part[2][kWarps];  // by the parity of the row step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / WPR;
  const int first = (warp % WPR) * 32 + lane;  // this thread's first vector
  const int nvec = cols / VEC;
  int parity = 0;
  for (int row = blockIdx.x * kRowsPerBlock + group; row < rows;
       row += gridDim.x * kRowsPerBlock, parity ^= 1) {
    const V* xr = reinterpret_cast<const V*>(x + (size_t)row * cols);
    V xv[NV];
    float wv[kEarlyW ? NV : 1][VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = first + i * 32 * WPR;
      if (c < nvec) {
        xv[i] = load_x(xr + c);
        if constexpr (kEarlyW) load_w<VEC>(wv[i], w, c);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (first + i * 32 * WPR < nvec) ss = sum_sq<T, VEC>(xv[i], ss);
    ss = warp_sum(ss);
    if constexpr (WPR > 1) {
      // the row's warps meet on named barrier 1 + group; a slot is
      // written again two rows later, after every reader passed the
      // barrier of the row between
      if (lane == 0) part[parity][warp] = ss;
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(WPR * 32)
                   : "memory");
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) ss += part[parity][group * WPR + k];
    }
    const float r = rsqrtf(ss / (float)cols + eps);
    V* yr = reinterpret_cast<V*>(y + (size_t)row * cols);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = first + i * 32 * WPR;
      if (c < nvec) {
        opaque<T, VEC>(xv[i]);
        if constexpr (kEarlyW) {
          yr[c] = scale_vec<T, VEC>(xv[i], wv[i], r);
        } else {
          float wl[VEC];
          load_w<VEC>(wl, w, c);
          yr[c] = scale_vec<T, VEC>(xv[i], wl, r);
        }
      }
    }
  }
}

// A row per block, too wide for registers: the sum of squares, then the
// scale pass over x again.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
            T* __restrict__ y, int cols, float eps) {
  using V = Vec<T, VEC>;
  __shared__ float part[kWarps];
  const int nvec = cols / VEC;
  const V* xr = reinterpret_cast<const V*>(x + (size_t)blockIdx.x * cols);
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    ss = sum_sq<T, VEC>(xr[i], ss);
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) ss += part[k];
  const float r = rsqrtf(ss / (float)cols + eps);
  V* yr = reinterpret_cast<V*>(y + (size_t)blockIdx.x * cols);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float wv[VEC];
    load_w<VEC>(wv, w, i);
    yr[i] = scale_vec<T, VEC>(xr[i], wv, r);
  }
}

template <typename T, int VEC, int NV, int WPR>
cudaError_t launch_rows(const T* x, const float* w, T* y, int rows,
                        int cols, float eps, int sms, cudaStream_t stream) {
  auto kernel = rmsnorm_rows_kernel<T, VEC, NV, WPR>;
  // blocks one SM holds at once: a property of the kernel alone
  static const int per_sm = [&] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                         kThreads, 0) ==
                   cudaSuccess && n > 0
               ? n
               : 1;
  }();
  constexpr int kRowsPerBlock = kWarps / WPR;
  const long need = ((long)rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long slots = (long)sms * per_sm;
  kernel<<<(unsigned)(need < slots ? need : slots), kThreads, 0, stream>>>(
      x, w, y, rows, cols, eps);
  return cudaGetLastError();
}

// NV = 4 (weights loaded beside x) or 8 vectors a thread at WPR warps a
// row.
template <typename T, int VEC, int WPR>
cudaError_t launch_nv(const T* x, const float* w, T* y, int rows, int cols,
                      float eps, int per_thread, int sms,
                      cudaStream_t stream) {
  if (per_thread <= 4)
    return launch_rows<T, VEC, 4, WPR>(x, w, y, rows, cols, eps, sms, stream);
  return launch_rows<T, VEC, kMaxNV, WPR>(x, w, y, rows, cols, eps, sms,
                                          stream);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* w, void* y, int rows,
                       int cols, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* yp = static_cast<T*>(y);
  const int per_lane = (cols / VEC + 31) / 32;  // vectors a lane, 1 warp
  if (per_lane > kMaxNV * kWarps) {
    rmsnorm_wide_kernel<T, VEC><<<rows, kThreads, 0, stream>>>(xp, wp, yp,
                                                               cols, eps);
    return cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the fewest warps a row that hold it; then, while the rows' warps
  // would leave the card's SMs short of two blocks each, twice as many
  int wpr = 1;
  while (per_lane > kMaxNV * wpr) wpr *= 2;
  while (wpr < kWarps && (long)rows * wpr < 2L * sms * kWarps &&
         per_lane > 2 * wpr)
    wpr *= 2;
  const int per_thread = (per_lane + wpr - 1) / wpr;
  switch (wpr) {
    case 1:
      return launch_nv<T, VEC, 1>(xp, wp, yp, rows, cols, eps, per_thread,
                                  sms, stream);
    case 2:
      return launch_nv<T, VEC, 2>(xp, wp, yp, rows, cols, eps, per_thread,
                                  sms, stream);
    case 4:
      return launch_nv<T, VEC, 4>(xp, wp, yp, rows, cols, eps, per_thread,
                                  sms, stream);
    default:
      return launch_nv<T, VEC, 8>(xp, wp, yp, rows, cols, eps, per_thread,
                                  sms, stream);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int cols,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (cols % kVec == 0 && aligned(x) && aligned(y) && aligned(w))
    return launch_vec<T, kVec>(x, w, y, rows, cols, eps, stream);
  return launch_vec<T, 1>(x, w, y, rows, cols, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int rtt_rmsnorm_fwd(const void* x, const void* w, void* y,
                               int rows, int cols, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, w, y, rows, cols, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, y, rows, cols, eps, s);
  return (int)cudaErrorInvalidValue;
}
