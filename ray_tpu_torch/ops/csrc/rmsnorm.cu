// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/fused.py::_rmsnorm_kernel (Pallas, launched by
// _rmsnorm).  Per row: y = x * rsqrt(mean(x^2) + eps) * w, in f32, stored
// in x's dtype; w is f32.
//
// Bound: device-memory bytes.  The kernel does ~4 flops per element and
// moves 2 * rows * cols * sizeof(x) bytes (read x, write y); at the
// Llama-2-7B prefill shape [4*1024, 4096] bf16 that is 67 MB, ~20 us at
// 3.35 TB/s.  Nothing here is compute-limited.
//
// Design: every byte is touched once by 16-byte vector loads and stores
// (8 bf16 or 4 f32 per access, neighbouring threads on neighbouring
// addresses).  A row of up to 1024 elements goes to one warp (shuffle
// reduction only, eight rows per 256-thread block); a longer row gets the
// whole 256-thread block (shuffles, then one pass through shared memory).
// The sum of squares is f32.  The second pass re-reads x, which the
// first pass has just brought into L1/L2, so device memory still sees x
// once.  The row scale is one rsqrtf; the weight stays f32 as in the TPU
// kernel.  Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int rows, int cols, float eps) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool active = row < rows;
  const int nvec = cols / VEC;
  using V = Vec<T, VEC>;
  const V* xr = reinterpret_cast<const V*>(x + (size_t)row * cols);

  float ss = 0.f;
  if (active) {
    for (int i = lane; i < nvec; i += TPR) {
      V xv = xr[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f = to_f32(xv.v[j]);
        ss += f * f;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (TPR > 32) {
    __shared__ float part[kThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) ss += part[i];
  }
  if (!active) return;

  const float r = rsqrtf(ss / (float)cols + eps);
  V* yr = reinterpret_cast<V*>(y + (size_t)row * cols);
  for (int i = lane; i < nvec; i += TPR) {
    V xv = xr[i];
    V out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_f32<T>(to_f32(xv.v[j]) * r * w[i * VEC + j]);
    yr[i] = out;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int cols,
            float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = cols % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* yp = static_cast<T*>(y);
  if (cols <= 1024) {
    dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
    if (vec)
      rmsnorm_kernel<T, kVec, 32><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, cols, eps);
    else
      rmsnorm_kernel<T, 1, 32><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, cols, eps);
  } else {
    dim3 grid(rows);
    if (vec)
      rmsnorm_kernel<T, kVec, kThreads><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, cols, eps);
    else
      rmsnorm_kernel<T, 1, kThreads><<<grid, kThreads, 0, stream>>>(
          xp, wp, yp, rows, cols, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int rtt_rmsnorm_fwd(const void* x, const void* w, void* y,
                               int rows, int cols, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float>(x, w, y, rows, cols, eps, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, y, rows, cols, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
