// Shared by flash_fwd.cu and flash_bwd.cu: the layout the flash kernels
// read, the block's place in the grid and the launchers (the bf16
// kernels' Hopper building blocks are in hopper.cuh).
//
// Layout.  Every kernel reads [B, T, H, D] by strides: one head's
// positions lie H * D elements apart.  The JAX package has two kernel
// families: its _fa_nl_* kernels read [B, T, H, D] in 128-lane slabs of
// packed heads, and its _fa_* kernels read head-major [B, H, T, D], which
// their wrappers make by transposing q, k, v and dO and undo on O, dQ, dK
// and dV.  Both layouts exist to fit the TPU's tiles; here a stride does
// that, so both families' wrappers launch these kernels on the caller's
// tensors and no transpose is made.
//
// Grid.  (batch * heads, sequence tiles): gridDim.x takes up to 2^31 - 1
// blocks, so no head count meets gridDim.y's limit of 65535.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
// The f32 kernels' launch bound asks for two resident blocks: without it
// ptxas spilled 4-8 bytes in two of them once they took a runtime column
// bound (head_dim below the built D), with it none (H100 build, sm_90a).
constexpr int kF32MinBlocks = 2;

// Offset of position 0 of head h of batch b in a [B, seq, H, dim] tensor.
__device__ __forceinline__ size_t slice_base(int b, int h, int heads,
                                             int seq, int dim) {
  return ((size_t)b * seq * heads + h) * dim;
}

// A work item is a (batch * head, sequence tile) pair.  Three orders,
// each the faster for its kernels on an H100 (against the others and
// against the plain grid, which starts every head's first tile, then
// every head's second one):
struct Work {
  int bh, tile;
};

// The f32 dQ: all heads' last query tiles first, then the tiles before
// them.  A causal block's work grows with its tile, so the longest blocks
// start first and the short ones fill the tail.
__device__ __forceinline__ Work work_longest_first() {
  return {(int)blockIdx.x, (int)(gridDim.y - 1 - blockIdx.y)};
}

// The kernels that split the outputs' columns into groups across the grid
// (flash_xwide.cu's and flash_fma.cu's forwards, flash_xwide_bwd.cu's and
// flash_fma_bwd.cu's dK/dV and dQ): grid (batch * heads * groups, tiles),
// a block one (head, tile, group).  A tile's groups are adjacent, then a
// head's tiles: the groups of a tile read the same rows, a head's tiles
// the same streamed ones, so they meet in L2.  32-bit: a
// block covers at least 16 positions of one head, so 2^32 blocks would
// need inputs far beyond the card's memory.
struct GroupWork {
  int bh, tile, group;
};

__device__ __forceinline__ GroupWork work_group_tiles_adjacent(int groups) {
  const unsigned lin = blockIdx.y * gridDim.x + blockIdx.x;
  const unsigned item = lin / groups;
  return {(int)(item / gridDim.y), (int)(item % gridDim.y),
          (int)(lin % groups)};
}

// dK/dV and the f32 forward up to 128: the same order with one group, so
// a head's blocks run together and share in L2 the tiles they all walk
// (Q and dO in dK/dV).
__device__ __forceinline__ Work work_head_tiles_adjacent() {
  const GroupWork w = work_group_tiles_adjacent(1);
  return {w.bh, w.tile};
}

// The persistent bf16 forward and dQ walk items by a linear index `lin` over
// `n_bh` heads x `n_t` tiles, two consecutive items per step of a block.
// work_head_tile_pairs orders one head's tiles 0, n-1, 1, n-2, ...: a
// block's step gets a causal head's tiles k and n-1-k, the same work for
// every k, and a head's pairs sit on neighbouring blocks, which share its
// K/V tiles in L2 (scripts/compare_flash_block_order_torch.py times it
// against the other two orders).
__device__ __forceinline__ Work work_head_tile_pairs(unsigned lin,
                                                     unsigned n_bh,
                                                     unsigned n_t) {
  const unsigned k = lin % n_t;
  return {(int)(lin / n_t), (int)((k & 1) ? n_t - 1 - k / 2 : k / 2)};
}

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

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Launch `threads` a block with `smem` bytes of dynamic shared memory and
// return the launch's error.  The kernel's dynamic limit is set to
// `smem` first (above 48 KB it must be), so func_attrs reads it back.
template <typename... KArgs, typename... Args>
cudaError_t launch_block(void (*kernel)(KArgs...), dim3 grid, int threads,
                         size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// What the runtime holds for a kernel: out[0] registers per thread,
// out[1] static shared bytes, out[2] the dynamic shared bytes its last
// launch set.
template <typename... KArgs>
cudaError_t func_attrs(void (*kernel)(KArgs...), int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

// Blocks of a persistent kernel that takes its `items` two at a time: one
// per SM, or one per pair of items if there are fewer.
inline cudaError_t persistent_blocks(long items, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    const long pairs = (items + 1) / 2;
    *blocks = (int)(pairs < sms ? pairs : sms);
  }
  return e;
}

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t s, Args... args) {
  return launch_block(kernel, grid, kThreads, smem, s, args...);
}

// dtype: the inputs' (0 = float32, 1 = bfloat16); out_dtype: the outputs'
// (O; dQ, dK, dV), the inputs' own or, from bfloat16 inputs, float32 (the
// chunk mode of ring attention: the f32 accumulators leave unrounded).
inline bool bad_args(int batch, int tq, int tk, int heads, int dtype,
                     int out_dtype) {
  return batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 ||
         (dtype != 0 && dtype != 1) ||
         (out_dtype != dtype && !(dtype == 1 && out_dtype == 0));
}

template <int D>
using HeadDim = std::integral_constant<int, D>;

// The kernels are built for D = 32, 64 and 128 and take any head size
// that is a multiple of 8 up to 128: fn(HeadDim<D>{}) for the smallest
// built D at or above head_dim.  The kernels read and write head_dim
// columns and treat the D - head_dim beyond as zeros: the bf16 ones
// through tensor maps whose extent is head_dim (TMA fills the box's
// columns past it with zeros on load and clips them on store), the f32
// ones through a bound on their column loops.  Zero columns of Q and K
// add nothing to S, zero columns of dO and V nothing to dP, and the
// columns they give O, dQ, dK and dV are never written.  A multiple of 8:
// a row of bf16 then spans a multiple of 16 bytes, the strides TMA takes.
// Any other size is cudaErrorInvalidValue.
template <typename Fn>
cudaError_t by_head_dim(int head_dim, Fn&& fn) {
  if (head_dim <= 0 || head_dim % 8 != 0) return cudaErrorInvalidValue;
  if (head_dim <= 32) return fn(HeadDim<32>{});
  if (head_dim <= 64) return fn(HeadDim<64>{});
  if (head_dim <= 128) return fn(HeadDim<128>{});
  return cudaErrorInvalidValue;
}

}  // namespace flash
