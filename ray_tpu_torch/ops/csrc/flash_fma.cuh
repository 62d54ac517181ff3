// What the f32 flash kernels on the FMA units share (flash_fma.cu: the
// forward; flash_fma_bwd.cu: dK/dV and dQ): cp.async copies of 16-byte
// granules, 16-byte shared loads, the widths they take, and the rule and
// the launch that cut the head_dim into column groups, a block each, the
// groups of one tile a thread block cluster.

#pragma once

#include <initializer_list>
#include <type_traits>

#include "flash_common.cuh"

namespace flash {

constexpr int kFmaMaxGroups = 8;  // a portable cluster
constexpr int kFmaMinDim = 129, kFmaMaxDim = 1024;
constexpr int kFmaRows = 64;  // a block's rows, and a streamed tile's

// 16 bytes from src to shared dst, or 16 zero bytes if !valid (src is then
// not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Any head_dim from kFmaMinDim to kFmaMaxDim that is a multiple of 4 (the
// wrapper zero-pads another to the next multiple of 4): a row of f32 then
// spans whole 16-byte granules, which cp.async copies.
inline bool bad_fma_dim(int head_dim) {
  return head_dim < kFmaMinDim || head_dim > kFmaMaxDim || head_dim % 4 != 0;
}

template <int GC>
using GroupCols = std::integral_constant<int, GC>;

// The group width for a launch over `items` (batch * heads * the tiles a
// block owns) at head_dim `dim` on `sms` SMs, of 64, 128 and 256 wide up
// to `widest` (at most kFmaMaxGroups groups): the one with the most groups
// whose blocks (items x groups) fit in one wave, or the one with the
// fewest if none fits.  Held against each fixed width on an H100 80GB
// HBM3 at 700 W (scripts/compare_kernels_torch.py): for the forward
// it picked the fastest at f32 [2, 256, 4, d] for d = 160, 256 (64; its
// 128 blocks are 8 more than the card holds at once, yet 1.2x ahead of
// 128), 512 (128) and 1024 (256), and at [8, 1024, 16, 256] (256), so
// each width wins somewhere; PERF.md has the backward's readings.
inline int fma_group_cols(long items, int dim, int sms, int widest) {
  int best = 0, fewest = 0;
  for (int gc : {256, 128, 64}) {
    const long groups = (dim + gc - 1) / gc;
    if (gc > widest || groups > kFmaMaxGroups) continue;
    if (fewest == 0) fewest = gc;
    if (items * groups <= sms) best = gc;
  }
  return best ? best : fewest;
}

// fn(GroupCols<GC>{}) for the group width (at most Widest) a launch over
// `items` at this head_dim takes.
template <int Widest, typename Fn>
cudaError_t by_group_cols(long items, int head_dim, Fn&& fn) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  switch (fma_group_cols(items, head_dim, sms, Widest)) {
    case 256:
      if constexpr (Widest >= 256) return fn(GroupCols<256>{});
      return cudaErrorInvalidValue;
    case 128:
      return fn(GroupCols<128>{});
    default:
      return fn(GroupCols<64>{});
  }
}

// A launch of a kernel that cuts the head_dim into groups of `gc` columns:
// grid (bh * groups, tiles), 256 threads a block, one cluster a tile's
// groups, and the kernel's dynamic shared memory (its limit set first, as
// it must be above 48 KB).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  int groups;

  template <typename Kernel>
  cudaError_t init(Kernel kernel, int gc, int bh, int tiles, int head_dim,
                   size_t smem, cudaStream_t s) {
    groups = (head_dim + gc - 1) / gc;
    cfg.gridDim = dim3(bh * groups, tiles);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = groups;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }

  // The launch's clusters: one a tile's groups.
  int clusters() const {
    return (int)(cfg.gridDim.x / groups * cfg.gridDim.y);
  }
};

}  // namespace flash
