// Hopper (sm_90a) building blocks in raw PTX, shared by the bf16 flash
// forward (flash_fwd.cu), dK/dV and dQ (flash_bwd.cu) kernels, the
// 192/256-column forward, dK/dV and dQ (flash_wide.cu), the
// 384/512/768/1024-column forward (flash_xwide.cu) and dK/dV and dQ
// (flash_xwide_bwd.cu): mbarriers, the cluster barrier and distributed
// shared memory, TMA loads and stores of 4-D [B, T, H, D] tiles, wgmma
// shared-memory descriptors and the few wgmma shapes the kernels issue,
// register rebalancing between warpgroups, and the host-side tensor-map
// encoder.
//
// Tiles in shared memory.  A tile of `rows` positions x D bf16 is stored
// as D / C boxes of rows x C columns, C = 64 (128-byte rows, 128-byte
// swizzle; D = 64, 128, 192, 256, 384, 512, 768, 1024: one to sixteen
// boxes) or, at D = 32, C = 32 (64-byte rows, 64-byte swizzle), one box
// after the other; each box starts on a 1024-byte boundary.  TMA writes a
// box in that swizzle, and the wgmma descriptors below read it in the same
// one, so the two must agree on C (Swz<D>).
//
// Descriptors (PTX ISA, "matrix descriptor"): start address >> 4 in bits
// 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, swizzle mode in 62-63 (1 = 128 B, 2 = 64 B).
//  * K-major (the reduction dimension contiguous: Q, K for S = Q K^T):
//    SBO = 8 rows x row bytes; stepping k by 16 elements adds 32 bytes to
//    the start inside the row (the swizzle is applied to the final
//    address, so a 1024-aligned box reads correctly at any 32-byte step).
//  * MN-major (the output dimension contiguous: V for P V, dO and Q for
//    dV and dK): a swizzle atom is C output columns x 8 reduction rows;
//    SBO = the 8 rows' bytes, LBO = the distance between atoms along the
//    output dimension (one box).  flash_fwd.cu and flash_bwd.cu issue one
//    wgmma per box; flash_wide.cu's and flash_xwide.cu's products span one
//    to four boxes in one instruction, stepping from atom to atom by LBO.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ layout --

template <int D>
struct Swz {
  static constexpr int kCols = D < 64 ? D : 64;          // columns per box
  static constexpr int kRowBytes = kCols * 2;            // 64 or 128
  static constexpr int kBoxes = D / kCols;
  static constexpr int kMode = kRowBytes == 128 ? 1 : 2;  // descriptor
  static constexpr int kKSteps = kCols / 16;  // k16 steps inside one row
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static_assert(D == 32 || D == 64 || D == 128 || D == 192 || D == 256 ||
                    D == 384 || D == 512 || D == 768 || D == 1024,
                "head_dim 32, 64, 128, 192, 256, 384, 512, 768 or 1024");
};

// Byte offset of element (row, col) of a box, swizzled as TMA stores it.
template <int D>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const uint32_t off = row * Swz<D>::kRowBytes + col * 2;
  constexpr uint32_t mask = Swz<D>::kRowBytes == 128 ? 0x70 : 0x30;
  return off ^ ((off >> 3) & mask);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -------------------------------------------------------- mbarriers --

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) among
// `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on named barrier `id` without waiting: the other `threads` -
// (this warpgroup) threads wait on it with named_sync.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Generic-proxy writes to shared memory made visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------- clusters --

// The cluster barrier in two halves, each thread on its own: arrive
// (release: this thread's writes before it, shared memory included, are
// visible to every thread of the cluster after its wait), then wait
// (acquire) until every thread of every block of the cluster arrived.  A
// thread waits before it arrives again.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address of this block's shared `addr` in block `rank` of the cluster
// (distributed shared memory).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// --------------------------------------------------------------- TMA --

// Box at (c0, c1, c2, c3) = (column, head, position, batch) into `dst`;
// completion counted on `bar`.  Positions past the map's T read as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Box from `src` to (c0, c1, c2, c3); positions past T are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Close the group of stores issued so far.
__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every committed store has read its shared memory.
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ------------------------------------------------------------- wgmma --

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

// K-major operand: rows of this layout's box, reduction along the row.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, Swz<D>::kAtomBytes, Swz<D>::kMode);
}

// MN-major operand: reduction down the rows, output along the row; `box`
// = bytes between boxes.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box) {
  return desc(addr, box, Swz<D>::kAtomBytes, Swz<D>::kMode);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep reads and writes of accumulator registers on their side of an
// asynchronous wgmma (the compiler does not know the instruction is
// still writing them until wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x in one MUFU instruction (relative error ~2^-22); -inf and very
// negative x give +0.
__device__ __forceinline__ float exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int Regs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}
template <int Regs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

#define RTT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RTT_F16(d, i) \
  RTT_F4(d, i), RTT_F4(d, i + 4), RTT_F4(d, i + 8), RTT_F4(d, i + 12)

// d (64 x N, f32) (+)= A (64 x 16, smem K-major) B (16 x N, smem K-major,
// or with TransB = 1 MN-major); scale_d = 0 overwrites d.
template <int TransB = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : RTT_F16(d, 0), RTT_F16(d, 16), RTT_F16(d, 32), RTT_F16(d, 48)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : RTT_F16(d, 0), RTT_F16(d, 16)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

template <int TransB = 0>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : RTT_F16(d, 0)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

// One SS product of width N = 32, 64 or 128; B K-major (TransB = 0) or
// MN-major (TransB = 1).
template <int N, int TransB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "N = 32, 64 or 128");
  if constexpr (N == 128)
    mma_ss_n128<TransB>(d, a, b, scale_d);
  else if constexpr (N == 64)
    mma_ss_n64<TransB>(d, a, b, scale_d);
  else
    mma_ss_n32<TransB>(d, a, b, scale_d);
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers: the mma.sync A-fragment
// layout per warp) B (16 x 64, smem MN-major).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_F16(d, 0), RTT_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// As mma_rs_n64 with N = 32.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : RTT_F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// As mma_rs_n64 with N = 192 and 256: the whole head of a 192- or
// 256-column build, V read MN-major across its three or four boxes (LBO =
// the distance between boxes).
__device__ __forceinline__ void mma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : RTT_F16(d, 0), RTT_F16(d, 16), RTT_F16(d, 32), RTT_F16(d, 48),
        RTT_F16(d, 64), RTT_F16(d, 80)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RTT_F16(d, 0), RTT_F16(d, 16), RTT_F16(d, 32), RTT_F16(d, 48),
        RTT_F16(d, 64), RTT_F16(d, 80), RTT_F16(d, 96), RTT_F16(d, 112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One RS product of width N = 32, 64, 192 or 256.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 32 || N == 64 || N == 192 || N == 256,
                "N = 32, 64, 192 or 256");
  if constexpr (N == 256)
    mma_rs_n256(d, a, b);
  else if constexpr (N == 192)
    mma_rs_n192(d, a, b);
  else if constexpr (N == 64)
    mma_rs_n64(d, a, b);
  else
    mma_rs_n32(d, a, b);
}

// One box-wide RS product: N = the box's columns.
template <int D>
__device__ __forceinline__ void mma_rs_box(float (&d)[Swz<D>::kCols / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (Swz<D>::kCols == 64)
    mma_rs_n64(d, a, b);
  else
    mma_rs_n32(d, a, b);
}

#undef RTT_F16
#undef RTT_F4

// -------------------------------------------------------------- host --

// A 4-D map over a contiguous [B, T, H, dim] bf16 tensor, dims innermost
// first (dim, H, T, B), read in boxes of Swz<D>::kCols columns x `rows`
// positions of one head, for a kernel built for D >= dim columns: the
// columns of a box past dim are zeros on load and not written on store
// (flash_common.cuh, by_head_dim).  Encoded per call through the driver's
// entry point, so the library needs no -lcuda.  False if the driver
// refuses.
template <int D>
inline bool encode_map(CUtensorMap* map, const void* base, int batch, int seq,
                       int heads, int dim, int rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dim * 2,
                                 (cuuint64_t)heads * dim * 2,
                                 (cuuint64_t)seq * heads * dim * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Swz<D>::kCols, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Swz<D>::kMode == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
