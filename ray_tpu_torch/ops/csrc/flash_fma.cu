// Flash-attention forward for f32 inputs at head_dim 129 to 1024, on the
// FMA units (sm_90a), over [B, T, H, D].
//
// Replaces, for head_dim above 128 and f32 inputs: ray_tpu/ops/
// flash_attention.py::_fa_kernel (the head-major forward, launched by
// _flash_forward).  Its products there are full f32 (preferred_element_type
// f32; P stays f32, as p.astype(v.dtype) is a no-op), and the port holds
// its f32 kernels to 2e-5 of the plain version (chip_smoke.ROW_TOL) and an
// f32 training step to the CPU's: so every product here is an exact f32
// FFMA.  No tensor-core path: TF32 keeps about three decimal digits, and
// 3xTF32 on wgmma would take V only K-major (tf32 wgmma takes no MN-major
// operand).  Contract as the other forwards: the causal mask aligned
// top-left, f32 LSE, a row with no visible key giving O = 0 and LSE =
// -1e30.  No f32-out variant: the chunk mode takes bf16 inputs (f32 in is
// f32 out already).  dK/dV and dQ stay on flash_generic.cu.
//
// Bound: 4 * D flops per visible (query, key) pair at 67 TFLOP/s (f32 FMA):
// at [2, 256, 4, 256] causal 0.27 GFLOP, 4.0 us, against 4.2 MB of q, k,
// v, o (1.3 us); at [2, 256, 4, 1024] 16 us.  So the design keeps the FMA
// units busy: each thread's operands come from shared memory in 16-byte
// loads, 8 FMAs a load, and S, P and O never leave the chip.
//
// Design.  A block owns 64 queries of one (batch, head) and one group of O's
// columns, GC = 64, 128 or 256 wide, and walks the key tiles (64 keys) up
// to the diagonal.  Its 256 threads hold O in registers (4 rows x GC / 16
// columns each: rows ty + 16 i, columns 4 tx + 64 s + e) and a 4 x 4
// micro-tile of each tile's scores (rows ty + 16 i, keys tx + 16 j).  S =
// Q K^T runs over chunks of 32 head-dim columns, a chunk of Q and of K (64
// rows each) staged in shared memory by cp.async; P goes through shared
// memory (transposed, each thread's four rows side by side) to P V, which
// runs over chunks of 32 keys of V x GC columns.  A tile's chunks stream
// through a ring of four slots, three in flight while the fourth is read.
// The online softmax is the flash one, in f32 with expf; its row
// statistics are reduced across the 16 threads of a row by shuffles.
//
// Groups.  The G = head_dim / GC blocks of a query tile form a thread block
// cluster.  Each computes the partial S over its G-th of the head_dim's
// chunks; the partials pass through distributed shared memory (each block
// reads the others' from their buffers, double-buffered by tile parity,
// one cluster barrier a tile), and every block adds them in rank order, so
// every block holds the same S to the bit and normalises its columns
// exactly as the others do; group 0 writes the LSE.  So S is computed once
// (a pair costs 4 D flops, the work's own), and the group count trades
// only parallelism against the exchange: the launcher takes the most
// groups (at most 8, a portable cluster) whose blocks fit in one wave of
// the SMs, or the fewest if none does (fma_group_cols): at [2, 256, 4,
// 256] there are only 8 heads x 4 query tiles, which 4 groups of 64
// columns spread over 128 SMs.
//
// Widths: any head_dim from 129 to 1024 that is a multiple of 4 (the
// wrapper zero-pads another to the next multiple of 4): a row of f32 then
// spans whole 16-byte granules, which cp.async copies; granules past
// head_dim, rows past the sequence and columns past the group are zero-
// filled (src-size 0), so they add nothing to S and give no O.
//
// Launches on the caller's stream; allocates nothing.

#include <cooperative_groups.h>

#include <initializer_list>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
namespace cg = cooperative_groups;

constexpr int kFThreads = 256;
constexpr int kFBM = 64, kFBN = 64;  // queries a block, keys a tile
constexpr int kFDK = 32;   // head-dim columns of Q and K a chunk
constexpr int kFStages = 4;           // ring slots
constexpr int kFQKPitch = kFDK + 4;   // floats a staged Q / K row
constexpr int kFPPitch = kFBM + 4;    // floats a P^T row (one key)
constexpr int kFPart = 16 * kFThreads;  // floats of one partial S
constexpr int kFMaxGroups = 8;  // a portable cluster
constexpr int kFMinDim = 129, kFMaxDim = 1024;

template <int GC>
struct FmaSmem {
  static constexpr int kVK = 32;                    // keys of V a chunk
  static constexpr int kQK = 2 * kFBM * kFQKPitch;  // floats: Q, K chunks
  static constexpr int kV = kVK * GC;               // floats: a V chunk
  static constexpr int kSlot = kQK > kV ? kQK : kV;
  static constexpr int kP = kFBN * kFPPitch;  // P^T of a tile
  // the ring, P^T, two partial S buffers
  static constexpr size_t kBytes =
      (size_t)(kFStages * kSlot + kP + 2 * kFPart) * 4;
  static_assert(kBytes <= 232448, "over the block's shared memory");
};

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

// x maximised or summed across the 16 threads tx = 0..15 of a half-warp
// (the threads of one row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int GC>
__global__ void __launch_bounds__(kFThreads, 1)
fma_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int heads, int dim, int tq, int tk,
               float scale, int causal, int groups) {
  using SM = FmaSmem<GC>;
  constexpr int BM = kFBM, BN = kFBN;
  constexpr int NS = GC / 64;  // O's float4 column segments a thread
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;
  // pt[key * kFPPitch + 4 ty + i] = P[ty + 16 i][key]
  float* pt = sm + kFStages * SM::kSlot;
  // part + (kt & 1) * kFPart: this block's partial S of tile kt, thread
  // tid's row i at float4 i * kFThreads + tid
  float* part = pt + SM::kP;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the cluster is the query tile's groups (gridDim.x is a multiple of
  // groups, so blockIdx.x % groups is both the group and the rank)
  const GroupWork w = work_group_tiles_adjacent(groups);
  const int b = w.bh / heads, h = w.bh % heads;
  // a head's query tiles last first: the longest causal ones start first,
  // and a launch with more clusters than the card holds at once (32 of
  // four blocks at [2, 256, 4, 256], where an H100 holds 30) leaves short
  // ones for the late start (rtt_flash_fma_attrs reads the capacity)
  const int m0 = (gridDim.y - 1 - w.tile) * BM;
  const int col0 = w.group * GC;  // the group's first O column
  const size_t rs = (size_t)heads * dim;
  const float* qb = q + slice_base(b, h, heads, tq, dim);
  const float* kb = k + slice_base(b, h, heads, tk, dim);
  const float* vb = v + slice_base(b, h, heads, tk, dim);
  // the key loop stops at the diagonal
  const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);
  // this block's chunks of S's head_dim (at least one: groups <= dim / 64)
  const int n_chunks = (dim + kFDK - 1) / kFDK;
  const int c_lo = w.group * n_chunks / groups;
  const int n_mine = (w.group + 1) * n_chunks / groups - c_lo;
  const int per_tile = n_mine + BN / SM::kVK;  // and P V's
  const int n_items = n_tiles * per_tile;

  // Item it's copies into ring slot it % kFStages, as one cp.async group
  // (empty past the last item, so the waits below count alike).
  auto issue = [&](int it) {
    if (it < n_items) {
      const int kt = it / per_tile, idx = it % per_tile, n0 = kt * BN;
      const uint32_t slot =
          hopper::smem_u32(ring + (it % kFStages) * SM::kSlot);
      if (idx < n_mine) {  // 64 rows x kFDK columns of Q and of K
#pragma unroll
        for (int u = 0; u < BM * kFDK / 4 / kFThreads; ++u) {
          const int e = tid + u * kFThreads;
          const int r = e / (kFDK / 4), c = 4 * (e % (kFDK / 4));
          const int col = (c_lo + idx) * kFDK + c;
          const bool qok = col < dim && m0 + r < tq;
          const bool kok = col < dim && n0 + r < tk;
          cp_async16(slot + 4 * (r * kFQKPitch + c),
                     qok ? qb + (size_t)(m0 + r) * rs + col : qb, qok);
          cp_async16(slot + 4 * ((BM + r) * kFQKPitch + c),
                     kok ? kb + (size_t)(n0 + r) * rs + col : kb, kok);
        }
      } else {  // kVK keys of V x the group's GC columns
        const int nv = n0 + (idx - n_mine) * SM::kVK;
#pragma unroll
        for (int u = 0; u < SM::kVK * GC / 4 / kFThreads; ++u) {
          const int e = tid + u * kFThreads;
          const int r = e / (GC / 4), c = 4 * (e % (GC / 4));
          const bool ok = col0 + c < dim && nv + r < tk;
          cp_async16(slot + 4 * (r * GC + c),
                     ok ? vb + (size_t)(nv + r) * rs + col0 + c : vb, ok);
        }
      }
    }
    cp_commit();
  };

  float acc[4][4 * NS];  // O: acc[i][4 s + e] is (ty + 16 i, 4 tx + 64 s + e)
  float s[4][4];         // S, then P: s[i][j] is (ty + 16 i, key tx + 16 j)
  float m_run[4], l_run[4];  // scaled-score units; l: this thread's share
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NS; ++e) acc[i][e] = 0.f;
  }

  // Tile kt's whole S from the groups' partials, added in rank order.
  auto gather = [&](int kt) {
    float* mine = part + (kt & 1) * kFPart;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(mine + 4 * (i * kFThreads + tid)) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    cg::this_cluster().sync();  // every group's partial of tile kt is in
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int r = 0; r < groups; ++r) {
      const float* src = cg::this_cluster().map_shared_rank(mine, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = lds4(src + 4 * (i * kFThreads + tid));
        s[i][0] += x.x;
        s[i][1] += x.y;
        s[i][2] += x.z;
        s[i][3] += x.w;
      }
    }
  };

  // The online softmax of tile kt's scores: P to pt, O rescaled.
  auto softmax = [&](int kt) {
    const int n0 = kt * BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = m0 + ty + 16 * i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + tx + 16 * j;
        const bool masked = kpos >= tk || (causal && kpos > qpos);
        s[i][j] = masked ? kNegInf : s[i][j] * scale;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = half_warp_max(tmax);
      const float m_new = fmaxf(m_run[i], tmax);
      const float safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr =
          m_run[i] <= kNegInf / 2 ? 0.f : expf(m_run[i] - safe);
      m_run[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - safe);  // masked: exactly 0
        psum += s[i][j];
      }
      l_run[i] = l_run[i] * corr + psum;
#pragma unroll
      for (int e = 0; e < 4 * NS; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kFPPitch + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = 0.f;
    }
  };

  // Item it waits for its slot, frees the slot item it - 1 read (the
  // barrier), refills it with item it + kFStages - 1, and runs: an S chunk
  // (the last of a tile ends with the gather and the softmax) or a P V
  // chunk.
  for (int it = 0; it < kFStages - 1; ++it) issue(it);
  for (int it = 0; it < n_items; ++it) {
    cp_wait<kFStages - 2>();
    __syncthreads();
    issue(it + kFStages - 1);
    const float* slot = ring + (it % kFStages) * SM::kSlot;
    const int kt = it / per_tile, idx = it % per_tile;
    if (idx < n_mine) {
      const float* qs = slot;
      const float* ks = slot + BM * kFQKPitch;
#pragma unroll
      for (int c = 0; c < kFDK; c += 4) {
        float4 a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = lds4(qs + (ty + 16 * i) * kFQKPitch + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bk[j] = lds4(ks + (tx + 16 * j) * kFQKPitch + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
          }
      }
      if (idx == n_mine - 1) {
        if (groups > 1) gather(kt);
        softmax(kt);
      }
    } else {
      const float* vs = slot;
      const int k0 = (idx - n_mine) * SM::kVK;
#pragma unroll 4
      for (int n = 0; n < SM::kVK; ++n) {
        const float4 p = lds4(pt + (k0 + n) * kFPPitch + 4 * ty);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int sg = 0; sg < NS; ++sg) {
          const float4 x = lds4(vs + n * GC + 4 * tx + 64 * sg);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * sg] = fmaf(pr[i], x.x, acc[i][4 * sg]);
            acc[i][4 * sg + 1] = fmaf(pr[i], x.y, acc[i][4 * sg + 1]);
            acc[i][4 * sg + 2] = fmaf(pr[i], x.z, acc[i][4 * sg + 2]);
            acc[i][4 * sg + 3] = fmaf(pr[i], x.w, acc[i][4 * sg + 3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  float* ob = o + slice_base(b, h, heads, tq, dim);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = half_warp_sum(l_run[i]);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    const int qpos = m0 + ty + 16 * i;
    if (qpos >= tq) continue;
    if (w.group == 0 && tx == 0)
      lse[((size_t)b * heads + h) * tq + qpos] =
          m_run[i] <= kNegInf / 2 ? kNegInf : m_run[i] + logf(l_safe);
#pragma unroll
    for (int sg = 0; sg < NS; ++sg) {
      const int col = col0 + 4 * tx + 64 * sg;
      if (col < dim)  // dim is a multiple of 4: col + 3 < dim too
        *reinterpret_cast<float4*>(ob + (size_t)qpos * rs + col) =
            make_float4(acc[i][4 * sg] * inv, acc[i][4 * sg + 1] * inv,
                        acc[i][4 * sg + 2] * inv, acc[i][4 * sg + 3] * inv);
    }
  }
  // no block leaves while another may still read its partial S
  if (groups > 1) cg::this_cluster().sync();
}

template <int GC>
using GroupCols = std::integral_constant<int, GC>;

// O's group width for a launch over `items` (batch * heads * query tiles)
// at head_dim `dim` on `sms` SMs: of 64, 128 and 256 wide (at most
// kFMaxGroups groups), the one with the most groups whose blocks (items x
// groups) fit in one wave, or the one with the fewest if none fits.  Held
// against each fixed width on an H100 (scripts/compare_kernels_torch.py
// on copies with the width fixed): it picked the fastest at f32 [2, 256,
// 4, d] for d = 160, 256 (64; its 128 blocks are 8 more than the card
// holds at once, yet 1.2x ahead of 128), 512 (128) and 1024 (256), and at
// [8, 1024, 16, 256] (256), so each width wins somewhere.
inline int fma_group_cols(long items, int dim, int sms) {
  int best = 0, fewest = 0;
  for (int gc : {256, 128, 64}) {
    const long groups = (dim + gc - 1) / gc;
    if (groups > kFMaxGroups) continue;
    if (fewest == 0) fewest = gc;
    if (items * groups <= sms) best = gc;
  }
  return best ? best : fewest;
}

// fn(GroupCols<GC>{}) for the group width a launch at this shape takes.
template <typename Fn>
cudaError_t by_group_cols(int batch, int tq, int heads, int head_dim,
                          Fn&& fn) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long items = (long)batch * heads * ((tq + kFBM - 1) / kFBM);
  switch (fma_group_cols(items, head_dim, sms)) {
    case 256:
      return fn(GroupCols<256>{});
    case 128:
      return fn(GroupCols<128>{});
    default:
      return fn(GroupCols<64>{});
  }
}

bool bad_dim(int head_dim) {
  return head_dim < kFMinDim || head_dim > kFMaxDim || head_dim % 4 != 0;
}

// A launch of fma_fwd_kernel<GC> at this shape: its grid, one cluster a
// query tile's groups, and the kernel's dynamic shared memory (its limit
// set first, as it must be above 48 KB).
struct FmaLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  int groups;

  template <int GC>
  cudaError_t init(int batch, int tq, int heads, int head_dim,
                   cudaStream_t s) {
    groups = (head_dim + GC - 1) / GC;
    cfg.gridDim = dim3(batch * heads * groups, (tq + kFBM - 1) / kFBM);
    cfg.blockDim = dim3(kFThreads);
    cfg.dynamicSmemBytes = FmaSmem<GC>::kBytes;
    cfg.stream = s;
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = groups;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return cudaFuncSetAttribute(fma_fwd_kernel<GC>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)FmaSmem<GC>::kBytes);
  }
};

}  // namespace

// As rtt_flash_fwd (flash_fwd.cu), for f32 inputs and outputs (dtype and
// out_dtype 0) and head_dim a multiple of 4 from 132 to 1024; anything
// else is cudaErrorInvalidValue.
extern "C" int rtt_flash_fma_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int tq,
                                 int tk, int heads, int head_dim, float scale,
                                 int causal, int dtype, int out_dtype,
                                 void* stream) {
  if (bad_args(batch, tq, tk, heads, dtype, out_dtype) || dtype != 0 ||
      bad_dim(head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_group_cols(batch, tq, heads, head_dim, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    FmaLaunch l;
    cudaError_t e = l.init<GC>(batch, tq, heads, head_dim, s);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&l.cfg, fma_fwd_kernel<GC>,
                           static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<float*>(o), static_cast<float*>(lse),
                           heads, head_dim, tq, tk, scale, causal,
                           l.groups);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// The kernel a launch at (batch, tq, heads, head_dim) takes: out[0]
// registers per thread, out[1] static shared bytes, out[2] the dynamic
// shared bytes its launch sets, out[3] its group width GC, out[4] how many
// of its clusters the card holds at once, out[5] how many clusters the
// launch has (one a query tile).
extern "C" int rtt_flash_fma_attrs(int batch, int tq, int heads,
                                   int head_dim, int* out) {
  if (batch <= 0 || tq <= 0 || heads <= 0 || bad_dim(head_dim))
    return (int)cudaErrorInvalidValue;
  return (int)by_group_cols(batch, tq, heads, head_dim, [&](auto gc) {
    constexpr int GC = decltype(gc)::value;
    FmaLaunch l;
    cudaError_t e = l.init<GC>(batch, tq, heads, head_dim, nullptr);
    if (e == cudaSuccess) e = func_attrs(fma_fwd_kernel<GC>, out);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&out[4], fma_fwd_kernel<GC>, &l.cfg);
    out[3] = GC;
    out[5] = (int)(l.cfg.gridDim.x / l.groups * l.cfg.gridDim.y);
    return e;
  });
}
