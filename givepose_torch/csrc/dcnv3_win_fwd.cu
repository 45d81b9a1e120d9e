// Windowed DCNv3 forward for Hopper, sm_90a: every sample clamped to its
// query's centre +- window px.
//
// Replaces the TPU kernel
// givepose_tpu/ops/dcnv3_window_pallas.py:_win_kernel (reached through
// dcnv3_windowed_pallas and dcnv3_windowed).  That kernel lays the input
// out as a y-major slab and samples with two-hot x-weight matmuls and a
// y-weight FMA sweep because Mosaic cannot gather; its bf16 intermediates
// (rmix, ey) are TPU roundings, not part of the function.  Here the
// function is ported, not that structure: pointwise bilinear samples
// summed in f32 with f32 weights, in the plain version's tap order.
//
// Contract (givepose_torch/ops/dcnv3.py:dcnv3_core with window > 0):
//   x      (N, H, W, G*gc)     bf16 or f32, channels-last, unpadded
//   offset (N, Ho, Wo, G*P*2)  f32, last dim ordered (g, p, xy)
//   mask   (N, Ho, Wo, G*P)    f32, softmaxed over P
//   out    (N, Ho, Wo, G*gc)   f32
// The sampling location, clamp included, is dcnv3_common.cuh's, shared
// with the backward, so both pick the same floor() neighbour as the plain
// version.
//
// Bound: memory.  About 10 flop per tap and channel against x, offset
// and mask read once and out written once: the three MAPEncoder layers
// at batch 32 move 151 MB, 45 us at 3.35 TB/s, a third of it the f32 out.
//
// Design: the window bounds what a tile can read.  A tile of tr x tc
// output pixels of one (image, group) at stride s reaches only
//     (s*(tr-1) + 2*window + 2) x (s*(tc-1) + 2*window + 2)
// input pixels (floor of a clamped location lies in [c - window,
// c + window], its +1 neighbour one further), its slab.  So a block
//   - stages the slab, gc channels a pixel, into shared memory with one
//     TMA load of a 4-d box of x (C, W, H, N), whose out-of-image part
//     the copy fills with zeros (the pad band); where TMA's rules fail
//     (a row of gc channels not a multiple of 16 bytes, x misaligned)
//     the block copies it itself, zeros included;
//   - meanwhile computes each (pixel, tap) of the tile once (the shared
//     tap_corners) into a table in shared memory: the slab offset of its
//     top-left corner, its fractional parts and its mask (16 bytes); all
//     four corners lie in the slab, and one outside the image reads the
//     slab's zero, so the table keeps no validity;
//   - then samples from shared memory only: lanes_per_pixel lanes cover a
//     pixel's gc channels, VEC adjacent channels a lane (8 for gc 64:
//     one 16-byte shared load of bf16 per corner, a pixel's corner one
//     128-byte wavefront), 32 / lanes_per_pixel pixels a warp, and stores
//     VEC f32 results in 16-byte stores.
// The tiling is chosen in Python (ops/dcnv3_cuda.py win_plan) and passed
// in: tile rows and columns, tiles a block walks (the next slab staged
// into a second buffer and the next tile's offsets loaded while the
// current one is sampled), the staging and the shared bytes, which this
// file recomputes and checks.  By default a block takes one 4 x 8 tile
// (53 KB of shared memory at gc 64 in bf16: four blocks an SM).
//
// Where it stands (tools/win_kernel_split.py, NVIDIA H100 80GB HBM3 at
// 700 W, the three MAPEncoder layers at batch 32): 103 us against the
// 45 us bound, where B1's tiled body with the same window takes 127 us
// and this kernel's earlier design (a warp a pixel, taps broadcast by
// shuffles) took 345.  By part: staging the slabs and storing one value
// an output takes 76 us, of which the stores and the blocks' own cost
// 40; without the corner gathers the kernel takes 87.  Each block's
// stage, sample and store run in turn, and overlap only across the four
// blocks of an SM.  Walking several tiles a block with the next slab in
// flight, a ring of input rows that loads only the new rows of each
// tile down a column (half the slabs' L2 traffic), clusters sharing
// their common rows by TMA multicast, the block's own copies in place of
// TMA, larger tiles and one block an (image, group) were each slower
// there (PERF.md).

#include "dcnv3_common.cuh"
#include "hopper_common.cuh"

#include <stdint.h>

namespace {

using dcnv3::Corners;
using dcnv3::Params;
using dcnv3::load_n;
using dcnv3::tap_corners;
using hopper::fence_async_smem;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;

constexpr int kThreads = 256;
constexpr int kBarBytes = 128;        // the slab buffers' mbarriers
constexpr int kMaxStages = 2;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxBox = 256;          // TMA: elements along a box dimension
constexpr int kFill = 2;              // tap entries a thread fills a tile

// A block's work (ops/dcnv3_cuda.py WinPlan): tiles of tr x tc output
// pixels of one (image, group), per_block consecutive tiles of an image
// (row-major over its n_rt x n_ct tiles), each tile's slab staged into
// one of `stages` buffers.
struct Plan {
  int tr, tc;             // output rows and columns of a tile
  int rows, cols;         // input pixels of a slab
  int n_ct, n_tiles;      // tiles along a row of tiles, tiles an image
  int per_block, chunks;  // tiles a block walks, blocks an (image, group)
  int stages;             // slab buffers
  int tma;                // 1: TMA loads, 0: the block's own copies
  int wide;               // copies in 16-byte units
  int slab_stride;        // bytes between slab buffers, 128-aligned
  int box_bytes;          // bytes a slab's TMA box writes
};

template <int VEC>
__device__ __forceinline__ void store_n(float* p, const float* v) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// lanes that cover a pixel's gc channels, VEC a lane: a power of two, at
// most a warp (a warp then loops over the channels)
template <int VEC>
__host__ __device__ inline int lanes_per_pixel(int gc) {
  const int need = (gc + VEC - 1) / VEC;
  int lp = 1;
  while (lp < need && lp < 32) lp *= 2;
  return lp;
}

// top-left input pixel (x, y; unpadded coordinates) of the slab of the
// tile whose first output pixel is (oh0, ow0)
__device__ __forceinline__ int2 slab_origin(const Params& p, int oh0,
                                            int ow0) {
  const int half = (p.dilation * (p.kernel - 1)) / 2;
  return make_int2(half + p.stride * ow0 - p.window - p.pad,
                   half + p.stride * oh0 - p.window - p.pad);
}

// thread 0: one slab by TMA into `dst`, completing on `bar`
__device__ __forceinline__ void issue_slab(const CUtensorMap* map,
                                           uint32_t bar, void* dst,
                                           const Params& p, const Plan& plan,
                                           int n, int g, int2 org) {
  fence_async_smem();  // the block's reads of the buffer came first
  mbar_expect_tx(bar, plan.box_bytes);
  tma_load_4d(smem_u32(dst), map, g * p.gc, org.x, org.y, n, bar);
}

// the whole block: one slab by its own loads, zeros outside the image
template <typename T>
__device__ __forceinline__ void copy_slab(const T* __restrict__ x, T* slab,
                                          const Params& p, const Plan& plan,
                                          int n, int g, int2 org) {
  const int c_total = p.group * p.gc;
  const int per = plan.wide ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int units = p.gc / per;
  const int cells = plan.rows * plan.cols;
  const T* xg = x + static_cast<long long>(n) * p.h * p.w * c_total +
                static_cast<long long>(g) * p.gc;
  for (int i = threadIdx.x; i < cells * units; i += kThreads) {
    const int u = i % units;
    const int cell = i / units;
    const int y = org.y + cell / plan.cols, xx = org.x + cell % plan.cols;
    const bool in = y >= 0 && y < p.h && xx >= 0 && xx < p.w;
    const T* src = xg + (static_cast<long long>(y) * p.w + xx) * c_total +
                   u * per;
    T* dst = slab + static_cast<long long>(cell) * p.gc + u * per;
    if (plan.wide) {
      *reinterpret_cast<uint4*>(dst) =
          in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      *dst = in ? *src : T(0.0f);
    }
  }
}

// One (pixel, tap) of a tile: the slab offset (elements) of its
// top-left corner, its fractional parts and its mask.  The four corners
// lie in the slab, and a corner outside the image reads the slab's zero
// there, so no validity is kept.
struct SlabTap {
  int base;
  float fx, fy, m;
};

// Tap `tap` of output pixel (oh, ow) with its offset and mask, in the
// slab whose origin is `org`.  Every corner of a clamped sample lies in
// the slab: only a NaN location (whose weights are NaN) has its corner
// moved into it.
__device__ __forceinline__ SlabTap slab_tap(const Params& p, const Plan& plan,
                                            int2 org, int oh, int ow, int tap,
                                            float off_x, float off_y,
                                            float m) {
  const Corners c = tap_corners(p, oh, ow, tap / p.kernel, tap % p.kernel,
                                off_x, off_y);
  const int sx = min(max(c.x0 - org.x, 0), plan.cols - 2);
  const int sy = min(max(c.y0 - org.y, 0), plan.rows - 2);
  return SlabTap{(sy * plan.cols + sx) * p.gc, c.fx, c.fy, m};
}

// A thread's share of one tile's taps (entries threadIdx.x + j * kThreads
// of the tile's table, pixel-major), their offsets and masks loaded from
// global memory ahead of their use, so that the loads' latency hides
// behind the sampling of the tile before
struct TapLoads {
  float ox[kFill], oy[kFill], m[kFill];
};

__device__ __forceinline__ TapLoads load_taps(const Params& p,
                                              const float* __restrict__ offset,
                                              const float* __restrict__ mask,
                                              const Plan& plan, int n, int g,
                                              int2 o) {
  const int K = p.kernel * p.kernel;
  TapLoads r;
#pragma unroll
  for (int j = 0; j < kFill; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int pix = e / K;
    const int oh = o.x + pix / plan.tc, ow = o.y + pix % plan.tc;
    const bool ok = e < plan.tr * plan.tc * K && oh < p.ho && ow < p.wo;
    const long long at =
        ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) * p.group * K +
        g * K + (e - pix * K);
    r.ox[j] = ok ? offset[2 * at] : 0.0f;
    r.oy[j] = ok ? offset[2 * at + 1] : 0.0f;
    r.m[j] = ok ? mask[at] : 0.0f;
  }
  return r;
}

// the thread's share of the taps of the tile at o into its table
__device__ __forceinline__ void store_taps(const Params& p, const Plan& plan,
                                           int2 o, const TapLoads& r,
                                           SlabTap* taps) {
  const int K = p.kernel * p.kernel;
  const int2 org = slab_origin(p, o.x, o.y);
#pragma unroll
  for (int j = 0; j < kFill; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int pix = e / K;
    const int oh = o.x + pix / plan.tc, ow = o.y + pix % plan.tc;
    if (e < plan.tr * plan.tc * K && oh < p.ho && ow < p.wo) {
      taps[e] = slab_tap(p, plan, org, oh, ow, e - pix * K, r.ox[j], r.oy[j],
                         r.m[j]);
    }
  }
}

// one tap's four corners, weighted (bilinear weights times the mask),
// into acc; dx and dy: elements between columns and rows of the slab
template <typename T, int VEC>
__device__ __forceinline__ void add_tap(const T* slab, const SlabTap& e,
                                        int c, int dx, int dy, float* acc) {
  const float gx = 1.0f - e.fx, a = (1.0f - e.fy) * e.m, b = e.fy * e.m;
  const float w[4] = {gx * a, e.fx * a, gx * b, e.fx * b};
  const T* at = slab + e.base + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float val[VEC];
    load_n<VEC>(at + (k >> 1) * dy + (k & 1) * dx, val, true);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += w[k] * val[v];
  }
}

// every output pixel of the tile at (oh0, ow0), group g, from the slab
template <typename T, int VEC, int KK>
__device__ __forceinline__ void sample_tile(const T* slab,
                                            const SlabTap* taps,
                                            float* __restrict__ out,
                                            const Params& p, const Plan& plan,
                                            int n, int g, int oh0, int ow0) {
  const int K = KK > 0 ? KK : p.kernel * p.kernel;
  const int lp = lanes_per_pixel<VEC>(p.gc);
  const int lane = threadIdx.x & 31;
  const int c_total = p.group * p.gc;
  for (int q = (threadIdx.x >> 5) * (32 / lp) + lane / lp;
       q < plan.tr * plan.tc; q += kThreads / lp) {
    const int oh = oh0 + q / plan.tc, ow = ow0 + q % plan.tc;
    if (oh >= p.ho || ow >= p.wo) continue;
    float* o = out + ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) *
                         c_total + g * p.gc;
    const SlabTap* t = taps + q * K;
    for (int c = (lane % lp) * VEC; c < p.gc; c += lp * VEC) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      // taps in the plain version's order: x varies slowly, y fast; two at
      // a time in flight, so that four blocks share an SM (64 registers)
#pragma unroll 2
      for (int tap = 0; tap < (KK > 0 ? KK : K); ++tap)
        add_tap<T, VEC>(slab, t[tap], c, p.gc, plan.cols * p.gc, acc);
      store_n<VEC>(o + c, acc);
    }
  }
}

// KK: kernel*kernel when fixed at compile time (9), else 0.  A block
// walks its tiles in a software pipeline: while it samples tile i, the
// slab of tile i + 1 is in flight (two slab buffers) and the offsets and
// masks of tile i + 2 are on their way into registers; tile i + 1's taps
// go into the second tap table after the sampling.
template <typename T, int VEC, int KK>
__global__ void __launch_bounds__(kThreads, 4)
dcnv3_win_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                     const T* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask, float* __restrict__ out,
                     Params p, Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* slabs = smem + kBarBytes;
  SlabTap* tables =
      reinterpret_cast<SlabTap*>(slabs + plan.stages * plan.slab_stride);
  const int table = plan.tr * plan.tc * p.kernel * p.kernel;

  int b = blockIdx.x;
  const int g = b % p.group;
  b /= p.group;
  const int first = (b % plan.chunks) * plan.per_block;
  const int n = b / plan.chunks;
  const int count = min(plan.per_block, plan.n_tiles - first);

  auto tile = [&](int i) {  // first output pixel (oh0, ow0) of tile i
    const int t = first + i;
    return make_int2(t / plan.n_ct * plan.tr, t % plan.n_ct * plan.tc);
  };
  auto buffer = [&](int i) {
    return slabs + (i % plan.stages) * plan.slab_stride;
  };
  if (plan.tma && threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < plan.stages && i < count; ++i) {
      const int2 o = tile(i);
      issue_slab(&xmap, smem_u32(bars + i), buffer(i), p, plan, n, g,
                 slab_origin(p, o.x, o.y));
    }
  }
  TapLoads next = load_taps(p, offset, mask, plan, n, g, tile(0));
  store_taps(p, plan, tile(0), next, tables);
  if (count > 1) next = load_taps(p, offset, mask, plan, n, g, tile(1));
  __syncthreads();

  for (int i = 0; i < count; ++i) {
    const int2 o = tile(i);
    T* slab = reinterpret_cast<T*>(buffer(i));
    if (plan.tma) {
      mbar_wait(smem_u32(bars + i % plan.stages), (i / plan.stages) & 1);
    } else {
      copy_slab(x, slab, p, plan, n, g, slab_origin(p, o.x, o.y));
      __syncthreads();
    }
    sample_tile<T, VEC, KK>(slab, tables + (i & 1) * table, out, p, plan, n,
                            g, o.x, o.y);
    if (i + 1 < count) {
      store_taps(p, plan, tile(i + 1), next,
                 tables + ((i + 1) & 1) * table);
      if (i + 2 < count) {
        next = load_taps(p, offset, mask, plan, n, g, tile(i + 2));
      }
    }
    __syncthreads();
    if (plan.tma && threadIdx.x == 0 && i + plan.stages < count) {
      const int2 o2 = tile(i + plan.stages);
      issue_slab(&xmap, smem_u32(bars + i % plan.stages), buffer(i), p, plan,
                 n, g, slab_origin(p, o2.x, o2.y));
    }
  }
}

int span(int t, const Params& p) {
  return p.stride * (t - 1) + 2 * p.window + 2;
}

// the tiled tensor map of x, (C, W, H, N) innermost first, read in boxes
// of one group's channels over a slab
template <typename T>
bool x_map(CUtensorMap* map, const void* x, const Params& p,
           const Plan& plan) {
  hopper::EncodeTiled encode = hopper::encoder();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t c_total = static_cast<cuuint64_t>(p.group) * p.gc;
  const cuuint64_t dims[4] = {c_total, static_cast<cuuint64_t>(p.w),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[3] = {c_total * es, c_total * es * p.w,
                                 c_total * es * p.w * p.h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.gc),
                             static_cast<cuuint32_t>(plan.cols),
                             static_cast<cuuint32_t>(plan.rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the plan's derived fields and its shared bytes; false for a plan this
// file does not take
bool make_plan(const Params& p, size_t elem, int tr, int tc, int per_block,
               int stages, int tma, const void* x, Plan* plan,
               size_t* smem) {
  if (tr < 1 || tc < 1 || per_block < 1 || stages < 1 ||
      stages > kMaxStages || (tma != 0 && tma != 1) || (!tma && stages != 1))
    return false;
  const int c_total = p.group * p.gc;
  const bool aligned = (p.gc * elem) % 16 == 0 &&
                       (c_total * elem) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  plan->tr = tr;
  plan->tc = tc;
  plan->rows = span(tr, p);
  plan->cols = span(tc, p);
  plan->n_ct = (p.wo + tc - 1) / tc;
  plan->n_tiles = plan->n_ct * ((p.ho + tr - 1) / tr);
  plan->per_block = per_block;
  plan->chunks = (plan->n_tiles + per_block - 1) / per_block;
  plan->stages = stages;
  plan->tma = tma;
  plan->wide = aligned;
  const size_t slab = static_cast<size_t>(plan->rows) * plan->cols * p.gc *
                      elem;
  plan->slab_stride = static_cast<int>((slab + 127) / 128 * 128);
  plan->box_bytes = plan->rows * plan->cols * p.gc * static_cast<int>(elem);
  if (tma && (!aligned || p.gc > kMaxBox || plan->cols > kMaxBox ||
              plan->rows > kMaxBox))
    return false;
  const int entries = tr * tc * p.kernel * p.kernel;
  if (entries > kFill * kThreads) return false;
  *smem = kBarBytes + static_cast<size_t>(stages) * plan->slab_stride +
          static_cast<size_t>(per_block > 1 ? 2 : 1) * entries *
              sizeof(SlabTap);
  return true;
}

template <typename T, int VEC, int KK>
int launch(const void* x, const void* offset, const void* mask, void* out,
           const Params& p, const Plan& plan, size_t smem,
           cudaStream_t stream) {
  CUtensorMap map{};
  if (plan.tma && !x_map<T>(&map, x, p, plan)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  auto kernel = dcnv3_win_fwd_kernel<T, VEC, KK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks =
      static_cast<long long>(p.n) * p.group * plan.chunks;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      map, static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(out), p, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_kk(const void* x, const void* offset, const void* mask,
              void* out, const Params& p, const Plan& plan, size_t smem,
              cudaStream_t s) {
  return p.kernel == 3
             ? launch<T, VEC, 9>(x, offset, mask, out, p, plan, smem, s)
             : launch<T, VEC, 0>(x, offset, mask, out, p, plan, smem, s);
}

template <typename T>
int launch_vec(const void* x, const void* offset, const void* mask,
               void* out, const Params& p, const Plan& plan, size_t smem,
               int vec, cudaStream_t s) {
  switch (vec) {
    case 8: return launch_kk<T, 8>(x, offset, mask, out, p, plan, smem, s);
    case 4: return launch_kk<T, 4>(x, offset, mask, out, p, plan, smem, s);
    case 2: return launch_kk<T, 2>(x, offset, mask, out, p, plan, smem, s);
    default: return launch_kk<T, 1>(x, offset, mask, out, p, plan, smem, s);
  }
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); window > 0; vec (8, 4, 2 or 1) divides gc: the
// channels a lane gathers at once from the slab.  The plan (ops/
// dcnv3_cuda.py win_plan): tile_rows x tile_cols output pixels a tile,
// tiles_per_block tiles a block, stages slab buffers (1 or 2; 1 when the
// block copies), tma 1 to stage by TMA (x 16-byte aligned, gc and G*gc
// channels whole multiples of 16 bytes) or 0 for the block's own copies,
// and smem_bytes, the shared memory the plan needs, which must equal this
// file's count.  Every image must have fewer than 2^31 elements.  Returns
// a CUDA error code: that of the launch (cudaGetLastError) or of raising
// the shared-memory limit, cudaErrorInvalidValue for a window, vec or
// plan it does not take, cudaErrorInvalidConfiguration when the plan's
// shared memory exceeds a block's, cudaErrorNotSupported when
// cuTensorMapEncodeTiled is missing or refuses the tensor map.
extern "C" int dcnv3_win_fwd(const void* x, int x_bf16, const void* offset,
                             const void* mask, void* out, int n, int h,
                             int w, int ho, int wo, int group, int gc,
                             int kernel, int stride, int pad, int dilation,
                             float offset_scale, int window, int vec,
                             int tile_rows, int tile_cols,
                             int tiles_per_block, int stages, int tma,
                             int smem_bytes, void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group == 0) return static_cast<int>(cudaGetLastError());
  if (window <= 0 || kernel < 1 ||
      (vec != 8 && vec != 4 && vec != 2 && vec != 1) || gc % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t elem = x_bf16 ? 2 : 4;
  Plan plan;
  size_t smem = 0;
  if (!make_plan(p, elem, tile_rows, tile_cols, tiles_per_block, stages, tma,
                 x, &plan, &smem) ||
      smem != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  return x_bf16 ? launch_vec<__nv_bfloat16>(x, offset, mask, out, p, plan,
                                            smem, vec, s)
                : launch_vec<float>(x, offset, mask, out, p, plan, smem,
                                    vec, s);
}
