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
// summed in f32 with f32 weights, as dcnv3_fwd.cu.
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
// Bound: memory, as the unwindowed forward (about 10 flop per tap and
// channel against x, offset and mask read once and out written once: at
// batch 32 the first MAPEncoder layer moves ~115 MB, ~34 us at 3.35
// TB/s).  What the window buys on this card: a tile of TR output rows and
// TC output columns of one (n, group) can reach only
//     (stride*(TR-1) + 2*window + 2) x (stride*(TC-1) + 2*window + 2)
// input pixels (floor of a clamped location lies in [c - window,
// c + window], its +1 neighbour one further).  So a block stages that
// slab of x, gc channels per pixel in x's dtype, in shared memory once
// (16-byte copies where aligned) and then gathers every tap from shared
// memory, where the unwindowed kernel reads each input pixel ~9 times
// through L2.  The tile is chosen on the host: full output width and as
// many rows (at most 4) as fit in 56 KB, so four blocks share an SM;
// fewer columns when one row does not fit (at layer 0, 64x64 input, gc
// 64, bf16, stride 2, window 4: one row of 18 columns, a 10 x 44 pixel
// slab of 55 KB).  Sampling is B1's layout, one warp per output pixel of
// the tile with each lane owning VEC adjacent channels (bank-conflict-free
// reads of 4 or 8 bytes per lane), except that each tap's footprint is
// computed once per warp, by lane `tap`, and broadcast by shuffles: the
// location and weight arithmetic, repeated by every lane in B1, costs as
// much as the gathers.  With both the kernel runs at about B1's speed
// (PERF.md), so the slab saves no time on this card yet: L2 already
// serves B1's repeated reads.

#include "dcnv3_common.cuh"

#include <stdint.h>

namespace {

using dcnv3::Corners;
using dcnv3::Params;
using dcnv3::load_vec;
using dcnv3::tap_corners;

constexpr int kThreads = 256;
constexpr size_t kTileBudget = 56 * 1024;    // four blocks per SM
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxTileRows = 4;

struct Tile {
  int tr, tc;       // output rows and columns per block
  int rows, cols;   // input pixels the slab holds
  int n_rt, n_ct;   // tiles along rows and columns
  size_t bytes;     // dynamic shared memory
};

int span(int t, const Params& p) {
  return p.stride * (t - 1) + 2 * p.window + 2;
}

Tile make_tile(const Params& p, int tr, int tc, size_t elem) {
  Tile t;
  t.tr = tr;
  t.tc = tc;
  t.rows = span(tr, p);
  t.cols = span(tc, p);
  t.n_rt = (p.ho + tr - 1) / tr;
  t.n_ct = (p.wo + tc - 1) / tc;
  t.bytes = static_cast<size_t>(t.rows) * t.cols * p.gc * elem;
  return t;
}

// Full output width and the most rows that fit the budget; fewer columns
// when one full row does not; a single pixel up to the card's limit.
bool choose_tile(const Params& p, size_t elem, Tile* out) {
  for (int tr = kMaxTileRows < p.ho ? kMaxTileRows : p.ho; tr >= 1; --tr) {
    const Tile t = make_tile(p, tr, p.wo, elem);
    if (t.bytes <= kTileBudget) {
      *out = t;
      return true;
    }
  }
  for (int tc = p.wo - 1; tc >= 1; --tc) {
    const Tile t = make_tile(p, 1, tc, elem);
    if (t.bytes <= kTileBudget || (tc == 1 && t.bytes <= kMaxSmem)) {
      *out = t;
      return true;
    }
  }
  return false;
}

template <typename T, int VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
dcnv3_win_fwd_kernel(const T* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask, float* __restrict__ out,
                     Params p, Tile tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  int b = blockIdx.x;
  const int ct = b % tile.n_ct;
  b /= tile.n_ct;
  const int rt = b % tile.n_rt;
  b /= tile.n_rt;
  const int g = b % p.group;
  const int n = b / p.group;

  const int half = (p.dilation * (p.kernel - 1)) / 2;
  const int oh0 = rt * tile.tr, ow0 = ct * tile.tc;
  const int oh1 = min(oh0 + tile.tr, p.ho), ow1 = min(ow0 + tile.tc, p.wo);
  // slab origin in unpadded input coordinates
  const int y_org = half + p.stride * oh0 - p.window - p.pad;
  const int x_org = half + p.stride * ow0 - p.window - p.pad;
  const int c_total = p.group * p.gc;
  const T* xg = x + static_cast<long long>(n) * p.h * p.w * c_total +
                static_cast<long long>(g) * p.gc;

  // stage the slab; cells outside the image are never read (below)
  const int cells = tile.rows * tile.cols;
  constexpr int kPer = WIDE ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int units = p.gc / kPer;
  for (int i = threadIdx.x; i < cells * units; i += kThreads) {
    const int u = i % units;
    const int cell = i / units;
    const int y = y_org + cell / tile.cols;
    const int xx = x_org + cell % tile.cols;
    if (y < 0 || y >= p.h || xx < 0 || xx >= p.w) continue;
    const T* src = xg + (static_cast<long long>(y) * p.w + xx) * c_total +
                   u * kPer;
    T* dst = slab + static_cast<long long>(cell) * p.gc + u * kPer;
    if (WIDE) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      *dst = *src;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tw = ow1 - ow0;
  const int n_pix = (oh1 - oh0) * tw;
  const int taps = p.kernel * p.kernel;           // <= 32 (host checks)
  for (int q = warp; q < n_pix; q += kThreads / 32) {
    const int oh = oh0 + q / tw, ow = ow0 + q % tw;
    const long long pix =
        (static_cast<long long>(n) * p.ho + oh) * p.wo + ow;
    const float* off = offset + pix * (2LL * p.group * taps) + 2LL * g * taps;
    const float* msk = mask + pix * (static_cast<long long>(p.group) * taps) +
                       static_cast<long long>(g) * taps;
    float* og = out + pix * c_total + static_cast<long long>(g) * p.gc;

    // lane t < taps computes tap t's footprint once; the taps are then
    // broadcast by shuffles.  Slab coordinates: every in-image corner of a
    // clamped sample lies in the slab, the bounds only guard shared memory
    int t_sx = 0, t_sy = 0, t_valid = 0;
    float t_fx = 0.0f, t_fy = 0.0f, t_m = 0.0f;
    if (lane < taps) {
      const Corners k = tap_corners(p, oh, ow, lane / p.kernel,
                                    lane % p.kernel, off[2 * lane],
                                    off[2 * lane + 1]);
      t_sx = k.x0 - x_org;
      t_sy = k.y0 - y_org;
      t_valid = (k.vx0 && t_sx >= 0 && t_sx < tile.cols) |
                (k.vx1 && t_sx + 1 >= 0 && t_sx + 1 < tile.cols) << 1 |
                (k.vy0 && t_sy >= 0 && t_sy < tile.rows) << 2 |
                (k.vy1 && t_sy + 1 >= 0 && t_sy + 1 < tile.rows) << 3;
      t_fx = k.fx;
      t_fy = k.fy;
      t_m = msk[lane];
    }

    for (int c0 = 0; c0 < p.gc; c0 += 32 * VEC) {
      const int c = c0 + lane * VEC;
      const bool active = c < p.gc;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

      // taps in the plain version's order: x varies slowly, y fast
      for (int tap = 0; tap < taps; ++tap) {
        const int sx = __shfl_sync(0xffffffffu, t_sx, tap);
        const int sy = __shfl_sync(0xffffffffu, t_sy, tap);
        const int valid = __shfl_sync(0xffffffffu, t_valid, tap);
        const float fx = __shfl_sync(0xffffffffu, t_fx, tap);
        const float fy = __shfl_sync(0xffffffffu, t_fy, tap);
        const float m = __shfl_sync(0xffffffffu, t_m, tap);
        const bool ix0 = valid & 1, ix1 = valid & 2;
        const bool iy0 = valid & 4, iy1 = valid & 8;
        const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
        const float w01 = (1.0f - fx) * fy, w11 = fx * fy;

        float tap_sum[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) tap_sum[v] = 0.0f;
        if (active) {
          float val[VEC];
          const T* row0 =
              slab + (static_cast<long long>(sy) * tile.cols + sx) * p.gc +
              c;
          const T* row1 = row0 + static_cast<long long>(tile.cols) * p.gc;
          if (iy0 && ix0) {
            load_vec(row0, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w00;
          }
          if (iy0 && ix1) {
            load_vec(row0 + p.gc, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w10;
          }
          if (iy1 && ix0) {
            load_vec(row1, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w01;
          }
          if (iy1 && ix1) {
            load_vec(row1 + p.gc, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w11;
          }
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += tap_sum[v] * m;
      }
      if (active) {
        if (VEC == 2) {
          *reinterpret_cast<float2*>(og + c) =
              make_float2(acc[0], acc[VEC - 1]);
        } else {
          og[c] = acc[0];
        }
      }
    }
  }
}

template <typename T, int VEC, bool WIDE>
int launch(const void* x, const void* offset, const void* mask, void* out,
           const Params& p, const Tile& tile, cudaStream_t stream) {
  auto kernel = dcnv3_win_fwd_kernel<T, VEC, WIDE>;
  if (tile.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks =
      static_cast<long long>(p.n) * p.group * tile.n_rt * tile.n_ct;
  kernel<<<static_cast<unsigned>(blocks), kThreads, tile.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(out), p, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* offset, const void* mask, void* out,
             const Params& p, int vec, cudaStream_t stream) {
  Tile tile;
  if (!choose_tile(p, sizeof(T), &tile)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int c_total = p.group * p.gc;
  const bool wide = (p.gc * sizeof(T)) % 16 == 0 &&
                    (c_total * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec == 2) {
    return wide ? launch<T, 2, true>(x, offset, mask, out, p, tile, stream)
                : launch<T, 2, false>(x, offset, mask, out, p, tile, stream);
  }
  return wide ? launch<T, 1, true>(x, offset, mask, out, p, tile, stream)
              : launch<T, 1, false>(x, offset, mask, out, p, tile, stream);
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); window > 0; kernel <= 5 (a lane per tap); vec is 2
// when every lane may move two channels at once (gc even), else 1.
// Returns a CUDA error code: that of the launch (cudaGetLastError), of
// raising the shared-memory limit, cudaErrorInvalidValue for a window or
// kernel it does not take, or cudaErrorInvalidConfiguration when not even
// a one-pixel slab fits in shared memory.
extern "C" int dcnv3_win_fwd(const void* x, int x_bf16, const void* offset,
                             const void* mask, void* out, int n, int h,
                             int w, int ho, int wo, int group, int gc,
                             int kernel, int stride, int pad, int dilation,
                             float offset_scale, int window, int vec,
                             void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group == 0) return static_cast<int>(cudaGetLastError());
  if (window <= 0 || kernel * kernel > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return x_bf16 ? dispatch<__nv_bfloat16>(x, offset, mask, out, p, vec, s)
                : dispatch<float>(x, offset, mask, out, p, vec, s);
}
