// DCNv3 backward (unbounded or windowed offsets) for Hopper, sm_90a.
//
// Replaces the TPU kernel
// givepose_tpu/ops/dcnv3_pallas_bwd.py:_dcnv3_bwd_kernel, the backward of
// dcnv3_fast and, on window-clamped locations, of dcnv3_windowed
// (givepose_tpu/ops/dcnv3_window_pallas.py:326).  That kernel is the
// transpose of the forward's two-hot matmuls (Mosaic has no gather or
// scatter) and leaves the chain rule through the sampling prep, the
// window clamp included, to XLA.  Here the whole gradient is computed
// pointwise: the transpose of the forward's gather is a scatter.
//
// Contract (autograd of givepose_torch/ops/dcnv3.py:dcnv3_core, any
// window):
//   x        (N, H, W, G*gc)     bf16 or f32, the forward's input
//   offset   (N, Ho, Wo, G*P*2)  f32, last dim ordered (g, p, xy)
//   mask     (N, Ho, Wo, G*P)    f32
//   grad_out (N, Ho, Wo, G*gc)   f32
//   d_x      (N, H, W, G*gc)     f32, zeroed by the caller, accumulated
//   d_offset (N, Ho, Wo, G*P*2)  f32, written
//   d_mask   (N, Ho, Wo, G*P)    f32, written
// floor() has zero gradient, so d(location) is d(fractional part); a
// corner outside the image (pad band or beyond) has neither value nor
// gradient; d_offset = d_location * clip' * offset_scale, where clip' is
// the window clamp's gradient (1 without a window; with one, 1 strictly
// inside, 0.5 on the bound, 0 where the clamp holds the sample: the
// jnp.clip semantics of the JAX package).  The samples themselves are
// taken at the clamped location, as in the windowed forward.  With w_k
// the bilinear weights, m the mask and dot_k the dot product of corner k
// with grad_out over the group's channels:
//   d_mask   = sum_k w_k dot_k
//   d_fx     = m ((1-fy)(dot_10 - dot_00) + fy (dot_11 - dot_01))
//   d_fy     = m ((1-fx)(dot_01 - dot_00) + fx (dot_11 - dot_10))
//   d_x[corner k] += m w_k grad_out
// The scatter into d_x is a sum of f32 reductions in no fixed order, so
// d_x is nondeterministic in its last bits: the order in which the ~9
// contributions to one input value land changes from run to run.
//
// Bound: memory.  About 16 flop per (pixel, group, tap, channel) against
// x, grad_out, offset, mask read once and d_x, d_offset, d_mask written
// once: at training batch 48 the first MAPEncoder layer moves ~395 MB,
// ~118 us at 3.35 TB/s; the caller's d_x fill writes another 201 MB.
//
// What held the first design back (one warp per (pixel, group), 2
// channels a lane; PERF.md, tools/dcnv3_breakdown.py, NVIDIA H100 80GB
// HBM3 at 700 W): at the three layers it took 1212 us, of which the
// location arithmetic repeated by every lane ~217 us, the 4-byte corner
// loads ~337 us, the float2 atomics ~347 us and the 32-lane shuffle sums
// ~72 us.  This design cuts the instructions around the scatter, as the
// forward does:
//   - a block walks a small tile of output pixels of one image (2 x 4:
//     ops/dcnv3_cuda.py dcn_tile) and computes each (pixel, group, tap)
//     once, with the shared tap_corners, into shared memory (fill_taps);
//   - one warp takes one pixel, all its groups, VEC channels a lane (4 for
//     gc 64: 8-byte loads of bf16 x, 16-byte loads of grad_out); per tap a
//     lane loads the four corners, forms its share of the four dots, and
//     adds m w_k grad_out to each corner inside the image with one 16-byte
//     reduction (red.global.add.v4.f32), a group's 16 lanes covering its
//     256 contiguous bytes of d_x in whole 32-byte sectors (with 8
//     channels a lane each reduction covers half of every sector it
//     touches, and the kernel took 1.7 times as long);
//   - the four dots are summed over the lanes of one group only (4 shuffle
//     steps for gc 64), and the group's leader lane writes them to shared
//     memory;
//   - after the tile, one thread per (pixel, group, tap) recomputes its
//     location and writes d_mask and d_offset, in the layout's order.
// What bounds it now is the rate at which L2 takes the reductions: ~9 per
// input value (36 per output channel), 1.8 GB at layer 0.  Without them
// the kernel takes ~310 us at the three layers, with them ~860
// (tools/dcnv3_breakdown.py); L2 takes ~0.8 T f32 adds/s from random rows
// (tools/reduction_probe.py).  Two ways of adding in shared memory first
// were built and dropped, both slower than this design: a d_x region per
// block with shared f32 atomicAdd (a compare-and-swap loop here,
// ATOMS.CAST.SPIN), and a region whose corners are sorted into buckets
// and summed in registers (the sort and the lower occupancy cost more than
// the reductions they saved; PERF.md).  The tile is small because the
// reductions hit L2 only while the d_x they reach stays there: with 4 x 8
// pixels a block the blocks in flight reach ~12 images' d_x at layer 0,
// and the kernel took 1.6 times as long.

#include "dcnv3_common.cuh"

namespace {

using dcnv3::Corners;
using dcnv3::Params;
using dcnv3::Tap;
using dcnv3::fill_taps;
using dcnv3::load_n;
using dcnv3::tap_corners;
using dcnv3::tap_safe;
using dcnv3::tap_valid;

constexpr int kThreads = 256;

// d_x[p .. p + VEC) += v, as f32 reductions
template <int VEC>
__device__ __forceinline__ void scatter(float* p, const float* v) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   ::"l"(p + i), "f"(v[i]), "f"(v[i + 1]), "f"(v[i + 2]),
                   "f"(v[i + 3])
                   : "memory");
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// dot[0..3] summed over the aligned segments of seg lanes
__device__ __forceinline__ void seg_sum(float* dot, int seg) {
  for (int o = 1; o < seg; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
  }
}

template <typename T, int VEC, int KK>
__global__ void __launch_bounds__(kThreads, 2)
dcnv3_bwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                 const float* __restrict__ mask,
                 const float* __restrict__ grad_out, float* __restrict__ d_x,
                 float* __restrict__ d_offset, float* __restrict__ d_mask,
                 Params p, int tile_h, int tile_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KK > 0 ? KK : p.kernel * p.kernel;
  const int gk = p.group * K;
  const int entries = tile_h * tile_w * gk;
  Tap* taps = reinterpret_cast<Tap*>(smem);
  float4* dots = reinterpret_cast<float4*>(taps + entries);
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * tile_h, ow0 = blockIdx.x * tile_w;
  fill_taps(p, offset, mask, n, oh0, ow0, tile_h, tile_w, taps);
  for (int e = threadIdx.x; e < entries; e += blockDim.x)
    dots[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int c_total = p.group * p.gc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // lanes of one group in a chunk: run = gc / VEC; aligned segments of
  // seg lanes (the largest power of two dividing run, at most 32) never
  // hold two groups
  const int run = p.gc / VEC;
  const int seg = min(run & -run, 32);
  const long long img = static_cast<long long>(n) * p.h * p.w * c_total;
  const T* xi = x + img;
  float* dxi = d_x + img;
  for (int pix = warp; pix < tile_h * tile_w; pix += kThreads / 32) {
    const int oh = oh0 + pix / tile_w, ow = ow0 + pix % tile_w;
    if (oh >= p.ho || ow >= p.wo) continue;           // whole warp
    const float* gop =
        grad_out + ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) *
                       c_total;
    // every lane runs every chunk, so the shuffles see all 32
    for (int c0 = 0; c0 < c_total; c0 += 32 * VEC) {
      const int c = c0 + lane * VEC;
      const bool active = c < c_total;
      const int g = active ? c / p.gc : 0;
      const int cc = active ? c : 0;
      float go[VEC];
      load_n<VEC>(gop + cc, go, active);
      const Tap* t = taps + (pix * p.group + g) * K;
      float4* dt = dots + (pix * p.group + g) * K;
#pragma unroll
      for (int tap = 0; tap < (KK > 0 ? KK : K); ++tap) {
        const Tap e = t[tap];
        float dot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = active && tap_valid(e.idx[k]);
          float val[VEC], add[VEC];
          load_n<VEC>(xi + tap_safe(e.idx[k]) + cc, val, ok);
          dot[k] = 0.0f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            dot[k] += go[v] * val[v];
            add[v] = go[v] * e.wgt[k];
          }
          if (ok) scatter<VEC>(dxi + tap_safe(e.idx[k]) + c, add);
        }
        seg_sum(dot, seg);
        if (active && (lane & (seg - 1)) == 0) {
          if (seg == run) {              // the group's only segment
            dt[tap] = make_float4(dot[0], dot[1], dot[2], dot[3]);
          } else {
            atomicAdd(&dt[tap].x, dot[0]);
            atomicAdd(&dt[tap].y, dot[1]);
            atomicAdd(&dt[tap].z, dot[2]);
            atomicAdd(&dt[tap].w, dot[3]);
          }
        }
      }
    }
  }
  __syncthreads();

  // d_mask and d_offset, one thread per (pixel, group, tap)
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int pix = e / gk;
    const int r = e - pix * gk;
    const int tap = r % K;
    const int oh = oh0 + pix / tile_w, ow = ow0 + pix % tile_w;
    if (oh >= p.ho || ow >= p.wo) continue;
    const long long at =
        ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) * gk + r;
    const Corners k = tap_corners(p, oh, ow, tap / p.kernel, tap % p.kernel,
                                  offset[2 * at], offset[2 * at + 1]);
    const float m = mask[at];
    const float4 d = dots[e];
    const float fx = k.fx, fy = k.fy;
    const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
    const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
    d_mask[at] = w00 * d.x + w10 * d.y + w01 * d.z + w11 * d.w;
    float d_fx = m * ((1.0f - fy) * (d.y - d.x) + fy * (d.w - d.z));
    float d_fy = m * ((1.0f - fx) * (d.z - d.x) + fx * (d.w - d.y));
    // a held sample passes no gradient, not even a NaN one
    d_fx = k.gx == 0.0f ? 0.0f : d_fx * k.gx;
    d_fy = k.gy == 0.0f ? 0.0f : d_fy * k.gy;
    *reinterpret_cast<float2*>(d_offset + 2 * at) =
        make_float2(d_fx * p.offset_scale, d_fy * p.offset_scale);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* offset, const void* mask,
           const void* grad_out, void* d_x, void* d_offset, void* d_mask,
           const Params& p, int tile_h, int tile_w, cudaStream_t stream) {
  const size_t smem =
      dcnv3::tile_smem_bytes(tile_h, tile_w, p.group, p.kernel, true);
  const dim3 grid((p.wo + tile_w - 1) / tile_w, (p.ho + tile_h - 1) / tile_h,
                  p.n);
  auto kernel = p.kernel == 3 ? dcnv3_bwd_kernel<T, VEC, 9>
                              : dcnv3_bwd_kernel<T, VEC, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(grad_out),
      static_cast<float*>(d_x), static_cast<float*>(d_offset),
      static_cast<float*>(d_mask), p, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const void* x, const void* offset, const void* mask,
               const void* grad_out, void* d_x, void* d_offset, void* d_mask,
               const Params& p, int vec, int tile_h, int tile_w,
               cudaStream_t s) {
  switch (vec) {
    case 8:
      return launch<T, 8>(x, offset, mask, grad_out, d_x, d_offset, d_mask,
                          p, tile_h, tile_w, s);
    case 4:
      return launch<T, 4>(x, offset, mask, grad_out, d_x, d_offset, d_mask,
                          p, tile_h, tile_w, s);
    case 2:
      return launch<T, 2>(x, offset, mask, grad_out, d_x, d_offset, d_mask,
                          p, tile_h, tile_w, s);
    default:
      return launch<T, 1>(x, offset, mask, grad_out, d_x, d_offset, d_mask,
                          p, tile_h, tile_w, s);
  }
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); window 0 means unbounded offsets; vec (8, 4, 2 or 1)
// is the channels a lane moves at once: it divides gc, and x and grad_out
// are aligned to min(vec * element size, 16) bytes; tile_h x tile_w
// output pixels per block, whose taps and dots fit in shared memory (the
// wrapper chooses both).  d_x must hold zeros and be 16-byte aligned;
// every image must have fewer than 2^31 elements.  Returns a cudaError_t.
extern "C" int dcnv3_bwd(const void* x, int x_bf16, const void* offset,
                         const void* mask, const void* grad_out, void* d_x,
                         void* d_offset, void* d_mask, int n, int h, int w,
                         int ho, int wo, int group, int gc, int kernel,
                         int stride, int pad, int dilation,
                         float offset_scale, int window, int vec, int tile_h,
                         int tile_w, void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group == 0) return static_cast<int>(cudaGetLastError());
  return x_bf16 ? launch_vec<__nv_bfloat16>(x, offset, mask, grad_out, d_x,
                                            d_offset, d_mask, p, vec, tile_h,
                                            tile_w, s)
                : launch_vec<float>(x, offset, mask, grad_out, d_x, d_offset,
                                    d_mask, p, vec, tile_h, tile_w, s);
}
