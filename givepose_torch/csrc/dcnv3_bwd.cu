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
// taken at the clamped location, as in the windowed forward.
//
// Design: one warp per (n, output pixel, group), each lane owning VEC
// adjacent channels, as the forward.  Per tap the warp recomputes the
// location with the forward's code (dcnv3_common.cuh), loads the four
// corners of x, and forms each corner's dot product with grad_out; a warp
// shuffle reduces the four dots, from which lane 0 writes d_mask and
// d_offset (with w_k the bilinear weights, m the mask):
//   d_mask   = sum_k w_k dot_k
//   d_fx     = m ((1-fy)(dot_10 - dot_00) + fy (dot_11 - dot_01))
//   d_fy     = m ((1-fx)(dot_01 - dot_00) + fx (dot_11 - dot_10))
// and every lane scatters m * w_k * grad_out into d_x with f32 atomics
// (float2 atomics for VEC 2).  The atomics make d_x nondeterministic in
// its last bits: the order in which the ~9 contributions to one input
// value land changes from run to run.
//
// Bound: memory.  Per (pixel, group, tap, channel): 4 corner FMAs for the
// dots, 4 products and 4 atomic adds for the scatter (~16 flop) against
// x, grad_out, offset, mask read once and d_x, d_offset, d_mask written
// once; at training batch 48 the first MAPEncoder layer moves ~395 MB,
// ~118 us at 3.35 TB/s.  Left for later work: the ~9 atomics per input
// value go to L2 (a per-block tile of d_x in shared memory, or a gather
// formulation over the inverse map, would cut them), and each input pixel
// is read ~9 times, as in the forward.

#include "dcnv3_common.cuh"

namespace {

using dcnv3::Corners;
using dcnv3::Params;
using dcnv3::load_vec;
using dcnv3::tap_corners;

template <int VEC>
__device__ __forceinline__ void scatter(float* dst, const float* go,
                                        float scale) {
  if (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst),
              make_float2(go[0] * scale, go[VEC - 1] * scale));
  } else {
    atomicAdd(dst, go[0] * scale);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
dcnv3_bwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                 const float* __restrict__ mask,
                 const float* __restrict__ grad_out, float* __restrict__ d_x,
                 float* __restrict__ d_offset, float* __restrict__ d_mask,
                 Params p) {
  const long long item =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_items =
      static_cast<long long>(p.n) * p.ho * p.wo * p.group;
  // whole warps leave together, so the shuffles below see all 32 lanes
  if (item >= n_items) return;

  const int g = static_cast<int>(item % p.group);
  const long long pix = item / p.group;           // n*Ho*Wo + oh*Wo + ow
  const int ow = static_cast<int>(pix % p.wo);
  const int oh = static_cast<int>((pix / p.wo) % p.ho);
  const int n = static_cast<int>(pix / (static_cast<long long>(p.wo) * p.ho));

  const int taps = p.kernel * p.kernel;
  const int c_total = p.group * p.gc;
  const long long off_base = pix * (2LL * p.group * taps) + 2LL * g * taps;
  const long long msk_base = pix * (static_cast<long long>(p.group) * taps) +
                             static_cast<long long>(g) * taps;
  const long long img_base = static_cast<long long>(n) * p.h * p.w * c_total +
                             static_cast<long long>(g) * p.gc;
  const T* xg = x + img_base;
  float* dxg = d_x + img_base;
  const float* gog =
      grad_out + pix * c_total + static_cast<long long>(g) * p.gc;

  for (int i = 0; i < p.kernel; ++i) {            // x varies slowly
    for (int j = 0; j < p.kernel; ++j) {          // y varies fast
      const int tap = i * p.kernel + j;
      const Corners k =
          tap_corners(p, oh, ow, i, j, offset[off_base + 2 * tap],
                      offset[off_base + 2 * tap + 1]);
      const float m = mask[msk_base + tap];
      const float fx = k.fx, fy = k.fy;
      const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
      const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
      const bool v00 = k.vy0 && k.vx0, v10 = k.vy0 && k.vx1;
      const bool v01 = k.vy1 && k.vx0, v11 = k.vy1 && k.vx1;
      const long long at00 = (static_cast<long long>(k.y0) * p.w + k.x0) *
                             c_total;
      const long long at10 = at00 + c_total;
      const long long at01 = at00 + static_cast<long long>(p.w) * c_total;
      const long long at11 = at01 + c_total;

      float dot00 = 0.0f, dot10 = 0.0f, dot01 = 0.0f, dot11 = 0.0f;
      for (int c0 = 0; c0 < p.gc; c0 += 32 * VEC) {
        const int c = c0 + lane * VEC;
        if (c >= p.gc) continue;
        float go[VEC], val[VEC];
        load_vec(gog + c, go, VEC);
        if (v00) {
          load_vec(xg + at00 + c, val, VEC);
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot00 += go[v] * val[v];
          scatter<VEC>(dxg + at00 + c, go, m * w00);
        }
        if (v10) {
          load_vec(xg + at10 + c, val, VEC);
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot10 += go[v] * val[v];
          scatter<VEC>(dxg + at10 + c, go, m * w10);
        }
        if (v01) {
          load_vec(xg + at01 + c, val, VEC);
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot01 += go[v] * val[v];
          scatter<VEC>(dxg + at01 + c, go, m * w01);
        }
        if (v11) {
          load_vec(xg + at11 + c, val, VEC);
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot11 += go[v] * val[v];
          scatter<VEC>(dxg + at11 + c, go, m * w11);
        }
      }
      dot00 = warp_sum(dot00);
      dot10 = warp_sum(dot10);
      dot01 = warp_sum(dot01);
      dot11 = warp_sum(dot11);
      if (lane == 0) {
        d_mask[msk_base + tap] =
            w00 * dot00 + w10 * dot10 + w01 * dot01 + w11 * dot11;
        float d_fx =
            m * ((1.0f - fy) * (dot10 - dot00) + fy * (dot11 - dot01));
        float d_fy =
            m * ((1.0f - fx) * (dot01 - dot00) + fx * (dot11 - dot10));
        // a held sample passes no gradient, not even a NaN one
        d_fx = k.gx == 0.0f ? 0.0f : d_fx * k.gx;
        d_fy = k.gy == 0.0f ? 0.0f : d_fy * k.gy;
        *reinterpret_cast<float2*>(d_offset + off_base + 2 * tap) =
            make_float2(d_fx * p.offset_scale, d_fy * p.offset_scale);
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* offset, const void* mask,
            const void* grad_out, void* d_x, void* d_offset, void* d_mask,
            const Params& p, cudaStream_t stream) {
  const long long warps = static_cast<long long>(p.n) * p.ho * p.wo * p.group;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  dcnv3_bwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<const float*>(grad_out),
      static_cast<float*>(d_x), static_cast<float*>(d_offset),
      static_cast<float*>(d_mask), p);
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); vec is 2 when every lane may move two channels at
// once (gc even, x and grad_out aligned), else 1; window 0 means
// unbounded offsets.  d_x must hold zeros.
// Returns cudaGetLastError().
extern "C" int dcnv3_bwd(const void* x, int x_bf16, const void* offset,
                         const void* mask, const void* grad_out, void* d_x,
                         void* d_offset, void* d_mask, int n, int h, int w,
                         int ho, int wo, int group, int gc, int kernel,
                         int stride, int pad, int dilation,
                         float offset_scale, int window, int vec,
                         void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group > 0) {
    if (x_bf16) {
      if (vec == 2)
        launch<__nv_bfloat16, 2>(x, offset, mask, grad_out, d_x, d_offset,
                                 d_mask, p, s);
      else
        launch<__nv_bfloat16, 1>(x, offset, mask, grad_out, d_x, d_offset,
                                 d_mask, p, s);
    } else {
      if (vec == 2)
        launch<float, 2>(x, offset, mask, grad_out, d_x, d_offset, d_mask, p,
                         s);
      else
        launch<float, 1>(x, offset, mask, grad_out, d_x, d_offset, d_mask, p,
                         s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
