// DCNv3 forward (unbounded offsets) for Hopper, sm_90a.
//
// Replaces the TPU kernel givepose_tpu/ops/dcnv3_pallas.py:_dcnv3_kernel.
// That kernel decomposes the bilinear gather into two-hot matmuls because
// Mosaic cannot gather; on the GPU the natural form is a pointwise gather
// (the DCNv3 im2col design), which is what this file does.
//
// Contract (same as givepose_torch/ops/dcnv3.py:dcnv3_core, window 0):
//   x      (N, H, W, G*gc)     bf16 or f32, channels-last, unpadded
//   offset (N, Ho, Wo, G*P*2)  f32, last dim ordered (g, p, xy)
//   mask   (N, Ho, Wo, G*P)    f32, softmaxed over P
//   out    (N, Ho, Wo, G*gc)   f32
// Sampling positions follow dcnv3_sampling_locations: reference point
// half + 0.5 + stride*o, dilation grid with x slow and y fast, offsets
// times offset_scale, then -0.5 (grid_sample align_corners=False), in
// PyTorch's f32 order (dcnv3_common.cuh, shared with the backward).
// Coordinates live in padded-input space; the pad band is read as zeros
// without materialising the padded tensor.
//
// Bound: memory.  Each (pixel, group, tap, channel) does about 10 flop
// against 4 corner reads, so the kernel is limited by the bytes it moves
// (x once, offset, mask, out) at 3.35 TB/s.  Design: one warp per
// (n, output pixel, group); each lane owns VEC adjacent channels, so each
// of the 4 bilinear corners of a tap is one coalesced load of
// 32*VEC*sizeof(T) bytes (128 B for gc=64 in bf16).  Taking x in bf16
// halves the dominant read.  The sampling location is computed by every
// lane (uniform across the warp, so the corner checks do not diverge).

#include "dcnv3_common.cuh"

#include <stdint.h>

namespace {

using dcnv3::Corners;
using dcnv3::Params;
using dcnv3::load_vec;
using dcnv3::tap_corners;

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
dcnv3_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                 const float* __restrict__ mask, float* __restrict__ out,
                 Params p) {
  const long long item =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_items =
      static_cast<long long>(p.n) * p.ho * p.wo * p.group;
  if (item >= n_items) return;

  const int g = static_cast<int>(item % p.group);
  const long long pix = item / p.group;           // n*Ho*Wo + oh*Wo + ow
  const int ow = static_cast<int>(pix % p.wo);
  const int oh = static_cast<int>((pix / p.wo) % p.ho);
  const int n = static_cast<int>(pix / (static_cast<long long>(p.wo) * p.ho));

  const int taps = p.kernel * p.kernel;
  const int c_total = p.group * p.gc;
  const float* off = offset + pix * (2LL * p.group * taps) + 2LL * g * taps;
  const float* msk = mask + pix * (static_cast<long long>(p.group) * taps) +
                     static_cast<long long>(g) * taps;
  const T* xg = x + static_cast<long long>(n) * p.h * p.w * c_total +
                static_cast<long long>(g) * p.gc;
  float* og = out + pix * c_total + static_cast<long long>(g) * p.gc;

  for (int c0 = 0; c0 < p.gc; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < p.gc;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

    for (int i = 0; i < p.kernel; ++i) {          // x varies slowly
      for (int j = 0; j < p.kernel; ++j) {        // y varies fast
        const int tap = i * p.kernel + j;
        const Corners k =
            tap_corners(p, oh, ow, i, j, off[2 * tap], off[2 * tap + 1]);
        const float m = msk[tap];
        const int x0 = k.x0, y0 = k.y0;
        const bool vx0 = k.vx0, vx1 = k.vx1, vy0 = k.vy0, vy1 = k.vy1;
        const float fx = k.fx, fy = k.fy;
        const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
        const float w01 = (1.0f - fx) * fy, w11 = fx * fy;

        float tap_sum[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) tap_sum[v] = 0.0f;
        if (active) {
          float val[VEC];
          const long long row0 = static_cast<long long>(y0) * p.w;
          const long long row1 = row0 + p.w;
          if (vy0 && vx0) {
            load_vec(xg + (row0 + x0) * c_total + c, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w00;
          }
          if (vy0 && vx1) {
            load_vec(xg + (row0 + x0 + 1) * c_total + c, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w10;
          }
          if (vy1 && vx0) {
            load_vec(xg + (row1 + x0) * c_total + c, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w01;
          }
          if (vy1 && vx1) {
            load_vec(xg + (row1 + x0 + 1) * c_total + c, val, VEC);
#pragma unroll
            for (int v = 0; v < VEC; ++v) tap_sum[v] += val[v] * w11;
          }
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += tap_sum[v] * m;
      }
    }
    if (active) {
      if (VEC == 2) {
        *reinterpret_cast<float2*>(og + c) = make_float2(acc[0], acc[VEC - 1]);
      } else {
        og[c] = acc[0];
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* offset, const void* mask, void* out,
            const Params& p, cudaStream_t stream) {
  const long long warps = static_cast<long long>(p.n) * p.ho * p.wo * p.group;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  dcnv3_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(out), p);
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); vec is 2 when every lane may load two channels at
// once (gc even and x aligned), else 1.  Returns cudaGetLastError().
extern "C" int dcnv3_fwd(const void* x, int x_bf16, const void* offset,
                         const void* mask, void* out, int n, int h, int w,
                         int ho, int wo, int group, int gc, int kernel,
                         int stride, int pad, int dilation,
                         float offset_scale, int vec, void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group > 0) {
    if (x_bf16) {
      if (vec == 2) launch<__nv_bfloat16, 2>(x, offset, mask, out, p, s);
      else launch<__nv_bfloat16, 1>(x, offset, mask, out, p, s);
    } else {
      if (vec == 2) launch<float, 2>(x, offset, mask, out, p, s);
      else launch<float, 1>(x, offset, mask, out, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
