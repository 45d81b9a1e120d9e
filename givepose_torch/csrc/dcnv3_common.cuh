// Shared by dcnv3_fwd.cu and dcnv3_bwd.cu: shapes, vector loads, and the
// sampling location and bilinear corners of one tap.
//
// The location must match givepose_torch/ops/dcnv3.py bit for bit: the
// backward's gradient with respect to the location jumps where floor()
// changes, so a location one ulp off can pick the other neighbour.  It is
// computed in PyTorch's f32 order,
//     ((ref + grid * scale) + offset * scale) - 0.5,
// with every operation rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn
// keep nvcc from contracting a product and a sum into one FMA).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace dcnv3 {

struct Params {
  int n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation;
  float offset_scale;
};

__device__ __forceinline__ void load_vec(const float* p, float* v, int vec) {
  if (vec == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v,
                                         int vec) {
  if (vec == 2) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// One tap's bilinear footprint in the unpadded input: top-left corner
// (x0, y0), fractional parts, and which of the two columns and rows lie
// inside the image (a corner in the pad band or beyond reads as zero).
struct Corners {
  int x0, y0;
  float fx, fy;
  bool vx0, vx1, vy0, vy1;
};

// Tap (i, j) of output pixel (oh, ow); i walks x (slow), j walks y (fast),
// as the dilation grid of dcnv3_sampling_locations.
__device__ __forceinline__ Corners tap_corners(const Params& p, int oh,
                                               int ow, int i, int j,
                                               float off_x, float off_y) {
  const int half = (p.dilation * (p.kernel - 1)) / 2;
  const float s = p.offset_scale;
  const float ref_x = __fadd_rn(half + 0.5f, static_cast<float>(p.stride * ow));
  const float ref_y = __fadd_rn(half + 0.5f, static_cast<float>(p.stride * oh));
  const float gx = static_cast<float>(-half + i * p.dilation);
  const float gy = static_cast<float>(-half + j * p.dilation);
  const float lx = __fsub_rn(
      __fadd_rn(__fadd_rn(ref_x, __fmul_rn(gx, s)), __fmul_rn(off_x, s)),
      0.5f);
  const float ly = __fsub_rn(
      __fadd_rn(__fadd_rn(ref_y, __fmul_rn(gy, s)), __fmul_rn(off_y, s)),
      0.5f);

  const float x0f = floorf(lx), y0f = floorf(ly);
  // padded-space corner index range that can land inside the image;
  // clamping keeps far-away corners invalid and the int cast safe
  const float x_hi = static_cast<float>(p.w + 2 * p.pad + 1);
  const float y_hi = static_cast<float>(p.h + 2 * p.pad + 1);
  Corners c;
  c.fx = __fsub_rn(lx, x0f);
  c.fy = __fsub_rn(ly, y0f);
  c.x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f), x_hi)) - p.pad;
  c.y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f), y_hi)) - p.pad;
  c.vx0 = c.x0 >= 0 && c.x0 < p.w;
  c.vx1 = c.x0 + 1 >= 0 && c.x0 + 1 < p.w;
  c.vy0 = c.y0 >= 0 && c.y0 < p.h;
  c.vy1 = c.y0 + 1 >= 0 && c.y0 + 1 < p.h;
  return c;
}

}  // namespace dcnv3
