// Shared by dcnv3_fwd.cu, dcnv3_win_fwd.cu and dcnv3_bwd.cu: shapes,
// vector loads, the sampling location and bilinear corners of one tap,
// and (for the forward and the backward) a tile's taps in shared memory.
//
// The location must match givepose_torch/ops/dcnv3.py bit for bit: the
// backward's gradient with respect to the location jumps where floor()
// changes, so a location one ulp off can pick the other neighbour.  It is
// computed in PyTorch's f32 order,
//     ((ref + grid * scale) + offset * scale) - 0.5,
// with every operation rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn
// keep nvcc from contracting a product and a sum into one FMA).
//
// With a window (> 0) the location is then clamped to the query's centre
// +- window, as clamp_to_window: centre = half + stride*o, an exact
// integer in f32, so centre - window and centre + window are exact too.
// The clamp's gradient is jnp.clip's: 1 strictly inside, 0.5 on either
// bound, 0 outside (Corners::gx, gy; the backward scales d_offset by it).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace dcnv3 {

struct Params {
  int n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation;
  float offset_scale;
  int window;  // 0: unbounded offsets
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
// (x0, y0), fractional parts, which of the two columns and rows lie
// inside the image (a corner in the pad band or beyond reads as zero),
// and the window clamp's gradient along x and y (1 without a window).
struct Corners {
  int x0, y0;
  float fx, fy;
  bool vx0, vx1, vy0, vy1;
  float gx, gy;
};

// min(max(v, lo), hi) with NaN passed through, as torch.clamp; *grad is
// the gradient of jnp.clip at v.
__device__ __forceinline__ float clip(float v, float lo, float hi,
                                      float* grad) {
  *grad = (v > lo && v < hi) ? 1.0f : ((v == lo || v == hi) ? 0.5f : 0.0f);
  return v < lo ? lo : (v > hi ? hi : v);
}

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
  float lx = __fsub_rn(
      __fadd_rn(__fadd_rn(ref_x, __fmul_rn(gx, s)), __fmul_rn(off_x, s)),
      0.5f);
  float ly = __fsub_rn(
      __fadd_rn(__fadd_rn(ref_y, __fmul_rn(gy, s)), __fmul_rn(off_y, s)),
      0.5f);
  Corners c;
  c.gx = 1.0f;
  c.gy = 1.0f;
  if (p.window > 0) {
    const float cx = static_cast<float>(half + p.stride * ow);
    const float cy = static_cast<float>(half + p.stride * oh);
    const float win = static_cast<float>(p.window);
    lx = clip(lx, cx - win, cx + win, &c.gx);
    ly = clip(ly, cy - win, cy + win, &c.gy);
  }

  const float x0f = floorf(lx), y0f = floorf(ly);
  // padded-space corner index range that can land inside the image;
  // clamping keeps far-away corners invalid and the int cast safe
  const float x_hi = static_cast<float>(p.w + 2 * p.pad + 1);
  const float y_hi = static_cast<float>(p.h + 2 * p.pad + 1);
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

// ---- the forward and the backward: VEC channels a lane, taps in shared
// memory ----

// VEC adjacent channels as f32, zeros where !valid (a corner outside the
// image reads as the pad's zero, whatever the pixel it was pointed at
// holds).  bf16 x: one 16-byte load for 8 channels; f32 x: two.
template <int VEC>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* v,
                                       bool valid) {
  if constexpr (VEC == 8 || VEC == 4 || VEC == 2) {
    constexpr int W = VEC / 2;                   // 32-bit words
    unsigned u[W];
    if constexpr (W == 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      u[0] = t.x; u[1] = t.y; u[2] = t.z; u[3] = t.w;
    } else if constexpr (W == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      u[0] = t.x; u[1] = t.y;
    } else {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const unsigned w = valid ? u[i] : 0u;
      v[2 * i] = __uint_as_float(w << 16);
      v[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  } else {
    v[0] = valid ? __bfloat162float(*p) : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void load_n(const float* p, float* v, bool valid) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = valid ? t.x : 0.0f;
      v[i + 1] = valid ? t.y : 0.0f;
      v[i + 2] = valid ? t.z : 0.0f;
      v[i + 3] = valid ? t.w : 0.0f;
    }
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = valid ? t.x : 0.0f;
    v[1] = valid ? t.y : 0.0f;
  } else {
    v[0] = valid ? *p : 0.0f;
  }
}

// One (pixel, group, tap) of a tile: the element offset within the image
// of each bilinear corner (00, 10, 01, 11: x then y), and its weight times
// the mask.  A corner outside the image has weight 0 and the offset
// -(o + 1), o that of the nearest pixel inside it, so a load stays in the
// image and near its neighbours' (and reads as zero, load_n's valid).
struct Tap {
  int idx[4];
  float wgt[4];
};

__device__ __forceinline__ bool tap_valid(int o) { return o >= 0; }
__device__ __forceinline__ int tap_safe(int o) { return o >= 0 ? o : -o - 1; }

// The output pixels of a tile, row-major tile_h x tile_w from (oh0, ow0).
// Fills taps[(pixel * group + g) * K + tap] for each of them, in the
// order of offset's last dimension, so consecutive threads read
// consecutive offsets and masks.  Pixels outside the output are skipped.
__device__ __forceinline__ void fill_taps(const Params& p,
                                          const float* __restrict__ offset,
                                          const float* __restrict__ mask,
                                          int n, int oh0, int ow0,
                                          int tile_h, int tile_w, Tap* taps) {
  const int K = p.kernel * p.kernel;
  const int gk = p.group * K;
  const int c_total = p.group * p.gc;
  for (int e = threadIdx.x; e < tile_h * tile_w * gk; e += blockDim.x) {
    const int pix = e / gk;
    const int r = e - pix * gk;
    const int tap = r % K;
    const int oh = oh0 + pix / tile_w, ow = ow0 + pix % tile_w;
    if (oh >= p.ho || ow >= p.wo) continue;
    const long long at =
        ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) * gk + r;
    const Corners c = tap_corners(p, oh, ow, tap / p.kernel, tap % p.kernel,
                                  offset[2 * at], offset[2 * at + 1]);
    const float m = mask[at];
    const float fx = c.fx, fy = c.fy;
    const float w[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                        (1.0f - fx) * fy, fx * fy};
    const bool vx[2] = {c.vx0, c.vx1}, vy[2] = {c.vy0, c.vy1};
    Tap t;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xk = c.x0 + (k & 1), yk = c.y0 + (k >> 1);
      const int xs = min(max(xk, 0), p.w - 1), ys = min(max(yk, 0), p.h - 1);
      const int o = (ys * p.w + xs) * c_total;
      const bool ok = vx[k & 1] && vy[k >> 1];
      t.idx[k] = ok ? o : -o - 1;
      t.wgt[k] = ok ? m * w[k] : 0.0f;
    }
    taps[e] = t;
  }
}

// Shared memory of a tile: its taps, then (backward) four f32 dots each.
__host__ __device__ inline size_t tile_smem_bytes(int tile_h, int tile_w,
                                                  int group, int kernel,
                                                  bool backward) {
  const size_t entries = static_cast<size_t>(tile_h) * tile_w * group *
                         kernel * kernel;
  return entries * (sizeof(Tap) + (backward ? 4 * sizeof(float) : 0));
}

}  // namespace dcnv3
