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
// Bound: memory.  About 10 flop per (pixel, group, tap, channel) against
// x, offset and mask read once and out written once: at batch 32 the
// first MAPEncoder layer moves ~115 MB, ~34 us at 3.35 TB/s.
//
// What held the first design back (one warp per (pixel, group), 2
// channels a lane; PERF.md, tools/dcnv3_breakdown.py): not the bytes but
// the instructions.  Every lane redid the whole per-tap cost for its 2
// channels: the location (~100 of its 364 us at the three layers), four
// validity branches (~76 us), and 4-byte loads (without any corner load
// the kernel still took 193 us).  So this design spreads that cost:
//   - a block walks a tile of tile_h x tile_w output pixels of one image
//     (chosen by the wrapper, ops/dcnv3_cuda.py dcn_tile), so that
//     neighbouring pixels' corners meet in L1;
//   - the block first computes each (pixel, group, tap) of the tile once,
//     cooperatively, with the shared tap_corners (bit-exact with the plain
//     version), and stores the four corners' offsets within the image
//     (32-bit) and weights times the mask in shared memory (fill_taps);
//   - then one warp takes one output pixel, all its groups: each lane owns
//     VEC adjacent channels (8 for gc 64: 16-byte loads of bf16), so a
//     tap costs a lane two 16-byte shared loads and four independent
//     corner loads, no branch (a corner outside the image is read in the
//     image and zeroed by a select), unrolled over the 9 taps so that many
//     loads are in flight;
//   - the lane's 8 f32 results leave in two 16-byte stores.
// Narrower vectors (4, 2, 1 channels) serve a gc or an alignment that 8
// does not divide; a warp loops over channel chunks when the pixel has
// more than 32 * VEC channels.
//
// Where it stands (tools/dcnv3_breakdown.py, NVIDIA H100 80GB HBM3 at
// 700 W, the three MAPEncoder layers at batch 32): 128 us against 45 us
// of bytes (the first design: 364 us).  The corner loads set the pace:
// without them it takes 52 us; the location arithmetic, now once per
// (pixel, group, tap), costs ~12 us.  The last layer (8 x 8 outputs, 64
// blocks) fills half the card.  With a window of 4 the same body takes
// the same time, against 352 us for dcnv3_win_fwd.cu.

#include "dcnv3_common.cuh"

#include <stdint.h>

namespace {

using dcnv3::Params;
using dcnv3::Tap;
using dcnv3::fill_taps;
using dcnv3::load_n;
using dcnv3::tap_safe;
using dcnv3::tap_valid;

constexpr int kThreads = 256;

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

// KK: kernel*kernel when fixed at compile time (9), else 0
template <typename T, int VEC, int KK>
__global__ void __launch_bounds__(kThreads, 2)
dcnv3_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                 const float* __restrict__ mask, float* __restrict__ out,
                 Params p, int tile_h, int tile_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* taps = reinterpret_cast<Tap*>(smem);
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * tile_h, ow0 = blockIdx.x * tile_w;
  fill_taps(p, offset, mask, n, oh0, ow0, tile_h, tile_w, taps);
  __syncthreads();

  const int K = KK > 0 ? KK : p.kernel * p.kernel;
  const int c_total = p.group * p.gc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xi = x + static_cast<long long>(n) * p.h * p.w * c_total;
  for (int pix = warp; pix < tile_h * tile_w; pix += kThreads / 32) {
    const int oh = oh0 + pix / tile_w, ow = ow0 + pix % tile_w;
    if (oh >= p.ho || ow >= p.wo) continue;           // whole warp
    float* o = out + ((static_cast<long long>(n) * p.ho + oh) * p.wo + ow) *
                         c_total;
    for (int c = lane * VEC; c < c_total; c += 32 * VEC) {
      const Tap* t = taps + (pix * p.group + c / p.gc) * K;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int tap = 0; tap < (KK > 0 ? KK : K); ++tap) {
        const Tap e = t[tap];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float val[VEC];
          load_n<VEC>(xi + tap_safe(e.idx[k]) + c, val, tap_valid(e.idx[k]));
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += e.wgt[k] * val[v];
        }
      }
      store_n<VEC>(o + c, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* offset, const void* mask, void* out,
           const Params& p, int tile_h, int tile_w, cudaStream_t stream) {
  const size_t smem =
      dcnv3::tile_smem_bytes(tile_h, tile_w, p.group, p.kernel, false);
  const dim3 grid((p.wo + tile_w - 1) / tile_w, (p.ho + tile_h - 1) / tile_h,
                  p.n);
  auto kernel = p.kernel == 3 ? dcnv3_fwd_kernel<T, VEC, 9>
                              : dcnv3_fwd_kernel<T, VEC, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(out), p, tile_h,
      tile_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const void* x, const void* offset, const void* mask,
               void* out, const Params& p, int vec, int tile_h, int tile_w,
               cudaStream_t s) {
  switch (vec) {
    case 8: return launch<T, 8>(x, offset, mask, out, p, tile_h, tile_w, s);
    case 4: return launch<T, 4>(x, offset, mask, out, p, tile_h, tile_w, s);
    case 2: return launch<T, 2>(x, offset, mask, out, p, tile_h, tile_w, s);
    default: return launch<T, 1>(x, offset, mask, out, p, tile_h, tile_w, s);
  }
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  x_bf16 selects the input type
// (1: bf16, 0: f32); vec (8, 4, 2 or 1) is the channels a lane moves at
// once: it divides gc, and x is aligned to min(vec * sizeof(T), 16)
// bytes; tile_h x tile_w output pixels per block, whose taps fit in shared
// memory (the wrapper chooses both).  Every image must have fewer than
// 2^31 elements.  Returns a cudaError_t.
extern "C" int dcnv3_fwd(const void* x, int x_bf16, const void* offset,
                         const void* mask, void* out, int n, int h, int w,
                         int ho, int wo, int group, int gc, int kernel,
                         int stride, int pad, int dilation,
                         float offset_scale, int vec, int tile_h, int tile_w,
                         void* stream) {
  Params p{n, h, w, ho, wo, group, gc, kernel, stride, pad, dilation,
           offset_scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * ho * wo * group == 0) return static_cast<int>(cudaGetLastError());
  return x_bf16 ? launch_vec<__nv_bfloat16>(x, offset, mask, out, p, vec,
                                            tile_h, tile_w, s)
                : launch_vec<float>(x, offset, mask, out, p, vec, tile_h,
                                    tile_w, s);
}
