// W8A8 dense matmuls for Hopper, sm_90a.
//
// Replaces the TPU kernels of givepose_tpu/ops/quant_matmul_pallas.py:
//
//   int8_qmm      (_qmm_kernel, B4): x (M, K) bf16 or f32, quantized per
//                 row inside the kernel,
//                   xs = max(amax_row(x), 1e-8) * (1/127);  xq = round(x / xs)
//                   y  = ((f32(xq @ wq) * xs) * ws) + b;  out = act(y)   (f32)
//   int8_qmm_pre  (_qmm_pre_kernel, B5): xq (M, K) int8 and xs (M) f32
//                 given, and the epilogue rounded to bf16 before the
//                 activation, which then runs in the JAX package's mixed
//                 bf16/f32 order (act_pre below).
//
// wq arrives transposed, wt (N, K) int8 (output channel-major, the layout
// of torch's Linear.weight), with ws (N) f32 (any layer scale folded in)
// and an optional bias (N) f32 (zeros when absent, as the TPU wrapper pads
// it).  Every f32 step is rounded on its own (__fmul_rn/__fadd_rn/
// __fdiv_rn, no FMA contraction) in the order of the plain versions
// (givepose_torch/ops/quant_matmul.py: quant_matmul_plain,
// quant_matmul_pre_plain); rounding is half to even.  The int8 products
// are exact int32 sums, so a kernel and its plain version can differ only
// where tanhf or erff differs from PyTorch's.  M, N and K take any size:
// the ragged edges are masked, and zeros past K add nothing.
//
// Bound.  2*M*N*K int8 ops at 1979 TOP/s against x, wt, out (and xs) read
// or written once at 3.35 TB/s.  At the ConvNeXt-B MLP shapes of batch 32
// (1.72e10 ops, 8.7 us each): the stage-2 matmuls (8192 x 512 -> 2048 and
// 8192 x 2048 -> 512) move ~43 MB with bf16 x and out, 12.8 us, bound by
// bytes; the stage-3 ones (2048 x 1024 -> 4096, 2048 x 4096 -> 1024) ~25
// MB, 7.5 us, bound by operations.  B5 reads x at half the bytes.
//
// Design.  One block of 8 warps per BM x 128 output tile (BM 128, or 64
// when fewer than two tiles per SM would be in flight), K walked in steps
// of 64.  The TPU kernel quantizes a row tile once and keeps it across its
// sequential N grid; a CUDA grid has no order, so here every tile
// quantizes its own rows: a first pass takes each row's amax over the
// whole K row (a warp per row), and the K loop then quantizes each 64-wide
// slice of x into shared memory as it goes.  So B4 reads its x rows twice
// per column tile, N/128 times in all, from L2 (x is at most 17 MB at
// these shapes, the L2 50 MB), instead of writing a quantized copy to
// device memory.  Per K step the block stages the int8 A slice (BM x 64)
// and B slice (128 x 64) in shared memory, 64-byte rows, which makes the
// 16-byte fragment loads of a quarter-warp conflict-free; each warp runs
// mma.sync m16n8k32 on a 32 x 64 (BM 128) or 32 x 32 (BM 64) sub-tile.
// Within a 64-wide K step the K order is permuted the same way in A and B
// (each lane loads 16 contiguous bytes of a row), which leaves the exact
// sum unchanged.  No double buffering: several blocks per SM hide the
// loads.  wgmma, TMA and a pipelined shared-memory ring are later work.

#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;
constexpr int kBK = 64;

// flags: vector loads allowed (base 16-byte aligned, rows a multiple of
// 16 bytes apart) for x, and for the int8 operands wt and xq
constexpr int kVecX = 1;
constexpr int kVecQ = 2;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 0.044715 rounded to bf16, as JAX rounds the weakly typed Python constant
// to the bf16 operand's type
__device__ __forceinline__ float gelu_k_bf16() {
  return __int_as_float(0x3d370000);
}

// _apply_act on a bf16 y (held in f32) as the compiled JAX kernel
// computes it: the Python constants are weak (bf16 ops, each product
// rounded), the numpy f32 constant c and np.sqrt(2.0) strong (f32 ops);
// the sum y + cube, a bf16 op that feeds the conversion to f32 at once,
// XLA computes in f32 (apply_act_bf16 in ops/quant_matmul.py)
template <int ACT>
__device__ __forceinline__ float act_pre(float yb) {
  if (ACT == 1) {
    const float cube =
        bf(__fmul_rn(bf(__fmul_rn(bf(__fmul_rn(gelu_k_bf16(), yb)), yb)), yb));
    const float t = tanhf(__fmul_rn(gelu_c(), __fadd_rn(yb, cube)));
    return __fmul_rn(bf(__fmul_rn(0.5f, yb)), __fadd_rn(1.0f, t));
  }
  if (ACT == 2) {
    const float e = erff(__fdiv_rn(yb, sqrt2()));
    return __fmul_rn(bf(__fmul_rn(0.5f, yb)), __fadd_rn(1.0f, e));
  }
  return yb;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// amax of row r of x (K columns) by one warp
template <typename TX>
__device__ __forceinline__ float row_amax(const TX* __restrict__ xr, int k,
                                          int lane, bool vec) {
  float amax = 0.0f;
  if (vec) {
    for (int c = 8 * lane; c + 8 <= k; c += 256) {
      float v[8];
      load8(xr + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
    for (int c = (k & ~7) + lane; c < k; c += 32) {
      amax = fmaxf(amax, fabsf(to_f32(xr[c])));
    }
  } else {
    for (int c = lane; c < k; c += 32) {
      amax = fmaxf(amax, fabsf(to_f32(xr[c])));
    }
  }
  return warp_max(amax);
}

__device__ __forceinline__ uint32_t pack4(const int8_t* q) {
  return static_cast<uint32_t>(static_cast<uint8_t>(q[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(q[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[3])) << 24;
}

// 16 int8 values of a row at columns c..c+15 (zeros past k or for a row
// out of range)
__device__ __forceinline__ uint4 load_q16(const int8_t* __restrict__ row,
                                          bool in_range, int c, int k,
                                          bool vec) {
  if (!in_range) return make_uint4(0u, 0u, 0u, 0u);
  if (vec && c + 16 <= k) {
    return __ldg(reinterpret_cast<const uint4*>(row + c));
  }
  int8_t q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = c + i < k ? row[c + i] : 0;
  return make_uint4(pack4(q), pack4(q + 4), pack4(q + 8), pack4(q + 12));
}

// 16 values of x's row at columns c..c+15 quantized with scale
template <typename TX>
__device__ __forceinline__ uint4 quantize16(const TX* __restrict__ row,
                                            bool in_range, int c, int k,
                                            float scale, bool vec) {
  if (!in_range) return make_uint4(0u, 0u, 0u, 0u);
  float v[16];
  if (vec && c + 16 <= k) {
    load8(row + c, v);
    load8(row + c + 8, v + 8);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = c + i < k ? to_f32(row[c + i]) : 0.0f;
  }
  int8_t q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = quantize(v[i], scale);
  return make_uint4(pack4(q), pack4(q + 4), pack4(q + 8), pack4(q + 12));
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// TX: x's type (int8_t when PRE); TO: output type; BM rows per tile
template <typename TX, typename TO, int BM, int ACT, bool PRE>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const TX* __restrict__ x, const float* __restrict__ xs_in,
           const int8_t* __restrict__ wt, const float* __restrict__ ws,
           const float* __restrict__ bias, TO* __restrict__ out, int m,
           int n, int k, int flags) {
  constexpr int WM = BM / 32;          // warps along M, 32 rows each
  constexpr int WN = kWarps / WM;      // warps along N
  constexpr int NT = kBN / WN / 8;     // 8-column mma tiles per warp
  __shared__ __align__(16) int8_t as[BM * kBK];
  __shared__ __align__(16) int8_t bs[kBN * kBK];
  __shared__ float xs[BM];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * kBN;
  const bool vec_x = flags & kVecX, vec_q = flags & kVecQ;

  // 1. the tile's row scales (rows past m: 1, their values zeros)
  if constexpr (PRE) {
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      xs[i] = row0 + i < m ? xs_in[row0 + i] : 1.0f;
    }
  } else {
    for (int i = warp; i < BM; i += kWarps) {
      const long long r = row0 + i;
      const float amax = r < m ? row_amax(x + r * k, k, lane, vec_x) : 0.0f;
      if (lane == 0) xs[i] = r < m ? row_scale(amax) : 1.0f;
    }
  }
  __syncthreads();

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][j][v] = 0;
    }
  }
  const int wm = warp % WM, wn = warp / WM;

  // 2. K in steps of 64: stage int8 A and B slices, then the products
  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int idx = threadIdx.x; idx < BM * 4; idx += kThreads) {
      const int i = idx >> 2, c = (idx & 3) * 16;
      const long long r = row0 + i;
      uint4 q;
      if constexpr (PRE) {
        q = load_q16(reinterpret_cast<const int8_t*>(x) + r * k, r < m,
                     k0 + c, k, vec_q);
      } else {
        q = quantize16(x + r * k, r < m, k0 + c, k, xs[i], vec_x);
      }
      *reinterpret_cast<uint4*>(as + i * kBK + c) = q;
    }
    for (int idx = threadIdx.x; idx < kBN * 4; idx += kThreads) {
      const int j = idx >> 2, c = (idx & 3) * 16;
      const int col = col0 + j;
      *reinterpret_cast<uint4*>(bs + j * kBK + c) = load_q16(
          wt + static_cast<long long>(col) * k, col < n, k0 + c, k, vec_q);
    }
    __syncthreads();
    uint4 a[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* ar = as + (wm * 32 + mt * 16 + g) * kBK + 16 * t;
      a[mt][0] = *reinterpret_cast<const uint4*>(ar);
      a[mt][1] = *reinterpret_cast<const uint4*>(ar + 8 * kBK);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          bs + (wn * (kBN / WN) + 8 * j + g) * kBK + 16 * t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][j], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y,
               w.x, w.y);
        mma_s8(acc[mt][j], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w,
               w.z, w.w);
      }
    }
    __syncthreads();
  }

  // 3. epilogue: lane (g, t) holds rows g, g+8 and columns 2t, 2t+1 of
  // each 16 x 8 tile
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = wm * 32 + mt * 16 + g + 8 * h;
        const long long r = row0 + i;
        const int col = col0 + wn * (kBN / WN) + 8 * j + 2 * t;
        if (r >= m || col >= n) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = col + e < n ? col + e : col;
          float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mt][j][2 * h + e]), xs[i]),
              ws[cc]);
          v = __fadd_rn(v, bias != nullptr ? bias[cc] : 0.0f);
          y[e] = PRE ? act_pre<ACT>(bf(v)) : act_fn<ACT>(v);
        }
        TO* o = out + r * n + col;
        if (pairs) {
          store2<TO>(o, y[0], y[1]);
        } else {
          o[0] = from_f32<TO>(y[0]);
          if (col + 1 < n) o[1] = from_f32<TO>(y[1]);
        }
      }
    }
  }
}

template <typename TX, typename TO, int BM, int ACT, bool PRE>
int launch(const void* x, const void* xs, const void* wt, const void* ws,
           const void* bias, void* out, int m, int n, int k, int flags,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  qmm_kernel<TX, TO, BM, ACT, PRE><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wt), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<TO*>(out), m, n, k,
      flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TO, bool PRE>
int dispatch(int act, const void* x, const void* xs, const void* wt,
             const void* ws, const void* bias, void* out, int m, int n,
             int k, int flags, cudaStream_t s) {
  // BM 128 when the grid holds at least two tiles per SM of an H100
  const bool big = static_cast<long long>((m + 127) / 128) *
                       ((n + kBN - 1) / kBN) >= 2 * 132;
#define QMM_CASE(A)                                                        \
  case A:                                                                  \
    return big ? launch<TX, TO, 128, A, PRE>(x, xs, wt, ws, bias, out, m,  \
                                             n, k, flags, s)               \
               : launch<TX, TO, 64, A, PRE>(x, xs, wt, ws, bias, out, m,   \
                                            n, k, flags, s);
  switch (act) {
    QMM_CASE(0)
    QMM_CASE(1)
    QMM_CASE(2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QMM_CASE
}

bool bad_shape(int m, int n, int k) {
  return m < 0 || n <= 0 || k <= 0 || (n + kBN - 1) / kBN > 65535;
}

}  // namespace

// Plain-C entry points, loaded with ctypes.  Pointers: x (M, K) (bf16 if
// x_bf16, else f32), wt (N, K) int8, ws (N) f32, bias (N) f32 or null, out
// (M, N) (bf16 if out_bf16, else f32); int8_qmm_pre takes xq (M, K) int8
// and xs (M) f32 instead of x.  act 0 none, 1 tanh GELU, 2 erf GELU;
// flags 1: x may be read 16 bytes at a time, 2: wt and xq may.  Each
// returns a CUDA error code: that of the launch (cudaGetLastError), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int int8_qmm(const void* x, int x_bf16, const void* wt,
                        const void* ws, const void* bias, void* out,
                        int out_bf16, int m, int n, int k, int act,
                        int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (x_bf16) {
    return out_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16, false>(
                          act, x, nullptr, wt, ws, bias, out, m, n, k, flags,
                          s)
                    : dispatch<__nv_bfloat16, float, false>(
                          act, x, nullptr, wt, ws, bias, out, m, n, k, flags,
                          s);
  }
  return out_bf16 ? dispatch<float, __nv_bfloat16, false>(
                        act, x, nullptr, wt, ws, bias, out, m, n, k, flags, s)
                  : dispatch<float, float, false>(act, x, nullptr, wt, ws,
                                                  bias, out, m, n, k, flags,
                                                  s);
}

extern "C" int int8_qmm_pre(const void* xq, const void* xs, const void* wt,
                            const void* ws, const void* bias, void* out,
                            int out_bf16, int m, int n, int k, int act,
                            int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  return out_bf16 ? dispatch<int8_t, __nv_bfloat16, true>(
                        act, xq, xs, wt, ws, bias, out, m, n, k, flags, s)
                  : dispatch<int8_t, float, true>(act, xq, xs, wt, ws, bias,
                                                  out, m, n, k, flags, s);
}
