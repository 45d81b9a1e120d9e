// Fused W8A8 ConvNeXt MLP for Hopper, sm_90a.
//
// Replaces the TPU kernels givepose_tpu/ops/quant_matmul_pallas.py:
// _mlp_kernel and _mlp_ln_kernel (both through _mlp_core), the whole MLP
// tail of a ConvNeXt block in int8:
//
//   [y = ((y - mu) * rsig) * ln_g + ln_b]            (LN prologue, opt.)
//   xs = max(amax_row(y), 1e-8) * (1/127);   yq = round(y / xs)   (int8)
//   h  = ((f32(yq @ w0q) * xs) * s0) + b0;   h = act(h)           (f32)
//   hs = max(amax_row(h), 1e-8) * (1/127);   hq = round(h / hs)   (int8)
//   out = (res + (f32(hq @ w1q) * hs) * s1) + b1                  (T)
//
// with the layer scale gamma folded into s1 and b1 by the caller.  Every
// f32 step is rounded on its own (__fmul_rn/__fadd_rn/__fdiv_rn, no FMA
// contraction), in the order of the plain version
// (givepose_torch/ops/quant_matmul.py:mlp_int8_plain) and of _mlp_core;
// rounding is half to even (__float2int_rn, as jnp.round).  The int8
// products are exact int32 sums, so a kernel and its plain version differ
// only where tanhf (or erff) or an upstream last bit moves a value across
// a rounding boundary of the requantization: a one-step flip of an int8
// value.
//
// Contract: y, res, out (M, C) in T (bf16 or f32), row-major; w0t (H, C)
// and w1t (C, H) int8, the weights transposed (output channel-major, the
// layout of torch's Linear.weight); s0, b0 (H), s1, b1 (C), f32; with the
// prologue mu, rsig (M) and ln_g, ln_b (C), f32.  C and H multiples of 64.
//
// Bound: operations.  2*M*C*H int8 ops per product, two products: at
// batch 32 a stage-2 block (M 8192, C 512, H 2048) and a stage-3 block
// (M 2048, C 1024, H 4096) each do 3.44e10, 17.4 us at the int8 tensor
// core peak of 1979 TOP/s; bytes (y, res, out in bf16, both weights in
// int8) are ~27 MB, 8.2 us, at stage 2.
//
// Design: one block of 8 warps per BM rows (16 rows when C <= 512, else
// 8).  The hard part is the requantization: hs needs the amax over the
// whole H-wide hidden row before any of it is quantized.  This kernel
// keeps the block's BM x H f32 hidden rows in shared memory (128 KB at
// either width) rather than computing the first product twice: it costs
// occupancy (one block per SM) but no extra operations, and keeps h out
// of device memory, which is what the TPU kernel's fusion is for.  Both
// products run on the int8 tensor cores through mma.sync m16n8k32 (BM 8
// leaves half of each 16-row tile empty).  The A operand (quantized rows)
// is read from shared memory with a row stride that makes the 16-byte
// loads of a quarter-warp conflict-free; the B operand (weights) streams
// from L2/HBM straight into registers, 64 contiguous bytes per weight row
// per load.  Within each 64-wide K step the K order is permuted the same
// way in A and B (each lane loads 16 contiguous bytes), which leaves the
// exact int32 sum unchanged.  wgmma, TMA and a shared-memory weight ring
// are later work.

#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

// row stride (bytes) of an int8 A operand of K columns: a multiple of 64
// that is 64 mod 128, so the 16-byte loads of rows g and g+1 in one
// quarter-warp fall on disjoint banks
__host__ __device__ __forceinline__ int a_stride(int k) {
  return k % 128 == 0 ? k + 64 : k;
}

// acc[j][.] += A (BM x K, shared, stride as) @ B^T for the 64 output
// columns n0..n0+63, B (N x K) row-major in global memory.  Lane (g, t)
// holds rows g and g+8 and output columns n0 + 8j + 2t, +1 (mma.sync's C
// fragment); per 64-wide K step it loads 16 contiguous bytes of each of
// its A rows and of its B row, and feeds bytes 0-7 to one mma and bytes
// 8-15 to the next (the same K permutation in A and B).
template <int BM>
__device__ __forceinline__ void gemm_chunk(const int8_t* a, int as,
                                           const int8_t* __restrict__ b,
                                           int k, int n0, int lane,
                                           int acc[8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;
  }
  const int8_t* arow0 = a + g * as + 16 * t;
  const int8_t* arow1 = a + (g + 8) * as + 16 * t;
  const int8_t* brow = b + static_cast<long long>(n0 + g) * k + 16 * t;
#pragma unroll 2
  for (int k0 = 0; k0 < k; k0 += 64) {
    const uint4 q = *reinterpret_cast<const uint4*>(arow0 + k0);
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (BM == 16) r = *reinterpret_cast<const uint4*>(arow1 + k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          brow + static_cast<long long>(8 * j) * k + k0));
      mma_s8(acc[j], q.x, r.x, q.y, r.y, w.x, w.y);
      mma_s8(acc[j], q.z, r.z, q.w, r.w, w.z, w.w);
    }
  }
}

template <typename T, int BM, int ACT, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
int8_mlp_kernel(const T* __restrict__ y, const T* __restrict__ res,
                T* __restrict__ out, const int8_t* __restrict__ w0t,
                const float* __restrict__ s0, const float* __restrict__ b0,
                const int8_t* __restrict__ w1t,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const float* __restrict__ mu, const float* __restrict__ rsig,
                const float* __restrict__ ln_g,
                const float* __restrict__ ln_b, int m, int c, int hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = hd > c ? hd : c;               // f32 row width of hbuf
  float* hbuf = reinterpret_cast<float*>(smem_raw);            // BM x hw
  int8_t* yq = reinterpret_cast<int8_t*>(hbuf + BM * hw);     // BM x a_stride(c)
  int8_t* hq = yq + BM * a_stride(c);                          // BM x a_stride(hd)
  float* xs = reinterpret_cast<float*>(hq + BM * a_stride(hd));   // BM
  float* hs = xs + BM;                                         // BM

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;

  // 1. prologue and per-row quantization of y (padding rows are zeros)
  for (int i = warp; i < BM; i += kWarps) {
    const long long r = row0 + i;
    float* hrow = hbuf + i * hw;
    int8_t* qrow = yq + i * a_stride(c);
    if (r >= m) {
      for (int col = lane; col < c; col += 32) qrow[col] = 0;
      if (lane == 0) xs[i] = 1.0f;
      continue;
    }
    float amax = 0.0f;
    for (int col = lane; col < c; col += 32) {
      float v = to_f32(y[r * c + col]);
      if (LN) {
        v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu[r]), rsig[r]),
                                ln_g[col]),
                      ln_b[col]);
      }
      hrow[col] = v;
      amax = fmaxf(amax, fabsf(v));
    }
    const float scale = __fmul_rn(fmaxf(warp_max(amax), eps8()), inv127());
    for (int col = lane; col < c; col += 32) {
      qrow[col] = quantize(hrow[col], scale);
    }
    if (lane == 0) xs[i] = scale;
  }
  __syncthreads();

  // 2. h = act(dequant(yq @ w0q) + b0) into hbuf, 64 columns per warp task
  for (int n0 = warp * 64; n0 < hd; n0 += kWarps * 64) {
    int acc[8][4];
    gemm_chunk<BM>(yq, a_stride(c), w0t, c, n0, lane, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = g + (v >= 2 ? 8 : 0);
        if (i >= BM) continue;
        const int col = n0 + 8 * j + 2 * t + (v & 1);
        const float h = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[j][v]), xs[i]), s0[col]),
            b0[col]);
        hbuf[i * hw + col] = act_fn<ACT>(h);
      }
    }
  }
  __syncthreads();

  // 3. per-row requantization of h over all H columns
  for (int i = warp; i < BM; i += kWarps) {
    const float* hrow = hbuf + i * hw;
    int8_t* qrow = hq + i * a_stride(hd);
    float amax = 0.0f;
    for (int col = lane; col < hd; col += 32) {
      amax = fmaxf(amax, fabsf(hrow[col]));
    }
    const float scale = __fmul_rn(fmaxf(warp_max(amax), eps8()), inv127());
    for (int col = lane; col < hd; col += 32) {
      qrow[col] = quantize(hrow[col], scale);
    }
    if (lane == 0) hs[i] = scale;
  }
  __syncthreads();

  // 4. out = res + dequant(hq @ w1q) + b1
  for (int n0 = warp * 64; n0 < c; n0 += kWarps * 64) {
    int acc[8][4];
    gemm_chunk<BM>(hq, a_stride(hd), w1t, hd, n0, lane, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = g + (v >= 2 ? 8 : 0);
        const long long r = row0 + i;
        if (i >= BM || r >= m) continue;
        const int col = n0 + 8 * j + 2 * t + (v & 1);
        const float o = __fadd_rn(
            __fadd_rn(to_f32(res[r * c + col]),
                      __fmul_rn(__fmul_rn(__int2float_rn(acc[j][v]), hs[i]),
                                s1[col])),
            b1[col]);
        out[r * c + col] = from_f32<T>(o);
      }
    }
  }
}

size_t smem_bytes(int bm, int c, int hd) {
  const int hw = hd > c ? hd : c;
  return static_cast<size_t>(bm) * hw * sizeof(float) +
         static_cast<size_t>(bm) * (a_stride(c) + a_stride(hd)) +
         2 * bm * sizeof(float);
}

template <typename T, int BM, int ACT, bool LN>
int launch(const void* y, const void* res, void* out, const void* w0t,
           const void* s0, const void* b0, const void* w1t, const void* s1,
           const void* b1, const void* mu, const void* rsig,
           const void* ln_g, const void* ln_b, int m, int c, int hd,
           cudaStream_t stream) {
  auto kernel = int8_mlp_kernel<T, BM, ACT, LN>;
  const size_t bytes = smem_bytes(BM, c, hd);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((m + BM - 1) / BM);
  kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(res),
      static_cast<T*>(out), static_cast<const int8_t*>(w0t),
      static_cast<const float*>(s0), static_cast<const float*>(b0),
      static_cast<const int8_t*>(w1t), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(mu),
      static_cast<const float*>(rsig), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), m, c, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int ACT>
int with_ln(int has_ln, const void* y, const void* res, void* out,
            const void* w0t, const void* s0, const void* b0,
            const void* w1t, const void* s1, const void* b1, const void* mu,
            const void* rsig, const void* ln_g, const void* ln_b, int m,
            int c, int hd, cudaStream_t s) {
  return has_ln ? launch<T, BM, ACT, true>(y, res, out, w0t, s0, b0, w1t, s1,
                                           b1, mu, rsig, ln_g, ln_b, m, c,
                                           hd, s)
                : launch<T, BM, ACT, false>(y, res, out, w0t, s0, b0, w1t,
                                            s1, b1, mu, rsig, ln_g, ln_b, m,
                                            c, hd, s);
}

template <typename T, int BM>
int with_act(int act, int has_ln, const void* y, const void* res, void* out,
             const void* w0t, const void* s0, const void* b0,
             const void* w1t, const void* s1, const void* b1,
             const void* mu, const void* rsig, const void* ln_g,
             const void* ln_b, int m, int c, int hd, cudaStream_t s) {
  switch (act) {
    case 0:
      return with_ln<T, BM, 0>(has_ln, y, res, out, w0t, s0, b0, w1t, s1, b1,
                               mu, rsig, ln_g, ln_b, m, c, hd, s);
    case 1:
      return with_ln<T, BM, 1>(has_ln, y, res, out, w0t, s0, b0, w1t, s1, b1,
                               mu, rsig, ln_g, ln_b, m, c, hd, s);
    case 2:
      return with_ln<T, BM, 2>(has_ln, y, res, out, w0t, s0, b0, w1t, s1, b1,
                               mu, rsig, ln_g, ln_b, m, c, hd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int with_rows(int act, int has_ln, const void* y, const void* res, void* out,
              const void* w0t, const void* s0, const void* b0,
              const void* w1t, const void* s1, const void* b1,
              const void* mu, const void* rsig, const void* ln_g,
              const void* ln_b, int m, int c, int hd, cudaStream_t s) {
  if (smem_bytes(16, c, hd) <= kMaxSmem) {
    return with_act<T, 16>(act, has_ln, y, res, out, w0t, s0, b0, w1t, s1,
                           b1, mu, rsig, ln_g, ln_b, m, c, hd, s);
  }
  if (smem_bytes(8, c, hd) <= kMaxSmem) {
    return with_act<T, 8>(act, has_ln, y, res, out, w0t, s0, b0, w1t, s1, b1,
                          mu, rsig, ln_g, ln_b, m, c, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

// Plain-C entry point, loaded with ctypes.  y_bf16 selects T (1: bf16,
// 0: f32); act 0 none, 1 tanh GELU, 2 erf GELU; has_ln selects the LN
// prologue (mu, rsig, ln_g, ln_b are read only then).  Returns a CUDA
// error code: that of the launch (cudaGetLastError), of raising the
// shared-memory limit, or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for shapes the kernel does not take.
extern "C" int int8_mlp(const void* y, const void* res, void* out,
                        const void* w0t, const void* s0, const void* b0,
                        const void* w1t, const void* s1, const void* b1,
                        const void* mu, const void* rsig, const void* ln_g,
                        const void* ln_b, int m, int c, int hd, int y_bf16,
                        int act, int has_ln, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if (c <= 0 || hd <= 0 || c % 64 || hd % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return y_bf16
             ? with_rows<__nv_bfloat16>(act, has_ln, y, res, out, w0t, s0, b0,
                                        w1t, s1, b1, mu, rsig, ln_g, ln_b, m,
                                        c, hd, s)
             : with_rows<float>(act, has_ln, y, res, out, w0t, s0, b0, w1t,
                                s1, b1, mu, rsig, ln_g, ln_b, m, c, hd, s);
}
