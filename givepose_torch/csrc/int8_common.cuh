// Shared pieces of the int8 kernels (int8_mlp.cu, int8_qmm.cu), sm_90a:
// the f32 constants of the JAX package's int8 arithmetic, dtype
// conversions, the f32 activation, half-to-even quantization and the int8
// tensor-core product (mma.sync m16n8k32, s8 x s8 -> s32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

// f32 constants, bit for bit those the JAX package and the plain versions
// use (each a Python float rounded once to f32)
__device__ __forceinline__ float inv127() { return __int_as_float(0x3c010204); }
__device__ __forceinline__ float eps8() { return __int_as_float(0x322bcc77); }
__device__ __forceinline__ float gelu_c() { return __int_as_float(0x3f4c422a); }
__device__ __forceinline__ float gelu_k() { return __int_as_float(0x3d372713); }
__device__ __forceinline__ float sqrt2() { return __int_as_float(0x3fb504f3); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// _apply_act in f32: 0 none, 1 tanh GELU, 2 erf GELU
template <int ACT>
__device__ __forceinline__ float act_fn(float y) {
  if (ACT == 1) {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(gelu_k(), y), y), y);
    const float t = tanhf(__fmul_rn(gelu_c(), __fadd_rn(y, cube)));
    return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, t));
  }
  if (ACT == 2) {
    const float e = erff(__fdiv_rn(y, sqrt2()));
    return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, e));
  }
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// round(v / scale) half to even, as jnp.round and torch.round
__device__ __forceinline__ int8_t quantize(float v, float scale) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, scale)));
}

// per-row scale max(amax, 1e-8) * (1/127), as the TPU kernels take it
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, eps8()), inv127());
}

__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace int8k
