// Shared pieces of the int8 kernels (int8_mlp.cu, int8_qmm.cu), sm_90a:
// the f32 constants of the JAX package's int8 arithmetic, dtype
// conversions, the f32 activation and half-to-even quantization; and the
// Hopper machinery both kernels are built from (the mbarriers, TMA loads
// and tensor-map encoder of hopper_common.cuh): int8 tiles in 128-byte
// swizzled rows and the tensor map that describes them, wgmma s8 from
// shared memory, and the consumers' side of a TMA ring fed by a producer
// warp.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace int8k {

using hopper::EncodeTiled;
using hopper::encoder;
using hopper::fence_async_smem;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;

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

// ---- TMA tiles and the consumers' barrier ----------------------------

constexpr int kSlice = 128;          // K bytes of a TMA box (the swizzle)
constexpr int kConsumers = 256;      // two consumer warpgroups (B6)
constexpr size_t kMaxSmem = 227 * 1024;

// byte offset of (row, k) in a tile of 128-byte rows under the 128-byte
// swizzle that TMA writes and wgmma reads: the 16-byte chunk index xor
// the row within its group of 8 (the tile 1024-byte aligned)
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// the N consumer threads, not the producer warpgroup
template <int N = kConsumers>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma -----------------------------------------------------------

// K-major operand in 128-byte swizzled rows: start >> 4, leading offset
// 16 B (unused by the swizzled K-major layout), stride 1024 B between
// groups of 8 rows, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, s32) += A (64 x 32 int8) @ B (256 x 32 int8)^T
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32 int8) @ B (128 x 32 int8)^T
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, s32) += A (64 x 32 int8) @ B (64 x 32 int8)^T
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32, s32) += A (64 x 32 int8) @ B (32 x 32 int8)^T
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N, s32) += A (64 x 32 int8) @ B (N x 32 int8)^T; d holds N / 2
// registers a thread: for each 8 columns j, [4j, 4j + 1] the thread's row
// (16 w + lane / 4, w its warp) at columns 8j + 2 (lane % 4) + {0, 1},
// [4j + 2, 4j + 3] the row 8 below
template <int N, int R>
__device__ __forceinline__ void wgmma_tile(int (&d)[R], uint64_t a,
                                           uint64_t b) {
  static_assert(R == N / 2, "accumulator registers");
  if constexpr (N == 256) {
    wgmma_n256(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_n128(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_n64(d, a, b);
  } else {
    static_assert(N == 32, "wgmma width");
    wgmma_n32(d, a, b);
  }
}

// ---- the consumers' side of the ring ------------------------------------

// Stages arrive in the order the producer issues them, each with a full
// mbarrier (bars[s]) and an empty one (bars[stages + s]) that every
// consumer warp arrives on.  A consumer keeps one wgmma group in flight:
// after committing the group that reads a stage it waits for the group
// before, and releases that one's stage.
struct Ring {
  uint32_t tiles;   // shared address of stage 0
  uint32_t full;    // shared address of full[0]; empty[] follows
  int stages;
  int stage_bytes;
  int lane;
  int it = 0;       // stages acquired
  int pend = -1;    // stage read by the group still in flight

  __device__ __forceinline__ uint32_t acquire() {
    const int s = it % stages;
    mbar_wait(full + 8 * s, (it / stages) & 1);
    return tiles + s * stage_bytes;
  }
  __device__ __forceinline__ void release() {
    if (pend >= 0 && lane == 0) mbar_arrive(full + 8 * (stages + pend));
    pend = -1;
  }
  // after the group that read the stage of acquire() was committed
  __device__ __forceinline__ void retire() {
    wgmma_wait<1>();
    release();
    pend = it % stages;
    ++it;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    release();
  }
};

// ---- host side --------------------------------------------------------

// a row-major int8 matrix (rows x cols, cols a multiple of 16, the base
// 16-byte aligned: TMA's rules) read in boxes of box_rows x 128 bytes,
// 128-byte swizzle, zeros beyond its edges
inline bool int8_map(CUtensorMap* map, const void* w, int rows, int cols,
                     int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlice),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace int8k
