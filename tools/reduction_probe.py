#!/usr/bin/env python3
"""How fast this card adds f32 values into memory, four ways.

    python3 tools/reduction_probe.py

The DCNv3 backward scatters m w_k grad_out into d_x, about nine additions
per input value.  This probe times four ways of adding f32 values to
64-channel rows picked by a hash, the same number of values each:
  - global float2 atomicAdd, a warp on one 256-byte row (the backward's
    first design);
  - global ``red.global.add.v4.f32``, 8 lanes on one row, two a lane,
    and 16 lanes on one row, one a lane;
  - shared-memory f32 ``atomicAdd`` into a 112 KB tile (what a d_x tile in
    shared memory would use);
  - plain shared loads, adds and stores on the same tile (racy; for
    scale);
  - shared f32, int32 and 64-bit integer ``atomicAdd``, a warp on one row
    with no bank conflicts.
It prints the SASS of each reduction (``cuobjdump``): a shared f32
atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN).  Rows are random
here, so the global rates are a floor for the backward's pattern, whose
neighbouring taps hit neighbouring lines.  It needs one NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""// Rates of the f32 reductions a DCNv3 backward can use.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}

// kind 0: float2 atomicAdd, a warp on one 256-byte pixel-group row
__global__ void k_f2(float* buf, int npix, int iters) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (int it = 0; it < iters; ++it) {
    unsigned px = hash32(warp * 977u + it) % npix;
    atomicAdd(reinterpret_cast<float2*>(buf + px * 64 + lane * 2),
              make_float2(1.0f, 2.0f));
  }
}

// kind 1: red.global.add.v4.f32, 8 lanes on one 256-byte row, 2 a lane
// (each reduction covers half of each 32-byte sector)
__global__ void k_v4(float* buf, int npix, int iters) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (int it = 0; it < iters / 4; ++it) {
    unsigned px = hash32((warp * 4 + (lane >> 3)) * 977u + it) % npix;
    float* d = buf + px * 64 + (lane & 7) * 8;
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(d),
                 "f"(1.0f), "f"(2.0f), "f"(3.0f), "f"(4.0f) : "memory");
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(d + 4),
                 "f"(1.0f), "f"(2.0f), "f"(3.0f), "f"(4.0f) : "memory");
  }
}

// kind 4: red.global.add.v4.f32, 16 lanes on one 256-byte row, 1 a lane
// (each reduction covers whole sectors)
__global__ void k_v4_rows(float* buf, int npix, int iters) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (int it = 0; it < iters / 2; ++it) {
    unsigned px = hash32((warp * 2 + (lane >> 4)) * 977u + it) % npix;
    float* d = buf + px * 64 + (lane & 15) * 4;
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(d),
                 "f"(1.0f), "f"(2.0f), "f"(3.0f), "f"(4.0f) : "memory");
  }
}

// kind 2: shared-memory float atomicAdd into a 112 KB tile, 8 a lane
// kind 3: the same with plain shared loads and stores (racy, for scale)
template <bool ATOMIC>
__global__ void k_smem(float* buf, int iters) {
  extern __shared__ float tile[];
  const int n = 112 * 1024 / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (int it = 0; it < iters / 4; ++it) {
    unsigned px = hash32((warp * 4 + (lane >> 3)) * 977u + it) % (n / 64);
    float* d = tile + px * 64 + (lane & 7) * 8;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (ATOMIC) atomicAdd(d + v, 1.0f);
      else d[v] += 1.0f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    buf[blockIdx.x * 64 + (i & 63)] += tile[i];
}

// kinds 5-7: a warp on one 64-channel row of the tile, lane l on words
// l and l + 32 (no bank conflicts): f32 atomicAdd, int32 atomicAdd,
// 64-bit integer atomicAdd
template <typename V>
__global__ void k_smem_rows(float* buf, int iters) {
  extern __shared__ __align__(16) unsigned char raw[];
  V* tile = reinterpret_cast<V*>(raw);
  const int n = 112 * 1024 / sizeof(V);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = V(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  for (int it = 0; it < iters; ++it) {
    unsigned px = hash32(warp * 977u + it) % (n / 64);
    atomicAdd(tile + px * 64 + lane, V(1));
    atomicAdd(tile + px * 64 + 32 + lane, V(1));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    buf[blockIdx.x * 64 + (i & 63)] += static_cast<float>(tile[i]);
}

extern "C" int run(int kind, float* buf, int npix, int blocks, int iters,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) k_f2<<<blocks, 256, 0, s>>>(buf, npix, iters);
  if (kind == 1) k_v4<<<blocks, 256, 0, s>>>(buf, npix, iters);
  if (kind == 4) k_v4_rows<<<blocks, 256, 0, s>>>(buf, npix, iters);
  if (kind >= 5) {
    auto k = kind == 5 ? k_smem_rows<float>
             : kind == 6 ? k_smem_rows<int>
                         : k_smem_rows<unsigned long long>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         112 * 1024);
    k<<<blocks, 256, 112 * 1024, s>>>(buf, iters);
  }
  if (kind == 2 || kind == 3) {
    auto k = kind == 2 ? k_smem<true> : k_smem<false>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         112 * 1024);
    k<<<blocks, 256, 112 * 1024, s>>>(buf, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

KINDS = ((0, "global float2 atomicAdd"),
         (1, "global red.v4.f32, half sectors"),
         (4, "global red.v4.f32, whole sectors"),
         (2, "shared atomicAdd f32"), (3, "shared ld/add/st"),
         (5, "shared atomicAdd f32, no bank conflicts"),
         (6, "shared atomicAdd int32, no bank conflicts"),
         (7, "shared atomicAdd u64, no bank conflicts"))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("reduction_probe: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from givepose_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "reduction_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir,
                                                               "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True).stdout
    for line in sass.splitlines():
        if "Function" in line or "ATOM" in line or "RED" in line:
            smoke.log(f"  {line.strip()[:100]}")
    card = smoke.card_line()
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    npix = 48 * 64 * 64 * 4       # 64-channel rows of layer 0's d_x
    buf = torch.zeros(npix * 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 256
    # global kinds twice: rows over layer 0's 201 MB d_x (most reductions
    # miss the 50 MB L2), and over 8 MB (they hit it)
    runs = [(k, n, npix) for k, n in KINDS] + [
        (k, n + ", 8 MB", npix // 24) for k, n in KINDS if k in (0, 4)]
    for kind, name, rows in runs:
        blocks = 132 * 2 if kind in (2, 3, 5, 6, 7) else 132 * 8

        def call():
            err = fn(kind, buf.data_ptr(), rows, blocks, iters, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        ms = smoke.time_ms(call, 5)
        adds = blocks * 256 * iters * 2    # 8 values every 4 steps
        smoke.log(f"  {name}: {ms * 1e3:.1f} us, {adds / ms / 1e6:.1f} G "
                  f"adds/s ({4 * adds / ms / 1e6:.0f} GB/s of f32) [{card}]")


if __name__ == "__main__":
    main()
