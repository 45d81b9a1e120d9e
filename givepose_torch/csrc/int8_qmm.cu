// W8A8 dense matmuls for Hopper, sm_90a: wgmma s8 from shared memory, the
// int8 operands by TMA through an mbarrier ring, persistent blocks.
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
// where tanhf or erff differs from PyTorch's.  M and N take any size (the
// ragged edges are masked, and TMA reads zeros past them); K must be a
// multiple of 16 with every operand's base 16-byte aligned, TMA's rules,
// which the wrapper meets by padding with zeros along K where a caller's
// tensor does not (ops/quant_matmul.py qmm_pad: zeros add nothing to a
// sum and leave a row's amax as it was).
//
// Bound.  2*M*N*K int8 ops at 1979 TOP/s against x, wt, out (and xs) read
// or written once at 3.35 TB/s.  At the ConvNeXt-B MLP shapes of batch 32
// (1.72e10 ops, 8.7 us each): the stage-2 matmuls (8192 x 512 -> 2048 and
// 8192 x 2048 -> 512) move ~43 MB with bf16 x and out, 12.8 us, bound by
// bytes; the stage-3 ones (2048 x 1024 -> 4096, 2048 x 4096 -> 1024) ~25
// MB, 7.5 us, bound by operations.  B5 reads x at half the bytes.
//
// Design.  A block is four consumer warpgroups and a producer warpgroup
// (640 threads, one block per SM; setmaxnreg gives the consumers 112
// registers, the producer 24).  One producer thread streams the operands'
// 128-byte K slices by TMA (cp.async.bulk.tensor, 128-byte swizzle, zeros
// past every edge) into a ring of up to 8 stages, each with a full and an
// empty mbarrier, in the order the consumers take them; the consumers run
// wgmma m64nNk32 s8 on each stage as it lands, keep one group in flight
// and release a stage when the group after the one that read it is
// committed, and apply the epilogue to the accumulator fragments in
// registers: the f32 steps, then 16-byte stores of bf16 rows (a transpose
// of the 8-column blocks within each quad of lanes) or 8-byte f32 pairs.
// The epilogue (GELU's tanhf and, in B5, five bf16 roundings an output)
// and B4's quantization (an IEEE division a value) are bound by the
// issue of their instructions and their latency, so four consumer
// warpgroups (16 warps) take them where two took 1.3x as long.  The grid
// is persistent: min(units, SMs) blocks, block b walking units b, b +
// grid, ..., so the producer loads the next tile's slices while the
// consumers finish one tile's epilogue.  A unit is `group` consecutive
// column tiles of one row tile, `gpr` units a row tile; the wrapper picks
// them (ops/quant_matmul.py qmm_plan, which a CPU test holds to cover
// every output tile exactly once).
//   B5: 128 x 128 tiles, one a unit; a stage is the xq slice (128 rows)
//       and the wt slice (128 rows).  Two teams of two warpgroups (64 rows
//       x 128 columns each) take the block's tiles in turn, and their
//       products run in turn too (named barriers), so that one team's
//       epilogue runs while the other's products and loads do.
//   B4: 64 x 256 tiles, each warpgroup all 64 rows x 64 columns; the
//       stages carry wt slices only.  As the TPU kernel quantizes a row
//       tile once and keeps it across its sequential N grid, a block takes
//       the row tile's amax over the whole K row (a warp a row), then
//       quantizes each K slice of its rows into shared memory (64 swizzled
//       128-byte rows, the layout wgmma reads; a 16-byte chunk a thread,
//       loaded a slice ahead) just before its first product, and keeps
//       every slice for the unit's other column tiles when they all fit
//       beside the ring ("resident", K <= 2048); otherwise a ring of 4
//       slots is quantized again per column tile (K 4096 at stage 3, where
//       a unit is one column tile: no slice is quantized twice by one
//       block).  So a row tile is quantized once per unit: gpr times in
//       all (1 at stage 2; 4 at stage 3, whose 32 row tiles of 64 fill 128
//       SMs only with 4 units each).  The amax of a row does not depend on
//       the order of the max, so any split is exact.
// Left (PERF.md, tools/qmm_breakdown.py): the epilogue's instructions
// (GELU, stores) are the largest part at the fc1 shapes; B4 at stage 3
// quantizes its rows 4 times over, which a cluster of the row tile's
// blocks sharing the quantized slices would avoid.

#include <algorithm>

#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int kQConsumers = 512;            // four consumer warpgroups
constexpr int kThreads = kQConsumers + 128;  // + the producer warpgroup
constexpr int kARows = 64;                   // rows of a B4 tile
constexpr int kASlot = kARows * kSlice;      // a quantized K slice of them
constexpr int kMaxStages = 8;

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

// 8 values of x from 16 bytes (bf16) or 32 (f32) as f32
__device__ __forceinline__ void unpack8(const uint4& a, float* v) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const uint4& a, const uint4& b,
                                        float* v) {
  v[0] = __uint_as_float(a.x); v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z); v[3] = __uint_as_float(a.w);
  v[4] = __uint_as_float(b.x); v[5] = __uint_as_float(b.y);
  v[6] = __uint_as_float(b.z); v[7] = __uint_as_float(b.w);
}

// 16-byte words of 16 values of x: 2 (bf16) or 4 (f32)
template <typename TX>
constexpr int kWords = 16 * static_cast<int>(sizeof(TX)) / 16;

// 16 values of x from their 16-byte words, as f32
template <typename TX>
__device__ __forceinline__ void unpack16(const uint4 (&u)[kWords<TX>],
                                         float* v) {
  if constexpr (sizeof(TX) == 2) {
    unpack8(u[0], v);
    unpack8(u[1], v + 8);
  } else {
    unpack8(u[0], u[1], v);
    unpack8(u[2], u[3], v + 8);
  }
}

// amax of a row of x (k columns, a multiple of 16, 16-byte aligned) by one
// warp, 16 values a lane at a time, up to four loads in flight
template <typename TX>
__device__ __forceinline__ float row_amax(const TX* __restrict__ xr, int k,
                                          int lane) {
  float amax = 0.0f;
#pragma unroll 4
  for (int c = 16 * lane; c < k; c += 512) {
    uint4 u[kWords<TX>];
#pragma unroll
    for (int w = 0; w < kWords<TX>; ++w) {
      u[w] = __ldg(reinterpret_cast<const uint4*>(xr + c) + w);
    }
    float v[16];
    unpack16<TX>(u, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  return warp_max(amax);
}

__device__ __forceinline__ uint32_t pack4(const int8_t* q) {
  return static_cast<uint32_t>(static_cast<uint8_t>(q[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(q[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(q[3])) << 24;
}

// v rounded half to even to an integer, for |v| < 2^22: the f32 sum with
// 1.5 * 2^23 has a unit ulp, so the addition itself rounds, on the FMA
// pipe; __float2int_rn would take the conversion pipe, which the
// quantization's IEEE division also needs (its reciprocal)
__device__ __forceinline__ int rint_small(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

// 16 values quantized with scale and packed: round(v / scale), the
// quotient at most 127 in magnitude (scale = amax / 127)
__device__ __forceinline__ uint4 quantize16(const float* v, float scale) {
  int8_t q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    q[i] = static_cast<int8_t>(rint_small(__fdiv_rn(v[i], scale)));
  }
  return make_uint4(pack4(q), pack4(q + 4), pack4(q + 8), pack4(q + 12));
}

// B4: a consumer thread's share of K slice kb (columns 128 kb ..) of the
// tile's 64 rows of x: the 16 columns from 128 kb + 16 (tid % 8) of row
// tid / 8, as raw 16-byte words (zeros past m and k).  Loaded one slice
// ahead of their quantization, so that the loads' latency passes under
// the products of the slice before.
template <typename TX>
struct XChunk {
  uint4 u[kWords<TX>];

  __device__ __forceinline__ void load(const TX* __restrict__ x,
                                       long long row0, int m, int k, int kb,
                                       int tid) {
    const int c = kb * kSlice + (tid & 7) * 16;
    const long long row = row0 + (tid >> 3);
    const bool live = row < m && c < k;
    const uint4* src = reinterpret_cast<const uint4*>(x + row * k + c);
#pragma unroll
    for (int w = 0; w < kWords<TX>; ++w) {
      u[w] = live ? __ldg(src + w) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // quantized with the row's scale into a slot of 64 swizzled 128-byte
  // rows
  __device__ __forceinline__ void store(int8_t* __restrict__ slot,
                                        const float* xs_s, int tid) const {
    const int r = tid >> 3;
    float v[16];
    unpack16<TX>(u, v);
    const uint4 q = quantize16(v, xs_s[r]);
    *reinterpret_cast<uint4*>(slot + swz(r, (tid & 7) * 16)) = q;
  }
};

// one output's f32 epilogue in the plain versions' order: ((acc * xs) *
// ws) + b, then the activation (B5: on the sum rounded to bf16)
template <int ACT, bool PRE>
__device__ __forceinline__ float epilogue(int acc, float xs, float w,
                                          float b) {
  const float v =
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), w), b);
  return PRE ? act_pre<ACT>(bf(v)) : act_fn<ACT>(v);
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// lane q of each quad (4 lanes) holds v[b], b = 0..3; returns lane 0..3's
// v[q]: a transpose within the quad
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4],
                                                int q) {
  uint32_t r[4];
  r[0] = pick(v, q);
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    r[s] = __shfl_xor_sync(0xffffffffu, pick(v, q ^ s), s);
  }
  return make_uint4(pick(r, q), pick(r, q ^ 1), pick(r, q ^ 2),
                    pick(r, q ^ 3));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// row r's values y[b][e] at columns c0 + 8 b + 2 q + e (b < 4, q the lane
// in its quad) into out (M, N): bf16 with N a multiple of 8 as one 16-byte
// store of columns c0 + 8 q .. + 7 after a transpose within the quad (every
// lane takes part), f32 with N even as 8-byte pairs, else one at a time
template <typename TO>
__device__ __forceinline__ void store4(TO* __restrict__ out, long long r,
                                       int c0, int m, int n, int q,
                                       const float (&y)[4][2]) {
  const long long o = r * n + c0;
  if constexpr (sizeof(TO) == 2) {
    if (n % 8 == 0) {
      uint32_t v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) v[b] = bf16x2(y[b][0], y[b][1]);
      const uint4 t = quad_transpose(v, q);
      if (r < m && c0 + 8 * q < n) {
        *reinterpret_cast<uint4*>(out + o + 8 * q) = t;
      }
      return;
    }
  } else {
    if (n % 2 == 0) {
      if (r >= m) return;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (c0 + 8 * b + 2 * q < n) {
          *reinterpret_cast<float2*>(out + o + 8 * b + 2 * q) =
              make_float2(y[b][0], y[b][1]);
        }
      }
      return;
    }
  }
  if (r >= m) return;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c0 + 8 * b + 2 * q + e < n) {
        out[o + 8 * b + 2 * q + e] = from_f32<TO>(y[b][e]);
      }
    }
  }
}

// a consumer warpgroup's output tile: this thread's rows ra and ra + 8,
// their scales, and the warpgroup's first column
struct Tile {
  long long ra;
  float xa, xb;
  int col0;
};

// a warpgroup's WN columns of its tile, four 8-column blocks at a time:
// the epilogue and the stores
template <int WN, int ACT, bool PRE, typename TO>
__device__ __forceinline__ void epilogue_tile(
    const int (&acc)[WN / 2], const Tile& t, TO* __restrict__ out,
    const float* __restrict__ ws, const float* __restrict__ bias, int m,
    int n, int q) {
#pragma unroll
  for (int g = 0; g < WN / 32; ++g) {
    float ya[4][2], yb[4][2];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 4 * g + b;
        const int col = t.col0 + 8 * j + 2 * q + e;
        const int cc = col < n ? col : n - 1;
        const float w = __ldg(ws + cc);
        const float bb = bias != nullptr ? __ldg(bias + cc) : 0.0f;
        ya[b][e] = epilogue<ACT, PRE>(acc[4 * j + e], t.xa, w, bb);
        yb[b][e] = epilogue<ACT, PRE>(acc[4 * j + 2 + e], t.xb, w, bb);
      }
    }
    store4<TO>(out, t.ra, t.col0 + 32 * g, m, n, q, ya);
    store4<TO>(out, t.ra + 8, t.col0 + 32 * g, m, n, q, yb);
  }
}

struct Params {
  const void* x;        // B4: x (M, K); B5: unused (xq arrives by TMA)
  const float* xs;      // B5: the row scales (M)
  const float* ws;      // (N)
  const float* bias;    // (N) or null
  void* out;            // (M, N)
  int m, n, k;          // k a multiple of 16
  int group;            // column tiles of a unit
  int gpr;              // units of a row tile
  int stages;           // ring stages
  int a_slots;          // B4: quantized K slices kept (all nk: resident)
};

// The two layouts of the four consumer warpgroups:
//   B5: 128 x 128 tiles, two teams of two warpgroups (64 rows x 128
//       columns each) that take the block's tiles in turn;
//   B4: 64 x 256 tiles, the four warpgroups 64 x 64 each, sharing the
//       tile's 64 quantized rows.
template <bool PRE>
__host__ __device__ constexpr int tile_rows() {
  return PRE ? 128 : kARows;
}
template <bool PRE>
__host__ __device__ constexpr int tile_cols() {
  return PRE ? 128 : 256;
}

// a ring stage: B5's xq slice and the wt slice, 128 bytes a row
template <bool PRE>
__host__ __device__ constexpr int stage_bytes() {
  return ((PRE ? tile_rows<PRE>() : 0) + tile_cols<PRE>()) * kSlice;
}

// named barriers 2 and 3, between B5's two teams
__device__ __forceinline__ void team_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kQConsumers) : "memory");
}
__device__ __forceinline__ void team_signal(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kQConsumers)
               : "memory");
}

// TX: x's type (int8_t when PRE, read by TMA through amap); TO: output
// type
template <int ACT, bool PRE, typename TX, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
qmm_kernel(const __grid_constant__ CUtensorMap amap,
           const __grid_constant__ CUtensorMap bmap, const Params p) {
  constexpr int BM = tile_rows<PRE>(), BN = tile_cols<PRE>();
  constexpr int WN = PRE ? 128 : 64;          // columns of a warpgroup
  // the consumer threads that read a stage: B5's team, or all of B4's
  constexpr int USERS = PRE ? kQConsumers / 2 : kQConsumers;
  constexpr int A_BYTES = PRE ? BM * kSlice : 0;
  constexpr int STAGE = stage_bytes<PRE>();

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tiles = base;
  int8_t* aslots = reinterpret_cast<int8_t*>(tiles + p.stages * STAGE);
  float* xs_s = reinterpret_cast<float*>(aslots + p.a_slots * kASlot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs_s + BM);
  // bars[0, stages): full; bars[stages, 2 stages): empty

  const int m = p.m, n = p.n, k = p.k;
  const int nk = (k + kSlice - 1) / kSlice;
  const int ctiles = (n + BN - 1) / BN;
  const int units = (m + BM - 1) / BM * p.gpr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + p.stages + s), USERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kQConsumers) {
    // producer: one thread loads every stage in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != kQConsumers) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int rt = u / p.gpr, c0 = (u % p.gpr) * p.group;
      const int c1 = min(c0 + p.group, ctiles);
      for (int ct = c0; ct < c1; ++ct) {
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % p.stages;
          const uint32_t full = smem_u32(bars + s);
          const uint32_t dst = smem_u32(tiles + s * STAGE);
          mbar_wait(smem_u32(bars + p.stages + s),
                    ((it / p.stages) & 1) ^ 1);
          mbar_expect_tx(full, STAGE);
          if constexpr (PRE) {
            tma_load(dst, &amap, kb * kSlice, rt * BM, full);
          }
          tma_load(dst + A_BYTES, &bmap, kb * kSlice, ct * BN, full);
        }
      }
    }
    return;
  }

  // the registers the producer gave back, (96 - 24) x 128, spread over
  // the 512 consumer threads: 96 + 18, rounded down to a multiple of 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31, q = lane & 3;
  // B5's team; this thread's first row of the tile (the second is 8
  // below), and the warpgroup's first row and column
  const int team = PRE ? wg >> 1 : 0;
  const int wrow = PRE ? 64 * (wg & 1) : 0, wcol = PRE ? 0 : WN * wg;
  const int r_a = wrow + 16 * (warp & 3) + (lane >> 2);
  const TX* x = static_cast<const TX*>(p.x);
  TO* out = static_cast<TO*>(p.out);
  const bool resident = p.a_slots >= nk;

  Ring ring;
  ring.tiles = smem_u32(tiles);
  ring.full = smem_u32(bars);
  ring.stages = p.stages;
  ring.stage_bytes = STAGE;
  ring.lane = lane;
  ring.it = team * nk;          // a team's first tile is the block's team-th
  XChunk<TX> chunk;

  for (int u = blockIdx.x + team * gridDim.x; u < units;
       u += (PRE ? 2 : 1) * gridDim.x) {
    const int rt = u / p.gpr, c0 = (u % p.gpr) * p.group;
    const int c1 = min(c0 + p.group, ctiles);
    const long long row0 = static_cast<long long>(rt) * BM;
    const long long ra = row0 + r_a;
    float xa, xb;
    if constexpr (PRE) {
      xa = ra < m ? p.xs[ra] : 1.0f;
      xb = ra + 8 < m ? p.xs[ra + 8] : 1.0f;
    } else {
      // the tile's row scales over whole K rows, a warp a row (after the
      // last unit's products and quantization are done with xs_s and the
      // slots)
      consumer_sync<kQConsumers>();
      for (int r = warp; r < kARows; r += kQConsumers / 32) {
        const long long row = row0 + r;
        const TX* xr = x + row * k;
        const float amax = row < m ? row_amax(xr, k, lane) : 0.0f;
        if (lane == 0) xs_s[r] = row < m ? row_scale(amax) : 1.0f;
      }
      consumer_sync<kQConsumers>();
      xa = xs_s[r_a];
      xb = xs_s[r_a + 8];
    }
    for (int ct = c0; ct < c1; ++ct) {
      // B4 quantizes the rows on the unit's first column tile, or on every
      // one when its K slices do not all stay (a ring of slots, reused
      // only after every warpgroup drained the last tile's products)
      const bool quant = !PRE && (ct == c0 || !resident);
      if constexpr (!PRE) {
        if (quant) {
          if (ct != c0) consumer_sync<kQConsumers>();
          chunk.load(x, row0, m, k, 0, tid);
        }
      }
      int acc[WN / 2];
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
      // B5: the other team's products of the block's tile before this one
      // are issued first, so that the teams' products run in turn and one
      // team's epilogue while the other's products and loads
      if constexpr (PRE) {
        if (u != blockIdx.x) team_wait(2 + team);
      }
      for (int kb = 0; kb < nk; ++kb) {
        uint32_t a = 0;
        if constexpr (!PRE) {
          int8_t* slot = aslots + kb % p.a_slots * kASlot;
          if (quant) {
            chunk.store(slot, xs_s, tid);
            fence_async_smem();
            consumer_sync<kQConsumers>();
            if (kb + 1 < nk) chunk.load(x, row0, m, k, kb + 1, tid);
          }
          a = smem_u32(slot);
        }
        const uint32_t stage = ring.acquire();
        if constexpr (PRE) a = stage + wrow * kSlice;
        const uint32_t b = stage + A_BYTES + wcol * kSlice;
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < kSlice; kk += 32) {
          wgmma_tile<WN>(acc, desc(a + kk), desc(b + kk));
        }
        wgmma_commit();
        ring.retire();
      }
      if constexpr (PRE) {
        if (u + gridDim.x < units) team_signal(3 - team);
        ring.it += nk;          // the other team's tile
      }
      ring.drain();
      fence_acc(acc);
      epilogue_tile<WN, ACT, PRE, TO>(acc, Tile{ra, xa, xb, ct * BN + wcol},
                                      out, p.ws, p.bias, m, n, q);
    }
  }
}

// dynamic shared memory: the ring, B4's slots, the row scales, the
// barriers and 1 KB of alignment slack (ops/quant_matmul.py qmm_smem)
size_t smem_bytes(int stage, int stages, int a_slots, int bm) {
  return static_cast<size_t>(stages) * stage +
         static_cast<size_t>(a_slots) * kASlot + bm * sizeof(float) +
         2 * kMaxStages * sizeof(uint64_t) + 1024;
}

template <int ACT, bool PRE, typename TX, typename TO>
int launch(const Params& p, const void* xq, const void* wt, int blocks,
           cudaStream_t stream) {
  const int nk = (p.k + kSlice - 1) / kSlice;
  const size_t bytes = smem_bytes(stage_bytes<PRE>(), p.stages, p.a_slots,
                                  tile_rows<PRE>());
  // a ring of B4 slots needs 3: a slot is written again only after every
  // warpgroup's products that read it are done
  if (p.stages < 2 || p.stages > kMaxStages || bytes > kMaxSmem ||
      p.group < 1 || p.gpr < 1 || blocks < 1 ||
      (PRE ? p.a_slots != 0 || p.group != 1
           : p.a_slots < std::min(nk, 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap amap{}, bmap{};
  if (!int8_map(&bmap, wt, p.n, p.k, tile_cols<PRE>()) ||
      (PRE && !int8_map(&amap, xq, p.m, p.k, tile_rows<PRE>()))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = qmm_kernel<ACT, PRE, TX, TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, bytes, stream>>>(amap, bmap, p);
  return static_cast<int>(cudaGetLastError());
}

// bn: the plan's tile width, which must be the kernel's
template <typename TX, typename TO, bool PRE>
int dispatch(int act, const Params& p, const void* xq, const void* wt,
             int bn, int blocks, cudaStream_t s) {
  if (bn != tile_cols<PRE>()) return static_cast<int>(cudaErrorInvalidValue);
  switch (act) {
    case 0:
      return launch<0, PRE, TX, TO>(p, xq, wt, blocks, s);
    case 1:
      return launch<1, PRE, TX, TO>(p, xq, wt, blocks, s);
    case 2:
      return launch<2, PRE, TX, TO>(p, xq, wt, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int m, int n, int k) {
  return m < 0 || n <= 0 || k <= 0 || k % 16 != 0;
}

}  // namespace

// Plain-C entry points, loaded with ctypes.  Pointers: x (M, K) (bf16 if
// x_bf16, else f32), wt (N, K) int8, ws (N) f32, bias (N) f32 or null, out
// (M, N) (bf16 if out_bf16, else f32); int8_qmm_pre takes xq (M, K) int8
// and xs (M) f32 instead of x.  K a multiple of 16 and x (xq) and wt
// 16-byte aligned.  act 0 none, 1 tanh GELU, 2 erf GELU.  The plan
// (ops/quant_matmul.py qmm_plan): bn columns a tile (B4 256, B5 128),
// group column tiles a unit, gpr units a row tile, stages of the ring,
// a_slots quantized K slices of B4 (0 for B5), blocks of the persistent
// grid.  Each returns a
// CUDA error code: that of the launch (cudaGetLastError), of raising the
// shared-memory limit, or cudaErrorInvalidValue for arguments the kernel
// does not take (or when the driver has no cuTensorMapEncodeTiled).
extern "C" int int8_qmm(const void* x, int x_bf16, const void* wt,
                        const void* ws, const void* bias, void* out,
                        int out_bf16, int m, int n, int k, int act, int bn,
                        int group, int gpr, int stages, int a_slots,
                        int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const Params p{x,     nullptr, static_cast<const float*>(ws),
                 static_cast<const float*>(bias), out, m, n, k, group, gpr,
                 stages, a_slots};
  if (x_bf16) {
    return out_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16, false>(
                          act, p, nullptr, wt, bn, blocks, s)
                    : dispatch<__nv_bfloat16, float, false>(
                          act, p, nullptr, wt, bn, blocks, s);
  }
  return out_bf16 ? dispatch<float, __nv_bfloat16, false>(act, p, nullptr,
                                                          wt, bn, blocks, s)
                  : dispatch<float, float, false>(act, p, nullptr, wt, bn,
                                                  blocks, s);
}

extern "C" int int8_qmm_pre(const void* xq, const void* xs, const void* wt,
                            const void* ws, const void* bias, void* out,
                            int out_bf16, int m, int n, int k, int act,
                            int bn, int group, int gpr, int stages,
                            int a_slots, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(m, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const Params p{nullptr, static_cast<const float*>(xs),
                 static_cast<const float*>(ws),
                 static_cast<const float*>(bias), out, m, n, k, group, gpr,
                 stages, a_slots};
  return out_bf16 ? dispatch<int8_t, __nv_bfloat16, true>(act, p, xq, wt, bn,
                                                          blocks, s)
                  : dispatch<int8_t, float, true>(act, p, xq, wt, bn, blocks,
                                                  s);
}
