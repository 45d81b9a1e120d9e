"""DCNv3 on the GPU: wrappers of the hand-written CUDA kernels and the
autograd Function that joins them.

Kernels: ``givepose_torch/csrc/dcnv3_fwd.cu``, ``csrc/dcnv3_win_fwd.cu``
and ``csrc/dcnv3_bwd.cu`` (sharing ``csrc/dcnv3_common.cuh``), built by
``ops/_build.py`` with nvcc for sm_90a and called through ctypes.  They
replace the TPU kernels ``givepose_tpu/ops/dcnv3_pallas.py:_dcnv3_kernel``
(forward, reached there through ``dcnv3_fast``),
``givepose_tpu/ops/dcnv3_window_pallas.py:_win_kernel`` (the forward with
samples clamped to a window, ``dcnv3_windowed``) and
``givepose_tpu/ops/dcnv3_pallas_bwd.py:_dcnv3_bwd_kernel`` (the backward
of both, with the clamp's gradient for the windowed one).

Forward bound: memory.  About 10 flop per (pixel, group, tap, channel)
against the bytes of x, offset, mask and out; at batch 32 the first
MAPEncoder layer moves ~115 MB, ~34 us at 3.35 TB/s.  The kernel takes x
in bf16 (halving the dominant read; the model's ``x_proj`` already is
bf16).  A block walks a tile of output pixels (``dcn_tile``), computes
each (pixel, group, tap)'s corners and weights once into shared memory,
and then gives each warp one pixel, all its groups, with ``_vec``
channels a lane (8 in 16-byte loads where gc and alignment allow).
Output is f32, as the TPU kernel's; the module casts it to its compute
dtype.

Windowed forward bound: memory, as the forward.  The window bounds the
input a tile of output pixels can reach, its slab: a block stages the
slab of one (image, group) into shared memory by TMA (or, where TMA's
rules fail, by its own copies), computes the tile's taps meanwhile into
a table of slab offsets and weights, and gathers from shared memory
only, 16-byte loads of 8 bf16 channels a lane.  ``win_plan`` chooses the
tiling per shape (see the source's note).

Backward bound: memory.  About 16 flop per (pixel, group, tap, channel)
(4 corner dots, 4 scatter products and adds) against x, grad_out, offset
and mask read once and d_x, d_offset, d_mask written once: at training
batch 48 the first layer moves ~395 MB, ~118 us at 3.35 TB/s.  The
wrapper fills d_x with zeros (the kernel adds into it; casting d_x to x's
dtype is ``DCNv3Function``'s).  Same shared-memory taps as the forward,
on smaller tiles and at most ``BWD_VEC`` channels a lane; d_x takes f32
reductions in L2, whose rate bounds the kernel, so its last bits vary
from run to run.

``dcnv3`` dispatches through the ``torch.ops.givepose`` operators of
``ops/library.py`` (``dcnv3_fwd``, ``dcnv3_win_fwd``, ``dcnv3_bwd``), whose
CUDA implementations are the wrappers below and whose CPU implementations
are the plain versions (``dcnv3_core``, ``dcnv3_core_bwd``): a CUDA tensor
reaches a kernel or a raise, a CPU tensor the plain version.  There is no
fallback from one to the other.  ``DCNv3Function`` joins the forward and
backward operators where a gradient is wanted; without one the forward
operator is called alone, which is what ``torch.export`` keeps in a
serving graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from givepose_torch.ops.dcnv3 import dcnv3_core

FWD_SOURCE = "dcnv3_fwd.cu"
WIN_FWD_SOURCE = "dcnv3_win_fwd.cu"
BWD_SOURCE = "dcnv3_bwd.cu"
_fns: dict[str, object] = {}


# C entry point -> (pointers, ints after offset_scale): every entry point
# takes its pointers with an int after the first (x's dtype), 11 int
# shapes, offset_scale, those ints (window where there is one, vec, and
# for the forward and the backward the tile's height and width, for the
# windowed forward its plan) and the stream
_SIGNATURES = {"dcnv3_fwd": (4, 3), "dcnv3_win_fwd": (4, 8),
               "dcnv3_bwd": (7, 4)}


def _bind(fn, name: str, n_tail: int | None = None):
    """Set the ctypes argument types of the C entry point ``name`` (with
    ``n_tail`` ints after offset_scale, if given)."""
    n_pointers, tail = _SIGNATURES[name]
    n_tail = tail if n_tail is None else n_tail
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * (n_pointers - 1)
                   + [ctypes.c_int] * 11
                   + [ctypes.c_float] + [ctypes.c_int] * n_tail
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(source: str, name: str):
    """The C entry point ``name`` of ``csrc/<source>``, bound."""
    if name not in _fns:
        from givepose_torch.ops._build import load_library

        _fns[name] = _bind(getattr(load_library(source), name), name)
    return _fns[name]


def _check_inputs(x, offset, mask, kernel, group, caller):
    """Raise unless x, offset and mask fit the kernels' contract; returns
    (n, h, w, h_out, w_out, gc)."""
    if not x.is_cuda:
        raise RuntimeError(f"{caller} needs CUDA tensors; CPU tensors go to "
                           "ops.dcnv3.dcnv3_core")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    for name, t in (("offset", offset), ("mask", mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, got {t.dtype}")
        if t.device != x.device:
            raise RuntimeError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError("x, offset and mask must be NHWC 4-d tensors")
    n, h, w, c_total = x.shape
    _, h_out, w_out, _ = offset.shape
    p = kernel * kernel
    if c_total % group:
        raise ValueError(f"channels {c_total} not divisible by group {group}")
    gc = c_total // group
    if tuple(offset.shape) != (n, h_out, w_out, group * p * 2):
        raise ValueError(f"offset shape {tuple(offset.shape)} does not match "
                         f"x {tuple(x.shape)}, group {group}, kernel {kernel}")
    if tuple(mask.shape) != (n, h_out, w_out, group * p):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not match "
                         f"offset {tuple(offset.shape)}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x.numel(), offset.numel(), n * h_out * w_out * c_total) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's 32-bit shapes")
    return n, h, w, h_out, w_out, gc


def _vec(gc: int, *tensors: torch.Tensor, top: int = 8) -> int:
    """The channels a lane of the forward or the backward moves at once:
    the largest of 8, 4, 2, 1, at most ``top``, that divides gc and to
    whose vector (16 bytes at most) every tensor is aligned."""
    for vec in (v for v in (8, 4, 2) if v <= top):
        if gc % vec == 0 and all(
                t.data_ptr() % min(vec * t.element_size(), 16) == 0
                for t in tensors):
            return vec
    return 1


# the backward's widest vector: 4 channels a lane, so that each 16-byte
# reduction into d_x covers whole 32-byte sectors with its neighbour lane
# (with 8 a lane it covers half of every sector it touches: 1.7 times the
# time, tools/dcnv3_breakdown.py)
BWD_VEC = 4

# shared memory a block of the forward or the backward may take: two
# blocks share an SM (227 KB a block at most, 228 KB an SM)
TILE_SMEM_BYTES = 112 * 1024
TAP_BYTES = 32          # dcnv3_common.cuh Tap: 4 offsets, 4 weights
DOT_BYTES = 16          # the backward's four f32 dots of a tap


def tile_smem_bytes(tile_h: int, tile_w: int, group: int, kernel: int,
                    backward: bool) -> int:
    """Shared memory of a block: its pixels' taps (and, backward, their
    dots), as ``dcnv3_common.cuh`` tile_smem_bytes."""
    per_tap = TAP_BYTES + (DOT_BYTES if backward else 0)
    return tile_h * tile_w * group * kernel * kernel * per_tap


def dcn_tile(group: int, kernel: int, backward: bool) -> tuple[int, int]:
    """Output pixels (rows, columns) a block walks: the forward 4 x 8 (four
    pixels a warp; 37 KB of taps at the MAPEncoder's 4 groups of 3 x 3),
    the backward 2 x 4 (one pixel a warp; 14 KB of taps and dots), halved
    along the longer side until the taps fit in ``TILE_SMEM_BYTES``;
    raises if one pixel's do not.  The backward's tile is small because
    its reductions into d_x run in L2, which holds the d_x of the images
    that the blocks in flight reach: at batch 48 a 4 x 8 tile (about 12
    images of 4 MB at layer 0) took 1.6 times as long as 2 x 4
    (``tools/dcnv3_breakdown.py``, PERF.md)."""
    th, tw = (2, 4) if backward else (4, 8)
    while tile_smem_bytes(th, tw, group, kernel, backward) > TILE_SMEM_BYTES:
        if th * tw == 1:
            raise ValueError(f"the taps of one pixel ({group} groups, "
                             f"kernel {kernel}) exceed the shared memory of "
                             "a block")
        if tw >= th:
            tw //= 2
        else:
            th //= 2
    return th, tw


# the windowed forward's plan (csrc/dcnv3_win_fwd.cu Plan): a tile of
# WIN_TILE output pixels of one (image, group) a block by default, halved
# along its longer side until the block's shared memory fits
# WIN_SMEM_BYTES (two blocks an SM; at the MAPEncoder's bf16 shapes a
# block takes 53 KB, and four share an SM) and until the grid has
# WIN_MIN_BLOCKS blocks (one for each of the H100's SMs) or the tile 8
# pixels.  Larger and smaller tiles, several tiles a block and one block
# an (image, group) were slower on the H100 (tools/win_kernel_split.py,
# PERF.md).
WIN_TILE = (4, 8)
WIN_SMEM_BYTES = 112 * 1024
WIN_MIN_BLOCKS = 132
WIN_MAX_SMEM = 227 * 1024          # a block's shared memory on the H100
WIN_BAR_BYTES = 128                # the slab buffers' mbarriers
WIN_TAP_BYTES = 16                 # SlabTap: a corner's offset, fx, fy, mask
WIN_MAX_TAPS = 512                 # a tile's taps: two for each of 256 threads
WIN_MAX_BOX = 256                  # TMA: elements along a box dimension


@dataclasses.dataclass(frozen=True)
class WinPlan:
    """How the windowed forward covers one shape: tiles of ``tile_rows`` x
    ``tile_cols`` output pixels of one (image, group), ``tiles_per_block``
    consecutive tiles of an image (row-major) a block, each tile's slab
    staged into one of ``stages`` shared buffers by ``staging`` ("tma" or
    "copy"), ``smem_bytes`` of shared memory a block.  The geometry it was
    made for is kept, so that its tiles and slabs can be listed."""

    tile_rows: int
    tile_cols: int
    tiles_per_block: int
    stages: int
    staging: str
    smem_bytes: int
    n: int
    ho: int
    wo: int
    group: int
    kernel: int
    stride: int
    pad: int
    dilation: int
    window: int

    @property
    def slab_rows(self) -> int:
        return win_span(self.tile_rows, self.stride, self.window)

    @property
    def slab_cols(self) -> int:
        return win_span(self.tile_cols, self.stride, self.window)

    @property
    def tiles_per_image(self) -> int:
        return (-(-self.ho // self.tile_rows)) * (-(-self.wo // self.tile_cols))

    @property
    def blocks(self) -> int:
        return self.n * self.group * -(-self.tiles_per_image
                                        // self.tiles_per_block)

    def block_tiles(self, chunk: int) -> list:
        """The first output pixel (oh0, ow0) of each tile that a block of
        an (image, group) walks, ``chunk`` counting its blocks."""
        n_ct = -(-self.wo // self.tile_cols)
        first = chunk * self.tiles_per_block
        last = min(first + self.tiles_per_block, self.tiles_per_image)
        return [(t // n_ct * self.tile_rows, t % n_ct * self.tile_cols)
                for t in range(first, last)]

    def slab_origin(self, oh0: int, ow0: int) -> tuple[int, int]:
        """The input pixel (y, x), unpadded, at the top left of the slab of
        the tile whose first output pixel is (oh0, ow0)."""
        half = self.dilation * (self.kernel - 1) // 2
        return (half + self.stride * oh0 - self.window - self.pad,
                half + self.stride * ow0 - self.window - self.pad)

    def args(self, gc: int, elem: int) -> tuple:
        """The plan's ints of the C entry point, after window: vec, tile
        rows and columns, tiles a block, stages, TMA, shared bytes."""
        return (win_vec(gc, elem), self.tile_rows, self.tile_cols,
                self.tiles_per_block, self.stages,
                int(self.staging == "tma"), self.smem_bytes)


def win_span(tile: int, stride: int, window: int) -> int:
    """Input pixels along one side of a slab: a tile of ``tile`` outputs
    at ``stride`` reaches centre +- window and the +1 neighbour."""
    return stride * (tile - 1) + 2 * window + 2


def win_vec(gc: int, elem: int) -> int:
    """The channels a lane gathers at once from the slab (16-byte aligned
    in shared memory whatever x's alignment): the largest of 8, 4, 2, 1
    that divides gc and spans at most 16 bytes."""
    return next(v for v in (8, 4, 2, 1) if gc % v == 0 and v * elem <= 16)


def win_smem_bytes(tile_rows: int, tile_cols: int, stages: int,
                   tiles_per_block: int, gc: int, elem: int, kernel: int,
                   stride: int, window: int) -> int:
    """A block's shared memory, as ``csrc/dcnv3_win_fwd.cu`` make_plan
    counts it: the mbarriers, ``stages`` slabs of gc channels a pixel
    (each rounded up to 128 bytes) and a table of the tile's taps, two
    when the block walks several tiles (the next tile's taps are written
    while the current one is sampled)."""
    slab = (win_span(tile_rows, stride, window)
            * win_span(tile_cols, stride, window) * gc * elem)
    tables = 2 if tiles_per_block > 1 else 1
    return (WIN_BAR_BYTES + stages * (-(-slab // 128) * 128)
            + tables * tile_rows * tile_cols * kernel * kernel
            * WIN_TAP_BYTES)


@functools.lru_cache(maxsize=512)
def win_plan(n: int, ho: int, wo: int, group: int, gc: int, elem: int,
             kernel: int, stride: int, pad: int, dilation: int, window: int,
             aligned: bool = True, mode: str = "default") -> WinPlan:
    """The windowed forward's plan for one shape (x of ``elem`` bytes an
    element, ``aligned``: its base 16-byte aligned).  ``mode``: "default"
    (one tile a block), "mono" (one block an (image, group), walking all
    of its tiles), "chunkN" (N tiles a block); any of them may be joined
    by "-" with "tileRxC" (tiles of R x C before fitting) or "copy" (the
    block's own copies instead of TMA).  A block that walks
    several tiles stages the next slab into a second buffer while it
    samples the current one, where two fit in ``WIN_SMEM_BYTES``.  TMA
    stages the slab where its rules hold (x aligned, gc and G*gc channels
    whole multiples of 16 bytes, each box side at most 256); the block
    copies it otherwise.  Raises ValueError where not even a one-pixel
    tile's slab fits in a block's shared memory."""
    tile, per_block, staging = None, 1, None
    for token in mode.split("-"):
        if token == "default":
            continue
        if token == "mono":
            per_block = 0
        elif token.startswith("chunk") and token[5:].isdigit():
            per_block = int(token[5:])
        elif token.startswith("tile") and "x" in token:
            tile = tuple(int(v) for v in token[4:].split("x"))
        elif token == "copy":
            staging = "copy"
        else:
            raise ValueError(f"unknown windowed-forward plan {mode!r}")
    fit_grid = tile is None and per_block == 1
    tile = tile or WIN_TILE
    tr, tc = min(tile[0], ho), min(tile[1], wo)

    def smem(r, c, s):
        return win_smem_bytes(r, c, s, per_block, gc, elem, kernel, stride,
                              window)

    def blocks(r, c):
        return n * group * (-(-ho // r)) * (-(-wo // c))

    while tr * tc > 1 and (smem(tr, tc, 1) > WIN_SMEM_BYTES
                           or tr * tc * kernel * kernel > WIN_MAX_TAPS):
        tr, tc = (tr, tc // 2) if tc >= tr else (tr // 2, tc)
    while fit_grid and blocks(tr, tc) < WIN_MIN_BLOCKS and tr * tc > 8:
        tr, tc = (tr, tc // 2) if tc >= tr else (tr // 2, tc)
    if (smem(tr, tc, 1) > WIN_MAX_SMEM
            or tr * tc * kernel * kernel > WIN_MAX_TAPS):
        raise ValueError(
            f"the windowed DCNv3 forward's one-pixel slab ({gc} channels of "
            f"{elem} bytes, stride {stride}, window {window}: "
            f"{smem(1, 1, 1)} bytes) exceeds a block's shared memory "
            f"({WIN_MAX_SMEM})")
    tiles = (-(-ho // tr)) * (-(-wo // tc))
    per_block = min(per_block or tiles, tiles)
    c_total = group * gc
    tma_ok = (aligned and (gc * elem) % 16 == 0
              and (c_total * elem) % 16 == 0 and gc <= WIN_MAX_BOX
              and max(win_span(tr, stride, window),
                      win_span(tc, stride, window)) <= WIN_MAX_BOX)
    staging = staging or ("tma" if tma_ok else "copy")
    if staging == "tma" and not tma_ok:
        raise ValueError(f"plan {mode!r}: TMA cannot stage this shape")
    stages = 2 if (staging == "tma" and per_block > 1
                   and smem(tr, tc, 2) <= WIN_SMEM_BYTES) else 1
    return WinPlan(tr, tc, per_block, stages, staging, smem(tr, tc, stages),
                   n, ho, wo, group, kernel, stride, pad, dilation, window)


def win_args(x, offset, mask, out, kernel, stride, pad, dilation, group,
             offset_scale, window, plan: str = "default") -> tuple:
    """The arguments of the C entry point ``dcnv3_win_fwd`` for checked
    inputs at the plan ``plan`` (a ``win_plan`` mode), on the current
    stream of x's device."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shapes = _shape_args(x, offset, kernel, stride, pad, dilation, group,
                         offset_scale)
    n, _, _, ho, wo, _, gc = shapes[:7]
    wp = win_plan(n, ho, wo, group, gc, x.element_size(), kernel, stride,
                  pad, dilation, int(window), x.data_ptr() % 16 == 0, plan)
    return (x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), out.data_ptr(), *shapes, int(window),
            *wp.args(gc, x.element_size()), stream)


def _shape_args(x, offset, kernel, stride, pad, dilation, group,
                offset_scale) -> list:
    n, h, w, c_total = x.shape
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernels' grid (65535)")
    return [n, h, w, offset.shape[1], offset.shape[2], group,
            c_total // group, kernel, stride, pad, dilation,
            float(offset_scale)]


def fwd_args(x, offset, mask, out, kernel, stride, pad, dilation, group,
             offset_scale) -> tuple:
    """The arguments of the C entry point ``dcnv3_fwd`` for checked
    inputs, on the current stream of x's device."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shapes = _shape_args(x, offset, kernel, stride, pad, dilation, group,
                         offset_scale)
    return (x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), out.data_ptr(), *shapes, _vec(shapes[6], x),
            *dcn_tile(group, kernel, False), stream)


def bwd_args(x, offset, mask, grad_out, d_x, d_offset, d_mask, kernel,
             stride, pad, dilation, group, offset_scale, window) -> tuple:
    """The arguments of the C entry point ``dcnv3_bwd`` for checked
    inputs, on the current stream of x's device."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shapes = _shape_args(x, offset, kernel, stride, pad, dilation, group,
                         offset_scale)
    return (x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), grad_out.data_ptr(), d_x.data_ptr(),
            d_offset.data_ptr(), d_mask.data_ptr(), *shapes, int(window),
            _vec(shapes[6], x, grad_out, top=BWD_VEC),
            *dcn_tile(group, kernel, True), stream)


def dcnv3_cuda(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               kernel: int = 3, stride: int = 1, pad: int = 1,
               dilation: int = 1, group: int = 4,
               offset_scale: float = 1.0) -> torch.Tensor:
    """Launch the DCNv3 forward kernel.  Contract of ``dcnv3_core``
    (window 0): x (N,H,W,G*gc) bf16/f32, offset (N,Ho,Wo,G*P*2) f32,
    mask (N,Ho,Wo,G*P) f32, all contiguous on one CUDA device; returns
    (N,Ho,Wo,G*gc) f32."""
    n, h, w, h_out, w_out, gc = _check_inputs(x, offset, mask, kernel, group,
                                              "dcnv3_cuda")
    c_total = x.shape[-1]
    out = torch.empty((n, h_out, w_out, c_total), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _kernel(FWD_SOURCE, "dcnv3_fwd")(*fwd_args(
            x, offset, mask, out, kernel, stride, pad, dilation, group,
            offset_scale))
    if err != 0:
        raise RuntimeError(f"dcnv3_fwd launch failed: cudaError {err}")
    dcnv3_cuda.launches += 1
    return out


dcnv3_cuda.launches = 0


def dcnv3_win_cuda(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   kernel: int = 3, stride: int = 1, pad: int = 1,
                   dilation: int = 1, group: int = 4,
                   offset_scale: float = 1.0, window: int = 3,
                   plan: str = "default") -> torch.Tensor:
    """Launch the windowed DCNv3 forward kernel.  Contract of
    ``dcnv3_core(..., window=window)`` with window > 0, inputs as
    ``dcnv3_cuda``; returns (N,Ho,Wo,G*gc) f32.  ``plan``: a ``win_plan``
    mode (the operator takes the default); each launch is counted in
    ``launches`` and, by plan, in ``plan_launches``."""
    if int(window) != window or window <= 0:
        raise ValueError(f"window must be a positive int, got {window}")
    n, h, w, h_out, w_out, gc = _check_inputs(x, offset, mask, kernel, group,
                                              "dcnv3_win_cuda")
    c_total = x.shape[-1]
    out = torch.empty((n, h_out, w_out, c_total), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _kernel(WIN_FWD_SOURCE, "dcnv3_win_fwd")(*win_args(
            x, offset, mask, out, kernel, stride, pad, dilation, group,
            offset_scale, window, plan))
    if err != 0:
        raise RuntimeError(f"dcnv3_win_fwd launch failed: cudaError {err}")
    dcnv3_win_cuda.launches += 1
    dcnv3_win_cuda.plan_launches[plan] = (
        dcnv3_win_cuda.plan_launches.get(plan, 0) + 1)
    return out


dcnv3_win_cuda.launches = 0
dcnv3_win_cuda.plan_launches = {}


def dcnv3_bwd_cuda(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   grad_out: torch.Tensor, kernel: int = 3, stride: int = 1,
                   pad: int = 1, dilation: int = 1, group: int = 4,
                   offset_scale: float = 1.0, window: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the DCNv3 backward kernel: the forward's inputs (contract of
    ``dcnv3_cuda``) and grad_out (N,Ho,Wo,G*gc) f32, contiguous; returns
    (d_x, d_offset, d_mask), all f32, as ``ops.dcnv3.dcnv3_core_bwd``
    with the same ``window`` (0: unbounded offsets)."""
    if int(window) != window or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window}")
    n, h, w, h_out, w_out, gc = _check_inputs(x, offset, mask, kernel, group,
                                              "dcnv3_bwd_cuda")
    if grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out must be f32, got {grad_out.dtype}")
    if grad_out.device != x.device:
        raise RuntimeError(f"grad_out is on {grad_out.device}, x on "
                           f"{x.device}")
    if tuple(grad_out.shape) != (n, h_out, w_out, x.shape[-1]):
        raise ValueError(f"grad_out shape {tuple(grad_out.shape)} does not "
                         f"match the output of x {tuple(x.shape)}")
    if not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous")

    d_x = torch.zeros(x.shape, device=x.device, dtype=torch.float32)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    with torch.cuda.device(x.device):
        err = _kernel(BWD_SOURCE, "dcnv3_bwd")(*bwd_args(
            x, offset, mask, grad_out, d_x, d_offset, d_mask, kernel, stride,
            pad, dilation, group, offset_scale, window))
    if err != 0:
        raise RuntimeError(f"dcnv3_bwd launch failed: cudaError {err}")
    dcnv3_bwd_cuda.launches += 1
    return d_x, d_offset, d_mask


dcnv3_bwd_cuda.launches = 0


def _forward_op(x, offset, mask, kernel, stride, pad, dilation, group,
                offset_scale, window):
    """The forward operator: windowed when ``window`` > 0."""
    if window > 0:
        return torch.ops.givepose.dcnv3_win_fwd(
            x, offset, mask, kernel, stride, pad, dilation, group,
            offset_scale, window)
    return torch.ops.givepose.dcnv3_fwd(x, offset, mask, kernel, stride, pad,
                                        dilation, group, offset_scale)


class DCNv3Function(torch.autograd.Function):
    """DCNv3 through the forward operator (window 0) or the windowed
    forward operator, and the backward operator with the same window: on
    CUDA tensors the kernels, on CPU tensors the plain versions.  Returns
    f32 (N,Ho,Wo,G*gc); d_x comes back in x's dtype, as the transpose of
    the JAX module's cast of ``x_proj`` to f32."""

    @staticmethod
    def forward(ctx, x, offset, mask, kernel, stride, pad, dilation, group,
                offset_scale, window):
        ctx.save_for_backward(x, offset, mask)
        ctx.kw = dict(kernel=kernel, stride=stride, pad=pad,
                      dilation=dilation, group=group,
                      offset_scale=offset_scale, window=window)
        return _forward_op(x, offset, mask, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask = ctx.saved_tensors
        d_x, d_offset, d_mask = torch.ops.givepose.dcnv3_bwd(
            x, offset, mask, grad_out.float().contiguous(), *ctx.kw.values())
        return (d_x.to(x.dtype), d_offset, d_mask,
                None, None, None, None, None, None, None)


def dcnv3(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
          kernel: int = 3, stride: int = 1, pad: int = 1, dilation: int = 1,
          group: int = 4, offset_scale: float = 1.0, window: int = 0,
          impl: str = "auto") -> torch.Tensor:
    """DCNv3, f32 out, differentiable.  ``impl``: auto (the operators:
    kernels for CUDA tensors, plain versions for CPU tensors), cuda
    (kernels only), torch (the plain version's ops).  ``window`` > 0
    clamps every sample to +-window px of its query (the windowed kernel
    on CUDA tensors)."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown dcn impl {impl!r}")
    if impl == "torch":
        return dcnv3_core(x.float(), offset, mask, kernel=kernel,
                          stride=stride, pad=pad, dilation=dilation,
                          group=group, offset_scale=offset_scale,
                          window=window)
    if impl == "cuda" and not x.is_cuda:
        raise RuntimeError("dcnv3(impl='cuda') needs CUDA tensors; CPU "
                           "tensors go to ops.dcnv3.dcnv3_core")
    args = (x.contiguous(), offset.contiguous(), mask.contiguous(), kernel,
            stride, pad, dilation, group, offset_scale, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:3]):
        return DCNv3Function.apply(*args)
    return _forward_op(*args)

