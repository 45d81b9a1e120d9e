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
bf16) and loads each bilinear corner of a group as one coalesced 128-byte
read, one warp per (n, output pixel, group).  Output is f32, as the TPU
kernel's; the module casts it to its compute dtype.

Windowed forward bound: memory, as the forward.  A block stages the slab
of x that its tile of output rows can reach in shared memory and gathers
from there (the window bounds the slab; see the source's note).

Backward bound: memory.  About 16 flop per (pixel, group, tap, channel)
(4 corner dots, 4 scatter products and atomic adds) against x, grad_out,
offset and mask read once and d_x, d_offset, d_mask written once: at
training batch 48 the first layer moves ~395 MB, ~118 us at 3.35 TB/s
(zeroing d_x and casting it to x's dtype are extra traffic outside the
kernel).  Same warp layout as the forward; d_x is scattered with f32
atomics, so its last bits vary from run to run.  Later work can cut the
atomics (a shared-memory tile of d_x) and the repeated corner reads.

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

import torch

from givepose_torch.ops.dcnv3 import dcnv3_core

FWD_SOURCE = "dcnv3_fwd.cu"
WIN_FWD_SOURCE = "dcnv3_win_fwd.cu"
BWD_SOURCE = "dcnv3_bwd.cu"
_fns: dict[str, object] = {}


def _kernel(source: str, name: str, n_pointers: int, n_tail: int = 1):
    """The C entry point ``name`` of ``csrc/<source>``: ``n_pointers``
    pointers with an int after the first (x's dtype), 11 int shapes,
    offset_scale, ``n_tail`` ints (window where there is one, then vec)
    and the stream."""
    if name not in _fns:
        from givepose_torch.ops._build import load_library

        fn = getattr(load_library(source), name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * (n_pointers - 1)
                       + [ctypes.c_int] * 11
                       + [ctypes.c_float] + [ctypes.c_int] * n_tail
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
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


def _vec(gc: int, *tensors: torch.Tensor) -> int:
    """2 when every lane may move two channels at once, else 1."""
    aligned = all(t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors)
    return 2 if gc % 2 == 0 and aligned else 1


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
    vec = _vec(gc, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(FWD_SOURCE, "dcnv3_fwd", 4)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), out.data_ptr(), n, h, w, h_out, w_out, group,
            gc, kernel, stride, pad, dilation, float(offset_scale), vec,
            stream)
    if err != 0:
        raise RuntimeError(f"dcnv3_fwd launch failed: cudaError {err}")
    dcnv3_cuda.launches += 1
    return out


dcnv3_cuda.launches = 0


def dcnv3_win_cuda(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   kernel: int = 3, stride: int = 1, pad: int = 1,
                   dilation: int = 1, group: int = 4,
                   offset_scale: float = 1.0, window: int = 3
                   ) -> torch.Tensor:
    """Launch the windowed DCNv3 forward kernel.  Contract of
    ``dcnv3_core(..., window=window)`` with window > 0, inputs as
    ``dcnv3_cuda``; returns (N,Ho,Wo,G*gc) f32."""
    if int(window) != window or window <= 0:
        raise ValueError(f"window must be a positive int, got {window}")
    if kernel * kernel > 32:
        raise ValueError(f"the windowed kernel takes kernel <= 5, got "
                         f"{kernel}")
    n, h, w, h_out, w_out, gc = _check_inputs(x, offset, mask, kernel, group,
                                              "dcnv3_win_cuda")
    c_total = x.shape[-1]
    out = torch.empty((n, h_out, w_out, c_total), device=x.device,
                      dtype=torch.float32)
    vec = 2 if gc % 2 == 0 else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(WIN_FWD_SOURCE, "dcnv3_win_fwd", 4, 2)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), out.data_ptr(), n, h, w, h_out, w_out, group,
            gc, kernel, stride, pad, dilation, float(offset_scale),
            int(window), vec, stream)
    if err != 0:
        raise RuntimeError(f"dcnv3_win_fwd launch failed: cudaError {err}")
    dcnv3_win_cuda.launches += 1
    return out


dcnv3_win_cuda.launches = 0


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
    vec = _vec(gc, x, grad_out)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(BWD_SOURCE, "dcnv3_bwd", 7, 2)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), grad_out.data_ptr(), d_x.data_ptr(),
            d_offset.data_ptr(), d_mask.data_ptr(), n, h, w, h_out, w_out,
            group, gc, kernel, stride, pad, dilation, float(offset_scale),
            int(window), vec, stream)
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

