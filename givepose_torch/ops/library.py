"""The port's kernels as PyTorch operators, namespace ``givepose``.

Each kernel of ``csrc/`` is a ``torch.library.custom_op``:

  ==================================  =======================================
  ``torch.ops.givepose.dcnv3_fwd``     DCNv3 forward (``csrc/dcnv3_fwd.cu``)
  ``torch.ops.givepose.dcnv3_win_fwd`` windowed forward (``dcnv3_win_fwd.cu``)
  ``torch.ops.givepose.dcnv3_bwd``     DCNv3 backward (``dcnv3_bwd.cu``)
  ``torch.ops.givepose.int8_mlp``      fused int8 ConvNeXt MLP (``int8_mlp.cu``)
  ``torch.ops.givepose.int8_qmm``      W8A8 dense, x quantized inside
                                       (``int8_qmm.cu``)
  ``torch.ops.givepose.int8_qmm_pre``  W8A8 dense on int8 x (``int8_qmm.cu``)
  ==================================  =======================================

Each has a CUDA implementation, the kernel's wrapper (which counts its
launches), a CPU implementation, the kernel's plain version, and a fake
implementation that gives the output's shape and dtype.  So a CPU tensor
reaches the plain version and a CUDA tensor the kernel or a raise, and a
graph that ``torch.export`` traces keeps each operator as one node, which
runs the kernel wherever the graph is served on the card.  Importing this
module registers the operators.  The package ``givepose_torch.ops``
imports it, so any module of the package that launches through
``torch.ops.givepose`` (``dcnv3_cuda.dcnv3``, the dispatch of
``quant_matmul``) finds them registered; ``eval/serving.py`` imports it
before it loads an exported graph.
"""

# no ``from __future__ import annotations``: custom_op reads the
# annotations to build each operator's schema

from typing import Optional

import torch

from givepose_torch.ops import dcnv3, dcnv3_cuda, quant_matmul


def _dcn_out(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    return offset.new_empty((*offset.shape[:3], x.shape[-1]))


@torch.library.custom_op("givepose::dcnv3_fwd", mutates_args=(),
                         device_types="cpu")
def dcnv3_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              kernel: int, stride: int, pad: int, dilation: int, group: int,
              offset_scale: float) -> torch.Tensor:
    """DCNv3 forward, f32 (N, Ho, Wo, C) out; CPU: ``dcnv3_core``."""
    return dcnv3.dcnv3_core(x.float(), offset, mask, kernel=kernel,
                            stride=stride, pad=pad, dilation=dilation,
                            group=group, offset_scale=offset_scale)


@dcnv3_fwd.register_kernel("cuda")
def _(x, offset, mask, kernel, stride, pad, dilation, group, offset_scale):
    return dcnv3_cuda.dcnv3_cuda(x, offset, mask, kernel=kernel,
                                 stride=stride, pad=pad, dilation=dilation,
                                 group=group, offset_scale=offset_scale)


@dcnv3_fwd.register_fake
def _(x, offset, mask, kernel, stride, pad, dilation, group, offset_scale):
    return _dcn_out(x, offset)


@torch.library.custom_op("givepose::dcnv3_win_fwd", mutates_args=(),
                         device_types="cpu")
def dcnv3_win_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  kernel: int, stride: int, pad: int, dilation: int,
                  group: int, offset_scale: float, window: int
                  ) -> torch.Tensor:
    """DCNv3 forward with every sample clamped to +-window px of its
    query; CPU: ``dcnv3_core(..., window=window)``."""
    return dcnv3.dcnv3_core(x.float(), offset, mask, kernel=kernel,
                            stride=stride, pad=pad, dilation=dilation,
                            group=group, offset_scale=offset_scale,
                            window=window)


@dcnv3_win_fwd.register_kernel("cuda")
def _(x, offset, mask, kernel, stride, pad, dilation, group, offset_scale,
      window):
    return dcnv3_cuda.dcnv3_win_cuda(x, offset, mask, kernel=kernel,
                                     stride=stride, pad=pad,
                                     dilation=dilation, group=group,
                                     offset_scale=offset_scale,
                                     window=window)


@dcnv3_win_fwd.register_fake
def _(x, offset, mask, kernel, stride, pad, dilation, group, offset_scale,
      window):
    return _dcn_out(x, offset)


@torch.library.custom_op("givepose::dcnv3_bwd", mutates_args=(),
                         device_types="cpu")
def dcnv3_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              grad_out: torch.Tensor, kernel: int, stride: int, pad: int,
              dilation: int, group: int, offset_scale: float, window: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_x, d_offset, d_mask), all f32; CPU: ``dcnv3_core_bwd``."""
    return dcnv3.dcnv3_core_bwd(x, offset, mask, grad_out, kernel=kernel,
                                stride=stride, pad=pad, dilation=dilation,
                                group=group, offset_scale=offset_scale,
                                window=window)


@dcnv3_bwd.register_kernel("cuda")
def _(x, offset, mask, grad_out, kernel, stride, pad, dilation, group,
      offset_scale, window):
    return dcnv3_cuda.dcnv3_bwd_cuda(x, offset, mask, grad_out,
                                     kernel=kernel, stride=stride, pad=pad,
                                     dilation=dilation, group=group,
                                     offset_scale=offset_scale,
                                     window=window)


@dcnv3_bwd.register_fake
def _(x, offset, mask, grad_out, kernel, stride, pad, dilation, group,
      offset_scale, window):
    return (x.new_empty(x.shape, dtype=torch.float32),
            torch.empty_like(offset), torch.empty_like(mask))


@torch.library.custom_op("givepose::int8_mlp", mutates_args=(),
                         device_types="cpu")
def int8_mlp(y: torch.Tensor, residual: torch.Tensor, w0t: torch.Tensor,
             s0: torch.Tensor, b0: torch.Tensor, w1t: torch.Tensor,
             s1: torch.Tensor, b1: torch.Tensor, act: str,
             out_dtype: torch.dtype, mu: Optional[torch.Tensor],
             rsig: Optional[torch.Tensor], ln_g: Optional[torch.Tensor],
             ln_b: Optional[torch.Tensor]) -> torch.Tensor:
    """Fused int8 ConvNeXt MLP on (M, C) rows, weights quantized and
    transposed (w0t (H, C), w1t (C, H)); the LN prologue when mu is given.
    CPU: ``mlp_int8_plain``."""
    ln = None if mu is None else (mu.reshape(-1, 1), rsig.reshape(-1, 1),
                                  ln_g, ln_b)
    return quant_matmul.mlp_int8_plain(y, residual, w0t.t(), s0, b0,
                                       w1t.t(), s1, b1, act, out_dtype, ln)


@int8_mlp.register_kernel("cuda")
def _(y, residual, w0t, s0, b0, w1t, s1, b1, act, out_dtype, mu, rsig,
      ln_g, ln_b):
    if out_dtype != y.dtype:
        raise TypeError(f"the kernel writes y's dtype {y.dtype}, not "
                        f"{out_dtype}")
    ln = None if mu is None else (mu, rsig, ln_g, ln_b)
    return quant_matmul.mlp_int8_cuda(y, residual, w0t, s0, b0, w1t, s1, b1,
                                      act, ln)


@int8_mlp.register_fake
def _(y, residual, w0t, s0, b0, w1t, s1, b1, act, out_dtype, mu, rsig,
      ln_g, ln_b):
    return y.new_empty(y.shape, dtype=out_dtype)


@torch.library.custom_op("givepose::int8_qmm", mutates_args=(),
                         device_types="cpu")
def int8_qmm(x: torch.Tensor, wt: torch.Tensor, ws: torch.Tensor,
             bias: Optional[torch.Tensor], act: str,
             out_dtype: torch.dtype) -> torch.Tensor:
    """W8A8 dense (M, K) x (N, K)^T with x quantized per row inside.
    CPU: ``quant_matmul_plain``."""
    return quant_matmul.quant_matmul_plain(x, wt.t(), ws, bias, act,
                                           out_dtype)


@int8_qmm.register_kernel("cuda")
def _(x, wt, ws, bias, act, out_dtype):
    return quant_matmul.qmm_cuda(x, wt, ws, bias, act, out_dtype)


@int8_qmm.register_fake
def _(x, wt, ws, bias, act, out_dtype):
    return x.new_empty((x.shape[0], wt.shape[0]), dtype=out_dtype)


@torch.library.custom_op("givepose::int8_qmm_pre", mutates_args=(),
                         device_types="cpu")
def int8_qmm_pre(xq: torch.Tensor, xs: torch.Tensor, wt: torch.Tensor,
                 ws: torch.Tensor, bias: Optional[torch.Tensor], act: str,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """W8A8 dense on int8 x (M, K) with row scales xs (M,).
    CPU: ``quant_matmul_pre_plain``."""
    return quant_matmul.quant_matmul_pre_plain(xq, xs, wt.t(), ws, bias, act,
                                               out_dtype)


@int8_qmm_pre.register_kernel("cuda")
def _(xq, xs, wt, ws, bias, act, out_dtype):
    return quant_matmul.qmm_pre_cuda(xq, xs, wt, ws, bias, act, out_dtype)


@int8_qmm_pre.register_fake
def _(xq, xs, wt, ws, bias, act, out_dtype):
    return xq.new_empty((xq.shape[0], wt.shape[0]), dtype=out_dtype)
