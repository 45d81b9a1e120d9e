"""Fused W8A8 ConvNeXt MLP: the plain PyTorch version and the CUDA kernel.

Port of ``givepose_tpu/ops/quant_matmul_pallas.py``'s ``_apply_act``,
``quantize_weights`` and ``convnext_mlp_int8``.  The whole MLP tail of a
ConvNeXt block runs in int8 with dynamic per-row activation scales::

    out = residual + gamma * (act(y @ w0 + b0) @ w1 + b1)

with an optional LayerNorm prologue on y.  Both versions follow the TPU
kernel's ``_mlp_core`` (``quant_matmul_pallas.py:219-237``), not the JAX
package's CPU fallback: the activation scale is
``max(amax, 1e-8) * (1/127)`` (the fallback divides by 127, which can
differ by an ulp and flip a rounding).  Rounding is half to even.  The
int8 products are exact integer sums (taken here in float64, which holds
them exactly, then rounded to f32 as an int32 would be).

``convnext_mlp_int8`` dispatches: a CPU tensor goes to ``mlp_int8_plain``,
a CUDA tensor to the kernel ``givepose_torch/csrc/int8_mlp.cu``
(``mlp_int8_cuda``, replacing ``_mlp_kernel`` and ``_mlp_ln_kernel``) or
a raise.  There is no fallback.  Weights are quantized per output channel
with plain tensor ops on every call, as the JAX package does in-graph.
The kernel is bound by its int8 operations; see the source's note.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

SOURCE = "int8_mlp.cu"
ACTS = {"none": 0, "gelu_tanh": 1, "gelu_exact": 2}
# np.sqrt(2/pi) rounded to f32, as _apply_act takes it
GELU_C = float(np.sqrt(2.0 / np.pi).astype(np.float32))
_fn = []


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """``_apply_act`` in f32, in the JAX expression's order."""
    if act == "none":
        return y
    if act == "gelu_tanh":
        cube = 0.044715 * y * y * y
        return 0.5 * y * (1.0 + torch.tanh(GELU_C * (y + cube)))
    if act == "gelu_exact":
        return 0.5 * y * (1.0 + torch.erf(y / math.sqrt(2.0)))
    raise ValueError(f"unknown act {act!r}")


def quantize_weights(w: torch.Tensor, gamma: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of w (K, N): (int8 (K, N),
    f32 (N,) scale), the layer scale gamma (N,) folded into the scale."""
    wf = w.float()
    ws = torch.clamp_min(wf.abs().amax(dim=0), 1e-8) / 127.0
    wq = torch.round(wf / ws).to(torch.int8)
    if gamma is not None:
        ws = ws * gamma.float()
    return wq, ws


def _quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row scale ``max(amax, 1e-8) * (1/127)`` and round(v / scale),
    as ``_mlp_core``; the rounded values stay in f32."""
    scale = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True),
                            1e-8) * (1.0 / 127.0)
    return torch.round(v / scale), scale


def _int8_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 values, rounded to f32."""
    return (q.double() @ wq.double()).float()


def _hidden(y, w0q, s0, b0, act, ln) -> torch.Tensor:
    """The f32 hidden rows act(dequant(yq @ w0q) + b0), yq the rows of y
    (after the LN prologue) quantized."""
    yf = y.float()
    if ln is not None:
        mu, rsig, ln_g, ln_b = ln
        yf = (yf - mu) * rsig * ln_g + ln_b
    yq, xs = _quantize_rows(yf)
    return apply_act(_int8_matmul(yq, w0q) * xs * s0 + b0, act)


def mlp_int8_plain(y, residual, w0q, s0, b0, w1q, s1, b1, act="gelu_tanh",
                   out_dtype=torch.bfloat16, ln=None) -> torch.Tensor:
    """``_mlp_core`` on (M, C) rows: y, residual any float dtype; w0q (C, H)
    and w1q (H, C) int8 (or their values); s0, b0 (H,), s1, b1 (C,) f32
    with the layer scale folded into s1 and b1; ``ln = (mu, rsig, ln_g,
    ln_b)``: mu, rsig (M, 1), ln_g, ln_b (C,)."""
    hq, hs = _quantize_rows(_hidden(y, w0q, s0, b0, act, ln))
    out = residual.float() + _int8_matmul(hq, w1q) * hs * s1 + b1
    return out.to(out_dtype)


def requant_flip(y, w0q, s0, b0, w1q, s1, act="gelu_tanh", ln=None) -> float:
    """How far one one-step flip of a requantized hidden value can move an
    output of ``mlp_int8_plain`` on these operands: max_row(hs) *
    max|s1 * w1q|.  The kernel and the plain version, or the JAX package's
    kernel, compute the same int8 values, but a last bit of tanh or of an
    upstream sum can flip one rounding; their tolerances count in these."""
    hs = _quantize_rows(_hidden(y, w0q, s0, b0, act, ln))[1].max()
    return (hs * (w1q.float() * s1).abs().max()).item()


def _kernel():
    if not _fn:
        from givepose_torch.ops._build import load_library

        fn = load_library(SOURCE).int8_mlp
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def mlp_int8_cuda(y, residual, w0t, s0, b0, w1t, s1, b1, act="gelu_tanh",
                  ln=None) -> torch.Tensor:
    """Launch the fused int8 MLP kernel.  y, residual (M, C) bf16 or f32
    (one dtype, which the output takes); w0t (H, C) and w1t (C, H) int8,
    the quantized weights transposed; s0, b0 (H,), s1, b1 (C,) f32; ``ln =
    (mu, rsig, ln_g, ln_b)`` with mu, rsig (M,) or (M, 1) and ln_g, ln_b
    (C,) f32.  All contiguous on one CUDA device; C and H multiples of
    64."""
    if not y.is_cuda:
        raise RuntimeError("mlp_int8_cuda needs CUDA tensors; CPU tensors "
                           "go to ops.quant_matmul.mlp_int8_plain")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if y.dim() != 2:
        raise ValueError(f"y must be (M, C), got {tuple(y.shape)}")
    m, c = y.shape
    hd = w0t.shape[0]
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"y must be bf16 or f32, got {y.dtype}")
    if c % 64 or hd % 64:
        raise ValueError(f"C={c} and H={hd} must be multiples of 64")
    if m * max(c, hd) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's 32-bit shapes")
    ln_args = (None,) * 4 if ln is None else (
        ln[0].reshape(m), ln[1].reshape(m), ln[2], ln[3])
    expect = {"residual": (residual, y.dtype, (m, c)),
              "w0t": (w0t, torch.int8, (hd, c)),
              "w1t": (w1t, torch.int8, (c, hd)),
              "s0": (s0, torch.float32, (hd,)),
              "b0": (b0, torch.float32, (hd,)),
              "s1": (s1, torch.float32, (c,)),
              "b1": (b1, torch.float32, (c,))}
    if ln is not None:
        expect.update({name: (t, torch.float32, shape) for name, t, shape in
                       zip(("mu", "rsig", "ln_g", "ln_b"), ln_args,
                           ((m,), (m,), (c,), (c,)))})
    for name, (t, dtype, shape) in {"y": (y, y.dtype, (m, c)),
                                    **expect}.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != y.device:
            raise RuntimeError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(y)
    ptr = [0 if t is None else t.data_ptr() for t in ln_args]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _kernel()(
            y.data_ptr(), residual.data_ptr(), out.data_ptr(),
            w0t.data_ptr(), s0.data_ptr(), b0.data_ptr(), w1t.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), *ptr, m, c, hd,
            int(y.dtype == torch.bfloat16), ACTS[act], int(ln is not None),
            stream)
    if err != 0:
        raise RuntimeError(f"int8_mlp launch failed: cudaError {err}")
    mlp_int8_cuda.launches += 1
    return out


mlp_int8_cuda.launches = 0


def convnext_mlp_int8(y, residual, w0, b0, w1, b1, gamma,
                      act: str = "gelu_tanh", out_dtype=torch.bfloat16,
                      ln=None, impl: str = "auto") -> torch.Tensor:
    """Fused int8 ConvNeXt MLP: residual + gamma * (act(y@w0+b0)@w1+b1).

    y, residual (..., C); w0 (C, H), w1 (H, C) f32 master weights (views
    such as ``Linear.weight.t()`` are fine), quantized per output channel
    here; b0 (H,), b1 (C,), gamma (C,).  ``ln = (mu, rsig, ln_g, ln_b)``
    makes y the raw depthwise-conv output, normalised in the prologue (mu,
    rsig per position (..., 1); ln_g, ln_b (C,)).  ``impl``: auto (kernel
    for CUDA tensors, plain version for CPU tensors), cuda, torch.  The
    kernel writes y's dtype, which must then be ``out_dtype``."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown quant impl {impl!r}")
    lead, c = y.shape[:-1], y.shape[-1]
    y2 = y.reshape(-1, c)
    r2 = residual.reshape(-1, c)
    w0q, s0 = quantize_weights(w0)
    w1q, s1 = quantize_weights(w1, gamma)
    b1g = b1.float() * gamma.float()
    b0f = b0.float()
    if ln is not None:
        mu, rsig, ln_g, ln_b = ln
        ln = (mu.reshape(-1, 1).float().contiguous(),
              rsig.reshape(-1, 1).float().contiguous(),
              ln_g.float().contiguous(), ln_b.float().contiguous())
    if impl == "torch" or (impl == "auto" and not y.is_cuda):
        out = mlp_int8_plain(y2, r2, w0q, s0, b0f, w1q, s1, b1g, act,
                             out_dtype, ln)
    else:
        if out_dtype != y.dtype:
            raise TypeError(f"the kernel writes y's dtype {y.dtype}, not "
                            f"{out_dtype}")
        out = mlp_int8_cuda(y2.contiguous(), r2.contiguous(),
                            w0q.t().contiguous(), s0.contiguous(),
                            b0f.contiguous(), w1q.t().contiguous(),
                            s1.contiguous(), b1g.contiguous(), act, ln)
    return out.reshape(*lead, c)
