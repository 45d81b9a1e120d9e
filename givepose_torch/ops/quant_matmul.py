"""W8A8 int8 matmuls: the plain PyTorch versions and the CUDA kernels.

Port of ``givepose_tpu/ops/quant_matmul_pallas.py``: ``_apply_act``,
``quantize_weights``, ``quantize_activations``, the dense matmuls
``quant_matmul_pallas`` / ``quant_dense`` (kernel ``_qmm_kernel``) and
``quant_matmul_pre_pallas`` (``_qmm_pre_kernel``), and the fused ConvNeXt
MLP ``convnext_mlp_int8`` (``_mlp_kernel``, ``_mlp_ln_kernel``).

The plain versions follow the TPU kernels, not the JAX package's CPU
fallbacks: the per-row activation scale inside a kernel is
``max(amax, 1e-8) * (1/127)`` (the fallbacks divide by 127, which can
differ by an ulp and flip a rounding).  ``quantize_activations`` and
``quantize_weights`` divide by 127, as the JAX package does outside its
kernels.  Rounding is half to even.  The int8 products are exact integer
sums (taken here in float64, which holds them exactly, then rounded to f32
as an int32 would be).

The fused MLP: ``out = residual + gamma * (act(y @ w0 + b0) @ w1 + b1)``
with an optional LayerNorm prologue on y.  The dense matmuls: ``act((x @
wq) * scales + bias)`` with x quantized per row inside the kernel (B4) or
before it (B5, whose epilogue is rounded to bf16 before the activation).

Dispatch (``convnext_mlp_int8``, ``quant_dense``, ``quant_matmul_pre``)
goes through the ``torch.ops.givepose`` operators of ``ops/library.py``: a
CPU tensor reaches the plain version, a CUDA tensor the kernel
(``csrc/int8_mlp.cu`` and ``csrc/int8_qmm.cu``) or a raise.  There is no
fallback.  Weights are quantized per output channel with plain tensor ops
on every call, as the JAX package does in-graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

SOURCE = "int8_mlp.cu"
QMM_SOURCE = "int8_qmm.cu"
ACTS = {"none": 0, "gelu_tanh": 1, "gelu_exact": 2}
IMPLS = ("auto", "cuda", "torch")
# np.sqrt(2/pi) rounded to f32, as _apply_act takes it
GELU_C = float(np.sqrt(2.0 / np.pi).astype(np.float32))
GELU_K = 0.044715
# np.sqrt(2.0) as JAX takes it: a strongly typed scalar, f32
SQRT2 = float(np.float32(np.sqrt(2.0)))
# csrc/int8_qmm.cu's tiling: K bytes of a TMA box (and of a row of a
# quantized B4 slot), the K multiple its operands take (16-byte rows),
# rows of a B4 tile, ring stages, shared memory a block may take
QMM_SLICE = 128
QMM_K_MULTIPLE = 16
QMM_B4_ROWS = 64
QMM_MAX_STAGES = 8
QMM_SMEM = 227 * 1024
_fns: dict[str, object] = {}
_sms: dict[int, int] = {}


def _div(v: torch.Tensor, d: float) -> torch.Tensor:
    """v / d in IEEE division on any device (PyTorch's CUDA division by a
    Python number multiplies by its reciprocal instead)."""
    return v / v.new_full((), d)


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """``_apply_act`` in f32, in the JAX expression's order."""
    if act == "none":
        return y
    if act == "gelu_tanh":
        cube = GELU_K * y * y * y
        return 0.5 * y * (1.0 + torch.tanh(GELU_C * (y + cube)))
    if act == "gelu_exact":
        return 0.5 * y * (1.0 + torch.erf(_div(y, SQRT2)))
    raise ValueError(f"unknown act {act!r}")


def apply_act_bf16(y: torch.Tensor, act: str) -> torch.Tensor:
    """``_apply_act`` on a bf16 y as the compiled JAX kernel computes it.
    JAX's promotion: the weakly typed Python constants give bf16 ops
    (0.044715 rounded to bf16 first), the strongly typed numpy constants
    (the f32 c, np.sqrt(2.0)) f32 ops.  So the cube's three products and
    ``0.5 * y`` are bf16, each rounded; the tanh's argument, ``y /
    sqrt(2)``, ``1 + tanh`` and the last product are f32, which is what
    this returns (y itself for ``none``).  The sum ``y + cube`` is a bf16
    op that feeds the conversion to f32 at once; XLA computes it in f32
    (its excess-precision allowance drops that rounding), and so does this
    version: op-by-op evaluation in JAX would round it."""
    if act == "none":
        return y
    half_y = (0.5 * y).float()
    if act == "gelu_tanh":
        cube = y.new_full((), GELU_K) * y * y * y
        inner = (y.float() + cube.float()) * GELU_C
        return half_y * (1.0 + torch.tanh(inner))
    if act == "gelu_exact":
        return half_y * (1.0 + torch.erf(_div(y.float(), SQRT2)))
    raise ValueError(f"unknown act {act!r}")


def quantize_weights(w: torch.Tensor, gamma: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of w (K, N): (int8 (K, N),
    f32 (N,) scale), the layer scale gamma (N,) folded into the scale."""
    wf = w.float()
    ws = _div(torch.clamp_min(wf.abs().amax(dim=0), 1e-8), 127.0)
    wq = torch.round(wf / ws).to(torch.int8)
    if gamma is not None:
        ws = ws * gamma.float()
    return wq, ws


def quantize_activations(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (..., K) -> (int8 (..., K), f32 (..., 1)),
    scale ``max(amax, 1e-8) / 127``."""
    xf = x.float()
    xs = _div(torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8),
              127.0)
    return torch.round(xf / xs).to(torch.int8), xs


def _quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row scale ``max(amax, 1e-8) * (1/127)`` and round(v / scale),
    as the TPU kernels; the rounded values stay in f32."""
    scale = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True),
                            1e-8) * (1.0 / 127.0)
    return torch.round(v / scale), scale


def _int8_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 values, rounded to f32."""
    return (q.double() @ wq.double()).float()


def _epilogue(acc, xs, ws, bias) -> torch.Tensor:
    """(acc * xs) * ws + b in f32; a missing bias adds zeros, as the TPU
    wrappers pad it."""
    b = torch.zeros_like(ws) if bias is None else bias.float()
    return acc * xs * ws.float() + b


def quant_matmul_plain(x, wq, ws, bias=None, act: str = "none",
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """``_qmm_kernel`` (B4) on (M, K) rows x of any float dtype: wq (K, N)
    int8 (or its values), ws (N,) f32, bias (N,) or None; per-row dynamic
    quantization of x, the f32 epilogue and ``act`` in f32."""
    xq, xs = _quantize_rows(x.float())
    return apply_act(_epilogue(_int8_matmul(xq, wq), xs, ws, bias),
                     act).to(out_dtype)


def quant_matmul_pre_plain(xq, xs, wq, ws, bias=None, act: str = "none",
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``_qmm_pre_kernel`` (B5): xq (M, K) int8 and its scales xs (M,) or
    (M, 1) f32; the f32 epilogue rounded to bf16, then ``act`` in JAX's
    mixed bf16/f32 order (``apply_act_bf16``)."""
    y = _epilogue(_int8_matmul(xq, wq), xs.reshape(-1, 1).float(), ws,
                  bias)
    return apply_act_bf16(y.to(torch.bfloat16), act).to(out_dtype)


def qmm_flip(x, wq, ws) -> float:
    """How far a one-step flip of one quantized x value can move an output
    of ``quant_matmul_plain`` (before the activation, whose slope is at
    most 1.13): max_row(xs) * max|wq * ws|."""
    xs = _quantize_rows(x.float())[1].max()
    return (xs * (wq.float() * ws.float()).abs().max()).item()


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


def _kernel(source: str, name: str, argtypes: list):
    if name not in _fns:
        from givepose_torch.ops._build import load_library

        fn = getattr(load_library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(tensors: dict, device) -> None:
    """Each of {name: (tensor, dtype or tuple of dtypes, shape)} has that
    dtype and shape, lies on ``device`` and is contiguous; raise if not."""
    for name, (t, dtype, shape) in tensors.items():
        dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}"
                            f", got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != device:
            raise RuntimeError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    expect = {"y": (y, y.dtype, (m, c)),
              "residual": (residual, y.dtype, (m, c)),
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
    _check(expect, y.device)
    # the kernel reads s0 and b0 in pairs (8-byte loads), and w0t and w1t
    # through TMA tensor maps, whose base address must be 16-byte aligned
    s0, b0 = (t if t.data_ptr() % 8 == 0 else t.clone() for t in (s0, b0))
    w0t, w1t = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (w0t, w1t))
    out = torch.empty_like(y)
    ptr = [0 if t is None else t.data_ptr() for t in ln_args]
    fn = _kernel(SOURCE, "int8_mlp", [ctypes.c_void_p] * 13
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), residual.data_ptr(), out.data_ptr(),
                 w0t.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                 w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(), *ptr, m, c,
                 hd, int(y.dtype == torch.bfloat16), ACTS[act],
                 int(ln is not None), stream)
    if err != 0:
        raise RuntimeError(f"int8_mlp launch failed: cudaError {err}")
    mlp_int8_cuda.launches += 1
    return out


mlp_int8_cuda.launches = 0


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How ``csrc/int8_qmm.cu`` cuts an (M, N) output: tiles of ``bm``
    rows and ``bn`` columns; a unit is ``group`` consecutive column tiles
    of one row tile, ``gpr`` units a row tile; ``blocks`` persistent
    blocks, block b taking units b, b + blocks, ...; ``stages`` ring
    stages; B4's ``a_slots`` quantized K slices of its rows (every slice:
    resident, quantized once per unit)."""

    bm: int
    bn: int
    group: int
    gpr: int
    stages: int
    a_slots: int
    blocks: int

    def units(self, m: int) -> int:
        return -(-m // self.bm) * self.gpr

    def tiles(self, m: int, n: int, block: int) -> list[tuple[int, int]]:
        """(row tile, column tile) of every output tile ``block`` computes,
        in the kernel's order."""
        ctiles = -(-n // self.bn)
        out = []
        for u in range(block, self.units(m), self.blocks):
            c0 = u % self.gpr * self.group
            out += [(u // self.gpr, ct)
                    for ct in range(c0, min(c0 + self.group, ctiles))]
        return out


def _stage_bytes(plan: QmmPlan, pre: bool) -> int:
    """A ring stage: B5's xq slice and the wt slice, 128 bytes a row."""
    return ((plan.bm if pre else 0) + plan.bn) * QMM_SLICE


def qmm_smem(plan: QmmPlan, pre: bool) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source): the
    ring, B4's slots, the row scales, the barriers, 1 KB of alignment."""
    return (plan.stages * _stage_bytes(plan, pre)
            + plan.a_slots * QMM_B4_ROWS * QMM_SLICE + 4 * plan.bm
            + 16 * QMM_MAX_STAGES + 1024)


@functools.lru_cache(maxsize=256)
def qmm_plan(m: int, n: int, k: int, pre: bool, sms: int) -> QmmPlan:
    """The tiling of B5 (``pre``) or B4 on an (M, K) x (K, N) product (K
    a multiple of 16) for a card of ``sms`` SMs.  B5: 128 x 128 tiles, one
    a unit.  B4: 64 x 256 tiles; a row tile's column tiles split into as
    few groups (units) as fill the card, since each unit quantizes its
    rows again; every K slice resident when they fit beside a ring of 3
    stages and a unit has more than one column tile, else a ring of 4
    slots.  Stages: as many as fit (at most 8)."""
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    nk = ceil(k, QMM_SLICE)
    if pre:
        bm, bn = 128, 128
        group, gpr, a_slots = 1, ceil(n, bn), 0
    else:
        bm, bn = QMM_B4_ROWS, 256
        ctiles = ceil(n, bn)
        group = ceil(ctiles, min(ctiles, max(1, sms // ceil(m, bm))))
        gpr = ceil(ctiles, group)
        a_slots = min(nk, 4)
        whole = QmmPlan(bm, bn, group, gpr, 3, nk, 1)
        if group > 1 and qmm_smem(whole, pre) <= QMM_SMEM:
            a_slots = nk
    plan = QmmPlan(bm, bn, group, gpr, 0, a_slots, 1)
    stages = min(QMM_MAX_STAGES, (QMM_SMEM - qmm_smem(plan, pre))
                 // _stage_bytes(plan, pre))
    return dataclasses.replace(plan, stages=stages,
                               blocks=max(1, min(plan.units(m), sms)))


def _padded_k(k: int) -> int:
    return -(-k // QMM_K_MULTIPLE) * QMM_K_MULTIPLE


def qmm_pad(t: torch.Tensor) -> torch.Tensor:
    """An (R, K) operand of B4 or B5 as the kernels read it: K a multiple
    of 16 and the base 16-byte aligned (TMA's rules for xq and wt, and
    B4's 16-byte loads of x).  Otherwise a copy padded with zeros along K,
    which adds nothing to an int32 sum and leaves a row's amax as it
    was."""
    rows, k = t.shape
    kp = _padded_k(k)
    if kp == k and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(rows, kp)
    out[:, :k] = t
    return out


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def _qmm_argtypes(pre: bool) -> list:
    head = ([ctypes.c_void_p] * 6 if pre
            else [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    return head + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def bind_qmm(fn, pre: bool):
    """Set the ctypes signature of ``int8_qmm_pre`` (``pre``) or
    ``int8_qmm`` on ``fn`` (an entry point of some build of
    ``csrc/int8_qmm.cu``) and return it."""
    fn.argtypes = _qmm_argtypes(pre)
    fn.restype = ctypes.c_int
    return fn


def qmm_call_args(x, xs, wt, ws, bias, out, act: str, pre: bool) -> tuple:
    """The arguments of a call of B5 (``pre``: x is xq, xs its row scales)
    or B4 on operands that meet ``qmm_pad`` already, with the plan of
    ``qmm_plan`` for x's card, on its current stream."""
    m, k = x.shape
    n = wt.shape[0]
    plan = qmm_plan(m, n, k, pre, _sm_count(x.device))
    head = ((x.data_ptr(), xs.data_ptr()) if pre
            else (x.data_ptr(), int(x.dtype == torch.bfloat16)))
    return head + (
        wt.data_ptr(), ws.data_ptr(), None if bias is None else
        bias.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
        m, n, k, ACTS[act], plan.bn, plan.group, plan.gpr, plan.stages,
        plan.a_slots, plan.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)


def _qmm_launch(name: str, pre: bool, x, xs, wt, ws, bias, out, act):
    fn = _kernel(QMM_SOURCE, name, _qmm_argtypes(pre))
    with torch.cuda.device(x.device):
        err = fn(*qmm_call_args(x, xs, wt, ws, bias, out, act, pre))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _qmm_args(x, wt, ws, bias, act, out_dtype, caller):
    """Raise unless the B4/B5 operands fit the kernels: x (M, K), wt (N, K)
    int8, ws (N,) f32, bias (N,) f32 or None, contiguous on x's CUDA
    device; returns (m, n, k)."""
    if not x.is_cuda:
        raise RuntimeError(f"{caller} needs CUDA tensors; CPU tensors go to "
                           "the plain version")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if x.dim() != 2 or wt.dim() != 2:
        raise ValueError(f"x and wt must be 2-d, got {tuple(x.shape)} and "
                         f"{tuple(wt.shape)}")
    (m, k), n = x.shape, wt.shape[0]
    if n == 0 or k == 0:
        raise ValueError(f"N={n} and K={k} must be positive")
    if max(m, n) * _padded_k(k) >= 2 ** 31 or m * n >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's 32-bit shapes")
    expect = {"wt": (wt, torch.int8, (n, k)),
              "ws": (ws, torch.float32, (n,))}
    if bias is not None:
        expect["bias"] = (bias, torch.float32, (n,))
    _check(expect, x.device)
    return m, n, k


def qmm_cuda(x, wt, ws, bias=None, act: str = "none",
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch B4 (``int8_qmm``): x (M, K) bf16 or f32, quantized per row in
    the kernel; wt (N, K) int8, the quantized weights transposed; ws (N,)
    f32; bias (N,) f32 or None; all contiguous on one CUDA device.
    Returns (M, N) in ``out_dtype`` (bf16 or f32)."""
    m, n, _ = _qmm_args(x, wt, ws, bias, act, out_dtype, "qmm_cuda")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _qmm_launch("int8_qmm", False, qmm_pad(x), None, qmm_pad(wt), ws, bias,
                out, act)
    qmm_cuda.launches += 1
    return out


qmm_cuda.launches = 0


def qmm_pre_cuda(xq, xs, wt, ws, bias=None, act: str = "none",
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch B5 (``int8_qmm_pre``): xq (M, K) int8 and xs (M,) f32, the
    activations quantized before the call; the other operands as
    ``qmm_cuda``."""
    m, n, k = _qmm_args(xq, wt, ws, bias, act, out_dtype, "qmm_pre_cuda")
    _check({"xq": (xq, torch.int8, (m, k)),
            "xs": (xs, torch.float32, (m,))}, xq.device)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    _qmm_launch("int8_qmm_pre", True, qmm_pad(xq), xs, qmm_pad(wt), ws,
                bias, out, act)
    qmm_pre_cuda.launches += 1
    return out


qmm_pre_cuda.launches = 0


def _route(impl: str, x: torch.Tensor, caller: str) -> bool:
    """Whether ``impl`` sends x to the plain version directly (``torch``);
    otherwise it goes through the operator, which picks by device.  Raises
    on an unknown impl and on ``cuda`` for a tensor off the GPU."""
    if impl not in IMPLS:
        raise ValueError(f"unknown quant impl {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise RuntimeError(f"{caller}(impl='cuda') needs CUDA tensors")
    return impl == "torch"


def quant_dense(x, w, bias=None, act: str = "none", gamma=None,
                out_dtype=torch.bfloat16, impl: str = "auto"
                ) -> torch.Tensor:
    """W8A8 dense: (..., K) x (K, N) with per-row dynamic quantization of
    x inside the kernel (B4), optional bias and activation.  w (K, N) f32
    master weights, quantized per output channel here (``gamma`` (N,)
    folded into the scale).  ``impl``: auto (kernel for CUDA tensors, plain
    version for CPU tensors), cuda, torch."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    x2 = x.reshape(-1, k)
    wq, ws = quantize_weights(w, gamma)
    b = None if bias is None else bias.float()
    if _route(impl, x, "quant_dense"):
        y = quant_matmul_plain(x2, wq, ws, b, act, out_dtype)
    else:
        y = torch.ops.givepose.int8_qmm(
            x2.contiguous(), wq.t().contiguous(), ws.contiguous(),
            None if b is None else b.contiguous(), act, out_dtype)
    return y.reshape(*lead, n)


def quant_matmul_pre(xq, xs, wq, ws, bias=None, act: str = "none",
                     out_dtype=torch.bfloat16, impl: str = "auto"
                     ) -> torch.Tensor:
    """W8A8 matmul on pre-quantized activations (B5): xq (..., K) int8 and
    xs (..., 1) f32 (``quantize_activations``), wq (K, N) int8 and ws (N,)
    f32 (``quantize_weights``), bias (N,) or None.  The epilogue is
    rounded to bf16 before ``act``.  ``impl`` as ``quant_dense``."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    lead, k, n = xq.shape[:-1], xq.shape[-1], wq.shape[-1]
    xq2, xs2 = xq.reshape(-1, k), xs.reshape(-1).float()
    b = None if bias is None else bias.float()
    if _route(impl, xq, "quant_matmul_pre"):
        y = quant_matmul_pre_plain(xq2, xs2, wq, ws, b, act, out_dtype)
    else:
        y = torch.ops.givepose.int8_qmm_pre(
            xq2.contiguous(), xs2.contiguous(), wq.t().contiguous(),
            ws.float().contiguous(), None if b is None else b.contiguous(),
            act, out_dtype)
    return y.reshape(*lead, n)


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
    if _route(impl, y, "convnext_mlp_int8"):
        out = mlp_int8_plain(y2, r2, w0q, s0, b0f, w1q, s1, b1g, act,
                             out_dtype, ln)
    else:
        if y.is_cuda and out_dtype != y.dtype:
            raise TypeError(f"the kernel writes y's dtype {y.dtype}, not "
                            f"{out_dtype}")
        out = torch.ops.givepose.int8_mlp(
            y2.contiguous(), r2.contiguous(), w0q.t().contiguous(),
            s0.contiguous(), b0f.contiguous(), w1q.t().contiguous(),
            s1.contiguous(), b1g.contiguous(), act, out_dtype,
            *((None,) * 4 if ln is None else ln))
    return out.reshape(*lead, c)

