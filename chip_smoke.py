#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``givepose_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of ``givepose_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all started together;
3. hold each kernel against its plain PyTorch version on the card:
   - the DCNv3 forward and backward: the three MAPEncoder shapes at batch
     8, edge cases (stride 1, dilation 2, 16, 96, 24, 12, 5 and 2 channels
     per group, large offsets, offsets of 20 px on an output whose tiles
     are ragged, an odd output size) and, for the backward, zero offsets,
     with x in bf16 and in f32;
   - the windowed DCNv3 forward and the backward with the window (4 unless
     said): the MAPEncoder shapes, offsets that the clamp mostly holds,
     offsets exactly on the window's bound, a ragged last row tile,
     column tiles, and for the backward the tie case (window 1, zero
     offsets, where d_offset is half the unclamped one);
   - the fused int8 ConvNeXt MLP at the stage-2 and stage-3 shapes of
     batch 32, with and without its LayerNorm prologue, in bf16 and f32,
     and at the edges of its tiling: M 37 short of a multiple of its 64-row
     tile, M below one tile, C 64, 256-column blocks (C 768) and a half
     last hidden chunk (H 320);
   - the W8A8 dense matmuls (``int8_qmm``, x quantized in the kernel, and
     ``int8_qmm_pre``, x quantized before) at the four ConvNeXt-B MLP
     matmul shapes of batch 32 and at ragged shapes, x and out in bf16 and
     in f32, for each activation; and ``QuantDense`` loaded from a bf16
     ``nn.Linear``'s state dict;
4. serve batch-32 requests through full-width ConvNeXt-B PoseNet (bf16,
   seeded random weights, DCNv3 offset and mask projections perturbed so
   that samples land off the grid), first under the default ModelConfig,
   then under the fast configuration (``dcn_window=4``,
   ``quant_dense=True``, O(1) layer scales); check the outputs and each
   kernel's launches per request; serve one request again on the plain
   versions and compare, in bf16 and in an f32 copy of the model; print
   the int8 model's departure from the same weights served in bf16;
   after each configuration, export it as a serving artifact
   (``export_posenet``, weights as call arguments), save and load it, and
   serve the same 3 requests through it: the eager outputs, the eager
   launches per request, an artifact under 5 MB;
5. run the W8A8 dense path (``QuantDense`` layers, and
   ``quantize_activations`` into ``quant_matmul_pre``) over the stage-2
   and stage-3 MLPs of 3 batch-32 requests, counting both kernels;
6. train, first under the default Config (Ranger, lr 1e-3, clip 5, batch
   48), then with ``dcn_window=4``: 5 steps on a seeded batch (256²
   crops, 64² maps and masks, 1024 model points, random rotations, half
   of them symmetric); the loss stays finite, parameters and BatchNorm
   statistics move, nothing is skipped, and each step launches each of
   its DCNv3 kernels three times; then a step whose translation target
   holds a NaN must leave the parameters untouched and count one skip;
   then, from the seeded weights before the first step, one step's
   losses and gradients with the kernels against the plain DCNv3
   version, in an f32 copy at batch 8 (and the backward kernel on that
   step's own tensors against the plain backward) and in bf16;
7. time each kernel per layer, block or matmul at the path's shapes
   (kernel, plain version, bound; for the int8 MLP also the bound of the
   operations its two-pass design executes, TOP/s, the bf16 block MLP it
   replaces, the ratio of the two per forward and the earlier mma.sync
   design's time; for the dense matmuls the bf16 ``F.linear`` and
   ``torch._int_mm`` on the same operands), the PoseNet forward of both
   configurations, eager and from its artifact, and the train step of both
   with CUDA events, break the forwards' and the default
   train step's device time down by op with torch.profiler, and the
   default train step's wall and device time down by part (forward,
   gradients, optimizer).

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 32
REQUESTS = 3
CHECK_BATCH = 8
TRAIN_BATCH = 48           # TrainConfig.batch_size
TRAIN_STEPS = 5            # checked steps of the train phase
TIMED_STEPS = 10
# kernel vs plain version on the same (dtype-rounded) inputs: both sum in
# f32, only the order differs
KERNEL_BAR = 1e-4          # max abs err <= KERNEL_BAR * max|ref|
# bf16 x against the plain version on the unrounded f32 x (bench.py:83)
BF16_BAR = 3e-2            # max abs err / max|ref|
# PoseNet with the kernel vs with the plain DCNv3, f32 model: the repo's
# PoseNet parity bars (ROADMAP.md), relative to max|plain| except rot
PARITY_BARS = {"nocs_coor": 1e-4, "ivfc_coor": 1e-4, "size": 1e-4,
               "trans": 1e-4, "rot": 1e-3}
ORTHO_BAR = 1e-3           # max |R^T R - I|

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FLOP_PER_TAP_CHANNEL = 10  # 4 corner FMAs + 1 mask FMA
# backward: 4 corner-dot FMAs, 4 scatter products, 4 atomic adds
BWD_FLOP_PER_TAP_CHANNEL = 16
# kernel path vs plain DCNv3 path in one train step (compare_train_paths):
# relative L2 of all f32 gradients, and the bf16 losses' gap as a multiple
# of the plain bf16 losses' gap to f32
PATH_L2_BAR = 1e-3
BF16_LOSS_RATIO = 2.0

# the JAX package's fast serving configuration (README: the DCNv3
# encoder's windowed kernel and the int8 ConvNeXt MLP)
WINDOW = 4
# offset projection noise of the windowed models: offsets of ~2 px, so
# that the clamp holds some of the samples (std 0.05 gives ~0.5 px: none)
WINDOW_OFFSET_STD = 0.2
# int8 MLP kernel vs its plain version: both compute the same int8 values,
# but a last bit (tanhf, an upstream order) can flip a requantized value by
# one step: max err within MLP_FLIPS such flips plus 2 ulp of the output
# dtype, mean err within MLP_MEAN_BAR * mean|ref| (mlp_bars)
MLP_FLIPS = 3
MLP_MEAN_BAR = 1e-3
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core peak
# ConvNeXt-B blocks on the int8 MLP at batch 32 (256^2 crops): (name,
# blocks, rows M, width C); H = 4 C
MLP_STAGES = [("stage2", 27, BATCH * 16 * 16, 512),
              ("stage3", 3, BATCH * 8 * 8, 1024)]
# edges of the kernel's tiling (64-row tiles, 128-column hidden chunks, NB
# output columns per block): (name, M, C, H)
MLP_EDGE_CASES = [("ragged_tile", BATCH * 16 * 16 - 37, 512, 2048),
                  ("below_tile", 40, 512, 2048),
                  ("c64", 200, 64, 256),
                  ("nb256", 130, 768, 3072),
                  ("half_chunk", 70, 192, 320)]
# the fused int8 MLP per fast forward in its earlier mma.sync design
# (weights streamed from L2 into every 16- or 8-row block), as PERF.md
# records it on the H100
MLP_MMA_SYNC_MS = 8.272

# W8A8 dense matmuls (B4, B5) at the ConvNeXt-B MLP shapes of batch 32:
# (name, M, K, N, the layer's activation)
QMM_SHAPES = [("stage2_fc1", BATCH * 16 * 16, 512, 2048, "gelu_tanh"),
              ("stage2_fc2", BATCH * 16 * 16, 2048, 512, "none"),
              ("stage3_fc1", BATCH * 8 * 8, 1024, 4096, "gelu_tanh"),
              ("stage3_fc2", BATCH * 8 * 8, 4096, 1024, "none")]
# ragged (M, K, N): K with 16-byte rows, a multiple of 8 only, of 4 only,
# odd; the JAX package's test shape
QMM_RAGGED = [("ragged", 77, 96, 48, "gelu_tanh"),
              ("k520", 200, 520, 130, "gelu_tanh"),
              ("k100", 33, 100, 250, "gelu_tanh"),
              ("odd", 5, 37, 19, "gelu_tanh"),
              ("tpu_test", 48, 192, 160, "gelu_tanh")]
QMM_ACTS = ("none", "gelu_tanh", "gelu_exact")
# dense kernel vs plain version: max err within QMM_FLIPS one-step flips of
# a quantized x value (B4 only; times GELU's largest slope 1.13) plus 2 ulp
# of the output dtype at max|ref|, mean within MLP_MEAN_BAR * mean|ref|
QMM_FLIPS = 3
# serving artifact: the graph only, the weights as call arguments
ARTIFACT_MAX_BYTES = 5 * 2 ** 20
WEIGHTS_MIN_BYTES = 350e6        # f32 bytes of ConvNeXt-B PoseNet's weights

# DCNv3 layers of the MAPEncoder: (name, input side), k3 s2 p1, 4 x 64 ch
MAIN_LAYERS = [("layer0", 64), ("layer1", 32), ("layer2", 16)]
# (name, n, h, w, group, gc, stride, pad, dilation, offset multiplier)
EDGE_CASES = [
    ("stride1", 2, 20, 20, 4, 64, 1, 1, 1, 2.0),
    ("dilation2", 2, 17, 19, 4, 64, 2, 2, 2, 2.0),
    ("gc16", 2, 24, 24, 4, 16, 2, 1, 1, 2.0),
    ("offsets_x4", 2, 16, 16, 4, 64, 2, 1, 1, 8.0),
    ("odd_output", 2, 15, 13, 4, 64, 2, 1, 1, 2.0),
    ("gc96", 2, 12, 12, 4, 96, 2, 1, 1, 2.0),
    ("gc5", 2, 9, 10, 4, 5, 1, 1, 1, 2.0),
    # offsets N(0, 20 px), most samples far outside a block's tile or the
    # image, on an 11 x 13 output (tiles ragged at the last row and column)
    ("far_x20", 2, 22, 26, 4, 64, 2, 1, 1, 20.0),
    # narrow vectors: 24 and 12 channels per group (4 a lane, several lane
    # segments a group in the forward), 2 channels per group
    ("gc24", 2, 10, 12, 4, 24, 2, 1, 1, 2.0),
    ("gc12_s1", 2, 8, 9, 4, 12, 1, 1, 1, 3.0),
    ("gc2", 2, 9, 9, 4, 2, 2, 1, 1, 2.0),
]
# windowed kernels: (name, n, h, w, group, gc, stride, pad, dilation,
# offset multiplier, window, offsets exactly on the window's bound)
WIN_EDGE_CASES = [
    ("clamped_x4", 2, 16, 16, 4, 64, 2, 1, 1, 8.0, 4, False),
    ("on_bound", 2, 16, 16, 4, 64, 2, 1, 1, 0.0, 4, True),
    # 11 x 11 outputs: tiles of 3 rows (bf16) or 7 columns (f32) leave a
    # ragged last one
    ("ragged_tile", 2, 22, 22, 4, 64, 2, 1, 1, 2.0, 4, False),
    ("stride1_w3", 2, 20, 20, 4, 64, 1, 1, 1, 2.0, 3, False),
    ("dilation2", 2, 17, 19, 4, 64, 2, 2, 2, 2.0, 4, False),
    # a 48-wide output row's slab exceeds the tile budget: column tiles
    ("column_tiles", 2, 20, 96, 4, 64, 2, 1, 1, 4.0, 4, False),
    ("gc96", 2, 12, 12, 4, 96, 2, 1, 1, 2.0, 4, False),
    ("gc5", 2, 9, 10, 4, 5, 1, 1, 1, 2.0, 2, False),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def out_side(side: int, stride: int, pad: int, dilation: int) -> int:
    return (side + 2 * pad - (2 * dilation + 1)) // stride + 1


def dcnv3_inputs(gen, n, h, w, group, gc, stride, pad, dilation, mult):
    """f32 x, offsets (N(0,1) * mult px) and a softmaxed mask on the card."""
    import torch

    ho, wo = out_side(h, stride, pad, dilation), out_side(w, stride, pad,
                                                          dilation)
    dev = gen.device
    x = torch.randn(n, h, w, group * gc, generator=gen, device=dev)
    off = torch.randn(n, ho, wo, group * 18, generator=gen, device=dev) * mult
    m = torch.softmax(torch.randn(n, ho, wo, group, 9, generator=gen,
                                  device=dev), dim=-1)
    return x, off, m.reshape(n, ho, wo, group * 9)


def check_kernel(gen) -> float:
    """Phase 3; returns the largest max abs error over all cases."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core
    from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda

    cases = [(name, CHECK_BATCH, s, s, 4, 64, 2, 1, 1, 2.0)
             for name, s in MAIN_LAYERS] + EDGE_CASES
    worst = 0.0
    for name, n, h, w, group, gc, stride, pad, dil, mult in cases:
        x, off, m = dcnv3_inputs(gen, n, h, w, group, gc, stride, pad, dil,
                                 mult)
        kw = dict(stride=stride, pad=pad, dilation=dil, group=group)
        ref32 = dcnv3_core(x, off, m, **kw)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            out = dcnv3_cuda(xd, off, m, **kw)
            ref = dcnv3_core(xd.float(), off, m, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            rel32 = (out - ref32).abs().max().item() / ref32.abs().max().item()
            ok = err <= KERNEL_BAR * scale and rel32 < BF16_BAR
            worst = max(worst, err)
            log(f"  dcnv3_fwd {name:<11} x{tuple(x.shape)} "
                f"{str(dtype).split('.')[1]:<8} max_abs_err {err:.3e} "
                f"(bar {KERNEL_BAR * scale:.3e}) rel_err_vs_f32 {rel32:.3e} "
                f"(bar {BF16_BAR}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"dcnv3_fwd disagrees with dcnv3_core on {name} "
                     f"{dtype}")
    return worst


def check_bwd_kernel(gen) -> float:
    """Phase 3, backward: d_x, d_offset and d_mask of the kernel against
    autograd of the plain version, each within KERNEL_BAR * max|ref|;
    returns the largest max abs error over all cases and outputs."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd
    from givepose_torch.ops.dcnv3_cuda import dcnv3_bwd_cuda

    cases = ([(name, CHECK_BATCH, s, s, 4, 64, 2, 1, 1, 2.0)
              for name, s in MAIN_LAYERS] + EDGE_CASES
             + [("zero_offsets", CHECK_BATCH, 64, 64, 4, 64, 2, 1, 1, 0.0),
                ("zero_off_s1", 2, 20, 20, 4, 64, 1, 1, 1, 0.0)])
    worst = 0.0
    for name, n, h, w, group, gc, stride, pad, dil, mult in cases:
        x, off, m = dcnv3_inputs(gen, n, h, w, group, gc, stride, pad, dil,
                                 mult)
        g = torch.randn(n, out_side(h, stride, pad, dil),
                        out_side(w, stride, pad, dil), group * gc,
                        generator=gen, device=gen.device)
        kw = dict(stride=stride, pad=pad, dilation=dil, group=group)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            got = dcnv3_bwd_cuda(xd, off, m, g, **kw)
            want = dcnv3_core_bwd(xd, off, m, g, **kw)
            torch.cuda.synchronize()
            errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
            bars = [KERNEL_BAR * b.abs().max().item() for b in want]
            ok = all(e <= bar for e, bar in zip(errs, bars))
            worst = max(worst, *errs)
            log(f"  dcnv3_bwd {name:<12} x{tuple(x.shape)} "
                f"{str(dtype).split('.')[1]:<8} max_abs_err d_x {errs[0]:.3e} "
                f"(bar {bars[0]:.3e}) d_offset {errs[1]:.3e} "
                f"(bar {bars[1]:.3e}) d_mask {errs[2]:.3e} "
                f"(bar {bars[2]:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"dcnv3_bwd disagrees with dcnv3_core_bwd on {name} "
                     f"{dtype}")
    return worst


def set_impl(model, impl: str) -> None:
    """Every DCNv3 layer and every int8 ConvNeXt block of ``model`` on
    ``impl`` (auto: the kernels; torch: the plain versions)."""
    from givepose_torch.models.convnext import ConvNeXtBlock
    from givepose_torch.models.dcnv3_module import DCNv3

    for m in model.modules():
        if isinstance(m, (DCNv3, ConvNeXtBlock)):
            m.impl = impl


def kernel_wrappers() -> dict:
    """The wrapper of each kernel by name; each counts its launches."""
    from givepose_torch.ops.dcnv3_cuda import (dcnv3_bwd_cuda, dcnv3_cuda,
                                               dcnv3_win_cuda)
    from givepose_torch.ops.quant_matmul import (mlp_int8_cuda, qmm_cuda,
                                                 qmm_pre_cuda)

    return {"dcnv3_fwd": dcnv3_cuda, "dcnv3_win_fwd": dcnv3_win_cuda,
            "dcnv3_bwd": dcnv3_bwd_cuda, "int8_mlp": mlp_int8_cuda,
            "int8_qmm": qmm_cuda, "int8_qmm_pre": qmm_pre_cuda}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def check_counts(counts: dict, expect: dict, what: str) -> None:
    """Each kernel launched exactly ``expect`` times (0 if not named)."""
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        fail(f"{what}: kernel launches {counts}, expected {want}")


def perturb_dcn(model, seed: int, offset_std: float = 0.05) -> None:
    """Seeded noise on the zero-initialised offset (std ``offset_std``)
    and mask (std 0.5) projections, so that samples land off the regular
    grid."""
    import torch

    from givepose_torch.models.dcnv3_module import DCNv3

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCNv3):
                for lin, std in ((m.offset, offset_std), (m.mask, 0.5)):
                    w = torch.randn(lin.weight.shape, generator=gen) * std
                    lin.weight.copy_(w)


def check_outputs(out: dict, b: int) -> None:
    import torch

    shapes = {"rot": (b, 3, 3), "trans": (b, 3), "size": (b, 3),
              "nocs_coor": (b, 64, 64, 3), "ivfc_coor": (b, 64, 64, 3),
              "rot_raw": (b, 6), "t_raw": (b, 3)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not torch.isfinite(out[k]).all():
            fail(f"{k} is not finite")
    r = out["rot"]
    ortho = (r.transpose(1, 2) @ r - torch.eye(3, device=r.device)).abs()
    if ortho.max().item() > ORTHO_BAR:
        fail(f"R^T R - I reaches {ortho.max().item():.3e}")


def serve(model, batches, per_request: dict) -> tuple[list, dict]:
    """Phase 4: a serving main path.  Returns the outputs and each
    kernel's launches during it, which must be ``per_request`` times the
    requests."""
    import torch

    reset_counts()
    with torch.inference_mode():
        outs = [model(b) for b in batches]
    torch.cuda.synchronize()
    counts = read_counts()
    for out in outs:
        check_outputs(out, BATCH)
    check_counts(counts, {k: v * len(batches) for k, v in
                          per_request.items()},
                 f"{len(batches)} requests")
    return outs, counts


def run_plain(model, batch) -> dict:
    """Serve one request with the DCNv3 layers and the int8 MLPs on the
    plain versions."""
    import torch

    before = read_counts()
    set_impl(model, "torch")
    try:
        with torch.inference_mode():
            plain = model(batch)
        torch.cuda.synchronize()
    finally:
        set_impl(model, "auto")
    if read_counts() != before:
        fail("impl='torch' launched a kernel")
    return plain


def max_diff(a, b) -> float:
    return (a - b).abs().max().item()


def compare_paths(model, batch, out, cfg=None) -> dict:
    """The kernel path against the plain path (DCNv3 and, with
    ``quant_dense``, the int8 MLP), on the card, for the model of ``cfg``
    (default ``ModelConfig()``); returns the f32 copy's outputs.

    In f32 (the same weights in a float32 model, TF32 off) the two differ
    by summation order only and are held to the repo's PoseNet parity bars
    (maps, size, trans 1e-4, rotation 1e-3; relative to max|plain| except
    the rotation).  In bf16 a summation-order difference flips roundings
    downstream; there the bar is what bf16 allows, measured here: on
    average over the batch, the kernel path may differ from the plain bf16
    path by no more than the plain bf16 path differs from the f32 model.
    (Means, because the maximum over 32 crops of either is noisy.)"""
    import torch

    from givepose_torch.core.config import ModelConfig
    from givepose_torch.eval.serving import build_posenet

    plain = run_plain(model, batch)
    cfg32 = dataclasses.replace(cfg or ModelConfig(), compute_dtype="float32")
    m32 = build_posenet(cfg32, backbone_variant="base",
                        state_dict=model.state_dict())
    with torch.inference_mode():
        out32 = m32(batch)
    plain32 = run_plain(m32, batch)
    del m32
    for k in PARITY_BARS:
        bar32 = PARITY_BARS[k] * (1.0 if k == "rot"
                                  else plain32[k].abs().max().item())
        d32 = max_diff(out32[k], plain32[k])
        d16 = (out[k] - plain[k]).abs()
        e16 = (plain[k] - plain32[k]).abs()
        ok = d32 <= bar32 and d16.mean().item() <= e16.mean().item()
        log(f"  kernel vs plain path: {k:<9} f32 max {d32:.3e} "
            f"(bar {bar32:.3e}); bf16 mean {d16.mean().item():.3e} "
            f"(bar = bf16 vs f32 mean {e16.mean().item():.3e}), bf16 max "
            f"{d16.max().item():.3e} (bf16 vs f32 max "
            f"{e16.max().item():.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"PoseNet {k} differs between the kernel and plain paths")
    return out32


def train_batch(b: int, seed: int) -> dict:
    """A seeded training batch on the card: the serving fields
    (``example_serving_batch``: 256² crops, 64² 2-D coordinates) plus the
    targets, with uniformly random rotations, half of the samples
    symmetric about y, 64² maps and masks and 1024 model points."""
    import torch

    from givepose_torch.eval.serving import example_serving_batch

    batch = example_serving_batch(b, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device="cuda")

    w, x, y, z = torch.nn.functional.normalize(
        torch.randn(b, 4, generator=gen, device="cuda"), dim=1).unbind(1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(b, 3, 3)
    sym = torch.tensor([[1.0, 1, 0, 1]] * (b // 2)
                       + [[0.0, 1, 0, 0]] * (b - b // 2), device="cuda")
    res = 64
    batch.update({
        "rotation": rot,
        "translation": torch.randn(b, 3, generator=gen, device="cuda") * 0.2
        + torch.tensor([0.0, 0.0, 1.0], device="cuda"),
        "real_size": uniform(0.05, 0.3, b, 3),
        "nocs_scale": uniform(0.1, 0.4, b),
        "sym_info": sym,
        "nocs_coord": uniform(-0.5, 0.5, b, res, res, 3),
        "ivfc_coord": uniform(-0.5, 0.5, b, res, res, 3),
        "roi_mask_output": (uniform(0, 1, b, res, res, 1) > 0.4).float(),
        "roi_ivfc_mask_output": (uniform(0, 1, b, res, res, 1)
                                 > 0.4).float(),
        "model_point": uniform(-0.5, 0.5, b, 1024, 3),
    })
    return batch


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def moved(before: dict, model, running: bool) -> bool:
    """Whether any parameter (running=False) or BatchNorm running
    statistic (running=True) differs from ``before``."""
    import torch

    return any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items()
               if ("running_" in k) == running)


def train(state, step, batch, per_step: dict) -> tuple[list, dict]:
    """Phase 6: a training main path, TRAIN_STEPS steps at batch 48.
    Returns the total losses and each kernel's launches, which must be
    ``per_step`` times the steps."""
    import torch

    before = snapshot(state.model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    reset_counts()
    metrics = [step(state, batch, gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [m["total_loss"].item() for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        fail(f"train loss is not finite: {losses}")
    if metrics[-1]["notfinite_total"] != 0:
        fail(f"{metrics[-1]['notfinite_total']} steps were skipped")
    check_counts(counts, {k: v * TRAIN_STEPS for k, v in per_step.items()},
                 f"{TRAIN_STEPS} train steps")
    if not moved(before, state.model, running=False):
        fail("the parameters did not move")
    if not moved(before, state.model, running=True):
        fail("the BatchNorm running statistics did not move")
    for i, m in enumerate(metrics):
        log(f"  step {i + 1}: total_loss {m['total_loss'].item():.5f} "
            f"grad_norm {m['grad_norm'].item():.4f} " + " ".join(
                f"{k} {m[k].item():.4f}" for k in
                ("Rot1", "Tran", "Size", "Point_matching", "nocs_coor",
                 "sp2d_coor")))
    return losses, counts


def nan_step(state, step, batch) -> None:
    """A NaN in a loss target: the finite guard must skip the update.
    (In ``roi_img`` it would turn SizeHead's running statistics NaN, which
    the JAX package and the port both replace on a skipped step too.)"""
    import torch

    bad = dict(batch)
    bad["translation"] = batch["translation"].clone()
    bad["translation"][0, 0] = float("nan")
    before = snapshot(state.model)
    skipped = state.optimizer.total_notfinite
    m = step(state, bad, torch.Generator(device="cuda").manual_seed(8))
    if m["notfinite_total"] != skipped + 1:
        fail(f"the NaN step was not counted ({m['notfinite_total']})")
    if moved(before, state.model, running=False):
        fail("the NaN step moved the parameters")
    log(f"  NaN target: loss {m['total_loss'].item()}, notfinite_total "
        f"{m['notfinite_total']}, parameters untouched")


def step_grads(model, loss_fn, batch, seed: int) -> tuple[dict, dict]:
    """Losses and gradients of one training forward (dropout from
    ``seed``), as the train step takes them."""
    import torch

    out = model(batch, train=True,
                generator=torch.Generator(device="cuda").manual_seed(seed))
    losses = loss_fn(out, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()), params)
    return ({k: v.item() for k, v in losses.items()},
            dict(zip(names, grads)))


def step_losses(model, loss_fn, batch, seed: int) -> dict:
    """Losses of one training forward (dropout from ``seed``)."""
    import torch

    with torch.no_grad():
        out = model(batch, train=True, generator=torch.Generator(
            device="cuda").manual_seed(seed))
        return {k: v.item() for k, v in loss_fn(out, batch).items()}


@contextlib.contextmanager
def dcn_backward(replace=None):
    """Within the block, every backward of ``DCNv3Function`` is recorded
    (its saved inputs, grad_out, options and the gradients it returned)
    and, when ``replace`` is given, computed by ``replace(x, offset, mask,
    grad_out, **options)`` instead of the kernel."""
    from givepose_torch.ops.dcnv3_cuda import DCNv3Function

    calls = []
    orig = DCNv3Function.__dict__["backward"]

    def backward(ctx, grad_out):
        if replace is None:
            grads = orig.__func__(ctx, grad_out)
        else:
            x, offset, mask = ctx.saved_tensors
            d_x, d_off, d_m = replace(x, offset, mask, grad_out, **ctx.kw)
            grads = (d_x.to(x.dtype), d_off, d_m) + (None,) * 7
        calls.append((ctx.saved_tensors, grad_out, dict(ctx.kw), grads[:3]))
        return grads

    DCNv3Function.backward = staticmethod(backward)
    try:
        yield calls
    finally:
        DCNv3Function.backward = orig


def check_recorded_bwd(calls) -> None:
    """The backward kernel's d_x, d_offset and d_mask on the tensors the
    train step gave it against the plain backward on the same tensors,
    each within KERNEL_BAR * max|ref|.  With bf16 x, d_x comes back in
    bf16: there the error is counted beyond one bf16 ulp (2^-7 |ref|),
    as the two f32 values may round to neighbouring bf16 values."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd

    if len(calls) != 3:
        fail(f"the kernel path's step ran {len(calls)} DCNv3 backwards, "
             f"expected 3")
    for i, ((x, off, m), g, kw, got) in enumerate(calls):
        want = list(dcnv3_core_bwd(x, off, m, g, **kw))
        bars = [KERNEL_BAR * b.abs().max().item() for b in want]
        slack = [0.0, 0.0, 0.0]
        if x.dtype == torch.bfloat16:
            slack[0] = want[0].abs() * 2.0 ** -7
            want[0] = want[0].to(torch.bfloat16).float()
        errs = [((a.float() - b).abs() - s).max().item()
                for a, b, s in zip(got, want, slack)]
        ok = all(e <= bar for e, bar in zip(errs, bars))
        log(f"  dcnv3_bwd on the step's own tensors, x{tuple(x.shape)} "
            f"{str(x.dtype).split('.')[1]}: max_abs_err d_x "
            f"{errs[0]:.3e} (bar {bars[0]:.3e}) d_offset "
            f"{errs[1]:.3e} (bar {bars[1]:.3e}) d_mask {errs[2]:.3e} (bar "
            f"{bars[2]:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"dcnv3_bwd disagrees with dcnv3_core_bwd on the train "
                 f"step's DCNv3 backward {i}")


def grad_error(grads: dict, ref: dict) -> tuple[float, str, float]:
    """(worst leaf's max|g - ref| / max|ref|, that leaf, relative L2 error
    over all leaves), leaves that are zero up to rounding (below 1e-6 of
    the largest gradient: the bias ahead of SizeHead's batch-statistics
    BatchNorm) left out."""
    top = max(g.abs().max().item() for g in ref.values())
    worst, worst_key, num, den = 0.0, "", 0.0, 0.0
    for k, r in ref.items():
        scale = r.abs().max().item()
        if scale < 1e-6 * top:
            continue
        d = grads[k].double() - r.double()
        if d.abs().max().item() / scale > worst:
            worst, worst_key = d.abs().max().item() / scale, k
        num += d.square().sum().item()
        den += r.double().square().sum().item()
    return worst, worst_key, math.sqrt(num / den)


def compare_train_paths(sd: dict, batch, cfg=None) -> None:
    """One step's losses and gradients with the DCNv3 kernels against the
    plain DCNv3 version, for the model of ``cfg`` (default
    ``ModelConfig()``; with ``dcn_window`` the windowed kernels), from the
    weights ``sd`` (the seeded state before any training step), on the
    same batch and dropout mask, with cuDNN
    held to deterministic algorithms.

    At this random initialisation the step's gradients are ill-conditioned
    in the forward's last bits: the kernel's and the plain version's
    forward sum in different orders, and that alone moves single leaves
    by up to ~1e-2 of their largest value (ReLU inputs within rounding of
    zero, sums that cancel such as the GroupNorm biases'; so does f64
    sampling against f32).  So the gradients are held to 1e-4 per leaf
    where only the backward differs, and the whole paths to an L2 bar:

    f32, an f32 copy of the model at batch 8 (TF32 off):
    - each loss term, kernel path against plain path, within
      1e-5 * (1 + |plain|);
    - the backward kernel on the tensors this step gave it against the
      plain backward, within KERNEL_BAR (check_recorded_bwd);
    - every leaf's gradient, with the kernel forward and the backward
      kernel against the kernel forward and the plain backward, within
      KERNEL_BAR * max|leaf|;
    - all gradients, kernel path against plain path, within PATH_L2_BAR
      in relative L2.

    bf16 (the model as it trains):
    - the backward kernel on the tensors a batch-8 step gave it (bf16 x)
      against the plain backward (check_recorded_bwd);
    - over the six batch-8 slices of the training batch, the loss terms'
      summed gap between the kernel and plain paths within
      BF16_LOSS_RATIO times the plain bf16 losses' own gap to f32.  Both
      gaps are draws of one noise, bf16 rounding amplified by the same
      ill-conditioning (the rotation and point-matching terms of single
      samples move most).

    ``tools/train_path_spread.py`` runs this comparison over ten states
    and batches; on an H100 the whole paths' gradients differed by
    3.6e-6 to 2.8e-4 in relative L2, and the bf16 gap ratio ranged from
    0.25 to 1.66, the largest at this state."""
    import torch

    from givepose_torch.core.config import LossConfig, ModelConfig
    from givepose_torch.eval.serving import build_posenet
    from givepose_torch.losses.pose_loss import PoseLossFn
    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd

    loss_fn = PoseLossFn(LossConfig(), device="cuda")
    slices = [{k: v[i:i + CHECK_BATCH] for k, v in batch.items()}
              for i in range(0, TRAIN_BATCH, CHECK_BATCH)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = cfg or ModelConfig()
        m = build_posenet(dataclasses.replace(cfg, compute_dtype="float32"),
                          state_dict=sd)
        with dcn_backward() as calls:
            l_k, g_k = step_grads(m, loss_fn, slices[0], seed=9)
        check_recorded_bwd(calls)
        del calls
        with dcn_backward(replace=dcnv3_core_bwd):
            _, g_kp = step_grads(m, loss_fn, slices[0], seed=9)
        set_impl(m, "torch")
        l_p, g_p = step_grads(m, loss_fn, slices[0], seed=9)
        l32 = [step_losses(m, loss_fn, s, seed=9) for s in slices]
        del m
        m = build_posenet(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                          state_dict=sd)
        with dcn_backward() as calls:
            step_grads(m, loss_fn, slices[0], seed=9)
        check_recorded_bwd(calls)
        del calls
        l16k = [step_losses(m, loss_fn, s, seed=9) for s in slices]
        set_impl(m, "torch")
        l16p = [step_losses(m, loss_fn, s, seed=9) for s in slices]
        del m
    finally:
        torch.backends.cudnn.deterministic = deterministic

    for k in l_p:
        d = abs(l_k[k] - l_p[k])
        log(f"  f32 loss {k:<15} kernel {l_k[k]:.7f} plain {l_p[k]:.7f} "
            f"diff {d:.2e}")
        if d > 1e-5 * (1 + abs(l_p[k])):
            fail(f"f32 loss {k} differs between the kernel and plain paths")
    bw, bk, bl2 = grad_error(g_k, g_kp)
    log(f"  f32 gradients, backward kernel vs plain backward in the step "
        f"({len(g_kp)} leaves): worst leaf {bw:.3e} ({bk}), L2 {bl2:.3e} "
        f"(bar {KERNEL_BAR} per leaf) {'ok' if bw <= KERNEL_BAR else 'FAIL'}")
    if bw > KERNEL_BAR:
        fail(f"gradient {bk} differs between the backward kernel and the "
             f"plain backward")
    pw, pk, pl2 = grad_error(g_k, g_p)
    log(f"  f32 gradients, kernel path vs plain path: L2 {pl2:.3e} (bar "
        f"{PATH_L2_BAR}), worst leaf {pw:.3e} ({pk}) "
        f"{'ok' if pl2 <= PATH_L2_BAR else 'FAIL'}")
    if pl2 > PATH_L2_BAR:
        fail("the f32 gradients differ between the kernel and plain paths")
    gap = sum(abs(a[k] - b[k]) for a, b in zip(l16k, l16p) for k in l_p)
    own = sum(abs(b[k] - c[k]) for b, c in zip(l16p, l32) for k in l_p)
    ok = gap <= BF16_LOSS_RATIO * own
    log(f"  bf16 losses over {len(slices)} slices of {CHECK_BATCH}, kernel "
        f"vs plain: summed gap {gap:.3e} (bar {BF16_LOSS_RATIO} x plain "
        f"bf16 vs f32 {own:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("bf16 losses differ between the kernel and plain paths by more "
             "than bf16 departs from f32")


def time_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around each call,
    after a warm-up; ``flush`` (a large tensor) is overwritten before each
    call so that the inputs come from HBM, not from the 50 MB L2."""
    import torch

    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def time_layers(gen, card: str, window: int = 0, reps: int = 50) -> dict:
    """Phase 7a: each MAPEncoder DCNv3 layer at batch 32, bf16 x, offsets
    N(0, 2 px); with a window, the windowed kernel."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core
    from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda, dcnv3_win_cuda

    name_k = "dcnv3_win_fwd" if window else "dcnv3_fwd"
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, err=0.0)
    for name, side in MAIN_LAYERS:
        x, off, m = dcnv3_inputs(gen, BATCH, side, side, 4, 64, 2, 1, 1, 2.0)
        x = x.to(torch.bfloat16)
        kw = dict(stride=2, pad=1, dilation=1, group=4)
        if window:
            kw["window"] = window

            def kernel():
                return dcnv3_win_cuda(x, off, m, **kw)
        else:
            def kernel():
                return dcnv3_cuda(x, off, m, **kw)
        out = kernel()
        ref = dcnv3_core(x.float(), off, m, **kw)
        err = (out - ref).abs().max().item()
        if err > KERNEL_BAR * ref.abs().max().item():
            fail(f"{name_k} disagrees at batch {BATCH} on {name}")
        ms = time_ms(kernel, reps, flush)
        plain_ms = time_ms(lambda: dcnv3_core(x.float(), off, m, **kw), 3,
                           flush)
        n_bytes = (x.numel() * x.element_size() + off.numel() * 4
                   + m.numel() * 4 + out.numel() * 4)
        ops = out.numel() * 9 * FLOP_PER_TAP_CHANNEL
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        share = ""
        if window:
            held = clamp_share(off, side, side, 2, 1, 1, 4, window)
            share = f", clamp holds {100 * held:.1f} % of samples"
        log(f"  {name_k} {name} x{tuple(x.shape)} bf16: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops_ms:.4f} ms), "
            f"{n_bytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e}{share} "
            f"[{card}]")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["ops_ms"] += ops_ms
        total["err"] = max(total["err"], err)
    return total


def time_bwd_layers(gen, card: str, window: int = 0,
                    reps: int = 30) -> dict:
    """Phase 7b: the backward of each MAPEncoder DCNv3 layer at the
    training batch 48, bf16 x, with ``window`` (0: unbounded).  ``ms`` is
    the wrapper ``dcnv3_bwd_cuda``: the f32 zeros it fills d_x with (the
    kernel adds into d_x) and the kernel; the fill alone is timed and
    logged on its own line.  Casting d_x to x's dtype after it (in
    ``DCNv3Function``) is not in ``ms``.  Bytes of the bound: x, grad_out,
    offset, mask read once, d_x (f32), d_offset, d_mask written once; the
    fill's write is not counted, as it is not work the function needs."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd
    from givepose_torch.ops.dcnv3_cuda import dcnv3_bwd_cuda

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    total = dict(ms=0.0, fill_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                 err=0.0)
    for name, side in MAIN_LAYERS:
        x, off, m = dcnv3_inputs(gen, TRAIN_BATCH, side, side, 4, 64, 2, 1,
                                 1, 2.0)
        x = x.to(torch.bfloat16)
        g = torch.randn(TRAIN_BATCH, side // 2, side // 2, 256,
                        generator=gen, device="cuda")
        kw = dict(stride=2, pad=1, dilation=1, group=4, window=window)
        got = dcnv3_bwd_cuda(x, off, m, g, **kw)
        want = dcnv3_core_bwd(x, off, m, g, **kw)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if any((a - b).abs().max().item() > KERNEL_BAR * b.abs().max().item()
               for a, b in zip(got, want)):
            fail(f"dcnv3_bwd (window {window}) disagrees at batch "
                 f"{TRAIN_BATCH} on {name}")
        del got, want
        ms = time_ms(lambda: dcnv3_bwd_cuda(x, off, m, g, **kw), reps, flush)
        fill_ms = time_ms(lambda: torch.zeros(x.shape, device="cuda"), reps,
                          flush)
        log(f"  dcnv3_bwd window {window} {name} d_x fill alone "
            f"(torch.zeros, {x.numel() * 4 / 1e6:.1f} MB f32): "
            f"{fill_ms:.4f} ms of the kernel's {ms:.4f} ms [{card}]")
        plain_ms = time_ms(lambda: dcnv3_core_bwd(x, off, m, g, **kw), 3,
                           flush)
        n_bytes = (x.numel() * x.element_size() + g.numel() * 4
                   + 2 * (off.numel() * 4 + m.numel() * 4) + x.numel() * 4)
        ops = g.numel() * 9 * BWD_FLOP_PER_TAP_CHANNEL
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  dcnv3_bwd window {window} {name} x{tuple(x.shape)} bf16: "
            f"kernel (d_x fill included) {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops_ms:.4f} ms), "
            f"{n_bytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e} [{card}]")
        total["ms"] += ms
        total["fill_ms"] += fill_ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["ops_ms"] += ops_ms
        total["err"] = max(total["err"], err)
    log(f"  dcnv3_bwd window {window} three layers: {total['ms']:.4f} ms, of "
        f"which the d_x fill alone {total['fill_ms']:.4f} ms [{card}]")
    return total


def device_busy_ms(prof) -> float:
    """Device time of every kernel, copy and fill in a torch.profiler
    profile, in ms, summed over the device events themselves: a kernel
    launched through ctypes, as the port's are, has no host op to carry
    its time."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def time_train(state, step, batch, card: str) -> float:
    """Phase 7e: the train step at batch 48 over TIMED_STEPS steps after
    two warm-up steps: CUDA events around each step, and the host clock
    around all of them; peak device memory.  Returns ms per step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pairs = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, gen)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  train step batch {TRAIN_BATCH}: {ms:.3f} ms mean (min "
        f"{times[0]:.3f}, max {times[-1]:.3f}; host clock {wall_ms:.3f} ms), "
        f"{TRAIN_BATCH * 1e3 / ms:.1f} images/s, peak memory {peak:.2f} GiB "
        f"[{card}]")
    return ms


def profile_train_step(state, step, batch, step_ms: float,
                       card: str) -> None:
    """Phase 7f: device time of one train step by op, from torch.profiler
    over 2 steps, and the share of the unprofiled step time in which the
    device is busy."""
    import torch
    from torch.profiler import ProfilerActivity

    reps = 2
    gen = torch.Generator(device="cuda").manual_seed(11)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    ops = prof.key_averages()
    busy_ms = device_busy_ms(prof) / reps
    log(ops.table(sort_by="self_device_time_total", row_limit=20,
                  max_name_column_width=48))
    log(f"  train step batch {TRAIN_BATCH}: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.3f} ms ({100 * busy_ms / step_ms:.0f} %) [{card}]")


def breakdown_train_step(state, batch, card: str) -> None:
    """Phase 7g: where one train step's time goes.  The step's three parts
    (forward with the loss; the gradients; the optimizer update) run
    apart, synchronised at their edges: the host clock gives each part's
    wall time (mean of 3), and a torch.profiler around each part its
    device-busy time."""
    import torch
    from torch.profiler import ProfilerActivity

    from givepose_torch.core.config import LossConfig
    from givepose_torch.losses.pose_loss import PoseLossFn

    model, opt = state.model, state.optimizer
    loss_fn = PoseLossFn(LossConfig(), device="cuda")
    names, params = zip(*model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(12)
    ctx = {}

    def forward():
        out = model(batch, train=True, generator=gen)
        ctx["total"] = sum(loss_fn(out, batch).values())

    def backward():
        ctx["grads"] = dict(zip(names, torch.autograd.grad(ctx["total"],
                                                           params)))

    def update():
        opt.step(ctx["grads"])

    parts = (("forward + loss", forward), ("gradients", backward),
             ("optimizer", update))
    wall = {name: 0.0 for name, _ in parts}
    reps = 3
    for _ in range(reps):
        for name, fn in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[name] += (time.perf_counter() - t0) * 1e3 / reps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, fn in parts:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        log(f"  train step part {name:<15}: wall {wall[name]:.3f} ms, "
            f"device busy {busy:.3f} ms [{card}]")
    state.step += reps + 1


def time_posenet(model, batch, card: str) -> float:
    """Phase 7c: PoseNet forward at batch 32; returns ms per forward."""
    import torch

    def fwd():
        with torch.inference_mode():
            model(batch)

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(fwd, 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  PoseNet forward batch {BATCH}: {ms:.3f} ms, "
        f"{BATCH * 1e3 / ms:.1f} crops/s, peak memory {peak:.2f} GiB "
        f"[{card}]")
    return ms


def profile_forward(model, batch, fwd_ms: float, card: str) -> None:
    """Phase 7: device time of the PoseNet forward (``model``: the model or
    an artifact's forward on the batch) by op, from torch.profiler over 3
    forwards, and the share of the unprofiled forward time (``fwd_ms``) in
    which the device is busy."""
    import torch
    from torch.profiler import ProfilerActivity

    reps = 3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                model(batch)
            torch.cuda.synchronize()
    ops = prof.key_averages()
    busy_ms = device_busy_ms(prof) / reps
    log(ops.table(sort_by="self_device_time_total", row_limit=15,
                  max_name_column_width=48))
    log(f"  PoseNet forward batch {BATCH}: device busy {busy_ms:.3f} ms of "
        f"{fwd_ms:.3f} ms ({100 * busy_ms / fwd_ms:.0f} %) [{card}]")


def on_bound(off, window: int):
    """Offsets (offset_scale 1, dilation 1) that put every tap of every
    query exactly on the window's bound: x on the high side, y on the low
    side."""
    import torch

    lin = torch.arange(3, device=off.device, dtype=off.dtype) - 1
    gx, gy = lin.repeat_interleave(3), lin.repeat(3)
    o = off.reshape(*off.shape[:3], -1, 9, 2).clone()
    o[..., 0] = window - gx
    o[..., 1] = -window - gy
    return o.reshape(off.shape)


def clamp_share(off, h, w, stride, pad, dilation, group, window) -> float:
    """Share of samples (k3, offset_scale 1) that the window clamp moves
    or holds on its bound, along x or y."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_sampling_locations

    ho, wo = off.shape[1:3]
    loc = dcnv3_sampling_locations(off, h + 2 * pad, w + 2 * pad, 3, stride,
                                   dilation, group, 1.0)
    half = dilation
    cx = half + stride * torch.arange(wo, device=off.device)
    cy = half + stride * torch.arange(ho, device=off.device)
    cx = cx[None, None, :, None, None]
    cy = cy[None, :, None, None, None]
    held = (((loc[..., 0] - cx).abs() >= window)
            | ((loc[..., 1] - cy).abs() >= window))
    return held.float().mean().item()


def win_cases() -> list:
    """The windowed kernels' checks: the MAPEncoder shapes at batch 8,
    then WIN_EDGE_CASES."""
    return ([(name, CHECK_BATCH, s, s, 4, 64, 2, 1, 1, 2.0, WINDOW, False)
             for name, s in MAIN_LAYERS] + WIN_EDGE_CASES)


def check_win_kernel(gen) -> float:
    """Phase 3, windowed forward against the plain windowed dcnv3_core,
    x in bf16 and f32, within KERNEL_BAR * max|ref|; returns the largest
    max abs error."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core
    from givepose_torch.ops.dcnv3_cuda import dcnv3_win_cuda

    worst = 0.0
    for (name, n, h, w, group, gc, stride, pad, dil, mult, window,
         bound) in win_cases():
        x, off, m = dcnv3_inputs(gen, n, h, w, group, gc, stride, pad, dil,
                                 mult)
        if bound:
            off = on_bound(off, window)
        share = clamp_share(off, h, w, stride, pad, dil, group, window)
        kw = dict(stride=stride, pad=pad, dilation=dil, group=group,
                  window=window)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            out = dcnv3_win_cuda(xd, off, m, **kw)
            ref = dcnv3_core(xd.float(), off, m, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            bar = KERNEL_BAR * ref.abs().max().item()
            worst = max(worst, err)
            log(f"  dcnv3_win_fwd {name:<13} x{tuple(x.shape)} window "
                f"{window} {str(dtype).split('.')[1]:<8} clamp holds "
                f"{100 * share:5.1f} % max_abs_err {err:.3e} (bar {bar:.3e}) "
                f"{'ok' if err <= bar else 'FAIL'}")
            if err > bar:
                fail(f"dcnv3_win_fwd disagrees with dcnv3_core on {name} "
                     f"{dtype}")
    return worst


def check_win_bwd_kernel(gen) -> float:
    """Phase 3, the backward kernel with a window against autograd of the
    plain windowed version, each of d_x, d_offset, d_mask within
    KERNEL_BAR * max|ref|, including the tie case (window 1, zero
    offsets: every corner tap on the bound, where d_offset is half the
    unclamped one); returns the largest max abs error."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd
    from givepose_torch.ops.dcnv3_cuda import dcnv3_bwd_cuda

    cases = win_cases() + [
        ("tie_w1", CHECK_BATCH, 64, 64, 4, 64, 2, 1, 1, 0.0, 1, False),
        ("tie_w1_s1", 2, 20, 20, 4, 64, 1, 1, 1, 0.0, 1, False)]
    worst = 0.0
    for (name, n, h, w, group, gc, stride, pad, dil, mult, window,
         bound) in cases:
        x, off, m = dcnv3_inputs(gen, n, h, w, group, gc, stride, pad, dil,
                                 mult)
        if bound:
            off = on_bound(off, window)
        g = torch.randn(n, out_side(h, stride, pad, dil),
                        out_side(w, stride, pad, dil), group * gc,
                        generator=gen, device=gen.device)
        kw = dict(stride=stride, pad=pad, dilation=dil, group=group,
                  window=window)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            got = dcnv3_bwd_cuda(xd, off, m, g, **kw)
            want = dcnv3_core_bwd(xd, off, m, g, **kw)
            torch.cuda.synchronize()
            errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
            bars = [KERNEL_BAR * b.abs().max().item() for b in want]
            ok = all(e <= bar for e, bar in zip(errs, bars))
            worst = max(worst, *errs)
            log(f"  dcnv3_bwd {name:<13} x{tuple(x.shape)} window {window} "
                f"{str(dtype).split('.')[1]:<8} max_abs_err d_x "
                f"{errs[0]:.3e} (bar {bars[0]:.3e}) d_offset {errs[1]:.3e} "
                f"(bar {bars[1]:.3e}) d_mask {errs[2]:.3e} (bar "
                f"{bars[2]:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"dcnv3_bwd disagrees with dcnv3_core_bwd on {name} "
                     f"{dtype}")
    return worst


def mlp_inputs(gen, m: int, c: int, dtype, hd: int = 0) -> dict:
    """A ConvNeXt block's int8-MLP operands: the raw depthwise-conv map y
    and the residual in ``dtype``, LN statistics of y, LN affine near
    (1, 0), weights N(0, 1/fan_in), small biases and O(1) layer scales
    U(0.2, 1); H = ``hd`` or 4 C."""
    import torch

    hd = hd or 4 * c

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=gen.device) * scale

    yc = randn(m, c, scale=2.0) + randn(m, 1)
    mu = yc.mean(-1, keepdim=True)
    d = yc - mu
    rsig = torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-6)
    return dict(y=yc.to(dtype), residual=randn(m, c).to(dtype),
                w0=randn(c, hd, scale=c ** -0.5), b0=randn(hd, scale=0.02),
                w1=randn(hd, c, scale=hd ** -0.5), b1=randn(c, scale=0.02),
                gamma=0.2 + 0.8 * torch.rand(c, generator=gen,
                                             device=gen.device),
                ln=(mu, rsig, 1 + randn(c, scale=0.1), randn(c, scale=0.1)))


def mlp_operands(inp: dict, with_ln: bool) -> tuple:
    """The kernel's operands (weights quantized and transposed, gamma
    folded) and the plain version's, from ``mlp_inputs``."""
    from givepose_torch.ops.quant_matmul import quantize_weights

    w0q, s0 = quantize_weights(inp["w0"])
    w1q, s1 = quantize_weights(inp["w1"], inp["gamma"])
    b1g = inp["b1"] * inp["gamma"]
    ln = inp["ln"] if with_ln else None
    kernel = (inp["y"], inp["residual"], w0q.t().contiguous(), s0, inp["b0"],
              w1q.t().contiguous(), s1, b1g, "gelu_tanh", ln)
    plain = (inp["y"], inp["residual"], w0q, s0, inp["b0"], w1q, s1, b1g,
             "gelu_tanh", inp["y"].dtype, ln)
    return kernel, plain


def mlp_bars(plain_args, ref) -> tuple[float, float]:
    """(max bar, mean bar) of the int8 MLP kernel against its plain
    version: MLP_FLIPS one-step flips of a requantized hidden value
    (``requant_flip``) plus 2 ulp of the output dtype at max|ref|;
    MLP_MEAN_BAR * mean|ref|."""
    import torch

    from givepose_torch.ops.quant_matmul import requant_flip

    y, _, w0q, s0, b0, w1q, s1, _, act, _, ln = plain_args
    flip = requant_flip(y, w0q, s0, b0, w1q, s1, act, ln)
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -23
    top = ref.float().abs()
    return (MLP_FLIPS * flip + 2 * ulp * top.max().item(),
            MLP_MEAN_BAR * top.mean().item())


def mlp_block_cols(c: int) -> int:
    """Output columns per block of the int8 MLP kernel at width C, for the
    log: the rule of ``block_cols`` in givepose_torch/csrc/int8_mlp.cu."""
    return next(nb for nb in (512, 256, 64) if c % nb == 0)


def mlp_kernel_ops(m: int, c: int, hd: int) -> int:
    """int8 operations the int8 MLP kernel executes on (M, C) rows and H
    hidden columns: the first product once per pass (two) and per column
    block, the second once; 2 M C H per product."""
    return 2 * m * c * hd * (2 * (c // mlp_block_cols(c)) + 1)


def check_mlp_kernel(gen) -> float:
    """Phase 3, the fused int8 MLP kernel against its plain version at the
    stage-2 and stage-3 shapes of batch 32, with the LN prologue (the
    model's variant) and without, in bf16 and (with LN) f32, and at the
    edges of its tiling (MLP_EDGE_CASES) with LN in bf16 and raw in f32;
    returns the largest max abs error."""
    import torch

    from givepose_torch.ops.quant_matmul import (mlp_int8_cuda,
                                                 mlp_int8_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, c, 4 * c, variant) for name, _, m, c in MLP_STAGES
             for variant in ((True, bf16), (False, bf16), (True, f32))]
    cases += [(name, m, c, hd, variant) for name, m, c, hd in MLP_EDGE_CASES
              for variant in ((True, bf16), (False, f32))]
    worst = 0.0
    for name, m, c, hd, (with_ln, dtype) in cases:
        inp = mlp_inputs(gen, m, c, dtype, hd)
        kernel_args, plain_args = mlp_operands(inp, with_ln)
        out = mlp_int8_cuda(*kernel_args)
        ref = mlp_int8_plain(*plain_args)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        max_bar, mean_bar = mlp_bars(plain_args, ref)
        err, mean = d.max().item(), d.mean().item()
        ok = err <= max_bar and mean <= mean_bar
        worst = max(worst, err)
        moved = (ref.float() - inp["residual"].float()).abs().mean()
        # not vacuous: the MLP branch shows in the output
        ok = ok and moved.item() > 1e-2
        log(f"  int8_mlp {name} ({m}, {c}, H {hd}; {c // mlp_block_cols(c)}"
            f" column block(s)) {'ln ' if with_ln else 'raw'} "
            f"{str(dtype).split('.')[1]:<8} max_abs_err {err:.3e} (bar "
            f"{max_bar:.3e}) mean {mean:.3e} (bar {mean_bar:.3e}), "
            f"{int((d > 0).sum())} of {d.numel()} outputs differ; MLP branch "
            f"mean |out - res| {moved.item():.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"int8_mlp disagrees with mlp_int8_plain on {name} {dtype} "
                 f"{'ln' if with_ln else 'raw'}")
    return worst


def set_layer_scales(model, seed: int) -> None:
    """Seeded O(1) layer scales, U(0.2, 1), in every ConvNeXt block: the
    init's 1e-6 would hide the MLP branches, and with them the int8
    kernel."""
    import torch

    from givepose_torch.models.convnext import ConvNeXtBlock

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(0.2 + 0.8 * torch.rand(m.gamma.shape,
                                                     generator=gen))


def model_clamp_share(model, batch, window: int, train: bool) -> list:
    """Share of each DCNv3 layer's samples that the window clamp holds in
    one forward of ``batch``."""
    import torch

    from givepose_torch.models.dcnv3_module import DCNv3

    offsets = []
    hooks = [m.offset.register_forward_hook(
        lambda mod, inp, out: offsets.append(out.detach().float()))
        for m in model.modules() if isinstance(m, DCNv3)]
    try:
        with torch.no_grad():
            model(batch, train=train, generator=torch.Generator(
                device="cuda").manual_seed(0) if train else None)
    finally:
        for h in hooks:
            h.remove()
    return [clamp_share(o, 2 * o.shape[1], 2 * o.shape[2], 2, 1, 1, 4,
                        window) for o in offsets]


def departure(model, cfg, batch, out) -> None:
    """The int8 model's outputs against the same weights served without
    int8 (bf16, same window): what int8 serving changes.  Fails if the
    NOCS map does not move by more than 1e-6 (the int8 path did not
    show)."""
    import torch

    from givepose_torch.eval.serving import build_posenet

    m16 = build_posenet(dataclasses.replace(cfg, quant_dense=False),
                        backbone_variant="base",
                        state_dict=model.state_dict())
    with torch.inference_mode():
        ref = m16(batch)
    del m16
    for k in PARITY_BARS:
        d = (out[k] - ref[k]).abs()
        log(f"  int8 vs bf16 model: {k:<9} max {d.max().item():.3e} mean "
            f"{d.mean().item():.3e} (max|bf16| "
            f"{ref[k].abs().max().item():.3e})")
    if (out["nocs_coor"] - ref["nocs_coor"]).abs().max().item() <= 1e-6:
        fail("the int8 model serves what the bf16 model does")


def time_mlp(gen, card: str, reps: int = 20) -> dict:
    """Phase 7: the int8 MLP kernel (LN variant, bf16) per block of each
    int8 stage at batch 32, against its bound (operations: 16 M C^2 int8
    ops at 1979 TOP/s; bytes: y, residual, out in bf16, both int8 weight
    matrices, LN statistics), the bound of the operations its design
    executes (the first product once per pass and column block:
    ``mlp_kernel_ops``), its plain version, and the bf16 block MLP it
    replaces (fc1 -> tanh GELU -> fc2 -> x + y * gamma, as the unquantized
    ConvNeXt block runs it, without the LN), summed per forward over the
    27 + 3 blocks and set beside the earlier mma.sync design.  Weights
    are quantized outside the timed call."""
    import torch
    import torch.nn.functional as F

    from givepose_torch.ops.quant_matmul import (mlp_int8_cuda,
                                                 mlp_int8_plain)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                 run_ops_ms=0.0, bf16_ms=0.0)
    for name, blocks, m, c in MLP_STAGES:
        inp = mlp_inputs(gen, m, c, torch.bfloat16)
        kernel_args, plain_args = mlp_operands(inp, True)
        ms = time_ms(lambda: mlp_int8_cuda(*kernel_args), reps, flush)
        plain_ms = time_ms(lambda: mlp_int8_plain(*plain_args), 3, flush)
        w0 = inp["w0"].t().contiguous().to(torch.bfloat16)
        w1 = inp["w1"].t().contiguous().to(torch.bfloat16)
        b0, b1 = inp["b0"].to(torch.bfloat16), inp["b1"].to(torch.bfloat16)
        gamma = inp["gamma"].to(torch.bfloat16)
        y, res = inp["y"], inp["residual"]

        def bf16_mlp():
            h = F.gelu(F.linear(y, w0, b0), approximate="tanh")
            return res + F.linear(h, w1, b1) * gamma

        bf16_ms = time_ms(bf16_mlp, reps, flush)
        ops = 16 * m * c * c
        run_ops = mlp_kernel_ops(m, c, 4 * c)
        n_bytes = 3 * m * c * 2 + 8 * c * c + 8 * m + 8 * 4 * c + 16 * c
        ops_ms = ops / INT8_OPS_PER_S * 1e3
        run_ops_ms = run_ops / INT8_OPS_PER_S * 1e3
        bound_ms = max(ops_ms, n_bytes / HBM_BYTES_PER_S * 1e3)
        log(f"  int8_mlp {name} ({m}, {c}) bf16 + LN, per block: kernel "
            f"{ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s of the MLP's ops, "
            f"{run_ops / ms / 1e9:.0f} executed), bound {bound_ms:.4f} ms "
            f"(ops {ops_ms:.4f} ms at 1979 TOP/s; {n_bytes / 1e6:.1f} MB at "
            f"3.35 TB/s), design's ops {run_ops_ms:.4f} ms "
            f"({run_ops / ops:.1f}x), plain {plain_ms:.4f} ms, bf16 block "
            f"MLP {bf16_ms:.4f} ms (int8 / bf16 {ms / bf16_ms:.2f}); x "
            f"{blocks} blocks [{card}]")
        total["ms"] += blocks * ms
        total["plain_ms"] += blocks * plain_ms
        total["bound_ms"] += blocks * bound_ms
        total["ops_ms"] += blocks * ops_ms
        total["run_ops_ms"] += blocks * run_ops_ms
        total["bf16_ms"] += blocks * bf16_ms
    log(f"  int8_mlp per forward (27 + 3 blocks): kernel {total['ms']:.4f} "
        f"ms (mma.sync design: {MLP_MMA_SYNC_MS:.3f} ms, PERF.md), bound "
        f"{total['bound_ms']:.4f} ms, design's ops {total['run_ops_ms']:.4f}"
        f" ms, plain {total['plain_ms']:.4f} ms, bf16 block MLPs "
        f"{total['bf16_ms']:.4f} ms; int8 / bf16 "
        f"{total['ms'] / total['bf16_ms']:.3f} [{card}]")
    return total


def qmm_operands(gen, m: int, k: int, n: int, dtype) -> dict:
    """A dense layer's operands on the card: x ~ N(0, 4) in ``dtype``, its
    per-row int8 form (``quantize_activations``), weights N(0, 1/K)
    quantized per output channel (int8 (K, N), transposed (N, K), f32
    scales) and a bias N(0, 0.01)."""
    import torch

    from givepose_torch.ops.quant_matmul import (quantize_activations,
                                                 quantize_weights)

    x = (torch.randn(m, k, generator=gen, device=gen.device) * 2.0).to(dtype)
    wq, ws = quantize_weights(torch.randn(k, n, generator=gen,
                                          device=gen.device) * k ** -0.5)
    xq, xs = quantize_activations(x)
    return dict(x=x, xq=xq, xs=xs.reshape(-1), wq=wq,
                wt=wq.t().contiguous(), ws=ws,
                b=torch.randn(n, generator=gen, device=gen.device) * 0.1)


def qmm_bars(ref, flip: float = 0.0) -> tuple[float, float]:
    """(max bar, mean bar) of a dense kernel against its plain version:
    QMM_FLIPS one-step flips of a quantized x value (``qmm_flip``; 0 for
    B5, whose x is quantized before the call) times GELU's largest slope,
    plus 2 ulp of the output dtype at max|ref|; MLP_MEAN_BAR *
    mean|ref|."""
    import torch

    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -23
    top = ref.float().abs()
    return (QMM_FLIPS * 1.13 * flip + 2 * ulp * top.max().item(),
            MLP_MEAN_BAR * top.mean().item())


def check_qmm_kernels(gen) -> tuple[float, float]:
    """Phase 3, the W8A8 dense kernels against their plain versions at the
    batch-32 ConvNeXt-B MLP shapes and the ragged ones, x and out in bf16
    and f32, for every activation; returns the largest max abs error of
    B4 and of B5."""
    import torch

    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_flip,
                                                 qmm_pre_cuda,
                                                 quant_matmul_plain,
                                                 quant_matmul_pre_plain)

    worst = [0.0, 0.0]
    for name, m, k, n, _ in QMM_SHAPES + QMM_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            op = qmm_operands(gen, m, k, n, dtype)
            flip = qmm_flip(op["x"], op["wq"], op["ws"])
            parts = []
            for act in QMM_ACTS:
                runs = (
                    (qmm_cuda(op["x"], op["wt"], op["ws"], op["b"], act,
                              dtype),
                     quant_matmul_plain(op["x"], op["wq"], op["ws"], op["b"],
                                        act, dtype), flip),
                    (qmm_pre_cuda(op["xq"], op["xs"], op["wt"], op["ws"],
                                  op["b"], act, dtype),
                     quant_matmul_pre_plain(op["xq"], op["xs"], op["wq"],
                                            op["ws"], op["b"], act, dtype),
                     0.0))
                torch.cuda.synchronize()
                for i, (out, ref, fl) in enumerate(runs):
                    d = (out.float() - ref.float()).abs()
                    max_bar, mean_bar = qmm_bars(ref, fl)
                    err = d.max().item()
                    ok = (out.shape == (m, n) and out.dtype == dtype
                          and err <= max_bar and d.mean().item() <= mean_bar)
                    worst[i] = max(worst[i], err)
                    parts.append(f"{('B4', 'B5')[i]} {act} {err:.2e} "
                                 f"({int((d > 0).sum())} differ, bar "
                                 f"{max_bar:.1e})")
                    if not ok:
                        fail(f"{('int8_qmm', 'int8_qmm_pre')[i]} disagrees "
                             f"with its plain version on {name} {dtype} "
                             f"{act}: max {err:.3e} (bar {max_bar:.3e}), "
                             f"mean {d.mean().item():.3e} (bar "
                             f"{mean_bar:.3e})")
            log(f"  int8_qmm / int8_qmm_pre {name} ({m}, {k} -> {n}) "
                f"{str(dtype).split('.')[1]:<8} of {m * n} outputs: "
                + "; ".join(parts) + " ok")
    return worst[0], worst[1]


def check_quant_dense(gen) -> None:
    """Phase 3, ``QuantDense`` from ``make_dense(True, ...)`` loaded (strict)
    from a bf16 ``nn.Linear``'s state dict, on a (32, 16, 16, 512) bf16
    input: one int8_qmm launch per call, its plain path's output up to
    flips, and its departure from the bf16 Linear (+ GELU) it replaces."""
    import torch
    import torch.nn.functional as F

    from givepose_torch.models.quant import make_dense
    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_flip,
                                                 quant_dense,
                                                 quantize_weights)

    _, m, k, n, act = QMM_SHAPES[0]
    lin = torch.nn.Linear(k, n, dtype=torch.bfloat16, device=gen.device)
    with torch.no_grad():
        lin.weight.normal_(0, k ** -0.5, generator=gen)
        lin.bias.normal_(0, 0.1, generator=gen)
    layer = make_dense(True, k, n, torch.bfloat16, act=act).to(gen.device)
    layer.load_state_dict(lin.state_dict(), strict=True)
    x = torch.randn(BATCH, 16, 16, k, generator=gen, device=gen.device).to(
        torch.bfloat16)
    wq, ws = quantize_weights(layer.weight.t())
    before = qmm_cuda.launches
    with torch.inference_mode():
        out = layer(x)
        launched = qmm_cuda.launches - before
        ref = quant_dense(x, layer.weight.t(), layer.bias, act=act,
                          impl="torch")
        want = F.gelu(lin(x), approximate="tanh")
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    max_bar, mean_bar = qmm_bars(ref, qmm_flip(x.reshape(-1, k), wq, ws))
    rel = ((out.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    ok = (launched == 1 and out.shape == (BATCH, 16, 16, n)
          and d.max().item() <= max_bar and d.mean().item() <= mean_bar
          and rel < 5e-2)
    log(f"  QuantDense({k}, {n}, act={act}) from a bf16 nn.Linear's state "
        f"dict, x{tuple(x.shape)} bf16: {launched} int8_qmm launch, vs its "
        f"plain path max {d.max().item():.3e} ({int((d > 0).sum())} of "
        f"{d.numel()} differ), vs the bf16 Linear + GELU max/max|ref| "
        f"{rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("QuantDense disagrees with its plain path or the Linear it "
             "replaces")


def dense_path(gen) -> tuple[dict, float]:
    """Phase 5, the W8A8 dense path: for each of 3 batch-32 requests, the
    stage-2 and stage-3 ConvNeXt-B MLPs as ``QuantDense`` layers (fc1 with
    its GELU in the epilogue, fc2), and as ``quantize_activations`` into
    ``quant_matmul_pre`` with the same layers' weights.  Returns each
    kernel's launches (4 of each per request) and the largest departure
    of the int8 MLP from the bf16 one (relative to max|bf16|)."""
    import torch
    import torch.nn.functional as F

    from givepose_torch.models.quant import make_dense
    from givepose_torch.ops.quant_matmul import (quant_matmul_pre,
                                                 quantize_activations,
                                                 quantize_weights)

    bf16 = torch.bfloat16
    stages = []
    for (_, m, c, h, _), side in ((QMM_SHAPES[0], 16), (QMM_SHAPES[2], 8)):
        fc1 = make_dense(True, c, h, bf16, act="gelu_tanh").to(gen.device)
        fc2 = make_dense(True, h, c, bf16).to(gen.device)
        with torch.no_grad():
            for lin in (fc1, fc2):
                lin.weight.normal_(0, lin.in_features ** -0.5, generator=gen)
                lin.bias.normal_(0, 0.02, generator=gen)
        pre = [quantize_weights(lin.weight.t()) + (lin.bias,)
               for lin in (fc1, fc2)]
        xs = [torch.randn(BATCH, side, side, c, generator=gen,
                          device=gen.device).to(bf16)
              for _ in range(REQUESTS)]
        stages.append((fc1, fc2, pre, xs))
    reset_counts()
    outs = []
    with torch.inference_mode():
        for r in range(REQUESTS):
            for fc1, fc2, pre, xs in stages:
                x = xs[r]
                y = fc2(fc1(x))
                (w1q, w1s, b1), (w2q, w2s, b2) = pre
                hq, hs = quantize_activations(x)
                hid = quant_matmul_pre(hq, hs, w1q, w1s, b1, "gelu_tanh")
                gq, gs = quantize_activations(hid)
                z = quant_matmul_pre(gq, gs, w2q, w2s, b2)
                outs.append((x, y, z, fc1, fc2))
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"int8_qmm": 4 * REQUESTS,
                          "int8_qmm_pre": 4 * REQUESTS},
                 f"{REQUESTS} dense-path requests")
    worst = 0.0
    with torch.inference_mode():
        for x, y, z, fc1, fc2 in outs:
            want = F.linear(F.gelu(F.linear(x, fc1.weight.to(bf16),
                                            fc1.bias.to(bf16)),
                                   approximate="tanh"),
                            fc2.weight.to(bf16), fc2.bias.to(bf16))
            for got in (y, z):
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail("the dense path's output is malformed")
                rel = ((got.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                worst = max(worst, rel)
    if worst > 5e-2:
        fail(f"the int8 dense MLP departs from the bf16 one by {worst:.3e}")
    return counts, worst


def time_qmm(gen, card: str, reps: int = 20) -> dict:
    """Phase 7: B4 and B5 per matmul at the batch-32 ConvNeXt-B shapes, x
    and out in bf16, each layer's activation: the kernel, its plain
    version, its bound (2 M N K int8 ops at 1979 TOP/s; bytes: x (bf16 for
    B4, int8 and the row scales for B5), the int8 weights, scales and bias,
    the bf16 output, at 3.35 TB/s), and as yardsticks the bf16
    ``F.linear`` (+ GELU) and ``torch._int_mm`` on the same operands.
    Returns the four matmuls summed, per kernel."""
    import torch
    import torch.nn.functional as F

    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_pre_cuda,
                                                 quant_matmul_plain,
                                                 quant_matmul_pre_plain)

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=gen.device)
    keys = ("ms", "plain_ms", "bound_ms", "ops_ms", "bf16_linear_ms",
            "int_mm_ms")
    tot = {k: {key: 0.0 for key in keys} for k in ("int8_qmm",
                                                    "int8_qmm_pre")}
    bf16 = torch.bfloat16
    for name, m, k, n, act in QMM_SHAPES:
        op = qmm_operands(gen, m, k, n, bf16)
        w16 = (op["wq"].float() * op["ws"]).t().contiguous().to(bf16)
        b16 = op["b"].to(bf16)

        def linear():
            y = F.linear(op["x"], w16, b16)
            return F.gelu(y, approximate="tanh") if act != "none" else y

        lin_ms = time_ms(linear, reps, flush)
        int_mm_ms = time_ms(lambda: torch._int_mm(op["xq"], op["wt"].t()),
                            reps, flush)
        ops = 2 * m * n * k
        ops_ms = ops / INT8_OPS_PER_S * 1e3
        runs = {
            "int8_qmm": (
                lambda: qmm_cuda(op["x"], op["wt"], op["ws"], op["b"], act),
                lambda: quant_matmul_plain(op["x"], op["wq"], op["ws"],
                                           op["b"], act),
                2 * m * k),
            "int8_qmm_pre": (
                lambda: qmm_pre_cuda(op["xq"], op["xs"], op["wt"], op["ws"],
                                     op["b"], act),
                lambda: quant_matmul_pre_plain(op["xq"], op["xs"], op["wq"],
                                               op["ws"], op["b"], act),
                m * k + 4 * m)}
        for kname, (kernel, plain, x_bytes) in runs.items():
            ms = time_ms(kernel, reps, flush)
            plain_ms = time_ms(plain, 3, flush)
            n_bytes = x_bytes + n * k + 8 * n + 2 * m * n
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            log(f"  {kname} {name} ({m}, {k} -> {n}) bf16, {act}: kernel "
                f"{ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (ops "
                f"{ops_ms:.4f} ms at 1979 TOP/s; {n_bytes / 1e6:.1f} MB, "
                f"{bytes_ms:.4f} ms at 3.35 TB/s), bf16 F.linear"
                f"{' + GELU' if act != 'none' else ''} {lin_ms:.4f} ms, "
                f"torch._int_mm {int_mm_ms:.4f} ms [{card}]")
            t = tot[kname]
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound_ms), ("ops_ms", ops_ms),
                           ("bf16_linear_ms", lin_ms),
                           ("int_mm_ms", int_mm_ms)):
                t[key] += v
    for kname, t in tot.items():
        log(f"  {kname} over the four batch-32 matmuls: kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bf16 F.linear {t['bf16_linear_ms']:.4f}"
            f" ms, torch._int_mm {t['int_mm_ms']:.4f} ms [{card}]")
    return tot


def time_dispatch(gen, card: str, calls: int = 30, rounds: int = 7) -> dict:
    """Phase 7: the host time that a call through a kernel's
    ``torch.ops.givepose`` operator adds to a direct call of its wrapper,
    on the same tensors at the main path's batch-32 shapes (the first
    DCNv3 layer, a stage-2 int8 block, the stage-2 fc1 matmul).  The host
    clock runs around ``calls`` calls with no synchronisation inside, so
    it reads the time to issue them while the card runs behind; operator
    and wrapper in turns (operator, wrapper, wrapper, operator), median
    over ``rounds``.  Logs the cost per serving request (default: 3
    dcnv3_fwd; fast: 3 dcnv3_win_fwd + 30 int8_mlp) and returns, per
    kernel, the operator's and the wrapper's µs per call."""
    import statistics

    import torch

    from givepose_torch.ops.dcnv3_cuda import (dcnv3_bwd_cuda, dcnv3_cuda,
                                               dcnv3_win_cuda)
    from givepose_torch.ops.quant_matmul import (mlp_int8_cuda, qmm_cuda,
                                                 qmm_pre_cuda)

    ops, bf16 = torch.ops.givepose, torch.bfloat16
    x, off, m = dcnv3_inputs(gen, BATCH, 64, 64, 4, 64, 2, 1, 1, 2.0)
    x = x.to(bf16)
    go = torch.randn(*off.shape[:3], x.shape[-1], generator=gen,
                     device=gen.device)
    kw = dict(kernel=3, stride=2, pad=1, dilation=1, group=4,
              offset_scale=1.0)
    geo = tuple(kw.values())
    _, _, mm, c = MLP_STAGES[0]
    (y, res, w0t, s0, b0, w1t, s1, b1, act, ln), _ = mlp_operands(
        mlp_inputs(gen, mm, c, bf16), True)
    ln = (ln[0].contiguous(), ln[1].contiguous(), ln[2], ln[3])
    _, qm, qk, qn, qact = QMM_SHAPES[0]
    q = qmm_operands(gen, qm, qk, qn, bf16)
    qargs = (q["wt"], q["ws"], q["b"], qact, bf16)
    pairs = {
        "dcnv3_fwd": (lambda: ops.dcnv3_fwd(x, off, m, *geo),
                      lambda: dcnv3_cuda(x, off, m, **kw)),
        "dcnv3_win_fwd": (
            lambda: ops.dcnv3_win_fwd(x, off, m, *geo, WINDOW),
            lambda: dcnv3_win_cuda(x, off, m, window=WINDOW, **kw)),
        "dcnv3_bwd": (lambda: ops.dcnv3_bwd(x, off, m, go, *geo, 0),
                      lambda: dcnv3_bwd_cuda(x, off, m, go, **kw)),
        "int8_mlp": (
            lambda: ops.int8_mlp(y, res, w0t, s0, b0, w1t, s1, b1, act, bf16,
                                 *ln),
            lambda: mlp_int8_cuda(y, res, w0t, s0, b0, w1t, s1, b1, act, ln)),
        "int8_qmm": (lambda: ops.int8_qmm(q["x"], *qargs),
                     lambda: qmm_cuda(q["x"], *qargs)),
        "int8_qmm_pre": (lambda: ops.int8_qmm_pre(q["xq"], q["xs"], *qargs),
                         lambda: qmm_pre_cuda(q["xq"], q["xs"], *qargs)),
    }

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t) / calls * 1e6

    res_us = {}
    for name, (op, wrapper) in pairs.items():
        for _ in range(3):
            op()
            wrapper()
        t_op, t_w = [], []
        for _ in range(rounds):
            t_op.append(host_us(op))
            t_w += [host_us(wrapper), host_us(wrapper)]
            t_op.append(host_us(op))
        o, w = statistics.median(t_op), statistics.median(t_w)
        res_us[name] = (o, w)
        log(f"  {name} issued from the host: operator {o:.2f} µs, wrapper "
            f"{w:.2f} µs per call, the operator adds {o - w:.2f} µs "
            f"(median of {2 * rounds} runs of {calls} calls each) [{card}]")
    torch.cuda.synchronize()

    def add(name):
        return res_us[name][0] - res_us[name][1]

    log(f"  operators' host cost per batch-{BATCH} request: default "
        f"{3 * add('dcnv3_fwd') / 1e3:.4f} ms (3 dcnv3_fwd), fast "
        f"{(3 * add('dcnv3_win_fwd') + 30 * add('int8_mlp')) / 1e3:.4f} ms "
        f"(3 dcnv3_win_fwd + 30 int8_mlp); per train step "
        f"{3 * (add('dcnv3_fwd') + add('dcnv3_bwd')) / 1e3:.4f} ms [{card}]")
    # the int8 MLP wrapper's own host time (shape checks, two tensor-map
    # encodes, the shared-memory attribute, the launch) per fast request
    log(f"  int8_mlp wrapper's host time per batch-{BATCH} fast request: "
        f"30 x {res_us['int8_mlp'][1]:.2f} µs = "
        f"{30 * res_us['int8_mlp'][1] / 1e3:.4f} ms [{card}]")
    return res_us


def serve_artifact(model, cfg, batches, outs, out32, per_request: dict,
                   card: str) -> dict:
    """Phase 4, after each configuration: export ``model`` (of ``cfg``) at
    batch 32 on the card, save the artifact to a file and load it, and
    serve ``batches`` through it with the model's weights.  Each request
    must launch what the eager forward does (``per_request``), the outputs
    must equal the eager ones (``outs``) or, failing that, depart from
    them on average by no more than bf16 departs from the f32 copy
    (``out32``, request 0), and the artifact must stay under
    ARTIFACT_MAX_BYTES against at least WEIGHTS_MIN_BYTES of f32 weights.
    Returns the launches."""
    import io
    import tempfile

    import torch

    from givepose_torch.eval.serving import (export_posenet,
                                             load_exported_file,
                                             save_exported)

    weights = model.state_dict()
    t0 = time.time()
    blob = export_posenet(weights, cfg, "base", batch_size=BATCH,
                          img_size=256, device="cuda")
    export_s = time.time() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "posenet.pt2")
        save_exported(path, blob)
        fn = load_exported_file(path)
    weight_bytes = sum(v.numel() * 4 for v in weights.values())
    if len(blob) >= ARTIFACT_MAX_BYTES or weight_bytes < WEIGHTS_MIN_BYTES:
        fail(f"artifact {len(blob)} bytes against {weight_bytes} bytes of "
             f"f32 weights")
    reset_counts()
    arts = [fn(weights, b) for b in batches]
    torch.cuda.synchronize()
    counts = read_counts()
    for art in arts:
        check_outputs(art, BATCH)
    check_counts(counts, {k: v * len(batches) for k, v in
                          per_request.items()},
                 f"{len(batches)} requests through the artifact")
    bitwise = all(torch.equal(a[k], o[k]) for a, o in zip(arts, outs)
                  for k in o)
    for k in PARITY_BARS:
        d = max((a[k] - o[k]).abs().mean().item() for a, o in zip(arts, outs))
        own = (outs[0][k] - out32[k]).abs().mean().item()
        if not bitwise and d > own:
            fail(f"the artifact's {k} departs from the eager forward by "
                 f"{d:.3e} on average, more than bf16 from f32 ({own:.3e})")

    def eager():
        with torch.inference_mode():
            model(batches[0])

    # in turns: eager, artifact, artifact, eager
    times = [time_ms(f, 10) for f in (eager, lambda: fn(weights, batches[0]),
                                      lambda: fn(weights, batches[0]),
                                      eager)]
    eager_ms, art_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    profile_forward(lambda b: fn(weights, b), batches[0], art_ms, card)
    # where the artifact's host time goes: its graph's size, and the same
    # graph without torch.export's per-call checks of the ~470 inputs
    exported = torch.export.load(io.BytesIO(blob))
    n_ops = sum(n.op == "call_function" for n in exported.graph.nodes)
    raw = exported.module()
    raw.validate_inputs = False
    args = ({k: weights[k] for k in sorted(weights)},
            {k: batches[0][k] for k in sorted(batches[0])})

    def unchecked():
        with torch.inference_mode():
            raw(*args)

    unchecked_ms = time_ms(unchecked, 10)
    log(f"  artifact: {len(blob) / 1e6:.3f} MB against {weight_bytes / 1e6:.1f}"
        f" MB of f32 weights; export {export_s:.1f} s; launches {counts}; "
        f"outputs {'bitwise equal to' if bitwise else 'within bf16 of'} the "
        f"eager forward; forward batch {BATCH}: artifact {art_ms:.3f} ms "
        f"({BATCH * 1e3 / art_ms:.1f} crops/s), eager {eager_ms:.3f} ms "
        f"({BATCH * 1e3 / eager_ms:.1f} crops/s); the graph's {n_ops} ops "
        f"without the input checks {unchecked_ms:.3f} ms [{card}]")
    return counts


def main(argv: list[str]) -> None:
    if argv:
        fail(f"chip_smoke.py takes no arguments, got {argv}")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: the smoke run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "givepose_torch")):
        fail(f"no givepose_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from givepose_torch.core.config import Config, ModelConfig
    from givepose_torch.eval.serving import (build_posenet,
                                             example_serving_batch)
    from givepose_torch.ops import _build
    from givepose_torch.train import init_train_state, make_train_step

    # f32 means f32: no TF32 in cuBLAS or cuDNN (build_posenet sets the
    # same; the plain DCNv3 version's einsum is a batched matmul, and the
    # int8 blocks' depthwise conv is an f32 cuDNN conv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.time()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")

    t0 = time.time()
    _build.build()
    log(f"phase build: {_build.all_sources()} in {time.time() - t0:.1f} s")
    for src, report in _build.build_logs.items():
        log(f"  ptxas {src}:\n" + "\n".join(
            "    " + ln for ln in report.strip().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln))

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    max_err = check_kernel(gen)
    max_bwd_err = check_bwd_kernel(gen)
    win_err = check_win_kernel(gen)
    win_bwd_err = check_win_bwd_kernel(gen)
    mlp_err = check_mlp_kernel(gen)
    qmm_err, qmm_pre_err = check_qmm_kernels(gen)
    check_quant_dense(gen)
    log(f"phase kernel check: ok in {time.time() - t0:.1f} s")

    # serving, default ModelConfig: the unwindowed DCNv3 forward kernel
    t0 = time.time()
    model = build_posenet(ModelConfig(), backbone_variant="base", seed=0)
    perturb_dcn(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    batches = [example_serving_batch(BATCH, seed=s)
               for s in range(REQUESTS)]
    log(f"phase build model: ConvNeXt-B PoseNet, {n_params / 1e6:.1f} M "
        f"params, bf16 compute, in {time.time() - t0:.1f} s")
    t0 = time.time()
    outs, serve_counts = serve(model, batches, {"dcnv3_fwd": 3})
    log(f"phase serve: {REQUESTS} requests of batch {BATCH}, launches "
        f"{serve_counts}, outputs finite, |R^T R - I| <= {ORTHO_BAR}, in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    out32 = compare_paths(model, batches[0], outs[0])
    log(f"phase compare: kernel vs plain DCNv3 path in f32 and bf16, "
        f"in {time.time() - t0:.1f} s")
    t0 = time.time()
    tot = time_layers(gen, card, reps=20)
    fwd_ms = time_posenet(model, batches[0], card)
    profile_forward(model, batches[0], fwd_ms, card)
    log(f"phase serve timing: in {time.time() - t0:.1f} s")
    t0 = time.time()
    art_counts = serve_artifact(model, ModelConfig(), batches, outs, out32,
                                {"dcnv3_fwd": 3}, card)
    log(f"phase serve artifact: default ModelConfig exported, saved, "
        f"loaded and served {REQUESTS} requests of batch {BATCH}, in "
        f"{time.time() - t0:.1f} s")
    del model, outs, out32
    torch.cuda.empty_cache()

    # serving, the fast configuration: windowed DCNv3 + int8 ConvNeXt MLP
    t0 = time.time()
    cfg_fast = ModelConfig(dcn_window=WINDOW, quant_dense=True)
    model = build_posenet(cfg_fast, backbone_variant="base", seed=0)
    perturb_dcn(model, seed=1, offset_std=WINDOW_OFFSET_STD)
    set_layer_scales(model, seed=2)
    outs, fast_counts = serve(model, batches,
                              {"dcnv3_win_fwd": 3, "int8_mlp": 30})
    shares = model_clamp_share(model, batches[0], WINDOW, train=False)
    log(f"phase serve fast: dcn_window={WINDOW}, quant_dense=True, "
        f"{REQUESTS} requests of batch {BATCH}, launches {fast_counts}, "
        f"outputs finite, |R^T R - I| <= {ORTHO_BAR}; clamp holds "
        f"{', '.join(f'{100 * v:.2f} %' for v in shares)} of the DCNv3 "
        f"layers' samples, in {time.time() - t0:.1f} s")
    t0 = time.time()
    out32 = compare_paths(model, batches[0], outs[0], cfg_fast)
    departure(model, cfg_fast, batches[0], outs[0])
    log(f"phase compare fast: kernel vs plain path (windowed DCNv3 and "
        f"int8 MLP) in f32 and bf16, in {time.time() - t0:.1f} s")
    t0 = time.time()
    tot_win = time_layers(gen, card, window=WINDOW, reps=30)
    tot_mlp = time_mlp(gen, card)
    fast_ms = time_posenet(model, batches[0], card)
    profile_forward(model, batches[0], fast_ms, card)
    log(f"phase serve fast timing: in {time.time() - t0:.1f} s")
    t0 = time.time()
    art_fast_counts = serve_artifact(model, cfg_fast, batches, outs, out32,
                                     {"dcnv3_win_fwd": 3, "int8_mlp": 30},
                                     card)
    log(f"phase serve fast artifact: dcn_window={WINDOW}, quant_dense=True "
        f"exported, saved, loaded and served {REQUESTS} requests of batch "
        f"{BATCH}, in {time.time() - t0:.1f} s")
    del model, outs, out32, batches
    torch.cuda.empty_cache()

    # the W8A8 dense path: QuantDense, quantize_activations ->
    # quant_matmul_pre
    t0 = time.time()
    dense_counts, dense_dep = dense_path(gen)
    log(f"phase dense: ConvNeXt-B stage-2 and stage-3 MLPs through "
        f"QuantDense and quant_matmul_pre, {REQUESTS} requests of batch "
        f"{BATCH}, launches {dense_counts}; int8 vs bf16 MLP max/max|bf16| "
        f"{dense_dep:.3e}, in {time.time() - t0:.1f} s")
    t0 = time.time()
    tot_qmm = time_qmm(gen, card)
    time_dispatch(gen, card)
    log(f"phase dense timing: in {time.time() - t0:.1f} s")

    # training, default Config
    t0 = time.time()
    cfg = Config()
    state = init_train_state(cfg, backbone_variant="base", seed=0)
    perturb_dcn(state.model, seed=1)
    initial = snapshot(state.model)
    step = make_train_step(state.model, cfg)
    batch = train_batch(TRAIN_BATCH, seed=5)
    losses, train_counts = train(state, step, batch,
                                 {"dcnv3_fwd": 3, "dcnv3_bwd": 3})
    log(f"phase train: {TRAIN_STEPS} steps of batch {TRAIN_BATCH}, losses "
        f"{[round(v, 5) for v in losses]}, launches {train_counts}, in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    nan_step(state, step, batch)
    compare_train_paths(initial, batch)
    del initial
    log(f"phase train checks: NaN step skipped; kernel vs plain DCNv3 "
        f"path in one step, f32 and bf16, in {time.time() - t0:.1f} s")
    t0 = time.time()
    tot_bwd = time_bwd_layers(gen, card, reps=20)
    step_ms = time_train(state, step, batch, card)
    profile_train_step(state, step, batch, step_ms, card)
    breakdown_train_step(state, batch, card)
    log(f"phase train timing: in {time.time() - t0:.1f} s")
    del state, step
    torch.cuda.empty_cache()

    # training under the window
    t0 = time.time()
    cfg_w = Config(model=ModelConfig(dcn_window=WINDOW))
    state = init_train_state(cfg_w, backbone_variant="base", seed=0)
    perturb_dcn(state.model, seed=1, offset_std=WINDOW_OFFSET_STD)
    initial = snapshot(state.model)
    step = make_train_step(state.model, cfg_w)
    losses_w, win_train_counts = train(state, step, batch,
                                       {"dcnv3_win_fwd": 3, "dcnv3_bwd": 3})
    shares_t = model_clamp_share(state.model, batch, WINDOW, train=False)
    log(f"phase train window: dcn_window={WINDOW}, {TRAIN_STEPS} steps of "
        f"batch {TRAIN_BATCH}, losses {[round(v, 5) for v in losses_w]}, "
        f"launches {win_train_counts}; after them the clamp holds "
        f"{', '.join(f'{100 * v:.2f} %' for v in shares_t)} of the DCNv3 "
        f"layers' samples, in {time.time() - t0:.1f} s")
    t0 = time.time()
    nan_step(state, step, batch)
    compare_train_paths(initial, batch, cfg_w.model)
    del initial
    log(f"phase train window checks: NaN step skipped; kernel vs plain "
        f"windowed DCNv3 path in one step, f32 and bf16, in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    tot_bwd_win = time_bwd_layers(gen, card, window=WINDOW, reps=20)
    step_ms_w = time_train(state, step, batch, card)
    log(f"phase train window timing: {step_ms_w:.3f} ms per step, in "
        f"{time.time() - t0:.1f} s")
    log(f"all phases ok in {time.time() - start:.1f} s")

    def bound_by(t):
        return "bytes" if t["bound_ms"] > t["ops_ms"] else "operations"

    log(card)
    log(json.dumps({"kernels": [{
        "name": "dcnv3_fwd",
        "route": "cuda",
        "source": "givepose_torch/csrc/dcnv3_fwd.cu",
        "replaces": "givepose_tpu/ops/dcnv3_pallas.py:146",
        "launches": serve_counts["dcnv3_fwd"],
        "launches_by_path": {"serve": serve_counts["dcnv3_fwd"],
                             "serve_artifact": art_counts["dcnv3_fwd"],
                             "train": train_counts["dcnv3_fwd"]},
        "max_abs_err": max(max_err, tot["err"]),
        "max_err": max(max_err, tot["err"]),
        # per PoseNet forward at batch 32: the three layers summed
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": bound_by(tot),
        # no single PyTorch call computes DCNv3
        "library_ms": None,
    }, {
        "name": "dcnv3_bwd",
        "route": "cuda",
        "source": "givepose_torch/csrc/dcnv3_bwd.cu",
        "replaces": "givepose_tpu/ops/dcnv3_pallas_bwd.py:32",
        "launches": train_counts["dcnv3_bwd"]
        + win_train_counts["dcnv3_bwd"],
        "launches_by_path": {"train": train_counts["dcnv3_bwd"],
                             "train_window": win_train_counts["dcnv3_bwd"]},
        "max_abs_err": max(max_bwd_err, tot_bwd["err"], win_bwd_err,
                           tot_bwd_win["err"]),
        "max_err": max(max_bwd_err, tot_bwd["err"], win_bwd_err,
                       tot_bwd_win["err"]),
        # per train step at batch 48: the three layers summed, unbounded
        # offsets; the windowed backward beside it
        "ms": tot_bwd["ms"],
        "plain_ms": tot_bwd["plain_ms"],
        "bound_ms": tot_bwd["bound_ms"],
        "bound_by": bound_by(tot_bwd),
        "window_ms": tot_bwd_win["ms"],
        "window_plain_ms": tot_bwd_win["plain_ms"],
        # no single PyTorch call computes the DCNv3 backward
        "library_ms": None,
    }, {
        "name": "dcnv3_win_fwd",
        "route": "cuda",
        "source": "givepose_torch/csrc/dcnv3_win_fwd.cu",
        "replaces": "givepose_tpu/ops/dcnv3_window_pallas.py:156",
        "launches": fast_counts["dcnv3_win_fwd"],
        "launches_by_path": {
            "serve_fast": fast_counts["dcnv3_win_fwd"],
            "serve_fast_artifact": art_fast_counts["dcnv3_win_fwd"],
            "train_window": win_train_counts["dcnv3_win_fwd"]},
        "max_abs_err": max(win_err, tot_win["err"]),
        # per PoseNet forward at batch 32: the three layers summed
        "ms": tot_win["ms"],
        "plain_ms": tot_win["plain_ms"],
        "bound_ms": tot_win["bound_ms"],
        "bound_by": bound_by(tot_win),
        # no single PyTorch call computes DCNv3
        "library_ms": None,
    }, {
        "name": "int8_mlp",
        "route": "cuda",
        "source": "givepose_torch/csrc/int8_mlp.cu",
        "replaces": "givepose_tpu/ops/quant_matmul_pallas.py:251",
        "launches": fast_counts["int8_mlp"],
        "launches_by_path": {
            "serve_fast": fast_counts["int8_mlp"],
            "serve_fast_artifact": art_fast_counts["int8_mlp"]},
        "max_abs_err": mlp_err,
        # per PoseNet forward at batch 32: 27 stage-2 and 3 stage-3 blocks
        "ms": tot_mlp["ms"],
        "plain_ms": tot_mlp["plain_ms"],
        "bound_ms": tot_mlp["bound_ms"],
        "bound_by": bound_by(tot_mlp),
        # no single PyTorch call computes the int8 MLP; the bf16 block MLPs
        # it replaces, as a yardstick
        "library_ms": None,
        "bf16_mlp_ms": tot_mlp["bf16_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "givepose_torch/csrc/int8_qmm.cu",
        "replaces": f"givepose_tpu/ops/quant_matmul_pallas.py:{line}",
        "launches": dense_counts[name],
        "max_abs_err": err,
        # the four batch-32 ConvNeXt-B MLP matmuls summed, bf16 x and out
        "ms": tot_qmm[name]["ms"],
        "plain_ms": tot_qmm[name]["plain_ms"],
        "bound_ms": tot_qmm[name]["bound_ms"],
        "bound_by": bound_by(tot_qmm[name]),
        # no single PyTorch call computes dynamic W8A8; the bf16 matmuls
        # it replaces and the bare int8 product, as yardsticks
        "library_ms": None,
        "bf16_linear_ms": tot_qmm[name]["bf16_linear_ms"],
        "int_mm_ms": tot_qmm[name]["int_mm_ms"],
    } for name, line, err in (("int8_qmm", 49, qmm_err),
                              ("int8_qmm_pre", 74, qmm_pre_err))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
