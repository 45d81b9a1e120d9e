#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``givepose_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of ``givepose_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all started together;
3. hold the DCNv3 forward and backward kernels against their plain
   PyTorch versions on the card: the three MAPEncoder shapes at batch 8,
   edge cases (stride 1, dilation 2, 16 and 96 and 5 channels per group,
   large offsets, an odd output size) and, for the backward, zero offsets,
   with x in bf16 and in f32;
4. serve batch-32 requests through full-width ConvNeXt-B PoseNet (default
   ModelConfig, bf16, seeded random weights, DCNv3 offset and mask
   projections perturbed so that samples land off the grid); check the
   outputs and that the kernel ran three times per request; serve one
   request again through the plain DCNv3 version and compare, in bf16 and
   in an f32 copy of the model;
5. train: the same model under the default Config (Ranger, lr 1e-3, clip
   5, batch 48) takes 5 steps on a seeded batch (256² crops, 64² maps and
   masks, 1024 model points, random rotations, half of them symmetric);
   the loss stays finite, parameters and BatchNorm statistics move,
   nothing is skipped, and each step launches each DCNv3 kernel three
   times; then a step whose translation target holds a NaN must leave the
   parameters untouched and count one skip; then, from the seeded weights
   before the first step, one step's losses and gradients with the
   kernels against the plain DCNv3 version, in an f32 copy at batch 8
   (and the backward kernel on that step's own tensors against the plain
   backward) and in bf16;
6. time each DCNv3 layer, forward at the serving batch 32 and backward at
   the training batch 48 (kernel, plain version, bound), the PoseNet
   forward and the train step with CUDA events, break the forward's and
   the train step's device time down by op with torch.profiler, and the
   train step's wall and device time down by part (forward, gradients,
   optimizer).

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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


def set_dcn_impl(model, impl: str) -> None:
    from givepose_torch.models.dcnv3_module import DCNv3

    for m in model.modules():
        if isinstance(m, DCNv3):
            m.impl = impl


def perturb_dcn(model, seed: int) -> None:
    """Seeded noise on the zero-initialised offset (std 0.05) and mask
    (std 0.5) projections, so that samples land off the regular grid."""
    import torch

    from givepose_torch.models.dcnv3_module import DCNv3

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCNv3):
                for lin, std in ((m.offset, 0.05), (m.mask, 0.5)):
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


def serve(model, batches) -> tuple[list, int]:
    """Phase 4: the main path.  Returns the outputs and the kernel's
    launches during it."""
    import torch

    from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda

    dcnv3_cuda.launches = 0
    with torch.inference_mode():
        outs = [model(b) for b in batches]
    torch.cuda.synchronize()
    launches = dcnv3_cuda.launches
    for out in outs:
        check_outputs(out, BATCH)
    if launches != 3 * len(batches):
        fail(f"dcnv3_fwd launched {launches} times for {len(batches)} "
             f"requests, expected 3 per request")
    return outs, launches


def run_plain(model, batch) -> dict:
    """Serve one request with the DCNv3 layers on the plain version."""
    import torch

    from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda

    before = dcnv3_cuda.launches
    set_dcn_impl(model, "torch")
    try:
        with torch.inference_mode():
            plain = model(batch)
        torch.cuda.synchronize()
    finally:
        set_dcn_impl(model, "auto")
    if dcnv3_cuda.launches != before:
        fail("dcn_impl='torch' launched the kernel")
    return plain


def max_diff(a, b) -> float:
    return (a - b).abs().max().item()


def compare_paths(model, batch, out) -> None:
    """The kernel path against the plain DCNv3 path, on the card.

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
    m32 = build_posenet(ModelConfig(compute_dtype="float32"),
                        backbone_variant="base",
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
        log(f"  kernel vs plain DCNv3 path: {k:<9} f32 max {d32:.3e} "
            f"(bar {bar32:.3e}); bf16 mean {d16.mean().item():.3e} "
            f"(bar = bf16 vs f32 mean {e16.mean().item():.3e}), bf16 max "
            f"{d16.max().item():.3e} (bf16 vs f32 max "
            f"{e16.max().item():.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"PoseNet {k} differs between the kernel and plain paths")


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


def train(state, step, batch) -> tuple[list, int, int]:
    """Phase 5: the training main path, TRAIN_STEPS steps at batch 48.
    Returns the total losses and the launches of each kernel."""
    import torch

    from givepose_torch.ops.dcnv3_cuda import dcnv3_bwd_cuda, dcnv3_cuda

    before = snapshot(state.model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    dcnv3_cuda.launches = 0
    dcnv3_bwd_cuda.launches = 0
    metrics = [step(state, batch, gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    fwd, bwd = dcnv3_cuda.launches, dcnv3_bwd_cuda.launches
    losses = [m["total_loss"].item() for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        fail(f"train loss is not finite: {losses}")
    if metrics[-1]["notfinite_total"] != 0:
        fail(f"{metrics[-1]['notfinite_total']} steps were skipped")
    if fwd != 3 * TRAIN_STEPS or bwd != 3 * TRAIN_STEPS:
        fail(f"dcnv3_fwd launched {fwd} and dcnv3_bwd {bwd} times in "
             f"{TRAIN_STEPS} steps, expected 3 each per step")
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
    return losses, fwd, bwd


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
            grads = (d_x.to(x.dtype), d_off, d_m) + (None,) * 6
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


def compare_train_paths(sd: dict, batch) -> None:
    """One step's losses and gradients with the DCNv3 kernels against the
    plain DCNv3 version, from the weights ``sd`` (the seeded state before
    any training step), on the same batch and dropout mask, with cuDNN
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
        m = build_posenet(ModelConfig(compute_dtype="float32"), state_dict=sd)
        with dcn_backward() as calls:
            l_k, g_k = step_grads(m, loss_fn, slices[0], seed=9)
        check_recorded_bwd(calls)
        del calls
        with dcn_backward(replace=dcnv3_core_bwd):
            _, g_kp = step_grads(m, loss_fn, slices[0], seed=9)
        set_dcn_impl(m, "torch")
        l_p, g_p = step_grads(m, loss_fn, slices[0], seed=9)
        l32 = [step_losses(m, loss_fn, s, seed=9) for s in slices]
        del m
        m = build_posenet(ModelConfig(compute_dtype="bfloat16"),
                          state_dict=sd)
        with dcn_backward() as calls:
            step_grads(m, loss_fn, slices[0], seed=9)
        check_recorded_bwd(calls)
        del calls
        l16k = [step_losses(m, loss_fn, s, seed=9) for s in slices]
        set_dcn_impl(m, "torch")
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


def time_layers(gen, card: str) -> dict:
    """Phase 6a: each MAPEncoder DCNv3 layer at batch 32, bf16 x."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core
    from givepose_torch.ops.dcnv3_cuda import dcnv3_cuda

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0)
    for name, side in MAIN_LAYERS:
        x, off, m = dcnv3_inputs(gen, BATCH, side, side, 4, 64, 2, 1, 1, 2.0)
        x = x.to(torch.bfloat16)
        kw = dict(stride=2, pad=1, dilation=1, group=4)
        out = dcnv3_cuda(x, off, m, **kw)
        ref = dcnv3_core(x.float(), off, m, **kw)
        err = (out - ref).abs().max().item()
        if err > KERNEL_BAR * ref.abs().max().item():
            fail(f"dcnv3_fwd disagrees at batch {BATCH} on {name}")
        ms = time_ms(lambda: dcnv3_cuda(x, off, m, **kw), 50, flush)
        plain_ms = time_ms(lambda: dcnv3_core(x.float(), off, m, **kw), 5,
                           flush)
        n_bytes = (x.numel() * x.element_size() + off.numel() * 4
                   + m.numel() * 4 + out.numel() * 4)
        ops = out.numel() * 9 * FLOP_PER_TAP_CHANNEL
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  dcnv3_fwd {name} x{tuple(x.shape)} bf16: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops_ms:.4f} ms), "
            f"{n_bytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e} [{card}]")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["ops_ms"] += ops_ms
    return total


def time_bwd_layers(gen, card: str) -> dict:
    """Phase 6b: the backward of each MAPEncoder DCNv3 layer at the
    training batch 48, bf16 x.  Bytes: x, grad_out, offset, mask read once,
    d_x (f32), d_offset, d_mask written once; zeroing d_x before the
    kernel and casting it to bf16 after are not counted (they are outside
    the kernel, and ``ms`` does not include them either)."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core_bwd
    from givepose_torch.ops.dcnv3_cuda import dcnv3_bwd_cuda

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, err=0.0)
    for name, side in MAIN_LAYERS:
        x, off, m = dcnv3_inputs(gen, TRAIN_BATCH, side, side, 4, 64, 2, 1,
                                 1, 2.0)
        x = x.to(torch.bfloat16)
        g = torch.randn(TRAIN_BATCH, side // 2, side // 2, 256,
                        generator=gen, device="cuda")
        kw = dict(stride=2, pad=1, dilation=1, group=4)
        got = dcnv3_bwd_cuda(x, off, m, g, **kw)
        want = dcnv3_core_bwd(x, off, m, g, **kw)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if any((a - b).abs().max().item() > KERNEL_BAR * b.abs().max().item()
               for a, b in zip(got, want)):
            fail(f"dcnv3_bwd disagrees at batch {TRAIN_BATCH} on {name}")
        del got, want
        ms = time_ms(lambda: dcnv3_bwd_cuda(x, off, m, g, **kw), 30, flush)
        plain_ms = time_ms(lambda: dcnv3_core_bwd(x, off, m, g, **kw), 3,
                           flush)
        n_bytes = (x.numel() * x.element_size() + g.numel() * 4
                   + 2 * (off.numel() * 4 + m.numel() * 4) + x.numel() * 4)
        ops = g.numel() * 9 * BWD_FLOP_PER_TAP_CHANNEL
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  dcnv3_bwd {name} x{tuple(x.shape)} bf16: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops_ms:.4f} ms), "
            f"{n_bytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e} [{card}]")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["ops_ms"] += ops_ms
        total["err"] = max(total["err"], err)
    return total


def time_train(state, step, batch, card: str) -> float:
    """Phase 6e: the train step at batch 48 over TIMED_STEPS steps after
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
    """Phase 6f: device time of one train step by op, from torch.profiler
    over 2 steps, and the share of the unprofiled step time in which the
    device is busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    reps = 2
    gen = torch.Generator(device="cuda").manual_seed(11)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    ops = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ops
                  if e.device_type == DeviceType.CPU) / 1e3 / reps
    log(ops.table(sort_by="self_device_time_total", row_limit=20,
                  max_name_column_width=48))
    log(f"  train step batch {TRAIN_BATCH}: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.3f} ms ({100 * busy_ms / step_ms:.0f} %) [{card}]")


def breakdown_train_step(state, batch, card: str) -> None:
    """Phase 6g: where one train step's time goes.  The step's three parts
    (forward with the loss; the gradients; the optimizer update) run
    apart, synchronised at their edges: the host clock gives each part's
    wall time (mean of 3), and a torch.profiler around each part its
    device-busy time."""
    import torch
    from torch.autograd import DeviceType
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
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU) / 1e3
        log(f"  train step part {name:<15}: wall {wall[name]:.3f} ms, "
            f"device busy {busy:.3f} ms [{card}]")
    state.step += reps + 1


def time_posenet(model, batch, card: str) -> float:
    """Phase 6c: PoseNet forward at batch 32; returns ms per forward."""
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
    """Phase 6d: device time of the PoseNet forward by op, from
    torch.profiler over 3 forwards, and the share of the unprofiled
    forward time (``fwd_ms``) in which the device is busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    reps = 3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                model(batch)
            torch.cuda.synchronize()
    ops = prof.key_averages()
    # device time is attributed to the host op that launched it; summing
    # over host ops counts every kernel once
    busy_ms = sum(e.self_device_time_total for e in ops
                  if e.device_type == DeviceType.CPU) / 1e3 / reps
    log(ops.table(sort_by="self_device_time_total", row_limit=15,
                  max_name_column_width=48))
    log(f"  PoseNet forward batch {BATCH}: device busy {busy_ms:.3f} ms of "
        f"{fwd_ms:.3f} ms ({100 * busy_ms / fwd_ms:.0f} %) [{card}]")


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
    # same; the plain DCNv3 version's einsum is a batched matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
            "    " + ln for ln in report.strip().splitlines()))

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    max_err = check_kernel(gen)
    max_bwd_err = check_bwd_kernel(gen)
    log(f"phase kernel check: ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    model = build_posenet(ModelConfig(), backbone_variant="base", seed=0)
    perturb_dcn(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    batches = [example_serving_batch(BATCH, seed=s)
               for s in range(REQUESTS)]
    log(f"phase build model: ConvNeXt-B PoseNet, {n_params / 1e6:.1f} M "
        f"params, bf16 compute, in {time.time() - t0:.1f} s")
    t0 = time.time()
    outs, launches = serve(model, batches)
    log(f"phase serve: {REQUESTS} requests of batch {BATCH}, "
        f"dcnv3_fwd launches {launches}, outputs finite, "
        f"|R^T R - I| <= {ORTHO_BAR}, in {time.time() - t0:.1f} s")
    t0 = time.time()
    compare_paths(model, batches[0], outs[0])
    log(f"phase compare: kernel vs plain DCNv3 path in f32 and bf16, "
        f"in {time.time() - t0:.1f} s")

    t0 = time.time()
    tot = time_layers(gen, card)
    fwd_ms = time_posenet(model, batches[0], card)
    profile_forward(model, batches[0], fwd_ms, card)
    log(f"phase serve timing: in {time.time() - t0:.1f} s")
    del model, outs, batches
    torch.cuda.empty_cache()

    t0 = time.time()
    cfg = Config()
    state = init_train_state(cfg, backbone_variant="base", seed=0)
    perturb_dcn(state.model, seed=1)
    initial = snapshot(state.model)
    step = make_train_step(state.model, cfg)
    batch = train_batch(TRAIN_BATCH, seed=5)
    losses, train_fwd, train_bwd = train(state, step, batch)
    log(f"phase train: {TRAIN_STEPS} steps of batch {TRAIN_BATCH}, losses "
        f"{[round(v, 5) for v in losses]}, dcnv3_fwd launches {train_fwd}, "
        f"dcnv3_bwd launches {train_bwd}, in {time.time() - t0:.1f} s")
    t0 = time.time()
    nan_step(state, step, batch)
    compare_train_paths(initial, batch)
    del initial
    log(f"phase train checks: NaN step skipped; kernel vs plain DCNv3 "
        f"path in one step, f32 and bf16, in {time.time() - t0:.1f} s")

    t0 = time.time()
    tot_bwd = time_bwd_layers(gen, card)
    step_ms = time_train(state, step, batch, card)
    profile_train_step(state, step, batch, step_ms, card)
    breakdown_train_step(state, batch, card)
    log(f"phase train timing: in {time.time() - t0:.1f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "dcnv3_fwd",
        "route": "cuda",
        "source": "givepose_torch/csrc/dcnv3_fwd.cu",
        "replaces": "givepose_tpu/ops/dcnv3_pallas.py:146",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        # per PoseNet forward at batch 32: the three layers summed
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bound_ms"] > tot["ops_ms"]
        else "operations",
        # no single PyTorch call computes DCNv3
        "library_ms": None,
    }, {
        "name": "dcnv3_bwd",
        "route": "cuda",
        "source": "givepose_torch/csrc/dcnv3_bwd.cu",
        "replaces": "givepose_tpu/ops/dcnv3_pallas_bwd.py:32",
        "launches": train_bwd,
        "max_abs_err": max(max_bwd_err, tot_bwd["err"]),
        "max_err": max(max_bwd_err, tot_bwd["err"]),
        # per train step at batch 48: the three layers summed
        "ms": tot_bwd["ms"],
        "plain_ms": tot_bwd["plain_ms"],
        "bound_ms": tot_bwd["bound_ms"],
        "bound_by": "bytes" if tot_bwd["bound_ms"] > tot_bwd["ops_ms"]
        else "operations",
        # no single PyTorch call computes the DCNv3 backward
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
