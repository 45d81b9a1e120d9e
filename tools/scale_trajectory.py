#!/usr/bin/env python3
"""The overfit proof's ScaleNet half, the port beside the JAX CLI, on the CPU.

The recipe of ``tools/overfit_proof.py`` / ``benchmarks/overfit_proof.py``
(6 images, 64² crops, batch 4, augmentation off, 800 steps, train seed 0)
runs through ``givepose_tpu.cli.train_scale`` under JAX on the CPU, as it
is: its own initial weights, batches and dropout masks.  Those three are
recorded (the init by wrapping ``ScaleNet.init``, the batches by wrapping
``build_model_batch``, the masks by a ``flax.linen.intercept_methods``
interceptor that reproduces ``nn.Dropout``) and fed to
``givepose_torch.cli.train_scale`` on the CPU, so both CLIs take the same
steps on the same arithmetic unit and any gap is the port's or f32
rounding's, not a different draw.

    JAX_PLATFORMS=cpu python3 tools/scale_trajectory.py --seed 1 [--steps 800]
        [--out FILE]

Reports, and writes as JSON (default ``OVERFIT_trajectory_cpu_seed<S>.json``):

  * whether both packages' fixture writers wrote the same files (bytes, or
    for PNGs the decoded pixels), and where they differ;
  * both CLIs' scale losses every 50 steps and the first step at which
    they differ by more than 1e-3 relative (every step is logged);
  * step 1 (same weights, batch and masks) in JAX f32, the port's f32 and
    the port's f64, each held layer by layer (stems, their BatchNorms,
    each Bneck, heads, ``line1..3``, the prediction) and in its gradients
    against the JAX ScaleNet evaluated in f64 (``jax_scalenet_in_f64``);
    the first layer where the two f32 sides differ, and the stems'
    BatchNorm batch mean and variance on each f32 side against f64;
  * each side's final scale loss, its six per-image scale ratios
    (predicted metric scale over GT, the ratios of
    ``tools/overfit_proof.py scale_ratios``) and the present-class IoU25 /
    10°10cm those ratios give with a perfect PoseNet: GT rotation,
    translation and size, the predicted scale folded into the top rows of
    the sRT as ``cli.evaluate`` folds it.

Imports both packages: a CPU tool, like a test.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

REL_TOL = 1e-3


def compare_fixtures(a: str, b: str) -> list:
    """Files of tree ``a`` that differ from tree ``b``: missing, or
    different bytes and (PNGs) different decoded pixels."""
    import cv2

    diffs = []
    for dirpath, _, files in os.walk(a):
        for fn in sorted(files):
            pa = os.path.join(dirpath, fn)
            rel = os.path.relpath(pa, a)
            pb = os.path.join(b, rel)
            if not os.path.exists(pb):
                diffs.append({"file": rel, "diff": "missing"})
            elif not filecmp.cmp(pa, pb, shallow=False):
                if fn.endswith(".png"):
                    ia = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
                    ib = cv2.imread(pb, cv2.IMREAD_UNCHANGED)
                    same = (ia.shape == ib.shape and ia.dtype == ib.dtype
                            and np.array_equal(ia, ib))
                    diffs.append({"file": rel, "diff": "bytes",
                                  "pixels_equal": bool(same)})
                else:
                    diffs.append({"file": rel, "diff": "bytes"})
    return diffs


def dropout_recorder(masks: list):
    """flax's Dropout, reproduced, with each drawn mask handed out
    (``tests/test_torch_cli_train_scale.py``'s interceptor)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    def interceptor(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if not (isinstance(mod, nn.Dropout)
                and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        deterministic = nn.merge_param("deterministic", mod.deterministic,
                                       kwargs.get("deterministic"))
        x = args[0]
        if deterministic:
            return x
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection),
                                    p=keep, shape=x.shape)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask,
                           ordered=True)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))
    return interceptor


def run_jax(argv: list, steps: int):
    """The JAX CLI as it is, recording its init, batches and masks."""
    import flax.linen as nn
    import jax

    from givepose_tpu.cli import train_scale as jax_cli
    from givepose_tpu.models import ScaleNet as JaxScaleNet

    batches, masks, init = [], [], {}
    build = jax_cli.build_model_batch
    original_init = JaxScaleNet.init

    def recorded(raw, key, cfg, **kw):
        out = build(raw, key, cfg, **kw)
        batches.append({k: np.asarray(v) for k, v in out.items()})
        return out

    def recorded_init(self, *a, **k):
        v = original_init(self, *a, **k)
        init["variables"] = jax.tree_util.tree_map(np.asarray, v)
        jax.effects_barrier()
        masks.clear()               # init's own train-mode forward
        return v

    jax_cli.build_model_batch = recorded
    JaxScaleNet.init = recorded_init
    try:
        with nn.intercept_methods(dropout_recorder(masks)):
            state = jax_cli.train_scale(argv, max_steps=steps)
        jax.effects_barrier()
    finally:
        jax_cli.build_model_batch = build
        JaxScaleNet.init = original_init
    final = {"params": jax.tree_util.tree_map(np.asarray, state.params),
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   state.batch_stats)}
    return init["variables"], batches, masks, final


def run_port(argv: list, steps: int, variables: dict, batches: list,
             masks: list, freeze_at: int):
    """The port's CLI from the JAX run's init, fed its batches (less the
    init sample, which the port's CLI skips without building) and the
    train-mode steps' masks (the recalibration runs no dropout here)."""
    import torch

    from givepose_torch.cli import train_scale as cli
    from givepose_torch.models import scale_net as scale_net_mod
    from givepose_torch.models.convert_from_flax import flax_to_state_dict
    from givepose_torch.models.scale_net import build_scalenet

    feed = iter(batches[1:])
    fed = [torch.from_numpy(np.array(m)) for m in masks[:2 * freeze_at]]
    saved = (cli.build_model_batch, cli.build_scalenet,
             scale_net_mod.dropout_keep_mask)
    cli.build_model_batch = lambda *a, **k: {
        key: torch.from_numpy(np.array(v)) for key, v in next(feed).items()}
    cli.build_scalenet = lambda *a, **k: build_scalenet(
        device="cpu", state_dict=flax_to_state_dict(variables))
    scale_net_mod.dropout_keep_mask = lambda *a: fed.pop(0)
    try:
        state = cli.train_scale(argv + ["--device", "cpu"], max_steps=steps)
    finally:
        (cli.build_model_batch, cli.build_scalenet,
         scale_net_mod.dropout_keep_mask) = saved
    assert not fed, f"{len(fed)} dropout masks left unused"
    return state.model


class _F64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@contextlib.contextmanager
def jax_scalenet_in_f64():
    """The JAX ScaleNet evaluated in float64: under ``jax.enable_x64``,
    with the literal ``jnp.float32`` of its modules (the BatchNorms'
    dtype, the casts around them and of the head's inputs) read as
    ``float64`` in this process.  With a ``dtype=float64`` model and f64
    parameters and inputs, every op of its forward and backward is f64.
    No file of the JAX package changes."""
    import jax
    import jax.numpy as jnp

    from givepose_tpu.models import mobilenet, scale_net

    saved = mobilenet.jnp, scale_net.jnp
    mobilenet.jnp = scale_net.jnp = _F64Numpy(jnp)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        mobilenet.jnp, scale_net.jnp = saved


# the modules whose outputs step 1 compares, in forward order
LAYERS = [name for tower in ("feat_encoder_bbox", "feat_encoder_full")
          for name in (*(f"{tower}.{sub}" for sub in (
              "stem", "stem_bn", *(f"bneck{i}" for i in range(11)),
              "head", "head_bn")), tower)] + ["line1", "line2", "line3"]


def jax_step1(cfg, variables: dict, batch: dict, masks: list,
              f64: bool) -> dict:
    """The JAX ScaleNet's step-1 loss, prediction, the output of every
    layer of ``LAYERS`` and the gradients (port names), in f32 as the CLI
    runs it or in f64."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from givepose_torch.models.convert_from_flax import flax_to_state_dict
    from givepose_tpu.losses import scale_loss as jax_loss
    from givepose_tpu.models import ScaleNet as JaxScaleNet

    ctx = jax_scalenet_in_f64() if f64 else contextlib.nullcontext()
    with ctx:
        dt = jnp.float64 if f64 else jnp.float32

        def cast(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dt) if np.asarray(a).dtype.kind
                == "f" else jnp.asarray(a), tree)

        model = JaxScaleNet(feat_dim=cfg.model.feat_dim,
                            use_hw=cfg.model.use_hw, dtype=dt)
        jb, params, stats = (cast(batch), cast(variables["params"]),
                             cast(variables["batch_stats"]))
        feed = list(masks[:2])

        def fed_dropout(next_fun, args, kwargs, ctx):
            if not (isinstance(ctx.module, nn.Dropout)
                    and ctx.method_name == "__call__"):
                return next_fun(*args, **kwargs)
            keep = 1.0 - ctx.module.rate
            return jnp.where(jnp.asarray(feed.pop(0)), args[0] / keep, 0.0)

        def loss_fn(p):
            pred, mut = model.apply(
                {"params": p, "batch_stats": stats}, jb, train=True,
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=True)
            gt = jnp.linalg.norm(jb["real_size"], axis=1)
            return jax_loss(cfg.loss, pred, gt), (pred, mut["intermediates"])

        with nn.intercept_methods(fed_dropout):      # jitted, as the CLI
            (loss, (pred, inter)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
        acts = {}
        for name in LAYERS:
            node = inter
            for part in name.split("."):
                node = node[part]
            acts[name] = np.asarray(node["__call__"][0], np.float64)
        assert pred.dtype == dt and grads["line1"]["kernel"].dtype == dt
        grads = flax_to_state_dict({"params": jax.device_get(grads)},
                                   dtype=np.float64)
        return {"loss": float(loss), "pred": np.asarray(pred, np.float64),
                "acts": acts, "grads": {k: v.numpy()
                                        for k, v in grads.items()}}


def port_step1(cfg, variables: dict, batch: dict, masks: list,
               dtype) -> dict:
    """The port's ``jax_step1``: f32 as its CLI runs it, or a float64
    copy (parameters, buffers and every layer's ``compute_dtype``)."""
    import torch

    from givepose_torch.losses.pose_loss import scale_loss as port_loss
    from givepose_torch.models import scale_net as scale_net_mod
    from givepose_torch.models.convert_from_flax import flax_to_state_dict
    from givepose_torch.models.scale_net import build_scalenet

    net = build_scalenet(device="cpu",
                         state_dict=flax_to_state_dict(variables)).train()
    net = net.to(dtype)
    for m in net.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    acts = {}
    for name in LAYERS:
        net.get_submodule(name).register_forward_hook(
            lambda mod, inp, out, name=name: acts.__setitem__(
                name, out.detach().double().numpy()))
    tb = {k: torch.from_numpy(np.array(v)).to(
        dtype if np.asarray(v).dtype.kind == "f" else None)
        for k, v in batch.items()}
    fed = [torch.from_numpy(np.array(m)) for m in masks[:2]]
    saved = scale_net_mod.dropout_keep_mask
    scale_net_mod.dropout_keep_mask = lambda *a: fed.pop(0)
    try:
        pred = net(tb, train=True, generator=torch.Generator())
    finally:
        scale_net_mod.dropout_keep_mask = saved
    gt = torch.linalg.vector_norm(tb["real_size"], dim=1)
    loss = port_loss(cfg.loss, pred, gt)
    assert pred.dtype == loss.dtype == dtype
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return {"loss": loss.item(), "pred": pred.detach().double().numpy(),
            "acts": acts, "grads": {n: g.double().numpy()
                                    for n, g in zip(names, grads)}}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def stem_bn_statistics(x: np.ndarray) -> dict:
    """Train-mode BatchNorm's batch statistics of one f32 NHWC input (a
    stem's output, which both f32 sides compute alike), as
    ``flax.linen.BatchNorm(use_fast_variance=False)`` and the port's
    ``FlaxBatchNorm2d`` take them: the mean over N, H, W, then the mean
    of the squared deviations from it.  Each f32 side's mean and variance
    against the same two passes in f64, relative L2 over the channels;
    also the mean's size beside the deviations' (how much the
    subtraction amplifies the mean's error)."""
    import jax
    import jax.numpy as jnp
    import torch

    x = np.asarray(x, np.float32)
    x64 = x.astype(np.float64)
    mean64 = x64.mean(axis=(0, 1, 2))
    var64 = ((x64 - mean64) ** 2).mean(axis=(0, 1, 2))
    @jax.jit
    def flax_stats(x):
        mean = x.mean(axis=(0, 1, 2))
        return mean, jnp.mean(jnp.abs(x - mean) ** 2, axis=(0, 1, 2))

    jmean, jvar = flax_stats(jnp.asarray(x))
    tx = torch.from_numpy(x)
    tmean = tx.mean(dim=(0, 1, 2))
    d = tx - tmean
    tvar = (d * d).mean(dim=(0, 1, 2))
    return {"mean": {"jax_f32": _rel(jmean, mean64),
                     "port_f32": _rel(tmean, mean64)},
            "var": {"jax_f32": _rel(jvar, var64),
                    "port_f32": _rel(tvar, var64)},
            "mean_over_std": float(np.linalg.norm(mean64)
                                   / np.linalg.norm(np.sqrt(var64)))}


def first_step_against_f64(cfg, variables: dict, batch: dict,
                           masks: list) -> dict:
    """Step 1 (same weights, batch and dropout masks) in JAX f64, JAX f32,
    the port's f32 and the port's f64.  JAX's f64 evaluation is the
    truth: the port's f64 distance from it says whether the two compute
    the same function, and each f32 side's distance, layer by layer in
    forward order, says where its rounding departs and whose departs
    more.  All distances are relative L2."""
    import torch

    sides = {"jax_f64": jax_step1(cfg, variables, batch, masks, True),
             "jax_f32": jax_step1(cfg, variables, batch, masks, False),
             "port_f32": port_step1(cfg, variables, batch, masks,
                                    torch.float32),
             "port_f64": port_step1(cfg, variables, batch, masks,
                                    torch.float64)}
    truth = sides.pop("jax_f64")
    layers = []
    for name in LAYERS + ["pred"]:
        get = ((lambda s: s["pred"]) if name == "pred"
               else (lambda s, n=name: s["acts"][n]))
        row = {"layer": name}
        row.update({k: _rel(get(s), get(truth)) for k, s in sides.items()})
        row["port_f32_vs_jax_f32"] = _rel(get(sides["port_f32"]),
                                          get(sides["jax_f32"]))
        layers.append(row)

    def grad_err(g):
        num = sum(float(((g[n] - truth["grads"][n]) ** 2).sum())
                  for n in truth["grads"])
        den = sum(float((v ** 2).sum()) for v in truth["grads"].values())
        return float(np.sqrt(num / den))

    leaves = {n: {k: _rel(s["grads"][n], truth["grads"][n])
                  for k, s in sides.items()} for n in truth["grads"]}
    apart = next((r["layer"] for r in layers
                  if r["port_f32_vs_jax_f32"] > REL_TOL), None)
    first_unequal = next((r["layer"] for r in layers
                          if r["port_f32_vs_jax_f32"] > 0), None)
    stems = {tower: stem_bn_statistics(sides["jax_f32"]["acts"][
        f"{tower}.stem"]) for tower in ("feat_encoder_bbox",
                                        "feat_encoder_full")}
    return {"loss": {"jax_f64": truth["loss"],
                     **{k: s["loss"] for k, s in sides.items()}},
            "layers": layers,
            "first_layer_apart": apart,
            "first_layer_unequal": first_unequal,
            "stem_bn_statistics": stems,
            "grad_rel_err_all": {k: grad_err(s["grads"])
                                 for k, s in sides.items()},
            "leaves_port_f32_closer": sum(
                v["port_f32"] <= v["jax_f32"] for v in leaves.values()),
            "leaves": len(leaves)}


def print_step1(step1: dict) -> None:
    print("step 1 against JAX's f64 evaluation (relative L2):")
    print(f"  loss {step1['loss']}")
    print(f"  {'layer':<28} {'jax_f32':>10} {'port_f32':>10} "
          f"{'port_f64':>10} {'port-jax f32':>13}")
    for r in step1["layers"]:
        print(f"  {r['layer']:<28} {r['jax_f32']:10.3g} {r['port_f32']:10.3g}"
              f" {r['port_f64']:10.3g} {r['port_f32_vs_jax_f32']:13.3g}")
    print(f"  first layer where port f32 and JAX f32 differ: "
          f"{step1['first_layer_unequal']}; by more than {REL_TOL}: "
          f"{step1['first_layer_apart']}")
    print(f"  stems' BatchNorm statistics: {step1['stem_bn_statistics']}")
    print(f"  gradients: {step1['grad_rel_err_all']}, port f32 closer on "
          f"{step1['leaves_port_f32_closer']} of {step1['leaves']} leaves")


def losses(save: str) -> list:
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line)["scale_loss"] for line in f if line.strip()]


def eval_scale(data_dir: str, predict) -> dict:
    """Scale ratios on the test split and the present-class IoU25 /
    10°10cm with GT pose and size and the predicted scale
    (``tools/overfit_proof.py scale_on_gt_pose``)."""
    from givepose_torch.eval.load_eval import (NocsEvalReader,
                                               build_instance_batch)
    from overfit_proof import diagnostics, scale_ratios

    reader = NocsEvalReader("Real", data_dir)
    results, present = [], set()
    for i in range(len(reader)):
        image, det, cam_k = reader.read(i)
        batch, keep = build_instance_batch(image, det, cam_k, "Real",
                                           img_size=64, out_res=16,
                                           max_instances=4)
        s_pred = np.asarray(predict(batch), np.float64)[:len(keep)]
        out = dict(det)
        out["pred_RTs"] = np.tile(np.eye(4), (len(keep), 1, 1))
        out["pred_RTs"][:, :3, :] *= s_pred[:, None, None]
        out["pred_scales"] = np.zeros((len(keep), 3))
        for key in ("pred_class_ids", "pred_scores", "pred_bboxes"):
            out[key] = np.asarray(det[key])[keep]
        present.update(int(c) for c in det["gt_class_ids"])
        results.append(out)
    m = diagnostics(results, sorted(present))["scale_on_gt_pose"]
    return {"scale_ratio": scale_ratios(results), "IoU25": m["IoU25"],
            "10d10cm": m["10d10cm"]}


def run(seed: int, steps: int, out_json: str | None) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from givepose_torch.core.config import Config, parse_overrides
    from givepose_torch.data import synthetic as port_synth
    from givepose_torch.models.convert_from_flax import flax_to_state_dict
    from givepose_torch.models.scale_net import build_scalenet
    from givepose_tpu.data import synthetic as jax_synth
    from givepose_tpu.models import ScaleNet as JaxScaleNet
    from overfit_proof import N_IMAGES, common_flags

    torch.set_num_threads(2)
    root = tempfile.mkdtemp(prefix="scale_traj_")
    dirs = {}
    for name, mod in (("jax", jax_synth), ("port", port_synth)):
        r = os.path.join(root, name)
        dirs[name] = mod.make_synthetic_nocs(r, n_images=N_IMAGES,
                                             seed=seed, split="train",
                                             source="Real")
        mod.make_synthetic_eval(r, n_images=N_IMAGES, seed=seed)
    fixture_diffs = compare_fixtures(os.path.join(root, "jax"),
                                     os.path.join(root, "port"))
    print(f"fixture files that differ: {len(fixture_diffs)}")
    for d in fixture_diffs:
        print("  ", d)

    data_dir, ivfc_dir = dirs["jax"]
    flags = common_flags(data_dir, ivfc_dir, 64, 16, 1e-3, 2500, 10,
                         "cpu")
    flags = flags[:flags.index("--device")]          # not a JAX CLI flag
    save_j = os.path.join(root, "run_jax")
    save_t = os.path.join(root, "run_port")
    log = ["--log_every", "1"]
    cfg = parse_overrides(Config(), flags)
    freeze_at = int(cfg.train.bn_freeze_point * steps)

    t0 = time.time()
    init, batches, masks, jax_final = run_jax(
        flags + log + ["--model_save", save_j], steps)
    t_jax = time.time() - t0
    t0 = time.time()
    port_model = run_port(flags + log + ["--model_save", save_t], steps,
                          init, batches, masks, freeze_at)
    t_port = time.time() - t0

    lj, lt = losses(save_j), losses(save_t)
    first = next((i + 1 for i, (a, b) in enumerate(zip(lt, lj))
                  if abs(a - b) > REL_TOL * abs(b)), None)
    print(f"first step with |port - jax| > {REL_TOL} relative: {first}")
    print(f"{'step':>5} {'jax':>12} {'port':>12} {'rel':>10}")
    table = []
    for i in range(49, len(lj), 50):
        rel = abs(lt[i] - lj[i]) / max(abs(lj[i]), 1e-12)
        table.append([i + 1, lj[i], lt[i], rel])
        print(f"{i + 1:5d} {lj[i]:12.6g} {lt[i]:12.6g} {rel:10.3g}")

    step1 = first_step_against_f64(cfg, init, batches[1], masks)
    print_step1(step1)

    jax_model = JaxScaleNet(feat_dim=cfg.model.feat_dim,
                            use_hw=cfg.model.use_hw)

    def predict_jax(batch):
        return jax_model.apply(jax_final, {k: jnp.asarray(v)
                                           for k, v in batch.items()})

    @torch.no_grad()
    def predict_port(batch):
        return port_model({k: torch.from_numpy(v) for k, v in
                           batch.items()}).numpy()

    sides = {"jax": eval_scale(data_dir, predict_jax),
             "port": eval_scale(data_dir, predict_port)}
    # the final JAX state in the port's model: the two evaluations differ
    # only by the forward, not by the weights
    converted = build_scalenet(device="cpu",
                               state_dict=flax_to_state_dict(jax_final))

    @torch.no_grad()
    def predict_converted(batch):
        return converted({k: torch.from_numpy(v) for k, v in
                          batch.items()}).numpy()

    sides["jax_weights_port_forward"] = eval_scale(data_dir,
                                                   predict_converted)
    for name, side in (("jax", lj), ("port", lt)):
        sides[name]["final_scale_loss"] = side[-1]
        sides[name]["pass_iou25"] = sides[name]["IoU25"] >= 95.0
        sides[name]["pass_10d10cm"] = sides[name]["10d10cm"] >= 80.0
    for name, s in sides.items():
        print(f"{name}: ratios {np.round(s['scale_ratio'], 5).tolist()} "
              f"IoU25 {s['IoU25']:.1f} 10d10cm {s['10d10cm']:.1f}"
              + (f" final loss {s['final_scale_loss']:.6g}"
                 if "final_scale_loss" in s else ""))
    out = {"seed": seed, "train_seed": 0, "steps": steps,
           "freeze_at": freeze_at, "backend": "cpu",
           "fixture_diffs": fixture_diffs,
           "rel_tol": REL_TOL, "first_step_apart": first,
           "step1_against_jax_f64": step1,
           "jax_cli_step1_loss": lj[0],
           "every_50": table, "jax_losses": lj, "port_losses": lt,
           "sides": sides, "seconds": {"jax": t_jax, "port": t_port}}
    out_json = out_json or os.path.join(
        ROOT, f"OVERFIT_trajectory_cpu_seed{seed}.json")
    with open(out_json, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    run(a.seed, a.steps, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
