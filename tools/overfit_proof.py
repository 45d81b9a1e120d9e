#!/usr/bin/env python3
"""End-to-end learning proof of the PyTorch port: overfit PoseNet and the
ScaleNet on the synthetic fixture, then run the port's evaluation with
the trained weights.

The port's counterpart of ``benchmarks/overfit_proof.py``, with its
recipe: the same scenes are written to the train and test splits (same
seed), PoseNet (tiny ConvNeXt, 64² crops, 16² maps, f32) trains 2500
steps at batch 4 and the ScaleNet 800 with augmentation disabled, and
``cli.evaluate`` must then report near-perfect mAP from *predicted* poses
over the classes present.  Everything runs in this process, on the GPU
unless ``--device cpu`` is given.

    python3 tools/overfit_proof.py [--steps N] [--sn-steps N] [--seed S]
        [--train-seed T] [--pose-steps N] [--out FILE] [--device cuda|cpu]

``--seed`` draws the fixture; ``--train-seed`` (the CLIs' ``--seed``: the
sampler's stream, the initial weights, the dropout masks) is 0 in the
recipe; ``--pose-steps`` (default ``--steps``) stops PoseNet early while
the schedules stay those of ``--steps``, to measure the scale net alone
(its per-image scale ratios do not depend on PoseNet).  Writes
``OVERFIT_torch_seed<S>.json`` (or ``--out``): the final losses, the
absolute mAP, the present-class mAP with its pass flags (IoU25 >= 95,
10°10cm >= 80), GT-substitution diagnostics, each image's
predicted metric scale over the GT's, both CLIs' logged losses, the
backend and the card's name and power limit.  Exits 1 when a bar is
missed.

Before any CUDA work the run asks for repeatable arithmetic
(``deterministic_setup``): cuDNN's deterministic algorithms and no
benchmark-driven choice, cuBLAS's fixed workspace
(``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and PyTorch's deterministic
implementations where an op has one, with a warning where it has none.
So two ScaleNet trainings of one seed log equal losses on one card.  The
DCNv3 backward kernel (``csrc/dcnv3_bwd.cu``) still sums ``d_x`` by f32
atomics in no fixed order, so PoseNet's half varies between runs.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

IOU25_BAR = 95.0
DEG10_CM10_BAR = 80.0
N_IMAGES = 6


def card_line(device: str) -> str:
    if device != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def deterministic_setup() -> None:
    """Repeatable cuDNN, cuBLAS and PyTorch arithmetic for the run; call
    before the first model is built.  ``warn_only``: an op with no
    deterministic implementation (the DCNv3 backward's atomics are a
    custom op, which PyTorch cannot see) warns instead of raising."""
    import torch

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def loss_log(path: str, keys: tuple) -> list:
    """``[step, loss...]`` of every line of a CLI's ``metrics.jsonl``."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [[r.get("step")] + [r.get(k) for k in keys] for r in rows]


def common_flags(data_dir: str, ivfc_dir: str, img_size: int, out_res: int,
                 lr: float, steps: int, steps_per_epoch: int, device: str,
                 train_seed: int = 0) -> list:
    return [
        "--dataset", "Real",
        "--dataset_dir", data_dir,
        "--data.ivfc_dir", ivfc_dir,
        "--img_size", str(img_size),
        "--out_res", str(out_res),
        "--model.compute_dtype", "float32",
        # determinism for memorization: zero-jitter DZI (uniform with zero
        # ratios keeps the 1.5x pad the eval loader applies), no colour
        # augmentation, no mask deformation; eval crops go through the
        # same resampler arithmetic as training (ops/resample.py)
        "--DZI_TYPE", "uniform",
        "--DZI_SCALE_RATIO", "0",
        "--DZI_SHIFT_RATIO", "0",
        "--color_aug_prob", "0",
        "--data.roi_mask_pro", "0",
        "--batch_size", "4",
        "--train_size", str(N_IMAGES * steps_per_epoch),
        "--warmup_iters", "20",
        "--lr", str(lr),
        "--total_epoch", str(max(1, steps // steps_per_epoch)),
        "--save_every", "1000000",
        "--train.seed", str(train_seed),
        "--device", device,
    ]


def present_map(iou_aps, pose_aps, rows) -> dict:
    iou_aps, pose_aps = np.asarray(iou_aps), np.asarray(pose_aps)
    return {
        "IoU25": float(np.mean(iou_aps[rows, 1])) * 100,
        "IoU50": float(np.mean(iou_aps[rows, 2])) * 100,
        "IoU75": float(np.mean(iou_aps[rows, 3])) * 100,
        "5d5cm": float(np.mean(pose_aps[rows, 0, 0])) * 100,
        "10d10cm": float(np.mean(pose_aps[rows, 1, 1])) * 100,
        "10d": float(np.mean(pose_aps[rows, 1, -1])) * 100,
        "10cm": float(np.mean(pose_aps[rows, -1, 1])) * 100,
    }


def scale_ratios(results) -> list:
    """Each image's predicted metric scale over the GT's (the cube root of
    the determinant of the sRT's rotation block)."""
    out = []
    for r in results:
        for pred, gt in zip(r["pred_RTs"], r["gt_RTs"]):
            s_pred = np.cbrt(np.linalg.det(pred[:3, :3]))
            s_gt = np.cbrt(np.linalg.det(np.asarray(gt)[:3, :3]))
            out.append(float(s_pred / s_gt))
    return out


def diagnostics(results, rows) -> dict:
    """Re-score the cached predictions with GT substituted for one factor
    at a time (the scale net's metric scale, the size head's extents, the
    whole pose), isolating which term limits IoU.  The fixture has one
    instance per image and GT as detections, so pred i matches gt i."""
    from givepose_torch.eval.harness import compute_degree_cm_map
    from givepose_torch.eval.metrics import SYNSET_NAMES

    def rescore(make_variant):
        variant = []
        for r in results:
            r2 = copy.deepcopy(r)
            make_variant(r2)
            variant.append(r2)
        iou_aps, pose_aps = compute_degree_cm_map(
            variant, SYNSET_NAMES, (5, 10, 360), (5, 10, 1e4),
            (0.1, 0.25, 0.5, 0.75), iou_pose_thres=0.1,
            use_matches_for_pose=True)
        m = present_map(iou_aps, pose_aps, rows)
        return {k: m[k] for k in ("IoU25", "IoU50", "IoU75", "10d10cm")}

    def sub_gt_scale(r):
        n = min(len(r["pred_RTs"]), len(r["gt_RTs"]))
        for i in range(n):
            s_pred = np.cbrt(np.linalg.det(r["pred_RTs"][i, :3, :3]))
            s_gt = np.cbrt(np.linalg.det(r["gt_RTs"][i][:3, :3]))
            r["pred_RTs"][i, :3, :] *= s_gt / max(s_pred, 1e-8)

    def sub_gt_size(r):
        n = min(len(r["pred_scales"]), len(r["gt_scales"]))
        r["pred_scales"][:n] = np.asarray(r["gt_scales"])[:n]

    def sub_gt_pose(r):
        n = min(len(r["pred_RTs"]), len(r["gt_RTs"]))
        r["pred_RTs"][:n] = np.asarray(r["gt_RTs"])[:n]

    return {
        "gt_scale": rescore(sub_gt_scale),
        "gt_size": rescore(sub_gt_size),
        "gt_scale_and_size": rescore(lambda r: (sub_gt_scale(r),
                                                sub_gt_size(r))),
        "gt_pose_and_scale": rescore(sub_gt_pose),
    }


def run(steps: int = 2500, sn_steps: int = 800, seed: int = 0,
        out_json: str | None = None, device: str = "cuda",
        train_seed: int = 0, pose_steps: int | None = None,
        steps_per_epoch: int = 10, lr: float = 1e-3, img_size: int = 64,
        out_res: int = 16) -> dict:
    import torch

    from givepose_torch.cli.evaluate import evaluate
    from givepose_torch.cli.train import train
    from givepose_torch.cli.train_scale import train_scale
    from givepose_torch.core.checkpoint import latest_checkpoint
    from givepose_torch.data.synthetic import (make_synthetic_eval,
                                               make_synthetic_nocs)

    deterministic_setup()
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available (pass --device cpu)")
    out_json = out_json or f"OVERFIT_torch_seed{seed}.json"
    root = tempfile.mkdtemp(prefix="overfit_")
    # identical scenes in both splits: the same seed draws the same scenes
    data_dir, ivfc_dir = make_synthetic_nocs(root, n_images=N_IMAGES,
                                             seed=seed, split="train",
                                             source="Real")
    make_synthetic_eval(root, n_images=N_IMAGES, seed=seed)
    common = common_flags(data_dir, ivfc_dir, img_size, out_res, lr, steps,
                          steps_per_epoch, device, train_seed)
    pose_steps = pose_steps or steps
    save = os.path.join(root, "run")
    sn_save = os.path.join(root, "run_sn")
    times = {}

    t0 = time.time()
    train(common + ["--model_save", save, "--log_every",
                    str(min(50, pose_steps))],
          max_steps=pose_steps, backbone_variant="tiny")
    times["pose_s"] = time.time() - t0
    with open(os.path.join(save, "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    final_loss = last.get("total_loss", float("nan"))
    print(f"final train loss after {pose_steps} steps: {final_loss:.4f}")

    t0 = time.time()
    train_scale(common + ["--model_save", sn_save, "--log_every",
                          str(min(50, sn_steps))], max_steps=sn_steps)
    times["scale_s"] = time.time() - t0
    with open(os.path.join(sn_save, "metrics.jsonl")) as f:
        sn_last = json.loads(f.readlines()[-1])

    sn_ckpts = sorted((d for d in os.listdir(sn_save)
                       if d.startswith("scale_ckpt_")),
                      key=lambda d: int(d.split("_")[-1]))
    t0 = time.time()
    summary = evaluate(
        common + ["--model_save", os.path.join(root, "eval_out"),
                  "--eval.max_instances", "4",
                  "--resume_model", latest_checkpoint(save),
                  "--sn_path", os.path.join(sn_save, sn_ckpts[-1])],
        backbone_variant="tiny")
    times["eval_s"] = time.time() - t0
    absolute = summary["absolute"]
    print("absolute mAP:", absolute)

    # the harness means over ALL 6 categories (reference convention); the
    # fixture instantiates a few, so the pass metric is the mean over the
    # categories that appear
    present = set()
    scene = os.path.join(data_dir, "Real/test/scene_1")
    for fn in sorted(os.listdir(scene)):
        if fn.endswith("_label.pkl"):
            with open(os.path.join(scene, fn), "rb") as f:
                present.update(int(c) for c in pickle.load(f)["class_ids"])
    rows = sorted(present)
    present_mAP = present_map(summary["iou_aps"], summary["pose_aps"], rows)
    print("present-class mAP:", present_mAP)

    cache = glob.glob(os.path.join(root, "eval_out", "eval_result_*",
                                   "pred_result.pkl"))[0]
    with open(cache, "rb") as f:
        results = pickle.load(f)
    diag = diagnostics(results, rows)
    ratios = scale_ratios(results)
    print("predicted / GT metric scale per image:", ratios)
    print("diagnostics (GT-substitution bisection):")
    for k, v in diag.items():
        print(f"  {k}: {v}")

    out = {
        "backend": device,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
        "card": card_line(device),
        "steps": pose_steps,
        "sn_steps": sn_steps,
        "final_loss": float(final_loss),
        "final_scale_loss": float(sn_last.get("scale_loss", float("nan"))),
        "pose_loss_log": loss_log(os.path.join(save, "metrics.jsonl"),
                                  ("total_loss",)),
        "scale_loss_log": loss_log(os.path.join(sn_save, "metrics.jsonl"),
                                   ("scale_loss",)),
        "absolute_mAP": absolute,
        "seed": seed,
        "train_seed": train_seed,
        "present_classes": rows,
        "present_class_mAP": present_mAP,
        "diagnostics": diag,
        "scale_ratio": ratios,
        "seconds": times,
        "pass_iou25": present_mAP["IoU25"] >= IOU25_BAR,
        "pass_10d10cm": present_mAP["10d10cm"] >= DEG10_CM10_BAR,
    }
    with open(out_json, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--sn-steps", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-seed", type=int, default=0)
    p.add_argument("--pose-steps", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    out = run(a.steps, a.sn_steps, a.seed, a.out, a.device, a.train_seed,
              a.pose_steps)
    return 0 if out["pass_iou25"] and out["pass_10d10cm"] else 1


if __name__ == "__main__":
    sys.exit(main())
