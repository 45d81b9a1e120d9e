"""Evaluation: inference -> pred_RT assembly -> two-pass mAP.

Port of ``givepose_tpu/eval/evaluate.py`` (reference
evaluation/evaluate.py:27-283): per-image inference with the scale net
(pred_RT[:, :3, :] *= scale, :120-126), pred_result.pkl caching
(:135-136), then an absolute-threshold mAP pass (5°5cm / 10°5cm /
10°10cm + IoU25/50/75, :141-203) and a scale-normalized pass (thresholds
as % of diameter, :205-283).

Every image's instances run as one padded batch (``max_instances``
slots, the JAX package's static shape) on the models' device, under
``torch.inference_mode``; the rot/trans/size assembly and the scale run
there too.  The depth-assisted Umeyama pose (``eval.use_umeyama``) and
the AP curve plot of ``eval_precise`` are not ported yet and raise.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from givepose_torch.core.config import Config
from givepose_torch.eval.harness import (
    compute_degree_cm_map,
    scale_normalize_results,
    summarize,
)
from givepose_torch.eval.load_eval import build_instance_batch
from givepose_torch.eval.metrics import SYNSET_NAMES


def make_inference_fn(model, scale_model, use_scale_net: bool,
                      is_wild6d: bool = False):
    """``infer(batch) -> (rt (B,4,4), size (B,3))`` for a batch of tensors
    on the models' device: PoseNet's pose with the ScaleNet's metric
    scale folded into the top rows (sRT convention), and the unit-norm
    size.  Without ``use_scale_net`` the scale is 1 and ScaleNet does not
    run."""

    @torch.inference_mode()
    def infer(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        out = model(batch, is_wild6d=is_wild6d)
        b = out["rot"].shape[0]
        if use_scale_net:
            scale = scale_model(batch).float()
        else:
            scale = torch.ones((b,), dtype=torch.float32,
                               device=out["rot"].device)
        rt = torch.zeros((b, 4, 4), dtype=torch.float32,
                         device=out["rot"].device)
        rt[:, :3, :3] = out["rot"]
        rt[:, :3, 3] = out["trans"]
        rt[:, 3, 3] = 1.0
        # fold the metric scale into the top rows
        # (reference evaluate.py:125: sRT convention)
        rt[:, :3, :] *= scale[:, None, None]
        size = out["size"].float()
        size = size / torch.linalg.vector_norm(size, dim=1, keepdim=True)
        return rt, size

    return infer


def run_inference(reader, model, scale_model, cfg: Config,
                  source: str = "Real", is_wild6d: bool = False,
                  cache_path: str | None = None, progress=None):
    """Returns the list of per-image result dicts (detection dict +
    pred_RTs/pred_scales), reading the cache if present.  ``model`` and
    ``scale_model`` are in eval mode on one device, which the batches go
    to."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    if cfg.eval.use_umeyama:
        raise NotImplementedError(
            "eval.use_umeyama (the depth-assisted RANSAC-Umeyama pose, "
            "geometry/umeyama.py) is not ported yet (ROADMAP queue A, "
            "item 8)")

    per_obj_id = None
    if cfg.data.per_obj in SYNSET_NAMES[1:]:
        per_obj_id = SYNSET_NAMES.index(cfg.data.per_obj)

    device = next(model.parameters()).device
    infer = make_inference_fn(model, scale_model, cfg.model.use_scale_net,
                              is_wild6d)
    results = []
    for i in range(len(reader)):
        item = reader.read(i)
        if item is None:
            continue
        image, det, cam_k = item
        built = build_instance_batch(
            image, det, cam_k, source, img_size=cfg.data.img_size,
            out_res=cfg.data.out_res, pad_scale=cfg.data.dzi_pad_scale,
            max_instances=cfg.eval.max_instances,
            resize_full=cfg.model.resize_full, per_obj_id=per_obj_id)
        out = dict(det)
        if built is None:
            # keep ALL pred_* keys consistent at length 0 (the reference
            # builds one coherent empty dict, evaluation/evaluate.py:105-108;
            # leaving class_ids at full length crashes the matcher)
            out["pred_RTs"] = np.zeros((0, 4, 4))
            out["pred_scales"] = np.zeros((0, 3))
            out["pred_class_ids"] = np.zeros((0,), np.int32)
            out["pred_scores"] = np.zeros((0,), np.float32)
            out["pred_bboxes"] = np.zeros((0, 4), np.float32)
            results.append(out)
            continue
        batch, keep = built
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        rts, sizes = infer(tb)
        n = len(keep)
        out["pred_RTs"] = rts.cpu().numpy()[:n]
        out["pred_scales"] = sizes.cpu().numpy()[:n]
        for key in ("pred_class_ids", "pred_scores", "pred_bboxes"):
            out[key] = np.asarray(det[key])[keep]
        results.append(out)
        if progress and (i % 50 == 0):
            progress(i, len(reader))

    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(results, f)
    return results


def evaluate_results(results, cfg: Config, log=print):
    """Two-pass mAP reporting (reference evaluate.py:141-283)."""
    if cfg.eval.eval_precise:
        degree_thrs = tuple(range(0, 71, 1))
        shift_thrs = tuple(i / 2 for i in range(51))
        iou_thrs = tuple(i / 100 for i in range(101))
    else:
        degree_thrs = (5, 10, 360)
        shift_thrs = (5, 10, 1e4)
        iou_thrs = (0.1, 0.25, 0.5, 0.75)
    if cfg.eval.result_dir and cfg.eval.eval_precise:
        # the JAX package plots the precise sweep's AP curves here
        # (eval/visualize.py, matplotlib, which the GPU machine lacks)
        raise NotImplementedError(
            "the AP curve plot of eval_precise with eval.result_dir "
            "(eval/visualize.py) is not ported yet (ROADMAP queue A, "
            "item 8); unset eval.result_dir")

    cls_idx = -1
    if cfg.data.per_obj in SYNSET_NAMES:
        cls_idx = SYNSET_NAMES.index(cfg.data.per_obj)

    iou_aps, pose_aps = compute_degree_cm_map(
        results, SYNSET_NAMES, degree_thrs, shift_thrs, iou_thrs,
        iou_pose_thres=0.1,
        use_matches_for_pose=cfg.eval.use_match_for_pose)
    absolute = summarize(iou_aps, pose_aps, degree_thrs, shift_thrs,
                         iou_thrs, cls_idx)
    log("absolute mAP: " + ", ".join(f"{k}={v:.1f}"
                                     for k, v in absolute.items()))

    # pass 2: scale-normalized (relative) thresholds
    if cfg.eval.eval_precise:
        degree_thrs2 = tuple(range(0, 61, 1))
        shift_thrs2 = tuple(range(51))
    else:
        degree_thrs2 = (5, 10)
        shift_thrs2 = (5, 10, 20, 50)
    normed = scale_normalize_results(results)
    iou_aps2, pose_aps2 = compute_degree_cm_map(
        normed, SYNSET_NAMES, degree_thrs2, shift_thrs2, iou_thrs,
        iou_pose_thres=0.1,
        use_matches_for_pose=cfg.eval.use_match_for_pose)
    relative = summarize(iou_aps2, pose_aps2, degree_thrs2, shift_thrs2,
                         iou_thrs, cls_idx)
    log("scale-normalized mAP (shift in % of diameter): "
        + ", ".join(f"{k}={v:.1f}" for k, v in relative.items()))
    return {"absolute": absolute, "relative": relative,
            "iou_aps": iou_aps, "pose_aps": pose_aps}
