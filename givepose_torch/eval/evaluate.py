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
there too.  With ``eval.use_umeyama`` the pose comes instead from a
RANSAC-Umeyama fit of the predicted NOCS map to the image's depth
(``eval/umeyama_pose.py``), its hypotheses drawn from one generator on
the models' device, seeded once from ``train.seed``.  With
``eval_precise`` and ``eval.result_dir``, the AP curves are drawn into
``mAP.png`` beside ``mAP_Acc.pkl`` (``eval/visualize.py``).
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
from givepose_torch.eval.umeyama_pose import umeyama_pose_from_maps
from givepose_torch.eval.visualize import plot_map_curves


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


def make_umeyama_inference_fn(model, is_wild6d: bool = False):
    """``infer(batch, generator) -> (rt (B,4,4), size (B,3))``: the pose
    from a RANSAC-Umeyama similarity fit of the predicted NOCS map to the
    backprojected depth crop (reference tools/umeyama.py:17-60), one call
    for the batch, its hypotheses drawn from ``generator``.  The size
    stays the network's, unit-norm.  sRT in the NOCS convention:
    RT[:3,:3] = s*R, RT[:3,3] = t."""

    @torch.inference_mode()
    def infer(batch: dict, generator: torch.Generator
              ) -> tuple[torch.Tensor, torch.Tensor]:
        out = model(batch, is_wild6d=is_wild6d)
        nocs = out["nocs_coor"].float()                  # (B, R, R, 3)
        # absolute pixels from the normalized roi_coord_2d grid
        imh = batch["im_hw"][:, 0][:, None, None]
        imw = batch["im_hw"][:, 1][:, None, None]
        px = (batch["roi_coord_2d"][..., 0] * (imw - 1) + (imw - 1)) * 0.5
        py = (batch["roi_coord_2d"][..., 1] * (imh - 1) + (imh - 1)) * 0.5
        fit = umeyama_pose_from_maps(
            nocs, px, py, batch["roi_depth"], batch["roi_mask_out"],
            batch["cam_K"].float(), generator=generator)
        b = nocs.shape[0]
        rt = torch.zeros((b, 4, 4), dtype=torch.float32, device=nocs.device)
        rt[:, :3, :3] = fit["rotation"] * fit["scale"][:, None, None]
        rt[:, :3, 3] = fit["translation"]
        rt[:, 3, 3] = 1.0
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
    to.  With ``eval.use_umeyama`` an image without depth is skipped, as
    the reference does, and the ScaleNet does not run."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    per_obj_id = None
    if cfg.data.per_obj in SYNSET_NAMES[1:]:
        per_obj_id = SYNSET_NAMES.index(cfg.data.per_obj)

    device = next(model.parameters()).device
    use_umeyama = cfg.eval.use_umeyama
    if use_umeyama:
        infer_um = make_umeyama_inference_fn(model, is_wild6d)
        generator = torch.Generator(device=device).manual_seed(
            cfg.train.seed)

        def infer(batch):
            return infer_um(batch, generator)
    else:
        infer = make_inference_fn(model, scale_model,
                                  cfg.model.use_scale_net, is_wild6d)
    results = []
    for i in range(len(reader)):
        item = reader.read(i)
        if item is None:
            continue
        image, det, cam_k = item
        depth = None
        if use_umeyama:
            depth = reader.read_depth(i)
            if depth is None:
                continue   # reference skips images without depth
        built = build_instance_batch(
            image, det, cam_k, source, img_size=cfg.data.img_size,
            out_res=cfg.data.out_res, pad_scale=cfg.data.dzi_pad_scale,
            max_instances=cfg.eval.max_instances,
            resize_full=cfg.model.resize_full, per_obj_id=per_obj_id,
            depth=depth)
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

    # plot only full-resolution curves (the sparse default threshold
    # lists carry 360deg/1e4cm sentinels that would render as 3-point
    # lines; the reference only plots the precise sweep)
    if cfg.eval.result_dir and cfg.eval.eval_precise:
        png_path = plot_map_curves(iou_aps, pose_aps, cfg.eval.result_dir,
                                   iou_thrs, degree_thrs, shift_thrs)
        log(f"AP curves: {png_path}")
    return {"absolute": absolute, "relative": relative,
            "iou_aps": iou_aps, "pose_aps": pose_aps}
