"""mAP aggregation harness.

The port's own copy of ``givepose_tpu/eval/harness.py`` (numpy only).

Mirrors compute_degree_cm_mAP (evaluation/eval_utils_cass.py:490-820):
per image and class, match predictions to ground truth by 3D IoU and by
degree/cm error, accumulate match vectors, then VOC-AP per class and mean
over classes.  ``use_matches_for_pose`` filters pose candidates to those
IoU-matched at ``iou_pose_thres`` (reference :606-620).

Input: a list of per-image result dicts with the same keys the reference
caches into pred_result.pkl (evaluation/evaluate.py:128-133):
  gt_class_ids, gt_RTs, gt_scales, gt_handle_visibility,
  pred_class_ids, pred_scores, pred_RTs, pred_scales, pred_bboxes.
"""

from __future__ import annotations

import numpy as np

from givepose_torch.eval.metrics import (
    SYNSET_NAMES,
    match_degree_cm,
    match_iou,
    pairwise_3d_iou,
    pairwise_degree_cm,
    voc_ap,
)


def compute_degree_cm_map(results, synset_names=None,
                          degree_thresholds=(5, 10, 360),
                          shift_thresholds=(5, 10, 1e4),
                          iou_3d_thresholds=(0.1, 0.25, 0.5, 0.75),
                          iou_pose_thres=0.1,
                          use_matches_for_pose=True):
    """Returns (iou_aps (C+1, n_iou), pose_aps (C+1, n_deg, n_shift)).

    Index -1 of the class axis is the mean over classes 1..C-1, matching
    the reference layout (:515-523, :687, :733).
    """
    synset_names = synset_names or SYNSET_NAMES
    n_cls = len(synset_names)
    degree_thrs = list(degree_thresholds) + [360]
    shift_thrs = list(shift_thresholds) + [100000]
    iou_thrs = list(iou_3d_thresholds)
    nd, ns, ni = len(degree_thrs), len(shift_thrs), len(iou_thrs)

    iou_pred_all = [[] for _ in range(n_cls)]
    iou_score_all = [[] for _ in range(n_cls)]
    iou_gt_all = [[] for _ in range(n_cls)]
    pose_pred_all = [[] for _ in range(n_cls)]
    pose_score_all = [[] for _ in range(n_cls)]
    pose_gt_all = [[] for _ in range(n_cls)]

    for res in results:
        gt_cls = np.asarray(res["gt_class_ids"], np.int32)
        gt_rts = np.asarray(res["gt_RTs"], np.float64).reshape(-1, 4, 4)
        gt_scales = np.asarray(res["gt_scales"],
                               np.float64).reshape(-1, 3)
        gt_hv = np.asarray(res["gt_handle_visibility"]).reshape(-1)
        pr_cls = np.asarray(res["pred_class_ids"], np.int32)
        pr_scores = np.asarray(res["pred_scores"], np.float64)
        pr_rts = np.asarray(res["pred_RTs"], np.float64).reshape(-1, 4, 4)
        pr_scales = np.asarray(res["pred_scales"],
                               np.float64).reshape(-1, 3)
        boxes = np.asarray(res.get("pred_bboxes", ()))
        if len(pr_cls) and boxes.ndim == 2 and len(boxes) == len(pr_cls):
            # reference compute_3d_matches trims zero-padded detection
            # rows before matching (eval_utils_cass.py:277-279) — keeps
            # third-party result pickles with padded arrays comparable
            keep = ~np.all(boxes == 0, axis=1)
            pr_cls, pr_scores = pr_cls[keep], pr_scores[keep]
            pr_rts, pr_scales = pr_rts[keep], pr_scales[keep]
        if len(gt_cls) == 0 and len(pr_cls) == 0:
            continue

        for cid in range(1, n_cls):
            g_sel = gt_cls == cid
            p_sel = pr_cls == cid
            cg_rts, cg_scales = gt_rts[g_sel], gt_scales[g_sel]
            cg_cls = gt_cls[g_sel]
            if synset_names[cid] != "mug":
                cg_hv = np.ones(g_sel.sum())
            else:
                cg_hv = gt_hv[g_sel]
            cp_rts, cp_scales = pr_rts[p_sel], pr_scales[p_sel]
            cp_cls, cp_scores = pr_cls[p_sel], pr_scores[p_sel]

            # sort preds by score desc (reference :276-287)
            order = np.argsort(cp_scores)[::-1]
            cp_rts, cp_scales = cp_rts[order], cp_scales[order]
            cp_cls, cp_scores = cp_cls[order], cp_scores[order]

            iou = pairwise_3d_iou(cp_rts, cp_scales, cg_rts, cg_scales,
                                  cp_cls, cg_cls, cg_hv)
            gt_m, pred_m = match_iou(iou, cp_cls, cg_cls, cp_scores,
                                     iou_thrs)
            iou_pred_all[cid].append(pred_m)
            iou_score_all[cid].append(np.tile(cp_scores, (ni, 1)))
            iou_gt_all[cid].append(gt_m)

            if use_matches_for_pose:
                ti = iou_thrs.index(iou_pose_thres)
                keep = pred_m[ti] > -1
                cp_rts, cp_scores = cp_rts[keep], cp_scores[keep]
                cp_cls = cp_cls[keep]

            rt_err = pairwise_degree_cm(cp_rts, cg_rts, cg_cls, cg_hv)
            pose_gt_m, pose_pred_m = match_degree_cm(
                rt_err, cp_cls, cg_cls, degree_thrs, shift_thrs)
            pose_pred_all[cid].append(pose_pred_m)
            pose_score_all[cid].append(
                np.tile(cp_scores, (nd, ns, 1)))
            pose_gt_all[cid].append(pose_gt_m)

    iou_aps = np.zeros((n_cls + 1, ni))
    pose_aps = np.zeros((n_cls + 1, nd, ns))
    for cid in range(1, n_cls):
        pm = (np.concatenate(iou_pred_all[cid], axis=-1)
              if iou_pred_all[cid] else np.zeros((ni, 0)))
        sc = (np.concatenate(iou_score_all[cid], axis=-1)
              if iou_score_all[cid] else np.zeros((ni, 0)))
        gm = (np.concatenate(iou_gt_all[cid], axis=-1)
              if iou_gt_all[cid] else np.zeros((ni, 0)))
        for s in range(ni):
            iou_aps[cid, s] = voc_ap(pm[s], sc[s], gm[s])

        ppm = (np.concatenate(pose_pred_all[cid], axis=-1)
               if pose_pred_all[cid] else np.zeros((nd, ns, 0)))
        psc = (np.concatenate(pose_score_all[cid], axis=-1)
               if pose_score_all[cid] else np.zeros((nd, ns, 0)))
        pgm = (np.concatenate(pose_gt_all[cid], axis=-1)
               if pose_gt_all[cid] else np.zeros((nd, ns, 0)))
        for d in range(nd):
            for s in range(ns):
                pose_aps[cid, d, s] = voc_ap(ppm[d, s], psc[d, s],
                                             pgm[d, s])
    iou_aps[-1] = iou_aps[1:n_cls].mean(axis=0)
    pose_aps[-1] = pose_aps[1:n_cls].mean(axis=0)
    return iou_aps, pose_aps


def scale_normalize_results(results):
    """Second-pass normalization (reference evaluate.py:214-227): divide
    the top 3 rows of every RT by cbrt(det R) so thresholds become
    diameter-relative."""
    out = []
    for res in results:
        r = dict(res)
        for key in ("gt_RTs", "pred_RTs"):
            rts = np.array(r[key], np.float64).reshape(-1, 4, 4).copy()
            if len(rts):
                s = np.cbrt(np.linalg.det(rts[:, :3, :3]))
                rts[:, :3, :] = rts[:, :3, :] / s[:, None, None]
            r[key] = rts
        out.append(r)
    return out


def summarize(iou_aps, pose_aps, degree_thrs, shift_thrs, iou_thrs,
              cls_idx=-1) -> dict:
    """The reference's headline numbers (evaluate.py:162-201)."""
    d = list(degree_thrs) + [360]
    s = list(shift_thrs) + [100000]
    i = list(iou_thrs)
    get = lambda arr, *ix: float(arr[ix]) * 100

    out = {}
    for thr in (0.25, 0.5, 0.75):
        if thr in i:
            out[f"IoU{int(thr*100)}"] = get(iou_aps, cls_idx, i.index(thr))
    pairs = [(5, 5), (10, 5), (10, 10), (5, 20), (10, 20), (10, 50)]
    for dd, ss in pairs:
        if dd in d and ss in s:
            out[f"{dd}d{ss}cm"] = get(pose_aps, cls_idx, d.index(dd),
                                      s.index(ss))
    if 10 in d:
        out["10d"] = get(pose_aps, cls_idx, d.index(10), len(s) - 1)
    if 10 in s:
        out["10cm"] = get(pose_aps, cls_idx, len(d) - 1, s.index(10))
    return out
