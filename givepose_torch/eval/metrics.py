"""Pose-evaluation metrics: batched 3D IoU and degree/cm errors.

The port's own copy of ``givepose_tpu/eval/metrics.py`` (numpy only; the
port imports nothing of the JAX package).

Reference: evaluation/eval_utils_cass.py — compute_3d_iou_new (:35-97,
pure-python per pair with a 20-iteration symmetry loop),
compute_RT_degree_cm_symmetry (:100-175).  Here both are vectorized over
(pred, gt[, rotation]) with numpy broadcasting, so the per-image
pairwise matrices are a handful of einsums instead of O(P*G*20) Python
iterations.  Greedy matching and VOC AP integration (inherently
sequential, tiny) stay on host: compute_3d_matches (:260-333),
compute_match_from_degree_cm (:445-487), compute_ap_from_matches_scores
(:336-362).
"""

from __future__ import annotations

import math

import numpy as np

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]
_Y_SYM_CLASSES = {"bottle", "bowl", "can"}


def box_corners(scales: np.ndarray) -> np.ndarray:
    """(..., 3) sizes -> (..., 3, 8) corner matrix (reference get_3d_bbox,
    :178-207)."""
    s = np.asarray(scales, np.float64) / 2.0
    signs = np.array([[1, 1, 1], [1, 1, -1], [-1, 1, 1], [-1, 1, -1],
                      [1, -1, 1], [1, -1, -1], [-1, -1, 1], [-1, -1, -1]],
                     np.float64)
    corners = s[..., None, :] * signs          # (..., 8, 3)
    return np.swapaxes(corners, -1, -2)        # (..., 3, 8)


def transform_corners(corners: np.ndarray, rts: np.ndarray) -> np.ndarray:
    """Apply (..., 4, 4) homogeneous transforms to (..., 3, 8) corners."""
    r = rts[..., :3, :3]
    t = rts[..., :3, 3:4]
    w = rts[..., 3:4, :3] @ corners + rts[..., 3:4, 3:4]
    return (r @ corners + t) / w


def _y_rotation_bank(n: int = 20) -> np.ndarray:
    theta = 2 * math.pi * np.arange(n) / n
    c, s = np.cos(theta), np.sin(theta)
    out = np.zeros((n, 4, 4))
    out[:, 0, 0] = c
    out[:, 0, 2] = s
    out[:, 1, 1] = 1
    out[:, 2, 0] = -s
    out[:, 2, 2] = c
    out[:, 3, 3] = 1
    return out


def _aabb_iou(bbox1_min, bbox1_max, bbox2_min, bbox2_max):
    """Axis-aligned IoU with the reference's empty-overlap rule (:59-68)."""
    omin = np.maximum(bbox1_min, bbox2_min)
    omax = np.minimum(bbox1_max, bbox2_max)
    gap = omax - omin
    inter = np.where(np.min(gap, axis=-1) < 0, 0.0,
                     np.prod(gap, axis=-1))
    vol1 = np.prod(bbox1_max - bbox1_min, axis=-1)
    vol2 = np.prod(bbox2_max - bbox2_min, axis=-1)
    return inter / (vol1 + vol2 - inter)


def pairwise_3d_iou(pred_rts, pred_scales, gt_rts, gt_scales,
                    pred_classes, gt_classes, gt_handle_vis,
                    num_sym_rot: int = 20) -> np.ndarray:
    """(P, G) IoU matrix matching compute_3d_iou_new semantics.

    real_iou=True convention (the reference default, config.py:94): AABB
    extents are taken over the 8 transformed corners per box.  For matched
    y-symmetric classes the max over ``num_sym_rot`` pre-rotations of the
    pred box is used.
    """
    p, g = len(pred_classes), len(gt_classes)
    if p == 0 or g == 0:
        return np.zeros((p, g))
    bank = _y_rotation_bank(num_sym_rot)        # (R, 4, 4)

    gt_c = transform_corners(box_corners(gt_scales), gt_rts)   # (G, 3, 8)
    gt_min, gt_max = gt_c.min(-1), gt_c.max(-1)                # (G, 3)

    pred_c = transform_corners(box_corners(pred_scales), pred_rts)
    pred_min, pred_max = pred_c.min(-1), pred_c.max(-1)        # (P, 3)
    base_iou = _aabb_iou(pred_min[:, None], pred_max[:, None],
                         gt_min[None, :], gt_max[None, :])     # (P, G)

    # symmetric pairs: rotate pred RT by the bank then AABB again
    pred_rts_rot = pred_rts[:, None] @ bank[None]              # (P, R, 4, 4)
    rot_c = transform_corners(box_corners(pred_scales)[:, None],
                              pred_rts_rot)                    # (P, R, 3, 8)
    rot_min, rot_max = rot_c.min(-1), rot_c.max(-1)            # (P, R, 3)
    sym_iou = _aabb_iou(rot_min[:, None, :], rot_max[:, None, :],
                        gt_min[None, :, None], gt_max[None, :, None])
    sym_iou = sym_iou.max(-1)                                  # (P, G)

    pn = np.array([SYNSET_NAMES[c] for c in pred_classes])
    gn = np.array([SYNSET_NAMES[c] for c in gt_classes])
    same = pn[:, None] == gn[None, :]
    is_sym = np.isin(pn, list(_Y_SYM_CLASSES))[:, None] & same
    mug_nohandle = ((pn == "mug")[:, None] & same
                    & (np.asarray(gt_handle_vis) == 0)[None, :])
    use_sym = is_sym | mug_nohandle
    return np.where(use_sym, sym_iou, base_iou)


def pairwise_degree_cm(pred_rts, gt_rts, gt_classes, gt_handle_vis
                       ) -> np.ndarray:
    """(P, G, 2) [degrees, cm] matrix (compute_RT_degree_cm_symmetry).

    Rotations are scale-normalized by cbrt(det); y-symmetric classes (and
    handleless mugs) compare only the rotated y axes.
    """
    p, g = len(pred_rts), len(gt_rts)
    if p == 0 or g == 0:
        return np.zeros((p, g, 2))
    r1 = pred_rts[:, :3, :3]
    r1 = r1 / np.cbrt(np.linalg.det(r1))[:, None, None]
    t1 = pred_rts[:, :3, 3]
    r2 = gt_rts[:, :3, :3]
    r2 = r2 / np.cbrt(np.linalg.det(r2))[:, None, None]
    t2 = gt_rts[:, :3, 3]

    # full geodesic angle
    rr = np.einsum("pij,gkj->pgik", r1, r2)
    trace = np.trace(rr, axis1=-2, axis2=-1)
    theta_full = np.arccos(np.clip((trace - 1) / 2, -1, 1))

    # y-axis-only angle for symmetric classes
    y1 = r1[:, :, 1]                                   # R @ [0,1,0]
    y2 = r2[:, :, 1]
    cosang = np.einsum("pi,gi->pg", y1, y2) / (
        np.linalg.norm(y1, axis=1)[:, None]
        * np.linalg.norm(y2, axis=1)[None, :])
    theta_y = np.arccos(np.clip(cosang, -1, 1))

    names = np.array([SYNSET_NAMES[c] for c in gt_classes])
    sym = (np.isin(names, list(_Y_SYM_CLASSES))
           | ((names == "mug") & (np.asarray(gt_handle_vis) == 0)))
    theta = np.where(sym[None, :], theta_y, theta_full) * 180 / math.pi
    shift = np.linalg.norm(t1[:, None] - t2[None, :], axis=-1) * 100
    return np.stack([theta, shift], axis=-1)


def match_iou(overlaps, pred_classes, gt_classes, pred_scores,
              iou_thresholds):
    """Greedy IoU matching (compute_3d_matches :298-333).  Predictions are
    assumed pre-sorted by descending score."""
    n_thr = len(iou_thresholds)
    p, g = overlaps.shape
    pred_match = -np.ones((n_thr, p))
    gt_match = -np.ones((n_thr, g))
    for s, thr in enumerate(iou_thresholds):
        for i in range(p):
            order = np.argsort(overlaps[i])[::-1]
            for j in order:
                if gt_match[s, j] > -1:
                    continue
                if overlaps[i, j] < thr:
                    break
                if pred_classes[i] != gt_classes[j]:
                    continue
                if overlaps[i, j] > thr:
                    gt_match[s, j] = i
                    pred_match[s, i] = j
                    break
    return gt_match, pred_match


def match_degree_cm(overlaps, pred_classes, gt_classes, degree_thrs,
                    shift_thrs):
    """Greedy pose matching (compute_match_from_degree_cm :445-487)."""
    nd, ns = len(degree_thrs), len(shift_thrs)
    p, g = overlaps.shape[:2]
    pred_match = -np.ones((nd, ns, p))
    gt_match = -np.ones((nd, ns, g))
    if p == 0 or g == 0:
        return gt_match, pred_match
    sum_err = overlaps.sum(-1)
    orders = np.argsort(sum_err, axis=1)
    for d, dthr in enumerate(degree_thrs):
        for s, sthr in enumerate(shift_thrs):
            for i in range(p):
                for j in orders[i]:
                    if gt_match[d, s, j] > -1 \
                            or pred_classes[i] != gt_classes[j]:
                        continue
                    if overlaps[i, j, 0] > dthr or overlaps[i, j, 1] > sthr:
                        continue
                    gt_match[d, s, j] = i
                    pred_match[d, s, i] = j
                    break
    return gt_match, pred_match


def voc_ap(pred_match, pred_scores, gt_match) -> float:
    """VOC-style AP (compute_ap_from_matches_scores :336-362).

    Keeps the reference's NaN semantics: a class with predictions but zero
    ground truth anywhere divides by len(gt_match)==0 and yields NaN
    (which then propagates into the class mean), not 0."""
    order = np.argsort(pred_scores)[::-1]
    pm = pred_match[order]
    precisions = np.cumsum(pm > -1) / (np.arange(len(pm)) + 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        recalls = np.cumsum(pm > -1).astype(np.float64) / len(gt_match)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1])
                        * precisions[idx]))
