"""The port's eval metrics and mAP harness against the JAX package's.

Seeded predictions around seeded ground truth (every class, the
y-symmetric ones and mugs with and without a visible handle, false
positives, zero-padded detection rows, a class with predictions and no
ground truth) go through ``givepose_torch.eval`` and ``givepose_tpu.eval``;
the mAP arrays agree to 1e-6 (``PARITY.md``), NaNs in the same places.
"""

from __future__ import annotations

import numpy as np
import pytest

from givepose_tpu.eval import harness as jax_harness
from givepose_tpu.eval import metrics as jax_metrics

from givepose_torch.eval import harness, metrics

MAP_BAR = 1e-6


def random_rt(rng, scale):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)]])
    rt = np.eye(4)
    rt[:3, :3] = r * scale
    rt[:3, 3] = rng.uniform([-0.2, -0.2, 0.6], [0.2, 0.2, 1.4])
    return rt


def perturb(rng, rt, deg, cm):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
    out = rt.copy()
    out[:3, :3] = rot @ rt[:3, :3]
    out[:3, 3] += rng.normal(size=3) * cm / 100
    return out


def make_results(seed, n_images=6, no_gt_class=None, pad_rows=2):
    """Per-image result dicts as ``run_inference`` writes them."""
    rng = np.random.default_rng(seed)
    results = []
    for _ in range(n_images):
        g = int(rng.integers(1, 5))
        classes = [c for c in rng.integers(1, 7, g) if c != no_gt_class]
        g = len(classes)
        gt_rts = [random_rt(rng, rng.uniform(0.1, 0.4)) for _ in range(g)]
        gt_scales = rng.uniform(0.3, 1.0, (g, 3))
        hv = rng.integers(0, 2, g).astype(np.float64)
        pr_cls, pr_rts, pr_scales, scores, boxes = [], [], [], [], []
        for j in range(g):
            if rng.random() < 0.85:                     # detected
                pr_cls.append(classes[j])
                pr_rts.append(perturb(rng, gt_rts[j], rng.uniform(0, 15),
                                      rng.uniform(0, 12)))
                pr_scales.append(gt_scales[j] * rng.uniform(0.8, 1.2, 3))
                scores.append(rng.uniform(0.3, 1.0))
                boxes.append(rng.integers(1, 400, 4))
        for _ in range(int(rng.integers(0, 3))):       # false positives
            c = int(rng.integers(1, 7))
            pr_cls.append(c)
            pr_rts.append(random_rt(rng, rng.uniform(0.1, 0.4)))
            pr_scales.append(rng.uniform(0.3, 1.0, 3))
            scores.append(rng.uniform(0.0, 0.8))
            boxes.append(rng.integers(1, 400, 4))
        if no_gt_class is not None and rng.random() < 0.5:
            pr_cls.append(no_gt_class)
            pr_rts.append(random_rt(rng, 0.2))
            pr_scales.append(rng.uniform(0.3, 1.0, 3))
            scores.append(rng.uniform(0.3, 1.0))
            boxes.append(rng.integers(1, 400, 4))
        for _ in range(pad_rows):                       # zero-padded rows
            pr_cls.append(int(rng.integers(1, 7)))
            pr_rts.append(np.zeros((4, 4)))
            pr_scales.append(np.zeros(3))
            scores.append(0.0)
            boxes.append(np.zeros(4, np.int64))
        results.append({
            "gt_class_ids": np.asarray(classes, np.int64),
            "gt_RTs": np.asarray(gt_rts).reshape(-1, 4, 4),
            "gt_scales": np.asarray(gt_scales).reshape(-1, 3),
            "gt_handle_visibility": hv,
            "pred_class_ids": np.asarray(pr_cls, np.int64),
            "pred_scores": np.asarray(scores, np.float32),
            "pred_RTs": np.asarray(pr_rts, np.float32).reshape(-1, 4, 4),
            "pred_scales": np.asarray(pr_scales, np.float32).reshape(-1, 3),
            "pred_bboxes": np.asarray(boxes).reshape(-1, 4),
        })
    results.append({                 # an image with nothing at all
        "gt_class_ids": np.zeros(0, np.int64),
        "gt_RTs": np.zeros((0, 4, 4)), "gt_scales": np.zeros((0, 3)),
        "gt_handle_visibility": np.zeros(0),
        "pred_class_ids": np.zeros(0, np.int32),
        "pred_scores": np.zeros(0, np.float32),
        "pred_RTs": np.zeros((0, 4, 4)), "pred_scales": np.zeros((0, 3)),
        "pred_bboxes": np.zeros((0, 4), np.float32)})
    return results


def assert_maps_equal(got, ref):
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=0, atol=MAP_BAR,
                                   equal_nan=True)


def test_pairwise_matrices_equal_jax():
    """Symmetric classes (bottle, bowl, can), mugs with and without a
    visible handle, and the rest, in one (P, G) matrix."""
    rng = np.random.default_rng(0)
    gt_cls = np.array([1, 2, 3, 4, 5, 6, 6])
    pr_cls = np.array([1, 2, 3, 4, 5, 6, 6, 1])
    hv = np.array([1, 1, 1, 1, 1, 0, 1])
    gt_rts = np.stack([random_rt(rng, 0.3) for _ in gt_cls])
    pr_rts = np.stack([perturb(rng, gt_rts[min(i, 6)], 20, 5)
                       for i in range(len(pr_cls))])
    gs = rng.uniform(0.3, 1, (7, 3))
    ps = rng.uniform(0.3, 1, (8, 3))
    iou = metrics.pairwise_3d_iou(pr_rts, ps, gt_rts, gs, pr_cls, gt_cls, hv)
    ref = jax_metrics.pairwise_3d_iou(pr_rts, ps, gt_rts, gs, pr_cls, gt_cls,
                                      hv)
    np.testing.assert_array_equal(iou, ref)
    err = metrics.pairwise_degree_cm(pr_rts, gt_rts, gt_cls, hv)
    np.testing.assert_array_equal(
        err, jax_metrics.pairwise_degree_cm(pr_rts, gt_rts, gt_cls, hv))
    # the handleless mug compares only the y axes: its angle is not the
    # full one
    full = metrics.pairwise_degree_cm(pr_rts, gt_rts, gt_cls, np.ones(7))
    assert err[5, 5, 0] <= full[5, 5, 0]
    assert metrics.SYNSET_NAMES == jax_metrics.SYNSET_NAMES


def test_matching_and_voc_ap_equal_jax():
    rng = np.random.default_rng(1)
    overlaps = rng.uniform(0, 1, (6, 5))
    pc = rng.integers(1, 3, 6)
    gc = rng.integers(1, 3, 5)
    thr = [0.1, 0.25, 0.5, 0.75]
    got = metrics.match_iou(overlaps, pc, gc, None, thr)
    ref = jax_metrics.match_iou(overlaps, pc, gc, None, thr)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    errs = np.stack([rng.uniform(0, 30, (6, 5)), rng.uniform(0, 20, (6, 5))],
                    -1)
    got = metrics.match_degree_cm(errs, pc, gc, [5, 10, 360], [5, 10, 1e4])
    ref = jax_metrics.match_degree_cm(errs, pc, gc, [5, 10, 360],
                                      [5, 10, 1e4])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    scores = rng.uniform(0, 1, 6)
    assert metrics.voc_ap(got[1][1, 1], scores, got[0][1, 1]) == \
        jax_metrics.voc_ap(got[1][1, 1], scores, got[0][1, 1])
    # predictions and no ground truth: NaN in both
    assert np.isnan(metrics.voc_ap(np.array([-1.0]), np.array([0.5]),
                                   np.zeros(0)))
    assert np.isnan(jax_metrics.voc_ap(np.array([-1.0]), np.array([0.5]),
                                       np.zeros(0)))


@pytest.mark.parametrize("case", ["default", "no_gt_class", "no_match_filter"])
def test_degree_cm_map_equals_jax(case):
    results = make_results(2, no_gt_class=4 if case == "no_gt_class"
                           else None)
    kw = {"use_matches_for_pose": case != "no_match_filter"}
    got = harness.compute_degree_cm_map(results, **kw)
    ref = jax_harness.compute_degree_cm_map(results, **kw)
    assert_maps_equal(got, ref)
    iou_aps, pose_aps = got
    assert iou_aps.shape == (8, 4) and pose_aps.shape == (8, 4, 4)
    if case == "no_gt_class":
        # class 4 has predictions and no GT: NaN, carried into the mean
        assert np.isnan(iou_aps[4]).all() and np.isnan(iou_aps[-1]).all()
    else:
        assert np.isfinite(iou_aps[1:7]).all()
        assert 0 < np.nanmean(iou_aps[-1]) < 1


def test_zero_padded_rows_are_trimmed():
    padded = make_results(3, pad_rows=3)
    clean = []
    for r in padded:
        keep = ~np.all(r["pred_bboxes"] == 0, axis=1)
        clean.append({k: (v[keep] if k.startswith("pred_") else v)
                      for k, v in r.items()})
    assert sum(len(r["pred_RTs"]) for r in clean) < \
        sum(len(r["pred_RTs"]) for r in padded)
    got = harness.compute_degree_cm_map(padded)
    assert_maps_equal(got, harness.compute_degree_cm_map(clean))
    assert_maps_equal(got, jax_harness.compute_degree_cm_map(padded))


def test_precise_thresholds_equal_jax():
    """eval_precise's sweep (evaluate_results): degrees 0..70, shifts
    0..25 by 0.5, IoU 0..1 by 0.01; and its scale-normalized pass."""
    results = make_results(4, n_images=3)
    args = (metrics.SYNSET_NAMES, tuple(range(0, 71)),
            tuple(i / 2 for i in range(51)), tuple(i / 100 for i in
                                                   range(101)))
    got = harness.compute_degree_cm_map(results, *args)
    ref = jax_harness.compute_degree_cm_map(results, *args)
    assert_maps_equal(got, ref)
    assert got[1].shape == (8, 72, 52)
    normed = harness.scale_normalize_results(results)
    args2 = args[:1] + (tuple(range(0, 61)), tuple(range(51))) + args[3:]
    assert_maps_equal(
        harness.compute_degree_cm_map(normed, *args2),
        jax_harness.compute_degree_cm_map(
            jax_harness.scale_normalize_results(results), *args2))


def test_scale_normalize_results_equals_jax():
    results = make_results(5)
    got = harness.scale_normalize_results(results)
    ref = jax_harness.scale_normalize_results(results)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]))
    rts = got[0]["gt_RTs"]
    np.testing.assert_allclose(np.linalg.det(rts[:, :3, :3]), 1.0,
                               rtol=1e-12)


@pytest.mark.parametrize("cls_idx", [-1, 1, 6])
def test_summarize_equals_jax(cls_idx):
    results = make_results(6)
    for thrs in (((5, 10, 360), (5, 10, 1e4), (0.1, 0.25, 0.5, 0.75)),
                 ((5, 10), (5, 10, 20, 50), (0.1, 0.25, 0.5, 0.75))):
        maps = harness.compute_degree_cm_map(
            harness.scale_normalize_results(results), metrics.SYNSET_NAMES,
            *thrs)
        got = harness.summarize(*maps, *thrs, cls_idx=cls_idx)
        ref = jax_harness.summarize(*maps, *thrs, cls_idx=cls_idx)
        assert got.keys() == ref.keys() and "IoU25" in got
        for k in got:
            assert got[k] == ref[k] or (np.isnan(got[k])
                                        and np.isnan(ref[k])), k
