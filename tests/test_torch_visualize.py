"""``givepose_torch/eval/visualize.py`` against ``givepose_tpu/eval/
visualize.py`` (which draws with OpenCV and matplotlib).

  * colours and NOCS maps equal; ``project_box`` within 1e-5;
  * ``line`` at thickness 1 bitwise against ``cv2.line`` on random
    segments, clipped ones included;
  * thicknesses 2 and 3 (cv2's thick line: the segment clipped to the
    image widened by the thickness, a filled quadrilateral and round caps)
    bitwise too, inside the image and across its edges; ``draw_results``
    (GT at thickness 1, predictions at 2) bitwise on boxes inside and
    across the frame's edges;
  * ``plot_map_curves``: ``mAP_Acc.pkl`` equal to the JAX package's (same
    keys, arrays bitwise); ``mAP.png`` cannot match matplotlib's pixels,
    so its structure is checked: the size, and a constant-AP row drawn in
    its colour at the predicted row of each panel.
"""

from __future__ import annotations

import os
import pickle

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyRot

from givepose_torch.data import png
from givepose_torch.eval import visualize as vis
from givepose_tpu.eval import visualize as jax_vis

K = np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]])


def test_colors_and_maps_equal_jax():
    for cid in range(13):
        assert vis.class_color(cid) == jax_vis.class_color(cid)
    coor = np.random.default_rng(0).uniform(-0.7, 0.7, (16, 16, 3))
    got, ref = vis.nocs_map_to_rgb(coor), jax_vis.nocs_map_to_rgb(coor)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert vis._CURVE_STYLE == jax_vis._CURVE_STYLE
    from matplotlib.colors import to_rgb
    for name, rgb in vis.TAB_COLORS.items():
        assert rgb == tuple(int(round(255 * c)) for c in to_rgb(name))


def _box(seed):
    rng = np.random.default_rng(seed)
    rt = np.eye(4)
    rt[:3, :3] = (ScipyRot.random(random_state=seed).as_matrix()
                  * rng.uniform(0.1, 0.4))
    rt[:3, 3] = (rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4),
                 rng.uniform(0.6, 1.5))
    size = rng.uniform(0.3, 1.0, 3)
    return rt, size / np.linalg.norm(size)


def test_project_box_equals_jax():
    for seed in range(10):
        rt, size = _box(seed)
        np.testing.assert_allclose(vis.project_box(rt, size, K),
                                   jax_vis.project_box(rt, size, K),
                                   rtol=0, atol=1e-5)


def _segments(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        p0 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        if i % 3 == 0:            # short ones, caps and single pixels
            p1 = (p0[0] + int(rng.integers(-5, 6)),
                  p0[1] + int(rng.integers(-5, 6)))
        else:
            p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        yield h, w, p0, p1


def _draw_both(h, w, p0, p1, thickness):
    ref = np.zeros((h, w, 3), np.uint8)
    got = ref.copy()
    cv2.line(ref, p0, p1, (10, 200, 30), thickness)
    vis.line(got, p0, p1, (10, 200, 30), thickness)
    return got, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_thin_line_equals_cv2(seed):
    """Ends from -40 to 100 on images of 5 to 59 pixels a side: most
    segments are clipped, some miss the image."""
    for h, w, p0, p1 in _segments(seed, 600, -40, 100):
        got, ref = _draw_both(h, w, p0, p1, 1)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h, w, p0, p1}")


@pytest.mark.parametrize("thickness", [2, 3])
def test_thick_line_equals_cv2(thickness):
    """Inside a 60 x 60 image, then the clipped and missing segments."""
    rng = np.random.default_rng(thickness)
    for _ in range(300):
        p0 = tuple(int(v) for v in rng.integers(3, 57, 2))
        p1 = tuple(int(v) for v in rng.integers(3, 57, 2))
        got, ref = _draw_both(60, 60, p0, p1, thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f"{p0, p1}")
    for h, w, p0, p1 in _segments(10 + thickness, 600, -40, 100):
        got, ref = _draw_both(h, w, p0, p1, thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h, w, p0, p1}")


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_results_equals_jax(seed):
    """GT boxes at thickness 1, predicted ones at 2 in their class colour,
    on a 640 x 480 frame; a quarter to half of the boxes cross its edge."""
    rng = np.random.default_rng(seed)
    crossing = 0
    for i in range(40):
        rt, size = _box(100 * seed + i)
        pred = rt.copy()
        pred[:3, 3] += rng.normal(0, 0.02, 3)
        result = {"gt_RTs": rt[None], "gt_scales": size[None],
                  "pred_RTs": pred[None], "pred_scales": size[None],
                  "pred_class_ids": np.array([i % 7])}
        img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        got = vis.draw_results(img, result, K)
        np.testing.assert_array_equal(got, jax_vis.draw_results(img, result,
                                                                K))
        assert (got != img).any()
        corners = np.concatenate([vis.project_box(rt, size, K),
                                  vis.project_box(pred, size, K)])
        crossing += not ((corners >= 0).all() and (corners[:, 0] < 640).all()
                         and (corners[:, 1] < 480).all())
    assert 5 <= crossing <= 30


def _curves(n_rows=8):
    """AP arrays whose every drawn row is a constant: class j at
    10 + 11 j percent, the mean row at 90 %."""
    iou_t = [i / 100 for i in range(101)]
    deg_t = list(range(71))
    sft_t = [i / 2 for i in range(51)]
    iou_aps = np.zeros((n_rows, len(iou_t)))
    pose_aps = np.zeros((n_rows, len(deg_t), len(sft_t)))
    levels = {}
    for j, row in enumerate(list(range(1, n_rows - 1)) + [n_rows - 1]):
        level = 0.9 if row == n_rows - 1 else 0.10 + 0.11 * j
        iou_aps[row] = level
        pose_aps[row] = level
        levels[row] = (j, level)
    return iou_aps, pose_aps, iou_t, deg_t, sft_t, levels


def test_plot_pickle_equals_jax_and_png_structure(tmp_path):
    iou_aps, pose_aps, iou_t, deg_t, sft_t, levels = _curves()
    out, jax_out = tmp_path / "port", tmp_path / "jax"
    out.mkdir()
    jax_out.mkdir()
    path = vis.plot_map_curves(iou_aps, pose_aps, str(out), iou_t, deg_t,
                               sft_t)
    jax_vis.plot_map_curves(iou_aps, pose_aps, str(jax_out), iou_t, deg_t,
                            sft_t)
    with open(out / "mAP_Acc.pkl", "rb") as f:
        got = pickle.load(f)
    with open(jax_out / "mAP_Acc.pkl", "rb") as f:
        ref = pickle.load(f)
    assert got.keys() == ref.keys()
    for k in ref:
        assert type(got[k]) is type(ref[k])
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype

    assert path == os.path.join(str(out), "mAP.png")
    img = png.imread(path)[:, :, ::-1]                      # RGB
    assert img.shape == (vis.FIG_H, vis.FIG_W, 3) == (350, 800, 3)
    assert img.shape[:2] == cv2.imread(str(jax_out / "mAP.png")).shape[:2]
    for i in range(3):
        left, top, w, h = vis.panel_box(i)
        assert (img[top:top + h, left] == 0).all()          # the spine
        x = left + w // 4                                   # clear of legend
        for row, (j, level) in levels.items():
            color, style = vis._CURVE_STYLE[j]
            y = int(np.floor(vis.to_pixel(100 * level, 0, 100, top, h,
                                          flip=True)))
            rgb = np.array(vis.TAB_COLORS[color])
            if style == "-":
                band = img[y - 1:y + 3, x]
                assert (band == rgb).all(-1).any(), (i, row, y)
            else:        # the mean row, dashed: on and off along the row
                on = (img[y - 1:y + 3, left + 2:left + w - 2]
                      == rgb).all(-1).any(0)
                assert 0.4 < on.mean() < 0.9, (i, on.mean())
        # titles above and tick labels below the panel, in black
        assert (img[top - 14:top - 4, left:left + w] == 0).all(-1).any()
        assert (img[top + h + 6:top + h + 14, left:left + w]
                == 0).all(-1).any()
