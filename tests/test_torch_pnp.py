"""``givepose_torch/eval/pnp.py`` against ``givepose_tpu/eval/pnp.py``.

The JAX function is cv2's EPnP + RANSAC; the port's is its own, drawn
from a torch generator, so the bars are on the pose, not the sample:

  * exact correspondences (``tests/test_eval.py::TestRansacPnP``'s setup,
    and three more poses): rotation within 0.05° and translation within
    1e-4 of the JAX function's;
  * 0.5 px noise and 30 % gross outliers: both within that test's GT bars
    (0.5°, 5e-3);
  * too few points give None, and a batch's ``ok`` flags equal JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from givepose_torch.eval import pnp
from givepose_tpu.eval import pnp as jax_pnp

K = np.array([[591.0, 0, 322.5], [0, 590.2, 244.1], [0, 0, 1]])
ROT_BAR, TRANS_BAR = 0.05, 1e-4          # against the JAX function
GT_ROT_BAR, GT_TRANS_BAR = 0.5, 5e-3     # against GT (tests/test_eval.py)


def correspondences(seed, noise=0.0, outliers=0.0, r=32):
    rng = np.random.default_rng(seed)
    nocs = rng.uniform(-0.4, 0.4, (r, r, 3)).astype(np.float32)
    mask = np.ones((r, r), np.float32)
    if seed == 0:                        # tests/test_eval.py's pose
        rot = ScipyRot.from_euler("xyz", [0.2, -0.4, 0.1]).as_matrix()
        t = np.array([0.1, -0.05, 1.1])
    else:
        rot = ScipyRot.from_euler("xyz", rng.uniform(-1, 1, 3)).as_matrix()
        t = np.array([0.1, -0.05, 1.1]) + rng.uniform(-0.1, 0.1, 3)
    scale = 0.25
    cam = (nocs * scale) @ rot.T + t
    px = cam[..., 0] / cam[..., 2] * K[0, 0] + K[0, 2]
    py = cam[..., 1] / cam[..., 2] * K[1, 1] + K[1, 2]
    px = px + rng.normal(0, noise, px.shape)
    py = py + rng.normal(0, noise, py.shape)
    bad = rng.random(px.shape) < outliers
    px[bad] += rng.uniform(-100, 100, bad.sum())
    py[bad] += rng.uniform(-100, 100, bad.sum())
    return nocs, px, py, mask, scale, rot, t


def angle_deg(a, b):
    """The angle of a^T b, from its quaternion (exact near 0)."""
    rel = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    return float(np.degrees(ScipyRot.from_matrix(rel).magnitude()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_correspondences_match_jax(seed):
    nocs, px, py, mask, scale, rot, t = correspondences(seed)
    got = pnp.ransac_pnp(nocs, px, py, mask, K, nocs_scale=scale,
                         generator=torch.Generator().manual_seed(seed))
    ref = jax_pnp.ransac_pnp(nocs, px, py, mask, K, nocs_scale=scale)
    assert got is not None and ref is not None
    assert got[0].dtype == ref[0].dtype == np.float32
    assert got[0].shape == (3, 3) and got[1].shape == (3,)
    assert angle_deg(got[0], ref[0]) < ROT_BAR
    np.testing.assert_allclose(got[1], ref[1], atol=TRANS_BAR)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_noise_and_outliers_within_gt_bars(seed):
    nocs, px, py, mask, scale, rot, t = correspondences(seed, noise=0.5,
                                                        outliers=0.3)
    got = pnp.ransac_pnp(nocs, px, py, mask, K, nocs_scale=scale,
                         generator=torch.Generator().manual_seed(seed))
    ref = jax_pnp.ransac_pnp(nocs, px, py, mask, K, nocs_scale=scale)
    for fit in (got, ref):
        assert fit is not None
        assert angle_deg(fit[0], rot) < GT_ROT_BAR
        np.testing.assert_allclose(fit[1], t, atol=GT_TRANS_BAR)


def test_too_few_points_and_batch_flags():
    assert pnp.ransac_pnp(np.zeros((4, 4, 3)), np.zeros((4, 4)),
                          np.zeros((4, 4)), np.zeros((4, 4)), np.eye(3),
                          generator=torch.Generator()) is None
    cases = [correspondences(s) for s in (1, 2)]
    few = np.zeros((32, 32), np.float32)
    few[0, :5] = 1                       # 5 points: below min_points
    masks = [cases[0][3], few, cases[1][3]]
    args = ([cases[0][0], cases[0][0], cases[1][0]],
            [cases[0][1], cases[0][1], cases[1][1]],
            [cases[0][2], cases[0][2], cases[1][2]], masks, [K] * 3)
    scales = [0.25] * 3
    rots, trans, ok = pnp.ransac_pnp_batch(
        *args, nocs_scales=scales, generator=torch.Generator().manual_seed(0))
    jrots, jtrans, jok = jax_pnp.ransac_pnp_batch(*args, nocs_scales=scales)
    np.testing.assert_array_equal(ok, jok)
    assert ok.tolist() == [True, False, True]
    assert rots.dtype == np.float32 and trans.dtype == np.float32
    np.testing.assert_array_equal(rots[1], np.eye(3))
    np.testing.assert_array_equal(trans[1], np.zeros(3))
    for i in (0, 2):
        assert angle_deg(rots[i], jrots[i]) < ROT_BAR
        np.testing.assert_allclose(trans[i], jtrans[i], atol=TRANS_BAR)


def test_epnp_alone_is_exact():
    """EPnP on all points of a noise-free instance, without RANSAC: every
    approximation's Gauss-Newton lands on the pose (f64)."""
    nocs, px, py, mask, scale, rot, t = correspondences(2)
    obj = torch.from_numpy(nocs.reshape(-1, 3).astype(np.float64) * scale)
    img = torch.from_numpy(np.stack([px.reshape(-1), py.reshape(-1)], -1))
    r, tt, err = pnp.epnp(obj, img, torch.from_numpy(K))
    assert float(err) < 1e-6
    assert angle_deg(r.numpy(), rot) < 1e-6
    np.testing.assert_allclose(tt.numpy(), t, atol=1e-9)


def test_device_defaults_to_the_card():
    nocs, px, py, mask, scale, _, _ = correspondences(1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pnp.ransac_pnp(nocs, px, py, mask, K)
