"""The rest of the port's geometry and the result re-scorer against the JAX
package: ``geometry/errors.py``, the conversions and 5-D representations
of ``geometry/rotations.py`` (``mat_to_quat`` near each of its branch
boundaries too), ``get_rot_mat``'s dispatch, ``geometry/bop_errors.py``'s
MSSD and MSPD (numpy float64 in both, with symmetry translations) and VSD
(not ported: it raises), and ``eval/evaluate_other.py``.
"""

from __future__ import annotations

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from givepose_tpu.core.config import Config as JaxConfig
from givepose_tpu.eval import evaluate_other as jax_other
from givepose_tpu.geometry import bop_errors as jax_bop
from givepose_tpu.geometry import errors as jax_errors
from givepose_tpu.geometry import rotations as jax_rot

from givepose_torch.core.config import Config
from givepose_torch.eval import evaluate_other
from givepose_torch.geometry import bop_errors, errors, rotations

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def assert_close(got, ref, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


def rotations_batch(n, seed):
    return ScipyRot.random(n, random_state=seed).as_matrix().astype(
        np.float32)


def test_errors_equal_jax():
    r_gt = rotations_batch(64, 0)
    # angles from 0 to 180 degrees about random axes
    axes = np.random.default_rng(1).normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.linspace(0, np.pi, 64)
    r_est = (ScipyRot.from_rotvec(axes * angles[:, None]).as_matrix()
             @ r_gt).astype(np.float32)
    got = errors.rotation_error_deg(_t(r_est), _t(r_gt))
    ref = jax_errors.rotation_error_deg(jnp.asarray(r_est), jnp.asarray(r_gt))
    assert got.shape == ref.shape == (64,)
    # the cosines within 1e-6: arccos turns an ulp of the trace into
    # 1 / sin(angle) times as much angle, so the degrees are held to that
    cos_got = np.cos(np.radians(got.numpy().astype(np.float64)))
    cos_ref = np.cos(np.radians(np.asarray(ref, np.float64)))
    np.testing.assert_allclose(cos_got, cos_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.degrees(angles), atol=0.05)
    t = np.random.default_rng(2).normal(size=(2, 64, 3)).astype(np.float32)
    assert_close(errors.translation_error(_t(t[0]), _t(t[1])),
                 jax_errors.translation_error(jnp.asarray(t[0]),
                                              jnp.asarray(t[1])))


def boundary_matrices() -> np.ndarray:
    """Rotations at and near each branch boundary of ``mat_to_quat``: the
    trace at 0 (120 degrees), m00 = m11 and m11 = m22 with a negative
    trace, half turns (w = 0) and the identity."""
    mats = []
    for eps in (0.0, 1e-4, -1e-4):
        mats.append(ScipyRot.from_rotvec(
            (2 * np.pi / 3 + eps) * np.array([1.0, 2, 3]) / np.sqrt(14)
        ).as_matrix())
    for axis in ([1.0, 1, 0], [0.0, 1, 1], [1.0, 0, 1], [1.0, 1, 1]):
        for eps in (0.0, 1e-3):
            a = np.asarray(axis) + eps * np.array([0.3, -0.2, 0.1])
            mats.append(ScipyRot.from_rotvec(
                0.9 * np.pi * a / np.linalg.norm(a)).as_matrix())
    for axis in np.eye(3):
        mats.append(ScipyRot.from_rotvec(np.pi * axis).as_matrix())
    mats.append(np.eye(3))
    return np.asarray(mats, np.float32)


@pytest.mark.parametrize("which", ["random", "boundaries"])
def test_mat_conversions_equal_jax(which):
    m = rotations_batch(200, 3) if which == "random" else boundary_matrices()
    assert_close(rotations.mat_to_rot6d(_t(m)),
                 jax_rot.mat_to_rot6d(jnp.asarray(m)))
    q = rotations.mat_to_quat(_t(m))
    assert_close(q, jax_rot.mat_to_quat(jnp.asarray(m)))
    assert (q[:, 0] >= 0).all()
    assert_close(rotations.quat_to_mat(q), m, 1e-5)


def test_5d_reps_equal_jax():
    rng = np.random.default_rng(4)
    for fn, width in (("rot5d_to_mat", 5), ("ortho5d_to_mat", 5)):
        x = rng.normal(size=(100, width)).astype(np.float32)
        got = getattr(rotations, fn)(_t(x))
        ref = getattr(jax_rot, fn)(jnp.asarray(x))
        assert_close(got, ref)
        rtr = got.transpose(-1, -2) @ got
        torch.testing.assert_close(rtr, torch.eye(3).expand_as(rtr),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("rot_type", [
    "ego_quat", "allo_log_quat", "allo_lie_vec", "allo_rot6d",
    "allo_rot6d_y", "allo_rot6d_z", "allo_rot6d_x", "euler", "rot5d",
    "ortho5d"])
def test_get_rot_mat_dispatch_equals_jax(rot_type):
    """The same rotation types dispatch (the 5-D representations do not,
    in either package) and give the same matrices."""
    width = {"quat": 4, "log_quat": 4, "lie_vec": 3, "euler": 3}
    n = next((v for k, v in width.items() if rot_type.endswith(k)), 6)
    x = np.random.default_rng(5).normal(size=(8, n)).astype(np.float32)
    try:
        ref = jax_rot.get_rot_mat(jnp.asarray(x), rot_type)
    except ValueError:
        with pytest.raises(ValueError, match="Wrong pred_rot type"):
            rotations.get_rot_mat(_t(x), rot_type)
        return
    assert_close(rotations.get_rot_mat(_t(x), rot_type), ref)


def bop_case(seed, n_sym):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 0.1, (300, 3))
    r_gt = ScipyRot.random(random_state=seed).as_matrix()
    t_gt = np.array([0.02, -0.03, 0.9])
    r_est = ScipyRot.from_rotvec(rng.normal(size=3) * 0.1).as_matrix() @ r_gt
    t_est = t_gt + rng.normal(size=3) * 0.01
    syms = np.stack([np.eye(3)] + [
        ScipyRot.from_euler("y", 360 * i / n_sym, degrees=True).as_matrix()
        for i in range(1, n_sym)])
    sym_ts = rng.normal(size=(n_sym, 3)) * 0.005
    k = np.array([[591.0, 0, 322.5], [0, 590.0, 244.1], [0, 0, 1]])
    return pts, r_est, t_est, r_gt, t_gt, syms, sym_ts, k


@pytest.mark.parametrize("n_sym,with_ts", [(1, False), (4, False),
                                           (4, True)])
def test_mssd_mspd_equal_jax(n_sym, with_ts):
    pts, r_est, t_est, r_gt, t_gt, syms, sym_ts, k = bop_case(6, n_sym)
    ts = sym_ts if with_ts else None
    for est in ((r_est, t_est), (r_gt @ syms[-1], t_gt)):
        got = bop_errors.mssd(*est, r_gt, t_gt, pts, syms, ts)
        ref = jax_bop.mssd(*est, r_gt, t_gt, pts, syms, ts)
        assert isinstance(got, float)
        assert abs(got - ref) <= 1e-12
        got = bop_errors.mspd(*est, r_gt, t_gt, k, pts, syms, ts)
        ref = jax_bop.mspd(*est, r_gt, t_gt, k, pts, syms, ts)
        assert abs(got - ref) <= 1e-12
    if n_sym > 1 and not with_ts:
        # an estimate rotated by a symmetry scores 0
        assert bop_errors.mssd(r_gt @ syms[1], t_gt, r_gt, t_gt, pts,
                               syms) < 1e-12
    with pytest.raises(ValueError):
        bop_errors.mssd(r_est, t_est, r_gt, t_gt, pts, syms,
                        np.zeros((n_sym + 1, 3)))


def test_vsd_raises_naming_a11():
    pts, r_est, t_est, r_gt, t_gt, _, _, k = bop_case(7, 1)
    with pytest.raises(NotImplementedError, match="queue A, item 11"):
        bop_errors.vsd(r_est, t_est, r_gt, t_gt, k, pts,
                       np.zeros((480, 640)))


@pytest.fixture(scope="module")
def result_pkls(tmp_path_factory):
    """Per-image result dicts of the eval fixture with GT detections and
    perturbed GT poses as predictions: one list pickle, and a directory of
    a list pickle and a single-dict pickle."""
    from givepose_torch.data.synthetic import make_synthetic_eval
    from givepose_torch.eval.load_eval import NocsEvalReader

    root = tmp_path_factory.mktemp("rescore")
    data_dir, _ = make_synthetic_eval(str(root), n_images=4, seed=2)
    reader = NocsEvalReader("Real", data_dir)
    rng = np.random.default_rng(8)
    results = []
    for i in range(len(reader)):
        _, det, _ = reader.read(i)
        det = dict(det)
        rt = np.array(det["gt_RTs"], np.float32)
        rot = ScipyRot.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
        rt[0, :3, :3] = rot @ rt[0, :3, :3]
        rt[0, :3, 3] += rng.normal(size=3) * 0.02
        det["pred_RTs"] = rt
        det["pred_scales"] = np.array(det["gt_scales"], np.float32) * (
            1 + 0.05 * rng.normal(size=3))
        results.append(det)
    one = str(root / "pred_result.pkl")
    with open(one, "wb") as f:
        pickle.dump(results, f)
    many = root / "many"
    os.makedirs(many)
    with open(many / "a.pkl", "wb") as f:
        pickle.dump(results[:3], f)
    with open(many / "b.pkl", "wb") as f:
        pickle.dump(results[3], f)
    return one, str(many), results


@pytest.mark.parametrize("which", ["file", "directory"])
def test_rescore_equals_jax(result_pkls, which):
    one, many, results = result_pkls
    path = one if which == "file" else many
    loaded = evaluate_other.load_results(path)
    assert len(loaded) == len(results) == 4
    for got, want in zip(loaded, results):
        np.testing.assert_array_equal(got["pred_RTs"], want["pred_RTs"])
    logs = []
    got = evaluate_other.rescore(path, Config(), log=logs.append)
    ref = jax_other.rescore(path, JaxConfig(), log=lambda s: None)
    assert logs[0] == f"rescoring 4 images from {path}"
    for k in ("absolute", "relative"):
        assert got[k].keys() == ref[k].keys()
        for name in ref[k]:
            assert abs(got[k][name] - ref[k][name]) <= 1e-6, (k, name)
    for k in ("iou_aps", "pose_aps"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
    assert max(got["absolute"].values()) > 0


def test_rescore_without_results_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no results"):
        evaluate_other.rescore(str(tmp_path))
