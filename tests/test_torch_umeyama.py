"""The port's RANSAC-Umeyama fit and its eval path against the JAX package.

  * ``umeyama_similarity``: exact recovery, batched inputs, weights and
    the reflection case, against JAX's within 1e-5;
  * ``ransac_umeyama`` with injected draws: the test computes JAX's
    ``(128, 5)`` hypothesis indices from a key by JAX's own split, Gumbel
    and top-k, feeds them to the port's fit and holds the result to JAX's
    ``ransac_umeyama`` on the same key (noise-free inliers and far
    outliers, so that no inlier decision sits at the threshold), also with
    fewer than 5 valid points (the refit on all valid points);
  * the port's own draw (``draw_hypotheses``) recovers a similarity from
    data with outliers;
  * ``umeyama_pose_from_maps`` against JAX's with injected draws;
  * the port's reader and ``build_instance_batch``: the fixture's GT NOCS
    crop and depth crop recover the GT similarity;
  * ``run_inference`` with ``eval.use_umeyama`` on the tiny backbone:
    images without depth skipped, sRTs of the form s * R, finite mAP.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from givepose_tpu.eval import umeyama_pose as jax_pose
from givepose_tpu.geometry import umeyama as jax_um

from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.data import png
from givepose_torch.eval import evaluate, load_eval
from givepose_torch.eval.serving import build_posenet
from givepose_torch.eval.umeyama_pose import umeyama_pose_from_maps
from givepose_torch.geometry import umeyama
from givepose_torch.geometry.errors import rotation_error_deg
from givepose_torch.models.scale_net import build_scalenet
from givepose_torch.ops.resample import crop_resize_affine_np

torch.set_num_threads(2)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def synthetic(rng, n=256, noise=0.0, outliers=0, far=0.0):
    """Source points in the NOCS cube and their image under a similarity;
    ``outliers`` targets moved by N(0, 0.5) or, with ``far``, by ``far``
    metres in a random direction."""
    src = rng.uniform(-0.5, 0.5, size=(n, 3))
    s = 0.37
    R = ScipyRot.from_euler("xyz", rng.uniform(-1, 1, 3)).as_matrix()
    t = np.array([0.1, -0.2, 1.4])
    tgt = s * src @ R.T + t + noise * rng.normal(size=(n, 3))
    if outliers:
        idx = rng.choice(n, size=outliers, replace=False)
        move = rng.normal(size=(outliers, 3))
        if far:
            move *= far / np.linalg.norm(move, axis=1, keepdims=True)
        else:
            move *= 0.5
        tgt[idx] += move
    return (src.astype(np.float32), tgt.astype(np.float32), s, R, t)


def jax_hypotheses(key, valid, num_hypotheses=128, sample_size=5):
    """JAX's ``ransac_umeyama`` draw: per hypothesis key of
    ``jax.random.split``, Gumbel noise on the validity logits, top-k."""
    valid = jnp.asarray(valid, jnp.float32)
    logits = jnp.where(valid > 0, 0.0, -1e9)

    def one(k):
        g = jax.random.gumbel(k, (valid.shape[0],)) + logits
        return jax.lax.top_k(g, sample_size)[1]

    return np.asarray(jax.vmap(one)(jax.random.split(key, num_hypotheses)))


def assert_fit_equal(got, ref, tol=TOL):
    for k in ("scale", "rotation", "translation", "inlier_ratio"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", ["exact", "batched", "weighted",
                                  "reflection"])
def test_umeyama_similarity_equals_jax(case):
    rng = np.random.default_rng(0)
    weights = None
    if case == "batched":
        sets = [synthetic(rng) for _ in range(4)]
        src = np.stack([s[0] for s in sets])
        tgt = np.stack([s[1] for s in sets])
    elif case == "reflection":
        # a planar set: without the sign fix its SVD gives det(R) < 0
        src = rng.uniform(-0.5, 0.5, size=(64, 3)).astype(np.float32)
        src[:, 2] = 0
        R = ScipyRot.from_euler("z", 0.3).as_matrix()
        tgt = (src @ R.T).astype(np.float32)
    else:
        src, tgt, *_ = synthetic(rng, noise=0.01 if case == "weighted"
                                 else 0.0)
        if case == "weighted":
            weights = rng.uniform(0, 1, len(src)).astype(np.float32)
            weights[::7] = 0
    got = umeyama.umeyama_similarity(
        _t(src), _t(tgt), None if weights is None else _t(weights))
    ref = jax_um.umeyama_similarity(
        jnp.asarray(src), jnp.asarray(tgt),
        None if weights is None else jnp.asarray(weights))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)
    assert (torch.linalg.det(got[1]) > 0).all()
    if case == "exact":
        np.testing.assert_allclose(float(got[0]), 0.37, rtol=1e-5)


@pytest.mark.parametrize("case", ["far_outliers", "few_valid"])
def test_ransac_with_injected_draws_equals_jax(case):
    rng = np.random.default_rng(1)
    if case == "far_outliers":
        src, tgt, s, R, t = synthetic(rng, n=256, outliers=60, far=3.0)
        valid = np.ones(256, np.float32)
        valid[rng.choice(256, 20, replace=False)] = 0
    else:
        # 3 valid points: every sample takes invalid ones, fewer than 5
        # inliers remain and the refit takes all valid points
        src, tgt, *_ = synthetic(rng, n=64)
        valid = np.zeros(64, np.float32)
        valid[[3, 17, 40]] = 1
    key = jax.random.PRNGKey(3)
    hyp = jax_hypotheses(key, valid)
    assert hyp.shape == (128, 5)
    got = umeyama.ransac_umeyama(_t(src), _t(tgt), _t(valid),
                                 hypotheses=torch.from_numpy(np.array(hyp)))
    ref = jax_um.ransac_umeyama(jnp.asarray(src), jnp.asarray(tgt),
                                valid=jnp.asarray(valid), key=key)
    assert_fit_equal(got, ref)
    if case == "far_outliers":
        assert float(got["inlier_ratio"]) == pytest.approx(
            float(np.asarray(ref["inlier_ratio"])), abs=0)
        np.testing.assert_allclose(float(got["scale"]), s, rtol=1e-5)
        assert float(rotation_error_deg(got["rotation"], _t(R))) < 0.01
    else:
        # the refit on all valid points: the weighted fit on them alone
        s_all, r_all, t_all = umeyama.umeyama_similarity(
            _t(src), _t(tgt), _t(valid))
        np.testing.assert_allclose(got["scale"].numpy(), s_all.numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got["rotation"].numpy(), r_all.numpy(),
                                   rtol=0, atol=TOL)


def test_own_draw_recovers_with_outliers():
    rng = np.random.default_rng(2)
    src, tgt, s, R, t = synthetic(rng, n=256, noise=1e-4, outliers=60)
    gen = torch.Generator().manual_seed(3)
    out = umeyama.ransac_umeyama(_t(src), _t(tgt), generator=gen)
    np.testing.assert_allclose(float(out["scale"]), s, rtol=1e-2)
    assert float(rotation_error_deg(out["rotation"], _t(R))) < 1.0
    np.testing.assert_allclose(out["translation"].numpy(), t, atol=5e-3)
    # the same seed draws the same hypotheses
    again = umeyama.ransac_umeyama(_t(src), _t(tgt),
                                   generator=torch.Generator().manual_seed(3))
    for k in out:
        torch.testing.assert_close(out[k], again[k], rtol=0, atol=0)


def test_draw_takes_valid_points_only():
    valid = torch.zeros(2, 100)
    valid[0, ::3] = 1
    valid[1, 50:60] = 1
    hyp = umeyama.draw_hypotheses(valid, torch.Generator().manual_seed(0))
    assert hyp.shape == (2, 128, 5) and hyp.dtype == torch.int64
    for b in range(2):
        assert bool(valid[b][hyp[b]].all())
        # a sample's points are distinct
        assert all(len(set(row.tolist())) == 5 for row in hyp[b])


def test_backproject_depth_equals_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 2.0, (24, 32)).astype(np.float32)
    depth[::5, ::3] = 0
    mask = (rng.uniform(size=(24, 32)) > 0.3).astype(np.float32)
    k = np.array([[500.0, 0, 15.5], [0, 500.0, 11.0], [0, 0, 1]],
                 np.float32)
    pts, valid = umeyama.backproject_depth(_t(depth), _t(k), _t(mask))
    pts_ref, valid_ref = jax_um.backproject_depth(
        jnp.asarray(depth), jnp.asarray(k), jnp.asarray(mask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_ref), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))


def test_umeyama_pose_from_maps_equals_jax():
    """Three instances of 16 x 16 cells: NOCS points seen through K at
    their exact pixels and depths, a mask, holes in the depth, far
    outliers in depth; the third instance has 4 valid cells."""
    rng = np.random.default_rng(5)
    b, r = 3, 16
    cam_k = np.tile(np.array([[591.0, 0, 322.5], [0, 590.0, 244.1],
                              [0, 0, 1]], np.float32), (b, 1, 1))
    nocs = rng.uniform(-0.5, 0.5, (b, r, r, 3)).astype(np.float32)
    px = np.zeros((b, r, r), np.float32)
    py = np.zeros((b, r, r), np.float32)
    depth = np.zeros((b, r, r), np.float32)
    for i in range(b):
        rot = ScipyRot.from_euler("xyz", rng.uniform(-1, 1, 3)).as_matrix()
        cam = (0.2 + 0.1 * i) * nocs[i] @ rot.T + np.array([0.05, -0.1,
                                                              0.9 + 0.2 * i])
        depth[i] = cam[..., 2]
        px[i] = cam[..., 0] * 591.0 / cam[..., 2] + 322.5
        py[i] = cam[..., 1] * 590.0 / cam[..., 2] + 244.1
    mask = (rng.uniform(size=(b, r, r)) > 0.2).astype(np.float32)
    depth[:, ::4, ::5] = 0
    far = rng.uniform(size=(b, r, r)) < 0.15
    depth[far] += 2.0
    mask[2] = 0
    mask[2, 3, 1:5] = 1
    depth[2, 3, 1:5] = 1.0
    valid = ((mask.reshape(b, -1) > 0) & (depth.reshape(b, -1) > 0))
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, b)
    hyp = np.stack([jax_hypotheses(keys[i], valid[i]) for i in range(b)])
    got = umeyama_pose_from_maps(_t(nocs), _t(px), _t(py), _t(depth),
                                 _t(mask), _t(cam_k),
                                 hypotheses=torch.from_numpy(np.array(hyp)))
    ref = jax_pose.umeyama_pose_from_maps(
        jnp.asarray(nocs), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(cam_k), key)
    assert got["rotation"].shape == (b, 3, 3)
    assert_fit_equal(got, ref)


# --- the eval path on the port's fixture ---------------------------------

IMG = 64
OUT_RES = 16


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    from givepose_torch.data.synthetic import make_synthetic_eval
    root = str(tmp_path_factory.mktemp("umeyama_eval"))
    data_dir, _ = make_synthetic_eval(root, n_images=3, seed=1)
    return data_dir


def gt_nocs_crop(img_path, center, scale, out_res):
    """The fixture's GT NOCS map cropped as the batch crops depth."""
    enc = png.imread(img_path + "_coord.png")[:, :, ::-1]
    nocs = enc.astype(np.float32) / 255.0 - 0.5
    nocs[:, :, 2] = -nocs[:, :, 2]          # stored z-flipped
    return crop_resize_affine_np(nocs, center, scale, out_res, "nearest")


def test_depth_crop_and_gt_nocs_recover_pose(eval_dir):
    reader = load_eval.NocsEvalReader("Real", eval_dir)
    image, det, cam_k = reader.read(0)
    depth = reader.read_depth(0)
    assert depth is not None and depth.dtype == np.uint16
    out_res = 64
    batch, keep = load_eval.build_instance_batch(
        image, det, cam_k, "Real", img_size=128, out_res=out_res,
        max_instances=4, depth=depth)
    assert batch["roi_depth"].shape == (4, out_res, out_res)
    assert (batch["roi_depth"][0] > 0).sum() > 30
    img_path = os.path.join(eval_dir, reader.img_list[0])
    nocs = gt_nocs_crop(img_path, batch["bbox_center"][0],
                        batch["img_scale"][0], out_res)[None]
    im_h, im_w = image.shape[:2]
    cx2 = batch["roi_coord_2d"][:1]
    px = (cx2[..., 0] * (im_w - 1) + (im_w - 1)) * 0.5
    py = (cx2[..., 1] * (im_h - 1) + (im_h - 1)) * 0.5
    fit = umeyama_pose_from_maps(
        _t(nocs), _t(px), _t(py), _t(batch["roi_depth"][:1]),
        _t(batch["roi_mask_out"][:1]), _t(batch["cam_K"][:1]),
        generator=torch.Generator().manual_seed(0))
    with open(img_path + "_label.pkl", "rb") as f:
        gts = pickle.load(f)
    gt_scale = gts["scales"][0]
    assert abs(float(fit["scale"][0]) - gt_scale) < 0.05 * gt_scale
    np.testing.assert_allclose(fit["translation"][0].numpy(),
                               gts["translations"][0], atol=0.02)
    r_err = float(rotation_error_deg(fit["rotation"][0],
                                     _t(gts["rotations"][0])))
    assert r_err < 5.0, r_err


def test_run_inference_with_use_umeyama(eval_dir, tmp_path):
    """``run_inference`` with ``eval.use_umeyama``: the tiny backbone's
    random NOCS maps through the fit, an image without depth skipped, the
    sRTs s * R with R a rotation, finite mAP; the same seed repeats."""
    import shutil

    data_dir = str(tmp_path / "data")
    shutil.copytree(eval_dir, data_dir)
    reader = load_eval.NocsEvalReader("Real", data_dir)
    os.remove(os.path.join(data_dir, reader.img_list[1] + "_depth.png"))
    cfg = parse_overrides(Config(), [
        "--dataset", "Real", "--dataset_dir", data_dir, "--img_size",
        str(IMG), "--out_res", str(OUT_RES), "--eval.max_instances", "4",
        "--model.compute_dtype", "float32", "--eval.use_umeyama", "1"])
    model = build_posenet(cfg.model, "tiny", device="cpu", seed=0,
                          img_size=IMG)
    scale_model = build_scalenet(device="cpu", seed=1)
    results = evaluate.run_inference(reader, model, scale_model, cfg)
    assert len(results) == 2
    names = [reader.img_list[i] for i in (0, 2)]
    for r, name in zip(results, names):
        _, det, _ = reader.read(reader.img_list.index(name))
        np.testing.assert_array_equal(r["gt_RTs"], det["gt_RTs"])
        assert r["pred_RTs"].shape == (1, 4, 4)
        assert r["pred_RTs"].dtype == np.float32
        assert r["pred_scales"].shape == (1, 3)
        rt = r["pred_RTs"][0]
        assert np.isfinite(rt).all() and (rt[3] == [0, 0, 0, 1]).all()
        sr = rt[:3, :3].astype(np.float64)
        s = np.cbrt(np.linalg.det(sr))
        assert s >= 0
        if s > 0:
            rot = sr / s
            np.testing.assert_allclose(rot.T @ rot, np.eye(3), atol=1e-4)
    summary = evaluate.evaluate_results(results, cfg, log=lambda *_: None)
    for v in summary["absolute"].values():
        assert np.isfinite(v)
    again = evaluate.run_inference(reader, model, scale_model, cfg)
    for r, a in zip(results, again):
        np.testing.assert_array_equal(r["pred_RTs"], a["pred_RTs"])
