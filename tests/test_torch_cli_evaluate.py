"""The port's evaluation CLI (``givepose_torch/cli/evaluate.py``) on the
CPU, end to end: checkpoints written by the port's own ``cli/train.py``
(tiny ConvNeXt, one step) and ``cli/train_scale.py`` (two steps), the
fixture's test split with one more image whose detections are empty, and
``--device cpu``.  The eval path's parity with the JAX package's is held in
``tests/test_torch_eval.py``; the Wild6D case (``--data.dataset wild6d``,
JPEG frames from ``tests/data/jpeg``) is held against the JAX CLI run
with the same two models as stand-ins (``jax.disable_jit``), its mAP
arrays within 1e-6.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from givepose_torch.cli import evaluate as cli
from givepose_torch.cli.train import split_device_flag
from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.eval import evaluate as eval_path

torch.set_num_threads(2)

IMG = 64
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "jpeg")


def _add_empty_image(data_dir):
    """A test image whose detection pkl holds no instance."""
    with open(os.path.join(data_dir, "Real/test_list.txt")) as f:
        entries = [line.strip() for line in f if line.strip()]
    src = entries[0]
    dst = src[:-4] + "9999"
    shutil.copy(os.path.join(data_dir, "Real", src + "_color.png"),
                os.path.join(data_dir, "Real", dst + "_color.png"))
    det_dir = os.path.join(data_dir, "detection_dualposenet/data/"
                           "segmentation_results_refine_for_mug/REAL275")
    scene = dst.split("/")[-2]
    det = {"pred_class_ids": np.zeros(0, np.int64),
           "pred_bboxes": np.zeros((0, 4), np.int64),
           "pred_scores": np.zeros(0), "pred_masks": np.zeros((480, 640, 0),
                                                              np.uint8),
           "gt_class_ids": np.zeros(0, np.int64),
           "gt_bboxes": np.zeros((0, 4)), "gt_RTs": np.zeros((0, 4, 4)),
           "gt_scales": np.zeros((0, 3)), "gt_handle_visibility": np.zeros(0)}
    with open(os.path.join(det_dir, f"results_test_{scene}_9999.pkl"),
              "wb") as f:
        pickle.dump(det, f)
    with open(os.path.join(data_dir, "Real/test_list.txt"), "w") as f:
        f.write("\n".join([entries[0], dst] + entries[1:]) + "\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture (train and test splits) and the two CLIs' checkpoints."""
    from givepose_torch.cli.train import train
    from givepose_torch.cli.train_scale import train_scale
    from givepose_torch.data.synthetic import (make_synthetic_eval,
                                               make_synthetic_nocs)

    root = str(tmp_path_factory.mktemp("eval_cli"))
    data_dir, ivfc_dir = make_synthetic_nocs(root, n_images=4, seed=0)
    make_synthetic_eval(root, n_images=3, seed=0)
    _add_empty_image(data_dir)
    common = ["--dataset", "Real", "--dataset_dir", data_dir,
              "--data.ivfc_dir", ivfc_dir, "--img_size", str(IMG),
              "--out_res", "16", "--model.compute_dtype", "float32",
              "--batch_size", "2", "--train_size", "4", "--total_epoch", "1",
              "--device", "cpu"]
    save = os.path.join(root, "pose")
    train(common + ["--model_save", save], max_steps=1,
          backbone_variant="tiny")
    sn_save = os.path.join(root, "scale")
    train_scale(common + ["--model_save", sn_save], max_steps=2)
    return {"root": root, "data_dir": data_dir, "common": common,
            "ckpt": os.path.join(save, "ckpt_1"),
            "sn_ckpt": os.path.join(sn_save, "scale_ckpt_2")}


def _argv(trained, out, *extra):
    return trained["common"] + ["--model_save", out, "--eval.max_instances",
                                "4", "--resume_model", trained["ckpt"],
                                "--sn_path", trained["sn_ckpt"], *extra]


@pytest.fixture(scope="module")
def first_eval(trained, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("eval_out"))
    summary = cli.evaluate(_argv(trained, out), backbone_variant="tiny")
    return out, summary


def test_evaluate_reads_the_clis_checkpoints(trained, first_eval):
    """The summary, the log and the cache under eval_result_<model>, and
    predictions from the checkpoints' weights."""
    from givepose_torch.eval import NocsEvalReader
    from givepose_torch.eval.serving import build_posenet
    from givepose_torch.models.scale_net import build_scalenet

    out, summary = first_eval
    res_dir = os.path.join(out, "eval_result_ckpt_1")
    assert sorted(os.listdir(res_dir)) == ["log_eval.txt", "pred_result.pkl"]
    assert {"IoU25", "10d10cm"} <= summary["absolute"].keys()
    assert "10d50cm" in summary["relative"]
    assert summary["iou_aps"].shape == (8, 4)
    assert summary["pose_aps"].shape == (8, 4, 4)
    with open(os.path.join(res_dir, "log_eval.txt")) as f:
        log = f.read()
    assert "absolute mAP" in log and "scale-normalized mAP" in log

    argv, _ = split_device_flag(_argv(trained, out))
    cfg = parse_overrides(Config(), argv)
    saved = torch.load(trained["ckpt"], weights_only=True)
    sn_saved = torch.load(trained["sn_ckpt"], weights_only=True)
    assert saved["step"] == 1 and sn_saved["step"] == 2
    model = build_posenet(cfg.model, "tiny", device="cpu", img_size=IMG,
                          state_dict=saved["model"])
    scale_model = build_scalenet(device="cpu", state_dict=sn_saved["model"])
    again = eval_path.run_inference(
        NocsEvalReader("Real", trained["data_dir"]), model, scale_model, cfg)
    with open(os.path.join(res_dir, "pred_result.pkl"), "rb") as f:
        cached = pickle.load(f)
    assert len(cached) == len(again) == 4
    for c, a in zip(cached, again):
        for k in ("pred_RTs", "pred_scales"):
            np.testing.assert_array_equal(c[k], a[k])


def test_image_without_instances(first_eval):
    out, _ = first_eval
    with open(os.path.join(out, "eval_result_ckpt_1", "pred_result.pkl"),
              "rb") as f:
        results = pickle.load(f)
    empty = results[1]
    assert len(empty["gt_class_ids"]) == 0
    assert empty["pred_RTs"].shape == (0, 4, 4)
    assert empty["pred_scales"].shape == (0, 3)
    for k in ("pred_class_ids", "pred_scores", "pred_bboxes"):
        assert len(empty[k]) == 0, k
    for r in results[:1] + results[2:]:
        assert r["pred_RTs"].shape == (1, 4, 4)
        assert r["pred_RTs"].dtype == np.float32
        assert np.isfinite(r["pred_RTs"]).all()
        np.testing.assert_allclose(np.linalg.norm(r["pred_scales"], axis=1),
                                   1, rtol=1e-6)


def test_the_cache_is_read_back(trained, first_eval, monkeypatch):
    out, summary = first_eval

    def no_inference(*a, **k):
        raise AssertionError("inference ran despite the cache")

    monkeypatch.setattr(eval_path, "make_inference_fn", no_inference)
    again = cli.evaluate(_argv(trained, out), backbone_variant="tiny")
    assert again["absolute"] == summary["absolute"]
    for k in ("iou_aps", "pose_aps"):
        np.testing.assert_array_equal(again[k], summary[k])


def test_inference_only(trained, tmp_path):
    out = str(tmp_path / "only")
    assert cli.evaluate(_argv(trained, out, "--eval.eval_inference_only",
                              "1"), backbone_variant="tiny") is None
    with open(os.path.join(out, "eval_result_ckpt_1", "pred_result.pkl"),
              "rb") as f:
        assert len(pickle.load(f)) == 4


def test_state_dicts_given_directly(trained, first_eval, tmp_path):
    """``posenet_variables`` / ``scalenet_variables`` are used as given."""
    saved = torch.load(trained["ckpt"], weights_only=True)["model"]
    sn_saved = torch.load(trained["sn_ckpt"], weights_only=True)["model"]
    out = str(tmp_path / "direct")
    argv = trained["common"] + ["--model_save", out,
                                "--eval.max_instances", "4"]
    got = cli.evaluate(argv, backbone_variant="tiny",
                       posenet_variables=saved, scalenet_variables=sn_saved)
    for k in ("iou_aps", "pose_aps"):
        np.testing.assert_array_equal(got[k], first_eval[1][k])
    assert os.listdir(out) == ["eval_result_random"]


def test_use_umeyama_runs_through_the_cli(trained, tmp_path):
    """``--eval.use_umeyama 1``: the depth-assisted pose for every image
    with depth (the fixture writes it; the added empty image has none and
    is skipped), finite mAP, and the same predictions again from the same
    seed."""
    out = str(tmp_path / "u")
    summary = cli.evaluate(_argv(trained, out, "--eval.use_umeyama", "1"),
                           backbone_variant="tiny")
    for part in ("absolute", "relative"):
        assert summary[part] and all(np.isfinite(v)
                                     for v in summary[part].values())
    cache = os.path.join(out, "eval_result_ckpt_1", "pred_result.pkl")
    with open(cache, "rb") as f:
        results = pickle.load(f)
    assert len(results) == 3
    assert all(len(r["gt_class_ids"]) == 1 for r in results)
    for r in results:
        assert r["pred_RTs"].shape == (1, 4, 4)
        assert np.isfinite(r["pred_RTs"]).all()
        assert np.linalg.det(r["pred_RTs"][0, :3, :3]) >= 0
    again = cli.evaluate(_argv(trained, str(tmp_path / "v"),
                               "--eval.use_umeyama", "1",
                               "--eval.eval_inference_only", "1"),
                         backbone_variant="tiny")
    assert again is None
    with open(os.path.join(tmp_path, "v", "eval_result_ckpt_1",
                           "pred_result.pkl"), "rb") as f:
        for r, a in zip(results, pickle.load(f)):
            np.testing.assert_array_equal(r["pred_RTs"], a["pred_RTs"])


@pytest.fixture(scope="module")
def wild(tmp_path_factory):
    """A Wild6D-layout split of 5 JPEG frames, one a category."""
    from givepose_torch.data.synthetic import make_synthetic_wild6d

    root = str(tmp_path_factory.mktemp("wild6d"))
    frames = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
    return make_synthetic_wild6d(root, frames, n_frames=5, seed=0)


class _JaxStandIn:
    """``apply(variables, batch, **kw)`` of a port model on jnp arrays
    (runs only under ``jax.disable_jit``)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, **kw):
        import jax.numpy as jnp

        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        with torch.no_grad():
            out = self.model(tb, **kw)
        if isinstance(out, dict):
            return {k: jnp.asarray(v.numpy()) for k, v in out.items()}
        return jnp.asarray(out.numpy())


def test_wild6d_equals_the_jax_cli(trained, wild, tmp_path):
    """``--data.dataset wild6d``: the JPEG frames read, PoseNet run under
    ``is_wild6d``, the mAP arrays within 1e-6 of the JAX CLI's."""
    import jax
    from givepose_torch.eval.serving import build_posenet
    from givepose_torch.models.scale_net import build_scalenet
    from givepose_tpu.cli import evaluate as jax_cli

    extra = ("--data.dataset", "wild6d", "--dataset_dir", wild)
    summary = cli.evaluate(_argv(trained, str(tmp_path / "port"), *extra),
                           backbone_variant="tiny")
    cache = os.path.join(tmp_path, "port", "eval_result_ckpt_1",
                         "pred_result_all.pkl")
    with open(cache, "rb") as f:
        results = pickle.load(f)
    assert len(results) == 5
    assert all(np.isfinite(r["pred_RTs"]).all() for r in results)

    argv, _ = split_device_flag(_argv(trained, str(tmp_path / "jax"),
                                      *extra))
    cfg = parse_overrides(Config(), argv)
    posenet = build_posenet(cfg.model, "tiny", device="cpu", img_size=IMG,
                            state_dict=torch.load(trained["ckpt"],
                                                  weights_only=True)["model"])
    scalenet = build_scalenet(device="cpu", state_dict=torch.load(
        trained["sn_ckpt"], weights_only=True)["model"])
    calls = []

    def posenet_stand_in(cfg, backbone_variant):
        stand_in = _JaxStandIn(posenet)
        apply = stand_in.apply
        stand_in.apply = lambda v, b, **kw: (calls.append(kw), apply(v, b,
                                                                     **kw))[1]
        return stand_in

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax_cli, "PoseNet", posenet_stand_in)
        mp.setattr(jax_cli, "ScaleNet", lambda **kw: _JaxStandIn(scalenet))
        ref = jax_cli.evaluate(argv, backbone_variant="tiny",
                               posenet_variables={}, scalenet_variables={})
    assert calls and all(kw == {"is_wild6d": True} for kw in calls)
    for k in ("iou_aps", "pose_aps"):
        assert summary[k].shape == np.asarray(ref[k]).shape
        np.testing.assert_allclose(summary[k], np.asarray(ref[k]), rtol=0,
                                   atol=1e-6)
    assert summary["absolute"].keys() == ref["absolute"].keys()


def test_unported_branches_raise(trained, wild, tmp_path):
    """A progressive JPEG frame, which the port does not decode, raises
    naming its ROADMAP item; ``eval_precise`` with ``eval.result_dir``,
    which raised before the plot was ported, writes ``mAP.png`` and
    ``mAP_Acc.pkl``."""
    import cv2

    root = str(tmp_path / "wild_progressive")
    shutil.copytree(wild, root)
    frame = glob.glob(os.path.join(root, "test_set", "*", "*", "*",
                                   "images", "*.jpg"))[0]
    cv2.imwrite(frame, cv2.imread(frame), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.evaluate(_argv(trained, str(tmp_path / "w"), "--data.dataset",
                           "wild6d", "--dataset_dir", root),
                     backbone_variant="tiny")
    plots = str(tmp_path / "plots")
    os.makedirs(plots)
    summary = cli.evaluate(_argv(trained, str(tmp_path / "p"),
                                 "--eval.eval_precise", "1",
                                 "--eval.result_dir", plots),
                           backbone_variant="tiny")
    assert sorted(os.listdir(plots)) == ["mAP.png", "mAP_Acc.pkl"]
    with open(os.path.join(plots, "mAP_Acc.pkl"), "rb") as f:
        saved = pickle.load(f)
    np.testing.assert_array_equal(saved["iou_aps"], summary["iou_aps"])
    assert len(saved["degree_thres_list"]) == 71


def test_device_flag(trained, tmp_path):
    argv = [a for a in _argv(trained, str(tmp_path)) if a not in
            ("--device", "cpu")]
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.evaluate(argv, backbone_variant="tiny")
    with pytest.raises(ValueError, match="--device"):
        cli.evaluate(argv + ["--device", "tpu"], backbone_variant="tiny")
