"""The port's eval reader and eval loop against the JAX package's.

On the fixture ``data/synthetic.py`` writes (Real layout, detection pkls):

  * ``NocsEvalReader``, ``WildEvalReader`` (a Wild6D-layout fixture built
    here) and ``load_depth`` (a 3-channel composite and a uint16 PNG)
    return what the JAX readers (OpenCV) return, bitwise, and
    ``build_instance_batch`` builds the JAX function's batch bitwise;
  * ``make_inference_fn``'s pose assembly equals JAX's on the same model
    outputs;
  * the whole eval path, ``run_inference`` then ``evaluate_results``: JAX's
    runs under ``jax.disable_jit()`` with stand-in models whose ``apply``
    converts the batch and calls the port's PoseNet and ScaleNet (held
    against JAX's in ``test_torch_posenet.py`` and
    ``test_torch_scale_net.py``), so no JAX PoseNet is compiled; the
    results and the mAP arrays agree.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.core.config import Config as JaxConfig
from givepose_tpu.core.config import parse_overrides as jax_parse
from givepose_tpu.eval import evaluate as jax_evaluate
from givepose_tpu.eval import load_eval as jax_load

from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.data import png
from givepose_torch.eval import evaluate, load_eval
from givepose_torch.eval.serving import build_posenet
from givepose_torch.models.scale_net import build_scalenet

torch.set_num_threads(2)

IMG = 64
OUT_RES = 16
MAX_INST = 4
DEPTHS = (1, 1, 2, 1)
DIMS = (16, 32, 48, 64)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    from givepose_torch.data.synthetic import make_synthetic_eval
    root = str(tmp_path_factory.mktemp("eval_data"))
    data_dir, _ = make_synthetic_eval(root, n_images=3, seed=1)
    return data_dir


def argv(data_dir, *extra):
    return ["--dataset", "Real", "--dataset_dir", data_dir, "--img_size",
            str(IMG), "--out_res", str(OUT_RES), "--eval.max_instances",
            str(MAX_INST), "--model.compute_dtype", "float32", *extra]


def assert_items_equal(got, ref):
    assert type(got) is type(ref)
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            assert_items_equal(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_items_equal(g, r)
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_nocs_reader_and_batches_equal_jax(eval_dirs):
    port = load_eval.NocsEvalReader("Real", eval_dirs)
    ref = jax_load.NocsEvalReader("Real", eval_dirs)
    assert port.img_list == ref.img_list and len(port) == 3
    for i in range(len(ref)):
        got, want = port.read(i), ref.read(i)
        assert_items_equal(got, want)
        assert got[0].dtype == np.uint8 and got[0].shape == (480, 640, 3)
        for kw in ({}, {"per_obj_id": int(want[1]["pred_class_ids"][0])},
                   {"resize_full": False, "pad_scale": 1.2}):
            b_got = load_eval.build_instance_batch(
                *got, "Real", img_size=IMG, out_res=OUT_RES,
                max_instances=MAX_INST, **kw)
            b_ref = jax_load.build_instance_batch(
                *want, "Real", img_size=IMG, out_res=OUT_RES,
                max_instances=MAX_INST, **kw)
            assert_items_equal(b_got, b_ref)
            batch = b_got[0]
            assert batch["roi_img"].shape == (MAX_INST, IMG, IMG, 3)
            assert batch["valid"].tolist() == [1.0, 0.0, 0.0, 0.0]
            assert batch["full_img"].shape[0] == 1
        depth = port.read_depth(i)
        assert depth.dtype == np.uint16
        np.testing.assert_array_equal(depth, ref.read_depth(i))
    # a class with no detection in the image: no batch in either
    other = int(ref.read(0)[1]["pred_class_ids"][0]) % 6 + 1
    assert load_eval.build_instance_batch(
        *port.read(0), "Real", per_obj_id=other) is None
    assert jax_load.build_instance_batch(
        *ref.read(0), "Real", per_obj_id=other) is None


def test_load_depth_equals_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    composite = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    composite[0, 0] = (7, 125, 1)            # G*256 + R-slot = 32001
    depth16 = rng.integers(0, 65535, (24, 32), dtype=np.uint16)
    gray8 = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    for name, img in (("composite", composite), ("depth16", depth16),
                      ("gray8", gray8)):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        got, ref = load_eval.load_depth(path), jax_load.load_depth(path)
        if ref is None:
            assert got is None
            continue
        assert got.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(got, ref)
    assert load_eval.load_depth(str(tmp_path / "composite.png"))[0, 0] == 0
    assert load_eval.load_depth(str(tmp_path / "missing.png")) is None


def write_wild6d(root, jpeg=False):
    """A Wild6D-layout fixture: test_set/<cat>/<video>/images/<frame>.jpg
    (PNG bytes unless ``jpeg``; both readers decode by content), masks,
    depth, and pkl_annotations/<cat>/<cat>-<video>-<frame>.pkl."""
    import cv2

    rng = np.random.default_rng(3)
    for cat, video, frame in (("bottle", "0001/1", "0000"),
                              ("mug", "0002/3", "0007")):
        base = os.path.join(root, "test_set", cat, video)
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        path = os.path.join(base, "images", f"{frame}.jpg")
        if jpeg:
            cv2.imwrite(path, img)
        else:
            png.imwrite(path, img)
        mask = np.zeros((48, 64, 3), np.uint8)
        mask[10:30, 20:40, 2] = 255
        png.imwrite(os.path.join(base, "masks", f"{frame}.png"), mask)
        png.imwrite(os.path.join(base, "images", f"{frame}-depth.png"),
                    rng.integers(0, 3000, (48, 64), dtype=np.uint16))
        ann_dir = os.path.join(root, "pkl_annotations", cat)
        os.makedirs(ann_dir, exist_ok=True)
        ann = {"K": np.array([[60, 0, 32], [0, 60, 24], [0, 0, 1.0]]),
               "gt_RTs": np.eye(4)[None], "gt_scales": np.ones((1, 3))}
        name = f"{cat}-{video.replace('/', '-')}-{frame}.pkl"
        with open(os.path.join(ann_dir, name), "wb") as f:
            pickle.dump(ann, f)


def test_wild6d_reader_equals_jax(tmp_path):
    root = str(tmp_path / "wild")
    write_wild6d(root)
    port = load_eval.WildEvalReader(root)
    ref = jax_load.WildEvalReader(root)
    assert port.samples == ref.samples and len(port) == 2
    for i in range(len(ref)):
        assert_items_equal(port.read(i), ref.read(i))
        np.testing.assert_array_equal(port.read_depth(i), ref.read_depth(i))
    mug = load_eval.WildEvalReader(root, per_obj="mug")
    assert len(mug) == 1 and mug.read(0)[1]["pred_class_ids"][0] == 6


def test_jpeg_frames_raise(tmp_path):
    root = str(tmp_path / "wild_jpeg")
    write_wild6d(root, jpeg=True)
    assert jax_load.WildEvalReader(root).read(0) is not None
    with pytest.raises(NotImplementedError, match="JPEG"):
        load_eval.WildEvalReader(root).read(0)


class _JaxStandIn:
    """``apply(variables, batch, **kw)``: the batch to torch, a port model,
    the outputs back to jnp arrays (runs only under jax.disable_jit)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, **kw):
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        with torch.no_grad():
            out = self.model(tb, **kw)
        if isinstance(out, dict):
            return {k: jnp.asarray(v.numpy()) for k, v in out.items()}
        return jnp.asarray(out.numpy())


def test_inference_fn_assembly_equals_jax():
    rng = np.random.default_rng(4)
    outs = {"rot": rng.normal(size=(5, 3, 3)).astype(np.float32),
            "trans": rng.normal(size=(5, 3)).astype(np.float32),
            "size": rng.uniform(0.1, 1, (5, 3)).astype(np.float32)}
    scale = rng.uniform(0.05, 0.5, 5).astype(np.float32)

    def posenet(batch, is_wild6d=False):
        return {k: torch.from_numpy(v) for k, v in outs.items()}

    def scalenet(batch):
        return torch.from_numpy(scale)

    class JaxModel:
        def apply(self, variables, batch, is_wild6d=False):
            return {k: jnp.asarray(v) for k, v in outs.items()}

    class JaxScale:
        def apply(self, variables, batch):
            return jnp.asarray(scale)

    posenet.parameters = lambda: iter([torch.zeros(1)])
    batch = {"roi_img": torch.zeros(5, 2, 2, 3)}
    for use_sn in (True, False):
        rt, size = evaluate.make_inference_fn(posenet, scalenet, use_sn)(batch)
        rt_ref, size_ref = jax_evaluate.make_inference_fn(
            JaxModel(), JaxScale(), use_sn)(None, None,
                                            {"roi_img": jnp.zeros((5, 2, 2,
                                                                   3))})
        np.testing.assert_allclose(rt.numpy(), np.asarray(rt_ref), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(size.numpy(), np.asarray(size_ref),
                                   rtol=0, atol=1e-7)
        assert rt.dtype == torch.float32 and (rt[:, 3, 3] == 1).all()


@pytest.mark.parametrize("precise", [False, True])
def test_eval_path_equals_jax(eval_dirs, precise):
    extra = ("--eval.eval_precise", "1") if precise else ()
    cfg = parse_overrides(Config(), argv(eval_dirs, *extra))
    jcfg = jax_parse(JaxConfig(), argv(eval_dirs, *extra))
    model = build_posenet(cfg.model, "custom", device="cpu", seed=0,
                          img_size=IMG, backbone_depths=DEPTHS,
                          backbone_dims=DIMS)
    scale_model = build_scalenet(device="cpu", seed=1)
    reader = load_eval.NocsEvalReader("Real", eval_dirs)
    got = evaluate.run_inference(reader, model, scale_model, cfg)
    with jax.disable_jit():
        ref = jax_evaluate.run_inference(
            jax_load.NocsEvalReader("Real", eval_dirs), _JaxStandIn(model),
            None, _JaxStandIn(scale_model), None, jcfg)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if k in ("pred_RTs", "pred_scales"):
                assert g[k].dtype == r[k].dtype == np.float32
                np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(r[k]))
        assert np.isfinite(g["pred_RTs"]).all()
    maps = evaluate.evaluate_results(got, cfg, log=lambda s: None)
    maps_ref = jax_evaluate.evaluate_results(ref, jcfg, log=lambda s: None)
    assert maps["absolute"].keys() == maps_ref["absolute"].keys()
    assert maps["relative"].keys() == maps_ref["relative"].keys()
    for k in ("iou_aps", "pose_aps"):
        np.testing.assert_allclose(maps[k], maps_ref[k], rtol=0, atol=1e-6)


def test_unported_branches_raise(eval_dirs, tmp_path):
    # the Umeyama path is ported: it skips every image without depth
    cfg = parse_overrides(Config(), argv(eval_dirs, "--eval.use_umeyama",
                                         "1"))
    reader = load_eval.NocsEvalReader("Real", eval_dirs)
    reader.read_depth = lambda i: None
    model = torch.nn.Linear(1, 1)
    assert evaluate.run_inference(reader, model, None, cfg) == []
    cfg = parse_overrides(Config(), argv(eval_dirs, "--eval.eval_precise",
                                         "1", "--eval.result_dir",
                                         str(tmp_path)))
    with pytest.raises(NotImplementedError, match="queue A, item 8"):
        evaluate.evaluate_results([], cfg)
