"""The port's data layer (``givepose_torch/data``, ``ops/resample.py``)
against the JAX package's, on the CPU.

The same fixture (``data/synthetic.py``, seeded) is written by both
packages; records, sampler streams, host batches, preprocessing (fed the
JAX package's own ``jax.random`` draws, split as its code splits them),
the point-cloud augmentations, the bbox helpers and the native bindings
are held against the JAX package's.  Gathered crops, masks, coordinates
and labels are bitwise; arithmetic outputs (colour augmentation,
normalization, the bilinear resize) within 1e-5 * max|ref|.
"""

from __future__ import annotations

import os
import pickle
import random
import shutil
import struct
import tempfile
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra.numpy import arrays
from PIL import Image

import jax
import jax.numpy as jnp

from givepose_torch.data import png

REL_BAR = 1e-5
H, W = 480, 640


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same fixture written by each package: Real train (4 images)
    and CAMERA train (3) in one tree, and a Real eval split."""
    from givepose_tpu.data import synthetic as jsyn
    from givepose_torch.data import synthetic as tsyn

    out = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        root = str(tmp_path_factory.mktemp(f"fixture_{name}"))
        data_dir, ivfc_dir = mod.make_synthetic_nocs(root, n_images=4,
                                                     seed=0)
        mod.make_synthetic_nocs(root, n_images=3, seed=1, source="CAMERA")
        eval_root = os.path.join(root, "eval")
        mod.make_synthetic_eval(eval_root, n_images=2, seed=2)
        out[name] = (root, data_dir, ivfc_dir, eval_root)
    return out


def _files(root):
    found = []
    for d, _, names in os.walk(root):
        found += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(found)


def _assert_tree_equal(a, b, path="."):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _close(got, ref, bar=REL_BAR, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= bar * scale, f"{what}: {err} > {bar} * {scale}"


# ------------------------------------------------------------------- PNG


def _check_imread(path):
    for flag, unchanged in ((cv2.IMREAD_COLOR, False),
                            (cv2.IMREAD_UNCHANGED, True)):
        ref = cv2.imread(path, flag)
        got = png.imread(path, unchanged=unchanged)
        assert ref is not None and got is not None, path
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            path, unchanged, got.shape, got.dtype, ref.shape, ref.dtype)
        np.testing.assert_array_equal(got, ref)


def _shape(channels):
    return st.tuples(st.integers(1, 37), st.integers(1, 41)).map(
        lambda hw: hw if channels is None else (*hw, channels))


CV2_KINDS = {"gray8": (np.uint8, None), "bgr8": (np.uint8, 3),
             "bgra8": (np.uint8, 4), "gray16": (np.uint16, None),
             "bgr16": (np.uint16, 3), "bgra16": (np.uint16, 4)}


@pytest.mark.parametrize("kind", sorted(CV2_KINDS))
@settings(max_examples=12, deadline=None)
@given(data=st.data(), level=st.integers(0, 9), smooth=st.booleans())
def test_imread_equals_cv2_on_cv2_files(kind, data, level, smooth):
    dtype, ch = CV2_KINDS[kind]
    arr = data.draw(arrays(dtype, _shape(ch)))
    if smooth:   # a gradient with noise: libpng picks Sub/Up/Avg/Paeth
        h, w = arr.shape[:2]
        ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 5)
        ramp = ramp.reshape(h, w, *([1] * (arr.ndim - 2)))
        arr = (ramp + arr % 3).astype(dtype)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.png")
        assert cv2.imwrite(path, arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        _check_imread(path)


PIL_KINDS = ("L", "RGB", "RGBA", "P", "P4_trns", "I;16", "LA", "1",
             "RGB_trns", "L_trns")


def _pil_image(kind, rgb):
    if kind in ("P", "P4_trns"):
        return Image.fromarray(rgb).convert(
            "P", palette=Image.ADAPTIVE, colors=7 if kind == "P4_trns"
            else 13)
    if kind == "I;16":
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * 257 + 3)
    if kind == "1":
        return Image.fromarray(rgb[..., 0]).convert("1")
    if kind == "LA":
        return Image.fromarray(rgb[..., :2], "LA")
    if kind in ("L", "L_trns"):
        return Image.fromarray(rgb[..., 0])
    if kind in ("RGB", "RGB_trns"):
        return Image.fromarray(rgb[..., :3])
    return Image.fromarray(np.concatenate(
        [rgb, rgb[..., :1] ^ 0x5A], axis=2), "RGBA")


@pytest.mark.parametrize("kind", PIL_KINDS)
@settings(max_examples=8, deadline=None)
@given(rgb=arrays(np.uint8, _shape(3)), level=st.sampled_from([0, 6, 9]))
def test_imread_equals_cv2_on_pil_files(kind, rgb, level):
    im = _pil_image(kind, rgb)
    kw = {"compress_level": level}
    if kind == "P4_trns":
        kw.update(transparency=bytes([0, 128, 255]), bits=4)
    elif kind == "RGB_trns":
        kw["transparency"] = tuple(int(v) for v in rgb[0, 0])
    elif kind == "L_trns":
        kw["transparency"] = int(rgb[0, 0, 0])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.png")
        im.save(path, **kw)
        _check_imread(path)


def _filters(path):
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        if ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    rowbytes = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (rowbytes + 1)] for y in range(h)}


def test_cv2_files_cover_every_row_filter(tmp_path):
    """The decoder sees every filter type libpng writes (Paeth and
    Average are the recurrences the C++ unfilter exists for)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:96, 0:128]
    img = np.stack([x // 3, y // 2, (x + y) // 4], -1) + rng.integers(
        0, 3, (96, 128, 3))
    seen = set()
    for i, arr in enumerate((img.astype(np.uint8),
                             rng.integers(0, 256, (96, 128, 3),
                                          dtype=np.uint8))):
        for level in (None, 0, 6, 9):   # cv2's default writes Sub rows
            path = str(tmp_path / f"{i}_{level}.png")
            cv2.imwrite(path, arr, [] if level is None
                        else [cv2.IMWRITE_PNG_COMPRESSION, level])
            seen |= _filters(path)
            _check_imread(path)
    assert seen == {0, 1, 2, 3, 4}, seen


@pytest.mark.parametrize("dtype,shape", [
    (np.uint8, (5, 7)), (np.uint8, (5, 7, 3)), (np.uint8, (5, 7, 4)),
    (np.uint16, (5, 7)), (np.uint16, (5, 7, 3)), (np.uint16, (5, 7, 4))])
def test_imwrite_reads_back_in_cv2(tmp_path, dtype, shape):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype,
                       endpoint=True)
    path = str(tmp_path / "w.png")
    assert png.imwrite(path, arr)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  arr)
    np.testing.assert_array_equal(png.imread(path, unchanged=True), arr)
    assert _filters(path) == {0}


def test_interlaced_raises_and_bad_files_are_none(tmp_path):
    path = str(tmp_path / "i.png")
    png.imwrite(path, np.zeros((4, 4), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[28] = 1                                   # IHDR interlace method
    crc = zlib.crc32(bytes(data[12:29]))
    data[29:33] = struct.pack(">I", crc)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.imread(path)
    assert png.imread(str(tmp_path / "missing.png")) is None
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(b"\x89PNG\r\n\x1a\nnot a png at all")
    assert png.imread(bad) is None and cv2.imread(bad) is None


# ------------------------------------------------------------- fixtures


def test_fixture_files_decode_equal(roots):
    jroot, proot = roots["jax"][0], roots["port"][0]
    files = _files(jroot)
    assert files == _files(proot)
    n_png = 0
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".png"):
            n_png += 1
            for flag, unchanged in ((cv2.IMREAD_COLOR, False),
                                    (cv2.IMREAD_UNCHANGED, True)):
                ref = cv2.imread(a, flag)
                got = png.imread(b, unchanged=unchanged)
                assert got.dtype == ref.dtype, rel
                np.testing.assert_array_equal(got, ref, err_msg=rel)
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                _assert_tree_equal(pickle.load(fa), pickle.load(fb), rel)
        else:
            assert open(a).read() == open(b).read(), rel
    assert n_png == 4 * 5 + 3 * 5 + 2 * 5


# ---------------------------------------------------------------- records


def _record_fields(rec):
    import dataclasses
    return dataclasses.asdict(rec) if rec is not None else None


def _assert_records_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is None:
        return
    fa, fb = _record_fields(a), _record_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, (what, k)
            np.testing.assert_array_equal(va, vb, err_msg=f"{what} {k}")
        else:
            assert type(va) is type(vb) and va == vb, (what, k, va, vb)


def _readers(data_dir, ivfc_dir, source="Real", **kw):
    from givepose_tpu.data.records import NocsRecordReader as JR
    from givepose_torch.data.records import NocsRecordReader as TR
    return (JR(source, "train", data_dir, ivfc_dir, **kw),
            TR(source, "train", data_dir, ivfc_dir, **kw))


@pytest.mark.parametrize("source", ["Real", "CAMERA", "CAMERA+Real"])
def test_records_equal_jax_reader(roots, source):
    """Port reader on the port's files == JAX reader on the JAX files."""
    from givepose_tpu.data.records import NocsRecordReader as JR
    from givepose_torch.data.records import NocsRecordReader as TR

    _, jdir, jivfc, _ = roots["jax"]
    _, pdir, pivfc, _ = roots["port"]
    jr = JR(source, "train", jdir, jivfc)
    tr = TR(source, "train", pdir, pivfc)
    assert len(jr) == len(tr) and jr.subset_len == tr.subset_len
    for i in range(len(jr)):
        a = jr.read(i, random.Random(i))
        b = tr.read(i, random.Random(i))
        assert a is not None
        a.img_path = a.img_path.replace(jdir, pdir)
        _assert_records_equal(a, b, f"{source} {i}")


def _clone_fixture(roots, tmp_path):
    _, jdir, jivfc, _ = roots["jax"]
    root = tmp_path / "clone"
    shutil.copytree(os.path.dirname(jdir), root)
    return str(root / "NOCS"), str(root / "IVFC")


def _edit_label(data_dir, name, edit):
    path = os.path.join(data_dir, "Real/train/scene_1", name + "_label.pkl")
    with open(path, "rb") as f:
        gts = pickle.load(f)
    edit(gts)
    with open(path, "wb") as f:
        pickle.dump(gts, f)


def _three_instances(gts, classes=(6, 6, 2)):
    n = len(classes)
    gts["class_ids"] = np.array(classes)
    gts["instance_ids"] = np.array([1, 2, 3])
    gts["model_list"] = gts["model_list"] * n
    for k in ("bboxes", "scales", "rotations", "translations"):
        gts[k] = np.repeat(gts[k], n, axis=0)


@pytest.mark.parametrize("case", [
    "zero_instances", "per_obj_absent", "per_obj_present", "ban_mug",
    "invalid", "stale_model", "missing_color", "missing_ivfc"])
def test_record_bad_sample_paths_match(roots, tmp_path, case):
    """The bad-sample paths (records.py:194-262) give None, or the same
    record, in both readers."""
    data_dir, ivfc_dir = _clone_fixture(roots, tmp_path)
    kw = {}
    if case == "zero_instances":
        _edit_label(data_dir, "0000", lambda g: g.update(
            instance_ids=np.array([], int), class_ids=np.array([], int)))
    elif case in ("per_obj_absent", "per_obj_present"):
        _edit_label(data_dir, "0000", _three_instances)
        kw["per_obj"] = "bottle" if case == "per_obj_absent" else "mug"
    elif case == "ban_mug":
        for name in ("0000", "0001"):
            _edit_label(data_dir, name, _three_instances)
        _edit_label(data_dir, "0002",
                    lambda g: _three_instances(g, (6, 6, 6)))
        kw["ban_mug"] = True
    elif case == "stale_model":
        _edit_label(data_dir, "0001",
                    lambda g: g.update(model_list=["gone"]))
    elif case == "missing_color":
        os.remove(os.path.join(data_dir, "Real/train/scene_1/0002_color.png"))
    elif case == "missing_ivfc":
        os.remove(os.path.join(ivfc_dir, "Real/train/scene_1/0003_coor_0.png"))
    jr, tr = _readers(data_dir, ivfc_dir, **kw)
    if case == "invalid":
        for r in (jr, tr):
            r.add_invalid(os.path.join(data_dir, "Real/train/scene_1/0001"), 1)
        jr, tr = _readers(data_dir, ivfc_dir, **kw)   # re-read the cache
    reads = {}
    for i in range(len(jr)):
        for seed in range(3):
            a = jr.read(i, random.Random(seed))
            b = tr.read(i, random.Random(seed))
            _assert_records_equal(a, b, f"{case} {i} {seed}")
            reads[i, seed] = a
    none_at = {"zero_instances": 0, "per_obj_absent": 0, "invalid": 1,
               "stale_model": 1, "missing_color": 2}.get(case)
    for (i, seed), rec in reads.items():
        if not case.startswith("per_obj") or i == 0:
            assert (rec is None) == (i == none_at), (case, i, seed)
    if case == "per_obj_present":
        assert all(reads[0, s].cat_id0 == 5 for s in range(3))
    if case == "ban_mug":   # redrawn off the mugs where it can be
        assert all(reads[0, s].inst_id == 3 for s in range(3))
        assert all(reads[2, s].cat_id0 == 5 for s in range(3))
    if case == "missing_ivfc":
        assert not reads[3, 0].ivfc_mask.any()


# ------------------------------------------------------- sampler, pipeline


@pytest.mark.parametrize("cam,real,size,ratio", [
    (0, 5, 7, 3.0), (6, 0, 4, 3.0), (6, 3, 16, 3.0), (2, 7, 40, 0.5),
    (100, 4, 9, 3.0)])
def test_sampler_streams_equal(cam, real, size, ratio):
    from givepose_tpu.data.sampler import EpochSampler as JS
    from givepose_torch.data.sampler import EpochSampler as TS

    for seed in (0, 3):
        js, ts = JS(cam, real, size, ratio, seed), TS(cam, real, size,
                                                      ratio, seed)
        for _ in range(6):
            np.testing.assert_array_equal(ts.epoch_indices(),
                                          js.epoch_indices())


def _pipelines(data_dir, ivfc_dir, source="CAMERA+Real", **kw):
    from givepose_tpu.data import TrainPipeline as JP
    from givepose_torch.data import TrainPipeline as TP
    jr, tr = _readers(data_dir, ivfc_dir, source)
    return JP(jr, **kw), TP(tr, **kw)


def _assert_batches_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_pipeline_batches_equal_two_epochs(roots):
    _, jdir, jivfc, _ = roots["jax"]
    jp, tp = _pipelines(jdir, jivfc, batch_size=2, train_size=6, seed=4)
    jp.skip_epochs(1)
    tp.skip_epochs(1)
    for epoch in range(2):
        jb, tb = list(jp.epoch()), list(tp.epoch())
        assert len(jb) == len(tb) == 3
        for i, (a, b) in enumerate(zip(jb, tb)):
            _assert_batches_equal(a, b, f"epoch {epoch} batch {i}")
    assert len(tp.read_seconds) == 6


def test_pipeline_two_process_split_equal(roots):
    _, jdir, jivfc, _ = roots["jax"]
    whole = None
    parts = []
    for pid in range(2):
        jp, tp = _pipelines(jdir, jivfc, batch_size=4, train_size=8,
                            seed=2, process_id=pid, num_processes=2)
        jb, tb = list(jp.epoch()), list(tp.epoch())
        assert len(tb) == 2 and tb[0]["image"].shape[0] == 2
        for i, (a, b) in enumerate(zip(jb, tb)):
            _assert_batches_equal(a, b, f"process {pid} batch {i}")
        parts.append(tb)
    _, tp = _pipelines(jdir, jivfc, batch_size=4, train_size=8, seed=2)
    whole = list(tp.epoch())
    for t in range(2):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][t]["bbox"], parts[1][t]["bbox"]]),
            whole[t]["bbox"])


def test_process_local_indices_equal():
    from givepose_tpu.core.mesh import process_local_indices as jpl
    from givepose_torch.core.mesh import process_local_indices as tpl

    idx = np.random.default_rng(0).permutation(64)
    for n in (1, 2, 4):
        for p in range(n):
            np.testing.assert_array_equal(
                tpl(idx, 16, process_id=p, num_processes=n),
                jpl(idx, 16, process_id=p, num_processes=n))


def test_abandoned_epoch_generator_releases_worker(roots):
    """next(iter(epoch())) abandons the generator; the prefetch worker
    must exit rather than block on the bounded queue, pinning batches."""
    from givepose_torch.data import NocsRecordReader, TrainPipeline

    _, data_dir, ivfc_dir, _ = roots["port"]
    pipe = TrainPipeline(NocsRecordReader("Real", "train", data_dir,
                                          ivfc_dir), batch_size=1,
                         train_size=4)
    before = set(threading.enumerate())
    next(iter(pipe.epoch()))     # generator collected right here
    deadline = time.time() + 10
    while time.time() < deadline:
        extra = [t for t in set(threading.enumerate()) - before
                 if t.is_alive()]
        if not extra:
            break
        time.sleep(0.1)
    assert not extra, f"leaked worker threads: {extra}"


def test_pipeline_propagates_worker_errors(roots):
    from givepose_torch.data import NocsRecordReader, TrainPipeline

    _, data_dir, ivfc_dir, _ = roots["port"]
    pipe = TrainPipeline(NocsRecordReader("Real", "train", data_dir,
                                          ivfc_dir), batch_size=2,
                         train_size=4)

    def bad_read(indices, rng):
        raise RuntimeError("worker boom")

    pipe._read_batch = bad_read
    with pytest.raises(RuntimeError, match="worker boom"):
        list(pipe.epoch())


# ------------------------------------------------------------ preprocess


def _jax_draws(key, b, img_size, color_aug_prob, mask_pro):
    """The JAX package's draws, split as its code splits them
    (preprocess.py:121 and dzi_jitter :55, augment.py:72, :109)."""
    k_dzi, k_color, k_mask = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_dzi)
    draws = {"dzi": {
        "ratio": np.array(jax.random.uniform(k1, (b,), minval=-1.0,
                                               maxval=1.0)),
        "shift": np.asarray(jax.random.uniform(k2, (b, 2), minval=-1.0,
                                               maxval=1.0))}}
    if color_aug_prob > 0:
        keys = jax.random.split(k_color, 10)
        ops = [(0.3, (0.0, 2.0)), (0.5, (0.5, 1.5)), (0.5, (0.5, 1.5)),
               (0.3, (0.0, 3.0))]
        gates, factors = [], []
        for i, (p, (lo, hi)) in enumerate(ops):
            gates.append(np.asarray(jax.random.uniform(keys[1 + 2 * i],
                                                       (b,)) < p))
            factors.append(np.asarray(jax.random.uniform(
                keys[2 + 2 * i], (b,), minval=lo, maxval=hi)))
        draws["color"] = {
            "apply": np.asarray(jax.random.uniform(keys[0], (b,))
                                < color_aug_prob),
            "gate": np.stack(gates, 1), "factor": np.stack(factors, 1),
            "order": np.asarray(jnp.argsort(jax.random.uniform(
                keys[9], (b, 4)), axis=1))}
    k_apply, k_fill = jax.random.split(k_mask)
    draws["mask"] = {
        "apply": np.asarray(jax.random.uniform(k_apply, (b,)) < mask_pro),
        "fill": np.asarray(jax.random.bernoulli(k_fill, 0.5,
                                                (b, img_size, img_size)))}
    # writable copies (torch does not take read-only arrays silently)
    return jax.tree_util.tree_map(np.array, draws)


BITWISE = ("roi_mask", "roi_mask_output", "roi_mask_deform", "nocs_coord",
           "ivfc_coord", "roi_ivfc_mask_output", "roi_coord_2d", "one_hot",
           "bbox_center", "img_scale", "resize_ratio", "roi_wh", "cam_K",
           "rotation", "translation", "nocs_scale", "real_size",
           "mean_size", "sym_info", "model_point", "cat_id0")


@pytest.fixture(scope="module")
def raw_batch(roots):
    """Two records of the fixture, collated (B=2, 480 x 640); the bboxes
    of the second moved to the frame's corner so that crops leave it."""
    from givepose_torch.data import NocsRecordReader, collate_records

    _, data_dir, ivfc_dir, _ = roots["port"]
    r = NocsRecordReader("Real", "train", data_dir, ivfc_dir)
    batch = collate_records([r.read(i, random.Random(i)) for i in (0, 1)])
    batch["bbox"][1] = [590.0, -20.0, 655.5, 40.25]
    return batch


@pytest.mark.parametrize("train,seed", [(True, 0), (True, 1), (True, 5),
                                        (False, 0)])
def test_preprocess_equals_jax(raw_batch, train, seed):
    from givepose_tpu.data.preprocess import preprocess_batch as jpre
    from givepose_torch.data import preprocess_batch

    key = jax.random.PRNGKey(seed)
    prob = 1.0
    ref = jpre(key, {k: jnp.asarray(v) for k, v in raw_batch.items()},
               train=train, color_aug_prob=prob if train else 0.0)
    draws = _jax_draws(key, 2, 256, prob, 0.5) if train else {}
    got = preprocess_batch(raw_batch, draws, train=train,
                           color_aug_prob=prob if train else 0.0)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.dtype,
                                                           r.dtype)
        if k in BITWISE or (k == "roi_img_origin" and not train):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            _close(g, r, what=k)
    if train and draws["mask"]["apply"][0]:   # sample 0's object is in view
        assert not np.array_equal(got["roi_mask_deform"][0].numpy(),
                                  got["roi_mask"][0].numpy())


def test_crop_ops_equal_jax_on_random_inputs():
    """Nearest gathers bitwise and the bilinear resize within the bar,
    against the JAX one-hot / two-tap matmuls, at random centers and
    scales (many out of the frame)."""
    from givepose_tpu.ops import resample as jr
    from givepose_torch.ops import resample as tr
    from givepose_torch.data.preprocess import _full_resize

    rng = np.random.default_rng(3)
    b, h, w = 6, 48, 64
    img = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    centers = rng.uniform(-10, 74, (b, 2)).astype(np.float32)
    scales = rng.uniform(3, 90, (b,)).astype(np.float32)
    for size in (16, 37):
        ref = jax.jit(jr.batched_crop_resize, static_argnums=(3, 4))(
            img, centers, scales, size, "nearest")
        a, bx, by = tr.affine_crop_params_np(centers, scales, size)
        rows, rok = tr.nearest_index(a, by, size, h)
        cols, cok = tr.nearest_index(a, bx, size, w)
        got = tr.crop_nearest(torch.from_numpy(img), rows, rok, cols, cok)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    full = jnp.einsum("oh,bhwc->bowc", jr.resize_matrix(
        h, 32, jnp.float32(h / 32), jnp.float32(0.5 * h / 32 - 0.5)), img,
        precision="highest")
    full = jnp.einsum("pw,bowc->bopc", jr.resize_matrix(
        w, 32, jnp.float32(w / 32), jnp.float32(0.5 * w / 32 - 0.5)), full,
        precision="highest")
    wy, wx = _full_resize(h, w, 32)
    got = tr.resize_bilinear(torch.from_numpy(img), torch.from_numpy(wy),
                             torch.from_numpy(wx))
    _close(got.numpy(), np.asarray(full), what="bilinear")
    # the host mirrors are copies
    arr = img[0]
    np.testing.assert_array_equal(
        tr.crop_resize_affine_np(arr, centers[0], scales[0], 16),
        jr.crop_resize_affine_np(arr, centers[0], scales[0], 16))
    np.testing.assert_array_equal(tr.resize_image_np(arr, 20),
                                  jr.resize_image_np(arr, 20))
    np.testing.assert_array_equal(
        tr.crop_coord_2d_np(centers[1], scales[1], 16, w, h),
        jr.crop_coord_2d_np(centers[1], scales[1], 16, w, h))


def test_port_draws_ranges_and_permutations():
    from givepose_torch.data import draw_preprocess

    d = draw_preprocess(torch.Generator().manual_seed(0), 64, img_size=32)
    assert ((d["dzi"]["ratio"] >= -1) & (d["dzi"]["ratio"] < 1)).all()
    assert ((d["dzi"]["shift"] >= -1) & (d["dzi"]["shift"] < 1)).all()
    c = d["color"]
    for i, (lo, hi) in enumerate([(0, 2), (0.5, 1.5), (0.5, 1.5), (0, 3)]):
        f = c["factor"][:, i]
        assert ((f >= lo) & (f < hi)).all() and f.max() - f.min() > 0.5
    order = c["order"].numpy()
    np.testing.assert_array_equal(np.sort(order, axis=1),
                                  np.tile(np.arange(4), (64, 1)))
    assert len({tuple(r) for r in order}) > 8
    assert c["apply"].dtype == torch.bool and 0.6 < c["apply"].float(
        ).mean() < 0.95
    assert d["mask"]["fill"].shape == (64, 32, 32)
    assert 0.45 < d["mask"]["fill"].float().mean() < 0.55
    assert draw_preprocess(torch.Generator(), 4, train=False) == {}
    same = draw_preprocess(torch.Generator().manual_seed(0), 64,
                           img_size=32)
    assert torch.equal(same["mask"]["fill"], d["mask"]["fill"])


# ------------------------------------------------- augment3d, bbox, native


def test_augment3d_equals_jax():
    from scipy.spatial.transform import Rotation as SR

    from givepose_tpu.data import augment3d as ja
    from givepose_torch.data import augment3d as ta

    rng = np.random.default_rng(0)
    b, n = 6, 48
    rots = SR.random(b, random_state=np.random.RandomState(2)).as_matrix()
    aug_r = SR.random(b, random_state=np.random.RandomState(3)).as_matrix()
    data = {
        "rotation": rots.astype(np.float32),
        "translation": (rng.normal(size=(b, 3)) * 0.1 + [0, 0, 1]
                        ).astype(np.float32),
        "real_size": rng.uniform(0.08, 0.3, (b, 3)).astype(np.float32),
        "model_point": rng.uniform(-0.4, 0.4, (b, n, 3)).astype(np.float32),
        "sym_info": np.array([[1, 1, 0, 1], [0, 1, 0, 0]] * 3, np.float32),
        "cat_id0": np.array([1, 5, 0, 1, 5, 2], np.int32),
        "aug_bb": rng.uniform(0.8, 1.2, (b, 3)).astype(np.float32),
        "aug_rt_t": rng.uniform(-0.02, 0.02, (b, 3)).astype(np.float32),
        "aug_rt_R": aug_r.astype(np.float32),
    }
    pc = (rng.normal(size=(b, n, 3)) * 0.05 + [0, 0, 1]).astype(np.float32)
    nocs = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = ja.pc_augment(key, jnp.asarray(pc), jnp.asarray(nocs),
                        {k: jnp.asarray(v) for k, v in data.items()},
                        aug_bb_pro=0.5, aug_rt_pro=0.5, aug_bc_pro=0.9,
                        aug_pc_pro=0.5)
    keys = jax.random.split(key, 8)
    k_up, k_down = jax.random.split(keys[3])
    draws = {
        "gate_bb": np.asarray(jax.random.uniform(keys[0], (b,)) < 0.5),
        "gate_rt": np.asarray(jax.random.uniform(keys[1], (b,)) < 0.5),
        "gate_bc": np.asarray(jax.random.uniform(keys[2], (b,)) < 0.9),
        "ey_up": np.asarray(jax.random.uniform(k_up, (b, 1), minval=0.8,
                                               maxval=1.2)),
        "ey_down": np.asarray(jax.random.uniform(k_down, (b, 1),
                                                 minval=0.8, maxval=1.2)),
        "gate_pc": np.asarray(jax.random.uniform(keys[4], (b,)) < 0.5),
        "noise": np.asarray(jax.random.uniform(keys[5], (b, n, 3),
                                               minval=-0.002,
                                               maxval=0.002)),
    }
    draws = jax.tree_util.tree_map(np.array, draws)   # writable copies
    for g in ("gate_bb", "gate_rt", "gate_bc", "gate_pc"):
        assert 0 < draws[g].sum() < b, g       # both branches exercised
    got = ta.pc_augment(torch.from_numpy(pc), torch.from_numpy(nocs),
                        {k: torch.from_numpy(v) for k, v in data.items()},
                        draws)
    _close(got[0].numpy(), np.asarray(ref[0]), 1e-6, "pc")
    _close(got[1].numpy(), np.asarray(ref[1]), 1e-6, "nocs")
    for k in ref[2]:
        _close(got[2][k].numpy(), np.asarray(ref[2][k]), 1e-6, k)
    own = ta.pc_augment_draws(torch.Generator().manual_seed(0), 256, 8)
    assert ((own["ey_up"] >= 0.8) & (own["ey_up"] < 1.2)).all()
    assert own["noise"].abs().max() <= 0.002
    assert 0.15 < own["gate_pc"].float().mean() < 0.25


def test_bbox_utils_equal_jax():
    from givepose_tpu.data import bbox_utils as jb
    from givepose_torch.data import bbox_utils as tb

    rng = np.random.default_rng(0)
    for _ in range(200):
        y1, x1 = rng.integers(-60, 500, 2)
        box = (int(y1), int(x1), int(y1 + rng.integers(1, 480)),
               int(x1 + rng.integers(1, 640)))
        other = tuple(int(v) for v in rng.integers(-50, 600, 4))
        assert tb.get_bbox_square(box) == jb.get_bbox_square(box)
        assert tb.get_real_hw(box) == jb.get_real_hw(box)
        assert tb.bbox_iou_2d(box, other) == jb.bbox_iou_2d(box, other)


def test_native_bindings_equal_jax(roots, tmp_path):
    from givepose_tpu.data import native_loader as jn
    from givepose_torch.data import native_loader as tn

    assert tn.available(), "libpng headers are present here"
    assert str(tn.SOURCE).endswith("native/src/givepose_host.cpp")
    if not jn.available():
        pytest.skip("the JAX package's committed library does not load")
    _, data_dir, _, _ = roots["port"]
    color = os.path.join(data_dir, "Real/train/scene_1/0000_color.png")
    depth = os.path.join(data_dir, "Real/train/scene_1/0000_depth.png")
    np.testing.assert_array_equal(tn.decode_png_rgb(color),
                                  jn.decode_png_rgb(color))
    np.testing.assert_array_equal(tn.decode_png_depth(depth),
                                  jn.decode_png_depth(depth))
    assert tn.decode_png_rgb(str(tmp_path / "none.png")) is None
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)
    for src in (img, img.astype(np.uint8)):
        np.testing.assert_array_equal(
            tn.affine_crop(src, (25.3, 19.7), 30.7, 32, False),
            jn.affine_crop(src, (25.3, 19.7), 30.7, 32, False))
        # the committed library was built with -march=native, where g++
        # contracts the bilinear weights' products into FMAs
        _close(tn.affine_crop(src, (25.3, 19.7), 30.7, 32, True),
               jn.affine_crop(src, (25.3, 19.7), 30.7, 32, True),
               what=f"bilinear crop {src.dtype}")
    mask = (rng.uniform(size=(30, 40)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(tn.mask_band(mask), jn.mask_band(mask))
    loader = tn.PrefetchLoader([color, color], n_threads=2)
    try:
        np.testing.assert_array_equal(loader.get(1),
                                      jn.decode_png_rgb(color))
    finally:
        loader.close()
