"""The port's training CLI (``givepose_torch/cli/train.py``) on the CPU.

The config overrides are held against the JAX package's
``parse_overrides``; the CLI (``--device cpu``, the tiny ConvNeXt, 64²
crops, 16² maps, f32, colour augmentation on) against:

  * the JAX CLI's host batches: the JAX package's reader and
    ``TrainPipeline`` with the JAX CLI's first epoch consumed
    (``cli/train.py:107``, its init sample) feed the same raw batches;
  * the port's own ``make_train_step`` applied directly to the
    preprocessed batches with the same per-step generators: the losses
    bitwise (``tests/test_torch_train_step.py`` holds that step against
    JAX's; no JAX PoseNet is compiled here);
  * itself: a run stopped by ``--restart_every`` (exit 75) and resumed
    ends bitwise where the uninterrupted run does.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from givepose_torch.cli import train as cli
from givepose_torch.core.config import Config, parse_overrides

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    from givepose_torch.data.synthetic import make_synthetic_nocs
    return make_synthetic_nocs(str(tmp_path_factory.mktemp("cli_data")),
                               n_images=4)


def _argv(dirs, save, *extra):
    data_dir, ivfc_dir = dirs
    return ["--dataset", "Real", "--dataset_dir", data_dir,
            "--data.ivfc_dir", ivfc_dir, "--batch_size", "2",
            "--train_size", "4", "--total_epoch", "2", "--img_size", "64",
            "--out_res", "16", "--model_save", save, "--log_every", "1",
            "--model.compute_dtype", "float32", "--warmup_iters", "1",
            "--save_every", "100", "--color_aug_prob", "1",
            "--device", "cpu", *extra]


def _recorded_train(argv, record=None, corrupt=None, **kw):
    """``cli.train`` with each step's raw batch and preprocessed batch
    appended to ``record`` (and ``corrupt(step, batch)`` applied)."""
    original = cli.build_model_batch
    calls = []

    def wrapped(raw, draws, cfg, train=True, device=None):
        batch = original(raw, draws, cfg, train=train, device=device)
        if corrupt is not None:
            corrupt(len(calls), batch)
        calls.append(1)
        if record is not None:
            record.append(({k: v.copy() for k, v in raw.items()},
                           {k: v.clone() for k, v in batch.items()}))
        return batch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_model_batch", wrapped)
        return cli.train(argv, backbone_variant="tiny", **kw)


def _metrics(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def reference_run(fixture_dirs, tmp_path_factory):
    """The uninterrupted run: 2 epochs of 2 steps."""
    save = str(tmp_path_factory.mktemp("cli_ref"))
    record = []
    state = _recorded_train(_argv(fixture_dirs, save), record)
    return {"save": save, "state": state, "record": record}


# ------------------------------------------------------------- overrides


def _value_for(current, i):
    if isinstance(current, bool):
        return ("true", "0", "yes", "off")[i % 4]
    if isinstance(current, int):
        return str(7 + i)
    if isinstance(current, float):
        return str(0.25 + i / 8)
    if isinstance(current, tuple):
        return "4,2" if i % 2 else "(8)"
    return f"value_{i}"


@pytest.mark.parametrize("section", ["data", "model", "loss", "train",
                                     "eval"])
def test_parse_overrides_equals_jax(section):
    """Every alias of the section, and the dotted form of each of its
    fields, in both spellings (``--f v`` and ``--f=v``)."""
    from givepose_tpu.core.config import Config as JaxConfig
    from givepose_tpu.core.config import _FLAG_ALIASES as JAX_ALIASES
    from givepose_tpu.core.config import parse_overrides as jax_parse
    from givepose_torch.core.config import _FLAG_ALIASES

    assert _FLAG_ALIASES == JAX_ALIASES
    fields = dataclasses.asdict(getattr(Config(), section))
    argvs = []
    for i, (alias, (sec, name)) in enumerate(sorted(_FLAG_ALIASES.items())):
        if sec == section:
            argvs.append([f"--{alias}", _value_for(fields[name], i)])
    for i, (name, current) in enumerate(sorted(fields.items())):
        if current is None:
            continue
        argvs.append([f"--{section}.{name}={_value_for(current, i + 1)}"])
    argvs.append(sum(argvs, []))       # all at once
    for argv in argvs:
        got = parse_overrides(Config(), argv).to_dict()
        ref = jax_parse(JaxConfig(), argv).to_dict()
        assert got == ref, argv
        assert parse_overrides(Config(), argv).to_json() == \
            jax_parse(JaxConfig(), argv).to_json()


@pytest.mark.parametrize("argv", [["--no_such_flag", "1"],
                                  ["--train.no_such_field", "1"],
                                  ["--nosection.batch_size", "1"],
                                  ["--batch_size"]])
def test_bad_overrides_raise_in_both(argv):
    from givepose_tpu.core.config import Config as JaxConfig
    from givepose_tpu.core.config import parse_overrides as jax_parse

    with pytest.raises(ValueError):
        jax_parse(JaxConfig(), argv)
    with pytest.raises(ValueError):
        parse_overrides(Config(), argv)


# -------------------------------------------------------------------- CLI


def test_cli_trains_and_checkpoints(reference_run, fixture_dirs):
    from givepose_tpu.core.config import Config as JaxConfig
    from givepose_tpu.core.config import parse_overrides as jax_parse

    save = reference_run["save"]
    assert reference_run["state"].step == 4
    assert "ckpt_4" in os.listdir(save)
    rows = _metrics(save)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    assert all(r["data_wait_ms"] >= 0 for r in rows)
    assert rows[0]["read_ms"] > 0
    argv, device = cli.split_device_flag(_argv(fixture_dirs, save))
    assert device == "cpu"
    with open(os.path.join(save, "config.json")) as f:
        assert f.read() == jax_parse(JaxConfig(), argv).to_json()
    batch = reference_run["record"][0][1]
    assert batch["roi_img"].shape == (2, 64, 64, 3)
    assert batch["roi_coord_2d"].shape == (2, 16, 16, 2)


def test_cli_trains_on_the_jax_cli_host_batches(reference_run,
                                                 fixture_dirs):
    """The JAX CLI reads its init sample with next(iter(pipeline.epoch()))
    (cli/train.py:107), so its step 1 trains on sampler epoch 1; the
    port's first three steps train on the same raw batches."""
    from givepose_tpu.core.config import Config as JaxConfig
    from givepose_tpu.core.config import parse_overrides as jax_parse
    from givepose_tpu.data import NocsRecordReader, TrainPipeline

    argv, _ = cli.split_device_flag(_argv(fixture_dirs, "unused"))
    cfg = jax_parse(JaxConfig(), argv)
    reader = NocsRecordReader(cfg.data.dataset, "train",
                              cfg.data.dataset_dir, cfg.data.ivfc_dir)
    pipeline = TrainPipeline(reader, cfg.train.batch_size,
                             cfg.train.train_size, cfg.data.syn_ratio,
                             seed=cfg.train.seed)
    next(iter(pipeline.epoch()))
    jax_raws = [raw for _ in range(2) for raw in pipeline.epoch()][:3]
    for step, (ref, (raw, _)) in enumerate(zip(jax_raws,
                                               reference_run["record"])):
        assert ref.keys() == raw.keys()
        for k in ref:
            assert raw[k].dtype == ref[k].dtype, (step, k)
            np.testing.assert_array_equal(raw[k], ref[k],
                                          err_msg=f"step {step} {k}")


def test_cli_losses_equal_the_step_applied_directly(reference_run,
                                                    fixture_dirs):
    from givepose_torch.train import init_train_state, make_train_step

    argv, _ = cli.split_device_flag(_argv(fixture_dirs, "unused"))
    cfg = parse_overrides(Config(), argv)
    state = init_train_state(cfg, "tiny", device="cpu", seed=cfg.train.seed,
                             img_size=cfg.data.img_size)
    step = make_train_step(state.model, cfg)
    rows = _metrics(reference_run["save"])
    for i, (raw, batch) in enumerate(reference_run["record"]):
        gen_pre, gen_step = cli.step_generators(cfg.train.seed, i, "cpu")
        again = cli.preprocess_batch(
            raw, cli.draw_step(gen_pre, 2, cfg), img_size=64, out_res=16,
            color_aug_prob=1.0)
        for k in batch:
            assert torch.equal(again[k], batch[k]), (i, k)
        m = step(state, batch, gen_step)
        assert float(m["total_loss"]) == rows[i]["total_loss"], i
        assert float(m["grad_norm"]) == rows[i]["grad_norm"], i
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, reference_run["state"].model.state_dict()[k]), k


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.state_dict(), b.state_dict()

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), path
            for i, (p, q) in enumerate(zip(x, y)):
                walk(p, q, f"{path}/{i}")
        elif torch.is_tensor(x):
            assert torch.equal(x, y), path
        else:
            assert x == y, (path, x, y)

    walk(sa, sb, "")


def test_restart_and_resume_equal_the_uninterrupted_run(reference_run,
                                                        fixture_dirs,
                                                        tmp_path):
    save = str(tmp_path / "interrupted")
    record = []
    with pytest.raises(SystemExit) as exc:
        _recorded_train(_argv(fixture_dirs, save, "--restart_every", "1"),
                        record)
    assert exc.value.code == 75
    assert "ckpt_2" in os.listdir(save)
    state = _recorded_train(_argv(fixture_dirs, save, "--restart_every",
                                  "1", "--resume", "1"), record)
    _assert_states_equal(state, reference_run["state"])
    ref = reference_run["record"]
    assert len(record) == len(ref) == 4
    for (raw, batch), (rraw, rbatch) in zip(record, ref):
        for k in raw:
            np.testing.assert_array_equal(raw[k], rraw[k])
        for k in batch:
            assert torch.equal(batch[k], rbatch[k]), k
    got = [r["total_loss"] for r in _metrics(save)]
    assert got == [r["total_loss"] for r in _metrics(reference_run["save"])]


def test_quant_dense_is_refused(fixture_dirs, tmp_path):
    with pytest.raises(ValueError, match="SERVING"):
        cli.train(_argv(fixture_dirs, str(tmp_path), "--quant_dense", "1"),
                  backbone_variant="tiny")


def test_failure_seam_dumps_batch_and_state(fixture_dirs, tmp_path):
    """A non-finite loss target: the step is skipped, and the log point
    dumps the raw batch and the state into exception/."""
    save = str(tmp_path / "seam")

    def corrupt(step, batch):
        if step == 0:
            batch["translation"][0, 0] = float("nan")

    state = _recorded_train(_argv(fixture_dirs, save), corrupt=corrupt,
                            max_steps=1)
    assert state.optimizer.total_notfinite == 1
    dump = os.path.join(save, "exception")
    assert sorted(os.listdir(dump)) == ["state_1", "step1.npz"]
    with np.load(os.path.join(dump, "step1.npz")) as z:
        assert z["image"].shape == (2, 480, 640, 3)


def test_device_flag():
    assert cli.split_device_flag(["--a", "1", "--device", "cpu"]) == (
        ["--a", "1"], "cpu")
    assert cli.split_device_flag(["--device=cuda"]) == ([], "cuda")
    assert cli.split_device_flag(["--a", "1"]) == (["--a", "1"], None)
    with pytest.raises(ValueError):
        cli.split_device_flag(["--device", "tpu"])
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.train(["--dataset", "Real"])


def test_step_generators_are_counter_based():
    a = cli.step_generators(3, 17, "cpu")
    b = cli.step_generators(3, 17, "cpu")
    c = cli.step_generators(3, 18, "cpu")
    draws = [torch.rand(4, generator=g) for g in (*a, *b, *c)]
    assert torch.equal(draws[0], draws[2]) and torch.equal(draws[1],
                                                           draws[3])
    assert not torch.equal(draws[0], draws[4])
    assert not torch.equal(draws[0], draws[1])


def test_train_durable_relaunches_on_75(monkeypatch):
    from givepose_torch.cli import train_durable

    codes = iter([75, 75, 3])
    cmds = []

    class Done:
        def __init__(self, code):
            self.returncode = code

    def fake_run(cmd):
        cmds.append(cmd)
        return Done(next(codes))

    monkeypatch.setattr(train_durable.subprocess, "run", fake_run)
    assert train_durable.train_durable(["--batch_size", "2"]) == 3
    assert len(cmds) == 3
    assert cmds[0][1:3] == ["-m", "givepose_torch.cli.train"]
    assert cmds[0][3:] == ["--batch_size", "2", "--restart_every", "20"]
    assert all(c[-2:] == ["--resume", "1"] for c in cmds[1:])
