"""The port's scale-net training CLI (``cli/train_scale.py``) on the CPU.

One run of 6 steps at batch 2 (64² crops, 16² maps, colour augmentation
on), the BatchNorm statistics recalibrated over 2 batches and frozen at
step 3, is held against

  * the JAX CLI (``givepose_tpu/cli/train_scale.py``, jit-compiled) from
    the same initial weights, fed the port's preprocessed batches (its
    ``build_model_batch`` patched) and recording the dropout masks flax
    draws (a ``flax.linen.intercept_methods`` interceptor that reproduces
    ``nn.Dropout`` and hands each mask out through
    ``jax.debug.callback``); the port, fed those masks, matches its
    losses — train-mode steps, the recalibration and the frozen steps —
    within the loss-dict bar, and its final state (the parameters'
    updates and the running statistics, held as the test says);
  * the JAX CLI's host batches: the epochs consumed by its init sample and
    by the recalibration move the sampler's stream alike;
  * the port's own step functions and ``recalibrate_bn`` applied directly:
    the losses and the final state bitwise.

Each preprocessed batch gets seeded noise on its crops and full images
(``texture``): the fixture's images are boxes on black, and train-mode
BatchNorm at batch 2 over nearly constant images amplifies the JAX
package's f32 rounding past the bar
(``test_torch_scale_net.py::test_tower_on_fixture_images_is_f32_accurate``).

``ClippedAdam`` is held against ``optax.chain(clip_by_global_norm,
adam)`` on its own.
"""

from __future__ import annotations

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from givepose_torch.cli import train_scale as cli
from givepose_torch.core.config import Config, parse_overrides
from givepose_torch.models import scale_net as scale_net_mod
from givepose_torch.models.convert_from_flax import flax_to_state_dict
from givepose_torch.models.scale_net import build_scalenet
from givepose_torch.train.adam import ClippedAdam
from givepose_torch.train.schedule import flat_and_anneal

torch.set_num_threads(2)

STEPS = 6
FREEZE_AT = 3            # int(0.5 * STEPS)
RECAL = 2
LOSS_BAR = 2e-5


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    from givepose_torch.data.synthetic import make_synthetic_nocs
    return make_synthetic_nocs(str(tmp_path_factory.mktemp("scale_data")),
                               n_images=4)


def _argv(dirs, save):
    data_dir, ivfc_dir = dirs
    return ["--dataset", "Real", "--dataset_dir", data_dir,
            "--data.ivfc_dir", ivfc_dir, "--batch_size", "2",
            "--train_size", "4", "--total_epoch", "2", "--img_size", "64",
            "--out_res", "16", "--model_save", save, "--log_every", "1",
            "--warmup_iters", "1", "--save_every", "100",
            "--color_aug_prob", "1", "--train.bn_recal_batches", str(RECAL),
            "--train.bn_freeze_point", "0.5"]


def _metrics(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line)["scale_loss"] for line in f]


@pytest.fixture(scope="module")
def initial():
    """The JAX ScaleNet's variables as its CLI creates them (params from
    a seeded numpy draw, BatchNorm statistics at flax's init)."""
    from givepose_tpu.models import ScaleNet as JaxScaleNet

    rng = np.random.default_rng(0)
    sample = {"roi_img": jnp.zeros((2, 64, 64, 3)),
              "full_img": jnp.zeros((2, 64, 64, 3)),
              "one_hot": jnp.zeros((2, 6)), "roi_wh": jnp.ones((2, 2)),
              "mean_size": jnp.ones((2, 3))}
    shapes = jax.eval_shape(JaxScaleNet().init, jax.random.PRNGKey(0),
                            sample)

    def leaf(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "kernel":
            v = rng.normal(0, np.sqrt(1 / np.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "var"):
            v = np.ones(s.shape)
        else:
            v = np.zeros(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def texture(batch: dict, i: int) -> dict:
    """``batch`` with seeded noise (std 0.5) added to its images."""
    gen = torch.Generator().manual_seed(1000 + i)
    out = dict(batch)
    for k in ("roi_img", "full_img"):
        out[k] = batch[k] + 0.5 * torch.randn(batch[k].shape, generator=gen)
    return out


def run_port(argv, variables, masks=None):
    """``cli.train_scale`` from ``variables``, each preprocessed batch
    textured and recorded (raw, preprocessed, textured); dropout masks fed
    from ``masks`` when given."""
    record = []
    original = cli.build_model_batch

    def recorded(raw, draws, cfg, train=True, device=None):
        batch = original(raw, draws, cfg, train=train, device=device)
        textured = texture(batch, len(record))
        record.append(({k: v.copy() for k, v in raw.items()},
                       {k: v.clone() for k, v in batch.items()},
                       textured))
        return textured

    def build(feat_dim, use_hw, device, seed):
        return build_scalenet(feat_dim, use_hw, device,
                              state_dict=flax_to_state_dict(variables))

    fed = [torch.from_numpy(np.array(m)) for m in masks or ()]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_model_batch", recorded)
        mp.setattr(cli, "build_scalenet", build)
        if masks is not None:
            mp.setattr(scale_net_mod, "dropout_keep_mask",
                       lambda *a: fed.pop(0))
        state = cli.train_scale(argv + ["--device", "cpu"],
                                max_steps=STEPS)
    assert not fed
    return state, record


def _dropout_recorder(masks):
    """flax's Dropout, reproduced, with each drawn mask handed out."""
    def interceptor(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if not (isinstance(mod, nn.Dropout)
                and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        deterministic = nn.merge_param("deterministic", mod.deterministic,
                                       kwargs.get("deterministic"))
        x = args[0]
        if deterministic:
            return x
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection),
                                    p=keep, shape=x.shape)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask,
                           ordered=True)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))
    return interceptor


@pytest.fixture(scope="module")
def runs(fixture_dirs, initial, tmp_path_factory):
    from givepose_tpu.cli import train_scale as jax_cli
    from givepose_tpu.models import ScaleNet as JaxScaleNet

    save_a = str(tmp_path_factory.mktemp("port_a"))
    state_a, record_a = run_port(_argv(fixture_dirs, save_a), initial)

    # the JAX CLI on the port's batches, recording its raw batches and
    # its dropout masks
    save_j = str(tmp_path_factory.mktemp("jax"))
    jax_raws, masks = [], []
    feed = iter([record_a[0]] + record_a)        # its init sample first

    def build_model_batch(raw, key, cfg):
        jax_raws.append({k: np.array(v) for k, v in raw.items()})
        batch = next(feed)[2]
        return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "build_model_batch", build_model_batch)
        mp.setattr(JaxScaleNet, "init", lambda self, *a, **k: initial)
        with nn.intercept_methods(_dropout_recorder(masks)):
            jax_state = jax_cli.train_scale(_argv(fixture_dirs, save_j),
                                            max_steps=STEPS)
    jax.effects_barrier()

    save_b = str(tmp_path_factory.mktemp("port_b"))
    state_b, record_b = run_port(_argv(fixture_dirs, save_b), initial,
                                 masks=masks[:2 * FREEZE_AT])
    return {"a": (save_a, state_a, record_a), "b": (save_b, state_b,
                                                    record_b),
            "jax": (save_j, jax_state, jax_raws[1:], masks)}


def test_host_batches_equal_the_jax_cli(runs):
    """Steps 0-3 from sampler epochs 1-2 (epoch 0 went to the init
    sample), the recalibration's 2 batches from epoch 3, steps 4-5 from
    epoch 4: the same raw batches, in the same order, in both CLIs."""
    record = runs["a"][2]
    jax_raws = runs["jax"][2]
    assert len(record) == len(jax_raws) == STEPS + RECAL
    for i, ((raw, _, _), ref) in enumerate(zip(record, jax_raws)):
        assert raw.keys() == ref.keys()
        for k in ref:
            assert raw[k].dtype == ref[k].dtype, (i, k)
            np.testing.assert_array_equal(raw[k], ref[k],
                                          err_msg=f"call {i} {k}")
    # the recalibration's epoch differs from the steps around it
    assert not np.array_equal(record[4][0]["image"], record[6][0]["image"])


def test_losses_and_statistics_equal_the_jax_cli(runs, initial):
    save_b, state_b, record_b = runs["b"]
    save_j, jax_state, _, masks = runs["jax"]
    # 3 train-mode steps and 2 recalibration forwards, 2 masks each
    assert len(masks) == 2 * (FREEZE_AT + RECAL)
    for (_, _, b1), (_, _, b2) in zip(runs["a"][2], record_b):
        for k in b1:
            assert torch.equal(b1[k], b2[k]), k
    got, ref = _metrics(save_b), _metrics(save_j)
    assert len(got) == len(ref) == STEPS
    for i, (g, r) in enumerate(zip(got, ref)):
        assert abs(g - r) <= LOSS_BAR * max(abs(r), 1e-3), (i, g, r)
    # The final state.  Adam turns a gradient that is 0 on one side and
    # ~1e-12 on the other (a channel behind a dead ReLU) into steps of lr
    # of either sign, so parameters are held by the relative L2 of their
    # updates over the run (4.8e-3 when written), not per element; each
    # running mean by its shift in units of its standard deviation (the
    # means of the expand convs' outputs sit near 0 by construction), each
    # running variance relative to itself.
    sd = state_b.model.state_dict()
    ref_sd = flax_to_state_dict({"params": jax_state.params,
                                 "batch_stats": jax_state.batch_stats})
    init = flax_to_state_dict(initial)
    assert sd.keys() == ref_sd.keys()
    params = [k for k in sd if not ("running" in k or "num_batches" in k)]
    num = sum(float(((sd[k] - ref_sd[k]).double() ** 2).sum())
              for k in params)
    den = sum(float(((ref_sd[k] - init[k]).double() ** 2).sum())
              for k in params)
    assert (num / den) ** 0.5 < 2e-2
    for k in sd:
        if k.endswith("running_mean"):
            kv = k.replace("running_mean", "running_var")
            var = ref_sd[kv]
            shift = (sd[k] - ref_sd[k]).abs() / torch.sqrt(var + 1e-3)
            assert shift.max() < 1e-2, k
            assert ((sd[kv] - var).abs() / var).max() < 1e-4, kv
    assert state_b.step == int(jax_state.step) == STEPS
    assert state_b.optimizer.count == STEPS
    assert "scale_ckpt_6" in os.listdir(save_b)


def test_losses_equal_the_steps_applied_directly(runs, fixture_dirs,
                                                 initial):
    save_a, state_a, record = runs["a"]
    cfg = parse_overrides(Config(), _argv(fixture_dirs, "unused"))
    model = build_scalenet(device="cpu",
                           state_dict=flax_to_state_dict(initial))
    state = cli.TrainState(model, cli.make_optimizer(model, cfg))
    step, step_frozen = cli.make_scale_steps(model, cfg)
    steps = record[:FREEZE_AT + 1] + record[FREEZE_AT + 1 + RECAL:]
    losses = []
    for i, (raw, clean, batch) in enumerate(steps):
        gen_pre, gen_step = cli.step_generators(cfg.train.seed, i, "cpu")
        again = cli.build_model_batch(raw, cli.draw_step(gen_pre, 2, cfg),
                                      cfg)
        for k in clean:
            assert torch.equal(again[k], clean[k]), (i, k)
        if i == FREEZE_AT:
            from givepose_torch.data import NocsRecordReader, TrainPipeline
            reader = NocsRecordReader("Real", "train", *fixture_dirs)
            pipeline = TrainPipeline(reader, 2, 4, seed=cfg.train.seed)
            pipeline.skip_epochs(3)        # init, and the epochs 1 and 2
            before = [b.running_var.clone() for b in cli.batch_norms(model)]
            calls = iter(range(FREEZE_AT + 1, FREEZE_AT + 1 + RECAL))
            original = cli.build_model_batch
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cli, "build_model_batch", lambda *a, **k: texture(
                    original(*a, **k), next(calls)))
                assert cli.recalibrate_bn(model, pipeline, cfg, i,
                                          "cpu") == RECAL
            assert not all(torch.equal(a, b.running_var) for a, b in
                           zip(before, cli.batch_norms(model)))
        if i >= FREEZE_AT:
            losses.append(float(step_frozen(state, batch)))
        else:
            losses.append(float(step(state, batch, gen_step)))
    assert losses == _metrics(save_a)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, state_a.model.state_dict()[k]), k


def test_checkpoint_restores_the_state(runs, fixture_dirs, initial):
    from givepose_torch.core.checkpoint import restore_checkpoint

    save_a, state_a, _ = runs["a"]
    cfg = parse_overrides(Config(), _argv(fixture_dirs, "unused"))
    model = build_scalenet(device="cpu",
                           state_dict=flax_to_state_dict(initial))
    state = cli.TrainState(model, cli.make_optimizer(model, cfg))
    restore_checkpoint(os.path.join(save_a, f"scale_ckpt_{STEPS}"), state)
    assert state.step == STEPS and state.optimizer.count == STEPS
    for k, v in state_a.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    for k, v in state_a.optimizer.mu.items():
        assert torch.equal(v, state.optimizer.mu[k]), k


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_clipped_adam_equals_optax(clip):
    """optax.chain(clip_by_global_norm, adam(flat_and_anneal)) over 5
    steps: clipped every step (0.05) or never (100)."""
    from givepose_tpu.train.schedule import flat_and_anneal as jax_sched

    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 3, 5)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sched_args = (1e-2, 40)
    sched_kw = {"warmup_iters": 3, "anneal_point": 0.1}
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adam(jax_sched(*sched_args, **sched_kw)))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    adam = ClippedAdam(tparams, flat_and_anneal(*sched_args, **sched_kw),
                       clip)
    for _ in range(5):
        grads = {k: rng.normal(0, 0.3, s).astype(np.float32)
                 for k, s in shapes.items()}
        grads["b"][2] = 0.0
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in
                                      grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = adam.step({k: torch.from_numpy(v) for k, v in grads.items()})
        assert np.isclose(float(norm), float(optax.global_norm(grads)),
                          rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7)
    assert adam.count == int(jstate[1][0].count) == 5


def test_device_flag(fixture_dirs, tmp_path):
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.train_scale(_argv(fixture_dirs, str(tmp_path)), max_steps=1)
