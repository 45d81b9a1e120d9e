"""The port's PoseNet train step against the JAX package's.

A small PoseNet (custom ConvNeXt, depths 1/1/1/1, 64² crops, 16² maps,
f32 compute, DCNv3 on the plain version) with seeded numpy weights
(``test_torch_posenet.random_variables``: perturbed DCNv3 offset and mask
projections, non-trivial BatchNorm statistics) is carried to the port by
the weight bridge; both sides take the same batch (the fields of
``test_train.tiny_train_batch``).  The weight seed is one whose ReLU
inputs stay clear of zero by more than the two frameworks' f32 rounding:
where an input lies within rounding of zero the two can take different
sides, and the gradient of everything upstream moves by up to a few
percent (seeds 11 and 13 do that, at 7e-4 and 4e-2 of the largest
gradient; f64 sides with JAX there).  For the same reason the losses
along the trajectory are not compared: a near tie in the symmetric
ground truth's argmax (360 rotations 1° apart) can flip.  SizeHead's dropout mask is taken from
JAX (the ``Dropout_0`` output captured with the step's rng) and handed to
the port in place of its own draw.  Bars: loss dict 2e-5; per-leaf
gradients 1e-4·max|JAX leaf|; BatchNorm running statistics 1e-5;
parameters after 7 steps, and after a step continued from a converted JAX
state, atol 2e-5 and rtol 1e-4 (JAX's own bar for a sharded against an
unsharded step, ``tests/test_train.py``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from givepose_tpu.core.config import Config as JaxConfig
from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.core.config import TrainConfig as JaxTrainConfig
from givepose_tpu.losses import PoseLossFn as JaxPoseLossFn
from givepose_tpu.models import PoseNet as JaxPoseNet
from givepose_tpu.train import make_train_step as jax_make_train_step
from givepose_tpu.train.step import TrainState as JaxTrainState
from givepose_tpu.train.step import make_optimizer as jax_make_optimizer

from givepose_torch.core.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from givepose_torch.core.config import Config, ModelConfig, TrainConfig
from givepose_torch.losses.pose_loss import PoseLossFn
from givepose_torch.models import heads
from givepose_torch.models.convert_from_flax import (
    _torch_tree,
    flax_to_state_dict,
    flax_train_state_to_torch,
)
from givepose_torch.train import init_train_state, make_train_step

from test_torch_posenet import random_variables
from test_train import tiny_train_batch

torch.set_num_threads(2)

DEPTHS = (1, 1, 1, 1)
DIMS = (16, 32, 48, 64)
IMG, RES, BATCH, STEPS = 64, 16, 4, 7
TRAIN = dict(batch_size=BATCH, warmup_iters=2, total_epoch=1, train_size=64)


def port_state(variables=None, device="cpu"):
    cfg = Config(model=ModelConfig(compute_dtype="float32"),
                 train=TrainConfig(**TRAIN))
    state = init_train_state(
        cfg, "custom", device=device, backbone_depths=DEPTHS,
        backbone_dims=DIMS, img_size=IMG,
        state_dict=None if variables is None else flax_to_state_dict(
            variables))
    return state, make_train_step(state.model, cfg), cfg


@pytest.fixture(scope="module")
def run():
    """JAX: 7 steps of make_train_step, the dropout mask of each step,
    and the loss and gradients of the first."""
    cfg = JaxConfig(model=JaxModelConfig(compute_dtype="float32"),
                    train=JaxTrainConfig(**TRAIN))
    model = JaxPoseNet(cfg=cfg.model, backbone_variant="custom",
                       backbone_depths=DEPTHS, backbone_dims=DIMS)
    jbatch = tiny_train_batch(np.random.default_rng(0), b=BATCH,
                              out_res=RES, img=IMG)
    variables = random_variables(model, jbatch, seed=12)
    state = JaxTrainState.create(
        variables, jax_make_optimizer(cfg).init(variables["params"]))
    loss_fn = JaxPoseLossFn(cfg.loss, r_type=cfg.model.r_type)
    rngs = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]

    @jax.jit
    def probe(params, batch_stats, rng):
        def loss(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, jbatch,
                train=True, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: m.name == "Dropout_0",
                rngs={"dropout": rng})
            losses = loss_fn(out, jbatch)
            drop = mut["intermediates"]["size_head"]["Dropout_0"]
            return sum(losses.values()), (losses, drop["__call__"][0])

        (_, (losses, drop)), grads = jax.value_and_grad(loss, has_aux=True)(
            params)
        return losses, grads, drop != 0

    losses, grads, _ = probe(state.params, state.batch_stats, rngs[0])
    masks = [np.array(probe(state.params, state.batch_stats, r)[2])
             for r in rngs]
    step, _ = jax_make_train_step(model, cfg)
    states, metrics = [], []
    for r in rngs:
        state, m = step(state, jbatch, r)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(variables=variables, masks=masks, states=states,
                metrics=metrics, losses={k: float(v)
                                         for k, v in losses.items()},
                grads=_torch_tree(grads),
                batch={k: torch.from_numpy(np.array(v))
                       for k, v in jbatch.items()})


@pytest.fixture
def jax_masks(monkeypatch):
    """Feeds SizeHead the given keep masks, one per call, in order."""
    queue = []

    def keep_mask(shape, keep_prob, generator, device):
        mask = torch.from_numpy(queue.pop(0))
        assert tuple(mask.shape) == tuple(shape) and keep_prob == 0.8
        return mask.to(device)

    monkeypatch.setattr(heads, "dropout_keep_mask", keep_mask)
    return queue


def gen(i):
    return torch.Generator().manual_seed(i)


def assert_params_close(model, jax_state, atol=2e-5, rtol=1e-4):
    ref = flax_to_state_dict({"params": jax_state.params,
                              "batch_stats": jax_state.batch_stats})
    got = model.state_dict()
    for k, v in ref.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                       rtol=rtol, err_msg=k)


def test_one_step_matches_jax(run, jax_masks):
    """Loss dict, gradients and BatchNorm statistics of the first step."""
    state, step, cfg = port_state(run["variables"])
    # the gradients, as the step takes them, on a copy of the model
    probe_state, _, _ = port_state(run["variables"])
    jax_masks.append(run["masks"][0])
    out = probe_state.model(run["batch"], train=True, generator=gen(0))
    losses = PoseLossFn(cfg.loss)(out, run["batch"])
    names, params = zip(*probe_state.model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(sum(losses.values()),
                                                params)))
    assert set(grads) == set(run["grads"])
    top = max(g.abs().max().item() for g in run["grads"].values())
    for k, ref in run["grads"].items():
        scale = ref.abs().max().item()
        if scale < 1e-6 * top:
            # zero but for rounding on both sides: the bias ahead of
            # SizeHead's batch-statistics BatchNorm
            assert grads[k].abs().max().item() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(grads[k].numpy(), ref.numpy(),
                                   atol=1e-4 * scale, err_msg=k)

    jax_masks.append(run["masks"][0])
    metrics = step(state, run["batch"], gen(0))
    ref = run["metrics"][0]
    # jit hands JAX's dict back with sorted keys; the order is the module's
    assert list(losses) == ["Rot1", "Tran", "Size", "Point_matching",
                            "nocs_coor", "sp2d_coor"]
    assert set(losses) == set(run["losses"])
    for k in run["losses"]:
        np.testing.assert_allclose(metrics[k].item(), ref[k], atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(),
                               ref["total_loss"], atol=2e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"],
                               rtol=1e-4)
    assert metrics["notfinite_total"] == ref["notfinite_total"] == 0
    assert state.step == 1
    assert_params_close(state.model, run["states"][0])


def test_seven_steps_match_jax(run, jax_masks):
    """Across the adaptive switch and the lookahead sync at step 6."""
    state, step, _ = port_state(run["variables"])
    jax_masks.extend(run["masks"])
    for i in range(STEPS):
        step(state, run["batch"], gen(i))
    assert_params_close(state.model, run["states"][-1])


def test_continues_a_converted_jax_state(run, jax_masks):
    state, step, _ = port_state(run["variables"])
    state.load_state_dict(flax_train_state_to_torch(run["states"][5]))
    assert state.step == 6 and state.optimizer.ranger.step == 6
    jax_masks.append(run["masks"][6])
    step(state, run["batch"], gen(6))
    assert state.step == 7
    assert_params_close(state.model, run["states"][6])


def snapshot(state):
    sd = state.state_dict()
    flat = {f"model.{k}": v for k, v in sd["model"].items()}
    opt = sd["optimizer"]
    for key in ("exp_avg", "exp_avg_sq", "slow"):
        flat.update({f"{key}.{k}": v for k, v in opt["ranger"][key].items()})
    counters = (sd["step"], opt["notfinite_count"], opt["total_notfinite"],
                opt["ranger"]["step"])
    return {k: v.clone() for k, v in flat.items()}, counters


def test_checkpoint_resume_is_exact(run, tmp_path):
    """3 steps, save, restore into a fresh state, 3 more: bitwise the
    same as 6 steps in one go."""
    whole, step_w, _ = port_state(run["variables"])
    for i in range(6):
        step_w(whole, run["batch"], gen(i))

    first, step_f, _ = port_state(run["variables"])
    for i in range(3):
        step_f(first, run["batch"], gen(i))
    path = str(tmp_path / "ckpt_3")
    save_checkpoint(path, first)
    resumed, step_r, _ = port_state()          # other (random) weights
    restore_checkpoint(path, resumed)
    for i in range(3, 6):
        step_r(resumed, run["batch"], gen(i))

    got, got_counters = snapshot(resumed)
    want, want_counters = snapshot(whole)
    assert got_counters == want_counters == (6, 0, 0, 6)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_pruning(run, tmp_path):
    state, _, _ = port_state(run["variables"])
    for i in range(1, 6):
        save_checkpoint(str(tmp_path / f"ckpt_{i}"), state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_4", "ckpt_5"]
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_5")
    save_checkpoint(str(tmp_path / "ckpt_6"), state)       # keep-all
    assert len(os.listdir(tmp_path)) == 3


def test_nonfinite_target_skips_the_update(run):
    """A NaN target: parameters untouched, BatchNorm statistics and the
    step counter advanced, the skip counted."""
    state, step, _ = port_state(run["variables"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = dict(run["batch"])
    batch["translation"] = batch["translation"].clone()
    batch["translation"][0, 0] = float("nan")
    metrics = step(state, batch, gen(0))
    assert metrics["notfinite_total"] == 1
    assert not np.isfinite(metrics["total_loss"].item())
    assert state.step == 1 and state.optimizer.ranger.step == 0
    for k, v in state.model.state_dict().items():
        if "running" in k:
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]), k


def test_init_train_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(backbone_variant="tiny")
