"""The port's windowed DCNv3 (``dcn_window > 0``) against the JAX package.

- The plain windowed forward (``dcnv3_core(..., window=w)``) against the
  TPU kernel ``dcnv3_windowed_pallas`` in interpret mode with f32
  compute (atol 1e-5, the op's parity bar): stride 1 and 2, offsets that
  put most samples on the clamp, offsets placed exactly on the window's
  bound, and a ragged last row tile of the TPU kernel.
- The windowed backward against ``jax.grad`` of the clamped JAX core
  (atol 1e-5), where the clamp holds most samples and where samples lie
  on its bound (``jnp.clip``'s gradient is 0.5 there).
- One PoseNet train step at ``dcn_window=4`` (custom backbone, f32, DCNv3
  offset projections scaled so that the clamp holds some samples in every
  layer) against ``make_train_step``: loss dict 2e-5, every gradient
  leaf 1e-4 * max|JAX leaf|, parameters after the step atol 2e-5 and
  rtol 1e-4 (the bars of ``test_torch_train_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.core.config import Config as JaxConfig
from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.core.config import TrainConfig as JaxTrainConfig
from givepose_tpu.losses import PoseLossFn as JaxPoseLossFn
from givepose_tpu.models import PoseNet as JaxPoseNet
from givepose_tpu.ops.dcnv3 import dcnv3_core as jax_dcnv3_core
from givepose_tpu.ops.dcnv3_window_pallas import dcnv3_windowed_pallas
from givepose_tpu.train import make_train_step as jax_make_train_step
from givepose_tpu.train.step import TrainState as JaxTrainState
from givepose_tpu.train.step import make_optimizer as jax_make_optimizer

from givepose_torch.core.config import Config, ModelConfig, TrainConfig
from givepose_torch.losses.pose_loss import PoseLossFn
from givepose_torch.models import heads
from givepose_torch.models.convert_from_flax import (_torch_tree,
                                                     flax_to_state_dict)
from givepose_torch.models.dcnv3_module import DCNv3
from givepose_torch.ops.dcnv3 import dcnv3_core, dcnv3_sampling_locations
from givepose_torch.train import init_train_state, make_train_step

from test_torch_dcnv3 import make_inputs
from test_torch_posenet import random_variables
from test_torch_train_step import assert_params_close
from test_train import tiny_train_batch

torch.set_num_threads(2)


def on_bound(off, window, kernel=3):
    """Offsets that put every tap of every query exactly on the window's
    bound: x on the high side, y on the low side (grid of tap (i, j):
    x = i - half, y = j - half, offset_scale 1)."""
    half = (kernel - 1) // 2
    lin = np.arange(kernel) - half
    gx, gy = np.repeat(lin, kernel), np.tile(lin, kernel)
    o = off.reshape(*off.shape[:3], -1, kernel * kernel, 2).copy()
    o[..., 0] = window - gx
    o[..., 1] = -window - gy
    return o.reshape(off.shape).astype(np.float32)


# (seed, h, w, group, gc, stride, window, offset multiplier, on bound)
FWD_CASES = {
    "s1_w3": (1, 9, 8, 2, 8, 1, 3, 2.0, False),
    "s2_w4": (2, 12, 10, 2, 8, 2, 4, 2.0, False),
    "s2_w4_mostly_clamped": (3, 12, 10, 2, 8, 2, 4, 8.0, False),
    "s2_w1": (4, 8, 8, 4, 8, 2, 1, 2.0, False),
    "s2_w4_on_bound": (5, 10, 10, 2, 8, 2, 4, 0.0, True),
    # h_out 11, w_out 16: the TPU kernel's row tile of 8 leaves a ragged
    # last tile (tests/test_dcnv3.py::test_tile_geometry_odd_height)
    "s1_w3_ragged_tile": (6, 11, 16, 2, 16, 1, 3, 2.0, False),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_windowed_forward_matches_pallas(case):
    seed, h, w, g, gc, stride, window, mult, bound = FWD_CASES[case]
    x, off, m = make_inputs(seed, n=2, h=h, w=w, group=g, gc=gc,
                            stride=stride, offset_mult=mult)
    if bound:
        off = on_bound(off, window)
    ref = np.asarray(dcnv3_windowed_pallas(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(m), stride=stride,
        group=g, window=window, interpret=True, compute_dtype=jnp.float32))
    out = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(m), stride=stride, group=g,
                     window=window).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def clamped_share(off, h, w, stride, group, window, kernel=3):
    """Share of sample coordinates the window clamp moves or holds on its
    bound."""
    off = torch.from_numpy(off)
    ho, wo = off.shape[1:3]
    loc = dcnv3_sampling_locations(off, h + 2, w + 2, kernel, stride, 1,
                                   group, 1.0)
    half = (kernel - 1) // 2
    cx = half + stride * torch.arange(wo)[None, None, :, None, None]
    cy = half + stride * torch.arange(ho)[None, :, None, None, None]
    on = ((loc[..., 0] - cx).abs() >= window) | ((loc[..., 1] - cy).abs()
                                                  >= window)
    return on.float().mean().item()


@pytest.mark.parametrize("mult,bound,least_share", [
    (8.0, False, 0.5), (0.0, True, 1.0), (1.0, False, 0.0)])
def test_windowed_grads_match_jax(mult, bound, least_share):
    stride, g, window = 2, 2, 4
    x, off, m = make_inputs(20 + int(mult), n=1, h=10, w=9, group=g, gc=8,
                            stride=stride, offset_mult=mult)
    if bound:
        off = on_bound(off, window)
    assert clamped_share(off, 10, 9, stride, g, window) >= least_share
    kw = dict(kernel=3, stride=stride, pad=1, dilation=1, group=g,
              offset_scale=1.0, window=window)
    ho, wo = off.shape[1:3]
    cot = np.random.default_rng(9).normal(
        size=(1, ho, wo, x.shape[-1])).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jax_dcnv3_core(a, b, c, **kw) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(off),
                                            jnp.asarray(m))
    tx, toff, tm = (torch.from_numpy(a).requires_grad_() for a in (x, off, m))
    (dcnv3_core(tx, toff, tm, **kw) * torch.from_numpy(cot)).sum().backward()
    for name, t, j in (("x", tx, jg[0]), ("offset", toff, jg[1]),
                       ("mask", tm, jg[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   err_msg=name)
    if bound:   # half of the unclamped gradient reaches the offsets
        assert np.abs(np.asarray(jg[1])).max() > 1e-2


DEPTHS = (1, 1, 1, 1)
DIMS = (16, 32, 48, 64)
IMG, RES, BATCH, WINDOW = 64, 16, 4, 4
TRAIN = dict(batch_size=BATCH, warmup_iters=2, total_epoch=1, train_size=64)
# DCNv3 offsets of ~1.6 px (std): the clamp holds a few samples per
# mille in each layer (the op tests above hold most of them).  Larger
# offsets make the step's gradients ill-conditioned between the two
# frameworks with or without a window (at 5x, leaves differ by up to
# ~10 %, window 0 alike), as the weight seed can (see
# test_torch_train_step.py); seed 20 keeps every leaf within 3.3e-5 of
# its bar's scale.
OFFSET_GAIN = 2.0
WEIGHT_SEED = 20


def wide_offsets(variables):
    """The seeded weights with every DCNv3 offset kernel scaled up."""
    def leaf(path, v):
        names = [getattr(k, "key", str(k)) for k in path]
        return v * OFFSET_GAIN if names[-2:] == ["offset", "kernel"] else v

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def run():
    """JAX at dcn_window=4: the first step's losses, gradients and dropout
    mask, and the state after one make_train_step step."""
    cfg = JaxConfig(model=JaxModelConfig(compute_dtype="float32",
                                         dcn_window=WINDOW),
                    train=JaxTrainConfig(**TRAIN))
    model = JaxPoseNet(cfg=cfg.model, backbone_variant="custom",
                       backbone_depths=DEPTHS, backbone_dims=DIMS)
    jbatch = tiny_train_batch(np.random.default_rng(0), b=BATCH,
                              out_res=RES, img=IMG)
    variables = wide_offsets(random_variables(model, jbatch,
                                              seed=WEIGHT_SEED))
    state = JaxTrainState.create(
        variables, jax_make_optimizer(cfg).init(variables["params"]))
    loss_fn = JaxPoseLossFn(cfg.loss, r_type=cfg.model.r_type)
    rng = jax.random.PRNGKey(100)

    @jax.jit
    def probe(params, batch_stats):
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

    losses, grads, mask = probe(state.params, state.batch_stats)
    step, _ = jax_make_train_step(model, cfg)
    state, metrics = step(state, jbatch, rng)
    return dict(variables=variables, mask=np.array(mask),
                state=jax.tree_util.tree_map(np.asarray, state),
                metrics={k: float(v) for k, v in metrics.items()},
                losses={k: float(v) for k, v in losses.items()},
                grads=_torch_tree(grads),
                batch={k: torch.from_numpy(np.array(v))
                       for k, v in jbatch.items()})


def port_state(variables):
    cfg = Config(model=ModelConfig(compute_dtype="float32",
                                   dcn_window=WINDOW),
                 train=TrainConfig(**TRAIN))
    state = init_train_state(cfg, "custom", device="cpu",
                             backbone_depths=DEPTHS, backbone_dims=DIMS,
                             img_size=IMG,
                             state_dict=flax_to_state_dict(variables))
    return state, make_train_step(state.model, cfg), cfg


@pytest.fixture
def jax_mask(run, monkeypatch):
    """SizeHead takes JAX's dropout keep mask instead of drawing one."""
    def keep_mask(shape, keep_prob, generator, device):
        assert tuple(shape) == run["mask"].shape and keep_prob == 0.8
        return torch.from_numpy(run["mask"]).to(device)

    monkeypatch.setattr(heads, "dropout_keep_mask", keep_mask)


def test_windowed_step_grads_match_jax(run, jax_mask):
    state, _, cfg = port_state(run["variables"])
    model = state.model
    offsets = []
    hooks = [m.offset.register_forward_hook(
        lambda mod, inp, out: offsets.append(out.detach()))
        for m in model.modules() if isinstance(m, DCNv3)]
    out = model(run["batch"], train=True,
                generator=torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    # the clamp holds samples in each layer (16^2 -> 8^2 -> 4^2 -> 2^2
    # maps): 3.1, 1.3 and 1.7 per mille at these weights
    assert len(offsets) == 3
    shares = [clamped_share(o.numpy(), RES >> i, RES >> i, 2, 4, WINDOW)
              for i, o in enumerate(offsets)]
    assert min(shares) > 0, shares
    losses = PoseLossFn(cfg.loss)(out, run["batch"])
    assert set(losses) == set(run["losses"])
    for k, v in run["losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, atol=2e-5,
                                   err_msg=k)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(sum(losses.values()),
                                                params)))
    assert set(grads) == set(run["grads"])
    top = max(g.abs().max().item() for g in run["grads"].values())
    for k, ref in run["grads"].items():
        scale = ref.abs().max().item()
        if scale < 1e-6 * top:
            # zero but for rounding: the bias ahead of SizeHead's
            # batch-statistics BatchNorm
            assert grads[k].abs().max().item() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(grads[k].numpy(), ref.numpy(),
                                   atol=1e-4 * scale, err_msg=k)


def test_windowed_step_matches_jax(run, jax_mask):
    state, step, _ = port_state(run["variables"])
    metrics = step(state, run["batch"], torch.Generator().manual_seed(0))
    ref = run["metrics"]
    for k in run["losses"]:
        np.testing.assert_allclose(metrics[k].item(), ref[k], atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               ref["grad_norm"], rtol=1e-4)
    assert metrics["notfinite_total"] == ref["notfinite_total"] == 0
    assert_params_close(state.model, run["state"])
