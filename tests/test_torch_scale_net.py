"""The port's MobileNetV3-Small and ScaleNet against the JAX modules.

Same weights (seeded numpy values for the flax tree, carried over by
``models.convert_from_flax``), same inputs (64² crops), f32 on the CPU.
Eval mode with random running statistics; train mode (batch statistics,
the running statistics' update, dropout masks fed to flax through
``flax.linen.intercept_methods``) against flax's ``mutable=
['batch_stats']``.  Bar: 1e-5 relative to the output's largest value.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.models import MobileNetV3Small as JaxMobileNet
from givepose_tpu.models import ScaleNet as JaxScaleNet

from givepose_torch.models import scale_net as scale_net_mod
from givepose_torch.models.convert_from_flax import (
    _convert_leaf,
    flax_to_state_dict,
)
from givepose_torch.models.mobilenet import FlaxBatchNorm2d, MobileNetV3Small
from givepose_torch.models.scale_net import ScaleNet, build_scalenet

torch.set_num_threads(2)

BATCH = 3
IMG = 64
BAR = 1e-5


def random_variables(model, batch, seed, stats_random=True):
    """Seeded numpy weights for the flax tree of ``model``: kernels ~
    N(0, 2/fan_in), BatchNorm scales near 1, small biases, and running
    statistics random (or flax's init: mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)

    def leaf(path, s):
        name, shape = getattr(path[-1], "key", str(path[-1])), s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0, np.sqrt(2 / fan_in), shape)
        elif name == "scale":
            v = 1 + rng.normal(0, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape) if stats_random \
                else np.ones(shape)
        elif name == "mean":
            v = rng.normal(0, 0.2, shape) if stats_random \
                else np.zeros(shape)
        else:
            v = rng.normal(0, 0.02, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(seed, b=BATCH, full_b=None):
    rng = np.random.default_rng(seed)
    full_b = b if full_b is None else full_b
    return {
        "roi_img": rng.normal(size=(b, IMG, IMG, 3)).astype(np.float32),
        "full_img": rng.normal(size=(full_b, IMG, IMG, 3)).astype(
            np.float32),
        "one_hot": np.eye(6, dtype=np.float32)[rng.integers(0, 6, b)],
        "roi_wh": rng.uniform(30, 200, (b, 2)).astype(np.float32),
        "mean_size": rng.uniform(0.05, 0.3, (b, 3)).astype(np.float32),
    }


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def feed_masks(masks):
    """An interceptor that applies ``masks`` (in call order) in flax's
    Dropout instead of its random draws: ``select(mask, x / keep, 0)``."""
    queue = list(masks)

    def interceptor(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if not (isinstance(mod, nn.Dropout)
                and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = 1.0 - mod.rate
        mask = queue.pop(0)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return interceptor


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def scalenet_case():
    batch = make_batch(0)
    model = JaxScaleNet()
    variables = random_variables(model, to_jax(batch), seed=1)
    port = build_scalenet(device="cpu",
                          state_dict=flax_to_state_dict(variables))
    return model, variables, port


def test_mobilenet_eval_matches_jax():
    batch = make_batch(2)
    x = batch["roi_img"]
    model = JaxMobileNet()
    variables = random_variables(model, jnp.asarray(x), seed=3)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = MobileNetV3Small()
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, 576)
    assert rel_err(got, ref) < BAR


def test_scalenet_eval_matches_jax(scalenet_case):
    model, variables, port = scalenet_case
    batch = make_batch(4)
    ref = np.asarray(jax.jit(model.apply)(variables, to_jax(batch)))
    with torch.no_grad():
        got = port(to_torch(batch)).numpy()
    assert got.shape == (BATCH,)
    assert rel_err(got, ref) < BAR


def test_full_image_of_batch_one_is_broadcast(scalenet_case):
    """The eval loader's layout: one shared full image for a batch of
    instances runs its tower once; the result equals the full image tiled
    per instance, and the JAX module's."""
    model, variables, port = scalenet_case
    batch = make_batch(5, full_b=1)
    tiled = dict(batch, full_img=np.repeat(batch["full_img"], BATCH, 0))
    calls = []
    hook = port.feat_encoder_full.register_forward_hook(
        lambda m, i, o: calls.append(tuple(i[0].shape)))
    try:
        with torch.no_grad():
            got = port(to_torch(batch)).numpy()
            again = port(to_torch(tiled)).numpy()
    finally:
        hook.remove()
    assert calls == [(1, IMG, IMG, 3), (BATCH, IMG, IMG, 3)]
    assert rel_err(got, again) < BAR      # conv batch 1 vs 3: sum order
    ref = np.asarray(jax.jit(model.apply)(variables, to_jax(batch)))
    assert rel_err(got, ref) < BAR


def test_scalenet_train_matches_flax_mutable(scalenet_case):
    """Train mode: batch statistics, flax's running-average update (biased
    variance, momentum 0.99), dropout masks fed to both sides."""
    model, variables, _ = scalenet_case
    port = build_scalenet(device="cpu",
                          state_dict=flax_to_state_dict(variables))
    batch = make_batch(6)
    rng = np.random.default_rng(7)
    masks = [rng.random((BATCH, 576)) < 0.8 for _ in range(2)]

    @jax.jit
    def apply(v, b, m):
        with nn.intercept_methods(feed_masks(m)):
            return model.apply(v, b, train=True, mutable=["batch_stats"])

    ref, mut = apply(variables, to_jax(batch), [jnp.asarray(m) for m in masks])
    fed = [torch.from_numpy(m) for m in masks]

    def keep_mask(shape, keep_prob, generator, device):
        mask = fed.pop(0)
        assert tuple(mask.shape) == tuple(shape) and keep_prob == 0.8
        return mask

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scale_net_mod, "dropout_keep_mask", keep_mask)
        got = port(to_torch(batch), train=True,
                   generator=torch.Generator()).detach().numpy()
    assert not fed
    assert rel_err(got, np.asarray(ref)) < BAR
    sd = port.state_dict()
    ref_stats = {k: v for k, v in flax_to_state_dict(
        {"batch_stats": mut["batch_stats"]}).items()
        if not k.endswith("num_batches_tracked")}
    assert len(ref_stats) == 2 * len([m for m in port.modules()
                                      if isinstance(m, FlaxBatchNorm2d)])
    for key, ref_v in ref_stats.items():
        assert rel_err(sd[key].numpy(), ref_v.numpy()) < BAR, key
        # the update moved them from the loaded values
        assert not np.array_equal(ref_v.numpy(), flax_to_state_dict(
            variables)[key].numpy()), key


def test_running_var_takes_the_biased_variance():
    """nn.BatchNorm2d's own train-mode update moves running_var by the
    unbiased variance; flax (and the port) by the biased one.  At the
    head's 2 x 2 output of a batch of 2 (n = 8) the two differ by 8/7."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 2, 2, 16)).astype(np.float32)
    bn = nn.BatchNorm(use_fast_variance=False, use_running_average=False,
                      momentum=0.99, epsilon=1e-3)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref_y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    ref_var = np.asarray(mut["batch_stats"]["var"])

    port = FlaxBatchNorm2d(16)
    y = port(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), ref_var,
                               rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)

    torch_bn = torch.nn.BatchNorm2d(16, eps=1e-3, momentum=0.01)
    torch_bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(torch_bn.running_var.numpy(), ref_var) > 1e-4


def f64_copy(model):
    """``model`` evaluated in float64 (every conv and dense layer's compute
    dtype, parameters and buffers)."""
    import copy

    out = copy.deepcopy(model).double()
    for m in out.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return out


def test_tower_on_fixture_images_is_f32_accurate(tmp_path):
    """The CLI's full images (the fixture's boxes on black, resized to 64²)
    are nearly constant, and train-mode BatchNorm at batch 2 divides by
    their small variances, so f32 rounding grows there.  The port's tower
    stays within 1e-4 of its own float64 evaluation, and nearer to it
    than JAX's f32 tower, which is why the scale CLI's comparison with the
    JAX CLI adds seeded texture to the images both CLIs train on."""
    from givepose_torch.cli import train as cli
    from givepose_torch.core.config import Config, parse_overrides
    from givepose_torch.data import NocsRecordReader, TrainPipeline
    from givepose_torch.data.synthetic import make_synthetic_nocs

    dirs = make_synthetic_nocs(str(tmp_path), n_images=2)
    cfg = parse_overrides(Config(), ["--img_size", str(IMG), "--out_res",
                                     "16", "--color_aug_prob", "1"])
    pipeline = TrainPipeline(NocsRecordReader("Real", "train", *dirs), 2, 2)
    raw = next(iter(pipeline.epoch()))
    gen, _ = cli.step_generators(0, 0, "cpu")
    x = cli.build_model_batch(raw, cli.draw_step(gen, 2, cfg),
                              cfg)["full_img"]
    model = JaxMobileNet()
    variables = random_variables(model, jnp.asarray(x.numpy()), seed=1,
                                 stats_random=False)
    port = MobileNetV3Small()
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    truth = f64_copy(port)(x.double(), train=True).detach().numpy()
    got = port(x, train=True).detach().numpy()
    ref, _ = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x.numpy()))
    port_err, jax_err = rel_err(got, truth), rel_err(np.asarray(ref), truth)
    assert port_err < 1e-4 and port_err < jax_err, (port_err, jax_err)


def test_hard_swish_rounds_as_jax():
    from givepose_tpu.models.mobilenet import hard_swish as jax_hs

    from givepose_torch.models.mobilenet import hard_swish

    x = np.random.default_rng(9).normal(0, 4, 4096).astype(np.float32)
    got = hard_swish(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hs(jnp.asarray(x))))


def test_bridge_loads_strictly_and_transposes_depthwise(scalenet_case):
    _, variables, _ = scalenet_case
    sd = flax_to_state_dict(variables)
    port = ScaleNet()
    missing = port.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    k = np.asarray(variables["params"]["feat_encoder_bbox"]["bneck3"][
        "Conv_1"]["kernel"])                       # depthwise (5,5,1,96)
    assert k.shape == (5, 5, 1, 96)
    w = sd["feat_encoder_bbox.bneck3.convs.1.weight"].numpy()
    assert w.shape == (96, 1, 5, 5)
    for c, i, j in ((0, 0, 0), (95, 4, 1), (17, 2, 3)):
        assert w[c, 0, i, j] == k[i, j, 0, c]
    np.testing.assert_array_equal(_convert_leaf("kernel", k), w)
    # the block without expansion: flax's Conv_0 is its depthwise conv
    assert sd["feat_encoder_full.bneck0.convs.0.weight"].shape == (16, 1, 3, 3)
