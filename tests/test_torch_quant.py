"""The port's int8 ConvNeXt MLP against the JAX package's, on the CPU.

The plain ``convnext_mlp_int8`` follows the TPU kernel's ``_mlp_core``
(activation scale ``max(amax, 1e-8) * (1/127)``) and is held against
JAX's ``convnext_mlp_int8(..., interpret=True)``, which runs that core.
Both sides compute the same int8 values from f32 arithmetic in the same
order; where a last bit differs (XLA's tanh or a fused multiply-add
against PyTorch's), a requantized value can move by one int8 step.  So
the bars admit a few such flips: max |out - ref| within 3 one-step flips
of the second product (3 * max_row(hs) * max|s1 * w1q|, plus 1e-5 *
max|ref| for the f32 rounding), and mean |out - ref| within 1e-3 *
mean|ref|, which a systematic fault (a wrong scale, a lost bias) exceeds.

The model-level tests compare with the JAX model, which on the CPU takes
its fallback formulation, with the activation scale ``max(amax, 1e-8) /
127``: an ulp away from the kernel's in some rows, which can flip a
rounding in any block and carries downstream.  Their bars are relative:
ConvNeXt output 1e-3 * max|ref| at most and 1e-4 * mean|ref| on average;
PoseNet maps, size and translation 2e-3 * max|ref|, rotation 1e-2.

Layer scales are O(1) in every comparison (the flax init's 1e-6 would
hide the MLP branch, and with it every int8 error), and each check also
asserts that the int8 output departs from the unquantized one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.core.config import ModelConfig as JaxModelConfig
from givepose_tpu.models import PoseNet as JaxPoseNet
from givepose_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from givepose_tpu.ops.quant_matmul_pallas import \
    convnext_mlp_int8 as jax_mlp_int8
from givepose_tpu.ops.quant_matmul_pallas import \
    quantize_weights as jax_quantize_weights

from givepose_torch.core.config import ModelConfig
from givepose_torch.eval.serving import build_posenet, example_serving_batch
from givepose_torch.models.convert_from_flax import flax_to_state_dict
from givepose_torch.models.convnext import ConvNeXt
from givepose_torch.ops.quant_matmul import (convnext_mlp_int8,
                                             mlp_int8_cuda, quantize_weights,
                                             requant_flip)

from test_torch_models import load
from test_torch_models import random_variables as module_variables
from test_torch_posenet import jax_batch, random_variables

torch.set_num_threads(2)


def mlp_inputs(seed, m=48, c=64, hd=256):
    rng = np.random.default_rng(seed)

    def f32(*a):
        return np.asarray(a[0], np.float32)

    return dict(
        y=f32(rng.normal(size=(m, c))),
        residual=f32(rng.normal(size=(m, c))),
        w0=f32(rng.normal(size=(c, hd)) / np.sqrt(c)),
        b0=f32(rng.normal(0, 0.1, hd)),
        w1=f32(rng.normal(size=(hd, c)) / np.sqrt(hd)),
        b1=f32(rng.normal(0, 0.1, c)),
        gamma=f32(1 + rng.normal(0, 0.1, c)),
        ln=(f32(rng.normal(0, 0.1, (m, 1))), f32(rng.uniform(0.5, 2, (m, 1))),
            f32(1 + rng.normal(0, 0.1, c)), f32(rng.normal(0, 0.1, c))))


def flip_bar(inp, ln, act, ref):
    """3 one-step flips of a requantized hidden value, plus f32 rounding."""
    t = torch.from_numpy
    w0q, s0 = quantize_weights(t(inp["w0"]))
    w1q, s1 = quantize_weights(t(inp["w1"]), t(inp["gamma"]))
    flip = requant_flip(t(inp["y"]), w0q, s0, t(inp["b0"]), w1q, s1, act,
                        None if ln is None else tuple(map(t, ln)))
    return 3 * flip + 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact", "none"])
@pytest.mark.parametrize("with_ln", [False, True])
def test_mlp_matches_jax_kernel(act, with_ln):
    inp = mlp_inputs(3 + with_ln)
    ln = inp["ln"] if with_ln else None
    j = {k: jnp.asarray(v) for k, v in inp.items() if k != "ln"}
    ref = np.asarray(jax_mlp_int8(
        j["y"], j["residual"], j["w0"], j["b0"], j["w1"], j["b1"],
        j["gamma"], act=act, out_dtype=jnp.float32, interpret=True,
        ln=None if ln is None else tuple(jnp.asarray(a) for a in ln)))
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "ln"}
    out = convnext_mlp_int8(
        t["y"], t["residual"], t["w0"], t["b0"], t["w1"], t["b1"],
        t["gamma"], act=act, out_dtype=torch.float32,
        ln=None if ln is None else tuple(torch.from_numpy(a) for a in ln))
    d = np.abs(out.numpy() - ref)
    assert d.max() <= flip_bar(inp, ln, act, ref), d.max()
    assert d.mean() <= 1e-3 * np.abs(ref).mean(), d.mean()
    # not vacuous: the MLP branch moves the output well past the residual
    assert np.abs(ref - inp["residual"]).mean() > 1e-2


def test_quantize_weights_match_jax():
    inp = mlp_inputs(5)
    wq, ws = quantize_weights(torch.from_numpy(inp["w0"]),
                              torch.from_numpy(inp["b0"]))
    jq, js = jax_quantize_weights(jnp.asarray(inp["w0"]),
                                  jnp.asarray(inp["b0"]))
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js))


def test_bf16_out_and_leading_dims():
    """(N, H, W, C) rows in bf16, as the ConvNeXt block hands them over:
    the output is bf16 of the f32 result."""
    inp = mlp_inputs(6, m=2 * 4 * 6)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "ln"}
    y4 = t["y"].reshape(2, 4, 6, -1).to(torch.bfloat16)
    r4 = t["residual"].reshape(2, 4, 6, -1).to(torch.bfloat16)
    args = (t["w0"], t["b0"], t["w1"], t["b1"], t["gamma"])
    out = convnext_mlp_int8(y4, r4, *args)
    want = convnext_mlp_int8(y4.float().reshape(48, -1),
                             r4.float().reshape(48, -1), *args,
                             out_dtype=torch.float32)
    assert out.dtype == torch.bfloat16 and out.shape == y4.shape
    torch.testing.assert_close(out.reshape(48, -1),
                               want.to(torch.bfloat16), rtol=0, atol=0)


def test_dispatch_on_cpu():
    inp = mlp_inputs(7)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "ln"}
    args = (t["y"], t["residual"], t["w0"], t["b0"], t["w1"], t["b1"],
            t["gamma"])
    mlp_int8_cuda.launches = 0
    a = convnext_mlp_int8(*args, out_dtype=torch.float32)
    b = convnext_mlp_int8(*args, out_dtype=torch.float32, impl="torch")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        convnext_mlp_int8(*args, out_dtype=torch.float32, impl="cuda")
    with pytest.raises(ValueError):
        convnext_mlp_int8(*args, impl="bogus")
    assert mlp_int8_cuda.launches == 0


def test_quant_convnext_matches_jax():
    """Every block quantized (quant_min_dim 32), layer scales ~0.5."""
    rng = np.random.default_rng(8)
    depths, dims = (1, 1), (32, 64)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxConvNeXt(depths=depths, dims=dims, quant=True, quant_min_dim=32)
    v = module_variables(jm, jnp.asarray(x), seed=8)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    plain = np.asarray(JaxConvNeXt(depths=depths, dims=dims).apply(
        v, jnp.asarray(x)))
    tm = load(ConvNeXt(depths, dims, quant=True, quant_min_dim=32), v,
              "ConvNeXt_0", "backbone")
    assert all(getattr(tm, f"stage{s}_block0").quant for s in (0, 1))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    d = np.abs(out - ref)
    assert d.max() <= 1e-3 * np.abs(ref).max(), d.max()
    assert d.mean() <= 1e-4 * np.abs(ref).mean(), d.mean()
    assert np.abs(ref - plain).max() > 1e-6 * np.abs(plain).max()


def test_quant_min_dim_keeps_narrow_stages():
    tm = ConvNeXt((1, 1, 1, 1), (16, 32, 512, 1024), quant=True)
    assert [getattr(tm, f"stage{s}_block0").quant for s in range(4)] == [
        False, False, True, True]


DEPTHS = (1, 1, 1, 1)
DIMS = (16, 32, 48, 512)        # a stage of width >= quant_min_dim
IMG = 128


def test_quant_posenet_matches_jax():
    """PoseNet with ``quant_dense=True`` and ``dcn_window=4``, f32, its
    512-wide last stage in int8, against the JAX PoseNet."""
    batch = example_serving_batch(2, img_size=IMG, seed=4, device="cpu")
    kw = dict(compute_dtype="float32", quant_dense=True, dcn_window=4)
    jmodel = JaxPoseNet(cfg=JaxModelConfig(**kw), backbone_variant="custom",
                        backbone_depths=DEPTHS, backbone_dims=DIMS)
    jb = jax_batch(batch)
    variables = random_variables(jmodel, jb, seed=17)
    ref = jmodel.apply(variables, jb)
    state = flax_to_state_dict(variables)

    def port(**over):
        return build_posenet(ModelConfig(**{**kw, **over}),
                             backbone_variant="custom", device="cpu",
                             state_dict=state, backbone_depths=DEPTHS,
                             backbone_dims=DIMS, img_size=IMG)

    model = port()
    assert model.backbone.stage3_block0.quant
    with torch.inference_mode():
        out = model(batch)
        unquant = port(quant_dense=False)(batch)
    for key in ("nocs_coor", "ivfc_coor", "size", "trans", "t_raw"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), r,
                                   atol=2e-3 * np.abs(r).max(), err_msg=key)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(ref["rot"]),
                               atol=1e-2)
    d = (out["nocs_coor"] - unquant["nocs_coor"]).abs().max().item()
    assert d > 1e-6, "the int8 path did not change the output"
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="serving"):
        model(batch, train=True, generator=g)


def test_train_step_refuses_quant():
    """A train step of an int8 model raises (its forward does)."""
    from givepose_torch.core.config import Config
    from givepose_torch.train import init_train_state, make_train_step

    cfg = Config(model=ModelConfig(compute_dtype="float32",
                                   quant_dense=True))
    state = init_train_state(cfg, "custom", device="cpu",
                             backbone_depths=DEPTHS, backbone_dims=DIMS,
                             img_size=IMG)
    step = make_train_step(state.model, cfg)
    batch = example_serving_batch(2, img_size=IMG, seed=0, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 0
