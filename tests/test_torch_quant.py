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


# csrc/int8_mlp.cu's shortcut for the row amax of GELU(x) over the values
# of one thread's fragment: GELU(m1) when the largest value m1 is at least
# KERNEL_ACT_FLOOR and the second largest at most m1 * KERNEL_NEAR
KERNEL_ACT_FLOOR = 0.5
KERNEL_NEAR = 1.0 - 1.0 / 4096


def fragment_amax(pre, h, act):
    """Per row, max |h| over a chunk as the kernel takes it: each thread
    holds 16 values of a row (columns 64 w + 8 b + 2 q + e of the chunk
    for its warpgroup w and lane quad q, b < 8, e < 2); for GELU a thread
    whose largest pre-activation m1 >= 1/2 has a second largest at most
    m1 (1 - 2^-12) takes GELU at m1 alone, any other takes all 16.  pre and
    h = act(pre) are (rows, width), width a multiple of 64."""
    rows, width = pre.shape

    def frag(t):
        return (t.reshape(rows, width // 64, 8, 4, 2).permute(0, 1, 3, 2, 4)
                .reshape(rows, -1, 16))

    p, a = frag(pre), frag(h)
    if act == "none":
        return p.abs().amax(-1).amax(-1, keepdim=True)
    top = p.topk(2, dim=-1)
    m1, m2 = top.values[..., 0], top.values[..., 1]
    near = torch.tensor(KERNEL_NEAR, dtype=torch.float32)
    fast = (m1 >= KERNEL_ACT_FLOOR) & (m2 <= m1 * near)
    at_m1 = a.gather(-1, top.indices[..., :1])[..., 0]
    per_thread = torch.where(fast, at_m1, a.abs().amax(-1))
    return per_thread.amax(-1, keepdim=True)


def two_pass_mlp(y, residual, w0q, s0, b0, w1q, s1, b1, act, ln,
                 tile_rows, chunk_cols, nb):
    """The int8 MLP as the Hopper kernel decomposes it, in torch: per tile
    of ``tile_rows`` rows and block of ``nb`` output columns, pass 1 takes
    each ``chunk_cols``-wide chunk of h (a multiple of 64) and keeps only
    the rows' amax (``fragment_amax``); pass 2 computes every chunk again,
    quantizes it with hs, and adds its int32 partial product into the
    block's accumulator."""
    from givepose_torch.ops.quant_matmul import _quantize_rows, apply_act

    m, c = y.shape
    hd = w0q.shape[1]
    out = torch.empty(m, c)
    for r0 in range(0, m, tile_rows):
        rows = slice(r0, min(r0 + tile_rows, m))
        yf = y[rows].float()
        if ln is not None:
            mu, rsig, ln_g, ln_b = ln
            yf = (yf - mu[rows]) * rsig[rows] * ln_g + ln_b
        yq, xs = _quantize_rows(yf)

        def chunk(j):
            """One chunk of h from column j, and its pre-activation, from
            the chunk's exact int32 sums."""
            cols = slice(j, min(j + chunk_cols, hd))
            acc = yq.to(torch.int32) @ w0q[:, cols].to(torch.int32)
            pre = acc.float() * xs * s0[cols] + b0[cols]
            return cols, pre, apply_act(pre, act)

        for n0 in range(0, c, nb):
            ncols = slice(n0, n0 + nb)
            amax = torch.zeros(yq.shape[0], 1)
            first = {}
            for j in range(0, hd, chunk_cols):        # pass 1
                _, pre, first[j] = chunk(j)
                am = fragment_amax(pre, first[j], act)
                # the shortcut finds the exact max
                assert torch.equal(am, first[j].abs().amax(-1, keepdim=True))
                amax = torch.maximum(amax, am)
            hs = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)
            acc2 = torch.zeros(yq.shape[0], nb, dtype=torch.int32)
            for j in range(0, hd, chunk_cols):        # pass 2
                cols, _, h = chunk(j)
                assert torch.equal(h, first[j])         # recomputed bitwise
                hq = torch.round(h / hs).to(torch.int32)
                acc2 += hq @ w1q[cols, ncols].to(torch.int32)
            out[rows, ncols] = (residual[rows, ncols].float()
                                + acc2.float() * hs * s1[ncols]
                                + b1[ncols])
    return out


def two_pass_case(m, c, hd, act, with_ln, tilings):
    """``two_pass_mlp`` at each (row tile, chunk, NB) of ``tilings``
    against ``mlp_int8_plain`` on seeded inputs of shape (m, c, hd):
    bitwise equal."""
    from givepose_torch.ops.quant_matmul import mlp_int8_plain

    inp = mlp_inputs(11 + m, m=m, c=c, hd=hd)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "ln"}
    ln = tuple(map(torch.from_numpy, inp["ln"])) if with_ln else None
    w0q, s0 = quantize_weights(t["w0"])
    w1q, s1 = quantize_weights(t["w1"], t["gamma"])
    b1 = t["b1"] * t["gamma"]
    args = (t["y"], t["residual"], w0q, s0, t["b0"], w1q, s1, b1)
    # one thread: PyTorch's CPU tanh takes its vectorized path except on a
    # loop's tail, where it takes the scalar one, and a split of the loop
    # over threads moves the tails; every tensor here is a multiple of the
    # vector width, so in one thread both sides take the vectorized path
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = mlp_int8_plain(*args, act=act, out_dtype=torch.float32, ln=ln)
        for tiling in tilings:
            out = two_pass_mlp(*args, act, ln, *tiling)
            assert torch.equal(out, ref), tiling
    finally:
        torch.set_num_threads(threads)
    assert (ref - t["residual"]).abs().mean() > 1e-2


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("m,c,hd", [(150, 128, 512), (40, 64, 192),
                                    (70, 768, 256)])
def test_two_pass_tiling_is_exact(act, with_ln, m, c, hd):
    """The kernel's decomposition (64-row tiles, a ragged last one or M
    below one tile; H in 128-column chunks, the last one half (H 192);
    pass 1 for hs, pass 2 recomputing h and summing int32 partial
    products) equals ``mlp_int8_plain`` bitwise, at every split of the
    output columns into blocks of 64, 256, 512 or all C that divides C
    (``block_cols`` in csrc/int8_mlp.cu picks one of them)."""
    splits = sorted({nb for nb in (64, 256, 512, c) if c % nb == 0})
    two_pass_case(m, c, hd, act, with_ln, [(64, 128, nb) for nb in splits])


@pytest.mark.parametrize("tile_rows,chunk_cols,nb", [
    (16, 64, 64), (32, 192, 128), (128, 64, 256), (48, 320, 384)])
def test_two_pass_any_tiling_is_exact(tile_rows, chunk_cols, nb):
    """The decomposition's exactness does not rest on the kernel's own
    tile sizes: other row tiles (ragged against M 150), hidden chunks
    (ragged against H 576) and column blocks give ``mlp_int8_plain``
    bitwise too."""
    two_pass_case(150, 768, 576, "gelu_tanh", True,
                  [(tile_rows, chunk_cols, nb)])


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact"])
def test_amax_shortcut_is_exact(act):
    """The kernel's amax shortcut against the full max over values that
    take both of its paths: N(0, 1) rows, rows whose maximum is below 1/2,
    negative rows, large values, and near-ties of the largest value (a
    second value one step below the first, in every column)."""
    from givepose_torch.ops.quant_matmul import apply_act

    rng = np.random.default_rng(21)
    rows = [rng.normal(size=(256, 128)), rng.normal(0, 0.15, (256, 128)),
            -np.abs(rng.normal(size=(64, 128))),
            rng.normal(0, 300, (64, 128))]
    tie = rng.normal(size=(128, 128))
    top = tie.max(-1, keepdims=True)
    for col in range(0, 128, 16):
        tie[np.arange(128) % 16 == col // 16, col] = (
            top[np.arange(128) % 16 == col // 16, 0] * (1 - 2.0 ** -14))
    rows.append(tie)
    pre = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    h = apply_act(pre, act)
    want = h.abs().amax(-1, keepdim=True)
    assert torch.equal(fragment_amax(pre, h, act), want)
    # both paths taken
    p = pre.reshape(-1, 2, 8, 4, 2).permute(0, 1, 3, 2, 4).reshape(
        pre.shape[0], -1, 16)
    m = p.topk(2, dim=-1).values
    fast = (m[..., 0] >= KERNEL_ACT_FLOOR) & (
        m[..., 1] <= m[..., 0] * torch.tensor(KERNEL_NEAR))
    assert fast.any() and (~fast).any()

