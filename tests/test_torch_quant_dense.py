"""The port's W8A8 dense path against the JAX package's, on the CPU.

- ``quant_matmul_plain`` (the plain version of the ``int8_qmm`` kernel)
  against ``quant_matmul_pallas(..., interpret=True)``, which runs the TPU
  kernel ``_qmm_kernel``: f32 out, atol 2e-5 (the bar of
  ``tests/test_quant.py``); the two compute the same int8 values and
  differ only in the last bits of tanh and erf.
- ``quant_matmul_pre_plain`` (plain ``int8_qmm_pre``) against
  ``quant_matmul_pre_pallas(..., interpret=True)`` (``_qmm_pre_kernel``):
  bf16 out, within one bf16 ulp of the larger of the two values.
- ``quantize_activations`` and ``quant_matmul_w8a8``: bitwise.
- ``quant_dense`` and ``QuantDense`` against JAX's CPU ``quant_dense``,
  which divides by 127 where the kernels multiply by 1/127: a last-bit
  difference of a row scale can flip an int8 value by one step.  Bar:
  max |out - ref| within 3 such flips (``qmm_flip``, times GELU's largest
  slope 1.13) plus 1e-6 * max|ref|; mean within 1e-3 * mean|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.models.quant import QuantDense as JaxQuantDense
from givepose_tpu.models.quant import quant_matmul_w8a8 as jax_w8a8
from givepose_tpu.ops.quant_matmul_pallas import \
    quant_dense as jax_quant_dense
from givepose_tpu.ops.quant_matmul_pallas import (quant_matmul_pallas,
                                                  quant_matmul_pre_pallas)
from givepose_tpu.ops.quant_matmul_pallas import \
    quantize_activations as jax_quantize_activations
from givepose_tpu.ops.quant_matmul_pallas import \
    quantize_weights as jax_quantize_weights

from givepose_torch.models.convert_from_flax import flax_to_state_dict
from givepose_torch.models.layers import Linear
from givepose_torch.models.quant import (QuantDense, make_dense,
                                         quant_matmul_w8a8)
from givepose_torch.ops.quant_matmul import (QMM_MAX_STAGES, QMM_SMEM,
                                             qmm_cuda, qmm_flip, qmm_pad,
                                             qmm_plan, qmm_pre_cuda,
                                             qmm_smem, quant_dense,
                                             quant_matmul_plain,
                                             quant_matmul_pre,
                                             quant_matmul_pre_plain,
                                             quantize_activations,
                                             quantize_weights)

torch.set_num_threads(2)

ACTS = ["none", "gelu_tanh", "gelu_exact"]
# (M, K, N): the TPU tests' 48 x 192 -> 160 and QuantDense's 96 -> 48,
# and odd sizes that pad every dimension of the TPU kernel's tiles
SHAPES = [(48, 192, 160), (37, 96, 48), (5, 40, 7)]
GELU_SLOPE = 1.13


def operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(0, 0.1, n).astype(np.float32)
    return x, w, b


def t(a):
    return torch.from_numpy(np.array(a))


def flip_bar(x, w, ref, gamma=None):
    wq, ws = quantize_weights(t(w), None if gamma is None else t(gamma))
    flip = qmm_flip(t(x).reshape(-1, w.shape[0]), wq, ws)
    return 3 * GELU_SLOPE * flip + 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_qmm_kernel(act, m, k, n):
    x, w, b = operands(m + k, m, k, n)
    wq, ws = jax_quantize_weights(jnp.asarray(w))
    ref = np.asarray(quant_matmul_pallas(
        jnp.asarray(x), wq, ws, bias=jnp.asarray(b), act=act,
        out_dtype=jnp.float32, interpret=True))
    out = quant_matmul_plain(t(x), t(wq), t(ws), t(b), act, torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)
    # bf16 x and out, and no bias: the same rows
    xb = t(x).to(torch.bfloat16)
    ref16 = np.asarray(quant_matmul_pallas(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), wq, ws,
        act=act, out_dtype=jnp.bfloat16, interpret=True), np.float32)
    out16 = quant_matmul_plain(xb, t(wq), t(ws), None, act).float().numpy()
    np.testing.assert_allclose(
        out16, ref16, rtol=0,
        atol=2 ** -7 * np.abs(ref16).max() + 2e-5)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_pre_plain_matches_qmm_pre_kernel(act, m, k, n):
    """bf16 epilogue and JAX's mixed bf16/f32 activation: within one bf16
    ulp of the larger value, and most outputs bitwise."""
    x, w, b = operands(2 * m + k, m, k, n)
    xq, xs = jax_quantize_activations(jnp.asarray(x))
    wq, ws = jax_quantize_weights(jnp.asarray(w))
    ref = np.asarray(quant_matmul_pre_pallas(
        xq, xs, wq, ws, bias=jnp.asarray(b), act=act,
        out_dtype=jnp.bfloat16, interpret=True), np.float32)
    out = quant_matmul_pre_plain(t(xq), t(xs), t(wq), t(ws), t(b), act)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    out = out.float().numpy()
    d = np.abs(out - ref)
    assert (d <= 2 ** -7 * np.maximum(np.abs(out), np.abs(ref))).all(), \
        d.max()
    assert (d == 0).mean() >= 0.9, (d == 0).mean()
    # f32 out: the f32 value of the bf16 epilogue's activation
    out32 = quant_matmul_pre_plain(t(xq), t(xs), t(wq), t(ws), t(b), act,
                                   torch.float32)
    ref32 = np.asarray(quant_matmul_pre_pallas(
        xq, xs, wq, ws, bias=jnp.asarray(b), act=act,
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(out32.numpy(), ref32, rtol=0,
                               atol=2 ** -7 * np.abs(ref32).max())


def test_quantize_activations_bitwise():
    x, _, _ = operands(1, 3 * 5, 72, 1)
    x = x.reshape(3, 5, 72)
    x[0, 0] = 0.0                         # a zero row takes the 1e-8 floor
    q, s = quantize_activations(t(x))
    jq, js = jax_quantize_activations(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (3, 5, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_matmul_w8a8_bitwise(out_dtype):
    x, w, _ = operands(2, 2 * 7, 64, 24)
    x = x.reshape(2, 7, 64)
    got = quant_matmul_w8a8(t(x), t(w), getattr(torch, out_dtype))
    want = jax_w8a8(jnp.asarray(x), jnp.asarray(w),
                    getattr(jnp, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("act", ACTS)
def test_quant_dense_matches_jax(act):
    """N-D x, bias and a layer scale, against JAX's CPU formulation."""
    x, w, b = operands(3, 2 * 9, 96, 40)
    x = x.reshape(2, 9, 96)
    gamma = np.random.default_rng(4).uniform(0.2, 1.0, 40).astype(
        np.float32)
    ref = np.asarray(jax_quant_dense(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), act=act,
        gamma=jnp.asarray(gamma), out_dtype=jnp.float32))
    out = quant_dense(t(x), t(w), t(b), act=act, gamma=t(gamma),
                      out_dtype=torch.float32)
    assert out.shape == (2, 9, 40)
    d = np.abs(out.numpy() - ref)
    assert d.max() <= flip_bar(x, w, ref, gamma), d.max()
    assert d.mean() <= 1e-3 * np.abs(ref).mean(), d.mean()


@pytest.mark.parametrize("act", ["none", "gelu_tanh"])
def test_quant_dense_layer_matches_flax(act):
    """Flax QuantDense params through the weight bridge (strict load)."""
    x, _, _ = operands(5, 8, 96, 1)
    jm = JaxQuantDense(48, dtype=jnp.float32, act=act)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05), v)          # a non-zero bias
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    layer = QuantDense(96, 48, act=act, dtype=torch.float32)
    layer.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        out = layer(t(x)).numpy()
    d = np.abs(out - ref)
    w = np.asarray(v["params"]["kernel"])
    assert d.max() <= flip_bar(x, w, ref), d.max()
    assert d.mean() <= 1e-3 * np.abs(ref).mean(), d.mean()


def test_state_dict_interchange_with_linear():
    """A Linear's state dict serves a QuantDense and back (strict), as
    flax Dense and QuantDense share their param tree."""
    x = t(operands(6, 8, 96, 1)[0])
    dense = Linear(96, 48)
    torch.nn.init.normal_(dense.weight, 0, 96 ** -0.5,
                          generator=torch.Generator().manual_seed(0))
    qdense = QuantDense(96, 48, dtype=torch.float32)
    qdense.load_state_dict(dense.state_dict(), strict=True)
    with torch.no_grad():
        ref, got = dense(x), qdense(x)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert 1e-6 < rel < 0.02, rel
    back = Linear(96, 48)
    back.load_state_dict(QuantDense(96, 48).state_dict(), strict=True)
    assert list(back.state_dict()) == list(dense.state_dict())


def test_make_dense_dispatch():
    q = make_dense(True, 16, 8, torch.float32, act="gelu_tanh")
    assert isinstance(q, QuantDense) and q.act == "gelu_tanh"
    d = make_dense(False, 16, 8, torch.float32, use_bias=False)
    assert type(d) is Linear and d.bias is None
    assert make_dense(True, 16, 8, torch.bfloat16,
                      use_bias=False).bias is None


def test_dispatch_on_cpu():
    """A CPU tensor takes the plain version through the operator, equal
    to it bitwise; ``impl='cuda'`` raises and no kernel launches."""
    x, w, b = operands(7, 16, 64, 32)
    args = (t(x), t(w), t(b))
    qmm_cuda.launches = qmm_pre_cuda.launches = 0
    auto = quant_dense(*args, act="gelu_tanh")
    plain = quant_dense(*args, act="gelu_tanh", impl="torch")
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    xq, xs = quantize_activations(t(x))
    wq, ws = quantize_weights(t(w))
    auto = quant_matmul_pre(xq, xs, wq, ws, t(b), act="gelu_exact")
    plain = quant_matmul_pre(xq, xs, wq, ws, t(b), act="gelu_exact",
                             impl="torch")
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        quant_dense(*args, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        quant_matmul_pre(xq, xs, wq, ws, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        qmm_cuda(t(x), wq.t().contiguous(), ws)
    with pytest.raises(ValueError):
        quant_dense(*args, impl="bogus")
    with pytest.raises(ValueError):
        quant_dense(*args, act="relu")
    assert qmm_cuda.launches == qmm_pre_cuda.launches == 0


# K through the kernels' pad rule: K 100 (a multiple of 4 only), 37 (odd),
# 520 (of 8 only)
PAD_SHAPES = [(33, 100, 25), (5, 37, 19), (20, 520, 13)]


def padded(t):
    """An (R, K) tensor through ``qmm_pad``; the padded columns zero."""
    p = qmm_pad(t)
    assert p.shape[1] % 16 == 0 and p.shape[1] - t.shape[1] < 16
    assert torch.equal(p[:, :t.shape[1]], t)
    assert not p[:, t.shape[1]:].any()
    return p


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", PAD_SHAPES)
def test_pad_rule_is_bitwise(act, m, k, n):
    """Each plain version on operands padded with zeros along K, as the
    wrappers hand them to the kernels, equals its result on the unpadded
    ones bitwise (zeros add nothing to the int32 sum and leave each row's
    amax), and the TPU kernel in interpret mode as
    ``test_plain_matches_qmm_kernel`` and
    ``test_pre_plain_matches_qmm_pre_kernel`` hold the unpadded one."""
    x, w, b = operands(5 * m + k, m, k, n)
    wq, ws = quantize_weights(t(w))
    wq_p = padded(wq.t().contiguous()).t()
    out = quant_matmul_plain(t(x), wq, ws, t(b), act, torch.float32)
    out_p = quant_matmul_plain(padded(t(x)), wq_p, ws, t(b), act,
                               torch.float32)
    assert torch.equal(out_p, out)
    jq, jws = jax_quantize_weights(jnp.asarray(w))
    ref = np.asarray(quant_matmul_pallas(
        jnp.asarray(x), jq, jws, bias=jnp.asarray(b), act=act,
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(out_p.numpy(), ref, rtol=0, atol=2e-5)
    xq, xs = quantize_activations(t(x))
    pre = quant_matmul_pre_plain(xq, xs, wq, ws, t(b), act)
    pre_p = quant_matmul_pre_plain(padded(xq), xs, wq_p, ws, t(b), act)
    assert torch.equal(pre_p, pre)
    jxq, jxs = jax_quantize_activations(jnp.asarray(x))
    ref16 = np.asarray(quant_matmul_pre_pallas(
        jxq, jxs, jq, jws, bias=jnp.asarray(b), act=act,
        out_dtype=jnp.bfloat16, interpret=True), np.float32)
    d = np.abs(pre_p.float().numpy() - ref16)
    assert (d <= 2 ** -7 * np.maximum(np.abs(ref16),
                                      np.abs(pre_p.float().numpy()))).all()


def test_pad_keeps_aligned_operands():
    """An operand with K a multiple of 16 at an aligned base is handed on
    as it is; a view at an odd offset is copied."""
    a = torch.zeros(8, 64, dtype=torch.int8)
    assert qmm_pad(a) is a
    buf = torch.zeros(8 * 64 + 1, dtype=torch.int8)
    view = buf[1:].view(8, 64)
    assert view.data_ptr() % 16 and qmm_pad(view).data_ptr() % 16 == 0
    assert torch.equal(qmm_pad(view), view)


# (M, N, K, SMs): the four batch-32 ConvNeXt-B MLP matmuls, the tiling's
# edges (ragged M and N, M below one tile, K 4096, more units than blocks),
# and a card of fewer SMs
PLAN_CASES = [(8192, 2048, 512, 132), (8192, 512, 2048, 132),
              (2048, 4096, 1024, 132), (2048, 1024, 4096, 132),
              (8192 - 37, 2048, 512, 132), (40, 2048, 512, 132),
              (77, 48, 96, 132), (5, 19, 48, 132), (200, 130, 528, 132),
              (9000, 512, 256, 132), (256, 1024, 4096, 132),
              (1000, 3000, 2048, 114), (3, 5000, 16, 7)]


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("m,n,k,sms", PLAN_CASES)
def test_plan_fits_and_covers_every_tile_once(pre, m, n, k, sms):
    """The persistent blocks of ``qmm_plan`` compute every output tile
    exactly once, in shared memory a block may take, with a ring of at
    least 2 stages and B4's slots either every K slice or a ring of at
    least 3 (a slot is written again only after both warpgroups' products
    that read it are done)."""
    plan = qmm_plan(m, n, k, pre, sms)
    seen = [tile for block in range(plan.blocks)
            for tile in plan.tiles(m, n, block)]
    every = [(r, c) for r in range(-(-m // plan.bm))
             for c in range(-(-n // plan.bn))]
    assert sorted(seen) == every
    assert 1 <= plan.blocks <= min(sms, plan.units(m))
    assert qmm_smem(plan, pre) <= QMM_SMEM
    assert 2 <= plan.stages <= QMM_MAX_STAGES
    nk = -(-k // 128)
    if pre:
        assert plan.a_slots == 0 and plan.group == 1 and plan.bm == 128
    else:
        assert plan.a_slots >= min(nk, 3) and plan.bm == 64
