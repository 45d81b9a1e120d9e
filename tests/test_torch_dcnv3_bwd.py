"""The port's plain DCNv3 backward against the JAX package's.

``dcnv3_core_bwd`` (autograd of the plain version, the reference the
backward CUDA kernel is held to on the card) against the interpret-mode
Pallas backward kernel ``dcnv3_pallas_bwd`` carried through its prep's
vjp, as ``tests/test_dcnv3.py`` runs it (atol 2e-5), and against
``jax.grad`` of JAX ``dcnv3_core`` (atol 1e-5): f32, one summation order
against another.  Zero offsets put every sample on a texel centre, where
``floor`` picks the neighbour that the one-sided difference uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.ops.dcnv3 import dcnv3_core as jax_dcnv3_core
from givepose_tpu.ops.dcnv3_pallas import _prepare_inputs, auto_tiles
from givepose_tpu.ops.dcnv3_pallas_bwd import dcnv3_pallas_bwd

from givepose_torch.ops.dcnv3 import dcnv3_core_bwd

torch.set_num_threads(2)

GROUP = 2


def make_inputs(seed, h, gc, stride, dilation, offset_mult, n=2, pad=1):
    """x, offset (N(0,1) * offset_mult px), softmaxed mask and an upstream
    gradient, as numpy f32."""
    rng = np.random.default_rng(seed)
    ho = (h + 2 * pad - (2 * dilation + 1)) // stride + 1
    x = rng.normal(size=(n, h, h, GROUP * gc)).astype(np.float32)
    off = (rng.normal(size=(n, ho, ho, GROUP * 18))
           * offset_mult).astype(np.float32)
    logits = rng.normal(size=(n, ho, ho, GROUP, 9))
    m = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    m = m.reshape(n, ho, ho, GROUP * 9).astype(np.float32)
    gup = rng.normal(size=(n, ho, ho, GROUP * gc)).astype(np.float32)
    return x, off, m, gup


def torch_grads(x, off, m, gup, **kw):
    return [t.numpy() for t in dcnv3_core_bwd(
        *(torch.from_numpy(a) for a in (x, off, m, gup)), **kw)]


# (stride, dilation, gc, offset multiplier); 0.0 = zero offsets, 2.0 puts
# corners out of bounds
CASES = [
    (1, 1, 4, 2.0), (2, 1, 16, 2.0), (1, 2, 16, 2.0), (2, 2, 4, 2.0),
    (2, 1, 4, 0.0), (1, 2, 16, 0.0),
]


@pytest.mark.parametrize("stride,dilation,gc,mult", CASES)
def test_bwd_matches_jax_autodiff(stride, dilation, gc, mult):
    x, off, m, gup = make_inputs(stride * 7 + dilation * 3 + gc, 7, gc,
                                 stride, dilation, mult)
    kw = dict(kernel=3, stride=stride, pad=1, dilation=dilation,
              group=GROUP, offset_scale=1.0)

    def loss(a, b, c):
        return jnp.sum(jax_dcnv3_core(a, b, c, **kw) * gup)

    refs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(m))
    for name, got, ref in zip(("d_x", "d_offset", "d_mask"),
                              torch_grads(x, off, m, gup, **kw), refs):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("stride,dilation,gc,mult", [
    (2, 1, 16, 2.0), (1, 2, 4, 0.0),
])
def test_bwd_matches_pallas_interpret(stride, dilation, gc, mult):
    """The TPU backward kernel (interpret mode) through its prep's vjp."""
    x, off, m, gup = make_inputs(50 + stride + dilation + gc, 8, gc,
                                 stride, dilation, mult)
    n, pad = x.shape[0], 1
    tap_chunk, ptm = auto_tiles(x.shape, off.shape, 3, pad, GROUP,
                                jnp.float32, 6 << 20)

    def prep(a, b, c):
        img_t, aux, _ = _prepare_inputs(a, b, c, 3, stride, pad, dilation,
                                        GROUP, 1.0, pix_tile_max=ptm)
        return img_t, aux

    args = (jnp.asarray(x), jnp.asarray(off), jnp.asarray(m))
    (img_t, aux), vjp_prep = jax.vjp(prep, *args)
    _, _, dims = _prepare_inputs(*args, 3, stride, pad, dilation, GROUP,
                                 1.0, pix_tile_max=ptm)
    gc_, q_pix = dims["gc"], dims["q_pix"]
    q_pad = dims["n_tiles"] * dims["pix_tile"]
    gk = jnp.asarray(gup).reshape(n, q_pix, GROUP, gc_).transpose(0, 2, 3, 1)
    gk = jnp.pad(gk, ((0, 0), (0, 0), (0, 0), (0, q_pad - q_pix)))
    d_img_t, d_aux = dcnv3_pallas_bwd(img_t, aux, gk, dims,
                                      tap_chunk=tap_chunk, interpret=True)
    refs = vjp_prep((d_img_t, d_aux))
    got = torch_grads(x, off, m, gup, kernel=3, stride=stride, pad=pad,
                      dilation=dilation, group=GROUP)
    for name, g, ref in zip(("d_x", "d_offset", "d_mask"), got, refs):
        np.testing.assert_allclose(g, np.asarray(ref), atol=2e-5,
                                   err_msg=name)


def test_zero_offsets_take_the_forward_difference():
    """With zero offsets every sample sits on a texel centre (fx = 0), so
    d_offset_x is m · (x[x0+1] − x[x0]) · grad_out, the one-sided
    difference that floor() picks."""
    x, off, m, gup = make_inputs(5, 6, 4, 1, 1, 0.0, n=1)
    _, d_off, _ = torch_grads(x, off, m, gup, stride=1, group=GROUP)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    # output (2, 3), group 0, tap (i=2, j=1): sample at padded (x=5, y=3)
    oh, ow, i, j = 2, 3, 2, 1
    px, py = ow + i, oh + j
    diff = (xp[0, py, px + 1, :4] - xp[0, py, px, :4])
    want = m[0, oh, ow, i * 3 + j] * np.dot(diff, gup[0, oh, ow, :4])
    np.testing.assert_allclose(d_off[0, oh, ow, 2 * (i * 3 + j)], want,
                               rtol=1e-5, atol=1e-6)
