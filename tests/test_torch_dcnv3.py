"""The port's DCNv3 op against the JAX package's.

The plain PyTorch ``dcnv3_core`` is held against JAX ``dcnv3_core`` and
the Pallas kernel in interpret mode (f32, atol 1e-5: the same arithmetic
in another summation order), gradients included (atol 1e-5).  The CUDA
kernel's own tests need a GPU and no JAX: ``test_torch_dcnv3_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from givepose_tpu.ops.dcnv3 import dcnv3_core as jax_dcnv3_core
from givepose_tpu.ops.dcnv3_pallas import dcnv3_pallas

from givepose_torch.ops.dcnv3 import dcnv3_core
from givepose_torch.ops.dcnv3_cuda import dcnv3, dcnv3_cuda

torch.set_num_threads(2)


def make_inputs(seed, n=2, h=9, w=8, group=2, gc=8, kernel=3, stride=1,
                pad=1, dilation=1, offset_mult=2.0):
    """x, offset (x offset_mult, so corners land out of bounds) and a
    softmaxed mask, as numpy f32."""
    rng = np.random.default_rng(seed)
    p = kernel * kernel
    ho = (h + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1
    x = rng.normal(size=(n, h, w, group * gc)).astype(np.float32)
    off = (rng.normal(size=(n, ho, wo, group * p * 2))
           * offset_mult).astype(np.float32)
    logits = rng.normal(size=(n, ho, wo, group, p))
    m = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, off, m.reshape(n, ho, wo, group * p).astype(np.float32)


CASES = [  # (stride, dilation, window)
    (1, 1, 0), (2, 1, 0), (1, 2, 0), (2, 2, 0), (1, 1, 3), (2, 1, 3),
    (2, 2, 3),
]


@pytest.mark.parametrize("stride,dilation,window", CASES)
def test_core_matches_jax(stride, dilation, window):
    x, off, m = make_inputs(stride * 10 + dilation, stride=stride,
                            dilation=dilation)
    kw = dict(kernel=3, stride=stride, pad=1, dilation=dilation, group=2,
              offset_scale=1.0, window=window)
    ref = np.asarray(jax_dcnv3_core(jnp.asarray(x), jnp.asarray(off),
                                    jnp.asarray(m), **kw))
    out = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(m), **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_offsets_reach_out_of_bounds():
    """The test inputs do put corners outside the image."""
    from givepose_torch.ops.dcnv3 import dcnv3_sampling_locations
    _, off, _ = make_inputs(21, stride=2)
    loc = dcnv3_sampling_locations(torch.from_numpy(off), 11, 10, 3, 2, 1,
                                   2, 1.0)
    assert (loc < 0).any() and (loc[..., 0] > 10).any()


@pytest.mark.parametrize("stride", [1, 2])
def test_core_matches_pallas_interpret(stride):
    x, off, m = make_inputs(40 + stride, h=8, w=8, group=4, gc=8,
                            stride=stride)
    ref = np.asarray(dcnv3_pallas(jnp.asarray(x), jnp.asarray(off),
                                  jnp.asarray(m), stride=stride, group=4,
                                  interpret=True))
    out = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(m), stride=stride, group=4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("stride,dilation,window", [(1, 1, 0), (2, 1, 0),
                                                    (2, 2, 3)])
def test_core_grads_match_jax(stride, dilation, window):
    x, off, m = make_inputs(60 + stride, n=1, h=7, w=6, stride=stride,
                            dilation=dilation)
    kw = dict(kernel=3, stride=stride, pad=1, dilation=dilation, group=2,
              offset_scale=1.0, window=window)
    rng = np.random.default_rng(7)
    ho, wo = off.shape[1:3]
    cot = rng.normal(size=(1, ho, wo, x.shape[-1])).astype(np.float32)

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


def test_clamp_tie_grads_match_jax():
    """Window 1, zero offsets: every corner tap of the 3x3 grid lies on
    the window's bound, where ``jnp.clip``'s gradient is 0.5 (that of
    ``torch.clamp`` is 1, which doubled d_offset there)."""
    x, _, m = make_inputs(80, n=1, h=8, w=8, group=1, gc=8)
    off = np.zeros((1, 8, 8, 18), np.float32)
    kw = dict(kernel=3, stride=1, pad=1, dilation=1, group=1,
              offset_scale=1.0, window=1)
    cot = np.random.default_rng(81).normal(size=x.shape).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jax_dcnv3_core(a, b, c, **kw) * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(off),
                                            jnp.asarray(m))
    tx, toff, tm = (torch.from_numpy(a).requires_grad_() for a in (x, off, m))
    (dcnv3_core(tx, toff, tm, **kw) * torch.from_numpy(cot)).sum().backward()
    # the corner taps' d_offset is half the unclamped one, not zero
    assert np.abs(np.asarray(jg[1])).max() > 1e-2
    for name, t, j in (("x", tx, jg[0]), ("offset", toff, jg[1]),
                       ("mask", tm, jg[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   err_msg=name)


def test_dispatch_on_cpu_takes_plain_path():
    x, off, m = make_inputs(3, stride=2)
    tx, toff, tm = (torch.from_numpy(a) for a in (x, off, m))
    dcnv3_cuda.launches = 0
    out = dcnv3(tx.to(torch.bfloat16), toff, tm, stride=2, group=2)
    ref = dcnv3_core(tx.to(torch.bfloat16).float(), toff, tm, stride=2,
                     group=2)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert dcnv3_cuda.launches == 0


@pytest.mark.parametrize("impl,window,exc", [
    ("cuda", 0, RuntimeError),            # CPU tensor never reaches a kernel
    ("cuda", 3, RuntimeError),            # nor the windowed one
    ("bogus", 0, ValueError),
])
def test_dispatch_raises(impl, window, exc):
    x, off, m = make_inputs(4)
    with pytest.raises(exc):
        dcnv3(torch.from_numpy(x), torch.from_numpy(off),
              torch.from_numpy(m), group=2, window=window, impl=impl)
    assert dcnv3_cuda.launches == 0


# (h_out, w_out, group, kernel, backward): the MAPEncoder layers, ragged
# and tiny outputs, and tap counts that force a smaller tile
TILE_CASES = [(32, 32, 4, 3, False), (32, 32, 4, 3, True), (8, 8, 4, 3, True),
              (11, 13, 4, 3, True), (1, 1, 4, 3, False), (5, 40, 16, 5, True),
              (9, 3, 16, 7, True), (7, 7, 1, 1, False)]


@pytest.mark.parametrize("h_out,w_out,group,kernel,backward", TILE_CASES)
def test_tile_fits_and_covers_every_pixel_once(h_out, w_out, group, kernel,
                                               backward):
    """The forward's and the backward's tile: its taps fit in the shared
    memory of a block with a second block beside it (227 KB a block at
    most), and the grid the kernels launch (ceil-divided output, row-major
    tile) reaches each output pixel exactly once."""
    from givepose_torch.ops.dcnv3_cuda import (TILE_SMEM_BYTES, dcn_tile,
                                               tile_smem_bytes)

    th, tw = dcn_tile(group, kernel, backward)
    smem = tile_smem_bytes(th, tw, group, kernel, backward)
    assert smem <= TILE_SMEM_BYTES and 2 * smem <= 228 * 1024
    assert smem <= 227 * 1024
    seen = np.zeros((h_out, w_out), int)
    for by in range(-(-h_out // th)):
        for bx in range(-(-w_out // tw)):
            for pix in range(th * tw):
                oh, ow = by * th + pix // tw, bx * tw + pix % tw
                if oh < h_out and ow < w_out:
                    seen[oh, ow] += 1
    assert (seen == 1).all()


def test_tile_raises_when_one_pixel_does_not_fit():
    from givepose_torch.ops.dcnv3_cuda import dcn_tile

    with pytest.raises(ValueError, match="one pixel"):
        dcn_tile(64, 9, True)


@pytest.mark.parametrize("gc,dtype,shift,want", [
    (64, torch.bfloat16, 0, 8), (64, torch.float32, 0, 8),
    (96, torch.bfloat16, 0, 8), (12, torch.bfloat16, 0, 4),
    (6, torch.float32, 0, 2), (5, torch.bfloat16, 0, 1),
    (64, torch.bfloat16, 4, 4), (64, torch.bfloat16, 1, 1),
    (64, torch.float32, 2, 2)])
def test_vector_width(gc, dtype, shift, want):
    """The channels a lane moves: the largest of 8, 4, 2, 1 that divides gc
    and to whose vector (at most 16 bytes) x is aligned; a view shifted by
    ``shift`` elements from an aligned buffer narrows it."""
    from givepose_torch.ops.dcnv3_cuda import _vec

    x = torch.zeros(64 * 4 + 16, dtype=dtype)[shift:shift + 64 * 4]
    assert x.data_ptr() % 16 == (shift * x.element_size()) % 16
    assert _vec(gc, x) == want
