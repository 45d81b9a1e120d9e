"""The windowed DCNv3 forward's tiling, and the TPU sweep of that kernel.

- ``win_plan`` (``ops/dcnv3_cuda.py``), the plan of the windowed forward
  kernel, at the three MAPEncoder shapes and every windowed edge case of
  ``chip_smoke.py``, x in bf16 and f32, at the default, ``mono`` and
  ``chunk2`` plans: its tiles cover every output pixel once; every
  in-image corner that a clamped sample of a tile can reach (worked out
  here from the centre +- window, floor and +1) lies inside that tile's
  slab; its shared memory fits.  A numpy walk of the plan (slabs staged
  with zeros outside the image, all four corners of every tap read from
  the slab with no validity test) against the plain ``dcnv3_core(...,
  window=w)``.
- The TPU sweep's design variants (``benchmarks/bench_win_kernel_split.py``
  ``_mono_kernel`` and ``_chunk_kernel``, ported as plans of the kernel
  above) in interpret mode, through ``pl.pallas_call``s built here as that
  file's ``run_mono`` and ``run_chunk`` build them, against the port's
  plain version within the sweep's own bar (2e-2 * max|ref|: the TPU
  kernels round their intermediates to bf16) and against
  ``dcnv3_windowed_pallas`` in interpret mode.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from givepose_torch.ops.dcnv3 import (clamp_to_window, dcnv3_core,
                                      dcnv3_sampling_locations)
from givepose_torch.ops.dcnv3_cuda import (WIN_MAX_SMEM, WIN_SMEM_BYTES,
                                           WIN_TAP_BYTES, win_plan)
from givepose_tpu.ops.dcnv3_window_pallas import (_prepare, _win_dims,
                                                  dcnv3_windowed_pallas)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sweep_module():
    spec = importlib.util.spec_from_file_location(
        "bench_win_kernel_split",
        os.path.join(REPO, "benchmarks", "bench_win_kernel_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (name, n, h, w, group, gc, stride, pad, dilation, window)
SHAPES = ([(name, chip_smoke.BATCH, s, s, 4, 64, 2, 1, 1, chip_smoke.WINDOW)
           for name, s in chip_smoke.MAIN_LAYERS]
          + [(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[10])
             for c in chip_smoke.WIN_EDGE_CASES])
PLANS = ["default", "mono", "chunk2"]


def plan_for(shape, elem, mode):
    _, n, h, w, group, gc, stride, pad, dil, window = shape
    ho = chip_smoke.out_side(h, stride, pad, dil)
    wo = chip_smoke.out_side(w, stride, pad, dil)
    return ho, wo, win_plan(n, ho, wo, group, gc, elem, 3, stride, pad, dil,
                            window, True, mode)


def reach(o: int, stride: int, pad: int, dilation: int, window: int,
          size: int) -> set:
    """Input pixels (unpadded) that a bilinear corner of a sample of
    output pixel ``o`` can land on inside the image: floor of a location
    clamped to centre +- window, or that floor + 1."""
    centre = dilation + stride * o           # half = dilation for k 3
    floors = range(centre - window, centre + window + 1)
    return {c - pad for f in floors for c in (f, f + 1)
            if 0 <= c - pad < size}


@pytest.mark.parametrize("mode", PLANS)
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_win_plan_covers_reaches_and_fits(shape, elem, mode):
    name, n, h, w, group, gc, stride, pad, dil, window = shape
    ho, wo, plan = plan_for(shape, elem, mode)

    # every output pixel of an (image, group) in exactly one tile of one
    # block
    hits = np.zeros((ho, wo), np.int64)
    chunks = plan.blocks // (n * group)
    tiles = [t for c in range(chunks) for t in plan.block_tiles(c)]
    assert all(len(plan.block_tiles(c)) <= plan.tiles_per_block
               for c in range(chunks))
    for oh0, ow0 in tiles:
        hits[oh0:oh0 + plan.tile_rows, ow0:ow0 + plan.tile_cols] += 1
    assert (hits == 1).all(), name
    if mode == "mono":
        assert chunks == 1
    if mode == "chunk2":
        assert plan.tiles_per_block == min(2, len(tiles))

    # every in-image corner a tile's samples can reach lies in its slab
    for oh0, ow0 in tiles:
        ys = set().union(*(reach(o, stride, pad, dil, window, h) for o in
                           range(oh0, min(oh0 + plan.tile_rows, ho))))
        xs = set().union(*(reach(o, stride, pad, dil, window, w) for o in
                           range(ow0, min(ow0 + plan.tile_cols, wo))))
        y0, x0 = plan.slab_origin(oh0, ow0)
        assert y0 <= min(ys) and max(ys) < y0 + plan.slab_rows, (name, oh0)
        assert x0 <= min(xs) and max(xs) < x0 + plan.slab_cols, (name, ow0)

    # the shared memory: mbarriers, the slab buffers and the taps
    slab = plan.slab_rows * plan.slab_cols * gc * elem
    taps = plan.tile_rows * plan.tile_cols * 9 * WIN_TAP_BYTES
    tables = 2 if plan.tiles_per_block > 1 else 1
    assert plan.smem_bytes >= plan.stages * slab + tables * taps
    assert plan.smem_bytes <= WIN_MAX_SMEM
    if mode == "default":
        assert plan.smem_bytes <= WIN_SMEM_BYTES
    assert plan.staging == ("tma" if (gc * elem) % 16 == 0 else "copy")


def test_win_plan_raises_where_no_slab_fits():
    """A shape whose one-pixel slab exceeds a block's shared memory raises
    ValueError naming it."""
    with pytest.raises(ValueError, match="one-pixel slab"):
        win_plan(1, 20, 20, 1, 1024, 4, 3, 1, 1, 1, 8)
    with pytest.raises(ValueError, match="unknown"):
        win_plan(1, 8, 8, 4, 64, 2, 3, 2, 1, 1, 4, True, "chunky")


def walk_plan(x, off, m, plan, stride, pad, dil, window, group):
    """The kernel's arithmetic in numpy, block by block: each tile's slab
    of x with zeros outside the image, each tap's four corners read from
    the slab (all four inside it, a corner outside the image reading the
    slab's zero), weighted by the bilinear weights times the mask, the
    taps summed in order."""
    n, h, w, c_total = x.shape
    gc = c_total // group
    ho, wo = off.shape[1:3]
    loc = clamp_to_window(dcnv3_sampling_locations(
        torch.from_numpy(off), h + 2 * pad, w + 2 * pad, 3, stride, dil,
        group, 1.0), ho, wo, 3, stride, dil, window).numpy()
    out = np.zeros((n, ho, wo, c_total), np.float64)
    rows, cols = plan.slab_rows, plan.slab_cols
    for b in range(n):
        for g in range(group):
            xg = x[b, :, :, g * gc:(g + 1) * gc]
            for chunk in range(plan.blocks // (n * group)):
                for oh0, ow0 in plan.block_tiles(chunk):
                    y0, x0 = plan.slab_origin(oh0, ow0)
                    slab = np.zeros((rows, cols, gc), np.float64)
                    sy = slice(max(y0, 0), min(y0 + rows, h))
                    sx = slice(max(x0, 0), min(x0 + cols, w))
                    slab[sy.start - y0:sy.stop - y0,
                         sx.start - x0:sx.stop - x0] = xg[sy, sx]
                    for oh in range(oh0, min(oh0 + plan.tile_rows, ho)):
                        for ow in range(ow0, min(ow0 + plan.tile_cols, wo)):
                            acc = np.zeros(gc)
                            for t in range(9):
                                lx, ly = loc[b, oh, ow, g, t]
                                fx0, fy0 = np.floor(lx), np.floor(ly)
                                fx, fy = lx - fx0, ly - fy0
                                wts = ((1 - fx) * (1 - fy), fx * (1 - fy),
                                       (1 - fx) * fy, fx * fy)
                                for k in range(4):
                                    sx = int(fx0) + (k & 1) - pad - x0
                                    sy = int(fy0) + (k >> 1) - pad - y0
                                    # all four corners in the slab, in the
                                    # image or not
                                    assert 0 <= sx < cols and 0 <= sy < rows
                                    acc += (m[b, oh, ow, g * 9 + t] * wts[k]
                                            * slab[sy, sx])
                            out[b, oh, ow, g * gc:(g + 1) * gc] = acc
    return out


@pytest.mark.parametrize("mode", PLANS)
def test_walk_of_the_plan_matches_plain(mode):
    """The plan's slabs and slab-relative taps give the plain windowed
    DCNv3 (ragged tiles: a 7 x 9 output of 4 x 8 tiles)."""
    rng = np.random.default_rng(3)
    n, h, w, group, gc, stride, window = 1, 14, 18, 2, 3, 2, 4
    ho, wo = 7, 9
    x = rng.normal(size=(n, h, w, group * gc)).astype(np.float32)
    off = (rng.normal(size=(n, ho, wo, group * 18)) * 3).astype(np.float32)
    m = rng.random((n, ho, wo, group * 9)).astype(np.float32)
    plan = win_plan(n, ho, wo, group, gc, 4, 3, stride, 1, 1, window, True,
                    mode + "-tile4x8" if mode == "default" else mode)
    assert (plan.tile_rows, plan.tile_cols) == (4, 8)
    got = walk_plan(x, off, m, plan, stride, 1, 1, window, group)
    ref = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(m), stride=stride, group=group,
                     window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ---- the TPU sweep's variants, interpret mode --------------------------

# batch 2, 32 x 32 input, 4 groups of 8 channels, stride 2, window 4
SWEEP = dict(n=2, h=32, c=32, group=4, stride=2, window=4)


def sweep_inputs():
    rng = np.random.default_rng(7)
    n, h, c = SWEEP["n"], SWEEP["h"], SWEEP["c"]
    ho = h // SWEEP["stride"]
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    off = (rng.normal(size=(n, ho, ho, SWEEP["group"] * 18)) * 2
           ).astype(np.float32)
    logits = rng.normal(size=(n, ho, ho, SWEEP["group"], 9))
    m = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return x, off, m.reshape(n, ho, ho, -1).astype(np.float32)


def run_sweep_kernel(kind: str, x, off, m):
    """``_mono_kernel`` (kind "mono") or ``_chunk_kernel`` with 2 tiles a
    step (kind "chunk2") through a ``pl.pallas_call`` built as
    ``run_mono`` / ``run_chunk`` build it, in interpret mode; returns
    (N, Ho, Wo, C) as the sweep's ``verify`` lays it out."""
    sweep = _sweep_module()
    group, stride, window = SWEEP["group"], SWEEP["stride"], SWEEP["window"]
    x, off, m = jnp.asarray(x), jnp.asarray(off), jnp.asarray(m)
    n = x.shape[0]
    d = _win_dims(x.shape, off.shape, 3, stride, 1, 1, group, window)
    img, aux, _ = _prepare(x, off, m, 3, stride, 1, 1, group, 1.0, window,
                           jnp.bfloat16)
    gc, p, t, n_tiles = d["gc"], d["p"], d["t"], d["n_tiles"]
    img_spec = (1, group, d["h_eff"] * gc, d["w_pad"])
    params = pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024)
    if kind == "mono":
        out = pl.pallas_call(
            functools.partial(sweep._mono_kernel, dims=d, n_tiles=n_tiles),
            grid=(n,),
            in_specs=[
                pl.BlockSpec(img_spec, lambda i: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, group, n_tiles, 3, p * t),
                             lambda i: (i, 0, 0, 0, 0),
                             memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, group, gc, n_tiles * t),
                                   lambda i: (i, 0, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n, group, gc, n_tiles * t),
                                           jnp.float32),
            compiler_params=params, interpret=True)(img, aux)
    else:
        ch = 2
        assert n_tiles % ch == 0
        out = pl.pallas_call(
            functools.partial(sweep._chunk_kernel, dims=d, ch=ch),
            grid=(n, n_tiles // ch),
            in_specs=[
                pl.BlockSpec(img_spec, lambda i, q: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, group, ch, 3, p * t),
                             lambda i, q: (i, 0, q, 0, 0),
                             memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, group, gc, ch * t),
                                   lambda i, q: (i, 0, 0, q),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n, group, gc, n_tiles * t),
                                           jnp.float32),
            scratch_shapes=[pltpu.VMEM((d["slab_h"] * gc, p * t),
                                       jnp.bfloat16)],
            compiler_params=params, interpret=True)(img, aux)
    out = out[..., :d["q_pix"]]
    return np.asarray(out.transpose(0, 3, 1, 2).reshape(
        n, d["h_out"], d["w_out"], group * gc))


@pytest.fixture(scope="module")
def sweep_refs():
    x, off, m = sweep_inputs()
    kw = dict(stride=SWEEP["stride"], group=SWEEP["group"],
              window=SWEEP["window"])
    plain = dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                       torch.from_numpy(m), **kw).numpy()
    tpu = np.asarray(dcnv3_windowed_pallas(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(m), interpret=True,
        **kw))
    return (x, off, m), plain, tpu


@pytest.mark.parametrize("kind", ["mono", "chunk2"])
def test_sweep_variant_matches_plain_and_tpu_kernel(sweep_refs, kind):
    (x, off, m), plain, tpu = sweep_refs
    out = run_sweep_kernel(kind, x, off, m)
    assert out.shape == plain.shape
    scale = np.abs(plain).max()
    assert np.abs(out - plain).max() <= 2e-2 * scale
    # the same bf16 intermediates as the production TPU kernel
    assert np.abs(out - tpu).max() <= 2e-2 * scale
    assert np.abs(tpu - plain).max() <= 2e-2 * scale
