"""The DCNv3 CUDA kernels against their plain PyTorch versions, on the GPU.

Every test carries the ``cuda`` marker and skips without a GPU.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_dcnv3_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which pins JAX to the CPU.)
Inputs are rounded to the kernel's input dtype first and handed to both
versions, so only the f32 summation order differs (and, for the backward's
d_x, the order of its atomic adds): bar 1e-4 * max|ref| for the output and
for each of d_x, d_offset and d_mask.
"""

import pytest
import torch

from givepose_torch.ops.dcnv3 import dcnv3_core, dcnv3_core_bwd
from givepose_torch.ops.dcnv3_cuda import (dcnv3, dcnv3_bwd_cuda, dcnv3_cuda,
                                           dcnv3_win_cuda)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, n, h, w, group, gc, stride, dilation, offset_mult,
                device, pad=1, kernel=3):
    g = torch.Generator(device=device).manual_seed(seed)
    p = kernel * kernel
    ho = (h + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1
    wo = (w + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1
    x = torch.randn(n, h, w, group * gc, generator=g, device=device)
    off = torch.randn(n, ho, wo, group * p * 2, generator=g,
                      device=device) * offset_mult
    m = torch.softmax(torch.randn(n, ho, wo, group, p, generator=g,
                                  device=device), dim=-1)
    return x, off, m.reshape(n, ho, wo, group * p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gc,stride,dilation,mult,h", [
    (64, 2, 1, 2.0, 16), (16, 1, 2, 2.0, 9), (4, 2, 1, 8.0, 7),
    (8, 1, 1, 2.0, 5), (96, 2, 1, 2.0, 8), (5, 1, 1, 2.0, 6),
])
def test_kernel_matches_plain(cuda, dtype, gc, stride, dilation, mult, h):
    x, off, m = make_inputs(gc, 2, h, h + 1, 4, gc, stride, dilation, mult,
                            cuda)
    kw = dict(stride=stride, dilation=dilation, group=4)
    x = x.to(dtype)
    out = dcnv3_cuda(x, off, m, **kw)
    ref = dcnv3_core(x.float(), off, m, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_dispatch_on_card(cuda):
    """auto launches the kernel for CUDA tensors, torch never does, and a
    windowed call launches the windowed kernel (no fallback)."""
    x, off, m = make_inputs(0, 1, 8, 8, 4, 8, 2, 1, 2.0, cuda)
    dcnv3_cuda.launches = dcnv3_win_cuda.launches = 0
    a = dcnv3(x, off, m, stride=2)
    b = dcnv3(x, off, m, stride=2, impl="torch")
    assert dcnv3_cuda.launches == 1
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max())
    a = dcnv3(x, off, m, stride=2, window=3)
    b = dcnv3(x, off, m, stride=2, window=3, impl="torch")
    assert dcnv3_win_cuda.launches == 1 and dcnv3_cuda.launches == 1
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max())
    with pytest.raises(ValueError):
        dcnv3_cuda(x, off[..., :-2].contiguous(), m, stride=2)
    with pytest.raises(ValueError):
        dcnv3_win_cuda(x, off, m, stride=2, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gc,stride,dilation,mult,h", [
    (64, 2, 1, 2.0, 16), (64, 2, 1, 0.0, 16), (16, 1, 2, 2.0, 9),
    (4, 2, 1, 8.0, 7), (96, 2, 1, 2.0, 8), (5, 1, 1, 2.0, 6),
])
def test_bwd_kernel_matches_plain(cuda, dtype, gc, stride, dilation, mult,
                                  h):
    """Zero offsets (mult 0) put every sample on a texel centre, where the
    kernel's floor must pick the same neighbour as the plain version's."""
    x, off, m = make_inputs(gc + 1, 2, h, h + 1, 4, gc, stride, dilation,
                            mult, cuda)
    kw = dict(stride=stride, dilation=dilation, group=4)
    x = x.to(dtype)
    g = torch.randn(dcnv3_core(x.float(), off, m, **kw).shape,
                    generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    got = dcnv3_bwd_cuda(x, off, m, g, **kw)
    want = dcnv3_core_bwd(x, off, m, g, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_x", "d_offset", "d_mask"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), \
            name


@pytest.mark.cuda
def test_cuda_output_is_differentiable(cuda):
    """On CUDA tensors dcnv3 runs DCNv3Function: the output has a grad_fn,
    backward() launches the backward kernel once, and the gradients are
    the plain version's; d_x comes back in x's dtype."""
    x, off, m = make_inputs(2, 2, 16, 16, 4, 64, 2, 1, 2.0, cuda)
    xb = x.to(torch.bfloat16).requires_grad_()
    offr, mr = off.clone().requires_grad_(), m.clone().requires_grad_()
    dcnv3_bwd_cuda.launches = 0
    y = dcnv3(xb, offr, mr, stride=2)
    assert y.grad_fn is not None
    g = torch.randn_like(y)
    y.backward(g)
    assert dcnv3_bwd_cuda.launches == 1
    assert xb.grad.dtype == torch.bfloat16
    want = dcnv3_core_bwd(xb.detach(), off, m, g, stride=2)
    for got, ref in ((xb.grad.float(), want[0].to(torch.bfloat16).float()),
                     (offr.grad, want[1]), (mr.grad, want[2])):
        assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_train_step_runs_the_kernels(cuda):
    """A small PoseNet train step on the card launches each DCNv3 kernel
    three times (one per MAPEncoder layer) and moves the parameters."""
    from givepose_torch.core.config import Config, TrainConfig
    from givepose_torch.eval.serving import example_serving_batch
    from givepose_torch.train import init_train_state, make_train_step

    cfg = Config(train=TrainConfig(batch_size=2, warmup_iters=1))
    state = init_train_state(cfg, "custom", device=cuda,
                             backbone_depths=(1, 1, 1, 1),
                             backbone_dims=(16, 32, 48, 64), img_size=64)
    b = 2
    batch = example_serving_batch(b, img_size=64, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch.update({
        "rotation": torch.eye(3, device=cuda).expand(b, 3, 3).contiguous(),
        "translation": torch.rand(b, 3, generator=gen, device=cuda),
        "real_size": torch.rand(b, 3, generator=gen, device=cuda),
        "nocs_scale": torch.full((b,), 0.3, device=cuda),
        "sym_info": torch.tensor([[1.0, 1, 0, 1]] * b, device=cuda),
        "nocs_coord": torch.rand(b, 16, 16, 3, generator=gen, device=cuda),
        "ivfc_coord": torch.rand(b, 16, 16, 3, generator=gen, device=cuda),
        "roi_mask_output": torch.ones(b, 16, 16, 1, device=cuda),
        "roi_ivfc_mask_output": torch.ones(b, 16, 16, 1, device=cuda),
        "model_point": torch.rand(b, 64, 3, generator=gen, device=cuda),
    })
    before = [p.detach().clone() for p in state.model.parameters()]
    step = make_train_step(state.model, cfg)
    dcnv3_cuda.launches = dcnv3_bwd_cuda.launches = 0
    metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    assert dcnv3_cuda.launches == 3 and dcnv3_bwd_cuda.launches == 3
    assert torch.isfinite(metrics["total_loss"])
    assert metrics["notfinite_total"] == 0
    assert any(not torch.equal(a, p) for a, p in
               zip(before, state.model.parameters()))


def on_bound(off, window, kernel=3):
    """Offsets that put every tap exactly on the window's bound (x high,
    y low; offset_scale 1)."""
    half = (kernel - 1) // 2
    lin = torch.arange(kernel, device=off.device, dtype=off.dtype) - half
    gx, gy = lin.repeat_interleave(kernel), lin.repeat(kernel)
    o = off.reshape(*off.shape[:3], -1, kernel * kernel, 2).clone()
    o[..., 0] = window - gx
    o[..., 1] = -window - gy
    return o.reshape(off.shape)


# (gc, stride, dilation, offset multiplier, h, window, on bound); large
# multipliers put most samples on the clamp
WIN_CASES = [
    (64, 2, 1, 2.0, 16, 4, False), (64, 2, 1, 8.0, 16, 4, False),
    (64, 2, 1, 0.0, 16, 4, True), (16, 1, 2, 2.0, 9, 3, False),
    (4, 2, 1, 8.0, 7, 1, False), (96, 2, 1, 2.0, 8, 4, False),
    (5, 1, 1, 2.0, 6, 2, False), (64, 1, 1, 3.0, 11, 3, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gc,stride,dilation,mult,h,window,bound", WIN_CASES)
def test_win_kernel_matches_plain(cuda, dtype, gc, stride, dilation, mult, h,
                                  window, bound):
    x, off, m = make_inputs(gc + 7, 2, h, h + 1, 4, gc, stride, dilation,
                            mult, cuda)
    if bound:
        off = on_bound(off, window)
    kw = dict(stride=stride, dilation=dilation, group=4, window=window)
    x = x.to(dtype)
    out = dcnv3_win_cuda(x, off, m, **kw)
    ref = dcnv3_core(x.float(), off, m, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_win_kernel_wide_rows_tile_columns(cuda):
    """f32 x, 64 channels per group and a 96-wide input: one full output
    row's slab exceeds the tile budget, so the kernel tiles columns."""
    x, off, m = make_inputs(3, 2, 20, 96, 4, 64, 2, 1, 4.0, cuda)
    kw = dict(stride=2, group=4, window=4)
    out = dcnv3_win_cuda(x, off, m, **kw)
    ref = dcnv3_core(x, off, m, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gc,stride,dilation,mult,h,window,bound", WIN_CASES)
def test_win_bwd_kernel_matches_plain(cuda, dtype, gc, stride, dilation,
                                      mult, h, window, bound):
    """The backward kernel with a window: samples at clamped locations,
    d_offset scaled by the clamp's gradient (0 where it holds a sample,
    0.5 on its bound)."""
    x, off, m = make_inputs(gc + 9, 2, h, h + 1, 4, gc, stride, dilation,
                            mult, cuda)
    if bound:
        off = on_bound(off, window)
    kw = dict(stride=stride, dilation=dilation, group=4, window=window)
    x = x.to(dtype)
    g = torch.randn(dcnv3_core(x.float(), off, m, **kw).shape,
                    generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    got = dcnv3_bwd_cuda(x, off, m, g, **kw)
    want = dcnv3_core_bwd(x, off, m, g, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_x", "d_offset", "d_mask"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), \
            name


@pytest.mark.cuda
def test_win_bwd_clamp_tie(cuda):
    """Window 1, zero offsets, stride 1: every corner tap lies on the
    window's bound, where d_offset is half the unclamped gradient."""
    x, _, m = make_inputs(5, 1, 8, 8, 1, 8, 1, 1, 0.0, cuda)
    off = torch.zeros(1, 8, 8, 18, device=cuda)
    kw = dict(stride=1, group=1, window=1)
    g = torch.randn(1, 8, 8, 8, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    got = dcnv3_bwd_cuda(x, off, m, g, **kw)
    want = dcnv3_core_bwd(x, off, m, g, **kw)
    unclamped = dcnv3_core_bwd(x, off, m, g, stride=1, group=1)[1]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    corner = torch.tensor([0, 2, 6, 8], device=cuda)
    held = want[1].reshape(1, 8, 8, 9, 2)[..., corner, :]
    free = unclamped.reshape(1, 8, 8, 9, 2)[..., corner, :]
    assert free.abs().max().item() > 1e-2
    torch.testing.assert_close(held, 0.5 * free)


@pytest.mark.cuda
def test_windowed_output_is_differentiable(cuda):
    """A windowed CUDA DCNv3 runs the windowed forward and the backward
    kernel with the window."""
    x, off, m = make_inputs(4, 2, 16, 16, 4, 64, 2, 1, 6.0, cuda)
    xb = x.to(torch.bfloat16).requires_grad_()
    offr, mr = off.clone().requires_grad_(), m.clone().requires_grad_()
    dcnv3_win_cuda.launches = dcnv3_bwd_cuda.launches = 0
    y = dcnv3(xb, offr, mr, stride=2, window=4)
    g = torch.randn_like(y)
    y.backward(g)
    assert dcnv3_win_cuda.launches == 1 and dcnv3_bwd_cuda.launches == 1
    want = dcnv3_core_bwd(xb.detach(), off, m, g, stride=2, window=4)
    for got, ref in ((xb.grad.float(), want[0].to(torch.bfloat16).float()),
                     (offr.grad, want[1]), (mr.grad, want[2])):
        assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


# the forward's and the backward's tiles (4 x 8 output pixels a block, at
# most one pixel a warp at a time): (gc, stride, h, w, offsets), offsets
# "far" N(0, 20 px), most samples outside the block's reach or the image;
# "band" U(-3, 3) px on a small image, corners in the pad band of every
# edge; "ragged" N(0, 2 px) with an 11 x 13 output, tiles ragged at the
# last row and column.  gc 24 and 12 take the narrow vectors with a dot
# shared by several lane segments, gc 2 two channels a lane.
TILED_CASES = [(64, 2, 22, 26, "far"), (64, 1, 6, 7, "band"),
               (64, 2, 22, 26, "ragged"), (24, 2, 10, 12, "ragged"),
               (12, 1, 8, 9, "band"), (2, 2, 9, 9, "far")]


def tiled_inputs(seed, gc, stride, h, w, kind, device):
    x, off, m = make_inputs(seed, 2, h, w, 4, gc, stride, 1, 2.0, device)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    if kind == "far":
        off = torch.randn(off.shape, generator=g, device=device) * 20.0
    elif kind == "band":
        off = torch.rand(off.shape, generator=g, device=device) * 6.0 - 3.0
    return x, off, m


def check_both(x, off, m, kw, seed):
    """Forward and backward kernels against the plain versions, each
    output within 1e-4 * max|ref|."""
    out = dcnv3_cuda(x, off, m, **kw)
    ref = dcnv3_core(x.float(), off, m, **kw)
    g = torch.randn(ref.shape, generator=torch.Generator(
        device=x.device).manual_seed(seed), device=x.device)
    got = dcnv3_bwd_cuda(x, off, m, g, **kw)
    want = dcnv3_core_bwd(x, off, m, g, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    for name, a, b in zip(("d_x", "d_offset", "d_mask"), got, want):
        assert a.shape == b.shape, name
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gc,stride,h,w,kind", TILED_CASES)
def test_tiled_kernels_match_plain(cuda, dtype, gc, stride, h, w, kind):
    x, off, m = tiled_inputs(gc + stride, gc, stride, h, w, kind, cuda)
    if kind == "far":      # most samples outside the image: some inside
        assert ((off.abs() < 4).float().mean() > 0.1).item()
    check_both(x.to(dtype), off, m, dict(stride=stride, group=4), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shift,vec", [
    (torch.bfloat16, 1, 1), (torch.bfloat16, 2, 2), (torch.bfloat16, 4, 4),
    (torch.float32, 2, 2), (torch.float32, 1, 1)])
def test_kernels_take_misaligned_x(cuda, dtype, shift, vec):
    """x a contiguous view ``shift`` elements into a buffer: the wrappers
    narrow the vector to x's alignment, and both kernels stay right."""
    from givepose_torch.ops.dcnv3_cuda import _vec

    x, off, m = make_inputs(11, 2, 12, 14, 4, 64, 2, 1, 2.0, cuda)
    buf = torch.empty(x.numel() + 8, dtype=dtype, device=cuda)
    xs = buf[shift:shift + x.numel()].view(x.shape)
    xs.copy_(x)
    assert _vec(64, xs) == vec
    check_both(xs, off, m, dict(stride=2, group=4), 5)
