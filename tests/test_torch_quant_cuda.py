"""The int8 kernels against their plain PyTorch versions, on the GPU: the
fused ConvNeXt MLP (``int8_mlp``), the W8A8 dense matmuls (``int8_qmm``,
``int8_qmm_pre``) and ``QuantDense``; and each ``torch.ops.givepose``
operator launching its kernel.

Every test carries the ``cuda`` marker and skips without a GPU; the file
imports no JAX (run it with ``--noconftest`` on a machine without JAX, as
``test_torch_dcnv3_cuda.py``).  Both versions take the same quantized
weights and compute the same int8 values from f32 steps in the same order,
so they differ only where a last bit (tanhf, the order of a reduction
upstream) moves a requantized value across a rounding boundary, a
one-step flip.  Bars: max |out - ref| within 3 one-step flips of the second
product (3 * max(hs) * max|s1 * w1q|) plus 2 ulp of the output dtype at
max|ref|, and mean |out - ref| within 1e-3 * mean|ref|, which a
systematic fault exceeds.  In bf16 both round the same f32 value.
"""

import pytest
import torch

from givepose_torch.ops.quant_matmul import (convnext_mlp_int8,
                                             mlp_int8_cuda, quantize_weights,
                                             requant_flip)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, m, c, hd, device):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    return dict(
        y=randn(m, c), residual=randn(m, c),
        w0=randn(c, hd, scale=c ** -0.5), b0=randn(hd, scale=0.1),
        w1=randn(hd, c, scale=hd ** -0.5), b1=randn(c, scale=0.1),
        gamma=1 + randn(c, scale=0.1),
        ln=(randn(m, 1, scale=0.1), 0.5 + randn(m, 1).abs(),
            1 + randn(c, scale=0.1), randn(c, scale=0.1)))


def bars(inp, ln, act, ref):
    w0q, s0 = quantize_weights(inp["w0"])
    w1q, s1 = quantize_weights(inp["w1"], inp["gamma"])
    flip = requant_flip(inp["y"].to(ref.dtype), w0q, s0, inp["b0"], w1q, s1,
                        act, ln)
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -23
    top = ref.float().abs()
    return 3 * flip + 2 * ulp * top.max().item(), 1e-3 * top.mean().item()


def run_both(inp, act, with_ln, dtype):
    ln = inp["ln"] if with_ln else None
    args = [inp["y"].to(dtype), inp["residual"].to(dtype), inp["w0"],
            inp["b0"], inp["w1"], inp["b1"], inp["gamma"]]
    mlp_int8_cuda.launches = 0
    out = convnext_mlp_int8(*args, act=act, out_dtype=dtype, ln=ln)
    ref = convnext_mlp_int8(*args, act=act, out_dtype=dtype, ln=ln,
                            impl="torch")
    torch.cuda.synchronize()
    assert mlp_int8_cuda.launches == 1
    return out, ref, ln


# (m, c, hd): the stage-2 (C 512) and stage-3 (C 1024) widths with a
# ragged last row tile, and narrow ones; the kernel's 64-row tiles: M 37
# short of batch 32's stage-2 rows, M below one tile, stage 3 at its full
# M (two column blocks); 256-column blocks (C 768) and a half last hidden
# chunk (H 320)
SHAPES = [(200, 512, 2048), (77, 1024, 4096), (48, 64, 256),
          (33, 128, 512), (8192 - 37, 512, 2048), (40, 512, 2048),
          (2048, 1024, 4096), (130, 768, 3072), (70, 192, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("m,c,hd", SHAPES)
def test_kernel_matches_plain(cuda, dtype, with_ln, m, c, hd):
    inp = make_inputs(c + m, m, c, hd, cuda)
    out, ref, ln = run_both(inp, "gelu_tanh", with_ln, dtype)
    assert out.dtype == dtype and out.shape == ref.shape
    d = (out.float() - ref.float()).abs()
    max_bar, mean_bar = bars(inp, ln, "gelu_tanh", ref)
    assert d.max().item() <= max_bar, (d.max().item(), max_bar)
    assert d.mean().item() <= mean_bar, (d.mean().item(), mean_bar)
    # not vacuous: the MLP branch moves the output past the residual
    moved = (ref.float() - inp["residual"].to(dtype).float()).abs().mean()
    assert moved.item() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu_exact"])
def test_kernel_activations(cuda, act):
    inp = make_inputs(5, 40, 128, 512, cuda)
    out, ref, ln = run_both(inp, act, True, torch.float32)
    d = (out - ref).abs()
    max_bar, mean_bar = bars(inp, ln, act, ref)
    assert d.max().item() <= max_bar and d.mean().item() <= mean_bar


@pytest.mark.cuda
def test_kernel_rejects(cuda):
    inp = make_inputs(6, 16, 64, 256, cuda)
    w0q, s0 = quantize_weights(inp["w0"])
    w1q, s1 = quantize_weights(inp["w1"], inp["gamma"])
    args = [inp["y"], inp["residual"], w0q.t().contiguous(), s0, inp["b0"],
            w1q.t().contiguous(), s1, inp["b1"]]
    mlp_int8_cuda.launches = 0
    with pytest.raises(TypeError):              # residual of another dtype
        mlp_int8_cuda(args[0], args[1].to(torch.bfloat16), *args[2:])
    with pytest.raises(ValueError):             # C not a multiple of 64
        mlp_int8_cuda(args[0][:, :48].contiguous(), *args[1:])
    with pytest.raises(ValueError):             # transposed weights
        mlp_int8_cuda(*args[:2], w0q, *args[3:])
    with pytest.raises(TypeError):              # kernel writes y's dtype
        convnext_mlp_int8(inp["y"], inp["residual"], inp["w0"], inp["b0"],
                          inp["w1"], inp["b1"], inp["gamma"],
                          out_dtype=torch.bfloat16)
    assert mlp_int8_cuda.launches == 0


@pytest.mark.cuda
def test_kernel_takes_misaligned_views(cuda):
    """Operands that are contiguous views at an odd offset (weights below
    the 16 bytes a TMA tensor map needs, s0 and b0 below the 8 of their
    paired loads) give what the aligned tensors give."""
    inp = make_inputs(7, 100, 128, 512, cuda)
    w0q, s0 = quantize_weights(inp["w0"])
    w1q, s1 = quantize_weights(inp["w1"], inp["gamma"])
    args = [inp["y"], inp["residual"], w0q.t().contiguous(), s0, inp["b0"],
            w1q.t().contiguous(), s1, inp["b1"]]

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    odd = [shifted(t) if i in (2, 3, 4, 5) else t for i, t in enumerate(args)]
    assert odd[2].data_ptr() % 16 and odd[3].data_ptr() % 8
    assert torch.equal(mlp_int8_cuda(*odd), mlp_int8_cuda(*args))


@pytest.mark.cuda
def test_quant_convnext_runs_the_kernel(cuda):
    """A quant ConvNeXt on the card: one launch per block of width >= 512,
    and the same features as with the plain int8 MLP, up to flips."""
    from givepose_torch.models.convnext import ConvNeXt
    from givepose_torch.models.layers import init_weights_

    net = ConvNeXt((1, 1, 2, 1), (32, 64, 512, 1024), quant=True,
                   compute_dtype=torch.bfloat16)
    init_weights_(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
    net = net.to(cuda).eval()
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    mlp_int8_cuda.launches = 0
    with torch.inference_mode():
        out = net(x)
        for mod in net.modules():
            if getattr(mod, "quant", False):
                mod.impl = "torch"
        ref = net(x)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.launches == 3
    assert torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    assert d.mean().item() <= 1e-2 * ref.float().abs().mean().item()


# W8A8 dense kernels (int8_qmm, B4; int8_qmm_pre, B5) against their plain
# versions.  Both compute the same int8 values and f32 steps, so they differ
# only where tanhf or erff differs from PyTorch's: bars of one-step flips of
# a quantized x value (B4) plus 2 ulp of the output dtype at max|ref|, and
# 1e-3 * mean|ref| on average.
# (M, K, N): ragged M and N, K with 16-byte rows (vector loads), K a
# multiple of 8 only, K odd (scalar loads everywhere), a 128-row tile grid
QMM_SHAPES = [(77, 96, 48), (200, 520, 130), (33, 100, 250), (5, 37, 19),
              (1024, 512, 384)]


def qmm_inputs(seed, m, k, n, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(m, k, generator=g, device=device) * 2.0,
            torch.randn(k, n, generator=g, device=device) * k ** -0.5,
            torch.randn(n, generator=g, device=device) * 0.1)


def qmm_bars(ref, flip=0.0):
    ulp = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 2.0 ** -23
    top = ref.float().abs()
    return 3 * 1.13 * flip + 2 * ulp * top.max().item(), \
        1e-3 * top.mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_qmm_matches_plain(cuda, act, dtype, m, k, n):
    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_flip,
                                                 quant_matmul_plain)

    x, w, b = qmm_inputs(m + k + n, m, k, n, cuda)
    x = x.to(dtype)
    wq, ws = quantize_weights(w)
    qmm_cuda.launches = 0
    out = qmm_cuda(x, wq.t().contiguous(), ws, b, act, dtype)
    ref = quant_matmul_plain(x, wq, ws, b, act, dtype)
    torch.cuda.synchronize()
    assert qmm_cuda.launches == 1
    assert out.dtype == dtype and out.shape == (m, n)
    d = (out.float() - ref.float()).abs()
    max_bar, mean_bar = qmm_bars(ref, qmm_flip(x, wq, ws))
    assert d.max().item() <= max_bar, (d.max().item(), max_bar)
    assert d.mean().item() <= mean_bar, (d.mean().item(), mean_bar)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_qmm_pre_matches_plain(cuda, act, dtype, m, k, n):
    from givepose_torch.ops.quant_matmul import (qmm_pre_cuda,
                                                 quant_matmul_pre_plain,
                                                 quantize_activations)

    x, w, b = qmm_inputs(2 * m + k, m, k, n, cuda)
    xq, xs = quantize_activations(x)
    wq, ws = quantize_weights(w)
    qmm_pre_cuda.launches = 0
    out = qmm_pre_cuda(xq, xs.reshape(-1), wq.t().contiguous(), ws, b, act,
                       dtype)
    ref = quant_matmul_pre_plain(xq, xs, wq, ws, b, act, dtype)
    torch.cuda.synchronize()
    assert qmm_pre_cuda.launches == 1
    d = (out.float() - ref.float()).abs()
    max_bar, mean_bar = qmm_bars(ref)
    assert d.max().item() <= max_bar, (d.max().item(), max_bar)
    assert d.mean().item() <= mean_bar, (d.mean().item(), mean_bar)


# edges of the wgmma design's tiling (ops/quant_matmul.py qmm_plan: B4 64
# x 256 tiles, B5 128 x 128): M 37 short of batch 32's stage-2 rows and M
# below one tile; N not a multiple of a tile (48, 130); K through the pad
# rule (520, 100, odd); K 4096, whose quantized rows do not all stay in
# B4's shared memory (a ring of slots); more units than blocks of the
# persistent grid (B4 at M 9000; B5 at M 8155, 8 or 7 tiles a block, and
# at M 9000, 3 or 2: an odd count for a block's two B5 teams)
QMM_EDGE_SHAPES = [(8192 - 37, 512, 2048), (40, 512, 2048), (300, 256, 48),
                   (200, 520, 130), (33, 100, 250), (5, 37, 19),
                   (256, 4096, 1024), (9000, 256, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_exact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", QMM_EDGE_SHAPES)
def test_qmm_tiling_edges(cuda, act, dtype, m, k, n):
    """B4 and B5 against their plain versions at the tiling's edges, at
    the bars of ``test_qmm_matches_plain``."""
    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_flip,
                                                 qmm_plan, qmm_pre_cuda,
                                                 quant_matmul_plain,
                                                 quant_matmul_pre_plain,
                                                 quantize_activations)

    x, w, b = qmm_inputs(3 * m + k + n, m, k, n, cuda)
    x = x.to(dtype)
    xq, xs = quantize_activations(x)
    wq, ws = quantize_weights(w)
    wt = wq.t().contiguous()
    qmm_cuda.launches = qmm_pre_cuda.launches = 0
    runs = ((qmm_cuda(x, wt, ws, b, act, dtype),
             quant_matmul_plain(x, wq, ws, b, act, dtype),
             qmm_flip(x, wq, ws)),
            (qmm_pre_cuda(xq, xs.reshape(-1), wt, ws, b, act, dtype),
             quant_matmul_pre_plain(xq, xs, wq, ws, b, act, dtype), 0.0))
    torch.cuda.synchronize()
    assert qmm_cuda.launches == qmm_pre_cuda.launches == 1
    for out, ref, flip in runs:
        assert out.dtype == dtype and out.shape == (m, n)
        d = (out.float() - ref.float()).abs()
        max_bar, mean_bar = qmm_bars(ref, flip)
        assert d.max().item() <= max_bar, (d.max().item(), max_bar)
        assert d.mean().item() <= mean_bar, (d.mean().item(), mean_bar)
    if m >= 8000:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        kp = -(-k // 16) * 16
        plans = [qmm_plan(m, n, kp, pre, sms) for pre in (False, True)]
        assert any(p.units(m) > p.blocks for p in plans)


@pytest.mark.cuda
def test_qmm_takes_misaligned_views(cuda):
    """Operands that are contiguous views at an odd offset (x, xq and wt
    below the 16 bytes a TMA tensor map and B4's loads need, ws and bias
    below 8) give what the aligned tensors give."""
    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_pre_cuda,
                                                 quantize_activations)

    x, w, b = qmm_inputs(11, 100, 256, 384, cuda)
    xq, xs = quantize_activations(x)
    wq, ws = quantize_weights(w)
    wt = wq.t().contiguous()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    xb = x.to(torch.bfloat16)
    odd = [shifted(t) for t in (xb, xq, wt, ws, b)]
    assert all(t.data_ptr() % 8 for t in odd)
    for act in ("none", "gelu_tanh"):
        assert torch.equal(qmm_cuda(odd[0], odd[2], odd[3], odd[4], act),
                           qmm_cuda(xb, wt, ws, b, act))
        assert torch.equal(
            qmm_pre_cuda(odd[1], xs.reshape(-1), odd[2], odd[3], odd[4],
                         act),
            qmm_pre_cuda(xq, xs.reshape(-1), wt, ws, b, act))


@pytest.mark.cuda
def test_qmm_rejects(cuda):
    from givepose_torch.ops.quant_matmul import qmm_cuda, qmm_pre_cuda

    x, w, b = qmm_inputs(9, 16, 64, 32, cuda)
    wq, ws = quantize_weights(w)
    wt = wq.t().contiguous()
    qmm_cuda.launches = qmm_pre_cuda.launches = 0
    with pytest.raises(RuntimeError, match="CUDA"):       # a CPU tensor
        qmm_cuda(x.cpu(), wt, ws)
    with pytest.raises(TypeError):                          # f16 x
        qmm_cuda(x.half(), wt, ws)
    with pytest.raises(ValueError):                         # (K, N) weights
        qmm_cuda(x, wq, ws)
    with pytest.raises(ValueError):                         # non-contiguous
        qmm_cuda(x.t().contiguous().t(), wt, ws)
    with pytest.raises(TypeError):                          # f32 x as xq
        qmm_pre_cuda(x, torch.ones(16, device=cuda), wt, ws)
    with pytest.raises(ValueError):
        qmm_cuda(x, wt, ws, act="relu")
    assert qmm_cuda.launches == qmm_pre_cuda.launches == 0


@pytest.mark.cuda
def test_quant_dense_layer_on_card(cuda):
    """QuantDense (make_dense(True, ...)) from a bf16 Linear's state dict:
    one int8_qmm launch per call, the plain path's output up to flips, and
    close to the Linear it replaces."""
    from givepose_torch.models.quant import make_dense
    from givepose_torch.ops.quant_matmul import qmm_cuda, quant_dense

    dense = make_dense(False, 512, 2048, torch.bfloat16).to(cuda)
    torch.nn.init.normal_(dense.weight, 0, 512 ** -0.5)
    q = make_dense(True, 512, 2048, torch.bfloat16, act="gelu_tanh")
    q.load_state_dict(dense.state_dict(), strict=True)
    q = q.to(cuda)
    x = torch.randn(2, 16, 16, 512, device=cuda, dtype=torch.bfloat16)
    qmm_cuda.launches = 0
    with torch.inference_mode():
        out = q(x)
        ref = quant_dense(x, q.weight.t(), q.bias, act="gelu_tanh",
                          impl="torch")
        want = torch.nn.functional.gelu(dense(x), approximate="tanh")
    torch.cuda.synchronize()
    assert qmm_cuda.launches == 1
    assert out.shape == (2, 16, 16, 2048) and out.dtype == torch.bfloat16
    d = (out.float() - ref.float()).abs()
    assert d.mean().item() <= 1e-3 * ref.float().abs().mean().item()
    rel = ((out.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < 0.05, rel


@pytest.mark.cuda
def test_operators_launch_their_kernels(cuda):
    """Each torch.ops.givepose operator on CUDA tensors launches its
    kernel once (the wrapper's count goes up by one)."""
    from givepose_torch.ops.dcnv3_cuda import (dcnv3_bwd_cuda, dcnv3_cuda,
                                               dcnv3_win_cuda)
    from givepose_torch.ops.quant_matmul import (qmm_cuda, qmm_pre_cuda,
                                                 quantize_activations)

    ops = torch.ops.givepose
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(1, 10, 10, 128, generator=g, device=cuda)
    off = torch.randn(1, 5, 5, 72, generator=g, device=cuda)
    msk = torch.softmax(torch.randn(1, 5, 5, 4, 9, generator=g, device=cuda),
                        -1).reshape(1, 5, 5, 36)
    go = torch.randn(1, 5, 5, 128, generator=g, device=cuda)
    inp = make_inputs(4, 32, 64, 256, cuda)
    w0q, s0 = quantize_weights(inp["w0"])
    w1q, s1 = quantize_weights(inp["w1"])
    xq, xs = quantize_activations(inp["y"])
    calls = {
        dcnv3_cuda: lambda: ops.dcnv3_fwd(x, off, msk, 3, 2, 1, 1, 4, 1.0),
        dcnv3_win_cuda: lambda: ops.dcnv3_win_fwd(x, off, msk, 3, 2, 1, 1,
                                                  4, 1.0, 4),
        dcnv3_bwd_cuda: lambda: ops.dcnv3_bwd(x, off, msk, go, 3, 2, 1, 1,
                                              4, 1.0, 0),
        mlp_int8_cuda: lambda: ops.int8_mlp(
            inp["y"], inp["residual"], w0q.t().contiguous(), s0, inp["b0"],
            w1q.t().contiguous(), s1, inp["b1"], "gelu_tanh",
            torch.float32, None, None, None, None),
        qmm_cuda: lambda: ops.int8_qmm(inp["y"], w0q.t().contiguous(), s0,
                                       inp["b0"], "none", torch.bfloat16),
        qmm_pre_cuda: lambda: ops.int8_qmm_pre(
            xq, xs.reshape(-1), w0q.t().contiguous(), s0, None, "gelu_tanh",
            torch.float32),
    }
    for wrapper, call in calls.items():
        wrapper.launches = 0
        out = call()
        torch.cuda.synchronize()
        assert wrapper.launches == 1, wrapper.__name__
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.is_cuda and torch.isfinite(o).all() for o in outs)
