"""The fused int8 ConvNeXt MLP kernel against its plain PyTorch version, on
the GPU.

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
# ragged last row tile, and a narrow one
SHAPES = [(200, 512, 2048), (77, 1024, 4096), (48, 64, 256),
          (33, 128, 512)]


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
