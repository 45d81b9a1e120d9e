"""Shared building blocks (PyTorch, NHWC at every module boundary).

Port of ``givepose_tpu/models/layers.py``.  Modules take and return NHWC
tensors like the JAX package; a convolution runs on the NCHW view of its
input (``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a
channels-last NCHW tensor, no copy).  Parameters are f32; each module
computes in its ``compute_dtype`` and casts the parameters at the op, as
flax's ``dtype``/``param_dtype`` pair does.  Norms take their statistics
in f32 with two-pass variance and round once at the output.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name; ``gelu`` is the tanh approximation."""
    name = name.lower()
    if name == "relu":
        return F.relu
    if name in ("lrelu", "leaky_relu"):
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu_exact":
        return lambda x: F.gelu(x, approximate="none")
    if name == "silu":
        return F.silu
    if name == "sigmoid":
        return torch.sigmoid
    if name in ("none", "identity"):
        return lambda x: x
    raise ValueError(f"unknown activation: {name}")


class Conv2d(nn.Conv2d):
    """NHWC conv computed in ``compute_dtype`` (flax ``nn.Conv``).

    ``init_std``: normal init with this std (the JAX package's
    ``normal_init``), 0 for zeros, None for flax's lecun normal."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 init_std: float | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        y = self._conv_forward(x.permute(0, 3, 1, 2).to(cd),
                               self.weight.to(cd), bias)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """NHWC transposed conv computed in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 init_std: float | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(cd),
                               self.weight.to(cd), bias, self.stride,
                               self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Linear):
    """Dense layer on the last dim, computed in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 init_std: float | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


def _affine_norm(x: torch.Tensor, dims, weight, bias, eps: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """(x - mu) * (rsqrt(var + eps) * w) + b in f32, two-pass variance."""
    xf = x.float()
    mu = xf.mean(dim=dims, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=dims, keepdim=True)
    return (d * (torch.rsqrt(var + eps) * weight) + bias).to(out_dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim (flax ``nn.LayerNorm``,
    use_fast_variance=False)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _affine_norm(x, (-1,), self.weight, self.bias, self.eps,
                            self.compute_dtype)


class GroupNorm32(nn.Module):
    """GroupNorm with up to 32 groups (the largest count <= 32 dividing C),
    eps 1e-5, NHWC, two-pass f32 statistics."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        groups = min(num_groups, num_channels)
        while num_channels % groups != 0:
            groups -= 1
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        g = self.groups
        xg = x.reshape(n, h * w, g, c // g)
        y = _affine_norm(xg, (1, 3), self.weight.reshape(g, c // g),
                         self.bias.reshape(g, c // g), 1e-5,
                         self.compute_dtype)
        return y.reshape(n, h, w, c)


class ConvModule(nn.Module):
    """conv -> GN -> act (reference ConvModule, norm 'GN')."""

    def __init__(self, in_dim: int, features: int, kernel_size: int = 3,
                 stride: int = 1, act: str = "gelu", use_ws: bool = False,
                 num_gn_groups: int = 32,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_ws:
            raise NotImplementedError(
                "weight-standardised ConvModule (use_ws) is off every "
                "ported path (ROADMAP queue A, item 10)")
        k = kernel_size
        self.conv = Conv2d(in_dim, features, k, stride, padding=k // 2,
                           bias=False, compute_dtype=compute_dtype,
                           init_std=0.001)
        self.norm = GroupNorm32(features, num_gn_groups,
                                compute_dtype=compute_dtype)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class DeconvModule(nn.Module):
    """ConvTranspose(k3, s2, p1, output_padding 1) -> GN -> act; doubles
    H and W."""

    def __init__(self, in_dim: int, features: int, act: str = "gelu",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvTranspose2d(in_dim, features, 3, stride=2, padding=1,
                                    output_padding=1, bias=False,
                                    compute_dtype=compute_dtype,
                                    init_std=0.001)
        self.norm = GroupNorm32(features, compute_dtype=compute_dtype)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


def _interp_matrix(out_n: int, in_n: int, device) -> torch.Tensor:
    """align_corners=True bilinear weights: out[i] samples i*(in-1)/(out-1)."""
    pos = (torch.arange(out_n, dtype=torch.float32, device=device)
           * (in_n - 1) / (out_n - 1))
    i0 = torch.floor(pos)
    frac = pos - i0
    grid = torch.arange(in_n, dtype=torch.float32, device=device)
    w0 = (grid == i0[:, None]).float() * (1 - frac)[:, None]
    w1 = (grid == (i0 + 1)[:, None]).float() * frac[:, None]
    return w0 + w1


def upsample_2x(x: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """2x spatial upsample, NHWC; bilinear uses align_corners=True, as the
    JAX package's separable matrices (rounded to x's dtype)."""
    n, h, w, c = x.shape
    if method == "nearest":
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if method != "bilinear":
        raise ValueError(f"unknown upsample method {method}")
    wy = _interp_matrix(2 * h, h, x.device).to(x.dtype)
    wx = _interp_matrix(2 * w, w, x.device).to(x.dtype)
    y = torch.einsum("oh,nhwc->nowc", wy, x)
    return torch.einsum("pw,nowc->nopc", wx, y)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax lecun_normal: truncated normal (+-2 std) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter as the JAX package's flax init does (in
    distribution; the numbers differ), drawing from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            if m.init_std is None:
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif m.init_std == 0:
                m.weight.zero_()
            else:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (LayerNorm, GroupNorm32, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if hasattr(m, "reset_extra_parameters_"):
            m.reset_extra_parameters_()


def out_size(size: int, num_stride2_layers: int) -> int:
    """Spatial size after ``num_stride2_layers`` 3x3/2 pad-1 convs."""
    for _ in range(num_stride2_layers):
        size = (size - 1) // 2 + 1
    return size


def check_no_drop(drop_prob: float, where: str) -> None:
    if drop_prob > 0:
        raise NotImplementedError(
            f"DropBlock in {where} (drop_prob > 0) is not ported yet "
            "(ROADMAP queue A, item 10)")
