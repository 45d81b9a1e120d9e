"""MobileNetV3-Small feature extractor (PyTorch, NHWC at the boundary).

Port of ``givepose_tpu/models/mobilenet.py``: hard-swish stem,
inverted-residual bottlenecks with squeeze-excitation, the 576-channel
head conv, and the mean over H and W (``(B, 576)`` out).  f32 throughout.

BatchNorm is flax's ``BatchNorm(momentum=0.99, epsilon=1e-3,
use_fast_variance=False)``: in train mode it normalises with the batch
mean and the two-pass *biased* variance and moves its running statistics
by ``ra = 0.99·ra + 0.01·batch``, the variance included.
``torch.nn.BatchNorm2d`` would move ``running_var`` by the unbiased
variance, so ``FlaxBatchNorm2d`` keeps its parameters and buffers (the
``state_dict`` keys of ``nn.BatchNorm2d``) and computes itself.

Submodule names follow flax's auto-names inside ``Bneck`` (``convs.i`` is
``Conv_i``, ``bns.i`` is ``BatchNorm_i``; a block without expansion has
no ``Conv_0`` of its own, so its depthwise conv is ``Conv_0``), which
keeps the weight bridge a list of renames.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from givepose_torch.models.layers import Conv2d, Linear


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``x * (relu6(x + 3) / 6)``, rounded in the JAX package's order
    (``F.hardswish`` multiplies before it divides)."""
    return x * hard_sigmoid(x)


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over N, H, W of an NHWC tensor with flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 (or in x's
    dtype if wider); in train mode the batch's mean and biased two-pass
    variance, and the running statistics moved by ``m·ra + (1 - m)·batch``
    (``m`` = ``MOMENTUM``)."""

    MOMENTUM = 0.99

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean(dim=(0, 1, 2))
            d = xf - mean
            var = (d * d).mean(dim=(0, 1, 2))
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        hidden = _make_divisible(channels // reduction)
        self.fc1 = Linear(channels, hidden)
        self.fc2 = Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(x.mean(dim=(1, 2))))
        return x * hard_sigmoid(self.fc2(h))[:, None, None, :]


class Bneck(nn.Module):
    """Inverted residual: [1x1 expand, BN, act] -> kxk depthwise (stride),
    BN, act -> [SE] -> 1x1 project, BN -> [+ x]."""

    def __init__(self, cin: int, kernel: int, exp: int, out: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.act = F.relu if act == "RE" else hard_swish
        self.expand = exp != cin
        self.residual = stride == 1 and cin == out
        convs = []
        if self.expand:
            convs.append(Conv2d(cin, exp, 1, bias=False))
        convs.append(Conv2d(exp, exp, kernel, stride, padding=kernel // 2,
                            groups=exp, bias=False))
        convs.append(Conv2d(exp, out, 1, bias=False))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(FlaxBatchNorm2d(c.out_channels)
                                 for c in convs)
        self.se = SqueezeExcite(exp) if use_se else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        layers = list(zip(self.convs, self.bns))
        if self.expand:
            conv, bn = layers.pop(0)
            h = self.act(bn(conv(h), train))
        conv, bn = layers.pop(0)
        h = self.act(bn(conv(h), train))
        if self.se is not None:
            h = self.se(h)
        conv, bn = layers.pop(0)
        h = bn(conv(h), train)
        if self.residual:
            h = h + x
        return h


# (kernel, exp, out, SE, act, stride) — mobilenet_v3_small spec
_SMALL_SPEC = [
    (3, 16, 16, True, "RE", 2),
    (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1),
    (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1),
    (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1),
    (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2),
    (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


class MobileNetV3Small(nn.Module):
    """NHWC image -> the pooled 576-d feature (mean over the head conv)."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2d(3, 16, 3, 2, padding=1, bias=False)
        self.stem_bn = FlaxBatchNorm2d(16)
        cin = 16
        for i, spec in enumerate(_SMALL_SPEC):
            setattr(self, f"bneck{i}", Bneck(cin, *spec))
            cin = spec[2]
        self.head = Conv2d(cin, 576, 1, bias=False)
        self.head_bn = FlaxBatchNorm2d(576)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = hard_swish(self.stem_bn(self.stem(x), train))
        for i in range(len(_SMALL_SPEC)):
            h = getattr(self, f"bneck{i}")(h, train)
        h = hard_swish(self.head_bn(self.head(h), train))
        return h.mean(dim=(1, 2))
