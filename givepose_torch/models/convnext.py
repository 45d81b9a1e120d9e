"""ConvNeXt backbone (PyTorch, NHWC).

Port of ``givepose_tpu/models/convnext.py``: 4x4/4 patchify stem + LN,
stages of [depthwise 7x7 -> LN -> 1x1 (4x) -> GELU -> 1x1 -> layer scale]
blocks, LN + 2x2/2 downsample between stages.  Stem and downsample convs
are VALID.  Submodule names follow the flax tree (``stem_conv``,
``downsample_norm{s}``, ``stage{s}_block{b}``) so the weight bridge
(``models/convert_from_flax.py``) maps them one to one.

``quant=True`` is the int8 serving mode: blocks of width >= ``quant_min_dim``
(512: stages 2 and 3 of ConvNeXt-B) run their MLP tail through the fused
int8 kernel (``ops/quant_matmul.py``).  The parameters are the same, so a
trained checkpoint serves as it is.  It is inference-only, as in the JAX
package (rounding has zero gradient): ``PoseNet`` refuses to train it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from givepose_torch.models.layers import Conv2d, LayerNorm, Linear
from givepose_torch.ops.dwconv_ln import dwconv_ln
from givepose_torch.ops.quant_matmul import convnext_mlp_int8


class ConvNeXtBlock(nn.Module):
    """``impl`` (quant blocks only): auto (int8 kernel on CUDA tensors,
    plain version on CPU), cuda, or torch."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 gelu_exact: bool = False, quant: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quant = quant
        self.impl = "auto"
        cd = compute_dtype
        # parameter holders for dwconv_ln: (C,1,7,7) kernel + bias, LN affine
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim,
                             compute_dtype=cd)
        self.norm = LayerNorm(dim, eps=1e-6, compute_dtype=cd)
        self.fc1 = Linear(dim, 4 * dim, compute_dtype=cd)
        self.fc2 = Linear(4 * dim, dim, compute_dtype=cd)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.layer_scale_init = layer_scale_init
        self.gelu = "none" if gelu_exact else "tanh"
        self.compute_dtype = cd

    def reset_extra_parameters_(self) -> None:
        self.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self._forward_quant(x)
        y = dwconv_ln(x, self.dwconv.weight, self.dwconv.bias,
                      self.norm.weight, self.norm.bias, self.norm.eps)
        y = F.gelu(self.fc1(y), approximate=self.gelu)
        y = self.fc2(y)
        return x + y * self.gamma.to(self.compute_dtype)

    def _forward_quant(self, x: torch.Tensor) -> torch.Tensor:
        """As the JAX quant branch: the depthwise conv of the compute-dtype
        operands summed in f32 (here on their f32 upcast; TF32 must be off)
        plus the f32 bias, its LN statistics in f32, and the raw map in
        the compute dtype into the int8 MLP, whose prologue normalises it;
        residual and layer scale are applied in f32 inside."""
        c = x.shape[-1]
        w = self.dwconv.weight.to(x.dtype).float()
        yc = F.conv2d(x.float().permute(0, 3, 1, 2), w, None, 1, 3, 1,
                      c).permute(0, 2, 3, 1) + self.dwconv.bias
        mu = yc.mean(-1, keepdim=True)
        d = yc - mu
        rsig = torch.rsqrt((d * d).mean(-1, keepdim=True) + self.norm.eps)
        act = "gelu_tanh" if self.gelu == "tanh" else "gelu_exact"
        return convnext_mlp_int8(
            yc.to(self.compute_dtype), x, self.fc1.weight.t(), self.fc1.bias,
            self.fc2.weight.t(), self.fc2.bias, self.gamma, act=act,
            out_dtype=self.compute_dtype,
            ln=(mu, rsig, self.norm.weight, self.norm.bias), impl=self.impl)


class ConvNeXt(nn.Module):
    """Features-only ConvNeXt returning the stride-32 stage-3 map, NHWC."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 in_chans: int = 3, gelu_exact: bool = False,
                 quant: bool = False, quant_min_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.compute_dtype = cd
        self.stem_conv = Conv2d(in_chans, dims[0], 4, stride=4,
                                compute_dtype=cd)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6, compute_dtype=cd)
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                self.add_module(f"downsample_norm{stage}",
                                LayerNorm(dims[stage - 1], eps=1e-6,
                                          compute_dtype=cd))
                self.add_module(f"downsample_conv{stage}",
                                Conv2d(dims[stage - 1], dim, 2, stride=2,
                                       compute_dtype=cd))
            for blk in range(depth):
                # int8 pays only where K is deep (the JAX package's v5e
                # sweep); narrow early stages stay in the compute dtype
                self.add_module(f"stage{stage}_block{blk}",
                                ConvNeXtBlock(dim, gelu_exact=gelu_exact,
                                              quant=quant
                                              and dim >= quant_min_dim,
                                              compute_dtype=cd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem_norm(self.stem_conv(x.to(self.compute_dtype)))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                y = getattr(self, f"downsample_norm{stage}")(y)
                y = getattr(self, f"downsample_conv{stage}")(y)
            for blk in range(depth):
                y = getattr(self, f"stage{stage}_block{blk}")(y)
        return y


def convnext_base(compute_dtype: torch.dtype = torch.float32,
                  gelu_exact: bool = False, quant: bool = False) -> ConvNeXt:
    """convnext_base: depths 3/3/27/3, dims 128..1024."""
    return ConvNeXt((3, 3, 27, 3), (128, 256, 512, 1024),
                    gelu_exact=gelu_exact, quant=quant,
                    compute_dtype=compute_dtype)


def convnext_tiny(compute_dtype: torch.dtype = torch.float32,
                  gelu_exact: bool = False, quant: bool = False) -> ConvNeXt:
    """Smaller variant for tests: depths 3/3/9/3, dims 96..768."""
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768),
                    gelu_exact=gelu_exact, quant=quant,
                    compute_dtype=compute_dtype)
