"""DCNv3 modules (PyTorch, NHWC).

Port of ``givepose_tpu/models/dcnv3_module.py``: ``DCNv3`` (input_proj,
depthwise-conv offset/mask branch, sampling core, output_proj) and
``DCNv3Conv`` (1x1 projection conv then DCNv3), the MAPEncoder layer.

As in the JAX package, offset and mask are computed at the strided output
positions by a strided depthwise conv (an intended departure from the
original PyTorch code, which aliases full-resolution maps), and the
offset/mask projections start at zero.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from givepose_torch.core.config import DCN_IMPLS
from givepose_torch.models.layers import Conv2d, LayerNorm, Linear
from givepose_torch.ops.dcnv3_cuda import dcnv3


class DCNv3(nn.Module):
    """Deformable block, NHWC in at (H, W), out at (H_out, W_out).

    ``impl``: auto (CUDA kernel on CUDA tensors, plain version on CPU),
    cuda, or torch.  ``window`` > 0 clamps sampling to +-window px (the
    windowed kernel on CUDA tensors).
    """

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 pad: int = 1, dilation: int = 1, group: int = 4,
                 offset_scale: float = 1.0, impl: str = "auto",
                 gelu_exact: bool = False, window: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if impl not in DCN_IMPLS:
            raise ValueError(f"unknown dcn_impl {impl!r}")
        cd = compute_dtype
        p = kernel_size * kernel_size
        self.channels = channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.pad = pad
        self.dilation = dilation
        self.group = group
        self.offset_scale = offset_scale
        self.impl = impl
        self.window = window
        self.gelu = "none" if gelu_exact else "tanh"
        self.compute_dtype = cd
        self.input_proj = Linear(channels, channels, compute_dtype=cd)
        self.dw_conv = Conv2d(channels, channels, kernel_size, stride,
                              padding=kernel_size // 2, groups=channels,
                              compute_dtype=cd)
        self.dw_norm = LayerNorm(channels, eps=1e-6, compute_dtype=cd)
        self.offset = Linear(channels, group * p * 2, compute_dtype=cd,
                             init_std=0)
        self.mask = Linear(channels, group * p, compute_dtype=cd, init_std=0)
        self.output_proj = Linear(channels, channels, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        p = self.kernel_size * self.kernel_size
        x_proj = self.input_proj(x)
        x1 = F.gelu(self.dw_norm(self.dw_conv(x)), approximate=self.gelu)
        offset = self.offset(x1)
        mask_logits = self.mask(x1)
        nh, nw = mask_logits.shape[1:3]
        # softmax in f32, rounded to the compute dtype as in the JAX module
        mask = torch.softmax(
            mask_logits.reshape(n, nh, nw, self.group, p).float(), dim=-1
        ).reshape(n, nh, nw, self.group * p).to(self.compute_dtype)
        # the kernel takes x_proj in the compute dtype (bf16 halves its
        # read); the plain version upcasts it to f32 itself
        y = dcnv3(x_proj, offset.float(), mask.float(),
                  kernel=self.kernel_size, stride=self.stride, pad=self.pad,
                  dilation=self.dilation, group=self.group,
                  offset_scale=self.offset_scale, window=self.window,
                  impl=self.impl)
        return self.output_proj(y.to(self.compute_dtype))


class DCNv3Conv(nn.Module):
    """1x1 projection conv then DCNv3 (reference DCNv3_C)."""

    def __init__(self, in_dim: int, features: int, stride: int = 1,
                 group: int = 4, impl: str = "auto", gelu_exact: bool = False,
                 window: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_dim, features, 1, compute_dtype=compute_dtype)
        self.dcnv3 = DCNv3(features, stride=stride, group=group, impl=impl,
                           gelu_exact=gelu_exact, window=window,
                           compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dcnv3(self.proj(x))
