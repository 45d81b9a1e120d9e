"""Prediction heads (PyTorch, NHWC): TopDownXyzHead, MAPEncoder,
ConvPnPNet, SizeHead.

Port of ``givepose_tpu/models/heads.py``.  The f32 islands of the JAX
package stay f32: the xyz head's output, ConvPnPNet's ``fc_r``/``fc_t``/
``fc_z`` and SizeHead's ``bn1``/``conv2``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from givepose_torch.models.dcnv3_module import DCNv3Conv
from givepose_torch.models.layers import (
    Conv2d,
    ConvModule,
    DeconvModule,
    GroupNorm32,
    Linear,
    check_no_drop,
    get_act,
    out_size,
    upsample_2x,
)


class TopDownXyzHead(nn.Module):
    """stride-32 feature -> (coor_x, coor_y, coor_z) planes at 8x the
    input resolution, each (B, H, W, 1) f32."""

    def __init__(self, in_dim: int, feat_dim: int = 256,
                 up_types: Sequence[str] = ("deconv", "bilinear", "bilinear"),
                 num_conv_per_block: int = 2, act: str = "gelu",
                 out_dim: int = 3, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        self.up_types = tuple(up_types)
        self.num_conv_per_block = num_conv_per_block
        self.deconvs = nn.ModuleList()
        self.convs = nn.ModuleList()
        c = in_dim
        for up in self.up_types:
            if up == "deconv":
                self.deconvs.append(DeconvModule(c, feat_dim, act=act,
                                                 compute_dtype=cd))
                c = feat_dim
            elif up not in ("bilinear", "nearest"):
                raise ValueError(f"unknown up_type {up}")
            for _ in range(num_conv_per_block):
                self.convs.append(ConvModule(c, feat_dim, 3, act=act,
                                             compute_dtype=cd))
                c = feat_dim
        self.out_layer = Conv2d(c, out_dim, 1, compute_dtype=cd,
                                init_std=0.01)

    def forward(self, x: torch.Tensor):
        y = x
        deconvs, convs = iter(self.deconvs), iter(self.convs)
        for up in self.up_types:
            y = next(deconvs)(y) if up == "deconv" else upsample_2x(y, up)
            for _ in range(self.num_conv_per_block):
                y = next(convs)(y)
        out = self.out_layer(y).float()
        return out[..., 0:1], out[..., 1:2], out[..., 2:3]


class MAPEncoder(nn.Module):
    """Dense-coordinate-map encoder: stride-2 DCNv3 (or conv) blocks, each
    followed by GroupNorm32 and the activation."""

    def __init__(self, in_dim: int = 3, featdim: int = 256, outdim: int = 256,
                 num_stride2_layers: int = 3, use_dcn: str = "dcnv3",
                 dcn_impl: str = "auto", dcn_window: int = 0,
                 gelu_exact: bool = False, act: str = "relu",
                 drop_prob: float = 0.0, dropblock_size: int = 5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_no_drop(drop_prob, "MAPEncoder")
        cd = compute_dtype
        self.layers = nn.ModuleList()
        self.norms = nn.ModuleList()
        c = in_dim
        for i in range(num_stride2_layers):
            features = outdim if i == num_stride2_layers - 1 else featdim
            if use_dcn == "dcnv3":
                self.layers.append(DCNv3Conv(c, features, stride=2,
                                             impl=dcn_impl,
                                             gelu_exact=gelu_exact,
                                             window=dcn_window,
                                             compute_dtype=cd))
            else:
                self.layers.append(Conv2d(c, features, 3, 2, padding=1,
                                          bias=False, compute_dtype=cd,
                                          init_std=0.001))
            self.norms.append(GroupNorm32(features, compute_dtype=cd))
            c = features
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer, norm in zip(self.layers, self.norms):
            y = self.act(norm(layer(y)))
        return y


class ConvPnPNet(nn.Module):
    """(IVFC xyz + 2D coords) maps -> rot (B, rot_dim) and (cx, cy, z)."""

    def __init__(self, in_dim: int, in_hw: int, featdim: int = 128,
                 rot_dim: int = 6, num_stride2_layers: int = 3,
                 mask_attention_type: str = "none", flat_op: str = "flatten",
                 act: str = "relu", drop_prob: float = 0.0,
                 dropblock_size: int = 5, mask_channels: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_no_drop(drop_prob, "ConvPnPNet")
        if mask_attention_type not in ("none", "mul", "concat"):
            raise ValueError(mask_attention_type)
        cd = compute_dtype
        self.mask_attention_type = mask_attention_type
        self.flat_op = flat_op
        self.compute_dtype = cd
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        c = in_dim + (mask_channels if mask_attention_type == "concat" else 0)
        for _ in range(num_stride2_layers):
            self.convs.append(Conv2d(c, featdim, 3, 2, padding=1, bias=False,
                                     compute_dtype=cd, init_std=0.001))
            self.norms.append(GroupNorm32(featdim, compute_dtype=cd))
            c = featdim
        hw = out_size(in_hw, num_stride2_layers)
        flat_dim = {"flatten": c * hw * hw, "avg": c, "avg-max": 2 * c,
                    "avg-max-min": 3 * c}.get(flat_op)
        if flat_dim is None:
            raise ValueError(f"Invalid flat_op: {flat_op}")
        self.act = get_act(act)
        self.fc1 = Linear(flat_dim, 1024, compute_dtype=cd, init_std=0.001)
        self.fc2 = Linear(1024, 256, compute_dtype=cd, init_std=0.001)
        self.fc_r = Linear(256, rot_dim, init_std=0.01)
        self.fc_t = Linear(256, 2, init_std=0.01)
        self.fc1_z = Linear(flat_dim, 1024, compute_dtype=cd, init_std=0.001)
        self.fc2_z = Linear(1024, 256, compute_dtype=cd, init_std=0.001)
        self.fc_z = Linear(256, 1, init_std=0.001)

    def forward(self, coor_feat: torch.Tensor,
                mask_attention: torch.Tensor | None = None):
        x = coor_feat
        if self.mask_attention_type == "mul":
            x = x * mask_attention
        elif self.mask_attention_type == "concat":
            x = torch.cat([x, mask_attention], dim=-1)
        x = x.to(self.compute_dtype)
        for conv, norm in zip(self.convs, self.norms):
            x = self.act(norm(conv(x)))
        pnp_feat = x
        b, c = x.shape[0], x.shape[-1]
        flat = x.reshape(b, -1, c)                      # (B, HW, C)
        if self.flat_op == "flatten":
            # channel-major, as the JAX package (and NCHW .flatten(1))
            flat = flat.transpose(1, 2).reshape(b, -1)
        elif self.flat_op == "avg":
            flat = flat.mean(1)
        elif self.flat_op == "avg-max":
            flat = torch.cat([flat.mean(1), flat.amax(1)], dim=-1)
        else:
            flat = torch.cat([flat.mean(1), flat.amax(1), flat.amin(1)],
                             dim=-1)

        def lrelu(v):
            return F.leaky_relu(v, negative_slope=0.1)

        h = lrelu(self.fc2(lrelu(self.fc1(flat))))
        rot = self.fc_r(h.float())
        t2d = self.fc_t(h.float())
        hz = lrelu(self.fc2_z(lrelu(self.fc1_z(flat))))
        z = self.fc_z(hz.float())
        return rot, torch.cat([t2d, z], dim=-1), pnp_feat


def dropout_keep_mask(shape, keep_prob: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """Boolean keep mask of ``shape``, each entry kept with ``keep_prob``,
    drawn from ``generator`` (which must live on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


class SizeHead(nn.Module):
    """Global max-pool -> Dense -> BN (f32) -> ReLU -> Dropout 0.2 ->
    Dense (f32).

    In train mode BN normalises with the batch mean and the biased
    two-pass variance and moves its running statistics by
    ``ra = 0.9·ra + 0.1·batch`` (flax's update, biased variance: not
    ``F.batch_norm``'s, which keeps the unbiased one), and dropout keeps
    each value with probability 0.8 (mask from ``generator``, kept values
    scaled by 1/0.8)."""

    MOMENTUM = 0.9
    DROP_RATE = 0.2

    def __init__(self, in_dim: int, feat_dim: int = 128, out_dim: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Linear(in_dim, feat_dim, compute_dtype=compute_dtype,
                            init_std=0.001)
        self.bn1 = nn.BatchNorm1d(feat_dim, eps=1e-5)
        self.conv2 = Linear(feat_dim, out_dim, init_std=0.001)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = x.reshape(x.shape[0], -1, x.shape[-1]).amax(dim=1)
        y = self.conv1(y).float()
        bn = self.bn1
        if train:
            mean = y.mean(0)
            var = ((y - mean) ** 2).mean(0)
            with torch.no_grad():
                m = self.MOMENTUM
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        y = (y - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        y = F.relu(y)
        if train:
            keep_prob = 1.0 - self.DROP_RATE
            keep = dropout_keep_mask(y.shape, keep_prob, generator, y.device)
            y = torch.where(keep, y / keep_prob, torch.zeros_like(y))
        return self.conv2(y)[:, :3]
