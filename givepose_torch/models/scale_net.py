"""Metric-scale regressor (PyTorch, NHWC at the boundary).

Port of ``givepose_tpu/models/scale_net.py``: two MobileNetV3-Small
towers over the roi crop (``feat_encoder_bbox``) and the resized full
image (``feat_encoder_full``), each feature through dropout 0.2, then
``line1`` (128) -> ReLU -> [one-hot] -> ``line2`` (``feat_dim``) -> ReLU ->
[one-hot, roi (w, h) / 100] -> ``line3``, a scalar residual over
``||mean_size||``.  f32 end to end.

A full image of batch 1 beside a batch of instances (the eval loader's
layout, one shared ``full_img[None]``) runs its tower once and is
broadcast over the instances.  In train mode the towers' BatchNorms take
batch statistics, and the dropout masks are drawn from the caller's
``generator`` (the roi feature's first, then the full image's).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from givepose_torch.models.heads import dropout_keep_mask
from givepose_torch.models.layers import Linear, init_weights_
from givepose_torch.models.mobilenet import MobileNetV3Small


class ScaleNet(nn.Module):
    DROP_RATE = 0.2
    FEATURES = 576

    def __init__(self, feat_dim: int = 24, use_hw: bool = True,
                 cats_num: int = 6):
        super().__init__()
        self.use_hw = use_hw
        self.feat_encoder_bbox = MobileNetV3Small()
        self.feat_encoder_full = MobileNetV3Small()
        self.line1 = Linear(2 * self.FEATURES, 128)
        self.line2 = Linear(128 + cats_num, feat_dim)
        self.line3 = Linear(feat_dim + cats_num + (2 if use_hw else 0), 1)

    def _dropout(self, x: torch.Tensor, generator) -> torch.Tensor:
        keep_prob = 1.0 - self.DROP_RATE
        keep = dropout_keep_mask(x.shape, keep_prob, generator, x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(self, batch: dict, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if train and generator is None:
            raise ValueError("train=True needs a torch.Generator on the "
                             "model's device for the dropout masks")
        roi = batch["roi_img"]
        full = batch["full_img"]
        one_hot = batch["one_hot"].float()

        feat_roi = self.feat_encoder_bbox(roi, train)
        feat_full = self.feat_encoder_full(full, train)
        if full.shape[0] == 1 and roi.shape[0] != 1:
            feat_full = feat_full.expand(roi.shape[0], -1)
        if train:
            feat_roi = self._dropout(feat_roi, generator)
            feat_full = self._dropout(feat_full, generator)
        feat = torch.cat([feat_roi, feat_full], dim=-1).float()

        x = F.relu(self.line1(feat))
        x = torch.cat([x, one_hot], dim=-1)
        x = F.relu(self.line2(x))
        x = torch.cat([x, one_hot], dim=-1)
        if self.use_hw:
            hw = batch["roi_wh"].float() / 100.0
            x = torch.cat([x, hw], dim=-1)
        resid = self.line3(x)[:, 0]
        mean_scale = torch.linalg.vector_norm(batch["mean_size"].float(),
                                              dim=1)
        return resid + mean_scale


def build_scalenet(feat_dim: int = 24, use_hw: bool = True, device=None,
                   seed: int = 1, state_dict: dict | None = None
                   ) -> ScaleNet:
    """ScaleNet in eval mode on ``device`` (default: the GPU).

    Weights come from ``state_dict`` (for example
    ``models.convert_from_flax.flax_to_state_dict`` of the JAX ScaleNet's
    variables) or, without one, from a seeded random init that follows
    flax's initialisers (lecun normal kernels, zero biases, unit
    BatchNorm scales).

    Turns TF32 off for cuBLAS and cuDNN (process-wide), as
    ``eval.serving.build_posenet`` does: ScaleNet is f32 end to end, and
    cuDNN's convolutions default to TF32 on this card.
    """
    from givepose_torch.eval.serving import resolve_device

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ScaleNet(feat_dim, use_hw)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
