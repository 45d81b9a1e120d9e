"""Data augmentation on the batch's device, its random draws on the host.

Port of ``givepose_tpu/data/augment.py``.  Color jitter reproduces the
reference's default 'new' imgaug pipeline
(datasets/load_data_nocs.py:559-574): a random-order composition of
PIL-style enhancement ops, each applied with its own probability:

    Sometimes(0.3, EnhanceSharpness(factor 0..2))
    Sometimes(0.5, EnhanceContrast(factor 0.5..1.5))
    Sometimes(0.5, EnhanceBrightness(factor 0.5..1.5))
    Sometimes(0.3, EnhanceColor(factor 0..3))

PIL semantics (Pillow's ImageEnhance):
  sharpness:  blend with a 3x3 smooth kernel ([1,1,1;1,5,1;1,1,1]/13),
              the border pixels kept
  contrast:   blend with the mean of the grayscale image
  brightness: blend with black
  color:      blend with the grayscale image
  blend(a, b, f) = b + f * (a - b);  grayscale = ITU-R 601-2 luma.

The order of the four ops is drawn per sample.  Mask deformation matches
defor_2D (datasets/data_augmentation.py:11-33).

Each function is split in two: ``*_draws(generator, ...)`` makes every
random value on a CPU ``torch.Generator``, and the function itself applies
given draws deterministically.  torch cannot reproduce ``jax.random``'s
stream; with the split, tests feed the JAX package's own draws to the
port.  Since the draws are on the host, the colour ops run only on the
samples that take them (no host synchronisation).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LUMA = (0.299, 0.587, 0.114)
# (probability, factor range) of sharpness, contrast, brightness, color
COLOR_OPS = ((0.3, (0.0, 2.0)), (0.5, (0.5, 1.5)), (0.5, (0.5, 1.5)),
             (0.3, (0.0, 3.0)))


def _uniform(generator, shape, lo=0.0, hi=1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator)


def _blend(a, b, factor):
    return b + factor * (a - b)


def _gray(img):
    luma = torch.tensor(LUMA, dtype=img.dtype, device=img.device)
    return (img * luma).sum(-1)


def _sharpness(img, factor):
    b, h, w, c = img.shape
    kernel = torch.tensor([[1.0, 1, 1], [1, 5, 1], [1, 1, 1]],
                          dtype=img.dtype, device=img.device) / 13.0
    planes = img.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    smooth = F.conv2d(planes, kernel[None, None], padding=1)
    smooth = smooth.reshape(b, c, h, w).permute(0, 2, 3, 1)
    out = _blend(img, smooth, factor).clone()
    # PIL keeps the border pixels unchanged
    out[:, 0], out[:, -1] = img[:, 0], img[:, -1]
    out[:, :, 0], out[:, :, -1] = img[:, :, 0], img[:, :, -1]
    return out


def _contrast(img, factor):
    mean = _gray(img).mean(dim=(1, 2))[:, None, None, None]
    return _blend(img, mean, factor)


def _brightness(img, factor):
    return img * factor


def _color(img, factor):
    return _blend(img, _gray(img)[..., None], factor)


_OP_FNS = (_sharpness, _contrast, _brightness, _color)


def color_augment_draws(generator: torch.Generator, b: int,
                        prob: float = 0.8) -> dict:
    """Host draws of ``color_augment`` for a batch of ``b``: whether a
    sample is augmented at all, each op's gate and factor, and each
    sample's order of the four ops (a permutation per row)."""
    apply_any = _uniform(generator, (b,)) < prob
    gates, factors = [], []
    for p, (lo, hi) in COLOR_OPS:
        gates.append(_uniform(generator, (b,)) < p)
        factors.append(_uniform(generator, (b,), lo, hi))
    order = torch.argsort(_uniform(generator, (b, 4)), dim=1)
    return {"apply": apply_any, "gate": torch.stack(gates, 1),
            "factor": torch.stack(factors, 1), "order": order}


def color_augment(img: torch.Tensor, draws: dict) -> torch.Tensor:
    """The 'new' colour pipeline on a (B, H, W, 3) f32 [0, 255] batch:
    in each of four slots, every sample whose slot holds an op it takes
    (its gate, and ``apply``) gets that op; then a clip to [0, 255]."""
    apply_any = np.asarray(draws["apply"], bool)
    gate = np.asarray(draws["gate"], bool)
    order = np.asarray(draws["order"])
    factor = torch.as_tensor(draws["factor"], dtype=img.dtype)
    out = img
    for slot in range(4):
        for op, fn in enumerate(_OP_FNS):
            take = np.flatnonzero(apply_any & gate[:, op]
                                  & (order[:, slot] == op))
            if not len(take):
                continue
            if out is img:
                out = img.clone()
            take = torch.from_numpy(take)
            idx = take.to(img.device)
            f = factor[take, op].to(img.device)[:, None, None, None]
            out[idx] = fn(out[idx], f)
    return out.clamp(0.0, 255.0)


def defor_2d_mask_draws(generator: torch.Generator, shape,
                        prob: float = 0.5) -> dict:
    """Host draws of ``defor_2d_mask`` for masks of ``shape`` (B, H, W):
    which samples are deformed, and a Bernoulli(1/2) fill per pixel."""
    return {"apply": _uniform(generator, (shape[0],)) < prob,
            "fill": _uniform(generator, tuple(shape)) < 0.5}


def defor_2d_mask(mask: torch.Tensor, draws: dict) -> torch.Tensor:
    """Mask boundary noise (reference defor_2D, data_augmentation.py:11-33).

    Erode/dilate with a 2x2 kernel (the reference's iterations argument
    lands in cv2's dst slot, so it is always one iteration); in the band
    where they differ, pixels take the fill (the reference samples an
    exact half without replacement; Bernoulli(1/2) matches in
    distribution per pixel).  cv2's even-kernel anchor reads the window
    (y-1..y, x-1..x): the mask is padded one row and column before, with
    its own edge, so the window looks backward and ignores the outside.

    mask: (B, H, W) in {0, 1}.
    """
    m = F.pad(mask[:, None], (1, 0, 1, 0), mode="replicate")
    dilate = F.max_pool2d(m, 2, stride=1)[:, 0]
    erode = -F.max_pool2d(-m, 2, stride=1)[:, 0]
    fill = torch.as_tensor(draws["fill"], device=mask.device).to(mask.dtype)
    deformed = (torch.where(dilate != erode, fill, mask) > 0).to(mask.dtype)
    active = torch.as_tensor(draws["apply"], device=mask.device)
    return torch.where(active[:, None, None], deformed, mask)
