"""Learning-rate schedule: linear warmup, flat, then anneal.

Port of ``givepose_tpu/train/schedule.py``, evaluated in float32 as the
JAX package does (its step is an f32 array and its Python constants are
weakly typed, so every operation rounds to f32).
"""

from __future__ import annotations

import math

import torch


def flat_and_anneal(base_lr: float, total_iters: int,
                    warmup_iters: int = 100,
                    warmup_factor: float = 1e-3,
                    warmup_method: str = "linear",
                    anneal_point: float = 0.72,
                    anneal_method: str = "cosine",
                    target_lr_factor: float = 0.0,
                    poly_power: float = 0.9):
    """Returns ``schedule(step) -> lr``, a 0-d float32 CPU tensor:
    warmup from ``warmup_factor``, flat, then anneal from
    ``anneal_point * total_iters`` (cosine by default)."""
    if warmup_method not in ("linear", "constant"):
        raise ValueError(warmup_method)
    if anneal_method not in ("cosine", "linear", "poly", "exp", "none"):
        raise ValueError(anneal_method)
    anneal_start = anneal_point * total_iters

    def schedule(step) -> torch.Tensor:
        x = torch.as_tensor(step, dtype=torch.float32)
        if warmup_method == "linear":
            alpha = x / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha
        else:
            wf = torch.full_like(x, warmup_factor)

        denom = max(total_iters - anneal_start, 1.0)
        progress = (x - anneal_start) / denom
        if anneal_method == "cosine":
            af = target_lr_factor + 0.5 * (1 - target_lr_factor) * (
                1 + torch.cos(math.pi * progress))
        elif anneal_method == "linear":
            af = target_lr_factor + (1 - target_lr_factor) * (1 - progress)
        elif anneal_method == "poly":
            af = (target_lr_factor
                  + (1 - target_lr_factor) * (1 - progress) ** poly_power)
        elif anneal_method == "exp":
            af = max(target_lr_factor, 5e-3) ** progress
        else:
            af = torch.ones_like(x)

        factor = torch.where(x < warmup_iters, wf,
                             torch.where(x >= anneal_start, af,
                                         torch.ones_like(x)))
        return base_lr * factor

    return schedule
