"""Pose error metrics, batched (PyTorch).

Port of ``givepose_tpu/geometry/errors.py`` (reference
network/pose_utils/pose_error.py re/te, losses/pose_loss.py:451-466).
"""

from __future__ import annotations

import torch

from givepose_torch.geometry.allo_ego import matmul3_f32


def rotation_error_deg(R_est: torch.Tensor, R_gt: torch.Tensor
                       ) -> torch.Tensor:
    """Geodesic rotation error in degrees, (..., 3, 3) -> (...).

    The trace is clamped into the arccos domain as the reference does
    (trace <= 3, cos in [-1, 1]); the product is a sum of f32 products,
    so TF32 cannot round it."""
    diff = matmul3_f32(R_est, R_gt.transpose(-1, -2))
    trace = torch.diagonal(diff, dim1=-2, dim2=-1).sum(-1)
    trace = torch.minimum(trace, trace.new_tensor(3.0))
    cos = 0.5 * (trace - 1.0)
    cos = torch.maximum(torch.minimum(cos, cos.new_tensor(1.0)),
                        cos.new_tensor(-1.0))
    return torch.rad2deg(torch.arccos(cos))


def translation_error(t_est: torch.Tensor, t_gt: torch.Tensor
                      ) -> torch.Tensor:
    """L2 translation error (reference pose_error.py te)."""
    return torch.linalg.vector_norm(t_est - t_gt, dim=-1)
