"""Depth-assisted Umeyama pose recovery (the ``eval.use_umeyama`` path).

Port of ``givepose_tpu/eval/umeyama_pose.py`` (reference
tools/umeyama.py:17-60, ``pose_from_umeyama``): backproject the roi depth
crop through K at the absolute pixels of the predicted NOCS map and fit a
similarity transform NOCS -> camera with RANSAC.  The reference loops
over instances in numpy; here every instance of the batch is one call of
``geometry.ransac_umeyama`` on the batch's device.
"""

from __future__ import annotations

import torch

from givepose_torch.geometry.umeyama import ransac_umeyama


def umeyama_pose_from_maps(nocs_coor: torch.Tensor, pixel_x: torch.Tensor,
                           pixel_y: torch.Tensor, depth: torch.Tensor,
                           mask: torch.Tensor, cam_k: torch.Tensor,
                           hypotheses: torch.Tensor | None = None,
                           generator: torch.Generator | None = None
                           ) -> dict:
    """Batched NOCS -> depth similarity fit.

    Args:
      nocs_coor: (B, R, R, 3) predicted NOCS map.
      pixel_x/pixel_y: (B, R, R) absolute source-image pixel coordinates
        of each output cell (the un-normalized roi_coord_2d).
      depth: (B, R, R) metric depth crop (0 = invalid).
      mask: (B, R, R) object mask.
      cam_k: (B, 3, 3).
      hypotheses: optional (B, 128, 5) point indices into the R * R cells;
        drawn from ``generator`` when None.

    Returns dict(scale (B,), rotation (B,3,3), translation (B,3),
    inlier_ratio (B,)).
    """
    b, r = nocs_coor.shape[0], nocs_coor.shape[1]
    n = r * r
    fx = cam_k[:, 0, 0][:, None]
    fy = cam_k[:, 1, 1][:, None]
    ux = cam_k[:, 0, 2][:, None]
    uy = cam_k[:, 1, 2][:, None]
    d = depth.reshape(b, n)
    px = pixel_x.reshape(b, n)
    py = pixel_y.reshape(b, n)
    pc = torch.stack([(px - ux) * d / fx, (py - uy) * d / fy, d], dim=-1)
    src = nocs_coor.reshape(b, n, 3)
    valid = ((mask.reshape(b, n) > 0) & (d > 0)).to(torch.float32)
    return ransac_umeyama(src, pc, valid, hypotheses, generator)
