"""Similarity-transform estimation (Umeyama) with RANSAC, batched (PyTorch).

Port of ``givepose_tpu/geometry/umeyama.py`` (reference
tools/align_utils.py:10-125).  ``umeyama_similarity`` is the weighted fit:
an inlier mask enters as per-point weights, so a refit on any subset keeps
the shapes.  ``ransac_umeyama`` scores every hypothesis at once and refits
on the best one's inliers.

The draw is split from the fit, as ``jax.random`` cannot be reproduced in
torch: ``draw_hypotheses`` picks each hypothesis' points by Gumbel top-k
over the valid points from an explicit ``torch.Generator`` on the tensors'
device, and ``ransac_umeyama`` takes those ``(..., 128, 5)`` indices (or
draws them).  Given JAX's indices, the fit equals JAX's.

The 3 x 3 products are sums of elementwise f32 products, never a matmul,
so no TF32 setting can round them (the JAX package asks for
``precision="highest"``).  The SVD and determinants are
``torch.linalg``'s.
"""

from __future__ import annotations

import torch

from givepose_torch.geometry.allo_ego import matmul3_f32


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) in full f32."""
    return (m * v[..., None, :]).sum(-1)


def umeyama_similarity(source: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       eps: float = 1e-12):
    """Weighted similarity fit target ~ s * R @ source + t.

    Args:
      source: (..., N, 3)
      target: (..., N, 3)
      weights: (..., N) nonnegative; None = uniform.

    Returns:
      (scale (...,), rotation (..., 3, 3), translation (..., 3)), with the
      reference's convention scale = sum(D) / var(source) and the det-sign
      fix on the last singular value and on U's last column.
    """
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype,
                             device=source.device)
    w = weights / torch.clamp_min(weights.sum(-1, keepdim=True), eps)
    mu_s = (source * w[..., None]).sum(-2, keepdim=True)
    mu_t = (target * w[..., None]).sum(-2, keepdim=True)
    cs = source - mu_s
    ct = target - mu_t
    # covariance of (target, source): (..., 3, 3)
    cov = (ct[..., :, :, None] * cs[..., :, None, :]
           * w[..., None, None]).sum(-3)
    U, D, Vh = torch.linalg.svd(cov, full_matrices=True)
    det = torch.linalg.det(U) * torch.linalg.det(Vh)
    sign = torch.where(det < 0, -1.0, 1.0).to(D.dtype)
    D = torch.cat([D[..., :2], D[..., 2:] * sign[..., None]], -1)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * sign[..., None, None]], -1)
    rotation = matmul3_f32(U, Vh)
    var_s = ((cs * cs).sum(-1) * w).sum(-1)
    scale = D.sum(-1) / torch.clamp_min(var_s, eps)
    translation = (mu_t[..., 0, :]
                   - scale[..., None] * _matvec3(rotation, mu_s[..., 0, :]))
    return scale, rotation, translation


def draw_hypotheses(valid: torch.Tensor,
                    generator: torch.Generator | None = None,
                    num_hypotheses: int = 128,
                    sample_size: int = 5) -> torch.Tensor:
    """(..., N) validity -> (..., num_hypotheses, sample_size) int64 point
    indices, drawn by Gumbel top-k over the valid points.

    Where fewer than ``sample_size`` points are valid a sample also takes
    invalid ones: their logits tie at -1e9 and ``torch.topk`` does not say
    which of them it picks."""
    logits = torch.where(valid > 0, 0.0, -1e9).to(torch.float32)
    shape = (*valid.shape[:-1], num_hypotheses, valid.shape[-1])
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=valid.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return torch.topk(g + logits[..., None, :], sample_size, dim=-1).indices


def ransac_umeyama(source: torch.Tensor, target: torch.Tensor,
                   valid: torch.Tensor | None = None,
                   hypotheses: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   num_hypotheses: int = 128, sample_size: int = 5) -> dict:
    """RANSAC similarity fit, batched over leading dims.

    Args:
      source: (..., N, 3) NOCS-space points.
      target: (..., N, 3) camera-space points.
      valid: optional (..., N) mask of usable correspondences.
      hypotheses: optional (..., H, sample_size) point indices; drawn by
        ``draw_hypotheses`` from ``generator`` when None.

    Returns:
      dict(scale (...,), rotation (..., 3, 3), translation (..., 3),
      inlier_ratio (...,)).

    The inlier threshold is the valid source points' diameter / 10, scaled
    by each hypothesis' scale; the test is strict.  The best ratio wins,
    ties going to the first hypothesis; the refit takes the best
    hypothesis' inliers, or all valid points when fewer than
    ``sample_size`` inliers remain.
    """
    if valid is None:
        valid = torch.ones(source.shape[:-1], dtype=source.dtype,
                           device=source.device)
    valid = valid.to(source.dtype)
    if hypotheses is None:
        hypotheses = draw_hypotheses(valid, generator, num_hypotheses,
                                     sample_size)

    wsum = torch.clamp_min(valid.sum(-1), 1e-6)                  # (...)
    centroid = (source * valid[..., None]).sum(-2) / wsum[..., None]
    radii = torch.linalg.vector_norm(
        (source - centroid[..., None, :]) * valid[..., None], dim=-1)
    inlier_t = 2.0 * radii.amax(-1) / 10.0                       # (...)

    # every hypothesis' fit on its sample: (..., H) scales
    idx = hypotheses.long()[..., None]                           # (...,H,k,1)
    s, rot, t = umeyama_similarity(
        torch.take_along_dim(source[..., None, :, :], idx, dim=-2),
        torch.take_along_dim(target[..., None, :, :], idx, dim=-2))
    # residuals of every point under every hypothesis: (..., H, N)
    x, y, z = (source[..., None, :, c] for c in range(3))
    sq = 0.0
    for r in range(3):
        pred = (rot[..., r, 0, None] * x + rot[..., r, 1, None] * y
                + rot[..., r, 2, None] * z)
        d = target[..., None, :, r] - (s[..., None] * pred + t[..., r, None])
        sq = sq + d * d
    resid = torch.sqrt(sq)
    inliers = ((resid < (s * inlier_t[..., None])[..., None]).to(source.dtype)
               * valid[..., None, :])
    ratios = inliers.sum(-1) / wsum[..., None]                   # (..., H)
    best = torch.argmax(ratios, dim=-1, keepdim=True)            # first max
    best_inliers = torch.take_along_dim(inliers, best[..., None],
                                        dim=-2)[..., 0, :]
    use_all = best_inliers.sum(-1) < sample_size
    fit_w = torch.where(use_all[..., None], valid, best_inliers)
    scale, rotation, translation = umeyama_similarity(source, target, fit_w)
    return {
        "scale": scale,
        "rotation": rotation,
        "translation": translation,
        "inlier_ratio": torch.take_along_dim(ratios, best, dim=-1)[..., 0],
    }


def backproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor,
                      mask: torch.Tensor):
    """Back-project a depth map to camera-space points, every pixel, with
    a mask of the usable ones (depth > 0 and mask > 0).

    Returns (points (H*W, 3), valid (H*W,)).
    """
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    z = depth
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fy
    pts = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1).reshape(-1, 3)
    valid = ((depth > 0) & (mask > 0)).reshape(-1).to(depth.dtype)
    return pts, valid
