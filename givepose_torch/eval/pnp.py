"""RANSAC-PnP pose from the dense NOCS map and the pixel grid.

Port of ``givepose_tpu/eval/pnp.py`` (reference tools/utils/align.py:31-52
``ransac_pnp``), the depth-free classical baseline beside the learned
centroid-z head.  The JAX package calls ``cv2.solvePnPRansac(...,
reprojectionError=3.0, iterationsCount=100, flags=SOLVEPNP_EPNP)`` per
instance on the host; the card machine has no OpenCV, so the port has its
own solver with OpenCV's method:

  * EPnP (Lepetit et al. 2009, as OpenCV's ``epnp.cpp`` computes it): four
    control points (the centroid and the principal axes scaled by
    sqrt(eigenvalue / n)), each point's barycentric coordinates, the
    2N x 12 system M and the null space of MᵀM (its four eigenvectors of
    least eigenvalue), the N = 1, 2, 3 approximations of the betas from
    the 6 x 10 matrix L of the control points' distances, five
    Gauss-Newton steps on each, the camera frame by Procrustes, and the
    approximation of least mean reprojection error;
  * RANSAC: 100 minimal sets of 5 points, a 3 px reprojection threshold,
    the set with most inliers (the first of equal ones), then EPnP on its
    inliers.

The draw of the minimal sets (``geometry.umeyama.draw_hypotheses``, Gumbel
top-k from an explicit ``torch.Generator``) is split from the fit, and all
hypotheses of all instances are solved as one batch of f64 tensors on the
input's device (the GPU by default), with ``torch.linalg`` for the small
eigen, SVD and least-squares problems.  OpenCV's random stream cannot be
reproduced, so a pose equals cv2's where every consensus gives the same
pose (exact correspondences), not sample for sample.

``ransac_pnp`` and ``ransac_pnp_batch`` keep the JAX contract: numpy in,
numpy out; ``None`` (one instance) or an identity pose with ``ok=False``
(batch) on failure; at least ``min_points = 6`` masked points.
"""

from __future__ import annotations

import numpy as np
import torch

from givepose_torch.geometry.umeyama import draw_hypotheses

NUM_HYPOTHESES = 100
SAMPLE_SIZE = 5
THRESHOLD_PX = 3.0

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# the beta products of L's ten columns: b0², b0 b1, b1², b0 b2, ...
_QUAD_P = (0, 0, 1, 0, 1, 2, 0, 1, 2, 3)
_QUAD_Q = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3)


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the point axis: (..., N, d), (..., N) -> (..., d)."""
    return ((x * w[..., None]).sum(-2)
            / w.sum(-1, keepdim=True).clamp_min(1.0))


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solution of a x = b, (..., m, n), (..., m) -> (..., n),
    by the pseudo-inverse (OpenCV solves these by SVD)."""
    return (torch.linalg.pinv(a) @ b[..., None])[..., 0]


def _project(points: torch.Tensor, cam_k: torch.Tensor) -> torch.Tensor:
    """Camera-frame (..., N, 3) -> pixels (..., N, 2) through (..., 3, 3)."""
    z = points[..., 2]
    u = cam_k[..., 0, 0, None] * points[..., 0] / z + cam_k[..., 0, 2, None]
    v = cam_k[..., 1, 1, None] * points[..., 1] / z + cam_k[..., 1, 2, None]
    return torch.stack([u, v], -1)


def epnp(obj: torch.Tensor, img: torch.Tensor, cam_k: torch.Tensor,
         weight: torch.Tensor | None = None):
    """EPnP, batched over leading dims.

    Args:
      obj: (..., N, 3) object points, f64.
      img: (..., N, 2) their pixels.
      cam_k: (..., 3, 3) intrinsics (no skew).
      weight: optional (..., N) 0/1 mask of the points to use.

    Returns (R (..., 3, 3), t (..., 3), mean reprojection error (...)).
    """
    if weight is None:
        weight = torch.ones(obj.shape[:-1], dtype=obj.dtype,
                            device=obj.device)
    w = weight.to(obj.dtype)
    n = w.sum(-1)
    fu, fv = cam_k[..., 0, 0, None], cam_k[..., 1, 1, None]
    uc, vc = cam_k[..., 0, 2, None], cam_k[..., 1, 2, None]

    # choose_control_points: the centroid, then the principal axes
    c0 = _wmean(obj, w)
    d = obj - c0[..., None, :]
    cov = (d * w[..., None]).transpose(-1, -2) @ d
    evals, evecs = torch.linalg.eigh(cov)
    evals, evecs = evals.flip(-1).clamp_min(0.0), evecs.flip(-1)
    k = torch.sqrt(evals / n[..., None].clamp_min(1.0))
    axes = k[..., :, None] * evecs.transpose(-1, -2)          # rows
    cws = torch.cat([c0[..., None, :], c0[..., None, :] + axes], -2)

    # compute_barycentric_coordinates
    cc_inv = torch.linalg.pinv(axes.transpose(-1, -2))
    a123 = d @ cc_inv.transpose(-1, -2)
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)

    # fill_M, then MᵀM and its null space (eigenvectors of least
    # eigenvalue; OpenCV's ut rows 11, 10, 9, 8)
    zeros = torch.zeros_like(alphas)
    du = (uc - img[..., 0])[..., None]
    dv = (vc - img[..., 1])[..., None]
    r1 = torch.stack([alphas * fu[..., None], zeros, alphas * du],
                     -1).flatten(-2)
    r2 = torch.stack([zeros, alphas * fv[..., None], alphas * dv],
                     -1).flatten(-2)
    mtm = ((r1 * w[..., None]).transpose(-1, -2) @ r1
           + (r2 * w[..., None]).transpose(-1, -2) @ r2)
    _, vecs = torch.linalg.eigh(mtm)
    null = vecs[..., :, :4].transpose(-1, -2).reshape(
        *vecs.shape[:-2], 4, 4, 3)        # (..., i, control point, xyz)

    # compute_L_6x10, compute_rho
    diff = torch.stack([null[..., a, :] - null[..., b, :]
                        for a, b in _PAIRS], -2)          # (..., 4, 6, 3)

    def dot(i, j):
        return (diff[..., i, :, :] * diff[..., j, :, :]).sum(-1)

    L = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2),
                     2 * dot(1, 2), dot(2, 2), 2 * dot(0, 3),
                     2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)], -1)
    rho = torch.stack([((cws[..., a, :] - cws[..., b, :]) ** 2).sum(-1)
                       for a, b in _PAIRS], -1)

    def approx_1():
        b4 = _lstsq(L[..., [0, 1, 3, 6]], rho)
        b0 = torch.sqrt(b4[..., 0].abs())
        sign = torch.where(b4[..., 0] < 0, -1.0, 1.0).to(b4.dtype)
        return torch.stack([b0, sign * b4[..., 1] / b0,
                            sign * b4[..., 2] / b0,
                            sign * b4[..., 3] / b0], -1)

    def approx_2_3(cols):
        b = _lstsq(L[..., cols], rho)
        neg = b[..., 0] < 0
        b0 = torch.sqrt(b[..., 0].abs())
        b1 = torch.where(torch.where(neg, b[..., 2] < 0, b[..., 2] > 0),
                         torch.sqrt(b[..., 2].abs()), 0.0)
        b0 = torch.where(b[..., 1] < 0, -b0, b0)
        b2 = b[..., 3] / b0 if len(cols) == 5 else torch.zeros_like(b0)
        return torch.stack([b0, b1, b2, torch.zeros_like(b0)], -1)

    # L's columns are the products b_p b_q of _QUAD; their Jacobian in
    # the betas is (one-hot p) b_q + (one-hot q) b_p
    eye4 = torch.eye(4, dtype=L.dtype, device=L.device)
    p_hot, q_hot = eye4[list(_QUAD_P)], eye4[list(_QUAD_Q)]

    def gauss_newton(betas):
        # a degenerate set's division by 0 must not reach the SVDs
        betas = torch.nan_to_num(betas, nan=0.0, posinf=0.0, neginf=0.0)
        for _ in range(5):           # compute_A_and_b_gauss_newton, solve
            bp, bq = betas[..., _QUAD_P], betas[..., _QUAD_Q]
            jac = p_hot * bq[..., None] + q_hot * bp[..., None]
            resid = rho - (L @ (bp * bq)[..., None])[..., 0]
            betas = betas + _lstsq(L @ jac, resid)
        return betas

    def r_and_t(betas):
        ccs = (betas[..., :, None, None] * null).sum(-3)       # (..., 4, 3)
        pcs = alphas @ ccs
        # solve_for_sign: the points in front of the camera
        flip = (pcs[..., 2] * w).sum(-1) < 0
        sign = torch.where(flip, -1.0, 1.0).to(pcs.dtype)[..., None, None]
        pcs = pcs * sign
        pc0 = _wmean(pcs, w)
        abt = (((pcs - pc0[..., None, :]) * w[..., None]).transpose(-1, -2)
               @ d)
        u, _, vh = torch.linalg.svd(abt)
        rot = u @ vh
        neg = torch.linalg.det(rot) < 0
        rot = torch.cat([rot[..., :2, :],
                         torch.where(neg[..., None], -rot[..., 2, :],
                                     rot[..., 2, :])[..., None, :]], -2)
        t = pc0 - (rot @ c0[..., None])[..., 0]
        cam = obj @ rot.transpose(-1, -2) + t[..., None, :]
        err = torch.linalg.vector_norm(_project(cam, cam_k) - img, dim=-1)
        err = (torch.nan_to_num(err, nan=1e30) * w).sum(-1) / n.clamp_min(1)
        return rot, t, err

    best = None
    for betas in (approx_1(), approx_2_3([0, 1, 2]),
                  approx_2_3([0, 1, 2, 3, 4])):
        rot, t, err = r_and_t(gauss_newton(betas))
        if best is None:
            best = (rot, t, err)
            continue
        take = err < best[2]
        best = (torch.where(take[..., None, None], rot, best[0]),
                torch.where(take[..., None], t, best[1]),
                torch.where(take, err, best[2]))
    return best


def ransac_pnp_fit(obj: torch.Tensor, img: torch.Tensor,
                   cam_k: torch.Tensor, valid: torch.Tensor,
                   hypotheses: torch.Tensor,
                   threshold: float = THRESHOLD_PX) -> dict:
    """RANSAC over given minimal sets, batched over instances.

    Args:
      obj: (B, N, 3), img: (B, N, 2), cam_k: (B, 3, 3), f64.
      valid: (B, N) bool, the usable correspondences.
      hypotheses: (B, H, 5) point indices (``draw_hypotheses``).

    Returns dict(rotation (B, 3, 3), translation (B, 3), inliers (B,),
    ok (B,)): EPnP on each minimal set, the one with most points within
    ``threshold`` px (the first of equal ones), EPnP refitted on those.
    """
    b, h, k = hypotheses.shape
    idx = hypotheses.reshape(b, h * k)
    sub_obj = torch.gather(obj, 1, idx[..., None].expand(-1, -1, 3))
    sub_img = torch.gather(img, 1, idx[..., None].expand(-1, -1, 2))
    rot, t, _ = epnp(sub_obj.reshape(b, h, k, 3), sub_img.reshape(b, h, k, 2),
                     cam_k[:, None])
    cam = obj[:, None] @ rot.transpose(-1, -2) + t[..., None, :]
    err2 = ((_project(cam, cam_k[:, None]) - img[:, None]) ** 2).sum(-1)
    inl = valid[:, None] & (err2 <= threshold * threshold)    # NaN: out
    count = inl.sum(-1)
    best = torch.argmax(count, dim=1)
    inliers = inl[torch.arange(b, device=obj.device), best]
    rot, t, _ = epnp(obj, img, cam_k, inliers)
    n_in = inliers.sum(-1)
    ok = ((n_in >= k) & torch.isfinite(rot).flatten(1).all(1)
          & torch.isfinite(t).all(1))
    return {"rotation": rot, "translation": t, "inliers": n_in, "ok": ok}


def _correspondences(nocs_coor, pixel_x, pixel_y, mask, cam_k, scales,
                     device):
    """Padded (B, N) f64 tensors of every instance's masked points."""
    b = len(nocs_coor)
    sel = [np.asarray(m).reshape(-1) > 0 for m in mask]
    n = max(1, max(int(s.sum()) for s in sel))
    obj = np.zeros((b, n, 3))
    img = np.zeros((b, n, 2))
    valid = np.zeros((b, n), bool)
    for i, s in enumerate(sel):
        c = int(s.sum())
        obj[i, :c] = (np.asarray(nocs_coor[i]).reshape(-1, 3)[s]
                      .astype(np.float64) * scales[i])
        img[i, :c, 0] = np.asarray(pixel_x[i]).reshape(-1)[s]
        img[i, :c, 1] = np.asarray(pixel_y[i]).reshape(-1)[s]
        valid[i, :c] = True
    k = np.stack([np.asarray(c, np.float64) for c in cam_k])
    return tuple(torch.from_numpy(a).to(device) for a in (obj, img, k,
                                                          valid))


def ransac_pnp_batch(nocs_coor, pixel_x, pixel_y, mask, cam_k,
                     nocs_scales=None, min_points: int = 6,
                     generator: torch.Generator | None = None,
                     device=None):
    """A batch of instances in one call; failures (fewer than
    ``min_points`` masked points, no consensus of 5, a non-finite fit)
    give identity poses with ``ok`` False.  Numpy in, numpy out:
    (rots (B, 3, 3) f32, trans (B, 3) f32, ok (B,) bool).  Runs on
    ``device`` (default: the GPU; a CPU ``generator`` picks the CPU), its
    minimal sets drawn from ``generator``."""
    from givepose_torch.eval.serving import resolve_device

    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    b = len(nocs_coor)
    scales = (np.ones(b) if nocs_scales is None
              else np.asarray(nocs_scales, np.float64).reshape(b))
    obj, img, k, valid = _correspondences(nocs_coor, pixel_x, pixel_y,
                                          mask, cam_k, scales, device)
    hyp = draw_hypotheses(valid, generator, NUM_HYPOTHESES, SAMPLE_SIZE)
    fit = ransac_pnp_fit(obj, img, k, valid, hyp)
    ok = (fit["ok"] & (valid.sum(-1) >= min_points)).cpu().numpy()
    rots = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    trans = np.zeros((b, 3), np.float32)
    rots[ok] = fit["rotation"].cpu().numpy()[ok]
    trans[ok] = fit["translation"].cpu().numpy()[ok]
    return rots, trans, ok


def ransac_pnp(nocs_coor: np.ndarray, pixel_x: np.ndarray,
               pixel_y: np.ndarray, mask: np.ndarray, cam_k: np.ndarray,
               nocs_scale: float = 1.0, min_points: int = 6,
               generator: torch.Generator | None = None, device=None):
    """One instance: (R (3, 3) f32, t (3,) f32) from its NOCS <-> pixel
    correspondences, or None on failure.

    Args:
      nocs_coor: (R, R, 3) predicted NOCS map.
      pixel_x/pixel_y: (R, R) absolute source-image pixel coords.
      mask: (R, R) foreground mask.
      cam_k: (3, 3).
      nocs_scale: metric scale multiplying the NOCS coords.
    """
    if (np.asarray(mask) > 0).sum() < min_points:
        return None
    rots, trans, ok = ransac_pnp_batch(
        [nocs_coor], [pixel_x], [pixel_y], [mask], [cam_k], [nocs_scale],
        min_points, generator, device)
    return (rots[0], trans[0]) if ok[0] else None
