"""BOP-style pose errors: MSSD, MSPD, VSD.

Port of ``givepose_tpu/geometry/bop_errors.py`` (reference
network/pose_utils/pose_error.py:19-220).  MSSD and MSPD are its numpy
float64 copies.  VSD renders both poses with the JAX package's z-buffer
point renderer (``prep/renderer.py``), which the port does not have yet:
it raises.

Symmetry transforms follow the BOP convention (pose_error.py:143-151):
each is a rotation S with an optional translation t_s, applied as
R_gt_sym = R_gt @ S and t_gt_sym = R_gt @ t_s + t_gt.
"""

from __future__ import annotations

import numpy as np


def _sym_list(syms, sym_ts):
    rs = np.asarray(syms).reshape(-1, 3, 3)
    if sym_ts is None:
        ts = np.zeros((len(rs), 3), np.float64)
    else:
        ts = np.asarray(sym_ts).reshape(-1, 3)
        if len(ts) != len(rs):
            raise ValueError(f"{len(ts)} symmetry translations for "
                             f"{len(rs)} rotations")
    return rs, ts


def mssd(r_est, t_est, r_gt, t_gt, pts, syms, sym_ts=None) -> float:
    """Maximum Symmetry-aware Surface Distance (pose_error.py:128-150).

    min over symmetry transforms (S, t_s) of
    max_x ||(R̂x+t̂) - (R̄Sx + R̄t_s + t̄)||.

    Args:
      r_est/r_gt: (3,3); t_est/t_gt: (3,); pts: (N,3) model points;
      syms: (K,3,3) symmetry rotations (include identity);
      sym_ts: optional (K,3) symmetry translations (BOP models_info).
    """
    r_gt = np.asarray(r_gt)
    t_gt = np.asarray(t_gt)
    est = pts @ np.asarray(r_est).T + np.asarray(t_est)
    dists = []
    for s, ts in zip(*_sym_list(syms, sym_ts)):
        gt = (pts @ s.T) @ r_gt.T + (r_gt @ ts + t_gt)
        dists.append(np.linalg.norm(est - gt, axis=1).max())
    return float(min(dists))


def mspd(r_est, t_est, r_gt, t_gt, k, pts, syms, sym_ts=None) -> float:
    """Maximum Symmetry-aware Projection Distance in pixels
    (pose_error.py:153-177)."""
    k = np.asarray(k)
    r_gt = np.asarray(r_gt)
    t_gt = np.asarray(t_gt)

    def proj(cam):
        uv = cam @ k.T
        return uv[:, :2] / uv[:, 2:3]

    est = proj(pts @ np.asarray(r_est).T + np.asarray(t_est))
    dists = []
    for s, ts in zip(*_sym_list(syms, sym_ts)):
        gt = proj((pts @ s.T) @ r_gt.T + (r_gt @ ts + t_gt))
        dists.append(np.linalg.norm(est - gt, axis=1).max())
    return float(min(dists))


def vsd(r_est, t_est, r_gt, t_gt, k, pts, depth_test, delta: float = 15.0,
        taus=(20.0,), im_h: int = 480, im_w: int = 640,
        normalized_by_diameter: bool = False, diameter: float = 1.0,
        cost_type: str = "step") -> list[float]:
    """Visible Surface Discrepancy (pose_error.py:19-126, BOP19): not
    ported yet."""
    raise NotImplementedError(
        "vsd renders both poses through prep/renderer.py render_points, "
        "which is not ported yet (ROADMAP queue A, item 11)")
