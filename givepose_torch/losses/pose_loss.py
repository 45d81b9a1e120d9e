"""Pose losses (PyTorch), all on the device.

Port of ``givepose_tpu/losses/pose_loss.py``.  The symmetric ground truth
comes from a batched argmax over a 360-rotation bank
(``geometry/symmetry.py``), so the loss never waits on the host.

Loss terms, in this order:
  Rot1            L1 on R against the symmetry-resolved gt, or angle loss
  Tran / Size     L1 (or smooth L1) on targets divided by nocs_scale
  Point_matching  L1 between R·model and R_gt·model
  nocs_coor /
  sp2d_coor       dense coordinate loss (quadratic below 0.03, linear
                  above), mask-normalised, on symmetry-rotated gt maps

The 3×3 products are full f32 (TF32 off on the card), as the JAX
package's ``precision="highest"`` ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from givepose_torch.core.config import LossConfig
from givepose_torch.geometry.symmetry import (
    closest_sym_rot,
    symmetry_rotation_bank_y,
)

_COOR_THRESHOLD = 0.03


class _Abs(torch.autograd.Function):
    """|x| with the gradient of ``jnp.abs``: sign(x), NaN where x is NaN
    (``torch.sign`` gives 0 there).  So a NaN target makes the gradients
    NaN, as in the JAX package, and the train step's finite guard skips
    the step instead of applying the other samples' gradients."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.where(torch.isnan(x), x, torch.sign(x))


_abs = _Abs.apply


def _l1(a, b):
    return _abs(a - b)


def _smooth_l1(a, b, beta=0.5):
    d = _abs(a - b)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _coor_loss(pred, gt, mask):
    """Dense coordinate loss; pred/gt (B,H,W,3), mask (B,H,W,1)."""
    pred = pred * mask
    gt = gt * mask
    diff = _abs(pred - gt)
    lower = diff * diff / (2.0 * _COOR_THRESHOLD)
    higher = diff - _COOR_THRESHOLD / 2.0
    per_px = torch.where(diff > _COOR_THRESHOLD, higher, lower) * mask
    num = per_px.sum(dim=(1, 2, 3))
    den = mask.sum(dim=(1, 2, 3)) + 1e-5
    return torch.mean(num / den)


def _rotate_maps(maps: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Per-sample 3×3 rotation of an NHWC coordinate map."""
    return torch.einsum("bij,bhwj->bhwi", rot, maps)


class PoseLossFn:
    """Callable returning the loss dict; the bank lives on ``device``."""

    def __init__(self, cfg: LossConfig, r_type: str = "allo_rot6d",
                 device=None):
        self.cfg = cfg
        self.r_type = r_type
        # the search uses the 360-entry bank; rot_sym_num is unused on the
        # coor_gt_sym='rot' path, as in the JAX package
        self.bank = torch.as_tensor(symmetry_rotation_bank_y(360),
                                    dtype=torch.float32, device=device)
        self.base = _l1 if cfg.pose_loss_type == "l1" else _smooth_l1

    def __call__(self, pred: dict, data: dict) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        gt_rot_origin = data["rotation"]                 # (B,3,3)
        nocs_scale = data["nocs_scale"][:, None]
        sym_flag = (data["sym_info"][:, 0] == 1).float()
        gt_size_n = data["real_size"] / nocs_scale
        gt_trans_n = data["translation"] / nocs_scale

        gt_rot = closest_sym_rot(pred["rot"], gt_rot_origin, sym_flag,
                                 self.bank)
        # residual symmetry rotation applied to the gt maps
        rot_sym = torch.einsum("bij,bik->bjk", gt_rot, gt_rot_origin)
        gt_nocs = _rotate_maps(data["nocs_coord"], rot_sym)
        gt_ivfc = _rotate_maps(data["ivfc_coord"], rot_sym)

        losses = {}
        if cfg.r_loss == "l1":
            losses["Rot1"] = cfg.rot_1_w * torch.mean(
                self.base(pred["rot"], gt_rot))
        elif cfg.r_loss == "angle":
            diff = torch.einsum("bij,bkj->bik", gt_rot, pred["rot"])
            trace = diff.diagonal(dim1=-2, dim2=-1).sum(-1)
            # min/max, not torch.clamp: jnp.clip's gradient, 0.5 on the
            # bound (ops/dcnv3.py _clip)
            c = (trace - 1) / 2
            ang = torch.arccos(torch.minimum(
                torch.maximum(c, c.new_tensor(-0.99999)),
                c.new_tensor(0.99999)))
            losses["Rot1"] = cfg.rot_1_w * torch.mean(
                _smooth_l1(ang, torch.zeros_like(ang), beta=0.2))
        else:
            raise NotImplementedError(cfg.r_loss)

        losses["Tran"] = cfg.tran_w * torch.mean(
            self.base(pred["trans"], gt_trans_n))
        losses["Size"] = cfg.size_w * torch.mean(
            self.base(pred["size"], gt_size_n))

        pts = data["model_point"]                         # (B,P,3)
        pred_pts = torch.einsum("bij,bpj->bpi", pred["rot"], pts)
        gt_pts = torch.einsum("bij,bpj->bpi", gt_rot, pts)
        losses["Point_matching"] = cfg.prop_pm_w * torch.mean(
            self.base(pred_pts, gt_pts))

        losses["nocs_coor"] = cfg.coor_w * _coor_loss(
            pred["nocs_coor"], gt_nocs, data["roi_mask_output"])
        losses["sp2d_coor"] = cfg.coor_w * _coor_loss(
            pred["ivfc_coor"], gt_ivfc, data["roi_ivfc_mask_output"])
        return losses


def pnp_loss(cfg: LossConfig, pred: dict, data: dict,
             bank: torch.Tensor) -> dict:
    """Reduced loss for PnP-only training: Rot1 + Tran + Point_matching."""
    base = _l1 if cfg.pose_loss_type == "l1" else _smooth_l1
    sym_flag = (data["sym_info"][:, 0] == 1).float()
    gt_rot = closest_sym_rot(pred["rot"], data["rotation"], sym_flag, bank)
    gt_trans_n = data["translation"] / data["nocs_scale"][:, None]
    pts = data["model_point"]
    pred_pts = torch.einsum("bij,bpj->bpi", pred["rot"], pts)
    gt_pts = torch.einsum("bij,bpj->bpi", gt_rot, pts)
    return {
        "Rot1": cfg.rot_1_w * torch.mean(base(pred["rot"], gt_rot)),
        "Tran": cfg.tran_w * torch.mean(base(pred["trans"], gt_trans_n)),
        "Point_matching": cfg.prop_pm_w * torch.mean(base(pred_pts, gt_pts)),
    }


def scale_loss(cfg: LossConfig, pred_scale: torch.Tensor,
               gt_scale: torch.Tensor) -> torch.Tensor:
    base = _l1 if cfg.pose_loss_type == "l1" else _smooth_l1
    return torch.mean(base(pred_scale, gt_scale))


def soft_label_cross_entropy(pred_logits, target):
    """-sum(log(target, with 0 read as 1) * softmax(pred_logits, dim 1))."""
    pred_p = torch.softmax(pred_logits, dim=1)
    log_t = torch.log(torch.where(target == 0, torch.ones_like(target),
                                  target))
    return -torch.sum(log_t * pred_p)


def laplacian_aleatoric_loss(pred, target, log_variance, mask=None,
                             balance_weight=10.0, sum_last_dim=True):
    if sum_last_dim:
        err = torch.sum(_abs(pred - target), dim=1, keepdim=True)
    else:
        err = _abs(pred - target)
    loss = (balance_weight * 1.4142 * torch.exp(-0.5 * log_variance) * err
            + 0.5 * log_variance)
    if mask is not None:
        loss = loss * mask
    return torch.mean(loss)


def gaussian_aleatoric_loss(pred, target, log_variance):
    loss = (0.5 * torch.exp(-log_variance) * _abs(pred - target) ** 2
            + 0.5 * log_variance)
    return torch.mean(loss)


def backbone_mask_loss(pred_mask_logits, gt_mask):
    """Binary cross-entropy on mask logits (off the default path)."""
    logp = F.logsigmoid(pred_mask_logits)
    logn = F.logsigmoid(-pred_mask_logits)
    return -torch.mean(gt_mask * logp + (1.0 - gt_mask) * logn)
