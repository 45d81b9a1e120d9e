"""Symmetry handling: the rotation bank about +y and the closest
symmetric ground-truth rotation, batched on the device.

Port of ``givepose_tpu/geometry/symmetry.py``.  The bank is built in f64
and used in f32.  The search is an argmax of trace(predᵀ · gt · bank_k)
over the bank, in full f32 (TF32 off on the card); ``torch.argmax`` takes
the first of equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def symmetry_rotation_bank_y(number: int = 30) -> np.ndarray:
    """(number, 3, 3) f64 rotations about +y by 2πk/number."""
    theta = 2.0 * np.pi / number * np.arange(number)
    c, s = np.cos(theta), np.sin(theta)
    zeros = np.zeros_like(theta)
    ones = np.ones_like(theta)
    rows = np.stack([
        np.stack([c, zeros, s], axis=-1),
        np.stack([zeros, ones, zeros], axis=-1),
        np.stack([-s, zeros, c], axis=-1),
    ], axis=-2)
    return rows.astype(np.float64)


def closest_sym_rot(pred_rots: torch.Tensor, gt_rots: torch.Tensor,
                    sym_flags: torch.Tensor,
                    bank: torch.Tensor) -> torch.Tensor:
    """(B,3,3) ground truth rotated by the bank entry closest to the
    prediction where ``sym_flags`` (B,) is 1, else ``gt_rots`` unchanged.
    No gradient flows to ``pred_rots`` (the argmax picks an index)."""
    pg = torch.einsum("bij,bik->bjk", pred_rots, gt_rots)      # predᵀ gt
    traces = torch.einsum("bjk,nkj->bn", pg, bank)
    best = torch.argmax(traces, dim=1)
    gt_sym = torch.matmul(gt_rots, bank[best])
    flag = sym_flags.reshape(-1, 1, 1).to(gt_rots.dtype)
    return flag * gt_sym + (1.0 - flag) * gt_rots


# Per-category symmetry descriptors, rows by 1-based category id
# (bottle, bowl, camera, can, laptop, mug with a visible handle).
_SYM_TABLE = np.array([
    [1, 1, 0, 1],
    [1, 1, 0, 1],
    [0, 0, 0, 0],
    [1, 1, 1, 1],
    [0, 1, 0, 0],
    [0, 1, 0, 0],
], dtype=np.int32)
_MUG_NO_HANDLE = np.array([1, 0, 0, 0], dtype=np.int32)


def sym_info_table() -> np.ndarray:
    return _SYM_TABLE.copy()


def sym_info(cat_id_1based: int, mug_handle: int = 1) -> np.ndarray:
    """Symmetry descriptor of a category; a mug without a visible handle
    is symmetric."""
    if cat_id_1based == 6 and mug_handle == 0:
        return _MUG_NO_HANDLE.copy()
    return _SYM_TABLE[cat_id_1based - 1].copy()
