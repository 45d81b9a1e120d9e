"""Point-cloud augmentations (reference datasets/data_augmentation.py:
38-259, inherited from FS-Net).

Port of ``givepose_tpu/data/augment3d.py``.  These operate on
depth-derived point clouds, NOCS points and model points.  On the
reference's RGB pipeline they are imported by the engine but never called
(SURVEY.md §2.3); they are provided, batched over the leading dim, for the
depth-assisted training configurations.  As in ``data/augment.py``, the
random values are drawn apart (``pc_augment_draws``, on a CPU
``torch.Generator``) and the functions apply given draws
deterministically, returning updated copies.
"""

from __future__ import annotations

import torch

from givepose_torch.data.augment import _uniform


def _to_object_frame(pc, rot, trans):
    return torch.einsum("bji,bnj->bni", rot, pc - trans[:, None, :])


def _to_camera_frame(pc_obj, rot, trans):
    return torch.einsum("bij,bnj->bni", rot, pc_obj) + trans[:, None, :]


def _scale_xz(pts, factor):
    """pts with its x and z columns multiplied by ``factor`` (B, N)."""
    f = torch.stack([factor, torch.ones_like(factor), factor], dim=-1)
    return pts * f


def defor_3d_bb(pc, rot, trans, size, nocs, model, sym, aug_bb):
    """Bounding-box anisotropic rescale (reference defor_3D_bb :38-81).

    y-symmetric samples share the x/z factor ((ex+ez)/2).  Returns
    (pc, size, nocs, model).
    """
    ex, ey, ez = aug_bb[:, 0], aug_bb[:, 1], aug_bb[:, 2]
    exz = (ex + ez) / 2
    is_sym = sym[:, 0] == 1
    factors = torch.stack([torch.where(is_sym, exz, ex), ey,
                           torch.where(is_sym, exz, ez)], dim=1)   # (B, 3)

    new_size = size * factors
    scale_aug = new_size.norm(dim=1) / size.norm(dim=1)            # (B,)

    pc_obj = _to_object_frame(pc, rot, trans) * factors[:, None, :]
    pc_new = _to_camera_frame(pc_obj, rot, trans)
    nocs_new = nocs * factors[:, None, :] / scale_aug[:, None, None]
    model_new = model * factors[:, None, :] / scale_aug[:, None, None]
    return pc_new, new_size, nocs_new, model_new


def defor_3d_bc(pc, rot, trans, size, model, nocs, ey_up, ey_down):
    """Box-cage y-linear rescale (reference defor_3D_bc :84-120, applied
    only to bowl/mug); ``ey_up``, ``ey_down`` (B, 1) in [0.8, 1.2).
    Returns (pc, size, model, nocs)."""
    pc_obj = _to_object_frame(pc, rot, trans)
    per_pt = ((pc_obj[:, :, 1] + size[:, 1:2] / 2) / size[:, 1:2]
              * (ey_up - ey_down) + ey_down)
    pc_new = _to_camera_frame(_scale_xz(pc_obj, per_pt), rot, trans)

    norm_s = size / size.norm(dim=1, keepdim=True)
    m_resize = ((model[:, :, 1] + norm_s[:, 1:2] / 2) / norm_s[:, 1:2]
                * (ey_up - ey_down) + ey_down)
    model = _scale_xz(model, m_resize)

    lx = 2 * torch.maximum(model[:, :, 0].amax(1), -model[:, :, 0].amin(1))
    ly = model[:, :, 1].amax(1) - model[:, :, 1].amin(1)
    lz = model[:, :, 2].amax(1) - model[:, :, 2].amin(1)
    extents = torch.stack([lx, ly, lz], dim=1)
    size_new = extents * size.norm(dim=1)[:, None]
    scale_aug = extents.norm(dim=1)
    model = model / scale_aug[:, None, None]

    n_resize = ((nocs[:, :, 1] + norm_s[:, 1:2] / 2) / norm_s[:, 1:2]
                * (ey_up - ey_down) + ey_down)
    nocs = _scale_xz(nocs, n_resize) / scale_aug[:, None, None]
    return pc_new, size_new, model, nocs


def defor_3d_rt(pc, rot, trans, aug_t, aug_r):
    """Pose jitter (reference defor_3D_rt): rotate about the object frame
    by aug_r and shift by aug_t.  Returns (pc, rot, trans)."""
    pc_obj = _to_object_frame(pc, rot, trans)
    rot_new = torch.einsum("bij,bjk->bik", rot, aug_r)
    trans_new = trans + aug_t
    pc_new = torch.einsum("bij,bnj->bni", rot_new, pc_obj) \
        + trans_new[:, None, :]
    return pc_new, rot_new, trans_new


def defor_3d_pc(pc, noise):
    """Per-point jitter (reference defor_3D_pc): ``noise`` of pc's shape,
    uniform in [-r, r) meters."""
    return pc + noise


def pc_augment_draws(generator: torch.Generator, b: int, n_points: int,
                     aug_bb_pro=0.3, aug_rt_pro=0.3, aug_bc_pro=0.3,
                     aug_pc_pro=0.2, aug_pc_r=0.002) -> dict:
    """Host draws of ``pc_augment`` for ``b`` clouds of ``n_points``: the
    four per-sample gates, the box cage's (B, 1) ``ey_up``/``ey_down`` and
    the per-point noise."""
    return {
        "gate_bb": _uniform(generator, (b,)) < aug_bb_pro,
        "gate_rt": _uniform(generator, (b,)) < aug_rt_pro,
        "gate_bc": _uniform(generator, (b,)) < aug_bc_pro,
        "ey_up": _uniform(generator, (b, 1), 0.8, 1.2),
        "ey_down": _uniform(generator, (b, 1), 0.8, 1.2),
        "gate_pc": _uniform(generator, (b,)) < aug_pc_pro,
        "noise": _uniform(generator, (b, n_points, 3), -aug_pc_r, aug_pc_r),
    }


def pc_augment(pc, pc_nocs, data, draws):
    """Batched entry point (reference pc_augment :203-259) under ``draws``
    (``pc_augment_draws``); the box cage applies only to bowl (cat 1) and
    mug (cat 5)."""
    dev = pc.device

    def gate(name, cond=None):
        g = torch.as_tensor(draws[name], device=dev)
        return g if cond is None else g & cond

    rot, trans = data["rotation"], data["translation"]
    size, model = data["real_size"], data["model_point"]

    g = gate("gate_bb")
    pc2, size2, nocs2, model2 = defor_3d_bb(
        pc, rot, trans, size, pc_nocs, model, data["sym_info"],
        data["aug_bb"])
    pc = torch.where(g[:, None, None], pc2, pc)
    size = torch.where(g[:, None], size2, size)
    pc_nocs = torch.where(g[:, None, None], nocs2, pc_nocs)
    model = torch.where(g[:, None, None], model2, model)

    g = gate("gate_rt")
    pc2, rot2, trans2 = defor_3d_rt(pc, rot, trans, data["aug_rt_t"],
                                    data["aug_rt_R"])
    pc = torch.where(g[:, None, None], pc2, pc)
    rot = torch.where(g[:, None, None], rot2, rot)
    trans = torch.where(g[:, None], trans2, trans)

    cat = data["cat_id0"]
    g = gate("gate_bc", (cat == 1) | (cat == 5))
    pc2, size2, model2, nocs2 = defor_3d_bc(
        pc, rot, trans, size, model, pc_nocs,
        torch.as_tensor(draws["ey_up"], device=dev),
        torch.as_tensor(draws["ey_down"], device=dev))
    pc = torch.where(g[:, None, None], pc2, pc)
    size = torch.where(g[:, None], size2, size)
    model = torch.where(g[:, None, None], model2, model)
    pc_nocs = torch.where(g[:, None, None], nocs2, pc_nocs)

    g = gate("gate_pc")
    pc2 = defor_3d_pc(pc, torch.as_tensor(draws["noise"], device=dev))
    pc = torch.where(g[:, None, None], pc2, pc)

    out = dict(data)
    out["rotation"] = rot
    out["translation"] = trans
    out["real_size"] = size
    out["model_point"] = model
    return pc, pc_nocs, out
