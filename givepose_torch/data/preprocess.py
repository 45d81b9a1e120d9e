"""Preprocessing of a host batch into the model's inputs, on its device.

Port of ``givepose_tpu/data/preprocess.py``.  The reference preprocesses
per sample in DataLoader workers: DZI bbox jitter
(tools/dataset_utils.py:32-82), seven cv2.warpAffine crops
(datasets/load_data_nocs.py:277-331), normalization, mask deformation
(data_augmentation.py:11-33) and imgaug color jitter (:508-617).  Here
the batch's full-resolution arrays go to the device once and:

  * DZI jitter (``dzi_jitter``: uniform type, scale in [0.75, 1.25],
    shift +-0.25, pad 1.5) and the crops' index tables are computed on
    the host in f32, so the CPU and GPU paths gather the same pixels;
  * the roi/mask/coord/ivfc crops are nearest gathers
    (``ops.resample.crop_nearest``), as the reference's INTER_NEAREST;
  * the 2D pixel-coordinate crop is computed in closed form
    (``crop_coord_2d``);
  * mask deformation is the 2x2 min/max morphology band with a
    Bernoulli(0.5) fill (``data.augment.defor_2d_mask``);
  * color augmentation runs on the full image before cropping, as in the
    reference; the full image for the scale net is a bilinear resize.

Every random value comes from ``draw_preprocess`` (a CPU generator), so
``preprocess_batch`` itself is deterministic.  Outputs are NHWC with the
JAX package's keys, the port's PoseNet boundary.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from givepose_torch.data.augment import (
    _uniform,
    color_augment,
    color_augment_draws,
    defor_2d_mask,
    defor_2d_mask_draws,
)
from givepose_torch.data.records import IMG_MEAN, IMG_STD
from givepose_torch.ops.resample import (
    affine_crop_params_np,
    crop_nearest,
    nearest_index,
    nearest_src,
    resize_bilinear,
    resize_matrix_np,
)

PASS_THROUGH = ("cam_K", "rotation", "translation", "nocs_scale",
                "real_size", "mean_size", "sym_info", "model_point",
                "cat_id0")


def draw_preprocess(generator: torch.Generator, b: int, img_size: int = 256,
                    train: bool = True, color_aug_prob: float = 0.8,
                    mask_pro: float = 0.5, dzi_type: str = "uniform"
                    ) -> dict:
    """Every random value ``preprocess_batch`` takes for a batch of ``b``,
    drawn on the host: the DZI jitter's per-sample uniforms, the colour
    draws (``color_augment_draws``) and the mask deformation's
    (``defor_2d_mask_draws``: one (b, img_size, img_size) fill).  Eval
    mode draws nothing."""
    if not train:
        return {}
    draws = {}
    if dzi_type == "uniform":
        ratio = _uniform(generator, (b,), -1.0, 1.0)
    elif dzi_type == "uniform_sr":
        ratio = _uniform(generator, (b,))
    elif dzi_type == "none":
        ratio = None
    else:
        raise NotImplementedError(dzi_type)
    if ratio is not None:
        draws["dzi"] = {"ratio": ratio,
                        "shift": _uniform(generator, (b, 2), -1.0, 1.0)}
    if color_aug_prob > 0:
        draws["color"] = color_augment_draws(generator, b, color_aug_prob)
    draws["mask"] = defor_2d_mask_draws(generator, (b, img_size, img_size),
                                        mask_pro)
    return draws


def dzi_jitter(bbox, im_h: int, im_w: int, draws: dict | None = None,
               pad_scale: float = 1.5, scale_ratio: float = 0.25,
               shift_ratio: float = 0.25, dzi_type: str = "uniform"):
    """Batched DZI bbox jitter (reference aug_bbox_DZI), on the host in
    f32.  bbox (B, 4) xyxy and the ``draws["dzi"]`` uniforms (``ratio``
    in [-1, 1) for ``uniform``, [0, 1) for ``uniform_sr``; ``shift`` (B, 2)
    in [-1, 1)) -> (center (B, 2), scale (B,)) numpy f32."""
    f32 = np.float32
    bbox = np.asarray(bbox, f32)
    x1, y1, x2, y2 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    cx, cy = f32(0.5) * (x1 + x2), f32(0.5) * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    base = np.maximum(bh, bw)
    if dzi_type == "none":
        return np.stack([cx, cy], axis=1), np.minimum(base, f32(max(im_h,
                                                                     im_w)))
    u = np.asarray(draws["ratio"], f32)
    if dzi_type == "uniform":
        ratio = f32(1.0) + f32(scale_ratio) * u
    elif dzi_type == "uniform_sr":
        ratio = f32(1.0) - f32(0.25) * u
    else:
        raise NotImplementedError(dzi_type)
    shift = f32(shift_ratio) * np.asarray(draws["shift"], f32)
    center = np.stack([cx + bw * shift[:, 0], cy + bh * shift[:, 1]],
                      axis=1)
    scale = np.minimum(base * ratio * f32(pad_scale), f32(max(im_h, im_w)))
    return center, scale


def crop_coord_2d(center, scale, out_res: int, im_w: int, im_h: int,
                  device=None) -> torch.Tensor:
    """Closed-form nearest-sampled crop of the normalized pixel grid
    (warping get_2d_coord_np's grid, reference :238,285-287): source
    pixel round(a*j + b), normalized to [-1, 1] by (v - (n-1)/2) * (2/(n-1))
    (the reciprocal's product, as XLA computes the JAX package's
    quotient).  Cells whose source pixel lies outside the image are (0, 0)
    (cv2.warpAffine's zero border).  Returns (B, out, out, 2), x first."""
    a, bx, by = affine_crop_params_np(center, scale, out_res)
    sx = nearest_src(a, bx, out_res)
    sy = nearest_src(a, by, out_res)
    hw, hh = np.float32((im_w - 1) / 2), np.float32((im_h - 1) / 2)
    nx = (sx - hw) * np.float32(1 / hw)
    ny = (sy - hh) * np.float32(1 / hh)
    okx = (sx >= 0) & (sx <= im_w - 1)
    oky = (sy >= 0) & (sy <= im_h - 1)
    nx = torch.from_numpy(np.where(okx, nx, np.float32(0))).to(device)
    ny = torch.from_numpy(np.where(oky, ny, np.float32(0))).to(device)
    ok = (torch.from_numpy(oky).to(device)[:, :, None]
          & torch.from_numpy(okx).to(device)[:, None, :])
    b = nx.shape[0]
    xx = nx[:, None, :].expand(b, out_res, out_res)
    yy = ny[:, :, None].expand(b, out_res, out_res)
    out = torch.stack([xx, yy], dim=-1)
    return torch.where(ok[..., None], out, torch.zeros((), device=device))


@lru_cache(maxsize=8)
def _full_resize(im_h: int, im_w: int, img_size: int):
    """The scale net's full-image bilinear matrices (cv2.resize's pixel
    centers: src = (dst + 0.5) * a - 0.5), built as the JAX package does."""
    wy = resize_matrix_np(im_h, img_size, np.float32(im_h / img_size),
                          np.float32(0.5 * im_h / img_size - 0.5))
    a = np.float32(im_w / float(img_size))
    wx = resize_matrix_np(im_w, img_size, a, np.float32(0.5) * a
                          - np.float32(0.5))
    return wy, wx


def _normalize(img01: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMG_MEAN, device=img01.device)
    std = torch.as_tensor(IMG_STD, device=img01.device)
    return (img01 - mean) / std


def preprocess_batch(batch: dict, draws: dict, img_size: int = 256,
                     out_res: int = 64, train: bool = True,
                     color_aug_prob: float = 0.8, resize_full: bool = True,
                     dzi_type: str = "uniform",
                     dzi_pad_scale: float = 1.5,
                     dzi_scale_ratio: float = 0.25,
                     dzi_shift_ratio: float = 0.25, device=None) -> dict:
    """Full-resolution host arrays -> model-ready crops on ``device``.

    batch keys (stacked over B; numpy arrays or tensors):
      image (B,H,W,3) uint8/f32, mask (B,H,W), nocs_coord (B,H,W,3),
      ivfc_coord (B,H,W,3), ivfc_mask (B,H,W), bbox (B,4 xyxy), cat_id0,
      plus pass-through metadata (cam_K, rotation, ...).
    draws: ``draw_preprocess``'s for this batch (``{}`` in eval mode).
    device: where to run; by default where ``batch["image"]`` is (the CPU
    for numpy arrays).

    DZI knobs mirror the reference FLAGS (config/config.py:30-33) and
    only apply when ``train``; eval mode uses the reference's ``ori=True``
    branch (tools/dataset_utils.py:44-48, no pad factor).
    """
    image = batch["image"]
    if device is None:
        device = image.device if torch.is_tensor(image) else "cpu"
    device = torch.device(device)

    def dev(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    img = dev(image).float()
    b, im_h, im_w = img.shape[:3]
    bbox = batch["bbox"]
    bbox = np.asarray(bbox.cpu() if torch.is_tensor(bbox) else bbox,
                      np.float32)

    if train and color_aug_prob > 0:
        img = color_augment(img, draws["color"])
    if train:
        center, scale = dzi_jitter(bbox, im_h, im_w, draws.get("dzi"),
                                   pad_scale=dzi_pad_scale,
                                   scale_ratio=dzi_scale_ratio,
                                   shift_ratio=dzi_shift_ratio,
                                   dzi_type=dzi_type)
    else:
        center, scale = dzi_jitter(bbox, im_h, im_w, dzi_type="none")

    def tables(size):
        a, bx, by = affine_crop_params_np(center, scale, size)
        rows, row_ok = nearest_index(a, by, size, im_h)
        cols, col_ok = nearest_index(a, bx, size, im_w)
        return tuple(dev(t) for t in (rows, row_ok, cols, col_ok))

    roi_t, out_t = tables(img_size), tables(out_res)

    # roi crop: the reference uses INTER_NEAREST for the rgb roi (:277-279)
    roi_img_origin = crop_nearest(img, *roi_t) * np.float32(1 / 255.0)
    roi_img = _normalize(roi_img_origin)

    mask = dev(batch["mask"]).float()[..., None]
    roi_mask = crop_nearest(mask, *roi_t)
    roi_mask_out = crop_nearest(mask, *out_t)
    roi_nocs = crop_nearest(dev(batch["nocs_coord"]).float(), *out_t)
    roi_ivfc = crop_nearest(dev(batch["ivfc_coord"]).float(), *out_t)
    roi_ivfc_mask = crop_nearest(dev(batch["ivfc_mask"]).float()[..., None],
                                 *out_t)
    coord2d = crop_coord_2d(center, scale, out_res, im_w, im_h, device)

    if train:
        roi_mask_deform = defor_2d_mask(roi_mask[..., 0],
                                        draws["mask"])[..., None]
    else:
        roi_mask_deform = roi_mask

    # full image for the scale net (reference :349-351)
    if resize_full:
        wy, wx = _full_resize(im_h, im_w, img_size)
        full = resize_bilinear(img, dev(wy), dev(wx))
    else:
        full = img
    full_img = _normalize(full * np.float32(1 / 255.0))

    bw = np.clip(bbox[:, 2], 0, im_w) - np.clip(bbox[:, 0], 0, im_w)
    bh = np.clip(bbox[:, 3], 0, im_h) - np.clip(bbox[:, 1], 0, im_h)
    cat = dev(batch["cat_id0"])

    out = {
        "roi_img": roi_img,
        "roi_img_origin": roi_img_origin,
        "roi_mask": roi_mask,
        "roi_mask_output": roi_mask_out,
        "roi_mask_deform": roi_mask_deform,
        "nocs_coord": roi_nocs,
        "ivfc_coord": roi_ivfc,
        "roi_ivfc_mask_output": roi_ivfc_mask,
        "roi_coord_2d": coord2d,
        "full_img": full_img,
        "one_hot": F.one_hot(cat.long(), 6).float(),
        "bbox_center": dev(center),
        "img_scale": dev(scale),
        "resize_ratio": dev(np.float32(out_res) / scale),
        "roi_wh": dev(np.stack([bw, bh], axis=1).astype(np.float32)),
    }
    # pass-through labels / metadata
    for k in PASS_THROUGH:
        if k in batch:
            out[k] = cat if k == "cat_id0" else dev(batch[k])
    return out


def collate_records(records) -> dict:
    """Stack host Records into the raw array batch preprocess_batch eats."""
    return {
        "image": np.stack([r.image for r in records]),
        "mask": np.stack([r.mask for r in records]),
        "nocs_coord": np.stack([r.nocs_coord for r in records]),
        "ivfc_coord": np.stack([r.ivfc_coord for r in records]),
        "ivfc_mask": np.stack([r.ivfc_mask for r in records]),
        "bbox": np.stack([r.bbox for r in records]),
        "cat_id0": np.asarray([r.cat_id0 for r in records], np.int32),
        "cam_K": np.stack([r.cam_k for r in records]),
        "rotation": np.stack([r.rotation for r in records]),
        "translation": np.stack([r.translation for r in records]),
        "nocs_scale": np.asarray([r.nocs_scale for r in records],
                                 np.float32),
        "real_size": np.stack([r.real_size for r in records]),
        "mean_size": np.stack([r.mean_size for r in records]),
        "sym_info": np.stack([r.sym for r in records]),
        "model_point": np.stack([r.model_points for r in records]),
    }
