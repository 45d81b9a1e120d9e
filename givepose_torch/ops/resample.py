"""Crop-and-resize for the data path: host numpy and batched torch.

Port of ``givepose_tpu/ops/resample.py``.  The reference warps every
sample seven times with cv2.warpAffine (datasets/load_data_nocs.py:277-331
via tools/dataset_utils.py:101-114); its affine never rotates, so the warp
is an axis-aligned scale + translation, separable per axis: source
position ``src = a * dst + b``.  The JAX package builds one-hot or
two-tap interpolation matrices and multiplies them on the MXU.  Here:

  * **nearest** (six of the seven crops) is an index gather: the row and
    column source indices ``floor(a * j + b + 0.5)`` are computed once, in
    f32, on the host (``nearest_index``; on the card a contraction into an
    FMA could move a tie to the neighbouring pixel and part the CPU and
    GPU paths), then ``crop_nearest`` gathers on the batch's device.  A
    one-hot matmul selects the same values exactly, so the result is the
    JAX package's, bit for bit;
  * **bilinear** (the scale net's full image) is two f32 matmuls against
    the JAX package's two-tap matrices (``resize_matrix_np``), with TF32
    off (``eval.serving.build_posenet`` turns it off process-wide);
  * the numpy host mirrors (``crop_resize_affine_np``, ``resize_image_np``,
    ``crop_coord_2d_np``, the eval loader's) are copies;
  * the JAX package's public functions (``affine_crop_params``,
    ``resize_matrix``, ``crop_resize_affine``, ``get_2d_coord_grid``)
    keep their signatures and layouts and take and return tensors, built
    on the above: the coefficients and matrices in f32 on the host, the
    crop a gather (nearest) or the two matmuls (bilinear).

Out-of-image samples are 0 (cv2 BORDER_CONSTANT).
"""

from __future__ import annotations

import numpy as np
import torch


def affine_crop_params_np(center, scale, out_size: int):
    """Inverse-map line coefficients, f32: src = a * dst + b per axis.

    Derived from get_affine_transform with rot=0 (dataset_utils.py:116-157):
    dst = (src - center) * out/scale + out/2  =>  src = (dst - out/2) *
    scale/out + center.  ``scale`` is the square crop side; cv2 convention
    puts pixel centers at integer coordinates.
    """
    center = np.asarray(center, np.float32)
    a = np.asarray(scale, np.float32) / np.float32(out_size)
    half = np.float32(0.5 * out_size)
    return a, center[..., 0] - half * a, center[..., 1] - half * a


def nearest_src(a, b, out_size: int) -> np.ndarray:
    """cv2 INTER_NEAREST source positions of ``src = a * dst + b``,
    rounded half up, f32 (..., out); a, b: (...,) f32."""
    dst = np.arange(out_size, dtype=np.float32)
    src = (np.asarray(a, np.float32)[..., None] * dst
           + np.asarray(b, np.float32)[..., None])
    return np.floor(src + np.float32(0.5))


def nearest_index(a, b, out_size: int, src_size: int):
    """``nearest_src`` clamped into the source as int64, and whether each
    lies inside (bool), both (..., out)."""
    idx = nearest_src(a, b, out_size)
    inside = (idx >= 0) & (idx <= src_size - 1)
    return np.clip(idx, 0, src_size - 1).astype(np.int64), inside


def crop_nearest(imgs: torch.Tensor, rows, row_ok, cols, col_ok
                 ) -> torch.Tensor:
    """(B, H, W, C) -> (B, S, S, C): out[b, i, j] = imgs[b, rows[b, i],
    cols[b, j]] where both lie inside, else 0.  The tables are
    ``nearest_index``'s, (B, S), on the host or on ``imgs``' device."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    rows = torch.as_tensor(rows, device=dev)
    cols = torch.as_tensor(cols, device=dev)
    ok = (torch.as_tensor(row_ok, device=dev)[:, :, None]
          & torch.as_tensor(col_ok, device=dev)[:, None, :])
    base = torch.arange(b, device=dev)[:, None, None] * (h * w)
    flat = base + rows[:, :, None] * w + cols[:, None, :]
    out = imgs.reshape(b * h * w, c).index_select(0, flat.reshape(-1))
    out = out.reshape(b, *flat.shape[1:], c)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=dev))


def resize_matrix_np(src_size: int, out_size: int, a, b) -> np.ndarray:
    """(..., out, src) f32 bilinear matrix for src = a * dst + b, the JAX
    package's ``resize_matrix(..., "bilinear")``: the two taps of each
    output row, a tap outside the source dropped (zero border)."""
    dst = np.arange(out_size, dtype=np.float32)
    src = (np.asarray(a, np.float32)[..., None] * dst
           + np.asarray(b, np.float32)[..., None])
    grid = np.arange(src_size, dtype=np.float32)
    x0 = np.floor(src)
    frac = src - x0
    w0 = (grid == x0[..., None]).astype(np.float32) * (1 - frac)[..., None]
    w1 = (grid == (x0 + 1)[..., None]).astype(np.float32) * frac[..., None]
    return w0 + w1


def resize_bilinear(imgs: torch.Tensor, wy: torch.Tensor,
                    wx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 and (S, H), (S, W) matrices -> (B, S, S, C)."""
    out = torch.einsum("oh,bhwc->bowc", wy, imgs)
    return torch.einsum("pw,bowc->bopc", wx, out)


def _resample_axis_np(data: np.ndarray, src: np.ndarray, size: int,
                      axis: int, method: str) -> np.ndarray:
    """Gather-with-interpolation along one axis, mirroring resize_matrix.

    ``src`` holds f32 sample positions for each output index.  Nearest is
    an exact gather (identical to the one-hot matmul); bilinear combines
    the two taps in the same order the separable matmul reduces them, so
    host and device agree to f32 rounding.
    """
    if method == "nearest":
        idx = np.floor(src + np.float32(0.5))
        ok = (idx >= 0) & (idx <= size - 1)
        take = np.take(data, np.clip(idx, 0, size - 1).astype(np.int64),
                       axis=axis)
        shape = [1] * data.ndim
        shape[axis] = -1
        return take * ok.astype(np.float32).reshape(shape)
    if method == "bilinear":
        x0 = np.floor(src)
        frac = src - x0
        i0 = x0.astype(np.int64)
        i1 = i0 + 1
        ok0 = ((i0 >= 0) & (i0 < size)).astype(np.float32)
        ok1 = ((i1 >= 0) & (i1 < size)).astype(np.float32)
        t0 = np.take(data, np.clip(i0, 0, size - 1), axis=axis)
        t1 = np.take(data, np.clip(i1, 0, size - 1), axis=axis)
        shape = [1] * data.ndim
        shape[axis] = -1
        w0 = ((np.float32(1) - frac) * ok0).reshape(shape)
        w1 = (frac * ok1).reshape(shape)
        return t0 * w0 + t1 * w1
    raise ValueError(f"unknown method: {method}")


def crop_resize_affine_np(arr: np.ndarray, center, scale, out_size: int,
                          method: str = "nearest") -> np.ndarray:
    """Host-side mirror of crop_resize_affine (same f32 arithmetic).

    The eval loader serves crops through this function so the network
    sees the SAME resampling at train (device matmul) and eval (host
    numpy) — the reference uses one crop_resize_by_warp_affine both
    sides (tools/dataset_utils.py:101-114).  cv2.warpAffine is NOT
    equivalent: its fixed-point coordinate math rounds sample positions
    to 1/32 px, which flips nearest-neighbor picks by +-1 px and was
    measured to cost double-digit-degree eval rotation error on
    memorized scenes.
    """
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    arr = np.ascontiguousarray(arr, np.float32)
    h, w = arr.shape[:2]
    a = np.float32(scale) / np.float32(out_size)
    bx = np.float32(center[0]) - np.float32(0.5) * np.float32(out_size) * a
    by = np.float32(center[1]) - np.float32(0.5) * np.float32(out_size) * a
    dst = np.arange(out_size, dtype=np.float32)
    out = _resample_axis_np(arr, a * dst + by, h, 0, method)
    out = _resample_axis_np(out, a * dst + bx, w, 1, method)
    if squeeze:
        out = out[..., 0]
    return out


def resize_image_np(arr: np.ndarray, out_size: int) -> np.ndarray:
    """Host-side mirror of preprocess_batch's full-image bilinear resize
    (cv2.resize pixel-center mapping src = (dst+0.5)*a - 0.5, computed
    with the same f32 coefficients as the device matmul form)."""
    arr = np.ascontiguousarray(arr, np.float32)
    h, w = arr.shape[:2]
    dst = np.arange(out_size, dtype=np.float32)
    ay = np.float32(h / out_size)
    ax = np.float32(w / out_size)
    by = np.float32(0.5 * h / out_size - 0.5)
    bx = np.float32(0.5 * w / out_size - 0.5)
    out = _resample_axis_np(arr, ay * dst + by, h, 0, "bilinear")
    return _resample_axis_np(out, ax * dst + bx, w, 1, "bilinear")


def crop_coord_2d_np(center, scale, out_res: int, im_w: int,
                     im_h: int) -> np.ndarray:
    """Host-side mirror of data.preprocess.crop_coord_2d (closed-form
    nearest crop of the normalized pixel grid); returns (out,out,2),
    x in channel 0."""
    a = np.float32(scale) / np.float32(out_res)
    bx = np.float32(center[0]) - np.float32(0.5) * np.float32(out_res) * a
    by = np.float32(center[1]) - np.float32(0.5) * np.float32(out_res) * a
    j = np.arange(out_res, dtype=np.float32)
    sx = np.floor(a * j + bx + np.float32(0.5))
    sy = np.floor(a * j + by + np.float32(0.5))
    nx = (sx - (im_w - 1) / 2) / ((im_w - 1) / 2)
    ny = (sy - (im_h - 1) / 2) / ((im_h - 1) / 2)
    xx = np.broadcast_to(nx[None, :], (out_res, out_res))
    yy = np.broadcast_to(ny[:, None], (out_res, out_res))
    # cv2.warpAffine zero border (reference :285-287): an output cell
    # whose NEAREST source pixel falls outside the image gets (0,0),
    # not the extrapolated grid value — boundary crops (pad 1.5x) hit
    # this on most border objects
    valid = ((sx >= 0) & (sx <= im_w - 1))[None, :] \
        & ((sy >= 0) & (sy <= im_h - 1))[:, None]
    out = np.stack([xx, yy], axis=-1).astype(np.float32)
    return out * valid[:, :, None].astype(np.float32)


def _host_f32(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def affine_crop_params(center, scale, out_size: int):
    """``affine_crop_params_np`` on tensors: (a, bx, by), f32, on
    ``center``'s device (the CPU for arrays)."""
    dev = center.device if torch.is_tensor(center) else None
    return tuple(torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                 for v in affine_crop_params_np(_host_f32(center),
                                                _host_f32(scale), out_size))


def resize_matrix(src_size: int, out_size: int, a, b,
                  method: str = "bilinear",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., out_size, src_size) interpolation matrix for src = a*dst+b,
    the JAX package's ``resize_matrix``: one-hot rows of the rounded
    position (nearest; a row outside the source is zero) or the two taps
    of each row (bilinear; a tap outside is dropped).  Built in f32 on the
    host, returned as ``dtype`` on ``a``'s device."""
    a32, b32 = _host_f32(a), _host_f32(b)
    if method == "nearest":
        idx = nearest_src(a32, b32, out_size)
        grid = np.arange(src_size, dtype=np.float32)
        inb = (idx >= 0) & (idx <= src_size - 1)
        m = ((grid == idx[..., None]) & inb[..., None]).astype(np.float32)
    elif method == "bilinear":
        m = resize_matrix_np(src_size, out_size, a32, b32)
    else:
        raise ValueError(f"unknown method: {method}")
    dev = a.device if torch.is_tensor(a) else None
    return torch.from_numpy(m).to(device=dev, dtype=dtype)


def crop_resize_affine(img: torch.Tensor, center, scale, out_size: int,
                       method: str = "bilinear") -> torch.Tensor:
    """Crop-and-resize one image, matching crop_resize_by_warp_affine.

    Args:
      img: (H, W, C) or (H, W) tensor.
      center: (2,) crop center (x, y) in source pixels.
      scale: scalar square crop side in source pixels.
    Returns:
      (out_size, out_size, C) (or (out, out)) on ``img``'s device: the
      nearest crop by ``crop_nearest``, the bilinear one by
      ``resize_bilinear``.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    a, bx, by = affine_crop_params_np(_host_f32(center), _host_f32(scale),
                                      out_size)
    if method == "nearest":
        rows, row_ok = nearest_index(a, by, out_size, h)
        cols, col_ok = nearest_index(a, bx, out_size, w)
        out = crop_nearest(img[None], rows[None], row_ok[None], cols[None],
                           col_ok[None])[0]
    elif method == "bilinear":
        wy = resize_matrix(h, out_size, a, by, dtype=img.dtype)
        wx = resize_matrix(w, out_size, a, bx, dtype=img.dtype)
        out = resize_bilinear(img[None], wy.to(img.device),
                              wx.to(img.device))[0]
    else:
        raise ValueError(f"unknown method: {method}")
    return out[..., 0] if squeeze else out


def get_2d_coord_grid(width: int, height: int, norm: bool = True,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalized pixel grid, layout (2, H, W) with x first (reference
    tools/dataset_utils.py:8-30 get_2d_coord_np): values in [-1, 1] via
    (v - (n-1)/2) / ((n-1)/2)."""
    x = torch.arange(width, dtype=dtype)
    y = torch.arange(height, dtype=dtype)
    if norm:
        x = (x - (width - 1) / 2) / ((width - 1) / 2)
        y = (y - (height - 1) / 2) / ((height - 1) / 2)
    return torch.stack([x[None, :].expand(height, width),
                        y[:, None].expand(height, width)], dim=0)
