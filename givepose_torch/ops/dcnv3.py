"""DCNv3 deformable sampling: the plain PyTorch version.

Port of ``givepose_tpu/ops/dcnv3.py``.  Per output pixel and group, K*K
bilinear taps are sampled at (reference grid + dilation grid + learned
offsets) * offset_scale, weighted by a softmax mask and summed.  This file
is the specification the CUDA kernel (``ops/dcnv3_cuda.py``) is held
against, and the path CPU tensors take.  It is the gather formulation:
four ``torch.gather`` calls and a weighted sum, differentiable through
input, offsets and mask.  ``dcnv3_core_bwd`` is its backward through
autograd: the plain version of the backward kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def dcnv3_sampling_locations(offset: torch.Tensor, h_in: int, w_in: int,
                             kernel: int, stride: int, dilation: int,
                             group: int, offset_scale: float) -> torch.Tensor:
    """Absolute sampling coordinates in padded-input pixel space.

    Args:
      offset: (N, H_out, W_out, G*P*2), last dim ordered (g, p, xy).
      h_in/w_in: padded input spatial dims.

    Returns:
      (N, H_out, W_out, G, P, 2) pixel-space (x, y) positions, where an
      integer coordinate addresses a texel centre (grid_sample
      align_corners=False convention).
    """
    n, h_out, w_out, _ = offset.shape
    p = kernel * kernel
    half = (dilation * (kernel - 1)) // 2

    ref_y = half + 0.5 + stride * np.arange(h_out, dtype=np.float32)
    ref_x = half + 0.5 + stride * np.arange(w_out, dtype=np.float32)

    # dilation grid: x varies slowly, y fast (meshgrid 'ij' of (x, y))
    lin = np.linspace(-half, -half + (kernel - 1) * dilation, kernel,
                      dtype=np.float32)
    gx = np.repeat(lin, kernel)
    gy = np.tile(lin, kernel)

    base = np.zeros((h_out, w_out, p, 2), np.float32)
    base[..., 0] = ref_x[None, :, None] + gx[None, None, :] * offset_scale
    base[..., 1] = ref_y[:, None, None] + gy[None, None, :] * offset_scale
    base_t = torch.from_numpy(base[None, :, :, None]).to(offset.device)

    off = offset.reshape(n, h_out, w_out, group, p, 2)
    loc = base_t + off * offset_scale
    return loc - 0.5


def clamp_to_window(loc: torch.Tensor, h_out: int, w_out: int, kernel: int,
                    stride: int, dilation: int, window: int) -> torch.Tensor:
    """Clamp (N, Ho, Wo, G, P, 2) locations to ``centre +- window`` px."""
    half = (dilation * (kernel - 1)) // 2
    cy = torch.from_numpy(half + stride * np.arange(h_out, dtype=np.float32))
    cx = torch.from_numpy(half + stride * np.arange(w_out, dtype=np.float32))
    cx = cx.to(loc.device)[None, None, :, None, None]
    cy = cy.to(loc.device)[None, :, None, None, None]
    return torch.stack([torch.clamp(loc[..., 0], cx - window, cx + window),
                        torch.clamp(loc[..., 1], cy - window, cy + window)],
                       dim=-1)


def _bilinear_gather(x_flat: torch.Tensor, ix: torch.Tensor,
                     iy: torch.Tensor, h_in: int, w_in: int) -> torch.Tensor:
    """Zero-padded bilinear sample.

    x_flat (N, G, H_in*W_in, C); ix, iy (N, G, Q) -> (N, G, Q, C).
    """
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx1 = ix - x0
    wy1 = iy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    c = x_flat.shape[-1]

    def corner(xc, yc, w):
        inb = (xc >= 0) & (xc < w_in) & (yc >= 0) & (yc < h_in)
        xi = torch.clamp(xc, 0, w_in - 1).long()
        yi = torch.clamp(yc, 0, h_in - 1).long()
        idx = (yi * w_in + xi)[..., None].expand(-1, -1, -1, c)
        g = torch.gather(x_flat, 2, idx)
        return g * (w * inb.to(x_flat.dtype))[..., None]

    return (corner(x0, y0, wx0 * wy0)
            + corner(x0 + 1, y0, wx1 * wy0)
            + corner(x0, y0 + 1, wx0 * wy1)
            + corner(x0 + 1, y0 + 1, wx1 * wy1))


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               kernel: int = 3, stride: int = 1, pad: int = 1,
               dilation: int = 1, group: int = 4,
               group_channels: int | None = None,
               offset_scale: float = 1.0, window: int = 0) -> torch.Tensor:
    """DCNv3 forward (NHWC), differentiable.

    Args:
      x: (N, H, W, G*C) input (after the module's input projection).
      offset: (N, H_out, W_out, G*P*2).
      mask: (N, H_out, W_out, G*P), already softmaxed over P per group.
      window: if > 0, clamp sampling to ``centre +- window`` per query.

    Returns:
      (N, H_out, W_out, G*C) in x's dtype.
    """
    n, h, w, c_total = x.shape
    if group_channels is None:
        group_channels = c_total // group
    p = kernel * kernel
    _, h_out, w_out, _ = offset.shape

    x_pad = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    h_in, w_in = h + 2 * pad, w + 2 * pad

    loc = dcnv3_sampling_locations(offset, h_in, w_in, kernel, stride,
                                   dilation, group, offset_scale)
    if window > 0:
        loc = clamp_to_window(loc, h_out, w_out, kernel, stride, dilation,
                              window)
    q = h_out * w_out * p
    ix = loc[..., 0].permute(0, 3, 1, 2, 4).reshape(n, group, q)
    iy = loc[..., 1].permute(0, 3, 1, 2, 4).reshape(n, group, q)

    x_flat = (x_pad.reshape(n, h_in * w_in, group, group_channels)
              .permute(0, 2, 1, 3))                       # (N, G, S, C)
    sampled = _bilinear_gather(x_flat, ix, iy, h_in, w_in)
    sampled = sampled.reshape(n, group, h_out * w_out, p, group_channels)

    m = mask.reshape(n, h_out * w_out, group, p).permute(0, 2, 1, 3)
    out = torch.einsum("ngqpc,ngqp->ngqc", sampled, m)
    return (out.permute(0, 2, 1, 3)
            .reshape(n, h_out, w_out, group * group_channels))


def dcnv3_core_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   grad_out: torch.Tensor, kernel: int = 3, stride: int = 1,
                   pad: int = 1, dilation: int = 1, group: int = 4,
                   offset_scale: float = 1.0, window: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (d_x, d_offset, d_mask), all f32, of ``dcnv3_core`` on
    ``x.float()``, offset and mask against ``grad_out`` (N,Ho,Wo,G*C).

    The semantics of autograd through ``dcnv3_core``: ``floor`` has zero
    gradient, so the fractional part passes d(location) straight through;
    a corner outside the padded input contributes neither value nor
    gradient, and gradient landing in the pad band is dropped."""
    with torch.enable_grad():
        xs = x.detach().float().requires_grad_(True)
        offs = offset.detach().float().requires_grad_(True)
        ms = mask.detach().float().requires_grad_(True)
        out = dcnv3_core(xs, offs, ms, kernel=kernel, stride=stride,
                         pad=pad, dilation=dilation, group=group,
                         offset_scale=offset_scale, window=window)
        d_x, d_off, d_m = torch.autograd.grad(out, (xs, offs, ms),
                                              grad_out.float())
    return d_x, d_off, d_m
