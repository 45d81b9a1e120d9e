"""Bbox helpers (reference tools/eval_utils.py:157-249).

get_bbox_square snaps the crop window to 40-px quanta and clamps it inside
the frame (used by depth-based pipelines); get_real_hw clips the bbox to
the image before measuring.

Copy of ``givepose_tpu/data/bbox_utils.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def get_bbox_square(bbox, img_h: int = 480, img_w: int = 640):
    """(y1,x1,y2,x2) -> (rmin, rmax, cmin, cmax) square window."""
    y1, x1, y2, x2 = bbox
    window = (max(y2 - y1, x2 - x1) // 40 + 1) * 40
    window = min(window, 440)
    cy, cx = (y1 + y2) // 2, (x1 + x2) // 2
    rmin, rmax = cy - window // 2, cy + window // 2
    cmin, cmax = cx - window // 2, cx + window // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return rmin, rmax, cmin, cmax


def get_real_hw(bbox, img_h: int = 480, img_w: int = 640):
    """Clipped (w, h) of a (y1,x1,y2,x2) bbox."""
    y1, x1, y2, x2 = bbox
    y1, x1 = max(0, y1), max(0, x1)
    y2, x2 = min(img_h, y2), min(img_w, x2)
    return x2 - x1, y2 - y1


def bbox_iou_2d(a, b) -> float:
    """(y1,x1,y2,x2) IoU (reference calculate_iou)."""
    ay1, ax1, ay2, ax2 = a
    by1, bx1, by2, bx2 = b
    iy1, ix1 = max(ay1, by1), max(ax1, bx1)
    iy2, ix2 = min(ay2, by2), min(ax2, bx2)
    if iy2 <= iy1 or ix2 <= ix1:
        return 0.0
    inter = (iy2 - iy1) * (ix2 - ix1)
    union = ((ay2 - ay1) * (ax2 - ax1)
             + (by2 - by1) * (bx2 - bx1) - inter)
    return inter / union
