"""Result visualization without OpenCV or matplotlib.

Port of ``givepose_tpu/eval/visualize.py`` (reference tools/vis_utils.py +
evaluation/colormap.py subset used by the eval path): project 3D boxes
onto images, render NOCS maps, per-class colormap, and the eval's AP-curve
figure with its results pickle.  The card machine has neither OpenCV nor
matplotlib, so the module carries its own rasteriser:

  * ``line(img, p0, p1, color, thickness)`` is ``cv2.line`` (``LINE_8``):
    thickness 1 is OpenCV's clipped 8-connected Bresenham walk
    (``clipLine``, ``LineIterator``), bitwise; a thicker line is OpenCV's
    ``ThickLine``: the segment clipped to the image widened by the
    thickness, then a convex quadrilateral filled in 16-bit fixed point
    (``FillConvexPoly`` with its ``Line2`` edges) and a filled circle at
    each end, bitwise too;
  * ``plot_map_curves`` draws the three AP panels into an 800 x 350 RGB
    canvas (matplotlib's ``figsize=(8, 3.5)`` at 100 dpi) with the same
    axis ranges, grid, ``_CURVE_STYLE`` colours and dash patterns and
    legend, its text in a 5 x 7 bitmap font carried here, and writes it
    with ``data/png.imwrite``; the pickle is the JAX package's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from givepose_torch.eval.metrics import box_corners, transform_corners

# Detectron-style colormap head (reference evaluation/colormap.py)
_COLORS = np.array([
    [0.000, 0.447, 0.741], [0.850, 0.325, 0.098], [0.929, 0.694, 0.125],
    [0.494, 0.184, 0.556], [0.466, 0.674, 0.188], [0.301, 0.745, 0.933],
    [0.635, 0.078, 0.184], [0.300, 0.300, 0.300], [0.600, 0.600, 0.600],
    [1.000, 0.000, 0.000],
])


def class_color(cls_id: int) -> tuple[int, int, int]:
    c = (_COLORS[cls_id % len(_COLORS)] * 255).astype(int)
    return int(c[0]), int(c[1]), int(c[2])


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
              (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]

# ---------------------------------------------------------------------------
# cv2.line (imgproc/src/drawing.cpp), LINE_8, shift 0

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's ``clipLine`` on (width, height): the clipped end points, or
    None where the segment misses the rectangle.  ``int()`` of a float
    truncates toward zero, as C's (int64) cast of a double does."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line``: the 8-connected ``LineIterator`` walk, left to
    right, clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:                                    # leftToRight
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:                       # the diagonal step
            err += 2 * dx - 2 * dy
            x, y = x + sx, y + sy
        else:                             # the straight step
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += sx


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an edge in XY_SHIFT fixed point."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = XY_ONE
        y_step = _c_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = _c_div(dx << XY_SHIFT, ay | 1)
        y_step = XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _c_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _hline(img, y, x1, x2, color) -> None:
    img[y, x1:x2 + 1] = color


def _fill_convex_poly(img: np.ndarray, v, color, shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` for LINE_8: the outline by ``Line2``
    (``Line`` when ``shift`` is 0), then each row between the two edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0,
             "ye": ymin}]
    y = ymin
    delta1 = delta2 = XY_ONE >> 1
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _c_div((xe - xs) * 2 + (ty - y),
                                         2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's ``Circle`` with ``fill``: rows of the midpoint circle."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx),
                           (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy),
                           (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, color, thickness)`` (LINE_8, shift 0) in
    place on an (H, W, C) uint8 image; ``color`` has C entries."""
    color = np.asarray(color, img.dtype)
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    if thickness <= 1:
        _line8(img, p0, p1, color)
        return img
    # the segment clipped to the image widened by the thickness each side
    h, w = img.shape[:2]
    t = thickness
    clipped = clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t),
                        (p1[0] + t, p1[1] + t))
    if clipped is None:
        return img
    (x0, y0), (x1, y1) = clipped
    p0, p1 = (x0 - t, y0 - t), (x1 - t, y1 - t)
    q0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    q1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx = int(np.round(dy * r))      # cvRound: half to even
        ddy = int(np.round(dx * r))
        pts = [(q0[0] + ddx, q0[1] + ddy), (q0[0] - ddx, q0[1] - ddy),
               (q1[0] - ddx, q1[1] - ddy), (q1[0] + ddx, q1[1] + ddy)]
        _fill_convex_poly(img, pts, color, XY_SHIFT)
    radius = (thick + (XY_ONE >> 1)) >> XY_SHIFT
    for q in (q0, q1):
        _circle_filled(img, ((q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                             (q[1] + (XY_ONE >> 1)) >> XY_SHIFT), radius,
                       color)
    return img


# ---------------------------------------------------------------------------
# boxes and maps


def project_box(rt: np.ndarray, scale: np.ndarray,
                k: np.ndarray) -> np.ndarray:
    """(4,4) sRT + (3,) normalized extents -> (8,2) pixel corners."""
    corners = transform_corners(box_corners(scale), rt)     # (3, 8)
    proj = k @ corners
    return (proj[:2] / proj[2:3]).T


def draw_box(image: np.ndarray, rt: np.ndarray, scale: np.ndarray,
             k: np.ndarray, color=(0, 255, 0),
             thickness: int = 2) -> np.ndarray:
    """Draw a projected 3D box in place (reference draw_detections)."""
    pts = project_box(rt, scale, k).astype(int)
    for a, b in _BOX_EDGES:
        line(image, pts[a], pts[b], color, thickness)
    return image


def draw_results(image: np.ndarray, result: dict,
                 k: np.ndarray, draw_gt: bool = True) -> np.ndarray:
    """Overlay predicted (class-colored) and GT (green) boxes."""
    img = image.copy()
    if draw_gt:
        for rt, sc in zip(np.asarray(result["gt_RTs"]).reshape(-1, 4, 4),
                          np.asarray(result["gt_scales"]).reshape(-1, 3)):
            draw_box(img, rt, sc, k, color=(0, 255, 0), thickness=1)
    for rt, sc, cid in zip(
            np.asarray(result["pred_RTs"]).reshape(-1, 4, 4),
            np.asarray(result["pred_scales"]).reshape(-1, 3),
            np.asarray(result["pred_class_ids"]).reshape(-1)):
        draw_box(img, rt, sc, k, color=class_color(int(cid)))
    return img


def nocs_map_to_rgb(coor: np.ndarray) -> np.ndarray:
    """[-0.5, 0.5] NOCS map -> uint8 visualization."""
    return np.clip((np.asarray(coor) + 0.5) * 255, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the AP-curve figure

_CURVE_STYLE = [
    ("tab:blue", "-"), ("tab:orange", "-"), ("tab:green", "-"),
    ("tab:pink", "-"), ("tab:olive", "-"), ("tab:purple", "-"),
    ("tab:red", "--"), ("tab:gray", ":"),
]

# matplotlib's tab10 colours, RGB
TAB_COLORS = {
    "tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14),
    "tab:green": (44, 160, 44), "tab:red": (214, 39, 40),
    "tab:purple": (148, 103, 189), "tab:brown": (140, 86, 75),
    "tab:pink": (227, 119, 194), "tab:gray": (127, 127, 127),
    "tab:olive": (188, 189, 34), "tab:cyan": (23, 190, 207),
}

# dash patterns in pixels (on, off) at linewidth 1.5 and 100 dpi:
# matplotlib's '--' (3.7, 1.6) and ':' (1, 1.65) times the linewidth
_DASHES = {"-": None, "--": (7.7, 3.3), ":": (2.1, 3.4)}

FIG_W, FIG_H = 800, 350
_LEFT, _RIGHT, _TOP, _BOTTOM, _GAP = 64, 10, 28, 46, 20
PANEL_W = (FIG_W - _LEFT - _RIGHT - 2 * _GAP) // 3
PANEL_H = FIG_H - _TOP - _BOTTOM
GRID_RGB = (176, 176, 176)               # matplotlib's '#b0b0b0'

# 5 x 7 bitmap font: seven rows of five bits (bit 4 the leftmost column)
_FONT = {
    "0": "0E1113151911 0E", "1": "040C0404040 40E", "2": "0E110102040 81F",
    "3": "1F020402011 10E", "4": "02060A121F0 202", "5": "1F101E01011 10E",
    "6": "0608101E111 10E", "7": "1F010204080 808", "8": "0E11110E111 10E",
    "9": "0E11110F010 20C",
    "A": "0E11111F111 111", "B": "1E11111E111 11E", "C": "0E111010101 10E",
    "D": "1C121111111 21C", "E": "1F10101E101 01F", "F": "1F10101E101 010",
    "G": "0E111017111 10F", "H": "1111111F111 111", "I": "0E040404040 40E",
    "J": "07020202021 20C", "K": "11121418141 211", "L": "10101010101 01F",
    "M": "111B1515111 111", "N": "11111915131 111", "O": "0E111111111 10E",
    "P": "1E11111E101 010", "Q": "0E111111151 20D", "R": "1E11111E141 211",
    "S": "0F10100E010 11E", "T": "1F040404040 404", "U": "11111111111 10E",
    "V": "11111111110 A04", "W": "11111115151 50A", "X": "11110A040A1 111",
    "Y": "11110A04040 404", "Z": "1F010204081 01F",
    "a": "00000E010F1 10F", "b": "10101619111 11E", "c": "00000E101 0110E",
    "d": "01010D13111 10F", "e": "00000E111F1 00E", "f": "0609081C080 808",
    "g": "000F11110F0 10E", "h": "10101619111 111", "i": "04000C04040 40E",
    "j": "02000602021 20C", "k": "10101214181 412", "l": "0C040404040 40E",
    "m": "00001A15151 111", "n": "00001619111 111", "o": "00000E11111 10E",
    "p": "00001E111E1 010", "q": "00000D130F0 101", "r": "00001619101 010",
    "s": "00000E100E0 11E", "t": "08081C08080 906", "u": "00001111111 30D",
    "v": "00001111110 A04", "w": "00001111151 50A", "x": "0000110A040 A11",
    "y": "000011110F0 10E", "z": "00001F02040 81F",
    " ": "00000000000 000", ".": "00000000000 C0C", "-": "0000001F000 000",
    "_": "00000000000 01F", "%": "18190204081 303", ":": "000C0C000C0 C00",
    "(": "02040808080 402", ")": "08040202020 408", "/": "00010204081 000",
    "+": "0004041F040 400", ",": "00000000000 C04", "?": "0E110102040 004",
}


def _glyph(ch: str) -> np.ndarray:
    code = _FONT.get(ch, _FONT["?"]).replace(" ", "")
    rows = [int(code[2 * i:2 * i + 2], 16) for i in range(7)]
    return np.array([[(r >> (4 - c)) & 1 for c in range(5)] for r in rows],
                    bool)


def text_mask(text: str) -> np.ndarray:
    """(7, 6 * len - 1) bool mask of ``text`` in the bitmap font."""
    if not text:
        return np.zeros((7, 0), bool)
    out = np.zeros((7, 6 * len(text) - 1), bool)
    for i, ch in enumerate(text):
        out[:, 6 * i:6 * i + 5] = _glyph(ch)
    return out


def _blit(img, mask, x, y, color) -> None:
    """Set ``mask``'s pixels at top-left (x, y), clipped."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + mh, h), min(x + mw, w)
    if y1 <= y0 or x1 <= x0:
        return
    sub = mask[y0 - y:y1 - y, x0 - x:x1 - x]
    img[y0:y1, x0:x1][sub] = color


def _text(img, text, x, y, color=(0, 0, 0), anchor="tl",
          vertical=False) -> None:
    """Text with its anchor ('tl', 'tc', 'mr', 'mc') at (x, y); vertical
    text reads bottom to top."""
    mask = text_mask(text)
    if vertical:
        mask = np.rot90(mask)
    mh, mw = mask.shape
    if anchor[1] == "c":
        x -= mw // 2
    elif anchor[1] == "r":
        x -= mw
    if anchor[0] == "m":
        y -= mh // 2
    _blit(img, mask, x, y, color)


def panel_box(i: int) -> tuple[int, int, int, int]:
    """Panel ``i``'s plotting area in pixels: (left, top, width, height)."""
    return _LEFT + i * (PANEL_W + _GAP), _TOP, PANEL_W, PANEL_H


def to_pixel(value, lo: float, hi: float, start: int, length: int,
             flip: bool = False):
    """Data ``value`` on the axis range [lo, hi] -> pixel coordinate in
    [start, start + length - 1] (rows grow downward when ``flip``)."""
    f = (np.asarray(value, np.float64) - lo) / (hi - lo)
    if flip:
        f = 1.0 - f
    return start + f * (length - 1)


def auto_limits(values) -> tuple[float, float]:
    """matplotlib's autoscaled view: the data range widened by 5 % each
    side."""
    lo, hi = float(np.min(values)), float(np.max(values))
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def nice_ticks(lo: float, hi: float, max_ticks: int = 8) -> np.ndarray:
    """Ticks at a 1/2/2.5/5 x 10^k step inside [lo, hi] (matplotlib's
    AutoLocator steps), at most ``max_ticks``."""
    span = hi - lo
    for exp in range(-3, 6):
        for m in (1, 2, 2.5, 5):
            step = m * 10.0 ** exp
            first = np.ceil(lo / step - 1e-9) * step
            ticks = np.arange(first, hi + 1e-9 * span, step)
            if len(ticks) <= max_ticks:
                return ticks
    return np.array([lo, hi])


def _fmt_tick(t: float) -> str:
    return f"{t + 0.0:g}"            # + 0.0: no "-0" from a ceil


def _polyline(img, xs, ys, color, dashes, box) -> None:
    """A 2 px polyline, dashed by arc length, clipped to ``box``."""
    left, top, w, h = box
    pts = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64)],
                   1)
    seg = np.diff(pts, axis=0)
    lengths = np.hypot(seg[:, 0], seg[:, 1])
    pos = 0.0
    for (x0, y0), (dx, dy), n in zip(pts[:-1], seg, lengths):
        steps = max(int(np.ceil(n * 2)), 1)
        for s in np.arange(steps + 1) / steps:
            arc = pos + s * n
            if dashes is not None and arc % sum(dashes) >= dashes[0]:
                continue
            px = int(np.floor(x0 + s * dx))
            py = int(np.floor(y0 + s * dy))
            ya, yb = max(py, top), min(py + 2, top + h)
            xa, xb = max(px, left), min(px + 2, left + w)
            if ya < yb and xa < xb:
                img[ya:yb, xa:xb] = color
        pos += n


def render_map_curves(iou_aps: np.ndarray, pose_aps: np.ndarray,
                      iou_thres_list, degree_thres_list, shift_thres_list,
                      class_names=None) -> np.ndarray:
    """The three-panel AP-curve figure as an (FIG_H, FIG_W, 3) uint8 RGB
    array: AP vs 3D-IoU threshold, AP vs rotation threshold at the
    loosest shift, AP vs shift threshold at the loosest rotation.  Rows
    1..C-1 are the classes, row -1 the class mean."""
    from givepose_torch.eval.metrics import SYNSET_NAMES

    names = list(class_names or SYNSET_NAMES[1:]) + ["mean"]
    iou_t = np.asarray(iou_thres_list, np.float64)
    deg_t = np.asarray(degree_thres_list, np.float64)
    sft_t = np.asarray(shift_thres_list, np.float64)
    rows = list(range(1, iou_aps.shape[0] - 1)) + [iou_aps.shape[0] - 1]

    img = np.full((FIG_H, FIG_W, 3), 255, np.uint8)
    panels = [
        ("3D IoU", "Percent", (0.0, 100.0), 100 * iou_t,
         lambda r: 100 * iou_aps[r, :len(iou_t)]),
        ("Rotation", "Degree", auto_limits(deg_t), deg_t,
         lambda r: 100 * pose_aps[r, :len(deg_t), -1]),
        ("Translation", "Centimeter", auto_limits(sft_t), sft_t,
         lambda r: 100 * pose_aps[r, -1, :len(sft_t)]),
    ]
    for i, (title, xlabel, (xlo, xhi), xs, ys_of) in enumerate(panels):
        box = left, top, w, h = panel_box(i)
        for t in nice_ticks(xlo, xhi):                      # grid, ticks
            px = int(round(float(to_pixel(t, xlo, xhi, left, w))))
            img[top:top + h, px] = GRID_RGB
            img[top + h:top + h + 4, px] = 0
            _text(img, _fmt_tick(t), px, top + h + 6, anchor="tc")
        for t in nice_ticks(0.0, 100.0):
            py = int(round(float(to_pixel(t, 0.0, 100.0, top, h, True))))
            img[py, left:left + w] = GRID_RGB
            img[py, left - 4:left] = 0
            if i == 0:
                _text(img, _fmt_tick(t), left - 6, py, anchor="mr")
        for j, row in enumerate(rows):                      # curves
            color, style = _CURVE_STYLE[j % len(_CURVE_STYLE)]
            px = to_pixel(xs, xlo, xhi, left, w)
            py = to_pixel(ys_of(row), 0.0, 100.0, top, h, True)
            _polyline(img, px, py, TAB_COLORS[color], _DASHES[style], box)
        img[top, left:left + w] = 0                         # spines
        img[top + h - 1, left:left + w] = 0
        img[top:top + h, left] = 0
        img[top:top + h, left + w - 1] = 0
        _text(img, title, left + w // 2, top - 12, anchor="tc")
        _text(img, xlabel, left + w // 2, top + h + 22, anchor="tc")
    left, top, w, h = panel_box(0)
    _text(img, "Average Precision", 8, top + h // 2, anchor="ml",
          vertical=True)

    # legend, lower right of the translation panel
    left, top, w, h = panel_box(2)
    labels = [names[j] if j < len(names) else f"cls{row}"
              for j, row in enumerate(rows)]
    lw = 30 + 6 * max(len(s) for s in labels)
    lh = 6 + 11 * len(labels)
    x0, y0 = left + w - lw - 6, top + h - lh - 6
    img[y0:y0 + lh, x0:x0 + lw] = 255
    img[y0, x0:x0 + lw] = img[y0 + lh - 1, x0:x0 + lw] = (204, 204, 204)
    img[y0:y0 + lh, x0] = img[y0:y0 + lh, x0 + lw - 1] = (204, 204, 204)
    for j, label in enumerate(labels):
        color, style = _CURVE_STYLE[j % len(_CURVE_STYLE)]
        cy = y0 + 8 + 11 * j
        _polyline(img, [x0 + 4, x0 + 22], [cy, cy], TAB_COLORS[color],
                  _DASHES[style], (x0, y0, lw, lh))
        _text(img, label, x0 + 26, cy, anchor="ml")
    return img


def plot_map_curves(iou_aps: np.ndarray, pose_aps: np.ndarray,
                    out_dir: str, iou_thres_list, degree_thres_list,
                    shift_thres_list, class_names=None,
                    save_pkl: bool = True) -> str:
    """Three-panel AP-curve figure + results pickle.

    Reference behavior: evaluation/eval_utils.py:467-515 (plot_mAP) plus
    the mAP_Acc.pkl dump at :452-464.  ``mAP.png`` is
    ``render_map_curves`` written by ``data/png.py``; ``mAP_Acc.pkl``
    holds what the JAX package's holds.  Returns the path of the PNG."""
    from givepose_torch.data import png

    img = render_map_curves(iou_aps, pose_aps, iou_thres_list,
                            degree_thres_list, shift_thres_list,
                            class_names)
    png_path = os.path.join(out_dir, "mAP.png")
    png.imwrite(png_path, np.ascontiguousarray(img[:, :, ::-1]))

    if save_pkl:
        with open(os.path.join(out_dir, "mAP_Acc.pkl"), "wb") as f:
            pickle.dump({
                "iou_thres_list": list(iou_thres_list),
                "degree_thres_list": list(degree_thres_list),
                "shift_thres_list": list(shift_thres_list),
                "iou_aps": iou_aps,
                "pose_aps": pose_aps,
            }, f)
    return png_path
