"""PNG reading and writing without OpenCV or PIL.

The JAX package reads and writes every PNG of the dataset through
``cv2.imread`` / ``cv2.imwrite``; the port's data path must run where
neither OpenCV nor PIL is installed, so it carries this codec:

  * ``imread(path)`` returns what ``cv2.imread(path)`` returns: (H, W, 3)
    uint8 BGR; alpha dropped (not composited); gray and palette images
    expanded to three channels; 1-, 2- and 4-bit gray scaled to 0..255;
    16-bit samples cut to their high byte;
  * ``imread(path, unchanged=True)`` returns what
    ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns: gray as (H, W),
    color as BGR, BGRA where the file has alpha (gray + alpha, RGBA) or a
    tRNS chunk on an RGB or palette image, 16-bit files as uint16;
  * both return None for a missing or undecodable file, as cv2 does, and
    raise on an interlaced file, which the port does not decode;
  * ``imwrite(path, img)`` writes (H, W) gray, (H, W, 3) BGR or
    (H, W, 4) BGRA, uint8 or uint16, with filter-0 rows through zlib.

Inflation is Python's ``zlib``.  The row filters (Sub, Up, Average,
Paeth) are recurrences along a row; they run in a small C++ library
(``csrc/png_unfilter.cpp``) that g++ builds at first use
(``ops/_build.py`` ``build_host``).  If it cannot be built, decoding
raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from givepose_torch.ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


class _Undecodable(Exception):
    """A file cv2 would not decode (imread returns None)."""


def _unfilter_lib() -> ctypes.CDLL:
    lib = _build.load_host_library(_build.CSRC_DIR / "png_unfilter.cpp")
    fn = lib.png_unfilter
    if fn.restype is not ctypes.c_int64:
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64]
    return lib


def _chunks(data: bytes):
    """(type, payload) of each chunk; a critical chunk with a bad CRC is
    undecodable, an ancillary one is skipped (libpng's defaults)."""
    if data[:8] != SIGNATURE:
        raise _Undecodable("not a PNG")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise _Undecodable("truncated chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        pos = end + 4
        if zlib.crc32(ctype + payload) != crc:
            if ctype[:1].isupper():
                raise _Undecodable(f"bad CRC in {ctype!r}")
            continue
        yield ctype, payload
        if ctype == b"IEND":
            return
    raise _Undecodable("no IEND")


def _decode(data: bytes) -> dict:
    """The file's samples at their own depth, (H, W, channels), with its
    header, palette and tRNS."""
    header = plte = trns = None
    idat = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise _Undecodable("bad IHDR")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise _Undecodable("no IHDR or IDAT")
    width, height, depth, ctype, comp, filt, interlace = header
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp
            or filt or width == 0 or height == 0):
        raise _Undecodable(f"bad IHDR {header}")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if ctype == 3 and plte is None:
        raise _Undecodable("palette image without PLTE")
    channels = _CHANNELS[ctype]
    bits = width * channels * depth
    rowbytes = (bits + 7) // 8
    bpp = max(1, channels * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise _Undecodable(str(e)) from e
    if len(raw) < height * (rowbytes + 1):
        raise _Undecodable("short image data")
    raw = np.frombuffer(raw, np.uint8)
    rows = np.empty(height * rowbytes, np.uint8)
    bad = _unfilter_lib().png_unfilter(raw.ctypes.data, rows.ctypes.data,
                                       height, rowbytes, bpp)
    if bad:
        raise _Undecodable(f"bad filter type on row {bad - 1}")
    rows = rows.reshape(height, rowbytes)
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        samples = samples.reshape(height, rowbytes * per_byte)
    samples = samples[:, :width * channels].reshape(height, width, channels)
    return {"samples": samples, "depth": depth, "color_type": ctype,
            "palette": plte, "trns": trns}


def _transform(d: dict, unchanged: bool) -> np.ndarray:
    """cv2's libpng transforms (grfmt_png.cpp ``readData``)."""
    s, depth, ctype, trns = (d["samples"], d["depth"], d["color_type"],
                             d["trns"])
    has_trns = trns is not None and len(trns) > 0
    if ctype in (4, 6):
        out_ch = 4
    elif ctype in (2, 3):
        out_ch = 4 if has_trns else 3
    else:
        out_ch = 1
    if not unchanged:
        out_ch = 3
    keep16 = unchanged and depth == 16
    if ctype == 3:
        idx = s[..., 0].astype(np.intp)
        pal = d["palette"]
        if idx.max(initial=0) >= len(pal):
            raise _Undecodable("palette index out of range")
        rgb = pal[idx]
        alpha = np.full(len(pal), 255, np.uint8)
        if has_trns:
            t = np.frombuffer(trns, np.uint8)[:len(pal)]
            alpha[:len(t)] = t
        a = alpha[idx]
        color = rgb[..., ::-1]
    else:
        if depth == 16 and not keep16:
            s = (s >> 8).astype(np.uint8)
        elif depth < 8:
            s = (s * _GRAY_SCALE[depth]).astype(np.uint8)
        if ctype in (0, 4):
            color = np.repeat(s[..., :1], 3, axis=2)
        else:
            color = s[..., 2::-1]
        if ctype in (4, 6):
            a = s[..., -1]
        else:
            a = None
            if ctype == 2 and out_ch == 4:
                # tRNS names one color transparent (alpha 0, else opaque)
                key = np.frombuffer(trns[:6], ">u2").astype(s.dtype)
                hit = (s == key).all(axis=2)
                a = np.where(hit, 0, np.iinfo(s.dtype).max).astype(s.dtype)
    if out_ch == 1:
        return np.ascontiguousarray(color[..., 0])
    if out_ch == 3:
        return np.ascontiguousarray(color)
    return np.ascontiguousarray(np.concatenate([color, a[..., None]],
                                               axis=2))


def imread(path: str, unchanged: bool = False) -> np.ndarray | None:
    """``cv2.imread(path)``, or with ``unchanged`` ``cv2.imread(path, -1)``."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        return _transform(_decode(data), unchanged)
    except _Undecodable:
        return None


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def imwrite(path: str, img: np.ndarray) -> bool:
    """Write (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, uint8 or uint16,
    as ``cv2.imwrite`` reads them; rows unfiltered, zlib level 1 (cv2's
    default)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        px = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w = px.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(px.astype(">u2") if depth == 16 else px)
    rows = rows.view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    data = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return True
