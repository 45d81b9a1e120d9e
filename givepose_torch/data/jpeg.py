"""JPEG reading without OpenCV or PIL.

The JAX package reads Wild6D's frames with ``cv2.imread``; the port must
run where neither OpenCV nor PIL is installed, so it carries this
decoder:

  * ``imread(path)`` returns what ``cv2.imread(path)`` returns, bitwise:
    (H, W, 3) uint8 BGR, a gray file as three equal channels, turned as
    its EXIF orientation tag says (APP1, tag 0x0112);
  * ``imread(path, unchanged=True)`` returns what ``cv2.imread(path,
    cv2.IMREAD_UNCHANGED)`` returns: the orientation tag ignored, a gray
    file as (H, W);
  * both return None for a missing file or one cv2 would not decode.

Scope: baseline and extended-sequential Huffman files, 8-bit, with 1 or
3 components (YCbCr, or RGB where an Adobe marker or the component ids
say so), any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1), one interleaved scan or one scan per component, restart
intervals, and sizes that are not a multiple of the MCU.  Progressive,
arithmetic-coded, lossless, 12-bit and CMYK files raise
``NotImplementedError`` (ROADMAP queue A, item 14).

The markers are parsed here; the entropy decoding, the ISLOW inverse
DCT, the upsampling and the colour conversion run in a small C++ library
(``csrc/jpeg_decode.cpp``) that g++ builds at first use
(``ops/_build.py`` ``build_host``), with libjpeg-turbo's integer
arithmetic, which is what OpenCV decodes with.  If it cannot be built,
decoding raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from givepose_torch.ops import _build

SOI = b"\xff\xd8"

# jpeg_natural_order: zigzag index -> row-major index
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded "
    "progressive", 0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-"
    "coded differential sequential", 0xCE: "arithmetic-coded differential "
    "progressive", 0xCF: "arithmetic-coded differential lossless"}

_ROADMAP = "ROADMAP queue A, item 14"


class _Undecodable(Exception):
    """A file cv2 would not decode (imread returns None)."""


def _lib() -> ctypes.CDLL:
    lib = _build.load_host_library(_build.CSRC_DIR / "jpeg_decode.cpp")
    if lib.jpeg_decode_scan.restype is not ctypes.c_int64:
        lib.jpeg_decode_scan.restype = ctypes.c_int64
        lib.jpeg_decode_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.jpeg_reconstruct.restype = ctypes.c_int32
        lib.jpeg_reconstruct.argtypes = [ctypes.c_void_p] * 4
    return lib


def _segments(data: bytes):
    """(marker, payload start, payload end) of each marker segment up to
    the first SOS (inclusive); then the caller takes over."""
    if data[:2] != SOI:
        raise _Undecodable("not a JPEG")
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                      # libjpeg skips garbage, warning
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise _Undecodable("no EOI")
        marker = data[pos]
        pos += 1
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            yield marker, pos, pos
            continue
        if marker == 0xD9:
            yield marker, pos, pos
            return
        if pos + 2 > len(data):
            raise _Undecodable("truncated segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        end = pos + length
        if length < 2 or end > len(data):
            raise _Undecodable("truncated segment")
        pos = yield marker, pos + 2, end
        if pos is None:
            pos = end


def exif_orientation(payload: bytes) -> int:
    """The orientation tag (1..8) of an APP1 Exif payload, else 1."""
    if payload[:6] != b"Exif\x00\x00" or len(payload) < 14:
        return 1
    tiff = payload[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, typ = struct.unpack(order + "HH", entry[:4])
            if tag == 0x0112 and typ == 3:
                (value,) = struct.unpack(order + "H", entry[8:10])
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def _huffman_table(payload: bytes, pos: int):
    if pos + 17 > len(payload):
        raise _Undecodable("bad DHT")
    tc_th = payload[pos]
    bits = np.zeros(17, np.uint16)
    bits[1:] = np.frombuffer(payload[pos + 1:pos + 17], np.uint8)
    n = int(bits.sum())
    if n > 256 or pos + 17 + n > len(payload):
        raise _Undecodable("bad DHT")
    vals = np.zeros(256, np.uint16)
    vals[:n] = np.frombuffer(payload[pos + 17:pos + 17 + n], np.uint8)
    return tc_th >> 4, tc_th & 15, np.concatenate([bits, vals]), pos + 17 + n


def decode(data: bytes) -> tuple[np.ndarray, int, int]:
    """(BGR (H, W, 3) uint8, number of components, EXIF orientation)."""
    lib = _lib()
    quant = [None] * 4
    huff = np.zeros((8, 273), np.uint16)
    restart = 0
    frame = None
    jfif = adobe = False
    adobe_transform = 1
    orientation = 1
    coefs = []
    segments = _segments(data)
    send = None
    while True:
        try:
            marker, start, end = segments.send(send)
        except StopIteration:
            break
        send = None
        payload = data[start:end]
        if marker == 0xE0 and payload[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and orientation == 1:
            orientation = exif_orientation(payload)
        elif marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe, adobe_transform = True, payload[11]
        elif marker == 0xDB:
            pos = 0
            while pos < len(payload):
                pq, tq = payload[pos] >> 4, payload[pos] & 15
                size = 128 if pq else 64
                if tq > 3 or pos + 1 + size > len(payload):
                    raise _Undecodable("bad DQT")
                raw = np.frombuffer(payload[pos + 1:pos + 1 + size],
                                    ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[_NATURAL] = raw
                quant[tq] = table
                pos += 1 + size
        elif marker == 0xC4:
            pos = 0
            while pos < len(payload):
                tc, th, table, pos = _huffman_table(payload, pos)
                if tc > 1 or th > 3:
                    raise _Undecodable("bad DHT")
                huff[4 * tc + th] = table
        elif marker == 0xDD:
            if len(payload) != 2:
                raise _Undecodable("bad DRI")
            (restart,) = struct.unpack(">H", payload)
        elif marker in _UNSUPPORTED:
            raise NotImplementedError(
                f"{_UNSUPPORTED[marker]} JPEG files are not decoded by the "
                f"port ({_ROADMAP})")
        elif marker == 0xCC:
            raise NotImplementedError(
                f"arithmetic-coded JPEG files are not decoded by the port "
                f"({_ROADMAP})")
        elif marker in (0xC0, 0xC1):
            frame = _frame(payload)
            coefs = [np.zeros((c["bh"], c["bw"], 64), np.int16)
                     for c in frame["comps"]]
        elif marker == 0xDA:
            if frame is None:
                raise _Undecodable("SOS before SOF")
            send = _scan(lib, data, end, payload, frame, huff, restart,
                         coefs)
        elif marker == 0xD9:
            break
    if frame is None or frame.get("scans", 0) == 0:
        raise _Undecodable("no frame or no scan")
    comps = frame["comps"]
    if len(comps) == 1:
        transform = 0
    elif jfif:
        transform = 1
    elif adobe:
        transform = 2 if adobe_transform == 0 else 1
    else:
        ids = [c["id"] for c in comps]
        transform = 2 if ids == [82, 71, 66] else 1
    for c in comps:
        if quant[c["tq"]] is None:
            raise _Undecodable("missing quantization table")
    header = [len(comps), frame["width"], frame["height"], frame["hmax"],
              frame["vmax"], transform]
    for c in comps:
        header += [c["h"], c["v"], c["bw"], c["bh"]]
    header = np.asarray(header, np.int32)
    qt = np.stack([quant[c["tq"]] for c in comps])
    out = np.empty((frame["height"], frame["width"], 3), np.uint8)
    ptrs = (ctypes.c_void_p * len(coefs))(*[c.ctypes.data for c in coefs])
    if lib.jpeg_reconstruct(header.ctypes.data, ptrs, qt.ctypes.data,
                            out.ctypes.data):
        raise _Undecodable("fractional sampling factors")
    return out, len(comps), orientation


def _frame(payload: bytes) -> dict:
    if len(payload) < 6:
        raise _Undecodable("bad SOF")
    precision, height, width, ncomp = struct.unpack(">BHHB", payload[:6])
    if precision != 8:
        raise NotImplementedError(
            f"{precision}-bit JPEG files are not decoded by the port "
            f"({_ROADMAP})")
    if ncomp not in (1, 3):
        raise NotImplementedError(
            f"JPEG files with {ncomp} components are not decoded by the "
            f"port ({_ROADMAP})")
    if height == 0 or width == 0:
        raise _Undecodable("zero size (DNL) frame")
    if len(payload) < 6 + 3 * ncomp:
        raise _Undecodable("bad SOF")
    comps = []
    for i in range(ncomp):
        cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4 and tq <= 3):
            raise _Undecodable("bad component")
        comps.append({"id": cid, "h": h, "v": v, "tq": tq})
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    for c in comps:
        c["bw"], c["bh"] = mcus_x * c["h"], mcus_y * c["v"]
        # the component's own size in blocks (a non-interleaved scan's)
        comp_w = -(-width * c["h"] // hmax)
        comp_h = -(-height * c["v"] // vmax)
        c["bx"], c["by"] = -(-comp_w // 8), -(-comp_h // 8)
    return {"width": width, "height": height, "hmax": hmax, "vmax": vmax,
            "mcus_x": mcus_x, "mcus_y": mcus_y, "comps": comps, "scans": 0}


def _scan(lib, data: bytes, start: int, payload: bytes, frame: dict,
          huff: np.ndarray, restart: int, coefs: list) -> int:
    """Decode one scan into ``coefs``; the position after its data."""
    ns = payload[0] if payload else 0
    if not 1 <= ns <= len(frame["comps"]):
        raise _Undecodable(f"a scan of {ns} components")
    if len(payload) < 4 + 2 * ns:
        raise _Undecodable("bad SOS")
    ids = [c["id"] for c in frame["comps"]]
    spec = [ns, restart, frame["mcus_x"], frame["mcus_y"]]
    for i in range(ns):
        cid, tables = payload[1 + 2 * i], payload[2 + 2 * i]
        if cid not in ids:
            raise _Undecodable("scan names an unknown component")
        ci = ids.index(cid)
        c = frame["comps"][ci]
        spec += [ci, c["h"], c["v"], c["bw"], tables >> 4, tables & 15,
                 c["bx"], c["by"]]
    ss, se, ahal = payload[1 + 2 * ns:4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise NotImplementedError(
            f"a JPEG scan with spectral selection {ss}..{se} is not "
            f"decoded by the port ({_ROADMAP})")
    spec = np.asarray(spec, np.int32)
    ptrs = (ctypes.c_void_p * len(coefs))(*[c.ctypes.data for c in coefs])
    end = lib.jpeg_decode_scan(data, len(data), start, spec.ctypes.data,
                               huff.ctypes.data, ptrs)
    if end < 0:
        raise _Undecodable("bad Huffman table index")
    frame["scans"] += 1
    return int(end)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform for orientation tags 2..8."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    t = img.transpose(1, 0, 2)
    if orientation == 5:
        return t
    if orientation == 6:
        return t[:, ::-1]
    if orientation == 7:
        return t[::-1, ::-1]
    if orientation == 8:
        return t[::-1]
    return img


def imread(path: str, unchanged: bool = False) -> np.ndarray | None:
    """``cv2.imread(path)`` (``cv2.IMREAD_UNCHANGED`` with ``unchanged``)
    of a JPEG file; None for a file that cannot be read or that the
    decoder finds malformed.  Any other error (the host library does not
    build or load, a fault of the decoder itself) propagates."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        img, ncomp, orientation = decode(data)
    except _Undecodable:
        return None
    if unchanged:
        return np.ascontiguousarray(img[:, :, 0]) if ncomp == 1 else img
    return np.ascontiguousarray(_orient(img, orientation))
