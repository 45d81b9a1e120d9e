"""``givepose_torch/data/jpeg.py`` against ``cv2.imread``, bitwise.

OpenCV decodes with libjpeg-turbo (3.1.2 on the box these tests were
written on, ``cv2.getBuildInformation()``), whose decode path is integer
arithmetic throughout: the ISLOW inverse DCT, the fancy upsamplers and the
fixed-point YCbCr tables.  So the bar is equality, on files cv2 writes in
the test (every sampling, sizes that are not a multiple of the MCU, gray,
restart markers, optimized Huffman tables, qualities 5 and 100), on the
committed fixtures of ``tests/data/jpeg`` (whose digests
``chip_smoke.py`` checks on the card machine, which has no OpenCV), and
with an EXIF orientation tag spliced into a file.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from givepose_torch.data import jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "jpeg")
SAMPLINGS = ("444", "422", "420", "440", "411")
SIZES = ((480, 640), (37, 53), (1, 1), (2, 3), (17, 9))


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) % 256], -1).astype(np.float64)
    return np.clip(base + rng.normal(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


def both(path: str, unchanged: bool = False):
    flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
    return jpeg.imread(path, unchanged=unchanged), cv2.imread(path, flag)


def assert_same(got, ref):
    assert got is not None and ref is not None
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_sampling_and_sizes_equal_cv2(tmp_path, sampling):
    """Every size at this sampling; 480 x 640 is REAL275's and Wild6D's."""
    factor = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{h}x{w}.jpg")
        assert cv2.imwrite(path, scene(h, w, i),
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        assert_same(*both(path))
        assert_same(*both(path, unchanged=True))


@pytest.mark.parametrize("case,params", [
    ("restart_3", [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    ("restart_1_422", [cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    ("optimized", [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    ("quality_100", [cv2.IMWRITE_JPEG_QUALITY, 100]),
    ("quality_5", [cv2.IMWRITE_JPEG_QUALITY, 5]),
])
def test_coding_options_equal_cv2(tmp_path, case, params):
    for h, w in ((480, 640), (31, 45)):
        path = str(tmp_path / f"{case}_{h}.jpg")
        assert cv2.imwrite(path, scene(h, w, 7), params)
        assert_same(*both(path))


@pytest.mark.parametrize("h,w", [(480, 640), (13, 29)])
def test_gray_equals_cv2(tmp_path, h, w):
    """Three equal channels from ``imread``, (H, W) unchanged."""
    path = str(tmp_path / "gray.jpg")
    assert cv2.imwrite(path, scene(h, w, 2)[:, :, 0])
    got, ref = both(path)
    assert_same(got, ref)
    assert (got[..., 0] == got[..., 1]).all()
    assert_same(*both(path, unchanged=True))
    assert jpeg.imread(path, unchanged=True).ndim == 2


@pytest.mark.parametrize("name", ["420.jpg", "422.jpg", "444.jpg",
                                  "gray.jpg", "restart.jpg",
                                  "optimized.jpg"])
def test_committed_fixture_digests(name):
    """The digest committed beside each fixture is cv2's array, and the
    port's; 640 x 480 each."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)[name]
    path = os.path.join(FIXTURES, name)
    got, ref = both(path)
    assert_same(got, ref)
    assert list(ref.shape) == want["shape"] == [480, 640, 3]
    assert hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"]


def _exif(orientation: int, order: str) -> bytes:
    tiff = ({"<": b"II", ">": b"MM"}[order]
            + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHI", 0x0112, 3, 1)
            + struct.pack(order + "H", orientation) + b"\0\0"
            + struct.pack(order + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("order", ["<", ">"])
def test_exif_orientation_equals_cv2(tmp_path, order):
    """Orientations 1-8 in an APP1 segment spliced after SOI: turned as
    cv2 turns them, and ignored with ``unchanged``."""
    ok, buf = cv2.imencode(".jpg", scene(37, 53, 4))
    raw = buf.tobytes()
    for orientation in range(1, 9):
        path = str(tmp_path / f"o{orientation}.jpg")
        with open(path, "wb") as f:
            f.write(raw[:2] + _exif(orientation, order) + raw[2:])
        got, ref = both(path)
        assert_same(got, ref)
        assert ref.shape[:2] == ((37, 53) if orientation <= 4 else (53, 37))
        assert_same(*both(path, unchanged=True))


def test_progressive_raises_and_bad_files_are_none(tmp_path):
    path = str(tmp_path / "progressive.jpg")
    assert cv2.imwrite(path, scene(40, 40), [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                             1])
    assert cv2.imread(path) is not None
    with pytest.raises(NotImplementedError, match="progressive.*item 14"):
        jpeg.imread(path)
    assert jpeg.imread(str(tmp_path / "missing.jpg")) is None
    ok, buf = cv2.imencode(".jpg", scene(40, 40))
    trunc = str(tmp_path / "truncated.jpg")
    with open(trunc, "wb") as f:
        f.write(buf.tobytes()[:100])
    assert jpeg.imread(trunc) is None and cv2.imread(trunc) is None


def _with_segment(data: bytes, marker: int, payload: bytes) -> bytes:
    """``data`` with its first ``marker`` segment's payload replaced."""
    pos = data.index(bytes([0xFF, marker]))
    (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
    return (data[:pos + 2] + struct.pack(">H", len(payload) + 2) + payload
            + data[pos + 2 + length:])


@pytest.mark.parametrize("marker,payload", [
    (0xC0, b"\x08"), (0xC0, b"\x08\x00\x28\x00\x28\x03\x01\x22"),
    (0xC4, b"\x00\x01"), (0xDD, b"\x00"), (0xDA, b"\x03\x01")],
    ids=["sof-short", "sof-components-cut", "dht-short", "dri-short",
         "sos-short"])
def test_malformed_headers_are_none_as_in_cv2(tmp_path, marker, payload):
    ok, buf = cv2.imencode(".jpg", scene(40, 40),
                           [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(_with_segment(buf.tobytes(), marker, payload))
    got, ref = both(path)
    assert got is None and ref is None


def test_decoder_faults_raise(tmp_path, monkeypatch):
    """Only a file the decoder finds malformed reads as None: a host
    library that does not load, or an error inside the parser, raises
    (a reader would otherwise drop the frame as unreadable)."""
    path = str(tmp_path / "ok.jpg")
    assert cv2.imwrite(path, scene(16, 16))
    assert jpeg.imread(path) is not None

    def no_library():
        raise OSError("cannot load the host library")

    monkeypatch.setattr(jpeg, "_lib", no_library)
    with pytest.raises(OSError, match="host library"):
        jpeg.imread(path)
    monkeypatch.undo()

    def parser_fault(payload):
        raise IndexError("parser fault")

    monkeypatch.setattr(jpeg, "_frame", parser_fault)
    with pytest.raises(IndexError, match="parser fault"):
        jpeg.imread(path)
