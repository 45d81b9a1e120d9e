"""ctypes bindings to the native host runtime
(``native/src/givepose_host.cpp``).

Port of ``givepose_tpu/data/native_loader.py``.  The native library
provides PNG decode (libpng), NOCS decode, affine crop, mask-band
morphology and a threaded prefetch pool, the C++ counterpart of the
runtime the reference gets from cv2 + DataLoader workers.  The port
builds the source itself at first use, with g++ and without
``-march=native`` (``ops/_build.py`` ``build_host``: ``-O3 -fPIC -shared
-std=c++17 ... -lpng -lz -lpthread``), into ``build/givepose_torch/``;
it never loads the committed ``native/libgivepose_host.so``, which was
built for another host.  Where it cannot be built (no libpng headers),
``available()`` is False and the decoders return None.  No path of the
port calls it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from givepose_torch.ops import _build

SOURCE = _build.PACKAGE_DIR.parent / "native" / "src" / "givepose_host.cpp"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")

_LIB = None
_FAILED = False


def _load():
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    try:
        lib = _build.load_host_library(SOURCE, FLAGS, LIBS)
    except (OSError, RuntimeError):
        _FAILED = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.gp_decode_png_rgb.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                      ctypes.c_int, i32p, i32p]
    lib.gp_decode_png_depth.argtypes = [ctypes.c_char_p, u16p,
                                        ctypes.c_int, ctypes.c_int, i32p,
                                        i32p]
    lib.gp_decode_nocs.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, f32p]
    lib.gp_affine_crop_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_float,
                                       f32p, ctypes.c_int, ctypes.c_int]
    lib.gp_affine_crop_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float,
                                      f32p, ctypes.c_int, ctypes.c_int]
    lib.gp_mask_band.argtypes = [f32p, ctypes.c_int, ctypes.c_int, u8p]
    lib.gp_loader_create.restype = ctypes.c_void_p
    lib.gp_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p,
                                  i32p, i32p]
    lib.gp_loader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png_rgb(path: str, max_h: int = 1080,
                   max_w: int = 1920) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    buf = np.empty((max_h, max_w, 3), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.gp_decode_png_rgb(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_h, max_w, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    out[:] = buf.reshape(-1)[: h.value * w.value * 3].reshape(
        h.value, w.value, 3)
    return out


def decode_png_depth(path: str, max_h: int = 1080,
                     max_w: int = 1920) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    buf = np.empty((max_h, max_w), np.uint16)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.gp_decode_png_depth(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        max_h, max_w, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.uint16)
    out[:] = buf.reshape(-1)[: h.value * w.value].reshape(h.value, w.value)
    return out


def affine_crop(src: np.ndarray, center, scale: float, out_size: int,
                bilinear: bool = False) -> np.ndarray:
    """Native crop-resize; src (H,W,C) f32 or u8 -> (out,out,C) f32."""
    lib = _load()
    assert lib is not None
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    dst = np.empty((out_size, out_size, c), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if src.dtype == np.uint8:
        lib.gp_affine_crop_u8(
            np.ascontiguousarray(src).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            h, w, c, float(center[0]), float(center[1]), float(scale),
            dst.ctypes.data_as(f32p), out_size, int(bilinear))
    else:
        lib.gp_affine_crop_f32(
            np.ascontiguousarray(src, np.float32).ctypes.data_as(f32p),
            h, w, c, float(center[0]), float(center[1]), float(scale),
            dst.ctypes.data_as(f32p), out_size, int(bilinear))
    return dst[..., 0] if squeeze else dst


def mask_band(mask: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    h, w = mask.shape
    band = np.empty((h, w), np.uint8)
    lib.gp_mask_band(
        np.ascontiguousarray(mask, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        h, w, band.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return band


class PrefetchLoader:
    """Threaded native PNG prefetcher over a path list."""

    def __init__(self, paths: list[str], max_h: int = 480,
                 max_w: int = 640, n_threads: int = 2):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self.max_h, self.max_w = max_h, max_w
        self._handle = lib.gp_loader_create(arr, len(self._paths), max_h,
                                            max_w, n_threads)

    def get(self, idx: int) -> np.ndarray | None:
        buf = np.empty((self.max_h, self.max_w, 3), np.uint8)
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.gp_loader_get(
            self._handle, idx,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            return None
        out = np.empty((h.value, w.value, 3), np.uint8)
        out[:] = buf.reshape(-1)[: h.value * w.value * 3].reshape(
            h.value, w.value, 3)
        return out

    def close(self):
        if self._handle:
            self._lib.gp_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
