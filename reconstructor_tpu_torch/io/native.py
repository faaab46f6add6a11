"""ctypes binding to the native C++ runtime (native/reconstructor_native.cpp).

The package's own copy of ``reconstructor_tpu/io/native.py``: the same
library (``native/libreconstructor_native.so``, beside the packages), the
same load rule and the same contracts, so both packages decode a JPEG
folder and write a PLY through the same code. The shared object is built
once with ``native/build.sh`` when it is absent; if it does not build or
does not load, ``available()`` is False and every caller takes its
Python path (PIL decode, numpy PLY writer).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libreconstructor_native.so")


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.exists(_SO_PATH):
            subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(_SO_PATH)
        lib.probe_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.probe_jpeg.restype = ctypes.c_int
        lib.decode_jpeg_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.decode_jpeg_batch.restype = ctypes.c_int
        lib.write_ply_ascii.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.write_ply_ascii.restype = ctypes.c_int
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def decode_batch(paths: List[str], img_max_size: int = 512,
                 num_threads: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode JPEGs into padded (N,H,W) gray f32 + (N,2) shapes + (N,H,W,3)
    rgb u8, all reference-resized (DCT-domain prescale, then bilinear).
    Returns None if the library is unavailable, any input is not a JPEG or
    a probe or decode fails (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        return None
    n = len(paths)
    hs = (ctypes.c_int * 1)()
    ws = (ctypes.c_int * 1)()
    pad_h = pad_w = 0
    for p in paths:
        if not lib.probe_jpeg(p.encode(), img_max_size, hs, ws):
            return None
        pad_h = max(pad_h, hs[0])
        pad_w = max(pad_w, ws[0])

    rgb = np.zeros((n, pad_h, pad_w, 3), np.uint8)
    gray = np.zeros((n, pad_h, pad_w), np.float32)
    heights = (ctypes.c_int * n)()
    widths = (ctypes.c_int * n)()
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    ok = lib.decode_jpeg_batch(
        blob, n, img_max_size,
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad_h, pad_w, heights, widths, num_threads)
    if ok != n:
        return None
    shapes = np.asarray([[heights[i], widths[i]] for i in range(n)], np.int32)
    return gray, shapes, rgb


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> bool:
    """Write (N, 3) points and (N, 3) uint8 colours as an ASCII PLY in the
    PCL dialect. False if the library is unavailable or the write fails."""
    lib = _load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    return bool(lib.write_ply_ascii(
        path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), xyz.shape[0]))
