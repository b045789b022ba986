"""ctypes bindings for the native C++ preprocessing library.

The reference's CPU hot path is PIL resize/crop/normalize inside DataLoader
workers (SURVEY.md §3.1 "CPU hot path"); here it is one C++ call per image
(native/slime_preprocess.cpp) producing the fixed-shape crop stack directly.
Falls back to the PIL path transparently when the library isn't built.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..constants import IMAGE_WIDTH, MAX_CROPS

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libslime_preprocess.so")


def build_native(force: bool = False) -> bool:
    """Compile the shared library with make; returns success. Rebuilds when the
    C++ source is newer than the .so (a stale binary must never shadow edits).

    Processes that import this at once (test workers) build one at a time
    under a file lock: otherwise one can load the .so while another is still
    writing it."""
    import fcntl

    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(force)


def _build_locked(force: bool) -> bool:
    cpp = os.path.join(_NATIVE_DIR, "slime_preprocess.cpp")
    stale = (os.path.exists(_SO) and os.path.exists(cpp)
             and os.path.getmtime(cpp) > os.path.getmtime(_SO))
    if os.path.exists(_SO) and not force and not stale:
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        if stale:
            # The .cpp changed and the rebuild failed: a stale binary must
            # never shadow edits, so refuse it (callers fall back to PIL).
            import warnings
            warnings.warn("native rebuild failed with a stale libslime_preprocess.so; "
                          "refusing the stale binary (PIL fallback will be used)")
            return False
        return os.path.exists(_SO)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not build_native():  # also rebuilds when the .cpp is newer than the .so
        return None
    lib = ctypes.CDLL(_SO)
    lib.slime_anyres_preprocess.restype = ctypes.c_int
    lib.slime_anyres_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.slime_square_preprocess.restype = None
    lib.slime_square_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.slime_anyres_preprocess_u8.restype = ctypes.c_int
    lib.slime_anyres_preprocess_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def anyres_preprocess_native(img_hwc: np.ndarray, *, tile: int = IMAGE_WIDTH,
                             max_crops: int = MAX_CROPS, normalize: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """uint8 HWC image -> (crops [max_crops,3,t,t], mask, (cols, rows)).

    normalize=True: CLIP-normalized float32 crops (device-ready). False: raw
    uint8 crops — ship 1/4 the bytes and normalize on device
    (slime.encode_images handles uint8 pixel_values)."""
    lib = _load()
    assert lib is not None, "native preprocessing library not built"
    img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w = img.shape[:2]
    mask = np.zeros((max_crops,), np.uint8)
    cols = ctypes.c_int(0)
    rows = ctypes.c_int(0)
    if normalize:
        out = np.empty((max_crops, 3, tile, tile), np.float32)
        n = lib.slime_anyres_preprocess(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, tile,
            max_crops, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(cols), ctypes.byref(rows))
    else:
        out = np.empty((max_crops, 3, tile, tile), np.uint8)
        n = lib.slime_anyres_preprocess_u8(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, tile,
            max_crops, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(cols), ctypes.byref(rows))
    assert n > 0, "crop grid exceeded max_crops"
    return out, mask.astype(bool), (cols.value, rows.value)


def square_preprocess_native(img_hwc: np.ndarray, *, tile: int = IMAGE_WIDTH
                             ) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w = img.shape[:2]
    out = np.empty((3, tile, tile), np.float32)
    lib.slime_square_preprocess(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, tile,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
