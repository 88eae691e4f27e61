"""ctypes bindings to the native C++ data-loader (native/rso_loader.cpp).

The reference feeds the engine from a native C++ acquisition layer (MRPT
CCameraSensor / rawlog / CImage decode, demo-main.cpp:110-146); this module
is rso's equivalent: libpng/libjpeg/PGM grayscale decode plus a
bounded multi-threaded prefetch ring that overlaps host decode with device
compute.  Degrades gracefully (`available() == False`) when the shared
library is absent; `rso.io.datasets.StereoDataset.prefetch` then falls back
to the Python thread + cv2/PIL path.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Sequence

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "librso_loader.so")

_ERRORS = {
    -1: "cannot open file",
    -2: "unsupported image format",
    -3: "decode failed",
    -4: "image larger than buffer",
    -5: "frame dims differ from sequence dims",
}


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        # first-use build, mirroring rso.native: one self-contained C++ file
        import shutil
        import subprocess

        build = os.path.join(os.path.dirname(_LIB_PATH), "build.sh")
        if shutil.which("g++") and os.path.exists(build):
            try:
                subprocess.run(["bash", build], check=True, timeout=120,
                               capture_output=True)
            except (subprocess.SubprocessError, OSError):
                pass
    if not os.path.exists(_LIB_PATH):
        raise OSError(
            f"native loader not built: {_LIB_PATH} (run native/build.sh)")
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.rso_decode_gray.restype = ctypes.c_int
    lib.rso_decode_gray.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long,
                                    i32p, i32p]
    lib.rso_probe_image.restype = ctypes.c_int
    lib.rso_probe_image.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.rso_loader_open.restype = ctypes.c_void_p
    lib.rso_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p]
    lib.rso_loader_next.restype = ctypes.c_int
    lib.rso_loader_next.argtypes = [ctypes.c_void_p, u8p, u8p, i32p]
    lib.rso_loader_close.restype = None
    lib.rso_loader_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def decode_gray(path: str, max_bytes: int = 1 << 26) -> np.ndarray:
    """Decode PNG/JPEG/PGM to an 8-bit grayscale [H, W] array."""
    lib = _load()
    buf = np.empty(max_bytes, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.rso_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_bytes, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(
            f"native decode of {path}: {_ERRORS.get(rc, rc)}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def probe_image(path: str) -> tuple[int, int]:
    """Return (height, width) of an image file."""
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.rso_probe_image(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(f"native probe of {path}: {_ERRORS.get(rc, rc)}")
    return h.value, w.value


class NativePrefetcher:
    """In-order stereo prefetch ring over the C++ worker pool.

    Iterating yields (left u8 [H,W], right u8 [H,W], index).  At most
    `depth` frames are decoded ahead; memory is bounded at 2*depth*H*W.
    """

    def __init__(self, left_paths: Sequence[str], right_paths: Sequence[str],
                 depth: int = 4, n_threads: int = 2):
        assert len(left_paths) == len(right_paths) and len(left_paths) > 0
        lib = _load()
        n = len(left_paths)
        self._lp = (ctypes.c_char_p * n)(*[p.encode() for p in left_paths])
        self._rp = (ctypes.c_char_p * n)(*[p.encode() for p in right_paths])
        h = ctypes.c_int()
        w = ctypes.c_int()
        self._handle = lib.rso_loader_open(self._lp, self._rp, n, depth,
                                           n_threads, ctypes.byref(h),
                                           ctypes.byref(w))
        if not self._handle:
            raise RuntimeError(
                f"native loader failed to open sequence ({left_paths[0]})")
        self._lib = lib
        self.height, self.width = h.value, w.value
        self._n = n

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        idx = ctypes.c_int()
        try:
            while True:
                left = np.empty((self.height, self.width), np.uint8)
                right = np.empty((self.height, self.width), np.uint8)
                rc = self._lib.rso_loader_next(
                    self._handle, left.ctypes.data_as(u8p),
                    right.ctypes.data_as(u8p), ctypes.byref(idx))
                if rc == 1:
                    break
                if rc != 0:
                    raise RuntimeError(
                        f"native decode of frame {idx.value}: "
                        f"{_ERRORS.get(rc, rc)}")
                yield left, right, idx.value
        finally:
            self.close()

    def close(self):
        if self._handle:
            self._lib.rso_loader_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
