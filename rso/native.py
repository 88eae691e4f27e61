"""ctypes bindings to the native host library (native/rso_native.cpp).

Independent C++ implementations of the hot pixel kernels with the reference's
contracts (compute_SAD8, tracking_SAD, FAST segment test) — used as
cross-language oracles for the JAX kernels and available for host-side
tooling.  Builds with native/build.sh; all entry points degrade gracefully
(`available() == False`) when the shared library is absent.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "librso_native.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        # first-use build: the oracle is one self-contained C++ file; build
        # it on the spot when a toolchain is present rather than skipping
        # every cross-language equivalence test
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
            f"native library not built: {_LIB_PATH} (run native/build.sh)")
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    c = ctypes.c_int

    lib.rso_compute_sad8.restype = ctypes.c_uint32
    lib.rso_compute_sad8.argtypes = [u8p, u8p, c, c, c, c, c]
    lib.rso_sad_matrix.restype = None
    lib.rso_sad_matrix.argtypes = [u8p, c, u8p, c, u32p, c]
    lib.rso_hamming_matrix.restype = None
    lib.rso_hamming_matrix.argtypes = [u32p, c, u32p, c, u32p]
    lib.rso_tracking_sad.restype = ctypes.c_uint32
    lib.rso_tracking_sad.argtypes = [u8p, c, c, c, u8p, c, c, c, c, i32p, i32p]
    lib.rso_fast_detect.restype = c
    lib.rso_fast_detect.argtypes = [u8p, c, c, c, c, c, i32p, c]
    lib.rso_downsample2x.restype = None
    lib.rso_downsample2x.argtypes = [u8p, c, c, c, u8p]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _u8(a):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compute_sad8(img_a: np.ndarray, img_b: np.ndarray, ax: int, ay: int,
                 bx: int, by: int) -> int:
    """Scalar 8x8 SAD at two keypoints (reference compute_SAD8 contract)."""
    lib = _load()
    a, pa = _u8(img_a)
    b, pb = _u8(img_b)
    assert a.shape[1] == b.shape[1]
    return int(lib.rso_compute_sad8(pa, pb, a.shape[1], ax, ay, bx, by))


def sad_matrix(patches_a: np.ndarray, patches_b: np.ndarray,
               n_threads: int = 4) -> np.ndarray:
    lib = _load()
    a, pa = _u8(patches_a.reshape(len(patches_a), 64))
    b, pb = _u8(patches_b.reshape(len(patches_b), 64))
    out = np.empty((len(a), len(b)), np.uint32)
    lib.rso_sad_matrix(pa, len(a), pb, len(b),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                       n_threads)
    return out


def hamming_matrix(desc_a: np.ndarray, desc_b: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(desc_a, np.uint32)
    b = np.ascontiguousarray(desc_b, np.uint32)
    out = np.empty((len(a), len(b)), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rso_hamming_matrix(a.ctypes.data_as(u32p), len(a),
                           b.ctypes.data_as(u32p), len(b),
                           out.ctypes.data_as(u32p))
    return out


def tracking_sad(img: np.ndarray, template8x8: np.ndarray, cx: int, cy: int,
                 wx: int, wy: int):
    """Windowed min-SAD search (reference tracking_SAD contract).
    Returns (best_x, best_y, best_sad)."""
    lib = _load()
    a, pa = _u8(img)
    t, pt = _u8(template8x8.reshape(64))
    bx = ctypes.c_int32()
    by = ctypes.c_int32()
    sad = lib.rso_tracking_sad(pa, a.shape[1], a.shape[1], a.shape[0], pt,
                               cx, cy, wx, wy, ctypes.byref(bx),
                               ctypes.byref(by))
    return int(bx.value), int(by.value), int(sad)


def fast_detect(img: np.ndarray, threshold: int, arc: int = 12,
                max_out: int = 100000) -> np.ndarray:
    """Scalar FAST-N detector; returns [N,2] int32 (x, y)."""
    lib = _load()
    a, pa = _u8(img)
    out = np.empty((max_out, 2), np.int32)
    n = lib.rso_fast_detect(pa, a.shape[1], a.shape[1], a.shape[0], threshold,
                            arc,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            max_out)
    return out[: min(n, max_out)]


def downsample2x(img: np.ndarray) -> np.ndarray:
    lib = _load()
    a, pa = _u8(img)
    h2, w2 = a.shape[0] // 2, a.shape[1] // 2
    out = np.empty((h2, w2), np.uint8)
    lib.rso_downsample2x(pa, a.shape[1], a.shape[1], a.shape[0],
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
