"""ctypes bindings to the measured-reference baseline (native/rso_baseline.cpp).

The baseline library is a faithful OpenCV port of the reference pipeline
(famoreno/stereo-vo stages 1-5; the reference itself needs MRPT, absent in
this image).  Two uses:
  * tools/measure_baseline.py measures its FPS/ATE on the bench scenes
    (the denominator of bench.py's vs_baseline), via the standalone binary;
  * the test suite checks the JAX solver against reference solver semantics
    on identical correspondences (baseline_solve_pose below).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "librso_baseline.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH):
        import shutil
        import subprocess

        build = os.path.join(os.path.dirname(_LIB_PATH), "build.sh")
        if shutil.which("g++") and os.path.exists(build):
            try:
                subprocess.run(["bash", build], check=True, timeout=300,
                               capture_output=True)
            except (subprocess.SubprocessError, OSError):
                pass
    if not os.path.exists(_LIB_PATH):
        raise OSError(f"baseline library not built: {_LIB_PATH} "
                      "(run native/build.sh; needs OpenCV 4 dev)")
    lib = ctypes.CDLL(_LIB_PATH)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.baseline_solve_pose.restype = ctypes.c_int
    lib.baseline_solve_pose.argtypes = [f64p, f64p, u8p, ctypes.c_int, f64p,
                                        f64p, f64p, f64p, i32p]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def solve_pose(prev_obs: np.ndarray, cur_obs: np.ndarray, mask: np.ndarray,
               cam, params, initial_pose: np.ndarray | None = None):
    """Reference-semantics two-phase robust GN solve (getChangeInPose
    contract, common.cpp:355-413 -> stage5_optimization.cpp:392-736).

    cam: rso StereoCamera; params: rso LeastSquaresParams.
    Returns (pose6 [w,t] of current wrt previous, valid, (it1, it2)).
    """
    lib = _load()
    p = np.ascontiguousarray(prev_obs, np.float64).reshape(-1, 4)
    c = np.ascontiguousarray(cur_obs, np.float64).reshape(-1, 4)
    m = np.ascontiguousarray(mask, np.uint8)
    n = p.shape[0]
    cam9 = np.array([cam.fx_l, cam.fy_l, cam.cx_l, cam.cy_l,
                     cam.fx_r, cam.fy_r, cam.cx_r, cam.cy_r,
                     cam.baseline], np.float64)
    sp7 = np.array([float(params.use_robust_kernel), params.kernel_param,
                    params.initial_max_iters, params.max_iters,
                    params.min_mod_out_vector, params.max_incr_cost,
                    params.residual_threshold], np.float64)
    init = (np.zeros(6) if initial_pose is None
            else np.ascontiguousarray(initial_pose, np.float64))
    out = np.zeros(6, np.float64)
    iters = np.zeros(2, np.int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    ok = lib.baseline_solve_pose(
        p.ctypes.data_as(f64p), c.ctypes.data_as(f64p),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        cam9.ctypes.data_as(f64p), sp7.ctypes.data_as(f64p),
        init.ctypes.data_as(f64p), out.ctypes.data_as(f64p),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, bool(ok), (int(iters[0]), int(iters[1]))
