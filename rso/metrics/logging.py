"""Verbosity logging + per-frame artifact dumps.

JAX counterpart of the reference's VERBOSE_LEVEL macro
(internal_libstereo-odometry.h:27) and the `vo_save_files`/`vo_debug` artifact
dumps (process_new_image_pair.cpp:179-204, :278-287; stage4:80-82;
stage5:702-713).  Dumps are NPZ keyed by frame index instead of scattered
text/YML files, and happen on host after result fetch (never inside jit).
"""
from __future__ import annotations

import os

import numpy as np


class VOLogger:
    """verbosity: 0 = critical only, 1 = per-frame lines, 2 = firehose
    (reference setVerbosityLevel, h:527)."""

    def __init__(self, verbosity: int = 1, save_files: bool = False,
                 out_dir: str = "out"):
        self.verbosity = verbosity
        self.save_files = save_files
        self.out_dir = out_dir
        if save_files:
            os.makedirs(out_dir, exist_ok=True)

    def log(self, level: int, msg: str):
        if self.verbosity >= level:
            print(msg)

    def dump_frame(self, frame_idx: int, **arrays):
        """Dump per-frame artifacts (features, matches, residuals, ...) as one
        NPZ — rso's left_feats_%04d.txt / matches_%04d.txt /
        out_residual_%04d.txt equivalent."""
        if not self.save_files:
            return
        path = os.path.join(self.out_dir, f"frame_{frame_idx:04d}.npz")
        np.savez_compressed(path,
                            **{k: np.asarray(v) for k, v in arrays.items()})

    def dump_result(self, frame_idx: int, result):
        if not self.save_files:
            return
        self.dump_frame(
            frame_idx,
            pose=result.pose,
            valid=result.valid,
            error_code=result.error_code,
            detected_feats=result.detected_feats,
            stereo_matches=result.stereo_matches,
            residuals=result.residuals,
            inliers=result.inliers,
            track_mask=result.track_mask,
        )


ERROR_NAMES = {
    0: "voecNone",
    1: "voecBadTracking",
    2: "voecBadCondNumber",
    3: "voecIncrFuncCostStg1",
    4: "voecIncrFuncCostStg2",
    5: "voecFirstIteration",
    6: "voecTooFewInliers",  # rso extension (robust_gn.VOEC_TOO_FEW_INLIERS)
}


def error_name(code: int) -> str:
    """Pretty-printer for VOErrorCode (reference DUMP_VO_ERROR_CODE,
    internal_libstereo-odometry.h:77-84)."""
    return ERROR_NAMES.get(int(code), f"unknown({code})")
