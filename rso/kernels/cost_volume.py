"""Windowed SAD cost volume: the reference's tracking_SAD as a batched kernel.

tracking_SAD (stereo_vo tracking_SAD.cpp:73-125) exhaustively searches an 8x8
template over a +-wx,+-wy window and returns the best pixel + min SAD; it is
declared+tested but never wired into the reference pipeline (superseded by the
match-set search).  Here it is a first-class batched op — each of K templates
searched over its own window in one fused computation — used by the EuRoC
track-recovery configuration.

v2 formulation: the per-keypoint search region is pulled with the detector's
profiled row-take extractor (32-lane chunks) and all 8x8 windows are
materialized with one dense unfold (conv_general_dilated_patches) — no
vmapped dynamic_slice, whose per-keypoint scattered gathers are both slow
and a runtime fault trigger inside long scans (docs/FLOW_SCAN_FAULT.md).  Bit-identical to v1 (integer SADs).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class WindowedSearchResult(NamedTuple):
    best_xy: jnp.ndarray   # [K,2] f32 best match center
    best_sad: jnp.ndarray  # [K] f32 min SAD
    valid: jnp.ndarray     # [K] bool


def windowed_sad_search(
    img: jnp.ndarray,          # [H,W] f32 search image
    templates: jnp.ndarray,    # [K,64] f32 8x8 template patches
    centers: jnp.ndarray,      # [K,2] f32 search centers (x,y)
    win_x: int,
    win_y: int,
    valid: jnp.ndarray | None = None,
) -> WindowedSearchResult:
    """Exhaustive min-SAD search of each template over its window.

    All (2wy+1)x(2wx+1) candidate 8x8 SADs per template evaluated in parallel
    on the VPU from one unfolded region tensor.
    """
    from rso.frontend.detect import _extract_rect

    H, W = img.shape
    K = templates.shape[0]
    if valid is None:
        valid = jnp.ones((K,), bool)

    # window of candidate top-left corners per template (clamped whole-window
    # in-range, exactly like v1's dynamic_slice semantics)
    SX = 2 * win_x + 8
    SY = 2 * win_y + 8
    x0 = jnp.clip(jnp.round(centers[:, 0]).astype(jnp.int32) - 3 - win_x,
                  0, W - SX)
    y0 = jnp.clip(jnp.round(centers[:, 1]).astype(jnp.int32) - 3 - win_y,
                  0, H - SY)

    # region pull in 32-lane chunks -> [K, SY, SX]
    chunks = []
    done = 0
    while done < SX:
        w = min(32, SX - done)
        chunks.append(_extract_rect(img, x0 + done, y0, SY, w))
        done += w
    region = jnp.concatenate(chunks, axis=2)

    # all 8x8 windows: [K, 64, 2wy+1, 2wx+1]
    windows = lax.conv_general_dilated_patches(
        region[:, None], filter_shape=(8, 8), window_strides=(1, 1),
        padding="VALID")
    sad = jnp.sum(jnp.abs(windows - templates.reshape(K, 64, 1, 1)), axis=1)

    DX = 2 * win_x + 1
    flat = sad.reshape(K, (2 * win_y + 1) * DX)
    idx = jnp.argmin(flat, axis=1)
    dy = (idx // DX).astype(jnp.int32)
    dx = (idx % DX).astype(jnp.int32)
    best_xy = jnp.stack([(x0 + dx + 3).astype(jnp.float32),
                         (y0 + dy + 3).astype(jnp.float32)], axis=1)
    best_sad = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    best_sad = jnp.where(valid, best_sad,
                         jnp.float32(jnp.finfo(jnp.float32).max))
    return WindowedSearchResult(best_xy=best_xy, best_sad=best_sad,
                                valid=valid)
