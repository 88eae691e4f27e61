"""Pyramidal Lucas-Kanade optical flow, fully vectorized over keypoints.

JAX equivalent of the reference's ifmOpticalFlow tracking branch
(stereo_vo stage4_match_consecutive.cpp:333-431, which calls
cv::calcOpticalFlowPyrLK on the left and right streams).  Classic
coarse-to-fine iterative LK: per level, per keypoint, a 2x2 normal-equation
solve over a fixed window, fixed iteration count (XLA-friendly — no
data-dependent early exit; the convergence test feeds the status flag
instead).

Used by the engine's OPTICAL_FLOW inter-frame mode as a *flow-guided
association*: LK predicts where each previous match lands in the current
frame, and the association picks the nearest current match inside a small
gate around the prediction.  (The reference instead overwrites the current
feature set with the raw tracked points, :402-412, so its feature pool decays
until re-detection; guiding the association keeps the detector in the loop —
same recovery contract, better persistence.)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class FlowResult(NamedTuple):
    pos: jnp.ndarray      # [K,2] tracked positions in the current image
    status: jnp.ndarray   # [K] bool: converged && in-bounds
    err: jnp.ndarray      # [K] mean abs residual at the solution


_LK_SLACK = 5    # in-patch drift allowance per level beyond the initial guess


def _lk_level(prev_img, cur_img, pts_prev, guess, win: int, iters: int):
    """One pyramid level of iterative LK for all keypoints at once.

    pts_prev: [K,2] keypoint coords at this level; guess: [K,2] initial flow.
    Returns (flow [K,2], residual [K]).

    Fixed-shape formulation (v3): the iteration never touches the full image.  Two
    batched patch pulls per level (template [K,S_t,S_t] around the keypoint,
    search [K,S_c,S_c] around the initial guess) via the detector's profiled
    row-take extractor, then every LK iteration cuts its bilinear window
    from the small search patch with one-hot row/column matmuls — static
    shapes, no gather.  History of this function (docs/FLOW_SCAN_FAULT.md):
    v1 per-sample gather bilinear faulted the earlier runtime inside long
    scans; v2 fixed that with one lax.dynamic_slice from the padded full
    image per iteration, but vmapped dynamic_slice with per-keypoint starts
    lowers to scattered device-memory gathers, far slower in flow mode.  v3 is bit-identical to v2 for every iterate
    whose integer window base stays within _LK_SLACK px of the initial
    guess (coarse-to-fine refinement is a few px per level); beyond that
    the window clamps to the patch edge, the residual grows, and the err
    gate flags the track — v2 instead kept sampling, so v3 is slightly
    stricter on wild tracks.
    """
    from rso.frontend.detect import extract_patches

    r = win
    P = 2 * r + 1
    M = _LK_SLACK
    H, W = prev_img.shape
    pad_t = r + 2                       # template patch reach: r+1 (grads) +1
    pad_c = r + 1 + M                   # search reach: r +1 (bilinear) +slack
    prev_p = jnp.pad(prev_img, pad_t, mode="edge")
    cur_p = jnp.pad(cur_img, pad_c, mode="edge")
    S_t = 2 * r + 4
    S_c = 2 * r + 2 + 2 * M
    assert S_t <= 32 and S_c <= 32, "extract_patches lane limit"

    x = jnp.clip(pts_prev[:, 0], 0.0, W - 1.001)
    y = jnp.clip(pts_prev[:, 1], 0.0, H - 1.001)
    bx = jnp.floor(x).astype(jnp.int32)
    by = jnp.floor(y).astype(jnp.int32)
    fx = x - bx.astype(x.dtype)
    fy = y - by.astype(y.dtype)
    # template patches: row/col 0 = image row by-(r+1) / col bx-(r+1)
    t_centers = jnp.stack([(bx + pad_t).astype(jnp.float32),
                           (by + pad_t).astype(jnp.float32)], axis=1)
    Tpatches = extract_patches(prev_p, t_centers, size=S_t,
                               offset=r + 1).reshape(-1, S_t, S_t)
    # search patches around the initial guess: row 0 = image row cby0-r-M
    qx0 = jnp.clip(x + guess[:, 0], 0.0, W - 1.001)
    qy0 = jnp.clip(y + guess[:, 1], 0.0, H - 1.001)
    cbx0 = jnp.floor(qx0).astype(jnp.int32)
    cby0 = jnp.floor(qy0).astype(jnp.int32)
    c_centers = jnp.stack([(cbx0 + pad_c).astype(jnp.float32),
                           (cby0 + pad_c).astype(jnp.float32)], axis=1)
    Cpatches = extract_patches(cur_p, c_centers, size=S_c,
                               offset=r + M).reshape(-1, S_c, S_c)

    lanes = jnp.arange(S_c, dtype=jnp.int32)
    taps = jnp.arange(P + 1, dtype=jnp.int32)

    def one(patch, cpatch, x1, y1, fx1, fy1, cbx1, cby1, g0):
        w00 = (1 - fy1) * (1 - fx1)
        w01 = (1 - fy1) * fx1
        w10 = fy1 * (1 - fx1)
        w11 = fy1 * fx1

        def samp(oy, ox):
            # bilinear window grid at integer offset (oy,ox) from the center
            i, j = 1 + oy, 1 + ox
            return (w00 * patch[i:i + P, j:j + P]
                    + w01 * patch[i:i + P, j + 1:j + P + 1]
                    + w10 * patch[i + 1:i + P + 1, j:j + P]
                    + w11 * patch[i + 1:i + P + 1, j + 1:j + P + 1])

        T = samp(0, 0)
        # template gradients (standard LK uses prev-image gradients)
        Ix = (samp(0, 1) - samp(0, -1)) * 0.5
        Iy = (samp(1, 0) - samp(-1, 0)) * 0.5
        Gxx = jnp.sum(Ix * Ix)
        Gxy = jnp.sum(Ix * Iy)
        Gyy = jnp.sum(Iy * Iy)
        det = Gxx * Gyy - Gxy * Gxy
        ok = det > 1e-6
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

        def cur_window(g):
            qx = jnp.clip(x1 + g[0], 0.0, W - 1.001)
            qy = jnp.clip(y1 + g[1], 0.0, H - 1.001)
            cbx = jnp.floor(qx).astype(jnp.int32)
            cby = jnp.floor(qy).astype(jnp.int32)
            cfx = qx - cbx.astype(qx.dtype)
            cfy = qy - cby.astype(qy.dtype)
            dbx = jnp.clip(cbx - cbx1, -M, M)
            dby = jnp.clip(cby - cby1, -M, M)
            rsel = (lanes[None, :] == (M + dby + taps)[:, None])
            csel = (lanes[None, :] == (M + dbx + taps)[:, None])
            cp = (rsel.astype(cpatch.dtype) @ cpatch
                  @ csel.astype(cpatch.dtype).T)   # [P+1, P+1]
            return ((1 - cfy) * (1 - cfx) * cp[:P, :P]
                    + (1 - cfy) * cfx * cp[:P, 1:P + 1]
                    + cfy * (1 - cfx) * cp[1:P + 1, :P]
                    + cfy * cfx * cp[1:P + 1, 1:P + 1])

        def body(_, g):
            e = cur_window(g) - T
            bx_ = jnp.sum(Ix * e)
            by_ = jnp.sum(Iy * e)
            dgx = -(Gyy * bx_ - Gxy * by_) * inv_det
            dgy = -(-Gxy * bx_ + Gxx * by_) * inv_det
            return g + jnp.stack([dgx, dgy])

        g = lax.fori_loop(0, iters, body, g0)
        err = jnp.mean(jnp.abs(cur_window(g) - T))
        return g, err, ok

    flow, err, ok = jax.vmap(one)(Tpatches, Cpatches, x, y, fx, fy,
                                  cbx0, cby0, guess)
    return flow, err, ok


def _coarse_sad_seed(prev_img, cur_img, pts, seed_range: int):
    """Integer flow seed at the coarsest level: exhaustive 8x8-SAD search
    over +-seed_range px, formulated as a dense unfold + reduce (no gathers).

    This is the reference's tracking_SAD contract (tracking_SAD.cpp:73-125)
    applied where pyramidal LK needs it most: the coarsest level has no
    initial guess, and the v3 one-hot LK window clamps to +-_LK_SLACK px of
    the guess, so without a seed trackable motion is capped at
    ~_LK_SLACK * 2^(L-1) full-res px (ADVICE r2: 14 px tracked 9/40 on two
    levels).  The seed extends the reach to +-(seed_range + _LK_SLACK) at
    the coarsest level.
    """
    from rso.frontend.detect import extract_patches

    assert seed_range <= 12, "search patch must fit the 32-lane extractor"
    Ms = seed_range
    S = 8 + 2 * Ms                       # <= 32: one lane pull
    H, W = prev_img.shape
    K = pts.shape[0]
    # pad so border keypoints keep a centered window (extract_patches clamps
    # the whole window inside the image, which would bias the seed at edges).
    # The search window reaches Ms+3 left/up and Ms+4 right/down of the
    # keypoint (offset 3+Ms into a size-S pull), so a pad of Ms alone still
    # clamps for points within 3 px of the border and shifts the idx ->
    # displacement map (measured: seed dx=3 for a true 4 px shift at
    # coarse x=2.5); pad the full reach.
    pad = Ms + 4
    prev_p = jnp.pad(prev_img, pad, mode="edge")
    cur_p = jnp.pad(cur_img, pad, mode="edge")
    ctr = pts + pad
    T = extract_patches(prev_p, ctr, size=8, offset=3).reshape(K, 8, 8)
    Spatch = extract_patches(cur_p, ctr, size=S, offset=3 + Ms)
    Spatch = Spatch.reshape(K, S, S)
    # all 8x8 windows of each search patch: [K, 64, 2Ms+1, 2Ms+1]
    windows = lax.conv_general_dilated_patches(
        Spatch[:, None], filter_shape=(8, 8), window_strides=(1, 1),
        padding="VALID")
    sad = jnp.sum(jnp.abs(windows - T.reshape(K, 64, 1, 1)), axis=1)
    D = 2 * Ms + 1
    idx = jnp.argmin(sad.reshape(K, D * D), axis=1).astype(jnp.int32)
    dy = idx // D - Ms
    dx = idx % D - Ms
    return jnp.stack([dx, dy], axis=1).astype(pts.dtype)


def lk_track(
    prev_pyr: list,
    cur_pyr: list,
    pts: jnp.ndarray,        # [K,2] keypoint coords at octave 0 (full res)
    valid: jnp.ndarray,      # [K] bool
    win: int = 10,
    iters: int = 10,
    max_err: float = 20.0,
    seed_range: int = 12,
) -> FlowResult:
    """Track pts from prev to cur through the image pyramid (coarse->fine).

    The coarsest level is seeded with an exhaustive integer SAD search
    (+-seed_range px — see _coarse_sad_seed) because the v3 one-hot LK
    window can only drift _LK_SLACK px from its initial guess; finer levels
    inherit the doubled coarse flow as their guess, which coarse-to-fine
    refinement keeps within the slack.  Set seed_range=0 to disable.
    """
    L = len(prev_pyr)
    flow = jnp.zeros_like(pts)
    ok_all = jnp.ones(pts.shape[0], bool)
    err = jnp.zeros(pts.shape[0], jnp.float32)
    for lvl in range(L - 1, -1, -1):
        scale = 1.0 / (2 ** lvl)
        pts_l = pts * scale
        if lvl == L - 1 and seed_range > 0:
            flow = _coarse_sad_seed(prev_pyr[lvl], cur_pyr[lvl], pts_l,
                                    seed_range)
        flow, err, ok = _lk_level(prev_pyr[lvl], cur_pyr[lvl], pts_l, flow,
                                  win, iters)
        ok_all &= ok
        if lvl > 0:
            flow = flow * 2.0
    new_pos = pts + flow
    H, W = cur_pyr[0].shape
    inb = ((new_pos[:, 0] >= 1) & (new_pos[:, 0] < W - 1)
           & (new_pos[:, 1] >= 1) & (new_pos[:, 1] < H - 1))
    status = valid & ok_all & inb & (err <= max_err)
    return FlowResult(pos=new_pos, status=status, err=err)


def flow_guided_association(
    predicted: jnp.ndarray,   # [K,2] LK-predicted positions of prev matches
    pred_ok: jnp.ndarray,     # [K] bool
    cur_xy: jnp.ndarray,      # [K,2] current left-feature coords
    cur_ok: jnp.ndarray,      # [K] bool current matches validity
    gate: float = 4.0,
):
    """prev-slot -> cur-slot association by nearest current match inside a
    gate around the LK prediction.  Returns (cur_idx [K], valid [K])."""
    d2 = jnp.sum((predicted[:, None, :] - cur_xy[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(pred_ok[:, None] & cur_ok[None, :], d2, jnp.inf)
    best = jnp.argmin(d2, axis=1).astype(jnp.int32)
    bd = jnp.take_along_axis(d2, best[:, None], 1)[:, 0]
    ok = jnp.isfinite(bd) & (bd <= gate * gate)
    return jnp.where(ok, best, -1), ok
