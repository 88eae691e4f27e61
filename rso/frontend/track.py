"""Stage 4: inter-frame tracking of stereo matches as a masked cost matrix.

Fixed-shape re-design of the reference's stage4_track (stereo_vo
stage4_match_consecutive.cpp:71-801).  The reference tracks *stereo matches*
(not raw features) from frame t-1 to t; here both frames' matches live in
left-slot-aligned arrays, so tracking is a [K,K] cost matrix over
(prev-left-slot x cur-left-slot) with:

  ifmSAD     -> cost = SAD(prevL,curL) + SAD(prevR,curR), each side gated by
                sad_max_distance (reference :570-588)
  ifmDescWin -> cost = Hamming(prevL desc, curL desc) (reference :589-611 —
                note the reference also only uses the LEFT descriptor)
  ifmDescBF  -> Hamming L-L and R-R over the whole image, requiring the same
                (prev,cur) pair to win on both sides (consistency check
                :276-294); no window

  * window mask: |y_prev - y_cur| <= win_w and per-eye |x_prev - x_cur| <=
    win_h (reference :525-567; note the reference applies WIN_W vertically
    and WIN_H horizontally — preserved here via (row_win, col_win) naming)
  * one-to-one arbitration keeping the best prev per cur match (:622-636)
  * fundamental-matrix RANSAC filter on left-left and right-right point sets
    (:681-705), with pass-through when either model finds < 8 inliers

Output is prev-slot aligned: trk[p] = cur left-slot index tracked from prev
left-slot p, or -1.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rso.config import IFMatchMethod, InterFrameMatchParams
from rso.frontend.detect import Features
from rso.frontend.stereo_match import StereoMatches, _arbitrate_right
from rso.kernels.distance import hamming_matrix_jnp, track_sad_best
from rso.solver.ransac import ransac_fundamental

_BIG = jnp.float32(1e9)


class TrackResult(NamedTuple):
    cur_idx: jnp.ndarray   # [K] int32: cur left-slot tracked from prev slot p, -1 if none
    valid: jnp.ndarray     # [K] bool
    n_tracked: jnp.ndarray # int32


def _gather_right(feats_r: Features, ridx: jnp.ndarray):
    """Right-feature data aligned to left slots via the match index."""
    safe = jnp.maximum(ridx, 0)
    xy = feats_r.xy[safe]
    patch = feats_r.patch[safe]
    desc = feats_r.desc[safe]
    return xy, patch, desc


def track_interframe(
    prev_left: Features, prev_right: Features, prev_matches: StereoMatches,
    cur_left: Features, cur_right: Features, cur_matches: StereoMatches,
    params: InterFrameMatchParams,
    key: jnp.ndarray,
    ransac_iters: int = 64,
    ransac_threshold: float = 1.0,
    use_mxu: bool = False,
) -> TrackResult:
    """SAD method: exact both-eye SAD (kernels.distance.track_sad_best), or
    with use_mxu the squared-L2 shortlist re-scored by exact SAD."""
    K = prev_matches.ridx.shape[0]
    method = params.ifm_method

    p_ok = prev_matches.valid
    c_ok = cur_matches.valid

    pL_xy = prev_left.xy
    cL_xy = cur_left.xy
    pR_xy, pR_patch, pR_desc = _gather_right(prev_right, prev_matches.ridx)
    cR_xy, cR_patch, cR_desc = _gather_right(cur_right, cur_matches.ridx)

    if method == IFMatchMethod.SAD and not use_mxu:
        best_c, best_d = track_sad_best(
            prev_left.patch, cur_left.patch, pR_patch, cR_patch,
            prev_left.xy, cur_left.xy, pR_xy[:, 0], cR_xy[:, 0], p_ok, c_ok,
            win_row=float(params.ifm_win_w), win_col=float(params.ifm_win_h),
            sad_max=float(params.sad_max_distance))
        cand_ok = best_d < _BIG
        survive = _arbitrate_right(best_c, best_d, cand_ok, K, keep_best=True)
        return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                       params, key, ransac_iters, ransac_threshold)

    pair_ok = p_ok[:, None] & c_ok[None, :]

    if method == IFMatchMethod.SAD:
        # the squared-L2 shortlist (see stereo_match): the window mask is
        # applied to its coarse cost below
        side_ok = cost = None
        use_window = True
    elif method == IFMatchMethod.DESC_WIN:
        cost = hamming_matrix_jnp(prev_left.desc, cur_left.desc)
        side_ok = jnp.ones_like(pair_ok)
        use_window = True
    elif method == IFMatchMethod.DESC_BF:
        costL = hamming_matrix_jnp(prev_left.desc, cur_left.desc)
        costR = hamming_matrix_jnp(pR_desc, cR_desc)
        # both sides must independently pick the same cur match and pass the
        # distance threshold (reference :149-159 + consistency :282)
        DL = jnp.where(pair_ok, costL, _BIG)
        DR = jnp.where(pair_ok, costR, _BIG)
        bestL = jnp.argmin(DL, axis=1).astype(jnp.int32)
        bestR = jnp.argmin(DR, axis=1).astype(jnp.int32)
        dL = jnp.take_along_axis(DL, bestL[:, None], 1)[:, 0]
        dR = jnp.take_along_axis(DR, bestR[:, None], 1)[:, 0]
        cand_ok = (bestL == bestR) & (dL <= params.orb_max_distance) & (
            dR <= params.orb_max_distance) & p_ok
        survive = _arbitrate_right(bestL, dL + dR, cand_ok, K, keep_best=True)
        return _finish(prev_left, pR_xy, cur_left, cR_xy, bestL, survive,
                       params, key, ransac_iters, ransac_threshold)
    else:
        raise NotImplementedError(
            "ifmOpticalFlow: use track_optical_flow (needs image pyramids)"
        )

    if use_window:
        # vertical row window (WIN_W) and per-eye horizontal windows (WIN_H),
        # mirroring reference :525-567
        dy = jnp.abs(pL_xy[:, 1][:, None] - cL_xy[:, 1][None, :])
        dxl = jnp.abs(pL_xy[:, 0][:, None] - cL_xy[:, 0][None, :])
        dxr = jnp.abs(pR_xy[:, 0][:, None] - cR_xy[:, 0][None, :])
        win = (dy <= params.ifm_win_w) & (dxl <= params.ifm_win_h) & (
            dxr <= params.ifm_win_h)
        pair_ok &= win

    if method == IFMatchMethod.SAD:
        # coarse-to-fine: squared-L2 (both eyes summed, one matmul each)
        # shortlists top-8 per prev slot, exact SAD re-scores both eyes on
        # the shortlist; the cross-terms run at DEFAULT precision (TF32 on
        # a GPU) because they only rank
        from rso.kernels.distance import ssd_matrix

        coarse = ssd_matrix(prev_left.patch, cur_left.patch,
                            precision=jax.lax.Precision.DEFAULT) + ssd_matrix(
            pR_patch, cR_patch, precision=jax.lax.Precision.DEFAULT)
        coarse = jnp.where(pair_ok, coarse, jnp.inf)
        # recall_target=1.0: an exact top-k (on a GPU approx_max_k is an
        # exact top-k at any recall target)
        neg, idx = jax.lax.approx_max_k(-coarse, 8, recall_target=1.0)
        idx = idx.astype(jnp.int32)
        ok8 = jnp.isfinite(neg)
        sad_l8 = jnp.sum(jnp.abs(prev_left.patch[:, None, :]
                                 - cur_left.patch[idx]), axis=-1)
        sad_r8 = jnp.sum(jnp.abs(pR_patch[:, None, :]
                                 - cR_patch[idx]), axis=-1)
        good8 = (ok8 & (sad_l8 <= params.sad_max_distance)
                 & (sad_r8 <= params.sad_max_distance))
        cost8 = jnp.where(good8, sad_l8 + sad_r8, _BIG)
        j = jnp.argmin(cost8, axis=1)
        best_d = jnp.take_along_axis(cost8, j[:, None], 1)[:, 0]
        best_c = jnp.take_along_axis(idx, j[:, None], 1)[:, 0].astype(jnp.int32)
        cand_ok = best_d < _BIG
        survive = _arbitrate_right(best_c, best_d, cand_ok, K, keep_best=True)
        return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                       params, key, ransac_iters, ransac_threshold)

    D = jnp.where(pair_ok & side_ok, cost, _BIG)
    best_c = jnp.argmin(D, axis=1).astype(jnp.int32)
    best_d = jnp.take_along_axis(D, best_c[:, None], 1)[:, 0]
    cand_ok = best_d < _BIG
    survive = _arbitrate_right(best_c, best_d, cand_ok, K, keep_best=True)
    return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                   params, key, ransac_iters, ransac_threshold)


def _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive, params, key,
            ransac_iters, ransac_threshold):
    """Fundamental-matrix filtering on both eyes + final packing."""
    safe_c = jnp.maximum(best_c, 0)
    p1_l = prev_left.xy
    p2_l = cur_left.xy[safe_c]
    p1_r = pR_xy
    p2_r = cR_xy[safe_c]

    if params.filter_fund_matrix:
        k1, k2 = jax.random.split(key)
        # both eyes in ONE vmapped call: the per-hypothesis 9x9 Cholesky
        # batches to [2,H,9,9] in a single library call
        res2 = jax.vmap(
            lambda p1, p2, k: ransac_fundamental(
                p1, p2, survive, k, n_iters=ransac_iters,
                threshold=ransac_threshold)
        )(jnp.stack([p1_l, p1_r]), jnp.stack([p2_l, p2_r]),
          jnp.stack([k1, k2]))
        # if either model is degenerate, pass through (reference :256-259)
        both = res2.inliers[0] & res2.inliers[1]
        survive = jnp.where(res2.ok[0] & res2.ok[1], both, survive)

    cur_idx = jnp.where(survive, best_c, -1)
    return TrackResult(cur_idx=cur_idx, valid=survive,
                       n_tracked=jnp.sum(survive.astype(jnp.int32)))


def track_optical_flow(
    prev_pyr_l: list, prev_pyr_r: list,
    cur_pyr_l: list, cur_pyr_r: list,
    prev_left: Features, prev_right: Features, prev_matches: StereoMatches,
    cur_left: Features, cur_right: Features, cur_matches: StereoMatches,
    params: InterFrameMatchParams,
    key: jnp.ndarray,
    ransac_iters: int = 64,
    ransac_threshold: float = 1.0,
    lk_win: int = 10,
    lk_iters: int = 10,
    gate: float = 4.0,
) -> TrackResult:
    """ifmOpticalFlow (reference stage4_match_consecutive.cpp:333-431):
    pyramidal LK on both eyes + 1.5px epipolar consistency (:397) +
    fundamental-matrix filter, with flow-guided association onto the current
    match set (see rso.frontend.optical_flow for the deviation rationale)."""
    from rso.frontend.optical_flow import flow_guided_association, lk_track

    K = prev_matches.ridx.shape[0]
    p_ok = prev_matches.valid
    pR_xy, _, _ = _gather_right(prev_right, prev_matches.ridx)
    cR_xy, _, _ = _gather_right(cur_right, cur_matches.ridx)

    fl = lk_track(prev_pyr_l, cur_pyr_l, prev_left.xy, p_ok,
                  win=lk_win, iters=lk_iters)
    fr = lk_track(prev_pyr_r, cur_pyr_r, pR_xy, p_ok,
                  win=lk_win, iters=lk_iters)

    # epipolar consistency of the tracked pair (reference :393-398)
    epi_ok = jnp.abs(fl.pos[:, 1] - fr.pos[:, 1]) <= 1.5
    pred_ok = fl.status & fr.status & epi_ok

    cur_idx, ok = flow_guided_association(
        fl.pos, pred_ok, cur_left.xy, cur_matches.valid, gate=gate)

    survive = ok
    best_c = jnp.where(ok, cur_idx, 0).astype(jnp.int32)
    return _finish(prev_left, pR_xy, cur_left, cR_xy, best_c, survive,
                   params, key, ransac_iters, ransac_threshold)
