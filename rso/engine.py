"""The odometry engine: FrameState pytree + one jitted per-frame step.

Fixed-shape re-design of the reference's CStereoOdometryEstimator and its
per-frame driver processNewImagePair (stereo_vo
libstereo-odometry.h:147-1047, process_new_image_pair.cpp:41-385):

  * all per-frame mutable state (the reference's m_prev_imgpair /
    m_current_imgpair, ID counters, FAST thresholds, warm-start pose) lives in
    an immutable `EngineState` pytree,
  * `step(state, left, right) -> (state', StepResult)` runs stages 1-5 as ONE
    compiled XLA program — rectified grayscale in, pose out,
  * the recovery mechanism (skip the prev-frame shift on voecBadTracking /
    voecBadCondNumber, process_new_image_pair.cpp:86-95) is a jnp.where over
    the state pytree,
  * match-ID bookkeeping (C20: propagation through tracking, new IDs for
    untracked, KF max-ID) is int32 lanes updated in-graph.

The host-side `Engine` wrapper owns config/camera, jit caching, and the
python-friendly API (numpy in/out, error-code names, keyframe marking).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from rso.config import DetectMethod, IFMatchMethod, RSOConfig
from rso.frontend.detect import (
    Features,
    detect_features,
    octave_budget,
    octave_k_slots,
    update_fast_threshold,
)
from rso.frontend.pyramid import build_pyramid, to_grayscale
from rso.frontend.stereo_match import StereoMatches, match_left_right
from rso.frontend.track import TrackResult, track_interframe
from rso.geometry.stereo_camera import StereoCamera
from rso.solver.robust_gn import (
    VOEC_BAD_TRACKING,
    VOEC_FIRST_ITERATION,
    VOEC_NONE,
    PoseSolveResult,
    solve_pose,
)

# ---------------------------------------------------------------------------
# State pytrees
# ---------------------------------------------------------------------------


class OctaveData(NamedTuple):
    """Everything the engine keeps about one octave of one frame."""

    left: Features
    right: Features
    matches: StereoMatches
    match_ids: jnp.ndarray  # [K] int32, -1 for invalid slots


class FrameView(NamedTuple):
    octaves: tuple  # tuple[OctaveData, ...] length n_octaves


class EngineState(NamedTuple):
    prev: FrameView
    prev_pyr_l: tuple             # prev-frame pyramids (OPTICAL_FLOW mode or
    prev_pyr_r: tuple             # detect_every>1, else empty)
    have_prev: jnp.ndarray        # bool scalar
    since_detect: jnp.ndarray     # int32: frames since the last full detect
    #                               (drives EngineParams.detect_every)
    last_match_id: jnp.ndarray    # int32 — reference m_last_match_ID
    last_kf_max_id: jnp.ndarray   # int32 — reference m_last_kf_max_id
    last_pose: jnp.ndarray        # [6] f32 — reference m_last_computed_pose
    fast_th: jnp.ndarray          # [O] int32 — reference m_threshold
    last_error: jnp.ndarray       # int32 — reference m_error
    err_streak: jnp.ndarray       # int32 — consecutive keep-prev recoveries
    frame_idx: jnp.ndarray        # int32 — reference m_it_counter


class StepResult(NamedTuple):
    """Mirrors TStereoOdometryResult (libstereo-odometry.h:235-264)."""

    pose: jnp.ndarray                   # [6] (w,t): cur frame wrt previous
    valid: jnp.ndarray                  # bool
    error_code: jnp.ndarray             # int32 VOEC_*
    num_it: jnp.ndarray                 # int32
    num_it_final: jnp.ndarray           # int32
    detected_feats: jnp.ndarray         # [O,2] int32 (left,right)
    stereo_matches: jnp.ndarray         # [O] int32
    tracked_feats_from_last_frame: jnp.ndarray  # int32
    tracked_feats_from_last_KF: jnp.ndarray     # int32
    residuals: jnp.ndarray              # [T] f32 squared residuals
    track_mask: jnp.ndarray             # [T] bool slots that entered stage 5
    inliers: jnp.ndarray                # [T] bool final inlier set
    cost: jnp.ndarray                   # f32 final robust cost
    obs_outlier: jnp.ndarray            # [T] bool: CURRENT-frame match slots
    # whose track entered the pose solve and was judged an outlier — gates
    # which observations a keyframe contributes to the BA window


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _empty_features(k: int) -> Features:
    return Features(
        xy=jnp.zeros((k, 2), jnp.float32),
        response=jnp.zeros((k,), jnp.float32),
        valid=jnp.zeros((k,), jnp.bool_),
        desc=jnp.zeros((k, 8), jnp.uint32),
        patch=jnp.zeros((k, 64), jnp.float32),
    )


def _empty_octave(k: int) -> OctaveData:
    return OctaveData(
        left=_empty_features(k),
        right=_empty_features(k),
        matches=StereoMatches(
            ridx=jnp.full((k,), -1, jnp.int32),
            dist=jnp.zeros((k,), jnp.float32),
            valid=jnp.zeros((k,), jnp.bool_),
        ),
        match_ids=jnp.full((k,), -1, jnp.int32),
    )


def init_state(cfg: RSOConfig, img_hw: tuple | None = None) -> EngineState:
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.engine.max_kps_per_octave,
                        cfg.engine.octave_slot_decay)
    pyr_l = pyr_r = ()
    if (cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW
            or cfg.engine.detect_every > 1):
        if img_hw is None:
            raise ValueError("OPTICAL_FLOW / detect_every>1 modes need "
                             "img_hw for init_state")
        h, w = img_hw
        shapes = [(h >> o, w >> o) for o in range(O)]
        pyr_l = tuple(jnp.zeros(s_, jnp.float32) for s_ in shapes)
        pyr_r = tuple(jnp.zeros(s_, jnp.float32) for s_ in shapes)
    return EngineState(
        prev=FrameView(octaves=tuple(_empty_octave(k) for k in Ks)),
        prev_pyr_l=pyr_l,
        prev_pyr_r=pyr_r,
        have_prev=jnp.bool_(False),
        since_detect=jnp.int32(0),
        last_match_id=jnp.int32(0),
        last_kf_max_id=jnp.int32(-1),
        last_pose=jnp.zeros(6, jnp.float32),
        fast_th=jnp.full((O,), cfg.detect.initial_FAST_threshold, jnp.int32),
        last_error=jnp.int32(VOEC_NONE),
        err_streak=jnp.int32(0),
        frame_idx=jnp.int32(0),
    )


def _assign_new_ids(match_valid, tracked_mask, prop_ids, last_match_id):
    """IDs: tracked slots keep propagated ids; untracked valid matches get new
    sequential ids (reference stage4:296-305, stage3:406-407)."""
    need_new = match_valid & ~tracked_mask
    rank = jnp.cumsum(need_new.astype(jnp.int32)) - 1
    new_ids = last_match_id + rank
    ids = jnp.where(tracked_mask, prop_ids, jnp.where(need_new, new_ids, -1))
    return ids, last_match_id + jnp.sum(need_new.astype(jnp.int32))


def _stage5_nms(xy, resp, mask, img_w, img_h, min_distance):
    """Spatial decimation of the optimization set over previous-left keypoints
    (reference stage5_optimization.cpp:463-474 -> m_non_max_sup grid method).

    Dense pairwise formulation: a point survives unless a strictly better
    point (response, then slot index as tie-break) lies within
    ~min_distance/2 — the same decimation contract as the reference's
    occupancy grid, without scatter-based segment ops (colliding scatter
    writes serialize); this is one dense [T,T] compare.
    `img_w`/`img_h` are kept for signature stability.
    """
    del img_w, img_h
    r = max(float(min_distance) / 2.0, 1.0)
    T = xy.shape[0]
    idx = jnp.arange(T, dtype=jnp.int32)
    d2 = jnp.sum((xy[:, None, :] - xy[None, :, :]) ** 2, axis=-1)   # [T,T]
    better = (resp[None, :] > resp[:, None]) | (
        (resp[None, :] == resp[:, None]) & (idx[None, :] < idx[:, None]))
    kill = mask[None, :] & better & (d2 < r * r)
    return mask & ~jnp.any(kill, axis=1)


# ---------------------------------------------------------------------------
# The jitted step
# ---------------------------------------------------------------------------


def make_step(cfg: RSOConfig, cam: StereoCamera, img_h: int, img_w: int,
              rectify_maps=None, precomputed: str | None = None):
    """Build the jitted step function for a fixed config + image size.

    rectify_maps: optional ((mlx,mly),(mrx,mry)) float32 [H,W] sample maps
        (from rso.io.calib.compute_rectify_maps) applied on device before the
        pyramid — the engine half of stage 1's CStereoRectifyMap (reference
        stage1_rectify.cpp:66-73).
    precomputed: None for the full pipeline; "feats" to inject externally
        computed features (skip stages 1-2); "matches" to also inject stereo
        matches (skip stages 1-3).  This is the reference's
        use_precomputed_data seam (process_new_image_pair.cpp:131-162,
        :219-251) that SLAM layers above use.
    """
    from rso.device import platform

    platform()   # raises on a backend the step was never checked on
    O = cfg.n_octaves
    K = cfg.engine.max_kps_per_octave
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, K,
                        cfg.engine.octave_slot_decay)
    offs = [0]
    for _k in Ks:
        offs.append(offs[-1] + _k)
    from rso.config import StereoMatchMethod
    need_desc = (
        cfg.detect.detect_method in (DetectMethod.ORB, DetectMethod.FAST_ORB)
        or cfg.lr_match.match_method != StereoMatchMethod.SAD
        or cfg.if_match.ifm_method in (IFMatchMethod.DESC_BF, IFMatchMethod.DESC_WIN)
    )

    if cfg.detect.detect_method == DetectMethod.KLT:
        min_response = cfg.detect.minimum_KLT_response
    elif cfg.detect.detect_method == DetectMethod.ORB:
        min_response = cfg.detect.minimum_ORB_response
    else:
        min_response = 0.0  # reference stage3:188-193

    if precomputed and cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW:
        raise ValueError("precomputed-data injection requires a descriptor/"
                         "SAD tracking mode (no images for optical flow)")
    if precomputed and cfg.engine.detect_every > 1:
        raise ValueError("precomputed-data injection cannot combine with "
                         "detect_every>1 (propagation needs the images)")

    if rectify_maps is not None:
        (_mlx, _mly), (_mrx, _mry) = rectify_maps
        _maps = (jnp.asarray(_mlx), jnp.asarray(_mly),
                 jnp.asarray(_mrx), jnp.asarray(_mry))
    else:
        _maps = None

    def _stage_1(left_img, right_img):
        """Stage 1 (grayscale/rectify/pyramid, C5)."""
        from rso.frontend.pyramid import bilinear_remap

        gl = to_grayscale(left_img)
        gr = to_grayscale(right_img)
        if _maps is not None:
            gl = bilinear_remap(gl, _maps[0], _maps[1])
            gr = bilinear_remap(gr, _maps[2], _maps[3])
        return build_pyramid(gl, O), build_pyramid(gr, O)

    def _stage_2(state, pyr_l, pyr_r):
        """Stage 2 (detect, C6)."""
        octs = []
        new_fast_th = []
        detected = []
        for o in range(O):
            th = state.fast_th[o]
            fl = detect_features(pyr_l[o], cfg.detect, Ks[o], th, need_desc,
                                 arc=cfg.engine.fast_arc,
                                 bf16=cfg.engine.detect_bf16,
                                 topk_recall=cfg.engine.topk_recall,
                                 fast_i16=cfg.engine.fast_i16)
            fr = detect_features(pyr_r[o], cfg.detect, Ks[o], th, need_desc,
                                 arc=cfg.engine.fast_arc,
                                 bf16=cfg.engine.detect_bf16,
                                 topk_recall=cfg.engine.topk_recall,
                                 fast_i16=cfg.engine.fast_i16)
            # octave budget: keep only the strongest budget[o] slots
            slot_ok = jnp.arange(Ks[o]) < budgets[o]
            fl = fl._replace(valid=fl.valid & slot_ok)
            fr = fr._replace(valid=fr.valid & slot_ok)
            octs.append((fl, fr))
            detected.append(jnp.stack([jnp.sum(fl.valid.astype(jnp.int32)),
                                       jnp.sum(fr.valid.astype(jnp.int32))]))
            if cfg.detect.update_dyn_thresholds:
                area = pyr_l[o].shape[0] * pyr_l[o].shape[1]
                th = update_fast_threshold(
                    th, jnp.sum(fl.valid.astype(jnp.int32)), area, cfg.detect)
            new_fast_th.append(th)
        return octs, new_fast_th, detected

    def _stage_3(octs):
        """Stage 3 (stereo match, C7)."""
        cur_octs = []
        n_matches = []
        for o in range(O):
            fl, fr = octs[o]
            fxb = (float(cam.fx_l) * float(cam.baseline) / (2 ** o)
                   if cfg.lr_match.use_z_gate else None)
            m = match_left_right(fl, fr, cfg.lr_match, img_w >> o,
                                 min_response, fx_baseline=fxb,
                                 use_mxu=cfg.engine.use_mxu_distance)
            cur_octs.append(OctaveData(left=fl, right=fr, matches=m,
                                       match_ids=jnp.full((Ks[o],), -1,
                                                          jnp.int32)))
            n_matches.append(jnp.sum(m.valid.astype(jnp.int32)))
        return cur_octs, n_matches

    if precomputed == "matches":
        def step_pre(state: EngineState, octs, matches) -> tuple[EngineState, StepResult]:
            detected = [jnp.stack([jnp.sum(fl.valid.astype(jnp.int32)),
                                   jnp.sum(fr.valid.astype(jnp.int32))])
                        for fl, fr in octs]
            cur_octs = [OctaveData(left=octs[o][0], right=octs[o][1],
                                   matches=matches[o],
                                   match_ids=jnp.full((Ks[o],), -1, jnp.int32))
                        for o in range(O)]
            n_matches = [jnp.sum(m.valid.astype(jnp.int32)) for m in matches]
            pyr_l = pyr_r = None
            new_fast_th = [state.fast_th[o] for o in range(O)]
            return _tail(state, pyr_l, pyr_r, cur_octs, n_matches, detected,
                         new_fast_th)

    elif precomputed == "feats":
        def step_pre(state: EngineState, octs) -> tuple[EngineState, StepResult]:
            detected = [jnp.stack([jnp.sum(fl.valid.astype(jnp.int32)),
                                   jnp.sum(fr.valid.astype(jnp.int32))])
                        for fl, fr in octs]
            cur_octs, n_matches = _stage_3(octs)
            pyr_l = pyr_r = None
            new_fast_th = [state.fast_th[o] for o in range(O)]
            return _tail(state, pyr_l, pyr_r, cur_octs, n_matches, detected,
                         new_fast_th)
    else:
        step_pre = None

    detect_every = max(1, int(cfg.engine.detect_every))
    if detect_every > 1 and (need_desc or cfg.if_match.ifm_method
                             == IFMatchMethod.OPTICAL_FLOW):
        raise ValueError("detect_every>1 requires the SAD match/track "
                         "methods (descriptors are not re-extracted on "
                         "propagated frames; OPTICAL_FLOW already carries "
                         "its own LK stage)")

    def _propagate(state, pyr_l, pyr_r):
        """Amortized detection: LK-propagate the previous frame's matched
        stereo pairs into the current pyramids, skipping stages 2-3.

        The reference's flow mode OVERWRITES current features with raw
        LK-tracked points and lets the pool decay until re-detection
        (stage4_match_consecutive.cpp:402-412); this is that semantic as a
        scheduled perf mode.  Each propagated pair is re-validated per
        frame: LK convergence + in-bounds on both eyes, epipolar row
        consistency (|dy| <= max_y_diff like stage 3), positive disparity,
        and the stereo SAD threshold on freshly extracted 8x8 patches.
        Stage 4 then associates prev->cur through the normal windowed
        tracker (propagated slot i sits where slot i moved, so IDs and
        keyframe bookkeeping flow through the existing C20 logic).
        """
        from rso.frontend.detect import extract_patches
        from rso.frontend.optical_flow import lk_track

        cur_octs, n_matches, detected = [], [], []
        for o in range(O):
            p = state.prev.octaves[o]
            sub_pl = list(state.prev_pyr_l)[o:]
            sub_pr = list(state.prev_pyr_r)[o:]
            sub_cl = list(pyr_l)[o:]
            sub_cr = list(pyr_r)[o:]
            pair_ok = p.matches.valid
            p_ridx = jnp.maximum(p.matches.ridx, 0)
            pR_xy = p.right.xy[p_ridx]

            fl = lk_track(sub_pl, sub_cl, p.left.xy, p.left.valid)
            fr = lk_track(sub_pr, sub_cr, pR_xy, pair_ok)

            new_lxy = jnp.where(fl.status[:, None], fl.pos, p.left.xy)
            lpatch = extract_patches(pyr_l[o], new_lxy)
            left = p.left._replace(xy=new_lxy,
                                   valid=p.left.valid & fl.status,
                                   patch=jnp.where(fl.status[:, None],
                                                   lpatch, p.left.patch))

            # scatter tracked right positions back into their slots; rows
            # that did not track write out of bounds and are dropped
            upd = pair_ok & fr.status
            tgt = jnp.where(upd, p_ridx, p.right.xy.shape[0])
            new_rxy = p.right.xy.at[tgt].set(fr.pos, mode="drop")
            rpatch = extract_patches(pyr_r[o], new_rxy)
            moved = jnp.zeros(p.right.xy.shape[0],
                              bool).at[tgt].set(True, mode="drop")
            right = p.right._replace(xy=new_rxy,
                                     patch=jnp.where(moved[:, None], rpatch,
                                                     p.right.patch))

            # per-frame pair re-validation (the stage-3 acceptance gates
            # that still apply without a fresh detect)
            epi_ok = (jnp.abs(fl.pos[:, 1] - fr.pos[:, 1])
                      <= max(cfg.lr_match.max_y_diff, 1.0))
            disp_ok = (fl.pos[:, 0] - fr.pos[:, 0]) > 0.0
            dist = jnp.sum(jnp.abs(lpatch - rpatch[p_ridx]), axis=1)
            dist_ok = dist <= cfg.lr_match.sad_max_distance
            m_ok = (pair_ok & fl.status & fr.status & epi_ok & disp_ok
                    & dist_ok)
            matches = p.matches._replace(
                valid=m_ok,
                dist=jnp.where(m_ok, dist, jnp.float32(1e9)))

            cur_octs.append(OctaveData(left=left, right=right,
                                       matches=matches,
                                       match_ids=jnp.full(
                                           (Ks[o],), -1, jnp.int32)))
            n_matches.append(jnp.sum(m_ok.astype(jnp.int32)))
            detected.append(jnp.stack(
                [jnp.sum(left.valid.astype(jnp.int32)),
                 jnp.sum(right.valid.astype(jnp.int32))]))
        return cur_octs, n_matches, detected

    def step(state: EngineState, left_img, right_img) -> tuple[EngineState, StepResult]:
        pyr_l, pyr_r = _stage_1(left_img, right_img)
        if detect_every == 1:
            octs, new_fast_th, detected = _stage_2(state, pyr_l, pyr_r)
            cur_octs, n_matches = _stage_3(octs)
            return _tail(state, pyr_l, pyr_r, cur_octs, n_matches, detected,
                         new_fast_th)

        prev_pairs = sum(jnp.sum(oc.matches.valid.astype(jnp.int32))
                         for oc in state.prev.octaves)
        do_detect = (~state.have_prev
                     | (state.since_detect + 1 >= detect_every)
                     | (prev_pairs < cfg.engine.propagate_min_matches)
                     | (state.err_streak > 0))

        def _detect_branch(_):
            octs, new_fast_th, detected = _stage_2(state, pyr_l, pyr_r)
            cur_octs, n_matches = _stage_3(octs)
            return (tuple(cur_octs), tuple(n_matches), tuple(detected),
                    tuple(new_fast_th))

        def _prop_branch(_):
            cur_octs, n_matches, detected = _propagate(state, pyr_l, pyr_r)
            return (tuple(cur_octs), tuple(n_matches), tuple(detected),
                    tuple(state.fast_th[o] for o in range(O)))

        cur_octs, n_matches, detected, new_fast_th = lax.cond(
            do_detect, _detect_branch, _prop_branch, None)
        return _tail(state, pyr_l, pyr_r, list(cur_octs), list(n_matches),
                     list(detected), list(new_fast_th),
                     did_detect=do_detect)

    def _tail(state, pyr_l, pyr_r, cur_octs, n_matches, detected, new_fast_th,
              did_detect=True):

        # ---- stage 4: inter-frame tracking (C8) + IDs (C20) -----------------
        key = jax.random.fold_in(jax.random.PRNGKey(7), state.frame_idx)
        tracks: list[TrackResult] = []
        last_id = state.last_match_id
        final_octs = []
        n_tracked_total = jnp.int32(0)
        n_tracked_kf = jnp.int32(0)
        for o in range(O):
            p = state.prev.octaves[o]
            c = cur_octs[o]
            if cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW:
                from rso.frontend.track import track_optical_flow

                # pyramids sliced to [o:] — octave-o features live in
                # octave-o pixel coords, so the LK pyramid for this octave
                # must start at level o (pre-round-5 this passed the full
                # pyramid, so octave>0 features tracked at 2^o-wrong
                # positions, failed the LK error gate, and contributed
                # nothing to flow mode)
                trk = track_optical_flow(
                    list(state.prev_pyr_l)[o:], list(state.prev_pyr_r)[o:],
                    list(pyr_l)[o:], list(pyr_r)[o:],
                    p.left, p.right, p.matches,
                    c.left, c.right, c.matches,
                    cfg.if_match, jax.random.fold_in(key, o),
                    ransac_iters=cfg.engine.ransac_iters,
                    ransac_threshold=cfg.engine.ransac_threshold,
                )
            else:
                # fundamental-matrix filtering runs ONCE on the flat
                # cross-octave track set below (cheaper + better-conditioned
                # than the reference's per-octave filters)
                ifm = dataclasses.replace(cfg.if_match,
                                          filter_fund_matrix=False)
                trk = track_interframe(
                    p.left, p.right, p.matches,
                    c.left, c.right, c.matches,
                    ifm, jax.random.fold_in(key, o),
                    ransac_iters=cfg.engine.ransac_iters,
                    ransac_threshold=cfg.engine.ransac_threshold,
                    use_mxu=cfg.engine.use_mxu_distance,
                )
            # no previous frame -> nothing tracked
            trk_valid = trk.valid & state.have_prev
            trk_idx = jnp.where(trk_valid, trk.cur_idx, -1)
            trk = TrackResult(cur_idx=trk_idx, valid=trk_valid,
                              n_tracked=jnp.sum(trk_valid.astype(jnp.int32)))
            tracks.append(trk)

        # ---- gather tracks into the flat cross-octave set -------------------
        prev_obs_l, cur_obs_l, resp_l, mask_l, w_l = [], [], [], [], []
        for o in range(O):
            p = state.prev.octaves[o]
            c = cur_octs[o]
            trk = tracks[o]
            # octave -> full-res mapping.  The 2x2-mean pyramid puts octave-o
            # pixel centers at 2^o*x + (2^o-1)/2 full-res (the reference's
            # bare *=2^o scaling, stage5_optimization.cpp:422, carries a
            # half-pixel-per-level bias we correct here).
            scale = float(2 ** o)
            shift = (scale - 1.0) / 2.0

            p_ridx = jnp.maximum(p.matches.ridx, 0)
            pR_xy = p.right.xy[p_ridx]
            prev_obs = jnp.concatenate(
                [p.left.xy, pR_xy[:, :1], pR_xy[:, 1:2]], axis=1) * scale + shift

            safe_c = jnp.maximum(trk.cur_idx, 0)
            cL_xy = c.left.xy[safe_c]
            c_ridx = jnp.maximum(c.matches.ridx[safe_c], 0)
            cR_xy = c.right.xy[c_ridx]

            # subpixel: align current observations to the previous frame's
            # patches (LK, translation-only) before they reach the solver
            if cfg.engine.subpixel_track_refine and pyr_l is not None:
                from rso.frontend.refine import refine_positions

                # stored templates are centered on ROUNDED prev coords; the
                # LK-aligned position therefore estimates the rounded point's
                # new location — add back the prev subpixel fraction so the
                # measurement is consistent with the subpixel prev_obs
                frac_l = p.left.xy - jnp.round(p.left.xy)
                frac_r = pR_xy - jnp.round(pR_xy)
                cL_xy = refine_positions(
                    pyr_l[o], p.left.patch, cL_xy, trk.valid,
                    iters=cfg.engine.refine_iters,
                    ssd_gate=cfg.engine.refine_ssd_gate) + frac_l
                pR_patch = p.right.patch[p_ridx]
                cR_xy = refine_positions(
                    pyr_r[o], pR_patch, cR_xy, trk.valid,
                    iters=cfg.engine.refine_iters,
                    ssd_gate=cfg.engine.refine_ssd_gate) + frac_r

            cur_obs = jnp.concatenate(
                [cL_xy, cR_xy[:, :1], cR_xy[:, 1:2]], axis=1) * scale + shift

            prev_obs_l.append(prev_obs)
            cur_obs_l.append(cur_obs)
            resp_l.append(p.left.response)
            mask_l.append(trk.valid)
            # octave-o pixel noise is 2^o x larger at full-res: weight 1/4^o
            w_l.append(jnp.full((Ks[o],), 1.0 / (scale * scale),
                                jnp.float32))

        prev_obs = jnp.concatenate(prev_obs_l)   # [T,4]
        cur_obs = jnp.concatenate(cur_obs_l)
        resp = jnp.concatenate(resp_l)
        tmask = jnp.concatenate(mask_l)
        obs_w = jnp.concatenate(w_l)

        # single flat fundamental-matrix filter over all octaves (reference
        # stage4:681-705 runs one per octave per eye; one model over the
        # full-resolution flat set uses more support per hypothesis)
        if (cfg.if_match.filter_fund_matrix
                and cfg.if_match.ifm_method != IFMatchMethod.OPTICAL_FLOW):
            from rso.solver.ransac import ransac_fundamental

            kL, kR = jax.random.split(jax.random.fold_in(key, 1000))
            # both eyes in ONE vmapped call so the per-hypothesis 9x9
            # Cholesky batches to [2,H,9,9] in a single custom call
            res2 = jax.vmap(
                lambda p1, p2, k: ransac_fundamental(
                    p1, p2, tmask, k, n_iters=cfg.engine.ransac_iters,
                    threshold=cfg.engine.ransac_threshold)
            )(jnp.stack([prev_obs[:, :2], prev_obs[:, 2:4]]),
              jnp.stack([cur_obs[:, :2], cur_obs[:, 2:4]]),
              jnp.stack([kL, kR]))
            both = res2.inliers[0] & res2.inliers[1]
            tmask = jnp.where(res2.ok[0] & res2.ok[1], both, tmask)

        # ---- ID propagation (C20) with the POST-filter tracks ---------------
        # (false tracks must not carry landmark identity into the BA window)
        n_tracked_total = jnp.sum(tmask.astype(jnp.int32))
        tgts = []
        claims_l = []
        for o in range(O):
            p = state.prev.octaves[o]
            c = cur_octs[o]
            trk_ok = tmask[offs[o]:offs[o + 1]]
            trk_idx = tracks[o].cur_idx
            # route prev ids to tracked cur slots.  Dense one-hot instead of
            # a scatter (colliding .at[].set writes serialize); tracks are 1-to-1 by
            # arbitration so each cur slot has at most one claimant and the
            # max-reduce is exact.  Invalid entries point at Ks[o] and fall
            # outside the iota — the scatter mode="drop" equivalent.
            tgt = jnp.where(trk_ok, trk_idx, Ks[o])
            tgts.append(tgt)
            claims = tgt[:, None] == jnp.arange(Ks[o], dtype=jnp.int32)[None, :]
            claims_l.append(claims)
            tracked_mask_cur = jnp.any(claims, axis=0)
            prop_ids = jnp.max(
                jnp.where(claims, p.match_ids[:, None], -1), axis=0)
            ids, last_id = _assign_new_ids(
                c.matches.valid, tracked_mask_cur, prop_ids, last_id)
            final_octs.append(c._replace(match_ids=ids))
            n_tracked_kf = n_tracked_kf + jnp.sum(
                ((ids >= 0) & (ids <= state.last_kf_max_id)).astype(jnp.int32))
        cur_view = FrameView(octaves=tuple(final_octs))

        # ---- stage 4.1: robustness gate (C9) --------------------------------
        bad_tracking = state.have_prev & (
            n_tracked_total < cfg.least_squares.bad_tracking_th)

        nms_keep = _stage5_nms(prev_obs[:, :2], resp, tmask, img_w, img_h,
                               cfg.detect.min_distance)
        smask = tmask & nms_keep

        init_pose = jnp.where(
            cfg.least_squares.use_previous_pose_as_initial,
            state.last_pose, jnp.zeros(6, jnp.float32))
        sol = solve_pose(cam, prev_obs, cur_obs, smask, cfg.least_squares,
                         initial_pose=init_pose, obs_weight=obs_w)

        # per-CURRENT-slot outlier flags: a track that entered the solve and
        # was cut by the residual threshold marks its current match slot so
        # the BA window never ingests that observation (tracked-but-rejected
        # correspondences are exactly the aliased landmarks that destabilize
        # short-lifetime window solves)
        outlier_prev = smask & ~sol.inliers
        # dense one-hot routing (see claims above) instead of a scatter
        obs_outlier = jnp.concatenate([
            jnp.any(claims_l[o]
                    & outlier_prev[offs[o]:offs[o + 1], None], axis=0)
            for o in range(O)])

        # ---- error codes & result -------------------------------------------
        first = ~state.have_prev
        error_code = jnp.where(
            first, VOEC_FIRST_ITERATION,
            jnp.where(bad_tracking, VOEC_BAD_TRACKING, sol.error_code),
        ).astype(jnp.int32)
        valid = sol.valid & ~bad_tracking & ~first

        result = StepResult(
            pose=jnp.where(valid, sol.pose, jnp.zeros(6, jnp.float32)),
            valid=valid,
            error_code=error_code,
            num_it=sol.num_it,
            num_it_final=sol.num_it_final,
            detected_feats=jnp.stack(detected),
            stereo_matches=jnp.stack(n_matches),
            tracked_feats_from_last_frame=n_tracked_total,
            tracked_feats_from_last_KF=n_tracked_kf,
            residuals=sol.residuals,
            track_mask=smask,
            inliers=sol.inliers,
            cost=sol.cost,
            obs_outlier=obs_outlier,
        )

        # ---- state shift (C2 recovery semantics) ----------------------------
        # only voecBadTracking and voecBadCondNumber skip the prev-frame shift
        # (process_new_image_pair.cpp:86-89); cost-increase aborts still
        # shift.  Unlike the reference the skip is BOUNDED: after
        # max_recovery_frames consecutive failures the frame is consumed
        # anyway, so a marginal failure cannot wedge the engine against an
        # ever-more-distant stale frame (the camera keeps moving; see
        # GeneralParams.max_recovery_frames).
        from rso.solver.robust_gn import VOEC_BAD_COND_NUMBER
        recoverable = (bad_tracking | (
            (sol.error_code == VOEC_BAD_COND_NUMBER) & state.have_prev)) & ~first
        keep_prev = recoverable & (
            state.err_streak < cfg.general.max_recovery_frames)
        new_streak = jnp.where(keep_prev, state.err_streak + 1, jnp.int32(0))

        new_prev = jax.tree_util.tree_map(
            lambda new, old: jnp.where(keep_prev, old, new), cur_view,
            state.prev)
        if (cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW
                or max(1, int(cfg.engine.detect_every)) > 1):
            new_pyr_l = tuple(jnp.where(keep_prev, o_, n_)
                              for n_, o_ in zip(pyr_l, state.prev_pyr_l))
            new_pyr_r = tuple(jnp.where(keep_prev, o_, n_)
                              for n_, o_ in zip(pyr_r, state.prev_pyr_r))
        else:
            new_pyr_l = state.prev_pyr_l
            new_pyr_r = state.prev_pyr_r
        new_last_pose = jnp.where(
            valid & cfg.least_squares.use_previous_pose_as_initial
            & (not cfg.least_squares.use_custom_initial_pose),
            sol.delta_pose, state.last_pose)

        # a kept-prev (recovery) frame leaves the OLD features in state, so
        # it never counts as a fresh detection regardless of the branch run
        new_since = jnp.where(keep_prev | ~jnp.asarray(did_detect),
                              state.since_detect + 1, jnp.int32(0))
        new_state = EngineState(
            prev=new_prev,
            prev_pyr_l=new_pyr_l,
            prev_pyr_r=new_pyr_r,
            have_prev=jnp.bool_(True),
            since_detect=new_since,
            last_match_id=last_id,
            last_kf_max_id=state.last_kf_max_id,
            last_pose=new_last_pose,
            fast_th=jnp.stack(new_fast_th),
            last_error=error_code,
            err_streak=new_streak,
            frame_idx=state.frame_idx + 1,
        )
        return new_state, result

    return step_pre if precomputed else step


# ---------------------------------------------------------------------------
# Host-side wrapper
# ---------------------------------------------------------------------------


class Engine:
    """Host-facing engine: owns config + camera, jit-caches step per image size.

    Public API mirrors the reference class (processNewImagePair ->
    process_frame, setThisFrameAsKF, resetIds, saveStateToFile ->
    rso.io.checkpoint).
    """

    def __init__(self, cfg: RSOConfig, cam: StereoCamera, rectify_maps=None):
        self.cfg = cfg
        self.cam = cam
        self.rectify_maps = rectify_maps
        self.state: EngineState | None = None
        self._state_before_last: EngineState | None = None
        self._step_cache: dict[tuple, object] = {}

    def _get_step(self, h: int, w: int, precomputed: str | None = None):
        key = (h, w, precomputed)
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                make_step(self.cfg, self.cam, h, w,
                          rectify_maps=self.rectify_maps,
                          precomputed=precomputed))
        return self._step_cache[key]

    def process_frame(self, left_img, right_img,
                      repeat: bool = False) -> StepResult:
        """Run one frame through the pipeline; updates internal state.

        repeat=True re-runs against the SAME previous frame as the last call
        (the reference's request.repeat semantics,
        process_new_image_pair.cpp:86-95: the prev-frame shift is skipped so
        the new images are matched against the last good frame).
        """
        left_img = jnp.asarray(left_img)
        right_img = jnp.asarray(right_img)
        h, w = left_img.shape[:2]
        if self.state is None:
            self.state = init_state(self.cfg, (h, w))
        if repeat and self._state_before_last is not None:
            self.state = self._state_before_last
        self._state_before_last = self.state
        step = self._get_step(h, w)
        self.state, result = step(self.state, left_img, right_img)
        return result

    def process_chunk(self, left_imgs, right_imgs) -> StepResult:
        """Run N consecutive frames in ONE device dispatch via lax.scan.

        The offline-throughput surface: the engine state threads through the
        scan carry on device and results come back stacked along a leading
        frame axis.  Math and state evolution are identical to N sequential
        process_frame calls; per-dispatch host overhead amortizes away.
        """
        left_imgs = jnp.asarray(left_imgs)
        right_imgs = jnp.asarray(right_imgs)
        h, w = left_imgs.shape[1:3]
        if self.state is None:
            self.state = init_state(self.cfg, (h, w))
        self._state_before_last = self.state

        # All modes run unsliced (the patch-based LK rewrite replaced the
        # per-sample-gather LK that once forced flow mode into short
        # slices; docs/FLOW_SCAN_FAULT.md).
        key = (h, w, "__chunk__")
        if key not in self._step_cache:
            step = make_step(self.cfg, self.cam, h, w,
                             rectify_maps=self.rectify_maps)

            def chunk(st, ls, rs):
                return lax.scan(lambda s, lr: step(s, lr[0], lr[1]),
                                st, (ls, rs))

            self._step_cache[key] = jax.jit(chunk)
        self.state, results = self._step_cache[key](
            self.state, left_imgs, right_imgs)
        return results

    # ---- dynamic threshold accessors (reference h:529-541) ----------------

    def get_fast_threshold(self) -> int:
        st = self.state or init_state(self.cfg)
        return int(np.asarray(st.fast_th)[0])

    def set_fast_threshold(self, value: int):
        """Clamp to [fast_min_th, fast_max_th] and set all octaves (the
        dynamic FAST threshold the SLAM layer adjusts)."""
        v = int(np.clip(value, self.cfg.detect.fast_min_th,
                        self.cfg.detect.fast_max_th))
        if self.state is None:
            self.state = init_state(self.cfg)
        self.state = self.state._replace(
            fast_th=jnp.full_like(self.state.fast_th, v))

    def reset_fast_threshold(self):
        self.set_fast_threshold(self.cfg.detect.initial_FAST_threshold)

    def is_fast_th_min(self) -> bool:
        return self.get_fast_threshold() == self.cfg.detect.fast_min_th

    def is_fast_th_max(self) -> bool:
        return self.get_fast_threshold() == self.cfg.detect.fast_max_th

    def get_orb_threshold(self) -> float:
        return self.cfg.lr_match.orb_max_distance

    def set_orb_threshold(self, value: float):
        """Clamp to [orb_min_th, orb_max_th]; the ORB matching distance is a
        static jit arg, so changing it recompiles the step (the reference's
        m_current_orb_th is adjusted at SLAM-keyframe rate, so this is
        rare)."""
        v = float(np.clip(value, self.cfg.lr_match.orb_min_th,
                          self.cfg.lr_match.orb_max_th))
        self.cfg = self.cfg.replace(
            lr_match=dataclasses.replace(self.cfg.lr_match,
                                         orb_max_distance=v),
            if_match=dataclasses.replace(self.cfg.if_match,
                                         orb_max_distance=v),
        )
        self._step_cache.clear()

    def is_orb_th_min(self) -> bool:
        return self.cfg.lr_match.orb_max_distance <= self.cfg.lr_match.orb_min_th

    def is_orb_th_max(self) -> bool:
        return self.cfg.lr_match.orb_max_distance >= self.cfg.lr_match.orb_max_th

    def set_ids(self, ids):
        """Overwrite octave-0 match IDs (reference setIds, h:687-694 — used
        by the SLAM layer to re-key matches after loop closure)."""
        assert self.state is not None
        ids = np.asarray(ids, np.int32)
        K = self.state.prev.octaves[0].match_ids.shape[0]
        oct0 = self.state.prev.octaves[0]
        new_ids = jnp.full((K,), -1, jnp.int32).at[: len(ids)].set(
            jnp.asarray(ids[:K]))
        octs = (oct0._replace(match_ids=new_ids),) + self.state.prev.octaves[1:]
        self.state = self.state._replace(
            prev=FrameView(octaves=octs),
            last_match_id=jnp.maximum(self.state.last_match_id,
                                      jnp.int32(ids.max() + 1 if len(ids) else 0)))

    def process_precomputed(self, feats_left, feats_right, matches=None,
                            img_hw=(376, 1241)) -> StepResult:
        """Run the pipeline on externally computed features (the reference's
        use_precomputed_data path, process_new_image_pair.cpp:131-162): skip
        stages 1-2, and stage 3 too when `matches` is given.

        feats_left/right: per-octave lists of dicts or Features with keys
        xy [N,2], response [N], desc [N,8] uint32 (descriptor modes).
        matches: optional per-octave list of (left_idx, right_idx) int arrays.
        """
        if self.cfg.if_match.ifm_method == IFMatchMethod.OPTICAL_FLOW:
            raise ValueError("precomputed-data injection requires a "
                             "descriptor/SAD tracking mode")
        O = self.cfg.n_octaves
        Ks = octave_k_slots(self.cfg.detect.orb_nfeats, O,
                            self.cfg.engine.max_kps_per_octave,
                            self.cfg.engine.octave_slot_decay)
        h, w = img_hw
        if self.state is None:
            self.state = init_state(self.cfg, (h, w))

        def to_features(f, K) -> Features:
            if isinstance(f, Features):
                return f
            xy = np.asarray(f["xy"], np.float32)
            n = min(len(xy), K)
            out = _empty_features(K)
            out = out._replace(
                xy=out.xy.at[:n].set(xy[:n]),
                response=out.response.at[:n].set(
                    np.asarray(f.get("response", np.ones(len(xy))),
                               np.float32)[:n]),
                valid=out.valid.at[:n].set(True),
            )
            if "desc" in f:
                out = out._replace(
                    desc=out.desc.at[:n].set(
                        np.asarray(f["desc"], np.uint32)[:n]))
            if "patch" in f:
                out = out._replace(
                    patch=out.patch.at[:n].set(
                        np.asarray(f["patch"], np.float32)[:n]))
            return out

        octs = tuple((to_features(feats_left[o], Ks[o]),
                      to_features(feats_right[o], Ks[o]))
                     for o in range(O))
        if matches is None:
            step = self._get_step(h, w, precomputed="feats")
            self.state, result = step(self.state, octs)
        else:
            ms = []
            for o in range(O):
                li, ri = matches[o]
                m = StereoMatches(
                    ridx=jnp.full((Ks[o],), -1, jnp.int32),
                    dist=jnp.zeros((Ks[o],), jnp.float32),
                    valid=jnp.zeros((Ks[o],), jnp.bool_),
                )
                li = np.asarray(li, np.int64)
                ri = np.asarray(ri, np.int64)
                keep = (li < Ks[o]) & (ri < Ks[o])
                m = m._replace(
                    ridx=m.ridx.at[li[keep]].set(ri[keep].astype(np.int32)),
                    valid=m.valid.at[li[keep]].set(True),
                )
                ms.append(m)
            step = self._get_step(h, w, precomputed="matches")
            self.state, result = step(self.state, octs, tuple(ms))
        return result

    def set_this_frame_as_kf(self):
        """Record the max match ID as the KF watermark (reference
        setThisFrameAsKF, h:675-685)."""
        assert self.state is not None
        max_id = jnp.int32(-1)
        for o in self.state.prev.octaves:
            max_id = jnp.maximum(max_id, jnp.max(o.match_ids))
        self.state = self.state._replace(last_kf_max_id=max_id)

    def reset_ids(self):
        """Renumber current matches 0..N-1 and mark this frame as KF
        (reference resetIds + the m_reset block,
        process_new_image_pair.cpp:254-267)."""
        assert self.state is not None
        last = jnp.int32(0)
        new_octs = []
        for o in self.state.prev.octaves:
            valid = o.match_ids >= 0
            rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
            ids = jnp.where(valid, rank + last, -1)
            last = last + jnp.sum(valid.astype(jnp.int32))
            new_octs.append(o._replace(match_ids=ids))
        self.state = self.state._replace(
            prev=FrameView(octaves=tuple(new_octs)),
            last_match_id=last,
            last_kf_max_id=last - 1,
        )

    def reset(self):
        self.state = None
