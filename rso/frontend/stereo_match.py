"""Stage 3: left<->right stereo matching as one masked distance matrix.

Fixed-shape re-design of the reference's stage3_match_left_right (stereo_vo
stage3_match_left_right.cpp:62-484).  The row-bucketed triple loop
(rows x left-feats x right-feats-in-window) becomes a dense [K,K] cost matrix
with additive masks — mathematically the same acceptance rules, data-parallel:

  * epipolar constraint  |yL - yR| <= max_y_diff      (:254-256 row window)
  * disparity constraint 1 <= xL - xR <= 0.7*W        (:247, :283-285)
  * response filter      resp >= minimum_response     (:279-280)
  * border filter for SAD patches                     (:289-295)
  * distance threshold   dist <= max_distance         (:334)
  * ratio test           best/second <= max_ratio     (:347-349, SAD mode)
  * right-feature arbitration: keep FIRST (scan order) or BEST (robust
    1-to-1) left match per right feature               (:357-388)

Output is *left-slot aligned*: slot l holds the right index matched to left
feature l (or -1).  This replaces the reference's compacted DMatch list — a
fixed-shape, jit-stable encoding of the same data (at most one match per left
feature holds there too, by construction of its loop).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rso.config import LeftRightMatchParams, StereoMatchMethod
from rso.frontend.detect import Features

_BIG = jnp.float32(1e9)


class StereoMatches(NamedTuple):
    ridx: jnp.ndarray   # [K] int32: right-feature index matched to left slot, -1 if none
    dist: jnp.ndarray   # [K] f32 match distance
    valid: jnp.ndarray  # [K] bool


# Distance matrices live in rso.kernels; these aliases keep the stage-3
# module self-describing.
from rso.kernels.distance import (  # noqa: E402
    hamming_matrix_jnp as hamming_matrix,
    sad_matrix_jnp as sad_matrix,
    stereo_sad_best,
)


def _arbitrate_right(cand_r: jnp.ndarray, cand_d: jnp.ndarray,
                     cand_ok: jnp.ndarray, K_r: int, keep_best: bool):
    """One-to-one right-feature arbitration.

    cand_r[l]: chosen right index for left l; cand_d[l]: its distance;
    cand_ok[l]: left l has a candidate.  Returns the surviving left mask.

    keep_best=True  -> per right feature keep the lowest-distance left
                       (reference robust 1-to-1, :369-376)
    keep_best=False -> keep the first left in scan order (reference :381-386;
                       scan order is row-major = increasing slot index since
                       features are y-sorted)
    """
    K_l = cand_r.shape[0]
    l_idx = jnp.arange(K_l, dtype=jnp.int32)
    if keep_best:
        # key encodes (distance, index) for a total order; distances are
        # integral (SAD <= 64*255, Hamming <= 256) so key fits int32
        key = jnp.clip(cand_d, 0, 2**20).astype(jnp.int32) * K_l + l_idx
    else:
        key = l_idx
    key = jnp.where(cand_ok, key, jnp.int32(2**31 - 1))
    # dense one-hot min-reduce instead of segment_min: colliding scatter
    # writes serialize, the [K_l,K_r] compare + row reduction does not
    claims = (cand_r[:, None] == jnp.arange(K_r, dtype=jnp.int32)[None, :]
              ) & cand_ok[:, None]
    keymat = jnp.where(claims, key[:, None], jnp.int32(2**31 - 1))
    best_key = jnp.min(keymat, axis=0)                         # [K_r]
    safe_r = jnp.clip(cand_r, 0, K_r - 1)
    return cand_ok & (key == best_key[safe_r])


def match_left_right(
    left: Features,
    right: Features,
    params: LeftRightMatchParams,
    img_w: int,
    min_response: float,
    fx_baseline: float | None = None,
    use_mxu: bool = False,
) -> StereoMatches:
    """Stereo-match one octave's left/right feature sets.

    fx_baseline = fx * baseline (octave-scaled): when given, the disparity
    window honors params.min_z/max_z — the depth gate the reference declares
    (TLeftRightMatchParams h:497) and sketches in comments
    (stage3_match_left_right.cpp:155-156) but leaves hardcoded to [1, 0.7*W].

    SAD method: exact all-pairs SAD (kernels.distance.stereo_sad_best), or
    with use_mxu the squared-L2 shortlist re-scored by exact SAD.
    """
    method = params.match_method
    K = left.xy.shape[0]

    xl, yl = left.xy[:, 0], left.xy[:, 1]
    xr, yr = right.xy[:, 0], right.xy[:, 1]

    max_disp = img_w * 0.7 if method in (
        StereoMatchMethod.SAD, StereoMatchMethod.DESC_RBR) else float(img_w)

    def build_pair_ok():
        """[K,K] admissibility planes for the shortlist and Hamming paths
        (the exact-SAD path derives the same geometry from the [K]
        coordinate vectors)."""
        ok = left.valid[:, None] & right.valid[None, :]
        ok &= (left.response[:, None] >= min_response) & (
            right.response[None, :] >= min_response)
        # epipolar row window (reference :254-256; BF post-filter :162-164).
        # Rounded rows preserve the reference's integer row-bucket semantics
        # with subpixel keypoints.
        dy = jnp.abs(jnp.round(yl)[:, None] - jnp.round(yr)[None, :])
        ok &= dy <= jnp.maximum(params.max_y_diff, 0.0)
        # disparity window (reference :283-285 row path, :155-165 BF path)
        disp = xl[:, None] - xr[None, :]
        ok &= (disp >= 1.0) & (disp <= max_disp)
        return ok

    if method == StereoMatchMethod.SAD:
        max_distance = float(params.sad_max_distance)
        use_ratio = True
    else:  # smDescBF / smDescRbR: Hamming on descriptors
        max_distance = float(params.orb_max_distance)
        use_ratio = False  # reference applies no ratio test on ORB paths

    if method == StereoMatchMethod.SAD and not use_mxu:
        best_r, best_d, second_d = stereo_sad_best(
            left.patch, right.patch, left.xy, right.xy,
            left.valid & (left.response >= min_response),
            right.valid & (right.response >= min_response),
            max_y_diff=float(max(params.max_y_diff, 0.0)),
            max_disp=float(max_disp), max_distance=max_distance)
    elif method == StereoMatchMethod.SAD:
        # coarse-to-fine: squared-L2 shortlist (one matmul), exact SAD on
        # the top 8 (kernels.distance.sad_topk_refine)
        from rso.kernels.distance import sad_topk_refine

        idx, sad, ok = sad_topk_refine(left.patch, right.patch,
                                        build_pair_ok())
        sadm = jnp.where(ok & (sad <= max_distance), sad, _BIG)
        j = jnp.argmin(sadm, axis=1)
        best_d = jnp.take_along_axis(sadm, j[:, None], axis=1)[:, 0]
        best_r = jnp.take_along_axis(idx, j[:, None], axis=1)[:, 0]
        row2 = jnp.where(jax.nn.one_hot(j, sadm.shape[1], dtype=jnp.bool_),
                         _BIG, sadm)
        second_d = jnp.min(row2, axis=1)
    else:
        D = hamming_matrix(left.desc, right.desc)
        Dm = jnp.where(build_pair_ok() & (D <= max_distance), D, _BIG)

        # best + second-best per left feature
        best_r = jnp.argmin(Dm, axis=1).astype(jnp.int32)
        best_d = jnp.take_along_axis(Dm, best_r[:, None], axis=1)[:, 0]
        row2 = jnp.where(
            jax.nn.one_hot(best_r, Dm.shape[1], dtype=jnp.bool_), _BIG, Dm)
        second_d = jnp.min(row2, axis=1)

    cand_ok = best_d < _BIG
    if use_ratio:
        ratio = best_d / jnp.maximum(second_d, 1e-6)
        cand_ok &= (second_d >= _BIG) | (ratio <= params.sad_max_ratio)

    # z-gate as a POST-filter on the winning match's disparity (the reference
    # BF path filters after matching, :158-175).  Gating the search itself
    # would silently promote a wrong second-best candidate when the true
    # match is out of depth range.
    if fx_baseline is not None:
        best_disp = xl - xr[jnp.clip(best_r, 0, K - 1)]
        min_disp_z = fx_baseline / params.max_z
        max_disp_z = fx_baseline / max(params.min_z, 1e-6)
        cand_ok &= (best_disp >= min_disp_z) & (best_disp <= max_disp_z)

    # (reference non-robust mode keeps the FIRST scan-order claim :381-386)
    survive = _arbitrate_right(best_r, best_d, cand_ok, K,
                               keep_best=params.enable_robust_1to1_match)

    ridx = jnp.where(survive, best_r, -1)
    dist = jnp.where(survive, best_d, 0.0)
    return StereoMatches(ridx=ridx, dist=dist, valid=survive)
