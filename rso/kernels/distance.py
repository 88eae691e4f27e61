"""All-pairs patch / descriptor distance matrices in plain jnp.

The reference's per-pair scalar kernels — compute_SAD8 (stereo_vo
compute_SAD8.cpp:71-97) and the Wegner popcount Hamming loop
(stage3_match_left_right.cpp:320-332) — become batched all-pairs distance
matrices that XLA fuses: one pass computes every candidate pair of an
octave, plus the exact-SAD cores of stages 3 and 4 (masked all-pairs SAD
-> per-row best / second best).  On the H100 XLA's code for these dense
forms ran the step faster than a hand-written fused kernel (PERF.md, PR 1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_BIG = 1e9


def sad_matrix_jnp(patches_a: jnp.ndarray, patches_b: jnp.ndarray) -> jnp.ndarray:
    """[Ka,P] x [Kb,P] f32 -> [Ka,Kb] sum of absolute differences."""
    return jnp.sum(jnp.abs(patches_a[:, None, :] - patches_b[None, :, :]),
                   axis=-1)


def sad_matrix_mxu(patches_a: jnp.ndarray, patches_b: jnp.ndarray) -> jnp.ndarray:
    """SAD-equivalent patch distance computed as one matrix product.

    The exact all-pairs SAD is an elementwise [Ka,Kb,P] abs-diff reduction
    no matrix unit can express; the squared-L2 distance CAN (one matmul:
    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b) and ranks candidates nearly
    identically.  The result is mapped back to the SAD scale via the Gaussian
    moment relation E[SAD] = P*sigma*sqrt(2/pi), E[SSD] = P*sigma^2 ->
    SAD ~= sqrt(SSD * P * 2/pi), so every downstream threshold
    (sad_max_distance, sad_max_ratio) keeps its calibration.
    Equivalence-vs-ranking validated in tests/test_kernels.py.
    """
    P = patches_a.shape[1]
    return jnp.sqrt(ssd_matrix(patches_a, patches_b) * (P * 2.0 / jnp.pi))


def ssd_matrix(patches_a: jnp.ndarray, patches_b: jnp.ndarray,
               precision=None) -> jnp.ndarray:
    """All-pairs squared-L2 patch distance via one matmul.

    `precision=lax.Precision.DEFAULT` lets the cross-term run at reduced
    precision (TF32 on a GPU's tensor cores) — safe whenever the result only
    RANKS a shortlist that exact SAD re-scores (both frontend call sites),
    not when the value itself is thresholded.
    """
    if precision is None:
        precision = lax.Precision.HIGHEST
    ab = lax.dot_general(patches_a, patches_b, (((1,), (1,)), ((), ())),
                         precision=precision)
    na = jnp.sum(patches_a * patches_a, axis=-1)
    nb = jnp.sum(patches_b * patches_b, axis=-1)
    return jnp.maximum(na[:, None] + nb[None, :] - 2.0 * ab, 0.0)


def sad_topk_refine(patches_a: jnp.ndarray, patches_b: jnp.ndarray,
                    pair_ok: jnp.ndarray, k: int = 8):
    """Coarse-to-fine all-pairs SAD: squared-L2 shortlist + exact SAD.

    The [Ka,Kb] candidate field is ranked by the matmul-based squared-L2
    distance (sad_matrix_mxu rationale) and only the top-k shortlist per
    left feature is re-scored with the EXACT abs-diff SAD.  Downstream
    acceptance (thresholds, ratio test) therefore keeps exact-SAD semantics;
    only candidates the coarse metric ranks below the top-k are lost
    (pure-SSD ranking measurably degrades matching at KITTI motion scales —
    0.75 vs 0.22 ATE on the bench scene — while the refined form is
    ATE-neutral).

    Returns (idx [Ka,k] int32 right indices, sad [Ka,k] f32 exact SADs,
    ok [Ka,k] bool shortlist validity).  pair_ok gates eligibility.
    """
    # the cross-term runs at DEFAULT precision (TF32 on a GPU): it only
    # ranks the shortlist, and the exact SAD below re-scores it
    ssd = jnp.where(pair_ok,
                    ssd_matrix(patches_a, patches_b,
                               precision=lax.Precision.DEFAULT), jnp.inf)
    # recall_target=1.0: an exact top-k (on a GPU, approx_max_k lowers to
    # an exact top-k at any recall target)
    neg, idx = lax.approx_max_k(-ssd, k, recall_target=1.0)  # [Ka,k]
    ok = jnp.isfinite(neg)
    cand = patches_b[idx]                            # [Ka,k,P] gather
    sad = jnp.sum(jnp.abs(patches_a[:, None, :] - cand), axis=-1)
    return idx.astype(jnp.int32), sad, ok


def hamming_matrix_jnp(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """[Ka,W] x [Kb,W] u32 -> [Ka,Kb] f32 Hamming distance."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(lax.population_count(x), axis=-1).astype(jnp.float32)


def _best_two(Dm):
    """Per-row argmin, min and second-smallest value (_BIG where none)."""
    best = jnp.argmin(Dm, axis=1).astype(jnp.int32)
    best_d = jnp.take_along_axis(Dm, best[:, None], axis=1)[:, 0]
    second_d = jnp.min(
        jnp.where(jax.nn.one_hot(best, Dm.shape[1], dtype=jnp.bool_), _BIG,
                  Dm), axis=1)
    return best, best_d, second_d


def stereo_sad_best(patches_l, patches_r, xy_l, xy_r, ok_l, ok_r,
                    max_y_diff: float, max_disp: float, max_distance: float):
    """Stage-3 exact-SAD core: masked all-pairs SAD (rounded-row epipolar
    window, disparity window, validity, distance threshold) ->
    (best_r [K] int32, best_d [K], second_d [K]); distances are _BIG where
    no admissible pair exists.  SADs of u8 patches are integers below 2^24,
    exact in f32 in any summation order."""
    D = sad_matrix_jnp(patches_l, patches_r)
    dy = jnp.abs(jnp.round(xy_l[:, 1])[:, None]
                 - jnp.round(xy_r[:, 1])[None, :])
    disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
    ok = (ok_l[:, None] & ok_r[None, :] & (dy <= max_y_diff)
          & (disp >= 1.0) & (disp <= max_disp) & (D <= max_distance))
    return _best_two(jnp.where(ok, D, _BIG))


def track_sad_best(p_left_patch, c_left_patch, p_right_patch, c_right_patch,
                   p_left_xy, c_left_xy, p_right_x, c_right_x, ok_p, ok_c,
                   win_row: float, win_col: float, sad_max: float):
    """Stage-4 ifmSAD core (reference stage4:525-636): both-eye exact SAD,
    each eye gated by sad_max, inside the row / per-eye column windows ->
    (best_c [K] int32, best_d [K]); best_d is _BIG where none."""
    sad_l = sad_matrix_jnp(p_left_patch, c_left_patch)
    sad_r = sad_matrix_jnp(p_right_patch, c_right_patch)
    dy = jnp.abs(p_left_xy[:, 1][:, None] - c_left_xy[:, 1][None, :])
    dxl = jnp.abs(p_left_xy[:, 0][:, None] - c_left_xy[:, 0][None, :])
    dxr = jnp.abs(p_right_x[:, None] - c_right_x[None, :])
    ok = (ok_p[:, None] & ok_c[None, :] & (dy <= win_row)
          & (dxl <= win_col) & (dxr <= win_col)
          & (sad_l <= sad_max) & (sad_r <= sad_max))
    best_c, best_d, _ = _best_two(jnp.where(ok, sad_l + sad_r, _BIG))
    return best_c, best_d
