"""Batched fixed-iteration RANSAC for the fundamental matrix.

Replacement for cv::findFundamentalMat(FM_RANSAC, 1.0, 0.99) used by
the reference's inter-frame outlier filter (stereo_vo
stage4_match_consecutive.cpp:36-63, :202, :237, :684, :696).  OpenCV's adaptive
iteration count becomes a fixed hypothesis batch: all H hypotheses sample 8
correspondences, solve the normalized 8-point system, and score Sampson
inlier counts — entirely vectorized (vmap over hypotheses), deterministic
given the PRNG key.

Like the reference (which skips the filter when < 8 points are available,
stage4:166), the caller gets `ok=False` when the inlier structure is too thin
and should then pass matches through unfiltered.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    inliers: jnp.ndarray    # [N] bool
    F: jnp.ndarray          # [3,3] best fundamental matrix
    n_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray         # bool: >= 8 inliers found (reference stage4:205,240)


def _normalize_pts(pts, mask):
    """Hartley normalization: zero-mean, mean distance sqrt(2), masked."""
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / n, 1e-9)
    T = jnp.array(
        [[scale, 0.0, -scale * mean[0]],
         [0.0, scale, -scale * mean[1]],
         [0.0, 0.0, 1.0]], dtype=pts.dtype)
    pn = (pts - mean) * scale
    return pn, T


def _solve_eight_point(p1n, p2n):
    """F (in normalized coords) from 8 correspondences — batched, SVD-free.

    Accepts [..., 8, 2] stacks.  The nullspace of the 8x9 design matrix A is
    the 0-eigenvector of M = A^T A (rank <= 8 by construction), recovered by
    two rounds of inverse iteration on M + eps*I (rso.kernels.smallchol:
    batched 9x9 Cholesky + unrolled triangular solves).  Recovers
    slightly MORE inliers than the vmapped SVD path (no rank-2 truncation
    pulling the model off the 8 sample points; the rank-2 projection the
    reference's cv::findFundamentalMat applies matters for epipolar-geometry
    *use*, not for RANSAC inlier gating, which is all this filter does —
    stage4_match_consecutive.cpp:36-63).
    """
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                  axis=-1)                                # [..., 8, 9]
    M = jnp.einsum("...ki,...kj->...ij", A, A)            # [..., 9, 9]
    # flatten ALL batch dims into one so the Cholesky lowers to a single
    # library call (XLA unrolls extra leading batch dims, e.g. the vmapped
    # eye axis, into separate calls otherwise).  An unrolled in-graph f32
    # Cholesky was tried and is NOT robust enough here: M is rank-8 by
    # construction, and the last pivot drowns in f32 cancellation noise on
    # degenerate (static-scene) configurations.
    batch_shape = M.shape[:-2]
    M2 = M.reshape((-1, 9, 9))
    from rso.kernels.smallchol import nullvec9

    x = nullvec9(M2)
    return x.reshape(*batch_shape, 3, 3)


def _sampson_sq(F, p1, p2):
    """Squared Sampson distance of correspondences to F (pixel^2)."""
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=-1)  # [N,3]
    x2 = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], axis=-1)
    Fx1 = x1 @ F.T          # [N,3] = F @ x1
    Ftx2 = x2 @ F           # [N,3] = F^T @ x2
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def ransac_fundamental(
    p1: jnp.ndarray,        # [N,2] points in frame t
    p2: jnp.ndarray,        # [N,2] points in frame t+1
    mask: jnp.ndarray,      # [N] bool valid correspondences
    key: jnp.ndarray,       # PRNG key
    n_iters: int = 64,
    threshold: float = 1.0,
) -> RansacResult:
    """Fixed-batch 8-point RANSAC. All hypotheses evaluated in parallel."""
    N = p1.shape[0]
    dtype = jnp.float32
    p1 = p1.astype(dtype)
    p2 = p2.astype(dtype)

    p1n, T1 = _normalize_pts(p1, mask)
    p2n, T2 = _normalize_pts(p2, mask)

    # Sample 8 DISTINCT valid indices per hypothesis by stratified ranks:
    # the valid set (tracked counts here run ~30-80, not hundreds) is split
    # into 8 rank strata and each hypothesis draws one point per stratum.
    # With-replacement sampling at n_valid~50 leaves ~45% of hypotheses with
    # a duplicate point (rank-deficient 8-point systems), and a marginal
    # hypothesis pool is exactly what let single bad models erase the track
    # set (tracking-collapse cascade, see git history of this function).
    # Slots are y-sorted per octave, so strata also spread the sample
    # spatially — better-conditioned models for free.  [H,8] draws only.
    c = jnp.cumsum(mask.astype(jnp.int32))                # [N], c[-1]=n_valid
    n_valid = jnp.maximum(c[-1], 1)
    lanes = jnp.arange(8, dtype=jnp.int32)
    lo = (lanes * n_valid) // 8                           # [8] stratum bounds
    hi = ((lanes + 1) * n_valid) // 8
    width = jnp.maximum(hi - lo, 1).astype(jnp.float32)
    u = jax.random.uniform(key, (n_iters, 8))
    ranks = lo[None, :] + jnp.floor(u * width[None, :]).astype(jnp.int32)
    ranks = jnp.minimum(ranks, n_valid - 1)
    # method='compare_all': one dense [H*8, N] compare+sum; the default
    # binary-search lowering is a ~11-step sequential gather chain
    idx = jnp.searchsorted(c, ranks, side="right",
                           method="compare_all").astype(jnp.int32)
    idx = jnp.minimum(idx, N - 1)
    F = _solve_eight_point(p1n[idx], p2n[idx])            # [H,3,3]
    Fs = jnp.einsum("ji,hjk,kl->hil", T2, F, T1)          # de-normalize
    d2h = jax.vmap(lambda Fp: _sampson_sq(Fp, p1, p2))(Fs)
    inlh = mask[None] & (d2h <= threshold * threshold)
    scores = jnp.sum(inlh.astype(jnp.int32), axis=1)
    best = jnp.argmax(scores)

    # Least-squares refit of the best model on ALL its inliers (in normalized
    # coords), kept only if it scores at least as many inliers — the standard
    # consensus refinement cv::findFundamentalMat applies after RANSAC.
    inl_best = inlh[best]
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    Arows = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                       x1, y1, jnp.ones_like(x1)], axis=-1)        # [N,9]
    w = inl_best.astype(Arows.dtype)[:, None]
    Mr = jnp.einsum("ki,kj->ij", Arows * w, Arows * w)
    from rso.kernels.smallchol import nullvec9

    Fr = nullvec9(Mr[None])[0].reshape(3, 3)
    Fr = T2.T @ Fr @ T1
    d2r = _sampson_sq(Fr, p1, p2)
    score_r = jnp.sum((mask & (d2r <= threshold * threshold))
                      .astype(jnp.int32))
    use_r = score_r >= scores[best]
    Fbest = jnp.where(use_r, Fr, Fs[best])
    d2 = jnp.where(use_r, d2r, d2h[best])

    inliers = mask & (d2 <= threshold * threshold)
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    # Acceptance: >= 8 inliers (reference stage4:256-259 passthrough rule)
    # AND a sane consensus fraction — a "valid" model that rejects most of
    # the track set is far more likely wrong than the tracker (letting it
    # through collapses tracking; the pose solver's robust kernel + residual
    # cut handles the outliers a passthrough admits).
    ok = (n_inl >= 8) & (n_inl.astype(jnp.float32)
                         >= 0.25 * c[-1].astype(jnp.float32))
    inliers = jnp.where(ok, inliers, mask)
    return RansacResult(inliers=inliers, F=Fbest, n_inliers=n_inl, ok=ok)
