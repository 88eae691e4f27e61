"""Two-phase robust Gauss-Newton 6-DoF pose solver, fully fused under jit.

Fixed-shape re-design of the reference's stage-5 optimizer (stereo_vo
stage5_optimization.cpp:275-736 — m_evalRGN + the two while-loops) and of the
standalone getChangeInPose entry (common.cpp:355-413):

  * the per-landmark loop becomes a masked vmap/einsum accumulation,
  * the data-dependent iteration (early exit on ||dx||, cost-increase abort,
    condition-number abort) becomes a single `lax.while_loop` whose carry
    mirrors the reference's (deltaPose, pCost, timesInc, done, abort) state,
  * phase 1 (<= initial_max_iters) -> residual-threshold outlier cut ->
    phase 2 (<= max_iters) is one XLA program; landmarks are triangulated once
    and masked, never re-gathered.

Error-code semantics match VOErrorCode (libstereo-odometry.h:142):
NONE / FIRST_ITERATION are produced by the engine; BAD_COND_NUMBER,
INCR_FUNC_COST_STG1/2 are produced here.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rso.config import LeastSquaresParams
from rso.geometry.stereo_camera import (
    StereoCamera,
    project_stereo_with_jacobian,
    triangulate,
)

# VOErrorCode (reference libstereo-odometry.h:142)
VOEC_NONE = 0
VOEC_BAD_TRACKING = 1
VOEC_BAD_COND_NUMBER = 2
VOEC_INCR_FUNC_COST_STG1 = 3
VOEC_INCR_FUNC_COST_STG2 = 4
VOEC_FIRST_ITERATION = 5
# extension beyond the reference enum (libstereo-odometry.h:142): the solve
# had fewer than 8 correspondences before or after the residual cut.  The
# reference never reports this case distinctly (its GN just runs and usually
# trips voecBadCondNumber).  Deliberately NOT a keep-prev recovery trigger:
# measured on the 480-frame bench scene, consuming the frame (a 1-frame gap
# the caller coasts over) beats holding the previous frame while the camera
# moves on (raw ATE 3.2 vs 5.5 when these engage recovery).
VOEC_TOO_FEW_INLIERS = 6

_COND_MAX = 1e7  # condition-number guard (reference aborts only on NaN; we
                 # additionally flag numerically-singular systems in f32)


class PoseSolveResult(NamedTuple):
    pose: jnp.ndarray           # [6] pose of current frame wrt previous (inverse of deltaPose)
    delta_pose: jnp.ndarray     # [6] raw optimized increment (w,t)
    valid: jnp.ndarray          # bool scalar
    error_code: jnp.ndarray     # int32 scalar (VOEC_*)
    num_it: jnp.ndarray         # int32 phase-1 iterations
    num_it_final: jnp.ndarray   # int32 phase-2 iterations
    residuals: jnp.ndarray      # [N] squared pixel residual per track slot
    inliers: jnp.ndarray        # [N] bool final inlier mask
    cost: jnp.ndarray           # final robust cost


def _eval_rgn(cam: StereoCamera, lmks, obs, mask, delta_pose, params: LeastSquaresParams,
              obs_weight=None, lm_lambda=None):
    """One GN evaluation: the reference's m_evalRGN (stage5_optimization.cpp:275-390).

    lmks: [N,3] triangulated previous-frame landmarks
    obs:  [N,4] current-frame (uL,vL,uR,vR) observations
    mask: [N]   active-landmark mask
    Returns (dx, cost, residual_sq[N], bad_cond).
    """
    pix, J = project_stereo_with_jacobian(cam, lmks, delta_pose)

    r = obs - pix                                  # [N,4] observation - prediction
    s = jnp.sum(r * r, axis=-1)                    # [N] squared residual

    # mask out invalid Jacobians (reference m_jacobian_is_good, h:919-928)
    jac_ok = jnp.all(jnp.isfinite(J), axis=(1, 2)) & jnp.all(jnp.isfinite(pix), axis=1)
    m = mask & jac_ok
    mf = m.astype(J.dtype)

    if params.use_robust_kernel:
        b2 = params.kernel_param * params.kernel_param
        n = jnp.sqrt(1.0 + s / b2)
        rho_p = 1.0 / n                            # pseudo-Huber derivative
        fi = b2 * (n - 1.0)
    else:
        rho_p = jnp.ones_like(s)
        fi = 0.5 * s

    if obs_weight is not None:
        mf = mf * obs_weight
    cost = jnp.sum(mf * fi)

    # g = sum w rho' * J^T r ; H = sum w [rho'] J^T J  (reference :363-369
    # weights only g by rho'; with irls_hessian_weighting we use proper IRLS —
    # same fixed point, far better-conditioned steps; see LeastSquaresParams
    # docs.  obs_weight adds per-observation variance weighting, e.g. 1/4^o
    # for octave-o features — a rso improvement over the reference.)
    g = jnp.einsum("n,nij,ni->j", mf * rho_p, J, r)
    h_w = mf * rho_p if params.irls_hessian_weighting else mf
    H = jnp.einsum("n,nij,nik->jk", h_w, J, J)
    if lm_lambda is not None:
        # Marquardt damping: lambda * diag(H) keeps the step scale-relative
        H = H + lm_lambda * jnp.diag(jnp.diagonal(H))

    if params.solve_backend == "chol":
        # Cholesky solve + cond_1 guard (LeastSquaresParams.solve_backend):
        # identical dx on the PD systems real frames produce, and cheaper
        # than a 6x6 eigh.  cond_1 =
        # ||H||_1 ||H^-1||_1 (within 6x of cond_2 on 6x6) against the same
        # threshold; an indefinite H surfaces as NaN in L and aborts.
        L = jnp.linalg.cholesky(H)
        eye6 = jnp.eye(6, dtype=H.dtype)
        Hinv = jax.scipy.linalg.cho_solve((L, True), eye6)
        dx = Hinv @ g
        cond = (jnp.max(jnp.sum(jnp.abs(H), axis=0))
                * jnp.max(jnp.sum(jnp.abs(Hinv), axis=0)))
        if lm_lambda is not None:
            bad_cond = ~jnp.isfinite(cond) | ~jnp.all(jnp.isfinite(dx))
        else:
            bad_cond = (~jnp.isfinite(cond) | ~jnp.all(jnp.isfinite(dx))
                        | (cond > _COND_MAX))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
    else:
        # Symmetric-eigendecomposition least-squares solve.  H is symmetric
        # PSD, so eigh gives the same singular spectrum as the reference's
        # JacobiSVD (:375-388) at a fraction of its cost; the
        # condition-number guard is identical.
        w, V = jnp.linalg.eigh(H)  # ascending
        cond = w[5] / jnp.where(w[0] <= 0.0, jnp.nan, w[0])
        if lm_lambda is not None:
            # LM handles ill-conditioning via damping; abort only on NaN
            # (which is also the reference's actual abort condition,
            # :380-386)
            bad_cond = ~jnp.isfinite(cond)
        else:
            bad_cond = ~jnp.isfinite(cond) | (cond > _COND_MAX)
        w_inv = jnp.where(w > w[5] * 1e-9,
                          1.0 / jnp.where(w > 0, w, 1.0), 0.0)
        dx = V @ (w_inv * (V.T @ g))

    # masked-out slots report +inf residual (reference resizes out_residual to
    # double::max, :296) so the outlier cut removes them consistently.
    s_out = jnp.where(m, s, jnp.finfo(s.dtype).max)
    return dx, cost, s_out, bad_cond


def _gn_phase(cam, lmks, obs, mask, delta_pose0, max_iters, timesInc0,
              params: LeastSquaresParams, incr_cost_code, obs_weight=None):
    """One of the two GN loops (reference :549-598 and :650-700) as lax.while_loop."""

    def cond_fn(carry):
        it, _dp, _pc, _ti, done, abort, _res, _ec, _cost = carry
        return (it < max_iters) & ~done & ~abort

    use_lm = params.use_lm

    def cond_fn_lm(carry):
        it, _dp, _pc, _ti, done, abort, _res, _ec, _cost, _lam = carry
        return (it < max_iters) & ~done & ~abort

    def body_fn_lm(carry):
        it, dp, pCost, timesInc, done, abort, _res, ec, _cost, lam = carry
        dx, cCost, res, bad_cond = _eval_rgn(cam, lmks, obs, mask, dp, params,
                                             obs_weight, lm_lambda=lam)
        abort_cond = bad_cond
        ec = jnp.where(abort_cond, VOEC_BAD_COND_NUMBER, ec)

        # LM acceptance: the cost at the CURRENT dp was computed this round;
        # accept the step tentatively, adapt lambda by whether cost fell
        improved = (it == 0) | (cCost <= pCost)
        lam_new = jnp.where(improved, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e3))
        dp_new = jnp.where(abort_cond, dp, dp + dx)

        step_norm = jnp.sqrt(jnp.sum(dx * dx))
        done_new = (it > 0) & (step_norm < params.min_mod_out_vector)
        cost_increased = (it > 0) & (pCost < cCost)
        timesInc_new = timesInc + jnp.where(cost_increased, 1, 0)
        too_many_incr = timesInc_new > params.max_incr_cost
        ec = jnp.where(too_many_incr & ~abort_cond, incr_cost_code, ec)
        abort_new = abort_cond | too_many_incr
        return (it + 1, dp_new, cCost, timesInc_new, done_new, abort_new, res,
                ec, cCost, lam_new)

    def body_fn(carry):
        it, dp, pCost, timesInc, done, abort, _res, ec, _cost = carry
        dx, cCost, res, bad_cond = _eval_rgn(cam, lmks, obs, mask, dp, params,
                                             obs_weight)

        abort_cond = bad_cond
        ec = jnp.where(abort_cond, VOEC_BAD_COND_NUMBER, ec)

        dp_new = jnp.where(abort_cond, dp, dp + dx)

        # ending conditions (evaluated from iteration 1 onward, reference :580-596)
        step_norm = jnp.sqrt(jnp.sum(dx * dx))
        done_new = (it > 0) & (step_norm < params.min_mod_out_vector)
        cost_increased = (it > 0) & (pCost < cCost)
        timesInc_new = timesInc + jnp.where(cost_increased, 1, 0)
        too_many_incr = timesInc_new > params.max_incr_cost
        ec = jnp.where(too_many_incr & ~abort_cond, incr_cost_code, ec)
        abort_new = abort_cond | too_many_incr

        return (it + 1, dp_new, cCost, timesInc_new, done_new, abort_new, res,
                ec, cCost)

    N = obs.shape[0]
    if use_lm:
        init = (
            jnp.int32(0), delta_pose0, jnp.float32(0.0), jnp.int32(timesInc0),
            jnp.bool_(False), jnp.bool_(False),
            jnp.full((N,), jnp.finfo(jnp.float32).max, dtype=jnp.float32),
            jnp.int32(VOEC_NONE), jnp.float32(0.0),
            jnp.float32(params.lm_init_lambda),
        )
        it, dp, _pc, timesInc, _done, abort, res, ec, cost, _lam =             lax.while_loop(cond_fn_lm, body_fn_lm, init)
        return it, dp, timesInc, abort, res, ec, cost

    init = (
        jnp.int32(0), delta_pose0, jnp.float32(0.0), jnp.int32(timesInc0),
        jnp.bool_(False), jnp.bool_(False),
        jnp.full((N,), jnp.finfo(jnp.float32).max, dtype=jnp.float32),
        jnp.int32(VOEC_NONE), jnp.float32(0.0),
    )
    it, dp, _pc, timesInc, _done, abort, res, ec, cost = lax.while_loop(
        cond_fn, body_fn, init
    )
    return it, dp, timesInc, abort, res, ec, cost


def solve_pose(
    cam: StereoCamera,
    prev_obs: jnp.ndarray,     # [N,4] (uL,vL,uR,vR) in the previous frame
    cur_obs: jnp.ndarray,      # [N,4] (uL,vL,uR,vR) in the current frame
    mask: jnp.ndarray,         # [N] bool: valid tracked pair
    params: LeastSquaresParams,
    initial_pose: jnp.ndarray | None = None,   # [6] warm start (w,t)
    obs_weight: jnp.ndarray | None = None,     # [N] per-observation weights
) -> PoseSolveResult:
    """Full two-phase robust GN pose solve on tracked stereo correspondences.

    This is the public equivalent of the reference's getChangeInPose
    (common.cpp:355-413): it takes bare correspondences, so both the engine's
    stage 5 and external callers (SLAM layers, BA relinearization) share it.
    `params` must be static under jit (hashable frozen dataclass).
    """
    N = prev_obs.shape[0]
    dtype = jnp.float32
    prev_obs = prev_obs.astype(dtype)
    cur_obs = cur_obs.astype(dtype)

    delta0 = (jnp.zeros(6, dtype) if initial_pose is None
              else initial_pose.astype(dtype))

    # 1. Triangulate previous-frame observations once (reference :528-544).
    lmks = triangulate(cam, prev_obs[:, 0], prev_obs[:, 1], prev_obs[:, 2])

    n_valid = jnp.sum(mask.astype(jnp.int32))
    enough = n_valid >= 8

    # Phase 1 (reference :549-598)
    it1, dp1, timesInc, abort1, res1, ec1, _cost1 = _gn_phase(
        cam, lmks, cur_obs, mask, delta0, params.initial_max_iters, 0, params,
        VOEC_INCR_FUNC_COST_STG1, obs_weight,
    )

    # Outlier cut by residual threshold (reference :601-611)
    inliers = mask & (res1 <= params.residual_threshold)
    n_inliers = jnp.sum(inliers.astype(jnp.int32))
    enough2 = n_inliers >= 8

    # Phase 2 continues from the phase-1 deltaPose & timesInc (reference :650-700)
    it2, dp2, _ti2, abort2, res2, ec2, cost2 = _gn_phase(
        cam, lmks, cur_obs, inliers, dp1, params.max_iters, timesInc, params,
        VOEC_INCR_FUNC_COST_STG2, obs_weight,
    )

    valid = enough & enough2 & ~abort1 & ~abort2
    error_code = jnp.where(ec1 != VOEC_NONE, ec1, ec2).astype(jnp.int32)
    # too few correspondences (before or after the residual cut) is reported
    # distinctly instead of as a silent invalid-with-voecNone
    error_code = jnp.where((error_code == VOEC_NONE) & ~(enough & enough2),
                           VOEC_TOO_FEW_INLIERS, error_code).astype(jnp.int32)
    delta = jnp.where(valid, dp2, dp1)

    # outPose = inverse of accumulated deltaPose (reference :715-718)
    from rso.geometry.se3 import pose_inverse

    pose = pose_inverse(delta)
    return PoseSolveResult(
        pose=pose,
        delta_pose=delta,
        valid=valid,
        error_code=error_code,
        num_it=it1,
        num_it_final=it2,
        residuals=res2,
        inliers=inliers & (res2 <= params.residual_threshold),
        cost=cost2,
    )
