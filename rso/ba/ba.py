"""Sliding-window stereo bundle adjustment via Schur complement — fused XLA.

The capability the reference never had (SURVEY.md section 0: pose-only,
frame-pair optimization) and the north-star extension in BASELINE.json:
jointly refine a window of keyframe poses and the landmarks they observe.

Problem layout (fixed shapes, masked):
    poses   [P,6]   world->camera rotvec+translation per keyframe
    lmks    [L,3]   landmark positions (world frame)
    obs     [P,L,4] stereo observations (uL,vL,uR,vR)
    mask    [P,L]   observation validity

One LM iteration:
    residuals + closed-form Jacobians (vmapped stereo projection, same
    geometry core as the per-frame solver)
    H_pp [P,6,6] block diag, H_ll [L,3,3] block diag, H_pl [P,L,6,3]
    Schur: S = H_pp - sum_l H_pl H_ll^-1 H_pl^T   (reduced camera system,
    [P*6, P*6] dense — P is small), solve, back-substitute landmarks.

Gauge: the first keyframe pose is frozen (its Schur block is pinned to
identity).  Robust pseudo-Huber weighting matches the per-frame solver.
All sums over landmarks are einsum contractions -> on a device mesh the
landmark axis shards and the contractions become psum reductions
(rso.ba.distributed).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rso.geometry.rotations import rodrigues, rodrigues_with_grad
from rso.geometry.stereo_camera import StereoCamera


class BAProblem(NamedTuple):
    poses: jnp.ndarray      # [P,6] world->cam
    lmks: jnp.ndarray       # [L,3]
    obs: jnp.ndarray        # [P,L,4]
    mask: jnp.ndarray       # [P,L] bool
    lmk_weight: jnp.ndarray | None = None  # [L] observation down-weighting
    # (e.g. 2-view landmarks: geometrically valid but noise-dominated during
    # fast rotation — weighted, not dropped, so the problem never starves)


class BAResult(NamedTuple):
    poses: jnp.ndarray
    lmks: jnp.ndarray
    cost: jnp.ndarray
    n_iters: jnp.ndarray
    converged: jnp.ndarray


def _project_one(cam: StereoCamera, pose6, lmk):
    """Stereo projection of one landmark from one pose, with Jacobians wrt
    the pose (4x6) and the landmark (4x3).  Mirrors the per-frame analytic
    Jacobian (rso.geometry.stereo_camera, reference stage5_optimization.cpp:
    35-257) extended with dP/dX = R for the landmark block."""
    R, dR = rodrigues_with_grad(pose6[:3])
    P = R @ lmk + pose6[3:]
    X, Y, Z = P[0], P[1], P[2]
    Zs = jnp.where(jnp.abs(Z) < 1e-9, 1e-9, Z)
    X2 = X - cam.baseline

    ul = cam.fx_l * X / Zs + cam.cx_l
    vl = cam.fy_l * Y / Zs + cam.cy_l
    ur = cam.fx_r * X2 / Zs + cam.cx_r
    vr = cam.fy_r * Y / Zs + cam.cy_r
    pix = jnp.stack([ul, vl, ur, vr])

    # dP/dtheta: rotation params k: dR_k @ lmk; translation: I; landmark: R
    dP_rot = jnp.einsum("kij,j->ki", dR, lmk)          # [3,3]
    dP = jnp.concatenate([dP_rot, jnp.eye(3, dtype=P.dtype)], axis=0)  # [6,3]

    def pix_rows(dPd):  # dPd: [...,3] derivative of P
        Xd, Yd, Zd = dPd[..., 0], dPd[..., 1], dPd[..., 2]
        Z2 = Zs * Zs
        return jnp.stack([
            cam.fx_l * (Xd * Zs - X * Zd) / Z2,
            cam.fy_l * (Yd * Zs - Y * Zd) / Z2,
            cam.fx_r * (Xd * Zs - X2 * Zd) / Z2,
            cam.fy_r * (Yd * Zs - Y * Zd) / Z2,
        ], axis=-1)  # [...,4]

    J_pose = pix_rows(dP).T                             # [4,6]
    J_lmk = pix_rows(R.T).T                             # [4,3] (dP/dX = R)
    return pix, J_pose, J_lmk


def _project_grid(cam: StereoCamera, poses, lmks):
    """Batched [P,L] stereo projection + Jacobians.

    Vectorized so Rodrigues + dR/dw run ONCE per pose (the naive double-vmap
    of _project_one recomputes them per landmark).  Verified equal to the
    per-element form in tests/test_ba.py.
    """
    R, dR = jax.vmap(rodrigues_with_grad)(poses[:, :3])       # [P,3,3],[P,3,3,3]
    Pt = jnp.einsum("pij,lj->pli", R, lmks) + poses[:, None, 3:]  # [P,L,3]
    X, Y, Z = Pt[..., 0], Pt[..., 1], Pt[..., 2]
    Zs = jnp.where(jnp.abs(Z) < 1e-9, 1e-9, Z)
    X2 = X - cam.baseline

    pix = jnp.stack([
        cam.fx_l * X / Zs + cam.cx_l,
        cam.fy_l * Y / Zs + cam.cy_l,
        cam.fx_r * X2 / Zs + cam.cx_r,
        cam.fy_r * Y / Zs + cam.cy_r,
    ], axis=-1)                                               # [P,L,4]

    # dP/dtheta: [P,L,6,3]; rotation rows dR_k @ X, translation identity
    dP_rot = jnp.einsum("pkij,lj->plki", dR, lmks)            # [P,L,3,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Pt.dtype),
                           dP_rot.shape)
    dP = jnp.concatenate([dP_rot, eye], axis=2)               # [P,L,6,3]

    def pix_rows(dPd):
        Xd, Yd, Zd = dPd[..., 0], dPd[..., 1], dPd[..., 2]
        Z2 = (Zs * Zs)[..., None]
        Zse = Zs[..., None]
        return jnp.stack([
            cam.fx_l * (Xd * Zse - X[..., None] * Zd) / Z2,
            cam.fy_l * (Yd * Zse - Y[..., None] * Zd) / Z2,
            cam.fx_r * (Xd * Zse - X2[..., None] * Zd) / Z2,
            cam.fy_r * (Yd * Zse - Y[..., None] * Zd) / Z2,
        ], axis=-1)                                           # [P,L,params,4]

    J_pose = jnp.swapaxes(pix_rows(dP), -1, -2)               # [P,L,4,6]
    # landmark jacobian: dP/dX_j = column j of R -> rows of R^T
    RT = jnp.swapaxes(R, -1, -2)[:, None, :, :]               # [P,1,3,3]
    RT = jnp.broadcast_to(RT, (R.shape[0], lmks.shape[0], 3, 3))
    J_lmk = jnp.swapaxes(pix_rows(RT), -1, -2)                # [P,L,4,3]
    return pix, J_pose, J_lmk


def inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate/det).  jnp.linalg.inv lowers
    to a per-matrix LU factorization; the adjugate is a few fused
    elementwise ops."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    safe = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / safe)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        jnp.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _vee(M):
    """Inverse hat: the 3-vector of a (near-)skew-symmetric matrix."""
    return jnp.stack([M[..., 2, 1] - M[..., 1, 2],
                      M[..., 0, 2] - M[..., 2, 0],
                      M[..., 1, 0] - M[..., 0, 1]], axis=-1) * 0.5


def _relpose_residuals(poses, rel_meas):
    """Consecutive-keyframe relative-pose residuals [P-1,6].

    poses [P,6] world->cam; rel_meas [P-1,6] the VO-measured cam_p -> cam_{p+1}
    transform.  Rotation error uses the smooth first-order vee(E - E^T)/2 form
    (equals the log map to first order; avoids the non-differentiable
    arccos-at-identity of the exact log), translation error is the plain
    difference of the relative translations.
    """
    Ra = jax.vmap(rodrigues)(poses[:-1, :3])          # [P-1,3,3] W_p
    Rb = jax.vmap(rodrigues)(poses[1:, :3])           # W_{p+1}
    ta, tb = poses[:-1, 3:], poses[1:, 3:]
    # T_rel_est = W_{p+1} @ W_p^-1: R = Rb Ra^T, t = tb - Rb Ra^T ta
    R_rel = jnp.einsum("pij,pkj->pik", Rb, Ra)
    t_rel = tb - jnp.einsum("pij,pj->pi", R_rel, ta)
    Rm = jax.vmap(rodrigues)(rel_meas[:, :3])
    E = jnp.einsum("pij,pkj->pik", R_rel, Rm)         # R_rel_est @ R_meas^T
    r_rot = _vee(E - jnp.swapaxes(E, -1, -2))
    r_t = t_rel - rel_meas[:, 3:]
    return jnp.concatenate([r_rot, r_t], axis=-1)     # [P-1,6]


def relpose_prior_terms(poses, rel_meas, w_rot, w_trans):
    """Gauss-Newton terms of the odometry prior: (H [P,6,P,6], g [P,6], cost).

    The prior anchors consecutive keyframes to their VO-measured relative
    motion, constraining the directions the landmark observations leave weak
    (short-lifetime landmarks / low-parallax windows).  H adds to the reduced
    camera system S directly (pose-only — no landmark coupling), g follows
    the same sign convention as the reprojection gradient (x += H^-1 g).
    """
    W = jnp.concatenate([jnp.full((3,), w_rot, poses.dtype),
                         jnp.full((3,), w_trans, poses.dtype)])

    e = _relpose_residuals(poses, rel_meas)           # [P-1,6]
    J = jax.jacfwd(lambda p: _relpose_residuals(p, rel_meas))(poses)
    # J: [P-1,6,P,6];  H[pj,ql] = sum_{a,i} J[a,i,p,j] W[i] J[a,i,q,l]
    H = jnp.einsum("aipj,aiql->pjql", J * W[None, :, None, None], J)
    g = -jnp.einsum("aipj,ai->pj", J, e * W[None, :])
    cost = 0.5 * jnp.sum(e * e * W[None, :])
    return H, g, cost


def _robust_weights(r2, kernel_param, use_robust):
    if use_robust:
        b2 = kernel_param * kernel_param
        n = jnp.sqrt(1.0 + r2 / b2)
        return 1.0 / n, b2 * (n - 1.0)
    return jnp.ones_like(r2), 0.5 * r2


def ba_normal_equations(cam: StereoCamera, prob: BAProblem,
                        kernel_param: float = 3.0, use_robust: bool = True):
    """Assemble the BA normal-equation blocks (the distributed layer shards
    the landmark axis of everything returned here)."""
    pix, J_p, J_l = _project_grid(cam, prob.poses, prob.lmks)
    r = prob.obs - pix                                  # [P,L,4]
    r2 = jnp.sum(r * r, axis=-1)

    finite = (jnp.all(jnp.isfinite(pix), -1)
              & jnp.all(jnp.isfinite(J_p), (-1, -2))
              & jnp.all(jnp.isfinite(J_l), (-1, -2)))
    m = (prob.mask & finite).astype(r.dtype)            # [P,L]
    # explicitly zero non-finite terms: a masked weight of 0 times an inf
    # Jacobian entry would still produce NaN in the einsums
    mb = m[..., None] > 0
    r = jnp.where(mb, r, 0.0)
    J_p = jnp.where(mb[..., None], J_p, 0.0)
    J_l = jnp.where(mb[..., None], J_l, 0.0)
    r2 = jnp.where(m > 0, r2, 0.0)
    rho, fi = _robust_weights(r2, kernel_param, use_robust)
    if prob.lmk_weight is not None:
        m = m * prob.lmk_weight[None, :]
    w = m * rho

    cost = jnp.sum(m * fi)
    # gradient blocks
    g_p = jnp.einsum("pl,plij,pli->pj", w, J_p, r)      # [P,6]
    g_l = jnp.einsum("pl,plij,pli->lj", w, J_l, r)      # [L,3]
    # Hessian blocks (IRLS weighting on both, same fixed point)
    H_pp = jnp.einsum("pl,plij,plik->pjk", w, J_p, J_p)  # [P,6,6]
    H_ll = jnp.einsum("pl,plij,plik->ljk", w, J_l, J_l)  # [L,3,3]
    H_pl = jnp.einsum("pl,plij,plik->pljk", w, J_p, J_l)  # [P,L,6,3]
    return cost, g_p, g_l, H_pp, H_ll, H_pl, r2, m


def _schur_solve(g_p, g_l, H_pp, H_ll, H_pl, lm_lambda, fix_first: bool,
                 lmk_valid, prior=None):
    """Schur-complement reduced camera solve + landmark back-substitution.

    Returns (dpose [P,6], dlmk [L,3]).  With a sharded landmark axis the two
    einsum contractions marked PSUM become jax.lax.psum-reduced partial sums
    (see rso.ba.distributed).
    """
    P = g_p.shape[0]
    L = g_l.shape[0]
    eye3 = jnp.eye(3, dtype=g_l.dtype)
    eye6 = jnp.eye(6, dtype=g_p.dtype)

    # Marquardt damping (lam * diag(H)) keeps the damping scale-relative and
    # bounds the condition number of H_ll_d — required for the f32 adjugate
    # inverse (absolute lam*I damping leaves cond ~1e8 blocks that the
    # closed-form inverse cannot handle in f32)
    diag_ll = jnp.eye(3, dtype=g_l.dtype) * H_ll.diagonal(0, -2, -1)[..., None, :]
    H_ll_d = H_ll + lm_lambda * diag_ll + 1e-6 * eye3[None]
    # guard empty landmarks
    lv = lmk_valid.astype(g_l.dtype)
    H_ll_d = H_ll_d * lv[:, None, None] + (1 - lv)[:, None, None] * eye3[None]
    H_ll_inv = inv3x3(H_ll_d) * lv[:, None, None]

    # W_l = H_pl H_ll^-1  [P,L,6,3]
    W = jnp.einsum("pljk,lkm->pljm", H_pl, H_ll_inv)
    # S = H_pp - sum_l W H_pl^T  (cross-pose blocks!)  [P,P,6,6]   (PSUM over l)
    S_cross = jnp.einsum("pljm,qlkm->pqjk", W, H_pl)
    S = -S_cross
    S = S.at[jnp.arange(P), jnp.arange(P)].add(
        H_pp + lm_lambda * eye6[None])
    # reduced gradient: g_p - sum_l W g_l                          (PSUM over l)
    b = g_p - jnp.einsum("pljm,lm->pj", W, g_l)

    # odometry prior (pose-only, replicated): add before the gauge fix
    if prior is not None:
        H_prior, g_prior = prior
        S = S + H_prior.transpose(0, 2, 1, 3)         # [P,6,P,6]->[P,P,6,6]
        b = b + g_prior

    # gauge fix: freeze pose 0 (identity block, zero gradient)
    if fix_first:
        S = S.at[0, :, :, :].set(0.0)
        S = S.at[:, 0, :, :].set(0.0)
        S = S.at[0, 0].set(eye6)
        b = b.at[0].set(0.0)

    Sd = S.transpose(0, 2, 1, 3).reshape(P * 6, P * 6)
    dpose = jnp.linalg.solve(
        Sd + 1e-8 * jnp.eye(P * 6, dtype=Sd.dtype), b.reshape(-1)
    ).reshape(P, 6)

    # back-substitution: dlmk = H_ll^-1 (g_l - sum_p H_pl^T dpose_p)
    rhs = g_l - jnp.einsum("pljk,pj->lk", H_pl, dpose)
    dlmk = jnp.einsum("ljk,lk->lj", H_ll_inv, rhs)
    return dpose, dlmk


@partial(jax.jit, static_argnames=("max_iters", "use_robust", "fix_first",
                                   "rel_w_rot", "rel_w_trans"))
def bundle_adjust(
    cam: StereoCamera,
    prob: BAProblem,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas=None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
    marg_prior=None,
) -> BAResult:
    """Levenberg-Marquardt BA over the window as one lax.while_loop program.

    rel_meas [P-1,6] + rel_w_rot/rel_w_trans enable the odometry prior: each
    consecutive keyframe pair is softly anchored to its VO-measured relative
    transform (see relpose_prior_terms).  Weights are inverse variances in
    (rad, m) against 1-px reprojection noise.

    marg_prior: optional (H [P,6,P,6], b [P,6], lin [P,6]) marginalization
    prior from keyframe eviction (rso.ba.marginalization / SlidingWindow
    .prior_terms): cost += 0.5 dx^T H dx - b^T dx with dx = poses - lin;
    its Hessian adds to the reduced camera system, its gradient b - H dx to
    the reduced gradient.
    """
    lmk_valid = jnp.any(prob.mask, axis=0)
    use_prior = rel_meas is not None and (rel_w_rot > 0 or rel_w_trans > 0)
    use_marg = marg_prior is not None
    if use_marg:
        mH, mb, mlin = (jnp.asarray(a, prob.poses.dtype) for a in marg_prior)
        nP = prob.poses.shape[0]
        mHf = mH.reshape(nP * 6, nP * 6)

    def eval_cost(poses, lmks):
        pix, _, _ = _project_grid(cam, poses, lmks)
        r2 = jnp.sum((prob.obs - pix) ** 2, axis=-1)
        _, fi = _robust_weights(r2, kernel_param, use_robust)
        m = (prob.mask & jnp.all(jnp.isfinite(pix), -1)).astype(fi.dtype)
        if prob.lmk_weight is not None:
            m = m * prob.lmk_weight[None, :]
        cost = jnp.sum(m * fi)
        if use_prior:
            W = jnp.concatenate([
                jnp.full((3,), rel_w_rot, poses.dtype),
                jnp.full((3,), rel_w_trans, poses.dtype)])
            e = _relpose_residuals(poses, rel_meas)
            cost = cost + 0.5 * jnp.sum(e * e * W[None, :])
        if use_marg:
            dx = (poses - mlin).reshape(-1)
            cost = cost + 0.5 * dx @ (mHf @ dx) - mb.reshape(-1) @ dx
        return cost

    def cond(carry):
        it, _poses, _lmks, _lam, _cost, done = carry
        return (it < max_iters) & ~done

    def body(carry):
        it, poses, lmks, lam, cost, done = carry
        p = BAProblem(poses=poses, lmks=lmks, obs=prob.obs, mask=prob.mask,
                      lmk_weight=prob.lmk_weight)
        c, g_p, g_l, H_pp, H_ll, H_pl, _r2, _m = ba_normal_equations(
            cam, p, kernel_param, use_robust)
        prior = None
        if use_prior:
            H_pr, g_pr, _c_pr = relpose_prior_terms(
                poses, rel_meas, rel_w_rot, rel_w_trans)
            prior = (H_pr, g_pr)
        if use_marg:
            dx = (poses - mlin).reshape(-1)
            g_m = (mb.reshape(-1) - mHf @ dx).reshape(poses.shape)
            if prior is None:
                prior = (mH, g_m)
            else:
                prior = (prior[0] + mH, prior[1] + g_m)
        dpose, dlmk = _schur_solve(g_p, g_l, H_pp, H_ll, H_pl, lam,
                                   fix_first, lmk_valid, prior=prior)
        new_poses = poses + dpose
        new_lmks = lmks + dlmk * lmk_valid[:, None]
        new_cost = eval_cost(new_poses, new_lmks)
        accept = ((new_cost < cost) & jnp.isfinite(new_cost)
                  & jnp.all(jnp.isfinite(new_poses))
                  & jnp.all(jnp.isfinite(new_lmks)))

        poses = jnp.where(accept, new_poses, poses)
        lmks = jnp.where(accept, new_lmks, lmks)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-9),
                        jnp.minimum(lam * 8.0, 1e6))
        step = jnp.sqrt(jnp.sum(dpose ** 2))
        done = accept & (step < tol)
        cost = jnp.where(accept, new_cost, cost)
        return it + 1, poses, lmks, lam, cost, done

    cost0 = eval_cost(prob.poses, prob.lmks)
    it, poses, lmks, _lam, cost, done = lax.while_loop(
        cond, body,
        (jnp.int32(0), prob.poses, prob.lmks, jnp.float32(init_lambda),
         cost0, jnp.bool_(False)))
    return BAResult(poses=poses, lmks=lmks, cost=cost, n_iters=it,
                    converged=done)
