"""Distributed sliding-window BA: landmark-sharded Schur reduction on a mesh.

The multi-device story (SURVEY.md sections 2.5 and 5): landmarks shard
across the mesh's 'lmk' axis; every device assembles the normal-equation
blocks for its landmark shard, the reduced camera system is formed by an
all-reduce (psum) of the per-shard Schur contributions, the small
[P*6, P*6] solve runs replicated on every device, and landmark
back-substitution is purely local to each shard.  No hand-written
transport — jax.lax.psum inside shard_map, which XLA hands to NCCL on GPUs
(NVLink between the cards of one host).

Communication cost per LM iteration: one psum of P*P*36 + P*6 floats
(window of 8 keyframes -> ~9 KB), independent of the landmark count — the
Schur structure is what makes the distribution embarrassingly efficient.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rso.ba.ba import (
    BAProblem,
    BAResult,
    _project_grid,
    _relpose_residuals,
    _robust_weights,
    ba_normal_equations,
    inv3x3,
    relpose_prior_terms,
)
from rso.geometry.stereo_camera import StereoCamera


def make_mesh(n_devices: int | None = None, axis: str = "lmk") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=(axis,))


def pad_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the landmark axis to a multiple of the shard count."""
    L = prob.lmks.shape[0]
    Lp = ((L + n_shards - 1) // n_shards) * n_shards
    if Lp == L:
        return prob
    pad = Lp - L
    # pad landmarks at a benign depth (z=10) — zero-depth slots would project
    # to inf and pollute masked reductions
    pad_lmks = jnp.tile(jnp.asarray([[0.0, 0.0, 10.0]], prob.lmks.dtype),
                        (pad, 1))
    return BAProblem(
        poses=prob.poses,
        lmks=jnp.concatenate([prob.lmks, pad_lmks]),
        obs=jnp.pad(prob.obs, ((0, 0), (0, pad), (0, 0))),
        mask=jnp.pad(prob.mask, ((0, 0), (0, pad))),
        lmk_weight=(None if prob.lmk_weight is None
                    else jnp.pad(prob.lmk_weight, (0, pad))),
    )


def distributed_bundle_adjust(
    cam: StereoCamera,
    prob: BAProblem,
    mesh: Mesh,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas=None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
) -> BAResult:
    """LM BA with the landmark axis sharded over `mesh`'s 'lmk' axis.

    rel_meas/rel_w_* enable the odometry prior (see rso.ba.ba.bundle_adjust);
    the prior is pose-only, so it is computed replicated on every shard — no
    extra communication.
    """
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    prob = pad_problem(prob, n_shards)
    nP = prob.poses.shape[0]
    use_prior = rel_meas is not None and (rel_w_rot > 0 or rel_w_trans > 0)
    rel_arr = (jnp.asarray(rel_meas, prob.poses.dtype) if use_prior
               else jnp.zeros((max(nP - 1, 1), 6), prob.poses.dtype))

    def prior_cost(poses, rel):
        if not use_prior:
            return 0.0
        W = jnp.concatenate([
            jnp.full((3,), rel_w_rot, poses.dtype),
            jnp.full((3,), rel_w_trans, poses.dtype)])
        e = _relpose_residuals(poses, rel)
        return 0.5 * jnp.sum(e * e * W[None, :])

    lw = (jnp.ones(prob.lmks.shape[0], prob.lmks.dtype)
          if prob.lmk_weight is None else prob.lmk_weight)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(None, axis, None), P(None, axis),
                  P(), P(axis)),
        out_specs=(P(), P(axis, None), P(), P(), P()),
    )
    def lm_solve(poses0, lmks0, obs, mask, rel, lmk_w):
        """Runs per-shard; psum glues the reduced camera system together."""
        lmk_valid = jnp.any(mask, axis=0)

        def eval_cost(poses, lmks):
            pix, _, _ = _project_grid(cam, poses, lmks)
            r2 = jnp.sum((obs - pix) ** 2, axis=-1)
            _, fi = _robust_weights(r2, kernel_param, use_robust)
            m = (mask & jnp.all(jnp.isfinite(pix), -1)).astype(fi.dtype)
            m = m * lmk_w[None, :]
            return (lax.psum(jnp.sum(m * fi), axis)
                    + prior_cost(poses, rel))

        def body(carry):
            it, poses, lmks, lam, cost, done = carry
            p = BAProblem(poses=poses, lmks=lmks, obs=obs, mask=mask,
                          lmk_weight=lmk_w)
            _c, g_p, g_l, H_pp, H_ll, H_pl, _r2, _m = ba_normal_equations(
                cam, p, kernel_param, use_robust)
            # pose-side blocks carry partial landmark sums -> all-reduce
            g_p = lax.psum(g_p, axis)
            H_pp = lax.psum(H_pp, axis)

            eye3 = jnp.eye(3, dtype=lmks.dtype)
            eye6 = jnp.eye(6, dtype=poses.dtype)
            lv = lmk_valid.astype(lmks.dtype)
            diag_ll = eye3 * H_ll.diagonal(0, -2, -1)[..., None, :]
            H_ll_d = ((H_ll + lam * diag_ll + 1e-6 * eye3[None])
                      * lv[:, None, None]
                      + (1 - lv)[:, None, None] * eye3[None])
            H_ll_inv = inv3x3(H_ll_d) * lv[:, None, None]

            W = jnp.einsum("pljk,lkm->pljm", H_pl, H_ll_inv)
            # Schur cross blocks: local landmark contraction, then PSUM
            S_cross = lax.psum(
                jnp.einsum("pljm,qlkm->pqjk", W, H_pl), axis)
            b = g_p - lax.psum(jnp.einsum("pljm,lm->pj", W, g_l), axis)

            S = -S_cross
            S = S.at[jnp.arange(nP), jnp.arange(nP)].add(
                H_pp + lam * eye6[None])
            if use_prior:
                H_pr, g_pr, _c_pr = relpose_prior_terms(
                    poses, rel, rel_w_rot, rel_w_trans)
                S = S + H_pr.transpose(0, 2, 1, 3)
                b = b + g_pr
            if fix_first:
                S = S.at[0, :, :, :].set(0.0)
                S = S.at[:, 0, :, :].set(0.0)
                S = S.at[0, 0].set(eye6)
                b = b.at[0].set(0.0)

            Sd = S.transpose(0, 2, 1, 3).reshape(nP * 6, nP * 6)
            # replicated solve (every shard computes the same small system)
            dpose = jnp.linalg.solve(
                Sd + 1e-8 * jnp.eye(nP * 6, dtype=Sd.dtype),
                b.reshape(-1)).reshape(nP, 6)

            # landmark back-substitution: shard-local
            rhs = g_l - jnp.einsum("pljk,pj->lk", H_pl, dpose)
            dlmk = jnp.einsum("ljk,lk->lj", H_ll_inv, rhs)

            new_poses = poses + dpose
            new_lmks = lmks + dlmk * lv[:, None]
            new_cost = eval_cost(new_poses, new_lmks)
            # the landmark-finiteness vote is shard-local -> psum it so
            # `accept` stays replicated (shard_map varying-axes check)
            n_bad_lmk = lax.psum(
                jnp.sum((~jnp.isfinite(new_lmks)).astype(jnp.float32)), axis)
            accept = ((new_cost < cost) & jnp.isfinite(new_cost)
                      & jnp.all(jnp.isfinite(new_poses))
                      & (n_bad_lmk == 0))
            poses = jnp.where(accept, new_poses, poses)
            lmks = jnp.where(accept, new_lmks, lmks)
            lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-9),
                            jnp.minimum(lam * 8.0, 1e6))
            step = jnp.sqrt(jnp.sum(dpose ** 2))
            done = accept & (step < tol)
            cost = jnp.where(accept, new_cost, cost)
            return it + 1, poses, lmks, lam, cost, done

        def cond(carry):
            it, _p, _l, _lam, _c, done = carry
            return (it < max_iters) & ~done

        cost0 = eval_cost(poses0, lmks0)
        it, poses, lmks, _lam, cost, done = lax.while_loop(
            cond, body,
            (jnp.int32(0), poses0, lmks0, jnp.float32(init_lambda), cost0,
             jnp.bool_(False)))
        return poses, lmks, cost, it, done

    poses, lmks, cost, it, done = jax.jit(lm_solve)(
        prob.poses, prob.lmks, prob.obs, prob.mask, rel_arr, lw)
    return BAResult(poses=poses, lmks=lmks, cost=cost, n_iters=it,
                    converged=done)
