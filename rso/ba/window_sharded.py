"""Window-sharded BA: independent windows over one mesh axis, landmarks
over the other.

Landmark sharding (rso.ba.distributed) pays one reduced-camera psum every
LM iteration.  Window problems are independent (the sliding-window pipeline
emits one per keyframe; offline long-sequence refinement solves many at
once, reference analogue SURVEY.md §5 "long-context"), so sharding the
WINDOW axis needs no communication inside the LM loop at all — only the
initial scatter and the final gather of problem/solution arrays.  Landmarks
of each window still shard over the second axis, where the per-iteration
[P*6,P*6]+[P*6] psum is small.

Mesh layout: 2-D ('win', 'lmk').  The mesh follows the algorithm: cards
joined all to all (NVLink on one host) need no topology-aware placement,
and across hosts 'win' is the axis to lay over the slower link.
tests/test_window_sharded.py checks from the compiled HLO that every
collective's replica group stays within one 'lmk' row (no cross-'win'
traffic inside the LM loop).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from rso.ba.ba import (
    BAProblem,
    BAResult,
    _project_grid,
    _robust_weights,
    ba_normal_equations,
    inv3x3,
    relpose_prior_terms,
)
from rso.geometry.stereo_camera import StereoCamera


def make_win_mesh(n_hosts: int, chips_per_host: int | None = None,
                  devices=None) -> Mesh:
    """('win','lmk') mesh of n_hosts x chips_per_host devices.  Across hosts
    pass jax.devices() so 'win' lines up with processes; within one host
    (all-to-all links) or on a virtual CPU mesh any reshape works."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    if chips_per_host is None:
        chips_per_host = len(devs) // n_hosts
    devs = devs[: n_hosts * chips_per_host]
    return Mesh(devs.reshape(n_hosts, chips_per_host),
                axis_names=("win", "lmk"))


def stack_problems(probs: list[BAProblem]) -> BAProblem:
    """Stack same-shape window problems along a leading window axis."""
    shapes = {(p.poses.shape, p.lmks.shape) for p in probs}
    if len(shapes) != 1:
        raise ValueError(f"window problems must share shapes, got {shapes}")
    lw = [jnp.ones(p.lmks.shape[0], p.lmks.dtype)
          if p.lmk_weight is None else p.lmk_weight for p in probs]
    return BAProblem(
        poses=jnp.stack([p.poses for p in probs]),
        lmks=jnp.stack([p.lmks for p in probs]),
        obs=jnp.stack([p.obs for p in probs]),
        mask=jnp.stack([p.mask for p in probs]),
        lmk_weight=jnp.stack(lw),
    )


def _pad_axis(x, n, axis):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n)
    return jnp.pad(x, pad)


@partial(jax.jit, static_argnames=(
    "mesh", "max_iters", "use_robust", "fix_first", "rel_w_rot",
    "rel_w_trans", "kernel_param", "init_lambda", "tol"))
def _sharded_solve(cam, poses, lmks, obs, mask, lmk_w, rel, active, *,
                   mesh, max_iters, kernel_param, use_robust, fix_first,
                   init_lambda, tol, rel_w_rot, rel_w_trans):
    """[W,...]-stacked LM solve, shard_map'ed over the ('win','lmk') mesh.

    Inside: vmap over this shard's windows; lax.psum ONLY over 'lmk' — the
    'win' axis never communicates during the loop.
    """
    use_prior = rel_w_rot > 0 or rel_w_trans > 0
    nP = poses.shape[1]

    def one_window(poses0, lmks0, obs, mask, lmk_w, rel, active):
        """One window's LM loop on this device's landmark shard."""
        lmk_valid = jnp.any(mask, axis=0)

        def prior_cost(ps):
            if not use_prior:
                return 0.0
            W = jnp.concatenate([
                jnp.full((3,), rel_w_rot, ps.dtype),
                jnp.full((3,), rel_w_trans, ps.dtype)])
            from rso.ba.ba import _relpose_residuals

            e = _relpose_residuals(ps, rel)
            return 0.5 * jnp.sum(e * e * W[None, :])

        def eval_cost(ps, ls):
            pix, _, _ = _project_grid(cam, ps, ls)
            r2 = jnp.sum((obs - pix) ** 2, axis=-1)
            _, fi = _robust_weights(r2, kernel_param, use_robust)
            m = (mask & jnp.all(jnp.isfinite(pix), -1)).astype(fi.dtype)
            m = m * lmk_w[None, :]
            return lax.psum(jnp.sum(m * fi), "lmk") + prior_cost(ps)

        def body(carry):
            it, ps, ls, lam, cost, done = carry
            p = BAProblem(poses=ps, lmks=ls, obs=obs, mask=mask,
                          lmk_weight=lmk_w)
            _c, g_p, g_l, H_pp, H_ll, H_pl, _r2, _m = ba_normal_equations(
                cam, p, kernel_param, use_robust)
            g_p = lax.psum(g_p, "lmk")
            H_pp = lax.psum(H_pp, "lmk")

            eye3 = jnp.eye(3, dtype=ls.dtype)
            eye6 = jnp.eye(6, dtype=ps.dtype)
            lv = lmk_valid.astype(ls.dtype)
            diag_ll = eye3 * H_ll.diagonal(0, -2, -1)[..., None, :]
            H_ll_d = ((H_ll + lam * diag_ll + 1e-6 * eye3[None])
                      * lv[:, None, None]
                      + (1 - lv)[:, None, None] * eye3[None])
            H_ll_inv = inv3x3(H_ll_d) * lv[:, None, None]

            W = jnp.einsum("pljk,lkm->pljm", H_pl, H_ll_inv)
            S_cross = lax.psum(
                jnp.einsum("pljm,qlkm->pqjk", W, H_pl), "lmk")
            b = g_p - lax.psum(jnp.einsum("pljm,lm->pj", W, g_l), "lmk")

            S = -S_cross
            S = S.at[jnp.arange(nP), jnp.arange(nP)].add(
                H_pp + lam * eye6[None])
            if use_prior:
                H_pr, g_pr, _ = relpose_prior_terms(ps, rel, rel_w_rot,
                                                    rel_w_trans)
                S = S + H_pr.transpose(0, 2, 1, 3)
                b = b + g_pr
            if fix_first:
                S = S.at[0, :, :, :].set(0.0)
                S = S.at[:, 0, :, :].set(0.0)
                S = S.at[0, 0].set(eye6)
                b = b.at[0].set(0.0)

            Sd = S.transpose(0, 2, 1, 3).reshape(nP * 6, nP * 6)
            dpose = jnp.linalg.solve(
                Sd + 1e-8 * jnp.eye(nP * 6, dtype=Sd.dtype),
                b.reshape(-1)).reshape(nP, 6)

            rhs = g_l - jnp.einsum("pljk,pj->lk", H_pl, dpose)
            dlmk = jnp.einsum("ljk,lk->lj", H_ll_inv, rhs)

            new_ps = ps + dpose
            new_ls = ls + dlmk * lv[:, None]
            new_cost = eval_cost(new_ps, new_ls)
            n_bad = lax.psum(
                jnp.sum((~jnp.isfinite(new_ls)).astype(jnp.float32)), "lmk")
            accept = ((new_cost < cost) & jnp.isfinite(new_cost)
                      & jnp.all(jnp.isfinite(new_ps)) & (n_bad == 0))
            ps = jnp.where(accept, new_ps, ps)
            ls = jnp.where(accept, new_ls, ls)
            lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-9),
                            jnp.minimum(lam * 8.0, 1e6))
            step = jnp.sqrt(jnp.sum(dpose ** 2))
            done = done | (accept & (step < tol))
            cost = jnp.where(accept, new_cost, cost)
            return it + 1, ps, ls, lam, cost, done

        def cond(carry):
            it, _p, _l, _lam, _c, done = carry
            return (it < max_iters) & ~done

        cost0 = eval_cost(poses0, lmks0)
        # padded windows start done: under vmap the while_loop runs until
        # every window is done, so an inactive window must not hold the
        # real ones at max_iters.  Scalar carry inits are literals
        # (replicated); the loop body makes them 'win'-varying (no psum over
        # 'win' — that is the whole point), so mark them varying up front or
        # shard_map's vma check rejects the carry.
        def _vary(x):
            return lax.pcast(x, ("win",), to="varying")

        it, ps, ls, _lam, cost, done = lax.while_loop(
            cond, body,
            (_vary(jnp.int32(0)), poses0, lmks0,
             _vary(jnp.float32(init_lambda)), cost0, ~active))
        return ps, ls, cost, it, done

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("win"), P("win", "lmk"), P("win", None, "lmk"),
                  P("win", None, "lmk"), P("win", "lmk"), P("win"),
                  P("win")),
        out_specs=(P("win"), P("win", "lmk"), P("win"), P("win"), P("win")),
    )
    def run(poses, lmks, obs, mask, lmk_w, rel, active):
        return jax.vmap(one_window)(poses, lmks, obs, mask, lmk_w, rel,
                                    active)

    return run(poses, lmks, obs, mask, lmk_w, rel, active)


def window_sharded_bundle_adjust(
    cam: StereoCamera,
    probs: list[BAProblem],
    mesh: Mesh,
    max_iters: int = 20,
    kernel_param: float = 3.0,
    use_robust: bool = True,
    fix_first: bool = True,
    init_lambda: float = 1e-4,
    tol: float = 1e-5,
    rel_meas: list | None = None,
    rel_w_rot: float = 0.0,
    rel_w_trans: float = 0.0,
) -> list[BAResult]:
    """Solve a batch of independent window problems over a ('win','lmk')
    mesh; returns one BAResult per input problem (padding stripped).

    rel_meas: optional per-window [P-1,6] odometry-prior measurements (the
    same weights apply to every window — they are physical noise levels, not
    per-window tunables).
    """
    assert mesh.axis_names == ("win", "lmk"), mesh.axis_names
    W = len(probs)
    stacked = stack_problems(probs)
    nP = stacked.poses.shape[1]
    if rel_meas is not None:
        rel = jnp.stack([jnp.asarray(r, stacked.poses.dtype)
                         for r in rel_meas])
    else:
        rel = jnp.zeros((W, max(nP - 1, 1), 6), stacked.poses.dtype)

    n_win, n_lmk = mesh.devices.shape
    Wp = ((W + n_win - 1) // n_win) * n_win
    L = stacked.lmks.shape[1]
    Lp = ((L + n_lmk - 1) // n_lmk) * n_lmk

    poses = _pad_axis(stacked.poses, Wp - W, 0)
    # benign depth for padded landmark slots (z=0 would project to inf)
    lmks = _pad_axis(stacked.lmks, Wp - W, 0)
    lmks = jnp.concatenate([
        lmks, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 10.0], lmks.dtype),
                               (Wp, Lp - L, 3))], axis=1) \
        if Lp != L else lmks
    obs = _pad_axis(_pad_axis(stacked.obs, Wp - W, 0), Lp - L, 2)
    mask = _pad_axis(_pad_axis(stacked.mask, Wp - W, 0), Lp - L, 2)
    lmk_w = _pad_axis(_pad_axis(stacked.lmk_weight, Wp - W, 0), Lp - L, 1)
    rel = _pad_axis(rel, Wp - W, 0)
    active = jnp.arange(Wp) < W

    ps, ls, cost, iters, done = _sharded_solve(
        cam, poses, lmks, obs, mask, lmk_w, rel, active, mesh=mesh,
        max_iters=max_iters, kernel_param=kernel_param,
        use_robust=use_robust, fix_first=fix_first,
        init_lambda=init_lambda, tol=tol, rel_w_rot=rel_w_rot,
        rel_w_trans=rel_w_trans)
    return [BAResult(poses=ps[w], lmks=ls[w, :L], cost=cost[w],
                     n_iters=iters[w], converged=done[w])
            for w in range(W)]


# ---- offline long-sequence splitting / stitching -------------------------


def split_into_windows(n_kfs: int, window: int, overlap: int) -> list[range]:
    """Index ranges covering 0..n_kfs-1 with `overlap` shared keyframes
    between consecutive windows (the shared poses let stitching re-anchor
    each window's gauge)."""
    assert 0 < overlap < window
    step = window - overlap
    out = []
    s = 0
    while True:
        e = min(s + window, n_kfs)
        out.append(range(s, e))
        if e >= n_kfs:
            break
        s += step
    return out


def stitch_window_poses(poses6_list: list[np.ndarray],
                        ranges: list[range], overlap: int,
                        n_kfs: int) -> np.ndarray:
    """Chain per-window world->cam pose solutions into one global trajectory.

    Each window is solved in its own gauge (first pose frozen at its VO
    value); window w re-anchors by the rigid transform that maps its FIRST
    keyframe onto the same keyframe's pose in the already-stitched window
    w-1 (they share `overlap` keyframes).  Returns [n_kfs,4,4]
    camera-to-world.
    """
    from scipy.spatial.transform import Rotation

    def t_wc(p6):
        R_cw = Rotation.from_rotvec(np.asarray(p6[:3])).as_matrix()
        T = np.eye(4)
        T[:3, :3] = R_cw.T
        T[:3, 3] = -R_cw.T @ np.asarray(p6[3:])
        return T

    out = [None] * n_kfs
    A = np.eye(4)
    for w, (p6s, rng) in enumerate(zip(poses6_list, ranges)):
        locs = [t_wc(p) for p in np.asarray(p6s)[: len(rng)]]
        if w > 0:
            # anchor: this window's first KF == global index rng.start,
            # already solved by the previous window
            A = out[rng.start] @ np.linalg.inv(locs[0])
        for j, gi in enumerate(rng):
            T = A @ locs[j]
            if out[gi] is None or j >= overlap:
                out[gi] = T
    return np.stack(out)
