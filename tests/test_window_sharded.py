"""Window-sharded multi-host BA (rso.ba.window_sharded): equivalence vs the
single-device solver, window padding, zero cross-'win' collectives, and
offline split/stitch round trip.  Runs on the conftest 8-device virtual CPU
mesh as a (4 hosts x 2 chips) stand-in."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from rso.ba import BAProblem, bundle_adjust
from rso.ba.ba import _project_grid
from rso.ba.window_sharded import (
    make_win_mesh,
    split_into_windows,
    stitch_window_poses,
    window_sharded_bundle_adjust,
)
from rso.geometry.stereo_camera import StereoCamera

CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                        baseline=0.5)


def _make_problem(seed, P=4, L=64, noise=0.2):
    rng = np.random.default_rng(seed)
    true_poses = []
    for p in range(P):
        T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
        w = np.array([0.0, 0.002 * p, 0.0])
        Rwc = Rotation.from_rotvec(w).as_matrix().T
        t = -Rwc @ T_wc
        true_poses.append(np.concatenate([
            Rotation.from_matrix(Rwc).as_rotvec(), t]))
    true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
    lmks_true = jnp.asarray(np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(5, 30, L)], -1), jnp.float32)
    pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
    obs = pix + jnp.asarray(rng.normal(0, noise, pix.shape), jnp.float32)
    return BAProblem(
        poses=(true_poses + 0.01).at[0].set(true_poses[0]),
        lmks=lmks_true + 0.05,
        obs=obs,
        mask=jnp.ones((P, L), bool),
    )


class TestWindowSharded:
    def test_matches_single_device_solver(self):
        """4 windows over a (4,2) mesh must reproduce 4 independent
        bundle_adjust solves (same LM schedule, psum'd sums)."""
        probs = [_make_problem(s) for s in range(4)]
        mesh = make_win_mesh(4, 2)
        outs = window_sharded_bundle_adjust(CAM, probs, mesh, max_iters=10)
        assert len(outs) == 4
        for prob, out in zip(probs, outs):
            ref = bundle_adjust(CAM, prob, max_iters=10)
            np.testing.assert_allclose(np.asarray(out.poses),
                                       np.asarray(ref.poses), atol=1e-3)

    def test_window_padding(self):
        """3 windows on a 4-wide 'win' axis: the padded slot must not
        perturb the real ones or deadlock the batched while_loop."""
        probs = [_make_problem(s) for s in range(3)]
        mesh = make_win_mesh(4, 2)
        outs = window_sharded_bundle_adjust(CAM, probs, mesh, max_iters=10)
        assert len(outs) == 3
        ref = bundle_adjust(CAM, probs[1], max_iters=10)
        np.testing.assert_allclose(np.asarray(outs[1].poses),
                                   np.asarray(ref.poses), atol=1e-3)

    def test_odd_landmark_count_pads(self):
        probs = [_make_problem(s, L=63) for s in range(2)]
        mesh = make_win_mesh(2, 2)
        outs = window_sharded_bundle_adjust(CAM, probs, mesh, max_iters=8)
        assert outs[0].lmks.shape == (63, 3)
        ref = bundle_adjust(CAM, probs[0], max_iters=8)
        np.testing.assert_allclose(np.asarray(outs[0].poses),
                                   np.asarray(ref.poses), atol=1e-3)

    def test_no_cross_window_collectives(self):
        """The compiled LM loop must contain NO collective whose replica
        group spans two 'win' rows — no cross-window traffic, checked on
        the compiled HLO itself."""
        import re

        from rso.ba.window_sharded import _pad_axis, _sharded_solve, \
            stack_problems

        probs = [_make_problem(s) for s in range(4)]
        mesh = make_win_mesh(4, 2)
        stacked = stack_problems(probs)
        rel = jnp.zeros((4, 3, 6), jnp.float32)
        active = jnp.ones(4, bool)
        lowered = jax.jit(lambda *a: _sharded_solve(
            *a, mesh=mesh, max_iters=1, kernel_param=3.0, use_robust=True,
            fix_first=True, init_lambda=1e-4, tol=0.0, rel_w_rot=0.0,
            rel_w_trans=0.0)).lower(
            CAM, stacked.poses, stacked.lmks, stacked.obs, stacked.mask,
            stacked.lmk_weight, rel, active)
        hlo = lowered.compile().as_text()
        # device d = win_row * 2 + lmk_col on the (4,2) mesh: a legal group
        # stays within one row {2r, 2r+1}
        groups = re.findall(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}",
                            hlo)
        for g in groups:
            for grp in re.findall(r"\{([^}]*)\}", g):
                ids = [int(x) for x in grp.split(",") if x.strip()]
                rows = {i // 2 for i in ids}
                assert len(rows) <= 1, \
                    f"collective spans 'win' rows: {ids}\n"


class TestSplitStitch:
    def _trajectory(self, n, step=0.4):
        poses6, mats = [], []
        T = np.eye(4)
        for i in range(n):
            mats.append(T.copy())
            R_cw = T[:3, :3].T
            t_cw = -R_cw @ T[:3, 3]
            poses6.append(np.concatenate([
                Rotation.from_matrix(R_cw).as_rotvec(), t_cw]))
            d = np.eye(4)
            d[:3, :3] = Rotation.from_rotvec([0, 0.01, 0]).as_matrix()
            d[:3, 3] = [0, 0, step]
            T = T @ d
        return np.stack(poses6, dtype=np.float32), np.stack(mats)

    def test_split_covers_and_overlaps(self):
        rs = split_into_windows(20, window=8, overlap=2)
        assert rs[0] == range(0, 8)
        assert rs[1].start == 6  # 2-KF overlap
        assert rs[-1].stop == 20
        covered = sorted(set().union(*[set(r) for r in rs]))
        assert covered == list(range(20))

    def test_stitch_exact_on_consistent_windows(self):
        """Windows cut from one consistent trajectory, each re-gauged to its
        own first keyframe, must stitch back to the global trajectory."""
        n, win, ov = 20, 8, 2
        poses6, mats = self._trajectory(n)
        ranges = split_into_windows(n, win, ov)
        per_win = []
        for r in ranges:
            # re-gauge: left-compose each window by the inverse of its first
            # camera-to-world (what a fix_first solve in local gauge yields)
            G = np.linalg.inv(mats[r.start])
            loc = []
            for gi in r:
                Tl = G @ mats[gi]
                R_cw = Tl[:3, :3].T
                t_cw = -R_cw @ Tl[:3, 3]
                loc.append(np.concatenate([
                    Rotation.from_matrix(R_cw).as_rotvec(), t_cw]))
            per_win.append(np.stack(loc, dtype=np.float32))
        out = stitch_window_poses(per_win, ranges, ov, n)
        np.testing.assert_allclose(out, mats, atol=1e-4)


class TestOfflineRefine:
    """rso.ba.offline.refine_trajectory: drifted VO + exact keyframe
    observations -> window-sharded solve + stitch must recover most of the
    drift (the library form of tools/eval_global_refine.py)."""

    def test_recovers_injected_drift(self):
        from rso.ba.offline import refine_trajectory
        from rso.ba.window import KeyframeObs
        from rso.ba.window_sharded import make_win_mesh
        from rso.metrics.ate import ate_rmse

        rng = np.random.default_rng(3)
        n_kf, L = 12, 96
        # ground-truth forward trajectory with gentle yaw
        gt = []
        T = np.eye(4)
        for i in range(n_kf):
            gt.append(T.copy())
            d = np.eye(4)
            d[:3, :3] = Rotation.from_rotvec([0, 0.01, 0]).as_matrix()
            d[:3, 3] = [0, 0, 0.5]
            T = T @ d
        gt = np.stack(gt)
        lmks = np.stack([rng.uniform(-6, 6, L), rng.uniform(-3, 3, L),
                         rng.uniform(4, 20, L)], -1)

        def project(T_wc, P):
            Pc = (P - T_wc[:3, 3]) @ T_wc[:3, :3]
            z = Pc[:, 2]
            uL = 500.0 * Pc[:, 0] / z + 320.0
            vL = 500.0 * Pc[:, 1] / z + 240.0
            uR = 500.0 * (Pc[:, 0] - 0.5) / z + 320.0
            return np.stack([uL, vL, uR, vL], -1), z > 0.5

        # drifted VO: growing yaw error
        vo = []
        for i, Tg in enumerate(gt):
            E = np.eye(4)
            E[:3, :3] = Rotation.from_rotvec([0, 0.004 * i, 0]).as_matrix()
            E[:3, 3] = [0.02 * i, 0, 0]
            vo.append(E @ Tg)
        vo = np.stack(vo)

        kfs = []
        for i in range(n_kf):
            obs, ok = project(gt[i], lmks)  # EXACT observations
            kfs.append(KeyframeObs(pose_wc=vo[i].copy(),
                                   ids=np.arange(L)[ok].astype(np.int64),
                                   obs=obs[ok].astype(np.float32),
                                   pose_vo=vo[i].copy()))

        from rso.geometry.stereo_camera import StereoCamera

        cam = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0,
                                cy_l=240.0, baseline=0.5)
        mesh = make_win_mesh(4, 2)
        refined = refine_trajectory(cam, kfs, list(range(n_kf)), vo,
                                    window=6, overlap=2, mesh=mesh,
                                    rel_w_rot=0.0, rel_w_trans=0.0)
        ate_vo = ate_rmse(vo, gt)
        ate_ref = ate_rmse(refined, gt)
        assert ate_ref < 0.5 * ate_vo, (ate_vo, ate_ref)

    def test_too_few_keyframes_passthrough(self):
        from rso.ba.offline import refine_trajectory
        from rso.geometry.stereo_camera import StereoCamera

        cam = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0,
                                cy_l=240.0, baseline=0.5)
        vo = np.tile(np.eye(4), (5, 1, 1))
        out = refine_trajectory(cam, [], [], vo)
        np.testing.assert_array_equal(out, vo)

    def test_demo_cli_ba_offline(self, tmp_path):
        """rso-demo --ba-offline end-to-end on the synthetic sequence."""
        from rso.cli import demo

        out = tmp_path / "traj.txt"
        rc = demo.main(["--synthetic", "--frames", "16", "--ba-offline",
                        "--out", str(out), "--verbosity", "0"])
        assert rc == 0
        assert np.loadtxt(out).shape[1] == 12
