"""Golden parity: the JAX solver vs the measured-reference baseline solver
on IDENTICAL correspondences.

native/rso_baseline.cpp implements the reference's two-phase robust GN with
its exact semantics (m_evalRGN, stage5_optimization.cpp:275-390: pseudo-Huber
rho' weighting the gradient only, SVD solve, residual-threshold cut, pose
inversion).  If the JAX solver and that port disagree beyond numerical noise
on the same inputs, one of them diverged from the reference contract.
"""
import numpy as np
import pytest

from rso import baseline
from rso.config import LeastSquaresParams
from rso.geometry.stereo_camera import StereoCamera

pytestmark = pytest.mark.skipif(not baseline.available(),
                                reason="librso_baseline.so not built")

CAM = StereoCamera.make(fx_l=320.0, fy_l=320.0, cx_l=188.0, cy_l=120.0,
                        baseline=0.4)


def _make_correspondences(n=150, seed=0, noise=0.2, n_outliers=0,
                          w=(0.01, -0.02, 0.005), t=(0.05, -0.03, 0.2)):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 30, n)], -1)
    R = Rotation.from_rotvec(np.asarray(w)).as_matrix()
    Xc = X @ R.T + np.asarray(t)

    def proj(P):
        fx, cx, cy, b = (float(CAM.fx_l), float(CAM.cx_l), float(CAM.cy_l),
                         float(CAM.baseline))
        ul = fx * P[:, 0] / P[:, 2] + cx
        vl = fx * P[:, 1] / P[:, 2] + cy
        ur = fx * (P[:, 0] - b) / P[:, 2] + cx
        return np.stack([ul, vl, ur, vl], -1)

    prev = proj(X)
    cur = proj(Xc) + rng.normal(0, noise, (n, 4))
    if n_outliers:
        cur[:n_outliers] += rng.uniform(20, 60, (n_outliers, 4))
    return prev, cur


def _our_solve(prev, cur, mask, params, init=None):
    import jax.numpy as jnp

    from rso.solver.robust_gn import solve_pose

    out = solve_pose(CAM, jnp.asarray(prev), jnp.asarray(cur),
                     jnp.asarray(mask), params,
                     None if init is None else jnp.asarray(init))
    return np.asarray(out.pose), bool(out.valid)


# exact reference iteration behavior: rho' weights the gradient only
REF_PARAMS = LeastSquaresParams(irls_hessian_weighting=False)


class TestSolverParity:
    def test_clean_solve_matches(self):
        prev, cur = _make_correspondences(noise=0.0)
        mask = np.ones(len(prev), bool)
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM,
                                                  REF_PARAMS)
        our_pose, our_ok = _our_solve(prev, cur, mask, REF_PARAMS)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=2e-5)

    def test_noisy_solve_matches(self):
        prev, cur = _make_correspondences(noise=0.3, seed=3)
        mask = np.ones(len(prev), bool)
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM,
                                                  REF_PARAMS)
        our_pose, our_ok = _our_solve(prev, cur, mask, REF_PARAMS)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=5e-4)

    def test_outliers_cut_identically(self):
        """Both implementations must reject the gross outliers via the
        phase-1 residual cut and land on the same pose."""
        prev, cur = _make_correspondences(noise=0.2, n_outliers=15, seed=5)
        mask = np.ones(len(prev), bool)
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM,
                                                  REF_PARAMS)
        our_pose, our_ok = _our_solve(prev, cur, mask, REF_PARAMS)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=1e-3)
        # and both found roughly the true (inverted) motion
        assert np.linalg.norm(ref_pose[3:] - [-0.05, 0.03, -0.2]) < 0.02

    def test_masked_entries_ignored(self):
        prev, cur = _make_correspondences(noise=0.1, seed=7)
        # poison masked-out rows: they must not affect either solver
        mask = np.ones(len(prev), bool)
        mask[:30] = False
        cur2 = cur.copy()
        cur2[:30] = 1e6
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur2, mask, CAM,
                                                  REF_PARAMS)
        our_pose, our_ok = _our_solve(prev, cur2, mask, REF_PARAMS)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=5e-4)

    def test_too_few_points_invalid(self):
        prev, cur = _make_correspondences(n=6)
        mask = np.ones(6, bool)
        _, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM, REF_PARAMS)
        _, our_ok = _our_solve(prev, cur, mask, REF_PARAMS)
        assert not ref_ok and not our_ok

    def test_warm_start_agrees(self):
        prev, cur = _make_correspondences(noise=0.1, seed=11,
                                          t=(0.0, 0.0, 0.6))
        mask = np.ones(len(prev), bool)
        init = np.array([0.0, 0.0, 0.0, 0.0, 0.0, -0.5])
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM,
                                                  REF_PARAMS, init)
        our_pose, our_ok = _our_solve(prev, cur, mask, REF_PARAMS, init)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=5e-4)

    def test_no_robust_kernel(self):
        params = LeastSquaresParams(use_robust_kernel=False,
                                    irls_hessian_weighting=False)
        prev, cur = _make_correspondences(noise=0.05, seed=13)
        mask = np.ones(len(prev), bool)
        ref_pose, ref_ok, _ = baseline.solve_pose(prev, cur, mask, CAM,
                                                  params)
        our_pose, our_ok = _our_solve(prev, cur, mask, params)
        assert ref_ok and our_ok
        np.testing.assert_allclose(our_pose, ref_pose, atol=2e-4)
