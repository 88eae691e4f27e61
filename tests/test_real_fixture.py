"""Property tests on the reference's REAL stereo fixture.

The reference ships one real rectified stereo pair with a known ground-truth
correspondence L(646,263) <-> R(624,263) and builds its only meaningful test
on it: the SAD at the true correspondence must be a strict local minimum
(computeSAD8_unittest.cpp:20-41).  These tests re-assert that contract on the
rso's kernels and drive the detector / matcher / descriptor paths on
real texture — the synthetic blob scenes cannot falsify descriptor
discriminativeness, real pixels can.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp

FIXTURE_DIR = "/root/reference/libstereo-odometry/tests"
GT_L = (646, 263)   # ground-truth correspondence (computeSAD8_unittest.cpp:27)
GT_R = (624, 263)


def _load_fixture():
    lp = os.path.join(FIXTURE_DIR, "0L.png")
    rp = os.path.join(FIXTURE_DIR, "0R.png")
    if not (os.path.exists(lp) and os.path.exists(rp)):
        pytest.skip("reference image fixture not present")
    try:
        import cv2

        return (cv2.imread(lp, cv2.IMREAD_GRAYSCALE),
                cv2.imread(rp, cv2.IMREAD_GRAYSCALE))
    except ImportError:
        from PIL import Image

        return (np.asarray(Image.open(lp).convert("L")),
                np.asarray(Image.open(rp).convert("L")))


@pytest.fixture(scope="module")
def pair():
    return _load_fixture()


class TestSAD8RealPixels:
    def test_strict_local_minimum(self, pair):
        """The reference's own property: SAD(GT) < SAD(all 8 neighbors)."""
        from rso.frontend.detect import extract_patches
        from rso.kernels import sad_matrix_jnp

        L, R = pair
        jL = jnp.asarray(L, jnp.float32)
        jR = jnp.asarray(R, jnp.float32)
        pl = extract_patches(jL, jnp.asarray([GT_L], jnp.float32))      # [1,64]
        neigh = [(GT_R[0] + ix, GT_R[1] + iy)
                 for iy in (-1, 0, 1) for ix in (-1, 0, 1)]
        pr = extract_patches(jR, jnp.asarray(neigh, jnp.float32))       # [9,64]
        sads = np.asarray(sad_matrix_jnp(pl, pr))[0]                    # [9]
        center = sads[4]
        assert center < 600           # "minimum of a good match ~300-500"
        others = np.delete(sads, 4)
        assert (others > center).all()

    def test_mxu_distance_ranks_like_exact_sad(self, pair):
        """The MXU squared-L2 surrogate must rank the true correspondence
        first among the 3x3 neighborhood, like exact SAD does."""
        from rso.frontend.detect import extract_patches
        from rso.kernels.distance import sad_matrix_mxu

        L, R = pair
        pl = extract_patches(jnp.asarray(L, jnp.float32),
                             jnp.asarray([GT_L], jnp.float32))
        neigh = [(GT_R[0] + ix, GT_R[1] + iy)
                 for iy in (-1, 0, 1) for ix in (-1, 0, 1)]
        pr = extract_patches(jnp.asarray(R, jnp.float32),
                             jnp.asarray(neigh, jnp.float32))
        d = np.asarray(sad_matrix_mxu(pl, pr))[0]
        assert d.argmin() == 4

    def test_native_oracle_agrees_on_real_pixels(self, pair):
        """C++ oracle vs jnp on the real fixture (the reference's
        scalar-vs-SIMD equivalence pattern, computeSAD8_unittest.cpp:61-76)."""
        from rso import native

        if not native.available():
            pytest.skip("native oracle not built")
        from rso.frontend.detect import extract_patches
        from rso.kernels import sad_matrix_jnp

        L, R = pair
        rng = np.random.default_rng(0)
        xs = rng.integers(20, 780, 32)
        ys = rng.integers(20, 580, 32)
        xy = np.stack([xs, ys], -1).astype(np.float32)
        pl = np.asarray(extract_patches(jnp.asarray(L, jnp.float32),
                                        jnp.asarray(xy))).astype(np.uint8)
        pr = np.asarray(extract_patches(jnp.asarray(R, jnp.float32),
                                        jnp.asarray(xy))).astype(np.uint8)
        ref = native.sad_matrix(pl, pr)
        out = np.asarray(sad_matrix_jnp(jnp.asarray(pl, jnp.float32),
                                        jnp.asarray(pr, jnp.float32)))
        np.testing.assert_array_equal(out.astype(np.uint32), ref)

    def test_pointwise_oracle_at_gt(self, pair):
        from rso import native

        if not native.available():
            pytest.skip("native oracle not built")
        L, R = pair
        c = native.compute_sad8(L, R, *GT_L, *GT_R)
        for iy in (-1, 0, 1):
            for ix in (-1, 0, 1):
                if ix or iy:
                    assert native.compute_sad8(
                        L, R, *GT_L, GT_R[0] + ix, GT_R[1] + iy) > c


class TestDetectorRealTexture:
    def test_detects_spread_features(self, pair):
        from rso.config import DetectParams
        from rso.frontend.detect import detect_features

        L, _ = pair
        feats = detect_features(jnp.asarray(L, jnp.float32), DetectParams(),
                                512, jnp.int32(10), need_desc=False)
        v = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[v]
        assert v.sum() >= 350   # measured 393 at th=10 on the fixture
        # features spread over all four quadrants of the real image
        H, W = L.shape
        for qx in (0, 1):
            for qy in (0, 1):
                q = ((xy[:, 0] >= qx * W / 2) & (xy[:, 0] < (qx + 1) * W / 2)
                     & (xy[:, 1] >= qy * H / 2) & (xy[:, 1] < (qy + 1) * H / 2))
                assert q.sum() >= 15

    def test_detected_corners_have_contrast(self, pair):
        """Every detected FAST corner must actually exceed the threshold
        against its Bresenham ring (spot-check on real pixels).  Pins the
        FASTER method: this is a property of the FAST corner test, which the
        shipped KLT default (docs/MODES.md round-5 A/B) does not run."""
        from rso.config import DetectMethod, DetectParams
        from rso.frontend.detect import detect_features

        L, _ = pair
        th = 20
        feats = detect_features(jnp.asarray(L, jnp.float32),
                                DetectParams(detect_method=DetectMethod.FASTER),
                                256, jnp.int32(th), need_desc=False)
        v = np.asarray(feats.valid)
        # keypoints are subpixel-refined by +-0.5px; the FAST property holds
        # at the integer peak = the rounded coordinate
        xy = np.round(np.asarray(feats.xy)[v]).astype(int)
        ring = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
                (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
                (-2, -2), (-1, -3)]
        Li = L.astype(np.int32)
        bad = 0
        for x, y in xy[:100]:
            c = Li[y, x]
            vals = np.array([Li[y + dy, x + dx] for dx, dy in ring])
            bright = (vals > c + th).astype(int)
            dark = (vals < c - th).astype(int)

            def max_run(b):
                bb = np.concatenate([b, b])
                best = run = 0
                for z in bb:
                    run = run + 1 if z else 0
                    best = max(best, run)
                return min(best, 16)

            if max(max_run(bright), max_run(dark)) < 12:
                bad += 1
        assert bad == 0


class TestStereoMatchRealPixels:
    def test_gt_correspondence_wins_sad_match(self, pair):
        """Injected keypoints: the left GT point must match the right GT
        point against same-row decoys through the full stage-3 matcher."""
        from rso.config import LeftRightMatchParams, StereoMatchMethod
        from rso.frontend.detect import Features, extract_patches
        from rso.frontend.stereo_match import match_left_right

        L, R = pair
        jL = jnp.asarray(L, jnp.float32)
        jR = jnp.asarray(R, jnp.float32)

        lxy = np.asarray([GT_L], np.float32)
        # decoys: same row, spread of disparities, plus the GT at slot 0
        rxs = [GT_R[0]] + [GT_R[0] + d for d in (-40, -25, -12, -5, -2, 2,
                                                 5, 12, 19, 22)]
        rxy = np.asarray([[x, GT_R[1]] for x in rxs], np.float32)

        def mk(img, xy):
            K = xy.shape[0]
            return Features(
                xy=jnp.asarray(xy),
                response=jnp.ones(K, jnp.float32),
                valid=jnp.ones(K, bool),
                desc=jnp.zeros((K, 8), jnp.uint32),
                patch=extract_patches(img, jnp.asarray(xy)),
            )

        params = LeftRightMatchParams(
            match_method=StereoMatchMethod.SAD, sad_max_distance=2000,
            sad_max_ratio=0.95, max_y_diff=1.0,
            enable_robust_1to1_match=True)
        m = match_left_right(mk(jL, lxy), mk(jR, rxy), params,
                             img_w=L.shape[1], min_response=0.0)
        assert bool(np.asarray(m.valid)[0])
        assert int(np.asarray(m.ridx)[0]) == 0

    def test_engine_matches_real_pair(self, pair):
        """Full detect+match stages on the real pair: plenty of stereo
        matches, disparities all positive, and features near the GT left
        point land within ~2px of the GT disparity."""
        from rso.config import RSOConfig
        from rso.engine import Engine
        from rso.geometry.stereo_camera import StereoCamera

        L, R = pair
        H, W = L.shape
        cam = StereoCamera.make(fx_l=700.0, fy_l=700.0, cx_l=W / 2.0,
                                cy_l=H / 2.0, baseline=0.12)
        cfg = RSOConfig()
        import dataclasses

        # real-texture SAD levels: a good 8x8 match sits ~300-500 (the
        # reference's own comment, computeSAD8_unittest.cpp:28), so the
        # blob-tuned default sad_max_distance=200 is too tight here
        cfg = cfg.replace(lr_match=dataclasses.replace(
            cfg.lr_match, max_y_diff=1.0, enable_robust_1to1_match=True,
            sad_max_distance=1000, sad_max_ratio=0.6))
        eng = Engine(cfg, cam)
        res = eng.process_frame(L, R)
        n_match = int(np.asarray(res.stereo_matches).sum())
        assert n_match >= 150   # measured 184 on the fixture

        oc = eng.state.prev.octaves[0]
        mv = np.asarray(oc.matches.valid)
        mi = np.asarray(oc.matches.ridx)
        lxy = np.asarray(oc.left.xy)
        rxy = np.asarray(oc.right.xy)
        disp = lxy[mv, 0] - rxy[mi[mv], 0]
        assert (disp > 0).all()
        # features within 12px of the GT left point: disparity ~22
        near = mv & (np.abs(lxy[:, 0] - GT_L[0]) < 12) & (
            np.abs(lxy[:, 1] - GT_L[1]) < 12)
        assert near.sum() >= 1
        d_near = lxy[near, 0] - rxy[mi[near], 0]
        gt_disp = GT_L[0] - GT_R[0]
        assert np.abs(np.median(d_near) - gt_disp) <= 1.0

    def test_engine_zero_motion_on_real_pair(self, pair):
        """Full 5-stage pipeline on REAL pixels, static case: processing the
        identical real pair twice must estimate ~zero motion (< 0.05 deg,
        < 5 mm).  The end-to-end real-data contract no synthetic render can
        stand in for; the CLI-level version (KITTI-layout tree + native
        decode ring + demo) is tools/real_kitti_drive.py ->
        docs/artifacts/real_kitti_drive_r4.json."""
        import dataclasses

        from rso.config import RSOConfig
        from rso.engine import Engine
        from rso.geometry import pose_matrix
        from rso.geometry.stereo_camera import StereoCamera

        L, R = pair
        H, W = L.shape
        cam = StereoCamera.make(fx_l=700.0, fy_l=700.0, cx_l=W / 2.0,
                                cy_l=H / 2.0, baseline=0.12)
        cfg = RSOConfig()
        cfg = cfg.replace(lr_match=dataclasses.replace(
            cfg.lr_match, max_y_diff=1.0, enable_robust_1to1_match=True,
            sad_max_distance=1000, sad_max_ratio=0.6))
        eng = Engine(cfg, cam)
        eng.process_frame(L, R)
        res = eng.process_frame(L, R)
        assert bool(res.valid)
        M = np.asarray(pose_matrix(res.pose))
        ang = np.degrees(np.arccos(np.clip((np.trace(M[:3, :3]) - 1) / 2,
                                           -1, 1)))
        assert ang < 0.05, f"static real pair: {ang:.4f} deg rotation"
        assert np.linalg.norm(M[:3, 3]) < 0.005


class TestDescriptorMarginRealTexture:
    """Settles the round-1 question: is the BRIEF descriptor discriminative
    on real texture (the blob scenes could not tell)?"""

    def _desc_match_stats(self, pair, upright):
        from rso.config import DetectParams
        from rso.frontend.detect import detect_features
        from rso.kernels.distance import hamming_matrix_jnp

        L, R = pair
        p = DetectParams(orb_upright=upright)
        fl = detect_features(jnp.asarray(L, jnp.float32), p, 512,
                             jnp.int32(20), need_desc=True)
        fr = detect_features(jnp.asarray(R, jnp.float32), p, 512,
                             jnp.int32(20), need_desc=True)
        D = np.asarray(hamming_matrix_jnp(fl.desc, fr.desc)).astype(np.float64)
        vl = np.asarray(fl.valid)
        vr = np.asarray(fr.valid)
        D[~vl] = 1e9
        D[:, ~vr] = 1e9
        lxy = np.asarray(fl.xy)
        rxy = np.asarray(fr.xy)
        best = D.argmin(1)
        bestd = D.min(1)
        D2 = D.copy()
        D2[np.arange(D.shape[0]), best] = 1e9
        second = D2.min(1)
        ok = vl & (bestd < 1e8)
        dy = np.abs(lxy[ok, 1] - rxy[best[ok], 1])
        dx = lxy[ok, 0] - rxy[best[ok], 0]
        epi_ok = (dy <= 2.0) & (dx >= 0) & (dx <= 120)
        return {
            "inlier_rate": epi_ok.mean(),
            "best_mean": bestd[ok][epi_ok].mean(),
            "margin_mean": (second[ok] - bestd[ok])[epi_ok].mean(),
        }

    def test_brief_discriminative_on_real_texture(self, pair):
        # measured on the fixture: inlier_rate 0.50, best_mean 18.5,
        # margin_mean 28.6 — the true-correspondence Hamming distance is far
        # below random (128/256) with a wide margin to the runner-up, i.e.
        # the round-1 BF-mode ATE collapse was a property of the blob scenes,
        # not of the descriptor
        s = self._desc_match_stats(pair, upright=True)
        assert s["inlier_rate"] > 0.40
        assert s["best_mean"] < 40.0
        assert s["margin_mean"] > 10.0

    def test_oriented_brief_also_discriminative(self, pair):
        # measured: inlier_rate 0.45, best_mean 19.2, margin_mean 21.7
        s = self._desc_match_stats(pair, upright=False)
        assert s["inlier_rate"] > 0.35
        assert s["best_mean"] < 40.0
        assert s["margin_mean"] > 8.0


class TestSixDofRealPixels:
    """Per-axis motion contracts on real pixels (the CI version of
    tools/real_6dof_drive.py; full-size artifact docs/artifacts/
    real_6dof_r5.json).  Frame i warps BOTH eyes by the rotation homography
    K R(i*theta)^T K^-1 about the crop's principal point — exactly a rigid
    rig rotation when the axis is the baseline (pitch), and within
    O(theta*B/Z) ~ 0.05 px otherwise — so the engine's per-frame delta must
    be theta about that axis with ~zero translation.  Extends the
    zero-motion and 1-DoF pan contracts to roll, pitch, AND yaw."""

    N, THETA, F, BASE = 5, 0.3, 520.0, 0.12
    CROP, OFF = (320, 240), (240, 180)

    def _axis_deltas(self, pair, axis):
        cv2 = pytest.importorskip("cv2")
        from rso.engine import Engine
        from rso.geometry.stereo_camera import StereoCamera
        from rso.synthetic import textured_config

        L, R = pair
        (W, Hc), (x0, y0) = self.CROP, self.OFF
        K = np.array([[self.F, 0, x0 + W / 2.0],
                      [0, self.F, y0 + Hc / 2.0], [0, 0, 1.0]])
        a = np.asarray(axis, np.float64)
        Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                       [-a[1], a[0], 0]])
        frames = []
        for i in range(self.N):
            th = np.radians(i * self.THETA)
            Rm = (np.eye(3) + np.sin(th) * Kx
                  + (1 - np.cos(th)) * (Kx @ Kx))
            Hm = K @ Rm.T @ np.linalg.inv(K)
            li = cv2.warpPerspective(L, Hm, (L.shape[1], L.shape[0]))
            ri = cv2.warpPerspective(R, Hm, (R.shape[1], R.shape[0]))
            frames.append((li[y0:y0 + Hc, x0:x0 + W],
                           ri[y0:y0 + Hc, x0:x0 + W]))
        cam = StereoCamera.make(fx_l=self.F, fy_l=self.F, cx_l=W / 2.0,
                                cy_l=Hc / 2.0, baseline=self.BASE)
        eng = Engine(textured_config(), cam)
        Ls = jnp.stack([jnp.asarray(l) for l, _ in frames])
        Rs = jnp.stack([jnp.asarray(r) for _, r in frames])
        res = eng.process_chunk(Ls, Rs)
        ok = np.asarray(res.valid)[1:]
        return np.asarray(res.pose)[1:][ok], int(ok.sum())

    @pytest.mark.parametrize("name,axis", [("yaw", (0, 1, 0)),
                                           ("pitch", (1, 0, 0)),
                                           ("roll", (0, 0, 1))])
    def test_axis_rotation_recovered(self, pair, name, axis):
        poses, n_valid = self._axis_deltas(pair, axis)
        assert n_valid == self.N - 1
        w, t = poses[:, :3], poses[:, 3:]
        angs = np.degrees(np.linalg.norm(w, axis=1))
        med = float(np.median(angs))
        # per-axis bounds like the pan check: magnitude within 15% of GT
        # (tool measures 2-4% at full size; the 320x240 CI crop is looser),
        # rotation axis dominant, translation ~0 (<=15 mm — FASTER features
        # on the small crop measured up to 10.0 mm on the pitch axis)
        assert abs(med - self.THETA) / self.THETA < 0.15, (name, angs)
        assert (np.abs(w).argmax(1) == int(np.argmax(axis))).all(), (name, w)
        assert np.linalg.norm(t, axis=1).max() < 0.015, (name, t)
