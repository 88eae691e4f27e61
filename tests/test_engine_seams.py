"""Engine seams: precomputed-data injection (reference use_precomputed_data)
and on-device rectification maps."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from rso.config import DetectMethod, IFMatchMethod, StereoMatchMethod
from rso.engine import Engine
from rso.frontend.detect import detect_features
from rso.synthetic import make_sequence, synthetic_config


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=4, n_points=1500, H=160, W=240)


def orb_like_config():
    cfg = synthetic_config()
    return cfg.replace(
        rectify=dataclasses.replace(cfg.rectify, nOctaves=1),
        detect=dataclasses.replace(cfg.detect,
                                   detect_method=DetectMethod.FAST_ORB,
                                   orb_upright=True),
        lr_match=dataclasses.replace(
            cfg.lr_match, match_method=StereoMatchMethod.DESC_RBR,
            orb_max_distance=64.0, max_y_diff=1.5,
            enable_robust_1to1_match=True, use_z_gate=False),
        if_match=dataclasses.replace(
            cfg.if_match, ifm_method=IFMatchMethod.DESC_WIN,
            orb_max_distance=64.0),
    )


class TestPrecomputedSeam:
    def test_injected_features_run_pipeline(self, seq):
        """Inject our own detector's output through the seam: results must
        match the full pipeline's within the same frame."""
        cfg = orb_like_config()
        H, W = seq.frames[0][0].shape

        eng_full = Engine(cfg, seq.cam)
        eng_pre = Engine(cfg, seq.cam)

        n_both_valid = 0
        for i, (l, r) in enumerate(seq.frames[:3]):
            res_full = eng_full.process_frame(l, r)
            # extract the same features the full pipeline detected
            fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect,
                                 cfg.engine.max_kps_per_octave, jnp.int32(20),
                                 need_desc=True)
            fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect,
                                 cfg.engine.max_kps_per_octave, jnp.int32(20),
                                 need_desc=True)
            res_pre = eng_pre.process_precomputed([fl], [fr], img_hw=(H, W))
            np.testing.assert_array_equal(
                np.asarray(res_pre.stereo_matches),
                np.asarray(res_full.stereo_matches))
            assert abs(int(res_pre.tracked_feats_from_last_frame)
                       - int(res_full.tracked_feats_from_last_frame)) <= 2
            if bool(res_pre.valid) and bool(res_full.valid):
                n_both_valid += 1
                np.testing.assert_allclose(np.asarray(res_pre.pose),
                                           np.asarray(res_full.pose),
                                           atol=1e-4)
        assert n_both_valid >= 1

    def test_injected_matches(self, seq):
        """Also inject the stereo matches (skip stage 3)."""
        cfg = orb_like_config()
        H, W = seq.frames[0][0].shape
        eng = Engine(cfg, seq.cam)
        l, r = seq.frames[0]
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect,
                             cfg.engine.max_kps_per_octave, jnp.int32(20), True)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect,
                             cfg.engine.max_kps_per_octave, jnp.int32(20), True)
        li = np.asarray([0, 1, 2, 3, 4])
        ri = np.asarray([0, 1, 2, 3, 4])
        res = eng.process_precomputed([fl], [fr], matches=[(li, ri)],
                                      img_hw=(H, W))
        assert int(np.asarray(res.stereo_matches)[0]) == 5

    def test_optical_flow_mode_rejected(self, seq):
        cfg = orb_like_config()
        cfg = cfg.replace(if_match=dataclasses.replace(
            cfg.if_match, ifm_method=IFMatchMethod.OPTICAL_FLOW))
        eng = Engine(cfg, seq.cam)
        with pytest.raises(ValueError, match="precomputed"):
            eng.process_precomputed([None], [None], img_hw=(160, 240))


class TestRectifyMaps:
    def test_identity_maps_equal_no_maps(self, seq):
        cfg = synthetic_config()
        H, W = seq.frames[0][0].shape
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        maps = ((xs, ys), (xs, ys))

        e1 = Engine(cfg, seq.cam)
        e2 = Engine(cfg, seq.cam, rectify_maps=maps)
        for l, r in seq.frames[:2]:
            r1 = e1.process_frame(l, r)
            r2 = e2.process_frame(l, r)
        np.testing.assert_allclose(np.asarray(r1.pose), np.asarray(r2.pose),
                                   atol=1e-5)

    def test_shift_maps_shift_features(self, seq):
        """A +3px x-shift map must shift detected features by -3px."""
        cfg = synthetic_config()
        H, W = seq.frames[0][0].shape
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        maps = ((xs + 3.0, ys), (xs + 3.0, ys))
        e1 = Engine(cfg, seq.cam)
        e2 = Engine(cfg, seq.cam, rectify_maps=maps)
        l, r = seq.frames[0]
        e1.process_frame(l, r)
        e2.process_frame(l, r)
        xy1 = np.asarray(e1.state.prev.octaves[0].left.xy)
        v1 = np.asarray(e1.state.prev.octaves[0].left.valid)
        xy2 = np.asarray(e2.state.prev.octaves[0].left.xy)
        v2 = np.asarray(e2.state.prev.octaves[0].left.valid)
        # compare mean x of strong features (sets nearly identical)
        assert abs((xy1[v1][:50, 0].mean() - 3.0) - xy2[v2][:50, 0].mean()) < 1.0


class TestUnrectifiedRig:
    def test_rectification_end_to_end(self):
        """Full EuRoC-style path: distorted, misaligned rig -> rectify maps ->
        engine.  Rectification must restore matching and accuracy that the
        naive pinhole assumption loses."""
        from rso.geometry import pose_matrix
        from rso.io.calib import compute_rectify_maps
        from rso.synthetic import make_unrectified_sequence, synthetic_config

        seq, calib = make_unrectified_sequence(
            n_frames=5, n_points=1800,
            dist=(-0.28, 0.07, 0.001, -0.001, 0.0),
            rig_rot=(0.012, 0.02, 0.008))
        cam_rect, map_l, map_r = compute_rectify_maps(calib)

        def run(eng):
            nvalid, errs, nmatch = 0, [], []
            for i, (l, r) in enumerate(seq.frames):
                res = eng.process_frame(l, r)
                nmatch.append(int(np.asarray(res.stereo_matches).sum()))
                if i and bool(res.valid):
                    nvalid += 1
                    M = np.asarray(pose_matrix(res.pose))
                    errs.append(np.linalg.norm(
                        M[:3, 3] - seq.rel_poses[i - 1][:3, 3]))
            return nvalid, (np.mean(errs) if errs else np.inf), np.mean(nmatch)

        nv_r, err_r, m_r = run(Engine(synthetic_config(), cam_rect,
                                      rectify_maps=(map_l, map_r)))
        nv_0, err_0, m_0 = run(Engine(synthetic_config(), seq.cam))

        assert nv_r == 4                 # every trackable frame valid
        assert err_r < 0.06              # accurate through the full remap path
        assert m_r > m_0 * 1.3           # rectification restores matches
        assert err_r < err_0 * 0.5       # and at least halves the error

    def test_rectified_epipolar_alignment(self):
        """Analytic: after rectification the two cameras share image rows."""
        from scipy.spatial.transform import Rotation

        from rso.io.calib import FullCalibration, compute_rectify_maps

        K = np.array([[320.0, 0, 188], [0, 320.0, 120], [0, 0, 1]])
        R_lr = Rotation.from_rotvec([0.012, 0.02, 0.008]).as_matrix()
        calib = FullCalibration(K_l=K, K_r=K, dist_l=np.zeros(5),
                                dist_r=np.zeros(5), R_lr=R_lr,
                                t_lr=np.array([0.4, 0.0, 0.0]),
                                size=(240, 376))
        cam, _, _ = compute_rectify_maps(calib)
        r = Rotation.from_matrix(R_lr).as_rotvec()
        R_h = Rotation.from_rotvec(r / 2).as_matrix()
        t_rect = R_h.T @ calib.t_lr
        e1 = t_rect / np.linalg.norm(t_rect)
        e2 = np.cross([0, 0, 1.0], e1)
        e2 /= np.linalg.norm(e2)
        e3 = np.cross(e1, e2)
        R_align = np.stack([e1, e2, e3])
        R_l = R_align @ R_h.T
        R_r = R_align @ R_h
        rng = np.random.default_rng(1)
        X = np.stack([rng.uniform(-5, 5, 100), rng.uniform(-3, 3, 100),
                      rng.uniform(4, 30, 100)], -1)
        f, cy = float(cam.fx_l), float(cam.cy_l)
        Xl = (R_l @ X.T).T
        vl = f * Xl[:, 1] / Xl[:, 2] + cy
        Xr = (X - calib.t_lr) @ calib.R_lr      # left frame -> right frame
        Xr = (R_r @ Xr.T).T
        vr = f * Xr[:, 1] / Xr[:, 2] + cy
        assert np.abs(vl - vr).max() < 1e-9
