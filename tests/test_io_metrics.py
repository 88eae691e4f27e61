"""IO + metrics tests: calib parsing, trajectory round-trips, checkpoint
resume exactness, ATE/RPE math, config INI loading, profiler."""
import os

import numpy as np
import pytest

from rso.config import (
    DetectMethod,
    RSOConfig,
    StereoMatchMethod,
    load_config,
)
from rso.io.calib import load_kitti_calib
from rso.io.checkpoint import load_state, save_state
from rso.io.trajectory import (
    integrate_relative,
    read_kitti,
    read_tum,
    write_kitti,
    write_tum,
)
from rso.metrics.ate import ate_rmse, rpe
from rso.metrics.logging import error_name
from rso.metrics.profiler import SpanProfiler


class TestCalib:
    def test_kitti_calib(self, tmp_path):
        p = tmp_path / "calib.txt"
        fx, cx, cy, b = 718.856, 607.1928, 185.2157, 0.5371657
        P0 = f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0"
        P1 = f"P1: {fx} 0 {cx} {-fx*b} 0 {fx} {cy} 0 0 0 1 0"
        p.write_text(P0 + "\n" + P1 + "\n")
        cam = load_kitti_calib(str(p))
        assert abs(float(cam.fx_l) - fx) < 1e-3
        assert abs(float(cam.baseline) - b) < 1e-5

    def test_rectify_maps_identity_for_aligned_rig(self):
        """A perfectly aligned rig must yield (nearly) identity remap."""
        from rso.io.calib import FullCalibration, compute_rectify_maps

        K = np.array([[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]])
        calib = FullCalibration(
            K_l=K, K_r=K, dist_l=np.zeros(5), dist_r=np.zeros(5),
            R_lr=np.eye(3), t_lr=np.array([0.2, 0.0, 0.0]), size=(96, 128))
        cam, (mlx, mly), (mrx, mry) = compute_rectify_maps(calib)
        ys, xs = np.mgrid[0:96, 0:128]
        # maps should be close to identity (shared intrinsics recentered)
        assert np.abs(mlx - xs).max() < 1.0
        assert np.abs(mly - ys).max() < 1.0
        assert abs(float(cam.baseline) - 0.2) < 1e-6


class TestTrajectory:
    def _traj(self, n=20):
        rels = []
        from rso.geometry import pose_matrix
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        for _ in range(n):
            rels.append(np.asarray(pose_matrix(jnp.asarray(
                rng.normal(0, 0.05, 6), jnp.float32))))
        return integrate_relative(rels)

    def test_kitti_roundtrip(self, tmp_path):
        poses = self._traj()
        f = str(tmp_path / "t.txt")
        write_kitti(f, poses)
        back = read_kitti(f)
        np.testing.assert_allclose(back, poses, atol=1e-6)

    def test_tum_roundtrip(self, tmp_path):
        poses = self._traj()
        f = str(tmp_path / "t.txt")
        write_tum(f, poses)
        ts, back = read_tum(f)
        np.testing.assert_allclose(back[:, :3, 3], poses[:, :3, 3], atol=1e-5)
        np.testing.assert_allclose(back[:, :3, :3], poses[:, :3, :3], atol=1e-4)


class TestATE:
    def test_zero_error(self):
        poses = np.tile(np.eye(4), (10, 1, 1))
        poses[:, 2, 3] = np.arange(10)
        assert ate_rmse(poses, poses) < 1e-9
        rt, rr = rpe(poses, poses)
        assert rt < 1e-9 and rr < 1e-6

    def test_alignment_invariance(self):
        """ATE must be invariant to a rigid transform of the whole estimate."""
        rng = np.random.default_rng(0)
        gt = np.tile(np.eye(4), (30, 1, 1))
        gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (30, 3)), axis=0)
        from scipy.spatial.transform import Rotation

        R = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [5, -2, 3]
        est = np.einsum("ij,njk->nik", T, gt)
        assert ate_rmse(est, gt) < 1e-6

    def test_known_offset(self):
        gt = np.tile(np.eye(4), (10, 1, 1))
        gt[:, 0, 3] = np.arange(10)
        est = gt.copy()
        est[5, 1, 3] += 1.0  # one pose off by 1m laterally
        err = ate_rmse(est, gt, align=False)
        assert abs(err - np.sqrt(1.0 / 10)) < 1e-6


class TestCheckpoint:
    def test_exact_resume(self, tmp_path):
        from rso.engine import Engine
        from rso.synthetic import make_sequence, synthetic_config

        seq = make_sequence(n_frames=4, n_points=800, H=120, W=160)
        cfg = synthetic_config()
        eng = Engine(cfg, seq.cam)
        eng.process_frame(*seq.frames[0])
        eng.process_frame(*seq.frames[1])
        f = str(tmp_path / "state.npz")
        save_state(f, eng.state)

        eng2 = Engine(cfg, seq.cam)
        eng2.state = load_state(f, cfg)
        r_a = eng.process_frame(*seq.frames[2])
        r_b = eng2.process_frame(*seq.frames[2])
        np.testing.assert_array_equal(np.asarray(r_a.pose), np.asarray(r_b.pose))
        np.testing.assert_array_equal(
            np.asarray(r_a.residuals), np.asarray(r_b.residuals))

    def test_shape_mismatch_rejected(self, tmp_path):
        import dataclasses

        from rso.engine import init_state

        cfg = RSOConfig()
        f = str(tmp_path / "s.npz")
        save_state(f, init_state(cfg))
        other = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                    max_kps_per_octave=128))
        with pytest.raises(ValueError):
            load_state(f, other)


class TestConfig:
    def test_ini_loading(self, tmp_path):
        ini = tmp_path / "cfg.ini"
        ini.write_text("""
[RECTIFY]
nOctaves = 2
[DETECT]
detect_method = 0
orb_nfeats = 300
non_maximal_suppression = true
[MATCH]
match_method = 0
max_y_diff = 2.5
enable_robust_1to1_match = 1
[IF-MATCH]
if_match_method = 0
window_width = 31
[LEAST_SQUARES]
initial_max_iters = 7
kernel_param = 2.5
use_robust_kernel = true
[GUI]
show_gui = false
[GENERAL]
vo_use_matches_ids = true
vo_out_dir = /tmp/x
""")
        cfg = load_config(str(ini))
        assert cfg.rectify.nOctaves == 2
        assert cfg.detect.detect_method == DetectMethod.ORB
        assert cfg.detect.orb_nfeats == 300
        assert cfg.lr_match.match_method == StereoMatchMethod.DESC_BF
        assert cfg.lr_match.max_y_diff == 2.5
        assert cfg.lr_match.enable_robust_1to1_match is True
        assert cfg.if_match.ifm_win_w == 31
        assert cfg.least_squares.initial_max_iters == 7
        assert cfg.least_squares.kernel_param == 2.5
        assert cfg.general.vo_use_matches_ids is True
        assert cfg.general.vo_out_dir == "/tmp/x"
        # ORB mode forces 1 octave (reference stage1_rectify.cpp:80)
        assert cfg.n_octaves == 1

    def test_defaults_match_reference(self):
        cfg = RSOConfig()
        # reference ctor defaults (stage2_detect.cpp:44-58, stage3:46-57,
        # common.cpp:69-82)
        assert cfg.detect.initial_FAST_threshold == 20
        assert cfg.detect.orb_nfeats == 500
        assert cfg.lr_match.sad_max_distance == 200
        assert cfg.lr_match.sad_max_ratio == 0.5
        assert cfg.least_squares.kernel_param == 3.0
        assert cfg.least_squares.initial_max_iters == 10
        assert cfg.least_squares.max_iters == 100
        assert cfg.least_squares.residual_threshold == 10.0
        assert cfg.least_squares.bad_tracking_th == 5
        assert isinstance(hash(cfg), int)  # static-arg usable under jit

    def test_error_names(self):
        assert error_name(0) == "voecNone"
        assert error_name(1) == "voecBadTracking"
        assert error_name(99).startswith("unknown")

    @pytest.mark.parametrize("preset", ["kitti", "euroc", "malaga"])
    def test_dataset_presets_load_and_run(self, preset):
        """Every shipped preset INI must load and drive the engine end-to-end
        (including the [ENGINE] extension section, e.g. subpixel_track_refine)."""
        import os

        import numpy as np

        from rso.engine import Engine
        from rso.synthetic import make_textured_sequence

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cfg = load_config(os.path.join(root, "configs", f"{preset}.ini"))
        assert cfg.engine.subpixel_track_refine is True  # preset ships it on
        seq = make_textured_sequence(n_frames=3, seed=0)
        eng = Engine(cfg, seq.cam)
        results = [eng.process_frame(l, r) for l, r in seq.frames]
        assert any(bool(r.valid) for r in results[1:]), preset
        assert int(np.asarray(results[1].detected_feats).sum()) > 50


class TestMalagaLoader:
    """load_malaga against the real extract layout (BASELINE.json config #4):
    `<root>/Images/img_CAMERA1_<unix_ts>_left.jpg` pairs, rectified stream,
    published 1024x768 calibration."""

    @staticmethod
    def _tree(root, n=4, drop_right=None, ts0=1261228749.918590):
        from PIL import Image

        img = np.random.default_rng(0).integers(0, 255, (24, 32),
                                                dtype=np.uint8)
        d = root / "Images"
        d.mkdir()
        for i in range(n):
            ts = ts0 + i * 0.05
            Image.fromarray(img).save(d / f"img_CAMERA1_{ts:.6f}_left.jpg")
            if i != drop_right:
                Image.fromarray(img).save(
                    d / f"img_CAMERA1_{ts:.6f}_right.jpg")
        return root

    def test_layout_calib_and_timestamps(self, tmp_path):
        from rso.io.datasets import load_malaga

        self._tree(tmp_path)
        ds = load_malaga(str(tmp_path))           # extract root
        ds2 = load_malaga(str(tmp_path / "Images"))  # images dir directly
        assert len(ds) == len(ds2) == 4
        # published Malaga stereo intrinsics are the default calibration
        assert abs(ds.cam.fx_l - 795.11588) < 1e-4
        assert abs(ds.cam.baseline - 0.1194) < 1e-6
        assert ds.rectify_maps is None  # extracts ship rectified images
        # filename capture clock, rebased to t=0, 20 Hz spacing
        np.testing.assert_allclose(ds.timestamps,
                                   np.arange(4) * 0.05, atol=1e-6)
        f = ds[0]
        assert f.left.shape == (24, 32) and f.left.dtype == np.uint8

    def test_pairing_by_stem_not_position(self, tmp_path):
        """A single missing right eye must skip that one frame, not shift
        every later pair off by one."""
        from rso.io.datasets import load_malaga

        self._tree(tmp_path, n=5, drop_right=1)
        ds = load_malaga(str(tmp_path))
        assert len(ds) == 4
        for lp, rp in zip(ds.left_paths, ds.right_paths):
            assert (os.path.basename(lp).replace("_left", "")
                    == os.path.basename(rp).replace("_right", ""))
        # the dropped stem appears in neither list
        assert not any("918590" not in p or "968590" in p
                       for p in ds.right_paths[:1])

    def test_empty_dir(self, tmp_path):
        from rso.io.datasets import load_malaga

        ds = load_malaga(str(tmp_path))
        assert len(ds) == 0

    def test_demo_cli_malaga_end_to_end(self, tmp_path):
        """`rso-demo --malaga` on a Malaga-layout tree: loader + prefetch +
        engine + trajectory writer (the surface BASELINE.json config #4
        advertises; full-size real-pixel drive in
        tools/real_malaga_drive.py)."""
        from rso.cli import demo

        # bigger-than-minimum frames so the engine finds features; tiny
        # enough to keep the compile fast on CPU
        from PIL import Image

        rng = np.random.default_rng(3)
        img = rng.integers(0, 255, (96, 128), dtype=np.uint8)
        d = tmp_path / "Images"
        d.mkdir()
        for i in range(3):
            ts = 1261228749.9 + i * 0.05
            for eye in ("left", "right"):
                Image.fromarray(img).save(
                    d / f"img_CAMERA1_{ts:.6f}_{eye}.jpg")
        out = tmp_path / "traj.txt"
        rc = demo.main(["--malaga", str(tmp_path), "--frames", "3",
                        "--out", str(out), "--verbosity", "0"])
        assert rc == 0
        T = np.loadtxt(out)
        assert T.shape == (4, 12)  # initial pose + one row per frame


class TestProfiler:
    def test_spans(self):
        p = SpanProfiler()
        with p.span("a"):
            with p.span("b"):
                pass
        p.enter("c")
        p.leave("c")
        s = p.summary()
        assert "a" in s and "b" in s and "c" in s


class TestDemoChunked:
    def test_chunked_cli_matches_per_frame(self, tmp_path):
        """--chunk N (offline scan dispatch) must write the identical
        trajectory to the frame-at-a-time loop: same math, same state
        evolution, only the dispatch granularity differs."""
        import numpy as np

        from rso.cli import demo

        out_pf = tmp_path / "pf.txt"
        out_ch = tmp_path / "ch.txt"
        rc = demo.main(["--synthetic", "--frames", "9", "--out", str(out_pf),
                        "--verbosity", "0"])
        assert rc == 0
        # chunk=4 exercises both the full-chunk path and a short remainder
        rc = demo.main(["--synthetic", "--frames", "9", "--chunk", "4",
                        "--out", str(out_ch), "--verbosity", "0"])
        assert rc == 0
        np.testing.assert_array_equal(np.loadtxt(out_pf), np.loadtxt(out_ch))
