"""The platform check, the compile cache, and the step on a card
(`gpu`-marked tests skip on a CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rso import device


class TestPlatform:
    @pytest.mark.parametrize("name,ok", [("gpu", True), ("cpu", True),
                                         ("rocm", False)])
    def test_supported_platforms(self, monkeypatch, name, ok):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        if ok:
            assert device.platform() == name
        else:
            with pytest.raises(RuntimeError, match="not 'rocm'"):
                device.platform()

    def test_make_step_refuses_unknown_platform(self, monkeypatch):
        from rso.engine import make_step
        from rso.synthetic import make_sequence, synthetic_config

        cam = make_sequence(n_frames=1, n_points=10, H=64, W=96).cam
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError):
            make_step(synthetic_config(), cam, 64, 96)

    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(SystemExit, match="no GPU"):
            device.require_gpu()


class TestCompileCache:
    def test_env_var_is_honoured(self, monkeypatch, tmp_path):
        from rso import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_default_in_checkout(self, monkeypatch):
        from rso import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            path = compile_cache.enable()
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("K", [512, 256, 128, 203])
    def test_exact_sad_core_matches_numpy(self, gpu, rng, K):
        """Stage-3 exact SAD on the card vs NumPy: SADs of u8 patches are
        exact in f32, so distances are bit-equal and ties resolve to the
        lowest index in both."""
        from rso.kernels.distance import stereo_sad_best

        pl_ = rng.integers(0, 256, (K, 64)).astype(np.float32)
        pr_ = rng.integers(0, 256, (K, 64)).astype(np.float32)
        xy_l = np.stack([rng.uniform(10, 600, K),
                         rng.integers(0, 8, K)], -1).astype(np.float32)
        xy_r = xy_l - np.stack([rng.uniform(-20, 300, K),
                                rng.uniform(-0.6, 0.6, K)],
                               -1).astype(np.float32)
        ok_l, ok_r = rng.random(K) > 0.1, rng.random(K) > 0.1
        kw = dict(max_y_diff=1.0, max_disp=400.0, max_distance=7000.0)
        br, bd, _ = jax.jit(lambda *a: stereo_sad_best(*a, **kw))(
            *(jnp.asarray(a) for a in (pl_, pr_, xy_l, xy_r, ok_l, ok_r)))
        D = np.abs(pl_[:, None, :] - pr_[None, :, :]).sum(-1)
        disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
        ok = (ok_l[:, None] & ok_r[None, :]
              & (np.abs(np.round(xy_l[:, 1])[:, None]
                        - np.round(xy_r[:, 1])[None, :]) <= 1.0)
              & (disp >= 1.0) & (disp <= 400.0) & (D <= 7000.0))
        Dm = np.where(ok, D, 1e9)
        np.testing.assert_array_equal(np.asarray(bd), Dm.min(1))
        hit = Dm.min(1) < 1e9
        np.testing.assert_array_equal(np.asarray(br)[hit], Dm.argmin(1)[hit])

    def test_engine_runs_on_card(self, gpu):
        from rso.engine import Engine
        from rso.synthetic import make_sequence, synthetic_config

        seq = make_sequence(n_frames=4, n_points=1200, H=128, W=256)
        eng = Engine(synthetic_config(), seq.cam)
        for l, r in seq.frames:
            res = eng.process_frame(l, r)
        assert bool(res.valid)
        assert np.all(np.isfinite(np.asarray(res.pose)))
