"""Kernel equivalence tests: the jnp distance, detection and null-vector
paths vs NumPy brute force / float64 oracles — the reference repo's
scalar-vs-SSE4 equivalence pattern (computeSAD8_unittest.cpp:61-76).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rso.kernels import (
    hamming_matrix_jnp,
    sad_matrix_jnp,
    windowed_sad_search,
)
from rso.frontend.detect import extract_patches


@pytest.fixture(scope="module")
def patches(rng):
    a = rng.integers(0, 255, (256, 64)).astype(np.float32)
    b = rng.integers(0, 255, (512, 64)).astype(np.float32)
    return jnp.asarray(a), jnp.asarray(b)


@pytest.fixture(scope="module")
def descs(rng):
    a = rng.integers(0, 2**32, (256, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (512, 8), dtype=np.uint32)
    return jnp.asarray(a), jnp.asarray(b)


class TestDistanceKernels:
    @pytest.mark.parametrize("kind,ka,kb", [
        ("sad", 100, 200),       # non-square
        ("sad", 257, 131),       # prime K on both sides
        ("hamming", 256, 512),   # non-square
        ("hamming", 131, 131),   # self-distance, prime K
    ])
    def test_matches_numpy_brute_force(self, rng, kind, ka, kb):
        if kind == "sad":
            a = rng.integers(0, 256, (ka, 64)).astype(np.float32)
            b = rng.integers(0, 256, (kb, 64)).astype(np.float32)
            out = np.asarray(sad_matrix_jnp(jnp.asarray(a), jnp.asarray(b)))
            ref = np.abs(a[:, None, :] - b[None, :, :]).sum(-1)
        else:
            a = rng.integers(0, 2**32, (ka, 8), dtype=np.uint32)
            b = a if ka == kb else rng.integers(0, 2**32, (kb, 8),
                                                dtype=np.uint32)
            out = np.asarray(hamming_matrix_jnp(jnp.asarray(a),
                                                jnp.asarray(b)))
            x = a[:, None, :] ^ b[None, :, :]
            ref = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            if ka == kb:
                np.testing.assert_array_equal(np.diag(out), 0.0)
        assert out.shape == (ka, kb)
        np.testing.assert_array_equal(out, ref.astype(np.float32))

    def test_mxu_distance_ranking_matches_sad(self, rng):
        """The MXU squared-L2 formulation must pick the same best match as
        exact SAD for nearly all slots on realistic patch data (noisy shifted
        copies — the regime tracking actually operates in)."""
        from rso.kernels.distance import sad_matrix_mxu

        base = rng.normal(128, 40, (256, 64)).astype(np.float32)
        # b contains a noisy copy of each a row (true matches) + distractors
        noise = rng.normal(0, 8, base.shape).astype(np.float32)
        b = np.concatenate([base + noise,
                            rng.normal(128, 40, (256, 64))]).astype(np.float32)
        Dsad = np.asarray(sad_matrix_jnp(jnp.asarray(base), jnp.asarray(b)))
        Dmxu = np.asarray(sad_matrix_mxu(jnp.asarray(base), jnp.asarray(b)))
        agree = np.mean(Dsad.argmin(1) == Dmxu.argmin(1))
        assert agree > 0.98
        # scale calibration: on Gaussian residuals the mapped values track
        # the true SADs (moment relation sqrt(SSD * P * 2/pi))
        true_idx = np.arange(256)
        ratio = Dmxu[true_idx, true_idx] / np.maximum(
            Dsad[true_idx, true_idx], 1e-6)
        assert 0.8 < np.median(ratio) < 1.25

    def test_shortlist_match_equals_dense(self, rng):
        """stereo match via the coarse-to-fine MXU shortlist must agree with
        the dense exact-SAD path on almost every slot."""
        import jax.numpy as jnp

        from rso.config import LeftRightMatchParams
        from rso.frontend.detect import Features
        from rso.frontend.stereo_match import match_left_right

        K = 256
        W = 640
        xy_l = np.stack([rng.uniform(20, W - 20, K),
                         rng.uniform(10, 230, K)], -1).astype(np.float32)
        disp = rng.uniform(5, 60, K).astype(np.float32)
        xy_r = xy_l - np.stack([disp, np.zeros(K, np.float32)], -1)
        base = rng.normal(128, 40, (K, 64)).astype(np.float32)

        def feats(xy, patch):
            return Features(xy=jnp.asarray(xy),
                            response=jnp.ones((K,), jnp.float32),
                            valid=jnp.ones((K,), bool),
                            desc=jnp.zeros((K, 8), jnp.uint32),
                            patch=jnp.asarray(patch))

        fl = feats(xy_l, base)
        fr = feats(xy_r, base + rng.normal(0, 2, base.shape).astype(np.float32))
        params = LeftRightMatchParams()
        m_dense = match_left_right(fl, fr, params, W, 0.0, use_mxu=False)
        m_short = match_left_right(fl, fr, params, W, 0.0, use_mxu=True)
        agree = np.mean(np.asarray(m_dense.ridx) == np.asarray(m_short.ridx))
        assert agree > 0.97
        assert int(np.asarray(m_short.valid).sum()) > K * 0.5

    def test_mxu_distance_zero_diag(self, patches):
        from rso.kernels.distance import sad_matrix_mxu

        a, _ = patches
        out = np.asarray(sad_matrix_mxu(a, a))
        assert np.all(np.abs(np.diag(out)) < 1e-1)

    def test_sad_reference_scalar_oracle(self, rng):
        """Check one entry against a plain python double loop (the scalar
        oracle the reference's compute_SAD8_default implements)."""
        a = rng.integers(0, 255, (4, 64)).astype(np.float32)
        b = rng.integers(0, 255, (4, 64)).astype(np.float32)
        out = np.asarray(sad_matrix_jnp(jnp.asarray(a), jnp.asarray(b)))
        for i in range(4):
            for j in range(4):
                expect = float(np.abs(a[i] - b[j]).sum())
                assert out[i, j] == pytest.approx(expect, rel=1e-6)


class TestWindowedSearch:
    def test_recovers_known_offset(self, rng):
        """Property of the reference's trackingSAD test (trackSAD_unittest):
        the template must be found at its true location."""
        img = jnp.asarray(rng.integers(0, 255, (120, 160)).astype(np.float32))
        # template = the true 8x8 patch at (x,y); search centered nearby
        true_xy = jnp.asarray([[80.0, 60.0], [40.0, 30.0], [100.0, 90.0]])
        templates = extract_patches(img, true_xy)
        centers = true_xy + jnp.asarray([[5.0, -3.0], [-6.0, 4.0], [0.0, 7.0]])
        res = windowed_sad_search(img, templates, centers, win_x=8, win_y=8)
        np.testing.assert_allclose(np.asarray(res.best_xy),
                                   np.asarray(true_xy), atol=0.5)
        np.testing.assert_allclose(np.asarray(res.best_sad), 0.0, atol=1e-3)

    def test_masked_slots(self, rng):
        img = jnp.asarray(rng.integers(0, 255, (64, 64)).astype(np.float32))
        templates = jnp.zeros((2, 64))
        centers = jnp.asarray([[32.0, 32.0], [20.0, 20.0]])
        valid = jnp.asarray([True, False])
        res = windowed_sad_search(img, templates, centers, 4, 4, valid)
        assert np.asarray(res.best_sad)[1] > 1e30


class TestDetectXLA:
    """The dense detector passes vs NumPy oracles (interior pixels; the
    jnp forms wrap at the border, which the engine's margin masks)."""

    def _img(self):
        from rso.synthetic import make_sequence

        seq = make_sequence(n_frames=1, n_points=800, H=120, W=160)
        return np.asarray(seq.frames[0][0], np.float32)

    def test_shi_tomasi_matches_numpy_structure_tensor(self):
        from rso.frontend.detect import shi_tomasi_response

        img, win = self._img(), 4
        out = np.asarray(shi_tomasi_response(jnp.asarray(img), win))
        H, W = img.shape
        gx = np.zeros_like(img, np.float64)
        gy = np.zeros_like(img, np.float64)
        gx[:, 1:-1] = (img[:, 2:].astype(np.float64) - img[:, :-2]) * 0.5
        gy[1:-1, :] = (img[2:, :].astype(np.float64) - img[:-2, :]) * 0.5
        m = win + 1
        n = (2 * win + 1) ** 2
        for y in range(m, H - m, 7):
            for x in range(m, W - m, 5):
                sl = np.s_[y - win:y + win + 1, x - win:x + win + 1]
                a = (gx[sl] ** 2).sum() / n
                c = (gy[sl] ** 2).sum() / n
                b = (gx[sl] * gy[sl]).sum() / n
                lam_min = np.linalg.eigvalsh([[a, b], [b, c]])[0]
                assert out[y, x] == pytest.approx(lam_min, rel=1e-4,
                                                  abs=1e-3)

    @pytest.mark.parametrize("arc", [9, 12])
    def test_fast_mask_matches_numpy_segment_test(self, arc):
        from rso.frontend.detect import _FAST_OFFSETS, fast_corner_mask

        img = self._img()
        H, W = img.shape
        for th in (10.0, 25.0):
            out = np.asarray(fast_corner_mask(jnp.asarray(img),
                                              jnp.float32(th), arc=arc))
            ref = np.zeros_like(out)
            for y in range(3, H - 3):
                for x in range(3, W - 3):
                    ring = np.array([img[y + dy, x + dx]
                                     for dx, dy in _FAST_OFFSETS])
                    for flags in (ring > img[y, x] + th,
                                  ring < img[y, x] - th):
                        run = best = 0
                        for f in np.concatenate([flags, flags]):
                            run = run + 1 if f else 0
                            best = max(best, run)
                        if min(best, 16) >= arc:
                            ref[y, x] = True
            np.testing.assert_array_equal(out, ref)
            assert ref.sum() > 0


class TestNullvec9:
    """The RANSAC 9x9 null-vector solve vs a float64 eigh oracle."""

    def _rank8(self, rng, B):
        # M = A^T A from 8 random rows, like a RANSAC hypothesis design matrix
        A = rng.normal(0, 1, (B, 8, 9)).astype(np.float32)
        return jnp.asarray(np.einsum("bki,bkj->bij", A, A))

    def _eigh_null(self, M):
        _, V = np.linalg.eigh(np.asarray(M, np.float64))
        return V[..., :, 0]

    def test_matches_jnp_reference(self, rng):
        from rso.kernels.smallchol import nullvec9

        M = self._rank8(rng, 96)
        out = np.asarray(nullvec9(M))
        ref = self._eigh_null(M)
        # unit norm, and same direction up to sign
        np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                   atol=1e-4)
        cos = np.abs(np.sum(ref * out, axis=1))
        assert cos.min() > 1.0 - 1e-3

    def test_null_direction_quality(self, rng):
        from rso.kernels.smallchol import nullvec9

        M = self._rank8(rng, 64)
        x = np.asarray(nullvec9(M))
        # residual M x should be tiny relative to ||M||
        r = np.einsum("bij,bj->bi", np.asarray(M), x)
        rel = np.linalg.norm(r, axis=1) / np.trace(
            np.asarray(M), axis1=1, axis2=2)
        assert rel.max() < 1e-3

    def test_degenerate_inputs_finite(self, rng):
        from rso.kernels.smallchol import nullvec9

        # rank-deficient beyond the structural null (duplicate sample rows)
        A = rng.normal(0, 1, (32, 8, 9)).astype(np.float32)
        A[:, 4:] = A[:, :4]  # rank 4
        M = jnp.asarray(np.einsum("bki,bkj->bij", A, A))
        M = jnp.concatenate([M, jnp.zeros((8, 9, 9), jnp.float32)])  # + zeros
        x = np.asarray(nullvec9(M))
        assert np.all(np.isfinite(x))
        np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-3)


class TestExactSadOddK:
    """The stage-3/4 exact-SAD cores (kernels.distance) vs NumPy brute force
    at K with no power-of-two factor (e.g. prime K from an odd user
    k_max)."""

    def _numpy_stereo(self, pl_, pr_, xy_l, xy_r, ok_l, ok_r,
                      max_y_diff, max_disp, max_distance):
        D = np.abs(pl_[:, None, :] - pr_[None, :, :]).sum(-1)
        dy = np.abs(np.round(xy_l[:, 1])[:, None]
                    - np.round(xy_r[:, 1])[None, :])
        disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
        ok = (ok_l[:, None] & ok_r[None, :] & (dy <= max_y_diff)
              & (disp >= 1.0) & (disp <= max_disp) & (D <= max_distance))
        Dm = np.where(ok, D, 1e9)
        best_r = Dm.argmin(1)
        best_d = Dm.min(1)
        D2 = Dm.copy()
        D2[np.arange(len(best_r)), best_r] = 1e9
        return best_r, best_d, D2.min(1)

    def test_stereo_prime_k(self, rng):
        from rso.kernels.distance import stereo_sad_best

        K = 257
        pl_ = rng.integers(0, 255, (K, 64)).astype(np.float32)
        pr_ = rng.integers(0, 255, (K, 64)).astype(np.float32)
        xy_l = rng.uniform(10, 300, (K, 2)).astype(np.float32)
        xy_r = xy_l - np.stack([rng.uniform(2, 40, K),
                                rng.uniform(-0.4, 0.4, K)],
                               -1).astype(np.float32)
        ok_l = rng.random(K) > 0.1
        ok_r = rng.random(K) > 0.1
        br, bd, sd = stereo_sad_best(
            jnp.asarray(pl_), jnp.asarray(pr_), jnp.asarray(xy_l),
            jnp.asarray(xy_r), jnp.asarray(ok_l), jnp.asarray(ok_r),
            max_y_diff=1.0, max_disp=100.0, max_distance=6000.0)
        ref_r, ref_d, ref_s = self._numpy_stereo(pl_, pr_, xy_l, xy_r, ok_l,
                                                 ok_r, 1.0, 100.0, 6000.0)
        assert br.shape == (K,) and bd.shape == (K,) and sd.shape == (K,)
        hit = ref_d < 1e9
        assert hit.sum() > 10
        np.testing.assert_array_equal(np.asarray(br)[hit], ref_r[hit])
        np.testing.assert_array_equal(np.asarray(bd), ref_d)
        np.testing.assert_array_equal(np.asarray(sd), ref_s)

    def test_track_prime_k(self, rng):
        from rso.kernels.distance import track_sad_best

        K = 131
        pats = [rng.integers(0, 255, (K, 64)).astype(np.float32)
                for _ in range(4)]
        p_xy = rng.uniform(20, 200, (K, 2)).astype(np.float32)
        c_xy = (p_xy + rng.uniform(-3, 3, (K, 2))).astype(np.float32)
        p_rx = (p_xy[:, 0] - rng.uniform(2, 30, K)).astype(np.float32)
        c_rx = (c_xy[:, 0] - rng.uniform(2, 30, K)).astype(np.float32)
        ok_p = rng.random(K) > 0.15
        ok_c = rng.random(K) > 0.15
        bc, bd = track_sad_best(
            *(jnp.asarray(p) for p in pats), jnp.asarray(p_xy),
            jnp.asarray(c_xy), jnp.asarray(p_rx), jnp.asarray(c_rx),
            jnp.asarray(ok_p), jnp.asarray(ok_c),
            win_row=8.0, win_col=16.0, sad_max=8000.0)
        acc_l = np.abs(pats[0][:, None, :] - pats[1][None, :, :]).sum(-1)
        acc_r = np.abs(pats[2][:, None, :] - pats[3][None, :, :]).sum(-1)
        dy = np.abs(p_xy[:, 1][:, None] - c_xy[:, 1][None, :])
        dxl = np.abs(p_xy[:, 0][:, None] - c_xy[:, 0][None, :])
        dxr = np.abs(p_rx[:, None] - c_rx[None, :])
        ok = (ok_p[:, None] & ok_c[None, :] & (dy <= 8.0) & (dxl <= 16.0)
              & (dxr <= 16.0) & (acc_l <= 8000.0) & (acc_r <= 8000.0))
        Dm = np.where(ok, acc_l + acc_r, 1e9)
        hit = Dm.min(1) < 1e9
        assert bc.shape == (K,) and bd.shape == (K,)
        assert hit.sum() > 10
        np.testing.assert_array_equal(np.asarray(bc)[hit], Dm.argmin(1)[hit])
        np.testing.assert_array_equal(np.asarray(bd), Dm.min(1))
