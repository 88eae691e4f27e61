"""Frontend tests: detection properties, stereo matching and tracking
correctness on synthetic imagery (the reference's real-image property-test
pattern, computeSAD8_unittest.cpp, applied to generated fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rso.config import RSOConfig, StereoMatchMethod
from rso.frontend.detect import (
    detect_features,
    extract_patches,
    fast_corner_mask,
    nms_grid,
    octave_budget,
    orb_descriptors,
    shi_tomasi_response,
)
from rso.frontend.pyramid import build_pyramid, downsample2x, to_grayscale
from rso.frontend.stereo_match import (
    hamming_matrix,
    match_left_right,
    sad_matrix,
)
from rso.frontend.track import track_interframe
from rso.synthetic import make_sequence, synthetic_config


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=3, n_points=1500)


@pytest.fixture(scope="module")
def cfg():
    return synthetic_config()


class TestPyramid:
    def test_grayscale_shapes(self):
        img = np.random.default_rng(0).integers(0, 255, (64, 96, 3), dtype=np.uint8)
        g = to_grayscale(jnp.asarray(img))
        assert g.shape == (64, 96) and g.dtype == jnp.float32

    def test_downsample(self):
        img = jnp.ones((64, 96), jnp.float32) * 7.0
        d = downsample2x(img)
        assert d.shape == (32, 48)
        np.testing.assert_allclose(d, 7.0)

    def test_pyramid_octaves(self):
        img = jnp.zeros((240, 376), jnp.float32)
        pyr = build_pyramid(img, 3)
        assert [p.shape for p in pyr] == [(240, 376), (120, 188), (60, 94)]


class TestDetect:
    def test_fast_fires_on_blobs(self, seq):
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        mask = fast_corner_mask(img, jnp.int32(20))
        assert int(mask.sum()) > 50

    def test_fast_silent_on_flat(self):
        img = jnp.full((100, 100), 77.0)
        assert int(fast_corner_mask(img, jnp.int32(10)).sum()) == 0

    def test_response_peak_on_corner(self):
        """Shi-Tomasi response must peak at an L-corner."""
        img = np.zeros((64, 64), np.float32)
        img[32:, 32:] = 200.0
        r = shi_tomasi_response(jnp.asarray(img), 4)
        peak = np.unravel_index(np.argmax(np.asarray(r)), r.shape)
        assert abs(peak[0] - 32) <= 3 and abs(peak[1] - 32) <= 3

    def test_nms_suppresses_neighbors(self):
        resp = jnp.zeros((32, 32)).at[10, 10].set(5.0).at[10, 12].set(4.0)
        keep = nms_grid(resp, 3)
        assert bool(keep[10, 10]) and not bool(keep[10, 12])

    def test_detect_counts_and_validity(self, seq, cfg):
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        f = detect_features(img, cfg.detect, 512, jnp.int32(20), need_desc=False)
        n = int(f.valid.sum())
        assert 50 < n <= 512
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        assert xy[:, 0].min() >= 4 and xy[:, 1].min() >= 4

    def test_subpixel_coords(self, seq, cfg):
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        f = detect_features(img, cfg.detect, 512, jnp.int32(20), need_desc=False)
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        frac = np.abs(xy - np.round(xy))
        assert (frac > 1e-3).any()  # refinement produced non-integer coords

    def test_detect_bf16_agrees_with_f32(self, seq, cfg):
        """detect_bf16 (EngineParams) must keep f32 output dtypes and find
        essentially the same keypoints (rounding only perturbs response
        RANKING near the top-K boundary)."""
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        a = detect_features(img, cfg.detect, 512, jnp.int32(20), need_desc=False)
        b = detect_features(img, cfg.detect, 512, jnp.int32(20),
                            need_desc=False, bf16=True)
        assert b.response.dtype == jnp.float32 and b.xy.dtype == jnp.float32
        pa = np.asarray(a.xy)[np.asarray(a.valid)]
        pb = np.asarray(b.xy)[np.asarray(b.valid)]
        # bf16 rounding of img+threshold shifts the effective FAST threshold
        # by up to 1 for pixels >= 256, so the candidate set (and hence the
        # top-K tail) differs; the contract is that the STRONG f32 keypoints
        # survive, up to +-1px NMS-winner flips
        ra = np.asarray(a.response)[np.asarray(a.valid)]
        strong = pa[ra >= np.median(ra)]
        d = np.linalg.norm(strong[:, None, :] - pb[None, :, :], axis=-1)
        near = (d.min(axis=1) <= 1.5).mean()
        assert near > 0.85, near

    def test_octave_budget_matches_reference_formula(self):
        # reference stage2_detect.cpp:405-407 with nfeats=500, 3 octaves
        b = octave_budget(500, 3)
        assert b[0] == int(500 * 6 / 7)
        assert b[1] == round(b[0] / 2)
        assert b[2] == round(b[0] / 4)

    def test_orb_level_budgets_small_k(self):
        """Small k_slots must not produce zero/negative level budgets
        (ADVICE r2: max(8,...) + remainder dump made ks[0] <= 0 for
        orb_nfeats ~40-70 with the default 8 levels)."""
        from rso.frontend.detect import _orb_level_budgets

        for k in (1, 2, 5, 8, 40, 70, 128, 500):
            for nl in (1, 2, 4, 8):
                ks = _orb_level_budgets(k, nl)
                assert sum(ks) == k, (k, nl, ks)
                assert all(b >= 1 for b in ks), (k, nl, ks)

    def test_orb_multilevel_tiny_budget_traces(self, seq):
        """_detect_orb_multilevel with a tiny slot count must trace and run
        (used to crash select_topk with k<=0 at trace time)."""
        import dataclasses

        from rso.config import DetectMethod
        from rso.synthetic import synthetic_config

        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        dp = dataclasses.replace(synthetic_config().detect,
                                 detect_method=DetectMethod.ORB,
                                 orb_nlevels=8)
        f = detect_features(img, dp, 40, jnp.int32(20), need_desc=True)
        assert f.xy.shape[0] == 40
        assert bool(f.valid.any())

    def test_descriptors_deterministic_and_discriminative(self, seq, cfg):
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        f = detect_features(img, cfg.detect, 128, jnp.int32(20), need_desc=True)
        d1 = orb_descriptors(img, f.xy)
        d2 = orb_descriptors(img, f.xy)
        np.testing.assert_array_equal(d1, d2)
        v = np.asarray(f.valid)
        H = np.asarray(hamming_matrix(f.desc, f.desc))
        np.testing.assert_allclose(np.diag(H), 0)
        off = H[np.ix_(v, v)] + np.eye(v.sum()) * 999
        assert off.min() > 10  # distinct features have distant descriptors


class TestSAD:
    def test_sad_local_minimum_property(self, seq):
        """The reference's core property test (computeSAD8_unittest.cpp:20-41):
        SAD at the true correspondence is a strict local minimum vs shifted
        patches."""
        img = jnp.asarray(seq.frames[0][0], jnp.float32)
        xy = jnp.asarray([[100.0, 120.0]])
        p0 = extract_patches(img, xy)
        sads = {}
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                p = extract_patches(img, xy + jnp.asarray([[dx, dy]]))
                sads[(dx, dy)] = float(sad_matrix(p0, p)[0, 0])
        assert sads[(0, 0)] == 0.0
        for k, v in sads.items():
            if k != (0, 0):
                assert v > 0.0

    def test_hamming_basics(self):
        a = jnp.asarray([[0b1011, 0, 0, 0, 0, 0, 0, 0]], jnp.uint32)
        b = jnp.asarray([[0b0010, 0, 0, 0, 0, 0, 0, 0]], jnp.uint32)
        assert float(hamming_matrix(a, b)[0, 0]) == 2.0


class TestStereoMatch:
    def test_match_recovers_disparity(self, seq, cfg):
        l, r = seq.frames[0]
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        m = match_left_right(fl, fr, cfg.lr_match, l.shape[1], 0.0)
        n = int(m.valid.sum())
        assert n > 40
        v = np.asarray(m.valid)
        xl = np.asarray(fl.xy)[v]
        xr = np.asarray(fr.xy)[np.asarray(m.ridx)[v]]
        disp = xl[:, 0] - xr[:, 0]
        assert (disp >= 1).all()
        # rounded-row epipolar semantics allow up to max_y_diff + 1 subpixel
        assert np.abs(xl[:, 1] - xr[:, 1]).max() <= 2.0

    def test_one_to_one(self, seq, cfg):
        l, r = seq.frames[0]
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        m = match_left_right(fl, fr, cfg.lr_match, l.shape[1], 0.0)
        ridx = np.asarray(m.ridx)[np.asarray(m.valid)]
        assert len(np.unique(ridx)) == len(ridx)  # no right feature reused

    def test_exact_sad_matches_numpy(self, seq, cfg):
        """Every surviving stereo match carries the exact SAD of its pair,
        and no admissible candidate (NumPy brute force over the stage-3
        masks) has a smaller one."""
        l, r = seq.frames[0]
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        p = cfg.lr_match
        m = match_left_right(fl, fr, p, l.shape[1], 0.0)
        pl_, pr_ = np.asarray(fl.patch), np.asarray(fr.patch)
        xl, xr = np.asarray(fl.xy), np.asarray(fr.xy)
        D = np.abs(pl_[:, None, :] - pr_[None, :, :]).sum(-1)
        disp = xl[:, 0][:, None] - xr[:, 0][None, :]
        ok = (np.asarray(fl.valid)[:, None] & np.asarray(fr.valid)[None, :]
              & (np.abs(np.round(xl[:, 1])[:, None]
                        - np.round(xr[:, 1])[None, :]) <= p.max_y_diff)
              & (disp >= 1.0) & (disp <= 0.7 * l.shape[1])
              & (D <= p.sad_max_distance))
        v = np.asarray(m.valid)
        assert v.sum() > 40
        li = np.nonzero(v)[0]
        ri = np.asarray(m.ridx)[v]
        np.testing.assert_array_equal(np.asarray(m.dist)[v], D[li, ri])
        np.testing.assert_array_equal(D[li, ri],
                                      np.where(ok, D, np.inf)[li].min(1))

    def test_known_shift_recovered_exactly(self, seq, cfg):
        """Right image = left rolled by +5 px: every match must recover
        disparity 5 exactly (the controlled-geometry oracle)."""
        l, _ = seq.frames[0]
        r = np.roll(l, -5, axis=1)  # right eye sees features 5px to the left
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        m = match_left_right(fl, fr, cfg.lr_match, l.shape[1], 0.0)
        assert int(m.valid.sum()) > 100
        v = np.asarray(m.valid)
        disp = (np.asarray(fl.xy)[v, 0]
                - np.asarray(fr.xy)[np.asarray(m.ridx)[v], 0])
        assert np.abs(disp - 5.0).max() < 0.35  # subpixel-exact disparity


class TestTrack:
    def test_tracks_static_scene(self, seq, cfg):
        """Tracking a frame against itself: every stereo match must track to
        itself with zero cost."""
        l, r = seq.frames[0]
        fl = detect_features(jnp.asarray(l, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        fr = detect_features(jnp.asarray(r, jnp.float32), cfg.detect, 512,
                             jnp.int32(20), need_desc=False)
        m = match_left_right(fl, fr, cfg.lr_match, l.shape[1], 0.0)
        trk = track_interframe(fl, fr, m, fl, fr, m, cfg.if_match,
                               jax.random.PRNGKey(0))
        v = np.asarray(m.valid)
        tv = np.asarray(trk.valid)
        assert tv[v].mean() > 0.9
        np.testing.assert_array_equal(
            np.asarray(trk.cur_idx)[tv], np.arange(512)[tv])

    def test_tracks_moving_scene(self, seq, cfg):
        prev_l, prev_r = seq.frames[0]
        cur_l, cur_r = seq.frames[1]
        det = lambda im: detect_features(jnp.asarray(im, jnp.float32),
                                         cfg.detect, 512, jnp.int32(20),
                                         need_desc=False)
        pl, pr, cl, cr = det(prev_l), det(prev_r), det(cur_l), det(cur_r)
        pm = match_left_right(pl, pr, cfg.lr_match, prev_l.shape[1], 0.0)
        cm = match_left_right(cl, cr, cfg.lr_match, cur_l.shape[1], 0.0)
        trk = track_interframe(pl, pr, pm, cl, cr, cm, cfg.if_match,
                               jax.random.PRNGKey(0))
        assert int(trk.n_tracked) > 30

    def test_exact_sad_track_matches_numpy(self, seq, cfg):
        """Every tracked pair minimizes the both-eye exact SAD over the
        admissible window candidates (NumPy brute force)."""
        prev_l, prev_r = seq.frames[0]
        cur_l, cur_r = seq.frames[1]
        det = lambda im: detect_features(jnp.asarray(im, jnp.float32),
                                         cfg.detect, 512, jnp.int32(20),
                                         need_desc=False)
        pl, pr, cl, cr = det(prev_l), det(prev_r), det(cur_l), det(cur_r)
        pm = match_left_right(pl, pr, cfg.lr_match, prev_l.shape[1], 0.0)
        cm = match_left_right(cl, cr, cfg.lr_match, cur_l.shape[1], 0.0)
        q = cfg.if_match
        trk = track_interframe(pl, pr, pm, cl, cr, cm, q,
                               jax.random.PRNGKey(0))
        n = lambda x: np.asarray(x)
        pri, cri = np.maximum(n(pm.ridx), 0), np.maximum(n(cm.ridx), 0)
        sl = np.abs(n(pl.patch)[:, None] - n(cl.patch)[None]).sum(-1)
        sr = np.abs(n(pr.patch)[pri][:, None]
                    - n(cr.patch)[cri][None]).sum(-1)
        pxy, cxy = n(pl.xy), n(cl.xy)
        prx, crx = n(pr.xy)[pri, 0], n(cr.xy)[cri, 0]
        ok = (n(pm.valid)[:, None] & n(cm.valid)[None, :]
              & (np.abs(pxy[:, 1][:, None] - cxy[:, 1][None]) <= q.ifm_win_w)
              & (np.abs(pxy[:, 0][:, None] - cxy[:, 0][None]) <= q.ifm_win_h)
              & (np.abs(prx[:, None] - crx[None]) <= q.ifm_win_h)
              & (sl <= q.sad_max_distance) & (sr <= q.sad_max_distance))
        cost = np.where(ok, sl + sr, np.inf)
        v = n(trk.valid)
        assert v.sum() > 30
        pi, ci = np.nonzero(v)[0], n(trk.cur_idx)[v]
        np.testing.assert_array_equal(cost[pi, ci], cost[pi].min(1))


class TestRefine:
    """refine_positions: translation-only inverse-compositional LK on stored
    8x8 templates (patch-based formulation; docs/FLOW_SCAN_FAULT.md)."""

    def _scene(self, seed=0):
        rng = np.random.default_rng(seed)
        img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
        # smooth so subpixel interpolation is meaningful
        k = np.array([0.25, 0.5, 0.25])
        for ax in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), ax, img)
        return jnp.asarray(img)

    def _template(self, img, x, y):
        """8x8 bilinear patch at subpixel center (x,y), offsets -3..+4."""
        dy, dx = np.mgrid[-3:5, -3:5]
        xs, ys = x + dx.ravel(), y + dy.ravel()
        x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
        fx, fy = xs - x0, ys - y0
        a = np.asarray(img)
        v = (a[y0, x0] * (1 - fy) * (1 - fx) + a[y0, x0 + 1] * (1 - fy) * fx
             + a[y0 + 1, x0] * fy * (1 - fx) + a[y0 + 1, x0 + 1] * fy * fx)
        return v.astype(np.float32)

    def test_recovers_subpixel_shift(self):
        from rso.frontend.refine import refine_positions

        img = self._scene()
        true = np.array([[50.3, 40.7], [80.6, 60.2], [30.4, 90.8]], np.float32)
        temps = jnp.asarray(np.stack([self._template(img, x, y)
                                      for x, y in true]))
        start = jnp.asarray(true + np.array([[0.8, -0.6], [-0.7, 0.9],
                                             [0.5, 0.5]], np.float32))
        out = refine_positions(img, temps, start, jnp.ones(3, bool), iters=5)
        err = np.abs(np.asarray(out) - true)
        assert err.max() < 0.15, err

    def test_invalid_and_flat_pass_through(self):
        from rso.frontend.refine import refine_positions

        img = jnp.full((64, 64), 100.0)
        temps = jnp.full((2, 64), 100.0)
        xy = jnp.asarray([[20.0, 20.0], [40.0, 40.0]])
        out = refine_positions(img, temps, xy, jnp.asarray([True, False]))
        # flat template -> singular normal matrix -> no update; invalid -> none
        np.testing.assert_allclose(np.asarray(out), np.asarray(xy))


class TestFastI16:
    def test_i16_segment_test_bit_exact(self, seq, cfg):
        """EngineParams.fast_i16: the x16 int16 FAST comparison must be
        bit-identical to the f32 path on every pyramid octave (u8 pixels
        and 2x2-avg values are multiples of 1/16)."""
        from rso.frontend.pyramid import build_pyramid

        l, _ = seq.frames[0]
        pyr = build_pyramid(jnp.asarray(l, jnp.float32), 3)
        for img in pyr:
            a = detect_features(img, cfg.detect, 256, jnp.int32(20), False,
                                fast_i16=False)
            b = detect_features(img, cfg.detect, 256, jnp.int32(20), False,
                                fast_i16=True)
            np.testing.assert_array_equal(np.asarray(a.valid),
                                          np.asarray(b.valid))
            np.testing.assert_array_equal(np.asarray(a.xy),
                                          np.asarray(b.xy))
            np.testing.assert_array_equal(np.asarray(a.response),
                                          np.asarray(b.response))
