"""Cross-language oracle tests: the native C++ kernels vs the jnp/Pallas
Fixed-shape formulations — the reference repo's scalar-vs-SIMD equivalence pattern
extended across languages."""
import numpy as np
import jax.numpy as jnp
import pytest

from rso import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (native/build.sh)")


@pytest.fixture(scope="module")
def img(rng):
    return rng.integers(0, 255, (120, 160), dtype=np.uint8)


class TestSADOracle:
    def test_sad8_matches_jnp(self, img, rng):
        from rso.frontend.detect import extract_patches
        from rso.kernels import sad_matrix_jnp

        jimg = jnp.asarray(img, jnp.float32)
        xy_a = rng.integers(10, 100, (16, 2)).astype(np.float32)
        xy_b = rng.integers(10, 100, (16, 2)).astype(np.float32)
        pa = np.asarray(extract_patches(jimg, jnp.asarray(xy_a))).astype(np.uint8)
        pb = np.asarray(extract_patches(jimg, jnp.asarray(xy_b))).astype(np.uint8)
        ref = native.sad_matrix(pa, pb)
        out = np.asarray(sad_matrix_jnp(jnp.asarray(pa, jnp.float32),
                                        jnp.asarray(pb, jnp.float32)))
        np.testing.assert_array_equal(out.astype(np.uint32), ref)

    def test_sad8_pointwise(self, img):
        s = native.compute_sad8(img, img, 50, 60, 50, 60)
        assert s == 0
        s2 = native.compute_sad8(img, img, 50, 60, 51, 60)
        assert s2 > 0

    def test_hamming_matches_jnp(self, rng):
        from rso.kernels import hamming_matrix_jnp

        a = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, (48, 8), dtype=np.uint32)
        ref = native.hamming_matrix(a, b)
        out = np.asarray(hamming_matrix_jnp(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(out.astype(np.uint32), ref)


class TestTrackingSAD:
    def test_recovers_location(self, img):
        """Property test of the reference's trackSAD_unittest: the template
        must be found at its true location, matching the jnp cost volume."""
        from rso.kernels import windowed_sad_search

        tx, ty = 80, 60
        templ = img[ty - 3 : ty + 5, tx - 3 : tx + 5]
        bx, by, sad = native.tracking_sad(img, templ, tx + 4, ty - 3, 8, 8)
        assert (bx, by) == (tx, ty)
        assert sad == 0

        res = windowed_sad_search(
            jnp.asarray(img, jnp.float32),
            jnp.asarray(templ.reshape(1, 64), jnp.float32),
            jnp.asarray([[tx + 4.0, ty - 3.0]]), win_x=8, win_y=8)
        np.testing.assert_allclose(np.asarray(res.best_xy)[0], [tx, ty],
                                   atol=0.5)


class TestFASTOracle:
    def test_fast_matches_dense_jnp(self, rng):
        """The dense JAX corner mask must agree with the scalar C++ FAST."""
        from rso.frontend.detect import fast_corner_mask
        from rso.synthetic import make_sequence

        seq = make_sequence(n_frames=1, n_points=800, H=120, W=160)
        img = seq.frames[0][0]
        for th in (10, 25):
            ref = native.fast_detect(img, th, arc=12)
            mask = np.asarray(fast_corner_mask(jnp.asarray(img, jnp.float32),
                                               jnp.int32(th), arc=12))
            ys, xs = np.nonzero(mask)
            ours = set(zip(xs.tolist(), ys.tolist()))
            theirs = set(map(tuple, ref.tolist()))
            assert ours == theirs


class TestDownsample:
    def test_matches_mean(self, img):
        out = native.downsample2x(img)
        a = img[: out.shape[0] * 2, : out.shape[1] * 2].astype(np.int32)
        expect = (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2]
                  + a[1::2, 1::2] + 2) // 4
        np.testing.assert_array_equal(out, expect.astype(np.uint8))
