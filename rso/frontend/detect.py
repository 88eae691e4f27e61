"""Stage 2: feature detection, response, NMS, top-K, descriptors, patches.

Fixed-shape re-design of the reference's stage2_detect_features (stereo_vo
stage2_detect.cpp:385-671).  The reference's four detector modes map to:

  dmFASTER  -> dense FAST-N corner test + Shi-Tomasi (KLT) response filter
               (reference :519-576 computes KLT_response over FASTER corners)
  dmFAST_ORB-> same corner test + oriented-BRIEF descriptors
  dmORB     -> FAST + Harris-style response + oriented-BRIEF on 1 octave
  dmKLT     -> dense Shi-Tomasi response, no descriptor (goodFeaturesToTrack)

Everything is dense, fixed-shape and branch-free: the corner test runs over
the whole image as 16 shifted comparisons, NMS is a windowed max compare, and
the dynamic per-feature count becomes top-K with a validity mask (the
shape-stable replacement for the FAST threshold servo; the servo itself is
still carried as engine state and applied as a traced threshold).

Descriptors are 256-bit oriented BRIEF packed into uint32[8] words (Hamming
distance = XOR + population count).  The sampling pattern is
LEARNED (rso/frontend/orb_pattern.py, trained by tools/learn_orb_pattern.py
with the ORB paper's greedy variance/decorrelation procedure on steered
real-texture patches — the same training behind cv::ORB's bit_pattern_31_).
It is *self-consistent* (the framework matches its own descriptors) rather
than bit-compatible with OpenCV's table.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from rso.config import DetectMethod, DetectParams

# ---------------------------------------------------------------------------
# FAST circle (radius-3 Bresenham, the canonical 16 offsets) as (dx, dy)
# ---------------------------------------------------------------------------
_FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

# BRIEF pattern: 256 coordinate pairs, fixed seed, Gaussian sigma=5 clipped to
# a radius-12 disc so any rotation stays inside a 37x37 patch.
_BRIEF_N = 256
_PATCH = 37           # descriptor patch side (center at 18)
_PATCH_R = _PATCH // 2
_ORIENT_R = 15        # intensity-centroid radius (ORB uses 15)


def _make_brief_pattern() -> np.ndarray:
    """256 BRIEF test pairs, [256, 2(pair), 2(xy)].

    Primary: the LEARNED pattern (tools/learn_orb_pattern.py — the ORB-paper
    greedy variance/decorrelation training on steered real-texture patches,
    the same procedure behind cv::ORB's bit_pattern_31_ that the reference
    uses, stage2_detect.cpp:480-493).  Fallback: seeded random-Gaussian BRIEF
    with a minimum pair distance of 2.5px (pairs closer than the 5x5
    smoothing kernel compare a value with itself)."""
    try:
        from rso.frontend.orb_pattern import LEARNED_PATTERN

        return np.asarray(LEARNED_PATTERN, dtype=np.float32)
    except ImportError:  # pragma: no cover
        pass
    r = np.random.default_rng(0x5EED)
    out = []
    while len(out) < _BRIEF_N:
        p = np.clip(r.normal(0.0, 5.0, size=(2, 2)), -12.0, 12.0)
        if np.linalg.norm(p[0] - p[1]) >= 2.5:
            out.append(p)
    return np.asarray(out, dtype=np.float32)  # [256, 2(pair), 2(xy)]


_BRIEF_PATTERN = _make_brief_pattern()


class Features(NamedTuple):
    """Fixed-capacity feature set for one image at one octave."""

    xy: jnp.ndarray        # [K,2] f32 pixel coords (octave scale)
    response: jnp.ndarray  # [K] f32
    valid: jnp.ndarray     # [K] bool
    desc: jnp.ndarray      # [K,8] uint32 packed 256-bit BRIEF
    patch: jnp.ndarray     # [K,64] f32 flattened 8x8 SAD patch


# ---------------------------------------------------------------------------
# Dense responses
# ---------------------------------------------------------------------------

def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """Shift so out[y,x] = img[y+dy, x+dx], zero-padded."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def fast_corner_mask(img: jnp.ndarray, threshold: jnp.ndarray, arc: int = 12) -> jnp.ndarray:
    """Dense FAST-N segment test: [H,W] bool.

    A pixel is a corner if >= `arc` contiguous circle pixels are all brighter
    than center+t or all darker than center-t (FASTER-12 equivalent of the
    reference's detectFeatures_SSE2_FASTER12, stage2_detect.cpp:527).
    `threshold` may be a traced scalar (the dynamic servo state).
    """
    t = threshold.astype(img.dtype)
    hi = img + t
    lo = img - t
    # Bit-pack the 16 circle comparisons into one uint32 plane per polarity:
    # bit i of bright[y,x] says circle-pixel i is brighter than center+t.
    # ~3x less memory traffic than materializing a [16,H,W] stack.
    bright = jnp.zeros(img.shape, jnp.uint32)
    dark = jnp.zeros(img.shape, jnp.uint32)
    for i, (dx, dy) in enumerate(_FAST_OFFSETS):
        n = _shift2d(img, int(dx), int(dy))
        bit = jnp.uint32(1 << i)
        bright = bright | jnp.where(n > hi, bit, jnp.uint32(0))
        dark = dark | jnp.where(n < lo, bit, jnp.uint32(0))

    def rotl16(b, s):
        s = s % 16
        if s == 0:
            return b & jnp.uint32(0xFFFF)
        return ((b << s) | (b >> (16 - s))) & jnp.uint32(0xFFFF)

    def has_arc(b):
        # run-length doubling on the circular 16-bit word: R_{2k} = R_k &
        # rotl(R_k, k) marks a run of 2k set bits ending at each position;
        # compose R_arc from powers of two.  O(log arc) integer ops per pixel.
        runs = {1: b}
        k = 1
        while 2 * k <= arc:
            runs[2 * k] = runs[k] & rotl16(runs[k], k)
            k *= 2
        need = arc
        acc = None
        offset = 0
        for p in sorted(runs, reverse=True):
            while need >= p:
                term = rotl16(runs[p], offset)
                acc = term if acc is None else (acc & term)
                offset += p
                need -= p
        return acc != 0

    corner = has_arc(bright) | has_arc(dark)
    # zero out the 3px wrap-around border introduced by roll
    H, W = img.shape
    ys = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    border = (xs >= 3) & (xs < W - 3) & (ys >= 3) & (ys < H - 3)
    return corner & border


def _box_sum(img: jnp.ndarray, r: int) -> jnp.ndarray:
    """Sum over a (2r+1)^2 window (zero-padded at borders), separable.

    Two fused shift-add passes.  An integral-image (cumsum) formulation is
    asymptotically cheaper, but each shift-add pass is one elementwise
    sweep XLA fuses, and it is exact (no large-value cancellation).
    """
    H, W = img.shape
    s = 2 * r + 1
    p = jnp.pad(img, ((r, r), (0, 0)))
    rows = sum(p[dy:dy + H, :] for dy in range(s))
    p = jnp.pad(rows, ((0, 0), (r, r)))
    return sum(p[:, dx:dx + W] for dx in range(s))


def shi_tomasi_response(img: jnp.ndarray, win: int) -> jnp.ndarray:
    """Dense KLT (min-eigenvalue) response — the reference's per-feature
    CImage::KLT_response (stage2_detect.cpp:566) computed for every pixel at
    once: structure tensor over a (2*win+1)^2 window, lambda_min.
    """
    gx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    gy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    n = float((2 * win + 1) ** 2)
    gxx = _box_sum(gx * gx, win) / n
    gyy = _box_sum(gy * gy, win) / n
    gxy = _box_sum(gx * gy, win) / n
    tr_half = 0.5 * (gxx + gyy)
    det_term = jnp.sqrt(jnp.maximum(0.25 * (gxx - gyy) ** 2 + gxy * gxy, 0.0))
    return tr_half - det_term


def harris_response(img: jnp.ndarray, win: int = 3, k: float = 0.04) -> jnp.ndarray:
    """Dense Harris score (ORB's HARRIS_SCORE ordering)."""
    gx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    gy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    gxx = _box_sum(gx * gx, win)
    gyy = _box_sum(gy * gy, win)
    gxy = _box_sum(gx * gy, win)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


# ---------------------------------------------------------------------------
# NMS + top-K selection
# ---------------------------------------------------------------------------

def nms_grid(response: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Windowed-maximum non-maximal suppression: keep pixels that are the
    maximum of their (2*radius+1)^2 neighborhood.

    Parallel equivalent of the reference's greedy occupancy-grid suppression
    (stage2_detect.cpp:296-370) — same spatial decimation contract (no two
    survivors closer than ~radius), order-free so it vectorizes.
    """
    r = max(int(radius), 1)
    wmax = lax.reduce_window(
        response, -jnp.inf, lax.max,
        window_dimensions=(2 * r + 1, 2 * r + 1),
        window_strides=(1, 1), padding="SAME",
    )
    return response >= wmax


def adaptive_nms_select(xy: jnp.ndarray, resp: jnp.ndarray,
                        valid: jnp.ndarray, num_out: int,
                        min_radius: float = 0.0, crob: float = 0.9):
    """Adaptive (suppression-radius) non-maximal suppression.

    Vectorized form of the reference's m_adaptive_non_max_sup
    (stage2_detect.cpp:141-215): each keypoint's radius is its squared
    distance to the nearest keypoint that beats it by the robustness factor
    (resp_i < crob * resp_j); the global maximum gets infinite radius; keep
    the `num_out` largest radii above min_radius^2.

    Returns a refined validity mask over the same slots.
    """
    K = xy.shape[0]
    d2 = jnp.sum((xy[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
    stronger = (resp[:, None] < crob * resp[None, :]) & valid[None, :]
    d2 = jnp.where(stronger & valid[:, None], d2, jnp.inf)
    radius = jnp.min(d2, axis=1)            # inf if nothing stronger
    radius = jnp.where(valid, radius, -jnp.inf)
    order = jnp.argsort(-radius)            # descending radius
    rank = jnp.zeros((K,), jnp.int32).at[order].set(jnp.arange(K, dtype=jnp.int32))
    keep = valid & (rank < num_out) & (radius > min_radius * min_radius)
    return keep


def select_topk(response: jnp.ndarray, keep_mask: jnp.ndarray, k: int,
                min_response: float | jnp.ndarray = 0.0,
                subpixel: bool = True, recall: float = 0.95,
                bin_w: int = 1):
    """Top-K peaks of a masked dense response map -> (xy [K,2], resp [K], valid [K]).

    With subpixel=True, peak positions are refined by a 1D quadratic fit per
    axis on the response surface (clamped to +-0.5 px) — accuracy the integer
    FASTER path of the reference lacks; stage-3/4 row logic rounds coords so
    the reference's integer-row semantics are preserved.

    bin_w > 1 runs the top-K over a row-binned max of the masked map (bins
    of bin_w lanes, argmax-in-bin recovers the exact column).  EXACT when
    the map is NMS-sparsified with radius >= bin_w - 1: surviving same-row
    peaks are then >= bin_w apart, so no bin ever holds two peaks and the
    peak SET is identical — only the top-K input shrinks by bin_w.
    """
    H, W = response.shape
    masked = jnp.where(keep_mask, response, -jnp.inf)
    if bin_w > 1:
        Wp = -(-W // bin_w) * bin_w
        m = jnp.pad(masked, ((0, 0), (0, Wp - W)),
                    constant_values=-jnp.inf)
        m = m.reshape(H, Wp // bin_w, bin_w)
        binned = jnp.max(m, axis=-1)                  # [H, Wp/bin_w]
        inbin = jnp.argmax(m, axis=-1).astype(jnp.int32)
        flat = binned.reshape(-1)
    else:
        flat = masked.reshape(-1)
    try:  # approximate top-k where the backend has one (a GPU or CPU runs
        # an exact top-k; EngineParams.topk_recall)
        vals, idx = lax.approx_max_k(flat, k, recall_target=recall)
    except NotImplementedError:  # pragma: no cover
        vals, idx = lax.top_k(flat, k)
    if bin_w > 1:
        wb = flat.shape[0] // H
        yi = (idx // wb).astype(jnp.int32)
        bi = (idx % wb).astype(jnp.int32)
        xi = jnp.minimum(bi * bin_w + inbin[yi, bi], W - 1)
    else:
        yi = (idx // W).astype(jnp.int32)
        xi = (idx % W).astype(jnp.int32)
    valid = jnp.isfinite(vals) & (vals > min_response)
    xs = xi.astype(jnp.float32)
    ys = yi.astype(jnp.float32)
    if subpixel:
        def parab(vm, v0, vp):
            denom = vm - 2.0 * v0 + vp
            off = jnp.where(jnp.abs(denom) > 1e-6,
                            0.5 * (vm - vp) / jnp.where(jnp.abs(denom) > 1e-6,
                                                        denom, 1.0), 0.0)
            return jnp.clip(off, -0.5, 0.5)

        # neighbors must be finite response (corner-masked map has -inf
        # holes); mask AFTER gathering [K] values — a dense masked copy of
        # the whole response map would cost one more pass over the image
        xm = jnp.clip(xi - 1, 0, W - 1); xp = jnp.clip(xi + 1, 0, W - 1)
        ym = jnp.clip(yi - 1, 0, H - 1); yp = jnp.clip(yi + 1, 0, H - 1)

        def g(yy, xx):
            v = response[yy, xx]
            return jnp.where(jnp.isfinite(v), v, 0.0)

        # gathered [K] values are cast to f32 so the parabola fit keeps full
        # precision even when the dense response map is bf16 (detect_bf16)
        v0 = g(yi, xi).astype(jnp.float32)
        dx = parab(g(yi, xm).astype(jnp.float32), v0,
                   g(yi, xp).astype(jnp.float32))
        dy = parab(g(ym, xi).astype(jnp.float32), v0,
                   g(yp, xi).astype(jnp.float32))
        xs = xs + jnp.where(valid, dx, 0.0)
        ys = ys + jnp.where(valid, dy, 0.0)
    xy = jnp.stack([xs, ys], axis=-1)
    vals = vals.astype(jnp.float32)
    return xy, jnp.where(valid, vals, 0.0), valid


# ---------------------------------------------------------------------------
# Patches & descriptors
# ---------------------------------------------------------------------------

_WIN_STRIDE_OVERRIDE: int | None = None
_TOPK_BIN_OVERRIDE: int | None = None   # trace-time A/B hook for bin_w


def _extract_rect(img: jnp.ndarray, x0: jnp.ndarray, y0: jnp.ndarray,
                  size_y: int, size_x: int) -> jnp.ndarray:
    """Batched size_y x size_x window pull at integer top-left corners
    (x0, y0 [K] int32, caller-clamped in-range) -> [K, size_y, size_x].

    Formulation: gather whole 64-wide window rows (overlapping windows built
    by plain slicing) instead of pointwise 2D gathers, then pick the size_x
    lanes with an exact one-hot multiply-sum; bit-exact (one-hot is 0/1
    f32).  Its speed against a plain 2D gather on the GPU is not measured.

    Window stride: any stride <= 64 - size_x keeps the lane offset within
    the 64-lane window for every in-range x0 (off = x0 - stride*wi <=
    stride-1 when wi is exact, and <= 64 - size_x when it clamps at the
    right edge because stride*(n_win-1) >= W - 64 by construction).  The
    maximal stride 64 - size_x minimizes the materialized [H, n_win, 64]
    window stack — for 8x8 SAD patches that is stride 56 vs the original
    32, a 1.7x smaller stack.
    """
    assert size_x <= 32
    H, W = img.shape
    K = x0.shape[0]
    # trace-time experiment hook (build stride variants of the step program
    # in one process for an A/B)
    stride = (_WIN_STRIDE_OVERRIDE if _WIN_STRIDE_OVERRIDE
              else 64 - size_x)
    stride = min(stride, 64 - size_x)
    n_win = max(1, -(-(W - 64) // stride) + 1) if W > 64 else 1
    Wp = stride * (n_win - 1) + 64
    imp = jnp.pad(img, ((0, 0), (0, Wp - W)))
    win = jnp.stack([lax.slice(imp, (0, stride * i), (H, stride * i + 64))
                     for i in range(n_win)], axis=1)      # [H, n_win, 64]
    wi = jnp.clip(x0 // stride, 0, n_win - 1)             # window index [K]
    off = x0 - stride * wi                                # lane offset
    rows = y0[:, None] + jnp.arange(size_y, dtype=jnp.int32)[None, :]
    ridx = (rows * n_win + wi[:, None]).reshape(-1)                   # [K*sy]
    rowvals = jnp.take(win.reshape(H * n_win, 64), ridx, axis=0)      # [K*sy,64]
    lane = jnp.arange(64, dtype=jnp.int32)
    offb = jnp.repeat(off, size_y)                                    # [K*sy]
    sel = (lane[None, :, None] ==
           (offb[:, None, None]
            + jnp.arange(size_x, dtype=jnp.int32)[None, None, :]))
    out = jnp.sum(rowvals[:, :, None] * sel.astype(img.dtype), axis=1)
    return out.reshape(K, size_y, size_x)


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray, size: int = 8,
                    offset: int = 3) -> jnp.ndarray:
    """Gather size x size patches at integer keypoint coords -> [K, size*size].

    The 8x8 SAD patch window is (x-3..x+4, y-3..y+4) exactly like the
    reference's compute_SAD8 (compute_SAD8.cpp:71-97).  Coords are clamped to
    the image; border validity is the caller's mask.
    """
    H, W = img.shape
    K = xy.shape[0]
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - offset, 0, W - size)
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - offset, 0, H - size)
    return _extract_rect(img, x0, y0, size, size).reshape(K, size * size)


def extract_patches_wide(img: jnp.ndarray, xy: jnp.ndarray, size: int,
                         offset: int) -> jnp.ndarray:
    """extract_patches for size in (32, 64]: two lane pulls, concatenated.

    Same clamp semantics (whole window clipped to the image as one unit).
    """
    assert 32 < size <= 64
    H, W = img.shape
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - offset, 0, W - size)
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - offset, 0, H - size)
    left = _extract_rect(img, x0, y0, size, 32)
    right = _extract_rect(img, x0 + 32, y0, size, size - 32)
    return jnp.concatenate([left, right], axis=2)


def orb_orientation(patch31: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle of a [31,31] patch (ORB's orientation)."""
    r = _ORIENT_R
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    circle = (xs * xs + ys * ys) <= r * r
    wx = jnp.asarray((xs * circle).astype(np.float32))
    wy = jnp.asarray((ys * circle).astype(np.float32))
    m10 = jnp.sum(patch31 * wx)
    m01 = jnp.sum(patch31 * wy)
    return jnp.arctan2(m01, m10)


def orb_descriptors(img: jnp.ndarray, xy: jnp.ndarray,
                    upright: bool = False) -> jnp.ndarray:
    """Oriented-BRIEF 256-bit descriptors, packed uint32 [K,8].

    Per keypoint: extract a 37x37 patch, compute the intensity-centroid
    orientation on its central 31x31, rotate the BRIEF pair pattern by it and
    compare bilinear samples of the 5x5-box-smoothed patch.  This is the
    fixed-shape formulation of the reference's cv::ORB describe step
    (stage2_detect.cpp:480-493): gathers stay inside a per-keypoint patch
    instead of scattering across the image.  The pre-smoothing is classic
    BRIEF/ORB (cv::ORB compares 5x5 integral-image sums): raw point samples
    flip bits under sub-pixel drift and inter-frame scale change — measured
    on the synthetic scenes, unsmoothed bits put the true-correspondence
    Hamming distance near random (median 73/256); smoothing restores margin.
    """
    pattern = jnp.asarray(_BRIEF_PATTERN)  # [256,2,2]

    # ONE batched pull of all descriptor patches (a per-keypoint
    # dynamic_slice from the image lowers to scattered gathers)
    patches = extract_patches_wide(img, xy, size=_PATCH, offset=_PATCH_R)

    lanes = jnp.arange(_PATCH, dtype=jnp.int32)

    def one(patch):
        if upright:
            c, s = jnp.float32(1.0), jnp.float32(0.0)
        else:
            center = patch[3:34, 3:34]  # 31x31
            theta = orb_orientation(center)
            c, s = jnp.cos(theta), jnp.sin(theta)
        # 5x5 box smoothing, separable shift-adds on the patch (pattern
        # points stay >= 4px inside the patch, so edge decay never reaches a
        # sampled location)
        pp = jnp.pad(patch, ((2, 2), (0, 0)))
        rows = sum(pp[dy:dy + _PATCH, :] for dy in range(5))
        pp = jnp.pad(rows, ((0, 0), (2, 2)))
        sm = sum(pp[:, dx:dx + _PATCH] for dx in range(5))
        # rotate all pattern points
        px = (pattern[..., 0] * c - pattern[..., 1] * s).reshape(-1)  # [512]
        py = (pattern[..., 0] * s + pattern[..., 1] * c).reshape(-1)
        # bilinear sample via weighted one-hot row/col contraction — static
        # shapes, no in-patch gather (same clip semantics as the old
        # pointwise sampler: coords clamped to the patch interior)
        cc = (_PATCH - 1) / 2.0
        xf = jnp.clip(px + cc, 0.0, _PATCH - 1.001)
        yf = jnp.clip(py + cc, 0.0, _PATCH - 1.001)
        xb = xf.astype(jnp.int32)
        yb = yf.astype(jnp.int32)
        fx = xf - xb
        fy = yf - yb
        wy = ((lanes[None, :] == yb[:, None]) * (1 - fy)[:, None]
              + (lanes[None, :] == yb[:, None] + 1) * fy[:, None])  # [512,37]
        wx = ((lanes[None, :] == xb[:, None]) * (1 - fx)[:, None]
              + (lanes[None, :] == xb[:, None] + 1) * fx[:, None])
        v = jnp.einsum("sy,yx,sx->s", wy, sm, wx).reshape(_BRIEF_N, 2)
        bits = (v[:, 0] < v[:, 1]).astype(jnp.uint32)  # [256]
        weights = jnp.asarray((2 ** np.arange(32)).astype(np.uint32))
        return jnp.sum(bits.reshape(8, 32) * weights[None, :], axis=1, dtype=jnp.uint32)

    return jax.vmap(one)(patches)


# ---------------------------------------------------------------------------
# Full stage-2 per image per octave
# ---------------------------------------------------------------------------

def octave_budget(orb_nfeats: int, n_octaves: int) -> list[int]:
    """Per-octave target feature counts (reference stage2_detect.cpp:405-407):
    k0 = nfeats * 2*O / (2^O - 1), k_o = k0 / 2^o."""
    if n_octaves == 1:
        return [orb_nfeats]
    k0 = int(orb_nfeats * (2 * n_octaves) / (2 ** n_octaves - 1))
    return [max(1, int(round(k0 / 2 ** o))) for o in range(n_octaves)]


def octave_k_slots(orb_nfeats: int, n_octaves: int, k_max: int,
                   decay: bool = True) -> list[int]:
    """Per-octave feature-slot capacities.

    The budget halves per octave, so uniform slot counts waste most of the
    [K,K] distance-matrix / tracking work at octaves > 0 on slots the budget
    gate empties anyway.  Each octave gets the smallest lane-aligned (x128)
    capacity covering its budget, capped at k_max."""
    if not decay:
        return [k_max] * n_octaves
    return [min(k_max, max(128, -(-b // 128) * 128))
            for b in octave_budget(orb_nfeats, n_octaves)]


def _orb_level_budgets(k_slots: int, nlevels: int) -> list[int]:
    """Per-level feature budgets, geometric with factor 1/1.2 like cv::ORB's
    nfeatures-per-level split; sums exactly to k_slots with every level >= 1.

    If k_slots < nlevels the ladder is truncated (fewer levels) rather than
    emitting zero-budget levels, which would crash select_topk at trace time.
    """
    nlevels = max(1, min(nlevels, k_slots))
    f = 1.0 / 1.2
    raw = [f ** l for l in range(nlevels)]
    scale = k_slots / sum(raw)
    ks = [max(1, int(round(r * scale))) for r in raw]
    # make the sum exact, preserving the >=1 floor: walk levels coarse-to-fine
    # adding/removing one slot at a time (the residue is at most ~nlevels)
    diff = k_slots - sum(ks)
    j = 0
    while diff != 0:
        i = j % nlevels
        if diff > 0:
            ks[i] += 1
            diff -= 1
        elif ks[i] > 1:
            ks[i] -= 1
            diff += 1
        j += 1
    assert sum(ks) == k_slots and all(k >= 1 for k in ks)
    return ks


def _detect_orb_multilevel(img: jnp.ndarray, params: DetectParams,
                           k_slots: int, fast_threshold, need_desc: bool,
                           topk_recall: float = 0.95) -> Features:
    """ORB detection over the internal 1.2x scale ladder (reference ORB mode:
    one engine octave, orb_nlevels internal scales — stage2_detect.cpp:458-497).

    Per level: bilinear resize, FAST-9 + Harris response, grid NMS, top-K
    within the level's geometric budget, descriptors computed on the LEVEL
    image (scale-covariant like cv::ORB), coords scaled back to full
    resolution.  SAD patches are extracted from the full-resolution image
    (stage-3/4 SAD always runs at the octave scale).  All shapes static.
    """
    H, W = img.shape
    budgets = _orb_level_budgets(k_slots, params.orb_nlevels)
    nlevels = len(budgets)   # may be < orb_nlevels when k_slots is tiny
    xs, rs, vs, ds = [], [], [], []
    for l in range(nlevels):
        s = 1.2 ** l
        Hl, Wl = max(int(round(H / s)), 64), max(int(round(W / s)), 64)
        lvl = (img if l == 0 else
               jax.image.resize(img, (Hl, Wl), method="bilinear"))
        corner = fast_corner_mask(lvl, fast_threshold, arc=9)
        resp = jnp.where(corner, harris_response(lvl), -jnp.inf)
        keep = nms_grid(resp, params.min_distance) & corner
        margin = _PATCH_R + 1 if need_desc else 5
        yy = lax.broadcasted_iota(jnp.int32, (Hl, Wl), 0)
        xx = lax.broadcasted_iota(jnp.int32, (Hl, Wl), 1)
        keep &= ((xx >= margin) & (xx < Wl - margin)
                 & (yy >= margin) & (yy < Hl - margin))
        xy, resp_k, valid = select_topk(resp, keep, budgets[l],
                                        params.minimum_ORB_response,
                                        recall=topk_recall)
        xy = jnp.where(valid[:, None], xy, 0.0)
        if need_desc:
            desc = orb_descriptors(lvl, xy, upright=params.orb_upright)
            desc = jnp.where(valid[:, None], desc, 0)
        else:
            desc = jnp.zeros((budgets[l], 8), dtype=jnp.uint32)
        # back to full-resolution coords (clamped inside the base margin).
        # jax.image.resize bilinear uses the half-pixel convention, so the
        # inverse map is (x + 0.5) * (W / Wl) - 0.5, not (W-1)/(Wl-1) scaling
        # (align-corners) — the latter biases coarse-level keypoints by up to
        # ~0.5 px near the borders.
        scale_back = jnp.asarray([W / Wl, H / Hl], jnp.float32)
        xyf = jnp.clip((xy + 0.5) * scale_back[None, :] - 0.5,
                       jnp.float32(5.0),
                       jnp.asarray([W - 6, H - 6], jnp.float32))
        xs.append(jnp.where(valid[:, None], xyf, 0.0))
        rs.append(resp_k)
        vs.append(valid)
        ds.append(desc)
    xy = jnp.concatenate(xs, axis=0)
    valid = jnp.concatenate(vs, axis=0)
    patch = extract_patches(img, xy)
    return Features(xy=xy, response=jnp.concatenate(rs, axis=0), valid=valid,
                    desc=jnp.concatenate(ds, axis=0),
                    patch=jnp.where(valid[:, None], patch, 0.0))


def detect_features(
    img: jnp.ndarray,
    params: DetectParams,
    k_slots: int,
    fast_threshold: jnp.ndarray,
    need_desc: bool,
    arc: int = 12,
    bf16: bool = False,
    topk_recall: float = 0.95,
    fast_i16: bool = False,
) -> Features:
    """Detect up to k_slots features on one octave image.

    `fast_threshold` is traced (the dynamic servo state lives in the engine);
    everything else is static config.
    """
    H, W = img.shape
    method = params.detect_method
    if method == DetectMethod.ORB and params.orb_nlevels > 1:
        # cv::ORB's internal scale space: the reference's ORB mode runs one
        # engine octave but detects over orb_nlevels scales at factor 1.2
        # (stage2_detect.cpp:458-497, stage1_rectify.cpp:80)
        return _detect_orb_multilevel(img, params, k_slots, fast_threshold,
                                      need_desc, topk_recall)
    # dense detection passes optionally run in bf16 (EngineParams.detect_bf16):
    # u8 pixel values and their first differences are exact in bf16, only the
    # box-summed gradient products round; the top-K gathers cast back to f32
    work = img.astype(jnp.bfloat16) if bf16 else img

    if method == DetectMethod.KLT:
        resp = shi_tomasi_response(work, params.KLT_win)
        keep = nms_grid(resp, params.min_distance)
        min_resp = params.minimum_KLT_response
    elif method == DetectMethod.ORB:
        corner = fast_corner_mask(work, fast_threshold, arc=9 if arc == 12 else arc)
        resp = jnp.where(corner, harris_response(work), -jnp.inf)
        keep = nms_grid(resp, params.min_distance) & corner
        min_resp = params.minimum_ORB_response
    else:  # FASTER / FAST_ORB: FAST corners ranked by KLT response
        if fast_i16 and not bf16:
            # exact half-width segment test: every 2x2-avg pyramid value is
            # a multiple of 1/16, so x16 is integral and the int16
            # comparisons are bit-identical to the f32 ones
            # (EngineParams.fast_i16)
            imgq = jnp.round(work * 16.0).astype(jnp.int16)
            thq = (fast_threshold.astype(jnp.int32) * 16).astype(jnp.int16)
            corner = fast_corner_mask(imgq, thq, arc=arc)
        else:
            corner = fast_corner_mask(work, fast_threshold, arc=arc)
        resp = jnp.where(corner, shi_tomasi_response(work, params.KLT_win),
                         -jnp.inf)
        keep = nms_grid(resp, params.min_distance) & (resp > -jnp.inf)
        min_resp = (params.minimum_KLT_response
                    if method == DetectMethod.FASTER else 0.0)

    from rso.config import NMSMethod
    use_adaptive = (params.non_maximal_suppression
                    and params.nmsMethod == NMSMethod.ADAPTIVE)
    if use_adaptive:
        # adaptive NMS works on the candidate list: a light 3x3 local-max
        # prefilter supplies genuine peaks (the reference feeds it detector
        # output that is already locally sparse), then radius suppression
        # picks the spatial spread after top-K selection
        keep = nms_grid(resp, 1)
    if not params.non_maximal_suppression:
        keep = jnp.ones_like(keep) if method == DetectMethod.KLT else (
            resp > -jnp.inf)

    # border margin: SAD patches need 4px; descriptors need the 37x37 patch
    margin = _PATCH_R + 1 if need_desc else max(4, params.KLT_win + 1)
    ys = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inb = (xs >= margin) & (xs < W - margin) & (ys >= margin) & (ys < H - margin)
    keep = keep & inb

    # binned top-K (select_topk bin_w) is off by default: its extra
    # binned-max + argmax passes over the dense map may cost more than
    # shrinking the top-K input saves; not measured on the GPU.
    bin_w = _TOPK_BIN_OVERRIDE if _TOPK_BIN_OVERRIDE is not None else 1
    if not params.non_maximal_suppression:
        bin_w = 1
    xy, resp_k, valid = select_topk(resp, keep, k_slots, min_resp,
                                    recall=topk_recall, bin_w=bin_w)
    if use_adaptive:
        valid = adaptive_nms_select(xy, resp_k, valid, k_slots)
    xy = jnp.where(valid[:, None], xy, 0.0)

    patch = extract_patches(img, xy)
    if need_desc:
        desc = orb_descriptors(img, xy, upright=params.orb_upright)
        desc = jnp.where(valid[:, None], desc, 0)
    else:
        desc = jnp.zeros((k_slots, 8), dtype=jnp.uint32)
    return Features(xy=xy, response=resp_k, valid=valid, desc=desc,
                    patch=jnp.where(valid[:, None], patch, 0.0))


def update_fast_threshold(threshold: jnp.ndarray, n_feats: jnp.ndarray,
                          img_area: int, params: DetectParams) -> jnp.ndarray:
    """The FAST threshold servo (reference stage2_detect.cpp:537-550):
    track target_feats_per_pixel by +-1 steps, clamped to [1, inf)."""
    density = n_feats.astype(jnp.float32) / float(img_area)
    lo = density < 0.8 * params.target_feats_per_pixel
    hi = density > 1.2 * params.target_feats_per_pixel
    thr = jnp.where(lo, jnp.maximum(1, threshold - 1),
                    jnp.where(hi, threshold + 1, threshold))
    return thr
