"""Stage 1: grayscale, rectification remap, and image pyramid — all on device.

JAX equivalent of the reference's stage1_prepare_rectify (stereo_vo
stage1_rectify.cpp:37-93): MRPT's CStereoRectifyMap becomes a precomputed
bilinear remap grid applied as a gather; CImagePyramid::buildPyramidFast
becomes a chain of 2x2 average-pool downsamples.  The octave rule matches the
reference (stage1_rectify.cpp:80): 1 octave for ORB mode, nOctaves otherwise
(handled by RSOConfig.n_octaves).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


def to_grayscale(img: jnp.ndarray) -> jnp.ndarray:
    """[H,W] or [H,W,3] uint8/float -> [H,W] float32 grayscale (0..255)."""
    img = img.astype(jnp.float32)
    if img.ndim == 3:
        # ITU-R BT.601 luma, same weighting family as OpenCV's cvtColor
        img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return img


def bilinear_remap(img: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray) -> jnp.ndarray:
    """Sample img[f32 HxW] at float coords (map_x, map_y) with bilinear interp.

    The device half of rectification; the maps come from
    rso.io.calib.compute_rectify_maps (host, numpy, cached once per camera —
    mirroring the reference's one-time CStereoRectifyMap build,
    stage1_rectify.cpp:66-73).
    """
    H, W = img.shape
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)

    Ia = img[y0i, x0i]
    Ib = img[y0i, x1i]
    Ic = img[y1i, x0i]
    Id = img[y1i, x1i]
    top = Ia * (1 - fx) + Ib * fx
    bot = Ic * (1 - fx) + Id * fx
    out = top * (1 - fy) + bot * fy
    # out-of-range maps -> 0 (cv::remap BORDER_CONSTANT behavior)
    valid = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return jnp.where(valid, out, 0.0)


def _pool_matrix(n: int) -> jnp.ndarray:
    """[n//2, n] matrix averaging adjacent element pairs (rows sum to 1).

    Built from iotas, NOT a materialized numpy constant: an np array here
    serializes as an inline dense<...> constant in the lowered program —
    8.4 MB of hex for the four KITTI-size pool matrices, which the compiler
    has to parse on every compile (tests/test_program_size.py guards it).
    The iota form is a few ops; XLA constant-folds it and hoists it out of
    scan bodies.
    """
    rows = lax.broadcasted_iota(jnp.int32, (n // 2, n), 0)
    cols = lax.broadcasted_iota(jnp.int32, (n // 2, n), 1)
    half = cols // 2
    return jnp.where(half == rows, jnp.float32(0.5), jnp.float32(0.0))


def downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 average-pool halving (the pyramid step).

    buildPyramidFast smooths+subsamples; a 2x2 mean is the standard
    anti-aliased equivalent.  Computed as two pooling matmuls
    (D_H @ img @ D_W^T); bit-identical to a reshape-mean (the 0.5 weights
    and pixel sums are exact in f32).  Its speed against the alternatives
    on the GPU is not measured.
    """
    H, W = img.shape
    return (_pool_matrix(H) @ img) @ _pool_matrix(W).T


def build_pyramid(img: jnp.ndarray, n_octaves: int) -> list[jnp.ndarray]:
    """[img, half, quarter, ...] — n_octaves images, octave o scaled by 2^-o."""
    out = [img]
    for _ in range(1, n_octaves):
        out.append(downsample2x(out[-1]))
    return out
