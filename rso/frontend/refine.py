"""Subpixel refinement of tracked observations (rso improvement).

Neither the reference's FASTER path nor its windowed SAD tracker is subpixel:
tracked coordinates inherit integer detection quantization, which puts a
~0.3px noise floor under the pose solve.  This module aligns each tracked
current-frame observation against the stored previous-frame 8x8 patch
(template) with a few Gauss-Newton LK iterations — a translation-only,
fixed-iteration inverse-compositional solve, vectorized over all tracked
features.  Measured effect: ATE improves 6-15% in 6/6 seed x speed configs
on the textured corridor (tools/exp_refine_texture.py).

Runs inside the jitted step; needs only the current octave image and the
previous patches already carried in EngineState (no extra state).

Fixed-shape formulation (v2): the iteration never touches the full image.  One
batched 16x16 patch per keypoint is pulled up front with the detector's
profiled row-take + one-hot-lane extractor (detect.extract_patches); every
LK iteration then works on the [K,16,16] tensor with a tiny vmapped
dynamic_slice + static bilinear mixing.  The v1 formulation (one 9x9
dynamic_slice FROM THE FULL IMAGE per keypoint per iteration) lowered to
scattered device-memory gathers, many times slower; v1 itself replaced a per-sample gather bilinear
of the kernel-fault class documented in docs/FLOW_SCAN_FAULT.md.
Edge padding reproduces clamp-to-border sampling for out-of-image taps.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from rso.frontend.detect import extract_patches

_PAD = 8    # patch half-size: covers window reach (-3..+4) + shift (+-2.5) + 1
_S = 16


def refine_positions(
    img: jnp.ndarray,          # [H,W] current octave image
    templates: jnp.ndarray,    # [K,64] previous-frame 8x8 patches
    xy: jnp.ndarray,           # [K,2] current positions to refine
    valid: jnp.ndarray,        # [K]
    iters: int = 2,
    max_shift: float = 2.0,
    ssd_gate: bool = False,
) -> jnp.ndarray:
    """Return refined [K,2] positions (invalid slots pass through).

    `iters` GN iterations cost one window evaluation each; `ssd_gate` adds
    two more (alignment-improved acceptance test).  Measured on the
    textured corridor (3 seeds, tools/exp_refine_trim.py): iters=2 without
    the gate keeps the full ATE win of iters=3 with it (0.021-0.023 m vs
    0.039 m unrefined in every variant) at 2/5 of the window evals — the
    det > 1e-6 solvability check already rejects the weak-gradient patches
    the gate was guarding against.  Set ssd_gate=True for the conservative
    acceptance on unfamiliar imagery.
    """
    H, W = img.shape
    img_p = jnp.pad(img, _PAD, mode="edge")
    x = jnp.clip(xy[:, 0], 0.0, W - 1.0)
    y = jnp.clip(xy[:, 1], 0.0, H - 1.0)
    cx = jnp.round(x).astype(jnp.int32)
    cy = jnp.round(y).astype(jnp.int32)
    # one batched extraction: [K,16,16] windows centered on the rounded
    # start position (patch index _PAD,_PAD == image pixel (cy,cx))
    centers = jnp.stack([(cx + _PAD).astype(jnp.float32),
                         (cy + _PAD).astype(jnp.float32)], axis=1)
    patches = extract_patches(img_p, centers, size=_S,
                              offset=_PAD).reshape(-1, _S, _S)
    frac = jnp.stack([x - cx, y - cy], axis=1)   # in [-0.5, 0.5]

    def one(t, patch, r):
        T = t.reshape(8, 8)
        # template gradients from the template itself (inverse compositional):
        gx = jnp.zeros((8, 8)).at[:, 1:7].set((T[:, 2:] - T[:, :-2]) * 0.5)
        gy = jnp.zeros((8, 8)).at[1:7, :].set((T[2:, :] - T[:-2, :]) * 0.5)
        Gxx = jnp.sum(gx * gx)
        Gxy = jnp.sum(gx * gy)
        Gyy = jnp.sum(gy * gy)
        det = Gxx * Gyy - Gxy * Gxy
        ok = det > 1e-6
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

        idx = jnp.arange(_S, dtype=jnp.int32)
        nine = jnp.arange(9, dtype=jnp.int32)

        def window(d):
            # 8x8 bilinear window at real-valued in-patch offset r+d from
            # the patch center; all taps stay inside the 16x16 patch for
            # |r| <= 0.5, |d| <= max_shift (floor in [-3..2], tap <= 15).
            # The 9x9 integer window is cut out with one-hot row/column
            # matmuls — static shapes, no gather: a vmapped dynamic_slice
            # here lowers to scattered gathers.
            q = r + d
            bx = jnp.clip(jnp.floor(q[0]).astype(jnp.int32), -3, 2)
            by = jnp.clip(jnp.floor(q[1]).astype(jnp.int32), -3, 2)
            fx = q[0] - bx
            fy = q[1] - by
            rsel = (idx[None, :] == (_PAD + by - 3 + nine)[:, None])
            csel = (idx[None, :] == (_PAD + bx - 3 + nine)[:, None])
            cp = (rsel.astype(patch.dtype) @ patch
                  @ csel.astype(patch.dtype).T)
            return ((1 - fy) * (1 - fx) * cp[:8, :8]
                    + (1 - fy) * fx * cp[:8, 1:9]
                    + fy * (1 - fx) * cp[1:9, :8]
                    + fy * fx * cp[1:9, 1:9])

        def ssd(d):
            return jnp.sum((window(d) - T) ** 2)

        def body(_, d):
            e = window(d) - T
            bx_ = jnp.sum(gx * e)
            by_ = jnp.sum(gy * e)
            ddx = -(Gyy * bx_ - Gxy * by_) * inv
            ddy = -(-Gxy * bx_ + Gxx * by_) * inv
            d = d + jnp.stack([ddx, ddy])
            return jnp.clip(d, -max_shift, max_shift)

        d = lax.fori_loop(0, iters, body, jnp.zeros(2))
        if ssd_gate:
            # accept only if alignment measurably improved (2 extra window
            # evals; see docstring for the measured trade)
            ok = ok & (ssd(d) < 0.9 * ssd(jnp.zeros(2)))
        return jnp.where(ok, d, jnp.zeros(2))

    delta = jax.vmap(one)(templates, patches, frac)
    # delta is relative to the rounded center; rebase onto the true start
    refined = jnp.stack([cx.astype(xy.dtype), cy.astype(xy.dtype)],
                        axis=1) + frac + delta
    return jnp.where(valid[:, None], refined, xy)
