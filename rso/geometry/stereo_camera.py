"""Stereo pinhole camera model: triangulation, projection, analytic Jacobian.

JAX equivalent of (reference, stereo_vo):
  - closed-form stereo back-projection       stage5_optimization.cpp:519-544
  - m_pinhole_stereo_projection (+4x6 J)     stage5_optimization.cpp:35-257
  - getProjectedCoords landmark reprojection common.cpp:415-470

Everything is vectorized over landmarks (shape [N,...]); no per-landmark loop.
The analytic Jacobian mirrors the reference's closed form and is validated
against jax.jacfwd and finite differences in tests/test_geometry.py.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rso.geometry.rotations import rodrigues_with_grad


class StereoCamera(NamedTuple):
    """Rectified stereo pinhole pair. All entries are scalars (f32 on device).

    Mirrors mrpt::utils::TStereoCamera as used by the reference: left/right
    intrinsics plus the x-baseline (rightCameraPose[0]).
    """

    fx_l: jnp.ndarray
    fy_l: jnp.ndarray
    cx_l: jnp.ndarray
    cy_l: jnp.ndarray
    fx_r: jnp.ndarray
    fy_r: jnp.ndarray
    cx_r: jnp.ndarray
    cy_r: jnp.ndarray
    baseline: jnp.ndarray

    @staticmethod
    def make(fx_l, fy_l, cx_l, cy_l, baseline, fx_r=None, fy_r=None, cx_r=None, cy_r=None,
             dtype=jnp.float32):
        """Build a camera; right intrinsics default to the left ones."""
        f = lambda v: jnp.asarray(v, dtype=dtype)
        return StereoCamera(
            f(fx_l), f(fy_l), f(cx_l), f(cy_l),
            f(fx_r if fx_r is not None else fx_l),
            f(fy_r if fy_r is not None else fy_l),
            f(cx_r if cx_r is not None else cx_l),
            f(cy_r if cy_r is not None else cy_l),
            f(baseline),
        )


def triangulate(cam: StereoCamera, ul, vl, ur):
    """Closed-form stereo back-projection (reference stage5_optimization.cpp:537-543):

        b_d = baseline / (fl*(cur - ur) + fr*(ul - cul))
        X   = (b_d*fr*(ul-cul), b_d*fr*(vl-cvl), b_d*fl*fr)

    Inputs are arrays of left/right pixel coords; returns [N,3] landmarks in the
    left-camera frame.
    """
    denom = cam.fx_l * (cam.cx_r - ur) + cam.fx_r * (ul - cam.cx_l)
    safe = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    b_d = cam.baseline / safe
    X = b_d * cam.fx_r * (ul - cam.cx_l)
    Y = b_d * cam.fx_r * (vl - cam.cy_l)
    Z = b_d * cam.fx_l * cam.fx_r
    return jnp.stack([X, Y, Z], axis=-1)


def _transform(delta_pose, lmks):
    """3D points under the tested camera motion delta_pose=[w,t]."""
    R, dR = rodrigues_with_grad(delta_pose[:3])
    P = lmks @ R.T + delta_pose[3:]  # [N,3]
    return P, dR


def project_stereo(cam: StereoCamera, lmks: jnp.ndarray, delta_pose: jnp.ndarray):
    """Project [N,3] landmarks through delta_pose to (uL,vL,uR,vR) pixels [N,4].

    Mirrors stage5_optimization.cpp:179-195: the right camera shares Z with the
    left (rectified pair), X is shifted by the baseline.
    """
    P, _ = _transform(delta_pose, lmks)
    X1c, Y1c, Z1c = P[:, 0], P[:, 1], P[:, 2]
    Zs = jnp.where(jnp.abs(Z1c) < 1e-9, 1e-9, Z1c)
    X2c = X1c - cam.baseline
    ul = cam.fx_l * X1c / Zs + cam.cx_l
    vl = cam.fy_l * Y1c / Zs + cam.cy_l
    ur = cam.fx_r * X2c / Zs + cam.cx_r
    vr = cam.fy_r * Y1c / Zs + cam.cy_r
    return jnp.stack([ul, vl, ur, vr], axis=-1)


def project_stereo_with_jacobian(cam: StereoCamera, lmks: jnp.ndarray,
                                 delta_pose: jnp.ndarray):
    """Pixels [N,4] plus the per-landmark 4x6 Jacobian d(uL,vL,uR,vR)/d(w,t).

    Vectorized form of the reference's per-landmark loop
    (stage5_optimization.cpp:169-256):  dP/dw_k = dR/dw_k @ X_prev,
    dP/dt_k = e_k, then the pinhole quotient rule per image row.
    """
    R, dR = rodrigues_with_grad(delta_pose[:3])
    P = lmks @ R.T + delta_pose[3:]
    X1c, Y1c, Z1c = P[:, 0], P[:, 1], P[:, 2]
    Zs = jnp.where(jnp.abs(Z1c) < 1e-9, 1e-9, Z1c)
    X2c = X1c - cam.baseline

    ul = cam.fx_l * X1c / Zs + cam.cx_l
    vl = cam.fy_l * Y1c / Zs + cam.cy_l
    ur = cam.fx_r * X2c / Zs + cam.cx_r
    vr = cam.fy_r * Y1c / Zs + cam.cy_r
    pix = jnp.stack([ul, vl, ur, vr], axis=-1)

    # dP/dtheta_j for the 6 params: rotation part dR_k @ lmk, translation e_k.
    dP_rot = jnp.einsum("kij,nj->nki", dR, lmks)          # [N,3(k),3(coord)]
    dP_trans = jnp.broadcast_to(jnp.eye(3, dtype=lmks.dtype), (lmks.shape[0], 3, 3))
    dP = jnp.concatenate([dP_rot, dP_trans], axis=1)       # [N,6,3]
    Xd, Yd, Zd = dP[..., 0], dP[..., 1], dP[..., 2]        # each [N,6]

    Z2 = Zs * Zs
    # quotient rule rows (reference :251-254)
    Ju_l = cam.fx_l * (Xd * Zs[:, None] - X1c[:, None] * Zd) / Z2[:, None]
    Jv_l = cam.fy_l * (Yd * Zs[:, None] - Y1c[:, None] * Zd) / Z2[:, None]
    Ju_r = cam.fx_r * (Xd * Zs[:, None] - X2c[:, None] * Zd) / Z2[:, None]
    Jv_r = cam.fy_r * (Yd * Zs[:, None] - Y1c[:, None] * Zd) / Z2[:, None]
    J = jnp.stack([Ju_l, Jv_l, Ju_r, Jv_r], axis=1)        # [N,4,6]
    return pix, J


def project_landmarks(cam: StereoCamera, ul, vl, ur, delta_pose):
    """Triangulate prev-frame stereo observations and reproject them under
    delta_pose — the reference's getProjectedCoords (common.cpp:415-470)."""
    lmks = triangulate(cam, ul, vl, ur)
    return project_stereo(cam, lmks, delta_pose)
