"""Rotation-vector (Rodrigues) utilities with closed-form derivatives.

JAX counterpart of the reference's inline rotation algebra in
`m_pinhole_stereo_projection` (stereo_vo stage5_optimization.cpp:35-163): the
rotation matrix R(w) and all nine dR/dw_k terms, with the same small-angle
branch at ||w|| < 1e-5.  Here the branch is a `jnp.where` (both branches are
always computed — XLA-friendly, no data-dependent control flow) and everything
is batched/vmap-able.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_SMALL = 1e-5


def _hat(w):
    """Skew-symmetric matrix of a 3-vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def rodrigues(w: jnp.ndarray) -> jnp.ndarray:
    """R = I + v*[w]x + u*[w]x^2 with u=(1 - cos t)/t^2, v=sin t / t.

    The classic Rodrigues formula; algebraically identical to the reference's
    expansion (stage5_optimization.cpp:100-123, which writes u with the
    opposite sign against -[w]x^2 terms). Small-angle: R = I + [w]x.
    """
    t2 = jnp.sum(w * w, axis=-1)
    t = jnp.sqrt(t2)
    small = t < _SMALL
    # guard against 0/0; the small branch result is selected there anyway
    safe_t2 = jnp.where(small, 1.0, t2)
    u = jnp.where(small, 0.5, (1.0 - jnp.cos(t)) / safe_t2)
    v = jnp.where(small, 1.0, jnp.sin(t) / jnp.where(small, 1.0, t))
    K = _hat(w)
    K2 = K @ K
    eye = jnp.eye(3, dtype=w.dtype)
    R_full = eye + v[..., None, None] * K + u[..., None, None] * K2
    R_small = eye + K
    return jnp.where(small[..., None, None], R_small, R_full)


def rodrigues_with_grad(w: jnp.ndarray):
    """Return (R, dR) where dR[k] = dR/dw_k, each 3x3.

    Closed-form derivative algebra mirroring stage5_optimization.cpp:100-163,
    with the small-angle constant derivatives of :65-96. Validated against
    jax.jacfwd in tests/test_geometry.py.
    """
    w1, w2, w3 = w[0], w[1], w[2]
    t2 = w1 * w1 + w2 * w2 + w3 * w3
    t = jnp.sqrt(t2)
    small = t < _SMALL

    safe_t = jnp.where(small, 1.0, t)
    safe_t2 = jnp.where(small, 1.0, t2)
    safe_t3 = safe_t2 * safe_t
    safe_t4 = safe_t2 * safe_t2
    sin_t = jnp.sin(t)
    cos_t = jnp.cos(t)

    # u = (1 - cos t)/t^2 (the reference uses the negated u against -K^2,
    # stage5_optimization.cpp:102-105; same algebra)
    u = (1.0 - cos_t) / safe_t2
    v = sin_t / safe_t
    # du/dw_k = ((sin t / t) * t^2 - (1 - cos t) * 2) / t^4 * w_k
    du = ((sin_t / safe_t) * safe_t2 - (1.0 - cos_t) * 2.0) / safe_t4 * w
    # dv/dw_k = w_k (t cos t - sin t) / t^3
    dv = (safe_t * cos_t - sin_t) / safe_t3 * w

    K = _hat(w)
    K2 = K @ K

    eye = jnp.eye(3, dtype=w.dtype)
    R_full = eye + v * K + u * K2

    # dK/dw_k are constant basis matrices
    E = jnp.stack([_hat(jnp.eye(3, dtype=w.dtype)[k]) for k in range(3)])  # [3,3,3]
    # d(K^2)/dw_k = E_k K + K E_k
    dK2 = jnp.einsum("kij,jl->kil", E, K) + jnp.einsum("ij,kjl->kil", K, E)
    dR_full = (
        dv[:, None, None] * K[None]
        + v * E
        + du[:, None, None] * K2[None]
        + u * dK2
    )

    R_small = eye + K
    dR_small = E  # d(I + [w]x)/dw_k = E_k

    R = jnp.where(small, R_small, R_full)
    dR = jnp.where(small, dR_small, dR_full)
    return R, dR


def rotvec_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues: rotation vector from a 3x3 rotation matrix.

    Uses the quaternion route for numerical robustness near pi; fully
    branch-free (all four quaternion extraction cases are computed and the
    best-conditioned one selected).
    """
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternion extractions (w-, x-, y-, z-major).
    def cand_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])

    def cand_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])

    def cand_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])

    def cand_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    cands = jnp.stack([cand_w(), cand_x(), cand_y(), cand_z()])
    scores = jnp.stack([tr, m00, m11, m22])
    q = cands[jnp.argmax(scores)]
    q = q / jnp.linalg.norm(q)
    # enforce w >= 0 for the shortest rotation
    q = jnp.where(q[0] < 0, -q, q)
    qw = jnp.clip(q[0], -1.0, 1.0)
    angle = 2.0 * jnp.arccos(qw)
    s = jnp.sqrt(jnp.maximum(1.0 - qw * qw, 0.0))
    axis = jnp.where(s < 1e-7, jnp.array([1.0, 0.0, 0.0], dtype=R.dtype), q[1:] / jnp.where(s < 1e-7, 1.0, s))
    return axis * angle
