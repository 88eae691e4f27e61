"""Batched 9x9 PSD null-vector extraction for RANSAC, in plain jnp.

The 8-point fundamental-matrix solve (rso.solver.ransac._solve_eight_point)
needs the 0-eigenvector of M = A^T A, a rank-<=8 PSD 9x9 matrix, for every
RANSAC hypothesis: two rounds of inverse iteration on a regularized M, with
one batched Cholesky library call for the factor and the triangular solves
unrolled as elementwise ops over the [B] hypothesis axis.

On the H100 an unrolled, pivot-floored LDL^T of the whole recursion was
2.8x faster than this form timed alone but made the full step 15% slower,
so this form stays (PERF.md, PR 1).  Accuracy vs float64 eigh:
tests/test_kernels.py::TestNullvec9.
"""
from __future__ import annotations

import jax.numpy as jnp

_N = 9


def nullvec9(M: jnp.ndarray) -> jnp.ndarray:
    """[B,9,9] PSD rank-<=8 -> [B,9] unit approximate null vectors:
    regularized batched Cholesky + unrolled forward/backward substitution,
    two rounds of inverse iteration."""
    B = M.shape[0]
    # 3e-7*tr keeps the smallest pivot comfortably positive for f32 potrf
    # (cond ~3e6); still ≪ the smallest nonzero eigenvalue of a usable
    # hypothesis, so inverse iteration stays locked on the null direction.
    eps = 3e-7 * jnp.trace(M, axis1=-2, axis2=-1)[..., None, None] + 1e-12
    L = jnp.linalg.cholesky(M + eps * jnp.eye(_N, dtype=M.dtype))
    x = jnp.full((B, _N), 1.0 / 3.0, M.dtype)
    for _ in range(2):
        y = _cho_solve_unrolled(L, x)
        x = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return x


def _cho_solve_unrolled(L, b):
    """(L L^T)^{-1} b by unrolled substitution; [B,9,9],[B,9] -> [B,9].

    Substitution is numerically benign (the f32 fragility that rules out an
    unrolled *factorization* is in forming the last pivots); unrolling avoids
    four triangular-solve library calls per cho_solve pair.
    """
    n = L.shape[-1]
    ys = []
    for i in range(n):                       # L y = b
        acc = b[..., i]
        for j in range(i):
            acc = acc - L[..., i, j] * ys[j]
        ys.append(acc / L[..., i, i])
    y = jnp.stack(ys, axis=-1)
    # renormalize between the half-solves: inverse iteration is direction-
    # only, and this bounds magnitudes so near-floored pivots cannot push
    # the backward solve to f32 overflow
    y = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    xs = [None] * n
    for i in reversed(range(n)):             # L^T x = y
        acc = y[..., i]
        for j in range(i + 1, n):
            acc = acc - L[..., j, i] * xs[j]
        xs[i] = acc / L[..., i, i]
    return jnp.stack(xs, axis=-1)
