"""Tiny fixed-size linear solves, unrolled into elementwise ops.

XLA's generic batched LU (jnp.linalg.solve) lowers to loopy kernels that
are slow for batches of 6x6 systems; the LM refinement (refine/gauss_newton.py)
solves one damped-normal-equations system per candidate per iteration, so
an unrolled Cholesky (statically 6 steps of elementwise ops, fully
vmappable) is the right shape for the hardware.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-20


def solve_spd6(A, b):
    """Solve A x = b for symmetric positive-definite 6x6 A (batched).

    A: (..., 6, 6), b: (..., 6). Unrolled Cholesky + forward/back
    substitution; singular/indefinite inputs are guarded with a tiny
    diagonal floor (callers add LM damping anyway).
    """
    n = 6
    # Cholesky: L lower-triangular, A = L L^T
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(jnp.maximum(s, _EPS))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv

    # forward substitution: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    # back substitution: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]

    return jnp.stack(x, axis=-1)
