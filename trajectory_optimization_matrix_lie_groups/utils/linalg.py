"""Small-matrix linear algebra that lowers on every backend/dtype.

The matrices in this framework are tiny (3x3 inertia blocks, 6x6/nu x nu
Quu), so an unrolled Cholesky built purely from elementwise ops + stacks
lowers for every dtype on every backend, with no LAPACK/solver custom
calls, and is faster than a generic LU.

`setup_inv` covers the one place a true inverse is needed — setup-time
inertia constants — by computing on the host in f64 when the operand is
concrete (the reference's equivalents are `np.linalg.inv` calls at
construction, e.g. `traopt_dynamics.py:700`).
"""

import numpy as np

import jax
import jax.numpy as jnp


def setup_inv(M):
    """Inverse of a small concrete setup-time matrix, computed on host.

    Falls back to `jnp.linalg.inv` when `M` is a tracer.
    """
    if isinstance(M, jax.core.Tracer):
        return jnp.linalg.inv(M)
    Mn = np.asarray(M)
    return jnp.asarray(np.linalg.inv(Mn.astype(np.float64)), Mn.dtype)


def chol_solve_psd(A, B):
    """Solve A X = B for symmetric PD A, batched over leading dims.

    A: (..., n, n), B: (..., n, m) or (..., n).  Unrolled Cholesky +
    forward/back substitution in elementwise ops only — no LAPACK custom
    calls, so it compiles for every dtype on every backend.
    n is static and expected tiny (<= 12).
    """
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    # Cholesky: L strictly computed column-by-column (unrolled)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        inv_jj = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_jj
    # forward substitution  L Y = B
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * Y[k]
        Y[i] = s / L[i][i][..., None]
    # back substitution  L^T X = Y
    X = [None] * n
    for i in reversed(range(n)):
        s = Y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * X[k]
        X[i] = s / L[i][i][..., None]
    out = jnp.stack(X, axis=-2)
    return out[..., 0] if vec else out
