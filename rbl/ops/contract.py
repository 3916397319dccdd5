"""Accuracy-preserving long-axis contractions.

Every convergence-critical Gram / projection in the solver contracts over the
row dimension n (A_i = Q_iᵀU, reorthogonalization Grams, CholQR Grams).  A
single flat dot accumulates rounding linearly in n — measurably ~50× worse
under XLA:CPU f64 than LAPACK's blocked BLAS, and enough to break the 1e-13
eigenvalue gate at n = 10⁵⁻⁶ (the reference reaches that accuracy through
OpenBLAS's register-blocked accumulation, RBL.jl:7-8).

``gram`` restores (and improves on) blocked accumulation portably: the row
axis is split into fixed chunks, each chunk contracted as one batched
dot_general, and the ~n/chunk partials reduced pairwise.
Error drops from O(n·eps) to O((chunk + n/chunk)·eps) worst-case.
"""

from __future__ import annotations

import jax.numpy as jnp

from .spmm.operator import _pet

_CHUNK = 8192


def _pairwise_sum(P):
    """Pairwise (tree) reduction over axis 0 of the (c, p, q) partials."""
    while P.shape[0] > 1:
        c = P.shape[0]
        half = c // 2
        even = P[: 2 * half : 2]
        odd = P[1 : 2 * half : 2]
        tail = P[2 * half :]
        P = jnp.concatenate([even + odd, tail], axis=0)
    return P[0]


def gram(X, Y, chunk: int = _CHUNK, acc_dtype=None):
    """XᵀY with two-level row-chunked accumulation.  X: (n, p), Y: (n, q)."""
    n, p = X.shape
    q = Y.shape[1]
    acc = acc_dtype or _pet(jnp.result_type(X.dtype, Y.dtype))
    if n <= chunk:
        return jnp.dot(X.T, Y, preferred_element_type=acc)
    c = -(-n // chunk)
    pad = c * chunk - n
    if pad:
        X = jnp.pad(X, ((0, pad), (0, 0)))
        Y = jnp.pad(Y, ((0, pad), (0, 0)))
    Xc = X.reshape(c, chunk, p)
    Yc = Y.reshape(c, chunk, q)
    P = jnp.einsum("cnp,cnq->cpq", Xc, Yc, preferred_element_type=acc)
    return _pairwise_sum(P.astype(acc))

