"""Tall-skinny QR / block orthonormalization.

The reference leans on LAPACK geqrf (RBL.jl:86,103) and CUSOLVER qr
(RBL_gpu.jl:155,180) for the n×b residual block.  Here the two choices
are:

- "householder": XLA's QR (jnp.linalg.qr) — bitwise-robust, used for the
  strict f64 accuracy gates.
- "cholqr2": CholeskyQR2 — G = XᵀX (one GEMM, psum-reduced when X is
  row-sharded), Cholesky of the b×b Gram on every device, triangular solve,
  repeated twice.  O(eps) orthogonality for κ(X) ≲ eps^-1/2 and runs at
  matmul speed; the natural distributed tall-skinny QR (single b×b
  collective instead of gathering the n×b block).

A small symmetric shift (shifted CholeskyQR) guards against breakdown when
the residual block is numerically rank-deficient — a case the reference never
handles (SURVEY §5: no breakdown handling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .spmm.operator import _pet


def _chol_qr_once(X, acc_dtype):
    from .contract import gram

    n, b = X.shape
    from .contract import _CHUNK

    # The Gram pins the factorization's entire accuracy — compute it at
    # HIGHEST matmul precision regardless of the ambient context: a
    # reduced-precision Gram (TF32 on the GPU) loses digits of ‖QᵀQ−I‖
    # that the factorization cannot recover.  The b×b Gram is a sliver of
    # the solve's FLOPs.
    with jax.default_matmul_precision("highest"):
        G = gram(X, X, acc_dtype=acc_dtype)
    eps = jnp.finfo(acc_dtype).eps
    L = jnp.linalg.cholesky(G)
    # Fall back to a shifted Cholesky only on breakdown (nearly
    # rank-deficient X): the shift keeps G positive definite under rounding
    # at the cost of O(shift/σ_min²) orthogonality, which the next pass or
    # the enclosing CGS sweep repairs.  The error-size factor reflects
    # gram's chunked PAIRWISE accumulation (error ~ eps·chunk, not eps·n —
    # the literature's 11·(nb+…)·u·tr(G) shift assumes a flat sum and at
    # f32, n = 2M it EXCEEDS ‖G‖, which poisoned every factorization).
    # The absolute tiny-floor covers X ≈ 0 (a fully deflated residual
    # block), where a trace-proportional shift vanishes and the Cholesky
    # of ~0 yields NaN.
    err_rows = min(n, _CHUNK) * b + b * (b + 1)
    shift = (
        11.0 * err_rows * eps * jnp.trace(G) / b
        + jnp.finfo(acc_dtype).tiny * 1e4
    )
    L_shifted = jnp.linalg.cholesky(G + shift * jnp.eye(b, dtype=G.dtype))
    bad = jnp.any(jnp.isnan(L))
    R = jnp.where(bad, L_shifted, L).T  # upper triangular
    # Clamp vanishing diagonal entries before the solve: a ~0 pivot turns a
    # degenerate column into an unbounded one, whose norm then SQUARES in
    # downstream Grams (f32 overflows to inf within two iterations —
    # measured on an image Gram with σ₁²/σ₂² ≈ 700).  With the clamp a
    # degenerate column comes out ≈ 0; the solver's host-side collapse
    # detection then handles the breakdown properly.  The floor must sit
    # BETWEEN healthy pivots and rounding garbage: √eps on the average
    # column scale — a floor derived from the (much larger) PD shift
    # clamped every healthy pivot at f32 large n, silently destroying
    # orthonormality of every block.
    floor = (jnp.sqrt(eps * jnp.trace(G) / b) + jnp.finfo(acc_dtype).tiny)
    d = jnp.abs(jnp.diagonal(R))
    R_solve = R + jnp.diag(
        jnp.where(d < floor, floor, jnp.zeros_like(d)).astype(R.dtype)
    )
    Q = jax.lax.linalg.triangular_solve(
        R_solve.astype(X.dtype), X, left_side=False, lower=False
    )
    return Q, R


def cholqr(X, passes: int = 2):
    """CholeskyQR with `passes` refinement sweeps. Returns (Q, R) with
    X = Q @ R, R upper-triangular (product of per-pass factors).

    The first pass runs on column-equilibrated X: with mixed column scales
    (e.g. a converged-direction ghost at ‖A‖ scale next to sea-level
    residual columns) the Gram's small diagonal entries drown in the
    rounding of the large ones (eps·max² ≫ min²) and the factor comes out
    garbage — measured in f32 at a 10⁵ column-scale ratio: Q far from
    orthonormal, ‖B‖ running away geometrically.  Scaling columns to unit
    norm bounds the Gram's dynamic range by inter-column angles only; the
    scales are absorbed into R (X = X̂·D, X̂ = Q·R̂ ⇒ R = R̂·D)."""
    acc = _pet(X.dtype)
    d = jnp.sqrt(jnp.sum(X.astype(acc) * X.astype(acc), axis=0))
    d_safe = jnp.where(d > 0, d, jnp.ones_like(d))
    Q, R = _chol_qr_once(X / d_safe.astype(X.dtype)[None, :], acc)
    R = R * d_safe.astype(R.dtype)[None, :]
    for _ in range(passes - 1):
        Q, R2 = _chol_qr_once(Q, acc)
        R = jnp.dot(R2, R, preferred_element_type=acc)
    return Q, R.astype(X.dtype)


def householder_qr(X):
    Q, R = jnp.linalg.qr(X, mode="reduced")
    return Q, R


def block_qr(X, method: str = "householder"):
    """Orthonormalize the columns of the tall-skinny block X.

    Returns (Q, R): the reference consumes Q as the next Lanczos block and
    R as the super-/sub-diagonal block B_i of T (RBL.jl:86-88)."""
    if method == "householder":
        return householder_qr(X)
    if method == "cholqr2":
        return cholqr(X, passes=2)
    if method == "cholqr3":
        return cholqr(X, passes=3)
    raise ValueError(f"unknown qr method: {method}")
