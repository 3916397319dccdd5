"""Fast-diagonalization (FDM) exact shifted solves for Kronecker-sum
operators — the factorization-free analogue of ARPACK's factorized
shift-invert.

The model stencil operators are Kronecker sums (Laplacian2D = L⊗I + I⊗L,
Laplacian3D likewise — ops/spmm/operator.py:291,330, mirroring the
reference's benchmark surface, Julia/benchmark.jl:42's ARPACK shift-invert
semantics).  Such operators diagonalize separably: with L = QΛQᵀ,

    (A − σI)⁻¹ = (Q⊗Q) diag(λᵢ + λⱼ − σ)⁻¹ (Q⊗Q)ᵀ,

so a SHIFTED SOLVE is exact in 2d dense (n^{1/d}·n^{1/d}) × (n^{1/d}·b)
matmuls — pure GEMM work, no iteration.  For the 512² grid that is four
512×512 @ 512×(512·b) products per apply, replacing an inner MINRES run
of hundreds of SpMM iterations.  Where ARPACK needs a sparse LU of
(A − σI), this needs nothing factored and runs at matmul speed-of-light;
it is also valid at ANY shift (interior σ included — the preconditioned-
iteration tier only wins near the bottom of the spectrum).

The 1-D Dirichlet factors have the analytic eigensystem
λ_k = 2 − 2cos(kπ/(n+1)), Q[i,k] = √(2/(n+1))·sin((i+1)(k+1)π/(n+1)),
so construction is closed-form (no LAPACK call).

``ShiftInvertOperator(precond="auto")`` resolves to this first
(ops/minres._resolve_auto); the V-cycle (ops/multigrid.py) remains the
tier for structured operators that are not Kronecker sums.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["fdm_solver_for"]


@functools.lru_cache(maxsize=16)
def _dirichlet_eig_1d(n: int):
    """Analytic eigensystem of tridiag(-1, 2, -1) (n points, Dirichlet
    at virtual points 0 and n+1).  Returns (lam (n,), Q (n, n)) float64;
    Q orthonormal, A = Q diag(lam) Qᵀ."""
    k = np.arange(1, n + 1)
    lam = 2.0 - 2.0 * np.cos(np.pi * k / (n + 1))
    i = np.arange(1, n + 1)
    Q = np.sqrt(2.0 / (n + 1)) * np.sin(np.pi * np.outer(i, k) / (n + 1))
    return lam, Q


def _solver_2d(nx: int, ny: int, dtype):
    lamx, Qx = _dirichlet_eig_1d(nx)
    lamy, Qy = _dirichlet_eig_1d(ny)

    def solve(X: jax.Array, sigma) -> jax.Array:
        dt = X.dtype
        qx = jnp.asarray(Qx, dtype=dt)
        qy = jnp.asarray(Qy, dtype=dt)
        den = (jnp.asarray(lamx[:, None], dt) + jnp.asarray(lamy[None, :], dt)
               - jnp.asarray(sigma, dt))
        b = X.shape[1]
        G = X.reshape(nx, ny, b)
        # forward transform (Qᵀ along each axis), pointwise solve, back
        T = jnp.einsum("pi,pjb->ijb", qx, G, preferred_element_type=dt)
        T = jnp.einsum("qj,iqb->ijb", qy, T, preferred_element_type=dt)
        T = T / den[:, :, None]
        T = jnp.einsum("qj,ijb->iqb", qy, T, preferred_element_type=dt)
        T = jnp.einsum("pi,iqb->pqb", qx, T, preferred_element_type=dt)
        return T.reshape(nx * ny, b)

    return solve


def _solver_3d(nx: int, ny: int, nz: int, dtype):
    lamx, Qx = _dirichlet_eig_1d(nx)
    lamy, Qy = _dirichlet_eig_1d(ny)
    lamz, Qz = _dirichlet_eig_1d(nz)

    def solve(X: jax.Array, sigma) -> jax.Array:
        dt = X.dtype
        qx = jnp.asarray(Qx, dtype=dt)
        qy = jnp.asarray(Qy, dtype=dt)
        qz = jnp.asarray(Qz, dtype=dt)
        den = (jnp.asarray(lamx[:, None, None], dt)
               + jnp.asarray(lamy[None, :, None], dt)
               + jnp.asarray(lamz[None, None, :], dt)
               - jnp.asarray(sigma, dt))
        b = X.shape[1]
        G = X.reshape(nx, ny, nz, b)
        T = jnp.einsum("pi,pjkb->ijkb", qx, G, preferred_element_type=dt)
        T = jnp.einsum("qj,iqkb->ijkb", qy, T, preferred_element_type=dt)
        T = jnp.einsum("rk,ijrb->ijkb", qz, T, preferred_element_type=dt)
        T = T / den[:, :, :, None]
        T = jnp.einsum("rk,ijkb->ijrb", qz, T, preferred_element_type=dt)
        T = jnp.einsum("qj,ijkb->iqkb", qy, T, preferred_element_type=dt)
        T = jnp.einsum("pi,ijkb->pjkb", qx, T, preferred_element_type=dt)
        return T.reshape(nx * ny * nz, b)

    return solve


def fdm_min_shift_gap(op, sigma: float):
    """min |λ(A) − σ| for a supported Kronecker-sum operator (None if
    unsupported).  The FDM solve divides by these gaps — a σ that hits
    an eigenvalue exactly (it happens on the model Laplacians: e.g.
    σ = 3 on a 64² grid via cos(π/5) − cos(2π/5) = ½) must be rejected
    with a clear error instead of NaN-poisoning the sweep."""
    from .spmm.operator import Laplacian2D, Laplacian3D

    if isinstance(op, Laplacian2D):
        lx, _ = _dirichlet_eig_1d(op.nx)
        ly, _ = _dirichlet_eig_1d(op.ny)
        lam = np.add.outer(lx, ly)
    elif isinstance(op, Laplacian3D):
        lx, _ = _dirichlet_eig_1d(op.nx)
        ly, _ = _dirichlet_eig_1d(op.ny)
        lz, _ = _dirichlet_eig_1d(op.nz)
        lam = np.add.outer(np.add.outer(lx, ly), lz)
    else:
        return None
    return float(np.abs(lam - sigma).min())


def _with_refinement(base_solve, op, n_refine: int = 3):
    """f64 solves run the TRANSFORMS in f32 (half the bytes and the f32
    matmul rate) and recover f64
    accuracy by iterative refinement: x ← x + S₃₂(r), r = B − (A−σI)x
    with the residual in true f64 (a cheap stencil apply).  Each step
    contracts the error by ~κ(A−σI)·eps₃₂; the construction-time
    singular-σ guard (minres.shift) keeps κ finite, and three steps
    reach the f64 floor for κ up to ~1e5."""

    def solve(X, sigma):
        if X.dtype != jnp.float64:
            return base_solve(X, sigma)
        sig64 = jnp.asarray(sigma, jnp.float64)
        x = base_solve(X.astype(jnp.float32), sigma).astype(jnp.float64)
        for _ in range(n_refine):
            r = X - (op.apply(x) - sig64 * x)
            x = x + base_solve(
                r.astype(jnp.float32), sigma
            ).astype(jnp.float64)
        return x

    return solve


def fdm_solver_for(op):
    """Return an exact shifted-solve ``solve(X, sigma) -> (A−σI)⁻¹X`` for
    a supported Kronecker-sum operator, or None.  ``sigma`` may be a
    traced 0-d array (it only enters the pointwise denominators, so one
    compiled solve serves every shift).  f64 inputs run f32
    transforms + iterative refinement (see _with_refinement)."""
    from .spmm.operator import Laplacian2D, Laplacian3D

    if isinstance(op, Laplacian2D):
        return _with_refinement(_solver_2d(op.nx, op.ny, op.dtype), op)
    if isinstance(op, Laplacian3D):
        return _with_refinement(
            _solver_3d(op.nx, op.ny, op.nz, op.dtype), op
        )
    return None
