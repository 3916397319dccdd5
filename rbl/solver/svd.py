"""Truncated SVD via randomized block Lanczos — first-class front-end.

The reference computes truncated SVDs through the normal equations: RBL on
the Gram matrix BᵀB gives σ² and the right singular vectors V, and the left
factor follows as U = B·V/σ (images.jl:21-25, where the Gram matrix is
formed densely and the recovery is inlined in the demo script).  ``rbl_svd``
packages that pattern as a solver API:

- **matrix-free Gram operator** (ops/spmm/operator.py GramOperator): BᵀB is
  never materialized — O(m·n) HBM instead of O(n²)+O(m·n), and each apply is
  two chained GEMMs;
- **small-side selection**: for m < n the solve runs on B·Bᵀ (m×m Krylov
  vectors) and recovers V = Bᵀ·U/σ instead — the reference demo hardcodes
  the BᵀB side;
- **σ≈0 guarding**: Ritz values of a Gram operator are σ² ≥ 0 up to
  rounding; values at/below the floor are clamped and their cross-factor
  columns zeroed rather than divided into garbage.

Caveat inherited from the normal equations (and from the reference): the
Gram matrix SQUARES the spectrum, so σ smaller than ~√eps·σ₁ fall below the
compute dtype's resolvable range — run f64 for wide spectra, exactly as
images.jl does (it keeps Float64 throughout).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RBLConfig
from ..ops.spmm.operator import GramOperator, _pet


@dataclasses.dataclass
class SVDResult:
    U: jax.Array            # (m, k) left singular vectors
    s: np.ndarray           # (k,) singular values, descending; entries at
    #                         the normal-equations noise floor clamped to 0
    V: jax.Array            # (n, k) right singular vectors
    iterations: int
    kryl_dim: int
    converged: bool


@partial(jax.jit, static_argnames=("transpose",))
def _cross_recover(B, W, sigma, floor, transpose: bool = False):
    """The other singular factor: X = (B·W)/σ (or BᵀW), with σ ≤ floor
    columns zeroed instead of divided."""
    acc = _pet(W.dtype)
    M = B.T if transpose else B
    X = jnp.dot(M, W.astype(M.dtype), preferred_element_type=acc)
    safe = jnp.where(sigma > floor, sigma, jnp.ones_like(sigma))
    return jnp.where(sigma[None, :] > floor, X / safe[None, :], 0.0)


@jax.jit
def _cross_recover_sparse(Bop, W, sigma, floor):
    """Sparse-factor cross recovery: X = Bop(W)/σ with the same σ ≤ floor
    guarding (Bop is the pre-sorted rectangular COO factor pytree)."""
    X = Bop.apply(W.astype(Bop.dtype))
    safe = jnp.where(sigma > floor, sigma, jnp.ones_like(sigma))
    return jnp.where(sigma[None, :] > floor, X / safe[None, :], 0.0)


def _solve_gram(op, k, b, cfg, timer, v0, which):
    """Run the block Lanczos on the Gram-side operator: LM directly, SM
    through the σ = 0 blocked-MINRES shift-invert transform (the Gram is
    SPD, so the inner MINRES is a definite solve; B rank-deficient ⇒ the
    Gram is singular at σ = 0 and the inner solve stalls — same failure
    mode as ARPACK shift-invert on a singular pencil)."""
    from .rbl import rbl

    if which == "SM":
        from ..ops.minres import ShiftInvertOperator, default_inner_tol

        si = ShiftInvertOperator.shift(
            op, 0.0, inner_tol=default_inner_tol(op.dtype, cfg.tol)
        )
        return rbl(si, k, b, cfg=cfg, compute_eigenvectors=True,
                   timer=timer, v0=v0)
    return rbl(op, k, b, cfg=cfg, compute_eigenvectors=True,
               timer=timer, v0=v0)


def rbl_svd(
    B: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    timer=None,
    v0: Optional[Any] = None,
    which: str = "LM",
) -> SVDResult:
    """Top-k truncated SVD of a dense (m, n) factor B: B ≈ U·diag(s)·Vᵀ.

    Runs randomized block Lanczos on the matrix-free Gram operator of B's
    smaller side and recovers the cross factor with one GEMM (the
    reference's images.jl:21-25 pattern, lifted out of the demo script).

    ``v0`` (scipy ``svds`` convention) seeds the first column of the
    sampling block on the Gram side: length ``min(m, n)``.

    ``which="SM"`` returns the k SMALLEST singular triplets (scipy's
    ``svds(which="SM")``) via σ = 0 shift-invert on the Gram operator —
    blocked MINRES inside, never factoring B.  Singular values are
    recovered as the cross-product column norms σ = ‖B·w‖ (exact for exact
    singular vectors, first-order accurate in the Ritz error — more robust
    than √λ followed by a division at the small end of the spectrum).
    The normal-equations resolvability floor √(eps·dim)·σ₁ still applies:
    smaller σ are reported as 0 (run f64 to push the floor down).
    """
    which = which.upper()
    if which not in ("LM", "SM"):
        raise ValueError(f"which={which!r} not in ('LM', 'SM')")
    cfg = cfg or RBLConfig()
    # A scipy-sparse factor stays sparse: the Gram operator chains two
    # rectangular COO SpMMs instead of densifying B (which at images-demo
    # sizes is fine but defeats svds-style use on large sparse factors).
    # The mesh path keeps the dense layout — the sharded Gram contraction
    # is expressed through B's dense sharding spec below.
    if hasattr(B, "tocsr"):
        m, n = B.shape
        if not (0 < k <= min(m, n)):
            raise ValueError(f"k={k} out of range for shape {B.shape}")
        left = m < n  # solve the smaller Gram side
        from ..ops.spmm.operator import SparseGramOperator

        op = None
        if cfg.mesh is None:
            op = SparseGramOperator.from_scipy(
                B, dtype=cfg.compute_dtype, left=left
            )
        else:
            # mesh: row-partitioned rectangular COO factors (forward +
            # transpose), each all-gathering its input block over NVLink —
            # the sparse twin of the dense sharded-B path below.  Falls
            # through to densification when the dims don't divide the mesh.
            try:
                import scipy.sparse as sp

                from ..parallel.dist_spmm import ShardedRectCooSpMM

                Bc = sp.csr_matrix(B)
                Bf = ShardedRectCooSpMM.from_scipy(
                    Bc, cfg.mesh, axis=cfg.rows_axis, dtype=cfg.compute_dtype
                )
                Bt = ShardedRectCooSpMM.from_scipy(
                    Bc.T.tocsr(), cfg.mesh, axis=cfg.rows_axis,
                    dtype=cfg.compute_dtype,
                )
                op = SparseGramOperator(Bf=Bf, Bt=Bt, left=left)
            except ValueError:
                op = None
        if op is not None:
            res = _solve_gram(op, k, b, cfg, timer, v0, which)
            if which == "SM":
                return _assemble_svd_sm(res, cfg, m, n, left, op=op)
            return _assemble_svd(res, k, cfg, m, n, left, op=op)
    Bd = jnp.asarray(
        B.toarray() if hasattr(B, "toarray") else B, dtype=cfg.compute_dtype
    )
    if Bd.ndim != 2:
        raise ValueError(f"B must be 2-D, got shape {Bd.shape}")
    m, n = Bd.shape
    if not (0 < k <= min(m, n)):
        raise ValueError(f"k={k} out of range for shape {Bd.shape}")
    left = m < n  # solve the smaller Gram side
    if cfg.mesh is not None:
        # Shard B over the Gram dimension (the solver's row axis): the
        # inner contraction BᵀX / BX then reduces over the sharded axis
        # and GSPMD inserts the psum — the n×n (or m×m) Gram operator
        # rides the mesh exactly like an explicit row-partitioned A.
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P(cfg.rows_axis, None) if left else P(None, cfg.rows_axis)
        Bd = jax.device_put(Bd, NamedSharding(cfg.mesh, spec))
    op = GramOperator(B=Bd, left=left)
    res = _solve_gram(op, k, b, cfg, timer, v0, which)
    if which == "SM":
        return _assemble_svd_sm(res, cfg, m, n, left, Bd=Bd)
    return _assemble_svd(res, k, cfg, m, n, left, Bd=Bd)


def _assemble_svd_sm(res, cfg, m, n, left, op=None, Bd=None):
    """SM-end assembly: σ from cross-product column norms ‖B·w‖ (never a
    division by a tiny Ritz-derived σ), with the same normal-equations
    floor as the LM path — σ₁ for the floor comes from a power-method
    bound on the Gram operator since the solve only saw the small end."""
    import jax as _jax

    from ..ops.eig import spectral_norm_bound

    W = res.eigenvectors  # (gram-side, k) orthonormal
    if Bd is not None:
        M = Bd.T if left else Bd
        X = jnp.dot(M, W.astype(M.dtype), preferred_element_type=_pet(W.dtype))
        gop = GramOperator(B=Bd, left=left)
    else:
        cross = op.Bt if left else op.Bf
        X = cross.apply(W.astype(cross.dtype))
        gop = op
    X = np.asarray(X, dtype=np.float64)
    s = np.linalg.norm(X, axis=0)
    sigma1 = float(
        np.sqrt(max(spectral_norm_bound(gop, _jax.random.PRNGKey(cfg.seed + 2)),
                    0.0))
    )
    eps = float(np.finfo(np.dtype(cfg.compute_dtype)).eps)
    floor = np.sqrt(eps * max(m, n)) * max(sigma1, np.finfo(np.float64).tiny)
    keep = s > floor
    X = np.where(keep[None, :], X / np.where(keep, s, 1.0)[None, :], 0.0)
    s = np.where(keep, s, 0.0)
    order = np.argsort(-s, kind="stable")  # SVDResult contract: descending
    s = s[order]
    X = jnp.asarray(X[:, order])
    W = jnp.take(W, jnp.asarray(order), axis=1)
    U, V = (W, X) if left else (X, W)
    return SVDResult(U=U, s=s, V=V, iterations=res.iterations,
                     kryl_dim=res.kryl_dim, converged=res.converged)


def _assemble_svd(res, k, cfg, m, n, left, op=None, Bd=None):
    """σ = √λ with noise-floor guarding, descending re-sort, and the
    cross-factor recovery (dense ``Bd`` or sparse ``op`` path)."""
    sig2 = np.maximum(res.eigenvalues, 0.0)  # Ritz values of BᵀB are σ²≥0
    sigma = np.sqrt(sig2)
    # Below floor, W's directions are (numerical) null-space of B: their
    # cross-factor columns are rounding noise scaled by 1/σ — zero them.
    # The floor is the normal-equations resolvability limit: the Gram's
    # rounding is O(dim·eps·σ₁²) in λ, i.e. √(dim·eps)·σ₁ in σ — anything
    # at that level is indistinguishable from null space in this scheme.
    eps = float(np.finfo(np.dtype(cfg.compute_dtype)).eps)
    floor = np.sqrt(eps * max(m, n)) * max(
        sigma[0] if len(sigma) else 0.0, np.finfo(np.float64).tiny
    )
    # Honor the documented contract: σ at/below the floor clamp to 0, and
    # s comes back descending.  Without the re-sort a tiny negative Ritz
    # value (→ σ = 0) can precede a tinier positive one under the solver's
    # |λ| ordering, breaking callers that truncate at the first
    # below-threshold entry.
    sigma = np.where(sigma > floor, sigma, 0.0)
    order = np.argsort(-sigma, kind="stable")
    sigma = sigma[order]
    W = jnp.take(res.eigenvectors, jnp.asarray(order), axis=1)
    # left (m<n): W = U, recover V = Bᵀ·U/σ; else W = V, recover U = B·V/σ
    if Bd is not None:
        sj = jnp.asarray(sigma, dtype=Bd.dtype)
        X = _cross_recover(Bd, W, sj, floor, transpose=left)
    else:
        cross = op.Bt if left else op.Bf
        sj = jnp.asarray(sigma, dtype=op.dtype)
        X = _cross_recover_sparse(cross, W, sj, floor)
    U, V = (W, X) if left else (X, W)
    return SVDResult(
        U=U,
        s=sigma,
        V=V,
        iterations=res.iterations,
        kryl_dim=res.kryl_dim,
        converged=res.converged,
    )
