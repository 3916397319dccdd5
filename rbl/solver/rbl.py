"""User-facing solver entry — the reference's `RBL(A, k, b)` / `RBL_gpu`
surface (RBL.jl:119-142, RBL_gpu.jl:205-221), as a single device-agnostic
function: the same code runs on one GPU, a CPU test mesh, or a
multi-device row-sharded mesh depending on cfg.mesh.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RBLConfig
from ..ops.spmm.operator import LinearOperator, as_operator
from ..parallel.memory import clamp_kryl_dim
from .basis import BasisStore
from .lanczos import (
    LanczosResult,
    lanczos_iteration,
    random_start_block,
    recover_eigvec,
)


def _row_sharding(cfg: RBLConfig):
    if cfg.mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(cfg.mesh, P(cfg.rows_axis, None))


def rbl(
    A: Any,
    k: int,
    b: Optional[int] = None,
    cfg: Optional[RBLConfig] = None,
    compute_eigenvectors: bool = True,
    which: str = "LM",
    timer=None,
    v0=None,
    deflate=None,
    norm_bound: Optional[float] = None,
) -> LanczosResult:
    """Compute k eigenpairs of the symmetric operator A with randomized
    block Lanczos.

    Parameters mirror the reference's ``RBL(A, k, b) -> (D, V)``
    (RBL.jl:119-142): A may be a LinearOperator, dense/diagonal array, or
    scipy sparse matrix; k is the number of eigenpairs; b the block size.

    which selects the spectrum end (beyond reference parity — the
    reference is LM-only, benchmark.jl:42):
      "LM" (default) — largest magnitude; eigenvalues descending by |λ|.
      "LA" — largest algebraic, descending; solved as LM of A + sI.
      "SA" — smallest algebraic, ascending; solved as LM of sI − A.
    For LA/SA the shift s ≥ ‖A‖₂ comes from a power-method bound, and the
    residual tolerance is relative to ‖A ± sI‖ ≈ 2‖A‖ (a factor ≈2 looser
    than the LM semantics).

    v0 optionally seeds the first column of the random sampling block Ω
    (the scipy ``eigsh(v0=...)`` surface); the other b−1 columns stay
    random.

    norm_bound optionally supplies an upper bound on ‖A‖₂ for the LA/SA
    spectral shift, replacing the power-method estimate (callers with
    analytic bounds skip ~24 operator applies; must be a TRUE upper
    bound — see the inline note).

    deflate optionally supplies an (n, j) block of known eigenvectors (or
    any directions) to exclude: the sweep deflates every newborn residual
    against their orthonormalized span, so the returned k pairs are the
    dominant ones of the COMPLEMENT — incremental eigensolving ("give me
    the next k") without re-converging what is already known.  This is the
    restarted variant's internal lock set (restarted.jl:53-57 semantics,
    every-step here — see _sweep_chunk) opened up as an API.

    Returns a LanczosResult with (optionally) the matching Ritz vectors.
    """
    cfg = cfg or RBLConfig()
    if b is not None:
        cfg = cfg.replace(block_size=b)
    b = cfg.block_size
    op = as_operator(A, dtype=cfg.compute_dtype)
    n = op.n
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    which = which.upper()
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which={which!r} not in ('LM', 'LA', 'SA')")

    # GPU f32 matmuls at "default"/"high" run in TF32 (unit roundoff
    # 4.9e-4, above the √eps_f32 semi-orthogonality bar); "highest" keeps
    # IEEE f32, the reference's cuBLAS numerics.  Bound at trace time;
    # part of jit cache keys; no-op on CPU/f64.
    with jax.default_matmul_precision(cfg.matmul_precision):
        shift = 0.0
        if which != "LM":
            from ..ops.eig import spectral_norm_bound
            from ..ops.spmm.operator import AffineOperator

            # norm_bound: a caller-supplied upper bound on ‖A‖₂, replacing
            # the power-method estimate — callers with analytic bounds
            # (e.g. rbl_generalized: ‖P·A·P‖ ≤ ‖A‖/λmin(M), avoiding ~24
            # applies of the EXPENSIVE transformed operator) size the
            # spectral shift for free.  Must be a true upper bound: an
            # undershoot can leave the wrong spectrum end dominant; an
            # overshoot only compresses relative gaps.
            if norm_bound is not None:
                shift = float(norm_bound)
            else:
                shift = spectral_norm_bound(
                    op, jax.random.PRNGKey(cfg.seed + 1)
                )
            op = AffineOperator.shift(
                op, 1.0 if which == "LA" else -1.0, shift
            )
        # Opt-in probe-on-fault retry (cfg.fault_retries, default 0: a
        # retry that follows a device fault would hide it)
        if cfg.fault_retries:
            from ..utils.probe import solve_with_retry

            res = solve_with_retry(
                _rbl_impl, op, k, cfg, compute_eigenvectors, timer, v0=v0,
                deflate=deflate, retries=cfg.fault_retries,
            )
        else:
            res = _rbl_impl(
                op, k, cfg, compute_eigenvectors, timer, v0=v0,
                deflate=deflate,
            )
        if which == "LA":
            res.eigenvalues = res.eigenvalues - shift
        elif which == "SA":
            # θ descending ↦ λ = s − θ ascending (natural SA order); the
            # vectors and residual norms are shift-invariant
            res.eigenvalues = shift - res.eigenvalues
        return res


def _rbl_impl(op, k, cfg, compute_eigenvectors, timer, v0=None, deflate=None):
    b = cfg.block_size
    n = op.n
    sharding = _row_sharding(cfg)
    if v0 is not None:
        v0 = jnp.asarray(v0).reshape(-1)
        if v0.shape[0] != n:
            raise ValueError(f"v0 has length {v0.shape[0]}, expected {n}")
    lock = None
    if deflate is not None:
        lock = jnp.asarray(deflate, dtype=cfg.compute_dtype)
        if lock.ndim == 1:
            lock = lock[:, None]
        if lock.ndim != 2 or lock.shape[0] != n:
            raise ValueError(
                f"deflate must be (n, j) with n={n}, got {lock.shape}"
            )
        # Orthonormalize the user-supplied span once via SVD and keep only
        # the NUMERICAL-RANK columns: plain QR of a rank-deficient span
        # (duplicated vectors, a zero column, spans accumulated across
        # solves) fills the dead columns with arbitrary orthonormal
        # directions, silently deflating eigenvectors the user never asked
        # to exclude.  One-time O(n·j²) host cost.
        u, sv, _ = np.linalg.svd(np.asarray(lock), full_matrices=False)
        tol = (sv[0] if sv.size else 0.0) * max(lock.shape) * np.finfo(np.float64).eps
        r = int(np.sum(sv > tol))
        if r == 0:
            lock = None
        else:
            # Zero-pad the lock to a bucketed width (power of two, min 8):
            # incremental next-k usage grows the deflate span by k per
            # call, and an exact-width lock would recompile the whole
            # sweep kernel family at every new width.  Padding columns
            # project nothing — the same
            # zero-padding contract as the restarted lock buffer.
            width = min(max(8, 1 << (r - 1).bit_length()), n)
            buf = np.zeros((n, width), dtype=u.dtype)
            buf[:, :r] = u[:, :r]
            lock = jnp.asarray(buf, dtype=cfg.basis_dtype)
            if sharding is not None:
                lock = jax.device_put(lock, sharding)
    max_kryl = clamp_kryl_dim(
        cfg.max_kryl_dim, n, b, cfg.basis_dtype, cfg.compute_dtype,
        n_devices=(cfg.mesh.devices.size if cfg.mesh is not None else 1),
        budget_fraction=cfg.hbm_budget_fraction,
    )
    if max_kryl < k:
        # The final Rayleigh–Ritz can produce at most max_kryl pairs;
        # proceeding would silently return fewer than k eigenpairs.
        raise ValueError(
            f"k={k} exceeds the Krylov cap {max_kryl} "
            f"({'HBM-clamped from ' + str(cfg.max_kryl_dim) if max_kryl < cfg.max_kryl_dim else 'cfg.max_kryl_dim'}) — "
            "raise max_kryl_dim, shrink the problem, or add devices"
        )
    cfg = cfg.replace(max_kryl_dim=max_kryl)

    key = jax.random.PRNGKey(cfg.seed)
    Qi = random_start_block(op, key, b, cfg, sharding=sharding, v0=v0)
    if lock is not None:
        # the start block must begin clean of the deflated span (the
        # restarted sweep does the same before entering the driver)
        from ..ops.qr import block_qr
        from ..ops.reorth import deflate as _deflate

        Qi = _deflate(lock, Qi.astype(jnp.dtype(cfg.compute_dtype)))
        Qi, _ = block_qr(Qi, method=cfg.resolved_qr_method())
        Qi = Qi.astype(jnp.dtype(cfg.basis_dtype))
    store = BasisStore(
        n, b, max_cols=max_kryl + b, dtype=cfg.basis_dtype,
        init_cols=cfg.min_basis_cols, sharding=sharding,
        device_cap_cols=cfg.basis_device_cap_cols,
    )

    # Mid-sweep fault tolerance (SURVEY §5: the reference has none): an
    # existing checkpoint at sweep_checkpoint_path means a previous solve
    # was interrupted — resume it instead of restarting.  The file is
    # deleted once THIS solve completes, so a finished solve never leaks
    # stale state into the next call.
    resume = None
    ck_path = cfg.sweep_checkpoint_path
    if ck_path is not None and os.path.exists(ck_path):
        from ..utils.checkpoint import load_sweep_state

        resume = load_sweep_state(ck_path)

    w_sel, V_sel, T, bounds, converged, nblocks = lanczos_iteration(
        op, k, cfg, Qi, store, lock_basis=lock, timer=timer, resume=resume
    )
    if ck_path is not None and os.path.exists(ck_path):
        os.remove(ck_path)

    # ascending-|λ| → descending, as the reference returns
    # (D[end:-1:1], V[:,end:-1:1] — RBL.jl:116)
    D = np.asarray(w_sel)[::-1].copy()
    bounds_desc = bounds[::-1].copy() if bounds is not None else None
    V = None
    if compute_eigenvectors:
        Vk = np.asarray(V_sel)[:, ::-1]
        V = recover_eigvec(store, Vk)
        # Shifted Rayleigh-quotient refinement: the refined θ carries
        # O(eps·|θ|) rounding instead of the O(n·eps·‖A‖) accumulated in T.
        # The TRUE residual norms it computes along the way replace the
        # Lanczos bounds in the result — they stay honest even when the
        # basis degraded (the bounds assume exact orthonormality).
        from .lanczos import _rayleigh_refine

        D_j, res_j = _rayleigh_refine(
            op, V, jnp.asarray(D), cdt=jnp.dtype(cfg.compute_dtype)
        )
        D = np.asarray(D_j)
        bounds_desc = np.asarray(res_j)
        if converged and np.max(bounds_desc) > 10 * cfg.tol:
            # the Lanczos bound ‖B·y‖ assumes an orthonormal basis; if the
            # TRUE residuals contradict it, the basis degraded and the
            # convergence claim is not trustworthy — never report a
            # converged=True result whose actual residuals fail the
            # tolerance by an order of magnitude
            converged = False

    return LanczosResult(
        eigenvalues=D,
        eigenvectors=V,
        iterations=nblocks,
        kryl_dim=store.ncols,
        converged=converged,
        residual_bounds=bounds_desc,
    )


# Reference-shaped alias: RBL(A, k, b) -> (D, V)
def RBL(A, k: int, b: int, cfg: Optional[RBLConfig] = None):
    res = rbl(A, k, b, cfg=cfg)
    return res.eigenvalues, res.eigenvectors


def RBL_gpu(A, k: int, b: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (RBL_gpu.jl:205): the reference forks CPU and
    GPU solvers; here one device-agnostic core serves both, so this is
    `RBL` under the reference's GPU entry name — kept so reference call
    sites migrate verbatim (device/mesh placement comes from cfg)."""
    return RBL(A, k, b, cfg=cfg)
