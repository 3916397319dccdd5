"""Warm-started mixed-precision solve: f32 discovery → f64 Chebyshev polish.

Motivation: at the reference's absolute 1e-7 residual bound (RBL.jl:109)
a clustered spectrum defeats Krylov sweeps outright — the 256² Laplacian's
top-50 relative gaps are ~1e-5, so a 104-column restarted sweep reduces a
warm 1e-4 residual by ~(1 − 2√gap)ᵐ ≈ nothing (a restarted run locked 0/50
pairs in 22 restarts).  ARPACK solves it by *implicit restarting over
thousands of effective iterations*; the answer here is cheaper and
simpler: the f32 stage already
delivers the whole wanted subspace to ~1e-5 accuracy, and polishing a
KNOWN subspace is a job for **Chebyshev-filtered subspace iteration**
(Zhou–Saad Chebyshev–Davidson / ChASE lineage), not for growing a new
Krylov basis:

  1. coarse: f32/f32 plain sweep (`rbl`) for k + buffer pairs at a relaxed
     tolerance — fast, all in f32.
  2. polish: f64 block iteration on the warm (n, k+q+r) block:
     Rayleigh–Ritz → true residuals → one degree-d Chebyshev filter pass →
     repeat.  Per pass the unwanted component of every wanted pair shrinks
     by p(λ_i)/τ = cosh(d·acosh(x_i)) — with a q ≈ 32-pair buffer setting
     the cutoff at θ_{k+q}, a degree of a few hundred gains 10³–10⁵ per
     pass, so 2–3 passes close 1e-4 → 1e-7.  Everything is block SpMM and
     tall GEMM (two compiled programs total), the cluster is
     handled *inside* the Rayleigh–Ritz (cluster rotation is invisible to
     subspace error), and memory is O(n·(k+q)) — no Krylov basis at all.

This takes the role the reference's FLOAT/DOUBLE precision pair plays
(common.jl:5-6, README.md:69 mixed-precision rationale): the reference
spends FLOAT on the reorth/buffer tier inside one f64 sweep; here the
split is f32 for the WHOLE subspace discovery and f64 only for the final
filtered polish.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RBLConfig
from ..ops.chebyshev import ChebyshevProductFilter  # noqa: F401 — re-export for polish consumers
from ..ops.contract import gram
from ..ops.qr import block_qr
from ..ops.spmm.operator import AffineOperator, as_operator
from .lanczos import LanczosResult
from .rbl import rbl


@jax.jit
def _rr_gram(op, X):
    """A·X and the (m, m) Rayleigh–Ritz matrix XᵀAX in one dispatch."""
    AX = op.apply(X)
    return gram(X, AX), AX


@jax.jit
def _rr_rotate(X, AX, Y, theta):
    """Rotate the block onto the Ritz vectors and return TRUE absolute
    residual norms ‖A·x_i − θ_i·x_i‖ (the reference's convergence quantity,
    common.jl:56-65 — not the Lanczos bound, which lies once a basis
    degrades)."""
    pet = X.dtype
    Xr = jnp.dot(X, Y, preferred_element_type=pet)
    AXr = jnp.dot(AX, Y, preferred_element_type=pet)
    R = AXr - Xr * theta[None, :]
    return Xr, jnp.sqrt(jnp.sum(R * R, axis=0))


@partial(jax.jit, static_argnames=("degree", "qr_method", "fdt"))
def _filter_qr(op, X, frozen, a, b, degree, qr_method, fdt=None):
    """One Chebyshev filter pass + re-orthonormalization.

    The filter is the PRODUCT form (ChebyshevProductFilter): the factored
    `(A·Y − r·Y)` chain holds ~1e-16/step, and its per-step column
    normalization removes the scaled three-term form's
    f32-exponent-range underflow hazard.

    a/b are 0-d leaves: interval moves between passes hit the jit cache;
    only a degree or fdt change recompiles.

    ``fdt`` optionally runs the FILTER CHAIN in a lower precision (f32:
    half the bytes per SpMM of an f64 chain).  The subspace
    noise this injects (~√d·eps_f32 relative) is repaired by the enclosing
    loop: the post-filter QR and the Rayleigh–Ritz always run in X's own
    (compute) dtype, and the driver switches fdt to the compute dtype once
    the residuals approach the f32 floor (see _chebyshev_refine_impl)."""
    from ..ops.chebyshev import ChebyshevProductFilter

    xdt = X.dtype
    if fdt is not None and jnp.dtype(fdt) != xdt:
        from ..ops.spmm.operator import cast_operator

        fop = ChebyshevProductFilter(
            base=cast_operator(op, fdt), a=a.astype(fdt), b=b.astype(fdt),
            degree=degree,
        )
        Y = fop.apply(X.astype(fdt)).astype(xdt)
    else:
        fop = ChebyshevProductFilter(base=op, a=a, b=b, degree=degree)
        Y = fop.apply(X)
    nrm = jnp.sqrt(jnp.sum(Y * Y, axis=0))
    Y = Y / jnp.where(nrm > 0, nrm, 1.0)
    # frozen (already-converged) columns pass through UNFILTERED, and are
    # stable-partitioned to LEAD the QR (ADVICE r4): passthrough via
    # R₁₁ ≈ I only holds for a PREFIX of orthonormal columns — an
    # interleaved lock pattern would project a frozen column against a
    # filtered unfrozen one ahead of it, perturbing the converged vector
    # (possibly back above tol).  With the permutation, frozen columns
    # emerge bit-stable and the unfrozen ones are deflated against them
    # inside the same fixed-shape QR (run in the COMPUTE dtype, which
    # also re-orthogonalizes low-precision filter output against the
    # frozen set in full precision).  Traced mask + traced gather keep
    # one compiled program for every lock state.
    Y = jnp.where(frozen[None, :], X, Y)
    order = jnp.argsort(jnp.logical_not(frozen), stable=True)
    # the inverse permutation by scatter: XLA:GPU's rewrite of "argsort of
    # a permutation" fails its verifier on 64-bit indices
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=order.dtype)
    )
    Q, _ = block_qr(Y[:, order], method=qr_method)
    return Q[:, inv]


def _auto_degree(x: float, gain: float, cap: int) -> int:
    """Smallest d with cosh(d·acosh(x)) ≥ gain (filter gain at relative
    coordinate x > 1), clamped to [8, cap]."""
    if not np.isfinite(x) or x <= 1.0 + 1e-15:
        return cap
    d = math.acosh(2.0 * gain) / math.acosh(x)
    return int(min(cap, max(8, math.ceil(d))))


def chebyshev_refine(
    A: Any,
    warm_V: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    *,
    which: str = "LM",
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    degree: Optional[int] = None,
    max_passes: int = 12,
    extra_random: Optional[int] = None,
    target_gain: float = 1e6,
    degree_cap: int = 500,
    filter_dtype: str = "auto",
    timer=None,
    checkpoint_path: Optional[str] = None,
) -> LanczosResult:
    """Polish approximate eigenvectors to cfg.tol (absolute residual) by
    Chebyshev-filtered subspace iteration in cfg.compute_dtype.

    warm_V: (n, m) block of approximate eigenvectors for the wanted end,
        m ≥ k; extra columns beyond k act as the convergence buffer — the
        filter cutoff sits below the m-th Ritz value, so the wanted k gain
        cosh(d·acosh(x_k)) per pass while the buffer absorbs the slow edge.
    which: "LM" (descending |λ|), "LA" (descending λ), "SA" (ascending λ —
        solved as LA of −A).  LM with no certified lower bound uses the
        symmetric damped interval [−θ̃, θ̃] (correct for mixed-sign
        spectra; √2 more degree than one-sided).
    bounds: optional (λ_min, λ_max) certification for A's spectrum (either
        entry None).  λ_min = 0 for PSD operators halves the damped
        interval — the filter degree drops ~√2.
    degree: fixed filter degree (default: per-pass auto from the Ritz
        geometry, targeting ``target_gain`` per pass, capped at
        ``degree_cap``; raised 1.5× on a stalled pass).  The 1e6 default
        gain balances fewer passes (each pays a host round-trip) against
        smaller degrees; it has not been re-swept on the GPU.
    extra_random: random columns appended to warm_V (default block_size) —
        rank-deficiency repair and the escape hatch for any wanted
        direction the coarse stage missed entirely (the filter amplifies
        its component out of the random seed).
    filter_dtype: "auto" (default) runs filter chains in f32 while the
        residuals sit far above the f32 noise floor — half the bytes per
        SpMM — switching to the compute dtype
        for the final passes; "compute" pins every chain to
        cfg.compute_dtype.

    Returns LanczosResult with eigenvalues/eigenvectors/residual_bounds
    for the k wanted pairs (Rayleigh–Ritz values against the true A —
    these carry f64 RR accuracy, tighter than polished Lanczos T values);
    ``iterations`` counts filter passes.
    """
    cfg = cfg or RBLConfig()
    which = which.upper()
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which={which!r} not in ('LM', 'LA', 'SA')")
    # the opt-in probe-on-fault re-dispatch of rbl() (cfg.fault_retries)
    if cfg.fault_retries:
        from ..utils.probe import solve_with_retry

        # on a re-dispatch, resume from the pass-boundary checkpoint if
        # one was written (never the first attempt — a stale file from
        # some earlier solve must not hijack it)
        attempt = [0]

        def _dispatch():
            import os as _os

            wv, er = warm_V, extra_random
            if (attempt[0] and checkpoint_path is not None
                    and _os.path.exists(checkpoint_path)):
                from ..utils.checkpoint import load_polish_state

                wv, er = load_polish_state(checkpoint_path)["X"], 0
            attempt[0] += 1
            return _chebyshev_refine_impl(
                A, wv, k, cfg, which, bounds, degree, max_passes, er,
                target_gain, degree_cap, filter_dtype, timer,
                checkpoint_path,
            )

        return solve_with_retry(_dispatch, retries=cfg.fault_retries)
    return _chebyshev_refine_impl(
        A, warm_V, k, cfg, which, bounds, degree, max_passes,
        extra_random, target_gain, degree_cap, filter_dtype, timer,
        checkpoint_path,
    )


def _chebyshev_refine_impl(A, warm_V, k, cfg, which, bounds, degree,
                           max_passes, extra_random, target_gain,
                           degree_cap, filter_dtype, timer,
                           checkpoint_path=None):
    cdt = jnp.dtype(cfg.compute_dtype)
    base = as_operator(A, dtype=cdt)
    n = base.n
    # SA = LA of −A (eigenvectors invariant; values negated back at exit)
    op = base if which != "SA" else AffineOperator.shift(base, -1.0, 0.0)

    lo_u = hi_u = None
    if bounds is not None:
        lo_u, hi_u = bounds
    if which == "SA":  # bounds describe A itself; map to the solved −A
        lo_u, hi_u = (
            None if hi_u is None else -hi_u,
            None if lo_u is None else -lo_u,
        )

    from .rbl import _row_sharding

    sharding = _row_sharding(cfg)
    with jax.default_matmul_precision(cfg.matmul_precision):
        r = cfg.block_size if extra_random is None else int(extra_random)
        W = jnp.asarray(warm_V, dtype=cdt)
        if W.ndim != 2 or W.shape[0] != n or W.shape[1] < k:
            raise ValueError(
                f"warm_V must be (n={n}, m>={k}), got {W.shape}"
            )
        if r:
            key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 104729)
            W = jnp.concatenate(
                [W, jax.random.normal(key, (n, r), dtype=cdt)], axis=1
            )
        m = int(W.shape[1])
        if sharding is not None:
            W = jax.device_put(W, sharding)
        # entry orthonormalization: column-normalize first so duplicate /
        # garbage warm columns degrade into noise directions instead of
        # sinking the Cholesky (same rationale as _filter_qr)
        nrm = jnp.sqrt(jnp.sum(W * W, axis=0))
        W = W / jnp.where(nrm > 0, nrm, 1.0)
        # the Gram, the Rayleigh–Ritz rotation and the QR all stay on the
        # device; only the m×m Gram comes to the host for its eigh
        qr_method = ("cholqr2" if cdt.itemsize >= 8
                     else cfg.resolved_qr_method())
        X, _ = block_qr(W, method=qr_method)

        hi = hi_u
        if hi is None:
            from ..ops.eig import spectral_norm_bound

            hi = float(
                spectral_norm_bound(op, jax.random.PRNGKey(cfg.seed + 1))
            )

        import scipy.linalg
        import time as _time

        _t_last = _time.perf_counter()
        deg = degree
        prev_top = np.inf
        th = np.zeros(m)
        res = np.full(m, np.inf)
        converged = False
        npass = 0
        for p in range(max_passes):
            H, AX = _rr_gram(op, X)
            Hh = np.asarray(H, dtype=np.float64)
            if not np.all(np.isfinite(Hh)):
                # raise the RETRYABLE class (scipy's ValueError would
                # bypass every health-wait retry layer)
                raise FloatingPointError(
                    "non-finite Rayleigh-Ritz matrix in chebyshev_refine "
                    f"(pass {p}) — operator output or backend state is "
                    "unstable"
                )
            Hh = (Hh + Hh.T) / 2.0
            th_a, Y_a = scipy.linalg.eigh(Hh)
            order = (
                np.argsort(-np.abs(th_a), kind="stable") if which == "LM"
                else np.argsort(-th_a, kind="stable")
            )
            th, Yh = th_a[order], Y_a[:, order]
            X, res_j = _rr_rotate(
                X, AX, jnp.asarray(Yh, dtype=cdt),
                jnp.asarray(th, dtype=cdt),
            )
            res = np.asarray(res_j, dtype=np.float64)
            npass = p + 1
            top = float(np.max(res[:k]))
            if top < cfg.tol:
                converged = True
                break
            if p == max_passes - 1:
                break

            # ---- filter geometry from the CURRENT Ritz values ----------
            # Cutoff at the (k + half-buffer)-th Ritz value, NOT the m-th:
            # trailing columns can be garbage (a cap-hit coarse stage, the
            # random pad) whose Rayleigh quotients sit far below the
            # cluster — keying on θ_m drags the cutoff toward 0, gutting
            # the per-pass gain (and, for LM, collapsing the damped
            # interval entirely — observed on fem42: tilde ≈ 0 → early
            # degenerate-geometry break at 40/100 locked).  θ_ci ≤ λ_ci ≤
            # λ_k by interlacing (ci ≥ k), so the wanted pairs are never
            # damped; pairs between the cutoff and λ_k merely converge
            # along with the wanted ones.
            ci = min(m - 1, k - 1 + max(1, (m - k) // 2))
            scale = max(float(np.max(np.abs(th))), 1e-300)
            margin = 1e-10 * scale  # θ_i ≤ λ_i (interlacing) — the margin
            #                         only covers f64 RR rounding
            if which == "LM":
                tilde = float(np.abs(th[ci])) - margin
                a_ = -tilde if (lo_u is None or lo_u < -tilde) else float(lo_u)
                b_ = tilde
            else:
                a_ = float(lo_u) if lo_u is not None else -hi
                b_ = float(th[ci]) - margin
            span = max(float(np.abs(th[0])) - a_, 1e-300)
            if not (b_ - a_ > 1e-12 * max(span, 1.0)):
                # degenerate geometry (subspace ≈ whole space, or a flat
                # cluster down to a_): nothing left to damp — plain RR
                # iteration can't improve either, so stop honestly
                break

            c_ = (a_ + b_) / 2.0
            e_ = (b_ - a_) / 2.0
            # Lock: columns whose TRUE residual already clears the bound
            # freeze through the filter (see _filter_qr) — on spread
            # spectra the converged dominant pairs would otherwise set an
            # astronomically larger gain than the laggards and every
            # column would collapse onto them (measured: λ₁/λ_k = 10/6 at
            # auto-degree 80 gives a e⁸⁸ gain ratio — f64 cannot hold
            # both, the ±6 pairs were annihilated).
            frozen = res < cfg.tol
            unfrozen_wanted = np.nonzero(~frozen[:k])[0]

            # mixed-precision filter phase: run the chain in f32 (half
            # the bytes per SpMM) while the residual target is far above
            # the f32 noise floor; the QR/RR stay f64 throughout
            fdt = None
            if (
                filter_dtype == "auto"
                and cdt.itemsize >= 8
                and top > 64 * float(np.finfo(np.float32).eps) * scale
            ):
                fdt = jnp.float32
            # ratio-cap headroom e^head: leakage along the fast directions
            # reaches own·eps·e^{d·Δy} before QR; since those directions
            # are REPRESENTED in the block, QR-deflation strips what
            # lands on them — the cap only has to keep the transient
            # below ~1e-3 of the column's own content (f64: e²⁷·2e-16 ≈
            # 1e-4; f32: e⁹·1.2e-7 ≈ 1e-3)
            head = 9.0 if fdt is not None else 27.0

            def _y(i):
                x = abs((float(th[i]) - c_) / e_)
                return math.acosh(x) if x > 1.0 + 1e-15 else 0.0

            if degree is None:
                i_lo = int(unfrozen_wanted[-1])
                d_new = _auto_degree(
                    abs((float(th[i_lo]) - c_) / e_), target_gain,
                    degree_cap,
                )
                # gain-RATIO cap vs the GLOBAL spectral top (frozen pairs
                # included): rounding inside the filter reinjects
                # eps-level leakage along the fastest directions into
                # every unfrozen column, amplified by up to
                # e^{d·(y_top − y_lo)} over the remaining degree — it must
                # stay ≥ 1e-6 below the slow pair's own gain or the
                # column is annihilated before QR-deflation can strip it
                # (measured on a 10/6 two-tier spectrum: d=86 → e³⁷·eps
                # wiped the ±6 pairs; d ≤ 14/Δy converges them).
                y_spread = _y(0) - _y(i_lo)
                ratio_cap = (
                    max(8, int(head / y_spread)) if y_spread > 1e-9
                    else degree_cap
                )
                d_new = min(d_new, ratio_cap)
                # (the scaled form's underflow cap is gone: the product
                # filter's per-step column normalization keeps every
                # intermediate O(1) at any degree)
                if deg is None or top <= 0.3 * prev_top:
                    deg = d_new
                else:
                    # stalled: the geometry estimate was optimistic —
                    # escalate (recompile is the price of progress), but
                    # never past the ratio cap
                    deg = min(
                        degree_cap, max(d_new, int(deg * 1.5) + 8),
                        ratio_cap,
                    )
                # bucket to the √2-geometric grid: each distinct degree is
                # a fresh filter compile;
                # rounding UP costs ≤ 41% extra SpMMs and only ADDS gain.
                # Never round past the safety caps.
                if deg < degree_cap:
                    b_deg = 8
                    while b_deg < deg:
                        b_deg = int(b_deg * 1.4142) + 1
                    deg = min(b_deg, degree_cap, ratio_cap)
            prev_top = top
            import os as _os

            if _os.environ.get("RBL_DEBUG"):
                _t_now = _time.perf_counter()
                print(
                    f"[chebyshev_refine] pass {p}: top={top:.3e} "
                    f"locked={int(np.sum(res[:k] < cfg.tol))}/{k} "
                    f"deg={deg} fdt={fdt} cut={b_:.6g} "
                    f"th0={float(th[0]):.8g} thk={float(th[k-1]):.8g} "
                    f"thci={float(th[ci]):.8g} dt={_t_now - _t_last:.2f}s",
                    flush=True,
                )
                _t_last = _t_now
            X = _filter_qr(
                op, X, jnp.asarray(frozen),
                jnp.asarray(a_, cdt), jnp.asarray(b_, cdt),
                deg, qr_method, fdt=fdt,
            )
            if checkpoint_path is not None:
                from ..utils.checkpoint import save_polish_state

                save_polish_state(checkpoint_path, np.asarray(X), th, res,
                                  p + 1)

        lam = th[:k].astype(np.float64)
        if which == "SA":
            lam = -lam
        return LanczosResult(
            eigenvalues=lam,
            eigenvectors=X[:, :k],
            iterations=npass,
            kryl_dim=m,
            converged=converged,
            residual_bounds=res[:k].copy(),
        )


def rbl_polished(
    A: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    b: int = 8,
    coarse_tol: float = 1e-2,
    coarse_b: Optional[int] = None,
    coarse_cfg: Optional[RBLConfig] = None,
    buffer: Optional[int] = None,
    which: str = "LM",
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    degree: Optional[int] = None,
    max_passes: int = 12,
    target_gain: float = 1e6,
    timer=None,
    checkpoint_path: Optional[str] = None,
    # legacy restarted-polish knobs, still honored by the cold fallback
    polish_kryl_dim: Optional[int] = None,
    max_restarts: Optional[int] = None,
) -> LanczosResult:
    """Two-stage solve: f32 subspace discovery, f64 Chebyshev-filtered
    subspace polish (module docstring).

    ``cfg`` governs the POLISH stage (its ``tol`` is the final absolute
    residual bar; dtypes default f64).  The coarse stage runs ``rbl`` with
    f32 basis/compute at ``coarse_tol`` for k + ``buffer`` pairs (buffer
    default max(2b, min(k, 32)) — the extra pairs set the filter cutoff
    below the wanted cluster; see chebyshev_refine).  The 1e-2 coarse
    default: the refine self-starts from ~1e-2, so a tighter coarse bar
    bought nothing in an A/B (same passes and accuracy at 1e-4); halving
    ``buffer`` instead cost an extra filter pass.  Neither has been
    re-measured on the GPU.  ``bounds`` optionally
    certifies (λ_min, λ_max) of A — λ_min = 0 for PSD operators roughly
    halves the filter degree.

    Returns the polish stage's ``LanczosResult``; ``iterations`` counts
    filter passes.  If the coarse stage finds nothing usable
    (pathological), the solve falls back to a cold f64 ``rbl_restarted``
    — identical to the plain restarted solver.

    ``checkpoint_path`` is honored on BOTH paths: the warm polish writes
    an atomic filter-pass-boundary checkpoint (resumed automatically on
    a probe-on-fault re-dispatch), the cold fallback checkpoints at
    restart boundaries as before.
    """
    cfg = cfg or RBLConfig()
    if buffer is None:
        buffer = max(2 * b, min(k, 32))
    if coarse_cfg is None:
        coarse_cfg = cfg.replace(
            basis_dtype=jnp.float32,
            compute_dtype=jnp.float32,
            tol=max(coarse_tol, np.finfo(np.float32).eps),
            qr_method="auto",  # resolve per-dtype (cholqr2 for f32)
            sweep_checkpoint_path=None,
        )
    k_coarse = min(k + buffer, as_operator(A).n)
    # coarse_b: the discovery sweep's block size, decoupled from the
    # polish block.  None keeps the caller's b.
    coarse = rbl(A, k_coarse, cfg=coarse_cfg, b=coarse_b or b,
                 which=which, timer=timer)
    warm_V = coarse.eigenvectors
    if warm_V is not None and not bool(np.all(np.isfinite(np.asarray(warm_V)))):
        warm_V = None  # non-finite coarse output: run the polish cold

    if warm_V is None:
        # cold fallback: the round-2 restarted polish path (no warm
        # subspace to filter — grow one the Krylov way)
        if polish_kryl_dim is None:
            polish_kryl_dim = max(8 * b, 2 * k)
            polish_kryl_dim += (-polish_kryl_dim) % b
        if max_restarts is None:
            max_restarts = 4 * (k + b - 1) // b + 16
        from .restarted import rbl_restarted

        return rbl_restarted(
            A, k, cfg=cfg.replace(restart_kryl_dim=polish_kryl_dim), b=b,
            max_restarts=max_restarts, timer=timer,
            checkpoint_path=checkpoint_path, which=which,
        )

    return chebyshev_refine(
        A, warm_V, k, cfg=cfg.replace(block_size=b), which=which,
        bounds=bounds, degree=degree, max_passes=max_passes,
        target_gain=target_gain, timer=timer,
        checkpoint_path=checkpoint_path,
    )
