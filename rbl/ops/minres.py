"""Blocked MINRES and the shift-invert spectral transform.

The reference is exterior-only: its ARPACK comparison surface is
``eigs(..., which=:LM)`` (benchmark.jl:42) and the solver itself converges to
largest-magnitude Ritz pairs.  Interior eigenvalues (scipy's
``eigsh(A, k, sigma=...)`` and ``which="SM"``) need the shift-invert
transform OP = (A − σI)⁻¹, whose eigenvalues θ = 1/(λ − σ) make the
eigenvalues of A nearest σ the *exterior* ones of OP.

Design:

- The inner solve is **blocked MINRES** (A − σI is symmetric but indefinite
  for interior σ, so CG does not apply): all b right-hand sides advance in
  lockstep, so each inner iteration costs exactly one block SpMM — the same
  (n, b) shape as the outer Lanczos recurrence — plus a handful of
  per-column (b,)-lane scalar recurrences.  No per-column Python loop, no
  host round-trips.
- The whole solve is one ``lax.while_loop`` (static shapes, traced once),
  so ``ShiftInvertOperator.apply`` jits *inside* the outer solver's fused
  sweep chunks like any other operator.
- Division guards (`beta`, `oldb`, `gamma`) make exact breakdowns (RHS in a
  low-dimensional Krylov space — e.g. B already an eigenvector) converge to
  the exact solution instead of producing NaNs, with no per-column masking.

The recurrence follows Paige & Saunders' MINRES (the same formulation as
scipy.sparse.linalg.minres), vectorized so every scalar becomes a (b,) lane
vector.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .spmm.operator import LinearOperator, register_operator, static_field


def _coldot(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Per-column dot products, f32-accumulated for sub-f32 inputs."""
    pet = jnp.float32 if jnp.dtype(X.dtype).itemsize < 4 else X.dtype
    return jnp.einsum("ij,ij->j", X, Y, preferred_element_type=pet).astype(
        X.dtype
    )


def _safe(d: jax.Array) -> jax.Array:
    """Guard a nonnegative divisor: exact zero -> 1 (the masked quantity is
    itself zero in that case, so the quotient's value is irrelevant)."""
    return jnp.where(d > 0, d, jnp.ones_like(d))


def block_minres(
    apply_a: Callable[[jax.Array], jax.Array],
    B: jax.Array,
    *,
    shift: jax.Array | float = 0.0,
    tol: float = 1e-11,
    maxiter: Optional[int] = None,
    psolve: Optional[Callable[[jax.Array], jax.Array]] = None,
):
    """Solve (A − shift·I) X = B columnwise with MINRES in lockstep.

    Parameters
    ----------
    apply_a: block matvec X ↦ A·X on (n, b) arrays (A symmetric).
    B: (n, b) right-hand-side block.
    shift: scalar σ (python float or 0-d array — a traced 0-d array reuses
        the compiled solve across shifts).
    tol: per-column relative residual target ‖(A−σI)x − rhs‖ / ‖rhs‖
        (in the preconditioned norm when ``psolve`` is given).
    maxiter: inner iteration cap (default 3n; MINRES terminates in ≤ n
        exact-arithmetic steps, the slack covers finite-precision stalls).
    psolve: optional SPD preconditioner application X ↦ T·X (e.g. Jacobi
        T = diag(|A − σI|)⁻¹): the Paige–Saunders preconditioned recurrence
        — Lanczos runs on T^{1/2}·(A−σI)·T^{1/2} implicitly, one ``psolve``
        per iteration, no T^{1/2} ever formed.  T must be symmetric
        positive definite (an indefinite T breaks the β² = rᵀTr square
        roots; values are clamped at 0 rather than NaN'd, but convergence
        is no longer meaningful).

    Returns
    -------
    (X, (iterations, relres)) — the solution block, the number of inner
    iterations executed, and the (b,) per-column relative residual
    estimates (the MINRES φ̄ recurrence, not a recomputed true residual;
    preconditioned-norm when ``psolve`` is given).
    """
    n, b = B.shape
    dt = B.dtype
    if maxiter is None:
        maxiter = 3 * n
    maxiter = int(min(maxiter, 2**31 - 1))
    eps = jnp.asarray(jnp.finfo(dt).eps, dt)
    sigma = jnp.asarray(shift, dtype=dt)

    def op(V):
        return apply_a(V) - sigma * V

    if psolve is None:
        def psolve(X):  # noqa: E306 — identity preconditioner
            return X
        y0 = B
        beta1 = jnp.sqrt(_coldot(B, B))
    else:
        y0 = psolve(B)
        # β² = rᵀTr ≥ 0 for SPD T; clamp rounding noise
        beta1 = jnp.sqrt(jnp.maximum(_coldot(B, y0), 0.0))
    beta1s = _safe(beta1)  # zero columns converge at itn=0 with x=0

    zeros_nb = jnp.zeros_like(B)
    zeros_b = jnp.zeros((b,), dt)

    # state: (itn, x, y, r1, r2, w, w2, oldb, beta, dbar, epsln,
    #         phibar, cs, sn)
    state0 = (
        jnp.asarray(0, jnp.int32),
        zeros_nb,             # x
        y0,                   # y = T·r2
        B,                    # r1
        B,                    # r2
        zeros_nb,             # w
        zeros_nb,             # w2
        jnp.ones((b,), dt),   # oldb (guarded; masked at itn==1)
        beta1s,               # beta
        zeros_b,              # dbar
        zeros_b,              # epsln
        beta1,                # phibar
        -jnp.ones((b,), dt),  # cs
        zeros_b,              # sn
    )

    def cond(state):
        itn, phibar = state[0], state[11]
        return jnp.logical_and(
            itn < maxiter, jnp.any(phibar > tol * beta1s)
        )

    def body(state):
        (itn, x, y, r1, r2, w, w2, oldb, beta, dbar, epsln, phibar,
         cs, sn) = state
        itn = itn + 1

        v = y / _safe(beta)[None, :]
        y = op(v)
        # the r1 correction only exists from the second iteration on
        coef1 = jnp.where(itn >= 2, beta / _safe(oldb), zeros_b)
        y = y - coef1[None, :] * r1
        alfa = _coldot(v, y)
        y = y - (alfa / _safe(beta))[None, :] * r2
        r1, r2 = r2, y
        y = psolve(r2)
        oldb, beta = beta, jnp.sqrt(jnp.maximum(_coldot(r2, y), 0.0))

        # previous plane rotation applied to the new tridiagonal column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta * beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1, w2 = w2, w
        w = (v - oldeps[None, :] * w1 - delta[None, :] * w2) / gamma[None, :]
        x = x + phi[None, :] * w
        return (itn, x, y, r1, r2, w, w2, oldb, beta, dbar, epsln,
                phibar, cs, sn)

    state = lax.while_loop(cond, body, state0)
    itn, x, phibar = state[0], state[1], state[11]
    return x, (itn, phibar / beta1s)


@register_operator
@dataclasses.dataclass(frozen=True)
class ShiftInvertOperator(LinearOperator):
    """OP = (A − σI)⁻¹ via blocked MINRES — the spectral transform behind
    ``eigsh(A, k, sigma=σ)`` and ``which="SM"`` (σ = 0).

    θ(OP) = 1/(λ(A) − σ): eigenvalues of A nearest σ become the
    largest-magnitude eigenvalues of OP, which is exactly what the outer
    randomized block Lanczos converges to.  OP is symmetric, so the outer
    solver applies unchanged; each outer recurrence step costs one full
    inner MINRES solve (the price of interior eigenvalues — identical to
    ARPACK's shift-invert mode, but with the factorization replaced by an
    iteration that never materializes or factors A, so it shards over the
    mesh exactly like every other operator here).

    ``sigma`` is a 0-d array leaf: solves at different shifts reuse one
    compiled outer sweep.  ``inner_tol`` should be well below the outer
    convergence tolerance — inner-solve error acts as a non-symmetric
    perturbation of OP that the outer residual bounds cannot see.

    ``precond="auto"`` (the default) resolves, in order: "fdm" — the
    EXACT fast-diagonalization shifted solve for Kronecker-sum operators
    (ops/fdm.py; a handful of matmuls replace the whole inner
    iteration, any σ); "mg" — the geometric multigrid V-cycle for
    supported structured operators (ops/multigrid.py) when the shift is
    small against a diagonal-based ‖A‖ estimate (the cycle approximates
    A⁻¹, which only helps near the bottom of the spectrum); else Jacobi.
    ``shift()`` resolves "auto" at construction (the choice must be
    jit-static).  ``precond="jacobi"`` preconditions
    with the quantile-clamped Jacobi T of ``jacobi_psolve`` (d = diag(A) − σ)
    whenever the operator can report its diagonal
    (``LinearOperator.diagonal()``; matrix-free/composite operators
    return None and run unpreconditioned) — for operators whose diagonal
    spans orders of magnitude this collapses the inner iteration count;
    for near-constant diagonals it is a harmless rescale; the clamp keeps
    the σ-crossing rows from being amplified (see jacobi_psolve).
    """

    base: LinearOperator
    sigma: jax.Array  # 0-d
    inner_tol: float = static_field(default=1e-11)
    inner_maxiter: Optional[int] = static_field(default=None)
    precond: str = static_field(default="auto")
    # explicit SPD preconditioner application (wins over precond
    # resolution except the exact FDM path) — e.g. an
    # ops/amg.AssembledMultigrid.psolve for assembled FEM matrices.
    # Static leaf: hashes by identity, so reuse ONE instance across
    # solves to share the compiled sweep.
    psolve: Optional[Callable] = static_field(default=None)
    # "full": MINRES at the operator dtype.  "mixed": f32 MINRES + f64
    # defect correction (block_minres_refined) — a user's choice that
    # trades inner iterations for cheaper f32 applies.  NB under "mixed" a
    # user ``psolve`` must accept f32 blocks (the built-in Jacobi does;
    # build AMG psolves at f32).
    inner_precision: str = static_field(default="full")

    @classmethod
    def shift(cls, base: LinearOperator, sigma: float, **kw):
        # Resolve "auto" HERE, where sigma is a concrete float: the MG
        # V-cycle approximates A⁻¹, which only preconditions (A − σI)
        # well while |σ| is small against ‖A‖ — for interior shifts the
        # 1 − σ/λ spectrum is badly spread at the small-λ end and MG can
        # be worse than Jacobi (ADVICE r2).  The decision must also be
        # static (apply may trace with sigma as a tracer leaf).
        if kw.get("precond", "auto") == "auto":
            kw["precond"] = cls._resolve_auto(base, float(sigma))
        if kw.get("precond") == "fdm":
            # σ exactly at an eigenvalue makes A − σI singular; fail
            # loudly at construction instead of NaN-poisoning the sweep
            # (scipy's factorized shift-invert fails the same way, with
            # a singular-matrix error from the LU)
            from .fdm import fdm_min_shift_gap

            gap = fdm_min_shift_gap(base, float(sigma))
            if gap is not None and gap < 1e-12 * max(1.0, abs(float(sigma))):
                raise ValueError(
                    f"sigma={float(sigma)!r} coincides with an eigenvalue "
                    "of the operator (A - sigma*I is singular) — perturb "
                    "sigma"
                )
        return cls(
            base=base, sigma=jnp.asarray(sigma, dtype=base.dtype), **kw
        )

    @staticmethod
    def _resolve_auto(base: LinearOperator, sigma: float) -> str:
        """'fdm' when the operator admits an exact fast-diagonalization
        shifted solve (ops/fdm.py — Kronecker sums, any σ); else 'mg'
        when a V-cycle exists AND σ sits in the bottom of the spectrum
        (|σ| ≤ c·‖A‖ with ‖A‖ estimated from the diagonal — 2·max|d| is
        exact for the model Laplacians and a Gershgorin-flavored proxy
        generally); else 'jacobi'."""
        from .fdm import fdm_solver_for
        from .multigrid import mg_psolve_for

        if fdm_solver_for(base) is not None:
            return "fdm"
        if mg_psolve_for(base) is None:
            return "jacobi"
        d = base.diagonal()
        if d is not None:
            norm_est = 2.0 * float(jnp.max(jnp.abs(d)))
            if abs(sigma) > 0.125 * norm_est:
                return "jacobi"
        return "mg"

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def _mixed(self) -> bool:
        return self.inner_precision == "mixed"

    def _minres_solve(self, B64: jax.Array, psolve) -> jax.Array:
        """The inner solve, at full or mixed precision (see
        ``inner_precision``)."""
        if self._mixed():
            from .spmm.operator import cast_operator

            op32 = cast_operator(self.base, jnp.float32)
            Y, _ = block_minres_refined(
                self.base.apply, B64, shift=self.sigma,
                tol=self.inner_tol, apply32=op32.apply, psolve32=psolve,
                inner_maxiter=self.inner_maxiter,
            )
            return Y
        Y, _ = block_minres(
            self.base.apply, B64, shift=self.sigma, tol=self.inner_tol,
            maxiter=self.inner_maxiter, psolve=psolve,
        )
        return Y

    def apply(self, X: jax.Array) -> jax.Array:
        precond = self.precond
        if self.psolve is not None and precond != "fdm":
            # an explicit SPD preconditioner (e.g. assembled-matrix AMG,
            # ops/amg.py) wins over the built-in resolution — except the
            # exact FDM solve, which no preconditioner can beat
            if precond == "auto":
                try:
                    if self._resolve_auto(
                        self.base, float(self.sigma)
                    ) == "fdm":
                        return self._fdm_apply(X)
                except (jax.errors.ConcretizationTypeError, TypeError):
                    pass
            return self._minres_solve(
                X.astype(self.dtype), self.psolve
            ).astype(X.dtype)
        if precond == "auto":
            # ``shift()`` resolves "auto" at construction; a direct
            # dataclass construction can reach here with a possibly
            # traced sigma — resolve if concrete, else fall back to
            # Jacobi (the safe choice for an unknown shift).
            try:
                precond = self._resolve_auto(self.base, float(self.sigma))
            except (jax.errors.ConcretizationTypeError, TypeError):
                precond = "jacobi"
        if precond == "fdm":
            return self._fdm_apply(X)
        psolve = None
        if precond == "mg":
            # geometric V-cycle for supported structured operators
            # (ops/multigrid.py): measured 434 -> 38 inner iterations on
            # the 128² Laplacian at sigma=0.  Approximates A⁻¹, so it is
            # the right preconditioner for sigma at/near 0 ("SM", lowest
            # modes).
            from .multigrid import mg_psolve_for

            psolve = mg_psolve_for(self.base)
            if psolve is None:
                raise ValueError(
                    "precond='mg' requires a supported structured "
                    "operator (Laplacian2D with even dims, hierarchy "
                    "bottoming out near 8x8) — use 'jacobi', 'auto', "
                    "or 'none'"
                )
        if psolve is None and precond == "jacobi":
            d = self.base.diagonal()
            if d is not None:
                psolve = jacobi_psolve(d.astype(self.dtype) - self.sigma)
        return self._minres_solve(X.astype(self.dtype), psolve).astype(
            X.dtype
        )

    def _fdm_apply(self, X: jax.Array) -> jax.Array:
        # exact fast-diagonalization shifted solve (ops/fdm.py): no
        # inner iteration at all — the factorization-free analogue of ARPACK's
        # factorized shift-invert, valid at any σ
        from .fdm import fdm_solver_for

        direct = fdm_solver_for(self.base)
        if direct is None:
            raise ValueError(
                "precond='fdm' requires a Kronecker-sum operator "
                "(Laplacian2D/3D) — use 'mg', 'jacobi', 'auto', or "
                "'none'"
            )
        return direct(X.astype(self.dtype), self.sigma).astype(X.dtype)


def block_minres_refined(
    apply64: Callable[[jax.Array], jax.Array],
    B: jax.Array,
    *,
    shift: jax.Array | float = 0.0,
    tol: float = 1e-11,
    apply32: Optional[Callable[[jax.Array], jax.Array]] = None,
    psolve32: Optional[Callable[[jax.Array], jax.Array]] = None,
    inner_tol: float = 1e-5,
    inner_maxiter: Optional[int] = None,
    max_refine: int = 8,
):
    """Solve (A − σI) X = B to f64 accuracy with ALL iterations in f32:
    repeated defect correction x ← x + S₃₂(b − (A−σI)x), where S₃₂ is an
    f32 blocked-MINRES solve to ``inner_tol`` and the residual is true
    f64 (one ``apply64`` per refinement step).

    The mixed-precision formulation: a plain f64 MINRES runs every one of
    its hundreds of iterations in f64; here the f64 work is max_refine
    residuals and the iterations run at f32 bytes and rates.  Each
    refinement contracts the error by ~max(inner_tol, κ·eps₃₂), so the
    loop reaches ``tol`` (relative, f64 floor) when κ(A−σI) ≲ 1e5 —
    beyond that the f32 inner solve itself stalls and the loop exits at
    ``max_refine`` with whatever it reached (same caveat as any inexact
    inner solve).

    apply32/psolve32 default to casting wrappers around ``apply64`` —
    pass natively-f32 versions (``cast_operator``) to avoid f64 applies
    inside the f32 iteration.
    """
    n, b = B.shape
    if apply32 is None:
        def apply32(V):  # noqa: E306
            return apply64(V.astype(B.dtype)).astype(jnp.float32)
    sig64 = jnp.asarray(shift, B.dtype)
    sig32 = jnp.asarray(shift).astype(jnp.float32)
    bnorm = jnp.sqrt(
        jnp.einsum("ij,ij->j", B, B, preferred_element_type=B.dtype)
    )
    bnorm_s = jnp.where(bnorm > 0, bnorm, jnp.ones_like(bnorm))

    def resid(x):
        return B - (apply64(x) - sig64 * x)

    def rnorm(r):
        return jnp.sqrt(
            jnp.einsum("ij,ij->j", r, r, preferred_element_type=r.dtype)
        )

    def solve32(r):
        dx, _ = block_minres(
            apply32, r.astype(jnp.float32), shift=sig32, tol=inner_tol,
            maxiter=inner_maxiter, psolve=psolve32,
        )
        return dx.astype(B.dtype)

    x0 = solve32(B)
    r0 = resid(x0)

    def cond(state):
        it, _, r = state
        return jnp.logical_and(
            it < max_refine, jnp.any(rnorm(r) > tol * bnorm_s)
        )

    def body(state):
        it, x, r = state
        x = x + solve32(r)
        return it + 1, x, resid(x)

    it, x, r = lax.while_loop(cond, body, (jnp.asarray(1, jnp.int32),
                                           x0, r0))
    return x, (it, rnorm(r) / bnorm_s)


def default_inner_tol(dtype, tol: float) -> float:
    """Inner MINRES relative target for shift-invert transforms: well
    below the outer tolerance (inner error perturbs OP invisibly to the
    outer residual bounds), but floored at what the dtype's φ̄ recurrence
    can honestly reach — 1e-13 for f64, 30·eps for sub-f64 compute
    dtypes.  Below the floor the φ̄ estimate keeps 'converging' while the
    TRUE residual stalls (measured at f32: 479 inner iterations to a
    fictitious 7e-12 vs 225 to an honest 30·eps, same true residual)."""
    fi = jnp.finfo(jnp.dtype(dtype))
    floor = 1e-13 if fi.bits >= 64 else 30.0 * float(fi.eps)
    return float(max(floor, min(1e-11, 1e-4 * tol)))


def jacobi_psolve(d: jax.Array, clamp_quantile: float = 0.1
                  ) -> Callable[[jax.Array], jax.Array]:
    """SPD Jacobi preconditioner T = diag(max(|d|, floor))⁻¹ for a
    (possibly indefinite) system whose matrix diagonal is ``d`` — the
    absolute value keeps T positive definite, which preconditioned MINRES
    requires.

    The floor is the ``clamp_quantile`` quantile of |d| (not a tiny
    epsilon): a shift-invert diagonal d = diag(A) − σ·diag(M) CROSSES
    ZERO at interior shifts, and amplifying the near-crossing rows by
    1/|d| scales their off-diagonal coupling up unboundedly — measured on
    a 500-point pencil this *worsened* the preconditioned condition
    number 767 → 13k and stalled MINRES outright.  Clamping at q10 keeps
    those rows un-amplified while preserving the global equilibration:
    measured iterations (tol 1e-11) — logspace(1…10⁶) diagonal: 1200+
    (unpreconditioned, stalled) → 61; zero-crossing pencil: 896 → 762
    (never worse than unpreconditioned in either case)."""
    dabs = jnp.abs(d)
    floor = jnp.maximum(
        jnp.quantile(dabs, clamp_quantile),
        jnp.finfo(d.dtype).tiny,
    )
    inv = 1.0 / jnp.maximum(dabs, floor)

    def psolve(X):
        return X * inv[:, None].astype(X.dtype)

    return psolve
