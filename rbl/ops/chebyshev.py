"""Scaled Chebyshev spectral filter — the polynomial accelerator behind
``rbl_filtered`` (solver/filtered.py).

Randomized block Lanczos convergence is set by the relative gaps between
the wanted exterior eigenvalues and the rest of the spectrum; on
slowly-decaying spectra (the reference's ``slow_decay`` fixture, and the
2D-Laplacian headline problem whose top cluster spans <2% of ‖A‖) the basis
must grow deep before the top k separate.  A degree-d Chebyshev polynomial
p(A) that is ≤ τ = 1/T_d(x̂) on the damped interval [a, b] and grows to 1
at the normalization point γ re-spreads the wanted cluster [cutoff, λmax]
across [τ, 1] — gaps improve by orders of magnitude and the Krylov dimension
(and with it the dominant reorthogonalization traffic, which scales as
basis-length × n per step) collapses.

Cost model: each filtered apply is d extra SpMM + AXPY passes — pure
streaming work with *no* host round-trips, no polls, and no basis growth —
while every additional basis column adds n·4 bytes to EVERY later
reorthogonalization pass, so trading d SpMMs per step for a several-fold
smaller basis is the textbook algorithmic traffic cut.

The recurrence is the σ-scaled three-term form (Zhou & Saad,
Chebyshev–Davidson; same scaling as EVSL's cheb filters): the iterates
carry τ_j·T_j rather than raw T_j, so nothing overflows at any degree —
T_d(x̂) itself can exceed f32 range for d in the hundreds.

Filter geometry (which="LA" orientation):

    damp [a, b], normalize at γ > b:  p(x) = T_d((x−c)/e) / T_d((γ−c)/e),
    c = (a+b)/2, e = (b−a)/2, so |p| ≤ τ on [a, b], p(γ) = 1, and p is
    monotone increasing on [b, ∞) — top-k of A map to top-k algebraic of
    p(A) whenever all wanted eigenvalues lie above b.

Safety requirement: a ≤ λ_min(A).  Below the damped interval |T_d| grows
with alternating sign, so an eigenvalue under a would be *amplified* — the
callers bound a by −‖A‖₂ (power-method bound) unless the user certifies a
tighter λ_min.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax

from .spmm.operator import LinearOperator, register_operator, static_field


@register_operator
@dataclasses.dataclass(frozen=True)
class ChebyshevFilterOperator(LinearOperator):
    """p(A) for the scaled Chebyshev filter damping [a, b], normalized to
    1 at γ.  ``a``/``b``/``gamma`` are 0-d array leaves: re-tuning the
    interval between solves reuses the compiled sweep; only a change of
    ``degree`` (static) recompiles."""

    base: LinearOperator
    a: jax.Array      # 0-d: damped-interval lower edge (≤ λ_min!)
    b: jax.Array      # 0-d: damped-interval upper edge (the cutoff)
    gamma: jax.Array  # 0-d: normalization point (λ_max estimate)
    degree: int = static_field(default=24)

    @classmethod
    def make(cls, base: LinearOperator, a: float, b: float, gamma: float,
             degree: int = 24):
        dt = base.dtype
        if not (a < b < gamma):
            raise ValueError(
                f"need a < b < gamma, got a={a}, b={b}, gamma={gamma}"
            )
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        return cls(
            base=base,
            a=jnp.asarray(a, dt),
            b=jnp.asarray(b, dt),
            gamma=jnp.asarray(gamma, dt),
            degree=int(degree),
        )

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def apply(self, X: jax.Array) -> jax.Array:
        c = (self.a + self.b) / 2
        e = (self.b - self.a) / 2
        sigma1 = e / (self.gamma - c)  # |σ₁| < 1 since γ is outside [a, b]

        # y₁ = σ₁/e · (A − cI) x  — the degree-1 scaled filter
        Y = (self.base.apply(X) - c * X) * (sigma1 / e)
        if self.degree == 1:
            return Y

        def step(_, carry):
            Xp, Yc, sig = carry
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            Yn = (
                2.0 * (sig_new / e) * (self.base.apply(Yc) - c * Yc)
                - (sig * sig_new) * Xp
            )
            return (Yc, Yn, sig_new)

        _, Y, _ = lax.fori_loop(
            2, self.degree + 1, step, (X, Y, sigma1)
        )
        return Y

    def scalar(self, x):
        """p(x) for scalar/array x — the exact polynomial the operator
        applies (test oracle, and the value-mapping for diagnostics)."""
        import numpy as np

        a = float(self.a); b = float(self.b); g = float(self.gamma)
        c = (a + b) / 2.0
        e = (b - a) / 2.0
        xs = (np.asarray(x, dtype=np.float64) - c) / e
        gs = (g - c) / e
        sigma1 = 1.0 / gs
        y_prev = np.ones_like(xs)
        y = xs * sigma1
        sig = sigma1
        for _ in range(2, self.degree + 1):
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            y_prev, y, sig = (
                y, 2.0 * sig_new * xs * y - sig * sig_new * y_prev, sig_new
            )
        return y


def _leja_order(x):
    """Greedy Leja ordering of the points x: each next point maximizes the
    product of distances to those already chosen.  Keeps the partial
    products of the factored filter well-scaled (the classic ordering for
    product-form polynomial evaluation)."""
    import numpy as np

    n = len(x)
    sel = np.zeros(n, bool)
    acc = np.zeros(n)
    j = int(np.argmax(np.abs(x)))
    order = [j]
    sel[j] = True
    for _ in range(n - 1):
        acc = acc + np.log(np.abs(x - x[j]) + 1e-300)
        masked = np.where(sel, -np.inf, acc)
        j = int(np.argmax(masked))
        order.append(j)
        sel[j] = True
    return np.asarray(order)


@register_operator
@dataclasses.dataclass(frozen=True)
class ChebyshevProductFilter(LinearOperator):
    """The degree-d Chebyshev filter T_d((A−c)/e) evaluated as the product
    of its d linear factors (A − r_i·I), r_i the Chebyshev roots of the
    damped interval [a, b], visited in Leja order with per-step column
    normalization.

    Same filtered SUBSPACE as ChebyshevFilterOperator (columns differ by
    positive per-column scales, which every consumer normalizes away), but
    built exclusively from the `(A·Y − r·Y)` pattern, which chains at
    ~1e-16/step in f64.  The per-step normalization also removes the
    scaled form's range hazard (p-values e^{−d·y} underflow the f32
    exponent range of a reduced-precision chain), so no underflow degree
    cap is needed.

    a/b are 0-d array leaves: interval moves reuse the compiled apply;
    only a degree change recompiles."""

    base: LinearOperator
    a: jax.Array      # 0-d: damped-interval lower edge (≤ λ_min!)
    b: jax.Array      # 0-d: damped-interval upper edge (the cutoff)
    degree: int = static_field(default=24)

    @classmethod
    def make(cls, base: LinearOperator, a: float, b: float,
             degree: int = 24):
        dt = base.dtype
        if not (a < b):
            raise ValueError(f"need a < b, got a={a}, b={b}")
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        return cls(
            base=base,
            a=jnp.asarray(a, dt),
            b=jnp.asarray(b, dt),
            degree=int(degree),
        )

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def _unit_roots(self):
        """Leja-ordered roots of T_d on the REFERENCE interval [−1, 1] —
        a compile-time constant; the affine map to [a, b] happens in
        traced arithmetic so interval moves stay leaf updates."""
        import numpy as np

        d = self.degree
        r = np.cos((2 * np.arange(1, d + 1) - 1) * np.pi / (2 * d))
        return r[_leja_order(r)]

    def apply(self, X: jax.Array) -> jax.Array:
        c = (self.a + self.b) / 2
        e = (self.b - self.a) / 2
        roots = jnp.asarray(self._unit_roots(), X.dtype)

        def step(i, Y):
            r = c + e * roots[i]
            Y = self.base.apply(Y) - r * Y
            nrm = jnp.sqrt(jnp.sum(Y * Y, axis=0))
            return Y / jnp.where(nrm > 0, nrm, 1.0)

        return lax.fori_loop(0, self.degree, step, X)

    def scalar_direction(self, x):
        """sign(p(x))·|p(x)| up to a global positive scale, via
        log-magnitude accumulation (test oracle — the operator's output
        is only defined up to positive per-column scaling)."""
        import numpy as np

        a = float(self.a); b = float(self.b)
        c = (a + b) / 2.0
        e = (b - a) / 2.0
        xs = np.asarray(x, dtype=np.float64)
        roots = c + e * self._unit_roots()
        logm = np.zeros_like(xs, dtype=np.float64)
        sign = np.ones_like(xs)
        for r in roots:
            t = xs - r
            logm = logm + np.log(np.abs(t) + 1e-300)
            sign = sign * np.sign(t)
        logm = logm - np.max(logm)
        return sign * np.exp(logm)
