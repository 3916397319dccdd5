"""Chebyshev-filtered solver (solver/filtered.py, ops/chebyshev.py).

Beyond-parity accelerator: on slowly-decaying spectra the filter collapses
the Krylov dimension (the dominant reorth-traffic driver) by an order of
magnitude at the cost of `degree` extra SpMMs per iteration.  The
Krylov-dim reduction asserted here is hardware-independent — it is the
quantity the GPU wall-clock win follows from.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import rbl as rt
from rbl.ops.chebyshev import ChebyshevFilterOperator
from rbl.solver import filtered as filtered_mod
from rbl.solver.filtered import rbl_filtered


def _lap_top(nx, k):
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:k]


class TestFilterOperator:
    def test_matches_scalar_oracle(self):
        d = np.linspace(-3.0, 10.0, 400)
        op = rt.DiagonalOperator(jnp.asarray(d))
        f = ChebyshevFilterOperator.make(op, a=-3.5, b=8.0, gamma=10.2,
                                         degree=33)
        Y = np.asarray(f.apply(jnp.ones((400, 1))))[:, 0]
        np.testing.assert_allclose(Y, f.scalar(d), atol=1e-13)

    def test_normalization_damping_monotone(self):
        op = rt.DiagonalOperator(jnp.linspace(-2.0, 5.0, 50))
        f = ChebyshevFilterOperator.make(op, a=-2.5, b=4.0, gamma=5.1,
                                         degree=40)
        assert f.scalar(5.1) == pytest.approx(1.0, rel=1e-12)
        damped = f.scalar(np.linspace(-2.5, 4.0, 1001))
        assert np.max(np.abs(damped)) < 1e-5  # ≤ τ = 1/T_d(x̂)
        passband = f.scalar(np.linspace(4.0, 5.1, 200))
        assert np.all(np.diff(passband) > 0)  # monotone above the cutoff

    def test_no_overflow_at_extreme_degree_f32(self):
        op = rt.DiagonalOperator(jnp.linspace(-2.0, 5.0, 50,
                                              dtype=jnp.float32))
        f = ChebyshevFilterOperator.make(op, -2.5, 4.0, 5.1, degree=500)
        Y = np.asarray(f.apply(jnp.ones((50, 2), jnp.float32)))
        assert np.all(np.isfinite(Y))

    def test_invalid_geometry_raises(self):
        op = rt.DiagonalOperator(jnp.arange(1.0, 11.0))
        with pytest.raises(ValueError):
            ChebyshevFilterOperator.make(op, 5.0, 4.0, 10.0)
        with pytest.raises(ValueError):
            ChebyshevFilterOperator.make(op, 1.0, 4.0, 3.0)
        with pytest.raises(ValueError):
            ChebyshevFilterOperator.make(op, 1.0, 4.0, 10.0, degree=0)


class TestRblFiltered:
    @pytest.mark.slow  # ~23s; the collapse property also shows in test_slow_decay_both_ends's slow-tier run
    def test_laplacian_collapses_kryl_dim(self):
        # the headline-problem shape: top cluster spans <2% of ‖A‖; the
        # plain sweep runs to the cap without converging at this tol
        nx = 128
        op = rt.Laplacian2D(nx=nx, ny=nx)
        cfg = rt.RBLConfig(block_size=8, tol=1e-6, max_kryl_dim=768)
        k = 20
        res, info = rbl_filtered(op, k, cfg=cfg, which="LA",
                                 return_info=True)
        lam_true = _lap_top(nx, k)
        assert res.converged
        rel = np.max(np.abs(res.eigenvalues - lam_true) / lam_true)
        assert rel < 1e-10
        # the whole point: basis stays a fraction of the plain sweep's cap
        assert res.kryl_dim + info.presweep_kryl <= 320
        assert np.max(res.residual_bounds) < 1e-5

    @pytest.mark.slow  # ~18s
    def test_slow_decay_both_ends(self):
        n = 1000
        op = rt.DiagonalOperator(jnp.arange(1.0, n + 1.0))
        cfg = rt.RBLConfig(block_size=5, tol=1e-8, max_kryl_dim=600)
        la = rbl_filtered(op, 5, cfg=cfg, which="LA")
        np.testing.assert_allclose(la.eigenvalues,
                                   [1000, 999, 998, 997, 996], rtol=1e-10)
        sa = rbl_filtered(op, 5, cfg=cfg, which="SA")
        np.testing.assert_allclose(sa.eigenvalues, [1, 2, 3, 4, 5],
                                   rtol=1e-8)
        # SA vectors must align with the ascending values
        V = np.asarray(sa.eigenvectors)
        for j, lam in enumerate(sa.eigenvalues):
            assert np.argmax(np.abs(V[:, j])) == int(round(lam)) - 1

    def test_indefinite_spectrum(self):
        d = jnp.asarray(np.linspace(-500.0, 500.0, 1200))
        res = rbl_filtered(
            rt.DiagonalOperator(d), 6,
            cfg=rt.RBLConfig(block_size=6, tol=1e-8), which="LA",
        )
        assert res.converged
        np.testing.assert_allclose(
            res.eigenvalues, np.linspace(-500, 500, 1200)[::-1][:6],
            rtol=1e-9,
        )

    @pytest.mark.slow  # ~30s
    def test_psd_bounds_hint_lowers_degree(self):
        nx = 96
        op = rt.Laplacian2D(nx=nx, ny=nx)
        cfg = rt.RBLConfig(block_size=8, tol=1e-6)
        _, info_default = rbl_filtered(op, 10, cfg=cfg, which="LA",
                                       return_info=True)
        res, info_psd = rbl_filtered(op, 10, cfg=cfg, which="LA",
                                     bounds=(0.0, None), return_info=True)
        assert info_psd.degree < info_default.degree
        lam_true = _lap_top(nx, 10)
        assert np.max(np.abs(res.eigenvalues - lam_true) / lam_true) < 1e-10

    def test_explicit_cutoff_and_degree(self):
        n = 800
        op = rt.DiagonalOperator(jnp.arange(1.0, n + 1.0))
        res, info = rbl_filtered(
            op, 4, cfg=rt.RBLConfig(block_size=4, tol=1e-8), which="LA",
            cutoff=780.0, degree=25, return_info=True,
        )
        assert info.cutoff == pytest.approx(780.0)
        assert info.degree == 25
        assert info.presweep_kryl == 0  # no pre-sweep spent
        np.testing.assert_allclose(res.eigenvalues, [800, 799, 798, 797],
                                   rtol=1e-10)

    def test_overshot_cutoff_self_corrects(self, monkeypatch):
        # force a counting estimate ABOVE λ_k: the retry loop must bisect
        # toward the certified floor and still return the right pairs
        n = 600
        op = rt.DiagonalOperator(jnp.arange(1.0, n + 1.0))
        real = filtered_mod._presweep_cutoff

        def overshoot(op_, k_, pad_, cfg_, hi_):
            _cut, floor, top, m = real(op_, k_, pad_, cfg_, hi_)
            # just under the certified ceiling θ₁ but well above λ_k = 596
            return floor + 0.999 * (top - floor), floor, top, m

        monkeypatch.setattr(filtered_mod, "_presweep_cutoff", overshoot)
        res = rbl_filtered(
            op, 5, cfg=rt.RBLConfig(block_size=5, tol=1e-8), which="LA",
        )
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues,
                                   [600, 599, 598, 597, 596], rtol=1e-9)

    def test_lm_and_bad_bounds_raise(self):
        op = rt.DiagonalOperator(jnp.arange(1.0, 101.0))
        with pytest.raises(ValueError):
            rbl_filtered(op, 3, which="LM")
        with pytest.raises(ValueError):
            rbl_filtered(op, 3, which="LA", bounds=(5.0, 5.0))
        with pytest.raises(ValueError):
            rbl_filtered(op, 0, which="LA")
