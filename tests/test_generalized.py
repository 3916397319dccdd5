"""Generalized eigenproblems A·x = λ·M·x (solver/generalized.py,
ops/generalized.py) and the ``eigsh(M=...)`` compat surface.

Beyond-parity capability: the reference is standard-form only; scipy's
ARPACK path factorizes M.  Here the pencil runs through the
exactly-symmetric Chebyshev-M^{−1/2} transform (streaming SpMMs only) and
every answer is validated against the TRUE pencil — these tests gate both
the accuracy and the honesty (converged demotion, M-orthonormality).
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

import jax.numpy as jnp

import rbl as rt
from rbl.ops.generalized import (
    ChebyshevSeriesOperator,
    PencilOperator,
    chebyshev_fit,
    fit_to_tolerance,
)
from rbl.solver.generalized import rbl_generalized


def _fem1d(n):
    """1D FEM stiffness/mass pencil on (0,1): eigenvalues ≈ (kπ)²."""
    h = 1.0 / (n + 1)
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr() / h
    M = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).tocsr() * (h / 6)
    return A, M


def _wellcond():
    dA = np.linspace(1.0, 500.0, 500)
    A = sp.diags(dA).tocsr()
    M = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(500, 500)).tocsr()
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    return A, M, w


class TestChebyshevSeries:
    def test_fit_reproduces_polynomial_exactly(self):
        # a cubic is reproduced exactly at degree 3
        c = chebyshev_fit(lambda t: 2 * t**3 - t + 0.5, 1.0, 4.0, 3)
        op = ChebyshevSeriesOperator(
            base=rt.DiagonalOperator(jnp.linspace(1.0, 4.0, 50)),
            coeffs=jnp.asarray(c), lo=jnp.asarray(1.0), hi=jnp.asarray(4.0),
            degree=3,
        )
        t = np.linspace(1.0, 4.0, 200)
        np.testing.assert_allclose(op.scalar(t), 2 * t**3 - t + 0.5,
                                   rtol=1e-12, atol=1e-12)

    def test_inv_sqrt_fit_accuracy_and_apply(self):
        d = np.linspace(0.5, 8.0, 300)
        op = ChebyshevSeriesOperator.inv_sqrt(
            rt.DiagonalOperator(jnp.asarray(d)), 0.4, 8.5, rel_tol=1e-11
        )
        # scalar oracle hits the tolerance across the whole domain
        t = np.linspace(0.4, 8.5, 3000)
        assert np.max(np.abs(op.scalar(t) * np.sqrt(t) - 1.0)) < 1e-11
        # the Clenshaw apply matches the oracle on a diagonal operator
        Y = np.asarray(op.apply(jnp.ones((300, 1))))[:, 0]
        np.testing.assert_allclose(Y, op.scalar(d), rtol=1e-12, atol=1e-12)

    def test_fit_to_tolerance_degree_grows_with_kappa(self):
        c_easy, _ = fit_to_tolerance(lambda t: 1 / np.sqrt(t), 1.0, 4.0,
                                     rel_tol=1e-10)
        c_hard, _ = fit_to_tolerance(lambda t: 1 / np.sqrt(t), 0.01, 4.0,
                                     rel_tol=1e-10)
        assert len(c_hard) > 2 * len(c_easy)

    def test_fit_unreachable_tolerance_raises(self):
        with pytest.raises(ValueError, match="cannot reach"):
            fit_to_tolerance(lambda t: 1 / np.sqrt(t), 1e-9, 1.0,
                             rel_tol=1e-12, max_degree=30)

    def test_inv_sqrt_requires_positive_domain(self):
        op = rt.DiagonalOperator(jnp.linspace(1.0, 4.0, 10))
        with pytest.raises(ValueError, match="positive definite"):
            ChebyshevSeriesOperator.inv_sqrt(op, -0.5, 4.0)

    def test_pencil_operator_is_symmetric(self):
        rng = np.random.default_rng(0)
        Ad = rng.standard_normal((40, 40))
        Ad = Ad + Ad.T
        Md = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(40, 40)).toarray()
        P = ChebyshevSeriesOperator.inv_sqrt(
            rt.DenseOperator(jnp.asarray(Md)), 1.0, 3.0, rel_tol=1e-12
        )
        S = PencilOperator(A=rt.DenseOperator(jnp.asarray(Ad)), P=P)
        Sd = np.asarray(S.apply(jnp.eye(40)))
        np.testing.assert_allclose(Sd, Sd.T, atol=1e-12)


class TestRblGeneralized:
    def test_wellconditioned_all_whiches(self):
        A, M, w = _wellcond()
        cfg = rt.RBLConfig(block_size=5, tol=1e-9)
        for which, exact in (
            ("SA", w[:5]), ("LA", w[::-1][:5]), ("LM", w[::-1][:5])
        ):
            res = rbl_generalized(A, M, 5, cfg=cfg, which=which)
            assert res.converged, which
            rel = np.max(np.abs(res.eigenvalues - exact) / np.abs(exact))
            assert rel < 1e-12, which
            # M-orthonormal vectors (ARPACK convention)
            V = res.eigenvectors
            assert np.max(np.abs(V.T @ (M @ V) - np.eye(5))) < 1e-10
            # true pencil residuals
            R = A @ V - (M @ V) * res.eigenvalues[None, :]
            assert np.max(np.linalg.norm(R, axis=0)) < 1e-7

    def test_fem_pencil_largest_modes(self):
        n = 400
        A, M = _fem1d(n)
        w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
        res, info = rbl_generalized(
            A, M, 6, cfg=rt.RBLConfig(block_size=6, tol=1e-4), which="LA",
            return_info=True,
        )
        assert res.converged
        rel = np.max(np.abs(res.eigenvalues - w[::-1][:6]) / w[::-1][:6])
        assert rel < 1e-11
        assert info.degree > 0  # tridiagonal M went through the series path
        lo, hi = info.m_bounds
        assert 0 < lo < hi

    def test_diagonal_mass_fast_path_exact(self):
        # diag A, diag M: pencil eigenvalues are a_i/m_i; degree must be 0
        a = np.linspace(3.0, 900.0, 600)
        m = np.linspace(0.5, 2.0, 600)
        res, info = rbl_generalized(
            sp.diags(a).tocsr(), rt.DiagonalOperator(jnp.asarray(m)), 4,
            cfg=rt.RBLConfig(block_size=4, tol=1e-10), which="LA",
            return_info=True,
        )
        assert info.degree == 0 and info.approx_err == 0.0
        exact = np.sort(a / m)[::-1][:4]
        np.testing.assert_allclose(res.eigenvalues, exact, rtol=1e-12)

    def test_explicit_degree_and_bounds(self):
        A, M, w = _wellcond()
        res, info = rbl_generalized(
            A, M, 3, cfg=rt.RBLConfig(block_size=3, tol=1e-8), which="LA",
            m_bounds=(0.5, 3.2), degree=20, return_info=True,
        )
        assert info.degree == 20
        assert info.m_bounds == (0.5, 3.2)
        np.testing.assert_allclose(res.eigenvalues, w[::-1][:3], rtol=1e-10)

    def test_indefinite_m_raises(self):
        A = sp.diags(np.linspace(1.0, 10.0, 200)).tocsr()
        # diagonal fast path
        with pytest.raises(ValueError, match="non-positive diagonal"):
            rbl_generalized(
                A, rt.DiagonalOperator(jnp.linspace(-1.0, 2.0, 200)), 2
            )
        # series path certification
        Mind = sp.diags([0.3, 0.1, 0.3], [-1, 0, 1], shape=(200, 200))
        with pytest.raises(ValueError, match="positive definite"):
            rbl_generalized(A, Mind.tocsr(), 2)

    def test_shape_mismatch_and_bad_k_raise(self):
        A = sp.eye(100).tocsr()
        with pytest.raises(ValueError, match="shapes differ"):
            rbl_generalized(A, sp.eye(80).tocsr(), 2)
        with pytest.raises(ValueError, match="out of range"):
            rbl_generalized(A, sp.eye(100).tocsr(), 0)
        with pytest.raises(ValueError, match="which"):
            rbl_generalized(A, sp.eye(100).tocsr(), 2, which="BE")

    def test_low_degree_demotes_converged(self):
        # an intentionally bad P (degree 2): values come back Rayleigh-
        # refined anyway, but true residuals must demote `converged`
        A, M, w = _wellcond()
        res = rbl_generalized(
            A, M, 3, cfg=rt.RBLConfig(block_size=3, tol=1e-10), which="LA",
            m_bounds=(0.5, 3.2), degree=2,
        )
        assert not res.converged
        assert np.max(res.residual_bounds) > 1e-8


class TestEigshGeneralized:
    def test_eigsh_matches_dense_oracle(self):
        A, M, w = _wellcond()
        wv, V = rt.eigsh(A, 6, M=M, which="LM", tol=1e-9)
        exact = np.sort(w[::-1][:6])  # ascending, scipy convention
        np.testing.assert_allclose(wv, exact, rtol=1e-12)
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(6))) < 1e-10

    def test_eigsh_be_split(self):
        A, M, w = _wellcond()
        wv = rt.eigsh(A, 5, M=M, which="BE", tol=1e-9,
                      return_eigenvectors=False)
        exact = np.sort(np.concatenate([w[:2], w[-3:]]))
        np.testing.assert_allclose(wv, exact, rtol=1e-11)

    def test_eigsh_generalized_unsupported_modes(self):
        A, M, _ = _wellcond()
        with pytest.raises(ValueError):
            # buckling/cayley REQUIRE sigma (scipy raises too)
            rt.eigsh(A, 3, M=M, mode="buckling")
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, 3, M=M, mode="bogus")
        with pytest.raises(NotImplementedError):
            # "SM" WITH sigma = farthest from σ — not implemented
            rt.eigsh(A, 3, M=M, sigma=2.0, which="SM")


class TestGeneralizedShiftInvert:
    """sigma: interior pencil eigenvalues via the factorization-free
    mode-3 transform W = M^{1/2}·(A − σM)^{−1}·M^{1/2} (blocked-MINRES
    inner solve, Chebyshev M^{±1/2})."""

    def test_operator_is_symmetric(self):
        from rbl.ops.generalized import GeneralizedShiftInvertOperator

        rng = np.random.default_rng(1)
        Ad = rng.standard_normal((30, 30))
        Ad = Ad + Ad.T
        Md = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(30, 30)).toarray()
        Ps = ChebyshevSeriesOperator.sqrt(
            rt.DenseOperator(jnp.asarray(Md)), 1.0, 3.0, rel_tol=1e-12
        )
        W = GeneralizedShiftInvertOperator(
            A=rt.DenseOperator(jnp.asarray(Ad)),
            M=rt.DenseOperator(jnp.asarray(Md)),
            msqrt=Ps, sigma=jnp.asarray(0.37), inner_tol=1e-12,
        )
        Wd = np.asarray(W.apply(jnp.eye(30)))
        np.testing.assert_allclose(Wd, Wd.T, atol=1e-9)
        # eigenvalues of W are 1/(λ_pencil − σ)
        w_pencil = scipy.linalg.eigh(Ad, Md, eigvals_only=True)
        got = np.sort(np.linalg.eigvalsh(Wd))
        want = np.sort(1.0 / (w_pencil - 0.37))
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)

    def test_sigma_nearest_interior(self):
        A, M, w = _wellcond()
        # asymmetric placement: the spectrum is near-uniform, so a midpoint
        # σ creates exactly-tied |λ−σ| pairs and an ambiguous order
        sig = w[200] + 0.3 * (w[201] - w[200])
        res = rbl_generalized(
            A, M, 4, cfg=rt.RBLConfig(block_size=4, tol=1e-8),
            which="LM", sigma=sig,
        )
        assert res.converged
        exact = w[np.argsort(np.abs(w - sig), kind="stable")[:4]]
        # returned nearest-first; compare as sets ordered by distance
        np.testing.assert_allclose(res.eigenvalues, exact, rtol=1e-10)
        V = res.eigenvectors
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(4))) < 1e-8
        R = A @ V - (M @ V) * res.eigenvalues[None, :]
        assert np.max(np.linalg.norm(R, axis=0)) < 1e-6

    def test_sigma_la_sa_take_sides(self):
        A, M, w = _wellcond()
        sig = 0.5 * (w[300] + w[301])
        above = w[w > sig][:3]
        below = w[w < sig][-3:][::-1]
        cfg = rt.RBLConfig(block_size=3, tol=1e-8)
        res_a = rbl_generalized(A, M, 3, cfg=cfg, which="LA", sigma=sig)
        np.testing.assert_allclose(res_a.eigenvalues, above, rtol=1e-10)
        res_b = rbl_generalized(A, M, 3, cfg=cfg, which="SA", sigma=sig)
        np.testing.assert_allclose(res_b.eigenvalues, below, rtol=1e-10)

    def test_sigma_diagonal_mass_fast_path(self):
        a = np.linspace(3.0, 900.0, 500)
        m = np.linspace(0.5, 2.0, 500)
        lam = a / m
        sig = float(np.median(lam)) + 0.123
        res, info = rbl_generalized(
            sp.diags(a).tocsr(), rt.DiagonalOperator(jnp.asarray(m)), 4,
            cfg=rt.RBLConfig(block_size=4, tol=1e-9), which="LM",
            sigma=sig, return_info=True,
        )
        assert info.degree == 0
        exact = lam[np.argsort(np.abs(lam - sig), kind="stable")[:4]]
        np.testing.assert_allclose(res.eigenvalues, exact, rtol=1e-10)

    def test_eigsh_m_sigma_scipy_order(self):
        A, M, w = _wellcond()
        sig = 0.5 * (w[100] + w[101])
        wv, V = rt.eigsh(A, 4, M=M, sigma=sig, tol=1e-8)
        exact = np.sort(w[np.argsort(np.abs(w - sig), kind="stable")[:4]])
        np.testing.assert_allclose(wv, exact, rtol=1e-10)
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(4))) < 1e-8

    def test_buckling_mode(self):
        # A SPD, M symmetric INDEFINITE (the buckling shape: stiffness vs
        # geometric stiffness); B = A inner product, ν = λ/(λ−σ)
        n = 300
        dA = np.linspace(4.0, 600.0, n)
        A = sp.diags([-1.0 * np.ones(n - 1), dA, -1.0 * np.ones(n - 1)],
                     [-1, 0, 1]).tocsr()
        s = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        M = (sp.diags(s)
             + 0.2 * sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
             ).tocsr()
        w = scipy.linalg.eig(A.toarray(), M.toarray(),
                             right=False)
        w = np.sort(np.real(w))
        sig = 37.3
        nu = w / (w - sig)
        expect = w[np.argsort(-np.abs(nu), kind="stable")[:3]]
        res = rbl_generalized(
            A, M, 3, cfg=rt.RBLConfig(block_size=3, tol=1e-8),
            which="LM", sigma=sig, mode="buckling",
        )
        np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)
        assert res.converged
        # A-orthonormal vectors (B = A in buckling mode)
        V = res.eigenvectors
        assert np.max(np.abs(V.T @ (A @ V) - np.eye(3))) < 1e-8

    def test_cayley_mode(self):
        A, M, w = _wellcond()
        sig = w[250] + 0.37 * (w[251] - w[250])
        nu = (w + sig) / (w - sig)
        expect = w[np.argsort(-np.abs(nu), kind="stable")[:3]]
        res = rbl_generalized(
            A, M, 3, cfg=rt.RBLConfig(block_size=3, tol=1e-8),
            which="LM", sigma=sig, mode="cayley",
        )
        np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)
        assert res.converged
        V = res.eigenvectors
        assert np.max(np.abs(V.T @ (M @ V) - np.eye(3))) < 1e-8

    @pytest.mark.slow  # ~55s: each mode also has its own fast-tier test
    def test_modes_cross_check_vs_scipy_arpack(self):
        # scipy's eigsh drives the REAL ARPACK modes (with a factorization
        # we deliberately avoid); our factorization-free transforms must
        # reproduce its eigenvalues for normal/buckling/cayley
        import scipy.sparse.linalg as sla

        n = 240
        h = 1.0 / (n + 1)
        A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)
                     ).tocsr() / h
        M = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)
                     ).tocsr() * (h / 6)
        sig = 800.0
        for mode in ("normal", "cayley"):
            w_sp = sla.eigsh(A, 4, M=M, sigma=sig, mode=mode,
                             return_eigenvectors=False)
            w_rt = rt.eigsh(A, 4, M=M, sigma=sig, mode=mode, tol=1e-9,
                            return_eigenvectors=False)
            np.testing.assert_allclose(
                np.sort(w_rt), np.sort(w_sp), rtol=1e-8, err_msg=mode
            )
        # buckling takes B = A roots: use a well-conditioned SPD A (a
        # stiffness-like κ ~ n² matrix needs explicit m_bounds/degree —
        # documented limitation of the factorization-free route) and an
        # indefinite geometric-stiffness M
        rng = np.random.default_rng(11)
        Ab = sp.diags([-np.ones(n - 1), rng.uniform(4.0, 9.0, n),
                       -np.ones(n - 1)], [-1, 0, 1]).tocsr()
        Mb = sp.csr_matrix(
            sp.diags(np.where(np.arange(n) % 2 == 0, 1.0, -1.0))
            + 0.2 * sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
        )
        sigb = 9.7
        w_sp = sla.eigsh(Ab, 4, M=Mb, sigma=sigb, mode="buckling",
                         return_eigenvectors=False)
        w_rt = rt.eigsh(Ab, 4, M=Mb, sigma=sigb, mode="buckling",
                        tol=1e-9, return_eigenvectors=False)
        np.testing.assert_allclose(
            np.sort(w_rt), np.sort(w_sp), rtol=1e-8, err_msg="buckling"
        )

    def test_mode_validation(self):
        A, M, _ = _wellcond()
        with pytest.raises(ValueError, match="requires sigma"):
            rbl_generalized(A, M, 2, mode="buckling")
        with pytest.raises(ValueError, match="nonzero sigma"):
            rbl_generalized(A, M, 2, mode="cayley", sigma=0.0)
        with pytest.raises(ValueError, match="mode="):
            rbl_generalized(A, M, 2, mode="bogus")

    def test_eigsh_m_sm_is_sigma_zero(self):
        A, M, w = _wellcond()
        wv = rt.eigsh(A, 3, M=M, which="SM", tol=1e-8,
                      return_eigenvectors=False)
        exact = w[np.argsort(np.abs(w), kind="stable")[:3]]
        # scipy SM order without eigenvectors: descending |λ|
        np.testing.assert_allclose(wv, exact[np.argsort(-np.abs(exact))],
                                   rtol=1e-10)
