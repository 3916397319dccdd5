"""Shift-invert / interior eigenvalues: blocked MINRES + eigsh(sigma=...).

The reference is exterior-only (LM: benchmark.jl:42); these cover the
beyond-parity interior capability (ops/minres.py, compat.eigsh sigma/SM).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla

import jax
import jax.numpy as jnp

import rbl as rt
from rbl.ops.minres import ShiftInvertOperator, block_minres


class TestBlockMinres:
    def test_indefinite_diagonal(self):
        # (A - 37.3 I) is indefinite: eigenvalues straddle the shift
        d = jnp.arange(1.0, 201.0)
        op = rt.DiagonalOperator(d)
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((200, 4)))
        X, (itn, relres) = block_minres(op.apply, B, shift=37.3, tol=1e-12)
        Xtrue = B / (d - 37.3)[:, None]
        assert float(jnp.max(jnp.abs(X - Xtrue))) < 1e-9
        assert float(jnp.max(relres)) < 1e-11

    def test_laplacian_interior_shift_jits(self):
        lp = rt.Laplacian2D(nx=24, ny=24)
        rng = np.random.default_rng(1)
        B = jnp.asarray(rng.standard_normal((576, 3)))
        si = ShiftInvertOperator.shift(lp, 1.7, inner_tol=1e-12)
        Y = jax.jit(lambda o, b: o.apply(b))(si, B)
        res = lp.apply(Y) - 1.7 * Y - B
        assert float(jnp.max(jnp.abs(res))) < 1e-9

    def test_breakdown_columns_stay_finite(self):
        # column 0: zero RHS (x = 0); column 1: an eigenvector (exact
        # solution after one step) — neither may produce NaNs
        d = jnp.arange(1.0, 201.0)
        op = rt.DiagonalOperator(d)
        e5 = jnp.where(jnp.arange(200) == 5, 1.0, 0.0)
        B = jnp.stack([jnp.zeros(200), e5], axis=1)
        X, (itn, relres) = block_minres(op.apply, B, shift=37.3, tol=1e-12)
        assert bool(jnp.all(jnp.isfinite(X)))
        assert float(jnp.max(jnp.abs(X[:, 0]))) == 0.0
        assert float(X[5, 1]) == pytest.approx(1.0 / (6.0 - 37.3), rel=1e-12)

    def test_maxiter_caps(self):
        d = jnp.arange(1.0, 201.0)
        op = rt.DiagonalOperator(d)
        B = jnp.ones((200, 2))
        _, (itn, relres) = block_minres(
            op.apply, B, shift=37.3, tol=1e-14, maxiter=5
        )
        assert int(itn) == 5


class TestJacobiPrecond:
    def test_preconditioned_matches_and_converges_faster(self):
        from rbl.ops.minres import jacobi_psolve

        # wildly scaled diagonal + weak coupling: Jacobi equilibration
        # collapses the iteration count
        rng = np.random.default_rng(3)
        n = 400
        d = np.logspace(0, 6, n)
        A = sp.diags(d) + sp.diags([np.ones(n - 1)] * 2, [-1, 1])
        op = rt.as_operator(A.tocsr())
        B = jnp.asarray(rng.standard_normal((n, 3)))
        sig = 513.7
        X0, (it0, _) = block_minres(op.apply, B, shift=sig, tol=1e-12)
        ps = jacobi_psolve(op.diagonal() - sig)
        X1, (it1, _) = block_minres(op.apply, B, shift=sig, tol=1e-12,
                                    psolve=ps)
        # measured: unpreconditioned MINRES stalls at the 3n = 1200 cap
        # with residual ~1.5; quantile-clamped Jacobi converges in 64
        # iterations to 2e-12
        res1 = op.apply(X1) - sig * X1 - B
        assert float(jnp.max(jnp.abs(res1))) < 1e-9
        assert int(it1) < 200
        assert int(it1) * 5 < int(it0)

    def test_zero_crossing_pencil_not_harmed(self):
        # d = diag(A) − σ·diag(M) crosses zero: naive 1/|d| Jacobi WORSENS
        # conditioning (767 → 13k measured) and stalls MINRES; the
        # quantile clamp must keep the preconditioned solve at least as
        # good as the unpreconditioned one AND accurate
        import scipy.linalg

        from rbl.ops.minres import jacobi_psolve

        dA = np.linspace(1.0, 500.0, 500)
        A = sp.diags(dA).tocsr()
        M = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], shape=(500, 500)).tocsr()
        w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
        sig = 0.5 * (w[300] + w[301])
        opA, opM = rt.as_operator(A), rt.as_operator(M)

        def f(V):
            return opA.apply(V) - sig * opM.apply(V)

        rng = np.random.default_rng(9)
        B = jnp.asarray(rng.standard_normal((500, 2)))
        ps = jacobi_psolve(opA.diagonal() - sig * opM.diagonal())
        X1, (it1, _) = block_minres(f, B, tol=1e-11, psolve=ps)
        _, (it0, _) = block_minres(f, B, tol=1e-11)
        Xtrue = np.linalg.solve((A - sig * M).toarray(), np.asarray(B))
        assert np.max(np.abs(np.asarray(X1) - Xtrue)) < 1e-9
        assert int(it1) <= int(it0) + 50

    def test_diagonal_protocol_all_formats(self):
        from rbl.ops.spmm.coo import CooOperator, HybOperator
        from rbl.ops.spmm.dia import DiaOperator
        from rbl.ops.spmm.ell import SparseEllOperator
        from rbl.ops.spmm.pallas_bsr import BlockSparseOperator

        rng = np.random.default_rng(4)
        n = 150
        # banded sparsity (17 diagonals) so the SAME matrix exercises every
        # format including DIA (which rejects unbanded matrices)
        Ad = np.zeros((n, n))
        for off in range(-8, 9):
            v = rng.standard_normal(n - abs(off))
            v[np.abs(v) < 0.8] = 0.0
            Ad += np.diag(v, off)
        Ad = Ad + Ad.T
        np.fill_diagonal(Ad, rng.standard_normal(n) + 5.0)
        A = sp.csr_matrix(Ad)
        want = Ad.diagonal()
        for cls in (CooOperator, DiaOperator, SparseEllOperator,
                    HybOperator):
            got = np.asarray(cls.from_scipy(A).diagonal())
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=0,
                                       err_msg=cls.__name__)
        got = np.asarray(
            BlockSparseOperator.from_scipy(A, dtype=jnp.float32).diagonal()
        )
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   err_msg="BlockSparseOperator")
        # dense, diagonal, affine, stencils
        np.testing.assert_allclose(
            np.asarray(rt.DenseOperator(jnp.asarray(Ad)).diagonal()), want)
        dop = rt.DiagonalOperator(jnp.asarray(want))
        np.testing.assert_allclose(np.asarray(dop.diagonal()), want)
        from rbl.ops.spmm.operator import AffineOperator

        aff = AffineOperator.shift(dop, 2.0, -1.5)
        np.testing.assert_allclose(np.asarray(aff.diagonal()),
                                   2.0 * want - 1.5)
        assert float(rt.Laplacian2D(nx=4, ny=4).diagonal()[0]) == 4.0
        assert float(rt.Laplacian3D(nx=3, ny=3, nz=3).diagonal()[0]) == 6.0
        # matrix-free operators opt out
        assert rt.FunctionOperator(
            fun=lambda X: X, _n=8, _dtype=jnp.float64
        ).diagonal() is None

    def test_gram_diagonals(self):
        from rbl.ops.spmm.operator import (
            GramOperator,
            SparseGramOperator,
        )

        rng = np.random.default_rng(6)
        Bd = rng.standard_normal((70, 40))
        Bd[np.abs(Bd) < 1.0] = 0.0
        for left, G in ((False, Bd.T @ Bd), (True, Bd @ Bd.T)):
            got = np.asarray(
                GramOperator(B=jnp.asarray(Bd), left=left).diagonal()
            )
            np.testing.assert_allclose(got, np.diag(G), rtol=1e-12)
            gots = np.asarray(SparseGramOperator.from_scipy(
                sp.csr_matrix(Bd), left=left
            ).diagonal())
            np.testing.assert_allclose(gots, np.diag(G), rtol=1e-12)

    def test_shift_invert_precond_matches_none(self):
        d = np.logspace(0, 4, 250)
        A = (sp.diags(d) + 0.5 * sp.diags([np.ones(249)] * 2, [-1, 1])
             ).tocsr()
        op = rt.as_operator(A)
        rng = np.random.default_rng(5)
        B = jnp.asarray(rng.standard_normal((250, 2)))
        sig = 97.3
        got = {}
        for pc in ("jacobi", "none"):
            si = ShiftInvertOperator.shift(op, sig, inner_tol=1e-12,
                                           precond=pc)
            got[pc] = np.asarray(si.apply(B))
        np.testing.assert_allclose(got["jacobi"], got["none"],
                                   rtol=1e-7, atol=1e-9)


class TestEigshSigma:
    def test_interior_matches_scipy(self):
        n = 300
        A = sp.diags(np.arange(1.0, n + 1.0)).tocsr()
        w, v = rt.eigsh(A, k=5, sigma=137.4)
        ws, _ = sla.eigsh(A, k=5, sigma=137.4)
        np.testing.assert_allclose(w, ws, rtol=1e-10)
        # residuals against the original A
        r = A @ v - v * w
        assert np.max(np.abs(r)) < 1e-6

    def test_which_sm_tridiag_laplacian(self):
        lp = sp.diags([-1, 2.0, -1], [-1, 0, 1], shape=(400, 400)).tocsr()
        w = rt.eigsh(lp, k=4, which="SM", return_eigenvectors=False)
        ws = sla.eigsh(lp, k=4, which="SM", return_eigenvectors=False)
        # scipy sorts no-vector SM results by DESCENDING |λ|; match it
        np.testing.assert_allclose(w, ws, rtol=1e-8)

    def test_which_sm_with_vectors_ascending(self):
        lp = sp.diags([-1, 2.0, -1], [-1, 0, 1], shape=(300, 300)).tocsr()
        w, v = rt.eigsh(lp, k=3, which="SM")
        assert np.all(np.diff(w) > 0)  # ascending algebraic
        r = lp @ v - v * w
        assert np.max(np.abs(r)) < 1e-6

    def test_sigma_la_sa_sides(self):
        # LA with sigma: eigenvalues just ABOVE σ; SA: just below
        n = 200
        A = sp.diags(np.arange(1.0, n + 1.0)).tocsr()
        w_above = rt.eigsh(
            A, k=3, sigma=50.5, which="LA", return_eigenvectors=False
        )
        np.testing.assert_allclose(np.sort(w_above), [51.0, 52.0, 53.0],
                                   rtol=1e-9)
        w_below = rt.eigsh(
            A, k=3, sigma=50.5, which="SA", return_eigenvectors=False
        )
        np.testing.assert_allclose(np.sort(w_below), [48.0, 49.0, 50.0],
                                   rtol=1e-9)

    def test_unsupported_modes_raise(self):
        A = sp.eye(50, format="csr") * 2.0
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, k=2, sigma=1.0, mode="buckling")
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, k=2, sigma=1.0, which="SM")
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, k=2, sigma=1.0, which="BE")


class TestMixedPrecisionInner:
    """f32 MINRES + f64 defect correction (block_minres_refined) must
    reach full-f64 inner accuracy (the opt-in mixed inner tier)."""

    def test_refined_matches_full_diag(self):
        from rbl.ops.minres import (
            ShiftInvertOperator,
            block_minres_refined,
        )

        d = jnp.linspace(1.0, 500.0, 800).astype(jnp.float64)
        op = rt.DiagonalOperator(d)
        rng = np.random.default_rng(0)
        B = jnp.asarray(rng.standard_normal((800, 3)))
        sigma = 123.4
        X, (it, rel) = block_minres_refined(
            lambda V: op.apply(V), B, shift=sigma, tol=1e-12,
        )
        R = np.asarray(op.apply(X) - sigma * X - B)
        assert np.linalg.norm(R) < 1e-10 * np.linalg.norm(np.asarray(B))
        # operator surface, forced mixed, vs forced full
        si_m = ShiftInvertOperator.shift(
            op, sigma, inner_precision="mixed")
        si_f = ShiftInvertOperator.shift(
            op, sigma, inner_precision="full")
        Ym = np.asarray(si_m.apply(B))
        Yf = np.asarray(si_f.apply(B))
        np.testing.assert_allclose(Ym, Yf, rtol=1e-8, atol=1e-10)

    def test_refined_generalized_fem(self):
        from rbl.ops.generalized import GeneralizedShiftInvertOperator
        from rbl.utils.fem import fem_elasticity_3d

        A = fem_elasticity_3d(4)
        n = A.shape[0]
        m = np.abs(np.asarray(A.sum(axis=1)).ravel()) + 0.1
        opA = rt.as_operator(A, dtype=jnp.float64)
        opM = rt.DiagonalOperator(jnp.asarray(m))
        msqrt = rt.DiagonalOperator(jnp.asarray(np.sqrt(m)))
        rng = np.random.default_rng(1)
        B = jnp.asarray(rng.standard_normal((n, 2)))
        outs = {}
        for label in ("mixed", "full"):
            W = GeneralizedShiftInvertOperator(
                A=opA, M=opM, msqrt=msqrt,
                sigma=jnp.asarray(0.0, jnp.float64),
                inner_tol=1e-11, inner_precision=label,
            )
            outs[label] = np.asarray(W.apply(B))
        np.testing.assert_allclose(
            outs["mixed"], outs["full"], rtol=1e-7, atol=1e-9
        )
