"""which="LA"/"SA" — algebraic spectrum ends via spectral shift.

Beyond reference parity (the reference solves LM only, benchmark.jl:42):
rbl() shifts by a power-method bound s ≥ ‖A‖₂ (AffineOperator) so the
requested algebraic end becomes the magnitude end, then maps θ back."""

import numpy as np
import pytest

import rbl as rt


def test_la_on_sign_mixed_diagonal():
    """LM would return the -50 end; LA must return the +10 end."""
    d = np.linspace(-50.0, 10.0, 400)
    res = rt.rbl(d, 5, 4, which="LA")
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[::-1][:5],
                               rtol=1e-9)
    lm = rt.rbl(d, 5, 4)  # sanity: default really is the other end
    np.testing.assert_allclose(lm.eigenvalues[0], -50.0, rtol=1e-9)


def test_sa_laplacian_smallest_modes():
    """Smallest 2D Dirichlet Laplacian modes (the Fiedler-vector use case),
    ascending, with honest eigenvector residuals."""
    nx = 24
    op = rt.Laplacian2D(nx=nx, ny=nx)
    res = rt.rbl(op, 6, 4, which="SA")
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[:6]
    np.testing.assert_allclose(res.eigenvalues, lam, rtol=1e-8)
    V = np.asarray(res.eigenvectors)
    AV = np.asarray(op.apply(res.eigenvectors))
    resid = np.linalg.norm(AV - V * res.eigenvalues[None, :], axis=0)
    assert resid.max() < 1e-6 * np.abs(lam).max() + 1e-8


def test_sa_matches_eigsh_sparse():
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(0)
    M = sp.random(500, 500, density=0.02, random_state=1)
    A = sp.csr_matrix(M + M.T)
    res = rt.rbl(A, 5, 4, which="SA")
    ref = np.sort(spla.eigsh(A, k=5, which="SA", tol=0)[0])
    np.testing.assert_allclose(res.eigenvalues, ref, rtol=1e-8)


def test_which_validation():
    with pytest.raises(ValueError):
        rt.rbl(np.ones(10), 2, 2, which="BE")


class TestDeflateAPI:
    """rbl(..., deflate=X): external deflation — compute the NEXT k pairs
    orthogonal to an already-known span (the restarted variant's lock set
    opened as an API; restarted.jl:53-57 semantics)."""

    def test_next_k_after_known_eigenvectors(self):
        import scipy.sparse as sp

        d = np.arange(1.0, 501.0)
        A = sp.diags(d)
        top = rt.rbl(A, 3, b=4)
        nxt = rt.rbl(A, 3, b=4, deflate=top.eigenvectors)
        np.testing.assert_allclose(
            nxt.eigenvalues, [497.0, 496.0, 495.0], rtol=1e-10
        )
        # returned vectors orthogonal to the deflated span
        X = np.asarray(top.eigenvectors).T @ np.asarray(nxt.eigenvectors)
        assert np.abs(X).max() < 1e-8

    def test_unnormalized_deflate_input(self):
        import scipy.sparse as sp

        d = np.arange(1.0, 301.0)
        A = sp.diags(d)
        # raw (scaled, non-orthonormal) directions for the top-2
        X = np.zeros((300, 2))
        X[299, 0] = 7.5
        X[298, 1] = -0.03
        res = rt.rbl(A, 2, b=4, deflate=X)
        np.testing.assert_allclose(res.eigenvalues, [298.0, 297.0], rtol=1e-10)

    def test_rank_deficient_deflate_keeps_only_true_span(self):
        import scipy.sparse as sp

        d = np.arange(1.0, 301.0)
        A = sp.diags(d)
        # 4 columns, rank 1: duplicated/scaled copies of e_300 plus a zero
        # column.  QR would invent 3 arbitrary orthonormal directions and
        # silently deflate eigenvectors the user never excluded; the SVD
        # rank screen must keep only span{e_300}.
        X = np.zeros((300, 4))
        X[299, 0] = 1.0
        X[299, 1] = -2.5
        X[299, 3] = 1e-3
        res = rt.rbl(A, 3, b=4, deflate=X)
        np.testing.assert_allclose(
            res.eigenvalues, [299.0, 298.0, 297.0], rtol=1e-10
        )

    def test_zero_deflate_is_ignored(self):
        import scipy.sparse as sp

        A = sp.diags(np.arange(1.0, 201.0))
        res = rt.rbl(A, 2, b=4, deflate=np.zeros((200, 3)))
        np.testing.assert_allclose(res.eigenvalues, [200.0, 199.0], rtol=1e-10)

    def test_deflate_shape_validation(self):
        import scipy.sparse as sp

        A = sp.diags(np.arange(1.0, 101.0))
        with pytest.raises(ValueError):
            rt.rbl(A, 2, deflate=np.ones((55, 2)))
