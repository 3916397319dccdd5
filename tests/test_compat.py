"""scipy.sparse.linalg-compat surface (rbl/compat.py): the migration
path for reference users — benchmark.jl:42 validates against ARPACK `eigs`
and images.jl:37-42 against `svds` through exactly these signatures."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla

import rbl as rt


def _sym_sparse(n=300, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng)
    A = sp.csr_matrix(A + A.T)
    A.setdiag(rng.standard_normal(n))
    return A


class TestEigsh:
    def test_matches_scipy_lm(self):
        A = _sym_sparse()
        w, V = rt.eigsh(A, k=6, tol=1e-9)
        w_ref = sla.eigsh(A, k=6, which="LM", tol=1e-10)[0]
        # both ascending algebraic
        np.testing.assert_allclose(w, w_ref, rtol=1e-7)
        # eigenvector residuals
        R = A @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-6

    @pytest.mark.parametrize("which", ["LA", "SA"])
    def test_matches_scipy_ends(self, which):
        A = _sym_sparse(seed=1)
        w = rt.eigsh(A, k=5, which=which, tol=1e-9,
                     return_eigenvectors=False)
        w_ref = sla.eigsh(A, k=5, which=which, tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(np.sort(w), np.sort(w_ref), rtol=1e-6)

    def test_ascending_order_and_vector_match(self):
        # diagonal operator: exact spectrum, exact eigenvectors
        d = np.linspace(-10.0, 10.0, 200)
        A = sp.diags(d)
        w, V = rt.eigsh(A, k=4, tol=1e-11)
        assert np.all(np.diff(w) >= 0)
        idx = np.argsort(np.abs(d))[-4:]
        np.testing.assert_allclose(
            np.sort(w), np.sort(d[idx]), rtol=1e-10, atol=1e-10
        )
        for j, wj in enumerate(w):
            i = int(np.argmin(np.abs(d - wj)))
            assert abs(abs(V[i, j]) - 1.0) < 1e-5

    def test_v0_seeds_start(self):
        A = _sym_sparse(seed=2)
        v0 = np.ones(A.shape[0])
        w1, _ = rt.eigsh(A, k=4, v0=v0, tol=1e-9)
        w2, _ = rt.eigsh(A, k=4, v0=v0, tol=1e-9)
        np.testing.assert_array_equal(w1, w2)  # deterministic
        w3 = sla.eigsh(A, k=4, which="LM", tol=1e-10,
                       return_eigenvectors=False)
        np.testing.assert_allclose(w1, np.sort(w3), rtol=1e-6)

    def test_ncv_caps_krylov(self):
        A = _sym_sparse(seed=3)
        w, _ = rt.eigsh(A, k=3, ncv=60, tol=1e-8)
        w_ref = sla.eigsh(A, k=3, which="LM", tol=1e-10,
                          return_eigenvectors=False)
        # a 60-column cap may stop short of the 1e-8 residual target —
        # accuracy is only subspace-limited here
        np.testing.assert_allclose(w, np.sort(w_ref), rtol=1e-4)

    def test_be_both_ends(self):
        A = _sym_sparse(seed=4)
        w, V = rt.eigsh(A, k=5, which="BE", tol=1e-9)
        w_ref = sla.eigsh(A, k=5, which="BE", tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(w, np.sort(w_ref), rtol=1e-6)
        R = A @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-6

    def test_be_k_exceeding_n_raises(self):
        # each BE half-solve passes its own kk <= n check, so without the
        # up-front guard k > n silently returned duplicated/wrong values
        A = sp.diags(np.linspace(1.0, 8.0, 8))
        with pytest.raises(ValueError):
            rt.eigsh(A, k=10, which="BE")

    def test_be_honors_explicit_block_size(self):
        # an explicit b must not be shrunk on the BE path (it used to be
        # clamped to _default_block(kk) of the half-solve)
        A = _sym_sparse(seed=7)
        w = rt.eigsh(A, k=4, which="BE", b=16, tol=1e-9,
                     return_eigenvectors=False)
        w_ref = sla.eigsh(A, k=4, which="BE", tol=1e-10,
                          return_eigenvectors=False)
        np.testing.assert_allclose(w, np.sort(w_ref), rtol=1e-6)

    def test_unsupported_modes_raise(self):
        # sigma, which="SM", and generalized M (tests/test_generalized.py)
        # are supported now; non-normal shift-invert modes and
        # sigma-with-SM (eigenvalues farthest from σ) still raise
        A = _sym_sparse()
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, k=3, sigma=1.0, mode="cayley")
        with pytest.raises(NotImplementedError):
            rt.eigsh(A, k=3, sigma=1.0, which="SM")
        with pytest.raises(ValueError):
            rt.eigsh(A, k=5, ncv=5)


class TestSvds:
    def test_matches_scipy(self):
        rng = np.random.default_rng(0)
        B = rng.standard_normal((160, 90))
        U, s, Vh = rt.svds(B, k=5)
        s_ref = sla.svds(B, k=5, return_singular_vectors=False)
        # both ascending
        np.testing.assert_allclose(s, np.sort(s_ref), rtol=1e-8)
        # factor shapes and reconstruction on the top-k subspace
        assert U.shape == (160, 5) and Vh.shape == (5, 90)
        np.testing.assert_allclose(
            U * s[None, :], B @ Vh.T, atol=1e-8 * s.max()
        )

    def test_values_only(self):
        rng = np.random.default_rng(1)
        B = rng.standard_normal((64, 128))
        s = rt.svds(B, k=4, return_singular_vectors=False)
        s_exact = np.linalg.svd(B, compute_uv=False)[:4]
        np.testing.assert_allclose(s, np.sort(s_exact), rtol=1e-9)

    def test_sparse_input(self):
        B = sp.random(200, 80, density=0.1, random_state=3)
        s = rt.svds(B, k=3, return_singular_vectors=False)
        s_ref = sla.svds(B, k=3, return_singular_vectors=False)
        np.testing.assert_allclose(s, np.sort(s_ref), rtol=1e-7)

    def test_which_unknown_raises(self):
        with pytest.raises(NotImplementedError):
            rt.svds(np.eye(10), k=2, which="LA")

    def test_random_state_generator_and_randomstate(self):
        # scipy accepts int | Generator | RandomState — all must work
        rng = np.random.default_rng(2)
        B = rng.standard_normal((50, 30))
        s_exact = np.sort(np.linalg.svd(B, compute_uv=False)[:3])
        for rs in (7, np.random.default_rng(7), np.random.RandomState(7)):
            s = rt.svds(B, k=3, return_singular_vectors=False,
                        random_state=rs)
            np.testing.assert_allclose(s, s_exact, rtol=1e-9)

    def test_v0_is_forwarded(self):
        # v0 seeds the Gram-side start block (scipy: length min(m, n));
        # a wrong-length v0 must raise instead of being silently ignored
        rng = np.random.default_rng(3)
        B = rng.standard_normal((60, 40))
        v0 = rng.standard_normal(40)  # min(m, n) = 40 (right Gram side)
        s = rt.svds(B, k=3, v0=v0, return_singular_vectors=False)
        s_exact = np.sort(np.linalg.svd(B, compute_uv=False)[:3])
        np.testing.assert_allclose(s, s_exact, rtol=1e-9)
        with pytest.raises(ValueError):
            rt.svds(B, k=3, v0=rng.standard_normal(60))


def test_reference_gpu_entry_aliases():
    """All four reference entry names (RBL.jl:119, RBL_gpu.jl:205,
    restarted.jl:97,196) resolve to the single device-agnostic core."""
    d = np.arange(1.0, 401.0)
    A = sp.diags(d)
    D, V = rt.RBL_gpu(A, 5, 5)
    np.testing.assert_allclose(D, d[::-1][:5], rtol=1e-12)
    D2, V2 = rt.RBL_gpu_restarted(A, 3)
    np.testing.assert_allclose(np.sort(D2)[::-1], d[::-1][:3], rtol=1e-8)
    assert V2 is not None  # unlike the reference's V=zeros quirk


class TestMaxiterRestarted:
    """eigsh(maxiter=...) routes through the explicitly restarted solver
    (ARPACK's implicit-restart budget ↦ max_restarts) — round-1 behavior
    silently ignored it."""

    def test_maxiter_converged_matches_dense(self):
        A = _sym_sparse(160, seed=5)
        w = rt.eigsh(A, k=4, maxiter=50, return_eigenvectors=False)
        dense = np.linalg.eigvalsh(A.toarray())
        ref = np.sort(dense[np.argsort(-np.abs(dense))[:4]])
        # scipy order for LM without vectors: ascending |λ|
        np.testing.assert_allclose(np.sort(w), np.sort(ref), rtol=1e-6)

    def test_maxiter_with_vectors_and_which_sa(self):
        A = _sym_sparse(120, seed=6)
        w, V = rt.eigsh(A, k=3, which="SA", maxiter=60, b=2)
        dense = np.linalg.eigvalsh(A.toarray())
        np.testing.assert_allclose(w, dense[:3], rtol=1e-6)
        R = A @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-5 * np.abs(dense).max()

    def test_maxiter_exhausted_raises_with_partial(self):
        from scipy.sparse.linalg import ArpackNoConvergence

        import scipy.sparse as sp

        # near-uniform spectrum, one tiny sweep, one restart: cannot lock
        # all 8 pairs
        A = sp.diags(np.arange(1.0, 201.0))
        with pytest.raises(ArpackNoConvergence) as ei:
            rt.eigsh(A, k=8, maxiter=1, ncv=10, b=1)
        # partial results ride on the exception, scipy-style
        assert ei.value.eigenvalues.shape[0] <= 8


def test_svds_which_sm_ascending():
    """svds(which="SM"): smallest singular triplets, s ascending, scipy
    conventions (round 1 raised NotImplementedError here)."""
    rng = np.random.default_rng(21)
    B = rng.standard_normal((70, 50)) + 5.0 * np.eye(70, 50)
    u, s, vh = rt.svds(B, k=4, which="SM")
    s_true = np.sort(np.linalg.svd(B, compute_uv=False))[:4]
    np.testing.assert_allclose(s, s_true, rtol=1e-8)
    assert np.all(np.diff(s) >= 0)
    np.testing.assert_allclose(
        B @ vh.T, u * s[None, :], atol=1e-7 * s_true[-1]
    )
    s_only = rt.svds(B, k=4, which="SM", return_singular_vectors=False)
    np.testing.assert_allclose(np.sort(s_only), s_true, rtol=1e-8)


def test_eigsh_be_maxiter_raises_on_nonconvergence():
    """Review regression: BE with maxiter must raise ArpackNoConvergence
    (like the non-BE maxiter path) instead of silently returning a
    partial spectrum."""
    from scipy.sparse.linalg import ArpackNoConvergence

    d = np.linspace(1.0, 1.001, 400)  # pathologically clustered
    A = sp.diags(d).tocsr()
    with pytest.raises(ArpackNoConvergence):
        rt.eigsh(A, k=8, which="BE", maxiter=1, ncv=10, tol=1e-14)


class TestMaxiterShiftInvert:
    """maxiter under shift-invert (VERDICT r2 item 8): the restart budget
    applies to the outer sweep on OP = (A − σI)⁻¹ — previously
    documented-but-ignored."""

    def test_sigma_maxiter_converged_matches_dense(self):
        import scipy.sparse as sp

        d = np.concatenate([np.arange(1.0, 97.0), [200.0, 201.0]])
        A = sp.diags(d)
        w, V = rt.eigsh(A, k=3, sigma=50.2, maxiter=40, tol=1e-9)
        exact = d[np.argsort(np.abs(d - 50.2))[:3]]
        np.testing.assert_allclose(np.sort(w), np.sort(exact), rtol=1e-8)
        R = A @ V - V * w[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-6 * d.max()

    def test_sm_maxiter_exhausted_raises(self):
        from scipy.sparse.linalg import ArpackNoConvergence

        import scipy.sparse as sp

        # clustered near zero: one restart of a tiny sweep cannot lock 8
        A = sp.diags(1.0 + np.arange(300.0) / 1e5)
        with pytest.raises(ArpackNoConvergence) as ei:
            rt.eigsh(A, k=8, which="SM", maxiter=1, ncv=10, b=1,
                     tol=1e-12)
        assert ei.value.eigenvalues.shape[0] <= 8

    def test_generalized_sigma_maxiter_converged(self):
        import scipy.sparse as sp

        rng = np.random.default_rng(11)
        d = np.arange(1.0, 81.0)
        A = sp.diags(d)
        m = 1.0 + rng.random(80)
        M = sp.diags(m)
        lam = d / m
        target = 10.0
        w, V = rt.eigsh(A, k=3, M=M, sigma=target, maxiter=40, tol=1e-9)
        exact = lam[np.argsort(np.abs(lam - target))[:3]]
        np.testing.assert_allclose(np.sort(w), np.sort(exact), rtol=1e-7)

    def test_generalized_plain_maxiter_exhausted_raises(self):
        from scipy.sparse.linalg import ArpackNoConvergence

        import scipy.sparse as sp

        A = sp.diags(np.arange(1.0, 201.0))
        M = sp.diags(np.ones(200))
        with pytest.raises(ArpackNoConvergence):
            rt.eigsh(A, k=8, M=M, maxiter=1, ncv=10, b=1, tol=1e-13)
