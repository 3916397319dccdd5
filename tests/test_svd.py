"""rbl_svd — truncated SVD via the matrix-free Gram operator.

The reference computes SVDs only inside the image demo (images.jl:21-25:
RBL on a densified BᵀB, U = B·V/σ).  These tests gate the first-class API
against numpy's exact SVD: singular values, factor orthonormality, singular
residuals ‖B·v − σ·u‖, and Eckart–Young optimality of the reconstruction.
"""

import numpy as np
import pytest

import rbl as rt


def _make_B(m, n, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    V, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    s = decay if decay is not None else np.linspace(50.0, 1.0, min(m, n))
    return (U * s[None, :]) @ V.T, np.sort(s)[::-1]


def _check(B, s_true, res, k):
    U, s, V = np.asarray(res.U), res.s, np.asarray(res.V)
    np.testing.assert_allclose(s, s_true[:k], rtol=1e-9)
    assert np.abs(U.T @ U - np.eye(k)).max() < 1e-8
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-8
    # singular residuals of each recovered triplet
    r1 = np.linalg.norm(B @ V - U * s[None, :], axis=0)
    r2 = np.linalg.norm(B.T @ U - V * s[None, :], axis=0)
    assert max(r1.max(), r2.max()) < 1e-7 * s[0]
    # Eckart–Young: the rank-k reconstruction error equals the optimal one
    err = np.linalg.norm(B - (U * s[None, :]) @ V.T)
    opt = np.linalg.norm(s_true[k:])
    assert err < opt + 1e-7 * s[0]


def test_svd_tall_matches_numpy():
    B, s_true = _make_B(120, 70, seed=1)
    res = rt.rbl_svd(B, 8, b=4)
    _check(B, s_true, res, 8)


def test_svd_wide_uses_small_side():
    """m < n routes the Lanczos solve through B·Bᵀ (m-dimensional Krylov
    vectors) and recovers V = Bᵀ·U/σ."""
    B, s_true = _make_B(60, 150, seed=2)
    res = rt.rbl_svd(B, 6, b=4)
    _check(B, s_true, res, 6)
    assert res.U.shape == (60, 6) and res.V.shape == (150, 6)


def test_svd_rank_deficient_zero_guard():
    """σ at the numerical-rank floor must produce zeroed cross-factor
    columns, not 1/σ garbage."""
    rng = np.random.default_rng(3)
    B = rng.standard_normal((80, 5)) @ rng.standard_normal((5, 90))
    res = rt.rbl_svd(B, 8, b=4, cfg=rt.RBLConfig(max_kryl_dim=64))
    s_true = np.linalg.svd(B, compute_uv=False)
    np.testing.assert_allclose(res.s[:5], s_true[:5], rtol=1e-8)
    # m < n: the solve ran on B·Bᵀ and V is the cross-recovered (guarded)
    # factor.  normal-equations resolvability floor (see solver/svd.py).
    V = np.asarray(res.V)
    dead = res.s <= np.sqrt(np.finfo(np.float64).eps * 90) * res.s[0]
    assert dead.any()  # rank 5 < k=8: the tail sits at the floor
    assert np.all(np.isfinite(V)) and np.all(np.isfinite(np.asarray(res.U)))
    assert np.abs(V[:, dead]).max() == 0.0


def test_svd_input_validation():
    with pytest.raises(ValueError):
        rt.rbl_svd(np.ones((4, 4, 4)), 2)
    with pytest.raises(ValueError):
        rt.rbl_svd(np.ones((10, 6)), 7)


def test_svd_scipy_sparse_input():
    import scipy.sparse as sp

    B, s_true = _make_B(90, 50, seed=4)
    B[np.abs(B) < 0.05] = 0.0
    s_true = np.linalg.svd(B, compute_uv=False)
    res = rt.rbl_svd(sp.csr_matrix(B), 5, b=5)
    np.testing.assert_allclose(res.s, s_true[:5], rtol=1e-9)


def test_svd_sharded_mesh_matches_single_device():
    """rbl_svd over an 8-device row mesh: B sharded on the Gram dimension,
    Gram contractions psum-reduced by GSPMD; results must match the
    unsharded solve."""
    from rbl.parallel.mesh import make_row_mesh

    B, s_true = _make_B(256, 96, seed=7)
    mesh = make_row_mesh(8)
    res = rt.rbl_svd(B, 6, b=4, cfg=rt.RBLConfig(mesh=mesh, block_size=4))
    _check(B, s_true, res, 6)


def test_rect_coo_apply_and_transpose():
    """RectCooOperator: rectangular SpMM matches dense, both orientations."""
    import scipy.sparse as sp

    from rbl.ops.spmm.coo import RectCooOperator

    rng = np.random.default_rng(11)
    B = sp.random(73, 41, density=0.15, random_state=rng).tocsr()
    op = RectCooOperator.from_scipy(B, dtype=np.float64)
    X = rng.standard_normal((41, 4))
    np.testing.assert_allclose(np.asarray(op.apply(X)), B @ X, rtol=1e-13)
    Y = rng.standard_normal((73, 4))
    np.testing.assert_allclose(np.asarray(op.T.apply(Y)), B.T @ Y, rtol=1e-13)
    assert op.shape == (73, 41) and op.T.shape == (41, 73)


def test_svd_sparse_stays_sparse_and_recovers_factors():
    """The sparse rbl_svd path (SparseGramOperator): full factor recovery,
    both the tall (n-side Gram) and wide (m-side Gram) orientations."""
    import scipy.sparse as sp

    import rbl as rt

    rng = np.random.default_rng(12)
    for shape in [(300, 120), (120, 300)]:
        B = sp.random(*shape, density=0.08, random_state=rng).tocsr()
        res = rt.rbl_svd(B, 5, b=5)
        s_true = np.linalg.svd(B.toarray(), compute_uv=False)[:5]
        np.testing.assert_allclose(res.s, s_true, rtol=1e-8)
        U, V = np.asarray(res.U), np.asarray(res.V)
        # factor orthonormality + reconstruction on the top-k subspace
        np.testing.assert_allclose(U.T @ U, np.eye(5), atol=1e-8)
        np.testing.assert_allclose(V.T @ V, np.eye(5), atol=1e-8)
        np.testing.assert_allclose(
            B @ V, U * res.s[None, :], atol=1e-8 * res.s[0]
        )


def test_svd_smallest_which_sm():
    """which="SM": smallest singular triplets via σ = 0 shift-invert on
    the Gram operator (scipy's svds(which="SM") surface, which round 1
    rejected)."""
    B, s_true = _make_B(90, 60, seed=4)
    k = 5
    res = rt.rbl_svd(B, k, b=4, which="SM")
    s_small = np.sort(s_true)[:k]            # ascending smallest
    np.testing.assert_allclose(np.sort(res.s), s_small, rtol=1e-8)
    U, s, V = np.asarray(res.U), res.s, np.asarray(res.V)
    assert np.abs(U.T @ U - np.eye(k)).max() < 1e-8
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-8
    r1 = np.linalg.norm(B @ V - U * s[None, :], axis=0)
    r2 = np.linalg.norm(B.T @ U - V * s[None, :], axis=0)
    assert max(r1.max(), r2.max()) < 1e-6 * s_true[0]


def test_svd_sm_sparse_factor():
    """SM path on a sparse factor keeps B sparse (SparseGramOperator +
    Jacobi-preconditioned inner MINRES through its diagonal protocol)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(13)
    # well-conditioned sparse factor: random sparse + identity tail
    B = (sp.random(80, 80, density=0.1, random_state=rng)
         + 3.0 * sp.eye(80)).tocsr()
    res = rt.rbl_svd(B, 4, b=4, which="SM")
    s_true = np.sort(np.linalg.svd(B.toarray(), compute_uv=False))[:4]
    np.testing.assert_allclose(np.sort(res.s), s_true, rtol=1e-7)
