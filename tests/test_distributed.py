"""Row-sharded multi-device tests on the 8-virtual-CPU mesh — the stand-in
for multi-GPU testing (SURVEY §4: the reference has no distributed
tests because nothing distributed exists)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import rbl as rt
from rbl.config import RBLConfig
from rbl.parallel.dist_spmm import ShardedEllSpMM, ShardedLaplacian2D
from rbl.parallel.mesh import make_row_mesh, shard_rows


def test_sharded_laplacian_matches_single_device(eight_devices):
    mesh = make_row_mesh(8)
    nx, ny, b = 32, 16, 3
    op_d = ShardedLaplacian2D(nx=nx, ny=ny, mesh=mesh, _dtype=jnp.float64)
    op_s = rt.Laplacian2D(nx=nx, ny=ny)
    X = np.random.default_rng(0).standard_normal((nx * ny, b))
    Xs = shard_rows(jnp.asarray(X), mesh)
    out_d = np.asarray(op_d.apply(Xs))
    out_s = np.asarray(op_s.apply(jnp.asarray(X)))
    np.testing.assert_allclose(out_d, out_s, atol=1e-12)


def test_sharded_ell_spmm_matches_scipy(eight_devices):
    import scipy.sparse as sp

    mesh = make_row_mesh(8)
    n, b = 512, 4
    rng = np.random.default_rng(1)
    M = sp.random(n, n, density=0.02, random_state=2)
    A = sp.csr_matrix(M + M.T)
    op = ShardedEllSpMM.from_scipy(A, mesh)
    X = rng.standard_normal((n, b))
    out = np.asarray(op.apply(shard_rows(jnp.asarray(X), mesh)))
    np.testing.assert_allclose(out, A @ X, atol=1e-12)


def test_sharded_solve_matches_single_device(eight_devices):
    """Full solve over the mesh must reproduce the single-device spectrum:
    the sharded Krylov store + psum Grams change the layout, not the math."""
    mesh = make_row_mesh(8)
    nx, ny, k, b = 32, 32, 6, 4
    cfg = RBLConfig(block_size=b, mesh=mesh, max_kryl_dim=512)
    res_d = rt.rbl(
        ShardedLaplacian2D(nx=nx, ny=ny, mesh=mesh, _dtype=jnp.float64),
        k, b, cfg=cfg,
    )
    res_s = rt.rbl(rt.Laplacian2D(nx=nx, ny=ny), k, b)
    np.testing.assert_allclose(res_d.eigenvalues, res_s.eigenvalues, rtol=1e-9)
    # recovered vectors live row-sharded; check residuals through the op
    V = res_d.eigenvectors
    AV = np.asarray(rt.Laplacian2D(nx=nx, ny=ny).apply(V.astype(jnp.float64)))
    r = AV - np.asarray(V) * res_d.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-5


def test_graft_entry_dryrun(eight_devices):
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_coo_spmm_matches_scipy(eight_devices):
    """Skewed matrix over the mesh: each device's COO shard (LOCAL row ids,
    padded to the max shard nnz) must reproduce the scipy product after
    the all-gather + sorted segment_sum."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM

    mesh = make_row_mesh(8)
    n, b = 512, 4
    rng = np.random.default_rng(3)
    M = sp.random(n, n, density=0.01, random_state=4).tolil()
    for r in rng.choice(n, 3, replace=False):  # dense rows → shard imbalance
        M[r, rng.choice(n, n // 2, replace=False)] = 1.0
    A = sp.csr_matrix(M + M.T)
    op = ShardedCooSpMM.from_scipy(A, mesh)
    X = rng.standard_normal((n, b))
    out = np.asarray(op.apply(shard_rows(jnp.asarray(X), mesh)))
    np.testing.assert_allclose(out, A @ X, atol=1e-12)


def test_sharded_coo_bf16_accumulates_in_f32(eight_devices):
    """Sub-f32 inputs must segment-sum in f32 (the _pet upcast), matching
    the single-device CooOperator: with a few long rows summing thousands
    of entries, raw bf16 accumulation loses ~2^-8 relative per row."""
    import scipy.sparse as sp

    from rbl.ops.spmm.coo import CooOperator
    from rbl.parallel.dist_spmm import ShardedCooSpMM

    mesh = make_row_mesh(8)
    n, b = 512, 4
    rng = np.random.default_rng(9)
    M = sp.lil_matrix((n, n))
    for r in rng.choice(n, 4, replace=False):  # long rows: the skew case
        M[r, :] = rng.standard_normal(n)
    A = sp.csr_matrix(M + M.T)
    X = rng.standard_normal((n, b))
    Xb = jnp.asarray(X, dtype=jnp.bfloat16)
    ref = np.asarray(
        CooOperator.from_scipy(A, dtype=np.float32).apply(Xb), dtype=np.float64
    )
    op = ShardedCooSpMM.from_scipy(A, mesh, dtype=np.float32)
    out = np.asarray(op.apply(shard_rows(Xb, mesh)), dtype=np.float64)
    # identical accumulation dtype → near-identical results (the all-gather
    # keeps bf16 for X itself; only the reduction is upcast)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=2e-3 * scale)


def test_sharded_coo_solve_end_to_end(eight_devices):
    """Sharded-COO operator through the full solver vs dense eigh."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM

    mesh = make_row_mesh(8)
    n, k, b = 256, 5, 4
    rng = np.random.default_rng(5)
    M = sp.random(n, n, density=0.03, random_state=6)
    A = sp.csr_matrix(M + M.T)
    cfg = RBLConfig(block_size=b, mesh=mesh, max_kryl_dim=256)
    res = rt.rbl(ShardedCooSpMM.from_scipy(A, mesh), k, b, cfg=cfg)
    w = np.linalg.eigvalsh(A.toarray())
    ref = w[np.argsort(-np.abs(w))][:k]
    np.testing.assert_allclose(res.eigenvalues, ref, rtol=1e-9)


def test_sharded_sparse_svd_matches_unsharded(eight_devices):
    """Sparse rbl_svd over a mesh: both rectangular COO factors live
    row-banded across devices; result must match the single-device solve."""
    import scipy.sparse as sp

    import rbl as rt
    from rbl.parallel.mesh import make_row_mesh

    rng = np.random.default_rng(21)
    B = sp.random(320, 128, density=0.06, random_state=rng).tocsr()
    s_ref = np.linalg.svd(B.toarray(), compute_uv=False)[:4]
    mesh = make_row_mesh(8)
    res = rt.rbl_svd(B, 4, b=4, cfg=rt.RBLConfig(mesh=mesh, block_size=4))
    np.testing.assert_allclose(res.s, s_ref, rtol=1e-8)
    U, V = np.asarray(res.U), np.asarray(res.V)
    np.testing.assert_allclose(
        B @ V, U * res.s[None, :], atol=1e-8 * res.s[0]
    )
    # indivisible dims fall back to the dense sharded path, same answer
    B2 = sp.random(321, 128, density=0.06, random_state=rng).tocsr()
    s2_ref = np.linalg.svd(B2.toarray(), compute_uv=False)[:3]
    res2 = rt.rbl_svd(B2, 3, b=4, cfg=rt.RBLConfig(mesh=mesh, block_size=4))
    np.testing.assert_allclose(res2.s, s2_ref, rtol=1e-8)


def test_sharded_diagonals(eight_devices):
    """diagonal() of every sharded operator must match the scipy/dense
    diagonal — it feeds the Jacobi preconditioner of distributed
    shift-invert solves (ops/minres.py jacobi_psolve)."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM

    mesh = make_row_mesh(8)
    n = 512
    rng = np.random.default_rng(7)
    M = sp.random(n, n, density=0.02, random_state=8)
    A = sp.csr_matrix(M + M.T)
    A.setdiag(rng.standard_normal(n) + 3.0)
    want = A.diagonal()
    for cls in (ShardedCooSpMM, ShardedEllSpMM):
        got = np.asarray(cls.from_scipy(A, mesh).diagonal())
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0,
                                   err_msg=cls.__name__)
    lp = ShardedLaplacian2D(nx=32, ny=16, mesh=mesh, _dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(lp.diagonal()), 4.0)


def test_sharded_bsr_matches_single_device(eight_devices):
    """Sharded Pallas-BSR operator (boundary-only ghost exchange) must
    reproduce both scipy and the single-device BlockSparseOperator, on a
    banded matrix (two-neighbor coupling) and a long-range one (ghosts on
    several shifts)."""
    import scipy.sparse as sp

    from rbl.ops.spmm.pallas_bsr import BlockSparseOperator
    from rbl.parallel.dist_spmm import ShardedBlockSparseOperator

    mesh = make_row_mesh(8)
    n, b, t = 512, 4, 16  # 16x16 tiles: 32 block rows, 4 per device
    rng = np.random.default_rng(11)

    diags = [rng.standard_normal(n - abs(o)) for o in (-20, -1, 0, 1, 20)]
    A_band = sp.csr_matrix(sp.diags(diags, [-20, -1, 0, 1, 20]))
    A_band = sp.csr_matrix(A_band + A_band.T)

    M = sp.random(n, n, density=0.02, random_state=12)
    A_rand = sp.csr_matrix(M + M.T)

    X = rng.standard_normal((n, b)).astype(np.float64)
    for A in (A_band, A_rand):
        op = ShardedBlockSparseOperator.from_scipy(
            A, mesh, dtype=jnp.float64, bm=t, bk=t
        )
        out = np.asarray(op.apply(shard_rows(jnp.asarray(X), mesh)))
        np.testing.assert_allclose(out, A @ X, atol=1e-12)
        op1 = BlockSparseOperator.from_scipy(A, dtype=jnp.float64, bm=t, bk=t)
        np.testing.assert_allclose(
            out, np.asarray(op1.apply(jnp.asarray(X))), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(op.diagonal()), A.diagonal(), atol=1e-14
        )

    # comm volume ∝ boundary blocks: the banded matrix (bandwidth 20 < one
    # 4-block band of 64 rows) needs ghosts only from the two neighbor
    # shifts — 2 of the 16-row blocks each way (20 rows straddle a block
    # boundary), vs 28 blocks for an all-gather
    op_band = ShardedBlockSparseOperator.from_scipy(
        A_band, mesh, dtype=jnp.float64, bm=t, bk=t
    )
    caps = op_band.caps
    assert caps[0] == 2 and caps[-1] == 2, caps
    assert all(c == 0 for c in caps[1:-1]), caps
    assert op_band.comm_blocks_per_apply() == 4  # all-gather would move 28


def test_sharded_bsr_solve_end_to_end(eight_devices):
    """Full eigensolve through the sharded BSR operator vs dense eigh."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedBlockSparseOperator

    mesh = make_row_mesh(8)
    n, k, b, t = 512, 5, 4, 16
    rng = np.random.default_rng(13)
    diags = [rng.standard_normal(n - abs(o)) for o in (-17, 0, 17)]
    A = sp.csr_matrix(sp.diags(diags, [-17, 0, 17]))
    A = sp.csr_matrix(A + A.T)
    op = ShardedBlockSparseOperator.from_scipy(
        A, mesh, dtype=jnp.float64, bm=t, bk=t
    )
    cfg = RBLConfig(block_size=b, mesh=mesh, max_kryl_dim=256)
    res = rt.rbl(op, k, b, cfg=cfg)
    w = np.linalg.eigvalsh(A.toarray())
    ref = w[np.argsort(-np.abs(w))][:k]
    np.testing.assert_allclose(res.eigenvalues, ref, rtol=1e-9)


@pytest.mark.slow  # ~55s integration; sharded path covered by test_sharded_solve_matches_single_device
def test_sharded_generalized_pencil(eight_devices):
    """rbl_generalized over a mesh: A and M both ShardedCooSpMM — the
    Chebyshev M^{−1/2} series, the pencil sweep, and the Rayleigh
    refinement must all compose with GSPMD (the docs claim the transform
    'shards over the mesh'; this test substantiates it).  Also one
    interior probe (mode 3: sharded blocked-MINRES + Jacobi from the
    SHARDED diagonal())."""
    import scipy.linalg
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM
    from rbl.solver.generalized import rbl_generalized

    mesh = make_row_mesh(8)
    n = 256
    A = sp.diags(np.linspace(1.0, 300.0, n)).tocsr()
    M = sp.diags([0.3 * np.ones(n - 1), 2.0 * np.ones(n),
                  0.3 * np.ones(n - 1)], [-1, 0, 1]).tocsr()
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    Ash = ShardedCooSpMM.from_scipy(A, mesh)
    Msh = ShardedCooSpMM.from_scipy(M, mesh)
    cfg = RBLConfig(block_size=4, mesh=mesh, tol=1e-9, max_kryl_dim=256)
    res = rbl_generalized(Ash, Msh, 4, cfg=cfg, which="LA")
    np.testing.assert_allclose(res.eigenvalues, w[::-1][:4], rtol=1e-10)
    assert res.converged
    sig = float(w[128] + 0.3 * (w[129] - w[128]))
    resi = rbl_generalized(Ash, Msh, 3, cfg=cfg, which="LM", sigma=sig)
    exact = w[np.argsort(np.abs(w - sig), kind="stable")[:3]]
    np.testing.assert_allclose(resi.eigenvalues, exact, rtol=1e-9)


def test_row_ghost_exchange_matches_scipy(eight_devices):
    """Boundary-only row-ghost exchange (ShardedEllSpMM/ShardedCooSpMM):
    a banded matrix must pick the ghost path (caps set, comm ∝ boundary
    rows) and reproduce scipy exactly; a long-range permutation matrix
    exercises ghosts on far shifts."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM, ShardedEllSpMM

    mesh = make_row_mesh(8)
    n, b = 512, 4  # ml = 64
    rng = np.random.default_rng(21)

    diags = [rng.standard_normal(n - abs(o)) for o in (-9, -1, 0, 1, 9)]
    A_band = sp.csr_matrix(sp.diags(diags, [-9, -1, 0, 1, 9]))
    A_band = sp.csr_matrix(A_band + A_band.T)

    # long-range but sparse coupling: band + a few cross-device arcs
    M = A_band.tolil(copy=True)
    for i in range(0, n, 97):
        M[i, (i + 3 * 64 + 11) % n] = 1.5
        M[(i + 3 * 64 + 11) % n, i] = 1.5
    A_far = sp.csr_matrix(M)

    X = rng.standard_normal((n, b))
    Xs = shard_rows(jnp.asarray(X), mesh)
    for A in (A_band, A_far):
        for cls in (ShardedEllSpMM, ShardedCooSpMM):
            op = cls.from_scipy(A, mesh)
            assert op.caps is not None, (cls.__name__, "expected ghost path")
            np.testing.assert_allclose(
                np.asarray(op.apply(Xs)), A @ X, atol=1e-12
            )
            np.testing.assert_allclose(
                np.asarray(op.diagonal()), A.diagonal(), atol=1e-14
            )
        # bandwidth 9 < ml=64: ghosts only from the two neighbor shifts,
        # ≤ 9 rows each way (vs 448 rows for an all-gather)
        op_band = ShardedCooSpMM.from_scipy(A_band, mesh)
        if A is A_band:
            assert op_band.comm_rows_per_apply() <= 18
            assert op_band.comm_rows_per_apply() < 0.05 * (n - n // 8)


def test_row_ghost_fallback_on_dense_coupling(eight_devices):
    """Dense-coupling sparsity (ghost volume ≥ half the all-gather's) must
    auto-fall back to the all-gather (caps is None) and still be exact;
    exchange='ghost' forces the boundary path and must agree."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM, ShardedEllSpMM

    mesh = make_row_mesh(8)
    n, b = 512, 4
    rng = np.random.default_rng(22)
    M = sp.random(n, n, density=0.15, random_state=23)
    A = sp.csr_matrix(M + M.T)
    X = rng.standard_normal((n, b))
    Xs = shard_rows(jnp.asarray(X), mesh)
    for cls in (ShardedEllSpMM, ShardedCooSpMM):
        op = cls.from_scipy(A, mesh)
        assert op.caps is None, (cls.__name__, "expected all-gather fallback")
        assert op.comm_rows_per_apply() == n - n // 8
        np.testing.assert_allclose(np.asarray(op.apply(Xs)), A @ X, atol=1e-12)
        forced = cls.from_scipy(A, mesh, exchange="ghost")
        assert forced.caps is not None
        np.testing.assert_allclose(
            np.asarray(forced.apply(Xs)), A @ X, atol=1e-12
        )


def test_row_ghost_solve_end_to_end(eight_devices):
    """Full eigensolve through the ghost-path ShardedCooSpMM (banded
    operator, boundary-only exchange) vs dense eigh."""
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM

    mesh = make_row_mesh(8)
    n, k, b = 512, 5, 4
    rng = np.random.default_rng(24)
    diags = [rng.standard_normal(n - abs(o)) for o in (-5, 0, 5)]
    A = sp.csr_matrix(sp.diags(diags, [-5, 0, 5]))
    A = sp.csr_matrix(A + A.T)
    op = ShardedCooSpMM.from_scipy(A, mesh)
    assert op.caps is not None
    cfg = RBLConfig(block_size=b, mesh=mesh, max_kryl_dim=256)
    res = rt.rbl(op, k, b, cfg=cfg)
    w = np.linalg.eigvalsh(A.toarray())
    ref = w[np.argsort(-np.abs(w))][:k]
    np.testing.assert_allclose(res.eigenvalues, ref, rtol=1e-9)
