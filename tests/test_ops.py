"""Kernel-level unit tests — coverage the reference lacks entirely
(SURVEY §4: "no unit tests of individual kernels"): QR orthogonality, band-T
assembly vs dense, banded eig vs numpy, reorthogonalization, operators."""

import numpy as np
import pytest

import jax.numpy as jnp

import rbl as rt
from rbl.ops.band import BlockTridiagonalT, band_to_dense
from rbl.ops.eig import (
    check_convergence,
    eig_banded_host,
    ritz_residual_bounds,
    sort_eig_abs,
)
from rbl.ops.qr import block_qr
from rbl.ops.reorth import local_reorth, partial_reorth, project_out


@pytest.mark.parametrize("method", ["householder", "cholqr2", "cholqr3"])
def test_block_qr_orthonormal(method):
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((500, 8)))
    Q, R = block_qr(X, method=method)
    assert np.linalg.norm(np.asarray(Q.T @ Q) - np.eye(8)) < 1e-12
    np.testing.assert_allclose(np.asarray(Q @ R), np.asarray(X), atol=1e-10)
    # R upper triangular
    assert np.allclose(np.tril(np.asarray(R), -1), 0.0, atol=1e-10)


def test_cholqr2_ill_conditioned():
    """Shifted CholeskyQR must survive a nearly rank-deficient block
    (breakdown case the reference never guards — SURVEY §5)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((300, 6))
    X[:, 5] = X[:, 0] + 1e-9 * X[:, 5]  # near-dependent column
    Q, R = block_qr(jnp.asarray(X), method="cholqr3")
    assert np.all(np.isfinite(np.asarray(Q)))
    assert np.linalg.norm(np.asarray(Q.T @ Q) - np.eye(6)) < 1e-8


def test_band_assembly_matches_dense():
    """insertA!/insertB! semantics (common.jl:9-26): the banded buffer must
    expand to the exact block-tridiagonal T."""
    rng = np.random.default_rng(2)
    b, nblk = 3, 4
    A_blocks = [rng.standard_normal((b, b)) for _ in range(nblk)]
    A_blocks = [(M + M.T) / 2 for M in A_blocks]
    B_blocks = [np.triu(rng.standard_normal((b, b))) for _ in range(nblk)]

    T = BlockTridiagonalT(b, max_cols=nblk * b)
    for i in range(nblk):
        T.append_diag(A_blocks[i])
        T.set_subdiag(B_blocks[i], i)

    m = nblk * b
    expect = np.zeros((m, m))
    for i in range(nblk):
        s = i * b
        expect[s : s + b, s : s + b] = A_blocks[i]
        if i < nblk - 1:
            expect[s + b : s + 2 * b, s : s + b] = B_blocks[i]
            expect[s : s + b, s + b : s + 2 * b] = B_blocks[i].T
    got = T.dense()
    # the last B block hangs off the end of T and is ignored by dense()
    np.testing.assert_allclose(got, expect, atol=1e-14)
    np.testing.assert_allclose(band_to_dense(T.view()), expect, atol=1e-14)


def test_eig_banded_matches_numpy():
    rng = np.random.default_rng(3)
    b, nblk = 2, 5
    T = BlockTridiagonalT(b, max_cols=nblk * b)
    for i in range(nblk):
        M = rng.standard_normal((b, b))
        T.append_diag(M + M.T)
        T.set_subdiag(np.triu(rng.standard_normal((b, b))), i)
    w, V = eig_banded_host(T.view())
    w_np = np.linalg.eigvalsh(T.dense())
    np.testing.assert_allclose(w, w_np, atol=1e-12)
    Td = T.dense()
    np.testing.assert_allclose(Td @ V, V * w[None, :], atol=1e-10)


def test_sort_eig_abs():
    w = np.array([-5.0, 1.0, 3.0, -2.0])
    V = np.eye(4)
    wk, Vk = sort_eig_abs(w, V, 2)
    assert list(wk) == [3.0, -5.0]  # ascending by |λ|
    assert Vk.shape == (4, 2)


def test_ritz_residual_bounds_and_convergence():
    b, m, k = 2, 8, 3
    rng = np.random.default_rng(4)
    Bi = np.triu(rng.standard_normal((b, b)))
    V = np.linalg.qr(rng.standard_normal((m, k)))[0]
    bounds = ritz_residual_bounds(Bi, V, b)
    expect = np.linalg.norm(Bi @ V[-b:, :], axis=0)
    np.testing.assert_allclose(np.asarray(bounds), expect)
    assert check_convergence(Bi, V, b, k, tol=expect.max() + 1e-12)
    assert not check_convergence(Bi, V, b, k, tol=expect.min() / 2)


def test_project_out_and_partial_reorth():
    rng = np.random.default_rng(5)
    n, b = 400, 4
    basis = np.linalg.qr(rng.standard_normal((n, 3 * b)))[0]
    # zero-pad the buffer: padding must not change the projection
    buf = np.concatenate([basis, np.zeros((n, 2 * b))], axis=1)
    W = rng.standard_normal((n, b))
    out = np.asarray(project_out(jnp.asarray(buf), jnp.asarray(W)))
    assert np.abs(basis.T @ out).max() < 1e-12
    Qi, Qp = partial_reorth(jnp.asarray(buf), jnp.asarray(W), jnp.asarray(W + 1.0))
    assert np.abs(basis.T @ np.asarray(Qi)).max() < 1e-12
    assert np.abs(basis.T @ np.asarray(Qp)).max() < 1e-11


def test_local_reorth_cgs2():
    rng = np.random.default_rng(6)
    n, b = 300, 5
    Qprev = np.linalg.qr(rng.standard_normal((n, b)))[0]
    Qi = rng.standard_normal((n, b)) + Qprev @ rng.standard_normal((b, b))
    out = np.asarray(local_reorth(jnp.asarray(Qi), jnp.asarray(Qprev)))
    assert np.abs(Qprev.T @ out).max() < 1e-13
    assert np.linalg.norm(out.T @ out - np.eye(b)) < 1e-13


def test_operators_match_dense():
    rng = np.random.default_rng(7)
    n, b = 64, 3
    M = rng.standard_normal((n, n))
    M = (M + M.T) / 2
    M[np.abs(M) < 1.0] = 0.0  # sparsify
    X = rng.standard_normal((n, b))
    expect = M @ X

    dense = rt.DenseOperator(jnp.asarray(M))
    np.testing.assert_allclose(np.asarray(dense.apply(jnp.asarray(X))), expect, atol=1e-12)

    ell = rt.SparseEllOperator.from_dense(M)
    np.testing.assert_allclose(np.asarray(ell.apply(jnp.asarray(X))), expect, atol=1e-12)


def test_laplacian_operator_matches_explicit():
    import scipy.sparse as sp

    nx = ny = 6
    lap = rt.Laplacian2D(nx=nx, ny=ny)
    n = nx * ny
    I = sp.eye(nx)
    D1 = sp.diags([-1, 2, -1], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(D1, I) + sp.kron(I, D1)).toarray()
    X = np.random.default_rng(8).standard_normal((n, 2))
    np.testing.assert_allclose(np.asarray(lap.apply(jnp.asarray(X))), A @ X, atol=1e-12)


def test_laplacian_eigen_end_to_end():
    """Cross-validate against scipy eigsh on the 2D Laplacian — the
    benchmark.jl ARPACK cross-check (benchmark.jl:42), miniaturized."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    nx = ny = 20
    lap = rt.Laplacian2D(nx=nx, ny=ny)
    I = sp.eye(nx)
    D1 = sp.diags([-1, 2, -1], [-1, 0, 1], shape=(nx, nx))
    A = sp.kron(D1, I) + sp.kron(I, D1)
    k = 6
    expect = spla.eigsh(A, k=k, which="LM", return_eigenvectors=False)[::-1]
    res = rt.rbl(lap, k, 4)
    np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)


def test_eig_banded_topk_matches_full():
    """The selective top-k path (eigvals + index-range inverse iteration)
    must reproduce sort_eig_abs over the full dsbevd factorization,
    including indefinite spectra where the top-k straddles both ends."""
    from rbl.ops.eig import eig_banded_topk

    rng = np.random.default_rng(11)
    b, m = 3, 60
    band = np.zeros((b + 1, m))
    band[0] = rng.standard_normal(m) * 5.0  # indefinite diagonal
    band[1:, : m - 1] = 0.3 * rng.standard_normal((b, m - 1))
    w, V = eig_banded_host(band)
    for k in [1, 5, 17]:
        w_ref, V_ref = sort_eig_abs(w, V, k)
        w_k, V_k = eig_banded_topk(band, k)
        np.testing.assert_allclose(w_k, w_ref, atol=1e-12)
        # eigenvectors up to sign
        for j in range(k):
            d = min(np.linalg.norm(V_k[:, j] - V_ref[:, j]),
                    np.linalg.norm(V_k[:, j] + V_ref[:, j]))
            assert d < 1e-9
    # k == m degenerates to the full solve
    w_k, V_k = eig_banded_topk(band, m)
    np.testing.assert_allclose(w_k, sort_eig_abs(w, V, m)[0], atol=1e-12)


def test_eig_banded_topk_dense_matches_full():
    """The MRRR dense-subset path (the poll hot path) must reproduce
    sort_eig_abs over the full dsbevd factorization, including indefinite
    spectra where the top-k straddles both ends, and must fall back to the
    full solve at large k/m."""
    from rbl.ops.eig import eig_banded_topk_dense

    rng = np.random.default_rng(12)
    b, m = 3, 60
    band = np.zeros((b + 1, m))
    band[0] = rng.standard_normal(m) * 5.0  # indefinite diagonal
    band[1:, : m - 1] = 0.3 * rng.standard_normal((b, m - 1))
    w, V = eig_banded_host(band)
    for k in [1, 5, 17, 40]:  # 40 > m/3 exercises the fallback
        w_ref, V_ref = sort_eig_abs(w, V, k)
        w_k, V_k = eig_banded_topk_dense(band, k)
        np.testing.assert_allclose(w_k, w_ref, atol=1e-12)
        assert V_k.shape == (m, k)
        for j in range(k):
            d = min(np.linalg.norm(V_k[:, j] - V_ref[:, j]),
                    np.linalg.norm(V_k[:, j] + V_ref[:, j]))
            assert d < 1e-9


def test_basis_store_host_offload_solve():
    """Two-tier basis store: a device cap far below the Krylov need forces
    pinned-host offload + hybrid reorth + two-tier recovery; eigenpairs
    must match the all-device solve (reference hybrid_part_reorth!
    semantics, RBL_gpu.jl:59-81)."""
    import rbl as rt

    n, k, b = 600, 5, 4
    d = np.linspace(1.0, 80.0, n) ** 2
    base = rt.RBLConfig(block_size=b, max_kryl_dim=200)
    res_full = rt.rbl(d, k, b, cfg=base)
    res_off = rt.rbl(d, k, b, cfg=base.replace(basis_device_cap_cols=48))
    np.testing.assert_allclose(
        res_off.eigenvalues, res_full.eigenvalues, rtol=1e-10
    )
    Vo = np.asarray(res_off.eigenvectors)
    resid = np.linalg.norm(
        d[:, None] * Vo - Vo * res_off.eigenvalues[None, :], axis=0
    )
    assert resid.max() < 1e-6 * d.max()


def test_host_offload_dominant_spectrum_orthogonality():
    """Offload + dominant outliers: EVERY full-scrub step inside a fused
    chunk must see the host tier, not just the window's first.  Leaks along
    offloaded dominant directions re-amplify ~|λ|max/|λ|min per step, so a
    once-per-window host projection loses the basis (measured ‖QᵀQ−I‖
    1.5e-15 → 3.9e-6 starting exactly at the offload boundary, and wrong
    eigenvalues: 26.2 reported where 85 belongs)."""
    import scipy.sparse as sp

    import rbl as rt

    n, k, b = 300, 6, 4
    d = np.linspace(1.0, 50.0, n)
    d[:3] = [-80.0, 85.0, 90.0]  # dominant outliers atop the bulk
    A = sp.diags(d)
    base = rt.RBLConfig(block_size=b, max_kryl_dim=160)
    res = rt.rbl(A, k, b, cfg=base.replace(basis_device_cap_cols=64))
    expect = d[np.argsort(-np.abs(d))][:k]
    # the bug reported 26.2 where 85 belongs; the healthy (cap-limited)
    # solve converges the slowest bulk pair to ~1e-8 relative
    np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-7)
    # offload must reproduce the all-device solve: identical eigenvalues
    # and true residuals, orthonormal returned vectors
    ctrl = rt.rbl(A, k, b, cfg=base)
    np.testing.assert_allclose(res.eigenvalues, ctrl.eigenvalues, rtol=1e-10)
    np.testing.assert_allclose(
        res.residual_bounds, ctrl.residual_bounds, rtol=1e-3, atol=1e-12
    )
    V = np.asarray(res.eigenvectors)
    assert np.abs(V.T @ V - np.eye(k)).max() < 1e-10


def test_host_offload_T_consistency():
    """With offload active, T must equal QᵀAQ to rounding: host-tier
    reorthogonalization applies to the newborn residual at birth (the
    split-step path), never to live blocks whose T couplings are already
    recorded.  The reference's hybrid_part_reorth! (RBL_gpu.jl:59-81)
    scrubs live blocks retroactively — O(‖leak‖·‖A‖) T error (measured
    ~1e-7 at the cap under that scheme; this gate is 1e-10)."""
    import jax

    import rbl as rt
    from rbl.ops.band import band_to_dense
    from rbl.ops.spmm.operator import as_operator
    from rbl.solver.basis import BasisStore
    from rbl.solver.lanczos import lanczos_iteration, random_start_block

    n, k, b, cap = 500, 6, 4, 48
    d = np.linspace(1.0, 50.0, n)
    # unreachable tol forces the sweep to the Krylov cap → several
    # offload compactions
    cfg = rt.RBLConfig(
        block_size=b, max_kryl_dim=120, tol=1e-300, basis_device_cap_cols=cap
    )
    op = as_operator(d, dtype=cfg.compute_dtype)
    Qi = random_start_block(op, jax.random.PRNGKey(cfg.seed), b, cfg)
    store = BasisStore(
        n, b, max_cols=cfg.max_kryl_dim + b, dtype=cfg.basis_dtype,
        device_cap_cols=cap,
    )
    _, _, T, _, _, _ = lanczos_iteration(op, k, cfg, Qi, store)
    assert store.host_ncols > 0  # offload actually happened
    panels = [np.asarray(p) for p in store.host_tier()]
    dev_tier = np.asarray(store.view())[:, : store.dev_ncols]
    Q = np.concatenate(panels + [dev_tier], axis=1)
    assert Q.shape[1] == store.ncols
    Td = band_to_dense(T.view(store.ncols))
    QtAQ = Q.T @ (d[:, None] * Q)
    assert np.abs(Td - QtAQ).max() < 1e-10 * d.max()


def test_k_beyond_krylov_cap_raises():
    """A Krylov cap below k cannot produce k Rayleigh–Ritz pairs; the
    solver must raise instead of silently returning fewer eigenpairs."""
    import pytest

    import rbl as rt

    d = np.arange(1.0, 101.0)
    with pytest.raises(ValueError):
        rt.rbl(d, 10, cfg=rt.RBLConfig(block_size=4, max_kryl_dim=8))


def test_iterations_matches_kryl_dim_on_early_convergence():
    """Early convergence via a prefix poll rewinds the basis; the reported
    iteration count must match the final basis (iterations·b == kryl_dim ==
    V rows), not the speculated chunk's counter."""
    import rbl as rt

    n, k, b = 400, 4, 4
    d = np.zeros(n)
    d[:8] = [100.0, 90.0, 80.0, 70.0, 2.0, 1.5, 1.2, 1.1]  # fast converger
    res = rt.rbl(d, k, b, cfg=rt.RBLConfig(block_size=b, max_kryl_dim=256))
    assert res.iterations * b == res.kryl_dim


def test_adaptive_reorth_semiorthogonality():
    """With the full-scrub interval stretched to its cap on a calm spectrum
    (unreachable tol → sweep runs to the Krylov cap), the stored basis must
    stay semiorthogonal: ‖QᵀQ − I‖ ≤ O(√eps) is the classic partial-
    reorthogonalization contract that keeps T's Ritz values honest."""
    import jax

    import rbl as rt
    from rbl.ops.spmm.operator import as_operator
    from rbl.solver.basis import BasisStore
    from rbl.solver.lanczos import lanczos_iteration, random_start_block

    n, k, b = 500, 6, 4
    d = np.linspace(1.0, 50.0, n)
    cfg = rt.RBLConfig(
        block_size=b, max_kryl_dim=160, tol=1e-300, adaptive_reorth_max=8
    )
    op = as_operator(d, dtype=cfg.compute_dtype)
    Qi = random_start_block(op, jax.random.PRNGKey(cfg.seed), b, cfg)
    store = BasisStore(
        n, b, max_cols=cfg.max_kryl_dim + b, dtype=cfg.basis_dtype
    )
    lanczos_iteration(op, k, cfg, Qi, store)
    Q = np.asarray(store.view())[:, : store.ncols]
    orth = np.abs(Q.T @ Q - np.eye(store.ncols)).max()
    # f64: √eps ≈ 1.5e-8; the danger/selective machinery plus the calm
    # gate must keep the stretched sweep well inside it
    assert orth < 1e-8, f"semiorthogonality lost: {orth:.3g}"


def test_breakdown_rerandomization_low_rank():
    """Exact invariant-subspace breakdown: a rank-6 operator exhausts its
    Krylov space after two b=3 blocks; the solver must detect the collapsed
    B, re-randomize (reference has no handling — SURVEY §5), and still
    return the top-k eigenpairs without ghosts or NaNs."""
    import rbl as rt

    n = 300
    d = np.zeros(n)
    d[:6] = [60.0, 50.0, 40.0, 30.0, 20.0, 10.0]
    cfg = rt.RBLConfig(block_size=3, max_kryl_dim=60, eig_poll_cadence=4)
    res = rt.rbl(d, 4, 3, cfg=cfg)
    np.testing.assert_allclose(res.eigenvalues, [60, 50, 40, 30], atol=1e-8)
    assert np.all(np.isfinite(np.asarray(res.eigenvectors)))


def test_eig_backend_device_solve():
    """eig_backend='device' routes the Rayleigh–Ritz solve through
    jnp.linalg.eigh of the densified T."""
    import rbl as rt

    n = 400
    d = np.arange(1.0, n + 1.0)
    res = rt.rbl(d, 5, 4, cfg=rt.RBLConfig(block_size=4, eig_backend="device"))
    np.testing.assert_allclose(res.eigenvalues, d[::-1][:5], rtol=1e-11)


def test_basis_store_small_cap_rejected_or_safe():
    """Review regression: a device cap too small for the append window must
    raise (not silently clamp writes over the newest blocks)."""
    import pytest as _pytest

    import jax.numpy as jnp
    from rbl.solver.basis import BasisStore

    store = BasisStore(64, 4, max_cols=64, dtype=jnp.float64,
                       device_cap_cols=16)
    blk = jnp.ones((64, 4))
    with _pytest.raises(ValueError):
        # one _ensure for a 20-column window on a 16-column cap
        store._ensure(20)


def test_basis_store_offload_exact_contents():
    """Every stored block must be recoverable bit-for-bit across tiers."""
    import jax.numpy as jnp
    from rbl.solver.basis import BasisStore

    rng = np.random.default_rng(0)
    n, b, cap = 32, 4, 16
    store = BasisStore(n, b, max_cols=80, dtype=jnp.float64,
                       device_cap_cols=cap)
    blocks = [rng.standard_normal((n, b)) for _ in range(12)]
    for blk in blocks:
        store.append(jnp.asarray(blk))
    got = np.concatenate(
        [np.asarray(p) for p in store.host_tier()]
        + [np.asarray(store.view())[:, : store.dev_ncols]],
        axis=1,
    )
    np.testing.assert_array_equal(got, np.concatenate(blocks, axis=1))


def test_basis_store_rewind_across_tiers():
    """Tier-aware rewind: a rewind target inside (or before) offloaded
    panels must drop/trim panels and leave exactly the prefix readable."""
    import jax.numpy as jnp
    from rbl.solver.basis import BasisStore
    from rbl.solver.lanczos import _zero_cols_range

    rng = np.random.default_rng(1)
    n, b, cap = 24, 4, 16
    store = BasisStore(n, b, max_cols=96, dtype=jnp.float64,
                       device_cap_cols=cap)
    blocks = [rng.standard_normal((n, b)) for _ in range(14)]
    for blk in blocks:
        store.append(jnp.asarray(blk))
    assert store.dev_base > 20  # offload actually happened
    target_cols = 20  # predates the device tier
    store.rewind(target_cols, _zero_cols_range)
    assert store.ncols == target_cols
    got = np.concatenate(
        [np.asarray(p) for p in store.host_tier()]
        + ([np.asarray(store.view())[:, : store.dev_ncols]]
           if store.dev_ncols else []),
        axis=1,
    )
    np.testing.assert_array_equal(
        got, np.concatenate(blocks, axis=1)[:, :target_cols]
    )
    # read_block across tiers
    blk2 = np.asarray(store.read_block(4, 4))
    np.testing.assert_array_equal(blk2, blocks[1])
    # appends continue cleanly
    store.append(jnp.asarray(blocks[0]))
    assert store.ncols == target_cols + b


def test_fresh_directions_deflates_lock_and_host_tier():
    """Breakdown re-randomization must orthogonalize the fresh block
    against the FULL stored state: the host-offloaded panels and the lock
    set, not just the device tier.  A leak frozen in here re-amplifies
    every step (locked |λ| exceed the active window's), producing ghost
    duplicates of already-locked eigenvalues."""
    import jax

    import rbl as rt
    from rbl.solver.basis import BasisStore
    from rbl.solver.lanczos import _fresh_directions

    n, b, cap = 400, 4, 16
    rng = np.random.default_rng(0)
    Qfull, _ = np.linalg.qr(rng.standard_normal((n, 40 + 8 + b)))
    store = BasisStore(n, b, max_cols=64, dtype=jnp.float64,
                       device_cap_cols=cap)
    for j in range(10):  # 40 columns > cap → offload kicks in
        store.append(jnp.asarray(Qfull[:, j * b:(j + 1) * b]))
    assert store.host_ncols > 0
    lock = jnp.asarray(Qfull[:, 40:48])
    Qprev = jnp.asarray(Qfull[:, 48:48 + b])
    Z = _fresh_directions(store, (Qprev,), lock, jax.random.PRNGKey(1),
                          (n, b), jnp.float64, "householder")
    Zn = np.asarray(Z)
    # orthonormal, and orthogonal to every stored span
    assert np.abs(Zn.T @ Zn - np.eye(b)).max() < 1e-12
    assert np.abs(Qfull[:, :48 + b].T @ Zn).max() < 1e-12


def test_breakdown_with_host_offload_active():
    """Breakdown AFTER the basis spilled to the host tier: the replacement
    block must come out orthogonal to the offloaded panels too, or the
    solve returns ghost duplicates."""
    import rbl as rt

    n = 500
    nval = 40
    d = np.zeros(n)
    d[:nval] = np.linspace(100.0, 10.0, nval)  # rank-40 operator
    b, cap = 4, 24
    cfg = rt.RBLConfig(block_size=b, max_kryl_dim=96, eig_poll_cadence=4,
                       basis_device_cap_cols=cap, tol=1e-12)
    res = rt.rbl(d, 6, b, cfg=cfg)
    np.testing.assert_allclose(
        res.eigenvalues, d[:6], atol=1e-7 * d[0]
    )
    V = np.asarray(res.eigenvectors)
    resid = np.linalg.norm(d[:, None] * V - V * res.eigenvalues[None, :],
                           axis=0)
    assert resid.max() < 1e-6 * d[0]


def test_partial_breakdown_midsweep_repair():
    """A rank-11 operator with b=4: the third coupling block keeps 3
    healthy singular directions and loses 1 to the rounding floor while
    ‖B‖ stays O(‖A‖) — the partial-repair path (σ_min scan) must catch it
    and the solve must return exact eigenvalues (RBL_DEBUG shows
    'partial breakdown at i=2: rank 3/4')."""
    import rbl as rt

    n = 300
    d = np.zeros(n)
    d[:11] = np.linspace(100.0, 50.0, 11)
    cfg = rt.RBLConfig(block_size=4, max_kryl_dim=64, eig_poll_cadence=4)
    res = rt.rbl(d, 8, 4, cfg=cfg)
    np.testing.assert_allclose(res.eigenvalues, d[:8], atol=1e-7)


def test_repair_block_rank_zero():
    """rank == 0 (every σ at the floor while the max-entry test passed):
    _repair_block must degenerate to full re-randomization with a zero
    coupling — fresh orthonormal block, orthogonal to the stored state."""
    import jax

    from rbl.solver.basis import BasisStore
    from rbl.solver.lanczos import _repair_block

    n, b = 200, 4
    rng = np.random.default_rng(0)
    Qfull, _ = np.linalg.qr(rng.standard_normal((n, 3 * b)))
    store = BasisStore(n, b, max_cols=8 * b, dtype=jnp.float64)
    store.append(jnp.asarray(Qfull[:, :b]))
    Qprev = jnp.asarray(Qfull[:, b:2 * b])
    Qold = jnp.asarray(Qfull[:, 2 * b:3 * b])
    B_s = np.full((b, b), 1e-18)
    Qnew, B_new = _repair_block(
        store, Qprev, Qold, B_s, 0, None, jax.random.PRNGKey(0),
        "householder",
    )
    assert np.all(B_new == 0.0)
    Z = np.asarray(Qnew)
    assert np.abs(Z.T @ Z - np.eye(b)).max() < 1e-12
    assert np.abs(np.asarray(store.view()).T @ Z).max() < 1e-12
    assert np.abs(np.asarray(Qprev).T @ Z).max() < 1e-12


def test_as_operator_bcoo_bcsr():
    """jax.experimental.sparse BCOO/BCSR inputs route through the same
    format auto-selection as scipy matrices."""
    import numpy as np
    import scipy.sparse as sp
    from jax.experimental import sparse as jsparse

    import rbl as rt

    rng = np.random.default_rng(0)
    A = sp.random(150, 150, density=0.05, random_state=rng)
    A = ((A + A.T) * 0.5).tocsr()
    Ab = jsparse.BCOO.from_scipy_sparse(A.tocoo())
    op = rt.as_operator(Ab, dtype=np.float64)
    X = rng.standard_normal((150, 4))
    np.testing.assert_allclose(np.asarray(op.apply(X)), A @ X, rtol=1e-12)
    Abs = jsparse.BCSR.from_scipy_sparse(A)
    op2 = rt.as_operator(Abs, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(op2.apply(X)), A @ X, rtol=1e-12)
    # end-to-end solve from a BCOO input
    d = np.arange(1.0, 201.0)
    Db = jsparse.BCOO.fromdense(np.diag(d))
    D, _ = rt.RBL(Db, 3, 4)
    np.testing.assert_allclose(D, [200.0, 199.0, 198.0], rtol=1e-11)


def test_function_operator_end_to_end():
    """FunctionOperator: user-supplied jax-traceable matvec drives a full
    solve (the matrix-free migration path for scipy LinearOperator users)."""
    import jax.numpy as jnp
    import numpy as np

    import rbl as rt

    d = jnp.asarray(np.arange(1.0, 501.0))
    op = rt.FunctionOperator(
        fun=lambda X: d[:, None] * X, _n=500, _dtype=jnp.float64
    )
    res = rt.rbl(op, 4, b=4)
    np.testing.assert_allclose(
        res.eigenvalues, [500.0, 499.0, 498.0, 497.0], rtol=1e-11
    )


def test_as_operator_casts_linear_operator_dtype():
    """An explicit dtype request must cast an existing LinearOperator
    (a mismatched mass-matrix dtype poisoned while_loop carries in the
    f32 generalized path)."""
    import jax.numpy as jnp

    from rbl.ops.spmm.operator import as_operator

    d64 = rt.DiagonalOperator(jnp.asarray(np.arange(1.0, 11.0)))
    assert jnp.dtype(d64.dtype) == jnp.float64
    d32 = as_operator(d64, dtype=jnp.float32)
    assert jnp.dtype(d32.dtype) == jnp.float32
    X = jnp.ones((10, 2), jnp.float32)
    assert d32.apply(X).dtype == jnp.float32
    # no request: unchanged instance
    assert as_operator(d64) is d64


def test_poll_schedule_geometric_then_fine_then_forced():
    """Pin the poll/backoff schedule (VERDICT r4 weak #6): a scripted
    sweep trace must reproduce the exact poll panel sequence — geometric
    ~m/4 backoff far from convergence, base-cadence pinning after the
    fine-poll flip, and the forced final poll at the cap."""
    from rbl.solver.lanczos import (
        fine_poll_reset_cols,
        poll_panel_for,
        poll_stride_cols,
    )

    b, cadence, k, i_max = 8, 16, 50, 96
    fine_flip_at_panel = 71  # script: ≥25% of pairs meet the bound here

    polls = []
    next_poll_cols = 0
    fine = False
    for i in range(cadence, i_max + 1, cadence):  # chunk boundaries
        if i * b <= k:
            continue
        polled_panel = None
        while next_poll_cols <= i * b:
            j = poll_panel_for(next_poll_cols, i, b, k)
            polls.append(j)
            polled_panel = j
            next_poll_cols = j * b + poll_stride_cols(j, b, cadence, fine)
            if not fine and j >= fine_flip_at_panel:  # scripted harvest
                fine = True
                next_poll_cols = fine_poll_reset_cols(
                    next_poll_cols, j, b, cadence
                )
        if i == i_max and (polled_panel is None or polled_panel < i):
            polls.append(i)  # forced final poll at the cap

    # geometric phase: first poll at the earliest k-capable panel, then
    # strides of max(cadence·b, j·b/4) columns
    assert polls[:5] == [7, 23, 39, 55, 71]
    # fine-poll phase: pinned to the BASE cadence (16 panels), not the
    # geometric stride (which would be 71·8/4 = 142 cols ≈ 18 panels)
    assert polls[5] == 71 + cadence
    # forced final poll at the cap panel exactly once
    assert polls[-1] == i_max and polls.count(i_max) == 1
    # strictly increasing — no duplicate or regressing polls
    assert all(x < y for x, y in zip(polls, polls[1:]))


def test_poll_schedule_fine_reset_pulls_back():
    from rbl.solver.lanczos import fine_poll_reset_cols

    # geometric stride had scheduled 890 cols; the flip at panel 89 pulls
    # the next poll back to 89·8 + 16·8 = 840
    assert fine_poll_reset_cols(890, 89, 8, 16) == 840
    # never pushes a closer poll further out
    assert fine_poll_reset_cols(700, 89, 8, 16) == 700
