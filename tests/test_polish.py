"""Warm-started f32→f64 polish pipeline (solver/polish.py).

The reference's mixed-precision story is a FLOAT reorth tier inside one
DOUBLE sweep (common.jl:5-6, README.md:69); here the split is f32 for the
whole subspace discovery and f64 only for a short filtered polish.  No reference
test coverage exists for any of this (SURVEY §4)."""

import numpy as np

import jax.numpy as jnp

import rbl as rt
from rbl.config import RBLConfig
from rbl.solver.polish import rbl_polished


def _lap2d_exact(nx, k):
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:k]


def test_polished_clustered_laplacian_at_ref_tol():
    """The target workload: clustered Laplacian top-k at the reference's
    absolute 1e-7 residual bound (RBL.jl:109) — unreachable by one sweep
    (cap-hits), reachable by the warm-started polish."""
    nx, k, b = 48, 10, 4
    op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float64)
    cfg = RBLConfig(block_size=b, tol=1e-7, seed=0)
    res = rbl_polished(op, k, cfg=cfg, b=b)
    assert res.converged
    w = np.sort(np.asarray(res.eigenvalues))[::-1]
    np.testing.assert_allclose(w, _lap2d_exact(nx, k), rtol=1e-8)
    # locked vectors are true eigenvectors at the polish tolerance
    V = np.asarray(res.eigenvectors)
    AV = np.asarray(op.apply(jnp.asarray(V)))
    r = AV - V * np.asarray(res.eigenvalues)[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-6


def test_polished_dense_cluster_at_ref_tol_k50():
    """The round-3 failure mode, CPU-reproducible (VERDICT r3 item 1): a
    top cluster with ~2e-5 RELATIVE gaps (the 256² Laplacian's geometry,
    incl. exact degeneracies) defeats short restarted Krylov sweeps — the
    recorded restarted run locked 0/50 in 22 restarts.  The Chebyshev subspace
    polish must lock all 50 at the reference's absolute 1e-7 bound."""
    n, k, b = 5000, 50, 8
    d = np.zeros(n)
    d[:100] = 8.0 * (1.0 - 1.9e-5 * np.arange(100))  # clustered top
    d[10] = d[11]  # exact degeneracy, like the Laplacian's (i,j)/(j,i)
    d[100:] = np.linspace(7.8, 1e-3, n - 100)        # dense sea below
    op = rt.DiagonalOperator(jnp.asarray(d))
    cfg = RBLConfig(block_size=b, tol=1e-7, seed=0)
    res = rbl_polished(op, k, cfg=cfg, b=b)
    assert res.converged, f"locked residuals: {np.sort(res.residual_bounds)[-3:]}"
    assert res.residual_bounds.max() < 1e-7
    w = np.sort(np.asarray(res.eigenvalues))[::-1]
    np.testing.assert_allclose(w, np.sort(d)[::-1][:k], rtol=1e-10)
    # true residuals of the returned vectors confirm the bound
    V = np.asarray(res.eigenvectors)
    AV = np.asarray(op.apply(jnp.asarray(V)))
    r = AV - V * np.asarray(res.eigenvalues)[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-7


def test_polished_psd_bounds_hint_and_degree_cap():
    """bounds=(0, None) (certified PSD) narrows the damped interval —
    the polish must stay correct with the hint and a small degree cap
    (more passes, same answer)."""
    nx, k, b = 32, 8, 4
    op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float64)
    cfg = RBLConfig(block_size=b, tol=1e-7, seed=0)
    res = rbl_polished(op, k, cfg=cfg, b=b, bounds=(0.0, None))
    assert res.converged
    np.testing.assert_allclose(
        np.sort(np.asarray(res.eigenvalues))[::-1], _lap2d_exact(nx, k),
        rtol=1e-10,
    )


def test_chebyshev_refine_mixed_sign_lm():
    """LM on a mixed-sign spectrum: wanted pairs at BOTH ends, symmetric
    damped interval [−θ̃, θ̃] (no λ_min certification possible)."""
    from rbl.solver.polish import chebyshev_refine

    n, k = 800, 6
    rng = np.random.default_rng(3)
    d = np.zeros(n)
    d[:4] = [10.0, -9.5, 9.0, -8.7]
    d[4:] = np.linspace(6.0, -6.0, n - 4)
    op = rt.DiagonalOperator(jnp.asarray(d))
    idx = np.argsort(-np.abs(d))[: k + 6]
    warm = np.zeros((n, k + 6))
    warm[idx, np.arange(k + 6)] = 1.0
    warm += 1e-5 * rng.standard_normal(warm.shape)
    res = chebyshev_refine(op, warm, k, cfg=RBLConfig(tol=1e-8, seed=0))
    assert res.converged
    w = np.asarray(res.eigenvalues)
    np.testing.assert_allclose(
        np.sort(np.abs(w))[::-1], np.sort(np.abs(d))[::-1][:k], rtol=1e-10
    )


def test_chebyshev_refine_sa_mode():
    """SA: smallest-algebraic polish (solved as LA of −A)."""
    from rbl.solver.polish import chebyshev_refine

    n, k = 600, 5
    rng = np.random.default_rng(5)
    d = np.linspace(1.0, 100.0, n)
    op = rt.DiagonalOperator(jnp.asarray(d))
    warm = np.zeros((n, k + 4))
    warm[np.arange(k + 4), np.arange(k + 4)] = 1.0
    warm += 1e-5 * rng.standard_normal(warm.shape)
    res = chebyshev_refine(
        op, warm, k, cfg=RBLConfig(tol=1e-8, seed=0), which="SA"
    )
    assert res.converged
    np.testing.assert_allclose(
        np.sort(np.asarray(res.eigenvalues)), d[:k], rtol=1e-10
    )


def test_warm_seeding_converges_with_short_sweeps():
    """warm_V columns aligned with the unlocked pairs let the restarted
    solver lock k pairs with sweeps far shorter than the cold solve needs;
    eigenvalues reach the f64 class."""
    n, k, b = 400, 6, 3
    rng = np.random.default_rng(0)
    d = np.cumsum(np.arange(1.0, n + 1.0))  # moderate decay (test.jl:17)
    op = rt.DiagonalOperator(jnp.asarray(d))
    idx = np.argsort(-np.abs(d))[:k]
    warm = np.zeros((n, k))
    warm[idx, np.arange(k)] = 1.0
    warm += 1e-4 * rng.standard_normal((n, k))
    res = rt.rbl_restarted(
        op, k, b=b,
        cfg=RBLConfig(tol=1e-5, restart_kryl_dim=24, seed=0),
        warm_V=warm, max_restarts=12,
    )
    assert res.converged
    w = np.sort(np.asarray(res.eigenvalues))[::-1]
    np.testing.assert_allclose(w, np.sort(d)[::-1][:k], rtol=1e-9)
    # a cold solve at this sweep length needs many more restarts; warm
    # locks within the small budget (the exact count moved 10 -> 11 when
    # restart_growth_policy="stall" pinned sweep lengths — one extra cheap
    # cached-shape restart instead of seven recompiling growths)
    assert res.iterations <= 12


def test_polished_cold_fallback_on_nonfinite_warm(monkeypatch):
    """Non-finite garbage in the coarse stage must not poison the polish: non-finite warm_V
    is dropped and the restarted solve runs cold."""
    import rbl.solver.polish as pol

    n, k = 300, 4
    a = np.cumsum(np.arange(1.0, n + 1.0))
    op = rt.DiagonalOperator(jnp.asarray(a))

    real_rbl = pol.rbl

    def bad_rbl(*args, **kw):
        res = real_rbl(*args, **kw)
        res.eigenvectors = jnp.full_like(res.eigenvectors, jnp.nan)
        return res

    monkeypatch.setattr(pol, "rbl", bad_rbl)
    res = rbl_polished(op, k, cfg=RBLConfig(tol=1e-8, seed=0), b=2)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, a[::-1][:k], rtol=1e-9)


def test_polished_sharded_mesh(eight_devices):
    """Both polish stages must run under a row mesh: the f32 coarse sweep,
    the warm-block placement, and the f64 restarted polish all inherit
    cfg.mesh (SURVEY §2c sharded-basis strategy)."""
    import jax.numpy as jnp

    from rbl.parallel.dist_spmm import ShardedLaplacian2D
    from rbl.parallel.mesh import make_row_mesh

    mesh = make_row_mesh(8)
    nx, k, b = 24, 4, 2
    op = ShardedLaplacian2D(nx=nx, ny=nx, mesh=mesh, _dtype=jnp.float64)
    cfg = RBLConfig(block_size=b, tol=1e-7, mesh=mesh, seed=0)
    res = rbl_polished(op, k, cfg=cfg, b=b)
    assert res.converged
    w = np.sort(np.asarray(res.eigenvalues))[::-1]
    np.testing.assert_allclose(w, _lap2d_exact(nx, k), rtol=1e-8)


def test_warm_block_pads_missing_columns():
    from rbl.config import RBLConfig as C
    from rbl.solver.restarted import _warm_block

    n, b = 50, 3
    warm = np.zeros((n, 4))
    warm[7, 3] = 1.0  # only column index 3 exists past start=3
    blk = np.asarray(_warm_block(warm, 3, b, n, C(), None))
    assert blk.shape == (n, b)
    np.testing.assert_allclose(blk[:, 0], warm[:, 3])
    # padded columns are fresh randomness, not zeros (a zero start column
    # would make the sweep's first QR rank-deficient by construction)
    assert np.linalg.norm(blk[:, 1]) > 0 and np.linalg.norm(blk[:, 2]) > 0


def test_chebyshev_refine_pass_checkpoint_and_resume(tmp_path):
    """checkpoint_path on the WARM polish path (ADVICE r4): each filter
    pass writes an atomic (X, theta, res, npass) checkpoint; resuming
    from the saved block converges in fewer passes."""
    from rbl.solver.polish import chebyshev_refine
    from rbl.utils.checkpoint import load_polish_state

    n, k = 600, 6
    d = np.linspace(0.01, 9.0, n)
    d[-20:] = 9.5 * (1.0 - 1e-4 * np.arange(20))[::-1]
    op = rt.DiagonalOperator(jnp.asarray(d))
    rng = np.random.default_rng(0)
    exact_V = np.zeros((n, k))
    for j, idx in enumerate(np.argsort(d)[::-1][:k]):
        exact_V[idx, j] = 1.0
    warm = exact_V + 1e-3 * rng.standard_normal((n, k))
    ck = str(tmp_path / "polish.npz")
    cfg = RBLConfig(block_size=4, tol=1e-9, seed=0)
    res = chebyshev_refine(op, warm, k, cfg=cfg, checkpoint_path=ck)
    assert res.converged and res.iterations >= 1
    st = load_polish_state(ck)
    assert st["X"].shape[0] == n and st["npass"] >= 1
    assert np.all(np.isfinite(st["X"]))
    # resume: the checkpointed block is a valid warm start
    res2 = chebyshev_refine(op, st["X"], k, cfg=cfg, extra_random=0)
    assert res2.converged and res2.iterations <= res.iterations
    np.testing.assert_allclose(
        np.sort(res2.eigenvalues), np.sort(res.eigenvalues), rtol=1e-12
    )


def test_filter_qr_interleaved_frozen_passthrough():
    """ADVICE r4: frozen columns must emerge (near) bit-stable from the
    fixed-shape QR even when the lock pattern is INTERLEAVED — the
    stable partition puts them ahead of every filtered column."""
    from rbl.solver.polish import _filter_qr

    n, m = 300, 6
    d = np.linspace(0.1, 5.0, n)
    op = rt.DiagonalOperator(jnp.asarray(d))
    rng = np.random.default_rng(1)
    X, _ = np.linalg.qr(rng.standard_normal((n, m)))
    frozen = np.array([True, False, True, False, False, True])
    Q = np.asarray(_filter_qr(
        op, jnp.asarray(X), jnp.asarray(frozen),
        jnp.asarray(0.0, jnp.float64), jnp.asarray(2.5, jnp.float64),
        16, "cholqr2",  # the f64 polish QR (positive-diagonal R:
    ))                  # passthrough preserves sign, unlike Householder)
    # frozen columns: exact passthrough up to rounding (same sign)
    for j in np.nonzero(frozen)[0]:
        np.testing.assert_allclose(Q[:, j], X[:, j], atol=5e-14)
    # unfrozen columns: still orthonormal against the whole block
    G = Q.T @ Q
    np.testing.assert_allclose(G, np.eye(m), atol=1e-12)
