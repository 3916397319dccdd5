"""Geometric multigrid preconditioner (ops/multigrid.py) + the FDM exact
shifted solve (ops/fdm.py) — NEXT.md item 1.  The contraction factors and
inner-iteration counts asserted here are hardware-independent; they are
the quantity the GPU shift-invert wall-clock follows from."""

import numpy as np
import pytest

import jax.numpy as jnp

import rbl as rt
from rbl.ops.fdm import fdm_solver_for
from rbl.ops.minres import ShiftInvertOperator, block_minres
from rbl.ops.multigrid import (
    MultigridCycle2D,
    SeparableMultigrid,
    mg_psolve_for,
)


def test_vcycle_is_spd_and_contracts():
    op = rt.Laplacian2D(nx=64, ny=64, _dtype=jnp.float64)
    ps = mg_psolve_for(op)
    assert ps is not None
    rng = np.random.default_rng(0)
    n = 64 * 64
    b = jnp.asarray(rng.standard_normal((n, 2)))
    # stationary iteration contracts (vertex-centered exact Galerkin:
    # asymptotic rho ~ 0.34 for V(1,1); 6 cycles cut the residual > 100x)
    x = jnp.zeros_like(b)
    r0 = np.linalg.norm(np.asarray(b))
    for _ in range(6):
        x = x + ps(b - op.apply(x))
    assert np.linalg.norm(np.asarray(b - op.apply(x))) / r0 < 5e-3
    # symmetry + positive definiteness (PMINRES requirements)
    u = jnp.asarray(rng.standard_normal((n, 1)))
    v = jnp.asarray(rng.standard_normal((n, 1)))
    s1 = float(u[:, 0] @ ps(v)[:, 0])
    s2 = float(v[:, 0] @ ps(u)[:, 0])
    assert abs(s1 - s2) <= 1e-12 * abs(s1)
    assert float(u[:, 0] @ ps(u)[:, 0]) > 0


def test_mesh_independent_contraction():
    """Exact separable Galerkin restores textbook MG: the per-cycle
    contraction must not degrade with depth (the round-2 PWC cycle sat
    at ~0.7; the cell-centered bilinear attempt DIVERGED at 3 levels)."""
    rng = np.random.default_rng(1)
    for nx in (64, 128, 256):
        op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float64)
        ps = mg_psolve_for(op)
        b = jnp.asarray(rng.standard_normal((nx * nx, 1)))
        x = jnp.zeros_like(b)
        prev = np.linalg.norm(np.asarray(b))
        rho = None
        for _ in range(6):
            x = x + ps(b - op.apply(x))
            rn = np.linalg.norm(np.asarray(b - op.apply(x)))
            rho = rn / prev
            prev = rn
        assert rho < 0.45, f"nx={nx}: asymptotic rho {rho:.3f}"


def test_mg_cuts_minres_iterations_10x():
    """Round 2 measured 434 -> 38 (PWC, nu=2); the vertex-centered
    cycle reaches ~15.  Gate asserts >= 10x and an absolute ceiling."""
    op = rt.Laplacian2D(nx=128, ny=128, _dtype=jnp.float64)
    rng = np.random.default_rng(1)
    B = jnp.asarray(rng.standard_normal((128 * 128, 4)))
    _, (it_none, _) = block_minres(
        op.apply, B, shift=jnp.asarray(0.0), tol=1e-10
    )
    _, (it_mg, _) = block_minres(
        op.apply, B, shift=jnp.asarray(0.0), tol=1e-10,
        psolve=mg_psolve_for(op),
    )
    assert int(it_mg) * 10 <= int(it_none)
    assert int(it_mg) < 30


def test_mg_3d_contracts_and_helps_minres():
    op = rt.Laplacian3D(nx=16, ny=16, nz=16, _dtype=jnp.float64)
    ps = mg_psolve_for(op)
    assert ps is not None
    rng = np.random.default_rng(2)
    B = jnp.asarray(rng.standard_normal((16 ** 3, 2)))
    _, (it_none, _) = block_minres(
        op.apply, B, shift=jnp.asarray(0.0), tol=1e-10
    )
    _, (it_mg, _) = block_minres(
        op.apply, B, shift=jnp.asarray(0.0), tol=1e-10, psolve=ps
    )
    assert int(it_mg) * 3 <= int(it_none)
    assert int(it_mg) < 40


def test_fdm_exact_shifted_solve():
    """(A − σI)⁻¹ by fast diagonalization is exact to rounding, for σ
    below, inside, and above the spectrum."""
    for op, n in (
        (rt.Laplacian2D(nx=48, ny=32, _dtype=jnp.float64), 48 * 32),
        (rt.Laplacian3D(nx=12, ny=10, nz=8, _dtype=jnp.float64),
         12 * 10 * 8),
    ):
        solve = fdm_solver_for(op)
        assert solve is not None
        rng = np.random.default_rng(3)
        B = jnp.asarray(rng.standard_normal((n, 3)))
        for sigma in (0.0, 3.7, 11.9):
            X = solve(B, jnp.asarray(sigma))
            R = np.asarray(op.apply(X) - sigma * X - B)
            assert np.linalg.norm(R) < 1e-10 * np.linalg.norm(
                np.asarray(B)
            ), f"{type(op).__name__} sigma={sigma}"


def test_eigsh_sm_with_auto_matches_analytic():
    op = rt.Laplacian2D(nx=64, ny=64, _dtype=jnp.float64)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, 65) / 65)
    exact = np.sort(np.add.outer(ev1, ev1).ravel())[:4]
    w, V = rt.eigsh(op, k=4, which="SM", tol=1e-8)
    assert np.abs((np.sort(w) - exact) / exact).max() < 1e-8
    R = np.asarray(op.apply(jnp.asarray(V))) - V * w[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6


def test_eigsh_sm_with_mg_matches_analytic():
    """The V-cycle tier stays correct end-to-end (opt-in via
    precond='mg' now that 'auto' resolves to the exact FDM solve)."""
    from rbl.ops.minres import default_inner_tol

    op = rt.Laplacian2D(nx=32, ny=32, _dtype=jnp.float64)
    si = ShiftInvertOperator.shift(
        op, 0.0, precond="mg",
        inner_tol=default_inner_tol(op.dtype, 1e-8),
    )
    res = rt.rbl(si, 4, 4, which="LM", compute_eigenvectors=True)
    w = 1.0 / np.asarray(res.eigenvalues)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, 33) / 33)
    exact = np.sort(np.add.outer(ev1, ev1).ravel())[:4]
    assert np.abs((np.sort(w) - exact) / exact).max() < 1e-7


def test_mg_unsupported_falls_back_and_strict_raises():
    d = rt.DiagonalOperator(jnp.linspace(1.0, 100.0, 500))
    # auto: falls back to jacobi silently
    si = ShiftInvertOperator.shift(d, 0.0, precond="auto")
    assert si.precond == "jacobi"
    Y = si.apply(jnp.ones((500, 2)))
    assert np.all(np.isfinite(np.asarray(Y)))
    # strict mg / fdm: clear errors
    with pytest.raises(ValueError, match="precond='mg'"):
        ShiftInvertOperator.shift(d, 0.0, precond="mg").apply(
            jnp.ones((500, 2))
        )
    with pytest.raises(ValueError, match="precond='fdm'"):
        ShiftInvertOperator.shift(d, 0.0, precond="fdm").apply(
            jnp.ones((500, 2))
        )


def test_galerkin_factors_stay_spd():
    """Every level operator must stay SPD (the cycle's SPD-ness rests
    on it).  With the separable representation, check the assembled
    Kronecker sum of the coarsest level and each level's diagonal."""
    S = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]])
    cyc = MultigridCycle2D(128, 128, S)
    assert isinstance(cyc, SeparableMultigrid)
    for lv in cyc.levels:
        assert np.all(cyc.omega / lv.winv > 0)  # positive diagonals
    nc = int(np.prod(cyc.coarse_dims))
    A = np.zeros((nc, nc))
    for fac in cyc.coarse_terms:
        K = fac[0]
        for T in fac[1:]:
            K = np.kron(K, T)
        A = A + K
    w = np.linalg.eigvalsh((A + A.T) / 2)
    assert w.min() > 0
    np.testing.assert_allclose(A, A.T, atol=1e-13)


def test_hierarchy_bound_rejects_early_odd_grids():
    """ADVICE r2 (medium): a grid that goes odd after one halving
    (1026 -> 513) must NOT get a dense 513x513-cells coarsest inverse —
    mg_psolve_for returns None (Jacobi fallback) and the class raises."""
    op = rt.Laplacian2D(nx=1026, ny=1026, _dtype=jnp.float64)
    assert mg_psolve_for(op) is None
    S = np.array([[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]])
    with pytest.raises(ValueError, match="bottoms out"):
        MultigridCycle2D(1026, 1026, S)
    # 130 -> 65: also rejected (65*65 = 4225 cells > cap)
    assert mg_psolve_for(
        rt.Laplacian2D(nx=130, ny=130, _dtype=jnp.float64)
    ) is None


def test_auto_resolves_fdm_for_kronecker_sums():
    """auto order: exact FDM for Kronecker sums (any shift), MG for
    structured non-FDM operators at small |sigma|, Jacobi otherwise."""
    op = rt.Laplacian2D(nx=64, ny=64, _dtype=jnp.float64)
    assert ShiftInvertOperator.shift(op, 0.0).precond == "fdm"
    assert ShiftInvertOperator.shift(op, 4.05).precond == "fdm"
    op3 = rt.Laplacian3D(nx=16, ny=16, nz=16, _dtype=jnp.float64)
    assert ShiftInvertOperator.shift(op3, 1.0).precond == "fdm"
    d = rt.DiagonalOperator(jnp.linspace(1.0, 100.0, 500))
    assert ShiftInvertOperator.shift(d, 0.0).precond == "jacobi"


def test_fdm_sigma_at_eigenvalue_raises():
    """sigma exactly at an eigenvalue (sigma=3 IS one on the 64² grid:
    cos(pi/5) - cos(2pi/5) = 1/2) must raise at construction, not NaN."""
    op = rt.Laplacian2D(nx=64, ny=64, _dtype=jnp.float64)
    with pytest.raises(ValueError, match="coincides with an eigenvalue"):
        ShiftInvertOperator.shift(op, 3.0)
    # a perturbed shift works
    si = ShiftInvertOperator.shift(op, 3.0 + 1e-6)
    Y = si.apply(jnp.ones((64 * 64, 2)))
    assert bool(jnp.isfinite(Y).all())
