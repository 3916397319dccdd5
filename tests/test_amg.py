"""Assembled-matrix preconditioner tier (ops/amg.py).  The iteration
counts asserted here are hardware-independent and are what the fem3d
vibration wall-clock follows from (scalar Jacobi leaves it far behind a
factorized shift-invert)."""

import numpy as np
import pytest

import jax.numpy as jnp

import rbl as rt
from rbl.ops.amg import (
    AssembledMultigrid,
    block_jacobi_psolve,
    detect_dof_blocks,
    rigid_body_modes,
)
from rbl.ops.minres import block_minres, jacobi_psolve
from rbl.ops.spmm.operator import as_operator
from rbl.utils.fem import fem_elasticity_3d


def _fem_coords(nx):
    nnx = nx + 1
    g = np.arange(nnx, dtype=np.float64)
    k, j, i = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)
    return coords[nnx * nnx:]  # clamped z=0 face removed


def test_detect_dof_blocks():
    A = fem_elasticity_3d(4)
    assert detect_dof_blocks(A) == 3
    import scipy.sparse as sp

    L = sp.diags([-np.ones(99), 2 * np.ones(100), -np.ones(99)],
                 [-1, 0, 1]).tocsr()
    assert detect_dof_blocks(L) == 1


def test_amg_cycle_is_spd():
    A = fem_elasticity_3d(6)
    for amg in (
        AssembledMultigrid.smoothed_aggregation(A, dof=3),
        AssembledMultigrid.from_grid(A, (6, 7, 7), dof=3),
    ):
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal((A.shape[0], 1)))
        v = jnp.asarray(rng.standard_normal((A.shape[0], 1)))
        s1 = float(u[:, 0] @ amg.psolve(v)[:, 0])
        s2 = float(v[:, 0] @ amg.psolve(u)[:, 0])
        assert abs(s1 - s2) <= 1e-12 * abs(s1)
        assert float(u[:, 0] @ amg.psolve(u)[:, 0]) > 0


def test_amg_cuts_minres_iterations():
    """fem3d-8 elasticity at sigma=0: scalar Jacobi needs ~131, block
    Jacobi ~121, SA-AMG ~36 (translations) / ~20 (rigid modes), grid
    AMG ~25.  Gates assert the ordering with margin."""
    A = fem_elasticity_3d(8)
    op = as_operator(A, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    B = jnp.asarray(rng.standard_normal((A.shape[0], 4)))

    def iters(ps):
        _, (it, _) = block_minres(
            op.apply, B, shift=jnp.asarray(0.0), tol=1e-10, psolve=ps,
            maxiter=4000,
        )
        return int(it)

    it_jac = iters(jacobi_psolve(op.diagonal()))
    it_bj = iters(block_jacobi_psolve(A))
    sa = AssembledMultigrid.smoothed_aggregation(
        A, dof=3, near_nullspace=rigid_body_modes(_fem_coords(8))
    )
    it_sa = iters(sa.psolve)
    gg = AssembledMultigrid.from_grid(A, (8, 9, 9), dof=3)
    it_gg = iters(gg.psolve)
    assert it_bj <= it_jac
    assert it_sa * 4 <= it_jac, (it_sa, it_jac)
    assert it_gg * 3 <= it_jac, (it_gg, it_jac)
    assert it_sa < 40 and it_gg < 50


def test_grid_transfers_match_scipy_kron():
    """The device per-axis einsum transfers must equal the assembled
    kron(P0,P1,P2)⊗I3 used for RAP (same operators, two codepaths)."""
    import scipy.sparse as sp

    from rbl.ops.amg import _GridTransfer, _grid_prolong_1d

    dims = (4, 5, 3)
    dof = 3
    P1s = [_grid_prolong_1d(m) for m in dims]
    cdims = tuple(P.shape[1] for P in P1s)
    tr = _GridTransfer(dims, cdims, P1s, dof)
    Pn = sp.kron(sp.kron(sp.csr_matrix(P1s[0]), sp.csr_matrix(P1s[1])),
                 sp.csr_matrix(P1s[2]))
    P = sp.kron(Pn, sp.identity(dof, format="csr")).tocsr()
    rng = np.random.default_rng(1)
    C = rng.standard_normal((P.shape[1], 2))
    F = rng.standard_normal((P.shape[0], 2))
    np.testing.assert_allclose(
        np.asarray(tr.prolong(jnp.asarray(C))), P @ C, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(tr.restrict(jnp.asarray(F))), P.T @ F, atol=1e-13
    )


def test_vibration_solve_with_amg_matches_scipy():
    """End-to-end eigsh(A, M, sigma=0) on a small elasticity pencil with
    the grid-AMG inner preconditioner vs scipy's factorized solve."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    N = 6
    A = fem_elasticity_3d(N)
    m = np.asarray(A.sum(axis=1)).ravel()
    m = np.abs(m) + 1e-3 * np.abs(m).mean()
    amg = AssembledMultigrid.from_grid(A, (N, N + 1, N + 1), dof=3)
    w, V = rt.eigsh(
        A, k=4, M=rt.DiagonalOperator(jnp.asarray(m, jnp.float64)),
        sigma=0.0, which="LM", tol=1e-8, inner_psolve=amg.psolve,
    )
    w_ref = sla.eigsh(A, k=4, M=sp.diags(m), sigma=0.0, which="LM",
                      return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(w), np.sort(w_ref), rtol=1e-7)
    R = A @ V - (m[:, None] * V) * w[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6


def test_agg_transfer_matches_scipy_smoothed_p():
    """The permuted-aggregate device transfers must equal the scipy
    smoothed prolongator used for RAP (same operator, two codepaths)."""
    import scipy.sparse as sp

    from rbl.ops.amg import (
        _aggregate,
        _lambda_max_dinv_a,
        _node_strength_graph,
        _tentative_prolongator,
        _AggTransfer,
        _AMGLevel,
    )

    A = fem_elasticity_3d(5)
    S = _node_strength_graph(A, 3)
    agg = _aggregate(S, 0.05)
    B = np.zeros((A.shape[0], 3))
    for c in range(3):
        B[c::3, c] = 1.0
    Pt, Bc, meta = _tentative_prolongator(agg, B, 3)
    lam = _lambda_max_dinv_a(A)
    w = 4.0 / (3.0 * lam)
    d = A.diagonal().copy()
    d[d == 0] = 1.0
    P = (Pt - w * (sp.diags(1.0 / d) @ (A @ Pt))).tocsr()
    lv = _AMGLevel(A, 3, 0.6, jnp.float64)
    tr = _AggTransfer(meta, lv.op, 1.0 / d, w, Pt.shape[1], jnp.float64)
    rng = np.random.default_rng(2)
    C = rng.standard_normal((P.shape[1], 3))
    F = rng.standard_normal((P.shape[0], 3))
    np.testing.assert_allclose(
        np.asarray(tr.prolong(jnp.asarray(C))), P @ C, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(tr.restrict(jnp.asarray(F))), P.T @ F, atol=1e-11
    )
