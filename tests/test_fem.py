"""3D elasticity FEM assembly (rbl/utils/fem.py) — the in-repo
stand-in for the reference's SuiteSparse structural matrices
(reference Julia/benchmark.jl:21-28; no network egress here)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from rbl.utils.fem import fem_elasticity_3d, hex8_stiffness


def test_element_stiffness_rigid_body_null_space():
    Ke = hex8_stiffness(h=2.0, E=3.0, nu=0.25)
    assert np.allclose(Ke, Ke.T, atol=1e-13)
    corners = np.array(
        [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], float
    )
    modes = []
    for d in range(3):
        m = np.zeros((8, 3))
        m[:, d] = 1
        modes.append(m.ravel())
    for a, b in ((1, 2), (2, 0), (0, 1)):
        m = np.zeros((8, 3))
        m[:, a] = -corners[:, b]
        m[:, b] = corners[:, a]
        modes.append(m.ravel())
    R = np.stack(modes, 1)
    assert np.abs(Ke @ R).max() < 1e-12
    w = np.linalg.eigvalsh(Ke)
    assert (np.abs(w) < 1e-12).sum() == 6  # exactly the 6 rigid modes
    assert w[0] > -1e-12  # PSD


def test_assembly_free_free_null_space_and_clamped_spd():
    A = fem_elasticity_3d(3, clamp=False)
    assert abs(A - A.T).max() < 1e-12
    w = np.linalg.eigvalsh(A.toarray())
    assert (np.abs(w) < 1e-9).sum() == 6
    Ac = fem_elasticity_3d(3, clamp=True)
    wc = np.linalg.eigvalsh(Ac.toarray())
    assert wc[0] > 0  # SPD once one face is fixed
    # clamping removes 3 dof per z=0 face node
    assert A.shape[0] - Ac.shape[0] == 3 * 4 * 4


def test_block_structure_is_bsr_friendly():
    # 3x3 dof blocks per node pair: nnz must be divisible into full blocks
    A = fem_elasticity_3d(4, clamp=False)
    B = A.tobsr(blocksize=(3, 3))
    # interior node couples to its full 27-node neighborhood
    nnz_per_noderow = np.diff(B.indptr)
    assert nnz_per_noderow.max() == 27


def test_rbl_matches_arpack_on_fem_matrix():
    A = fem_elasticity_3d(6)  # n = 1008, genuinely 3D elasticity spectrum
    import rbl as rt

    res = rt.rbl(rt.as_operator(A), 8, 4)
    d = spla.eigsh(A, k=8, which="LM", return_eigenvectors=False)[::-1]
    assert np.abs((res.eigenvalues - d) / d).max() < 1e-7


def test_random_permutation_preserves_solution():
    """Worst-case irregular ordering (examples/benchmark.py --permute):
    eigenvalues are permutation-invariant and every routed format must
    agree with the native-ordering solve."""
    import rbl as rt

    A = fem_elasticity_3d(5)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    import scipy.sparse as sp

    P = sp.csr_matrix((np.ones(n), (np.arange(n), perm)), shape=(n, n))
    Ap = (P @ A @ P.T).tocsr()
    r1 = rt.rbl(rt.as_operator(A), 5, 4)
    r2 = rt.rbl(rt.as_operator(Ap), 5, 4)
    np.testing.assert_allclose(r1.eigenvalues, r2.eigenvalues, rtol=1e-8)
