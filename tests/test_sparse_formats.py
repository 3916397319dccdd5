"""Sparse-format operator tests: DIA, ELL, COO/HYB, the BSR kernel (in
interpret mode on the CPU test backend) and its plain XLA twin, and the
auto format selection.  The reference's only sparse layout is CSC
dispatched to cuSPARSE (RBL_gpu.jl:209); here each layout is
property-tested against the scipy ground truth."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import rbl as rt
from rbl.ops.spmm.dia import DiaOperator, count_diagonals
from rbl.ops.spmm.ell import SparseEllOperator
from rbl.ops.spmm import pallas_bsr as pb
from rbl.ops.spmm.pallas_bsr import BlockSparseOperator


def _banded(n, offs, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.standard_normal(n) for _ in offs], offs, shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


def _random_sym(n, density, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng)
    return ((A + A.T) * 0.5).tocsr()


@pytest.mark.parametrize("offs", [[0], [0, 1, -1], [0, 3, -3, 40, -40]])
def test_dia_matches_scipy(offs):
    n = 200
    A = _banded(n, offs)
    op = DiaOperator.from_scipy(A)
    X = np.random.default_rng(1).standard_normal((n, 5))
    Y = np.asarray(op.apply(jnp.asarray(X)))
    np.testing.assert_allclose(Y, A @ X, atol=1e-12)


def test_dia_rejects_dense_diag_structure():
    A = _random_sym(300, 0.5, seed=2)
    with pytest.raises(ValueError):
        DiaOperator.from_scipy(A, max_diags=16)


def test_count_diagonals():
    A = _banded(100, [0, 2, -2])
    assert count_diagonals(A) == 3


@pytest.mark.parametrize("n", [100, 300, 517])
def test_bsr_pallas_matches_scipy_interpret(n):
    A = _random_sym(n, 0.02, seed=3)
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32)
    X = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
    Y = np.asarray(op.apply(jnp.asarray(X)))
    ref = (A @ X.astype(np.float64)).astype(np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(Y - ref).max() / scale < 1e-5


def test_bsr_format_roundtrip():
    """The CSR-of-tiles arrays must reconstruct A exactly, with each block
    row's tiles in [rptr[i], rptr[i+1])."""
    A = _random_sym(300, 0.05, seed=5)
    rptr, cols, vals, nb, ncb = pb.bsr_from_scipy(A, 32, 64, np.float64)
    assert rptr[0] == 0 and rptr[-1] == len(cols) == len(vals)
    D = np.zeros((nb * 32, ncb * 64))
    for i in range(nb):
        for t in range(rptr[i], rptr[i + 1]):
            D[i * 32:(i + 1) * 32, cols[t] * 64:(cols[t] + 1) * 64] += vals[t]
    np.testing.assert_allclose(D[:300, :300], A.toarray(), atol=1e-14)


def test_ell_matches_scipy():
    n = 250
    A = _random_sym(n, 0.03, seed=6)
    op = SparseEllOperator.from_scipy(A)
    X = np.random.default_rng(7).standard_normal((n, 4))
    Y = np.asarray(op.apply(jnp.asarray(X)))
    np.testing.assert_allclose(Y, A @ X, atol=1e-12)


def test_as_operator_auto_selects_dia():
    A = _banded(400, [0, 1, -1, 7, -7])
    op = rt.as_operator(A)
    assert isinstance(op, DiaOperator)


def test_as_operator_auto_falls_back_to_ell_on_cpu():
    """Scattered sparsity with >64 diagonals on the CPU backend → ELL."""
    A = _random_sym(400, 0.05, seed=8)
    op = rt.as_operator(A)
    assert isinstance(op, SparseEllOperator)


def test_dia_solver_end_to_end():
    """Full RBL solve through the DIA path: eigenvalues of a known banded
    matrix vs numpy."""
    n = 400
    A = _banded(n, [0, 1, -1], seed=9)
    w = np.linalg.eigvalsh(A.toarray())
    idx = np.argsort(-np.abs(w))[:4]
    expect = w[idx]
    res = rt.rbl(rt.as_operator(A), 4, 4)
    np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-9)


def test_bsr_sums_duplicate_coo_entries():
    """Review regression: FEM-assembly-style COO input with duplicate
    entries must sum them (fancy-index scatter alone keeps the last)."""
    rows = np.array([0, 0, 3])
    cols = np.array([1, 1, 2])
    vals = np.array([2.0, 3.0, 7.0])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(8, 8))
    A = A + A.T
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32)
    X = np.eye(8, dtype=np.float32)
    Y = np.asarray(op.apply(jnp.asarray(X)))
    np.testing.assert_allclose(Y, A.toarray(), atol=1e-6)


def _skewed_sym(n, seed=0):
    """Sparse background + a few half-dense rows: the row-length skew that
    makes pure ELL pad every row to ~n/2."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.01, random_state=rng).tolil()
    for r in rng.choice(n, 3, replace=False):
        cols = rng.choice(n, n // 2, replace=False)
        A[r, cols] = rng.standard_normal(len(cols))
    return ((A + A.T) * 0.5).tocsr()


def test_coo_matches_scipy():
    from rbl.ops.spmm.coo import CooOperator

    A = _random_sym(300, 0.03, seed=5)
    op = CooOperator.from_scipy(A)
    X = np.random.default_rng(1).standard_normal((300, 8))
    np.testing.assert_allclose(np.asarray(op @ jnp.asarray(X)), A @ X, rtol=1e-12)


def test_coo_chunked_matches_unchunked():
    import dataclasses

    from rbl.ops.spmm.coo import CooOperator

    A = _random_sym(300, 0.05, seed=6)
    op = CooOperator.from_scipy(A)
    small = dataclasses.replace(op, _chunk=1024)  # forces the scan path
    assert op.rows.shape[0] > 1024
    X = np.random.default_rng(2).standard_normal((300, 4))
    np.testing.assert_allclose(
        np.asarray(small @ jnp.asarray(X)), np.asarray(op @ jnp.asarray(X)),
        rtol=1e-12,
    )


def test_hyb_matches_scipy_and_spills():
    from rbl.ops.spmm.coo import HybOperator

    A = _skewed_sym(400, seed=7)
    op = HybOperator.from_scipy(A)
    assert op.coo.nnz > 0                      # the dense rows spilled
    assert op.ell.cols.shape[0] < np.diff(A.indptr).max()  # ELL is capped
    X = np.random.default_rng(3).standard_normal((400, 8))
    np.testing.assert_allclose(np.asarray(op @ jnp.asarray(X)), A @ X, rtol=1e-12)
    assert abs(op.nnz - A.nnz) <= 0  # no entries lost or duplicated


def test_hyb_no_spill_degenerates_to_ell():
    from rbl.ops.spmm.coo import HybOperator

    A = _random_sym(200, 0.05, seed=9)
    op = HybOperator.from_scipy(A, quantile=1.0)
    assert op.coo.nnz == 0
    X = np.random.default_rng(4).standard_normal((200, 4))
    np.testing.assert_allclose(np.asarray(op @ jnp.asarray(X)), A @ X, rtol=1e-12)


def test_as_operator_auto_selects_hyb_on_skew():
    from rbl.ops.spmm.coo import HybOperator

    op = rt.as_operator(_skewed_sym(400, seed=10))
    assert isinstance(op, HybOperator)


def test_hyb_solver_end_to_end():
    import scipy.sparse.linalg as spla

    A = _skewed_sym(500, seed=11)
    op = rt.as_operator(A)
    k = 6
    D, V = rt.RBL(op, k, 4)
    ref = spla.eigsh(A, k=k, which="LM", tol=0)[0]
    ref = ref[np.argsort(-np.abs(ref))]
    np.testing.assert_allclose(D, ref, rtol=1e-9)
    resid = np.linalg.norm(A @ np.asarray(V) - np.asarray(V) * D[None, :], axis=0)
    assert resid.max() < 1e-6 * np.abs(D).max()


def test_ell_dia_bf16_accumulate_in_f32():
    """Sub-f32 inputs must accumulate in f32 across ALL formats (the _pet
    upcast): a bf16 scan over ~n products per row loses ~L·2⁻⁸ relative.
    ELL and DIA are checked against the f64 ground truth at a tolerance a
    raw-bf16 accumulation fails by an order of magnitude."""
    n, b = 256, 4
    rng = np.random.default_rng(12)
    # one dense band: every row sums ~n/4 products — accumulation-hostile
    A = _banded(n, list(range(-24, 25)), seed=12)
    X = rng.standard_normal((n, b))
    Xb = jnp.asarray(X, dtype=jnp.bfloat16)
    ref = A @ np.asarray(Xb, dtype=np.float64)
    scale = np.abs(ref).max()
    for op in (
        SparseEllOperator.from_scipy(A, dtype=np.float32),
        DiaOperator.from_scipy(A, dtype=np.float32),
    ):
        out = np.asarray(op @ Xb, dtype=np.float64)
        assert np.abs(out - ref).max() < 3e-3 * scale, type(op).__name__


def test_auto_routing_uses_matrix_dtype_when_unspecified(monkeypatch):
    """_pick_sparse_format must gate the BSR branch on the dtype the
    operator will actually be built with — A.dtype when the caller passes
    none — not on a hardcoded f64 default."""
    import jax

    from rbl.ops.spmm.operator import _pick_sparse_format

    A = _random_sym(600, 0.05, seed=13).astype(np.float32)
    assert _pick_sparse_format(A, None) == _pick_sparse_format(A, np.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _pick_sparse_format(A, None)[0] == "bsr"
    assert _pick_sparse_format(A.astype(np.float64), None)[0] != "bsr"


def test_as_operator_routes_pure_diagonal_to_diagonal_operator():
    """An exactly-diagonal scipy matrix must become a DiagonalOperator —
    cheaper applies than any sparse layout, and rbl_generalized's exact
    degree-0 M^{±1/2} fast path keys on it (the reference's test matrices
    are sparse(Diagonal(...)), test.jl:17-50)."""
    d = np.linspace(0.5, 9.0, 300)
    for mat in (sp.diags(d).tocsr(), sp.diags(d).tocoo(), sp.diags(d)):
        op = rt.as_operator(mat)
        assert isinstance(op, rt.DiagonalOperator), type(mat)
        np.testing.assert_allclose(np.asarray(op.diag), d)
    # duplicate COO entries on the diagonal must sum, matching scipy
    A = sp.coo_matrix(([1.0, 2.0, 5.0], ([0, 0, 2], [0, 0, 2])),
                      shape=(3, 3))
    op = rt.as_operator(A)
    assert isinstance(op, rt.DiagonalOperator)
    np.testing.assert_allclose(np.asarray(op.diag), [3.0, 0.0, 5.0])
    # a forced format is honored even for a diagonal matrix
    from rbl.ops.spmm.dia import DiaOperator

    assert isinstance(rt.as_operator(sp.diags(d), format="dia"),
                      DiaOperator)


# ---- packed (CSR-of-tiles) BSR layout --------------------------------------

def _messy_sym(n=2000, seed=0):
    """Skewed tile counts, one very heavy row, plenty of empty block-rows."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 300, 4000), np.full(1500, 1777)])
    cols = np.concatenate(
        [rng.integers(0, n, 4000), rng.integers(0, n, 1500)]
    )
    vals = rng.standard_normal(rows.size)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return ((A + A.T) * 0.5).tocsr()


@pytest.mark.parametrize("bm", [None, 16, 32, 128])
def test_bsr_packed_matches_scipy_all_tile_heights(bm):
    A = _messy_sym()
    rng = np.random.default_rng(1)
    X = rng.standard_normal((A.shape[0], 8)).astype(np.float32)
    op = BlockSparseOperator.from_scipy(
        A, dtype=jnp.float32, bm=bm
    )
    Y = np.asarray(op.apply(jnp.asarray(X)))
    ref = (A @ X.astype(np.float64)).astype(np.float32)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 5e-6
    np.testing.assert_allclose(
        np.asarray(op.diagonal()), A.diagonal(), atol=1e-6
    )


def test_bsr_tile_plan_calibrated_choices():
    """The (bm, bk) plan minimizes bytes moved per apply: scattered dense
    16x16 node blocks go to the finest tile height (taller tiles store
    ~2-4x more zeros), and the plan's operator is correct whatever it
    picks."""
    from rbl.utils.fem import fem_elasticity_3d

    rng = np.random.default_rng(5)
    nbn = 1024
    rb = np.repeat(np.arange(nbn), 7)
    cb = rng.integers(0, nbn, rb.size)
    key = np.unique(
        np.concatenate([rb, cb]).astype(np.int64) * nbn
        + np.concatenate([cb, rb])
    )
    rb, cb = key // nbn, key % nbn
    ii = (rb[:, None, None] * 16 + np.arange(16)[None, :, None]
          ).repeat(16, axis=2).ravel()
    jj = (cb[:, None, None] * 16 + np.arange(16)[None, None, :]
          ).repeat(16, axis=1).ravel()
    G = sp.coo_matrix(
        (np.ones(ii.size, np.float32), (ii, jj)), shape=(nbn * 16, nbn * 16)
    ).tocsr()
    bm_g, bk_g = pb.pick_tile_plan(G)
    assert bm_g == 16 and bk_g in (64, 128)

    A = fem_elasticity_3d(8)
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32)
    assert (op.bm, op.bk) == pb.pick_tile_plan(A)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((A.shape[0], 8)).astype(np.float32)
    Y = np.asarray(op.apply(jnp.asarray(X)))
    ref = (A @ X.astype(np.float64)).astype(np.float32)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 5e-6


def test_bsr_packed_pads_rows_to_unroll_not_to_max():
    """Layout memory: a matrix with one 40-tile row and 99 1-tile rows
    stores exactly its occupied tiles — no per-row alignment padding and
    no pad-to-the-longest-row as blocked-ELL would (100 x 40)."""
    n = 100 * 16
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.full(40, 5), np.arange(100) * 16])
    cols = np.concatenate(
        [np.arange(40) * 40, rng.integers(0, n, 100)]
    )
    A = sp.coo_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(n, n)
    ).tocsr()
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32, bm=16, bk=128)
    assert op.nnz_blocks == len(pb._tile_keys(A, 16, 128)[0]) <= 13 + 100
    X = rng.standard_normal((n, 4)).astype(np.float32)
    Y = np.asarray(op.apply(jnp.asarray(X)))
    ref = (A @ X.astype(np.float64)).astype(np.float32)
    assert np.abs(Y - ref).max() <= 5e-6 * max(np.abs(ref).max(), 1)


def test_bsr_packed_edge_shapes():
    """Empty matrix, 1x1, and n not a multiple of either tile dim."""
    A0 = sp.csr_matrix((64, 64))
    op = BlockSparseOperator.from_scipy(A0, dtype=jnp.float32)
    assert np.all(np.asarray(op.apply(jnp.ones((64, 4), jnp.float32))) == 0)

    A1 = sp.csr_matrix(np.array([[3.0]]))
    op1 = BlockSparseOperator.from_scipy(A1, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(op1.apply(jnp.ones((1, 2), jnp.float32))), 3.0
    )

    A2 = sp.random(333, 333, density=0.05, random_state=0)
    A2 = ((A2 + A2.T) * 0.5).tocsr()
    op2 = BlockSparseOperator.from_scipy(A2, dtype=jnp.float32)
    X2 = np.random.default_rng(0).standard_normal((333, 8)).astype(np.float32)
    Y2 = np.asarray(op2.apply(jnp.asarray(X2)))
    ref = (A2 @ X2.astype(np.float64)).astype(np.float32)
    assert np.abs(Y2 - ref).max() < 5e-6 * np.abs(ref).max()


def test_bsr_plan_none_when_smem_overflows():
    """The plan has no scalar-memory budget to overflow: a matrix with one
    very heavy row and many empty block rows still gets a (bm, bk) plan
    from the allowed sets, and its operator matches scipy."""
    A = _messy_sym()
    bm, bk = pb.pick_tile_plan(A)
    assert bm in (16, 32, 64) and bk in (64, 128)
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32)
    X = np.random.default_rng(4).standard_normal((A.shape[0], 8))
    Y = np.asarray(op.apply(jnp.asarray(X, jnp.float32)))
    ref = A @ X.astype(np.float32).astype(np.float64)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 5e-6


# ---- the kernel (interpret mode here), its plain twin, the dtype rule -----

def _ref_in(dtype, M):
    """M rounded to ``dtype`` and back to f64 — the exact operand the
    kernel sees, so only its accumulation error is measured."""
    return np.asarray(jnp.asarray(M, dtype).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("bm", [16, 32, 64])
def test_bsr_kernel_interpret_matches_scipy(bm, b, dtype):
    """The Pallas kernel (interpret mode) against scipy in f64 at every
    tile height, at a width it pads (8) and one it takes as is (16).
    f32 accumulation over ≤ 4 tiles of 64 products: 5e-6 relative."""
    n = 512
    A = _random_sym(n, 0.03, seed=21)
    rptr, cols, vals, _, _ = pb.bsr_from_scipy(A, bm, 64, dtype)
    X = np.random.default_rng(22).standard_normal((n, b))
    Y = pb.bsr_apply(jnp.asarray(rptr), jnp.asarray(cols), jnp.asarray(vals),
                     jnp.asarray(X, jnp.float32), bm=bm, bk=64,
                     interpret=True)
    assert Y.shape == (n, b) and Y.dtype == jnp.float32
    Ad = sp.csr_matrix(_ref_in(dtype, A.toarray()))
    ref = Ad @ _ref_in(dtype, X)
    assert np.abs(np.asarray(Y, np.float64) - ref).max() \
        / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize("n", [333, 1000])
def test_bsr_kernel_ragged_n_and_empty_rows(n):
    """n not a multiple of either tile dimension, and whole empty block
    rows (the kernel's loop runs zero times there and must write zeros)."""
    rng = np.random.default_rng(n)
    # rows and columns past n/3 stay empty
    rows, cols = rng.integers(0, n // 3, (2, 3000))
    C = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n))
    A = (C + C.T).tocsr()
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32, bm=16, bk=128)
    assert np.any(np.diff(np.asarray(op.rptr)) == 0)  # empty block rows
    X = rng.standard_normal((n, 5)).astype(np.float32)
    Y = np.asarray(op.apply(jnp.asarray(X)))
    ref = A @ X.astype(np.float64)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("bm,bk", [(16, 128), (64, 64)])
def test_bsr_xla_matches_scipy(bm, bk, dtype):
    """The plain XLA version (gather + batched product + segment_sum)
    against scipy: f64 to roundoff, f32 at f32 accumulation."""
    n = 700
    A = _random_sym(n, 0.02, seed=31)
    rptr, cols, vals, nb, ncb = pb.bsr_from_scipy(A, bm, bk, dtype)
    X = np.random.default_rng(32).standard_normal((ncb * bk, 6))
    X[n:] = 0
    Y = np.asarray(pb.bsr_spmm_xla(jnp.asarray(rptr), jnp.asarray(cols),
                                   jnp.asarray(vals), jnp.asarray(X, dtype),
                                   bk=bk), np.float64)
    assert Y.shape == (nb * bm, 6)
    ref = A @ _ref_in(dtype, X[:n]) if dtype != jnp.float64 else A @ X[:n]
    tol = 1e-13 if dtype == jnp.float64 else 5e-6
    assert np.abs(Y[:n] - ref).max() / np.abs(ref).max() < tol
    assert np.all(Y[n:] == 0)


def test_bsr_kernel_matches_xla():
    """Kernel and plain version agree on the same tiles (f32)."""
    A = _messy_sym(seed=3)[:1024, :1024]
    rptr, cols, vals = map(
        jnp.asarray, pb.bsr_from_scipy(A, 32, 128, np.float32)[:3]
    )
    X = jnp.asarray(np.random.default_rng(5).standard_normal((1024, 16)),
                    jnp.float32)
    Yk = pb.bsr_spmm(rptr, cols, vals, X, bm=32, bk=128, interpret=True)
    Yx = pb.bsr_spmm_xla(rptr, cols, vals, X, bk=128)
    np.testing.assert_allclose(np.asarray(Yk), np.asarray(Yx),
                               rtol=1e-5, atol=1e-5)


def test_bsr_dtype_rule_f64_takes_plain_path(monkeypatch):
    """f32/bf16 operators run the kernel; f64 operators the plain XLA
    version, by an explicit dtype rule — never by catching a failure."""
    assert pb.uses_kernel(jnp.float32) and pb.uses_kernel(jnp.bfloat16)
    assert not pb.uses_kernel(jnp.float64)
    calls = []
    real = pb.bsr_spmm
    monkeypatch.setattr(pb, "bsr_spmm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    A = _random_sym(200, 0.05, seed=41)
    X = np.random.default_rng(42).standard_normal((200, 3))
    op64 = BlockSparseOperator.from_scipy(A, dtype=jnp.float64, bm=16, bk=64)
    np.testing.assert_allclose(np.asarray(op64.apply(jnp.asarray(X))),
                               A @ X, atol=1e-12)
    assert calls == []
    op32 = BlockSparseOperator.from_scipy(A, dtype=jnp.float32, bm=16, bk=64)
    op32.apply(jnp.asarray(X, jnp.float32))
    assert calls == [1]


@pytest.mark.parametrize("case", ["banded", "scattered_f32", "scattered_f64",
                                  "low_fill_f32", "wide_band_f32",
                                  "wide_band_cpu"])
def test_router_choices_on_gpu_backend(monkeypatch, case):
    """By the measured per-entry costs: a few full diagonals → DIA;
    scattered f32 with tiles ~9% full → the BSR kernel (built compiled,
    not interpreted); f64 → ELL; f32 tiles under the ~0.047 crossover
    fill → ELL; full bands past the DIA limit → the kernel on the GPU,
    ELL where the kernel only interprets (the CPU)."""
    import jax

    from rbl.ops.spmm.ell import SparseEllOperator
    from rbl.ops.spmm.operator import _DIA_MAX_DIAGONALS

    wide = list(range(-(_DIA_MAX_DIAGONALS // 2 + 4),
                      _DIA_MAX_DIAGONALS // 2 + 5))
    backend = "cpu" if case.endswith("_cpu") else "gpu"
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    A, dtype, expect = {
        "banded": (_banded(400, [0, 1, -1, 90, -90]), None, DiaOperator),
        "scattered_f32": (_random_sym(600, 0.05, seed=13), jnp.float32,
                          BlockSparseOperator),
        "scattered_f64": (_random_sym(600, 0.05, seed=13), None,
                          SparseEllOperator),
        "low_fill_f32": (_random_sym(600, 0.01, seed=13), jnp.float32,
                         SparseEllOperator),
        "wide_band_f32": (_banded(600, wide), jnp.float32,
                          BlockSparseOperator),
        "wide_band_cpu": (_banded(600, wide), jnp.float32,
                          SparseEllOperator),
    }[case]
    assert len(wide) > _DIA_MAX_DIAGONALS
    op = rt.as_operator(A, dtype=dtype)
    assert type(op) is expect, type(op).__name__
    if expect is BlockSparseOperator:
        assert op.interpret is False
        assert (op.bm, op.bk) == pb.pick_tile_plan(A)


@pytest.mark.gpu
def test_bsr_kernel_compiled_on_gpu(gpu):
    """The compiled kernel against scipy in f64 on the card, f32 at the
    f32 tolerance (IEEE f32 tile products, f32 accumulation)."""
    from rbl.utils.fem import fem_elasticity_3d

    A = fem_elasticity_3d(12)
    op = BlockSparseOperator.from_scipy(A, dtype=jnp.float32)
    assert op.interpret is False
    X = np.random.default_rng(0).standard_normal((A.shape[0], 16))
    Y = np.asarray(op.apply(jnp.asarray(X, jnp.float32)), np.float64)
    ref = A @ X.astype(np.float32).astype(np.float64)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5
