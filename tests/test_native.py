"""Native C++ component tests: the tred2/tql2 banded eigensolver and the
MatrixMarket parser (native/*.cpp via ctypes).  These are the framework's
equivalents of the reference's only native touchpoints — the raw LAPACK
dsbev ccall (common.jl:28-48) and the MatrixMarket/MAT loaders
(benchmark.jl:21-28).  Skipped when no C++ toolchain is available."""

import os
import tempfile

import numpy as np
import pytest
import scipy.io
import scipy.linalg
import scipy.sparse as sp

from rbl import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _rand_band(m, b, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    band = np.zeros((b + 1, m))
    band[0] = rng.standard_normal(m) * scale
    band[1:, : m - 1] = 0.4 * rng.standard_normal((b, m - 1))
    return band


@pytest.mark.parametrize("m,b", [(1, 1), (5, 2), (64, 1), (200, 5), (500, 8)])
def test_band_eigh_matches_scipy(m, b):
    band = _rand_band(m, min(b, m), seed=m + b)
    w, V = native.band_eigh(band)
    w_ref = scipy.linalg.eigvals_banded(band, lower=True)
    np.testing.assert_allclose(w, w_ref, atol=1e-11 * max(abs(w_ref).max(), 1))
    from rbl.ops.band import band_to_dense

    Td = band_to_dense(band)
    assert np.abs(Td @ V - V * w[None, :]).max() < 1e-11 * max(abs(w).max(), 1)
    assert np.abs(V.T @ V - np.eye(m)).max() < 1e-12 * m


def test_band_eigh_clustered_spectrum():
    """Repeated eigenvalues (the step_decay fixture's sea of ones)."""
    m = 120
    band = np.zeros((2, m))
    band[0] = 1.0
    band[0, :5] = [100.0, 80.0, 60.0, 40.0, 20.0]
    w, V = native.band_eigh(band)
    assert np.abs(np.sort(w)[-5:] - [20, 40, 60, 80, 100]).max() < 1e-12
    assert np.abs(V.T @ V - np.eye(m)).max() < 1e-12 * m


def test_solver_with_native_eig_backend():
    """End-to-end RBL solve using the native eigensolver backend."""
    import rbl as rt

    n = 500
    d = np.arange(1.0, n + 1.0)
    cfg = rt.RBLConfig(block_size=4, eig_backend="native")
    res = rt.rbl(d, 5, 4, cfg=cfg)
    np.testing.assert_allclose(res.eigenvalues, d[::-1][:5], rtol=1e-12)


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_mm_parser_roundtrip(symmetry):
    rng = np.random.default_rng(3)
    A = sp.random(60, 60, density=0.08, random_state=rng)
    if symmetry == "symmetric":
        A = (A + A.T) * 0.5
    A = A.tocoo()
    with tempfile.NamedTemporaryFile(suffix=".mtx", delete=False) as f:
        path = f.name
    try:
        scipy.io.mmwrite(path, A, symmetry=symmetry)
        B = native.read_matrix_market(path)
        assert abs(B.toarray() - A.toarray()).max() < 1e-15
    finally:
        os.unlink(path)


def test_mm_parser_pattern():
    with tempfile.NamedTemporaryFile(
        "w", suffix=".mtx", delete=False
    ) as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write("% comment line\n3 3 2\n1 2\n3 1\n")
        path = f.name
    try:
        B = native.read_matrix_market(path).toarray()
        expect = np.zeros((3, 3))
        expect[0, 1] = expect[2, 0] = 1.0
        np.testing.assert_array_equal(B, expect)
    finally:
        os.unlink(path)


def test_mm_parser_via_load_matrix():
    """utils.load_matrix routes .mtx through the native parser and
    symmetrizes."""
    from rbl.utils.suitesparse import load_matrix

    rng = np.random.default_rng(4)
    A = sp.random(40, 40, density=0.1, random_state=rng)
    A = ((A + A.T) * 0.5).tocoo()
    with tempfile.NamedTemporaryFile(suffix=".mtx", delete=False) as f:
        path = f.name
    try:
        scipy.io.mmwrite(path, A, symmetry="symmetric")
        B = load_matrix(path)
        assert abs(B - A.tocsr()).max() < 1e-15
    finally:
        os.unlink(path)
