"""Synthetic-spectrum accuracy gates — the reference's CI test suite.

Mirrors Unit Testing/test.jl + {slow,mod,step}_dec.jl: sparse diagonal
matrices with analytically known spectra, full solve, relative eigenvalue
error gated at 1e-13 with k=5, b=5.  Sizes follow the reference drivers
(slow/mod: 100:200:1000, slow_dec.jl:4; step: 100_000:200_000:1_000_000,
step_dec.jl:4 — the largest step sizes are marked slow to keep default CI
fast; CI runs them in a dedicated job, like the reference's 3-way split).
"""

import numpy as np
import pytest

import rbl as rt


def _residual(diag, eig, k, b):
    """RBL_residual (test.jl:10-14): relative eigenvalue error."""
    res = rt.rbl(rt.DiagonalOperator(np.asarray(diag)), k, b)
    return (res.eigenvalues - eig) / eig


def slow_decay(n, k, b):
    """λ_i = i (test.jl:31-37)."""
    a = np.arange(1.0, n + 1.0)
    return _residual(a, a[::-1][:k], k, b)


def moderate_decay(n, k, b):
    """λ_i = Σ_{j≤i} j (test.jl:17-28)."""
    a = np.cumsum(np.arange(1.0, n + 1.0))
    return _residual(a, a[::-1][:k], k, b)


def step_decay(n, k, b):
    """2k dominant eigenvalues i·n atop a sea of ones (test.jl:40-50)."""
    a = np.ones(n)
    sz = 2 * k
    for i in range(1, sz + 1):
        a[sz - i] = i * n
    return _residual(a, a[:k].copy(), k, b)


@pytest.mark.parametrize("n", range(100, 1001, 200))
def test_slow_decay(n):
    assert np.linalg.norm(slow_decay(n, 5, 5)) < 1e-13


@pytest.mark.parametrize("n", range(100, 1001, 200))
def test_moderate_decay(n):
    assert np.linalg.norm(moderate_decay(n, 5, 5)) < 1e-13


@pytest.mark.parametrize("n", [100_000])
def test_step_decay(n):
    assert np.linalg.norm(step_decay(n, 5, 5)) < 1e-13


@pytest.mark.slow
@pytest.mark.parametrize("n", [300_000, 500_000, 700_000, 900_000])
def test_step_decay_large(n):
    assert np.linalg.norm(step_decay(n, 5, 5)) < 1e-13


def test_negative_eigenvalues_by_magnitude():
    """Largest-|λ| selection must find dominant negative eigenvalues
    (sort_eig_abs semantics, common.jl:50-54)."""
    n, k = 400, 4
    a = np.arange(1.0, n + 1.0)
    a[-1] = -2.0 * n  # dominant negative
    res = rt.rbl(rt.DiagonalOperator(a), k, 4)
    expect = sorted(a, key=abs)[::-1][:k]
    np.testing.assert_allclose(res.eigenvalues, expect, rtol=1e-10)


def test_eigenvectors_residual():
    """Ritz vectors must satisfy ‖A v − λ v‖ ≤ tol·‖A‖ (reference validates
    only eigenvalues; we also gate the recovered vectors)."""
    n, k, b = 500, 6, 4
    a = np.cumsum(np.arange(1.0, n + 1.0))
    res = rt.rbl(rt.DiagonalOperator(a), k, b)
    V = np.asarray(res.eigenvectors)
    r = a[:, None] * V - V * res.eigenvalues[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-6 * np.abs(a).max()
    assert np.linalg.norm(V.T @ V - np.eye(k)) < 1e-10


def test_large_gap_gram_spectrum():
    """Large-gap spectra (λ1/λ2 ≈ 700, the image-demo Gram matrix shape)
    drive ghost re-amplification ~‖A‖/‖B‖ per iteration once ‖B‖ collapses;
    the solver's danger-mode escalation (every-step CGS2 partial reorth)
    must keep the basis orthogonal.  Without it the basis degenerates
    (‖QᵀQ−I‖ → 1 within ~15 iterations) and eigenvalues explode past ‖A‖."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    h, w, r = 480, 640, 40
    img = rng.standard_normal((h, r)) @ rng.standard_normal((r, w))
    img += 0.05 * rng.standard_normal((h, w))
    img -= img.min()
    img /= img.max()
    G = img.T @ img
    wtrue = np.linalg.eigvalsh(G)[::-1]
    for b in (1, 4):
        res = rt.rbl(rt.DenseOperator(jnp.asarray(G)), 50, b)
        err = np.abs((res.eigenvalues - wtrue[:50]) / wtrue[0]).max()
        assert res.converged, f"b={b} failed to converge"
        assert err < 1e-7, f"b={b} max rel err {err}"


def test_mixed_precision_bf16_basis():
    """Reference mixed-precision scheme (README.md:69, common.jl:5-6):
    low-precision basis storage + higher-precision recurrence.  bf16 basis
    with f32 recurrence must still resolve well-separated eigenvalues to
    ~bf16-resolution accuracy."""
    import jax.numpy as jnp

    n = 400
    d = np.linspace(1.0, 100.0, n) ** 2
    cfg = rt.RBLConfig(
        block_size=4,
        basis_dtype=jnp.bfloat16,
        compute_dtype=jnp.float32,
        qr_method="cholqr2",
        tol=1e-2,
        max_kryl_dim=200,
    )
    res = rt.rbl(d.astype(np.float32), 4, 4, cfg=cfg)
    expect = np.sort(d)[::-1][:4]
    assert np.abs((res.eigenvalues - expect) / expect).max() < 5e-2


def test_bf16_basis_headline_scheme():
    """The benchmark's flagship mixed-precision scheme (bf16 basis
    storage + f32 recurrence — the reference's FLOAT/DOUBLE split,
    common.jl:5-6, mapped to bf16/f32) must match the f32-basis solve
    on a clustered 2D-Laplacian spectrum (the headline problem shape)."""
    import jax.numpy as jnp

    import rbl as rt

    op = rt.Laplacian2D(nx=64, ny=64, _dtype=jnp.float32)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, 65) / 65)
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:20]
    rels = {}
    for bd in (jnp.float32, jnp.bfloat16):
        cfg = rt.RBLConfig(block_size=8, basis_dtype=bd,
                           compute_dtype=jnp.float32, qr_method="cholqr2",
                           tol=1e-3, max_kryl_dim=256, eig_poll_cadence=16)
        res = rt.rbl(op, 20, cfg=cfg)
        rels[np.dtype(bd).name] = np.abs((res.eigenvalues - lam) / lam).max()
    # bf16 storage must not degrade accuracy beyond the f32 run's level
    assert rels["bfloat16"] < max(2 * rels["float32"], 5e-2)
