"""Spectrum-shape fuzzing — regression armor beyond the reference's three
fixtures (Unit Testing/test.jl).

The solver's failure modes live in spectrum structure, not in size: the
danger regime (large gaps → ‖B‖ collapse → ghost re-amplification) and the
convergence window (polls overstep it → converged directions corrupt the
basis — found via slow_decay n=700 with grown chunks).  These cases sample
the shapes that historically break block Lanczos implementations: clusters,
huge gaps, mixed signs, near-degenerate pairs, heavy tails — on diagonal
operators where the true spectrum is exact.

Gate: the k returned eigenvalues match the true top-k by |λ| to 1e-10
relative (looser than the 1e-13 reference gate: some shapes legitimately
stop at the Krylov cap, where the Rayleigh-quotient refinement still
delivers ~1e-12; what MUST never happen is a wrong or ghost eigenvalue).
"""

import numpy as np
import pytest

import rbl as rt
from rbl.config import RBLConfig


def _check(diag, k=5, b=5, tol_rel=1e-10, **cfg_kw):
    diag = np.asarray(diag, dtype=np.float64)
    order = np.argsort(np.abs(diag))[::-1]
    true_k = diag[order[:k]]
    cfg = RBLConfig(block_size=b, **cfg_kw)
    res = rt.rbl(rt.DiagonalOperator(diag), k, b, cfg=cfg)
    rel = np.abs(res.eigenvalues - true_k) / np.abs(true_k)
    assert np.all(rel < tol_rel), (
        f"rel errors {rel}, got {res.eigenvalues}, want {true_k}, "
        f"converged={res.converged}, kryl={res.kryl_dim}"
    )


SHAPES = {
    # two tight clusters separated by a huge gap (danger-regime stress)
    "gap_clusters": lambda rng, n: np.concatenate(
        [1e6 + rng.uniform(0, 1, 8), rng.uniform(1, 2, n - 8)]
    ),
    # geometric decay — fast convergence, early poll window
    "geometric": lambda rng, n: 0.9 ** np.arange(n) * 1e3 + 1e-3,
    # mixed signs, |λ| top-k straddles both ends of the spectrum
    "indefinite": lambda rng, n: np.concatenate(
        [-(n + 10.0 - np.arange(5.0)), np.arange(1.0, n - 4.0)]
    ),
    # near-degenerate top pairs (MRRR subset + convergence-bound stress)
    "near_degenerate": lambda rng, n: np.concatenate(
        [[1000.0, 1000.0 + 1e-8, 999.0, 999.0 + 1e-8], np.arange(1.0, n - 3.0)]
    ),
    # heavy uniform tail right under the wanted eigenvalues
    "crowded_top": lambda rng, n: np.concatenate(
        [n + np.arange(6.0), rng.uniform(0.9 * n, n, n - 6)]
    ),
    # random log-uniform — no structure at all
    "log_uniform": lambda rng, n: np.exp(rng.uniform(0, 12, n)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_spectrum(shape, seed):
    rng = np.random.default_rng(seed)
    diag = SHAPES[shape](rng, 400)
    _check(diag)


@pytest.mark.parametrize(
    "shape", ["gap_clusters", "indefinite", "near_degenerate", "log_uniform"]
)
def test_fuzz_spectrum_with_host_offload(shape):
    """The fuzz shapes re-run with the two-tier basis store active: leaks
    along OFFLOADED dominant directions re-amplify per step, a regime the
    all-device fuzz cases cannot reach (the once-per-window host projection
    bug passed every flat-spectrum offload test)."""
    rng = np.random.default_rng(2)
    diag = SHAPES[shape](rng, 400)
    _check(diag, basis_device_cap_cols=64)


@pytest.mark.parametrize("shape", ["gap_clusters", "indefinite"])
def test_fuzz_spectrum_on_mesh(shape, eight_devices):
    """Danger/selective-regime shapes under the 8-device row mesh: policy
    flips, rewinds, and re-randomization interact with sharded state."""
    from rbl.parallel.mesh import make_row_mesh

    rng = np.random.default_rng(3)
    diag = SHAPES[shape](rng, 400)
    _check(diag, mesh=make_row_mesh(8))


def test_fuzz_grown_chunks_narrow_window():
    """The regression that motivated poll decoupling: a slowly separating
    spectrum whose convergence window is narrower than a grown chunk."""
    diag = np.arange(1.0, 701.0)
    _check(diag, chunk_growth_cap=8, eig_poll_cadence=4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fuzz_spectrum_adaptive_reorth(shape):
    """Every fuzz shape with the adaptive full-scrub stretch enabled: the
    stretch must SNAP BACK (and discard under-scrubbed speculation) before
    any ghost regime can exploit the sparser scrubs — accuracy must match
    the fixed-cadence gate exactly."""
    rng = np.random.default_rng(1)
    diag = SHAPES[shape](rng, 400)
    _check(diag, adaptive_reorth_max=4)


def test_fuzz_adaptive_reorth_slow_separation():
    """The narrow-window regression shape with maximum stretch AND grown
    chunks — the calmest spectrum, i.e. where the stretch spends the most
    time at its cap and the convergence-window snap-back matters most."""
    diag = np.arange(1.0, 701.0)
    _check(diag, adaptive_reorth_max=4, chunk_growth_cap=8,
           eig_poll_cadence=4)


def test_fuzz_negative_dominant():
    """Largest-|λ| eigenvalue negative — sign handling through sort_eig_abs,
    the residual bounds, and the Rayleigh refinement."""
    diag = np.concatenate([[-5000.0], np.arange(1.0, 400.0)])
    _check(diag)


RESTARTED_SHAPES = {
    # 8-dim dominant cluster over a tiny sea: breakdown + heavy deflation
    "gap_clusters": np.concatenate(
        [1e6 + np.random.default_rng(0).uniform(0, 1, 8),
         np.random.default_rng(1).uniform(1, 2, 392)]
    ),
    # dominant-value ghost regime (selective mode inside the sweep)
    "negative_dominant": np.concatenate([[-5000.0], np.arange(1.0, 400.0)]),
    # locked near-degenerate pairs leak hardest
    "near_degenerate": np.concatenate(
        [[1000.0, 1000.0 + 1e-8, 999.0, 999.0 + 1e-8], np.arange(1.0, 397.0)]
    ),
    # slow separation: many restarts, growing sweeps
    "slow_uniform": np.arange(1.0, 401.0),
}


@pytest.mark.parametrize("case", ["random_sym", "banded_posdef", "power_law"])
def test_fuzz_sparse_operators_vs_eigsh(case):
    """End-to-end solves on real sparse operators (SpMM format
    auto-selection + solver together), cross-checked against ARPACK —
    the diagonal fuzz cases control the spectrum but never exercise the
    sparse kernels."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = {
        "random_sym": sp.random(400, 400, density=0.05, random_state=3),
        "banded_posdef": sp.diags(
            [np.full(600, 4.0), np.full(599, -1.0), np.full(599, -1.0)],
            [0, 1, -1],
        ),
        "power_law": sp.random(500, 500, density=0.02, random_state=5),
    }[case]
    A = sp.csr_matrix(A + A.T)
    w_ref = spla.eigsh(A, k=5, which="LM", tol=1e-10,
                       return_eigenvectors=False)
    w_ref = w_ref[np.argsort(-np.abs(w_ref))]
    res = rt.rbl(A, 5, 5)
    rel = np.abs(res.eigenvalues - w_ref) / np.abs(w_ref)
    assert res.converged
    assert np.all(rel < 1e-10), (res.eigenvalues, w_ref)


@pytest.mark.slow
def test_f32_large_laplacian_no_false_convergence():
    """Large-n f32 on a clustered-top spectrum (the headline bench shape):
    regression for the pivot-clamp floor that silently destroyed f32
    orthonormality at large n·b — the basis degraded globally and the
    solve FALSELY converged with eigenvalues 10% wrong while the Lanczos
    bounds read 1e-7 (they assume orthonormality)."""
    import jax.numpy as jnp
    from rbl.config import RBLConfig

    nx = ny = 256
    op = rt.Laplacian2D(nx=nx, ny=ny, _dtype=jnp.float32)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:20]
    cfg = RBLConfig(
        block_size=8, basis_dtype=jnp.float32, compute_dtype=jnp.float32,
        qr_method="cholqr2", tol=1e-3, max_kryl_dim=512, eig_poll_cadence=16,
    )
    res = rt.rbl(op, 20, cfg=cfg)
    rel = np.abs(res.eigenvalues - lam) / lam
    assert np.max(rel) < 0.02, (res.eigenvalues[:5], lam[:5])
    # if it claims convergence, the TRUE residuals must back it up
    if res.converged:
        assert np.max(res.residual_bounds) < 10 * cfg.tol


def test_f32_precision_exhaustion_graceful():
    """f32 with dominance beyond eps's resolvable range (σ₁/σ_sea ≈ 1e5):
    the solver must degrade gracefully — finite values, honest TRUE
    residuals in the result, the dominant pairs still accurate — instead
    of running ‖B‖ off to NaN (the pre-detector behavior)."""
    import jax.numpy as jnp
    from rbl.config import RBLConfig

    rng = np.random.default_rng(3)
    diag = np.concatenate(
        [[8.0e4, 4.0e4], 100.0 - np.arange(40.0), rng.uniform(0.1, 0.4, 600)]
    )
    cfg = RBLConfig(
        block_size=8, basis_dtype=jnp.float32, compute_dtype=jnp.float32,
        tol=1e-5, max_kryl_dim=512,
    )
    res = rt.rbl(rt.DiagonalOperator(diag.astype(np.float32)), 20, cfg=cfg)
    assert np.all(np.isfinite(res.eigenvalues))
    assert res.residual_bounds is not None
    assert np.all(np.isfinite(res.residual_bounds))
    # the resolvable (dominant + structural) pairs must still be right
    true_top = np.sort(diag)[::-1][:20]
    rel = np.abs(res.eigenvalues - true_top) / true_top
    assert np.all(rel[:10] < 1e-3), (res.eigenvalues[:10], true_top[:10])


@pytest.mark.parametrize("shape", sorted(RESTARTED_SHAPES))
def test_fuzz_restarted(shape):
    """The restarted sweep is the main driver run against the lock set —
    these spectra all corrupted the previous standalone fixed-length sweep
    (duplicate basis directions, Ritz values past ‖A‖)."""
    from rbl.solver.restarted import rbl_restarted

    diag = np.asarray(RESTARTED_SHAPES[shape], dtype=np.float64)
    order = np.argsort(np.abs(diag))[::-1]
    true_k = diag[order[:4]]
    res = rbl_restarted(rt.DiagonalOperator(diag), 4)
    rel = np.abs(res.eigenvalues - true_k) / np.abs(true_k)
    assert res.converged
    assert np.all(rel < 1e-10), (res.eigenvalues, true_k, rel)


@pytest.mark.slow  # ~60s: the fast tier covers pencils in test_generalized
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_generalized_pencils(seed):
    """Random SPD pencils through rbl_generalized: random sparse symmetric
    A, random well-conditioned SPD M (diagonal + symmetric coupling),
    extreme ends vs the dense scipy.linalg.eigh(A, M) oracle."""
    import scipy.linalg
    import scipy.sparse as sp

    from rbl.solver.generalized import rbl_generalized

    rng = np.random.default_rng(100 + seed)
    n = 260
    A = sp.random(n, n, density=0.03, random_state=seed + 1)
    A = sp.csr_matrix(A + A.T)
    A.setdiag(rng.standard_normal(n) * 3.0)
    Md = sp.random(n, n, density=0.02, random_state=seed + 50)
    Md = (Md + Md.T) * 0.1
    Md.setdiag(rng.uniform(1.0, 3.0, n))
    M = sp.csr_matrix(Md)
    w = scipy.linalg.eigh(A.toarray(), M.toarray(), eigvals_only=True)
    cfg = RBLConfig(block_size=4, tol=1e-9)
    for which, exact in (("LA", w[::-1][:4]), ("SA", w[:4])):
        res = rbl_generalized(A, M, 4, cfg=cfg, which=which)
        assert res.converged, (seed, which)
        rel = np.max(np.abs(res.eigenvalues - exact)
                     / np.maximum(np.abs(exact), 1e-12))
        assert rel < 1e-8, (seed, which, rel)
    # one interior probe (mode 3), sigma between two mid-spectrum values
    sig = w[n // 2] + 0.29 * (w[n // 2 + 1] - w[n // 2])
    res = rbl_generalized(A, M, 3, cfg=cfg, which="LM", sigma=sig)
    exact = w[np.argsort(np.abs(w - sig), kind="stable")[:3]]
    rel = np.max(np.abs(res.eigenvalues - exact) / np.abs(exact))
    assert rel < 1e-8, (seed, rel)
