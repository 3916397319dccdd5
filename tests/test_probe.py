"""Worker-fault probes + retry wrapper (utils/probe.py).

The reference has no failure-detection subsystem (SURVEY §5); this covers
the opt-in library-level retry for a device that returns garbage after a
fault."""

import numpy as np
import pytest

import rbl  # noqa: F401 — enables x64 before probes run
from rbl.solver.lanczos import LanczosResult
from rbl.utils.probe import (
    backend_healthy,
    solve_with_retry,
    wait_until_healthy,
)


def _result(vals):
    return LanczosResult(
        eigenvalues=np.asarray(vals), eigenvectors=None,
        iterations=1, kryl_dim=8, converged=True,
    )


def test_backend_healthy_on_cpu():
    assert backend_healthy()
    assert wait_until_healthy(attempts=1, sleep_s=0)


def test_retry_after_floating_point_error():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise FloatingPointError("non-finite T blocks (injected)")
        return _result([3.0, 2.0])

    res = solve_with_retry(flaky, retries=1, attempts=1, sleep_s=0)
    assert calls["n"] == 2
    np.testing.assert_allclose(res.eigenvalues, [3.0, 2.0])


def test_retry_after_nonfinite_result():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            return _result([np.nan, 2.0])
        return _result([3.0, 2.0])

    res = solve_with_retry(flaky, retries=2, attempts=1, sleep_s=0)
    assert calls["n"] == 2
    assert np.all(np.isfinite(res.eigenvalues))


def test_exhausted_retries_propagate_error():
    def always_bad():
        raise FloatingPointError("injected")

    with pytest.raises(FloatingPointError):
        solve_with_retry(always_bad, retries=1, attempts=1, sleep_s=0)


def test_exhausted_retries_return_last_result():
    # genuine numerical failure (always non-finite) must still surface —
    # the final attempt's result returns as-is for the caller to inspect
    res = solve_with_retry(
        lambda: _result([np.nan]), retries=1, attempts=1, sleep_s=0
    )
    assert np.isnan(res.eigenvalues).all()


def test_retry_catches_xla_runtime_error():
    # a hard worker crash surfaces as a jax/XLA runtime error, not
    # FloatingPointError — it must get the same health-wait-and-retry
    from rbl.utils.probe import _retryable_exceptions

    excs = _retryable_exceptions()
    assert len(excs) > 1  # FloatingPointError + at least one jax error
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise excs[-1]("RESOURCE_EXHAUSTED (injected)")
        return _result([3.0])

    res = solve_with_retry(flaky, retries=1, attempts=1, sleep_s=0)
    assert calls["n"] == 2
    np.testing.assert_allclose(res.eigenvalues, [3.0])


def test_solver_level_fault_retry_rbl(monkeypatch):
    """VERDICT r3 item 6: the probe-on-nonfinite retry wired into the
    SOLVER, not just bench.py — an injected garbage start block (the
    post-OOM worker signature) fires the non-finite-T guard; with
    cfg.fault_retries=1 the solve re-dispatches and completes, with 0 it
    propagates."""
    import jax.numpy as jnp

    import rbl as rt
    import rbl.solver.rbl as rblmod
    from rbl.config import RBLConfig

    real = rblmod.random_start_block
    calls = {"n": 0}

    def flaky(*a, **kw):
        blk = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            return jnp.full_like(blk, jnp.nan)
        return blk

    monkeypatch.setattr(rblmod, "random_start_block", flaky)
    d = np.arange(1.0, 301.0)
    op = rt.DiagonalOperator(jnp.asarray(d))
    cfg = RBLConfig(tol=1e-8, block_size=4, fault_retries=1, seed=0)
    res = rt.rbl(op, 5, cfg=cfg)
    assert res.converged and calls["n"] >= 2
    np.testing.assert_allclose(res.eigenvalues, d[::-1][:5], rtol=1e-10)

    calls["n"] = 0
    with pytest.raises(FloatingPointError):
        rt.rbl(op, 5, cfg=cfg.replace(fault_retries=0))


def test_solver_level_fault_retry_restarted(monkeypatch):
    import jax.numpy as jnp

    import rbl as rt
    import rbl.solver.restarted as rmod
    from rbl.config import RBLConfig

    real = rmod.random_start_block
    calls = {"n": 0}

    def flaky(*a, **kw):
        blk = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            return jnp.full_like(blk, jnp.nan)
        return blk

    monkeypatch.setattr(rmod, "random_start_block", flaky)
    d = np.arange(1.0, 301.0)
    op = rt.DiagonalOperator(jnp.asarray(d))
    cfg = RBLConfig(tol=1e-7, block_size=2, restart_kryl_dim=24,
                    fault_retries=1, seed=0)
    res = rt.rbl_restarted(op, 4, b=2, cfg=cfg)
    assert res.converged and calls["n"] >= 2
    np.testing.assert_allclose(
        np.sort(res.eigenvalues)[::-1], d[::-1][:4], rtol=1e-9
    )


def test_custom_validate():
    # validator sees the result; a False verdict triggers the retry path
    seen = []

    def solve():
        return _result([1.0])

    def validate(res):
        seen.append(res)
        return len(seen) >= 2

    res = solve_with_retry(solve, retries=3, attempts=1, sleep_s=0,
                           validate=validate)
    assert len(seen) == 2
    np.testing.assert_allclose(res.eigenvalues, [1.0])
