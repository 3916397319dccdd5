"""Backend health probes and an opt-in fault-tolerant solve wrapper.

A device that has faulted (out of memory, say) can keep returning garbage
for a while.  The solvers re-dispatch through ``solve_with_retry`` only
when ``RBLConfig.fault_retries`` asks for it (default 0: a retry that
follows a device fault hides the fault).

- ``backend_healthy()`` — value-checked probes that exercise BOTH an f32
  and an f64 matmul and an f64 reduction.  All expected values are
  exactly representable, so the checks are equality-tight.
- ``wait_until_healthy()`` — poll until the probes pass.
- ``solve_with_retry()`` — run a solver entry; on a FloatingPointError (the
  solvers' non-finite-T guard, solver/lanczos.py) or a non-finite result,
  wait for a healthy backend and re-dispatch.

The reference has no failure-detection story at all (SURVEY §5).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

import jax.numpy as jnp


def backend_healthy(n64: int = 512) -> bool:
    """Value-checked backend probes: f32 matmul, f64 matmul, and an f64
    reduction.  ``n64`` sizes the f64 matmul — large enough to run a real
    GEMM kernel, small enough to be cheap (~2 MB operands)."""
    try:
        x = jnp.ones((128, 128), jnp.float32)
        if abs(float((x @ x)[7, 11]) - 128.0) > 1e-3:
            return False
        # x64 guard on the RUNTIME state (importing rbl enables it, but
        # numpy dtype metadata would read 8 regardless — a disabled-x64
        # session must skip the f64 probes or they fail forever)
        f64 = jnp.zeros((), jnp.float64).dtype
        if f64.itemsize == 8:
            y = jnp.ones((n64, n64), f64)
            if float((y @ y)[3, 5]) != float(n64):
                return False
            d = jnp.arange(1.0, 1001.0, dtype=f64)
            # sum i^2, i=1..1000 — exactly representable in f64
            if float(d @ d) != 333833500.0:
                return False
        return True
    except Exception:
        return False


def wait_until_healthy(attempts: int = 12, sleep_s: float = 60.0,
                       n64: int = 512) -> bool:
    """Poll ``backend_healthy`` up to ``attempts`` times.  Returns True
    when healthy; False if every attempt failed."""
    for attempt in range(attempts):
        if backend_healthy(n64=n64):
            return True
        if attempt < attempts - 1:
            time.sleep(sleep_s)
    return False


def _result_finite(res: Any) -> bool:
    vals = getattr(res, "eigenvalues", None)
    if vals is None:
        return True
    return bool(np.all(np.isfinite(np.asarray(vals))))


def _retryable_exceptions() -> tuple:
    """FloatingPointError (the solvers' non-finite-T guard) plus the jax
    runtime errors a device fault surfaces as (out of memory, lost device) —
    those must get the same health-wait-and-retry, not a first-attempt
    propagate."""
    excs = [FloatingPointError]
    try:
        from jax.errors import JaxRuntimeError

        excs.append(JaxRuntimeError)
    except ImportError:  # pragma: no cover — older jax
        pass
    try:
        from jaxlib.xla_extension import XlaRuntimeError

        if not any(issubclass(XlaRuntimeError, e) for e in excs):
            excs.append(XlaRuntimeError)
    except ImportError:  # pragma: no cover
        pass
    return tuple(excs)


def solve_with_retry(
    solve_fn: Callable[..., Any],
    *args: Any,
    retries: int = 1,
    attempts: int = 12,
    sleep_s: float = 60.0,
    validate: Optional[Callable[[Any], bool]] = None,
    exceptions: Optional[tuple] = None,
    **kwargs: Any,
) -> Any:
    """Dispatch ``solve_fn(*args, **kwargs)``; on a retryable exception
    (``exceptions`` overrides: default FloatingPointError + jax runtime
    errors) or a result whose eigenvalues are non-finite (``validate``
    overrides the check), wait for a healthy backend and re-dispatch up to
    ``retries`` more times.  The final attempt's error propagates / result
    returns as-is, so genuine numerical failures still surface."""
    validate = validate or _result_finite
    exceptions = exceptions if exceptions is not None else _retryable_exceptions()
    last_exc: Optional[BaseException] = None
    for attempt in range(retries + 1):
        if attempt > 0:
            wait_until_healthy(attempts=attempts, sleep_s=sleep_s)
        try:
            res = solve_fn(*args, **kwargs)
        except exceptions as e:
            last_exc = e
            if attempt == retries:
                raise
            continue
        if validate(res) or attempt == retries:
            return res
    raise last_exc  # pragma: no cover — loop always returns or raises
