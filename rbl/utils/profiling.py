"""Per-phase timing — the TimerOutputs analogue.

The reference times every phase of the hot loop with a harness-owned global
``TimerOutput`` ("A*Q", "3-term", "QR", "Part reorth", "Loc reorth", "eig",
"Ritz vectors" — RBL.jl:80-107) and forces device sync with CUDA.@sync
around each timed region (RBL_gpu.jl:152).  Here: an explicit, passed-in
Timer (no hidden global) whose sections optionally ``block_until_ready`` for
accurate device timing, plus ``jax.profiler`` trace hooks for deep dives.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class Timer:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @staticmethod
    def _barrier():
        # Device programs execute in launch order, so waiting for a freshly
        # enqueued trivial computation drains everything queued before it.
        import jax.numpy as jnp

        (jnp.zeros(()) + 1.0).block_until_ready()

    @contextlib.contextmanager
    def section(self, name: str):
        if self.sync:
            self._barrier()
        t0 = time.perf_counter()
        with jax.named_scope(name):
            yield
        if self.sync:
            self._barrier()
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'section':<18}{'calls':>8}{'time (s)':>12}{'%':>7}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<18}{self.counts[name]:>8}{t:>12.4f}{pct:>6.1f}%")
        lines.append(f"{'total':<18}{'':>8}{total:>12.4f}")
        return "\n".join(lines)


class _NullTimer:
    @contextlib.contextmanager
    def section(self, name: str):
        yield

    def report(self) -> str:
        return "(timing disabled)"


_NULL = _NullTimer()


def null_timer():
    return _NULL


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
