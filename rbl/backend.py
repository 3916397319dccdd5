"""Where the program runs: the one module that knows backend names.

The solver runs on NVIDIA GPUs, where its Pallas kernels compile through
Triton, and is tested on JAX's CPU backend, where the same kernels run in
interpret mode.  No other backend is supported.
"""

from __future__ import annotations

import os

import jax

# The checkout (or install) root: the package lives one level below it.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_summary() -> dict:
    """Platform, device kind and count of JAX's default backend, as a
    benchmark line names its device."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> list:
    """The GPU devices, or RuntimeError when JAX found no GPU.  Every
    measurement path calls this first: it never falls back to the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default backend is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this path measures the GPU only"
        )
    return devs


def interpret_mode() -> bool:
    """Whether Pallas kernels run in interpret mode: True on the CPU test
    backend, False (compiled) on the GPU."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"unsupported JAX backend {platform!r}: kernels compile for 'gpu' "
        "and run interpreted on 'cpu'"
    )


def donate(*argnums: int) -> tuple:
    """Donation argnums for ``jax.jit``, or ``()`` when
    ``RBL_NO_DONATION=1``: XLA:CPU can abort while reloading donated
    executables from the persistent compile cache, so a cached CPU test
    run compiles them without donation.  Read at decoration time."""
    if os.environ.get("RBL_NO_DONATION") == "1":
        return ()
    return argnums


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<root>/.jax_cache``
    — a fixed path, since the directory is part of each entry's key."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()`` and
    keep every program that took more than 0.1 s to compile (the sweep's
    chunk programs included).  Returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
