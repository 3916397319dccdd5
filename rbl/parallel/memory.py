"""Device-memory budgeting for the Krylov basis.

The analogue of the reference's VRAM accounting: ``gpu_buffer_size``
(RBL_gpu.jl:95-104) budgets 0.8·free VRAM minus the working set (6 FLOAT +
5 DOUBLE blocks) minus A, in units of one (n, b) block; ``blocksize``
(RBL_gpu.jl:24-27) budgets recovery panels at 0.7·free.  Here the same
arithmetic caps the Krylov dimension per device, with rows sharded across
``n_devices`` so capacity scales with the mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def device_free_memory(device=None) -> int | None:
    """Free bytes on the device, or None when the backend doesn't report
    (e.g. the CPU test backend)."""
    # local_devices, not devices: under multi-process (jax.distributed)
    # jax.devices()[0] can belong to another process, and memory_stats on
    # a non-addressable device raises INVALID_ARGUMENT
    device = device or jax.local_devices()[0]
    try:
        stats = getattr(device, "memory_stats", lambda: None)()
    except Exception:
        return None
    if not stats:
        return None
    limit = stats.get("bytes_limit")
    used = stats.get("bytes_in_use", 0)
    if limit is None:
        return None
    return max(int(limit - used), 0)


def krylov_capacity(
    n: int,
    block_size: int,
    basis_dtype,
    compute_dtype,
    operator_bytes: int = 0,
    n_devices: int = 1,
    budget_fraction: float = 0.8,
    free_bytes: int | None = None,
) -> int | None:
    """Max Krylov dimension (columns) the basis buffer can hold in HBM.

    Mirrors gpu_buffer_size: budget = frac·free − working set − A, in units
    of one basis block; returns a column count (multiple of block_size),
    or None when free memory is unknown."""
    if free_bytes is None:
        free_bytes = device_free_memory()
    if free_bytes is None:
        return None
    b = block_size
    rows_local = (n + n_devices - 1) // n_devices
    bl_f = rows_local * b * jnp.dtype(basis_dtype).itemsize
    bl_d = rows_local * b * jnp.dtype(compute_dtype).itemsize
    budget = budget_fraction * free_bytes - 6 * bl_f - 5 * bl_d - operator_bytes / n_devices
    nblocks = int(budget // bl_f) if bl_f else 0
    return max(nblocks, 0) * b


def clamp_kryl_dim(cfg_max: int, n: int, block_size: int, basis_dtype,
                   compute_dtype, operator_bytes: int = 0,
                   n_devices: int = 1, budget_fraction: float = 0.8) -> int:
    """Final Krylov cap = min(config cap, n rounded up to b, HBM capacity)."""
    b = block_size
    cap = min(cfg_max, ((n + b - 1) // b) * b)
    hbm = krylov_capacity(
        n, b, basis_dtype, compute_dtype, operator_bytes,
        n_devices=n_devices, budget_fraction=budget_fraction,
    )
    if hbm is not None:
        # hbm == 0 is a real answer (zero basis blocks fit), not "unknown":
        # the max(cap, b) floor below keeps one block, and the caller's
        # k-vs-cap guard turns exhaustion into a clean ValueError instead
        # of an opaque device OOM
        cap = min(cap, hbm)
    return max(cap, b)
