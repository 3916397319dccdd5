"""Device-mesh construction and row shardings.

The reference is strictly single-device; its 'distribution' is a VRAM buffer
plus pinned-host overflow (SURVEY §2c).  Here the first-class layout
is a 1-D mesh over the matrix-row dimension: A's rows, every (n, b) Krylov
block, the basis buffer, and the lock set are all sharded on the same
"rows" axis, so every Gram contraction reduces with a single psum that
GSPMD inserts from the sharding annotations, and SpMM halos ride NVLink
neighbor permutes.  Small state (T, B_i, Ritz values) stays replicated —
exactly the split the reference keeps between device arrays and host-side T
(RBL_gpu.jl:159-161).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_row_mesh(n_devices: Optional[int] = None, axis: str = "rows",
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row-partition axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def row_sharding(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    """(n, b) blocks: rows sharded, block columns replicated."""
    return NamedSharding(mesh, P(axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(x, mesh: Mesh, axis: str = "rows"):
    return jax.device_put(x, row_sharding(mesh, axis))
