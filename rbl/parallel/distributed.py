"""Multi-host (multi-process) execution setup.

The reference is strictly single-process (SURVEY §2c); this module is the
multi-host layer (SURVEY §7 step 5): one
``initialize_cluster()`` call per process, then the exact same solver code
— the 1-D "rows" mesh simply spans every device of every host, GSPMD routes
the b×b Gram psums and stencil halo ppermutes to NCCL (NVLink within a
host, the network across hosts).  Nothing else in the framework is host-count-aware.

Typical pod-slice launch (one process per host)::

    from rbl.parallel.distributed import initialize_cluster
    from rbl.parallel.mesh import make_row_mesh
    import rbl as rt

    initialize_cluster(coordinator_address="host0:1234",
                       num_processes=2, process_id=rank)
    cfg = rt.RBLConfig(mesh=make_row_mesh(), block_size=8)
    res = rt.rbl(op, k=100, cfg=cfg)      # identical single-host code

For CPU-based multi-process testing (the "fake cluster" of SURVEY §4)::

    initialize_cluster(coordinator="localhost:9876", num_processes=2,
                       process_id=<rank>)

Design notes for meshes that cross hosts:
- Keep the "rows" axis ordered so that devices of one host own adjacent
  row slabs — `make_row_mesh` uses `jax.devices()` order, which groups
  each host's devices; the only cross-host traffic in a solve is then the
  two slab-boundary halo rows per host pair and the replicated b×b psum
  tree.
- The Krylov basis store shards rows, so per-host HBM need is n/n_hosts ·
  max_kryl · itemsize — `parallel.memory.krylov_capacity` accounts for
  this via its ``n_devices`` argument.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_cluster(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Initialize jax.distributed for a multi-host run.

    With no arguments, relies on an environment JAX can autodetect the
    coordinator from (a managed cluster).  A plain GPU host has none:
    pass ``coordinator_address``, ``num_processes`` and ``process_id``.  Safe to
    call once per process, before any other JAX API touches the backend.
    """
    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)


def cluster_info() -> dict:
    """Process/device topology of the current run (replicated log lines,
    the reference's println-style observability — SURVEY §5)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_device_count": len(jax.devices()),
    }
