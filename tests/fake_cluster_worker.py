"""Worker process for the multi-host fake-cluster test.

Launched by tests/test_multiprocess.py as ``python fake_cluster_worker.py
<rank> <nproc> <port>``: each process owns 4 virtual CPU devices, joins a
``jax.distributed`` cluster (the CPU stand-in for one process per GPU host
— SURVEY §4's "test multi-node without a real cluster"), builds the GLOBAL
8-device row mesh, and runs the identical sharded solve every rank.  The
eigenvalues (replicated host state) print as one JSON line for the parent
to cross-check between ranks and against the analytic spectrum.
"""

import json
import os
import sys


def main():
    rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # repo root on sys.path: the worker is launched by path, so only
    # tests/ is added automatically
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from rbl.parallel.distributed import cluster_info, initialize_cluster

    initialize_cluster(
        coordinator=f"localhost:{port}", num_processes=nproc, process_id=rank
    )
    info = cluster_info()
    assert info["process_count"] == nproc, info
    assert info["global_device_count"] == 4 * nproc, info

    import numpy as np  # noqa: F401

    import jax.numpy as jnp

    import rbl as rt
    from rbl.parallel.dist_spmm import ShardedLaplacian2D
    from rbl.parallel.mesh import make_row_mesh

    mesh = make_row_mesh()  # all 4·nproc global devices
    nx = ny = 32
    k, b = 4, 4
    op = ShardedLaplacian2D(nx=nx, ny=ny, mesh=mesh, _dtype=jnp.float64)
    cfg = rt.RBLConfig(block_size=b, mesh=mesh, max_kryl_dim=256)
    res = rt.rbl(op, k, b, cfg=cfg)

    # Second path: general sparse triplets built host-side on every rank
    # and device_put onto the GLOBAL sharding (from_scipy scatters local
    # shards — the risky cross-process construction path)
    import scipy.sparse as sp

    from rbl.parallel.dist_spmm import ShardedCooSpMM

    rng = np.random.default_rng(7)
    M = sp.random(256, 256, density=0.03, random_state=rng)
    A = sp.csr_matrix(M + M.T)
    coo_op = ShardedCooSpMM.from_scipy(A, mesh)
    res2 = rt.rbl(
        coo_op, 3, 4, cfg=rt.RBLConfig(block_size=4, mesh=mesh,
                                       max_kryl_dim=256),
    )
    print(json.dumps({
        "rank": info["process_index"],
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "converged": bool(res.converged),
        "kryl_dim": int(res.kryl_dim),
        "coo_eigenvalues": [float(v) for v in res2.eigenvalues],
    }), flush=True)


if __name__ == "__main__":
    main()
