"""Time-to-k-eigenpairs vs block size b (BASELINE.md north-star row 3;
the reference's sweep is b ∈ {1,2,4,8} at k=100, benchmark.jl:29-36).

512² Laplacian, k=50, tol 1e-3, bf16 basis (the headline config), one
compile run and one timed run per block size.  Wider blocks make wider
reorth contractions but do more total work per converged pair — this
sweep records where the trade lands at the solver level.  Prints one
JSON line per b.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    import rbl as rt
    from rbl.backend import device_summary, enable_compile_cache
    from rbl.config import RBLConfig

    enable_compile_cache()

    nx = 512
    k = 50
    op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float32)
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][:k]

    for b in (int(x) for x in (sys.argv[1:] or [4, 8, 16, 32])):
        cfg = RBLConfig(
            block_size=b, basis_dtype=jnp.bfloat16,
            compute_dtype=jnp.float32, qr_method="cholqr2", tol=1e-3,
            max_kryl_dim=768 + (-768) % b, eig_poll_cadence=16, seed=0,
        )
        for leg in ("compile", "timed"):
            t0 = time.perf_counter()
            res = rt.rbl(op, k, b, cfg=cfg, compute_eigenvectors=True)
            jax.block_until_ready(res.eigenvectors)
            dt = time.perf_counter() - t0
        w = np.sort(np.asarray(res.eigenvalues))[::-1]
        print(json.dumps({
            "metric": f"lap2d_512_k50_b{b}",
            "device": device_summary(),
            "warm_s": dt,
            "kryl_dim": int(res.kryl_dim),
            "max_rel_err": float(np.max(np.abs(w - lam) / lam)),
            "converged": bool(res.converged),
        }), flush=True)


if __name__ == "__main__":
    main()
