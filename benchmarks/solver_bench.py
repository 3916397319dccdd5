"""Solver benchmark — time-to-k-eigenpairs across block sizes.

Mirrors the reference's benchmark configuration (benchmark.jl:29-36:
block sizes b ∈ {1,2,4,8}, k = 100 largest eigenpairs) on a synthetic
problem, optionally cross-checked against scipy's ARPACK (the reference's
Arpack.eigs comparison, benchmark.jl:42).

Usage:
  python benchmarks/solver_bench.py [--laplacian 512] [--k 100]
      [--blocks 1,2,4,8] [--arpack] [--f64]
  python benchmarks/solver_bench.py --matrix path.mtx
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--laplacian", type=int, default=512)
    p.add_argument("--matrix")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--blocks", default="1,2,4,8")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--max-kryl", type=int, default=1024)
    p.add_argument("--arpack", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--adaptive-reorth", type=int, default=1,
                   help="cfg.adaptive_reorth_max stretch cap (1 = off)")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    import rbl as rt
    from rbl.backend import device_summary, enable_compile_cache
    from rbl.config import RBLConfig

    enable_compile_cache()

    dt_ = jnp.float64 if args.f64 else jnp.float32
    if args.matrix:
        from rbl.utils.suitesparse import load_matrix

        A = load_matrix(args.matrix)
        op = rt.as_operator(A, dtype=np.dtype(dt_.dtype.name if hasattr(dt_, "dtype") else dt_))
        label = args.matrix
    else:
        s = args.laplacian
        op = rt.Laplacian2D(nx=s, ny=s, _dtype=dt_)
        A = None
        label = f"laplacian2d-{s}x{s}"

    # warm-up (reference benchmark.jl:57-58)
    rt.rbl(np.abs(np.random.default_rng(0).standard_normal(64)) + 1.0, 2, 2)

    results = []
    for b in [int(x) for x in args.blocks.split(",")]:
        cfg = RBLConfig(
            block_size=b, tol=args.tol, max_kryl_dim=args.max_kryl,
            basis_dtype=dt_, compute_dtype=dt_,
            qr_method="auto", eig_poll_cadence=8,
            adaptive_reorth_max=args.adaptive_reorth,
        )
        rt.rbl(op, args.k, b, cfg=cfg)  # per-shape compile warm-up
        t0 = time.perf_counter()
        res = rt.rbl(op, args.k, b, cfg=cfg)
        jax.block_until_ready(res.eigenvectors)
        dt = time.perf_counter() - t0
        results.append((b, dt, res))
        print(
            f"[b={b:2d}] {label}: {dt:7.3f}s  converged={res.converged} "
            f"kryl={res.kryl_dim}  λmax={res.eigenvalues[0]:.6e}"
        )

    if args.arpack:
        import scipy.sparse.linalg as spla

        if A is None:
            from rbl.utils.suitesparse import laplacian_2d

            A = laplacian_2d(args.laplacian, args.laplacian)
        t0 = time.perf_counter()
        d = spla.eigsh(A, k=args.k, which="LM", tol=args.tol,
                       return_eigenvectors=False)[::-1]
        t_arp = time.perf_counter() - t0
        best = min(results, key=lambda r: r[1])
        rel = np.abs((best[2].eigenvalues - d) / d).max()
        print(f"[ARPACK] {t_arp:.3f}s  max rel diff vs RBL: {rel:.3e}  "
              f"speedup x{t_arp/best[1]:.1f}")

    best = min(results, key=lambda r: r[1])
    print(json.dumps({
        "metric": f"time_to_{args.k}_eigenpairs_{label}",
        "device": device_summary(),
        "value": round(best[1], 3), "unit": "s", "block_size": best[0],
    }))


if __name__ == "__main__":
    main()
