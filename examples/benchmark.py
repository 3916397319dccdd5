"""Benchmark harness — the reference benchmark.jl re-imagined.

Loads a SuiteSparse matrix (or builds a synthetic Laplacian), runs the
RBL solver across a block-size sweep, cross-checks against scipy's ARPACK
(`eigsh`, the reference's Arpack.eigs comparison — benchmark.jl:42), and
prints the per-phase timing report (TimerOutputs analogue).

Usage:
  python examples/benchmark.py [--matrix path.mtx] [--k 100] [--blocks 1,2,4,8]
  python examples/benchmark.py --laplacian 512   # 512x512 grid, n=262144
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--matrix", help=".mtx or .mat file (SuiteSparse)")
    p.add_argument("--laplacian", type=int, default=0, help="2D grid side")
    p.add_argument("--fem3d", type=int, default=0,
                   help="assemble a real 3D elasticity stiffness matrix on "
                        "an N^3 hex mesh (the ldoor/hood SuiteSparse family; "
                        "use when the matrices can't be downloaded — see "
                        "benchmarks/fetch_suitesparse.sh). N=42 is "
                        "hood-class (238k dof), N=64 ldoor-class (0.8M)")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--permute", action="store_true",
                   help="apply a random symmetric permutation first — the "
                        "worst-case irregular ordering (destroys diagonal "
                        "and block locality; real SuiteSparse orderings "
                        "are better than this)")
    p.add_argument("--rcm", action="store_true",
                   help="apply reverse-Cuthill-McKee bandwidth reduction "
                        "first — the standard preprocessing for "
                        "irregularly-ordered matrices; typically restores "
                        "a DIA/banded-friendly profile")
    p.add_argument("--blocks", default="4")
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--arpack", action="store_true", help="cross-check with scipy eigsh")
    p.add_argument("--repeat", type=int, default=2,
                   help="solves per block size; the first includes XLA "
                        "compile time for every basis-growth bucket, so "
                        "the last repeat is the warm number")
    p.add_argument("--f32", action="store_true",
                   help="f32 basis and recurrence (default: f64, the "
                        "reference's DOUBLE)")
    args = p.parse_args()

    import jax.numpy as jnp

    import rbl as rt
    from rbl.backend import enable_compile_cache
    from rbl.config import RBLConfig
    from rbl.utils.profiling import Timer

    enable_compile_cache()
    use_f64 = not args.f32

    def _reorder(A, label):
        import scipy.sparse as sp_

        if args.permute:
            perm = np.random.default_rng(0).permutation(A.shape[0])
            P = sp_.csr_matrix(
                (np.ones(len(perm)), (np.arange(len(perm)), perm)),
                shape=A.shape,
            )
            A = (P @ A @ P.T).tocsr()
            label += " [random-permuted]"
        if args.rcm:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True)
            A = A.tocsr()[perm][:, perm].tocsr()
            label += " [RCM]"
        return A, label

    if args.matrix:
        from rbl.utils.suitesparse import load_matrix

        A, label = _reorder(load_matrix(args.matrix), args.matrix)
        op = rt.as_operator(A)
    elif args.fem3d:
        from rbl.utils.fem import fem_elasticity_3d

        A = fem_elasticity_3d(args.fem3d)
        A, label = _reorder(
            A, f"fem3d-elasticity-{args.fem3d}^3 (n={A.shape[0]}, nnz={A.nnz})"
        )
        op = rt.as_operator(A.astype(np.float64 if use_f64 else np.float32))
    elif args.laplacian:
        s = args.laplacian
        dt = jnp.float64 if use_f64 else jnp.float32
        op = rt.Laplacian2D(nx=s, ny=s, _dtype=dt)
        A = None
        label = f"laplacian2d-{s}x{s}"
    else:
        p.error("need --matrix, --fem3d, or --laplacian")

    dtype = jnp.float64 if use_f64 else jnp.float32
    blocks = [int(x) for x in args.blocks.split(",")]

    # warm-up on a small random problem (benchmark.jl:57-58's JIT warm-up)
    rt.rbl(np.abs(np.random.default_rng(0).standard_normal(64)) + 1.0, 2, 2)

    for b in blocks:
        cfg = RBLConfig(
            block_size=b, tol=args.tol,
            basis_dtype=dtype, compute_dtype=dtype,
            qr_method="auto" if use_f64 else "cholqr2",
        )
        for rep in range(max(args.repeat, 1)):
            timer = Timer(sync=False)
            t0 = time.perf_counter()
            res = rt.rbl(op, args.k, b, cfg=cfg, timer=timer)
            np.asarray(res.eigenvalues)
            dt_solve = time.perf_counter() - t0
            tag = "cold" if rep == 0 else "warm"
            print(
                f"[RBL b={b} {tag}] {label}: {dt_solve:.3f}s, "
                f"converged={res.converged}, kryl={res.kryl_dim}, "
                f"largest={res.eigenvalues[0]:.6e}, "
                f"smallest={res.eigenvalues[-1]:.6e}"
            )
        print(timer.report())

    if args.arpack:
        import scipy.sparse.linalg as spla

        if A is None:
            from rbl.utils.suitesparse import laplacian_2d

            A = laplacian_2d(args.laplacian, args.laplacian)
        t0 = time.perf_counter()
        d = spla.eigsh(A, k=args.k, which="LM", tol=args.tol,
                       return_eigenvectors=False)[::-1]
        print(f"[ARPACK eigsh] {time.perf_counter() - t0:.3f}s, "
              f"largest={d[0]:.6e}, smallest={d[-1]:.6e}")
        rel = np.abs((res.eigenvalues - d) / d)
        print(f"max |rel diff| RBL vs ARPACK: {rel.max():.3e}")


if __name__ == "__main__":
    main()
