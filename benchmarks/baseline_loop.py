"""Reference-shaped solver loop — the measured baseline behind bench.py.

A faithful port of the REFERENCE's iteration STRUCTURE
(RBL_gpu.jl:134-203): one device dispatch per numeric phase per iteration,
per-iteration device→host transfer of the b×b coupling blocks for T
assembly, partial reorthogonalization as a per-older-block GEMM loop
(RBL_gpu.jl:63-71), an eig + convergence poll on the host every 4th
iteration (RBL_gpu.jl:186-192), and the basis kept as a Python list of
blocks.  The numerics are identical to rbl's solver (same CGS
projections, same QR, same banded Rayleigh–Ritz, same convergence bound) —
only the orchestration differs.

This is what "the reference's design on this hardware" costs: every
per-iteration fetch synchronises host and device, and every small
dispatch serializes against it.  bench.py measures it live at the
headline's configuration.

Run:  python benchmarks/baseline_loop.py [--nx 512] [--k 50] [--b 8]
Import: ``reference_shaped_solve(op, k, b, ...)``.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("b", "qr_method"))
def _start_block(op, key, b, qr_method):
    from rbl.ops.qr import block_qr

    n = op.shape[0]
    omega = jax.random.normal(key, (n, b), dtype=op.dtype)
    Q, _ = block_qr(op.apply(omega), method=qr_method)
    return Q


@jax.jit
def _project_pair(Qold, Qi, Qprev):
    """One step of the reference's per-older-block partial reorth: project
    the two newest blocks against ONE stored block (part_reorth_gpu!,
    RBL_gpu.jl:29-57) — dispatched separately per block, as the reference
    loops (RBL_gpu.jl:63-71)."""
    from rbl.ops.reorth import project_out

    return project_out(Qold, Qi), project_out(Qold, Qprev)


@partial(jax.jit, static_argnames=("qr_method",))
def _loc_reorth(Qi, Qprev, qr_method):
    """loc_reorth! intended semantics (RBL.jl:4-13): CGS vs the previous
    block, then re-orthonormalize."""
    from rbl.ops.qr import block_qr
    from rbl.ops.reorth import project_out

    Q, _ = block_qr(project_out(Qprev, Qi), method=qr_method)
    return Q


@partial(jax.jit, static_argnames=("qr_method",))
def _three_term(op, Qi, Qprev, Bi, qr_method):
    """One recurrence step (RBL_gpu.jl:176-184): SpMM, two projections,
    QR.  Returns the new block and the b×b couplings (fetched by the
    caller each iteration, like the reference's Array(Ai)/fact.R pulls)."""
    from rbl.ops.contract import gram
    from rbl.ops.qr import block_qr

    U = op.apply(Qi) - jnp.dot(Qprev, Bi.T, preferred_element_type=Qi.dtype)
    Ai = gram(Qi, U)
    U = U - jnp.dot(Qi, Ai, preferred_element_type=Qi.dtype)
    Qn, Bn = block_qr(U, method=qr_method)
    return Qn, Ai, Bn


def reference_shaped_solve(op, k, b, tol=1e-3, max_kryl=768, seed=0,
                           qr_method="cholqr2"):
    """Solve with the reference's orchestration shape.  Returns
    (eigenvalues desc-|λ|, iterations)."""
    from rbl.ops.band import BlockTridiagonalT
    from rbl.ops.eig import (
        check_convergence,
        eig_banded_host,
        sort_eig_abs,
    )

    n = op.shape[0]
    Qi = _start_block(op, jax.random.PRNGKey(seed), b, qr_method)
    Qprev = jnp.zeros_like(Qi)
    Bi = jnp.zeros((b, b), dtype=Qi.dtype)
    T = BlockTridiagonalT(b, max_kryl)
    Q_list = []  # the reference's push!(Q, ...) basis archive
    w = V = None
    i = 0
    while (i + 1) * b <= max_kryl:
        i += 1
        if i > 1:
            if i % 2 == 0:  # partial reorth cadence 2 (RBL_gpu.jl:164)
                for Qold in Q_list[:-1]:  # per-block loop (RBL_gpu.jl:63-71)
                    Qi, Qprev = _project_pair(Qold, Qi, Qprev)
            Qi = _loc_reorth(Qi, Qprev, qr_method)
        Q_list.append(Qi)
        Qn, Ai, Bn = _three_term(op, Qi, Qprev, Bi, qr_method)
        # per-iteration D→H pull of the couplings (RBL_gpu.jl:159-161,185)
        T.append_diag(np.asarray(Ai, dtype=np.float64))
        Bn_h = np.asarray(Bn, dtype=np.float64)
        Qprev, Qi, Bi = Qi, Qn, Bn
        if i * b > k and i % 4 == 0:  # eig poll cadence 4 (RBL_gpu.jl:186)
            w_all, V_all = eig_banded_host(T.view(i * b))
            w, V = sort_eig_abs(w_all, V_all, k)
            if check_convergence(Bn_h, V, b, k, tol * np.abs(w).max()):
                break
        T.set_subdiag(Bn_h, i - 1)
    if w is None:
        w_all, V_all = eig_banded_host(T.view(i * b))
        w, V = sort_eig_abs(w_all, V_all, k)
    return np.asarray(w)[::-1], i


def main():
    import argparse

    import rbl as rt

    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--trials", type=int, default=2)
    args = p.parse_args()

    op = rt.Laplacian2D(nx=args.nx, ny=args.nx, _dtype=jnp.float32)
    # warm-up epoch populates the compile caches (benchmark.jl:57-58)
    reference_shaped_solve(op, args.k, args.b)
    times = []
    for _ in range(args.trials):
        t0 = time.perf_counter()
        w, iters = reference_shaped_solve(op, args.k, args.b)
        times.append(time.perf_counter() - t0)
    nx = args.nx
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(w)]
    print(f"reference-shaped loop: best {min(times):.3f} s "
          f"(trials: {[f'{t:.3f}' for t in times]}), {iters} iterations, "
          f"max rel err {np.max(np.abs(w - lam) / lam):.3e}")


if __name__ == "__main__":
    main()
