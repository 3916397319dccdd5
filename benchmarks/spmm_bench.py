"""SpMM format benchmark — nnz/s per sparse layout on the current device.

BASELINE.md north-star: "SpMM throughput: nnz/s/chip at speed-of-light
(memory-bandwidth roofline)".  Measures every operator layout (matrix-free
stencil, DIA, the BSR kernel, ELL scan, HYB/COO) on structurally matched
problems.

Usage: python benchmarks/spmm_bench.py [--n 262144] [--b 8] [--reps 50]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def time_apply(op, X, reps):
    import jax
    import jax.numpy as jnp

    # - op as a pytree ARGUMENT, not a closure: closure-captured operator
    #   arrays become compile-time constants, which bloats the XLA program
    # - applications CHAINED on device (normalized to unit norm so f32
    #   can't overflow) in a lax.fori_loop with a traced trip count: one
    #   compile, and the difference of two counts cancels the fixed
    #   dispatch overhead
    def step(y, o):
        z = o.apply(y)
        return z / jnp.linalg.norm(z[:1024])

    ap = jax.jit(
        lambda o, x, r: jax.lax.fori_loop(0, r, lambda i, y: step(y, o), x)
    )

    def run(r):
        t0 = time.perf_counter()
        jax.block_until_ready(ap(op, X, r))
        return time.perf_counter() - t0

    run(1)  # warm
    lo = float(np.median([run(reps) for _ in range(3)]))
    hi = float(np.median([run(4 * reps) for _ in range(3)]))
    return max(hi - lo, 1e-9) / (3 * reps)


def _row(rows, name, dt, gnnz):
    # print as we go: a run cut by its time limit keeps completed cases
    print(f"  [row] {name:>14} {dt*1e3:9.3f} ms {gnnz:8.2f} Gnnz/s",
          flush=True)
    rows.append((name, dt, gnnz))


def router_matrices(fem: int):
    """The assembled matrices the sparse router has to choose for, f32:
    FEM stiffness in natural order (~99 diagonals), a two-field coupling
    of a smaller mesh (~207 diagonals, the same n class), the RCM order,
    and the RCM order shuffled within windows of 128/256/512 rows (a poor
    local ordering: tile fill falls toward the BSR gate)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    from rbl.utils.fem import fem_elasticity_3d

    A = fem_elasticity_3d(fem).astype(np.float32)
    two = fem_elasticity_3d(max(2, fem * 11 // 14))
    K = sp.kron(two, sp.csr_matrix([[2.0, 1.0], [1.0, 2.0]]))
    perm = csgraph.reverse_cuthill_mckee(A, symmetric_mode=True)
    R = A[perm][:, perm].tocsr()
    yield f"fem3d-{fem} natural", A
    yield f"fem3d-{max(2, fem * 11 // 14)} x 2 fields", K.tocsr().astype(
        np.float32)
    yield f"fem3d-{fem} rcm", R
    rng = np.random.default_rng(0)
    for w in (128, 256, 512):
        q = np.arange(R.shape[0])
        for s in range(0, q.size, w):
            q[s:s + w] = rng.permutation(q[s:s + w])
        yield f"fem3d-{fem} rcm shuffled/{w}", R[q][:, q].tocsr()


def router_bench(fem: int, b: int, reps: int) -> dict:
    """Per-apply seconds of every format the router weighs (DIA where it
    applies, the BSR kernel at its planned tiles, ELL) on each
    ``router_matrices`` matrix, each checked against scipy in f64."""
    import jax.numpy as jnp

    import rbl as rt
    from rbl.ops.spmm.dia import count_diagonals
    from rbl.ops.spmm.operator import _pick_sparse_format
    from rbl.ops.spmm.pallas_bsr import pick_tile_plan, tile_fill

    rng = np.random.default_rng(0)
    out = {}
    for name, M in router_matrices(fem):
        n = M.shape[0]
        X = rng.standard_normal((n, b)).astype(np.float32)
        ref = M.astype(np.float64) @ X.astype(np.float64)
        plan = pick_tile_plan(M)
        rec = {"n": n, "nnz": int(M.nnz), "diagonals": count_diagonals(M),
               "plan": list(plan), "fill": tile_fill(M, *plan),
               "routed": _pick_sparse_format(M, None)[0], "ms": {},
               "rel_err": {}}
        makers = {
            "bsr": lambda: rt.BlockSparseOperator.from_scipy(
                M, dtype=jnp.float32, bm=plan[0], bk=plan[1]),
            "ell": lambda: rt.SparseEllOperator.from_scipy(
                M, dtype=np.float32),
        }
        if rec["diagonals"] <= 256:
            makers["dia"] = lambda: rt.DiaOperator.from_scipy(
                M, dtype=np.float32)
        for fmt, mk in makers.items():
            op = mk()
            Y = np.asarray(op.apply(jnp.asarray(X)), np.float64)
            rec["rel_err"][fmt] = float(
                np.abs(Y - ref).max() / np.abs(ref).max())
            rec["ms"][fmt] = time_apply(op, jnp.asarray(X), reps) * 1e3
            del op
        print(f"  [router] {name}: {json.dumps(rec)}", flush=True)
        out[name] = rec
    return out


def dia_sweep(fem: int, b: int, reps: int,
              counts=(99, 112, 128, 144, 160, 176, 192, 207, 232, 256)):
    """Per-apply seconds of DIA by diagonal count: the nearest ``d``
    diagonals (by |offset|) of a banded matrix holding the two-field
    matrix's offsets, then the next ones out, at the same n."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    import rbl as rt

    _, (_, K) = list(router_matrices(fem))[:2]
    offs = np.unique(K.tocoo().col.astype(np.int64) - K.tocoo().row)
    extra = np.arange(offs.max() + 1, offs.max() + 1 + max(counts))
    offs = np.concatenate([offs[np.argsort(np.abs(offs), kind="stable")],
                           np.stack([extra, -extra], 1).ravel()])
    n = K.shape[0]
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, b)).astype(np.float32))
    out = {}
    for d in counts:
        M = sp.diags([rng.standard_normal(n) for _ in range(d)],
                     offs[:d], (n, n), format="csr", dtype=np.float32)
        op = rt.DiaOperator.from_scipy(M, dtype=np.float32)
        out[d] = time_apply(op, X, reps) * 1e3
        print(f"  [dia] {d} diagonals, n={n}: {out[d]:.4f} ms", flush=True)
        del op
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--matrix", help="optional .mtx/.mat to benchmark instead")
    p.add_argument("--router", action="store_true",
                   help="time DIA, the BSR kernel and ELL on the matrices "
                        "the sparse router chooses for (router_matrices)")
    p.add_argument("--fem", type=int, default=42,
                   help="mesh size of the --router matrices")
    args = p.parse_args()

    if args.router:
        from rbl.backend import device_summary, enable_compile_cache

        enable_compile_cache()
        res = {"device": device_summary(), "b": args.b,
               "dia_ms_by_diagonals": dia_sweep(args.fem, args.b,
                                                args.reps),
               "cases": router_bench(args.fem, args.b, args.reps)}
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "spmm_router.json"), "w") as f:
            json.dump(res, f, indent=1)
        return

    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import rbl as rt

    n, b = args.n, args.b
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, b)).astype(np.float32))
    rows = []

    if args.matrix:
        from rbl.utils.suitesparse import load_matrix

        A = load_matrix(args.matrix).astype(np.float32)
        n = A.shape[0]
        X = jnp.asarray(rng.standard_normal((n, b)).astype(np.float32))
        cases = [
            ("bsr-pallas", lambda: rt.BlockSparseOperator.from_scipy(A, dtype=jnp.float32)),
            ("ell-scan", lambda: rt.SparseEllOperator.from_scipy(A, dtype=np.float32)),
            ("auto", lambda: rt.as_operator(A, dtype=np.float32)),
        ]
        nnz = A.nnz
        for name, mk in cases:
            try:
                op = mk()
            except Exception as e:
                print(f"{name:>12}: skipped ({e})")
                continue
            dt = time_apply(op, X, args.reps)
            _row(rows, name, dt, nnz / dt / 1e9)
    else:
        # structurally matched synthetic problems
        side = int(np.sqrt(n))
        lap = rt.Laplacian2D(nx=side, ny=side, _dtype=jnp.float32)
        Xl = jnp.asarray(
            rng.standard_normal((side * side, b)).astype(np.float32)
        )
        dt = time_apply(lap, Xl, args.reps)
        _row(rows, "stencil-2d", dt, 5 * side * side / dt / 1e9)

        offs = [0, 1, -1, 128, -128, 256, -256, 4096, -4096]
        A = sp.diags([rng.standard_normal(n) for _ in offs], offs, (n, n))
        A = ((A + A.T) * 0.5).tocsr().astype(np.float32)
        for name, mk in [
            ("dia", lambda: rt.DiaOperator.from_scipy(A, dtype=np.float32)),
            ("bsr-pallas", lambda: rt.BlockSparseOperator.from_scipy(A, dtype=jnp.float32)),
            ("ell-scan", lambda: rt.SparseEllOperator.from_scipy(A, dtype=np.float32)),
        ]:
            op = mk()
            dt = time_apply(op, X, args.reps)
            _row(rows, name, dt, A.nnz / dt / 1e9)

        # FEM-class problems — the matrices the BSR kernel exists for
        # (reference benchmark.jl:21-28 benchmarks ldoor/hood/audikw).
        # (a) real 3D elasticity on a regular mesh (fine tiles store far
        #     fewer zeros than coarse ones);
        # (b) audikw-style scattered dense 16x16 node blocks.
        from rbl.utils.fem import fem_elasticity_3d

        F = fem_elasticity_3d(30).astype(np.float32)  # n=86490, 6.6 Mnnz
        Xf = jnp.asarray(
            rng.standard_normal((F.shape[0], b)).astype(np.float32)
        )
        for name, mk in [
            ("bsr-fem3d", lambda: rt.BlockSparseOperator.from_scipy(
                F, dtype=jnp.float32)),
            ("bsr64x128-fem3d", lambda: rt.BlockSparseOperator.from_scipy(
                F, dtype=jnp.float32, bm=64, bk=128)),
            ("dia-fem3d", lambda: rt.DiaOperator.from_scipy(
                F, dtype=np.float32)),
            ("auto-fem3d", lambda: rt.as_operator(F, dtype=np.float32)),
        ]:
            try:
                op = mk()
            except Exception as e:
                print(f"{name:>12}: skipped ({e})")
                continue
            dt = time_apply(op, Xf, args.reps)
            label = getattr(op, "density_report", lambda: "")()
            print(f"  {name}: {label}")
            _row(rows, name, dt, F.nnz / dt / 1e9)

        # sized so the coarse-tile variant still fits device memory next
        # to the fine one
        nbn = 65536 // 16
        bpr = 7
        rb = np.repeat(np.arange(nbn), bpr)
        cb = rng.integers(0, nbn, rb.size)
        key = np.unique(
            np.concatenate([rb, cb]).astype(np.int64) * nbn
            + np.concatenate([cb, rb])
        )
        rb, cb = key // nbn, key % nbn
        ii = (rb[:, None, None] * 16 + np.arange(16)[None, :, None]
              ).repeat(16, axis=2).ravel()
        jj = (cb[:, None, None] * 16 + np.arange(16)[None, None, :]
              ).repeat(16, axis=1).ravel()
        G = sp.coo_matrix(
            (rng.standard_normal(ii.size).astype(np.float32), (ii, jj)),
            shape=(nbn * 16, nbn * 16),
        ).tocsr()
        Xg = jnp.asarray(
            rng.standard_normal((G.shape[0], b)).astype(np.float32)
        )
        for name, mk in [
            ("bsr-blocky", lambda: rt.BlockSparseOperator.from_scipy(
                G, dtype=jnp.float32)),
            ("bsr64x128-blocky", lambda: rt.BlockSparseOperator.from_scipy(
                G, dtype=jnp.float32, bm=64, bk=128)),
        ]:
            try:
                op = mk()
            except Exception as e:
                print(f"{name:>12}: skipped ({e})")
                continue
            dt = time_apply(op, Xg, args.reps)
            label = getattr(op, "density_report", lambda: "")()
            print(f"  {name}: {label}")
            _row(rows, name, dt, G.nnz / dt / 1e9)

        # skewed row-length problem (mean ~16 nnz/row, 8 half-dense rows):
        # pure ELL pads every row to n/2 — HYB caps the scan at the
        # typical row length and spills the heavy rows to COO.  Built from
        # triplets: sp.random at this n samples without replacement from
        # n² and takes minutes.
        bulk = 8 * n
        heavy = rng.choice(n, 8, replace=False)
        hr = np.repeat(heavy, n // 2)
        hc = rng.integers(0, n, hr.size)
        r_ = np.concatenate([rng.integers(0, n, bulk), hr])
        c_ = np.concatenate([rng.integers(0, n, bulk), hc])
        v_ = rng.standard_normal(r_.size)
        S = sp.coo_matrix((v_, (r_, c_)), shape=(n, n))
        S = ((S + S.T) * 0.5).tocsr().astype(np.float32)
        from rbl.ops.spmm.coo import CooOperator, HybOperator

        for name, mk in [
            ("hyb", lambda: HybOperator.from_scipy(S, dtype=np.float32)),
            ("coo-segsum", lambda: CooOperator.from_scipy(S, dtype=np.float32)),
            # ell-scan on this matrix would allocate 2·n·(n/2)·4B — skipped
        ]:
            op = mk()
            dt = time_apply(op, X, args.reps)
            _row(rows, f"{name}(skew)", dt, S.nnz / dt / 1e9)

    from rbl.backend import device_summary

    print(f"device={device_summary()}  n={n}  b={b}")
    print(f"{'format':>12} {'ms':>9} {'Gnnz/s':>8}")
    for name, dt, gnnz in rows:
        print(f"{name:>12} {dt*1e3:9.3f} {gnnz:8.2f}")
    best = max(rows, key=lambda r: r[2])
    print(json.dumps({
        "metric": "spmm_best_gnnz_per_s", "value": round(best[2], 3),
        "unit": "Gnnz/s", "format": best[0],
    }))


if __name__ == "__main__":
    main()
