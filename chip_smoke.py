"""Run the solver's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py           # phases A-E on one card
    python chip_smoke.py --multi   # phase F only: row-sharded solves over
                                   # four cards, each against one card

Phases (each prints what it finds; any failure fails the run):

A. Device: requires a GPU; prints its kind, count, the JAX version,
   XLA_FLAGS, the compile-cache directory and nvidia-smi's name and power
   limit.
B. Matrix-free headline (bench.py's configuration): 2D Laplacian 512²,
   k=50, b=16, bf16 basis, tol 1e-3, Krylov cap 768, cold and warm.
C. Assembled FEM stiffness (fem_elasticity_3d(42), n=232,974, 18.0 M
   nonzeros) through rt.rbl, k=100, b=8, in natural order (routed to DIA)
   and RCM order (routed to the BSR kernel, and timed against the plain
   XLA BSR), against the committed ARPACK eigenvalues.
D. The BSR SpMM kernel at real widths on the RCM matrix: b in {8, 16},
   f32 and bf16, against scipy in f64, timed against the plain XLA
   version, the ELL/HYB operator the router would otherwise build, and
   cuSPARSE CSR (jax.experimental.sparse) as a yardstick.
E. f64 at the reference's tolerance: rbl_polished on the f64 Laplacian
   512², k=50, b=8, to 1e-7, cold and warm.
F. (--multi) ShardedBlockSparseOperator on fem_elasticity_3d(63)
   (n=774,144, k=100, b=8) and ShardedLaplacian2D 2048² (k=50, b=16) over
   a 4-card row mesh, each against the same solve on one card.

Details go to chiprun_out/chip_smoke[_multi].json.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.  With
no GPU, or without the rbl package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """Name and power limit from nvidia-smi, run in a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class CompileCounter:
    """Counts XLA compiles (and persistent-cache loads) and their seconds
    from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.count, self.seconds = 0, 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.count += 1
            self.seconds += duration

    def snapshot(self) -> tuple[int, float]:
        return self.count, self.seconds


def timed(fn, *args, **kwargs):
    """(seconds, result), waiting for every device array in the result."""
    import jax

    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    jax.block_until_ready(
        [getattr(res, "eigenvectors", None), getattr(res, "eigenvalues", None)]
        if hasattr(res, "eigenvalues") else res
    )
    return time.perf_counter() - t0, res


def lap2d_spectrum(nx: int, ny: int, k: int) -> np.ndarray:
    """The k largest eigenvalues of the 5-point Dirichlet Laplacian."""
    ex = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    ey = 2 - 2 * np.cos(np.pi * np.arange(1, ny + 1) / (ny + 1))
    return np.sort(np.add.outer(ex, ey).ravel())[::-1][:k]


def true_residuals(A, lam, V) -> np.ndarray:
    """‖A v − λ v‖₂ of every pair, in f64 on the host."""
    V = np.asarray(V, dtype=np.float64)
    return np.linalg.norm(A @ V - V * np.asarray(lam)[None, :], axis=0)


def orth_error(V) -> float:
    """‖VᵀV − I‖₂ in f64 on the host."""
    V = np.asarray(V, dtype=np.float64)
    return float(np.linalg.norm(V.T @ V - np.eye(V.shape[1]), 2))


def peak_bytes(dev=None) -> int | None:
    import jax

    dev = dev or jax.devices()[0]
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def fmt(x) -> str:
    return np.array2string(np.asarray(x), precision=3, max_line_width=10**6,
                           threshold=10**6)


# --------------------------------------------------------------------------
# Phase B: matrix-free headline


def phase_b(ctx, out: dict) -> None:
    import jax.numpy as jnp

    import rbl as rt

    S, cc = ctx.S, ctx.cc

    nx = S.lap
    op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float32)
    lam = lap2d_spectrum(nx, nx, S.lap_k)
    cfg = rt.RBLConfig(
        block_size=16, basis_dtype=jnp.bfloat16, compute_dtype=jnp.float32,
        qr_method="cholqr2", tol=1e-3, max_kryl_dim=S.lap_cap,
        eig_poll_cadence=16, seed=0,
    )
    for leg in ("cold", "warm"):
        c0 = cc.snapshot()
        dt, res = timed(rt.rbl, op, S.lap_k, 16, cfg=cfg)
        c1 = cc.snapshot()
        w = np.sort(np.asarray(res.eigenvalues, np.float64))[::-1]
        rec = out[leg] = {
            "seconds": dt, "compiles": c1[0] - c0[0],
            "compile_seconds": c1[1] - c0[1],
            "max_rel": float(np.max(np.abs(w - lam) / lam)),
            "orth": orth_error(res.eigenvectors),
            "kryl_dim": int(res.kryl_dim),
            "converged": bool(res.converged),
        }
        log(f"[B] lap2d {nx}² k={S.lap_k} b=16 bf16 basis {leg}: "
            f"{dt:.3f} s, compiles {rec['compiles']} "
            f"({rec['compile_seconds']:.1f} s), "
            f"max_rel {rec['max_rel']:.3e}, ‖VᵀV−I‖ {rec['orth']:.3e}, "
            f"kryl {res.kryl_dim}, converged {res.converged}")
        # Eigenvalues at tol 1e-3 are tol-limited at ~1.4e-2 relative on
        # this problem: 0.025 leaves ~2x margin and still catches a false
        # convergence.
        assert rec["max_rel"] < 0.025, \
            f"headline eigenvalues off by {rec['max_rel']:.3e}"
    out["peak_bytes_in_use"] = peak_bytes()
    log(f"[B] peak_bytes_in_use {out['peak_bytes_in_use']}")


# --------------------------------------------------------------------------
# Phase C: assembled FEM stiffness, natural and RCM order


class Context:
    """What the phases share: sizes, the compile counter, and the FEM
    matrix in natural and RCM order (built once, on first use)."""

    def __init__(self, S, cc: CompileCounter):
        self.S, self.cc, self._fem = S, cc, None

    def fem(self):
        if self._fem is None:
            import scipy.sparse.csgraph as csgraph

            from rbl.utils.fem import fem_elasticity_3d

            A = fem_elasticity_3d(self.S.fem).astype(np.float32)
            perm = csgraph.reverse_cuthill_mckee(A, symmetric_mode=True)
            self._fem = (A, A[perm][:, perm].tocsr())
        return self._fem


def _plain_bsr_operator():
    """BlockSparseOperator whose apply runs the plain XLA BSR: the kernel's
    end-to-end comparison."""
    import dataclasses

    from rbl.ops.spmm.operator import register_operator
    from rbl.ops.spmm.pallas_bsr import BlockSparseOperator, bsr_spmm_xla

    import jax.numpy as jnp

    @register_operator
    @dataclasses.dataclass(frozen=True)
    class PlainBSR(BlockSparseOperator):
        def apply(self, X):
            n, b = X.shape
            pad = -(-n // self.bk) * self.bk - n
            Y = bsr_spmm_xla(self.rptr, self.tile_cols, self.vals,
                             jnp.pad(X, ((0, pad), (0, 0))), bk=self.bk)
            return Y[:n]

    return PlainBSR


def phase_c(ctx, out: dict) -> None:
    import dataclasses

    import jax.numpy as jnp

    import rbl as rt
    from rbl.ops.spmm.operator import _pick_sparse_format

    S, cc = ctx.S, ctx.cc
    A, A_rcm = ctx.fem()
    truth = None
    if S.fem_truth:
        truth = np.load(S.fem_truth)["eigenvalues"]
    # chunk growth off: every fused sweep chunk is 16 steps, so the cold
    # solve compiles a few small programs instead of a 16/32/64-step
    # ladder (the default ladder compiled for 228 s on the DIA operator
    # on an H100); the numerics are the same
    cfg = rt.RBLConfig(
        block_size=8, basis_dtype=jnp.bfloat16, compute_dtype=jnp.float32,
        qr_method="cholqr2", tol=1e-3, max_kryl_dim=S.fem_cap,
        eig_poll_cadence=16, seed=0, chunk_growth_cap=1,
    )
    k = S.fem_k
    log(f"[C] fem3d-{S.fem}: n={A.shape[0]} nnz={A.nnz}")
    PlainBSR = _plain_bsr_operator()

    def solve(order, name, leg, Mop, rec):
        c0 = cc.snapshot()
        dt, res = timed(rt.rbl, Mop, k, 8, cfg=cfg)
        c1 = cc.snapshot()
        w = np.asarray(res.eigenvalues, np.float64)
        r = {"seconds": dt, "compiles": c1[0] - c0[0],
             "compile_seconds": c1[1] - c0[1],
             "kryl_dim": int(res.kryl_dim), "converged": bool(res.converged)}
        if truth is not None:
            r["max_rel"] = float(np.max(
                np.abs(np.sort(w)[::-1] - np.sort(truth)[::-1])
                / np.abs(truth).max()))
        log(f"[C] {order} {name} {leg}: {dt:.3f} s, compiles "
            f"{r['compiles']} ({r['compile_seconds']:.1f} s), kryl "
            f"{res.kryl_dim}, converged {res.converged}, max_rel "
            f"{r.get('max_rel', float('nan')):.3e}")
        rec["legs"][f"{name}_{leg}"] = r
        # tol 1e-3 residual bounds give eigenvalues to ~3e-3 relative
        # (measured 3.1e-3 on an H100, cap hit); 1e-2 leaves ~3x margin.
        # Relative to the largest eigenvalue: the 100 wanted ones cluster
        # within ~0.5% of it.
        if truth is not None:
            assert r["max_rel"] < 1e-2, (order, name, leg, r["max_rel"])
        return w, res

    for order, M in (("natural", A), ("rcm", A_rcm)):
        t0 = time.perf_counter()
        fmt_, plan = _pick_sparse_format(M, None)
        log(f"[C] {order} order: router picks {fmt_!r} plan {plan} "
            f"({time.perf_counter() - t0:.1f} s on the host)")
        rec = {"format": fmt_, "plan": plan, "legs": {}}
        # cold: the scipy CSR through rt.rbl — routing, conversion to the
        # device format and every compile; the warm legs reuse one
        # operator, so they time the solve alone
        solve(order, "router", "cold_from_scipy", M, rec)
        t0 = time.perf_counter()
        op = rt.as_operator(M)
        rec["operator_build_seconds"] = time.perf_counter() - t0
        log(f"[C] {order}: {type(op).__name__} built in "
            f"{rec['operator_build_seconds']:.1f} s on the host")
        legs = [("router", op)]
        if fmt_ == "bsr":
            legs.append(("plain_xla_bsr", PlainBSR(
                **{f.name: getattr(op, f.name)
                   for f in dataclasses.fields(op)})))
        for name, Mop in legs:
            if name != "router":
                solve(order, name, "cold", Mop, rec)
            w, res = solve(order, name, "warm", Mop, rec)
            resid = true_residuals(M.astype(np.float64), w, res.eigenvectors)
            rec["legs"][f"{name}_warm"]["true_residuals"] = resid.tolist()
            log(f"[C] {order} {name} f64 true residuals ‖Av−λv‖ "
                f"(max {resid.max():.3e}): {fmt(resid)}")
        out[order] = rec
    assert out["natural"]["format"] == "dia", out["natural"]["format"]
    assert out["rcm"]["format"] == "bsr", out["rcm"]["format"]


# --------------------------------------------------------------------------
# Phase D: the SpMM kernel at real widths


def time_apply(fn, *args, reps: int = 3, n: int = 30) -> float:
    """Median over ``reps`` of the mean seconds per call over ``n`` calls
    (compiled and warmed first).  Arrays go in as arguments: a jitted
    closure would embed them in the program as constants."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            Y = fn(*args)
        jax.block_until_ready(Y)
        times.append((time.perf_counter() - t0) / n)
    return float(np.median(times))


def copy_bandwidth(elems: int) -> float:
    """Bytes/s of an elementwise f32 copy (read + write) of ``elems``."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((elems,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    return 2 * x.nbytes / time_apply(f, x, n=10)


def _apply(op, x):
    return op.apply(x)


def _csr_matmul(M, x):
    return M @ x


def phase_d(ctx, out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from rbl.backend import interpret_mode
    from rbl.ops.spmm import pallas_bsr as pb
    from rbl.ops.spmm.coo import HybOperator
    from rbl.ops.spmm.ell import SparseEllOperator
    from rbl.ops.spmm.operator import _pick_sparse_format

    S = ctx.S
    _, A = ctx.fem()
    n = A.shape[0]
    bw = copy_bandwidth(S.copy_elems)
    out["copy_GBps"] = bw / 1e9
    log(f"[D] copy bandwidth {bw / 1e9:.1f} GB/s "
        f"({S.copy_elems * 4 >> 20} MiB f32 x+1)")
    bm, bk = pb.pick_tile_plan(A)
    rptr, cols, vals32, _, ncb = pb.bsr_from_scipy(A, bm, bk, np.float32)
    T = len(cols)
    log(f"[D] rcm fem3d-{S.fem}: plan ({bm}, {bk}), {T} tiles, fill "
        f"{A.nnz / (T * bm * bk):.3f}")
    # what the router builds when the kernel is not in play (f64 route)
    alt_fmt, _ = _pick_sparse_format(A.astype(np.float64), None)
    rng = np.random.default_rng(0)
    rp, cl = jnp.asarray(rptr), jnp.asarray(cols)
    apply = jax.jit(_apply)
    out["plan"] = [bm, bk]
    out["alt_format"] = alt_fmt
    out["cases"] = {}
    for dt_name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        vals = jnp.asarray(vals32, dt)
        Ad = sp.csr_matrix(
            (np.asarray(jnp.asarray(A.data, dt).astype(jnp.float32),
                        np.float64), A.indices, A.indptr), shape=A.shape)
        alt = (SparseEllOperator if alt_fmt == "ell" else HybOperator
               ).from_scipy(A, dtype=dt)
        csr = None
        if dt == jnp.float32:
            from jax.experimental import sparse as jsparse

            csr = jsparse.CSR((jnp.asarray(A.data), jnp.asarray(A.indices),
                               jnp.asarray(A.indptr)), shape=A.shape)
        for b in (8, 16):
            # X rounded to the operator dtype; every variant writes f32
            Xd = jnp.asarray(rng.standard_normal((n, b)), dt)
            Xf = Xd.astype(jnp.float32)
            ref = Ad @ np.asarray(Xf, np.float64)
            scale = np.abs(ref).max()
            pad = ((0, ncb * bk - n), (0, max(16, b) - b))
            Xp, Xpf = jnp.pad(Xd, pad), jnp.pad(Xf, pad)
            kw = dict(bm=bm, bk=bk, out_dtype=jnp.float32,
                      interpret=interpret_mode())
            variants = {
                "kernel": (functools.partial(pb.bsr_spmm, **kw),
                           (rp, cl, vals, Xp)),
                "plain_xla": (functools.partial(pb.bsr_spmm_xla, bk=bk),
                              (rp, cl, vals, Xpf)),
                alt_fmt: (apply, (alt, Xf)),
            }
            if csr is not None:
                variants["cusparse_csr"] = (jax.jit(_csr_matmul), (csr, Xf))
            rec = {}
            for name, (f, args) in variants.items():
                Y = np.asarray(f(*args)[:n, :b], np.float64)
                err = float(np.abs(Y - ref).max() / scale)
                sec = time_apply(f, *args)
                rec[name] = {"seconds": sec, "rel_err": err}
                if name.startswith(("kernel", "plain")):
                    rec[name]["A_GBps"] = (T * bm * bk * vals.dtype.itemsize
                                           / sec / 1e9)
            for name, r in rec.items():
                log(f"[D] {dt_name} b={b} {name}: {r['seconds'] * 1e3:.3f} "
                    f"ms/apply, rel err {r['rel_err']:.2e}"
                    + (f", A stream {r['A_GBps']:.0f} GB/s"
                       if "A_GBps" in r else ""))
            out["cases"][f"{dt_name}_b{b}"] = rec
            # Tile products in IEEE f32 (or bf16 operands) with f32
            # accumulation over ≤ ~100 terms per output: max-abs error
            # relative to max |A·X| stays ≤ 1e-5.  ELL/HYB/cuSPARSE and
            # the plain version hold the same bound.
            for name, r in rec.items():
                assert r["rel_err"] < 1e-5, (dt_name, b, name, r["rel_err"])


# --------------------------------------------------------------------------
# Phase E: f64 to the reference's 1e-7


def phase_e(ctx, out: dict) -> None:
    import jax.numpy as jnp

    import rbl as rt
    from rbl.solver.polish import rbl_polished

    S, cc = ctx.S, ctx.cc

    nx = S.lap
    op = rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float64)
    lam = lap2d_spectrum(nx, nx, S.lap_k)
    cfg = rt.RBLConfig(block_size=8, tol=1e-7, qr_method="cholqr2",
                       eig_poll_cadence=16, seed=0)
    for leg in ("cold", "warm"):
        c0 = cc.snapshot()
        dt, res = timed(rbl_polished, op, S.lap_k, cfg=cfg, b=8,
                        bounds=(0.0, None))
        c1 = cc.snapshot()
        w = np.sort(np.asarray(res.eigenvalues, np.float64))[::-1]
        locked = int(np.sum(np.asarray(res.residual_bounds) < 1e-7))
        rel = float(np.max(np.abs(w - lam) / lam)) if len(w) == len(lam) \
            else float("inf")
        r = {"seconds": dt, "compiles": c1[0] - c0[0],
             "compile_seconds": c1[1] - c0[1], "locked": locked,
             "max_rel": rel, "passes": int(res.iterations),
             "orth": orth_error(res.eigenvectors)}
        out[leg] = r
        log(f"[E] f64 lap2d {nx}² k={S.lap_k} tol 1e-7 {leg}: "
            f"{dt:.3f} s (compiles {r['compiles']}, "
            f"{r['compile_seconds']:.1f} s), locked {locked}/{S.lap_k}, "
            f"max_rel {rel:.3e}, ‖VᵀV−I‖ {r['orth']:.3e}, "
            f"passes {r['passes']}")
        # every pair below the reference's 1e-7 residual bound, and
        # eigenvalues within 1e-12 relative (1e-7² ≪ 1e-12 for these
        # separated eigenvalues; f64 roundoff ~1e-15)
        assert locked == S.lap_k, (leg, locked)
        assert rel < 1e-12, (leg, rel)


# --------------------------------------------------------------------------
# Phase F: four cards


def phase_f(ctx, out: dict) -> None:
    import jax
    import jax.numpy as jnp

    import rbl as rt
    from rbl.ops.spmm.pallas_bsr import BlockSparseOperator
    from rbl.parallel.dist_spmm import (
        ShardedBlockSparseOperator, ShardedLaplacian2D,
    )
    from rbl.parallel.mesh import make_row_mesh
    from rbl.utils.fem import fem_elasticity_3d

    S, cc = ctx.S, ctx.cc
    ndev = S.ndev
    assert len(jax.devices()) >= ndev, f"needs {ndev} devices"
    mesh = make_row_mesh(ndev)
    log(f"[F] mesh {dict(mesh.shape)} over {[d.id for d in mesh.devices]}")

    def solve_pair(name, op_many, op_one, k, cfg, check):
        rec = {}
        for label, op, c in (("sharded", op_many, cfg.replace(mesh=mesh)),
                             ("one_card", op_one, cfg)):
            for leg in ("cold", "warm"):
                c0 = cc.snapshot()
                dt, res = timed(rt.rbl, op, k, cfg.block_size, cfg=c)
                c1 = cc.snapshot()
                rec[f"{label}_{leg}"] = {
                    "seconds": dt, "compiles": c1[0] - c0[0],
                    "compile_seconds": c1[1] - c0[1],
                    "kryl_dim": int(res.kryl_dim),
                    "converged": bool(res.converged)}
                log(f"[F] {name} {label} {leg}: {dt:.3f} s, compiles "
                    f"{c1[0] - c0[0]} ({c1[1] - c0[1]:.1f} s), kryl "
                    f"{res.kryl_dim}, converged {res.converged}")
            if label == "sharded":
                devs = res.eigenvectors.sharding.device_set
                assert len(devs) == ndev, f"eigenvectors on {len(devs)} cards"
                w_many = np.asarray(res.eigenvalues, np.float64)
                V_many = res.eigenvectors
            else:
                w_one = np.asarray(res.eigenvalues, np.float64)
        scale = np.abs(w_one).max()
        diff = float(np.max(np.abs(np.sort(w_many) - np.sort(w_one))) / scale)
        rec["rel_diff_sharded_vs_one"] = diff
        rec["peak_bytes_per_device"] = [peak_bytes(d) for d in mesh.devices]
        log(f"[F] {name}: max |λ_sharded − λ_one| / |λ|max = {diff:.3e}; "
            f"peak bytes per card {rec['peak_bytes_per_device']}")
        check(rec, w_many, V_many)
        # both solves stop at tol 1e-3 residual bounds: their eigenvalues
        # agree to that accuracy class (~3e-3), not bit for bit, since the
        # row-sharded Grams sum in another order; 1e-2 leaves ~3x margin
        assert diff < 1e-2, (name, diff)
        return rec

    # assembled FEM, ldoor class
    A = fem_elasticity_3d(S.fem_multi).astype(np.float32)
    log(f"[F] fem3d-{S.fem_multi}: n={A.shape[0]} nnz={A.nnz}")
    sh = ShardedBlockSparseOperator.from_scipy(A, mesh, dtype=jnp.float32)
    one = BlockSparseOperator.from_scipy(A, dtype=jnp.float32,
                                         bm=sh.bm, bk=sh.bk)
    assert len(sh.vals.sharding.device_set) == ndev
    log(f"[F] tiles {sh.bm}x{sh.bk}, ghost blocks per apply "
        f"{sh.comm_blocks_per_apply()}")
    # chunk growth off, as in phase C: bounded compile time
    cfg = rt.RBLConfig(block_size=8, basis_dtype=jnp.bfloat16,
                       compute_dtype=jnp.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=S.fem_cap,
                       eig_poll_cadence=16, seed=0, chunk_growth_cap=1)

    def check_fem(rec, w, V):
        resid = true_residuals(A.astype(np.float64), w, V)
        rec["true_residual_max"] = float(resid.max())
        log(f"[F] fem sharded f64 true residuals max {resid.max():.3e}")

    out["fem"] = solve_pair(f"fem3d-{S.fem_multi}", sh, one, S.fem_k, cfg,
                            check_fem)

    # matrix-free stencil with ppermute halos
    nx = S.lap_multi
    lam = lap2d_spectrum(nx, nx, S.lap_k)
    cfg = rt.RBLConfig(block_size=16, basis_dtype=jnp.bfloat16,
                       compute_dtype=jnp.float32, qr_method="cholqr2",
                       tol=1e-3, max_kryl_dim=S.lap_cap,
                       eig_poll_cadence=16, seed=0)

    def check_lap(rec, w, V):
        rec["max_rel_vs_analytic"] = float(
            np.max(np.abs(np.sort(w)[::-1] - lam) / lam))
        log(f"[F] lap2d sharded max_rel vs analytic "
            f"{rec['max_rel_vs_analytic']:.3e}")
        # the headline's accuracy class (phase B)
        assert rec["max_rel_vs_analytic"] < 0.025

    out["lap"] = solve_pair(
        f"lap2d-{nx}²",
        ShardedLaplacian2D(nx=nx, ny=nx, mesh=mesh, _dtype=jnp.float32),
        rt.Laplacian2D(nx=nx, ny=nx, _dtype=jnp.float32),
        S.lap_k, cfg, check_lap)


# --------------------------------------------------------------------------


class Sizes:
    """The full-size configuration (a rehearsal substitutes small ones)."""
    lap = 512            # bench.py's headline grid (n = 262,144)
    lap_k = 50
    lap_cap = 768
    fem = 42             # hood class: n = 232,974, 18.0 M nonzeros
    fem_k = 100
    fem_cap = 1400
    fem_truth = os.path.join(HERE, "benchmarks", "groundtruth",
                             "fem42_lm_k100.npz")
    fem_multi = 63       # ldoor class: n = 774,144 = 4·128·1512
    lap_multi = 2048
    ndev = 4
    copy_elems = 1 << 28  # 1 GiB, far past the 50 MB L2


def run(phases, S, out_name: str) -> int:
    import jax

    import rbl  # noqa: F401  (x64 on)
    from rbl.backend import device_summary, enable_compile_cache, require_gpu

    try:
        require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    summary = device_summary()
    cache = enable_compile_cache()
    smi = nvidia_smi()
    log(f"[A] device {summary['kind']} x{summary['count']} "
        f"({summary['platform']}), jax {jax.__version__}")
    log(f"[A] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[A] compile cache {cache}")
    ctx = Context(S, CompileCounter())
    results = {"device": summary, "nvidia_smi": smi, "jax": jax.__version__}
    failed = []
    for name, fn in phases:
        rec = results.setdefault(name, {})
        t0 = time.perf_counter()
        try:
            fn(ctx, rec)
        except Exception as e:  # a phase failure fails the run, at the end
            failed.append(name)
            rec["error"] = f"{type(e).__name__}: {e}"
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
        rec["phase_seconds"] = time.perf_counter() - t0
        log(f"[{name}] phase time {rec['phase_seconds']:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        json.dump(results, f, indent=1, default=str)
    log(f"nvidia-smi: {smi}")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only phase F, the row-sharded solves over four "
                        "cards")
    args = p.parse_args(argv)
    if args.multi:
        phases = [("F", phase_f)]
        name = "chip_smoke_multi.json"
    else:
        phases = [("B", phase_b), ("C", phase_c), ("D", phase_d),
                  ("E", phase_e)]
        name = "chip_smoke.json"
    return run(phases, Sizes(), name)


if __name__ == "__main__":
    sys.exit(main())
