"""Explicitly restarted, deflating randomized block Lanczos.

Reference: restarted.jl — `RBL_gpu_restarted` / `RBL_restarted`
(restarted.jl:97-146, 196-246) run fixed-length Lanczos sweeps with no
convergence polling, deflate against a lock set of converged Ritz vectors
every 3rd iteration (restarted.jl:53-57), then after one banded eigensolve
lock every Ritz pair whose residual bound clears 1e-7, seed the next sweep
with the first unconverged Ritz vector, and grow the sweep by 10
(restarted.jl:131-142).  Memory stays bounded by the sweep length — the
variant trades restarts for basis storage.

Design notes:
- One device-agnostic implementation replaces the CPU/GPU twins.
- The lock set is a zero-padded (n, k) device buffer sharded like the basis;
  deflation is the same fused projection as partial reorth.
- The sweep state at a restart boundary (lock set, locked values, count,
  sweep length, next start block, PRNG key) is the checkpoint/resume
  surface (SURVEY §5 — the reference has no checkpointing; this variant is
  where it naturally attaches).
- Unlike the reference, which returns V = zeros and discards the locked
  vectors (restarted.jl:99-100,145 — SURVEY #20 notes the quirk), we return
  the locked Ritz vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RBLConfig
from ..ops.qr import block_qr
from ..ops.reorth import deflate
from ..ops.spmm.operator import LinearOperator, as_operator
from .basis import BasisStore, _write_block
from .lanczos import (
    LanczosResult,
    random_start_block,
    recover_eigvec,
)


@dataclasses.dataclass
class RestartState:
    """Checkpointable restart-boundary state (SURVEY §5)."""

    lock_buf: Any              # (n, k) zero-padded locked Ritz vectors
    locked_values: np.ndarray  # (k,)
    count: int
    kryl_dim: int
    Qi: Any                    # next start block (n, b)
    restarts: int = 0
    low_yield_streak: int = 0  # consecutive restarts locking < b/2 pairs


def _restarted_sweep(op, cfg: RBLConfig, Qi, store: BasisStore, lock_buf,
                     timer, k_rem: int):
    """One restart sweep — the MAIN driver run against the lock set.

    The reference implements the restarted sweep as a separate fixed-length
    loop with no convergence polls and no safety machinery
    (lanczos_iteration_res, restarted.jl:23-95 — ~80% duplicated logic,
    SURVEY §7 design stance).  Here it IS ``lanczos_iteration`` with
    ``lock_basis`` set, so the sweep inherits convergence polling (it may
    finish early), breakdown re-randomization, danger/selective reorth
    escalation, and birth-scrub T consistency — without them, every
    large-gap or dominant-value spectrum corrupted the sweep basis
    (measured: duplicate directions with 13× column norms by restart 2).
    Returns (w desc-|λ|, V desc, bounds desc); V has store.ncols rows."""
    from .lanczos import lanczos_iteration

    cdt = jnp.dtype(cfg.compute_dtype)
    qr_method = cfg.resolved_qr_method()
    # deflate + re-orthonormalize the start block (the reference deflates
    # without renormalizing, restarted.jl:40; we renormalize for a properly
    # scaled T)
    Qi = deflate(lock_buf, Qi)
    Qi, _ = block_qr(Qi.astype(cdt), method=qr_method)
    Qi = Qi.astype(cfg.basis_dtype)

    # restart-boundary checkpoints (RestartState) are this variant's
    # fault-tolerance surface — strip the MAIN solver's mid-sweep knobs so
    # successive inner sweeps can't fight over one checkpoint file
    sweep_cfg = cfg.replace(
        max_kryl_dim=cfg.restart_kryl_dim,
        sweep_checkpoint_path=None,
        fault_inject_abort_after_chunks=None,
    )
    w, V, T, bounds, converged, nb = lanczos_iteration(
        op, k_rem, sweep_cfg, Qi, store, lock_basis=lock_buf, timer=timer
    )
    # descending by |λ| (the reference orders by algebraic value,
    # restarted.jl:93-94; |λ| keeps parity with the main solver's
    # largest-magnitude contract)
    w = np.asarray(w)
    V = np.asarray(V)
    bounds = np.asarray(bounds)
    order = np.argsort(-np.abs(w))
    return w[order], V[:, order], bounds[order]


def rbl_restarted(
    A: Any,
    k: int,
    cfg: Optional[RBLConfig] = None,
    b: int = 1,
    max_restarts: int = 200,
    timer=None,
    checkpoint_path: Optional[str] = None,
    state: Optional[RestartState] = None,
    which: str = "LM",
    v0: Optional[Any] = None,
    warm_V: Optional[Any] = None,
    poll_ahead: Optional[int] = None,
) -> LanczosResult:
    """Restarted + deflated RBL — reference `RBL_gpu_restarted(A, k)`
    (restarted.jl:97-146) with block size b (reference fixes b=1).

    ``which`` selects the spectrum end exactly as ``rbl`` does (the
    reference is LM-only): LA/SA run the sweep on the spectrally shifted
    operator A ± sI and map the locked values back.  Checkpointed
    ``RestartState.locked_values`` live in the SHIFTED (θ) space; resuming
    must pass the same ``which``.  ``v0`` seeds the first column of the
    initial sampling block (scipy convention).

    Pass ``checkpoint_path`` to persist the restart state each sweep, and/or
    ``state`` (e.g. from utils.checkpoint.load_restart_state) to resume.

    ``warm_V`` optionally supplies an (n, ≥1) block of approximate
    eigenvectors ordered as this solve locks (descending |λ| for LM) —
    e.g. from a converged low-precision solve (solver/polish.py).  The
    initial block and, after each productive restart, the next start block
    are seeded from the columns aligned with the not-yet-locked pairs
    instead of from randomness / the sweep's own Ritz vectors; a restart
    that locks nothing falls back to the sweep-Ritz seed (the f64 sweep's
    own refinement), which is the progress guarantee.  Eigenvectors are
    shift-invariant, so the same ``warm_V`` is valid for LA/SA (the
    ordering conventions of ``rbl``'s results match the shifted sweep's
    locking order).

    ``poll_ahead`` caps how many UNLOCKED pairs each sweep's convergence
    poll targets (the locking is prefix-only regardless).  The reference's
    all-or-nothing bound over every remaining pair (common.jl:56-65) makes
    a sweep run to its cap whenever the trailing pairs are slow — measured
    on a clustered top-50: 22 restarts locked only 16 pairs because each
    104-dim sweep chased all 34+ remaining bounds.  Polling just the next
    ~2b pairs lets a sweep break as soon as its seeded group converges.
    None keeps the reference semantics."""
    cfg = cfg or RBLConfig()
    cfg = cfg.replace(block_size=b)
    op = as_operator(A, dtype=cfg.compute_dtype)
    n = op.n
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    which = which.upper()
    if which not in ("LM", "LA", "SA"):
        raise ValueError(f"which={which!r} not in ('LM', 'LA', 'SA')")

    with jax.default_matmul_precision(cfg.matmul_precision):
        shift = 0.0
        if which != "LM":
            from ..ops.eig import spectral_norm_bound
            from ..ops.spmm.operator import AffineOperator

            shift = spectral_norm_bound(op, jax.random.PRNGKey(cfg.seed + 1))
            op = AffineOperator.shift(op, 1.0 if which == "LA" else -1.0,
                                      shift)
        # Opt-in probe-on-fault retry, as in rbl().  A restart-boundary
        # checkpoint_path makes the re-dispatch resume rather than restart.
        attempt = [0]

        def _dispatch():
            st = state
            # a RETRY attempt resumes from the failed attempt's own
            # restart-boundary checkpoint (never the first attempt — a
            # stale file from some earlier solve must not hijack it)
            if attempt[0] and checkpoint_path is not None and st is None:
                import os

                if os.path.exists(checkpoint_path):
                    from ..utils.checkpoint import load_restart_state

                    st = load_restart_state(checkpoint_path)
            attempt[0] += 1
            return _rbl_restarted_impl(
                op, k, cfg, b, max_restarts, timer, checkpoint_path, st, v0,
                warm_V=warm_V, poll_ahead=poll_ahead,
            )

        if cfg.fault_retries:
            from ..utils.probe import solve_with_retry

            res = solve_with_retry(_dispatch, retries=cfg.fault_retries)
        else:
            res = _dispatch()
        if which != "LM":
            # un-shift, then restore LanczosResult's documented order
            # (descending |λ| — lanczos.py LanczosResult docstring): the
            # sweep ordered by θ of the SHIFTED operator, which after
            # un-shifting is ascending algebraic for SA / descending
            # algebraic for LA, neither of which is descending |λ| when
            # mixed signs are present
            res.eigenvalues = (
                res.eigenvalues - shift if which == "LA"
                else shift - res.eigenvalues
            )
            order = np.argsort(-np.abs(res.eigenvalues), kind="stable")
            res.eigenvalues = res.eigenvalues[order]
            if res.eigenvectors is not None:
                res.eigenvectors = np.asarray(res.eigenvectors)[:, order]
            if getattr(res, "residual_bounds", None) is not None:
                res.residual_bounds = np.asarray(res.residual_bounds)[order]
        return res


def _warm_block(warm_V, start: int, b: int, n: int, cfg, sharding):
    """Start block from warm_V[:, start:start+b], random-padded to width b.

    The sweep entry deflates + re-orthonormalizes (see _restarted_sweep), so
    raw warm columns are fine here."""
    blk = jnp.asarray(warm_V)[:, start : start + b].astype(cfg.basis_dtype)
    if blk.shape[1] < b:
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 7919 + start)
        pad = jax.random.normal(key, (n, b - blk.shape[1]), dtype=blk.dtype)
        blk = jnp.concatenate([blk, pad], axis=1)
    if sharding is not None:
        blk = jax.device_put(blk, sharding)
    return blk


def _rbl_restarted_impl(op, k, cfg, b, max_restarts, timer,
                        checkpoint_path, state, v0=None, warm_V=None,
                        poll_ahead=None):
    n = op.n
    from .rbl import _row_sharding

    sharding = _row_sharding(cfg)
    lock_cols = max(k, 1)

    if state is None:
        if warm_V is not None:
            Qi = _warm_block(warm_V, 0, b, n, cfg, sharding)
        else:
            key = jax.random.PRNGKey(cfg.seed)
            Qi = random_start_block(op, key, b, cfg, sharding=sharding,
                                    v0=v0)
        lock_buf = jnp.zeros((n, lock_cols), dtype=cfg.basis_dtype)
        if sharding is not None:
            lock_buf = jax.device_put(lock_buf, sharding)
        state = RestartState(
            lock_buf=lock_buf,
            locked_values=np.zeros(k),
            count=0,
            kryl_dim=cfg.restart_kryl_dim,
            Qi=Qi,
        )

    while state.count < k and state.restarts < max_restarts:
        sweep_cfg = cfg.replace(restart_kryl_dim=state.kryl_dim)
        # Bucket the store capacity at the next power of two: capacity is
        # an operand shape of every fused chunk program, so successive
        # restarts (kryl_dim + restart_growth each round) would otherwise
        # each compile their own late-sweep chunks.  The sweep itself
        # still stops at kryl_dim; padding
        # columns stay zero (basis invariant).
        cap = state.kryl_dim + b
        bucket = 1 << (cap - 1).bit_length()
        if cfg.basis_device_cap_cols is not None:
            # the bucketed doubling must not overshoot the user's device
            # cap — the geometric growth could otherwise ~2x peak basis
            # HBM right at the OOM boundary the cap exists to protect
            bucket = max(cap, min(bucket, cfg.basis_device_cap_cols))
        store = BasisStore(
            n, b, max_cols=bucket,
            dtype=cfg.basis_dtype,
            init_cols=cfg.min_basis_cols, sharding=sharding,
            device_cap_cols=cfg.basis_device_cap_cols,
        )
        k_rem = max(k - state.count, 1)
        if poll_ahead is not None:
            k_rem = min(k_rem, max(int(poll_ahead), 1))
        w, V, bounds = _restarted_sweep(
            op, sweep_cfg, state.Qi, store, state.lock_buf, timer,
            k_rem=k_rem,
        )
        # Converged prefix: pairs are locked in order until the first
        # unconverged one (which seeds the restart) or k is reached.
        ncomp = 0
        while (
            state.count + ncomp < k
            and ncomp < len(w)
            and bounds[ncomp] < cfg.tol
        ):
            ncomp += 1
        if ncomp:
            # ONE batched basis GEMM for all newly locked pairs (per-pair
            # recovery costs ncomp full basis reads + ncomp dispatches,
            # each a host synchronisation).  The recovery width
            # is padded to the FIXED lock_cols so every restart reuses the
            # same compiled shape; zero columns recover to zero and are
            # normalized against 1.
            Vp = np.zeros((V.shape[0], lock_cols), dtype=np.asarray(V).dtype)
            Vp[:, :ncomp] = np.asarray(V)[:, :ncomp]
            QV = recover_eigvec(store, Vp)
            nrm = jnp.linalg.norm(QV, axis=0)
            QV = QV / jnp.where(nrm > 0, nrm, 1.0)
            # GHOST GATE: on extreme-dominance spectra at low precision,
            # deflation leaks (eps-level) re-amplify by |λ|max/|λ|min per
            # iteration and the sweep re-converges an ALREADY-LOCKED
            # direction with a small (lying) residual bound — locking it
            # displaces a true pair (measured: f32 step-decay with
            # |λ|max/sea = 2e6 locked a duplicate; final values off by
            # 54%).  A true new pair of a symmetric matrix is orthogonal
            # to the locked set, so reject candidates with significant
            # overlap; the truncated prefix seeds the restart instead.
            if state.count:
                ov = np.abs(
                    np.asarray(state.lock_buf[:, : state.count]).T
                    @ np.asarray(QV[:, :ncomp])
                )
                bad = np.nonzero(ov.max(axis=0) > 0.1)[0]
                if bad.size:
                    ncomp = int(bad[0])  # keep the clean prefix only
        if ncomp:
            for t in range(ncomp):
                state.lock_buf = _write_block(
                    state.lock_buf, QV[:, t : t + 1],
                    jnp.int32(state.count + t),
                )
            state.locked_values[state.count : state.count + ncomp] = w[:ncomp]
        next_start = None
        j = ncomp
        # warm-started polish (rbl_polished): after a PRODUCTIVE restart,
        # seed from the warm columns aligned with the next unlocked pairs —
        # the low-precision eigenvector of pair count+ncomp is a far better
        # start than a short sweep's trailing Ritz vector.  A restart that
        # locked nothing keeps the sweep-Ritz seed (the f64 refinement of
        # whatever the sweep was already chasing) so stalls still progress.
        warm_seed = (
            warm_V is not None
            and ncomp > 0
            and state.count + ncomp < k
            and np.asarray(warm_V).shape[1] > state.count + ncomp
        )
        if state.count + ncomp < k and j < len(w) and not warm_seed:
            # restart block: the first b unconverged Ritz vectors (the
            # reference takes one, b=1 — restarted.jl:131-133); fewer
            # than b available → pad with fresh randomness, which the
            # sweep entry deflates and re-orthonormalizes
            width = min(b, V.shape[1] - j)
            next_start = recover_eigvec(store, V[:, j : j + width])
        state.count += ncomp
        # compile-ladder cut (VERDICT r3 item 7): growth is the STALL
        # remedy — a productive restart reuses its compiled sweep shapes.
        # "stall" also grows after 2 consecutive LOW-yield (< b/2 locked)
        # restarts (ADVICE r4): a spectrum that locks one easy pair per
        # round would otherwise never grow and can plateau where the
        # reference's unconditional per-restart growth (restarted.jl:142)
        # escapes.  The deviation is recorded in PARITY.md.
        low = ncomp < max(1, b // 2)
        state.low_yield_streak = state.low_yield_streak + 1 if low else 0
        if (
            ncomp == 0
            or cfg.restart_growth_policy == "always"
            or state.low_yield_streak >= 2
        ):
            state.kryl_dim += cfg.restart_growth
            state.low_yield_streak = 0
        state.restarts += 1
        if warm_seed:
            state.Qi = _warm_block(warm_V, state.count, b, n, cfg, sharding)
        elif next_start is not None:
            blk = jnp.asarray(next_start)
            if blk.shape[1] < b:
                key = jax.random.fold_in(
                    jax.random.PRNGKey(cfg.seed), state.restarts
                )
                pad = jax.random.normal(
                    key, (n, b - blk.shape[1]), dtype=blk.dtype
                )
                blk = jnp.concatenate([blk, pad], axis=1)
            state.Qi = blk.astype(cfg.basis_dtype)
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_restart_state

            save_restart_state(checkpoint_path, state)

    converged = state.count >= k
    # order descending by |λ|
    order = np.argsort(-np.abs(state.locked_values[: state.count]))
    D = state.locked_values[: state.count][order]
    V_cols = np.asarray(state.lock_buf[:, : state.count])[:, order]
    return LanczosResult(
        eigenvalues=D,
        eigenvectors=jnp.asarray(V_cols),
        iterations=state.restarts,
        kryl_dim=state.kryl_dim,
        converged=converged,
    )


def RBL_restarted(A, k: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (restarted.jl:196): returns (D, V)."""
    res = rbl_restarted(A, k, cfg=cfg)
    return res.eigenvalues, res.eigenvectors


def RBL_gpu_restarted(A, k: int, cfg: Optional[RBLConfig] = None):
    """Reference-shaped alias (restarted.jl:97): the GPU/CPU restarted twins
    collapse into one device-agnostic solve here, so this is `RBL_restarted`
    under the reference's GPU entry name — kept so reference call sites
    migrate verbatim.  UNLIKE the reference (which returns V=zeros,
    restarted.jl:99-100,145), V holds the locked eigenvectors."""
    return RBL_restarted(A, k, cfg=cfg)
