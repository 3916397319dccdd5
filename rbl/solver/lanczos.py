"""Randomized block Lanczos iteration driver — the solver's core.

One device-agnostic driver replaces the reference's three near-duplicate
loops (CPU lanczos_iteration RBL.jl:74-117, GPU lanczos_iteration
RBL_gpu.jl:134-203, legacy.jl): the hot path is a small set of jitted,
static-shaped step functions (SpMM + three-term recurrence + tall-skinny QR;
fused partial reorth; CGS2 local reorth), driven by a host loop that owns
only the tiny replicated state — the banded T, convergence polling, and
iteration cadences (partial reorth every 2nd iteration RBL.jl:93, eig poll
every 4th RBL.jl:106).  The n-sized state never leaves the device(s); only
b×b blocks (A_i, B_i) cross to the host, exactly as the reference ships only
T's blocks across the PCIe boundary (RBL_gpu.jl:159-161,185).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import RBLConfig
from ..ops.band import BlockTridiagonalT
from ..ops.eig import (
    eig_banded_host,
    eig_banded_values_topk,
    sort_eig_abs,
)
from ..ops.qr import block_qr
from ..ops.spmm.operator import LinearOperator, _pet
from ..backend import donate
from .basis import BasisStore


import os

# Observability: RBL_DEBUG=1 prints solver state transitions (danger /
# selective mode, breakdowns, rewinds) with iteration numbers — the
# structured upgrade of the reference's bare printlns (RBL.jl:115).
_DEBUG = bool(int(os.environ.get("RBL_DEBUG", "0")))


def _dbg(msg):
    if _DEBUG:
        print(f"[rbl] {msg}", flush=True)


class SweepAborted(RuntimeError):
    """Raised by the deterministic preemption injector
    (``RBLConfig.fault_inject_abort_after_chunks``) — simulates losing the
    process mid-sweep so the checkpoint/resume path can be tested without
    actually killing anything."""


# Worker for host-side eig factorizations, overlapped with device sweeps
# (LAPACK releases the GIL).  One thread: at most one poll is in flight.
_EIG_EXECUTOR = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="rbl-eig"
)


def _poll_task(snapshot, k, backend, chain, tol, force_full):
    """One convergence poll, run on the eig worker thread: a values-only
    screen (dsbevd eigenvalues path) gates the full factorization — the
    residual bounds need eigenvectors, but they cannot pass while the top-k
    Ritz values are still moving by more than tol·|λ|max between polls.

    ``chain`` carries the previous poll's screen between tasks ON the
    worker thread (single worker → sequential), so the screen-to-screen
    comparisons feeding both the stability gate and the solver's selective
    trigger are deterministic — harvesting them on the main thread made
    the comparison pairs depend on wall-clock harvest timing.
    Returns (screen, previous poll's screen, (w, V) or None)."""
    w_prev = chain.get("w")

    def factorize():
        if backend == "scipy":
            # top-k-only factorization (values sweep + MRRR subset): ~2.3×
            # cheaper than the full dsbevd at the solver's k/m ratios
            from ..ops.eig import eig_banded_topk_dense

            return eig_banded_topk_dense(snapshot, k)
        return eig_banded_host(snapshot, backend=backend)

    if force_full:
        # the factorization runs regardless — its eigenvalues subsume the
        # O(m²b) values-only screen, so skip it (the final forced poll
        # sits on the critical path: nothing is left to overlap it with)
        full = factorize()
        w_all = full[0]
        idx = np.argsort(np.abs(w_all))[-min(k, len(w_all)):]
        chain["w"] = w_all[idx]
        return w_all[idx], w_prev, full
    w_scr = eig_banded_values_topk(snapshot, k)
    stable = (
        w_prev is not None
        and len(w_prev) == len(w_scr)
        and np.max(np.abs(w_scr - w_prev))
        <= tol * max(np.abs(w_scr).max(), np.finfo(np.float64).tiny)
    )
    full = None
    if stable:
        full = factorize()
    chain["w"] = w_scr
    return w_scr, w_prev, full


# --- poll schedule arithmetic -------------------------------------------
# Pure functions, pinned by tests/test_ops.py::test_poll_schedule_* —
# the schedule is load-bearing for both perf (the O(m²b) values screen at
# large m) and the selective trigger's screen-to-screen chain (VERDICT r4
# weak #6): a silent regression here shows up only as a 2× slowdown or a
# missed convergence window, so the arithmetic is factored out where a
# scripted-trace unit test can flip on it.


def poll_stride_cols(j: int, b: int, cadence: int, fine_poll: bool) -> int:
    """Columns from panel ``j``'s poll to the next one: the base cadence
    once ``fine_poll`` is set, else the geometric ~m/4 backoff (never
    below the base cadence)."""
    return cadence * b if fine_poll else max(cadence * b, (j * b) // 4)


def poll_panel_for(next_poll_cols: int, i: int, b: int, k: int) -> int:
    """The panel to poll when ``next_poll_cols`` columns are due by panel
    ``i``: never beyond ``i``, never before the first panel whose T can
    hold k Ritz pairs."""
    return min(i, max((next_poll_cols + b - 1) // b, k // b + 1))


def fine_poll_reset_cols(next_poll_cols: int, i_poll: int, b: int,
                         cadence: int) -> int:
    """On the fine-poll flip (≥ 25% of pairs at the bound) the schedule
    is pulled back to base cadence from the flipping poll's panel —
    convergence lives in a window, and the geometric stride can step
    clean over it."""
    return min(next_poll_cols, i_poll * b + cadence * b)


@dataclasses.dataclass
class LanczosResult:
    eigenvalues: np.ndarray          # (k,), descending by |λ|
    eigenvectors: Optional[jax.Array]  # (n, k) or None
    iterations: int                  # number of Lanczos blocks generated
    kryl_dim: int                    # final Krylov dimension used
    converged: bool
    residual_bounds: Optional[np.ndarray] = None  # (k,), matching order


# ----------------------------------------------------------------------------
# jitted step functions (static-shaped; cached across iterations)
# ----------------------------------------------------------------------------

def first_step_fn(op: LinearOperator, Qb, cdt, qr_method):
    """Unrolled first iteration (reference RBL.jl:79-89)."""
    from ..ops.contract import gram

    Qc = Qb.astype(cdt)
    U = op.apply(Qc)
    Ai = gram(Qc, U)
    U = U - jnp.dot(Qc, Ai, preferred_element_type=_pet(cdt))
    Qn, Bn = block_qr(U, method=qr_method)
    return Qn.astype(Qb.dtype), Bn, Ai


def recurrence_step_fn(op: LinearOperator, Qi_b, Qprev_b, Bi, cdt, qr_method):
    """Three-term block recurrence (reference RBL.jl:97-104):
    U = A·Q_i − Q_{i−1}·B_iᵀ;  A_i = Q_iᵀU;  U −= Q_i·A_i;  Q_{i+1}B_{i+1} = qr(U).
    Promotes the basis-precision blocks to compute precision on entry — the
    mixed-precision seam of RBL_gpu.jl:142-143,173-175."""
    from ..ops.contract import gram

    acc = _pet(cdt)
    Qc = Qi_b.astype(cdt)
    Qp = Qprev_b.astype(cdt)
    U = op.apply(Qc) - jnp.dot(Qp, Bi.T, preferred_element_type=acc)
    Ai = gram(Qc, U)
    U = U - jnp.dot(Qc, Ai, preferred_element_type=acc)
    Qn, Bn = block_qr(U, method=qr_method)
    return Qn.astype(Qi_b.dtype), Bn, Ai


_first_step = jax.jit(first_step_fn, static_argnames=("cdt", "qr_method"))


@partial(
    jax.jit,
    static_argnames=(
        "cdt", "qr_method", "nsteps", "reorth_pattern",
        "loc_passes", "reorth_passes",
    ),
    donate_argnums=donate(1),
)
def _sweep_chunk(
    op: LinearOperator,
    basis_buf,
    Qi,
    Qprev,
    Bi,
    col0,
    lock_basis,
    *,
    cdt,
    qr_method,
    nsteps,
    reorth_pattern,
    loc_passes,
    reorth_passes=1,
):
    """``nsteps`` Lanczos iterations fused into ONE dispatch.

    The reference's GPU loop syncs to the host every iteration to grow T
    (RBL_gpu.jl:159-161,185), a synchronising transfer per step.  Fusing
    the sweep between eigenvalue polls means the n-sized state (including
    the donated basis
    buffer, updated in place) never leaves the device, and the b×b T blocks
    of all nsteps iterations come back in a single stacked transfer.

    reorth_pattern: static booleans per step (the iteration cadence i % 2,
    resolved at trace time).
    Returns (basis_buf, Qi, Qprev, Bi, TB) with TB = (2·nsteps, b, b):
    TB[2s] = A_i, TB[2s+1] = B_{i+1} of step s.

    Reorthogonalization applies to the RESIDUAL U at birth, never to
    already-created blocks.  The reference scrubs Q_j/Q_{j-1} between
    recording their T contributions and using them (RBL.jl:93-104) — that
    retroactive modification makes T inconsistent with the stored basis by
    O(‖scrub delta‖·‖A‖), which is catastrophic exactly when a large scrub
    is needed (measured: a dominant −5000 eigenvalue atop a 1..399 bulk
    left T's band wrong by O(200) at the reorth-policy switch while the
    basis itself was orthonormal to 1e-15).  Scrubbing U before its QR
    gives B_{j+1} of the *scrubbed* residual and leaves every recorded
    block untouched: T ≡ QᵀAQ up to rounding, by construction."""
    from ..ops.contract import gram
    from ..ops.reorth import deflate, project_out

    b = Qi.shape[1]
    acc = _pet(cdt)
    out = []
    for s in range(nsteps):
        # archive Q_{j-1} first: blocks are final at creation, and having
        # it in the buffer lets the residual projection below cover it in
        # the same fused contraction
        basis_buf = jax.lax.dynamic_update_slice(
            basis_buf,
            Qprev.astype(basis_buf.dtype),
            (jnp.int32(0), col0 + jnp.int32(s * b)),
        )
        Qc = Qi.astype(cdt)
        Qp = Qprev.astype(cdt)
        U = op.apply(Qc) - jnp.dot(Qp, Bi.T, preferred_element_type=acc)
        Ai = gram(Qc, U)
        U = U - jnp.dot(Qc, Ai, preferred_element_type=acc)
        if reorth_pattern[s]:
            # full scrub: project against the whole stored basis (which now
            # includes Q_{j-1}) and the not-yet-stored Q_j
            for _ in range(max(reorth_passes, 1)):
                U = project_out(basis_buf, U)
                U = project_out(Qc, U)
        else:
            # local scrub (reference loc_reorth!'s role): newborn residual
            # orthogonal to its two parents
            for _ in range(loc_passes):
                U = project_out(Qp, U)
                U = project_out(Qc, U)
        if lock_basis is not None:
            # deflate the newborn residual EVERY step: locked directions
            # re-enter U through A (their |λ| exceeds the active window's,
            # so leaked content grows every iteration, and a block born
            # between cadence deflations freezes that content into the
            # basis).  The reference deflates live blocks every 3rd step
            # (restarted.jl:53-57) to save GEMMs; against the ≤ k-column
            # lock set the projection is a small GEMM.
            U = deflate(lock_basis, U)
        Qnext, Bnext = block_qr(U, method=qr_method)
        out.append(Ai)
        out.append(Bnext)
        Qprev, Qi, Bi = Qi, Qnext.astype(Qi.dtype), Bnext
    TB = jnp.stack(out)
    return basis_buf, Qi, Qprev, Bi, TB


@partial(jax.jit, static_argnames=("cdt",), donate_argnums=donate(1))
def _split_step_recur(op: LinearOperator, basis_buf, Qi, Qprev, Bi, col0, *, cdt):
    """Archive Qprev and run ONE three-term-recurrence step, halted at the
    raw residual U (before any reorthogonalization or QR).

    Used when the host-offload tier is active: the offloaded panels must
    project the NEWBORN residual, never the live pair (Qi, Qprev) whose T
    couplings (A_{i-1}, B_i) are already recorded — retroactively scrubbing
    recorded blocks makes T ≠ QᵀAQ by O(‖leak‖·‖A‖) (the reference's
    hybrid_part_reorth! does exactly that, RBL_gpu.jl:59-81; measured
    ~1e-7 eigenvalue error at the device cap before this split-step
    design).  The caller streams each host panel through a projection of U
    (one async dispatch per panel, H→D DMA from pinned host memory — no
    host round-trip), finishes the step with _split_step_qr, and fuses the
    window's remaining steps via the normal _sweep_chunk."""
    from ..ops.contract import gram

    acc = _pet(cdt)
    basis_buf = jax.lax.dynamic_update_slice(
        basis_buf, Qprev.astype(basis_buf.dtype), (jnp.int32(0), col0)
    )
    Qc = Qi.astype(cdt)
    U = op.apply(Qc) - jnp.dot(
        Qprev.astype(cdt), Bi.T, preferred_element_type=acc
    )
    Ai = gram(Qc, U)
    U = U - jnp.dot(Qc, Ai, preferred_element_type=acc)
    return basis_buf, U, Ai


@jax.jit
def _project_out_jit(basis, W):
    from ..ops.reorth import project_out

    return project_out(basis, W)


@partial(jax.jit, static_argnames=("qr_method", "bdt"))
def _split_step_qr(U, lock_basis, *, qr_method, bdt):
    """Finish a split step: deflate the (now host-tier-clean) residual
    against the lock set and orthonormalize it."""
    from ..ops.reorth import deflate

    if lock_basis is not None:
        U = deflate(lock_basis, U)
    Qn, Bn = block_qr(U, method=qr_method)
    return Qn.astype(bdt), Bn


@partial(jax.jit, donate_argnums=donate(0) or None)
def _zero_cols_range(buf, lo, hi):
    """Zero basis columns [lo, hi) — breakdown / speculation rewind.
    Mask-multiply instead of dynamic_update_slice so the (rare) rewind
    widths don't each trigger a fresh compile."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, buf.shape[1]), 1)
    keep = (cols < lo) | (cols >= hi)
    return buf * keep.astype(buf.dtype)


@partial(jax.jit, static_argnames=("qr_method",))
def _block_qr_jit(W, qr_method):
    return block_qr(W, method=qr_method)


def _fresh_directions(store, extras, lock_basis, key, shape, dtype, qr_method):
    """Breakdown recovery: fresh random directions orthogonalized (CGS2 +
    QR) against the WHOLE stored state — device tier, host-offloaded
    panels, lock set, and the given live ``extras`` blocks.  The reference
    has no breakdown handling (SURVEY §5) — after an invariant subspace
    converges, its QR renormalizes noise and re-injects converged
    directions ("ghost" Ritz values), which can stall the all-or-nothing
    convergence test.  Re-randomizing keeps the basis orthonormal and the
    sweep productive.

    The host tier and lock set must be included: a random block has
    ~√(cols/n) expected overlap with any stored span, and a leak frozen in
    here re-amplifies every subsequent step (locked |λ| exceed the active
    window's — CLAUDE.md lock-leak invariant).  Breakdowns are rare, so
    the per-pass H→D panel streaming cost is irrelevant.

    ``extras`` must contain ONLY kept state (Q_i = the new Qprev).
    Projecting against the dead chunk-end block as well reinjects whatever
    polluted it: at breakdown that block IS renormalized rounding noise
    with an O(1) converged-direction component, and one such block in the
    basis makes the CGS projector non-contractive (duplicate directions →
    overshoot → geometric ‖B‖ runaway; measured on an f32 image Gram)."""
    Z = jax.random.normal(key, shape, dtype=dtype)
    for _ in range(2):
        Z = _project_out_jit(store.view(), Z)
        for panel in store.host_tier():
            Z = _project_out_jit(
                jax.device_put(panel, store.buf.sharding), Z
            )
        if lock_basis is not None:
            Z = _project_out_jit(lock_basis, Z)
        for blk in extras:
            Z = _project_out_jit(blk, Z)
        Z, _ = _block_qr_jit(Z, qr_method)
    return Z


def _split_coupling(B_s: np.ndarray, r0: int):
    """Host-side factorization for a partial-breakdown repair: split the
    rank-deficient coupling block B_s = P·Σ·Wᵀ into a rotation Pf for the
    device block and an UPPER-TRIANGULAR honest coupling B_new (zero rows
    past r0), such that Q_old·B_s = (Q_old·Pf)[:, :r0]·B_new[:r0] up to the
    discarded O(σ_dead) part.  Triangularity matters: T's band layout
    records only B's upper triangle (insertB! semantics, common.jl:20-26),
    so a Σ·Wᵀ coupling would silently lose its lower part — instead the QR
    rotation g of the honest rows is folded into Pf."""
    P_, sv_, Wt_ = np.linalg.svd(B_s.astype(np.float64))
    M = sv_[:r0, None] * Wt_[:r0]           # (r0, b) honest coupling
    g, r = np.linalg.qr(M)                  # g: (r0, r0), r: (r0, b) upper
    Pf = P_.copy()
    Pf[:, :r0] = P_[:, :r0] @ g
    B_new = np.zeros_like(B_s)
    B_new[:r0] = r.astype(B_s.dtype)
    return Pf, B_new


@partial(jax.jit, static_argnames=("r0",))
def _rotate_healthy(Qold, P, *, r0):
    """The healthy part of a partially-collapsed block: (Q_old·P)[:, :r0]."""
    Qrot = jnp.dot(
        Qold, P.astype(Qold.dtype), preferred_element_type=_pet(Qold.dtype)
    )
    return Qrot[:, :r0]


def _repair_partial_block(store, Qprev, Qold, P, lock_basis, key, *, r0, qr_method):
    """Partial-breakdown repair: the residual U = Q_old·B lost rank —
    σ_{r0+1..b}(B) sit at the breakdown floor while σ_{1..r0} are healthy.
    QR of a rank-deficient residual orthonormalizes ROUNDING NOISE into the
    dead columns; that noise is dominated by converged-direction
    components, so the dead columns are ghost seeds: the next application
    of A re-amplifies them to O(‖A‖), T picks up duplicate eigenvalues,
    and the basis loses orthogonality at O(1) (measured: a rank-5 Gram
    operator with k=8 returned eigenvalues wrong by 2×).  The max-entry
    collapse test cannot see this — ‖B‖ stays O(‖A‖).

    Repair: rotate Q_old by B's left singular basis P so the honest
    residual directions U·W_r/σ_r = (Q_old·P)[:, :r0] land in the first r0
    columns — exactly preserved, keeping T ≡ QᵀAQ — and replace the dead
    columns with fresh randomness orthogonalized against everything —
    device tier, host panels, lock set, live blocks (CGS2 + QR via
    _fresh_directions).  The honest coupling is Σ_r·W_rᵀ with zero rows
    for the repaired columns (an exact deflation split, assembled
    host-side by the caller)."""
    H = _rotate_healthy(Qold, P, r0=r0)
    Z = _fresh_directions(
        store, (Qprev, H), lock_basis, key,
        (Qold.shape[0], Qold.shape[1] - r0), Qold.dtype, qr_method,
    )
    return jnp.concatenate([H, Z], axis=1)


def _repair_block(store, Qprev, Qold, B_s, rank, lock_basis, key, qr_method):
    """Dispatch a rank-``rank`` coupling-block repair: rank ≥ 1 keeps the
    healthy singular directions (_repair_partial_block); rank == 0 — every
    σ at the rounding floor while ‖B‖ passed the max-entry test (reachable
    when the ACTIVE scale sits far below tscale) — degenerates to full
    re-randomization with a zero coupling, exactly the total-collapse
    treatment.  Returns (Q_new, B_new host array)."""
    if rank == 0:
        Qnew = _fresh_directions(
            store, (Qprev,), lock_basis, key,
            Qprev.shape, Qprev.dtype, qr_method,
        )
        return Qnew, np.zeros_like(B_s)
    Pf, B_new = _split_coupling(B_s, rank)
    Qnew = _repair_partial_block(
        store, Qprev, Qold, jnp.asarray(Pf), lock_basis, key,
        r0=rank, qr_method=qr_method,
    )
    return Qnew, B_new


@partial(jax.jit, static_argnames=("cdt",))
def _rayleigh_refine(op: LinearOperator, X, theta0, cdt):
    """Shifted Rayleigh-quotient refinement of converged Ritz values:
    θ = θ₀ + xᵀ(Ax − θ₀x)/xᵀx.  The correction contracts residual-scale
    quantities, so the refined value carries O(eps·|θ|) rounding instead of
    the O(n·eps·‖A‖) accumulated through T's assembly — recovering the
    reference's strict 1e-13 eigenvalue gate at n = 10⁵⁻⁶.

    Also returns the TRUE relative residual norms ‖A·x − θx‖/‖x‖ of the
    refined pairs — A·X is already in hand, so this is free, and unlike
    the Lanczos bound ‖B·y‖ it stays honest when the basis degraded (e.g.
    precision exhaustion on extreme-dominance spectra)."""
    from ..ops.contract import gram

    Xc = X.astype(cdt)
    Y = op.apply(Xc) - Xc * theta0[None, :]
    num = jnp.diagonal(gram(Xc, Y))
    den = jnp.diagonal(gram(Xc, Xc))
    theta = theta0 + num / den
    R = Y - Xc * (theta - theta0)[None, :]
    res = jnp.sqrt(jnp.sum(R * R, axis=0) / den)
    return theta, res


@jax.jit
def _recover(basis_buf, Vk_padded, cdt_scale=None):
    """Ritz-vector recovery V = Q_basis · Ṽ as one GEMM (reference
    accumulates per-block GEMMs: RBL.jl:61-71, RBL_gpu.jl:106-132)."""
    return jnp.dot(
        basis_buf, Vk_padded.astype(basis_buf.dtype),
        preferred_element_type=_pet(basis_buf.dtype),
    )


def recover_eigvec(store: BasisStore, Vk: np.ndarray) -> jax.Array:
    """Recover k Ritz vectors from the basis store; Vk has store.ncols rows.
    Host-tier panels (columns [0, dev_base)) and the device tier (columns
    [dev_base, ncols)) contribute contiguous GEMMs — the reference's
    panelled GPU recovery + CPU overflow accumulation (RBL_gpu.jl:106-132)
    with no per-block loop."""
    Vk = np.asarray(Vk)
    out = None
    if store.host_ncols:
        off = 0
        for panel in store.host_tier():
            w = panel.shape[1]
            part = _recover(
                jax.device_put(panel, store.buf.sharding),
                jnp.asarray(Vk[off : off + w]),
            )
            out = part if out is None else out + part
            off += w
    dev_rows = Vk.shape[0] - store.dev_base
    Vk_p = np.zeros((store.capacity, Vk.shape[1]), dtype=Vk.dtype)
    Vk_p[:dev_rows] = Vk[store.dev_base :]
    dev_part = _recover(store.view(), jnp.asarray(Vk_p))
    return dev_part if out is None else out + dev_part


@partial(
    jax.jit, static_argnames=("b", "cdt", "bdt", "qr_method", "sharding", "raw"),
)
def _start_block(op: LinearOperator, key, b, cdt, bdt, qr_method, sharding,
                 v0=None, raw=False):
    Omega = jax.random.normal(key, (op.n, b), dtype=cdt)
    if v0 is not None:
        # user-supplied starting direction (scipy eigsh's v0): it seeds the
        # first column of Ω; the remaining b−1 columns stay random
        Omega = Omega.at[:, 0].set(v0.astype(cdt))
    if sharding is not None:
        Omega = jax.lax.with_sharding_constraint(Omega, sharding)
    Y = Omega if raw else op.apply(Omega)
    Q1, _ = block_qr(Y, method=qr_method)
    return Q1.astype(bdt)


def random_start_block(op: LinearOperator, key, b: int, cfg: RBLConfig,
                       sharding=None, v0=None, raw: bool = False):
    """Randomized start: Q₁ = qr(A·Ω).Q with Ω ~ N(0,1)ⁿˣᵇ (reference
    RBL.jl:136-137 — note the single power-iteration step A·Ω).  One jitted
    dispatch: run eagerly, each op would be a separate dispatch.
    ``v0`` optionally seeds Ω's first column (scipy-compat surface).
    ``raw=True`` skips the A-multiply (Q₁ = qr(Ω).Q): needed when the
    sweep's T feeds stochastic Lanczos quadrature (solver/filtered.py) —
    the A·Ω start weights the probe's spectral measure by ~λ² and biases
    the counting estimate."""
    return _start_block(
        op, key, b=b, cdt=jnp.dtype(cfg.compute_dtype),
        bdt=jnp.dtype(cfg.basis_dtype),
        qr_method=cfg.resolved_qr_method(), sharding=sharding, v0=v0,
        raw=raw,
    )


def lanczos_iteration(
    op: LinearOperator,
    k: int,
    cfg: RBLConfig,
    Qi,
    store: BasisStore,
    lock_basis=None,
    timer=None,
    key=None,
    resume: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray, "BlockTridiagonalT", Optional[np.ndarray], bool, int]:
    """Run the block Lanczos sweep until convergence or the Krylov cap.

    Returns (w_sel ascending-|λ|, V_sel, T, residual_bounds, converged, nblocks)
    where V_sel has nblocks*b rows and k columns.  ``store`` holds all
    nblocks basis blocks on return.

    ``resume``: a ``utils.checkpoint.load_sweep_state`` dict — restores the
    between-chunks invariant (basis prefix in ``store``, which must come in
    EMPTY; recurrence triple; T band; flags) and continues the sweep from
    the saved iteration instead of running the randomized first step.
    """
    from ..utils.profiling import null_timer

    timer = timer or null_timer()
    b = cfg.block_size
    n = op.n
    cdt = jnp.dtype(cfg.compute_dtype)
    qr_method = cfg.resolved_qr_method()
    eig_bk = {"native": "native", "device": "device"}.get(cfg.eig_backend, "scipy")
    max_kryl = min(cfg.max_kryl_dim, ((n + b - 1) // b) * b)

    T = BlockTridiagonalT(b, max_cols=max_kryl + b)
    if key is None:
        key = jax.random.PRNGKey(cfg.seed + 1)
    eps = float(jnp.finfo(cdt).eps)

    if resume is not None:
        if int(resume["n"]) != n or int(resume["b"]) != b:
            raise ValueError(
                f"checkpoint shape mismatch: saved (n={resume['n']}, "
                f"b={resume['b']}) vs current (n={n}, b={b})"
            )
        if int(resume["T_ncols"]) > T.band.shape[1]:
            raise ValueError(
                f"checkpoint Krylov prefix {resume['T_ncols']} exceeds the "
                f"current cap {max_kryl} — raise max_kryl_dim"
            )
        AB0 = None
    else:
        # --- first iteration, unrolled ---
        with timer.section("recurrence"):
            Qnext, Bnext, Ai = _first_step(op, Qi, cdt=cdt, qr_method=qr_method)
        AB0 = np.asarray(jnp.stack([Ai, Bnext.astype(Ai.dtype)]))  # one transfer
        T.append_diag(AB0[0])
        T.set_subdiag(AB0[1], 0)
        tscale = np.abs(AB0[0]).max()
        B_last = AB0[1]  # host copy of the newest B (degenerate-cap fallback)
        Qprev, Qi, Bi = Qi, Qnext, Bnext

    # --- chunked, speculatively pipelined sweep ---
    # The reference copies each iteration's b×b blocks to the host
    # (RBL_gpu.jl:159-161,185), a synchronising transfer per step.  Here:
    # (a) one fused dispatch per eig-poll window, returning all of its T
    # blocks in a single stacked transfer; (b) up to cfg.pipeline_depth later chunks
    # are dispatched before the current chunk's results are read back, so
    # the device sweeps windows c+1.. while the host factorizes T for
    # window c and the blocking TB read pays only the RPC latency; (c)
    # chunk lengths grow geometrically (chunk_growth_cap) so late-sweep
    # round-trips amortize.  Speculation only wastes work on the final
    # windows (convergence) or on breakdown — both rare, both handled by
    # zeroing the speculated basis columns.
    w_sel = V_sel = bounds = None
    poll_chain = {}    # previous screen, threaded through the eig worker
    converged = False
    i_max = max_kryl // b
    pr = cfg.partial_reorth_cadence
    if resume is None:
        next_poll_cols = 0  # geometric poll backoff (see the poll block)
        fine_poll = False  # near convergence: pin polls to the base cadence
        danger = False     # near-invariant-subspace reorth escalation
        selective = False  # sticky: dominant Ritz pair converged on a
        #                    spectrum with compounding dominance — harvest()
        calm_chunks = 0    # consecutive chunks clear of the danger regime
        B_hist = {1: AB0[1]}  # B_{j+1} produced at iteration j, host copies
        #                       (poll prefixes need the coupling block at any
        #                       panel, not just this chunk's — 25 KB at cap)
        i = 1              # Lanczos iterations completed (host view)
        i_next = 2         # first iteration of the next chunk to dispatch
        dev = (Qi, Qprev, Bi)  # device-side recurrence state (dispatch order)
        pr_stretch = 1  # adaptive full-scrub stretch (adaptive_reorth_max)
    else:
        # --- restore the between-chunks invariant from a checkpoint ---
        # (stored basis = Q_1..Q_{i-1} goes into the empty store; the
        # recurrence triple is (Q_{i+1}, Q_i, B_{i+1}); T's band already
        # includes the edge subdiag written at the end of the saved chunk)
        bdt = store.buf.dtype
        store.load_snapshot(resume["basis"])
        tc = int(resume["T_ncols"])
        T.band[:, :tc] = resume["band"][:, :tc]
        T.ncols = tc
        tscale = float(resume["tscale"])
        B_last = np.asarray(resume["B_last"], dtype=np.float64)
        B_hist = {
            int(j): np.asarray(v, dtype=np.float64)
            for j, v in resume["B_hist"].items()
        }
        i = int(resume["i"])
        i_next = i + 1
        next_poll_cols = int(resume["next_poll_cols"])
        fine_poll = bool(resume["fine_poll"])
        danger = bool(resume["danger"])
        selective = bool(resume["selective"])
        calm_chunks = int(resume["calm_chunks"])
        pr_stretch = int(resume["pr_stretch"])

        def _dev_arr(x, dt):
            a = jnp.asarray(np.asarray(x), dtype=dt)
            if store.sharding is not None and a.ndim == 2 and a.shape[0] == n:
                a = jax.device_put(a, store.sharding)
            return a

        Qprev = _dev_arr(resume["Q_i"], bdt)
        dev = (
            _dev_arr(resume["Q_ip1"], bdt),
            Qprev,
            jnp.asarray(np.asarray(resume["B_ip1"]), dtype=cdt),
        )
        key = jnp.asarray(
            np.asarray(resume["key"], dtype=np.uint32)
        )
        _dbg(f"resumed sweep at i={i} ({(i - 1) * b} basis columns)")

    # Rank check of the FIRST coupling block (the chunk scan below covers
    # later steps): a start block wider than the reachable subspace — e.g.
    # rank(A) < b, or an unlucky Ω — makes U₁ rank-deficient, and its QR
    # seeds ghost columns into Q₂ before the first chunk even launches.
    # The discard threshold is the ROUNDING floor (~eps·‖A‖, the scale of
    # noise A injects per application), NOT the scan's √eps·‖A‖ breakdown
    # level: a restarted sweep starts from a near-converged Ritz vector
    # whose honest B₁ ≈ its residual — small, but real; discarding it
    # freezes the locked value at its current error (measured 2e-5 on the
    # moderate-decay restart suite).  Between the two levels the coupling
    # is honest but ghost-prone — danger-mode reorth, no discard.
    if AB0 is not None:  # first-step path only (a resume skips iteration 1)
        if not np.all(np.isfinite(AB0)):
            # same numerical-health diagnostic the chunk loop raises —
            # without this, the SVD below would fail first with an unhelpful
            # "SVD did not converge" on non-finite step-1 output
            raise FloatingPointError(
                "non-finite T blocks at iteration 1 — operator output or "
                "precision configuration is unstable "
                f"(basis_dtype={cfg.basis_dtype}, compute_dtype={cfg.compute_dtype})"
            )
        sv0 = np.linalg.svd(AB0[1], compute_uv=False)
        thr0 = 100.0 * eps * max(tscale, np.finfo(np.float64).tiny)
        if thr0 <= sv0[-1] < np.sqrt(eps) * tscale:
            danger = True
        if sv0[-1] < thr0:
            r0 = int(np.sum(sv0 >= thr0))  # may be 0: all σ at the floor
            key, sub = jax.random.split(key)
            with timer.section("rerandomize"):
                Q2, B_new0 = _repair_block(
                    store, Qprev, Qi, AB0[1], r0, lock_basis, sub, qr_method
                )
            _dbg(f"partial breakdown at i=1: rank {r0}/{b} — repaired")
            T.set_subdiag(B_new0, 0)
            B_last = B_new0
            B_hist[1] = B_new0
            dev = (Q2, Qprev, jnp.asarray(B_new0))
            danger = True  # at an invariant subspace: every-step CGS2

    # chunks dispatched so far (drives geometric chunk growth)
    n_chunks = int(resume["n_chunks"]) if resume is not None else 0
    chunks_done = int(resume["chunks_done"]) if resume is not None else 0
    # checkpoint-policy plumbing: see RBLConfig.sweep_checkpoint_path
    ck_path = cfg.sweep_checkpoint_path
    ck_every = cfg.sweep_checkpoint_every
    abort_after = cfg.fault_inject_abort_after_chunks
    growth_cap = cfg.chunk_growth_cap

    def dispatch():
        """Launch one chunk against the current device state (async)."""
        nonlocal dev, i_next, n_chunks
        i0 = i_next
        # Geometric chunk growth, mirroring the geometric poll backoff:
        # chunks double every second eligible dispatch up to
        # chunk_growth_cap× the poll cadence — late in the sweep polls are
        # sparse, and each chunk boundary costs a device→host
        # synchronisation.  Growth requires a *calm*
        # spectrum (≥ 2 consecutive chunks with healthy ‖B‖): near the
        # danger regime, policy flips discard every in-flight chunk, so a
        # grown speculated chunk is expensive wasted work (measured 2.3×
        # on the large-gap step_decay suite).  Danger mode and the
        # deflating sweep pin the base size (their reorth/deflate patterns
        # recompile per length, and breakdown monitoring wants fine
        # granularity).
        # selective mode is sticky, so its chunks are never discarded by a
        # policy flip — growth and deep pipelining stay on (unlike danger)
        if (
            growth_cap > 1
            and not danger
            and calm_chunks >= 2
            and lock_basis is None
        ):
            grow = min(growth_cap, 2 << (n_chunks // 2))
            n_chunks += 1
        else:
            grow = 1
        S = min(cfg.eig_poll_cadence * grow, i_max - i0 + 1)
        if cfg.basis_device_cap_cols is not None:
            # the two-tier store needs ≥ 2·window + 2b device-resident
            # columns per append window (BasisStore._ensure feasibility)
            S = max(1, min(S, (cfg.basis_device_cap_cols // b - 2) // 2))
        # danger mode: ‖B‖ has collapsed toward an invariant subspace, where
        # ghost components of converged directions re-amplify by ~‖A‖/‖B‖
        # per iteration — reorthogonalize EVERY step with CGS2 against the
        # basis until ‖B‖ recovers (the reference's fixed cadence-2 single
        # pass loses the basis to ghosts on large-gap spectra: measured
        # ‖QᵀQ−I‖ → 1 within 15 iterations on a rank-40-dominant Gram)
        if danger or selective:
            reorth_pattern = (True,) * S
        else:
            # pr·pr_stretch: the adaptive full-scrub interval (stretched
            # only while the spectrum is calm — see the stats block in the
            # chunk loop; base cadence when adaptive_reorth_max == 1)
            pr_eff = pr * pr_stretch
            reorth_pattern = tuple((i0 + s) % pr_eff == 0 for s in range(S))
        store._ensure(store.ncols + S * b)
        col0_abs = store.ncols
        col0_rel = jnp.int32(col0_abs - store.dev_base)
        npass = 2 if (danger or selective) else 1
        with timer.section("sweep_dispatch"):
            if store.host_ncols and reorth_pattern.count(True):
                # Hybrid reorth, host tier (reference hybrid_part_reorth!,
                # RBL_gpu.jl:59-81), re-designed for T-consistency: the
                # offloaded panels re-enter the device and project EVERY
                # full-scrub newborn residual U before its QR (a split
                # step); runs of local-only steps between full scrubs stay
                # fused in one dispatch.  One split step per window is NOT
                # enough: leaks along offloaded dominant directions
                # re-amplify by ~|λ|max/|λ|min per step, so a window's later
                # full scrubs seeing only the device tier lose the basis
                # (measured ‖QᵀQ−I‖ 1.5e-15 → 3.9e-6 starting exactly at
                # the offload boundary, wrong eigenvalues downstream).
                # The panels must never scrub the live pair (Qi, Qprev):
                # those blocks' T couplings (A_{i-1}, B_i) are already
                # recorded, and a retroactive edit makes T ≠ QᵀAQ by
                # O(‖leak‖·‖A‖) — measured ~1e-7 eigenvalue error at the
                # device cap under the live-pair scheme.
                buf = store.buf
                Qi_n, Qprev_n, Bi_n = dev
                bdt_ = dev[0].dtype
                col = col0_rel
                TBs = []
                s = 0
                while s < S:
                    if reorth_pattern[s]:
                        buf, U, Ai0 = _split_step_recur(
                            op, buf, Qi_n, Qprev_n, Bi_n, col, cdt=cdt
                        )
                        # Panel-major, not pass-major: each host panel is
                        # transferred H→D once and projected npass times
                        # consecutively.  Pass-major (the textbook BCGS2
                        # sweep order) would either re-transfer the whole
                        # host tier per pass or pin every panel in HBM at
                        # once — and the tier exists precisely because HBM
                        # is full.  Reordering is safe here because the
                        # panels are mutually orthonormal to basis
                        # precision: cross-panel re-injection from a later
                        # projection is O(‖QᵢᵀQⱼ‖·eps·‖U‖), far below the
                        # CGS2 floor.
                        for _ in range(npass):
                            U = _project_out_jit(buf, U)
                        for panel in store.host_tier():
                            pd = jax.device_put(panel, store.buf.sharding)
                            for _ in range(npass):
                                U = _project_out_jit(pd, U)
                        for _ in range(npass):
                            U = _project_out_jit(Qi_n, U)
                        Q1, B1 = _split_step_qr(
                            U, lock_basis, qr_method=qr_method, bdt=bdt_
                        )
                        TBs.append(jnp.stack([Ai0, B1.astype(Ai0.dtype)]))
                        Qi_n, Qprev_n, Bi_n = Q1, Qi_n, B1
                        col = col + b
                        s += 1
                    else:
                        e = s
                        while e < S and not reorth_pattern[e]:
                            e += 1
                        buf, Qi_n, Qprev_n, Bi_n, TBseg = _sweep_chunk(
                            op, buf, Qi_n, Qprev_n, Bi_n, col, lock_basis,
                            cdt=cdt, qr_method=qr_method, nsteps=e - s,
                            reorth_pattern=reorth_pattern[s:e],
                            loc_passes=cfg.loc_reorth_passes,
                            reorth_passes=npass,
                        )
                        TBs.append(TBseg)
                        col = col + (e - s) * b
                        s = e
                TB = jnp.concatenate(TBs, axis=0) if len(TBs) > 1 else TBs[0]
            else:
                buf, Qi_n, Qprev_n, Bi_n, TB = _sweep_chunk(
                    op, store.buf, dev[0], dev[1], dev[2],
                    col0_rel, lock_basis,
                    cdt=cdt, qr_method=qr_method, nsteps=S,
                    reorth_pattern=reorth_pattern,
                    loc_passes=cfg.loc_reorth_passes,
                    reorth_passes=npass,
                )
        store.buf = buf
        store.ncols = col0_abs + S * b
        dev = (Qi_n, Qprev_n, Bi_n)
        i_next = i0 + S
        try:
            # start the device→host copy of the T blocks now so the RPC
            # round-trip overlaps this chunk's host-side processing
            TB.copy_to_host_async()
        except Exception:
            pass
        return dict(i0=i0, S=S, col0=col0_abs, TB=TB,
                    Qi=Qi_n, Qprev=Qprev_n, Bi=Bi_n,
                    danger=danger or selective, stretch=pr_stretch)

    def rewind_to(ncols_new):
        """Discard basis columns beyond ncols_new (speculated, degenerate,
        or post-convergence writes).  Tier-aware: with host offload active,
        a stale convergence poll or a breakdown can target columns that
        were already offloaded — BasisStore.rewind drops/trims panels."""
        store.rewind(ncols_new, _zero_cols_range)

    # Full eig factorizations run in a worker thread (LAPACK releases the
    # GIL), overlapped with the next chunk's transfer + screening + device
    # sweep: the host dsbevd at m ≈ max_kryl (~0.1 s) was the largest
    # host-serial block left.  Convergence is then detected one chunk late;
    # the extra chunk is rewound exactly like a mispredicted speculation.
    pending = None  # in-flight poll: dict(future, i_poll, B_snap, Qprev)

    def harvest(block: bool) -> None:
        """Collect a finished (or, if block, in-flight) eig poll; on
        convergence rewind everything past the poll's basis prefix."""
        nonlocal pending, w_sel, V_sel, bounds, converged, Qprev
        nonlocal fine_poll, next_poll_cols, selective
        if pending is None or (not block and not pending["future"].done()):
            return
        with timer.section("eig_wait"):
            w_scr, w_old, full = pending["future"].result()
        if not selective and len(w_scr) > 1:
            # Immediate tier: at extreme dominance the ghost of the top
            # pair reaches O(1) within ~10 iterations of its convergence —
            # waiting for two stable screens is already too late (a -5000
            # atop a 1..399 bulk corrupts T by iteration 14).  Trigger on
            # the first screen when the compounding margin is ≥ 3× the
            # threshold; a false positive merely costs extra reorth.
            mx0 = abs(w_scr[-1])
            g0 = mx0 / max(abs(w_scr[0]), np.finfo(np.float64).tiny)
            rem0 = max(i_max - pending["i_poll"], 0)
            if g0 > 1.0 and rem0 * np.log(g0) > 3.0 * np.log(0.01 / eps):
                selective = True
        if (
            not selective
            and w_old is not None
            and len(w_old) == len(w_scr)
            and len(w_scr) > 1
        ):
            # Selective-orthogonalization trigger (Parlett–Scott flavored,
            # from Ritz VALUES alone — residual bounds only exist at full
            # factorizations, which the stability gate can defer for a long
            # time on exactly these spectra).  Once the dominant Ritz value
            # has stabilized, its eigenvector is nearly converged and ghost
            # components of it re-amplify ≈ |θ|max/|θ|min per iteration;
            # when that growth compounded over the remaining sweep can lift
            # eps-level rounding noise above ~1% of scale, cadence-2
            # single-pass reorth loses the basis (measured: a single -5000
            # eigenvalue atop a 1..399 bulk corrupts T within 80 iterations
            # while ‖B‖ stays healthy, so danger mode never fires).  Sticky:
            # converged directions stay in the basis.
            # the dominant pair's value must be converged to its eps-level
            # noise floor (ghosts only matter once the EIGENVECTOR is
            # nearly converged, i.e. Δλ ~ eps·|λ|); gating on cfg.tol
            # false-triggers on loose-tolerance solves where nothing has
            # truly converged (measured: the f32 Laplacian headline at
            # tol=1e-3 flipped selective on and lost 25% time-to-solution)
            mx = abs(w_scr[-1])
            if mx > 0 and abs(w_scr[-1] - w_old[-1]) <= 10.0 * eps * mx:
                gamma = mx / max(abs(w_scr[0]), np.finfo(np.float64).tiny)
                rem = max(i_max - pending["i_poll"], 0)
                if gamma > 1.0 and rem * np.log(gamma) > np.log(0.01 / eps):
                    selective = True
                    _dbg(f"selective ON (stable-max) at poll panel "
                         f"{pending['i_poll']}: gamma={gamma:.3g} rem={rem}")
        if full is not None:
            from ..ops.eig import ritz_residual_bounds

            w_sel, V_sel = sort_eig_abs(full[0], full[1], k)
            bounds_now = ritz_residual_bounds(
                np.asarray(pending["B_snap"]), np.asarray(V_sel[:, :k]), b
            )
            if not fine_poll and np.mean(bounds_now <= cfg.tol) >= 0.25:
                # a meaningful fraction of the Ritz pairs already meets the
                # residual bound: the all-or-nothing convergence window is
                # near.  Pin polls back to the base cadence — convergence
                # lives in a window (past it, converged directions
                # re-amplify and corrupt the basis), and the geometric
                # stride (~m/4 columns) can step clean over it.
                fine_poll = True
                next_poll_cols = fine_poll_reset_cols(
                    next_poll_cols, pending["i_poll"], b,
                    cfg.eig_poll_cadence,
                )
            if bool(np.all(bounds_now <= cfg.tol)):
                bounds = bounds_now
                converged = True
                Qp = pending["Qprev"]
                if Qp is None:
                    # mid-chunk poll: Q_{i_poll} lives in the basis store
                    # (read before the rewind truncates it away)
                    Qp = store.read_block((pending["i_poll"] - 1) * b, b)
                rewind_to((pending["i_poll"] - 1) * b)
                Qprev = Qp
        pending = None

    # In-flight chunk pipeline: up to cfg.pipeline_depth chunks are
    # dispatched ahead of the one whose T blocks the host reads next, so
    # the blocking TB read overlaps the later chunks' device sweeps (at
    # depth 1 this is the single-speculation pipeline; ≥ 2 hides the chunk
    # compute entirely and the host pays only the RPC latency).
    from collections import deque

    inflight: deque = deque()

    def top_up():
        # deep speculation only on a calm spectrum: near the danger regime
        # every policy flip discards all in-flight chunks (see dispatch)
        depth = cfg.pipeline_depth if (not danger and calm_chunks >= 2) else 1
        while len(inflight) < max(1, depth) and i_next <= i_max and not converged:
            inflight.append(dispatch())

    top_up()
    while inflight:
        cur = inflight.popleft()
        top_up()  # keep the pipeline full while we block on cur's TB
        with timer.section("transfer"):
            TB = np.asarray(cur["TB"])  # (2S, b, b): [A_s, B_s] pairs
        i0, S, col0_abs = cur["i0"], cur["S"], cur["col0"]
        if not np.all(np.isfinite(TB)):
            # numerical health check (SURVEY §5: the reference has no
            # failure detection) — the T blocks cross to the host anyway,
            # so this is free; a NaN here means the operator or dtype
            # configuration produced non-finite values
            raise FloatingPointError(
                f"non-finite T blocks at iterations {i0}..{i0 + S - 1} — "
                "operator output or precision configuration is unstable "
                f"(basis_dtype={cfg.basis_dtype}, compute_dtype={cfg.compute_dtype})"
            )
        # host-side T assembly + breakdown scan.  Step s is iteration
        # j = i0+s; it consumed (Q_j, Q_{j-1}, B_j), wrote Q_{j-1} to the
        # basis, and produced (A_j, B_{j+1}).
        collapse_at = None
        partial_at = None   # first step whose coupling block lost rank
        partial_rank = 0    # its number of healthy singular directions
        danger_at = None  # first mid-chunk step entering the danger regime
        chunk_min_sv = np.inf  # min σ_min(B_s) over this chunk
        chunk_scale = 0.0  # max |A_s| over this chunk: the ACTIVE Rayleigh
        # scale.  Breakdown/danger thresholds compare ‖B‖ against THIS, not
        # against the historical tscale: once a dominant direction is
        # captured, tscale stays at |λ|max while the live sweep works at the
        # bulk scale — a √eps·tscale collapse test then flags every healthy
        # bulk step as breakdown (measured on an image Gram with
        # σ₁²/σ₂² ≈ 700 in f32: the whole sweep burned on spurious
        # re-randomizations, σ₂ off by 20%).
        explosion_at = None  # first step whose ‖B‖ exceeds the ‖A‖ bound
        for s in range(S):
            A_s, B_s = TB[2 * s], TB[2 * s + 1]
            if np.abs(B_s).max() > 10.0 * max(tscale, np.abs(A_s).max()):
                # ‖B_{j+1}‖ ≤ ‖A‖ for any orthonormal basis — a larger
                # value means the dtype's precision floor (eps·|λ|max
                # re-injected per application of A) has crossed the active
                # spectral scale: no further directions are resolvable in
                # this precision, and continuing runs away geometrically
                # to inf within a few steps (measured: f32 on an image
                # Gram with σ₁²/σ_sea² ≈ 10⁵).  Discard this step too —
                # its A block is already suspect.
                explosion_at = s
                break
            B_hist[i0 + s] = B_s
            T.append_diag(A_s)
            a_s = np.abs(A_s).max()
            tscale = max(tscale, a_s)
            chunk_scale = max(chunk_scale, a_s)
            if np.abs(B_s).max() < np.sqrt(eps) * max(a_s, tscale * eps):
                collapse_at = s  # B_{j+1} ≈ 0: steps after s are noise
                break
            B_svals = np.linalg.svd(B_s, compute_uv=False)
            chunk_min_sv = min(chunk_min_sv, B_svals[-1])
            # Partial-collapse discard threshold: the ROUNDING floor
            # (noise A injects per application), not the √eps breakdown
            # level — an honest-but-small σ (a nearly-converged interior
            # direction, e.g. a restart block) must stay in T; between
            # the levels the hysteresis below escalates to danger reorth.
            rank_thr = 100.0 * eps * max(tscale, np.finfo(np.float64).tiny)
            if B_svals[-1] < rank_thr:
                # PARTIAL rank collapse: some σ of the coupling block sit
                # at the rounding floor while ‖B‖ stays O(‖A‖) — the
                # max-entry test above is blind to it, but the QR has
                # already orthonormalized ghost noise into the dead
                # columns (see _repair_partial_block).  Steps after s
                # consumed the poisoned block.
                partial_at = s
                # may be 0 (all σ at the floor while ‖B‖ passes the
                # max-entry test — reachable when the active scale sits
                # far below tscale): _repair_block then degenerates to
                # full re-randomization
                partial_rank = int(np.sum(B_svals >= rank_thr))
                break
            if (
                not selective
                and not cur["danger"]
                and s < S - 1
                and tscale > 10.0 * a_s
            ):
                # Per-STEP dominance transition: the active Rayleigh scale
                # just dropped an order of magnitude below the captured top
                # — the dominant direction converged THIS chunk, and at
                # extreme ratios (γ = tscale/a_s) its ghost re-amplifies
                # ×γ per iteration: by the time a chunk-level or poll-level
                # trigger reacts, 2 calm steps at γ ≈ 700 in f32 have
                # already seeded eps·γ² ≈ 6% ghost copies into T.  Truncate
                # at the transition and resume in selective mode.
                gp = tscale / max(a_s, np.finfo(np.float64).tiny)
                if (i_max - (i0 + s)) * np.log(gp) > 3.0 * np.log(0.01 / eps):
                    danger_at = s
                    selective = True
                    _dbg(
                        f"selective ON (step-scale) at i={i0 + s}: "
                        f"gamma≈{gp:.3g}"
                    )
                    break
            if (
                not cur["danger"]
                and np.abs(B_s).max() < 1e-2 * a_s
                and s < S - 1
            ):
                # ‖B‖ entered the ghost re-amplification regime mid-chunk,
                # and the rest of the chunk ran under the calm cadence-2
                # policy — with grown chunks that is long enough to lose the
                # basis to ghosts.  Truncate processing here; the handler
                # below rewinds to this step and resumes in danger mode.
                danger_at = s
                break
            if s < S - 1:
                T.set_subdiag(B_s, i0 + s - 1)
        done = S
        for stop in (collapse_at, danger_at, partial_at):
            if stop is not None:
                done = stop + 1
                break
        if explosion_at is not None:
            done = explosion_at  # step s itself is discarded
        i = i0 + done - 1
        B_last = (
            TB[2 * (done - 1) + 1] if done >= 1 else np.asarray(B_hist[i])
        )
        Qprev = cur["Qprev"]

        if explosion_at is not None:
            # Precision exhaustion (see the scan): restore the invariant at
            # the last valid iteration and either finish with the basis in
            # hand (enough columns for a Rayleigh–Ritz answer — the values
            # are as good as this dtype allows) or re-randomize and keep
            # sweeping if the basis is still smaller than k.
            q_col = col0_abs + explosion_at * b  # Q_i, written at step s
            Qp = store.read_block(q_col, b)
            rewind_to((i - 1) * b)
            Qprev = Qp
            inflight.clear()
            if i * b >= k:
                _dbg(
                    f"precision exhaustion at i={i}: terminating sweep "
                    f"(‖B‖ exceeded 10·tscale={tscale:.3g})"
                )
                i_next = i_max + 1  # terminal: no further dispatches
            else:
                key, sub = jax.random.split(key)
                with timer.section("rerandomize"):
                    Qi_new = _fresh_directions(
                        store, (Qprev,), lock_basis, sub,
                        Qprev.shape, Qprev.dtype, qr_method,
                    )
                # the honest coupling to the re-randomized block is zero —
                # a deflation-style split, like the collapse path
                dev = (Qi_new, Qprev, jnp.zeros_like(cur["Bi"]))
                i_next = i + 1

        if collapse_at is not None:
            # Breakdown: an (almost) invariant subspace was hit — the
            # reference has no handling for this (SURVEY §5).  Discard the
            # degenerate tail and the speculated chunk, restore the
            # invariant "stored = Q_1..Q_{i-1}, Qprev = Q_i", and replace
            # the dead block with fresh orthogonalized randomness.  T keeps
            # the honest (tiny) B out of its band — a √eps-accurate
            # deflation split.
            if collapse_at < S - 1:
                # Q_i sits at step s*+1's write; read it before rewinding
                # (tier-aware: it may already have been offloaded)
                qcol = col0_abs + (collapse_at + 1) * b
                Qprev = store.read_block(qcol, b)
            rewind_to((i - 1) * b)
            key, sub = jax.random.split(key)
            with timer.section("rerandomize"):
                Qi_new = _fresh_directions(
                    store, (Qprev,), lock_basis, sub,
                    Qprev.shape, Qprev.dtype, qr_method,
                )
            dev = (Qi_new, Qprev, jnp.asarray(B_last))
            i_next = i + 1
            inflight.clear()  # speculated chunks consumed garbage state

        if partial_at is not None:
            # Partial rank collapse at iteration j = i: keep the healthy
            # singular directions of the coupling block exactly (they carry
            # real O(‖A‖) couplings — dropping them, as the full-collapse
            # path does with its tiny B, would put O(‖A‖) error into T),
            # re-randomize the dead ones with zero coupling, and discard
            # the poisoned later steps.  See _repair_partial_block.
            s = partial_at
            q_col = col0_abs + (s + 1) * b
            Q_j = (
                store.read_block(q_col, b) if s + 1 <= S - 1 else cur["Qprev"]
            )
            if s == S - 1:
                Q_jp1 = cur["Qi"]
            elif s == S - 2:
                Q_jp1 = cur["Qprev"]
            else:
                Q_jp1 = store.read_block(q_col + b, b)
            rewind_to((i - 1) * b)
            Qprev = Q_j
            B_s = TB[2 * s + 1]
            key, sub = jax.random.split(key)
            with timer.section("rerandomize"):
                Qnew, B_new = _repair_block(
                    store, Qprev, Q_jp1, B_s, partial_rank, lock_basis,
                    sub, qr_method,
                )
            _dbg(
                f"partial breakdown at i={i}: rank {partial_rank}/{b} "
                f"(σ_min={B_svals[-1]:.3g}) — repaired"
            )
            B_last = B_new
            B_hist[i] = B_new
            dev = (Qnew, Qprev, jnp.asarray(B_new))
            i_next = i + 1
            inflight.clear()  # speculated chunks consumed the poisoned block
            # A rank-deficient residual means the sweep is AT an invariant
            # subspace: the repaired random directions re-excite converged
            # eigendirections through A at O(‖A‖·leak) per step, which
            # cadence-2 reorth cannot contain (measured: rank-5 Gram, k=8 —
            # ghost couplings reached O(‖A‖) within 2 iterations of the
            # repair).  Every-step CGS2 until the spectrum calms.
            danger = True
            calm_chunks = 0
            n_chunks = 0

        if danger_at is not None:
            # Mid-chunk danger onset (see the scan above): discard the
            # calm-policy tail of this chunk and the speculated one, restore
            # the state invariant at iteration i = i0 + danger_at, and
            # resume with every-step CGS2 reorth.  Q_i and Q_{i+1} were
            # written to the basis by the (discarded) later steps, so they
            # are read back before the rewind; B_{i+1} is TB's entry for the
            # onset step.  This mirrors what the base-cadence solver does —
            # enter danger mode within ≤ cadence iterations of onset —
            # independent of the grown chunk length.
            q_col = col0_abs + (danger_at + 1) * b
            Q_i = store.read_block(q_col, b)
            if danger_at + 2 <= S - 1:
                Q_ip1 = store.read_block(q_col + b, b)
            else:  # danger_at == S-2: Q_{i+1} is the chunk-end Qprev
                Q_ip1 = cur["Qprev"]
            rewind_to((i - 1) * b)
            Qprev = Q_i
            dev = (Q_ip1, Q_i, jnp.asarray(B_last))
            i_next = i + 1
            danger = True
            calm_chunks = 0
            n_chunks = 0  # restart chunk growth from the base cadence
            inflight.clear()  # speculated chunks ran under the stale calm policy

        # danger-mode hysteresis: enter every-step CGS2 reorth while any
        # ‖B_s‖ sits below 1e-2·tscale (ghost re-amplification regime);
        # leave only after 3 consecutive chunks clear of 1e-1·tscale —
        # danger reorth itself restores ‖B‖, so an eager exit oscillates,
        # and every policy flip discards the speculated chunk AND compiles
        # a fresh _sweep_chunk variant (measured: 44 dispatches for an
        # 11-chunk solve).  A speculated chunk dispatched under a stale
        # policy is discarded and re-run.
        min_B = min(
            (float(np.abs(TB[2 * s + 1]).max()) for s in range(done)),
            default=None,
        )
        # σ_min in the ghost-prone band (above the partial-collapse
        # rounding floor, below the √eps breakdown level): an honest but
        # nearly-converged interior direction — its coupling stays in T,
        # but its ghost re-amplifies like any converged direction, and the
        # max-entry min_B test below cannot see it inside a healthy block.
        # NB the danger mode this triggers persists for as long as some
        # σ_min stays in the band — DELIBERATELY: the calm exit below IS a
        # σ_min-recovery test (three consecutive chunks must clear this
        # threshold), and under every-step CGS2 a residual that still has
        # unexplored spectrum to draw on recovers full rank within a chunk
        # or two.  If σ_min never recovers, the interior direction keeps
        # re-converging and the escalated reorth is genuinely needed for
        # the rest of the sweep — the chunk-growth/pipeline cost of that
        # (measured 2.3×-class on gap spectra) is the price of a basis
        # that stays orthonormal.
        sv_ghostly = chunk_min_sv < np.sqrt(eps) * max(
            chunk_scale, tscale * eps
        )
        if min_B is None:
            pass  # empty chunk (explosion at step 0): keep current mode
        elif min_B < 1e-2 * chunk_scale or sv_ghostly:
            if not danger:
                _dbg(f"danger ON at i={i}: min|B|={min_B:.3g} "
                     f"min sv={chunk_min_sv:.3g} "
                     f"active scale={chunk_scale:.3g}")
            danger = True
            calm_chunks = 0
        elif min_B > 1e-1 * chunk_scale:
            calm_chunks += 1
            if calm_chunks >= 3:
                danger = False
        else:
            calm_chunks = 0
        if not selective and chunk_scale > 0 and tscale > chunk_scale:
            # Chunk-stats selective trigger (no poll needed — with b small
            # and k large the first poll at i·b > k can come long after
            # extreme-dominance ghosts have corrupted the basis): once the
            # sweep's ACTIVE Rayleigh scale has dropped below the historical
            # tscale, converged dominant directions exist and their ghosts
            # re-amplify by ≈ tscale/active per iteration.  3× margin like
            # the immediate poll tier.
            gp = tscale / chunk_scale
            rem_i = max(i_max - i, 0)
            if rem_i * np.log(gp) > 3.0 * np.log(0.01 / eps):
                selective = True
                _dbg(f"selective ON (chunk-stats) at i={i}: "
                     f"gamma≈{gp:.3g} rem={rem_i}")
        if cfg.adaptive_reorth_max > 1:
            # Adaptive full-scrub stretch (see RBLConfig.adaptive_reorth_max):
            # double the interval per calm chunk; snap back to base on ANY
            # risk signal.  Near the convergence window (fine_poll) and
            # with captured dominant directions, leaks re-amplify — those
            # regimes keep the base cadence.
            calm_for_stretch = (
                not danger and not selective and lock_basis is None
                and not fine_poll and calm_chunks >= 3
                and min_B is not None
                and chunk_min_sv >= 0.1 * chunk_scale
                and tscale <= 2.0 * chunk_scale
            )
            pr_stretch = (
                min(pr_stretch * 2, cfg.adaptive_reorth_max)
                if calm_for_stretch else 1
            )
        if inflight and inflight[0]["danger"] != (danger or selective):
            rewind_to((i - 1) * b)
            dev = (cur["Qi"], cur["Qprev"], cur["Bi"])
            i_next = i + 1
            n_chunks = 0  # restart chunk growth from the base cadence
            inflight.clear()
        elif inflight and inflight[0]["stretch"] > pr_stretch:
            # a speculated chunk dispatched under a STRETCHED cadence after
            # the policy snapped back would run with fewer scrubs than the
            # risk now demands — discard it (more scrubs than demanded is
            # the safe direction and is never discarded)
            rewind_to((i - 1) * b)
            dev = (cur["Qi"], cur["Qprev"], cur["Bi"])
            i_next = i + 1
            n_chunks = 0
            inflight.clear()

        # Convergence polls (reference cadence RBL.jl:106; immediately on
        # breakdown — the Krylov space is nearly invariant then, so the
        # Rayleigh–Ritz values are ripe *now*).  Every poll runs on the eig
        # worker thread (values-only screen gating the full factorization —
        # see _poll_task) overlapped with device sweeps, and polls back off
        # geometrically: even the values-only solve is O(m²b) on the host,
        # so polling every window at large m can cost more than the
        # sweeps themselves.
        #
        # Polls are DECOUPLED from chunk boundaries: the chunk's TB carries
        # every per-step T block, so T can be factorized at any panel prefix
        # j ≤ i — a grown chunk does not coarsen the poll schedule.  (It
        # must not: convergence lives in a window — past it, converged Ritz
        # directions re-amplify through rounding and corrupt the basis — and
        # a chunk-sized poll stride can step clean over that window.)
        force_poll = (
            i >= i_max or collapse_at is not None or explosion_at is not None
        )
        polled = False

        def submit_poll(j):
            """Queue a poll of T's j-panel prefix on the eig worker, and
            advance the backoff schedule (geometric ~m/4 stride far from
            convergence, base cadence once fine_poll is set)."""
            nonlocal pending, next_poll_cols, polled
            snapshot = T.view(j * b).copy()  # T keeps growing under the thread
            if j == i:
                B_snap, Qp = B_last, Qprev
            else:
                # prefix poll: the coupling block B_{j+1} from the host-side
                # history (the panel may predate this chunk when a fine_poll
                # reset pulled the schedule back); Q_j is read from the
                # basis store only if this poll converges
                B_snap, Qp = B_hist[j], None
            pending = dict(
                future=_EIG_EXECUTOR.submit(
                    _poll_task, snapshot, k, eig_bk, poll_chain, cfg.tol,
                    poll_chain.get("w") is None or (force_poll and j == i),
                ),
                i_poll=j,
                B_snap=B_snap,
                Qprev=Qp,
                npanels=j,
            )
            next_poll_cols = j * b + poll_stride_cols(
                j, b, cfg.eig_poll_cadence, fine_poll
            )
            polled = True

        if i * b > k:
            while next_poll_cols <= i * b and not converged:
                harvest(block=True)  # at most one poll in flight
                if converged:
                    break
                # fine_poll may have just flipped — next_poll_cols reflects it
                if next_poll_cols > i * b:
                    break
                submit_poll(poll_panel_for(next_poll_cols, i, b, k))
            if (
                force_poll
                and not converged
                and (pending is None or pending["i_poll"] < i)
            ):
                harvest(block=True)
                if not converged:
                    submit_poll(i)
        if converged:
            break
        if not polled:
            harvest(block=False)
            if converged:
                break
        if collapse_at is None and explosion_at is None:
            T.set_subdiag(B_last, i - 1)
        chunks_done += 1
        handler_fired = any(
            x is not None
            for x in (collapse_at, danger_at, partial_at, explosion_at)
        )
        if ck_path and not handler_fired and chunks_done % ck_every == 0:
            # Clean chunk boundary: the invariant state is exactly what
            # resume needs — basis prefix Q_1..Q_{i-1}, the triple
            # (Q_{i+1}, Q_i, B_{i+1}) from THIS chunk's snapshot (``dev``
            # may already hold speculated later state), T including the
            # edge subdiag just written, and the policy flags.
            from ..utils.checkpoint import save_sweep_state

            with timer.section("checkpoint"):
                save_sweep_state(ck_path, dict(
                    n=n, b=b, k=k, i=i, chunks_done=chunks_done,
                    n_chunks=n_chunks,
                    T_ncols=T.ncols, band=T.band[:, : T.ncols],
                    basis=store.snapshot((i - 1) * b),
                    Q_ip1=cur["Qi"], Q_i=cur["Qprev"], B_ip1=cur["Bi"],
                    tscale=float(tscale), B_last=B_last, B_hist=B_hist,
                    danger=danger, selective=selective,
                    calm_chunks=calm_chunks, pr_stretch=pr_stretch,
                    fine_poll=fine_poll, next_poll_cols=next_poll_cols,
                    key=np.asarray(key),
                ))
        if abort_after is not None and chunks_done >= abort_after:
            raise SweepAborted(
                f"fault injection: aborting after {chunks_done} processed "
                f"chunks (i={i})"
            )
        top_up()

    final_panels = None if pending is None else pending["npanels"]
    harvest(block=True)
    if w_sel is not None and not converged and final_panels is not None:
        # the final poll may have produced only a screen; its stale V_sel
        # (from an earlier, shorter T) must not masquerade as the final
        # factorization
        final_panels = final_panels if V_sel.shape[0] == final_panels * b else None

    # the newest block Q_i completes the basis (cols = i·b); on the
    # converged path this mirrors the reference's final push (RBL.jl:113),
    # on the cap path its final append before recovery
    store.append(Qprev)

    if converged:
        # a prefix poll may have converged mid-chunk: the harvest rewound
        # the store to the poll's panel prefix, so the chunk's iteration
        # counter overstates the basis.  nblocks must match V_sel's rows
        # (the documented contract: V_sel has nblocks·b rows).
        i = store.ncols // b

    if not converged:
        # Cap reached: final Rayleigh–Ritz with everything we have.  (The
        # reference returns the last poll's stale factorization here —
        # RBL.jl:116 — which can disagree with the stored basis length; we
        # re-solve so D/V always match the basis — unless the final async
        # poll already factorized the full T, in which case its result IS
        # the final factorization.)
        i_final = store.ncols // b
        if final_panels != i_final or w_sel is None:
            with timer.section("eig"):
                if eig_bk == "scipy":
                    from ..ops.eig import eig_banded_topk_dense

                    w_sel, V_sel = eig_banded_topk_dense(T.view(store.ncols), k)
                else:
                    w, V = eig_banded_host(T.view(store.ncols), backend=eig_bk)
                    w_sel, V_sel = sort_eig_abs(w, V, k)
        from ..ops.eig import ritz_residual_bounds
        bounds = ritz_residual_bounds(np.asarray(B_last), V_sel, b)
        i = i_final

    return w_sel, V_sel, T, np.asarray(bounds) if bounds is not None else None, converged, i
