"""Solver configuration.

The reference hardcodes every knob as a literal scattered through the source
(max Krylov sizes at RBL.jl:133 / RBL_gpu.jl:211 / restarted.jl:103,210; reorth
cadence at RBL.jl:93 and restarted.jl:53,171; eig-poll cadence at RBL.jl:106;
tolerance 1e-7 at RBL.jl:109; precision pair at common.jl:5-6; buffer fractions
at RBL_gpu.jl:25,96).  Here every one of those is lifted into a single typed
config object threaded through the solver.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RBLConfig:
    """Configuration for the randomized block Lanczos solver.

    Attributes
    ----------
    block_size:
        Block width b (number of Lanczos vectors advanced per iteration).
    max_kryl_dim:
        Hard cap on the Krylov subspace dimension (reference: 1400 CPU /
        1200 GPU).  The actual cap may be further reduced by the device
        memory budget
        (see ``rbl.parallel.memory``).
    tol:
        Ritz-pair residual-bound convergence tolerance (reference: 1e-7).
    basis_dtype:
        Storage/reorthogonalization precision of the Krylov basis — the
        reference's ``FLOAT`` (common.jl:5).  bf16/f32 on the GPU for
        speed, f64 for the strict CI accuracy gate.
    compute_dtype:
        Precision of the three-term recurrence, QR and projected eigensolve —
        the reference's ``DOUBLE`` (common.jl:6).
    partial_reorth_cadence:
        Run partial reorthogonalization against the stored basis every this
        many iterations (reference: 2; restarted variant: 3).
    eig_poll_cadence:
        Solve the projected eigenproblem / poll convergence every this many
        iterations (reference: 4).
    loc_reorth_passes:
        Number of (project, re-orthonormalize) passes of the local
        reorthogonalization of the newest block against its predecessor.
        2 == CGS2, the *intended* semantics of the reference's loc_reorth!
        (RBL.jl:4-13 — its in-place effective behavior keeps only one
        projection; we implement the intended algorithm).
    qr_method:
        "householder" (jnp.linalg.qr) or "cholqr2" (CholeskyQR2 — two
        GEMMs + small Cholesky, a tall-skinny QR that runs at matmul speed
        and distributes with a single psum).  "auto" picks householder for f64
        and cholqr2 otherwise.
    eig_backend:
        "banded_host": LAPACK-banded eigensolver (scipy ``eig_banded``) on the
        host — the same dsbev path as the reference (common.jl:28-48).
        "native": the in-repo C++ tred2/tql2 banded solver
        (native/band_eig.cpp, loaded via ctypes) — the framework's own
        native replacement for the reference's raw LAPACK ccall; falls back
        to scipy when no toolchain is available.
        "device": dense symmetric ``jnp.linalg.eigh`` of the expanded
        block-tridiagonal T on device (usable inside fully-jitted sweeps).
    min_basis_cols:
        Initial number of columns allocated for the Krylov basis buffer; the
        buffer grows geometrically (×2) up to the capped Krylov dimension so
        quickly-converging problems never allocate the worst case.  This is
        the analogue of the reference's lazily-grown ``push!`` basis plus
        its VRAM-budgeted resident buffer (RBL_gpu.jl:95-104).
    seed:
        PRNG seed for the randomized starting block Ω.
    mesh / rows_axis:
        Optional ``jax.sharding.Mesh`` and the mesh-axis name over which the
        row dimension (n) of the operator and of every Krylov block is
        sharded.  ``None`` means single-device.
    hbm_budget_fraction:
        Fraction of free device memory the Krylov basis is allowed to use
        (reference uses 0.8 of free VRAM, RBL_gpu.jl:96).
    basis_device_cap_cols:
        Optional cap on device-resident basis columns.  Beyond it the store
        offloads the oldest half to pinned host memory and streams it back
        once per reorth window — the reference's hybrid VRAM/pinned-RAM
        hierarchy (RBL_gpu.jl:59-81,95-104,168-169) re-designed with bulk
        compaction instead of per-block streaming.  None (default) keeps
        the whole basis in HBM.
    chunk_growth_cap:
        Cap (as a multiple of ``eig_poll_cadence``) on the geometric growth
        of the fused sweep-chunk length.  Chunks start at the poll cadence
        and double every second chunk, mirroring the geometric poll backoff:
        late in the sweep, convergence polls are sparse, so there is no
        reason to pay a device→host round-trip per cadence window.  1
        disables growth
        (fixed reference-style cadence windows).
    pipeline_depth:
        Number of sweep chunks kept in flight ahead of the one whose T
        blocks the host is reading.  At depth ≥ 2 the blocking device→host
        read of chunk c's T blocks overlaps chunk c+1's (and c+2's) device
        sweep, so the host pays only the RPC latency, not the chunk compute.
        Speculated chunks wasted at convergence/breakdown are rewound
        (device-side only).  1 reproduces the single-speculation pipeline.
    adaptive_reorth_max:
        Maximum stretch factor on ``partial_reorth_cadence`` while the
        spectrum is CALM (classic partial-reorthogonalization economics,
        Simon '84 flavored): the full scrub reads the entire stored basis
        — the dominant HBM traffic late in a sweep — and on spectra with
        no converged/dominant directions the leak between scrubs grows
        only O(eps) per step, so the scrub interval can stretch.  The
        effective cadence doubles per calm chunk up to
        ``partial_reorth_cadence × adaptive_reorth_max`` and snaps back to
        the base cadence the moment any risk signal fires (danger or
        selective mode, a lock set, fine polling near the convergence
        window, a weak coupling block σmin < 0.1·scale, or a captured
        dominant direction tscale > 2·active scale).  1 (default)
        disables stretching — the reference-shaped fixed cadence.
    matmul_precision:
        XLA matmul input precision for the whole solve ("default" | "high"
        | "highest").  On an NVIDIA GPU "default" and "high" run f32
        products in TF32, whose unit roundoff 2⁻¹¹ ≈ 4.9e-4 is above the
        √eps_f32 ≈ 3.5e-4 semi-orthogonality bar the reorthogonalization
        projector has to hold; "highest" runs them in IEEE f32.  Measured
        on an H100 (400 W limit), 2D Laplacian 512², k=50, b=16, f32
        basis: ‖VᵀV−I‖ 1.3e-7 under "highest" against 1.6e-4 under
        "high", at 0.193 s against 0.142 s warm (with the bf16 basis
        both read 1.3e-3, set by bf16 storage).  No effect on CPU or
        f64.
    """

    block_size: int = 4
    max_kryl_dim: int = 1400
    tol: float = 1e-7
    basis_dtype: Any = jnp.float64
    compute_dtype: Any = jnp.float64
    partial_reorth_cadence: int = 2
    eig_poll_cadence: int = 4
    loc_reorth_passes: int = 2
    qr_method: str = "auto"
    eig_backend: str = "banded_host"
    min_basis_cols: int = 32
    seed: int = 0
    mesh: Optional[Any] = None
    rows_axis: str = "rows"
    hbm_budget_fraction: float = 0.8
    basis_device_cap_cols: Optional[int] = None
    chunk_growth_cap: int = 4
    pipeline_depth: int = 2
    adaptive_reorth_max: int = 1
    matmul_precision: str = "highest"

    # --- fault tolerance (SURVEY §5: the reference has none) ---
    # Mid-sweep checkpointing of the MAIN solver: at every
    # ``sweep_checkpoint_every``-th cleanly-processed chunk boundary the
    # full sweep state (basis prefix, recurrence triple, T band, coupling
    # history, reorth-policy flags) is written atomically to
    # ``sweep_checkpoint_path``; ``rbl`` auto-resumes from an existing
    # file and deletes it when the solve completes.  None disables.
    # The path identifies ONE logical solve: never share it across
    # different operators/solves (resume would continue the wrong sweep);
    # internal multi-solve paths (eigsh BE halves, restarted inner
    # sweeps, M-bounds certification) strip it automatically.
    # ``fault_inject_abort_after_chunks`` raises SweepAborted after N
    # processed chunks — deterministic preemption injection for testing
    # the checkpoint/resume path.
    sweep_checkpoint_path: Optional[str] = None
    sweep_checkpoint_every: int = 1
    fault_inject_abort_after_chunks: Optional[int] = None
    # Opt-in solver-level retry: when the non-finite-T guard (or a jax
    # runtime error) fires inside ``rbl``/``rbl_restarted``/
    # ``chebyshev_refine``, wait for value-checked backend health probes
    # (utils/probe.py) and re-dispatch the whole solve this many times.
    # 0 by default: a retry that follows a device fault hides the fault.
    fault_retries: int = 0

    # --- restarted / deflating variant knobs (restarted.jl) ---
    restart_kryl_dim: int = 100      # initial sweep length (restarted.jl:103)
    restart_growth: int = 10         # sweep growth per restart (restarted.jl:142)
    restart_reorth_cadence: int = 3  # deflation + partial reorth cadence (restarted.jl:53)
    # When to grow the sweep: "stall" (default) grows only after a restart
    # that locked nothing — a PRODUCTIVE restart keeps its length, so the
    # sweep shapes (and the whole compiled chunk family) stay pinned across
    # the common progressing case.
    # "always" restores the reference's unconditional +growth
    # (restarted.jl:142).
    restart_growth_policy: str = "stall"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be ≥ 1, got {self.block_size}")
        if self.tol <= 0:
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.max_kryl_dim < self.block_size:
            raise ValueError(
                f"max_kryl_dim={self.max_kryl_dim} < block_size={self.block_size}"
            )
        for name in ("partial_reorth_cadence", "eig_poll_cadence",
                     "loc_reorth_passes", "restart_reorth_cadence",
                     "chunk_growth_cap", "pipeline_depth",
                     "adaptive_reorth_max", "sweep_checkpoint_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be ≥ 1")
        if self.qr_method not in ("auto", "householder", "cholqr2", "cholqr3"):
            raise ValueError(f"unknown qr_method: {self.qr_method!r}")
        if self.eig_backend not in ("banded_host", "native", "device"):
            raise ValueError(f"unknown eig_backend: {self.eig_backend!r}")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}"
            )

    def resolved_qr_method(self) -> str:
        if self.qr_method != "auto":
            return self.qr_method
        return "householder" if jnp.dtype(self.compute_dtype).itemsize >= 8 else "cholqr2"

    def replace(self, **kw) -> "RBLConfig":
        return dataclasses.replace(self, **kw)
