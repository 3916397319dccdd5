"""Reorthogonalization kernels.

The reference's reorthogonalization layer (SURVEY §1 L2) is a family of
per-block BLAS loops: ``part_reorth!`` walks the stored basis one (n, b) block
at a time (RBL.jl:34-46), with 2-way thread/stream parallelism for the two
newest blocks and, on GPU, a host↔device streaming path for blocks that fell
out of the VRAM buffer (hybrid_part_reorth!, RBL_gpu.jl:59-81).

Here all of that collapses into single large GEMM contractions:

- partial reorth: both newest blocks are stacked into one (n, 2b) panel and
  projected against the *entire* stored basis in one fused
  (2b×n)·(n×M) + (n×M)·(M×2b) GEMM pair.  The basis buffer is zero-padded to
  its allocated capacity, so padding columns contribute exactly nothing and
  the contraction stays static-shaped for XLA.  Under a row-sharded mesh the
  Gram factor reduces with one psum — the distributed analogue of the
  reference's per-block streaming.
- local reorth: CGS2 (two passes of project-then-orthonormalize) of the
  newest block against its predecessor — the *intended* semantics of
  ``loc_reorth!`` (RBL.jl:4-13).
- deflation (restart) reorth: projection against the locked Ritz vectors
  (restarted.jl:1-21, RBL.jl:50-59), same fused formulation.
"""

from __future__ import annotations

import jax.numpy as jnp

from .contract import gram
from .qr import block_qr
from .spmm.operator import _pet


def project_out(basis, W):
    """W <- W - basis @ (basisᵀ @ W).  basis: (n, M) with zero padding
    beyond the stored columns; W: (n, p)."""
    acc = _pet(W.dtype)
    G = gram(basis, W)
    return W - jnp.dot(basis, G.astype(basis.dtype), preferred_element_type=acc).astype(W.dtype)


def partial_reorth(basis, Qi, Qprev, qr_method: str = "householder",
                   passes: int = 1):
    """Project the two newest blocks against the stored basis in one fused
    contraction (reference: part_reorth!, RBL.jl:31-48).

    basis must contain only blocks strictly older than Qprev (zero-padded).
    Returns the updated (Qi, Qprev).

    Unlike the reference (which leaves both blocks un-normalized after the
    projection), Qprev is re-orthonormalized here: a projection against a
    basis that has lost orthogonality can *grow* a block's norm by
    ‖I − QQᵀ‖, and storing un-normalized blocks compounds that growth
    exponentially across iterations.  The QR caps every stored block at
    orthonormal, which keeps the projection operator uniformly bounded.
    (Qi is re-orthonormalized by the local reorth that always follows.)

    ``passes=2`` (CGS2 against the basis) is used by the solver's danger
    mode — near an invariant subspace, ghost components re-amplify by
    ~‖A‖/‖B_i‖ per iteration, and a single classical GS pass leaves a
    residual proportional to the basis's own orthogonality error."""
    b = Qi.shape[1]
    W = jnp.concatenate([Qi, Qprev], axis=1)
    for _ in range(passes):
        W = project_out(basis, W)
    Qprev_new, _ = block_qr(W[:, b:], method=qr_method)
    return W[:, :b], Qprev_new


def local_reorth(Qi, Qprev, passes: int = 2, qr_method: str = "householder"):
    """CGS2: orthogonalize Qi against Qprev and re-orthonormalize, `passes`
    times (reference loc_reorth!'s intended algorithm, RBL.jl:4-13)."""
    for _ in range(passes):
        Qi = project_out(Qprev, Qi)
        Qi, _ = block_qr(Qi, method=qr_method)
    return Qi


def deflate(lock_basis, W):
    """Project W against the locked (converged) Ritz vectors
    (reference restart_reorth!/restart_reorth_gpu!).  lock_basis is the
    zero-padded (n, L) lock buffer."""
    return project_out(lock_basis, W)
