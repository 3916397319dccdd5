"""rbl — randomized block Lanczos eigensolver for NVIDIA GPUs, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
GPU-Randomized-Block-Lanczos (Julia/CUDA): k largest-magnitude eigenpairs of
large sparse symmetric matrices via randomized block Lanczos with local +
partial reorthogonalization, banded Rayleigh–Ritz solves, residual-bound
convergence, Ritz-vector recovery, an explicitly-restarted deflating variant,
mixed precision, and row-sharded multi-chip execution over a jax Mesh.

Public surface (reference parity, SURVEY §1 L4):
  rbl / RBL                — RBL(A, k, b)            (RBL.jl:119)
  rbl_restarted / RBL_restarted — restarted+deflated  (restarted.jl:97,196)
  rbl_svd                  — truncated SVD via the Gram operator (images.jl:21-25)
  eigsh / svds             — scipy.sparse.linalg-compatible shims (the
                             reference's ARPACK comparison surface,
                             benchmark.jl:42 / images.jl:37-42)
  RBLConfig                — every knob the reference hardcodes
  operators                — DiagonalOperator, DenseOperator, SparseEllOperator,
                             DiaOperator, BlockSparseOperator (Pallas BSR),
                             CooOperator/HybOperator (skewed row lengths),
                             Laplacian2D/3D; as_operator auto-selects
"""

import jax as _jax

# The recurrence and projected eigensolve run in f64 by default, like the
# reference's DOUBLE (common.jl:6).  x64 must be enabled before any JAX call.
_jax.config.update("jax_enable_x64", True)

from .config import RBLConfig
from .ops.spmm.operator import (
    AffineOperator,
    DenseOperator,
    DiagonalOperator,
    FunctionOperator,
    GramOperator,
    Laplacian2D,
    Laplacian3D,
    LinearOperator,
    SparseGramOperator,
    as_operator,
)
from .ops.spmm.ell import SparseEllOperator
from .ops.spmm.coo import CooOperator, HybOperator
from .ops.spmm.dia import DiaOperator
from .ops.minres import ShiftInvertOperator, block_minres
from .ops.amg import AssembledMultigrid, block_jacobi_psolve, rigid_body_modes
from .ops.chebyshev import ChebyshevFilterOperator
from .ops.generalized import (
    ChebyshevSeriesOperator,
    GeneralizedShiftInvertOperator,
    PencilOperator,
)
from .solver.filtered import FilterInfo, rbl_filtered
from .solver.generalized import PencilInfo, rbl_generalized
from .ops.spmm.pallas_bsr import BlockSparseOperator
from .solver.lanczos import LanczosResult, SweepAborted
from .solver.rbl import RBL, RBL_gpu, rbl
from .solver.polish import chebyshev_refine, rbl_polished
from .solver.restarted import RBL_gpu_restarted, RBL_restarted, rbl_restarted
from .solver.svd import SVDResult, rbl_svd
from .compat import eigsh, svds

__all__ = [
    "RBLConfig",
    "LinearOperator",
    "AffineOperator",
    "DiagonalOperator",
    "DenseOperator",
    "FunctionOperator",
    "GramOperator",
    "SparseGramOperator",
    "SparseEllOperator",
    "CooOperator",
    "HybOperator",
    "DiaOperator",
    "BlockSparseOperator",
    "Laplacian2D",
    "Laplacian3D",
    "as_operator",
    "LanczosResult",
    "rbl",
    "RBL",
    "chebyshev_refine",
    "rbl_polished",
    "rbl_restarted",
    "RBL_restarted",
    "RBL_gpu",
    "RBL_gpu_restarted",
    "rbl_svd",
    "SVDResult",
    "eigsh",
    "svds",
    "ShiftInvertOperator",
    "block_minres",
    "AssembledMultigrid",
    "block_jacobi_psolve",
    "rigid_body_modes",
    "ChebyshevFilterOperator",
    "ChebyshevSeriesOperator",
    "GeneralizedShiftInvertOperator",
    "PencilOperator",
    "FilterInfo",
    "rbl_filtered",
    "PencilInfo",
    "rbl_generalized",
    "SweepAborted",
]

__version__ = "0.1.0"
