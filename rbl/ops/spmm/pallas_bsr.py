"""Block-sparse (BSR) SpMM for assembled matrices that are not banded.

The reference hands this product to cuSPARSE on a CSC matrix
(``mul!(U, Ag, Q)``, RBL_gpu.jl:152,176).  Here A is stored as a CSR of
dense tiles: A is cut into (bm, bk) tiles, only tiles holding a nonzero
are kept, row-major by block row —

- ``vals``: (T, bm, bk) tile values;
- ``tile_cols``: (T,) int32 column-block index of each tile;
- ``rptr``: (nb + 1,) int32, block row i owns tiles [rptr[i], rptr[i+1]).

Two implementations of Y = A·X share that layout:

- ``bsr_spmm`` — a Pallas kernel on the GPU's Triton route.  One program
  per block row loads its own tile range and walks it with an in-kernel
  loop; each step loads one A tile and the (bk, b) X tile its column
  index names, and accumulates ``A_tile @ X_tile`` in an f32 register
  tile.  The partials never leave registers, and the X tiles, reused by
  every block row that touches the same column block, come from L2.
- ``bsr_spmm_xla`` — the plain XLA version: gather one X tile per stored
  tile, one batched product, and a ``segment_sum`` of the per-tile
  partials.  It is the reference the kernel is tested against, and the
  path for f64 operators (the kernel is built for f32 and bf16 only).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...backend import interpret_mode
from .operator import LinearOperator, register_operator, static_field

# f32 tile products run in IEEE f32 (no TF32): the recurrence's
# semi-orthogonality needs SpMM at full f32 accuracy.  TF32x3 holds the
# same accuracy but was no faster on an H100 (400 W limit), RCM
# fem_elasticity_3d(42), b=8: 0.499 ms per apply against 0.489 ms with
# 32x64 tiles, 0.765 ms against 0.435 ms with 16x64 tiles.
F32_PRECISION = jax.lax.Precision.HIGHEST

# The Triton dot takes operands whose every dimension is ≥ 16, and Triton
# tensors are powers of two: the RHS width is padded up to this floor.
_MIN_RHS_WIDTH = 16


def _bsr_kernel(rptr_ref, cols_ref, vals_ref, x_ref, out_ref, *, bk,
                precision):
    i = pl.program_id(0)

    def body(t, acc):
        c = cols_ref[t]
        x = x_ref[pl.ds(c * bk, bk), :]
        return acc + jax.lax.dot(
            vals_ref[t], x, precision=precision,
            preferred_element_type=jnp.float32,
        )

    acc = jax.lax.fori_loop(
        rptr_ref[i], rptr_ref[i + 1], body,
        jnp.zeros(out_ref.shape, jnp.float32),
    )
    out_ref[...] = acc.astype(out_ref.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("bm", "bk", "interpret", "precision", "out_dtype"),
)
def bsr_spmm(rptr, tile_cols, vals, X, *, bm: int, bk: int,
             interpret: bool = False, precision=F32_PRECISION,
             out_dtype=None):
    """Y = A @ X with the Pallas kernel.  X: (ncb·bk, b) in the tiles'
    dtype, rows padded to whole column blocks, b a power of two ≥ 16.
    Returns (nb·bm, b)."""
    nb = rptr.shape[0] - 1
    b = X.shape[1]
    return pl.pallas_call(
        functools.partial(_bsr_kernel, bk=bk, precision=precision),
        grid=(nb,),
        in_specs=[
            pl.BlockSpec(rptr.shape, lambda i: (0,)),
            pl.BlockSpec(tile_cols.shape, lambda i: (0,)),
            pl.BlockSpec(vals.shape, lambda i: (0, 0, 0)),
            pl.BlockSpec(X.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((bm, b), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * bm, b), out_dtype or X.dtype),
        interpret=interpret,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        name="bsr_spmm",
    )(rptr, tile_cols, vals, X)


@functools.partial(jax.jit, static_argnames=("bk",))
def bsr_spmm_xla(rptr, tile_cols, vals, X, *, bk: int):
    """Y = A @ X in plain XLA.  X: (ncb·bk, b).  Returns (nb·bm, b) in
    X's dtype, accumulated in f32 or wider."""
    nb = rptr.shape[0] - 1
    T, bm, _ = vals.shape
    b = X.shape[1]
    acc = jnp.promote_types(X.dtype, jnp.float32)
    xt = X.reshape(-1, bk, b)[tile_cols]  # (T, bk, b)
    part = jnp.einsum(
        "tmk,tkb->tmb", vals, xt.astype(vals.dtype),
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=acc,
    )
    tile_rows = jnp.repeat(
        jnp.arange(nb), jnp.diff(rptr), total_repeat_length=T
    )
    Y = jax.ops.segment_sum(
        part, tile_rows, num_segments=nb, indices_are_sorted=True
    )
    return Y.reshape(nb * bm, b).astype(X.dtype)


def _tile_keys(A, bm: int, bk: int):
    """Sorted unique (block row · ncb + block col) keys of A's nonzero
    tiles, with the block counts (nb, ncb)."""
    import scipy.sparse as sp

    C = A if isinstance(A, sp.coo_matrix) else sp.coo_matrix(A)
    nb = -(-C.shape[0] // bm)
    ncb = -(-C.shape[1] // bk)
    key = (C.row // bm).astype(np.int64) * ncb + (C.col // bk)
    return np.unique(key), nb, ncb


def pick_tile_plan(A, heights=(16, 32, 64),
                   widths=(64, 128)) -> tuple[int, int]:
    """(bm, bk) by fill: the tile shape that stores the fewest entries.

    The A-tile stream is what the kernel pays for; the X tiles it names
    are re-read by many block rows and come from L2.  Measured on an H100
    (400 W limit) on the RCM-ordered fem_elasticity_3d(42), f32, b=16,
    ms per apply: 16x64 0.436, 64x64 0.467, 32x64 0.484, 64x128 0.556,
    16x128 0.618, 32x128 0.623 — the fewest stored entries (16x64) was
    the fastest.  Ties go to the taller, wider tile (fewer programs)."""
    best, best_entries = None, None
    for bm in sorted(heights, reverse=True):
        for bk in sorted(widths, reverse=True):
            entries = len(_tile_keys(A, bm, bk)[0]) * bm * bk
            if best_entries is None or entries < best_entries:
                best, best_entries = (bm, bk), entries
    return best


def tile_fill(A, bm: int, bk: int) -> float:
    """Share of the stored tile entries that are nonzeros of A."""
    return A.nnz / max(len(_tile_keys(A, bm, bk)[0]) * bm * bk, 1)


def bsr_from_scipy(A, bm: int, bk: int, dtype):
    """Host-side scipy sparse → (rptr, tile_cols, vals, nb, ncb).
    Duplicate COO entries are summed."""
    import scipy.sparse as sp

    C = sp.coo_matrix(A)
    C.sum_duplicates()
    ukey, nb, ncb = _tile_keys(C, bm, bk)
    rptr = np.zeros(nb + 1, dtype=np.int32)
    rptr[1:] = np.cumsum(np.bincount(ukey // ncb, minlength=nb))
    tile_cols = (ukey % ncb).astype(np.int32)
    vals = np.zeros((len(ukey), bm, bk), dtype=np.dtype(dtype))
    key = (C.row // bm).astype(np.int64) * ncb + (C.col // bk)
    vals[np.searchsorted(ukey, key), C.row % bm, C.col % bk] = C.data
    return rptr, tile_cols, vals, nb, ncb


def uses_kernel(dtype) -> bool:
    """The dtype rule: f32 and bf16 operators run the Pallas kernel, f64
    operators the plain XLA version."""
    return jnp.dtype(dtype).itemsize <= 4


def bsr_apply(rptr, tile_cols, vals, X, *, bm: int, bk: int,
              interpret: bool):
    """Y = A @ X for an (n, b) block X, n ≤ nb·bm: pads X to whole
    column blocks (and, for the kernel, to a kernel-legal width), then
    runs the kernel or the plain version by the operator's dtype.
    Returns (nb·bm, b) in X's dtype."""
    nb = rptr.shape[0] - 1
    n, b = X.shape
    ncb_rows = -(-n // bk) * bk
    if vals.shape[0] == 0:
        return jnp.zeros((nb * bm, b), X.dtype)
    if not uses_kernel(vals.dtype):
        Xp = jnp.pad(X, ((0, ncb_rows - n), (0, 0)))
        return bsr_spmm_xla(rptr, tile_cols, vals, Xp, bk=bk)
    bp = max(_MIN_RHS_WIDTH, 1 << (b - 1).bit_length())
    Xp = jnp.pad(X.astype(vals.dtype), ((0, ncb_rows - n), (0, bp - b)))
    Y = bsr_spmm(rptr, tile_cols, vals, Xp, bm=bm, bk=bk,
                 interpret=interpret, out_dtype=X.dtype)
    return Y[:, :b] if bp != b else Y


@register_operator
@dataclasses.dataclass(frozen=True)
class BlockSparseOperator(LinearOperator):
    """Symmetric sparse operator in the CSR-of-tiles layout, applied with
    the Pallas BSR kernel (f32/bf16) or its plain XLA twin (f64).

    The tile shape is chosen per matrix by ``pick_tile_plan``: FEM-class
    matrices with scattered dense node blocks store far fewer zeros in
    16-row tiles than in square ones."""

    rptr: jax.Array         # (nb + 1,) int32 tile range of each block row
    tile_cols: jax.Array    # (T,) int32 column-block id of each tile
    vals: jax.Array         # (T, bm, bk) tile values
    diag: jax.Array | None = None  # (n,) — stashed at construction
    _n: int = static_field(default=0)
    bm: int = static_field(default=16)
    bk: int = static_field(default=128)
    interpret: bool = static_field(default=False)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz_blocks(self):
        return int(self.tile_cols.shape[0])

    def apply(self, X):
        Y = bsr_apply(self.rptr, self.tile_cols, self.vals, X,
                      bm=self.bm, bk=self.bk, interpret=self.interpret)
        return Y[: self._n] if Y.shape[0] != self._n else Y

    def diagonal(self):
        return self.diag

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32, bm: int | None = None,
                   bk: int | None = None):
        """Build from a scipy sparse symmetric matrix.  ``bm``/``bk``
        default to ``pick_tile_plan``'s choice."""
        import scipy.sparse as sp

        if bm is None or bk is None:
            pbm, pbk = pick_tile_plan(A)
            bm, bk = bm or pbm, bk or pbk
        rptr, tile_cols, vals, _, _ = bsr_from_scipy(A, bm, bk, dtype)
        return cls(
            rptr=jnp.asarray(rptr),
            tile_cols=jnp.asarray(tile_cols),
            vals=jnp.asarray(vals),
            diag=jnp.asarray(
                sp.csr_matrix(A).diagonal().astype(np.dtype(dtype))
            ),
            _n=A.shape[0],
            bm=bm,
            bk=bk,
            interpret=interpret_mode(),
        )

    def density_report(self) -> str:
        nnz = int(np.count_nonzero(np.asarray(self.vals)))
        stored = int(self.vals.size)
        return (
            f"BlockSparseOperator: n={self._n}, {self.nnz_blocks} tiles of "
            f"{self.bm}x{self.bk}, fill={nnz / max(stored, 1):.3f}"
        )
