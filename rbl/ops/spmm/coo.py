"""COO segment-sum + HYB (capped-ELL / COO overflow) sparse operators.

The reference relies on CuSPARSE to handle arbitrary sparsity structure
(RBL_gpu.jl:152,176).  The portable ELL scan (ell.py) pads every row
to the MAXIMUM row nnz — for skewed row-length distributions (power-law
graphs, matrices with a few dense rows) that multiplies both memory and scan
length by the skew factor: one degree-10⁴ row in a mean-degree-10 graph
makes ELL 1000× too big.  Two classic layouts fix it:

- ``CooOperator``: nonzeros as flat (rows, cols, vals) triplets sorted by
  row; SpMM is one gather of X rows + one ``segment_sum`` — O(nnz·b) work
  regardless of skew, fully static shapes, optional chunking to bound the
  (nnz, b) gather intermediate in HBM.
- ``HybOperator``: ELL capped at a row-length quantile (the dense,
  vectorizable bulk) + COO for the overflow entries of the few long rows —
  the ELL/COO hybrid of Bell & Garland's classic SpMV taxonomy, built here
  by composing the two operator pytrees.

``as_operator(..., format="auto")`` routes skewed matrices here
(operator.py ``_pick_sparse_format``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .operator import LinearOperator, _pet, register_operator, static_field

# Pad the triplet arrays to a lane-friendly multiple so re-runs with
# slightly different nnz hit the same compiled program.
_NNZ_ALIGN = 1024


def _coo_apply(rows, cols, vals, X, nrows_out, chunk):
    """Shared COO SpMM body: gather X rows, one sorted ``segment_sum``
    into ``nrows_out`` output rows, accumulated in ``_pet(X.dtype)``;
    ``lax.scan`` over ``chunk``-sized triplet slabs bounds the (nnz, b)
    gather intermediate in HBM."""
    nnz = rows.shape[0]
    acc = _pet(X.dtype)

    def seg(r, c, v):
        contrib = (v[:, None] * jnp.take(X, c, axis=0)).astype(acc)
        return jax.ops.segment_sum(
            contrib, r, num_segments=nrows_out, indices_are_sorted=True
        )

    if nnz <= chunk:
        return seg(rows, cols, vals).astype(X.dtype)
    nfull = nnz // chunk
    body = lambda out, t: (out + seg(*t), None)
    parts = (
        rows[: nfull * chunk].reshape(nfull, chunk),
        cols[: nfull * chunk].reshape(nfull, chunk),
        vals[: nfull * chunk].reshape(nfull, chunk),
    )
    out, _ = jax.lax.scan(
        body, jnp.zeros((nrows_out, X.shape[1]), acc), parts
    )
    if nfull * chunk < nnz:
        out = out + seg(
            rows[nfull * chunk:], cols[nfull * chunk:], vals[nfull * chunk:]
        )
    return out.astype(X.dtype)


def _pad_sorted_triplets(rows, cols, vals, last_row):
    """Row-sort triplets and pad to ``_NNZ_ALIGN``.  Pad slots target
    ``last_row`` with val 0 (zero contribution): appending them keeps the
    row array ascending, which segment_sum's ``indices_are_sorted=True``
    contract requires — row-0 padding after sorted rows would violate it."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    pad = (-len(rows)) % _NNZ_ALIGN
    if pad or len(rows) == 0:
        pad = pad or _NNZ_ALIGN
        rows = np.concatenate([rows, np.full(pad, last_row, rows.dtype)])
        cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
        vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    return rows.astype(np.int32), cols.astype(np.int32), vals


@register_operator
@dataclasses.dataclass(frozen=True)
class CooOperator(LinearOperator):
    """Symmetric sparse operator as row-sorted COO triplets.

    rows/cols: (nnz_pad,) int32, sorted by row; padding slots target the
    LAST row (col 0, val 0 — zero contribution) so the row array stays
    ascending, which segment_sum's ``indices_are_sorted=True`` contract
    requires (see ``_pad_sorted_triplets``).
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    _n: int = static_field(default=0)
    # Max gather-intermediate rows per chunk: bounds the (chunk, b) HBM
    # scratch for very large nnz; one chunk (no scan) when nnz fits.
    _chunk: int = static_field(default=1 << 22)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self):
        return int(jnp.count_nonzero(self.vals))

    def apply(self, X):
        return _coo_apply(
            self.rows, self.cols, self.vals, X, self._n, self._chunk
        )

    def diagonal(self):
        # padding slots carry value 0 (last row, col 0) — no contribution
        return jax.ops.segment_sum(
            jnp.where(self.rows == self.cols, self.vals, 0.0),
            self.rows, num_segments=self._n, indices_are_sorted=True,
        )

    @classmethod
    def from_scipy(cls, A, dtype=None):
        import scipy.sparse as sp

        A = sp.coo_matrix(A)
        dtype = np.dtype(dtype or A.dtype)
        return cls._from_triplets(A.row, A.col, A.data.astype(dtype), A.shape[0])

    @classmethod
    def _from_triplets(cls, rows, cols, vals, n):
        rows, cols, vals = _pad_sorted_triplets(rows, cols, vals, n - 1)
        return cls(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            _n=n,
        )

    @classmethod
    def from_dense(cls, M, dtype=None):
        import scipy.sparse as sp

        return cls.from_scipy(sp.coo_matrix(np.asarray(M)), dtype=dtype)


@register_operator
@dataclasses.dataclass(frozen=True)
class RectCooOperator:
    """RECTANGULAR (m, n) sparse factor as row-sorted COO triplets — the
    sparse analogue of the dense factor B that ``rbl_svd`` (solver/svd.py)
    takes: not a symmetric LinearOperator, but the building block of the
    matrix-free Gram operator BᵀB / B·Bᵀ (operator.py SparseGramOperator).
    apply(X): (n, b) → (m, b) via the same gather + segment_sum as
    CooOperator; ``transpose()`` returns the (n, m) factor with triplets
    re-sorted by the new row index (segment_sum's indices_are_sorted
    contract)."""

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    _m: int = static_field(default=0)
    _ncols: int = static_field(default=0)
    _chunk: int = static_field(default=1 << 22)

    @property
    def shape(self):
        return (self._m, self._ncols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self):
        return int(jnp.count_nonzero(self.vals))

    def apply(self, X):
        return _coo_apply(
            self.rows, self.cols, self.vals, X, self._m, self._chunk
        )

    @classmethod
    def from_scipy(cls, A, dtype=None):
        import scipy.sparse as sp

        A = sp.coo_matrix(A)
        dtype = np.dtype(dtype or A.dtype)
        return cls._from_triplets(
            A.row, A.col, A.data.astype(dtype), A.shape[0], A.shape[1]
        )

    @classmethod
    def _from_triplets(cls, rows, cols, vals, m, ncols):
        rows, cols, vals = _pad_sorted_triplets(rows, cols, vals, m - 1)
        return cls(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            _m=m,
            _ncols=ncols,
        )

    def transpose(self) -> "RectCooOperator":
        """The (n, m) transposed factor — triplets swapped and re-sorted
        host-side (a one-time cost at operator construction)."""
        rows = np.asarray(self.cols)
        cols = np.asarray(self.rows)
        vals = np.asarray(self.vals)
        live = vals != 0  # drop this layout's padding; _from_triplets re-pads
        return RectCooOperator._from_triplets(
            rows[live], cols[live], vals[live], self._ncols, self._m
        )

    @property
    def T(self) -> "RectCooOperator":
        return self.transpose()


@register_operator
@dataclasses.dataclass(frozen=True)
class HybOperator(LinearOperator):
    """ELL capped at a row-length quantile + COO overflow (HYB layout)."""

    ell: LinearOperator  # SparseEllOperator over the capped rows
    coo: CooOperator     # overflow entries of the long rows

    @property
    def shape(self):
        return self.ell.shape

    @property
    def dtype(self):
        return self.ell.dtype

    @property
    def nnz(self):
        return self.ell.nnz + self.coo.nnz

    def apply(self, X):
        return self.ell.apply(X) + self.coo.apply(X)

    def diagonal(self):
        return self.ell.diagonal() + self.coo.diagonal()

    @classmethod
    def from_scipy(cls, A, dtype=None, quantile: float = 0.95):
        """Cap ELL at the ``quantile`` row-length; spill the rest to COO.

        The cap keeps the scan length at the TYPICAL row length; the few
        rows longer than that contribute only their tail entries to the
        O(nnz_tail) COO pass."""
        import scipy.sparse as sp

        from .ell import SparseEllOperator

        A = sp.csr_matrix(A)
        n = A.shape[0]
        dtype = np.dtype(dtype or A.dtype)
        row_nnz = np.diff(A.indptr)
        L = max(int(np.quantile(row_nnz, quantile)), 1)
        rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
        # slot l = position within row, vectorized (a per-row arange loop
        # is O(n) interpreter time at n=10⁶)
        slot = np.arange(A.nnz, dtype=np.int64) - A.indptr[rows]
        keep = slot < L
        ell_part = sp.csr_matrix(
            (A.data[keep], (rows[keep], A.indices[keep])), shape=A.shape
        )
        spill = ~keep
        ell = SparseEllOperator.from_scipy(ell_part, dtype=dtype)
        coo = CooOperator._from_triplets(
            rows[spill].astype(np.int32),
            A.indices[spill].astype(np.int32),
            A.data[spill].astype(dtype),
            n,
        )
        return cls(ell=ell, coo=coo)
