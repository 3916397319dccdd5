"""ELLPACK sparse operator — the portable SpMM baseline.

The reference stores A as CSC and dispatches SpMM to CuSPARSE
(RBL_gpu.jl:152,176 via ``mul!(U, Ag, Qg_d)``).  CSR/CSC row-pointer loops have
data-dependent shapes, which XLA's static-shape model does not take, so the
portable format is ELLPACK: every row padded to the same nnz count L, giving two
dense (n, L) arrays (column indices, values) and an SpMM that is a static
``lax.scan`` of L gathered AXPYs — fully jittable, shardable, and with no
data-dependent shapes.  The BSR kernel (pallas_bsr.py) replaces this on the
GPU for f32/bf16 matrices that are not banded.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .operator import LinearOperator, _pet, register_operator, static_field


@register_operator
@dataclasses.dataclass(frozen=True)
class SparseEllOperator(LinearOperator):
    """Symmetric sparse operator in ELLPACK (padded-row) layout.

    cols: (L, n) int32 — column index of the l-th nonzero of each row;
          padding slots point at the row itself.
    vals: (L, n)       — matching values; padding slots are 0.
    """

    cols: jax.Array
    vals: jax.Array
    _n: int = static_field(default=0)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self):
        # counts stored (padded) slots with nonzero value
        return int(jnp.count_nonzero(self.vals))

    def apply(self, X):
        # accumulate in _pet(X.dtype): a bf16 scan over L~100 slots loses
        # ~L·2⁻⁸ relative per row — same upcast as the COO/BSR paths
        acc_dt = _pet(X.dtype)

        def body(acc, row):
            c, v = row
            return acc + (v[:, None] * jnp.take(X, c, axis=0)).astype(acc_dt), None

        out, _ = jax.lax.scan(
            body,
            jnp.zeros(X.shape, dtype=acc_dt),
            (self.cols, self.vals),
        )
        return out.astype(X.dtype)

    def diagonal(self):
        # padding slots self-point with value 0, so they contribute nothing
        r = jnp.arange(self._n, dtype=self.cols.dtype)
        return jnp.sum(
            jnp.where(self.cols == r[None, :], self.vals, 0.0), axis=0
        )

    @classmethod
    def from_scipy(cls, A, dtype=None):
        """Build from a scipy.sparse matrix (CSR'd internally)."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n = A.shape[0]
        dtype = dtype or A.dtype
        row_nnz = np.diff(A.indptr)
        L = max(int(row_nnz.max()), 1)
        cols = np.tile(np.arange(n, dtype=np.int32), (L, 1))  # self-pad
        vals = np.zeros((L, n), dtype=np.dtype(dtype))
        # scatter nonzeros into slot l = position within row, vectorized
        # (a per-row arange loop is O(n) interpreter time at n=10⁶)
        rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
        slot = np.arange(A.nnz, dtype=np.int64) - A.indptr[rows]
        cols[slot, rows] = A.indices.astype(np.int32)
        vals[slot, rows] = A.data.astype(np.dtype(dtype))
        return cls(cols=jnp.asarray(cols), vals=jnp.asarray(vals), _n=n)

    @classmethod
    def from_dense(cls, M, dtype=None):
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(M)), dtype=dtype)
