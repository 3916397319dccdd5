"""DIA (diagonal-storage) sparse operator — the format for banded and
multi-banded matrices.

Where the reference leans on CuSPARSE's gather-based CSC SpMM for every
matrix shape (RBL_gpu.jl:152,176) — banded
matrices (stencils, many SuiteSparse FEM problems after RCM reordering) have
a handful of populated diagonals, and SpMM in diagonal form is pure
streaming arithmetic:
one multiply and one statically-shifted add per diagonal, no indices at all.
XLA fuses the whole loop into a few vectorized passes, so throughput is the
HBM roofline on (k_diags + 2)·n·b elements — far beyond what any gather- or
densified-block format reaches for these matrices.

``Y[r] = Σ_d data[d, r + off_d] · X[r + off_d]`` (scipy DIA convention:
``data[d, c] = A[c − off_d, c]``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .operator import LinearOperator, _pet, register_operator, static_field

# Design note: there is no hand-written DIA kernel; XLA fuses the static
# slice-multiply-add chain below into one pass over the block.


@register_operator
@dataclasses.dataclass(frozen=True)
class DiaOperator(LinearOperator):
    """Symmetric sparse operator in DIA layout.

    data: (k, n) *row-aligned* — data[d, r] = A[r, r + offsets[d]]
    (zero where r + off is out of range), so ``apply`` is a pure fused
    multiply-add over static slices of a zero-padded X: no scatters, no
    gathers, no index arithmetic on device.
    """

    data: jax.Array
    offsets: tuple = static_field(default=())
    _n: int = static_field(default=0)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return int(jnp.count_nonzero(self.data))

    @property
    def _halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def apply(self, X):
        n = self._n
        m = self._halo
        Xp = jnp.pad(X, ((m, m), (0, 0)))
        # accumulate in _pet(X.dtype): sub-f32 inputs sum k_diags products
        # per row — same upcast as the COO/ELL/BSR paths
        Y = jnp.zeros(X.shape, dtype=_pet(X.dtype))
        for d, off in enumerate(self.offsets):
            # row r reads column r + off  →  Xp[m + off + r]
            Y = Y + (self.data[d][:, None] * Xp[m + off : m + off + n]).astype(Y.dtype)
        return Y.astype(X.dtype)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros((self._n,), dtype=self.dtype)

    @classmethod
    def from_scipy(cls, A, dtype=None, max_diags: int = 256):
        """Build from scipy sparse; raises if A has more than ``max_diags``
        populated diagonals (then use BSR/ELL instead)."""
        import scipy.sparse as sp

        D = sp.dia_matrix(A)
        if len(D.offsets) > max_diags:
            raise ValueError(
                f"{len(D.offsets)} diagonals > max_diags={max_diags}; "
                "DIA is the wrong format for this matrix"
            )
        n = A.shape[0]
        dtype = dtype or D.data.dtype
        # re-align scipy's column-aligned storage (data[d, c] = A[c-off, c])
        # to row-aligned (data[d, r] = A[r, r+off])
        data = np.zeros((len(D.offsets), n), dtype=np.dtype(dtype))
        for d, off in enumerate(D.offsets):
            off = int(off)
            src = D.data[d]
            if off >= 0:
                # rows r = c - off, c in [off, min(len, n))
                hi = min(src.shape[0], n)
                if hi > off:
                    data[d, : hi - off] = src[off:hi]
            else:
                hi = min(src.shape[0], n + off)
                if hi > 0:
                    data[d, -off : -off + hi] = src[:hi]
        return cls(
            data=jnp.asarray(data),
            offsets=tuple(int(o) for o in D.offsets),
            _n=n,
        )


def count_diagonals(A) -> int:
    """Number of populated diagonals of a scipy sparse matrix (cheap probe
    for format selection)."""
    coo = A.tocoo()
    return len(np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64)))
