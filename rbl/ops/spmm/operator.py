"""Linear-operator abstraction for the sparse symmetric matrix A.

The reference binds the operator to concrete CPU/GPU storage types
(SparseMatrixCSC / CuSparseMatrixCSC, dispatched at RBL.jl:74 and
RBL_gpu.jl:134).  Here the solver core is written against a single abstract
``LinearOperator`` whose implementations are JAX pytrees, so the same jitted
solver traces over any of them — dense, diagonal, matrix-free stencil, COO
segment-sum, or the Pallas BSR kernel — on any backend and under any sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _pet(dtype):
    """Accumulation dtype: accumulate sub-f32 inputs in f32."""
    return jnp.float32 if jnp.dtype(dtype).itemsize < 4 else dtype


class LinearOperator:
    """A symmetric n×n linear operator.  Subclasses are registered pytrees.

    Required:
      - ``shape`` property -> (n, n)
      - ``dtype`` property
      - ``apply(X)``: block matvec, (n, b) -> (n, b)
    """

    @property
    def shape(self):
        raise NotImplementedError

    @property
    def dtype(self):
        raise NotImplementedError

    def apply(self, X: jax.Array) -> jax.Array:
        raise NotImplementedError

    def diagonal(self):
        """The matrix diagonal as an (n,) array, or None when extraction
        is not supported (matrix-free/composite operators).  Used to build
        Jacobi preconditioners for the shift-invert inner MINRES solves
        (ops/minres.py) — a None simply disables preconditioning."""
        return None

    def __matmul__(self, X):
        return self.apply(X)

    @property
    def n(self) -> int:
        return self.shape[0]


def register_operator(cls):
    """Register an operator dataclass as a JAX pytree (array fields are
    leaves, everything else is static aux data)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    array_fields = [f.name for f in dataclasses.fields(cls) if f.metadata.get("leaf", True)]
    static_fields = [f for f in fields if f not in array_fields]

    def flatten(op):
        children = tuple(getattr(op, f) for f in array_fields)
        aux = tuple(getattr(op, f) for f in static_fields)
        return children, aux

    def unflatten(aux, children):
        kw = dict(zip(array_fields, children))
        kw.update(dict(zip(static_fields, aux)))
        return cls(**kw)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def static_field(**kw):
    return dataclasses.field(metadata={"leaf": False}, **kw)


def cast_operator(op, dtype):
    """An operator equal to ``op`` with every floating array leaf (and
    any static ``_dtype`` field) cast to ``dtype``.

    Powers the mixed-precision inner-solve tier (ops/minres.py): casting
    the operator once and iterating in f32 with f64 defect correction.
    Works for any registered operator pytree
    (array-backed formats cast their value arrays; matrix-free stencils
    flip their static dtype)."""
    dtype = jnp.dtype(dtype)

    def cast_leaf(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return a.astype(dtype)
        return a

    new = jax.tree_util.tree_map(cast_leaf, op)
    if dataclasses.is_dataclass(new) and any(
        f.name == "_dtype" for f in dataclasses.fields(new)
    ):
        new = dataclasses.replace(new, _dtype=dtype)
    return new


@register_operator
@dataclasses.dataclass(frozen=True)
class DiagonalOperator(LinearOperator):
    """A = diag(d).  The reference's unit-test matrices are exactly this
    (Unit Testing/test.jl:17-50 builds sparse(Diagonal(a)))."""

    diag: jax.Array  # (n,)

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    @property
    def dtype(self):
        return self.diag.dtype

    def apply(self, X):
        return self.diag[:, None] * X

    def diagonal(self):
        return self.diag


@register_operator
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """A as a dense matrix — matmul.  Used for the Gram-matrix path of
    the image demo (images.jl:21-25) and as the reference oracle in tests."""

    mat: jax.Array  # (n, n)

    @property
    def shape(self):
        return self.mat.shape

    @property
    def dtype(self):
        return self.mat.dtype

    def apply(self, X):
        return jnp.dot(self.mat, X, preferred_element_type=_pet(X.dtype))

    def diagonal(self):
        return jnp.diagonal(self.mat)


@register_operator
@dataclasses.dataclass(frozen=True)
class GramOperator(LinearOperator):
    """A = BᵀB (or B·Bᵀ) of a rectangular factor B, applied matrix-free as
    two chained GEMMs — the Gram matrix is never materialized.

    The reference's image demo forms the n×n Gram densely before solving
    (images.jl:21 ``RBL(B'B, k)``); matrix-free keeps HBM at O(m·n)
    instead of O(n²) + O(m·n) and both GEMMs GEMM-shaped.  Used by
    ``rbl_svd`` (solver/svd.py)."""

    B: jax.Array  # (m, n)
    left: bool = static_field(default=False)  # True: A = B·Bᵀ (m×m)

    @property
    def shape(self):
        s = self.B.shape[0] if self.left else self.B.shape[1]
        return (s, s)

    @property
    def dtype(self):
        return self.B.dtype

    def apply(self, X):
        acc = _pet(X.dtype)
        F, S = (self.B.T, self.B) if self.left else (self.B, self.B.T)
        Y = jnp.dot(F, X, preferred_element_type=acc)
        return jnp.dot(S, Y, preferred_element_type=acc)

    def diagonal(self):
        # diag(BᵀB) = squared column norms (rows for the B·Bᵀ side)
        ax = 1 if self.left else 0
        return jnp.sum(
            jnp.square(self.B), axis=ax,
            dtype=_pet(self.B.dtype),
        ).astype(self.B.dtype)


@register_operator
@dataclasses.dataclass(frozen=True)
class FunctionOperator(LinearOperator):
    """Matrix-free operator from a user-supplied JAX-traceable function
    ``fun(X) -> A·X`` on (n, b) blocks.  The function must be symmetric as
    a linear map and pure (it is traced under jit inside the solver's
    fused sweep chunks); closure constants become compile-time constants.
    The scipy-LinearOperator migration path for matrix-free users — except
    the map stays on device instead of calling back to the host."""

    fun: Any = static_field()
    _n: int = static_field(default=0)
    _dtype: Any = static_field(default=None)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return jnp.dtype(self._dtype or jnp.float64)

    def apply(self, X):
        return self.fun(X)


@register_operator
@dataclasses.dataclass(frozen=True)
class SparseGramOperator(LinearOperator):
    """A = BᵀB (or B·Bᵀ) of a SPARSE rectangular factor B, applied
    matrix-free as two chained sparse SpMMs — neither the Gram matrix nor
    a dense copy of B is ever materialized.  The sparse upgrade of
    GramOperator for ``rbl_svd``/``svds`` on large sparse factors (the
    reference's images.jl:21 forms BᵀB densely; scipy's ``svds`` keeps B
    sparse — this is the on-device equivalent of the latter).

    Bf is the (m, n) forward factor, Bt its (n, m) transpose — both
    pre-sorted COO layouts built once at construction (coo.py
    RectCooOperator); keeping them separate avoids re-sorting triplets
    inside the hot loop."""

    Bf: Any  # RectCooOperator (m, n)
    Bt: Any  # RectCooOperator (n, m)
    left: bool = static_field(default=False)  # True: A = B·Bᵀ (m×m)

    @property
    def shape(self):
        s = self.Bf.shape[0] if self.left else self.Bf.shape[1]
        return (s, s)

    @property
    def dtype(self):
        return self.Bf.dtype

    def apply(self, X):
        if self.left:
            return self.Bf.apply(self.Bt.apply(X))
        return self.Bt.apply(self.Bf.apply(X))

    def diagonal(self):
        # diag(BᵀB)_j = Σ_{nnz with col j} val² (rows for the B·Bᵀ side);
        # COO pad slots carry val 0, so they contribute nothing
        if self.left:
            idx, n = self.Bf.rows, self.Bf.shape[0]
            sorted_ = True  # Bf triplets are row-sorted
        else:
            idx, n = self.Bf.cols, self.Bf.shape[1]
            sorted_ = False
        return jax.ops.segment_sum(
            jnp.square(self.Bf.vals), idx, num_segments=n,
            indices_are_sorted=sorted_,
        )

    @classmethod
    def from_scipy(cls, B, dtype=None, left: bool = False):
        from .coo import RectCooOperator

        Bf = RectCooOperator.from_scipy(B, dtype=dtype)
        return cls(Bf=Bf, Bt=Bf.transpose(), left=left)


@register_operator
@dataclasses.dataclass(frozen=True)
class AffineOperator(LinearOperator):
    """α·A + β·I of a base operator — the spectral-shift combinator behind
    ``rbl(..., which="LA"/"SA")`` (solver/rbl.py): shifting by β ≥ ‖A‖₂
    moves the algebraic extreme of the spectrum to the magnitude extreme,
    which is what Lanczos converges to.  α and β are 0-d arrays (pytree
    leaves), so different shifts reuse the same compiled solver."""

    base: LinearOperator
    alpha: jax.Array  # 0-d scalar
    beta: jax.Array   # 0-d scalar

    @classmethod
    def shift(cls, base, alpha: float, beta: float):
        dt = base.dtype
        return cls(
            base=base,
            alpha=jnp.asarray(alpha, dtype=dt),
            beta=jnp.asarray(beta, dtype=dt),
        )

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def apply(self, X):
        return self.alpha * self.base.apply(X) + self.beta * X

    def diagonal(self):
        d = self.base.diagonal()
        return None if d is None else self.alpha * d + self.beta


@register_operator
@dataclasses.dataclass(frozen=True)
class Laplacian2D(LinearOperator):
    """Matrix-free 5-point 2D Laplacian stencil on an nx×ny grid
    (Dirichlet).  n = nx*ny.  Matrix-free 'sparse' operator: the stencil
    is pure shifts/adds — no gathers.

    Layout note: the block is processed as a FOLDED (nx, ny·b) 2-D view,
    so the minor dimension is ny·b wide rather than b.  y-neighbors become
    ±b shifts of a zero-padded row (the zero pad IS the Dirichlet
    boundary), x-neighbors row shifts."""

    nx: int = static_field()
    ny: int = static_field()
    _dtype: Any = static_field(default=jnp.float64)

    @property
    def shape(self):
        return (self.nx * self.ny, self.nx * self.ny)

    @property
    def dtype(self):
        return jnp.dtype(self._dtype)

    def apply(self, X):
        b = X.shape[1]
        G = X.reshape(self.nx, self.ny * b)
        Gx = jnp.pad(G, ((1, 1), (0, 0)))
        Gy = jnp.pad(G, ((0, 0), (b, b)))
        out = 4.0 * G - Gx[:-2] - Gx[2:] - Gy[:, : -2 * b] - Gy[:, 2 * b :]
        return out.reshape(self.nx * self.ny, b)

    def diagonal(self):
        return jnp.full((self.n,), 4.0, dtype=self.dtype)


@register_operator
@dataclasses.dataclass(frozen=True)
class Laplacian3D(LinearOperator):
    """Matrix-free 7-point 3D Laplacian on an nx×ny×nz grid (Dirichlet)."""

    nx: int = static_field()
    ny: int = static_field()
    nz: int = static_field()
    _dtype: Any = static_field(default=jnp.float64)

    @property
    def shape(self):
        n = self.nx * self.ny * self.nz
        return (n, n)

    @property
    def dtype(self):
        return jnp.dtype(self._dtype)

    def apply(self, X):
        # folded (nx, ny, nz·b) layout — see Laplacian2D.apply
        b = X.shape[1]
        G = X.reshape(self.nx, self.ny, self.nz * b)
        Gx = jnp.pad(G, ((1, 1), (0, 0), (0, 0)))
        Gy = jnp.pad(G, ((0, 0), (1, 1), (0, 0)))
        Gz = jnp.pad(G, ((0, 0), (0, 0), (b, b)))
        out = (
            6.0 * G
            - Gx[:-2] - Gx[2:]
            - Gy[:, :-2] - Gy[:, 2:]
            - Gz[:, :, : -2 * b] - Gz[:, :, 2 * b :]
        )
        return out.reshape(-1, b)

    def diagonal(self):
        return jnp.full((self.n,), 6.0, dtype=self.dtype)


# Per-apply costs of the sparse layouts on an H100, f32, b=8, from
# ``benchmarks/spmm_bench.py --router`` (FEM stiffness matrices of
# n ≈ 230 k in natural, two-field, RCM and shuffled RCM orders; 400 W
# limit): the BSR kernel costs 2.5–2.7 ps per stored tile entry at fills
# from 0.019 to 0.187, the ELL scan 53–58 ps per nonzero.  So the kernel
# beats ELL above a tile fill of ~0.047: measured, it won at fill 0.050
# (0.913 against 0.973 ms) and lost at 0.032 (1.389 against 1.005 ms).
# DIA costs 5.4–5.9 ps per stored diagonal entry up to 160 diagonals,
# then XLA's fused apply falls off a cliff: 0.198 ms at 160 diagonals,
# 0.528 ms at 176, 2.38 ms at 192, 5.59 ms at 256 (n = 228,888; the
# sweep in the same script, 700 W limit).
_KERNEL_S_PER_TILE_ENTRY = 2.6e-12
_ELL_S_PER_NNZ = 55e-12
_DIA_S_PER_ENTRY = 5.8e-12
_DIA_MAX_DIAGONALS = 160


def _pick_sparse_format(A, dtype):
    """Choose the layout for a scipy sparse matrix: the cheapest by the
    measured per-entry costs above.

    DIA (static shifted adds, no gathers) is a candidate up to
    _DIA_MAX_DIAGONALS populated diagonals; the BSR kernel for f32 and
    bf16 operators where it runs compiled (the GPU); the gather formats
    always — HYB under skewed row lengths, else the ELL scan.  Returns
    (format, (bm, bk) plan or None)."""
    import numpy as _np

    from ...backend import interpret_mode
    from .dia import count_diagonals

    costs = {"gather": _ELL_S_PER_NNZ * A.nnz}
    n_diag = count_diagonals(A)
    if n_diag <= _DIA_MAX_DIAGONALS:
        costs["dia"] = _DIA_S_PER_ENTRY * n_diag * A.shape[0]
    # the operator is built at dtype or, when unspecified, A's own dtype —
    # an f32/bf16 matrix with dtype=None must still reach the BSR branch
    itemsize = jnp.dtype(dtype if dtype is not None else A.dtype).itemsize
    plan = None
    if itemsize <= 4 and not interpret_mode():
        from .pallas_bsr import pick_tile_plan, tile_fill

        plan = pick_tile_plan(A)
        costs["bsr"] = (_KERNEL_S_PER_TILE_ENTRY * A.nnz
                        / max(tile_fill(A, *plan), 1e-12))
    fmt = min(costs, key=costs.get)
    if fmt != "gather":
        return fmt, plan if fmt == "bsr" else None
    # ELL pads every row to the max row nnz: under row-length skew
    # (power-law graphs, a few dense rows) that multiplies memory and scan
    # length by the skew factor — route to HYB (capped ELL + COO overflow)
    row_nnz = _np.diff(A.tocsr().indptr)
    if row_nnz.size and row_nnz.max() > 4 * max(row_nnz.mean(), 1.0):
        return "hyb", None
    return "ell", None


def as_operator(A, dtype=None, format: str = "auto") -> LinearOperator:
    """Coerce a user-supplied matrix into a LinearOperator.

    Accepts: LinearOperator (returned as-is), dense ndarray/jax array,
    scipy.sparse matrix, ``jax.experimental.sparse`` BCOO/BCSR (converted
    through scipy triplets so the same format auto-selection applies),
    1-D array (diagonal).  Sparse matrices pick their layout
    automatically ("auto"): DIA for banded, the BSR kernel for
    block-structured (GPU, ≤f32), HYB for skewed row-length
    distributions, ELL otherwise; or force one with
    format="dia" | "bsr" | "ell" | "hyb" | "coo".
    """
    if isinstance(A, LinearOperator):
        # honor an explicit dtype request: a mismatched operator dtype
        # poisons downstream lax.while_loop carries with promotions
        # (e.g. an f64 DiagonalOperator mass under an f32 solve)
        if dtype is not None and jnp.dtype(A.dtype) != jnp.dtype(dtype):
            return cast_operator(A, dtype)
        return A
    if (
        type(A).__module__.startswith("jax.experimental.sparse")
        and hasattr(A, "todense")
    ):  # BCOO / BCSR: route through scipy COO triplets (host-side,
        #   one-time) so the structure probe + layout auto-pick apply
        import scipy.sparse as _sp

        Ac = A.to_bcoo() if hasattr(A, "to_bcoo") else A  # BCSR → BCOO
        if getattr(Ac, "n_batch", 0) or getattr(Ac, "n_dense", 0):
            raise TypeError(
                "batched/block BCOO not supported — pass an unbatched 2-D "
                "matrix (n_batch == n_dense == 0)"
            )
        idx = np.asarray(Ac.indices)
        dat = np.asarray(Ac.data)
        # BCOO pads its nse slots with out-of-range or duplicate indices
        # and zero data; drop them (scipy's tocsr sums any remaining dupes)
        live = (
            (dat != 0)
            & (idx[:, 0] < Ac.shape[0])
            & (idx[:, 1] < Ac.shape[1])
        )
        A = _sp.coo_matrix(
            (dat[live], (idx[live, 0], idx[live, 1])), shape=Ac.shape
        ).tocsr()
    if hasattr(A, "tocsr"):  # scipy.sparse
        if (
            format == "auto"
            and A.shape[0] == A.shape[1]
            and A.nnz <= A.shape[0]  # cheap screen: diagonal ⇒ nnz ≤ n
        ):
            # exactly-diagonal matrix → DiagonalOperator: cheaper applies
            # than any sparse layout AND the exact fast paths keyed on it
            # (rbl_generalized's degree-0 M^{±1/2}, reference test
            # matrices are sparse(Diagonal(...)) — test.jl:17-50)
            import scipy.sparse as _sp

            coo = _sp.coo_matrix(A)
            if coo.nnz == 0 or bool(np.all(coo.row == coo.col)):
                d = np.zeros(A.shape[0], dtype=coo.data.dtype)
                np.add.at(d, coo.row, coo.data)
                return DiagonalOperator(
                    jnp.asarray(d, dtype=dtype or d.dtype)
                )
        plan = None
        if format == "auto":
            fmt, plan = _pick_sparse_format(A, dtype)
        else:
            fmt = format
        if fmt == "dia":
            from .dia import DiaOperator

            return DiaOperator.from_scipy(A, dtype=dtype)
        if fmt == "bsr":
            from .pallas_bsr import BlockSparseOperator

            bm, bk = plan or (None, None)
            return BlockSparseOperator.from_scipy(
                A, dtype=dtype or jnp.float32, bm=bm, bk=bk
            )
        if fmt == "hyb":
            from .coo import HybOperator

            return HybOperator.from_scipy(A, dtype=dtype)
        if fmt == "coo":
            from .coo import CooOperator

            return CooOperator.from_scipy(A, dtype=dtype)
        from .ell import SparseEllOperator

        return SparseEllOperator.from_scipy(A.tocsr(), dtype=dtype)
    A = jnp.asarray(A, dtype=dtype)
    if A.ndim == 1:
        return DiagonalOperator(A)
    if A.ndim == 2:
        return DenseOperator(A)
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")
