"""Smoothed-aggregation algebraic multigrid for ASSEMBLED sparse SPD
matrices — the preconditioner tier for the FEM benchmark class.

The structured-stencil tiers (ops/fdm.py exact solves, ops/multigrid.py
separable V-cycles) do not apply to assembled matrices (SuiteSparse
ldoor/hood class; in this repo `utils.fem.fem_elasticity_3d`), and scalar
Jacobi does almost nothing for elasticity: a fem3d-16 vibration solve
(`eigsh(A, M=diag, sigma=0)`) under Jacobi-preconditioned inner MINRES
ran orders of magnitude longer than scipy's factorized shift-invert.  This
module closes that gap without ever factorizing A.

Construction (host, scipy — one-time, O(nnz)):

1. **Block compression**: nodes of ``dof`` unknowns (elasticity: 3); the
   strength graph uses Frobenius norms of the 3×3 coupling blocks,
   normalized by the diagonal blocks.
2. **Greedy aggregation** (Vanek-style): each aggregate is a seed node
   plus its strong neighbors (≈ 3³ nodes for a 27-point FEM stencil —
   the algebraic analogue of 3× geometric coarsening per axis).
3. **Tentative prolongator**: the near-nullspace restricted to each
   aggregate, orthonormalized per aggregate (translations by default;
   pass ``near_nullspace=rigid_body_modes(coords)`` for the full 6-mode
   elasticity kernel — rotations matter for beam-like meshes).
4. **Prolongator smoothing**: P = (I − ω D⁻¹A) P_tent with
   ω = 4/(3·λ̂max(D⁻¹A)) — the standard SA choice; this is what turns
   piecewise-constant aggregation (V-cycle ρ → 1 with depth) into a
   mesh-independent method.
5. **Galerkin RAP** per level until the coarsest fits a dense inverse.

Apply (device, jitted): a symmetric V(ν,ν) cycle — damped BLOCK-Jacobi
smoothing (the 3×3 block inverses are baked constants; an einsum over
the dof axis), level operators through the normal ``as_operator`` router
(DIA / packed-BSR Pallas kernels), transfers through
``RectCooOperator``/its transpose, dense coarsest solve.  Equal pre/post
smoothing and R = Pᵀ make the cycle SPD — the PMINRES requirement.

Used by the shift-invert operators via their ``psolve`` hook
(ops/minres.py, ops/generalized.py) and auto-built by ``eigsh`` when the
operand arrives as a scipy sparse matrix (compat.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

__all__ = [
    "AssembledMultigrid",
    "detect_dof_blocks",
    "rigid_body_modes",
    "block_jacobi_psolve",
]


# ---------------------------------------------------------------------------
# host-side building blocks
# ---------------------------------------------------------------------------


def detect_dof_blocks(A: sp.spmatrix, candidates=(3, 2, 6)) -> int:
    """Detect a nodal block size from the sparsity pattern: ``d`` wins if
    rows d·t … d·t+d−1 reference the same column-node set (sampled).
    Returns 1 when nothing matches."""
    A = A.tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    for d in candidates:
        if n % d:
            continue
        nodes = rng.integers(0, n // d, size=min(64, n // d))
        ok = True
        for t in nodes:
            sets = [
                np.unique(A.indices[A.indptr[d * t + r]:
                                    A.indptr[d * t + r + 1]] // d)
                for r in range(d)
            ]
            if any(len(s) != len(sets[0]) or np.any(s != sets[0])
                   for s in sets[1:]):
                ok = False
                break
        if ok:
            return d
    return 1


def rigid_body_modes(coords: np.ndarray, dof: int = 3) -> np.ndarray:
    """Near-nullspace for elasticity: 3 translations + 3 rotations from
    node coordinates (n_nodes, 3) → (n_nodes·dof, 6).  For dof=2:
    2 translations + 1 rotation."""
    coords = np.asarray(coords, dtype=np.float64)
    nn = coords.shape[0]
    if dof == 3:
        B = np.zeros((nn, 3, 6))
        B[:, 0, 0] = B[:, 1, 1] = B[:, 2, 2] = 1.0
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        # rotations about z, x, y
        B[:, 0, 3], B[:, 1, 3] = -y, x
        B[:, 1, 4], B[:, 2, 4] = -z, y
        B[:, 2, 5], B[:, 0, 5] = -x, z
        return B.reshape(nn * 3, 6)
    if dof == 2:
        B = np.zeros((nn, 2, 3))
        B[:, 0, 0] = B[:, 1, 1] = 1.0
        B[:, 0, 2], B[:, 1, 2] = -coords[:, 1], coords[:, 0]
        return B.reshape(nn * 2, 3)
    raise ValueError(f"dof={dof} not supported (2 or 3)")


def _node_strength_graph(A: sp.csr_matrix, dof: int) -> sp.csr_matrix:
    """Frobenius norms of the dof×dof coupling blocks, diagonally
    normalized: s_ij = ‖A_ij‖_F / √(‖A_ii‖_F ‖A_jj‖_F)."""
    C = A.tocoo()
    ni, nj = C.row // dof, C.col // dof
    nn = A.shape[0] // dof
    W = sp.coo_matrix((C.data ** 2, (ni, nj)), shape=(nn, nn)).tocsr()
    W.data = np.sqrt(W.data)
    d = np.sqrt(W.diagonal())
    d[d == 0] = 1.0
    Dinv = sp.diags(1.0 / d)
    S = (Dinv @ W @ Dinv).tocsr()
    S.setdiag(0.0)
    S.eliminate_zeros()
    return S


def _aggregate(S: sp.csr_matrix, theta: float) -> np.ndarray:
    """Vanek greedy aggregation on the strength graph.  Returns agg id
    per node (every node assigned)."""
    nn = S.shape[0]
    # strong neighbor lists
    agg = np.full(nn, -1, dtype=np.int64)
    indptr, indices, data = S.indptr, S.indices, S.data
    # pass 1: seed aggregates from fully-unaggregated strong neighborhoods
    na = 0
    for i in range(nn):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr = indices[sl][data[sl] >= theta]
        if np.all(agg[nbr] == -1):
            agg[i] = na
            agg[nbr] = na
            na += 1
    # pass 2: attach leftovers to the strongest neighboring aggregate
    for i in range(nn):
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbr, w = indices[sl], data[sl]
        cand = agg[nbr] != -1
        if np.any(cand):
            agg[i] = agg[nbr[cand][np.argmax(w[cand])]]
        else:
            agg[i] = na  # isolated node: its own aggregate
            na += 1
    return agg


def _tentative_prolongator(agg: np.ndarray, B: np.ndarray, dof: int):
    """Per-aggregate orthonormalization of the near-nullspace: returns
    (P_tent sparse (n × na·nb), B_coarse (na·nb, nb), agg_meta) —
    ``agg_meta = (Qpad, perm_padded, posinv)`` is the PERMUTED-AGGREGATE
    device layout of P_tent: fine dofs grouped by aggregate and padded
    to the max aggregate size, so the device apply is ONE row gather
    plus a batched (na, s_max, nb) contraction instead of nnz-scale COO
    gathers (see _AggTransfer)."""
    nn = agg.shape[0]
    n = nn * dof
    na = int(agg.max()) + 1
    nb = B.shape[1]
    order = np.argsort(agg, kind="stable")
    bounds = np.searchsorted(agg[order], np.arange(na + 1))
    Bc = np.zeros((na * nb, nb))
    s_max = int((np.diff(bounds)).max()) * dof
    Qpad = np.zeros((na, s_max, nb))
    perm_padded = np.full(na * s_max, n, dtype=np.int32)  # n → zero row
    posinv = np.zeros(n, dtype=np.int32)
    rlist, clist, vlist = [], [], []
    for a in range(na):
        nodes = order[bounds[a]:bounds[a + 1]]
        dofs = (nodes[:, None] * dof + np.arange(dof)).ravel()
        m = dofs.shape[0]
        Q, Rf = np.linalg.qr(B[dofs])  # (m, k), (k, nb); k = min(m, nb)
        if Q.shape[1] < nb:  # tiny aggregate: pad (coarse cols stay 0)
            Q = np.pad(Q, ((0, 0), (0, nb - Q.shape[1])))
            Rf = np.pad(Rf, ((0, nb - Rf.shape[0]), (0, 0)))
        rlist.append(np.repeat(dofs, nb))
        clist.append(np.tile(a * nb + np.arange(nb), m))
        vlist.append(Q.ravel())
        Bc[a * nb : (a + 1) * nb] = Rf
        Qpad[a, :m] = Q
        perm_padded[a * s_max : a * s_max + m] = dofs
        posinv[dofs] = a * s_max + np.arange(m)
    rows = np.concatenate(rlist)
    cols = np.concatenate(clist)
    vals = np.concatenate(vlist)
    P = sp.coo_matrix((vals, (rows, cols)), shape=(n, na * nb)).tocsr()
    return P, Bc, (Qpad, perm_padded, posinv)


def _lambda_max_dinv_a(A: sp.csr_matrix, it: int = 12) -> float:
    """Power estimate of λmax(D⁻¹A) (scalar diagonal)."""
    d = A.diagonal().copy()
    d[d == 0] = 1.0
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(it):
        x = (A @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        lam, x = nrm, x / nrm
    return float(lam)


def _block_diag_inv(A: sp.csr_matrix, dof: int, omega: float) -> np.ndarray:
    """ω · (block diag of A)⁻¹ as (n_nodes, dof, dof)."""
    nn = A.shape[0] // dof
    C = A.tocoo()
    mask = (C.row // dof) == (C.col // dof)
    r, c, v = C.row[mask], C.col[mask], C.data[mask]
    D = np.zeros((nn, dof, dof))
    D[r // dof, r % dof, c % dof] = v
    # regularize empty/singular blocks
    for i in range(dof):
        zero = D[:, i, i] == 0
        D[zero, i, i] = 1.0
    return omega * np.linalg.inv(D)


def block_jacobi_psolve(A: sp.spmatrix, dof: Optional[int] = None):
    """Plain damped block-Jacobi psolve (the sub-AMG tier): SPD for SPD
    A.  ``dof`` defaults to pattern detection."""
    A = sp.csr_matrix(A)
    if dof is None:
        dof = detect_dof_blocks(A)
    Winv = jnp.asarray(_block_diag_inv(A, dof, 1.0))

    def psolve(X):
        nn = Winv.shape[0]
        Xr = X.reshape(nn, dof, -1)
        Y = jnp.einsum(
            "nij,njb->nib", Winv.astype(X.dtype), Xr,
            preferred_element_type=X.dtype,
        )
        return Y.reshape(X.shape)

    return psolve


# ---------------------------------------------------------------------------
# the multigrid hierarchy
# ---------------------------------------------------------------------------


class _AMGLevel:
    def __init__(self, A: sp.csr_matrix, dof: int, omega: float, dtype):
        from .spmm.operator import as_operator

        self.n = A.shape[0]
        self.dof = dof
        self.op = as_operator(A, dtype=dtype)
        self.Winv = jnp.asarray(
            _block_diag_inv(A, dof, omega), dtype=dtype
        )

    def smooth_apply(self, X):
        nn = self.Winv.shape[0]
        Xr = X.reshape(nn, self.dof, -1)
        Y = jnp.einsum(
            "nij,njb->nib", self.Winv.astype(X.dtype), Xr,
            preferred_element_type=X.dtype,
        )
        return Y.reshape(X.shape)


class _CooTransfer:
    """Generic sparse transfer pair via RectCooOperator — the portable
    fallback (nnz-scale segment sums; gather-bound)."""

    def __init__(self, P: sp.csr_matrix, dtype):
        from .spmm.coo import RectCooOperator

        self.P = RectCooOperator.from_scipy(P, dtype=dtype)
        self.R = self.P.transpose()

    def prolong(self, C):
        return self.P.apply(C)

    def restrict(self, F):
        return self.R.apply(F)


class _AggTransfer:
    """Smoothed-aggregation transfer pair in the PERMUTED-AGGREGATE
    device layout: P = (I − ω D⁻¹A) P_t applied as the tentative
    aggregate contraction (one (n, b) row gather + one batched
    (na, s_max, nb) matmul — fine dofs pre-sorted by aggregate and
    padded to the max aggregate size) followed by one LEVEL-OPERATOR
    apply (the fast DIA/BSR kernel) for the smoothing term.  Replaces
    nnz-scale COO segment sums, which are gather- and scatter-bound."""

    def __init__(self, agg_meta, level_op, dinv: np.ndarray, w: float,
                 nc: int, dtype):
        Qpad, perm_padded, posinv = agg_meta
        self.Qpad = jnp.asarray(Qpad, dtype=dtype)
        self.perm = jnp.asarray(perm_padded)   # (na*s_max,) → [0..n]
        self.posinv = jnp.asarray(posinv)      # (n,) → padded slot
        self.op = level_op
        self.dinv = jnp.asarray(dinv, dtype=dtype)
        self.w = float(w)
        self.nc = nc

    def _pt(self, C):
        na, s_max, nb = self.Qpad.shape
        C3 = C.reshape(na, nb, -1)
        Ypad = jnp.einsum(
            "asn,anb->asb", self.Qpad.astype(C.dtype), C3,
            preferred_element_type=C.dtype,
        ).reshape(na * s_max, -1)
        return jnp.take(Ypad, self.posinv, axis=0)

    def _pt_T(self, F):
        na, s_max, nb = self.Qpad.shape
        Fz = jnp.concatenate([F, jnp.zeros_like(F[:1])], axis=0)
        Xpad = jnp.take(Fz, self.perm, axis=0).reshape(na, s_max, -1)
        return jnp.einsum(
            "asn,asb->anb", self.Qpad.astype(F.dtype), Xpad,
            preferred_element_type=F.dtype,
        ).reshape(self.nc, -1)

    def prolong(self, C):
        y = self._pt(C)
        return y - self.w * self.dinv.astype(y.dtype)[:, None] \
            * self.op.apply(y)

    def restrict(self, F):
        t = F - self.w * self.op.apply(
            self.dinv.astype(F.dtype)[:, None] * F
        )
        return self._pt_T(t)


class _GridTransfer:
    """Separable per-axis transfer on a node grid: dense (m_f, m_c)
    factor matmuls over each grid axis (GEMM work, no gathers).  The
    last array axis keeps dof·b folded."""

    def __init__(self, fine_dims, coarse_dims, P1s, dof):
        self.fine_dims = tuple(fine_dims)
        self.coarse_dims = tuple(coarse_dims)
        self.P1s = [np.asarray(P) for P in P1s]  # per-axis (m_f, m_c)
        self.dof = dof

    def prolong(self, C):
        b = C.shape[1]
        G = C.reshape(self.coarse_dims + (self.dof * b,))
        pet = G.dtype
        p0, p1, p2 = (jnp.asarray(P, dtype=pet) for P in self.P1s)
        G = jnp.einsum("ip,pjkc->ijkc", p0, G, preferred_element_type=pet)
        G = jnp.einsum("jq,iqkc->ijkc", p1, G, preferred_element_type=pet)
        G = jnp.einsum("kr,ijrc->ijkc", p2, G, preferred_element_type=pet)
        return G.reshape(-1, b)

    def restrict(self, F):
        b = F.shape[1]
        G = F.reshape(self.fine_dims + (self.dof * b,))
        pet = G.dtype
        p0, p1, p2 = (jnp.asarray(P, dtype=pet) for P in self.P1s)
        G = jnp.einsum("pi,pjkc->ijkc", p0, G, preferred_element_type=pet)
        G = jnp.einsum("qj,iqkc->ijkc", p1, G, preferred_element_type=pet)
        G = jnp.einsum("rk,ijrc->ijkc", p2, G, preferred_element_type=pet)
        return G.reshape(-1, b)


def _grid_prolong_1d(m: int) -> np.ndarray:
    """Node-grid coarsening keeping every other node (works for any m):
    coarse t ↔ fine 2t; odd fine nodes average their coarse neighbors
    (or inject when the right neighbor falls off the grid)."""
    mc = (m + 1) // 2
    P = np.zeros((m, mc))
    for t in range(mc):
        P[2 * t, t] = 1.0
    for f in range(1, m, 2):
        t = f // 2
        if t + 1 < mc:
            P[f, t] = P[f, t + 1] = 0.5
        else:
            P[f, t] = 1.0
    return P


class AssembledMultigrid:
    """Multigrid V-cycle for an assembled sparse SPD matrix.  See module
    docstring; construct via :meth:`smoothed_aggregation` (algebraic,
    any SPD matrix) or :meth:`from_grid` (grid-structured meshes — fast
    separable transfers), apply via :meth:`psolve` (SPD — usable as the
    ``psolve`` hook of the shift-invert operators and
    ``block_minres``)."""

    def __init__(self, levels, transfers, coarse_inv, nu, dtype):
        self.levels = levels            # list[_AMGLevel]
        self.transfers = transfers      # list[_CooTransfer|_GridTransfer]
        self.coarse_inv = coarse_inv    # numpy (nc, nc)
        self.nu = nu
        self._jit = None

    @classmethod
    def smoothed_aggregation(
        cls,
        A,
        dof: Optional[int] = None,
        near_nullspace: Optional[np.ndarray] = None,
        theta: float = 0.05,
        nu: int = 1,
        omega: float = 0.6,
        coarsest_n: int = 1500,
        max_levels: int = 12,
        dtype=jnp.float64,
    ) -> "AssembledMultigrid":
        """Build the hierarchy from a scipy sparse SPD matrix.

        dof: unknowns per node (default: pattern detection).
        near_nullspace: (n, nb) modes the coarse spaces must represent
            exactly (default: per-dof translations; pass
            ``rigid_body_modes(coords)`` for elasticity with rotations).
        theta: strength threshold on the normalized block graph.
        omega: block-Jacobi smoother damping.
        """
        A = sp.csr_matrix(A).astype(np.float64)
        if dof is None:
            dof = detect_dof_blocks(A)
        if near_nullspace is None:
            nn = A.shape[0] // dof
            B = np.zeros((A.shape[0], dof))
            for c in range(dof):
                B[c::dof, c] = 1.0
        else:
            B = np.asarray(near_nullspace, dtype=np.float64)
        levels = []
        transfers = []
        Al, Bl, dofl = A, B, dof
        for _ in range(max_levels):
            if Al.shape[0] <= coarsest_n:
                break
            levels.append(_AMGLevel(Al, dofl, omega, dtype))
            S = _node_strength_graph(Al, dofl)
            agg = _aggregate(S, theta)
            Pt, Bc, agg_meta = _tentative_prolongator(agg, Bl, dofl)
            # prolongator smoothing: P = (I − ω_P D⁻¹A) P_tent
            lam = _lambda_max_dinv_a(Al)
            w_p = 4.0 / (3.0 * lam)
            d = Al.diagonal().copy()
            d[d == 0] = 1.0
            Dinv = sp.diags(1.0 / d)
            P = (Pt - w_p * (Dinv @ (Al @ Pt))).tocsr()
            transfers.append(_AggTransfer(
                agg_meta, levels[-1].op, 1.0 / d, w_p, Pt.shape[1], dtype
            ))
            Al = (P.T @ Al @ P).tocsr()
            Al.sum_duplicates()
            Bl, dofl = Bc, B.shape[1]  # coarse "nodes" carry nb dofs
        # pinv: a rank-deficient tentative space (tiny aggregates padded
        # with zero columns) can leave null coarse directions; the cycle
        # stays PD through the smoother term
        coarse_inv = np.linalg.pinv(Al.toarray())
        return cls(levels, transfers, coarse_inv, nu, dtype)

    @classmethod
    def from_grid(
        cls,
        A,
        node_dims,
        dof: int = 3,
        nu: int = 1,
        omega: float = 0.6,
        coarsest_n: int = 1500,
        max_levels: int = 12,
        dtype=jnp.float64,
    ) -> "AssembledMultigrid":
        """Geometric hierarchy for a matrix assembled on a regular node
        grid (the FEM benchmark class — ``utils.fem.fem_elasticity_3d``
        after clamping is a full box of nodes).

        node_dims: (d0, d1, d2) node counts with node id =
            (k0·d1 + k1)·d2 + k2 (the assembler's ordering: last axis
            fastest).
        Transfers are per-axis linear interpolation (dense axis matmuls
        on device — GEMMs, no gathers); level operators are assembled
        Galerkin RAP (scipy, at construction), applied through the
        normal sparse-operator router.  Trilinear P reproduces linear
        fields, so all 6 elasticity rigid-body modes transfer exactly —
        no near-nullspace input needed."""
        A = sp.csr_matrix(A).astype(np.float64)
        dims = tuple(int(x) for x in node_dims)
        if int(np.prod(dims)) * dof != A.shape[0]:
            raise ValueError(
                f"node_dims {dims} x dof {dof} != n {A.shape[0]}"
            )
        levels = []
        transfers = []
        Al, dl = A, dims
        for _ in range(max_levels):
            if Al.shape[0] <= coarsest_n or min(dl) < 3:
                break
            levels.append(_AMGLevel(Al, dof, omega, dtype))
            P1s = [_grid_prolong_1d(m) for m in dl]
            cdl = tuple(P.shape[1] for P in P1s)
            transfers.append(_GridTransfer(dl, cdl, P1s, dof))
            Pn = sp.kron(
                sp.kron(sp.csr_matrix(P1s[0]), sp.csr_matrix(P1s[1])),
                sp.csr_matrix(P1s[2]),
            )
            P = sp.kron(Pn, sp.identity(dof, format="csr")).tocsr()
            Al = (P.T @ Al @ P).tocsr()
            Al.sum_duplicates()
            dl = cdl
        coarse_inv = np.linalg.pinv(Al.toarray())
        return cls(levels, transfers, coarse_inv, nu, dtype)

    # -- device apply -------------------------------------------------

    def _vcycle(self, lvl: int, R):
        if lvl == len(self.levels):
            ci = jnp.asarray(self.coarse_inv, dtype=R.dtype)
            return ci @ R
        level = self.levels[lvl]
        E = level.smooth_apply(R)
        for _ in range(self.nu - 1):
            E = E + level.smooth_apply(R - level.op.apply(E))
        resid = R - level.op.apply(E)
        rc = self.transfers[lvl].restrict(resid)
        Ec = self._vcycle(lvl + 1, rc)
        E = E + self.transfers[lvl].prolong(Ec)
        for _ in range(self.nu):
            E = E + level.smooth_apply(R - level.op.apply(E))
        return E

    def psolve(self, X):
        """One symmetric V-cycle ≈ A⁻¹ on an (n, b) block (SPD; jitted —
        see ops/multigrid.py on why eager XLA:CPU is avoided)."""
        if self._jit is None:
            self._jit = jax.jit(lambda X: self._vcycle(0, X))
        return self._jit(X)
