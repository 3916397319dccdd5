"""Row-partitioned distributed SpMM with halo exchange.

Multi-device replacement for the reference's single-GPU CuSPARSE SpMM +
host↔device streaming (RBL_gpu.jl:152,176 and hybrid_part_reorth's copyto!
loop): A's rows live on a 1-D "rows" mesh; applying a stencil/banded
operator needs only the neighbor devices' boundary rows, moved with
``jax.lax.ppermute`` over NVLink (the sparse analogue of ring/context
parallelism — SURVEY §2c).  Non-circular permutes deliver zeros at the mesh
edges, which is exactly the Dirichlet boundary.

For general sparse matrices there are two tiers:

- ``ShardedBlockSparseOperator`` — the flagship path: block rows banded over
  the mesh, the Pallas BSR kernel applied per device, and a *boundary-only*
  ghost-block exchange (one ``ppermute`` per mesh shift that actually
  carries coupling, with per-shift slabs precomputed host-side from the
  static block-column lists).  Comm volume ∝ boundary nnz, not n.
- ``ShardedEllSpMM`` / ``ShardedCooSpMM`` — general sparse at ROW
  granularity: the same boundary-only exchange built from the column
  index sets (``_row_ghost_plan``), auto-falling back to an all-gather
  of the full (n, b) block only when the sparsity has no exploitable
  locality (ghost volume ≥ half the all-gather's).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.spmm.operator import LinearOperator, register_operator, static_field
from ..backend import interpret_mode
from ..ops.spmm.pallas_bsr import bsr_apply, bsr_from_scipy, pick_tile_plan


@register_operator
@dataclasses.dataclass(frozen=True)
class ShardedLaplacian2D(LinearOperator):
    """5-point 2D Laplacian with grid rows slabbed across the mesh's
    "rows" axis.  apply() runs under shard_map: local stencil plus a
    two-neighbor ppermute halo exchange of one grid row each way."""

    nx: int = static_field()
    ny: int = static_field()
    mesh: Mesh = static_field(default=None)
    axis: str = static_field(default="rows")
    _dtype: Any = static_field(default=jnp.float32)

    @property
    def shape(self):
        n = self.nx * self.ny
        return (n, n)

    @property
    def dtype(self):
        return jnp.dtype(self._dtype)

    def apply(self, X):
        ndev = self.mesh.shape[self.axis]
        if self.nx % ndev:
            raise ValueError(
                f"nx={self.nx} not divisible by mesh axis size {ndev}"
            )
        nx_local = self.nx // ndev
        ny = self.ny

        def local_apply(x_slab):
            # x_slab: (nx_local*ny, b) — this device's slab of grid rows,
            # processed in the folded (nx_local, ny·b) full-lane layout
            # (see Laplacian2D.apply)
            b = x_slab.shape[1]
            G = x_slab.reshape(nx_local, ny * b)
            fwd = [(i, i + 1) for i in range(ndev - 1)]
            bwd = [(i + 1, i) for i in range(ndev - 1)]
            # halo rows from the neighbors (zeros at the mesh edges)
            halo_lo = jax.lax.ppermute(G[-1], self.axis, perm=fwd)
            halo_hi = jax.lax.ppermute(G[0], self.axis, perm=bwd)
            up = jnp.concatenate([halo_lo[None], G[:-1]], axis=0)
            down = jnp.concatenate([G[1:], halo_hi[None]], axis=0)
            Gy = jnp.pad(G, ((0, 0), (b, b)))
            out = 4.0 * G - up - down - Gy[:, : -2 * b] - Gy[:, 2 * b :]
            return out.reshape(nx_local * ny, b)

        return jax.shard_map(
            local_apply,
            mesh=self.mesh,
            in_specs=P(self.axis, None),
            out_specs=P(self.axis, None),
        )(X)

    def diagonal(self):
        return jnp.full((self.n,), 4.0, dtype=self.dtype)


@register_operator
@dataclasses.dataclass(frozen=True)
class ShardedEllSpMM(LinearOperator):
    """General row-partitioned sparse SpMM: each device owns a row band of A
    in ELL layout (cols/vals (L, n) sharded over rows, i.e. axis 1).

    Input-block movement is BOUNDARY-ONLY by default: the needed remote
    rows are known host-side from the column indices, so apply moves one
    padded (cap, b) slab per coupling-carrying mesh shift via circular
    ``ppermute`` (``_row_ghost_plan``) — comm volume ∝ boundary rows, not
    n.  When the sparsity has no locality (Σcaps ≥ half of what an
    all-gather would move) construction falls back to the all-gather
    apply, with global column ids (``caps is None``)."""

    cols: jax.Array  # (L, n) int32; LOCAL-EXTENDED ids (ghost plan) or
    #                  global ids (all-gather fallback); sharded on axis 1
    vals: jax.Array  # (L, n)
    send_idx: jax.Array  # (ndev, max(Σcaps, 1)) int32 local row ids
    _n: int = static_field(default=0)
    caps: Optional[tuple] = static_field(default=None)  # None → all-gather
    mesh: Mesh = static_field(default=None)
    axis: str = static_field(default="rows")

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, A, mesh, axis: str = "rows", dtype=None,
                   exchange: str = "auto"):
        import numpy as np

        from ..ops.spmm.ell import SparseEllOperator

        if exchange not in ("auto", "ghost", "allgather"):
            raise ValueError(f"exchange={exchange!r}")
        ndev = mesh.shape[axis]
        n = A.shape[0]
        if n % ndev:
            raise ValueError(
                f"n={n} not divisible by mesh axis size {ndev}"
            )
        ell = SparseEllOperator.from_scipy(A, dtype=dtype)
        cols = np.asarray(ell.cols)  # pad slots self-point → always local
        ml = n // ndev
        caps = None
        send_idx = np.zeros((ndev, 1), np.int32)
        if exchange != "allgather" and ndev > 1:
            bands = [cols[:, d * ml : (d + 1) * ml] for d in range(ndev)]
            remap, send_idx, caps_ = _row_ghost_plan(bands, ml, ndev)
            # an all-gather moves (ndev−1)·ml rows per device; take the
            # boundary path only when it moves materially less
            if exchange == "ghost" or sum(caps_) < 0.5 * (ndev - 1) * ml:
                caps = caps_
                cols = np.concatenate(
                    [remap[d](bands[d]) for d in range(ndev)], axis=1
                )
        sh = NamedSharding(mesh, P(None, axis))
        return cls(
            cols=jax.device_put(jnp.asarray(cols), sh),
            vals=jax.device_put(ell.vals, sh),
            send_idx=jax.device_put(
                jnp.asarray(send_idx), NamedSharding(mesh, P(axis, None))
            ),
            _n=ell._n, caps=caps, mesh=mesh, axis=axis,
        )

    def apply(self, X):
        from ..ops.spmm.operator import _pet

        ndev = self.mesh.shape[self.axis]
        caps = self.caps

        def local_apply(cols_l, vals_l, send_l, x_local):
            if caps is None:
                x_ext = jax.lax.all_gather(
                    x_local, self.axis, axis=0, tiled=True
                )
            else:
                x_ext = _ghost_exchange(
                    x_local, send_l, caps, ndev, self.axis
                )
            acc_dt = _pet(x_local.dtype)

            def body(acc, row):
                c, v = row
                return acc + (
                    v[:, None] * jnp.take(x_ext, c, axis=0)
                ).astype(acc_dt), None

            out, _ = jax.lax.scan(
                body,
                # zeros_like keeps x_local's shard_map varying axes (a
                # fresh jnp.zeros is unvarying → carry type mismatch)
                jnp.zeros_like(x_local, dtype=acc_dt),
                (cols_l, vals_l),
            )
            return out.astype(x_local.dtype)

        return jax.shard_map(
            local_apply,
            mesh=self.mesh,
            in_specs=(P(None, self.axis), P(None, self.axis),
                      P(self.axis, None), P(self.axis, None)),
            out_specs=P(self.axis, None),
        )(self.cols, self.vals, self.send_idx, X)

    def diagonal(self):
        # (L, n) sharded on axis 1 → the (n,) result shards like X's rows;
        # padding slots self-point with value 0 (SparseEllOperator layout).
        # Ghost-plan cols are local-extended: the diagonal of local row r
        # is local id r; all-gather cols are global.
        ml = self._n // self.mesh.shape[self.axis]

        def local_diag(cols_l, vals_l):
            r = jnp.arange(cols_l.shape[1], dtype=cols_l.dtype)
            if self.caps is None:
                r = r + (jax.lax.axis_index(self.axis) * ml).astype(r.dtype)
            return jnp.sum(
                jnp.where(cols_l == r[None, :], vals_l, 0.0), axis=0
            )

        return jax.shard_map(
            local_diag,
            mesh=self.mesh,
            in_specs=(P(None, self.axis), P(None, self.axis)),
            out_specs=P(self.axis),
        )(self.cols, self.vals)

    def comm_rows_per_apply(self) -> int:
        """Ghost rows each device moves per apply (an all-gather moves
        n − n/ndev) — the boundary comm-volume metric."""
        ndev = self.mesh.shape[self.axis]
        if self.caps is None:
            return self._n - self._n // ndev
        return int(sum(self.caps))


def _block_ghost_plan(needs, ndev: int, ncb_local: int):
    """Shared ghost-plan derivation at BLOCK granularity.

    needs: per-device sorted arrays of GLOBAL column-block ids referenced
    by that device's tiles.  Returns (caps, seg_off, send_idx, remaps):
    per-shift uniform slab capacities, each device's send list (its own
    local block ids, one segment per shift), and per-device dicts mapping
    remote global ids → local-extended ids (own blocks first, then ghost
    slots in receive order)."""
    import numpy as np

    recv = [[None] * ndev for _ in range(max(ndev - 1, 0))]
    for d in range(ndev):
        lo = d * ncb_local
        need = needs[d]
        remote = need[(need < lo) | (need >= lo + ncb_local)]
        owner = remote // ncb_local
        for s in range(1, ndev):
            recv[s - 1][d] = remote[owner == (d - s) % ndev]
    caps = tuple(
        int(max(len(recv[s][d]) for d in range(ndev)))
        for s in range(max(ndev - 1, 0))
    )
    seg_off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    total_cap = int(sum(caps))
    send_idx = np.zeros((ndev, max(total_cap, 1)), np.int32)
    remaps = []
    for d in range(ndev):
        lo = d * ncb_local
        remap = {}
        for s in range(1, ndev):
            if caps[s - 1] == 0:
                continue
            base = ncb_local + seg_off[s - 1]
            for j, c in enumerate(recv[s - 1][d]):
                remap[int(c)] = base + j
            dst = (d + s) % ndev
            lst = recv[s - 1][dst]  # owned by d by construction
            send_idx[d, seg_off[s - 1] : seg_off[s - 1] + len(lst)] = (
                lst - lo
            )
        remaps.append(remap)
    return caps, seg_off, send_idx, remaps


@register_operator
@dataclasses.dataclass(frozen=True)
class ShardedBlockSparseOperator(LinearOperator):
    """Row-banded CSR-of-tiles operator applied with the single-device BSR
    SpMM (``ops/spmm/pallas_bsr.bsr_apply``) on each device, with
    BOUNDARY-ONLY ghost-block exchange — the distributed form of the
    reference's cuSPARSE ``mul!`` (RBL_gpu.jl:152,176; SURVEY §2b row 1's
    "row-partitioned across devices with halo exchange").

    Everything data-dependent is resolved host-side at construction:

    - Device d owns block rows [d·nb_local, (d+1)·nb_local) — its slice
      of the tile list, zero-padded to the max per-device tile count so
      shard_map sees uniform shapes — and the matching band of X's column
      blocks.  Its ``rptr`` slice is rebased to its own tiles.
    - Its tile column ids are REMAPPED to local-extended ids: own column
      blocks first (0..ncb_local−1), then ghost slots in receive order.
    - For each mesh shift s that carries coupling anywhere, each device
      holds a static send list padded to the max count over devices
      (``caps[s−1]``) so one circular ``ppermute`` per shift moves
      uniform (cap, bk, b) slabs.  Zero-cap shifts are skipped at trace
      time: a banded matrix pays exactly its two neighbor permutes and
      comm volume stays ∝ boundary blocks, not n.

    The bands need n divisible by ndev·bm and ndev·bk.
    """

    rptr: jax.Array        # (ndev*(nb_local+1),) int32 LOCAL tile ranges
    tile_cols: jax.Array   # (ndev*Tmax,) int32 LOCAL-EXTENDED ids, banded
    vals: jax.Array        # (ndev*Tmax, bm, bk) tiles, banded
    send_idx: jax.Array    # (ndev, max(Σcaps, 1)) int32 local col-block ids
    diag: jax.Array | None = None   # (n,) — stashed at construction
    _n: int = static_field(default=0)
    bm: int = static_field(default=16)
    bk: int = static_field(default=128)
    caps: tuple = static_field(default=())
    interpret: bool = static_field(default=False)
    mesh: Mesh = static_field(default=None)
    axis: str = static_field(default="rows")

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, A, mesh, axis: str = "rows", dtype=jnp.float32,
                   bm: int | None = None, bk: int | None = None):
        import numpy as np
        import scipy.sparse as sp

        ndev = mesh.shape[axis]
        n = A.shape[0]
        if bm is None or bk is None:
            pbm, pbk = pick_tile_plan(A)
            bm, bk = bm or pbm, bk or pbk
        if n % (ndev * bk) or n % (ndev * bm):
            raise ValueError(
                f"n={n} must be divisible by mesh_size*bk={ndev * bk} and "
                f"mesh_size*bm={ndev * bm} so row bands align with the "
                "column-block grid"
            )
        rptr_g, cols_g, vals_g, nb, ncb = bsr_from_scipy(A, bm, bk, dtype)
        nb_local = nb // ndev
        ncb_local = ncb // ndev
        starts = [int(rptr_g[d * nb_local]) for d in range(ndev + 1)]
        needs = [np.unique(cols_g[starts[d]:starts[d + 1]])
                 for d in range(ndev)]
        caps, _, send_idx, remaps = _block_ghost_plan(
            needs, ndev, ncb_local
        )

        Tmax = max(max(starts[d + 1] - starts[d] for d in range(ndev)), 1)
        cols_out = np.zeros((ndev, Tmax), np.int32)
        vals_out = np.zeros((ndev, Tmax, bm, bk), vals_g.dtype)
        rptr_out = np.zeros((ndev, nb_local + 1), np.int32)
        for d in range(ndev):
            lo = d * ncb_local
            flat = cols_g[starts[d]:starts[d + 1]]
            own = (flat >= lo) & (flat < lo + ncb_local)
            out = np.empty_like(flat)
            out[own] = flat[own] - lo
            out[~own] = [remaps[d][int(c)] for c in flat[~own]]
            cols_out[d, : flat.size] = out
            vals_out[d, : flat.size] = vals_g[starts[d]:starts[d + 1]]
            rptr_out[d] = (
                rptr_g[d * nb_local : (d + 1) * nb_local + 1] - starts[d]
            )

        sh_flat = NamedSharding(mesh, P(axis))
        return cls(
            rptr=jax.device_put(jnp.asarray(rptr_out.reshape(-1)), sh_flat),
            tile_cols=jax.device_put(
                jnp.asarray(cols_out.reshape(-1)), sh_flat
            ),
            vals=jax.device_put(
                vals_out.reshape(ndev * Tmax, bm, bk),
                NamedSharding(mesh, P(axis, None, None)),
            ),
            send_idx=jax.device_put(
                jnp.asarray(send_idx), NamedSharding(mesh, P(axis, None))
            ),
            diag=jax.device_put(
                jnp.asarray(
                    sp.csr_matrix(A).diagonal().astype(np.dtype(dtype))
                ),
                sh_flat,
            ),
            _n=n, bm=bm, bk=bk, caps=caps, interpret=interpret_mode(),
            mesh=mesh, axis=axis,
        )

    def apply(self, X):
        ndev = self.mesh.shape[self.axis]
        ncb_local = self._n // (ndev * self.bk)
        b = X.shape[1]
        caps, bm, bk = self.caps, self.bm, self.bk

        def local_apply(rptr_l, cols_l, vals_l, send_l, x_local):
            xb = x_local.reshape(ncb_local, bk, b)
            x_ext = _ghost_exchange(
                xb, send_l, caps, ndev, self.axis
            ).reshape(-1, b)
            return bsr_apply(rptr_l, cols_l, vals_l, x_ext, bm=bm, bk=bk,
                             interpret=self.interpret)

        return jax.shard_map(
            local_apply,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis, None, None),
                P(self.axis, None), P(self.axis, None),
            ),
            out_specs=P(self.axis, None),
            # pallas_call's out_shape carries no varying-mesh-axes info, so
            # the vma checker cannot type it — the specs above are the truth
            check_vma=False,
        )(self.rptr, self.tile_cols, self.vals, self.send_idx, X)

    def diagonal(self):
        return self.diag

    def comm_blocks_per_apply(self) -> int:
        """Ghost (bk, b)-slabs each device moves per apply — the boundary
        comm-volume metric (an all-gather would move ncb − ncb_local)."""
        return int(sum(self.caps))


def _row_ghost_plan(cols_by_dev, ml, ndev):
    """Host-side boundary-exchange plan at ROW granularity (the
    row-level twin of ShardedBlockSparseOperator's block plan; SURVEY
    §2c halo-exchange design, replacing the all-gather the round-1
    operators used).

    ``cols_by_dev[d]`` is the (possibly duplicated) GLOBAL column-id
    array referenced by device d's row band; every id is assumed
    in-range and pad slots must already point at a LOCAL row.  Returns
    ``(remap, send_idx, caps)``:

    - ``remap[d]``: vectorized global→local-extended id map for band d
      (own rows 0..ml-1 first, then ghost rows in receive order);
    - ``send_idx``: (ndev, max(Σcaps, 1)) int32 — per device, the LOCAL
      row ids the device s hops ahead needs, one padded segment per
      shift (slot 0-padding sends row 0; receivers never index unasked
      slots);
    - ``caps``: per-shift slab heights, max over devices — zero-cap
      shifts cost nothing at trace time, so comm volume stays ∝ the
      boundary row count.
    """
    import numpy as np

    recv = [[None] * ndev for _ in range(max(ndev - 1, 0))]
    for d in range(ndev):
        lo = d * ml
        need = np.unique(np.asarray(cols_by_dev[d]))
        remote = need[(need < lo) | (need >= lo + ml)]
        owner = remote // ml
        for s in range(1, ndev):
            recv[s - 1][d] = remote[owner == (d - s) % ndev]
    caps = tuple(
        int(max(len(recv[s][d]) for d in range(ndev)))
        for s in range(max(ndev - 1, 0))
    )
    seg_off = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    total_cap = int(sum(caps))
    send_idx = np.zeros((ndev, max(total_cap, 1)), np.int32)
    lookup = []
    for d in range(ndev):
        lo = d * ml
        remap_d = {}
        for s in range(1, ndev):
            if caps[s - 1] == 0:
                continue
            base = ml + seg_off[s - 1]
            for j, c in enumerate(recv[s - 1][d]):
                remap_d[int(c)] = base + j
            dst = (d + s) % ndev
            lst = recv[s - 1][dst]  # rows owned by d by construction
            send_idx[d, seg_off[s - 1] : seg_off[s - 1] + len(lst)] = lst - lo
        lookup.append(remap_d)

    def make_remap(d):
        lo = d * ml
        tbl = lookup[d]

        def remap(cols):
            cols = np.asarray(cols)
            uniq, inv = np.unique(cols, return_inverse=True)
            own = (uniq >= lo) & (uniq < lo + ml)
            ext = np.empty_like(uniq, dtype=np.int32)
            ext[own] = (uniq[own] - lo).astype(np.int32)
            ext[~own] = [tbl[int(c)] for c in uniq[~own]]
            return ext[inv].reshape(cols.shape)

        return remap

    return [make_remap(d) for d in range(ndev)], send_idx, caps


def _ghost_exchange(x_local, send_l, caps, ndev, axis):
    """Trace-time ghost-row exchange: one circular ppermute per
    coupling-carrying shift, uniform (cap, b) slabs; returns x_local
    extended with the ghost rows in receive order (the layout
    ``_row_ghost_plan``'s remap targets)."""
    ghosts = []
    for s, cap in enumerate(caps, start=1):
        if cap == 0:
            continue
        off = sum(caps[: s - 1])
        slab = jnp.take(x_local, send_l[0, off : off + cap], axis=0)
        perm = [(i, (i + s) % ndev) for i in range(ndev)]
        ghosts.append(jax.lax.ppermute(slab, axis, perm=perm))
    if not ghosts:
        return x_local
    return jnp.concatenate([x_local, *ghosts], axis=0)


def _banded_coo_shards_np(A, ndev, dtype):
    """Split a scipy matrix into ``ndev`` row bands of row-sorted COO
    triplets, padded to the max per-band nnz (uniform shard shapes).  Pad
    slots target the band's last local row with val 0 and the band's own
    FIRST GLOBAL column — zero contribution, ascending rows preserved (the
    ``indices_are_sorted=True`` segment_sum contract), and no spurious
    remote-row demand in the ghost plan.  Returns host (ndev, cap) numpy
    arrays (rows LOCAL, cols GLOBAL, vals)."""
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    ml = A.shape[0] // ndev
    dtype = np.dtype(dtype or A.dtype)
    shards = []
    for d in range(ndev):
        band = A[d * ml : (d + 1) * ml].tocoo()
        order = np.argsort(band.row, kind="stable")
        shards.append((band.row[order], band.col[order], band.data[order]))
    cap = max(max(len(s[0]) for s in shards), 1)
    rows = np.full((ndev, cap), ml - 1, np.int32)
    # rectangular operands (m ≠ n): clamp the pad column into range — the
    # pad value is 0 either way, the clamp only keeps the gather in-bounds
    pad_col = np.minimum(
        np.arange(ndev, dtype=np.int32) * ml, A.shape[1] - 1
    )
    cols = np.repeat(pad_col[:, None], cap, axis=1)
    vals = np.zeros((ndev, cap), dtype)
    for d, (r, c, v) in enumerate(shards):
        rows[d, : len(r)] = r
        cols[d, : len(c)] = c
        vals[d, : len(v)] = v.astype(dtype)
    return rows, cols, vals


def _put_coo_shards(rows, cols, vals, mesh, axis):
    sh = NamedSharding(mesh, P(axis))
    return (
        jax.device_put(rows.reshape(-1), sh),
        jax.device_put(cols.reshape(-1), sh),
        jax.device_put(vals.reshape(-1), sh),
    )


def _sharded_coo_apply(op, X, nrows_local, caps=None, send_idx=None):
    """Shared shard_map body for the row-banded COO operators: extend the
    local input block (boundary-only ghost exchange when a plan is given,
    all-gather otherwise), gather + sorted segment_sum into the local
    band, accumulating in ``_pet(X.dtype)`` (bf16 inputs segment-sum in
    f32, matching the single-device CooOperator/RectCooOperator)."""
    from ..ops.spmm.operator import _pet

    ndev = op.mesh.shape[op.axis]

    def local_apply(rows_l, cols_l, vals_l, send_l, x_local):
        if caps is None:
            x_ext = jax.lax.all_gather(x_local, op.axis, axis=0, tiled=True)
        else:
            x_ext = _ghost_exchange(x_local, send_l, caps, ndev, op.axis)
        contrib = (
            vals_l[:, None] * jnp.take(x_ext, cols_l, axis=0)
        ).astype(_pet(x_local.dtype))
        return jax.ops.segment_sum(
            contrib, rows_l, num_segments=nrows_local, indices_are_sorted=True
        ).astype(x_local.dtype)

    if send_idx is None:
        send_idx = jax.device_put(
            jnp.zeros((ndev, 1), jnp.int32),
            NamedSharding(op.mesh, P(op.axis, None)),
        )
    return jax.shard_map(
        local_apply,
        mesh=op.mesh,
        in_specs=(P(op.axis), P(op.axis), P(op.axis),
                  P(op.axis, None), P(op.axis, None)),
        out_specs=P(op.axis, None),
    )(op.rows, op.cols, op.vals, send_idx, X)


@register_operator
@dataclasses.dataclass(frozen=True)
class ShardedCooSpMM(LinearOperator):
    """Row-partitioned COO segment-sum SpMM: each device owns its row
    band's nonzero triplets (row indices LOCAL to the band, padded to the
    max per-device count so shapes are uniform) and reduces with one
    sorted ``segment_sum`` — the skew-robust general distributed path
    (the single-device rationale is in ops/spmm/coo.py; padding
    row-length-skewed matrices to ELL wastes the skew factor in memory
    AND makes the per-device scan length the GLOBAL max row length).

    Input-block movement is BOUNDARY-ONLY by default (``_row_ghost_plan``
    ppermute slabs, comm ∝ boundary rows); dense-coupling matrices fall
    back to the all-gather (``caps is None``)."""

    rows: jax.Array  # (ndev * nnz_shard,) int32 LOCAL row ids, sharded
    cols: jax.Array  # (ndev * nnz_shard,) int32 LOCAL-EXTENDED ids (ghost
    #                  plan) or global ids (all-gather fallback)
    vals: jax.Array  # (ndev * nnz_shard,)
    send_idx: jax.Array  # (ndev, max(Σcaps, 1)) int32 local row ids
    _n: int = static_field(default=0)
    caps: Optional[tuple] = static_field(default=None)
    mesh: Mesh = static_field(default=None)
    axis: str = static_field(default="rows")

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, A, mesh, axis: str = "rows", dtype=None,
                   exchange: str = "auto"):
        import numpy as np

        if exchange not in ("auto", "ghost", "allgather"):
            raise ValueError(f"exchange={exchange!r}")
        n = A.shape[0]
        ndev = mesh.shape[axis]
        if n % ndev:
            raise ValueError(f"n={n} not divisible by mesh axis size {ndev}")
        rows, cols, vals = _banded_coo_shards_np(A, ndev, dtype)
        ml = n // ndev
        caps = None
        send_idx = np.zeros((ndev, 1), np.int32)
        if exchange != "allgather" and ndev > 1:
            remap, send_idx, caps_ = _row_ghost_plan(list(cols), ml, ndev)
            if exchange == "ghost" or sum(caps_) < 0.5 * (ndev - 1) * ml:
                caps = caps_
                cols = np.stack([remap[d](cols[d]) for d in range(ndev)])
        r, c, v = _put_coo_shards(rows, cols, vals, mesh, axis)
        return cls(
            rows=r, cols=c, vals=v,
            send_idx=jax.device_put(
                jnp.asarray(send_idx), NamedSharding(mesh, P(axis, None))
            ),
            _n=n, caps=caps, mesh=mesh, axis=axis,
        )

    def apply(self, X):
        return _sharded_coo_apply(
            self, X, self._n // self.mesh.shape[self.axis],
            caps=self.caps, send_idx=self.send_idx,
        )

    def diagonal(self):
        # rows are LOCAL band ids: the diagonal entry of local row r is
        # local-extended id r under the ghost plan, global d·ml + r under
        # the all-gather fallback; pad slots carry val 0
        ml = self._n // self.mesh.shape[self.axis]
        local_ids = self.caps is not None

        def local_diag(rows_l, cols_l, vals_l):
            base = 0 if local_ids else (
                jax.lax.axis_index(self.axis) * ml
            ).astype(cols_l.dtype)
            eq = cols_l == rows_l + base
            return jax.ops.segment_sum(
                jnp.where(eq, vals_l, 0.0), rows_l, num_segments=ml,
                indices_are_sorted=True,
            )

        return jax.shard_map(
            local_diag,
            mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis)),
            out_specs=P(self.axis),
        )(self.rows, self.cols, self.vals)

    def comm_rows_per_apply(self) -> int:
        """Ghost rows each device moves per apply (an all-gather moves
        n − n/ndev) — the boundary comm-volume metric."""
        ndev = self.mesh.shape[self.axis]
        if self.caps is None:
            return self._n - self._n // ndev
        return int(sum(self.caps))


@register_operator
@dataclasses.dataclass(frozen=True)
class ShardedRectCooSpMM:
    """RECTANGULAR (m, n) row-partitioned COO factor: the distributed twin
    of ops.spmm.coo.RectCooOperator, used in pairs (forward + transpose)
    by the sharded sparse Gram operator behind ``rbl_svd`` on a mesh.
    Output rows (m) are banded across the mesh axis; the input block
    arrives sharded over its own rows (n) and is all-gathered over NVLink
    before the local gather + sorted segment_sum.  Both m and n must be
    divisible by the mesh axis size (the caller falls back to the dense
    sharded path otherwise)."""

    rows: jax.Array  # (ndev * cap,) int32 LOCAL output-row ids, sharded
    cols: jax.Array  # (ndev * cap,) int32 global input-column ids
    vals: jax.Array  # (ndev * cap,)
    _m: int = static_field(default=0)
    _ncols: int = static_field(default=0)
    mesh: Mesh = static_field(default=None)
    axis: str = static_field(default="rows")

    @property
    def shape(self):
        return (self._m, self._ncols)

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, B, mesh, axis: str = "rows", dtype=None):
        m, n = B.shape
        ndev = mesh.shape[axis]
        if m % ndev or n % ndev:
            raise ValueError(
                f"shape {B.shape} not divisible by mesh axis size {ndev}"
            )
        rows, cols, vals = _put_coo_shards(
            *_banded_coo_shards_np(B, ndev, dtype), mesh, axis
        )
        return cls(
            rows=rows, cols=cols, vals=vals,
            _m=m, _ncols=n, mesh=mesh, axis=axis,
        )

    def apply(self, X):
        return _sharded_coo_apply(self, X, self._m // self.mesh.shape[self.axis])
