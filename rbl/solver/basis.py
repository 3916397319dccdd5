"""Krylov-basis store.

The reference archives every Lanczos block twice — a ``push!``-grown list of
host copies (pinned RAM, RBL_gpu.jl:168-169) plus a VRAM-budgeted resident
device buffer (gpu_buffer_size, RBL_gpu.jl:95-104) — and streams overflow
blocks host→device inside partial reorth (hybrid_part_reorth!,
RBL_gpu.jl:59-81).

Here, two tiers:

- **Device tier**: one zero-padded buffer of shape (n, capacity), grown
  geometrically (×2) and updated in place via donated
  ``dynamic_update_slice``.  Zero padding makes the fused
  reorthogonalization contraction static-shaped for XLA while contributing
  exactly nothing numerically; geometric growth keeps the number of
  distinct compiled shapes logarithmic.  Under a mesh the buffer rows are
  sharded like every other n-sized array, which *is* the "sharded
  Krylov-basis store" of SURVEY §2c — partial reorth then reduces b×b Grams
  with a single psum inserted by GSPMD.

- **Host tier** (opt-in via ``device_cap_cols``): when the device tier hits
  its cap it *compacts* — the oldest half moves to a pinned-host panel
  (``memory_kind='pinned_host'``, a device-side DMA, no host round-trip)
  and the newest half shifts to the buffer front.  This mirrors the
  reference's pinned-RAM overflow but amortizes the traffic: one bulk panel
  copy per half-capacity of appends instead of per-block streaming, and
  overflow panels re-enter the device once per reorth window rather than
  per iteration.  Panels keep global column order, so Ritz recovery is
  two contiguous GEMM groups (host panels + device tier) with no
  permutation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..backend import donate


@partial(jax.jit, donate_argnums=donate(0) or None)
def _write_block(buf, block, col):
    zero = jnp.zeros((), dtype=col.dtype)
    return jax.lax.dynamic_update_slice(buf, block.astype(buf.dtype), (zero, col))


@partial(jax.jit, static_argnames=("new_cols",))
def _grow(buf, new_cols):
    n, cols = buf.shape
    return jnp.pad(buf, ((0, 0), (0, new_cols - cols)))


@partial(jax.jit, donate_argnums=donate(0) or None, static_argnames=("shift",))
def _compact(buf, shift):
    """Drop the oldest ``shift`` columns: move cols [shift, C) to the
    front, zero the tail."""
    moved = buf[:, shift:]
    return jnp.pad(moved, ((0, 0), (0, shift)))


@partial(jax.jit, static_argnames=("width",))
def _slice_cols(buf, width):
    return buf[:, :width]


class BasisStore:
    """Zero-padded, geometrically grown (n, capacity) basis buffer with
    optional pinned-host overflow tier."""

    def __init__(self, n, block_size, max_cols, dtype, init_cols=32,
                 sharding=None, device_cap_cols: Optional[int] = None,
                 offload_memory_kind: str = "pinned_host"):
        b = block_size
        init_cols = max(b, min(max_cols, ((init_cols + b - 1) // b) * b))
        self.n = n
        self.b = b
        self.max_cols = max_cols
        self.ncols = 0          # total stored columns (both tiers)
        self.dev_base = 0       # global column index of device col 0
        self.sharding = sharding
        if device_cap_cols is not None:
            device_cap_cols = max(((device_cap_cols // b) * b), 4 * b)
        self.device_cap_cols = device_cap_cols
        self.offload_memory_kind = offload_memory_kind
        self.host_panels: list = []   # pinned-host arrays, oldest first
        if device_cap_cols is not None:
            init_cols = min(init_cols, device_cap_cols)
        buf = jnp.zeros((n, init_cols), dtype=dtype)
        if sharding is not None:
            buf = jax.device_put(buf, sharding)
        self.buf = buf

    # --- tier bookkeeping -------------------------------------------------

    @property
    def capacity(self):
        """Device-tier capacity (columns)."""
        return self.buf.shape[1]

    @property
    def dev_ncols(self):
        """Columns currently stored in the device tier."""
        return self.ncols - self.dev_base

    @property
    def host_ncols(self):
        return self.dev_base

    def _host_sharding(self):
        if self.sharding is not None:
            return self.sharding.with_memory_kind(self.offload_memory_kind)
        dev = jax.devices()[0]
        try:
            return jax.sharding.SingleDeviceSharding(
                dev, memory_kind=self.offload_memory_kind
            )
        except Exception:  # backend without memory kinds: default memory
            return jax.sharding.SingleDeviceSharding(dev)

    def _offload_oldest(self, keep_cols: int) -> None:
        """Move device cols [0, dev_ncols - keep_cols) to a host panel and
        shift the remainder to the buffer front."""
        shift = self.dev_ncols - keep_cols
        panel = _slice_cols(self.buf, shift)
        try:
            panel = jax.device_put(panel, self._host_sharding())
        except Exception:
            panel = jax.device_put(panel)  # no pinned_host on this backend
        jax.block_until_ready(panel)  # materialize before donating buf
        self.host_panels.append(panel)
        self.buf = _compact(self.buf, shift=shift)
        self.dev_base += shift

    def _ensure(self, needed_total: int) -> None:
        """Make room in the device tier for ``needed_total`` total columns."""
        needed_dev = needed_total - self.dev_base
        cap = self.device_cap_cols
        if cap is not None and needed_dev > cap:
            # Compact, keeping as much of the newest history as fits next
            # to the incoming append window W.  keep = cap − W guarantees
            # one offload always suffices (needed_dev becomes W + keep ≤
            # cap — a smaller keep would let writes clamp at the buffer
            # edge and silently overwrite the newest blocks), and the
            # feasibility check keeps ≥ W + 2b columns resident so
            # breakdown rewinds / Q_i re-reads and the speculated chunk's
            # own offload never touch host-tier territory.
            W = needed_total - self.ncols
            if cap < 2 * W + 2 * self.b:
                raise ValueError(
                    f"basis_device_cap_cols={cap} too small for an append "
                    f"window of {W} columns (needs ≥ {2 * W + 2 * self.b}: "
                    "raise the cap or lower eig_poll_cadence·block_size)"
                )
            keep = (cap - W) // self.b * self.b
            self._offload_oldest(keep)
            needed_dev = needed_total - self.dev_base
        if needed_dev <= self.capacity:
            return
        new_cols = self.capacity
        while new_cols < needed_dev:
            new_cols *= 2
        new_cols = min(new_cols, self.max_cols)
        if cap is not None:
            new_cols = min(new_cols, cap)
        buf = _grow(self.buf, new_cols=new_cols)
        if self.sharding is not None:
            buf = jax.device_put(buf, self.sharding)
        self.buf = buf

    # --- API ----------------------------------------------------------------

    def append(self, block) -> None:
        self._ensure(self.ncols + self.b)
        self.buf = _write_block(
            self.buf, block, jnp.int32(self.ncols - self.dev_base)
        )
        self.ncols += self.b

    def view(self):
        """The device-tier zero-padded buffer (safe operand for fused
        reorth)."""
        return self.buf

    def read_block(self, col: int, width: int):
        """One (n, width) block by GLOBAL column index, whichever tier it
        lives in (host panels re-enter the device)."""
        if col >= self.dev_base:
            return jax.lax.dynamic_slice(
                self.buf, (jnp.int32(0), jnp.int32(col - self.dev_base)),
                (self.n, width),
            )
        base = 0
        for panel in self.host_panels:
            w = panel.shape[1]
            if col < base + w:
                assert col - base + width <= w, "block straddles panels"
                # host → device memory, matching the device tier's sharding
                # (a target-less device_put is a no-op on a pinned_host
                # array — it stays in host memory)
                part = jax.device_put(panel, self.buf.sharding)
                return jax.lax.dynamic_slice(
                    part, (jnp.int32(0), jnp.int32(col - base)),
                    (self.n, width),
                )
            base += w
        raise IndexError(f"column {col} beyond stored range")

    def rewind(self, ncols_new: int, zero_fn) -> None:
        """Discard all columns ≥ ncols_new (speculation / breakdown / stale
        convergence-poll rewind), dropping or trimming host panels when the
        target predates the device tier.  ``zero_fn(buf, lo, hi)`` zeros a
        device-column range (donating)."""
        if self.ncols <= ncols_new:
            return
        if ncols_new >= self.dev_base:
            self.buf = zero_fn(
                self.buf,
                jnp.int32(ncols_new - self.dev_base),
                jnp.int32(self.ncols - self.dev_base),
            )
            self.ncols = ncols_new
            return
        # target predates the device tier: the kept prefix lives entirely
        # in host panels — drop/trim panels, empty the device tier
        while self.dev_base > ncols_new and self.host_panels:
            panel = self.host_panels.pop()
            w = panel.shape[1]
            self.dev_base -= w
            if self.dev_base < ncols_new:
                keep_w = ncols_new - self.dev_base
                # normalize the trimmed slice back onto the panel's own
                # (pinned-host) sharding: an eager slice of a pinned_host
                # array yields a hybrid whose aval says <host> while its
                # sharding says device — a later device_put by sharding is
                # then a no-op and consumers' jitted GEMMs reject the
                # mixed memory space (dot_general memory_space error)
                self.host_panels.append(
                    jax.device_put(panel[:, :keep_w], panel.sharding)
                )
                self.dev_base += keep_w
        self.buf = zero_fn(self.buf, jnp.int32(0), jnp.int32(self.capacity))
        self.ncols = ncols_new

    def host_tier(self):
        """The pinned-host overflow panels, oldest first (may be empty)."""
        return self.host_panels

    def snapshot(self, ncols: int):
        """The first ``ncols`` stored columns as one host numpy array
        (assembled across both tiers) — the sweep-checkpoint payload
        (utils/checkpoint.py).  Sub-f32 storage upcasts to f32 (numpy has
        no portable bf16 serialization); resume casts back."""
        import numpy as np

        assert ncols <= self.ncols, (ncols, self.ncols)
        parts = []
        got = 0
        for panel in self.host_panels:
            if got >= ncols:
                break
            w = min(panel.shape[1], ncols - got)
            parts.append(np.asarray(panel[:, :w]))
            got += w
        if got < ncols:
            parts.append(np.asarray(self.buf[:, : ncols - got]))
        out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        if out.dtype.itemsize < 4:
            out = out.astype(np.float32)
        return out

    def load_snapshot(self, basis) -> None:
        """Refill an EMPTY store from a ``snapshot`` array, re-applying
        dtype, sharding, and the host-offload policy block by block."""
        import numpy as np

        assert self.ncols == 0, "load_snapshot requires a fresh store"
        basis = np.asarray(basis)
        dt = self.buf.dtype
        for c in range(0, basis.shape[1], self.b):
            blk = jnp.asarray(basis[:, c : c + self.b], dtype=dt)
            if self.sharding is not None:
                blk = jax.device_put(blk, self.sharding)
            self.append(blk)

    def reset(self):
        self.buf = jnp.zeros_like(self.buf)
        self.ncols = 0
        self.dev_base = 0
        self.host_panels = []
