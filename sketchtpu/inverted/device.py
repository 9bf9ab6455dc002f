"""Device inverted-index query kernels.

The in-memory inverted index is a dense [n_samples x sketch_size] u16 sign
matrix (inverted/index.py). All three query families reduce to sign-equality
tiles:

- match-count  (inverted.rs:229-240): per (query, sample) count of equal bins
- any/all-bins (inverted.rs:243-268): per (query, sample) OR/AND of equality
- precluster --count (inverted.rs:271-300): number of sample pairs sharing at
  least one bin — the reference's only published performance number is this
  operation ("~90m and 50Gb for 661k samples, 32 threads", lib.rs:702-703);
  here it is an all-vs-all equality-any reduction fused into ONE device
  program (scan over row strips x column tiles, exact split-int32
  subtotals). Its time on the GPU is not measured yet.

Signs are widened to i32 (one bin per element); the equality mask never
materialises in device memory — XLA fuses the compare into the `any`/`sum`
reduction.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("tc", "nstrips"))
def _match_count_schedule(
    m: jnp.ndarray,  # (n_pad, S) i32 padded sign matrix
    lo: jnp.ndarray,  # () int32 first global row of the range
    hi: jnp.ndarray,  # () int32 end of the row range
    n_real: jnp.ndarray,  # () int32 real rows/columns
    tc: int,
    nstrips: int,
):
    """The whole `precluster --count` pair enumeration as ONE device
    program: an outer scan over `nstrips` row strips of `tc`, each
    scanning every column tile (_match_count_strip semantics — eq-any +
    i<j/bounds mask + per-tile count, tri skip), accumulating per-strip
    subtotals in TWO int32 lanes (lo 16 bits / hi remainder — a strip's
    subtotal can reach rows*n ~ 2.7e9 at 661k and overflow one int32;
    per-tile counts are <= tc^2 so the split accumulation is exact).
    Returns (nstrips, 2) int32; host total = sum(hi)<<16 + sum(lo) in
    Python ints. One scalar-sized transfer replaces the per-strip
    dispatches."""
    n_pad, s = m.shape
    n_tiles = n_pad // tc

    def strip(_, si):
        r0 = lo + si * tc
        a = jax.lax.dynamic_slice(m, (r0, 0), (tc, s))

        def tile_count(j0):
            b = jax.lax.dynamic_slice(m, (j0, 0), (tc, s))
            eq = (a[:, None, :] == b[None, :, :]).any(axis=2)
            ri = r0 + jax.lax.broadcasted_iota(jnp.int32, (tc, tc), 0)
            ci = j0 + jax.lax.broadcasted_iota(jnp.int32, (tc, tc), 1)
            keep = eq & (ri < hi) & (ci < n_real) & (ci > ri)
            return jnp.sum(keep, dtype=jnp.int32)

        def tbody(carry, t):
            j0 = t * tc
            add = jax.lax.cond(
                j0 + tc > r0, tile_count, lambda _: jnp.int32(0) + r0 * 0,
                j0,
            )
            c_lo, c_hi = carry
            return (c_lo + (add & 0xFFFF), c_hi + (add >> 16)), None

        (c_lo, c_hi), _ = jax.lax.scan(
            tbody, (jnp.int32(0) + r0 * 0, jnp.int32(0) + r0 * 0),
            jnp.arange(n_tiles, dtype=jnp.int32),
        )
        return None, jnp.stack([c_lo, c_hi])

    _, subs = jax.lax.scan(
        strip, None, jnp.arange(nstrips, dtype=jnp.int32)
    )
    return subs  # (nstrips, 2)


@functools.partial(jax.jit, static_argnames=("tc",))
def _match_count_strip(
    a: jnp.ndarray,  # (ti, S) i32 row block
    m: jnp.ndarray,  # (n, S) i32 full sign matrix (n % tc == 0 after pad)
    i0: jnp.ndarray,  # () int32 global row offset of the block
    na: jnp.ndarray,  # () int32 real rows in the block
    n_real: jnp.ndarray,  # () int32 real columns
    tc: int,
) -> jnp.ndarray:
    """Per-column-tile pair counts (global i < j, >= 1 equal bin) for one
    row strip: (n_tiles,) int32. The column dimension is scanned on device,
    so one small vector per row strip is all that returns to the host,
    in place of one dispatch per tile."""
    n, s = m.shape
    ti = a.shape[0]
    n_tiles = n // tc

    def tile_count(j0):
        b = jax.lax.dynamic_slice(m, (j0, 0), (tc, s))
        eq = (a[:, None, :] == b[None, :, :]).any(axis=2)
        ri = i0 + jax.lax.broadcasted_iota(jnp.int32, (ti, tc), 0)
        ci = j0 + jax.lax.broadcasted_iota(jnp.int32, (ti, tc), 1)
        keep = eq & (ri < i0 + na) & (ci < n_real) & (ci > ri)
        # per-tile count <= ti*tc (~16M) fits int32; the strip total can
        # overflow it (and jnp.int64 degrades to int32 without x64 mode),
        # so per-tile counts go back and the host sums in Python ints
        return jnp.sum(keep, dtype=jnp.int32)

    def body(_, t):
        j0 = t * tc
        # tiles wholly below the strip's diagonal contribute nothing (the
        # upper triangle is i < j); a real branch skips their compute.
        # + i0 * 0: under shard_map the taken branch varies over 'rows',
        # so the zero branch must inherit that device-varying type too
        add = jax.lax.cond(
            j0 + tc > i0, tile_count, lambda _: jnp.int32(0) + i0 * 0, j0
        )
        return None, add

    _, counts = jax.lax.scan(
        body, None, jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return counts


@functools.partial(jax.jit, static_argnames=("tc", "mode"))
def _match_matrix_scan(q: jnp.ndarray, m: jnp.ndarray, tc: int, mode: str):
    """(nq, S) x (n, S) -> (nq, n) counts (mode="count") or bool
    any-/all-shared mask (mode="any"/"all", inverted.rs:243-268), with the
    column dimension scanned ON DEVICE so the whole result returns to the
    host in one transfer. Counts are bounded by S, so they return as uint16
    when that provably fits, int32 otherwise."""
    n, s = m.shape
    nq = q.shape[0]
    cdtype = jnp.uint16 if s < 65536 else jnp.int32

    def body(_, t):
        b = jax.lax.dynamic_slice(m, (t * tc, 0), (tc, s))
        eq = q[:, None, :] == b[None, :, :]
        if mode == "count":
            out = jnp.sum(eq.astype(jnp.int32), axis=2).astype(cdtype)
        elif mode == "all":
            out = eq.all(axis=2)
        else:
            out = eq.any(axis=2)
        return None, out

    _, tiles = jax.lax.scan(
        body, None, jnp.arange(n // tc, dtype=jnp.int32)
    )  # (n_tiles, nq, tc)
    return tiles.transpose(1, 0, 2).reshape(nq, n)


class DeviceInvertedEngine:
    """Device-resident inverted-index queries over the dense sign matrix."""

    def __init__(self, sign_matrix: np.ndarray, tile: int = 4096):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.n = int(sign_matrix.shape[0])
        self.tile = min(tile, max(256, self.n))
        # u16 signs -> i32 lanes (pad rows are masked by size, not value)
        self._mat = jax.device_put(sign_matrix.astype(np.int32))

    def _tile_of(self, i0: int) -> tuple[jnp.ndarray, int]:
        t = self._mat[i0 : i0 + self.tile]
        real = int(t.shape[0])
        pad = self.tile - real
        if pad:
            t = jnp.pad(t, ((0, pad), (0, 0)))
        return t, real

    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        """Total sample pairs (i < j) sharing >= 1 bin, with i restricted
        to row_range when given (multi-process: rank partials sum to the
        full count since each pair is counted at its smaller index).

        The whole row-strip schedule runs as one device program
        (_match_count_schedule) rather than one dispatch per strip. The
        (tile x tile x S) equality mask stays fused in the reduction and
        never touches device memory; per-strip subtotals come back as
        exact split-int32 pairs."""
        n, tile = self.n, self.tile
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        if hi <= lo:
            return 0
        nstrips = -(-(hi - lo) // tile)
        # one extra tile of row padding so an un-aligned lo never makes
        # the last strip's dynamic_slice clamp (clamping would mislabel
        # the strip's global row indices); the extra rows are masked by
        # ri < hi and ci < n_real
        m = self._padded_mat()
        key = "_mat_pad_extra"
        if key not in self.__dict__:
            self.__dict__[key] = jnp.pad(m, ((0, tile), (0, 0)))
        subs = np.asarray(
            _match_count_schedule(
                self.__dict__[key], np.int32(lo), np.int32(hi),
                np.int32(n), tc=tile, nstrips=nstrips,
            )
        ).astype(np.int64)
        return int((subs[:, 1].sum() << 16) + subs[:, 0].sum())

    def _padded_mat(self) -> jnp.ndarray:
        if "_mat_pad" not in self.__dict__:
            pad = (-self.n) % self.tile
            self.__dict__["_mat_pad"] = (
                jnp.pad(self._mat, ((0, pad), (0, 0))) if pad else self._mat
            )
        return self.__dict__["_mat_pad"]

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) int64 shared-bin counts."""
        q = jax.device_put(np.asarray(queries, dtype=np.int32))
        out = _match_matrix_scan(q, self._padded_mat(), self.tile, "count")
        return np.asarray(out)[:, : self.n].astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool any-shared-bin mask."""
        q = jax.device_put(np.asarray(queries, dtype=np.int32))
        out = _match_matrix_scan(q, self._padded_mat(), self.tile, "any")
        return np.asarray(out)[:, : self.n]

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        """(nq, S) u16 query signs -> (nq, n) bool all-bins-shared mask
        (inverted.rs:243-256). Pad rows are sliced off on host, so a
        zero-padded row can never masquerade as an all-match."""
        q = jax.device_put(np.asarray(queries, dtype=np.int32))
        out = _match_matrix_scan(q, self._padded_mat(), self.tile, "all")
        return np.asarray(out)[:, : self.n]
