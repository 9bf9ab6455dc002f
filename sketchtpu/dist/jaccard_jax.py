"""Device samebits engine: the hot kernel of all distance modes.

samebits(i, j) counts sketch bins whose low-BBITS sign bits agree — an
XNOR + AND-reduction over 14 bit-planes followed by popcount
(reference src/distances/jaccard.rs:15-25). u64 plane words are
reinterpreted as pairs of u32 (bit order is irrelevant to popcount), the
per-plane AND chain uses the complement of the reference operand
(~a ^ b == ~(a ^ b)), and `jax.lax.population_count` reduces each
surviving mask word.

`_samebits_tile` is the one tile every engine calls; runtime.samebits_kernel
picks its implementation per platform: the Triton kernel
(samebits_triton.py) on the GPU, XLA's fusion of the plain version
(`_samebits_xla`) on the CPU. The engines feed the unchanged scalar f64
distance pipeline, so results are identical to the host oracle.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import BBITS
from ..runtime import samebits_kernel
from .samebits_triton import samebits_tile_triton, samebits_triton, word_major

_U32 = jnp.uint32


def _samebits_tile(a: jnp.ndarray, b: jnp.ndarray, s64: int) -> jnp.ndarray:
    """a: (na, W2) u32, b: (nb, W2) u32 -> (na, nb) int32 samebits, on the
    platform's tile (runtime.samebits_kernel)."""
    if samebits_kernel() == "triton":
        return samebits_tile_triton(a, b, s64)
    return _samebits_xla(a, b, s64)


@functools.partial(jax.jit, static_argnames=("s64",))
def _samebits_xla(a: jnp.ndarray, b: jnp.ndarray, s64: int) -> jnp.ndarray:
    """a: (na, W2) u32, b: (nb, W2) u32 with W2 = BBITS * s64 * 2, laid out
    [chunk][plane][lo,hi]. Returns (na, nb) int32 samebits."""
    na = a.shape[0]
    nb = b.shape[0]
    ar = a.reshape(na, 1, s64, BBITS, 2)
    br = b.reshape(1, nb, s64, BBITS, 2)
    nar = ~ar
    acc = jnp.full((na, nb, s64, 2), 0xFFFFFFFF, dtype=_U32)
    for p in range(BBITS):
        acc = acc & (nar[:, :, :, p] ^ br[:, :, :, p])
    counts = jax.lax.population_count(acc)
    return jnp.sum(counts, axis=(2, 3), dtype=jnp.int32)


class DeviceSamebitsEngine:
    """Drop-in `engine` for dist/api.py drivers."""

    def __init__(self, sketchsize64: int, col_tile: int = 2048):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.s64 = sketchsize64
        self.col_tile = col_tile

    def _to_u32(self, mat: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(mat, dtype=np.uint64).view(np.uint32)

    def matrix(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """All-pairs samebits: a (na, W) u64, b (nb, W) u64 -> (na, nb)."""
        a32 = self._to_u32(a)
        b32 = self._to_u32(b)
        nb = b32.shape[0]
        pending = []
        for j0 in range(0, nb, self.col_tile):
            tile = b32[j0 : j0 + self.col_tile]
            pad = 0
            if tile.shape[0] < min(self.col_tile, nb) and nb > self.col_tile:
                pad = self.col_tile - tile.shape[0]
                tile = np.pad(tile, ((0, pad), (0, 0)))
            # async dispatch; collection below overlaps device compute
            pending.append((pad, _samebits_tile(a32, tile, self.s64)))
        outs = []
        for pad, res in pending:
            res = np.asarray(res)
            if pad:
                res = res[:, : res.shape[1] - pad]
            outs.append(res)
        return np.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]


@functools.partial(jax.jit, static_argnames=("s64", "tc", "tri"))
def _samebits_strip(
    a: jnp.ndarray,
    m: jnp.ndarray,
    s64: int,
    tc: int,
    i0: jnp.ndarray = 0,
    tri: bool = False,
):
    """(blk, W2) x (n, W2) -> (blk, n) int16 samebits, computed in tc-wide
    column tiles on device (bounds the fused plane-mask intermediates).
    samebits <= s64*64 <= 2^15 for any practical sketch size, so int16
    halves the device->host strip traffic and stays exact.

    tri=True skips tiles wholly below the strip's diagonal (a real branch;
    upper-triangle consumers never read those columns), halving the
    all-vs-all compute; i0 is the strip's global row offset."""
    n, w2 = m.shape
    n_tiles = n // tc

    def tile(j0):
        bt = jax.lax.dynamic_slice(m, (j0, 0), (tc, w2))
        return _samebits_tile(a, bt, s64).astype(jnp.int16)

    def body(_, t):
        j0 = t * tc
        if tri:
            out = jax.lax.cond(
                j0 + tc > i0,
                tile,
                lambda _: jnp.zeros((a.shape[0], tc), jnp.int16),
                j0,
            )
        else:
            out = tile(j0)
        return None, out

    _, tiles = jax.lax.scan(
        body, None, jnp.arange(n_tiles, dtype=jnp.int32)
    )  # (n_tiles, blk, tc)
    return tiles.transpose(1, 0, 2).reshape(a.shape[0], n)


@functools.partial(jax.jit, static_argnames=("s64", "tile", "tri"))
def _samebits_strip_triton(m_t, q_t, r0, s64: int, tile: int, tri: bool):
    """_samebits_strip on the Triton kernel: rows [r0, r0+tile) of the
    word-major matrix m_t against every column of q_t, in one kernel call
    that writes the int16 strip directly and skips, with tri=True, every
    (BM, BN) block below the diagonal."""
    a_t = jax.lax.dynamic_slice_in_dim(m_t, r0, tile, axis=1)
    return samebits_triton(
        a_t, q_t, s64, row0=r0, tri=tri, out_dtype=jnp.int16
    )


class DeviceDenseStreamEngine:
    """Streaming dense self-distances for large single-k runs.

    Device computes exact int32 samebits strips (row block x all columns);
    the host runs the same f64 Jaccard/ANI/completeness chain as the oracle
    on each strip and writes long-form output — so values are IDENTICAL to
    the host path while the O(n^2) samebits work runs on chip. The next
    strip is dispatched before the current one is formatted.
    """

    def __init__(self, ms, k_idx: int, tile: int = 2048):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.s64 = ms.sketchsize64
        self.tile = tile
        self.k_idx = k_idx
        self.n = ms.number_samples_loaded()
        self._triton = samebits_kernel() == "triton"
        self._mat = self._put(ms)

    def _put(self, ms):
        """Device copy of ms's plane for this k, padded to the tile:
        word-major for the Triton strip, row-major for the XLA one."""
        mat = np.ascontiguousarray(ms.bins_matrix(self.k_idx)).view(np.uint32)
        pad = (-mat.shape[0]) % self.tile
        if pad:
            mat = np.pad(mat, ((0, pad), (0, 0)))
        dev = jax.device_put(mat)
        return word_major(dev) if self._triton else dev

    def _strip(self, r0: int):
        return self.cross_strip(r0, self._mat, tri=True)

    def prep_query(self, query_ms):
        """Device-resident query matrix (this engine's k plane, padded to
        the column tile) for cross strips."""
        return self._put(query_ms)

    def cross_strip(self, r0: int, q, tri: bool = False):
        """(tile, nq_padded) int16 samebits strip of ref rows
        [r0, r0+tile) against a prep_query() matrix."""
        if self._triton:
            return _samebits_strip_triton(
                self._mat, q, jnp.int32(r0), self.s64, self.tile, tri
            )
        a = self._mat[r0 : r0 + self.tile]
        return _samebits_strip(
            a, q, self.s64, self.tile, jnp.int32(r0), tri=tri
        )

    def stream_self_dense(
        self, out, names, dist_type, comp=None, cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        from .jaccard_np import ani_pois, jaccard_from_samebits
        from .output import (
            _name_table,
            fmt_f32,
            format_lines_bytes,
            row_spans,
            self_pair_indices,
        )
        from .._native import get_lib

        n = self.n
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        comp = np.asarray(comp, dtype=np.float64) if comp is not None else None
        tab = _name_table(names) if get_lib() is not None else None
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        pending: list[tuple] = []

        def dispatch(r0: int):
            pending.append((r0, self._strip(r0)))

        dispatch(starts[0])
        s64 = self.s64

        def chunk_task(strip, sbase: int, i0: int, i1: int) -> bytes:
            """Index-gen + exact f64 chain + native format for rows
            [i0, i1) of the strip based at sbase — runs in a pipeline
            worker, so strips format in parallel across all cores while
            the writer preserves order."""
            rows, cols = self_pair_indices(i0, i1, n)
            npad = strip.shape[1]
            flat_idx = (rows - sbase).astype(np.int64) * npad + cols
            sb = strip.reshape(-1)[flat_idx]
            c1 = comp[rows] if comp is not None else None
            c2 = comp[cols] if comp is not None else None
            j = jaccard_from_samebits(sb, s64, c1, c2, cutoff)
            if dist_type.ani:
                d = ani_pois(j, dist_type.k).astype(np.float32)
            else:
                d = (1.0 - j).astype(np.float32)
            return format_lines_bytes(tab, tab, rows, cols, d, None)

        pipe = None
        if tab is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, strip_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                r1 = min(r0 + self.tile, hi)
                strip = np.asarray(strip_dev)
                if pipe is not None:
                    for i0, i1 in row_spans(r0, r1, max(1, n - r0)):
                        pipe.submit(chunk_task, strip, r0, i0, i1)
                    continue
                npad = strip.shape[1]
                rows, cols = self_pair_indices(r0, r1, n)
                flat_idx = (rows - r0).astype(np.int64) * npad + cols
                sb = strip.reshape(-1)[flat_idx]
                c1 = comp[rows] if comp is not None else None
                c2 = comp[cols] if comp is not None else None
                j = jaccard_from_samebits(sb, self.s64, c1, c2, cutoff)
                if dist_type.ani:
                    d = ani_pois(j, dist_type.k).astype(np.float32)
                else:
                    d = (1.0 - j).astype(np.float32)
                out.write(
                    "".join(
                        f"{names[i]}\t{names[jx]}\t{fmt_f32(v)}\n"
                        for i, jx, v in zip(rows, cols, d)
                    )
                )
        finally:
            if pipe is not None:
                pipe.close()

    def stream_cross_dense(
        self,
        out,
        ref_names,
        query_names,
        query_ms,
        dist_type,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular output (cross_dists_all semantics); ref
        row blocks stream against the device-resident query matrix.
        row_range restricts to a block of reference rows."""
        from .jaccard_np import ani_pois, jaccard_from_samebits
        from .output import (
            _name_table,
            fmt_f32,
            format_lines_bytes,
            row_spans,
        )
        from .._native import get_lib

        n = self.n
        nq = query_ms.number_samples_loaded()
        q = self.prep_query(query_ms)
        rcomp = np.asarray(rcomp, dtype=np.float64) if rcomp is not None else None
        qcomp = np.asarray(qcomp, dtype=np.float64) if qcomp is not None else None
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        tab_r = _name_table(ref_names) if get_lib() is not None else None
        tab_q = _name_table(query_names) if tab_r is not None else None
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        pending: list[tuple] = []

        def dispatch(r0: int):
            pending.append((r0, self.cross_strip(r0, q)))

        dispatch(starts[0])
        s64 = self.s64

        def chunk_task(strip, sbase: int, i0: int, i1: int) -> bytes:
            rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
            cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
            npad = strip.shape[1]
            flat_idx = (rows - sbase).astype(np.int64) * npad + cols
            sb = strip.reshape(-1)[flat_idx]
            c1 = rcomp[rows] if rcomp is not None else None
            c2 = qcomp[cols] if qcomp is not None else None
            j = jaccard_from_samebits(sb, s64, c1, c2, cutoff)
            if dist_type.ani:
                d = ani_pois(j, dist_type.k).astype(np.float32)
            else:
                d = (1.0 - j).astype(np.float32)
            return format_lines_bytes(tab_r, tab_q, rows, cols, d, None)

        pipe = None
        if tab_r is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, strip_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                r1 = min(r0 + self.tile, hi)
                strip = np.asarray(strip_dev)
                if pipe is not None:
                    for i0, i1 in row_spans(r0, r1, nq):
                        pipe.submit(chunk_task, strip, r0, i0, i1)
                    continue
                npad = strip.shape[1]
                rows = np.repeat(np.arange(r0, r1, dtype=np.int32), nq)
                cols = np.tile(np.arange(nq, dtype=np.int32), r1 - r0)
                flat_idx = (rows - r0).astype(np.int64) * npad + cols
                sb = strip.reshape(-1)[flat_idx]
                c1 = rcomp[rows] if rcomp is not None else None
                c2 = qcomp[cols] if qcomp is not None else None
                j = jaccard_from_samebits(sb, self.s64, c1, c2, cutoff)
                if dist_type.ani:
                    d = ani_pois(j, dist_type.k).astype(np.float32)
                else:
                    d = (1.0 - j).astype(np.float32)
                out.write(
                    "".join(
                        f"{ref_names[i]}\t{query_names[jx]}\t{fmt_f32(v)}\n"
                        for i, jx, v in zip(rows, cols, d)
                    )
                )
        finally:
            if pipe is not None:
                pipe.close()


@functools.partial(jax.jit, static_argnames=("s64", "ani", "k"))
def jaccard_dist_block(
    a: jnp.ndarray, b: jnp.ndarray, s64: int, k: float = 0.0, ani: bool = False
) -> jnp.ndarray:
    """Fully on-device Jaccard (or ANI) distance tile in f32.

    This is the high-throughput path for large all-vs-all runs where the f64
    host post-processing would dominate; bit-exact output formatting uses
    the samebits path instead.
    """
    sb = _samebits_tile(a, b, s64).astype(jnp.float32)
    maxnbits = float(s64 * 64)
    expected = float(int(s64 * 64) >> BBITS)
    diff = jnp.maximum(sb - expected, 0.0)
    j = (diff * maxnbits / (maxnbits - expected)) / maxnbits
    if ani:
        val = 1.0 + 1.0 / k * jnp.log((2.0 * j) / (1.0 + j))
        return jnp.maximum(0.0, val)
    return 1.0 - j
