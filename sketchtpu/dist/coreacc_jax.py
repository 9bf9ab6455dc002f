"""Fully on-device multi-k core/accessory distance tiles.

For large all-vs-all runs the f64 host pipeline would dominate, so this
computes the whole per-pair chain on the device in f32: per k-mer length
a samebits tile (jaccard_jax._samebits_tile, the platform's tile), the
Jaccard bias correction, ln, the reference's early-break inclusion rule (a k participates only while ln(J) stays above
the tolerance, jaccard.rs:77-99), the closed-form linear regression and
the (1 - e^beta, 1 - e^alpha) transform (jaccard.rs:105-142).

f32 agrees with the exact f64 host pipeline to ~1e-5 absolute — far below
the 0.05 tolerance the reference's own accuracy gate uses — and the exact
path remains the default for small runs and golden tests.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import BBITS
from .jaccard_jax import _samebits_tile


@functools.partial(
    jax.jit,
    static_argnames=("s64", "kmers", "sketch_size", "axis_name", "cutoff"),
)
def coreacc_tile(
    a_stack: jnp.ndarray,  # (nk, na, W2) u32 sketch planes per k (ascending)
    b_stack: jnp.ndarray,  # (nk, nb, W2) u32
    s64: int,
    kmers: tuple[int, ...],
    sketch_size: int,
    axis_name: str | None = None,
    c1: jnp.ndarray | None = None,  # (na,) f32 row completeness
    c2: jnp.ndarray | None = None,  # (nb,) f32 column completeness
    cutoff: float = 0.64,
) -> jnp.ndarray:
    """Returns (na, nb, 2) f32: core and accessory distances.

    `s64` is the FULL sketch size; when the word axis is sharded over a mesh
    axis (W2 < s64*28), pass the mesh axis as `axis_name` and per-k samebits
    partials are psum-reduced over it before the regression chain.

    c1/c2 apply the MAG completeness correction (jaccard.rs:36-57) to each
    per-k Jaccard before the regression (the correction factor is constant
    over k, so it is computed once per pair)."""
    maxnbits = float(s64 * 64)
    expected = float(int(s64 * 64) >> BBITS)
    tolerance = float(np.log(2.0 / float(sketch_size * 64)))
    s64_tile = a_stack.shape[2] // (BBITS * 2)

    na = a_stack.shape[1]
    nb = b_stack.shape[1]
    shape = (na, nb)
    if c1 is not None:
        prod = c1[:, None] * c2[None, :]
        factor = prod / (c1[:, None] + c2[None, :] - prod)
        comp_apply = prod >= jnp.float32(cutoff)
    xsum = jnp.zeros(shape, jnp.float32)
    ysum = jnp.zeros(shape, jnp.float32)
    xysum = jnp.zeros(shape, jnp.float32)
    xsq = jnp.zeros(shape, jnp.float32)
    ysq = jnp.zeros(shape, jnp.float32)
    n = jnp.zeros(shape, jnp.float32)
    still = jnp.ones(shape, jnp.bool_)

    for ki, k in enumerate(kmers):
        sb_i = _samebits_tile(a_stack[ki], b_stack[ki], s64_tile)
        if axis_name is not None:
            sb_i = jax.lax.psum(sb_i, axis_name)
        sb = sb_i.astype(jnp.float32)
        diff = jnp.maximum(sb - expected, 0.0)
        j = (diff * maxnbits / (maxnbits - expected)) / maxnbits
        if c1 is not None:
            j = jnp.where(
                comp_apply, jnp.minimum(j / factor, 1.0), j
            )
        y = jnp.log(j)
        still = still & (y >= tolerance)
        k_fl = float(k)
        yk = jnp.where(still, y, 0.0)
        xsum = xsum + jnp.where(still, k_fl, 0.0)
        ysum = ysum + yk
        xysum = xysum + k_fl * yk
        xsq = xsq + jnp.where(still, k_fl * k_fl, 0.0)
        ysq = ysq + yk * yk
        n = n + still

    xbar = xsum / n
    ybar = ysum / n
    x_diff = xsq - xsum * xsum / n
    y_diff = ysq - ysum * ysum / n
    # In the reference, r = Sxy/sqrt(x_diff*y_diff) and beta = r*ystd/xstd,
    # which simplifies to Sxy/x_diff; when y_diff == 0 the reference's r is
    # NaN and both outputs collapse to 0 — replicated via the mask below.
    beta = (xysum - xsum * ysum / n) / x_diff
    alpha = -beta * xbar + ybar

    core = jnp.where(
        beta < 0.0,
        1.0 - jnp.exp(beta),
        jnp.where(beta > 0.0, 1.0, 0.0),
    )
    acc = jnp.where(alpha < 0.0, 1.0 - jnp.exp(alpha), 0.0)
    degenerate = y_diff <= 0.0
    core = jnp.where(degenerate, 0.0, core)
    acc = jnp.where(degenerate, 0.0, acc)
    bad = jnp.isnan(ysum) | jnp.isneginf(ysum) | (n < 3.0)
    core = jnp.where(bad, 1.0, core)
    acc = jnp.where(bad, 1.0, acc)
    return jnp.stack([core, acc], axis=-1)


class DeviceCoreAccEngine:
    """Tiled on-device core/accessory distances for large runs: per-k
    samebits tiles plus the f32 regression chain of coreacc_tile, which
    XLA fuses."""

    def __init__(self, ms, tile: int = 4096,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.ms = ms
        self.tile = tile
        self.s64 = ms.sketchsize64
        self.kmers = tuple(ms.kmer_lengths)
        nk = len(self.kmers)
        n = ms.number_samples_loaded()
        w = ms.kmer_stride
        mat = ms.sketch_bins.reshape(n, nk, w)
        stack = np.ascontiguousarray(mat.transpose(1, 0, 2)).view(np.uint32)
        self._comp = None
        self._cutoff = float(completeness_cutoff)
        if completeness_vec is not None:
            self._comp = jax.device_put(
                np.asarray(completeness_vec, dtype=np.float32)
            )
        self._stack = jax.device_put(stack)
        self._n = n

    def tile_dists(self, rows: slice, cols: slice) -> np.ndarray:
        a = self._stack[:, rows, :]
        b = self._stack[:, cols, :]
        out = coreacc_tile(
            a, b, self.s64, self.kmers, self.ms.sketch_size,
            c1=self._comp[rows] if self._comp is not None else None,
            c2=self._comp[cols] if self._comp is not None else None,
            cutoff=self._cutoff,
        )
        return np.asarray(out)

    def _tile_dists_async(self, r0: int, r1: int, n: int):
        """Dispatch one (row-block x all-columns) tile; returns the device
        array without forcing a transfer."""
        a = self._stack[:, r0:r1, :]
        return coreacc_tile(
            a, self._stack, self.s64, self.kmers, self.ms.sketch_size,
            c1=self._comp[r0:r1] if self._comp is not None else None,
            c2=self._comp if self._comp is not None else None,
            cutoff=self._cutoff,
        )

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular core/acc output (cross_dists_all
        semantics); ref row blocks stream against the device-resident
        query stack. Completeness applies only when both sides have
        values (jaccard.rs:36-42)."""
        from .._native import get_lib
        from .output import _name_table, emit_coreacc_cross_block

        n = len(ref_names)
        nq = query_ms.number_samples_loaded()
        nk = len(self.kmers)
        w = self.ms.kmer_stride
        qmat = query_ms.sketch_bins.reshape(nq, nk, w)
        q_stack = np.ascontiguousarray(qmat.transpose(1, 0, 2)).view(
            np.uint32
        )
        comp_on = rcomp is not None and qcomp is not None
        q_dev = jax.device_put(q_stack)
        rc_v = (
            jnp.asarray(np.asarray(rcomp, dtype=np.float32))
            if comp_on
            else None
        )
        qc_v = (
            jnp.asarray(np.asarray(qcomp, dtype=np.float32))
            if comp_on
            else None
        )
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        tab_r = _name_table(ref_names) if get_lib() is not None else None
        tab_q = _name_table(query_names) if tab_r is not None else None
        pending: list[tuple] = []

        def dispatch(r0: int):
            r1 = min(r0 + self.tile, hi)
            blk = coreacc_tile(
                self._stack[:, r0:r1, :], q_dev, self.s64, self.kmers,
                self.ms.sketch_size,
                c1=rc_v[r0:r1] if comp_on else None,
                c2=qc_v,
                cutoff=cutoff,
            )
            pending.append((r0, r1, blk))

        dispatch(starts[0])
        pipe = None
        if tab_r is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, r1, block_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                block = np.asarray(block_dev)[: r1 - r0]
                emit_coreacc_cross_block(
                    out, ref_names, query_names, tab_r, tab_q, block,
                    r0, r1, nq, pipe=pipe,
                )
        finally:
            if pipe is not None:
                pipe.close()

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        """Write the upper-triangle long-form core/acc output, computing
        (tile x all-columns) blocks on device and streaming rows out. The
        next block is dispatched before the current one is formatted, so
        device compute overlaps host text formatting. row_range restricts
        to a block of rows (multi-process sharding)."""
        from .._native import get_lib
        from .output import _name_table, emit_coreacc_self_block

        n = len(names)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        pending: list[tuple] = []
        tab = _name_table(names) if get_lib() is not None else None

        def dispatch(r0: int):
            r1 = min(r0 + self.tile, hi)
            pending.append((r0, r1, self._tile_dists_async(r0, r1, n)))

        dispatch(starts[0])
        pipe = None
        if tab is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, r1, block_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                block = np.asarray(block_dev)[: r1 - r0]
                emit_coreacc_self_block(
                    out, names, tab, block, r0, r1, n, pipe=pipe
                )
        finally:
            if pipe is not None:
                pipe.close()


class DeviceCoreAccExactStreamEngine:
    """Exact-output dense core/accessory streaming (`dist --exact`).

    The f32 DeviceCoreAccEngine above is within ~1e-5 of the f64 pipeline
    (far inside the reference's own 0.05 accuracy gate), but a user
    diffing large output byte-for-byte against the reference sees
    spurious deltas (plus the beta==0 discontinuity both share,
    jaccard.rs:105-114). This engine streams per-k EXACT int16 samebits
    strips (the single-k dense stream engine's kernel, one per k) and
    replays the oracle's f64 Jaccard + completeness + regression chain
    (jaccard.rs:61-142) on the host through the OutputPipeline — output
    is byte-identical to the host engine while the O(n^2 * nk) samebits
    work stays on chip. Costs ~nk int16 strips of device->host traffic
    per pair versus the f32 engine's one (core, acc) pair, and the f64
    chain runs per pair on the host (scales with --threads workers).
    """

    def __init__(self, ms, completeness_vec=None,
                 completeness_cutoff: float = 0.64, tile: int = 2048):
        from .jaccard_jax import DeviceDenseStreamEngine

        self.n = ms.number_samples_loaded()
        self.s64 = ms.sketchsize64
        self.kmers = list(ms.kmer_lengths)
        self.sketch_size = ms.sketch_size
        self.tile = tile
        self._comp = (
            np.asarray(completeness_vec, dtype=np.float64)
            if completeness_vec is not None
            else None
        )
        self._cutoff = float(completeness_cutoff)
        self._per_k = [
            DeviceDenseStreamEngine(ms, ki, tile)
            for ki in range(len(self.kmers))
        ]

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        from .._native import get_lib
        from .jaccard_np import core_acc_from_jaccards, jaccard_from_samebits
        from .output import (
            _name_table,
            fmt_f32,
            format_lines_bytes,
            row_spans,
            self_pair_indices,
        )

        n = self.n
        comp = self._comp
        cutoff = self._cutoff
        nk = len(self.kmers)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        tab = _name_table(names) if get_lib() is not None else None
        pending: list[tuple] = []

        def dispatch(r0: int):
            pending.append((r0, [e._strip(r0) for e in self._per_k]))

        dispatch(starts[0])
        s64 = self.s64

        def pair_values(strips, sbase: int, i0: int, i1: int):
            rows, cols = self_pair_indices(i0, i1, n)
            npad = strips[0].shape[1]
            flat_idx = (rows - sbase).astype(np.int64) * npad + cols
            c1 = comp[rows] if comp is not None else None
            c2 = comp[cols] if comp is not None else None
            jaccs = np.empty((rows.size, nk), dtype=np.float64)
            for ki, s in enumerate(strips):
                jaccs[:, ki] = jaccard_from_samebits(
                    s.reshape(-1)[flat_idx], s64, c1, c2, cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, self.kmers, self.sketch_size
            )
            return rows, cols, core, acc

        def chunk_task(strips, sbase: int, i0: int, i1: int) -> bytes:
            rows, cols, core, acc = pair_values(strips, sbase, i0, i1)
            return format_lines_bytes(
                tab, tab, rows, cols,
                core.astype(np.float32), acc.astype(np.float32),
            )

        pipe = None
        if tab is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, strips_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                r1 = min(r0 + self.tile, hi)
                strips = [np.asarray(s) for s in strips_dev]
                if pipe is not None:
                    for i0, i1 in row_spans(r0, r1, max(1, n - r0)):
                        pipe.submit(chunk_task, strips, r0, i0, i1)
                    continue
                rows, cols, core, acc = pair_values(strips, r0, r0, r1)
                out.write(
                    "".join(
                        f"{names[i]}\t{names[jx]}\t"
                        f"{fmt_f32(np.float32(c))}\t{fmt_f32(np.float32(a))}\n"
                        for i, jx, c, a in zip(rows, cols, core, acc)
                    )
                )
        finally:
            if pipe is not None:
                pipe.close()

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Cross (ref-vs-query) twin of stream_self_dense: per-k EXACT
        int16 samebits strips over the query rectangle, the oracle's f64
        chain replayed on the host — byte-identical to
        api.cross_dists_all + write_dense_cross
        (/root/reference/src/distances/mod.rs:227-297 semantics).
        Completeness applies only when both sides have values
        (jaccard.rs:36-42)."""
        from .._native import get_lib
        from .jaccard_np import core_acc_from_jaccards, jaccard_from_samebits
        from .output import (
            _name_table,
            fmt_f32,
            format_lines_bytes,
            row_spans,
        )

        n = self.n
        nq = query_ms.number_samples_loaded()
        cutoff = float(cutoff)
        comp_on = rcomp is not None and qcomp is not None
        rc = np.asarray(rcomp, dtype=np.float64) if comp_on else None
        qc = np.asarray(qcomp, dtype=np.float64) if comp_on else None
        nk = len(self.kmers)
        qreps = [e.prep_query(query_ms) for e in self._per_k]
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        starts = list(range(lo, hi, self.tile))
        if not starts:
            return
        tab_r = _name_table(ref_names) if get_lib() is not None else None
        tab_q = _name_table(query_names) if tab_r is not None else None
        pending: list[tuple] = []

        def dispatch(r0: int):
            pending.append(
                (
                    r0,
                    [
                        e.cross_strip(r0, qr)
                        for e, qr in zip(self._per_k, qreps)
                    ],
                )
            )

        dispatch(starts[0])
        s64 = self.s64

        def pair_values(strips, sbase: int, i0: int, i1: int):
            rows = np.repeat(np.arange(i0, i1, dtype=np.int32), nq)
            cols = np.tile(np.arange(nq, dtype=np.int32), i1 - i0)
            npad = strips[0].shape[1]
            flat_idx = (rows - sbase).astype(np.int64) * npad + cols
            c1 = rc[rows] if comp_on else None
            c2 = qc[cols] if comp_on else None
            jaccs = np.empty((rows.size, nk), dtype=np.float64)
            for ki, s in enumerate(strips):
                jaccs[:, ki] = jaccard_from_samebits(
                    s.reshape(-1)[flat_idx], s64, c1, c2, cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, self.kmers, self.sketch_size
            )
            return rows, cols, core, acc

        def chunk_task(strips, sbase: int, i0: int, i1: int) -> bytes:
            rows, cols, core, acc = pair_values(strips, sbase, i0, i1)
            return format_lines_bytes(
                tab_r, tab_q, rows, cols,
                core.astype(np.float32), acc.astype(np.float32),
            )

        pipe = None
        if tab_r is not None:
            from .opipe import OutputPipeline

            pipe = OutputPipeline(out)
        try:
            for nxt in starts[1:] + [None]:
                r0, strips_dev = pending.pop(0)
                if nxt is not None:
                    dispatch(nxt)
                r1 = min(r0 + self.tile, hi)
                strips = [np.asarray(s) for s in strips_dev]
                if pipe is not None:
                    for i0, i1 in row_spans(r0, r1, nq):
                        pipe.submit(chunk_task, strips, r0, i0, i1)
                    continue
                rows, cols, core, acc = pair_values(strips, r0, r0, r1)
                out.write(
                    "".join(
                        f"{ref_names[i]}\t{query_names[jx]}\t"
                        f"{fmt_f32(np.float32(c))}\t{fmt_f32(np.float32(a))}\n"
                        for i, jx, c, a in zip(rows, cols, core, acc)
                    )
                )
        finally:
            if pipe is not None:
                pipe.close()
