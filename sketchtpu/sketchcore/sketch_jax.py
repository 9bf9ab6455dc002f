"""Batched device sketching backend.

Concatenates a batch of genome streams into one device program per k
(hash -> Mersenne mod -> magic-divide binning -> two-pass scatter-min), so
XLA compiles a single fused pipeline per (k, bucket size) and the whole
batch's bin minima come back in one transfer. Densification and the b-bit
plane transpose are O(num_bins) host work per sample.

Produces Sketch objects bit-identical to the host oracle
(sketchcore/sketch.py) — asserted by tests/test_device_parity.py.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import SIGN_MOD, num_bins as num_bins_fn
from ..hash.nthash_jax import (
    MAX_K,
    combine_bin_minima,
    hash_bin_kernel,
    hash_signs_kernel,
    magic_divider,
    tap_tables_u32,
)
from ..hash.nthash_np import valid_window_mask
from ..ingest.fastx import DnaStream
from .signs import bin_minima_filtered, densify, fill_usigs
from .sketch import Sketch

# Up to this many concatenated bases per device batch (bounds device-memory
# temporaries). This and the group caps below are not yet retuned on the
# GPU (ROADMAP).
# MAX_K under the bucket boundary: _prepare_group pads to
# _bucket_size(total + MAX_K), and a group summing to exactly 2^24 would
# otherwise spill into a one-off 2^25-element program (minutes of compile
# at ~1/4 the efficiency — see the note at _BATCH_BASES_FAST).
_BATCH_BASES = (1 << 24) - MAX_K  # ~16M
# genomes per device group: the sort key packs the genome index into 3 bits
# (value 7 marks invalid windows), so at most 7 genomes share one kernel call
_MAX_GROUP = 7
# The fast multi-k kernel packs the genome index into 8 bits of its
# candidate key (nthash_multik.py), so prefilter-eligible genomes batch in
# much larger groups — fewer dispatch round-trips per sketched base.
_MAX_GROUP_FAST = 96
# Small samples that miss the fast prefilter (density > 1/8, e.g. 100k-aa
# proteomes at s=1000) batch in WIDE exact groups: the genome index rides
# a third sort key (bin_min_sorted) instead of 3 spare hi bits, lifting
# the 7-row cap. Growth past 7 rows stops once the group holds _WIDE_BASES
# (large genomes keep the cheaper 2-key program and were dispatch-bound
# never anyway).
_MAX_GROUP_WIDE = 64
_WIDE_BASES = 1 << 23
# Same byte budget as the exact path; big groups only help workloads of
# many sub-2M genomes (bucket size not yet tuned on the GPU, ROADMAP).
_BATCH_BASES_FAST = (1 << 24) - MAX_K
# A single stream above this is split into overlapping segments rather
# than forming a one-off giant device program (compile time and efficiency
# degrade superlinearly past ~64M elements; the reference streams per-base
# and has no such cliff). Sized so a segment plus its MAX_K-1 window
# overlap still packs into the standard 2^24 bucket, keeping eukaryote-
# scale contigs on the same cached program as everything else.
_SEG_BASES = _BATCH_BASES - 2 * MAX_K
# Single-k requests route to the fast kernel only below this stream length
# (the benefit is purely the bigger genome groups; see _fast_eligible)
_SINGLEK_FAST_MAX_LEN = 1 << 20


def _exact_rows(g: int) -> int:
    """out_rows bucket for an exact dispatch of g genomes (two cached
    program shapes: the 2-key <=7-row one and the 3-key wide one)."""
    return _MAX_GROUP if g <= _MAX_GROUP else _MAX_GROUP_WIDE


def _bucket_size(n: int) -> int:
    b = 1 << 14
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=1)
def _slice_prefix_fn():
    import jax

    @functools.partial(jax.jit, static_argnames=("b",))
    def sl(x, b):
        return x[:b]

    return sl


def _slice_prefix(arr, b: int):
    """First b elements of a device array as a device array — a jitted
    slice so only b elements cross the link (np.asarray on the full
    array would transfer the whole buffer)."""
    return _slice_prefix_fn()(arr, b)


def _segment_stream(stream: DnaStream, seg: int | None = None):
    """Split an oversized stream into window-covering segments.

    Segment i owns windows *starting* in [p0, p1) and carries MAX_K-1
    extra bases past p1 so those windows are complete; breaks are shifted
    into segment coordinates. Windows starting inside the overlap are
    emitted by both neighbouring segments — harmless for a min-reduction,
    so the per-bin min over segments equals the whole stream's (the
    in-order FASTQ path instead truncates each segment to its owned
    starts; see signs_in_order). Returns (segments, [(p0, p1), ...])."""
    seg = seg or _SEG_BASES
    n = stream.seq_len
    segs, spans = [], []
    for p0 in range(0, n, seg):
        p1 = min(p0 + seg, n)
        end = min(p1 + MAX_K - 1, n)
        br = stream.breaks
        b = (br[(br > p0) & (br <= end)] - p0).astype(np.int64)
        segs.append(
            DnaStream(codes=stream.codes[p0:end], breaks=b, reads=stream.reads)
        )
        spans.append((p0, p1))
    return segs, spans


def segmented_min_combine(streams, kmers, nbins, oversized, segment, inner):
    """Oversized-stream driver shared by the DNA and AA backends: expand
    each stream past the segment budget via `segment`, run `inner` on the
    expanded list, and min-combine rows by owner — exact because the
    empty-bin sentinel is u64::MAX. Returns None when nothing is
    oversized (caller proceeds with the normal grouped path)."""
    if not any(oversized(s) for s in streams):
        return None
    expanded, owner = [], []
    for i, s in enumerate(streams):
        segs = segment(s)[0] if oversized(s) else [s]
        expanded.extend(segs)
        owner.extend([i] * len(segs))
    part = inner(expanded)
    owner_a = np.array(owner, dtype=np.int64)
    out = {
        kk: np.full(
            (len(streams), nbins),
            np.uint64(0xFFFFFFFFFFFFFFFF),
            dtype=np.uint64,
        )
        for kk in kmers
    }
    for kk in kmers:
        np.minimum.at(out[kk], owner_a, part[kk])
    return out


@functools.lru_cache(maxsize=None)
def bin_magic(nbins: int) -> tuple[int, int]:
    """Memoised magic-divider constants for hash -> bin index (shared by
    the DNA and AA device backends)."""
    binsize = (SIGN_MOD + nbins - 1) // nbins
    return magic_divider(binsize, nbins)


class DeviceSketchBackend:
    def __init__(self):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()

    @staticmethod
    def _magic(nbins: int) -> tuple[int, int]:
        return bin_magic(nbins)

    def _groups(self, streams):
        start = 0
        while start < len(streams):
            end = start
            total = 0
            while (
                end < len(streams)
                and end - start < _MAX_GROUP_WIDE
                and (
                    end == start or total + streams[end].seq_len <= _BATCH_BASES
                )
                and (
                    end - start < _MAX_GROUP
                    or total + streams[end].seq_len <= _WIDE_BASES
                )
            ):
                total += streams[end].seq_len
                end += 1
            yield start, end
            start = end

    @staticmethod
    def _fast_eligible(stream, kmers, nbins) -> bool:
        if max(kmers) > 64:
            return False
        n = stream.seq_len
        if len(kmers) < 2 and n > _SINGLEK_FAST_MAX_LEN:
            # single-k shares no pass across k, so the fast kernel only
            # wins through its larger groups (96 vs 7 genomes/dispatch) —
            # route only small genomes, the inverted-build shape at 100k+
            # samples
            return False
        from ..hash.nthash_multik import group_thresholds

        return n > 0 and group_thresholds([n], nbins)[2]

    def _groups_mixed(self, streams, kmers, nbins):
        """Yield (start, end, is_fast): consecutive prefilter-eligible
        streams in large fast-kernel groups, the rest in exact-size ones."""
        start = 0
        n = len(streams)
        while start < n:
            is_fast = self._fast_eligible(streams[start], kmers, nbins)
            cap = _MAX_GROUP_FAST if is_fast else _MAX_GROUP_WIDE
            bases = _BATCH_BASES_FAST if is_fast else _BATCH_BASES
            end = start
            total = 0
            while (
                end < n
                and end - start < cap
                and (end == start or total + streams[end].seq_len <= bases)
                and (
                    is_fast
                    or end - start < _MAX_GROUP
                    or total + streams[end].seq_len <= _WIDE_BASES
                )
                and (
                    end == start
                    or self._fast_eligible(streams[end], kmers, nbins)
                    == is_fast
                )
            ):
                total += streams[end].seq_len
                end += 1
            yield start, end, is_fast
            start = end

    def bin_minima_multi_k(
        self,
        streams: list[DnaStream],
        kmers: list[int],
        rc: bool,
        nbins: int,
    ) -> dict[int, np.ndarray]:
        """Per-bin minima for all k values; the packed stream (the bulk of
        host->device traffic) is uploaded once per genome group and reused
        across k.

        Large-genome groups take the fast multi-k kernel (incremental hash
        over k + residual prefilter + one candidate sort, hash/nthash_multik
        .py); a group falls back to the exact per-k full-sort kernel when a
        genome is too small for the prefilter, a compaction block overflows,
        or any bin lost all candidates — so results are always bit-exact.

        Streams past _SEG_BASES are split into overlapping segments
        (one standard-size device program each, see _segment_stream) and
        their per-segment bin minima min-combined — the empty-bin
        sentinel is u64::MAX, so np.minimum composes exactly."""
        import jax

        if max(kmers) > MAX_K:
            # k past the device tap-table width. The reference allows any
            # k >= 3 (io.rs:154-156), so take the host oracle for the whole
            # request (practical genomics k stays far below MAX_K).
            from ..hash.nthash_np import nthash_valid
            from .signs import bin_minima, signs_from_hashes

            return {
                kk: np.stack(
                    [
                        bin_minima(
                            signs_from_hashes(nthash_valid(s, kk, rc)), nbins
                        )
                        for s in streams
                    ]
                )
                for kk in kmers
            }

        seg = segmented_min_combine(
            streams,
            kmers,
            nbins,
            lambda s: s.seq_len > _SEG_BASES + MAX_K,
            _segment_stream,
            lambda ex: self.bin_minima_multi_k(ex, kmers, rc, nbins),
        )
        if seg is not None:
            return seg

        out = {kk: np.empty((len(streams), nbins), dtype=np.uint64) for kk in kmers}

        # JAX dispatch is async: issuing several groups' kernels before
        # collecting any result overlaps host packing, transfers and device
        # compute, and amortises the per-dispatch cost. The window bounds
        # device memory to a few packed streams.
        #
        # Sketching is per-sample independent, so on a multi-chip host the
        # groups round-robin over the local devices (the data-parallel
        # axis); each group's kernels run on the device holding its packed
        # stream. The reference's analogue is the rayon par_iter over
        # samples (sketch/mod.rs:318-391).
        devices = jax.local_devices()
        window = max(8, 2 * len(devices))
        in_flight: list[tuple] = []

        def dispatch(start: int, end: int, is_fast: bool, dev):
            group = streams[start:end]
            g = len(group)
            rows = _MAX_GROUP_FAST if is_fast else _exact_rows(g)
            # breaks are k-independent; prepare with the smallest k
            packed, breakbits, starts, total = self._prepare_group(
                group, min(kmers)
            )
            packed_d = jax.device_put(packed, dev)
            breakbits_d = jax.device_put(breakbits, dev)
            starts_pad = np.full(rows, total, dtype=np.int32)
            starts_pad[:g] = starts
            fast = exact = None
            if is_fast:
                fast = self._dispatch_fast_multi_k(
                    group, packed_d, breakbits_d, starts_pad, total, kmers,
                    rc, nbins, rows,
                )
            if fast is None:
                if g <= _MAX_GROUP_WIDE:
                    exact = self._dispatch_exact(
                        packed_d, breakbits_d,
                        self._pad_starts(starts, total, _exact_rows(g)),
                        total, kmers, rc, nbins,
                    )
                # else: handled at collect time by re-running in exact-size
                # chunks (only reachable on a fast-dispatch refusal)
            return (start, end, g, rows, packed_d, breakbits_d, starts, total,
                    fast, exact)

        # rows whose bin the prefilter lost; redone in ONE batched exact
        # pass after all groups are collected (keeps the collect loop
        # non-blocking — inline redos serialized a dispatch round-trip per
        # affected group)
        bad_global: list[int] = []

        def collect(item):
            (start, end, g, rows, packed_d, breakbits_d, starts, total,
             fast, exact) = item
            if fast is not None:
                done, bad_rows = self._collect_fast_multi_k(
                    fast, kmers, g, nbins, rows
                )
                if done is not None:
                    for kk in kmers:
                        out[kk][start:end] = done[kk][:g]
                    bad_global.extend(start + int(i) for i in bad_rows)
                    return
                # compaction overflow: nothing in the group is trustworthy
                if g <= _MAX_GROUP_WIDE:
                    exact = self._dispatch_exact(
                        packed_d, breakbits_d,
                        self._pad_starts(starts, total, _exact_rows(g)),
                        total, kmers, rc, nbins,
                    )
            if exact is None:
                redo = self.bin_minima_multi_k_exact(
                    streams[start:end], kmers, rc, nbins
                )
                for kk in kmers:
                    out[kk][start:end] = redo[kk]
                return
            for kk, (min_hi, min_lo, found) in exact.items():
                mh = np.asarray(min_hi).reshape(-1, nbins)[:g]
                ml = np.asarray(min_lo).reshape(-1, nbins)[:g]
                fd = np.asarray(found).reshape(-1, nbins)[:g]
                out[kk][start:end] = combine_bin_minima(mh, ml, fd)

        for gi, (start, end, is_fast) in enumerate(
            self._groups_mixed(streams, kmers, nbins)
        ):
            if len(in_flight) >= window:
                collect(in_flight.pop(0))
            in_flight.append(
                dispatch(start, end, is_fast, devices[gi % len(devices)])
            )
        for item in in_flight:
            collect(item)
        if bad_global:
            # one exact dispatch per bad row, pipelined behind the same
            # in-flight window as the main loop (bounds device memory).
            # Per-row (not batched into one group): a batch would
            # concatenate to a novel total-length bucket and recompile the
            # exact kernels, while single-genome buckets are hot
            def redo_collect(item):
                i, exact = item
                for kk, (min_hi, min_lo, found) in exact.items():
                    mh = np.asarray(min_hi).reshape(-1, nbins)[:1]
                    ml = np.asarray(min_lo).reshape(-1, nbins)[:1]
                    fd = np.asarray(found).reshape(-1, nbins)[:1]
                    out[kk][i] = combine_bin_minima(mh, ml, fd)[0]

            handles = []
            for i in bad_global:
                if len(handles) >= window:
                    redo_collect(handles.pop(0))
                packed, breakbits, starts, total = self._prepare_group(
                    [streams[i]], min(kmers)
                )
                handles.append((i, self._dispatch_exact(
                    jax.device_put(packed),
                    jax.device_put(breakbits),
                    self._pad_starts(starts, total),
                    total, kmers, rc, nbins,
                )))
            for item in handles:
                redo_collect(item)
        return out

    @staticmethod
    def _pad_starts(
        starts: np.ndarray, total: int, rows: int = _MAX_GROUP
    ) -> np.ndarray:
        pad = np.full(rows, total, dtype=np.int32)
        pad[: starts.shape[0]] = starts
        return pad

    def bin_minima_multi_k_exact(
        self, streams, kmers, rc: bool, nbins: int
    ) -> dict[int, np.ndarray]:
        """Exact per-k kernels in _MAX_GROUP-size chunks (blocking; used as
        the fallback when a large fast-kernel group fails validation)."""
        out = {kk: np.empty((len(streams), nbins), dtype=np.uint64) for kk in kmers}
        import jax

        for start, end in self._groups(streams):
            group = streams[start:end]
            g = len(group)
            packed, breakbits, starts, total = self._prepare_group(
                group, min(kmers)
            )
            exact = self._dispatch_exact(
                jax.device_put(packed),
                jax.device_put(breakbits),
                self._pad_starts(starts, total, _exact_rows(g)),
                total,
                kmers,
                rc,
                nbins,
            )
            for kk, (min_hi, min_lo, found) in exact.items():
                mh = np.asarray(min_hi).reshape(-1, nbins)[:g]
                ml = np.asarray(min_lo).reshape(-1, nbins)[:g]
                fd = np.asarray(found).reshape(-1, nbins)[:g]
                out[kk][start:end] = combine_bin_minima(mh, ml, fd)
        return out

    def _dispatch_exact(
        self, packed_d, breakbits_d, starts_pad, total, kmers, rc, nbins
    ):
        """Issue the exact per-k kernels (async); returns {k: device tuple}.
        out_rows follows starts_pad's length (the _exact_rows bucket)."""
        results = {}
        for kk in kmers:
            taps_fwd, taps_rev = tap_tables_u32(kk, rc)
            results[kk] = hash_bin_kernel(
                packed_d,
                breakbits_d,
                starts_pad,
                np.int32(total),
                np.int32(kk),
                taps_fwd,
                taps_rev,
                rc=rc,
                num_bins=nbins,
                magic=self._magic(nbins),
                out_rows=int(starts_pad.shape[0]),
            )
        return results

    def _dispatch_fast_multi_k(
        self,
        group,
        packed_d,
        breakbits_d,
        starts_pad,
        total,
        kmers,
        rc,
        nbins,
        out_rows,
    ):
        """Issue the fast multi-k kernel (async); returns the device result
        tuple, or None when the group is ineligible (host-side check)."""
        if max(kmers) > 64:
            return None
        from ..hash.nthash_multik import (
            group_thresholds,
            multik_hash_bin_kernel,
            pick_block_geometry,
        )

        lengths = [s.seq_len for s in group] + [0] * (out_rows - len(group))
        t_lo, t_hi, eligible, max_density = group_thresholds(
            [m if m > 0 else -1 for m in lengths[: len(group)]]
            + [10**12] * (out_rows - len(group)),
            nbins,
        )
        if not eligible:
            return None
        blk, w = pick_block_geometry(max_density)
        o_hi, o_lo, found, overflow = multik_hash_bin_kernel(
            packed_d,
            breakbits_d,
            starts_pad,
            np.int32(total),
            t_lo,
            t_hi,
            kmers=tuple(kmers),
            rc=rc,
            num_bins=nbins,
            magic=self._magic(nbins),
            out_rows=out_rows,
            blk=blk,
            w=w,
        )
        return (o_hi, o_lo, found, overflow, w)

    def _collect_fast_multi_k(self, fast, kmers, g, nbins, out_rows):
        """Validate a fast-path result; returns ({k: (out_rows, nbins) u64},
        bad_rows). bad_rows lists genome rows with a missing bin (ambiguous:
        prefiltered-away vs genuinely empty) — the caller redoes ONLY those
        rows with the exact kernel (measured: typically one row with one
        missing bin per affected group, so a whole-group redo wasted ~70x
        the work). Returns (None, None) when a compaction block overflowed
        (candidates were dropped, so no row of the group is trustworthy)."""
        o_hi, o_lo, found, overflow, w = fast
        if int(overflow) > w:
            return None, None
        o_hi = np.asarray(o_hi)
        o_lo = np.asarray(o_lo)
        found = np.asarray(found)
        fd_rows = found.reshape(len(kmers), out_rows, nbins)[:, :g, :]
        bad_rows = np.where(~fd_rows.all(axis=(0, 2)))[0]
        out = {}
        for ki, kk in enumerate(kmers):
            mh = o_hi[ki].reshape(out_rows, nbins)
            ml = o_lo[ki].reshape(out_rows, nbins)
            fd = found[ki].reshape(out_rows, nbins)
            out[kk] = combine_bin_minima(mh, ml, fd)
        return out, bad_rows

    def _prepare_group(self, streams, k: int):
        """Host-side packing of a genome group: 2-bit packed stream plus
        sorted break positions and genome start offsets (the only data that
        crosses the host->device link)."""
        total = sum(s.seq_len for s in streams)
        n_pad = _bucket_size(total + MAX_K)
        codes = np.zeros(n_pad, dtype=np.uint8)
        break_parts = []
        starts = []
        pos = 0
        for s in streams:
            n = s.seq_len
            codes[pos : pos + n] = s.codes
            starts.append(pos)
            if s.breaks.size:
                break_parts.append(s.breaks + pos)
            pos += n
            # windows must never roll across a genome boundary: the parser
            # always ends a stream with a break at seq_len, but arbitrary
            # DnaStreams may not — force one (duplicates are idempotent)
            break_parts.append(np.array([pos], dtype=np.int64))
        bflags = np.zeros(n_pad, dtype=np.uint8)
        if break_parts:
            breaks = np.concatenate(break_parts)
            bflags[breaks[breaks < n_pad]] = 1
        breakbits = np.packbits(bflags, bitorder="little")
        packed = np.zeros(n_pad // 4, dtype=np.uint8)
        c = codes.reshape(-1, 4).astype(np.uint8)
        packed[:] = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
        return packed, breakbits, np.array(starts, dtype=np.int32), total

    def _dispatch_signs(self, stream: DnaStream, k: int, rc: bool, dev=None):
        """Issue the in-order hash kernel for one stream (async)."""
        n = stream.seq_len
        n_pad = _bucket_size(n + MAX_K)
        codes = np.zeros(n_pad, dtype=np.uint8)
        codes[:n] = stream.codes
        packed = np.zeros(n_pad // 4, dtype=np.uint8)
        c = codes.reshape(-1, 4)
        packed[:] = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
        taps_fwd, taps_rev = tap_tables_u32(k, rc)
        if dev is not None:
            import jax

            packed = jax.device_put(packed, dev)
        return hash_signs_kernel(packed, np.int32(k), taps_fwd, taps_rev, rc=rc)

    @staticmethod
    def _collect_signs(
        handle, stream: DnaStream, k: int, n_starts: int | None = None
    ) -> np.ndarray:
        """Valid signs for windows starting at [0, n_starts) — the whole
        stream by default; segments pass their owned-start count so
        overlap windows are not double-collected."""
        lo, hi = handle
        n = stream.seq_len
        take = n - k + 1 if n_starts is None else min(n_starts, n - k + 1)
        lo = np.asarray(lo)[:take].astype(np.uint64)
        hi = np.asarray(hi)[:take].astype(np.uint64)
        signs = (hi << np.uint64(32)) | lo
        mask = valid_window_mask(n, stream.breaks, k)[:take]
        return signs[mask]

    def dispatch_signs_maybe_filtered(
        self, stream: DnaStream, k: int, rc: bool, nbins: int,
        min_count: int, dev=None, n_starts: int | None = None,
    ):
        """Async dispatch for the FASTQ count-filter path with the device
        consult-superset prefilter (sign_prefilter.py) when eligible: only
        the subsequence the order-dependent filter could ever consult
        crosses the link (bit-identical replay; >= 4x transfer reduction
        by construction of the cap, far more on high-coverage streams).
        Returns an opaque handle for collect_signs_maybe_filtered.

        Oversized streams (> _SEG_BASES) prefilter PER SEGMENT (round 5;
        previously they silently fell back to the full stream, so the
        25 Mb bench samples never used the prefilter at all). Per-segment
        filtering is still a provable consult superset: a sign's
        min_count-th occurrence WITHIN a segment can only come at-or-
        after its min_count-th occurrence globally, so a per-segment drop
        (some smaller same-bin sign completed min_count occurrences
        earlier in the same segment) is always globally justified; the
        concatenated survivors replay bit-identically. n_starts restricts
        the emitted windows to the segment's owned starts (overlap
        windows belong to the next segment)."""
        import os

        if k > MAX_K:
            return ("seg", stream, k, rc, None, None, None, None)
        if stream.seq_len > _SEG_BASES + MAX_K:
            import jax

            devices = jax.local_devices()
            segs, spans = _segment_stream(stream)
            subs = [
                self.dispatch_signs_maybe_filtered(
                    s, k, rc, nbins, min_count,
                    devices[j % len(devices)], n_starts=p1 - p0,
                )
                for j, (s, (p0, p1)) in enumerate(zip(segs, spans))
            ]
            return ("multi", stream, k, rc, subs, None, None, None)
        # Default OFF: the prefilter cuts shipped bytes about 13x at 25x
        # coverage, but its two full-stream device sorts cost more than
        # the transfer they save on a PCIe host. Opt in with
        # SKETCHTPU_FASTQ_PREFILTER=1 on slow host links. Output is
        # bit-identical either way (consult-superset proof above).
        h = self._dispatch_signs(stream, k, rc, dev)
        eligible = min_count >= 2 and os.environ.get(
            "SKETCHTPU_FASTQ_PREFILTER", "0"
        ) in ("1", "on")
        if not eligible:
            return ("plain", stream, k, rc, h, None, None, n_starts)
        from ..hash.nthash_np import valid_window_mask
        from .sign_prefilter import prefilter_signs_device

        lo, _hi = h
        m = int(lo.shape[0])
        n = stream.seq_len
        take = max(n - k + 1, 0)
        if n_starts is not None:
            take = min(take, n_starts)
        mask = np.zeros(m + (-m) % 8, dtype=np.uint8)
        mask[:take] = valid_window_mask(n, stream.breaks, k)[:take]
        vbits = np.packbits(mask, bitorder="little")
        cap = max(4096, m // 4)
        pf = prefilter_signs_device(
            lo, _hi, vbits, min_count=min_count, num_bins=nbins,
            magic=self._magic(nbins), cap=cap,
        )
        return ("pf", stream, k, rc, h, pf, cap, n_starts)

    def collect_signs_maybe_filtered(self, handle) -> np.ndarray:
        """In-order valid signs for a dispatch_signs_maybe_filtered handle
        (the prefiltered subsequence when available — same bins after the
        host filter replay — else the full stream)."""
        kind, stream, k, rc, h, pf, cap, ns = handle
        if kind == "seg":
            return self.signs_in_order(stream, k, rc)
        if kind == "multi":
            return np.concatenate(
                [self.collect_signs_maybe_filtered(sub) for sub in h]
            )
        if kind == "pf":
            c_lo, c_hi, count = pf
            count = int(count)
            if count <= cap:
                # ship only a power-of-two bucket >= count, not the whole
                # m/4 cap: the survivor fraction is ~5-10% at real
                # coverage, so bucketed fetches cut shipped bytes by the
                # kept fraction (~13x) instead of the cap's 4x. One tiny
                # slice program compiles per (cap, bucket) pair.
                b = 4096
                while b < count:
                    b <<= 1
                b = min(b, cap)
                lo = np.asarray(_slice_prefix(c_lo, b))[:count]
                hi = np.asarray(_slice_prefix(c_hi, b))[:count]
                return (
                    hi.astype(np.uint64) << np.uint64(32)
                ) | lo.astype(np.uint64)
        return self._collect_signs(h, stream, k, n_starts=ns)

    def signs_in_order(self, stream: DnaStream, k: int, rc: bool) -> np.ndarray:
        """Valid-window signs in sequence order (for the order-dependent
        FASTQ count-filter, which must run sequentially on the host).

        Oversized streams dispatch one standard-size program per segment
        (all issued before any collect, so transfers and device compute
        overlap); each segment contributes only its owned window starts,
        so the concatenation is the exact in-order sign sequence."""
        if k > MAX_K:  # past the device tap-table width; host oracle
            from ..hash.nthash_np import nthash_valid
            from .signs import signs_from_hashes

            return signs_from_hashes(nthash_valid(stream, k, rc))
        if stream.seq_len <= _SEG_BASES + MAX_K:
            return self._collect_signs(
                self._dispatch_signs(stream, k, rc), stream, k
            )
        import jax

        devices = jax.local_devices()
        segs, spans = _segment_stream(stream)
        handles = [
            self._dispatch_signs(s, k, rc, devices[j % len(devices)])
            for j, s in enumerate(segs)
        ]
        return np.concatenate(
            [
                self._collect_signs(h, s, k, n_starts=p1 - p0)
                for h, s, (p0, p1) in zip(handles, segs, spans)
            ]
        )

    def sketch_dna_streams(
        self,
        streams: list[DnaStream],
        names: list[str],
        kmers: list[int],
        sketch_size: int,
        rc: bool,
        min_count: int,
        threads: int = 1,
    ) -> list[Sketch]:
        _s64, nbins, _u = num_bins_fn(sketch_size)

        assembly_idx = [i for i, s in enumerate(streams) if not s.reads]
        read_idx = [i for i, s in enumerate(streams) if s.reads]

        bins_per_k: dict[int, dict[int, np.ndarray]] = {kk: {} for kk in kmers}
        if assembly_idx:
            multi = self.bin_minima_multi_k(
                [streams[i] for i in assembly_idx], kmers, rc, nbins
            )
            for kk in kmers:
                for bi, i in enumerate(assembly_idx):
                    bins_per_k[kk][i] = multi[kk][bi]
        if read_idx:
            # The count filter is order-dependent *within* one (stream, k)
            # sign sequence but independent across pairs (the reference
            # rayon-parallelises whole samples, sketch/mod.rs:318-391), so
            # hash kernels dispatch ahead (round-robin over chips), the
            # main thread collects sign streams, and the sequential filter
            # loops run in a host pool (the native filter is a ctypes call
            # and releases the GIL, so --threads scales this stage).
            from concurrent.futures import ThreadPoolExecutor

            import jax

            devices = jax.local_devices()
            n_workers = max(1, threads)
            window = max(4, 2 * len(devices), n_workers)
            pending: list[tuple] = []
            filt_futs: list[tuple[int, int, object]] = []

            with ThreadPoolExecutor(max_workers=n_workers) as filt_pool:

                def collect_one():
                    kk0, i0, h = pending.pop(0)
                    signs = self.collect_signs_maybe_filtered(h)
                    filt_futs.append(
                        (kk0, i0,
                         filt_pool.submit(
                             bin_minima_filtered, signs, nbins, min_count
                         ))
                    )

                # oversized read streams also go through
                # dispatch_signs_maybe_filtered (round 5): it segments
                # them internally, prefilters each segment, and
                # dispatches every segment ahead — previously they
                # bypassed the prefilter entirely via a blocking
                # signs_in_order call here, so the 25 Mb bench samples
                # never used it
                order = [(kk, i) for kk in kmers for i in read_idx]
                for j, (kk, i) in enumerate(order):
                    if kk > MAX_K:  # past the device tap-table width
                        filt_futs.append(
                            (kk, i,
                             filt_pool.submit(
                                 bin_minima_filtered,
                                 self.signs_in_order(streams[i], kk, rc),
                                 nbins,
                                 min_count,
                             ))
                        )
                        continue
                    if len(pending) >= window:
                        collect_one()
                    pending.append(
                        (kk, i,
                         self.dispatch_signs_maybe_filtered(
                             streams[i], kk, rc, nbins, min_count,
                             devices[j % len(devices)],
                         ))
                    )
                while pending:
                    collect_one()
                for kk, i, fut in filt_futs:
                    bins_per_k[kk][i] = fut.result()

        out = []
        for i, (stream, name) in enumerate(zip(streams, names)):
            usigs_parts = []
            minhash_sum = 0.0
            densified_any = False
            for kk in kmers:
                binned = bins_per_k[kk][i].copy()
                if (binned == np.uint64(0xFFFFFFFFFFFFFFFF)).all():
                    raise ValueError("K-mer larger than smallest valid sequence")
                densified_any |= densify(binned)
                minhash_sum += float(binned[0]) / float(SIGN_MOD)
                usigs_parts.append(fill_usigs(binned))
            seq_length = (
                int(len(kmers) / minhash_sum) if stream.reads else stream.seq_len
            )
            out.append(
                Sketch(
                    name=name,
                    rc=rc,
                    reads=stream.reads,
                    seq_length=seq_length,
                    densified=densified_any,
                    acgt=tuple(int(x) for x in stream.acgt),
                    non_acgt=stream.non_acgt,
                    usigs=np.concatenate(usigs_parts),
                )
            )
        return out
