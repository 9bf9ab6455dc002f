"""Batched device amino-acid / 3Di sketching backend.

Mirrors the DNA backend (sketch_jax.py): sample streams are concatenated
into one device program per k (aaHash -> Mersenne mod -> magic-divide
binning -> sort-based scatter-min), so the whole batch's bin minima come
back in one transfer. Window emission masks are recomputed ON DEVICE from
the compact code stream (hash/aahash_jax._aa_window_mask_device — the
exact semantics of aa_window_valid, including the reference's
final-window quirk, aahash_iterator.rs:138-210), so whole-sample groups
pay no host oracle pass and no mask upload; only segments of an
oversized stream ship a host-computed pre-sliced global mask (the quirk
is a whole-sequence property). Both paths are bit-identical to the host
oracle (asserted by tests/test_aa_device.py).
"""

from __future__ import annotations

import numpy as np

from ..constants import num_bins as num_bins_fn
from ..hash.aahash_jax import (
    AA_COMPACT,
    aa_hash_bin_kernel,
    aa_hash_bin_kernel_devmask,
    aa_tap_tables_u32,
)
from ..hash.aahash_np import aa_window_valid
from ..hash.nthash_jax import MAX_K, combine_bin_minima


def _aa_hash_variant() -> str:
    """SKETCHTPU_AA_HASH selects the device aaHash formulation:
    "taps" (default), "prefix", or "rotsel" (rotate-after-select — one
    32-way seed select per position hoisted out of the tap loop, then
    fixed srol1 rotations; see aahash_jax._windowed_hash_aa_rotsel).

    Default "taps". The alternatives are bit-exact (fuzz-tested on CPU
    across levels and k) but lost to it on earlier hardware; neither has
    been measured on the GPU yet (ROADMAP D3). "prefix" (prefix-XOR
    aaHash, O(1) work per position regardless of k) pays variable-width
    field rotations per position plus two memory-bound XOR scans, and
    its compile time grows with stream length; "rotsel" adds a
    pre-selected seed stream's memory traffic per step. All three share
    the downstream mod/mask/bin-min-sort chain that bounds the total."""
    import os

    v = os.environ.get("SKETCHTPU_AA_HASH", "taps")
    if v not in ("taps", "prefix", "rotsel"):
        import logging

        logging.getLogger("sketchtpu").warning(
            "SKETCHTPU_AA_HASH=%s unknown (taps|prefix|rotsel); using taps",
            v,
        )
        return "taps"
    return v
from ..ingest.fastx import AaStream
from .sketch import Sketch
from .sketch_jax import (
    _MAX_GROUP,
    _MAX_GROUP_FAST,
    _MAX_GROUP_WIDE,
    _SEG_BASES,
    _bucket_size,
    _exact_rows,
    DeviceSketchBackend,
    segmented_min_combine,
)


def _segment_aa_stream(stream: AaStream, kmers, seg: int | None = None):
    """Split an oversized AA stream into window-covering segments (the DNA
    backend's _segment_stream, adapted): segment i owns windows starting
    in [p0, p1) with max(k)-1 overlap bases past p1; duplicates in the
    overlap are harmless for the min-reduction.

    AA window validity depends on *global* sequence position (the
    reference's final-window quirk applies only at the true sequence end,
    aahash_iterator.rs:138-210), so the oracle mask is computed once on
    the whole stream here and sliced per segment — stashed on each segment
    as `_win_valid[k]` for the masks() packer."""
    seg = seg or _SEG_BASES
    n = stream.seq_len
    kmax = max(kmers)
    global_wv = {kk: aa_window_valid(stream.seq, kk) for kk in kmers}
    segs, spans = [], []
    for p0 in range(0, n, seg):
        p1 = min(p0 + seg, n)
        end = min(p1 + kmax - 1, n)
        s = AaStream(seq=stream.seq[p0:end])
        s._win_valid = {
            kk: global_wv[kk][p0 : max(p0, end - kk + 1)] for kk in kmers
        }
        segs.append(s)
        spans.append((p0, p1))
    return segs, spans


class DeviceAaSketchBackend:
    def __init__(self):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self._magic = DeviceSketchBackend._magic

    # Group routing policy (eligibility rule, group caps, base budgets) is
    # shared with the DNA backend — the aaHash kernel has the same
    # prefilter semantics and the same 7/96-row group limits.
    _fast_eligible = staticmethod(DeviceSketchBackend._fast_eligible)
    _groups_mixed = DeviceSketchBackend._groups_mixed

    def bin_minima_multi_k(
        self,
        streams: list[AaStream],
        kmers: list[int],
        level: int,
        nbins: int,
    ) -> dict[int, np.ndarray]:
        import jax

        if max(kmers) > MAX_K:
            # k past the device tap-table width (reference allows any
            # k >= 3, io.rs:154-156): host oracle for the whole request
            from ..hash.aahash_np import aahash_valid
            from .signs import bin_minima, signs_from_hashes

            return {
                kk: np.stack(
                    [
                        bin_minima(
                            signs_from_hashes(aahash_valid(s, kk, level)),
                            nbins,
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
            lambda s: _segment_aa_stream(s, kmers),
            lambda ex: self.bin_minima_multi_k(ex, kmers, level, nbins),
        )
        if seg is not None:
            return seg

        # m = seq_len - k + 1 <= 0: the host oracle's unconditional raise
        # (aa_window_valid; set_k panic semantics). Checked up front so the
        # device-mask path needn't handle sub-k samples (whose boundary
        # interval would bleed into the previous sample).
        kmax = max(kmers)
        for s in streams:
            # segments (_win_valid) may be shorter than kmax: the whole
            # stream they came from was validated when its mask was built
            if s.seq_len < kmax and getattr(s, "_win_valid", None) is None:
                raise ValueError("K-mer larger than smallest valid sequence")

        out = {kk: np.empty((len(streams), nbins), dtype=np.uint64) for kk in kmers}

        # Same dispatch discipline as the DNA backend: issue a window of
        # groups (round-robin over local devices — sketching is per-sample
        # independent) before collecting any result, overlapping host mask
        # packing with device compute.
        devices = jax.local_devices()
        window = max(8, 2 * len(devices))
        in_flight: list[tuple] = []

        def prepare(group):
            total = sum(s.seq_len for s in group)
            n_pad = _bucket_size(total + MAX_K)
            codes = np.zeros(n_pad, dtype=np.uint8)
            starts = []
            pos = 0
            for s in group:
                codes[pos : pos + s.seq_len] = AA_COMPACT[s.seq]
                starts.append(pos)
                pos += s.seq_len
            return codes, np.array(starts, dtype=np.int32), total, n_pad

        def masks(group, kk, n_pad):
            # emission mask: exact host oracle per sample, concatenated;
            # segments of an oversized stream carry a pre-sliced global
            # mask (the final-window quirk is a whole-sequence property)
            vflags = np.zeros(n_pad, dtype=np.uint8)
            p = 0
            for s in group:
                pre = getattr(s, "_win_valid", None)
                wv = pre[kk] if pre else aa_window_valid(s.seq, kk)
                vflags[p : p + wv.shape[0]] = wv
                p += s.seq_len
            return np.packbits(vflags, bitorder="little")

        def dispatch_exact(group, codes_d, starts, total, n_pad):
            rows = _exact_rows(len(group))
            starts_pad = np.full(rows, total, dtype=np.int32)
            starts_pad[: starts.shape[0]] = starts
            # whole samples: mask recomputed on device (no host pass, no
            # upload); segments carry a pre-sliced global mask -> host path
            devmask = all(
                getattr(s, "_win_valid", None) is None for s in group
            )
            results = {}
            variant = _aa_hash_variant()
            if variant != "taps":
                from ..hash.aahash_multik import aa_seed_row_u32

                seed_row = aa_seed_row_u32(level)
            for kk in kmers:
                tab = (
                    aa_tap_tables_u32(kk, level)
                    if variant == "taps"
                    else seed_row
                )
                if devmask:
                    results[kk] = aa_hash_bin_kernel_devmask(
                        codes_d,
                        starts_pad,
                        np.int32(kk),
                        tab,
                        np.int32(total),
                        num_bins=nbins,
                        magic=self._magic(nbins),
                        out_rows=rows,
                        variant=variant,
                    )
                else:
                    results[kk] = aa_hash_bin_kernel(
                        codes_d,
                        masks(group, kk, n_pad),
                        starts_pad,
                        np.int32(kk),
                        tab,
                        num_bins=nbins,
                        magic=self._magic(nbins),
                        out_rows=rows,
                        variant=variant,
                    )
            return results

        def dispatch_fast(group, codes_d, starts, total, n_pad):
            """Fused multi-k kernel (one pass over the stream for all k);
            returns None when the group is ineligible."""
            from ..hash.aahash_multik import (
                aa_seed_row_u32,
                multik_aa_hash_bin_kernel,
            )
            from ..hash.nthash_multik import (
                group_thresholds,
                pick_block_geometry,
            )

            lengths = [s.seq_len for s in group] + [10**12] * (
                _MAX_GROUP_FAST - len(group)
            )
            t_lo, t_hi, eligible, max_density = group_thresholds(lengths, nbins)
            if not eligible:
                return None
            blk, w = pick_block_geometry(max_density)
            devmask = all(
                getattr(s, "_win_valid", None) is None for s in group
            )
            if devmask:  # masks computed on device; no host pass, no upload
                validbits_all = np.zeros((len(kmers), 1), dtype=np.uint8)
            else:
                validbits_all = np.stack(
                    [masks(group, kk, n_pad) for kk in kmers]
                )
            starts_pad = np.full(_MAX_GROUP_FAST, total, dtype=np.int32)
            starts_pad[: starts.shape[0]] = starts
            res = multik_aa_hash_bin_kernel(
                codes_d,
                validbits_all,
                starts_pad,
                t_lo,
                t_hi,
                aa_seed_row_u32(level),
                kmers=tuple(kmers),
                num_bins=nbins,
                magic=self._magic(nbins),
                out_rows=_MAX_GROUP_FAST,
                blk=blk,
                w=w,
                total=np.int32(total) if devmask else None,
                device_mask=devmask,
                variant=_aa_hash_variant(),
            )
            if devmask:
                o_hi, o_lo, found, overflow, counts = res
            else:
                o_hi, o_lo, found, overflow = res
                counts = None
            return (o_hi, o_lo, found, overflow, w, counts)

        def dispatch(start: int, end: int, is_fast: bool, dev):
            group = streams[start:end]
            codes, starts, total, n_pad = prepare(group)
            codes_d = jax.device_put(codes, dev)
            fast = exact = None
            if is_fast:
                fast = dispatch_fast(group, codes_d, starts, total, n_pad)
            if fast is None and len(group) <= _MAX_GROUP_WIDE:
                exact = dispatch_exact(group, codes_d, starts, total, n_pad)
            return start, end, codes_d, starts, total, n_pad, fast, exact

        def collect_exact(results, start, end):
            g = end - start
            for kk, res in results.items():
                if len(res) == 4:  # devmask kernel: verify reachability
                    min_hi, min_lo, found, counts = res
                    if not np.asarray(counts)[:g].all():
                        raise ValueError(
                            "K-mer larger than smallest valid sequence"
                        )
                else:
                    min_hi, min_lo, found = res
                mh = np.asarray(min_hi).reshape(-1, nbins)[:g]
                ml = np.asarray(min_lo).reshape(-1, nbins)[:g]
                fd = np.asarray(found).reshape(-1, nbins)[:g]
                out[kk][start:end] = combine_bin_minima(mh, ml, fd)

        # prefilter-missed rows, redone in one batched exact pass at the
        # end (an inline redo would block the collect loop per group)
        bad_global: list[int] = []

        def collect(item):
            start, end, codes_d, starts, total, n_pad, fast, exact = item
            g = end - start
            if fast is not None:
                o_hi, o_lo, found, overflow, w, counts = fast
                if counts is not None and not np.asarray(counts)[:, :g].all():
                    # a sample with no reachable non-final window at some k:
                    # the reference's set_k panic (found bins could still be
                    # nonzero via the final window, so this is not subsumed
                    # by the missing-bin redo)
                    raise ValueError(
                        "K-mer larger than smallest valid sequence"
                    )
                fd_all = np.asarray(found).reshape(
                    len(kmers), _MAX_GROUP_FAST, nbins
                )
                if int(overflow) <= w:
                    # compaction is intact: fast results are exact wherever
                    # bins were found; only rows with a missing (ambiguous:
                    # prefiltered-away vs genuinely empty) bin need the
                    # exact kernel — typically one row per affected group,
                    # so a whole-group redo would waste ~70x the work
                    bad_rows = np.where(~fd_all[:, :g, :].all(axis=(0, 2)))[0]
                    o_hi = np.asarray(o_hi)
                    o_lo = np.asarray(o_lo)
                    for ki, kk in enumerate(kmers):
                        mh = o_hi[ki].reshape(_MAX_GROUP_FAST, nbins)[:g]
                        ml = o_lo[ki].reshape(_MAX_GROUP_FAST, nbins)[:g]
                        out[kk][start:end] = combine_bin_minima(
                            mh, ml, fd_all[ki, :g]
                        )
                    bad_global.extend(start + int(i) for i in bad_rows)
                    return
                # block overflow dropped candidates: nothing in the group
                # is trustworthy
                if g <= _MAX_GROUP_WIDE:
                    group = streams[start:end]
                    exact = dispatch_exact(group, codes_d, starts, total, n_pad)
            if exact is not None:
                collect_exact(exact, start, end)
                return
            # fast refusal on a large group: exact kernels in wide
            # chunks (blocking; rare)
            for s0 in range(start, end, _MAX_GROUP_WIDE):
                e0 = min(s0 + _MAX_GROUP_WIDE, end)
                group = streams[s0:e0]
                codes, starts2, total2, n_pad2 = prepare(group)
                collect_exact(
                    dispatch_exact(
                        group, jax.device_put(codes), starts2, total2, n_pad2
                    ),
                    s0,
                    e0,
                )

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
        # one exact dispatch per bad row, pipelined behind the same
        # in-flight window as the main loop (bounds device memory; per-row
        # so each reuses the hot single-sample bucket shape instead of
        # compiling a novel batched total length)
        def redo_collect(item):
            i, res = item
            for kk, vals in res.items():
                if len(vals) == 4:
                    min_hi, min_lo, found2, counts = vals
                    if not np.asarray(counts)[:1].all():
                        raise ValueError(
                            "K-mer larger than smallest valid sequence"
                        )
                else:
                    min_hi, min_lo, found2 = vals
                mh = np.asarray(min_hi).reshape(-1, nbins)[:1]
                ml = np.asarray(min_lo).reshape(-1, nbins)[:1]
                fd = np.asarray(found2).reshape(-1, nbins)[:1]
                out[kk][i] = combine_bin_minima(mh, ml, fd)[0]

        handles = []
        for i in bad_global:
            if len(handles) >= window:
                redo_collect(handles.pop(0))
            group = [streams[int(i)]]
            codes, starts2, total2, n_pad2 = prepare(group)
            handles.append((int(i), dispatch_exact(
                group, jax.device_put(codes), starts2, total2, n_pad2
            )))
        for item in handles:
            redo_collect(item)
        return out

    def sketch_aa_streams(
        self,
        streams: list[AaStream],
        names: list[str],
        kmers: list[int],
        sketch_size: int,
        level: int,
        rc: bool,
    ) -> list[Sketch]:
        from .signs import densify, fill_usigs

        _s64, nbins, _u = num_bins_fn(sketch_size)
        for s, name in zip(streams, names):
            if s.seq_len == 0:
                raise ValueError(f"{name} has no valid sequence")
        bins_per_k = self.bin_minima_multi_k(streams, kmers, level, nbins)
        out = []
        for i, (stream, name) in enumerate(zip(streams, names)):
            usigs_parts = []
            densified_any = False
            for kk in kmers:
                binned = bins_per_k[kk][i].copy()
                densified_any |= densify(binned)
                usigs_parts.append(fill_usigs(binned))
            out.append(
                Sketch(
                    name=name,
                    rc=rc,
                    reads=False,
                    seq_length=stream.seq_len,
                    densified=densified_any,
                    acgt=(0, 0, 0, 0),
                    non_acgt=stream.invalid_count,
                    usigs=np.concatenate(usigs_parts),
                )
            )
        return out
