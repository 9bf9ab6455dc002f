"""Parity: fast multi-k sketching kernel vs the exact per-k kernel and the
host oracle (bit-exact whenever the fast path reports no fallback)."""

import numpy as np
import pytest

from sketchtpu.constants import SIGN_MOD
from sketchtpu.hash.nthash_multik import group_thresholds, pick_block_geometry
from sketchtpu.ingest.fastx import DnaStream
from sketchtpu.sketchcore.sketch import sketch_dna_sample
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend


def _streams(n_genomes=3, n_bases=300_000, with_breaks=True, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_genomes):
        n = n_bases + rng.integers(0, 5000)
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        breaks = []
        if with_breaks:
            # record boundaries and N positions, like multi-contig FASTA
            for p in sorted(rng.integers(1, n, 4)):
                breaks.append(int(p))
        out.append(
            DnaStream(
                codes=codes,
                breaks=np.array(sorted(set(breaks)), dtype=np.int64),
                acgt=np.bincount(codes, minlength=4).astype(np.int64),
            )
        )
    return out


def test_fast_path_is_taken_and_bit_exact():
    streams = _streams()
    names = [f"g{i}" for i in range(len(streams))]
    kmers = [15, 21, 29]
    nbins = 128

    backend = DeviceSketchBackend()
    taken = {"fast": 0}
    orig = backend._collect_fast_multi_k

    def spy(*a, **kw):
        res = orig(*a, **kw)
        if res is not None:
            taken["fast"] += 1
        return res

    backend._collect_fast_multi_k = spy
    dev = backend.sketch_dna_streams(streams, names, kmers, nbins, True, 0)
    assert taken["fast"] >= 1, "fast multi-k path was not exercised"

    host = [
        sketch_dna_sample(s, n, kmers, nbins, True, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)
        assert h.seq_length == d.seq_length
        assert h.densified == d.densified


def test_fast_path_single_strand():
    streams = _streams(n_genomes=2, seed=7)
    names = ["a", "b"]
    kmers = [17, 23]
    dev = DeviceSketchBackend().sketch_dna_streams(
        streams, names, kmers, 128, False, 0
    )
    host = [
        sketch_dna_sample(s, n, kmers, 128, False, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)


def test_small_genomes_fall_back_and_match():
    # 20k bases at 1024 bins -> prefilter ineligible -> exact kernel path
    streams = _streams(n_genomes=2, n_bases=20_000, seed=3)
    names = ["a", "b"]
    kmers = [17, 29]
    backend = DeviceSketchBackend()
    dev = backend.sketch_dna_streams(streams, names, kmers, 1024, True, 0)
    host = [
        sketch_dna_sample(s, n, kmers, 1024, True, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)


def test_group_thresholds_bounds():
    t_lo, t_hi, eligible, dens = group_thresholds([3_000_000, 2_000_000], 1024)
    assert eligible
    binsize = (SIGN_MOD + 1023) // 1024
    t0 = (int(t_hi[0]) << 32) | int(t_lo[0])
    assert 0 < t0 < binsize
    # tiny genome -> ineligible
    _, _, eligible2, _ = group_thresholds([10_000], 1024)
    assert not eligible2


def test_block_geometry_margins():
    blk, w = pick_block_geometry(0.005)
    lam = 0.005 * blk
    assert w >= lam + 6 * np.sqrt(lam)


def test_big_group_exact_fallback_split():
    """A >7-genome fast group whose fast-path validation fails must be
    re-run bit-exactly through the exact kernel in _MAX_GROUP-size chunks."""
    import sketchtpu.sketchcore.sketch_jax as sj

    streams = _streams(n_genomes=4, seed=11)
    names = [f"g{i}" for i in range(len(streams))]
    kmers = [15, 21]

    backend = sj.DeviceSketchBackend()
    # force a big fast group regardless of genome sizes...
    orig_elig = backend._fast_eligible
    backend._fast_eligible = lambda *a, **kw: True
    # ...and make its validation always fail (overflow contract)
    backend._collect_fast_multi_k = lambda *a, **kw: (None, None)
    assert len(list(backend._groups_mixed(streams, kmers, 128))) == 1
    dev = backend.sketch_dna_streams(streams, names, kmers, 128, True, 0)
    backend._fast_eligible = orig_elig

    host = [
        sketch_dna_sample(s, n, kmers, 128, True, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)


def test_single_k_fast_route_small_genomes():
    """Single-k requests on small genomes route through the fast kernel
    (larger groups) and stay bit-exact; large
    single-k genomes stay on the exact kernel."""
    rng = np.random.default_rng(5)
    streams = [
        DnaStream(
            codes=rng.integers(0, 4, n).astype(np.uint8),
            breaks=np.zeros(0, dtype=np.int64),
            acgt=np.array([1, 1, 1, 1], dtype=np.int64),
        )
        for n in (200_000, 250_000, 300_000)
    ]
    names = ["a", "b", "c"]
    kmers = [17]

    backend = DeviceSketchBackend()
    taken = {"fast": 0}
    orig = backend._collect_fast_multi_k

    def spy(*a, **kw):
        res = orig(*a, **kw)
        if res is not None:
            taken["fast"] += 1
        return res

    backend._collect_fast_multi_k = spy
    dev = backend.sketch_dna_streams(streams, names, kmers, 128, True, 0)
    assert taken["fast"] >= 1, "single-k fast route was not exercised"

    host = [
        sketch_dna_sample(s, n, kmers, 128, True, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)

    # a large single-k genome must NOT be fast-eligible
    from sketchtpu.sketchcore.sketch_jax import _SINGLEK_FAST_MAX_LEN

    big = DnaStream(
        codes=np.zeros(_SINGLEK_FAST_MAX_LEN + 1, dtype=np.uint8),
        breaks=np.zeros(0, dtype=np.int64),
    )
    assert not backend._fast_eligible(big, [17], 128)
    assert backend._fast_eligible(streams[0], [17], 128)


def test_row_level_fallback_bit_exact(monkeypatch):
    """When the prefilter loses a bin in ONE genome, only that row is
    redone through the exact kernel; the others keep the fast result.
    End-to-end output must stay bit-exact vs the host oracle."""
    from sketchtpu.hash import nthash_multik as nm
    import sketchtpu.sketchcore.sketch_jax as sj

    orig_kernel = nm.multik_hash_bin_kernel

    def lose_a_bin(*a, **kw):
        o_hi, o_lo, found, overflow = orig_kernel(*a, **kw)
        f = np.asarray(found).copy()
        shape = f.shape
        f3 = f.reshape(len(kw["kmers"]), kw["out_rows"], kw["num_bins"])
        f3[0, 1, 3] = False  # row 1: one bin "prefiltered away"
        return o_hi, o_lo, f3.reshape(shape), overflow

    monkeypatch.setattr(nm, "multik_hash_bin_kernel", lose_a_bin)

    redo_calls = []
    orig_exact = sj.DeviceSketchBackend._dispatch_exact

    def spy_exact(self, *a, **kw):
        redo_calls.append(1)
        return orig_exact(self, *a, **kw)

    monkeypatch.setattr(sj.DeviceSketchBackend, "_dispatch_exact", spy_exact)

    streams = _streams(n_genomes=3, seed=23)
    names = [f"g{i}" for i in range(len(streams))]
    kmers = [15, 21]
    backend = sj.DeviceSketchBackend()
    dev = backend.sketch_dna_streams(streams, names, kmers, 128, True, 0)
    host = [
        sketch_dna_sample(s, n, kmers, 128, True, 0)
        for s, n in zip(streams, names)
    ]
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)
    # exactly one per-row exact redo (the forced bad row), nothing else
    assert redo_calls == [1], redo_calls
