"""Device FASTQ sign prefilter: replaying the exact count filter on the
kept subsequence must reproduce the full-stream bins bit-for-bit."""

import numpy as np
import pytest

import jax.numpy as jnp

from sketchtpu.sketchcore.sign_prefilter import prefilter_signs_device
from sketchtpu.sketchcore.sketch_jax import bin_magic
from sketchtpu.sketchcore.signs import bin_minima_filtered, bin_size

_SIGN_MOD = (1 << 61) - 1


def _run_case(seed, m, nbins, min_count, sign_space, invalid_frac=0.1):
    rng = np.random.default_rng(seed)
    # heavy collisions: draw from a small set of sign values concentrated
    # in low bins (the bin-min region) so the filter state actually matters
    values = rng.integers(0, sign_space, 400).astype(np.uint64)
    signs = rng.choice(values, m)
    valid = rng.random(m) >= invalid_frac
    vbits = np.packbits(
        np.pad(valid, (0, (-m) % 8)), bitorder="little"
    )
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    cap = m  # correctness test: no fallback
    c_lo, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits),
        min_count=min_count, num_bins=nbins, magic=bin_magic(nbins),
        cap=cap,
    )
    count = int(count)
    surv = (
        np.asarray(c_hi)[:count].astype(np.uint64) << np.uint64(32)
    ) | np.asarray(c_lo)[:count].astype(np.uint64)
    full = signs[valid]
    want = bin_minima_filtered(full, nbins, min_count)
    got = bin_minima_filtered(surv, nbins, min_count)
    np.testing.assert_array_equal(got, want)
    return count, full.size


@pytest.mark.parametrize("min_count", [2, 3, 5])
def test_prefilter_replay_bit_exact(min_count):
    for seed in range(4):
        _run_case(
            seed, m=4000, nbins=64, min_count=min_count,
            sign_space=int(bin_size(64)) * 64,
        )


def test_prefilter_drops_most_of_a_high_coverage_stream():
    # high coverage: few distinct signs, many occurrences -> most of the
    # stream is provably unconsultable
    count, full = _run_case(
        9, m=20000, nbins=16, min_count=5,
        sign_space=int(bin_size(16)) * 16,
    )
    assert count < full // 3, (count, full)


def test_prefilter_keeps_everything_when_counts_never_reach_mc():
    # every sign unique -> no sign ever reaches min_count occurrences ->
    # nothing is provably unconsultable, everything ships
    rng = np.random.default_rng(3)
    m, nbins = 1000, 16
    signs = rng.permutation(
        np.arange(1, m + 1, dtype=np.uint64) * np.uint64(12345701)
    ) % np.uint64(int(bin_size(nbins)) * nbins)
    signs = np.unique(signs)
    m = signs.size
    vbits = np.packbits(np.ones(m + (-m) % 8, np.uint8), bitorder="little")
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    c_lo, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits),
        min_count=2, num_bins=nbins, magic=bin_magic(nbins), cap=m,
    )
    assert int(count) == m
    got = (
        np.asarray(c_hi)[:m].astype(np.uint64) << np.uint64(32)
    ) | np.asarray(c_lo)[:m].astype(np.uint64)
    np.testing.assert_array_equal(got, signs)  # stream order preserved


def test_prefilter_out_of_range_bins_dropped():
    # signs with bin >= num_bins are never consulted (mod.rs:198-208
    # `if bin >= nbins continue`) and must not ship
    nbins = 16
    top = np.uint64(int(bin_size(nbins)) * nbins)
    signs = np.array(
        [5, top + np.uint64(7), 5, top + np.uint64(9), 5], dtype=np.uint64
    )
    m = signs.size
    vbits = np.packbits(np.ones(8, np.uint8), bitorder="little")
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    _, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits),
        min_count=2, num_bins=nbins, magic=bin_magic(nbins), cap=m,
    )
    assert int(count) == 3  # only the three in-range occurrences


def test_blocked_scan_bit_exact_vs_flat():
    """_blocked_scan (the two-level lowering that keeps the 16.7M-window
    prefilter graph quick to compile) must
    reproduce jax.lax.associative_scan exactly for both this module's
    ops, forward and reverse, at block-multiple AND ragged sizes."""
    import jax

    from sketchtpu.sketchcore.sign_prefilter import _SCAN_BLOCK, _blocked_scan

    rng = np.random.default_rng(3)
    for n in (_SCAN_BLOCK * 3, _SCAN_BLOCK * 2 + 4097, 300):
        flags = jnp.asarray(rng.random(n) < 0.01)
        vals = jnp.asarray(
            rng.integers(0, 2**31 - 1, n).astype(np.int32)
        )

        def op(a, b):
            fa, va = a
            fb, vb = b
            return fa | fb, jnp.where(fb, vb, jnp.minimum(va, vb))

        for rev in (False, True):
            _, got = _blocked_scan(op, (flags, vals), reverse=rev)
            _, want = jax.lax.associative_scan(
                op, (flags, vals), reverse=rev
            )
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        got = _blocked_scan(jnp.maximum, jnp.where(flags, vals, -1))
        want = jax.lax.associative_scan(
            jnp.maximum, jnp.where(flags, vals, -1)
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_prefilter_replay_bit_exact_blocked_path():
    """The full prefilter at a stream long enough to take the blocked
    scan path (> _SCAN_BLOCK windows) must keep a superset whose replay
    reproduces the full-stream bins exactly (high-collision stream so
    the count filter and per-bin minima interact)."""
    from sketchtpu.sketchcore.sign_prefilter import _SCAN_BLOCK
    from sketchtpu.sketchcore.signs import bin_minima_filtered

    rng = np.random.default_rng(11)
    nbins, mc = 32, 3
    m = _SCAN_BLOCK + 4321
    # heavy collisions: draw from a small sign universe
    signs = rng.integers(0, 5000, m).astype(np.uint64) * np.uint64(
        int(bin_size(nbins)) // 4096
    )
    vmask = (rng.random(m) < 0.98).astype(np.uint8)
    vbits = np.packbits(
        np.pad(vmask, (0, (-m) % 8)), bitorder="little"
    )
    lo = (signs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (signs >> np.uint64(32)).astype(np.uint32)
    c_lo, c_hi, count = prefilter_signs_device(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(vbits),
        min_count=mc, num_bins=nbins, magic=bin_magic(nbins), cap=m,
    )
    count = int(count)
    assert 0 < count < m
    kept = (
        np.asarray(c_hi[:count]).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(c_lo[:count]).astype(np.uint64)
    full = signs[vmask.astype(bool)]
    np.testing.assert_array_equal(
        bin_minima_filtered(kept, nbins, mc),
        bin_minima_filtered(full, nbins, mc),
    )


def test_prefilter_segmented_oversized_stream_bit_exact(monkeypatch):
    """Oversized reads streams (> _SEG_BASES) prefilter PER SEGMENT
    (round 5; previously they silently skipped the prefilter). The
    concatenated per-segment survivors must replay to the same bins as
    the full in-order stream — the per-segment drop rule is a subset of
    the globally-justified drops, so the kept set is still a consult
    superset."""
    import sketchtpu.sketchcore.sketch_jax as sj
    from sketchtpu.ingest.fastx import DnaStream
    from sketchtpu.sketchcore.signs import bin_minima_filtered

    monkeypatch.setenv("SKETCHTPU_FASTQ_PREFILTER", "1")
    monkeypatch.setattr(sj, "_SEG_BASES", 16384)
    rng = np.random.default_rng(23)
    k, nbins, mc = 17, 64, 3
    glen = 3000
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    read_len, n_reads = 150, 400  # 60k bases @ ~20x over 4 segments
    codes = np.empty(n_reads * read_len, dtype=np.uint8)
    for i, s in enumerate(rng.integers(0, glen - read_len, n_reads)):
        seg = genome[s : s + read_len]
        if i % 2:
            seg = 3 - seg[::-1]
        codes[i * read_len : (i + 1) * read_len] = seg
    breaks = np.arange(1, n_reads, dtype=np.int64) * read_len
    stream = DnaStream(
        codes=codes, breaks=breaks,
        acgt=np.array([1, 1, 1, 1], dtype=np.int64), reads=True,
    )
    be = sj.DeviceSketchBackend()
    h = be.dispatch_signs_maybe_filtered(stream, k, True, nbins, mc)
    assert h[0] == "multi"
    assert any(sub[0] == "pf" for sub in h[4])
    surv = be.collect_signs_maybe_filtered(h)
    full = be.signs_in_order(stream, k, True)
    assert surv.size < full.size  # something was actually dropped
    np.testing.assert_array_equal(
        bin_minima_filtered(surv, nbins, mc),
        bin_minima_filtered(full, nbins, mc),
    )
