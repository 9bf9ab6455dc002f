"""Device (JAX) sketching path must be bit-identical to the host oracle.

Runs on the CPU backend in tests (conftest defaults JAX_PLATFORMS to cpu);
the same code path runs on the GPU.
"""

import numpy as np
import pytest

from sketchtpu.hash.nthash_jax import magic_divider
from sketchtpu.constants import SIGN_MOD


def test_magic_divider_exact():
    rng = np.random.default_rng(0)
    for nbins in [64, 1024, 10048, 10, 1000, 999, 123456]:
        d = (SIGN_MOD + nbins - 1) // nbins
        m, s = magic_divider(d, nbins)
        # exhaustive boundary + random check with Python ints
        for b in list(range(0, min(nbins, 50))) + [nbins - 1, nbins // 2]:
            for x in (b * d, b * d - 1, b * d + 1):
                if 0 <= x < SIGN_MOD:
                    assert (x * m) >> s == x // d, (nbins, b, x)
        for x in rng.integers(0, SIGN_MOD, 200, dtype=np.uint64).tolist():
            assert (x * m) >> s == x // d


def test_mul_shift_kernel():
    import jax.numpy as jnp

    from sketchtpu.hash.nthash_jax import _mul_shift

    rng = np.random.default_rng(1)
    xs = rng.integers(0, SIGN_MOD, 1000, dtype=np.uint64)
    for nbins in [1024, 10048, 10]:
        d = (SIGN_MOD + nbins - 1) // nbins
        m, s = magic_divider(d, nbins)
        lo = jnp.asarray((xs & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        hi = jnp.asarray((xs >> np.uint64(32)).astype(np.uint32))
        got = np.asarray(_mul_shift(lo, hi, m, s))
        want = (xs // np.uint64(d)).astype(np.int32)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k,rc", [(17, True), (21, True), (9, False)])
def test_device_hash_matches_oracle(k, rc):
    from sketchtpu.hash.nthash_jax import (
        MAX_K,
        hash_signs_kernel,
        tap_tables_u32,
    )
    from sketchtpu.hash.nthash_np import nthash_all

    rng = np.random.default_rng(2)
    n = 5000
    n_pad = 8192
    codes = np.zeros(n_pad, dtype=np.uint8)
    codes[:n] = rng.integers(0, 4, n).astype(np.uint8)
    c = codes.reshape(-1, 4)
    packed = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    taps_fwd, taps_rev = tap_tables_u32(k, rc)
    lo, hi = hash_signs_kernel(packed, np.int32(k), taps_fwd, taps_rev, rc=rc)
    got = (
        np.asarray(hi)[: n - k + 1].astype(np.uint64) << np.uint64(32)
    ) | np.asarray(lo)[: n - k + 1].astype(np.uint64)
    from sketchtpu.sketchcore.signs import signs_from_hashes

    want = signs_from_hashes(nthash_all(codes[:n], k, rc))
    assert np.array_equal(got, want)


import jax.numpy as jnp  # noqa: E402


def _synthetic_streams(n_genomes=3, length=30000, with_breaks=True, seed=3):
    """Small random genomes (fast enough for the single-core CPU backend in
    tests)."""
    from sketchtpu.ingest.fastx import DnaStream

    rng = np.random.default_rng(seed)
    streams = []
    for gi in range(n_genomes):
        n = length + gi * 977
        codes = rng.integers(0, 4, n).astype(np.uint8)
        breaks = [n]
        if with_breaks:
            breaks = sorted(
                set(rng.integers(1, n, 5).tolist() + [n // 2, n])
            )
        streams.append(
            DnaStream(
                codes=codes,
                breaks=np.array(breaks, dtype=np.int64),
                acgt=np.bincount(codes, minlength=4).astype(np.int64),
            )
        )
    return streams


def test_device_sketch_bit_exact_vs_host():
    from sketchtpu.sketchcore.sketch import sketch_dna_sample
    from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend

    streams = _synthetic_streams()
    names = [f"g{i}" for i in range(len(streams))]
    kmers = [17, 29]
    host = [
        sketch_dna_sample(s, n, kmers, 1024, True, 0)
        for s, n in zip(streams, names)
    ]
    dev = DeviceSketchBackend().sketch_dna_streams(
        streams, names, kmers, 1024, True, 0
    )
    for h, d in zip(host, dev):
        assert np.array_equal(h.usigs, d.usigs)
        assert h.seq_length == d.seq_length
        assert h.densified == d.densified


def test_device_sketch_nonpow2_bins():
    from sketchtpu.sketchcore.sketch import sketch_dna_sample
    from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend

    streams = _synthetic_streams(1, 20000, with_breaks=False, seed=5)
    host = [sketch_dna_sample(streams[0], "g0", [21], 10048, True, 0)]
    dev = DeviceSketchBackend().sketch_dna_streams(
        streams, ["g0"], [21], 10048, True, 0
    )
    assert np.array_equal(host[0].usigs, dev[0].usigs)


def test_dense_stream_engine_bit_exact():
    """The streaming dense engine (device samebits + host f64 chain) must
    produce byte-identical output to the host driver, including ANI and
    completeness correction."""
    import io

    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.jaccard_jax import DeviceDenseStreamEngine
    from sketchtpu.dist.output import write_dense_self

    ms = _fake_ms(n=37, nk=2, s64=4, kmers=(17, 21), seed=5)
    names = [f"g{i}" for i in range(37)]
    rng = np.random.default_rng(0)
    comp = rng.uniform(0.6, 1.0, 37)
    for ani in (False, True):
        for use_comp in (False, True):
            dist_type = api.set_k(ms, 17, ani)
            c = comp if use_comp else None
            d = api.self_dists_all(ms, dist_type, c, 0.64)
            want = io.StringIO()
            write_dense_self(want, names, d, False)
            got = io.StringIO()
            DeviceDenseStreamEngine(ms, dist_type.k_idx, tile=16).stream_self_dense(
                got, names, dist_type, c, 0.64
            )
            assert got.getvalue() == want.getvalue(), (ani, use_comp)


def test_cross_dense_stream_engine_bit_exact():
    """Cross streaming engine must match the host cross driver + writer
    byte-for-byte, including completeness on both sides."""
    import io
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.jaccard_jax import DeviceDenseStreamEngine
    from sketchtpu.dist.output import write_dense_cross

    refs = _fake_ms(n=23, nk=2, s64=4, kmers=(17, 21), seed=6)
    queries = _fake_ms(n=11, nk=2, s64=4, kmers=(17, 21), seed=7)
    rnames = [f"r{i}" for i in range(23)]
    qnames = [f"q{i}" for i in range(11)]
    rng = np.random.default_rng(1)
    rcomp = rng.uniform(0.6, 1.0, 23)
    qcomp = rng.uniform(0.6, 1.0, 11)
    for ani in (False, True):
        for use_comp in (False, True):
            dist_type = api.set_k(refs, 17, ani)
            rc_ = rcomp if use_comp else None
            qc_ = qcomp if use_comp else None
            d = api.cross_dists_all(refs, queries, dist_type, rc_, qc_, 0.64)
            want = io.StringIO()
            write_dense_cross(want, rnames, qnames, d, False)
            got = io.StringIO()
            DeviceDenseStreamEngine(refs, dist_type.k_idx, tile=16).stream_cross_dense(
                got, rnames, qnames, queries, dist_type, rc_, qc_, 0.64
            )
            assert got.getvalue() == want.getvalue(), (ani, use_comp)
