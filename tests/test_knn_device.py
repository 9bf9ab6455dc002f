"""Parity: device kNN engine vs the host (exact) drivers.

Data is constructed with high Jaccard similarity (bit-flips off a shared
base sketch) so the ANI transform stays unclamped — where distances tie
exactly, both paths break ties by lowest column index, so outputs must be
identical item-for-item.
"""

import numpy as np
import pytest

from sketchtpu.constants import BBITS
from sketchtpu.dist import api
from sketchtpu.dist.knn_jax import DeviceKnnEngine
from sketchtpu.formats.skm import MultiSketch
from sketchtpu.inverted.index import Inverted
from sketchtpu.sketchcore.sketch import HashType, Sketch


def _fake_ms(n=60, nk=2, s64=2, seed=0, kmers=(17, 21)):
    rng = np.random.default_rng(seed)
    w = s64 * BBITS
    base = rng.integers(0, 2**63, (nk, w), dtype=np.uint64)
    rows = []
    for i in range(n):
        planes = base.copy()
        # flip bits, more at larger k, so Jaccard decreases with k like real
        # genomes (a flat/symmetric J-vs-k profile is a knife-edge where the
        # regression slope sign is pure rounding noise in f64 and f32 alike)
        for ki in range(nk):
            for _ in range(1 + 3 * ki + int(rng.integers(0, 2))):
                word = rng.integers(0, w)
                bit = np.uint64(1) << np.uint64(rng.integers(0, 64))
                planes[ki, word] ^= bit
        rows.append(planes.reshape(-1))
    bins = np.concatenate(rows)
    sketches = []
    for i in range(n):
        s = Sketch(
            name=f"g{i}",
            rc=True,
            reads=False,
            seq_length=1000,
            densified=False,
            acgt=(1, 1, 1, 1),
            non_acgt=0,
        )
        s.index = i
        sketches.append(s)
    ms = MultiSketch(sketches, s64 * 64, list(kmers), HashType("dna"))
    ms.sketch_bins = bins
    return ms


def _assert_rows_equal(dev_rows, host_rows):
    assert len(dev_rows) == len(host_rows)
    for r, (dr, hr) in enumerate(zip(dev_rows, host_rows)):
        assert len(dr) == len(hr), f"row {r}: {len(dr)} != {len(hr)}"
        for (di, dd), (hi, hd) in zip(dr, hr):
            assert di == hi, f"row {r}: index {di} != {hi}"
            assert np.float32(dd) == np.float32(hd), f"row {r}: {dd} != {hd}"


@pytest.mark.parametrize("ani", [False, True])
def test_self_knn_matches_host(ani):
    ms = _fake_ms()
    dist_type = api.set_k(ms, 17, ani)
    knn = 7
    host = api.self_dists_knn(ms, knn, dist_type)
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).self_knn(knn, dist_type)
    _assert_rows_equal(dev, host)


def test_cross_knn_matches_host():
    refs = _fake_ms(n=40, seed=1)
    queries = _fake_ms(n=13, seed=2)
    dist_type = api.set_k(refs, 21, False)
    knn = 5
    host = api.cross_dists_knn(refs, queries, knn, dist_type)
    dev = DeviceKnnEngine(refs, row_tile=8, col_tile=16).cross_knn(
        queries, knn, dist_type
    )
    _assert_rows_equal(dev, host)


def test_self_knn_coreacc_close_to_host():
    ms = _fake_ms(n=30, nk=4, kmers=(17, 21, 25, 29), seed=3)
    dist_type = api.set_k(ms, None, False)
    knn = 4
    host = api.self_dists_knn(ms, knn, dist_type)
    dev = DeviceKnnEngine(ms, row_tile=8, col_tile=16).self_knn_coreacc(knn)
    # f32 device pipeline: selected distances must match the host's selected
    # distances to ~1e-4 (indices may swap among near-ties)
    for dr, hr in zip(dev, host):
        d_cores = sorted(c for _, c, _ in dr)
        h_cores = sorted(c for _, c, _ in hr)
        np.testing.assert_allclose(d_cores, h_cores, atol=2e-4)


@pytest.mark.parametrize("retain", [None, "singleton", "bruteforce"])
def test_precluster_knn_matches_host(retain):
    ms = _fake_ms(n=50, seed=4)
    rng = np.random.default_rng(5)
    stride = 37
    # small alphabet -> plenty of candidates; a few isolated rows with a
    # private alphabet -> no candidates (exercises retain_unmatched)
    signs = rng.integers(0, 25, (50, stride), dtype=np.uint16)
    for iso in (7, 23, 41):
        signs[iso] = rng.integers(1000 + iso * 50, 1000 + iso * 50 + 40, stride)
    # the .ski ordering differs from the .skd ordering
    perm = rng.permutation(50)
    inv = Inverted(
        sign_matrix=signs[perm],
        sample_names=[f"g{i}" for i in perm],
        kmer_size=17,
        rc=True,
        hash_type=HashType("dna"),
    )
    skq_flat = inv.sign_matrix.reshape(-1)
    dist_type = api.set_k(ms, 17, False)
    knn = 6
    host = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, knn, dist_type, retain_unmatched=retain
    )
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain
    )
    # On exact distance ties the host keeps candidates in .ski iteration
    # order while the device keeps the lowest .skd index — both valid (the
    # reference's own order is heap-implementation-defined). Distances and
    # structure must agree exactly; indices must agree wherever the distance
    # is unique in its row.
    assert len(dev) == len(host)
    for r, (dr, hr) in enumerate(zip(dev, host)):
        assert len(dr) == len(hr), f"row {r}"
        d_dists = [np.float32(d) for _, d in dr]
        h_dists = [np.float32(d) for _, d in hr]
        assert d_dists == h_dists, f"row {r}: {d_dists} != {h_dists}"
        for c, ((di, dd), (hi, hd)) in enumerate(zip(dr, hr)):
            if h_dists.count(np.float32(hd)) == 1:
                assert di == hi, f"row {r} col {c}: index {di} != {hi}"


def _coreacc_precluster_fixture(n=40, seed=6):
    ms = _fake_ms(n=n, nk=4, kmers=(17, 21, 25, 29), seed=seed)
    rng = np.random.default_rng(seed + 1)
    stride = 29
    signs = rng.integers(0, 20, (n, stride), dtype=np.uint16)
    for iso in (5, 19):  # private alphabets -> zero candidates
        signs[iso] = rng.integers(
            1000 + iso * 50, 1000 + iso * 50 + 30, stride
        )
    perm = rng.permutation(n)
    inv = Inverted(
        sign_matrix=signs[perm],
        sample_names=[f"g{i}" for i in perm],
        kmer_size=17,
        rc=True,
        hash_type=HashType("dna"),
    )
    return ms, inv, inv.sign_matrix.reshape(-1), stride


def test_precluster_coreacc_host_matches_dense_oracle():
    """Extension (the reference panics `unimplemented!` here,
    distances/mod.rs:548-550): per-row candidates from the inverted
    prefilter, ranked by multi-k core distance. Oracle: the (tested)
    dense core/acc pipeline + a brute-force candidate filter."""
    ms, inv, skq_flat, stride = _coreacc_precluster_fixture()
    n = ms.number_samples_loaded()
    knn = 5
    dist_type = api.set_k(ms, None, False)
    rows = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, knn, dist_type
    )
    dense = api.self_dists_all(ms, dist_type)  # (n_pairs, 2) f32

    def dense_pair(i, j):
        a, b = min(i, j), max(i, j)
        # upper-triangle row-major condensed index
        return dense[a * n - a * (a + 1) // 2 + (b - a - 1)]

    skd_of_name = {ms.sketch_name(i): i for i in range(n)}
    ski_of_skd = np.array(
        [inv.sample_names.index(ms.sketch_name(i)) for i in range(n)]
    )
    mat = inv.sign_matrix
    for i in range(n):
        cands = [
            j
            for j in range(n)
            if j != i
            and (mat[ski_of_skd[i]] == mat[ski_of_skd[j]]).any()
        ]
        all_cands = sorted(
            ((float(dense_pair(i, j)[0]), j) for j in cands)
        )
        want = all_cands[:knn]
        got = [(float(c), j) for j, c, _ in rows[i]]
        assert len(got) == len(want), f"row {i}"
        np.testing.assert_allclose(
            [c for c, _ in got], [c for c, _ in want], atol=1e-6
        )
        for (gc, gj), (wc, wj) in zip(got, want):
            # indices must agree when the core distance is unique among
            # ALL candidates (ties may resolve either way)
            if sum(abs(wc - c) < 1e-9 for c, _ in all_cands) == 1:
                assert gj == wj, f"row {i}"
        for j, c, a in rows[i]:
            np.testing.assert_allclose(
                [c, a], dense_pair(i, j), atol=1e-6
            )
    assert skd_of_name  # silence unused warning


@pytest.mark.parametrize("retain", [None, "singleton", "bruteforce"])
def test_precluster_knn_coreacc_device_matches_host(retain):
    ms, inv, skq_flat, stride = _coreacc_precluster_fixture()
    dist_type = api.set_k(ms, None, False)
    knn = 5
    host = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, knn, dist_type, retain_unmatched=retain
    )
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain
    )
    assert len(dev) == len(host)
    for r, (dr, hr) in enumerate(zip(dev, host)):
        assert len(dr) == len(hr), f"row {r}: {len(dr)} != {len(hr)}"
        d_cores = sorted(c for _, c, _ in dr)
        h_cores = sorted(c for _, c, _ in hr)
        np.testing.assert_allclose(d_cores, h_cores, atol=2e-4)
        # f32 vs f64 pipelines: indices must agree where the row's core
        # distances are well separated
        h_sorted = sorted(h_cores)
        seps = all(
            b - a > 1e-3 for a, b in zip(h_sorted, h_sorted[1:])
        )
        if seps:
            assert [j for j, _, _ in dr] == [j for j, _, _ in hr], f"row {r}"

    # row_range slicing matches the corresponding host rows
    dev_slice = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain,
        row_range=slice(8, 24),
    )
    assert len(dev_slice) == 16
    for dr, fr in zip(dev_slice, dev[8:24]):
        assert [j for j, _, _ in dr] == [j for j, _, _ in fr]


def test_precluster_coreacc_completeness_host():
    """--core-acc with a completeness file takes the host driver (like
    every completeness run); corrected values must equal the dense
    pipeline's corrected values pair-for-pair."""
    ms, inv, skq_flat, stride = _coreacc_precluster_fixture(n=24, seed=9)
    n = ms.number_samples_loaded()
    rng = np.random.default_rng(10)
    comp = np.clip(rng.uniform(0.7, 1.0, n), 0.0, 1.0)
    dist_type = api.set_k(ms, None, False)
    rows = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, 4, dist_type, completeness_vec=comp
    )
    dense = api.self_dists_all(ms, dist_type, completeness_vec=comp)

    def dense_pair(i, j):
        a, b = min(i, j), max(i, j)
        return dense[a * n - a * (a + 1) // 2 + (b - a - 1)]

    for i in range(n):
        for j, c, a in rows[i]:
            np.testing.assert_allclose([c, a], dense_pair(i, j), atol=1e-6)


def test_self_knn_coreacc_completeness_close_to_host():
    """Completeness-corrected core/acc kNN runs on device (XLA tile; the
    selection key is the corrected f32 core distance)."""
    ms = _fake_ms(n=30, nk=4, kmers=(17, 21, 25, 29), seed=12)
    rng = np.random.default_rng(13)
    comp = rng.uniform(0.7, 1.0, 30)
    dist_type = api.set_k(ms, None, False)
    knn = 4
    host = api.self_dists_knn(ms, knn, dist_type, completeness_vec=comp)
    dev = DeviceKnnEngine(ms, row_tile=8, col_tile=16).self_knn_coreacc(
        knn, completeness_vec=comp
    )
    for dr, hr in zip(dev, host):
        np.testing.assert_allclose(
            sorted(c for _, c, _ in dr),
            sorted(c for _, c, _ in hr),
            atol=2e-4,
        )


def test_precluster_coreacc_completeness_device_matches_host():
    ms, inv, skq_flat, stride = _coreacc_precluster_fixture(n=32, seed=14)
    rng = np.random.default_rng(15)
    comp = rng.uniform(0.7, 1.0, 32)
    dist_type = api.set_k(ms, None, False)
    host = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, 4, dist_type, completeness_vec=comp
    )
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, 4, dist_type, completeness_vec=comp
    )
    assert len(dev) == len(host)
    for r, (dr, hr) in enumerate(zip(dev, host)):
        assert len(dr) == len(hr), f"row {r}"
        np.testing.assert_allclose(
            sorted(c for _, c, _ in dr),
            sorted(c for _, c, _ in hr),
            atol=2e-4,
        )


def test_self_knn_singlek_completeness_matches_host():
    """Single-k kNN with completeness: device selects by corrected f32
    Jaccard, host recomputes exact f64 values from the selected samebits."""
    ms = _fake_ms(n=40, nk=2, kmers=(17, 21), seed=18)
    rng = np.random.default_rng(19)
    comp = rng.uniform(0.7, 1.0, 40)
    knn = 5
    for ani in (False, True):
        dist_type = api.set_k(ms, 17, ani)
        host = api.self_dists_knn(
            ms, knn, dist_type, completeness_vec=comp
        )
        dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).self_knn(
            knn, dist_type, completeness_vec=comp
        )
        for r, (dr, hr) in enumerate(zip(dev, host)):
            d_dists = sorted(np.float32(d) for _, d in dr)
            h_dists = sorted(np.float32(d) for _, d in hr)
            np.testing.assert_allclose(
                d_dists, h_dists, atol=1e-6, err_msg=f"row {r} ani={ani}"
            )


def test_precluster_singlek_completeness_matches_host():
    ms, inv, skq_flat, stride = _coreacc_precluster_fixture(n=30, seed=23)
    rng = np.random.default_rng(24)
    comp = rng.uniform(0.7, 1.0, 30)
    dist_type = api.set_k(ms, 17, False)
    for retain in (None, "singleton", "bruteforce"):
        host = api.self_dists_knn_precluster(
            ms, inv, skq_flat, stride, 4, dist_type,
            completeness_vec=comp, retain_unmatched=retain,
        )
        dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
            inv, skq_flat, 4, dist_type, retain_unmatched=retain,
            completeness_vec=comp,
        )
        assert len(dev) == len(host)
        for r, (dr, hr) in enumerate(zip(dev, host)):
            assert len(dr) == len(hr), (r, retain)
            d_dists = sorted(np.float32(d) for _, d in dr)
            h_dists = sorted(np.float32(d) for _, d in hr)
            np.testing.assert_allclose(
                d_dists, h_dists, atol=1e-6, err_msg=f"row {r} {retain}"
            )


def test_grouped_merge_path_matches_host():
    """Engine shapes that trigger the two-stage grouped top-k merge
    (col_tile/8 groups > knn — see _tile_topk_reduce) must match the host
    item-for-item, in plain and masked (precluster) modes."""
    from sketchtpu.dist.knn_jax import _MERGE_GROUP

    n, knn, col_tile = 300, 8, 256
    assert col_tile // _MERGE_GROUP > knn  # grouped reduce active
    ms = _fake_ms(n=n, nk=2, kmers=(17, 21), seed=31)
    dist_type = api.set_k(ms, 17, False)
    host = api.self_dists_knn(ms, knn, dist_type)
    dev = DeviceKnnEngine(ms, row_tile=64, col_tile=col_tile).self_knn(
        knn, dist_type
    )
    for r, (dr, hr) in enumerate(zip(dev, host)):
        assert [(i, np.float32(v)) for i, v in dr] == [
            (i, np.float32(v)) for i, v in hr
        ], f"row {r}"

    # masked (precluster) mode through the same grouped merge
    rng = np.random.default_rng(32)
    stride = 19
    signs = rng.integers(0, 9, (n, stride), dtype=np.uint16)
    inv = Inverted(
        sign_matrix=signs,
        sample_names=[ms.sketch_name(i) for i in range(n)],
        kmer_size=17,
        rc=True,
        hash_type=HashType("dna"),
    )
    skq_flat = signs.reshape(-1)
    host_pc = api.self_dists_knn_precluster(
        ms, inv, skq_flat, stride, knn, dist_type
    )
    dev_pc = DeviceKnnEngine(ms, row_tile=64, col_tile=col_tile).precluster_knn(
        inv, skq_flat, knn, dist_type
    )
    for r, (dr, hr) in enumerate(zip(dev_pc, host_pc)):
        np.testing.assert_allclose(
            sorted(np.float32(v) for _, v in dr),
            sorted(np.float32(v) for _, v in hr),
            atol=0,
            err_msg=f"row {r}",
        )

    # core/accessory through the grouped merge (XLA tile on CPU CI)
    dt_ca = api.set_k(ms, None, False)
    host_ca = api.self_dists_knn(ms, knn, dt_ca)
    dev_ca = DeviceKnnEngine(
        ms, row_tile=64, col_tile=col_tile
    ).self_knn_coreacc(knn)
    for r, (dr, hr) in enumerate(zip(dev_ca, host_ca)):
        np.testing.assert_allclose(
            sorted(c for _, c, _ in dr),
            sorted(c for _, c, _ in hr),
            atol=2e-4,
            err_msg=f"row {r}",
        )


def test_coreacc_knn_values_exact():
    """Core/acc kNN now emits EXACT f64-pipeline values for the selected
    pairs (selection stays f32): each returned (i, j, core, acc) must equal
    the host oracle's computation for that pair bit for bit."""
    from sketchtpu.dist.jaccard_np import (
        core_acc_from_jaccards,
        jaccard_from_samebits,
        samebits_matrix,
    )

    ms = _fake_ms(n=40, nk=4, kmers=(17, 21, 25, 29), seed=41)
    dist_type = api.set_k(ms, None, False)
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).self_knn_coreacc(5)
    kmers = list(ms.kmer_lengths)
    for i, row in enumerate(dev):
        for j, core, acc in row:
            jaccs = np.empty((1, len(kmers)))
            for ki in range(len(kmers)):
                a = np.ascontiguousarray(ms.bins_matrix(ki)[i : i + 1])
                b = np.ascontiguousarray(ms.bins_matrix(ki)[j : j + 1])
                sb = samebits_matrix(a, b)[0, 0]
                jaccs[0, ki] = jaccard_from_samebits(
                    np.array([sb]), ms.sketchsize64
                )[0]
            core_x, acc_x = core_acc_from_jaccards(
                jaccs, kmers, ms.sketch_size
            )
            assert np.float32(core_x[0]) == core, (i, j)
            assert np.float32(acc_x[0]) == acc, (i, j)


def test_coreacc_knn_completeness_values_exact():
    """Same exactness with the MAG completeness correction applied."""
    from sketchtpu.dist.jaccard_np import (
        core_acc_from_jaccards,
        jaccard_from_samebits,
        samebits_matrix,
    )

    ms = _fake_ms(n=30, nk=4, kmers=(17, 21, 25, 29), seed=42)
    rng = np.random.default_rng(43)
    comp = rng.uniform(0.7, 1.0, 30)
    dist_type = api.set_k(ms, None, False)
    dev = DeviceKnnEngine(ms, row_tile=8, col_tile=16).self_knn_coreacc(
        4, completeness_vec=comp
    )
    kmers = list(ms.kmer_lengths)
    for i, row in enumerate(dev):
        for j, core, acc in row:
            jaccs = np.empty((1, len(kmers)))
            for ki in range(len(kmers)):
                a = np.ascontiguousarray(ms.bins_matrix(ki)[i : i + 1])
                b = np.ascontiguousarray(ms.bins_matrix(ki)[j : j + 1])
                sb = samebits_matrix(a, b)[0, 0]
                jaccs[0, ki] = jaccard_from_samebits(
                    np.array([sb]), ms.sketchsize64,
                    np.array([comp[i]]), np.array([comp[j]]), 0.64,
                )[0]
            core_x, acc_x = core_acc_from_jaccards(
                jaccs, kmers, ms.sketch_size
            )
            assert np.float32(core_x[0]) == core, (i, j)
            assert np.float32(acc_x[0]) == acc, (i, j)
