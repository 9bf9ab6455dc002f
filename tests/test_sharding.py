"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from sketchtpu.dist.jaccard_np import samebits_matrix


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()


def test_sharded_samebits_matches_host(eight_devices):
    from sketchtpu.shard.mesh import ShardedSamebitsEngine, make_mesh

    s64 = 16
    w = s64 * 14
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**63, (37, w), dtype=np.uint64)
    b = rng.integers(0, 2**63, (23, w), dtype=np.uint64)
    want = samebits_matrix(a, b)

    for rows, words in [(8, 1), (4, 2), (2, 4)]:
        mesh = make_mesh(n_rows=rows, n_words=words)
        engine = ShardedSamebitsEngine(s64, mesh)
        got = engine.matrix(a, b)
        assert np.array_equal(got, want), (rows, words)


def test_sharded_dist_step(eight_devices):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sketchtpu.shard.mesh import make_mesh, sharded_dist_step

    mesh = make_mesh(n_rows=4, n_words=2)
    s64 = 16
    w2 = s64 * 14 * 2
    rng = np.random.default_rng(1)
    a = jax.device_put(
        rng.integers(0, 2**32, (16, w2), dtype=np.uint32),
        NamedSharding(mesh, P("rows", "words")),
    )
    b = jax.device_put(
        rng.integers(0, 2**32, (8, w2), dtype=np.uint32),
        NamedSharding(mesh, P(None, "words")),
    )
    out = np.asarray(sharded_dist_step(a, b, s64=s64, mesh=mesh, k=21.0, ani=False))
    sb = samebits_matrix(
        np.asarray(a).view(np.uint64), np.asarray(b).view(np.uint64)
    ).astype(np.float64)
    maxnbits = float(s64 * 64)
    expected = float((s64 * 64) >> 14)
    j = (np.maximum(sb - expected, 0) * maxnbits / (maxnbits - expected)) / maxnbits
    np.testing.assert_allclose(out, (1.0 - j).astype(np.float32), atol=1e-6)


def test_graft_entry():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 128)
    g.dryrun_multichip(8)


def test_sharded_coreacc_step(eight_devices):
    """Row+word-sharded core/accessory step vs the single-device XLA tile."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    from sketchtpu.dist.coreacc_jax import coreacc_tile
    from sketchtpu.shard.mesh import make_mesh, sharded_coreacc_step

    s64 = 4
    w2 = s64 * 14 * 2
    kmers = (17, 21, 25, 29)
    nk = len(kmers)
    rng = np.random.default_rng(2)
    base = rng.integers(0, 2**32, (1, w2), dtype=np.uint32)
    stack = np.where(
        rng.random((nk, 16, w2)) < 0.8,
        base,
        rng.integers(0, 2**32, (nk, 16, w2), dtype=np.uint32),
    ).astype(np.uint32)
    want = np.asarray(
        coreacc_tile(jnp.asarray(stack), jnp.asarray(stack), s64, kmers, s64 * 64)
    )
    for rows, words in [(8, 1), (4, 2), (2, 4)]:
        mesh = make_mesh(n_rows=rows, n_words=words)
        a = jax.device_put(stack, NamedSharding(mesh, P(None, "rows", "words")))
        b = jax.device_put(stack, NamedSharding(mesh, P(None, None, "words")))
        got = np.asarray(
            sharded_coreacc_step(a, b, s64, mesh, kmers, s64 * 64)
        )
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{rows}x{words}")


def test_sharded_knn_step(eight_devices):
    """Row-sharded kNN selection vs a host argsort oracle."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sketchtpu.shard.mesh import make_mesh, sharded_knn_step

    s64 = 4
    w = s64 * 14
    n, knn = 64, 5
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2**63, (1, w), dtype=np.uint64)
    mat = np.where(
        rng.random((n, w)) < 0.8,
        base,
        rng.integers(0, 2**63, (n, w), dtype=np.uint64),
    ).astype(np.uint64)
    sb_full = samebits_matrix(mat, mat).astype(np.int64)
    np.fill_diagonal(sb_full, -(2**31))  # exclude self

    mesh = make_mesh(n_rows=8, n_words=1)
    m32 = mat.view(np.uint32)
    a = jax.device_put(m32, NamedSharding(mesh, P("rows", None)))
    b = jax.device_put(m32, NamedSharding(mesh, P(None, None)))
    v, i = sharded_knn_step(
        a, b, s64, mesh, knn, n_real=n, exclude_self=True, col_tile=16
    )
    v = np.asarray(v)
    i = np.asarray(i)
    for r in range(n):
        want_v = np.sort(sb_full[r])[::-1][:knn]
        np.testing.assert_array_equal(np.sort(v[r])[::-1], want_v, err_msg=str(r))
        # indices must be actual argmax-class columns (ties allowed)
        assert all(sb_full[r, c] == vv for c, vv in zip(i[r], v[r]))


def test_select_engine_uses_mesh_on_multidevice(eight_devices, monkeypatch):
    """With >1 device and a forced device backend, the samebits engine
    shards rows over the whole mesh and stays exact."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu import runtime

    monkeypatch.setenv("SKETCHTPU_BACKEND", "device")
    ms = _fake_ms(n=19, nk=1, s64=2, kmers=(17,), seed=9)
    engine = runtime.select_engine(ms)
    assert engine is not None
    a = ms.bins_matrix(0)
    got = engine(a, a)
    want = samebits_matrix(a, a)
    assert np.array_equal(got, want)


def test_sharded_coreacc_engine_matches_device_engine(eight_devices, monkeypatch):
    import io
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist.coreacc_jax import DeviceCoreAccEngine
    from sketchtpu.shard.mesh import ShardedCoreAccEngine

    ms = _fake_ms(n=21, nk=3, s64=2, kmers=(15, 19, 23), seed=12)
    names = [f"g{i}" for i in range(21)]
    single = io.StringIO()
    DeviceCoreAccEngine(ms, tile=8).stream_self_dense(single, names)
    sharded = io.StringIO()
    ShardedCoreAccEngine(ms, tile=8).stream_self_dense(sharded, names)
    assert sharded.getvalue() == single.getvalue()


def test_sharded_knn_engine_matches_host(eight_devices):
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms, _assert_rows_equal

    from sketchtpu.dist import api
    from sketchtpu.shard.mesh import ShardedKnnEngine

    ms = _fake_ms(n=52, nk=2, s64=2, kmers=(17, 21), seed=13)
    queries = _fake_ms(n=9, nk=2, s64=2, kmers=(17, 21), seed=14)
    for ani in (False, True):
        dist_type = api.set_k(ms, 17, ani)
        host = api.self_dists_knn(ms, 5, dist_type)
        dev = ShardedKnnEngine(ms, col_tile=16).self_knn(5, dist_type)
        _assert_rows_equal(dev, host)
        host_x = api.cross_dists_knn(ms, queries, 4, dist_type)
        dev_x = ShardedKnnEngine(ms, col_tile=16).cross_knn(
            queries, 4, dist_type
        )
        _assert_rows_equal(dev_x, host_x)


def test_sharded_knn_coreacc_matches_device(eight_devices, monkeypatch):
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms, _assert_rows_equal

    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.shard.mesh import ShardedKnnEngine

    ms = _fake_ms(n=48, nk=3, s64=2, kmers=(15, 19, 23), seed=21)
    queries = _fake_ms(n=10, nk=3, s64=2, kmers=(15, 19, 23), seed=22)
    single = DeviceKnnEngine(ms, row_tile=16, col_tile=16)
    sharded = ShardedKnnEngine(ms, col_tile=16)

    def rows_eq(a, b):
        for ra, rb in zip(a, b):
            assert len(ra) == len(rb)
            for (ia, ca, aa), (ib, cb, ab) in zip(ra, rb):
                assert ia == ib
                assert np.float32(ca) == np.float32(cb)
                assert np.float32(aa) == np.float32(ab)

    rows_eq(sharded.self_knn_coreacc(5), single.self_knn_coreacc(5))
    rows_eq(
        sharded.cross_knn_coreacc(queries, 4),
        single.cross_knn_coreacc(queries, 4),
    )


def test_sharded_coreacc_completeness(eight_devices):
    """Completeness-corrected sharded core/acc step matches the
    single-device corrected tile bit-for-bit (identical f32 math; the
    correction runs after the samebits psum)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    from sketchtpu.dist.coreacc_jax import coreacc_tile
    from sketchtpu.shard.mesh import make_mesh, sharded_coreacc_step

    s64 = 4
    w2 = s64 * 14 * 2
    kmers = (17, 21, 25)
    nk = len(kmers)
    rng = np.random.default_rng(6)
    base = rng.integers(0, 2**32, (1, w2), dtype=np.uint32)
    keep = np.array([0.95, 0.85, 0.7])[:, None, None]
    stack = np.where(
        rng.random((nk, 16, w2)) < keep,
        base,
        rng.integers(0, 2**32, (nk, 16, w2), dtype=np.uint32),
    ).astype(np.uint32)
    comp = rng.uniform(0.7, 1.0, 16).astype(np.float32)
    want = np.asarray(
        coreacc_tile(
            jnp.asarray(stack), jnp.asarray(stack), s64, kmers, s64 * 64,
            c1=jnp.asarray(comp), c2=jnp.asarray(comp), cutoff=0.64,
        )
    )
    for rows, words in [(8, 1), (2, 4)]:
        mesh = make_mesh(n_rows=rows, n_words=words)
        a = jax.device_put(stack, NamedSharding(mesh, P(None, "rows", "words")))
        b = jax.device_put(stack, NamedSharding(mesh, P(None, None, "words")))
        got = np.asarray(
            sharded_coreacc_step(
                a, b, s64, mesh, kmers, s64 * 64,
                c1=jnp.asarray(comp), c2=jnp.asarray(comp), cutoff=0.64,
            )
        )
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{rows}x{words}")


def test_sharded_coreacc_engine_completeness(eight_devices):
    """ShardedCoreAccEngine with a completeness vector matches the host
    f64 pipeline to f32 tolerance (engine-level, odd row count)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.shard.mesh import ShardedCoreAccEngine, make_mesh

    ms = _fake_ms(n=13, nk=3, kmers=(17, 21, 25), seed=21)
    rng = np.random.default_rng(22)
    comp = rng.uniform(0.7, 1.0, 13)
    dist_type = api.set_k(ms, None, False)
    host = api.self_dists_all(ms, dist_type, completeness_vec=comp)
    eng = ShardedCoreAccEngine(
        ms, mesh=make_mesh(n_rows=4, n_words=2), tile=8,
        completeness_vec=comp,
    )
    n = 13
    got = []
    for i in range(n):
        block = eng.tile_dists(slice(i, i + 1), slice(0, n))
        got.append(block[0, i + 1 :])
    got = np.concatenate(got)
    np.testing.assert_allclose(got, host, atol=2e-4)


def test_sharded_knn_coreacc_completeness(eight_devices):
    """Sharded corrected core/acc kNN matches the single-device engine."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.shard.mesh import ShardedKnnEngine, make_mesh

    ms = _fake_ms(n=24, nk=3, kmers=(17, 21, 25), seed=31)
    rng = np.random.default_rng(32)
    comp = rng.uniform(0.7, 1.0, 24)
    sharded = ShardedKnnEngine(ms, mesh=make_mesh(n_rows=8, n_words=1),
                               col_tile=8)
    single = DeviceKnnEngine(ms, row_tile=8, col_tile=8)
    for dr, hr in zip(
        sharded.self_knn_coreacc(4, completeness_vec=comp),
        single.self_knn_coreacc(4, completeness_vec=comp),
    ):
        np.testing.assert_allclose(
            sorted(c for _, c, _ in dr), sorted(c for _, c, _ in hr),
            atol=1e-6,
        )


def test_sharded_cross_dense_coreacc(eight_devices):
    """Sharded dense cross core/acc matches the host pipeline (with and
    without completeness)."""
    import io
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.shard.mesh import ShardedCoreAccEngine, make_mesh

    # refs and queries from one related family (split of a single
    # synthetic MultiSketch) — unrelated pairs sit on the regression
    # knife edge where f32/f64 can flip between (0,0) and (1,1)
    family = _fake_ms(n=17, nk=3, kmers=(17, 21, 25), seed=41)
    import copy

    refs = copy.copy(family)
    queries = copy.copy(family)
    nk, w = 3, family.kmer_stride
    mat = family.sketch_bins.reshape(17, nk * w)
    refs.sketch_metadata = family.sketch_metadata[:11]
    refs.sketch_bins = np.ascontiguousarray(mat[:11]).reshape(-1)
    queries.sketch_metadata = family.sketch_metadata[11:]
    queries.sketch_bins = np.ascontiguousarray(mat[11:]).reshape(-1)
    rng = np.random.default_rng(43)
    rc_v = rng.uniform(0.7, 1.0, 11)
    qc_v = rng.uniform(0.7, 1.0, 6)
    dist_type = api.set_k(refs, None, False)
    rnames = [refs.sketch_name(i) for i in range(11)]
    qnames = [f"q{i}" for i in range(6)]
    eng = ShardedCoreAccEngine(
        refs, mesh=make_mesh(n_rows=4, n_words=2), tile=4
    )
    for rcomp, qcomp in ((None, None), (rc_v, qc_v)):
        host = api.cross_dists_all(
            refs, queries, dist_type, rcomp, qcomp
        ).reshape(11, 6, 2)
        out = io.StringIO()
        eng.stream_cross_dense(
            out, rnames, qnames, queries, rcomp=rcomp, qcomp=qcomp
        )
        lines = out.getvalue().strip().split("\n")
        assert len(lines) == 11 * 6
        got = np.array(
            [[float(x) for x in ln.split("\t")[2:]] for ln in lines]
        ).reshape(11, 6, 2)
        np.testing.assert_allclose(got, host, atol=2e-4)


def test_sharded_knn_singlek_completeness(eight_devices):
    """Sharded single-k kNN with completeness matches the single-device
    engine item-for-item (identical selection key and exact host
    recompute)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.shard.mesh import ShardedKnnEngine, make_mesh

    ms = _fake_ms(n=26, nk=2, kmers=(17, 21), seed=51)
    rng = np.random.default_rng(52)
    comp = rng.uniform(0.7, 1.0, 26)
    dist_type = api.set_k(ms, 17, False)
    sharded = ShardedKnnEngine(ms, mesh=make_mesh(n_rows=8, n_words=1),
                               col_tile=8)
    single = DeviceKnnEngine(ms, row_tile=8, col_tile=8)
    host = api.self_dists_knn(ms, 4, dist_type, completeness_vec=comp)
    for dr, sr, hr in zip(
        single.self_knn(4, dist_type, completeness_vec=comp),
        sharded.self_knn(4, dist_type, completeness_vec=comp),
        host,
    ):
        d_dists = sorted(np.float32(d) for _, d in dr)
        s_dists = sorted(np.float32(d) for _, d in sr)
        h_dists = sorted(np.float32(d) for _, d in hr)
        np.testing.assert_allclose(s_dists, d_dists, atol=1e-7)
        np.testing.assert_allclose(s_dists, h_dists, atol=1e-6)


def test_sharded_knn_grouped_merge(eight_devices):
    """Sharded kNN with shapes that activate the two-stage grouped top-k
    merge inside shard_map (col_tile/8 groups > knn) — the other sharded
    tests use tiny tiles where it falls back to the flat merge."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms, _assert_rows_equal

    from sketchtpu.dist import api
    from sketchtpu.dist.knn_jax import _MERGE_GROUP
    from sketchtpu.shard.mesh import ShardedKnnEngine

    col_tile, knn = 128, 4
    assert col_tile // _MERGE_GROUP > knn
    ms = _fake_ms(n=200, nk=2, s64=2, kmers=(17, 21), seed=61)
    dist_type = api.set_k(ms, 17, False)
    host = api.self_dists_knn(ms, knn, dist_type)
    dev = ShardedKnnEngine(ms, col_tile=col_tile).self_knn(knn, dist_type)
    _assert_rows_equal(dev, host)


@pytest.mark.parametrize("retain", [None, "singleton", "bruteforce"])
def test_sharded_precluster_knn_matches_device(eight_devices, retain):
    """The mesh-sharded masked (prefiltered) scan must match the
    single-device engine item-for-item: exact samebits selection with the
    same (value desc, column asc) tie rule, same f64 value chain, same
    retain-unmatched and padding semantics."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.inverted.index import Inverted
    from sketchtpu.shard.mesh import ShardedKnnEngine, make_mesh
    from sketchtpu.sketchcore.sketch import HashType

    n = 50
    ms = _fake_ms(n=n, seed=4)
    rng = np.random.default_rng(5)
    stride = 37
    signs = rng.integers(0, 25, (n, stride), dtype=np.uint16)
    for iso in (7, 23, 41):  # private alphabets -> zero candidates
        signs[iso] = rng.integers(1000 + iso * 50, 1000 + iso * 50 + 40, stride)
    perm = rng.permutation(n)
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
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain
    )
    sharded_eng = ShardedKnnEngine(
        ms, mesh=make_mesh(n_rows=8, n_words=1), col_tile=16
    )
    sharded = sharded_eng.precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain
    )
    assert len(sharded) == len(dev)
    for r, (sr, dr) in enumerate(zip(sharded, dev)):
        assert [(i, np.float32(d)) for i, d in sr] == [
            (i, np.float32(d)) for i, d in dr
        ], f"row {r}"

    # row_range slicing matches the corresponding full-run rows
    sl = sharded_eng.precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain,
        row_range=slice(10, 30),
    )
    assert len(sl) == 20
    for sr, fr in zip(sl, sharded[10:30]):
        assert [(i, np.float32(d)) for i, d in sr] == [
            (i, np.float32(d)) for i, d in fr
        ]


@pytest.mark.parametrize("retain", [None, "bruteforce"])
def test_sharded_precluster_coreacc_matches_device(eight_devices, retain):
    """Core/accessory precluster (extension; the reference panics here,
    distances/mod.rs:548-550) over the mesh: f32 selection with the same
    kernels as the single-device engine plus the exact-value pass, so
    items must match exactly."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _coreacc_precluster_fixture

    from sketchtpu.dist import api
    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.shard.mesh import ShardedKnnEngine, make_mesh

    ms, inv, skq_flat, stride = _coreacc_precluster_fixture()
    dist_type = api.set_k(ms, None, False)
    knn = 5
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, knn, dist_type, retain_unmatched=retain
    )
    sharded = ShardedKnnEngine(
        ms, mesh=make_mesh(n_rows=8, n_words=1), col_tile=16
    ).precluster_knn(inv, skq_flat, knn, dist_type, retain_unmatched=retain)
    assert len(sharded) == len(dev)
    for r, (sr, dr) in enumerate(zip(sharded, dev)):
        assert [
            (i, np.float32(c), np.float32(a)) for i, c, a in sr
        ] == [(i, np.float32(c), np.float32(a)) for i, c, a in dr], f"row {r}"


def test_sharded_precluster_knn_completeness(eight_devices):
    """Masked scan + MAG completeness correction on the mesh: selection
    keys on the corrected f32 Jaccard, printed values recomputed exactly
    — must match the single-device engine."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.knn_jax import DeviceKnnEngine
    from sketchtpu.inverted.index import Inverted
    from sketchtpu.shard.mesh import ShardedKnnEngine, make_mesh
    from sketchtpu.sketchcore.sketch import HashType

    n = 40
    ms = _fake_ms(n=n, seed=11)
    rng = np.random.default_rng(12)
    stride = 23
    signs = rng.integers(0, 15, (n, stride), dtype=np.uint16)
    inv = Inverted(
        sign_matrix=signs,
        sample_names=[f"g{i}" for i in range(n)],
        kmer_size=17,
        rc=True,
        hash_type=HashType("dna"),
    )
    skq_flat = inv.sign_matrix.reshape(-1)
    dist_type = api.set_k(ms, 17, False)
    comp = rng.uniform(0.75, 1.0, n)
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).precluster_knn(
        inv, skq_flat, 5, dist_type, completeness_vec=comp
    )
    sharded = ShardedKnnEngine(
        ms, mesh=make_mesh(n_rows=8, n_words=1), col_tile=16
    ).precluster_knn(inv, skq_flat, 5, dist_type, completeness_vec=comp)
    for r, (sr, dr) in enumerate(zip(sharded, dev)):
        assert [(i, np.float32(d)) for i, d in sr] == [
            (i, np.float32(d)) for i, d in dr
        ], f"row {r}"


def test_sharded_inverted_engine_matches_device(eight_devices):
    """ShardedInvertedEngine (rows mesh axis) must byte-match the
    single-device engine on count/match/any/all, including a row_range
    partial whose strips straddle device boundaries and an n that is not
    a multiple of tile*rows."""
    from sketchtpu.inverted.device import DeviceInvertedEngine
    from sketchtpu.shard.mesh import ShardedInvertedEngine, make_mesh

    rng = np.random.default_rng(21)
    n, s = 530, 37
    mat = rng.integers(0, 30, (n, s), dtype=np.uint16)
    mat[rng.random((n, s)) < 0.01] = np.uint16(0xFFFF)
    mat[17] = mat[401]  # a guaranteed far pair

    dev = DeviceInvertedEngine(mat, tile=64)
    mesh = make_mesh(n_rows=8, n_words=1)
    sh = ShardedInvertedEngine(mat, mesh=mesh, tile=32)

    assert sh.any_shared_bin_count() == dev.any_shared_bin_count()
    # rank partials sum to the total (multi-process contract)
    parts = [
        sh.any_shared_bin_count(row_range=slice(lo, min(lo + 171, n)))
        for lo in range(0, n, 171)
    ]
    assert sum(parts) == dev.any_shared_bin_count()

    queries = rng.integers(0, 30, (11, s), dtype=np.uint16)
    queries[3] = mat[77]
    np.testing.assert_array_equal(
        sh.match_counts(queries), dev.match_counts(queries)
    )
    np.testing.assert_array_equal(
        sh.any_shared_rows(queries), dev.any_shared_rows(queries)
    )
    np.testing.assert_array_equal(
        sh.all_shared_rows(queries), dev.all_shared_rows(queries)
    )


def test_select_inverted_engine_uses_mesh_on_multidevice(
    eight_devices, monkeypatch
):
    from sketchtpu import runtime
    from sketchtpu.inverted.index import Inverted
    from sketchtpu.shard.mesh import ShardedInvertedEngine
    from sketchtpu.sketchcore.sketch import HashType

    monkeypatch.setenv("SKETCHTPU_BACKEND", "device")
    rng = np.random.default_rng(5)
    inv = Inverted(
        sign_matrix=rng.integers(0, 99, (24, 16), dtype=np.uint16),
        sample_names=[f"s{i}" for i in range(24)],
        kmer_size=17,
        rc=True,
        hash_type=HashType("dna"),
    )
    eng = runtime.select_inverted_engine(inv)
    assert isinstance(eng, ShardedInvertedEngine)
    assert eng.any_shared_bin_count() == inv.any_shared_bin_count()
