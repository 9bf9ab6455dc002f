"""On-device f32 core/accessory tiles vs the exact f64 host pipeline."""

import numpy as np

import jax.numpy as jnp

from sketchtpu.dist.coreacc_jax import coreacc_tile
from sketchtpu.dist.jaccard_np import (
    core_acc_from_jaccards,
    jaccard_from_samebits,
    samebits_matrix,
)


def test_coreacc_tile_matches_host():
    rng = np.random.default_rng(0)
    s64 = 16
    w = s64 * 14
    kmers = (17, 21, 25, 29)
    na, nb = 24, 16
    sketch_size = 1024

    # correlated sketches so some pairs have meaningful multi-k signal
    base = rng.integers(0, 2**63, (1, len(kmers), w), dtype=np.uint64)
    a = np.where(
        rng.random((na, len(kmers), w)) < 0.7,
        base,
        rng.integers(0, 2**63, (na, len(kmers), w), dtype=np.uint64),
    )
    b = np.where(
        rng.random((nb, len(kmers), w)) < 0.7,
        base,
        rng.integers(0, 2**63, (nb, len(kmers), w), dtype=np.uint64),
    )
    # include an identical pair (y == 0 for all k: degenerate regression)
    b[0] = a[0]

    # host pipeline
    jaccs = np.empty((na * nb, len(kmers)))
    for ki in range(len(kmers)):
        sb = samebits_matrix(
            np.ascontiguousarray(a[:, ki]), np.ascontiguousarray(b[:, ki])
        ).reshape(-1)
        jaccs[:, ki] = jaccard_from_samebits(sb, s64)
    core_h, acc_h = core_acc_from_jaccards(jaccs, list(kmers), sketch_size)

    # device pipeline
    a_stack = jnp.asarray(
        np.ascontiguousarray(a.transpose(1, 0, 2)).view(np.uint32)
    )
    b_stack = jnp.asarray(
        np.ascontiguousarray(b.transpose(1, 0, 2)).view(np.uint32)
    )
    out = np.asarray(coreacc_tile(a_stack, b_stack, s64, kmers, sketch_size))
    core_d = out[:, :, 0].reshape(-1)
    acc_d = out[:, :, 1].reshape(-1)

    np.testing.assert_allclose(core_d, core_h, atol=2e-4)
    np.testing.assert_allclose(acc_d, acc_h, atol=2e-4)


def test_coreacc_tile_completeness_matches_host():
    """Completeness-corrected core/accessory on device: the per-k Jaccard
    correction (jaccard.rs:36-57) is applied before the regression, same
    as the host f64 pipeline."""
    rng = np.random.default_rng(3)
    s64 = 4
    w = s64 * 14
    kmers = (17, 21, 25)
    na, nb = 12, 10
    sketch_size = 256
    cutoff = 0.64

    # J decreasing in k (like real genomes) — a flat/symmetric J-vs-k
    # profile is a knife edge where the regression slope sign is pure
    # rounding noise in f64 and f32 alike (see test_knn_device._fake_ms)
    base = rng.integers(0, 2**63, (1, len(kmers), w), dtype=np.uint64)
    keep = np.array([0.95, 0.85, 0.7])[None, :, None]
    a = np.where(
        rng.random((na, len(kmers), w)) < keep,
        base,
        rng.integers(0, 2**63, (na, len(kmers), w), dtype=np.uint64),
    )
    b = np.where(
        rng.random((nb, len(kmers), w)) < keep,
        base,
        rng.integers(0, 2**63, (nb, len(kmers), w), dtype=np.uint64),
    )
    # mix of completeness values straddling the cutoff product
    c1 = rng.uniform(0.6, 1.0, na)
    c2 = rng.uniform(0.6, 1.0, nb)

    jaccs = np.empty((na * nb, len(kmers)))
    c1_pairs = np.repeat(c1, nb)
    c2_pairs = np.tile(c2, na)
    for ki in range(len(kmers)):
        sb = samebits_matrix(
            np.ascontiguousarray(a[:, ki]), np.ascontiguousarray(b[:, ki])
        ).reshape(-1)
        jaccs[:, ki] = jaccard_from_samebits(
            sb, s64, c1_pairs, c2_pairs, cutoff
        )
    core_h, acc_h = core_acc_from_jaccards(jaccs, list(kmers), sketch_size)

    a_stack = jnp.asarray(
        np.ascontiguousarray(a.transpose(1, 0, 2)).view(np.uint32)
    )
    b_stack = jnp.asarray(
        np.ascontiguousarray(b.transpose(1, 0, 2)).view(np.uint32)
    )
    out = np.asarray(
        coreacc_tile(
            a_stack, b_stack, s64, kmers, sketch_size,
            c1=jnp.asarray(c1, jnp.float32),
            c2=jnp.asarray(c2, jnp.float32),
            cutoff=cutoff,
        )
    )
    np.testing.assert_allclose(out[:, :, 0].reshape(-1), core_h, atol=2e-4)
    np.testing.assert_allclose(out[:, :, 1].reshape(-1), acc_h, atol=2e-4)


def test_dense_engine_completeness_matches_host():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api
    from sketchtpu.dist.coreacc_jax import DeviceCoreAccEngine

    ms = _fake_ms(n=20, nk=4, kmers=(17, 21, 25, 29), seed=8)
    rng = np.random.default_rng(9)
    comp = rng.uniform(0.7, 1.0, 20)
    dist_type = api.set_k(ms, None, False)
    host = api.self_dists_all(ms, dist_type, completeness_vec=comp)
    eng = DeviceCoreAccEngine(ms, tile=8, completeness_vec=comp)
    import io

    out = io.StringIO()
    names = [ms.sketch_name(i) for i in range(20)]
    eng.stream_self_dense(out, names)
    lines = out.getvalue().strip().split("\n")
    assert len(lines) == host.shape[0]
    got = np.array(
        [[float(x) for x in ln.split("\t")[2:]] for ln in lines]
    )
    np.testing.assert_allclose(got, host, atol=2e-4)


def test_coreacc_exact_stream_byte_identical_to_host():
    """DeviceCoreAccExactStreamEngine (`dist --exact`) must emit BYTE-
    identical output to the host f64 pipeline — plain and completeness-
    corrected, row_range'd and full."""
    import io
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api, output as dist_output
    from sketchtpu.dist.coreacc_jax import DeviceCoreAccExactStreamEngine

    ms = _fake_ms(n=30, nk=4, kmers=(17, 21, 25, 29), seed=12)
    names = [ms.sketch_name(i) for i in range(30)]
    rng = np.random.default_rng(13)
    comp = rng.uniform(0.5, 1.0, 30)
    dist_type = api.set_k(ms, None, False)
    for cv in (None, comp):
        for rr in (None, slice(7, 19)):
            host_out = io.StringIO()
            d = api.self_dists_all(
                ms, dist_type, completeness_vec=cv, row_range=rr
            )
            dist_output.write_dense_self(
                host_out, names, d, True, row_range=rr
            )
            eng = DeviceCoreAccExactStreamEngine(
                ms, completeness_vec=cv, tile=8
            )
            dev_out = io.StringIO()
            eng.stream_self_dense(dev_out, names, row_range=rr)
            assert dev_out.getvalue() == host_out.getvalue(), (
                f"comp={cv is not None} rr={rr}"
            )


def test_coreacc_exact_stream_cross_byte_identical_to_host():
    """The cross (ref-vs-query) twin of `dist --exact`
    (DeviceCoreAccExactStreamEngine.stream_cross_dense) must emit BYTE-
    identical output to the host f64 cross pipeline — plain and
    completeness-corrected, row_range'd and full
    (/root/reference/src/distances/mod.rs:227-297 semantics)."""
    import copy
    import io
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_knn_device import _fake_ms

    from sketchtpu.dist import api, output as dist_output
    from sketchtpu.dist.coreacc_jax import DeviceCoreAccExactStreamEngine

    family = _fake_ms(n=31, nk=4, kmers=(17, 21, 25, 29), seed=17)
    nk, w = 4, family.kmer_stride
    mat = family.sketch_bins.reshape(31, nk * w)
    ms = copy.copy(family)
    ms.sketch_metadata = family.sketch_metadata[:22]
    ms.sketch_bins = np.ascontiguousarray(mat[:22]).reshape(-1)
    qms = copy.copy(family)
    qms.sketch_metadata = family.sketch_metadata[22:]
    qms.sketch_bins = np.ascontiguousarray(mat[22:]).reshape(-1)
    names = [ms.sketch_name(i) for i in range(22)]
    qnames = [qms.sketch_name(i) for i in range(9)]
    rng = np.random.default_rng(19)
    rcomp = rng.uniform(0.5, 1.0, 22)
    qcomp = rng.uniform(0.5, 1.0, 9)
    dist_type = api.set_k(ms, None, False)
    for rc, qc in ((None, None), (rcomp, qcomp)):
        for rr in (None, slice(5, 17)):
            host_out = io.StringIO()
            d = api.cross_dists_all(
                ms, qms, dist_type,
                ref_completeness_vec=rc, query_completeness_vec=qc,
            )
            if rr is None:
                dist_output.write_dense_cross(
                    host_out, names, qnames, d, True
                )
            else:
                # host rectangle sliced to just the ref row block
                d = np.asarray(d).reshape(22, 9, 2)[rr].reshape(-1, 2)
                dist_output.write_dense_cross(
                    host_out, names[rr], qnames, d, True
                )
            eng = DeviceCoreAccExactStreamEngine(ms, tile=8)
            dev_out = io.StringIO()
            eng.stream_cross_dense(
                dev_out, names, qnames, qms,
                rcomp=rc, qcomp=qc, row_range=rr,
            )
            assert dev_out.getvalue() == host_out.getvalue(), (
                f"comp={rc is not None} rr={rr}"
            )
