"""The distance engines on the GPU's tile: runtime.samebits_kernel is made
to answer "triton" and the Triton kernel runs in interpret mode, so the
word-major layouts, padding, the int16 strip with its triangle skip, and
the core/accessory chain fed by the kernel are checked here against the
host oracle."""

import functools
import io
import sys
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_knn_device import _assert_rows_equal, _fake_ms  # noqa: E402

from sketchtpu.dist import api, jaccard_jax  # noqa: E402
from sketchtpu.dist import samebits_triton as st_mod  # noqa: E402


@pytest.fixture
def triton_tile(monkeypatch):
    monkeypatch.setattr(jaccard_jax, "samebits_kernel", lambda: "triton")
    monkeypatch.setattr(jaccard_jax, "samebits_triton", functools.partial(
        st_mod.samebits_triton, interpret=True))
    monkeypatch.setattr(jaccard_jax, "samebits_tile_triton",
                        functools.partial(st_mod.samebits_tile_triton,
                                          interpret=True))
    jax.clear_caches()  # no trace of the XLA tile may be reused
    yield
    jax.clear_caches()


@pytest.mark.parametrize("ani", [False, True])
def test_dense_stream_self_on_triton_tile(triton_tile, ani):
    from sketchtpu.dist.jaccard_jax import DeviceDenseStreamEngine
    from sketchtpu.dist.output import write_dense_self

    n = 150  # two 128-row strips, the second ragged
    ms = _fake_ms(n=n, nk=2, s64=3, kmers=(17, 21), seed=5)
    names = [f"g{i}" for i in range(n)]
    dist_type = api.set_k(ms, 17, ani)
    want = io.StringIO()
    write_dense_self(want, names, api.self_dists_all(ms, dist_type), False)
    eng = DeviceDenseStreamEngine(ms, dist_type.k_idx, tile=128)
    assert eng._triton and eng._mat.shape == (3 * 28, 256)
    got = io.StringIO()
    eng.stream_self_dense(got, names, dist_type)
    assert got.getvalue() == want.getvalue()


def test_dense_stream_cross_on_triton_tile(triton_tile):
    from sketchtpu.dist.jaccard_jax import DeviceDenseStreamEngine
    from sketchtpu.dist.output import write_dense_cross

    refs = _fake_ms(n=130, nk=2, s64=2, kmers=(17, 21), seed=6)
    queries = _fake_ms(n=11, nk=2, s64=2, kmers=(17, 21), seed=7)
    rnames = [f"r{i}" for i in range(130)]
    qnames = [f"q{i}" for i in range(11)]
    dist_type = api.set_k(refs, 17, False)
    want = io.StringIO()
    write_dense_cross(want, rnames, qnames,
                      api.cross_dists_all(refs, queries, dist_type), False)
    got = io.StringIO()
    DeviceDenseStreamEngine(refs, dist_type.k_idx, tile=128).stream_cross_dense(
        got, rnames, qnames, queries, dist_type)
    assert got.getvalue() == want.getvalue()


def test_self_knn_on_triton_tile(triton_tile):
    from sketchtpu.dist.knn_jax import DeviceKnnEngine

    ms = _fake_ms(n=60, s64=2)
    dist_type = api.set_k(ms, 17, False)
    host = api.self_dists_knn(ms, 7, dist_type)
    dev = DeviceKnnEngine(ms, row_tile=16, col_tile=32).self_knn(7, dist_type)
    _assert_rows_equal(dev, host)


def test_coreacc_tile_on_triton_tile_matches_xla(monkeypatch):
    """Core/accessory as the per-k Triton tile plus coreacc_tile's f32 chain
    equals coreacc_tile on XLA's samebits fusion, bit for bit (the chain
    sees identical int32 counts)."""
    from sketchtpu.dist.coreacc_jax import coreacc_tile

    ms = _fake_ms(n=40, nk=4, s64=2, kmers=(17, 21, 25, 29), seed=8)
    stack = jnp.asarray(np.ascontiguousarray(
        ms.sketch_bins.reshape(40, 4, -1).transpose(1, 0, 2)).view(np.uint32))
    kmers = (17, 21, 25, 29)
    c = jnp.asarray(np.random.default_rng(9).uniform(0.7, 1.0, 40),
                    jnp.float32)

    def run():
        jax.clear_caches()
        return np.asarray(coreacc_tile(stack, stack, 2, kmers, 128,
                                       c1=c, c2=c))

    want = run()
    monkeypatch.setattr(jaccard_jax, "samebits_kernel", lambda: "triton")
    monkeypatch.setattr(jaccard_jax, "samebits_tile_triton",
                        functools.partial(st_mod.samebits_tile_triton,
                                          interpret=True))
    got = run()
    jax.clear_caches()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", ["samebits", "coreacc", "knn_masked"])
def test_sharded_steps_lower_triton_tile_for_cuda(monkeypatch, step):
    """The mesh engines trace the Triton tile inside shard_map (its output
    varies over the operands' mesh axes) and lower it for CUDA; the
    lowering needs no card."""
    from sketchtpu.shard import mesh as mesh_mod

    monkeypatch.setattr(jaccard_jax, "samebits_kernel", lambda: "triton")
    mesh = mesh_mod.make_mesh(n_rows=4)
    s64 = 3
    a = jax.ShapeDtypeStruct((64, s64 * 28), jnp.uint32)
    stack = jax.ShapeDtypeStruct((2, 64, s64 * 28), jnp.uint32)
    sig = jax.ShapeDtypeStruct((64, 10), jnp.int32)
    if step == "samebits":
        fn, args = (lambda x, y: mesh_mod._sharded_samebits(x, y, s64, mesh),
                    (a, a))
    elif step == "coreacc":
        fn, args = (lambda x, y: mesh_mod.sharded_coreacc_step(
            x, y, s64, mesh, (17, 21), s64 * 64), (stack, stack))
    else:
        fn, args = (lambda x, y, u, v: mesh_mod.sharded_knn_step(
            x, y, s64, mesh, 5, 64, True, col_tile=32, a_sig=u, b_sig=v),
            (a, a, sig, sig))
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "samebits_triton" in text
