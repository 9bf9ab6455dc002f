"""The Triton-route samebits kernel (interpret mode on the CPU; its compiled
form runs in the `gpu` tests and in chip_smoke.py), and the packed kNN scan
that every distance engine's tile feeds."""

import functools

import numpy as np

import jax
import jax.numpy as jnp

import pytest

from sketchtpu.dist.jaccard_np import samebits_matrix
from sketchtpu.dist.samebits_triton import (
    samebits_tile_triton,
    samebits_triton,
    word_major,
)
from sketchtpu.synth import clustered_sketch_planes


def _planes(n, sketch_size, seed):
    """(n, W2) u32 planes of related sketches (samebits spans a range)."""
    rows = np.concatenate(
        list(clustered_sketch_planes(n, [17], sketch_size, seed, batch=64))
    )[:, 0]
    return np.ascontiguousarray(rows).view(np.uint32)


@pytest.mark.parametrize("sketch_size", [256, 1000, 180])  # s64 = 4, 16, 3
@pytest.mark.parametrize("na,nb", [(128, 64), (100, 37)])
def test_samebits_triton_matches_samebits_matrix(sketch_size, na, nb):
    """Row-major wrapper: any na/nb (padded to the blocks), any s64 (odd
    ones too: no lane-padding rule)."""
    a = _planes(na, sketch_size, 1)
    b = np.ascontiguousarray(_planes(nb, sketch_size, 1)[::-1])
    s64 = a.shape[1] // 28
    got = np.asarray(samebits_tile_triton(
        jnp.asarray(a), jnp.asarray(b), s64, interpret=True))
    want = samebits_matrix(a.view(np.uint64), b.view(np.uint64))
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row0", [0, 64, 128, 320])
def test_samebits_triton_tri_int16_strip(row0):
    """tri=True with an int16 strip: every upper-triangle (col > row) entry
    exact, every (BM, BN) block wholly at or below the diagonal zero."""
    s64, bm, bn, na, nb = 4, 32, 32, 64, 384
    mat = _planes(nb, 256, 3)
    m_t = word_major(jnp.asarray(mat))
    r0 = row0
    got = np.asarray(samebits_triton(
        m_t[:, r0 : r0 + na], m_t, s64, row0=r0, tri=True,
        out_dtype=jnp.int16, bm=bm, bn=bn, interpret=True))
    assert got.dtype == np.int16
    want = samebits_matrix(mat[r0 : r0 + na].view(np.uint64),
                           mat.view(np.uint64))
    rows = r0 + np.arange(na)[:, None]
    cols = np.arange(nb)[None, :]
    np.testing.assert_array_equal(got[cols > rows], want[cols > rows])
    bi, bj = np.meshgrid(np.arange(na // bm), np.arange(nb // bn),
                         indexing="ij")
    for i, j in zip(*np.nonzero((bj + 1) * bn - 1 <= r0 + bi * bm)):
        assert not got[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn].any()


def test_samebits_triton_rejects_ragged_blocks():
    a_t = jnp.zeros((4 * 28, 100), jnp.int32)
    with pytest.raises(ValueError, match="na % 128"):
        samebits_triton(a_t, a_t, 4, interpret=True)


def test_samebits_tile_dispatch_per_platform(monkeypatch):
    """_samebits_tile runs the platform's tile: the Triton kernel when the
    runtime says gpu (interpret mode here), XLA on the CPU; both exact."""
    from sketchtpu.dist import jaccard_jax

    a = _planes(40, 1000, 4)
    want = samebits_matrix(a.view(np.uint64), a.view(np.uint64))
    got_xla = np.asarray(jaccard_jax._samebits_tile(
        jnp.asarray(a), jnp.asarray(a), 16))
    monkeypatch.setattr(jaccard_jax, "samebits_kernel", lambda: "triton")
    monkeypatch.setattr(jaccard_jax, "samebits_tile_triton", functools.partial(
        samebits_tile_triton, interpret=True))
    got_tri = np.asarray(jaccard_jax._samebits_tile(
        jnp.asarray(a), jnp.asarray(a), 16))
    np.testing.assert_array_equal(got_xla, want)
    np.testing.assert_array_equal(got_tri, want)


@pytest.mark.parametrize("tri,out_dtype", [(False, jnp.int32),
                                            (True, jnp.int16)])
def test_samebits_triton_module_verifies_for_cuda(monkeypatch, tri,
                                                  out_dtype):
    """Lower the kernel for CUDA here and verify its Triton module, which
    the card's compiler would otherwise be first to reject (s64 = 157)."""
    from jax._src.pallas.triton import pallas_call_registration as reg

    lower = reg.lowering.lower_jaxpr_to_triton_module
    verified = []

    def checked(*args, **kwargs):
        res = lower(*args, **kwargs)
        verified.append(res.module.operation.verify())
        return res

    monkeypatch.setattr(reg.lowering, "lower_jaxpr_to_triton_module", checked)
    a_t = jax.ShapeDtypeStruct((157 * 28, 256), jnp.int32)
    jax.jit(lambda x, y, r: samebits_triton(
        x, y, 157, row0=r, tri=tri, out_dtype=out_dtype)).trace(
        a_t, a_t, jnp.int32(0)).lower(lowering_platforms=("cuda",))
    assert verified == [True]


@pytest.mark.gpu
@pytest.mark.parametrize("sketch_size", [1000, 10000])
def test_samebits_triton_compiled_on_gpu(gpu, sketch_size):
    """The compiled kernel at a real width (s64 = 16 and 157)."""
    a = _planes(1024, sketch_size, 5)
    s64 = a.shape[1] // 28
    got = np.asarray(samebits_tile_triton(jnp.asarray(a), jnp.asarray(a), s64))
    rows = np.arange(0, 1024, 37)
    want = samebits_matrix(a[rows].view(np.uint64), a.view(np.uint64))
    np.testing.assert_array_equal(got[rows], want)


def test_knn_scan_block_packed_matches_reference_scan():
    """The packed-key fast scan (branch-gated masks, single-top_k merge)
    must select identically — values, indices, tie order — to the original
    scan."""
    from sketchtpu.dist.knn_jax import (
        _knn_scan_block,
        _knn_scan_block_packed,
    )

    s64 = 4
    w2 = s64 * 14 * 2
    rng = np.random.default_rng(4)
    nb = 512
    tr = 256
    knn = 5
    a_np = rng.integers(0, 2**32, (tr, w2), dtype=np.uint32)
    b_np = rng.integers(0, 2**32, (nb, w2), dtype=np.uint32)
    b_np[:tr] = a_np  # diagonal overlap: exercises the self-exclusion branch
    # duplicate columns: exercises tie-breaking (must prefer lowest column)
    b_np[300] = b_np[10]
    b_np[301] = b_np[10]
    sig = np.zeros((tr, 1), np.int32)
    bsig = np.zeros((nb, 1), np.int32)
    for nb_real in (nb, nb - 3):  # with and without padded tail columns
        want_v, want_i = _knn_scan_block(
            jnp.asarray(a_np), jnp.asarray(b_np), np.int32(0),
            np.int32(nb_real), sig, bsig,
            s64=s64, knn=knn, tc=256, exclude_self=True, masked=False,
        )
        got_v, got_i = _knn_scan_block_packed(
            jnp.asarray(a_np), jnp.asarray(b_np), np.int32(0),
            np.int32(nb_real),
            s64=s64, knn=knn, tc=256, exclude_self=True,
        )
        assert np.array_equal(np.asarray(got_v), np.asarray(want_v))
        assert np.array_equal(np.asarray(got_i), np.asarray(want_i))


def test_knn_scan_block_packed_masked_matches_reference_scan():
    """Packed scan in masked (precluster sign-equality prefilter) mode."""
    from sketchtpu.dist.knn_jax import (
        _knn_scan_block,
        _knn_scan_block_packed,
    )

    s64 = 4
    w2 = s64 * 14 * 2
    rng = np.random.default_rng(5)
    nb = 512
    tr = 256
    knn = 5
    S = 16
    a_np = rng.integers(0, 2**32, (tr, w2), dtype=np.uint32)
    b_np = rng.integers(0, 2**32, (nb, w2), dtype=np.uint32)
    b_np[:tr] = a_np
    b_sig = rng.integers(0, 8, (nb, S)).astype(np.int32)  # dense collisions
    a_sig = b_sig[:tr]
    want_v, want_i = _knn_scan_block(
        jnp.asarray(a_np), jnp.asarray(b_np), np.int32(0), np.int32(nb - 3),
        a_sig, b_sig,
        s64=s64, knn=knn, tc=256, exclude_self=True, masked=True,
    )
    got_v, got_i = _knn_scan_block_packed(
        jnp.asarray(a_np), jnp.asarray(b_np), np.int32(0), np.int32(nb - 3),
        s64=s64, knn=knn, tc=256, exclude_self=True,
        a_sig=a_sig, b_sig=b_sig, masked=True,
    )
    assert np.array_equal(np.asarray(got_v), np.asarray(want_v))
    assert np.array_equal(np.asarray(got_i), np.asarray(want_i))

