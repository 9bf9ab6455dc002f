"""Samebits tile for NVIDIA GPUs, written in Pallas through the Triton route.

samebits(i, j) counts the sketch bins whose BBITS low sign bits agree: per
64-bin chunk, an XNOR + AND chain over the 14 bit-plane words, then a
popcount (jaccard_np.samebits_matrix is the exact reference). It is
integer logic with no matrix product in it, so it runs on the CUDA cores.

One program computes one (bm, bn) output tile. Both operands arrive
word-major, (W2, n) int32 with W2 = s64 * BBITS * 2, so the load of one
plane word for the tile's rows (or columns) is one contiguous vector. A
loop over the s64 chunks runs inside the program and keeps the int32
counts in registers; each (row, column) pair is an outer-product broadcast
of those vectors. u32 words are bitcast to int32 first, because Triton's
popcount takes only int32/int64 (bit order does not matter to a popcount).

tri=True skips every tile that holds no pair with column > row (the
self-dense consumers read only the upper triangle): such a tile branches
past the chunk loop and stores zeros. row0, the global index of the first
row, is an ordinary (1,) int32 operand.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..constants import BBITS

# block sizes and launch shape, chosen by bench/kernel_ab.py --sweep on an
# H100 (PERF.md): best at s64 = 157 and within 12% of the best at s64 = 16
BM = 128
BN = 64
NUM_WARPS = 4
NUM_STAGES = 3


def _samebits_kernel(row0_ref, a_ref, b_ref, o_ref, *, s64: int, bm: int,
                     bn: int, tri: bool):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = pl.ds(i * bm, bm)
    cols = pl.ds(j * bn, bn)

    def chunk(c, counts):
        base = c * (BBITS * 2)
        for half in range(2):
            acc = jnp.full((bm, bn), -1, jnp.int32)
            for p in range(BBITS):
                w = base + p * 2 + half
                av = a_ref[w, rows]
                bv = b_ref[w, cols]
                acc = acc & ~(av[:, None] ^ bv[None, :])
            counts = counts + lax.population_count(acc)
        return counts

    zeros = jnp.zeros((bm, bn), jnp.int32)

    def all_chunks():
        return lax.fori_loop(0, s64, chunk, zeros)

    if tri:
        skip = (j + 1) * bn - 1 <= row0_ref[0] + i * bm
        counts = lax.cond(skip, lambda: zeros, all_chunks)
    else:
        counts = all_chunks()
    o_ref[...] = counts.astype(o_ref.dtype)


@functools.partial(
    jax.jit,
    static_argnames=(
        "s64", "tri", "out_dtype", "bm", "bn", "num_warps", "num_stages",
        "interpret",
    ),
)
def samebits_triton(
    a_t: jnp.ndarray,  # (W2, na) int32 word-major rows, na % bm == 0
    b_t: jnp.ndarray,  # (W2, nb) int32 word-major columns, nb % bn == 0
    s64: int,
    row0: jnp.ndarray | int = 0,
    tri: bool = False,
    out_dtype=jnp.int32,
    bm: int = BM,
    bn: int = BN,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
) -> jnp.ndarray:
    """(na, nb) samebits of word-major operands. out_dtype=int16 writes the
    dense strip directly (samebits <= s64 * 64 <= 32767 for the strip
    engines, which check it)."""
    w2, na = a_t.shape
    nb = b_t.shape[1]
    if w2 != s64 * BBITS * 2 or b_t.shape[0] != w2:
        raise ValueError(f"operands must hold {s64 * BBITS * 2} words")
    if na % bm or nb % bn:
        raise ValueError(
            f"samebits_triton needs na % {bm} == 0 and nb % {bn} == 0, "
            f"got na={na}, nb={nb}"
        )
    row0 = jnp.asarray(row0, jnp.int32).reshape(1)
    # under shard_map the tile varies over the mesh axes its operands vary over
    vma = jax.typeof(a_t).vma | jax.typeof(b_t).vma
    return pl.pallas_call(
        functools.partial(_samebits_kernel, s64=s64, bm=bm, bn=bn, tri=tri),
        grid=(na // bm, nb // bn),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((na, nb), out_dtype, vma=vma),
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="samebits_triton",
    )(row0, a_t, b_t)


def word_major(x: jnp.ndarray, mult: int = 1) -> jnp.ndarray:
    """(n, W2) u32 rows -> (W2, n') int32, zero-padded to n' % mult == 0."""
    pad = (-x.shape[0]) % mult
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return lax.bitcast_convert_type(x, jnp.int32).T


@functools.partial(jax.jit, static_argnames=("s64", "interpret"))
def samebits_tile_triton(a: jnp.ndarray, b: jnp.ndarray, s64: int,
                         interpret: bool = False) -> jnp.ndarray:
    """Row-major (na, W2) x (nb, W2) u32 -> (na, nb) int32 samebits: the
    same contract as jaccard_jax._samebits_xla, any na and nb."""
    na, nb = a.shape[0], b.shape[0]
    out = samebits_triton(
        word_major(a, BM), word_major(b, BN), s64, interpret=interpret
    )
    return out[:na, :nb]
