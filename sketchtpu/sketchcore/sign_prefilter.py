"""Device-side prefilter for the FASTQ count-filter path.

The reads path ships the full in-order sign stream (8 B/base/k) to the
host, where the reference's order-dependent count filter runs serially
(reference src/sketch/mod.rs:198-208 + hashing/bloom_filter.rs —
`sign < bins[bin] && filter(sign) == 0`). Over a slow host link the
transfer dominates. This kernel computes, ON DEVICE, a
provable superset of the sign occurrences the filter could ever CONSULT,
so only that subsequence crosses the link and the host replays the exact
bloom/count logic on it — bit-identical by construction:

An occurrence (position i, sign s, bin b) is consulted iff s < bins[b] at
time i. bins[b] is non-increasing, and bins[b]@i <= M_b(i) where M_b(i) is
the smallest sign in bin b with >= min_count occurrences before i: such a
sign t either was skipped at one of its occurrences (so bins[b] <= t
already) or had all of them consulted, in which case the filter's count
walk (bloom add -> exact counts 2,3,..., pass at count == min_count; false
positives only accelerate it — counts increment by one per consult, so
min_count is always hit) passes by its min_count-th occurrence and sets
bins[b] <= t. Hence any occurrence with s > M_b(i) — i.e. some t < s in
bin b has its min_count-th occurrence before i — is provably never
consulted; dropping it cannot change the replay (unconsulted occurrences
never mutate the bloom, the exact counts, or the bins). The kept
subsequence replayed through the unchanged native filter therefore
reproduces the full-stream result exactly, INCLUDING bloom false-positive
artifacts (a naive "drop signs with total count < min_count" does not:
a colliding low-count sign can pass the bloom and set a bin).

Signs out of bin range (bin >= num_bins) are never consulted either
(`if bin >= nbins continue` precedes the filter) and are dropped.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..hash.nthash_jax import _mul_shift, _unpack_bits

_U32 = jnp.uint32
_I32 = jnp.int32
_BIG = jnp.int32(0x7FFFFFFF)
_INVALID = jnp.uint32(0xFFFFFFFF)  # real sign hi < 2^29


_SCAN_BLOCK = 65536


def _blocked_scan(op, elems, reverse=False):
    """jax.lax.associative_scan with a compile-bounded lowering for long
    1-D inputs.

    The flat odd/even scan graph over a multi-million-element vector
    compiles slowly and grows with the stream (a two-level reshape only
    halves the stage count and still grows). The fix is structural: an outer jax.lax.scan
    over L-element rows whose body — one (L,) associative_scan plus a
    carry combine — is compiled ONCE, so compile cost is O(log L)
    regardless of n, and device cost adds only the sequential row loop
    (n/L steps). Identical results for any associative op:
    out[r] = op(agg_{r-1}, scan(row_r)), by associativity. Reverse
    scans flip, scan forward, flip back — the exact definition of
    associative_scan(reverse=True). Inputs pad to a row multiple; the
    padded tail never feeds a real output in a forward inclusive
    scan."""
    if reverse:
        flipped = jax.tree.map(lambda e: e[::-1], elems)
        out = _blocked_scan(op, flipped)
        return jax.tree.map(lambda e: e[::-1], out)
    leaves = jax.tree_util.tree_leaves(elems)
    n = leaves[0].shape[0]
    L = _SCAN_BLOCK
    if n <= L:
        return jax.lax.associative_scan(op, elems)
    pad = (-n) % L
    if pad:
        elems = jax.tree.map(lambda e: jnp.pad(e, (0, pad)), elems)
    rows = (n + pad) // L
    x2 = jax.tree.map(lambda e: e.reshape(rows, L), elems)

    def body(carry, row):
        first, agg = carry
        local = jax.lax.associative_scan(op, row)
        combined = op(jax.tree.map(lambda a: a[None], agg), local)
        out = jax.tree.map(
            lambda l, c: jnp.where(first, l, c), local, combined
        )
        agg2 = jax.tree.map(lambda e: e[L - 1], out)
        return (jnp.bool_(False), agg2), out

    init_agg = jax.tree.map(lambda e: e[0, 0], x2)
    (_, _), out = jax.lax.scan(body, (jnp.bool_(True), init_agg), x2)
    return jax.tree.map(lambda e: e.reshape(rows * L)[:n], out)


def _seg_min_scan(flags, vals, reverse=False):
    """Inclusive segmented min-scan: running min of vals with reset where
    flags is True (segment starts; for reverse=True flags mark segment
    ENDS read right-to-left, i.e. pass the start flags shifted)."""

    def op(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, jnp.minimum(va, vb))

    _, out = _blocked_scan(op, (flags, vals), reverse=reverse)
    return out


@functools.partial(
    jax.jit, static_argnames=("min_count", "num_bins", "magic", "cap")
)
def prefilter_signs_device(
    lo: jnp.ndarray,  # (m,) u32 sign low words (hash mod 2^61-1)
    hi: jnp.ndarray,  # (m,) u32 sign high words
    validbits: jnp.ndarray,  # (ceil(m/8),) u8 packed window validity
    min_count: int,
    num_bins: int,
    magic: tuple[int, int],
    cap: int,
):
    """Returns (surv_lo, surv_hi, count): the consult-superset subsequence
    in stream order, padded to `cap` (count may exceed cap — caller falls
    back to the full stream)."""
    m = lo.shape[0]
    ok = _unpack_bits(validbits)[:m] == 1
    mm, ss = magic
    bin_idx = _mul_shift(lo, hi, mm, ss)
    ok = ok & (bin_idx < num_bins)
    key_hi = jnp.where(ok, hi, _INVALID)
    key_lo = jnp.where(ok, lo, _INVALID)
    pos = jnp.arange(m, dtype=_I32)
    s_hi, s_lo, s_pos = jax.lax.sort(
        (key_hi, key_lo, pos), num_keys=2, is_stable=True
    )

    # runs of equal signs (stable sort keeps occurrences in stream order)
    new_run = jnp.concatenate(
        [
            jnp.ones(1, jnp.bool_),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    iota = pos
    start_idx = _blocked_scan(
        jnp.maximum, jnp.where(new_run, iota, -1)
    )
    rank = iota - start_idx

    # stream position of each sign's min_count-th occurrence, broadcast to
    # every element of its run (<= 1 marker per run: forward + backward
    # segmented min fills cover elements after and before it)
    alive = s_hi != _INVALID
    cand = jnp.where(alive & (rank == min_count - 1), s_pos, _BIG)
    fwd = _seg_min_scan(new_run, cand)
    end_flags = jnp.concatenate([new_run[1:], jnp.ones(1, jnp.bool_)])
    bwd = _seg_min_scan(end_flags, cand, reverse=True)
    pmc = jnp.minimum(fwd, bwd)

    # f = min pmc over strictly smaller signs in the same bin. Bins are
    # contiguous sign ranges, so the sign sort is already bin-grouped.
    s_bin = _mul_shift(s_lo, s_hi, mm, ss)
    new_bin = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), s_bin[1:] != s_bin[:-1]]
    )
    # contribute each run's pmc only at its LAST element, scan within the
    # bin, then read the value just before the current run's start
    last_of_run = end_flags
    contrib = jnp.where(last_of_run, pmc, _BIG)
    z = _seg_min_scan(new_bin, contrib)
    z_prev = jnp.concatenate([jnp.full(1, _BIG), z[:-1]])
    at_start = jnp.where(
        new_run, jnp.where(new_bin, _BIG, z_prev), _BIG
    )
    f = _seg_min_scan(new_run, at_start)

    keep = alive & (f >= s_pos)

    # compact survivors back to stream order
    inv_keep = jnp.where(keep, 0, 1).astype(_I32)
    _, _, c_lo, c_hi = jax.lax.sort(
        (inv_keep, s_pos, s_lo, s_hi), num_keys=2, is_stable=True
    )
    count = jnp.sum(keep.astype(_I32))
    return c_lo[:cap], c_hi[:cap], count
