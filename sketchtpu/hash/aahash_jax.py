"""Device (JAX/XLA) aaHash + sign extraction.

Same windowed-XOR reformulation as the device ntHash kernel
(nthash_jax.py), specialised to the forward-only amino-acid hash
(/root/reference/src/hashing/aahash_iterator.rs:138-210):

  fh(p) = XOR_{j<k} srol^{k-1-j}( SEED_level[ seq[p+j] ] )

The 20-letter alphabet (case-folded; the reference's seed tables are
case-insensitive) is compacted to 5-bit codes so each tap lookup is a
5-deep binary select tree over u32 lane pairs — the same trick as the
DNA kernel's 2-bit select tree, scaled to 32 entries. Window emission
masks (including the reference's final-window quirk) are computed on the
host with the exact oracle (aahash_np.aa_window_valid) and shipped as one
bit per window; binning reuses the sort-based per-(sample, bin) minimum
from the DNA kernel (nthash_jax.bin_min_sorted).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import aa_tap_table
from .nthash_jax import (
    MAX_K,
    _mod_mersenne61,
    _unpack_bits,
    bin_min_sorted,
)

_U32 = jnp.uint32
_I32 = jnp.int32

AA_LETTERS = b"ACDEFGHIKLMNPQRSTVWY"

# 256-entry byte -> compact code (0..19); invalid bytes (incl. SEQSEP)
# -> 20, so device code makes validity decisions directly from the code
# stream (valid <=> code < 20; tap-table rows 20..31 are zero, and every
# window containing an invalid residue is masked out of emission)
AA_COMPACT = np.full(256, 20, dtype=np.uint8)
for _i, _c in enumerate(AA_LETTERS):
    AA_COMPACT[_c] = _i
    AA_COMPACT[_c + 32] = _i  # lowercase


def aa_tap_tables_u32(k: int, level: int) -> np.ndarray:
    """Per-tap compact seed tables as (MAX_K, 32, 2) u32 [lo, hi]; rows past
    k are zero so the table can be a traced input to the k-generic kernel."""
    tab = aa_tap_table(k, level)  # (k, 256) u64
    out = np.zeros((MAX_K, 32, 2), dtype=np.uint32)
    cols = np.frombuffer(AA_LETTERS, dtype=np.uint8)
    vals = tab[:, cols]  # (k, 20) u64
    out[:k, :20, 0] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:k, :20, 1] = (vals >> np.uint64(32)).astype(np.uint32)
    return out


def _tap_select32_dyn(codes: jnp.ndarray, row: jnp.ndarray) -> tuple:
    """5-deep binary select of a traced (32, 2) u32 table row by 5-bit
    codes -> (lo, hi) u32 arrays."""
    bits = [((codes >> b) & 1).astype(jnp.bool_) for b in range(5)]

    def sel(vals):  # vals: (32,) u32
        level = [jnp.where(bits[0], vals[i + 1], vals[i]) for i in range(0, 32, 2)]
        for b in range(1, 5):
            level = [
                jnp.where(bits[b], level[i + 1], level[i])
                for i in range(0, len(level), 2)
            ]
        return level[0]

    return sel(row[:, 0]), sel(row[:, 1])


def _sll33(vl, vh, s):
    """(v << s) mod 2^33 on a 33-bit value held as (u32 low, 1-bit high);
    s is a per-lane u32 in [0, 33)."""
    lo = jnp.where(s < 32, vl << jnp.minimum(s, 31), 0)
    # bit 32 of the result: bit (32 - s) of vl for s >= 1, else vh
    hi = jnp.where(
        s == 0, vh, (vl >> jnp.minimum(32 - s, 31)) & jnp.uint32(1)
    )
    hi = jnp.where(s > 32, 0, hi)
    return lo, hi


def _srl33(vl, vh, s):
    """v >> s on a 33-bit (low, high-bit) pair; s in [0, 33)."""
    lo = jnp.where(
        s == 0,
        vl,
        jnp.where(
            s < 33,
            (jnp.where(s < 32, vl >> jnp.minimum(s, 31), 0))
            | (vh << jnp.minimum(jnp.maximum(32 - s, 0), 31)),
            0,
        ),
    )
    hi = jnp.where(s == 0, vh, 0)
    return lo, hi


def _rotl33(vl, vh, r):
    """Rotate the 33-bit field left by r (per-lane u32 in [0, 33))."""
    al, ah = _sll33(vl, vh, r)
    bl, bh = _srl33(vl, vh, jnp.uint32(33) - r)
    bl = jnp.where(r == 0, 0, bl)
    bh = jnp.where(r == 0, 0, bh)
    return al | bl, ah | bh


def _rotl31(v, r):
    """Rotate a 31-bit value left by r (per-lane u32 in [0, 31))."""
    m31 = jnp.uint32(0x7FFFFFFF)
    hi = (v << jnp.minimum(r, 30)) & m31
    hi = jnp.where(r == 0, v, hi)
    lo = jnp.where(r == 0, 0, v >> jnp.minimum(jnp.uint32(31) - r, 30))
    return hi | lo


def _srol_n(lo, hi, r33, r31):
    """srol applied with per-lane rotation amounts (r33 in [0,33),
    r31 in [0,31)) to 64-bit values held as (lo, hi) u32 pairs. The split
    fields are bits [0,33) and [33,64) (constants.srol1)."""
    al, ah = lo, hi & jnp.uint32(1)
    b = hi >> jnp.uint32(1)
    al, ah = _rotl33(al, ah, r33)
    b = _rotl31(b, r31)
    return al, (b << jnp.uint32(1)) | ah


def _xor_prefix_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive XOR prefix scan, blocked two-level for long streams.

    jax.lax.associative_scan on a multi-million-element 1D vector builds a
    ~2*log2(n)-stage odd/even graph that is slow to compile at the 2^23
    stream shape. The identical scan over a (n/8192, 8192) reshape — per-row scans plus one
    tiny scan of row totals XORed back — is mathematically the same
    prefix (XOR is associative/commutative) with a shallower, regular
    graph. Bit-exact either way; the 1D path remains for streams not a
    multiple of 8192 (stream buckets are powers of two >= 2^14)."""
    n = x.shape[0]
    L = 8192
    if n <= L or n % L:
        return jax.lax.associative_scan(jnp.bitwise_xor, x)
    x2 = x.reshape(n // L, L)
    s_local = jax.lax.associative_scan(jnp.bitwise_xor, x2, axis=1)
    tot = jax.lax.associative_scan(jnp.bitwise_xor, s_local[:, -1])
    offs = jnp.concatenate([jnp.zeros(1, x.dtype), tot[:-1]])
    return (s_local ^ offs[:, None]).reshape(n)


def _windowed_hash_aa_prefix(codes: jnp.ndarray, k, seeds: jnp.ndarray):
    """Prefix-XOR reformulation of the forward aaHash — O(1) work per
    position regardless of k (the tap formulation pays a 32-way select
    tree per (position, tap), k of them per window):

      fh(p) = XOR_{q in [p, p+k)} srol^{(k-1+p)-q}( seed[s_q] )
            = srol^{k-1+p}( S(p+k-1) ^ S(p-1) )

    with G(q) = srol^{-q}(seed[s_q]) and S the prefix-XOR of G — srol is a
    bit permutation, hence XOR-linear, with independent 33/31-bit field
    rotations of periods 33 and 31. Bit-exact vs the tap path by
    construction (fuzz-tested). k is a traced scalar; seeds is the traced
    UNROTATED (32, 2) table."""
    n = codes.shape[0] - MAX_K
    total = codes.shape[0]
    k = k.astype(jnp.uint32)
    q = jnp.arange(total, dtype=jnp.uint32)
    g_lo, g_hi = _tap_select32_dyn(codes, seeds)
    # srol^{-q} = srol^{(33 - q%33) % 33, (31 - q%31) % 31}
    r33 = (jnp.uint32(33) - q % 33) % 33
    r31 = (jnp.uint32(31) - q % 31) % 31
    g_lo, g_hi = _srol_n(g_lo, g_hi, r33, r31)
    s_lo = _xor_prefix_scan(g_lo)
    s_hi = _xor_prefix_scan(g_hi)
    # window p: S(p+k-1) ^ S(p-1); S(-1) = 0 via a zero-prepended shift
    hi_end_lo = jax.lax.dynamic_slice(s_lo, (k - 1,), (n,))
    hi_end_hi = jax.lax.dynamic_slice(s_hi, (k - 1,), (n,))
    lo_end_lo = jnp.concatenate([jnp.zeros(1, _U32), s_lo[: n - 1]])
    lo_end_hi = jnp.concatenate([jnp.zeros(1, _U32), s_hi[: n - 1]])
    f_lo = hi_end_lo ^ lo_end_lo
    f_hi = hi_end_hi ^ lo_end_hi
    p = jnp.arange(n, dtype=jnp.uint32)
    e = p + (k - 1)
    return _srol_n(f_lo, f_hi, e % 33, e % 31)


def _windowed_hash_aa_rotsel(codes: jnp.ndarray, k, seeds: jnp.ndarray):
    """Rotate-after-select reformulation — the middle
    ground between the tap select trees and the prefix-XOR scan:

      fh(p) = XOR_{t<k} srol^t( r_{p + k-1-t} ),   r_q = seed[s_q]

    ONE 32-way select per position builds the unrotated seed stream r;
    the fori_loop then pays only a fixed srol1 (a compile-time-constant
    bit permutation, ~8 ops on the u32 pair) of the r stream plus a
    dynamic slice + XOR per tap — no per-tap select tree (taps: ~32 ops
    per (position, tap)) and no variable 33/31-field rotation or XOR scan
    (prefix). k is a traced scalar; seeds is the UNROTATED (32, 2) row
    (aa_seed_row_u32). Bit-exact vs the tap path by construction
    (fuzz-pinned in tests/test_aahash_prefix.py)."""
    from .nthash_multik import _srol1_pair

    n = codes.shape[0] - MAX_K
    r_lo, r_hi = _tap_select32_dyn(codes, seeds)
    # one materialization: without the barrier XLA re-fuses the select
    # tree into every loop iteration's consumer, undoing the hoist
    r_lo, r_hi = jax.lax.optimization_barrier((r_lo, r_hi))
    zeros = jnp.zeros(n, dtype=_U32)
    k = k.astype(jnp.int32)

    def body(t, carry):
        f_lo, f_hi, c_lo, c_hi = carry
        j = k - 1 - t
        f_lo = f_lo ^ jax.lax.dynamic_slice(c_lo, (j,), (n,))
        f_hi = f_hi ^ jax.lax.dynamic_slice(c_hi, (j,), (n,))
        c_lo, c_hi = _srol1_pair(c_lo, c_hi)
        return f_lo, f_hi, c_lo, c_hi

    f_lo, f_hi, _, _ = jax.lax.fori_loop(
        0, k, body, (zeros, zeros, r_lo, r_hi)
    )
    return f_lo, f_hi


def _windowed_hash_aa(codes: jnp.ndarray, k, taps: jnp.ndarray):
    """Forward-only k-generic windowed hash; k is a traced scalar and the
    per-tap rotated seed tables a traced input. codes must be padded with
    at least MAX_K trailing elements; returns (lo, hi) of length
    len(codes) - MAX_K for every window start."""
    n = codes.shape[0] - MAX_K
    zeros = jnp.zeros(n, dtype=_U32)

    def body(j, carry):
        f_lo, f_hi = carry
        cj = jax.lax.dynamic_slice(codes, (j,), (n,))
        row = jax.lax.dynamic_index_in_dim(taps, j, keepdims=False)
        tl, th = _tap_select32_dyn(cj, row)
        return f_lo ^ tl, f_hi ^ th

    return jax.lax.fori_loop(0, k, body, (zeros, zeros))


# static `variant` kernel arg -> windowed hash implementation. "taps"
# expects the (MAX_K, 32, 2) rotated tap tables; "prefix" and "rotsel"
# the unrotated (32, 2) seed row (aa_seed_row_u32).
_WINDOWED_HASH = {
    "taps": _windowed_hash_aa,
    "prefix": _windowed_hash_aa_prefix,
    "rotsel": _windowed_hash_aa_rotsel,
}


def _aa_window_mask_device(valid, starts, total, k, m, out_rows):
    """Device recomputation of the per-sample emission mask — the exact
    semantics of aahash_np.aa_window_valid applied to each sample of the
    concatenated stream, without any host work or mask upload:

    - a window is emitted iff its k residues are all valid (cumsum test
      over the whole stream) AND it does not cross a sample boundary
      (window starts in (end_i - k, end_i) are zeroed via an interval
      delta + cumsum; scatters touch only the `out_rows` boundaries),
    - the final window of a sample (start end_i - k) additionally
      requires residue end_i - k - 1 valid and sample length > k — the
      reference's final-window quirk (aahash_iterator.rs:138-210).

    valid: (N,) i32 0/1 per position; starts: (out_rows,) i32 sample
    starts with padding rows set to `total`; total/k traced i32 scalars.
    Returns (ok (m,) bool, counts (out_rows,) i32) where counts[i] is the
    number of emitted NON-final windows — the reference's reachability
    condition (aa_window_valid raises iff window_valid[:m-1].any() is
    false, i.e. counts == 0 -> the caller must raise the set_k panic)."""
    iota = jnp.arange(m, dtype=_I32)
    vc = jnp.concatenate(
        [jnp.zeros(1, dtype=_I32), jnp.cumsum(valid, dtype=_I32)]
    )
    wav = (jax.lax.dynamic_slice(vc, (k,), (m,)) - vc[:m]) == k

    ends = jnp.concatenate([starts[1:], total[None]])
    lens = ends - starts
    real = lens > 0  # padding rows have start == end == total

    # no window may start in (end_i - k, end_i); padding rows contribute
    # duplicate deltas on the same final interval, which is harmless
    # (cumsum goes more negative, `allowed` is already False there)
    delta = jnp.zeros(m + 1, dtype=_I32)
    delta = delta.at[jnp.clip(ends - k + 1, 0, m)].add(-1)
    delta = delta.at[jnp.clip(ends, 0, m)].add(1)
    allowed = (jnp.cumsum(delta, dtype=_I32)[:m] == 0) & (iota < total)

    fin = ends - k  # final-window start per sample
    quirk_ok = real & (lens > k) & (valid[jnp.clip(fin - 1, 0)] == 1)
    fidx = jnp.where(real, fin, jnp.int32(m))  # padding rows -> dropped
    qmask = jnp.ones(m, dtype=jnp.bool_).at[fidx].set(quirk_ok, mode="drop")
    isfinal = jnp.zeros(m, dtype=jnp.bool_).at[fidx].set(True, mode="drop")

    ok = wav & allowed & qmask
    nonfinal = wav & allowed & ~isfinal

    sflags = jnp.zeros(m, dtype=_I32).at[starts].add(1, mode="drop")
    gidx = jnp.cumsum(sflags, dtype=_I32) - 1
    counts = jax.ops.segment_sum(
        nonfinal.astype(_I32),
        jnp.minimum(gidx, out_rows - 1),
        num_segments=out_rows,
    )
    return ok, counts


@functools.partial(
    jax.jit, static_argnames=("num_bins", "magic", "out_rows", "variant")
)
def aa_hash_bin_kernel_devmask(
    codes: jnp.ndarray,  # (N,) uint8 compact codes, invalid bytes == 20
    starts: jnp.ndarray,  # (out_rows,) int32 sample start offsets
    k: jnp.ndarray,  # () int32 k-mer length (traced: no recompile per k)
    taps: jnp.ndarray,  # (MAX_K, 32, 2) u32 rotated taps ("taps"), or the
    #   UNROTATED (32, 2) seed row (aa_seed_row_u32) for "prefix"/"rotsel"
    total: jnp.ndarray,  # () int32 valid prefix length of the stream
    num_bins: int,
    magic: tuple[int, int],
    out_rows: int,
    variant: str = "taps",
):
    """aa_hash_bin_kernel with the emission mask computed ON DEVICE from
    the code stream — no host oracle pass and no mask upload. Only valid
    for whole samples (segments of an oversized stream must ship their
    pre-sliced global mask, because the final-window quirk is a property
    of the whole sequence). Returns (min_hi, min_lo, found, counts);
    counts[i] == 0 means sample i has no reachable window at this k and
    the caller must raise the reference's set_k panic."""
    c = codes.astype(_I32)
    n0 = c.shape[0]
    m = n0 - MAX_K
    k = k.astype(_I32)
    lo, hi = _WINDOWED_HASH[variant](c, k, taps)
    lo, hi = _mod_mersenne61(lo, hi)
    ok, counts = _aa_window_mask_device(
        (c < 20).astype(_I32), starts, total.astype(_I32), k, m, out_rows
    )
    mh, ml, fd = bin_min_sorted(lo, hi, ok, starts, n0, num_bins, magic, out_rows)
    return mh, ml, fd, counts


@functools.partial(
    jax.jit, static_argnames=("num_bins", "magic", "out_rows", "variant")
)
def aa_hash_bin_kernel(
    codes: jnp.ndarray,  # (N,) uint8 compact 5-bit aa codes, padded
    validbits: jnp.ndarray,  # (N/8,) uint8 bit-packed window emission flags
    starts: jnp.ndarray,  # (out_rows,) int32 sample start offsets
    k: jnp.ndarray,  # () int32 k-mer length (traced: no recompile per k)
    taps: jnp.ndarray,  # (MAX_K, 32, 2) u32 rotated taps ("taps"), or the
    #   UNROTATED (32, 2) seed row (aa_seed_row_u32) for "prefix"/"rotsel"
    num_bins: int,
    magic: tuple[int, int],
    out_rows: int,
    variant: str = "taps",
):
    """Batched aaHash + mod + bin-min over a concatenated sample stream.

    Window emission is decided on the host (1 bit per position) with the
    exact oracle, so device results are bit-identical by construction.
    Returns (min_hi, min_lo, found) as in the DNA kernel."""
    c = codes.astype(_I32)
    n0 = c.shape[0]
    m = n0 - MAX_K
    lo, hi = _WINDOWED_HASH[variant](c, k.astype(_I32), taps)
    lo, hi = _mod_mersenne61(lo, hi)
    ok = _unpack_bits(validbits)[:m] == 1
    return bin_min_sorted(lo, hi, ok, starts, n0, num_bins, magic, out_rows)
