"""Device (JAX/XLA) ntHash + sign extraction.

Data-parallel formulation (see hash/nthash_np.py for the derivation):

  hash(p) = min( XOR_j srol^{k-1-j}(SEED[s[p+j]]),
                 XOR_j srol^{j}(RC_SEED[s[p+j]]) )

Everything is computed on uint32 word pairs (no u64 arithmetic needed):
per-tap lookup of the statically rotated seed tables is a 3-deep select
tree over the 2-bit base code, the windowed XOR is a static-slice reduction,
and the Mersenne reduction mod 2^61-1 is shift-add. Division by the bin
width uses a host-verified magic multiply so arbitrary (non power-of-two)
bin counts stay exact.

One kernel instance processes a whole *batch* of genomes: streams are
concatenated with break positions at genome boundaries and binned into a
[G * num_bins] table via two-pass int32 scatter-min, which keeps a single
compiled program per (k, bucket-size) and lets XLA fuse the entire
hash->mod->bin pipeline.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import nt_tap_tables

_U32 = jnp.uint32
_I32 = jnp.int32

# sentinel for empty bins in the hi-word pass: any value > max sign hi (2^29)
_HI_SENTINEL = np.int32(1 << 30)
_LO_SENTINEL = np.int32(0x7FFFFFFF)


def magic_divider(d: int, max_quotient: int) -> tuple[int, int]:
    """(M, S) such that floor(x*M >> S) == x // d for all x < 2^61, verified
    exactly with integer arithmetic.

    Uses the round-up method: M = ceil(2^S / d), e = M*d - 2^S. Writing
    x = b*d + r, x*M = b*2^S + b*e + r*M, correctness for all x < 2^61
    follows from (max_quotient)*e < M (checked below; both the value at bin
    starts and at bin ends are then exact, and the mapping is monotone).
    """
    for s_extra in range(0, 64):
        S = 61 + s_extra
        M = -(-(1 << S) // d)  # ceil
        e = M * d - (1 << S)
        if max_quotient * e < M and M < (1 << 64):
            return M, S
    raise ValueError(f"no magic divider for d={d}")


def _u16_limbs(value: int, n: int) -> list[np.uint32]:
    return [np.uint32((value >> (16 * i)) & 0xFFFF) for i in range(n)]


def _mul_shift(lo: jnp.ndarray, hi: jnp.ndarray, m: int, shift: int) -> jnp.ndarray:
    """floor(((hi<<32 | lo) * m) >> shift) for a 64-bit constant m, with the
    result guaranteed to fit in int32. 16-bit limb long multiplication."""
    x_limbs = [
        lo & _U32(0xFFFF),
        lo >> _U32(16),
        hi & _U32(0xFFFF),
        hi >> _U32(16),
    ]
    m_limbs = _u16_limbs(m, 4)
    # 8-limb accumulator of 16-bit limbs with carries
    acc = [jnp.zeros_like(lo) for _ in range(8)]
    for i in range(4):
        if int(m_limbs[i]) == 0:
            continue
        mi = _U32(int(m_limbs[i]))
        for jlimb in range(4):
            prod = x_limbs[jlimb] * mi  # fits in u32 (16x16)
            acc[i + jlimb] = acc[i + jlimb] + (prod & _U32(0xFFFF))
            acc[i + jlimb + 1] = acc[i + jlimb + 1] + (prod >> _U32(16))
    # propagate carries
    for i in range(7):
        acc[i + 1] = acc[i + 1] + (acc[i] >> _U32(16))
        acc[i] = acc[i] & _U32(0xFFFF)
    # extract >> shift: the quotient fits in int32, so at most three limbs
    # contribute bits below 2^31
    word = shift // 16
    bit = shift % 16
    zeros = jnp.zeros_like(lo)
    r0 = acc[word] if word < 8 else zeros
    r1 = acc[word + 1] if word + 1 < 8 else zeros
    r2 = acc[word + 2] if word + 2 < 8 else zeros
    if bit:
        out = (r0 >> _U32(bit)) | (r1 << _U32(16 - bit)) | (r2 << _U32(32 - bit))
    else:
        out = r0 | (r1 << _U32(16))
    return out.astype(_I32)


def _tap_select(codes: jnp.ndarray, table_row: np.ndarray) -> tuple:
    """Look up a 4-entry u64 tap table by 2-bit code -> (lo, hi) u32."""
    t = [int(v) for v in table_row]
    lo_vals = [np.uint32(v & 0xFFFFFFFF) for v in t]
    hi_vals = [np.uint32(v >> 32) for v in t]
    low_bit = (codes & 1).astype(jnp.bool_)
    high_bit = (codes >> 1).astype(jnp.bool_)

    def sel(vals):
        v01 = jnp.where(low_bit, _U32(int(vals[1])), _U32(int(vals[0])))
        v23 = jnp.where(low_bit, _U32(int(vals[3])), _U32(int(vals[2])))
        return jnp.where(high_bit, v23, v01)

    return sel(lo_vals), sel(hi_vals)


def _tap_select_dyn(codes: jnp.ndarray, row: jnp.ndarray) -> tuple:
    """Like _tap_select but with a traced (4, 2) u32 table row."""
    low_bit = (codes & 1).astype(jnp.bool_)
    high_bit = (codes >> 1).astype(jnp.bool_)

    def sel(vals):  # vals: (4,) u32
        v01 = jnp.where(low_bit, vals[1], vals[0])
        v23 = jnp.where(low_bit, vals[3], vals[2])
        return jnp.where(high_bit, v23, v01)

    return sel(row[:, 0]), sel(row[:, 1])


def tap_tables_u32(k: int, rc: bool) -> tuple[np.ndarray, np.ndarray]:
    """Per-tap tables as (MAX_K, 4, 2) u32 [lo, hi] arrays, zero-padded past
    k so they can be passed as traced inputs to the k-generic kernel."""
    fwd, rev = nt_tap_tables(k)
    out_f = np.zeros((MAX_K, 4, 2), dtype=np.uint32)
    out_r = np.zeros((MAX_K, 4, 2), dtype=np.uint32)
    out_f[:k, :, 0] = (fwd & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out_f[:k, :, 1] = (fwd >> np.uint64(32)).astype(np.uint32)
    if rc:
        out_r[:k, :, 0] = (rev & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out_r[:k, :, 1] = (rev >> np.uint64(32)).astype(np.uint32)
    return out_f, out_r


MAX_K = 64


def _windowed_hash_dyn(codes: jnp.ndarray, k, taps_fwd, taps_rev, rc: bool):
    """k-generic windowed hash: k is a traced scalar, the per-tap rotated
    seed tables are traced inputs, and the tap loop is a fori_loop — one
    compiled program covers every k-mer length (huge compile-time win, and
    XLA keeps the loop carries in place).

    codes must be padded with at least MAX_K trailing elements. Returns
    (lo, hi) of length len(codes) - MAX_K for every window start (windows
    running past the valid data are masked downstream).
    """
    n = codes.shape[0] - MAX_K
    zeros = jnp.zeros(n, dtype=_U32)

    def body(j, carry):
        f_lo, f_hi, r_lo, r_hi = carry
        cj = jax.lax.dynamic_slice(codes, (j,), (n,))
        row_f = jax.lax.dynamic_index_in_dim(taps_fwd, j, keepdims=False)
        tl, th = _tap_select_dyn(cj, row_f)
        f_lo = f_lo ^ tl
        f_hi = f_hi ^ th
        if rc:
            row_r = jax.lax.dynamic_index_in_dim(taps_rev, j, keepdims=False)
            rl, rh = _tap_select_dyn(cj, row_r)
            r_lo = r_lo ^ rl
            r_hi = r_hi ^ rh
        return f_lo, f_hi, r_lo, r_hi

    f_lo, f_hi, r_lo, r_hi = jax.lax.fori_loop(
        0, k, body, (zeros, zeros, zeros, zeros)
    )
    if not rc:
        return f_lo, f_hi
    rev_smaller = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
    return (
        jnp.where(rev_smaller, r_lo, f_lo),
        jnp.where(rev_smaller, r_hi, f_hi),
    )


def _mod_mersenne61(lo: jnp.ndarray, hi: jnp.ndarray):
    """(hi<<32|lo) mod (2^61 - 1) on u32 pairs."""
    # x = (x & M) + (x >> 61);  x >> 61 = hi >> 29 (<= 7)
    a_lo = lo
    a_hi = hi & _U32(0x1FFFFFFF)
    add = hi >> _U32(29)
    new_lo = a_lo + add
    carry = (new_lo < a_lo).astype(_U32)
    new_hi = a_hi + carry
    # if result >= M: subtract M  (M = 2^61-1: lo=0xFFFFFFFF, hi=0x1FFFFFFF)
    ge = (new_hi > _U32(0x1FFFFFFF)) | (
        (new_hi == _U32(0x1FFFFFFF)) & (new_lo == _U32(0xFFFFFFFF))
    )
    # subtracting M == adding 1 then clearing bit 61 (mod 2^64 semantics):
    sub_lo = new_lo + _U32(1)
    sub_carry = (sub_lo == _U32(0)).astype(_U32)
    sub_hi = (new_hi + sub_carry) & _U32(0x1FFFFFFF)
    lo_out = jnp.where(ge, sub_lo, new_lo)
    hi_out = jnp.where(ge, sub_hi, new_hi)
    return lo_out, hi_out


def _unpack_codes(packed: jnp.ndarray) -> jnp.ndarray:
    """(N/4,) uint8 2-bit packed -> (N,) int32 base codes. Base 0 is in the
    high bits of each byte (matching host packing order)."""
    p = packed.astype(jnp.int32)
    shifts = jnp.array([6, 4, 2, 0], dtype=jnp.int32)
    return ((p[:, None] >> shifts[None, :]) & 3).reshape(-1)


def _unpack_bits(flagbytes: jnp.ndarray) -> jnp.ndarray:
    """(N/8,) uint8 bit-packed flags -> (N,) int32 0/1 (LSB first)."""
    p = flagbytes.astype(jnp.int32)
    shifts = jnp.arange(8, dtype=jnp.int32)
    return ((p[:, None] >> shifts[None, :]) & 1).reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("rc", "num_bins", "magic", "out_rows")
)
def hash_bin_kernel(
    packed: jnp.ndarray,  # (N/4,) uint8 2-bit packed base codes, padded
    breakbits: jnp.ndarray,  # (N/8,) uint8 bit-packed break flags
    starts: jnp.ndarray,  # (out_rows,) int32 genome start offsets
    total: jnp.ndarray,  # () int32 number of real (unpadded) bases
    k: jnp.ndarray,  # () int32 k-mer length (traced: no recompile per k)
    taps_fwd: jnp.ndarray,  # (MAX_K, 4, 2) u32 rotated seed taps
    taps_rev: jnp.ndarray,  # (MAX_K, 4, 2) u32 rotated RC seed taps
    rc: bool,
    num_bins: int,
    magic: tuple[int, int],
    out_rows: int,
):
    """Batched hash + mod + bin-min over a concatenated genome stream.

    Host->device traffic is 2 bits/base (packed codes) + 1 bit/base (break
    flags); window validity and genome ids are reconstructed on device with
    cumulative sums rather than a searchsorted over millions of queries or
    a scatter.

    Per-bin minima come from a two-key sort: the key packs (genome index,
    sign hi-word) into one u32 — the bin index is monotone in the sign, so
    each (genome, bin) is a contiguous run of the sorted stream and the run
    head is the minimum, located by a searchsorted over the out_rows *
    num_bins bin ids. Returns (min_hi, min_lo, found); empty bins have
    found == False.
    """
    codes = _unpack_codes(packed)
    n0 = codes.shape[0]
    m = n0 - MAX_K  # window starts considered; tail masked via `total`
    k = k.astype(_I32)
    lo, hi = _windowed_hash_dyn(codes, k, taps_fwd, taps_rev, rc)
    lo, hi = _mod_mersenne61(lo, hi)
    mm, ss = magic

    pos = jnp.arange(m, dtype=_I32)
    # C[p] = number of break positions <= p; window [s, s+k) is valid iff
    # no break p with s < p <= s+k-1, i.e. C[s+k-1] - C[s] == 0
    bflags = _unpack_bits(breakbits)
    csum = jnp.cumsum(bflags, dtype=_I32)
    shifted = jax.lax.dynamic_slice(csum, (k - 1,), (m,))
    ok = (shifted - jax.lax.slice(csum, (0,), (m,))) == 0
    ok = ok & (pos + k <= total)
    return bin_min_sorted(lo, hi, ok, starts, n0, num_bins, magic, out_rows)


def bin_min_sorted(lo, hi, ok, starts, n0, num_bins, magic, out_rows):
    """Per-(genome, bin) sign minima via a multi-key sort. lo/hi are (m,)
    u32 sign words, ok the (m,) emission mask, starts the (out_rows,) i32
    genome start offsets in the length-n0 concatenated stream.

    out_rows <= 7 packs (genome, sign-hi) into ONE u32 sort key: the sign
    occupies 61 bits so hi < 2^29, leaving 3 bits for the genome index
    (gidx 7 marks invalid windows). Wider groups (small-sample batches,
    up to _MAX_GROUP_WIDE) carry the genome index as a separate third
    sort key instead — ~1.5x the sort bytes buys ~9x fewer dispatches.
    Either way the bin index is monotone in the sign, so sorting by
    (gidx, hi, lo) orders each genome's stream by bin and each run head
    is the minimum. Returns (min_hi, min_lo, found); empty bins have
    found == False."""
    m = lo.shape[0]
    mm, ss = magic
    sflags = jnp.zeros(n0, dtype=_I32).at[starts].add(1, mode="drop")
    gidx = jnp.cumsum(sflags, dtype=_I32)[:m].astype(_U32) - _U32(1)

    if out_rows <= 7:
        marker = _U32(7 << 29)
        key1 = jnp.where(ok, (gidx << _U32(29)) | hi, _U32(0xFFFFFFFF))
        sorted_key, sorted_lo = jax.lax.sort((key1, lo), num_keys=2)
        sorted_hi = sorted_key & _U32(0x1FFFFFFF)
        sorted_gidx = jnp.where(
            sorted_key >= marker,
            jnp.int32(out_rows),
            (sorted_key >> _U32(29)).astype(_I32),
        )
    else:
        gkey = jnp.where(ok, gidx, _U32(0xFFFFFFFF))
        sorted_gkey, sorted_hi, sorted_lo = jax.lax.sort(
            (gkey, hi, lo), num_keys=3
        )
        # invalid windows sort last (gkey 2^32-1); clamp them to out_rows
        # so their bin ids land past the searchsorted range
        sorted_gidx = jnp.where(
            sorted_gkey >= _U32(out_rows),
            jnp.int32(out_rows),
            sorted_gkey.astype(_I32),
        )
    sorted_bins = sorted_gidx * num_bins + _mul_shift(
        sorted_lo, sorted_hi, mm, ss
    )
    size = out_rows * num_bins
    # first element of each bin's run is its minimum
    idx = jnp.searchsorted(sorted_bins, jnp.arange(size, dtype=_I32))
    idx_c = jnp.clip(idx, 0, m - 1)
    found = sorted_bins[idx_c] == jnp.arange(size, dtype=_I32)
    return sorted_hi[idx_c], sorted_lo[idx_c], found


def combine_bin_minima(
    min_hi: np.ndarray, min_lo: np.ndarray, found: np.ndarray
) -> np.ndarray:
    """Host-side: (hi, lo, found) -> u64 signs (empty bins -> u64::MAX)."""
    signs = (min_hi.astype(np.uint64) << np.uint64(32)) | min_lo.astype(
        np.uint64
    )
    return np.where(found, signs, np.uint64(0xFFFFFFFFFFFFFFFF))


@functools.partial(jax.jit, static_argnames=("rc",))
def hash_signs_kernel(
    packed: jnp.ndarray,
    k: jnp.ndarray,
    taps_fwd: jnp.ndarray,
    taps_rev: jnp.ndarray,
    rc: bool,
):
    """Hash + mod only (for the order-dependent FASTQ filter path): returns
    (lo, hi) u32 arrays for every window start (length N - MAX_K)."""
    codes = _unpack_codes(packed)
    lo, hi = _windowed_hash_dyn(codes, k.astype(_I32), taps_fwd, taps_rev, rc)
    return _mod_mersenne61(lo, hi)
