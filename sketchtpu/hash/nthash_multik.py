"""Fast multi-k device sketching kernel.

Replaces the per-k (hash -> full 16M-element sort) pipeline of
`nthash_jax.hash_bin_kernel` with three ideas, ~10x kernel time for the
default 7-k core/accessory sketch workload:

1. **Incremental hashing over k.** ntHash's forward recurrence in k is
   fh_k(p) = srol(fh_{k-1}(p)) ^ SEED[s[p+k-1]] and the reverse-complement
   recurrence is rh_k(p) = rh_{k-1}(p) ^ srol^{k-1}(RC[s[p+k-1]])
   (unrolling /root/reference/src/hashing/nthash_iterator.rs:325-415 in k
   instead of p). One pass over the stream with a carried (fh, rh) pair
   yields every k-mer length's hashes for ~1/5 of the tap work.

2. **Residual prefilter (exact).** Only the per-(genome, bin) *minimum*
   sign survives sketching. Keep an element iff its in-bin residual
   `sign - bin*binsize` is below a per-genome threshold T_g: because all
   elements of a bin share the bin start, *if any element of a bin passes,
   the bin's minimum passes too* — so every produced minimum is provably
   the true minimum. T_g is sized so each bin keeps ~12 candidates in
   expectation; a bin with no survivor (probability e^-12 per bin, or a
   genuinely empty bin) and block overflow are both detected and the whole
   group falls back to the exact full-sort kernel. The test
   `residual < T` is evaluated divide-only as `bin(sign) != bin(sign-T)`
   (T < binsize, so subtracting T either stays in-bin — residual >= T —
   or crosses the bin start).

3. **Sort candidates, not the stream.** Kept elements (~1-3% of windows)
   are compacted blockwise with a monotone masked-reduce (the keep-rank
   `pos` is a cumsum, so slot s of a block is `max over l of key[l]
   where pos[l]==s` — no scatter, no gather), then a single 3-key sort
   over all k-mer lengths' candidates ((k, genome), sign-hi, sign-lo)
   replaces nk full-stream 2-key sorts. Run heads of the sorted candidate
   stream are the bin minima, exactly as in the full-sort kernel.

Everything lands bit-identical to `hash_bin_kernel` whenever the fast path
reports no fallback — asserted by tests/test_multik.py.

Single-k requests route here only for small genomes (<= 1 Mb): with no
multi-k pass sharing the win is purely the larger genome groups (96 vs 7
per dispatch), so big single-k genomes stay on the exact kernel
(sketch_jax._fast_eligible). The cut-over is not yet tuned on the GPU.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import NT_HASH_SEEDS, SIGN_MOD, nt_tap_tables
from .nthash_jax import (
    MAX_K,
    _mod_mersenne61,
    _mul_shift,
    _tap_select,
    _unpack_bits,
    _unpack_codes,
)

_U32 = jnp.uint32
_I32 = jnp.int32


def _srol1_pair(lo: jnp.ndarray, hi: jnp.ndarray):
    """srol1 (33/31 split rotate-left by one, constants.py:35-48) on a
    (lo32, hi32) pair."""
    new_lo = (lo << _U32(1)) | (hi & _U32(1))
    h = hi >> _U32(1)  # the 31-bit high part
    h_rot = ((h << _U32(1)) | (h >> _U32(30))) & _U32(0x7FFFFFFF)
    new_hi = (h_rot << _U32(1)) | (lo >> _U32(31))
    return new_lo, new_hi


def _seed_rows_u32():
    """Base forward seed row (4, 2) u32 — the j = k-1 tap."""
    out = np.zeros((4, 2), dtype=np.uint32)
    for b in range(4):
        v = NT_HASH_SEEDS[b]
        out[b, 0] = v & 0xFFFFFFFF
        out[b, 1] = v >> 32
    return out


def _rc_rows_u32(kmax: int):
    """(kmax, 4, 2) u32: row j = srol^j(RC_SEED[b]) — the RC tap at in-window
    offset j, independent of k."""
    _, rev = nt_tap_tables(kmax)
    out = np.zeros((kmax, 4, 2), dtype=np.uint32)
    out[:, :, 0] = (rev & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, :, 1] = (rev >> np.uint64(32)).astype(np.uint32)
    return out


def _sub_pair(lo, hi, t_lo, t_hi):
    """(hi<<32|lo) - (t_hi<<32|t_lo) on u32 pairs, with an underflow flag."""
    d_lo = lo - t_lo
    borrow = (lo < t_lo).astype(_U32)
    d_hi = hi - t_hi - borrow
    under = (hi < t_hi) | ((hi == t_hi) & (lo < t_lo))
    return d_lo, d_hi, under


def _compact_candidates(keep_p, key0_p, hi_p, lo_p, blk, w, sentinel_key):
    """Blockwise monotone compaction of already-padded 1-D streams: slot s
    of a block holds the (s+1)-th kept element (kpos is a cumsum, so a
    masked one-hot reduce — no scatter, no gather). The (B, w, blk) hit
    tensor costs O(stream * w) with w a multiple of 8. Shared by the DNA
    and AA multi-k kernels. Returns flattened (c_k0, c_hi, c_lo) plus the max
    per-block keep count (overflow detection)."""
    nb_blocks = keep_p.shape[0] // blk
    kb = keep_p.reshape(nb_blocks, blk)
    key0 = key0_p.reshape(nb_blocks, blk)
    e_hi = hi_p.reshape(nb_blocks, blk)
    e_lo = lo_p.reshape(nb_blocks, blk)
    kpos = jnp.cumsum(kb.astype(_I32), axis=1) - kb.astype(_I32)
    count_max = jnp.max(kpos[:, -1] + kb[:, -1])
    slot = jax.lax.broadcasted_iota(_I32, (1, w, 1), 1)
    hit = kb[:, None, :] & (kpos[:, None, :] == slot)  # (B, w, blk)
    c_k0 = jnp.max(jnp.where(hit, key0[:, None, :], -1), axis=2)
    c_hi = jnp.max(jnp.where(hit, e_hi[:, None, :], _U32(0)), axis=2)
    c_lo = jnp.max(jnp.where(hit, e_lo[:, None, :], _U32(0)), axis=2)
    # empty slots -> a sentinel key0 sorting after every real (k, genome)
    c_k0 = jnp.where(c_k0 < 0, sentinel_key, c_k0)
    return c_k0.reshape(-1), c_hi.reshape(-1), c_lo.reshape(-1), count_max


def _sort_and_extract(cand_k0, cand_hi, cand_lo, kmers, out_rows, num_bins,
                      magic):
    """One 3-key sort over every k's candidate slots, then run heads of the
    sorted (key, sign) stream are the per-(k, genome, bin) minima — the
    shared tail of the DNA and AA multi-k kernels. Returns
    (out_hi, out_lo, found) each (nk, out_rows * num_bins)."""
    mm, ss = magic
    all_k0 = jnp.concatenate(cand_k0)
    all_hi = jnp.concatenate(cand_hi)
    all_lo = jnp.concatenate(cand_lo)
    s_k0, s_hi, s_lo = jax.lax.sort((all_k0, all_hi, all_lo), num_keys=3)

    s_bins = s_k0 * num_bins + _mul_shift(s_lo, s_hi, mm, ss)
    n_cand = s_bins.shape[0]
    # searchsorted targets: only the real (k, genome) combinations
    targets = (
        (jnp.arange(len(kmers), dtype=_I32)[:, None, None] << 8)
        + jnp.arange(out_rows, dtype=_I32)[None, :, None]
    ) * num_bins + jnp.arange(num_bins, dtype=_I32)[None, None, :]
    targets = targets.reshape(-1)
    idx = jnp.searchsorted(s_bins, targets)
    idx_c = jnp.clip(idx, 0, n_cand - 1)
    found = s_bins[idx_c] == targets
    out_hi = s_hi[idx_c].reshape(len(kmers), out_rows * num_bins)
    out_lo = s_lo[idx_c].reshape(len(kmers), out_rows * num_bins)
    return out_hi, out_lo, found.reshape(len(kmers), out_rows * num_bins)


@functools.partial(
    jax.jit,
    static_argnames=("kmers", "rc", "num_bins", "magic", "out_rows", "blk", "w"),
)
def multik_hash_bin_kernel(
    packed: jnp.ndarray,  # (N/4,) uint8 2-bit packed base codes, padded
    breakbits: jnp.ndarray,  # (N/8,) uint8 bit-packed break flags
    starts: jnp.ndarray,  # (out_rows,) int32 genome start offsets
    total: jnp.ndarray,  # () int32 real (unpadded) base count
    t_lo: jnp.ndarray,  # (out_rows,) u32 per-genome threshold low word
    t_hi: jnp.ndarray,  # (out_rows,) u32 threshold high word
    kmers: tuple[int, ...],  # ascending k-mer lengths (static)
    rc: bool,
    num_bins: int,
    magic: tuple[int, int],
    out_rows: int,
    blk: int,  # compaction block length (static)
    w: int,  # compaction slots per block (static)
):
    """Returns (min_hi, min_lo, found) each (nk, out_rows * num_bins), plus
    `overflow` () int32: the max keep-count over compaction blocks. The host
    must discard the whole group and fall back to the exact kernel when
    overflow > w or when any `found` is False."""
    kmax = kmers[-1]
    codes = _unpack_codes(packed)
    n0 = codes.shape[0]
    m = n0 - MAX_K
    mm, ss = magic

    pos = jnp.arange(m, dtype=_I32)
    bflags = _unpack_bits(breakbits)
    csum = jnp.cumsum(bflags, dtype=_I32)
    sflags = jnp.zeros(n0, dtype=_I32).at[starts].add(1, mode="drop")
    gidx = jnp.cumsum(sflags, dtype=_I32)[:m] - 1

    # per-element thresholds: a one-hot select over the small genome table
    # in place of a gather or a prefix-xor scan (not yet measured against
    # either on the GPU)
    tl = jnp.zeros(m, dtype=_U32)
    th = jnp.zeros(m, dtype=_U32)
    for g in range(out_rows):
        sel = gidx == g
        tl = jnp.where(sel, t_lo[g], tl)
        th = jnp.where(sel, t_hi[g], th)
    # materialize once: without the barrier XLA re-fuses the out_rows-deep
    # select chain into every k's prefilter consumer, where one round-trip
    # through device memory is cheap
    tl, th = jax.lax.optimization_barrier((tl, th))

    seed_row = _seed_rows_u32()
    rc_rows = _rc_rows_u32(kmax)

    # compaction runs over the full padded length (a power of two, so it
    # divides into whole blocks); the MAX_K tail windows carry keep=False
    nb_blocks = n0 // blk
    assert nb_blocks * blk == n0, (n0, blk)
    pad_tail = n0 - m

    f_lo = jnp.zeros(m, dtype=_U32)
    f_hi = jnp.zeros(m, dtype=_U32)
    r_lo = jnp.zeros(m, dtype=_U32)
    r_hi = jnp.zeros(m, dtype=_U32)

    cand_k0 = []  # (k_idx << 8 | gidx) or sentinel
    cand_hi = []
    cand_lo = []
    overflow = jnp.int32(0)

    for step in range(1, kmax + 1):
        # extend every window by one base: s[p + step - 1]
        cj = jax.lax.slice(codes, (step - 1,), (step - 1 + m,))
        sl, sh = _tap_select(cj, seed_row.view(np.uint64).reshape(4))
        f_lo, f_hi = _srol1_pair(f_lo, f_hi)
        f_lo = f_lo ^ sl
        f_hi = f_hi ^ sh
        if rc:
            rl, rh = _tap_select(cj, rc_rows[step - 1].view(np.uint64).reshape(4))
            r_lo = r_lo ^ rl
            r_hi = r_hi ^ rh
        if step not in kmers:
            continue
        k_idx = kmers.index(step)
        if rc:
            rev_smaller = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
            h_lo = jnp.where(rev_smaller, r_lo, f_lo)
            h_hi = jnp.where(rev_smaller, r_hi, f_hi)
        else:
            h_lo, h_hi = f_lo, f_hi
        h_lo, h_hi = _mod_mersenne61(h_lo, h_hi)

        # window validity at this k
        shifted = jax.lax.slice(csum, (step - 1,), (step - 1 + m,))
        ok = (shifted - jax.lax.slice(csum, (0,), (m,))) == 0
        ok = ok & (pos + step <= total)

        # residual prefilter: keep iff sign < T or bin(sign) != bin(sign-T)
        bin_idx = _mul_shift(h_lo, h_hi, mm, ss)
        d_lo, d_hi, under = _sub_pair(h_lo, h_hi, tl, th)
        bin_shift = _mul_shift(
            jnp.where(under, _U32(0), d_lo), jnp.where(under, _U32(0), d_hi), mm, ss
        )
        keep = ok & (under | (bin_idx != bin_shift))

        # blockwise monotone compaction (shared helper)
        c_k0, c_hi, c_lo, count_max = _compact_candidates(
            jnp.pad(keep, (0, pad_tail)),
            jnp.pad((_I32(k_idx) << 8) | gidx, (0, pad_tail)),
            jnp.pad(h_hi, (0, pad_tail)),
            jnp.pad(h_lo, (0, pad_tail)),
            blk,
            w,
            _I32(len(kmers)) << 8,
        )
        overflow = jnp.maximum(overflow, count_max)
        cand_k0.append(c_k0)
        cand_hi.append(c_hi)
        cand_lo.append(c_lo)

    # one sort over all k's candidates: (k_idx|gidx, hi, lo)
    out_hi, out_lo, found = _sort_and_extract(
        cand_k0, cand_hi, cand_lo, kmers, out_rows, num_bins, magic
    )
    return out_hi, out_lo, found, overflow


def group_thresholds(
    lengths: list[int], num_bins: int, c: int = 16
) -> tuple[np.ndarray, np.ndarray, bool, float]:
    """Per-genome residual thresholds T_g ~ c * binsize * num_bins / m_g.

    Returns (t_lo, t_hi, eligible, max_density): eligible is False when any
    genome is so small that the prefilter would keep >1/8 of its windows
    (route the group to the exact kernel instead); max_density is the
    largest per-window keep probability, used to size compaction blocks.

    c = 16 keeps ~16 expected candidates per (genome, bin): the per-bin
    empty probability ~e^-16 (slightly worse at the mod-fold density
    ripple) makes the exact fallback a <1%-of-groups event, where c = 12
    measured ~14% of groups losing some bin and re-running exactly.
    """
    binsize = (SIGN_MOD + num_bins - 1) // num_bins
    t_lo = np.zeros(len(lengths), dtype=np.uint32)
    t_hi = np.zeros(len(lengths), dtype=np.uint32)
    max_density = 0.0
    eligible = True
    for g, m_g in enumerate(lengths):
        if m_g <= 0:
            eligible = False
            continue
        t = min(binsize, (c * binsize * num_bins) // m_g + 1)
        density = t / binsize
        max_density = max(max_density, density)
        if density > 0.125:
            eligible = False
        t_lo[g] = t & 0xFFFFFFFF
        t_hi[g] = t >> 32
    return t_lo, t_hi, eligible, max_density


def pick_block_geometry(max_density: float, blk: int = 1024) -> tuple[int, int]:
    """(blk, w): compaction slots sized for Poisson(lambda = density * blk)
    with a ~6-sigma margin, bucketed to limit recompilation.

    The compaction reduce costs O(stream * w) per k (the (B, w, blk)
    one-hot hit tensor), while the candidate-sort volume is
    (stream/blk) * w — so w is the smallest sufficient multiple of 8 and
    blk balances the two. blk=1024 is not yet retuned on the GPU
    (ROADMAP). Any overflow still falls back to the exact kernel, so
    geometry never affects results."""
    lam = max_density * blk
    need = int(lam + 6.0 * np.sqrt(lam + 1.0) + 8.0)
    for w in (16, 24, 32, 40, 48, 56, 64, 96, 128, 160, 192, 224, 256):
        if need <= w:
            return blk, w
    return blk, 256
