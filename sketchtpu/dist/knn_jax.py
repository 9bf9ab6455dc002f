"""Device sparse kNN engines: top-k neighbour selection on device.

The host drivers (api.py) argsort full distance rows — fine at 10k samples,
dominated by host work at 100k+. Here the whole selection runs on device:
samebits tiles stream over column blocks and a running top-k (values +
global column indices) is merged per block with `jax.lax.top_k`, so only
(rows x knn) results ever leave the chip.

Selection semantics match the reference heap (distances/mod.rs:41-48,
133-224): distance is monotone decreasing in samebits at one k, so top-k by
samebits = bottom-k by distance; ties prefer the lowest column index because
the running candidates (earlier columns) sit before the new tile in the
merge concatenation and `lax.top_k` favours earlier positions on ties. The
final printed distances are recomputed on the host from the selected
samebits with the exact f64 pipeline, so output values are identical to the
host path; only the *choice* among exactly-tied distances can differ, which
the reference itself leaves heap-order-defined.

Core/accessory kNN SELECTS by the f32 core distance computed on device
(near-tie neighbour choice is in the f32 accuracy class, like single-k
tie choice is heap-order-defined in the reference), but the printed
values are recomputed exactly: the selected pairs' per-k samebits are
gathered on device (_gather_pair_samebits) and the host replays the f64
Jaccard + regression chain, so every emitted value matches the host
oracle bit for bit.

The precluster variant fuses the inverted-index any-shared-bin prefilter
(inverted.rs:271-300, distances/mod.rs:399-553) into the same scan: a sign-
equality mask tile invalidates non-candidate columns before the top-k merge.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import BBITS
from .coreacc_jax import coreacc_tile
from .jaccard_jax import _samebits_tile
from .jaccard_np import ani_pois, core_acc_from_jaccards, jaccard_from_samebits

_NEG = -0x7FFFFFFF


def _tile_valid(c0, tr, tc, row0, nb_real, exclude_self, masked, a_sig,
                b_sig):
    """(cols, valid) for one column tile: in-range, not-self, and (in
    masked mode) sharing at least one inverted-index sign."""
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (tr, tc), 1)
    valid = cols < nb_real
    if exclude_self:
        rows = row0 + jax.lax.broadcasted_iota(jnp.int32, (tr, tc), 0)
        valid = valid & (cols != rows)
    if masked:
        st = jax.lax.dynamic_slice(b_sig, (c0, 0), (tc, b_sig.shape[1]))
        shared = (a_sig[:, None, :] == st[None, :, :]).any(axis=2)
        valid = valid & shared
    return cols, valid


_MERGE_GROUP = 8  # two-stage merge group width (see _tile_topk_reduce)


def _tile_topk_reduce(key: jnp.ndarray, knn: int, g: int = _MERGE_GROUP):
    """Exact two-stage shrink of a (tr, tc) key tile ahead of the top-k
    merge: group-max over adjacent groups of g columns, stable top-knn of
    the group maxes, then the selected groups gathered back in ascending-
    column order. Returns (keys (tr, knn*g), tile-local positions) — a
    superset of the per-row stable top-knn with IDENTICAL tie semantics
    (value desc, column asc):

    Every element of the stable top-knn lives in the top-knn groups by
    (max desc, group idx asc) — any group ranked above element e's group
    contributes one element strictly preceding e (greater value, or equal
    value at a lower column since whole groups are column-ordered) — and
    sorting the selected group indices keeps the gathered columns
    ascending, so the follow-up `lax.top_k` breaks ties exactly as it
    would on the full tile. The point is to shrink `lax.top_k`'s input
    (its cost grows faster than its width); returns (key, None) when the
    tile is too narrow to shrink."""
    tr, tc = key.shape
    ng = tc // g
    if tc % g or ng <= knn:
        return key, None
    k3 = key.reshape(tr, ng, g)
    gm = k3.max(axis=2)
    _, gsel = jax.lax.top_k(gm, knn)
    gsel = jnp.sort(gsel, axis=1)
    keys_r = jnp.take_along_axis(k3, gsel[:, :, None], axis=1)
    loc = gsel[:, :, None] * g + jax.lax.broadcasted_iota(
        gsel.dtype, (tr, knn, g), 2
    )
    return keys_r.reshape(tr, knn * g), loc.reshape(tr, knn * g)


@functools.partial(
    jax.jit, static_argnames=("s64", "knn", "tc", "exclude_self", "masked")
)
def _knn_scan_block(
    a: jnp.ndarray,  # (tr, W2) u32 row-block sketch planes
    b: jnp.ndarray,  # (nbp, W2) u32 all column planes, padded to tc multiple
    row0: jnp.ndarray,  # () int32 global row offset of this block
    nb_real: jnp.ndarray,  # () int32 real (unpadded) column count
    a_sig: jnp.ndarray,  # (tr, S) i32 row signs (masked mode; else (tr, 1))
    b_sig: jnp.ndarray,  # (nbp, S) i32 column signs (masked mode)
    s64: int,
    knn: int,
    tc: int,
    exclude_self: bool,
    masked: bool,
):
    """Running top-k by samebits over column tiles. Returns
    (vals (tr, knn) int32 samebits, idxs (tr, knn) int32 global columns).
    Invalid/masked-out columns never appear unless a row has fewer than knn
    candidates, in which case trailing entries have vals == _NEG."""
    nbp, w2 = b.shape
    tr = a.shape[0]
    n_tiles = nbp // tc
    # + row0*0: inherit row0's device-varying type so the scan carry matches
    # the body output when running per-shard under shard_map (scan-vma rule)
    init_v = jnp.full((tr, knn), _NEG, jnp.int32) + row0 * 0
    init_i = jnp.full((tr, knn), 0x7FFFFFFF, jnp.int32) + row0 * 0

    def body(carry, t):
        vals, idxs = carry
        c0 = t * tc
        bt = jax.lax.dynamic_slice(b, (c0, 0), (tc, w2))
        sb = _samebits_tile(a, bt, s64)
        cols, valid = _tile_valid(
            c0, tr, tc, row0, nb_real, exclude_self, masked, a_sig, b_sig
        )
        sb = jnp.where(valid, sb, _NEG)
        sb, loc = _tile_topk_reduce(sb, knn)
        if loc is not None:
            cols = jnp.take_along_axis(cols, loc, axis=1)
        cat_v = jnp.concatenate([vals, sb], axis=1)
        cat_i = jnp.concatenate([idxs, cols], axis=1)
        v2, sel = jax.lax.top_k(cat_v, knn)
        i2 = jnp.take_along_axis(cat_i, sel, axis=1)
        return (v2, i2), None

    (vals, idxs), _ = jax.lax.scan(
        body, (init_v, init_i), jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return vals, idxs


def _pack_shift(s64: int) -> int:
    """Bits reserved for the column field of a packed (samebits, col) int32
    key: 31 minus the bits needed for samebits (<= s64*64)."""
    return 31 - int(s64 * 64).bit_length()


@functools.partial(
    jax.jit,
    static_argnames=("s64", "knn", "tc", "exclude_self", "masked"),
)
def _knn_scan_block_packed(
    a: jnp.ndarray,  # (tr, W2) u32 rows
    b: jnp.ndarray,  # (nbp, W2) u32 columns, padded to a tc multiple
    row0: jnp.ndarray,
    nb_real: jnp.ndarray,
    s64: int,
    knn: int,
    tc: int,
    exclude_self: bool,
    a_sig: jnp.ndarray | None = None,  # (tr, S) i32 row signs (masked mode)
    b_sig: jnp.ndarray | None = None,  # (nbp, S) i32 column signs
    masked: bool = False,
):
    """Fast unmasked kNN scan: same contract as _knn_scan_block(masked=False)
    with two changes for throughput that leave selection semantics
    IDENTICAL (asserted by parity tests):

    - validity masking is branch-gated per column tile: only tiles crossing
      this row block's diagonal (self exclusion) or the padded tail pay for
      the (tr, tc) iota/compare/where chain — interior tiles skip it;
    - samebits and column index pack into one int32 key
      (sb << shift | (mask - col)), so the running top-k merge is a single
      `lax.top_k` with no index gathers, and ordering ties break exactly
      like the reference heap (samebits desc, column asc).

    Callers must guarantee nbp <= 2^shift - 1 (engine checks via
    _pack_shift; at the default s=1000 that is 1M columns)."""
    nbp, w2 = b.shape
    tr = a.shape[0]
    n_tiles = nbp // tc
    shift = _pack_shift(s64)
    colmask = (1 << shift) - 1
    init = jnp.full((tr, knn), -1, jnp.int32) + row0 * 0

    def body(carry, t):
        c0 = t * tc

        def compute_sb():
            bt = jax.lax.dynamic_slice(b, (c0, 0), (tc, w2))
            return _samebits_tile(a, bt, s64)

        def apply_mask(sb):
            cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (tr, tc), 1)
            valid = cols < nb_real
            if exclude_self:
                rows = row0 + jax.lax.broadcasted_iota(
                    jnp.int32, (tr, tc), 0
                )
                valid = valid & (cols != rows)
            return jnp.where(valid, sb, _NEG)

        def merge(carry, sb):
            sb_s, loc = _tile_topk_reduce(sb, knn)
            if loc is None:
                loc = jax.lax.broadcasted_iota(jnp.int32, sb_s.shape, 1)
            packed = (sb_s << shift) | (colmask - (c0 + loc))
            packed = jnp.where(sb_s < 0, -1, packed)
            cat = jnp.concatenate([carry, packed], axis=1)
            merged, _ = jax.lax.top_k(cat, knn)
            return merged

        if masked:
            # sign-equality prefilter: every tile pays for the mask. A
            # tile with NO candidate pairs skips samebits + selection
            # entirely via the cond below; it rarely fires on real data
            # (u16-truncated signs give unrelated pairs a ~S/2^16
            # background shared-bin rate, so multi-M-pair tiles are never
            # empty) — kept because it costs nothing and fires on
            # degenerate inputs
            st = jax.lax.dynamic_slice(
                b_sig, (c0, 0), (tc, b_sig.shape[1])
            )
            shared = (a_sig[:, None, :] == st[None, :, :]).any(axis=2)
            cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (tr, tc), 1)
            valid = shared & (cols < nb_real)
            if exclude_self:
                rows = row0 + jax.lax.broadcasted_iota(
                    jnp.int32, (tr, tc), 0
                )
                valid = valid & (cols != rows)

            def with_candidates(carry):
                return merge(carry, jnp.where(valid, compute_sb(), _NEG))

            return (
                jax.lax.cond(
                    valid.any(), with_candidates, lambda c: c, carry
                ),
                None,
            )

        sb = compute_sb()
        needs_mask = c0 + tc > nb_real
        if exclude_self:
            needs_mask = needs_mask | (
                (c0 + tc > row0) & (c0 < row0 + tr)
            )
        sb = jax.lax.cond(needs_mask, apply_mask, lambda x: x, sb)
        return merge(carry, sb), None

    carry, _ = jax.lax.scan(
        body, init, jnp.arange(n_tiles, dtype=jnp.int32)
    )
    vals = jnp.where(carry < 0, _NEG, carry >> shift)
    idxs = jnp.where(carry < 0, 0x7FFFFFFF, colmask - (carry & colmask))
    return vals, idxs


@functools.partial(
    jax.jit,
    static_argnames=("s64", "knn", "tc", "exclude_self", "masked", "cutoff"),
)
def _knn_scan_block_comp(
    a: jnp.ndarray,
    b: jnp.ndarray,
    row0: jnp.ndarray,
    nb_real: jnp.ndarray,
    a_sig: jnp.ndarray,
    b_sig: jnp.ndarray,
    c1: jnp.ndarray,  # (tr,) f32 row completeness
    c2: jnp.ndarray,  # (nbp,) f32 column completeness
    s64: int,
    knn: int,
    tc: int,
    exclude_self: bool,
    masked: bool,
    cutoff: float,
):
    """Single-k selection under completeness correction: the per-sample
    correction breaks samebits-distance monotonicity ACROSS columns, so
    the running top-k keys on the corrected f32 Jaccard (monotone for
    both plain and ANI distances). Returns the SELECTED raw samebits +
    indices; the host recomputes exact f64 corrected values from them,
    so printed output matches the host path (selection among f32
    near-ties may differ, the same accuracy class as the core/acc
    engines)."""
    nbp, w2 = b.shape
    tr = a.shape[0]
    n_tiles = nbp // tc
    maxnbits = float(s64 * 64)
    expected = float(int(s64 * 64) >> BBITS)
    init_k = jnp.full((tr, knn), -jnp.inf, jnp.float32) + row0 * 0
    init_v = jnp.full((tr, knn), _NEG, jnp.int32) + row0 * 0
    init_i = jnp.full((tr, knn), 0x7FFFFFFF, jnp.int32) + row0 * 0

    def body(carry, t):
        keys, vals, idxs = carry
        c0 = t * tc
        bt = jax.lax.dynamic_slice(b, (c0, 0), (tc, w2))
        sb = _samebits_tile(a, bt, s64)
        cols, valid = _tile_valid(
            c0, tr, tc, row0, nb_real, exclude_self, masked, a_sig, b_sig
        )
        diff = jnp.maximum(sb.astype(jnp.float32) - expected, 0.0)
        j = (diff * maxnbits / (maxnbits - expected)) / maxnbits
        c2t = jax.lax.dynamic_slice(c2, (c0,), (tc,))
        prod = c1[:, None] * c2t[None, :]
        factor = prod / (c1[:, None] + c2t[None, :] - prod)
        j = jnp.where(
            prod >= jnp.float32(cutoff), jnp.minimum(j / factor, 1.0), j
        )
        key = jnp.where(valid, j, -jnp.inf)
        sb = jnp.where(valid, sb, _NEG)
        key, loc = _tile_topk_reduce(key, knn)
        if loc is not None:
            sb = jnp.take_along_axis(sb, loc, axis=1)
            cols = jnp.take_along_axis(cols, loc, axis=1)
        cat_k = jnp.concatenate([keys, key], axis=1)
        cat_v = jnp.concatenate([vals, sb], axis=1)
        cat_i = jnp.concatenate([idxs, cols], axis=1)
        k2, sel = jax.lax.top_k(cat_k, knn)
        return (
            k2,
            jnp.take_along_axis(cat_v, sel, axis=1),
            jnp.take_along_axis(cat_i, sel, axis=1),
        ), None

    (keys, vals, idxs), _ = jax.lax.scan(
        body, (init_k, init_v, init_i), jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return vals, idxs


def _ca_topk_merge(carry, ca, c0, row0, nb_real, a_sig, b_sig, knn,
                   exclude_self, masked):
    """Merge one (tr, tc, 2) core/acc tile into the running top-k carry
    (selection key is the negated core distance)."""
    keys, accs, idxs = carry
    tr, tc = ca.shape[0], ca.shape[1]
    cols, valid = _tile_valid(
        c0, tr, tc, row0, nb_real, exclude_self, masked, a_sig, b_sig
    )
    key = jnp.where(valid, -ca[:, :, 0], -jnp.inf)
    acc_tile = ca[:, :, 1]
    key, loc = _tile_topk_reduce(key, knn)
    if loc is not None:
        acc_tile = jnp.take_along_axis(acc_tile, loc, axis=1)
        cols = jnp.take_along_axis(cols, loc, axis=1)
    cat_k = jnp.concatenate([keys, key], axis=1)
    cat_a = jnp.concatenate([accs, acc_tile], axis=1)
    cat_i = jnp.concatenate([idxs, cols], axis=1)
    k2, sel = jax.lax.top_k(cat_k, knn)
    return (
        k2,
        jnp.take_along_axis(cat_a, sel, axis=1),
        jnp.take_along_axis(cat_i, sel, axis=1),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "s64", "kmers", "sketch_size", "knn", "tc", "exclude_self", "masked",
        "cutoff",
    ),
)
def _knn_scan_block_ca(
    a_stack: jnp.ndarray,  # (nk, tr, W2) u32
    b_stack: jnp.ndarray,  # (nk, nbp, W2) u32
    row0: jnp.ndarray,
    nb_real: jnp.ndarray,
    a_sig: jnp.ndarray,  # (tr, S) i32 row signs (masked mode; else (tr, 1))
    b_sig: jnp.ndarray,  # (nbp, S) i32 column signs (masked mode)
    s64: int,
    kmers: tuple[int, ...],
    sketch_size: int,
    knn: int,
    tc: int,
    exclude_self: bool,
    masked: bool,
    c1: jnp.ndarray | None = None,  # (tr,) f32 row completeness
    c2: jnp.ndarray | None = None,  # (nbp,) f32 column completeness
    cutoff: float = 0.64,
):
    """Running top-k by (negated) core distance. Returns (core (tr, knn) f32,
    acc (tr, knn) f32, idxs (tr, knn) int32)."""
    nk, nbp, w2 = b_stack.shape
    tr = a_stack.shape[1]
    n_tiles = nbp // tc
    # + row0*0: inherit row0's device-varying type under shard_map (scan-vma)
    init_key = jnp.full((tr, knn), -jnp.inf, jnp.float32) + row0 * 0
    init_acc = jnp.zeros((tr, knn), jnp.float32) + row0 * 0
    init_i = jnp.full((tr, knn), 0x7FFFFFFF, jnp.int32) + row0 * 0

    def body(carry, t):
        c0 = t * tc
        bt = jax.lax.dynamic_slice(b_stack, (0, c0, 0), (nk, tc, w2))
        c2t = (
            jax.lax.dynamic_slice(c2, (c0,), (tc,))
            if c1 is not None
            else None
        )
        ca = coreacc_tile(
            a_stack, bt, s64, kmers, sketch_size,
            c1=c1, c2=c2t, cutoff=cutoff,
        )
        return _ca_topk_merge(
            carry, ca, c0, row0, nb_real, a_sig, b_sig, knn,
            exclude_self, masked,
        ), None

    (keys, accs, idxs), _ = jax.lax.scan(
        body, (init_key, init_acc, init_i), jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return -keys, accs, idxs


class SparseKnnRows:
    """Array-backed sparse kNN result from the device engines.

    Iterating yields per-row item lists, identical to the host drivers'
    output (so tests and the precluster post-processing see lists), while
    dist/output.write_sparse consumes the arrays directly via as_arrays()
    — building 5M+ Python tuples was a bigger cost than the device scan.

    vals is (n, knn) f32 for Jaccard/ANI or (n, knn, 2) f32 for core/acc;
    valid is an optional (n, knn) bool emission mask (invalid trailing
    entries are truncated from the per-row lists, as the host path does).
    """

    def __init__(self, idx: np.ndarray, vals: np.ndarray,
                 valid: np.ndarray | None):
        self.idx = idx
        self.vals = vals
        self.valid = valid

    def as_arrays(self):
        return self.idx, self.vals, self.valid

    def __len__(self):
        return self.idx.shape[0]

    def _row(self, r: int) -> list:
        knn = self.idx.shape[1]
        cols = range(knn)
        if self.valid is not None:
            cols = [c for c in cols if self.valid[r, c]]
        if self.vals.ndim == 3:
            return [
                (int(self.idx[r, c]), np.float32(self.vals[r, c, 0]),
                 np.float32(self.vals[r, c, 1]))
                for c in cols
            ]
        return [(int(self.idx[r, c]), np.float32(self.vals[r, c])) for c in cols]

    def __getitem__(self, r: int) -> list:
        return self._row(r)

    def __iter__(self):
        for r in range(len(self)):
            yield self._row(r)


def rows_from_samebits(
    sb: np.ndarray, idx: np.ndarray, dist_type, s64: int,
    as_lists: bool = False,
    c1_rows: np.ndarray | None = None,
    c2_all: np.ndarray | None = None,
    cutoff: float = 0.64,
):
    """Exact f64 host post-processing of selected samebits -> sparse rows
    (ANI items hold the similarity, as the host driver emits). Entries
    with sb == _NEG are missing candidates and are truncated. c1_rows
    (na,) / c2_all (n,) apply the completeness correction (c2 gathered by
    the selected column indices)."""
    na, knn = sb.shape
    if c1_rows is not None:
        c1 = np.repeat(np.asarray(c1_rows, dtype=np.float64), knn)
        c2 = np.asarray(c2_all, dtype=np.float64)[
            np.clip(idx, 0, len(c2_all) - 1).ravel()
        ]
        j = jaccard_from_samebits(sb.ravel(), s64, c1, c2, cutoff).reshape(
            na, knn
        )
    else:
        j = jaccard_from_samebits(sb.ravel(), s64).reshape(na, knn)
    if dist_type.ani:
        d = ani_pois(j, dist_type.k).astype(np.float32)  # similarity
    else:
        d = (1.0 - j).astype(np.float32)
    rows = SparseKnnRows(idx, d, sb != _NEG)
    return list(rows) if as_lists else rows


def _pad_rows(mat: np.ndarray, mult: int) -> np.ndarray:
    pad = (-mat.shape[0]) % mult
    if pad:
        mat = np.pad(mat, ((0, pad), (0, 0)))
    return mat


@functools.partial(jax.jit, static_argnames=("s64",))
def _gather_pair_samebits(a_stack, b_stack, a_idx, b_idx, s64: int):
    """Exact per-pair samebits for selected pairs, every k at once:
    a_stack (nk, na, W2) u32, b_stack (nk, nb, W2) u32, a_idx/b_idx (m,)
    int32 -> (m, nk) int32. Elementwise (not a tile): used to recompute
    the values of kNN-selected pairs exactly."""
    a = a_stack[:, a_idx, :]
    b = b_stack[:, b_idx, :]
    x = ~(a ^ b)
    nk, m, w2 = x.shape
    x = x.reshape(nk, m, s64, BBITS, 2)
    acc = x[:, :, :, 0, :]
    for p in range(1, BBITS):
        acc = acc & x[:, :, :, p, :]
    counts = jnp.sum(
        jax.lax.population_count(acc), axis=(2, 3), dtype=jnp.int32
    )
    return jnp.transpose(counts)


_PAIR_CHUNK = 1 << 15  # selected pairs per exact-recompute dispatch


def exact_ca_values(ms, s64, idx, core_f32, acc_f32, a_stack_dev,
                    b_stack_dev, a_rows, c1_rows, c2_host, cutoff):
    """Replace the f32 engine core/acc values of the SELECTED pairs with
    the exact f64 pipeline's: gather per-pair samebits for every k on
    device (_gather_pair_samebits, chunked), then run the same host f64
    chain as api.self_dists_knn (Jaccard bias + completeness +
    regression), and re-sort each row by (f32(core), column) — the host
    driver's order. Selection itself remains in the f32 accuracy class
    (near-tie neighbour choice, documented), but every emitted value
    equals the host oracle's bit for bit. a_rows maps each result row to
    its index in a_stack_dev. Returns (core, acc, idx) re-sorted."""
    valid = (idx != 0x7FFFFFFF) & np.isfinite(core_f32)
    vr, vc = np.nonzero(valid)
    m = vr.size
    if m:
        a_idx_all = np.asarray(a_rows, dtype=np.int32)[vr]
        b_idx_all = idx[vr, vc].astype(np.int32)
        chunks = []
        for c0 in range(0, m, _PAIR_CHUNK):
            c1 = min(c0 + _PAIR_CHUNK, m)
            chunks.append(_gather_pair_samebits(
                a_stack_dev, b_stack_dev,
                jnp.asarray(a_idx_all[c0:c1]),
                jnp.asarray(b_idx_all[c0:c1]),
                s64,
            ))
        sb = np.concatenate([np.asarray(c) for c in chunks])  # (m, nk)
        kmers = list(ms.kmer_lengths)
        comp_c1 = comp_c2 = None
        if c1_rows is not None and c2_host is not None:
            comp_c1 = np.asarray(c1_rows, dtype=np.float64)[vr]
            comp_c2 = np.asarray(c2_host, dtype=np.float64)[b_idx_all]
        jaccs = np.empty((m, len(kmers)), dtype=np.float64)
        for ki in range(len(kmers)):
            jaccs[:, ki] = jaccard_from_samebits(
                sb[:, ki], s64, comp_c1, comp_c2, cutoff
            )
        core_x, acc_x = core_acc_from_jaccards(jaccs, kmers, ms.sketch_size)
        core_f32 = core_f32.copy()
        acc_f32 = acc_f32.copy()
        core_f32[vr, vc] = core_x.astype(np.float32)
        acc_f32[vr, vc] = acc_x.astype(np.float32)
    # host order: ascending (f32 distance, column index); invalid entries
    # (core=inf, idx=0x7FFFFFFF) sort last. f32 bit patterns of
    # non-negative floats are order-isomorphic to the values.
    key = (
        core_f32.astype(np.float32).view(np.int32).astype(np.int64) << 32
    ) | idx.astype(np.int64)
    order = np.argsort(key, axis=1, kind="stable")
    return (
        np.take_along_axis(core_f32, order, axis=1),
        np.take_along_axis(acc_f32, order, axis=1),
        np.take_along_axis(idx, order, axis=1),
    )


class PreclusterKnnMixin:
    """Fused inverted-prefilter + kNN driver (distances/mod.rs:399-553),
    shared by the single-device and mesh-sharded engines.

    The engine supplies four scan primitives (plus .ms/.n/.s64):

    - _pc_scan(dist_type, lo, hi, signs, knn, comp, cutoff) -> (sb, idx):
      masked single-k scan over rows [lo, hi); `signs` is the full
      skd-ordered (n, S) u16 sign matrix, comp an optional (n,) f64
      completeness vector;
    - _pc_scan_subset(dist_type, rows, knn, comp, cutoff) -> (sb, idx):
      UNMASKED scan over a gathered global-row subset (bruteforce rescue;
      self-exclusion is done by the caller);
    - _pc_ca(lo, hi, signs, knn, comp, cutoff) -> SparseKnnRows: masked
      multi-k core/accessory scan (comp is (n,) f32 here);
    - _pc_ca_subset(rows, knn, comp, cutoff) -> SparseKnnRows.

    Candidate semantics, retain-unmatched handling and knn padding live
    here once. skq_bins is the flat u16 sign stream in .ski order; rows
    follow the .skd order. row_range restricts to a block of rows
    (multi-process sharding); candidate columns always range over all
    samples.

    Core/accessory mode is an extension (the reference leaves it
    `unimplemented!`, distances/mod.rs:548-550): the same sign-equality
    prefilter mask gates the fused multi-k core/accessory tile, with
    neighbours ranked by core distance (see api.py host driver)."""

    def precluster_knn(
        self,
        inverted,
        skq_bins: np.ndarray,
        knn: int,
        dist_type,
        retain_unmatched: str | None = None,
        row_range: slice | None = None,
        completeness_vec=None,
        completeness_cutoff: float = 0.64,
    ):
        from .api import ski_skd_maps

        n = self.n
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        stride = inverted.sketch_size
        # name-based ski<->skd mapping, shared with the host driver
        ski_of_skd = np.asarray(ski_skd_maps(self.ms, inverted)[0])
        signs = skq_bins.reshape(-1, stride)[ski_of_skd]  # skd-ordered (n, S)

        if dist_type.coreacc:
            return self._pc_coreacc(
                signs, knn, lo, hi, retain_unmatched, completeness_vec,
                completeness_cutoff,
            )

        comp_sk = (
            np.asarray(completeness_vec, dtype=np.float64)
            if completeness_vec is not None
            else None
        )
        sb, idx = self._pc_scan(
            dist_type, lo, hi, signs, knn, comp_sk, completeness_cutoff
        )
        rows_out = rows_from_samebits(
            sb, idx, dist_type, self.s64, as_lists=True,
            c1_rows=comp_sk[lo:hi] if comp_sk is not None else None,
            c2_all=comp_sk, cutoff=completeness_cutoff,
        )

        # rows with zero candidates: retain_unmatched handling
        empty = np.flatnonzero(sb[:, 0] == _NEG)  # local (row - lo) indices
        if empty.size and retain_unmatched == "bruteforce":
            sb2, idx2 = self._pc_scan_subset(
                dist_type, lo + empty, min(knn + 1, self.n), comp_sk,
                completeness_cutoff,
            )
            # exclude self manually (the scans' exclude_self keys on block
            # row offset, which is wrong for a gathered row subset)
            for bi, r_loc in enumerate(empty):
                mask = idx2[bi] != lo + r_loc
                sb_r = sb2[bi][mask][:knn]
                idx_r = idx2[bi][mask][:knn]
                rows_out[r_loc] = rows_from_samebits(
                    sb_r[None, :], idx_r[None, :], dist_type, self.s64,
                    as_lists=True,
                    c1_rows=(
                        comp_sk[lo + r_loc : lo + r_loc + 1]
                        if comp_sk is not None
                        else None
                    ),
                    c2_all=comp_sk, cutoff=completeness_cutoff,
                )[0]
        # singleton + padding entries use raw 0.0/1.0 regardless of ANI mode
        # (the host driver and distance_matrix.rs:377-380 do the same; the
        # print filter skips (row, 1.0) self entries); indices are global
        for r_loc in range(hi - lo):
            r = lo + r_loc
            items = rows_out[r_loc]
            if not items and retain_unmatched == "singleton":
                rows_out[r_loc] = [(r, np.float32(0.0))] + [
                    (r, np.float32(1.0))
                ] * (knn - 1)
                continue
            if len(items) < knn:
                rows_out[r_loc] = items + [(r, np.float32(1.0))] * (
                    knn - len(items)
                )
        return rows_out

    def _pc_coreacc(self, signs, knn, lo, hi, retain_unmatched,
                    completeness_vec, cutoff):
        comp = (
            np.asarray(completeness_vec, dtype=np.float32)
            if completeness_vec is not None
            else None
        )
        res = self._pc_ca(lo, hi, signs, knn, comp, cutoff)
        idx_a, vals_a, _ = res.as_arrays()
        rows_ca: list[list[tuple]] = []
        for r_loc in range(hi - lo):
            ok = np.flatnonzero(
                np.isfinite(vals_a[r_loc, :, 0])
                & (idx_a[r_loc] != 0x7FFFFFFF)
            )
            rows_ca.append(
                [
                    (
                        int(idx_a[r_loc, x]),
                        np.float32(vals_a[r_loc, x, 0]),
                        np.float32(vals_a[r_loc, x, 1]),
                    )
                    for x in ok
                ]
            )
        empty_ca = [r for r in range(hi - lo) if not rows_ca[r]]
        if empty_ca and retain_unmatched == "bruteforce":
            res2 = self._pc_ca_subset(
                np.asarray([lo + r for r in empty_ca]),
                min(knn + 1, self.n), comp, cutoff,
            )
            idx2, vals2, _ = res2.as_arrays()
            for bi, r_loc in enumerate(empty_ca):
                # exclude self manually (the scan's exclude_self keys
                # on block row offset, wrong for a gathered subset)
                keep = np.flatnonzero(
                    (idx2[bi] != lo + r_loc)
                    & np.isfinite(vals2[bi, :, 0])
                    & (idx2[bi] != 0x7FFFFFFF)
                )[:knn]
                rows_ca[r_loc] = [
                    (
                        int(idx2[bi, x]),
                        np.float32(vals2[bi, x, 0]),
                        np.float32(vals2[bi, x, 1]),
                    )
                    for x in keep
                ]
        if retain_unmatched == "singleton":
            for r_loc in empty_ca:
                if not rows_ca[r_loc]:
                    rows_ca[r_loc] = [
                        (lo + r_loc, np.float32(0.0), np.float32(0.0))
                    ]
        return rows_ca


class DeviceKnnEngine(PreclusterKnnMixin):
    """On-device kNN over a reference sketch DB.

    Holds the b-bit plane matrices device-resident (u32 view of the .skd
    u64 words); one scan per row block streams column tiles and returns only
    the selected neighbours.
    """

    def __init__(self, ref_ms, row_tile: int = 2048,
                 col_tile: int | None = None):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.ms = ref_ms
        self.s64 = ref_ms.sketchsize64
        self.row_tile = row_tile
        # col_tile is the padding multiple and the scans' column tile:
        # with the grouped merge, the big top_k input stays ~knn*9
        # regardless of tile width, so wider tiles amortise the per-tile
        # group-max/top-k. Padded columns are computed and discarded, so
        # the default picks the widest tile whose padding waste stays
        # under ~10% of the run (50k samples -> 4096, 100k+ -> 8192)
        if col_tile is None:
            n = ref_ms.number_samples_loaded()
            col_tile = 2048
            for tc in (8192, 4096):
                if n and ((-n) % tc) / n <= 0.10:
                    col_tile = tc
                    break
        self.col_tile = col_tile
        self.n = ref_ms.number_samples_loaded()
        self._planes: dict[int, jax.Array] = {}
        self._planes_host: dict[int, np.ndarray] = {}
        self._dummy_sig = np.zeros((1, 1), dtype=np.int32)

    def _plane_host(self, k_idx: int) -> np.ndarray:
        if k_idx not in self._planes_host:
            self._planes_host[k_idx] = np.ascontiguousarray(
                self.ms.bins_matrix(k_idx)
            ).view(np.uint32)
        return self._planes_host[k_idx]

    def _plane(self, k_idx: int) -> jax.Array:
        if k_idx not in self._planes:
            self._planes[k_idx] = jax.device_put(
                _pad_rows(self._plane_host(k_idx), self.col_tile)
            )
        return self._planes[k_idx]

    def _stack_host(self) -> np.ndarray:
        """(nk, n_pad, W2) u32 multi-k stack on the host (no transfer)."""
        if "stack_host" not in self.__dict__:
            nk = len(self.ms.kmer_lengths)
            w = self.ms.kmer_stride
            mat = self.ms.sketch_bins.reshape(self.n, nk, w)
            stack = np.ascontiguousarray(mat.transpose(1, 0, 2)).view(np.uint32)
            pad = (-self.n) % self.col_tile
            if pad:
                stack = np.pad(stack, ((0, 0), (0, pad), (0, 0)))
            self.__dict__["stack_host"] = stack
        return self.__dict__["stack_host"]

    def _stack(self) -> jax.Array:
        if "stack" not in self.__dict__:
            self.__dict__["stack"] = jax.device_put(self._stack_host())
        return self.__dict__["stack"]

    # --- single-k (Jaccard / ANI) ---

    def _scan_rows(
        self,
        a_mat: np.ndarray,
        b_dev: jax.Array,
        knn: int,
        exclude_self: bool,
        a_sig: np.ndarray | None = None,
        b_sig_dev: jax.Array | None = None,
        row_base: int = 0,
        c1_rows: np.ndarray | None = None,
        c2_dev: jax.Array | None = None,
        cutoff: float = 0.64,
        a_dev: jax.Array | None = None,
    ):
        """Generic row-block scan; a_mat is host u32 (na, W2). row_base is
        the global index of a_mat's first row (self-exclusion offset when
        rows are a multi-process slice). c1_rows/c2_dev switch selection
        to the completeness-corrected kernel. a_dev, when given, is a
        device-resident matrix holding the same rows at global indices
        (the self case passes the column matrix): row blocks then slice
        on device instead of re-uploading planes that already live in
        device memory."""
        na = a_mat.shape[0]
        masked = a_sig is not None
        tc = self.col_tile
        comp = c1_rows is not None
        out_v = np.empty((na, knn), dtype=np.int32)
        out_i = np.empty((na, knn), dtype=np.int32)
        dummy = self._dummy_sig
        # dispatch every row block before collecting any (async): only the
        # (rows x knn) results come back, so nothing bounds the window
        pending = []
        # packed fast path: uncorrected scans whose column count fits the
        # int32 key's column field (1M at the default s=1000)
        packed_ok = (
            not comp
            and 0 < b_dev.shape[0] <= (1 << _pack_shift(self.s64)) - 1
        )
        for r0 in range(0, na, self.row_tile):
            r1 = min(r0 + self.row_tile, na)
            sig_blk = a_sig[r0:r1].astype(np.int32) if masked else dummy
            a_blk = (
                a_dev[row_base + r0 : row_base + r1]
                if a_dev is not None
                else a_mat[r0:r1]
            )
            if comp:
                v, i = _knn_scan_block_comp(
                    a_blk,
                    b_dev,
                    np.int32(row_base + r0),
                    np.int32(self.n),
                    sig_blk,
                    b_sig_dev if masked else dummy,
                    jnp.asarray(c1_rows[r0:r1].astype(np.float32)),
                    c2_dev,
                    s64=self.s64,
                    knn=knn,
                    tc=tc,
                    exclude_self=exclude_self,
                    masked=masked,
                    cutoff=cutoff,
                )
            elif packed_ok:
                v, i = _knn_scan_block_packed(
                    a_blk,
                    b_dev,
                    np.int32(row_base + r0),
                    np.int32(self.n),
                    s64=self.s64,
                    knn=knn,
                    tc=tc,
                    exclude_self=exclude_self,
                    a_sig=sig_blk if masked else None,
                    b_sig=b_sig_dev if masked else None,
                    masked=masked,
                )
            else:
                v, i = _knn_scan_block(
                    a_blk,
                    b_dev,
                    np.int32(row_base + r0),
                    np.int32(self.n),
                    sig_blk,
                    b_sig_dev if masked else dummy,
                    s64=self.s64,
                    knn=knn,
                    tc=tc,
                    exclude_self=exclude_self,
                    masked=masked,
                )
            pending.append((r0, r1, v, i))
        for r0, r1, v, i in pending:
            out_v[r0:r1] = np.asarray(v)[: r1 - r0]
            out_i[r0:r1] = np.asarray(i)[: r1 - r0]
        return out_v, out_i

    def _rows_from_samebits(
        self, sb: np.ndarray, idx: np.ndarray, dist_type,
        as_lists: bool = False, c1_rows=None, c2_all=None,
        cutoff: float = 0.64,
    ):
        return rows_from_samebits(
            sb, idx, dist_type, self.s64, as_lists,
            c1_rows=c1_rows, c2_all=c2_all, cutoff=cutoff,
        )

    def self_knn(self, knn: int, dist_type, row_range: slice | None = None,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        """Self kNN (Jaccard or ANI); row_range restricts to a block of
        rows (multi-process sharding), neighbours always range over all
        samples. With completeness the device selects by the corrected
        f32 Jaccard and the host recomputes exact f64 values."""
        b_dev = self._plane(dist_type.k_idx)
        a_mat = self._plane_host(dist_type.k_idx)
        base = 0
        comp = (
            np.asarray(completeness_vec, dtype=np.float64)
            if completeness_vec is not None
            else None
        )
        c1 = comp
        if row_range is not None:
            a_mat = a_mat[row_range]
            base = row_range.start
            if comp is not None:
                c1 = comp[row_range]
        sb, idx = self._scan_rows(
            a_mat, b_dev, knn, exclude_self=True, row_base=base,
            c1_rows=c1,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            cutoff=completeness_cutoff,
            a_dev=b_dev,
        )
        return self._rows_from_samebits(
            sb, idx, dist_type,
            c1_rows=c1, c2_all=comp, cutoff=completeness_cutoff,
        )

    def cross_knn(self, query_ms, knn: int, dist_type,
                  ref_completeness_vec=None, query_completeness_vec=None,
                  completeness_cutoff: float = 0.64):
        """Cross kNN: rows = queries, neighbours among refs. Correction
        applies only when BOTH sides have values (jaccard.rs:36-42)."""
        q = np.ascontiguousarray(query_ms.bins_matrix(dist_type.k_idx)).view(
            np.uint32
        )
        b_dev = self._plane(dist_type.k_idx)
        c1 = c2 = None
        if (
            ref_completeness_vec is not None
            and query_completeness_vec is not None
        ):
            c1 = np.asarray(query_completeness_vec, dtype=np.float64)
            c2 = np.asarray(ref_completeness_vec, dtype=np.float64)
        sb, idx = self._scan_rows(
            q, b_dev, knn, exclude_self=False,
            c1_rows=c1,
            c2_dev=self._comp_cols_dev(c2) if c2 is not None else None,
            cutoff=completeness_cutoff,
        )
        return self._rows_from_samebits(
            sb, idx, dist_type,
            c1_rows=c1, c2_all=c2, cutoff=completeness_cutoff,
        )

    # --- multi-k core/accessory ---

    def _knn_coreacc(self, row_stack: np.ndarray, nrows: int, knn: int,
                     exclude_self: bool, row_base: int = 0,
                     a_sig: np.ndarray | None = None,
                     b_sig_dev=None,
                     c1_rows: np.ndarray | None = None,
                     c2_dev=None,
                     c2_host: np.ndarray | None = None,
                     cutoff: float = 0.64,
                     self_rows: bool = False):
        """Shared row-block driver for self/cross core-acc kNN; row_stack is
        (nk, nrows, W2) u32. a_sig/b_sig_dev add the inverted-index
        prefilter mask (precluster mode). c1_rows/c2_dev apply the MAG
        completeness correction on device, inside the tile's f32 chain.
        self_rows marks row_stack as a [row_base:row_base+nrows] view of
        the reference stack, so row blocks slice the device-resident copy
        instead of re-uploading."""
        if nrows == 0:  # empty multi-process row slice
            return SparseKnnRows(
                np.zeros((0, knn), np.int32),
                np.zeros((0, knn, 2), np.float32),
                None,
            )
        kmers = tuple(self.ms.kmer_lengths)
        masked = a_sig is not None
        comp = c1_rows is not None
        dummy = self._dummy_sig
        b_stack = self._stack()
        pending = []
        for r0 in range(0, nrows, self.row_tile):
            r1 = min(r0 + self.row_tile, nrows)
            sig_blk = (
                a_sig[r0:r1].astype(np.int32) if masked else dummy
            )
            core, acc, idx = _knn_scan_block_ca(
                (
                    b_stack[:, row_base + r0 : row_base + r1, :]
                    if self_rows
                    else jnp.asarray(np.asarray(row_stack)[:, r0:r1, :])
                ),
                b_stack,
                np.int32(row_base + r0),
                np.int32(self.n),
                sig_blk,
                b_sig_dev if masked else dummy,
                s64=self.s64,
                kmers=kmers,
                sketch_size=self.ms.sketch_size,
                knn=knn,
                tc=self.col_tile,
                exclude_self=exclude_self,
                masked=masked,
                c1=(
                    jnp.asarray(c1_rows[r0:r1].astype(np.float32))
                    if comp
                    else None
                ),
                c2=c2_dev if comp else None,
                cutoff=cutoff,
            )
            pending.append((r0, r1, core, acc, idx))
        cores, accs, idxs = [], [], []
        for r0, r1, core, acc, idx in pending:
            cores.append(np.asarray(core)[: r1 - r0])
            accs.append(np.asarray(acc)[: r1 - r0])
            idxs.append(np.asarray(idx)[: r1 - r0])
        idx_all = np.concatenate(idxs)
        core_all = np.concatenate(cores)
        acc_all = np.concatenate(accs)
        core_all, acc_all, idx_all = self._exact_ca_values(
            idx_all, core_all, acc_all, row_stack, row_base, self_rows,
            c1_rows, c2_host, cutoff,
        )
        return SparseKnnRows(
            idx_all,
            np.stack([core_all, acc_all], axis=-1).astype(np.float32),
            None,
        )

    def _exact_ca_values(self, idx, core_f32, acc_f32, row_stack, row_base,
                         self_rows, c1_rows, c2_host, cutoff):
        b_stack = self._stack()
        if self_rows:
            a_stack = b_stack
            a_rows = row_base + np.arange(idx.shape[0], dtype=np.int32)
        else:
            a_stack = jax.device_put(
                np.ascontiguousarray(np.asarray(row_stack)).view(np.uint32)
            )
            a_rows = np.arange(idx.shape[0], dtype=np.int32)
        return exact_ca_values(
            self.ms, self.s64, idx, core_f32, acc_f32, a_stack, b_stack,
            a_rows, c1_rows, c2_host, cutoff,
        )

    def _comp_cols_dev(self, comp: np.ndarray):
        """Column completeness padded to the b-stack's column count."""
        c = np.asarray(comp, dtype=np.float32)
        pad = (-c.size) % self.col_tile
        if pad:
            c = np.pad(c, (0, pad), constant_values=1.0)
        return jax.device_put(c)

    def self_knn_coreacc(self, knn: int, row_range: slice | None = None,
                         completeness_vec=None,
                         completeness_cutoff: float = 0.64):
        a_host = self._stack_host()[:, : self.n, :]
        base = 0
        comp = (
            np.asarray(completeness_vec, dtype=np.float32)
            if completeness_vec is not None
            else None
        )
        c1_rows = comp
        if row_range is not None:
            a_host = a_host[:, row_range, :]
            base = row_range.start
            if comp is not None:
                c1_rows = comp[row_range]
        return self._knn_coreacc(
            a_host, a_host.shape[1], knn, exclude_self=True, row_base=base,
            c1_rows=c1_rows,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            c2_host=comp,
            cutoff=completeness_cutoff,
            self_rows=True,
        )

    def cross_knn_coreacc(self, query_ms, knn: int,
                          ref_completeness_vec=None,
                          query_completeness_vec=None,
                          completeness_cutoff: float = 0.64):
        kmers = tuple(self.ms.kmer_lengths)
        nq = query_ms.number_samples_loaded()
        nk = len(kmers)
        w = self.ms.kmer_stride
        qmat = query_ms.sketch_bins.reshape(nq, nk, w)
        qstack = np.ascontiguousarray(qmat.transpose(1, 0, 2)).view(np.uint32)
        # the correction formula is symmetric in (c1, c2); rows are queries.
        # Like the reference (jaccard.rs:36-42), correction applies only
        # when BOTH sides have completeness values.
        c1 = c2d = c2h = None
        if (
            ref_completeness_vec is not None
            and query_completeness_vec is not None
        ):
            c1 = np.asarray(query_completeness_vec, dtype=np.float32)
            c2h = np.asarray(ref_completeness_vec, dtype=np.float32)
            c2d = self._comp_cols_dev(c2h)
        return self._knn_coreacc(
            qstack, nq, knn, exclude_self=False,
            c1_rows=c1, c2_dev=c2d, c2_host=c2h, cutoff=completeness_cutoff,
        )

    # --- precluster scan primitives (see PreclusterKnnMixin) ---

    def _pc_sig_dev(self, signs: np.ndarray):
        return jax.device_put(
            _pad_rows(signs.astype(np.int32), self.col_tile)
        )

    def _pc_scan(self, dist_type, lo, hi, signs, knn, comp, cutoff):
        sig_dev = self._pc_sig_dev(signs)
        b_dev = self._plane(dist_type.k_idx)
        a_mat = self._plane_host(dist_type.k_idx)
        return self._scan_rows(
            a_mat[lo:hi],
            b_dev,
            knn,
            exclude_self=True,
            a_sig=signs[lo:hi],
            b_sig_dev=sig_dev,
            row_base=lo,
            c1_rows=comp[lo:hi] if comp is not None else None,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            cutoff=cutoff,
            a_dev=b_dev,
        )

    def _pc_scan_subset(self, dist_type, rows, knn, comp, cutoff):
        a_mat = self._plane_host(dist_type.k_idx)
        sub = a_mat[rows]
        b_dev = self._plane(dist_type.k_idx)
        return self._scan_rows(
            sub,
            b_dev,
            knn,
            exclude_self=False,
            c1_rows=comp[rows] if comp is not None else None,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            cutoff=cutoff,
        )

    def _pc_ca(self, lo, hi, signs, knn, comp, cutoff):
        sig_dev = self._pc_sig_dev(signs)
        a_host = self._stack_host()[:, : self.n, :]
        return self._knn_coreacc(
            a_host[:, lo:hi, :],
            hi - lo,
            knn,
            exclude_self=True,
            row_base=lo,
            a_sig=signs[lo:hi],
            b_sig_dev=sig_dev,
            c1_rows=comp[lo:hi] if comp is not None else None,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            c2_host=comp,
            cutoff=cutoff,
            self_rows=True,
        )

    def _pc_ca_subset(self, rows, knn, comp, cutoff):
        a_host = self._stack_host()[:, : self.n, :]
        return self._knn_coreacc(
            a_host[:, rows, :],
            len(rows),
            knn,
            exclude_self=False,
            c1_rows=comp[rows] if comp is not None else None,
            c2_dev=self._comp_cols_dev(comp) if comp is not None else None,
            c2_host=comp,
            cutoff=cutoff,
        )
