"""Distance drivers: dense all-vs-all, sparse kNN, self and cross modes.

Host (NumPy) execution with exact reference numerics; the device backend
(jaccard_jax.py) plugs in as a samebits engine via the `engine` argument and
is used automatically for large workloads by the CLI.

Mirrors /root/reference/src/distances/mod.rs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .jaccard_np import (
    ani_pois,
    core_acc_from_jaccards,
    jaccard_from_samebits,
    samebits_matrix,
)

_ROW_CHUNK = 256


@dataclass
class DistType:
    """Jaccard-at-one-k (optionally ANI) or multi-k core/accessory."""

    k_idx: int | None = None  # None => CoreAcc
    k: float = 0.0
    ani: bool = False

    @property
    def coreacc(self) -> bool:
        return self.k_idx is None

    def describe(self) -> str:
        if self.coreacc:
            return "Distances: core/accessory regression"
        k = int(self.k)
        if self.ani:
            return f"Distances: ANI at k={k}"
        return f"Distances: Jaccard distances at k={k}"


def set_k(ms, kmer: int | None, ani: bool) -> DistType:
    if kmer is None:
        return DistType()
    k_idx = ms.get_k_idx(kmer)
    if k_idx is None:
        raise ValueError(f"K-mer size {kmer} not found in file")
    return DistType(k_idx=k_idx, k=float(kmer), ani=ani)


def _default_engine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return samebits_matrix(a, b)


def _usig_matrix(ms, k_idx: int) -> np.ndarray:
    return np.ascontiguousarray(ms.bins_matrix(k_idx))


def self_dists_all(
    ms,
    dist_type: DistType,
    completeness_vec=None,
    completeness_cutoff: float = 0.64,
    engine=None,
    row_range: slice | None = None,
) -> np.ndarray:
    """Dense self distances, upper-triangle row-major.

    Returns (n_pairs,) f32 for Jaccard/ANI or (n_pairs, 2) f32 for core-acc.
    row_range restricts to rows [lo, hi) x all columns j > i (the
    multi-process shard of the long-form output; concatenating ranks in
    order reproduces the full file).
    """
    engine = engine or _default_engine
    n = ms.number_samples_loaded()
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    s64 = ms.sketchsize64
    comp = (
        np.asarray(completeness_vec, dtype=np.float64)
        if completeness_vec is not None
        else None
    )

    out_parts = []
    if dist_type.coreacc:
        k_mats = [_usig_matrix(ms, ki) for ki in range(len(ms.kmer_lengths))]
    else:
        # hoisted: _usig_matrix copies the full (n, stride) column slice
        mat = _usig_matrix(ms, dist_type.k_idx)
    for i0 in range(lo, hi, _ROW_CHUNK):
        i1 = min(i0 + _ROW_CHUNK, hi)
        rows = np.arange(i0, i1)
        # upper-triangle pair indices for this row block
        ii, jj = np.nonzero(
            rows[:, None] < np.arange(n)[None, :]
        )  # local row idx, global col idx
        gi = rows[ii]
        if not dist_type.coreacc:
            sb = engine(mat[rows], mat)
            sb = sb[ii, jj]
            c1 = comp[gi] if comp is not None else None
            c2 = comp[jj] if comp is not None else None
            j = jaccard_from_samebits(sb, s64, c1, c2, completeness_cutoff)
            if dist_type.ani:
                d = ani_pois(j, dist_type.k).astype(np.float32)
            else:
                d = (1.0 - j).astype(np.float32)
            out_parts.append(d)
        else:
            jaccs = np.empty((gi.size, len(ms.kmer_lengths)))
            c1 = comp[gi] if comp is not None else None
            c2 = comp[jj] if comp is not None else None
            for ki in range(len(ms.kmer_lengths)):
                sb = engine(k_mats[ki][rows], k_mats[ki])[ii, jj]
                jaccs[:, ki] = jaccard_from_samebits(
                    sb, s64, c1, c2, completeness_cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, ms.kmer_lengths, ms.sketch_size
            )
            out_parts.append(np.stack([core, acc], axis=1))
    if not out_parts:
        return np.zeros((0, 2) if dist_type.coreacc else 0, dtype=np.float32)
    return np.concatenate(out_parts)


def cross_dists_all(
    ref_ms,
    query_ms,
    dist_type: DistType,
    ref_completeness_vec=None,
    query_completeness_vec=None,
    completeness_cutoff: float = 0.64,
    engine=None,
    row_range: slice | None = None,
) -> np.ndarray:
    """Dense cross distances, ref-major rectangle (n_ref * n_query).
    row_range restricts to a block of reference rows (multi-process)."""
    engine = engine or _default_engine
    n = ref_ms.number_samples_loaded()
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    nq = query_ms.number_samples_loaded()
    s64 = ref_ms.sketchsize64
    rcomp = (
        np.asarray(ref_completeness_vec, dtype=np.float64)
        if ref_completeness_vec is not None
        else None
    )
    qcomp = (
        np.asarray(query_completeness_vec, dtype=np.float64)
        if query_completeness_vec is not None
        else None
    )

    out_parts = []
    # hoisted: _usig_matrix copies the full column slice per call
    if dist_type.coreacc:
        r_mats = [
            _usig_matrix(ref_ms, ki) for ki in range(len(ref_ms.kmer_lengths))
        ]
        q_mats = [
            _usig_matrix(query_ms, ki)
            for ki in range(len(ref_ms.kmer_lengths))
        ]
    else:
        r_mat = _usig_matrix(ref_ms, dist_type.k_idx)
        q_mat = _usig_matrix(query_ms, dist_type.k_idx)
    for i0 in range(lo, hi, _ROW_CHUNK):
        i1 = min(i0 + _ROW_CHUNK, hi)
        rows = np.arange(i0, i1)
        gi = np.repeat(rows, nq)
        gj = np.tile(np.arange(nq), rows.size)
        c1 = rcomp[gi] if rcomp is not None else None
        c2 = qcomp[gj] if qcomp is not None else None
        if not dist_type.coreacc:
            sb = engine(r_mat[rows], q_mat).reshape(-1)
            j = jaccard_from_samebits(sb, s64, c1, c2, completeness_cutoff)
            if dist_type.ani:
                out_parts.append(ani_pois(j, dist_type.k).astype(np.float32))
            else:
                out_parts.append((1.0 - j).astype(np.float32))
        else:
            jaccs = np.empty((gi.size, len(ref_ms.kmer_lengths)))
            for ki in range(len(ref_ms.kmer_lengths)):
                sb = engine(r_mats[ki][rows], q_mats[ki]).reshape(-1)
                jaccs[:, ki] = jaccard_from_samebits(
                    sb, s64, c1, c2, completeness_cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, ref_ms.kmer_lengths, ref_ms.sketch_size
            )
            out_parts.append(np.stack([core, acc], axis=1))
    if not out_parts:
        return np.zeros((0, 2) if dist_type.coreacc else 0, dtype=np.float32)
    return np.concatenate(out_parts)


def _knn_select(dists: np.ndarray, knn: int, exclude: int | None):
    """Indices of the knn smallest f32 distances with reference heap
    semantics: membership ties at the boundary go to the lowest index, and
    results are ordered ascending by (distance, index)."""
    d = dists.astype(np.float32).copy()
    if exclude is not None:
        d[exclude] = np.inf
    order = np.argsort(d, kind="stable")[:knn]
    if exclude is not None:
        order = order[np.isfinite(d[order])]
    return order


def self_dists_knn(
    ms,
    knn: int,
    dist_type: DistType,
    completeness_vec=None,
    completeness_cutoff: float = 0.64,
    engine=None,
    row_range: slice | None = None,
):
    """Sparse kNN self distances. Returns a list of per-row item lists
    matching output.write_sparse (rows [lo, hi) when row_range is set;
    neighbours always range over all samples)."""
    engine = engine or _default_engine
    n = ms.number_samples_loaded()
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    s64 = ms.sketchsize64
    comp = (
        np.asarray(completeness_vec, dtype=np.float64)
        if completeness_vec is not None
        else None
    )
    rows_out = []
    if dist_type.coreacc:
        k_mats = [_usig_matrix(ms, ki) for ki in range(len(ms.kmer_lengths))]
    else:
        mat = _usig_matrix(ms, dist_type.k_idx)
    for i0 in range(lo, hi, _ROW_CHUNK):
        i1 = min(i0 + _ROW_CHUNK, hi)
        rows = np.arange(i0, i1)
        if not dist_type.coreacc:
            sb = engine(mat[rows], mat)  # (chunk, n)
            for li, i in enumerate(rows):
                c1 = np.full(n, comp[i]) if comp is not None else None
                c2 = comp if comp is not None else None
                j = jaccard_from_samebits(
                    sb[li], s64, c1, c2, completeness_cutoff
                )
                if dist_type.ani:
                    d = (1.0 - ani_pois(j, dist_type.k)).astype(np.float32)
                else:
                    d = (1.0 - j).astype(np.float32)
                sel = _knn_select(d, knn, exclude=int(i))
                if dist_type.ani:
                    rows_out.append(
                        [(int(jx), np.float32(1.0) - d[jx]) for jx in sel]
                    )
                else:
                    rows_out.append([(int(jx), d[jx]) for jx in sel])
        else:
            jaccs = np.empty((rows.size * n, len(ms.kmer_lengths)))
            for ki in range(len(ms.kmer_lengths)):
                sbk = engine(k_mats[ki][rows], k_mats[ki]).reshape(-1)
                gi = np.repeat(rows, n)
                gj = np.tile(np.arange(n), rows.size)
                c1 = comp[gi] if comp is not None else None
                c2 = comp[gj] if comp is not None else None
                jaccs[:, ki] = jaccard_from_samebits(
                    sbk, s64, c1, c2, completeness_cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, ms.kmer_lengths, ms.sketch_size
            )
            core = core.reshape(rows.size, n)
            acc = acc.reshape(rows.size, n)
            for li, i in enumerate(rows):
                sel = _knn_select(core[li], knn, exclude=int(i))
                rows_out.append(
                    [(int(jx), core[li, jx], acc[li, jx]) for jx in sel]
                )
    return rows_out


def ski_skd_maps(ms, inverted):
    """Name-based index maps between a loaded .skd and a .ski
    (distances/mod.rs:413-438). Returns (skq_index_lookup, skd_index_from_ski):
    the forward map gives each skd sample's ski position (every skd sample
    must exist in the ski, like the reference); the reverse map covers
    every SKI sample, with -1 for samples the .skd lacks."""
    skq_lookup = {name: i for i, name in enumerate(inverted.sample_names)}
    skq_index_lookup = []
    not_found = []
    for skd_idx in range(ms.number_samples_loaded()):
        name = ms.sketch_name(skd_idx)
        if name in skq_lookup:
            skq_index_lookup.append(skq_lookup[name])
        else:
            not_found.append(name)
    if not_found:
        raise ValueError(
            "The following samples in the .skd could not be found in the "
            f".ski:\n{not_found!r}"
        )
    skd_index_from_ski = np.full(len(inverted.sample_names), -1, np.int64)
    for skd_idx, ski_idx in enumerate(skq_index_lookup):
        skd_index_from_ski[ski_idx] = skd_idx
    return skq_index_lookup, skd_index_from_ski


def self_dists_knn_precluster(
    ms,
    inverted,
    skq_bins: np.ndarray,
    skq_stride: int,
    knn: int,
    dist_type: DistType,
    completeness_vec=None,
    completeness_cutoff: float = 0.64,
    retain_unmatched: str | None = None,
    engine=None,
    row_range: slice | None = None,
):
    """kNN with inverted-index prefiltering (distances/mod.rs:399-553).

    retain_unmatched: None | "singleton" | "bruteforce".
    row_range restricts to a block of rows (multi-process sharding).

    Core/accessory mode (dist_type.coreacc) is an extension: the reference
    leaves it `unimplemented!` (distances/mod.rs:548-550). Candidates come
    from the inverted index's single-k prefilter; distances are the multi-k
    core/accessory regression over every k in the .skd, with neighbours
    ranked by core distance. Rows keep only their real candidates (no
    (row, 1.0) padding entries — the sparse core/acc printer never skips).
    """
    engine = engine or _default_engine
    n = ms.number_samples_loaded()
    s64 = ms.sketchsize64
    comp = (
        np.asarray(completeness_vec, dtype=np.float64)
        if completeness_vec is not None
        else None
    )
    # name-based index mappings between the .skd and .ski orderings.
    # The reverse map covers EVERY ski sample, with -1 marking samples the
    # .skd lacks (the reference sizes its reverse vec by the .skd count,
    # distances/mod.rs:435-438, and panics / silently maps such candidates
    # to sample 0 — the device path here already skips them, so the host
    # path matches it)
    skq_index_lookup, skd_index_from_ski = ski_skd_maps(ms, inverted)

    if dist_type.coreacc:
        k_mats = [_usig_matrix(ms, ki) for ki in range(len(ms.kmer_lengths))]
    else:
        mat = _usig_matrix(ms, dist_type.k_idx)
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
    rows_out = []
    for i in range(lo, hi):
        ski_i = skq_index_lookup[i]
        flat_i = skq_bins[ski_i * skq_stride : (ski_i + 1) * skq_stride]
        candidates = inverted.any_shared_bins(flat_i)
        candidates = candidates[candidates != ski_i]
        skd_js = skd_index_from_ski[candidates]
        skd_js = skd_js[skd_js >= 0]  # .ski samples absent from the .skd

        if dist_type.coreacc:

            def _ca_for(js: np.ndarray):
                jaccs = np.empty((js.size, len(k_mats)))
                c1 = np.full(js.size, comp[i]) if comp is not None else None
                c2 = comp[js] if comp is not None else None
                for ki in range(len(k_mats)):
                    sbk = engine(
                        k_mats[ki][i : i + 1], k_mats[ki][js]
                    ).reshape(-1)
                    jaccs[:, ki] = jaccard_from_samebits(
                        sbk, s64, c1, c2, completeness_cutoff
                    )
                return core_acc_from_jaccards(
                    jaccs, ms.kmer_lengths, ms.sketch_size
                )

            ca_items: list[tuple] = []
            if skd_js.size:
                core, acc = _ca_for(skd_js)
                order = np.argsort(core, kind="stable")[:knn]
                ca_items = [
                    (int(skd_js[x]), core[x], acc[x]) for x in order
                ]
            if not ca_items:
                if retain_unmatched == "singleton":
                    rows_out.append(
                        [(i, np.float32(0.0), np.float32(0.0))]
                    )
                    continue
                if retain_unmatched == "bruteforce":
                    js = np.array(
                        [j for j in range(n) if j != i], dtype=np.int64
                    )
                    core, acc = _ca_for(js)
                    order = np.argsort(core, kind="stable")[:knn]
                    ca_items = [
                        (int(js[x]), core[x], acc[x]) for x in order
                    ]
            rows_out.append(ca_items)
            continue

        def _dists_for(js: np.ndarray) -> np.ndarray:
            sb = engine(mat[i : i + 1], mat[js]).reshape(-1)
            c1 = np.full(js.size, comp[i]) if comp is not None else None
            c2 = comp[js] if comp is not None else None
            j_idx = jaccard_from_samebits(sb, s64, c1, c2, completeness_cutoff)
            if dist_type.ani:
                return (1.0 - ani_pois(j_idx, dist_type.k)).astype(np.float32)
            return (1.0 - j_idx).astype(np.float32)

        items: list[tuple[int, np.float32]] = []
        if skd_js.size:
            d = _dists_for(skd_js)
            order = np.argsort(d, kind="stable")[:knn]
            items = [(int(skd_js[x]), d[x]) for x in order]

        if not items:
            if retain_unmatched == "singleton":
                row = [(i, np.float32(0.0))] + [(i, np.float32(1.0))] * (knn - 1)
                rows_out.append(row)
                continue
            if retain_unmatched == "bruteforce":
                js = np.array(
                    [j for j in range(n) if j != i], dtype=np.int64
                )
                d = _dists_for(js)
                order = np.argsort(d, kind="stable")[:knn]
                items = [(int(js[x]), d[x]) for x in order]

        if dist_type.ani:
            items = [(j, np.float32(1.0) - d) for j, d in items]
        if len(items) < knn:
            items += [(i, np.float32(1.0))] * (knn - len(items))
        rows_out.append(items)
    return rows_out


def cross_dists_knn(
    ref_ms,
    query_ms,
    knn: int,
    dist_type: DistType,
    ref_completeness_vec=None,
    query_completeness_vec=None,
    completeness_cutoff: float = 0.64,
    engine=None,
    row_range: slice | None = None,
):
    """Sparse kNN cross distances: one row per query, neighbours are refs.
    row_range restricts to a block of query rows (multi-process)."""
    engine = engine or _default_engine
    n = ref_ms.number_samples_loaded()
    nq = query_ms.number_samples_loaded()
    if n == 0:
        raise ValueError("Reference database has no loaded samples")
    if nq == 0:
        raise ValueError("Query database has no loaded samples")
    knn = min(knn, n)
    s64 = ref_ms.sketchsize64
    rcomp = (
        np.asarray(ref_completeness_vec, dtype=np.float64)
        if ref_completeness_vec is not None
        else None
    )
    qcomp = (
        np.asarray(query_completeness_vec, dtype=np.float64)
        if query_completeness_vec is not None
        else None
    )
    lo, hi = (row_range.start, row_range.stop) if row_range else (0, nq)
    rows_out = []
    if dist_type.coreacc:
        q_mats = [
            _usig_matrix(query_ms, ki)
            for ki in range(len(ref_ms.kmer_lengths))
        ]
        r_mats = [
            _usig_matrix(ref_ms, ki) for ki in range(len(ref_ms.kmer_lengths))
        ]
    else:
        q_mat = _usig_matrix(query_ms, dist_type.k_idx)
        r_mat = _usig_matrix(ref_ms, dist_type.k_idx)
    for q0 in range(lo, hi, _ROW_CHUNK):
        q1 = min(q0 + _ROW_CHUNK, hi)
        qrows = np.arange(q0, q1)
        if not dist_type.coreacc:
            sb = engine(q_mat[qrows], r_mat)
            for lq, qi in enumerate(qrows):
                c1 = np.full(n, qcomp[qi]) if qcomp is not None else None
                c2 = rcomp if rcomp is not None else None
                j = jaccard_from_samebits(
                    sb[lq], s64, c1, c2, completeness_cutoff
                )
                if dist_type.ani:
                    d = (1.0 - ani_pois(j, dist_type.k)).astype(np.float32)
                else:
                    d = (1.0 - j).astype(np.float32)
                sel = _knn_select(d, knn, exclude=None)
                if dist_type.ani:
                    rows_out.append(
                        [(int(rx), np.float32(1.0) - d[rx]) for rx in sel]
                    )
                else:
                    rows_out.append([(int(rx), d[rx]) for rx in sel])
        else:
            jaccs = np.empty((qrows.size * n, len(ref_ms.kmer_lengths)))
            for ki in range(len(ref_ms.kmer_lengths)):
                sbk = engine(q_mats[ki][qrows], r_mats[ki]).reshape(-1)
                gq = np.repeat(qrows, n)
                gr = np.tile(np.arange(n), qrows.size)
                c1 = rcomp[gr] if rcomp is not None else None
                c2 = qcomp[gq] if qcomp is not None else None
                jaccs[:, ki] = jaccard_from_samebits(
                    sbk, s64, c1, c2, completeness_cutoff
                )
            core, acc = core_acc_from_jaccards(
                jaccs, ref_ms.kmer_lengths, ref_ms.sketch_size
            )
            core = core.reshape(qrows.size, n)
            acc = acc.reshape(qrows.size, n)
            for lq in range(qrows.size):
                sel = _knn_select(core[lq], knn, exclude=None)
                rows_out.append(
                    [(int(rx), core[lq, rx], acc[lq, rx]) for rx in sel]
                )
    return rows_out
