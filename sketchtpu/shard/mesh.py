"""Multi-chip sharding of the distance computation.

Design (the scaling-book recipe applied to sketch comparison):

- The sketch database is sharded by sample ("rows" axis = the data-parallel
  analogue): each device holds an equal block of reference sketches.
- Optionally the sketch word dimension is sharded too ("words" axis = the
  tensor-parallel analogue): each device computes partial samebits over its
  plane-word slice and a psum over the words axis yields exact counts.
  Useful when sketches are very large (s >= 100k bins).
- Query blocks are broadcast (all-gather on the rows axis); each device
  emits its (rows_shard x query) tile of the distance matrix. Collectives
  run over the device interconnect (NVLink between the cards of one host);
  the host only sees the reduced per-tile outputs.

Single-host multi-chip uses one jax.sharding.Mesh; multi-host extends the
same mesh over jax.distributed processes (same code path — the mesh simply
spans more devices).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import BBITS
from ..dist.jaccard_jax import _samebits_tile
from ..dist.knn_jax import PreclusterKnnMixin


def make_mesh(n_rows: int | None = None, n_words: int = 1) -> Mesh:
    """Mesh over THIS PROCESS's devices: ('rows', 'words').

    Local (not global) devices on purpose: under jax.distributed the CLI
    row-shards the work per process (shard/distributed.py), so each rank
    computes its own row block on its own chips — a global mesh would put
    rank-local arrays onto non-addressable devices and fail at collect."""
    devices = np.array(jax.local_devices())
    if n_rows is None:
        n_rows = devices.size // n_words
    devices = devices[: n_rows * n_words].reshape(n_rows, n_words)
    return Mesh(devices, ("rows", "words"))


@functools.partial(jax.jit, static_argnames=("s64", "mesh"))
def _sharded_samebits(a, b, s64: int, mesh: Mesh):
    """a: (na, W2) row-sharded + word-sharded; b: (nb, W2) word-sharded,
    replicated over rows. Returns (na, nb) int32, row-sharded."""

    def tile_fn(a_blk, b_blk):
        # a_blk: (na/rows, W2/words); b_blk: (nb, W2/words)
        partial = _samebits_tile(a_blk, b_blk, s64 // mesh.shape["words"])
        return jax.lax.psum(partial, "words")

    from jax import shard_map

    return shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P("rows", "words"), P(None, "words")),
        out_specs=P("rows", None),
    )(a, b)


def sharded_coreacc_step(a_stack, b_stack, s64: int, mesh: Mesh,
                         kmers: tuple[int, ...], sketch_size: int,
                         c1=None, c2=None, cutoff: float = 0.64):
    """Full multi-k core/accessory distances over a mesh.

    a_stack: (nk, na, W2) u32, sample axis sharded over 'rows' and the word
    axis over 'words'; b_stack: (nk, nb, W2) u32, word-sharded, replicated
    over rows. Per-k samebits partials psum over 'words' (exact int32
    counts cross the interconnect), then each device runs the regression
    chain for its row block. Returns (na, nb, 2) f32, row-sharded.

    c1 (na,) / c2 (nb,) f32 apply the completeness correction — c1 shards
    with the rows, c2 replicates; the correction runs after the psum so it
    sees whole samebits."""
    from jax import shard_map

    from ..dist.coreacc_jax import coreacc_tile

    if c1 is not None:

        def tile_fn_c(a_blk, b_blk, c1_blk, c2_all):
            return coreacc_tile(
                a_blk, b_blk, s64, kmers, sketch_size, axis_name="words",
                c1=c1_blk, c2=c2_all, cutoff=cutoff,
            )

        return shard_map(
            tile_fn_c,
            mesh=mesh,
            in_specs=(
                P(None, "rows", "words"),
                P(None, None, "words"),
                P("rows"),
                P(None),
            ),
            out_specs=P("rows", None, None),
        )(a_stack, b_stack, c1, c2)

    def tile_fn(a_blk, b_blk):
        # psum over a size-1 axis is a no-op; always reducing keeps the
        # output's replication over 'words' statically inferable.
        return coreacc_tile(
            a_blk, b_blk, s64, kmers, sketch_size, axis_name="words"
        )

    return shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(None, "rows", "words"), P(None, None, "words")),
        out_specs=P("rows", None, None),
    )(a_stack, b_stack)


def sharded_knn_step(a, b, s64: int, mesh: Mesh, knn: int, n_real: int,
                     exclude_self: bool, col_tile: int = 2048,
                     row_base: int = 0, c1=None, c2=None,
                     cutoff: float = 0.64, a_sig=None, b_sig=None):
    """Sparse kNN selection over a mesh: rows sharded, columns streamed.

    a: (na, W2) u32 row-sharded (na % mesh rows == 0); b: (nbp, W2) u32
    replicated (nbp % col_tile == 0). Each device scans the full column
    range for its row block and keeps a running top-k; only (rows x knn)
    samebits + global column indices leave the devices (row-sharded).
    The word axis must be unsharded (selection needs whole samebits).
    c1 (na,) / c2 (nbp,) f32 switch selection to the completeness-
    corrected f32 Jaccard (c1 shards with the rows). a_sig (na, S) /
    b_sig (nbp, S) i32 inverted-index signs switch on the precluster
    prefilter mask (a_sig shards with the rows, b_sig replicates)."""
    from jax import shard_map

    from ..dist.knn_jax import (
        _knn_scan_block, _knn_scan_block_comp, _knn_scan_block_packed,
        _pack_shift,
    )

    if mesh.shape["words"] != 1:
        raise ValueError("sharded kNN requires an unsharded word axis")
    rows = mesh.shape["rows"]
    rows_per = a.shape[0] // rows
    tc = min(col_tile, b.shape[0])
    comp = c1 is not None
    masked = a_sig is not None
    # packed-key scan (samebits<<shift | ~col in one int32): one top_k and
    # no index gathers; valid whenever the column count fits the key's
    # column field
    packed_ok = not comp and b.shape[0] <= (1 << _pack_shift(s64)) - 1

    def shard_fn(a_blk, b_blk, c1_blk, c2_all, sig_blk, bsig_all):
        row0 = jnp.int32(row_base) + jax.lax.axis_index("rows").astype(
            jnp.int32
        ) * jnp.int32(rows_per)
        if comp:
            return _knn_scan_block_comp(
                a_blk,
                b_blk,
                row0,
                jnp.int32(n_real),
                sig_blk,
                bsig_all,
                c1_blk,
                c2_all,
                s64=s64,
                knn=knn,
                tc=tc,
                exclude_self=exclude_self,
                masked=masked,
                cutoff=cutoff,
            )
        if packed_ok:
            return _knn_scan_block_packed(
                a_blk,
                b_blk,
                row0,
                jnp.int32(n_real),
                s64=s64,
                knn=knn,
                tc=tc,
                exclude_self=exclude_self,
                a_sig=sig_blk if masked else None,
                b_sig=bsig_all if masked else None,
                masked=masked,
            )
        return _knn_scan_block(
            a_blk,
            b_blk,
            row0,
            jnp.int32(n_real),
            sig_blk,
            bsig_all,
            s64=s64,
            knn=knn,
            tc=tc,
            exclude_self=exclude_self,
            masked=masked,
        )

    if not comp:
        c1 = jnp.zeros(a.shape[0], jnp.float32)
        c2 = jnp.zeros(b.shape[0], jnp.float32)
    if not masked:
        a_sig = np.zeros((a.shape[0], 1), np.int32)
        b_sig = np.zeros((b.shape[0], 1), np.int32)
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("rows", None), P(None, None), P("rows"), P(None),
                  P("rows", None), P(None, None)),
        out_specs=(P("rows", None), P("rows", None)),
    )(a, b, jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(a_sig),
      jnp.asarray(b_sig))


def sharded_knn_ca_step(a_stack, b_stack, s64: int, mesh: Mesh, knn: int,
                        n_real: int, exclude_self: bool,
                        kmers: tuple[int, ...], sketch_size: int,
                        col_tile: int = 2048, row_base: int = 0,
                        c1=None, c2=None, cutoff: float = 0.64,
                        a_sig=None, b_sig=None):
    """Sharded multi-k core/accessory kNN: rows shard over 'rows', the
    (nk, nbp, W2) column stack replicates; each device keeps a running
    top-k by core distance over streamed column tiles. Returns
    (core, acc, idx) each (na, knn), row-sharded. c1 (na,) / c2 (nbp,)
    f32 apply the completeness correction (c1 shards with the rows).
    a_sig (na, S) / b_sig (nbp, S) i32 inverted-index signs switch on the
    precluster prefilter mask (a_sig shards with the rows)."""
    from jax import shard_map

    from ..dist.knn_jax import _knn_scan_block_ca

    if mesh.shape["words"] != 1:
        raise ValueError("sharded kNN requires an unsharded word axis")
    rows = mesh.shape["rows"]
    rows_per = a_stack.shape[1] // rows
    tc = min(col_tile, b_stack.shape[1])
    comp = c1 is not None
    masked = a_sig is not None

    def shard_fn(a_blk, b_blk, c1_blk, c2_all, sig_blk, bsig_all):
        row0 = jnp.int32(row_base) + jax.lax.axis_index("rows").astype(
            jnp.int32
        ) * jnp.int32(rows_per)
        return _knn_scan_block_ca(
            a_blk,
            b_blk,
            row0,
            jnp.int32(n_real),
            sig_blk,
            bsig_all,
            s64=s64,
            kmers=kmers,
            sketch_size=sketch_size,
            knn=knn,
            tc=tc,
            exclude_self=exclude_self,
            masked=masked,
            c1=c1_blk if comp else None,
            c2=c2_all if comp else None,
            cutoff=cutoff,
        )

    if not comp:
        c1 = jnp.zeros(a_stack.shape[1], jnp.float32)
        c2 = jnp.zeros(b_stack.shape[1], jnp.float32)
    if not masked:
        a_sig = np.zeros((a_stack.shape[1], 1), np.int32)
        b_sig = np.zeros((b_stack.shape[1], 1), np.int32)
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, "rows", None), P(None, None, None), P("rows"),
                  P(None), P("rows", None), P(None, None)),
        out_specs=(P("rows", None), P("rows", None), P("rows", None)),
    )(a_stack, b_stack, jnp.asarray(c1), jnp.asarray(c2),
      jnp.asarray(a_sig), jnp.asarray(b_sig))


class ShardedSamebitsEngine:
    """samebits engine distributing row blocks over all devices in a mesh.

    Drop-in `engine` for dist/api.py drivers (host numpy in/out); large
    inputs stay resident on device across calls via a simple cache.
    """

    def __init__(self, sketchsize64: int, mesh: Mesh | None = None):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.s64 = sketchsize64
        self.mesh = mesh or make_mesh()
        self._cache: dict = {}

    def _rows(self) -> int:
        return self.mesh.shape["rows"]

    def _words(self) -> int:
        return self.mesh.shape["words"]

    def _pad_rows(self, mat: np.ndarray, mult: int) -> np.ndarray:
        n = mat.shape[0]
        pad = (-n) % mult
        if pad:
            mat = np.pad(mat, ((0, pad), (0, 0)))
        return mat

    def put_a(self, a: np.ndarray):
        a32 = np.ascontiguousarray(a, dtype=np.uint64).view(np.uint32)
        a32 = self._pad_rows(a32, self._rows())
        sharding = NamedSharding(self.mesh, P("rows", "words"))
        return jax.device_put(a32, sharding)

    def put_b(self, b: np.ndarray):
        # the dist drivers stream row chunks against the SAME column
        # matrix; key the device copy on the array identity so it uploads
        # once instead of once per chunk
        key = (id(b), b.shape, b.dtype.str)
        cached = self._cache.get("b")
        if cached is not None and cached[0] == key:
            return cached[1]
        b32 = np.ascontiguousarray(b, dtype=np.uint64).view(np.uint32)
        sharding = NamedSharding(self.mesh, P(None, "words"))
        b_dev = jax.device_put(b32, sharding)
        self._cache["b"] = (key, b_dev)
        return b_dev

    def matrix(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        na = a.shape[0]
        a_dev = self.put_a(a)
        b_dev = self.put_b(b)
        out = _sharded_samebits(a_dev, b_dev, self.s64, self.mesh)
        return np.asarray(out)[:na]


class ShardedCoreAccEngine:
    """Dense multi-k core/accessory engine over a whole device mesh.

    Same tile_dists/stream_self_dense interface as
    dist.coreacc_jax.DeviceCoreAccEngine (the CLI uses either
    interchangeably): rows of each tile shard over 'rows', sketch words
    over 'words' (per-k samebits partials psum-reduced), so one tile call
    engages every chip. Values match the single-device f32 engine exactly
    (the math is identical; only the partition differs).
    """

    def __init__(self, ms, mesh: Mesh | None = None, tile: int = 4096,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.ms = ms
        self.mesh = mesh or make_mesh()
        self.tile = tile
        self.s64 = ms.sketchsize64
        self.kmers = tuple(ms.kmer_lengths)
        self._comp = (
            np.asarray(completeness_vec, dtype=np.float32)
            if completeness_vec is not None
            else None
        )
        self._cutoff = float(completeness_cutoff)
        nk = len(self.kmers)
        n = ms.number_samples_loaded()
        w = ms.kmer_stride
        mat = ms.sketch_bins.reshape(n, nk, w)
        stack = np.ascontiguousarray(mat.transpose(1, 0, 2)).view(np.uint32)
        self._stack_host = stack
        self._b = jax.device_put(
            stack, NamedSharding(self.mesh, P(None, None, "words"))
        )

    def _rows_mult(self) -> int:
        return self.mesh.shape["rows"]

    def tile_dists(self, rows: slice, cols: slice) -> np.ndarray:
        a = self._stack_host[:, rows, :]
        na = a.shape[1]
        pad = (-na) % self._rows_mult()
        if pad:
            a = np.pad(a, ((0, 0), (0, pad), (0, 0)))
        a_dev = jax.device_put(
            a, NamedSharding(self.mesh, P(None, "rows", "words"))
        )
        b = self._b if cols == slice(0, self.ms.number_samples_loaded()) else (
            jax.device_put(
                self._stack_host[:, cols, :],
                NamedSharding(self.mesh, P(None, None, "words")),
            )
        )
        c1 = c2 = None
        if self._comp is not None:
            c1 = np.pad(
                self._comp[rows], (0, pad), constant_values=1.0
            ).astype(np.float32)
            c2 = self._comp[cols].astype(np.float32)
        out = sharded_coreacc_step(
            a_dev, b, self.s64, self.mesh, self.kmers, self.ms.sketch_size,
            c1=c1, c2=c2, cutoff=self._cutoff,
        )
        return np.asarray(out)[:na]

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular core/acc output over the mesh: ref row
        blocks shard over 'rows', the query stack replicates (word-sharded).
        Completeness applies only when both sides have values
        (jaccard.rs:36-42)."""
        from ..dist.output import _name_table, emit_coreacc_cross_block
        from .._native import get_lib

        n = len(ref_names)
        nq = query_ms.number_samples_loaded()
        nk = len(self.kmers)
        w = self.ms.kmer_stride
        qmat = query_ms.sketch_bins.reshape(nq, nk, w)
        q_stack = np.ascontiguousarray(qmat.transpose(1, 0, 2)).view(
            np.uint32
        )
        q_dev = jax.device_put(
            q_stack, NamedSharding(self.mesh, P(None, None, "words"))
        )
        comp_on = rcomp is not None and qcomp is not None
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        tab_r = _name_table(ref_names) if get_lib() is not None else None
        tab_q = _name_table(query_names) if tab_r is not None else None
        for r0 in range(lo, hi, self.tile):
            r1 = min(r0 + self.tile, hi)
            a = self._stack_host[:, r0:r1, :]
            na = r1 - r0
            pad = (-na) % self._rows_mult()
            if pad:
                a = np.pad(a, ((0, 0), (0, pad), (0, 0)))
            a_dev = jax.device_put(
                a, NamedSharding(self.mesh, P(None, "rows", "words"))
            )
            c1 = c2 = None
            if comp_on:
                c1 = np.pad(
                    np.asarray(rcomp, dtype=np.float32)[r0:r1], (0, pad),
                    constant_values=1.0,
                )
                c2 = np.asarray(qcomp, dtype=np.float32)
            block = np.asarray(
                sharded_coreacc_step(
                    a_dev, q_dev, self.s64, self.mesh, self.kmers,
                    self.ms.sketch_size, c1=c1, c2=c2, cutoff=cutoff,
                )
            )[:na]
            emit_coreacc_cross_block(
                out, ref_names, query_names, tab_r, tab_q, block, r0, r1, nq
            )

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        from ..dist.output import _name_table, emit_coreacc_self_block
        from .._native import get_lib

        n = len(names)
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        tab = _name_table(names) if get_lib() is not None else None
        for r0 in range(lo, hi, self.tile):
            r1 = min(r0 + self.tile, hi)
            block = self.tile_dists(slice(r0, r1), slice(0, n))
            emit_coreacc_self_block(out, names, tab, block, r0, r1, n)


class ShardedKnnEngine(PreclusterKnnMixin):
    """Sparse single-k kNN over a device mesh: rows shard over 'rows', all
    columns stream on every device; per-shard top-k results come back
    row-sharded. Same self_knn/cross_knn/precluster_knn interface as
    DeviceKnnEngine (the preclustered masked scan shards its rows over
    the mesh too, so the flagship 661k prefiltered workload engages every
    chip)."""

    def __init__(self, ms, mesh: Mesh | None = None, col_tile: int = 8192):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.ms = ms
        self.mesh = mesh or make_mesh(n_words=1)
        if self.mesh.shape["words"] != 1:
            raise ValueError("sharded kNN requires an unsharded word axis")
        self.col_tile = col_tile
        self.s64 = ms.sketchsize64
        self.n = ms.number_samples_loaded()

    def _mats(self, k_idx: int):
        mat = np.ascontiguousarray(self.ms.bins_matrix(k_idx)).view(np.uint32)
        padc = (-self.n) % self.col_tile
        b = np.pad(mat, ((0, padc), (0, 0))) if padc else mat
        return mat, b

    def _run(self, a_mat: np.ndarray, b_mat: np.ndarray, knn: int,
             exclude_self: bool, row_base: int = 0,
             c1_rows=None, c2_cols=None, cutoff: float = 0.64,
             a_sig=None, b_sig=None):
        rows_mult = self.mesh.shape["rows"]
        na = a_mat.shape[0]
        if na == 0:  # empty multi-process row slice
            return (np.zeros((0, knn), np.int32), np.zeros((0, knn), np.int32))
        pad = (-na) % rows_mult
        if pad:
            a_mat = np.pad(a_mat, ((0, pad), (0, 0)))
        c1 = c2 = None
        if c1_rows is not None:
            c1 = np.pad(
                np.asarray(c1_rows, dtype=np.float32), (0, pad),
                constant_values=1.0,
            )
            c2 = np.asarray(c2_cols, dtype=np.float32)
            padb = b_mat.shape[0] - c2.size
            if padb:
                c2 = np.pad(c2, (0, padb), constant_values=1.0)
        if a_sig is not None:
            # padded sign rows are discarded from the output; padded sign
            # COLUMNS never pass the cols < n_real validity check
            a_sig = np.pad(a_sig.astype(np.int32), ((0, pad), (0, 0)))
            b_sig = np.asarray(b_sig, dtype=np.int32)
            padb = b_mat.shape[0] - b_sig.shape[0]
            if padb:
                b_sig = np.pad(b_sig, ((0, padb), (0, 0)))
        a_dev = jax.device_put(a_mat, NamedSharding(self.mesh, P("rows", None)))
        b_dev = jax.device_put(b_mat, NamedSharding(self.mesh, P(None, None)))
        v, i = sharded_knn_step(
            a_dev, b_dev, self.s64, self.mesh, knn, n_real=self.n,
            exclude_self=exclude_self, col_tile=self.col_tile,
            row_base=row_base, c1=c1, c2=c2, cutoff=cutoff,
            a_sig=a_sig, b_sig=b_sig,
        )
        return np.asarray(v)[:na], np.asarray(i)[:na]

    def self_knn(self, knn: int, dist_type, row_range: slice | None = None,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        from ..dist.knn_jax import rows_from_samebits

        a_mat, b_mat = self._mats(dist_type.k_idx)
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
        sb, idx = self._run(
            a_mat, b_mat, knn, exclude_self=True, row_base=base,
            c1_rows=c1, c2_cols=comp, cutoff=completeness_cutoff,
        )
        return rows_from_samebits(
            sb, idx, dist_type, self.s64,
            c1_rows=c1, c2_all=comp, cutoff=completeness_cutoff,
        )

    def cross_knn(self, query_ms, knn: int, dist_type,
                  ref_completeness_vec=None, query_completeness_vec=None,
                  completeness_cutoff: float = 0.64):
        from ..dist.knn_jax import rows_from_samebits

        _, b_mat = self._mats(dist_type.k_idx)
        q = np.ascontiguousarray(query_ms.bins_matrix(dist_type.k_idx)).view(
            np.uint32
        )
        # correction only when BOTH sides have values (jaccard.rs:36-42)
        c1 = c2 = None
        if (
            ref_completeness_vec is not None
            and query_completeness_vec is not None
        ):
            c1 = np.asarray(query_completeness_vec, dtype=np.float64)
            c2 = np.asarray(ref_completeness_vec, dtype=np.float64)
        sb, idx = self._run(
            q, b_mat, knn, exclude_self=False,
            c1_rows=c1, c2_cols=c2, cutoff=completeness_cutoff,
        )
        return rows_from_samebits(
            sb, idx, dist_type, self.s64,
            c1_rows=c1, c2_all=c2, cutoff=completeness_cutoff,
        )

    def _stack(self, ms) -> np.ndarray:
        nk = len(ms.kmer_lengths)
        w = ms.kmer_stride
        n = ms.number_samples_loaded()
        mat = ms.sketch_bins.reshape(n, nk, w)
        return np.ascontiguousarray(mat.transpose(1, 0, 2)).view(np.uint32)

    def _run_ca(self, a_stack: np.ndarray, knn: int, exclude_self: bool,
                row_base: int = 0, c1_rows=None, c2_cols=None,
                cutoff: float = 0.64, a_sig=None, b_sig=None):
        from ..dist.knn_jax import SparseKnnRows

        kmers = tuple(self.ms.kmer_lengths)
        b_stack = self._stack(self.ms)
        padc = (-self.n) % self.col_tile
        if padc:
            b_stack = np.pad(b_stack, ((0, 0), (0, padc), (0, 0)))
        rows_mult = self.mesh.shape["rows"]
        na = a_stack.shape[1]
        if na == 0:  # empty multi-process row slice
            return SparseKnnRows(
                np.zeros((0, knn), np.int32),
                np.zeros((0, knn, 2), np.float32),
                None,
            )
        pad = (-na) % rows_mult
        if pad:
            a_stack = np.pad(a_stack, ((0, 0), (0, pad), (0, 0)))
        c1 = c2 = None
        if c1_rows is not None:
            c1 = np.pad(
                np.asarray(c1_rows, dtype=np.float32), (0, pad),
                constant_values=1.0,
            )
            c2 = np.pad(
                np.asarray(c2_cols, dtype=np.float32), (0, padc),
                constant_values=1.0,
            )
        if a_sig is not None:
            a_sig = np.pad(a_sig.astype(np.int32), ((0, pad), (0, 0)))
            b_sig = np.asarray(b_sig, dtype=np.int32)
            padb = b_stack.shape[1] - b_sig.shape[0]
            if padb:
                b_sig = np.pad(b_sig, ((0, padb), (0, 0)))
        a_dev = jax.device_put(
            a_stack, NamedSharding(self.mesh, P(None, "rows", None))
        )
        b_dev = jax.device_put(
            b_stack, NamedSharding(self.mesh, P(None, None, None))
        )
        core, acc, idx = sharded_knn_ca_step(
            a_dev, b_dev, self.s64, self.mesh, knn, n_real=self.n,
            exclude_self=exclude_self, kmers=kmers,
            sketch_size=self.ms.sketch_size, col_tile=self.col_tile,
            row_base=row_base, c1=c1, c2=c2, cutoff=cutoff,
            a_sig=a_sig, b_sig=b_sig,
        )
        # exact f64 values for the selected pairs (same pass as the
        # single-device engine; selection stays f32)
        from ..dist.knn_jax import exact_ca_values

        core_np = np.asarray(core)[:na]
        acc_np = np.asarray(acc)[:na]
        idx_np = np.asarray(idx)[:na]
        core_np, acc_np, idx_np = exact_ca_values(
            self.ms, self.s64, idx_np, core_np, acc_np, a_dev, b_dev,
            np.arange(na, dtype=np.int32),
            c1_rows[:na] if c1_rows is not None else None,
            c2_cols, cutoff,
        )
        vals = np.stack([core_np, acc_np], axis=-1).astype(np.float32)
        return SparseKnnRows(idx_np, vals, None)

    def self_knn_coreacc(self, knn: int, row_range: slice | None = None,
                         completeness_vec=None,
                         completeness_cutoff: float = 0.64):
        stack = self._stack(self.ms)
        base = 0
        comp = (
            np.asarray(completeness_vec, dtype=np.float32)
            if completeness_vec is not None
            else None
        )
        c1 = comp
        if row_range is not None:
            stack = stack[:, row_range, :]
            base = row_range.start
            if comp is not None:
                c1 = comp[row_range]
        return self._run_ca(
            stack, knn, exclude_self=True, row_base=base,
            c1_rows=c1, c2_cols=comp, cutoff=completeness_cutoff,
        )

    def cross_knn_coreacc(self, query_ms, knn: int,
                          ref_completeness_vec=None,
                          query_completeness_vec=None,
                          completeness_cutoff: float = 0.64):
        # like the reference (jaccard.rs:36-42), correction applies only
        # when BOTH sides have completeness values; rows are queries
        c1 = c2 = None
        if (
            ref_completeness_vec is not None
            and query_completeness_vec is not None
        ):
            c1 = np.asarray(query_completeness_vec, dtype=np.float32)
            c2 = np.asarray(ref_completeness_vec, dtype=np.float32)
        return self._run_ca(
            self._stack(query_ms), knn, exclude_self=False,
            c1_rows=c1, c2_cols=c2, cutoff=completeness_cutoff,
        )

    # --- precluster scan primitives (see PreclusterKnnMixin) ---

    def _pc_scan(self, dist_type, lo, hi, signs, knn, comp, cutoff):
        a_mat, b_mat = self._mats(dist_type.k_idx)
        return self._run(
            a_mat[lo:hi], b_mat, knn, exclude_self=True, row_base=lo,
            c1_rows=comp[lo:hi] if comp is not None else None,
            c2_cols=comp, cutoff=cutoff,
            a_sig=signs[lo:hi], b_sig=signs,
        )

    def _pc_scan_subset(self, dist_type, rows, knn, comp, cutoff):
        a_mat, b_mat = self._mats(dist_type.k_idx)
        return self._run(
            a_mat[rows], b_mat, knn, exclude_self=False,
            c1_rows=comp[rows] if comp is not None else None,
            c2_cols=comp, cutoff=cutoff,
        )

    def _pc_ca(self, lo, hi, signs, knn, comp, cutoff):
        stack = self._stack(self.ms)
        return self._run_ca(
            stack[:, lo:hi, :], knn, exclude_self=True, row_base=lo,
            c1_rows=comp[lo:hi] if comp is not None else None,
            c2_cols=comp, cutoff=cutoff,
            a_sig=signs[lo:hi], b_sig=signs,
        )

    def _pc_ca_subset(self, rows, knn, comp, cutoff):
        stack = self._stack(self.ms)
        return self._run_ca(
            stack[:, rows, :], knn, exclude_self=False,
            c1_rows=comp[rows] if comp is not None else None,
            c2_cols=comp, cutoff=cutoff,
        )


class ShardedInvertedEngine:
    """Inverted-index queries and the precluster pair count over a device
    mesh (same interface as inverted.device.DeviceInvertedEngine).

    The dense [n x S] sign matrix replicates on every device (661k x 100
    i32 = 264 MB, well inside device memory); work shards over the 'rows' mesh axis:
    queries shard by query row, and the all-pairs any-shared-bin count
    (the reference's stated 90-min/50-GB pain point,
    /root/reference/src/inverted.rs:271-300) gives each chip its own row
    strip of the upper triangle per dispatch. Counts are exact int32 per
    (device, column tile) and summed on the host in Python ints."""

    def __init__(self, sign_matrix: np.ndarray, mesh: Mesh | None = None,
                 tile: int = 4096):
        from ..runtime import enable_compilation_cache

        enable_compilation_cache()
        self.mesh = mesh or make_mesh(n_words=1)
        if self.mesh.shape["words"] != 1:
            raise ValueError("sharded inverted engine needs words=1")
        self.rows = self.mesh.shape["rows"]
        self.n = int(sign_matrix.shape[0])
        self.tile = min(tile, max(256, -(-self.n // self.rows)))
        mat = np.asarray(sign_matrix, dtype=np.int32)
        padc = (-self.n) % self.tile
        if padc:
            mat = np.pad(mat, ((0, padc), (0, 0)))
        self._mat_host = mat
        # replicated: every chip scans all column tiles for its row strip
        self._mat = jax.device_put(
            mat, NamedSharding(self.mesh, P(None, None))
        )

    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        from ..inverted.device import _match_count_strip

        n, tile, rows = self.n, self.tile, self.rows
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, n)
        step = tile * rows  # one strip of `tile` rows per device

        def strip_fn(a_blk, m, i0_base):
            d = jax.lax.axis_index("rows").astype(jnp.int32)
            i0 = i0_base + d * jnp.int32(tile)
            na = jnp.clip(jnp.int32(hi) - i0, 0, jnp.int32(tile))
            counts = _match_count_strip(
                a_blk, m, i0, na, jnp.int32(n), tc=tile
            )
            return counts[None, :]

        from jax import shard_map

        shard = shard_map(
            strip_fn,
            mesh=self.mesh,
            in_specs=(P("rows", None), P(None, None), P()),
            out_specs=P("rows", None),
        )
        total = 0
        pending = []
        for s0 in range(lo, hi, step):
            a = self._mat_host[s0 : s0 + step]
            pad = step - a.shape[0]
            if pad:
                a = np.pad(a, ((0, pad), (0, 0)))
            a_dev = jax.device_put(
                a, NamedSharding(self.mesh, P("rows", None))
            )
            pending.append(shard(a_dev, self._mat, jnp.int32(s0)))
        for x in pending:
            total += int(np.asarray(x).astype(np.int64).sum())
        return total

    def _query(self, queries: np.ndarray, mode: str) -> np.ndarray:
        from ..inverted.device import _match_matrix_scan

        q = np.asarray(queries, dtype=np.int32)
        nq = q.shape[0]
        pad = (-nq) % self.rows
        if pad:
            q = np.pad(q, ((0, pad), (0, 0)))
        q_dev = jax.device_put(q, NamedSharding(self.mesh, P("rows", None)))

        from jax import shard_map

        out = shard_map(
            lambda qb, m: _match_matrix_scan(qb, m, self.tile, mode),
            mesh=self.mesh,
            in_specs=(P("rows", None), P(None, None)),
            out_specs=P("rows", None),
        )(q_dev, self._mat)
        return np.asarray(out)[:nq, : self.n]

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "count").astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "any")

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "all")


def sharded_dist_step(a, b, s64: int, mesh: Mesh, k: float, ani: bool):
    """One full sharded distance step (samebits -> f32 distances), jittable
    over a mesh. This is the 'training step' analogue the multi-chip dry
    run compiles: row-sharded A, word-sharded contraction with psum, and a
    replicated query block."""

    from jax import shard_map

    words = mesh.shape["words"]

    def tile_fn(a_blk, b_blk):
        partial = _samebits_tile(a_blk, b_blk, s64 // words)
        sb = jax.lax.psum(partial, "words").astype(jnp.float32)
        maxnbits = float(s64 * 64)
        expected = float(int(s64 * 64) >> BBITS)
        diff = jnp.maximum(sb - expected, 0.0)
        j = (diff * maxnbits / (maxnbits - expected)) / maxnbits
        if ani:
            val = 1.0 + 1.0 / k * jnp.log((2.0 * j) / (1.0 + j))
            return jnp.maximum(0.0, val)
        return 1.0 - j

    return shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P("rows", "words"), P(None, "words")),
        out_specs=P("rows", None),
    )(a, b)
