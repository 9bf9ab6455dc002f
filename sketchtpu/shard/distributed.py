"""Multi-host orchestration: sample-sharded sketching over jax.distributed.

The reference's only parallelism is a shared-memory rayon pool with a
serial writer thread (/root/reference/src/sketch/mod.rs:318-391); nothing
spans hosts. The analogue here is process-level data parallelism:
each host sketches a contiguous slice of the input list into a local
`.skd`/`.skm` shard (device-batched on its own chips, no cross-host
communication — sketching is per-sample independent), and shard files are
then concatenated. Because `.skd` is a headerless sample-major stream
(sketch_datafile.rs:14-96) and metadata merging re-bases indices exactly
like the reference's `merge` (src/utils.rs:18-33), the merged database is
byte-identical to a single-host sketch of the full input list — asserted
by tests/test_distributed.py.

Distance computation across hosts reuses the same pattern at a higher
level: rows (samples) are sharded per host by `process_slice`, each host
computes its row-block against the full column range with its local
chip mesh (mesh.py does the intra-host sharding), and long-form output
streams are concatenated in rank order. No collective is needed because
the distance matrix is written, not reduced.
"""

from __future__ import annotations

import os


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialise jax.distributed when running multi-host; returns
    (process_index, process_count). Single-process when no coordinator is
    configured (env JAX_COORDINATOR_ADDRESS or explicit args)."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
            num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        if process_id is None and os.environ.get("JAX_PROCESS_ID"):
            process_id = int(os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def process_slice(n_items: int, process_index: int, process_count: int) -> slice:
    """Contiguous near-equal split of n_items over processes (first
    n_items % process_count processes take one extra)."""
    base = n_items // process_count
    extra = n_items % process_count
    start = process_index * base + min(process_index, extra)
    length = base + (1 if process_index < extra else 0)
    return slice(start, start + length)


def shard_prefix(output_prefix: str, process_index: int) -> str:
    return f"{output_prefix}.part{process_index}"


def triangle_row_slice(
    n: int, process_index: int, process_count: int
) -> slice:
    """Row range for one process of an upper-triangle self-distance run,
    balanced by pair count (row i carries n-1-i pairs, so equal row counts
    would leave the first rank with ~2x the work). Concatenating the ranks'
    long-form outputs in rank order reproduces the single-process file."""
    import numpy as np

    if n == 0:
        return slice(0, 0)
    cum = np.arange(n + 1, dtype=np.float64)
    cum = cum * n - cum * (cum + 1) / 2  # pairs in rows [0, i)
    total = cum[-1]
    lo = int(np.searchsorted(cum, total * process_index / process_count))
    hi = int(np.searchsorted(cum, total * (process_index + 1) / process_count))
    if process_index == process_count - 1:
        hi = n
    return slice(min(lo, n), min(hi, n))


def sketch_shard(
    output_prefix: str,
    input_files: list,
    process_index: int,
    process_count: int,
    *,
    concat_fasta: bool,
    kmers: list[int],
    sketch_bins: int,
    seq_type,
    rc: bool,
    min_count: int,
    min_qual: int,
    threads: int = 1,
    convert_pdb: bool = False,
) -> str:
    """Sketch this process's slice of the input list into
    {output_prefix}.part{i}.skd/.skm. Returns the shard prefix."""
    from ..formats.skm import MultiSketch
    from ..runtime import select_backend
    from ..sketchcore.pipeline import sketch_files

    sl = process_slice(len(input_files), process_index, process_count)
    part = input_files[sl]
    prefix = shard_prefix(output_prefix, process_index)
    backend = select_backend(seq_type, len(part))
    sketches = sketch_files(
        prefix,
        part,
        concat_fasta,
        kmers,
        sketch_bins,
        seq_type,
        rc,
        min_count,
        min_qual,
        threads=threads,
        backend=backend,
        convert_pdb=convert_pdb,
    )
    ms = MultiSketch(sketches, sketch_bins, kmers, seq_type)
    ms.save_metadata(prefix)
    return prefix


def merge_shards(output_prefix: str, process_count: int, *, keep_parts: bool = False):
    """Concatenate per-process shards into {output_prefix}.skd/.skm
    (rank-0 step after a barrier). Byte-identical to a single-process
    sketch of the full input list."""
    from ..formats.skm import MultiSketch

    merged = MultiSketch.load_metadata(shard_prefix(output_prefix, 0))
    for i in range(1, process_count):
        nxt = MultiSketch.load_metadata(shard_prefix(output_prefix, i))
        merged = merged.merge_sketches(nxt)
    with open(f"{output_prefix}.skd", "wb") as out:
        for i in range(process_count):
            with open(f"{shard_prefix(output_prefix, i)}.skd", "rb") as f:
                while True:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        break
                    out.write(chunk)
    merged.save_metadata(output_prefix)
    if not keep_parts:
        for i in range(process_count):
            p = shard_prefix(output_prefix, i)
            os.remove(f"{p}.skd")
            os.remove(f"{p}.skm")
    return merged


def inverted_build_shard(
    output_prefix: str,
    input_files: list,
    file_order: list[int],
    process_index: int,
    process_count: int,
    *,
    k: int,
    sketch_size: int,
    rc: bool,
    min_count: int,
    min_qual: int,
    write_skq: bool,
    hash_type,
    threads: int = 1,
    progress=None,
) -> str:
    """Build this process's slice of the inverted index into
    {output_prefix}.part{i}.ski (+ .skq). The slice is over DISTINCT
    sample indices (rows of the sign matrix), so multi-file samples —
    which min-combine into one row — stay whole on one rank. Returns the
    shard prefix."""
    from ..inverted.index import Inverted
    from ..runtime import select_backend

    n_distinct = (max(file_order) + 1) if file_order else 0
    sl = process_slice(n_distinct, process_index, process_count)
    pairs = [
        (idx - sl.start, f)
        for idx, f in zip(file_order, input_files)
        if sl.start <= idx < sl.stop
    ]
    part_order = [i for i, _ in pairs]
    part_files = [f for _, f in pairs]
    prefix = shard_prefix(output_prefix, process_index)
    if not part_files:  # more ranks than samples: write an empty shard
        import numpy as np

        inv = Inverted(
            sign_matrix=np.zeros((0, sketch_size), dtype=np.uint16),
            sample_names=[],
            kmer_size=k,
            rc=rc,
            hash_type=hash_type,
        )
        if write_skq:
            open(f"{prefix}.skq", "wb").close()
        inv.save(prefix)
        return prefix
    inv = Inverted.build(
        part_files,
        part_order,
        k,
        sketch_size,
        rc,
        min_count,
        min_qual,
        write_skq=f"{prefix}.skq" if write_skq else None,
        hash_type=hash_type,
        backend=select_backend(hash_type, len(part_files)),
        threads=threads,
        progress=progress,
    )
    inv.save(prefix)
    return prefix


def merge_inverted_shards(
    output_prefix: str,
    process_count: int,
    *,
    metadata=None,
    labels=None,
    write_skq: bool = False,
    keep_parts: bool = False,
):
    """Concatenate per-process inverted shards into {output_prefix}.ski
    (+ .skq), byte-identical to a single-process build of the full list.
    metadata/labels are global (rank 0 computes them from the full input
    list)."""
    import numpy as np

    from ..inverted.index import Inverted

    parts = [
        Inverted.load(shard_prefix(output_prefix, i))
        for i in range(process_count)
    ]
    first = parts[0]
    inv = Inverted(
        sign_matrix=np.concatenate([p.sign_matrix for p in parts]),
        sample_names=[n for p in parts for n in p.sample_names],
        kmer_size=first.kmer_size,
        rc=first.rc,
        hash_type=first.hash_type,
        metadata=metadata,
        labels=labels,
    )
    inv.save(output_prefix)
    if write_skq:
        # .skq is the row-major u16 sign stream in .ski order: parts
        # concatenate bytewise
        with open(f"{output_prefix}.skq", "wb") as out:
            for i in range(process_count):
                with open(f"{shard_prefix(output_prefix, i)}.skq", "rb") as f:
                    while True:
                        chunk = f.read(1 << 24)
                        if not chunk:
                            break
                        out.write(chunk)
    if not keep_parts:
        for i in range(process_count):
            p = shard_prefix(output_prefix, i)
            os.remove(f"{p}.ski")
            if write_skq:
                os.remove(f"{p}.skq")
    return inv
