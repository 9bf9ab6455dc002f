"""`sketchtpu warmup` — populate the persistent XLA compile cache for a
given sketch/distance configuration.

The reference has no compile step; on the GPU the first dispatch of
each program pays an XLA compilation (up to minutes for the large hash
programs). This command drives the REAL CLI code paths against
synthetic inputs sized like the user's workload, so every later
invocation with the same configuration hits the persistent cache
(runtime.enable_compilation_cache) and its wall clock is honest.

Zero drift by construction: nothing is lowered by hand — the warmup
invokes `cli.main` on a synthetic database / synthetic genomes, so the
engine selection, padding, tiling, and kernel choices are exactly the
production ones. Distance programs specialize on the padded column
count, so pass --db-size near your real database size; row-block
programs come in a full-block and a tail-block shape, so warmup runs
the first AND last multi-process rank slice of the synthetic DB.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
import time

import numpy as np

log = logging.getLogger("sketchtpu")

_WARM_ROWS = 2048  # one full row block per rank slice


def build_synth_db(prefix: str, n: int, sketch_size: int, kmers: list[int],
                   seq_type: str = "dna", level: int = 1) -> str:
    """Synthesize an on-disk sketch DB with random bit-planes (program
    shapes depend only on geometry, not sign values)."""
    from .formats.skd import SketchDataWriter
    from .formats.skm import MultiSketch
    from .sketchcore.sketch import HashType, Sketch, num_bins

    _s64, _bins, usize = num_bins(sketch_size)
    rng = np.random.default_rng(0)
    sketches = []
    with SketchDataWriter(f"{prefix}.skd") as w:
        for i in range(n):
            usigs = rng.integers(
                0, 1 << 62, size=len(kmers) * usize, dtype=np.uint64
            )
            sk = Sketch(
                name=f"w{i}",
                rc=True,
                reads=False,
                seq_length=2_000_000,
                densified=False,
                acgt=(1, 1, 1, 1),
                non_acgt=0,
                usigs=usigs,
            )
            sk.index = w.write_sketch(usigs)
            sk.usigs = None
            sketches.append(sk)
    ht = HashType(seq_type if seq_type != "pdb" else "aa", level)
    MultiSketch(sketches, sketch_size, kmers, ht).save_metadata(prefix)
    return prefix


def _write_synth_fasta(path: str, length: int, seq_type: str, seed: int):
    rng = np.random.default_rng(seed)
    alphabet = b"ACGT" if seq_type == "dna" else b"ACDEFGHIKLMNPQRSTVWY"
    letters = np.frombuffer(alphabet, dtype=np.uint8)
    seq = letters[rng.integers(0, len(letters), length)].tobytes()
    with open(path, "wb") as f:
        f.write(b">warmup\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i : i + 80] + b"\n")


def _write_synth_fastq_gz(path: str, total: int, seed: int,
                          read_len: int = 150, coverage: int = 25):
    """Synthetic FASTQ.gz: `total` bases of `read_len` reads at
    `coverage`x off one random genome, ~0.5% errors, Q40 (the reads-path
    programs specialize on the dispatch-window bucket of the total base
    count, not on read content)."""
    import gzip

    rng = np.random.default_rng(seed)
    glen = max(total // coverage, read_len + 1)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = total // read_len
    qual = b"I" * read_len
    with gzip.open(path, "wb", compresslevel=1) as f:
        for i, s in enumerate(rng.integers(0, glen - read_len, n_reads)):
            seg = genome[s : s + read_len]
            if i % 2:
                seg = 3 - seg[::-1]
            err = rng.random(read_len) < 0.005
            if err.any():
                seg = seg.copy()
                seg[err] = (seg[err] + rng.integers(1, 4, int(err.sum()))) % 4
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, letters[seg].tobytes(), qual))


def build_synth_inverted(prefix: str, n: int, sketch_size: int,
                         kmer: int) -> str:
    """Synthesize an on-disk inverted index (.ski + .skq) plus a matching
    .skd/.skm DB (same sample names, so `inverted precluster` accepts the
    pair). Program shapes depend only on (n, sketch_size), not sign
    values."""
    from .formats.skd import SketchDataWriter
    from .inverted.index import Inverted
    from .sketchcore.sketch import HashType

    rng = np.random.default_rng(0)
    signs = rng.integers(0, 1 << 16, size=(n, sketch_size), dtype=np.uint16)
    inv = Inverted(
        sign_matrix=signs,
        sample_names=[f"w{i}" for i in range(n)],
        kmer_size=kmer,
        rc=True,
        hash_type=HashType("dna"),
    )
    inv.save(prefix)
    with SketchDataWriter(f"{prefix}.skq", dtype=np.uint16) as w:
        for row in signs:
            w.write_sketch(row)
    return prefix


def _run_cli(argv: list[str], label: str) -> float:
    from . import cli

    t0 = time.time()
    log.info("warmup: %s (%s)", label, " ".join(argv))
    rc = cli.main(argv + ["--quiet"])
    dt = time.time() - t0
    if rc:
        raise RuntimeError(f"warmup step {label!r} failed (rc={rc})")
    print(f"  warmed {label}: {dt:.1f} s", file=sys.stderr)
    return dt


def run_warmup(args) -> int:
    from .ingest import inputs as io_inputs

    kmers = io_inputs.parse_kmers(args.k_vals, args.k_seq) or [21]
    modes = set((args.modes or "sketch,dense,knn").split(","))
    genome_sizes = [int(x) for x in args.genome_sizes.split(",") if x]
    total0 = time.time()
    with tempfile.TemporaryDirectory(prefix="sketchtpu_warmup_") as tmp:
        if "sketch" in modes:
            # sketching programs specialize on the padded stream bucket:
            # one synthetic genome per requested size covers the
            # pack/hash/compaction/sort kernels for that bucket
            for gs in genome_sizes:
                paths = []
                for i in range(2):  # two samples: group batching paths
                    p = os.path.join(tmp, f"g{gs}_{i}.fa")
                    _write_synth_fasta(p, gs, args.seq_type, seed=gs + i)
                    paths.append(p)
                argv = [
                    "sketch", *paths,
                    "-o", os.path.join(tmp, f"wdb{gs}"),
                    "-k", ",".join(str(k) for k in kmers),
                    "-s", str(args.sketch_size),
                    "--threads", str(args.threads),
                ]
                if args.seq_type != "dna":
                    argv += ["--seq-type", "aa", "--level", args.level]
                _run_cli(argv, f"sketch {args.seq_type} {gs:,} bases")

        if "reads" in modes:
            # FASTQ path: per-(dispatch-window bucket, k) hash + prefilter
            # graphs are among the most expensive compiles; one sample
            # covers the full-window program and the tail bucket
            fq = os.path.join(tmp, "reads.fastq.gz")
            _write_synth_fastq_gz(fq, args.reads_bases, seed=0)
            rfile = os.path.join(tmp, "reads_rfile.txt")
            with open(rfile, "w") as rf:
                rf.write(f"r0\t{fq}\n")
            _run_cli(
                [
                    "sketch", "-f", rfile,
                    "-o", os.path.join(tmp, "rdb"),
                    "-k", ",".join(str(k) for k in kmers),
                    "-s", str(args.sketch_size),
                    "--min-count", "5",
                    "--threads", str(args.threads),
                ],
                f"reads {args.reads_bases:,} bases",
            )

        dist_modes = modes & {
            "dense", "knn", "coreacc-dense", "coreacc-knn", "exact", "cross",
        }
        if dist_modes:
            n = args.db_size
            db = build_synth_db(
                os.path.join(tmp, "db"), n, args.sketch_size, kmers,
                args.seq_type, _level_num(args.level),
            )
            # first + last rank slices: full row blocks AND the tail block
            n_procs = max(1, n // _WARM_ROWS)
            ranks = [0] if n_procs == 1 else [0, n_procs - 1]
            for mode in sorted(
                dist_modes & {"dense", "knn", "coreacc-dense",
                              "coreacc-knn", "exact"}
            ):
                coreacc = mode.startswith("coreacc") or mode == "exact"
                if coreacc and len(kmers) < 3:
                    print(
                        f"  skipping {mode}: needs >= 3 k-mer lengths",
                        file=sys.stderr,
                    )
                    continue
                for rank in ranks:
                    argv = ["dist", db, "-o", os.path.join(tmp, "out")]
                    if not coreacc:
                        argv += ["-k", str(kmers[0])]
                    if mode == "exact":
                        argv += ["--exact"]
                    if mode.endswith("knn"):
                        argv += ["--knn", str(args.knn)]
                    argv += [
                        "--threads", str(args.threads),
                        "--process-id", str(rank),
                        "--n-processes", str(n_procs),
                    ]
                    _run_cli(argv, f"{mode} n={n} rank {rank}/{n_procs}")
            if "cross" in dist_modes:
                nq = args.query_db_size
                qdb = build_synth_db(
                    os.path.join(tmp, "qdb"), nq, args.sketch_size, kmers,
                    args.seq_type, _level_num(args.level),
                )
                runs = [
                    (["-k", str(kmers[0])], f"cross dense n={n} nq={nq}"),
                    (["--knn", str(args.knn)], f"cross knn n={n} nq={nq}"),
                ]
                if len(kmers) >= 3:
                    runs.append(([], f"cross coreacc n={n} nq={nq}"))
                    runs.append(
                        (["--exact"], f"cross exact n={n} nq={nq}")
                    )
                for extra, label in runs:
                    _run_cli(
                        [
                            "dist", db, qdb,
                            "-o", os.path.join(tmp, "out"),
                            "--threads", str(args.threads), *extra,
                        ],
                        label,
                    )

        if "inverted" in modes:
            # build kernels (single-k, no densify) on the smallest genome
            # bucket; query/precluster kernels (equality tiles, masked
            # scan) against a synthetic index at the requested scale
            gs = min(genome_sizes)
            paths = []
            for i in range(2):
                p = os.path.join(tmp, f"inv_g{i}.fa")
                _write_synth_fasta(p, gs, "dna", seed=1000 + i)
                paths.append(p)
            _run_cli(
                [
                    "inverted", "build", *paths,
                    "-o", os.path.join(tmp, "wski"),
                    "-s", str(args.inverted_sketch_size),
                    "-k", str(kmers[0]),
                    "--write-skq",
                    "--threads", str(args.threads),
                ],
                f"inverted build {gs:,} bases",
            )
            n = args.db_size
            ski = build_synth_inverted(
                os.path.join(tmp, "iski"), n,
                args.inverted_sketch_size, kmers[0],
            )
            build_synth_db(
                os.path.join(tmp, "iski"), n, args.inverted_sketch_size,
                kmers, "dna", 1,
            )
            for qt in ("match-count", "all-bins", "any-bins"):
                _run_cli(
                    [
                        "inverted", "query", f"{ski}.ski", *paths,
                        "-o", os.path.join(tmp, "qout"),
                        "--query-type", qt,
                        "--threads", str(args.threads),
                    ],
                    f"inverted query {qt} n={n}",
                )
            _run_cli(
                [
                    "inverted", "precluster", f"{ski}.ski", "--count",
                    "-o", os.path.join(tmp, "pout"),
                    "--threads", str(args.threads),
                ],
                f"inverted precluster --count n={n}",
            )
            pre = [
                "inverted", "precluster", f"{ski}.ski",
                "--skd", f"{ski}.skd",
                "-o", os.path.join(tmp, "pout"),
                "--knn", str(args.knn),
                "--threads", str(args.threads),
            ]
            _run_cli(pre, f"inverted precluster knn n={n}")
            if len(kmers) >= 3:
                _run_cli(
                    pre + ["--core-acc"],
                    f"inverted precluster core-acc n={n}",
                )
    print(
        f"warmup complete in {time.time() - total0:.0f} s — compile cache "
        "primed for this configuration",
        file=sys.stderr,
    )
    return 0


def _level_num(level) -> int:
    return int(str(level).removeprefix("level") or 1)
