"""Command-line interface, mirroring the reference's subcommands and flags
(reference src/cli.rs) on top of the JAX device runtime.

Subcommands: sketch, dist, inverted {build,query,precluster,serve},
merge, append, delete, info.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

log = logging.getLogger("sketchtpu")

DEFAULT_STRAND = False
DEFAULT_MINCOUNT = 5
DEFAULT_MINQUAL = 20
DEFAULT_SKETCHSIZE = 1000
DEFAULT_KNN = 50
DEFAULT_KMER = 21


def _add_common(p):
    p.add_argument("-v", "--verbose", action="store_true", help="Show progress messages")
    p.add_argument("--quiet", action="store_true", help="Don't show any messages")
    p.add_argument(
        "--jax-profile",
        metavar="DIR",
        help="Capture a JAX/XLA device profile of the run into DIR "
        "(view with TensorBoard or xprof)",
    )


def _add_kmers(p):
    p.add_argument(
        "-k",
        "--k-vals",
        type=lambda s: [int(x) for x in s.split(",")],
        help="K-mer list (comma separated k-mer values to sketch at)",
    )
    p.add_argument(
        "--k-seq",
        type=lambda s: [int(x) for x in s.split(",")],
        help="K-mer linear sequence (start,end,step)",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sketchtpu",
        description="Genome and amino-acid sketching and distances on the GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    # --- sketch ---
    p = sub.add_parser("sketch", help="Create sketches from input data")
    p.add_argument("seq_files", nargs="*", help="List of input FASTA files")
    p.add_argument("-f", dest="file_list", help="File listing input files")
    p.add_argument("--concat-fasta", action="store_true")
    p.add_argument("-o", dest="output", required=True, help="Output prefix")
    _add_kmers(p)
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("--seq-type", choices=["dna", "aa", "pdb"], default="dna")
    p.add_argument(
        "--convert-pdb",
        action="store_true",
        help="Input files are .pdb; convert them to 3Di first (requires the "
        "optional mini3di + biopython packages)",
    )
    p.add_argument("--level", choices=["level1", "level2", "level3"], default="level1")
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="Multi-host sharding: this process's rank (auto-detected from "
        "jax.distributed when JAX_COORDINATOR_ADDRESS is set)",
    )
    p.add_argument(
        "--n-processes",
        type=int,
        default=None,
        help="Multi-host sharding: total process count; each process "
        "sketches its slice of the input list, rank 0 merges",
    )
    _add_common(p)

    # --- dist ---
    p = sub.add_parser("dist", help="Calculate pairwise distances using sketches")
    p.add_argument("ref_db")
    p.add_argument("query_db", nargs="?")
    p.add_argument("-o", dest="output")
    p.add_argument("--knn", type=int)
    p.add_argument("--subset")
    p.add_argument("-k", dest="kmer", type=int)
    p.add_argument("--ani", action="store_true")
    p.add_argument(
        "--exact",
        action="store_true",
        help="Dense multi-k core/accessory output (self AND ref-vs-"
        "query): stream exact per-k samebits from the device and replay "
        "the f64 chain on the host — byte-identical to the host "
        "pipeline (the default large-run engine is f32, within ~1e-5). "
        "Single-k and kNN outputs are already exact; no effect there",
    )
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--ref-completeness-file")
    p.add_argument("--query-completeness-file")
    p.add_argument("--completeness-cutoff", type=float, default=0.64)
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="Multi-host sharding: this process's rank (auto-detected from "
        "jax.distributed when JAX_COORDINATOR_ADDRESS is set)",
    )
    p.add_argument(
        "--n-processes",
        type=int,
        default=None,
        help="Multi-host sharding: total process count; each process "
        "computes a balanced block of output rows and writes "
        "OUTPUT.partN; concatenate parts in rank order",
    )
    _add_common(p)

    # --- inverted ---
    p_inv = sub.add_parser("inverted", help="Inverted index commands")
    inv_sub = p_inv.add_subparsers(dest="inverted_command", required=True)

    p = inv_sub.add_parser("build")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("--write-skq", action="store_true")
    p.add_argument("--species-names")
    p.add_argument("--metadata")
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("-k", "--kmer-length", type=int, default=DEFAULT_KMER)
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="Multi-host sharding: this process's rank",
    )
    p.add_argument(
        "--n-processes",
        type=int,
        default=None,
        help="Multi-host sharding: total process count; each process "
        "builds its slice of the sample rows, rank 0 merges the .ski "
        "(byte-identical to a single-process build)",
    )
    _add_common(p)

    p = inv_sub.add_parser("query")
    p.add_argument("ski")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output")
    p.add_argument(
        "--query-type",
        choices=["match-count", "all-bins", "any-bins"],
        default="match-count",
    )
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="Multi-host sharding: this process's rank",
    )
    p.add_argument(
        "--n-processes",
        type=int,
        default=None,
        help="Multi-host sharding: total process count; each process "
        "handles a block of rows and writes OUTPUT.partN (concatenate "
        "parts in rank order; only rank 0 prints the header)",
    )
    _add_common(p)

    p = inv_sub.add_parser(
        "serve",
        help="Serve the index over HTTP (the reference's WASM/browser "
        "query frontend, hosted server-side: GET /info, POST /query "
        "= SketchlibData::get_probs JSON, POST /match-count)",
    )
    p.add_argument("ski")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    _add_common(p)

    p = inv_sub.add_parser("precluster")
    p.add_argument("ski")
    p.add_argument("--skd")
    p.add_argument("-o", dest="output")
    p.add_argument("--count", action="store_true")
    p.add_argument("--knn", type=int, default=DEFAULT_KNN)
    p.add_argument("--ani", action="store_true")
    p.add_argument(
        "--core-acc",
        action="store_true",
        help="Rank neighbours by multi-k core/accessory distances over "
        "every k in the .skd (extension; the reference CLI only supports "
        "single-k distances here)",
    )
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--ref-completeness-file")
    p.add_argument("--completeness-cutoff", type=float, default=0.64)
    p.add_argument(
        "--retain-unmatched", choices=["singleton", "bruteforce"], default=None
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="Multi-host sharding: this process's rank",
    )
    p.add_argument(
        "--n-processes",
        type=int,
        default=None,
        help="Multi-host sharding: total process count; each process "
        "handles a block of rows and writes OUTPUT.partN (concatenate "
        "parts in rank order; only rank 0 prints the header)",
    )
    _add_common(p)

    # --- merge ---
    p = sub.add_parser("merge", help="Merge two sketch databases")
    p.add_argument("db1")
    p.add_argument("db2")
    p.add_argument("-o", dest="output", required=True)
    _add_common(p)

    # --- append ---
    p = sub.add_parser("append", help="Sketch new genomes and append to a database")
    p.add_argument("db")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--concat-fasta", action="store_true")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--level", choices=["level1", "level2", "level3"], default="level1")
    _add_common(p)

    # --- delete ---
    p = sub.add_parser("delete", help="Delete genome(s) from a database")
    p.add_argument("db")
    p.add_argument("samples", help="Input file with IDs to delete (one per line)")
    p.add_argument("output_file")
    _add_common(p)

    # --- info ---
    p = sub.add_parser("info", help="Print information about a .skm/.ski file")
    p.add_argument("skm_file")
    p.add_argument("--sample-info", action="store_true")
    _add_common(p)

    # --- warmup (extension: the reference has no compile step) ---
    p = sub.add_parser(
        "warmup",
        help="Pre-compile the device kernel set for a configuration so later "
        "runs hit the persistent compile cache (drives the real CLI on "
        "synthetic inputs; see sketchtpu/warmup.py)",
    )
    _add_kmers(p)
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("--knn", type=int, default=DEFAULT_KNN)
    p.add_argument(
        "--db-size",
        type=int,
        default=10240,
        help="Synthetic DB rows for the distance programs (match your real "
        "DB size: programs specialize on the padded column count)",
    )
    p.add_argument(
        "--genome-sizes",
        default="2000000",
        help="Comma-separated genome lengths to warm the sketching kernels "
        "at (stream-bucket granularity)",
    )
    p.add_argument(
        "--modes",
        default="sketch,dense,knn",
        help="Comma-separated subset of sketch,dense,knn,coreacc-dense,"
        "coreacc-knn,exact,cross,reads,inverted",
    )
    p.add_argument(
        "--query-db-size",
        type=int,
        default=2048,
        help="Synthetic query DB rows for the cross (ref-vs-query) "
        "programs (match your real query count: cross programs "
        "specialize on the padded query column count)",
    )
    p.add_argument(
        "--reads-bases",
        type=int,
        default=20_000_000,
        help="Total FASTQ bases for the reads mode (programs specialize "
        "on the dispatch-window bucket of the base count; 20 Mb covers "
        "one full 16 Mb window plus a tail bucket)",
    )
    p.add_argument(
        "--inverted-sketch-size",
        type=int,
        default=100,
        help="Bins for the inverted-index programs (the inverted index "
        "is typically much smaller than the dense sketch, e.g. 100)",
    )
    p.add_argument("--seq-type", choices=["dna", "aa"], default="dna")
    p.add_argument("--level", choices=["level1", "level2", "level3"], default="level1")
    p.add_argument("--threads", type=int, default=1)
    _add_common(p)

    return parser


def strip_sketch_extension(name: str) -> str:
    if name.endswith((".skm", ".skd", ".ski")):
        return name[:-4]
    return name


def _resolve_ranks(args):
    """(proc_id, n_proc, multiproc) from flags or jax.distributed env."""
    n_proc = getattr(args, "n_processes", None)
    proc_id = getattr(args, "process_id", None)
    if n_proc is None and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        from .shard.distributed import init_distributed

        proc_id, n_proc = init_distributed()
    return proc_id or 0, n_proc, n_proc is not None and n_proc > 1


def _setup_logging(args):
    level = logging.WARNING
    if getattr(args, "quiet", False):
        level = logging.ERROR
    elif getattr(args, "verbose", False):
        level = logging.INFO
    logging.basicConfig(
        stream=sys.stderr, level=level, format="%(asctime)s %(levelname)s %(message)s"
    )


def _ostream(path):
    if path:
        return open(path, "w")
    return sys.stdout


def _level_num(level_str: str) -> int:
    return int(level_str[-1])


def main(argv=None) -> int:
    from .runtime import enable_compilation_cache

    args = build_parser().parse_args(argv)
    _setup_logging(args)
    enable_compilation_cache()
    start = time.time()
    print_success = True

    if os.environ.get("SKETCHTPU_COMPUTE_WINDOW_FILE"):
        # Post-import compute window for the scaling harness: interpreter +
        # module-import time is a fixed per-process cost that real N-host
        # deployments amortise over hours of work, so rank-scaling
        # efficiency must be reportable on the compute window alone.
        import atexit
        import json as _json

        def _write_window():
            with open(os.environ["SKETCHTPU_COMPUTE_WINDOW_FILE"], "w") as f:
                _json.dump({"compute_s": time.time() - start}, f)

        atexit.register(_write_window)

    if getattr(args, "jax_profile", None):
        # atexit (not try/finally) so every early-return path still closes
        # the trace
        import atexit

        import jax

        jax.profiler.start_trace(args.jax_profile)
        atexit.register(jax.profiler.stop_trace)
        log.info("JAX profiler tracing to %s", args.jax_profile)

    from .ingest import inputs as io_inputs
    from .sketchcore.sketch import HashType
    from .formats.skm import MultiSketch

    if args.command == "sketch":
        from .constants import num_bins
        from .sketchcore.pipeline import sketch_files
        from .runtime import select_backend

        input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
        log.info("Parsed %d samples in input list", len(input_files))
        kmers = io_inputs.parse_kmers(args.k_vals, args.k_seq)
        rc = not args.single_strand
        seq_type = HashType(args.seq_type, _level_num(args.level))
        _, sketch_bins, _ = num_bins(args.sketch_size)
        log.info(
            "Running sketching: k:%s; sketch_size:%s; seq:%s; threads:%s",
            kmers,
            sketch_bins,
            seq_type.debug_str(),
            args.threads,
        )
        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc:
            # Multi-host: sketch this rank's slice to a shard; rank 0 merges
            # once every shard file exists (byte-identical to a single-host
            # sketch of the full list).
            from .shard.distributed import merge_shards, sketch_shard

            sketch_shard(
                args.output,
                input_files,
                proc_id,
                n_proc,
                concat_fasta=args.concat_fasta,
                kmers=kmers,
                sketch_bins=sketch_bins,
                seq_type=seq_type,
                rc=rc,
                min_count=args.min_count,
                min_qual=args.min_qual,
                threads=args.threads,
                convert_pdb=args.convert_pdb,
            )
            try:
                import jax

                if jax.process_count() == n_proc:
                    from jax.experimental import multihost_utils

                    multihost_utils.sync_global_devices("sketchtpu_shards")
            except Exception:
                pass  # manual orchestration: caller merges when ready
            if proc_id == 0:
                from pathlib import Path

                from .shard.distributed import shard_prefix

                if all(
                    Path(f"{shard_prefix(args.output, i)}.skm").exists()
                    for i in range(n_proc)
                ):
                    merge_shards(args.output, n_proc)
                else:
                    log.warning(
                        "shards incomplete; run "
                        "sketchtpu.shard.distributed.merge_shards(%r, %d) "
                        "once all ranks finish",
                        args.output,
                        n_proc,
                    )
        else:
            backend = select_backend(seq_type, len(input_files))
            from .progress import progress_printer

            tick, finish = progress_printer(
                len(input_files), getattr(args, "quiet", False), "Sketching "
            )
            sketches = sketch_files(
                args.output,
                input_files,
                args.concat_fasta,
                kmers,
                sketch_bins,
                seq_type,
                rc,
                args.min_count,
                args.min_qual,
                threads=args.threads,
                backend=backend,
                convert_pdb=args.convert_pdb,
                progress=tick,
            )
            finish()
            elapsed = max(time.time() - start, 1e-9)
            total_mb = sum(s.seq_length for s in sketches) / 1e6
            log.info(
                "Sketched %d samples (%.1f Mbases) in %.2fs "
                "(%.1f samples/s, %.1f Mbase/s, %.1f Mbase-k/s)",
                len(sketches),
                total_mb,
                elapsed,
                len(sketches) / elapsed,
                total_mb / elapsed,
                total_mb * len(kmers) / elapsed,
            )
            ms = MultiSketch(sketches, sketch_bins, kmers, seq_type)
            ms.save_metadata(args.output)

    elif args.command == "dist":
        def _done_dense():
            # shared epilogue for the early-returning dense engine paths
            if out is not sys.stdout:
                out.close()
            if print_success and not getattr(args, "quiet", False):
                print(
                    f"\U0001f9ec\U0001f58b️ sketchtpu done in "
                    f"{int(time.time() - start)}s",
                    file=sys.stderr,
                )
            return 0

        from .dist import api, output as dist_output
        from .runtime import select_engine

        if args.ani and args.kmer is None:
            # clap: `ani` requires `kmer` (cli.rs:212)
            raise SystemExit("--ani requires -k (a single k-mer length)")
        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc and args.output:
            from .shard.distributed import shard_prefix

            args.output = shard_prefix(args.output, proc_id)
            log.info(
                "Multi-process dist: rank %d/%d writing %s "
                "(concatenate parts in rank order for the full output)",
                proc_id, n_proc, args.output,
            )
        out = _ostream(args.output)
        ref_name = strip_sketch_extension(args.ref_db)
        references = MultiSketch.load_metadata(ref_name)
        log.info("Loading sketch data from %s.skd", ref_name)
        if args.subset:
            references.read_sketch_data_block(
                ref_name, io_inputs.read_subset_names(args.subset)
            )
        else:
            references.read_sketch_data(ref_name)
        n = references.number_samples_loaded()
        ref_comp = (
            io_inputs.read_completeness_file(args.ref_completeness_file, references)
            if args.ref_completeness_file
            else None
        )
        dist_type = api.set_k(references, args.kmer, args.ani)
        log.info("%s", dist_type.describe())
        engine = select_engine(references)

        names = [references.sketch_name(i) for i in range(n)]

        # Multi-process row blocks: self-dense shards rows balanced by
        # pair count (upper triangle); kNN/cross shard rows uniformly.
        # Every rank loads all columns (the reference pattern at
        # distances/mod.rs has no analogue: the reference is single-host).
        tri_rows = uni_rows = None
        if multiproc:
            from .shard.distributed import process_slice, triangle_row_slice

            tri_rows = triangle_row_slice(n, proc_id, n_proc)
            uni_rows = process_slice(n, proc_id, n_proc)

        def _row_names(sl):
            return names[sl] if sl is not None else names

        def _tri_pairs():
            if tri_rows is None:
                return n * (n - 1) // 2
            lo, hi = tri_rows.start, tri_rows.stop
            return (hi - lo) * (n - 1) - (hi - lo) * (lo + hi - 1) // 2

        def _log_pair_rate(n_pairs):
            el = max(time.time() - start, 1e-9)
            log.info(
                "Computed %d pairwise distances in %.2fs (%.3g pairs/s)",
                n_pairs, el, n_pairs / el,
            )
        if args.query_db is None:
            if args.knn is None:
                coreacc_engine = None
                if dist_type.coreacc:
                    from .runtime import select_coreacc_engine

                    coreacc_engine = select_coreacc_engine(
                        references, ref_comp, args.completeness_cutoff,
                        exact=args.exact,
                    )
                if coreacc_engine is not None:
                    log.info(
                        "Using on-device core/accessory %s engine",
                        "exact-stream" if args.exact else "tile",
                    )
                    coreacc_engine.stream_self_dense(
                        out, names, row_range=tri_rows
                    )
                    _log_pair_rate(_tri_pairs())
                    return _done_dense()
                if not dist_type.coreacc:
                    from .runtime import select_dense_stream_engine

                    stream_engine = select_dense_stream_engine(
                        references, dist_type
                    )
                    if stream_engine is not None:
                        log.info("Using on-device dense streaming engine")
                        stream_engine.stream_self_dense(
                            out, names, dist_type, ref_comp,
                            args.completeness_cutoff, row_range=tri_rows,
                        )
                        _log_pair_rate(_tri_pairs())
                        return _done_dense()
                d = api.self_dists_all(
                    references,
                    dist_type,
                    ref_comp,
                    args.completeness_cutoff,
                    engine=engine,
                    row_range=tri_rows,
                )
                dist_output.write_dense_self(
                    out, names, d, dist_type.coreacc, row_range=tri_rows
                )
                _log_pair_rate(_tri_pairs())
            else:
                from .runtime import select_knn_engine

                nn = args.knn
                if nn >= n:
                    log.warning("knn=%d is higher than number of samples=%d", nn, n)
                    nn = n - 1
                knn_engine = select_knn_engine(references, dist_type)
                if knn_engine is not None:
                    log.info("Using on-device kNN engine")
                    if dist_type.coreacc:
                        rows = knn_engine.self_knn_coreacc(
                            nn, row_range=uni_rows,
                            completeness_vec=ref_comp,
                            completeness_cutoff=args.completeness_cutoff,
                        )
                    else:
                        rows = knn_engine.self_knn(
                            nn, dist_type, row_range=uni_rows,
                            completeness_vec=ref_comp,
                            completeness_cutoff=args.completeness_cutoff,
                        )
                else:
                    rows = api.self_dists_knn(
                        references,
                        nn,
                        dist_type,
                        ref_comp,
                        args.completeness_cutoff,
                        engine=engine,
                        row_range=uni_rows,
                    )
                dist_output.write_sparse(
                    out, _row_names(uni_rows), names, rows, dist_type.coreacc
                )
                _log_pair_rate(len(_row_names(uni_rows)) * n)
        else:
            query_name = strip_sketch_extension(args.query_db)
            queries = MultiSketch.load_metadata(query_name)
            if multiproc and args.knn is not None:
                # kNN rows are queries: this rank loads only its query
                # block (subset load); refs stay fully loaded
                from .shard.distributed import process_slice as _pslice

                all_q = [m.name for m in queries.sketch_metadata]
                queries.read_sketch_data_block(
                    query_name, all_q[_pslice(len(all_q), proc_id, n_proc)]
                )
            else:
                queries.read_sketch_data(query_name)
            q_comp = (
                io_inputs.read_completeness_file(args.query_completeness_file, queries)
                if args.query_completeness_file
                else None
            )
            qnames = [
                queries.sketch_name(i) for i in range(queries.number_samples_loaded())
            ]
            if args.knn is not None:
                from .runtime import select_knn_engine

                nn = args.knn
                if nn > n:
                    log.warning(
                        "knn=%d is higher than number of reference samples=%d", nn, n
                    )
                    nn = n
                knn_engine = select_knn_engine(references, dist_type)
                if knn_engine is not None:
                    log.info("Using on-device kNN engine")
                    if dist_type.coreacc:
                        rows = knn_engine.cross_knn_coreacc(
                            queries, nn,
                            ref_completeness_vec=ref_comp,
                            query_completeness_vec=q_comp,
                            completeness_cutoff=args.completeness_cutoff,
                        )
                    else:
                        rows = knn_engine.cross_knn(
                            queries, nn, dist_type,
                            ref_completeness_vec=ref_comp,
                            query_completeness_vec=q_comp,
                            completeness_cutoff=args.completeness_cutoff,
                        )
                else:
                    rows = api.cross_dists_knn(
                        references,
                        queries,
                        nn,
                        dist_type,
                        ref_comp,
                        q_comp,
                        args.completeness_cutoff,
                        engine=engine,
                    )
                dist_output.write_sparse(out, qnames, names, rows, dist_type.coreacc)
                _log_pair_rate(len(qnames) * n)
            else:
                stream_engine = None
                cross_ca_engine = None
                if not dist_type.coreacc:
                    from .runtime import select_dense_stream_engine

                    stream_engine = select_dense_stream_engine(
                        references, dist_type
                    )
                else:
                    from .runtime import select_coreacc_engine

                    # correction applies only when BOTH sides have values
                    # (jaccard.rs:36-42)
                    both_comp = (
                        ref_comp is not None and q_comp is not None
                    )
                    cross_ca_engine = select_coreacc_engine(
                        references,
                        ref_comp if both_comp else None,
                        args.completeness_cutoff,
                        exact=args.exact,
                    )
                if stream_engine is not None:
                    log.info("Using on-device dense streaming engine")
                    stream_engine.stream_cross_dense(
                        out, names, qnames, queries, dist_type, ref_comp,
                        q_comp, args.completeness_cutoff,
                        row_range=uni_rows,
                    )
                    _log_pair_rate(len(_row_names(uni_rows)) * len(qnames))
                elif cross_ca_engine is not None and hasattr(
                    cross_ca_engine, "stream_cross_dense"
                ):
                    log.info(
                        "Using on-device core/accessory %s engine (cross)",
                        "exact-stream" if args.exact else "tile",
                    )
                    cross_ca_engine.stream_cross_dense(
                        out, names, qnames, queries,
                        rcomp=ref_comp, qcomp=q_comp,
                        cutoff=args.completeness_cutoff,
                        row_range=uni_rows,
                    )
                    _log_pair_rate(len(_row_names(uni_rows)) * len(qnames))
                else:
                    d = api.cross_dists_all(
                        references,
                        queries,
                        dist_type,
                        ref_comp,
                        q_comp,
                        args.completeness_cutoff,
                        engine=engine,
                        row_range=uni_rows,
                    )
                    dist_output.write_dense_cross(
                        out, _row_names(uni_rows), qnames, d,
                        dist_type.coreacc,
                    )
                    _log_pair_rate(len(_row_names(uni_rows)) * len(qnames))
        if out is not sys.stdout:
            out.close()

    elif args.command == "inverted":
        _inverted_main(args)

    elif args.command == "merge":
        from .formats import skd as skd_io

        db1 = strip_sketch_extension(args.db1)
        db2 = strip_sketch_extension(args.db2)
        sketches1 = MultiSketch.load_metadata(db1)
        sketches2 = MultiSketch.load_metadata(db2)
        diffs = sketches1.incompatibilities(sketches2)
        if diffs:
            raise SystemExit(
                "Databases are not compatible for merging: "
                + "; ".join(diffs)
            )
        merged = sketches1.merge_sketches(sketches2)
        merged.save_metadata(args.output)
        with open(f"{args.output}.skd", "wb") as out_f:
            skd_io.append_skd(f"{db1}.skd", out_f)
            skd_io.append_skd(f"{db2}.skd", out_f)

    elif args.command == "append":
        from .sketchcore.pipeline import sketch_files
        from .formats import skd as skd_io
        from .runtime import select_backend

        input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
        db_metadata = MultiSketch.load_metadata(strip_sketch_extension(args.db))
        if not db_metadata.append_compatibility(input_files):
            raise SystemExit("Databases are not compatible for merging.")
        kmers = db_metadata.kmer_lengths
        rc = not args.single_strand
        sketch_size = db_metadata.sketch_size
        seq_type = db_metadata.hash_type
        if seq_type.kind == "aa":
            seq_type = HashType("aa", _level_num(args.level))
        backend = select_backend(seq_type, len(input_files))
        db2_sketches = sketch_files(
            args.output,
            input_files,
            args.concat_fasta,
            kmers,
            sketch_size,
            seq_type,
            rc,
            args.min_count,
            args.min_qual,
            threads=args.threads,
            backend=backend,
        )
        db2_metadata = MultiSketch(db2_sketches, sketch_size, kmers, seq_type)
        with open(f"{args.output}.skd", "ab") as out_f:
            skd_io.append_skd(f"{strip_sketch_extension(args.db)}.skd", out_f)
        concat = db2_metadata.merge_sketches(db_metadata)
        concat.save_metadata(args.output)

    elif args.command == "delete":
        ref_db = strip_sketch_extension(args.db)
        with open(args.samples) as f:
            ids = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        sketches = MultiSketch.load_metadata(ref_db)
        _delete_samples(sketches, ref_db, args.output_file, ids)

    elif args.command == "info":
        _info_main(args)
        print_success = False

    elif args.command == "warmup":
        from .warmup import run_warmup

        run_warmup(args)

    if print_success and not getattr(args, "quiet", False):
        print(f"\U0001f9ec\U0001f58b️ sketchtpu done in {int(time.time() - start)}s", file=sys.stderr)
    return 0


def _delete_samples(ms, ref_db: str, output_file: str, ids: list[str]) -> None:
    """Delete flow (lib.rs:879-908 + multisketch.rs:269-348): filter the
    metadata, then rewrite the .skd keeping non-deleted positions.

    Unlike the reference — which saves the OLD name_map and per-sketch
    index fields alongside the filtered metadata, leaving the output
    internally inconsistent (subset loads then panic / read the wrong
    rows; its own tests compare via a PartialEq that ignores name_map,
    multisketch.rs:376) — the surviving sketches are re-indexed to their
    compacted .skd rows, so the output equals a direct sketch of the
    remainder and every load path works on it."""
    from .formats import skd as skd_io

    removed = set()
    new_meta = []
    for sketch in ms.sketch_metadata:
        if sketch.name in ids:
            removed.add(sketch.name)
        else:
            new_meta.append(sketch)
    missing = [i for i in ids if i not in removed]
    if missing:
        raise SystemExit(
            f"The following samples have not been found in the database: {missing!r}"
        )
    positions = {ms.name_map[i] for i in ids}
    keep = [
        idx for idx in range(len(ms.sketch_metadata)) if idx not in positions
    ]
    for new_idx, sketch in enumerate(new_meta):
        sketch.index = new_idx
    ms.sketch_metadata = new_meta
    ms.name_map = {s.name: s.index for s in new_meta}
    ms.save_metadata(output_file)
    data = skd_io.read_skd_batch(f"{ref_db}.skd", keep, ms.sample_stride)
    with skd_io.SketchDataWriter(f"{output_file}.skd") as w:
        for i in range(len(keep)):
            w.write_sketch(data[i * ms.sample_stride : (i + 1) * ms.sample_stride])


def _inverted_main(args) -> None:
    from .ingest import inputs as io_inputs
    from .inverted.index import Inverted
    from .formats.skm import MultiSketch
    from .sketchcore.sketch import HashType

    if args.inverted_command == "build":
        input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
        log.info("Parsed %d samples in input list", len(input_files))
        distinct = {name for name, _ in input_files}
        if args.species_names:
            file_order, map_names_labels = io_inputs.reorder_input_files(
                input_files, args.species_names
            )
        else:
            names = [name for name, _ in input_files]
            if len(distinct) == len(input_files):
                file_order, map_names_labels = list(range(len(input_files))), None
            else:
                idx_map: dict[str, int] = {}
                for name in names:
                    if name not in idx_map:
                        idx_map[name] = len(idx_map)
                file_order, map_names_labels = [idx_map[n] for n in names], None

        labels_vec = None
        if map_names_labels is not None:
            labels_vec = [""] * len(distinct)
            for idx, (name, _f) in zip(file_order, input_files):
                labels_vec[idx] = map_names_labels.get(name, "")
        metadata_vec = None
        if args.metadata:
            md = io_inputs.parse_metadata_info(args.metadata)
            metadata_vec = [""] * len(distinct)
            for idx, (name, _f) in zip(file_order, input_files):
                metadata_vec[idx] = md[name]

        from .runtime import select_backend
        from .progress import progress_printer

        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc:
            # each rank builds its slice of sample rows; rank 0 merges
            # byte-identically (labels/metadata are global, so they are
            # attached at merge time from the full input list)
            from pathlib import Path

            from .shard.distributed import (
                inverted_build_shard,
                merge_inverted_shards,
                shard_prefix,
            )

            inverted_build_shard(
                args.output,
                input_files,
                file_order,
                proc_id,
                n_proc,
                k=args.kmer_length,
                sketch_size=args.sketch_size,
                rc=not args.single_strand,
                min_count=args.min_count,
                min_qual=args.min_qual,
                write_skq=args.write_skq,
                hash_type=HashType("dna"),
                threads=args.threads,
            )
            try:
                import jax

                if jax.process_count() == n_proc:
                    from jax.experimental import multihost_utils

                    multihost_utils.sync_global_devices(
                        "sketchtpu_inverted_shards"
                    )
            except Exception:
                pass  # manual orchestration: caller merges when ready
            if proc_id == 0:
                if all(
                    Path(f"{shard_prefix(args.output, i)}.ski").exists()
                    for i in range(n_proc)
                ):
                    inv = merge_inverted_shards(
                        args.output,
                        n_proc,
                        metadata=metadata_vec,
                        labels=labels_vec,
                        write_skq=args.write_skq,
                    )
                    log.info("Index info:\n%s", inv.debug_str())
                else:
                    log.warning(
                        "shards incomplete; run sketchtpu.shard."
                        "distributed.merge_inverted_shards(%r, %d) once "
                        "all ranks finish",
                        args.output,
                        n_proc,
                    )
        else:
            _inv_tick, _inv_finish = progress_printer(
                len(input_files), getattr(args, "quiet", False), "Sketching "
            )
            inv = Inverted.build(
                input_files,
                file_order,
                args.kmer_length,
                args.sketch_size,
                not args.single_strand,
                args.min_count,
                args.min_qual,
                write_skq=f"{args.output}.skq" if args.write_skq else None,
                metadata=metadata_vec,
                labels=labels_vec,
                hash_type=HashType("dna"),
                backend=select_backend(HashType("dna"), len(input_files)),
                threads=args.threads,
                progress=_inv_tick,
            )
            _inv_finish()
            inv.save(args.output)
            log.info("Index info:\n%s", inv.debug_str())

    elif args.inverted_command == "query":
        from .runtime import select_backend, select_inverted_engine

        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc and args.output:
            from .shard.distributed import shard_prefix

            args.output = shard_prefix(args.output, proc_id)
            log.info("Multi-process query: rank %d/%d writing %s",
                     proc_id, n_proc, args.output)
        out = _ostream(args.output)
        inv = Inverted.load(strip_sketch_extension(args.ski))
        input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
        if multiproc:
            from .shard.distributed import process_slice

            input_files = input_files[
                process_slice(len(input_files), proc_id, n_proc)
            ]
        queries, query_names = inv.sketch_queries(
            input_files,
            args.min_count,
            args.min_qual,
            backend=select_backend(HashType("dna"), len(input_files)),
            threads=args.threads,
        )
        engine = select_inverted_engine(inv)
        batch_counts = batch_any = None
        if engine is not None:
            if args.query_type == "match-count":
                batch_counts = engine.match_counts(queries)
            elif args.query_type == "any-bins":
                batch_any = engine.any_shared_rows(queries)
            elif args.query_type == "all-bins":
                batch_any = engine.all_shared_rows(queries)
        if not multiproc or proc_id == 0:
            out.write("Query")
            if args.query_type == "match-count":
                for name in inv.sample_names:
                    out.write(f"\t{name}")
                out.write("\n")
            else:
                out.write("\tMatches\n")
        for qi, q_name in enumerate(query_names):
            q = queries[qi]
            out.write(q_name)
            if args.query_type == "match-count":
                counts = (
                    batch_counts[qi]
                    if batch_counts is not None
                    else inv.query_match_count(q)
                )
                out.write("\t" + "\t".join(str(int(c)) for c in counts))
            else:
                if batch_any is not None:
                    hits = np.flatnonzero(batch_any[qi])
                elif args.query_type == "all-bins":
                    hits = inv.all_shared_bins(q)
                else:
                    hits = inv.any_shared_bins(q)
                if hits.size:
                    out.write("\t" + ",".join(inv.sample_names[int(h)] for h in hits))
            out.write("\n")
        if out is not sys.stdout:
            out.close()

    elif args.inverted_command == "serve":
        from .inverted.serve import serve_forever

        inv = Inverted.load(strip_sketch_extension(args.ski))
        serve_forever(inv, args.host, args.port)

    elif args.inverted_command == "precluster":
        from .dist import api, output as dist_output
        from .formats import skd as skd_io
        from .runtime import select_engine

        if args.count and args.skd:
            # clap: the "mode" ArgGroup is exclusive (cli.rs:416-420)
            raise SystemExit("--count and --skd are mutually exclusive")
        if args.count and args.core_acc:
            raise SystemExit("--core-acc needs --skd, not --count")
        input_prefix = strip_sketch_extension(args.ski)
        inv = Inverted.load(input_prefix)
        if args.count:
            from .runtime import select_inverted_engine

            proc_id, n_proc, multiproc = _resolve_ranks(args)
            n = len(inv.sample_names)
            row_range = None
            if multiproc:
                from .shard.distributed import triangle_row_slice

                row_range = triangle_row_slice(n, proc_id, n_proc)
            count = inv.any_shared_bin_count(
                engine=select_inverted_engine(inv), row_range=row_range
            )
            if multiproc:
                # aggregate across processes when the jax.distributed
                # runtime spans them; otherwise report the rank partial
                try:
                    import jax

                    if jax.process_count() == n_proc:
                        from jax.experimental import multihost_utils

                        count = int(
                            multihost_utils.process_allgather(
                                np.int64(count)
                            ).sum()
                        )
                        if proc_id == 0:
                            print(
                                f"Identified {count} prefilter pairs from "
                                f"a max of {n * (n - 1) // 2}"
                            )
                    else:
                        raise RuntimeError("no spanning runtime")
                except Exception:
                    print(
                        f"Identified {count} prefilter pairs in rows "
                        f"[{row_range.start}, {row_range.stop}) of {n} "
                        f"(rank {proc_id}/{n_proc} partial; sum ranks "
                        f"for the total)"
                    )
            else:
                print(
                    f"Identified {count} prefilter pairs from a max of "
                    f"{n * (n - 1) // 2}"
                )
        elif args.skd:
            proc_id, n_proc, multiproc = _resolve_ranks(args)
            if multiproc and args.output:
                from .shard.distributed import shard_prefix

                args.output = shard_prefix(args.output, proc_id)
                log.info("Multi-process precluster: rank %d/%d writing %s",
                         proc_id, n_proc, args.output)
            out = _ostream(args.output)
            skq_bins = skd_io.read_all_skq(f"{input_prefix}.skq")
            ref_name = strip_sketch_extension(args.skd)
            references = MultiSketch.load_metadata(ref_name)
            references.read_sketch_data(ref_name)
            n = references.number_samples_loaded()
            knn = args.knn
            if knn >= n:
                log.warning("knn=%d is higher than number of samples=%d", knn, n)
                knn = n - 1
            if args.core_acc:
                # extension: the reference leaves core/accessory precluster
                # unimplemented (distances/mod.rs:548-550)
                if args.ani:
                    raise SystemExit(
                        "--core-acc and --ani are mutually exclusive"
                    )
                if len(references.kmer_lengths) < 2:
                    raise SystemExit(
                        "--core-acc needs at least two k-mer lengths in "
                        "the .skd"
                    )
                # k-mer used for the prefilter must still exist in the .skd
                api.set_k(references, inv.kmer_size, False)
                dist_type = api.DistType()
                log.info(
                    "Preclustering with k=%d, ranking by core/accessory "
                    "over k=%s", inv.kmer_size, references.kmer_lengths,
                )
            else:
                dist_type = api.set_k(references, inv.kmer_size, args.ani)
            ref_comp = (
                io_inputs.read_completeness_file(
                    args.ref_completeness_file, references
                )
                if args.ref_completeness_file
                else None
            )
            from .runtime import select_knn_engine

            # both the single-device and mesh-sharded engines implement
            # the fused-prefilter scan (PreclusterKnnMixin), so a
            # multi-chip host engages every chip on this path
            knn_engine = select_knn_engine(references, dist_type)
            pc_rows = None
            if multiproc:
                from .shard.distributed import process_slice

                pc_rows = process_slice(n, proc_id, n_proc)
            if knn_engine is not None:
                log.info("Using on-device preclustered kNN engine")
                rows = knn_engine.precluster_knn(
                    inv, skq_bins, knn, dist_type, args.retain_unmatched,
                    row_range=pc_rows,
                    completeness_vec=ref_comp,
                    completeness_cutoff=args.completeness_cutoff,
                )
            else:
                rows = api.self_dists_knn_precluster(
                    references,
                    inv,
                    skq_bins,
                    inv.sketch_size,
                    knn,
                    dist_type,
                    ref_comp,
                    args.completeness_cutoff,
                    args.retain_unmatched,
                    engine=select_engine(references),
                    row_range=pc_rows,
                )
            names = [references.sketch_name(i) for i in range(n)]
            row_names = names[pc_rows] if pc_rows is not None else names
            dist_output.write_sparse(out, row_names, names, rows,
                                     coreacc=dist_type.coreacc)
            if out is not sys.stdout:
                out.close()
        else:
            raise SystemExit("one of --skd or --count is required")


def _info_main(args) -> None:
    from .formats.skm import MultiSketch
    from .inverted.index import Inverted

    name = args.skm_file
    if name.endswith(".ski"):
        inv = Inverted.load(name[:-4])
        if args.sample_info:
            print(inv.display_str())
        else:
            print(inv.debug_str())
    else:
        ms = MultiSketch.load_metadata(strip_sketch_extension(name))
        if args.sample_info:
            print(ms.display_str())
        else:
            print(ms.debug_str())


if __name__ == "__main__":
    sys.exit(main())
