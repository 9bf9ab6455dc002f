"""Multi-host orchestration: sharded sketching must merge byte-identically.

Runs the per-process shard driver for each rank in one process (rank
behaviour depends only on (process_index, process_count)), then merges and
compares against a direct single-process sketch of the full input list.
"""

import numpy as np
import pytest

from sketchtpu.constants import num_bins
from sketchtpu.formats.skm import MultiSketch
from sketchtpu.sketchcore.pipeline import sketch_files
from sketchtpu.sketchcore.sketch import HashType
from sketchtpu.shard.distributed import (
    merge_shards,
    process_slice,
    sketch_shard,
)


def test_process_slice_partitions():
    for n in (1, 5, 7, 8, 100):
        for p in (1, 2, 3, 8):
            slices = [process_slice(n, i, p) for i in range(p)]
            covered = []
            for s in slices:
                covered.extend(range(n)[s])
            assert covered == list(range(n))


def test_sharded_sketch_merges_bit_exact(tmp_path, ref_in):
    files = [
        ("R6", [str(ref_in / "R6.fa.gz")]),
        ("TIGR4", [str(ref_in / "TIGR4.fa.gz")]),
        ("s82", [str(ref_in / "14412_3#82.contigs_velvet.fa.gz")]),
        ("s84", [str(ref_in / "14412_3#84.contigs_velvet.fa.gz")]),
    ]
    kmers = [17, 21]
    seq_type = HashType("dna")
    _, bins, _ = num_bins(100)

    direct = tmp_path / "direct"
    sketches = sketch_files(
        str(direct), files, False, kmers, bins, seq_type, True, 0, 20
    )
    MultiSketch(sketches, bins, kmers, seq_type).save_metadata(str(direct))

    sharded = tmp_path / "sharded"
    nproc = 3
    for rank in range(nproc):
        sketch_shard(
            str(sharded),
            files,
            rank,
            nproc,
            concat_fasta=False,
            kmers=kmers,
            sketch_bins=bins,
            seq_type=seq_type,
            rc=True,
            min_count=0,
            min_qual=20,
        )
    merge_shards(str(sharded), nproc)

    assert (sharded.with_suffix(".skd")).read_bytes() == (
        direct.with_suffix(".skd")
    ).read_bytes()
    m1 = MultiSketch.load_metadata(str(sharded))
    m2 = MultiSketch.load_metadata(str(direct))
    assert [s.name for s in m1.sketch_metadata] == [
        s.name for s in m2.sketch_metadata
    ]
    assert [s.index for s in m1.sketch_metadata] == [
        s.index for s in m2.sketch_metadata
    ]
    m1.read_sketch_data(str(sharded))
    m2.read_sketch_data(str(direct))
    np.testing.assert_array_equal(m1.sketch_bins, m2.sketch_bins)


def test_cli_sharded_sketch(tmp_path, ref_in, monkeypatch):
    """`sketch --process-id I --n-processes N` per rank, then rank 0 merges
    (run last here so every shard exists); result is byte-identical to an
    unsharded CLI sketch."""
    from sketchtpu.cli import main as cli_main

    rfile = tmp_path / "rfile.txt"
    rfile.write_text(
        f"R6\t{ref_in}/R6.fa.gz\nTIGR4\t{ref_in}/TIGR4.fa.gz\n"
        f"s82\t{ref_in}/14412_3#82.contigs_velvet.fa.gz\n"
    )
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    base = ["sketch", "-f", str(rfile), "-k", "17", "-s", "100"]
    cli_main(base + ["-o", str(tmp_path / "direct")])
    for rank in (1, 2, 0):  # rank 0 last -> auto-merge
        cli_main(
            base
            + ["-o", str(tmp_path / "shard"), "--process-id", str(rank),
               "--n-processes", "3"]
        )
    assert (tmp_path / "shard.skd").read_bytes() == (
        tmp_path / "direct.skd"
    ).read_bytes()
    assert not (tmp_path / "shard.part0.skd").exists()


# --- multi-process distances ---


def _write_fasta(path, rng, n):
    seq = rng.choice(list("ACGT"), size=n)
    with open(path, "w") as f:
        f.write(">c1\n")
        f.write("".join(seq) + "\n")


def _make_db(tmp_path, monkeypatch, name, n_samples, seed, kmers="13,17,21"):
    from sketchtpu import cli

    rng = np.random.default_rng(seed)
    rfile = tmp_path / f"{name}.rfile"
    with open(rfile, "w") as f:
        for i in range(n_samples):
            fa = tmp_path / f"{name}_{i}.fa"
            _write_fasta(fa, rng, 4000 + senseless_pad(i))
            f.write(f"{name}{i}\t{fa}\n")
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    assert cli.main([
        "sketch", "-f", str(rfile), "-o", str(tmp_path / name),
        "-k", kmers, "-s", "100", "--quiet",
    ]) in (0, None)
    return str(tmp_path / name)


def senseless_pad(i):
    return 37 * i  # vary lengths a little


def _run_dist(tmp_path, monkeypatch, backend, dist_args, tag):
    """Single-process output vs 2-rank concatenation; returns both."""
    from sketchtpu import cli

    monkeypatch.setenv("SKETCHTPU_BACKEND", backend)
    single = tmp_path / f"{tag}_single.txt"
    assert cli.main(
        ["dist", *dist_args, "-o", str(single), "--quiet"]
    ) in (0, None)
    multi = tmp_path / f"{tag}_multi.txt"
    for rank in range(2):
        assert cli.main(
            ["dist", *dist_args, "-o", str(multi), "--quiet",
             "--n-processes", "2", "--process-id", str(rank)]
        ) in (0, None)
    parts = b"".join(
        open(f"{multi}.part{r}", "rb").read() for r in range(2)
    )
    return open(single, "rb").read(), parts


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_self_dense_coreacc(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 1)
    single, parts = _run_dist(tmp_path, monkeypatch, backend, [db], "ca")
    assert parts == single and single.count(b"\n") == 9 * 8 // 2


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_self_dense_jaccard(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 2)
    single, parts = _run_dist(
        tmp_path, monkeypatch, backend, [db, "-k", "17"], "jac"
    )
    assert parts == single and single.count(b"\n") == 9 * 8 // 2


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_self_knn(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 3)
    single, parts = _run_dist(
        tmp_path, monkeypatch, backend, [db, "-k", "17", "--knn", "3"], "knn"
    )
    assert parts == single


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_self_knn_coreacc(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 4)
    single, parts = _run_dist(
        tmp_path, monkeypatch, backend, [db, "--knn", "3"], "knnca"
    )
    assert parts == single


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_cross_dense(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 7, 5)
    qdb = _make_db(tmp_path, monkeypatch, "qdb", 5, 6)
    single, parts = _run_dist(
        tmp_path, monkeypatch, backend, [db, qdb, "-k", "17"], "xd"
    )
    assert parts == single and single.count(b"\n") == 7 * 5


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_cross_knn(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 7, 7)
    qdb = _make_db(tmp_path, monkeypatch, "qdb", 5, 8)
    single, parts = _run_dist(
        tmp_path, monkeypatch, backend, [db, qdb, "-k", "17", "--knn", "3"],
        "xknn",
    )
    assert parts == single


def test_triangle_row_slice_covers():
    from sketchtpu.shard.distributed import triangle_row_slice

    for n in (0, 1, 2, 9, 100, 6610):
        for p in (1, 2, 3, 8):
            slices = [triangle_row_slice(n, i, p) for i in range(p)]
            covered = []
            for s in slices:
                covered.extend(range(n)[s])
            assert covered == list(range(n)), (n, p)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", [[], ["-k", "17"], ["--knn", "2"],
                                  ["-k", "17", "--knn", "2"]])
def test_multiprocess_more_ranks_than_rows(tmp_path, monkeypatch, backend,
                                           mode):
    """More processes than samples: surplus ranks must write empty parts
    (not crash), and the concatenation still matches (found by review:
    DeviceKnnEngine.self_knn_coreacc raised on an empty row slice)."""
    from sketchtpu import cli

    db = _make_db(tmp_path, monkeypatch, "tiny", 3, 9)
    monkeypatch.setenv("SKETCHTPU_BACKEND", backend)
    single = tmp_path / "s.txt"
    assert cli.main(["dist", db, *mode, "-o", str(single), "--quiet"]) in (0, None)
    multi = tmp_path / "m.txt"
    for rank in range(5):
        assert cli.main(
            ["dist", db, *mode, "-o", str(multi), "--quiet",
             "--n-processes", "5", "--process-id", str(rank)]
        ) in (0, None)
    parts = b"".join(
        open(f"{multi}.part{r}", "rb").read() for r in range(5)
    )
    assert parts == open(single, "rb").read()


def test_live_two_process_sketch_and_count(tmp_path):
    """REAL jax.distributed integration: two subprocesses with a
    coordinator. Exercises the auto rank detection
    (JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES/JAX_PROCESS_ID), the
    sync_global_devices barrier before the rank-0 sketch merge, and the
    precluster --count process_allgather sum."""
    import gzip
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    repo = str(Path(__file__).resolve().parent.parent)
    pypath = repo + os.pathsep + os.environ.get("PYTHONPATH", "")

    rng = np.random.default_rng(77)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = alphabet[rng.integers(0, 4, 4000)]
    genomes = []
    for i in range(6):
        seq = base.copy()
        muts = rng.integers(0, seq.size, 40 * (i % 3))
        seq[muts] = alphabet[rng.integers(0, 4, muts.size)]
        p = tmp_path / f"g{i}.fa.gz"
        with gzip.open(p, "wb") as f:
            f.write(b">r0\n" + seq.tobytes() + b"\n")
        genomes.append(str(p))

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def run_pair(args):
        procs = []
        for pid in range(2):
            env = dict(
                os.environ,
                PYTHONPATH=pypath,
                JAX_PLATFORMS="cpu",
                JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                JAX_NUM_PROCESSES="2",
                JAX_PROCESS_ID=str(pid),
                SKETCHTPU_BACKEND="host",
            )
            env.pop("XLA_FLAGS", None)
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "sketchtpu.cli", *args],
                    env=env,
                    cwd=tmp_path,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                )
            )
        outs = [p.communicate(timeout=240) for p in procs]
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, se.decode()[-2000:]
        return outs

    # single-process oracle (in-process main would lock jax platforms;
    # use a subprocess for isolation)
    env1 = dict(os.environ, PYTHONPATH=pypath, JAX_PLATFORMS="cpu",
                SKETCHTPU_BACKEND="host")
    env1.pop("XLA_FLAGS", None)
    subprocess.run(
        [sys.executable, "-m", "sketchtpu.cli", "sketch", "--k-vals", "17",
         "-s", "100", *genomes, "-o", "single", "--quiet"],
        env=env1, cwd=tmp_path, check=True, capture_output=True, timeout=240,
    )
    run_pair(["sketch", "--k-vals", "17", "-s", "100", *genomes, "-o",
              "multi", "--quiet"])
    for ext in (".skd", ".skm"):
        a = (tmp_path / f"single{ext}").read_bytes()
        b = (tmp_path / f"multi{ext}").read_bytes()
        assert a == b, ext

    # precluster --count with a spanning runtime: ranks psum their
    # partials, rank 0 prints the global total
    subprocess.run(
        [sys.executable, "-m", "sketchtpu.cli", "inverted", "build",
         *genomes, "-o", "inv", "-k", "17", "-s", "12", "--quiet"],
        env=env1, cwd=tmp_path, check=True, capture_output=True, timeout=240,
    )
    single = subprocess.run(
        [sys.executable, "-m", "sketchtpu.cli", "inverted", "precluster",
         "inv.ski", "--count", "--quiet"],
        env=env1, cwd=tmp_path, check=True, capture_output=True, timeout=240,
    ).stdout.decode()
    outs = run_pair(["inverted", "precluster", "inv.ski", "--count",
                     "--quiet"])
    rank0_out = outs[0][0].decode()
    assert single.strip() in rank0_out, (single, rank0_out)

    # live inverted build: barrier + rank-0 merge byte-identical
    run_pair(["inverted", "build", *genomes, "-o", "inv2", "-k", "17",
              "-s", "12", "--write-skq", "--quiet"])
    subprocess.run(
        [sys.executable, "-m", "sketchtpu.cli", "inverted", "build",
         *genomes, "-o", "inv2s", "-k", "17", "-s", "12", "--write-skq",
         "--quiet"],
        env=env1, cwd=tmp_path, check=True, capture_output=True, timeout=240,
    )
    for ext in (".ski", ".skq"):
        assert (tmp_path / f"inv2{ext}").read_bytes() == (
            tmp_path / f"inv2s{ext}"
        ).read_bytes(), ext
