"""CLI-level golden tests, mirroring the reference's snapbox integration
tests (tests/{sketch,inverted,merge,concat,delete}.rs)."""

import os
import shutil

import numpy as np
import pytest

from sketchtpu.cli import main

GENOMES = [
    "14412_3#82.contigs_velvet.fa.gz",
    "14412_3#84.contigs_velvet.fa.gz",
    "R6.fa.gz",
    "TIGR4.fa.gz",
]


@pytest.fixture()
def wd(tmp_path, ref_in, monkeypatch):
    for g in GENOMES:
        shutil.copy(ref_in / g, tmp_path / g)
    shutil.copy(ref_in / "rfile.txt", tmp_path / "rfile.txt")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    return tmp_path


def run(*argv):
    assert main(list(argv)) == 0


def test_sketch_info_goldens(wd, ref_correct, capsys):
    run("sketch", "--k-vals", "31", GENOMES[0], GENOMES[1], "-o", "assembly",
        "--quiet")
    run("info", "assembly.skm")
    got = capsys.readouterr().out
    want = (ref_correct / "assembly_sketch_info.stdout").read_text()
    assert got.splitlines()[1:] == want.splitlines()[1:]  # line 0 has version
    run("info", "--sample-info", "assembly.skm")
    got = capsys.readouterr().out
    want = (ref_correct / "assembly_sketch_full_info.stdout").read_text()
    assert got == want.replace("[..]", "")


def test_fastq_sketch_goldens(wd, ref_in, ref_correct, capsys):
    with open("fq_rfile.txt", "w") as f:
        for p in ("test_1", "test_2"):
            f.write(
                f"{p}\t{ref_in}/{p}_fwd.fastq.gz\t{ref_in}/{p}_rev.fastq.gz\n"
            )
    run("sketch", "-f", "fq_rfile.txt", "-o", "reads", "--min-count", "2",
        "-k", "9", "--min-qual", "2", "--quiet")
    run("info", "--sample-info", "reads")
    got = capsys.readouterr().out
    assert got == (ref_correct / "read_sketch_full_info.stdout").read_text()


def test_fastq_three_files_fails(wd, ref_in):
    with open("bad_rfile.txt", "w") as f:
        f.write(
            f"test_1\t{ref_in}/test_1_fwd.fastq.gz\t"
            f"{ref_in}/test_1_rev.fastq.gz\tnope.fastq.gz\n"
        )
    with pytest.raises((ValueError, SystemExit)):
        run("sketch", "-f", "bad_rfile.txt", "-o", "readsbad", "--min-count",
            "2", "-k", "9", "--quiet")


def test_merge_append_delete_equivalences(wd):
    run("sketch", "--k-vals", "17", GENOMES[0], GENOMES[1], "-o", "part1",
        "--quiet")
    run("sketch", "--k-vals", "17", GENOMES[2], GENOMES[3], "-o", "part2",
        "--quiet")
    run("sketch", "--k-vals", "17", *GENOMES, "-o", "merged_ref", "--quiet")
    run("merge", "part1", "part2", "-o", "merged_test", "--quiet")
    assert (
        (wd / "merged_test.skd").read_bytes()
        == (wd / "merged_ref.skd").read_bytes()
    )
    with pytest.raises((SystemExit, ValueError)):
        run("merge", "part1", "part1", "-o", "bad", "--quiet")
    # incompatible DBs: the error must NAME the mismatched property
    # (the reference points at the failing check, multisketch.rs:222-226)
    run("sketch", "--k-vals", "21", GENOMES[2], "-o", "otherk", "--quiet")
    with pytest.raises(SystemExit, match=r"k-mer lengths: \[17\] vs \[21\]"):
        run("merge", "part1", "otherk", "-o", "bad2", "--quiet")

    # append: new samples first, then the old db (lib.rs:860-869)
    run("append", "part1", GENOMES[2], GENOMES[3], "-o", "appended", "--quiet")
    run("sketch", "--k-vals", "17", GENOMES[2], GENOMES[3], GENOMES[0],
        GENOMES[1], "-o", "append_ref", "--quiet")
    assert (
        (wd / "appended.skd").read_bytes()
        == (wd / "append_ref.skd").read_bytes()
    )

    with open("del.txt", "w") as f:
        f.write("TIGR4.fa.gz\n")
    run("delete", "merged_ref", "del.txt", "deleted", "--quiet")
    run("sketch", "--k-vals", "17", GENOMES[0], GENOMES[1], GENOMES[2], "-o",
        "delete_ref", "--quiet")
    assert (
        (wd / "deleted.skd").read_bytes()
        == (wd / "delete_ref.skd").read_bytes()
    )


def test_inverted_build_query_precluster(wd, ref_correct, capsys):
    run("inverted", "build", "-o", "inv", "-k", "21", "-s", "10", "-f",
        "rfile.txt", "--write-skq", "--quiet")
    assert (wd / "inv.skq").read_bytes() == (
        ref_correct / "inverted.skq"
    ).read_bytes()

    run("inverted", "query", "-f", "rfile.txt", "inv.ski", "-o", "qc.out",
        "--quiet")
    got = sorted((wd / "qc.out").read_text().splitlines())
    want = sorted(
        (ref_correct / "inverted_query_count.stdout").read_text().splitlines()
    )
    assert got == want

    run("inverted", "precluster", "--count", "inv.ski", "--quiet")
    out = capsys.readouterr().out
    assert "Identified 2 prefilter pairs from a max of 6" in out

    run("sketch", "-o", "standard", "--k-vals", "21", "-s", "1000", "-f",
        "rfile.txt", "--quiet")
    run("inverted", "precluster", "--knn", "1", "--skd", "standard",
        "inv.ski", "-o", "prec.out", "--quiet")
    got = sorted((wd / "prec.out").read_text().splitlines())
    want = sorted(
        (ref_correct / "inverted_precluster.stdout").read_text().splitlines()
    )
    assert got == want

    run("inverted", "precluster", "--knn", "1", "--ani", "--skd", "standard",
        "inv.ski", "-o", "prec_ani.out", "--quiet")
    got = sorted((wd / "prec_ani.out").read_text().splitlines())
    want = sorted(
        (ref_correct / "inverted_precluster_ani.stdout").read_text().splitlines()
    )
    assert got == want


def test_inverted_ski_roundtrip(wd):
    from sketchtpu.inverted.index import Inverted

    run("inverted", "build", "-o", "rt", "-k", "21", "-s", "10", "-f",
        "rfile.txt", "--quiet")
    inv = Inverted.load("rt")
    inv.save("rt2")
    inv2 = Inverted.load("rt2")
    assert np.array_equal(inv.sign_matrix, inv2.sign_matrix)
    assert inv.sample_names == inv2.sample_names
    assert inv.kmer_size == inv2.kmer_size
    assert inv.rc == inv2.rc


def test_convert_pdb_requires_mini3di(wd, tmp_path):
    """--convert-pdb is gated on the optional mini3di package, mirroring
    the reference's '3di' cargo feature (cli.rs:143-146)."""
    import pytest

    from sketchtpu.cli import main as cli_main

    pdb = tmp_path / "x.pdb"
    pdb.write_text("ATOM\n")
    rfile = tmp_path / "rfile.txt"
    rfile.write_text(f"x\t{pdb}\n")
    with pytest.raises((RuntimeError, ImportError), match="mini3di"):
        cli_main(
            ["sketch", "-f", str(rfile), "-o", str(tmp_path / "db"),
             "--seq-type", "pdb", "--convert-pdb", "-k", "5", "-s", "64"]
        )


def test_inverted_query_any_all_goldens(wd, ref_correct):
    """any-bins / all-bins query snapshots (inverted.rs:208-240)."""
    run("inverted", "build", "-o", "inv", "-k", "21", "-s", "10", "-f",
        "rfile.txt", "--quiet")
    for qtype, golden in (
        ("any-bins", "inverted_query_any.stdout"),
        ("all-bins", "inverted_query_all.stdout"),
    ):
        run("inverted", "query", "-f", "rfile.txt", "inv.ski", "-o",
            f"{qtype}.out", "--query-type", qtype, "--quiet")
        got = sorted((wd / f"{qtype}.out").read_text().splitlines())
        want = sorted((ref_correct / golden).read_text().splitlines())
        assert got == want, qtype


def test_inverted_info_goldens(wd, ref_correct, capsys):
    """info on a .ski built from direct args at default sketch size
    (inverted.rs:15-48)."""
    run("inverted", "build", "-o", "inverted", "-k", "31", GENOMES[0],
        GENOMES[1], "--quiet")
    run("info", "inverted.ski")
    got = capsys.readouterr().out
    want = (ref_correct / "inverted_sketch_info.stdout").read_text()
    assert got.splitlines()[1:] == want.splitlines()[1:]  # line 0 has version
    run("info", "--sample-info", "inverted.ski")
    got = capsys.readouterr().out
    want = (ref_correct / "inverted_sketch_full_info.stdout").read_text()
    assert got.splitlines()[1:] == want.splitlines()[1:]


def test_read_sketch_info_golden(wd, ref_in, ref_correct, capsys):
    """Summary info of a read sketch (sketch.rs:50-71)."""
    with open("fq_rfile.txt", "w") as f:
        for p in ("test_1", "test_2"):
            f.write(
                f"{p}\t{ref_in}/{p}_fwd.fastq.gz\t{ref_in}/{p}_rev.fastq.gz\n"
            )
    run("sketch", "-f", "fq_rfile.txt", "-o", "reads", "--min-count", "2",
        "-k", "9", "--min-qual", "2", "--quiet")
    run("info", "reads")
    got = capsys.readouterr().out
    want = (ref_correct / "read_sketch_info.stdout").read_text()
    assert got.splitlines()[1:] == want.splitlines()[1:]  # line 0 has version


def test_inverted_reorder_info_golden(wd, ref_in, ref_correct, capsys):
    """Species-reordered build with k=61, s=63 (inverted.rs:130-166)."""
    run("inverted", "build", "-o", "invr", "-k", "61", "-s", "63",
        "--species-names", str(ref_in / "species_names.txt"),
        GENOMES[0], GENOMES[1], GENOMES[2], GENOMES[3], "--quiet")
    run("info", "invr.ski", "--sample-info")
    got = capsys.readouterr().out
    want = (ref_correct / "inverted_sketch_info_reorder.stdout").read_text()
    assert got.splitlines()[1:] == want.splitlines()[1:]


def test_precluster_with_completeness(wd, ref_correct):
    """Precluster kNN with completeness correction runs and yields valid
    distances, and correction actually changes values
    (completeness.rs:382-460)."""
    run("inverted", "build", "-o", "pci", "-k", "21", "-s", "10",
        "--write-skq", GENOMES[0], GENOMES[1], GENOMES[2], "--quiet")
    run("sketch", "-o", "pcs", "--k-vals", "21", "-s", "1000",
        GENOMES[0], GENOMES[1], GENOMES[2], "--quiet")
    with open("comp.txt", "w") as f:
        f.write(f"{GENOMES[0]}\t0.8\n{GENOMES[1]}\t0.9\n{GENOMES[2]}\t0.7\n")
    run("inverted", "precluster", "pci.ski", "--skd", "pcs", "--knn", "2",
        "--ref-completeness-file", "comp.txt", "-o", "pc_comp.out", "--quiet")
    run("inverted", "precluster", "pci.ski", "--skd", "pcs", "--knn", "2",
        "-o", "pc_plain.out", "--quiet")
    corr = (wd / "pc_comp.out").read_text().splitlines()
    plain = (wd / "pc_plain.out").read_text().splitlines()
    assert len(corr) > 0
    for line in corr:
        d = float(line.split("\t")[2])
        assert np.isfinite(d) and 0.0 <= d <= 1.0
    assert corr != plain  # the correction must have an effect


def test_k_seq_flag(wd):
    """--k-seq start,end,step expands to the same db as the explicit list."""
    run("sketch", "--k-seq", "17,26,4", GENOMES[2], "-o", "kseq", "--quiet")
    run("sketch", "--k-vals", "17,21,25", GENOMES[2], "-o", "klist", "--quiet")
    assert (wd / "kseq.skd").read_bytes() == (wd / "klist.skd").read_bytes()


def test_arg_group_enforcement(tmp_path, monkeypatch):
    """clap ArgGroup semantics: required/exclusive input groups
    (cli.rs:121-126), --ani requires -k (cli.rs:212), precluster mode
    group exclusive (cli.rs:416-420)."""
    import pytest

    from sketchtpu.cli import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "g.fa").write_text(">r0\nACGTACGTACGTACGTACGTACGT\n")
    (tmp_path / "rf.txt").write_text("a\tg.fa\n")
    with pytest.raises(SystemExit, match="provide input"):
        main(["sketch", "-o", "db", "-k", "17", "--quiet"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["sketch", "g.fa", "-f", "rf.txt", "-o", "db", "-k", "17",
              "--quiet"])
    with pytest.raises(SystemExit, match="--ani requires -k"):
        main(["dist", "db", "--ani", "--quiet"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["inverted", "precluster", "x.ski", "--count", "--skd", "db",
              "--quiet"])


def test_warmup_smoke(tmp_path, monkeypatch):
    """`warmup` must drive sketch + every dist mode end-to-end on a tiny
    synthetic configuration (the production cache-priming path; on this
    CPU test backend it exercises the same CLI flows with host engines)."""
    monkeypatch.chdir(tmp_path)
    run(
        "warmup", "-k", "17,21,25", "-s", "64", "--db-size", "64",
        "--genome-sizes", "20000", "--knn", "3",
        "--modes", "sketch,dense,knn,coreacc-dense,coreacc-knn",
    )


def test_warmup_smoke_extended_modes(tmp_path, monkeypatch):
    """Extended warmup modes: reads (FASTQ bucket
    programs), cross (ref-vs-query dense/knn/coreacc/exact), exact
    (self --exact strip engine), inverted (build/query x 3 types/
    precluster count + knn + core-acc) — each drives the real CLI."""
    monkeypatch.chdir(tmp_path)
    run(
        "warmup", "-k", "17,21,25", "-s", "64", "--db-size", "48",
        "--genome-sizes", "20000", "--knn", "3",
        "--query-db-size", "16", "--reads-bases", "200000",
        "--inverted-sketch-size", "32",
        "--modes", "reads,cross,exact,inverted",
    )
