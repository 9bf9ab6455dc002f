"""End-to-end CLI fuzz: random genomes driven through the real CLI under
each backend (host / device) and codec path (native / pure-Python). Every
artifact (.skd/.skm/.ski/.skq) and every stdout surface must agree
byte-for-byte across backends — the CLI-level analogue of
test_fuzz_parity (which fuzzes the backends directly)."""

import gzip
import os

import numpy as np
import pytest

from sketchtpu.cli import main


def _write_fasta_gz(path, rng, n_contigs, lo, hi):
    """Random-contig gzipped FASTA with occasional N runs (window breaks)."""
    with gzip.open(path, "wt") as f:
        for c in range(n_contigs):
            n = int(rng.integers(lo, hi))
            seq = rng.choice(list("ACGT"), size=n)
            # sprinkle N runs to exercise break handling
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, n))
                ln = int(rng.integers(1, 30))
                seq[p : p + ln] = "N"
            f.write(f">contig_{c}\n")
            s = "".join(seq)
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")


def _make_inputs(tmp_path, rng, n_samples):
    rfile = tmp_path / "rfile.txt"
    with open(rfile, "w") as f:
        for i in range(n_samples):
            p = tmp_path / f"g{i}.fa.gz"
            _write_fasta_gz(
                p, rng, int(rng.integers(1, 4)), 3_000, 30_000
            )
            f.write(f"g{i}\t{p}\n")
    return str(rfile)


def _run(capsys, *argv):
    assert main(list(argv)) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("seed", range(3))
def test_cli_backend_ab(seed, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(1000 + seed)
    monkeypatch.chdir(tmp_path)
    rfile = _make_inputs(tmp_path, rng, int(rng.integers(3, 6)))
    kmers = sorted(
        rng.choice(np.arange(9, 32, 2), size=rng.integers(1, 4), replace=False)
        .tolist()
    )
    kstr = ",".join(str(k) for k in kmers)
    sketch_size = int(rng.choice([100, 500]))

    outs = {}
    for be in ("host", "device"):
        monkeypatch.setenv("SKETCHTPU_BACKEND", be)
        _run(capsys, "sketch", "-f", rfile, "-o", f"db_{be}", "-k", kstr,
             "-s", str(sketch_size), "--quiet")
        # no -k selects core/accessory, which (like the reference's panic,
        # jaccard.rs:70-72) errors on a single-k db — pick Jaccard there
        sel = [] if len(kmers) > 1 else ["-k", str(kmers[0])]
        dense = _run(capsys, "dist", f"db_{be}", *sel, "--quiet")
        knn = _run(capsys, "dist", f"db_{be}", *sel, "--knn", "2", "--quiet")
        ani = (
            _run(capsys, "dist", f"db_{be}", "-k", str(kmers[0]), "--ani",
                 "--quiet")
            if len(kmers) == 1
            else ""
        )
        outs[be] = (dense, knn, ani)

    assert (tmp_path / "db_host.skd").read_bytes() == (
        tmp_path / "db_device.skd"
    ).read_bytes(), seed
    assert (tmp_path / "db_host.skm").read_bytes() == (
        tmp_path / "db_device.skm"
    ).read_bytes(), seed
    assert outs["host"][0] == outs["device"][0], (seed, "dense")
    # kNN: pair sets identical; distances equal (both exact at this scale)
    assert outs["host"][1] == outs["device"][1], (seed, "knn")
    assert outs["host"][2] == outs["device"][2], (seed, "ani")


@pytest.mark.parametrize("seed", range(2))
def test_cli_inverted_backend_ab(seed, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(2000 + seed)
    monkeypatch.chdir(tmp_path)
    rfile = _make_inputs(tmp_path, rng, int(rng.integers(3, 6)))
    k = int(rng.choice([15, 17, 21]))
    ssize = int(rng.choice([50, 100]))

    outs = {}
    for be in ("host", "device"):
        monkeypatch.setenv("SKETCHTPU_BACKEND", be)
        _run(capsys, "inverted", "build", "-f", rfile, "-o", f"inv_{be}",
             "-s", str(ssize), "-k", str(k), "--write-skq", "--quiet")
        q = _run(capsys, "inverted", "query", f"inv_{be}.ski", "-f", rfile,
                 "--query-type", "match-count", "--quiet")
        pc = _run(capsys, "inverted", "precluster", f"inv_{be}.ski",
                  "--count", "--quiet")
        # precluster --skd takes a standard sketch db at the ski's k
        _run(capsys, "sketch", "-f", rfile, "-o", f"db_{be}", "-k", str(k),
             "-s", "100", "--quiet")
        pk = _run(capsys, "inverted", "precluster", f"inv_{be}.ski",
                  "--skd", f"db_{be}", "--knn", "2", "--quiet")
        outs[be] = (q, pc, pk)

    assert (tmp_path / "inv_host.ski").read_bytes() == (
        tmp_path / "inv_device.ski"
    ).read_bytes(), seed
    assert (tmp_path / "inv_host.skq").read_bytes() == (
        tmp_path / "inv_device.skq"
    ).read_bytes(), seed
    for i, surface in enumerate(("query", "precluster-count", "precluster-knn")):
        assert outs["host"][i] == outs["device"][i], (seed, surface)


def test_cli_no_native_ab(tmp_path, monkeypatch, capsys):
    """Pure-Python parsers/codecs must produce byte-identical artifacts."""
    rng = np.random.default_rng(3000)
    monkeypatch.chdir(tmp_path)
    rfile = _make_inputs(tmp_path, rng, 3)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    for tag, no_native in (("nat", "0"), ("py", "1")):
        monkeypatch.setenv("SKETCHTPU_NO_NATIVE", no_native)
        _run(capsys, "sketch", "-f", rfile, "-o", f"db_{tag}", "-k", "17",
             "-s", "100", "--quiet")
        _run(capsys, "inverted", "build", "-f", rfile, "-o", f"inv_{tag}",
             "-s", "50", "-k", "17", "--quiet")
    monkeypatch.delenv("SKETCHTPU_NO_NATIVE")
    assert (tmp_path / "db_nat.skd").read_bytes() == (
        tmp_path / "db_py.skd"
    ).read_bytes()
    assert (tmp_path / "db_nat.skm").read_bytes() == (
        tmp_path / "db_py.skm"
    ).read_bytes()
    assert (tmp_path / "inv_nat.ski").read_bytes() == (
        tmp_path / "inv_py.ski"
    ).read_bytes()
