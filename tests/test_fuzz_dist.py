"""Randomized distance-driver fuzz at the CLI level: on random genome
sets / sketch sizes / k sets, the distance surfaces must agree with each
other the way the reference guarantees (tests/distance.rs:388-687):

- kNN rows = the knn smallest entries of the dense self matrix,
- cross(db, db) off-diagonal = dense self, diagonal = 0,
- --subset output = the corresponding rows of the full dense output,
- completeness correction = the documented per-pair formula applied to
  the uncorrected Jaccard (jaccard.rs:36-57), cutoff semantics included.
"""

import gzip

import numpy as np
import pytest

from sketchtpu.cli import main


def run(*argv):
    assert main(list(argv)) == 0


def _write_fasta(path, rng, length):
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    with gzip.open(path, "wb") as f:
        f.write(b">r0\n")
        f.write(alphabet[rng.integers(0, 4, length)].tobytes() + b"\n")


def _parse_pairs(path):
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            out[(parts[0], parts[1])] = tuple(float(x) for x in parts[2:])
    return out


@pytest.fixture()
def wd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    return tmp_path


@pytest.mark.parametrize("seed", range(4))
def test_dist_surfaces_consistent(wd, seed):
    rng = np.random.default_rng(2000 + seed)
    ngen = int(rng.integers(5, 10))
    genomes = []
    for i in range(ngen):
        name = f"g{i}.fa.gz"
        _write_fasta(wd / name, rng, int(rng.integers(1500, 5000)))
        genomes.append(name)

    s = int(rng.choice([64, 156, 288]))
    single_k = int(rng.choice([15, 17, 21]))
    run("sketch", "--k-vals", str(single_k), "-s", str(s), *genomes, "-o",
        "db", "--quiet")

    run("dist", "db", "-k", str(single_k), "-o", "dense.txt", "--quiet")
    dense = _parse_pairs(wd / "dense.txt")
    assert len(dense) == ngen * (ngen - 1) // 2

    # kNN distances per row match the dense row's smallest knn
    knn = int(rng.integers(1, ngen - 1))
    run("dist", "db", "-k", str(single_k), "--knn", str(knn), "-o",
        "knn.txt", "--quiet")
    knn_rows = {}
    for (a, b), v in _parse_pairs(wd / "knn.txt").items():
        knn_rows.setdefault(a, []).append(v[0])
    names = [g for g in genomes]
    for nm in names:
        row = sorted(
            v[0] for (a, b), v in dense.items() if nm in (a, b)
        )[:knn]
        got = sorted(knn_rows.get(nm, []))
        assert np.allclose(got, row, atol=1e-6), (nm, got, row)

    # cross(db, db): off-diagonal equals dense (symmetric), diagonal = 0
    run("dist", "db", "db", "-k", str(single_k), "-o", "cross.txt", "--quiet")
    cross = _parse_pairs(wd / "cross.txt")
    assert len(cross) == ngen * ngen
    for (a, b), v in cross.items():
        if a == b:
            assert v[0] == 0.0
        else:
            want = dense.get((a, b), dense.get((b, a)))
            assert np.isclose(v[0], want[0], atol=1e-6)

    # subset = the matching rows of the dense output
    sub_n = int(rng.integers(2, ngen))
    subset = sorted(rng.choice(genomes, size=sub_n, replace=False).tolist())
    with open("subset.txt", "w") as f:
        for nm in subset:
            f.write(nm + "\n")
    run("dist", "db", "-k", str(single_k), "--subset", "subset.txt", "-o",
        "sub.txt", "--quiet")
    sub = _parse_pairs(wd / "sub.txt")
    assert len(sub) == sub_n * (sub_n - 1) // 2
    for (a, b), v in sub.items():
        want = dense.get((a, b), dense.get((b, a)))
        assert np.isclose(v[0], want[0], atol=1e-6)

    # completeness correction: J' = min(J / (c1*c2/(c1+c2-c1*c2)), 1) when
    # c1*c2 >= cutoff, else J unchanged (jaccard.rs:36-57)
    comp = {g: float(rng.uniform(0.5, 1.0)) for g in genomes}
    with open("comp.txt", "w") as f:
        for g, c in comp.items():
            f.write(f"{g}\t{c}\n")
    cutoff = float(rng.choice([0.0, 0.64, 0.9]))
    run("dist", "db", "-k", str(single_k), "--ref-completeness-file",
        "comp.txt", "--completeness-cutoff", str(cutoff), "-o", "corr.txt",
        "--quiet")
    corr = _parse_pairs(wd / "corr.txt")
    for (a, b), v in corr.items():
        j = 1.0 - dense.get((a, b), dense.get((b, a)))[0]
        c1, c2 = comp[a], comp[b]
        if c1 * c2 >= cutoff:
            j = min(j / (c1 * c2 / (c1 + c2 - c1 * c2)), 1.0)
        want = np.float32(1.0 - j)
        assert np.isclose(v[0], want, atol=1e-6), ((a, b), v[0], want)


@pytest.mark.parametrize("seed", range(3))
def test_multiprocess_concat_matches_fuzz(wd, seed, monkeypatch):
    """Random mode/backend/process-count: the rank-ordered concatenation
    of .partN outputs must equal the single-process output bytes."""
    rng = np.random.default_rng(4000 + seed)
    ngen = int(rng.integers(6, 12))
    genomes = []
    for i in range(ngen):
        name = f"g{i}.fa.gz"
        _write_fasta(wd / name, rng, int(rng.integers(1500, 5000)))
        genomes.append(name)
    run("sketch", "--k-vals", "13,17,21", "-s", "100", *genomes, "-o",
        "db", "--quiet")

    backend = ["host", "device"][int(rng.integers(0, 2))]
    monkeypatch.setenv("SKETCHTPU_BACKEND", backend)
    mode = [
        [],                       # dense coreacc
        ["-k", "17"],             # dense jaccard
        ["-k", "17", "--ani"],    # dense ani
        ["--knn", "2"],           # knn coreacc
        ["-k", "17", "--knn", "2"],
        ["db", "-k", "17"],       # cross dense (db vs itself)
        ["db", "-k", "17", "--knn", "2"],
    ][int(rng.integers(0, 7))]
    n_proc = int(rng.integers(2, 5))

    run("dist", "db", *mode, "-o", "single.txt", "--quiet")
    for r in range(n_proc):
        run("dist", "db", *mode, "-o", "multi.txt", "--quiet",
            "--n-processes", str(n_proc), "--process-id", str(r))
    parts = b"".join(
        open(f"multi.txt.part{r}", "rb").read() for r in range(n_proc)
    )
    assert parts == open("single.txt", "rb").read(), (seed, mode, n_proc)


def _related_fastas(wd, rng, ngen):
    """Genomes sharing fragments so inverted bins overlap."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = alphabet[rng.integers(0, 4, 4000)]
    names = []
    for i in range(ngen):
        seq = base.copy()
        muts = rng.integers(0, base.size, 40 * (i % 4))
        seq[muts] = alphabet[rng.integers(0, 4, muts.size)]
        name = f"g{i}.fa.gz"
        with gzip.open(wd / name, "wb") as f:
            f.write(b">r0\n" + seq.tobytes() + b"\n")
        names.append(name)
    return names


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("retain", [None, "singleton", "bruteforce"])
def test_multiprocess_precluster_concat(wd, seed, retain, monkeypatch):
    """inverted precluster --skd with --n-processes: rank-ordered part
    concatenation equals the single-process output, incl. retain-unmatched
    singleton/bruteforce and padding semantics."""
    rng = np.random.default_rng(5000 + seed)
    genomes = _related_fastas(wd, rng, int(rng.integers(7, 12)))
    run("inverted", "build", "-o", "inv", "-k", "17", "-s", "12",
        *genomes, "--write-skq", "--quiet")
    run("sketch", "--k-vals", "17", "-s", "100", *genomes, "-o", "db",
        "--quiet")

    backend = ["host", "device"][int(rng.integers(0, 2))]
    monkeypatch.setenv("SKETCHTPU_BACKEND", backend)
    extra = ["--retain-unmatched", retain] if retain else []
    run("inverted", "precluster", "--knn", "2", "--skd", "db", "inv.ski",
        *extra, "-o", "single.txt", "--quiet")
    n_proc = int(rng.integers(2, 4))
    for r in range(n_proc):
        run("inverted", "precluster", "--knn", "2", "--skd", "db", "inv.ski",
            *extra, "-o", "multi.txt", "--quiet",
            "--n-processes", str(n_proc), "--process-id", str(r))
    parts = b"".join(
        open(f"multi.txt.part{r}", "rb").read() for r in range(n_proc)
    )
    assert parts == open("single.txt", "rb").read(), (seed, retain, backend)


@pytest.mark.parametrize("qtype", ["match-count", "any-bins", "all-bins"])
def test_multiprocess_inverted_query_concat(wd, qtype, monkeypatch):
    """inverted query with --n-processes: header only on rank 0, query rows
    sharded; concatenation equals the single-process output. Also an A/B:
    the single-process run goes through the device equality-tile engine
    (match_counts/any_shared_rows/all_shared_rows) while the sharded runs
    use the host loop, so the concat equality doubles as engine parity."""
    rng = np.random.default_rng(6000)
    genomes = _related_fastas(wd, rng, 8)
    run("inverted", "build", "-o", "inv", "-k", "17", "-s", "12",
        *genomes, "--quiet")
    monkeypatch.setenv("SKETCHTPU_BACKEND", "device")
    run("inverted", "query", "inv.ski", *genomes, "--query-type", qtype,
        "-o", "single.txt", "--quiet")
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    for r in range(3):
        run("inverted", "query", "inv.ski", *genomes, "--query-type", qtype,
            "-o", "multi.txt", "--quiet",
            "--n-processes", "3", "--process-id", str(r))
    parts = b"".join(
        open(f"multi.txt.part{r}", "rb").read() for r in range(3)
    )
    assert parts == open("single.txt", "rb").read()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multiprocess_precluster_count_partials(wd, backend, monkeypatch,
                                                capsys):
    """--count with --n-processes: rank partial counts sum to the
    single-process total (each pair counted at its smaller index)."""
    import re

    rng = np.random.default_rng(7000)
    genomes = _related_fastas(wd, rng, 9)
    run("inverted", "build", "-o", "inv", "-k", "17", "-s", "12",
        *genomes, "--quiet")
    monkeypatch.setenv("SKETCHTPU_BACKEND", backend)
    run("inverted", "precluster", "--count", "inv.ski", "--quiet")
    single = int(re.search(r"Identified (\d+)",
                           capsys.readouterr().out).group(1))
    total = 0
    for r in range(3):
        run("inverted", "precluster", "--count", "inv.ski", "--quiet",
            "--n-processes", "3", "--process-id", str(r))
        total += int(re.search(r"Identified (\d+)",
                               capsys.readouterr().out).group(1))
    assert total == single and single > 0


@pytest.mark.parametrize("retain", [None, "singleton", "bruteforce"])
def test_precluster_coreacc_cli(wd, retain, monkeypatch):
    """`inverted precluster --core-acc` (extension; the reference leaves
    core/accessory precluster unimplemented, distances/mod.rs:548-550):
    host and device backends agree on pairs exactly and values to f32
    tolerance; multi-process parts concatenate to the single run."""
    rng = np.random.default_rng(7100)
    genomes = _related_fastas(wd, rng, 9)
    run("inverted", "build", "-o", "inv", "-k", "17", "-s", "12",
        *genomes, "--write-skq", "--quiet")
    run("sketch", "--k-vals", "17,21,25", "-s", "100", *genomes, "-o",
        "db", "--quiet")

    extra = ["--retain-unmatched", retain] if retain else []
    outs = {}
    for be in ("host", "device"):
        monkeypatch.setenv("SKETCHTPU_BACKEND", be)
        run("inverted", "precluster", "--knn", "3", "--skd", "db",
            "inv.ski", "--core-acc", *extra, "-o", f"ca_{be}.txt",
            "--quiet")
        outs[be] = _parse_pairs(wd / f"ca_{be}.txt")
    assert outs["host"].keys() == outs["device"].keys()
    assert outs["host"], "expected at least one preclustered pair"
    for pair, hv in outs["host"].items():
        tv = outs["device"][pair]
        np.testing.assert_allclose(tv, hv, atol=2e-4)

    # multi-process rank concatenation (host backend)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    for r in range(3):
        run("inverted", "precluster", "--knn", "3", "--skd", "db",
            "inv.ski", "--core-acc", *extra, "-o", "multi.txt", "--quiet",
            "--n-processes", "3", "--process-id", str(r))
    parts = b"".join(
        open(f"multi.txt.part{r}", "rb").read() for r in range(3)
    )
    assert parts == open("ca_host.txt", "rb").read()


def test_completeness_coreacc_device_cli(wd, monkeypatch):
    """Completeness-corrected core/accessory runs engage the device
    engines (dense tile + kNN) instead of falling back to the host;
    values agree with the host f64 pipeline to f32 tolerance and pair
    sets match."""
    rng = np.random.default_rng(8200)
    genomes = _related_fastas(wd, rng, 8)
    run("sketch", "--k-vals", "15,17,21", "-s", "100", *genomes, "-o",
        "db", "--quiet")
    with open("comp.tsv", "w") as f:
        for i, _ in enumerate(genomes):
            f.write(f"g{i}\t{0.7 + 0.04 * i:.2f}\n")

    for mode in (["--knn", "3"], []):
        res = {}
        for be in ("host", "device"):
            monkeypatch.setenv("SKETCHTPU_BACKEND", be)
            run("dist", "db", *mode, "--ref-completeness-file", "comp.tsv",
                "-o", f"d_{be}.txt", "--quiet")
            res[be] = _parse_pairs(wd / f"d_{be}.txt")
        assert res["host"].keys() == res["device"].keys(), mode
        for pair, hv in res["host"].items():
            np.testing.assert_allclose(res["device"][pair], hv, atol=2e-4)


def test_cross_dense_coreacc_device_cli(wd, monkeypatch):
    """Dense cross core/accessory on the device tile engine: values agree
    with the host f64 pipeline to f32 tolerance, with and without
    completeness (correction applies only when both sides have files)."""
    rng = np.random.default_rng(9300)
    genomes = _related_fastas(wd, rng, 10)
    run("sketch", "--k-vals", "15,17,21", "-s", "100", *genomes[:6], "-o",
        "dbr", "--quiet")
    run("sketch", "--k-vals", "15,17,21", "-s", "100", *genomes[6:], "-o",
        "dbq", "--quiet")
    with open("rcomp.tsv", "w") as f:
        for i in range(6):
            f.write(f"g{i}\t{0.75 + 0.03 * i:.2f}\n")
    with open("qcomp.tsv", "w") as f:
        for i in range(6, 10):
            f.write(f"g{i}\t{0.8 + 0.04 * (i - 6):.2f}\n")

    for comp in ([], ["--ref-completeness-file", "rcomp.tsv",
                      "--query-completeness-file", "qcomp.tsv"],
                 ["--ref-completeness-file", "rcomp.tsv"]):
        res = {}
        for be in ("host", "device"):
            monkeypatch.setenv("SKETCHTPU_BACKEND", be)
            run("dist", "dbr", "dbq", *comp, "-o", f"x_{be}.txt", "--quiet")
            res[be] = _parse_pairs(wd / f"x_{be}.txt")
        assert res["host"].keys() == res["device"].keys(), comp
        for pair, hv in res["host"].items():
            np.testing.assert_allclose(res["device"][pair], hv, atol=2e-4)


def test_multiprocess_inverted_build(wd, monkeypatch):
    """inverted build --n-processes: rank 0's merged .ski/.skq are
    byte-identical to a single-process build, incl. multi-file samples
    (rows stay whole on one rank) and species-label reordering."""
    rng = np.random.default_rng(9900)
    genomes = _related_fastas(wd, rng, 11)
    with open("rfile.txt", "w") as f:
        for i, g in enumerate(genomes[:9]):
            f.write(f"s{i}\t{g}\n")
        # one multi-file sample (bin-min merge + deferred densify)
        f.write(f"s1\t{genomes[9]}\n")
        f.write(f"s8\t{genomes[10]}\n")
    with open("species.tsv", "w") as f:
        for i in range(9):
            f.write(f"s{i}\tspecies{'AB'[i % 2]}\n")

    for extra, tag in (
        ([], "plain"),
        (["--species-names", "species.tsv"], "lab"),
    ):
        run("inverted", "build", "-f", "rfile.txt", "-o", f"single_{tag}",
            "-k", "17", "-s", "12", "--write-skq", *extra, "--quiet")
        for r in (1, 2, 0):  # rank 0 last: it merges once parts exist
            run("inverted", "build", "-f", "rfile.txt", "-o",
                f"multi_{tag}", "-k", "17", "-s", "12", "--write-skq",
                *extra, "--quiet", "--n-processes", "3",
                "--process-id", str(r))
        for ext in (".ski", ".skq"):
            a = open(f"single_{tag}{ext}", "rb").read()
            b = open(f"multi_{tag}{ext}", "rb").read()
            assert a == b, (tag, ext)


def test_multiprocess_inverted_build_empty_rank(wd, monkeypatch):
    """More ranks than samples: empty ranks write empty shards and the
    merge still reproduces the single-process files byte-identically."""
    rng = np.random.default_rng(9950)
    genomes = _related_fastas(wd, rng, 3)
    run("inverted", "build", *genomes, "-o", "single", "-k", "17", "-s",
        "12", "--write-skq", "--quiet")
    for r in (1, 2, 3, 4, 0):
        run("inverted", "build", *genomes, "-o", "multi", "-k", "17",
            "-s", "12", "--write-skq", "--quiet", "--n-processes", "5",
            "--process-id", str(r))
    for ext in (".ski", ".skq"):
        assert open(f"single{ext}", "rb").read() == open(
            f"multi{ext}", "rb").read(), ext


def test_completeness_singlek_knn_device_cli(wd, monkeypatch):
    """Single-k kNN and precluster with completeness run on the device
    engine; printed values equal the host path (exact f64 recompute from
    the selected samebits), pair sets match."""
    rng = np.random.default_rng(8600)
    genomes = _related_fastas(wd, rng, 9)
    run("sketch", "--k-vals", "17", "-s", "100", *genomes, "-o", "db",
        "--quiet")
    run("inverted", "build", *genomes, "-o", "inv", "-k", "17", "-s",
        "12", "--write-skq", "--quiet")
    with open("comp.tsv", "w") as f:
        for i, _ in enumerate(genomes):
            f.write(f"g{i}\t{0.72 + 0.03 * i:.2f}\n")

    for cmd in (
        ["dist", "db", "--knn", "3", "-k", "17",
         "--ref-completeness-file", "comp.tsv"],
        ["dist", "db", "--knn", "3", "--ani", "-k", "17",
         "--ref-completeness-file", "comp.tsv"],
        ["inverted", "precluster", "inv.ski", "--skd", "db", "--knn", "3",
         "--ref-completeness-file", "comp.tsv"],
    ):
        res = {}
        for be in ("host", "device"):
            monkeypatch.setenv("SKETCHTPU_BACKEND", be)
            run(*cmd, "-o", f"o_{be}.txt", "--quiet")
            res[be] = _parse_pairs(wd / f"o_{be}.txt")
        assert res["host"].keys() == res["device"].keys(), cmd
        for pair, hv in res["host"].items():
            np.testing.assert_allclose(res["device"][pair], hv, atol=1e-6)
