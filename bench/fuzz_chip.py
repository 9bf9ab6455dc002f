"""Randomized host-vs-device A/B fuzz on the GPU.

The CI fuzz suites run on the CPU backend (conftest defaults
JAX_PLATFORMS to cpu); this script drives the CLI end-to-end on the card
across random genome sets and configurations and byte-compares every
artefact and output against the host oracle. Each CLI call is its own
process, one at a time, so only one process holds the card.
Run: `python bench/fuzz_chip.py [iters]`.
"""

import os
import random
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def write_fasta(path: Path, rng, n_contigs, clen, with_n=False):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for c in range(n_contigs):
            f.write(f">c{c}\n".encode())
            seq = bases[rng.integers(0, 4, clen)].tobytes()
            if with_n and clen > 50:
                pos = int(rng.integers(10, clen - 10))
                seq = seq[:pos] + b"N" * int(rng.integers(1, 5)) + seq[pos:]
            f.write(seq + b"\n")


def run_cli(args, backend, cwd):
    env = dict(os.environ, SKETCHTPU_BACKEND=backend,
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "sketchtpu.cli", *args],
        capture_output=True, env=env, cwd=cwd, timeout=900,
    )
    if r.returncode != 0:
        raise RuntimeError(f"{backend} {' '.join(args)}:\n{r.stderr.decode()[-2000:]}")
    return r.stdout


def one_iter(it: int) -> None:
    rng = np.random.default_rng(1000 + it)
    pyr = random.Random(it)
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        n_samples = pyr.choice([3, 5, 9])
        # correlated family: mutate a base genome so core/acc is stable
        base_len = pyr.choice([30_000, 120_000])
        base = rng.integers(0, 4, base_len)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        lines = []
        for s in range(n_samples):
            g = base.copy()
            n_mut = int(base_len * pyr.choice([0.001, 0.01, 0.05]))
            idx = rng.integers(0, base_len, n_mut)
            g[idx] = (g[idx] + rng.integers(1, 4, n_mut)) % 4
            p = tdp / f"s{s}.fa"
            with open(p, "wb") as f:
                n_contigs = pyr.choice([1, 3])
                for ci, chunk in enumerate(np.array_split(g, n_contigs)):
                    f.write(f">c{ci}\n".encode())
                    f.write(bases[chunk].tobytes() + b"\n")
            lines.append(f"s{s}\t{p}")
        (tdp / "rfile.txt").write_text("\n".join(lines) + "\n")

        kmers = pyr.choice(["17", "15,19", "17,21,25,29"])
        ssize = pyr.choice([100, 1000])
        sketch_args = ["sketch", "-f", "rfile.txt", "-o", "db", "-k", kmers,
                       "-s", str(ssize)]
        if pyr.random() < 0.3:
            sketch_args.append("--single-strand")
        for be in ("host", "device"):
            run_cli(sketch_args[:4] + [f"db_{be}"] + sketch_args[5:], be, td)
        skd_h = (tdp / "db_host.skd").read_bytes()
        skd_t = (tdp / "db_device.skd").read_bytes()
        assert skd_h == skd_t, f"iter {it}: .skd mismatch ({sketch_args})"
        assert (tdp / "db_host.skm").read_bytes() == (tdp / "db_device.skm").read_bytes()

        first_k = kmers.split(",")[0]
        dist_modes = [["-k", first_k], ["-k", first_k, "--ani"]]
        knn = str(pyr.choice([1, 2]))
        if "," in kmers and kmers.count(",") >= 2:
            dist_modes.append([])  # dense core/acc: f32 engine, tolerance
            # core/acc kNN: byte-exact (selection f32, values exact f64)
            dist_modes.append(["--knn", knn])
        dist_modes.append(["-k", first_k, "--knn", knn])
        for m in dist_modes:
            outs = {}
            for be in ("host", "device"):
                outs[be] = run_cli(["dist", "db_host", *m], be, td)
            if m == []:  # f32 core/acc engine: tolerance, pair set identical
                def parse(b):
                    rows = [l.split("\t") for l in b.decode().strip().split("\n")]
                    return [r[:2] for r in rows], np.array(
                        [[float(x) for x in r[2:]] for r in rows]
                    )
                ph, vh = parse(outs["host"])
                pt, vt = parse(outs["device"])
                assert ph == pt, f"iter {it}: core/acc pair set"
                assert np.abs(vh - vt).max() < 5e-4, f"iter {it}: core/acc tol"
            else:
                assert outs["host"] == outs["device"], f"iter {it}: dist {m}"

        # inverted build/query A/B on a fresh small index
        inv_args = ["inverted", "build", "-f", "rfile.txt", "-s",
                    str(pyr.choice([50, 100])), "-k", first_k, "--write-skq"]
        for be in ("host", "device"):
            run_cli(inv_args[:4] + ["-o", f"inv_{be}"] + inv_args[4:], be, td)
        assert (tdp / "inv_host.ski").read_bytes() == (tdp / "inv_device.ski").read_bytes(), \
            f"iter {it}: .ski mismatch"
        assert (tdp / "inv_host.skq").read_bytes() == (tdp / "inv_device.skq").read_bytes(), \
            f"iter {it}: .skq mismatch"
        qt = pyr.choice(["match-count", "any-bins", "all-bins"])
        q = {}
        for be in ("host", "device"):
            q[be] = run_cli(["inverted", "query", "inv_host.ski", "-f",
                             "rfile.txt", "--query-type", qt], be, td)
        assert q["host"] == q["device"], f"iter {it}: query {qt}"

        # preclustered kNN over the single-k db (fused prefilter path)
        if "," not in kmers:
            pc = {}
            for be in ("host", "device"):
                pc[be] = run_cli(
                    ["inverted", "precluster", "inv_host.ski", "--skd",
                     "db_host", "--knn", "2"], be, td)
            assert pc["host"], f"iter {it}: precluster produced no output"
            assert pc["host"] == pc["device"], f"iter {it}: precluster"
    print(f"iter {it} OK (n={n_samples} k={kmers} s={ssize})", flush=True)


def one_iter_fastq(it: int) -> None:
    """Reads path: paired FASTQ with quality filtering + count filter."""
    rng = np.random.default_rng(5000 + it)
    pyr = random.Random(500 + it)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        lines = []
        for s in range(2):
            glen = pyr.choice([50_000, 200_000])
            genome = rng.integers(0, 4, glen)
            pair_files = []
            for mate in (1, 2):
                p = tdp / f"s{s}_{mate}.fastq"
                with open(p, "wb") as f:
                    n_reads = glen * pyr.choice([10, 20]) // 150 // 2
                    starts = rng.integers(0, glen - 150, n_reads)
                    for ri, st in enumerate(starts):
                        seq = bases[genome[st : st + 150]].tobytes()
                        # mixed qualities straddling min_qual (default 20,
                        # phred+33 -> '5' = Q20)
                        qual = bytes(
                            int(x)
                            for x in rng.integers(33 + 10, 33 + 40, 150)
                        )
                        f.write(b"@r%d\n%s\n+\n%s\n" % (ri, seq, qual))
                pair_files.append(str(p))
            lines.append(f"s{s}\t" + "\t".join(pair_files))
        (tdp / "rfile.txt").write_text("\n".join(lines) + "\n")
        kmers = pyr.choice(["17", "17,21"])
        mc = pyr.choice(["1", "2", "5"])
        for be in ("host", "device"):
            run_cli(["sketch", "-f", "rfile.txt", "-o", f"db_{be}", "-k",
                     kmers, "-s", "100", "--min-count", mc], be, td)
        assert (tdp / "db_host.skd").read_bytes() == (tdp / "db_device.skd").read_bytes(), \
            f"fastq iter {it}: .skd mismatch (k={kmers} mc={mc})"
        assert (tdp / "db_host.skm").read_bytes() == (tdp / "db_device.skm").read_bytes()
    print(f"fastq iter {it} OK (k={kmers} min_count={mc})", flush=True)


def one_iter_aa(it: int) -> None:
    """Amino-acid path across the three reduced-alphabet levels."""
    rng = np.random.default_rng(7000 + it)
    pyr = random.Random(700 + it)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        lines = []
        for s in range(3):
            p = tdp / f"p{s}.fa"
            with open(p, "wb") as f:
                for c in range(pyr.choice([1, 4])):
                    f.write(f">c{c}\n".encode())
                    seq = aa[rng.integers(0, 20, pyr.choice([5_000, 60_000]))]
                    f.write(seq.tobytes() + b"\n")
            lines.append(f"p{s}\t{p}")
        (tdp / "rfile.txt").write_text("\n".join(lines) + "\n")
        level = pyr.choice(["1", "2", "3"])
        kmers = pyr.choice(["6", "6,9,12"])
        for be in ("host", "device"):
            run_cli(["sketch", "-f", "rfile.txt", "-o", f"db_{be}", "-k",
                     kmers, "-s", "100", "--seq-type", "aa", "--level",
                     f"level{level}"], be, td)
        assert (tdp / "db_host.skd").read_bytes() == (tdp / "db_device.skd").read_bytes(), \
            f"aa iter {it}: .skd mismatch (k={kmers} level={level})"
    print(f"aa iter {it} OK (k={kmers} level={level})", flush=True)


if __name__ == "__main__":
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    for it in range(iters):
        one_iter(it)
    for it in range(max(2, iters // 3)):
        one_iter_fastq(it)
        one_iter_aa(it)
    print(f"all {iters} dna + {max(2, iters // 3)}x(fastq+aa) iterations passed")
