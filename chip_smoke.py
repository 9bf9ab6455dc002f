#!/usr/bin/env python3
"""Smoke check: sketchtpu's main path, end to end, on one NVIDIA GPU.

    python3 chip_smoke.py           # every phase on one card
    python3 chip_smoke.py --four    # the sharded dist and precluster path
                                    # on four cards, and its host oracle

Drives the CLI (`sketchtpu.cli.main`) in this one process, with
SKETCHTPU_BACKEND=device so the device engines run whatever the size, and
checks every result against the host NumPy/f64 oracle. Every input comes
from --seed; widths follow PopPUNK's database defaults (k = 13..29 step 4,
sketch size 10000). A failed check or phase stops the script with a
non-zero exit. Phase timings are smoke timings, not benchmark numbers. The
last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
KMERS = [13, 17, 21, 25, 29]
SKETCH = 10000
KNN = 50
ORACLE_ROWS = 256

_compile_s = [0.0]
_phases: list[str] = []


def _on_duration(event: str, duration: float, **_) -> None:
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


@contextlib.contextmanager
def phase(name: str):
    c0, t0 = _compile_s[0], time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    _phases.append(
        f"smoke timing: phase={name} status=ok "
        f"compile_s={_compile_s[0] - c0:.1f} "
        f"wall_s={time.perf_counter() - t0:.1f}"
    )
    print(_phases[-1], flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def cli(backend: str, *argv: str) -> str:
    """Run `sketchtpu <argv>` in this process; returns its stdout."""
    import io

    from sketchtpu.cli import main

    os.environ["SKETCHTPU_BACKEND"] = backend
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([*argv, "--quiet"])
    check(rc in (0, None), f"{backend}: sketchtpu {' '.join(argv[:2])}")
    return out.getvalue()


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def preflight(count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {devices[0].platform}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")
    from sketchtpu.runtime import enable_compilation_cache

    enable_compilation_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    print(f"device_kind: {devices[0].device_kind}; jax {jax.__version__}; "
          f"{len(devices)} device(s)")
    print(f"nvidia-smi: {card()}", flush=True)
    return devices


def rfile(path: Path, rows: list[tuple[str, ...]]) -> str:
    path.write_text("".join("\t".join(r) + "\n" for r in rows))
    return str(path)


def skd_rows(prefix: str) -> dict[str, bytes]:
    from sketchtpu.formats.skd import read_all_skd
    from sketchtpu.formats.skm import MultiSketch

    ms = MultiSketch.load_metadata(prefix)
    flat = read_all_skd(f"{prefix}.skd")
    rows = flat.reshape(ms.number_samples_loaded(), -1)
    return {ms.sketch_name(i): rows[i].tobytes() for i in range(len(rows))}


def same_files(a: str, b: str) -> bool:
    return Path(a).read_bytes() == Path(b).read_bytes()


# --- phases ----------------------------------------------------------------


def sketch_dna(tmp: Path, seed: int, n: int = 64,
               length: tuple[int, int] = (2_000_000, 2_300_000)) -> None:
    from sketchtpu import synth

    rng = np.random.default_rng(seed)
    genomes = synth.clustered_genomes(n, length, seed, n_clusters=8)
    rows = []
    for i, g in enumerate(genomes):
        path = tmp / f"asm{i}.fa.gz"
        synth.write_fasta(path, g, f"asm{i}", int(rng.integers(1, 60)))
        rows.append((f"asm{i}", str(path)))
    k = ",".join(map(str, KMERS))
    cli("device", "sketch", "-f", rfile(tmp / "asm.txt", rows),
        "-o", str(tmp / "asm_dev"), "-k", k, "-s", str(SKETCH))
    cli("host", "sketch", "-f", rfile(tmp / "asm8.txt", rows[::8]),
        "-o", str(tmp / "asm_host"), "-k", k, "-s", str(SKETCH))
    dev, host = skd_rows(str(tmp / "asm_dev")), skd_rows(str(tmp / "asm_host"))
    check(len(dev) == n and len(host) == len(rows[::8]),
          f"{n} assemblies sketched")
    check(all(dev[name] == host[name] for name in host),
          f"assembly .skd rows byte-identical to the host backend "
          f"({len(host)} of {n})")


def sketch_reads_aa(tmp: Path, seed: int, genome_len: int = 1_000_000,
                    n_proteins: int = 2000) -> None:
    from sketchtpu import synth

    genomes = synth.clustered_genomes(2, (genome_len, genome_len), seed + 1)
    rows = []
    for i, g in enumerate(genomes):
        r1, r2 = synth.write_paired_reads(tmp / f"reads{i}", g, 20, seed + i)
        rows.append((f"reads{i}", r1, r2))
    rf = rfile(tmp / "reads.txt", rows)
    k = ",".join(map(str, KMERS))
    for be in ("device", "host"):
        cli(be, "sketch", "-f", rf, "-o", str(tmp / f"reads_{be}"), "-k", k,
            "-s", str(SKETCH), "--min-count", "5", "--min-qual", "20")
    check(same_files(f"{tmp}/reads_device.skd", f"{tmp}/reads_host.skd")
          and same_files(f"{tmp}/reads_device.skm", f"{tmp}/reads_host.skm"),
          "paired-read .skd/.skm byte-identical to the host backend")

    prots = synth.clustered_proteomes(16, n_proteins, seed + 2)
    rows = []
    for i, p in enumerate(prots):
        path = tmp / f"prot{i}.faa"
        synth.write_proteome(path, p, f"prot{i}")
        rows.append((f"prot{i}", str(path)))
    rf = rfile(tmp / "prot.txt", rows)
    for be in ("device", "host"):
        cli(be, "sketch", "-f", rf, "-o", str(tmp / f"aa_{be}"),
            "--seq-type", "aa", "--level", "level1", "-k", "7,9,11",
            "-s", "1000")
    check(same_files(f"{tmp}/aa_device.skd", f"{tmp}/aa_host.skd")
          and same_files(f"{tmp}/aa_device.skm", f"{tmp}/aa_host.skm"),
          "proteome (AA level 1, multi-k) sketches byte-identical to host")


def _planes(prefix: str):
    from sketchtpu.formats.skm import MultiSketch

    ms = MultiSketch.load_metadata(prefix)
    ms.read_sketch_data(prefix)
    return ms, [np.ascontiguousarray(ms.bins_matrix(k))
                for k in range(len(ms.kmer_lengths))]


def oracle_samebits(planes, rows: np.ndarray) -> list[np.ndarray]:
    """Per k, (len(rows), n) exact samebits from the host NumPy oracle,
    in threads over row chunks."""
    from sketchtpu.dist.jaccard_np import samebits_matrix

    chunks = [rows[i : i + 8] for i in range(0, rows.size, 8)]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return [
            np.concatenate(list(pool.map(
                lambda r, p=p: samebits_matrix(p[r], p), chunks)))
            for p in planes
        ]


def oracle_coreacc(ms, sbs) -> tuple[np.ndarray, np.ndarray]:
    from sketchtpu.dist.jaccard_np import (
        core_acc_from_jaccards,
        jaccard_from_samebits,
    )

    j = np.stack([jaccard_from_samebits(sb.ravel(), ms.sketchsize64)
                  for sb in sbs], axis=1)
    core, acc = core_acc_from_jaccards(j, ms.kmer_lengths, ms.sketch_size)
    return core.reshape(sbs[0].shape), acc.reshape(sbs[0].shape)


def dense_rows(path: str, n: int, rows: np.ndarray) -> dict[int, list[bytes]]:
    """Upper-triangle long-form output: the lines of the given rows, read
    in one pass (row i holds n - 1 - i lines)."""
    want = sorted(int(r) for r in rows)
    starts = {r: r * (n - 1) - r * (r - 1) // 2 for r in want}
    out: dict[int, list[bytes]] = {}
    with open(path, "rb") as f:
        line_no = 0
        it = iter(want)
        r = next(it, None)
        for line in f:
            while r is not None and line_no >= starts[r] + n - 1 - r:
                r = next(it, None)
            if r is None:
                break
            if line_no >= starts[r]:
                out.setdefault(r, []).append(line.rstrip(b"\n"))
            line_no += 1
    return out


def sketch_db(tmp: Path, n: int, seed: int) -> str:
    from sketchtpu import synth

    db = str(tmp / f"db{n}_{seed}")
    if not Path(f"{db}.skm").exists():
        synth.write_sketch_db(db, n, KMERS, SKETCH, seed)
    return db


def dist_dense(tmp: Path, seed: int, n: int, rng,
               single_k: bool = True) -> None:
    db = sketch_db(tmp, n, seed)
    ms, planes = _planes(db)
    names = [ms.sketch_name(i) for i in range(n)]
    rows = np.sort(rng.choice(n, min(n, ORACLE_ROWS), replace=False))
    sbs = oracle_samebits(planes, rows)
    if single_k:
        dense_single_k(tmp, db, ms, names, rows, sbs)

    # core/accessory: f32 on the device. No matrix product is involved (no
    # dot, einsum or matmul), so TF32 does not come into it; differences
    # come only from f32 log/exp and summation order on the GPU, within
    # the 2e-4 absolute tolerance of tests/test_coreacc_device.py
    cli("device", "dist", db, "-o", str(tmp / "dense_ca.txt"))
    got = dense_rows(str(tmp / "dense_ca.txt"), n, rows)
    core, acc = oracle_coreacc(ms, sbs)
    short = [int(r) for r in rows if len(got.get(int(r), [])) != n - 1 - r]
    check(not short, f"dense core/accessory at N={n}: every sampled row "
          f"holds all its pairs (short rows: {short[:5]})")
    worst = 0.0
    for li, r in enumerate(rows):
        lines = got.get(int(r), [])
        vals = np.array([ln.split(b"\t")[2:] for ln in lines],
                        dtype=np.float64).reshape(-1, 2)
        worst = max(worst, float(np.abs(vals[:, 0] - core[li, r + 1 :])
                                 .max(initial=0)),
                    float(np.abs(vals[:, 1] - acc[li, r + 1 :]).max(initial=0)))
    check(worst <= 2e-4, f"dense core/accessory at N={n}: {rows.size} rows "
          f"within 2e-4 of the host f64 oracle (max |diff| {worst:.2e})")


def dense_single_k(tmp: Path, db: str, ms, names, rows, sbs) -> None:
    """Single k through the strip engine: exact, so byte-identical text."""
    from sketchtpu.dist.jaccard_np import jaccard_from_samebits
    from sketchtpu.dist.output import fmt_f32

    n = len(names)
    cli("device", "dist", db, "-k", "17", "-o", str(tmp / "dense_k17.txt"))
    got = dense_rows(str(tmp / "dense_k17.txt"), n, rows)
    ki = KMERS.index(17)
    bad = 0
    for li, r in enumerate(rows):
        j = jaccard_from_samebits(sbs[ki][li, r + 1 :], ms.sketchsize64)
        d = (1.0 - j).astype(np.float32)
        want = [f"{names[r]}\t{names[c]}\t{fmt_f32(v)}".encode()
                for c, v in zip(range(r + 1, n), d)]
        bad += got.get(int(r), []) != want
    check(bad == 0, f"dense -k 17 at N={n}: {rows.size} rows byte-identical "
          "to the host f64 oracle")


def dist_knn(tmp: Path, seed: int, n: int, rng) -> None:
    db = sketch_db(tmp, n, seed)
    ms, planes = _planes(db)
    rows = np.sort(rng.choice(n, min(n, ORACLE_ROWS), replace=False))
    names = [ms.sketch_name(i) for i in range(n)]
    cli("device", "dist", db, "--knn", str(KNN), "-o", str(tmp / "knn.txt"))
    got: dict[str, list[tuple[str, float, float]]] = {}
    want_rows = {names[r] for r in rows}
    with open(tmp / "knn.txt") as f:
        for line in f:
            a, b, c, x = line.split("\t")
            if a in want_rows:
                got.setdefault(a, []).append((b, float(c), float(x)))
    core, acc = oracle_coreacc(ms, oracle_samebits(planes, rows))
    bad = worst = 0
    for li, r in enumerate(rows):
        d = core[li].copy()
        d[r] = np.inf
        sel = np.argsort(d, kind="stable")[:KNN]  # (f32 distance, column)
        want = [names[c] for c in sel]
        have = got.get(names[r], [])
        bad += [h[0] for h in have] != want
        if len(have) == KNN:
            worst = max(worst, max(abs(h[1] - core[li, c]) + abs(h[2] - acc[li, c])
                                   for h, c in zip(have, sel)))
    check(bad == 0, f"core/accessory --knn {KNN} at N={n}: neighbour lists "
          f"of {ORACLE_ROWS} rows identical to the host oracle (pairs, order)")
    check(worst <= 2e-4, f"--knn values within 2e-4 (max {worst:.2e})")


def inverted(tmp: Path, seed: int, n: int = 1024, length: int = 200_000,
             count_only: bool = False) -> None:
    from sketchtpu import synth

    genomes = synth.clustered_genomes(n, (length, length), seed + 3,
                                      n_clusters=32)
    rows = []
    for i, g in enumerate(genomes):
        path = tmp / f"g{i}.fa.gz"
        synth.write_fasta(path, g, f"g{i}")
        rows.append((f"g{i}", str(path)))
    rf = rfile(tmp / "inv.txt", rows)
    for be in ("device", "host"):
        cli(be, "inverted", "build", "-f", rf, "-o", str(tmp / f"inv_{be}"),
            "-s", "100", "-k", "17", "--write-skq")
    check(same_files(f"{tmp}/inv_device.ski", f"{tmp}/inv_host.ski")
          and same_files(f"{tmp}/inv_device.skq", f"{tmp}/inv_host.skq"),
          f"inverted build of {n} genomes: .ski/.skq byte-identical to host")
    ski = f"{tmp}/inv_device.ski"
    runs = [("count", ["inverted", "precluster", ski, "--count"])]
    if not count_only:
        qf = rfile(tmp / "q.txt", rows[::64])
        cli("device", "sketch", "-f", rf, "-o", str(tmp / "invdb"), "-k", "17",
            "-s", "1000")
        runs = [
            ("match-count", ["inverted", "query", ski, "-f", qf,
                             "--query-type", "match-count"]),
            *runs,
            ("precluster-knn", ["inverted", "precluster", ski, "--skd",
                                str(tmp / "invdb"), "--knn", str(KNN)]),
        ]
    for label, argv in runs:
        outs = []
        for be in ("device", "host"):
            path = tmp / f"{label}_{be}.txt"
            stdout = cli(be, *argv, "-o", str(path))
            outs.append(stdout + (path.read_text() if path.exists() else ""))
        check(len(outs[0]) > 0 and outs[0] == outs[1],
              f"inverted {label}: output byte-identical to host")


def kernels(rng) -> None:
    import jax
    import jax.numpy as jnp

    from sketchtpu.dist.jaccard_np import samebits_matrix
    from sketchtpu.dist.samebits_triton import samebits_triton, word_major
    from sketchtpu.synth import clustered_sketch_planes

    n = 4096
    for sketch_size in (1000, SKETCH):
        planes = np.concatenate(list(
            clustered_sketch_planes(n, [17], sketch_size, 7)))[:, 0]
        s64 = planes.shape[1] // 14
        u32 = np.ascontiguousarray(planes).view(np.uint32)
        a_t = word_major(jnp.asarray(u32))
        t0 = time.perf_counter()
        compiled = jax.jit(
            lambda x, y, s=s64: samebits_triton(x, y, s)
        ).lower(a_t, a_t).compile()
        dt = time.perf_counter() - t0
        got = np.asarray(compiled(a_t, a_t))
        rows = rng.choice(n, 64, replace=False)
        check(np.array_equal(got[rows], samebits_matrix(planes[rows], planes)),
              f"samebits_triton {n}x{n} s64={s64} (compile {dt:.1f}s) equals "
              "samebits_matrix on 64 rows")
        print(f"  memory_analysis s64={s64}: {compiled.memory_analysis()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its oracle")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    count = 4 if args.four else 1
    if not args.four:
        # one card: the engines take the single-device path
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    with phase("preflight"):
        devices = preflight(count)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tmp = Path(td)
        if args.four:
            with phase("dist-four"):
                dist_knn(tmp, args.seed, 12288, rng)
                dist_dense(tmp, args.seed, 12288, rng, single_k=False)
            with phase("precluster-count-four"):
                inverted(tmp, args.seed, count_only=True)
        else:
            with phase("sketch-dna"):
                sketch_dna(tmp, args.seed)
            with phase("sketch-reads-aa"):
                sketch_reads_aa(tmp, args.seed)
            with phase("dist"):
                dist_dense(tmp, args.seed, 4096, rng)
                dist_knn(tmp, args.seed + 1, 12288, rng)
            stats = devices[0].memory_stats() or {}
            print(f"peak_bytes_in_use after dist: "
                  f"{stats.get('peak_bytes_in_use', 'not reported')}")
            with phase("inverted"):
                inverted(tmp, args.seed)
            with phase("kernels"):
                kernels(rng)
    for line in _phases:
        print(line)
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
