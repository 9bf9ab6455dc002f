"""Host-scaling efficiency harness (BASELINE.json: >=80% at 1 -> N hosts).

Measures the rank-sharded distance paths end-to-end: a synthetic sketch DB
is built once, then for each process count N the harness launches N
`sketchtpu.cli dist ... --n-processes N --process-id r` workers (the same
manual-orchestration route a real N-host deployment uses — each rank
computes its pair-balanced triangle_row_slice and writes a .partN file),
times the slowest rank, and reports speedup / parallel efficiency vs the
single-process run.

On one host the N ranks start at once, and each would open a GPU: rank r
gets CUDA_VISIBLE_DEVICES=r (the r-th visible card), and N larger than the
number of visible cards is refused. With JAX_PLATFORMS=cpu or
--backend host the ranks share the CPU instead, which only validates the
harness and the per-rank work split. Across hosts the ranks are
independent processes with no inter-host communication on this path
(shard/distributed.py:triangle_row_slice), so the only efficiency losses
are the pair-split imbalance (<=1 row) and the per-rank fixed startup.

Usage:
  python bench/scaling.py --samples 2000 --mode knn --procs 1,2,4
  python bench/scaling.py --mode dense --kmers 17 --procs 1,2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def build_db(tmp: Path, n: int, sketch_size: int, kmers: list[int]) -> str:
    """Synthesize a sketch DB with random bit-planes (distance throughput
    does not depend on sign values)."""
    sys.path.insert(0, str(REPO))
    import numpy as np

    from sketchtpu.formats.skd import SketchDataWriter
    from sketchtpu.formats.skm import MultiSketch
    from sketchtpu.sketchcore.sketch import HashType, Sketch, num_bins

    s64, _bins, usize = num_bins(sketch_size)
    rng = np.random.default_rng(0)
    prefix = str(tmp / "db")
    sketches = []
    with SketchDataWriter(f"{prefix}.skd") as w:
        for i in range(n):
            usigs = rng.integers(
                0, 1 << 62, size=len(kmers) * usize, dtype=np.uint64
            )
            sk = Sketch(
                name=f"s{i}",
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
    MultiSketch(sketches, sketch_size, kmers, HashType("dna")).save_metadata(
        prefix
    )
    return prefix


def visible_cards() -> list[str]:
    """IDs of the GPUs this process may hand to ranks, without opening
    any of them (the parent stays off JAX)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, check=True).stdout
    except (FileNotFoundError, subprocess.CalledProcessError):
        return []
    return [str(i) for i, line in enumerate(out.splitlines())
            if line.startswith("GPU ")]


def run_ranks(prefix: str, tmp: Path, mode: str, kmers: list[int],
              knn: int, n_procs: int, backend: str) -> tuple[float, float]:
    """Launch n_procs CLI ranks; return (slowest total wall, slowest
    post-import compute window). The compute window — written by each rank
    via SKETCHTPU_COMPUTE_WINDOW_FILE — excludes interpreter + module
    import, a fixed per-process cost that real N-host deployments amortise
    over hours of work; reporting both makes the efficiency artifact
    defensible on small probe runs."""
    args = ["dist", prefix, "-o", str(tmp / f"out_{n_procs}.txt"), "--quiet"]
    if mode == "knn":
        args += ["--knn", str(knn)]
    if mode in ("dense", "knn") and len(kmers) == 1:
        args += ["-k", str(kmers[0])]
    on_cards = backend != "host" and os.environ.get("JAX_PLATFORMS") != "cpu"
    cards = visible_cards() if on_cards else []
    if on_cards and n_procs > len(cards):
        raise SystemExit(
            f"{n_procs} ranks need {n_procs} GPUs (one process per card); "
            f"{len(cards)} visible"
        )
    procs = []
    t0 = time.time()
    for r in range(n_procs):
        wfile = tmp / f"window_{n_procs}_{r}.json"
        env = dict(
            os.environ,
            SKETCHTPU_BACKEND=backend,
            SKETCHTPU_COMPUTE_WINDOW_FILE=str(wfile),
        )
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        if on_cards:
            env["CUDA_VISIBLE_DEVICES"] = cards[r]
        cmd = [sys.executable, "-m", "sketchtpu.cli", *args]
        if n_procs > 1:
            cmd += ["--n-processes", str(n_procs), "--process-id", str(r)]
        procs.append(
            (subprocess.Popen(cmd, cwd=tmp, env=env, stderr=subprocess.PIPE),
             time.time(), wfile)
        )
    worst = worst_c = 0.0
    for p, ts, wfile in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(err.decode()[-2000:])
        worst = max(worst, time.time() - ts)
        try:
            worst_c = max(worst_c, json.loads(wfile.read_text())["compute_s"])
        except Exception:
            worst_c = worst  # window file missing: fall back to wall
    return max(worst, time.time() - t0), worst_c


def format_pool_bench(workers_list: list[int], n_chunks: int = 64,
                      rows_per_chunk: int = 20000) -> None:
    """OutputPipeline format-stage scaling: measure lines/s into a null
    sink with 1..N pool workers formatting synthetic distance chunks (the
    native GIL-releasing line assembly). On a single-core rig this prints
    ~flat rates; on a multi-core host it measures how the output stage
    scales with workers."""
    sys.path.insert(0, str(REPO))
    import io

    import numpy as np

    from sketchtpu.dist.opipe import OutputPipeline
    from sketchtpu.dist.output import _name_table, format_lines_bytes
    from sketchtpu._native import get_lib

    if get_lib() is None:
        print("format-pool bench skipped: native lib unavailable")
        return
    names = [f"sample_{i:06d}" for i in range(4096)]
    tab = _name_table(names)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4096, n_chunks * rows_per_chunk).astype(np.int32)
    cols = rng.integers(0, 4096, n_chunks * rows_per_chunk).astype(np.int32)
    dist = rng.random(n_chunks * rows_per_chunk).astype(np.float32)

    class _Null:
        def __init__(self):
            self.buffer = self

        def write(self, b):
            return len(b)

        def flush(self):
            pass

    def chunk_task(c0: int) -> bytes:
        s = slice(c0 * rows_per_chunk, (c0 + 1) * rows_per_chunk)
        return format_lines_bytes(tab, tab, rows[s], cols[s], dist[s], None)

    total_lines = n_chunks * rows_per_chunk
    print("\n  format-pool (OutputPipeline, null sink)")
    print("  workers  wall(s)   Mlines/s  speedup")
    base = None
    for w in workers_list:
        for c in range(2):  # warm page cache / JIT-free, take 2nd
            t0 = time.time()
            with OutputPipeline(_Null(), workers=w) as pipe:
                for ci in range(n_chunks):
                    pipe.submit(chunk_task, ci)
            dt = time.time() - t0
        if base is None:
            base = dt
        print(f"  {w:>7}  {dt:7.2f}  {total_lines/dt/1e6:9.2f}  "
              f"{base/dt:7.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=int, default=1500)
    ap.add_argument("--sketch-size", type=int, default=1000)
    ap.add_argument("--kmers", default="17,21,25,29",
                    help="comma k list; one k => single-k Jaccard")
    ap.add_argument("--mode", choices=["dense", "knn"], default="knn")
    ap.add_argument("--knn", type=int, default=50)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--backend", default=os.environ.get(
        "SKETCHTPU_BACKEND", "device"))
    ap.add_argument("--format-pool", default="1,2,4,8",
                    help="worker counts for the format-pool microbench; "
                         "empty string skips it")
    a = ap.parse_args()
    kmers = [int(x) for x in a.kmers.split(",")]
    procs_list = [int(x) for x in a.procs.split(",")]

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        prefix = build_db(tmp, a.samples, a.sketch_size, kmers)
        n_pairs = a.samples * (a.samples - 1) // 2
        rows = []
        t_first = tc_first = p_first = None
        for np_ in procs_list:
            t, tc = run_ranks(
                prefix, tmp, a.mode, kmers, a.knn, np_, a.backend
            )
            if t_first is None:
                t_first, tc_first, p_first = t, tc, np_
            # speedup/efficiency relative to the FIRST config (ideally 1);
            # compute-only excludes interpreter+jax import per rank
            speedup = t_first / t
            eff = speedup * p_first / np_
            eff_c = (tc_first / tc) * p_first / np_
            rows.append((np_, t, tc, speedup, eff, eff_c))
            print(json.dumps({
                "bench": "scaling",
                "mode": a.mode,
                "samples": a.samples,
                "procs": np_,
                "wall_s": round(t, 3),
                "compute_s": round(tc, 3),
                "pairs": n_pairs,
                "pair_rate": round(n_pairs / t, 1),
                "speedup": round(speedup, 3),
                "efficiency": round(eff, 3),
                "efficiency_compute": round(eff_c, 3),
            }))
        print("\n  procs  wall(s)  compute(s)  speedup  eff(total)  eff(compute)")
        for np_, t, tc, s, e, ec in rows:
            print(f"  {np_:>5}  {t:7.2f}  {tc:10.2f}  {s:7.2f}  "
                  f"{e:9.1%}  {ec:11.1%}")
        print(
            "\neff(compute) removes the per-rank interpreter+jax import."
        )

    if a.format_pool:
        format_pool_bench([int(x) for x in a.format_pool.split(",")])


if __name__ == "__main__":
    main()
