"""Samebits tile on the GPU: the Triton kernel against XLA's plain version.

Run on a machine with one NVIDIA GPU:

  python bench/kernel_ab.py            # tiles at 4096 x 4096, s64 = 16, 157
  python bench/kernel_ab.py --sweep    # block sizes, warps and stages
  python bench/kernel_ab.py --e2e      # the dense -k 17 and --knn 50 CLI
                                       # runs with either tile

The results also go, as JSON, into the directory --out names.

Every time is the median of 5 runs, each ended by block_until_ready, after
one compiling run. The card's name and power limit are printed first; keep
them beside every number. Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 4096
WIDTHS = (16, 157)  # s = 1000 and s = 10000 (PopPUNK database default)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_time(fn, *args, runs: int = 5) -> float:
    fn(*args).block_until_ready()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sketch_planes(n: int, s64: int, seed: int) -> np.ndarray:
    """(n, W2) u32 planes in related families, so samebits spans a range
    (the kernel's speed does not depend on the values)."""
    from sketchtpu.constants import BBITS

    rng = np.random.default_rng(seed)
    w2 = s64 * BBITS * 2
    base = rng.integers(0, 2**32, (16, w2), dtype=np.uint64).astype(np.uint32)
    x = base[rng.integers(0, 16, n)]
    flip = rng.random((n, w2)) < rng.uniform(0.0, 0.3, (n, 1))
    noise = rng.integers(0, 2**32, (n, w2), dtype=np.uint64).astype(np.uint32)
    return np.where(flip, noise, x)


def ab(s64: int, **kw) -> dict:
    import jax
    import jax.numpy as jnp

    from sketchtpu.dist.jaccard_jax import _samebits_xla
    from sketchtpu.dist.jaccard_np import samebits_matrix
    from sketchtpu.dist.samebits_triton import samebits_triton, word_major

    a_h = sketch_planes(N, s64, 1)
    a = jnp.asarray(a_h)
    a_t = word_major(a)
    tri = jax.jit(lambda x, y: samebits_triton(x, y, s64, **kw))
    t0 = time.perf_counter()
    compiled = tri.lower(a_t, a_t).compile()
    compile_s = time.perf_counter() - t0
    got = np.asarray(compiled(a_t, a_t))
    rows = np.random.default_rng(0).choice(N, 128, replace=False)
    want = samebits_matrix(a_h[rows].view(np.uint64), a_h.view(np.uint64))
    if not np.array_equal(got[rows], want):
        raise SystemExit(f"s64={s64}: kernel differs from samebits_matrix")
    res = {
        "s64": s64, "n": N, "kernel_compile_s": compile_s,
        "kernel_memory": str(compiled.memory_analysis()),
        "kernel_s": median_time(compiled, a_t, a_t),
    }
    xla = jax.jit(lambda x, y: _samebits_xla(x, y, s64)).lower(a, a).compile()
    res["xla_memory"] = str(xla.memory_analysis())
    res["xla_s"] = median_time(xla, a, a)
    if not np.array_equal(np.asarray(xla(a, a))[rows], want):
        raise SystemExit(f"s64={s64}: XLA tile differs from samebits_matrix")
    for k in ("kernel", "xla"):
        res[f"{k}_gpair_s"] = N * N / res[f"{k}_s"] / 1e9
    return res


def coreacc_ab(s64: int) -> dict:
    """coreacc_tile with XLA's samebits fusion inside against the same
    chain fed by the Triton tile (5 k, 4096 x 4096)."""
    import jax
    import jax.numpy as jnp

    from sketchtpu.dist import jaccard_jax
    from sketchtpu.dist.coreacc_jax import coreacc_tile

    kmers = (13, 17, 21, 25, 29)
    stack = jnp.asarray(np.stack([sketch_planes(N, s64, 10 + k)
                                  for k in range(len(kmers))]))
    res = {"s64": s64, "n": N, "kmers": len(kmers)}
    outs = {}
    for kern in ("triton", "xla"):
        jaccard_jax.samebits_kernel = lambda kern=kern: kern
        jax.clear_caches()
        f = jax.jit(lambda a, b: coreacc_tile(a, b, s64, kmers, s64 * 64))
        outs[kern] = np.asarray(f(stack, stack))
        res[f"coreacc_{kern}_s"] = median_time(f, stack, stack)
        res[f"coreacc_{kern}_gpair_s"] = N * N / res[f"coreacc_{kern}_s"] / 1e9
    res["max_abs_diff"] = float(np.abs(outs["triton"] - outs["xla"]).max())
    return res


def e2e() -> list[dict]:
    """dist -k 17 (dense strip engine, N = 4096) and --knn 50 (core/acc
    kNN engine, N = 12288) at s = 10000, 5 k, through sketchtpu.cli.main:
    median wall of 5 runs after one warm-up, with each tile."""
    import os
    import tempfile

    import jax

    from sketchtpu import synth
    from sketchtpu.cli import main as cli
    from sketchtpu.dist import jaccard_jax

    os.environ["SKETCHTPU_BACKEND"] = "device"
    kmers = [13, 17, 21, 25, 29]
    out = []
    with tempfile.TemporaryDirectory() as td:
        cases = []
        for n, extra in ((4096, ["-k", "17"]), (12288, ["--knn", "50"])):
            db = f"{td}/db{n}"
            synth.write_sketch_db(db, n, kmers, 10000, 0)
            cases.append((n, extra, db))
        for n, extra, db in cases:
            res = {"case": f"dist {' '.join(extra)} N={n} s=10000"}
            for kern in ("triton", "xla", "xla", "triton"):
                jaccard_jax.samebits_kernel = lambda kern=kern: kern
                jax.clear_caches()
                argv = ["dist", db, *extra, "-o", f"{td}/out.txt", "--quiet"]
                cli(argv)  # warm-up: compiles
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    cli(argv)
                    times.append(time.perf_counter() - t0)
                res.setdefault(f"{kern}_s", []).append(
                    statistics.median(times))
            out.append(res)
            print(json.dumps(res), flush=True)
    return out


def sweep(s64: int) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from sketchtpu.dist.samebits_triton import samebits_triton, word_major

    a_t = word_major(jnp.asarray(sketch_planes(N, s64, 1)))
    out = []
    for bm, bn, warps, stages in itertools.product(
        (32, 64, 128), (32, 64, 128), (4, 8), (1, 2, 3)
    ):
        if bm * bn > 128 * 128 or bm * bn < 32 * 64:
            continue
        f = jax.jit(lambda x, y: samebits_triton(
            x, y, s64, bm=bm, bn=bn, num_warps=warps, num_stages=stages))
        t = median_time(f, a_t, a_t)
        out.append({"s64": s64, "bm": bm, "bn": bn, "warps": warps,
                    "stages": stages, "s": t, "gpair_s": N * N / t / 1e9})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out", default="bench_out",
                    help="directory for the JSON results")
    args = ap.parse_args()
    import jax

    from sketchtpu.runtime import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_ab: no GPU found")
    enable_compilation_cache()
    print(f"card: {card()}; jax {jax.__version__}; "
          f"{jax.devices()[0].device_kind}", flush=True)
    results = []
    if args.e2e:
        results = e2e()
    for s64 in () if args.e2e else WIDTHS:
        if args.sweep:
            results += sweep(s64)
        else:
            results += [ab(s64), coreacc_ab(s64)]
            print(json.dumps(results[-2:]), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = ("kernel_sweep.json" if args.sweep
            else "kernel_e2e.json" if args.e2e else "kernel_ab.json")
    (out / name).write_text(json.dumps({"card": card(), "results": results},
                                       indent=1))


if __name__ == "__main__":
    main()
