"""Kernel rates on one NVIDIA GPU.

Measures the hot kernel of every distance mode — the samebits tile (XNOR +
14-plane AND + popcount over b-bit sketch planes, reference
jaccard.rs:6-45) — at the default sketch size (s=1000 -> s64=16), the
5-k core/accessory tile, and multi-k sketching of 14 x 2 Mb genomes.

Every figure is the median of 5 runs after one compiling run; device work
ends in block_until_ready (sketching returns host arrays). The card's name
and power limit are printed beside the numbers. Exits non-zero when JAX
finds no GPU. The last line is one JSON object.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_s(fn, runs: int = 5) -> float:
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    import jax
    import jax.numpy as jnp

    from sketchtpu.runtime import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform}")
    enable_compilation_cache()
    from sketchtpu.dist.coreacc_jax import coreacc_tile
    from sketchtpu.dist.jaccard_jax import _samebits_tile

    hw = card()
    s64 = 16
    w2 = s64 * 14 * 2
    n = 4096
    a = jax.random.bits(jax.random.PRNGKey(0), (n, w2), dtype=jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (n, w2), dtype=jnp.uint32)
    tile = jax.jit(lambda x, y: _samebits_tile(x, y, s64))
    dt = median_s(lambda: tile(a, b).block_until_ready())
    pairs_per_s = n * n / dt
    print(f"[{hw}] samebits tile {n}x{n} (s64={s64}): {dt * 1e3:.3f} ms "
          f"-> {pairs_per_s / 1e9:.3f} G pair/s (median of 5)",
          file=sys.stderr)

    kmers = (13, 17, 21, 25, 29)
    stack = jax.random.bits(jax.random.PRNGKey(2), (len(kmers), n, w2),
                            dtype=jnp.uint32)
    ca = jax.jit(lambda x: coreacc_tile(x, x, s64, kmers, 1024))
    dt_ca = median_s(lambda: ca(stack).block_until_ready())
    print(f"[{hw}] core/accessory tile ({len(kmers)} k): "
          f"{n * n / dt_ca / 1e6:.1f} M pair/s (median of 5)",
          file=sys.stderr)

    from sketchtpu.ingest.fastx import DnaStream
    from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend

    kset = [17, 21, 25]
    r = np.random.default_rng(11)
    streams = [
        DnaStream(
            codes=r.integers(0, 4, 2_000_000).astype(np.uint8),
            breaks=np.zeros(0, dtype=np.int64),
            acgt=np.array([1, 1, 1, 1], dtype=np.int64),
        )
        for _ in range(14)
    ]
    be = DeviceSketchBackend()
    dt_sk = median_s(lambda: be.bin_minima_multi_k(streams, kset, True, 1024))
    print(f"[{hw}] multi-k sketching (14 x 2 Mb genomes, 3 k): "
          f"{dt_sk:.3f} s -> {14 * 2.0 * len(kset) / dt_sk:.1f} Mbase-k/s "
          f"(median of 5)", file=sys.stderr)

    print(json.dumps({
        "metric": "samebits pair comparisons/s (s=1000, one k)",
        "value": pairs_per_s,
        "unit": "pairs/s",
        "card": hw,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
