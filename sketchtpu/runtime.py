"""Backend selection: host (NumPy oracle) or device (JAX engines).

The device paths produce bit-identical sketches and samebits counts, so
the choice is a performance decision. SKETCHTPU_BACKEND picks it:
- host: the NumPy paths everywhere;
- device: the device engines on JAX's default platform, whatever the size;
- auto (default): the device engines when that platform is not the CPU and
  the run is large enough to amortise compilation.

Once a device engine is chosen, its errors propagate: nothing falls back
to the host behind the user's back.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger("sketchtpu")

_MODES = ("host", "device", "auto")
_cache_ready = False

# the checkout's own compile cache, used when JAX_COMPILATION_CACHE_DIR is
# unset (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (the hash kernels have
    large unrolled graphs). JAX reads JAX_COMPILATION_CACHE_DIR itself when
    it is set; otherwise the cache lives in the checkout's .jax_cache."""
    global _cache_ready
    if _cache_ready:
        return
    _cache_ready = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_MIN_SAMPLES_FOR_DEVICE_SKETCH = 1
_MIN_SAMPLES_FOR_DEVICE_DIST = 64
_MIN_SAMPLES_FOR_DEVICE_COREACC = 2048
_MIN_SAMPLES_FOR_DEVICE_INVERTED = 512
_MIN_SAMPLES_FOR_DEVICE_KNN = 4096
_MIN_SAMPLES_FOR_DEVICE_DENSE_STREAM = 8192


def _mode() -> str:
    mode = os.environ.get("SKETCHTPU_BACKEND", "auto")
    if mode not in _MODES:
        raise ValueError(
            f"SKETCHTPU_BACKEND={mode!r}: expected one of {', '.join(_MODES)}"
        )
    return mode


def _device_available() -> bool:
    import jax

    return jax.default_backend() != "cpu"


def _use_device(mode: str, n: int, threshold: int) -> bool:
    return mode == "device" or (
        mode == "auto" and n >= threshold and _device_available()
    )


def _multi_device() -> bool:
    import jax

    return len(jax.local_devices()) > 1


def samebits_kernel() -> str:
    """The samebits tile for JAX's default platform: the Triton kernel on
    the GPU, XLA's fusion of the plain version on the CPU (where the tests
    run). Any other platform has no tile."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no samebits tile for platform {platform!r}")


def select_backend(seq_type, n_samples: int):
    """Batched device sketching backend, or None for the host path."""
    if not _use_device(_mode(), n_samples, _MIN_SAMPLES_FOR_DEVICE_SKETCH):
        return None
    if seq_type.kind == "dna":
        from .sketchcore.sketch_jax import DeviceSketchBackend

        return DeviceSketchBackend()
    # aa / pdb (3Di strings hashed as AA level 1)
    from .sketchcore.sketch_aa_jax import DeviceAaSketchBackend

    return DeviceAaSketchBackend()


def select_coreacc_engine(ms, completeness_vec=None,
                          completeness_cutoff: float = 0.64,
                          exact: bool = False):
    """Fully on-device core/accessory engine for large dense runs (f32; the
    exact f64 host pipeline is used for small runs). Completeness
    correction runs on device too, folded into the regression chain of the
    tile (after the samebits psum on the multi-device sharded engine).

    exact=True (`dist --exact`) selects the exact-output stream engine:
    per-k int16 samebits strips on device, the oracle's f64 chain on the
    host — byte-identical output to the host pipeline at a device->host
    transfer and host-format cost (see DeviceCoreAccExactStreamEngine)."""
    mode = _mode()
    if mode == "host" or len(ms.kmer_lengths) < 2:
        return None
    if exact and ms.sketchsize64 * 64 > 32767:
        # not silent: the user asked for --exact and gets the host path
        log.info(
            "--exact: sketch size %d bins exceeds the device exact "
            "engine's int16 samebits range (max 32767 bins); using the "
            "host f64 pipeline (output is identical, just slower)",
            ms.sketchsize64 * 64,
        )
        return None
    n = ms.number_samples_loaded()
    if not _use_device(mode, n, _MIN_SAMPLES_FOR_DEVICE_COREACC):
        return None
    kwargs = dict(
        completeness_vec=completeness_vec,
        completeness_cutoff=completeness_cutoff,
    )
    if exact:
        from .dist.coreacc_jax import DeviceCoreAccExactStreamEngine

        return DeviceCoreAccExactStreamEngine(ms, **kwargs)
    if _multi_device():
        from .shard.mesh import ShardedCoreAccEngine

        return ShardedCoreAccEngine(ms, **kwargs)
    from .dist.coreacc_jax import DeviceCoreAccEngine

    return DeviceCoreAccEngine(ms, **kwargs)


def select_dense_stream_engine(ms, dist_type):
    """Streaming device engine for large single-k dense self runs. Output
    values are identical to the host path (exact samebits on device, f64
    chain on host), so this is purely a throughput decision; supports
    completeness correction."""
    mode = _mode()
    if mode == "host" or dist_type.coreacc:
        return None
    if ms.sketchsize64 * 64 > 32767:
        return None  # samebits would overflow the engine's int16 strips
    n = ms.number_samples_loaded()
    if not _use_device(mode, n, _MIN_SAMPLES_FOR_DEVICE_DENSE_STREAM):
        return None
    from .dist.jaccard_jax import DeviceDenseStreamEngine

    return DeviceDenseStreamEngine(ms, dist_type.k_idx)


def select_knn_engine(ms, dist_type):
    """On-device kNN engine for large sparse runs (selection by samebits on
    device, exact f64 distance values; core-acc mode is f32 like the dense
    device engine). With completeness correction, selection keys on the
    corrected f32 distance (per-sample correction breaks samebits
    monotonicity) and single-k values are still recomputed exactly on the
    host from the selected samebits, on both the single-device and
    sharded engines."""
    mode = _mode()
    if mode == "host":
        return None
    if dist_type.coreacc and len(ms.kmer_lengths) < 2:
        return None
    n = ms.number_samples_loaded()
    if not _use_device(mode, n, _MIN_SAMPLES_FOR_DEVICE_KNN):
        return None
    if _multi_device():
        from .shard.mesh import ShardedKnnEngine

        return ShardedKnnEngine(ms)
    from .dist.knn_jax import DeviceKnnEngine

    return DeviceKnnEngine(ms)


def select_inverted_engine(inv):
    """Device equality-tile engine for inverted-index queries/precluster."""
    if not _use_device(_mode(), inv.n_samples,
                       _MIN_SAMPLES_FOR_DEVICE_INVERTED):
        return None
    if _multi_device():
        from .shard.mesh import ShardedInvertedEngine

        return ShardedInvertedEngine(inv.sign_matrix)
    from .inverted.device import DeviceInvertedEngine

    return DeviceInvertedEngine(inv.sign_matrix)


def select_engine(ms):
    """samebits engine for distance drivers, or None for the host path.

    With more than one device, row blocks shard over the full mesh
    (ShardedSamebitsEngine); output is identical either way (exact int32
    samebits)."""
    n = ms.number_samples_loaded()
    if not _use_device(_mode(), n, _MIN_SAMPLES_FOR_DEVICE_DIST):
        return None
    if _multi_device():
        from .shard.mesh import ShardedSamebitsEngine

        return ShardedSamebitsEngine(ms.sketchsize64).matrix
    from .dist.jaccard_jax import DeviceSamebitsEngine

    return DeviceSamebitsEngine(ms.sketchsize64).matrix
