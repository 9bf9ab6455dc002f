"""Backend-selection runtime: modes, the per-platform tile, errors that
propagate, and the compile cache's directory."""

import jax
import pytest

from sketchtpu import runtime


def test_backend_selection_env_gates(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")

    class _Kind:
        kind = "dna"

    assert runtime.select_backend(_Kind(), 8) is None


def test_backend_mode_rejects_unknown(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_BACKEND", "fast")
    with pytest.raises(ValueError, match="host, device, auto"):
        runtime.select_engine(_Ms())


@pytest.mark.parametrize(
    "platform,kernel", [("cpu", "xla"), ("gpu", "triton"), ("rocm", None)]
)
def test_samebits_kernel_per_platform(monkeypatch, platform, kernel):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if kernel is None:
        with pytest.raises(RuntimeError, match="no samebits tile"):
            runtime.samebits_kernel()
    else:
        assert runtime.samebits_kernel() == kernel


class _Ms:
    """Just enough of a MultiSketch for the selectors."""

    sketchsize64 = 16
    kmer_lengths = [17, 21]

    def number_samples_loaded(self):
        return 100_000


class _Dt:
    coreacc = False
    k_idx = 0


def _boom(*_a, **_k):
    raise RuntimeError("engine failed")


@pytest.mark.parametrize("selector,module,engine", [
    ("select_knn_engine", "sketchtpu.dist.knn_jax", "DeviceKnnEngine"),
    ("select_dense_stream_engine", "sketchtpu.dist.jaccard_jax",
     "DeviceDenseStreamEngine"),
    ("select_coreacc_engine", "sketchtpu.dist.coreacc_jax",
     "DeviceCoreAccEngine"),
])
def test_engine_error_propagates_with_gpu(monkeypatch, selector, module,
                                          engine):
    """With a GPU present (faked here) an engine error reaches the caller:
    nothing falls back to the host."""
    import importlib

    monkeypatch.setenv("SKETCHTPU_BACKEND", "auto")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(runtime, "_multi_device", lambda: False)
    monkeypatch.setattr(importlib.import_module(module), engine, _boom)
    args = (_Ms(),) if selector == "select_coreacc_engine" else (_Ms(), _Dt())
    with pytest.raises(RuntimeError, match="engine failed"):
        getattr(runtime, selector)(*args)


def test_small_runs_stay_on_host_with_gpu(monkeypatch):
    """Below its threshold a run takes the host path even with a GPU."""
    monkeypatch.setenv("SKETCHTPU_BACKEND", "auto")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    class _Small(_Ms):
        def number_samples_loaded(self):
            return 10

    assert runtime.select_knn_engine(_Small(), _Dt()) is None


@pytest.mark.parametrize("env", [None, "/somewhere/else"])
def test_compile_cache_dir(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache lives in the checkout's .jax_cache."""
    calls = {}
    monkeypatch.setattr(runtime, "_cache_ready", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    runtime.enable_compilation_cache()
    runtime.enable_compilation_cache()  # once per process
    if env is None:
        assert calls["jax_compilation_cache_dir"] == str(runtime.CACHE_DIR)
        assert runtime.CACHE_DIR.name == ".jax_cache"
        assert (runtime.CACHE_DIR.parent / "sketchtpu").is_dir()
    else:
        assert "jax_compilation_cache_dir" not in calls
