"""Test configuration.

Tests run on a virtual 8-device CPU mesh so sharding logic can be validated
without several cards. This must be set before JAX is imported anywhere.
Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; run them on the
card with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402

# The upstream reference checkout (read-only) provides golden fixtures:
# real genome FASTAs, prebuilt .skd/.skm databases and stdout snapshots.
REF_ROOT = Path(os.environ.get("SKETCHLIB_REF", "/root/reference"))
REF_IN = REF_ROOT / "tests" / "test_files_in"
REF_CORRECT = REF_ROOT / "tests" / "test_results_correct"

requires_reference = pytest.mark.skipif(
    not REF_IN.is_dir(), reason="reference fixture checkout not available"
)


@pytest.fixture
def ref_in():
    if not REF_IN.is_dir():
        pytest.skip("reference fixtures not available")
    return REF_IN


@pytest.fixture
def ref_correct():
    if not REF_CORRECT.is_dir():
        pytest.skip("reference fixtures not available")
    return REF_CORRECT


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU (decided here, at
    run time, never while a module is imported)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.fixture(scope="session")
def genomes(tmp_path_factory):
    """Three seeded synthetic assemblies (gzipped FASTA, two related and
    one more distant) for tests that need real files on disk."""
    from sketchtpu import synth

    d = tmp_path_factory.mktemp("genomes")
    seqs = synth.clustered_genomes(3, (150_000, 200_000), 11, n_clusters=2)
    paths = {}
    for name, seq in zip(("R6", "TIGR4", "s82"), seqs):
        paths[name] = d / f"{name}.fa.gz"
        synth.write_fasta(paths[name], seq, name, n_contigs=3)
    return paths
