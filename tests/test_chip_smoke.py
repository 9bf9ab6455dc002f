"""chip_smoke.py at a tiny size on the CPU: its phases, host oracles and
output readers run here; only the card's compiler and timings need the
card (the driver runs the full-size script there)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("SKETCHTPU_BACKEND", "auto")  # restored after cli()
    monkeypatch.setattr(chip_smoke, "KMERS", [13, 17, 21])
    monkeypatch.setattr(chip_smoke, "SKETCH", 1000)
    monkeypatch.setattr(chip_smoke, "KNN", 5)
    monkeypatch.setattr(chip_smoke, "ORACLE_ROWS", 12)


def test_preflight_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "needs an NVIDIA GPU" in res.stderr
    assert '"ok"' not in res.stdout


def test_sketch_dna_phase(small, tmp_path):
    chip_smoke.sketch_dna(tmp_path, 0, n=9, length=(20_000, 24_000))


def test_sketch_reads_aa_phase(small, tmp_path):
    chip_smoke.sketch_reads_aa(tmp_path, 0, genome_len=20_000, n_proteins=12)


def test_dist_phase(small, tmp_path):
    rng = np.random.default_rng(0)
    chip_smoke.dist_dense(tmp_path, 0, 40, rng)
    chip_smoke.dist_knn(tmp_path, 1, 70, rng)


def test_inverted_phase(small, tmp_path):
    chip_smoke.inverted(tmp_path, 0, n=40, length=20_000)


def test_dense_rows_reads_upper_triangle(tmp_path):
    n = 7
    path = tmp_path / "dense.txt"
    path.write_text("".join(f"{i}\t{j}\n" for i in range(n)
                            for j in range(i + 1, n)))
    got = chip_smoke.dense_rows(str(path), n, np.array([0, 3, 5, 6]))
    assert got[3] == [b"3\t4", b"3\t5", b"3\t6"]
    assert got[0][0] == b"0\t1" and got[5] == [b"5\t6"]
    assert 6 not in got  # the last row holds no pair


def test_last_line_contract():
    line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert json.loads(line)["device"]["count"] == 1
