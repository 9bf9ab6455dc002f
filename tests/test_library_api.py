"""Public library surface (`import sketchtpu`): the reference is a Rust
library as well as a CLI (docs.rs API, src/lib.rs:19-129), so the package
root re-exports the equivalent Python API."""

import numpy as np

import sketchtpu as st


def test_sketch_load_dist_roundtrip(tmp_path, genomes):
    inputs = st.get_input_list(
        None,
        [
            str(genomes["R6"]),
            str(genomes["TIGR4"]),
        ],
    )
    prefix = str(tmp_path / "db")
    ms = st.sketch_database(prefix, inputs, kmers=[17, 21], sketch_size=100)
    assert (tmp_path / "db.skd").exists() and (tmp_path / "db.skm").exists()
    assert ms.number_samples_loaded() == 2

    loaded = st.load_database(prefix)
    dt = st.set_k(loaded, 17, False)
    d = st.self_dists_all(loaded, dt)
    assert d.shape == (1,)
    assert 0.0 <= float(d[0]) <= 1.0

    # multi-k core/accessory
    dt_ca = st.set_k(loaded, None, False)
    ca = st.self_dists_all(loaded, dt_ca)
    assert ca.shape == (1, 2)

    # kNN returns one row per sample
    rows = st.self_dists_knn(loaded, 1, dt)
    assert len(rows) == 2

    # subset load by name
    sub = st.load_database(prefix, subset=[loaded.sketch_name(0)])
    assert sub.number_samples_loaded() == 1


def test_all_exports_resolve():
    for name in st.__all__:
        assert getattr(st, name, None) is not None, name


def test_inverted_query_probs(genomes):
    """Python analogue of the WASM frontend's SketchlibData::{query,
    get_probs} (lib.rs:1019-1111): top-N Jaccard estimates with labels."""
    from sketchtpu.inverted.index import Inverted

    inputs = st.get_input_list(
        None,
        [
            str(genomes["R6"]),
            str(genomes["TIGR4"]),
            str(genomes["s82"]),
        ],
    )
    inv = Inverted.build(
        inputs, list(range(3)), 17, 100, True, 5, 20,
        labels=["R6", "TIGR4", "s82"],
    )
    res = inv.query_probs(inputs[:1], nouts=3)
    assert set(res) == {"probs", "names", "metadata"}
    assert len(res["probs"]) == 3
    # the query IS the first indexed sample: perfect match-count ->
    # d = sketch_size, prob = s/(2s-s) = 1.0, ranked first
    assert res["names"][0] == "R6" and res["probs"][0] == 1.0
    assert res["probs"] == sorted(res["probs"], reverse=True)
    assert res["metadata"] == ["", "", ""]  # no metadata vector, like WASM
