"""HTTP query frontend (`inverted serve`): the server must return exactly
the in-memory API's answers — /query == Inverted.query_probs (the WASM
frontend's SketchlibData::get_probs JSON, lib.rs:1019-1111), /match-count
== query_against_inverted_index counts (inverted.rs:229-240) — for
uploads sent as raw bytes (gzip sniffed from magic, fastx_wasm.rs)."""

import gzip
import json
import threading
import urllib.request

import pytest

import sketchtpu as st
from sketchtpu.inverted.index import Inverted
from sketchtpu.inverted.serve import make_server


@pytest.fixture(scope="module")
def inv(genomes):
    inputs = st.get_input_list(
        None,
        [
            str(genomes["R6"]),
            str(genomes["TIGR4"]),
            str(genomes["s82"]),
        ],
    )
    return Inverted.build(
        inputs, list(range(3)), 17, 100, True, 5, 20,
        labels=["R6", "TIGR4", "s82"],
    )


@pytest.fixture(scope="module")
def server(inv):
    srv = make_server(inv, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_info(server, inv):
    status, info = _get(server + "/info")
    assert status == 200
    assert info["n_samples"] == 3
    assert info["kmer_size"] == 17
    assert info["sketch_size"] == 100
    assert info["has_labels"] and not info["has_metadata"]


def test_query_matches_inmemory_api(server, inv, genomes):
    body = genomes["R6"].read_bytes()  # gzip: sniffed from magic
    status, res = _post(server + "/query?nouts=3&name=R6", body)
    assert status == 200
    expect = inv.query_probs([("R6", [str(genomes["R6"])])], nouts=3)
    assert res == json.loads(json.dumps(expect))  # identical through JSON
    assert res["names"][0] == "R6" and res["probs"][0] == 1.0


def test_match_count_matches_inmemory_api(server, inv, genomes):
    body = genomes["TIGR4"].read_bytes()
    status, res = _post(server + "/match-count?name=T4", body)
    assert status == 200
    assert res["query"] == "T4"
    assert res["samples"] == list(inv.sample_names)
    queries, _ = inv.sketch_queries(
        [("T4", [str(genomes["TIGR4"])])], 5, 20
    )
    assert res["counts"] == [int(c) for c in inv.query_match_count(queries[0])]
    # the query IS an indexed sample: its own column is a full match
    assert res["counts"][1] == 100


def test_plain_fasta_upload(server, genomes):
    """Uncompressed payloads work too (format sniffing, not extension)."""
    plain = gzip.decompress(genomes["R6"].read_bytes())
    status, res = _post(server + "/query?nouts=1", plain)
    assert status == 200 and res["probs"][0] == 1.0


def test_errors(server):
    status, res = _post(server + "/query", b"")
    assert status == 400 and "error" in res
    status, res = _post(server + "/query", b">broken\nNNNN\n")
    assert status == 400 and "error" in res
    status, res = _get(server + "/nope")
    assert status == 404 or status == 200 and "error" in res
