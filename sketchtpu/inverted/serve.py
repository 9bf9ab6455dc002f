"""HTTP query frontend over an inverted index.

The server-side equivalent of the reference's WASM/browser frontend
(reference src/fastx_wasm.rs, src/lib.rs:961-1111 —
`SketchlibData::{new, query, get_probs}`): the reference ships the whole
`.ski` to the browser and sketches the user's uploaded fastx in WASM; a
GPU deployment keeps the index resident server-side (where the cards
are) and serves the same query surface over HTTP.

Endpoints (JSON responses):

  GET  /info         index summary: n_samples, n_bins, kmer_size,
                     sketch_size, has_labels, has_metadata.
  POST /query        body = raw FASTA/FASTQ bytes (gzip is sniffed from
                     the magic bytes, like the WASM shim's manual gz
                     sniffing, fastx_wasm.rs:1-69). Query params:
                     nouts (default 10), min_count (5), min_qual (20),
                     name (default "query"). Response is exactly
                     `Inverted.query_probs`: {"probs", "names",
                     "metadata"} sorted by descending Jaccard estimate
                     d / (2*sketch_size - d) (lib.rs:1019-1111).
  POST /match-count  same body/params; response {"query": name,
                     "samples": [...], "counts": [...]} — the
                     `query_against_inverted_index` per-sample bin-match
                     counts (inverted.rs:229-240).

Run via `sketchtpu inverted serve INDEX.ski --port 8080`.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("sketchtpu")


def _info_payload(inv) -> dict:
    return {
        "n_samples": len(inv.sample_names),
        "n_bins": int(inv.sketch_size),
        "kmer_size": int(inv.kmer_size),
        "sketch_size": int(inv.sketch_size),
        "rc": bool(inv.rc),
        "has_labels": inv.labels is not None,
        "has_metadata": inv.metadata is not None,
    }


def _sketch_body(inv, body: bytes, name: str, min_count: int, min_qual: int):
    """Sketch one uploaded fastx payload against the index's parameters.

    The upload goes through the same parser as file inputs (gzip sniffed
    from magic bytes, not the name), so .fa/.fq/.gz payloads all work."""
    fd, path = tempfile.mkstemp(suffix=".fastx")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        queries, _ = inv.sketch_queries([(name, [path])], min_count, min_qual)
        return queries[0]
    finally:
        os.unlink(path)


def make_handler(inv):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger
            log.debug("serve: " + fmt, *args)

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/info":
                self._json(200, _info_payload(inv))
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            url = urlparse(self.path)
            params = parse_qs(url.query)

            def p(key, default, cast=int):
                return cast(params[key][0]) if key in params else default

            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if not body:
                    self._json(400, {"error": "empty body"})
                    return
                name = p("name", "query", str)
                min_count = p("min_count", 5)
                min_qual = p("min_qual", 20)
                if url.path == "/query":
                    # exactly the WASM frontend's get_probs output
                    fd, path = tempfile.mkstemp(suffix=".fastx")
                    try:
                        with os.fdopen(fd, "wb") as f:
                            f.write(body)
                        out = inv.query_probs(
                            [(name, [path])],
                            nouts=p("nouts", 10),
                            min_count=min_count,
                            min_qual=min_qual,
                        )
                    finally:
                        os.unlink(path)
                    self._json(200, out)
                elif url.path == "/match-count":
                    q = _sketch_body(inv, body, name, min_count, min_qual)
                    counts = inv.query_match_count(q)
                    self._json(
                        200,
                        {
                            "query": name,
                            "samples": list(inv.sample_names),
                            "counts": [int(c) for c in counts],
                        },
                    )
                else:
                    self._json(404, {"error": "unknown endpoint"})
            except Exception as e:  # surface parse/sketch errors as 400s
                log.warning("serve: query failed: %s", e)
                self._json(400, {"error": str(e)})

    return Handler


def make_server(inv, host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the HTTP server; port 0 picks a free port
    (server.server_address reports the bound one). ThreadingHTTPServer:
    queries are independent reads of the resident index."""
    return ThreadingHTTPServer((host, port), make_handler(inv))


def serve_forever(inv, host: str, port: int) -> None:
    srv = make_server(inv, host, port)
    bound = srv.server_address
    log.info(
        "Serving inverted index (%d samples, %d bins, k=%d) on http://%s:%d "
        "— GET /info, POST /query, POST /match-count",
        len(inv.sample_names),
        int(inv.sketch_size),
        int(inv.kmer_size),
        bound[0],
        bound[1],
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        log.info("Shutting down")
    finally:
        srv.server_close()
