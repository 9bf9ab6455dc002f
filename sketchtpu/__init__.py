"""sketchtpu — genome sketching and distance estimation on the GPU.

A from-scratch JAX reimplementation of the capabilities of
bacpop/sketchlib.rust (binned bottom-MinHash sketching with ntHash/aaHash,
Jaccard/ANI/core-accessory distances, inverted-index preclustering), with
bit-compatible `.skm`/`.skd`/`.ski`/`.skq` files. The CLI
(`python -m sketchtpu.cli`) mirrors the reference's subcommands; this module
is the library surface, mapping to the reference's public Rust API
(src/lib.rs:19-129):

| reference (Rust)                         | here                          |
|------------------------------------------|-------------------------------|
| `MultiSketch::{load,save,read_sketch_data}` (multisketch.rs) | `MultiSketch`, `load_database` |
| `sketch::sketch_files` (sketch/mod.rs:283) | `sketch_database` / `sketch_files` |
| `distances::{self_dists_all,...}` (distances/mod.rs) | `set_k`, `self_dists_all`, `self_dists_knn`, `cross_dists_all`, `cross_dists_knn`, `self_dists_knn_precluster` |
| `Inverted::{new,load,save,...}` (inverted.rs) | `Inverted` |
| `io::{get_input_list,parse_kmers,...}` (io.rs) | `get_input_list`, `parse_kmers`, `read_completeness_file` |

Distance functions take a `MultiSketch` with loaded bins and a `DistType`
from `set_k(ms, kmer, ani)` (kmer=None selects multi-k core/accessory).
Heavy paths automatically use the device engines when JAX has a GPU and
the run is large enough; set SKETCHTPU_BACKEND=host|device to force a
backend.

Example::

    import sketchtpu as st

    inputs = st.get_input_list(None, ["r1.fa.gz", "r2.fa.gz"])
    ms = st.sketch_database("db", inputs, kmers=[17, 21], sketch_size=1000)
    ms = st.load_database("db")          # reload later (reads .skm + .skd)
    dt = st.set_k(ms, 17, ani=False)     # single-k Jaccard distance
    dists = st.self_dists_all(ms, dt)    # condensed upper triangle
"""

from .constants import BBITS, SIGN_MOD, num_bins
from .dist.api import (
    DistType,
    cross_dists_all,
    cross_dists_knn,
    self_dists_all,
    self_dists_knn,
    self_dists_knn_precluster,
    set_k,
)
from .formats.skm import MultiSketch
from .ingest.inputs import (
    get_input_list,
    parse_kmers,
    read_completeness_file,
    read_subset_names,
)
from .inverted.index import Inverted
from .sketchcore.pipeline import sketch_files
from .sketchcore.sketch import HashType, Sketch

__version__ = "0.1.0"


def load_database(prefix: str, subset: list[str] | None = None) -> MultiSketch:
    """Load `{prefix}.skm` metadata and the `.skd` sketch bins (the whole
    file, or an mmap'd subset of samples — multisketch.rs:167-210)."""
    ms = MultiSketch.load_metadata(prefix)
    if subset is None:
        ms.read_sketch_data(prefix)
    else:
        ms.read_sketch_data_block(prefix, subset)
    return ms


def sketch_database(
    output_prefix: str,
    input_files: list[tuple[str, list[str]]],
    kmers: list[int],
    sketch_size: int = 1000,
    seq_type: HashType = HashType("dna"),
    rc: bool = True,
    min_count: int = 5,
    min_qual: int = 20,
    concat_fasta: bool = False,
    threads: int = 1,
) -> MultiSketch:
    """Sketch samples and write `{prefix}.skd` + `{prefix}.skm`; returns the
    in-memory MultiSketch (metadata only — call load_database to get bins).
    Equivalent to the reference's sketch command (lib.rs:242-302): kmers are
    sorted, sketch_size is rounded up to a multiple of 64 bins."""
    from .runtime import select_backend

    kmers = sorted(kmers)
    _s64, nbins, _u = num_bins(sketch_size)
    sketches = sketch_files(
        output_prefix,
        input_files,
        concat_fasta,
        kmers,
        nbins,
        seq_type,
        rc,
        min_count,
        min_qual,
        threads=threads,
        backend=select_backend(seq_type, len(input_files)),
    )
    ms = MultiSketch(sketches, nbins, kmers, seq_type)
    ms.save_metadata(output_prefix)
    return ms


__all__ = [
    "BBITS",
    "SIGN_MOD",
    "DistType",
    "HashType",
    "Inverted",
    "MultiSketch",
    "Sketch",
    "cross_dists_all",
    "cross_dists_knn",
    "get_input_list",
    "load_database",
    "num_bins",
    "parse_kmers",
    "read_completeness_file",
    "read_subset_names",
    "self_dists_all",
    "self_dists_knn",
    "self_dists_knn_precluster",
    "set_k",
    "sketch_database",
    "sketch_files",
    "__version__",
]
