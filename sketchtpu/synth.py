"""Seeded synthetic inputs: clustered genomes, read sets, proteomes and
sketch databases.

The tests and chip_smoke.py use these in place of downloaded fixtures.
Real collections are clustered, so every generator is too: a tree of
ancestors (clades, then clusters) from which samples descend by SNPs and
by gain or loss of accessory blocks. That gives distances that span the
whole range, where unrelated random sequences would all sit at distance
1.0.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from .constants import BBITS, num_bins

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _mutate(rng, seq: np.ndarray, snp_rate: float, indel_blocks: int,
            block_len: int, alphabet: np.ndarray) -> np.ndarray:
    """SNPs at snp_rate, then indel_blocks deletions and insertions of
    random blocks (accessory gain and loss)."""
    seq = seq.copy()
    hits = np.flatnonzero(rng.random(seq.size) < snp_rate)
    seq[hits] = alphabet[rng.integers(0, alphabet.size, hits.size)]
    for _ in range(indel_blocks):
        at = int(rng.integers(0, max(1, seq.size - block_len)))
        if rng.random() < 0.5:
            seq = np.delete(seq, np.s_[at : at + block_len])
        else:
            ins = alphabet[rng.integers(0, alphabet.size, block_len)]
            seq = np.insert(seq, at, ins)
    return seq


def clustered_genomes(n: int, length: tuple[int, int], seed: int,
                      n_clusters: int = 4) -> list[np.ndarray]:
    """n DNA genomes (uint8 ACGT) with lengths in [length[0], length[1]],
    in n_clusters clusters that descend from one root."""
    rng = np.random.default_rng(seed)
    lo, hi = length
    mid = (lo + hi) // 2
    root = _DNA[rng.integers(0, 4, mid)]
    block = max(1, (hi - lo) // 16)
    ancestors = [
        _mutate(rng, root, rng.uniform(0.02, 0.05), 4, block, _DNA)
        for _ in range(n_clusters)
    ]
    out = []
    for i in range(n):
        g = _mutate(rng, ancestors[i % n_clusters], rng.uniform(0.0005, 0.01),
                    int(rng.integers(0, 6)), block, _DNA)
        target = int(rng.integers(lo, hi + 1))
        if g.size > target:
            g = g[:target]
        elif g.size < target:
            g = np.concatenate([g, _DNA[rng.integers(0, 4, target - g.size)]])
        out.append(g)
    return out


def write_fasta(path: str | Path, seq: np.ndarray, name: str,
                n_contigs: int = 1, width: int = 80) -> None:
    """FASTA (gzipped when path ends in .gz), split into n_contigs."""
    cuts = np.linspace(0, seq.size, n_contigs + 1).astype(int)
    parts = []
    for c in range(n_contigs):
        body = seq[cuts[c] : cuts[c + 1]].tobytes()
        lines = [body[i : i + width] for i in range(0, len(body), width)]
        parts.append(b">%s_%d\n" % (name.encode(), c) + b"\n".join(lines))
    data = b"\n".join(parts) + b"\n"
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(data)
    else:
        Path(path).write_bytes(data)


def write_paired_reads(prefix: str | Path, genome: np.ndarray, coverage: float,
                       seed: int, read_len: int = 150,
                       error_rate: float = 0.005) -> tuple[str, str]:
    """Gzipped paired FASTQ at the given coverage: fragments of ~350 bp,
    read 2 reverse-complemented, substitution errors at error_rate, and
    qualities that drop below 20 at the errors and in read tails."""
    rng = np.random.default_rng(seed)
    n_pairs = int(coverage * genome.size / (2 * read_len))
    frag = np.clip(rng.normal(350, 30, n_pairs).astype(int), read_len,
                   genome.size)
    start = rng.integers(0, genome.size - frag + 1)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    idx = np.arange(read_len)
    r1 = genome[start[:, None] + idx]
    r2 = comp[genome[(start + frag - 1)[:, None] - idx]]
    paths = []
    for mate, reads in ((1, r1), (2, r2)):
        err = rng.random(reads.shape) < error_rate
        reads = np.where(err, _DNA[rng.integers(0, 4, reads.shape)], reads)
        qual = np.where(err | (idx >= read_len - 10)[None, :], 10, 35)
        qual = (qual + 33).astype(np.uint8)
        recs = []
        for r in range(n_pairs):
            recs.append(b"@r%d/%d\n%s\n+\n%s\n"
                        % (r, mate, reads[r].tobytes(), qual[r].tobytes()))
        path = f"{prefix}_{mate}.fastq.gz"
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(b"".join(recs))
        paths.append(path)
    return paths[0], paths[1]


def clustered_proteomes(n: int, n_proteins: int, seed: int,
                        n_clusters: int = 4) -> list[list[np.ndarray]]:
    """n proteomes of n_proteins proteins (uint8 amino-acid letters), in
    clusters descending from one root proteome."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(80, 600, n_proteins)
    root = [_AA[rng.integers(0, _AA.size, m)] for m in lengths]
    ancestors = [
        [_mutate(rng, p, 0.05, 0, 1, _AA) for p in root]
        for _ in range(n_clusters)
    ]
    out = []
    for i in range(n):
        anc = ancestors[i % n_clusters]
        keep = rng.random(n_proteins) > rng.uniform(0.0, 0.1)
        out.append([_mutate(rng, p, rng.uniform(0.0, 0.03), 0, 1, _AA)
                    for p, k in zip(anc, keep) if k])
    return out


def write_proteome(path: str | Path, proteins: list[np.ndarray],
                   name: str) -> None:
    recs = [b">%s_%d\n%s" % (name.encode(), j, p.tobytes())
            for j, p in enumerate(proteins)]
    Path(path).write_bytes(b"\n".join(recs) + b"\n")


def _replace(rng, planes: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Give every bin a fresh random sign with probability 1 - keep.

    planes: (..., nk, s64, BBITS) u64 bit-planes, bit b of every plane word
    of a chunk belonging to bin b; keep: (..., nk) per-k keep probability."""
    shape = planes.shape
    bits = rng.random((*shape[:-1], 64)) >= keep[..., None, None]
    mask = np.packbits(bits, axis=-1, bitorder="little").view(np.uint64)
    fresh = rng.integers(0, 2**64, shape, dtype=np.uint64)
    return (planes & ~mask) | (fresh & mask)


def _keep(rng, count: int, kmers: np.ndarray, acc: tuple[float, float],
          snp: tuple[float, float]) -> np.ndarray:
    """(count, nk) probability that a bin survives one branch of the tree:
    (1 - a) * (1 - m)^k for an accessory share a and a SNP rate m, so
    ln(Jaccard) is linear in k, as the core/accessory fit assumes."""
    a = rng.uniform(*acc, count)[:, None]
    m = rng.uniform(*snp, count)[:, None]
    return (1.0 - a) * (1.0 - m) ** kmers[None, :]


def clustered_sketch_planes(n: int, kmers: list[int], sketch_size: int,
                            seed: int, n_clades: int = 8,
                            n_clusters: int = 128, batch: int = 256):
    """Yield (n_batch, nk, s64 * BBITS) u64 .skd rows for n samples in a
    root -> clade -> cluster -> sample tree. Cluster sizes are heavy
    tailed. Pairwise Jaccard runs from about 0.9 within a cluster to a few
    per cent between clades, at every k."""
    rng = np.random.default_rng(seed)
    s64 = num_bins(sketch_size)[0]
    kv = np.asarray(kmers, dtype=np.float64)
    nk = kv.size
    root = rng.integers(0, 2**64, (nk, s64, BBITS), dtype=np.uint64)
    clades = _replace(rng, np.broadcast_to(root, (n_clades, *root.shape)),
                      _keep(rng, n_clades, kv, (0.2, 0.45), (0.02, 0.045)))
    clade_of = rng.integers(0, n_clades, n_clusters)
    clusters = _replace(rng, clades[clade_of],
                        _keep(rng, n_clusters, kv, (0.02, 0.1),
                              (0.002, 0.012)))
    weight = rng.pareto(2.0, n_clusters) + 1.0
    cluster_of = rng.choice(n_clusters, n, p=weight / weight.sum())
    for b0 in range(0, n, batch):
        cl = cluster_of[b0 : b0 + batch]
        rows = _replace(rng, clusters[cl],
                        _keep(rng, cl.size, kv, (0.0, 0.03), (0.0005, 0.003)))
        yield rows.reshape(cl.size, nk, s64 * BBITS)


def write_sketch_db(prefix: str, n: int, kmers: list[int], sketch_size: int,
                    seed: int) -> None:
    """prefix.skd/.skm of n clustered synthetic samples, written through
    the repo's own writers."""
    from .formats.skd import SketchDataWriter
    from .formats.skm import MultiSketch
    from .sketchcore.sketch import HashType, Sketch

    sketches = []
    with SketchDataWriter(f"{prefix}.skd") as w:
        for rows in clustered_sketch_planes(n, kmers, sketch_size, seed):
            for r in rows:
                i = len(sketches)
                sk = Sketch(name=f"sample{i}", seq_length=2_000_000,
                            acgt=(1, 1, 1, 1))
                sk.index = w.write_sketch(r.reshape(-1))
                sketches.append(sk)
    MultiSketch(sketches, sketch_size, list(kmers),
                HashType("dna")).save_metadata(prefix)
