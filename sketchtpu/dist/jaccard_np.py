"""Jaccard / ANI / core-accessory distance math (host oracle, exact f64).

Numerics mirror /root/reference/src/distances/jaccard.rs operation-for-
operation so that formatted f32 output is identical. The device path
(jaccard_jax.py) computes the integer samebits kernel on the device and
feeds the same scalar pipeline.
"""

from __future__ import annotations

import numpy as np

from ..constants import BBITS

_U64 = np.uint64


def samebits_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise samebits between paired sketch slices.

    a, b: (n_pairs, W) uint64 where W = sketchsize64 * BBITS, laid out as
    [chunk][plane] (the .skd layout). Returns (n_pairs,) int64 counts of
    bins whose low-BBITS sign bits agree (jaccard.rs:15-25).
    """
    n, w = a.shape
    s64 = w // BBITS
    x = ~(a ^ b)
    x = x.reshape(n, s64, BBITS)
    acc = np.bitwise_and.reduce(x, axis=2)
    return np.bitwise_count(acc).sum(axis=1, dtype=np.int64)


def samebits_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs samebits: a (na, W), b (nb, W) -> (na, nb) int64.

    Tiled so the broadcast intermediate stays bounded (~tens of MB)."""
    na, w = a.shape
    nb = b.shape[0]
    s64 = w // BBITS
    out = np.empty((na, nb), dtype=np.int64)
    # keep na_t * nb_t * s64 u64 words around 4M elements
    tile = max(1, (1 << 22) // max(1, na * s64))
    ar = a.reshape(na, 1, s64, BBITS)
    for j0 in range(0, nb, tile):
        br = b[j0 : j0 + tile].reshape(1, -1, s64, BBITS)
        acc = np.bitwise_and.reduce(~(ar ^ br), axis=3)
        out[:, j0 : j0 + tile] = np.bitwise_count(acc).sum(axis=2, dtype=np.int64)
    return out


def jaccard_from_samebits(
    samebits: np.ndarray,
    sketchsize64: int,
    c1=None,
    c2=None,
    completeness_cutoff: float = 0.64,
) -> np.ndarray:
    """samebits (int array) -> Jaccard index (f64 array), with optional MAG
    completeness correction (jaccard.rs:26-45)."""
    maxnbits = sketchsize64 * 64
    expected = maxnbits >> BBITS
    unionsize = float(maxnbits)
    diff = np.maximum(samebits.astype(np.int64) - expected, 0).astype(np.float64)
    intersize = diff * float(maxnbits) / float(maxnbits - expected)
    j = intersize / unionsize
    if c1 is not None and c2 is not None:
        c1 = np.asarray(c1, dtype=np.float64)
        c2 = np.asarray(c2, dtype=np.float64)
        apply = c1 * c2 >= completeness_cutoff
        corrected = np.minimum(j / (c1 * c2 / (c1 + c2 - c1 * c2)), 1.0)
        j = np.where(apply, corrected, j)
    return j


def ani_pois(jaccard: np.ndarray, k: float) -> np.ndarray:
    """Poisson-model ANI transform (jaccard.rs:49-51)."""
    jaccard = np.asarray(jaccard, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        val = 1.0 + 1.0 / k * np.log((2.0 * jaccard) / (1.0 + jaccard))
    return np.maximum(0.0, val)


def core_acc_from_jaccards(
    jaccards: np.ndarray, kmer_lengths: list[int], sketch_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Core/accessory distances via the PopPUNK log-linear regression.

    jaccards: (n_pairs, n_k) f64 Jaccard values in ascending-k order.
    Replicates core_acc_dist (jaccard.rs:61-142) exactly, including the
    early-break when ln(J) falls below the tolerance and the f64 summation
    order.

    Returns (core, acc) as f32 arrays.
    """
    n_pairs, n_k = jaccards.shape
    if n_k < 2:
        raise ValueError(
            "Need at least two k-mer lengths to calculate core/accessory distances"
        )
    tolerance = np.log(2.0 / float(sketch_size * 64))
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.log(jaccards)
    # The reference breaks out of the k loop at the first y < tolerance:
    # include a k only if all previous ys (and its own) are >= tolerance.
    ok = y >= tolerance  # nan -> False, matching f64 comparison semantics
    include = np.logical_and.accumulate(ok, axis=1)

    xsum = np.zeros(n_pairs)
    ysum = np.zeros(n_pairs)
    xysum = np.zeros(n_pairs)
    xsquaresum = np.zeros(n_pairs)
    ysquaresum = np.zeros(n_pairs)
    n = np.zeros(n_pairs)
    for k_idx, k in enumerate(kmer_lengths):
        m = include[:, k_idx]
        k_fl = float(k)
        yk = np.where(m, y[:, k_idx], 0.0)
        xsum = xsum + np.where(m, k_fl, 0.0)
        ysum = ysum + yk
        xysum = xysum + k_fl * yk
        xsquaresum = xsquaresum + np.where(m, k_fl * k_fl, 0.0)
        ysquaresum = ysquaresum + yk * yk
        n = n + m

    with np.errstate(divide="ignore", invalid="ignore"):
        xbar = xsum / n
        ybar = ysum / n
        x_diff = xsquaresum - xsum * xsum / n
        y_diff = ysquaresum - ysum * ysum / n
        xstddev = np.sqrt(x_diff / n)
        ystddev = np.sqrt(y_diff / n)
        r = (xysum - xsum * ysum / n) / np.sqrt(x_diff * y_diff)
        beta = r * ystddev / xstddev
        alpha = -beta * xbar + ybar

        core = np.where(beta < 0.0, 1.0 - np.exp(beta), np.where(r > 0.0, 1.0, 0.0))
        acc = np.where(alpha < 0.0, 1.0 - np.exp(alpha), 0.0)

    bad = np.isnan(ysum) | np.isneginf(ysum) | (n < 3.0)
    core = np.where(bad, 1.0, core)
    acc = np.where(bad, 1.0, acc)
    return core.astype(np.float32), acc.astype(np.float32)
