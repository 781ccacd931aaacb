"""Histogram clustering to at most 8 prefix codes.

Functionally mirrors the reference's greedy seeded clustering
(encoder/enc_cluster.cc:38-131) with one deliberate, TPU-friendly redesign:
the pairwise distance uses vectorized Shannon entropy instead of building an
exact Huffman tree per candidate pair. This lets us cluster the *full* context
space (e.g. all 1980 AC contexts) as one batched numpy computation instead of
requiring the reference's static 1980->64 pre-clustering table
(static_entropy_codes.h). The serialized bitstream format is identical; only
the clustering decisions may differ marginally.
"""
import numpy as np

from ..constants import CLUSTERS_LIMIT

_MIN_DISTANCE_FOR_DISTINCT = 64.0


def _entropy_bits(h):
    """Shannon cost in bits of histogram rows h: [..., S]."""
    h = h.astype(np.float64)
    total = h.sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.where(h > 0, np.log2(np.maximum(h, 1)), 0.0)
        tlog = np.where(total > 0, np.log2(np.maximum(total, 1)), 0.0)
    return total * tlog - (h * logs).sum(axis=-1)


def cluster_histograms(histograms: np.ndarray):
    """histograms: [N, S] uint32 -> (clustered [M, S] uint64, context_map [N] uint8).

    M <= CLUSTERS_LIMIT. Canonical reindexing: cluster ids appear in increasing
    order of first use in the context map (enc_cluster.cc:97-115).
    """
    hist = np.asarray(histograms, np.uint64)
    n = hist.shape[0]
    if n == 0:
        return hist, np.zeros(0, np.uint8)
    if n == 1:
        return hist.copy(), np.zeros(1, np.uint8)

    totals = hist.sum(axis=1)
    self_cost = _entropy_bits(hist)
    symbols = np.full(n, -1, np.int64)
    symbols[totals == 0] = 0  # empty histograms -> cluster of first seed
    dists = np.full(n, np.inf)
    dists[totals == 0] = 0.0

    seeds = []
    largest = int(np.argmax(totals))
    max_histograms = min(CLUSTERS_LIMIT, n)
    while len(seeds) < max_histograms:
        symbols[largest] = len(seeds)
        seeds.append(largest)
        dists[largest] = 0.0
        seed_h = hist[largest]
        # distance(i, seed) = H(i + seed) - H(i) - H(seed), vectorized over i.
        combined = _entropy_bits(hist + seed_h[None, :])
        d = combined - self_cost - self_cost[largest]
        np.minimum(dists, d, out=dists)
        largest = int(np.argmax(dists))
        if dists[largest] < _MIN_DISTANCE_FOR_DISTINCT:
            break

    # Assign every remaining histogram to the nearest seed.
    rest = np.where(symbols < 0)[0]
    if rest.size:
        seed_h = hist[np.array(seeds)]  # [M, S]
        comb = _entropy_bits(hist[rest][:, None, :] + seed_h[None, :, :])
        d = comb - self_cost[rest][:, None] - self_cost[np.array(seeds)][None, :]
        symbols[rest] = np.argmin(d, axis=1)

    # Aggregate cluster histograms.
    m = len(seeds)
    clustered = np.zeros((m, hist.shape[1]), np.uint64)
    np.add.at(clustered, symbols, hist)

    # Canonical reindex by first appearance.
    new_index = np.full(m, -1, np.int64)
    order = []
    for s in symbols:
        if new_index[s] < 0:
            new_index[s] = len(order)
            order.append(s)
    context_map = new_index[symbols].astype(np.uint8)
    clustered = clustered[np.array(order)]
    return clustered, context_map
