"""Brute-force float64 numpy oracle for the KNN within-sample reference.

Independent of the code under test: for each target row, the squared
distance to every other-chromosome candidate is summed directly (no norm
trick, no tiling), candidates at or beyond 1e10 are dropped, and the k
nearest are taken in (distance, scan position) order — the reference's
bisect-insertion semantics (newref_tools.py:255-278).  Indexes are
reported in own-chromosome-excluded space, unfilled slots as -1 / 1e10.
"""

from __future__ import annotations

import numpy as np

SENTINEL = 1e10


def brute_force_knn(data, chr_of_bin, starts, sizes, ref_size,
                    row_range=None):
    data = np.asarray(data, dtype=np.float64)
    chr_of_bin = np.asarray(chr_of_bin)
    starts = np.asarray(starts, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.int64)
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    idx = np.full((r1 - r0, ref_size), -1, dtype=np.int32)
    dist = np.full((r1 - r0, ref_size), SENTINEL, dtype=np.float64)
    cols = np.arange(n)
    for out_row, r in enumerate(range(r0, r1)):
        c = chr_of_bin[r]
        cand = cols[chr_of_bin != c]
        d = np.sum((data[cand] - data[r]) ** 2, axis=1)
        keep = d < SENTINEL
        cand, d = cand[keep], d[keep]
        order = np.lexsort((cand, d))[:ref_size]
        excl = cand[order] - np.where(cand[order] >= starts[c], sizes[c], 0)
        idx[out_row, : order.size] = excl
        dist[out_row, : order.size] = d[order]
    return idx, dist


def layout(bins_per_chr):
    """(starts, chr_of_bin) for contiguous chromosomes of the given sizes."""
    bins_per_chr = np.asarray(bins_per_chr)
    starts = np.concatenate([[0], np.cumsum(bins_per_chr)[:-1]]).astype(
        np.int64
    )
    chr_of_bin = np.repeat(
        np.arange(len(bins_per_chr)), bins_per_chr
    ).astype(np.int32)
    return starts, chr_of_bin
