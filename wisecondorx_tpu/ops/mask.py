"""Usability-mask construction (reference newref_tools.py:77-102).

A bin is usable when, after per-sample depth normalization, the summed
coverage across samples exceeds 5% of the median nonzero per-bin coverage
(the 5%-floor is a reference-fork addition on top of the upstream
zero-coverage mask; SURVEY.md 2.6).
"""

from __future__ import annotations



import numpy as np


def get_mask(matrix: np.ndarray) -> np.ndarray:
    """Compute the usability mask for a dense [total_bins, n_samples] matrix.

    Host numpy on purpose: this runs once per reference build on a small
    matrix.

    Returns bool[total_bins].
    """
    matrix = np.asarray(matrix)
    return mask_from_normed(matrix / matrix.sum(axis=0))


def mask_from_normed(normed: np.ndarray) -> np.ndarray:
    """Mask from an already depth-normalized matrix.

    Depth normalization is per-column, so a column subset of the
    normalized cohort equals normalizing the subset — the F/M sub-masks
    reuse one normalization instead of re-dividing the ~1 GB matrix
    (reference newref_tools.py:92-100 recomputes it per call).
    """
    return _threshold(np.asarray(normed).sum(axis=1))


def _threshold(sum_per_bin: np.ndarray) -> np.ndarray:
    median_cov = np.median(sum_per_bin[sum_per_bin > 0])
    return sum_per_bin > (0.05 * median_cov)


def get_masks(matrix: np.ndarray, col_subsets, block: int = 32768):
    """Usability masks for the full cohort and per-gender column subsets
    in ONE chunked pass — bit-identical to calling :func:`get_mask` on
    ``matrix`` / ``matrix[:, cols]`` (elementwise division and the
    per-row pairwise sums are unchanged by row blocking), with ~130 MB
    peak temporaries instead of several full-matrix copies.

    ``col_subsets``: list of boolean column selectors (None = all).
    Returns one bool[total_bins] mask per subset.
    """
    matrix = np.asarray(matrix)
    totals = matrix.sum(axis=0)
    sums = [
        np.empty(matrix.shape[0], dtype=np.float64) for _ in col_subsets
    ]
    for a in range(0, matrix.shape[0], block):
        chunk = matrix[a : a + block] / totals
        for out, cols in zip(sums, col_subsets):
            sel = chunk if cols is None else chunk[:, cols]
            out[a : a + block] = sel.sum(axis=1)
    return [_threshold(s) for s in sums]


def depth_normalize(matrix):
    """Per-sample depth normalization: each column / its total.

    Matches reference newref_tools.py:124-125 / predict_tools.py:44-45.
    Host numpy: the result is masked on host immediately after, so staging
    one elementwise division through the device would only add transfers.
    """
    matrix = np.asarray(matrix)
    return matrix / matrix.sum(axis=0)
