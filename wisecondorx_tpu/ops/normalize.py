"""Predict-stage normalization kernels.

Replaces the reference's per-bin Python loops (predict_tools.py:94-142) with
fixed-shape JAX kernels:

* coverage normalization + masking of the test sample;
* the iterative within-sample normalization: per target bin, statistics over
  its precomputed neighbour set, with aberrant bins (|z| above the 99th
  normal percentile) progressively removed from *serving* as references via
  the reference's ``-1`` sentinel (predict_tools.py:104);
* the distance-derived "optimal cutoff" and per-bin weights.

The neighbour gather uses *global* masked indexes precomputed once from the
reference's own-chromosome-excluded index space
(:meth:`wisecondorx_tpu.genome.MaskedLayout.neighbour_to_global`), removing
the per-chromosome array concatenation of predict_tools.py:125-130 from the
hot path entirely.

Transfer-economy design: the predict path moves far more bytes than it
computes on, so the optimal-cutoff and weight computations run on HOST
numpy in float64 —
bit-identical to the reference's math (predict_tools.py:74-82, 152-155)
and free of a 229 MB f32 distance upload each — and the cutoff decision
``distance < cutoff`` is folded into the neighbour-index upload itself:
excluded neighbours become ``-1`` sentinels in the int32 index table, so
ONE [rows, k] int32 array per pass is the only bulk transfer the predict
path makes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from wisecondorx_tpu.ops.common import masked_mean, masked_median, masked_std

#: scipy.stats.norm.ppf(0.99) — the reference's aberrant-bin z threshold
#: (predict_tools.py:104).
Z_MASK_THRESHOLD = 2.3263478740408408


def coverage_normalize_and_mask(
    sample: dict, bins_per_chr: np.ndarray, mask: np.ndarray
) -> np.ndarray:
    """Pad/truncate each chromosome to the reference layout, depth-normalize
    over the pass's chromosome range, apply the mask
    (reference predict_tools.py:32-48)."""
    parts = []
    for c, n_bins in enumerate(np.asarray(bins_per_chr)):
        arr = np.zeros(int(n_bins), dtype=np.float64)
        chr_data = np.asarray(sample[str(c + 1)])
        m = min(int(n_bins), len(chr_data))
        arr[:m] = chr_data[:m]
        parts.append(arr)
    all_data = np.concatenate(parts)
    all_data = all_data / np.sum(all_data)
    return all_data[np.asarray(mask, dtype=bool)]


def get_optimal_cutoff(distances: np.ndarray, repeats: int) -> float:
    """Iterative mean+3*std over reference distances (reference
    predict_tools.py:74-82) — host numpy in float64: exact reference
    parity, and it spares the device a full distance-table upload.

    ``repeats <= 0`` means no distance masking at all: the reference's
    loop body never executes and the initial ``float("inf")`` cutoff is
    returned unchanged (predict_tools.py:75-82)."""
    if repeats <= 0:
        return float("inf")
    return float(optimal_cutoff_schedule(distances, repeats)[repeats - 1])


#: Cutoff-iteration depths precomputed into the reference npz cache
#: (``wcx_cutoffs``); covers every practical ``--maskrepeats``.
CUTOFF_CACHE_REPEATS = 10


def optimal_cutoff_schedule(
    distances: np.ndarray, max_repeats: int = CUTOFF_CACHE_REPEATS
) -> np.ndarray:
    """Cutoff value after each of 1..max_repeats iterations — the exact
    sequence :func:`get_optimal_cutoff` walks, so ``schedule[r-1] ==
    get_optimal_cutoff(d, r)``.  newref caches this (it is a pure
    function of the stored distance table) so predict can skip both the
    distance-table decompression and ~10 s of host float64 statistics."""
    distances = np.asarray(distances, dtype=np.float64)
    out = []
    cutoff = np.inf
    prev_n = -1
    for _ in range(max_repeats):
        sel = distances[distances < cutoff]
        if sel.size == prev_n:
            # The selection is unchanged, so every further iteration
            # yields the same mean/std/cutoff — fill and stop (exact).
            out.extend([cutoff] * (max_repeats - len(out)))
            break
        prev_n = sel.size
        cutoff = float(np.mean(sel) + 3 * np.std(sel))
        out.append(cutoff)
    return np.array(out)


def get_weights(distances: np.ndarray) -> np.ndarray:
    """weight_i = 1 / mean(sqrt(distances_i)) (reference
    predict_tools.py:152-155); host float64 — see :func:`get_optimal_cutoff`.

    Row-independent, so calling it on a row slice equals slicing the
    full-table result.

    Degenerate rows (a too-small reference can leave placeholder or
    negative distances) yield NaN weights exactly as the reference's
    expression does; the predict assembler detects those and falls back
    to unweighted CBS with an explicit warning (predictor.py), so the
    raw numpy RuntimeWarning is suppressed here — the logged fallback is
    the intended signal."""
    distances = np.asarray(distances, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return 1.0 / np.mean(np.sqrt(distances), axis=1)


def sentinel_indexes(
    global_idx: np.ndarray, distances: np.ndarray, optimal_cutoff: float
) -> np.ndarray:
    """Fold the ``distance < cutoff`` neighbour filter into the index
    table: excluded neighbours become ``-1``.  The result is the ONLY
    bulk array the normalization kernel needs on device.

    The comparison runs in float64 regardless of the stored distance
    dtype — matching the native kernel (tablekit.cpp casts each f32 to
    double) and the wcx_distok cache; comparing an f32 table against the
    f64 cutoff at f32 precision (numpy's scalar-cast default) can flip
    boundary neighbours between hosts with and without the native
    library."""
    return np.where(
        np.asarray(distances, dtype=np.float64) < optimal_cutoff,
        global_idx,
        -1,
    ).astype(np.int32)


#: Target rows processed per gather block — bounds peak memory of the
#: [block, k] neighbour gather + sort (and its vmapped [batch, block, k]
#: counterpart) so XLA never materializes the full [targets, k] tensor in
#: an unfavourable layout.
NORMALIZE_BLOCK = 16384


@functools.partial(jax.jit, static_argnames=("rounds", "ct"))
def _normalize_repeat_kernel(
    test_data,  # [n] masked pass-space sample values
    global_idx,  # int32[n - ct, k] neighbour indexes into [n]; -1 excluded
    ct: int,
    rounds: int = 3,
):
    """The reference's three-round z-masked normalization
    (predict_tools.py:94-142), fully vectorized over target bins.

    ``global_idx`` carries the distance-cutoff filter as ``-1`` sentinels
    (:func:`sentinel_indexes`).  ``test_copy`` starts as the sample and
    accumulates -1 sentinels at bins whose |z| crossed the threshold in
    any earlier round, so that they stop serving as references;
    statistics always use the *original* values (``test_data``) for the
    targets themselves.  The neighbour gather + masked statistics run as
    a sequential map over fixed-size row blocks.
    """
    targets = test_data[ct:]
    m, k = global_idx.shape
    block = min(NORMALIZE_BLOCK, max(8, m))
    n_blocks = -(-m // block)
    pad = n_blocks * block - m
    gi = jnp.pad(global_idx, ((0, pad), (0, 0))).reshape(n_blocks, block, k)

    def one_round(test_copy):
        def per_block(gi_b):
            neigh = test_copy[jnp.maximum(gi_b, 0)]  # [block, k]
            valid = (gi_b >= 0) & (neigh >= 0)
            return (
                masked_mean(neigh, valid),
                masked_std(neigh, valid),
                masked_median(neigh, valid),
                jnp.sum(valid, axis=1),
            )

        mean, std, med, sizes = jax.lax.map(per_block, gi)
        mean = mean.reshape(-1)[:m]
        std = std.reshape(-1)[:m]
        med = med.reshape(-1)[:m]
        ref_sizes = sizes.reshape(-1)[:m]
        z = (targets - mean) / std
        r = targets / med
        return z, r, ref_sizes

    test_copy = test_data
    z = r = ref_sizes = None
    for _ in range(rounds):
        z, r, ref_sizes = one_round(test_copy)
        aberrant = jnp.abs(z) >= Z_MASK_THRESHOLD  # NaN -> False, as in numpy
        test_copy = test_copy.at[ct:].set(
            jnp.where(aberrant, -1.0, test_copy[ct:])
        )

    log_r = jnp.log2(r)
    m_lr = jnp.nanmedian(log_r)
    m_z = jnp.nanmedian(z)
    return z, r, ref_sizes, m_lr, m_z


def normalize_repeat_pre(test_data, sentinel_idx, ct: int = 0, rounds: int = 3):
    """Run the within-sample normalization from a prebuilt (possibly
    already device-resident) sentinel index table.

    Returns host (z, r, ref_sizes, m_lr, m_z) over the target rows.
    """
    z, r, ref_sizes, m_lr, m_z = _normalize_repeat_kernel(
        jnp.asarray(test_data),
        sentinel_idx
        if isinstance(sentinel_idx, jax.Array)
        else jnp.asarray(sentinel_idx, dtype=jnp.int32),
        ct=int(ct),
        rounds=rounds,
    )
    return (
        np.asarray(z),
        np.asarray(r),
        np.asarray(ref_sizes, dtype=np.float64),
        float(m_lr),
        float(m_z),
    )


def normalize_repeat(
    test_data: np.ndarray,
    global_idx: np.ndarray,
    distances: np.ndarray,
    optimal_cutoff: float,
    ct: int = 0,
    rounds: int = 3,
):
    """Run the within-sample normalization for one pass.

    Parameters
    ----------
    test_data : [n] masked, coverage-normalized, PCA-projected sample.
    global_idx : int[n - ct, k] global-space neighbour indexes for the
        target rows (``ct`` is the first target row: 0 for the autosomal
        pass, the pre-gonosomal bin count for F/M passes —
        reference predict_control.py:22-29).
    distances : [n - ct, k] neighbour distances for the target rows.

    Returns (z, r, ref_sizes, m_lr, m_z) over the target rows.
    """
    return normalize_repeat_pre(
        test_data,
        sentinel_indexes(global_idx, distances, optimal_cutoff),
        ct=ct,
        rounds=rounds,
    )
