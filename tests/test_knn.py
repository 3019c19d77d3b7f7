"""Parity tests: KNN within-sample reference search vs the reference's
bisect-insertion loop (newref_tools.py:155-278)."""

import random

import numpy as np
import pytest

from synthetic import CohortSim
from wisecondorx_tpu.genome import MaskedLayout, samples_to_matrix
from wisecondorx_tpu.ops import knn as knn_ops
from wisecondorx_tpu.ops import mask as mask_ops
from wisecondorx_tpu.ops import pca as pca_ops


def _prepped(genome_scale=0.015, n_f=8, n_m=6, seed=11, last_chr=22):
    sim = CohortSim(binsize=1e5, genome_scale=genome_scale, seed=seed)
    samples, _ = sim.cohort(n_f, n_m)
    matrix, layout = samples_to_matrix(samples)
    mask = mask_ops.get_mask(matrix)
    tl = layout.truncated(last_chr)
    tm = mask[: tl.total_bins]
    normed = np.asarray(mask_ops.depth_normalize(matrix[: tl.total_bins]))
    masked = normed[tm]
    corrected, _, _ = pca_ops.train_pca(masked)
    ml = MaskedLayout(tl, tm)
    return corrected, ml


@pytest.fixture(scope="module")
def prepped():
    return _prepped()


def test_knn_matches_reference(ref_modules, prepped):
    corrected, ml = prepped
    ref_size = 60

    ref_idx, ref_dist, _ = ref_modules["newref_tools"].get_reference(
        corrected,
        ml.masked_bins_per_chr,
        ml.masked_bins_per_chr_cum,
        ref_size=ref_size,
        part=1,
        split_parts=1,
    )

    idx, dist = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=ref_size,
        col_tile=256,
    )

    np.testing.assert_allclose(dist, ref_dist, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(idx, ref_idx)


def test_knn_row_tiling_consistent(prepped):
    corrected, ml = prepped
    full_idx, full_dist = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=40,
        col_tile=128,
    )
    tiled_idx, tiled_dist = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=40,
        col_tile=512,
        row_tile=173,
    )
    np.testing.assert_array_equal(full_idx, tiled_idx)
    np.testing.assert_allclose(full_dist, tiled_dist, rtol=1e-12)


def test_knn_unfilled_slots_sentinels(ref_modules):
    """ref_size larger than the candidate pool -> -1 / 1e10 sentinel slots."""
    corrected, ml = _prepped(genome_scale=0.0012, n_f=6, n_m=5, seed=5)
    ref_size = corrected.shape[0]  # guaranteed > candidates per row

    ref_idx, ref_dist, _ = ref_modules["newref_tools"].get_reference(
        corrected,
        ml.masked_bins_per_chr,
        ml.masked_bins_per_chr_cum,
        ref_size=ref_size,
        part=1,
        split_parts=1,
    )
    idx, dist = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=ref_size,
        col_tile=128,
    )
    assert (idx == -1).any(), "expected unfilled sentinel slots in this setup"
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(dist, ref_dist, rtol=1e-9, atol=1e-12)


def test_gonosome_pass_rows(ref_modules):
    """F-pass (23 chromosomes): only chrX rows are searched; the reference
    emits zero/one placeholders for autosome rows (newref_tools.py:186-191)."""
    corrected, ml = _prepped(genome_scale=0.01, last_chr=23, seed=13)
    ref_size = 30

    ref_idx, ref_dist, _ = ref_modules["newref_tools"].get_reference(
        corrected,
        ml.masked_bins_per_chr,
        ml.masked_bins_per_chr_cum,
        ref_size=ref_size,
        part=1,
        split_parts=1,
    )

    x_start = int(ml.masked_chr_starts[22])
    x_end = int(ml.masked_bins_per_chr_cum[22])
    idx, dist = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=ref_size,
        row_range=(x_start, x_end),
        col_tile=256,
    )
    np.testing.assert_array_equal(idx, ref_idx[x_start:x_end])
    np.testing.assert_allclose(
        dist, ref_dist[x_start:x_end], rtol=1e-9, atol=1e-12
    )
    # reference placeholder rows for autosomes
    assert (ref_idx[:x_start] == 0).all()
    assert (ref_dist[:x_start] == 1.0).all()


def test_null_ratios_match_reference(ref_modules, prepped):
    corrected, ml = prepped
    ref_size = 50

    random.seed(42)
    ref_idx, _, ref_null = ref_modules["newref_tools"].get_reference(
        corrected,
        ml.masked_bins_per_chr,
        ml.masked_bins_per_chr_cum,
        ref_size=ref_size,
        part=1,
        split_parts=1,
    )
    random.seed(42)
    chosen = random.sample(
        range(corrected.shape[1]), min(corrected.shape[1], 100)
    )

    ours = knn_ops.compute_null_ratios(corrected, ref_idx, np.array(chosen))
    np.testing.assert_allclose(ours, ref_null, rtol=1e-12, atol=0)


def test_null_ratios_jax_backend_matches_numpy(prepped):
    corrected, ml = prepped
    idx, _ = knn_ops.knn_search(
        corrected,
        ml.chr_of_masked_bin,
        ml.masked_chr_starts,
        ml.masked_bins_per_chr,
        ref_size=40,
        col_tile=256,
    )
    ids = np.arange(corrected.shape[1])
    a = knn_ops.compute_null_ratios(corrected, idx, ids, backend="numpy")
    b = knn_ops.compute_null_ratios(corrected, idx, ids, backend="jax")
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_xla_partial_merge_matches_sort():
    """The "partial" (approx_max_k) merge must equal "sort" on tie-free
    data."""
    from knn_oracle import layout

    rng = np.random.default_rng(11)
    bins_per_chr = [300, 250, 200]
    starts, chr_of_bin = layout(bins_per_chr)
    n = int(sum(bins_per_chr))
    data = rng.lognormal(0, 0.02, size=(n, 24))

    idx_s, dist_s = knn_ops.knn_search(
        data, chr_of_bin, starts, bins_per_chr, ref_size=25, col_tile=128,
    )
    idx_m, dist_m = knn_ops.knn_search(
        data, chr_of_bin, starts, bins_per_chr, ref_size=25,
        col_tile=128, merge_method="partial",
    )
    np.testing.assert_allclose(
        np.sort(dist_m, axis=1), np.sort(dist_s, axis=1), rtol=1e-12
    )
    for r in range(n):
        assert set(idx_m[r]) == set(idx_s[r])


def test_knn_matches_brute_force_oracle(prepped):
    """The float64 search equals the independent brute-force oracle:
    identical neighbour order (bisect tie order) and distances."""
    from knn_oracle import brute_force_knn

    corrected, ml = prepped
    idx_o, dist_o = brute_force_knn(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, 30,
    )
    idx, dist = knn_ops.knn_search(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, ref_size=30, col_tile=128, row_tile=100,
    )
    np.testing.assert_array_equal(idx, idx_o)
    np.testing.assert_allclose(dist, dist_o, rtol=1e-9, atol=1e-15)


def test_null_ratios_device_matches_host():
    """The all-device null-ratio driver must reproduce the host table,
    including the -1 wraparound quirk and gonosomal placeholder rows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    n, s, k = 700, 12, 9
    data = rng.lognormal(0, 0.1, size=(n, s))
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    idx[3, :4] = -1  # sentinel slots -> numpy wraparound parity
    chosen = np.array([0, 2, 5, 7])

    host = knn_ops.compute_null_ratios(data, idx, chosen, backend="numpy")
    dev = knn_ops.compute_null_ratios_device(
        jnp.asarray(data), jnp.asarray(idx), chosen
    )
    np.testing.assert_allclose(dev, host, rtol=1e-12)

    # Gonosomal shape: placeholder zero-index rows prepended on device.
    r0 = 300
    idx_g = idx.copy()
    idx_g[:r0] = 0
    host_g = knn_ops.compute_null_ratios(
        data, idx_g, chosen, backend="numpy"
    )
    dev_g = knn_ops.compute_null_ratios_device(
        jnp.asarray(data), jnp.asarray(idx[r0:]), chosen,
        placeholder_rows=r0,
    )
    np.testing.assert_allclose(dev_g, host_g, rtol=1e-12)
    # Unfetched chunks assemble to the same table.
    parts = knn_ops.compute_null_ratios_device(
        jnp.asarray(data), jnp.asarray(idx[r0:]), chosen,
        placeholder_rows=r0, fetch=False,
    )
    np.testing.assert_array_equal(
        knn_ops.assemble_null_ratio_rows(parts, n), dev_g
    )
