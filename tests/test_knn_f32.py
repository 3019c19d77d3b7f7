"""float32 numerics of the KNN search (the accelerator path).

Accelerators run the search in float32 on centred + rescaled data (see
ops/knn.py); parity tests run float64.  These tests hold the f32 path
against the brute-force float64 oracle in tests/knn_oracle.py and quantify
what the dtype difference does to (a) the neighbour sets and (b) the
*call-level* outputs — the per-bin ratios and z-scores the segmentation
consumes — on a realistic synthetic cohort.

Documented bound (asserted below): >= 99% of neighbours agree, and the
downstream per-bin log2 ratios and z-scores from the f32 neighbour sets
match the f64-oracle ones to < 1e-2 absolute everywhere, < 1e-3 at the
median.  Divergent neighbours are near-ties whose substitution moves the
300-neighbour statistics by less than the assay noise floor.
"""

import jax
import jax.numpy as jnp
import numpy as np

from knn_oracle import SENTINEL, brute_force_knn, layout
from synthetic import CohortSim
from wisecondorx_tpu.genome import MaskedLayout, samples_to_matrix
from wisecondorx_tpu.ops import knn as knn_ops
from wisecondorx_tpu.ops import mask as mask_ops
from wisecondorx_tpu.ops import normalize as norm_ops
from wisecondorx_tpu.ops import pca as pca_ops


def _cohort(seed=17, n_f=10, n_m=8, genome_scale=0.012):
    sim = CohortSim(binsize=1e5, genome_scale=genome_scale, seed=seed)
    samples, _ = sim.cohort(n_f, n_m)
    matrix, layout_ = samples_to_matrix(samples)
    m = mask_ops.get_mask(matrix)
    tl = layout_.truncated(22)
    tm = m[: tl.total_bins]
    normed = np.asarray(mask_ops.depth_normalize(matrix[: tl.total_bins]))
    corrected, comps, mean = pca_ops.train_pca(normed[tm])
    return corrected, MaskedLayout(tl, tm)


def _search32(data, chr_of_bin, starts, sizes, ref_size, **kw):
    kw.setdefault("col_tile", 128)
    return knn_ops.knn_search(
        np.asarray(data, np.float32), chr_of_bin, starts, sizes,
        ref_size=ref_size, **kw,
    )


def test_f32_neighbour_and_call_level_divergence():
    corrected, ml = _cohort()
    ref_size = 60

    idx64, dist64 = brute_force_knn(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, ref_size,
    )
    idx32, dist32 = _search32(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, ref_size, col_tile=256,
    )
    assert dist32.dtype == np.float32

    n = corrected.shape[0]
    overlap = np.array(
        [len(np.intersect1d(a, b)) for a, b in zip(idx64, idx32)]
    )
    agreement = overlap.mean() / ref_size
    assert agreement >= 0.99, f"neighbour agreement {agreement:.4f}"

    # Call-level effect: run the predict-stage normalization with each
    # neighbour set on a held-out synthetic test sample and compare the
    # per-bin ratios / z-scores that CBS consumes.
    rng = np.random.default_rng(99)
    test = corrected[:, 0] * rng.lognormal(0.0, 0.01, size=n)

    out = {}
    for tag, idx, dist in (("f64", idx64, dist64), ("f32", idx32, dist32)):
        gi = ml.neighbour_to_global(idx)
        cutoff = norm_ops.get_optimal_cutoff(dist.astype(np.float64), 5)
        z, r, sizes, m_lr, m_z = norm_ops.normalize_repeat(
            test, gi, dist.astype(np.float64), cutoff
        )
        out[tag] = (z, r)

    z64, r64 = out["f64"]
    z32, r32 = out["f32"]
    with np.errstate(divide="ignore", invalid="ignore"):
        lr64 = np.log2(r64)
        lr32 = np.log2(r32)
    both = np.isfinite(lr64) & np.isfinite(lr32)
    assert both.mean() > 0.99
    dlr = np.abs(lr64[both] - lr32[both])
    dz = np.abs(z64[both] - z32[both])
    assert np.median(dlr) < 1e-3, f"median dlog2r {np.median(dlr):.2e}"
    assert np.max(dlr) < 1e-2, f"max dlog2r {np.max(dlr):.2e}"
    assert np.median(dz) < 5e-3, f"median dz {np.median(dz):.2e}"
    assert np.max(dz) < 5e-2, f"max dz {np.max(dz):.2e}"


def test_integer_exact_match():
    """Small-integer data: the f32 result must equal the f64 oracle (as
    sets where the k boundary is not tied; distances to f32 rounding of
    the centring round trip)."""
    rng = np.random.default_rng(7)
    bins_per_chr = [400, 350, 274]
    starts, chr_of_bin = layout(bins_per_chr)
    data = rng.integers(0, 8, size=(sum(bins_per_chr), 16)).astype(np.float64)

    idx_o, dist_o = brute_force_knn(data, chr_of_bin, starts, bins_per_chr, 20)
    # k+1 oracle: a row's top-20 SET is unique iff the 21st smallest
    # distance strictly exceeds the 20th.
    _, dist_o21 = brute_force_knn(data, chr_of_bin, starts, bins_per_chr, 21)
    idx_p, dist_p = _search32(data, chr_of_bin, starts, bins_per_chr, 20)
    np.testing.assert_allclose(
        np.sort(dist_p, axis=1).astype(np.float64),
        np.sort(dist_o, axis=1), rtol=1e-5, atol=1e-5,
    )
    unique_set = dist_o21[:, 20] > dist_o21[:, 19]
    for r in np.nonzero(unique_set)[0]:
        assert set(idx_p[r]) == set(idx_o[r]), f"row {r}"


def test_realistic_cohort_agreement():
    """PCA-corrected cohort data (the production distribution): the f32
    path must agree with the f64 oracle on >= 99% of neighbours and on
    distance values to ~1e-4 relative at the median."""
    corrected, ml = _cohort(seed=11, n_f=8, n_m=6, genome_scale=0.01)
    ref_size = 40
    idx_o, dist_o = brute_force_knn(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, ref_size,
    )
    idx_p, dist_p = _search32(
        corrected, ml.chr_of_masked_bin, ml.masked_chr_starts,
        ml.masked_bins_per_chr, ref_size,
    )
    agree = np.mean(
        [len(np.intersect1d(a, b)) for a, b in zip(idx_o, idx_p)]
    ) / ref_size
    assert agree > 0.99, f"neighbour agreement {agree:.4f}"
    srt = np.sort(dist_o, axis=1)
    rel = np.abs(np.sort(dist_p, axis=1).astype(np.float64) - srt) / srt
    assert np.median(rel) < 1e-4
    assert np.max(rel) < 5e-2


def test_gonosome_row_range():
    rng = np.random.default_rng(23)
    bins_per_chr = [500, 400, 128]
    starts, chr_of_bin = layout(bins_per_chr)
    n = int(sum(bins_per_chr))
    data = rng.integers(0, 8, size=(n, 16)).astype(np.float64)
    rr = (900, n)

    _, dist_o = brute_force_knn(
        data, chr_of_bin, starts, bins_per_chr, 15, row_range=rr
    )
    idx_p, dist_p = _search32(
        data, chr_of_bin, starts, bins_per_chr, 15, row_range=rr,
        row_tile=64,
    )
    assert idx_p.shape == (n - 900, 15)
    np.testing.assert_allclose(
        np.sort(dist_p, axis=1).astype(np.float64),
        np.sort(dist_o, axis=1), rtol=1e-5, atol=1e-5,
    )


def test_unfilled_slots_sentinels():
    """ref_size > candidate pool: unfilled slots must be -1 / 1e10."""
    rng = np.random.default_rng(5)
    bins_per_chr = [40, 30, 20]
    starts, chr_of_bin = layout(bins_per_chr)
    n = int(sum(bins_per_chr))
    data = rng.integers(0, 8, size=(n, 8)).astype(np.float64)

    idx_o, dist_o = brute_force_knn(data, chr_of_bin, starts, bins_per_chr, n)
    idx_p, dist_p = _search32(data, chr_of_bin, starts, bins_per_chr, n)
    assert (idx_p == -1).any()
    np.testing.assert_array_equal(idx_p == -1, idx_o == -1)
    np.testing.assert_array_equal(dist_p == SENTINEL, dist_o == SENTINEL)


def test_far_candidates_stay_unselected():
    """Candidates at distance >= 1e10 are never selected, whatever the
    centring and rescaling do to the working units."""
    rng = np.random.default_rng(2)
    bins_per_chr = [30, 30, 30]
    starts, chr_of_bin = layout(bins_per_chr)
    data = rng.normal(0.0, 1.0, size=(90, 4))
    data[60:, 0] += 2e5  # chr3: ~4e10 away from chr1/chr2 bins
    idx_o, dist_o = brute_force_knn(data, chr_of_bin, starts, bins_per_chr, 40)
    idx_p, dist_p = _search32(data, chr_of_bin, starts, bins_per_chr, 40)
    # chr1/chr2 rows see only the 30 bins of the other near chromosome.
    assert (idx_o[:60, 30:] == -1).all()
    np.testing.assert_array_equal(idx_p == -1, idx_o == -1)
    np.testing.assert_array_equal(dist_p[:60, 30:], SENTINEL)
    assert (dist_p[idx_p >= 0] < SENTINEL).all()


def test_empty_row_range():
    idx, dist = knn_ops.knn_search(
        np.ones((10, 4), np.float32), np.zeros(10, np.int32), [0], [10],
        ref_size=5, row_range=(10, 10),
    )
    assert idx.shape == (0, 5) and dist.shape == (0, 5)


def test_device_out_matches_host_result():
    """The device-resident index output equals the host result, and the
    pre-fetch hook's arrays come back fetched, over several row tiles."""
    rng = np.random.default_rng(31)
    bins_per_chr = [700, 500, 324]
    starts, chr_of_bin = layout(bins_per_chr)
    data = rng.lognormal(0, 0.05, size=(sum(bins_per_chr), 16))

    idx_o, dist_o = brute_force_knn(data, chr_of_bin, starts, bins_per_chr, 20)
    dev_out = {}

    def hook(dv):
        return [dv["indexes"] + 1]

    idx_p, dist_p = _search32(
        data, chr_of_bin, starts, bins_per_chr, 20, row_tile=256,
        device_out=dev_out, pre_fetch_hook=hook,
    )
    assert isinstance(dev_out["indexes"], jax.Array)
    np.testing.assert_array_equal(np.asarray(dev_out["indexes"]), idx_p)
    np.testing.assert_array_equal(dev_out["prefetched"][0], idx_p + 1)
    agree = np.mean(
        [len(np.intersect1d(a, b)) for a, b in zip(idx_o, idx_p)]
    ) / 20
    assert agree > 0.999
    # A device-resident input gives the same result as a host one.
    idx_d, dist_d = knn_ops.knn_search(
        jnp.asarray(data, jnp.float32), chr_of_bin, starts, bins_per_chr,
        ref_size=20, col_tile=128, row_tile=256,
    )
    np.testing.assert_array_equal(idx_d, idx_p)
    np.testing.assert_array_equal(dist_d, dist_p)


def test_knn_kernel_lowers_with_highest_precision():
    """Every KNN matmul asks for HIGHEST precision (strict f32, no TF32 on
    the H100's tensor cores) in the lowered program."""
    rows = jnp.zeros((8, 4), jnp.float32)
    data = jnp.zeros((16, 4), jnp.float32)
    lowered = knn_ops._knn_kernel.lower(
        rows, data, jnp.zeros(8, jnp.int32), jnp.zeros(16, jnp.int32),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), jnp.int32(16),
        jnp.float32(1e10), ref_size=4, col_tile=8,
    )
    text = lowered.as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert all("HIGHEST" in ln for ln in dots), dots
