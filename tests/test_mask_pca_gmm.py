"""Parity tests for the mask builder, PCA normalizer and the sex model."""

import numpy as np
import pytest

from synthetic import CohortSim
from wisecondorx_tpu.genome import GenomeLayout, MaskedLayout, samples_to_matrix
from wisecondorx_tpu.ops import gmm as gmm_ops
from wisecondorx_tpu.ops import mask as mask_ops
from wisecondorx_tpu.ops import pca as pca_ops


@pytest.fixture(scope="module")
def cohort():
    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=3)
    samples, genders = sim.cohort(12, 10)
    return sim, samples, genders


def test_get_mask_matches_reference(ref_modules, cohort):
    _, samples, _ = cohort
    matrix, layout = samples_to_matrix(samples)
    ours = mask_ops.get_mask(matrix)
    theirs_mask, theirs_bpc = ref_modules["newref_tools"].get_mask(samples)
    np.testing.assert_array_equal(layout.bins_per_chr, theirs_bpc)
    np.testing.assert_array_equal(ours, theirs_mask)


def test_masked_layout_tables(cohort):
    _, samples, _ = cohort
    matrix, layout = samples_to_matrix(samples)
    mask = mask_ops.get_mask(matrix)
    ml = MaskedLayout(layout, mask)
    # masked_bins_per_chr mirrors reference newref_control.py:60-66
    bpc = layout.bins_per_chr
    expected = [
        int(np.sum(mask[int(np.sum(bpc[:i])) : int(np.sum(bpc[:i])) + int(x)]))
        for i, x in enumerate(bpc)
    ]
    np.testing.assert_array_equal(ml.masked_bins_per_chr, expected)
    np.testing.assert_array_equal(
        ml.masked_bins_per_chr_cum, np.cumsum(expected)
    )
    assert ml.n_masked == int(mask.sum())


def test_neighbour_to_global_roundtrip():
    layout = GenomeLayout([4, 3, 5])
    mask = np.ones(12, dtype=bool)
    mask[[1, 7]] = False  # drop one bin on chr1 and chr3
    ml = MaskedLayout(layout, mask)
    # chromosome of each of the 10 masked bins: 0,0,0,1,1,1,2,2,2,2
    # For a target on chr2 (masked size 3, start 3), excluded space is
    # [0,1,2, 6,7,8,9] -> global [0,1,2, 6,7,8,9]
    idx = np.array([[0, 2, 3, 6]])  # for one chr-2 bin
    target_rows = np.nonzero(ml.chr_of_masked_bin == 1)[0]
    full = np.zeros((ml.n_masked, 4), dtype=np.int64)
    full[target_rows] = idx
    out = ml.neighbour_to_global(full)
    np.testing.assert_array_equal(out[target_rows[0]], [0, 2, 6, 9])


def test_train_pca_matches_full_svd(cohort):
    """Gram-eigh PCA must match sklearn's exact (svd_solver='full') PCA.

    Note: the reference calls sklearn PCA with the default 'auto' solver,
    which for bins >> 500 picks *randomized* SVD with an unseeded RNG — the
    reference's own PCA output is a nondeterministic approximation.  The
    exact decomposition is the correct oracle for both.
    """
    from sklearn.decomposition import PCA

    _, samples, _ = cohort
    matrix, layout = samples_to_matrix(samples)
    mask = mask_ops.get_mask(matrix)
    normed = np.asarray(mask_ops.depth_normalize(matrix))
    masked = normed[mask]

    corrected, components, mean = pca_ops.train_pca(masked)

    t_data = masked.T
    ref_pca = PCA(n_components=5, svd_solver="full")
    ref_pca.fit(t_data)
    inversed = ref_pca.inverse_transform(ref_pca.transform(t_data))
    ref_corrected = (t_data / inversed).T

    # rtol headroom: bins whose rank-5 reconstruction is ~0 amplify fp error
    # through the division; everything else matches to ~1e-12.
    np.testing.assert_allclose(corrected, ref_corrected, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(mean, ref_pca.mean_, rtol=1e-9)
    # components match up to sign
    for k in range(5):
        dots = np.abs(np.dot(components[k], ref_pca.components_[k]))
        np.testing.assert_allclose(dots, 1.0, rtol=1e-6)


def test_project_sample_matches_sklearn_semantics(cohort):
    _, samples, _ = cohort
    matrix, layout = samples_to_matrix(samples)
    mask = mask_ops.get_mask(matrix)
    normed = np.asarray(mask_ops.depth_normalize(matrix))
    masked = normed[mask]
    _, components, mean = pca_ops.train_pca(masked)

    test_vec = masked[:, 0]
    ours = np.asarray(pca_ops.project_sample(test_vec, components, mean))

    # Oracle: sklearn transform/inverse_transform semantics written out
    # (whiten=False): transform = (x - mean) @ C^T; reconstruction adds the
    # mean back (reference predict_tools.py:56-65).  The reference function
    # itself crashes on sklearn>=1.5 (hand-assembled PCA object lacks
    # explained_variance_), so the formula is the oracle.
    coeffs = (test_vec - mean) @ components.T
    reconstructed = coeffs @ components + mean
    theirs = test_vec / reconstructed
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-12)


def test_gender_model(cohort):
    _, samples, genders_true = cohort
    genders, cutoff, fit = gmm_ops.train_gender_model(samples)
    assert genders == genders_true
    assert 0 < cutoff < 0.02
    for s, g in zip(samples, genders_true):
        assert gmm_ops.predict_gender(s, cutoff) == g


def test_gender_model_override(cohort):
    _, samples, genders_true = cohort
    genders, cutoff, _ = gmm_ops.train_gender_model(samples, yfrac_override=0.004)
    assert cutoff == 0.004


def test_gender_model_reference_config_parity(cohort, ref_modules):
    """Round-1 gap: the reference's exact GMM configuration (tol=1e-99,
    unseeded init) was never parity-tested.  Run the reference's own
    train_gender_model as the oracle and ours with the replication knobs
    (tol=1e-99, random_state=None): cutoff and genders must agree."""
    import types

    _, samples, genders_true = cohort
    args = types.SimpleNamespace(yfrac=None, plotyfrac=None)
    ref_genders, ref_cutoff = ref_modules["newref_tools"].train_gender_model(
        args, samples
    )

    genders, cutoff, _ = gmm_ops.train_gender_model(
        samples, random_state=None, tol=1e-99
    )
    assert genders == ref_genders
    np.testing.assert_allclose(cutoff, ref_cutoff, rtol=0, atol=4e-6)
    # 4e-6 = one grid step of the 5000-point density grid: EM from a
    # different unseeded k-means init can move the density minimum by at
    # most a knot under these well-separated cohorts.


@pytest.mark.parametrize(
    "seed,n_f,n_m,separated",
    [(0, 10, 8, False), (3, 30, 30, False), (5, 12, 6, True)],
)
def test_gmm_matches_sklearn(seed, n_f, n_m, separated):
    """The numpy EM reproduces sklearn's GaussianMixture fit with the
    reference's hyper-parameters: same density on the cutoff grid, same
    cutoff, same genders — including a fully separated cohort whose
    inter-mode density underflows to zero."""
    from sklearn.mixture import GaussianMixture

    sim = CohortSim(binsize=1e5, genome_scale=0.02, seed=seed)
    samples, _ = sim.cohort(n_f, n_m)
    if separated:
        for s in samples[:n_f]:
            s["24"] = np.zeros_like(s["24"])
    yf = np.array([gmm_ops.y_fraction(s) for s in samples])
    sk = GaussianMixture(
        n_components=2, covariance_type="full", reg_covar=1e-99,
        max_iter=10000, tol=1e-12, random_state=0,
    ).fit(yf.reshape(-1, 1))
    ours = gmm_ops._Gmm1d(1e-99, 10000, 1e-12, 0).fit(yf)
    np.testing.assert_allclose(ours.means_, sk.means_.ravel(), rtol=1e-12)
    np.testing.assert_allclose(
        np.exp(ours.score_samples(gmm_ops.GRID)),
        np.exp(sk.score_samples(gmm_ops.GRID.reshape(-1, 1))),
        rtol=1e-9, atol=1e-300,
    )
    genders, cutoff, _ = gmm_ops.train_gender_model(samples)
    dens = np.exp(sk.score_samples(gmm_ops.GRID.reshape(-1, 1)))
    minima = gmm_ops._strict_local_minima(dens)
    if len(minima):
        assert cutoff == float(gmm_ops.GRID[minima[0]])
    assert genders == ["F"] * n_f + ["M"] * n_m
