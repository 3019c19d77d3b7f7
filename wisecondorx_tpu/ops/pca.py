"""PCA between-sample normalization — Gram-matrix form.

The reference fits scikit-learn's ``PCA(n_components=5)`` on the samples x bins
matrix and divides each sample by its rank-5 reconstruction
(newref_tools.py:138-147); predict-side, the stored components/mean rebuild
the projection for the single test sample (predict_tools.py:56-65).

Device formulation: with X the centered samples x bins matrix, the top-k
right singular vectors are obtained from the k principal eigenvectors of the
small S x S Gram matrix ``X X^T`` (one matmul + a tiny eigh), avoiding a
200k-column SVD.  ``components_[j] = u_j^T X / ||u_j^T X||`` is unit-norm by
construction and the reconstruction ``U U^T X + mean`` is numerically
identical to scikit-learn's ``inverse_transform(transform(.))`` up to fp error,
including in the rank-deficient case (n_samples == n_components) where the
trailing singular value vanishes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from wisecondorx_tpu.ops.common import MATMUL_PRECISION


@jax.jit
def _gram_kernel(data_bs):
    """[bins, samples] -> (gram [S, S], mean [bins]) — one matmul."""
    x = data_bs.T  # [samples, bins]
    mean = jnp.mean(x, axis=0)
    xc = x - mean
    gram = jnp.dot(xc, xc.T, preferred_element_type=xc.dtype,
                   precision=MATMUL_PRECISION)
    return gram, mean


@jax.jit
def _correct_kernel(data_bs, mean, u):
    """Given the top-k Gram eigenvectors u [S, k], build unit components
    and divide out the rank-k reconstruction ``U U^T Xc + mean``."""
    x = data_bs.T
    xc = x - mean
    coeffs = jnp.dot(u.T, xc, preferred_element_type=xc.dtype,
                     precision=MATMUL_PRECISION)  # [k, bins]
    norms = jnp.linalg.norm(coeffs, axis=1, keepdims=True)
    components = coeffs / jnp.where(norms > 0, norms, 1.0)
    reconstructed = jnp.dot(
        u, coeffs, preferred_element_type=xc.dtype,
        precision=MATMUL_PRECISION,
    ) + mean
    corrected = x / reconstructed
    return corrected.T, components


def train_pca(
    data_bs: np.ndarray, n_components: int = 5, return_device: bool = False
):
    """Fit PCA on [bins, samples] data; divide out the rank-k reconstruction.

    The S x S Gram matrix and the correction are device matmuls; the tiny
    samples x samples eigendecomposition runs in host numpy float64.

    ``data_bs`` may be numpy or an already-device-resident jnp array; with
    ``return_device=True`` the corrected matrix is returned as a device
    array (skipping a [bins, samples] download + re-upload) —
    components/mean are small and always numpy.

    Returns (pca_corrected [bins, samples], components [k, bins], mean [bins]).
    """
    data_j = jnp.asarray(data_bs)
    gram, mean = _gram_kernel(data_j)
    _, eigvecs = np.linalg.eigh(np.asarray(gram))  # ascending
    u = jnp.asarray(
        np.ascontiguousarray(eigvecs[:, ::-1][:, :n_components]),
        dtype=data_j.dtype,
    )
    corrected, components = _correct_kernel(data_j, mean, u)
    if return_device:
        return corrected, np.asarray(components), np.asarray(mean)
    return np.asarray(corrected), np.asarray(components), np.asarray(mean)


@jax.jit
def project_sample(sample_bins, components, mean):
    """Divide a test sample by its PCA reconstruction.

    Matches reference predict_tools.py:56-65: ``transform`` is
    ``(x - mean) @ components^T`` and the reconstruction adds the mean back.
    Two small matvecs — XLA fuses these into the surrounding predict graph.
    """
    coeffs = jnp.dot(
        sample_bins - mean, components.T,
        preferred_element_type=sample_bins.dtype,
        precision=MATMUL_PRECISION,
    )
    reconstructed = jnp.dot(
        coeffs, components, preferred_element_type=sample_bins.dtype,
        precision=MATMUL_PRECISION,
    ) + mean
    return sample_bins / reconstructed
