"""Sex (gender) model: Gaussian mixture over chrY read fractions.

Mirrors reference newref_tools.py:21-68 / predict_tools.py:17-24.  This is a
tiny host-side model (N samples, 1-D) — per SURVEY.md section 7 it stays on
the host.  The reference fits scikit-learn's GaussianMixture; :class:`_Gmm1d`
reproduces that fit (k-means++/Lloyd initialization from a seeded
RandomState, then EM with the same update and stopping rules) in numpy for
the reference's 1-D, 2-component, full-covariance configuration, and the
cutoff is the first strict local minimum of the mixture density on a
5000-point grid over [0, 0.02].
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.special import logsumexp

GRID = np.linspace(0, 0.02, 5000)


class _Gmm1d:
    """Two-component 1-D Gaussian mixture, fitted like scikit-learn's
    ``GaussianMixture(n_components=2, covariance_type="full")`` with the
    default k-means initialization and ``n_init=1``.

    The arithmetic follows scikit-learn's own expressions (responsibility-
    weighted dot products, ``10 * eps`` on the component masses, cutoff on
    the change of the mean log-likelihood), so a fit from the same seed
    lands on the same parameters.
    """

    n_components = 2

    def __init__(self, reg_covar, max_iter, tol, random_state):
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

    def fit(self, x: np.ndarray) -> "_Gmm1d":
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        resp = np.zeros((x.size, self.n_components))
        resp[np.arange(x.size), self._kmeans_labels(x)] = 1.0
        self._m_step(x, resp)
        self.weights_ = self._nk / x.size
        lower_bound = -np.inf
        for _ in range(self.max_iter):
            prev = lower_bound
            log_prob_norm, log_resp = self._e_step(x)
            self._m_step(x, np.exp(log_resp))
            self.weights_ = self._nk / self._nk.sum()
            lower_bound = log_prob_norm
            if abs(lower_bound - prev) < self.tol:
                break
        return self

    def score_samples(self, x: np.ndarray) -> np.ndarray:
        return logsumexp(self._weighted_log_prob(x), axis=1)

    # -- internals --------------------------------------------------------

    def _kmeans_labels(self, x: np.ndarray) -> np.ndarray:
        """k-means++ seeding (two local trials per centre) on centred
        data, then Lloyd iterations until the labels are stable."""
        rs = (
            self.random_state
            if isinstance(self.random_state, np.random.RandomState)
            else np.random.RandomState(self.random_state)
        )
        xc = x - x.mean()
        sq = xc * xc
        n = xc.size
        centers = np.empty(self.n_components)
        first = rs.choice(n, p=np.full(n, 1.0 / n))
        centers[0] = xc[first]
        closest = np.maximum(sq + centers[0] ** 2 - 2 * xc * centers[0], 0)
        pot = closest.sum()
        for c in range(1, self.n_components):
            rand_vals = rs.uniform(size=2) * pot
            cand = np.searchsorted(np.cumsum(closest), rand_vals)
            cand = np.minimum(cand, n - 1)
            d = np.maximum(
                sq[None, :] + xc[cand, None] ** 2
                - 2 * xc[cand, None] * xc[None, :],
                0,
            )
            d = np.minimum(closest[None, :], d)
            best = int(np.argmin(d.sum(axis=1)))
            centers[c] = xc[cand[best]]
            closest = d[best]
            pot = closest.sum()
        labels = None
        for _ in range(300):
            new = np.argmin(
                centers[None, :] ** 2 - 2 * xc[:, None] * centers[None, :],
                axis=1,
            )
            if labels is not None and np.array_equal(new, labels):
                break
            labels = new
            for c in range(self.n_components):
                if np.any(labels == c):
                    centers[c] = xc[labels == c].mean()
        return labels

    def _m_step(self, x, resp):
        nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
        means = np.dot(resp.T, x) / nk
        cov = np.empty(self.n_components)
        for k in range(self.n_components):
            diff = x - means[k]
            cov[k] = np.dot(resp[:, k] * diff, diff) / nk[k] + self.reg_covar
        self._nk = nk
        self.means_ = means
        self.covariances_ = cov
        self._prec_chol = 1.0 / np.sqrt(cov)

    def _weighted_log_prob(self, x):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        y = (
            x[:, None] * self._prec_chol[None, :]
            - self.means_[None, :] * self._prec_chol[None, :]
        )
        log_prob = -0.5 * (np.log(2 * np.pi) + y * y)
        return log_prob + np.log(self._prec_chol) + np.log(self.weights_)

    def _e_step(self, x):
        wlp = self._weighted_log_prob(x)
        norm = logsumexp(wlp, axis=1)
        return float(np.mean(norm)), wlp - norm[:, None]


def y_fraction(sample: dict) -> float:
    """Fraction of reads on chrY (reference newref_tools.py:24-28)."""
    total = float(np.sum([np.sum(sample[k]) for k in sample.keys()]))
    return float(np.sum(sample["24"])) / total


def train_gender_model(
    samples: list[dict],
    yfrac_override: float | None = None,
    random_state: int | None = 0,
    max_iter: int = 10000,
    tol: float = 1e-12,
):
    """Fit the 2-component GMM and derive the M/F cutoff.

    Parameters mirror reference newref_tools.py:31-38 (full covariance,
    reg_covar=1e-99, max_iter=10000) with two deliberate deviations: the
    initializer is seeded by default for reproducible builds (pass
    ``random_state=None`` for reference-identical unseeded behavior) and the
    EM tolerance is 1e-12 instead of the reference's 1e-99 — the latter
    forces all 10000 iterations for no change in the fitted parameters
    beyond float64 noise (pass ``tol=1e-99`` to replicate exactly).

    Returns (genders list of "M"/"F"/None, cutoff float, fit dict for QC/plot).
    """
    y_fractions = np.array([y_fraction(s) for s in samples])

    gmm = _Gmm1d(
        reg_covar=1e-99,
        max_iter=max_iter,
        tol=tol,
        random_state=random_state,
    ).fit(y_fractions)
    gmm_y = np.exp(gmm.score_samples(GRID))

    if yfrac_override is not None:
        cutoff = float(yfrac_override)
    else:
        minima = _strict_local_minima(gmm_y)
        if len(minima) > 0:
            cutoff = float(GRID[minima[0]])
        else:
            # Documented fix over the reference: with extremely separated
            # clusters the mixture density underflows to exactly 0 between
            # the modes, leaving no *strict* local minimum — the reference
            # then crashes with IndexError (newref_tools.py:62).  Fall back
            # to the first interior point of the global-minimum plateau.
            interior = gmm_y[1:-1]
            i = int(np.argmin(interior)) + 1
            if i <= 1 or i >= len(gmm_y) - 2:
                raise RuntimeError(
                    "Could not determine a --yfrac cutoff: the Gaussian "
                    "mixture density is monotone on [0, 0.02]. Provide "
                    "--yfrac."
                )
            cutoff = float(GRID[i])
        logging.info("Determined --yfrac cutoff: %s", round(cutoff, 4))

    genders: list = [None] * len(samples)
    for i, yf in enumerate(y_fractions):
        if yf > cutoff:
            genders[i] = "M"
        elif yf < cutoff:
            genders[i] = "F"

    fit = {
        "y_fractions": y_fractions,
        "grid": GRID,
        "density": gmm_y,
        "means": gmm.means_.ravel(),
        "weights": gmm.weights_.ravel(),
    }
    return genders, cutoff, fit


def predict_gender(sample: dict, trained_cutoff: float) -> str:
    """'M' iff the chrY fraction exceeds the trained cutoff
    (reference predict_tools.py:17-24)."""
    return "M" if y_fraction(sample) > float(trained_cutoff) else "F"


def _strict_local_minima(y: np.ndarray) -> np.ndarray:
    """Indices i with y[i-1] > y[i] < y[i+1] (scipy argrelextrema(np.less))."""
    interior = (y[1:-1] < y[:-2]) & (y[1:-1] < y[2:])
    return np.nonzero(interior)[0] + 1
