"""Crash recovery for the reference build.

The reference's staged temp files (``_prep.npz``, ``_part_<n>.npz``,
``.tmp.{A,F,M}.npz`` — reference newref_control.py:56-58,93-106,159-174)
double as resumable checkpoints: a crashed ``newref`` can be re-run and
picks up after the last completed stage.  This module provides the same
property for the in-memory device pipeline:

* per pass: the post-PCA state (corrected matrix, components, mean, and
  the total-mask snapshot — the PCA-distance filter mutates the shared
  mask, so resume must restore it);
* within the KNN stage: per-row-chunk neighbour results, so even the
  multi-hour-scale searches lose at most one chunk;
* per pass: the finished pass dict.

Artifacts carry a fingerprint of the inputs + config; resuming against
different inputs refuses rather than silently mixing cohorts.  On
success the checkpoint directory is removed, mirroring the reference's
cleanup (newref_control.py:106-109,234).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil

import numpy as np


def fingerprint(matrix: np.ndarray, cfg) -> str:
    """Cheap content hash of the cohort + the config fields that change
    numerics.  Samples a bounded number of matrix bytes so 15 kb cohorts
    hash in milliseconds."""
    h = hashlib.sha256()
    m = np.ascontiguousarray(matrix)
    h.update(str(m.shape).encode())
    h.update(str(m.dtype).encode())
    step = max(1, m.shape[0] // 64)
    h.update(m[::step].tobytes())
    for field in ("binsize", "refsize", "nipt", "yfrac", "seed",
                  "pca_components"):
        h.update(f"{field}={getattr(cfg, field)};".encode())
    return h.hexdigest()[:16]


class NewrefCheckpoint:
    """Directory-backed stage store; a None directory disables everything."""

    def __init__(self, directory: str | None, fp: str | None = None):
        self.dir = directory
        self.fp = fp
        if not directory:
            return
        os.makedirs(directory, exist_ok=True)
        fp_file = os.path.join(directory, "fingerprint")
        if os.path.exists(fp_file):
            existing = open(fp_file).read().strip()
            if fp is not None and existing != fp:
                raise RuntimeError(
                    f"Checkpoint directory {directory} belongs to a "
                    "different cohort/config (fingerprint "
                    f"{existing} != {fp}); remove it or point "
                    "--checkpoint-dir elsewhere"
                )
            logging.info("Resuming newref from checkpoint %s", directory)
        elif fp is not None:
            with open(fp_file, "w") as f:
                f.write(fp)

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".npz")

    def save(self, name: str, **arrays) -> None:
        if not self.enabled:
            return
        # np.savez appends ".npz" when missing — keep the suffix explicit.
        tmp = self._path(name) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(name))  # atomic: no torn artifacts

    def exists(self, name: str) -> bool:
        """Cheap presence check (no array parsing) — used to skip compile
        warm-ups for stages that will restore instead of compute."""
        return self.enabled and os.path.exists(self._path(name))

    def load(self, name: str):
        if not self.enabled or not os.path.exists(self._path(name)):
            return None
        try:
            with np.load(self._path(name), allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:  # torn/corrupt artifact -> recompute
            logging.warning(
                "Ignoring unreadable checkpoint %s (%s)", name, e
            )
            return None

    def done(self) -> None:
        """Remove the checkpoint directory after a successful build."""
        if self.enabled and os.path.isdir(self.dir):
            shutil.rmtree(self.dir, ignore_errors=True)
