"""Device-mesh helpers.

The reference's only parallelism is a thread pool over contiguous bin
ranges (reference newref_control.py:90-109, SURVEY.md 2.13).  On devices the
same two embarrassingly-parallel axes exist as sharding axes over a 1-D
``jax.sharding.Mesh``:

* the **bin axis** for the reference-build KNN search (each device owns a
  disjoint block of target rows; candidate data is replicated — at 15 kb
  resolution the bins x samples matrix is ~400 MB in f32, far below device
  memory);
* the **sample axis** for batched prediction (pure data parallelism).

Both need zero cross-device communication in the hot loop, so XLA's GSPMD
partitioner handles them from sharding annotations alone — no hand-written
collectives required.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def bin_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices; axis "bins" shards KNN target rows."""
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.array(devices), axis_names=("bins",))


def sample_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices; axis "samples" shards predict batches."""
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.array(devices), axis_names=("samples",))


def shard_rows(mesh: Mesh, axis: str) -> NamedSharding:
    """Sharding that splits an array's leading axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
