"""Multi-chip KNN reference search.

Two strategies, both with zero cross-chip communication in the hot loop
(each chip owns disjoint target rows and scans a replicated candidate
matrix — SURVEY.md section 7 step 6, replacing the reference's thread
fan-out over contiguous bin ranges, newref_control.py:90-109):

* :func:`knn_search_multidevice` — explicit placement: the target-row
  range splits into contiguous per-device parts, and one host thread per
  device drives the full single-device search with that device as its
  default.  This is the production path used by ``newref``.
* :func:`knn_search_sharded` — GSPMD: the row axis is sharded over a
  ``Mesh`` and XLA partitions the jitted XLA kernel from the sharding
  annotations alone.  Used by the mesh-jit dry run.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from wisecondorx_tpu.ops.knn import _knn_kernel, _prep_candidates, knn_search


def knn_search_multidevice(
    data,
    chr_of_bin,
    masked_chr_starts,
    masked_bins_per_chr,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    devices=None,
    merge_method: str = "sort",
    **kw,
):
    """Row-partitioned KNN across all local devices.

    Results are identical to the single-device search: rows are
    independent, each part runs the same kernel, and parts are contiguous
    (tie order within a row is unaffected by the split).  Falls back to
    the single-device path when only one device exists or the row count
    is too small to split.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    n_rows = r1 - r0

    def run(dev, part_range, part_data):
        with jax.default_device(dev):
            return knn_search(
                part_data,
                chr_of_bin,
                masked_chr_starts,
                masked_bins_per_chr,
                ref_size=ref_size,
                row_range=part_range,
                merge_method=merge_method,
                **kw,
            )

    if len(devices) <= 1 or n_rows < 4 * len(devices):
        return run(devices[0], (r0, r1), data)

    # A committed device array would pin every part to its device; fan out
    # from host memory so each worker's jnp.asarray lands on its own device.
    host_data = np.asarray(data)
    bounds = np.linspace(r0, r1, len(devices) + 1).astype(int)
    # One host thread per device: jax dispatch is thread-safe and each
    # thread blocks on its own device's downloads, so devices run
    # concurrently (the reference's ThreadPoolExecutor fan-out, with chips
    # in place of cores).
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futs = [
            pool.submit(run, dev, (int(a), int(b)), host_data)
            for dev, a, b in zip(devices, bounds[:-1], bounds[1:])
        ]
        parts = [f.result() for f in futs]
    idx = np.concatenate([p[0] for p in parts])
    dist = np.concatenate([p[1] for p in parts])
    return idx, dist


def knn_search_sharded(
    data: np.ndarray,
    chr_of_bin: np.ndarray,
    masked_chr_starts: np.ndarray,
    masked_bins_per_chr: np.ndarray,
    mesh,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    col_tile: int = 2048,
    merge_method: str | None = None,
):
    """GSPMD-sharded variant of :func:`wisecondorx_tpu.ops.knn.knn_search`.

    Rows are padded to a multiple of the mesh size and split across the
    "bins" axis; results match the single-device kernel exactly (verified
    by the sharding-equivalence tests).

    This is the mesh-jit path used by the multichip dry run; production
    ``newref`` uses :func:`knn_search_multidevice`, which routes each
    row part through the full single-device search (with its f32
    centring).

    The merge defaults to "sort" (stable ``lax.top_k``) on EVERY
    backend, so the configuration the dry run certifies is the one any
    hardware would execute: bit-identical to the single-device path
    including engineered equal-distance ties at the k boundary.  The
    faster-compiling "partial" merge (exact value set, unspecified tie
    order) is opt-in via ``merge_method="partial"`` — never a silent
    hardware-dependent default.
    """
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    n_rows = r1 - r0
    n_dev = mesh.devices.size

    n_pad = -(-n // col_tile) * col_tile
    work, sentinel, unscale = _prep_candidates(jnp.asarray(data), n_pad=n_pad)
    data_p = np.asarray(work)
    col_chr = np.full(n_pad, -2, dtype=np.int32)
    col_chr[:n] = chr_of_bin

    # Pad target rows to a device multiple; padding rows use chr -2 (no
    # valid candidates; output rows are dropped below).
    rows_pad = -(-n_rows // n_dev) * n_dev
    rows = np.zeros((rows_pad, data_p.shape[1]), dtype=data_p.dtype)
    rows[:n_rows] = data_p[r0:r1]
    row_chr = np.full(rows_pad, -2, dtype=np.int32)
    row_chr[:n_rows] = col_chr[r0:r1]

    shard = NamedSharding(mesh, P("bins"))
    repl = NamedSharding(mesh, P())
    rows_d = jax.device_put(jnp.asarray(rows), shard)
    row_chr_d = jax.device_put(jnp.asarray(row_chr), shard)
    data_d = jax.device_put(jnp.asarray(data_p), repl)
    col_chr_d = jax.device_put(jnp.asarray(col_chr), repl)
    starts_d = jax.device_put(
        jnp.asarray(masked_chr_starts, dtype=jnp.int32), repl
    )
    sizes_d = jax.device_put(
        jnp.asarray(masked_bins_per_chr, dtype=jnp.int32), repl
    )

    idx, dist = _knn_kernel(
        rows_d,
        data_d,
        row_chr_d,
        col_chr_d,
        starts_d,
        sizes_d,
        jnp.int32(n),
        jax.device_put(sentinel, repl),
        ref_size=ref_size,
        col_tile=col_tile,
        merge_method=merge_method or "sort",
    )
    idx = np.asarray(idx)[:n_rows]
    dist = np.asarray(dist)[:n_rows]
    return idx, np.where(idx >= 0, dist * np.asarray(unscale), dist)
