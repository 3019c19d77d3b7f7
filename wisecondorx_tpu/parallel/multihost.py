"""Multi-host orchestration (SURVEY.md section 7 step 6).

The reference is a single-process tool; its two embarrassingly parallel
axes map onto a multi-host deployment as:

* **sample axis over DCN** — ``convert`` and ``predict-batch`` shard the
  input *files* across hosts (each host reads its own BAM/CRAMs and
  scores its own plate shard; no cross-host traffic at all);
* **bin axis over hosts** — the ``newref`` KNN row fan-out extends from
  "one thread per local chip" to "one contiguous row range per global
  chip": every process searches the ranges owned by its local chips and
  the per-row results are exchanged once at the end with a host-side
  all-gather (the candidate matrix is replicated per chip, so the hot
  loop still has zero cross-chip communication).

Initialization is driven by the standard jax.distributed environment
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
or explicit arguments.  With a single process everything below
degenerates to the local behavior — which is what the tests pin down;
real multi-host runs need actual pods.
"""

from __future__ import annotations

import logging
import os

import numpy as np

import jax


def maybe_initialize_distributed() -> tuple[int, int]:
    """Initialize jax.distributed when a coordinator is configured.

    Returns (process_index, process_count); (0, 1) when single-process.
    """
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        # NOTE: jax.distributed.initialize must run before ANY backend
        # touch — even jax.process_count() initializes XLA, so no guard
        # query can precede this call.  Checking the distributed client
        # state is safe (module state only, no backend init); anything
        # else that goes wrong — including XlaRuntimeError, which
        # subclasses RuntimeError (e.g. coordinator DEADLINE_EXCEEDED) —
        # must surface as a WARNING, because the job then silently
        # degrades to independent single-process runs.
        already = False
        try:
            from jax._src import distributed as _dist

            already = getattr(_dist.global_state, "client", None) is not None
        except Exception:
            pass
        if already:
            logging.debug("jax.distributed already initialized")
        else:
            try:
                jax.distributed.initialize(
                    coordinator_address=coord,
                    num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                    process_id=int(os.environ["JAX_PROCESS_ID"]),
                )
                logging.info(
                    "jax.distributed initialized: process %d of %d",
                    jax.process_index(),
                    jax.process_count(),
                )
            except Exception as e:
                logging.warning(
                    "jax.distributed initialization failed (falling back "
                    "to single-process: every host computes all rows): %s",
                    e,
                )
    return jax.process_index(), jax.process_count()


def shard_files(paths: list, process_index: int, process_count: int) -> list:
    """Contiguous per-host shard of an input file list (convert /
    predict-batch: each host owns its shard end-to-end)."""
    if process_count <= 1:
        return list(paths)
    bounds = np.linspace(0, len(paths), process_count + 1).astype(int)
    return list(paths[bounds[process_index] : bounds[process_index + 1]])


def knn_search_multihost(
    data,
    chr_of_bin,
    masked_chr_starts,
    masked_bins_per_chr,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    **kw,
):
    """Global-row-fan-out KNN: every process searches the contiguous row
    ranges owned by its local devices; one all-gather merges the parts.

    Single-process: identical to
    :func:`wisecondorx_tpu.parallel.sharded_knn.knn_search_multidevice`.
    """
    from wisecondorx_tpu.parallel.sharded_knn import knn_search_multidevice

    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    n_proc = jax.process_count()
    if n_proc <= 1:
        return knn_search_multidevice(
            data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
            ref_size=ref_size, row_range=row_range, **kw,
        )

    # Rows split once over processes (DCN boundary), then per local chip.
    pidx = jax.process_index()
    bounds = np.linspace(r0, r1, n_proc + 1).astype(int)
    my_range = (int(bounds[pidx]), int(bounds[pidx + 1]))
    idx, dist = knn_search_multidevice(
        data, chr_of_bin, masked_chr_starts, masked_bins_per_chr,
        ref_size=ref_size, row_range=my_range,
        devices=jax.local_devices(), **kw,
    )
    # Pad to the largest shard so process_allgather sees one shape.
    widest = int(np.max(np.diff(bounds)))
    pad = widest - idx.shape[0]
    if pad:
        idx = np.concatenate(
            [idx, np.full((pad, ref_size), -1, np.int32)]
        )
        dist = np.concatenate(
            [dist, np.zeros((pad, ref_size), dist.dtype)]
        )
    from jax.experimental import multihost_utils

    all_idx = np.asarray(multihost_utils.process_allgather(idx))
    all_dist = np.asarray(multihost_utils.process_allgather(dist))
    parts_i, parts_d = [], []
    for p in range(n_proc):
        size = int(bounds[p + 1] - bounds[p])
        parts_i.append(all_idx[p, :size])
        parts_d.append(all_dist[p, :size])
    return np.concatenate(parts_i), np.concatenate(parts_d)
