"""Batched, data-parallel prediction.

The reference predicts one sample per process invocation; production NIPT
runs score plates of samples against one reference.  Here the predict hot
path (PCA projection + three-round z-masked normalization) is vmapped over
a sample batch and sharded over the mesh's "samples" axis — pure data
parallelism, no collectives.  Host-side pre/post-processing (coverage
normalization, combine, inflation, CBS input assembly) stays per-sample.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from wisecondorx_tpu.models.predictor import (
    BinResults,
    PredictConfig,
    assemble_results,
    prepare_sample,
)
from wisecondorx_tpu.ops import normalize as norm_ops
from wisecondorx_tpu.ops import pca as pca_ops

#: Samples per device per normalization dispatch.  Solo ``predict`` runs
#: its sample through the same block shape, so its outputs are
#: byte-identical to the sample's outputs on a plate.
DEFAULT_CHUNK = 8


@functools.partial(jax.jit, static_argnames=("ct", "rounds"))
def _batched_kernel(
    test_mat, components, mean, global_idx, ct: int, rounds: int = 3
):
    def one(tv):
        projected = pca_ops.project_sample(tv, components, mean)
        return norm_ops._normalize_repeat_kernel(
            projected, global_idx, ct=ct, rounds=rounds
        )

    return jax.vmap(one)(test_mat)


def _run_pass_batched(
    samples, ref_pass, gender, optimal_cutoff, mesh=None,
    chunk=DEFAULT_CHUNK, tables=None, a_pass=None,
):
    """Run one normalization pass for a batch of prepared samples.

    Returns per-sample tuples (z, r, weights, ref_sizes, m_lr, m_z).
    """
    from wisecondorx_tpu.models.ref_loader import build_pass_tables

    bins_per_chr = np.asarray(ref_pass["bins_per_chr"])
    mask = np.asarray(ref_pass["mask"], dtype=bool)
    if tables is None:
        tables = build_pass_tables(
            ref_pass, gender, optimal_cutoff, upload=(mesh is None),
            a_pass=a_pass,
        )
    ml = tables.ml
    ct = tables.ct
    weights = tables.weights

    test_mat = np.stack(
        [
            norm_ops.coverage_normalize_and_mask(s, bins_per_chr, mask)
            for s in samples
        ]
    )
    components = jnp.asarray(ref_pass["pca_components"])
    mean = jnp.asarray(ref_pass["pca_mean"])
    gi = tables.sentinel_idx
    if not isinstance(gi, jax.Array):
        gi = jnp.asarray(gi, dtype=jnp.int32)
    if mesh is not None:
        repl = NamedSharding(mesh, P())
        components = jax.device_put(components, repl)
        mean = jax.device_put(mean, repl)
        gi = jax.device_put(gi, repl)

    n_dev = mesh.devices.size if mesh is not None else 1
    # Every dispatch holds ``chunk`` samples per device (tail blocks are
    # padded; padded rows' outputs are discarded via n_real): device
    # reductions can round differently for another per-device shape, and
    # a sample's outputs must not depend on the plate, the device count
    # or the process count.
    chunk = chunk * n_dev

    out = []
    for s0 in range(0, len(samples), chunk):
        block = test_mat[s0 : s0 + chunk]
        pad = chunk - len(block)
        if pad:
            block = np.concatenate([block, block[-1:].repeat(pad, axis=0)])
        tm = jnp.asarray(block)
        if mesh is not None:
            tm = jax.device_put(tm, NamedSharding(mesh, P("samples")))
        z, r, sizes, m_lr, m_z = _batched_kernel(
            tm, components, mean, gi, ct=int(ct)
        )
        n_real = len(test_mat[s0 : s0 + chunk])
        for i in range(n_real):
            out.append(
                (
                    np.asarray(z[i]),
                    np.asarray(r[i]),
                    np.array(weights),
                    np.asarray(sizes[i], dtype=np.float64),
                    float(m_lr[i]),
                    float(m_z[i]),
                )
            )
    return out, ml


def predict_batch(
    samples_with_binsize,
    ref_passes,
    ref_meta,
    cfg: PredictConfig = PredictConfig(),
    mesh=None,
    chunk: int = DEFAULT_CHUNK,
    skip_errors: bool = False,
) -> list[BinResults]:
    """Predict a batch of samples data-parallel.

    Per-sample results are identical to :func:`predict_bins` (verified by
    the batch-equivalence tests).

    ``skip_errors``: a production plate should not lose 95 good samples
    to one corrupt npz (the reference scores one sample per process, so
    the failure domain question never arose there).  When set, samples
    that fail preparation are logged and returned as ``None`` entries
    (order preserved) instead of aborting the plate.
    """
    import logging

    cfg.validate()
    prepped = []
    ok_idx = []
    for i, (s, bs) in enumerate(samples_with_binsize):
        try:
            prepped.append(prepare_sample(s, bs, ref_passes, ref_meta, cfg))
            ok_idx.append(i)
        except Exception as e:
            if not skip_errors:
                raise
            logging.error("Skipping sample %d of the plate: %s", i + 1, e)
    if not prepped:
        return [None] * len(samples_with_binsize)

    a_pass = ref_passes["A"]
    cutoffs = np.atleast_1d(a_pass.get("wcx_cutoffs", []))
    if 1 <= cfg.maskrepeats <= len(cutoffs):
        cutoff = float(cutoffs[cfg.maskrepeats - 1])
    else:
        cutoff = norm_ops.get_optimal_cutoff(
            np.asarray(a_pass["distances"]), cfg.maskrepeats
        )

    a_out, _ = _run_pass_batched(
        [p[0] for p in prepped], a_pass, "A", cutoff, mesh, chunk,
        a_pass=a_pass,
    )

    results: list = [None] * len(samples_with_binsize)
    for gender in ("F", "M"):
        idxs = [i for i, p in enumerate(prepped) if p[2] == gender]
        if not idxs:
            continue
        g_pass = ref_passes[gender]
        g_out, g_ml = _run_pass_batched(
            [prepped[i][0] for i in idxs], g_pass, gender, cutoff, mesh,
            chunk, a_pass=a_pass,
        )
        for j, i in enumerate(idxs):
            z_g, r_g, w_g, sizes_g, _, _ = g_out[j]
            results[ok_idx[i]] = assemble_results(
                a_out[i],
                (z_g, r_g, w_g, sizes_g),
                g_ml,
                a_pass,
                g_pass,
                cfg,
                ref_gender=gender,
                gender=prepped[i][1],
                n_reads=prepped[i][3],
            )
    return results
