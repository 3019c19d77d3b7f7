"""Reference model construction (the ``newref`` stage).

Orchestrates the full build mirrored from reference main.py:40-137 and
newref_control.py, but as one in-memory pipeline over dense arrays instead
of a chain of temp files and threads:

1. rescale samples to the target bin size;
2. GMM sex model over chrY fractions;
3. gender correction (unless NIPT);
4. usability mask (+ per-sex sub-masks when >=5 samples of that sex);
5. per pass (A / F / M): depth-normalize over the pass's chromosome range,
   PCA residual, PCA-distance bin filter, KNN neighbour search, null ratios;
6. merge into the reference npz schema.

Parity quirk preserved (SURVEY.md 2.9): the PCA-distance filter mutates the
*shared* total mask through a slice view, so bins dropped by the A pass are
also absent from the later F/M passes — reference newref_control.py:52-54
relies on exactly this aliasing.

The reference's thread fan-out over contiguous bin ranges
(newref_control.py:90-109) is replaced by the tiled device kernel in
:mod:`wisecondorx_tpu.ops.knn`; ``row_tile`` bounds device memory and is
the natural sharding axis for multi-device builds.
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np

from wisecondorx_tpu.genome import (
    LAST_CHR,
    MaskedLayout,
    samples_to_matrix,
)
from wisecondorx_tpu.io.npz import gender_correct, scale_sample
from wisecondorx_tpu.ops import knn as knn_ops
from wisecondorx_tpu.ops import mask as mask_ops
from wisecondorx_tpu.ops import pca as pca_ops
from wisecondorx_tpu.ops.gmm import train_gender_model
from wisecondorx_tpu.utils.checkpoint import NewrefCheckpoint, fingerprint
from wisecondorx_tpu.utils.device import on_accelerator
from wisecondorx_tpu.utils.log import stage_timer


from wisecondorx_tpu.errors import UserInputError


class NewrefError(RuntimeError, UserInputError):
    """Raised when a reference cannot be built (e.g. too few samples)."""


@dataclasses.dataclass
class NewrefConfig:
    binsize: int = int(1e5)
    refsize: int = 300
    nipt: bool = False
    yfrac: float | None = None
    #: Seed for the null-ratio sample draw and GMM init; the reference is
    #: unseeded here (newref_tools.py:215) — we default to reproducible.
    seed: int | None = 0
    pca_components: int = 5
    #: Column-block width of the KNN kernel.
    col_tile: int = 8192
    #: Row-block height of the KNN kernel (bounds its device memory).  A
    #: pass's rows are padded to whole tiles of one shape, shared by every
    #: device of a row-split search.
    row_tile: int | None = 4096
    #: Host array dtype (the device path computes in float32; tests use
    #: float64 under jax_enable_x64 for reference parity).
    dtype: str = "float64"
    #: Keep the per-pass matrices device-resident (upload the cohort once,
    #: download only the final artifacts).  None = auto: on for an
    #: accelerator backend, off for the CPU/f64 parity path, whose numerics
    #: must match host numpy bit-for-bit.
    device: bool | None = None
    #: Directory for crash-recovery artifacts (None = off).  A killed build
    #: re-run with the same inputs + directory resumes after the last
    #: completed stage; see utils/checkpoint.py.
    checkpoint_dir: str | None = None
    #: KNN rows per checkpoint artifact when checkpointing is on.
    knn_checkpoint_rows: int = 32768


def build_reference(
    samples_with_binsize: list[tuple[dict, int]],
    config: NewrefConfig = NewrefConfig(),
    _null_chooser=None,
):
    """Build a normalization reference from negative-control samples.

    Parameters
    ----------
    samples_with_binsize : list of (sample dict, binsize) as loaded from
        convert npz files.
    _null_chooser : optional callable (gender, n_samples) -> sample id array
        overriding the seeded null-ratio sample draw (used by parity tests).

    Returns (passes dict for :func:`save_reference_npz`, meta dict).
    """
    cfg = config
    if _null_chooser is None:
        # Per-pass RNG derived from (seed, pass): the draw for pass X is
        # the same whether earlier passes computed or restored from a
        # checkpoint (a shared sequential stream would shift on resume).
        def _null_chooser(gender, n):
            g_rng = (
                np.random.default_rng()
                if cfg.seed is None
                else np.random.default_rng([cfg.seed, ord(gender)])
            )
            return knn_ops.choose_null_samples(n, g_rng)

    if cfg.yfrac is not None and not (0 <= cfg.yfrac <= 1):
        raise NewrefError(
            "Parameter --yfrac should be a positive number lower than or "
            "equal to 1"
        )

    with stage_timer("newref.scale"):
        samples = [
            scale_sample(s, bs, cfg.binsize) for s, bs in samples_with_binsize
        ]

    with stage_timer("newref.gender_model"):
        genders, trained_cutoff, _fit = train_gender_model(
            samples, yfrac_override=cfg.yfrac, random_state=cfg.seed
        )

    nipt = cfg.nipt
    if genders.count("F") < 5 and nipt:
        logging.warning(
            "A NIPT reference should have at least 5 female feti samples. "
            "Removing --nipt flag."
        )
        nipt = False
    if not nipt:
        samples = [
            gender_correct(s, g) for s, g in zip(samples, genders)
        ]

    if len(genders) <= 9:
        raise NewrefError(
            "Provide at least 10 samples to enable the generation of a "
            "reference."
        )

    with stage_timer("newref.mask"):
        matrix, layout = samples_to_matrix(samples)
        matrix = matrix.astype(cfg.dtype, copy=False)
        # All masks (total + per-gender sub-masks) in one chunked pass —
        # column subsets of a per-column depth normalization equal
        # normalizing the subsets, and row-blocking leaves every sum
        # bit-identical (mask_ops.get_masks).
        genders_arr = np.array(genders, dtype=object)
        subsets = [None]
        if genders.count("F") > 4:
            subsets.append(genders_arr == "F")
        if genders.count("M") > 4 and not nipt:
            subsets.append(genders_arr == "M")
        masks = mask_ops.get_masks(matrix, subsets)
        # np.array (not asarray): jax buffers are read-only and this mask is
        # mutated in place by the PCA-distance filter.
        total_mask = np.array(masks[0])
        for m in masks[1:]:
            total_mask &= np.asarray(m)

    passes = {}
    plan = [("A", np.ones(len(genders), dtype=bool))]
    if genders.count("F") > 4:
        plan.append(("F", genders_arr == "F"))
    else:
        logging.warning(
            "Provide at least 5 female samples to enable normalization of "
            "female gonosomes."
        )
    if not nipt:
        if genders.count("M") > 4:
            plan.append(("M", genders_arr == "M"))
        else:
            logging.warning(
                "Provide at least 5 male samples to enable normalization of "
                "male gonosomes."
            )

    ckpt = NewrefCheckpoint(
        cfg.checkpoint_dir,
        fingerprint(matrix, cfg) if cfg.checkpoint_dir else None,
    )

    # One cohort upload for the whole build: every pass consumes a
    # row-prefix + column subset of this device-resident matrix.
    on_device = cfg.device
    if on_device is None:
        on_device = on_accelerator()
    cohort_dev = None
    if on_device:
        with stage_timer("newref.cohort_upload"):
            cohort_dev = jnp.asarray(matrix.astype(np.float32, copy=False))
            cohort_dev.block_until_ready()

    # Predict-side cache computation (weights, cutoff schedule) is pure
    # host float64 math over each finished pass's distance table — it
    # overlaps the NEXT pass's device work on this thread pool.
    from concurrent.futures import ThreadPoolExecutor

    cache_pool = ThreadPoolExecutor(
        max_workers=2, thread_name_prefix="wcx-predict-cache"
    )
    cache_futs = {}

    # Pass pipelining: only the PREP phase (normalize -> PCA ->
    # PCA-distance filter) is serial across passes — the filter mutates
    # the shared mask the next pass reads.  The SEARCH phase (KNN +
    # null ratios + the big result fetch) only reads the pass's own
    # snapshot, so pass F's prep/search overlap pass A's fetch on worker
    # threads.  Disabled under multi-process builds (the cross-process
    # KNN all-gather must run in a fixed order) and under checkpointing
    # (row-chunked artifacts want deterministic sequencing).
    pipelined = jax.process_count() == 1 and not ckpt.enabled
    search_futs: dict = {}

    for gender, cols in plan:
        saved = ckpt.load(f"pass_{gender}")
        if saved is not None:
            logging.info("Pass %s restored from checkpoint", gender)
            # The PCA-distance filter mutated the shared mask during this
            # pass; replay that mutation for the later passes.
            total_mask[: len(saved["total_mask_after"])] &= saved[
                "total_mask_after"
            ]
            passes[gender] = {
                k: saved[k]
                for k in _PASS_KEYS + _OPTIONAL_PASS_KEYS
                if k in saved
            }
            passes[gender]["binsize"] = int(saved["binsize"])
        elif pipelined:
            with stage_timer(f"newref.pass_{gender}.prep"):
                run_search = _build_pass(
                    gender, matrix[:, cols], layout, total_mask, cfg,
                    _null_chooser, ckpt=ckpt, cohort_dev=cohort_dev,
                    cols=cols, defer_search=True,
                )
            # Daemon threads (not an executor): if a later prep or a
            # sibling search raises, the process must be able to exit
            # with its error instead of joining orphaned multi-minute
            # KNN searches at interpreter shutdown.
            search_futs[gender] = _DaemonFuture(
                run_search, name=f"wcx-search-{gender}"
            )
        else:
            with stage_timer(f"newref.pass_{gender}"):
                passes[gender] = _build_pass(
                    gender, matrix[:, cols], layout, total_mask, cfg,
                    _null_chooser, ckpt=ckpt, cohort_dev=cohort_dev,
                    cols=cols,
                )
            ckpt.save(
                f"pass_{gender}",
                total_mask_after=total_mask[: _truncated_len(layout, gender)],
                **passes[gender],
            )
        if gender in passes and "wcx_weights" not in passes[gender]:
            cache_futs[gender] = cache_pool.submit(
                _predict_cache, gender, passes[gender]["distances"]
            )

    for gender, fut in search_futs.items():
        with stage_timer(f"newref.pass_{gender}.search"):
            passes[gender] = fut.result()
        cache_futs[gender] = cache_pool.submit(
            _predict_cache, gender, passes[gender]["distances"]
        )

    with stage_timer("newref.predict_cache"):
        for gender, fut in cache_futs.items():
            passes[gender].update(fut.result())
        cache_pool.shutdown()

    # Bit-packed distance<cutoff masks at the default --maskrepeats 5:
    # needs the A pass's cutoff schedule, so it runs after every pass is
    # built (or restored).  See _predict_cache.
    cutoffs = passes.get("A", {}).get("wcx_cutoffs")
    if cutoffs is not None and len(cutoffs) >= 5:
        with stage_timer("newref.distok_cache"):
            c5 = float(cutoffs[4])
            for p in passes.values():
                if "wcx_distok" not in p:
                    ok = np.asarray(p["distances"], np.float64) < c5
                    p["wcx_distok"] = np.packbits(ok, axis=1)

    meta = {
        "is_nipt": nipt,
        "trained_cutoff": trained_cutoff,
        "has_female": "F" in passes,
        "has_male": "M" in passes,
    }
    ckpt.done()
    return passes, meta


#: Keys of a finished pass dict (checkpoint round-trip).
_PASS_KEYS = (
    "binsize", "mask", "bins_per_chr", "masked_bins_per_chr",
    "masked_bins_per_chr_cum", "pca_components", "pca_mean",
    "indexes", "distances", "null_ratios",
)

#: Predict-side caches (extra members the reference tool ignores).
_OPTIONAL_PASS_KEYS = ("wcx_weights", "wcx_cutoffs", "wcx_distok")


class _DaemonFuture:
    """Run ``fn`` on a daemon thread; ``result()`` re-raises its error.

    Unlike ThreadPoolExecutor (whose workers are non-daemon and joined
    at interpreter exit), an abandoned search dies with the process."""

    def __init__(self, fn, name):
        import threading

        self._done = threading.Event()
        self._out = None
        self._exc = None

        def run():
            try:
                self._out = fn()
            except BaseException as e:  # re-raised in result()
                self._exc = e
            finally:
                self._done.set()

        threading.Thread(target=run, name=name, daemon=True).start()

    def result(self):
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        return self._out


def _truncated_len(layout, gender):
    return layout.truncated(LAST_CHR[gender]).total_bins


def _build_pass(gender, matrix, layout, total_mask, cfg, null_chooser,
                ckpt=None, cohort_dev=None, cols=None, defer_search=False):
    """One reference pass (reference newref_control.py:24-80 + KNN stage).

    ``total_mask`` is mutated in place by the PCA-distance filter — the
    slice below aliases it exactly like the reference's mask view.

    ``cohort_dev``: the build's single device-resident [total_bins, S]
    float32 cohort; the pass's row-prefix/column subset is sliced on
    device instead of re-uploading.

    ``defer_search``: return after the prep phase (which holds the
    serial mask-mutation dependency between passes) with a zero-argument
    callable running the search phase — the pass-pipelining hook (the
    search only reads this pass's own snapshot).
    """
    if ckpt is None:
        ckpt = NewrefCheckpoint(None)
    last_chr = LAST_CHR[gender]
    tl = layout.truncated(last_chr)
    pass_mask = total_mask[: tl.total_bins]  # view — aliasing is intentional

    on_device = cfg.device
    if on_device is None:
        on_device = on_accelerator()

    prep = ckpt.load(f"prep_{gender}")
    if prep is not None:
        logging.info("Pass %s: PCA restored from checkpoint", gender)
        pass_mask &= prep["mask_after"]  # replay the filter's mutation
        corrected = prep["corrected"]
        components, mean = prep["components"], prep["mean"]
        if on_device:
            corrected = jnp.asarray(corrected)
    else:
        # Downstream matrices stay on device; the pass's view of the
        # cohort is a device slice/gather of the shared upload (or a
        # fresh upload when no shared cohort exists).
        sub_dev = None
        if on_device:
            with stage_timer(f"newref.pass_{gender}.subset"):
                if cohort_dev is not None:
                    sub_dev = _pass_subset_kernel(
                        cohort_dev[: tl.total_bins],
                        jnp.asarray(np.nonzero(cols)[0].astype(np.int32))
                        if cols is not None and not np.all(cols)
                        else None,
                    )
                    sub_dev.block_until_ready()
                else:
                    sub_dev = jnp.asarray(matrix[: tl.total_bins])

        with stage_timer(f"newref.pass_{gender}.pca"):
            corrected, components, mean = _normalize_and_pca(
                matrix, tl, pass_mask, cfg, sub_dev
            )

            # PCA-distance bin filter (reference-fork addition,
            # newref_control.py:38-58): drop bins far from the median
            # profile.
            if on_device:
                # Stats reduce on device; only the [n_masked] distance
                # vector and the decision are host-side.
                dist_to_med = np.asarray(_pca_distance_kernel(corrected))
            else:
                med_prof = np.median(corrected, axis=0)
                dist_to_med = np.sum((corrected - med_prof) ** 2, axis=1)
            mad = np.median(np.abs(dist_to_med - np.median(dist_to_med)))
            cutoff = max(np.median(dist_to_med) + 10 * mad, 5.0)
            bad_bins = dist_to_med > cutoff
            if np.any(bad_bins):
                logging.info(
                    "Removing %d anomalous bins based on PCA distance "
                    "(cutoff=%.4f)",
                    int(bad_bins.sum()),
                    cutoff,
                )
                masked_indices = np.where(pass_mask)[0]
                # mutates total_mask
                pass_mask[masked_indices[bad_bins]] = False
                corrected, components, mean = _normalize_and_pca(
                    matrix, tl, pass_mask, cfg, sub_dev
                )
        if ckpt.enabled:
            # Guarded: np.asarray(corrected) is a [bins, samples]
            # device->host fetch per pass, paid only when checkpointing.
            ckpt.save(
                f"prep_{gender}",
                corrected=np.asarray(corrected),
                components=components,
                mean=mean,
                mask_after=pass_mask,
            )

    ml = MaskedLayout(tl, pass_mask.copy())
    if defer_search:
        return lambda: _search_pass(
            gender, corrected, components, mean, ml, cfg, null_chooser,
            ckpt, on_device,
        )
    return _search_pass(
        gender, corrected, components, mean, ml, cfg, null_chooser, ckpt,
        on_device,
    )


def _search_pass(gender, corrected, components, mean, ml, cfg,
                 null_chooser, ckpt, on_device):
    """Search phase of one pass: KNN + null ratios + result assembly.

    Reads only this pass's own snapshot (``ml`` holds a mask COPY), so
    concurrent searches across passes are safe in a single process."""
    tl = ml.layout
    n_masked = ml.n_masked

    if gender == "A":
        row_range = None
    else:
        # Only gonosome target rows are searched; autosome rows get the
        # reference's 0-index/1.0-distance placeholders
        # (newref_tools.py:186-191).
        row_range = (int(ml.masked_chr_starts[22]), n_masked)

    indexes = np.zeros((n_masked, cfg.refsize), dtype=np.int32)
    distances = np.ones((n_masked, cfg.refsize), dtype=corrected.dtype)
    r0 = 0 if row_range is None else row_range[0]

    dev_out = None
    chosen = np.asarray(null_chooser(gender, corrected.shape[1]))
    # One row-tile shape per pass, fixed before any row split: a search
    # split over devices then runs the same compiled kernel as the
    # single-device search.
    row_tile = cfg.row_tile and min(
        cfg.row_tile, -(-(n_masked - r0) // 256) * 256
    )
    if len(jax.devices()) > 1 or jax.process_count() > 1:
        # Contiguous row parts across all chips (and, multi-host, across
        # processes with one final all-gather) — the functional
        # replacement for the reference's --cpus fan-out
        # (newref_control.py:90-109).
        from wisecondorx_tpu.parallel.multihost import (
            knn_search_multihost,
        )

        def search(rr):
            return knn_search_multihost(
                corrected,
                ml.chr_of_masked_bin,
                ml.masked_chr_starts,
                ml.masked_bins_per_chr,
                ref_size=cfg.refsize,
                row_range=rr,
                col_tile=cfg.col_tile,
                row_tile=row_tile,
            )
    else:
        # Device-resident index output feeds the null-ratio gather without
        # re-uploading the table.  Checkpointed builds search in row
        # chunks, so the single device table doesn't apply there.
        if on_device and not ckpt.enabled:
            dev_out = {}

        # The null-ratio chunks dispatch from inside the KNN search, after
        # the device index table is final and before the result download,
        # so their compute overlaps the index/distance fetch.
        pre_fetch_hook = None
        if dev_out is not None:
            def pre_fetch_hook(dv):
                return knn_ops.compute_null_ratios_device(
                    corrected, dv["indexes"], chosen,
                    placeholder_rows=r0, fetch=False,
                )

        def search(rr):
            return knn_ops.knn_search(
                corrected,
                ml.chr_of_masked_bin,
                ml.masked_chr_starts,
                ml.masked_bins_per_chr,
                ref_size=cfg.refsize,
                row_range=rr,
                col_tile=cfg.col_tile,
                row_tile=row_tile,
                device_out=dev_out,
                pre_fetch_hook=pre_fetch_hook,
            )

    if ckpt.enabled:
        # Row-chunked search with one artifact per chunk: a killed build
        # loses at most knn_checkpoint_rows rows of search (the analogue of
        # the reference's per-part npz files, newref_control.py:93-106).
        step = max(1024, cfg.knn_checkpoint_rows)
        for a in range(r0, n_masked, step):
            b = min(a + step, n_masked)
            part = ckpt.load(f"knn_{gender}_{a}_{b}")
            if part is None:
                idx, dist = search((a, b))
                ckpt.save(f"knn_{gender}_{a}_{b}", idx=idx, dist=dist)
            else:
                idx, dist = part["idx"], part["dist"]
            indexes[a:b] = idx
            distances[a:b] = dist
    else:
        with stage_timer(f"newref.pass_{gender}.knn"):
            idx, dist = search((r0, n_masked) if row_range else None)
            indexes[r0:] = idx
            distances[r0:] = dist

    with stage_timer(f"newref.pass_{gender}.nulls"):
        if dev_out is not None and "prefetched" in dev_out:
            # Null chunks were computed and downloaded inside the search's
            # fetch phase (pre_fetch_hook above) — just stitch the rows.
            null_ratios = knn_ops.assemble_null_ratio_rows(
                dev_out["prefetched"], n_masked
            )
        elif dev_out is not None and "indexes" in dev_out:
            null_ratios = knn_ops.compute_null_ratios_device(
                corrected, dev_out["indexes"], chosen, placeholder_rows=r0,
            )
        else:
            null_ratios = knn_ops.compute_null_ratios(
                corrected, indexes, chosen
            )

    return {
        "binsize": cfg.binsize,
        "mask": ml.mask,
        "bins_per_chr": np.asarray(tl.bins_per_chr),
        "masked_bins_per_chr": ml.masked_bins_per_chr,
        "masked_bins_per_chr_cum": ml.masked_bins_per_chr_cum,
        "pca_components": components,
        "pca_mean": mean,
        "indexes": indexes,
        "distances": distances,
        "null_ratios": null_ratios,
    }


def _predict_cache(gender: str, distances: np.ndarray) -> dict:
    """Precomputed predict-side derivations, stored as extra npz members
    (``wcx_*`` keys the reference tool ignores; SURVEY.md schema keys are
    untouched).  All are pure float64 functions of the stored distance
    table — byte-identical to what predict would recompute — and let the
    predict stage skip decompressing/scanning the table entirely:

    * ``wcx_weights``  — per-target-bin weights (predict_tools.py:152);
    * ``wcx_cutoffs``  — optimal-cutoff schedule for maskrepeats 1..10
      (A pass only; the gonosomal cutoff reuses it,
      predict_control.py:34);
    * ``wcx_distok``   — bit-packed ``distance < cutoff`` mask at the
      default ``--maskrepeats 5`` (bits beyond k pad each row).
    """
    from wisecondorx_tpu.ops import normalize as norm_ops

    out = {"wcx_weights": norm_ops.get_weights(distances)}
    if gender == "A":
        cutoffs = norm_ops.optimal_cutoff_schedule(distances)
        out["wcx_cutoffs"] = cutoffs
    return out


def _normalize_and_pca(matrix, tl, pass_mask, cfg, sub_dev=None):
    """Depth-normalize over the pass's chromosome range, mask, PCA-correct.

    Matches reference newref_tools.py:110-129 + 138-147: per-sample totals
    are taken over chromosomes 1..last_chr only (not the whole genome).

    With ``sub_dev`` (the device-resident [total_bins, S] counts slice) the
    normalization, masked gather, and PCA all run on device and the
    corrected matrix is returned as a device array — no [bins, samples]
    round-trips over the host link.
    """
    if sub_dev is not None:
        keep = jnp.asarray(np.nonzero(pass_mask)[0].astype(np.int32))
        masked = _normalize_gather_kernel(sub_dev, keep)
        return pca_ops.train_pca(
            masked, cfg.pca_components, return_device=True
        )
    sub = matrix[: tl.total_bins]
    normed = np.asarray(mask_ops.depth_normalize(sub))
    masked = normed[pass_mask]
    return pca_ops.train_pca(masked, cfg.pca_components)


@jax.jit
def _normalize_gather_kernel(sub_dev, keep):
    """Per-sample depth normalization + masked-row gather, fused on device."""
    totals = jnp.sum(sub_dev, axis=0)
    return jnp.take(sub_dev, keep, axis=0) / totals


def _pass_subset_kernel(rows_dev, cols_idx):
    """Column subset of the shared cohort (device gather; no-op when the
    pass uses every sample)."""
    if cols_idx is None:
        return rows_dev
    return _take_cols(rows_dev, cols_idx)


@jax.jit
def _take_cols(rows_dev, cols_idx):
    return jnp.take(rows_dev, cols_idx, axis=1)


@jax.jit
def _pca_distance_kernel(corrected):
    """Squared distance of every bin profile to the median profile."""
    med_prof = jnp.median(corrected, axis=0)
    return jnp.sum((corrected - med_prof) ** 2, axis=1)
