"""Within-sample reference search: per-bin K nearest neighbours.

This replaces the reference's O(bins^2 x samples) pure-Python bisect
insertion loop (newref_tools.py:255-278) — the documented scaling wall at
small bin sizes (reference README.md:10-11) — with a tiled XLA kernel that
runs unchanged on every backend:

* squared distances arrive as one matmul per (row-block, column-block):
  ``D = ||t||^2 + ||c||^2 - 2 t @ c^T``; the distances reported for the
  chosen neighbours are then recomputed as direct sums of squares;
* a running per-row top-k (smallest distance) is merged block-by-block with
  a stable ``lax.top_k``, which reproduces the reference's tie behavior
  exactly: the bisect insertion keeps equal-distance candidates ordered by
  scan position, and stable top-k over [running | new-block] does the same
  because every new block's excluded-space indexes are strictly larger than
  anything already held;
* candidates on the target's own chromosome are excluded with an +inf mask
  instead of the reference's per-chromosome array concatenation
  (newref_tools.py:192-199), but reported neighbour indexes remain in the
  reference's own-chromosome-excluded coordinate space so the npz artifacts
  stay interchangeable.

float32 inputs (the accelerator path) are centred and rescaled first:
depth-normalized bin profiles live at ~5e-6 with pairwise distances
~1e-12, where the norm-trick matmul cancels catastrophically in f32.
Distances are translation invariant, so the per-sample mean profile is
subtracted and the data divided by its global RMS, making working values
O(1); the selection threshold is scaled with it and reported distances are
un-scaled afterwards (tests/test_knn_f32.py measures the effect).  float64
inputs are searched as given.

Reference-parity details preserved: candidates with distance >= 1e10 are
never selected (the reference's ``cur_max`` starts at 1e10); unfilled slots
report index -1 / distance 1e10 (the reference's initial list contents).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from wisecondorx_tpu.ops.common import MATMUL_PRECISION

#: The reference's initial "infinite" distance (newref_tools.py:262,267).
SENTINEL_DISTANCE = 1e10


@functools.partial(
    jax.jit,
    static_argnames=("ref_size", "col_tile", "merge_method"),
)
def _knn_kernel(
    rows,  # [R, S] target-bin vectors
    data,  # [N_pad, S] all candidate vectors (zero-padded to col_tile)
    row_chr,  # int32[R] chromosome id per target row
    col_chr,  # int32[N_pad] chromosome id per candidate (-2 for padding)
    chr_starts,  # int32[n_chr] first masked index of each chromosome
    chr_sizes,  # int32[n_chr] masked bins per chromosome
    n_valid,  # scalar int32: true candidate count
    sentinel,  # scalar: candidates at or beyond this distance never count
    ref_size: int,
    col_tile: int,
    merge_method: str = "sort",
):
    dtype = rows.dtype
    R = rows.shape[0]
    n_blocks = data.shape[0] // col_tile

    row_norms = jnp.sum(rows * rows, axis=1)  # [R]
    col_norms = jnp.sum(data * data, axis=1)  # [N_pad]
    row_start = chr_starts[row_chr]  # [R]
    row_size = chr_sizes[row_chr]  # [R]

    data_blocks = data.reshape(n_blocks, col_tile, -1)
    norm_blocks = col_norms.reshape(n_blocks, col_tile)
    chr_blocks = col_chr.reshape(n_blocks, col_tile)

    init_vals = jnp.full((R, ref_size), jnp.inf, dtype=dtype)
    init_idx = jnp.full((R, ref_size), -1, dtype=jnp.int32)

    def body(carry, block):
        run_vals, run_idx = carry
        blk_data, blk_norms, blk_chr, blk_id = block
        g0 = blk_id * col_tile
        g = g0 + jax.lax.broadcasted_iota(jnp.int32, (1, col_tile), 1)  # [1,C]

        d = (
            row_norms[:, None]
            + blk_norms[None, :]
            - 2.0
            * jnp.dot(rows, blk_data.T, preferred_element_type=dtype,
                      precision=MATMUL_PRECISION)
        )
        same_chr = row_chr[:, None] == blk_chr[None, :]
        invalid = (
            same_chr
            | (g >= n_valid)
            | (d >= sentinel)
        )
        d = jnp.where(invalid, jnp.inf, d)

        # Excluded-space index of each candidate for each row.
        excl = g - jnp.where(g >= row_start[:, None], row_size[:, None], 0)
        excl = excl.astype(jnp.int32)

        merged_vals = jnp.concatenate([run_vals, d], axis=1)
        merged_idx = jnp.concatenate([run_idx, excl], axis=1)
        # Top-k of the smallest distances.  "sort" (lax.top_k) is stable:
        # exact bisect tie-order parity.  "partial" (approx_max_k at
        # recall_target=1.0) returns the exact value set with unspecified
        # tie order; tie order only matters for degenerate equal-distance
        # candidates at the k-boundary.
        if merge_method == "partial":
            neg_top, arg = jax.lax.approx_max_k(
                -merged_vals, ref_size, recall_target=1.0
            )
        else:
            neg_top, arg = jax.lax.top_k(-merged_vals, ref_size)
        new_idx = jnp.take_along_axis(merged_idx, arg, axis=1)
        return (-neg_top, new_idx), None

    (vals, idx), _ = jax.lax.scan(
        body,
        (init_vals, init_idx),
        (
            data_blocks,
            norm_blocks,
            chr_blocks,
            jnp.arange(n_blocks, dtype=jnp.int32),
        ),
    )

    # The matmul form ranks candidates, but its value carries an error of a
    # few ulps of the operand norms; the reported distances of the chosen
    # neighbours are recomputed as a direct sum of squares.
    unfilled = jnp.isinf(vals)
    indexes = jnp.where(unfilled, -1, idx)
    cand = idx + jnp.where(idx >= row_start[:, None], row_size[:, None], 0)
    cand = jnp.clip(cand, 0, data.shape[0] - 1)
    direct = jnp.sum((data[cand] - rows[:, None, :]) ** 2, axis=-1)
    distances = jnp.where(
        unfilled, jnp.asarray(SENTINEL_DISTANCE, dtype), direct
    )
    return indexes, distances


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _prep_candidates(data, *, n_pad: int):
    """Working candidate matrix, zero-padded to ``n_pad`` rows on device.

    Returns (work, sentinel, unscale): float32 data is centred and scaled
    to unit RMS, the 1e10 selection threshold scaled by the same factor
    (capped with headroom below f32 inf), and ``unscale`` maps working
    distances back to the data's own units.  Other dtypes pass through
    (unscale 1).
    """
    n = data.shape[0]
    if data.dtype == jnp.float32:
        work = data - jnp.mean(data, axis=0)
        rms = jnp.sqrt(jnp.mean(work * work))
        scale = jnp.where(jnp.isfinite(rms) & (rms > 0), 1.0 / rms, 1.0)
        work = work * scale
        sentinel = jnp.minimum(SENTINEL_DISTANCE * scale * scale, 1e30)
        unscale = 1.0 / (scale * scale)
    else:
        work = data
        sentinel = jnp.asarray(SENTINEL_DISTANCE, data.dtype)
        unscale = jnp.asarray(1.0, data.dtype)
    work = jnp.pad(work, ((0, n_pad - n), (0, 0)))
    return work, sentinel.astype(data.dtype), unscale.astype(data.dtype)


@functools.partial(jax.jit, static_argnames=("r0", "n_rows", "rows_pad"))
def _target_rows(work, col_chr, *, r0: int, n_rows: int, rows_pad: int):
    """Target rows [r0, r0+n_rows) of the working matrix, padded to
    ``rows_pad`` with chromosome -2 rows (no valid candidates)."""
    rows = jax.lax.slice_in_dim(work, r0, r0 + n_rows, axis=0)
    rows = jnp.pad(rows, ((0, rows_pad - n_rows), (0, 0)))
    rchr = jax.lax.slice_in_dim(col_chr, r0, r0 + n_rows, axis=0)
    rchr = jnp.pad(rchr, (0, rows_pad - n_rows), constant_values=-2)
    return rows, rchr


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _assemble(idx_parts, dist_parts, unscale, *, n_rows: int):
    """Concatenate per-tile results and un-scale filled distances."""
    idx = jnp.concatenate(idx_parts, axis=0)[:n_rows]
    dist = jnp.concatenate(dist_parts, axis=0)[:n_rows]
    dist = jnp.where(idx >= 0, dist * unscale, dist)
    return idx, dist


def knn_search(
    data,
    chr_of_bin: np.ndarray,
    masked_chr_starts: np.ndarray,
    masked_bins_per_chr: np.ndarray,
    ref_size: int = 300,
    row_range: tuple[int, int] | None = None,
    col_tile: int = 1024,
    row_tile: int | None = None,
    merge_method: str = "sort",
    device_out: dict | None = None,
    pre_fetch_hook=None,
):
    """Exact per-bin K nearest neighbours over other-chromosome bins.

    Parameters
    ----------
    data : [n_masked, n_samples] PCA-corrected bin vectors, numpy or
        device-resident.
    chr_of_bin : int[n_masked] chromosome id per masked bin.
    masked_chr_starts, masked_bins_per_chr : per-chromosome layout tables.
    row_range : optional (start, end) restricting which target rows are
        searched (used by the gonosomal passes and by sharding).
    row_tile : target rows per kernel call; the searched rows are padded
        to a whole number of tiles, so every call of one search (and of a
        row-split search using the same tile) runs one compiled shape.
        None = all rows in one call.
    merge_method : "sort" (stable, bisect tie-order parity) or "partial"
        (exact value set, unspecified tie order).
    device_out : optional dict that receives ``{"indexes": ...}``, the
        result index table as a device array, so the null-ratio stage
        gathers without re-uploading it.
    pre_fetch_hook : optional callable taking ``device_out`` and returning
        a list of device arrays; it runs before the results are fetched,
        and the fetched arrays come back as ``device_out["prefetched"]``.

    Returns (indexes int32[rows, ref_size], distances [rows, ref_size]) with
    indexes in own-chromosome-excluded space.
    """
    n = data.shape[0]
    r0, r1 = row_range if row_range is not None else (0, n)
    n_rows = r1 - r0
    if n_rows <= 0:
        return (
            np.zeros((0, ref_size), dtype=np.int32),
            np.zeros((0, ref_size), dtype=np.dtype(str(data.dtype))),
        )

    n_pad = -(-n // col_tile) * col_tile
    work, sentinel, unscale = _prep_candidates(jnp.asarray(data), n_pad=n_pad)
    col_chr = np.full(n_pad, -2, dtype=np.int32)
    col_chr[:n] = chr_of_bin
    col_chr_j = jnp.asarray(col_chr)
    starts = jnp.asarray(masked_chr_starts, dtype=jnp.int32)
    sizes = jnp.asarray(masked_bins_per_chr, dtype=jnp.int32)

    row_tile = row_tile or n_rows
    rows_pad = -(-n_rows // row_tile) * row_tile
    rows_j, rows_chr_j = _target_rows(
        work, col_chr_j, r0=r0, n_rows=n_rows, rows_pad=rows_pad
    )
    # Every row tile is dispatched before any result is fetched (dispatch
    # is asynchronous), so the device runs the tiles back to back.
    parts = [
        _knn_kernel(
            rows_j[s : s + row_tile],
            work,
            rows_chr_j[s : s + row_tile],
            col_chr_j,
            starts,
            sizes,
            jnp.int32(n),
            sentinel,
            ref_size=ref_size,
            col_tile=col_tile,
            merge_method=merge_method,
        )
        for s in range(0, rows_pad, row_tile)
    ]
    idx_j, dist_j = _assemble(
        [i for i, _ in parts], [d for _, d in parts], unscale, n_rows=n_rows
    )
    prefetched = []
    if device_out is not None:
        device_out["indexes"] = idx_j
        if pre_fetch_hook is not None:
            prefetched = list(pre_fetch_hook(device_out))
    indexes = np.asarray(idx_j)
    distances = np.asarray(dist_j)
    if device_out is not None and pre_fetch_hook is not None:
        device_out["prefetched"] = [np.asarray(p) for p in prefetched]
    return indexes, distances


@functools.partial(jax.jit, static_argnames=())
def _null_ratio_kernel(sub, idx_block, own_block):
    gathered = sub[idx_block]  # [c, k, chosen]
    medians = jnp.median(gathered, axis=1)
    return jnp.log2(own_block / medians)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _null_ratio_chunk_dev(sub_pad, idx_pad, offset, n, *, chunk: int):
    """One row chunk of the all-device null table.

    ``offset`` and ``n`` are traced scalars, so every chunk of a pass —
    and the same pass before/after the PCA-distance filter — shares one
    compiled program.  ``idx % n`` reproduces the reference's numpy -1
    wraparound (SURVEY.md 2.12).
    """
    idx = jax.lax.dynamic_slice_in_dim(idx_pad, offset, chunk, axis=0) % n
    own = jax.lax.dynamic_slice_in_dim(sub_pad, offset, chunk, axis=0)
    gathered = sub_pad[idx]  # [chunk, k, chosen]
    medians = jnp.median(gathered, axis=1)
    return jnp.log2(own / medians)


def _null_ratio_chunk(k: int, chosen: int) -> int:
    """Row-chunk height of the device null-ratio program (bounds the
    [chunk, k, chosen] gather to ~256 MB)."""
    chunk = max(256, int(2**28 // (k * max(chosen, 1) * 4)))
    return -(-chunk // 256) * 256


def compute_null_ratios_device(
    data_dev,
    indexes_dev,
    sample_ids: np.ndarray,
    placeholder_rows: int = 0,
    fetch: bool = True,
):
    """Null log2 ratios with data AND indexes resident on device.

    The host-array path (:func:`compute_null_ratios`) uploads the [rows, k]
    index table; here the table is the device output of
    :func:`knn_search` (``device_out``) and only the [rows, chosen] result
    is downloaded.

    ``placeholder_rows`` prepends that many zero-index rows (the gonosomal
    passes' autosome placeholders, reference newref_tools.py:186-191).
    With ``fetch=False`` the chunk results are returned as a list of
    device arrays (for :func:`assemble_null_ratio_rows` after a fetch).
    """
    n = int(data_dev.shape[0])
    ids = jnp.asarray(np.asarray(sample_ids, dtype=np.int32))
    chosen = int(ids.shape[0])
    k = int(indexes_dev.shape[1])
    sub = jnp.take(data_dev, ids, axis=1)  # [n, chosen]
    if placeholder_rows:
        indexes_dev = jnp.concatenate(
            [jnp.zeros((placeholder_rows, k), jnp.int32), indexes_dev]
        )
    n_rows = int(indexes_dev.shape[0])

    chunk = _null_ratio_chunk(k, chosen)
    rows_pad = -(-n_rows // chunk) * chunk
    idx_pad = jnp.pad(indexes_dev, ((0, rows_pad - n_rows), (0, 0)))
    # Pad rows carry 1.0 so the (discarded) tail never divides by zero.
    sub_pad = jnp.pad(
        sub, ((0, rows_pad - n), (0, 0)), constant_values=1.0
    )

    n_j = jnp.int32(n)
    pending = [
        _null_ratio_chunk_dev(
            sub_pad, idx_pad, jnp.int32(s), n_j, chunk=chunk
        )
        for s in range(0, rows_pad, chunk)
    ]
    if not fetch:
        return pending
    return assemble_null_ratio_rows(pending, n_rows)


def assemble_null_ratio_rows(parts: list, n_rows: int) -> np.ndarray:
    """Stitch null-ratio chunk arrays (from
    :func:`compute_null_ratios_device` with ``fetch=False``) into the final
    [n_rows, chosen] host table, dropping the padding tail."""
    parts = [np.asarray(p) for p in parts]
    chunk = parts[0].shape[0]
    out = np.empty((n_rows, parts[0].shape[1]), dtype=parts[0].dtype)
    for i, part in enumerate(parts):
        s = i * chunk
        if s >= n_rows:
            break
        e = min(s + chunk, n_rows)
        out[s:e] = part[: e - s]
    return out


def compute_null_ratios(
    data: np.ndarray,
    indexes: np.ndarray,
    sample_ids: np.ndarray,
    backend: str = "auto",
) -> np.ndarray:
    """Null log2 ratios for the chosen reference samples.

    Reference newref_tools.py:210-224: for each chosen sample s and each bin
    b, ``r = log2(data[b, s] / median(data[indexes[b], s]))``.

    Parity quirk reproduced deliberately (SURVEY.md 2.12): ``indexes`` are in
    own-chromosome-excluded space but are applied directly to the full
    masked-space sample vector, including the reference's numpy behavior of
    index -1 wrapping to the last bin.

    ``data`` may be numpy or device-resident (jnp); a device array forces
    the jax backend and skips the cohort re-upload.
    """
    if isinstance(data, jnp.ndarray) and backend != "numpy":
        backend = "jax"
        sub_dev = jnp.take(
            data, jnp.asarray(np.asarray(sample_ids, dtype=np.int32)), axis=1
        )
        data = None
    else:
        sub_dev = None
        data = np.asarray(data)
    indexes = np.asarray(indexes)
    if sub_dev is not None:
        n = sub_dev.shape[0]
        sub = None
    else:
        n = data.shape[0]
        sub = data[:, sample_ids]  # [bins, chosen]
    n_rows, k = indexes.shape
    chosen = len(sample_ids)
    out_dtype = sub.dtype if sub is not None else np.dtype(str(sub_dev.dtype))
    out = np.empty((n_rows, chosen), dtype=out_dtype)

    total_gathered = n_rows * k * max(chosen, 1)
    use_jax = backend == "jax" or (backend == "auto" and total_gathered > 5e7)

    if use_jax:
        # Device path: gather + median over the neighbour axis in chunks.
        sub_j = sub_dev if sub_dev is not None else jnp.asarray(sub)
        chunk = max(256, int(2**28 // (k * max(chosen, 1) * 4)))
        chunk = -(-chunk // 256) * 256
        pending = []
        for s in range(0, n_rows, chunk):
            e = min(s + chunk, n_rows)
            idx = (indexes[s:e] % n).astype(np.int32)
            # Own values sliced on device; shapes padded so every chunk
            # shares one compiled program (pad rows use 1.0 — discarded).
            own = jax.lax.slice(sub_j, (s, 0), (e, chosen))
            if e - s < chunk:
                pad = chunk - (e - s)
                idx = np.concatenate([idx, np.zeros((pad, k), np.int32)])
                own = jnp.pad(
                    own, ((0, pad), (0, 0)), constant_values=1.0
                )
            res = _null_ratio_kernel(
                sub_j, jnp.asarray(idx), own.astype(sub_j.dtype)
            )
            pending.append((s, e, res))
        for s, e, res in pending:
            out[s:e] = np.asarray(res)[: e - s]
        return out

    chunk = max(1, 2**28 // (k * max(chosen, 1) * 8))
    for s in range(0, n_rows, chunk):
        e = min(s + chunk, n_rows)
        # numpy negative-index wraparound for the -1 sentinel slots.
        gathered = sub[indexes[s:e] % n]  # [c, k, chosen]
        medians = np.median(gathered, axis=1)  # [c, chosen]
        with np.errstate(divide="ignore", invalid="ignore"):
            out[s:e] = np.log2(sub[s:e] / medians)
    return out


def choose_null_samples(n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Pick min(n_samples, 100) sample columns for the null-ratio table.

    The reference draws them with unseeded ``random.sample``
    (newref_tools.py:214-218) making builds non-reproducible; we take a
    seeded Generator.  Column order is irrelevant downstream (segment
    z-scores aggregate over the chosen-sample axis symmetrically).
    """
    return rng.choice(n_samples, size=min(n_samples, 100), replace=False)
