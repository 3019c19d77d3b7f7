"""Streaming reference-table loader for the predict stage.

The reference tool mmap-loads its npz and touches tables lazily
(reference predict_control.py:21-39 reads them via dict access).  At 15 kb
bins one pass's ``indexes``/``distances`` tables are ~1 GB decompressed,
so predict latency is set by how these bytes are scheduled, not by
compute.

This loader overlaps, per pass:

* npz member decompression (zlib releases the GIL -> real thread overlap);
* the host float64 optimal-cutoff / per-bin-weight math
  (ops/normalize.get_optimal_cutoff / get_weights);
* index-space translation + cutoff folding
  (MaskedLayout.neighbour_to_global -> sentinel_indexes); and
* the single bulk device upload per pass: one int32 [target_rows, k]
  sentinel index table.  The gonosomal pass only ships its chrX/chrY
  target rows (~5% of the table).

``null_ratios`` stay on host (segment z-scores are host math) and
decompress in the background so they are ready by CBS time.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wisecondorx_tpu.genome import GenomeLayout, MaskedLayout
from wisecondorx_tpu.io.npz import load_reference_small
from wisecondorx_tpu.ops import normalize as norm_ops


class PassTables:
    """Per-pass prediction tables, ready for the normalization kernel.

    ``sentinel_idx`` is the device-resident int32 [target_rows, k]
    neighbour table with the distance cutoff folded in as -1 sentinels;
    ``weights`` are the host float64 per-target-bin weights; ``ml`` the
    pass's masked layout; ``ct`` the first target row.
    """

    __slots__ = ("sentinel_idx", "weights", "ml", "ct")

    def __init__(self, sentinel_idx, weights, ml, ct):
        self.sentinel_idx = sentinel_idx
        self.weights = weights
        self.ml = ml
        self.ct = ct


def translate_and_mask(idx, dist, ml: MaskedLayout, ct: int, cutoff: float):
    """Fused neighbour-index translation + cutoff fold for target rows
    [ct:]: ``MaskedLayout.neighbour_to_global`` then
    ``ops.normalize.sentinel_indexes`` in one multi-threaded native pass
    (integer math + one float compare — bit-identical to the numpy
    fallback, which serves when the native library is unavailable)."""
    rows, k = idx.shape
    chr_rows = ml.chr_of_masked_bin[ct : ct + rows]
    starts = np.ascontiguousarray(ml.masked_chr_starts[chr_rows])
    sizes = np.ascontiguousarray(ml.masked_bins_per_chr[chr_rows])
    try:
        import ctypes

        from wisecondorx_tpu.io.bam import _load_library

        lib = _load_library()
        fn = lib.wcx_sentinel_translate
    except Exception:
        fn = None
    idx = np.ascontiguousarray(idx)
    dist = np.ascontiguousarray(dist)
    if (
        fn is not None
        and idx.dtype in (np.int32, np.int64)
        and dist.dtype in (np.float32, np.float64)
    ):
        out = np.empty((rows, k), dtype=np.int32)
        fn.restype = ctypes.c_int
        rc = fn(
            idx.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(idx.dtype.itemsize),
            dist.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(dist.dtype.itemsize),
            ctypes.c_int64(rows),
            ctypes.c_int64(k),
            starts.astype(np.int64).ctypes.data_as(ctypes.c_void_p),
            sizes.astype(np.int64).ctypes.data_as(ctypes.c_void_p),
            ctypes.c_double(cutoff),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == 0:
            return out
    gi = ml.neighbour_to_global(idx, row_start=ct)
    return norm_ops.sentinel_indexes(gi, dist, cutoff)


def translate_with_okbits(idx, ok_packed, ml: MaskedLayout, ct: int):
    """Like :func:`translate_and_mask` but consuming the bit-packed
    ``wcx_distok`` cache directly (big-endian numpy packbits layout) —
    the cached path never materializes a distance or boolean table."""
    rows, k = idx.shape
    chr_rows = ml.chr_of_masked_bin[ct : ct + rows]
    starts = np.ascontiguousarray(
        ml.masked_chr_starts[chr_rows].astype(np.int64)
    )
    sizes = np.ascontiguousarray(
        ml.masked_bins_per_chr[chr_rows].astype(np.int64)
    )
    idx = np.ascontiguousarray(idx)
    ok_packed = np.ascontiguousarray(ok_packed)
    try:
        import ctypes

        from wisecondorx_tpu.io.bam import _load_library

        lib = _load_library()
        fn = lib.wcx_sentinel_translate_ok
    except Exception:
        fn = None
    if fn is not None and idx.dtype in (np.int32, np.int64):
        out = np.empty((rows, k), dtype=np.int32)
        fn.restype = ctypes.c_int
        rc = fn(
            idx.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(idx.dtype.itemsize),
            ok_packed.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(ok_packed.shape[1]),
            ctypes.c_int64(rows),
            ctypes.c_int64(k),
            starts.ctypes.data_as(ctypes.c_void_p),
            sizes.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == 0:
            return out
    ok = np.unpackbits(ok_packed, axis=1, count=k).astype(bool)
    gi = ml.neighbour_to_global(idx, row_start=ct)
    return np.where(ok, gi, -1).astype(np.int32)


def _pack_sentinel(sent: np.ndarray):
    """3-byte packed form of an int32 sentinel table, or ``None`` when a
    value falls outside the 24-bit range (never true of real
    references — the masked-bin count bounds every index < 2^24).

    Encoding contract (value+1, little-endian low 3 bytes, -1 -> 0) is
    shared with the device-side decoder :func:`_decode_sentinel`."""
    if (
        sent.size == 0
        or int(sent.min()) < -1
        or int(sent.max()) + 1 >= (1 << 24)
    ):
        return None
    rows, k = sent.shape
    v = (sent + 1).astype("<i4", copy=False)
    return np.ascontiguousarray(
        v.view(np.uint8).reshape(rows, k, 4)[:, :, :3]
    )


def upload_sentinel(sent: np.ndarray):
    """Device-resident int32 sentinel table via a 3-byte packed h2d
    transfer.

    Index values are bounded by the masked-bin count (< 2^24 even at
    1 kb bins), so ``value + 1`` fits 24 bits (sentinel -1 becomes 0):
    shipping 3 of each little-endian int32's 4 bytes cuts the predict
    path's dominant upload by 25% losslessly; a trivial fused
    device op rebuilds the int32 table, so every downstream consumer is
    unchanged.  Falls back to the direct upload for out-of-range values
    (never produced by real references)."""
    import jax

    packed = _pack_sentinel(sent)
    if packed is None:
        dev = jax.device_put(sent.astype(np.int32, copy=False))
        dev.block_until_ready()
        return dev
    dev = _decode_sentinel(jax.device_put(packed))
    dev.block_until_ready()
    return dev


#: Cached jitted decoder — jax.jit's compile cache hangs off the wrapper
#: OBJECT, so a fresh closure per call would retrace and recompile every
#: upload.
_DECODE_JIT = None


def _decode_sentinel(p):
    global _DECODE_JIT
    if _DECODE_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def decode(p):
            v = (
                p[..., 0].astype(jnp.int32)
                | (p[..., 1].astype(jnp.int32) << 8)
                | (p[..., 2].astype(jnp.int32) << 16)
            )
            return v - 1

        _DECODE_JIT = decode
    return _DECODE_JIT(p)


def _upload_chunk_rows(k: int) -> int:
    """Row count per 64 MB chunk of the streamed sentinel upload."""
    return max(1, (64 << 20) // max(k * 4, 1))


def _assemble_packed(parts):
    """Concat packed chunk parts on device and decode to the int32
    table (the tail of the streamed upload)."""
    import jax.numpy as jnp

    dev = _decode_sentinel(
        parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    )
    dev.block_until_ready()
    return dev


def pass_ct(ref_pass_small: dict, gender: str) -> int:
    """First target row of a pass: 0 for "A", the pre-chrX masked bin
    count for gonosomal passes (reference predict_control.py:22-29)."""
    if gender == "A":
        return 0
    return int(np.asarray(ref_pass_small["masked_bins_per_chr_cum"])[21])


def build_pass_tables(
    ref_pass: dict, gender: str, cutoff: float, upload: bool = True,
    a_pass: dict | None = None,
) -> PassTables:
    """Synchronous PassTables construction from an in-memory pass dict
    (the test / batch path; numerically identical to the loader).

    When ``a_pass`` (the autosomal pass, source of the cutoff quirk) is
    given and ``cutoff`` equals its cached maskrepeats-5 value, the
    ``wcx_*`` caches serve weights and the cutoff mask — skipping the
    distance-table scan exactly like the streamed loader.  The weights
    cache is cutoff-INDEPENDENT (1/mean(sqrt(d)) never sees the
    cutoff), so it serves at every maskrepeats depth; only the
    bit-packed ``wcx_distok`` mask is pinned to the depth it was built
    at (the default 5)."""
    import jax

    ct = pass_ct(ref_pass, gender)
    ml = MaskedLayout(
        GenomeLayout(np.asarray(ref_pass["bins_per_chr"])),
        np.asarray(ref_pass["mask"], dtype=bool),
    )
    idx = np.asarray(ref_pass["indexes"])[ct:]
    cutoffs = np.atleast_1d(
        a_pass.get("wcx_cutoffs", [])
    ) if a_pass is not None else np.array([])
    ok_cached = (
        len(cutoffs) >= 5
        and cutoff == float(cutoffs[4])
        and "wcx_distok" in ref_pass
    )
    if ok_cached:
        sent = translate_with_okbits(
            idx, np.asarray(ref_pass["wcx_distok"])[ct:], ml, ct
        )
        dist = None
    else:
        dist = np.asarray(ref_pass["distances"])[ct:]
        sent = translate_and_mask(idx, dist, ml, ct, cutoff)
    if "wcx_weights" in ref_pass:
        weights = np.asarray(ref_pass["wcx_weights"], np.float64)[ct:]
    else:
        if dist is None:
            dist = np.asarray(ref_pass["distances"])[ct:]
        weights = norm_ops.get_weights(dist)
    if upload:
        sent = upload_sentinel(sent)
    return PassTables(sent, weights, ml, ct)


class ReferenceLoader:
    """Background-threaded reference loading for one predict invocation.

    Usage::

        loader = ReferenceLoader(path)        # small members, fast
        ...                                   # decide ref_gender
        loader.start(ref_gender, maskrepeats) # spawn decompress/upload
        tables = loader.tables("A")           # blocks until ready
        nulls  = loader.null_ratios("A")
    """

    def __init__(self, path):
        self.path = path
        t0 = time.perf_counter()
        self.passes, self.meta = load_reference_small(path)
        logging.debug(
            "reference small members in %.2fs", time.perf_counter() - t0
        )
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="wcx-ref-loader"
        )
        self._futs: dict = {}
        self._started = False
        self._use_cache = False
        self._inf_cutoff = False

    # -- internals --------------------------------------------------------

    def _member(self, gender: str, key: str, row_start: int = 0):
        """Load one big npz member (own handle per thread); stored
        members honour ``row_start`` with a seek instead of a full read.

        The ``[timing]`` stages overlap each other (they run on the
        loader's thread pool) — they attribute where the bytes went, not
        additive wall-clock."""
        from wisecondorx_tpu.io.npz import load_member_rows
        from wisecondorx_tpu.utils.log import stage_timer

        suffix = "" if gender == "A" else f".{gender}"
        with stage_timer(f"predict.load.{key}{suffix}"):
            return load_member_rows(
                self.path, f"{key}{suffix}", row_start
            )

    def _cutoff(self, maskrepeats: int) -> float:
        # Quirk preserved: the cutoff always derives from the *autosomal*
        # pass distances, even for the gonosomal pass (reference
        # predict_control.py:34 reads the unsuffixed "distances" key).
        from wisecondorx_tpu.utils.log import stage_timer

        if maskrepeats <= 0:
            # No masking iterations: the reference returns the initial
            # inf cutoff untouched (predict_tools.py:75-82); the cached
            # schedule starts at repeats=1 so indexing it would silently
            # apply the deepest cached cutoff instead.
            return float("inf")
        cached = self.passes["A"].get("wcx_cutoffs")
        if cached is not None and maskrepeats <= len(np.atleast_1d(cached)):
            return float(np.atleast_1d(cached)[maskrepeats - 1])
        dist_a = self._futs[("dist", "A")].result()
        with stage_timer("predict.load.cutoff"):
            return norm_ops.get_optimal_cutoff(dist_a, maskrepeats)

    def _tables(self, gender: str) -> PassTables:
        import jax

        small = self.passes[gender]
        ct = pass_ct(small, gender)
        ml = MaskedLayout(
            GenomeLayout(np.asarray(small["bins_per_chr"])),
            np.asarray(small["mask"], dtype=bool),
        )
        from wisecondorx_tpu.utils.log import stage_timer

        idx_t = np.asarray(self._futs[("idx", gender)].result())
        cutoff = self._futs["cutoff"].result()

        # With the wcx_* caches (our own newref output) and the default
        # --maskrepeats 5, the distance table is never touched: weights
        # and the cutoff mask come from the cached members.  The weights
        # cache is cutoff-independent, so it serves at EVERY maskrepeats
        # depth; only the bit-packed distok mask is pinned to depth 5.
        ok_t = None
        if self._use_cache and "wcx_distok" in small:
            ok_t = np.asarray(small["wcx_distok"])[ct:]
        dist_t = None
        if ok_t is None and not self._inf_cutoff:
            # The dist future was already row-sliced at ct (see start).
            dist_t = np.asarray(self._futs[("dist", gender)].result())
        if "wcx_weights" in small:
            weights = np.asarray(small["wcx_weights"], np.float64)[ct:]
        else:
            if dist_t is None:
                dist_t = np.asarray(
                    self._futs[("dist", gender)].result()
                )
            with stage_timer(f"predict.load.weights_{gender}"):
                weights = norm_ops.get_weights(dist_t)
        # Chunked translate -> packed async-upload pipeline: each
        # chunk's h2d rides the link while the next chunk translates on
        # host (device_put is async), and one full-shape decode rebuilds
        # the int32 table after a device-side concat.  The "translate" stage times the
        # host loop (+ enqueue); "upload" times the link-wait tail.
        import jax

        rows, k = idx_t.shape

        def translate_rows(s, e):
            if ok_t is not None:
                return translate_with_okbits(
                    idx_t[s:e], ok_t[s:e], ml, ct + s
                )
            if self._inf_cutoff:
                # maskrepeats <= 0: an infinite cutoff keeps every
                # neighbour — no distance compare needed at all.
                return np.asarray(
                    ml.neighbour_to_global(idx_t[s:e], row_start=ct + s),
                    dtype=np.int32,
                )
            return translate_and_mask(
                idx_t[s:e], dist_t[s:e], ml, ct + s, cutoff
            )

        # Translated values are global masked indexes in [-1, n_masked);
        # packability is therefore known before translating anything.
        if ml.n_masked >= (1 << 24) or rows == 0:
            with stage_timer(f"predict.load.translate_{gender}"):
                sent = translate_rows(0, rows)
            with stage_timer(f"predict.load.upload_{gender}"):
                sent_dev = upload_sentinel(sent)
        else:
            chunk = _upload_chunk_rows(k)
            parts = []
            with stage_timer(f"predict.load.translate_{gender}"):
                for s in range(0, rows, chunk):
                    packed = _pack_sentinel(translate_rows(
                        s, min(s + chunk, rows)
                    ))
                    if packed is None:  # only a corrupt index table
                        raise RuntimeError(
                            "sentinel index outside the 24-bit range "
                            "despite n_masked < 2^24 — corrupt "
                            "reference index table"
                        )
                    parts.append(jax.device_put(packed))  # async h2d
            with stage_timer(f"predict.load.upload_{gender}"):
                sent_dev = _assemble_packed(parts)
        logging.info(
            "streamed %s sentinel indexes (%.0f MB) to device", gender,
            rows * k * 4 / 2**20,
        )
        return PassTables(sent_dev, weights, ml, ct)

    # -- public API -------------------------------------------------------

    def start(self, ref_gender: str, maskrepeats: int) -> None:
        """Kick off loading + host math + uploads for the "A" pass and
        the resolved gonosomal pass.

        With the ``wcx_*`` caches present and ``--maskrepeats 5`` the
        distance tables never load; index tables row-slice for the
        gonosomal pass (stored members admit seeks)."""
        if self._started:
            return
        self._started = True
        genders = ["A"] + ([ref_gender] if ref_gender != "A" else [])
        sub = self._pool.submit
        # The bit-packed cutoff mask is only valid at the repeats depth
        # it was built for (the default 5); repeats <= 0 needs no mask
        # at all (infinite cutoff keeps every neighbour).
        self._use_cache = maskrepeats == 5
        self._inf_cutoff = maskrepeats <= 0
        cutoffs = self.passes["A"].get("wcx_cutoffs")
        cutoff_cached = maskrepeats <= 0 or (
            cutoffs is not None
            and maskrepeats <= len(np.atleast_1d(cutoffs))
        )
        for g in genders:
            ct = pass_ct(self.passes[g], g)
            self._futs[("idx", g)] = sub(self._member, g, "indexes", ct)
            # Distances are needed for the translate mask (unless the
            # depth-5 okbits cache serves, or the cutoff is infinite)
            # and for weights (unless cached — cutoff-independent).
            need_dist = ("wcx_weights" not in self.passes[g]) or not (
                self._inf_cutoff
                or (self._use_cache and "wcx_distok" in self.passes[g])
            )
            if need_dist or (g == "A" and not cutoff_cached):
                self._futs[("dist", g)] = sub(
                    self._member, g, "distances", ct if need_dist else 0
                )
        self._futs["cutoff"] = sub(self._cutoff, maskrepeats)
        for g in genders:
            self._futs[("tables", g)] = sub(self._tables, g)
            self._futs[("null", g)] = sub(self._member, g, "null_ratios")

    def cutoff(self) -> float:
        return self._futs["cutoff"].result()

    def tables(self, gender: str) -> PassTables:
        return self._futs[("tables", gender)].result()

    def null_ratios(self, gender: str) -> np.ndarray:
        return self._futs[("null", gender)].result()
