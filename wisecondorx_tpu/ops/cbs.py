"""Circular binary segmentation (CBS) — JAX reimplementation of the
reference's R/DNAcopy subprocess (reference predict_tools.py:242-275 +
include/CBS.R), removing the Python->JSON->Rscript round-trip entirely.

Algorithm (Olshen et al. 2004; weighted statistic as in DNAcopy's weighted
path, which the reference always uses since CBS.R:73 passes weights):

* per chromosome, non-NA bins are segmented recursively;
* for a segment of n bins, the split statistic is the max over circular
  arcs (i, j] (arc and complement each >= min_width bins) of
  ``|T| = |(X1/W1 - X0/W0)| / sqrt(1/W1 + 1/W0)`` with W/X the arc's
  weight / weighted-value sums;
* significance via permutation: device-vectorized permutation batches
  with early termination once the exceedance count proves p > alpha —
  the Monte-Carlo decision DNAcopy reaches through its sequential boundary
  (eta/sbdry machinery) without the per-permutation Fortran loop;
* where DNAcopy switches to its "hybrid" analytic tail approximation for
  long arcs (kmax=25), we instead test the max over a *thinned arc-length
  family* — all short arcs up to kmax exactly (including the wrap-around
  arcs, via the complement identity |T(arc)| == |T(complement)|), plus a
  geometric grid of longer lengths — using the SAME family for the
  observed and the permuted statistic.  That keeps the test an exact
  Monte-Carlo permutation test of a slightly less powerful statistic (the
  grid captures near-100% of the full max because arc maxima are strongly
  correlated across neighbouring lengths) while cutting per-permutation
  cost from O(n^2) to O(n log n);
* once a split is significant, the breakpoint is located with the exact
  full O(n^2) scan (run once per accepted split, like DNAcopy's
  detection/location separation).

Execution model: every synchronized dispatch costs a host round trip, and
a one-segment-at-a-time recursion needs ~1400 of them for a full genome at
15 kb.  The engine below therefore runs the recursion
*level-synchronously over every pending segment of every chromosome (and,
in batch mode, every sample)*:

* segments are grouped by padded-size bucket; each group's values live
  on device once per level;
* one fused program per group generates a batch of permutations
  (``lax.sort`` by random keys carrying the (w, w*x) payloads — no index
  gather), computes the observed statistic and all permuted maxima, and
  returns per-segment exceedance counts: ONE round trip decides a whole
  cohort of segments for ~10k permutation rows;
* the arc-length family is *shift-invariant* (shared per bucket): the
  n-dependent "mirror" lengths of the old per-segment family are exactly
  the wrap-around arcs of circular length <= kmax, which a [rows, kmax+1]
  suffix-sum table evaluates in O(kmax^2) extra work per row — so
  segments of different true sizes batch into the same program;
* breakpoint location for accepted splits runs as one batched exact scan
  per bucket.

Post-processing mirrors CBS.R exactly:

* zero ratios enter as NA (blacklist), zero weights become 1.0 — CBS.R:42
  writes ``1^-99`` which is literally 1.0, an R typo kept for parity;
* all-NA chromosomes emit no segments (CBS.R:56-63);
* segments spanning NA runs longer than ``int(2e6 / binsize)`` bins are
  split, keeping only pieces of length > 1, with the piece after a run
  starting on the run's last NA bin — CBS.R:84-113's exact off-by-one;
* segment ratios are recomputed as weighted means over the segment's bins
  (NA-removed) and rounded to 4 decimals — the rounding the reference
  inherits silently from jsonlite::write_json's digits=4 default;
* starts are converted to 0-based (CBS.R:129).

Determinism: the reference seeds R's RNG only when --seed is given
(CBS.R:67-69); here a JAX PRNG key derived from ``seed`` (default 0) makes
segmentation reproducible by default.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from wisecondorx_tpu.utils.device import on_accelerator


@dataclasses.dataclass
class CBSConfig:
    alpha: float = 1e-4
    nperm: int = 10000
    min_width: int = 2
    #: Permutation rows per host-loop batch (the device loop sizes
    #: batches from ``row_elems`` instead).
    perm_batch: int = 1024
    seed: int | None = 0
    #: All arc lengths <= kmax are tested exactly (DNAcopy's kmax),
    #: including the wrap-around arcs of circular length <= kmax.
    kmax: int = 25
    #: Geometric spacing of the long-arc length grid.
    length_ratio: float = 1.08
    #: Segments up to this size use the exact all-lengths arc family for
    #: the permutation test too (the thinned grid only kicks in above it,
    #: where its O(n log n) cost matters).
    exact_max: int = 2048
    #: Significance method: "perm" (Monte-Carlo permutation, default) or
    #: "hybrid" (DNAcopy-style: permutation over short arcs <= kmax plus a
    #: Siegmund-type analytic tail bound for the long arcs).
    p_method: str = "perm"
    #: Deterministic mode: accept a split iff the observed max |T| >= this
    #: value, skipping the permutation test entirely.  Makes segmentation
    #: a pure function of the data (reproducible across machines and RNGs,
    #: and fast); also the hook the differential test oracle uses
    #: (tests/cbs_oracle.py).
    t_threshold: float | None = None
    #: Element budget (rows x padded size) per device permutation dispatch;
    #: bounds device memory and sets how many permutation rows one round
    #: trip carries.
    row_elems: int = 1 << 26
    #: Max segments decided by one batched program instance.
    seg_batch: int = 32


#: Fixed padding of thinned/short length families — one program shape per
#: bucket regardless of the segment's true size.
_LFIX = 256


def _bucket(n: int) -> int:
    """Padded-size bucket: x4 growth up to 2048 (compute there is cheap;
    fewer buckets = fewer cold compiles), x2 above (padding waste on the
    big top-level segments costs real HBM traffic)."""
    p = 8
    while p < n:
        p *= 4 if p <= 512 else 2
    return p


def _bucket_list(n_max: int) -> list[int]:
    """Every bucket the engine can touch for segments up to ``n_max``,
    largest first (the recursion tests whole chromosomes before pieces)."""
    out = []
    p = _bucket(n_max)
    while p >= 8:
        out.append(p)
        p = p // 2 if p > 2048 else p // 4
    return out


# ---------------------------------------------------------------------------
# Statistic kernels
# ---------------------------------------------------------------------------


#: Arc lengths folded per lax.scan step — amortizes the per-step overhead
#: of long scans (locate: n_pad steps).
_SCAN_UNROLL = 8


def _tstat_scan(cw, cwx, n, lengths, min_width, want_argmax=True):
    """Max |T| over window arcs with lengths from ``lengths``.

    ``cw``/``cwx`` are zero-prefixed cumulative sums, possibly batched with
    a leading axis; ``n`` is the true (unpadded) size — scalar or per-row
    [B].  Scans arc length L, vectorizing over arc starts i.  Entries of
    ``lengths`` outside [min_width, n - min_width] are ignored per row.

    Returns (max, i*, L*) with ``want_argmax`` (tie order: shortest arc
    first, then smallest start — pinned by tests/test_cbs_oracle.py), else
    just max.  The tie order is preserved under the unrolled scan because
    ``lengths`` is scanned in its given (sorted) order and later entries
    only replace the carry on a strict improvement.
    """
    batched = cw.ndim == 2
    n_pad = cw.shape[-1] - 1
    B = cw.shape[0] if batched else 1
    cw = cw if batched else cw[None]
    cwx = cwx if batched else cwx[None]
    n_col = jnp.broadcast_to(jnp.asarray(n, jnp.int32).reshape(-1, 1), (B, 1))

    w_tot = jnp.take_along_axis(cw, n_col, axis=1)  # [B, 1]
    x_tot = jnp.take_along_axis(cwx, n_col, axis=1)
    i_idx = jnp.arange(n_pad + 1)
    # Arc end = start + L is a uniform shift: a contiguous dynamic slice
    # of the edge-padded cumsums replaces a [B, n] gather.
    cw2 = jnp.pad(cw, ((0, 0), (0, n_pad + 1)), mode="edge")
    cwx2 = jnp.pad(cwx, ((0, 0), (0, n_pad + 1)), mode="edge")

    lengths = jnp.asarray(lengths, jnp.int32)
    pad = (-lengths.shape[0]) % _SCAN_UNROLL
    if pad:
        # Zero-length entries fail the L >= min_width validity test.
        lengths = jnp.concatenate([lengths, jnp.zeros(pad, jnp.int32)])
    lengths = lengths.reshape(-1, _SCAN_UNROLL)

    def one_length(carry, L):
        w1 = jax.lax.dynamic_slice_in_dim(cw2, L, n_pad + 1, axis=1) - cw
        x1 = jax.lax.dynamic_slice_in_dim(cwx2, L, n_pad + 1, axis=1) - cwx
        w0 = w_tot - w1
        x0 = x_tot - x1
        t = (x1 / w1 - x0 / w0) * jax.lax.rsqrt(1.0 / w1 + 1.0 / w0)
        valid = (
            (i_idx[None, :] + L <= n_col)
            & (L >= min_width)
            & (L <= n_col - min_width)
        )
        t = jnp.where(valid, jnp.abs(t), -jnp.inf)
        m = jnp.max(t, axis=1)
        if want_argmax:
            best, best_i, best_l = carry
            am = jnp.argmax(t, axis=1)
            better = m > best
            return (
                jnp.where(better, m, best),
                jnp.where(better, am.astype(jnp.int32), best_i),
                jnp.where(better, L, best_l),
            )
        return jnp.maximum(carry, m)

    def body(carry, Ls):
        for u in range(_SCAN_UNROLL):
            carry = one_length(carry, Ls[u])
        return carry, None

    if want_argmax:
        init = (
            jnp.full((B,), -jnp.inf, cw.dtype),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
        )
        (best, best_i, best_l), _ = jax.lax.scan(body, init, lengths)
        if not batched:
            return best[0], best_i[0], best_l[0]
        return best, best_i, best_l
    best, _ = jax.lax.scan(
        body, jnp.full((B,), -jnp.inf, cw.dtype), lengths
    )
    return best if batched else best[0]


def _wrap_max(cw, cwx, n_col, kmax: int, min_width: int):
    """Max |T| over wrap-around arcs of circular length <= kmax.

    A wrap arc = suffix of length s + prefix of length p (s, p >= 1,
    s + p <= kmax).  By |T(arc)| == |T(complement)| these equal the old
    per-segment "mirror" window lengths {n-kmax..n-min_width} — but unlike
    those, this form is independent of n, so segments of different sizes
    share one compiled program.  Cost: one [B, kmax+1] gather + a
    [B, kmax+1, kmax+1] tensor — negligible next to the window scan.
    """
    B = cw.shape[0]
    kmax = min(kmax, cw.shape[1] - 1)  # tiny buckets: n_pad < kmax
    s_idx = jnp.arange(kmax + 1)
    w_tot = jnp.take_along_axis(cw, n_col, axis=1)  # [B, 1]
    x_tot = jnp.take_along_axis(cwx, n_col, axis=1)
    # Suffix sums: sum of last s = cw[n] - cw[n-s].
    pos = jnp.clip(n_col - s_idx[None, :], 0, cw.shape[1] - 1)  # [B, k+1]
    sfx_w = w_tot - jnp.take_along_axis(cw, pos, axis=1)
    sfx_x = x_tot - jnp.take_along_axis(cwx, pos, axis=1)
    pre_w = cw[:, : kmax + 1]
    pre_x = cwx[:, : kmax + 1]
    w1 = sfx_w[:, :, None] + pre_w[:, None, :]  # [B, s, p]
    x1 = sfx_x[:, :, None] + pre_x[:, None, :]
    w0 = w_tot[:, :, None] - w1
    x0 = x_tot[:, :, None] - x1
    t = (x1 / w1 - x0 / w0) * jax.lax.rsqrt(1.0 / w1 + 1.0 / w0)
    k_len = s_idx[None, :, None] + s_idx[None, None, :]  # s + p
    valid = (
        (s_idx[None, :, None] >= 1)
        & (s_idx[None, None, :] >= 1)
        & (k_len <= kmax)
        & (k_len >= min_width)
        & (k_len <= n_col[:, :, None] - min_width)
        & (s_idx[None, :, None] < n_col[:, :, None])
    )
    t = jnp.where(valid, jnp.abs(t), -jnp.inf)
    return jnp.max(t.reshape(B, -1), axis=1)


def _row_cumsums(w_rows, wx_rows):
    zero = jnp.zeros((w_rows.shape[0], 1), w_rows.dtype)
    cw = jnp.concatenate([zero, jnp.cumsum(w_rows, axis=1)], axis=1)
    cwx = jnp.concatenate([zero, jnp.cumsum(wx_rows, axis=1)], axis=1)
    return cw, cwx


def _max_t_rows_impl(w_rows, wx_rows, n_rows, lengths, min_width, kmax):
    """Max |T| per row over the (windows + wrap arcs) family."""
    cw, cwx = _row_cumsums(w_rows, wx_rows)
    n_col = jnp.asarray(n_rows, jnp.int32).reshape(-1, 1)
    best = _tstat_scan(
        cw, cwx, n_rows, lengths, min_width, want_argmax=False
    )
    if kmax > 0:
        best = jnp.maximum(best, _wrap_max(cw, cwx, n_col, kmax, min_width))
    return best


_max_t_rows = jax.jit(
    _max_t_rows_impl, static_argnames=("min_width", "kmax")
)


@functools.partial(jax.jit, static_argnames=("min_width",))
def _observed_stat(x, w, n, lengths, min_width: int):
    """Single-segment observed statistic over window arcs (kept for tests
    and the threshold/hybrid prepass; returns (max, i*, L*))."""
    cw = jnp.concatenate([jnp.zeros(1, x.dtype), jnp.cumsum(w)])
    cwx = jnp.concatenate([jnp.zeros(1, x.dtype), jnp.cumsum(w * x)])
    return _tstat_scan(cw, cwx, n, lengths, min_width)


@functools.partial(jax.jit, static_argnames=("min_width",))
def _locate_batch(w_seg, wx_seg, n_seg, min_width: int):
    """Exact all-window-lengths scan per segment; returns (i*, l*) [S]."""
    cw, cwx = _row_cumsums(w_seg, wx_seg)
    lengths = jnp.arange(w_seg.shape[1], dtype=jnp.int32)
    _, i_star, l_star = _tstat_scan(
        cw, cwx, n_seg, lengths, min_width, want_argmax=True
    )
    return i_star, l_star


def _shuffle_rows(keys, w_rows, wx_rows):
    """Row-wise sort by random ``keys`` carrying the (w, wx) payloads —
    i.e. a uniform joint shuffle of each row's (w, wx) pairs.

    ``lax.sort`` with payload operands sorts the payloads directly rather
    than applying an index permutation through a [B, n_pad] gather.

    Ties in the 32-bit keys resolve arbitrarily (is_stable=False); the
    uniformity deviation (P(tie) ~ n^2/2^33 per row) is far below
    Monte-Carlo resolution.
    """
    _, w_p, wx_p = jax.lax.sort(
        (keys, w_rows, wx_rows), dimension=1, is_stable=False, num_keys=1
    )
    return w_p, wx_p


@functools.partial(
    jax.jit, static_argnames=("min_width", "kmax", "use_ext_obs")
)
def _perm_round_device(
    base_key, w_seg, wx_seg, n_seg, seg_of_row, row_live,
    row_salt, row_lo, row_hi, row_draw, obs_ext, lengths,
    min_width: int, kmax: int, use_ext_obs: bool = False,
):
    """One fused permutation round for a batch of segments (device loop).

    ``w_seg``/``wx_seg``: [S, n_pad] per-segment weight / weight*value
    vectors (zero-padded past ``n_seg[s]``); ``seg_of_row``: [B] segment
    slot per permutation row; ``row_live``: [B] rows that count.  The
    first S internal rows are the *unshuffled* segments, so the observed
    statistic comes out of the same program — no separate round trip.

    Each permutation row's random keys derive from
    (base_key, row_salt, row_lo, row_hi, row_draw) — the draw is a pure
    function of the segment's identity and its draw index, independent of
    how segments are batched across dispatches, samples, or hosts.

    ``use_ext_obs`` (hybrid): compare permuted maxima against ``obs_ext``
    (the host-computed full-family observed statistic) instead of the
    in-program short-family observed rows.

    Returns (exceed_counts [S] int32, obs [S]).
    """
    S, n_pad = w_seg.shape
    w_rows = jnp.concatenate([w_seg, jnp.take(w_seg, seg_of_row, axis=0)])
    wx_rows = jnp.concatenate([wx_seg, jnp.take(wx_seg, seg_of_row, axis=0)])
    n_rows = jnp.concatenate([n_seg, jnp.take(n_seg, seg_of_row)])

    idx = jnp.arange(n_pad, dtype=jnp.uint32)

    def row_bits(salt, lo, hi, d):
        k = jax.random.fold_in(base_key, salt)
        k = jax.random.fold_in(k, lo)
        k = jax.random.fold_in(k, hi)
        k = jax.random.fold_in(k, d)
        return jax.random.bits(k, (n_pad,), dtype=jnp.uint32)

    rand = jax.vmap(row_bits)(row_salt, row_lo, row_hi, row_draw)
    rand = rand & jnp.uint32(0x7FFFFFFF)
    # Real slots get random keys; padding slots sort to the tail in index
    # order.  The S observed rows get plain index keys == identity.
    rand = jnp.where(
        idx[None, :] < n_rows[S:, None], rand, jnp.uint32(0x80000000) | idx
    )
    keys = jnp.concatenate([jnp.broadcast_to(idx, (S, n_pad)), rand])
    w_p, wx_p = _shuffle_rows(keys, w_rows, wx_rows)

    best = _max_t_rows_impl(w_p, wx_p, n_rows, lengths, min_width, kmax)
    obs = best[:S]
    obs_cmp = obs_ext if use_ext_obs else obs
    ex = (best[S:] >= jnp.take(obs_cmp, seg_of_row)) & row_live
    counts = jnp.zeros(S, jnp.int32).at[seg_of_row].add(ex.astype(jnp.int32))
    return counts, obs


# ---------------------------------------------------------------------------
# Arc-length families
# ---------------------------------------------------------------------------


def _arc_lengths(n_pad: int, cfg: CBSConfig, short_only: bool = False):
    """Shift-invariant window-length family for a size bucket, padded to
    ``_LFIX``.

    * all lengths in [min_width, kmax] (the wrap/mirror arcs are handled
      separately by :func:`_wrap_max`, so no n-dependent entries remain);
    * plus, unless ``short_only``, a geometric grid up to ``n_pad``.

    Per-row validity (L <= n - min_width) is enforced inside the scan, so
    one family serves every segment in the bucket.
    """
    mw = cfg.min_width
    ls = set(range(mw, cfg.kmax + 1))
    if not short_only:
        length = float(cfg.kmax)
        while length < n_pad:
            length = max(length * cfg.length_ratio, length + 1.0)
            ls.add(min(int(length), n_pad))
    out = np.array(sorted(ls), dtype=np.int32)
    if len(out) > _LFIX:
        raise ValueError(
            f"arc-length family ({len(out)}) exceeds _LFIX={_LFIX}; "
            f"raise length_ratio or _LFIX"
        )
    padded = np.zeros(_LFIX, dtype=np.int32)
    padded[: len(out)] = out
    return padded


def _group_lengths(n_pad: int, cfg: CBSConfig, mode: str) -> np.ndarray:
    """Length family for a (bucket, mode) group.

    mode "exact": every window length (the statistic is then DNAcopy's
    full max); "thin": the thinned family; "short": hybrid's <=kmax part.
    """
    if mode == "exact":
        return np.arange(n_pad, dtype=np.int32)
    return _arc_lengths(n_pad, cfg, short_only=(mode == "short"))


# ---------------------------------------------------------------------------
# Analytic tail (the "hybrid" option)
# ---------------------------------------------------------------------------


def _nu(x):
    """Siegmund's overshoot correction nu(x) (computable approximation)."""
    x = np.maximum(np.asarray(x, dtype=np.float64), 1e-8)
    from scipy.stats import norm as _norm

    phi = _norm.pdf(x / 2)
    Phi = _norm.cdf(x / 2)
    return ((2.0 / x) * (Phi - 0.5)) / ((x / 2) * Phi + phi)


def _tail_prob_long_arcs(b: float, n: int, kmax: int) -> float:
    """P(max over arcs longer than kmax of |T| >= b) under H0.

    Siegmund-type approximation for the maximum of the standardized
    two-sample statistic over the TWO-parameter family (arc start and arc
    length fraction t in (kmax/n, 1/2]):

        p ~= b^3 * phi(b) * Int nu(b*sqrt(2/(n t(1-t))))^2 / (t(1-t))^2 dt

    — the two-parameter field version of the formula behind DNAcopy's
    hybrid `tailp` (structurally equivalent, not claimed bit-identical).
    Empirical calibration (tests/test_cbs_battery.py): within a factor ~2
    of Monte-Carlo in the moderate tail at n=200, erring conservative
    (over-estimating p, i.e. under-splitting).  Returns 1.0 for tiny b.

    MEASURED UNSAFE ON SKEWED WEIGHTS (docs/cbs_calibration_hybrid.md):
    the formula assumes equal-variance increments; under 3-decade weight
    skew it realizes Type-I level 0.0695 at alpha=0.05 (whole 95% CI
    above alpha).  ``p_method="perm"`` (the default) is the validated
    mode; do not use "hybrid" on weighted data.
    """
    from scipy.stats import norm as _norm

    if not np.isfinite(b) or b <= 1.0:
        return 1.0
    t0 = max(kmax / n, 1e-6)
    if t0 >= 0.5:
        return 0.0
    t = np.linspace(t0, 0.5, 1024)
    tt = t * (1.0 - t)
    integrand = _nu(b * np.sqrt(2.0 / (n * tt))) ** 2 / tt**2
    integral = np.trapezoid(integrand, t)
    p = float(b**3 * _norm.pdf(b) * integral)
    return min(max(p, 0.0), 1.0)


# ---------------------------------------------------------------------------
# Level-synchronous engine
# ---------------------------------------------------------------------------


class _Item:
    """One pending segment: job ``ji``, half-open value range [lo, hi)."""

    __slots__ = ("ji", "lo", "hi", "n", "exceed", "done", "max_ones",
                 "decision", "split")

    def __init__(self, ji, lo, hi):
        self.ji = ji
        self.lo = lo
        self.hi = hi
        self.n = hi - lo
        self.exceed = 0
        self.done = 0
        self.max_ones = 0
        self.decision = None  # True=split, False=final
        self.split = None  # (i, j) within [0, n)


def _alloc_rows(B, items, remaining):
    """Fair-share allocation of B permutation rows among undecided items
    (each capped at its remaining draw budget)."""
    counts = [0] * len(items)
    left = B
    for pos in range(len(items)):
        share = left // (len(items) - pos)
        give = min(remaining[pos], share)
        counts[pos] = give
        left -= give
    if left:
        for pos in range(len(items)):
            extra = min(remaining[pos] - counts[pos], left)
            counts[pos] += extra
            left -= extra
            if not left:
                break
    return counts


def _seg_tables(items, jobs, n_pad, dtype, s_pad):
    """Build [s_pad, n_pad] (w, w*x) host tables + true sizes for a chunk.

    The segment axis is ALWAYS padded to ``s_pad`` — a partial chunk with
    its own S would otherwise compile a fresh program per (S, n_pad)
    combination.
    Padding rows have n=0 and produce NaN statistics that nothing reads:
    no permutation rows point at them and their locate results are
    discarded.
    """
    w_seg = np.zeros((s_pad, n_pad), dtype=dtype)
    wx_seg = np.zeros((s_pad, n_pad), dtype=dtype)
    n_seg = np.zeros(s_pad, dtype=np.int32)
    for s, it in enumerate(items):
        x, w = jobs[it.ji]
        w_seg[s, : it.n] = w[it.lo : it.hi]
        wx_seg[s, : it.n] = w[it.lo : it.hi] * x[it.lo : it.hi]
        n_seg[s] = it.n
    return w_seg, wx_seg, n_seg


def _job_salt(x: np.ndarray, w: np.ndarray) -> int:
    """Content-derived PRNG salt for one job.

    Every permutation draw is keyed by (seed, salt, segment lo/hi, draw
    index), so a segment's Monte-Carlo stream is a pure function of the
    data it tests — independent of which other chromosomes/samples share
    its device batches and of multi-host shard composition (the round-3
    global dispatch counter made sharded-vs-solo equality hold only away
    from the alpha boundary)."""
    import zlib

    return zlib.crc32(w.tobytes(), zlib.crc32(x.tobytes())) & 0x7FFFFFFF


def _decide_group(items, jobs, salts, n_pad, mode, cfg, seed, on_device,
                  dtype):
    """Decide split significance for every item of one (bucket, mode)
    group; fills ``it.decision`` (and exceed/done diagnostics)."""
    lengths_np = _group_lengths(n_pad, cfg, mode)
    lengths = jnp.asarray(lengths_np)
    mw = cfg.min_width
    kmax = cfg.kmax

    # Threshold mode and the hybrid tail test need the observed statistic
    # on host; the pure-perm device loop computes it inside the fused round
    # instead (one fewer round trip).  The hybrid observed statistic is
    # evaluated over the FULL (thinned) arc family — DNAcopy compares both
    # the analytic tail bound and the short-arc permutation maxima against
    # the observed full max, not a short-only max (which would shrink b,
    # inflate p_tail, and miss splits whose max |T| sits on a long arc).
    need_obs = (
        cfg.t_threshold is not None or mode == "short" or not on_device
    )
    budgets = {}
    if need_obs:
        obs_lengths = (
            jnp.asarray(_group_lengths(n_pad, cfg, "thin"))
            if mode == "short"
            else lengths
        )
        for chunk in _chunks(items, cfg.seg_batch):
            w_seg, wx_seg, n_seg = _seg_tables(
                chunk, jobs, n_pad, dtype, cfg.seg_batch
            )
            obs = np.asarray(
                _max_t_rows(
                    jnp.asarray(w_seg), jnp.asarray(wx_seg),
                    jnp.asarray(n_seg), obs_lengths, mw, kmax,
                )
            )
            for s, it in enumerate(chunk):
                o = float(obs[s])
                if not np.isfinite(o) or o <= 0:
                    it.decision = False
                elif cfg.t_threshold is not None:
                    it.decision = bool(o >= cfg.t_threshold)
                elif mode == "short":
                    # Hybrid: analytic long-arc tail first; the
                    # permutation part spends what's left of alpha.
                    p_tail = _tail_prob_long_arcs(o, it.n, kmax)
                    if p_tail > cfg.alpha:
                        it.decision = False
                    else:
                        budgets[id(it)] = (o, cfg.alpha - p_tail)
                else:
                    budgets[id(it)] = (o, cfg.alpha)
    if cfg.t_threshold is not None:
        return

    undecided = [it for it in items if it.decision is None]
    if not undecided:
        return
    for it in undecided:
        alpha = budgets[id(it)][1] if id(it) in budgets else cfg.alpha
        it.max_ones = int(np.floor(cfg.nperm * alpha)) + 1

    ext_obs = (
        {id(it): budgets[id(it)][0] for it in undecided}
        if mode == "short"
        else None
    )
    for chunk in _chunks(undecided, cfg.seg_batch):
        if on_device:
            _perm_loop_device(
                chunk, jobs, salts, n_pad, lengths, cfg, seed, dtype,
                ext_obs=ext_obs,
            )
        else:
            _perm_loop_host(
                chunk, jobs, salts, n_pad, lengths, cfg, seed, dtype,
                obs={id(it): budgets[id(it)][0] for it in chunk},
            )


def _perm_loop_device(
    chunk, jobs, salts, n_pad, lengths, cfg, seed, dtype, ext_obs=None
):
    """Batched early-terminating permutation loop, one fused dispatch per
    round (accelerator path: permutations generate on device).

    ``ext_obs`` (hybrid mode): per-item observed statistic computed over
    the full family on host; when given, permutation maxima compare
    against it instead of the in-program observed rows."""
    w_seg, wx_seg, n_seg = _seg_tables(
        chunk, jobs, n_pad, dtype, cfg.seg_batch
    )
    w_j = jnp.asarray(w_seg)
    wx_j = jnp.asarray(wx_seg)
    n_j = jnp.asarray(n_seg)
    base_key = jax.random.PRNGKey(0 if seed is None else int(seed))
    use_ext = ext_obs is not None
    obs_ext = np.zeros(cfg.seg_batch, dtype=dtype)
    if use_ext:
        for s, it in enumerate(chunk):
            obs_ext[s] = ext_obs[id(it)]
    obs_ext = jnp.asarray(obs_ext)
    B = max(64, min(cfg.row_elems // n_pad, 1 << 16))

    def live(it):
        return it.decision is None and it.done < cfg.nperm

    while any(live(it) for it in chunk):
        active = [s for s, it in enumerate(chunk) if live(it)]
        remaining = [cfg.nperm - chunk[s].done for s in active]
        counts = _alloc_rows(B, active, remaining)
        seg_of_row = np.zeros(B, dtype=np.int32)
        row_live = np.zeros(B, dtype=bool)
        row_salt = np.zeros(B, dtype=np.int32)
        row_lo = np.zeros(B, dtype=np.int32)
        row_hi = np.zeros(B, dtype=np.int32)
        row_draw = np.zeros(B, dtype=np.int32)
        r = 0
        for pos, s in enumerate(active):
            k = counts[pos]
            it = chunk[s]
            seg_of_row[r : r + k] = s
            row_live[r : r + k] = True
            row_salt[r : r + k] = salts[it.ji]
            row_lo[r : r + k] = it.lo
            row_hi[r : r + k] = it.hi
            row_draw[r : r + k] = np.arange(it.done, it.done + k)
            r += k
        ex_counts, _ = _perm_round_device(
            base_key, w_j, wx_j, n_j,
            jnp.asarray(seg_of_row), jnp.asarray(row_live),
            jnp.asarray(row_salt), jnp.asarray(row_lo),
            jnp.asarray(row_hi), jnp.asarray(row_draw),
            obs_ext, lengths, cfg.min_width, cfg.kmax, use_ext,
        )
        ex_counts = np.asarray(ex_counts)
        for pos, s in enumerate(active):
            it = chunk[s]
            it.exceed += int(ex_counts[s])
            it.done += counts[pos]
            if it.exceed >= it.max_ones:
                it.decision = False  # p > alpha proven — stop early
            elif it.done >= cfg.nperm:
                it.decision = True
    for it in chunk:
        if it.decision is None:
            it.decision = it.exceed < it.max_ones


def _perm_loop_host(chunk, jobs, salts, n_pad, lengths, cfg, seed, dtype, obs):
    """CPU path: numpy Fisher-Yates permutation rows, same decision logic.

    Draw ``d`` for a segment is generated by an rng seeded with
    (seed, salt, lo, hi, d) — composition-independent, like the device
    loop (the two loops' streams differ from each other by design).

    Cost note: constructing a Generator per draw measures ~56 us vs
    ~16 us/draw for one batched ``rng.permuted`` — accepted on this
    CPU-only fallback path because the batched form ties a draw's stream
    to the dispatch's row allocation (composition-dependent, the exact
    defect the per-draw seeding removes); a counter-based Philox would
    recover ~25% at the price of re-rolling every host-path decision."""
    B = max(64, int(cfg.perm_batch))
    seedval = 0 if seed is None else int(seed)

    def live(it):
        return it.decision is None and it.done < cfg.nperm

    while any(live(it) for it in chunk):
        active = [s for s, it in enumerate(chunk) if live(it)]
        remaining = [cfg.nperm - chunk[s].done for s in active]
        counts = _alloc_rows(B, active, remaining)
        w_rows = np.zeros((B, n_pad), dtype=dtype)
        wx_rows = np.zeros((B, n_pad), dtype=dtype)
        n_rows = np.zeros(B, dtype=np.int32)
        row_seg = np.full(B, -1, dtype=np.int64)
        r = 0
        for pos, s in enumerate(active):
            it = chunk[s]
            x, w = jobs[it.ji]
            ww = w[it.lo : it.hi]
            wx = ww * x[it.lo : it.hi]
            k = counts[pos]
            if not k:
                continue
            order = np.stack(
                [
                    np.random.default_rng(
                        [seedval, salts[it.ji], it.lo, it.hi, it.done + j]
                    ).permutation(it.n)
                    for j in range(k)
                ]
            )
            w_rows[r : r + k, : it.n] = ww[order]
            wx_rows[r : r + k, : it.n] = wx[order]
            n_rows[r : r + k] = it.n
            row_seg[r : r + k] = s
            r += k
        best = np.asarray(
            _max_t_rows(
                jnp.asarray(w_rows), jnp.asarray(wx_rows),
                jnp.asarray(n_rows), lengths, cfg.min_width, cfg.kmax,
            )
        )
        for pos, s in enumerate(active):
            it = chunk[s]
            sel = row_seg == s
            it.exceed += int(np.sum(best[sel] >= obs[id(it)]))
            it.done += counts[pos]
            if it.exceed >= it.max_ones:
                it.decision = False
            elif it.done >= cfg.nperm:
                it.decision = True
    for it in chunk:
        if it.decision is None:
            it.decision = it.exceed < it.max_ones


def _chunks(seq, size):
    for a in range(0, len(seq), size):
        yield seq[a : a + size]


def _segment_jobs(jobs: list, cfg: CBSConfig) -> list:
    """Level-synchronous recursive CBS over many value vectors at once.

    ``jobs`` is a list of (x, w) float64 arrays — one per chromosome (and,
    in batch mode, per sample).  Returns per-job sorted lists of (lo, hi)
    half-open segment ranges.  All pending segments of a level are
    grouped by size bucket and decided by batched device programs — the
    round-trip count is per *level x bucket*, not per segment
    (round-2 profile: 1429 dispatches, ~190 ms each, for one genome).

    Permutation streams are keyed per segment by (cfg.seed, content salt,
    lo, hi, draw index): results for one job are identical however the
    jobs are batched (solo, plate, multi-host shard).
    """
    on_device = on_accelerator()
    dtype = np.float64  # downcast to f32 happens on device transfer
    seed = cfg.seed
    salts = [_job_salt(x, w) for x, w in jobs]
    results = [[] for _ in jobs]
    pending = [
        _Item(ji, 0, len(x)) for ji, (x, w) in enumerate(jobs) if len(x)
    ]
    n_tested = 0

    while pending:
        testable = []
        for it in pending:
            if it.n < 2 * cfg.min_width:
                results[it.ji].append((it.lo, it.hi))
            else:
                testable.append(it)
        if not testable:
            break
        n_tested += len(testable)

        # Group by (bucket, family mode); modes never mix within a bucket
        # under a fixed exact_max, but a config change keeps them distinct.
        groups: dict = {}
        for it in testable:
            n_pad = _bucket(it.n)
            if it.n <= cfg.exact_max:
                mode = "exact"
            elif cfg.p_method == "hybrid":
                mode = "short"
            else:
                mode = "thin"
            groups.setdefault((n_pad, mode), []).append(it)

        for (n_pad, mode), items in sorted(groups.items(), reverse=True):
            _decide_group(
                items, jobs, salts, n_pad, mode, cfg, seed, on_device,
                dtype,
            )

        # Locate accepted splits with the exact scan, batched per bucket.
        accepted = [it for it in testable if it.decision]
        by_pad: dict = {}
        for it in accepted:
            by_pad.setdefault(_bucket(it.n), []).append(it)
        for n_pad, items in sorted(by_pad.items(), reverse=True):
            for chunk in _chunks(items, cfg.seg_batch):
                w_seg, wx_seg, n_seg = _seg_tables(
                    chunk, jobs, n_pad, dtype, cfg.seg_batch
                )
                i_star, l_star = _locate_batch(
                    jnp.asarray(w_seg), jnp.asarray(wx_seg),
                    jnp.asarray(n_seg), cfg.min_width,
                )
                i_star = np.asarray(i_star)
                l_star = np.asarray(l_star)
                for s, it in enumerate(chunk):
                    it.split = (int(i_star[s]), int(i_star[s] + l_star[s]))
                    # Degenerate locate (no valid arc found) — treat as
                    # no-split rather than recurse on an identical child.
                    if it.split[1] <= it.split[0]:
                        it.decision = False

        nxt = []
        for it in testable:
            if not it.decision:
                results[it.ji].append((it.lo, it.hi))
                continue
            i, j = it.split
            for a, b in (
                (it.lo, it.lo + i),
                (it.lo + i, it.lo + j),
                (it.lo + j, it.hi),
            ):
                if b > a:
                    nxt.append(_Item(it.ji, a, b))
        pending = nxt

    if cfg.t_threshold is None and n_tested:
        logging.info(
            "CBS: %d segment tests decided by the %s permutation loop",
            n_tested, "device" if on_device else "host",
        )
    return [sorted(r) for r in results]


def _segment_values(x, w, cfg: CBSConfig, chrom_seed=()):
    """Recursive CBS over one chromosome's non-NA values (thin wrapper
    over the batched engine; kept as the unit-test surface).

    ``chrom_seed`` is accepted for API compatibility but unused: streams
    are keyed by data content now (see :func:`_job_salt`), so a job's
    segmentation no longer depends on any caller-supplied position salt.

    Returns a sorted list of (lo, hi) half-open index ranges.
    """
    del chrom_seed
    return _segment_jobs(
        [(np.asarray(x, np.float64), np.asarray(w, np.float64))], cfg
    )[0]


# ---------------------------------------------------------------------------
# Full CBS.R-equivalent driver
# ---------------------------------------------------------------------------


def _prepare_chromosome(results_r, results_w, c):
    """CBS.R:41-63 prep: blacklist->NA, zero weights->1.0, drop all-NA.

    Returns (y, w, pos, yv, wv) or None for an all-NA chromosome.
    """
    y = np.asarray(results_r[c], dtype=np.float64).copy()
    w = np.asarray(results_w[c], dtype=np.float64).copy()
    y[y == 0] = np.nan  # blacklist -> NA (CBS.R:41)
    w[w == 0] = 1.0  # CBS.R:42's 1^-99 == 1.0
    keep = ~np.isnan(y)
    if not keep.any():
        return None  # all-NA chromosome dropped (CBS.R:56-63)
    pos = np.nonzero(keep)[0]  # 0-based original bin positions
    return y, w, pos, y[keep], w[keep]


def exec_cbs(
    results_r: list,
    results_w: list,
    ref_gender: str,
    binsize: int,
    cfg: CBSConfig = CBSConfig(),
) -> list:
    """Segment the per-chromosome log2 ratios.

    Returns rows ``[chr0, start, end, ratio]`` with 0-based half-open bin
    ranges per chromosome and 4-decimal ratios, matching what the reference
    reads back from CBS.R via JSON (predict_tools.py:266-275).
    """
    return exec_cbs_batch(
        [(results_r, results_w, ref_gender, binsize)], cfg
    )[0]


def exec_cbs_batch(samples: list, cfg: CBSConfig = CBSConfig()) -> list:
    """Segment many samples' genomes in one engine run.

    ``samples`` is a list of (results_r, results_w, ref_gender, binsize)
    tuples.  Every pending segment of every sample joins the same
    level-synchronous batches, so a plate of samples costs barely more
    round trips than one — the production path behind ``predict-batch``.
    Returns one ``exec_cbs``-format row list per sample.
    """
    jobs = []
    meta = []  # (sample idx, chr, y, w, pos)
    for si, (results_r, results_w, ref_gender, binsize) in enumerate(
        samples
    ):
        n_chr = 24 if ref_gender == "M" else 23
        for c in range(n_chr):
            prep = _prepare_chromosome(results_r, results_w, c)
            if prep is None:
                continue
            y, w, pos, yv, wv = prep
            jobs.append((yv, wv))
            meta.append((si, c, y, w, pos, binsize))

    all_segments = _segment_jobs(jobs, cfg)

    out = [[] for _ in samples]
    for (si, c, y, w, pos, binsize), segments in zip(meta, all_segments):
        na_run_threshold = int(2e6 / binsize)  # CBS.R:95
        for lo, hi in segments:
            # DNAcopy endpoints: 1-based inclusive positions of the first
            # and last non-NA bin of the segment.
            s1 = int(pos[lo]) + 1
            e1 = int(pos[hi - 1]) + 1
            out[si].extend(
                _postprocess_segment(c, s1, e1, y, w, na_run_threshold)
            )
    return out


def _postprocess_segment(c, s1, e1, y, w, thresh):
    """NA-run splitting + weighted-mean recompute (CBS.R:82-130).

    ``s1``/``e1`` are 1-based inclusive positions on the full chromosome.
    """
    seg = y[s1 - 1 : e1]  # R's y[start.i:end.i]
    isna = np.isnan(seg).astype(np.int64)
    diff = np.diff(isna)
    start_pos = np.nonzero(diff == 1)[0] + s1  # last non-NA before each run
    end_pos = np.nonzero(diff == -1)[0] + s1  # last NA of each run
    sel = (end_pos - start_pos) > thresh
    start_pos = start_pos[sel]
    end_pos = end_pos[sel]

    inv_start = np.concatenate([[s1], end_pos])
    inv_end = np.concatenate([start_pos, [e1]])
    sel2 = (inv_end - inv_start) > 0  # pieces must be >= 2 bins (CBS.R:103)
    if not sel2.any():
        return []
    inv_start = inv_start[sel2]
    inv_end = inv_end[sel2]

    rows = []
    for s, e in zip(inv_start, inv_end):
        yy = y[s - 1 : e]
        ww = w[s - 1 : e]
        ok = ~np.isnan(yy)
        if ok.any():
            r = float(np.sum(yy[ok] * ww[ok]) / np.sum(ww[ok]))
        else:
            r = float("nan")
        # jsonlite::write_json digits=4 — the rounding the reference's
        # downstream silently inherits.
        rows.append([c, int(s) - 1, int(e), round(r, 4)])
    return rows
