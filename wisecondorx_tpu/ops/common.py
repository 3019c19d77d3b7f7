"""Masked reductions used across the pipeline.

The reference repeatedly takes mean / std / median over *variable-size*
subsets selected by boolean conditions inside Python loops (e.g.
predict_tools.py:132-140).  Dynamic shapes are not jittable, so each
reduction here works on fixed-shape arrays plus a validity mask; the invalid
lanes are neutralized and empty selections yield NaN exactly like numpy's
reductions over empty arrays do.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: Explicit matmul precision for every device matmul in the pipeline.  On
#: an NVIDIA H100 the default f32 matmul may run on the tensor cores in
#: TF32 (10 mantissa bits) — catastrophic for squared-distance and Gram
#: computations whose answers live many decades below the operand norms.
#: HIGHEST keeps strict f32 arithmetic (no TF32); on CPU (the f64 parity
#: path) it is a no-op.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def masked_mean(x, valid, axis=-1):
    """Mean over ``valid`` lanes; NaN where no lane is valid (np.mean([]))."""
    n = jnp.sum(valid, axis=axis)
    s = jnp.sum(jnp.where(valid, x, 0.0), axis=axis)
    return s / n  # 0/0 -> NaN, matching np.mean of an empty slice


def masked_std(x, valid, axis=-1):
    """Population std (ddof=0, np.std default) over valid lanes; NaN if empty."""
    n = jnp.sum(valid, axis=axis)
    mean = masked_mean(x, valid, axis=axis)
    d = jnp.where(valid, x - jnp.expand_dims(mean, axis), 0.0)
    return jnp.sqrt(jnp.sum(d * d, axis=axis) / n)


def masked_median(x, valid, axis=-1):
    """Median over valid lanes (np.median semantics); NaN if empty.

    f32 uses an exact sort-free radix bisection (:func:`_median_bits_f32`);
    wider dtypes (the f64 CPU parity path) sort with invalid lanes pushed
    to +inf and average the two middle order statistics of the valid
    prefix.  Both forms return the exact attained order statistics, so
    results are identical; whether the bisection still beats a sort on
    the device is an open measurement (ROADMAP D5).
    """
    x = jnp.asarray(x)
    if x.dtype == jnp.float32:
        return _median_bits_f32(x, valid, axis)
    big = jnp.where(valid, x, jnp.inf)
    s = jnp.sort(big, axis=axis)
    n = jnp.sum(valid, axis=axis)
    k = x.shape[axis]
    lo_idx = jnp.clip((n - 1) // 2, 0, k - 1)
    hi_idx = jnp.clip(n // 2, 0, k - 1)
    lo = jnp.take_along_axis(s, jnp.expand_dims(lo_idx, axis), axis=axis)
    hi = jnp.take_along_axis(s, jnp.expand_dims(hi_idx, axis), axis=axis)
    med = jnp.squeeze((lo + hi) * 0.5, axis=axis)
    return jnp.where(n > 0, med, jnp.nan)


def _median_bits_f32(x, valid, axis=-1):
    """Exact median of the valid lanes via 32-step binary search over the
    order-preserving u32 encoding of f32 — no sort, no gather; compiles
    to a tiny fori_loop of elementwise counting passes.

    Finds the two middle order statistics (the smallest attained values u
    with rank >= (n-1)//2 and >= n//2) and averages them, exactly like
    np.median of the valid subset.
    """
    if axis != -1 and axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
        valid = jnp.moveaxis(valid, axis, -1)
    u = _ordered_u32(x)
    # Invalid lanes become the maximum key (above every finite value).
    u = jnp.where(valid, u, jnp.uint32(0xFFFFFFFF))
    n = jnp.sum(valid, axis=-1)
    k1 = jnp.maximum(n - 1, 0) // 2  # 0-based ranks of the two middles
    k2 = n // 2

    def order_stat(rank):
        # Smallest attained u whose count(u' <= u) > rank, built by
        # binary search on the u32 value range.
        lo = jnp.zeros(n.shape, jnp.uint32)
        hi = jnp.full(n.shape, 0xFFFFFFFF, jnp.uint32)

        def body(_, lohi):
            lo, hi = lohi
            mid = lo + ((hi - lo) >> 1)
            cnt = jnp.sum(u <= mid[..., None], axis=-1)
            go_left = cnt > rank
            return jnp.where(go_left, lo, mid + 1), jnp.where(
                go_left, mid, hi
            )

        lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
        return hi

    m1 = _ordered_u32_inv(order_stat(k1))
    m2 = _ordered_u32_inv(order_stat(k2))
    med = (m1 + m2) * 0.5
    return jnp.where(n > 0, med, jnp.nan)


def _ordered_u32(x):
    """Bitcast f32 -> u32 such that the u32 order matches the float order
    (negatives flipped entirely, positives offset past them)."""
    b = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return jnp.where(
        (b >> 31) == 1, ~b, b | jnp.uint32(0x80000000)
    )


def _ordered_u32_inv(u):
    b = jnp.where(
        (u >> 31) == 1, u & jnp.uint32(0x7FFFFFFF), ~u
    )
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def median_1d(x):
    """Plain median of a 1-D array (all lanes valid)."""
    return masked_median(x, jnp.ones(x.shape, dtype=bool))
