"""Micro-benchmark the CBS round's constituent ops on the device."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from wisecondorx_tpu.ops import cbs as cbs_ops  # noqa: E402
from wisecondorx_tpu.utils.device import setup_compile_cache  # noqa: E402


def bench(name, fn, *args, reps=3):
    out = jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    print(f"{name}: {dt*1000:.0f} ms", file=sys.stderr, flush=True)
    return out


def main():
    setup_compile_cache()
    for n_pad, B in ((16384, 4096), (2048, 16384)):
        print(f"--- n_pad={n_pad} B={B}", file=sys.stderr, flush=True)
        S = 32
        rng = np.random.default_rng(0)
        w_seg = jnp.asarray(rng.random((S, n_pad), dtype=np.float32) + 0.5)
        wx_seg = jnp.asarray(rng.random((S, n_pad), dtype=np.float32))
        n_seg = jnp.asarray(np.full(S, n_pad - 5, np.int32))
        seg_of_row = jnp.asarray(
            rng.integers(0, S, B).astype(np.int32)
        )
        key = jax.random.PRNGKey(0)

        bits = jax.jit(
            lambda k: jax.random.bits(k, (B, n_pad), dtype=jnp.uint32)
        )
        rnd = bench("random.bits", bits, key)

        gather = jax.jit(lambda s, i: jnp.take(s, i, axis=0))
        w_rows = bench("row gather", gather, w_seg, seg_of_row)
        wx_rows = gather(wx_seg, seg_of_row)

        shuf = jax.jit(cbs_ops._shuffle_rows)
        w_p, wx_p = bench("shuffle(sort)", shuf, rnd, w_rows, wx_rows)

        cs = jax.jit(lambda a: jnp.cumsum(a, axis=1))
        bench("cumsum", cs, w_p)

        lengths = jnp.asarray(
            cbs_ops._group_lengths(n_pad, cbs_ops.CBSConfig(), "thin")
        )
        n_rows = jnp.take(n_seg, seg_of_row)
        scan = jax.jit(
            lambda a, b, c, d: cbs_ops._max_t_rows_impl(
                a, b, c, d, 2, 25
            )
        )
        bench("maxt thin(256)", scan, w_p, wx_p, n_rows, lengths)

        full = jnp.arange(n_pad, dtype=jnp.int32)
        scan_s = jax.jit(
            lambda a, b, c, d: cbs_ops._max_t_rows_impl(
                a, b, c, d, 2, 25
            )
        )
        bench(
            "maxt full(S rows)", scan_s,
            w_seg, wx_seg, n_seg, full,
        )

        ri = jnp.asarray(np.zeros(B, np.int32))
        obs0 = jnp.asarray(np.zeros(w_seg.shape[0], np.float64))
        pr = jax.jit(
            lambda k, sl, rl: cbs_ops._perm_round_device(
                k, w_seg, wx_seg, n_seg, sl, rl, ri, ri, ri, ri,
                obs0, lengths, 2, 25,
            )
        )
        bench(
            "fused perm_round", pr, key, seg_of_row,
            jnp.asarray(np.ones(B, bool)),
        )


if __name__ == "__main__":
    main()
