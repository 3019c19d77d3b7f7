"""Profile full-genome CBS on the device (scratch, not shipped).

Counts dispatches and aggregates wall time per kernel family to decide
where the round-3 batching work should go.
"""

import collections
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from wisecondorx_tpu.ops import cbs as cbs_ops
    from wisecondorx_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    print("backend:", jax.default_backend(), file=sys.stderr)

    binsize = 15000
    chr_mbp = np.array(
        [248, 242, 198, 190, 181, 171, 159, 145, 138, 133, 135, 133, 114,
         107, 102, 90, 83, 80, 59, 64, 47, 51, 156], dtype=float)
    nbins = (chr_mbp * 1e6 / binsize).astype(int)
    rng = np.random.default_rng(7)

    results_r, results_w = [], []
    for c, n in enumerate(nbins):
        r = rng.normal(0.0, 0.08, n)
        # plant a few CNVs per chromosome to exercise accepted splits
        for _ in range(2):
            s = rng.integers(0, n - 500)
            ln = int(rng.integers(60, 400))
            r[s:s + ln] += rng.choice([-0.6, 0.58, -1.0, 0.4])
        # blacklist ~4% of bins (zeros -> NA)
        bl = rng.random(n) < 0.04
        r[bl] = 0.0
        results_r.append(r)
        results_w.append(np.abs(rng.normal(1.0, 0.1, n)))

    # instrument
    stats = collections.defaultdict(lambda: [0, 0.0])

    def wrap(name, fn, sync=True):
        def inner(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                jax.block_until_ready(out)
            stats[name][0] += 1
            stats[name][1] += time.perf_counter() - t
            return out
        return inner

    cbs_ops._perm_round_device = wrap(
        "perm_round", cbs_ops._perm_round_device
    )
    cbs_ops._max_t_rows = wrap("max_t", cbs_ops._max_t_rows)
    cbs_ops._locate_batch = wrap("locate", cbs_ops._locate_batch)

    t0 = time.perf_counter()
    rows = cbs_ops.exec_cbs(
        results_r, results_w, "F", binsize,
        cfg=cbs_ops.CBSConfig(nperm=10000),
    )
    wall = time.perf_counter() - t0
    print(f"full-genome CBS: {wall:.2f}s -> {len(rows)} segments",
          file=sys.stderr)
    for k, (cnt, tt) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
        print(f"  {k}: {cnt} dispatches, {tt:.2f}s "
              f"({tt/max(cnt,1)*1000:.0f} ms avg)", file=sys.stderr)


if __name__ == "__main__":
    main()
