#!/usr/bin/env python3
"""Focused reproduction of the calibration MISS cell
(n=2048, alpha=0.01, skewed 3-decade weights): is the elevated realized
level (a) seed-stable, (b) device-f32-specific (the CPU x64 host loop is
the f64 control), (c) dependent on the exact-family bucket boundary?

Usage:  python dev/cbs_miss_repro.py [--cpu] [--n 2048] [--seeds 3]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--nperm", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--weights", default="skewed",
                    choices=["skewed", "mild", "uniform"])
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from wisecondorx_tpu.utils.device import setup_compile_cache

    setup_compile_cache()

    from wisecondorx_tpu.ops.cbs import CBSConfig, _segment_jobs

    print(f"backend={jax.default_backend()} x64={args.x64} n={args.n} "
          f"alpha={args.alpha} w={args.weights}", file=sys.stderr)
    for s in range(args.seeds):
        rng = np.random.default_rng(1000 + s)
        jobs = []
        for _ in range(args.reps):
            y = rng.normal(0.0, 1.0, args.n)
            if args.weights == "skewed":
                w = 10.0 ** rng.uniform(-1.5, 1.5, args.n)
            elif args.weights == "mild":
                w = np.abs(rng.normal(1.0, 0.15, args.n)) + 1e-3
            else:
                w = np.ones(args.n)
            jobs.append((y, w))
        cfg = CBSConfig(alpha=args.alpha, nperm=args.nperm, seed=17 + s,
                        p_method="perm")
        t0 = time.perf_counter()
        res = _segment_jobs(jobs, cfg)
        rej = sum(len(r) > 1 for r in res)
        print(
            f"seed {s}: level={rej / args.reps:.4f} ({rej}/{args.reps}) "
            f"in {time.perf_counter() - t0:.0f}s",
            file=sys.stderr, flush=True,
        )


if __name__ == "__main__":
    main()
