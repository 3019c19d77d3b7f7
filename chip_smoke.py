#!/usr/bin/env python3
"""End-to-end smoke test of the device path on NVIDIA GPUs.

Drives the normal CLI (``python -m wisecondorx_tpu.cli``) at the upstream
defaults on a synthetic cohort at data scale: 200 control samples
(100 F / 100 M) converted at 5 kb and built into a 100 kb reference with
refsize 300, plus three test samples (a trisomy-21 female, a male with
three planted CNVs, and an unaffected female).  ``convert`` has no device
work and is not run; the cohort is written straight in convert's npz
format and cached under ``.chip_smoke/`` in the checkout.

Phases (each one CLI subprocess; this process never imports JAX, so only
one process holds a card at a time):

1. ``newref`` on the GPU (``JAX_PLATFORMS=cuda``: no silent CPU fallback).
2. ``newref`` on the CPU in float64 — the plain reference — compared pass
   by pass: masks, neighbour sets, shared-neighbour distances, null ratios.
3. ``predict --bed`` for each test sample on the GPU and on the CPU in
   float64 against the GPU-built reference: per-bin ratios, and the planted
   aberrations called on both.
4. ``predict-batch --bed`` on the GPU over the 3 test samples + 5 controls;
   every sample's files must equal its solo GPU ``predict`` byte for byte.

``--four-cards`` runs only the multi-device path: ``newref`` and
``predict-batch`` on four cards against one card (``CUDA_VISIBLE_DEVICES=0``),
requiring identical KNN indexes/distances and identical batch outputs.

The last stdout line is ``{"ok": true, "device": {...}}`` with the device
as JAX reports it; any failed phase exits non-zero without that line, as
does a machine where JAX finds no GPU.

Usage: python3 chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")

N_CONTROLS = 200
GENOME_SCALE = 1.0
CONVERT_BINSIZE = 5000
REF_BINSIZE = 100000
# Planted CNVs of the "cnv" test sample: (chr, start bp, end bp, copies).
PLANTED = [
    (2, 50_000_000, 56_000_000, 3.0),  # 6 Mb gain
    (5, 80_000_000, 86_000_000, 1.0),  # 6 Mb loss
    (12, 30_000_000, 32_000_000, 3.0),  # 2 Mb gain
]
TESTS = ("t21", "cnv", "normal")

# Tolerances (each reported beside its measured value).
NEIGHBOUR_MEAN_MIN = 0.999
NEIGHBOUR_ROW_MIN = 0.99
DIST_REL_MAX = 1e-4
NULL_ABS_TOL = 1e-3  # on the 99.9th percentile of |null ratio difference|
RATIO_ABS_TOL = 1e-4
RATIO_FRACTION_MIN = 0.999

BACKEND_RE = re.compile(
    r"JAX backend: (\S+), device_kind=(.*), devices=(\d+)"
)
TIMING_RE = re.compile(r"\[timing\] (\S+): ([0-9.]+)s")


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Log parsing and comparisons (numpy only; unit-tested on the CPU)
# ---------------------------------------------------------------------------


def parse_backend(log: str):
    """(platform, device_kind, count) from the CLI's start-up line."""
    m = BACKEND_RE.search(log)
    if m is None:
        return None
    return m.group(1), m.group(2).strip(), int(m.group(3))


def parse_timings(log: str) -> dict:
    out: dict = {}
    for name, secs in TIMING_RE.findall(log):
        out[name] = out.get(name, 0.0) + float(secs)
    return out


def neighbour_agreement(idx_a, idx_b) -> np.ndarray:
    """Per-row fraction of neighbours (ignoring -1 slots) both tables
    share; rows without neighbours in either table count as 1."""
    out = np.ones(idx_a.shape[0])
    for r in range(idx_a.shape[0]):
        a = idx_a[r][idx_a[r] >= 0]
        b = idx_b[r][idx_b[r] >= 0]
        k = max(a.size, b.size)
        if k:
            out[r] = np.intersect1d(a, b).size / k
    return out


def shared_distance_rel_err(idx_a, dist_a, idx_b, dist_b) -> float:
    """Largest relative difference of the distance of a neighbour found
    by both tables."""
    worst = 0.0
    for r in range(idx_a.shape[0]):
        _, ia, ib = np.intersect1d(
            idx_a[r], idx_b[r], assume_unique=False, return_indices=True
        )
        keep = idx_a[r][ia] >= 0
        if not keep.any():
            continue
        da = dist_a[r][ia[keep]].astype(np.float64)
        db = dist_b[r][ib[keep]].astype(np.float64)
        rel = np.abs(da - db) / np.maximum(np.abs(db), 1e-300)
        worst = max(worst, float(rel.max()))
    return worst


def null_ratio_diff(null_a, null_b):
    """(99.9th percentile, max) of |a - b| over entries finite in both,
    and whether the finite patterns agree."""
    a = np.asarray(null_a, np.float64)
    b = np.asarray(null_b, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    d = np.abs(a[both] - b[both])
    if d.size == 0:
        return 0.0, 0.0, bool(np.array_equal(fa, fb))
    return (
        float(np.quantile(d, 0.999)),
        float(d.max()),
        bool(np.array_equal(fa, fb)),
    )


def compare_references(ref_dev: dict, ref_cpu: dict) -> dict:
    """Pass-by-pass comparison of a device-built reference against the
    float64 CPU one; returns metrics per pass ("A", "F", "M")."""
    out = {}
    for gender in ("A", "F", "M"):
        sfx = "" if gender == "A" else f".{gender}"
        if f"indexes{sfx}" not in ref_cpu:
            continue
        if f"indexes{sfx}" not in ref_dev:
            raise SmokeFailure(f"device reference lacks pass {gender}")
        m = {}
        mask_d = np.asarray(ref_dev[f"mask{sfx}"], bool)
        mask_c = np.asarray(ref_cpu[f"mask{sfx}"], bool)
        m["mask_bins_differing"] = int(np.sum(mask_d != mask_c))
        if m["mask_bins_differing"]:
            out[gender] = m
            continue
        idx_d, idx_c = ref_dev[f"indexes{sfx}"], ref_cpu[f"indexes{sfx}"]
        r0 = 0
        if gender != "A":
            r0 = int(np.asarray(ref_cpu[f"masked_bins_per_chr_cum{sfx}"])[21])
        agree = neighbour_agreement(idx_d[r0:], idx_c[r0:])
        m["rows"] = int(agree.size)
        m["neighbour_mean"] = float(agree.mean()) if agree.size else 1.0
        m["neighbour_min"] = float(agree.min()) if agree.size else 1.0
        m["dist_rel_max"] = shared_distance_rel_err(
            idx_d[r0:], ref_dev[f"distances{sfx}"][r0:],
            idx_c[r0:], ref_cpu[f"distances{sfx}"][r0:],
        )
        q, mx, same = null_ratio_diff(
            ref_dev[f"null_ratios{sfx}"], ref_cpu[f"null_ratios{sfx}"]
        )
        m["null_abs_q999"] = q
        m["null_abs_max"] = mx
        m["null_finite_pattern_equal"] = same
        out[gender] = m
    return out


def reference_failures(metrics: dict) -> list:
    """Tolerance violations in :func:`compare_references` output.  The A
    pass carries the neighbour-agreement bar; every pass must keep its
    mask and its shared-neighbour distances and null ratios."""
    bad = []
    for gender, m in metrics.items():
        if m["mask_bins_differing"]:
            bad.append(f"{gender}: {m['mask_bins_differing']} mask bins differ")
            continue
        if gender == "A" and m["neighbour_mean"] < NEIGHBOUR_MEAN_MIN:
            bad.append(f"A: mean neighbour agreement {m['neighbour_mean']}")
        if gender == "A" and m["neighbour_min"] < NEIGHBOUR_ROW_MIN:
            bad.append(f"A: min neighbour agreement {m['neighbour_min']}")
        if m["dist_rel_max"] > DIST_REL_MAX:
            bad.append(f"{gender}: shared distance rel err {m['dist_rel_max']}")
        if m["null_abs_q999"] > NULL_ABS_TOL:
            bad.append(f"{gender}: null ratio |diff| q99.9 {m['null_abs_q999']}")
        if not m["null_finite_pattern_equal"]:
            bad.append(f"{gender}: null ratio finite patterns differ")
    return bad


def read_bins_ratios(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        next(f)
        for line in f:
            vals.append(float(line.rstrip("\n").split("\t")[4]))
    return np.asarray(vals)


def ratio_agreement(bins_a: np.ndarray, bins_b: np.ndarray, tol: float):
    """Fraction of bins whose ratios agree within ``tol`` (both NaN counts
    as agreement), and the largest finite difference."""
    if bins_a.shape != bins_b.shape:
        return 0.0, float("inf")
    both_nan = np.isnan(bins_a) & np.isnan(bins_b)
    diff = np.abs(bins_a - bins_b)
    ok = both_nan | (diff <= tol + 1e-12)
    finite = np.isfinite(diff)
    return float(ok.mean()), float(diff[finite].max()) if finite.any() else 0.0


def read_aberrations(path: str) -> list:
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            c, s, e, _, _, kind = line.rstrip("\n").split("\t")
            rows.append((c, int(s), int(e), kind))
    return rows


def is_called(rows: list, chrom: str, start: int, end: int, kind: str):
    """True when an aberration of ``kind`` on ``chrom`` covers at least
    half of [start, end)."""
    covered = 0
    for c, s, e, k in rows:
        if c == chrom and k == kind:
            covered += max(0, min(e, end) - max(s - 1, start))
    return covered >= 0.5 * (end - start)


def expected_calls(name: str, chr21_len: int) -> list:
    if name == "t21":
        return [("21", 0, chr21_len, "gain")]
    if name == "cnv":
        return [
            (str(c), s, e, "gain" if cp > 2 else "loss")
            for c, s, e, cp in PLANTED
        ]
    return []


OUTPUT_SUFFIXES = ("_bins.bed", "_segments.bed", "_aberrations.bed",
                   "_statistics.txt")


def outputs_identical(prefix_a: str, prefix_b: str) -> list:
    """Output files of two predict runs that differ (by bytes)."""
    bad = []
    for sfx in OUTPUT_SUFFIXES:
        with open(prefix_a + sfx, "rb") as fa, open(prefix_b + sfx, "rb") as fb:
            if fa.read() != fb.read():
                bad.append(sfx)
    return bad


# ---------------------------------------------------------------------------
# Cohort and CLI runs
# ---------------------------------------------------------------------------


def build_cohort(seed: int):
    """Controls + test samples as convert-format npz, cached per seed."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    from synthetic import CohortSim

    from wisecondorx_tpu.io.npz import save_sample_npz

    root = os.path.join(
        WORK, f"cohort_b{CONVERT_BINSIZE}_g{GENOME_SCALE:g}_n{N_CONTROLS}_s{seed}"
    )
    controls = [os.path.join(root, f"ctrl{i:03d}.npz") for i in range(N_CONTROLS)]
    tests = {name: os.path.join(root, f"test_{name}.npz") for name in TESTS}
    sim = CohortSim(
        binsize=CONVERT_BINSIZE, genome_scale=GENOME_SCALE, seed=seed
    )
    chr21_len = int(sim.bins[20]) * CONVERT_BINSIZE
    if os.path.exists(os.path.join(root, ".complete")):
        return controls, tests, chr21_len
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    qual = {"filter_rmdup": 0, "filter_mapq": 0, "pre_retro": 0,
            "post_retro": 0}
    jobs = [(p, sim.sample("F" if i < N_CONTROLS // 2 else "M"))
            for i, p in enumerate(controls)]
    n21 = int(sim.bins[20])
    cnvs = [(c, s // CONVERT_BINSIZE, e // CONVERT_BINSIZE, cp)
            for c, s, e, cp in PLANTED]
    jobs.append((tests["t21"], sim.sample("F", cnvs=[(21, 0, n21, 3.0)])))
    jobs.append((tests["cnv"], sim.sample("M", cnvs=cnvs)))
    jobs.append((tests["normal"], sim.sample("F")))
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(
            lambda j: save_sample_npz(j[0], CONVERT_BINSIZE, j[1], qual), jobs
        ))
    with open(os.path.join(root, ".complete"), "w") as f:
        f.write("ok")
    say(f"cohort: {len(jobs)} samples written in "
        f"{time.perf_counter() - t0:.1f} s -> {root}")
    return controls, tests, chr21_len


class CliRun:
    """One CLI subprocess with its log in ``logdir/<tag>.log``.

    CPU-only runs may go on in the background while a GPU run holds the
    card; :meth:`finish` waits, then fails when the command failed or ran
    on another backend than expected."""

    def __init__(self, tag: str, args: list, env_extra: dict, logdir: str):
        env = dict(os.environ)
        env.update(env_extra)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.tag = tag
        self.log_path = os.path.join(logdir, f"{tag}.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.t_end = None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "wisecondorx_tpu.cli", *args],
            env=env, stdout=subprocess.DEVNULL, stderr=self._log, cwd=REPO,
        )
        RUNNING.append(self)
        # Records the exit time of a run that finishes in the background.
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        self.proc.wait()
        self.t_end = time.perf_counter()

    def finish(self, timeout: float, expect_platform: str):
        """Wait; returns (wall s, log text, backend tuple)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{self.tag}: timed out after {timeout:.0f} s")
        finally:
            self._log.close()
        while self.t_end is None:  # the watcher records the exit time
            time.sleep(0.01)
        wall = self.t_end - self.t0
        RUNNING.remove(self)
        with open(self.log_path) as f:
            log = f.read()
        if rc != 0:
            tail = "\n".join(log.strip().splitlines()[-15:])
            raise SmokeFailure(f"{self.tag}: exit {rc}\n{tail}")
        backend = parse_backend(log)
        if backend is None or backend[0] != expect_platform:
            raise SmokeFailure(
                f"{self.tag}: ran on backend {backend}, expected "
                f"{expect_platform}"
            )
        stages = parse_timings(log)
        say(f"[{self.tag}] wall {wall:.3f} s on {backend[0]} ({backend[1]}) "
            f"x{backend[2]}")
        if stages:
            say(f"[{self.tag}] stages " + json.dumps(
                {k: round(v, 3) for k, v in stages.items()}
            ))
        return wall, log, backend


#: Subprocesses not yet finished; killed if the smoke test fails.
RUNNING: list = []


def run_cli(tag, args, env_extra, timeout, expect_platform, logdir):
    """Run one CLI subprocess to its end (see :class:`CliRun`)."""
    return CliRun(tag, args, env_extra, logdir).finish(
        timeout, expect_platform
    )


GPU = {"JAX_PLATFORMS": "cuda"}
GPU_PLATFORM = "gpu"
ONE_CARD = {"CUDA_VISIBLE_DEVICES": "0"}
CPU64 = {"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1"}
DEVICE_LOOP_LOG = "decided by the device permutation loop"


def probe_gpu() -> None:
    """Fail fast (before any cohort work) where JAX finds no GPU."""
    env = dict(os.environ, **GPU)
    try:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import jax; d = jax.devices(); print(d[0].platform, len(d))"],
            env=env, capture_output=True, text=True, timeout=300,
        )
    except subprocess.TimeoutExpired:
        raise SmokeFailure("GPU probe timed out")
    if proc.returncode != 0 or not proc.stdout.startswith("gpu"):
        raise SmokeFailure(
            "JAX finds no GPU: "
            + (proc.stderr.strip().splitlines() or ["?"])[-1]
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        say(f"card: {line.strip()}")


def load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def newref_args(controls: list, out: str) -> list:
    return ["newref", *controls, out, "--binsize", str(REF_BINSIZE),
            "--refsize", "300"]


def smoke_one_card(controls, tests, chr21_len, run_dir) -> tuple:
    """Phases 1-4.  The float64 CPU runs (the plain reference) go on in
    the background while the GPU runs take turns on the card, so the
    GPU phases' walls here include competition for host cores."""
    ref_gpu = os.path.join(run_dir, "ref_gpu.npz")
    ref_cpu = os.path.join(run_dir, "ref_cpu.npz")

    cpu_newref = CliRun("newref_cpu_f64", newref_args(controls, ref_cpu),
                        CPU64, run_dir)
    # Phase 1: newref on the GPU.
    _, _, backend = run_cli("newref_gpu", newref_args(controls, ref_gpu),
                            GPU, 600, GPU_PLATFORM, run_dir)
    cpu_predicts = {
        name: CliRun(
            f"predict_cpu_{name}",
            ["predict", tests[name], ref_gpu,
             os.path.join(run_dir, "cpu", name), "--bed"],
            CPU64, run_dir,
        )
        for name in TESTS
    }

    # Phase 3, GPU side; phase 4's solo runs for the plate's controls.
    plate = [tests[n] for n in TESTS] + controls[:3] + controls[-2:]
    for path in plate:
        base = os.path.basename(path)[:-4]
        name = base[5:] if base.startswith("test_") else base
        _, log_g, _ = run_cli(
            f"predict_gpu_{name}",
            ["predict", path, ref_gpu, os.path.join(run_dir, "gpu", name),
             "--bed"],
            GPU, 300, GPU_PLATFORM, run_dir,
        )
        if DEVICE_LOOP_LOG not in log_g:
            raise SmokeFailure(
                f"predict_gpu_{name}: CBS did not run the device loop"
            )

    # Phase 4: predict-batch on the plate, equal to solo GPU predict.
    batch_dir = os.path.join(run_dir, "batch")
    run_cli("predict_batch_gpu",
            ["predict-batch", ref_gpu, batch_dir, "--bed", "--infiles", *plate],
            GPU, 600, GPU_PLATFORM, run_dir)
    for path in plate:
        base = os.path.basename(path)[:-4]
        solo = os.path.join(
            run_dir, "gpu", base[5:] if base.startswith("test_") else base
        )
        diff = outputs_identical(os.path.join(batch_dir, base), solo)
        if diff:
            raise SmokeFailure(f"predict-batch {base} differs from solo: {diff}")
    say(f"[predict-batch] {len(plate)} samples byte-identical to solo predict")

    # Phase 2: the float64 CPU reference build, compared pass by pass.
    cpu_newref.finish(900, "cpu")
    metrics = compare_references(load_npz(ref_gpu), load_npz(ref_cpu))
    for gender, m in metrics.items():
        say(f"[newref compare {gender}] " + json.dumps(m))
    say(f"[newref tolerances] neighbour mean >= {NEIGHBOUR_MEAN_MIN}, "
        f"row min >= {NEIGHBOUR_ROW_MIN} (A pass); shared-neighbour "
        f"distance rel err <= {DIST_REL_MAX}; null ratio |diff| q99.9 <= "
        f"{NULL_ABS_TOL}; masks identical")
    bad = reference_failures(metrics)
    if bad:
        raise SmokeFailure("newref GPU vs CPU f64: " + "; ".join(bad))

    # Phase 3: GPU against CPU float64 predict on the GPU-built reference.
    calls_ok = []
    for name in TESTS:
        cpu_predicts[name].finish(900, "cpu")
        gpu_out = os.path.join(run_dir, "gpu", name)
        cpu_out = os.path.join(run_dir, "cpu", name)
        frac, worst = ratio_agreement(
            read_bins_ratios(gpu_out + "_bins.bed"),
            read_bins_ratios(cpu_out + "_bins.bed"),
            RATIO_ABS_TOL,
        )
        ab_g = read_aberrations(gpu_out + "_aberrations.bed")
        ab_c = read_aberrations(cpu_out + "_aberrations.bed")
        with open(gpu_out + "_segments.bed") as fg, \
                open(cpu_out + "_segments.bed") as fc:
            same_segments = fg.read() == fc.read()
        say(f"[predict compare {name}] bins within {RATIO_ABS_TOL}: "
            f"{frac:.6f} (need >= {RATIO_FRACTION_MIN}), max |diff| "
            f"{worst:.3g}; aberrations gpu {len(ab_g)} cpu {len(ab_c)}; "
            f"segments equal: {same_segments}")
        if frac < RATIO_FRACTION_MIN:
            raise SmokeFailure(f"predict {name}: ratio agreement {frac}")
        for chrom, s, e, kind in expected_calls(name, chr21_len):
            for tag, rows in (("gpu", ab_g), ("cpu", ab_c)):
                if not is_called(rows, chrom, s, e, kind):
                    raise SmokeFailure(
                        f"predict {name} ({tag}): {kind} on chr{chrom}:"
                        f"{s}-{e} not called"
                    )
            calls_ok.append(f"{name}:chr{chrom}:{kind}")
    say(f"[predict calls] found on both backends: {calls_ok}")
    return backend


def smoke_four_cards(controls, run_dir) -> tuple:
    one = {**GPU, **ONE_CARD}
    ref1 = os.path.join(run_dir, "ref_1card.npz")
    ref4 = os.path.join(run_dir, "ref_4card.npz")
    run_cli("newref_1card", newref_args(controls, ref1), one, 600,
            GPU_PLATFORM, run_dir)
    _, _, backend = run_cli("newref_4card", newref_args(controls, ref4), GPU,
                            600, GPU_PLATFORM, run_dir)
    if backend[2] != 4:
        raise SmokeFailure(f"expected 4 devices, JAX reports {backend[2]}")
    r1, r4 = load_npz(ref1), load_npz(ref4)
    differing = {}
    for key in sorted(r1):
        if key.startswith(("indexes", "distances", "mask")):
            if r1[key].shape != r4[key].shape:
                differing[key] = "shape"
            elif not np.array_equal(r1[key], r4[key]):
                rows = np.any(r1[key] != r4[key], axis=-1) \
                    if r1[key].ndim > 1 else r1[key] != r4[key]
                differing[key] = f"{int(np.sum(rows))} rows"
    nulls = {k: null_ratio_diff(r1[k], r4[k])[1]
             for k in r1 if k.startswith("null_ratios")}
    say(f"[newref 4 vs 1 card] differing: {differing or 'none'} "
        f"(indexes, distances, masks); null ratio max |diff| {nulls}")
    plate = controls[:4] + controls[-4:]
    b1 = os.path.join(run_dir, "batch_1card")
    b4 = os.path.join(run_dir, "batch_4card")
    run_cli("predict_batch_1card",
            ["predict-batch", ref1, b1, "--bed", "--infiles", *plate],
            one, 600, GPU_PLATFORM, run_dir)
    run_cli("predict_batch_4card",
            ["predict-batch", ref1, b4, "--bed", "--infiles", *plate],
            GPU, 600, GPU_PLATFORM, run_dir)
    batch_diff = {}
    for path in plate:
        base = os.path.basename(path)[:-4]
        diff = outputs_identical(os.path.join(b1, base), os.path.join(b4, base))
        if diff:
            batch_diff[base] = diff
    say(f"[predict-batch 4 vs 1 card] {len(plate)} samples; differing: "
        f"{batch_diff or 'none'}")
    if differing or batch_diff:
        raise SmokeFailure(
            f"4 cards vs 1 card differ: newref {differing}, "
            f"predict-batch {batch_diff}"
        )
    return backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card vs 1-card comparison")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    for part in ("wisecondorx_tpu", "tests/synthetic.py"):
        if not os.path.exists(os.path.join(REPO, part)):
            say(f"FAIL: {part} not found next to chip_smoke.py")
            return 2
    t0 = time.perf_counter()
    try:
        probe_gpu()
        controls, tests, chr21_len = build_cohort(args.seed)
        run_dir = os.path.join(WORK, "run_4card" if args.four_cards else "run")
        shutil.rmtree(run_dir, ignore_errors=True)
        for sub in ("gpu", "cpu", "batch"):
            os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
        if args.four_cards:
            backend = smoke_four_cards(controls, run_dir)
        else:
            backend = smoke_one_card(controls, tests, chr21_len, run_dir)
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        return 1
    finally:
        for run in RUNNING:
            run.proc.kill()
            run.proc.wait()
    say(f"total wall {time.perf_counter() - t0:.1f} s")
    platform, kind, count = backend
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
