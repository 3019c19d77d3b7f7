"""chip_smoke.py's log parsing and comparison functions on tiny inputs,
and its refusal to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

LOG = """[INFO - x]: JAX backend: gpu, device_kind=NVIDIA H100 80GB HBM3, devices=4
[INFO - x]: [timing] newref.pass_A.knn: 1.250s
[INFO - x]: [timing] newref.pass_A.knn: 0.750s
[INFO - x]: [timing] newref.write: 0.5s
"""


def test_log_parsing():
    assert cs.parse_backend(LOG) == ("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert cs.parse_backend("no backend line") is None
    assert cs.parse_timings(LOG) == {
        "newref.pass_A.knn": 2.0, "newref.write": 0.5
    }


def test_neighbour_agreement_and_distances():
    a = np.array([[1, 2, 3, 4], [5, 6, -1, -1], [-1, -1, -1, -1]])
    b = np.array([[4, 3, 2, 9], [6, 5, -1, -1], [-1, -1, -1, -1]])
    np.testing.assert_allclose(
        cs.neighbour_agreement(a, b), [0.75, 1.0, 1.0]
    )
    da = np.array([[1.0, 2.0, 3.0, 4.0], [1.0, 1.0, 1e10, 1e10],
                   [1e10] * 4])
    db = da.copy()
    db[0, 1] = 2.0 * (1 + 3e-5)  # index 2 of row 0, shared
    db[0, 0] = 99.0  # index 4 in b, slot 0: not the same neighbour slot
    err = cs.shared_distance_rel_err(a, da, b, db)
    # b's index 4 sits in slot 0 (99.0) while a's index 4 has 4.0.
    assert err == pytest.approx(abs(4.0 - 99.0) / 99.0)


def _ref(n=40, k=5, seed=0):
    rng = np.random.default_rng(seed)
    ref = {}
    for sfx in ("", ".F"):
        ref[f"mask{sfx}"] = np.ones(n + 4, bool)
        ref[f"indexes{sfx}"] = np.argsort(rng.random((n, n)), 1)[:, :k]
        ref[f"distances{sfx}"] = rng.random((n, k)) + 1.0
        ref[f"null_ratios{sfx}"] = rng.normal(0, 0.1, (n, 6))
        cum = np.arange(1, 25) * (n // 24)
        ref[f"masked_bins_per_chr_cum{sfx}"] = cum
    return ref


def test_compare_references_passes_on_equal_and_flags_differences():
    ref = _ref()
    metrics = cs.compare_references(ref, {k: v.copy() for k, v in ref.items()})
    assert set(metrics) == {"A", "F"}
    assert cs.reference_failures(metrics) == []
    assert metrics["A"]["neighbour_mean"] == 1.0
    assert metrics["F"]["rows"] == 40 - 22 * (40 // 24)

    bad = {k: v.copy() for k, v in ref.items()}
    bad["indexes"][3] = bad["indexes"][3] + 1000  # one row, no overlap
    bad["distances.F"] = bad["distances.F"] * (1 + 1e-3)
    bad["null_ratios"][0, 0] = np.nan
    fails = cs.reference_failures(cs.compare_references(bad, ref))
    text = " ".join(fails)
    assert "min neighbour agreement" in text
    assert "mean neighbour agreement" in text
    assert "F: shared distance rel err" in text
    assert "finite patterns differ" in text

    masked = {k: v.copy() for k, v in ref.items()}
    masked["mask"][0] = False
    assert "mask bins differ" in " ".join(
        cs.reference_failures(cs.compare_references(masked, ref))
    )


def test_bins_ratio_agreement(tmp_path):
    path = tmp_path / "x_bins.bed"
    path.write_text(
        "chr\tstart\tend\tid\tratio\tzscore\n"
        "1\t1\t10\t1:1-10\t0.5\t1.0\n"
        "1\t11\t20\t1:11-20\tnan\tnan\n"
        "1\t21\t30\t1:21-30\t-0.25\t2.0\n"
    )
    a = cs.read_bins_ratios(str(path))
    assert a.shape == (3,) and np.isnan(a[1])
    b = a.copy()
    b[2] += 5e-5
    assert cs.ratio_agreement(a, b, 1e-4)[0] == 1.0
    b[0] += 1e-3
    frac, worst = cs.ratio_agreement(a, b, 1e-4)
    assert frac == pytest.approx(2 / 3) and worst == pytest.approx(1e-3)
    assert cs.ratio_agreement(a, b[:2], 1e-4)[0] == 0.0


def test_aberration_calls(tmp_path):
    path = tmp_path / "x_aberrations.bed"
    path.write_text(
        "chr\tstart\tend\tratio\tzscore\ttype\n"
        "2\t50000001\t53000000\t0.55\t40.1\tgain\n"
        "2\t53000001\t56000000\t0.56\t41.0\tgain\n"
        "5\t80000001\t81000000\t-0.9\t-30\tloss\n"
    )
    rows = cs.read_aberrations(str(path))
    assert cs.is_called(rows, "2", 50_000_000, 56_000_000, "gain")
    assert not cs.is_called(rows, "2", 50_000_000, 56_000_000, "loss")
    # 1 of 6 Mb covered: not called.
    assert not cs.is_called(rows, "5", 80_000_000, 86_000_000, "loss")
    assert cs.expected_calls("t21", 46_000_000) == [
        ("21", 0, 46_000_000, "gain")
    ]
    assert [c[3] for c in cs.expected_calls("cnv", 0)] == [
        "gain", "loss", "gain"
    ]
    assert cs.expected_calls("normal", 0) == []


def test_outputs_identical(tmp_path):
    for prefix in ("a", "b"):
        for sfx in cs.OUTPUT_SUFFIXES:
            (tmp_path / f"{prefix}{sfx}").write_text("same\n")
    assert cs.outputs_identical(str(tmp_path / "a"), str(tmp_path / "b")) == []
    (tmp_path / "b_segments.bed").write_text("other\n")
    assert cs.outputs_identical(
        str(tmp_path / "a"), str(tmp_path / "b")
    ) == ["_segments.bed"]


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_gpu_or_repo(tmp_path, alone):
    """Without a GPU (this CPU host) or without the repo beside it, the
    script exits non-zero and prints no JSON result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, script], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
