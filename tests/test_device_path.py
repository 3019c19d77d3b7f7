"""The accelerator gate, the on-device CBS permutation loop, the compile
cache helper and the native table kernels — exercised on the CPU."""

import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from wisecondorx_tpu.ops import cbs as cbs_ops
from wisecondorx_tpu.utils import device as device_mod

# A small device round (256 rows at this bucket) keeps the CPU run short.
CFG = cbs_ops.CBSConfig(alpha=1e-3, nperm=2000, seed=0, row_elems=1 << 17)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _genome(values):
    rs = [np.asarray(values, dtype=float)] + [np.zeros(5)] * 22
    ws = [np.ones(len(values))] + [np.zeros(5)] * 22
    return rs, ws


def _step(seed=0):
    rng = np.random.default_rng(seed)
    y = np.concatenate([rng.normal(0, 0.08, 100), rng.normal(0.6, 0.08, 100)])
    y[y == 0] = 1e-9
    return y


@pytest.mark.parametrize(
    "backend,expected", [("gpu", "device"), ("cpu", "host")]
)
def test_accelerator_predicate_selects_perm_loop(
    monkeypatch, backend, expected
):
    calls = []
    for name in ("_perm_loop_device", "_perm_loop_host"):
        real = getattr(cbs_ops, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(cbs_ops, name, spy)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device_mod.on_accelerator() == (backend != "cpu")
    rs, ws = _genome(_step())
    cbs_ops.exec_cbs(rs, ws, "F", 100000, CFG)
    assert calls and set(calls) == {f"_perm_loop_{expected}"}


@pytest.mark.parametrize("planted", [True, False])
def test_device_perm_loop_decides_on_cpu(monkeypatch, planted):
    """The device loop (forced on the CPU backend) finds a planted step
    and leaves null data in one segment."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rng = np.random.default_rng(1)
    y = _step() if planted else rng.normal(0.01, 0.1, 200)
    rs, ws = _genome(y)
    segs = cbs_ops.exec_cbs(rs, ws, "F", 100000, CFG)
    if planted:
        assert len(segs) == 2
        assert abs(segs[0][2] - 100) <= 1
        assert abs(segs[1][3] - 0.6) < 0.05
    else:
        assert len(segs) == 1 and segs[0][1:3] == [0, 200]


_CACHE_PROBE = (
    "import jax, sys; sys.path.insert(0, {repo!r});"
    "from wisecondorx_tpu.utils.device import setup_compile_cache, CACHE_DIR;"
    "d = setup_compile_cache();"
    "print(d); print(jax.config.jax_compilation_cache_dir);"
    "print(CACHE_DIR)"
)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(tmp_path, env_set):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE.format(repo=REPO)],
        env=env, capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    returned, configured, default = out
    assert default == os.path.join(REPO, ".jax_cache")
    if env_set:
        assert returned == configured == str(tmp_path / "cache")
    else:
        assert returned == configured == default


def test_log_backend_names_the_device(caplog):
    with caplog.at_level(logging.INFO):
        device_mod.log_backend()
    msg = caplog.records[-1].getMessage()
    assert msg.startswith("JAX backend: cpu, device_kind=")
    assert msg.endswith(f"devices={len(jax.devices())}")


def test_native_table_kernels_resolve():
    """The library the package builds from the tracked sources exports
    the predict-side table kernels (otherwise the loader silently takes
    the numpy fallback)."""
    from wisecondorx_tpu.io.bam import _load_library

    lib = _load_library()
    for sym in ("wcx_sentinel_translate", "wcx_sentinel_translate_ok",
                "wcx_bam_open", "wcx_cram_open"):
        assert getattr(lib, sym) is not None


def test_plot_without_matplotlib_exits_cleanly(monkeypatch, caplog):
    import importlib.util

    from wisecondorx_tpu import cli

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "matplotlib" else real(name, *a),
    )
    with caplog.at_level(logging.CRITICAL), pytest.raises(SystemExit):
        cli._require_matplotlib("--plot")
    assert "needs matplotlib" in caplog.text


@pytest.mark.parametrize(
    "preset,expected",
    [
        ("", "--xla_gpu_autotune_level=0"),
        ("--xla_gpu_autotune_level=4", "--xla_gpu_autotune_level=4"),
    ],
)
def test_pin_autotuning(monkeypatch, preset, expected):
    """GPU kernel choice is pinned unless the user already chose a level;
    other flags are kept."""
    monkeypatch.setenv(
        "XLA_FLAGS", f"--xla_force_host_platform_device_count=8 {preset}"
    )
    device_mod.pin_autotuning()
    flags = os.environ["XLA_FLAGS"].split()
    assert "--xla_force_host_platform_device_count=8" in flags
    assert [f for f in flags if "autotune" in f] == [expected]
