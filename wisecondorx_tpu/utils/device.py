"""Backend queries and process-level JAX settings shared by every entry point.

* :func:`on_accelerator` is the one predicate every device-path gate reads:
  the device-resident newref prep, the device null-ratio table, and the
  on-device CBS permutation loop run whenever JAX's default backend is not
  the host CPU.
* :func:`setup_compile_cache` points JAX's persistent compilation cache at
  a fixed directory inside the checkout unless ``JAX_COMPILATION_CACHE_DIR``
  already names one, so a second cold process reuses the first one's
  executables.
* :func:`pin_autotuning` makes GPU compiles choose kernels without timing
  them, so every process and every card runs one program identically.
* :func:`log_backend` records which device a command actually ran on.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

#: Default persistent-cache directory: ``<checkout>/.jax_cache`` (derived
#: like io/bam.py's native directory; git-ignored).
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def on_accelerator() -> bool:
    """True when JAX's default backend is a device other than the host CPU."""
    import jax

    return jax.default_backend() != "cpu"


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    Must run before the first jit compile of the process.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
    else is configured here.  Otherwise the cache goes to
    :data:`CACHE_DIR`.  Every compiled program is cached (no minimum
    compile time), so a warm second process compiles nothing.
    """
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def pin_autotuning() -> None:
    """Have XLA pick GPU kernels by its heuristics instead of by timing.

    XLA otherwise times candidate matmul and fusion kernels at each
    compile and keeps the fastest, so two processes, or two cards of one
    process, can run the same program with different summation orders:
    KNN neighbour sets then differ at near-ties between a one-card and a
    four-card build, and outputs that must be byte-identical (solo
    ``predict`` vs ``predict-batch``) can differ.  A level the user set in
    ``XLA_FLAGS`` is kept.  Must run before the backend starts.
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_autotune_level=0"
        ).strip()


def log_backend() -> None:
    """Log the backend, device kind and device count once per command."""
    import jax

    devices = jax.devices()
    logging.info(
        "JAX backend: %s, device_kind=%s, devices=%d",
        devices[0].platform,
        devices[0].device_kind,
        len(devices),
    )
