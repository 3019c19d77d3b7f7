"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths are
exercised without accelerator hardware; x64 is enabled so parity checks
against the reference's float64 numpy math are tight.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

# Pin the CPU backend in-process as well, so tests run on the 8-device
# virtual CPU mesh even where an accelerator plugin registers itself.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# The CLI enables the persistent compile cache; tests call it in-process
# and must not write compiled programs into the checkout.
jax.config.update("jax_enable_compilation_cache", False)

import sys  # noqa: E402

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

REFERENCE_SRC = "/root/reference/src"


@pytest.fixture(scope="session")
def ref_modules():
    """Import the reference implementation as a golden oracle.

    Only the numpy/sklearn/scipy modules are importable here (convert_tools
    needs pysam and the R bridge needs Rscript; neither exists in this
    image), which is exactly the subset our parity tests need.
    """
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    import wisecondorx.newref_control as newref_control
    import wisecondorx.newref_tools as newref_tools
    import wisecondorx.overall_tools as overall_tools
    import wisecondorx.predict_control as predict_control
    import wisecondorx.predict_tools as predict_tools

    return {
        "newref_tools": newref_tools,
        "newref_control": newref_control,
        "overall_tools": overall_tools,
        "predict_tools": predict_tools,
        "predict_control": predict_control,
    }
