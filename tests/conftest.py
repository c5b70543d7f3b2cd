"""Test configuration.

NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see ONE
device.  Distributed tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves (see tests/dist_util.py).
"""
import os
import subprocess
import sys

import pytest

# The distributed snippets are written against the newer mesh API
# (jax.make_mesh(..., axis_types=(jax.sharding.AxisType.Auto, ...))).  On
# JAX versions without AxisType this prelude installs a tolerant shim; on
# newer JAX it is a no-op (see repro.common.compat).
_COMPAT_PRELUDE = (
    "from repro.common.compat import install_axis_type_shim\n"
    "install_axis_type_shim()\n"
)


def run_distributed(script: str, n_devices: int = 8, timeout: int = 560):
    """Run a python snippet in a subprocess with n host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", _COMPAT_PRELUDE + script],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(
            f"distributed subprocess failed:\nSTDOUT:{r.stdout[-3000:]}\n"
            f"STDERR:{r.stderr[-3000:]}")
    return r.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def dist():
    return run_distributed


@pytest.fixture(autouse=True)
def _clear_materialize_cache():
    """Drop the stacked-materialize compile cache after every test.

    ``moe_core._MAT_FNS`` pins compiled executables AND Meshes; without an
    explicit clear, executables built against one test's mesh survive into
    every later test in the process (the FIFO bound only caps growth, it
    does not release the last N).  Import lazily so non-JAX test files
    don't pay for it."""
    yield
    import sys
    mod = sys.modules.get("repro.core.moe")
    if mod is not None:
        mod.clear_materialize_cache()
