"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so the distributed code paths are
exercised without accelerator hardware, and with x64 enabled so the solver
can be validated against float64 references.
"""

import os
import sys

# Force CPU: the tests are the CPU tier; chip_smoke.py covers the GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Warm-start repeated runs (and the CLI subprocess tests) from a shared
# on-disk XLA compilation cache.
from irotavg_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Under a pytest-xdist worker, skip @pytest.mark.perf tests.

    Those tests assert wall-time properties (work-conservation ratios,
    subprocess deadlines) that hold on an uncontended host but not when
    N workers timeshare the cores — a correctness suite must be green
    under ``-n 4`` regardless of runner parallelism.  They still run in
    serial invocations (and ``pytest -m perf``).
    """
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    skip = pytest.mark.skip(
        reason="perf-sensitive: runs serially only (see pytest.ini)")
    for item in items:
        if "perf" in item.keywords:
            item.add_marker(skip)
