"""Test configuration: a virtual 8-device CPU mesh for the sharding tests.

`XLA_FLAGS` must be set before JAX creates its CPU backend, so it is set
here, at import.  The platform comes from the environment
(`JAX_PLATFORMS=cpu` in the tier-1 command); `chip_smoke.py` runs the
`gpu`-marked tests in its own process on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables after each test module.

    The full suite compiles several hundred XLA:CPU programs across the
    8 virtual devices; letting them accumulate in one process
    eventually aborts/segfaults inside `backend_compile_and_load`
    (observed deterministically at ~81% of the suite — a native
    compiler-arena failure, not a test bug).  Per-module cache clears
    keep the JIT arena bounded; cross-module recompiles are few because
    test modules mostly compile their own kernels."""
    yield
    jax.clear_caches()
