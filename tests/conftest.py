"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the row-sharded
multi-device path is exercised without GPUs ("test multi-node without a
cluster" — SURVEY §4), and Pallas kernels run in interpret mode.  Tests
marked ``gpu`` need a card: they skip here and run on the GPU with
``python -m pytest tests/ -m gpu``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# the CPU backend unless the caller names another (JAX_PLATFORMS=cuda runs
# the ``gpu``-marked tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# OPT-IN persistent XLA compile cache (RBL_TEST_COMPILE_CACHE=1), in the
# same directory the library's entry points use (rbl/backend.py): cuts a
# warm full-suite run ~3×.  Reloading serialized CPU executables that use
# buffer donation can abort the process (a JAX/XLA:CPU deserialization
# bug, not solver state), so the cached run also sets RBL_NO_DONATION=1
# (rbl/backend.py:donate): donated programs are compiled without
# donation.  Delete .jax_cache/ if a cached run crashes.
if os.environ.get("RBL_TEST_COMPILE_CACHE"):
    os.environ["RBL_NO_DONATION"] = "1"
    from rbl.backend import enable_compile_cache  # noqa: E402

    enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def gpu():
    """The GPU devices; skips the test where JAX found no GPU."""
    from rbl.backend import require_gpu

    try:
        return require_gpu()
    except RuntimeError as e:
        pytest.skip(str(e))


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite compiles many hundreds of XLA CPU executables in one
    process (every module jits at its own shapes); letting them all stay
    resident eventually segfaults the CPU JIT inside
    ``backend_compile_and_load`` — observed ~85% into the suite at
    varying, unrelated tests (test_spectra / test_svd), exit 139.
    Clearing per module keeps the live-executable footprint at one
    module's worth; intra-module caching (the expensive solver sweeps)
    is unaffected."""
    yield
    jax.clear_caches()
