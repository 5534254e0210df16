"""Test configuration: hermetic CPU backend with 8 virtual devices.

The tests run on the CPU. Multi-device sharding tests run on a virtual
8-device CPU mesh via `--xla_force_host_platform_device_count` (SURVEY.md
§4.4). Tests marked `gpu` need an NVIDIA GPU and skip here; on a machine
with one, `MPT_TEST_GPU=1 python -m pytest -m gpu tests/` runs them on the
card (chip_smoke.py phase 3 makes the same checks).
"""

import os

import pytest

ON_GPU = os.environ.get("MPT_TEST_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
os.environ["XLA_FLAGS"] = flags.strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from metalpathtracer_tpu.utils import enable_persistent_compile_cache  # noqa: E402

# persistent compilation cache: repeated test runs skip XLA recompiles
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
enable_persistent_compile_cache()

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided per test, never at
    import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 3 runs this "
                    "check on the card)")
