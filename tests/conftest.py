"""Test configuration: run on the CPU with a virtual 8-device mesh.

Tests need no accelerator; multi-device sharding is validated on a virtual
CPU mesh (``--xla_force_host_platform_device_count=8``), mirroring the
reference's "fake backend" affordances (mock denoiser inputs, forced compute
fallback — /root/reference/src/DXRExperimentsApp.cpp:19-23).

Tests that need a GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them on the CPU. On a machine with a card they run
with ``DXR_GPU_TESTS=1 python -m pytest tests/ -m gpu``: that variable
leaves JAX's own platform choice in place instead of forcing the CPU.
"""

import os
import sys

import pytest

# Import the package from the repo root without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Must be set before jax is imported anywhere.
ON_GPU = os.environ.get("DXR_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent XLA compilation cache (the suite is compile-bound; warm runs
# are ~3x faster), in the same place the entry points use. Opt out with
# DXR_NO_JAX_CACHE=1.
if not os.environ.get("DXR_NO_JAX_CACHE"):
    from dxrexperiments_tpu.utils.runtime import enable_compile_cache  # noqa: E402

    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")  # silence the loader
    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none (decided when
    the test runs, so every worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU")
