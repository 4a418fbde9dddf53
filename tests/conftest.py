"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated here without accelerators. The jax
config is updated as well as the environment, in case jax was imported
before this file. Tests marked `gpu` need a CUDA device and skip here;
chip_smoke.py runs them on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none. Decided
    here, at run time, never while a module is imported."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
