"""Test harness: CPU backend with an 8-device virtual mesh.

Multi-device sharding paths are validated on virtual CPU devices.  Tests
that need the card carry the ``gpu`` marker and the ``gpu`` fixture,
which decides at run time (never at import) whether a GPU is present;
chip_smoke.py runs them on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip unless this process's JAX backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card via chip_smoke.py")
    return jax.devices()[0]
