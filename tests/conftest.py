"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set env vars before the first jax import anywhere in the test session.
"""

import os

# CPU unless the caller names a platform (the `gpu`-marked tests run on
# the card with JAX_PLATFORMS=cuda,cpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
