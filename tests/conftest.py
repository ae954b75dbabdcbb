"""Test configuration: force JAX onto a virtual 8-device CPU mesh so all
device-code tests (shard_map sharding included) run anywhere, mirroring the
reference's GPU-free CI strategy (``@Tag("gpu")`` + graceful skip).  Must set
env vars before jax is imported anywhere."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the platform in config too, in case the interpreter's environment set
# jax_platforms before this file ran: tests never touch a real card.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def tmp_file(tmp_path):
    def make(name: str, data: bytes):
        p = tmp_path / name
        p.write_bytes(data)
        return str(p)

    return make


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one; "
        "python -m pytest -m gpu tests/test_gpu_hardware.py on the card)"
    )
    config.addinivalue_line("markers", "slow: long-running test")
