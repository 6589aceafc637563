"""Test environment.

By default the tests run on an 8-device CPU JAX backend: multi-device
hardware is not available in CI, and the standard JAX pattern is to fake
it with host devices (SURVEY.md section 4d).  The GPU traversal kernel
then runs in the Pallas interpreter, which the session requests.

``pytest -m gpu`` selects the card-only tests instead and leaves JAX its
default backend; each of them decides inside the ``gpu_backend`` fixture
whether a GPU is present and skips when none is.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _gpu_run(config) -> bool:
    return config.getoption("markexpr", "") == "gpu"


def pytest_configure(config):
    # before any test module touches a device
    if not _gpu_run(config):
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session", autouse=True)
def _backend(request):
    if _gpu_run(request.config):
        yield
        return
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
    assert len(jax.devices()) == 8
    from pathtracerap.pallas.trace import interpret_mode

    with interpret_mode():
        yield


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `pytest -m gpu tests/` on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
