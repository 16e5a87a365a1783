"""Test configuration.

The suite runs on the CPU (JAX_PLATFORMS=cpu) over 8 virtual host devices,
so multi-device sharding is checked on XLA's host platform.  Tests marked
`gpu` need the card: they skip here and run on a GPU from chip_smoke.py's
last phase, which sets CUSTRINGS_TESTS_ON_DEVICE=1 and runs them in its
own process, on the backend it already holds.
"""

import os

import pytest

_ON_DEVICE = os.environ.get("CUSTRINGS_TESTS_ON_DEVICE") == "1"

if not _ON_DEVICE:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

# the refcompat harness runs the UPSTREAM suite via its own runner
collect_ignore = ["refcompat"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (run by chip_smoke.py)"
    )


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX's backend is not a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return jax.devices()[0]
