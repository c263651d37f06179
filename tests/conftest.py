"""Test config: run JAX on a virtual 8-device CPU mesh.

Must run before jax initializes a backend; multi-chip sharding tests use
the 8 virtual devices. Tests marked `gpu` need the card: they take the
`gpu_device` fixture, which skips them on the CPU. To run them on a
machine with a GPU, set VSTRAINS_TESTS_ON_GPU=1, which leaves JAX's
platform choice alone (chip_smoke.py does this).
"""

import os

if os.environ.get("VSTRAINS_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    # an environment may import jax before this file runs, which freezes
    # the platform default from the old env — override it before any
    # backend initializes
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    import jax
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none. Decided here,
    at run time, so every worker collects the same tests."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
