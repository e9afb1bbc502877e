"""Test configuration: tests run on CPU with 8 virtual devices so the
multi-device sharding path is exercised without GPUs
(XLA_FLAGS=--xla_force_host_platform_device_count, SURVEY.md §4).

Tests marked `gpu` need the card; they take the `gpu` fixture, which skips
them elsewhere. On a machine with a GPU, select the CUDA backend and run
only them:
    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os

# Must be set before jax initializes a backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the CPU backend unless the environment names one (the `gpu` tests above)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu")


@pytest.fixture(scope="session")
def cornell_path():
    """The Cornell scene from the repo's own self-contained fixtures."""
    from pathtracer_tpu.scene.fixtures import scene_path

    return scene_path("cornell")


@pytest.fixture(scope="session")
def cornell_small(cornell_path):
    from pathtracer_tpu import load_scene

    return load_scene(cornell_path, overrides={"RES": [64, 64], "DEPTH": 4,
                                               "ITERATIONS": 8})
