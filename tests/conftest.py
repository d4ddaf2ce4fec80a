"""Test configuration: CPU backend with 8 virtual devices and x64 enabled.

Multi-host/multi-chip sharding tests run on a virtual CPU mesh since the
reference offers no distributed fixture to imitate (SURVEY.md §4).

Tests marked `gpu` need an NVIDIA GPU. They skip everywhere else, from
inside the `gpu_device` fixture, so every run collects the same tests. On
the card they run as one process:

    python -m pytest -m gpu tests/ -p no:xdist

and only in that run (marker expression exactly "gpu") does this file
leave JAX's default platform alone.
"""

import os

import pytest

from psba_tpu.datasets import DATA_DIR as DATA


def pytest_configure(config):
    if config.option.markexpr != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    import jax

    if config.option.markexpr != "gpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def has_data() -> bool:
    return os.path.isdir(DATA)


requires_data = pytest.mark.skipif(
    not has_data(), reason="reference datasets not mounted"
)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU; run `python -m pytest -m gpu tests/ "
            "-p no:xdist` on the card"
        )
    return jax.devices()[0]


@pytest.fixture(scope="session")
def prob7():
    """7 cameras, 465 points: the mid-size unit fixture, generated at the
    shape of the reference's 7-camera problem (io.synthetic)."""
    from psba_tpu.io import bal_shaped_problem

    return bal_shaped_problem(7, 465, seed=7)


@pytest.fixture(scope="session")
def prob54():
    """54 cameras, 5207 points, generated at the shape of the reference's
    54-camera problem."""
    from psba_tpu.io import bal_shaped_problem

    return bal_shaped_problem(54, 5207, seed=54)


@pytest.fixture(scope="session")
def prob7_ref():
    """The reference's own 7camsvarK/7pts problem (parity anchors)."""
    from psba_tpu.io import load_problem

    return load_problem(f"{DATA}/7camsvarK.txt", f"{DATA}/7pts.txt")


@pytest.fixture(scope="session")
def prob54_ref():
    """The reference's 54camsvarKD problem (distortion parsed+dropped)."""
    from psba_tpu.io import load_problem

    return load_problem(f"{DATA}/54camsvarKD.txt", f"{DATA}/54pts.txt")


@pytest.fixture(scope="session")
def prob_synth():
    from psba_tpu.io import synthetic_problem

    return synthetic_problem(n_cams=6, n_pts=150, seed=3)
