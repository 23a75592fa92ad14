"""Test configuration: an 8-virtual-device CPU backend.

Must run before any jax import: CPU-backend jax runs the whole suite
without a GPU, and the sharding tests use the virtual mesh. Tests marked
``gpu`` need a card: run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; everywhere else
they skip.
"""

import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compilation cache: the heavy pipeline compiles once per
# (params, caps) config and is reused across test runs.
from fccf_pcr_tpu.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from fccf_pcr_tpu.config import TEST_CAPS, FCCFParams  # noqa: E402
from fccf_pcr_tpu.io import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def params():
    # leaf 0.25 m on the synthetic room keeps point counts inside TEST_CAPS.
    return FCCFParams(leaf_size=0.25)


@pytest.fixture(scope="session")
def caps():
    return TEST_CAPS


@pytest.fixture(scope="session")
def small_pair(caps):
    src, tar, T_gt = synthetic.make_pair(
        seed=3, points_per_plane=1500, clutter_points=900
    )
    src_p, src_m = synthetic.pad_points(src, caps.max_points)
    tar_p, tar_m = synthetic.pad_points(tar, caps.max_points)
    return src_p, src_m, tar_p, tar_m, np.asarray(T_gt)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a GPU host)")
    return jax.devices()[0]
