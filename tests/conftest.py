"""Test configuration: run everything on a virtual 8-device CPU mesh so
sharding tests work without a multi-device machine and results are
deterministic.  Set FSPT_TEST_ON_DEVICE=1 to leave JAX on its default
devices instead (how the `gpu`-marked tests run on the card)."""

import os

ON_DEVICE = bool(os.environ.get("FSPT_TEST_ON_DEVICE"))
if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fspt_tpu.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` run only where JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's device is {platform}); run on the "
                    "card with FSPT_TEST_ON_DEVICE=1 pytest -m gpu tests/")


@pytest.fixture(scope="session")
def small_scene():
    from fspt_tpu.testing import make_test_scene
    return make_test_scene(subdivisions=2)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
