"""Test harness: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU backend; sharding tests use XLA's host-platform device
virtualization (SURVEY.md section 4).  Must be set before jax initializes.

Checks that need a GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them on the CPU.  On a machine with a card they run
with ``SPF_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``.
"""

import os

if os.environ.get("SPF_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Persistent compilation cache: the clustering subdivision compiles a bucketed
# family of shapes; caching makes reruns fast.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

from spfresh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (SPF_TESTS_ON_GPU=1 on the card; "
                    "chip_smoke.py phase 3 runs the same checks)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def toy_data():
    """The canonical 6x2 three-pair dataset used throughout the reference's
    tests and examples (hierarchical.rs:400-402, examples/build_index.rs:9-12)."""
    return np.array(
        [
            [1.0, 2.0],
            [1.5, 2.5],
            [8.0, 8.0],
            [8.5, 8.5],
            [4.0, 4.0],
            [4.5, 4.5],
        ],
        dtype=np.float32,
    )
