"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
path runs without a card (SURVEY.md §4.4).  A run that sets JAX_PLATFORMS
itself keeps it: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`
runs the tests marked `gpu` on the card, which skip everywhere else.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def h264ref():
    """Path to the libavcodec conformance-oracle CLI, built on demand
    (single build path: tools.streams.ensure_h264ref)."""
    from tools.streams import ensure_h264ref
    return ensure_h264ref()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, so every worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
