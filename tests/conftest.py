"""Shared test fixtures.

Tests run on the CPU by default, with a virtual 8-device CPU mesh for the
sharding tests; the XLA flags must be set before jax initializes, hence at
conftest import time. Tests marked `gpu` check compiled kernels on a GPU at
real widths and skip elsewhere; run them on a card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os
import sys
from pathlib import Path

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO_ROOT = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
REFTEST_IMAGES = REFERENCE / "tests" / "reftest" / "images"
CRASHTEST_IMAGES = REFERENCE / "tests" / "crashtest" / "images"
ICC_FIXTURES = REFERENCE / "tests" / "icc"

sys.path.insert(0, str(REPO_ROOT))


def reftest_files():
    """All reftest jpgs minus disabled.list (`/root/reference/tests/common/mod.rs:6-40`)."""
    files = sorted(
        p for p in REFTEST_IMAGES.rglob("*.jp*g") if p.suffix in (".jpg", ".jpeg"))
    disabled = set()
    disabled_list = REFTEST_IMAGES / "disabled.list"
    if disabled_list.exists():
        for line in disabled_list.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                disabled.add((REFTEST_IMAGES / line).resolve())
    return [p for p in files if p.resolve() not in disabled]


def crashtest_files():
    return sorted(CRASHTEST_IMAGES.rglob("*.jpg"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: compiled-kernel checks that need a GPU (skip "
        "elsewhere)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at test
    time, never at import or collection: every xdist worker must collect
    the same tests."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
