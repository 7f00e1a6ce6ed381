"""Test configuration: force an 8-device virtual CPU mesh and float64.

The reference protocol runs at tolerances down to 1e-16 (SURVEY.md §6), so
unit/parity tests use x64 on CPU; the GPU is exercised by ``chip_smoke.py``
and by tests marked ``gpu``, which skip here.  Multi-device sharding tests
use the 8 virtual host devices (a fake backend; SURVEY.md §4).
"""

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Tests that call build_sweep must not write tiny instances into the
# repo-tree dataset/_cache (the chip harness's generated-instance cache).
os.environ.setdefault(
    "RIPTRM_CACHE_DIR", tempfile.mkdtemp(prefix="riptrm_cache_")
)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from riptrm_tpu.config import setup  # noqa: E402

# Compile time dominates the suite, so every run shares the persistent
# compilation cache.  JAX_PLATFORMS=cuda,cpu runs the ``gpu``-marked tests
# on the card (README "Tests"); instance generation needs the CPU backend.
setup(cpu=os.environ["JAX_PLATFORMS"] == "cpu", x64=True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run on the card: python chip_smoke.py)")
    return gpus[0]
