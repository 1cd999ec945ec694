"""Test harness config: hermetic CPU runs with a virtual 8-device mesh.

Must run before jax is imported anywhere. The program's chip runs
(chip_smoke.py, bench.py) need the GPU; tests are deterministic on CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("FAD_TPU_OFFLINE", "1")  # hermetic: never hit the network
# Hermetic: no persistent compile-cache reads or writes (JAX's own switch;
# inherited by the subprocess tests too).
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

# Pin CPU with 8 virtual devices here, before any backend initialization.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

REPO_ROOT = Path(__file__).parent.parent
sys.path.insert(0, str(REPO_ROOT))


def generate_test_audio(duration: float, freq: float, sample_rate: int = 16000) -> np.ndarray:
    """Sine-wave fixture shared by all test files (mirrors the reference's
    tests/test_basic.py:20-24 fixture)."""
    t = np.linspace(0, duration, int(sample_rate * duration), dtype=np.float32)
    return (np.sin(2 * np.pi * freq * t) * 0.5).astype(np.float32)


@pytest.fixture
def sine_audio():
    return generate_test_audio
