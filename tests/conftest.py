"""Test configuration: run JAX on CPU with 8 virtual devices and f64.

The platform is forced through jax.config (an environment variable is too
late when jax was imported before pytest collected this file).
Multi-device sharding tests fake a multi-device mesh via
--xla_force_host_platform_device_count (SURVEY.md §4d); numerical oracles
use float64, which the CPU backend supports natively.

Tests marked `gpu` need a CUDA card; the `gpu_card` fixture skips them where
nvidia-smi lists none (decided at run time, never at import).  Such tests
drive the card from a child process, since this one is held to the CPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
    # 8 virtual devices share a few host cores under parallel test
    # workers, which can make shards slow enough to trip XLA's CPU
    # collective stuck-thread abort at its default ~30s deadline.  These
    # raise the rendezvous deadlines so slow-but-live shards aren't
    # SIGABRTed.
    + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=120"
    + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8, jax.devices()


import shutil  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu_card():
    """`name, power.limit` of the first CUDA card, or skip without one."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no CUDA card: nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    cards = [ln for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not cards:
        pytest.skip("no CUDA card listed by nvidia-smi")
    return cards[0]
