"""Test session config.

Tests run on the CPU backend with 8 virtual devices, so multi-device
sharding paths are exercised without accelerator hardware — the swtpu
analog of the reference's PSLSE strategy of running the full stack
hardware-free (pslse-master/; SURVEY.md §4 takeaway (c)).  The stream kernel
runs in the Pallas interpreter there.

Tests marked `gpu` need the card and skip elsewhere; on a machine with a
GPU run them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    # jax may already be (pre-)imported by the environment, so env vars are
    # too late for platform selection — use config.update, which takes
    # effect any time before backend initialization.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")

import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


@pytest.fixture
def plan():
    """The platform table's kernel plan for the backend the tests run on
    (decided when a test runs, never at import)."""
    from swtpu.device import kernel_plan

    return kernel_plan()


@pytest.fixture
def interpret(plan):
    """Whether the stream kernel runs in the Pallas interpreter here."""
    return plan.interpret


@pytest.fixture
def gpu():
    """Skip unless the first JAX device is a GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
