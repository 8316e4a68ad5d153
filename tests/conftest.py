"""Test config: force an 8-device virtual CPU mesh before JAX initializes.

Mirrors the reference's approach of running MPI/multi-locale tests on one
host (SURVEY.md §4.3): sharding tests run on 8 virtual CPU devices.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Tests run on the virtual 8-device CPU mesh, whatever accelerator the
# machine has.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xFE307)
