"""Test configuration: 8 virtual CPU devices + float64.

Multi-device logic is tested without hardware via the standard JAX trick —
``xla_force_host_platform_device_count`` gives 8 CPU devices and the SAME
``shard_map`` code paths that run on a multi-GPU host (something the reference
could never do: its GPU engines require real CUDA P2P hardware, reference:
v3/gpu/common.py:61-79).  float64 matches the reference's dtype policy
(reference: v3/cpu/common.py:23).

Must run before jax initializes a backend, hence the env mutation at import
time of this conftest.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# Force CPU via the config too, in case jax was imported (and read the
# environment) before this conftest ran: the tests never use an accelerator.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
