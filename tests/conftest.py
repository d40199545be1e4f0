"""Test harness: force CPU with 8 virtual devices (SURVEY.md §4.5).

Must run before jax is imported anywhere — pytest imports conftest first.
The 8-device CPU mesh is the "fake backend" for multi-walker/sharding tests;
the same shard_map code runs unmodified on a multi-GPU host.  Tests that
need the GPU carry the ``gpu`` marker and skip here.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# hard-set (not setdefault): tests run on the virtual-device CPU backend
# whatever the host exports
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Compile-cache policy (utils/cache.py): no persistent cache on the CPU
# unless JAX_COMPILATION_CACHE_DIR asks for one.
from metadyn_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
