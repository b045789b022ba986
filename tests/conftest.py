"""Test configuration: force an 8-device virtual CPU mesh before JAX initializes.

All tests run on CPU with 8 virtual devices so multi-device sharding (DP/FSDP/TP)
is exercised without accelerators (SURVEY.md §4: the fake-backend layer the
reference never had). Tests marked ``gpu`` skip here; chip_smoke.py runs them
on the card.
"""
import os
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Keep serving/gradio conversation logs out of the repo root during test runs.
os.environ.setdefault("SLIME_LOGDIR", tempfile.mkdtemp(prefix="slime_test_logs_"))
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from slime_jax.utils import enable_compilation_cache  # noqa: E402

# Persistent XLA compilation cache, same rule as the entry points:
# $JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_compile_cache.
enable_compilation_cache()
# 0.1s: the suite is thousands of small compiles, not a few big ones —
# caching the sub-second tail is worth minutes on warm 1-CPU runs.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
