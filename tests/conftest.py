"""Test environment: the CPU backend with 8 virtual devices, so the
multi-device sharding paths compile and execute without accelerator
hardware (the idiomatic substitute for a multi-node harness; see
SURVEY.md §4). JAX_PLATFORMS is only defaulted: `JAX_PLATFORMS=cuda
python -m pytest tests/ -m gpu` runs the card-only tests on a GPU."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from isle_jax.obs import enable_compilation_cache  # noqa: E402

# The suite's cost is dominated by XLA compiles; warm reruns skip them.
enable_compilation_cache()
