"""Test harness setup: an 8-virtual-device CPU backend.

The suite runs on the CPU (SURVEY.md §4.4): the unit and oracle tests need
no accelerator, and the sharding tests use XLA's fake-device trick —
`--xla_force_host_platform_device_count=8` — to exercise the real
Mesh/shard_map code paths without a multi-GPU host. Matmuls run at
`highest` precision so the NumPy references can be compared at f32
tolerances. The GPU path is exercised by `python chip_smoke.py` on the card.
"""

import os

# Must be set before the CPU backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
