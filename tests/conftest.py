"""Test environment: CPU backend with 8 virtual devices.

SURVEY.md §4 item 4: distributed code paths are tested without a cluster via
`--xla_force_host_platform_device_count=8`. Parity tests also want CPU's
exact fp32/fp64 semantics rather than an accelerator's matmul precision.

The platform is switched via jax.config before any backend is initialized,
so the tests run on the CPU whatever JAX_PLATFORMS says; XLA_FLAGS is read
at first backend init, so setting it here works.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))  # for `oracle` imports
