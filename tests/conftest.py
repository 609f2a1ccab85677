"""Test configuration.

Tests run on a virtual 8-device CPU mesh (per SURVEY.md §4: multi-host logic
is tested with XLA_FLAGS=--xla_force_host_platform_device_count=8) so the
distributed shuffle/join/agg paths execute without several accelerators.
The CPU is forced unconditionally, before jax initializes its backends.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# pin via config too, in case a plugin imported jax before this file ran
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
