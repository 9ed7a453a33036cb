"""Test env: the CPU backend with 8 forced host devices (SURVEY.md §4.5),
so the shard_map/psum/all_gather code paths run unmodified without a mesh
of accelerators.

The CPU is pinned only when ``JAX_PLATFORMS`` is unset; with it set (for
instance ``JAX_PLATFORMS=cuda`` on a machine with a GPU) the tests run on
that platform, and the ones marked ``gpu`` stop skipping.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if not os.environ.get("JAX_PLATFORMS"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev
