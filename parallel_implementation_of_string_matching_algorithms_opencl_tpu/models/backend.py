"""The one place that decides how a matcher executes on this backend.

- ``gpu`` and ``cpu``: the plain ``jax.numpy`` scan that XLA compiles;
- any other platform: an error, never a silent fallback.

Every matcher calls ``execution_path`` while it traces, so a kernel that
replaces a plain scan on one platform is chosen here and nowhere else.
"""

from __future__ import annotations

import jax

PLAIN = "plain"
PLATFORMS = ("gpu", "cpu")


def execution_path() -> str:
    """The execution path for the current default backend (``PLAIN``)."""
    platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"tpumatch runs on the {' or '.join(PLATFORMS)} backend, "
            f"not {platform!r}"
        )
    return PLAIN
