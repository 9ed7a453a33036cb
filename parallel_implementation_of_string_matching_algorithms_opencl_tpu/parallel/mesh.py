"""Device-mesh construction for the 1-D ``data`` axis decomposition.

The entire parallel model is data parallelism over text shards
(SURVEY.md §2.2): a 1-D mesh whose single axis spans every device.  The
cards of one host are joined all to all (NVLink), so device order does not
matter.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


DATA_AXIS = "data"


def make_data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all addressable devices)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (DATA_AXIS,), devices=devices)
