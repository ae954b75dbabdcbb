"""Device mesh construction.

The only cross-device axis in this framework is data parallelism over chunks
("blocks"), matching the reference's chunk-level parallelism (its only
scaling axis, ``SURVEY.md`` §2.7 P1) — but across devices and hosts instead
of a thread pool.  The mesh is flat: every GPU of a host reaches every other
over NVLink at the same rate, and the algorithm needs only one axis.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

BLOCKS_AXIS = "blocks"


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = BLOCKS_AXIS,
    devices: Optional[list] = None,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    device of JAX's default backend)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))
