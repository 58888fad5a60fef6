"""Device mesh construction for decode parallelism.

Axes:
- "data"   — batch data parallelism over images (DP). No collectives.
- "stripe" — MCU-row stripes within one image (SP). 1-row halo ppermute.

The cards of one host reach each other all to all (NVLink on an H100 host),
so the axes follow the algorithm alone. Multi-host: under `jax.distributed`,
`jax.devices()` spans all hosts and the same mesh code shards across them;
nothing here is host-count-specific.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None):
    """Create a Mesh with the given {axis_name: size} (insertion order = axis
    order). `devices` defaults to all available devices; sizes must multiply
    to len(devices) used."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    n = int(np.prod(list(axis_sizes.values())))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(tuple(axis_sizes.values()))
    return Mesh(dev, tuple(axis_sizes.keys()))
