"""Batch-data-parallel decode: a batch of same-geometry images over the mesh.

The serving-throughput axis the reference lacks entirely (one decoder = one
image, `/root/reference/src/decoder.rs:101-131`): coefficient stores for B
images are stacked on a leading batch axis, sharded over the mesh's "data"
axis, and the whole reconstruction (IDCT + upsample + color) runs as one
vmapped, jitted program — XLA inserts zero collectives since DP is embarrassing.

Same-geometry batching is the shape-bucketing strategy of compiled devices: production
decode services bucket images by (size class, sampling, scale) so each bucket
compiles once and streams.
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops.pipeline import ImageGeometry, _reconstruct


@functools.lru_cache(maxsize=64)
def make_batch_pipeline(geometry: ImageGeometry, mesh, data_axis: str = "data"):
    """Compile the batched reconstruction for `geometry` over `mesh`.

    Returns fn(stores, qts) -> uint8 [B, H, W, C] (device-sharded on B), where
    `stores` is a tuple of int16 [B, N_i, 64] per component and `qts` a tuple
    of uint16 [64].
    """
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)
    from jax.sharding import NamedSharding, PartitionSpec as P

    batch_sharding = NamedSharding(mesh, P(data_axis))
    replicated = NamedSharding(mesh, P())

    def run_one(stores, qts):
        return _reconstruct(geometry, stores, qts, jnp)

    batched = jax.vmap(run_one, in_axes=(0, None))

    def run(stores, qts):
        return batched(stores, qts)

    n_comp = len(geometry.components)
    return jax.jit(
        run,
        in_shardings=((batch_sharding,) * n_comp, (replicated,) * n_comp),
        out_shardings=batch_sharding,
    )


def decode_batch_sharded(geometry: ImageGeometry, stores_batched, qts, mesh,
                         data_axis: str = "data"):
    """Decode B same-geometry images in one sharded program.

    stores_batched: list of np.int16 [B, N_i, 64] per component.
    qts: list of np.uint16[64] per component.
    Returns np.uint8 [B, H, W, C].
    """
    fn = make_batch_pipeline(geometry, mesh, data_axis)
    out = fn(tuple(stores_batched), tuple(np.asarray(q) for q in qts))
    return np.asarray(out)
