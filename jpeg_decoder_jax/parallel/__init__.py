"""Mesh-scale parallelism: the device answer to the reference's workers.

The reference's execution tier is single-host threads (`/root/reference/src/
worker/`): component threads, rayon block parallelism, row-parallel
upsample+color. On a device those intra-image axes are simply array dimensions of
the batched kernels in `..ops`. *This* package provides the scaling axes the
reference cannot:

- `batch`: data-parallel decode of image batches sharded over a device mesh
  (DP axis — one image's reconstruction per device slot).
- `stripes`: a single large image's MCU rows sharded over the mesh with 1-row
  halo exchange for the V2 chroma upsamplers (SP axis; the "ring-attention
  analog" from SURVEY.md §5).
- `mesh`: mesh construction helpers shared by both.
"""

from .mesh import make_mesh
from .batch import decode_batch_sharded, make_batch_pipeline
from .stripes import decode_striped, decode_striped_batch, make_stripe_pipeline

__all__ = [
    "make_mesh",
    "decode_batch_sharded",
    "make_batch_pipeline",
    "decode_striped",
    "decode_striped_batch",
    "make_stripe_pipeline",
]
