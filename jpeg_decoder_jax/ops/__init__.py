"""Batched compute ops: coefficient tensors -> pixels.

Every op in this package is written over a numpy-compatible array namespace
(`xp` = numpy or jax.numpy) using exclusively int32/uint8 arithmetic that is
bit-exact with the reference's scalar kernels. The same code therefore serves
as the host oracle (numpy) and the device compute path (jax under jit,
fused per image in `pipeline.py`).
"""

from .idct import choose_idct_size, dequantize_and_idct_blocks, blocks_to_plane
from .upsample import upsample_component
from .color import (
    ycbcr_to_rgb,
    color_convert_image,
)

__all__ = [
    "choose_idct_size",
    "dequantize_and_idct_blocks",
    "blocks_to_plane",
    "upsample_component",
    "ycbcr_to_rgb",
    "color_convert_image",
]
