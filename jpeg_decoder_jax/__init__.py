"""jpeg_decoder_jax — a JPEG decode engine that decodes into device memory.

A from-scratch reimplementation of the full capability surface of the
`image-rs/jpeg-decoder` crate (baseline sequential SOF0/1, progressive SOF2,
lossless SOF3; grayscale/YCbCr/RGB/CMYK/YCCK pipelines; 4:2:0/4:2:2/generic
chroma upsampling; 1/8-1 IDCT-domain scaling; EXIF/XMP/ICC/Adobe metadata;
hardened malformed-input handling) designed for JAX execution:

- host entropy stage producing dense coefficient tensors (C++ kernel with a
  pure-Python oracle fallback), or anchored chunks that a device Huffman
  engine decodes (a Pallas kernel on GPUs, plain JAX elsewhere),
- batched, bit-exact integer kernels for dequant+IDCT, upsampling, and color
  conversion (numpy oracle and jitted device path share one implementation),
- decode-to-device streaming in `models/stream.py`,
- mesh-sharded batch/stripe parallelism in `parallel/`.

Public API mirrors the reference crate's `Decoder` (see `decoder.py`).
"""

from .decoder import Decoder, ImageInfo, PixelFormat, MAX_COMPONENTS
from .errors import (
    FormatError,
    InternalError,
    IoError,
    JpegError,
    UnsupportedError,
    UnsupportedFeature,
)
from .ops.color import ColorTransform
from .parser import CodingProcess, Predictor

__version__ = "0.1.0"

__all__ = [
    "Decoder",
    "ImageInfo",
    "PixelFormat",
    "ColorTransform",
    "CodingProcess",
    "Predictor",
    "JpegError",
    "FormatError",
    "UnsupportedError",
    "UnsupportedFeature",
    "IoError",
    "InternalError",
    "MAX_COMPONENTS",
    "__version__",
]
