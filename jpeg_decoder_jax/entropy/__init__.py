"""Entropy decode layer: JPEG bitstream -> coefficient / difference tensors.

The bit-serial Huffman stage runs on the host here (the device engines for
baseline scans are in `device_scan` and `triton_decode`); this package turns
its output into dense tensors that feed the batched kernels in `..ops`. Two
interchangeable host engines:

- `scan_python`: pure-Python oracle, exact semantics, used for validation and as
  the portable fallback.
- `native`: C++ host kernel (built on demand with g++, bound via ctypes), the
  production path, including restart-segment parallelism.

Use `decode_scan_dct` / `decode_scan_lossless` from this module; they dispatch
to the native engine when available.
"""

from . import scan_python
from .bitreader import BitReader
from .native import get_native

__all__ = ["BitReader", "decode_scan_dct", "decode_scan_lossless", "scan_python"]


def decode_scan_dct(*args, **kwargs):
    native = get_native()
    if native is not None:
        return native.decode_scan_dct(*args, **kwargs)
    return scan_python.decode_scan_dct(*args, **kwargs)


def decode_scan_lossless(*args, **kwargs):
    native = get_native()
    if native is not None:
        return native.decode_scan_lossless(*args, **kwargs)
    return scan_python.decode_scan_lossless(*args, **kwargs)
