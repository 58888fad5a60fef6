"""Which device engine runs on which backend, decided in one place.

The entropy stage has two engines with identical outputs
(entropy/device_scan.build_sweep):

- "triton": the hand-written anchored Huffman kernel
  (entropy/triton_decode.py, Pallas on the Triton route), one chunk per
  lane, coefficients stored straight into the stream-order tensor;
- "xla": the plain-JAX `lax.scan` engine that XLA compiles for any backend.

A GPU gets the kernel; the CPU and any backend this module does not know
get the plain-JAX engine. Every other stage (assembly, dequantisation and
IDCT, upsampling and colour conversion) has one plain-JAX engine on every
backend. No environment variable chooses an engine, and no backend is ever
given a kernel in interpret mode: tests that want the interpreter ask for it
explicitly.
"""

from __future__ import annotations

ENTROPY_ENGINES = ("triton", "xla")


def backend() -> str:
    import jax
    return jax.default_backend()


def entropy_engine(on: str = None) -> str:
    """Entropy engine for backend `on` (default: JAX's default backend)."""
    return "triton" if (on or backend()) == "gpu" else "xla"
