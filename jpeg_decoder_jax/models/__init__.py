"""Decode pipeline families — the user-facing "models" of this framework.

Three families, mirroring the reference's three coding processes:
- baseline (SOF0/1), progressive (SOF2), lossless (SOF3) — all served by
  `jpeg_decoder_jax.Decoder` with a backend choice, plus the batch/stripe
  mesh services in `service.py` for production throughput.
"""

from .service import BatchDecodeService, decode_many

__all__ = ["BatchDecodeService", "decode_many"]
