"""Regression: lossless Ra (predictor 1) + DRI must chain, not reset.

The reference dispatches the Ra fast path BEFORE any restart consideration
(`/root/reference/src/decoder/lossless.rs:108-138`), so the stale phase-2
restart flag (`:168-171`) never applies to predictor-1 scans. Round-1 native
and device paths checked restart_all first and emitted default-prediction
everywhere for Ra scans with (H*W-1) % DRI == 0 (e.g. DRI=1). This test
synthesizes exactly that stream and pins all three engines to the oracle.
"""

import numpy as np
import pytest

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.ops.predictors import (
    _reconstruct_ra,
    reconstruct_lossless,
    reconstruct_lossless_device,
)
from jpeg_decoder_jax.parser import Predictor
from jpeg_decoder_jax.testing.synth import BitWriter, encode_diff


# Canonical DC table: 3 codes of length 2 (symbols 0,1,2), 2 of length 3 (3,4).
_DHT_COUNTS = [0, 3, 2] + [0] * 13
_DHT_SYMBOLS = [0, 1, 2, 3, 4]
_CODES = {0: (0b00, 2), 1: (0b01, 2), 2: (0b10, 2), 3: (0b110, 3), 4: (0b111, 3)}


def _build_lossless_jpeg(diffs: np.ndarray, dri: int, predictor: int = 1,
                         precision: int = 8, pt: int = 0) -> bytes:
    """Minimal single-component SOF3 stream: one diff per sample, RST between
    every `dri` samples (marker protocol per G.1.2.2 / decoder.rs:920-952)."""
    h, w = diffs.shape
    bw = BitWriter()
    bw.raw(b"\xff\xd8")  # SOI
    # DHT (class 0, id 0)
    payload = bytes([0x00] + _DHT_COUNTS + _DHT_SYMBOLS)
    bw.raw(b"\xff\xc4" + (len(payload) + 2).to_bytes(2, "big") + payload)
    # SOF3
    sof = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + \
        bytes([1, 1, 0x11, 0])
    bw.raw(b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof)
    if dri:
        bw.raw(b"\xff\xdd\x00\x04" + dri.to_bytes(2, "big"))
    # SOS: Ss = predictor selection, Al = point transform
    sos = bytes([1, 1, 0x00, predictor, 0, pt])
    bw.raw(b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos)

    rst = 0
    since_restart = 0
    for i, diff in enumerate(diffs.reshape(-1)):
        if dri and since_restart == dri and i:
            bw.align()
            bw.raw(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
            since_restart = 0
        encode_diff(bw, int(diff), _CODES)
        since_restart += 1
    bw.align()
    bw.raw(b"\xff\xd9")  # EOI
    return bytes(bw.out)


def _expected_ra_chain(diffs: np.ndarray, precision: int = 8) -> np.ndarray:
    return _reconstruct_ra(diffs, 0, precision)


@pytest.fixture(scope="module")
def dri1_stream():
    rng = np.random.default_rng(7)
    diffs = rng.integers(-7, 8, (5, 6)).astype(np.int32)
    return _build_lossless_jpeg(diffs, dri=1), diffs


def test_stream_decodes_and_is_chained(dri1_stream):
    data, diffs = dri1_stream
    expected = _expected_ra_chain(diffs)
    out = np.frombuffer(Decoder(data).decode(), np.uint8).reshape(diffs.shape)
    assert (out == expected).all()
    # Guard: the buggy ordering gives default-prediction-everywhere instead.
    buggy = ((128 + diffs) & 0xFFFF).astype(np.uint8)
    assert not (out.reshape(-1) == buggy.reshape(-1)).all()


def test_all_backends_agree(dri1_stream):
    data, diffs = dri1_stream
    expected = _expected_ra_chain(diffs).astype(np.uint8).tobytes()
    assert Decoder(data, backend="numpy").decode() == expected
    assert Decoder(data, backend="jax").decode() == expected


def test_engines_agree_on_restart_all_ra():
    """Unit level: oracle / native / device, predictor 1, restart_all=True."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    diffs = rng.integers(-9, 10, (7, 9)).astype(np.int32)
    expected = _expected_ra_chain(diffs, precision=12)

    # reconstruct_lossless dispatches to native when built.
    host = reconstruct_lossless(diffs, Predictor.RA, 0, 12, restart_all=True)
    assert (host == expected).all()

    dev = reconstruct_lossless_device(diffs, Predictor.RA, 0, 12, True, jnp)
    assert (np.asarray(dev) == expected).all()


def test_general_path_restart_all_still_defaults():
    """Non-Ra predictors DO take the stale restart default (predict():200-206)."""
    rng = np.random.default_rng(13)
    diffs = rng.integers(-7, 8, (4, 5)).astype(np.int32)
    data = _build_lossless_jpeg(diffs, dri=1, predictor=2)
    out = np.frombuffer(Decoder(data).decode(), np.uint8).reshape(diffs.shape)
    expected = ((128 + diffs) & 0xFFFF).astype(np.uint8)
    assert (out == expected).all()
