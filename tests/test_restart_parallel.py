"""Restart-segment parallel entropy decode vs the serial oracle.

The corpus's restarts.jpg is too small to engage the threaded path
(`entropy.cc` requires total MCUs > 4 * restart_interval); these tests build
large DRI-segmented JPEGs with PIL so the std::thread splitter actually runs,
and verify byte-parity with the Python oracle plus stream-path correctness.
"""

import io
import os

import numpy as np
import pytest

import jpeg_decoder_jax.entropy.native as native_mod
from jpeg_decoder_jax import Decoder


def _pil():
    """Pillow, or a skip of the calling test when it is not installed."""
    return pytest.importorskip("PIL.Image")


def _make_dri_jpeg(h, w, restart_rows=1, quality=85, mode="RGB", seed=0):
    rng = np.random.default_rng(seed)
    if mode == "RGB":
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
    buf = io.BytesIO()
    _pil().fromarray(arr, mode).save(buf, "JPEG", quality=quality,
                                    restart_marker_rows=restart_rows)
    data = buf.getvalue()
    assert data.find(b"\xff\xdd") >= 0  # DRI present
    return data


def _oracle(data: bytes) -> bytes:
    os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    native_mod.reset_native_cache()
    try:
        return Decoder(data).decode()
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE")
        native_mod.reset_native_cache()


@pytest.mark.parametrize("shape,mode,rows", [
    ((512, 768), "RGB", 1),
    ((320, 320), "RGB", 2),
    ((528, 400), "L", 1),
])
def test_parallel_restart_decode_matches_oracle(shape, mode, rows):
    data = _make_dri_jpeg(*shape, restart_rows=rows, mode=mode)
    assert Decoder(data).decode() == _oracle(data)


def test_corrupted_restart_falls_back_consistently():
    """Breaking a RST marker mid-stream must yield the same outcome (error or
    pixels) as the oracle — the parallel path's validation + serial fallback."""
    data = bytearray(_make_dri_jpeg(512, 768))
    # Find and corrupt the 5th restart marker.
    count = 0
    for i in range(len(data) - 1):
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            count += 1
            if count == 5:
                data[i + 1] = 0xD9 if data[i + 1] != 0xD9 else 0xD5
                break
    data = bytes(data)

    def run(disable):
        if disable:
            os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
        else:
            os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()
        try:
            return ("OK", Decoder(data).decode())
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    try:
        assert run(False) == run(True)
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()


def test_dri_image_through_stream_pipeline():
    """DRI image through the decode-to-device staging (prefix capture handles
    restarts serially) — must match the plain decoder."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jpeg_decoder_jax.models.stream import stage_host, _compiled_prefix_pipeline

    data = _make_dri_jpeg(256, 384)
    golden = np.frombuffer(Decoder(data, precision="fast").decode(), np.uint8)
    st = stage_host(data)
    fn = _compiled_prefix_pipeline(st.geometry, len(st.resid_idx))
    out = np.asarray(fn(st.dc, st.ac, st.resid_idx, st.resid_vals, st.qts))
    assert (out.reshape(-1) == golden).all()
