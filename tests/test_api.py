"""Public-API behavior tests mirroring reference semantics not covered by the
corpus suites: buffer limits, color overrides, info lifecycle, output layouts.
"""

import numpy as np
import pytest

from conftest import REFTEST_IMAGES

from jpeg_decoder_jax import (CodingProcess, ColorTransform, Decoder,
                              FormatError, IoError, JpegError, PixelFormat,
                              UnsupportedError)

RGB = str(REFTEST_IMAGES / "rgb.jpg")


def test_info_none_before_decode():
    d = Decoder(RGB)
    assert d.info() is None
    d.read_info()
    info = d.info()
    assert (info.width, info.height) == (500, 333)
    assert info.pixel_format == PixelFormat.RGB24
    assert info.coding_process == CodingProcess.DCT_SEQUENTIAL


def test_pixel_bytes():
    assert PixelFormat.L8.pixel_bytes() == 1
    assert PixelFormat.L16.pixel_bytes() == 2
    assert PixelFormat.RGB24.pixel_bytes() == 3
    assert PixelFormat.CMYK32.pixel_bytes() == 4


def test_max_decoding_buffer_size():
    """`/root/reference/src/decoder.rs:631-641`: limit is in total samples."""
    d = Decoder(RGB)
    d.set_max_decoding_buffer_size(100)
    with pytest.raises(FormatError):
        d.decode()
    # Exactly at the limit passes.
    d2 = Decoder(RGB)
    d2.set_max_decoding_buffer_size(3 * 500 * 333)
    d2.decode()


def test_color_transform_none_is_planar_rows():
    """ColorTransform::None emits per-row planar layout
    (`/root/reference/src/decoder.rs:1476-1484`): row-major, each row holding
    the upsampled component rows back to back. Feeding those planes through
    the exact fixed-point YCbCr kernel must reproduce the standard decode
    bit-for-bit."""
    from jpeg_decoder_jax.ops.color import ycbcr_to_rgb

    d = Decoder(RGB)
    d.set_color_transform(ColorTransform.NONE)
    raw = np.frombuffer(d.decode(), np.uint8).reshape(333, 3, 500)

    d2 = Decoder(RGB)
    d2.set_color_transform(ColorTransform.YCBCR)
    rgb = np.frombuffer(d2.decode(), np.uint8).reshape(333, 500, 3)

    y, cb, cr = (raw[:, i, :].astype(np.int64) for i in range(3))
    reconverted = np.stack(ycbcr_to_rgb(y, cb, cr), axis=-1).astype(np.uint8)
    assert (reconverted == rgb).all()


def test_invalid_color_transform_pairs():
    d = Decoder(RGB)
    d.set_color_transform(ColorTransform.CMYK)  # 3 channels can't be CMYK
    with pytest.raises(FormatError):
        d.decode()

    d = Decoder(RGB)
    d.set_color_transform(ColorTransform.JCS_BG_RGB)
    with pytest.raises(UnsupportedError):
        d.decode()


def test_decode_twice_continues_stream():
    """Reference semantics: read_info then decode continues; decode after a
    full decode hits end-of-stream."""
    data = open(RGB, "rb").read()
    d = Decoder(data)
    first = d.decode()
    with pytest.raises(JpegError):
        d.decode()  # stream exhausted, like the reference's reader


def test_scale_returns_output_dims():
    d = Decoder(RGB)
    assert d.scale(1, 1) == (63, 42)       # 1/8
    d2 = Decoder(RGB)
    assert d2.scale(500, 333) == (500, 333)  # full


def test_decode_array_shapes():
    a = Decoder(RGB).decode_array()
    assert a.shape == (333, 500, 3) and a.dtype == np.uint8
    g = Decoder(str(REFTEST_IMAGES / "grayscale_square.jpg")).decode_array()
    assert g.ndim == 2 and g.dtype == np.uint8
    l16 = Decoder(str(REFTEST_IMAGES / "lossless" / "1" / "jpeg_lossless_sel1.jpg")).decode_array()
    assert l16.dtype == np.uint16


def test_file_object_source():
    with open(RGB, "rb") as f:
        d = Decoder(f)
        d.read_info()
        assert d.info().width == 500


def test_oracle_fallback_matches_native():
    """JPEG_JAX_DISABLE_NATIVE forces the pure-Python engines; output must be
    byte-identical (the CI matrix analog of the reference's
    platform_independent builds)."""
    import os
    import jpeg_decoder_jax.entropy.native as nm

    data = open(RGB, "rb").read()
    native = Decoder(data).decode()
    os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    nm.reset_native_cache()
    try:
        oracle = Decoder(data).decode()
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE")
        nm.reset_native_cache()
    assert native == oracle


class _ChunkReader:
    """File-like that serves tiny chunks and counts bytes read."""

    def __init__(self, data, chunk=512):
        self.data = data
        self.off = 0
        self.chunk = chunk
        self.read_calls = 0

    def read(self, n=-1):
        self.read_calls += 1
        n = self.chunk if n is None or n < 0 else min(n, self.chunk)
        out = self.data[self.off:self.off + n]
        self.off += len(out)
        return out


def test_incremental_reader_read_info():
    """read_info from a reader consumes only a prefix (socket-probe use)."""
    data = open(RGB, "rb").read()
    r = _ChunkReader(data)
    d = Decoder(r)
    d.read_info()
    info = d.info()
    assert (info.width, info.height) == (500, 333)
    assert r.off < len(data) // 2, f"read {r.off} of {len(data)}"


def test_incremental_reader_full_decode_matches():
    data = open(RGB, "rb").read()
    assert Decoder(_ChunkReader(data)).decode() == Decoder(data).decode()


def test_max_input_bytes_guard():
    data = open(RGB, "rb").read()
    with pytest.raises(FormatError):
        Decoder(_ChunkReader(data), max_input_bytes=1000).decode()
    # In-memory sources are checked up front.
    with pytest.raises(FormatError):
        Decoder(data, max_input_bytes=1000)
    # Generous limit passes.
    Decoder(_ChunkReader(data), max_input_bytes=10 << 20).decode()
