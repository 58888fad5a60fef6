"""The seeded JPEG writer (jpeg_decoder_jax.testing.synth)."""

import io

import numpy as np
import pytest

from jpeg_decoder_jax import CodingProcess, Decoder
from jpeg_decoder_jax.testing import synth


@pytest.mark.parametrize("kind", synth.KINDS)
def test_roundtrip_close_to_source(kind):
    """Every kind decodes with the oracle to the generated pixels: exactly
    for lossless, within quantisation noise for the DCT kinds."""
    w, h = 64, 48
    data = synth.make_jpeg(kind, w, h, seed=7)
    d = Decoder(data)
    px = np.asarray(d.decode_array()).astype(np.float64)
    info = d.info()
    assert (info.width, info.height) == (w, h)
    if kind.startswith("lossless"):
        bits = int(kind[len("lossless"):])
        src = synth.photo(w, h, 1, 7, bits)[..., 0]
        assert np.array_equal(px.reshape(src.shape), src)
        assert info.coding_process == CodingProcess.LOSSLESS
        return
    gray = "gray" in kind
    src = synth.photo(w, h, 1 if gray else 3, 7).astype(np.float64)
    px = px.reshape(src.shape)
    if not gray:
        # Luma only: chroma subsampling blurs the shapes' colour edges.
        luma = np.array([0.299, 0.587, 0.114])
        px, src = px @ luma, src @ luma
    rms = np.sqrt(np.mean((px - src) ** 2))
    assert rms < 6.0, rms
    expect = (CodingProcess.DCT_PROGRESSIVE if kind.startswith("progressive")
              else CodingProcess.DCT_SEQUENTIAL)
    assert info.coding_process == expect


@pytest.mark.parametrize("kind", [k for k in synth.KINDS
                                  if k != "lossless16"])
def test_pillow_agrees(kind):
    """An independent decoder (Pillow's libjpeg) reads the same pixels,
    within the IDCT and chroma-upsampling differences of two conforming
    decoders."""
    pil = pytest.importorskip("PIL.Image")
    data = synth.make_jpeg(kind, 64, 48, seed=8)
    ours = np.asarray(Decoder(data).decode_array()).astype(int)
    theirs = np.asarray(pil.open(io.BytesIO(data))).astype(int)
    tol = 6 if kind.startswith(("420", "422", "progressive")) else 3
    assert np.abs(ours.reshape(theirs.shape) - theirs).max() <= tol


def test_seeds_are_deterministic_and_distinct():
    a = synth.make_jpeg("420", 48, 32, seed=1)
    assert a == synth.make_jpeg("420", 48, 32, seed=1)
    assert a != synth.make_jpeg("420", 48, 32, seed=2)


def test_restart_markers_present():
    data = synth.make_jpeg("422-dri", 64, 32, seed=3)
    assert b"\xff\xdd" in data
    rst = [data.count(bytes([0xFF, 0xD0 + i])) for i in range(8)]
    assert sum(rst) == 32 // 8 - 1       # one segment per MCU row


def test_pack_bits_matches_scalar_writer():
    """The vectorised packer equals the scalar BitWriter (before stuffing),
    including fields that straddle 64-bit words and the 1-fill."""
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 33, 500)
    fields = np.array([int(rng.integers(0, 1 << int(n))) if n else 0
                       for n in lens], np.uint64)
    w = synth.BitWriter()
    for f, n in zip(fields, lens):
        w.put(int(f), int(n))
    w.align()
    assert synth.stuff(synth.pack_bits(fields, lens)) == bytes(w.out)


def test_stuffing():
    assert synth.stuff(b"\x12\xff\x34\xff") == b"\x12\xff\x00\x34\xff\x00"
    assert synth.stuff(b"\x00\x01") == b"\x00\x01"


def test_canonical_codes_match_annex_k():
    """Annex K.3 luminance DC codes: category 0 is '00', 1..5 are 3-bit
    '010'..'110', 6 is '1110'."""
    from jpeg_decoder_jax.huffman import (_MJPEG_DC_LUMA_BITS,
                                          _MJPEG_DC_LUMA_VALUES)
    code, length = synth.canonical_codes(_MJPEG_DC_LUMA_BITS,
                                         _MJPEG_DC_LUMA_VALUES)
    assert (code[0], length[0]) == (0b00, 2)
    assert [int(code[c]) for c in range(1, 6)] == [2, 3, 4, 5, 6]
    assert (code[6], length[6]) == (0b1110, 4)


@pytest.mark.parametrize("quality", [75, 90, 95])
def test_quality_scales_tables(quality):
    luma, chroma = synth.quant_tables(quality)
    assert luma.min() >= 1 and chroma.max() <= 255
    data = synth.make_jpeg("420", 48, 32, seed=4, quality=quality)
    assert Decoder(data).decode_array().shape == (32, 48, 3)


def test_lossless_diffs_wrap_to_int16():
    px = np.array([[0, 65535, 0]], np.uint16)
    d = synth.lossless_diffs(px, 16)
    assert d.tolist() == [[[-32768, -1, 1]]]
    data = synth.encode_lossless(px, 16)
    assert np.array_equal(np.asarray(Decoder(data).decode_array()
                                     ).reshape(px.shape), px)
