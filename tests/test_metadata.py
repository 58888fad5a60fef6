"""Metadata tests: ICC reassembly, EXIF/XMP, read_info/decode equivalence.

Port of `/root/reference/tests/lib.rs:34-170` using the reference's fixtures.
"""

from conftest import ICC_FIXTURES, REFTEST_IMAGES

from jpeg_decoder_jax import Decoder


def test_read_info_then_decode_matches():
    path = str(REFTEST_IMAGES / "mozilla" / "jpg-progressive.jpg")

    ref = Decoder(path)
    ref_data = ref.decode()
    ref_info = ref.info()

    dec = Decoder(path)
    dec.read_info()
    info = dec.info()
    data = dec.decode()

    assert info == dec.info()
    assert info == ref_info
    assert data == ref_data


def test_read_icc_profile():
    d = Decoder(str(REFTEST_IMAGES / "mozilla" / "jpg-srgb-icc.jpg"))
    d.decode()
    profile = d.icc_profile()
    assert profile is not None
    # "acsp" is a mandatory string in ICC profile headers.
    assert profile[36:40] == b"acsp"


def test_read_icc_profile_random_order():
    d = Decoder(str(ICC_FIXTURES / "icc_chunk_order.jpeg"))
    d.decode()
    profile = d.icc_profile()
    assert profile is not None
    assert len(profile) == 254
    assert profile == bytes(range(1, 255))


def test_read_icc_profile_seq_no_0():
    d = Decoder(str(ICC_FIXTURES / "icc_chunk_seq_no_0.jpeg"))
    d.decode()
    assert d.icc_profile() is None


def test_read_icc_profile_double_seq_no():
    d = Decoder(str(ICC_FIXTURES / "icc_chunk_double_seq_no.jpeg"))
    d.decode()
    assert d.icc_profile() is None


def test_read_icc_profile_chunk_count_mismatch():
    d = Decoder(str(ICC_FIXTURES / "icc_chunk_count_mismatch.jpeg"))
    d.decode()
    assert d.icc_profile() is None


def test_read_icc_profile_missing_chunk():
    d = Decoder(str(ICC_FIXTURES / "icc_missing_chunk.jpeg"))
    d.decode()
    assert d.icc_profile() is None


def test_read_exif_data():
    d = Decoder(str(REFTEST_IMAGES / "ycck.jpg"))
    d.decode()
    exif = d.exif_data()
    assert exif is not None
    assert exif[0:8] == b"\x49\x49\x2A\x00\x08\x00\x00\x00"  # TIFF header


def test_read_xmp_data():
    d = Decoder(str(REFTEST_IMAGES / "ycck.jpg"))
    d.decode()
    xmp = d.xmp_data()
    assert xmp is not None
    assert xmp[0:9] == b"<?xpacket"


def test_jfif_info_fields():
    """JFIF APP0 density fields (extension over the reference's detect-only
    handling, `/root/reference/src/parser.rs:618-632`)."""
    from conftest import REFTEST_IMAGES
    from jpeg_decoder_jax import Decoder

    d = Decoder(str(REFTEST_IMAGES / "mozilla" / "jpg-srgb-icc.jpg"))
    d.read_info()
    jfif = d.jfif_info()
    assert jfif is not None
    assert (jfif.version_major, jfif.version_minor) == (1, 1)
    assert jfif.density_unit == 1  # dots/inch
    assert jfif.x_density == 72 and jfif.y_density == 72
    assert jfif.thumbnail_width == jfif.thumbnail_height == 0
    assert jfif.thumbnail == b""
