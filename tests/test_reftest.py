"""Golden-image reftests against the reference corpus.

Port of `/root/reference/tests/reftest/mod.rs`: every jpg under the reference's
reftest corpus (minus disabled.list) is decoded and compared against its golden
PNG — max per-pixel |diff| <= 3 for lossy processes, exactly 0 for lossless.
CMYK32 output is converted to RGB with the harness's float formula before
comparison; L16 is compared as u16.
"""

import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax import CodingProcess, Decoder, PixelFormat


def _pil():
    """Pillow, or a skip of the calling test when it is not installed."""
    return pytest.importorskip("PIL.Image")


def load_golden(png_path):
    """Golden PNG as (array, channels). RGBA collapses to RGB
    (`/root/reference/tests/reftest/mod.rs:122-136`)."""
    im = _pil().open(png_path)
    if im.mode == "RGBA":
        arr = np.asarray(im)
        assert (arr[..., 3] == 255).all()
        return arr[..., :3].astype(np.int64)
    if im.mode in ("I;16", "I;16B", "I"):
        return np.asarray(im, dtype=np.int64)
    if im.mode == "P":
        im = im.convert("RGB")
    return np.asarray(im).astype(np.int64)


def cmyk_to_rgb(data: np.ndarray) -> np.ndarray:
    """The reftest harness's CMYK->RGB view transform
    (`/root/reference/tests/reftest/mod.rs:138-164`), float math and all."""
    f = data.astype(np.float32) / 255.0
    c, m, y, k = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    c = c * (1.0 - k) + k
    m = m * (1.0 - k) + k
    y = y * (1.0 - k) + k
    rgb = np.stack([(1.0 - c) * 255.0, (1.0 - m) * 255.0, (1.0 - y) * 255.0], axis=-1)
    return rgb.astype(np.uint8)  # trunc, like Rust `as u8` on in-range values


def check_against_golden(decoder: Decoder, png_path):
    data = decoder.decode()
    info = decoder.info()
    h, w = info.height, info.width

    pixel_format = info.pixel_format
    if pixel_format == PixelFormat.L8:
        ours = np.frombuffer(data, np.uint8).reshape(h, w).astype(np.int64)
        # The reference harness's png crate applies its default STRIP_16 /
        # EXPAND transforms for the L8 comparison, so 16-bit goldens compare
        # by their high byte and 1-bit goldens expand to 0/255.
        golden = load_golden(png_path)
        if golden.dtype == np.bool_ or golden.max() <= 1:
            golden = golden.astype(np.int64) * 255
        elif golden.max() > 255:
            golden = golden.astype(np.int64) >> 8
        _compare(ours, golden, info, png_path)
        return
    elif pixel_format == PixelFormat.L16:
        ours = np.frombuffer(data, np.uint16).reshape(h, w).astype(np.int64)
    elif pixel_format == PixelFormat.RGB24:
        ours = np.frombuffer(data, np.uint8).reshape(h, w, 3).astype(np.int64)
    else:  # CMYK32
        ours = np.frombuffer(data, np.uint8).reshape(h, w, 4)
        ours = cmyk_to_rgb(ours).astype(np.int64)

    golden = load_golden(png_path)
    _compare(ours, golden, info, png_path)


def _compare(ours, golden, info, png_path):
    assert golden.shape == ours.shape, f"{golden.shape} vs {ours.shape}"
    golden = golden.astype(np.int64)
    diff = np.abs(ours - golden)
    max_diff = int(diff.max()) if diff.size else 0
    tolerance = 0 if info.coding_process == CodingProcess.LOSSLESS else 3
    assert max_diff <= tolerance, (
        f"decoding difference vs {png_path}: max diff {max_diff}, "
        f"{int((diff > tolerance).sum())} bad samples")


@pytest.mark.parametrize(
    "jpg", reftest_files(), ids=lambda p: str(p.relative_to(REFTEST_IMAGES)))
def test_reftest(jpg):
    check_against_golden(Decoder(str(jpg)), jpg.with_suffix(".png"))


@pytest.mark.parametrize(
    "jpg", reftest_files(), ids=lambda p: str(p.relative_to(REFTEST_IMAGES)))
def test_reftest_jax_exact(jpg):
    """Full-corpus jax-backend sweep: exact precision must be bit-identical
    to the numpy oracle AND pass the golden comparison."""
    d = Decoder(str(jpg), backend="jax")
    check_against_golden(d, jpg.with_suffix(".png"))
    assert Decoder(str(jpg), backend="jax").decode() == Decoder(str(jpg)).decode()


@pytest.mark.parametrize(
    "jpg", reftest_files(), ids=lambda p: str(p.relative_to(REFTEST_IMAGES)))
def test_reftest_jax_fast(jpg):
    """Full-corpus fast (matmul IDCT) precision sweep: goldens within the
    reference tolerance (lossless stays bit-exact — fast only affects the
    DCT reconstruction tail)."""
    check_against_golden(Decoder(str(jpg), backend="jax", precision="fast"),
                         jpg.with_suffix(".png"))


@pytest.mark.parametrize("size,golden", [
    ((500, 333), "rgb.png"),
    ((250, 167), "rgb_250x167.png"),
    ((125, 84), "rgb_125x84.png"),
    ((63, 42), "rgb_63x42.png"),
], ids=lambda v: str(v))
def test_reftest_scaled(size, golden):
    """Scaled decode goldens (`/root/reference/tests/reftest/mod.rs:18-25`)."""
    if not isinstance(size, tuple):
        pytest.skip()
    decoder = Decoder(str(REFTEST_IMAGES / "rgb.jpg"))
    decoder.read_info()
    decoder.scale(*size)
    check_against_golden(decoder, REFTEST_IMAGES / golden)
