"""Fast (f32 matmul IDCT) precision mode must stay within the reference tolerance.

The reference ships non-bit-identical SIMD kernels by default with a
`platform_independent` opt-out (`/root/reference/src/arch/mod.rs:13-57`); our
"fast"/"exact" split mirrors that contract. Every lossy golden must stay
within the +-3 reftest tolerance in fast mode; lossless is unaffected (no
IDCT in SOF3).
"""

import pytest

from conftest import REFTEST_IMAGES

from jpeg_decoder_jax import Decoder
from test_reftest import check_against_golden

CASES = [
    "rgb.jpg",
    "mozilla/jpg-progressive.jpg",
    "mozilla/jpg-cmyk-1.jpg",
    "grayscale_16x24_sampling2x2.jpg",
    "restarts.jpg",
    "mjpeg.jpg",
    "16bit-qtables.jpg",
    "progressive3.jpg",
    "mozilla/jpg-size-1x1.jpg",
]


@pytest.mark.parametrize("name", CASES)
def test_fast_within_tolerance(name):
    d = Decoder(str(REFTEST_IMAGES / name), precision="fast")
    check_against_golden(d, (REFTEST_IMAGES / name).with_suffix(".png"))


@pytest.mark.parametrize("name", ["rgb.jpg", "mjpeg.jpg"])
def test_fast_jax_matches_fast_numpy(name):
    path = str(REFTEST_IMAGES / name)
    a = Decoder(path, backend="jax", precision="fast").decode()
    b = Decoder(path, backend="numpy", precision="fast").decode()
    assert a == b
