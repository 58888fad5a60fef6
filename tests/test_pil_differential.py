"""Independent-decoder differential: full corpus vs PIL/libjpeg.

The reference's fail_tmin fuzz target diffs against mozjpeg — an oracle that
shares no code with the implementation
(`/root/reference/fuzz/fuzz_targets/fail_tmin.rs:36-67`). Here PIL (libjpeg)
plays that role on every valid corpus image whose output format maps cleanly
(L8/RGB24): agreement within the reference's ±3 bar. A spec misreading shared
by this framework's native and Python engines (which agree by construction)
would surface here.
"""

import io

import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax import CodingProcess, Decoder, JpegError, PixelFormat


def _pil():
    """Pillow, or a skip of the calling test when it is not installed."""
    return pytest.importorskip("PIL.Image")


def _comparable(path):
    """(ours, theirs) arrays, or None when PIL can't play oracle."""
    data = path.read_bytes()
    d = Decoder(data)
    try:
        ours = d.decode()
    except JpegError:
        return None
    info = d.info()
    if info.coding_process == CodingProcess.LOSSLESS:
        return None  # PIL has no SOF3 support
    try:
        im = _pil().open(io.BytesIO(data))
        im.load()
    except Exception:  # noqa: BLE001
        return None
    want = {PixelFormat.L8: "L", PixelFormat.RGB24: "RGB"}.get(info.pixel_format)
    if want is None or im.mode != want:
        return None
    theirs = np.asarray(im)
    return np.frombuffer(ours, np.uint8).reshape(theirs.shape), theirs


@pytest.mark.parametrize(
    "jpg", reftest_files(), ids=lambda p: str(p.relative_to(REFTEST_IMAGES)))
def test_pil_agreement(jpg):
    pair = _comparable(jpg)
    if pair is None:
        pytest.skip("PIL cannot oracle this format")
    ours, theirs = pair
    diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
    assert int(diff.max()) <= 3, (
        f"PIL divergence: max {int(diff.max())}, "
        f"{int((diff > 3).sum())} samples beyond tolerance")


def test_pil_oracle_actually_engaged():
    """Guard: the sweep above must compare a substantial share of the corpus,
    not skip everything."""
    compared = sum(1 for p in reftest_files() if _comparable(p) is not None)
    assert compared >= 25
