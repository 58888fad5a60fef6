"""Host-parallel anchored entropy staging (non-DRI intra-image parallelism).

`jt_decode_scan_dct_prefix_anchored` (entropy/cpp/entropy.cc) re-decodes
disjoint MCU spans of the prescan-unstuffed stream from MCU-aligned anchors
with zero-seeded DC predictors, then applies per-span DC offsets — the
DRI-less analog of the restart-segment splitter (reference behavior anchor:
/root/reference/src/decoder.rs:910-956). Output must be identical to the
serial prefix staging for every eligible image; ineligible/irregular streams
must fall back transparently.
"""

import os

import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax.entropy.native import get_native
from jpeg_decoder_jax.models import stream as stream_mod

pytestmark = pytest.mark.skipif(
    get_native() is None, reason="native entropy kernel unavailable")

LARGE = "/root/reference/benches/large_image.jpg"


def _stage(path, anchored, monkeypatch):
    monkeypatch.setenv("JPEG_JAX_ANCHORED", "1" if anchored else "0")
    return stream_mod.stage_host(path)


def _resid_set(staged):
    return sorted(
        (i, v) for i, v in zip(staged.resid_idx.tolist(),
                               staged.resid_vals.tolist())
        if i < staged.total_coeffs and v != 0)


@pytest.mark.parametrize("name", [
    "rgb.jpg",
    "grayscale_16x24_sampling2x2.jpg",
    "16bit-qtables.jpg",
    "mozilla/jpg-cmyk-1.jpg",
    "ycck.jpg",
])
def test_anchored_matches_serial(name, monkeypatch):
    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip()
    a = _stage(str(path), True, monkeypatch)
    b = _stage(str(path), False, monkeypatch)
    assert np.array_equal(a.dc, b.dc)
    assert np.array_equal(a.ac, b.ac)
    assert _resid_set(a) == _resid_set(b)


def test_anchored_engages_and_matches_on_large(monkeypatch):
    """On large_image the anchored kernel must actually run (not fall back)
    and produce byte-identical staging — the non-vacuous version of the
    parity test above (small images are rejected by the MCU threshold)."""
    if (os.cpu_count() or 1) < 2:
        pytest.skip("needs >=2 cores")
    if not os.path.exists(LARGE):
        pytest.skip()
    ran = []
    orig = stream_mod.PrefixCapture._try_anchored

    def spy(self, *args, **kwargs):
        r = orig(self, *args, **kwargs)
        ran.append(r is not None)
        return r

    monkeypatch.setattr(stream_mod.PrefixCapture, "_try_anchored", spy)
    a = _stage(LARGE, True, monkeypatch)
    assert any(ran), "anchored path fell back on an eligible image"
    b = _stage(LARGE, False, monkeypatch)
    assert np.array_equal(a.dc, b.dc)
    assert np.array_equal(a.ac, b.ac)
    assert _resid_set(a) == _resid_set(b)


def test_anchored_full_corpus_decode(monkeypatch):
    """Every reftest image decodes identically with the anchored gate forced
    on: eligible scans decode in parallel, everything else (progressive,
    lossless, DRI, tiny, malformed-adjacent) must fall back losslessly."""
    monkeypatch.setenv("JPEG_JAX_ANCHORED", "1")
    checked = 0
    for path in reftest_files():
        try:
            a = stream_mod.stage_host(str(path))
        except Exception:
            continue
        if isinstance(a, stream_mod.StagedLossless):
            continue  # lossless ships diffs, not prefix coefficients
        monkeypatch.setenv("JPEG_JAX_ANCHORED", "0")
        b = stream_mod.stage_host(str(path))
        monkeypatch.setenv("JPEG_JAX_ANCHORED", "1")
        assert np.array_equal(a.dc, b.dc), path
        assert np.array_equal(a.ac, b.ac), path
        assert _resid_set(a) == _resid_set(b), path
        checked += 1
    assert checked >= 20
