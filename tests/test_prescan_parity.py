"""Native (C++ jt_prescan_baseline) vs Python-mirror prescan layout parity.

The bits-interchange wire format — unstuffed segment layout, anchors, chunk
ends, symbol counts — must be byte-for-byte identical whichever prescan built
it, because both device entropy engines consume it positionally and the
persistent compile cache keys on the bucketed shapes. The fixed per-segment
24-byte pad (entropy.cc jt_prescan_baseline phase 1 / device_scan.py
prescan_baseline) is the shared contract; this test pins it on both DRI
(parallel per-segment walk) and non-DRI (single segment) streams.
"""

import io
import os

import numpy as np
import pytest

import jpeg_decoder_jax.entropy.native as native_mod
from conftest import REFTEST_IMAGES

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.entropy.device_scan import (
    PrescanFallback,
    prescan_baseline,
)


def _pil():
    """Pillow, or a skip of the calling test when it is not installed."""
    return pytest.importorskip("PIL.Image")


class _Capture:
    """Decoder hook recording every baseline scan's staged layout."""

    def __init__(self):
        self.scans = []   # (pending_marker, AnchoredScan)

    def wants(self, frame) -> bool:
        return True

    def decode_scan(self, decoder, frame, scan, finished):
        marker, staged = prescan_baseline(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval)
        self.scans.append((marker, staged))
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
        return marker


def _prescan(data, disable_native: bool):
    if disable_native:
        os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    else:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
    native_mod.reset_native_cache()
    try:
        d = Decoder(data)
        cap = _Capture()
        d._prefix_capture = cap
        d._decode_entropy_only()
        return cap.scans
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()


def _assert_layout_equal(name, native_scans, mirror_scans):
    assert len(native_scans) == len(mirror_scans), name
    for si, ((nm, ns), (mm, ms)) in enumerate(zip(native_scans, mirror_scans)):
        ctx = f"{name} scan {si}"
        assert nm == mm, f"{ctx}: pending marker {nm} != {mm}"
        assert ns.n_items == ms.n_items, f"{ctx}: anchor count"
        assert ns.n_blocks == ms.n_blocks, f"{ctx}: n_blocks"
        for field in ("words", "anchor_bits", "anchor_block", "anchor_slot",
                      "chunk_end", "chunk_syms"):
            a, b = getattr(ns, field), getattr(ms, field)
            if a is None or b is None:
                assert a is b, f"{ctx}: {field} presence"
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, f"{ctx}: {field} shape {a.shape} != {b.shape}"
            bad = np.flatnonzero(a != b)
            assert bad.size == 0, (
                f"{ctx}: {field} differs at {bad[:5]} "
                f"native={a[bad[:5]]} mirror={b[bad[:5]]}")


def _make_dri_jpeg(h, w, restart_rows=1, mode="RGB", seed=0):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    buf = io.BytesIO()
    _pil().fromarray(arr, mode).save(buf, "JPEG", quality=85,
                                    restart_marker_rows=restart_rows)
    return buf.getvalue()


CORPUS = [
    "rgb.jpg",
    "restarts.jpg",                       # DRI
    "grayscale_16x24_sampling2x2.jpg",
    "mjpeg.jpg",
    "16bit-qtables.jpg",
    "mozilla/jpg-size-1x1.jpg",
    "mozilla/jpg-cmyk-1.jpg",
    "ycck.jpg",
]


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_prescan_layout_parity(name):
    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip(f"{name} not in corpus")
    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    data = path.read_bytes()
    try:
        native_scans = _prescan(data, disable_native=False)
    except PrescanFallback as e:
        pytest.skip(f"prescan fallback: {e}")
    mirror_scans = _prescan(data, disable_native=True)
    _assert_layout_equal(name, native_scans, mirror_scans)


@pytest.mark.parametrize("shape,mode,rows,seed", [
    ((512, 768), "RGB", 1, 0),    # ~64 segments — engages the threaded walk
    ((320, 320), "RGB", 2, 1),
    ((264, 120), "L", 1, 2),      # ragged right/bottom MCUs
])
def test_dri_prescan_layout_parity(shape, mode, rows, seed):
    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    data = _make_dri_jpeg(*shape, restart_rows=rows, mode=mode, seed=seed)
    native_scans = _prescan(data, disable_native=False)
    mirror_scans = _prescan(data, disable_native=True)
    assert native_scans and native_scans[0][1].n_items > 8, \
        "expected a multi-anchor DRI prescan"
    _assert_layout_equal(f"dri{shape}", native_scans, mirror_scans)


def _prescan_spec(data, spec_env: str):
    """Native prescan with the speculative-split threshold forced."""
    os.environ["JPEG_JAX_SPEC_PRESCAN"] = spec_env
    try:
        return _prescan(data, disable_native=False)
    finally:
        os.environ.pop("JPEG_JAX_SPEC_PRESCAN", None)


SPEC_CASES = [
    # (source, kwargs) — each synthesized large enough that a 4 KiB
    # threshold splits it across all walker threads.
    ("synth", dict(shape=(512, 768), mode="RGB")),     # 4:2:0, 2 tables
    ("synth", dict(shape=(768, 512), mode="L")),       # grayscale, uniform
    ("file", "/root/reference/benches/large_image.jpg"),  # 4:4:4, distinct
]


@pytest.mark.parametrize("kind,spec", SPEC_CASES)
def test_speculative_prescan_layout_parity(kind, spec):
    """The speculative parallel walk (entropy.cc spec_walk_span + stitcher)
    must produce anchors/chunks byte-identical to the serial walk and the
    Python mirror — speculation may only move time, never bytes."""
    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    if kind == "file":
        if not os.path.exists(spec):
            pytest.skip("bench image unavailable")
        data = open(spec, "rb").read()
    else:
        rng = np.random.default_rng(11)
        shape = spec["shape"] + ((3,) if spec["mode"] == "RGB" else ())
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        buf = io.BytesIO()
        _pil().fromarray(arr, spec["mode"]).save(buf, "JPEG", quality=92)
        data = buf.getvalue()
    spec_scans = _prescan_spec(data, "4096")
    serial_scans = _prescan_spec(data, "0")
    _assert_layout_equal("spec-vs-serial", spec_scans, serial_scans)
    mirror_scans = _prescan(data, disable_native=True)
    _assert_layout_equal("spec-vs-mirror", spec_scans, mirror_scans)


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("disable_native", [False, True])
def test_restart_underrun_falls_back_to_oracle_error(disable_native):
    """Fuzz regression (seed-7 mutant 624): a scan whose entropy data holds
    a full unconsumed byte before an expected RSTn. The oracle's take_marker
    finds data where the marker must be ("no marker found where RST3 was
    expected", decoder.rs:944-951); the prescan used to ACCEPT the stream
    (it walks exactly the MCU budget and ignored the unconsumed tail), so
    the device path would render pixels where every host tier raises. Both
    prescan mirrors must fall back so the host path owns the error."""
    if not disable_native and native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    data = open(os.path.join(
        FIXTURES, "restart_underrun_prescan.jpg"), "rb").read()
    with pytest.raises(PrescanFallback):
        _prescan(data, disable_native=disable_native)

    from jpeg_decoder_jax.errors import FormatError
    if disable_native:
        os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    else:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
    native_mod.reset_native_cache()
    try:
        with pytest.raises(FormatError, match="no marker found where RST3"):
            Decoder(data).decode_array()
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()


def test_oversize_scan_layout_falls_back(monkeypatch):
    """Anchor bit offsets ride the wire as uint32: a >=2^29-byte unstuffed
    layout must route to the host path in the Python mirror (entropy.cc
    carries the same guard on write_off), not wrap silently."""
    import jpeg_decoder_jax.entropy.device_scan as ds
    import jpeg_decoder_jax.entropy.native as native_pkg

    # Force the Python-mirror walk: the native path would run its own
    # (C-side) guard against the REAL stream and never see the fake segs.
    monkeypatch.setattr(native_pkg, "get_native", lambda: None)

    data = open(f"{REFTEST_IMAGES}/rgb.jpg", "rb").read()
    d = Decoder(data, backend="numpy")

    class _FakeSeg:
        """len() reports huge without allocating 512 MB."""

        def __init__(self, n):
            self._n = n

        def __len__(self):
            return self._n

    real_unstuff = ds.unstuff_scan

    def fake_unstuff(buf, pos):
        segments, rst_nums, end_pos, pending, hit_eof = real_unstuff(buf, pos)
        return ([_FakeSeg(1 << 29)] + list(segments[1:]),
                rst_nums, end_pos, pending, hit_eof)

    monkeypatch.setattr(ds, "unstuff_scan", fake_unstuff)

    captured = _Capture()
    d._prefix_capture = None

    class _Probe:
        def wants(self, frame):
            return True

        def decode_scan(self, decoder, frame, scan, finished):
            with pytest.raises(PrescanFallback, match="uint32 anchor"):
                prescan_baseline(
                    decoder._cursor, frame, scan,
                    decoder._dc_huffman_tables, decoder._ac_huffman_tables,
                    decoder._restart_interval)
            raise _Done()

    class _Done(Exception):
        pass

    d._prefix_capture = _Probe()
    with pytest.raises(_Done):
        d._decode_entropy_only()
