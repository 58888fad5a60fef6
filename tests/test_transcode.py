"""Transcode (store -> bits interchange re-encode) correctness.

The transcoder (entropy/transcode.py) re-encodes host-decoded coefficient
stores as anchored-chunk symbol streams for the device Huffman kernels —
the bits-interchange path for progressive and quirk streams. These tests pin:
store-level bit-exact roundtrips through the XLA device decoder, the extended
alphabet's edge values (DC category 16, AC size 15), pixel parity for the
full progressive corpus through the stream service, and the Pallas kernel
(interpret mode) on a transcoded scan.
"""

import io
import os

import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax import CodingProcess, Decoder
from jpeg_decoder_jax.entropy.device_scan import decode_anchored_device
from jpeg_decoder_jax.entropy.transcode import (
    TranscodeFallback,
    _encode_luts,
    transcode_scan,
    transcode_tables,
)


def _pil():
    """Pillow, or a skip of the calling test when it is not installed."""
    return pytest.importorskip("PIL.Image")


def _oracle_stores(path_or_bytes):
    d = Decoder(path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
                else str(path_or_bytes))
    d._decode_entropy_only()
    n = len(d.frame.components)
    stores = [np.asarray(d._pending_render[i][0]).reshape(-1)
              for i in range(n)]
    return d.frame, stores


def _roundtrip_assert(frame, stores, label):
    scan, staged = transcode_scan(frame, stores)
    out = decode_anchored_device(staged)
    for c, (a, b) in enumerate(zip(out, stores)):
        a = np.asarray(a)
        bad = np.flatnonzero(a != b)
        assert bad.size == 0, (
            f"{label} comp {c}: {bad.size} mismatches, first {bad[:5]} "
            f"got {a[bad[:5]]} want {b[bad[:5]]}")


def test_tables_roundtrip_all_symbols():
    """Every encoder (code, len) must decode back to its symbol through the
    same 16-bit LUT the device uses."""
    from jpeg_decoder_jax.entropy.device_scan import build_decode_lut16

    dc_table, ac_table = transcode_tables()
    dc_code, dc_len, ac_code, ac_len = _encode_luts()
    for table, codes, lens, syms in (
            (dc_table, dc_code, dc_len, range(17)),
            (ac_table, ac_code, ac_len,
             [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 16)])):
        lut = build_decode_lut16(table)
        for sym in syms:
            ln = int(lens[sym])
            assert 1 <= ln <= 16, f"symbol {sym:#x} has no code"
            win = int(codes[sym]) << (16 - ln)
            entry = int(lut[win])
            assert entry & 0xFF == sym
            assert (entry >> 8) & 0x1F == ln


BASELINE_CASES = [
    "rgb.jpg",                           # 4:4:4 color
    "grayscale_16x24_sampling2x2.jpg",
    "restarts.jpg",
    "16bit-qtables.jpg",
    "mozilla/jpg-size-1x1.jpg",
    "mozilla/jpg-cmyk-1.jpg",
    "ycck.jpg",
]


@pytest.mark.parametrize("name", BASELINE_CASES)
def test_store_roundtrip_corpus(name):
    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip(f"{name} not in corpus")
    frame, stores = _oracle_stores(path)
    _roundtrip_assert(frame, stores, name)


def _tiny_frame(nblocks_w=2, nblocks_h=2):
    """A real grayscale frame of the requested block grid (via PIL)."""
    arr = np.zeros((nblocks_h * 8, nblocks_w * 8), np.uint8)
    buf = io.BytesIO()
    _pil().fromarray(arr, "L").save(buf, "JPEG", quality=95)
    d = Decoder(buf.getvalue())
    d._decode_entropy_only()
    return d.frame


def test_extreme_values_roundtrip():
    """DC swings across the full int16 range (wrap16 diffs up to category
    16) and AC magnitudes to +-32767 (size 15) must round-trip exactly."""
    frame = _tiny_frame(4, 2)
    nb = frame.components[0].block_size.width \
        * frame.components[0].block_size.height
    rng = np.random.default_rng(0)
    store = rng.integers(-32767, 32768, (nb, 64), np.int64).astype(np.int16)
    store[0, 0] = -32768        # DC may be any int16
    store[1, 0] = 32767         # diff 65535 -> wrap16 -1
    store[2, 0] = -32768        # diff -65535 -> wrap16 +1
    _roundtrip_assert(frame, [store.reshape(-1)], "extreme")


def test_ac_min_int16_falls_back():
    """AC == -32768 needs a 16-bit AC size the alphabet lacks."""
    frame = _tiny_frame(2, 2)
    nb = frame.components[0].block_size.width \
        * frame.components[0].block_size.height
    store = np.zeros((nb, 64), np.int16)
    store[0, 5] = -32768
    with pytest.raises(TranscodeFallback):
        transcode_scan(frame, [store.reshape(-1)])


def test_sparse_and_dense_blocks():
    """ZRL chains (runs > 16), EOB-less full blocks, all-zero blocks."""
    frame = _tiny_frame(4, 2)
    nb = frame.components[0].block_size.width \
        * frame.components[0].block_size.height
    store = np.zeros((nb, 64), np.int16)
    store[0, 63] = 1            # run of 62 -> 3 ZRLs + (14, s)
    store[1, :] = 7             # dense block, no EOB
    store[2, 1] = -1            # minimal AC
    # store[3+] all zero: DC cat 0 + EOB only
    _roundtrip_assert(frame, [store.reshape(-1)], "patterns")


NATIVE_MIRROR_CASES = [
    "rgb.jpg",
    "grayscale_16x24_sampling2x2.jpg",
    "mozilla/jpg-cmyk-1.jpg",
    "mozilla/jpg-progressive.jpg",
    "progressive3.jpg",
    "mozilla/jpg-size-1x1.jpg",
]


@pytest.mark.parametrize("name", NATIVE_MIRROR_CASES)
def test_native_mirror_byte_identity(name):
    """The C++ encoder (entropy.cc jt_transcode_scan) and the Python mirror
    must produce identical staged layouts — the repo's native/oracle
    invariant extended to the encode direction."""
    import jpeg_decoder_jax.entropy.native as native_mod

    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip(f"{name} not in corpus")
    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")

    def staged_for(disable):
        if disable:
            os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
        else:
            os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()
        try:
            frame, stores = _oracle_stores(path)
            return transcode_scan(frame, stores)[1]
        finally:
            os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
            native_mod.reset_native_cache()

    sn, sp = staged_for(False), staged_for(True)
    assert sn.n_items == sp.n_items and sn.n_blocks == sp.n_blocks
    for f in ("words", "anchor_bits", "anchor_block", "anchor_slot",
              "chunk_end", "chunk_syms"):
        a, b = np.asarray(getattr(sn, f)), np.asarray(getattr(sp, f))
        assert a.shape == b.shape, f"{f} shape"
        bad = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
        assert bad.size == 0, f"{f} differs at {bad[:5]}"


def test_native_extreme_values_matches_mirror():
    """Full-range random stores (the extended alphabet's edge categories)
    through both encoders: identical layouts, exact roundtrip."""
    import jpeg_decoder_jax.entropy.native as native_mod

    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    frame = _tiny_frame(6, 4)
    nb = frame.components[0].block_size.width \
        * frame.components[0].block_size.height
    rng = np.random.default_rng(7)
    store = rng.integers(-32767, 32768, (nb, 64), np.int64).astype(np.int16)
    store[0, 0] = -32768
    stores = [store.reshape(-1)]

    _, sn = transcode_scan(frame, stores)
    os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    native_mod.reset_native_cache()
    try:
        _, sp = transcode_scan(frame, stores)
    finally:
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()
    for f in ("words", "anchor_bits", "anchor_block", "anchor_slot",
              "chunk_end", "chunk_syms"):
        assert (np.asarray(getattr(sn, f))
                == np.asarray(getattr(sp, f))).all(), f
    out = decode_anchored_device(sn)
    assert (np.asarray(out[0]) == stores[0]).all()


def test_progressive_corpus_pixel_parity():
    """Every progressive reftest image through the bits stream service
    (which transcodes) must match the host fast-precision decode exactly."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder, StagedBits, stage_host_bits

    dec = DeviceStreamDecoder(interchange="bits")
    ran = 0
    for jpg in reftest_files():
        probe = Decoder(str(jpg))
        try:
            probe.read_info()
        except Exception:  # noqa: BLE001
            continue
        info = probe.info()
        if info is None or info.coding_process != CodingProcess.DCT_PROGRESSIVE:
            continue
        try:
            golden = np.frombuffer(
                Decoder(str(jpg), precision="fast").decode(), np.uint8)
        except Exception:  # noqa: BLE001
            continue
        st = stage_host_bits(str(jpg))
        assert isinstance(st, StagedBits), f"{jpg.name} did not transcode"
        out = np.asarray(dec.decode_one(st)).reshape(-1)
        assert out.shape == golden.shape and (out == golden).all(), jpg.name
        ran += 1
    assert ran >= 5, f"only {ran} progressive images exercised the transcoder"


def test_progressive_scaled_decode_parity():
    """Transcoded bits path under IDCT-domain scaling."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder, StagedBits, stage_host_bits

    path = REFTEST_IMAGES / "progressive3.jpg"
    d = Decoder(str(path), precision="fast")
    w, h = d.scale(80, 60)
    golden = np.frombuffer(d.decode(), np.uint8)
    st = stage_host_bits(str(path), scale_to=(80, 60))
    assert isinstance(st, StagedBits)
    dec = DeviceStreamDecoder(interchange="bits")
    out = np.asarray(dec.decode_one(st)).reshape(-1)
    assert (out == golden).all()


def test_triton_interpret_transcoded_scan():
    """The Pallas kernel decodes a transcoded stream (synthesized tables,
    extended DC categories) bit-exactly — interpret mode, tiny image."""
    import jax

    from jpeg_decoder_jax.entropy.device_scan import build_xla_sweep
    from jpeg_decoder_jax.entropy.triton_decode import build_triton_sweep
    from jpeg_decoder_jax.models.stream import StagedBits, stage_host_bits
    from jpeg_decoder_jax.testing.synth import make_jpeg

    st = stage_host_bits(make_jpeg("progressive", 48, 32, seed=2))
    assert isinstance(st, StagedBits)
    staged = st.scans[0][0]
    assert staged.luts_key[0] == "transcode"
    plan = staged.plan
    args = (staged.words, staged.anchor_bits, staged.anchor_block,
            staged.anchor_slot, staged.luts)
    ref = jax.jit(build_xla_sweep(plan.n_blocks, plan.s_max,
                                  tuple(plan.pattern)))(*args)
    got = jax.jit(build_triton_sweep(plan.n_blocks, plan.s_max,
                                     tuple(plan.pattern),
                                     interpret=True))(*args)
    assert np.array_equal(np.asarray(ref), np.asarray(got))


def test_batched_stream_groups_transcoded_images():
    """Same-size progressive images share plans and static tables, so the
    batched bits dispatch must group them; outputs match singles."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder

    rng = np.random.default_rng(1)
    sources = []
    for i in range(3):
        arr = rng.integers(0, 256, (40, 56, 3), np.uint8)
        buf = io.BytesIO()
        _pil().fromarray(arr, "RGB").save(buf, "JPEG", quality=90,
                                         progressive=True)
        sources.append(buf.getvalue())

    dec = DeviceStreamDecoder(interchange="bits")
    singles = [np.asarray(x) for x in dec.decode_stream(sources)]
    batched = [np.asarray(x) for x in
               dec.decode_stream(sources, batch_size=3)]
    for i, (a, b) in enumerate(zip(singles, batched)):
        assert (a == b).all(), f"image {i}"
        golden = np.frombuffer(
            Decoder(sources[i], precision="fast").decode(),
            np.uint8).reshape(a.shape)
        assert (a == golden).all(), f"image {i} vs host"
