"""Compressed-bits interchange through the streaming decoder.

`DeviceStreamDecoder(interchange="bits")` ships entropy-coded bytes + anchors
and Huffman-decodes on device (entropy/device_scan.py); output must be
bit-identical to the prefix interchange (which ships host-decoded
coefficients) for every image, with transparent prefix fallback for
progressive/lossless/quirk streams.
"""

import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax import CodingProcess, Decoder
from jpeg_decoder_jax.models.stream import (
    DeviceStreamDecoder,
    StagedBits,
    stage_host_bits,
)

NAMES = [
    "rgb.jpg",
    "restarts.jpg",
    "grayscale_16x24_sampling2x2.jpg",
    "mjpeg.jpg",
    "ycck.jpg",
    "16bit-qtables.jpg",
    "mozilla/jpg-progressive.jpg",     # falls back to prefix staging
    "mozilla/jpg-cmyk-1.jpg",
]


@pytest.fixture(scope="module")
def decoders():
    return (DeviceStreamDecoder(host_threads=2, interchange="prefix"),
            DeviceStreamDecoder(host_threads=2, interchange="bits"))


def test_mesh_sharded_bits_stream():
    """Bits interchange composed with mesh DP: stacked bucket-padded anchor
    arrays shard over the data axis (XLA anchored decoder vmapped per image);
    output must equal the single-device bits path, including heterogeneous
    streams (group flush on key change / ineligible images)."""
    import jax

    from jpeg_decoder_jax.parallel import make_mesh

    mesh = make_mesh({"data": 8}, jax.devices("cpu"))
    rgb = (REFTEST_IMAGES / "rgb.jpg").read_bytes()
    prog = (REFTEST_IMAGES / "mozilla/jpg-progressive.jpg").read_bytes()

    plain = DeviceStreamDecoder(host_threads=1, interchange="bits")
    sharded = DeviceStreamDecoder(host_threads=1, interchange="bits",
                                  mesh=mesh)
    stream = [rgb] * 9 + [prog] + [rgb] * 3   # 8-group, 1-tail, fallback, 3
    ref = [np.asarray(o) for o in plain.decode_stream(stream)]
    got = sharded.decode_stream(stream, batch_size=8)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert np.array_equal(a, np.asarray(b)), i


@pytest.mark.parametrize("name", NAMES)
def test_bits_matches_prefix(decoders, name):
    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip()
    prefix, bits = decoders
    data = path.read_bytes()
    a = np.asarray(prefix.decode_stream([data])[0])
    b = np.asarray(bits.decode_stream([data])[0])
    assert a.shape == b.shape
    assert (a == b).all()


def test_baseline_images_actually_stage_as_bits():
    staged = stage_host_bits(str(REFTEST_IMAGES / "rgb.jpg"))
    assert isinstance(staged, StagedBits)
    # H2D payload tracks the *compressed* size (bucketing + anchors within
    # ~45%), not the pixel count — that is the entire point.
    nbytes = sum(s.words.nbytes + s.anchor_bits.nbytes + s.anchor_block.nbytes
                 + s.anchor_slot.nbytes for s, _ in staged.scans)
    compressed = (REFTEST_IMAGES / "rgb.jpg").stat().st_size
    assert nbytes < 1.45 * compressed, f"{nbytes} vs {compressed}"


def test_large_image_bytes_per_pixel():
    staged = stage_host_bits("/root/reference/benches/large_image.jpg")
    assert isinstance(staged, StagedBits)
    nbytes = sum(s.words.nbytes + s.anchor_bits.nbytes + s.anchor_block.nbytes
                 + s.anchor_slot.nbytes for s, _ in staged.scans)
    px = staged.mpix * 1e6
    # vs ~0.9 B/px for the prefix interchange on the same content.
    assert nbytes / px < 0.3, f"{nbytes / px:.3f} B/px"


def test_progressive_transcodes_to_bits():
    """Progressive images re-encode into the bits interchange (transcode.py)
    rather than shipping prefix coefficients."""
    staged = stage_host_bits(str(REFTEST_IMAGES / "mozilla" / "jpg-progressive.jpg"))
    assert isinstance(staged, StagedBits)


def test_lossless_stages_for_device():
    """Lossless frames stage as StagedLossless (round 3): the host ships only
    the Huffman-decoded differences (mod-2^16 uint16 wire) and the predictor
    recurrence runs on device."""
    import pytest

    from jpeg_decoder_jax.models.stream import StagedLossless

    path = REFTEST_IMAGES / "lossless" / "1" / "jpeg_lossless_sel1.jpg"
    if not path.exists():
        pytest.skip("lossless corpus image missing")
    st = stage_host_bits(str(path))
    assert isinstance(st, StagedLossless)
    assert st.diffs.dtype == np.uint16


def _lossless_corpus():
    root = REFTEST_IMAGES / "lossless"
    return sorted(root.rglob("*.jpg")) if root.exists() else []


def test_lossless_stream_corpus_bit_exact(decoders):
    """Every lossless corpus image (predictors sel1-7, 8/12/16-bit, DICOM
    MR4/XA1) through the streaming service == host oracle, bit-exact
    (/root/reference/src/decoder/lossless.rs semantics; the reftest bar for
    lossless is diff == 0). No host-side fallbacks allowed on this corpus."""
    prefix, bits = decoders
    files = _lossless_corpus()
    if not files:
        import pytest
        pytest.skip("lossless corpus missing")
    for f in files:
        data = f.read_bytes()
        ref = Decoder(data, backend="numpy").decode_array()
        for dec in (prefix, bits):
            got = np.asarray(dec.decode_stream([data])[0])
            assert got.shape == ref.shape, f.name
            assert (got == ref).all(), \
                f"{f.name}: {int((got != ref).sum())} mismatches"


def test_lossless_batch_and_mesh_parity(decoders):
    """Same-geometry lossless batches merge into one vmapped device dispatch
    (and shard over a mesh data axis), bit-exact vs the host oracle."""
    prefix, _ = decoders
    files = _lossless_corpus()
    if not files:
        import pytest
        pytest.skip("lossless corpus missing")
    data = files[0].read_bytes()
    ref = Decoder(data, backend="numpy").decode_array()
    outs = prefix.decode_stream([data] * 5, batch_size=4)
    assert len(outs) == 5
    for o in outs:
        assert (np.asarray(o) == ref).all()

    import jax
    if len(jax.devices()) >= 4:
        from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
        from jpeg_decoder_jax.parallel.mesh import make_mesh
        mesh = make_mesh({"data": 4})
        sharded = DeviceStreamDecoder(host_threads=2, mesh=mesh)
        outs = sharded.decode_stream([data] * 4, batch_size=4)
        for o in outs:
            assert (np.asarray(o) == ref).all()


def test_corpus_stream_bits_sweep(decoders):
    """Every reftest image through the bits stream == prefix stream."""
    prefix, bits = decoders
    checked = 0
    for jpg in reftest_files():
        probe = Decoder(str(jpg))
        try:
            probe.read_info()
        except Exception:  # noqa: BLE001
            continue
        info = probe.info()
        if info is None or info.coding_process == CodingProcess.LOSSLESS:
            continue  # lossless renders host-side, not via the DCT stream
        data = jpg.read_bytes()
        try:
            a = prefix.decode_stream([data])[0]
        except Exception:  # noqa: BLE001 — stream-ineligible image
            continue
        b = bits.decode_stream([data])[0]
        assert (np.asarray(a) == np.asarray(b)).all(), jpg.name
        checked += 1
    assert checked >= 30


def test_scaled_decode_bits(decoders):
    """IDCT-domain scaling through the bits interchange (dct_scale < 8)."""
    prefix, bits = decoders
    data = (REFTEST_IMAGES / "rgb.jpg").read_bytes()
    a = prefix.decode_stream([data], scale_to=(125, 84))[0]
    b = bits.decode_stream([data], scale_to=(125, 84))[0]
    assert np.asarray(a).shape == (84, 125, 3)
    assert (np.asarray(a) == np.asarray(b)).all()


@pytest.mark.parametrize("name,scale_to", [
    ("rgb.jpg", (60, 60)),                    # dct_scale 4, H2V2 chroma
    ("rgb.jpg", (30, 30)),                    # dct_scale 2
    ("rgb.jpg", (8, 8)),                      # dct_scale 1 (DC only)
    ("grayscale_square.jpg", (40, 40)),       # single-component
    ("ycck.jpg", (40, 40)),                   # 4-component YCCK
    ("restarts.jpg", (20, 20)),               # restart-interval stream
])
def test_scaled_decode_bits_small_scales(decoders, name, scale_to):
    """Scaled bits decode at genuine 4x4/2x2/1x1 Dugad-Ahuja kernel sizes
    (`/root/reference/src/idct.rs:454-565`) must match the numpy oracle
    within the fast-tier tolerance (the fast scaled basis is the float
    linearization of the exact integer kernels)."""
    _prefix, bits = decoders
    path = REFTEST_IMAGES / name
    d = Decoder(str(path), backend="numpy")
    d.scale(*scale_to)
    ref = d.decode_array()
    got = np.asarray(bits.decode_stream([path.read_bytes()],
                                        scale_to=scale_to)[0])
    assert got.shape == ref.shape
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 3


def test_mesh_kernel_pipeline_runs(monkeypatch):
    """The Pallas kernel inside the mesh program's shard_map (interpret
    mode): each device merges its local images into one sweep; outputs
    equal the oracle."""
    import functools

    import jax

    from jpeg_decoder_jax import platform
    from jpeg_decoder_jax.entropy import triton_decode
    from jpeg_decoder_jax.parallel import make_mesh
    from jpeg_decoder_jax.testing.synth import make_jpeg

    monkeypatch.setattr(platform, "entropy_engine", lambda on=None: "triton")
    monkeypatch.setattr(triton_decode, "build_triton_sweep", functools.partial(
        triton_decode.build_triton_sweep, interpret=True))
    data = make_jpeg("420", 32, 16, seed=3)
    mesh = make_mesh({"data": 2}, jax.devices("cpu")[:2])
    dec = DeviceStreamDecoder(host_threads=1, interchange="bits", mesh=mesh,
                              precision="exact")
    outs = dec.decode_stream([data] * 4, batch_size=4)
    assert dict(dec.counts) == {"dispatches": 1, "sweeps": 1}
    gold = Decoder(data, backend="numpy").decode_array()
    for out in outs:
        assert np.array_equal(np.asarray(out), gold)


def test_mesh_bits_group_is_one_sweep():
    """Mesh DP routing: a group of same-plan images stacks on the sharded
    image axis and runs one sweep per dispatch (a 4-image group plus a
    1-image tail here); outputs equal the prefix interchange."""
    import jax

    from jpeg_decoder_jax.parallel import make_mesh
    from jpeg_decoder_jax.testing.synth import make_jpeg

    data = make_jpeg("420", 48, 32, seed=4)
    mesh = make_mesh({"data": 4}, jax.devices("cpu")[:4])
    sharded = DeviceStreamDecoder(host_threads=1, interchange="bits",
                                  mesh=mesh)
    plain = DeviceStreamDecoder(host_threads=1, interchange="prefix")
    ref = np.asarray(plain.decode_stream([data])[0])
    got = sharded.decode_stream([data] * 5, batch_size=4)
    assert dict(sharded.counts) == {"dispatches": 2, "sweeps": 2}
    assert len(got) == 5
    for out in got:
        assert np.array_equal(ref, np.asarray(out))
