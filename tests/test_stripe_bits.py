"""Stripe-sharded bits pipeline: one image's device entropy decode +
assembly + reconstruction across N mesh devices (parallel/stripe_bits.py).

Bit-exactness bar: pixels equal the numpy oracle decode exactly (the stripe
recon runs the exact integer kernels), across geometries that exercise every
seam mechanism — the straddling chunk (anchors never land on MCU-row
boundaries), the cross-stripe DC carry, aligned restart segmentation, and
the V2 chroma halo. The XLA engine runs compiled here (8-device virtual CPU
mesh); the Pallas kernel runs in the interpreter on a small image.
"""

import io

import numpy as np
import pytest

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.models.stream import DeviceStreamDecoder, stage_host_bits
from jpeg_decoder_jax.parallel.stripe_bits import (
    decode_bits_striped,
    split_anchored_stripes,
)



def _mesh(n):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(devs[:n]).reshape(n), ("stripe",))


def _jpeg(h, w, mode="RGB", seed=0, **save_kw):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    if mode == "L":
        im = PIL.fromarray(rng.integers(0, 255, (h, w)).astype(np.uint8), "L")
    else:
        im = PIL.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    b = io.BytesIO()
    im.save(b, format="JPEG", quality=80, **save_kw)
    return b.getvalue()


CASES = [
    # (name, seed, h, w, mode, n_stripes, save_kw) — heights deliberately
    # not multiples of the stripe extent so the crop region and the
    # truncated final chunk are exercised. Seeds are FIXED integers so a
    # failure reproduces across processes (hash() is salted per process).
    ("420", 101, 488, 648, "RGB", 8, dict(subsampling=2)),
    ("444", 102, 333, 500, "RGB", 8, dict(subsampling=0)),
    ("422", 103, 256, 256, "RGB", 8, dict(subsampling=1)),
    ("gray", 104, 300, 400, "L", 8, {}),
    ("420-dri-aligned", 105, 512, 512, "RGB", 4,
     dict(subsampling=2, restart_marker_blocks=4)),
    # One restart segment per stripe exactly (seg_blocks == n_c): DC resets
    # AT the stripe entry, so the seam carry must be suppressed — round-5
    # review-confirmed bug, wrong in every structured/fused assembler
    # before the fix.
    ("420-dri-one-seg-per-stripe", 106, 512, 512, "RGB", 4,
     dict(subsampling=2, restart_marker_blocks=256)),
    ("444-small", 107, 64, 64, "RGB", 8, dict(subsampling=0)),
    ("420-mesh4-odd", 108, 100, 90, "RGB", 4, dict(subsampling=2)),
]


@pytest.mark.parametrize("name,seed,h,w,mode,n,save_kw",
                         CASES, ids=[c[0] for c in CASES])
def test_striped_bits_matches_oracle(name, seed, h, w, mode, n, save_kw):
    data = _jpeg(h, w, mode, seed=seed, **save_kw)
    mesh = _mesh(n)
    st = stage_host_bits(data)
    out = decode_bits_striped(st, mesh, engine="xla")
    assert out is not None, "expected stripe-eligible image"
    px = np.asarray(out)
    gold = Decoder(data, backend="numpy").decode_array()
    assert px.shape == gold.shape
    bad = np.flatnonzero(px != gold)
    assert bad.size == 0, f"{bad.size} pixel mismatches"


def test_giant_image_30mpix():
    """The capability the stripe path exists for: a >=30 Mpix baseline JPEG
    decodes with its entropy decode sharded across 8 devices, bit-exact vs
    the single-device oracle (VERDICT round-4 item 1's done-bar). Smooth
    synthesized content keeps the host staging/oracle cost test-sized."""
    PIL = pytest.importorskip("PIL.Image")
    h, w = 4800, 6400                                  # 30.7 Mpix
    rng = np.random.default_rng(1)
    base = rng.integers(0, 255, (h // 16, w // 16, 3)).astype(np.uint8)
    arr = np.asarray(PIL.fromarray(base).resize((w, h), PIL.BILINEAR))
    b = io.BytesIO()
    PIL.fromarray(arr).save(b, format="JPEG", quality=85, subsampling=2)
    data = b.getvalue()

    mesh = _mesh(8)
    st = stage_host_bits(data)
    out = decode_bits_striped(st, mesh, engine="xla")
    assert out is not None
    gold = Decoder(data, backend="numpy").decode_array()
    assert np.array_equal(np.asarray(out), gold)


def test_unaligned_dri_declines():
    """Restart segments that would straddle a stripe must decline (the DC
    reset position would be mis-modeled by the local segmented prefix sum).
    Ri=3 MCUs over 32-MCU rows with 8-row stripes never aligns."""
    data = _jpeg(512, 512, "RGB", seed=11, subsampling=2,
                 restart_marker_blocks=3)
    st = stage_host_bits(data)
    assert split_anchored_stripes(st.scans[0][0], 4) is None


def test_decoder_method_and_fallback():
    """DeviceStreamDecoder.decode_striped routes eligible images through
    the stripe pipeline and falls back to the single-device path (same
    pixels, unsharded) for ineligible ones."""
    mesh = _mesh(4)
    dec = DeviceStreamDecoder(host_threads=1, interchange="bits", mesh=mesh)
    data = _jpeg(200, 240, "RGB", seed=3, subsampling=2)
    out = np.asarray(dec.decode_striped(data, stripe_axis="stripe",
                                        engine="xla"))
    gold = Decoder(data, backend="numpy").decode_array()
    assert np.array_equal(out, gold)

    # Ineligible (16x16: fewer MCU rows than stripes) -> falls back to the
    # single-device pipeline, still correct within fast-precision tolerance.
    data2 = _jpeg(16, 16, "RGB", seed=4, subsampling=2)
    st2 = stage_host_bits(data2)
    from jpeg_decoder_jax.parallel.stripe_bits import split_anchored_stripes
    assert split_anchored_stripes(st2.scans[0][0], 4) is None
    out2 = np.asarray(dec.decode_striped(data2))
    gold2 = Decoder(data2, backend="numpy").decode_array()
    assert out2.shape == gold2.shape
    assert np.abs(out2.astype(int) - gold2.astype(int)).max() <= 3


def test_dp_sp_bits_batch():
    """Full DP x SP composition on the bits path: a batch of same-layout
    images sharded over the data axis, each image's entropy decode striped
    over the stripe axis — bit-exact per image vs the oracle."""
    import jax
    from jax.sharding import Mesh

    from jpeg_decoder_jax.parallel.stripe_bits import decode_bits_striped_batch

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("data", "stripe"))
    datas = [_jpeg(360, 480, "RGB", seed=200 + i, subsampling=2)
             for i in range(4)]
    st = [stage_host_bits(d) for d in datas]
    out = decode_bits_striped_batch(st, mesh)
    assert out is not None
    for i, d in enumerate(datas):
        gold = Decoder(d, backend="numpy").decode_array()
        assert np.array_equal(np.asarray(out[i]), gold), f"image {i}"


def test_triton_stripe_engine_interpret(monkeypatch):
    """The stripe pipeline on the Pallas kernel (interpret mode): straddling
    chunks rebased to negative blocks, the DC seam carry and the halo recon
    on a 2-stripe mesh — bit-exact vs the oracle."""
    import functools

    from jpeg_decoder_jax.entropy import triton_decode

    monkeypatch.setattr(triton_decode, "build_triton_sweep", functools.partial(
        triton_decode.build_triton_sweep, interpret=True))
    mesh = _mesh(2)
    data = _jpeg(48, 64, "RGB", seed=9, subsampling=2)
    st = stage_host_bits(data)
    out = decode_bits_striped(st, mesh, engine="triton")
    assert out is not None
    gold = Decoder(data, backend="numpy").decode_array()
    assert np.array_equal(np.asarray(out), gold)
