"""The jitted JAX pipeline must be bit-identical to the numpy oracle.

Runs on CPU (conftest defaults JAX_PLATFORMS to cpu); the same pipeline code
is the device path. Covers every upsampler mode, progressive, restarts, CMYK, grayscale,
and scaled decode.
"""

import pytest

from conftest import REFTEST_IMAGES

from jpeg_decoder_jax import Decoder

CASES = [
    "rgb.jpg",                          # 4:2:0 YCbCr (H2V2)
    "mozilla/jpg-progressive.jpg",      # progressive
    "mozilla/jpg-cmyk-1.jpg",           # CMYK
    "grayscale_16x24_sampling2x2.jpg",  # 1-comp, non-trivial sampling
    "restarts.jpg",                     # restart intervals
    "mjpeg.jpg",                        # MJPEG default tables, 4:2:2 (H2V1)
    "extraneous-data.jpg",
    "mozilla/jpg-size-7x7.jpg",         # odd tiny size
]


@pytest.mark.parametrize("name", CASES)
def test_jax_matches_numpy(name):
    path = str(REFTEST_IMAGES / name)
    assert Decoder(path, backend="jax").decode() == Decoder(path, backend="numpy").decode()


@pytest.mark.parametrize("size", [(250, 167), (125, 84), (63, 42)])
def test_jax_matches_numpy_scaled(size):
    outs = []
    for backend in ("jax", "numpy"):
        d = Decoder(str(REFTEST_IMAGES / "rgb.jpg"), backend=backend)
        d.scale(*size)
        outs.append(d.decode())
    assert outs[0] == outs[1]


def test_batched_stream_matches_single():
    """Batched (vmapped) stream pipeline == per-image pipeline, incl. a
    mixed-geometry stream (forces group flushes)."""
    import jax.numpy as jnp
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder

    rgb = open(REFTEST_IMAGES / "rgb.jpg", "rb").read()
    gray = open(REFTEST_IMAGES / "grayscale_large.jpg", "rb").read()
    dec = DeviceStreamDecoder(host_threads=2)
    stream = [rgb, rgb, gray, rgb, gray, gray, rgb]
    single = dec.decode_stream(stream, batch_size=1)
    batched = dec.decode_stream(stream, batch_size=4)
    for a, b in zip(single, batched):
        assert a.shape == b.shape
        assert (jnp.asarray(a) == jnp.asarray(b)).all()


def test_scaled_decode_through_stream():
    """Thumbnail decode (IDCT-domain scaling) through the streaming staging."""
    import jax.numpy as jnp
    from jpeg_decoder_jax.models.stream import stage_host, _compiled_prefix_pipeline

    path = str(REFTEST_IMAGES / "rgb.jpg")
    d = Decoder(path, precision="fast")
    d.scale(125, 84)
    golden = d.decode()

    st = stage_host(open(path, "rb").read(), scale_to=(125, 84))
    fn = _compiled_prefix_pipeline(st.geometry, len(st.resid_idx))
    out = jnp.asarray(fn(st.dc, st.ac, st.resid_idx, st.resid_vals, st.qts))
    import numpy as np
    assert bytes(np.asarray(out).tobytes()) == golden


def test_stream_error_isolation():
    """Malformed inputs in a stream must not poison the batch (on_error='none')."""
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder

    good = open(REFTEST_IMAGES / "rgb.jpg", "rb").read()
    bad = b"\xff\xd8 definitely not a jpeg"
    dec = DeviceStreamDecoder(host_threads=2)
    outs = dec.decode_stream([good, bad, good], batch_size=4, on_error="none")
    assert outs[1] is None
    assert outs[0] is not None and outs[2] is not None
    import pytest as _pytest
    from jpeg_decoder_jax import JpegError
    with _pytest.raises(JpegError):
        dec.decode_stream([good, bad], on_error="raise")
