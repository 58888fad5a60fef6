"""Device (jnp) lossless predictor formulations vs the host oracle.

The device path must be bit-identical for every supported predictor, on both
synthetic difference planes and real corpus streams.
"""

import numpy as np
import pytest

from conftest import REFTEST_IMAGES

from jpeg_decoder_jax.ops.predictors import (
    device_supported,
    reconstruct_lossless,
    reconstruct_lossless_device,
)
from jpeg_decoder_jax.parser import Predictor


@pytest.mark.parametrize("predictor", [
    Predictor.NO_PREDICTION, Predictor.RA, Predictor.RB, Predictor.RC,
    Predictor.RA_RB_RC_1,
])
@pytest.mark.parametrize("shape", [(1, 1), (1, 37), (37, 1), (24, 31), (64, 64)])
def test_device_matches_oracle_synthetic(predictor, shape):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(hash((predictor, shape)) & 0xFFFF)
    diffs = rng.integers(-32768, 32769, shape).astype(np.int32)

    oracle = reconstruct_lossless(diffs, predictor, 0, 16, restart_all=False)
    dev = jax.jit(
        lambda d: reconstruct_lossless_device(d, predictor, 0, 16, False, jnp)
    )(diffs)
    assert (np.asarray(dev) == oracle).all()


def test_device_restart_all_quirk():
    import jax.numpy as jnp

    diffs = np.arange(12, dtype=np.int32).reshape(3, 4) * 7 - 20
    for pt in (0, 2):
        oracle = reconstruct_lossless(diffs, Predictor.RA_RB_RC_2, pt, 12,
                                      restart_all=True)
        dev = reconstruct_lossless_device(diffs, Predictor.RA_RB_RC_2, pt, 12,
                                          True, jnp)
        assert (np.asarray(dev) == oracle).all()


def test_device_on_real_lossless_stream():
    """Real corpus: sel1 (predictor Ra) through the device formulation."""
    import jax.numpy as jnp

    from jpeg_decoder_jax.decoder import Decoder
    from jpeg_decoder_jax.entropy import decode_scan_lossless

    path = str(REFTEST_IMAGES / "lossless" / "1" / "jpeg_lossless_sel1.jpg")
    d = Decoder(path)
    golden = np.frombuffer(d.decode(), np.uint16)

    # Re-run entropy to get diffs, reconstruct on "device".
    d2 = Decoder(path)
    captured = {}
    orig = Decoder._process_scan_lossless

    def cap(self, frame, scan):
        marker, diffs, leftover = decode_scan_lossless(
            self._cursor, frame, scan, self._dc_huffman_tables,
            self._restart_interval)
        captured["diffs"] = diffs
        captured["scan"] = scan
        captured["frame"] = frame
        from jpeg_decoder_jax.ops.predictors import reconstruct_lossless as rl
        for pos, comp_i in enumerate(scan.component_indices):
            self._planes_u16[comp_i] = rl(
                diffs[pos], scan.predictor_selection, scan.point_transform,
                frame.precision, False)
        return marker

    Decoder._process_scan_lossless = cap
    try:
        d2.decode()
    finally:
        Decoder._process_scan_lossless = orig

    scan = captured["scan"]
    frame = captured["frame"]
    assert device_supported(scan.predictor_selection, scan.point_transform)
    dev = reconstruct_lossless_device(
        captured["diffs"][0], scan.predictor_selection, scan.point_transform,
        frame.precision, False, jnp)
    assert (np.asarray(dev).reshape(-1) == golden).all()


@pytest.mark.parametrize("predictor", list(Predictor))
@pytest.mark.parametrize("pt", [0, 1, 3])
def test_wavefront_matches_oracle(predictor, pt):
    import jax
    import jax.numpy as jnp
    from jpeg_decoder_jax.ops.predictors import reconstruct_lossless_wavefront

    rng = np.random.default_rng(hash((predictor, pt)) & 0xFFFF)
    diffs = rng.integers(-32768, 32769, (19, 23)).astype(np.int32)
    precision = 12

    oracle = reconstruct_lossless(diffs, predictor, pt, precision,
                                  restart_all=False)
    dev = jax.jit(lambda d: reconstruct_lossless_wavefront(
        d, predictor, pt, precision, jnp))(diffs)
    assert (np.asarray(dev) == oracle).all(), predictor


@pytest.mark.parametrize("name", [
    "lossless/1/jpeg_lossless_sel1.jpg",   # Ra (closed form)
    "lossless/1/jpeg_lossless_sel4.jpg",   # Ra+Rb-Rc (closed form)
    "lossless/1/jpeg_lossless_sel6.jpg",   # Rb+((Ra-Rc)>>1) (wavefront)
    "lossless/2/MR4.jpg",
])
def test_jax_backend_lossless_bit_exact(name):
    path = str(REFTEST_IMAGES / name)
    from jpeg_decoder_jax import Decoder
    assert Decoder(path, backend="jax").decode() == Decoder(path).decode()
