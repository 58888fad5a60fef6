"""The Pallas (Triton route) entropy kernel against the plain-JAX engine.

On the CPU the kernel runs in the Pallas interpreter, on tiny generated
images: every stored coefficient must equal the XLA engine's. Tests marked
`gpu` compile it for the card and compare at real widths.
"""

import numpy as np
import pytest

from jpeg_decoder_jax.entropy.device_scan import (build_xla_sweep,
                                                  merge_scans)
from jpeg_decoder_jax.entropy.triton_decode import build_triton_sweep
from jpeg_decoder_jax.models.stream import stage_host_bits
from jpeg_decoder_jax.ops.idct import dequantize_and_idct_blocks_fast
from jpeg_decoder_jax.testing.synth import make_jpeg


def _scan(kind, w=48, h=32, seed=3):
    st = stage_host_bits(make_jpeg(kind, w, h, seed=seed))
    return st.scans[0][0]


def _args(scan):
    return (scan.words, scan.anchor_bits, scan.anchor_block,
            scan.anchor_slot, scan.luts)


def _both(n_blocks, s_max, pattern, args, lanes=32):
    import jax
    ref = jax.jit(build_xla_sweep(n_blocks, s_max, pattern))(*args)
    got = jax.jit(build_triton_sweep(n_blocks, s_max, pattern, lanes=lanes,
                                     interpret=True))(*args)
    return np.asarray(ref), np.asarray(got)


@pytest.mark.parametrize("kind", ["420", "422-dri", "444", "gray",
                                  "progressive"])
def test_triton_sweep_matches_xla(kind):
    """Bit-exact stores on every sampling, with restart segments, and on a
    transcoded (progressive) stream."""
    scan = _scan(kind)
    plan = scan.plan
    ref, got = _both(plan.n_blocks, plan.s_max, tuple(plan.pattern),
                     _args(scan))
    assert ref.shape == (plan.n_blocks, 64)
    assert np.abs(ref).sum() > 0
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("lanes", [32, 64])
def test_triton_sweep_lane_widths(lanes):
    """More chunks than one program's lanes, several programs, a partial
    last program: the lane width changes the work split, not the result."""
    scan = _scan("444", 128, 96, seed=4)
    assert scan.n_items > lanes
    plan = scan.plan
    ref, got = _both(plan.n_blocks, plan.s_max, tuple(plan.pattern),
                     _args(scan), lanes=lanes)
    assert np.array_equal(ref, got)


def test_triton_sweep_merged_matches_xla():
    """A merged sweep over images of different sizes (the batched and
    mixed-size group paths): one kernel call, every image's rows intact."""
    scans = [_scan("420", 48, 32, seed=5), _scan("420", 32, 16, seed=6),
             _scan("420", 48, 32, seed=7)]
    total = sum(s.n_blocks for s in scans) + 6   # bucketed past the real count
    words, bits, block, slot, bases = merge_scans(scans)
    pattern = tuple(scans[0].plan.pattern)
    ref, got = _both(total, max(s.plan.s_max for s in scans), pattern,
                     (words, bits, block, slot, scans[0].luts))
    assert np.array_equal(ref, got)
    assert not got[sum(s.n_blocks for s in scans):].any()
    for s, b in zip(scans, bases):
        solo, _ = _both(s.n_blocks, s.plan.s_max, pattern, _args(s))
        assert np.array_equal(got[b:b + s.n_blocks], solo)


def test_triton_sweep_drops_out_of_range_blocks():
    """Stripe mode rebases a straddling chunk to negative blocks: emissions
    outside [0, n_blocks) must be dropped, the rest kept."""
    scan = _scan("gray", 64, 64, seed=8)
    plan = scan.plan
    shift = int(scan.anchor_block[1])            # first chunk's block count
    block = scan.anchor_block.astype(np.int64) - shift
    block[scan.n_items:] = plan.n_blocks - shift
    args = (scan.words, scan.anchor_bits, block.astype(np.int32),
            scan.anchor_slot, scan.luts)
    n_out = plan.n_blocks - shift
    ref, got = _both(n_out, plan.s_max, tuple(plan.pattern), args)
    assert np.array_equal(ref, got)
    full, _ = _both(plan.n_blocks, plan.s_max, tuple(plan.pattern),
                    _args(scan))
    assert np.array_equal(got, full[shift:])


def test_fast_scaled_idct_near_exact():
    """The Dugad-Ahuja linearization stays within 1 of the exact integer
    kernels on in-range content (the fast-tier contract for scale < 8)."""
    from jpeg_decoder_jax.ops.idct import dequantize_and_idct_blocks

    rng = np.random.default_rng(5)
    for scale in (4, 2, 1):
        worst = 0
        for _ in range(50):
            c = rng.normal(0, 40, size=(128, 64)).astype(np.int16)
            qt = rng.integers(1, 64, size=64).astype(np.uint16)
            exact = dequantize_and_idct_blocks(c, qt, scale).astype(int)
            fast = dequantize_and_idct_blocks_fast(
                c, qt, xp=np, scale=scale).astype(int)
            worst = max(worst, int(np.abs(exact - fast).max()))
        assert worst <= 1, (scale, worst)


def test_scaled_decode_fast_within_tolerance():
    """End-to-end scaled decode in fast precision stays within 3 of the
    exact path at every IDCT scale (the same contract the unscaled fast path
    is held to)."""
    from jpeg_decoder_jax import Decoder

    data = make_jpeg("420", 160, 112, seed=9)
    for req in ((20, 14), (40, 28), (80, 56), (160, 112)):
        d_exact = Decoder(data, backend="numpy", precision="exact")
        d_exact.scale(*req)
        a = np.asarray(d_exact.decode_array()).astype(int)

        d_fast = Decoder(data, backend="jax", precision="fast")
        d_fast.scale(*req)
        b = np.asarray(d_fast.decode_array()).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 3, req


@pytest.mark.parametrize("interchange", ["prefix", "bits"])
def test_batched_stream_respects_layout(interchange):
    """batch_size > 1 groups must produce the same layout and content as the
    per-image path for every layout."""
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder

    data = make_jpeg("444", 40, 24, seed=10)
    for layout in ("interleaved", "planar"):
        dec = DeviceStreamDecoder(host_threads=1, layout=layout,
                                  interchange=interchange)
        single = np.asarray(dec.decode_stream([data])[0])
        batched = dec.decode_stream([data] * 4, batch_size=4)
        assert len(batched) == 4
        for out in batched:
            out = np.asarray(out)
            assert out.shape == single.shape, layout
            assert (out == single).all(), layout


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["420", "422-dri", "gray", "progressive"])
def test_gpu_triton_sweep_matches_xla(gpu, kind):
    """Compiled for the card, at the `large` class's width (2304 x 1536)."""
    scan = _scan(kind, 2304, 1536, seed=0)
    plan = scan.plan
    import jax
    args = _args(scan)
    ref = np.asarray(jax.jit(build_xla_sweep(
        plan.n_blocks, plan.s_max, tuple(plan.pattern)))(*args))
    got = np.asarray(jax.jit(build_triton_sweep(
        plan.n_blocks, plan.s_max, tuple(plan.pattern)))(*args))
    assert np.array_equal(ref, got)
