"""Mesh-parallel decode tests on the virtual 8-device CPU mesh.

Validates the two mesh scaling axes against the single-device oracle:
- batch DP: B same-geometry images sharded over "data"
- MCU-row stripes with 1-row halo exchange over "stripe"

Both must be bit-identical to `Decoder(backend="numpy")`.
"""

import numpy as np
import pytest

from conftest import REFTEST_IMAGES

import jpeg_decoder_jax.parser as P
from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.ops.pipeline import geometry_from_frame
from jpeg_decoder_jax.parallel import decode_batch_sharded, decode_striped, make_mesh


def _decode_to_stores(path):
    """Run the host stages only, returning (frame, geometry, stores, qts, golden_bytes)."""
    d = Decoder(str(path), backend="numpy")
    golden = d.decode()
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1, 64) for i in range(n)]
    qts = [d._pending_render[i][1] for i in range(n)]
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(d.frame, transform)
    return d.frame, geometry, stores, qts, golden


@pytest.fixture(scope="module")
def mesh8():
    import jax
    return make_mesh({"data": 8}, jax.devices("cpu"))


@pytest.fixture(scope="module")
def stripe_mesh():
    import jax
    return make_mesh({"stripe": 8}, jax.devices("cpu"))


def test_batch_dp_matches_oracle(mesh8):
    frame, geometry, stores, qts, golden = _decode_to_stores(REFTEST_IMAGES / "rgb.jpg")
    B = 16
    batched = [np.broadcast_to(s, (B,) + s.shape).copy() for s in stores]
    out = decode_batch_sharded(geometry, batched, qts, mesh8)
    assert out.shape[0] == B
    for b in range(B):
        assert out[b].tobytes() == golden


@pytest.mark.parametrize("name", [
    "rgb.jpg",                          # H2V2 chroma: exercises halo exchange
    "mjpeg.jpg",                        # H2V1 4:2:2
    "grayscale_large.jpg",              # single component
    "mozilla/jpg-progressive.jpg",
])
def test_stripes_match_oracle(stripe_mesh, name):
    frame, geometry, stores, qts, golden = _decode_to_stores(REFTEST_IMAGES / name)
    out = decode_striped(geometry, stores, qts, stripe_mesh,
                         mcu_rows=frame.mcu_size.height)
    assert out.tobytes() == golden


def test_stripes_uneven_rows(stripe_mesh):
    """MCU rows not divisible by the stripe count (padding path)."""
    frame, geometry, stores, qts, golden = _decode_to_stores(
        REFTEST_IMAGES / "extraneous-data.jpg")
    out = decode_striped(geometry, stores, qts, stripe_mesh,
                         mcu_rows=frame.mcu_size.height)
    assert out.tobytes() == golden


def test_combined_dp_sp(stripe_mesh):
    """Batch DP x stripe SP composed in one shard_map program."""
    import jax
    from jpeg_decoder_jax.parallel import decode_striped_batch
    from jpeg_decoder_jax.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2, "stripe": 4}, jax.devices("cpu"))
    frame, geometry, stores, qts, golden = _decode_to_stores(REFTEST_IMAGES / "rgb.jpg")
    B = 4
    batched = [np.broadcast_to(s, (B,) + s.shape).copy() for s in stores]
    out = decode_striped_batch(geometry, batched, qts, mesh,
                               mcu_rows=frame.mcu_size.height)
    assert out.shape[0] == B
    for b in range(B):
        assert out[b].tobytes() == golden
