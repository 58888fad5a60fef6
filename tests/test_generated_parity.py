"""DeviceStreamDecoder on generated inputs against the numpy oracle.

Every sampling, restart intervals, progressive (transcoded onto the bits
interchange) and lossless at 8 and 16 bits, through both interchanges, solo
and batched: `exact` and lossless must be bit-exact, `fast` within 3.
"""

import numpy as np
import pytest

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
from jpeg_decoder_jax.testing.synth import make_jpeg

KINDS = ["420", "422", "444", "gray", "420-dri", "progressive", "lossless8",
         "lossless16"]


def _worst(outs, ref):
    return max(int(np.abs(np.asarray(o).astype(np.int64).reshape(ref.shape)
                          - ref.astype(np.int64)).max()) for o in outs)


@pytest.mark.parametrize("interchange", ["prefix", "bits"])
@pytest.mark.parametrize("kind", KINDS)
def test_stream_matches_oracle(kind, interchange):
    data = [make_jpeg(kind, 48, 32, seed=s) for s in (1, 2)]
    for precision, tol in (("exact", 0), ("fast", 3)):
        dec = DeviceStreamDecoder(host_threads=2, precision=precision,
                                  interchange=interchange)
        solo = dec.decode_stream(data)
        batched = dec.decode_stream(data * 2, batch_size=8)
        for i, d in enumerate(data):
            ref = Decoder(d, backend="numpy", precision=precision
                          ).decode_array()
            tol_i = 0 if kind.startswith("lossless") else tol
            assert _worst([solo[i], batched[i], batched[i + 2]],
                          ref) <= tol_i, (precision, i)


@pytest.mark.gpu
@pytest.mark.parametrize("interchange", ["prefix", "bits"])
@pytest.mark.parametrize("kind", ["420", "422-dri", "gray", "progressive",
                                  "lossless16"])
def test_gpu_stream_matches_oracle(gpu, kind, interchange):
    """The same contract compiled for the card at the `tower` class's size
    (512 x 512), solo and in a batch of 8."""
    data = make_jpeg(kind, 512, 512, seed=0)
    for precision, tol in (("exact", 0), ("fast", 3)):
        ref = Decoder(data, backend="numpy", precision=precision
                      ).decode_array()
        dec = DeviceStreamDecoder(precision=precision,
                                  interchange=interchange)
        outs = dec.decode_stream([data]) + dec.decode_stream([data] * 8,
                                                             batch_size=8)
        tol = 0 if kind.startswith("lossless") else tol
        assert _worst(outs, ref) <= tol, precision
