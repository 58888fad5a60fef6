"""Bounded-memory streaming decode (`Decoder(reader, streaming=True)`).

The reference decodes scan data straight off any `io::Read`
(`/root/reference/src/lib.rs:56-66`; `src/huffman.rs:123-160` reads the
reader inside the bit loop) and never buffers more than its read window.
The default contract here drains the stream before a scan (that random
access buys the segment/anchor parallelism); `streaming=True` restores the
reference's contract: the oracle entropy engine refills the cursor on
demand and compacts consumed bytes at MCU-row boundaries, so decode from a
socket/pipe of a file larger than memory works with O(window) buffering.
"""

import io
import pathlib

import numpy as np
import pytest

import jpeg_decoder_jax as jd
from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.errors import FormatError, IoError, JpegError

IMAGES = pathlib.Path("/root/reference/tests/reftest/images")


class ChunkReader:
    """Non-seekable sequential reader that caps every read() and records
    cumulative bytes served — a socket stand-in."""

    def __init__(self, data: bytes, cap: int = 4096):
        self._data = data
        self._pos = 0
        self.cap = cap
        self.reads = 0

    def read(self, n: int) -> bytes:
        n = min(n, self.cap)
        chunk = self._data[self._pos:self._pos + n]
        self._pos += len(chunk)
        self.reads += 1
        return chunk


STREAM_CASES = [
    "rgb.jpg",                      # baseline 4:2:0 color
    "restarts.jpg",                 # in-scan RSTn protocol
    "mozilla/jpg-progressive.jpg",  # multi-scan progressive
    "lossless/1/jpeg_lossless_sel1.jpg",  # SOF3, 16-bit output
    "ycck.jpg",                     # 4-component Adobe
]


@pytest.mark.parametrize("name", STREAM_CASES)
def test_streaming_bit_exact(name):
    data = (IMAGES / name).read_bytes()
    want = Decoder(data, backend="numpy", precision="exact").decode_array()

    d = Decoder(ChunkReader(data), backend="numpy", precision="exact",
                streaming=True)
    got = d.decode_array()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_streaming_memory_bounded():
    """The buffer high-water mark must track the refill window, not the
    file: with a 4 KiB window on a ~0.5 MB input the cursor may never hold
    more than a few windows + one MCU row of entropy bytes."""
    data = open("/root/reference/benches/large_image.jpg", "rb").read()
    assert len(data) > 400_000
    d = Decoder(ChunkReader(data), backend="numpy", precision="exact",
                streaming=True)
    d._cursor.chunk = 4096
    d.read_info()
    # Header phase alone must not have slurped the file.
    assert d._cursor.base + len(d._cursor.data) < len(data) // 4
    out = d.decode_array()
    assert out.shape[0] > 1000  # actually decoded
    # Whole stream consumed, tiny high-water mark.
    assert d._cursor.base + len(d._cursor.data) <= len(data)
    assert d._cursor.buffered_hwm < 64 * 1024
    ref = Decoder(data, backend="numpy", precision="exact").decode_array()
    assert np.array_equal(out, ref)


def test_streaming_requires_reader():
    with pytest.raises(ValueError):
        Decoder(b"\xff\xd8\xff\xd9", streaming=True)


def test_streaming_max_input_bytes_is_cumulative():
    """The DoS guard bounds cumulative fed bytes even though compaction
    keeps the resident buffer tiny."""
    data = (IMAGES / "rgb.jpg").read_bytes()
    d = Decoder(ChunkReader(data), backend="numpy", streaming=True,
                max_input_bytes=len(data) // 2)
    with pytest.raises(FormatError):
        d.decode_array()


def test_streaming_truncated_raises_typed():
    data = (IMAGES / "rgb.jpg").read_bytes()
    d = Decoder(ChunkReader(data[: len(data) // 3]), backend="numpy",
                streaming=True)
    with pytest.raises((IoError, JpegError)):
        d.decode_array()


def test_streaming_jax_backend():
    """Streaming feeds the device reconstruction path too: bounded host
    buffering with batched XLA reconstruct."""
    data = (IMAGES / "rgb.jpg").read_bytes()
    want = Decoder(data, backend="numpy", precision="fast").decode_array()
    d = Decoder(ChunkReader(data), backend="jax", precision="fast",
                streaming=True)
    got = np.asarray(d.decode_array())
    assert got.shape == want.shape
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 3


def test_streaming_io_bytesio():
    """Plain io.BytesIO works as the reader (seekability unused)."""
    data = (IMAGES / "restarts.jpg").read_bytes()
    want = Decoder(data, backend="numpy", precision="exact").decode_array()
    got = Decoder(io.BytesIO(data), backend="numpy", precision="exact",
                  streaming=True).decode_array()
    assert np.array_equal(got, want)


def _outcome(fn):
    try:
        out = fn()
        return ("ok", None if out is None else bytes(np.asarray(out).data))
    except JpegError as e:
        return ("err", type(e).__name__)


def test_streaming_crashtest_corpus():
    """The whole malformed-input corpus through the windowed reader: every
    file must error-or-decode exactly like the drained oracle (same pixels
    or same typed-error class), never crash. This is the crashtest contract
    (`/root/reference/tests/crashtest/mod.rs:8-17`) applied to the streaming
    refill/compact bit loop."""
    from conftest import crashtest_files

    mismatches = []
    for jpg in crashtest_files():
        data = jpg.read_bytes()
        want = _outcome(lambda: jd.Decoder(
            data, backend="numpy", precision="exact").decode_array())
        got = _outcome(lambda: jd.Decoder(
            ChunkReader(data), backend="numpy", precision="exact",
            streaming=True).decode_array())
        if want != got:
            mismatches.append((jpg.name, want[0], want[1] if want[0] == "err"
                               else "<pixels>", got))
    assert not mismatches, mismatches[:5]
