"""Robustness corpus: malformed/malicious JPEGs must error, never crash.

Port of `/root/reference/tests/crashtest/mod.rs:8-17`: decode() may return an
error (any JpegError) but must not raise anything else or hang.
"""

import pytest

from conftest import CRASHTEST_IMAGES, crashtest_files

from jpeg_decoder_jax import Decoder, JpegError


@pytest.mark.parametrize(
    "jpg", crashtest_files(), ids=lambda p: str(p.relative_to(CRASHTEST_IMAGES)))
def test_crashtest(jpg):
    decoder = Decoder(str(jpg))
    try:
        decoder.decode()
    except JpegError:
        pass
