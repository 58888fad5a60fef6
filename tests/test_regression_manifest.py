"""Pinned-output regression gate (the reference's regression-fuzz analog).

Every corpus image's exact-mode decode must stay byte-identical to the
committed manifest (or keep failing with the same error type). Regenerate
with tools/make_regression_manifest.py only for intended behavior changes.
"""

import hashlib
import json
import pathlib

import pytest

from conftest import crashtest_files, reftest_files

from jpeg_decoder_jax import Decoder, JpegError

MANIFEST = json.loads(
    (pathlib.Path(__file__).parent / "regression_manifest.json").read_text())


def _outcome(path) -> str:
    try:
        data = Decoder(str(path)).decode()
        return "sha256:" + hashlib.sha256(data).hexdigest()
    except JpegError as e:
        return "error:" + type(e).__name__


@pytest.mark.parametrize(
    "path", sorted(reftest_files()) + sorted(crashtest_files()),
    ids=lambda p: str(p).replace("/root/reference/tests/", ""))
def test_regression_pinned_output(path):
    key = str(path).replace("/root/reference/tests/", "")
    assert key in MANIFEST, "new corpus file; regenerate the manifest"
    assert _outcome(path) == MANIFEST[key]
