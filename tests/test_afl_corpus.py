"""The reference's AFL fuzzing corpus as fixed regression inputs.

`/root/reference/fuzz-afl/in/` holds 104 AFL queue entries (havoc/flip/arith
mutants of real JPEGs plus inputs synced from libjpeg9/libjpeg-turbo fuzzers,
many marked +cov — each grew coverage against the reference decoder;
`/root/reference/fuzz-afl/src/fuzz_decode.rs` is the harness). Reused
wholesale like the reftest/crashtest corpora: every input must decode or
raise a typed JpegError — never crash — on both entropy engines, and the
device staging path must accept-or-fallback cleanly.
"""

import os
import pathlib

import pytest

import jpeg_decoder_jax.entropy.native as native_mod
from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.errors import JpegError

AFL_IN = pathlib.Path("/root/reference/fuzz-afl/in")

CORPUS = sorted(AFL_IN.glob("*.jpg")) if AFL_IN.exists() else []


def _decode(data):
    try:
        Decoder(data, backend="numpy").decode()
        return "ok"
    except JpegError as e:
        return f"err:{type(e).__name__}"


@pytest.mark.skipif(not CORPUS, reason="AFL corpus unavailable")
def test_afl_corpus_native_and_oracle_agree():
    """Both engines must survive every input AND agree on accept/reject —
    the differential contract the random fuzzer enforces, pinned on the
    coverage-grown corpus."""
    if native_mod.get_native() is None:
        pytest.skip("native engine unavailable")
    disagreements = []
    for path in CORPUS:
        data = path.read_bytes()
        os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()
        a = _decode(data)
        os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
        native_mod.reset_native_cache()
        try:
            b = _decode(data)
        finally:
            os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
            native_mod.reset_native_cache()
        if (a == "ok") != (b == "ok"):
            disagreements.append((path.name, a, b))
    assert not disagreements, disagreements


@pytest.mark.skipif(not CORPUS, reason="AFL corpus unavailable")
def test_afl_corpus_device_staging_survives():
    """The bits staging (prescan + pack) must accept-or-fallback on every
    AFL input without crashing; accepted streams already get store-level
    verification from tools/fuzz.py --device."""
    from jpeg_decoder_jax.models.stream import stage_host_bits

    for path in CORPUS:
        try:
            stage_host_bits(path.read_bytes())
        except JpegError:
            pass  # typed rejection is fine
