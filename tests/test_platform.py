"""The one platform policy: which entropy engine runs on which backend."""

import pytest

from jpeg_decoder_jax import platform
from jpeg_decoder_jax.entropy.device_scan import build_sweep


@pytest.mark.parametrize("backend, engine", [
    ("gpu", "triton"), ("cpu", "xla"), ("metal", "xla"), ("rocm", "xla"),
    ("", "xla")])
def test_entropy_engine_per_backend(backend, engine, monkeypatch):
    """A GPU gets the kernel; the CPU and any backend the policy does not
    know get the plain-JAX engine, never an interpret-mode kernel."""
    if backend == "":
        monkeypatch.setattr(platform, "backend", lambda: "cpu")
        assert platform.entropy_engine() == "xla"
    else:
        assert platform.entropy_engine(backend) == engine
    assert platform.entropy_engine(backend or None) in platform.ENTROPY_ENGINES


def test_default_backend_here_is_plain_jax():
    assert platform.backend() == "cpu"
    assert platform.entropy_engine() == "xla"


def test_build_sweep_rejects_unknown_engine():
    with pytest.raises(ValueError):
        build_sweep(4, 16, (0,), engine="mosaic")


def test_build_sweep_never_interprets(monkeypatch):
    """The platform path builds the kernel for the card (interpret=False)."""
    from jpeg_decoder_jax.entropy import triton_decode

    seen = {}

    def spy(n_blocks, s_max, pattern, lanes=triton_decode.LANES,
            interpret=False):
        seen["interpret"] = interpret
        return lambda *a: None

    monkeypatch.setattr(triton_decode, "build_triton_sweep", spy)
    monkeypatch.setattr(platform, "entropy_engine", lambda on=None: "triton")
    build_sweep(4, 16, (0,))
    assert seen == {"interpret": False}
