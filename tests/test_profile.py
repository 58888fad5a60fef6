"""The trace reduction in jpeg_decoder_jax.utils.profile."""

import pytest

from jpeg_decoder_jax.utils.profile import summarize


def test_summarize_unions_overlapping_kernels():
    """Busy time is the union of intervals: overlap counts once, gaps are
    idle; per-kernel time sums every event of that name."""
    ev = [("a", 0, 10), ("b", 5, 10), ("a", 30, 10)]
    s = summarize(ev)
    assert s["busy_ms"] == pytest.approx(25e-6)
    assert s["window_ms"] == pytest.approx(40e-6)
    assert s["idle_share"] == pytest.approx(1 - 25 / 40)
    assert s["kernels_ms"] == pytest.approx({"a": 20e-6, "b": 10e-6})
    assert list(s["kernels_ms"]) == ["a", "b"]


def test_summarize_empty_trace():
    s = summarize([])
    assert s["busy_ms"] == 0.0 and s["idle_share"] is None
