"""Per-stage decode timing — the observability layer the reference lacks.

SURVEY.md §5: the reference has no in-crate tracing; measurement is external
criterion benches. Here stage timings (parse, entropy, pack, H2D, device
pipeline) are first-class: `StageTimer` collects wall times per named stage,
and `utils/profile.py` reads device time out of a `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall time per stage across repeated decodes.

    Thread-safe: staging runs on a host thread pool, so multiple stages
    report concurrently."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:>16}: {total * 1000:9.2f} ms total, "
                         f"{total / n * 1000:8.3f} ms/call x{n}")
        return "\n".join(lines)

    def per_call_ms(self) -> Dict[str, float]:
        """{stage: mean ms per call} — machine-readable summary for bench JSON."""
        with self._lock:
            return {name: round(self.totals[name] / self.counts[name] * 1000, 3)
                    for name in self.totals if self.counts[name]}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a jax profiler trace around a block (XProf-compatible).

    No-op when log_dir is None or jax is unavailable.
    """
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
