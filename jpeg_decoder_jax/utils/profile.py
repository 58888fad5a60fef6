"""Device time from a `jax.profiler` trace.

Host clocks around asynchronous dispatch measure the enqueue, and a warm
loop of small programs measures launch overhead as much as the work. This
module traces a few calls and reads the GPU's own kernel intervals back out
of the `.xplane.pb` file with `jax.profiler.ProfileData` (no other
package): per-kernel device time, the busy time (union of kernel
intervals) and the idle share of the traced window.

    from jpeg_decoder_jax.utils.profile import trace_device
    stats = trace_device(lambda: fn(*args), iters=10)
    stats["busy_ms"] / 10    # device time per call
"""

from __future__ import annotations

import collections
import glob
import os
import tempfile


def device_events(xplane_path: str) -> list:
    """(name, start_ns, duration_ns) of every kernel on the GPU stream lines
    of one trace file. Derived lines ("XLA Ops", "XLA Modules") repeat the
    same intervals and are skipped."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            out.extend((ev.name, ev.start_ns, ev.duration_ns)
                       for ev in line.events)
    return out


def summarize(events: list) -> dict:
    """Busy time (union of intervals), window, idle share and the device
    time of each kernel name, in milliseconds."""
    if not events:
        return {"busy_ms": 0.0, "window_ms": 0.0, "idle_share": None,
                "kernels_ms": {}}
    spans = sorted((s, s + d) for _n, s, d in events)
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _s, e in spans) - spans[0][0]
    per = collections.defaultdict(float)
    for name, _s, d in events:
        per[name] += d / 1e6
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels_ms": dict(sorted(per.items(), key=lambda kv: -kv[1]))}


def trace_device(call, iters: int = 10, trace_dir: str = None) -> dict:
    """Run `call()` (already warm) `iters` times under the profiler, wait for
    the device, and summarize its kernel intervals (see summarize)."""
    import jax

    with tempfile.TemporaryDirectory(dir=trace_dir) as d:
        with jax.profiler.trace(d):
            out = None
            for _ in range(iters):
                out = call()
            jax.block_until_ready(out)
        paths = sorted(glob.glob(os.path.join(
            d, "plugins", "profile", "*", "*.xplane.pb")))
        return summarize(device_events(paths[-1]) if paths else [])
