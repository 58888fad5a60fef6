#!/usr/bin/env python
"""The reference's full benchmark set, mirrored.

`/root/reference/benches/decoding_benchmark.rs` + `large_image.rs`:
  - decode a 512x512 JPEG (tower.jpg)
  - decode a 512x512 progressive JPEG (tower_progressive.jpg)
  - decode a 512x512 grayscale JPEG (tower_grayscale.jpg)
  - extract metadata from an image (read_info only)
  - decode a 3072x2048 RGB lossless JPEG — the reference's input file is
    missing from its own snapshot (bench broken there); we substitute the
    largest lossless reftest image and note it
  - decode a 2268x1512 JPEG (large_image.jpg)

Reports wall time per op for the host oracle and (when a device is up) the
jax backend, plus the decode-to-device streaming rate. Usage:
  python tools/benchsuite.py [--backend numpy|jax|both] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCHES = "/root/reference/benches"
REFTEST = "/root/reference/tests/reftest/images"

CASES = [
    ("decode a 512x512 JPEG", f"{BENCHES}/tower.jpg", "decode"),
    ("decode a 512x512 progressive JPEG", f"{BENCHES}/tower_progressive.jpg", "decode"),
    ("decode a 512x512 grayscale JPEG", f"{BENCHES}/tower_grayscale.jpg", "decode"),
    ("extract metadata from an image", f"{BENCHES}/tower.jpg", "read_info"),
    # Reference bench input jpeg_lossless_sel1-rgb.jpg is absent from its
    # snapshot; substitute the largest lossless corpus image (876x896 L16).
    ("decode a lossless JPEG (substitute)",
     f"{REFTEST}/lossless/1/lossless16bit.jpg", "decode"),
    ("decode a 2268x1512 JPEG", f"{BENCHES}/large_image.jpg", "decode"),
]


def run_case(data: bytes, op: str, backend: str, samples: int = 10) -> float:
    from jpeg_decoder_jax import Decoder

    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        d = Decoder(data, backend=backend)
        if op == "decode":
            d.decode()
        else:
            d.read_info()
        best = min(best, time.perf_counter() - t0)
    return best


def run_stream(samples: int, as_json: bool, interchange: str = "prefix") -> None:
    """Per-stage timing of the decode-to-device stream (StageTimer)."""
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
    from jpeg_decoder_jax.utils.timing import StageTimer

    data = open(f"{BENCHES}/large_image.jpg", "rb").read()
    timer = StageTimer()
    dec = DeviceStreamDecoder(host_threads=5, timer=timer,
                              interchange=interchange)
    dec.decode_stream([data] * 2)  # warm: compile + pools
    timer.reset()
    t0 = time.perf_counter()
    outs = dec.decode_stream([data] * samples)
    for o in outs:
        o.block_until_ready()
    elapsed = time.perf_counter() - t0
    stages = timer.per_call_ms()
    stages["e2e_wall_per_image"] = round(elapsed / samples * 1000, 3)
    if as_json:
        print(json.dumps(stages))
    else:
        print(timer.summary())
        print(f"{'e2e wall':>16}: {elapsed / samples * 1000:8.3f} ms/img x{samples}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="numpy", choices=["numpy", "jax", "both"])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--stream", action="store_true",
                    help="per-stage decode-to-device stream timing")
    ap.add_argument("--interchange", default="prefix",
                    choices=["prefix", "bits"])
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: one sample per case + staging paths; any "
                         "error exits non-zero (the reference CI runs its "
                         "benches as smoke tests, rust.yml:36-40)")
    args = ap.parse_args()

    if args.smoke:
        args.samples = 1

    if args.stream:
        run_stream(args.samples, args.json, args.interchange)
        return

    backends = ["numpy", "jax"] if args.backend == "both" else [args.backend]
    results = {}
    for name, path, op in CASES:
        if not os.path.exists(path):
            continue
        data = open(path, "rb").read()
        for backend in backends:
            key = f"{name} [{backend}]"
            try:
                t = run_case(data, op, backend, args.samples)
                results[key] = round(t * 1000, 3)
                if not args.json:
                    print(f"{key:>55}: {t * 1000:8.2f} ms")
            except Exception as e:  # noqa: BLE001
                results[key] = f"error: {e}"
                if not args.json:
                    print(f"{key:>55}: ERROR {e}")

    if args.smoke:
        # Perf-path import/staging smoke: both interchange stagers must run.
        from jpeg_decoder_jax.models.stream import stage_host, stage_host_bits
        data = open(f"{BENCHES}/large_image.jpg", "rb").read()
        for name, fn in (("stage_host", stage_host),
                         ("stage_host_bits", stage_host_bits)):
            try:
                fn(data)
                results[name] = "ok"
                if not args.json:
                    print(f"{name:>55}: ok")
            except Exception as e:  # noqa: BLE001
                results[name] = f"error: {e}"
                if not args.json:
                    print(f"{name:>55}: ERROR {e}")

    if args.json:
        print(json.dumps(results))

    if args.smoke and any(
            isinstance(v, str) and v.startswith("error") for v in results.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
