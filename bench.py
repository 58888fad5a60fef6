"""Benchmark: decode throughput on a generated `large_image`-class input.

    python bench.py [--seed N]

Decodes a 2304 x 1536 (3.54 Mpix) baseline 4:2:0 photo-like JPEG made from
the seed (jpeg_decoder_jax.testing.synth; the class of the reference's
`benches/large_image.rs`) on one GPU and prints ONE JSON line:

- `value` (Mpix/s): a burst of images through DeviceStreamDecoder's bits
  interchange, host staging included, every output waited for;
- `device_resident`: the full device pipeline iterated inside one jitted
  loop over device-resident inputs (no host work in the window);
- `staging_serial_ms`: single-threaded host staging per interchange;
- `wire_bytes_per_px`: host-to-device bytes of the bits interchange;
- the device (platform, kind, count) and the card's name and power limit.

Fails when JAX finds no GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _measure_burst(dec, data: bytes, mpix: float, n_images: int = 24,
                   trials: int = 3) -> float:
    best = 0.0
    for _ in range(trials):
        t0 = time.perf_counter()
        outs = dec.decode_stream([data] * n_images)
        for o in outs:
            o.block_until_ready()
        best = max(best, n_images * mpix / (time.perf_counter() - t0))
    return best


def _staging_serial_ms(data: bytes) -> dict:
    """Single-threaded host staging per interchange (median of 7, ms)."""
    from jpeg_decoder_jax.models.stream import stage_host, stage_host_bits
    out = {}
    for name, fn in (("prefix", stage_host), ("bits", stage_host_bits)):
        fn(data)  # warm (allocators, LUT caches)
        ts = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn(data)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(ts)[len(ts) // 2]
    return out


def _wire_bytes_per_px(data: bytes, mpix: float) -> float:
    from jpeg_decoder_jax.models.stream import stage_host_bits
    st = stage_host_bits(data)
    nbytes = sum(s.words.nbytes + s.anchor_bits.nbytes
                 + s.anchor_block.nbytes + s.anchor_slot.nbytes
                 for s, _kept in st.scans)
    return nbytes / (mpix * 1e6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from jpeg_decoder_jax import Decoder
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
    from jpeg_decoder_jax.testing.synth import make_jpeg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    data = make_jpeg("420", 2304, 1536, args.seed)
    info = Decoder(data)
    info.read_info()
    mpix = info.info().width * info.info().height / 1e6

    extra = {"staging_serial_ms": _staging_serial_ms(data),
             "wire_bytes_per_px": _wire_bytes_per_px(data, mpix)}
    dec = DeviceStreamDecoder(host_threads=8, interchange="bits")
    dec.decode_stream([data] * 2)           # warm: compile + pools
    throughput = _measure_burst(dec, data, mpix)
    extra["device_resident"] = dec.device_resident_rate(data)
    dev = jax.devices()
    print(json.dumps({
        "metric": "decode_throughput_large_image",
        "value": throughput,
        "unit": "Mpix/s",
        "device": {"platform": dev[0].platform, "kind": dev[0].device_kind,
                   "count": len(dev)},
        "card": card,
        **extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
