"""Smoke run of the decode-to-device path on one GPU (or four with --four).

    python chip_smoke.py [--seed N]      # one card
    python chip_smoke.py --four          # data-parallel and stripe meshes

Generates its inputs from the seed (jpeg_decoder_jax.testing.synth), decodes
them through DeviceStreamDecoder's normal entry points and checks them
against the numpy oracle. Exits non-zero on any failure, when JAX finds no
GPU, or when the native entropy library did not load. The last line of
standard output is one JSON object naming the device.

One card: every input through both interchanges, solo and with
batch_size=8, in `fast` (within 3 of the oracle's fast mode) and `exact`
(bit-exact) precision; lossless bit-exact; each batch of bits images in one
entropy sweep; the Pallas entropy kernel against the plain-JAX engine at the
`large` width; decode_striped's single-card path; and a warm-loop ms/image
for `large` solo and `tower` batch 8 (a sanity number, not a benchmark).

--four: DeviceStreamDecoder(mesh=make_mesh({"data": 4})) on 8 x tower with
batch_size=8 against the one-card stream, and decode_striped of a ~30 Mpix
4:2:0 image over make_mesh({"stripe": 4}) against the oracle, bit-exact.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _inputs(seed: int) -> dict:
    from jpeg_decoder_jax.testing.synth import make_jpeg
    return {
        "large": make_jpeg("420", 2304, 1536, seed),
        "tower": make_jpeg("420", 512, 512, seed + 1),
        "tower_progressive": make_jpeg("progressive", 512, 512, seed + 1),
        "tower_grayscale": make_jpeg("gray", 512, 512, seed + 1),
        "restart": make_jpeg("422-dri", 1024, 768, seed + 2),
        "lossless16": make_jpeg("lossless16", 512, 512, seed + 3),
    }


def _worst(out, ref) -> int:
    got = np.asarray(out).astype(np.int64)
    return int(np.abs(got.reshape(ref.shape) - ref.astype(np.int64)).max())


def check_streams(inputs: dict) -> None:
    """Every input, both interchanges, solo and batched, both precisions."""
    from jpeg_decoder_jax import Decoder
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder

    for name, data in inputs.items():
        lossless = name.startswith("lossless")
        for precision in ("fast", "exact"):
            ref = Decoder(data, backend="numpy",
                          precision=precision).decode_array()
            tol = 0 if lossless or precision == "exact" else 3
            for interchange in ("prefix", "bits"):
                dec = DeviceStreamDecoder(precision=precision,
                                          interchange=interchange)
                solo = dec.decode_stream([data])
                n0 = dict(dec.counts)
                batched = dec.decode_stream([data] * 8, batch_size=8)
                worst = max(_worst(o, ref) for o in solo + batched)
                sweeps = dec.counts["sweeps"] - n0.get("sweeps", 0)
                dispatches = (dec.counts["dispatches"]
                              - n0.get("dispatches", 0))
                print(f"stream {name:18s} {precision:5s} {interchange:6s} "
                      f"max|diff|={worst} batch8: dispatches={dispatches} "
                      f"sweeps={sweeps}", flush=True)
                if worst > tol:
                    raise AssertionError(f"{name} {precision} {interchange}: "
                                         f"max diff {worst} > {tol}")
                if dispatches != 1:
                    raise AssertionError(f"{name}: batch of 8 took "
                                         f"{dispatches} dispatches")
                if interchange == "bits" and not lossless and sweeps != 1:
                    raise AssertionError(f"{name}: batch of 8 bits images "
                                         f"took {sweeps} sweeps, not one")


def check_kernels(inputs: dict) -> None:
    """The Pallas entropy kernel against the plain-JAX engine at the `large`
    width; the compiled memory of the `large` bits program."""
    import jax

    from jpeg_decoder_jax.entropy.device_scan import build_xla_sweep
    from jpeg_decoder_jax.entropy.triton_decode import build_triton_sweep
    from jpeg_decoder_jax.models.stream import (DeviceStreamDecoder,
                                                stage_host_bits)

    st = stage_host_bits(inputs["large"])
    scan = st.scans[0][0]
    plan = scan.plan
    args = [jax.device_put(a) for a in (scan.words, scan.anchor_bits,
                                        scan.anchor_block, scan.anchor_slot,
                                        scan.luts)]
    ref = np.asarray(jax.jit(build_xla_sweep(
        plan.n_blocks, plan.s_max, tuple(plan.pattern)))(*args))
    got = np.asarray(jax.jit(build_triton_sweep(
        plan.n_blocks, plan.s_max, tuple(plan.pattern)))(*args))
    same = bool(np.array_equal(ref, got))
    print(f"kernel anchored_huffman_decode vs xla engine on large "
          f"({plan.n_blocks} blocks, {scan.n_items} chunks): "
          f"bit-exact={same}", flush=True)
    if not same:
        raise AssertionError("entropy kernel differs from the XLA engine")
    print("kernel idct / upsample+colour: none kept, plain XLA runs",
          flush=True)

    dec = DeviceStreamDecoder(interchange="bits")
    fn, scan_args = dec._bits_fn_args(st)
    compiled = fn.lower(scan_args, st.qts).compile()
    print(f"memory_analysis large bits: {compiled.memory_analysis()}",
          flush=True)


def check_striped_single(inputs: dict) -> None:
    """decode_striped on a one-device stripe mesh: the single-card path."""
    from jpeg_decoder_jax import Decoder
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
    from jpeg_decoder_jax.parallel.mesh import make_mesh

    data = inputs["restart"]
    ref = Decoder(data, backend="numpy").decode_array()
    dec = DeviceStreamDecoder(precision="exact", interchange="bits",
                              mesh=make_mesh({"stripe": 1}))
    worst = _worst(dec.decode_striped(data), ref)
    print(f"decode_striped restart (1 card) max|diff|={worst}", flush=True)
    if worst:
        raise AssertionError("decode_striped differs from the oracle")


def sanity_rates(inputs: dict, card: str) -> None:
    """Warm steady-state ms/image: device-resident loops, a warm
    decode_stream loop (host staging included), and the device's busy time
    and idle share over one traced decode_stream burst."""
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
    from jpeg_decoder_jax.utils.profile import trace_device

    dec = DeviceStreamDecoder(interchange="bits", host_threads=8)
    for name, batch in (("large", 1), ("tower", 8)):
        r = dec.device_resident_rate(inputs[name], iters=32, batch=batch)
        data = [inputs[name]] * 16
        for o in dec.decode_stream(data, batch_size=batch):
            o.block_until_ready()
        t0 = time.perf_counter()
        for o in dec.decode_stream(data, batch_size=batch):
            o.block_until_ready()
        e2e = (time.perf_counter() - t0) / len(data) * 1e3
        tr = trace_device(lambda: dec.decode_stream(data, batch_size=batch),
                          iters=1)
        traced = ("no GPU kernels in the trace" if tr["idle_share"] is None
                  else f"device busy {tr['busy_ms'] / len(data):.4f} "
                       f"ms/image, idle share {tr['idle_share']:.3f}")
        print(f"rate {name} batch={batch} [{card}]: device-resident "
              f"{r['ms_per_image']:.4f} ms/image; decode_stream "
              f"{e2e:.3f} ms/image (warm, host staging included); traced "
              f"burst: {traced}", flush=True)


def check_four(seed: int) -> None:
    """Data-parallel stream and stripe decode over four cards."""
    from jpeg_decoder_jax import Decoder
    from jpeg_decoder_jax.models.stream import DeviceStreamDecoder
    from jpeg_decoder_jax.parallel.mesh import make_mesh
    from jpeg_decoder_jax.testing.synth import make_jpeg

    tower = make_jpeg("420", 512, 512, seed + 1)
    one = DeviceStreamDecoder(precision="exact", interchange="bits")
    ref = np.asarray(one.decode_stream([tower])[0])
    for interchange in ("bits", "prefix"):
        dp = DeviceStreamDecoder(precision="exact", interchange=interchange,
                                 mesh=make_mesh({"data": 4}))
        outs = dp.decode_stream([tower] * 8, batch_size=8)
        worst = max(_worst(o, ref) for o in outs)
        print(f"four data-parallel {interchange}: 8 x tower "
              f"max|diff| vs one card={worst} counts={dict(dp.counts)}",
              flush=True)
        if worst:
            raise AssertionError("data-parallel stream differs")

    giant = make_jpeg("420", 6720, 4480, seed + 4)      # 30.1 Mpix
    gold = Decoder(giant, backend="numpy", precision="exact").decode_array()
    sp = DeviceStreamDecoder(precision="exact", interchange="bits",
                             mesh=make_mesh({"stripe": 4}))
    out = sp.decode_striped(giant)
    worst = _worst(out, gold)
    sharding = getattr(out, "sharding", None)
    print(f"four stripe: 6720x4480 4:2:0 max|diff| vs oracle={worst} "
          f"sharding={sharding}", flush=True)
    if worst:
        raise AssertionError("striped decode differs from the oracle")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel and stripe "
                         "phase")
    args = ap.parse_args()

    import jax

    from jpeg_decoder_jax.entropy.native import get_native

    devices = jax.devices()
    print(f"devices: {devices}", flush=True)
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    if get_native() is None:
        print("native entropy library did not load", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    if args.four:
        if len(devices) < 4:
            print(f"--four needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        check_four(args.seed)
    else:
        inputs = _inputs(args.seed)
        print("inputs: " + ", ".join(f"{k}={len(v)} B"
                                     for k, v in inputs.items()), flush=True)
        check_kernels(inputs)
        check_streams(inputs)
        check_striped_single(inputs)
        sanity_rates(inputs, card)
    print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
