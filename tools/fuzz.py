#!/usr/bin/env python
"""Mutation fuzzer for the decode engine — the AFL/libfuzzer analog.

The reference ships libfuzzer targets (differential vs mozjpeg, regression
vs previous versions) and AFL decode/info targets (`/root/reference/fuzz/`,
`/root/reference/fuzz-afl/`). This harness covers the same robustness
capability in-environment (zero-egress, no external fuzzer): seeded random
byte mutations of corpus images, decoded with both the native and oracle
entropy engines.

Invariants checked per mutant:
  1. decode() either succeeds or raises a typed JpegError — never any other
     exception, never a hang (alarm guard).
  2. native and oracle engines agree: same pixels or both error.
  3. independent oracle (the reference's fail_tmin-vs-mozjpeg analog,
     `/root/reference/fuzz/fuzz_targets/fail_tmin.rs:36-67`): when PIL/libjpeg
     also accepts the mutant and the output format maps cleanly (L8/RGB24),
     pixels agree within the reference's ±3 bar. PIL shares no code with this
     framework, so a spec misreading common to native+oracle is visible here.
     Triage (2026-08, round 2): pixel divergences on MUTATED streams are
     informational, not failures — inspection showed every class traces to
     legitimate semantic gaps on invalid data: (a) entropy-corruption
     recovery policy (libjpeg resyncs, the reference zero-fills), (b) DQT
     mutations driving IDCT overflow, where the reference (and this
     framework, bit-exactly) uses wrapping arithmetic
     (`/root/reference/src/idct.rs:1-3`) while libjpeg range-clamps, and
     (c) libjpeg's repair of broken DHT tables. Hard failures remain:
     dimension disagreement when both accept, plus invariants 1-2. The
     authoritative valid-stream PIL parity check lives in
     tests/test_pil_differential.py (full corpus, ±3).

Usage: python tools/fuzz.py [iterations] [seed]
"""

from __future__ import annotations

import os
import random
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = [
    "/root/reference/tests/reftest/images/rgb.jpg",
    "/root/reference/tests/reftest/images/mozilla/jpg-progressive.jpg",
    "/root/reference/tests/reftest/images/restarts.jpg",
    "/root/reference/tests/reftest/images/mozilla/jpg-cmyk-1.jpg",
    "/root/reference/tests/reftest/images/lossless/1/jpeg_lossless_sel1.jpg",
    "/root/reference/tests/reftest/images/grayscale_16x24_sampling2x2.jpg",
]


def mutate(data: bytes, rng: random.Random) -> bytes:
    buf = bytearray(data)
    n_mut = rng.randint(1, 8)
    for _ in range(n_mut):
        op = rng.random()
        if op < 0.6 and buf:  # flip bytes
            i = rng.randrange(len(buf))
            buf[i] = rng.randrange(256)
        elif op < 0.8 and buf:  # truncate
            buf = buf[:rng.randrange(1, len(buf) + 1)]
        else:  # duplicate a slice
            if len(buf) > 4:
                a = rng.randrange(len(buf) - 2)
                b = min(len(buf), a + rng.randrange(1, 64))
                buf[a:a] = buf[a:b]
    return bytes(buf)


def pil_decode(data: bytes):
    """Independent libjpeg-backed decode. Returns (mode, np.uint8 array) or
    None when PIL rejects the stream or the format doesn't map cleanly."""
    import io

    import numpy as np
    from PIL import Image

    try:
        im = Image.open(io.BytesIO(data))
        im.load()
    except Exception:  # noqa: BLE001 — any PIL rejection just skips the oracle
        return None
    if im.mode not in ("L", "RGB"):
        return None
    return im.mode, np.asarray(im)


def compare_with_pil(our_pixels: bytes, decoder, data: bytes):
    """Returns None if incomparable, True if within ±3, else a message."""
    import numpy as np

    from jpeg_decoder_jax import CodingProcess, PixelFormat

    info = decoder.info()
    if info is None or info.coding_process == CodingProcess.LOSSLESS:
        return None  # PIL has no SOF3 support
    pil = pil_decode(data)
    if pil is None:
        return None
    mode, theirs = pil
    want_mode = {PixelFormat.L8: "L", PixelFormat.RGB24: "RGB"}.get(
        info.pixel_format)
    if want_mode != mode:
        return None
    ours = np.frombuffer(our_pixels, np.uint8)
    if theirs.shape[:2] != (info.height, info.width) or ours.size != theirs.size:
        return f"shape mismatch: ours {info.width}x{info.height}, PIL {theirs.shape}"
    diff = np.abs(ours.reshape(theirs.shape).astype(np.int16)
                  - theirs.astype(np.int16))
    if diff.max() <= 3:
        return True
    return f"max diff {int(diff.max())}, {int((diff > 3).sum())} bad samples"


def run(iterations: int = 500, seed: int = 0, timeout_s: int = 60) -> int:
    from jpeg_decoder_jax import Decoder, JpegError

    class _Hang(Exception):
        pass

    def _on_alarm(signum, frame):
        raise _Hang(f"decode exceeded {timeout_s}s")

    signal.signal(signal.SIGALRM, _on_alarm)

    rng = random.Random(seed)
    seeds = [open(p, "rb").read() for p in SEEDS if os.path.exists(p)]
    failures = 0
    pil_compared = 0
    pil_entropy_diverged = 0

    def first_sos_data(seed_bytes: bytes) -> int:
        """Offset where the first scan's entropy data begins in the seed."""
        i = seed_bytes.find(b"\xff\xda")
        if i < 0:
            return len(seed_bytes)
        seg_len = int.from_bytes(seed_bytes[i + 2:i + 4], "big")
        return i + 2 + seg_len

    def decode(data: bytes, disable_native: bool):
        import jpeg_decoder_jax.entropy.native as native_mod
        if disable_native:
            os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
        else:
            os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
        native_mod.reset_native_cache()
        d = Decoder(data)
        # Dimension-field mutations produce legitimate 100+ Mpix images whose
        # decode blows the hang budget under load (observed: a 191 Mpix
        # lossless mutant at 8.7s uncontended). Cap the output like a
        # production caller would (the reference's DoS guard,
        # set_max_decoding_buffer_size) — both engines get the same cap, so
        # the differential stays exact.
        cap = 64 << 20
        d.set_max_decoding_buffer_size(cap)
        try:
            # The guard fires at end-of-image assembly (the reference's
            # placement, decoder.rs:631-641) — AFTER the full entropy
            # decode, so a 600-Mpix mutant still burns minutes before the
            # inevitable FormatError (observed: mutant 1785, 625 Mpix in
            # 27s uncontended). Short-circuit oversized frames up front;
            # both engines take the identical branch, so the differential
            # is unaffected.
            d.read_info()
            info = d.info()
            if info is not None:
                ncomp = {"L8": 1, "L16": 1, "RGB24": 3, "CMYK32": 4}.get(
                    info.pixel_format.name, 4)
                # Tighter than the decode cap: a 46M-sample mutant passes
                # the 64M cap but the pure-Python oracle needs minutes on
                # it (observed: mutant 5816, 15.3 Mpix in 0.9s native /
                # >60s oracle). Every real seed is <= 10.3M samples.
                if info.width * info.height * ncomp > 16 << 20:
                    return "ERR:FormatError(oversize-precheck)", d
            return d.decode(), d
        except JpegError as e:
            return f"ERR:{type(e).__name__}", d

    class _Chunks:
        """Non-seekable capped reader (socket stand-in) for the streaming leg."""

        def __init__(self, data: bytes):
            self._d, self._p = data, 0

        def read(self, n: int) -> bytes:
            n = min(n, 4096)
            c = self._d[self._p:self._p + n]
            self._p += len(c)
            return c

    def decode_streaming(data: bytes):
        """Third leg: the windowed streaming decode (refill/compact bit loop)
        must agree with the drained oracle on every mutant — same pixels or
        the same typed-error class. Skips (returns None) above 4M samples:
        this leg doubles the pure-Python oracle cost under the shared alarm,
        and small mutants exercise the refill/compact logic just as fully."""
        d = Decoder(_Chunks(data), streaming=True)
        d.set_max_decoding_buffer_size(64 << 20)
        try:
            d.read_info()
            info = d.info()
            if info is not None:
                ncomp = {"L8": 1, "L16": 1, "RGB24": 3, "CMYK32": 4}.get(
                    info.pixel_format.name, 4)
                if info.width * info.height * ncomp > 4 << 20:
                    return None, d
            return d.decode(), d
        except JpegError as e:
            return f"ERR:{type(e).__name__}", d

    for i in range(iterations):
        seed_bytes = rng.choice(seeds)
        if rng.random() < 0.3:
            # Header-only point mutations: keeps the PIL oracle authoritative
            # (parser/table semantics, not entropy-recovery policy).
            buf = bytearray(seed_bytes)
            sos = first_sos_data(seed_bytes)
            for _ in range(rng.randint(1, 4)):
                buf[rng.randrange(2, max(3, sos))] = rng.randrange(256)
            data = bytes(buf)
        else:
            data = mutate(seed_bytes, rng)
        signal.alarm(timeout_s)
        try:
            a, da = decode(data, disable_native=False)
            b, _ = decode(data, disable_native=True)
            c, _ = decode_streaming(data)
            verdict = None
            if isinstance(a, bytes):
                verdict = compare_with_pil(a, da, data)
        except Exception as e:  # noqa: BLE001 — any non-JpegError is a bug
            failures += 1
            path = f"/tmp/fuzz_crash_{i}.jpg"
            open(path, "wb").write(data)
            print(f"[{i}] CRASH {type(e).__name__}: {e} -> {path}")
            continue
        finally:
            signal.alarm(0)
        if a != b:
            failures += 1
            path = f"/tmp/fuzz_diff_{i}.jpg"
            open(path, "wb").write(data)
            print(f"[{i}] NATIVE/ORACLE DIVERGENCE -> {path}")
        if c is not None and c != b:
            failures += 1
            path = f"/tmp/fuzz_stream_{i}.jpg"
            open(path, "wb").write(data)
            print(f"[{i}] STREAMING/ORACLE DIVERGENCE -> {path}")
        if verdict is not None:
            pil_compared += 1
            if verdict is not True:
                if isinstance(verdict, str) and verdict.startswith("shape"):
                    failures += 1
                    path = f"/tmp/fuzz_pil_{i}.jpg"
                    open(path, "wb").write(data)
                    print(f"[{i}] PIL SHAPE DIVERGENCE ({verdict}) -> {path}")
                else:
                    pil_entropy_diverged += 1
                    path = f"/tmp/fuzz_pilnote_{i}.jpg"
                    open(path, "wb").write(data)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{iterations} done, {failures} failures, "
                  f"{pil_compared} PIL-compared "
                  f"({pil_entropy_diverged} invalid-stream diffs, expected)")

    print(f"fuzz complete: {iterations} mutants, {failures} failures, "
          f"{pil_compared} PIL-compared, "
          f"{pil_entropy_diverged} invalid-stream diffs (informational)")
    return failures


def run_device(iterations: int = 300, seed: int = 0,
               timeout_s: int = 60) -> int:
    """Device-engine differential fuzz (CPU/XLA): the bits-path safety
    property is that the prescan either FALLS BACK (host decodes, oracle
    semantics) or ACCEPTS — and every accepted stream must produce stores
    bit-identical to the host oracle. Mutants are biased into the entropy
    section (header mutations mostly change the plan shape, which costs an
    XLA compile per shape without exercising the decode kernels)."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from jpeg_decoder_jax import Decoder, JpegError
    from jpeg_decoder_jax.entropy.device_scan import (
        PrescanFallback,
        decode_anchored_device,
        prescan_baseline,
    )

    class _Hang(Exception):
        pass

    def _on_alarm(signum, frame):
        raise _Hang(f"exceeded {timeout_s}s")

    signal.signal(signal.SIGALRM, _on_alarm)

    class Cap:
        def __init__(self):
            self.scans = []

        def wants(self, frame):
            return True

        def decode_scan(self, dec, frame, scan, fin):
            m, st = prescan_baseline(
                dec._cursor, frame, scan, dec._dc_huffman_tables,
                dec._ac_huffman_tables, dec._restart_interval)
            self.scans.append((st, list(scan.component_indices)))
            for ci in scan.component_indices:
                qt = dec._quantization_tables[
                    frame.components[ci].quantization_table_index]
                dec._pending_render[ci] = (None, qt.copy())
            return m

    # Baseline seeds only (the bits path's eligibility set).
    seeds = [open(p, "rb").read() for p in SEEDS
             if os.path.exists(p) and "lossless" not in p
             and "progressive" not in p]
    rng = random.Random(seed)
    failures = accepted = fallbacks = errors = 0

    def sos_off(b: bytes) -> int:
        i = b.find(b"\xff\xda")
        if i < 0:
            return 2
        return i + 2 + int.from_bytes(b[i + 2:i + 4], "big")

    for i in range(iterations):
        seed_bytes = rng.choice(seeds)
        buf = bytearray(seed_bytes)
        lo = sos_off(seed_bytes)
        for _ in range(rng.randint(1, 8)):
            buf[rng.randrange(lo, len(buf))] = rng.randrange(256)
        data = bytes(buf)
        signal.alarm(timeout_s)
        try:
            cap = Cap()
            d = Decoder(data, backend="numpy")
            d._prefix_capture = cap
            try:
                d._decode_entropy_only()
            except PrescanFallback:
                fallbacks += 1
                continue
            except JpegError:
                errors += 1
                continue
            if not cap.scans:
                fallbacks += 1
                continue
            # Host oracle stores on the same bytes.
            o = Decoder(data, backend="numpy")
            try:
                o._decode_entropy_only()
            except JpegError as e:
                failures += 1
                path = f"/tmp/fuzz_dev_accept_{i}.jpg"
                open(path, "wb").write(data)
                print(f"[{i}] PRESCAN ACCEPTED, ORACLE RAISED "
                      f"{type(e).__name__} -> {path}")
                continue
            ok = True
            for st, comp_idx in cap.scans:
                dev = decode_anchored_device(st)
                for pos, ci in enumerate(comp_idx):
                    gold = np.asarray(o._pending_render[ci][0]).reshape(-1)
                    got = np.asarray(dev[pos]).reshape(-1)
                    if got.shape != gold.shape or (got != gold).any():
                        ok = False
            if not ok:
                failures += 1
                path = f"/tmp/fuzz_dev_diff_{i}.jpg"
                open(path, "wb").write(data)
                print(f"[{i}] DEVICE/ORACLE STORE DIVERGENCE -> {path}")
            else:
                accepted += 1
        except Exception as e:  # noqa: BLE001 — any non-JpegError is a bug
            failures += 1
            path = f"/tmp/fuzz_dev_crash_{i}.jpg"
            open(path, "wb").write(data)
            print(f"[{i}] CRASH {type(e).__name__}: {e} -> {path}")
        finally:
            signal.alarm(0)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{iterations} done: {accepted} accepted+verified, "
                  f"{fallbacks} fallbacks, {errors} typed errors, "
                  f"{failures} failures")

    print(f"device fuzz complete: {iterations} mutants, {accepted} "
          f"accepted+verified, {fallbacks} fallbacks, {errors} typed "
          f"errors, {failures} failures")
    return failures




# ---------------------------------------------------------------------------
# Coverage-guided mode (the AFL-analog feedback loop the random scheduler
# lacks — round-3, verdict item 8).


class _LineCoverage:
    """Line-coverage collector over jpeg_decoder_jax's Python layers via
    sys.monitoring (PEP 669). The callback DISABLEs each (code, line) event
    after its first firing, so after warm-up only genuinely NEW lines fire —
    per-run overhead is near zero and "events fired this run" IS the
    new-coverage count, exactly the AFL feedback signal."""

    TOOL = 3  # sys.monitoring.OPTIMIZER_ID slot (unused in CPython today)

    def __init__(self, prefix: str):
        import sys as _sys
        self.mon = _sys.monitoring
        self.prefix = prefix
        self.total: set = set()
        self.run_new = 0
        self.mon.use_tool_id(self.TOOL, "jt-fuzz-coverage")
        self.mon.register_callback(self.TOOL, self.mon.events.LINE,
                                   self._on_line)
        self.mon.set_events(self.TOOL, self.mon.events.LINE)

    def _on_line(self, code, line):
        if not code.co_filename.startswith(self.prefix):
            return self.mon.DISABLE
        key = (id(code), line)
        if key not in self.total:
            self.total.add(key)
            self.run_new += 1
        return self.mon.DISABLE

    def begin_run(self):
        self.run_new = 0

    def reset(self):
        """Re-arm every DISABLEd event and forget coverage (for the
        random-vs-guided comparison phases)."""
        self.total.clear()
        self.mon.restart_events()

    def close(self):
        self.mon.set_events(self.TOOL, 0)
        self.mon.free_tool_id(self.TOOL)


AFL_CORPUS_DIR = "/root/reference/fuzz-afl/in"


def _guided_seeds(max_bytes: int = 1 << 16):
    paths = [p for p in SEEDS if os.path.exists(p)]
    if os.path.isdir(AFL_CORPUS_DIR):
        paths += [os.path.join(AFL_CORPUS_DIR, f)
                  for f in sorted(os.listdir(AFL_CORPUS_DIR))
                  if f.endswith(".jpg")]
    out = []
    for p in paths:
        data = open(p, "rb").read()
        if len(data) <= max_bytes:
            out.append(data)
    return out


def run_guided(iterations: int = 2000, seed: int = 0,
               out_json: str = "/tmp/fuzz_guided_curve.json",
               timeout_s: int = 20, lean_seeds: bool = False) -> int:
    """Coverage-feedback fuzzing of the Python decode layers (parser, driver,
    oracle entropy, device prescan mirror): inputs that light up new lines
    join the live corpus and get preferentially re-mutated. Runs the same
    budget with the flat random scheduler first and writes both coverage
    curves to `out_json` — the measured guided-vs-random comparison.

    The Python oracle is forced (JPEG_JAX_DISABLE_NATIVE) so the feedback
    signal sees the decode layers; crash/differential verification of any
    corpus this mode grows stays with run()/run_device()."""
    import json

    os.environ["JPEG_JAX_DISABLE_NATIVE"] = "1"
    import jpeg_decoder_jax.entropy.native as native_mod
    native_mod.reset_native_cache()
    from jpeg_decoder_jax import Decoder, JpegError

    import jpeg_decoder_jax as pkg
    prefix = os.path.dirname(os.path.abspath(pkg.__file__))

    class _Hang(Exception):
        pass

    def _on_alarm(signum, frame):
        raise _Hang()

    signal.signal(signal.SIGALRM, _on_alarm)

    cov = _LineCoverage(prefix)
    if lean_seeds:
        # One minimal seed: coverage starts unsaturated, so the guided-vs-
        # random delta measures the feedback loop itself (with the full AFL
        # corpus as seeds, both schedulers start from ~saturated coverage
        # and the curves overlap — see tools/artifacts/).
        seeds = [open(SEEDS[0], "rb").read()]
    else:
        seeds = _guided_seeds()
    crashes = []

    def decode_one(data: bytes) -> None:
        signal.alarm(timeout_s)
        try:
            d = Decoder(data, backend="numpy")
            d.set_max_decoding_buffer_size(1 << 24)
            d.decode()
        except JpegError:
            pass
        except _Hang:
            pass
        except Exception as e:  # noqa: BLE001 — a genuine fuzz find
            path = f"/tmp/fuzz_guided_crash_{len(crashes)}.jpg"
            open(path, "wb").write(data)
            crashes.append((type(e).__name__, str(e)[:120], path))
        finally:
            signal.alarm(0)

    def phase(guided: bool):
        rng = random.Random(seed)
        corpus = [bytearray(s) for s in seeds]
        energy = [1.0] * len(corpus)
        curve = []
        # Baseline: the seeds themselves.
        for s in corpus:
            cov.begin_run()
            decode_one(bytes(s))
        for i in range(iterations):
            if guided:
                # Energy-weighted parent choice (productive parents breed).
                total = sum(energy)
                r = rng.random() * total
                acc = 0.0
                pi = 0
                for pi, e in enumerate(energy):
                    acc += e
                    if acc >= r:
                        break
                parent = corpus[pi]
            else:
                pi = rng.randrange(len(seeds))
                parent = corpus[pi]
            data = mutate(bytes(parent), rng)
            cov.begin_run()
            decode_one(data)
            if guided and cov.run_new > 0:
                corpus.append(bytearray(data))
                energy.append(1.0 + cov.run_new)
                energy[pi] += 0.5
            if (i + 1) % 100 == 0:
                curve.append((i + 1, len(cov.total)))
        curve.append((iterations, len(cov.total)))
        return curve, len(corpus) - len(seeds)

    random_curve, _ = phase(guided=False)
    random_total = len(cov.total)
    cov.reset()
    guided_curve, grown = phase(guided=True)
    guided_total = len(cov.total)
    cov.close()
    os.environ.pop("JPEG_JAX_DISABLE_NATIVE", None)
    native_mod.reset_native_cache()

    result = {
        "iterations": iterations,
        "seed": seed,
        "seeds": len(seeds),
        "random_final_lines": random_total,
        "guided_final_lines": guided_total,
        "guided_corpus_grown": grown,
        "random_curve": random_curve,
        "guided_curve": guided_curve,
        "crashes": crashes,
    }
    with open(out_json, "w") as f:
        json.dump(result, f)
    print(f"guided fuzz: {iterations} iters x2 phases, seeds {len(seeds)}; "
          f"lines random {random_total} -> guided {guided_total} "
          f"(+{guided_total - random_total}), corpus grew {grown}; "
          f"crashes {len(crashes)} -> {out_json}")
    for c in crashes:
        print("CRASH", c)
    return len(crashes)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]
            if a not in ("--device", "--guided", "--lean-seeds")]
    iters = int(args[0]) if len(args) > 0 else 500
    seed = int(args[1]) if len(args) > 1 else 0
    if "--guided" in sys.argv[1:]:
        lean = "--lean-seeds" in sys.argv[1:]
        out = ("/tmp/fuzz_guided_curve_lean.json" if lean
               else "/tmp/fuzz_guided_curve.json")
        sys.exit(1 if run_guided(iters, seed, out_json=out,
                                 lean_seeds=lean) else 0)
    if "--device" in sys.argv[1:]:
        sys.exit(1 if run_device(iters, seed) else 0)
    sys.exit(1 if run(iters, seed) else 0)
