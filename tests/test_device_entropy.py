"""Device-side anchored entropy decode vs the host oracle — bit-exact stores.

The anchored engine (entropy/device_scan.py) must produce coefficient stores
byte-identical to `decode_scan_dct` (the oracle mirroring
`/root/reference/src/decoder.rs:863-1172`) for every baseline scan it accepts.
"""


import numpy as np
import pytest

from conftest import REFTEST_IMAGES, reftest_files

from jpeg_decoder_jax import CodingProcess, Decoder
from jpeg_decoder_jax.entropy.device_scan import (
    PrescanFallback,
    decode_anchored_device,
    prescan_baseline,
)


class AnchorCapture:
    """Decoder hook staging every baseline scan for the device engine."""

    def __init__(self):
        self.scans = []   # (AnchoredScan, component_indices)
        self.used = False

    def wants(self, frame) -> bool:
        return True

    def decode_scan(self, decoder, frame, scan, finished):
        marker, staged = prescan_baseline(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval)
        self.used = True
        self.scans.append((staged, list(scan.component_indices)))
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
        return marker


def oracle_stores(path):
    d = Decoder(str(path))
    d._decode_entropy_only()
    n = len(d.frame.components)
    return [np.asarray(d._pending_render[i][0]) for i in range(n)], d


def device_stores(path):
    d = Decoder(str(path))
    cap = AnchorCapture()
    d._prefix_capture = cap
    d._decode_entropy_only()
    n = len(d.frame.components)
    out = [None] * n
    for staged, comp_indices in cap.scans:
        stores = decode_anchored_device(staged)
        for pos, comp_i in enumerate(comp_indices):
            out[comp_i] = np.asarray(stores[pos])
    return out, d


BASELINE_IMAGES = [
    "rgb.jpg",                            # 4:4:4-ish color
    "grayscale_square.jpg",
    "grayscale_16x24_sampling2x2.jpg",    # 2x2-sampled odd geometry
    "grayscale_24x16_sampling2x2.jpg",
    "restarts.jpg",                       # DRI segments
    "mjpeg.jpg",                          # AVI1 default tables
    "16bit-qtables.jpg",
    "extraneous-data.jpg",
    "mozilla/jpg-size-1x1.jpg",
    "mozilla/jpg-size-33x33.jpg",
    "mozilla/jpg-gray.jpg",
    "mozilla/jpg-cmyk-1.jpg",             # 4 components
    "ycck.jpg",
]


@pytest.mark.parametrize("name", BASELINE_IMAGES)
def test_device_stores_bit_exact(name):
    path = REFTEST_IMAGES / name
    if not path.exists():
        pytest.skip(f"{name} not in corpus")
    try:
        dev, _ = device_stores(path)
    except PrescanFallback as e:
        pytest.fail(f"prescan fell back on valid baseline image: {e}")
    gold, _ = oracle_stores(path)
    assert len(dev) == len(gold)
    for c, (a, b) in enumerate(zip(dev, gold)):
        assert a is not None, f"component {c} missing"
        assert a.dtype == np.int16
        bad = np.flatnonzero(a != b)
        assert bad.size == 0, (
            f"component {c}: {bad.size} coefficient mismatches, "
            f"first at {bad[:5]} dev={a[bad[:5]]} gold={b[bad[:5]]}")


def test_full_corpus_baseline_sweep():
    """Every sequential-DCT reftest image: anchored stores == oracle stores."""
    ran = 0
    for jpg in reftest_files():
        probe = Decoder(str(jpg))
        try:
            probe.read_info()
        except Exception:  # noqa: BLE001
            continue
        info = probe.info()
        if info is None or info.coding_process != CodingProcess.DCT_SEQUENTIAL:
            continue
        try:
            dev, _ = device_stores(jpg)
        except PrescanFallback:
            continue
        gold, _ = oracle_stores(jpg)
        for c, (a, b) in enumerate(zip(dev, gold)):
            assert a is not None and (a == b).all(), f"{jpg.name} comp {c}"
        ran += 1
    assert ran >= 25, f"only {ran} baseline images exercised the device engine"


def test_structured_assembler_matches_gather():
    """The structured (reshape/slice/transpose/pad) assembler must equal the
    general gather assembler bit for bit on random natural-order tensors —
    for every sampling shape, including DRI segmentation and int32 values
    that only agree modulo 2^16 (the wrap-16 DC contract)."""
    import jax

    from jpeg_decoder_jax.entropy.device_scan import build_assembler_nat
    from jpeg_decoder_jax.testing.synth import make_jpeg

    rng = np.random.default_rng(42)
    plans = []
    for kind in ("420", "422-dri", "444", "gray", "420-dri"):
        cap = AnchorCapture()
        d = Decoder(make_jpeg(kind, 72, 40, seed=3))
        d._prefix_capture = cap
        d._decode_entropy_only()
        plans.extend(st.plan for st, _ in cap.scans)
    assert plans and all(p.structured is not None for p in plans)

    for plan in plans:
        nat = rng.integers(-70000, 70000,
                           (plan.n_blocks, 64)).astype(np.int32)
        structured_fn = build_assembler_nat(plan)
        # Force the gather path by temporarily hiding the spec.
        spec, plan.structured = plan.structured, None
        gather_fn = build_assembler_nat(plan)
        plan.structured = spec
        a = jax.jit(structured_fn)(nat)
        b = jax.jit(gather_fn)(nat)
        for c, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype == np.int16
            assert (np.asarray(x) == np.asarray(y)).all(), \
                f"comp {c} of plan {plan._key}"


