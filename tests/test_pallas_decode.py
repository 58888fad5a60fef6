"""Merged entropy sweeps: several images' anchored chunks decoded in one
sweep, and the stream's grouping that sends images there.

The sweeps run the plain-JAX engine here (the Pallas kernel's own parity is
in test_pallas.py); both engines take the same merged input.
"""

import numpy as np
import pytest

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.entropy.device_scan import (build_assembler_nat,
                                                  build_xla_sweep,
                                                  decode_anchored_device,
                                                  merge_scans)
from jpeg_decoder_jax.models import stream as sm
from jpeg_decoder_jax.testing.synth import make_jpeg


def _synth_jpeg(w, h, seed=0, kind="420"):
    return make_jpeg(kind, w, h, seed=seed)


def _scan(data):
    return sm.stage_host_bits(data).scans[0][0]


def test_merge_hetero_block_offsets():
    """merge_scans with per-image block counts: image i's anchors shift by
    the cumulative block offset, its bits by its word base, and every
    padding chunk owns no blocks."""
    a = _scan(_synth_jpeg(32, 16, seed=1))
    b = _scan(_synth_jpeg(48, 32, seed=2))
    words, bits, block, slot, bases = merge_scans([a, b])
    assert bases == [0, a.n_blocks]
    assert len(words) == len(a.words) + len(b.words)
    assert len(block) == len(bits) + 1 == len(slot) + 1
    ia, ib = len(a.anchor_bits), len(b.anchor_bits)
    assert np.array_equal(block[:a.n_items], a.anchor_block[:a.n_items])
    assert np.array_equal(block[ia:ia + b.n_items],
                          b.anchor_block[:b.n_items] + a.n_blocks)
    assert np.array_equal(bits[ia:ia + b.n_items].astype(np.int64),
                          b.anchor_bits[:b.n_items].astype(np.int64)
                          + 32 * len(a.words))
    budgets = np.diff(block)
    real = np.zeros(len(bits), bool)
    real[:a.n_items] = True
    real[ia:ia + b.n_items] = True
    assert (budgets[~real] == 0).all()
    assert budgets[real].sum() == a.n_blocks + b.n_blocks
    assert block[-1] == a.n_blocks + b.n_blocks and ib > 0


@pytest.mark.parametrize("case", ["same-plan", "mixed-size"])
def test_merged_sweep_matches_per_image(case):
    """One sweep over a merge + per-image assembly reproduces every image's
    stores exactly."""
    import jax

    sizes = ([(48, 32)] * 3 if case == "same-plan"
             else [(48, 32), (32, 16), (64, 48)])
    scans = [_scan(_synth_jpeg(w, h, seed=20 + i))
             for i, (w, h) in enumerate(sizes)]
    words, bits, block, slot, bases = merge_scans(scans)
    total = sum(s.n_blocks for s in scans)
    nat = np.asarray(jax.jit(build_xla_sweep(
        total + 5, max(s.plan.s_max for s in scans),
        tuple(scans[0].plan.pattern)))(words, bits, block, slot,
                                       scans[0].luts))
    assert not nat[total:].any()
    for st, off in zip(scans, bases):
        stores = jax.jit(build_assembler_nat(st.plan, flat_stores=False))(
            nat[off:off + st.n_blocks])
        gold = decode_anchored_device(st)
        for c, s in enumerate(stores):
            assert (np.asarray(s).reshape(-1) == np.asarray(gold[c])).all(), c


def test_mixed_size_stream_routes_hetero():
    """decode_stream groups mixed-size same-encoder images under the hetero
    key: ONE entropy sweep, one reconstruct per distinct plan, outputs in
    stream order and equal to the oracle."""
    imgs = [_synth_jpeg(32, 16, seed=5), _synth_jpeg(48, 32, seed=6),
            _synth_jpeg(32, 16, seed=7)]
    staged = [sm.stage_host_bits(d) for d in imgs]
    keys = {sm._bits_hetero_key(st) for st in staged}
    assert len(keys) == 1 and None not in keys, \
        "same-encoder mixed sizes must share the hetero group key"
    exact = {sm._bits_group_key(st) for st in staged}
    assert len(exact) == 2, "plans differ, exact keys must split"

    dec = sm.DeviceStreamDecoder(host_threads=1, interchange="bits",
                                 precision="exact")
    outs = dec.decode_stream(imgs, batch_size=4)
    assert dec.counts["sweeps"] == 1, "mixed sizes must take ONE sweep"
    assert dec.counts["dispatches"] == 3, "sweep + one reconstruct per plan"
    for data, out in zip(imgs, outs):
        gold = Decoder(data, backend="numpy").decode_array()
        assert np.array_equal(np.asarray(out), gold)


def test_hetero_grouping_is_size_aware(monkeypatch):
    """Images above the hetero Mpix threshold must group on the exact key,
    small ones on the hetero key."""
    small = sm.stage_host_bits(_synth_jpeg(320, 256, seed=11))
    big = sm.stage_host_bits(_synth_jpeg(1024, 768, seed=12))
    assert small.mpix <= 0.25 < big.mpix

    routed = []
    real_hetero = sm._bits_hetero_key

    def spy_hetero(st):
        routed.append(("hetero", st.mpix))
        return real_hetero(st)

    def fake_dispatch(self, group):
        return [None] * len(group)

    monkeypatch.setattr(sm, "_bits_hetero_key", spy_hetero)
    monkeypatch.setattr(sm.DeviceStreamDecoder, "_decode_group_bits",
                        fake_dispatch)
    dec = sm.DeviceStreamDecoder(host_threads=1, interchange="bits")
    outs = dec.decode_stream([_synth_jpeg(320, 256, seed=11),
                              _synth_jpeg(1024, 768, seed=12)], batch_size=4)
    assert len(outs) == 2
    # Exactly the small image consulted the hetero key.
    assert [r[0] for r in routed] == ["hetero"]
    assert routed[0][1] <= 0.25


@pytest.mark.parametrize("n", [2, 3, 8])
def test_same_plan_group_is_one_sweep(n):
    """n same-plan bits images with batch_size=8: one dispatch, one sweep
    (the group pads to a power-of-two batch), every output exact."""
    imgs = [_synth_jpeg(48, 32, seed=30 + i) for i in range(n)]
    dec = sm.DeviceStreamDecoder(host_threads=2, interchange="bits",
                                 precision="exact")
    outs = dec.decode_stream(imgs, batch_size=8)
    assert dict(dec.counts) == {"dispatches": 1, "sweeps": 1}
    for data, out in zip(imgs, outs):
        gold = Decoder(data, backend="numpy").decode_array()
        assert np.array_equal(np.asarray(out), gold)


def test_group_key_ignores_buckets_but_not_tables():
    """Same-geometry images merge whatever their word/chunk buckets; images
    with other Huffman tables (a transcoded progressive stream) do not."""
    a = sm.stage_host_bits(_synth_jpeg(64, 48, seed=40))
    b = sm.stage_host_bits(_synth_jpeg(64, 48, seed=41, kind="progressive"))
    assert sm._bits_group_key(a) is not None
    assert sm._bits_group_key(a) != sm._bits_group_key(b)
    assert sm._bits_group_key(a, True)[1] is a.scans[0][0].plan


def test_device_resident_rate_batched_shape():
    """device_resident_rate(batch>1) runs the merged-sweep program and
    reports per-image numbers for the batch it ran."""
    dec = sm.DeviceStreamDecoder(host_threads=1, interchange="bits")
    r = dec.device_resident_rate(_synth_jpeg(32, 32, seed=50), iters=2,
                                 reps=1, batch=4)
    assert r["batch"] == 4 and r["interchange"] == "bits-batch4"
    assert r["ms_per_image"] > 0
