"""Stripe-sharded device entropy decode: ONE giant image across N devices.

The last SURVEY §2a axis composed with the flagship bits path (VERDICT
round-4 item 1): anchored chunks are independent by construction, so the
image's MCU rows partition into contiguous stripes whose chunks each device
Huffman-decodes, assembles, and reconstructs LOCALLY. The only cross-stripe
couplings, and how they're closed:

- **DC predictor chain** (`/root/reference/src/decoder.rs:1102-1118`): the
  kernel emits stream-ordered DC *diffs*; a stripe's absolute DC is its
  local prefix sum plus the total diff sum of earlier stripes — one scalar
  all_gather per component over the stripe axis (`device_scan._dc_carry`).
  Restart-interval streams need no carry at all when stripe boundaries
  align with restart segments (the splitter only accepts that case: DC
  resets at each segment start, which is then always stripe-local).
- **Chunk straddling the stripe entry**: anchors land every ~K_CAP blocks,
  not on MCU-row boundaries, so stripe d's first chunk is the last chunk
  anchored at-or-before its first block. Its lead-in blocks belong to
  stripe d-1 (which decodes the same chunk as its tail) — the duplicate
  work is < one chunk per seam; rebased block indices go negative and both
  entropy engines drop the out-of-range emissions (device_scan.build_sweep).
- **V2 chroma upsampling halo** (`/root/reference/src/upsampler.rs:174-177`):
  1-row ppermute exchange, reused from the store-level stripe pipeline
  (`stripes.build_stripe_local_recon`).

Wire: per-stripe words slices + rebased anchors (the AnchoredScan arrays,
12 B/chunk). Per-stripe layouts are bucketed to a common shape so one
shard_map program covers every stripe.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np

from ..entropy.device_scan import AnchoredScan, ScanPlan, _bucket_up, _plan_for
from ..ops.pipeline import ImageGeometry
from .stripes import (_shard_map, _shard_map_uncheck_kwargs,
                      build_stripe_local_recon)


@dataclasses.dataclass
class StripeSplit:
    """One scan partitioned into per-stripe sub-scans (uniform layout)."""
    plan: ScanPlan            # per-stripe plan (shared by every stripe)
    n_stripes: int
    mcu_rows: int             # full-image decoded MCU rows
    k_mcu: int                # MCU rows per stripe
    n_blocks_local: int
    # XLA-engine arrays, stacked on a leading stripe axis:
    words: np.ndarray         # uint32 [n, Wb]
    anchor_bits: np.ndarray   # uint32 [n, I]
    anchor_block: np.ndarray  # int32  [n, I + 1]
    anchor_slot: np.ndarray   # int32  [n, I]
    luts: np.ndarray


def _stripe_ranges(blk, n_items, nb_local, n_stripes, n_blocks_real):
    """Per-stripe chunk index ranges [i0, i1): i0 = last chunk anchored
    at-or-before the stripe's first block (the straddler), i1 = first chunk
    anchored at-or-after the stripe end."""
    ranges = []
    for d in range(n_stripes):
        b0 = d * nb_local
        if b0 >= n_blocks_real or n_items == 0:
            ranges.append((0, 0))
            continue
        b1 = b0 + nb_local
        i0 = int(np.searchsorted(blk[:n_items], b0, side="right")) - 1
        i0 = max(i0, 0)
        i1 = int(np.searchsorted(blk[:n_items], b1, side="left"))
        ranges.append((i0, i1))
    return ranges


def split_anchored_stripes(staged: AnchoredScan, n_stripes: int):
    """Partition one anchored scan into `n_stripes` MCU-row stripes.

    Returns a StripeSplit, or None when the scan isn't stripe-eligible
    (no structured plan, too few MCU rows, restart segments that would
    straddle a stripe, non-1x1-sampled non-interleaved scan)."""
    plan = staged.plan
    if (staged.frame is None or staged.scan is None
            or plan.structured is None or n_stripes < 2):
        return None
    (n_mcus, rows_d, cols_d, plen), specs = plan.structured
    if rows_d < n_stripes:
        return None
    f = staged.frame
    interleaved = len(staged.scan.component_indices) > 1
    if interleaved:
        if rows_d != f.mcu_size.height:
            return None          # clip-quirk geometry; keep single-device
    else:
        comp = f.components[staged.scan.component_indices[0]]
        if (len(f.components) != 1
                or comp.horizontal_sampling_factor != 1
                or comp.vertical_sampling_factor != 1):
            return None

    k = -(-rows_d // n_stripes)
    bpr = cols_d * plen                      # blocks per MCU row
    nb_local = k * bpr
    for (_s0, bpm, _vs, _hs, _Hc, _W, seg_blocks) in specs:
        if seg_blocks and (k * cols_d * bpm) % seg_blocks:
            return None          # a restart segment would straddle a stripe

    # Per-stripe sub-plan: the stripe is a sub-image of k whole MCU rows.
    from ..parser import Dimensions, update_component_sizes
    sub = copy.deepcopy(f)
    v_max = (max(c.vertical_sampling_factor for c in f.components)
             if interleaved else 1)
    sub.image_size = Dimensions(f.image_size.width, k * 8 * v_max)
    sub.mcu_size = update_component_sizes(sub.image_size, sub.components)

    n = staged.n_items
    blk = staged.anchor_block[:n].astype(np.int64)
    ab = staged.anchor_bits[:n].astype(np.int64)
    ranges = _stripe_ranges(blk, n, nb_local, n_stripes, staged.n_blocks)

    # Uniform buckets across stripes.
    items_max = max((i1 - i0) for i0, i1 in ranges)
    if items_max == 0:
        return None
    I = _bucket_up(items_max)

    # Word windows: stripe d's bits end at the entry of chunk i1 (chunks
    # tile the bitstream; the truncated last chunk never reads past the
    # next anchor) or at the scan end for the final data stripe.
    w0s, w_his = [], []
    for d, (i0, i1) in enumerate(ranges):
        if i1 <= i0:
            w0s.append(0)
            w_his.append(0)
            continue
        bit_hi = int(ab[i1]) if i1 < n else staged.n_words * 32
        w0s.append(int(ab[i0]) >> 5)
        w_his.append(min(staged.n_words, (bit_hi >> 5) + 2))
    Wb = _bucket_up(max(h - l for l, h in zip(w0s, w_his)) + 2, 1024)

    words_s = np.zeros((n_stripes, Wb), np.uint32)
    abits_s = np.zeros((n_stripes, I), np.uint32)
    ablk_s = np.empty((n_stripes, I + 1), np.int32)
    aslot_s = np.zeros((n_stripes, I), np.int32)
    for d, (i0, i1) in enumerate(ranges):
        b0 = d * nb_local
        m = i1 - i0
        # Sentinel/pad: the true remaining block count, so the final data
        # stripe's last chunk stops at the real stream end instead of
        # decoding zero-padding bits across the crop region.
        fill = int(min(nb_local, max(staged.n_blocks - b0, 0)))
        ablk_s[d] = fill
        if m == 0:
            continue
        words_s[d, :w_his[d] - w0s[d]] = staged.words[w0s[d]:w_his[d]]
        abits_s[d, :m] = (ab[i0:i1] - (w0s[d] << 5)).astype(np.uint32)
        ablk_s[d, :m] = (blk[i0:i1] - b0).astype(np.int32)
        aslot_s[d, :m] = staged.anchor_slot[i0:i1]

    words_bucket = Wb
    sub_plan = _plan_for(sub, staged.scan, plan.restart_interval, I,
                         words_bucket, plan.s_max)
    st = sub_plan.structured
    if (st is None or st[0][0] != k * cols_d or st[0][3] != plen
            or sub_plan.n_blocks != nb_local):
        return None              # sub-geometry didn't reproduce the stream

    return StripeSplit(
        plan=sub_plan, n_stripes=n_stripes, mcu_rows=rows_d, k_mcu=k,
        n_blocks_local=nb_local, words=words_s, anchor_bits=abits_s,
        anchor_block=ablk_s, anchor_slot=aslot_s, luts=staged.luts)


@functools.lru_cache(maxsize=16)
def _compiled_stripe_bits(plan: ScanPlan, kept: tuple, ncomp: int,
                          geometry: ImageGeometry, mcu_rows: int,
                          n_stripes: int, mesh, stripe_axis: str,
                          engine: str):
    """Stripe pipeline: per-stripe entropy sweep (`engine`, see
    device_scan.build_sweep) + assembly (DC seam carry) + halo'd
    reconstruction in one shard_map program."""
    import jax

    from ..entropy.device_scan import build_anchored_decoder
    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)
    from jax.sharding import PartitionSpec as P

    decoder = build_anchored_decoder(plan, flat_stores=False,
                                     dc_carry_axis=stripe_axis,
                                     engine=engine)
    recon = build_stripe_local_recon(geometry, mcu_rows, n_stripes,
                                     stripe_axis)

    def shard_fn(words, abits, ablk, aslot, luts, qts):
        scan_stores = decoder(words[0], abits[0], ablk[0], aslot[0], luts)
        stores = [None] * ncomp
        for pos, comp_i in kept:
            stores[comp_i] = scan_stores[pos]
        return recon(tuple(stores), qts)

    sm = _shard_map()
    S, R = P(stripe_axis), P()
    fn = sm(shard_fn, mesh=mesh,
            in_specs=(S, S, S, S, R, (R,) * ncomp),
            out_specs=S, **_shard_map_uncheck_kwargs(sm))
    out_h = geometry.out_height
    return jax.jit(lambda *args: fn(*args)[:out_h])


@functools.lru_cache(maxsize=16)
def _compiled_stripe_bits_batch(plan: ScanPlan, kept: tuple, ncomp: int,
                                geometry: ImageGeometry, mcu_rows: int,
                                n_stripes: int, batch: int, mesh,
                                data_axis: str, stripe_axis: str):
    """DP x SP composed on the bits pipeline: a batch of same-layout images
    sharded over `data_axis`, each image's entropy decode + assembly +
    reconstruction striped over `stripe_axis`. Each device runs the
    single-image stripe program once per local image (a static loop: the
    straddling chunks' negative block bases rule out merging the images
    into one sweep); the halo ppermutes and DC-carry all_gathers ride the
    stripe axis."""
    import jax
    import jax.numpy as jnp

    from ..entropy.device_scan import build_anchored_decoder
    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)
    from jax.sharding import PartitionSpec as P

    decoder = build_anchored_decoder(plan, flat_stores=False,
                                     dc_carry_axis=stripe_axis)
    recon = build_stripe_local_recon(geometry, mcu_rows, n_stripes,
                                     stripe_axis)
    local_b = batch // int(mesh.shape[data_axis])

    def shard_fn(words, abits, ablk, aslot, luts, qts):
        outs = []
        for i in range(local_b):
            scan_stores = decoder(words[i, 0], abits[i, 0], ablk[i, 0],
                                  aslot[i, 0], luts)
            stores = [None] * ncomp
            for pos, comp_i in kept:
                stores[comp_i] = scan_stores[pos]
            outs.append(recon(tuple(stores), qts))
        return jnp.stack(outs)

    sm = _shard_map()
    D, R = P(data_axis, stripe_axis), P()
    fn = sm(shard_fn, mesh=mesh,
            in_specs=(D, D, D, D, R, (R,) * ncomp),
            out_specs=P(data_axis, stripe_axis),
            **_shard_map_uncheck_kwargs(sm))
    out_h = geometry.out_height
    return jax.jit(lambda *args: fn(*args)[:, :out_h])


def decode_bits_striped_batch(staged_list, mesh, data_axis: str = "data",
                              stripe_axis: str = "stripe"):
    """Decode a batch of SAME-LAYOUT staged images with batch DP over
    `data_axis` and per-image MCU-row stripes (entropy included) over
    `stripe_axis` — the full DP x SP composition on the flagship bits path.
    Returns the device pixel batch (cropped to the output height), or None
    when any image declines (different plans/layouts, stripe-ineligible).
    The batch must be a multiple of the data-axis size."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = int(mesh.shape[stripe_axis])
    nd = int(mesh.shape[data_axis])
    if not staged_list or len(staged_list) % nd:
        return None
    splits = []
    for st in staged_list:
        if st is None or len(st.scans) != 1:
            return None
        scan0, kept = st.scans[0]
        if len(kept) != len(st.qts):
            return None
        sp = split_anchored_stripes(scan0, n)
        if sp is None:
            return None
        splits.append(sp)
    s0 = splits[0]
    for sp in splits[1:]:
        if (sp.plan != s0.plan or sp.words.shape != s0.words.shape
                or sp.anchor_bits.shape != s0.anchor_bits.shape):
            return None
    g0 = staged_list[0].geometry
    if any(st.geometry != g0 for st in staged_list[1:]):
        return None

    kept = staged_list[0].scans[0][1]
    ncomp = len(staged_list[0].qts)
    fn = _compiled_stripe_bits_batch(
        s0.plan, tuple(kept), ncomp, g0, s0.mcu_rows, n,
        len(staged_list), mesh, data_axis, stripe_axis)

    sharded = NamedSharding(mesh, P(data_axis, stripe_axis))
    repl = NamedSharding(mesh, P())
    stack = lambda f: jax.device_put(
        np.stack([getattr(sp, f) for sp in splits]), sharded)
    qts = tuple(jax.device_put(np.asarray(q), repl)
                for q in staged_list[0].qts)
    return fn(stack("words"), stack("anchor_bits"), stack("anchor_block"),
              stack("anchor_slot"), jax.device_put(s0.luts, repl), qts)


def decode_bits_striped(staged_bits, mesh, stripe_axis: str = "stripe",
                        engine: str = None):
    """Decode ONE staged image with its MCU rows sharded over `mesh`'s
    stripe axis — entropy decode included. Returns the device pixel array
    (rows sharded over the stripe axis, cropped to the output height), or
    None when the image isn't stripe-eligible (caller falls back to the
    single-device pipeline).

    `staged_bits`: a models.stream.StagedBits in the bits interchange with
    one scan covering every component. `engine`: "triton" | "xla" | None
    (the platform's choice, jpeg_decoder_jax.platform.entropy_engine)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..platform import entropy_engine

    if staged_bits is None or len(staged_bits.scans) != 1:
        return None
    scan0, kept = staged_bits.scans[0]
    if len(kept) != len(staged_bits.qts):
        return None
    n = int(mesh.shape[stripe_axis])
    split = split_anchored_stripes(scan0, n)
    if split is None:
        return None

    geometry = staged_bits.geometry
    ncomp = len(staged_bits.qts)
    sharded = NamedSharding(mesh, P(stripe_axis))
    repl = NamedSharding(mesh, P())
    put_s = lambda a: jax.device_put(a, sharded)
    put_r = lambda a: jax.device_put(a, repl)
    qts = tuple(put_r(np.asarray(q)) for q in staged_bits.qts)
    fn = _compiled_stripe_bits(
        split.plan, tuple(kept), ncomp, geometry, split.mcu_rows, n, mesh,
        stripe_axis, engine or entropy_engine())
    return fn(put_s(split.words), put_s(split.anchor_bits),
              put_s(split.anchor_block), put_s(split.anchor_slot),
              put_r(split.luts), qts)
