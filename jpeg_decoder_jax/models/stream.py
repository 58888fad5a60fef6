"""Decode-to-device streaming: bytes in host memory in, pixels in device
memory out; the host never reads pixels back. Two interchanges carry an
image from the host stages to the device:

- "prefix": the host runs the entropy stage and ships coefficients in a
  zigzag-prefix format — a dense int16 [blocks, K] tensor of each block's
  first K zigzag coefficients (rebuilt on device with a static column
  permutation) plus a small COO residual for nonzeros beyond the prefix,
  applied with one scatter-add (~0.9 B/px);
- "bits": the host prescans the entropy-coded bytes into anchored chunks and
  ships the bytes themselves (~0.2 B/px); the device runs the Huffman decode
  (entropy/device_scan.py, entropy/triton_decode.py).

Stages are overlapped: a host thread pool stages images, device_put and jit
dispatch are asynchronous. Images of one group share one device dispatch.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import os
import threading
from typing import Iterable

import numpy as np

from ..decoder import Decoder
from ..entropy.scan_python import UNZIGZAG
from ..ops.pipeline import ImageGeometry, _reconstruct, geometry_from_frame
from ..parser import CodingProcess

PREFIX_K = 16


def _tune_malloc() -> None:
    """Keep multi-MB numpy buffers on the heap instead of per-allocation mmap.

    glibc mmaps allocations above ~128KB and munmaps them on free, so every
    per-image tensor (prefix, residuals) pays full page-fault cost again —
    measured at 100+ ms per large_image-class decode. Raising the mmap
    threshold (and disabling trim) makes the heap retain and reuse the pages.
    """
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_malloc()

# Natural index -> zigzag position (inverse of UNZIGZAG).
_ZIGZAG_OF_NATURAL = np.zeros(64, np.int32)
for _z, _n in enumerate(UNZIGZAG):
    _ZIGZAG_OF_NATURAL[_n] = _z


def _bucket(n: int, floor: int = 2048) -> int:
    """Round up to a compile-friendly bucket (1.3x geometric steps)."""
    size = floor
    while size < n:
        size = int(size * 1.3) + (-int(size * 1.3) % 256)
    return size


def _recon(geometry: ImageGeometry, layout: str, stores, qts):
    """Traced reconstruction of one image's stores in the output layout:
    "interleaved" [H, W, C] or "planar" [C, H, W]."""
    import jax.numpy as jnp

    out = _reconstruct(geometry, stores, qts, jnp)
    if layout == "planar" and out.ndim == 3:
        return jnp.transpose(out, (2, 0, 1))
    return out


@functools.lru_cache(maxsize=256)
def _compiled_prefix_pipeline(geometry: ImageGeometry, resid_bucket: int,
                              layout: str = "interleaved"):
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)

    comps = geometry.components
    nblocks = [c.blocks_high * c.blocks_wide for c in comps]
    sizes = [n * 64 for n in nblocks]
    offsets = np.cumsum([0] + sizes)[:-1]
    total = int(sum(sizes))
    perm = tuple(int(x) for x in _ZIGZAG_OF_NATURAL)

    def run(dc, ac, resid_idx, resid_vals, qts):
        # dc: int16 [sum(nblocks)]; ac: int8 [sum(nblocks), K-1] (zigzag
        # slots 1..K-1, saturated; corrections ride the residual).
        padded = jnp.concatenate(
            [dc[:, None], ac.astype(jnp.int16),
             jnp.zeros((dc.shape[0], 64 - PREFIX_K), jnp.int16)], axis=1)
        dense_blocks = padded[:, jnp.asarray(perm)]       # natural order
        dense = dense_blocks.reshape(-1)
        dense = dense.at[resid_idx].add(resid_vals, mode="drop")
        stores = [
            dense[int(o):int(o) + int(s)].reshape(-1, 64)
            for o, s in zip(offsets, sizes)
        ]
        return _recon(geometry, layout, stores, qts)

    return jax.jit(run)


@functools.lru_cache(maxsize=128)
def _compiled_prefix_pipeline_batched(geometry: ImageGeometry, resid_bucket: int,
                                      batch: int, mesh=None,
                                      data_axis: str = "data",
                                      layout: str = "interleaved"):
    """vmapped variant of the prefix pipeline: one dispatch decodes `batch`
    same-geometry images (amortizes per-call RPC/dispatch overhead, which
    dominates sub-megapixel images).

    With `mesh`, the batch axis is sharded over `data_axis` — the streaming
    service's data-parallel scale-out path (SURVEY.md §2a DP): every input
    and the output pixel batch carry NamedShardings, XLA inserts no
    collectives, and each chip decodes its shard of the image batch."""
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)

    comps = geometry.components
    nblocks = [c.blocks_high * c.blocks_wide for c in comps]
    sizes = [n * 64 for n in nblocks]
    offsets = np.cumsum([0] + sizes)[:-1]
    total = int(sum(sizes))
    perm = tuple(int(x) for x in _ZIGZAG_OF_NATURAL)

    def run_one(dc, ac, resid_idx, resid_vals, qts):
        padded = jnp.concatenate(
            [dc[:, None], ac.astype(jnp.int16),
             jnp.zeros((dc.shape[0], 64 - PREFIX_K), jnp.int16)], axis=1)
        dense = padded[:, jnp.asarray(perm)].reshape(-1)
        dense = dense.at[resid_idx].add(resid_vals, mode="drop")
        stores = [dense[int(o):int(o) + int(s)].reshape(-1, 64)
                  for o, s in zip(offsets, sizes)]
        return _recon(geometry, layout, stores, qts)

    batched = jax.vmap(run_one, in_axes=(0, 0, 0, 0, 0))
    if mesh is None:
        return jax.jit(batched)

    from jax.sharding import NamedSharding, PartitionSpec as PS
    sharded = NamedSharding(mesh, PS(data_axis))
    ncomp = len(comps)
    return jax.jit(
        batched,
        in_shardings=(sharded, sharded, sharded, sharded, (sharded,) * ncomp),
        out_shardings=sharded)


def _anchored_enabled() -> bool:
    """Host-parallel anchored entropy decode for non-DRI baseline scans
    (entropy.cc jt_decode_scan_dct_prefix_anchored): prescan walk + N-thread
    re-decode from MCU-aligned anchors, on hosts with at least 4 cores.
    JPEG_JAX_ANCHORED=1 forces it on (0 off) regardless."""
    import os
    v = os.environ.get("JPEG_JAX_ANCHORED")
    if v is not None:
        return v not in ("0", "", "off")
    return (os.cpu_count() or 1) >= 4


def _batch_bucket(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


@dataclasses.dataclass
class StagedImage:
    geometry: ImageGeometry
    dc: np.ndarray          # int16 [sum_blocks]
    ac: np.ndarray          # int8 [sum_blocks, K-1], saturated zigzag slots
    resid_idx: np.ndarray   # int32 [resid_bucket]; padding -> out of range (dropped)
    resid_vals: np.ndarray  # int16 [resid_bucket]
    qts: tuple
    total_coeffs: int
    mpix: float


class _BufferPool:
    """Reusable host buffers keyed by (dtype, size). Large per-image numpy
    allocations hit mmap/page-fault churn (~100s of ms for 20MB-class
    tensors); pooling keeps the pages resident across images.

    Bounded: at most `depth` buffers per (dtype, size) and `budget` total
    bytes — a long-lived service decoding diverse image sizes must not grow
    without limit. Eviction drops the least-recently-released size class."""

    def __init__(self, depth: int = 8, budget: int = 1 << 30):
        self._lock = threading.Lock()
        self._free: dict = {}
        self._depth = depth
        self._budget = budget
        self._bytes = 0

    def acquire(self, size: int, dtype) -> np.ndarray:
        key = (np.dtype(dtype).str, size)
        with self._lock:
            stack = self._free.get(key)
            if stack:
                arr = stack.pop()
                self._bytes -= arr.nbytes
                return arr
        return np.empty(size, dtype=dtype)

    def release(self, arr: np.ndarray) -> None:
        key = (arr.dtype.str, arr.size)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) >= self._depth:
                return  # drop: per-class cap
            stack.append(arr)
            self._free[key] = stack
            # Move to MRU position for budget eviction order.
            self._free.pop(key)
            self._free[key] = stack
            self._bytes += arr.nbytes
            while self._bytes > self._budget and len(self._free) > 1:
                old_key = next(iter(self._free))
                if old_key == key:
                    break
                for dropped in self._free.pop(old_key):
                    self._bytes -= dropped.nbytes


_pool = _BufferPool()


class PrefixCapture:
    """Receives baseline scan output in the device interchange format straight
    from the native entropy kernel — no dense 64-coefficient stores ever exist
    on the host, roughly quartering per-image host memory traffic (the staging
    stage is DRAM-bandwidth-bound at multi-worker rates)."""

    def __init__(self, native, k: int = PREFIX_K, pool_width: int = 1):
        self.native = native
        self.k = k
        self.pool_width = max(1, pool_width)
        self.prefix_arrays: dict = {}   # frame comp index -> int16 [nblocks, K]
        self.bases: list = []
        self.sizes: list = []
        self.total = 0
        self.resid_idx = None
        self.resid_vals = None
        self.resid_count = 0
        self.used = False

    def wants(self, frame) -> bool:
        return True

    def _ensure_layout(self, frame) -> None:
        if self.bases:
            return
        self.sizes = [c.block_size.width * c.block_size.height * 64
                      for c in frame.components]
        self.bases = list(np.cumsum([0] + self.sizes)[:-1])
        self.total = int(sum(self.sizes))
        self.resid_idx = _pool.acquire(self.total, np.int32)
        self.resid_vals = _pool.acquire(self.total, np.int16)

    def _prefix_for(self, comp_i: int, frame):
        pair = self.prefix_arrays.get(comp_i)
        if pair is None:
            nblocks = self.sizes[comp_i] // 64
            dc = _pool.acquire(nblocks, np.int16)
            ac_flat = _pool.acquire(nblocks * (self.k - 1), np.int8)
            self.native.zero_buffer(dc)
            self.native.zero_buffer(ac_flat)
            pair = (dc, ac_flat.reshape(nblocks, self.k - 1))
            self.prefix_arrays[comp_i] = pair
        return pair

    def decode_scan(self, decoder, frame, scan, finished):
        self._ensure_layout(frame)
        self.used = True
        dcs, acs, bases = [], [], []
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                dc, ac = self._prefix_for(comp_i, frame)
                dcs.append(dc)
                acs.append(ac)
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
            else:
                dcs.append(None)  # dummy-block case
                acs.append(None)
            bases.append(self.bases[comp_i])

        anchored = self._try_anchored(decoder, frame, scan, dcs, acs, bases)
        if anchored is not None:
            return anchored[0]

        marker, self.resid_count = self.native.decode_scan_dct_prefix(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval, dcs, acs, bases, self.k,
            self.resid_idx, self.resid_vals, self.resid_count)
        return marker

    def _try_anchored(self, decoder, frame, scan, dcs, acs, bases):
        """Prescan + multi-thread anchored decode of one baseline scan.
        Returns (marker,) on success (cursor already past the scan) or None
        to run the serial path — on kernel fallback the cursor is restored
        and the prefix outputs are re-zeroed by the kernel itself."""
        import os

        from ..parser import CodingProcess
        if not _anchored_enabled():
            return None
        if frame.coding_process == CodingProcess.DCT_PROGRESSIVE:
            return None
        if (decoder._restart_interval > 0
                or scan.spectral_selection_start != 0
                or scan.spectral_selection_end != 64
                or scan.successive_approximation_high != 0
                or scan.successive_approximation_low != 0):
            return None
        if not hasattr(self.native, "decode_scan_dct_prefix_anchored"):
            return None

        from ..entropy.device_scan import (K_CAP, S_MAX, S_TARGET,
                                           _prescan_geometry,
                                           scan_decode_luts)
        geometry = _prescan_geometry(frame, scan, 0)
        # Cores available to THIS image's intra-image threads: siblings in
        # the staging pool already decode other images concurrently.
        nt = min((os.cpu_count() or 1) // self.pool_width, 8)
        n_mcus = geometry["est_blocks"] // len(geometry["pattern"])
        if nt < 2 or n_mcus < 8 * nt:
            return None

        luts = scan_decode_luts(scan, decoder._dc_huffman_tables,
                                decoder._ac_huffman_tables)
        if luts is None:
            return None

        cursor = decoder._cursor
        pos0 = cursor.pos
        res = self.native.prescan_baseline(cursor, luts, geometry,
                                           S_TARGET, K_CAP, S_MAX)
        if res is None:
            cursor.pos = pos0
            return None
        out_bytes, a_bits, a_block, a_slot, _n_blocks, pending, _, _ = res
        count = self.native.decode_scan_dct_prefix_anchored(
            cursor, frame, scan, decoder._dc_huffman_tables,
            decoder._ac_huffman_tables, dcs, acs, bases, self.k,
            self.resid_idx, self.resid_vals, self.resid_count,
            out_bytes, a_bits, a_block, a_slot)
        if count is None:
            cursor.pos = pos0
            return None
        self.resid_count = count
        return (pending,)

    def release(self) -> None:
        for dc, ac in self.prefix_arrays.values():
            _pool.release(dc)
            _pool.release(ac.reshape(-1))
        if self.resid_idx is not None:
            _pool.release(self.resid_idx)
            _pool.release(self.resid_vals)


def _staged_from_capture(d: Decoder, capture: PrefixCapture, precision: str,
                         pooled: list) -> StagedImage:
    from ..errors import FormatError

    frame = d.frame
    n = len(frame.components)
    if any(i not in d._pending_render for i in range(n)):
        capture.release()
        for buf in pooled:
            _pool.release(buf)
        raise FormatError("not all components have data")

    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    qts = tuple(d._pending_render[i][1] for i in range(n))

    total_blocks = capture.total // 64
    dc = np.empty(total_blocks, np.int16)
    ac = np.empty((total_blocks, capture.k - 1), np.int8)
    row = 0
    for i in range(n):
        nblocks = capture.sizes[i] // 64
        pair = capture.prefix_arrays.get(i)
        if pair is None:
            dc[row:row + nblocks] = 0
            ac[row:row + nblocks] = 0
        else:
            dc[row:row + nblocks] = pair[0]
            ac[row:row + nblocks] = pair[1]
        row += nblocks

    r = capture.resid_count
    bucket = _bucket(r)
    resid_idx = np.full(bucket, capture.total, np.int32)
    resid_vals = np.zeros(bucket, np.int16)
    resid_idx[:r] = capture.resid_idx[:r]
    resid_vals[:r] = capture.resid_vals[:r]

    capture.release()
    for buf in pooled:
        _pool.release(buf)

    info = d.info()
    return StagedImage(geometry, dc, ac, resid_idx, resid_vals, qts,
                       capture.total, info.width * info.height / 1e6)


def stage_host(source, scale_to=None, precision: str = "fast",
               timer=None, pool_width: int = 1) -> StagedImage:
    """Host stages for one image: parse + entropy + prefix/residual pack.

    `timer` (a `utils.timing.StageTimer`) records this as the "host_stage"
    stage — the per-stage observability layer the reference lacks
    (SURVEY.md §5). `pool_width` tells the anchored intra-image threads how
    many sibling staging workers share the cores (see _try_anchored)."""
    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host(source, scale_to, precision, None, pool_width)
    from ..entropy.native import get_native
    native = get_native()

    d = Decoder(source, backend="numpy")
    pooled: list = []
    capture = None
    if native is not None:
        def alloc(size: int) -> np.ndarray:
            buf = _pool.acquire(size, np.int16)
            native.zero_buffer(buf)
            pooled.append(buf)
            return buf
        d._store_allocator = alloc
        capture = PrefixCapture(native, pool_width=pool_width)
        d._prefix_capture = capture
    ll_cap = _LosslessCapture()
    d._lossless_capture = ll_cap

    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()

    if ll_cap.scans:
        for buf in pooled:
            _pool.release(buf)
        return _staged_lossless_from_capture(d, ll_cap)
    if capture is not None and capture.used:
        return _staged_from_capture(d, capture, precision, pooled)

    n_comp = len(d.frame.components) if d.frame is not None else 0
    if n_comp == 0 or any(i not in d._pending_render for i in range(n_comp)):
        for buf in pooled:
            _pool.release(buf)
        from ..errors import FormatError
        raise FormatError("not all components have data")
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1) for i in range(n)]
    qts = tuple(d._pending_render[i][1] for i in range(n))
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(d.frame, transform, precision=precision)

    nblocks = [s.size // 64 for s in stores]
    total_blocks = sum(nblocks)
    total = total_blocks * 64

    dc = np.empty(total_blocks, np.int16)
    ac = np.empty((total_blocks, PREFIX_K - 1), np.int8)
    scratch_idx = _pool.acquire(total, np.int32)
    scratch_vals = _pool.acquire(total, np.int16)

    r = 0
    brow = 0
    base = 0
    if native is not None:
        for s, nb in zip(stores, nblocks):
            r += native.pack_prefix(s, nb, PREFIX_K, base,
                                    dc[brow:brow + nb], ac[brow:brow + nb],
                                    scratch_idx[r:], scratch_vals[r:])
            brow += nb
            base += s.size
    else:
        zz = np.asarray(UNZIGZAG)
        for s, nb in zip(stores, nblocks):
            blocks = s.reshape(nb, 64)
            zzb = blocks[:, zz].astype(np.int32)
            dc[brow:brow + nb] = zzb[:, 0].astype(np.int16)
            sat = np.clip(zzb[:, 1:PREFIX_K], -128, 127)
            ac[brow:brow + nb] = sat.astype(np.int8)
            # int8 saturation corrections ride the residual.
            ebi, ezi = np.nonzero(zzb[:, 1:PREFIX_K] != sat)
            cnt = len(ebi)
            scratch_idx[r:r + cnt] = base + ebi * 64 + zz[1 + ezi]
            scratch_vals[r:r + cnt] = (zzb[:, 1:PREFIX_K] - sat)[ebi, ezi]
            r += cnt
            tail = zzb[:, PREFIX_K:]
            bi, zi = np.nonzero(tail)
            cnt = len(bi)
            scratch_idx[r:r + cnt] = base + bi * 64 + zz[PREFIX_K + zi]
            scratch_vals[r:r + cnt] = tail[bi, zi]
            r += cnt
            brow += nb
            base += s.size

    bucket = _bucket(r)
    resid_idx = np.full(bucket, total, np.int32)  # out-of-range: dropped
    resid_vals = np.zeros(bucket, np.int16)
    resid_idx[:r] = scratch_idx[:r]
    resid_vals[:r] = scratch_vals[:r]
    _pool.release(scratch_idx)
    _pool.release(scratch_vals)
    for buf in pooled:
        _pool.release(buf)

    info = d.info()
    return StagedImage(geometry, dc, ac, resid_idx, resid_vals, qts, total,
                       info.width * info.height / 1e6)


@dataclasses.dataclass
class StagedBits:
    """One image staged in the compressed-bits interchange: the entropy-coded
    bytes themselves plus anchors; Huffman decode runs on device
    (entropy/device_scan.py). ~0.2-0.4 B/px of H2D traffic vs ~0.9 for the
    prefix interchange — the sustained-throughput lever."""
    geometry: ImageGeometry
    scans: tuple      # ((AnchoredScan, kept_comp_indices), ...)
    qts: tuple
    mpix: float


class BitstreamCapture:
    """Decoder hook staging baseline scans as anchored bitstreams. Raises
    PrescanFallback (caught by stage_host) when any scan needs host
    semantics — the whole image then restages through the prefix path."""

    def __init__(self):
        self.scans: list = []
        self.used = False

    def wants(self, frame) -> bool:
        return True

    def decode_scan(self, decoder, frame, scan, finished):
        from ..entropy.device_scan import prescan_baseline

        marker, staged = prescan_baseline(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval)
        self.used = True
        kept = []
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                kept.append((pos, comp_i))
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
        self.scans.append((staged, tuple(kept)))
        return marker


def stage_host_bits(source, scale_to=None, precision: str = "fast",
                    timer=None, pool_width: int = 1):
    """Stage one image in the compressed-bits interchange; falls back to the
    prefix interchange (stage_host) when the stream needs host entropy
    semantics (progressive, lossless, malformed, quirk paths). `pool_width`
    reaches the fallback's anchored-thread gate (see stage_host)."""
    from ..entropy.device_scan import PrescanFallback
    from ..errors import FormatError

    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host_bits(source, scale_to, precision, None,
                                   pool_width)

    d = Decoder(source, backend="numpy")
    capture = BitstreamCapture()
    d._prefix_capture = capture
    ll_cap = _LosslessCapture()
    d._lossless_capture = ll_cap
    try:
        if scale_to is not None:
            d.scale(*scale_to)
        d._decode_entropy_only()
    except PrescanFallback:
        # Quirk baseline stream: re-decode on the host (oracle semantics),
        # then re-encode the stores into the bits format (transcode). Only
        # when that fails too does the image ship as prefix coefficients.
        return _stage_host_decoded_bits(source, scale_to, precision)
    if ll_cap.scans:
        # Lossless frame: ship the difference planes, reconstruct on device.
        return _staged_lossless_from_capture(d, ll_cap)
    if not capture.used:
        if d.frame is not None and d.frame.coding_process \
                == CodingProcess.DCT_PROGRESSIVE:
            # Progressive image: the host oracle already decoded it into
            # dense stores — transcode them into the bits format.
            from ..entropy.transcode import transcode_decoded
            st = transcode_decoded(d, precision)
            if st is not None:
                return st
        return stage_host(source, scale_to, precision,
                          pool_width=pool_width)

    frame = d.frame
    n = len(frame.components)
    if any(i not in d._pending_render for i in range(n)):
        raise FormatError("not all components have data")
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    qts = tuple(d._pending_render[i][1] for i in range(n))
    info = d.info()

    return StagedBits(geometry, tuple(capture.scans), qts,
                      info.width * info.height / 1e6)


@dataclasses.dataclass
class StagedLossless:
    """Lossless (SOF3) image staged for device reconstruction: the host runs
    only the Huffman difference decode (C++ jt_decode_scan_lossless); the
    predictor recurrences run on device (ops/predictors.py closed forms, or
    the anti-diagonal wavefront for predictors 5-7 / point transforms),
    bit-identical to /root/reference/src/decoder/lossless.rs:108-226.

    The wire is the difference plane reduced mod 2^16 (uint16, 2 B/sample):
    every predictor computes (prediction + diff) & 0xFFFF, so only the
    diff's low 16 bits can reach the output."""
    diffs: np.ndarray       # uint16 [ncomp, H, W]
    predictor: int
    point_transform: int
    precision: int
    restart_all: bool       # the reference's stale phase-2 restart flag
    out_width: int
    out_height: int
    mpix: float

    @property
    def group_key(self) -> tuple:
        return ("lossless", self.diffs.shape, self.predictor,
                self.point_transform, self.precision, self.restart_all,
                self.out_width, self.out_height)


class _LosslessCapture:
    """Decoder hook (decoder.py _process_scan_lossless): captures the decoded
    difference planes instead of reconstructing them on the host."""

    def __init__(self):
        self.scans = []

    def wants(self, frame, scan) -> bool:
        return True

    def capture_scan(self, decoder, frame, scan, diffs, restart_all, marker):
        self.scans.append((frame, scan, diffs, restart_all))
        return marker


def _staged_lossless_from_capture(d: Decoder, cap: _LosslessCapture
                                  ) -> StagedLossless:
    from ..errors import FormatError
    from ..parser import Predictor

    if len(cap.scans) != 1:
        raise FormatError("multi-scan lossless stays host-side")
    frame, scan, diffs, restart_all = cap.scans[0]
    if len(scan.component_indices) != len(frame.components):
        raise FormatError("partial-component lossless scan stays host-side")
    predictor = scan.predictor_selection
    pt = scan.point_transform
    if predictor == Predictor.RA and pt != 0:
        # The reference's Ra fast path has its own dispatch-order semantics
        # and the pt != 0 windowed chain has no device form — host oracle
        # owns this rare configuration (see decoder._reconstruct_lossless_device).
        raise FormatError("Ra with point transform stays host-side")
    out_w = frame.output_size.width
    out_h = frame.output_size.height
    ncomp = diffs.shape[0]
    if ncomp == 1 and diffs.shape[1:] != (out_h, out_w):
        raise FormatError("scaled single-component lossless stays host-side")
    info = d.info()
    return StagedLossless(
        diffs=(diffs & 0xFFFF).astype(np.uint16),
        predictor=int(predictor), point_transform=pt,
        precision=frame.precision, restart_all=bool(restart_all),
        out_width=out_w, out_height=out_h,
        mpix=info.width * info.height / 1e6)


def stage_host_lossless(source, scale_to=None, precision: str = "fast",
                        timer=None) -> StagedLossless:
    """Host stages for one lossless image: parse + Huffman difference decode.
    Raises a typed FormatError for configurations the device path declines
    (multi-scan, partial-component, Ra with point transform)."""
    from ..errors import FormatError

    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host_lossless(source, scale_to, precision, None)
    d = Decoder(source, backend="numpy")
    cap = _LosslessCapture()
    d._lossless_capture = cap
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    if not cap.scans:
        raise FormatError("not a lossless stream")
    return _staged_lossless_from_capture(d, cap)


@functools.lru_cache(maxsize=32)
def _compiled_lossless_pipeline(ncomp: int, predictor_val: int, pt: int,
                                precision: int, restart_all: bool,
                                out_w: int, out_h: int,
                                batch, mesh=None, data_axis: str = "data"):
    """Device lossless reconstruction: per-component predictor recurrence +
    interleave/narrow assembly (decoder.py _compute_image_lossless semantics,
    /root/reference/src/decoder/lossless.rs:228-260), vmapped over the batch
    and optionally sharded over a mesh data axis."""
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)
    from ..ops.predictors import (device_supported,
                                  reconstruct_lossless_device,
                                  reconstruct_lossless_wavefront)
    from ..parser import Predictor
    predictor = Predictor(predictor_val)

    def recon(plane):
        if (predictor == Predictor.RA or restart_all
                or device_supported(predictor, pt)):
            return reconstruct_lossless_device(plane, predictor, pt,
                                               precision, restart_all, jnp)
        return reconstruct_lossless_wavefront(plane, predictor, pt,
                                              precision, jnp)

    def run_one(diffs):
        planes = [recon(diffs[i]) for i in range(ncomp)]
        if ncomp == 1:
            img = planes[0]
        else:
            # Element-count-bound interleave (row-major prefix when scaling
            # shrank output_size), mirroring lossless.rs:240-246.
            count = out_w * out_h
            flats = [p.reshape(-1)[:count] for p in planes]
            img = jnp.stack(flats, axis=-1).reshape(out_h, out_w, ncomp)
        if precision == 8:
            return img.astype(jnp.uint8)
        return img

    if batch is None:
        return jax.jit(run_one)
    batched = jax.vmap(run_one)
    if mesh is None:
        return jax.jit(batched)
    from jax.sharding import NamedSharding, PartitionSpec as PS
    sharded = NamedSharding(mesh, PS(data_axis))
    return jax.jit(batched, in_shardings=(sharded,), out_shardings=sharded)


def _stage_host_decoded_bits(source, scale_to, precision: str):
    """Full host decode into dense stores, then transcode into the bits
    interchange; prefix fallback when the transcoder declines."""
    from ..entropy.transcode import transcode_decoded

    d = Decoder(source, backend="numpy")
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    st = transcode_decoded(d, precision)
    if st is not None:
        return st
    return stage_host(source, scale_to, precision)


def _place(scan_stores, kept, stores: list) -> None:
    for pos, comp_i in kept:
        stores[comp_i] = scan_stores[pos]


def _nat_recon(plan, kept: tuple, ncomp: int, geometry: ImageGeometry,
               layout: str):
    """Traced assembly + reconstruction of one image from its rows of an
    entropy sweep's stream-order tensor: (nat [n_blocks, 64], qts) -> pixels."""
    from ..entropy.device_scan import build_assembler_nat

    assemble = build_assembler_nat(plan, flat_stores=False)

    def recon_one(nat, qts):
        stores = [None] * ncomp
        _place(assemble(nat), kept, stores)
        return _recon(geometry, layout, stores, qts)

    return recon_one


@functools.lru_cache(maxsize=128)
def _compiled_bits_pipeline(plans_with_comps: tuple, ncomp: int,
                            geometry: ImageGeometry, layout: str):
    """Fused device dispatch for one image: the entropy sweep of every scan
    (engine per jpeg_decoder_jax.platform) + assembly +
    dequant/IDCT/upsample/color — one jit, pixels stay in device memory."""
    import jax

    from ..entropy.device_scan import build_anchored_decoder
    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)

    decoders = [build_anchored_decoder(plan, flat_stores=False)
                for plan, _kept in plans_with_comps]

    def run(scan_args, qts):
        stores = [None] * ncomp
        for decode, (_plan, kept), args in zip(decoders, plans_with_comps,
                                                scan_args):
            _place(decode(*args), kept, stores)
        return _recon(geometry, layout, stores, qts)

    return jax.jit(run)


@functools.lru_cache(maxsize=128)
def _compiled_bits_group(plan, kept: tuple, ncomp: int, batch: int,
                         s_max: int, geometry: ImageGeometry, layout: str):
    """One dispatch for `batch` same-plan images: ONE entropy sweep over
    their merged chunk arrays (device_scan.merge_scans) writes a
    [batch * n_blocks, 64] tensor, then assembly and reconstruction are
    vmapped over the images. Sub-megapixel images are dominated by the
    fixed cost of each dispatch; this pays it once per group."""
    import jax

    from ..entropy.device_scan import build_sweep
    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)

    nb = plan.n_blocks
    sweep = build_sweep(batch * nb, s_max, tuple(plan.pattern))
    recon_one = _nat_recon(plan, kept, ncomp, geometry, layout)

    def run(words, a_bits, a_block, a_slot, luts, qts_b):
        nat = sweep(words, a_bits, a_block, a_slot, luts)
        return jax.vmap(recon_one)(nat.reshape(batch, nb, 64), qts_b)

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _compiled_bits_sweep(n_blocks: int, s_max: int, pattern: tuple):
    """One jitted entropy sweep over a (possibly mixed-plan) merge: returns
    the stream-order [n_blocks, 64] int16 coefficient tensor. Keyed only by
    bucketed sizes, so a mixed stream's composition never recompiles it."""
    import jax

    from ..entropy.device_scan import build_sweep
    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)
    return jax.jit(build_sweep(n_blocks, s_max, pattern))


@functools.lru_cache(maxsize=64)
def _compiled_nat_reconstruct(plan, kept: tuple, ncomp: int,
                              count_bucket: int, geometry: ImageGeometry,
                              layout: str):
    """Assembly + reconstruction of `count_bucket` same-plan images from a
    dynamic slice of the mixed-plan sweep's coefficient tensor. The slice
    offset is a runtime scalar, so compile keys depend only on
    (plan, bucketed count) — not on where the images sit in the merge."""
    import jax

    from ..ops.pipeline import _enable_compile_cache
    _enable_compile_cache(jax)

    recon_one = _nat_recon(plan, kept, ncomp, geometry, layout)
    nb = plan.n_blocks

    def run(nat, off, qts_b):
        seg = jax.lax.dynamic_slice(nat, (off, 0), (count_bucket * nb, 64))
        return jax.vmap(recon_one)(seg.reshape(count_bucket, nb, 64), qts_b)

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _compiled_bits_mesh(plan, kept: tuple, batch: int, ncomp: int,
                        geometry: ImageGeometry, layout: str, mesh,
                        data_axis: str):
    """Mesh-sharded batched bits dispatch: per-image anchor arrays (equal
    buckets, so they stack) are sharded over `data_axis`; inside shard_map
    each device merges its local images on device (words back to back,
    anchors offset) and runs ONE entropy sweep over them, then vmapped
    assembly and reconstruction. LUTs are replicated."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from ..entropy.device_scan import build_sweep
    from ..ops.pipeline import _enable_compile_cache
    from ..parallel.stripes import _shard_map, _shard_map_uncheck_kwargs
    _enable_compile_cache(jax)
    shard_map = _shard_map()

    nb = plan.n_blocks
    local_b = batch // int(mesh.shape[data_axis])
    sweep = build_sweep(local_b * nb, plan.s_max, tuple(plan.pattern))
    recon_one = _nat_recon(plan, kept, ncomp, geometry, layout)

    def shard_fn(words, a_bits, a_block, a_slot, luts, qts_l):
        n_w = words.shape[1]
        img = jnp.arange(local_b, dtype=jnp.int32)[:, None]
        bits = a_bits + (img * (n_w * 32)).astype(jnp.uint32)
        blocks = jnp.concatenate(
            [(a_block[:, :-1] + img * nb).reshape(-1),
             jnp.full((1,), local_b * nb, jnp.int32)])
        nat = sweep(words.reshape(-1), bits.reshape(-1), blocks,
                    a_slot.reshape(-1), luts)
        return jax.vmap(recon_one)(nat.reshape(local_b, nb, 64), qts_l)

    data = PartitionSpec(data_axis)
    repl = PartitionSpec()
    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(data, data, data, data, repl, (data,) * ncomp),
                   out_specs=data, **_shard_map_uncheck_kwargs(shard_map))
    return jax.jit(fn)


def _bits_hetero_key(st: "StagedBits"):
    """Images sharing this key can merge into ONE entropy sweep even with
    different plans and geometries (mixed sizes from the same encoder): the
    sweep depends only on the MCU slot pattern and the decode LUTs; per-plan
    assembly and reconstruction run from slices of its output
    (_decode_group_bits_hetero). None = dispatch singly."""
    if len(st.scans) != 1:
        return None
    scan, kept = st.scans[0]
    if len(kept) != len(st.qts):
        return None
    return (tuple(scan.plan.pattern), kept, len(st.qts), scan.luts_key)


def _bits_group_key(st: "StagedBits", mesh_mode: bool = False):
    """Images sharing this key can merge into one batched bits dispatch:
    single scan covering every component, same geometry and plan shape,
    same decode LUTs (one table set binds the whole sweep), same
    kept-component mapping. None = dispatch singly.

    mesh_mode (DeviceStreamDecoder(mesh=...)): the batch stacks the
    bucket-padded per-image anchor arrays and shards them over the data
    axis, so the FULL plan (bucket sizes included) must match; the
    single-device merge concatenates, so bucket sizes may differ."""
    if len(st.scans) != 1:
        return None
    scan, kept = st.scans[0]
    if len(kept) != len(st.qts):
        return None
    plan_key = scan.plan if mesh_mode else scan.plan._key[:-3]
    return (st.geometry, plan_key, kept, len(st.qts), scan.luts_key)


def _hetero_threshold() -> float:
    """Largest image (Mpix) that merges across plans. Merging mixed plans
    adds a materialised coefficient tensor and one reconstruct dispatch per
    plan, which pays only where the fixed cost of a dispatch dominates.
    JPEG_JAX_HETERO_BITS: unset/''/'1' = 0.25, '0' = exact-key groups only,
    another float = the threshold."""
    v = os.environ.get("JPEG_JAX_HETERO_BITS", "1")
    if v in ("", "1"):
        return 0.25
    return 0.0 if v == "0" else float(v)


def _merged_inputs(scans):
    """Host merge of several scans into one sweep's inputs
    (device_scan.merge_scans), padded to bucketed sizes so that group
    composition rarely recompiles. Padding chunks own no blocks."""
    from ..entropy.device_scan import _bucket_up, merge_scans

    words, bits, block, slot, _bases = merge_scans(scans)
    n_w = _bucket_up(len(words), 1024)
    pad_i = _bucket_up(len(bits)) - len(bits)
    return (np.pad(words, (0, n_w - len(words))),
            np.pad(bits, (0, pad_i)),
            np.pad(block, (0, pad_i), mode="edge"),
            np.pad(slot, (0, pad_i)))


class DeviceStreamDecoder:
    """Streaming decode-to-device: returns device arrays, never reads back."""

    def __init__(self, host_threads: int = 4, precision: str = "fast",
                 layout: str = "interleaved", timer=None,
                 interchange: str = "prefix", mesh=None,
                 data_axis: str = "data"):
        """layout: "interleaved" ([H, W, C]) or "planar" ([C, H, W], device
        transpose).

        `interchange`: "prefix" ships decoded coefficients (~0.9 B/px);
        "bits" ships the entropy-coded bytes themselves (~0.2 B/px) and runs
        Huffman decode on the device. Images the device engine can't take
        (lossless, quirk streams) restage through "prefix"; progressive
        images are transcoded into the bits format on the host.

        `mesh`: optional `jax.sharding.Mesh`; batched dispatches shard the
        image-batch axis over `data_axis` (decoded batches live sharded in
        the mesh's device memory). Use batch_size >= mesh data-axis size.

        `timer`: optional `utils.timing.StageTimer`; records "host_stage"
        (parse + entropy/prescan + pack, per image), "h2d_submit"
        (device_put submission) and "device_dispatch" (async jit dispatch).
        Device execution itself is asynchronous — end-to-end wall time is
        the caller's to measure after block_until_ready.

        `counts` tallies what reached the device: "dispatches" (compiled
        programs called) and "sweeps" (entropy sweeps, one per merged group
        of bits images, or per scan of a solo image).

        Raises RuntimeError when the native entropy library is unavailable:
        the Python oracle is ~100x slower and is reached only on purpose
        (JPEG_JAX_DISABLE_NATIVE=1)."""
        if interchange not in ("prefix", "bits"):
            raise ValueError(f"unknown interchange {interchange!r}")
        if layout not in ("interleaved", "planar"):
            raise ValueError(f"unknown layout {layout!r}")
        from ..entropy.native import get_native
        if get_native() is None and not os.environ.get(
                "JPEG_JAX_DISABLE_NATIVE"):
            raise RuntimeError(
                "native entropy library unavailable (g++ build failed?); "
                "set JPEG_JAX_DISABLE_NATIVE=1 to run on the Python oracle")
        self.pool = cf.ThreadPoolExecutor(max_workers=host_threads)
        self.host_threads = host_threads
        self.precision = precision
        self.layout = layout
        self.timer = timer
        self.interchange = interchange
        self.mesh = mesh
        self.data_axis = data_axis
        self.counts = collections.Counter()

    @contextlib.contextmanager
    def _stage(self, name: str):
        if self.timer is None:
            yield
        else:
            with self.timer.stage(name):
                yield

    def _dispatch(self, fn, *args, sweeps: int = 0):
        self.counts["dispatches"] += 1
        self.counts["sweeps"] += sweeps
        with self._stage("device_dispatch"):
            return fn(*args)

    def decode_striped(self, source, scale_to=None,
                       stripe_axis: str = "stripe", engine: str = None):
        """Decode ONE image with its MCU rows — entropy decode included —
        sharded over the mesh's `stripe_axis` (parallel/stripe_bits.py):
        each device Huffman-decodes its stripe's anchored chunks, assembles
        with the DC seam carry, and reconstructs behind a 1-row halo
        exchange. The path for images too large for one device.
        Returns the device pixel array (rows sharded over the stripe axis);
        falls back to the single-device pipeline when the mesh has no such
        axis or the image isn't stripe-eligible. Reconstruction runs the
        exact integer kernels (same contract as parallel/stripes.py).
        `engine` overrides the platform's entropy engine ("triton"/"xla")."""
        staged = stage_host_bits(source, scale_to, self.precision,
                                 timer=self.timer)
        if (self.mesh is not None and stripe_axis in self.mesh.shape
                and isinstance(staged, StagedBits)):
            from ..parallel.stripe_bits import decode_bits_striped
            with self._stage("device_dispatch"):
                out = decode_bits_striped(staged, self.mesh, stripe_axis,
                                          engine=engine)
            if out is not None:
                self.counts["dispatches"] += 1
                self.counts["sweeps"] += 1
                return out
        return self.decode_one(staged)

    def decode_one(self, staged):
        if isinstance(staged, StagedBits):
            return self._decode_one_bits(staged)
        if isinstance(staged, StagedLossless):
            return self._decode_one_lossless(staged)
        import jax
        fn = _compiled_prefix_pipeline(staged.geometry, len(staged.resid_idx),
                                       self.layout)
        with self._stage("h2d_submit"):
            args = (jax.device_put(staged.dc),
                    jax.device_put(staged.ac),
                    jax.device_put(staged.resid_idx),
                    jax.device_put(staged.resid_vals))
        return self._dispatch(fn, *args, staged.qts)

    def _decode_one_lossless(self, st: "StagedLossless"):
        import jax
        fn = _compiled_lossless_pipeline(
            st.diffs.shape[0], st.predictor, st.point_transform,
            st.precision, st.restart_all, st.out_width, st.out_height,
            batch=None)
        with self._stage("h2d_submit"):
            d = jax.device_put(st.diffs)
        return self._dispatch(fn, d)

    def _decode_group_lossless(self, group: list) -> list:
        """One vmapped (optionally mesh-sharded) dispatch for a group of
        same-key lossless images."""
        import jax

        n = len(group)
        if n == 1 and self.mesh is None:
            return [self.decode_one(group[0])]
        batch = self._batch_for(n)
        st0 = group[0]
        diffs = np.stack([st.diffs for st in group]
                         + [group[-1].diffs] * (batch - n))
        fn = _compiled_lossless_pipeline(
            st0.diffs.shape[0], st0.predictor, st0.point_transform,
            st0.precision, st0.restart_all, st0.out_width, st0.out_height,
            batch=batch, mesh=self.mesh, data_axis=self.data_axis)
        with self._stage("h2d_submit"):
            d = jax.device_put(diffs) if self.mesh is None else diffs
        out = self._dispatch(fn, d)
        return [out[i] for i in range(n)]

    def _batch_for(self, n: int) -> int:
        """Power-of-two batch bucket, rounded UP to a multiple of the mesh's
        data-axis size (doubling never reaches divisibility by 3 or 6)."""
        batch = _batch_bucket(n)
        if self.mesh is not None:
            ndev = int(self.mesh.shape[self.data_axis])
            batch = -(-batch // ndev) * ndev
        return batch

    # Device-resident LUT cache: Huffman tables repeat across images from the
    # same encoder; keyed by table content so the 1 MB-class LUTs ship once.
    _lut_cache: dict = {}

    def _put_luts(self, scan):
        import jax
        key = scan.luts_key
        dev = self._lut_cache.get(key)
        if dev is None:
            dev = jax.device_put(scan.luts)
            if len(self._lut_cache) > 64:
                self._lut_cache.clear()
            self._lut_cache[key] = dev
        return dev

    def _bits_fn_args(self, staged: StagedBits):
        """Compiled full-pipeline fn + device-resident arguments for one
        bits-staged image. Shared by the dispatch path and the
        device-resident benchmark (device_resident_rate)."""
        import jax

        plans_with_comps = tuple(
            (scan.plan, kept) for scan, kept in staged.scans)
        fn = _compiled_bits_pipeline(plans_with_comps, len(staged.qts),
                                     staged.geometry, self.layout)
        with self._stage("h2d_submit"):
            scan_args = tuple(
                (jax.device_put(scan.words),
                 jax.device_put(scan.anchor_bits),
                 jax.device_put(scan.anchor_block),
                 jax.device_put(scan.anchor_slot),
                 self._put_luts(scan))
                for scan, _kept in staged.scans)
        return fn, scan_args

    def _decode_one_bits(self, staged: StagedBits):
        fn, scan_args = self._bits_fn_args(staged)
        return self._dispatch(fn, scan_args, staged.qts,
                              sweeps=len(staged.scans))

    def _group_fn_args(self, group: list, batch: int):
        """Compiled merged-sweep program + host arguments for same-plan bits
        images (padded to `batch` by repeating the last image)."""
        scans = [st.scans[0][0] for st in group]
        scans = scans + [scans[-1]] * (batch - len(group))
        scan0, kept = group[0].scans[0]
        s_max = max(s.plan.s_max for s in scans)
        fn = _compiled_bits_group(scan0.plan, kept, len(group[0].qts), batch,
                                  s_max, group[0].geometry, self.layout)
        ncomp = len(group[0].qts)
        qts_b = tuple(
            np.stack([st.qts[c] for st in group]
                     + [group[-1].qts[c]] * (batch - len(group)))
            for c in range(ncomp))
        return fn, _merged_inputs(scans), qts_b

    def device_resident_rate(self, source, iters: int = 64, scale_to=None,
                             reps: int = 3, batch: int = 1):
        """Device rate of the FULL device pipeline (entropy sweep + assembly
        + dequant/IDCT/upsample/color) with no host work in the window:
        `iters` decodes run inside ONE jitted lax.fori_loop over
        device-resident inputs. Two device copies of the input alternate by
        iteration parity so XLA cannot hoist the loop-invariant decode out
        of the loop.

        Accepts any source the stream accepts: baseline rides the bits wire,
        progressive rides the transcode wire, lossless rides the diff wire.
        batch>1 merges `batch` copies of a bits image into one entropy sweep
        + vmapped assembly and reconstruction per iteration (the serving
        shape). Returns {"ms_per_image", "mpix_s", "interchange", "batch"}
        (per image)."""
        import time as _time

        import jax
        import jax.numpy as jnp

        staged = stage_host_bits(source, scale_to, self.precision,
                                 pool_width=self.host_threads)
        if batch > 1 and isinstance(staged, StagedBits) \
                and _bits_group_key(staged) is not None:
            fn, inputs, qts_b = self._group_fn_args([staged] * batch, batch)
            luts = self._put_luts(staged.scans[0][0])
            args_a = tuple(jax.device_put(a) for a in inputs)
            args_b = tuple(jax.device_put(a) for a in inputs)
            call = lambda args: fn(*args, luts, qts_b)  # noqa: E731
            kind = f"bits-batch{batch}"
            eff_batch = batch
        elif isinstance(staged, StagedBits):
            fn, args_a = self._bits_fn_args(staged)
            _, args_b = self._bits_fn_args(staged)
            qts = staged.qts
            call = lambda args: fn(args, qts)  # noqa: E731
            kind = "bits"
            eff_batch = 1       # batch>1 request was ineligible: honest solo
        elif isinstance(staged, StagedLossless):
            fn = _compiled_lossless_pipeline(
                staged.diffs.shape[0], staged.predictor,
                staged.point_transform, staged.precision,
                staged.restart_all, staged.out_width, staged.out_height,
                batch=None)
            args_a = jax.device_put(staged.diffs)
            args_b = jax.device_put(staged.diffs)
            call = fn
            kind = "lossless"
            eff_batch = 1
        else:  # StagedImage — prefix coefficients
            fn = _compiled_prefix_pipeline(
                staged.geometry, len(staged.resid_idx), self.layout)
            mk = lambda: tuple(jax.device_put(x) for x in (  # noqa: E731
                staged.dc, staged.ac, staged.resid_idx, staged.resid_vals))
            args_a, args_b = mk(), mk()
            qts = staged.qts
            call = lambda args: fn(*args, qts)  # noqa: E731
            kind = "prefix"
            eff_batch = 1

        @jax.jit
        def chained(aa, ab):
            def body(i, acc):
                args = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(i % 2 == 0, a, b), aa, ab)
                out = call(args)
                return acc + out.astype(jnp.int32).sum()
            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        int(jax.device_get(chained(args_a, args_b)))  # warm (compile)
        best = float("inf")
        for _ in range(reps):
            t0 = _time.perf_counter()
            int(jax.device_get(chained(args_a, args_b)))
            best = min(best, (_time.perf_counter() - t0) / iters)
        per_image = best / eff_batch
        return {"ms_per_image": per_image * 1e3,
                "mpix_s": staged.mpix / per_image,
                "interchange": kind, "batch": eff_batch}

    def decode_stream(self, sources: Iterable, scale_to=None,
                      batch_size: int = 1, on_error: str = "raise") -> list:
        """Decode all sources; returns a list of device uint8 arrays.

        batch_size > 1 groups consecutive compatible images into one device
        dispatch — essential for sub-megapixel images, where the fixed cost
        of a dispatch otherwise dominates. Bits images of one group share
        one entropy sweep.

        on_error: "raise" propagates the first failure; "none" isolates
        per-item failures (malformed inputs in a production stream must not
        poison the batch) and yields None in that slot.
        """
        from ..errors import JpegError

        stage = stage_host_bits if self.interchange == "bits" else stage_host
        # pool_width gates the intra-image anchored threads so that the
        # staging workers and their threads do not oversubscribe the cores.
        staged_futures = [self.pool.submit(stage, s, scale_to,
                                           self.precision, self.timer,
                                           self.host_threads)
                          for s in sources]

        def resolve(fut):
            if on_error == "raise":
                return fut.result()
            try:
                return fut.result()
            except JpegError:
                return None

        if batch_size <= 1:
            return [self.decode_one(st) if st is not None else None
                    for st in map(resolve, staged_futures)]

        outputs: list = []
        group: list = []
        bits_group: list = []
        ll_group: list = []
        bits_key = [None]
        hetero_mpix = _hetero_threshold()

        def flush():
            if not group:
                return
            outputs.extend(self._decode_group(group))
            group.clear()

        def flush_bits():
            if not bits_group:
                return
            outputs.extend(self._decode_group_bits(bits_group))
            bits_group.clear()

        def flush_ll():
            if not ll_group:
                return
            outputs.extend(self._decode_group_lossless(ll_group))
            ll_group.clear()

        for fut in staged_futures:
            st = resolve(fut)
            if st is None:
                flush()
                flush_bits()
                flush_ll()
                outputs.append(None)
                continue
            if isinstance(st, StagedLossless):
                flush()
                flush_bits()
                if ll_group and (st.group_key != ll_group[0].group_key
                                 or len(ll_group) >= batch_size):
                    flush_ll()
                ll_group.append(st)
                continue
            flush_ll()
            if isinstance(st, StagedBits):
                flush()
                # Small images merge across plans (mixed sizes) on the
                # hetero key; larger ones and mesh groups need one plan.
                if self.mesh is not None:
                    key = _bits_group_key(st, True)
                elif st.mpix <= hetero_mpix:
                    key = _bits_hetero_key(st)
                else:
                    key = _bits_group_key(st)
                if key is None:
                    # Multi-scan or partial-component: per-image dispatch.
                    flush_bits()
                    outputs.append(self.decode_one(st))
                    continue
                if bits_group and (key != bits_key[0]
                                   or len(bits_group) >= batch_size):
                    flush_bits()
                bits_key[0] = key
                bits_group.append(st)
                continue
            flush_bits()
            if group and (st.geometry != group[0].geometry
                          or len(group) >= batch_size):
                flush()
            group.append(st)
        flush()
        flush_bits()
        flush_ll()
        return outputs

    def _decode_group_bits(self, group: list) -> list:
        """One merged device dispatch for a group of same-key StagedBits
        (see _bits_group_key): merge_scans concatenates the per-image chunk
        arrays with block-base offsets, one entropy sweep decodes them all,
        assembly and reconstruction are vmapped."""
        import jax

        if self.mesh is not None:
            return self._decode_group_bits_mesh(group)
        if len(group) == 1:
            return [self.decode_one(group[0])]
        if len({_bits_group_key(st) for st in group}) > 1:
            # Same hetero key, different plans: one sweep, per-plan assembly.
            return self._decode_group_bits_hetero(group)
        n = len(group)
        fn, inputs, qts_b = self._group_fn_args(group, _batch_bucket(n))
        with self._stage("h2d_submit"):
            dev = tuple(jax.device_put(a) for a in inputs)
            luts = self._put_luts(group[0].scans[0][0])
        out = self._dispatch(fn, *dev, luts, qts_b, sweeps=1)
        return [out[i] for i in range(n)]

    def _decode_group_bits_hetero(self, group: list) -> list:
        """Mixed-plan batched bits dispatch: ONE entropy sweep decodes every
        image's chunks (chunk anchors carry absolute block bases), then
        per-plan assemblers/reconstructors consume dynamic slices of the
        sweep's stream-order coefficient tensor. Dispatches: 1 sweep +
        #distinct-plans reconstructs, vs #images full pipelines.

        Compile-key discipline: the sweep is keyed by a bucketed total block
        count; each reconstruct by (plan, bucketed count) — a mixed stream's
        composition order never recompiles. Reconstruct slices may overrun
        into the next plan's rows (count padding); those padding images
        decode garbage and are discarded."""
        import jax

        scan0, _ = group[0].scans[0]
        # Group members by plan (first-seen order), remembering stream order.
        plan_groups: dict = {}
        for idx, st in enumerate(group):
            scan, _kept = st.scans[0]
            plan_groups.setdefault(
                (scan.plan, st.geometry), []).append((idx, st))
        ordered = [st.scans[0][0] for members in plan_groups.values()
                   for _i, st in members]

        # Sweep sized to cover every (count-bucketed) reconstruct slice.
        padded_total = sum(
            _batch_bucket(len(members)) * plan.n_blocks
            for (plan, _g), members in plan_groups.items())
        nb_bucket = _bucket(padded_total, floor=4096)
        s_max = max(s.plan.s_max for s in ordered)
        sweep = _compiled_bits_sweep(nb_bucket, s_max,
                                     tuple(scan0.plan.pattern))
        inputs = _merged_inputs(ordered)
        with self._stage("h2d_submit"):
            dev = tuple(jax.device_put(a) for a in inputs)
            luts = self._put_luts(scan0)
        results: list = [None] * len(group)
        nat = self._dispatch(sweep, *dev, luts, sweeps=1)
        off = 0
        for (plan, geometry), members in plan_groups.items():
            cnt = len(members)
            cb = _batch_bucket(cnt)
            st0 = members[0][1]
            kept = st0.scans[0][1]
            fn = _compiled_nat_reconstruct(plan, kept, len(st0.qts), cb,
                                           geometry, self.layout)
            qts_b = tuple(
                np.stack([st.qts[c] for _i, st in members]
                         + [members[-1][1].qts[c]] * (cb - cnt))
                for c in range(len(st0.qts)))
            out = self._dispatch(fn, nat, off, qts_b)
            for j, (idx, _st) in enumerate(members):
                results[idx] = out[j]
            off += plan.n_blocks * cnt
        return results

    def _decode_group_bits_mesh(self, group: list) -> list:
        """Mesh-sharded batched bits dispatch: stack the bucket-padded
        per-image anchor arrays along an image axis sharded over the data
        axis; each device sweeps its local images at once
        (_compiled_bits_mesh)."""
        scan0, kept = group[0].scans[0]
        n = len(group)
        batch = self._batch_for(n)
        pad = batch - n
        scans = [st.scans[0][0] for st in group] + [scan0] * pad
        stacked = tuple(np.stack([getattr(s, f) for s in scans])
                        for f in ("words", "anchor_bits", "anchor_block",
                                  "anchor_slot"))
        ncomp = len(group[0].qts)
        qts_b = tuple(
            np.stack([st.qts[c] for st in group]
                     + [group[0].qts[c]] * pad)
            for c in range(ncomp))
        fn = _compiled_bits_mesh(scan0.plan, kept, batch, ncomp,
                                 group[0].geometry, self.layout, self.mesh,
                                 self.data_axis)
        with self._stage("h2d_submit"):
            luts = self._put_luts(scan0)
        out = self._dispatch(fn, *stacked, luts, qts_b, sweeps=1)
        return [out[i] for i in range(n)]

    def _decode_group(self, group: list) -> list:
        import jax

        n = len(group)
        if n == 1 and self.mesh is None:
            return [self.decode_one(group[0])]
        resid_bucket = _bucket(max(len(st.resid_idx) for st in group))
        batch = self._batch_for(n)

        def pad_resid(st):
            idx = np.full(resid_bucket, st.total_coeffs, np.int32)
            vals = np.zeros(resid_bucket, np.int16)
            k = len(st.resid_idx)
            idx[:k] = st.resid_idx
            vals[:k] = st.resid_vals
            return idx, vals

        resids = [pad_resid(st) for st in group]
        pad_with = group[-1]
        dc = np.stack([st.dc for st in group]
                      + [pad_with.dc] * (batch - n))
        ac = np.stack([st.ac for st in group]
                      + [pad_with.ac] * (batch - n))
        ri = np.stack([r[0] for r in resids] + [resids[-1][0]] * (batch - n))
        rv = np.stack([r[1] for r in resids] + [resids[-1][1]] * (batch - n))

        # Per-image quantization tables (same geometry does not imply same
        # tables), stacked and vmapped alongside the coefficients.
        ncomp = len(group[0].qts)
        qts_b = tuple(
            np.stack([st.qts[c] for st in group]
                     + [pad_with.qts[c]] * (batch - n))
            for c in range(ncomp))

        fn = _compiled_prefix_pipeline_batched(
            group[0].geometry, resid_bucket, batch, self.mesh, self.data_axis,
            self.layout)
        with self._stage("h2d_submit"):
            args = (jax.device_put(dc), jax.device_put(ac),
                    jax.device_put(ri), jax.device_put(rv))
        out = self._dispatch(fn, *args, qts_b)
        return [out[i] for i in range(n)]
