"""Seeded JPEG writer: photo-like test and benchmark inputs made in numpy.

Nothing here needs Pillow or a file outside the repository. Images are
photo-like (smooth gradients, hard-edged shapes and seeded noise) so that
symbol statistics resemble photographs rather than white noise, and they are
encoded as:

- baseline sequential DCT (SOF0): forward DCT, Annex K quantisation tables
  scaled to a quality (IJG rule), Annex K Huffman tables, 4:2:0 / 4:2:2 /
  4:4:4 / grayscale sampling, an optional restart interval, byte stuffing;
- progressive DCT (SOF2) by spectral selection only: one interleaved DC scan,
  then one AC band scan per component and band, all with Ah = Al = 0;
- lossless (SOF3) with predictor 1 at 2..16 bits.

Bit packing is vectorised (one OR per 64-bit word), so a 3.5 Mpix image
encodes in about a second.

    from jpeg_decoder_jax.testing.synth import make_jpeg
    data = make_jpeg("420", 512, 512, seed=0)
"""

from __future__ import annotations

import numpy as np

from ..entropy.scan_python import UNZIGZAG
from ..huffman import (_MJPEG_AC_CHROMA_BITS, _MJPEG_AC_CHROMA_VALUES,
                       _MJPEG_AC_LUMA_BITS, _MJPEG_AC_LUMA_VALUES,
                       _MJPEG_DC_CHROMA_BITS, _MJPEG_DC_CHROMA_VALUES,
                       _MJPEG_DC_LUMA_BITS, _MJPEG_DC_LUMA_VALUES)

KINDS = ("420", "422", "444", "gray", "420-dri", "422-dri", "progressive",
         "progressive-gray", "lossless8", "lossless16")

SAMPLING = {"444": ((1, 1), (1, 1), (1, 1)),
            "422": ((2, 1), (1, 1), (1, 1)),
            "420": ((2, 2), (1, 1), (1, 1)),
            "gray": ((1, 1),)}

# Annex K.1 / K.2 quantisation tables, natural (row-major) order.
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_Q_CHROMA = np.full(64, 99, np.int64)
_Q_CHROMA.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                    [24, 26, 56, 99], [47, 66, 99, 99]]

# Lossless difference categories 0..16 (Annex H.1.2.2): lengths 2..9, no
# all-ones code; most frequent categories of smooth content get short codes.
_LL_BITS = [0, 1, 4, 2, 2, 2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0]
_LL_VALUES = bytes([3, 1, 2, 4, 5, 0, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16])

_ZZ = np.asarray(UNZIGZAG, np.int64)   # zigzag index -> natural index


# ---------------------------------------------------------------- content ---

def photo(width: int, height: int, channels: int = 3, seed: int = 0,
          bits: int = 8) -> np.ndarray:
    """Photo-like pixels [H, W, C] (uint8, or uint16 above 8 bits): smooth
    low-frequency gradients, a few dozen hard-edged rectangles and ellipses,
    and seeded sensor-like noise."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    img = np.empty((height, width, channels), np.float32)
    for c in range(channels):
        base = 128 + 60 * (rng.uniform(-1, 1) * x + rng.uniform(-1, 1) * y)
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            base = base + rng.uniform(10, 30) * np.cos(
                2 * np.pi * (fx * x + fy * y) + rng.uniform(0, 2 * np.pi))
        img[..., c] = base
    for _ in range(24):
        cx, cy = rng.uniform(0, 1, 2)
        rx, ry = rng.uniform(0.03, 0.25, 2)
        colour = rng.uniform(20, 235, channels).astype(np.float32)
        rect = rng.random() < 0.5
        alpha = np.float32(rng.uniform(0.5, 0.9))
        y0, y1 = (int(np.clip(v * (height - 1), 0, height))
                  for v in (cy - ry, cy + ry + 1 / height))
        x0, x1 = (int(np.clip(v * (width - 1), 0, width))
                  for v in (cx - rx, cx + rx + 1 / width))
        ys, xs = y[y0:y1], x[:, x0:x1]
        if rect:
            mask = (np.abs(xs - cx) < rx) & (np.abs(ys - cy) < ry)
        else:
            mask = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 < 1.0
        win = img[y0:y1, x0:x1]
        win[mask] = (1 - alpha) * win[mask] + alpha * colour
    img += 6.0 * rng.standard_normal(img.shape, dtype=np.float32)
    if bits <= 8:
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    top = (1 << bits) - 1
    return np.clip(np.rint(img * (top / 255.0)), 0, top).astype(np.uint16)


# ------------------------------------------------------------ bit packing ---

def canonical_codes(bits, values) -> "tuple[np.ndarray, np.ndarray]":
    """(code, length) per symbol value from a DHT (BITS, HUFFVAL) spec,
    Annex C figures C.1-C.3."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c = 0
    j = 0
    for L in range(1, 17):
        for _ in range(bits[L - 1]):
            code[values[j]] = c
            length[values[j]] = L
            c += 1
            j += 1
        c <<= 1
    return code, length


def pack_bits(fields: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first concatenation of `fields` (each < 2**lengths, lengths <= 32),
    1-filled to a byte boundary, without byte stuffing."""
    fields = np.asarray(fields, np.uint64)
    lengths = np.asarray(lengths, np.int64)
    keep = lengths > 0
    fields, lengths = fields[keep], lengths[keep]
    total = int(lengths.sum())
    pad = -total % 8
    if pad:
        fields = np.append(fields, np.uint64((1 << pad) - 1))
        lengths = np.append(lengths, pad)
        total += pad
    if total == 0:
        return b""
    start = np.cumsum(lengths) - lengths
    word = start >> 6
    end = (start & 63) + lengths                  # 1..95 within word `word`
    lo = np.where(end <= 64, fields << (64 - end).clip(0, 63).astype(np.uint64),
                  fields >> (end - 64).clip(0, 63).astype(np.uint64))
    spill = end > 64
    hi = np.where(spill, fields << (128 - end).clip(0, 63).astype(np.uint64),
                  np.uint64(0))
    out = np.zeros((total >> 6) + 2, np.uint64)
    np.bitwise_or.at(out, word, lo)
    np.bitwise_or.at(out, word[spill] + 1, hi[spill])
    return out.astype(">u8").tobytes()[:total // 8]


def stuff(data: bytes) -> bytes:
    """Insert the 0x00 stuffing byte after every 0xFF (Annex B.1.1.5)."""
    b = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(b == 0xFF)
    return np.insert(b, ff + 1, 0).tobytes() if len(ff) else data


class BitWriter:
    """Scalar MSB-first writer with 0xFF00 stuffing and 1-fill alignment, for
    hand-built streams in tests."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)
                self.acc = 0
                self.nbits = 0

    def align(self) -> None:
        if self.nbits:
            self.put((1 << (8 - self.nbits)) - 1, 8 - self.nbits)

    def raw(self, data: bytes) -> None:
        assert self.nbits == 0
        self.out.extend(data)


def encode_diff(w: BitWriter, diff: int, codes: dict) -> None:
    """SSSS category code + F.12 extend bits (Annex H.1 / F.1.2.1 coding);
    `codes` maps category -> (code, length)."""
    cat = abs(diff).bit_length()
    code, nbits = codes[cat]
    w.put(code, nbits)
    if cat:
        w.put(diff if diff >= 0 else diff + (1 << cat) - 1, cat)


def _category(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _magnitude_field(code, clen, v, cat):
    """Huffman code followed by the category's extend bits for value v."""
    mbits = np.where(v < 0, v - 1, v) & ((np.int64(1) << cat) - 1)
    return (code << cat) | mbits, clen + cat


# --------------------------------------------------------------- markers ---

def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _jfif() -> bytes:
    return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _dqt(tables) -> bytes:
    payload = b""
    for tid, q in enumerate(tables):
        payload += bytes([tid]) + bytes(int(v) for v in q[_ZZ])
    return _segment(0xDB, payload)


def _dht(specs) -> bytes:
    payload = b""
    for tc, th, bits, values in specs:
        payload += bytes([(tc << 4) | th]) + bytes(bits) + bytes(values)
    return _segment(0xC4, payload)


def _sof(marker: int, precision: int, width: int, height: int,
         comps) -> bytes:
    payload = bytes([precision]) + height.to_bytes(2, "big") \
        + width.to_bytes(2, "big") + bytes([len(comps)])
    for cid, (h, v), tq in comps:
        payload += bytes([cid, (h << 4) | v, tq])
    return _segment(marker, payload)


def _sos(comps, ss: int, se: int, ah: int = 0, al: int = 0) -> bytes:
    payload = bytes([len(comps)])
    for cid, td, ta in comps:
        payload += bytes([cid, (td << 4) | ta])
    return _segment(0xDA, payload + bytes([ss, se, (ah << 4) | al]))


# ------------------------------------------------------------------ DCT ---

def quant_tables(quality: int) -> "tuple[np.ndarray, np.ndarray]":
    """Annex K tables scaled by the IJG quality rule, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def _to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                     0.5 * r - 0.418688 * g - 0.081312 * b + 128], axis=-1)


class _Layout:
    """Frame geometry: per-component quantised coefficient grids
    [bh, bw, 64] (zigzag order) over the MCU-padded plane."""

    def __init__(self, pixels: np.ndarray, subsampling: str, quality: int):
        if pixels.ndim == 2:
            pixels = pixels[..., None]
        self.height, self.width, nc = pixels.shape
        self.sampling = SAMPLING["gray" if nc == 1 else subsampling]
        self.hmax = max(h for h, _ in self.sampling)
        self.vmax = max(v for _, v in self.sampling)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        planes = (pixels.astype(np.float32) if nc == 1
                  else _to_ycbcr(pixels))
        hp, wp = self.mcuy * 8 * self.vmax, self.mcux * 8 * self.hmax
        planes = np.pad(planes, ((0, hp - self.height),
                                 (0, wp - self.width), (0, 0)), mode="edge")
        self.qts = quant_tables(quality)
        d = _dct_matrix()
        self.coeffs = []
        for c, (h, v) in enumerate(self.sampling):
            fy, fx = self.vmax // v, self.hmax // h
            p = planes[..., c].reshape(hp // fy, fy, wp // fx, fx).mean(
                axis=(1, 3)) - 128.0
            bh, bw = p.shape[0] // 8, p.shape[1] // 8
            blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
            f = np.einsum("ij,abjk,lk->abil", d, blocks, d).reshape(bh, bw, 64)
            q = self.qts[min(c, 1)]
            self.coeffs.append(np.rint(f / q).astype(np.int64)[..., _ZZ])

    def tq(self, c: int) -> int:
        return min(c, 1)

    def interleaved_order(self):
        """(component, block row, block col) of every block of an
        interleaved scan, in stream order: MCU raster, then each
        component's v x h blocks."""
        my, mx = np.meshgrid(np.arange(self.mcuy), np.arange(self.mcux),
                             indexing="ij")
        parts = []
        for c, (h, v) in enumerate(self.sampling):
            vv, hh = np.meshgrid(np.arange(v), np.arange(h), indexing="ij")
            by = my[..., None, None] * v + vv
            bx = mx[..., None, None] * h + hh
            parts.append((np.full(by.shape, c), by, bx))
        comp = np.concatenate([p[0].reshape(self.mcuy, self.mcux, -1)
                               for p in parts], axis=2).reshape(-1)
        by = np.concatenate([p[1].reshape(self.mcuy, self.mcux, -1)
                             for p in parts], axis=2).reshape(-1)
        bx = np.concatenate([p[2].reshape(self.mcuy, self.mcux, -1)
                             for p in parts], axis=2).reshape(-1)
        return comp, by, bx, self.mcux * self.mcuy

    def single_order(self, c: int):
        """Blocks of a non-interleaved scan of component c: raster over the
        component's own ceil(size / 8) block grid (A.2.2)."""
        h, v = self.sampling[c]
        cw = -(-self.width * h // self.hmax)
        ch = -(-self.height * v // self.vmax)
        by, bx = np.meshgrid(np.arange(-(-ch // 8)), np.arange(-(-cw // 8)),
                             indexing="ij")
        return (np.full(by.size, c), by.reshape(-1), bx.reshape(-1),
                by.size)


def _scan_fields(rows: np.ndarray, comp: np.ndarray, ss: int, se: int,
                 tables, restart_blocks: int = 0):
    """Symbol fields of one scan, in stream order. `rows`: [n, 64] zigzag
    coefficients; `comp` selects each block's (dc, ac) code tables;
    `restart_blocks` > 0 resets DC prediction every that many blocks.
    Returns (fields, lengths, block index of each field)."""
    n = len(rows)
    keys, fields, lens = [], [], []
    if ss == 0:
        dc = rows[:, 0]
        prev = np.zeros(n, np.int64)
        for c in np.unique(comp):
            idx = np.flatnonzero(comp == c)
            p = np.concatenate([[0], dc[idx[:-1]]])
            if restart_blocks:
                seg = idx // restart_blocks
                first = np.concatenate([[True], seg[1:] != seg[:-1]])
                p = np.where(first, 0, p)
            prev[idx] = p
        diff = dc - prev
        cat = _category(diff)
        code = np.stack([t[0][0] for t in tables])[comp, cat]
        clen = np.stack([t[0][1] for t in tables])[comp, cat]
        f, ln = _magnitude_field(code, clen, diff, cat)
        keys.append(np.arange(n) * 1024)
        fields.append(f)
        lens.append(ln)
    k0 = max(ss, 1)
    if se >= k0:
        band = rows[:, k0:se + 1]
        bi, kk = np.nonzero(band)
        kk = kk + k0
        v = rows[bi, kk]
        first = np.concatenate([[True], bi[1:] != bi[:-1]])
        prevk = np.where(first, k0 - 1, np.concatenate([[0], kk[:-1]]))
        run = kk - prevk - 1
        acc = np.stack([t[1][0] for t in tables])
        acl = np.stack([t[1][1] for t in tables])
        nzrl = run // 16
        zb = np.repeat(bi, nzrl)
        keys.append(zb * 1024 + 2 * np.repeat(kk, nzrl) - 1)
        fields.append(acc[comp[zb], 0xF0])
        lens.append(acl[comp[zb], 0xF0])
        cat = _category(v)
        sym = ((run % 16) << 4) | cat
        f, ln = _magnitude_field(acc[comp[bi], sym], acl[comp[bi], sym], v,
                                 cat)
        keys.append(bi * 1024 + 2 * kk)
        fields.append(f)
        lens.append(ln)
        last = np.full(n, k0 - 1)
        np.maximum.at(last, bi, kk)
        eob = np.flatnonzero(last < se)
        keys.append(eob * 1024 + 1000)
        fields.append(acc[comp[eob], 0x00])
        lens.append(acl[comp[eob], 0x00])
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    return (np.concatenate(fields)[order], np.concatenate(lens)[order],
            keys[order] // 1024)


def _entropy_data(fields, lens, block, restart_blocks: int) -> bytes:
    """Pack one scan's fields; with a restart interval, each segment is
    1-filled and followed by its RSTn marker."""
    if not restart_blocks:
        return stuff(pack_bits(fields, lens))
    seg = block // restart_blocks
    cuts = np.flatnonzero(np.diff(seg)) + 1
    out = bytearray()
    bounds = [0, *cuts.tolist(), len(fields)]
    for i in range(len(bounds) - 1):
        a, b = bounds[i], bounds[i + 1]
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += stuff(pack_bits(fields[a:b], lens[a:b]))
    return bytes(out)


def _code_tables(ncomp: int):
    luma = (canonical_codes(_MJPEG_DC_LUMA_BITS, _MJPEG_DC_LUMA_VALUES),
            canonical_codes(_MJPEG_AC_LUMA_BITS, _MJPEG_AC_LUMA_VALUES))
    chroma = (canonical_codes(_MJPEG_DC_CHROMA_BITS, _MJPEG_DC_CHROMA_VALUES),
              canonical_codes(_MJPEG_AC_CHROMA_BITS, _MJPEG_AC_CHROMA_VALUES))
    dht = _dht([(0, 0, _MJPEG_DC_LUMA_BITS, _MJPEG_DC_LUMA_VALUES),
                (1, 0, _MJPEG_AC_LUMA_BITS, _MJPEG_AC_LUMA_VALUES)]
               + ([(0, 1, _MJPEG_DC_CHROMA_BITS, _MJPEG_DC_CHROMA_VALUES),
                   (1, 1, _MJPEG_AC_CHROMA_BITS, _MJPEG_AC_CHROMA_VALUES)]
                  if ncomp > 1 else []))
    return [luma] + [chroma] * (ncomp - 1), dht


def _frame_header(lay: _Layout, marker: int) -> bytes:
    ncomp = len(lay.sampling)
    comps = [(c + 1, lay.sampling[c], lay.tq(c)) for c in range(ncomp)]
    return (b"\xff\xd8" + _jfif() + _dqt(lay.qts[:min(ncomp, 2)])
            + _sof(marker, 8, lay.width, lay.height, comps))


def _gather(lay: _Layout, order) -> "tuple[np.ndarray, np.ndarray]":
    comp, by, bx, _ = order
    rows = np.empty((len(comp), 64), np.int64)
    for c in np.unique(comp):
        m = comp == c
        rows[m] = lay.coeffs[c][by[m], bx[m]]
    return rows, comp


def encode_baseline(pixels: np.ndarray, quality: int = 90,
                    subsampling: str = "420",
                    restart_interval: int = 0) -> bytes:
    """Baseline sequential JPEG (SOF0) of [H, W, 3] RGB or [H, W] / [H, W, 1]
    gray uint8 pixels. `restart_interval` is in MCUs (0 = no DRI)."""
    lay = _Layout(pixels, subsampling, quality)
    ncomp = len(lay.sampling)
    tables, dht = _code_tables(ncomp)
    order = lay.interleaved_order() if ncomp > 1 else lay.single_order(0)
    rows, comp = _gather(lay, order)
    blocks_per_mcu = sum(h * v for h, v in lay.sampling) if ncomp > 1 else 1
    rb = restart_interval * blocks_per_mcu
    fields, lens, block = _scan_fields(rows, comp, 0, 63, tables, rb)
    head = _frame_header(lay, 0xC0) + dht
    if restart_interval:
        head += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    sos = _sos([(c + 1, lay.tq(c), lay.tq(c)) for c in range(ncomp)], 0, 63)
    return head + sos + _entropy_data(fields, lens, block, rb) + b"\xff\xd9"


def encode_progressive(pixels: np.ndarray, quality: int = 90,
                       subsampling: str = "420",
                       bands=((1, 5), (6, 63))) -> bytes:
    """Progressive JPEG (SOF2) by spectral selection: an interleaved DC scan,
    then one non-interleaved AC scan per component and band."""
    lay = _Layout(pixels, subsampling, quality)
    ncomp = len(lay.sampling)
    tables, dht = _code_tables(ncomp)
    out = _frame_header(lay, 0xC2) + dht
    order = lay.interleaved_order() if ncomp > 1 else lay.single_order(0)
    rows, comp = _gather(lay, order)
    fields, lens, block = _scan_fields(rows, comp, 0, 0, tables)
    out += _sos([(c + 1, lay.tq(c), 0) for c in range(ncomp)], 0, 0)
    out += _entropy_data(fields, lens, block, 0)
    for ss, se in bands:
        for c in range(ncomp):
            rows, comp = _gather(lay, lay.single_order(c))
            fields, lens, block = _scan_fields(rows, comp, ss, se, tables)
            out += _sos([(c + 1, 0, lay.tq(c))], ss, se)
            out += _entropy_data(fields, lens, block, 0)
    return out + b"\xff\xd9"


def lossless_diffs(pixels: np.ndarray, precision: int) -> np.ndarray:
    """Predictor-1 differences [C, H, W] of [H, W] or [H, W, C] samples:
    the first sample against 2**(P-1), the first column against the sample
    above, the rest against the sample to the left; wrapped to int16
    (-32768 stands for the category-16 difference 32768)."""
    s = np.asarray(pixels, np.int64)
    if s.ndim == 2:
        s = s[..., None]
    s = s.transpose(2, 0, 1)
    pred = np.empty_like(s)
    pred[:, :, 1:] = s[:, :, :-1]
    pred[:, 1:, 0] = s[:, :-1, 0]
    pred[:, 0, 0] = 1 << (precision - 1)
    return ((s - pred + 0x8000) & 0xFFFF) - 0x8000


def encode_lossless(pixels: np.ndarray, precision: int = 8) -> bytes:
    """Lossless JPEG (SOF3), predictor 1, no point transform, one
    interleaved scan of every component (1x1 sampling)."""
    diffs = lossless_diffs(pixels, precision)
    ncomp, height, width = diffs.shape
    code, clen = canonical_codes(_LL_BITS, _LL_VALUES)
    d = diffs.transpose(1, 2, 0).reshape(-1)      # pixel-major, comp minor
    cat = np.where(d == -0x8000, 16, _category(d))
    fields, lens = _magnitude_field(code[cat], clen[cat], d,
                                    np.where(cat == 16, 0, cat))
    comps = [(c + 1, (1, 1), 0) for c in range(ncomp)]
    return (b"\xff\xd8" + _sof(0xC3, precision, width, height, comps)
            + _dht([(0, 0, _LL_BITS, _LL_VALUES)])
            + _sos([(c + 1, 0, 0) for c in range(ncomp)], 1, 0)
            + stuff(pack_bits(fields, lens)) + b"\xff\xd9")


def make_jpeg(kind: str, width: int, height: int, seed: int = 0,
              quality: int = 90) -> bytes:
    """One generated JPEG of `kind` (see KINDS). DRI kinds restart every
    MCU row; progressive kinds are 4:2:0 (or gray) by spectral selection."""
    if kind.startswith("lossless"):
        bits = int(kind[len("lossless"):])
        return encode_lossless(photo(width, height, 1, seed, bits)[..., 0],
                               bits)
    gray = kind in ("gray", "progressive-gray")
    pixels = photo(width, height, 1 if gray else 3, seed)
    if kind.startswith("progressive"):
        return encode_progressive(pixels, quality, "420")
    sub, _, dri = kind.partition("-")
    lay_mcux = -(-width // (8 * max(h for h, _ in SAMPLING[sub])))
    return encode_baseline(pixels, quality, sub,
                           restart_interval=lay_mcux if dri else 0)
