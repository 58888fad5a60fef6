"""Concurrency regression tests — the analog of the reference's rayon suite.

The reference guards against deadlocks/races when decodes run inside
constrained thread pools (`/root/reference/tests/rayon*.rs`). Here the shared
mutable surfaces are the native entropy kernel's buffer pool, the Huffman
table C-struct cache, and the jit pipeline caches: many concurrent decodes
must produce byte-identical results with no deadlock.
"""

import concurrent.futures as cf

from conftest import REFTEST_IMAGES

from jpeg_decoder_jax import Decoder
from jpeg_decoder_jax.models.stream import stage_host

FILES = ["rgb.jpg", "restarts.jpg", "mjpeg.jpg", "mozilla/jpg-progressive.jpg",
         "lossless/1/jpeg_lossless_sel1.jpg"]


def test_concurrent_decodes_are_identical():
    datas = {f: open(REFTEST_IMAGES / f, "rb").read() for f in FILES}
    golden = {f: Decoder(d).decode() for f, d in datas.items()}

    def work(i):
        f = FILES[i % len(FILES)]
        return f, Decoder(datas[f]).decode()

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        for f, out in pool.map(work, range(64)):
            assert out == golden[f]


def test_concurrent_staging():
    """stage_host (pooled buffers + prefix capture) under 8-way concurrency."""
    data = open(REFTEST_IMAGES / "rgb.jpg", "rb").read()
    ref = stage_host(data)

    def work(_):
        st = stage_host(data)
        assert (st.dc == ref.dc).all()
        assert (st.ac == ref.ac).all()
        r = (st.resid_idx < st.total_coeffs).sum()
        r0 = (ref.resid_idx < ref.total_coeffs).sum()
        assert r == r0
        return True

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(work, range(32)))


def test_soak_mixed_corpus_bounded_memory():
    """Mixed-corpus soak: decode + staging over many iterations must stay
    deterministic and keep the buffer pool bounded (long-lived service)."""
    import random

    from conftest import reftest_files
    from jpeg_decoder_jax import JpegError
    from jpeg_decoder_jax.models.stream import _pool, stage_host

    datas = []
    for p in reftest_files()[:20]:
        datas.append(open(p, "rb").read())
    rng = random.Random(7)
    golden = {}
    for i in range(300):
        d = rng.choice(datas)
        try:
            if i % 3 == 0:
                stage_host(d)
            else:
                out = Decoder(d).decode()
                key = hash(d)
                if key in golden:
                    assert golden[key] == hash(out)
                golden[key] = hash(out)
        except JpegError:
            pass
    assert _pool._bytes <= _pool._budget
