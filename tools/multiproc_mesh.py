#!/usr/bin/env python
"""Multi-process mesh harness: 2 OS processes x 4 CPU devices = one 8-device
global mesh over `jax.distributed` (gloo/TCP on localhost) — the multi-host
execution story exercised for real, not via a single-process virtual mesh.

What runs (each bit-exact against a process-local oracle):

  1. DP batch decode over a global "data"=8 axis with PROCESS-LOCAL staging:
     each rank materializes only the batch rows its own devices hold and the
     global array is assembled with jax.make_array_from_single_device_arrays
     — the host->global-batch seam where multi-host decode actually breaks.
  2. SP striped decode over a global "stripe"=8 axis: the 1-row V2-upsampling
     halo ppermute (parallel/stripes.py) crosses the PROCESS boundary, i.e.
     rides the gloo transport (the cross-host analog), not shared memory.
  3. Real JPEGs through the mesh-batched prefix pipeline
     (models/stream.py _compiled_prefix_pipeline_batched): each rank runs the
     full host staging (parse + entropy + prefix pack) for its rows only,
     feeds the sharded jit, and verifies its addressable output shards
     against a single-device decode of the same rows.

The reference has no distributed story at all (SURVEY.md §4: its closest
analog is the rayon limited-threadpool suite); multi-host decode needs this
path to exist and be correct.

Usage:
  python tools/multiproc_mesh.py                 # parent: spawn 2 ranks
  python tools/multiproc_mesh.py --rank R --port P   # child (internal)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROCS = 2
LOCAL_DEVICES = 4
MARK = "MULTIPROC-MESH OK"


# ---------------------------------------------------------------------------
# Child
# ---------------------------------------------------------------------------

def _assemble(sharding, global_shape, piece_of):
    """Build a global jax.Array from per-device pieces this process owns.

    `piece_of(index)` maps a device's global index (a tuple of slices) to the
    host data for that shard — the explicit process-local-staging seam."""
    import jax

    arrs = []
    dmap = sharding.devices_indices_map(tuple(global_shape))
    for dev in sharding.addressable_devices:
        arrs.append(jax.device_put(piece_of(dmap[dev]), dev))
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sharding, arrs)


def _local_shards_equal(out, expect_of, what: str) -> None:
    """Compare every addressable shard of `out` against the oracle rows."""
    import numpy as np

    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        want = expect_of(shard.index)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        if not (got == want).all():
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} mismatching samples in "
                                 f"shard {shard.index}")


def child(rank: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES} "
        + os.environ.get("XLA_FLAGS", ""))
    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=N_PROCS, process_id=rank)
    import jax.numpy as jnp  # noqa: F401  (backend init)
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert len(jax.devices()) == N_PROCS * LOCAL_DEVICES
    assert len(jax.local_devices()) == LOCAL_DEVICES

    import __graft_entry__ as ge
    from jpeg_decoder_jax.ops.pipeline import _reconstruct
    from jpeg_decoder_jax.parallel.mesh import make_mesh

    # ---- 1. DP over "data"=8, process-local staging --------------------
    mesh = make_mesh({"data": N_PROCS * LOCAL_DEVICES})
    geometry = ge._example_geometry()
    batch = N_PROCS * LOCAL_DEVICES
    stores_full, qts = ge._example_inputs(geometry, batch=batch, seed=7)

    sharded = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    g_stores = tuple(
        _assemble(sharded, s.shape, lambda idx, s=s: s[idx])
        for s in stores_full)
    g_qts = tuple(
        _assemble(repl, q.shape, lambda idx, q=q: q[idx]) for q in qts)

    from jpeg_decoder_jax.parallel.batch import make_batch_pipeline
    fn = make_batch_pipeline(geometry, mesh, "data")
    out = fn(g_stores, g_qts)

    oracle = np.stack([
        np.asarray(_reconstruct(geometry,
                                [s[i] for s in stores_full], qts, np))
        for i in range(batch)])
    _local_shards_equal(out, lambda idx: oracle[idx], "dp-batch")
    print(f"[rank {rank}] 1. DP batch over 2 processes: bit-exact", flush=True)

    # ---- 2. SP stripes over "stripe"=8: halo crosses the process seam --
    from jpeg_decoder_jax.parallel.stripes import make_stripe_pipeline
    sp = N_PROCS * LOCAL_DEVICES
    smesh = make_mesh({"stripe": sp})
    sgeo = ge._example_geometry(mcu_rows=2 * sp)
    mcu_rows = sgeo.components[0].blocks_high // 2
    stores1, qts1 = ge._example_inputs(sgeo, seed=3)

    k = -(-mcu_rows // sp)
    padded = []
    for c, store in zip(sgeo.components, stores1):
        vi = c.blocks_high // mcu_rows
        want = k * sp * vi
        blocks = store.reshape(c.blocks_high, c.blocks_wide, 64)
        if want > c.blocks_high:
            blocks = np.concatenate(
                [blocks, np.zeros((want - c.blocks_high, c.blocks_wide, 64),
                                  np.int16)], axis=0)
        padded.append(blocks.reshape(-1, 64))

    stripe_sh = NamedSharding(smesh, P("stripe"))
    repl_s = NamedSharding(smesh, P())
    g_blocks = tuple(
        _assemble(stripe_sh, pb.shape, lambda idx, pb=pb: pb[idx])
        for pb in padded)
    g_qts1 = tuple(
        _assemble(repl_s, q.shape, lambda idx, q=q: q[idx]) for q in qts1)

    sfn = make_stripe_pipeline(sgeo, mcu_rows, sp, smesh, "stripe")
    simg = sfn(g_blocks, g_qts1)
    sref = np.asarray(_reconstruct(sgeo, stores1, qts1, np))
    pad_rows = simg.shape[0] - sref.shape[0]
    sref_pad = np.concatenate(
        [sref, np.zeros((pad_rows,) + sref.shape[1:], sref.dtype)]) \
        if pad_rows else sref
    _local_shards_equal(simg, lambda idx: sref_pad[idx], "sp-stripes")
    print(f"[rank {rank}] 2. SP stripes, halo over gloo: bit-exact",
          flush=True)

    # ---- 3. Real JPEGs, process-local host staging -> sharded pipeline -
    from PIL import Image
    import io
    from jpeg_decoder_jax.models.stream import (
        _bucket, _compiled_prefix_pipeline_batched, stage_host)

    base = Image.open("/root/reference/tests/reftest/images/rgb.jpg")
    variants = []
    for q in (85, 92):
        buf = io.BytesIO()
        base.save(buf, "JPEG", quality=q, subsampling=2)
        variants.append(buf.getvalue())

    # Stage each distinct input once, on THIS process, for the rows its
    # devices own (rows alternate the two variants).
    staged = [stage_host(v, precision="fast") for v in variants]
    assert staged[0].geometry == staged[1].geometry
    rgeo = staged[0].geometry
    resid_bucket = _bucket(max(len(st.resid_idx) for st in staged))

    def pad_resid(st):
        idx = np.full(resid_bucket, st.total_coeffs, np.int32)
        vals = np.zeros(resid_bucket, np.int16)
        kr = len(st.resid_idx)
        idx[:kr] = st.resid_idx
        vals[:kr] = st.resid_vals
        return idx, vals

    def row_st(i: int):
        return staged[i % len(staged)]

    def rows_from(idx, field):
        rows = range(*idx[0].indices(batch))
        if field in ("ri", "rv"):
            return np.stack([pad_resid(row_st(i))[0 if field == "ri" else 1]
                             for i in rows])
        return np.stack([getattr(row_st(i), field) for i in rows])

    g_dc = _assemble(sharded, (batch,) + staged[0].dc.shape,
                     lambda idx: rows_from(idx, "dc"))
    g_ac = _assemble(sharded, (batch,) + staged[0].ac.shape,
                     lambda idx: rows_from(idx, "ac"))
    g_ri = _assemble(sharded, (batch, resid_bucket),
                     lambda idx: rows_from(idx, "ri"))
    g_rv = _assemble(sharded, (batch, resid_bucket),
                     lambda idx: rows_from(idx, "rv"))
    ncomp = len(staged[0].qts)
    g_qts_b = tuple(
        _assemble(sharded, (batch,) + staged[0].qts[c].shape,
                  lambda idx, c=c: np.stack(
                      [row_st(i).qts[c]
                       for i in range(*idx[0].indices(batch))]))
        for c in range(ncomp))

    rfn = _compiled_prefix_pipeline_batched(rgeo, resid_bucket, batch,
                                            mesh, "data")
    rout = rfn(g_dc, g_ac, g_ri, g_rv, g_qts_b)

    # Single-device oracle: the same batched program, batch=1, no mesh.
    ofn = _compiled_prefix_pipeline_batched(rgeo, resid_bucket, 1, None,
                                            "data")
    per_variant = [
        np.asarray(ofn(st.dc[None], st.ac[None],
                       pad_resid(st)[0][None], pad_resid(st)[1][None],
                       tuple(q[None] for q in st.qts)))[0]
        for st in staged]

    def expect_rows(idx):
        rows = range(*idx[0].indices(batch))
        return np.stack([per_variant[i % len(per_variant)] for i in rows])

    _local_shards_equal(rout, expect_rows, "real-jpeg-dp")
    print(f"[rank {rank}] 3. real-JPEG stream, process-local staging: "
          f"bit-exact", flush=True)

    # 4. Lossless (SOF3) over the same global data axis: each rank stages
    #    the uint16 difference planes for its rows only; the device runs the
    #    predictor reconstruction, sharded (round-3 StagedLossless path).
    from jpeg_decoder_jax import Decoder
    from jpeg_decoder_jax.models.stream import (_compiled_lossless_pipeline,
                                                stage_host_lossless)
    ll_path = ("/root/reference/tests/reftest/images/lossless/1/"
               "jpeg_lossless_sel1.jpg")
    if os.path.exists(ll_path):
        lldata = open(ll_path, "rb").read()
        ll = stage_host_lossless(lldata)
        llfn = _compiled_lossless_pipeline(
            ll.diffs.shape[0], ll.predictor, ll.point_transform,
            ll.precision, ll.restart_all, ll.out_width, ll.out_height,
            batch=batch, mesh=mesh, data_axis="data")
        g_diffs = _assemble(
            sharded, (batch,) + ll.diffs.shape,
            lambda idx: np.stack(
                [ll.diffs for _ in range(*idx[0].indices(batch))]))
        llout = llfn(g_diffs)
        want_ll = Decoder(lldata, backend="numpy",
                          precision="exact").decode_array()
        _local_shards_equal(
            llout,
            lambda idx: np.stack(
                [want_ll for _ in range(*idx[0].indices(batch))]),
            "lossless-dp")
        print(f"[rank {rank}] 4. lossless diffs, process-local staging: "
              f"bit-exact", flush=True)

    print(f"[rank {rank}] {MARK}", flush=True)


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parent(timeout_s: int) -> int:
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--rank", str(r), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(N_PROCS)
    ]
    deadline = time.time() + timeout_s
    ok = True
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(5.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        text = out.decode(errors="replace")
        sys.stdout.write(text)
        if p.returncode != 0 or MARK not in text:
            ok = False
    print("multiproc_mesh:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--timeout", type=int, default=420)
    args = ap.parse_args()
    if args.rank is None:
        return parent(args.timeout)
    child(args.rank, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
