"""Anchored Huffman decode as a GPU kernel (Pallas, Triton route).

The plain-JAX engine (device_scan.build_xla_sweep) advances every chunk in
lockstep through `s_max` steps of a `lax.scan`, which a GPU runs as a loop
of small kernels, and then scatters every (position, value) emission. This
kernel gives each anchored chunk a lane of its own, in the manner of the
GPU decoders of Weissenberger & Schmidt (PAPERS.md):

- a lane starts from its chunk's exact entry state (bit offset, first block,
  MCU-pattern slot; entropy/device_scan.AnchoredScan) and walks symbols with
  that state in registers until its block budget is spent;
- a 16-bit window into the scan's 64K-entry decode LUT (the same LUT as the
  plain engine, device_scan.build_decode_lut16) resolves each symbol;
- each coefficient is stored straight into a zero-initialised int16
  [n_blocks * 64] stream-order tensor (natural order inside a block, DC
  column holding diffs). Chunks start on block boundaries and own whole
  blocks, so the stores are disjoint and need no atomics.

Inputs and output match build_xla_sweep exactly, so the two engines are
interchangeable behind device_scan.build_sweep; the assembler
(device_scan.build_assembler_nat) does the DC prefix sums and the raster
placement afterwards.
"""

from __future__ import annotations

import numpy as np

from .scan_python import UNZIGZAG

# Chunks per program: one warp, one chunk per thread (32 lanes ran the
# `large` sweep in about half the time of 64 or 128 on an H100, PERF.md).
LANES = 32
PATTERN_PAD = 16      # MCU pattern table length (at most 10 blocks per MCU)


def build_triton_sweep(n_blocks: int, s_max: int, pattern: tuple,
                       lanes: int = LANES, interpret: bool = False):
    """Traceable sweep (words, anchor_bits, anchor_block, anchor_slot, luts)
    -> int16 [n_blocks, 64]; see device_scan.build_xla_sweep for the
    argument layout. Emissions outside [0, n_blocks) are dropped (stripe
    mode rebases straddling chunks to negative blocks). `interpret` runs
    the kernel in the Pallas interpreter, for tests on the CPU."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    pat = np.zeros(PATTERN_PAD, np.int32)
    pat[:len(pattern)] = pattern
    plen = max(len(pattern), 1)
    n_codes = n_blocks * 64
    # The interpreter writes a masked lane's old value back, which would
    # clobber a live lane's store to the same index: give masked lanes a
    # spare row past the tensor there. Compiled stores skip masked lanes.
    spare = 64 if interpret else 0

    def kernel(words_ref, bits_ref, block_ref, slot_ref, luts_ref, pat_ref,
               unzig_ref, _zeros_ref, out_ref):
        n_items = bits_ref.shape[0]
        n_words = words_ref.shape[0]
        i = pl.program_id(0) * lanes + jnp.arange(lanes, dtype=jnp.int32)
        live = i < n_items
        p0 = plt.load(bits_ref.at[i], mask=live, other=0)
        base = plt.load(block_ref.at[i], mask=live, other=0)
        budget = plt.load(block_ref.at[i + 1], mask=live, other=0) - base
        slot0 = plt.load(slot_ref.at[i], mask=live, other=0)
        zero = jnp.zeros(lanes, jnp.int32)

        def cond(carry):
            s, _p, _k, blk, _slot = carry
            return (s < s_max) & (jnp.max((blk < budget).astype(jnp.int32))
                                  > 0)

        def body(carry):
            s, p, k, blk, slot = carry
            active = blk < budget
            widx = (p >> 5).astype(jnp.int32)
            b = p & 31
            w0 = plt.load(words_ref.at[widx], mask=active & (widx < n_words),
                          other=0)
            w1 = plt.load(words_ref.at[widx + 1],
                          mask=active & (widx + 1 < n_words), other=0)
            win = jnp.where(b == 0, w0,
                            (w0 << b) | (w1 >> (jnp.uint32(32)
                                                - jnp.maximum(b, 1))))
            pair = plt.load(pat_ref.at[slot])
            is_dc = k == 0
            row = pair * 2 + jnp.where(is_dc, 0, 1)
            ent = plt.load(luts_ref.at[row * 65536
                                       + (win >> 16).astype(jnp.int32)],
                           mask=active, other=0)
            val8 = (ent & 0xFF).astype(jnp.int32)
            length = (ent >> 8) & 0x1F

            r = val8 >> 4
            sz = val8 & 0x0F
            mag = jnp.where(is_dc, val8, sz).astype(jnp.uint32)
            magm = jnp.maximum(mag, 1)
            mbits = ((win >> (jnp.uint32(32) - length - magm))
                     & ((jnp.uint32(1) << magm) - 1)).astype(jnp.int32)
            half = jnp.int32(1) << (magm.astype(jnp.int32) - 1)
            full = jnp.int32(1) << magm.astype(jnp.int32)
            ext = jnp.where(mbits < half, mbits - full + 1, mbits)
            ext = jnp.where(mag == 0, 0, ext)

            is_zrl = (~is_dc) & (sz == 0) & (r == 15)
            is_eob = (~is_dc) & (sz == 0) & (r != 15)
            k_coeff = jnp.where(is_dc, 0, jnp.minimum(k + r, 63))
            pos = plt.load(unzig_ref.at[k_coeff])
            code = (base + blk) * 64 + pos
            emits = (active & (is_dc | ((~is_zrl) & (~is_eob)))
                     & (code >= 0) & (code < n_codes))
            plt.store(out_ref.at[jnp.where(emits, code, n_codes + spare - 1)],
                      ext.astype(jnp.int16), mask=emits)

            k_next = jnp.where(is_dc, 1,
                               jnp.where(is_zrl, k + 16,
                                         jnp.where(is_eob, 64, k + r + 1)))
            done = active & (is_eob | (k_next >= 64))
            p = p + jnp.where(active, length + mag, jnp.uint32(0))
            k = jnp.where(active, jnp.where(done, 0, k_next), k)
            blk = blk + done.astype(jnp.int32)
            slot = slot + done.astype(jnp.int32)
            slot = jnp.where(slot >= plen, 0, slot)
            return s + 1, p, k, blk, slot

        jax.lax.while_loop(cond, body, (jnp.int32(0), p0, zero, zero, slot0))

    def run(words, anchor_bits, anchor_block, anchor_slot, luts):
        n_items = anchor_bits.shape[0]
        call = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((n_codes + spare,), jnp.int16),
            grid=(pl.cdiv(n_items, lanes),),
            input_output_aliases={7: 0},
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=max(lanes // 32, 1),
                                               num_stages=1),
            interpret=interpret,
            name="anchored_huffman_decode",
        )
        flat = call(words, anchor_bits, anchor_block, anchor_slot,
                    luts.reshape(-1), jnp.asarray(pat),
                    jnp.asarray(np.asarray(UNZIGZAG, np.int32)),
                    jnp.zeros((n_codes + spare,), jnp.int16))
        return flat[:n_codes].reshape(n_blocks, 64)

    return run
