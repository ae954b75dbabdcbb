"""DIFFERENTIAL ORACLE — not the production encoder.

An independently-formulated device Huffman encoder kept solely so
``tests/test_ops.py`` can cross-check the production tree-merge encoder
(``ops/encode_merge.py``) against a second device implementation with a
completely different structure (scan + searchsorted vs tree merge +
ownership scatter).  It is slower than the production path (per-symbol
gathers + a long associative_scan) and is NOT exported from
``datacomp.ops`` — use :func:`datacomp.ops.encode_device_merge`.

Formulation: bit-position scan + word-aligned OR-merge.

Device re-design of the reference's GPU packet encoder
(``TornadoKernels.encodePacketKernel:115-205`` — one thread per 32-bit output
word, binary-searching a CPU-computed prefix-sum of bit positions).  Rather
than translating that gather kernel, the encode is expressed in three
XLA-native data-parallel stages with no scatters and no atomics:

1. **positions** — per-symbol code lengths (table gather) and an exclusive
   ``cumsum`` give every symbol its absolute start bit (the prefix sum the
   reference runs serially on CPU, ``GpuCompressionService.java:773-779``).
2. **contributions** — each symbol's codeword lands in at most two 32-bit
   words (codes ≤ 32 bits).  Both aligned 32-bit contributions are computed
   with shifts/masks (MSB-first order identical to the host encoder).
3. **merge** — contributions are OR-combined per word with a *segmented OR
   scan* (``jax.lax.associative_scan`` over (word_id, value) pairs, word ids
   nondecreasing), then one vectorized ``searchsorted`` picks each word's
   final accumulated value.  Bits within a word are disjoint, so OR == the
   scatter-add the GPU kernel needed atomics-ordering arguments for.

Output is a padded uint32 word array (big-endian bit order within words) plus
the true bit length; the container layer slices ``ceil(bits/8)`` bytes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _seg_or(a, b):
    """Segmented-OR combine for associative_scan over (word_id, value)."""
    wa, va = a
    wb, vb = b
    return wb, vb | jnp.where(wa == wb, va, 0)


@functools.partial(jax.jit, static_argnames=("out_words", "subblock"))
def encode_device_scan_oracle(
    data: jnp.ndarray,       # uint8[N] padded chunk
    valid_len: jnp.ndarray,  # int32 scalar: real byte count
    lengths: jnp.ndarray,    # int32[256]
    codes: jnp.ndarray,      # uint32[256]
    out_words: int,          # static output capacity in 32-bit words (≥ N)
    subblock: int = 0,       # if >0, also return gap bits every `subblock` symbols
):
    """Returns (words uint32[out_words], total_bits int32[, gaps uint32[N/subblock]])."""
    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < valid_len
    x = data.astype(jnp.int32)
    lens = jnp.where(valid, lengths[x], 0)
    cws = jnp.where(valid, codes[x], 0).astype(jnp.uint32)
    ends = jnp.cumsum(lens, dtype=jnp.int32)
    total_bits = ends[-1]
    starts = ends - lens

    sw = starts >> 5                     # first word touched
    ws = sw << 5
    # contribution to word sw: codeword aligned so its last bit sits at
    # stream position starts+lens-1; bits that belong to word sw+1 dropped,
    # bits that would precede the word overflow out of the uint32 naturally
    drop = jnp.clip(starts + lens - ws - 32, 0, 31).astype(jnp.uint32)
    shl = jnp.clip(ws + 32 - starts - lens, 0, 31).astype(jnp.uint32)
    c1 = jnp.where(lens > 0, (cws >> drop) << shl, jnp.uint32(0))
    # spill into word sw+1: low `drop` bits of the codeword, left-aligned
    # (clamp the shift to keep it < 32 even where the mask is false)
    has_spill = (starts + lens - ws) > 32
    spill_shift = jnp.uint32(32) - jnp.maximum(drop, jnp.uint32(1))
    c2 = jnp.where(has_spill, cws << spill_shift, jnp.uint32(0))

    # segmented OR scans (word ids nondecreasing in both sequences)
    _, accA = jax.lax.associative_scan(_seg_or, (sw, c1))
    _, accB = jax.lax.associative_scan(_seg_or, (sw + 1, c2))

    # for each output word w: last symbol j with sw[j] <= w is ss[w]-1
    wq = jnp.arange(out_words, dtype=jnp.int32)
    ss = jnp.searchsorted(sw, wq, side="right").astype(jnp.int32)
    jA = ss - 1                                    # last j with sw[j] <= w
    jB = jnp.concatenate([jnp.full(1, -1, jnp.int32), jA[:-1]])  # last j with sw[j] <= w-1
    w_ids = jnp.arange(out_words, dtype=jnp.int32)
    wordA = jnp.where(
        (jA >= 0) & (sw[jnp.clip(jA, 0, n - 1)] == w_ids),
        accA[jnp.clip(jA, 0, n - 1)],
        jnp.uint32(0),
    )
    wordB = jnp.where(
        (jB >= 0) & (sw[jnp.clip(jB, 0, n - 1)] + 1 == w_ids),
        accB[jnp.clip(jB, 0, n - 1)],
        jnp.uint32(0),
    )
    words = wordA | wordB

    if subblock:
        gaps = starts[::subblock].astype(jnp.uint32)
        return words, total_bits, gaps
    return words, total_bits
