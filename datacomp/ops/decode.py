"""Device Huffman decoder: gap-array massively parallel canonical decode.

The reference abandoned in-chunk GPU decode because a Huffman stream is
"inherently sequential" (``gpu/GpuCompressionService.java:1096-1100``) and
falls back to CPU.  This framework goes further via the gap-array method from
the paper bundled with the reference (arXiv:2010.10039): format v2 records the
absolute bit offset of every sub-block of S symbols (free at encode time —
they are values of the same prefix-sum the encoder already computes), so at
decode time thousands of sub-blocks enter the bitstream at known offsets and
decode *concurrently*, vectorized across all sub-blocks with ``lax.scan``.

The decode step avoids per-element table gathers (the 256-entry gather is
the A/B candidate on the card):

* **code length by comparison** — the canonical boundaries
  ``limit[l] << (16-l)`` are monotone in the left-aligned 16-bit window, so
  ``len = 1 + Σ_l [win >= boundary_l]`` is 16 broadcast compares
  (``core/TableBasedHuffmanDecoder.java`` walks a 1024-entry table instead);
* **symbol by one-hot einsum** — the canonical index
  ``(win >> (16-len)) + (base[len] - first[len])`` selects into the 256-entry
  length-sorted symbol list via a 16x16 one-hot matmul, not a gather;
* **bit window in registers** — each lane carries a 64-bit window as two
  uint32 halves and decodes TWO symbols per scan step with ONE masked
  word-refill gather: the only gather left is 1 per 2 symbols.

Codebooks deeper than 16 bits fall back to the host decoder (vanishingly
rare for byte data; the CPU service handles them).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitio import CanonicalDecodeTables

TABLE_BITS = 16

#: production refill width: a row gather's cost is mostly per *index*, not
#: per fetched word, so 8-word rows amortize the decoder's only gather ~8x.
#: W=16 stays supported (its 33-register shift chain is the cost to weigh).
#: The per-step 16x16 symbol einsum stays inside the scan: one post-scan
#: lookup would materialize (N,16) one-hot operands through device memory.
#: None of these choices has been measured on a GPU yet.
DEFAULT_REFILL_WORDS = 8


def build_decode_tables(lengths: np.ndarray, table_bits: int = TABLE_BITS):
    """Comparison-decode constants for :func:`decode_device`:

    * ``limits`` int32[16] — monotone canonical boundaries
      ``(first[l] + count[l]) << (16 - l)`` (``1 << 16`` for unused lengths,
      so the running sum saturates at the true code length);
    * ``adj`` int32[16] — ``base[l] - first[l]`` (canonical index offset);
    * ``sym`` int32[256] — symbols sorted by (length, symbol), zero-padded.

    Raises ValueError when any code exceeds ``table_bits`` (host fallback).
    """
    t = CanonicalDecodeTables(lengths)
    if t.max_len > table_bits:
        raise ValueError(f"max code length {t.max_len} > table bits {table_bits}")
    limits = np.full(table_bits, 1 << table_bits, np.int64)
    adj = np.zeros(table_bits, np.int64)
    for ln in range(1, t.max_len + 1):
        limits[ln - 1] = (int(t.first[ln]) + int(t.counts[ln])) << (table_bits - ln)
        adj[ln - 1] = int(t.base[ln]) - int(t.first[ln])
    sym = np.zeros(256, np.int32)
    sym[: len(t.sym_sorted)] = t.sym_sorted
    return limits.astype(np.int32), adj.astype(np.int32), sym


def max_code_len(lengths: np.ndarray) -> int:
    lengths = np.asarray(lengths)
    used = lengths[lengths > 0]
    return int(used.max()) if used.size else 0


def syms_per_refill(max_len: int, subblock: int, refill_words: int = 1) -> int:
    """Largest symbols-per-step the codebook depth and sub-block size allow.

    The ``refill_words * 32``-bit refill per step must cover worst-case
    consumption (``k * max_len <= 32 * W`` keeps the bit budget
    non-draining), and the scan length must divide the sub-block.
    Correctness with the shared 16-bit window peek needs >= max_len valid
    bits before each in-step decode; for W=1 this follows from
    ``33 - (k-1) * max_len >= max_len``, for W>=2 from the wider window's
    ``nb >= 32*W + 33`` start-of-step invariant (see :func:`decode_device`).
    """
    ml = max(max_len, 1)
    if refill_words == 1:
        for k in (4, 3, 2):
            if k * ml <= 32 and subblock % k == 0:
                return k
        return 1
    cap = min(32, (32 * refill_words) // ml)
    for k in range(cap, 0, -1):
        if subblock % k == 0:
            return k
    return 1


def cmp_len_bucket(max_len: int) -> int:
    """Static compare-width bucket covering ``max_len`` (bounds recompiles)."""
    for b in (8, 10, 12, TABLE_BITS):
        if b >= max_len:
            return b
    return TABLE_BITS


@functools.partial(
    jax.jit,
    static_argnames=(
        "subblock", "num_subblocks", "syms_per_step", "table_bits", "cmp_len",
        "refill_words",
    ),
)
def decode_device(
    words: jnp.ndarray,      # uint32[W+2] compressed stream as big-endian-bit words (2 pad words)
    gaps: jnp.ndarray,       # uint32[num_subblocks] absolute start bit per sub-block
    limits: jnp.ndarray,     # int32[16] from build_decode_tables
    adj: jnp.ndarray,        # int32[16]
    sym: jnp.ndarray,        # int32[256]
    subblock: int,           # symbols per sub-block (static)
    num_subblocks: int,      # static padded sub-block count
    syms_per_step: int = 2,  # static; use syms_per_refill(max_len, subblock, refill_words)
    table_bits: int = TABLE_BITS,
    cmp_len: int = TABLE_BITS,  # static; >= chunk max code length (cmp_len_bucket)
    refill_words: int = 1,   # static; words fetched per refill gather (1/2/4/8)
):
    """Decode ``num_subblocks x subblock`` symbols → uint8[num_subblocks*subblock].

    Sub-blocks beyond the real data decode garbage from padded state; callers
    slice to the true symbol count.

    The decode step's only gather is the window refill, and a row gather's
    cost is mostly per *index*, not per fetched word.  ``refill_words=W``
    therefore fetches
    W-word rows of the stream per refill and decodes
    ``syms_per_refill(max_len, subblock, W)`` symbols per step from a
    ``V = 2W+1``-register bit window, cutting the refill gathers ~W-fold:

    * window: V uint32 registers, MSB-first; ``nb`` counts valid bits;
    * invariant: a step starts with ``nb > 32*(V-W) = 32*(W+1)``, consumes
      at most ``k*max_len <= 32*W`` bits, so every in-step decode sees >= 33
      valid bits (>= the 16-bit comparison window);
    * refill: when ``nb <= 32*(W+1)``, one row gather appends W whole words
      at bit offset ``nb`` (possible because init discards the gap's leading
      bits so validity always ends on a stream word boundary), restoring the
      invariant; ``wi`` stays W-aligned via up-to-W-1 masked single-word
      appends at init.
    """
    k = syms_per_step
    W = refill_words
    assert subblock % k == 0, "symbols-per-step must divide the sub-block"
    assert W in (1, 2, 4, 8, 16), "refill-words must be 1, 2, 4, 8 or 16"
    # CONTRACT (cannot be fully checked here — max_len is not an argument):
    # k * max_code_len <= 32 * W, or the window under-refills and the output
    # is silently corrupt.  Direct callers MUST derive k via
    # syms_per_refill(max_len, subblock, refill_words) or validate with
    # check_decompress_step_params; every public wrapper
    # (DeviceChunkCodec.decode_chunk*, sharded_decompress_arrays) does.  The
    # max_len >= 1 projection of the budget is checkable and catches
    # egregious misuse:
    assert 1 <= k <= 32 * W, (
        f"syms_per_step={k} exceeds the refill budget even for 1-bit codes "
        f"(32*refill_words={32 * W}); derive it via syms_per_refill()"
    )
    assert k <= 32, "invalid syms_per_step"
    u32 = jnp.uint32

    # Pad the stream so row gathers stay in range: W-alignment + one spare
    # row beyond any clipped index.
    pad = (-words.shape[0]) % W + 2 * W
    words = jnp.concatenate([words, jnp.zeros(pad, u32)])
    nwords = words.shape[0]
    rows = words.reshape(-1, W) if W > 1 else None

    V = 2 if W == 1 else 2 * W + 1  # window registers (W=1 keeps the r1 shape)
    cap = 32 * V

    def append_word(regs, nb, w, valid):
        """OR word ``w`` into the window at per-lane bit offset ``nb`` where
        ``valid``; returns updated regs.  ``nb`` may be any value in
        [1, cap-32] when valid."""
        out = []
        for r in range(V):
            d = nb - 32 * r  # w's bits land at reg-local offset d
            hi_part = jnp.where(
                valid & (d >= 0) & (d < 32),
                w >> jnp.clip(d, 0, 31).astype(u32),
                u32(0),
            )
            lo_part = jnp.where(
                valid & (d > -32) & (d < 0),
                w << jnp.clip(-d, 0, 31).astype(u32),
                u32(0),
            )
            out.append(regs[r] | hi_part | lo_part)
        return out

    # Init: load two words, discard the bi leading bits.  The window's valid
    # bits then END at stream word boundary wi0+2, so refills can append
    # whole words at bit offset nb.
    pos0 = gaps.astype(jnp.int32)
    wi0 = pos0 >> 5
    bi = (pos0 & 31).astype(u32)
    bis = jnp.maximum(bi, u32(1))
    w0 = words[jnp.clip(wi0, 0, nwords - 1)]
    w1 = words[jnp.clip(wi0 + 1, 0, nwords - 1)]
    regs = [jnp.zeros_like(w0) for _ in range(V)]
    regs[0] = jnp.where(bi > 0, (w0 << bi) | (w1 >> (u32(32) - bis)), w0)
    regs[1] = jnp.where(bi > 0, w1 << bi, w1)
    nb = (64 - bi).astype(jnp.int32)    # valid bits, 33..64
    wi = wi0 + 2                        # next unread word
    def refill(regs, nb, wi):
        """Masked W-word row refill at bit offset ``nb`` (shared by the scan
        step and the W>1 pre-scan fill)."""
        need = nb <= cap - 32 * W
        if W == 1:
            w = words[jnp.clip(wi, 0, nwords - 1)]
            ofs = jnp.clip(nb, 0, 32).astype(u32)
            hi_add = jnp.where(ofs < 32, w >> ofs, u32(0))
            lo_add = jnp.where(
                ofs > 0, w << (u32(32) - jnp.maximum(ofs, u32(1))), u32(0)
            )
            regs = [
                jnp.where(need, regs[0] | hi_add, regs[0]),
                jnp.where(need, regs[1] | lo_add, regs[1]),
            ]
        else:
            row = rows[jnp.clip(wi // W, 0, nwords // W - 1)]  # (NL, W) gather
            for j in range(W):
                regs = append_word(regs, nb + 32 * j, row[:, j], need)
        nb = nb + jnp.where(need, 32 * W, 0)
        wi = wi + jnp.where(need, W, 0)
        return regs, nb, wi

    if W > 1:
        # masked single-word appends until wi is W-aligned (per-lane counts
        # differ; at most W-1 extra gathers, once per sub-block)
        for _ in range(W - 1):
            misaligned = (wi % W) != 0
            w = words[jnp.clip(wi, 0, nwords - 1)]
            regs = append_word(regs, nb, w, misaligned)
            nb = nb + jnp.where(misaligned, 32, 0)
            wi = wi + misaligned.astype(jnp.int32)
        # pre-scan fill: init leaves as few as 33 valid bits, but a wide
        # step consumes up to 32*W — one row refill establishes the
        # start-of-step invariant nb > 32*(W+1)
        regs, nb, wi = refill(regs, nb, wi)

    r16 = jnp.arange(table_bits, dtype=jnp.int32)
    symT = sym.reshape(16, 16).astype(jnp.bfloat16)  # canonical idx = 16h + l
    # Static compare width: boundaries past the chunk's (bucketed) max code
    # length are the 1<<16 sentinel and can never match a 16-bit window.
    limits_c = limits[:cmp_len]
    # The boundary mask is prefix-true (limits monotone in win), so BOTH the
    # length and the canonical-index offset fall out of one compare pass:
    # ln-1 = popcount(mask) and adj[ln-1] = adj[0] + Σ_j mask[j]·Δadj[j]
    # (Δ padded with 0 so saturated garbage lanes land on adj[cmp_len-1],
    # matching the previous one-hot's saturation semantics).
    adj0 = adj[0]
    adj_delta = jnp.concatenate(
        [adj[1:cmp_len] - adj[: cmp_len - 1], jnp.zeros(1, adj.dtype)]
    )

    def decode1(regs, nb):
        win = (regs[0] >> u32(32 - table_bits)).astype(jnp.int32)
        # canonical boundaries are monotone in win: length = 1 + #(boundaries
        # at or below win).  Saturates at cmp_len for invalid windows
        # (garbage lanes) — decode still makes progress, checksums catch it.
        mask = win[:, None] >= limits_c[None, :]
        ln = jnp.minimum(mask.sum(axis=1).astype(jnp.int32) + 1, cmp_len)
        adj_l = adj0 + jnp.where(mask, adj_delta[None, :], 0).sum(axis=1)
        idx = jnp.clip((win >> (table_bits - ln)) + adj_l, 0, 255)
        # 256-entry lookup as a 16x16 one-hot einsum (values < 256: bf16-exact,
        # one selected product per output; the scope name is the TF32
        # audit's allow-list key, tests/test_ops.py)
        ohh = ((idx >> 4)[:, None] == r16[None, :]).astype(jnp.bfloat16)
        ohw = ((idx & 15)[:, None] == r16[None, :]).astype(jnp.bfloat16)
        with jax.named_scope("symbol_lookup_dot"):
            s_val = jnp.einsum(
                "nh,hl,nl->n", ohh, symT, ohw, preferred_element_type=jnp.float32
            )
        s = ln.astype(u32)  # 1..16: shifts stay in range
        shifted = [
            (regs[r] << s) | (regs[r + 1] >> (u32(32) - s)) for r in range(V - 1)
        ] + [regs[V - 1] << s]
        return shifted, nb - ln, s_val.astype(jnp.uint8)

    def step(state, _):
        regs, nb, wi = state
        outs = []
        for _j in range(k):
            regs, nb, s_j = decode1(regs, nb)
            outs.append(s_j)
        regs, nb, wi = refill(regs, nb, wi)
        return (regs, nb, wi), tuple(outs)

    (regs, nb, wi), outs = jax.lax.scan(
        step, (regs, nb, wi), None, length=subblock // k
    )
    # (steps, NL) tuples → per-lane sequential symbol order
    syms = jnp.stack(outs, axis=1)               # (steps, k, NL)
    return syms.transpose(2, 0, 1).reshape(num_subblocks * subblock)


def payload_to_words(payload: bytes) -> np.ndarray:
    """Byte stream → uint32 words (big-endian bit order) + 2 zero pad words
    (the decoder's 64-bit window may read one word past the final bit)."""
    pad = (-len(payload)) % 4
    buf = bytes(payload) + b"\x00" * (pad + 8)
    return np.frombuffer(buf, dtype=">u4").astype(np.uint32)
