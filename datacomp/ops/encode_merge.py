"""Production device encoder: gather-free bitstream tree-merge.

Answer to the reference's GPU encode strategies (prefix-sum + scatter
writer, ``TornadoKernels.writeCodewordsOptimizedKernel:361-398``, and
per-word binary-search gather, ``encodePacketKernel:115-205``) and to the
reduction-merge algebra of the paper bundled with the reference
(arXiv:2010.10039).  The formulation avoids per-element gathers (matmuls
instead) and limits the one unavoidable per-index op — the ownership
scatter, slots/32 ≈ 0.38 indices per byte at 10-bit codes — to far less
than the 1-per-byte a gather formulation would need.  The plain GPU form
(table gathers, ``jnp.cumsum``, scatter-add) is the A/B candidate on the
card.  The pieces:

* **table lookups as matmuls** — per-symbol (length, codeword) come from
  16×16 one-hot einsums over bit-split planes;
* **tree merge** — 5 pairwise levels pack each group of 32 symbols into a
  bit block of ``max_code_len`` words (32 worst-case; 8/16 under the
  static depth buckets the ownership scatter already uses — the bound
  shrinks every level's splice loop and buffer), arrays laid out
  (units, words, groups) so the huge groups axis is the minor dimension;
* **group offsets** — exclusive cumsum via in-row triangular matmul (exact
  in f32: row partials < 2²⁴) + tiny carry cumsum — a matmul does the
  prefix sum the reference ran serially on CPU
  (``GpuCompressionService.java:773-779``);
* **placement** — every full group holds ≥ 32 bits, so output words are
  *owned* by exactly one group; each group emits its ≤ 33 owned words
  (elementwise shifts from its own block + the next group's head word) and
  one unique scatter-set per word slot places them (dead slots dropped
  out-of-bounds).  No atomics, no read-modify-write, no binary search.

Bit/byte order matches the reference stream exactly (MSB-first, big-endian
words); validated bit-for-bit against the host encoder in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

GROUP = 32  # symbols per merged group == min bits per full (all-valid) group


def _mm_lookup(x: jnp.ndarray, tables: jnp.ndarray) -> jnp.ndarray:
    """Gather-free 256-entry table lookup via one-hot matmuls.

    ``x``: int32[N] byte values; ``tables``: f32[C, 256] with entries in
    [0, 256) (bf16/f32-exact).  Returns f32[N, C].
    """
    hi = x >> 4
    lo = x & 15
    r = jnp.arange(16, dtype=jnp.int32)
    ohh = (hi[:, None] == r).astype(jnp.bfloat16)  # (N,16)
    ohl = (lo[:, None] == r).astype(jnp.bfloat16)  # (N,16)
    t = tables.reshape(-1, 16, 16).astype(jnp.bfloat16)  # (C,16hi,16lo)
    # bf16 operands are exact here, unlike the cumsum below: one-hots are
    # 0/1 and plane values are < 256, both bf16-exact, and each output
    # element selects exactly one product (no lossy accumulation).
    # one fused 3-operand einsum per plane keeps intermediates register-sized
    # (the scope name is the TF32 audit's allow-list key, tests/test_ops.py)
    with jax.named_scope("table_lookup_dot"):
        outs = [
            jnp.einsum("nh,hl,nl->n", ohh, t[c], ohl,
                       preferred_element_type=jnp.float32)
            for c in range(t.shape[0])
        ]
    return jnp.stack(outs, axis=1)


def lookup_symbol_tables(
    x: jnp.ndarray, lengths: jnp.ndarray, codes: jnp.ndarray, code_bits: int = 0
):
    """Per-symbol (len int32[N], codeword uint32[N]) without gathers.

    ``code_bits`` (static): 0 — the production setting — splits the uint32
    codeword into four 8-bit planes plus a length plane (5 one-hot einsums,
    any codebook).  ``code_bits = 8``/``16`` packs ``len << code_bits | code``
    into one value spanning 2/3 planes (each 8-bit slice < 256 stays
    bf16/f32-exact).  Every production call site passes 0; the mechanism
    and its bit-exactness test remain for an A/B on the card.
    """
    codes = codes.astype(jnp.uint32)
    if code_bits:
        # packed = len << code_bits | code; len <= 16 and code < 2^code_bits
        # keep every 8-bit plane slice exact
        n_planes = (5 + code_bits + 7) // 8  # len needs <= 5 bits on top
        packed = (lengths.astype(jnp.uint32) << code_bits) | codes
        planes = jnp.stack(
            [((packed >> (8 * p)) & 0xFF).astype(jnp.float32)
             for p in range(n_planes)]
        )
        out = _mm_lookup(x, planes)  # (N, n_planes)
        v = out[:, 0].astype(jnp.uint32)
        for p in range(1, n_planes):
            v = v | (out[:, p].astype(jnp.uint32) << (8 * p))
        return (v >> code_bits).astype(jnp.int32), v & ((1 << code_bits) - 1)
    planes = jnp.stack(
        [
            lengths.astype(jnp.float32),
            (codes & 0xFF).astype(jnp.float32),
            ((codes >> 8) & 0xFF).astype(jnp.float32),
            ((codes >> 16) & 0xFF).astype(jnp.float32),
            ((codes >> 24) & 0xFF).astype(jnp.float32),
        ]
    )  # (5, 256)
    out = _mm_lookup(x, planes)  # (N, 5)
    lens = out[:, 0].astype(jnp.int32)
    cw = (
        out[:, 1].astype(jnp.uint32)
        | (out[:, 2].astype(jnp.uint32) << 8)
        | (out[:, 3].astype(jnp.uint32) << 16)
        | (out[:, 4].astype(jnp.uint32) << 24)
    )
    return lens, cw


def _merge_level(buf: jnp.ndarray, ulen: jnp.ndarray, unit_bits: int = 0):
    """Merge adjacent unit pairs.  ``buf``: (U, Q, NG) uint32 — unit u of
    group g occupies ``buf[u, :, g]``, bits left-aligned, zero-padded.
    ``ulen``: (U, NG) int32 bit lengths.

    ``unit_bits`` (static, 0 = unbounded ⇒ ``32·Q``) is a PROVEN upper
    bound on any input unit's bit length: a unit of k symbols under an
    m-bit-max codebook holds ≤ k·m bits, so B's word offset ``la >> 5`` is
    ≤ ``unit_bits/32``, its shifted stream spans ≤ ``Q+1`` live words, and
    the merged unit needs only ``ceil(2·unit_bits/32)`` words.  The bound
    shrinks the word-offset splice loop AND every level's materialized
    buffer — ~8× less splice traffic at m=8, ~4× at m=16.  Callers
    derive m from the same static ``max_slots`` bucket the ownership
    scatter uses, so the bound is exactly as trustworthy as the slot count.
    Returns ((U/2, Q2, NG), (U/2, NG)) with ``Q2 = ceil(2·unit_bits/32)``.
    """
    U, Q, NG = buf.shape
    mub = unit_bits or 32 * Q
    out_Q = min(2 * Q, (2 * mub + 31) // 32)
    wo_max = min(Q, mub // 32)  # B's word offset la>>5 <= unit_bits/32
    A = buf[0::2]
    B = buf[1::2]
    la = ulen[0::2]
    lb = ulen[1::2]

    s = (la & 31).astype(jnp.uint32)[:, None, :]
    wo = (la >> 5)[:, None, :]  # word offset of B, 0..wo_max
    z = jnp.zeros((U // 2, 1, NG), jnp.uint32)
    Wb = min(Q + 1, out_Q)  # live words of the shifted B stream
    Bprev = jnp.concatenate([z, B], axis=1)[:, :Wb]
    Bext = (
        B[:, :Wb]
        if Wb <= Q
        else jnp.concatenate([B, z], axis=1)[:, :Wb]
    )
    s_safe = jnp.maximum(s, jnp.uint32(1))
    SB = jnp.where(s > 0, (Bext >> s) | (Bprev << (jnp.uint32(32) - s_safe)), Bext)

    out = (
        A[:, :out_Q]
        if out_Q <= Q
        else jnp.concatenate(
            [A, jnp.zeros((U // 2, out_Q - Q, NG), jnp.uint32)], axis=1
        )
    )
    for w in range(wo_max + 1):  # static loop over possible word offsets
        width = min(Wb, out_Q - w)
        if width <= 0:
            continue
        seg = SB[:, :width, :]
        if wo_max > 0:  # single-offset levels (wo provably 0) skip the mask
            seg = jnp.where(wo == w, seg, jnp.uint32(0))
        out = out.at[:, w : w + width, :].set(out[:, w : w + width, :] | seg)
    return out, la + lb


def _exclusive_cumsum_2level(x: jnp.ndarray, row: int = 128):
    """Exclusive cumsum of int32 (n,) via in-row triangular matmul (exact:
    row partials < 2^24) + small carry cumsum.  Compile cost is flat in n."""
    n = x.shape[0]
    pad = (-n) % row
    if pad:
        x = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
    r = x.reshape((n + pad) // row, row)
    tri = jnp.asarray(np.triu(np.ones((row, row), np.float32), 1))  # k < j
    # precision=HIGHEST is load-bearing: default matmul precision may run
    # f32 operands as TF32 (10-bit mantissa) on a GPU or bf16 elsewhere,
    # silently rounding row values > 2^11 — group bit-lengths reach 1024 and
    # row partials 2^17
    intra = jax.lax.dot_general(
        r.astype(jnp.float32), tri,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)
    row_tot = r.sum(axis=1, dtype=jnp.int32)
    carry = jnp.cumsum(row_tot) - row_tot
    return (intra + carry[:, None]).reshape(n + pad)[:n]


def code_bits_bucket(max_len: int) -> int:
    """Static plane-packing width for :func:`encode_device_merge`'s lookup:
    8 (2 one-hot planes) for codebooks ≤ 8 bits, 16 (3 planes) for ≤ 16,
    0 (the 5-plane any-codebook split) otherwise.  Production passes 0 —
    this helper exists for an A/B of the packed lookup."""
    if max_len <= 8:
        return 8
    if max_len <= 16:
        return 16
    return 0


@functools.partial(
    jax.jit,
    static_argnames=("out_words", "subblock", "max_slots", "code_bits",
                     "fused_scatter", "merge_bound", "window_scatter"),
)
def encode_device_merge(
    data: jnp.ndarray,       # uint8[N], N % 32 == 0 (padded chunk)
    valid_len: jnp.ndarray,  # int32 scalar
    lengths: jnp.ndarray,    # int32[256]
    codes: jnp.ndarray,      # uint32[256]
    out_words: int,
    subblock: int = 0,       # if >0 (multiple of 32): also return gap bits
    max_slots: int = GROUP + 1,  # owned words per group ≤ max_code_len + 2
    code_bits: int = 0,      # static: code_bits_bucket(maxlen) for host tables
    fused_scatter: bool = False,  # ONE scatter over all slots vs one per slot
    merge_bound: int = 0,    # A/B override of the merge depth bound (0 =
                             # derive from max_slots — every production call)
    window_scatter: bool = False,  # ONE windowed scatter-ADD: one index per
                                   # GROUP, contiguous max_slots-word updates
):
    """Returns (words uint32[out_words], total_bits int32[, gaps]).

    ``max_slots`` bounds the owned-word scatter loop: a group of 32 symbols
    spans at most ``32·maxlen`` bits ⇒ ≤ ``maxlen + 1`` owned words (+1 for
    alignment).  Callers that build the codebook host-side pass
    ``min(33, maxlen + 2)`` to skip provably-empty scatter slots.
    ``code_bits`` stays 0 in production (see :func:`lookup_symbol_tables`).
    ``fused_scatter`` concatenates every slot's (index, value) pair into ONE
    unique-set scatter instead of ``max_slots`` chained ones — word
    ownership already makes ALL live indices globally unique, and per-slot
    sentinel ranges keep the dead ones unique too; bit-identical output
    either way.  ``window_scatter`` is one windowed scatter-ADD.  Both are
    tested A/B mechanisms; production always passes False.
    """
    n = data.shape[0]
    assert n % GROUP == 0, "padded chunk size must be a multiple of 32"
    ng = n // GROUP
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < valid_len
    x = jnp.where(valid, data.astype(jnp.int32), 0)
    lens, cws = lookup_symbol_tables(x, lengths, codes, code_bits)
    lens = jnp.where(valid, lens, 0)
    cws = jnp.where(valid, cws, jnp.uint32(0))

    # leaf pack, laid out (symbol-in-group, group): lane dim = groups
    shift = (jnp.uint32(32) - jnp.minimum(lens, 32).astype(jnp.uint32)) & jnp.uint32(31)
    leaf = jnp.where(lens > 0, cws << shift, jnp.uint32(0))
    buf = leaf.reshape(ng, GROUP).T.reshape(GROUP, 1, ng)
    ulen = lens.reshape(ng, GROUP).T

    # static code-depth bound from the SAME bucket that sizes the ownership
    # scatter (max_slots = maxlen + 2): bounds every merge level's splice
    # loop and buffer width (see _merge_level).  max_slots >= 33 means
    # "unbounded" (codes may reach 32 bits).
    m_bound = merge_bound or (
        32 if max_slots >= GROUP + 1 else max(1, max_slots - 2)
    )
    mub = m_bound  # max bits per unit: 1 symbol <= m_bound bits
    for _ in range(5):  # 1 → 32 symbols per unit
        buf, ulen = _merge_level(buf, ulen, mub)
        mub *= 2
    gwords = buf[0]          # (ceil(32·m/32) = m_bound, ng): group bit blocks
    glen = ulen[0]           # (ng,)

    gs = _exclusive_cumsum_2level(glen)          # group start bits
    total_bits = gs[-1] + glen[-1]

    # ownership: group g owns output words [v_g, v_{g+1})
    v = (gs + 31) >> 5                           # ceil(gs/32)
    v_next = (gs + glen + 31) >> 5
    d = ((v << 5) - gs).astype(jnp.uint32)       # 0..31: group bits preceding
    d_safe = jnp.maximum(d, jnp.uint32(1))       # word v start within group
    count = v_next - v                           # owned words, 0..33

    # pad the (bounded) group blocks so every slot's gpad[j] / gpad[j+1]
    # access lands on a real (zero) row: slots run to min(GROUP+1, max_slots)
    nslots = min(GROUP + 1, max_slots)
    pad_rows = max(nslots + 1 - gwords.shape[0], 1)
    gpad = jnp.concatenate(
        [gwords, jnp.zeros((pad_rows, ng), jnp.uint32)], axis=0
    )
    g_hi = gpad.shape[0] - 1  # clamp index for the j+1 access
    h_next = jnp.concatenate([gwords[0, 1:], jnp.zeros(1, jnp.uint32)])       # next group's head

    out = jnp.zeros(out_words, jnp.uint32)
    # Dead-slot scatter sentinels must sit beyond ANY reachable live index,
    # not just beyond out_words: if total_bits overflows out_words*32 (only
    # caught host-side after the fact), live targets v+j can exceed
    # out_words and would collide with sentinels placed at out_words+g,
    # voiding the unique_indices contract mid-overflow.  Code lengths are
    # <= 32 bits, so glen <= 1024 per group and v_next <= 32*ng + 1 — every
    # live index is < 32*ng + 1 regardless of overflow.
    oob_base = jnp.int32(max(out_words, 32 * ng + 1))
    assert not (fused_scatter and window_scatter)
    fused_tgts = []
    fused_vals = []
    window_vals = []
    for j in range(min(GROUP + 1, max_slots)):  # static loop over owned-word slots
        val = jnp.where(
            d > 0,
            (gpad[j] << d) | (gpad[min(j + 1, g_hi)] >> (jnp.uint32(32) - d_safe)),
            gpad[j],
        )
        # boundary word: splice in the next group's first bits
        rel = glen.astype(jnp.int32) - (jnp.int32(32) * j) - d.astype(jnp.int32)
        rel_u = jnp.clip(rel, 1, 31).astype(jnp.uint32)
        val = val | jnp.where((rel > 0) & (rel < 32), h_next >> rel_u, jnp.uint32(0))
        # unique-SET scatter with dead slots dropped out-of-bounds: word
        # ownership is disjoint, and each dead slot gets its own OOB index
        # (oob_base + group, past every reachable live index — see above)
        # so the unique_indices contract holds for EVERY index, not just
        # the surviving ones — XLA leaves duplicate indices under
        # unique_indices implementation-defined even when they are
        # dropped.
        # indices_are_sorted stays OFF: the OOB sentinels break
        # monotonicity and a sorted claim DROPS real writes (observed as a
        # bit-exactness failure).
        if fused_scatter:
            # per-slot sentinel range oob_base + j*ng keeps dead indices
            # unique ACROSS slots; live indices are unique across slots by
            # word ownership (group g's slots cover [v_g, v_{g+1}) disjointly)
            tgt = jnp.where(
                j < count,
                v + j,
                oob_base + jnp.int32(j * ng) + jnp.arange(ng, dtype=jnp.int32),
            )
            fused_tgts.append(tgt)
            fused_vals.append(val)
        elif window_scatter:
            # dead slots masked to ZERO (not routed OOB): under scatter-ADD a
            # zero contribution is exact, and group g's live slots never
            # reach a word owned by another group (slot j is live iff
            # j < count = v_{g+1} - v_g, i.e. word v_g + j < v_{g+1})
            window_vals.append(jnp.where(j < count, val, jnp.uint32(0)))
        else:
            tgt = jnp.where(
                j < count, v + j, oob_base + jnp.arange(ng, dtype=jnp.int32)
            )
            out = out.at[tgt].set(val, mode="drop", unique_indices=True)
    if fused_scatter:
        out = out.at[jnp.concatenate(fused_tgts)].set(
            jnp.concatenate(fused_vals), mode="drop", unique_indices=True
        )
    if window_scatter:
        # ONE windowed scatter-ADD: ng sorted row indices (group start
        # words), each update a CONTIGUOUS nslots-word window — 1/nslots-th
        # the scatter indices of the chained form, vectorizable window
        # writes, and the indices really are sorted (group starts are
        # monotone), so the sorted hint is legal here — unlike the
        # OOB-sentinel forms, where it provably drops writes.  Overlapping
        # windows are exact by the dead-slot zero masking above.  The
        # operand is padded by nslots words so end-of-stream windows stay
        # in bounds (overflowing streams may drop windows via FILL_OR_DROP;
        # the host-side capacity guard raises on those chunks anyway).
        dnums = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,),
            inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0,),
        )
        padded_out = jax.lax.scatter_add(
            jnp.zeros(out_words + nslots, jnp.uint32),
            v[:, None],
            jnp.stack(window_vals, axis=1),  # (ng, nslots)
            dnums,
            indices_are_sorted=True,
            unique_indices=False,
            mode=jax.lax.GatherScatterMode.FILL_OR_DROP,
        )
        out = padded_out[:out_words]

    if subblock:
        assert subblock % GROUP == 0, "subblock must be a multiple of 32 symbols"
        gaps = gs[:: subblock // GROUP].astype(jnp.uint32)
        return out, total_bits, gaps
    return out, total_bits


#: static scatter-slot buckets (= max code length + 2, see
#: ``encode_device_merge``): the ownership scatter is LINEAR in the slot
#: count, so 2-slot granularity caps the waste at ~2 scatter waves.  Each
#: bucket is one executable (compiled once, kept by the persistent XLA
#: cache).
SLOT_BUCKETS = (10, 12, 14, 16, 18, 33)


def slot_bucket(max_len: int) -> int:
    """Static scatter-slot bucket for a HOST-known max code length.  33
    slots suffice even for 32-bit codes (a 32-symbol group owns at most
    ``maxlen + 1`` words), hence the clamp — the old 3-bucket expression
    raised StopIteration at ``max_len == 32``."""
    return next(b for b in SLOT_BUCKETS if b >= min(max_len, 31) + 2)


def _slot_case(lengths) -> jnp.ndarray:
    """Bucket index into :data:`SLOT_BUCKETS` for a TRACED max code length
    (mirrors :func:`slot_bucket`'s static bucketing)."""
    ml = jnp.max(lengths)
    out = jnp.int32(0)
    for b in SLOT_BUCKETS[:-1]:
        out = out + (ml + 2 > b).astype(jnp.int32)
    return out


def encode_device_merge_slotted(data, valid_len, lengths, codes,
                                out_words: int, subblock: int = 0):
    """:func:`encode_device_merge` with RUNTIME slot bucketing for callers
    whose codebook depth is a traced value (it was computed on device, so
    the static ``max_slots`` bucketing the host-table paths use is
    unavailable — and the full 33-slot ownership scatter is a full-depth
    scatter on typical data).  ``lax.switch`` compiles every :data:`SLOT_BUCKETS` branch
    into the executable and runs exactly ONE at runtime."""
    def enc(slots):
        def branch(_):
            return encode_device_merge(
                data, valid_len, lengths, codes, out_words, subblock,
                max_slots=slots,
            )
        return branch

    return jax.lax.switch(
        _slot_case(lengths), [enc(b) for b in SLOT_BUCKETS], None
    )


def encode_device_merge_batch_slotted(data, valid, lengths, codes,
                                      out_words: int, subblock: int = 0):
    """Vmapped :func:`encode_device_merge` over a chunk batch, with runtime
    slot bucketing on the BATCH-max codebook depth.  The switch predicate
    must be a scalar computed OUTSIDE the vmap — a vmapped switch has a
    batched predicate and XLA then executes every branch.  One shared
    implementation for the batched service pipeline, the sharded mesh step
    and the device-side bench, so the bucket thresholds cannot diverge."""
    def enc(slots):
        def branch(_):
            return jax.vmap(
                lambda d, v, l, c: encode_device_merge(
                    d, v, l, c, out_words, subblock, max_slots=slots
                )
            )(data, valid, lengths, codes)
        return branch

    return jax.lax.switch(
        _slot_case(lengths), [enc(b) for b in SLOT_BUCKETS], None
    )


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize device words (uint32, MSB-first bit order) to the byte
    stream, truncated to the exact encoded length."""
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()[:nbytes]
