"""On-device canonical Huffman codebook construction.

The reference always builds trees on the CPU (3 ms per chunk,
``CanonicalHuffman.java:55-92``); this framework keeps a host builder for the
bit-exact parity mode (:mod:`datacomp.core.huffman`) but also provides a
fully on-device builder so the whole compress step — histogram → codebook →
encode — runs inside a single jit/shard_map with no host round-trip per chunk
(essential once chunks are sharded across many chips: a host hop per chunk
would serialize the mesh).

Algorithm: sort the 256 frequencies (XLA sort), then the classic two-queue
Huffman merge — leaves are consumed in sorted order and merged nodes are
produced in nondecreasing order, so both "queues" are arrays walked by
pointers inside a ``fori_loop`` (255 fixed iterations, masked past the real
symbol count).  Depths come from 9 rounds of parent-pointer doubling.  The
resulting lengths are optimal (same total bits as the reference) though
tie-breaks differ from Java's PriorityQueue; files remain fully readable by
the reference decoder since canonical codes derive from lengths alone.
Canonical code assignment mirrors ``CanonicalHuffman.java:99-132``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NLEAF = 256
_NINTERN = _NLEAF - 1
_NNODE = _NLEAF + _NINTERN  # leaf slot k → node id k; internal m → 256+m
# Frequencies are chunk byte counts (≤ 2^26 for 64 MB chunks), so int32 with
# a 2^30 sentinel is safe; x64 is disabled under default JAX config.
_INF = 1 << 30
MAX_LEN = 32


@jax.jit
def device_code_lengths(hist: jnp.ndarray) -> jnp.ndarray:
    """int32[256] canonical code lengths from an int32/int64[256] histogram."""
    freqs = hist.astype(jnp.int32)
    present = freqs > 0
    nsym = jnp.sum(present.astype(jnp.int32))

    # sort leaves by (freq, symbol); absent symbols pushed to the end
    keys = jnp.where(present, freqs, _INF)
    leaf_freq_sorted, leaf_sym_sorted = jax.lax.sort_key_val(
        keys, jnp.arange(_NLEAF, dtype=jnp.int32)
    )

    def pick(li, ii, ni, intern_freq):
        lf = jnp.where(li < _NLEAF, leaf_freq_sorted[jnp.clip(li, 0, _NLEAF - 1)], _INF)
        itf = jnp.where(ii < ni, intern_freq[jnp.clip(ii, 0, _NINTERN - 1)], _INF)
        take_leaf = lf <= itf
        node_id = jnp.where(take_leaf, li, _NLEAF + ii)
        freq = jnp.where(take_leaf, lf, itf)
        li = li + take_leaf.astype(jnp.int32)
        ii = ii + (1 - take_leaf.astype(jnp.int32))
        return node_id, freq, li, ii

    def merge_step(t, state):
        li, ii, ni, intern_freq, parent = state
        id1, f1, li, ii = pick(li, ii, ni, intern_freq)
        id2, f2, li2, ii2 = pick(li, ii, ni, intern_freq)
        active = t < nsym - 1  # only nsym−1 real merges
        new_id = _NLEAF + ni
        parent = jnp.where(
            active, parent.at[id1].set(new_id).at[id2].set(new_id), parent
        )
        intern_freq = jnp.where(active, intern_freq.at[ni].set(f1 + f2), intern_freq)
        li = jnp.where(active, li2, state[0])
        ii = jnp.where(active, ii2, state[1])
        ni = jnp.where(active, ni + 1, state[2])
        return li, ii, ni, intern_freq, parent

    parent0 = jnp.full(_NNODE, -1, dtype=jnp.int32)
    intern0 = jnp.full(_NINTERN, _INF, dtype=jnp.int32)
    _, _, _, _, parent = jax.lax.fori_loop(
        0, _NINTERN, merge_step,
        (jnp.int32(0), jnp.int32(0), jnp.int32(0), intern0, parent0),
    )

    # depth via parent-pointer doubling: d[v] += d[p[v]]; p[v] = p[p[v]]
    depth = jnp.where(parent >= 0, jnp.int32(1), jnp.int32(0))
    ptr = jnp.where(parent >= 0, parent, jnp.arange(_NNODE, dtype=jnp.int32))
    for _ in range(9):  # 2^9 = 512 ≥ max chain length
        depth = depth + depth[ptr]
        ptr = ptr[ptr]

    # leaf slot k (sorted order) holds symbol leaf_sym_sorted[k]
    slot_len = jnp.where(
        jnp.arange(_NLEAF, dtype=jnp.int32) < nsym, depth[:_NLEAF], 0
    )
    lengths = jnp.zeros(_NLEAF, dtype=jnp.int32).at[leaf_sym_sorted].set(slot_len)
    # edge case: a single distinct symbol gets a 1-bit code
    # (reference parity: CanonicalHuffman.java:35-45)
    lengths = jnp.where(nsym == 1, present.astype(jnp.int32), lengths)
    return lengths


@jax.jit
def device_canonical_codes(lengths: jnp.ndarray) -> jnp.ndarray:
    """uint32[256] canonical codewords from int32[256] lengths, same
    assignment rule as the host builder (shorter codes numerically smaller,
    same-length codes consecutive in symbol order)."""
    lengths = lengths.astype(jnp.int32)
    ln_range = jnp.arange(MAX_LEN + 1, dtype=jnp.int32)
    counts = jnp.sum(
        (lengths[None, :] == ln_range[:, None]) & (lengths[None, :] > 0), axis=1
    ).astype(jnp.int32)  # counts[l] for l in 0..32

    def first_step(l, carry):
        code, first = carry
        code = (code + counts[l - 1]) << 1
        return code, first.at[l].set(code)

    _, first = jax.lax.fori_loop(
        1, MAX_LEN + 1, first_step,
        (jnp.int32(0), jnp.zeros(MAX_LEN + 1, dtype=jnp.int32)),
    )
    # rank of symbol s within its length class (symbol-ascending)
    sym = jnp.arange(_NLEAF, dtype=jnp.int32)
    same_len_before = jnp.sum(
        (lengths[None, :] == lengths[:, None])
        & (sym[None, :] < sym[:, None])
        & (lengths[None, :] > 0),
        axis=1,
    ).astype(jnp.int32)
    codes = jnp.where(
        lengths > 0, first[jnp.clip(lengths, 0, MAX_LEN)] + same_len_before, 0
    )
    return codes.astype(jnp.uint32)


@jax.jit
def device_codebook(hist: jnp.ndarray):
    lengths = device_code_lengths(hist)
    return lengths, device_canonical_codes(lengths)
