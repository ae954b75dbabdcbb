"""Sharded compress step: data parallelism over chunks via ``shard_map``.

The full device pipeline — histogram → on-device codebook → encode → global
offset assignment — compiled as ONE jitted program over a ``Mesh``:

* each device processes its shard of the chunk batch (vmapped single-chunk
  pipeline, no host round-trips inside the step);
* per-chunk compressed byte counts are ``all_gather``-ed over the mesh axis
  and turned into global file offsets with an exclusive cumsum — the
  multi-chip equivalent of the reference collecting futures in order and
  accumulating ``compressedOffset`` on one thread
  (``CpuCompressionService.java:137-151``); the collective rides the
  interconnect (NVLink between the cards of one host), the ordered file
  write stays on the host(s).

This is the design the reference could never express: its GPU worker pool is
1–2 chunks sized by VRAM heuristics (``GpuCompressionService.java:79-117``);
here the batch axis scales to however many devices the mesh has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.codebook import device_codebook
from ..ops.encode_merge import (
    encode_device_merge,
    encode_device_merge_batch_slotted,
)
from ..ops.histogram import histogram_device
from .mesh import BLOCKS_AXIS


def _chunk_pipeline(data, valid_len, out_words: int, subblock: int):
    """Single-chunk device pipeline: histogram → codebook → encode."""
    hist = histogram_device(data, valid_len)
    lengths, codes = device_codebook(hist)
    words, total_bits, gaps = encode_device_merge(
        data, valid_len, lengths, codes, out_words, subblock
    )
    return hist, lengths, codes, words, total_bits, gaps


def make_sharded_compress_step(
    mesh: Mesh, chunk_bytes: int, subblock: int = 4096, axis_name: str = BLOCKS_AXIS,
):
    """Build the jitted sharded compress step.

    Takes ``data (B, chunk_bytes) uint8`` and ``valid (B,) int32`` with B a
    multiple of the mesh size; returns per-chunk
    ``(hists, lengths, codes, words, total_bits, gaps, comp_bytes, offsets)``
    where ``offsets`` are the global compressed file offsets of each chunk.
    """
    out_words = (9 * chunk_bytes + 31) // 32 + 2

    def per_device(data, valid):
        # data: (b_local, chunk_bytes); vmap histogram+codebook, then encode
        # with runtime slot bucketing on this shard's max codebook depth
        hist, (lengths, codes) = jax.vmap(
            lambda d, v: ((h := histogram_device(d, v)), device_codebook(h))
        )(data, valid)
        words, total_bits, gaps = encode_device_merge_batch_slotted(
            data, valid, lengths, codes, out_words, subblock
        )
        comp_bytes = (total_bits + 7) // 8
        # global exclusive cumsum of compressed sizes over the mesh axis:
        # all_gather over the interconnect, then every device computes all
        # offsets
        all_sizes = jax.lax.all_gather(comp_bytes, axis_name, tiled=True)  # (B,)
        all_offsets = jnp.cumsum(all_sizes) - all_sizes
        my = jax.lax.axis_index(axis_name)
        b_local = comp_bytes.shape[0]
        offsets = jax.lax.dynamic_slice(all_offsets, (my * b_local,), (b_local,))
        return hist, lengths, codes, words, total_bits, gaps, comp_bytes, offsets

    spec = P(axis_name)
    step = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec,) * 8,
        check_vma=False,
    )
    return jax.jit(step)


def sharded_compress_arrays(mesh: Mesh, data_batch, valid_batch, subblock: int = 4096):
    """Convenience wrapper: run the sharded step on host arrays."""
    import numpy as np

    data_batch = np.asarray(data_batch, dtype=np.uint8)
    chunk_bytes = data_batch.shape[1]
    step = make_sharded_compress_step(mesh, chunk_bytes, subblock)
    valid = jnp.asarray(np.asarray(valid_batch, dtype=np.int32))
    return step(jnp.asarray(data_batch), valid)


def check_decompress_step_params(
    code_lengths_batch, subblock: int, syms_per_step: int, cmp_len: int,
    refill_words: int = 1,
) -> None:
    """Validate static decode parameters against every codebook in a batch.

    The sharded decompress step silently decodes garbage if ``cmp_len`` is
    below a chunk's max code length (the compare mask saturates) or
    ``syms_per_step`` exceeds what one 32-bit refill can sustain — so callers
    MUST run this host-side check (or compute the params from the same batch
    with ``max_code_len``/``syms_per_refill``/``cmp_len_bucket``) before
    dispatch.  Raises ValueError instead of corrupting output."""
    from ..ops.decode import max_code_len, syms_per_refill

    ml = max((max_code_len(lens) for lens in code_lengths_batch), default=0)
    if ml > 16:
        raise ValueError(
            f"batch contains a {ml}-bit codebook; device decode supports <= 16 "
            "bits (route deep-codebook chunks to the host decoder)"
        )
    if cmp_len < ml:
        raise ValueError(
            f"cmp_len={cmp_len} < deepest codebook in batch ({ml} bits); "
            "decode would silently corrupt output"
        )
    if subblock % syms_per_step:
        raise ValueError(f"syms_per_step={syms_per_step} must divide subblock={subblock}")
    if ml and syms_per_step > syms_per_refill(ml, subblock, refill_words):
        raise ValueError(
            f"syms_per_step={syms_per_step} exceeds the refill budget for "
            f"{ml}-bit codes (max {syms_per_refill(ml, subblock, refill_words)} "
            f"at refill_words={refill_words}); decode would under-refill and "
            "corrupt output"
        )


def make_sharded_decompress_step(
    mesh: Mesh,
    subblock: int,
    num_subblocks: int,
    syms_per_step: int,
    cmp_len: int = 16,
    axis_name: str = BLOCKS_AXIS,
    refill_words: int = 1,
):
    """Build the jitted sharded DECOMPRESS step: chunks shard over the mesh,
    each device vmaps the gap-array decoder (``ops/decode.py``) over its local
    batch.  No collectives are needed — decompress is pure data parallelism
    over chunks (output offsets are already recorded in the container), the
    axis the reference could only drive with a CPU thread pool
    (``CpuCompressionService.java:398-490``; it abandoned in-chunk GPU decode).

    Per-batch static ``syms_per_step``/``cmp_len`` must cover the deepest
    codebook in the batch (``syms_per_refill(max_len, subblock)`` /
    ``cmp_len_bucket(max_len)`` over all chunks) — validate with
    :func:`check_decompress_step_params` before dispatch, or use
    :func:`sharded_decompress_arrays` which does both.

    Takes per-chunk ``words (B, W+2) uint32``, ``gaps (B, num_subblocks)``,
    ``limits (B, 16)``, ``adj (B, 16)``, ``sym (B, 256)``; returns
    ``(B, num_subblocks * subblock) uint8`` (callers slice each row to the
    chunk's original size).
    """
    from ..ops.decode import decode_device

    def per_device(words, gaps, limits, adj, sym):
        return jax.vmap(
            lambda w, g, l, a, s: decode_device(
                w, g, l, a, s, subblock, num_subblocks,
                syms_per_step=syms_per_step, cmp_len=cmp_len,
                refill_words=refill_words,
            )
        )(words, gaps, limits, adj, sym)

    spec = P(axis_name)
    step = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec,) * 5,
        out_specs=spec,
        check_vma=False,
    )
    return jax.jit(step)


def sharded_decompress_arrays(
    mesh: Mesh, words_batch, gaps_batch, code_lengths_batch, subblock: int
):
    """Convenience wrapper: build tables, pick safe static decode params from
    the batch's deepest codebook, validate, and run the sharded decompress
    step on host arrays.  Returns ``(B, num_subblocks * subblock) uint8``
    (callers slice each row to the chunk's original size)."""
    import numpy as np

    from ..ops.decode import (
        DEFAULT_REFILL_WORDS,
        build_decode_tables,
        cmp_len_bucket,
        max_code_len,
        syms_per_refill,
    )

    code_lengths_batch = [np.asarray(lens) for lens in code_lengths_batch]
    ml = max((max_code_len(lens) for lens in code_lengths_batch), default=1)
    refill_words = DEFAULT_REFILL_WORDS
    syms_per_step = syms_per_refill(ml, subblock, refill_words)
    cmp_len = cmp_len_bucket(ml)
    check_decompress_step_params(
        code_lengths_batch, subblock, syms_per_step, cmp_len, refill_words
    )
    gaps_batch = np.asarray(gaps_batch, dtype=np.uint32)
    num_subblocks = gaps_batch.shape[1]
    tables = [build_decode_tables(lens) for lens in code_lengths_batch]
    step = make_sharded_decompress_step(
        mesh, subblock, num_subblocks, syms_per_step, cmp_len,
        refill_words=refill_words,
    )
    return step(
        jnp.asarray(np.asarray(words_batch, dtype=np.uint32)),
        jnp.asarray(gaps_batch),
        jnp.asarray(np.stack([t[0] for t in tables])),
        jnp.asarray(np.stack([t[1] for t in tables])),
        jnp.asarray(np.stack([t[2] for t in tables])),
    )
