"""Multi-host orchestration: compress a file across the GPUs of several hosts.

Scaling design (the axis the reference never had — it is a single-JVM,
single-GPU system): chunks are data-parallel across *all* chips of *all*
hosts.  Each host:

1. reads its own chunk stripe (round-robin by global chunk index — every host
   can see the input via shared filesystem, or its local shard);
2. runs the sharded device pipeline over its local chips
   (:func:`datacomp.parallel.sharded.make_sharded_compress_step`);
3. participates in the global ``all_gather`` of per-chunk compressed sizes —
   the offset assignment is an exclusive scan over all chunks of all hosts,
   computed identically everywhere (one collective, no coordinator);
4. ``pwrite``s its chunks' payloads at their global offsets into the shared
   output file; host 0 alone appends the footer + pointer.

Initialization uses ``jax.distributed`` (controller-less, env-driven).  On a
single host this degrades to the plain sharded step.  The offset/assignment
arithmetic is pure and unit-tested without real multi-host hardware.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core import container as ct
from ..utils.checksum import sha256_digest


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  No-op if
    already initialized or if running single-process."""
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclass(frozen=True)
class ChunkAssignment:
    """Which global chunk indices a host owns (round-robin striping keeps
    per-host loads balanced even when trailing chunks are small)."""

    host_id: int
    num_hosts: int
    num_chunks: int

    def local_chunks(self) -> List[int]:
        return list(range(self.host_id, self.num_chunks, self.num_hosts))

    @staticmethod
    def owner_of(chunk_index: int, num_hosts: int) -> int:
        return chunk_index % num_hosts


def global_offsets(sizes_by_chunk: Sequence[int]) -> np.ndarray:
    """Exclusive scan of compressed sizes in global chunk order — identical
    on every host given the all-gathered size vector."""
    sizes = np.asarray(sizes_by_chunk, dtype=np.int64)
    return np.cumsum(sizes) - sizes


def interleave_gathered(per_host_sizes: Sequence[Sequence[int]], num_chunks: int) -> np.ndarray:
    """Reassemble the global size vector from per-host stripes: host h's k-th
    local chunk is global chunk ``h + k*num_hosts``."""
    num_hosts = len(per_host_sizes)
    out = np.zeros(num_chunks, dtype=np.int64)
    for h, sizes in enumerate(per_host_sizes):
        idx = np.arange(h, num_chunks, num_hosts)
        out[idx] = np.asarray(sizes[: len(idx)], dtype=np.int64)
    return out


def write_host_payloads(
    output_path: str, payloads: Sequence[bytes], chunk_indices: Sequence[int],
    offsets: np.ndarray,
) -> None:
    """Positional writes of this host's chunk payloads at global offsets
    (every host writes disjoint ranges of the shared file)."""
    fd = os.open(output_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        for payload, ci in zip(payloads, chunk_indices):
            os.pwrite(fd, payload, int(offsets[ci]))
    finally:
        os.close(fd)


def spill_to_output(
    output_path: str, spill_path: str, chunk_indices: Sequence[int],
    local_sizes: Sequence[int], offsets: np.ndarray,
) -> None:
    """Copy this host's spilled payloads (written sequentially in local-chunk
    order during encode) to their global offsets in the shared output file,
    one bounded chunk-sized buffer at a time — the memory-discipline
    counterpart of :func:`write_host_payloads`: global offsets only exist
    after the cross-process size all-gather, so payloads spill to a per-host
    temp file during encode instead of accumulating in RAM (a 15 GB input on
    2 hosts would otherwise hold ~5 GB of compressed payload per host)."""
    fd = os.open(output_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        with open(spill_path, "rb") as sp:
            for k, ci in enumerate(chunk_indices):
                payload = sp.read(int(local_sizes[k]))
                if len(payload) != int(local_sizes[k]):
                    raise IOError(f"short read in payload spill for chunk {ci}")
                os.pwrite(fd, payload, int(offsets[ci]))
    finally:
        os.close(fd)


def write_footer_host0(
    output_path: str, header: ct.ContainerHeader, total_payload: int
) -> None:
    """Host 0 appends footer + pointer after all hosts' payload writes (a
    barrier between payload writes and this call is the caller's job)."""
    with open(output_path, "r+b") as f:
        f.seek(total_payload)
        f.write(ct.serialize_footer(header))
        f.write(struct.pack(">q", total_payload))
        f.truncate()


def assemble_header(
    input_name: str, file_size: int, mtime_ms: int, chunk_size: int,
    metas_by_index: Sequence[ct.ChunkMeta], version: int = ct.VERSION_V1,
    subblock: int = 0,
) -> ct.ContainerHeader:
    """Build the final header from per-chunk metadata in global order and
    derive the global checksum (sha256 over chunk digests in order)."""
    g = sha256_digest()
    for m in metas_by_index:
        g.update(m.sha256)
    h = ct.ContainerHeader(
        original_file_name=input_name,
        original_file_size=file_size,
        original_timestamp=mtime_ms,
        global_sha256=g.digest(),
        chunk_size_bytes=chunk_size,
        version=version,
        subblock_symbols=subblock,
    )
    h.chunks = list(metas_by_index)
    return h


def _shard_rows(mesh, *arrays):
    """Place each host array's rows straight onto their mesh devices (one
    row block per device along the mesh axis)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.device_put(arrays, sharding)


def _encode_group_mesh(step, codec, cfg, datas, metrics, mesh):
    """Encode up to ``mesh.size`` chunks in ONE sharded device program.

    The host pre-pass (SHA-256, host histogram, raw-store routing) runs per
    chunk exactly as the single-chip service's does
    (``DeviceChunkCodec._host_prepass``), so routing — and therefore output
    bits — are identical to the single-host service; only compressible
    chunks enter the mesh step.  Unused device slots are padded with
    ``valid_len = 0`` chunks (a zero slot encodes to 0 bits).
    """
    import jax

    from ..models import Stage
    from ..ops import words_to_bytes
    from ..services.pipeline import EncodedChunk

    mesh_size = mesh.size
    chunk_size = cfg.chunk_size_bytes
    subblock = cfg.compression.subblock_symbols
    out_words = (9 * chunk_size + 31) // 32 + 2  # make_sharded_compress_step's capacity
    results: List[Optional[EncodedChunk]] = [None] * len(datas)
    live = []
    for i, d in enumerate(datas):
        sha, _lens, _codes, _opt, finished = codec._host_prepass(d, metrics)
        if finished is not None:
            results[i] = finished
        else:
            live.append((i, d, d.size, sha))
    if not live:
        return results

    batch = np.zeros((mesh_size, chunk_size), np.uint8)
    valid = np.zeros(mesh_size, np.int32)
    for j, (_i, d, n, _sha) in enumerate(live):
        batch[j, :n] = d
        valid[j] = n
    total_n = int(valid.sum())
    with metrics.timed(Stage.ENCODING, total_n):
        (_hists, lengths, _codes, words, total_bits, gaps, _cb, _off) = step(
            *_shard_rows(mesh, batch, valid)
        )
        # ONE small round trip for every chunk's control metadata, then one
        # live-prefix fetch per chunk (the padded tail is up to 9x payload)
        tbs, lens_all, gaps_all = (
            np.asarray(a) for a in jax.device_get((total_bits, lengths, gaps))
        )
        for j, (i, d, n, sha) in enumerate(live):
            tb = int(tbs[j])
            if tb >= n * 8:
                # device-side raw-store safety net, same as the single-chip
                # fused path (host pre-pass normally decides pre-upload)
                results[i] = EncodedChunk(
                    d.tobytes(), np.zeros(256, np.int32), sha, None
                )
                continue
            if tb > out_words * 32:
                raise RuntimeError("encoded stream exceeded device word capacity")
            nw = (tb + 31) // 32
            payload = words_to_bytes(np.asarray(words[j, :nw]), tb)
            nsub = (n + subblock - 1) // subblock
            results[i] = EncodedChunk(
                payload, lens_all[j].astype(np.int32), sha,
                gaps_all[j, :nsub].astype(np.uint32),
            )
    return results


def compress_multihost(
    input_path: str, output_path: str, config=None, backend: str = "cpu",
    mesh=None, progress=None, metrics=None,
) -> None:
    """End-to-end multi-host AND multi-chip compress: every participating
    process encodes its round-robin chunk stripe, per-chunk metadata is
    all-gathered across processes, offsets are derived identically
    everywhere, each host pwrites its payloads at their global offsets, and
    process 0 appends the footer.

    Within each process, the stripe itself is data-parallel over the local
    devices: with ``backend="gpu"``, a ``mesh`` (e.g. ``make_mesh()`` over
    ``jax.local_devices()``) and the device-codebook v2 config, groups of
    ``mesh.size`` chunks run through ONE sharded device program
    (:func:`datacomp.parallel.sharded.make_sharded_compress_step`:
    histogram → on-device codebook → encode, sharded over the mesh axis) —
    output bits identical to the single-host device service's.  Without a mesh
    (or for host-codebook / v1 configs, which the mesh step does not
    compile), the stripe runs through ``codec.encode_chunk_batch`` in
    ``codec.batch_chunks`` groups — the dispatch-amortized single-device
    path.  ``backend="cpu"`` uses the native host codec.

    Requires ``jax.distributed`` to be initialized when running with more
    than one process (see :func:`initialize_distributed`); single-process it
    produces output byte-identical to the ChunkedPipeline's.  The input must
    be visible to every process (shared filesystem).

    Memory is bounded like the single-host pipeline's (round 5): encoded
    payloads spill to a per-host temp file as they are produced and are
    positionally copied to the shared output once the all-gathered offsets
    exist — per-host RSS stays O(group × chunk), not O(stripe).
    ``progress`` (0..1 over this host's local stripe) and ``metrics``
    (:class:`StageMetrics`) mirror the single-host service surface; stage
    attribution matches the single-host fused path exactly — SHA-256 /
    host-histogram in the pre-pass stages, the fused device program
    (histogram → codebook → encode, one executable) under ENCODING.
    """
    import jax
    from jax.experimental import multihost_utils

    from ..config import load_config
    from ..models import StageMetrics
    from ..services.cpu_service import CpuChunkCodec

    cfg = config or load_config()
    host = jax.process_index()
    num_hosts = jax.process_count()
    chunk_size = cfg.chunk_size_bytes
    version = cfg.compression.format_version
    subblock = cfg.compression.subblock_symbols if version >= ct.VERSION_V2 else 0
    file_size = os.path.getsize(input_path)
    num_chunks = (file_size + chunk_size - 1) // chunk_size
    G = (chunk_size + subblock - 1) // subblock if subblock else 0

    assign = ChunkAssignment(host, num_hosts, num_chunks)
    local = assign.local_chunks()
    L = (num_chunks + num_hosts - 1) // num_hosts  # padded stripe length

    if backend == "gpu":
        from ..services.device_service import DeviceChunkCodec

        codec = DeviceChunkCodec(cfg)
    else:
        codec = CpuChunkCodec(cfg)
    use_mesh = (
        backend == "gpu"
        and mesh is not None
        and mesh.size > 1
        and cfg.compression.codebook_mode == "device"
        and version >= ct.VERSION_V2
    )
    step = None
    if use_mesh:
        from .sharded import make_sharded_compress_step

        step = make_sharded_compress_step(mesh, chunk_size, subblock)
        group = mesh.size
    else:
        group = max(1, getattr(codec, "batch_chunks", 1))

    from ..models import Stage

    metrics = metrics if metrics is not None else StageMetrics()
    # Per-host payload spill: sequential append in local-chunk order during
    # encode, positional copy to global offsets after the all-gather (RSS
    # stays O(group × chunk), matching the single-host pipeline's bounded
    # sliding window)
    spill_path = f"{output_path}.spill{host}"
    sizes = np.zeros(L, np.int64)
    osz = np.zeros(L, np.int64)
    shas = np.zeros((L, 32), np.uint8)
    lens = np.zeros((L, 256), np.int32)
    ngaps = np.zeros(L, np.int32)
    gaps = np.zeros((L, max(G, 1)), np.uint32)
    with open(input_path, "rb") as f, open(spill_path, "wb") as spill:
        for g0 in range(0, len(local), group):
            gidx = local[g0 : g0 + group]
            datas = []
            for ci in gidx:
                off = ci * chunk_size
                n = min(chunk_size, file_size - off)
                with metrics.timed(Stage.FILE_IO, n):
                    f.seek(off)
                    datas.append(np.frombuffer(f.read(n), dtype=np.uint8))
            if use_mesh:
                encs = _encode_group_mesh(step, codec, cfg, datas, metrics, mesh)
            else:
                encs = codec.encode_chunk_batch(datas, metrics)
            for k, enc in zip(range(g0, g0 + len(gidx)), encs):
                with metrics.timed(Stage.FILE_IO, len(enc.payload)):
                    spill.write(enc.payload)
                sizes[k] = len(enc.payload)
                osz[k] = datas[k - g0].size
                shas[k] = np.frombuffer(enc.sha256, np.uint8)
                lens[k] = enc.code_lengths
                if enc.gap_bits is not None:
                    ngaps[k] = enc.gap_bits.size
                    gaps[k, : enc.gap_bits.size] = enc.gap_bits
            if progress is not None:
                progress(min(g0 + len(gidx), len(local)) / max(len(local), 1))

    # all-gather per-chunk metadata across processes (leading axis = host)
    if num_hosts > 1:
        g_sizes = multihost_utils.process_allgather(sizes)
        g_osz = multihost_utils.process_allgather(osz)
        g_shas = multihost_utils.process_allgather(shas)
        g_lens = multihost_utils.process_allgather(lens)
        g_ngaps = multihost_utils.process_allgather(ngaps)
        g_gaps = multihost_utils.process_allgather(gaps)
    else:
        g_sizes, g_osz, g_shas, g_lens, g_ngaps, g_gaps = (
            a[None, ...] for a in (sizes, osz, shas, lens, ngaps, gaps)
        )

    sizes_global = interleave_gathered(list(np.asarray(g_sizes)), num_chunks)
    offsets = global_offsets(sizes_global)
    total_payload = int(sizes_global.sum())

    with metrics.timed(Stage.FILE_IO, int(sizes[: len(local)].sum())):
        spill_to_output(output_path, spill_path, local, sizes[: len(local)], offsets)
    os.remove(spill_path)
    if num_hosts > 1:
        multihost_utils.sync_global_devices("dcz:payloads-written")
    if host == 0:
        metas = []
        for ci in range(num_chunks):
            h, k = ChunkAssignment.owner_of(ci, num_hosts), ci // num_hosts
            gb = (
                np.asarray(g_gaps[h][k][: int(g_ngaps[h][k])], np.uint32)
                if subblock and int(g_ngaps[h][k]) else None
            )
            metas.append(
                ct.ChunkMeta(
                    ci, ci * chunk_size, int(g_osz[h][k]), int(offsets[ci]),
                    int(g_sizes[h][k]), bytes(np.asarray(g_shas[h][k], np.uint8)),
                    np.asarray(g_lens[h][k], np.int32), gb,
                )
            )
        header = assemble_header(
            os.path.basename(input_path), file_size,
            int(os.path.getmtime(input_path) * 1000), chunk_size, metas,
            version=version, subblock=subblock,
        )
        with metrics.timed(Stage.HEADER_WRITE):
            write_footer_host0(output_path, header, total_payload)
    if num_hosts > 1:
        multihost_utils.sync_global_devices("dcz:footer-written")


def _decode_group_mesh(codec, header, payloads, metas, metrics, mesh,
                       step_cache: dict):
    """Decode up to ``mesh.size`` chunks in ONE sharded device program.

    Routing is identical to the single-chip service's
    (``DeviceChunkCodec.decode_chunk``): raw-store chunks pass through, chunks
    the device cannot decode (v1 layout, deep codebooks, pathological
    streams — ``_device_decode_plan`` returns None) delegate to the host
    decoder, and the rest run through ``make_sharded_decompress_step`` with
    group-wide static params validated host-side by
    ``check_decompress_step_params`` first.  Unused device slots repeat the
    first live chunk's row (a valid stream; padding rows cost only compute
    and are never fetched).
    """
    from ..models import Stage
    from ..ops import DEFAULT_REFILL_WORDS, build_decode_tables
    from .sharded import check_decompress_step_params, make_sharded_decompress_step

    results = [None] * len(payloads)
    live = []  # (result index, payload, meta, plan)
    for i, (p, m) in enumerate(zip(payloads, metas)):
        if codec._is_raw_store(p, m, header):
            with metrics.timed(Stage.DECODING, m.original_size):
                results[i] = np.frombuffer(p, dtype=np.uint8)
            continue
        plan = codec._device_decode_plan(p, m, header)
        if plan is None:
            results[i] = codec._cpu.decode_chunk(p, m, header, metrics)
            continue
        live.append((i, p, m, plan))
    if not live:
        return results

    B = mesh.size
    s = header.subblock_symbols
    nsub = (header.chunk_size_bytes + s - 1) // s
    # group-wide static params: the most conservative of the members'
    # per-chunk plans (deepest codebook wins), validated host-side before
    # dispatch — the validator raises instead of silently corrupting output
    sps = min(plan["sps"] for (_i, _p, _m, plan) in live)
    cmp = max(plan["cmp"] for (_i, _p, _m, plan) in live)
    padded = max(plan["padded"] for (_i, _p, _m, plan) in live)
    check_decompress_step_params(
        [m.code_lengths for (_i, _p, m, _pl) in live], s, sps, cmp,
        DEFAULT_REFILL_WORDS,
    )
    with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
        tables = [build_decode_tables(m.code_lengths) for (_i, _p, m, _pl) in live]

    total = sum(m.original_size for (_i, _p, m, _pl) in live)
    with metrics.timed(Stage.DECODING, total):
        wpad = np.zeros((B, padded), np.uint32)
        gpad = np.zeros((B, nsub), np.uint32)
        lim = np.tile(tables[0][0], (B, 1))
        adj = np.tile(tables[0][1], (B, 1))
        sym = np.tile(tables[0][2], (B, 1))
        for j, (_i, _p, m, plan) in enumerate(live):
            w = plan["words"]
            wpad[j, : w.size] = w
            gpad[j, : m.gap_bits.size] = m.gap_bits
            lim[j], adj[j], sym[j] = tables[j]
        for j in range(len(live), B):  # pad slots repeat row 0 (valid stream)
            wpad[j] = wpad[0]
            gpad[j] = gpad[0]
        key = (padded, nsub, s, sps, cmp)
        step = step_cache.get(key)
        if step is None:
            step = make_sharded_decompress_step(
                mesh, s, nsub, sps, cmp, refill_words=DEFAULT_REFILL_WORDS
            )
            step_cache[key] = step
        out = step(*_shard_rows(mesh, wpad, gpad, lim, adj, sym))
        fetched = np.asarray(out[: len(live)])  # ONE fetch of the live rows
        for j, (i, _p, m, _pl) in enumerate(live):
            results[i] = fetched[j, : m.original_size]
    return results


def decompress_multihost(
    input_path: str, output_path: str, config=None, backend: str = "cpu",
    mesh=None, progress=None, metrics=None,
) -> None:
    """End-to-end multi-host AND multi-chip decompress — the symmetric
    counterpart of :func:`compress_multihost`:
    every participating process decodes its round-robin chunk stripe and
    ``pwrite``s restored bytes at each chunk's recorded ``original_offset``
    into the shared output file.  Decompress needs NO collectives beyond two
    barriers (output sizing, completion): output placement is already in the
    container metadata, the parallelism axis the reference could only drive
    with a CPU thread pool (``CpuCompressionService.java:398-490``).

    Within each process the stripe is data-parallel over the local chips:
    with ``backend="gpu"`` and a ``mesh``, groups of ``mesh.size`` v2 chunks
    decode through ONE sharded device program
    (:func:`datacomp.parallel.sharded.make_sharded_decompress_step`),
    with raw-store and host-only chunks (v1, deep codebooks) routed around
    it exactly like the single-chip service.  Without a mesh the stripe runs
    through ``codec.decode_chunk_batch``.  Every chunk's SHA-256 is verified
    before its bytes are written.
    """
    import jax
    from jax.experimental import multihost_utils

    from ..config import load_config
    from ..models import Stage, StageMetrics
    from ..services.cpu_service import CpuChunkCodec
    from ..utils.checksum import compute_sha256

    cfg = config or load_config()
    host = jax.process_index()
    num_hosts = jax.process_count()
    metrics = metrics if metrics is not None else StageMetrics()

    with metrics.timed(Stage.FILE_IO):
        header, data_start = ct.read_container(input_path)
    num_chunks = header.num_chunks
    local = ChunkAssignment(host, num_hosts, num_chunks).local_chunks()

    if backend == "gpu":
        from ..services.device_service import DeviceChunkCodec

        codec = DeviceChunkCodec(cfg)
    else:
        codec = CpuChunkCodec(cfg)
    use_mesh = (
        backend == "gpu"
        and mesh is not None
        and mesh.size > 1
        and header.version >= ct.VERSION_V2
        and header.subblock_symbols > 0
    )
    group = mesh.size if use_mesh else max(1, getattr(codec, "batch_chunks", 1))
    step_cache: dict = {}

    # host 0 creates + sizes the output; everyone then writes disjoint ranges
    if host == 0:
        with open(output_path, "wb") as f:
            f.truncate(header.original_file_size)
    if num_hosts > 1:
        multihost_utils.sync_global_devices("dcz:decompress-output-sized")

    in_fd = os.open(input_path, os.O_RDONLY)
    out_fd = os.open(output_path, os.O_WRONLY)
    try:
        for g0 in range(0, len(local), group):
            gmetas = [header.chunks[ci] for ci in local[g0 : g0 + group]]
            payloads = []
            for m in gmetas:
                with metrics.timed(Stage.FILE_IO, m.compressed_size):
                    p = os.pread(in_fd, m.compressed_size, data_start + m.compressed_offset)
                if len(p) != m.compressed_size:
                    raise IOError(f"short read on chunk {m.index}")
                payloads.append(p)
            if use_mesh:
                datas = _decode_group_mesh(
                    codec, header, payloads, gmetas, metrics, mesh, step_cache
                )
            else:
                datas = codec.decode_chunk_batch(payloads, gmetas, header, metrics)
            for m, data in zip(gmetas, datas):
                if data.size != m.original_size:
                    raise IOError(f"size mismatch in chunk {m.index}")
                with metrics.timed(Stage.CHECKSUM_VERIFY, data.size):
                    digest = compute_sha256(data)
                    if digest != m.sha256:
                        raise IOError(
                            f"Checksum mismatch in chunk {m.index}: expected "
                            f"{m.sha256.hex()}, got {digest.hex()}"
                        )
                with metrics.timed(Stage.FILE_IO, data.size):
                    os.pwrite(out_fd, data, m.original_offset)
            if progress is not None:
                progress(min(g0 + len(gmetas), len(local)) / max(len(local), 1))
    finally:
        os.close(in_fd)
        os.close(out_fd)
    if num_hosts > 1:
        multihost_utils.sync_global_devices("dcz:decompress-written")
