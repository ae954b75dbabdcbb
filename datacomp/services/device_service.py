"""Device backend: device chunk codec + compression service with fallback chain.

XLA re-architecture of the reference GPU backend
(``service/gpu/GpuCompressionService.java``, ``GpuFrequencyService.java``).
What the reference does with TornadoVM TaskGraphs, explicit H2D/D2H staging,
VRAM-string heuristics and manual frees, this service does with XLA: jitted
device functions over static padded chunk shapes and implicit transfers.  The
reference's layered fallback chain is preserved for the ``auto`` factory and
library callers, and switched off wherever the GPU is named
(:func:`open_gpu_service`):

1. availability probe at init (1 KB test kernel,
   ``GpuFrequencyService.isAvailable:255-283``),
2. config-driven ``fallback_on_error``,
3. whole-operation catch → CPU service
   (``GpuCompressionService.java:160-167``),
4. per-chunk decode: v1 containers (no gap arrays) and deep codebooks
   (> 16-bit codes) delegate to the CPU codec — mirroring the reference's
   deliberate CPU decompress delegation (``decompressGpuHybrid:852-862``) —
   while v2 containers decode on device via gap arrays.
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace
from typing import Optional

import numpy as np

from ..config import AppConfig, load_config
from ..core import container as ct, huffman
from ..models import Stage, StageMetrics
from ..ops import (
    TABLE_BITS,
    build_decode_tables,
    cmp_len_bucket,
    DEFAULT_REFILL_WORDS,
    decode_device,
    device_codebook,
    encode_device_merge,
    encode_device_merge_batch_slotted,
    slot_bucket,
    encode_device_merge_slotted,
    histogram_device,
    max_code_len,
    payload_to_words,
    syms_per_refill,
    words_to_bytes,
)
from ..utils.checksum import compute_sha256
from .base import CompressionService, FrequencyService, ProgressCallback
from .cpu_service import CpuChunkCodec, CpuCompressionService
from .pipeline import ChunkCodec, ChunkedPipeline, EncodedChunk

logger = logging.getLogger(__name__)


def _get_jax():
    import jax

    return jax


def pick_device(platform: str = "any", index: int = -1):
    """Select the compute device (the reference's ``findCudaDevice``,
    ``GpuFrequencyService.java:53-84``).  ``"gpu"`` or ``"cpu"`` names a
    platform and raises when JAX has no device of it, so a named accelerator
    never silently becomes another one; ``"any"`` is JAX's default backend."""
    jax = _get_jax()
    if platform in ("any", ""):
        devices = jax.devices()
    else:
        try:
            devices = jax.devices(platform)
        except RuntimeError as e:
            raise RuntimeError(f"no {platform} device available: {e}") from e
    if 0 <= index < len(devices):
        return devices[index]
    return devices[0]


def get_available_devices() -> list:
    """Enumerate devices (parity: ``GpuFrequencyService.getAvailableDevices:288-310``)."""
    try:
        jax = _get_jax()
        return [
            f"[{i}] {d.device_kind}  platform={d.platform}  id={d.id}  "
            f"process={d.process_index}"
            for i, d in enumerate(jax.devices())
        ]
    except Exception as e:  # noqa: BLE001
        return [f"no devices available: {e}"]


class DeviceFrequencyService(FrequencyService):
    """Device histogram service (parity surface: ``GpuFrequencyService``)."""

    def __init__(self, config: Optional[AppConfig] = None):
        self.config = config or load_config()
        self._device = None
        self._available: Optional[bool] = None

    def _ensure_device(self):
        if self._device is None:
            self._device = pick_device(
                self.config.device.platform, self.config.device.device_index
            )
        return self._device

    def compute_histogram(self, data, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        jax = _get_jax()
        import jax.numpy as jnp

        data = np.asarray(data, dtype=np.uint8)
        if length is None:
            length = data.size - offset
        view = np.ascontiguousarray(data[offset : offset + length])
        dev = self._ensure_device()
        x = jax.device_put(view, dev)
        return np.asarray(histogram_device(x, jnp.int32(length))).astype(np.int64)

    def probe(self) -> None:
        """Run a 1 KB histogram on the device and check it against the host
        (reference parity: 1 KB test kernel,
        ``GpuFrequencyService.java:255-283``); raises on any failure."""
        probe = np.arange(1024, dtype=np.uint8) % 251
        if not np.array_equal(
            self.compute_histogram(probe), np.bincount(probe, minlength=256)
        ):
            raise RuntimeError("device histogram probe returned a wrong result")

    def is_available(self) -> bool:
        if self._available is None:
            try:
                self.probe()
                self._available = True
            except Exception as e:  # noqa: BLE001 — any failure ⇒ unavailable
                logger.warning("device availability probe failed: %s", e)
                self._available = False
        return self._available

    def get_service_name(self) -> str:
        try:
            return f"Device Frequency Analysis ({self._ensure_device().device_kind})"
        except Exception:  # noqa: BLE001
            return "Device Frequency Analysis (unavailable)"


class DeviceChunkCodec(ChunkCodec):
    """Per-chunk device codec: device histogram → host (or device) codebook →
    device encode; gap-array device decode for v2 containers."""

    def __init__(self, config: AppConfig):
        self.config = config
        # max_code_len × codebook_mode interactions are diagnosed centrally
        # in config.load_config(), shared by all entry points
        self.freq = DeviceFrequencyService(config)
        # resolve the device now: a named platform with no device fails at
        # construction, before any output file is opened
        self.freq._ensure_device()
        self._cpu = CpuChunkCodec(config)  # embedded fallback + v1 decode
        self.padded_size = config.chunk_size_bytes
        self.subblock = config.compression.subblock_symbols
        # Output word capacity: Huffman average code length over the chunk
        # that built the code is ≤ H+1 ≤ 9 bits/byte, so 9n/32 words suffice;
        # a host-side guard below re-raises (→ CPU fallback) if ever exceeded.
        self.out_words = (9 * self.padded_size + 31) // 32 + 2
        # Payload-prefix fetches slice the device words array to the chunk's
        # live size — but a DISTINCT slice width is a distinct executable.
        # Real-world chunks almost always differ in encoded size, so exact
        # widths would compile per chunk; rounding the width up to 32K-word
        # (128 KB) buckets caps the executable count at out_words/2^15 (~144
        # for 16 MB chunks) while costing at most 128 KB of extra D2H per
        # chunk.  The same trick already shapes the decode path's input
        # padding (_device_decode_plan).
        self.fetch_bucket_words = 1 << 15
        # The first execution of each device program compiles it; serialize
        # it so worker threads don't compile the same program concurrently.
        self._warm_lock = __import__("threading").Lock()
        self._encode_warm = False
        self._decode_warm = False
        self._fused = None  # device-codebook fused pipeline (built lazily)
        self._batched = {}  # (Bs, with_gaps, host_tables, slots) -> jitted vmap
        self._batch_warm = set()  # batched-executable keys already run once
        self._batched_dec = {}  # (Bs, padded, nsub, s, sps, cmp) -> jitted vmap
        self._batch_dec_warm = set()

    def _fetch_words_ub(self, opt_bits: int) -> int:
        """Bucketed upper-bound word count for a single-round-trip payload
        fetch: exact live size from ``opt_bits``, rounded up to the fetch
        bucket so slice executables are reused across chunks."""
        nw = (opt_bits + 31) // 32 + 1
        b = self.fetch_bucket_words
        return min(-(-nw // b) * b, self.out_words)

    @property
    def batch_chunks(self) -> int:
        """Chunks per device program (the pipeline groups jobs by this).

        ``device.batch_chunks = 0`` (auto) resolves per platform: 4 on a
        GPU — one program dispatch + one H2D call per 4 chunks, the
        re-expression of the reference's sliding-window device scheduler
        (``GpuCompressionService.java:232-320``) — and 1 on CPU platforms
        (the XLA:CPU program would serialize chunks the worker threads
        already parallelize).  The GPU value is not yet measured against
        the alternatives."""
        b = self.config.device.batch_chunks
        if b != 0:
            return b
        return 1 if self.freq._ensure_device().platform == "cpu" else 4

    def _fused_pipeline(self):
        """Single jit for the device-codebook mode: histogram → codebook →
        encode in ONE executable (one program load, no host round-trips).
        The encode runs under the runtime slot-bucket switch
        (``ops.encode_device_merge_slotted``) — the codebook depth is a
        traced value here, so static ``max_slots`` bucketing is unavailable
        and the full 33-slot scatter would run at full depth on typical
        data."""
        if self._fused is None:
            jax = _get_jax()

            def fused(data, valid_len):
                hist = histogram_device(data, valid_len)
                lengths, codes = device_codebook(hist)
                words, total_bits, gaps = encode_device_merge_slotted(
                    data, valid_len, lengths, codes, self.out_words,
                    self.subblock or self.config.compression.subblock_symbols,
                )
                return lengths, words, total_bits, gaps

            self._fused = jax.jit(fused)
        return self._fused

    # -- encode -------------------------------------------------------------

    def encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        if not self._encode_warm:
            with self._warm_lock:
                if not self._encode_warm:
                    out = self._encode_chunk(data, metrics)
                    self._encode_warm = True
                    return out
        return self._encode_chunk(data, metrics)

    def _host_prepass(self, data: np.ndarray, metrics: StageMetrics):
        """Per-chunk host-side stage shared by the single and batched encode
        paths: SHA-256, host histogram, host codebook (non-device modes) and
        the raw-store decision.

        Host histogram first (one native pass): the raw-store decision
        (and, for host codebook modes, the codebook itself) comes from the
        host histogram, so incompressible chunks never touch the device.

        Returns ``(sha, lengths, codes, opt_bits, finished)``; ``finished``
        is a completed :class:`EncodedChunk` (empty input or raw store) that
        skips the device entirely, else ``None``.  ``opt_bits`` (None when
        not computed) is the chunk's exact encoded bit count under an
        optimal codebook — both the host ``fast`` builder and the device
        codebook are true Huffman over the same histogram, so the device's
        ``total_bits`` equals it; the encode paths use it to size the
        payload prefix and fetch payload + metadata in ONE blocking
        transfer.
        """
        n = data.size
        with metrics.timed(Stage.CHECKSUM_COMPUTE, n):
            sha = compute_sha256(data)  # hashlib takes the buffer, no copy
        if n == 0:
            return sha, None, None, None, EncodedChunk(
                b"", np.zeros(256, np.int32), sha, None
            )

        mode = self.config.compression.codebook_mode
        v2 = self.config.compression.format_version >= 2
        hist = None
        lengths = codes = None
        opt_bits = None
        if v2 or mode != "device":
            with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
                hist = self._cpu.freq.compute_histogram(data)
        if mode != "device":
            with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
                lengths, codes = huffman.build_codebook(
                    hist, mode=mode,
                    max_len=self.config.compression.effective_max_code_len(),
                )
        if hist is not None:
            # exact bit count under the codebook the device will use: the
            # host tables themselves, or (device mode) an optimal-Huffman
            # equal.  "fast"-mode lengths are true Huffman, as is the
            # device codebook (ops/codebook.py) — equal total bits by
            # optimality even where tie-breaks differ.
            opt_bits = (
                int(hist @ lengths.astype(np.int64))
                if lengths is not None
                else int(
                    hist
                    @ huffman.build_code_lengths(hist, mode="fast").astype(np.int64)
                )
            )
        if v2 and opt_bits is not None and opt_bits >= n * 8:
            # incompressible: store raw (v2 marker: all-zero lengths)
            # without touching the device
            finished = EncodedChunk(
                data.tobytes(), np.zeros(256, np.int32), sha, None
            )
            return sha, lengths, codes, opt_bits, finished
        return sha, lengths, codes, opt_bits, None

    def _encode_chunk(self, data: np.ndarray, metrics: StageMetrics) -> EncodedChunk:
        jax = _get_jax()
        import jax.numpy as jnp

        n = data.size
        mode = self.config.compression.codebook_mode
        v2 = self.config.compression.format_version >= 2

        sha, lengths, codes, opt_bits, finished = self._host_prepass(data, metrics)
        if finished is not None:
            return finished

        dev = self.freq._ensure_device()
        padded = np.zeros(self.padded_size, dtype=np.uint8)
        padded[:n] = data
        if mode == "device" and v2:
            # fused single-executable path: histogram → codebook → encode.
            # The H2D upload is timed inside ENCODING, matching _run_batch —
            # stage metrics must attribute transfer identically on the
            # single and batched paths or batch_chunks A/Bs misread.
            with metrics.timed(Stage.ENCODING, n):
                x = jax.device_put(padded, dev)
                lengths_dev, words, total_bits, gaps = self._fused_pipeline()(
                    x, jnp.int32(n)
                )
                # ONE round trip for metadata AND the payload prefix: the
                # prepass's opt_bits equals the device's total_bits (both
                # codebooks are optimal Huffman over the same histogram),
                # so the live word count is known before any fetch.
                nw_ub = self._fetch_words_ub(opt_bits)
                tb, lengths, gaps_h, words_h = jax.device_get(
                    (total_bits, lengths_dev, gaps, words[:nw_ub])
                )
                tb = int(tb)
                if tb >= n * 8:
                    # incompressible: store raw (v2 marker: all-zero lengths)
                    return EncodedChunk(data.tobytes(), np.zeros(256, np.int32), sha, None)
                if tb > self.out_words * 32:
                    raise RuntimeError("encoded stream exceeded device word capacity")
                nw = (tb + 31) // 32
                if nw <= nw_ub:
                    payload = words_to_bytes(np.asarray(words_h)[:nw], tb)
                else:  # defensive: codebook totals diverged; refetch bucketed
                    nw_b = self._fetch_words_ub(tb)
                    payload = words_to_bytes(np.asarray(words[:nw_b])[:nw], tb)
                lengths = np.asarray(lengths).astype(np.int32)
                nsub = (n + self.subblock - 1) // self.subblock
                gap_bits = np.asarray(gaps_h)[:nsub].astype(np.uint32)
            return EncodedChunk(payload, lengths, sha, gap_bits)

        if mode == "device":
            # v1 + device codebook: histogram + codebook stay on device
            with metrics.timed(Stage.FREQUENCY_ANALYSIS, n):
                x = jax.device_put(padded, dev)
                hist_dev = histogram_device(x, jnp.int32(n))
            with metrics.timed(Stage.HUFFMAN_TREE_BUILD, n):
                lengths_dev, codes_dev = device_codebook(hist_dev)
                lengths = np.asarray(lengths_dev)
                codes = np.asarray(codes_dev).astype(np.uint32)
        else:
            # host codebook (built above from the host histogram): the
            # 256-entry tables ship up WITH the data inside the encode stage
            # below — one device_put call, no histogram round trip
            lengths_dev = codes_dev = None

        # bucketed static scatter-slot bound (maxlen+2), avoiding a recompile
        # per distinct per-chunk max code length — the v1 device-codebook
        # branch above fetched `lengths` to host, so BOTH modes can bucket
        # statically here (33 slots would run a full-depth scatter on
        # typical data).
        ml = int(lengths.max()) if lengths.any() else 1
        slots = slot_bucket(ml)
        with metrics.timed(Stage.ENCODING, n):
            if lengths_dev is None:
                # ONE upload call for data + both tables; timed here so
                # transfer attribution matches the batched path (_run_batch)
                x, lengths_dev, codes_dev = jax.device_put(
                    (padded, lengths, codes.astype(np.uint32)), dev
                )
            # host-table paths know the exact bit count pre-dispatch
            # (opt_bits = hist @ the very lengths the device encodes with),
            # so metadata and the payload prefix ride ONE device_get; the
            # v1 device-codebook path (opt_bits None) keeps the 2-fetch flow
            nw_ub = (
                self._fetch_words_ub(opt_bits)
                if opt_bits is not None else None
            )
            if v2:
                words, total_bits, gaps = encode_device_merge(
                    x, jnp.int32(n), lengths_dev, codes_dev,
                    self.out_words, self.subblock, max_slots=slots,
                )
                nsub = (n + self.subblock - 1) // self.subblock
                if nw_ub is not None:
                    tb, gaps_h, words_h = jax.device_get(
                        (total_bits, gaps, words[:nw_ub])
                    )
                else:
                    tb, gaps_h = jax.device_get((total_bits, gaps))
                    words_h = None
                tb = int(tb)
                gap_bits = np.asarray(gaps_h)[:nsub].astype(np.uint32)
            else:
                words, total_bits = encode_device_merge(
                    x, jnp.int32(n), lengths_dev, codes_dev, self.out_words,
                    max_slots=slots,
                )
                gap_bits = None
                if nw_ub is not None:
                    tb, words_h = jax.device_get((total_bits, words[:nw_ub]))
                else:
                    tb, words_h = total_bits, None
                tb = int(tb)
            if v2 and tb >= n * 8:
                # incompressible: store raw (v2 marker: all-zero lengths) —
                # normally decided host-side before any upload; kept as a
                # safety net for codebook modes whose nbits estimate differs
                return EncodedChunk(data.tobytes(), np.zeros(256, np.int32), sha, None)
            if tb > self.out_words * 32:
                raise RuntimeError("encoded stream exceeded device word capacity")
            # D2H only the live prefix: device-slice to ceil(bits/32) words
            # (the padded tail is up to 9x the payload).  The no-opt_bits fallback slices at the
            # BUCKETED width so the slice executable is reused across chunks
            # (see fetch_bucket_words).
            nw = (tb + 31) // 32
            if words_h is not None and nw <= len(words_h):
                payload = words_to_bytes(np.asarray(words_h)[:nw], tb)
            else:
                nw_b = self._fetch_words_ub(tb)
                payload = words_to_bytes(np.asarray(words[:nw_b])[:nw], tb)
        return EncodedChunk(payload, lengths.astype(np.int32), sha, gap_bits)

    # -- batched encode -------------------------------------------------------

    def _batched_pipeline(self, Bs: int, with_gaps: bool, host_tables: bool,
                          slots: int):
        """ONE jitted program encoding ``Bs`` chunks (vmapped single-chunk
        pipeline, the same shape ``parallel/sharded._chunk_pipeline`` runs
        per mesh device).  Amortizes program dispatch and transfer-call
        latency over the batch — the re-expression of the reference's
        sliding-window device scheduler
        (``gpu/GpuCompressionService.java:232-320``)."""
        key = (Bs, with_gaps, host_tables, slots)
        fn = self._batched.get(key)
        if fn is None:
            jax = _get_jax()
            sub = self.subblock if with_gaps else 0
            if host_tables:
                def one(d, v, lens, cws):
                    return encode_device_merge(
                        d, v, lens, cws, self.out_words, sub, max_slots=slots
                    )
                fn = jax.jit(jax.vmap(one))
            else:
                def batched(d, v):
                    lens, cws = jax.vmap(
                        lambda di, vi: device_codebook(histogram_device(di, vi))
                    )(d, v)
                    out = encode_device_merge_batch_slotted(
                        d, v, lens, cws, self.out_words, sub
                    )
                    return (lens,) + tuple(out)

                fn = jax.jit(batched)
            self._batched[key] = fn
        return fn

    def encode_chunk_batch(self, datas, metrics: StageMetrics):
        Bs = self.batch_chunks
        if len(datas) == 1 or Bs <= 1:
            return [self.encode_chunk(d, metrics) for d in datas]
        mode = self.config.compression.codebook_mode
        v2 = self.config.compression.format_version >= 2
        results: list = [None] * len(datas)
        slots_dev = []  # (result index, data, n, sha, lengths, codes, opt_bits)
        for i, data in enumerate(datas):
            sha, lengths, codes, opt_bits, finished = self._host_prepass(
                data, metrics
            )
            if finished is not None:
                results[i] = finished
            else:
                slots_dev.append(
                    (i, data, data.size, sha, lengths, codes, opt_bits)
                )
        if not slots_dev:
            return results
        assert len(slots_dev) <= Bs, "pipeline grouped more chunks than batch_chunks"

        dev = self.freq._ensure_device()
        # static batch shape: pad unused slots with valid_len=0 chunks so one
        # executable serves every group (incl. raw-store-thinned and tail
        # groups) — a zero slot encodes to 0 bits, wasting only its compute
        batch = np.zeros((Bs, self.padded_size), dtype=np.uint8)
        valid = np.zeros(Bs, dtype=np.int32)
        for j, (_, data, n, _, _, _, _) in enumerate(slots_dev):
            batch[j, :n] = data
            valid[j] = n
        host_tables = mode != "device"
        if host_tables:
            lens_h = np.zeros((Bs, 256), dtype=np.int32)
            codes_h = np.zeros((Bs, 256), dtype=np.uint32)
            for j, (_, _, _, _, lengths, codes, _) in enumerate(slots_dev):
                lens_h[j] = lengths
                codes_h[j] = codes.astype(np.uint32)
            ml = int(lens_h.max()) if lens_h.any() else 1
            slots = slot_bucket(ml)
        else:
            slots = 33
        fn = self._batched_pipeline(Bs, v2, host_tables, slots)

        key = (Bs, v2, host_tables, slots)
        args = (fn, batch, valid, lens_h if host_tables else None,
                codes_h if host_tables else None, host_tables,
                v2, slots_dev, results, metrics, dev)
        if key not in self._batch_warm:
            # serialize each executable's first run (its compile)
            with self._warm_lock:
                out = self._run_batch(*args)
                self._batch_warm.add(key)
                return out
        return self._run_batch(*args)

    def _run_batch(self, fn, batch, valid, lens_h, codes_h, host_tables, v2,
                   slots_dev, results, metrics, dev):
        jax = _get_jax()

        total_n = int(valid.sum())
        with metrics.timed(Stage.ENCODING, total_n):
            # one device_put call for the whole group
            if host_tables:
                x, vl, ld, cd = jax.device_put(
                    (batch, valid, lens_h, codes_h), dev
                )
                out = fn(x, vl, ld, cd)
                if v2:
                    words, total_bits, gaps = out
                else:
                    words, total_bits = out
                    gaps = None
                lens_dev = None
            else:
                x, vl = jax.device_put((batch, valid), dev)
                out = fn(x, vl)
                if v2:
                    lens_dev, words, total_bits, gaps = out
                else:
                    lens_dev, words, total_bits = out
                    gaps = None
            # ONE round trip for every chunk's control metadata AND payload
            # prefixes: each chunk's exact bit count is known host-side
            # (opt_bits — see _host_prepass), so its live word prefix rides
            # the same device_get instead of a per-chunk blocking fetch
            fetch = [total_bits]
            if lens_dev is not None:
                fetch.append(lens_dev)
            if gaps is not None:
                fetch.append(gaps)
            nmeta = len(fetch)
            ubs = []
            for (_i, _d, _n, _s, _l, _c, opt_bits) in slots_dev:
                ubs.append(
                    self._fetch_words_ub(opt_bits)
                    if opt_bits is not None else None
                )
            for j, ub in enumerate(ubs):
                if ub is not None:
                    fetch.append(words[j, :ub])
            fetched = jax.device_get(tuple(fetch))
            tbs = np.asarray(fetched[0])
            lens_all = (
                np.asarray(fetched[1]) if lens_dev is not None else lens_h
            )
            gaps_all = (
                np.asarray(fetched[nmeta - 1]) if gaps is not None else None
            )
            prefixes = iter(fetched[nmeta:])
            words_pre = [next(prefixes) if ub is not None else None for ub in ubs]

            for j, (i, data, n, sha, _, _, _) in enumerate(slots_dev):
                tb = int(tbs[j])
                if v2 and tb >= n * 8:
                    # safety net (normally decided host-side pre-upload)
                    results[i] = EncodedChunk(
                        data.tobytes(), np.zeros(256, np.int32), sha, None
                    )
                    continue
                if tb > self.out_words * 32:
                    raise RuntimeError("encoded stream exceeded device word capacity")
                nw = (tb + 31) // 32
                if words_pre[j] is not None and nw <= len(words_pre[j]):
                    payload = words_to_bytes(np.asarray(words_pre[j])[:nw], tb)
                else:
                    # defensive: estimate diverged; refetch at bucketed width
                    nw_b = self._fetch_words_ub(tb)
                    payload = words_to_bytes(
                        np.asarray(words[j, :nw_b])[:nw], tb
                    )
                gap_bits = None
                if gaps_all is not None:
                    nsub = (n + self.subblock - 1) // self.subblock
                    gap_bits = gaps_all[j, :nsub].astype(np.uint32)
                results[i] = EncodedChunk(
                    payload, lens_all[j].astype(np.int32), sha, gap_bits
                )
        return results

    # -- decode -------------------------------------------------------------

    def decode_chunk(self, payload, meta, header, metrics: StageMetrics) -> np.ndarray:
        if not self._decode_warm:
            with self._warm_lock:
                if not self._decode_warm:
                    out = self._decode_chunk(payload, meta, header, metrics)
                    self._decode_warm = True
                    return out
        return self._decode_chunk(payload, meta, header, metrics)

    @staticmethod
    def _is_raw_store(payload, meta, header) -> bool:
        return (
            header.version >= ct.VERSION_V2
            and not meta.code_lengths.any()
            and meta.compressed_size == meta.original_size
        )

    def _device_decode_plan(self, payload, meta, header):
        """Host-side eligibility check + static decode parameters for one
        chunk; returns None when the chunk must decode on the host (v1
        container, deep codebook, or pathological stream size — reference
        parity: the GPU service delegates decompress to the CPU,
        ``gpu/GpuCompressionService.java:852-862``).

        The stream is padded to a BUCKETED static shape: padding straight to
        the worst case (9 bits/byte ≈ 18 MB for a 16 MB chunk) would transfer
        mostly zeros on every chunk.  Eight size buckets bound the compile count while keeping the transfer
        within 12.5% + 256 KB of the payload.
        """
        if not (
            header.version >= ct.VERSION_V2
            and meta.gap_bits is not None
            and meta.gap_bits.size > 0
            and header.subblock_symbols > 0
        ):
            return None
        ml = max_code_len(meta.code_lengths)
        if not 0 < ml <= TABLE_BITS:
            return None
        words = payload_to_words(payload)
        cap = (9 * header.chunk_size_bytes + 31) // 32 + 4
        if words.size > cap:
            return None  # foreign encoder with pathological codes
        bucket = max(cap // 8, 1 << 16)
        padded = min(-(-words.size // bucket) * bucket, cap)
        return {
            "words": words,
            "padded": padded,
            "sps": syms_per_refill(ml, header.subblock_symbols, DEFAULT_REFILL_WORDS),
            "cmp": cmp_len_bucket(ml),
        }

    def _decode_chunk(self, payload, meta, header, metrics: StageMetrics) -> np.ndarray:
        if self._is_raw_store(payload, meta, header):
            with metrics.timed(Stage.DECODING, meta.original_size):
                return np.frombuffer(payload, dtype=np.uint8)
        plan = self._device_decode_plan(payload, meta, header)
        if plan is None:
            return self._cpu.decode_chunk(payload, meta, header, metrics)

        jax = _get_jax()
        dev = self.freq._ensure_device()
        s = header.subblock_symbols
        nsub_static = (header.chunk_size_bytes + s - 1) // s
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
            limits, adj, sym = build_decode_tables(meta.code_lengths)
        with metrics.timed(Stage.DECODING, meta.original_size):
            wpad = np.zeros(plan["padded"], dtype=np.uint32)
            wpad[: plan["words"].size] = plan["words"]
            gpad = np.zeros(nsub_static, dtype=np.uint32)
            gpad[: meta.gap_bits.size] = meta.gap_bits
            # one device_put call for all five arrays
            wd, gd, ld, ad, sd = jax.device_put((wpad, gpad, limits, adj, sym), dev)
            out = decode_device(
                wd, gd, ld, ad, sd,
                s,
                nsub_static,
                syms_per_step=plan["sps"],
                cmp_len=plan["cmp"],
                refill_words=DEFAULT_REFILL_WORDS,
            )
            return np.asarray(out)[: meta.original_size]

    # -- batched decode -------------------------------------------------------

    def _batched_decoder(self, Bs: int, padded: int, nsub: int, s: int,
                         sps: int, cmp: int):
        """ONE jitted program decoding ``Bs`` chunks (vmapped gap-array
        decoder — the same shape ``parallel/sharded.make_sharded_decompress_
        step`` runs per mesh device).  Amortizes program dispatch and
        transfer-call latency over the batch, completing the symmetry with
        :meth:`_batched_pipeline` on the encode side."""
        key = (Bs, padded, nsub, s, sps, cmp)
        fn = self._batched_dec.get(key)
        if fn is None:
            jax = _get_jax()

            def one(w, g, lim, adj, sym):
                return decode_device(
                    w, g, lim, adj, sym, s, nsub,
                    syms_per_step=sps, cmp_len=cmp,
                    refill_words=DEFAULT_REFILL_WORDS,
                )

            fn = jax.jit(jax.vmap(one))
            self._batched_dec[key] = fn
        return fn

    def decode_chunk_batch(self, payloads, metas, header, metrics: StageMetrics):
        Bs = self.batch_chunks
        if Bs <= 1 or len(payloads) == 1:
            return [
                self.decode_chunk(p, m, header, metrics)
                for p, m in zip(payloads, metas)
            ]
        results: list = [None] * len(payloads)
        plans = {}
        groups: dict = {}  # (syms_per_step, cmp_len) -> [result index, ...]
        for j, (p, m) in enumerate(zip(payloads, metas)):
            if self._is_raw_store(p, m, header):
                with metrics.timed(Stage.DECODING, m.original_size):
                    results[j] = np.frombuffer(p, dtype=np.uint8)
                continue
            plan = self._device_decode_plan(p, m, header)
            if plan is None:
                results[j] = self._cpu.decode_chunk(p, m, header, metrics)
                continue
            plans[j] = plan
            groups.setdefault((plan["sps"], plan["cmp"]), []).append(j)
        for (sps, cmp), js in groups.items():
            if len(js) == 1:  # lone chunk in its depth bucket: single path
                j = js[0]
                results[j] = self.decode_chunk(payloads[j], metas[j], header, metrics)
                continue
            outs = self._run_decode_batch(
                js, payloads, metas, header, plans, sps, cmp, metrics
            )
            for j, out in zip(js, outs):
                results[j] = out
        return results

    def _run_decode_batch(self, js, payloads, metas, header, plans, sps, cmp,
                          metrics: StageMetrics):
        jax = _get_jax()
        dev = self.freq._ensure_device()
        Bs = self.batch_chunks
        assert len(js) <= Bs, "pipeline grouped more chunks than batch_chunks"
        s = header.subblock_symbols
        nsub = (header.chunk_size_bytes + s - 1) // s
        # one static word width per group (max of the members' size buckets)
        padded = max(plans[j]["padded"] for j in js)
        with metrics.timed(Stage.HUFFMAN_TREE_BUILD):
            tables = [build_decode_tables(metas[j].code_lengths) for j in js]

        def run():
            total = sum(metas[j].original_size for j in js)
            with metrics.timed(Stage.DECODING, total):
                # static batch shape: pad tail groups by repeating row 0 so
                # one executable serves every group; padding rows cost only
                # their compute and are never fetched
                wpad = np.zeros((Bs, padded), dtype=np.uint32)
                gpad = np.zeros((Bs, nsub), dtype=np.uint32)
                lim = np.tile(tables[0][0], (Bs, 1))
                adj = np.tile(tables[0][1], (Bs, 1))
                sym = np.tile(tables[0][2], (Bs, 1))
                for i, j in enumerate(js):
                    w = plans[j]["words"]
                    wpad[i, : w.size] = w
                    gpad[i, : metas[j].gap_bits.size] = metas[j].gap_bits
                    lim[i], adj[i], sym[i] = tables[i]
                # one device_put call for the whole group's five arrays
                wd, gd, ld, ad, sd = jax.device_put(
                    (wpad, gpad, lim, adj, sym), dev
                )
                fn = self._batched_decoder(Bs, padded, nsub, s, sps, cmp)
                out = fn(wd, gd, ld, ad, sd)
                # fetch only the live rows, in ONE transfer
                fetched = np.asarray(out[: len(js)])
                return [
                    fetched[i, : metas[j].original_size]
                    for i, j in enumerate(js)
                ]

        key = (Bs, padded, nsub, s, sps, cmp)
        if key not in self._batch_dec_warm:
            # serialize each executable's first run (its compile)
            with self._warm_lock:
                outs = run()
                self._batch_dec_warm.add(key)
                return outs
        return run()


class DeviceCompressionService(CompressionService):
    """Device-accelerated compression service with CPU fallback chain."""

    def __init__(self, config: Optional[AppConfig] = None):
        self.config = config or load_config()
        self._stage_metrics = StageMetrics()
        self._codec = DeviceChunkCodec(self.config)
        self._pipeline = ChunkedPipeline(
            self.config, self._codec, workers=max(2, self.config.device.parallel_chunks)
        )
        self._cpu_fallback = CpuCompressionService(self.config)

    def _run(self, op, *args, progress=None):
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        try:
            op(*args, progress, self._stage_metrics)
            backend = self._backend_name()
        except Exception as e:  # noqa: BLE001 — whole-op fallback (chain level 3)
            if not self.config.device.fallback_on_error:
                raise
            logger.warning("device pipeline failed (%s); falling back to CPU", e)
            cpu_ops = {
                self._pipeline.compress: self._cpu_fallback._pipeline.compress,
                self._pipeline.decompress: self._cpu_fallback._pipeline.decompress,
            }
            # fresh StageMetrics for the retry: the partial device attempt's
            # stage timings must not blend into the CPU run's breakdown
            # (the stage cards — the reference's displayStageMetrics parity
            # surface, ui/CompressController.java:491-521 — would otherwise
            # show a device/CPU hybrid as one run)
            self._stage_metrics = StageMetrics()
            cpu_ops[op](*args, progress, self._stage_metrics)
            backend = "CPU"
        return backend, time.perf_counter() - t0

    def compress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        backend, dt = self._run(self._pipeline.compress, input_path, output_path, progress=progress)
        self._record(input_path, output_path, True, dt, backend)

    def decompress(self, input_path, output_path, progress: ProgressCallback = None) -> None:
        backend, dt = self._run(self._pipeline.decompress, input_path, output_path, progress=progress)
        self._record(input_path, output_path, False, dt, backend)

    def resume_compression(self, input_path, output_path, last_completed_chunk, progress=None) -> None:
        self._stage_metrics = StageMetrics()
        t0 = time.perf_counter()
        self._pipeline.resume_compression(
            input_path, output_path, last_completed_chunk, progress, self._stage_metrics
        )
        self._record(
            input_path, output_path, True, time.perf_counter() - t0,
            self._backend_name(),
        )

    def verify_integrity(self, compressed_path, deep: bool = False) -> bool:
        return self._pipeline.verify_integrity(compressed_path, deep=deep)

    def get_service_name(self) -> str:
        return "Device Compression"

    def _backend_name(self) -> str:
        """Metrics label: the platform the device programs ran on."""
        return self._codec.freq._ensure_device().platform.upper()

    def is_available(self) -> bool:
        return self._codec.freq.is_available()

    def close(self) -> None:
        self._pipeline.close()
        self._cpu_fallback.close()

    def _record(self, input_path, output_path, compressing, duration_s, backend) -> None:
        import os

        from ..models import CompressionMetrics, MetricsService, OperationType

        try:
            in_size = os.path.getsize(input_path)
            out_size = os.path.getsize(output_path)
        except OSError:
            return
        MetricsService.get_instance().add_metrics(
            CompressionMetrics(
                file_name=os.path.basename(input_path),
                operation=OperationType.COMPRESSION if compressing else OperationType.DECOMPRESSION,
                original_size=in_size,
                processed_size=out_size,
                duration_s=max(duration_s, 1e-9),
                backend=backend,
            )
        )


def gpu_config(config: AppConfig) -> AppConfig:
    """``config`` pinned to the GPU with the CPU fallback off."""
    return replace(
        config,
        device=replace(config.device, platform="gpu", fallback_on_error=False),
    )


def open_gpu_service(config: Optional[AppConfig] = None) -> DeviceCompressionService:
    """The device service pinned to the GPU with the CPU fallback off: a
    missing card, a failed availability probe or a failed chunk raises.
    Every path that names the GPU (``--backend gpu``, the benchmark's device
    leg, the chip smoke run) builds its service here."""
    svc = DeviceCompressionService(gpu_config(config or load_config()))
    try:
        svc._codec.freq.probe()
    except BaseException:
        svc.close()
        raise
    return svc
