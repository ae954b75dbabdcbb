"""CPU service integration tests (mirrors ``CpuCompressionServiceTest.java``):
compress→decompress→byte-equality on text / random / empty / multi-chunk
inputs, progress callbacks, integrity verification, corruption detection,
resume-from-partial."""

import os

import numpy as np
import pytest

from datacomp.config import load_config
from datacomp.core import read_container
from datacomp.services.cpu_service import CpuCompressionService
from datacomp.services.pipeline import _partial_path, read_partial
from datacomp.utils.testdata import generate_bytes


@pytest.fixture
def svc():
    s = CpuCompressionService(load_config(compression={"chunk_size_mb": 1}))
    yield s
    s.close()


def roundtrip(svc, tmp_path, data: bytes, name="f.bin"):
    src = tmp_path / name
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    out = str(src) + ".out"
    svc.compress(str(src), dcz)
    svc.decompress(dcz, out)
    assert open(out, "rb").read() == data
    return dcz


def test_text_roundtrip(svc, tmp_path):
    dcz = roundtrip(svc, tmp_path, b"The quick brown fox jumps over the lazy dog. " * 100)
    assert os.path.getsize(dcz) < 4500 + 700  # compresses + metadata overhead


def test_random_roundtrip(svc, tmp_path):
    roundtrip(svc, tmp_path, generate_bytes("random", 10 * 1024))


def test_empty_file(svc, tmp_path):
    dcz = roundtrip(svc, tmp_path, b"")
    h, _ = read_container(dcz)
    assert h.num_chunks == 0 and h.original_file_size == 0


def test_multi_chunk_with_progress(svc, tmp_path):
    data = generate_bytes("text", 3 * 1024 * 1024 + 7)
    src = tmp_path / "big.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    calls = []
    svc.compress(str(src), dcz, progress=calls.append)
    assert len(calls) == 4  # ceil(3MB+7 / 1MB)
    assert calls == sorted(calls) and abs(calls[-1] - 1.0) < 1e-9
    h, _ = read_container(dcz)
    assert h.num_chunks == 4
    assert h.chunks[-1].original_size == 7
    out = str(src) + ".out"
    dcalls = []
    svc.decompress(dcz, out, progress=dcalls.append)
    assert open(out, "rb").read() == data
    assert len(dcalls) == 4


def test_verify_integrity(svc, tmp_path):
    dcz = roundtrip(svc, tmp_path, generate_bytes("text", 64 * 1024))
    assert svc.verify_integrity(dcz)
    assert svc.verify_integrity(dcz, deep=True)


def test_corruption_detected_on_decompress(svc, tmp_path):
    data = generate_bytes("text", 256 * 1024)
    src = tmp_path / "c.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    svc.compress(str(src), dcz)
    raw = bytearray(open(dcz, "rb").read())
    raw[100] ^= 0xFF  # flip bits inside chunk 0 payload
    open(dcz, "wb").write(bytes(raw))
    with pytest.raises((IOError, ValueError)):
        svc.decompress(dcz, str(src) + ".out")


def test_metadata_fields(svc, tmp_path):
    data = generate_bytes("compressible", 128 * 1024)
    src = tmp_path / "meta.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    svc.compress(str(src), dcz)
    h, _ = read_container(dcz)
    assert h.original_file_name == "meta.bin"
    assert h.original_file_size == len(data)
    assert h.chunk_size_bytes == 1024 * 1024
    # offsets are contiguous
    off = 0
    for c in h.chunks:
        assert c.compressed_offset == off
        off += c.compressed_size


def test_resume_compression(tmp_path):
    cfg = load_config(compression={"chunk_size_mb": 1})
    svc = CpuCompressionService(cfg)
    data = generate_bytes("text", 4 * 1024 * 1024)
    src = tmp_path / "r.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"

    # simulate an interruption: compress fully, then reconstruct a partial
    # state = first 2 chunks (sidecar kept, footer absent)
    svc.compress(str(src), dcz)
    full = open(dcz, "rb").read()
    h, _ = read_container(dcz)
    cut = h.chunks[1].compressed_offset + h.chunks[1].compressed_size
    # rebuild sidecar for first 2 chunks
    from datacomp.services.pipeline import _write_partial_header, _append_partial_chunk

    with open(_partial_path(dcz), "wb") as f:
        _write_partial_header(f, h)
        for c in h.chunks[:2]:
            _append_partial_chunk(f, c)
    with open(dcz, "wb") as f:
        f.write(full[:cut])  # truncated output: only chunks 0-1

    svc.resume_compression(str(src), dcz, last_completed_chunk=1)
    assert not os.path.exists(_partial_path(dcz))
    out = str(src) + ".out"
    svc.decompress(dcz, out)
    assert open(out, "rb").read() == data
    assert open(dcz, "rb").read() == full  # deterministic: resumed == one-shot
    svc.close()


def test_reference_fixture_files(svc, tmp_path):
    """Round-trip the reference repo's checked-in corpora."""
    for name in ["test_small.bin", "test_input.bin"]:
        path = os.path.join("/root/reference", name)
        if not os.path.exists(path):
            pytest.skip(f"{name} not present")
        data = open(path, "rb").read()
        roundtrip(svc, tmp_path, data, name=name)


def test_raw_store_incompressible_v2(tmp_path):
    """Format v2 stores incompressible chunks raw (all-zero code lengths +
    equal sizes marker), so ratio never exceeds 1 + metadata overhead — the
    reference expands such data (its 3.05 GB video run grew by 104 KB)."""
    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2})
    data = generate_bytes("random", 2 * 1024 * 1024 + 99)
    src = tmp_path / "r.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    with CpuCompressionService(cfg) as svc:
        svc.compress(str(src), dcz)
        h, _ = read_container(dcz)
        # full-size random chunks are stored raw; the 99-byte tail may
        # legitimately compress (few distinct symbols)
        full = [c for c in h.chunks if c.original_size == 1024 * 1024]
        assert full and all(not c.code_lengths.any() for c in full)
        assert all(c.compressed_size == c.original_size for c in full)
        payload_total = sum(c.compressed_size for c in h.chunks)
        assert payload_total <= len(data)  # never expands in v2
        svc.decompress(dcz, str(src) + ".out")
    assert open(str(src) + ".out", "rb").read() == data

    # v1 stays reference-faithful: still Huffman-encodes (slight expansion)
    cfg1 = load_config(compression={"chunk_size_mb": 1, "format_version": 1})
    with CpuCompressionService(cfg1) as svc:
        svc.compress(str(src), str(src) + ".v1.dcz")
        h1, _ = read_container(str(src) + ".v1.dcz")
        assert any(c.code_lengths.any() for c in h1.chunks)


def test_max_code_len_roundtrip_deep_skew(tmp_path):
    """A geometric byte distribution drives optimal codes past 16 bits; the
    max-code-len cap (package-merge) bounds them so v2 chunks stay on the
    device decode path — output must still round-trip and stay format-valid."""
    rng = np.random.default_rng(3)
    # geometric: ~half 0x00, quarter 0x01, ... very deep Huffman tree
    raw = np.minimum(rng.geometric(0.5, 1 << 18) - 1, 200).astype(np.uint8)
    data = raw.tobytes()

    cfg_unl = load_config(compression={"chunk_size_mb": 1, "codebook_mode": "fast"})
    cfg_cap = load_config(
        compression={"chunk_size_mb": 1, "codebook_mode": "fast", "max_code_len": 12}
    )
    with CpuCompressionService(cfg_unl) as s_unl, CpuCompressionService(cfg_cap) as s_cap:
        dcz_u = roundtrip(s_unl, tmp_path, data, "unl.bin")
        dcz_c = roundtrip(s_cap, tmp_path, data, "cap.bin")

    hdr_u, _ = read_container(dcz_u)
    hdr_c, _ = read_container(dcz_c)
    max_u = max(int(np.asarray(c.code_lengths).max()) for c in hdr_u.chunks)
    max_c = max(int(np.asarray(c.code_lengths).max()) for c in hdr_c.chunks)
    assert max_u > 12, "fixture no longer exercises deep codes"
    assert max_c <= 12
    # optimal length-limited: barely any ratio cost on this distribution
    assert os.path.getsize(dcz_c) <= int(1.05 * os.path.getsize(dcz_u))


def test_max_code_len_noop_on_typical_data(tmp_path):
    """Typical text never hits the cap: output must be byte-identical."""
    data = b"The quick brown fox jumps over the lazy dog. " * 500
    cfg_a = load_config(compression={"chunk_size_mb": 1})
    cfg_b = load_config(compression={"chunk_size_mb": 1, "max_code_len": 16})
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with CpuCompressionService(cfg_a) as sa, CpuCompressionService(cfg_b) as sb:
        a = roundtrip(sa, tmp_path / "a", data, "f.bin")
        b = roundtrip(sb, tmp_path / "b", data, "f.bin")
    # footer carries a timestamp; compare payloads and chunk tables instead
    ha, _ = read_container(a)
    hb, _ = read_container(b)
    for ca, cb in zip(ha.chunks, hb.chunks):
        assert np.array_equal(ca.code_lengths, cb.code_lengths)
        assert ca.compressed_size == cb.compressed_size
    na = sum(c.compressed_size for c in ha.chunks)
    assert open(a, "rb").read()[:na] == open(b, "rb").read()[:na]


def test_deep_verify_detects_payload_corruption(tmp_path):
    """deep verify decodes every chunk (in parallel) and must return False —
    not raise — on a corrupted payload byte."""
    from datacomp.config import load_config
    from datacomp.services.cpu_service import CpuCompressionService
    from datacomp.utils.testdata import generate_bytes

    cfg = load_config(compression={"chunk_size_mb": 1})
    src = tmp_path / "v.bin"
    src.write_bytes(generate_bytes("text", 3 * 1024 * 1024))
    dcz = str(src) + ".dcz"
    with CpuCompressionService(cfg) as svc:
        svc.compress(str(src), dcz)
        assert svc.verify_integrity(dcz, deep=True)
        raw = bytearray(open(dcz, "rb").read())
        raw[1000] ^= 0x10  # flip a payload bit in chunk 0
        open(dcz, "wb").write(bytes(raw))
        assert svc.verify_integrity(dcz, deep=True) is False


def test_compress_backpressure_bounds_inflight(tmp_path):
    """Hard backpressure: a 30x-slower head-of-line chunk must not let
    completed-but-unwritten payloads pile up without bound.  The sliding
    submit window caps in-flight chunks (running + finished-unwritten) at
    ``pipeline.window``, matching the reference's bounded sliding-window
    scheduler (``gpu/GpuCompressionService.java:232-320``)."""
    import threading
    import time

    from datacomp.services.cpu_service import CpuChunkCodec
    from datacomp.services.pipeline import ChunkCodec, ChunkedPipeline

    cfg = load_config(compression={"chunk_size_mb": 1})
    chunk = 1024 * 1024
    num_chunks = 16
    data = bytearray(generate_bytes("text", chunk * num_chunks))
    data[0] = 0xAA  # marker byte: the codec blocks on chunk 0 ("text" is ASCII)
    src = tmp_path / "skew.bin"
    src.write_bytes(bytes(data))

    release = threading.Event()
    head_blocked = threading.Event()
    done_while_blocked = []
    lock = threading.Lock()

    class SkewCodec(ChunkCodec):
        """Chunk 0 stalls until released; others count completions that
        happen while the head is still stalled."""

        def __init__(self, inner):
            self.inner = inner

        def encode_chunk(self, d, metrics):
            enc = self.inner.encode_chunk(d, metrics)
            if d.size and d[0] == 0xAA:
                head_blocked.set()
                release.wait(timeout=60)
            elif not release.is_set():
                with lock:
                    done_while_blocked.append(1)
            return enc

        def decode_chunk(self, payload, meta, header, metrics):
            return self.inner.decode_chunk(payload, meta, header, metrics)

    pipe = ChunkedPipeline(cfg, SkewCodec(CpuChunkCodec(cfg)), workers=2)
    dcz = str(src) + ".dcz"
    errors = []

    def run():
        try:
            pipe.compress(str(src), dcz)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        assert head_blocked.wait(timeout=60)
        # drain: with the window full and the head unwritten, no further
        # chunk may even be submitted — wait for the allowed tail to finish
        deadline = time.monotonic() + 10
        cap = pipe.window - 1  # head occupies one window slot
        while time.monotonic() < deadline and len(done_while_blocked) < cap:
            time.sleep(0.05)
        time.sleep(0.75)  # grace period: would-be over-submissions surface here
        assert len(done_while_blocked) <= cap, (
            f"{len(done_while_blocked)} chunks completed while the head was "
            f"blocked; window={pipe.window} should bound in-flight work"
        )
    finally:
        release.set()
        t.join(timeout=120)
    assert not errors, errors
    # ordered output is still correct end to end
    out = str(src) + ".out"
    pipe.decompress(dcz, out)
    pipe.close()
    assert open(out, "rb").read() == bytes(data)


def _rewrite_header_first(dcz: str, legacy: str) -> None:
    """Re-lay a footer-last .dcz as the legacy header-first layout the
    reference also reads (CpuCompressionService.java:328-393): footer at
    offset 0, payloads at the END, no trailing pointer."""
    from datacomp.core import container as ct

    header, data_start = read_container(dcz)
    with open(dcz, "rb") as f:
        f.seek(data_start)
        payloads = f.read(header.total_compressed_size())
    with open(legacy, "wb") as f:
        f.write(ct.serialize_footer(header))
        f.write(payloads)


def test_deep_verify_scan_fallback_layouts(svc, tmp_path, monkeypatch):
    """When the primary container read fails and verify falls back to the
    footer scan, data_start must be derived from the layout the scan found:
    0 for footer-last, fileSize - sum(compressedSize) for legacy header-first
    (payloads at the END) — not assumed 0, which would pread wrong ranges
    and misreport an intact legacy archive as corrupt."""
    from datacomp.core import container as ct

    data = generate_bytes("text", 40 * 1024)  # whole file within scan window
    src = tmp_path / "t.bin"
    src.write_bytes(data)
    dcz = str(src) + ".dcz"
    svc.compress(str(src), dcz)

    # footer-last with a corrupted trailing pointer: scan fallback, data at 0
    broken = str(tmp_path / "broken-pointer.dcz")
    raw = bytearray(open(dcz, "rb").read())
    raw[-8:] = b"\xff" * 8
    open(broken, "wb").write(bytes(raw))
    with pytest.raises(ct.ContainerError):
        read_container(broken)
    assert svc.verify_integrity(broken, deep=True) is True

    # legacy header-first: footer parses at offset 0, payloads at the end
    legacy = str(tmp_path / "legacy.dcz")
    _rewrite_header_first(dcz, legacy)
    assert svc.verify_integrity(legacy, deep=True) is True  # primary read path
    # force the scan fallback (any structural primary-read failure)
    real = ct.read_container

    def boom(path):
        if path == legacy:
            raise ct.ContainerError("simulated primary read failure")
        return real(path)

    monkeypatch.setattr(ct, "read_container", boom)
    assert svc.verify_integrity(legacy, deep=True) is True
    # a truncated legacy archive must fail cleanly, not pread negative offsets
    trunc = str(tmp_path / "legacy-trunc.dcz")
    lraw = open(legacy, "rb").read()
    open(trunc, "wb").write(lraw[: len(lraw) // 2])
    assert svc.verify_integrity(trunc, deep=True) is False
