"""`.dcz` container format tests: exact byte layout vs the reference spec
(``docs/FILE_FORMAT.md``, ``core/CompressionHeader.java:51-144``), footer-last
+ legacy header-first reads, v2 gap-array extension."""

import io
import struct

import numpy as np
import pytest

from datacomp.core import (
    CHUNK_META_LEN_V1,
    MAGIC,
    ChunkMeta,
    ContainerError,
    ContainerHeader,
    parse_footer,
    read_container,
    read_container_fp,
    scan_for_footer,
    serialize_footer,
    write_container,
)


def mk_header(nchunks=2, version=1, name="input.bin"):
    h = ContainerHeader(
        original_file_name=name,
        original_file_size=nchunks * 100,
        original_timestamp=1_700_000_000_123,
        global_sha256=bytes(range(32)),
        chunk_size_bytes=100,
        version=version,
        subblock_symbols=64 if version >= 2 else 0,
    )
    off = 0
    for i in range(nchunks):
        lens = np.zeros(256, dtype=np.int32)
        lens[i] = 8
        gaps = np.arange(3, dtype=np.uint32) if version >= 2 else None
        h.chunks.append(ChunkMeta(i, i * 100, 100, off, 50 + i, bytes([i]) * 32, lens, gaps))
        off += 50 + i
    return h


def test_footer_byte_layout_v1_exact():
    """Field-by-field check of the serialized footer against the Java
    DataOutputStream layout."""
    h = mk_header(nchunks=1)
    buf = serialize_footer(h)
    name = b"input.bin"
    assert buf[:4] == struct.pack(">i", MAGIC)
    assert buf[4:8] == struct.pack(">i", 1)
    assert buf[8:12] == struct.pack(">i", len(name))
    assert buf[12 : 12 + len(name)] == name
    p = 12 + len(name)
    assert buf[p : p + 8] == struct.pack(">q", 100)
    assert buf[p + 8 : p + 16] == struct.pack(">q", 1_700_000_000_123)
    assert buf[p + 16 : p + 20] == struct.pack(">i", 100)
    assert buf[p + 20 : p + 52] == bytes(range(32))
    assert buf[p + 52 : p + 56] == struct.pack(">i", 1)
    # per-chunk record is exactly 572 bytes in v1
    assert len(buf) == p + 56 + CHUNK_META_LEN_V1
    chunk = buf[p + 56 :]
    assert chunk[:4] == struct.pack(">i", 0)  # index
    assert chunk[4:12] == struct.pack(">q", 0)  # original offset
    assert chunk[12:16] == struct.pack(">i", 100)  # original size
    assert chunk[16:24] == struct.pack(">q", 0)  # compressed offset
    assert chunk[24:28] == struct.pack(">i", 50)  # compressed size
    assert chunk[28:60] == bytes([0]) * 32
    lens = np.frombuffer(chunk[60:572], dtype=">i2")
    assert lens[0] == 8 and (lens[1:] == 0).all()


@pytest.mark.parametrize("version", [1, 2])
def test_footer_roundtrip(version):
    h = mk_header(nchunks=3, version=version)
    h2 = parse_footer(serialize_footer(h))
    assert h2.original_file_name == h.original_file_name
    assert h2.original_file_size == h.original_file_size
    assert h2.original_timestamp == h.original_timestamp
    assert h2.chunk_size_bytes == h.chunk_size_bytes
    assert h2.global_sha256 == h.global_sha256
    assert h2.version == version
    assert h2.num_chunks == 3
    for a, b in zip(h.chunks, h2.chunks):
        assert (a.index, a.original_offset, a.original_size) == (
            b.index, b.original_offset, b.original_size)
        assert (a.compressed_offset, a.compressed_size) == (b.compressed_offset, b.compressed_size)
        assert a.sha256 == b.sha256
        assert np.array_equal(a.code_lengths, b.code_lengths)
        if version >= 2:
            assert np.array_equal(a.gap_bits, b.gap_bits)


def test_footer_last_file_layout(tmp_path):
    h = mk_header(nchunks=2)
    payloads = [b"a" * 50, b"b" * 51]
    p = tmp_path / "x.dcz"
    with open(p, "wb") as f:
        write_container(f, h, payloads)
    raw = p.read_bytes()
    # payloads first
    assert raw[:50] == b"a" * 50 and raw[50:101] == b"b" * 51
    # trailing 8 bytes point at the footer start
    (ptr,) = struct.unpack(">q", raw[-8:])
    assert ptr == 101
    h2, data_start = read_container(str(p))
    assert data_start == 0 and h2.num_chunks == 2


def test_legacy_header_first_read(tmp_path):
    """Reference dual-format probe: header at offset 0, payloads at
    fileSize − ΣcompressedSize."""
    h = mk_header(nchunks=2)
    payloads = [b"a" * 50, b"b" * 51]
    p = tmp_path / "legacy.dcz"
    with open(p, "wb") as f:
        f.write(serialize_footer(h))
        for pl in payloads:
            f.write(pl)
    h2, data_start = read_container(str(p))
    assert h2.num_chunks == 2
    assert data_start == p.stat().st_size - 101


def test_bad_magic_rejected():
    h = mk_header()
    buf = bytearray(serialize_footer(h))
    buf[0] = 0xFF
    with pytest.raises(ContainerError):
        parse_footer(bytes(buf))


def test_unsupported_version_rejected():
    h = mk_header()
    buf = bytearray(serialize_footer(h))
    buf[4:8] = struct.pack(">i", 99)
    with pytest.raises(ContainerError):
        parse_footer(bytes(buf))


def test_truncated_footer_rejected():
    h = mk_header()
    buf = serialize_footer(h)
    with pytest.raises(ContainerError):
        parse_footer(buf[: len(buf) - 10])


def test_invalid_footer_pointer(tmp_path):
    p = tmp_path / "bad.dcz"
    p.write_bytes(b"x" * 100 + struct.pack(">q", 10_000))
    with pytest.raises(ContainerError):
        read_container(str(p))


def test_utf8_filename():
    h = mk_header(name="données_压缩.bin")
    h2 = parse_footer(serialize_footer(h))
    assert h2.original_file_name == "données_压缩.bin"


class _CountingFile(io.BytesIO):
    """BytesIO that records how many bytes each read returned."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.bytes_read = 0

    def read(self, n=-1):
        b = super().read(n)
        self.bytes_read += len(b)
        return b


def test_read_container_is_o_footer():
    """A footer-last archive parse must read O(footer) bytes, never the
    payload (reference parity: the footer-last layout's entire point,
    ``docs/FILE_FORMAT.md:253-259``)."""
    h = mk_header(nchunks=4)
    payload = b"\xAB" * (32 << 20)  # 32 MB payload the reader must not touch
    # make metadata self-consistent with the giant payload
    for c in h.chunks:
        c.compressed_size = len(payload) // 4
        c.compressed_offset = c.index * (len(payload) // 4)
    buf = io.BytesIO()
    write_container(buf, h, [payload])
    f = _CountingFile(buf.getvalue())
    h2, data_start = read_container_fp(f)
    assert h2.num_chunks == 4 and data_start == 0
    footer_len = len(serialize_footer(h))
    # probe prefix + pointer + footer — nowhere near the 32 MB payload
    assert f.bytes_read <= footer_len + 8 + 8192, f.bytes_read


def test_read_container_header_first_bounded_probe():
    """Legacy header-first reads grow the prefix only to the footer size."""
    h = mk_header(nchunks=40)  # footer ≈ 23 KB > the 4 KB initial probe
    payloads = [b"p" * c.compressed_size for c in h.chunks]
    buf = io.BytesIO()
    buf.write(serialize_footer(h))
    for p in payloads:
        buf.write(p)
    buf.write(b"\xCD" * (8 << 20))  # trailing junk payload space
    f = _CountingFile(buf.getvalue())
    h2, data_start = read_container_fp(f)
    assert h2.num_chunks == 40
    footer_len = len(serialize_footer(h))
    assert f.bytes_read <= 8 * footer_len + 8192, f.bytes_read


def test_scan_for_footer_finds_valid_footer(tmp_path):
    h = mk_header(nchunks=2)
    p = tmp_path / "x.dcz"
    with open(p, "wb") as f:
        write_container(f, h, [b"a" * 50, b"b" * 51])
    found = scan_for_footer(str(p))
    assert found is not None
    fh, off = found
    assert fh.num_chunks == 2 and off == 101  # footer right after the payloads


def test_scan_for_footer_skips_decoy_magic(tmp_path):
    """Magic bytes inside the payload must not derail the scan."""
    h = mk_header(nchunks=2)
    decoy = struct.pack(">i", MAGIC) * 5
    p = tmp_path / "decoy.dcz"
    with open(p, "wb") as f:
        write_container(f, h, [decoy + b"a" * 34, b"b" * 51])
    found = scan_for_footer(str(p))
    assert found is not None
    fh, off = found
    assert fh.num_chunks == 2 and off == 105
    assert fh.original_file_name == "input.bin"


def test_scan_for_footer_no_footer(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"\x00" * 4096)
    assert scan_for_footer(str(p)) is None


def test_parse_footer_fuzz_never_crashes(rng):
    """Random bytes, bit-flipped footers, and truncations must raise
    ContainerError (or parse to something) — never IndexError/struct.error/
    hangs.  Guards the error paths of the stored-format parser."""
    h = mk_header(nchunks=3, version=2)
    good = serialize_footer(h)
    for _ in range(300):
        buf = bytearray(good)
        kind = rng.integers(0, 3)
        if kind == 0:  # random corruption
            for _ in range(int(rng.integers(1, 8))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        elif kind == 1:  # truncation
            buf = buf[: int(rng.integers(0, len(buf)))]
        else:  # random garbage
            buf = bytearray(rng.integers(0, 256, int(rng.integers(0, 200))).astype("u1").tobytes())
        try:
            parse_footer(bytes(buf))
        except ContainerError:
            pass


def test_read_container_fuzz_files(tmp_path, rng):
    """Corrupted container FILES must raise ContainerError or IOError."""
    h = mk_header(nchunks=2)
    p = tmp_path / "f.dcz"
    with open(p, "wb") as f:
        write_container(f, h, [b"a" * 50, b"b" * 51])
    good = p.read_bytes()
    for trial in range(40):
        buf = bytearray(good)
        if trial % 2 == 0:
            buf = buf[: int(rng.integers(0, len(buf)))]
        else:
            for _ in range(int(rng.integers(1, 6))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        q = tmp_path / f"fz{trial}.dcz"
        q.write_bytes(bytes(buf))
        try:
            read_container(str(q))
        except (ContainerError, OSError):
            pass
