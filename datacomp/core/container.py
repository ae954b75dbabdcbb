"""`.dcz` container format reader/writer.

Byte-compatible with the reference's footer-last container
(``core/CompressionHeader.java:51-144``, spec ``docs/FILE_FORMAT.md``):

* compressed chunk payloads written first, concatenated in order;
* footer: ``magic(4) version(4) nameLen(4) name size(8) mtimeMillis(8)
  chunkSize(4) globalSha256(32) numChunks(4)`` then per chunk
  ``index(4) origOffset(8) origSize(4) compOffset(8) compSize(4) sha256(32)
  codeLengths(256×2)`` — all big-endian (Java ``DataOutputStream``);
* final 8 bytes: absolute offset of the footer start (O(1) footer lookup).

The legacy header-first layout (header at offset 0, payloads at
``fileSize − ΣcompressedSize``) is supported on read, mirroring
``service/cpu/CpuCompressionService.java:328-393``.

Version 2 (this framework's extension, rejected cleanly by the reference's
version check) appends a per-chunk *gap array* — the absolute bit offset of
every sub-block of ``subblock_symbols`` input bytes — enabling massively
parallel decode on the device (per arXiv:2010.10039, bundled with the reference).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional

import numpy as np

MAGIC = 0x44435A46  # "DCZF"
VERSION_V1 = 1
VERSION_V2 = 2
SHA256_LEN = 32
ALPHABET_SIZE = 256
FOOTER_POINTER_LEN = 8
#: fixed per-chunk metadata size in v1 (4+8+4+8+4+32+512)
CHUNK_META_LEN_V1 = 572


class ContainerError(ValueError):
    pass


class TruncatedFooter(ContainerError):
    """Footer parse ran off the end of the supplied bytes (the buffer may
    simply be too small — distinguishable from structural corruption so the
    header-first probe can grow its prefix instead of giving up)."""


@dataclass
class ChunkMeta:
    index: int
    original_offset: int
    original_size: int
    compressed_offset: int
    compressed_size: int
    sha256: bytes
    code_lengths: np.ndarray  # int32[256]
    # v2 only: bit offset of each sub-block of `subblock_symbols` input bytes
    gap_bits: Optional[np.ndarray] = None  # uint32[num_subblocks]

    def __post_init__(self):
        if len(self.sha256) != SHA256_LEN:
            raise ContainerError("chunk sha256 must be 32 bytes")
        self.code_lengths = np.asarray(self.code_lengths, dtype=np.int32)
        if self.code_lengths.shape != (ALPHABET_SIZE,):
            raise ContainerError("code_lengths must have 256 entries")


@dataclass
class ContainerHeader:
    original_file_name: str
    original_file_size: int
    original_timestamp: int  # epoch millis, like java File mtime
    global_sha256: bytes
    chunk_size_bytes: int
    version: int = VERSION_V1
    subblock_symbols: int = 0  # v2 only
    chunks: List[ChunkMeta] = field(default_factory=list)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def total_compressed_size(self) -> int:
        return sum(c.compressed_size for c in self.chunks)


def serialize_footer(h: ContainerHeader) -> bytes:
    out = io.BytesIO()
    name_bytes = h.original_file_name.encode("utf-8")
    out.write(struct.pack(">iii", MAGIC, h.version, len(name_bytes)))
    out.write(name_bytes)
    out.write(struct.pack(">qqi", h.original_file_size, h.original_timestamp, h.chunk_size_bytes))
    if len(h.global_sha256) != SHA256_LEN:
        raise ContainerError("global sha256 must be 32 bytes")
    out.write(h.global_sha256)
    if h.version >= VERSION_V2:
        out.write(struct.pack(">i", h.subblock_symbols))
    out.write(struct.pack(">i", len(h.chunks)))
    for c in h.chunks:
        out.write(
            struct.pack(
                ">iqiqi",
                c.index,
                c.original_offset,
                c.original_size,
                c.compressed_offset,
                c.compressed_size,
            )
        )
        out.write(c.sha256)
        out.write(c.code_lengths.astype(">i2").tobytes())
        if h.version >= VERSION_V2:
            gaps = c.gap_bits if c.gap_bits is not None else np.zeros(0, np.uint32)
            out.write(struct.pack(">i", len(gaps)))
            out.write(np.asarray(gaps, dtype=">u4").tobytes())
    return out.getvalue()


class _Reader:
    """Bounded big-endian reader that raises on truncation (mirrors
    DataInputStream EOF behavior)."""

    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise TruncatedFooter("truncated footer")
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]


def parse_footer(data: bytes, off: int = 0) -> ContainerHeader:
    r = _Reader(data, off)
    magic = r.i32()
    if magic != MAGIC:
        raise ContainerError("invalid file format: bad magic number")
    version = r.i32()
    if version not in (VERSION_V1, VERSION_V2):
        raise ContainerError(f"unsupported version: {version}")
    name_len = r.i32()
    if name_len < 0 or name_len > 65536:
        raise ContainerError("implausible filename length")
    try:
        name = r.take(name_len).decode("utf-8")
    except UnicodeDecodeError as e:  # corrupted name bytes, not a crash
        raise ContainerError(f"invalid filename encoding: {e}") from e
    file_size = r.i64()
    timestamp = r.i64()
    chunk_size = r.i32()
    global_sha = r.take(SHA256_LEN)
    subblock_symbols = r.i32() if version >= VERSION_V2 else 0
    num_chunks = r.i32()
    if num_chunks < 0:
        raise ContainerError("negative chunk count")
    h = ContainerHeader(
        original_file_name=name,
        original_file_size=file_size,
        original_timestamp=timestamp,
        global_sha256=global_sha,
        chunk_size_bytes=chunk_size,
        version=version,
        subblock_symbols=subblock_symbols,
    )
    for _ in range(num_chunks):
        index = r.i32()
        orig_off = r.i64()
        orig_size = r.i32()
        comp_off = r.i64()
        comp_size = r.i32()
        sha = r.take(SHA256_LEN)
        lens = np.frombuffer(r.take(2 * ALPHABET_SIZE), dtype=">i2").astype(np.int32)
        gaps = None
        if version >= VERSION_V2:
            ngaps = r.i32()
            if ngaps < 0:
                raise ContainerError("negative gap count")
            gaps = np.frombuffer(r.take(4 * ngaps), dtype=">u4").astype(np.uint32)
        h.chunks.append(
            ChunkMeta(index, orig_off, orig_size, comp_off, comp_size, sha, lens, gaps)
        )
    return h


def write_container(
    fp: BinaryIO, header: ContainerHeader, payloads: List[bytes]
) -> None:
    """Write payloads + footer + 8-byte footer pointer (footer-last layout)."""
    pos = 0
    for p in payloads:
        fp.write(p)
        pos += len(p)
    footer_start = pos
    fp.write(serialize_footer(header))
    fp.write(struct.pack(">q", footer_start))


#: initial header-first probe prefix (grown only while the parse reports
#: truncation, so footer-last archives cost exactly one small read here)
_PROBE_PREFIX = 4096


def _probe_header_first(f: BinaryIO, total: int) -> Optional[ContainerHeader]:
    """Bounded probe for the legacy header-first layout: reads a small prefix
    and grows it only while the footer parse reports truncation (never the
    whole file unless the footer genuinely spans it)."""
    f.seek(0)
    if total < 4 or f.read(4) != struct.pack(">i", MAGIC):
        return None
    size = min(_PROBE_PREFIX, total)
    while True:
        f.seek(0)
        try:
            h = parse_footer(f.read(size))
        except TruncatedFooter:
            if size >= total:
                return None
            size = min(size * 8, total)
            continue
        except ContainerError:
            return None
        if total - h.total_compressed_size() < 0:
            return None
        return h


def read_container_fp(f: BinaryIO):
    """Parse an open ``.dcz`` stream → ``(header, data_start)`` reading only
    O(footer) bytes: a bounded header-first probe, then the trailing 8-byte
    pointer + seek to the footer.  This matches the reference's O(1) footer
    access (``CpuCompressionService.java:365-388``; its footer-last layout
    exists precisely so multi-GB archives never get slurped,
    ``docs/FILE_FORMAT.md:253-259``)."""
    f.seek(0, 2)
    total = f.tell()
    # Old header-first layout (header at offset 0, payloads at the end)
    h = _probe_header_first(f, total)
    if h is not None:
        return h, total - h.total_compressed_size()
    if total < FOOTER_POINTER_LEN:
        raise ContainerError("file too small for a .dcz container")
    f.seek(total - FOOTER_POINTER_LEN)
    (footer_start,) = struct.unpack(">q", f.read(FOOTER_POINTER_LEN))
    if footer_start < 0 or footer_start >= total - FOOTER_POINTER_LEN:
        raise ContainerError(f"invalid footer position: {footer_start}")
    f.seek(footer_start)
    h = parse_footer(f.read(total - FOOTER_POINTER_LEN - footer_start))
    return h, 0


def read_container(path: str):
    """Return ``(header, data_start)`` supporting both layouts.

    Mirrors the reference's dual-format probe
    (``CpuCompressionService.java:333-393``): try header-first at offset 0,
    else read the trailing 8-byte footer pointer.  Reads O(footer) bytes,
    not O(file) — see :func:`read_container_fp`.
    """
    with open(path, "rb") as f:
        return read_container_fp(f)


def scan_for_footer(path: str, window: int = 64 * 1024):
    """Scan the last ``window`` bytes for a parsable footer (integrity-check
    fallback, mirroring ``CpuCompressionService.verifyIntegrity:644-696``).
    Candidate offsets come from searching for the big-endian magic, not from
    attempting a parse at every byte position.

    Returns ``(header, footer_abs_offset)`` or ``None``.  The absolute file
    offset where the footer parsed tells the caller which layout it found:
    offset 0 is the legacy header-first layout (payloads at the END of the
    file, ``CpuCompressionService.java:328-393``), anything else is the
    footer-last layout (payloads start at offset 0)."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        total = f.tell()
        w = min(window, total)
        f.seek(total - w)
        buf = f.read(w)
    magic_be = struct.pack(">i", MAGIC)
    off = buf.find(magic_be)
    while off != -1:
        try:
            h = parse_footer(buf, off)
            if h.num_chunks > 0 and h.original_file_size > 0:
                return h, total - w + off
        except ContainerError:
            pass
        off = buf.find(magic_be, off + 1)
    return None
