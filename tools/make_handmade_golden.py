#!/usr/bin/env python3
"""Hand-construct a reference-direction golden `.dcz` fixture.

Every other golden fixture in ``tests/golden/`` was produced by THIS repo's
encoder, so they pin regressions but cannot catch a bug this repo's writer
and reader share.  This script assembles a minimal v1 container **by hand**
from the reference's documented format (reference ``docs/FILE_FORMAT.md:15-135``,
``core/CompressionHeader.java:51-85``) using nothing but ``struct`` and
``hashlib`` — no datacomp imports — pinning container-level parity
independent of this repo's code:

* payload: canonical-Huffman bitstream hand-derived below (MSB-first bit
  order, ``cpu/CpuCompressionService.java:716-728``);
* footer: magic ``0x44435A46`` "DCZF", version 1, name, size, mtime millis,
  chunk size, global SHA-256 (= SHA-256 over the per-chunk digests in order,
  ``CpuCompressionService.java:101-126``), chunk table (572 B/chunk:
  index i32, origOffset i64, origSize i32, compOffset i64, compSize i32,
  sha 32 B, 256 big-endian i16 code lengths) — all big-endian;
* trailing 8-byte footer pointer.

Content is maximally tie-heavy yet length-deterministic: eight symbols
'A'..'H' with EQUAL frequency 4.  Every optimal Huffman code (any tie-break)
assigns all eight a 3-bit length, so the expected code lengths are derivable
by hand, while the canonical assignment rule (same-length codes consecutive
by symbol: A=000 … H=111) and the bit/byte packing are fully pinned.

Writes ``tests/golden/handmade_tie_v1.dcz``.  Tests assert this repo's
decoder decodes it AND this repo's encoder reproduces it byte-for-byte.
"""

import hashlib
import struct
import sys

NAME = "handmade_tie.bin"
MTIME_MILLIS = 1_700_000_000_000  # matches FIXED_MTIME in tests/test_golden.py
CHUNK_SIZE = 1 << 20  # 1 MB


def content() -> bytes:
    return b"ABCDEFGH" * 4  # eight symbols, equal frequency 4 each


def payload() -> bytes:
    """Hand-packed canonical bitstream: A..H -> 000..111, MSB-first."""
    bits = ""
    for b in content():
        bits += format(b - ord("A"), "03b")
    assert len(bits) % 8 == 0  # 96 bits
    return bytes(int(bits[i : i + 8], 2) for i in range(0, len(bits), 8))


def build() -> bytes:
    data = content()
    pay = payload()
    chunk_sha = hashlib.sha256(data).digest()
    global_sha = hashlib.sha256(chunk_sha).digest()  # digest of chunk digests

    lengths = [0] * 256
    for s in range(ord("A"), ord("H") + 1):
        lengths[s] = 3

    footer = struct.pack(">iii", 0x44435A46, 1, len(NAME)) + NAME.encode()
    footer += struct.pack(">qqi", len(data), MTIME_MILLIS, CHUNK_SIZE)
    footer += global_sha
    footer += struct.pack(">i", 1)  # numChunks
    footer += struct.pack(">iqiqi", 0, 0, len(data), 0, len(pay))
    footer += chunk_sha
    footer += b"".join(struct.pack(">h", ln) for ln in lengths)

    return pay + footer + struct.pack(">q", len(pay))


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "tests/golden/handmade_tie_v1.dcz"
    blob = build()
    with open(out, "wb") as f:
        f.write(blob)
    print(f"wrote {out} ({len(blob)} bytes, payload {len(payload())} B)")
