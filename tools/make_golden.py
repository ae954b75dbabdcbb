"""Regenerate the golden `.dcz` byte fixtures in tests/golden/.

Run from the repo root: ``python tools/make_golden.py``.

The fixtures pin the java-mode v1 bitstream: deterministic inputs (the
byte-exact java.util.Random replica in utils/testdata.py + the reference's
fox/dog pattern), a fixed mtime, fixed basenames, and the reference-exact
codebook tie-breaks.  Any regression in the codebook build, the MSB-first bit
packing, or the container byte layout changes these bytes and fails
``tests/test_golden.py`` loudly.

ONLY regenerate after deliberately changing the v1 format (which would break
reference parity — don't) or the fixture definitions below.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from datacomp.config import load_config  # noqa: E402
from datacomp.services.cpu_service import CpuCompressionService  # noqa: E402
from datacomp.utils.testdata import generate_bytes  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "golden")
FIXED_MTIME = 1_700_000_000  # seconds; header stores ms

#: (name, kind, size, chunk_size_mb) — small ones are checked in verbatim,
#: larger ones as SHA-256 only.  64 KB chunks force multi-chunk coverage.
FIXTURES = [
    ("java_random_4k.bin", "random", 4096, 1),
    ("pattern_8k.bin", "compressible", 8192, 1),
    ("text_48k.bin", "text", 48 * 1024, 1),
    ("skewed_64k.bin", "skewed", 64 * 1024, 1),
]
HASH_ONLY = [
    ("text_4m.bin", "text", 4 * 1024 * 1024, 1),      # 4 chunks
    ("java_random_2m.bin", "random", 2 * 1024 * 1024, 1),
]


def compress_fixture(name: str, kind: str, size: int, chunk_mb: int) -> bytes:
    data = generate_bytes(kind, size)
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, name)
        with open(src, "wb") as f:
            f.write(data)
        os.utime(src, (FIXED_MTIME, FIXED_MTIME))
        cfg = load_config(compression={
            "chunk_size_mb": chunk_mb, "format_version": 1, "codebook_mode": "java",
        })
        out = src + ".dcz"
        with CpuCompressionService(cfg) as svc:
            svc.compress(src, out)
            assert svc.verify_integrity(out)
            restored = src + ".out"
            svc.decompress(out, restored)
            assert open(restored, "rb").read() == data
        return open(out, "rb").read()


def main() -> None:
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    hashes = {}
    for name, kind, size, chunk_mb in FIXTURES:
        blob = compress_fixture(name, kind, size, chunk_mb)
        path = os.path.join(GOLDEN_DIR, name + ".dcz")
        with open(path, "wb") as f:
            f.write(blob)
        hashes[name] = {
            "input_kind": kind, "input_size": size, "chunk_mb": chunk_mb,
            "dcz_size": len(blob),
            "dcz_sha256": hashlib.sha256(blob).hexdigest(),
        }
        print(f"{name}: {size} -> {len(blob)} bytes  {hashes[name]['dcz_sha256'][:16]}")
    for name, kind, size, chunk_mb in HASH_ONLY:
        blob = compress_fixture(name, kind, size, chunk_mb)
        hashes[name] = {
            "input_kind": kind, "input_size": size, "chunk_mb": chunk_mb,
            "dcz_size": len(blob),
            "dcz_sha256": hashlib.sha256(blob).hexdigest(),
        }
        print(f"{name}: {size} -> {len(blob)} bytes  {hashes[name]['dcz_sha256'][:16]} (hash only)")
    with open(os.path.join(GOLDEN_DIR, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=2, sort_keys=True)
    print(f"wrote {GOLDEN_DIR}/hashes.json")


if __name__ == "__main__":
    main()
