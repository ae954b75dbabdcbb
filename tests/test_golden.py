"""Golden `.dcz` bitstream fixtures: external-grade bit-exactness pinning.

Round-trip tests alone are self-referential — a silent regression in the
codebook tie-breaks or the MSB-first bit packer would round-trip fine while
breaking parity with the Java reference.  These tests pin the produced BYTES
against fixtures checked in at a known-good state (validated by the
independent OpenJDK-PriorityQueue differential fuzz in test_huffman.py and
the byte-exact java.util.Random input generator), so any change to
``core/huffman.py`` tie-breaks, ``bitio``/native bit order, or
``core/container.py`` layout fails loudly.

Regenerate (only after a deliberate format change): ``python tools/make_golden.py``.
The one-command JVM cross-check against the actual reference is documented in
``docs/GOLDEN_PARITY.md``.
"""

import hashlib
import json
import os

import pytest

from datacomp.config import load_config
from datacomp.services.cpu_service import CpuCompressionService
from datacomp.utils.testdata import generate_bytes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FIXED_MTIME = 1_700_000_000

with open(os.path.join(GOLDEN_DIR, "hashes.json")) as _f:
    HASHES = json.load(_f)


def _compress(tmp_path, name, spec) -> bytes:
    data = generate_bytes(spec["input_kind"], spec["input_size"])
    src = tmp_path / name
    src.write_bytes(data)
    os.utime(src, (FIXED_MTIME, FIXED_MTIME))
    cfg = load_config(compression={
        "chunk_size_mb": spec["chunk_mb"], "format_version": 1,
        "codebook_mode": "java",
    })
    out = str(src) + ".dcz"
    with CpuCompressionService(cfg) as svc:
        svc.compress(str(src), out)
    return open(out, "rb").read()


@pytest.mark.parametrize("name", sorted(HASHES))
def test_compressed_bytes_match_golden(tmp_path, name):
    spec = HASHES[name]
    blob = _compress(tmp_path, name, spec)
    assert len(blob) == spec["dcz_size"], (
        f"{name}: compressed size changed {spec['dcz_size']} -> {len(blob)} "
        "(codebook or packing regression)"
    )
    assert hashlib.sha256(blob).hexdigest() == spec["dcz_sha256"], (
        f"{name}: compressed bytes changed — java-mode v1 bitstream is no "
        "longer bit-identical to the pinned reference-parity state"
    )
    fixture = os.path.join(GOLDEN_DIR, name + ".dcz")
    if os.path.exists(fixture):
        assert blob == open(fixture, "rb").read(), f"{name}: byte mismatch vs fixture"


@pytest.mark.parametrize(
    "name", [n for n in sorted(HASHES) if os.path.exists(os.path.join(GOLDEN_DIR, n + ".dcz"))]
)
def test_golden_archives_decode(tmp_path, name):
    """The checked-in archives must decode to the regenerated inputs —
    catches decoder regressions independently of the encoder."""
    spec = HASHES[name]
    data = generate_bytes(spec["input_kind"], spec["input_size"])
    out = tmp_path / "restored.bin"
    with CpuCompressionService(load_config()) as svc:
        svc.decompress(os.path.join(GOLDEN_DIR, name + ".dcz"), str(out))
        assert svc.verify_integrity(os.path.join(GOLDEN_DIR, name + ".dcz"))
    assert out.read_bytes() == data


class TestHandmadeFixture:
    """Reference-direction fixture: ``handmade_tie_v1.dcz`` was assembled BY
    HAND from the documented container format (tools/make_handmade_golden.py,
    struct+hashlib only — NOT this repo's encoder), so it pins container-level
    parity independent of this repo's writer: a bug the writer and reader
    share cannot hide here."""

    FIXTURE = os.path.join(GOLDEN_DIR, "handmade_tie_v1.dcz")
    CONTENT = b"ABCDEFGH" * 4  # equal frequencies: every optimal code is 3 bits

    def test_generator_is_deterministic(self):
        """The checked-in fixture matches its standalone generator."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "make_handmade_golden",
            os.path.join(os.path.dirname(__file__), "..", "tools",
                         "make_handmade_golden.py"),
        )
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        assert gen.build() == open(self.FIXTURE, "rb").read()

    def test_our_decoder_reads_handmade_container(self, tmp_path):
        cfg = load_config(compression={"chunk_size_mb": 1})
        out = str(tmp_path / "restored.bin")
        with CpuCompressionService(cfg) as svc:
            assert svc.verify_integrity(self.FIXTURE, deep=True)
            svc.decompress(self.FIXTURE, out)
        assert open(out, "rb").read() == self.CONTENT

    def test_our_encoder_reproduces_handmade_container(self, tmp_path):
        src = tmp_path / "handmade_tie.bin"  # header stores the basename
        src.write_bytes(self.CONTENT)
        os.utime(src, (FIXED_MTIME, FIXED_MTIME))
        cfg = load_config(compression={
            "chunk_size_mb": 1, "format_version": 1, "codebook_mode": "java",
        })
        out = str(src) + ".dcz"
        with CpuCompressionService(cfg) as svc:
            svc.compress(str(src), out)
        assert open(out, "rb").read() == open(self.FIXTURE, "rb").read()
