"""Bitstream encode/decode tests: bit-exact MSB-first order, numpy vs native
C++ cross-validation, round trips on varied data shapes."""

import numpy as np
import pytest

from datacomp import native
from datacomp.core import (
    build_codebook,
    decode_bitstream_py,
    encode_bitstream,
    encoded_size_bits,
)


def mk(data):
    data = np.asarray(data, dtype=np.uint8)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    lens, codes = build_codebook(hist)
    return data, lens, codes


def reference_serial_encode(data, lens, codes):
    """Bit-by-bit oracle mimicking the reference BitOutputStream exactly."""
    bits = []
    for b in data:
        l, c = int(lens[b]), int(codes[b])
        for i in range(l - 1, -1, -1):
            bits.append((c >> i) & 1)
    out = bytearray()
    cur, n = 0, 0
    for bit in bits:
        cur = (cur << 1) | bit
        n += 1
        if n == 8:
            out.append(cur)
            cur, n = 0, 0
    if n:
        out.append(cur << (8 - n))
    return bytes(out)


CASES = {
    "ascii": b"hello huffman world, hello again and again",
    "single": b"A" * 333,
    "two-sym": bytes([0, 255] * 100 + [0] * 50),
    "all-bytes": bytes(range(256)) * 3,
    "one-byte": b"x",
}


@pytest.mark.parametrize("name", list(CASES))
def test_numpy_encode_matches_serial_oracle(name):
    data, lens, codes = mk(np.frombuffer(CASES[name], np.uint8))
    assert encode_bitstream(data, lens, codes) == reference_serial_encode(data, lens, codes)


@pytest.mark.parametrize("name", list(CASES))
def test_native_encode_matches_numpy(name):
    if not native.is_available():
        pytest.skip("native codec unavailable")
    data, lens, codes = mk(np.frombuffer(CASES[name], np.uint8))
    assert native.encode(data, lens, codes) == encode_bitstream(data, lens, codes)


@pytest.mark.parametrize("name", list(CASES))
def test_roundtrip_py_decoder(name):
    data, lens, codes = mk(np.frombuffer(CASES[name], np.uint8))
    enc = encode_bitstream(data, lens, codes)
    assert np.array_equal(decode_bitstream_py(enc, data.size, lens), data)


@pytest.mark.parametrize("name", list(CASES))
def test_roundtrip_native_decoder(name):
    if not native.is_available():
        pytest.skip("native codec unavailable")
    data, lens, codes = mk(np.frombuffer(CASES[name], np.uint8))
    enc = encode_bitstream(data, lens, codes)
    assert np.array_equal(native.decode(enc, data.size, lens), data)


def test_random_roundtrips(rng):
    if not native.is_available():
        pytest.skip("native codec unavailable")
    for _ in range(20):
        n = int(rng.integers(1, 60_000))
        nsym = int(rng.integers(1, 257))
        data = rng.integers(0, nsym, n).astype(np.uint8)
        data, lens, codes = mk(data)
        enc = encode_bitstream(data, lens, codes)
        assert len(enc) == (encoded_size_bits(data, lens) + 7) // 8
        assert native.encode(data, lens, codes) == enc
        assert np.array_equal(native.decode(enc, n, lens), data)


def test_long_codes_roundtrip():
    """Fibonacci-like frequencies force deep (>16-bit) codes, exercising the
    native decoder's long-code fallback path."""
    f = np.zeros(256, dtype=np.int64)
    a, b = 1, 1
    for s in range(24):
        f[s] = a
        a, b = b, a + b
    lens, codes = build_codebook(f)
    assert lens.max() > 16
    data = np.repeat(np.arange(24, dtype=np.uint8), 3)
    enc = encode_bitstream(data, lens, codes)
    assert np.array_equal(decode_bitstream_py(enc, data.size, lens), data)
    if native.is_available():
        assert native.encode(data, lens, codes) == enc
        assert np.array_equal(native.decode(enc, data.size, lens), data)


def test_empty_input():
    data, lens, codes = mk(np.zeros(0, dtype=np.uint8))
    assert encode_bitstream(data, lens, codes) == b""
    assert decode_bitstream_py(b"", 0, lens).size == 0


def test_corrupt_stream_detected():
    if not native.is_available():
        pytest.skip("native codec unavailable")
    # deep codebook so invalid prefixes exist
    f = np.zeros(256, dtype=np.int64)
    a, b = 1, 1
    for s in range(24):
        f[s] = a
        a, b = b, a + b
    lens, codes = build_codebook(f)
    data = np.repeat(np.arange(24, dtype=np.uint8), 5)
    enc = bytearray(encode_bitstream(data, lens, codes))
    enc = enc[: len(enc) // 2]  # truncate -> runs out of bits
    with pytest.raises(ValueError):
        native.decode(bytes(enc), data.size, lens)


def _gap_roundtrip(data, subblock):
    data = np.asarray(data, dtype=np.uint8)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    lens, codes = build_codebook(hist)
    payload, gaps = native.encode(data, lens, codes, subblock=subblock)
    out = native.decode_gaps(payload, data.size, lens, gaps, subblock)
    assert np.array_equal(out, data), (
        f"gap decode mismatch at {np.nonzero(out != data)[0][:5]}"
    )


def test_gap_decode_cursor_boundary_clobber():
    """Regression: a cursor's lone final symbol must not speculatively write
    into the next cursor's span.  Constructed so cursor 0's span ends with a
    9-bit code followed by a 9-bit first symbol of cursor 1 (combined > 16
    bits => no multi-symbol table entry covers the boundary), landing on a
    lone final step.  A buggy decoder zeroes out[256]."""
    if not native.is_available():
        pytest.skip("native codec unavailable")
    sb, n = 32, 1024  # ngaps=32, 4 cursors, spans of 256 symbols
    data = np.zeros(n, dtype=np.uint8)
    filler = np.array([s for s in range(1, 256) if s not in (5, 6, 7)], np.uint8)
    data[768:768 + filler.size] = filler  # all other symbols appear once
    data[254] = 6  # 9-bit; forces the final step to land on index 255 alone
    data[255] = 5  # last symbol of cursor-0 span
    data[256] = 7  # first symbol of cursor-1 span — the clobber target
    _gap_roundtrip(data, sb)


@pytest.mark.parametrize("ngaps", [1, 2, 3, 4, 5, 7, 8, 9, 31])
def test_gap_decode_span_splits(ngaps):
    """Every cursor-count regime: fewer sub-blocks than cursors (pure drain),
    exactly W, imbalanced remainders."""
    if not native.is_available():
        pytest.skip("native codec unavailable")
    sb = 64
    n = sb * (ngaps - 1) + sb // 2 + 1  # last sub-block partial
    rng = np.random.default_rng(1234 + ngaps)
    data = rng.integers(0, 11, n).astype(np.uint8) ** 2  # skewed, 11 symbols
    _gap_roundtrip(data, sb)


def test_gap_decode_long_codes():
    """Deep (>16-bit) codes exercise the joint fast loop's escape path."""
    if not native.is_available():
        pytest.skip("native codec unavailable")
    f = np.zeros(256, dtype=np.int64)
    a, b = 1, 1
    for s in range(24):
        f[s] = a
        a, b = b, a + b
    lens, codes = build_codebook(f)
    assert lens.max() > 16
    rng = np.random.default_rng(7)
    # sample symbols proportional to their frequencies so deep codes appear
    data = rng.choice(24, size=4096, p=f[:24] / f.sum()).astype(np.uint8)
    sb = 256
    payload, gaps = native.encode(data, lens, codes, subblock=sb)
    out = native.decode_gaps(payload, data.size, lens, gaps, sb)
    assert np.array_equal(out, data)


def test_gap_decode_corrupt_rejected():
    """Bit-flipped / truncated / garbage payloads must raise, not crash or
    read out of bounds (the canonical scans check both code bounds)."""
    if not native.is_available():
        pytest.skip("native codec unavailable")
    f = np.zeros(256, dtype=np.int64)
    a, b = 1, 1
    for s in range(24):
        f[s] = a
        a, b = b, a + b
    lens, codes = build_codebook(f)
    rng = np.random.default_rng(3)
    data = rng.choice(24, size=2048, p=f[:24] / f.sum()).astype(np.uint8)
    sb = 128
    payload, gaps = native.encode(data, lens, codes, subblock=sb)
    for bad in (
        payload[: len(payload) // 3],              # truncation
        bytes(len(payload)),                       # all zeros
        bytes(0xFF for _ in range(len(payload))),  # all ones
    ):
        try:
            out = native.decode_gaps(bad, data.size, lens, gaps, sb)
            # decoding garbage may "succeed" syntactically; it must at least
            # not match the original (integrity is SHA-256's job upstream)
            assert not np.array_equal(out, data)
        except ValueError:
            pass
    # corrupt gap metadata
    with pytest.raises(ValueError):
        native.decode_gaps(payload, data.size, lens,
                           np.full_like(gaps, 0xFFFFFFF0), sb)


def test_gap_decode_fuzz_roundtrips(rng):
    if not native.is_available():
        pytest.skip("native codec unavailable")
    for _ in range(15):
        n = int(rng.integers(1, 40_000))
        nsym = int(rng.integers(1, 257))
        sb = int(rng.choice([16, 64, 256, 4096]))
        data = rng.integers(0, nsym, n).astype(np.uint8)
        _gap_roundtrip(data, sb)
