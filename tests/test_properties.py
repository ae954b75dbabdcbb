"""Property-based tests (parity: the reference's jqwik suite,
``core/HuffmanPropertyTest.java`` — code uniqueness, frequency↔length
monotonicity, completeness over generated frequency arrays) plus round-trip
properties over arbitrary byte strings."""

import numpy as np
from hypothesis import given, settings, strategies as st

from datacomp import native
from datacomp.core import (
    build_codebook,
    decode_bitstream_py,
    encode_bitstream,
    validate_lengths,
)

freq_arrays = st.lists(
    st.integers(min_value=0, max_value=1_000_000), min_size=256, max_size=256
).map(lambda v: np.asarray(v, dtype=np.int64))

byte_strings = st.binary(min_size=0, max_size=20_000)


@settings(max_examples=60, deadline=None)
@given(freq_arrays)
def test_codebook_invariants(freqs):
    lens, codes = build_codebook(freqs)
    # completeness: exactly the used symbols get codes
    assert ((freqs > 0) == (lens > 0)).all()
    assert validate_lengths(lens)
    used = np.nonzero(lens > 0)[0]
    if used.size >= 2:
        # uniqueness within each length class
        for ln in np.unique(lens[used]):
            cs = codes[lens == ln]
            assert len(np.unique(cs)) == len(cs)
        # monotonicity: strictly higher frequency ⇒ length not longer
        f = freqs[used]
        ll = lens[used]
        order = np.argsort(-f, kind="stable")
        sorted_lens = ll[order]
        sorted_f = f[order]
        for i in range(len(order) - 1):
            if sorted_f[i] > sorted_f[i + 1]:
                assert sorted_lens[i] <= sorted_lens[i + 1]


@settings(max_examples=60, deadline=None)
@given(byte_strings)
def test_roundtrip_arbitrary_bytes(blob):
    data = np.frombuffer(blob, dtype=np.uint8)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    lens, codes = build_codebook(hist)
    enc = encode_bitstream(data, lens, codes)
    assert np.array_equal(decode_bitstream_py(enc, data.size, lens), data)
    if native.is_available():
        assert native.encode(data, lens, codes) == enc
        assert np.array_equal(native.decode(enc, data.size, lens), data)


@settings(max_examples=30, deadline=None)
@given(byte_strings, st.integers(min_value=32, max_value=512).map(lambda x: (x // 32) * 32))
def test_gap_decode_matches(blob, subblock):
    if not native.is_available() or len(blob) == 0:
        return
    data = np.frombuffer(blob, dtype=np.uint8)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    lens, codes = build_codebook(hist)
    payload, gaps = native.encode(data, lens, codes, subblock=subblock)
    out = native.decode_gaps(payload, data.size, lens, gaps, subblock)
    assert np.array_equal(out, data)


@settings(max_examples=60, deadline=None)
@given(
    freq_arrays,
    st.integers(min_value=8, max_value=20),
)
def test_length_limited_codebook_properties(freqs, limit):
    """Package-merge cap: limit respected, Kraft-valid, never cheaper than the
    unconstrained optimum, identical when the cap does not bind — and the
    resulting bitstream still round-trips."""
    lens_unl, _ = build_codebook(freqs, mode="fast")
    lens, codes = build_codebook(freqs, mode="fast", max_len=limit)
    assert ((freqs > 0) == (lens > 0)).all()
    assert validate_lengths(lens)
    used = lens > 0
    if used.any():
        assert int(lens[used].max()) <= limit
    f64 = freqs.astype(np.int64)
    cost_unl = int((f64 * lens_unl).sum())
    cost_lim = int((f64 * lens).sum())
    assert cost_lim >= cost_unl
    if int(lens_unl.max()) <= limit:
        assert np.array_equal(lens, lens_unl)

    # encode/decode a stream drawn from these frequencies round-trips
    syms = np.nonzero(freqs > 0)[0]
    if syms.size:
        rng = np.random.default_rng(1)
        p = freqs[syms] / freqs[syms].sum()
        blob = rng.choice(syms, size=512, p=p).astype(np.uint8)
        payload = encode_bitstream(blob, lens, codes)
        out = decode_bitstream_py(payload, blob.size, lens)
        assert np.array_equal(out, blob)
