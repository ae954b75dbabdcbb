"""Device-op tests (run on the CPU backend via conftest): histogram, on-device
codebook, encoder bit-exactness vs the host oracle, gap-array decoder."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from datacomp.core import build_codebook, encode_bitstream  # noqa: E402
from datacomp.core.huffman import (  # noqa: E402
    build_code_lengths,
    canonical_codes_from_lengths,
    validate_lengths,
)
from datacomp.ops import (  # noqa: E402
    build_decode_tables,
    decode_device,
    device_canonical_codes,
    device_code_lengths,
    histogram_device,
    payload_to_words,
    words_to_bytes,
)
from datacomp.ops.encode_scan_oracle import (  # noqa: E402 — test oracle
    encode_device_scan_oracle,
)
from datacomp.utils.testdata import generate_bytes  # noqa: E402


class TestHistogram:
    @pytest.mark.parametrize("n,cap", [(1000, 1024), (65536, 65536), (0, 512), (1, 8)])
    def test_matches_bincount(self, rng, n, cap):
        data = rng.integers(0, 256, cap).astype(np.uint8)
        h = np.asarray(histogram_device(jnp.asarray(data), jnp.int32(n)))
        assert np.array_equal(h, np.bincount(data[:n], minlength=256))

    def test_multi_tile_path(self, rng):
        data = rng.integers(0, 256, 1 << 17).astype(np.uint8)
        h = np.asarray(histogram_device(jnp.asarray(data), jnp.int32(data.size), tile=1 << 14))
        assert np.array_equal(h, np.bincount(data, minlength=256))


class TestCompilationCache:
    def test_default_dir_is_fixed_in_checkout(self):
        import os

        import datacomp
        from datacomp.ops import DEFAULT_CACHE_DIR

        checkout = os.path.dirname(os.path.dirname(os.path.abspath(datacomp.__file__)))
        assert DEFAULT_CACHE_DIR == os.path.join(checkout, ".jax_cache")

    @pytest.mark.parametrize("env_dir", [None, "custom"])
    def test_env_var_honoured(self, tmp_path, env_dir):
        """``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise importing
        the ops points the cache at the fixed in-checkout path."""
        import os
        import subprocess
        import sys

        from datacomp.ops import DEFAULT_CACHE_DIR

        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        want = DEFAULT_CACHE_DIR
        if env_dir:
            want = str(tmp_path / env_dir)
            env["JAX_COMPILATION_CACHE_DIR"] = want
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(
            [sys.executable, "-c",
             "import jax, datacomp.ops; print(jax.config.jax_compilation_cache_dir)"],
            env=env, capture_output=True, text=True, check=True, timeout=300,
        ).stdout.strip().splitlines()[-1]
        assert out == want


class TestHistogramValidLen:
    """The masked-tail contract of :func:`histogram_device` under the shapes
    the services use: vmapped chunk batches and multi-tile chunks."""

    def test_vmapped_batches(self, rng):
        """Every batch element of a vmapped histogram counts only its OWN
        ``valid_len`` prefix (the batched service pipeline and the mesh step
        vmap it over chunks)."""
        B, cap = 3, 1 << 15
        data = rng.integers(0, 256, (B, cap)).astype(np.uint8)
        valid = np.array([cap, cap - 12345, 7], np.int32)
        out = np.asarray(
            jax.vmap(lambda d, v: histogram_device(d, v, tile=1 << 13))(
                jnp.asarray(data), jnp.asarray(valid)
            )
        )
        for b in range(B):
            want = np.bincount(data[b, : valid[b]], minlength=256)
            assert np.array_equal(out[b], want), f"batch {b} corrupt"

    @pytest.mark.parametrize("delta", [-1, 0, 1, 4097])
    def test_valid_len_straddles_tile_boundary(self, rng, delta):
        tile = 1 << 12
        data = rng.integers(0, 256, 5 * tile + 100).astype(np.uint8)
        n = 2 * tile + delta
        h = np.asarray(histogram_device(jnp.asarray(data), jnp.int32(n), tile=tile))
        assert np.array_equal(h, np.bincount(data[:n], minlength=256))


def _dot_eqns(jaxpr):
    """Every dot_general in ``jaxpr`` and in all of its sub-jaxprs (jit,
    scan, while, switch branches)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "eqns"):
                    yield from _dot_eqns(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    yield from _dot_eqns(sub.jaxpr)


#: dots that run at default precision on purpose, by named scope, with the
#: reason each is exact when f32 operands run as TF32 (10-bit mantissa) or
#: bf16: every other dot with an f32 operand must ask for HIGHEST.
_EXACT_AT_DEFAULT_PRECISION = {
    # 0/1 one-hot operands, f32 accumulation, per-tile counts < 2^24
    "hist_onehot_dot",
    # one-hot × table plane: values < 256, one selected product per output
    "table_lookup_dot",
    # one-hot × 256-entry symbol table: values < 256, one selected product
    "symbol_lookup_dot",
}


def _tf32_audit_programs():
    from datacomp.ops import (
        device_codebook,
        encode_device_merge,
        encode_device_merge_batch_slotted,
        encode_device_merge_slotted,
    )

    n, sub, ow = 8192, 256, 2400
    d = jnp.zeros(n, jnp.uint8)
    v = jnp.int32(n - 5)
    lens = jnp.zeros(256, jnp.int32)
    codes = jnp.zeros(256, jnp.uint32)
    words = jnp.zeros(ow, jnp.uint32)
    gaps = jnp.zeros(n // sub, jnp.uint32)
    lim, adj = jnp.zeros(16, jnp.int32), jnp.zeros(16, jnp.int32)
    sym = jnp.zeros(256, jnp.int32)
    return {
        "histogram": (lambda d, v: histogram_device(d, v, tile=4096), (d, v)),
        "codebook": (device_codebook, (jnp.zeros(256, jnp.int32),)),
        "encode": (
            lambda d, v, l, c: encode_device_merge(d, v, l, c, ow, sub, max_slots=12),
            (d, v, lens, codes),
        ),
        "encode_slotted": (
            lambda d, v, l, c: encode_device_merge_slotted(d, v, l, c, ow, sub),
            (d, v, lens, codes),
        ),
        "encode_batch_slotted": (
            lambda d, v, l, c: encode_device_merge_batch_slotted(d, v, l, c, ow, sub),
            (d[None], v[None], lens[None], codes[None]),
        ),
        "decode": (
            lambda w, g, l, a, s: decode_device(
                w, g, l, a, s, sub, n // sub, syms_per_step=16, refill_words=8
            ),
            (words, gaps, lim, adj, sym),
        ),
    }


@pytest.mark.parametrize(
    "program",
    ["histogram", "codebook", "encode", "encode_slotted",
     "encode_batch_slotted", "decode"],
)
def test_tf32_audit(program):
    """A GPU may run an f32 dot at default precision as TF32; a dot whose
    exactness depends on f32 must say HIGHEST.  Walks the traced program and
    fails on any dot with an f32 operand that neither pins HIGHEST nor sits
    in an allow-listed named scope."""
    fn, args = _tf32_audit_programs()[program]
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    for eqn in _dot_eqns(jaxpr):
        if not any(x.aval.dtype == jnp.float32 for x in eqn.invars):
            continue
        scope = str(eqn.source_info.name_stack)
        allowed = any(s in scope for s in _EXACT_AT_DEFAULT_PRECISION)
        assert eqn.params["precision"] == highest or allowed, (
            f"{program}: f32 dot at default precision outside the allow-list "
            f"(scope {scope!r}, operands {[str(x.aval) for x in eqn.invars]})"
        )


class TestDeviceCodebook:
    def test_optimal_and_canonical(self, rng):
        for _ in range(15):
            nsym = int(rng.integers(1, 257))
            f = np.zeros(256, np.int64)
            syms = rng.choice(256, nsym, replace=False)
            f[syms] = rng.integers(1, 100_000, nsym)
            dl = np.asarray(device_code_lengths(jnp.asarray(f, dtype=jnp.int32)))
            assert validate_lengths(dl)
            if nsym >= 2:
                hl = build_code_lengths(f, mode="java")
                assert int(f @ dl) == int(f @ hl)  # same optimal total bits
            else:
                assert dl[syms[0]] == 1 and dl.sum() == 1
            dc = np.asarray(device_canonical_codes(jnp.asarray(dl))).astype(np.uint32)
            assert np.array_equal(dc, canonical_codes_from_lengths(dl))

    def test_empty_histogram(self):
        dl = np.asarray(device_code_lengths(jnp.zeros(256, jnp.int32)))
        assert (dl == 0).all()


class TestEncodeScanOracle:
    """The scan-formulation encoder is a DIFFERENTIAL ORACLE (not exported
    from datacomp.ops): an independent device implementation the
    production tree-merge encoder is cross-checked against below."""

    @pytest.mark.parametrize("kind", ["text", "compressible", "random", "skewed"])
    @pytest.mark.parametrize("n", [1, 97, 30_000])
    def test_bit_exact_vs_host(self, kind, n):
        data = np.frombuffer(generate_bytes(kind, n), np.uint8)
        N = 32768
        padded = np.zeros(N, np.uint8)
        padded[:n] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        words, total_bits = encode_device_scan_oracle(
            jnp.asarray(padded), jnp.int32(n), jnp.asarray(lens), jnp.asarray(codes), N
        )
        assert words_to_bytes(np.asarray(words), int(total_bits)) == encode_bitstream(
            data, lens, codes
        )

    def test_empty(self):
        words, tb = encode_device_scan_oracle(
            jnp.zeros(1024, jnp.uint8), jnp.int32(0),
            jnp.zeros(256, jnp.int32), jnp.zeros(256, jnp.uint32), 1024,
        )
        assert int(tb) == 0

    def test_gaps_match_prefix_sum(self):
        data = np.frombuffer(generate_bytes("text", 8000), np.uint8)
        N = 8192
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        _, _, gaps = encode_device_scan_oracle(
            jnp.asarray(padded), jnp.int32(data.size),
            jnp.asarray(lens), jnp.asarray(codes), N, 512,
        )
        l64 = lens.astype(np.int64)[data]
        starts = np.cumsum(l64) - l64
        expect = starts[::512]
        assert np.array_equal(np.asarray(gaps)[: expect.size], expect)


class TestDecodeDevice:
    @pytest.mark.parametrize("kind", ["text", "skewed", "compressible"])
    def test_roundtrip(self, kind):
        S = 512
        data = np.frombuffer(generate_bytes(kind, 20_000), np.uint8)
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        enc = encode_bitstream(data, lens, codes)
        l64 = lens.astype(np.int64)[data]
        starts = np.cumsum(l64) - l64
        gaps = starts[::S].astype(np.uint32)
        Mpad = 64
        gpad = np.zeros(Mpad, np.uint32)
        gpad[: gaps.size] = gaps
        limits, adj, sym = build_decode_tables(lens)
        from datacomp.ops import syms_per_refill
        maxlen = int(lens.max())
        tried = set()
        for k in {1, 2, syms_per_refill(maxlen, S)}:
            if k * maxlen > 32 and k > 1:
                continue  # refill cannot sustain worst-case consumption
            if S % k or k in tried:
                continue
            tried.add(k)
            out = np.asarray(
                decode_device(
                    jnp.asarray(payload_to_words(enc)), jnp.asarray(gpad),
                    jnp.asarray(limits), jnp.asarray(adj), jnp.asarray(sym),
                    S, Mpad, syms_per_step=k,
                )
            )
            assert np.array_equal(out[: data.size], data), f"k={k} mismatch"

    @pytest.mark.parametrize("kind", ["text", "skewed", "random"])
    @pytest.mark.parametrize("refill_words", [2, 4, 8])
    def test_wide_refill_roundtrip(self, kind, refill_words):
        """W-word row refills (the per-index gather amortization) decode
        bit-identically, including mid-word gap offsets and deep codebooks."""
        from datacomp.ops import cmp_len_bucket, syms_per_refill

        S = 504  # 2^3*3^2*7: divisible by the wide per-step symbol counts
        data = np.frombuffer(generate_bytes(kind, 33_333), np.uint8)
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        maxlen = int(lens.max())
        enc = encode_bitstream(data, lens, codes)
        l64 = lens.astype(np.int64)[data]
        starts = np.cumsum(l64) - l64
        gaps = starts[::S].astype(np.uint32)
        Mpad = 80
        gpad = np.zeros(Mpad, np.uint32)
        gpad[: gaps.size] = gaps
        limits, adj, sym = build_decode_tables(lens)
        k = syms_per_refill(maxlen, S, refill_words)
        assert k > syms_per_refill(maxlen, S, 1) or refill_words == 2
        out = np.asarray(
            decode_device(
                jnp.asarray(payload_to_words(enc)), jnp.asarray(gpad),
                jnp.asarray(limits), jnp.asarray(adj), jnp.asarray(sym),
                S, Mpad, syms_per_step=k, cmp_len=cmp_len_bucket(maxlen),
                refill_words=refill_words,
            )
        )
        assert np.array_equal(out[: data.size], data)

    def test_table_rejects_deep_codes(self):
        f = np.zeros(256, np.int64)
        a, b = 1, 1
        for s in range(26):
            f[s] = a
            a, b = b, a + b
        lens, _ = build_codebook(f)
        assert lens.max() > 16
        with pytest.raises(ValueError):
            build_decode_tables(lens)


class TestEncodeMerge:
    """Gather-free tree-merge encoder (the production device encode path)."""

    @pytest.mark.parametrize("kind", ["text", "compressible", "random", "skewed"])
    @pytest.mark.parametrize("n", [1, 31, 32, 97, 30_000])
    def test_bit_exact_vs_host(self, kind, n):
        from datacomp.ops import encode_device_merge

        data = np.frombuffer(generate_bytes(kind, n), np.uint8)
        N = 32768
        padded = np.zeros(N, np.uint8)
        padded[:n] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        words, tb, gaps = encode_device_merge(
            jnp.asarray(padded), jnp.int32(n), jnp.asarray(lens),
            jnp.asarray(codes), N, 512,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(data, lens, codes)
        l64 = lens.astype(np.int64)[data]
        starts = np.cumsum(l64) - l64
        exp = starts[::512]
        assert np.array_equal(np.asarray(gaps)[: exp.size], exp)

    @pytest.mark.parametrize("slots", [18, 33])
    def test_max_slots_buckets(self, slots):
        from datacomp.ops import encode_device_merge

        data = np.frombuffer(generate_bytes("text", 8000), np.uint8)
        N = 8192
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        assert int(lens.max()) + 2 <= slots
        words, tb = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, max_slots=slots,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(data, lens, codes)

    @pytest.mark.parametrize("kind,max_len,slots", [
        # m=8 bucket: the depth-bounded merge tree's tightest shapes,
        # including random data whose all-8-bit codes make unit bit-lengths
        # hit EXACT word multiples (la ≡ 0 mod 32 — the wo_max boundary)
        ("random", 8, 10),
        ("text", 8, 10),
        ("compressible", 8, 10),
        ("text", 16, 18),
        ("skewed", 16, 18),
    ])
    def test_depth_bounded_merge_bit_exact(self, kind, max_len, slots):
        """max_slots also bounds the merge tree's splice loops and buffer
        widths (round 5); every bucket must stay bit-identical to the host
        stream."""
        from datacomp.ops import encode_device_merge

        data = np.frombuffer(generate_bytes(kind, 30_000), np.uint8)
        N = 32768
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        lens, codes = build_codebook(
            np.bincount(data, minlength=256).astype(np.int64),
            mode="fast", max_len=max_len,
        )
        assert int(lens.max()) <= max_len
        words, tb, gaps = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, 512, max_slots=slots,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(
            data, lens, codes
        )
        l64 = lens.astype(np.int64)[data]
        starts = np.cumsum(l64) - l64
        exp = starts[::512]
        assert np.array_equal(np.asarray(gaps)[: exp.size], exp)

    @pytest.mark.parametrize("kind", ["text", "random", "skewed"])
    def test_window_scatter_bit_exact(self, kind):
        """window_scatter=True places each group's owned words with ONE
        windowed scatter-ADD (1 sorted index per group, dead slots masked
        to zero) — a tested A/B mechanism, never production.  Must stay
        bit-identical to the host stream."""
        from datacomp.ops import encode_device_merge, slot_bucket

        data = np.frombuffer(generate_bytes(kind, 30_000), np.uint8)
        N = 32768
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        words, tb, gaps = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, 512, max_slots=slot_bucket(int(lens.max())),
            window_scatter=True,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(
            data, lens, codes
        )

    @pytest.mark.parametrize("kind", ["text", "random", "skewed"])
    def test_fused_scatter_bit_exact(self, kind):
        """fused_scatter=True places every slot's owned words with ONE
        unique-set scatter; the stream must stay bit-identical to the host
        encoder and to the chained-scatter formulation."""
        from datacomp.ops import encode_device_merge

        data = np.frombuffer(generate_bytes(kind, 30_000), np.uint8)
        N = 32768
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        slots = min(33, int(lens.max()) + 2)
        words, tb, gaps = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, 512, max_slots=slots, fused_scatter=True,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(
            data, lens, codes
        )
        w2, tb2, g2 = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, 512, max_slots=slots,
        )
        assert int(tb) == int(tb2)
        assert np.array_equal(np.asarray(gaps), np.asarray(g2))
        assert np.array_equal(np.asarray(words), np.asarray(w2))

    def test_matmul_lookup_matches_gather(self, rng):
        from datacomp.ops.encode_merge import lookup_symbol_tables

        data = rng.integers(0, 256, 50_000).astype(np.uint8)
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        l_dev, c_dev = jax.jit(lookup_symbol_tables)(
            jnp.asarray(data, jnp.int32), jnp.asarray(lens), jnp.asarray(codes)
        )
        assert np.array_equal(np.asarray(l_dev), lens[data])
        assert np.array_equal(np.asarray(c_dev), codes[data])

    @pytest.mark.parametrize("kind,code_bits", [
        ("compressible", 8), ("text", 16), ("skewed", 16),
    ])
    def test_plane_packed_lookup_bit_exact(self, kind, code_bits):
        """code_bits packs (len, code) into 2-3 one-hot planes (the encode
        MAC-cost lever); output must stay bit-identical to the host stream."""
        from datacomp.ops import code_bits_bucket, encode_device_merge

        data = np.frombuffer(generate_bytes(kind, 20_000), np.uint8)
        N = 20_480
        padded = np.zeros(N, np.uint8)
        padded[: data.size] = data
        mode = "fast" if code_bits == 8 else "java"
        lens, codes = build_codebook(
            np.bincount(data, minlength=256).astype(np.int64), mode=mode,
            max_len=8 if code_bits == 8 else 0,
        )
        assert code_bits_bucket(int(lens.max())) == code_bits
        words, tb = encode_device_merge(
            jnp.asarray(padded), jnp.int32(data.size), jnp.asarray(lens),
            jnp.asarray(codes), N, code_bits=code_bits,
        )
        assert words_to_bytes(np.asarray(words), int(tb)) == encode_bitstream(
            data, lens, codes
        )

    def test_empty(self):
        from datacomp.ops import encode_device_merge

        words, tb = encode_device_merge(
            jnp.zeros(1024, jnp.uint8), jnp.int32(0),
            jnp.zeros(256, jnp.int32), jnp.zeros(256, jnp.uint32), 1024,
        )
        assert int(tb) == 0
        assert not np.asarray(words).any()


class TestEncodeMergeLargeEntropy:
    """Regression: group bit-lengths above 256 overflowed a default-precision
    (bf16-operand) matmul in the prefix-sum stage, silently corrupting
    streams for high-entropy chunks (caught by the round-trip checksum).  The
    cumsum matmul now pins precision=HIGHEST (TF32 would round the same way
    above 2^11); this covers the shape on any backend."""

    def test_random_1mb_bit_exact(self):
        from datacomp.ops import encode_device_merge

        n = 1 << 20
        # skewed+random mix: the shared codebook gives the random half 9-bit
        # codes, pushing group lengths past 256 bits (the exact failing shape)
        data = np.frombuffer(
            generate_bytes("skewed", n // 2) + generate_bytes("random", n // 2), np.uint8
        )
        lens, codes = build_codebook(np.bincount(data, minlength=256).astype(np.int64))
        # random bytes ⇒ ~8-bit codes ⇒ group lengths ≈ 256-288 bits
        l64 = lens.astype(np.int64)[data]
        gl = np.add.reduceat(l64, np.arange(0, n, 32))
        assert gl.max() > 256
        words, tb = encode_device_merge(
            jnp.asarray(data), jnp.int32(n), jnp.asarray(lens), jnp.asarray(codes),
            (9 * n + 31) // 32 + 2,
        )
        assert int(tb) == int(l64.sum())
        got = words_to_bytes(np.asarray(words)[: (int(tb) + 31) // 32], int(tb))
        assert got == encode_bitstream(data, lens, codes)


class TestSlotBuckets:
    def test_slot_bucket_static(self):
        from datacomp.ops import SLOT_BUCKETS, slot_bucket

        assert SLOT_BUCKETS == (10, 12, 14, 16, 18, 33)
        assert [slot_bucket(m) for m in (1, 8, 10, 14, 16, 17, 32)] == [
            10, 10, 12, 16, 18, 33, 33
        ]
        # ml=32 must clamp (the old 3-bucket expression raised StopIteration)
        assert slot_bucket(32) == 33

    def test_traced_case_matches_static(self):
        from datacomp.ops.encode_merge import SLOT_BUCKETS, _slot_case, slot_bucket

        for ml in range(1, 33):
            lens = np.zeros(256, np.int32)
            lens[:2] = [ml, ml]
            idx = int(_slot_case(jnp.asarray(lens)))
            assert SLOT_BUCKETS[idx] == slot_bucket(ml), ml
