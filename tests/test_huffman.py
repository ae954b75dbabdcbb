"""Canonical Huffman codebook tests.

Mirrors the reference's test strategy (``core/CanonicalHuffmanTest.java`` and
``core/HuffmanPropertyTest.java``): uniform/skewed distributions, the
single-symbol and empty edge cases, the canonical consecutive-codes property,
code uniqueness, frequency↔length monotonicity, completeness — plus parity
checks of the Java-PriorityQueue-exact tree build against an independent
reference heap implementation.
"""

import heapq

import numpy as np
import pytest

from datacomp.core import (
    build_code_lengths,
    build_codebook,
    canonical_codes_from_lengths,
    validate_lengths,
)


def ref_lengths_any_optimal(freqs):
    """Optimal Huffman total length via a plain heapq (tie-breaks differ,
    totals must match)."""
    items = [(int(f), i) for i, f in enumerate(freqs) if f > 0]
    if len(items) <= 1:
        return None
    heap = [(f, i, 0) for i, (f, s) in enumerate(items)]
    # store (freq, uid, ...) trees
    trees = [(f, [s]) for f, s in items]
    h = [(f, i) for i, (f, _) in enumerate(trees)]
    heapq.heapify(h)
    depth = {s: 0 for _, s in items}
    nxt = len(trees)
    while len(h) > 1:
        f1, i1 = heapq.heappop(h)
        f2, i2 = heapq.heappop(h)
        syms = trees[i1][1] + trees[i2][1]
        for s in syms:
            depth[s] += 1
        trees.append((f1 + f2, syms))
        heapq.heappush(h, (f1 + f2, nxt))
        nxt += 1
    return depth


class TestBuildCodeLengths:
    def test_empty_histogram(self):
        lens = build_code_lengths(np.zeros(256, dtype=np.int64))
        assert (lens == 0).all()

    def test_single_symbol_gets_one_bit(self):
        f = np.zeros(256, dtype=np.int64)
        f[65] = 1000
        lens = build_code_lengths(f)
        assert lens[65] == 1
        assert lens.sum() == 1

    def test_two_symbols(self):
        f = np.zeros(256, dtype=np.int64)
        f[0], f[255] = 7, 3
        lens, codes = build_codebook(f)
        assert lens[0] == 1 and lens[255] == 1
        assert {int(codes[0]), int(codes[255])} == {0, 1}

    def test_uniform_distribution_is_balanced(self):
        f = np.full(256, 100, dtype=np.int64)
        lens = build_code_lengths(f)
        assert (lens == 8).all()

    def test_skewed_shorter_codes_for_frequent(self):
        f = np.zeros(256, dtype=np.int64)
        f[:8] = [1000, 400, 200, 100, 50, 25, 12, 6]
        lens = build_code_lengths(f)
        used = lens[:8]
        # monotonic: higher frequency -> length no longer than less frequent
        assert all(used[i] <= used[i + 1] for i in range(7))

    def test_optimal_total_length_matches_heapq_reference(self, rng):
        for _ in range(25):
            nsym = int(rng.integers(2, 256))
            f = np.zeros(256, dtype=np.int64)
            syms = rng.choice(256, nsym, replace=False)
            f[syms] = rng.integers(1, 10_000, nsym)
            lens = build_code_lengths(f, mode="java")
            ref_depth = ref_lengths_any_optimal(f)
            total = sum(int(f[s]) * int(lens[s]) for s in syms)
            ref_total = sum(int(f[s]) * ref_depth[s] for s in syms)
            assert total == ref_total

    def test_fast_mode_same_total_length(self, rng):
        for _ in range(25):
            nsym = int(rng.integers(2, 256))
            f = np.zeros(256, dtype=np.int64)
            syms = rng.choice(256, nsym, replace=False)
            f[syms] = rng.integers(1, 10_000, nsym)
            lj = build_code_lengths(f, mode="java")
            lf = build_code_lengths(f, mode="fast")
            assert int(f @ lj) == int(f @ lf)
            assert validate_lengths(lf)

    def test_kraft_equality_holds(self, rng):
        for _ in range(10):
            f = rng.integers(0, 1000, 256).astype(np.int64)
            if np.count_nonzero(f) < 2:
                continue
            lens = build_code_lengths(f)
            used = lens[lens > 0]
            assert abs(np.sum(2.0 ** (-used.astype(float))) - 1.0) < 1e-9


class TestCanonicalCodes:
    def test_same_length_codes_consecutive(self, rng):
        """The explicit canonical-property check from the reference tests
        (CanonicalHuffmanTest.java:69-94)."""
        f = rng.integers(1, 1000, 256).astype(np.int64)
        lens, codes = build_codebook(f)
        for ln in np.unique(lens[lens > 0]):
            cs = np.sort(codes[lens == ln].astype(np.int64))
            assert (np.diff(cs) == 1).all()

    def test_all_codes_unique_per_length(self, rng):
        f = rng.integers(0, 50, 256).astype(np.int64)
        f[f < 5] = 0
        if np.count_nonzero(f) < 2:
            f[:3] = [10, 5, 1]
        lens, codes = build_codebook(f)
        for ln in np.unique(lens[lens > 0]):
            cs = codes[lens == ln]
            assert len(np.unique(cs)) == len(cs)

    def test_prefix_free(self, rng):
        f = rng.integers(0, 100, 256).astype(np.int64)
        lens, codes = build_codebook(f)
        entries = [
            (int(lens[s]), int(codes[s])) for s in range(256) if lens[s] > 0
        ]
        for la, ca in entries:
            for lb, cb in entries:
                if (la, ca) == (lb, cb) or la > lb:
                    continue
                assert (cb >> (lb - la)) != ca or (la, ca) == (lb, cb)

    def test_roundtrip_lengths_to_codes_deterministic(self):
        lens = np.zeros(256, dtype=np.int32)
        lens[10], lens[20], lens[30], lens[40] = 1, 2, 3, 3
        codes = canonical_codes_from_lengths(lens)
        assert int(codes[10]) == 0b0
        assert int(codes[20]) == 0b10
        assert int(codes[30]) == 0b110
        assert int(codes[40]) == 0b111

    def test_completeness_every_used_symbol_has_code(self, rng):
        f = rng.integers(0, 1000, 256).astype(np.int64)
        lens, codes = build_codebook(f)
        assert ((f > 0) == (lens > 0)).all()


class TestValidation:
    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            build_code_lengths(np.zeros(255, dtype=np.int64))
        with pytest.raises(ValueError):
            canonical_codes_from_lengths(np.zeros(10, dtype=np.int32))

    def test_validate_lengths(self):
        lens = np.zeros(256, dtype=np.int32)
        assert validate_lengths(lens)
        lens[0] = 1
        lens[1] = 1
        assert validate_lengths(lens)
        lens[2] = 1  # Kraft violation
        assert not validate_lengths(lens)


class TestLengthLimited:
    """Optimal length-limited codes (package-merge) — the reference has no
    equivalent (codes unbounded up to 32 bits); this keeps every chunk on the
    device decode path (codes <= 16 bits, ``ops/decode.py``)."""

    @staticmethod
    def _total(freqs, lens):
        return int((freqs.astype(np.int64) * lens).sum())

    def _brute_optimal(self, weights, limit):
        best = [None]

        def rec(i, lens, kraft):
            if kraft > 1.0 + 1e-12:
                return
            if i == len(weights):
                c = sum(w * l for w, l in zip(weights, lens))
                if best[0] is None or c < best[0]:
                    best[0] = c
                return
            for l in range(1, limit + 1):
                lens.append(l)
                rec(i + 1, lens, kraft + 2.0 ** -l)
                lens.pop()

        rec(0, [], 0.0)
        return best[0]

    def test_matches_brute_force_optimum(self, rng):
        for _ in range(60):
            n = int(rng.integers(2, 7))
            limit = int(rng.integers(int(np.ceil(np.log2(n))), 6))
            freqs = np.zeros(256, np.int64)
            syms = rng.choice(256, n, replace=False)
            freqs[syms] = rng.integers(1, 1000, n)
            lens = build_code_lengths(freqs, mode="fast", max_len=limit)
            assert validate_lengths(lens)
            assert lens[syms].max() <= limit and (lens[syms] > 0).all()
            assert self._total(freqs, lens) == self._brute_optimal(
                list(freqs[syms]), limit
            )

    def test_unchanged_when_limit_not_binding(self, rng):
        for _ in range(20):
            freqs = rng.integers(0, 1000, 256).astype(np.int64)
            unl = build_code_lengths(freqs, mode="java")
            lim = build_code_lengths(freqs, mode="java", max_len=32)
            assert np.array_equal(unl, lim)  # java mode stays bit-exact

    def test_limits_deep_skew_and_stays_kraft_valid(self):
        freqs = np.zeros(256, np.int64)
        freqs[:30] = (1 << np.arange(30)).astype(np.int64)  # fibonacci-ish skew
        unl = build_code_lengths(freqs, mode="fast")
        lim = build_code_lengths(freqs, mode="fast", max_len=16)
        assert unl.max() > 16
        assert lim.max() == 16 and validate_lengths(lim)
        # the cap costs compression but must stay close to optimal here
        assert self._total(freqs, lim) < int(1.10 * self._total(freqs, unl))

    def test_rescues_codes_beyond_32_bits(self):
        # unconstrained code depth 39 raises; the cap makes it compressible
        freqs = np.zeros(256, np.int64)
        freqs[:40] = (1 << np.arange(40)).astype(np.int64)
        with pytest.raises(ValueError):
            build_code_lengths(freqs, mode="fast")
        lens = build_code_lengths(freqs, mode="fast", max_len=16)
        assert lens.max() <= 16 and validate_lengths(lens)

    def test_tight_limit_full_alphabet(self, rng):
        # 256 used symbols at limit 8: the only Kraft-valid code is fixed 8-bit
        freqs = rng.integers(1, 10**6, 256).astype(np.int64)
        lens = build_code_lengths(freqs, mode="fast", max_len=8)
        assert (lens == 8).all()

    def test_infeasible_limit_rejected(self):
        freqs = np.ones(256, np.int64)
        with pytest.raises(ValueError):
            build_code_lengths(freqs, mode="fast", max_len=7)
        with pytest.raises(ValueError):
            build_code_lengths(freqs, max_len=33)

    def test_canonical_codes_from_limited_lengths_prefix_free(self, rng):
        freqs = np.zeros(256, np.int64)
        freqs[:50] = rng.integers(1, 2**40, 50)
        lens = build_code_lengths(freqs, mode="fast", max_len=12)
        codes = canonical_codes_from_lengths(lens)
        used = np.nonzero(lens > 0)[0]
        seen = set()
        for s in used:
            bits = format(codes[s], f"0{lens[s]}b")
            for p in seen:
                assert not bits.startswith(p) and not p.startswith(bits)
            seen.add(bits)


class TestJavaPQDifferential:
    """Differential fuzz of the production ``_JavaHeap`` tree build against a
    second, independently written OpenJDK PriorityQueue simulation
    (``tests/oracle_javapq.py``).  Optimality tests cannot pin down
    tie-break-dependent code *lengths*; two implementations written from the
    spec by different paths agreeing across heavy-tie histograms can."""

    @staticmethod
    def _fuzz_histograms(rng, n_cases):
        for i in range(n_cases):
            kind = i % 6
            h = np.zeros(256, np.int64)
            if kind == 0:  # dense tiny values: maximal tie pressure
                h[:] = rng.integers(1, 5, 256)
            elif kind == 1:  # sparse with ties
                k = int(rng.integers(2, 40))
                syms = rng.choice(256, k, replace=False)
                h[syms] = rng.integers(1, 4, k)
            elif kind == 2:  # random magnitudes
                k = int(rng.integers(2, 257))
                syms = rng.choice(256, k, replace=False)
                h[syms] = rng.integers(1, 1 << int(rng.integers(1, 31)), k)
            elif kind == 3:  # power-of-two plateaus (merged-node ties)
                h[:] = np.int64(1) << rng.integers(0, 8, 256)
            elif kind == 4:  # zipf-ish skew
                k = int(rng.integers(2, 257))
                syms = rng.choice(256, k, replace=False)
                h[syms] = (1e6 / (np.arange(k) + 1) ** 1.3).astype(np.int64) + 1
            else:  # all-equal: pure sift-order stress
                h[:] = int(rng.integers(1, 100))
            yield h

    def test_differential_fuzz_lengths_identical(self, rng):
        from oracle_javapq import oracle_code_lengths

        n = int(__import__("os").environ.get("DCZ_FUZZ_CASES", "2000"))
        for case, h in enumerate(self._fuzz_histograms(rng, n)):
            got = build_code_lengths(h, mode="java")
            want = oracle_code_lengths(h)
            assert np.array_equal(got, want), (
                f"case {case}: _JavaHeap and OpenJDK-spec oracle disagree on "
                f"code lengths\nhist nonzero: {np.nonzero(h)[0][:20]}..."
            )

    def test_differential_edge_cases(self):
        from oracle_javapq import oracle_code_lengths

        for h in (
            np.zeros(256, np.int64),                         # empty
            np.eye(256, dtype=np.int64)[7] * 5,              # single symbol
            np.r_[np.ones(2, np.int64), np.zeros(254, np.int64)],  # two
            np.arange(256, dtype=np.int64),                  # includes a zero
            np.full(256, np.int64(10**12)),                  # huge equal freqs
        ):
            assert np.array_equal(
                build_code_lengths(h, mode="java"), oracle_code_lengths(h)
            )


class TestAutoCap:
    """max_len='auto' policy: shallowest cap costing < 0.5% extra bits
    (v2 default — keeps device decode at the highest symbols-per-refill)."""

    def test_text_histogram_caps_to_8(self):
        from datacomp.core import resolve_auto_cap
        from datacomp.utils.testdata import generate_bytes

        data = np.frombuffer(generate_bytes("text", 1 << 20), np.uint8)
        hist = np.bincount(data, minlength=256).astype(np.int64)
        opt = build_code_lengths(hist, mode="java")
        cap = resolve_auto_cap(hist, opt)
        assert cap == 8  # ~27 distinct symbols: 8-bit cap is near-free
        capped = build_code_lengths(hist, mode="java", max_len=-1)
        assert int(capped.max()) <= 8
        cost = int(hist @ capped.astype(np.int64)) - int(hist @ opt.astype(np.int64))
        assert cost <= 0.005 * int(hist @ opt.astype(np.int64))
        assert validate_lengths(capped)

    def test_shallowest_tier_within_budget_is_chosen(self):
        from datacomp.core import resolve_auto_cap
        from datacomp.core.huffman import AUTO_CAP_TIERS, _lengths_package_merge

        # 10 hot symbols + 200 rare ones: the 8-bit tier is too lossy, a
        # deeper tier absorbs the rare tail cheaply
        hist = np.zeros(256, np.int64)
        hist[:10] = 100_000
        hist[10:210] = 1
        opt = build_code_lengths(hist, mode="java")
        cap = resolve_auto_cap(hist, opt)
        assert cap in AUTO_CAP_TIERS
        opt_bits = int(hist @ opt.astype(np.int64))
        chosen = build_code_lengths(hist, max_len=-1)
        assert int(chosen.max()) <= cap
        assert int(hist @ chosen.astype(np.int64)) - opt_bits <= 0.005 * opt_bits
        # every shallower tier must exceed the budget (else it would be chosen)
        for t in AUTO_CAP_TIERS:
            if t >= cap or t >= int(opt.max()):
                break
            cost = int(hist @ _lengths_package_merge(hist, t).astype(np.int64)) - opt_bits
            assert cost > 0.005 * opt_bits, f"tier {t} was within budget but not chosen"

    def test_v2_default_is_auto_v1_is_exact(self):
        from datacomp.config import load_config

        v1 = load_config(compression={"format_version": 1})
        v2 = load_config(compression={"format_version": 2})
        assert v1.compression.effective_max_code_len() == 0
        assert v2.compression.effective_max_code_len() == -1
        # explicit 32 opts v2 out of auto
        v2x = load_config(compression={"format_version": 2, "max_code_len": 32})
        assert v2x.compression.effective_max_code_len() == 32
        # "auto" string accepted from TOML-style overrides
        va = load_config(compression={"max_code_len": "auto"})
        assert va.compression.max_code_len == -1
