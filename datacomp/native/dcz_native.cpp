// Native host codec for datacomp: canonical-Huffman bit-serial encoder,
// table-based decoder, and byte histogram.
//
// These are the host-side (CPU-service / fallback-chain) equivalents of the
// reference's hot loops:
//   * encode:    service/cpu/CpuCompressionService.java:303-315 + BitOutputStream
//   * decode:    core/TableBasedHuffmanDecoder.java (10-bit table + long-code
//                fallback); here a 16-bit-capped single-level table + canonical
//                limit/base fallback for longer codes
//   * histogram: service/cpu/CpuFrequencyService.java (ForkJoin split; here a
//                4-way unrolled single pass — callers parallelize across chunks)
//
// Bit order: MSB-first, codewords high-bit-first, trailing partial byte
// zero-padded — identical to the reference's BitOutputStream.writeBits.
//
// Build: g++ -O3 -shared -fPIC (see build.py). Pure C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

void dcz_histogram(const uint8_t* data, int64_t n, int64_t* out256) {
  int64_t h0[256] = {0}, h1[256] = {0}, h2[256] = {0}, h3[256] = {0};
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    h0[data[i]]++;
    h1[data[i + 1]]++;
    h2[data[i + 2]]++;
    h3[data[i + 3]]++;
  }
  for (; i < n; i++) h0[data[i]]++;
  for (int s = 0; s < 256; s++) out256[s] = h0[s] + h1[s] + h2[s] + h3[s];
}

// Encode n input bytes; returns number of output bytes written, or -1 if
// out_cap insufficient. Exact output size = ceil(sum(lengths[data]) / 8).
int64_t dcz_encode(const uint8_t* data, int64_t n, const int32_t* lengths,
                   const uint32_t* codes, uint8_t* out, int64_t out_cap) {
  // thin wrapper kept for ABI stability; no gap emission
  extern int64_t dcz_encode_gaps(const uint8_t*, int64_t, const int32_t*,
                                 const uint32_t*, uint8_t*, int64_t,
                                 uint32_t*, int64_t);
  return dcz_encode_gaps(data, n, lengths, codes, out, out_cap, nullptr, 0);
}

// Encode + optionally record the absolute bit offset of every `subblock`-th
// symbol (the format-v2 gap array — free here, the bit position is the
// encoder's own running counter).
//
// Hot-loop design.  Per-symbol state is one fused table entry (codeword
// LEFT-aligned at bit 63, length in the low 6 bits) OR-shifted into a
// 64-bit accumulator, with a speculative 4-byte byte-swapped store each
// step (later stores overwrite; callers provide 8 bytes of slack).  The
// throughput limit is the accumulator dependency chain, so when every code
// fits 16 bits (true for all but pathologically skewed byte histograms) two
// codewords are pre-merged OFF the chain (merged = c1 | c2 >> len1 — both
// table loads and the merge are independent of acc/nbits), halving the
// chained ops per symbol: measured ~1.5x over the one-symbol loop.
// Interleaved multi-cursor variants (the decoder's trick) measured SLOWER
// here — the table is L1-resident, the OoO core already overlaps adjacent
// iterations, and extra cursors only add register pressure.
int64_t dcz_encode_gaps(const uint8_t* data, int64_t n, const int32_t* lengths,
                        const uint32_t* codes, uint8_t* out, int64_t out_cap,
                        uint32_t* gaps, int64_t subblock) {
  uint64_t tbl[256];
  int max_len = 0;
  for (int i = 0; i < 256; i++) {
    const int l = lengths[i];
    if (l > max_len) max_len = l;
    const uint64_t left =
        l > 0 ? static_cast<uint64_t>(codes[i]) << (64 - l) : 0ull;
    tbl[i] = left | static_cast<uint64_t>(l);
  }
  uint64_t acc = 0;
  int64_t nbits = 0;  // bits held in acc, left-aligned at bit 63 (always < 32)
  int64_t w = 0;
  const int64_t guard = out_cap - 8;
  // Outer loop per sub-block keeps gap emission out of the hot loop: the
  // running bit position is (8w + nbits) — no extra per-symbol state.
  const int64_t stride = (gaps != nullptr && subblock > 0) ? subblock : n;
  int64_t gi = 0;
  // Pair merging is valid when a merged pair (<= 2*max_len bits) plus the
  // accumulator backlog (< 32 bits) cannot overflow 64 bits.
  const bool pairs_ok = max_len <= 16;
  for (int64_t b0 = 0; b0 < n || (b0 == 0 && n == 0); b0 += stride) {
    if (gaps != nullptr) {
      gaps[gi++] = static_cast<uint32_t>((static_cast<uint64_t>(w) << 3) + nbits);
    }
    const int64_t b1 = b0 + stride < n ? b0 + stride : n;
    int64_t i = b0;
    if (pairs_ok) {
      for (; i + 2 <= b1; i += 2) {
        const uint64_t e1 = tbl[data[i]];
        const uint64_t e2 = tbl[data[i + 1]];
        const int64_t l1 = static_cast<int64_t>(e1 & 63u);
        const uint64_t merged = (e1 & ~63ull) | ((e2 & ~63ull) >> l1);
        acc |= merged >> nbits;
        nbits += l1 + static_cast<int64_t>(e2 & 63u);
        if (w > guard) return -1;
        const uint32_t blk = __builtin_bswap32(static_cast<uint32_t>(acc >> 32));
        std::memcpy(out + w, &blk, 4);
        const int64_t full = nbits >> 5;  // 0 or 1 (nbits < 64)
        w += full << 2;
        acc <<= (full << 5);
        nbits -= full << 5;
      }
    }
    for (; i < b1; i++) {  // odd tail, or deep-code (> 16-bit) streams
      const uint64_t e = tbl[data[i]];
      acc |= (e & ~63ull) >> nbits;
      nbits += static_cast<int64_t>(e & 63u);
      if (w > guard) return -1;
      const uint32_t blk = __builtin_bswap32(static_cast<uint32_t>(acc >> 32));
      std::memcpy(out + w, &blk, 4);
      const int64_t full = nbits >> 5;  // 0 or 1
      w += full << 2;
      acc <<= (full << 5);
      nbits -= full << 5;
    }
    if (n == 0) break;
  }
  while (nbits > 0) {  // trailing partial bytes, zero-padded
    if (w >= out_cap) return -1;
    out[w++] = static_cast<uint8_t>(acc >> 56);
    acc <<= 8;
    nbits -= 8;
  }
  return w;
}

// Canonical table-based decode (format v1 / whole-stream path).  Returns 0
// on success, -1 on invalid code, -2 on invalid code-length table.
// Implemented as a single-cursor run of the gap decoder below, inheriting
// its multi-symbol (1-3 codewords per 16-bit peek) lookup table and fast
// loop — ~1.5-2x the classic one-symbol table walk.
int64_t dcz_decode(const uint8_t* comp, int64_t comp_len, int64_t n_symbols,
                   const int32_t* lengths, uint8_t* out) {
  extern int64_t dcz_decode_gaps(const uint8_t*, int64_t, int64_t,
                                 const int32_t*, const uint32_t*, int64_t,
                                 int64_t, uint8_t*);
  if (n_symbols == 0) {
    // preserve the table-validation contract on empty streams
    for (int s = 0; s < 256; s++) {
      if (lengths[s] < 0 || lengths[s] > 32) return -2;
    }
    return 0;
  }
  const uint32_t gap0 = 0;
  return dcz_decode_gaps(comp, comp_len, n_symbols, lengths, &gap0, 1,
                         n_symbols, out);
}

// Gap-array parallel decode (format v2): sub-block entry bit offsets let
// several cursors walk the stream concurrently — here W interleaved cursors
// whose state lives in registers (manually unrolled) so independent
// table-lookup chains overlap in the pipeline (the ILP analogue of the device
// decoder's thousands of lanes).  Each multi-symbol table hit emits 1-3
// symbols per 16-bit lookup.
//
// Safety invariants (regression-tested; an earlier version violated both):
//   * no store ever lands at or past a cursor's `end` — the joint fast loop
//     only runs steps with oi+3 <= end, the drain never writes speculatively;
//     a speculative pair write at a span boundary would clobber the NEXT
//     cursor's already-decoded first symbol (and overflow `out` on the last).
//   * canonical fallback scans check the lower bound first <= c, else a
//     corrupt stream indexes sym_sorted negatively.
//
// Returns 0 on success, -1 invalid code, -2 invalid table, -3 bad gaps.
int64_t dcz_decode_gaps(const uint8_t* comp, int64_t comp_len, int64_t n_symbols,
                        const int32_t* lengths, const uint32_t* gap_bits,
                        int64_t ngaps, int64_t subblock, uint8_t* out) {
  if (n_symbols == 0) return 0;
  if (ngaps <= 0 || subblock <= 0) return -3;
  if ((ngaps - 1) * subblock >= n_symbols || ngaps * subblock < n_symbols) return -3;

  int max_len = 0;
  int64_t counts[40] = {0};
  for (int s = 0; s < 256; s++) {
    const int l = lengths[s];
    if (l < 0 || l > 32) return -2;
    if (l > 0) {
      counts[l]++;
      if (l > max_len) max_len = l;
    }
  }
  if (max_len == 0) return -2;
  int64_t first[40] = {0}, base[40] = {0}, limit[40] = {0};
  int64_t code = 0, nsyms = 0;
  for (int l = 1; l <= max_len; l++) {
    code = (code + counts[l - 1]) << 1;
    first[l] = code;
    base[l] = nsyms;
    nsyms += counts[l];
    limit[l] = first[l] + counts[l];
  }
  std::vector<uint8_t> sym_sorted(static_cast<size_t>(nsyms));
  {
    int64_t fill[40];
    std::memcpy(fill, base, sizeof(fill));
    for (int s = 0; s < 256; s++) {
      const int l = lengths[s];
      if (l > 0) sym_sorted[static_cast<size_t>(fill[l]++)] = static_cast<uint8_t>(s);
    }
  }
  // 16-bit MULTI-symbol table: each entry decodes 1, 2, or 3 complete
  // codewords per lookup (whichever fit in the 16 peeked bits).
  // layout: sym1 | sym2<<8 | sym3<<16 | count<<24 | totalLen<<26 ;
  // ESCAPE = long code (> 16 bits).  The careful drain path (a handful of
  // symbols per cursor) uses the canonical scan instead of a table.
  constexpr uint32_t ESCAPE = 0xFFFFFFFFu;
  std::vector<uint32_t> pt(static_cast<size_t>(1) << 16, ESCAPE);
  const int L1 = max_len < 16 ? max_len : 16;
  for (int l1 = 1; l1 <= L1; l1++) {
    for (int64_t c1 = first[l1]; c1 < limit[l1]; c1++) {
      const uint8_t s1 = sym_sorted[static_cast<size_t>(base[l1] + c1 - first[l1])];
      const uint64_t start1 = static_cast<uint64_t>(c1) << (16 - l1);
      const uint64_t span1 = static_cast<uint64_t>(1) << (16 - l1);
      const uint32_t e1 = static_cast<uint32_t>(s1) | (1u << 24) |
                          (static_cast<uint32_t>(l1) << 26);
      for (uint64_t k = 0; k < span1; k++) pt[start1 + k] = e1;
      const int rem = 16 - l1;
      for (int l2 = 1; l2 <= rem && l2 <= max_len; l2++) {
        for (int64_t c2 = first[l2]; c2 < limit[l2]; c2++) {
          const uint8_t s2 = sym_sorted[static_cast<size_t>(base[l2] + c2 - first[l2])];
          const uint64_t start2 = start1 + (static_cast<uint64_t>(c2) << (rem - l2));
          const uint64_t span2 = static_cast<uint64_t>(1) << (rem - l2);
          const uint32_t e2 = static_cast<uint32_t>(s1) |
                              (static_cast<uint32_t>(s2) << 8) | (2u << 24) |
                              (static_cast<uint32_t>(l1 + l2) << 26);
          for (uint64_t k = 0; k < span2; k++) pt[start2 + k] = e2;
          const int rem2 = rem - l2;
          for (int l3 = 1; l3 <= rem2 && l3 <= max_len; l3++) {
            for (int64_t c3 = first[l3]; c3 < limit[l3]; c3++) {
              const uint8_t s3 = sym_sorted[static_cast<size_t>(base[l3] + c3 - first[l3])];
              const uint64_t start3 = start2 + (static_cast<uint64_t>(c3) << (rem2 - l3));
              const uint64_t span3 = static_cast<uint64_t>(1) << (rem2 - l3);
              const uint32_t e3 = static_cast<uint32_t>(s1) |
                                  (static_cast<uint32_t>(s2) << 8) |
                                  (static_cast<uint32_t>(s3) << 16) | (3u << 24) |
                                  (static_cast<uint32_t>(l1 + l2 + l3) << 26);
              for (uint64_t k = 0; k < span3; k++) pt[start3 + k] = e3;
            }
          }
        }
      }
    }
  }

  const uint32_t* PT = pt.data();
  bool err = false;

  // One-symbol canonical decode shared by the fast loop's long-code escape
  // (codes > 16 bits — the scan's <= 16 rounds find nothing and fall
  // through) and the careful drain; returns length or 0 on corrupt stream.
  // Off the hot path by construction.
  auto long_decode = [&](uint64_t acc, uint8_t* sym) -> int {
    for (int ln = 1; ln <= max_len; ln++) {
      const int64_t c = static_cast<int64_t>(acc >> (64 - ln));
      if (c < limit[ln]) {
        if (c < first[ln]) return 0;
        *sym = sym_sorted[static_cast<size_t>(base[ln] + c - first[ln])];
        return ln;
      }
    }
    return 0;
  };

  struct Cursor {
    uint64_t acc = 0;
    int64_t nbits = 0;
    int64_t r = 0;      // byte cursor
    int64_t oi = 0;     // next output index
    int64_t end = 0;    // one-past-last output index
  };

  auto init_cursor = [&](Cursor& cu, int64_t gap_index) {
    const uint64_t bit = gap_bits[gap_index];
    cu.r = static_cast<int64_t>(bit >> 3);
    cu.acc = 0;
    cu.nbits = 0;
    if (cu.r > comp_len) { err = true; cu.r = comp_len; return; }
    const int drop = static_cast<int>(bit & 7u);
    // preload one byte and discard the leading bits of the sub-block's byte
    if (cu.r < comp_len) {
      cu.acc = static_cast<uint64_t>(comp[cu.r++]) << 56;
      cu.nbits = 8;
    }
    cu.acc <<= drop;
    cu.nbits -= drop;
  };

  // Careful drain: full refill, exactly one symbol per step, never writes
  // past `end`, bounds-checked for corrupt streams.
  auto drain = [&](Cursor& cu) {
    while (cu.oi < cu.end) {
      while (cu.nbits <= 32) {  // word refill + byte-wise tail
        if (cu.r + 4 <= comp_len) {
          uint32_t v;
          std::memcpy(&v, comp + cu.r, 4);
          cu.acc |= static_cast<uint64_t>(__builtin_bswap32(v)) << (32 - cu.nbits);
          cu.r += 4;
          cu.nbits += 32;
        } else if (cu.r < comp_len) {
          cu.acc |= static_cast<uint64_t>(comp[cu.r++]) << (56 - cu.nbits);
          cu.nbits += 8;
        } else {
          break;
        }
      }
      uint8_t sym;
      const int l = long_decode(cu.acc, &sym);
      if (l == 0 || l > cu.nbits) { err = true; return; }
      out[cu.oi++] = sym;
      cu.acc <<= l;
      cu.nbits -= l;
    }
  };

// One fast step: single conditional 32-bit refill (nbits stays >= 33 after,
// since a step consumes <= 16 table bits / <= 32 long-code bits), one pair
// lookup, 1-3 symbols out.  The unconditional out[oi+1]/out[oi+2] stores are
// safe only under oi+3 <= end, which the callers guarantee.  State lives in the
// caller's locals so the compiler keeps it in registers.
#define DCZ_FSTEP(acc, nb, r, oi)                                            \
  do {                                                                       \
    if (nb <= 32) {                                                          \
      uint32_t v_;                                                           \
      std::memcpy(&v_, comp + (r), 4);                                       \
      (acc) |= static_cast<uint64_t>(__builtin_bswap32(v_)) << (32 - (nb));  \
      (r) += 4;                                                              \
      (nb) += 32;                                                            \
    }                                                                        \
    const uint32_t e_ = PT[static_cast<uint32_t>((acc) >> 48)];              \
    if (__builtin_expect(e_ != ESCAPE, 1)) {                                 \
      out[(oi)] = static_cast<uint8_t>(e_);                                  \
      out[(oi) + 1] = static_cast<uint8_t>(e_ >> 8);                         \
      out[(oi) + 2] = static_cast<uint8_t>(e_ >> 16);                        \
      (oi) += (e_ >> 24) & 3u;                                               \
      const int l_ = static_cast<int>(e_ >> 26);                             \
      (acc) <<= l_;                                                          \
      (nb) -= l_;                                                            \
    } else {                                                                 \
      uint8_t sym_;                                                          \
      const int l_ = long_decode((acc), &sym_);                              \
      if (l_ == 0 || l_ > (nb)) {                                            \
        err = true;                                                          \
      } else {                                                               \
        out[(oi)++] = sym_;                                                  \
        (acc) <<= l_;                                                        \
        (nb) -= l_;                                                          \
      }                                                                      \
    }                                                                        \
  } while (0)

  constexpr int W = 4;
  // contiguous spans of whole sub-blocks per cursor, balanced split so no
  // cursor is empty when ngaps >= W (an empty cursor would pin the joint
  // phase's per-block iteration budget at zero)
  Cursor cur[W];
  for (int k = 0; k < W; k++) {
    const int64_t b0 = k * ngaps / W;
    const int64_t b1 = (k + 1) * ngaps / W;
    if (b0 >= b1) { cur[k].oi = cur[k].end = 0; continue; }
    init_cursor(cur[k], b0);
    cur[k].oi = b0 * subblock;
    cur[k].end = b1 * subblock < n_symbols ? b1 * subblock : n_symbols;
  }
  if (err) return -3;

  if (ngaps >= W) {
    // Joint fast phase: all four cursors advance in lockstep with their
    // state in registers.  Per block, T is the largest iteration count for
    // which every step is check-free: each iteration emits <= 3 symbols
    // (oi+3 <= end holds for T <= (end-oi)/3) and reads <= 4 bytes
    // (r+4 <= comp_len holds for T <= (comp_len-r)/4).
    uint64_t a0 = cur[0].acc, a1 = cur[1].acc, a2 = cur[2].acc, a3 = cur[3].acc;
    int64_t n0 = cur[0].nbits, n1 = cur[1].nbits, n2 = cur[2].nbits, n3 = cur[3].nbits;
    int64_t r0 = cur[0].r, r1 = cur[1].r, r2 = cur[2].r, r3 = cur[3].r;
    int64_t o0 = cur[0].oi, o1 = cur[1].oi, o2 = cur[2].oi, o3 = cur[3].oi;
    const int64_t e0 = cur[0].end, e1 = cur[1].end, e2 = cur[2].end, e3 = cur[3].end;
    while (!err) {
      int64_t T = (e0 - o0) / 3;
      int64_t t1 = (e1 - o1) / 3, t2 = (e2 - o2) / 3, t3 = (e3 - o3) / 3;
      if (t1 < T) T = t1;
      if (t2 < T) T = t2;
      if (t3 < T) T = t3;
      int64_t s0 = (comp_len - r0) >> 2, s1 = (comp_len - r1) >> 2;
      int64_t s2 = (comp_len - r2) >> 2, s3 = (comp_len - r3) >> 2;
      if (s0 < T) T = s0;
      if (s1 < T) T = s1;
      if (s2 < T) T = s2;
      if (s3 < T) T = s3;
      if (T <= 0) break;
      for (int64_t t = 0; t < T; t++) {
        DCZ_FSTEP(a0, n0, r0, o0);
        DCZ_FSTEP(a1, n1, r1, o1);
        DCZ_FSTEP(a2, n2, r2, o2);
        DCZ_FSTEP(a3, n3, r3, o3);
      }
    }
    cur[0] = {a0, n0, r0, o0, e0};
    cur[1] = {a1, n1, r1, o1, e1};
    cur[2] = {a2, n2, r2, o2, e2};
    cur[3] = {a3, n3, r3, o3, e3};
    if (err) return -1;
  }
  // Tails (and the whole input when ngaps < W): per-cursor fast loop with
  // per-step bounds, then the careful drain for the last <= 2 symbols and
  // the byte-wise stream tail.
  for (int k = 0; k < W; k++) {
    Cursor& cu = cur[k];
    while (!err && cu.oi + 3 <= cu.end && cu.r + 4 <= comp_len) {
      DCZ_FSTEP(cu.acc, cu.nbits, cu.r, cu.oi);
    }
    if (err) return -1;
    drain(cu);
    if (err) return -1;
  }
#undef DCZ_FSTEP
  return 0;
}

}  // extern "C"
