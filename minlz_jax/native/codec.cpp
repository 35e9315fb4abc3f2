// Native host block codec for MinLZ in JAX.
//
// Implements the MinLZ specification v1.0 block format: a margin-split
// decoder (fast loop + strict tail) and a greedy hash-table LZ77 encoder
// with four effort levels.  This is the host-side runtime path (CLI, stream
// fallback for foreign hint-less blocks); the device kernels are the primary
// compute path.  Behavioral parity targets: reference decode.go:178 and
// encode_l1.go:39 (clean-room from SPEC.md).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define MINLZ_EXPORT __attribute__((visibility("default")))

namespace {

constexpr size_t kMaxBlock = 8u << 20;

inline uint16_t load16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline void store16(uint8_t* p, uint16_t v) { memcpy(p, &v, 2); }
inline void store32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// Returns bytes written to dst, or -1 on corrupt input.
long decode_body(const uint8_t* src, size_t slen, uint8_t* dst, size_t want,
                 size_t d0 = 0) {
  // d0: window seed length — dst[0, d0) holds pre-loaded context (dict
  // decode); `want` includes it.  Copies may reach back into the seed.
  size_t s = 0, d = d0;
  uint32_t offset = 1;

  while (s < slen) {
    uint32_t b = src[s++];
    uint32_t tag = b & 3;
    uint32_t val = b >> 2;
    uint32_t length;

    if (tag == 0) {
      bool repeat = val & 1;
      uint32_t code = val >> 1;
      if (code < 29) {
        length = code + 1;
      } else {
        uint32_t nb = code - 28;
        if (s + nb > slen) return -1;
        length = 0;
        for (uint32_t i = 0; i < nb; i++) length |= (uint32_t)src[s + i] << (8 * i);
        length += 30;
        s += nb;
      }
      if (!repeat) {
        if (s + length > slen || d + length > want) return -1;
        // Literal copy; memcpy is safe (disjoint buffers).
        memcpy(dst + d, src + s, length);
        s += length;
        d += length;
        continue;
      }
      // repeat: fall through to copy with current offset
    } else if (tag == 1) {
      if (s >= slen) return -1;
      uint32_t lcode = val & 15;
      offset = ((uint32_t)src[s] << 2 | (val >> 4)) + 1;
      s++;
      if (lcode == 15) {
        if (s >= slen) return -1;
        length = (uint32_t)src[s++] + 18;
      } else {
        length = lcode + 4;
      }
    } else if (tag == 2) {
      if (s + 2 > slen) return -1;
      offset = ((uint32_t)src[s] | (uint32_t)src[s + 1] << 8) + 64;
      s += 2;
      if (val <= 60) {
        length = val + 4;
      } else {
        uint32_t nb = val - 60;
        if (s + nb > slen) return -1;
        length = 0;
        for (uint32_t i = 0; i < nb; i++) length |= (uint32_t)src[s + i] << (8 * i);
        length += 64;
        s += nb;
      }
    } else {
      bool is3 = val & 1;
      uint32_t litlen = (val >> 1) & 3;
      if (!is3) {
        // Fused Copy2
        if (s + 2 > slen) return -1;
        offset = ((uint32_t)src[s] | (uint32_t)src[s + 1] << 8) + 64;
        s += 2;
        length = (val >> 3) + 4;
        litlen += 1;
      } else {
        if (s + 3 > slen) return -1;
        uint32_t full = val | ((uint32_t)src[s] | (uint32_t)src[s + 1] << 8 |
                               (uint32_t)src[s + 2] << 16)
                                  << 6;
        s += 3;
        offset = (full >> 9) + 65536;
        uint32_t code = (full >> 3) & 63;
        if (code < 61) {
          length = code + 4;
        } else {
          uint32_t nb = code - 60;
          if (s + nb > slen) return -1;
          length = 0;
          for (uint32_t i = 0; i < nb; i++) length |= (uint32_t)src[s + i] << (8 * i);
          length += 64;
          s += nb;
        }
      }
      if (litlen) {
        if (s + litlen > slen || d + litlen > want) return -1;
        memcpy(dst + d, src + s, litlen);
        s += litlen;
        d += litlen;
      }
    }

    // Execute copy.
    if (offset > d || d + length > want) return -1;
    size_t from = d - offset;
    if (offset >= length) {
      memcpy(dst + d, dst + from, length);
    } else {
      // Overlapping copy is periodic with period `offset`; replicate by
      // doubling, always sourcing a whole number of periods back so every
      // source byte is already final.
      size_t done = 0;
      size_t avail = offset;
      while (done < length) {
        size_t take = length - done < avail ? length - done : avail;
        memcpy(dst + d + done, dst + d + done - avail, take);
        done += take;
        avail *= 2;
      }
    }
    d += length;
  }
  return d == want ? (long)d : -1;
}

// ---------------------------------------------------------------------------
// Encoder: greedy single-slot hash table (reference L1-style)
// ---------------------------------------------------------------------------

inline uint32_t hash4(uint32_t v, int bits) {
  return (v * 2654435761u) >> (32 - bits);
}
inline uint32_t hash8(uint64_t v, int bits) {
  return (uint32_t)((v * 0x9E3779B185EBCA87ull) >> (64 - bits));
}

// 8-byte-XOR forward match extension.
inline size_t match_len(const uint8_t* a, const uint8_t* b, size_t max) {
  size_t i = 0;
  while (i + 8 <= max) {
    uint64_t diff = load64(a + i) ^ load64(b + i);
    if (diff) return i + (__builtin_ctzll(diff) >> 3);
    i += 8;
  }
  while (i < max && a[i] == b[i]) i++;
  return i;
}

void emit_literals(std::vector<uint8_t>& out, const uint8_t* lits, size_t n) {
  if (!n) return;
  if (n < 30) {
    out.push_back((uint8_t)((n - 1) << 3));
  } else {
    uint32_t v = n - 30;
    if (v < 256) {
      out.push_back(29 << 3);
      out.push_back((uint8_t)v);
    } else if (v < 65536) {
      out.push_back(30 << 3);
      out.push_back((uint8_t)v);
      out.push_back((uint8_t)(v >> 8));
    } else {
      out.push_back(31u << 3);
      out.push_back((uint8_t)v);
      out.push_back((uint8_t)(v >> 8));
      out.push_back((uint8_t)(v >> 16));
    }
  }
  out.insert(out.end(), lits, lits + n);
}

void emit_repeat(std::vector<uint8_t>& out, uint32_t length) {
  uint32_t v = length - 1;
  if (v < 29) {
    out.push_back((uint8_t)(v << 3 | 4));
    return;
  }
  v = length - 30;
  if (v < 256) {
    out.push_back(29 << 3 | 4);
    out.push_back((uint8_t)v);
  } else if (v < 65536) {
    out.push_back(30 << 3 | 4);
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
  } else {
    out.push_back((uint8_t)(31u << 3 | 4));
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)(v >> 16));
  }
}

void emit_copy1(std::vector<uint8_t>& out, uint32_t offset, uint32_t length) {
  uint32_t o = offset - 1;
  if (length <= 18) {
    uint16_t x = (uint16_t)(o << 6 | (length - 4) << 2 | 1);
    out.push_back((uint8_t)x);
    out.push_back((uint8_t)(x >> 8));
  } else if (length <= 273) {
    uint16_t x = (uint16_t)(o << 6 | 15 << 2 | 1);
    out.push_back((uint8_t)x);
    out.push_back((uint8_t)(x >> 8));
    out.push_back((uint8_t)(length - 18));
  } else {
    uint16_t x = (uint16_t)(o << 6 | 14 << 2 | 1);
    out.push_back((uint8_t)x);
    out.push_back((uint8_t)(x >> 8));
    emit_repeat(out, length - 18);
  }
}

void emit_copy2(std::vector<uint8_t>& out, uint32_t offset, uint32_t length) {
  uint32_t o = offset - 64;
  uint32_t l = length - 4;
  if (l <= 60) {
    out.push_back((uint8_t)(l << 2 | 2));
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    return;
  }
  l -= 60;
  if (l < 256) {
    out.push_back(61 << 2 | 2);
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    out.push_back((uint8_t)l);
  } else if (l < 65536) {
    out.push_back(62 << 2 | 2);
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    out.push_back((uint8_t)l);
    out.push_back((uint8_t)(l >> 8));
  } else {
    out.push_back((uint8_t)(63u << 2 | 2));
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    out.push_back((uint8_t)l);
    out.push_back((uint8_t)(l >> 8));
    out.push_back((uint8_t)(l >> 16));
  }
}

void emit_copy3(std::vector<uint8_t>& out, uint32_t offset, uint32_t length,
                const uint8_t* lits, uint32_t nlits) {
  uint32_t o = offset - 65536;
  uint32_t l = length - 4;
  uint32_t word = 7 | nlits << 3 | o << 11;
  if (l <= 60) {
    word |= l << 5;
    out.push_back((uint8_t)word);
    out.push_back((uint8_t)(word >> 8));
    out.push_back((uint8_t)(word >> 16));
    out.push_back((uint8_t)(word >> 24));
  } else {
    l -= 60;
    uint32_t code = l < 256 ? 61 : l < 65536 ? 62 : 63;
    word |= code << 5;
    out.push_back((uint8_t)word);
    out.push_back((uint8_t)(word >> 8));
    out.push_back((uint8_t)(word >> 16));
    out.push_back((uint8_t)(word >> 24));
    out.push_back((uint8_t)l);
    if (code >= 62) out.push_back((uint8_t)(l >> 8));
    if (code == 63) out.push_back((uint8_t)(l >> 16));
  }
  out.insert(out.end(), lits, lits + nlits);
}

void emit_fused2(std::vector<uint8_t>& out, const uint8_t* lits,
                 uint32_t nlits, uint32_t offset, uint32_t length) {
  uint32_t o = offset - 64;
  uint32_t l = length - 4;
  if (l > 7) {
    out.push_back((uint8_t)(3 | (nlits - 1) << 3 | 7u << 5));
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    out.insert(out.end(), lits, lits + nlits);
    emit_repeat(out, l - 7);
  } else {
    out.push_back((uint8_t)(3 | (nlits - 1) << 3 | l << 5));
    out.push_back((uint8_t)o);
    out.push_back((uint8_t)(o >> 8));
    out.insert(out.end(), lits, lits + nlits);
  }
}

size_t put_uvarint(uint8_t* p, uint64_t v) {
  size_t i = 0;
  while (v >= 0x80) {
    p[i++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  p[i++] = (uint8_t)v;
  return i;
}

long encode_greedy(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                   int table_bits, int skip_log) {
  std::vector<uint32_t> table((size_t)1 << table_bits, 0);
  const size_t s_limit = n - 4;
  const size_t dst_limit = n - 1;  // body must be < n

  size_t next_emit = 0;
  size_t s = 1;
  uint32_t rep = 0;

  while (true) {
    // Probe for a match, accelerating through incompressible regions
    // (reference skip heuristic: step grows with literal run length).
    size_t candidate;
    uint32_t cv;
    while (true) {
      if (s > s_limit) goto remainder;
      cv = load32(src + s);
      uint32_t h = hash4(cv, table_bits);
      candidate = table[h];
      table[h] = (uint32_t)s;
      if (candidate && s - candidate <= (2u << 20) + 65535 &&
          cv == load32(src + candidate))
        break;
      s += 1 + ((s - next_emit) >> skip_log);
    }
    {
      size_t base = s;
      size_t c = candidate + 4;
      s += 4;
      while (s < n && src[s] == src[c]) {
        s++;
        c++;
      }
      // Backward extension over pending literals.
      while (base > next_emit && candidate > 0 &&
             src[base - 1] == src[candidate - 1]) {
        base--;
        candidate--;
      }
      uint32_t offset = (uint32_t)(base - candidate);
      uint32_t length = (uint32_t)(s - base);
      size_t nlits = base - next_emit;
      const uint8_t* lits = src + next_emit;

      bool fused = false;
      if (nlits && offset != rep && offset >= 64 &&
          (nlits <= 3 || (offset <= 65599 && nlits <= 4))) {
        if (offset <= 65599) {
          emit_fused2(out, lits, (uint32_t)nlits, offset, length);
        } else {
          emit_copy3(out, offset, length, lits, (uint32_t)nlits);
        }
        fused = true;
      } else if (nlits) {
        if (out.size() + nlits > dst_limit) return -1;
        emit_literals(out, lits, nlits);
      }
      if (!fused) {
        if (offset == rep) {
          emit_repeat(out, length);
        } else if (offset <= 1024) {
          emit_copy1(out, offset, length);
        } else if (offset <= 65599) {
          emit_copy2(out, offset, length);
        } else {
          emit_copy3(out, offset, length, nullptr, 0);
        }
      }
      rep = offset;
      next_emit = s;
      if (s > s_limit) goto remainder;
      if (out.size() > dst_limit) return -1;

      // Index interior positions (denser for better ratio at small cost).
      size_t step = length < 256 ? 1 : 2;
      for (size_t i = base + 1; i + 4 <= s && i + 4 <= n; i += step)
        table[hash4(load32(src + i), table_bits)] = (uint32_t)i;
    }
  }

remainder:
  if (next_emit < n) {
    if (out.size() + (n - next_emit) > dst_limit) return -1;
    emit_literals(out, src + next_emit, n - next_emit);
  }
  return (long)out.size();
}

// ---------------------------------------------------------------------------
// Level 2 "Balanced": dual hash tables (long 8-byte + short 4-byte probes).
// Behavioral model: reference encode_l2.go (two-table probe preferring
// 8-byte-confirmed long matches); clean-room implementation.
// ---------------------------------------------------------------------------

constexpr uint32_t kMaxOffset = (2u << 20) + 65535;

inline uint32_t literal_cost(size_t n) {
  if (n == 0) return 0;
  if (n < 30) return 1 + n;
  size_t v = n - 30;
  return (v < 256 ? 2 : v < 65536 ? 3 : 4) + n;
}

// Shared emit step used by L2/L3 once a match (base, offset, length) is
// chosen: pending literals [next_emit, base) + the copy token, with fused
// variants when profitable.  Updates rep.  Returns false on output overflow.
inline void emit_match(std::vector<uint8_t>& out, const uint8_t* src,
                       size_t next_emit, size_t base, uint32_t offset,
                       uint32_t length, uint32_t& rep) {
  size_t nlits = base - next_emit;
  const uint8_t* lits = src + next_emit;
  if (offset == rep) {
    if (nlits) emit_literals(out, lits, nlits);
    emit_repeat(out, length);
    return;
  }
  if (nlits && offset >= 64 &&
      (nlits <= 3 || (offset <= 65599 && nlits <= 4))) {
    if (offset <= 65599) {
      emit_fused2(out, lits, (uint32_t)nlits, offset, length);
    } else {
      emit_copy3(out, offset, length, lits, (uint32_t)nlits);
    }
  } else {
    if (nlits) emit_literals(out, lits, nlits);
    if (offset <= 1024) emit_copy1(out, offset, length);
    else if (offset <= 65599) emit_copy2(out, offset, length);
    else emit_copy3(out, offset, length, nullptr, 0);
  }
  rep = offset;
}

long encode_balanced(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  const int lbits = n < (64u << 10) ? 16 : 17;
  const int sbits = n < (64u << 10) ? 13 : 14;
  std::vector<uint32_t> longT((size_t)1 << lbits, 0);
  std::vector<uint32_t> shortT((size_t)1 << sbits, 0);
  const size_t s_limit = n - 8;
  const size_t dst_limit = n - (n >> 5) - 6;

  size_t next_emit = 0, s = 1;
  uint32_t rep = 0;

  while (s <= s_limit) {
    uint64_t cv = load64(src + s);
    uint32_t hl = hash8(cv, lbits);
    uint32_t hs = hash4((uint32_t)cv, sbits);
    size_t candL = longT[hl], candS = shortT[hs];
    longT[hl] = (uint32_t)s;
    shortT[hs] = (uint32_t)s;

    size_t best_cand = 0, best_len = 0;
    // Repeat first: 1-byte emit beats anything of similar length.
    if (rep && s >= rep && load32(src + s) == load32(src + s - rep)) {
      size_t l = 4 + match_len(src + s + 4, src + s - rep + 4, n - s - 4);
      // Emit immediately: repeats are nearly free.
      size_t base = s;
      emit_match(out, src, next_emit, base, rep, (uint32_t)l, rep);
      s += l;
      next_emit = s;
      if (out.size() > dst_limit) return -1;
      if (s > s_limit) break;
      // Index the skipped span sparsely.
      for (size_t i = base + 1; i + 8 <= s; i += 2) {
        uint64_t v = load64(src + i);
        longT[hash8(v, lbits)] = (uint32_t)i;
        shortT[hash4((uint32_t)v, sbits)] = (uint32_t)i;
      }
      continue;
    }
    if (candL && s - candL <= kMaxOffset && load32(src + candL) == (uint32_t)cv) {
      best_cand = candL;
      best_len = 4 + match_len(src + s + 4, src + candL + 4, n - s - 4);
    }
    if (candS && s - candS <= kMaxOffset && load32(src + candS) == (uint32_t)cv) {
      size_t l = 4 + match_len(src + s + 4, src + candS + 4, n - s - 4);
      // Prefer the shorter-offset short candidate on ties (cheaper token).
      if (l > best_len || (l == best_len && candS > best_cand)) {
        best_cand = candS;
        best_len = l;
      }
    }
    if (best_len >= 4) {
      // Lazy lookahead: a strictly better match one byte ahead wins.
      if (best_len < 32 && s + 1 <= s_limit) {
        uint64_t cv1 = load64(src + s + 1);
        uint32_t hl1 = hash8(cv1, lbits);
        uint32_t hs1 = hash4((uint32_t)cv1, sbits);
        size_t c1 = longT[hl1], c1s = shortT[hs1];
        size_t l1 = 0;
        if (c1 && s + 1 - c1 <= kMaxOffset &&
            load32(src + c1) == (uint32_t)cv1)
          l1 = 4 + match_len(src + s + 5, src + c1 + 4, n - s - 5);
        if (c1s && s + 1 - c1s <= kMaxOffset &&
            load32(src + c1s) == (uint32_t)cv1) {
          size_t l1s = 4 + match_len(src + s + 5, src + c1s + 4, n - s - 5);
          if (l1s > l1) l1 = l1s;
        }
        if (l1 > best_len + 1) {
          s++;
          continue;  // the next iteration re-probes (and re-inserts) s+1
        }
      }
      size_t base = s, cand = best_cand;
      while (base > next_emit && cand > 0 && src[base - 1] == src[cand - 1]) {
        base--;
        cand--;
        best_len++;
      }
      uint32_t offset = (uint32_t)(base - cand);
      emit_match(out, src, next_emit, base, offset, (uint32_t)best_len, rep);
      size_t end = base + best_len;
      if (out.size() > dst_limit) return -1;
      // Index interior positions.
      size_t step = best_len < 512 ? 1 : 2;
      size_t i = s + 1;
      for (; i + 8 <= end; i += step) {
        uint64_t v = load64(src + i);
        longT[hash8(v, lbits)] = (uint32_t)i;
        shortT[hash4((uint32_t)v, sbits)] = (uint32_t)i;
      }
      // Tail positions still feed the short table (next match often
      // starts right after this one).
      for (; i + 4 <= end && i + 4 <= n; i++)
        shortT[hash4(load32(src + i), sbits)] = (uint32_t)i;
      s = end;
      next_emit = s;
      continue;
    }
    s += 1 + ((s - next_emit) >> 7);
  }

  if (next_emit < n) {
    if (out.size() + literal_cost(n - next_emit) > dst_limit) return -1;
    emit_literals(out, src + next_emit, n - next_emit);
  }
  return (long)out.size();
}

// ---------------------------------------------------------------------------
// Optimal parse: forward DP over (position, repeat-offset) states with a
// small beam, hash-chain match finder, and the exact emitter cost model.
//
// Behavioral match: this subsumes the reference L3's scored-candidate search
// (encode_l3.go:118-169,633-699 — emit-cost-aware gains, repeat + lookahead
// candidates, fused-literal discounts): a DP that prices every token with
// the true on-wire emitter cost and keeps the best arrival per repeat-state
// considers strictly more parses than a greedy scan with lookahead.  Not a
// translation — the reference has no DP; this design trades the reference's
// single-pass heuristics for parse optimality at bounded beam width.
// ---------------------------------------------------------------------------

// Exact on-wire costs, mirrors the emitters above byte for byte.
inline uint32_t cost_lit_hdr(uint32_t run) {
  // Header bytes for a literal run of `run` (excl. the literal bytes).
  if (run < 30) return 1;
  if (run < 286) return 2;
  if (run < 65566) return 3;
  return 4;
}

inline uint32_t cost_repeat(uint32_t len) {
  if (len - 1 < 29) return 1;
  uint32_t v = len - 30;
  return v < 256 ? 2 : v < 65536 ? 3 : 4;
}

inline uint32_t cost_copy(uint32_t offset, uint32_t len) {
  if (offset <= 1024) {  // copy1 (+ repeat extension past 273)
    if (len <= 18) return 2;
    if (len <= 273) return 3;
    return 2 + cost_repeat(len - 18);
  }
  if (offset <= 65599) {  // copy2
    uint32_t l = len - 4;
    if (l <= 60) return 3;
    l -= 60;
    return l < 256 ? 4 : l < 65536 ? 5 : 6;
  }
  // copy3
  uint32_t l = len - 4;
  if (l <= 60) return 4;
  l -= 60;
  return l < 256 ? 5 : l < 65536 ? 6 : 7;
}

namespace optimal {

// Parent-edge packing: type(2) | slot(3) | len(23) | offset(22).
enum : uint32_t { kLit = 0, kCopy = 1, kRep = 2, kFused = 3 };

inline uint64_t pack_edge(uint32_t type, uint32_t slot, uint32_t len,
                          uint32_t off) {
  return (uint64_t)type | ((uint64_t)slot << 2) | ((uint64_t)len << 5) |
         ((uint64_t)off << 28);
}

struct Slot {
  uint32_t cost = 0xFFFFFFFFu;
  uint32_t rep = 0;
  uint32_t litrun = 0;
  uint64_t parent = 0;
};

struct Dp {
  const uint8_t* src;
  size_t n;
  int beam;
  std::vector<Slot> st;  // (n+1) * beam

  Slot* at(size_t i) { return st.data() + i * beam; }

  void push(size_t i, uint32_t rep, uint32_t cost, uint32_t litrun,
            uint64_t parent) {
    Slot* s = at(i);
    int worst = 0;
    for (int k = 0; k < beam; k++) {
      if (s[k].cost != 0xFFFFFFFFu && s[k].rep == rep) {
        if (cost < s[k].cost ||
            (cost == s[k].cost && litrun < s[k].litrun)) {
          s[k] = {cost, rep, litrun, parent};
        }
        return;
      }
      if (s[k].cost == 0xFFFFFFFFu) { worst = k; break; }
      if (s[k].cost > s[worst].cost) worst = k;
    }
    if (cost < s[worst].cost) s[worst] = {cost, rep, litrun, parent};
  }
};

}  // namespace optimal

// Optimal-parse encoder.  beam: arrival states kept per position (keyed by
// repeat offset); chain: hash-chain search depth.  ctx: length of a
// dictionary/context prefix at the start of `src` — those bytes are indexed
// as match sources but not encoded (reference analog: the dict-candidate
// paths in encode_l2.go:607 / encode_l3.go:278-296).  Returns -1 on
// overflow (incompressible under dst_limit).
long encode_optimal(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                    int beam, int chain_depth, size_t ctx = 0) {
  using namespace optimal;
  const size_t n_src = n - ctx;
  const size_t dst_limit = n_src - 5;
  if (n_src < 16) return -1;

  // Beam scaling keeps the DP state array bounded (~24B * n * beam).
  if (n > (1u << 20)) beam = beam > 2 ? 2 : beam;
  if (n > (4u << 20)) beam = 1;

  const int hbits = n >= (1u << 20) ? 17 : 15;
  std::vector<int32_t> head((size_t)1 << hbits, -1);
  std::vector<int32_t> prev(n, -1);

  Dp dp{src, n, beam, {}};
  dp.st.assign((n + 1) * (size_t)beam, Slot{});
  // Initial repeat offset is 1 per SPEC (decoder starts with rep = 1), so a
  // leading RLE run can use repeat ops immediately.
  dp.push(ctx, 1, 0, 0, 0);

  const size_t match_limit = n >= 8 ? n - 8 : 0;

  // Pre-seed the chains with the context prefix (sources only).
  for (size_t i = 0; i < ctx && i < match_limit; i++) {
    uint32_t h = hash4(load32(src + i), hbits);
    prev[i] = head[h];
    head[h] = (int32_t)i;
  }

  // Candidate buffer per position: best (longest, then nearest) match per
  // offset cost class: [0] <=1024, [1] <=65599, [2] <=kMaxOffset.
  uint32_t cand_off[3], cand_len[3];

  for (size_t i = ctx; i < n; i++) {
    Slot* cur = dp.at(i);

    // --- find candidates at i (once; shared by all slots) ---
    int ncls = 0;
    cand_len[0] = cand_len[1] = cand_len[2] = 0;
    if (i >= 1 && i < match_limit) {
      uint32_t cv = load32(src + i);
      int32_t j = head[hash4(cv, hbits)];
      int depth = 0;
      while (j >= 0 && depth < chain_depth) {
        uint32_t off = (uint32_t)(i - j);
        if (off > kMaxOffset) break;  // chain is position-ordered
        if (load32(src + (size_t)j) == cv) {
          size_t l =
              4 + match_len(src + i + 4, src + (size_t)j + 4, n - i - 4);
          int cls = off <= 1024 ? 0 : off <= 65599 ? 1 : 2;
          if (l > cand_len[cls]) {
            cand_len[cls] = (uint32_t)l;
            cand_off[cls] = off;
            ncls++;
          }
        }
        j = prev[(size_t)j];
        depth++;
      }
    }

    for (int k = 0; k < beam; k++) {
      if (cur[k].cost == 0xFFFFFFFFu) continue;
      const uint32_t cost = cur[k].cost;
      const uint32_t rep = cur[k].rep;
      const uint32_t litrun = cur[k].litrun;

      // Literal step: charge the byte plus any header growth.
      {
        uint32_t lr = litrun + 1;
        uint32_t extra = 1 + (cost_lit_hdr(lr) - (litrun ? cost_lit_hdr(litrun) : 0));
        dp.push(i + 1, rep, cost + extra, lr,
                pack_edge(kLit, k, 1, 0));
      }

      // Repeat: min length 1 byte.
      if (rep && i >= rep && i < n) {
        size_t maxl = match_len(src + i, src + i - rep, n - i);
        if (maxl >= 1) {
          uint32_t ls[3] = {(uint32_t)maxl, 29, 285};
          for (uint32_t L : ls) {
            if (L < 1 || L > maxl) continue;
            dp.push(i + L, rep, cost + cost_repeat(L), 0,
                    pack_edge(kRep, k, L, rep));
          }
        }
      }

      if (!ncls) continue;
      for (int cls = 0; cls < 3; cls++) {
        uint32_t maxl = cand_len[cls];
        if (maxl < 4) continue;
        uint32_t off = cand_off[cls];
        if (off == rep) continue;  // covered by the repeat transition
        // Cost-class boundary lengths + the full match.
        uint32_t ls[5];
        int nl = 0;
        ls[nl++] = maxl;
        if (cls == 0) {
          if (maxl > 18) ls[nl++] = 18;
          if (maxl > 273) ls[nl++] = 273;
        } else {
          if (maxl > 64) ls[nl++] = 64;
        }
        if (maxl > 4) ls[nl++] = 4;
        for (int q = 0; q < nl; q++) {
          uint32_t L = ls[q];
          dp.push(i + L, off, cost + cost_copy(off, L), 0,
                  pack_edge(kCopy, k, L, off));
        }
        // Fused copy2: folds a 1-4 byte pending literal run into the
        // token, saving the run's 1-byte header.
        if (litrun >= 1 && litrun <= 4 && off >= 64 && off <= 65599) {
          uint32_t L = maxl < 11 ? maxl : 11;
          dp.push(i + L, off, cost + 2, 0, pack_edge(kFused, k, L, off));
        }
        // Copy3 carries 0-3 fused literals: same 1-byte header saving.
        if (litrun >= 1 && litrun <= 3 && off > 65599) {
          dp.push(i + maxl, off, cost + cost_copy(off, maxl) - 1, 0,
                  pack_edge(kFused, k, maxl, off));
        }
      }
    }

    if (i < match_limit) {
      uint32_t h = hash4(load32(src + i), hbits);
      prev[i] = head[h];
      head[h] = (int32_t)i;
    }
  }

  // --- pick the cheapest arrival at n and backtrack ---
  Slot* fin = dp.at(n);
  int bk = -1;
  for (int k = 0; k < beam; k++) {
    if (fin[k].cost == 0xFFFFFFFFu) continue;
    if (bk < 0 || fin[k].cost < fin[bk].cost) bk = k;
  }
  if (bk < 0 || fin[bk].cost > dst_limit) return -1;

  // Reconstruct edges newest-first.
  struct Edge {
    uint32_t type, len, off;
  };
  std::vector<Edge> edges;
  {
    size_t i = n;
    int k = bk;
    while (i > ctx) {
      uint64_t e = dp.at(i)[k].parent;
      uint32_t type = (uint32_t)(e & 3);
      uint32_t slot = (uint32_t)((e >> 2) & 7);
      uint32_t len = (uint32_t)((e >> 5) & 0x7FFFFF);
      uint32_t off = (uint32_t)(e >> 28);
      edges.push_back({type, len, off});
      i -= len;
      k = (int)slot;
    }
  }

  // Emit forward, merging literal steps into runs.
  size_t pos = ctx, run = 0;
  for (size_t e = edges.size(); e-- > 0;) {
    const Edge& ed = edges[e];
    switch (ed.type) {
      case kLit:
        run += ed.len;
        pos += ed.len;
        break;
      case kRep:
        if (run) emit_literals(out, src + pos - run, run), run = 0;
        emit_repeat(out, ed.len);
        pos += ed.len;
        break;
      case kCopy:
        if (run) emit_literals(out, src + pos - run, run), run = 0;
        if (ed.off <= 1024) emit_copy1(out, ed.off, ed.len);
        else if (ed.off <= 65599) emit_copy2(out, ed.off, ed.len);
        else emit_copy3(out, ed.off, ed.len, nullptr, 0);
        pos += ed.len;
        break;
      case kFused: {
        const uint8_t* lits = src + pos - run;
        if (ed.off <= 65599) {
          emit_fused2(out, lits, (uint32_t)run, ed.off, ed.len);
        } else {
          emit_copy3(out, ed.off, ed.len, lits, (uint32_t)run);
        }
        run = 0;
        pos += ed.len;
        break;
      }
    }
    if (out.size() > dst_limit) return -1;
  }
  if (run) {
    if (out.size() + literal_cost(run) > dst_limit) return -1;
    emit_literals(out, src + pos - run, run);
  }
  return (long)out.size();
}

}  // namespace

extern "C" {

// Decode a full block (with 0x00 marker + uvarint header).
// Returns bytes written or negative on error.
MINLZ_EXPORT long minlz_decode_block(const uint8_t* src, size_t slen,
                                     uint8_t* dst, size_t dcap) {
  if (slen == 0 || src[0] != 0) return -1;
  if (slen == 1) return 0;
  size_t pos = 1;
  uint64_t want = 0;
  int shift = 0;
  while (true) {
    if (pos >= slen || shift > 63) return -1;
    uint8_t b = src[pos++];
    want |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (want > kMaxBlock) return -1;
  if (want == 0) {
    // Literal-only block.
    size_t n = slen - pos;
    if (n > dcap) return -2;
    memcpy(dst, src + pos, n);
    return (long)n;
  }
  if (want < slen - pos) return -1;
  if (want > dcap) return -2;
  return decode_body(src + pos, slen - pos, dst, want);
}

// Encode a block at the given level (-1, 1, 2, 3). Returns bytes written.
MINLZ_EXPORT long minlz_encode_block(const uint8_t* src, size_t n,
                                     uint8_t* dst, size_t dcap, int level) {
  if (n > kMaxBlock) return -1;
  auto uncompressed = [&]() -> long {
    if (n == 0) {
      if (dcap < 1) return -2;
      dst[0] = 0;
      return 1;
    }
    if (n + 2 > dcap) return -2;
    dst[0] = 0;
    dst[1] = 0;
    memcpy(dst + 2, src, n);
    return (long)(n + 2);
  };
  if (n <= 16) return uncompressed();

  std::vector<uint8_t> body;
  body.reserve(n / 2);
  long blen;
  // Small-block polish: below these sizes every level can afford the
  // optimal-parse DP (the reference similarly swaps in dedicated 64K
  // encoder variants for small inputs, encode_amd64.go:37-271); beam/chain
  // scale with level.  Large blocks keep the level's streaming encoder.
  const size_t polish_cap = level >= 2   ? (256u << 10)
                            : level == 1 ? (64u << 10)
                                         : (32u << 10);
  if (n <= polish_cap) {
    int beam = level >= 3 ? 8 : level == 2 ? 4 : 2;
    int chain = level >= 3 ? 192 : level == 2 ? 64 : level == 1 ? 32 : 16;
    blen = encode_optimal(src, n, body, beam, chain);
  } else if (level >= 3) {
    blen = encode_optimal(src, n, body, 4, 96);
  } else if (level == 2) {
    blen = encode_balanced(src, n, body);
  } else {
    int bits = level <= -1 ? 13 : 15;
    int skip_log = level <= -1 ? 5 : 6;
    // Size-class the table like the reference's 1K..8MB asm variants:
    // small inputs never fill a big table, so shrink it for cache locality.
    while (bits > 8 && ((size_t)1 << (bits + 2)) > n) bits--;
    blen = encode_greedy(src, n, body, bits, skip_log);
  }
  if (blen < 0) return uncompressed();

  uint8_t hdr[12];
  size_t hl = 1;
  hdr[0] = 0;
  hl += put_uvarint(hdr + 1, n);
  if (hl + body.size() > dcap) return -2;
  memcpy(dst, hdr, hl);
  memcpy(dst + hl, body.data(), body.size());
  return (long)(hl + body.size());
}

// Dictionary encode: `combined` = dict || src (ctx = dict length).  Copies
// may reach back into the dictionary; output is a block for src only.
// Levels map to the optimal-parse effort ladder (reference dict-candidate
// analog: encode_l2.go:607 / encode_l3.go:278-296,382-395).
MINLZ_EXPORT long minlz_encode_block_dict(const uint8_t* combined, size_t n,
                                          size_t ctx, uint8_t* dst,
                                          size_t dcap, int level) {
  if (n > kMaxBlock + (64u << 10) || ctx > n) return -1;
  const size_t n_src = n - ctx;
  auto uncompressed = [&]() -> long {
    if (n_src + 2 > dcap) return -2;
    dst[0] = 0;
    dst[1] = 0;
    memcpy(dst + 2, combined + ctx, n_src);
    return (long)(n_src + 2);
  };
  if (n_src <= 16) return uncompressed();
  std::vector<uint8_t> body;
  body.reserve(n_src / 2);
  int beam = level >= 3 ? 8 : level == 2 ? 4 : 2;
  int chain = level >= 3 ? 192 : level == 2 ? 64 : level == 1 ? 32 : 16;
  long blen = encode_optimal(combined, n, body, beam, chain, ctx);
  if (blen < 0) return uncompressed();
  uint8_t hdr[12];
  size_t hl = 1;
  hdr[0] = 0;
  hl += put_uvarint(hdr + 1, n_src);
  if (hl + body.size() > dcap) return -2;
  memcpy(dst, hdr, hl);
  memcpy(dst + hl, body.data(), body.size());
  return (long)(hl + body.size());
}

// Dictionary decode: dst capacity must cover ctx + decoded size; the caller
// pre-fills dst[0, ctx) with the dictionary and reads the tail.  Returns
// bytes decoded (excluding ctx) or negative on error.
MINLZ_EXPORT long minlz_decode_block_dict(const uint8_t* src, size_t slen,
                                          uint8_t* dst, size_t dcap,
                                          size_t ctx) {
  if (slen == 0 || src[0] != 0) return -1;
  if (slen == 1) return 0;
  size_t pos = 1;
  uint64_t want = 0;
  int shift = 0;
  while (true) {
    if (pos >= slen || shift > 63) return -1;
    uint8_t b = src[pos++];
    want |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (want > kMaxBlock) return -1;
  if (want == 0) {
    size_t nn = slen - pos;
    if (ctx + nn > dcap) return -2;
    memcpy(dst + ctx, src + pos, nn);
    return (long)nn;
  }
  if (want < slen - pos) return -1;
  if (ctx + want > dcap) return -2;
  long d = decode_body(src + pos, slen - pos, dst, ctx + want, ctx);
  return d < 0 ? d : d - (long)ctx;
}

// LZ4 block -> MinLZ block transcode WITHOUT decompression: token-by-token
// translation of LZ4 literal/match sequences into MinLZ literal/copy/repeat
// ops with last-offset tracking.  Native runtime analog of the reference's
// cvtLZ4BlockAsm fast path (lz4convert.go:39-231, asm glue :53-73).
// Returns the full MinLZ block length written to dst (marker + uvarint +
// ops), -1 on corrupt LZ4 input, -2 when dst is too small.
MINLZ_EXPORT long minlz_lz4_convert_block(const uint8_t* src, size_t slen,
                                          uint8_t* dst, size_t dcap,
                                          size_t max_size) {
  if (max_size == 0 || max_size > kMaxBlock) max_size = kMaxBlock;
  std::vector<uint8_t> body;
  body.reserve(slen);
  size_t i = 0, out_len = 0;
  long last_offset = -1;
  while (i < slen) {
    uint32_t token = src[i++];
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      while (true) {
        if (i >= slen) return -1;  // truncated literal length
        uint8_t b = src[i++];
        lit_len += b;
        if (b != 255) break;
      }
    }
    if (i + lit_len > slen) return -1;  // literal run exceeds input
    const uint8_t* lits = src + i;
    i += lit_len;

    if (i == slen) {  // final sequence: literals only
      if (lit_len) {
        emit_literals(body, lits, lit_len);
        out_len += lit_len;
      }
      break;
    }
    if (i + 2 > slen) return -1;  // truncated offset
    uint32_t offset = (uint32_t)src[i] | ((uint32_t)src[i + 1] << 8);
    i += 2;
    if (offset == 0 || offset > out_len + lit_len) return -1;
    size_t m_len = token & 15;  // size_t: the extension loop would wrap a
    if (m_len == 15) {          // uint32 on ~16.8M 0xFF bytes and sneak a
      while (true) {            // small wrong value past the max_size check
        if (i >= slen) return -1;  // truncated match length
        uint8_t b = src[i++];
        m_len += b;
        if (m_len > max_size) return -1;  // early: block can't fit anyway
        if (b != 255) break;
      }
    }
    m_len += 4;  // LZ4 min match
    if (out_len + lit_len + m_len > max_size) return -1;

    // Prefer fused forms; repeat when the offset recurs (mirrors
    // lz4.convert_block / reference ConvertBlock emission choices).
    if (lit_len && (long)offset != last_offset && offset >= 64 &&
        (lit_len <= 3 || (offset <= 65599 && lit_len <= 4))) {
      if (offset <= 65599) {
        emit_fused2(body, lits, (uint32_t)lit_len, offset, m_len);
      } else {
        emit_copy3(body, offset, m_len, lits, (uint32_t)lit_len);
      }
    } else {
      if (lit_len) emit_literals(body, lits, lit_len);
      if ((long)offset == last_offset) {
        emit_repeat(body, m_len);
      } else if (offset <= 1024) {
        emit_copy1(body, offset, m_len);
      } else if (offset <= 65599) {
        emit_copy2(body, offset, m_len);
      } else {
        emit_copy3(body, offset, m_len, nullptr, 0);
      }
    }
    last_offset = (long)offset;
    out_len += lit_len + m_len;
  }

  if (body.size() >= out_len && out_len > 0) {
    // MinLZ requires net compression; decode the LZ4 block and store raw.
    if (out_len + 2 > dcap) return -2;
    dst[0] = 0;
    dst[1] = 0;
    uint8_t* o = dst + 2;
    // Small strict LZ4 decode (validated above; re-walk emits bytes).
    size_t s = 0, d = 0;
    while (s < slen) {
      uint32_t token = src[s++];
      size_t ll = token >> 4;
      if (ll == 15) {
        uint8_t b;
        do { b = src[s++]; ll += b; } while (b == 255);
      }
      memcpy(o + d, src + s, ll);
      d += ll;
      s += ll;
      if (s == slen) break;
      uint32_t off = (uint32_t)src[s] | ((uint32_t)src[s + 1] << 8);
      s += 2;
      uint32_t ml = token & 15;
      if (ml == 15) {
        uint8_t b;
        do { b = src[s++]; ml += b; } while (b == 255);
      }
      ml += 4;
      for (uint32_t k = 0; k < ml; k++) o[d + k] = o[d + k - off];
      d += ml;
    }
    return (long)(d + 2);
  }
  uint8_t hdr[12];
  size_t hl = 1;
  hdr[0] = 0;
  hl += put_uvarint(hdr + 1, out_len);
  if (hl + body.size() > dcap) return -2;
  memcpy(dst, hdr, hl);
  memcpy(dst + hl, body.data(), body.size());
  return (long)(hl + body.size());
}

}  // extern "C"

extern "C" {

// Fused greedy parse + serialize from per-position device match proposals.
//
// dist/len: int32[n] candidate arrays from the device match finder.  Proposals
// are hints: every chosen match is re-verified and re-extended byte-exactly
// here (so coarse/hash-only device levels cannot corrupt output), with
// 1-step lazy lookahead and repeat-offset detection.  Match output spans
// never cross `seg` boundaries (the decode-parallel unit); hints_out gets
// the body offset of each segment.  Returns body size, or -1 when the body
// would reach `limit` (caller falls back to uncompressed).
// Serialize segments [seg_begin, seg_end) into `body`; hints_out[si] gets
// offsets RELATIVE to this range's body start.  Returns false when `limit`
// is reached (caller falls back to uncompressed).  Segments are fully
// independent (repeat offset and literal run reset at each boundary), which
// is what makes both the device decoder's lane parallelism and this
// function's thread parallelism legal.
// Segment-scoped optimal parse over DEVICE match proposals (level 3 of
// the device encode path): the same beam DP as encode_optimal, but the
// candidate set is the device's dist[] hints — verified byte-exactly and
// backward-extended into proposal-free predecessors — plus repeat
// transitions.  Each segment starts with NO live repeat (the device
// decode transducer resets repeat state per segment), matching the
// greedy path's contract.  Reference quality bar: encode_l3.go:118-169.
static void dp_segment(const uint8_t* src, const int32_t* dist, size_t s0,
                       size_t s1, size_t rng0, std::vector<uint8_t>& body) {
  using namespace optimal;
  const int beam = 4;
  const size_t m = s1 - s0;

  // Backward-extend proposals into earlier proposal-free positions (what
  // the greedy loop's backward extension recovers at emit time).
  std::vector<uint32_t> deff(m, 0);
  for (size_t i = 0; i < m; i++) {
    int32_t d = dist[s0 + i];
    if (d > 0) deff[i] = (uint32_t)d;
  }
  for (size_t i = m; i-- > 1;) {
    uint32_t d = deff[i];
    if (!d) continue;
    size_t q = s0 + i;
    while (q > s0 && deff[q - 1 - s0] == 0 && q - 1 >= d &&
           q - 1 - d >= rng0 && src[q - 1] == src[q - 1 - d]) {
      q--;
      deff[q - s0] = d;
    }
  }

  // Local hash-chain candidates COMPLEMENT the device proposals: the
  // proposal keeps only the best-by-length match per position, so the DP
  // cannot trade a long far match for a near (cheaper token class) one.
  // The chain covers a bounded recent window; distances beyond it are the
  // device proposals' job (long-range tiers).
  const size_t kChainWin = 128 << 10;
  const int kChainDepth = 24;
  const int hbits = 15;
  size_t wstart = s0 > kChainWin ? s0 - kChainWin : 0;
  if (wstart < rng0) wstart = rng0;
  std::vector<int32_t> head((size_t)1 << hbits, -1);
  std::vector<int32_t> prev(s1 - wstart, -1);
  const size_t chain_lim = s1 >= 4 ? s1 - 4 : 0;
  for (size_t p = wstart; p < s0 && p < chain_lim; p++) {
    uint32_t h = hash4(load32(src + p), hbits);
    prev[p - wstart] = head[h];
    head[h] = (int32_t)(p - wstart);
  }

  Dp dp{src, m, beam, {}};
  dp.st.assign((m + 1) * (size_t)beam, Slot{});
  dp.push(0, 0, 0, 0, 0);

  uint32_t cand_off[3], cand_len[3];
  for (size_t i = 0; i < m; i++) {
    Slot* cur = dp.at(i);
    size_t abs = s0 + i;

    // Candidate classes: best length per token-cost class, seeded from
    // the chain walk, then the (longer-range) device proposal.
    cand_len[0] = cand_len[1] = cand_len[2] = 0;
    if (abs < chain_lim) {
      uint32_t cv = load32(src + abs);
      int32_t j = head[hash4(cv, hbits)];
      int depth = 0;
      while (j >= 0 && depth < kChainDepth) {
        size_t pj = wstart + (size_t)j;
        uint32_t off = (uint32_t)(abs - pj);
        if (load32(src + pj) == cv) {
          size_t l = 4 + match_len(src + abs + 4, src + pj + 4,
                                   s1 - abs - 4);
          int cls = off <= 1024 ? 0 : off <= 65599 ? 1 : 2;
          if (l > cand_len[cls]) {
            cand_len[cls] = (uint32_t)l;
            cand_off[cls] = off;
          }
        }
        j = prev[(size_t)j];
        depth++;
      }
    }
    uint32_t cd = deff[i];
    if (cd && cd <= abs && abs - cd >= rng0 && cd <= kMaxOffset) {
      size_t l = match_len(src + abs, src + abs - cd, s1 - abs);
      if (l >= 4) {
        int cls = cd <= 1024 ? 0 : cd <= 65599 ? 1 : 2;
        if (l > cand_len[cls]) {
          cand_len[cls] = (uint32_t)l;
          cand_off[cls] = cd;
        }
      }
    }

    for (int k = 0; k < beam; k++) {
      if (cur[k].cost == 0xFFFFFFFFu) continue;
      const uint32_t cost = cur[k].cost;
      const uint32_t rep = cur[k].rep;
      const uint32_t litrun = cur[k].litrun;

      {  // literal step
        uint32_t lr = litrun + 1;
        uint32_t extra =
            1 + (cost_lit_hdr(lr) - (litrun ? cost_lit_hdr(litrun) : 0));
        dp.push(i + 1, rep, cost + extra, lr, pack_edge(kLit, k, 1, 0));
      }

      if (rep && rep <= abs && abs - rep >= rng0) {
        size_t maxl = match_len(src + abs, src + abs - rep, s1 - abs);
        if (maxl >= 2) {
          uint32_t ls[4] = {(uint32_t)maxl, 29, 285, 2};
          for (uint32_t L : ls) {
            if (L < 2 || L > maxl) continue;
            dp.push(i + L, rep, cost + cost_repeat(L), 0,
                    pack_edge(kRep, k, L, rep));
          }
        }
      }

      for (int cls = 0; cls < 3; cls++) {
        uint32_t cmax = cand_len[cls];
        if (cmax < 4) continue;
        uint32_t co = cand_off[cls];
        if (co == rep) continue;  // the repeat transition covers it
        uint32_t ls[5];
        int nl = 0;
        ls[nl++] = cmax;
        if (cls == 0) {
          if (cmax > 18) ls[nl++] = 18;
          if (cmax > 273) ls[nl++] = 273;
        } else {
          if (cmax > 64) ls[nl++] = 64;
        }
        if (cmax > 4) ls[nl++] = 4;
        for (int q = 0; q < nl; q++) {
          uint32_t L = ls[q];
          dp.push(i + L, co, cost + cost_copy(co, L), 0,
                  pack_edge(kCopy, k, L, co));
        }
        if (litrun >= 1 && litrun <= 4 && co >= 64 && co <= 65599) {
          uint32_t L = cmax < 11 ? cmax : 11;
          dp.push(i + L, co, cost + 2, 0, pack_edge(kFused, k, L, co));
        }
        if (litrun >= 1 && litrun <= 3 && co > 65599) {
          dp.push(i + cmax, co, cost + cost_copy(co, cmax) - 1, 0,
                  pack_edge(kFused, k, cmax, co));
        }
      }
    }

    if (abs < chain_lim) {
      uint32_t h = hash4(load32(src + abs), hbits);
      prev[abs - wstart] = head[h];
      head[h] = (int32_t)(abs - wstart);
    }
  }

  Slot* fin = dp.at(m);
  int bk = -1;
  for (int k = 0; k < beam; k++) {
    if (fin[k].cost == 0xFFFFFFFFu) continue;
    if (bk < 0 || fin[k].cost < fin[bk].cost) bk = k;
  }
  // A pure-literal path always reaches m, so bk >= 0.

  struct Edge {
    uint32_t type, len, off;
  };
  std::vector<Edge> edges;
  {
    size_t i = m;
    int k = bk;
    while (i > 0) {
      uint64_t e = dp.at(i)[k].parent;
      edges.push_back({(uint32_t)(e & 3), (uint32_t)((e >> 5) & 0x7FFFFF),
                       (uint32_t)(e >> 28)});
      i -= edges.back().len;
      k = (int)((e >> 2) & 7);
    }
  }

  size_t pos = s0, run = 0;
  for (size_t e = edges.size(); e-- > 0;) {
    const Edge& ed = edges[e];
    switch (ed.type) {
      case kLit:
        run += ed.len;
        pos += ed.len;
        break;
      case kRep:
        if (run) emit_literals(body, src + pos - run, run), run = 0;
        emit_repeat(body, ed.len);
        pos += ed.len;
        break;
      case kCopy:
        if (run) emit_literals(body, src + pos - run, run), run = 0;
        if (ed.off <= 1024) emit_copy1(body, ed.off, ed.len);
        else if (ed.off <= 65599) emit_copy2(body, ed.off, ed.len);
        else emit_copy3(body, ed.off, ed.len, nullptr, 0);
        pos += ed.len;
        break;
      case kFused: {
        const uint8_t* lits = src + pos - run;
        if (ed.off <= 65599) {
          emit_fused2(body, lits, (uint32_t)run, ed.off, ed.len);
        } else {
          emit_copy3(body, ed.off, ed.len, lits, (uint32_t)run);
        }
        run = 0;
        pos += ed.len;
        break;
      }
    }
  }
  if (run) emit_literals(body, src + pos - run, run);
}

static bool parse_serialize_range(
    const uint8_t* src, size_t n, const int32_t* dist, size_t seg,
    size_t seg_begin, size_t seg_end, std::vector<uint8_t>& body,
    size_t limit, int64_t* hints_out, size_t rng, int level) {
  for (size_t si = seg_begin; si < seg_end; si++) {
    size_t s0 = si * seg;
    size_t s1 = s0 + seg < n ? s0 + seg : n;
    // Match-source clamp (power-of-two `rng`, 0 = off): sources must stay
    // in the destination's rng-aligned range (parse-hints v2: a decoder may
    // execute ranges independently).  Matches never cross
    // segment ends, and segments never cross range boundaries, so the
    // range start is constant per segment.  Repeat offsets are inherited
    // from earlier in-segment matches at later positions, so their sources
    // only move forward — no separate clamp needed.
    size_t rng0 = rng ? (s0 & ~(rng - 1)) : 0;
    hints_out[si] = (int64_t)body.size();
    if (level >= 3) {
      // Level 3: beam DP over the device proposals (reference
      // encodeBlockBest analog, encode_l3.go:38 — "no speed target").
      dp_segment(src, dist, s0, s1, rng0, body);
      if (body.size() >= limit) return false;
      continue;
    }
    size_t lit_start = s0;
    uint32_t rep = 0;
    size_t p = s0;

    // Verified match length at q for distance d, capped at segment end.
    auto vlen = [&](size_t q, uint32_t d) -> size_t {
      if (!d || d > q || d > kMaxOffset || q - d < rng0) return 0;
      size_t m = match_len(src + q, src + q - d, s1 - q);
      return m >= 4 ? m : 0;
    };

    size_t look_p = (size_t)-1, look_l = 0;  // memoized lookahead vlen
    while (p + 4 <= s1) {
      uint32_t d = (uint32_t)dist[p];
      // Fast path: no proposal here and no live repeat match (even a
      // 2-byte repeat is profitable: 1 emitted byte covers 2) — skip runs
      // of proposal-free positions two at a time.
      if (d == 0) {
        bool rep_hit = rep && rep <= p &&
                       load16(src + p) == load16(src + p - rep);
        if (!rep_hit) {
          p++;
          bool no_rep = rep == 0;
          while (p + 9 <= s1 &&
                 load64((const uint8_t*)(dist + p)) == 0 &&
                 (no_rep || rep > p + 1 ||
                  (rep <= p &&
                   load16(src + p) != load16(src + p - rep) &&
                   load16(src + p + 1) != load16(src + p + 1 - rep))))
            p += 2;
          continue;
        }
      }
      size_t l = (p == look_p) ? look_l : vlen(p, d);
      bool is_rep = false;
      // Repeat probe (2-byte gated): a repeat token is 1-3 bytes
      // regardless of offset, so even 2-byte repeats pay for themselves.
      if (rep && rep <= p && load16(src + p) == load16(src + p - rep)) {
        size_t rl = 2 + match_len(src + p + 2, src + p - rep + 2,
                                  s1 - p - 2);
        if (rl + 2 >= l) {
          d = rep;
          l = rl;
          is_rep = true;
        }
      }
      if (l < 4 && !is_rep) {
        p++;
        continue;
      }
      // Lazy lookahead: a strictly better match ahead wins (never defers a
      // repeat or an already-long match — not worth the compares).  Level
      // -1 skips it (speed); level 3 also probes two bytes ahead.
      if (!is_rep && l < 16 && p + 5 <= s1 && level >= 1) {
        uint32_t d1 = (uint32_t)dist[p + 1];
        if (d1 && d1 != d) {
          size_t l1 = vlen(p + 1, d1);
          if (l1 > l + 1) {
            look_p = p + 1;
            look_l = l1;
            p++;
            continue;
          }
        }
        if (level >= 3 && p + 6 <= s1) {
          uint32_t d2 = (uint32_t)dist[p + 2];
          if (d2 && d2 != d) {
            size_t l2 = vlen(p + 2, d2);
            if (l2 > l + 2) {
              p++;  // re-evaluated at p+1/p+2 on the next iterations
              continue;
            }
          }
        }
      }
      // Backward extension over pending literals (not past segment start
      // nor, when range-clamped, past the source range boundary).
      size_t base = p;
      while (base > lit_start && base > d && base - 1 - d >= rng0 &&
             src[base - 1] == src[base - 1 - d]) {
        base--;
        l++;
      }
      // Token-profit gate (post-extension): a copy3 op costs 4+ wire
      // bytes, so l = 4 saves zero and splits the literal run (second
      // literal header) — strictly unprofitable; require l >= 6.  A
      // copy2 at l = 4 still saves a byte, and measurement showed gating
      // it trades ~0.3 ratio points for only ~3% fewer decode ops — a
      // bad trade, so copy1/copy2/repeat keep the spec minimum.
      // (reference encode_l3.go:147-169 cost model analog.)
      if (!is_rep && d > 65599 && l < 6) {
        p++;
        continue;
      }
      size_t nlits = base - lit_start;
      const uint8_t* lits = src + lit_start;
      if (d == rep) {
        if (nlits) emit_literals(body, lits, nlits);
        emit_repeat(body, (uint32_t)l);
      } else {
        bool fused = false;
        if (nlits && d >= 64 && (nlits <= 3 || (d <= 65599 && nlits <= 4))) {
          if (d <= 65599) {
            emit_fused2(body, lits, (uint32_t)nlits, d, (uint32_t)l);
          } else {
            emit_copy3(body, d, (uint32_t)l, lits, (uint32_t)nlits);
          }
          fused = true;
        } else if (nlits) {
          emit_literals(body, lits, nlits);
        }
        if (!fused) {
          if (d <= 1024) emit_copy1(body, d, (uint32_t)l);
          else if (d <= 65599) emit_copy2(body, d, (uint32_t)l);
          else emit_copy3(body, d, (uint32_t)l, nullptr, 0);
        }
        rep = d;
      }
      p = base + l;
      lit_start = p;
      if (body.size() >= limit) return false;
    }
    if (lit_start < s1) emit_literals(body, src + lit_start, s1 - lit_start);
    if (body.size() >= limit) return false;
  }
  return true;
}

MINLZ_EXPORT long minlz_parse_serialize(
    const uint8_t* src, size_t n, const int32_t* dist, const int32_t* len,
    size_t seg, uint8_t* out, size_t outcap, size_t limit,
    int64_t* hints_out, size_t rng, int level) {
  (void)len;  // device lengths are proposals; ranges re-extend byte-exactly
  size_t nseg = (n + seg - 1) / seg;
  unsigned hw = std::thread::hardware_concurrency();
  size_t nth = hw ? hw : 1;
  if (nth > nseg) nth = nseg;
  if (nth > 16) nth = 16;
  // Threading pays for itself above ~32 segments (128KiB at 4KiB segments).
  if (nseg < 32 || nth < 2) {
    std::vector<uint8_t> body;
    body.reserve(n / 2 + 64);
    if (!parse_serialize_range(src, n, dist, seg, 0, nseg, body, limit,
                               hints_out, rng, level))
      return -1;
    if (body.size() > outcap) return -2;
    memcpy(out, body.data(), body.size());
    return (long)body.size();
  }
  std::vector<std::vector<uint8_t>> bodies(nth);
  // NOT vector<bool>: threads write distinct elements concurrently.
  std::vector<char> oks(nth, 0);
  std::vector<std::thread> threads;
  size_t per = (nseg + nth - 1) / nth;
  for (size_t t = 0; t < nth; t++) {
    size_t b = t * per, e = b + per < nseg ? b + per : nseg;
    threads.emplace_back([&, t, b, e] {
      bodies[t].reserve((e - b) * seg / 2 + 64);
      // parse_serialize_range indexes hints_out with ABSOLUTE segment
      // indices [b, e) — pass the base pointer, not hints_out + b.
      oks[t] = parse_serialize_range(src, n, dist, seg, b, e, bodies[t],
                                     limit, hints_out, rng, level);
    });
  }
  for (auto& th : threads) th.join();
  size_t total = 0;
  for (size_t t = 0; t < nth; t++) {
    if (!oks[t]) return -1;
    total += bodies[t].size();
  }
  if (total >= limit) return -1;
  if (total > outcap) return -2;
  size_t off = 0;
  for (size_t t = 0; t < nth; t++) {
    size_t b = t * per, e = b + per < nseg ? b + per : nseg;
    for (size_t si = b; si < e; si++) hints_out[si] += (int64_t)off;
    memcpy(out + off, bodies[t].data(), bodies[t].size());
    off += bodies[t].size();
  }
  return (long)total;
}

// Serialize a compacted op list (from the device greedy parse) into a MinLZ
// block body with per-segment hint offsets.
//   pos/off/len/isrep: arrays of `count` ops, ascending global positions,
//   never crossing segment boundaries.  hints_out: comp offset per segment
//   (nseg = ceil(n/seg)).  Returns body size or negative on overflow.
MINLZ_EXPORT long minlz_serialize_ops(
    const uint8_t* src, size_t n, const int32_t* pos, const int32_t* off,
    const int32_t* len, const int32_t* isrep, size_t count, size_t seg,
    uint8_t* out, size_t outcap, int64_t* hints_out) {
  std::vector<uint8_t> body;
  body.reserve(n / 2);
  size_t nseg = (n + seg - 1) / seg;
  size_t i = 0;
  for (size_t si = 0; si < nseg; si++) {
    size_t s0 = si * seg;
    size_t s1 = s0 + seg < n ? s0 + seg : n;
    hints_out[si] = (int64_t)body.size();
    size_t lit_start = s0;
    int64_t rep = -1;
    while (i < count && (size_t)pos[i] < s1) {
      size_t p = (size_t)pos[i];
      uint32_t o = (uint32_t)off[i];
      uint32_t l = (uint32_t)len[i];
      const uint8_t* lits = src + lit_start;
      size_t nlits = p - lit_start;
      bool fused = false;
      if (o == (uint64_t)rep) {
        if (nlits) emit_literals(body, lits, nlits);
        emit_repeat(body, l);
      } else {
        if (nlits && o >= 64 &&
            (nlits <= 3 || (o <= 65599 && nlits <= 4))) {
          if (o <= 65599) {
            emit_fused2(body, lits, (uint32_t)nlits, o, l);
          } else {
            emit_copy3(body, o, l, lits, (uint32_t)nlits);
          }
          fused = true;
        } else if (nlits) {
          emit_literals(body, lits, nlits);
        }
        if (!fused) {
          if (o <= 1024) emit_copy1(body, o, l);
          else if (o <= 65599) emit_copy2(body, o, l);
          else emit_copy3(body, o, l, nullptr, 0);
        }
        rep = o;
      }
      lit_start = p + l;
      i++;
    }
    if (lit_start < s1) emit_literals(body, src + lit_start, s1 - lit_start);
  }
  if (body.size() > outcap) return -2;
  memcpy(out, body.data(), body.size());
  return (long)body.size();
}

}  // extern "C"
