// CRC-32C (Castagnoli) — hardware-accelerated on x86 via SSE4.2 CRC32
// instruction, with a slice-by-8 software fallback.  Part of the MinLZ
// native runtime (host side).  Exposed via ctypes.
//
// Spec: RFC 3720 §12.1; masking per MinLZ SPEC.md §3.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

namespace {

uint32_t table[8][256];
bool table_init_done = false;

void init_tables() {
  if (table_init_done) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++) crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    table[0][i] = crc;
  }
  for (int t = 1; t < 8; t++)
    for (uint32_t i = 0; i < 256; i++)
      table[t][i] = table[0][table[t - 1][i] & 0xFF] ^ (table[t - 1][i] >> 8);
  table_init_done = true;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t n) {
  init_tables();
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
          table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
          table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
          table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
bool has_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & bit_SSE4_2) != 0;
}

__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t crc,
                                                     const uint8_t* p,
                                                     size_t n) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return ~c32;
}
#endif

}  // namespace

#define MINLZ_EXPORT __attribute__((visibility("default")))

extern "C" {

MINLZ_EXPORT uint32_t minlz_crc32c(const uint8_t* data, size_t n,
                                   uint32_t crc) {
#if defined(__x86_64__)
  static const bool hw = has_sse42();
  if (hw) return crc32c_hw(crc, data, n);
#endif
  return crc32c_sw(crc, data, n);
}

}  // extern "C"
