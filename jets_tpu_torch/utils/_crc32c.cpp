// CRC32C (Castagnoli) — native model-content hashing.
//
// The port's copy of jets_tpu/utils/_crc32c.cpp (the same code, so the
// same values): the counterpart of the reference's CRC32c.crc32c overload
// for Float32/64/Complex model arrays ("for hashing models",
// src/Jets.jl:1284-1286). Compiled to a shared object at first use (see
// native.py and hashing.py) and called through ctypes; uses the SSE4.2
// hardware CRC32 instruction when available, with a software slice-by-8
// fallback.
#include <cstddef>
#include <cstdint>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t table_[8][256];
bool init_done_ = false;

void init_tables() {
    if (init_done_) return;
    const uint32_t poly = 0x82f63b78u;  // CRC32C reflected polynomial
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t crc = i;
        for (int k = 0; k < 8; ++k)
            crc = (crc >> 1) ^ ((crc & 1u) ? poly : 0u);
        table_[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
        for (int s = 1; s < 8; ++s)
            table_[s][i] =
                (table_[s - 1][i] >> 8) ^ table_[0][table_[s - 1][i] & 0xffu];
    init_done_ = true;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t n) {
    init_tables();
    while (n >= 8) {
        uint64_t v;
        __builtin_memcpy(&v, p, 8);
        v ^= crc;
        crc = table_[7][v & 0xffu] ^ table_[6][(v >> 8) & 0xffu] ^
              table_[5][(v >> 16) & 0xffu] ^ table_[4][(v >> 24) & 0xffu] ^
              table_[3][(v >> 32) & 0xffu] ^ table_[2][(v >> 40) & 0xffu] ^
              table_[1][(v >> 48) & 0xffu] ^ table_[0][(v >> 56) & 0xffu];
        p += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ table_[0][(crc ^ *p++) & 0xffu];
    return crc;
}

#if defined(__SSE4_2__)
uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, size_t n) {
    uint64_t c = crc;
    while (n >= 8) {
        uint64_t v;
        __builtin_memcpy(&v, p, 8);
        c = _mm_crc32_u64(c, v);
        p += 8;
        n -= 8;
    }
    uint32_t c32 = static_cast<uint32_t>(c);
    while (n--) c32 = _mm_crc32_u8(c32, *p++);
    return c32;
}
#endif

}  // namespace

extern "C" uint32_t jets_crc32c(const uint8_t* data, size_t n, uint32_t seed) {
    uint32_t crc = ~seed;
#if defined(__SSE4_2__)
    crc = crc32c_hw(crc, data, n);
#else
    crc = crc32c_sw(crc, data, n);
#endif
    return ~crc;
}
