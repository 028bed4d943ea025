// CRC32C (Castagnoli) — slice-by-8 software implementation.
// Fast path for TFRecord/tfevents framing (≙ the reference's use of the
// hadoop/tensorflow native CRC32C): the table-driven Castagnoli CRC,
// bit for bit.
#include <cstdint>
#include <cstddef>

namespace {

uint32_t table[8][256];
bool initialized = false;

void init_tables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
        table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = table[0][i];
        for (int s = 1; s < 8; s++) {
            c = table[0][c & 0xFF] ^ (c >> 8);
            table[s][i] = c;
        }
    }
    initialized = true;
}

}  // namespace

extern "C" {

uint32_t bigdl_crc32c(const uint8_t* data, size_t n, uint32_t crc) {
    if (!initialized) init_tables();
    crc ^= 0xFFFFFFFFu;
    // slice-by-8 over aligned middle
    while (n >= 8) {
        uint32_t lo = crc ^ (uint32_t(data[0]) | uint32_t(data[1]) << 8 |
                             uint32_t(data[2]) << 16 | uint32_t(data[3]) << 24);
        uint32_t hi = uint32_t(data[4]) | uint32_t(data[5]) << 8 |
                      uint32_t(data[6]) << 16 | uint32_t(data[7]) << 24;
        crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
              table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    while (n--) crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

uint32_t bigdl_crc32c_masked(const uint8_t* data, size_t n) {
    uint32_t crc = bigdl_crc32c(data, n, 0);
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // extern "C"
