// TFRecord container support: CRC32C (Castagnoli, software 8-slice) and a
// record-framing indexer, for bluefog_tpu_torch/data/tfrecord.py.
//
// Host code, built with the host C++ compiler at first use into
// bluefog_tpu_torch/_build/ and bound with ctypes.  The hot byte-level work
// (checksums, framing scans over multi-GB shards) is native; decoding and
// batching stay in Python.  A per-byte Python CRC would cost a loop
// iteration per byte, about 150 KB per 224x224x3 image.
//
// TFRecord framing (little-endian):
//   uint64 length | uint32 masked_crc32c(length) | byte data[length]
//   | uint32 masked_crc32c(data)
// masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const uint32_t (*tables())[256] {
  // function-local static: C++11 guarantees thread-safe one-time init —
  // concurrent first calls from writer/indexer threads are well-defined
  static const CrcTables kTables;
  return kTables.t;
}

uint32_t crc32c_impl(const uint8_t* p, int64_t n, uint32_t crc) {
  const uint32_t (*g_table)[256] = tables();
  crc = ~crc;
  while (n >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, p, 8);
    chunk ^= crc;  // little-endian: low 4 bytes fold into the crc
    crc = g_table[7][chunk & 0xFF] ^ g_table[6][(chunk >> 8) & 0xFF] ^
          g_table[5][(chunk >> 16) & 0xFF] ^ g_table[4][(chunk >> 24) & 0xFF] ^
          g_table[3][(chunk >> 32) & 0xFF] ^ g_table[2][(chunk >> 40) & 0xFF] ^
          g_table[1][(chunk >> 48) & 0xFF] ^ g_table[0][(chunk >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ g_table[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

inline uint32_t masked(uint32_t crc) {
  return (((crc >> 15) | (crc << 17)) + 0xa282ead8u);
}

}  // namespace

extern "C" {

// Plain CRC32C of a buffer (used by the Python writer / verifier).
uint32_t bf_crc32c(const void* data, int64_t len) {
  return crc32c_impl(static_cast<const uint8_t*>(data), len, 0);
}

// Scan a TFRecord file's framing.  Fills up to `max_records` (payload offset,
// payload length) pairs; pass max_records = 0 to just count.  verify != 0
// additionally checks both checksums per record (slower; reads payloads).
// Returns the total number of records in the file, or:
//   -1  cannot open file
//   -2  truncated / malformed framing
//   -3  checksum mismatch (verify only); *bad_record holds its index
int64_t bf_tfrecord_index(const char* path, int64_t* offsets,
                          int64_t* lengths, int64_t max_records, int verify,
                          int64_t* bad_record) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // File size once up front: every record's length field is validated
  // against it BEFORE any allocation or seek, so a corrupt/crafted length
  // yields -2 instead of bad_alloc/negative seeks (the framing guarantees
  // payload + 4-byte footer fit inside the file).
  std::fseek(f, 0, SEEK_END);
  const int64_t file_size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int64_t count = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint8_t header[12];
    size_t got = std::fread(header, 1, 12, f);
    if (got == 0) break;  // clean EOF
    if (got != 12) { std::fclose(f); return -2; }
    uint64_t len;
    uint32_t len_crc;
    std::memcpy(&len, header, 8);
    std::memcpy(&len_crc, header + 8, 4);
    if (verify && masked(bf_crc32c(header, 8)) != len_crc) {
      if (bad_record) *bad_record = count;
      std::fclose(f);
      return -3;
    }
    const int64_t payload_off = std::ftell(f);
    if (len > static_cast<uint64_t>(file_size) ||
        payload_off + static_cast<int64_t>(len) + 4 > file_size) {
      std::fclose(f);
      return -2;
    }
    if (verify) {
      buf.resize(len);
      if (len > 0 && std::fread(buf.data(), 1, len, f) != len) {
        std::fclose(f);
        return -2;
      }
      uint8_t footer[4];
      if (std::fread(footer, 1, 4, f) != 4) { std::fclose(f); return -2; }
      uint32_t data_crc;
      std::memcpy(&data_crc, footer, 4);
      if (masked(bf_crc32c(buf.data(), len)) != data_crc) {
        if (bad_record) *bad_record = count;
        std::fclose(f);
        return -3;
      }
    } else if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0) {
      std::fclose(f);
      return -2;
    }
    if (count < max_records) {
      offsets[count] = payload_off;
      lengths[count] = static_cast<int64_t>(len);
    }
    ++count;
  }
  std::fclose(f);
  return count;
}

}  // extern "C"
