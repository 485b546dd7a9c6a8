// The lengths-only scan of a canonical Huffman stream: the bit offset of each
// symbol group's first code, for blobs that come without the encoder's
// sidecar (foreign blobs). The offsets feed the group-parallel decode H3,
// which checks every one of them against the code lengths it decodes.
//
// A copy of the serial path of
// lerc_tpu/native/lerc_native.cpp::lerc_huffman_group_offsets (:604-757):
// a 13-bit multi-symbol table (count of whole codes and their total length,
// 8 KB, L1-resident) advances several symbols a lookup over a rolling 64-bit
// window; long codes, window tails and group boundaries step one exact
// symbol at a time (a 12-bit length table, then the canonical ranges of the
// longer lengths). The original's speculative chunk-parallel scan
// (spec_scan, :362-588) is not here (ROADMAP). One guard is added: a code
// that does not fit its length, which the original would place outside its
// table.
//
// group_counts[g] is the number of wire symbols in group g (64, a partial
// tail, 0 for dead groups). Returns the bits consumed, or -1 on a corrupt
// stream or a maximum code length <= 0 or > 32.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int64_t huffman_group_offsets(const uint8_t* buf, int64_t buf_len,
                                         const int32_t* lengths, const uint32_t* codes,
                                         int32_t table_size, int32_t n_groups,
                                         const int32_t* group_counts, int32_t* out_offsets) {
  int max_len = 0;
  for (int i = 0; i < table_size; i++)
    if (lengths[i] > max_len) max_len = lengths[i];
  if (max_len <= 0 || max_len > 32) return -1;
  const int lut_bits = max_len < 12 ? max_len : 12;
  std::vector<int16_t> lut_len(1u << lut_bits, 0);
  uint32_t first_code[33] = {0};
  int32_t count_len[33] = {0};
  bool has_len[33] = {false};
  for (int i = 0; i < table_size; i++) {
    const int len = lengths[i];
    if (len <= 0) continue;
    if (len < 32 && (codes[i] >> len) != 0) return -1;  // a code longer than its length
    if (!has_len[len]) { has_len[len] = true; first_code[len] = codes[i]; }
    else if (codes[i] < first_code[len]) first_code[len] = codes[i];
    count_len[len]++;
    if (len <= lut_bits) {
      const uint32_t base = codes[i] << (lut_bits - len);
      const uint32_t span = 1u << (lut_bits - len);
      for (uint32_t k = 0; k < span; k++) lut_len[base + k] = (int16_t)len;
    }
  }
  // the 13-bit multi-symbol table, (nSyms << 4) | totalLen in one byte: a
  // zero-padded lookup of k < lut_bits bits is sound iff the resolved length
  // is <= k (the prefix property)
  const int MB = 13;
  std::vector<uint8_t> multi(1u << MB);
  for (uint32_t v = 0; v < (1u << MB); v++) {
    int tl = 0, ns = 0;
    while (tl < MB && ns < 15) {
      const int k = MB - tl;
      const int take = lut_bits < k ? lut_bits : k;
      uint32_t win = ((v << tl) & ((1u << MB) - 1)) >> (MB - take);
      win <<= (lut_bits - take);
      const int len = lut_len[win];
      if (len == 0 || len > k) break;
      tl += len;
      ns++;
    }
    multi[v] = (uint8_t)((ns << 4) | tl);
  }

  const int64_t total_bits = (buf_len / 4) * 32;
  auto read_window = [&](int64_t p, int n) -> uint32_t {
    uint32_t w0, w1 = 0;
    const int64_t word = p >> 5;
    const int off = (int)(p & 31);
    memcpy(&w0, buf + word * 4, 4);
    if ((word + 2) * 4 <= buf_len) memcpy(&w1, buf + (word + 1) * 4, 4);
    const uint64_t both = ((uint64_t)w0 << 32) | w1;
    return (uint32_t)((both << off) >> (64 - n));
  };

  int64_t bitpos = 0;
  bool ok = true;
  for (int32_t g = 0; g < n_groups && ok; g++) {
    out_offsets[g] = (int32_t)bitpos;
    const int32_t cnt = group_counts[g];
    int32_t s = 0;
    if (bitpos + 64 <= total_bits) {
      int64_t word = bitpos >> 5;
      uint32_t w0, w1;
      memcpy(&w0, buf + word * 4, 4);
      memcpy(&w1, buf + word * 4 + 4, 4);
      uint64_t cur = ((uint64_t)w0 << 32) | w1;
      int off = (int)(bitpos & 31);
      // whole multi steps while >= 32 lookahead bits remain
      while (s < cnt) {
        const uint32_t win = (uint32_t)((cur << off) >> (64 - MB));
        const uint8_t e = multi[win];
        const int ns = e >> 4;
        if (!ns || s + ns > cnt) break;  // long code or group boundary
        const int tl = e & 15;
        off += tl;
        bitpos += tl;
        s += ns;
        if (off >= 32) {
          word++;
          if ((word + 2) * 4 > buf_len) break;  // tail: exact path below
          uint32_t wn;
          memcpy(&wn, buf + word * 4 + 4, 4);
          cur = (cur << 32) | wn;
          off -= 32;
        }
      }
    }
    while (s < cnt) {
      if (bitpos + 16 <= total_bits) {
        const uint8_t e = multi[read_window(bitpos, MB)];
        const int ns = e >> 4;
        if (ns && s + ns <= cnt) { bitpos += (e & 15); s += ns; continue; }
      }
      // one exact symbol (window tail, long code, or group boundary)
      if (bitpos + lut_bits > total_bits) { ok = false; break; }
      int len = lut_len[read_window(bitpos, lut_bits)];
      if (len == 0) {
        len = lut_bits;
        bool found = false;
        while (len < max_len) {
          len++;
          if (bitpos + len > total_bits) break;
          const uint32_t code = read_window(bitpos, len);
          if (has_len[len] && code >= first_code[len]
              && (uint64_t)code < (uint64_t)first_code[len] + (uint64_t)count_len[len]) {
            found = true;
            break;
          }
        }
        if (!found) { ok = false; break; }
      }
      bitpos += len;
      s++;
    }
  }
  return ok ? bitpos : -1;
}
