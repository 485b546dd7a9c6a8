// The host record scanner of the band decoder: walks a Lerc2 tile stream
// record by record and writes each record's descriptor.
//
// A copy of lerc_tpu/native/lerc_native.cpp::lerc_tile_scan (:70-145): the
// port builds it from this file (c++ -O3 -shared -fPIC, kernels/build.py)
// and imports nothing of the JAX package. The scan is serial by nature: a
// raw record is 1 + cnt * size bytes and a stuffed one 1 + offset + count
// header + payload, where cnt is the valid count of the record's own block,
// which the device's byte-wise pointer doubling (K5) cannot know. It runs
// on the host at a few ns per record; the decode kernel (K6) takes the
// descriptors.
//
// Every corruption check of the original stays: the integrity bits
// (pattern 14 at version >= 5, else 15), a diff record on depth slice 0,
// a stuffed count over 4096, a LUT record with numBits 0 or a LUT of no
// entries, and every overrun of the stream. A corrupt stream returns -1.
// Two guards are added where the original reads out of its tables: an
// offset type code that names no type, and a LUT byte of 0.
//
// Bound: bytes, on the host: the stream's bytes up to the last record and
// 40 B of descriptor per record. The walk touches each record's header
// only (a stuffed record's payload is skipped by its length).

#include <cstdint>
#include <cstring>

extern "C" {

struct RecordDesc {
  int64_t payload_pos;   // byte offset of the stuffed values (mode 1), indices (mode 4) or raw values (mode 0)
  double offset;         // block offset (zMin) for modes 1, 3, 4
  int32_t mode;          // 0 raw, 1 stuff, 2 const 0, 3 const offset, 4 stuff LUT; +8 if diff-encoded
  int32_t num_bits;      // bits per value (mode 1) or per LUT entry (mode 4)
  int32_t num_elements;  // stuffed value count
  int64_t lut_pos;       // byte offset of the LUT entries (mode 4)
  int32_t n_lut;         // LUT entries without the implicit 0 (mode 4)
  int32_t nbits_lut;     // bits per index (mode 4)
};

}  // extern "C"

namespace {

// dt codes: 0 char, 1 byte, 2 short, 3 ushort, 4 int, 5 uint, 6 float, 7 double
const int DT_SIZE_TBL[8] = {1, 1, 2, 2, 4, 4, 4, 8};

// the reduced type of a block offset (Lerc2.h:528-542)
inline int dt_used(int dt, int tc) {
  switch (dt) {
    case 2: case 4: return dt - tc;
    case 3: case 5: return dt - 2 * tc;
    case 6: return tc == 0 ? 6 : (tc == 1 ? 2 : 1);
    case 7: return tc == 0 ? 7 : (7 - 2 * tc + 1);
    default: return dt;
  }
}

inline double read_val(const uint8_t* p, int dtu) {
  switch (dtu) {
    case 0: return (double)(int8_t)p[0];
    case 1: return (double)p[0];
    case 2: { int16_t v; memcpy(&v, p, 2); return v; }
    case 3: { uint16_t v; memcpy(&v, p, 2); return v; }
    case 4: { int32_t v; memcpy(&v, p, 4); return v; }
    case 5: { uint32_t v; memcpy(&v, p, 4); return v; }
    case 6: { float v; memcpy(&v, p, 4); return v; }
    default: { double v; memcpy(&v, p, 8); return v; }
  }
}

inline int bit_len_u32(uint32_t x) {
  int n = 0;
  while (x >> n) n++;
  return n;
}

}  // namespace

// Scan the tile stream buf[0:buf_len]. cnts[b] is block b's valid count,
// j0s[b] its first column (for the integrity bits); records run block-major,
// depth inner. Returns the bytes consumed, or -1 on corruption.
extern "C" int64_t tile_scan(const uint8_t* buf, int64_t buf_len, const int32_t* cnts,
                             const int32_t* j0s, int32_t n_blocks, int32_t n_depth, int32_t dt,
                             int32_t version, RecordDesc* out) {
  const int size_t_ = DT_SIZE_TBL[dt];
  const bool dt_int = dt < 6;
  int64_t pos = 0;
  const int pattern = version >= 5 ? 14 : 15;
  for (int32_t b = 0; b < n_blocks; b++) {
    const int32_t cnt = cnts[b];
    for (int32_t d = 0; d < n_depth; d++) {
      RecordDesc& r = out[(int64_t)b * n_depth + d];
      if (pos >= buf_len) return -1;
      const uint8_t flag = buf[pos++];
      const bool bdiff = (version >= 5) && (flag & 4);
      if (bdiff && d == 0) return -1;  // Lerc2.cpp:2048: diff needs iDepth > 0
      if (((flag >> 2) & pattern) != ((j0s[b] >> 3) & pattern)) return -1;
      const int code = flag & 3;
      const int bits67 = flag >> 6;
      r.mode = code + (bdiff ? 8 : 0);
      r.num_bits = 0; r.num_elements = 0; r.offset = 0;
      r.payload_pos = 0; r.lut_pos = 0; r.n_lut = 0; r.nbits_lut = 0;
      if (code == 2) continue;                      // const 0
      if (code == 0) {                              // raw
        r.payload_pos = pos;
        pos += (int64_t)cnt * size_t_;
        if (pos > buf_len) return -1;
        continue;
      }
      // codes 1 and 3: the offset in its reduced type (integer diff records: INT)
      const int base_dt = (bdiff && dt_int) ? 4 : dt;
      const int dtu = dt_used(base_dt, bits67);
      if (dtu < 0) return -1;  // no such type (SHORT or USHORT at tc 3): corrupt
      const int w = DT_SIZE_TBL[dtu];
      if (pos + w > buf_len) return -1;
      r.offset = read_val(buf + pos, dtu);
      pos += w;
      if (code == 3) continue;
      // code 1: the bit-stuffed section (BitStuffer2::Decode header)
      if (pos >= buf_len) return -1;
      const uint8_t nbb = buf[pos++];
      const int cw_code = nbb >> 6;
      const int cw = cw_code == 0 ? 4 : 3 - cw_code;
      const bool lut = nbb & (1 << 5);
      const int nb = nbb & 31;
      if (pos + cw > buf_len) return -1;
      uint32_t n_elem = 0;
      memcpy(&n_elem, buf + pos, cw);  // little-endian, low bytes
      pos += cw;
      if ((int64_t)n_elem > 64LL * 64) return -1;
      r.num_elements = (int32_t)n_elem;
      r.num_bits = nb;
      if (!lut) {
        r.payload_pos = pos;
        pos += ((int64_t)n_elem * nb + 7) >> 3;
        if (pos > buf_len) return -1;
      } else {
        if (nb == 0 || pos >= buf_len) return -1;
        const int n_lut = buf[pos++] - 1;
        // a LUT byte of 0 (n_lut -1) has no entries; the original goes on
        // to bit_len_u32(0xffffffff), whose x >> 32 is undefined
        if (n_lut < 0) return -1;
        r.mode = 4 + (bdiff ? 8 : 0);
        r.n_lut = n_lut;
        r.lut_pos = pos;
        pos += ((int64_t)n_lut * nb + 7) >> 3;
        const int nbits_lut = bit_len_u32((uint32_t)n_lut);
        if (nbits_lut == 0) return -1;
        r.nbits_lut = nbits_lut;
        r.payload_pos = pos;
        pos += ((int64_t)n_elem * nbits_lut + 7) >> 3;
        if (pos > buf_len) return -1;
      }
    }
  }
  return pos;
}
