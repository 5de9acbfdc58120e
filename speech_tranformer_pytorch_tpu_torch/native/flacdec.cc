// First-party FLAC decoder (native speed path for the LibriSpeech recipe).
//
// Mirrors the behavioral reference in data/flac.py::decode_flac_py exactly
// (same supported subset: CONSTANT/VERBATIM/FIXED 0-4/LPC 1-32 subframes,
// Rice + Rice2 partitioned residuals with the raw-bits escape, wasted
// bits, all block-size/sample-rate/sample-size codes, mono + the four
// stereo assignments, CRC-8/CRC-16 verification). Tested equal to the
// Python reference over every encoder mode in tests/test_data.py.
//
// Built with the host g++ at first use by native/__init__.py; loaded via
// ctypes from data/flac.py.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;  // absolute bit position
  bool fail = false;

  BitReader(const uint8_t* d, int64_t nbytes, int64_t byte_pos)
      : data(d), nbits(nbytes * 8), pos(byte_pos * 8) {}

  uint64_t read(int n) {
    if (pos + n > nbits) { fail = true; return 0; }
    uint64_t v = 0;
    while (n > 0) {
      uint8_t byte = data[pos >> 3];
      int avail = 8 - (pos & 7);
      int take = avail < n ? avail : n;
      int shift = avail - take;
      v = (v << take) | ((byte >> shift) & ((1u << take) - 1));
      pos += take;
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }

  int64_t read_unary() {
    int64_t q = 0;
    while (true) {
      if (pos >= nbits) { fail = true; return 0; }
      uint8_t byte = data[pos >> 3];
      int rem = 8 - (pos & 7);
      uint8_t chunk = byte & ((1u << rem) - 1);
      if (chunk == 0) { q += rem; pos += rem; continue; }
      int bl = 0;  // bit_length of chunk
      for (uint8_t c = chunk; c; c >>= 1) bl++;
      int lead = rem - bl;
      q += lead;
      pos += lead + 1;
      return q;
    }
  }

  void align() { pos = (pos + 7) & ~(int64_t)7; }
  int64_t byte_pos() const { return pos >> 3; }
};

uint8_t crc8_tab[256];
uint16_t crc16_tab[256];
bool tabs_init = false;

void init_tabs() {
  if (tabs_init) return;
  for (int i = 0; i < 256; i++) {
    uint8_t c = (uint8_t)i;
    for (int k = 0; k < 8; k++)
      c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
    crc8_tab[i] = c;
  }
  for (int i = 0; i < 256; i++) {
    uint16_t c = (uint16_t)(i << 8);
    for (int k = 0; k < 8; k++)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
    crc16_tab[i] = c;
  }
  tabs_init = true;
}

uint8_t crc8(const uint8_t* d, int64_t n) {
  uint8_t c = 0;
  for (int64_t i = 0; i < n; i++) c = crc8_tab[c ^ d[i]];
  return c;
}

uint16_t crc16(const uint8_t* d, int64_t n) {
  uint16_t c = 0;
  for (int64_t i = 0; i < n; i++)
    c = (uint16_t)(crc16_tab[((c >> 8) ^ d[i]) & 0xFF] ^ (c << 8));
  return c;
}

const int kBlocksizeCode[16] = {-1, 192, 576, 1152, 2304, 4608, -2, -3,
                                256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizeCode[8] = {0, 8, 12, -1, 16, 20, 24, 32};
const int kFixedCoeffs[5][4] = {{0, 0, 0, 0},
                                {1, 0, 0, 0},
                                {2, -1, 0, 0},
                                {3, -3, 1, 0},
                                {4, -6, 4, -1}};

// err codes
constexpr int64_t E_MAGIC = -1, E_TRUNC = -2, E_STREAMINFO = -3,
                  E_SYNC = -4, E_HDR = -5, E_CRC = -6, E_SUBFRAME = -7,
                  E_RESIDUAL = -8, E_OVERFLOW = -9, E_UTF8 = -10;

int64_t read_utf8_number(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.read(8);
  if (br.fail) return E_TRUNC;
  if (b0 < 0x80) { *out = b0; return 0; }
  int n = 0;
  for (uint64_t mask = 0x80; b0 & mask; mask >>= 1) n++;
  if (n < 2 || n > 7) return E_UTF8;
  uint64_t v = b0 & (0xFFu >> (n + 1));
  for (int i = 0; i < n - 1; i++) {
    uint64_t b = br.read(8);
    if (br.fail) return E_TRUNC;
    if ((b & 0xC0) != 0x80) return E_UTF8;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return 0;
}

int64_t decode_residual(BitReader& br, int blocksize, int order,
                        int64_t* resid) {
  int method = (int)br.read(2);
  if (method > 1) return E_RESIDUAL;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = (1u << plen) - 1;
  int porder = (int)br.read(4);
  int nparts = 1 << porder;
  if (blocksize % nparts) return E_RESIDUAL;
  int part = blocksize >> porder;
  if (part <= 0 || part < order || (nparts == 1 && part <= order))
    return E_RESIDUAL;
  int64_t idx = 0;
  for (int p = 0; p < nparts; p++) {
    int count = (p == 0) ? part - order : part;
    uint32_t param = (uint32_t)br.read(plen);
    if (param == escape) {
      int bits = (int)br.read(5);
      if (bits == 0) {
        for (int i = 0; i < count; i++) resid[idx++] = 0;
      } else {
        for (int i = 0; i < count; i++) resid[idx++] = br.read_signed(bits);
      }
    } else {
      for (int i = 0; i < count; i++) {
        int64_t q = br.read_unary();
        uint64_t low = param ? br.read(param) : 0;
        uint64_t v = ((uint64_t)q << param) | low;
        resid[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    if (br.fail) return E_TRUNC;
  }
  return 0;
}

// decodes one subframe into x[blocksize]
int64_t decode_subframe(BitReader& br, int blocksize, int bps, int64_t* x,
                        int64_t* scratch) {
  if (br.read(1)) return E_SUBFRAME;
  int stype = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) {
    wasted = (int)br.read_unary() + 1;
    bps -= wasted;
  }
  if (br.fail) return E_TRUNC;
  if (bps <= 0 || bps > 33) return E_SUBFRAME;

  if (stype == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) x[i] = v;
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) x[i] = br.read_signed(bps);
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    int order = stype - 8;
    if (order > blocksize) return E_SUBFRAME;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
    int64_t rc = decode_residual(br, blocksize, order, scratch);
    if (rc) return rc;
    const int* c = kFixedCoeffs[order];
    for (int i = order; i < blocksize; i++) {
      int64_t acc = scratch[i - order];
      for (int j = 0; j < order; j++) acc += (int64_t)c[j] * x[i - 1 - j];
      x[i] = acc;
    }
  } else if (stype >= 32) {  // LPC
    int order = (stype & 31) + 1;
    if (order > blocksize) return E_SUBFRAME;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
    int prec = (int)br.read(4);
    if (prec == 15) return E_SUBFRAME;
    prec += 1;
    int64_t shift = br.read_signed(5);
    if (shift < 0) return E_SUBFRAME;
    int64_t coeffs[32];
    for (int i = 0; i < order; i++) coeffs[i] = br.read_signed(prec);
    int64_t rc = decode_residual(br, blocksize, order, scratch);
    if (rc) return rc;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coeffs[j] * x[i - 1 - j];
      x[i] = scratch[i - order] + (acc >> shift);
    }
  } else {
    return E_SUBFRAME;
  }
  if (br.fail) return E_TRUNC;
  if (wasted) {
    for (int i = 0; i < blocksize; i++) x[i] <<= wasted;
  }
  return 0;
}

}  // namespace

extern "C" {

// Decodes a whole FLAC stream. `out` receives interleaved int32 samples
// ([n][channels]); `max_samples` is the per-channel capacity. Returns the
// per-channel sample count, or a negative error code.
int64_t flac_decode(const uint8_t* data, int64_t len, int32_t* out,
                    int64_t max_samples, int32_t* rate_out,
                    int32_t* channels_out, int32_t* bps_out) {
  init_tabs();
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return E_MAGIC;
  int64_t pos = 4;
  bool have_si = false;
  uint32_t si_rate = 0;
  int si_channels = 0, si_bps = 0;
  uint64_t si_total = 0;
  while (true) {
    if (pos + 4 > len) return E_TRUNC;
    uint8_t hdr = data[pos];
    bool last = hdr & 0x80;
    int btype = hdr & 0x7F;
    int64_t blen = ((int64_t)data[pos + 1] << 16) |
                   ((int64_t)data[pos + 2] << 8) | data[pos + 3];
    if (pos + 4 + blen > len) return E_TRUNC;
    if (btype == 0) {
      if (blen < 34) return E_STREAMINFO;
      BitReader br(data, len, pos + 4);
      br.read(16); br.read(16); br.read(24); br.read(24);
      si_rate = (uint32_t)br.read(20);
      si_channels = (int)br.read(3) + 1;
      si_bps = (int)br.read(5) + 1;
      si_total = br.read(36);
      have_si = true;
    }
    pos += 4 + blen;
    if (last) break;
  }
  if (!have_si) return E_STREAMINFO;
  *rate_out = (int32_t)si_rate;
  *channels_out = (int32_t)si_channels;
  *bps_out = (int32_t)si_bps;

  // per-channel scratch: max FLAC block is 65535 samples
  static thread_local int64_t chan_buf[2][65536];
  static thread_local int64_t resid_buf[65536];
  static thread_local int64_t big_buf[8][65536];  // >2 channels

  int64_t got = 0;
  while (pos < len && (si_total == 0 || got < (int64_t)si_total)) {
    int64_t hdr_start = pos;
    BitReader br(data, len, pos);
    if (br.read(14) != 0x3FFE) return E_SYNC;
    if (br.read(1)) return E_HDR;
    br.read(1);  // blocking strategy
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int chan_code = (int)br.read(4);
    int ss_code = (int)br.read(3);
    if (br.read(1)) return E_HDR;
    uint64_t num;
    int64_t rc = read_utf8_number(br, &num);
    if (rc) return rc;
    int blocksize;
    if (bs_code == 0) return E_HDR;
    else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
    else blocksize = kBlocksizeCode[bs_code];
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (sr_code == 15) return E_HDR;
    int bps = (ss_code == 3) ? -1 : kSampleSizeCode[ss_code];
    if (bps < 0) return E_HDR;
    if (bps == 0) bps = si_bps;
    br.align();
    if (br.fail) return E_TRUNC;
    int64_t hdr_len = br.byte_pos() - hdr_start;
    uint8_t want_crc8 = (uint8_t)br.read(8);
    if (want_crc8 != crc8(data + hdr_start, hdr_len)) return E_CRC;
    if (blocksize <= 0 || blocksize > 65535) return E_HDR;
    if (got + blocksize > max_samples &&
        !(si_total != 0 && got < (int64_t)si_total)) return E_OVERFLOW;

    if (chan_code < 8) {
      int nchan = chan_code + 1;
      if (nchan != si_channels) return E_HDR;
      if (nchan > 8) return E_HDR;
      for (int c = 0; c < nchan; c++) {
        rc = decode_subframe(br, blocksize, bps, big_buf[c], resid_buf);
        if (rc) return rc;
      }
      int64_t room = max_samples - got;
      int take = blocksize < room ? blocksize : (int)room;
      for (int i = 0; i < take; i++)
        for (int c = 0; c < nchan; c++)
          out[(got + i) * nchan + c] = (int32_t)big_buf[c][i];
    } else if (chan_code <= 10) {
      if (si_channels != 2) return E_HDR;
      int bps0 = bps + (chan_code == 9 ? 1 : 0);
      int bps1 = bps + (chan_code == 9 ? 0 : 1);
      rc = decode_subframe(br, blocksize, bps0, chan_buf[0], resid_buf);
      if (rc) return rc;
      rc = decode_subframe(br, blocksize, bps1, chan_buf[1], resid_buf);
      if (rc) return rc;
      int64_t room = max_samples - got;
      int take = blocksize < room ? blocksize : (int)room;
      for (int i = 0; i < take; i++) {
        int64_t left, right;
        if (chan_code == 8) {        // left/side
          left = chan_buf[0][i];
          right = left - chan_buf[1][i];
        } else if (chan_code == 9) {  // right/side
          right = chan_buf[1][i];
          left = right + chan_buf[0][i];
        } else {                      // mid/side
          int64_t mid = chan_buf[0][i], side = chan_buf[1][i];
          mid = (mid << 1) | (side & 1);
          left = (mid + side) >> 1;
          right = (mid - side) >> 1;
        }
        out[(got + i) * 2] = (int32_t)left;
        out[(got + i) * 2 + 1] = (int32_t)right;
      }
    } else {
      return E_HDR;
    }

    br.align();
    if (br.fail) return E_TRUNC;
    int64_t body_len = br.byte_pos() - hdr_start;
    uint16_t want_crc16 = (uint16_t)br.read(16);
    if (br.fail) return E_TRUNC;
    if (want_crc16 != crc16(data + hdr_start, body_len)) return E_CRC;
    got += blocksize;
    pos = br.byte_pos();
  }
  if (si_total != 0 && got > (int64_t)si_total) got = (int64_t)si_total;
  return got;
}

}  // extern "C"
