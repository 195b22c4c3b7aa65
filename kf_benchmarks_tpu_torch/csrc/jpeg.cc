// JPEG codec of the port's input path: a baseline decoder that gives what
// libjpeg(-turbo) gives through PIL, at full and reduced (DCT-domain) scale,
// and a baseline encoder for the record generator.
//
// Decode: 8-bit Huffman, sequential (SOF0 / SOF1) or progressive (SOF2), 1,
// 3 or 4 components at any sampling factors, any DHT/DQT tables, restart
// intervals, interleaved or one-component scans. A progressive file's scans
// (jdphuff.c: DC first and refinement, AC first with end-of-band runs, AC
// refinement with correction bits) build the whole image's coefficients,
// which then take the same output stage as a sequential file's. The output stage is libjpeg's: the integer
// ("islow") IDCT, its reduced 4x4 / 2x2 / 1x1 IDCTs for the 1/2, 1/4 and 1/8
// scales (each component's DCT size picked as jdmaster.c picks it, so that
// chroma is scaled by the IDCT rather than upsampled where it can be),
// fancy (triangular) upsampling with libjpeg's context rows, and the
// fixed-point YCbCr -> RGB of jdcolor.c. Four-component files are CMYK, or
// YCCK under an Adobe marker with transform 2, and come out as RGB the way
// PIL's ``convert("RGB")`` makes them (it reads Adobe CMYK inverted).
// Arithmetic-coded, lossless, hierarchical and 12-bit frames are refused
// with the frame type named, and so is a progressive file whose scans leave
// some of AC coefficients 1-9 incomplete: libjpeg would smooth its blocks
// (jdcoefct.c block smoothing), which this codec does not do. Truncated or
// corrupt data is an error, never a guess.
//
// Encode: baseline YCbCr (4:4:4, 4:2:2 or 4:2:0) or grayscale with the
// standard tables of the JPEG specification (Annex K) scaled by a quality
// as jcparam.c scales them, the integer forward DCT of jfdctint.c and a
// JFIF header.
//
// Also here: CRC32C, for the TFRecord framing of the records.
//
// Every entry point returns 0 on success, or -1 with a message in ``err``.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // Guard entries: a run past the block's end lands on 63.
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables and the entropy-coded bit reader

struct Huffman {
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t fast[1 << 9];  // (length << 8) | value for codes of <= 9 bits
  bool defined = false;

  void build(const uint8_t* bits, const uint8_t* values) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l - 1];
    if (total > 256) fail("corrupt JPEG: Huffman table with > 256 codes");
    memcpy(vals, values, total);
    memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      // As jdhuff.c: no code may be all ones.
      if (bits[l - 1] && code >= (1 << l))
        fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct BitReader {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  uint64_t acc = 0;  // MSB-aligned
  int count = 0;     // bits held in acc, the padding ones included
  int padding = 0;   // zero bits appended past the end of the scan's data
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      if (!at_marker && pos < size) {
        uint8_t b = data[pos];
        if (b == 0xFF) {
          if (pos + 1 < size && data[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            continue;
          }
        } else {
          ++pos;
        }
        acc |= (uint64_t)b << (56 - count);
      } else {
        padding += 8;
      }
      count += 8;
    }
  }

  uint32_t peek16() {
    if (count < 16) fill();
    return (uint32_t)(acc >> 48);
  }

  void skip(int n) {
    acc <<= n;
    count -= n;
    if (count < padding) fail("truncated JPEG: the scan's data ends early");
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (count < n) fill();
    int v = (int)(acc >> (64 - n));
    skip(n);
    return v;
  }

  int decode(const Huffman& h) {
    uint32_t look = peek16();
    uint16_t f = h.fast[look >> 7];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = (int)(look >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(h.valptr[l] + code - h.mincode[l]) & 0xFF];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }

  void reset() {
    acc = 0;
    count = 0;
    padding = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// IDCTs (jidctint.c jpeg_idct_islow, jidctred.c 4x4 / 2x2 / 1x1)

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the value wraps to 10 bits, then clamps.
inline uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

void idct_8x8(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995,
                F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (int)(ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = (int)descale(tmp10 + tmp3, n);
    ws[7 * 8 + c] = (int)descale(tmp10 - tmp3, n);
    ws[1 * 8 + c] = (int)descale(tmp11 + tmp2, n);
    ws[6 * 8 + c] = (int)descale(tmp11 - tmp2, n);
    ws[2 * 8 + c] = (int)descale(tmp12 + tmp1, n);
    ws[5 * 8 + c] = (int)descale(tmp12 - tmp1, n);
    ws[3 * 8 + c] = (int)descale(tmp13 + tmp0, n);
    ws[4 * 8 + c] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  const int64_t F0_211 = 1730, F0_509 = 4176, F0_601 = 4926, F0_765 = 6270,
                F0_899 = 7373, F1_061 = 8697, F1_451 = 11893, F1_847 = 15137,
                F2_172 = 17799, F2_562 = 20995;
  int ws[32];  // 8 columns x 4 rows
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // column 4 is not used by the second pass
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)(ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 4; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t tmp0 = (int64_t)(ip[0] * qp[0]) * (1 << (CONST_BITS + 1));
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t tmp2 = z2 * F1_847 + z3 * -F0_765;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    int64_t z4 = ip[8] * qp[8];
    tmp0 = z1 * -F0_211 + z2 * F1_451 + z3 * -F2_172 + z4 * F1_061;
    tmp2 = z1 * -F0_509 + z2 * -F0_601 + z3 * F0_899 + z4 * F2_562;
    const int n = CONST_BITS - PASS1_BITS + 1;
    ws[0 * 8 + c] = (int)descale(tmp10 + tmp2, n);
    ws[3 * 8 + c] = (int)descale(tmp10 - tmp2, n);
    ws[1 * 8 + c] = (int)descale(tmp12 + tmp0, n);
    ws[2 * 8 + c] = (int)descale(tmp12 - tmp0, n);
  }
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 4; ++c) o[c] = dc;
      continue;
    }
    int64_t tmp0 = (int64_t)w[0] * (1 << (CONST_BITS + 1));
    int64_t tmp2 = (int64_t)w[2] * F1_847 + (int64_t)w[6] * -F0_765;
    int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    int64_t z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -F0_211 + z2 * F1_451 + z3 * -F2_172 + z4 * F1_061;
    tmp2 = z1 * -F0_509 + z2 * -F0_601 + z3 * F0_899 + z4 * F2_562;
    const int n = CONST_BITS + PASS1_BITS + 3 + 1;
    o[0] = idct_limit(descale(tmp10 + tmp2, n));
    o[3] = idct_limit(descale(tmp10 - tmp2, n));
    o[1] = idct_limit(descale(tmp12 + tmp0, n));
    o[2] = idct_limit(descale(tmp12 - tmp0, n));
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out,
              int stride) {
  const int64_t F0_720 = 5906, F0_850 = 6967, F1_272 = 10426, F3_624 = 29692;
  int ws[16];  // 8 columns x 2 rows
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      int dc = (int)(ip[0] * qp[0]) * (1 << PASS1_BITS);
      ws[c] = ws[8 + c] = dc;
      continue;
    }
    int64_t tmp10 = (int64_t)(ip[0] * qp[0]) * (1 << (CONST_BITS + 2));
    int64_t tmp0 = (int64_t)(ip[56] * qp[56]) * -F0_720 +
                   (int64_t)(ip[40] * qp[40]) * F0_850 +
                   (int64_t)(ip[24] * qp[24]) * -F1_272 +
                   (int64_t)(ip[8] * qp[8]) * F3_624;
    const int n = CONST_BITS - PASS1_BITS + 2;
    ws[c] = (int)descale(tmp10 + tmp0, n);
    ws[8 + c] = (int)descale(tmp10 - tmp0, n);
  }
  for (int r = 0; r < 2; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[3] && !w[5] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], PASS1_BITS + 3));
      o[0] = o[1] = dc;
      continue;
    }
    int64_t tmp10 = (int64_t)w[0] * (1 << (CONST_BITS + 2));
    int64_t tmp0 = (int64_t)w[7] * -F0_720 + (int64_t)w[5] * F0_850 +
                   (int64_t)w[3] * -F1_272 + (int64_t)w[1] * F3_624;
    const int n = CONST_BITS + PASS1_BITS + 3 + 2;
    o[0] = idct_limit(descale(tmp10 + tmp0, n));
    o[1] = idct_limit(descale(tmp10 - tmp0, n));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = idct_limit(descale((int64_t)(in[0] * q[0]), 3));
}

// ---------------------------------------------------------------------------
// The decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks of the coefficient array (MCU-padded)
  int dc_pred = 0;
  bool quant_latched = false;
  // Progressive: the Al of the last scan that coded each coefficient (in
  // zigzag order), -1 before any (libjpeg's coef_bits).
  int coef_bits[64];
  uint16_t qt[64];  // natural order
  std::vector<int16_t> coef;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  bool scanned = false;
  bool progressive = false;
  // The scan being decoded: spectral selection and successive
  // approximation, and the end-of-band run of a progressive AC scan.
  int ss = 0, se = 63, ah = 0, al = 0;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG: the headers end early");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // Skips anything up to an 0xFF, then fill bytes.
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail("truncated JPEG: no EOI marker");
    return d[pos++];
  }

  void parse_headers(bool stop_at_frame) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) {
        if (!scanned) fail("truncated JPEG: EOI before any scan");
        return;
      }
      size_t start = pos;
      int len = u16();
      if (len < 2 || start + len > n)
        fail("truncated JPEG: a marker segment runs past the end");
      size_t end = start + len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          parse_sof(m, end);
          progressive = m == 0xC2;
          if (stop_at_frame) return;
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3) is not supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail("hierarchical (differential) JPEG (SOF" +
               std::to_string(m - 0xC0) + ") is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
               ") is not supported");
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC) is not supported");
        case 0xC4:
          parse_dht(end);
          break;
        case 0xDB:
          parse_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA:
          if (!frame) fail("corrupt JPEG: SOS before SOF");
          parse_sos_and_scan(end);
          continue;  // pos is past the scan's data
        case 0xE0:
          if (len >= 7 && !memcmp(d + pos, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && !memcmp(d + pos, "Adobe", 5)) {
            adobe = true;
            adobe_transform = d[pos + 11];
          }
          break;
        default:
          break;
      }
      pos = end;
    }
  }

  void parse_sof(int marker, size_t end) {
    if (frame) fail("corrupt JPEG: two frames");
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG (SOF" +
           std::to_string(marker - 0xC0) + ") is not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (width <= 0 || height <= 0)
      fail("corrupt JPEG: zero image size (or a DNL marker, unsupported)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG with " + std::to_string(ncomp) +
           " components is not supported");
    if (pos + 3 * ncomp > end) fail("corrupt JPEG: short SOF");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
  }

  void parse_dht(size_t end) {
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("corrupt JPEG: bad DHT");
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end) fail("corrupt JPEG: bad DHT");
      (cls ? ac : dc)[id].build(bits, d + pos);
      pos += total;
    }
  }

  void parse_dqt(size_t end) {
    while (pos < end) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) fail("corrupt JPEG: bad DQT");
      for (int i = 0; i < 64; ++i)
        qt[id][kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[id] = true;
    }
  }

  void parse_sos_and_scan(size_t end) {
    int ns = u8();
    if (ns < 1 || ns > 4) fail("corrupt JPEG: bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int t = u8();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) c = &comp[k];
      if (!c) fail("corrupt JPEG: SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("corrupt JPEG: bad SOS tables");
      if (!c->quant_latched) {
        if (!qt_defined[c->tq])
          fail("corrupt JPEG: a component's quantization table is missing");
        memcpy(c->qt, qt[c->tq], sizeof(c->qt));
        c->quant_latched = true;
      }
      sc[i] = c;
    }
    ss = u8();
    se = u8();
    int ahal = u8();
    ah = ahal >> 4;
    al = ahal & 15;
    if (progressive) {
      check_progression(sc, ns);
    } else if (ss != 0 || se != 63 || ahal != 0) {
      fail("corrupt JPEG: a sequential scan with spectral selection");
    }
    // The Huffman tables the scan reads (jdphuff.c: a DC refinement reads
    // none, an AC scan no DC table, a DC scan no AC table).
    for (int i = 0; i < ns; ++i) {
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if ((need_dc && !dc[sc[i]->td].defined) ||
          (need_ac && !ac[sc[i]->ta].defined))
        fail("corrupt JPEG: SOS uses an undefined Huffman table");
    }
    eobrun = 0;
    pos = end;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;

    BitReader br;
    br.data = d;
    br.size = n;
    br.pos = pos;
    int mcus_x, mcus_y;
    if (ns == 1) {
      Component* c = sc[0];
      int cw = (width * c->h + hmax - 1) / hmax;
      int ch = (height * c->v + vmax - 1) / vmax;
      mcus_x = (cw + 7) / 8;
      mcus_y = (ch + 7) / 8;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int total = mcus_x * mcus_y;
    int todo = restart_interval;
    int next_rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        // Restart: drop the byte's padding, expect RSTn, reset predictors.
        br.reset();
        size_t p = br.pos;
        while (p < n && d[p] == 0xFF) ++p;
        if (p >= n || d[p] != 0xD0 + next_rst)
          fail("corrupt JPEG: missing restart marker");
        br.pos = p + 1;
        br.at_marker = false;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
        todo = restart_interval;
      }
      int mx = m % mcus_x, my = m / mcus_x;
      for (int i = 0; i < ns; ++i) {
        Component* c = sc[i];
        int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwn; ++bx) {
            int row = my * bh + by, col = mx * bwn + bx;
            int16_t* blk = &c->coef[((size_t)row * c->bw + col) * 64];
            if (!progressive)
              decode_block(br, *c, blk);
            else if (ss == 0)
              ah == 0 ? decode_dc_first(br, *c, blk) : decode_dc_refine(br, blk);
            else
              ah == 0 ? decode_ac_first(br, *c, blk) : decode_ac_refine(br, *c, blk);
          }
      }
      if (restart_interval) --todo;
    }
    // Resume marker parsing after the scan's data.
    size_t p = br.pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 &&
                          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
      ++p;
    pos = p;
    scanned = true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    int t = br.decode(dc[c.td]);
    if (t > 15) fail("corrupt JPEG: bad DC magnitude");
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG: AC run past the block's end");
        blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // -- progressive scans (jdphuff.c) ----------------------------------------

  // start_pass_phuff_decoder's checks, as errors: libjpeg stops on an
  // illegal spectral selection or approximation and only warns on a bogus
  // progression (a refinement that does not follow the bits already sent),
  // which a conforming encoder never writes; both raise here.
  void check_progression(Component* const* sc, int ns) {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (ns != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad)
      fail("corrupt JPEG: illegal progressive scan (Ss=" +
           std::to_string(ss) + " Se=" + std::to_string(se) + " Ah=" +
           std::to_string(ah) + " Al=" + std::to_string(al) + ")");
    for (int i = 0; i < ns; ++i) {
      int* bits = sc[i]->coef_bits;
      if (ss != 0 && bits[0] < 0)
        fail("corrupt JPEG: progressive AC scan before the DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(bits[k], 0))
          fail("corrupt JPEG: bogus progressive successive approximation");
        bits[k] = al;
      }
    }
  }

  void decode_dc_first(BitReader& br, Component& c, int16_t* blk) {
    int t = br.decode(dc[c.td]);
    if (t > 15) fail("corrupt JPEG: bad DC magnitude");
    c.dc_pred += t ? extend(br.bits(t), t) : 0;
    blk[0] = (int16_t)(c.dc_pred * (1 << al));
  }

  void decode_dc_refine(BitReader& br, int16_t* blk) {
    if (br.bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt JPEG: AC run past the band's end");
        blk[kNatural[k]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + br.bits(r) - 1;
        break;
      }
    }
  }

  // One correction bit for an already-nonzero coefficient.
  void refine_nonzero(BitReader& br, int16_t* coef) {
    int p1 = 1 << al;
    if (br.bits(1) && (*coef & p1) == 0)
      *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk) {
    int k = ss;
    if (eobrun == 0) {
      const Huffman& h = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG: bad AC refinement magnitude");
          s = br.bits(1) ? (1 << al) : -(1 << al);
        } else if (r != 15) {
          eobrun = (1 << r) + br.bits(r);
          break;  // the rest of the band is the end-of-band run's
        }
        // Pass the nonzero coefficients (a correction bit each) and r zero
        // ones; the new coefficient lands on the zero after them.
        for (; k <= se; ++k) {
          int16_t* coef = &blk[kNatural[k]];
          if (*coef != 0) {
            refine_nonzero(br, coef);
          } else if (--r < 0) {
            break;
          }
        }
        if (s) {
          if (k > se) fail("corrupt JPEG: AC run past the band's end");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef != 0) refine_nonzero(br, coef);
      }
      --eobrun;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // image whose DC is known for every component while some of AC 1-9 are
  // not yet complete (libjpeg-turbo 2.1 and later look at 1-9; earlier
  // versions at 1-5, a subset).
  bool block_smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component& c = comp[ci];
      if (!c.quant_latched || c.coef_bits[0] < 0) return false;
      for (int k = 0; k <= 9; ++k)
        if (c.qt[kNatural[k]] == 0) return false;
      for (int k = 1; k <= 9; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // -- output stage --------------------------------------------------------

  enum class Space { Gray, YCbCr, RGB, CMYK, YCCK };

  Space color_space() const {
    if (ncomp == 1) return Space::Gray;
    if (ncomp == 3) {
      if (jfif) return Space::YCbCr;
      if (adobe) return adobe_transform == 0 ? Space::RGB : Space::YCbCr;
      if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
        return Space::RGB;
      return Space::YCbCr;
    }
    if (adobe && adobe_transform != 0) return Space::YCCK;
    return Space::CMYK;
  }

  // Output (out_w x out_h) samples of component ``ci`` at the decode scale.
  std::vector<uint8_t> component_plane(int ci, int min_size, int ssize,
                                       int out_w, int out_h) {
    Component& c = comp[ci];
    int pw = c.bw * ssize, ph = c.bh * ssize;
    std::vector<uint8_t> plane((size_t)pw * ph);
    void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int) =
        ssize == 8 ? idct_8x8 : ssize == 4 ? idct_4x4
                              : ssize == 2 ? idct_2x2 : idct_1x1;
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct(&c.coef[((size_t)by * c.bw + bx) * 64], c.qt,
             &plane[(size_t)by * ssize * pw + bx * ssize], pw);
    // Sizes after the IDCT's scaling (jdmaster.c).
    int dw = (int)(((int64_t)width * c.h * ssize + hmax * 8 - 1) /
                   (hmax * 8));
    int dh = (int)(((int64_t)height * c.v * ssize + vmax * 8 - 1) /
                   (vmax * 8));
    int h_in = c.h * ssize / min_size, v_in = c.v * ssize / min_size;
    int h_out = hmax, v_out = vmax;
    bool fancy = min_size > 1;
    std::vector<uint8_t> out((size_t)out_w * out_h);
    auto src = [&](int y) { return &plane[(size_t)y * pw]; };
    if (h_in == h_out && v_in == v_out) {
      for (int y = 0; y < out_h; ++y) memcpy(&out[(size_t)y * out_w], src(y),
                                             out_w);
    } else if (h_in * 2 == h_out && v_in == v_out && fancy && dw > 2) {
      std::vector<uint8_t> row(2 * (size_t)dw);
      for (int y = 0; y < out_h; ++y) {
        const uint8_t* in = src(y);
        uint8_t* o = row.data();
        int v0 = in[0];
        *o++ = (uint8_t)v0;
        *o++ = (uint8_t)((v0 * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = in[x] * 3;
          *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
          *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
        }
        int vl = in[dw - 1];
        *o++ = (uint8_t)((vl * 3 + in[dw - 2] + 1) >> 2);
        *o++ = (uint8_t)vl;
        memcpy(&out[(size_t)y * out_w], row.data(), out_w);
      }
    } else if (h_in == h_out && v_in * 2 == v_out && fancy) {
      for (int y = 0; y < out_h; ++y) {
        int iy = y / 2, v = y & 1;
        int ny = v == 0 ? std::max(iy - 1, 0) : std::min(iy + 1, dh - 1);
        const uint8_t* in0 = src(std::min(iy, dh - 1));
        const uint8_t* in1 = src(ny);
        int bias = v == 0 ? 1 : 2;
        uint8_t* o = &out[(size_t)y * out_w];
        for (int x = 0; x < out_w; ++x)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (h_in * 2 == h_out && v_in * 2 == v_out && fancy && dw > 2) {
      std::vector<uint8_t> row(2 * (size_t)dw);
      for (int y = 0; y < out_h; ++y) {
        int iy = y / 2, v = y & 1;
        int ny = v == 0 ? std::max(iy - 1, 0) : std::min(iy + 1, dh - 1);
        const uint8_t* in0 = src(std::min(iy, dh - 1));
        const uint8_t* in1 = src(ny);
        uint8_t* o = row.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; ++x) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
        memcpy(&out[(size_t)y * out_w], row.data(), out_w);
      }
    } else if (h_out % h_in == 0 && v_out % v_in == 0) {
      // Box (replicating) upsampling, libjpeg's int_upsample and the
      // plain h2v1 / h2v2 methods.
      int hx = h_out / h_in, vx = v_out / v_in;
      for (int y = 0; y < out_h; ++y) {
        const uint8_t* in = src(y / vx);
        uint8_t* o = &out[(size_t)y * out_w];
        for (int x = 0; x < out_w; ++x) o[x] = in[x / hx];
      }
    } else {
      fail("JPEG with fractional sampling ratios is not supported");
    }
    return out;
  }

  void render(int scale, uint8_t* rgb, int out_w, int out_h) {
    if (!scanned) fail("truncated JPEG: no scan");
    if (block_smoothing())
      fail("progressive JPEG (SOF2) whose scans leave AC coefficients 1-9 "
           "incomplete (libjpeg's block smoothing) is not supported");
    int min_size = 8 / scale;
    std::vector<std::vector<uint8_t>> planes(ncomp);
    for (int ci = 0; ci < ncomp; ++ci) {
      // Scale chroma by the IDCT rather than by upsampling where the ratio
      // allows (jdmaster.c, IDCT_SCALING_SUPPORTED).
      int ssize = min_size;
      while (ssize < 8 &&
             (hmax * min_size) % (comp[ci].h * ssize * 2) == 0 &&
             (vmax * min_size) % (comp[ci].v * ssize * 2) == 0)
        ssize *= 2;
      planes[ci] = component_plane(ci, min_size, ssize, out_w, out_h);
    }
    size_t npix = (size_t)out_w * out_h;
    Space space = color_space();
    if (space == Space::Gray) {
      const uint8_t* g = planes[0].data();
      for (size_t i = 0; i < npix; ++i)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    if (space == Space::RGB) {
      for (size_t i = 0; i < npix; ++i)
        for (int k = 0; k < 3; ++k) rgb[3 * i + k] = planes[k][i];
      return;
    }
    // jdcolor.c's tables.
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    if (space == Space::YCbCr) {
      const uint8_t *yp = planes[0].data(), *cbp = planes[1].data(),
                    *crp = planes[2].data();
      for (size_t i = 0; i < npix; ++i) {
        int y = yp[i], cb = cbp[i], cr = crp[i];
        rgb[3 * i] = clamp(y + cr_r[cr]);
        rgb[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        rgb[3 * i + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // CMYK (YCCK converted to it first, as libjpeg does), then PIL's reading
    // of Adobe CMYK (inverted) and its convert("RGB").
    for (size_t i = 0; i < npix; ++i) {
      int c, m, yy;
      if (space == Space::YCCK) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        c = clamp(255 - (y + cr_r[cr]));
        m = clamp(255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> 16)));
        yy = clamp(255 - (y + cb_b[cb]));
      } else {
        c = planes[0][i];
        m = planes[1][i];
        yy = planes[2][i];
      }
      int k = planes[3][i];
      // PIL: C' = 255 - c (the Adobe inversion), nk = 255 - K' = k,
      // out = nk - MULDIV255(C', nk).
      int nk = k;
      int in[3] = {255 - c, 255 - m, 255 - yy};
      for (int ch = 0; ch < 3; ++ch) {
        int tmp = in[ch] * nk + 128;
        int prod = ((tmp >> 8) + tmp) >> 8;
        rgb[3 * i + ch] = clamp(nk - prod);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The encoder

const uint8_t kStdLumaQ[64] = {  // zigzag order
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)code_v++;
        size[vals[k]] = (uint8_t)l;
      }
      code_v <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int count = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void put(uint32_t bits, int n) {
    // n <= 16
    acc = (acc << n) | (bits & ((1u << n) - 1));
    count += n;
    while (count >= 8) {
      uint8_t b = (uint8_t)(acc >> (count - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      count -= 8;
    }
  }
  void flush() {
    if (count) put(0x7F, 8 - count);  // pad with ones
    acc = 0;
    count = 0;
  }
};

void fdct_islow(int* data) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995,
                F3_072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    int step = pass == 0 ? 1 : 8;    // element stride within a line
    int lstep = pass == 0 ? 8 : 1;   // stride between lines
    for (int l = 0; l < 8; ++l) {
      int* p = data + l * lstep;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step],
              tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step],
              tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int n_even = pass == 0 ? 0 : PASS1_BITS;  // shift of the DC/4 terms
      int n = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
      if (pass == 0) {
        p[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        p[0] = (int)descale(tmp10 + tmp11, n_even);
        p[4 * step] = (int)descale(tmp10 - tmp11, n_even);
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = (int)descale(z1 + tmp13 * F0_765, n);
      p[6 * step] = (int)descale(z1 + tmp12 * -F1_847, n);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int)descale(tmp4 + z1 + z3, n);
      p[5 * step] = (int)descale(tmp5 + z2 + z4, n);
      p[3 * step] = (int)descale(tmp6 + z2 + z3, n);
      p[1 * step] = (int)descale(tmp7 + z1 + z4, n);
    }
  }
}

int bit_length(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const uint8_t* plane, int pw, int bx, int by,
                  const int* divisors, const EncTable& dct,
                  const EncTable& act, int& pred) {
  int data[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      data[y * 8 + x] = plane[(size_t)(by * 8 + y) * pw + bx * 8 + x] - 128;
  fdct_islow(data);
  int q[64];
  for (int i = 0; i < 64; ++i) {
    int qv = divisors[i];
    int t = data[i];
    if (t < 0) {
      t = -t + (qv >> 1);
      t = -(t >= qv ? t / qv : 0);
    } else {
      t += qv >> 1;
      t = t >= qv ? t / qv : 0;
    }
    q[i] = t;
  }
  int diff = q[0] - pred;
  pred = q[0];
  int a = diff < 0 ? -diff : diff;
  int nb = bit_length(a);
  w.put(dct.code[nb], dct.size[nb]);
  if (nb) w.put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    int av = v < 0 ? -v : v;
    int s = bit_length(av);
    int rs = (run << 4) | s;
    w.put(act.code[rs], act.size[rs]);
    w.put((uint32_t)(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run) w.put(act.code[0], act.size[0]);
}

std::vector<uint8_t> encode(const uint8_t* img, int width, int height,
                            int channels, int quality, int subsampling) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
    fail("encode: bad image size");
  if (channels != 1 && channels != 3) fail("encode: 1 or 3 channels");
  if (subsampling < 0 || subsampling > 2) fail("encode: bad subsampling");
  quality = quality < 1 ? 1 : quality > 100 ? 100 : quality;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint8_t qtab[2][64];  // zigzag order
  for (int i = 0; i < 64; ++i) {
    const uint8_t* base[2] = {kStdLumaQ, kStdChromaQ};
    for (int t = 0; t < 2; ++t) {
      long v = ((long)base[t][i] * scale + 50) / 100;
      qtab[t][i] = (uint8_t)(v <= 0 ? 1 : v > 255 ? 255 : v);
    }
  }
  int divisors[2][64];  // natural order, x8 for the DCT's scaling
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) divisors[t][kNatural[i]] = qtab[t][i] << 3;
  int ncomp = channels;
  int hs = 1, vs = 1;
  if (ncomp == 3 && subsampling >= 1) hs = 2;
  if (ncomp == 3 && subsampling == 2) vs = 2;
  int mcu_w = 8 * hs, mcu_h = 8 * vs;
  int mx = (width + mcu_w - 1) / mcu_w, my = (height + mcu_h - 1) / mcu_h;
  int pw = mx * mcu_w, ph = my * mcu_h;
  // Planes at full size, edges replicated.
  std::vector<std::vector<uint8_t>> full(ncomp,
                                         std::vector<uint8_t>((size_t)pw * ph));
  const int64_t one_half = (int64_t)1 << 15, cbcr_off = (int64_t)128 << 16;
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  for (int y = 0; y < ph; ++y) {
    int sy = std::min(y, height - 1);
    for (int x = 0; x < pw; ++x) {
      int sx = std::min(x, width - 1);
      const uint8_t* p = img + ((size_t)sy * width + sx) * channels;
      size_t o = (size_t)y * pw + x;
      if (ncomp == 1) {
        full[0][o] = p[0];
        continue;
      }
      int64_t r = p[0], g = p[1], b = p[2];
      full[0][o] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g +
                              fix(0.11400) * b + one_half) >> 16);
      full[1][o] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g +
                              fix(0.5) * b + cbcr_off + one_half - 1) >> 16);
      full[2][o] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g -
                              fix(0.08131) * b + cbcr_off + one_half - 1) >>
                             16);
    }
  }
  // Chroma downsampled as jcsample.c does (alternating bias).
  int cw = pw / hs, chh = ph / vs;
  std::vector<std::vector<uint8_t>> planes(ncomp);
  planes[0] = full[0];
  for (int c = 1; c < ncomp; ++c) {
    if (hs == 1 && vs == 1) {
      planes[c] = full[c];
      continue;
    }
    planes[c].resize((size_t)cw * chh);
    for (int y = 0; y < chh; ++y) {
      int bias = vs == 2 ? 1 : 0;
      for (int x = 0; x < cw; ++x) {
        const uint8_t* r0 = &full[c][(size_t)(y * vs) * pw + 2 * x];
        int v;
        if (vs == 2) {
          const uint8_t* r1 = r0 + pw;
          v = (r0[0] + r0[1] + r1[0] + r1[1] + bias) >> 2;
          bias ^= 3;
        } else {
          v = (r0[0] + r0[1] + bias) >> 1;
          bias ^= 1;
        }
        planes[c][(size_t)y * cw + x] = (uint8_t)v;
      }
    }
  }
  EncTable dcl, acl, dcc, acc;
  dcl.build(kDcLumaBits, kDcVals);
  acl.build(kAcLumaBits, kAcLumaVals);
  dcc.build(kDcChromaBits, kDcVals);
  acc.build(kAcChromaBits, kAcChromaVals);

  Writer w;
  w.word(0xFFD8);
  // JFIF APP0
  w.word(0xFFE0);
  w.word(16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);
  int nq = ncomp == 3 ? 2 : 1;
  w.word(0xFFDB);
  w.word(2 + 65 * nq);
  for (int t = 0; t < nq; ++t) {
    w.byte(t);
    for (int i = 0; i < 64; ++i) w.byte(qtab[t][i]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * ncomp);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte(c == 0 ? (hs << 4) | vs : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  auto dht = [&](int tc, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[i];
    w.word(0xFFC4);
    w.word(2 + 17 + total);
    w.byte(tc);
    for (int i = 0; i < 16; ++i) w.byte(bits[i]);
    for (int i = 0; i < total; ++i) w.byte(vals[i]);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  if (ncomp == 3) {
    dht(0x01, kDcChromaBits, kDcVals);
    dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  w.word(0xFFDA);
  w.word(6 + 2 * ncomp);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);
  int pred[3] = {0, 0, 0};
  for (int y = 0; y < my; ++y)
    for (int x = 0; x < mx; ++x) {
      for (int by = 0; by < vs; ++by)
        for (int bx = 0; bx < hs; ++bx)
          encode_block(w, planes[0].data(), pw, x * hs + bx, y * vs + by,
                       divisors[0], dcl, acl, pred[0]);
      for (int c = 1; c < ncomp; ++c)
        encode_block(w, planes[c].data(), cw, x, y, divisors[1], dcc, acc,
                     pred[c]);
    }
  w.flush();
  w.word(0xFFD9);
  return std::move(w.out);
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg);
}

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[i] = c;
    }
  }
};

}  // namespace

extern "C" {

// Header only: image size and component count.
int kfj_info(const uint8_t* data, size_t size, int* width, int* height,
             int* components, char* err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.parse_headers(true);
    if (!dec.frame) fail("corrupt JPEG: no frame header");
    *width = dec.width;
    *height = dec.height;
    *components = dec.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// RGB, HWC, at 1/scale (scale 1, 2, 4 or 8): out_w = ceil(W / scale),
// out_h = ceil(H / scale); ``out`` holds out_w * out_h * 3 bytes.
int kfj_decode(const uint8_t* data, size_t size, int scale, uint8_t* out,
               int out_w, int out_h, char* err, int errlen) {
  try {
    if (scale != 1 && scale != 2 && scale != 4 && scale != 8)
      fail("decode scale must be 1, 2, 4 or 8");
    Decoder dec(data, size);
    dec.parse_headers(false);
    if (out_w != (dec.width + scale - 1) / scale ||
        out_h != (dec.height + scale - 1) / scale)
      fail("decode: output size does not match the image at this scale");
    dec.render(scale, out, out_w, out_h);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// Baseline JPEG of an HWC uint8 image (channels 1 or 3); subsampling 0, 1,
// 2 = 4:4:4, 4:2:2, 4:2:0. Writes at most ``capacity`` bytes into ``out``
// and the length into ``*length``.
int kfj_encode(const uint8_t* img, int width, int height, int channels,
               int quality, int subsampling, uint8_t* out, size_t capacity,
               size_t* length, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes =
        encode(img, width, height, channels, quality, subsampling);
    if (bytes.size() > capacity) fail("encode: output buffer too small");
    memcpy(out, bytes.data(), bytes.size());
    *length = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

uint32_t kf_crc32c(const uint8_t* data, size_t size) {
  static const CrcTable table;  // initialised once, thread-safely
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < size; ++i)
    crc = (crc >> 8) ^ table.t[(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
