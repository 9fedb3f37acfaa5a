// JPEG decoding for the port's native host runtime (built into the same
// library as stereo_native.cc).
//
// It gives the bytes of PIL's Image.open(f).convert("RGB") on libjpeg-turbo
// with its defaults (x86-64), which the JAX package serves and reads images
// with, for every file PIL decodes, and refuses every file PIL refuses:
//
//   * frames: baseline (SOF0), extended Huffman (SOF1) and progressive
//     (SOF2) at 8 bits, 1, 3 or 4 components, sampling factors 1-4 with
//     integral ratios; spectral selection, successive approximation, EOB
//     runs; Huffman tables redefined between scans (the Annex K tables in
//     slots 0 and 1 of a sequential file that defines none there),
//     quantization tables at 8 and 16 bits, each component's table
//     latched at its first scan; restart intervals and libjpeg's
//     resynchronisation on a misplaced RSTn; a marker inside entropy data
//     ends the segment with zero bits and leaves the rest of its restart
//     interval at zero, as libjpeg does;
//   * the ISLOW integer IDCT of jidctint.c, at the integer widths of
//     libjpeg-turbo's x86 SIMD version (see idct_islow);
//   * fancy upsampling (jdsample.c): the triangle filters for h2v1, h1v2
//     and h2v2, replication for other integral ratios and for components
//     two samples wide or less, edges replicated from the component's last
//     real row and column;
//   * colour (jdcolor.c): YCbCr -> RGB with libjpeg's fixed-point tables;
//     JFIF or ids 1-2-3 mean YCbCr, an Adobe marker with transform 0 or ids
//     'R','G','B' mean RGB; grey replicated to three channels; CMYK and
//     YCCK (Adobe transform 2) inverted as PIL's "CMYK;I" raw mode reads
//     them and mapped to RGB by PIL's CMYK conversion;
//   * block smoothing (jdcoefct.c's decompress_smooth_data) of a
//     progressive file whose scans leave one of the first nine AC
//     coefficients short of its last bit;
//   * the end of the input as PIL hands it to libjpeg (64 KiB reads, and
//     jdhuff.c's fast and slow paths, which refill at different times): a
//     file is truncated where libjpeg would suspend at its last byte, but
//     a single-scan file whose last MCU is decoded needs no EOI, since PIL
//     ignores jpeg_finish_decompress suspending for it.
//
// Refused, each with its own code: arithmetic coding (SOF9-11), lossless
// (SOF3) and hierarchical (SOF5-7, SOF13-15) frames, precisions other than
// 8 bits, 2 or more than 4 components, truncated files, malformed headers
// (also the few that PIL's own header parser refuses: a TEM marker, a
// JFIF or Adobe segment too short for its version), and more than
// 178956970 pixels (PIL's decompression-bomb limit).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct JpegError {
  int code;
};

enum JpegCode {
  kJpegTruncated = -1,     // the data ends where libjpeg needs more
  kJpegCorrupt = -2,       // a malformed marker, table or scan header
  kJpegNotJpeg = -3,       // not FF D8 FF at the start
  kJpegArithmetic = -4,    // SOF9-11: arithmetic coding
  kJpegLossless = -5,      // SOF3: lossless
  kJpegHierarchical = -6,  // SOF5-7, SOF13-15: hierarchical (differential)
  kJpegPrecision = -7,     // sample precision other than 8 bits
  kJpegComponents = -8,    // not 1, 3 or 4 components
  kJpegSampling = -9,      // sampling factors outside 1-4, a fractional
                           // ratio, or more than 10 blocks in an MCU
  kJpegTooLarge = -10,     // a side over 65500 or too many pixels
  kJpegMemory = -11,       // out of memory
  kJpegNoImage = -12,      // EOI before any scan
};

[[noreturn]] void jfail(int code) { throw JpegError{code}; }

inline void jcheck(bool ok, int code = kJpegCorrupt) {
  if (!ok) jfail(code);
}

// Zigzag position -> natural (row-major) position, with 16 extra entries so
// that a corrupt run past coefficient 63 lands on 63, as libjpeg's does.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kMaxDimension = 65500;              // JPEG_MAX_DIMENSION
const uint64_t kMaxPixels = 2ull * 89478485;  // PIL's bomb limit, 2x

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};   // bits[l]: codes of length l
  uint8_t vals[256] = {};  // symbols in code order, zero past the count
};

// The Annex K.3 tables, which libjpeg-turbo puts in slots 0 and 1 of a
// sequential file that defines none there (Motion-JPEG frames leave them
// out).
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                                0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0,
                                  0, 0, 0};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0,
                                1, 0x7d};
const uint8_t kAcLumVals[162] = {
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
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0,
                                  1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
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

void set_table(HuffTable* t, const uint8_t* bits, const uint8_t* vals,
               int count) {
  t->defined = true;
  std::memcpy(t->bits, bits, 17);
  std::memset(t->vals, 0, sizeof(t->vals));
  std::memcpy(t->vals, vals, size_t(count));
}

// A table ready for decoding (jpeg_make_d_derived_tbl): canonical codes by
// length, and an 8-bit lookahead table for the short ones.
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256];  // (length << 8) | symbol; length 9: longer code
  uint8_t vals[256];
};

void derive(const HuffTable& t, bool dc, Derived* d) {
  jcheck(t.defined);
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    jcheck(p + t.bits[l] <= 256);
    for (int i = 0; i < t.bits[l]; ++i) size[p++] = uint8_t(l);
  }
  size[p] = 0;
  const int symbols = p;
  // Figure C.2, refusing a set of lengths that is not a Huffman tree.
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    jcheck(code < (1u << si));
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d->valoffset[l] = p - int32_t(code_of[p]);
      p += t.bits[l];
      d->maxcode[l] = int32_t(code_of[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;  // ends a corrupt code at 17 bits
  for (auto& e : d->lookup) e = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      int look = int(code_of[p]) << (8 - l);
      for (int n = 1 << (8 - l); n > 0; --n)
        d->lookup[look++] = uint16_t((l << 8) | t.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < symbols; ++i) jcheck(t.vals[i] <= 15);
  std::memcpy(d->vals, t.vals, sizeof(d->vals));
}

// ---------------------------------------------------------------------------
// Input: bytes, markers and the entropy-coded bit stream
// ---------------------------------------------------------------------------

// Thrown inside a sequential MCU when libjpeg would suspend for more input
// (see Source::buffer_end); the MCU is then decoded again.
struct NeedData {};

// PIL hands libjpeg a file in reads of 64 KiB and adds the next read
// whenever the decoder suspends for lack of input.
const size_t kReadSize = 65536;

struct Source {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int unread_marker = 0;  // a marker read but not yet processed
  // The end of the input PIL has handed over: where the decoder would
  // suspend.  It decides, as in libjpeg, whether a sequential MCU takes
  // the fast path, and a suspension at the end of the file is an error
  // (PIL: "image file is truncated").
  size_t buffer_end = 0;
  bool in_mcu = false;  // a suspension restarts the current MCU

  int byte() {
    while (pos >= buffer_end) {
      if (buffer_end >= size) jfail(kJpegTruncated);
      if (in_mcu) throw NeedData{};
      buffer_end = std::min(size, buffer_end + kReadSize);
    }
    return data[pos++];
  }
  int be16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    if (n <= 0) return;
    if (size - pos < size_t(n)) jfail(kJpegTruncated);
    pos += size_t(n);
    while (buffer_end < pos) buffer_end = std::min(size, buffer_end + kReadSize);
  }
  // Skips to the next marker (libjpeg's next_marker): any bytes up to an
  // 0xFF, fill 0xFFs, and stuffed FF/00 pairs.
  void next_marker() {
    int c;
    for (;;) {
      c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }
};

// The entropy decoder's bit buffer, read as libjpeg reads it (jdhuff.c):
// refilled to 57 bits at a time, never past a marker.  When a request
// needs more bits than remain before the marker, zero bits are supplied
// and `insufficient` is set; the rest of the restart interval then
// decodes to zero coefficients.
struct BitReader {
  Source* src;
  uint64_t buf = 0;
  int left = 0;
  bool insufficient = false;

  void fill(int nbits) {
    if (src->unread_marker == 0) {
      while (left < 57) {
        int c = src->byte();
        if (c == 0xFF) {
          do c = src->byte(); while (c == 0xFF);
          if (c != 0) {
            src->unread_marker = c;
            break;
          }
          c = 0xFF;
        }
        buf = (buf << 8) | uint64_t(c);
        left += 8;
      }
    }
    if (src->unread_marker != 0 && nbits > left) {
      insufficient = true;
      buf <<= 57 - left;
      left = 57;
    }
  }

  int get(int n) {
    if (left < n) fill(n);
    left -= n;
    return int((buf >> left) & ((1u << n) - 1));
  }

  // One Huffman symbol (HUFF_DECODE / jpeg_huff_decode); a code longer
  // than 16 bits decodes as 0, as libjpeg's does.
  int decode(const Derived& t) {
    int l = 1;
    if (left < 8) fill(0);
    if (left >= 8) {
      const int look = int((buf >> (left - 8)) & 0xFF);
      const int nb = t.lookup[look] >> 8;
      if (nb <= 8) {
        left -= nb;
        return t.lookup[look] & 0xFF;
      }
      l = nb;
    }
    int32_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

// decode_mcu_fast's refill (jdhuff.h FILL_BIT_BUFFER_FAST): six bytes when
// 16 bits or fewer remain.  A marker is backed out and read as a zero
// byte; the MCU is then decoded again by the slow path.  The caller
// leaves at least 512 bytes a block in the buffer, as libjpeg does.
inline void fill_fast(BitReader& br) {
  if (br.left > 16) return;
  Source* src = br.src;
  for (int i = 0; i < 6; ++i) {
    jcheck(src->pos + 1 < src->size);
    const int c0 = src->data[src->pos++];
    const int c1 = src->data[src->pos];
    br.buf = (br.buf << 8) | uint64_t(c0);
    br.left += 8;
    if (c0 == 0xFF) {
      ++src->pos;
      if (c1 != 0) {
        src->unread_marker = c1;
        src->pos -= 2;
        br.buf &= ~uint64_t(0xFF);
      }
    }
  }
}

inline int get_fast(BitReader& br, int n) {
  br.left -= n;
  return int((br.buf >> br.left) & ((1u << n) - 1));
}

// HUFF_DECODE_FAST: the same symbols as BitReader::decode.
inline int decode_fast(BitReader& br, const Derived& t) {
  fill_fast(br);
  const int look = int((br.buf >> (br.left - 8)) & 0xFF);
  int nb = t.lookup[look] >> 8;
  br.left -= nb;
  if (nb <= 8) return t.lookup[look] & 0xFF;
  int32_t code = int32_t((br.buf >> br.left) & ((1u << nb) - 1));
  while (code > t.maxcode[nb]) {
    code = (code << 1) | get_fast(br, 1);
    ++nb;
  }
  if (nb > 16) return 0;
  return t.vals[(code + t.valoffset[nb]) & 0xFF];
}

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int dw = 0, dh = 0;    // samples: downsampled width and height
  int wib = 0, hib = 0;  // blocks that hold samples
  int bw = 0, bh = 0;    // blocks stored: wib, hib rounded up to h, v
  bool latched = false;
  int quant[64] = {};       // natural order, as libjpeg's ISLOW table (short)
  uint16_t qraw[64] = {};   // the same table as the file gives it
  int coef_bits[64];        // progressive: the last Al coded, -1 for none
  int prev_bits[10] = {};   // coef_bits[0..9] before the last scan of it
  std::vector<int16_t> coefs;

  int16_t* block(int by, int bx) {
    return coefs.data() + (size_t(by) * size_t(bw) + size_t(bx)) * 64;
  }
};

enum { kReachedSos = 1, kReachedEoi = 2 };

struct Jpeg {
  Source src;
  bool saw_sof = false, progressive = false;
  int precision = 0, height = 0, width = 0, ncomp = 0;
  Component comp[4];
  int maxh = 1, maxv = 1;
  HuffTable dc_tables[4], ac_tables[4];
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool multi_scan = false;
  bool smooth = false;  // progressive block smoothing on output
  int scans_read = 0;   // SOS markers read (input_scan_number)
  // The iMCU row of the last MCU the entropy decoder began with data to
  // decode (libjpeg's last_good_iMCU_row): smoothing takes the
  // coefficients' bits from before their last scan below it.
  int last_good_imcu_row = 0;
  bool header = true;   // before the first scan: PIL parses these markers
  // The current scan.
  int scan_n = 0;
  int scan_comp[4] = {0, 0, 0, 0};
  int ss = 0, se = 0, ah = 0, al = 0;
  int next_restart_num = 0;

  Jpeg(const uint8_t* data, size_t size) {
    src.data = data;
    src.size = size;
    src.buffer_end = std::min(size, kReadSize);
  }

  // jdhuff.c's std_huff_tables, which libjpeg-turbo calls for sequential
  // files only, once the first scan's header is read: slots 0 and 1 the
  // file has not defined by then get the Annex K tables.
  void default_tables() {
    static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
    if (!dc_tables[0].defined) set_table(&dc_tables[0], kDcLumBits, kDcVals, 12);
    if (!dc_tables[1].defined) set_table(&dc_tables[1], kDcChromBits, kDcVals, 12);
    if (!ac_tables[0].defined) set_table(&ac_tables[0], kAcLumBits, kAcLumVals, 162);
    if (!ac_tables[1].defined) set_table(&ac_tables[1], kAcChromBits, kAcChromVals, 162);
  }

  // --- markers (jdmarker.c) -------------------------------------------------

  void get_sof(bool is_progressive) {
    jcheck(!saw_sof);
    int length = src.be16();
    precision = src.byte();
    height = src.be16();
    width = src.be16();
    ncomp = src.byte();
    length -= 8;
    if (precision != 8) jfail(kJpegPrecision);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) jfail(kJpegComponents);
    jcheck(height > 0 && width > 0);
    jcheck(length == ncomp * 3);
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      c.id = src.byte();
      const int f = src.byte();
      c.h = (f >> 4) & 15;
      c.v = f & 15;
      c.tq = src.byte();
    }
    saw_sof = true;
    progressive = is_progressive;
  }

  void get_sos() {
    jcheck(saw_sof);
    const int length = src.be16();
    const int n = src.byte();
    jcheck(length == n * 2 + 6 && n >= 1 && n <= 4);
    bool used[4] = {false, false, false, false};
    for (int i = 0; i < n; ++i) {
      const int id = src.byte();
      const int t = src.byte();
      int ci = 0;
      while (ci < ncomp && (comp[ci].id != id || used[ci])) ++ci;
      jcheck(ci < ncomp);
      used[ci] = true;
      scan_comp[i] = ci;
      comp[ci].dc_tbl = (t >> 4) & 15;
      comp[ci].ac_tbl = t & 15;
    }
    scan_n = n;
    ss = src.byte();
    se = src.byte();
    const int a = src.byte();
    ah = (a >> 4) & 15;
    al = a & 15;
    next_restart_num = 0;
    ++scans_read;
  }

  void get_dht() {
    long length = src.be16() - 2;
    while (length > 16) {
      const int index = src.byte();
      HuffTable t;
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = uint8_t(src.byte());
        count += t.bits[l];
      }
      length -= 17;
      jcheck(count <= 256 && count <= length);
      for (int i = 0; i < count; ++i) t.vals[i] = uint8_t(src.byte());
      length -= count;
      t.defined = true;
      const int slot = index & ~0x10;
      jcheck(slot < 4);
      (index & 0x10 ? ac_tables : dc_tables)[slot] = t;
    }
    jcheck(length == 0);
  }

  void get_dqt() {
    long length = src.be16() - 2;
    while (length > 0) {
      --length;
      const int n = src.byte();
      const int prec = n >> 4;
      const int slot = n & 15;
      jcheck(slot < 4);
      // A table shorter than 64 entries (libjpeg's reduced DCT sizes) is
      // not taken.
      jcheck(length >= (prec ? 128 : 64));
      for (int i = 0; i < 64; ++i)
        qtables[slot][kNatural[i]] = uint16_t(prec ? src.be16() : src.byte());
      qdefined[slot] = true;
      length -= prec ? 128 : 64;
    }
    jcheck(length == 0);
  }

  void get_dri() {
    jcheck(src.be16() == 4);
    restart_interval = src.be16();
  }

  // APP0 (JFIF) and APP14 (Adobe) are examined for the colour space;
  // every APPn is skipped by its length, so an embedded thumbnail is never
  // parsed.
  void get_app(int marker) {
    long length = src.be16() - 2;
    uint8_t b[14];
    const int n = length >= 14 ? 14 : (length > 0 ? int(length) : 0);
    for (int i = 0; i < n; ++i) b[i] = uint8_t(src.byte());
    // PIL's header parser reads a JFIF or Adobe segment's version (bytes
    // 5-6) and refuses the file when the segment is shorter.
    if (header && n < 7 &&
        ((marker == 0xE0 && n >= 4 && std::memcmp(b, "JFIF", 4) == 0) ||
         (marker == 0xEE && n >= 5 && std::memcmp(b, "Adobe", 5) == 0)))
      jfail(kJpegCorrupt);
    length -= n;
    if (marker == 0xE0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    src.skip(length);
  }

  void skip_variable() { src.skip(long(src.be16()) - 2); }

  // DAC (arithmetic conditioning): read and checked as libjpeg's get_dac
  // checks it, though only an arithmetic-coded file, refused, would use it.
  void get_dac() {
    long length = src.be16() - 2;
    while (length > 0) {
      const int index = src.byte();
      const int val = src.byte();
      length -= 2;
      jcheck(index < 32 && (index >= 16 || (val & 15) <= (val >> 4)));
    }
    jcheck(length == 0);
  }

  // Processes markers up to the next SOS (its header read) or EOI.
  int read_markers() {
    for (;;) {
      if (src.unread_marker == 0) src.next_marker();
      const int m = src.unread_marker;
      src.unread_marker = 0;
      switch (m) {
        case 0xC0: case 0xC1: get_sof(false); break;
        case 0xC2: get_sof(true); break;
        case 0xC3: jfail(kJpegLossless);
        case 0xC5: case 0xC6: case 0xC7:
        case 0xCD: case 0xCE: case 0xCF: jfail(kJpegHierarchical);
        case 0xC9: case 0xCA: case 0xCB: jfail(kJpegArithmetic);
        case 0xDA: get_sos(); return kReachedSos;
        case 0xD9: return kReachedEoi;
        case 0xC4: get_dht(); break;
        case 0xDB: get_dqt(); break;
        case 0xDD: get_dri(); break;
        case 0xCC: get_dac(); break;
        case 0xFE: case 0xDC: skip_variable(); break;  // COM, DNL
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7: break;
        case 0x01:  // TEM: libjpeg ignores it, PIL's header parser refuses it
          jcheck(!header);
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            get_app(m);
            break;
          }
          jfail(kJpegCorrupt);  // a second SOI, JPG, DHP, EXP, RESn
      }
    }
  }

  // Reads the markers up to the first scan and checks the frame
  // (jpeg_read_header and jdinput.c's initial_setup).
  void read_header() {
    // SOI and the 0xFF of a marker after it: the signature PIL's JPEG
    // plugin accepts (libjpeg alone would skip bytes up to the next 0xFF).
    if (src.size < 3 || src.data[0] != 0xFF || src.data[1] != 0xD8 ||
        src.data[2] != 0xFF)
      jfail(kJpegNotJpeg);
    src.pos = 2;
    if (read_markers() == kReachedEoi) jfail(kJpegNoImage);
    header = false;
    if (height > kMaxDimension || width > kMaxDimension ||
        uint64_t(height) * uint64_t(width) > kMaxPixels)
      jfail(kJpegTooLarge);
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component& c = comp[ci];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) jfail(kJpegSampling);
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      // jdsample.c takes integral upsampling ratios only.
      if (maxh % c.h || maxv % c.v) jfail(kJpegSampling);
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.wib = int((int64_t(width) * c.h + 8 * maxh - 1) / (8 * maxh));
      c.hib = int((int64_t(height) * c.v + 8 * maxv - 1) / (8 * maxv));
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
      for (int& b : c.coef_bits) b = -1;
    }
  }

  // --- scans (jdinput.c, jdhuff.c, jdphuff.c) --------------------------------

  void read_restart_marker() {
    if (src.unread_marker == 0) src.next_marker();
    if (src.unread_marker == 0xD0 + next_restart_num) {
      src.unread_marker = 0;
    } else {
      // jpeg_resync_to_restart: drop the marker when it is the one
      // expected or too far off, scan on past an earlier one, and leave a
      // later one or a non-restart marker for an empty segment.
      const int desired = next_restart_num;
      for (;;) {
        const int m = src.unread_marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) ||
                   m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) ||
                   m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          src.unread_marker = 0;
          break;
        }
        if (action == 3) break;
        src.next_marker();
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }

  void decode_scan() {
    Derived tables[4][2];  // [table slot][0: DC, 1: AC]
    const bool dc_band = ss == 0;
    if (progressive) {
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || scan_n != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      jcheck(!bad);
    }
    int blocks_in_mcu = 0;
    for (int i = 0; i < scan_n; ++i) {
      Component& c = comp[scan_comp[i]];
      blocks_in_mcu += scan_n == 1 ? 1 : c.h * c.v;
      if (!c.latched) {
        jcheck(c.tq < 4 && qdefined[c.tq]);
        for (int k = 0; k < 64; ++k) {
          c.qraw[k] = qtables[c.tq][k];
          c.quant[k] = int16_t(qtables[c.tq][k]);
        }
        c.latched = true;
      }
      if (!progressive || (dc_band && ah == 0)) {
        jcheck(c.dc_tbl < 4);
        derive(dc_tables[c.dc_tbl], true, &tables[c.dc_tbl][0]);
      }
      if (!progressive || !dc_band) {
        jcheck(c.ac_tbl < 4);
        derive(ac_tables[c.ac_tbl], false, &tables[c.ac_tbl][1]);
      }
      if (progressive) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9) && k < 10; ++k)
          c.prev_bits[k] = scans_read > 1 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      }
    }
    if (blocks_in_mcu > 10) jfail(kJpegSampling);

    int mcus_x, mcus_y;
    if (scan_n == 1) {
      mcus_x = comp[scan_comp[0]].wib;
      mcus_y = comp[scan_comp[0]].hib;
    } else {
      mcus_x = (width + 8 * maxh - 1) / (8 * maxh);
      mcus_y = (height + 8 * maxv - 1) / (8 * maxv);
    }
    // The blocks of one MCU: (scan index, block row, block column) offsets.
    int mcu_ci[10], mcu_dy[10], mcu_dx[10];
    int nb = 0;
    for (int i = 0; i < scan_n; ++i) {
      const Component& c = comp[scan_comp[i]];
      const int hh = scan_n == 1 ? 1 : c.h, vv = scan_n == 1 ? 1 : c.v;
      for (int y = 0; y < vv; ++y)
        for (int x = 0; x < hh; ++x) {
          mcu_ci[nb] = i;
          mcu_dy[nb] = y;
          mcu_dx[nb] = x;
          ++nb;
        }
    }

    BitReader br{&src};
    int restarts_to_go = restart_interval;
    int eobrun = 0;
    int last_dc[4] = {0, 0, 0, 0};
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    const int mcu_rows_per_imcu = scan_n == 1 ? comp[scan_comp[0]].v : 1;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (!br.insufficient) last_good_imcu_row = my / mcu_rows_per_imcu;
        if (restart_interval && restarts_to_go == 0) {
          br.left = 0;
          read_restart_marker();
          for (int& d : last_dc) d = 0;
          eobrun = 0;
          restarts_to_go = restart_interval;
          if (src.unread_marker == 0) br.insufficient = false;
        }
        int16_t* blocks[10];
        for (int b = 0; b < nb; ++b) {
          Component& c = comp[scan_comp[mcu_ci[b]]];
          const int hh = scan_n == 1 ? 1 : c.h, vv = scan_n == 1 ? 1 : c.v;
          blocks[b] = c.block(my * vv + mcu_dy[b], mx * hh + mcu_dx[b]);
        }
        if (!br.insufficient && !progressive) {
          // jdhuff.c's decode_mcu: the fast path while 512 bytes a block
          // are left in the input handed over and no restart interval
          // runs, the slow path otherwise or when the fast one meets a
          // marker.  A suspension (more input needed) decodes the MCU
          // again from its start, once the next read is handed over.
          const BitReader start = br;
          const size_t start_pos = src.pos;
          int start_dc[4];
          std::memcpy(start_dc, last_dc, sizeof(last_dc));
          for (;;) {
            src.in_mcu = true;
            try {
              const bool fast = restart_interval == 0 &&
                                src.unread_marker == 0 &&
                                src.buffer_end - src.pos >= size_t(512 * nb);
              decode_sequential_mcu(br, fast, tables, blocks, nb, mcu_ci,
                                    last_dc);
              if (fast && src.unread_marker != 0) {
                br = start;
                src.pos = start_pos;
                src.unread_marker = 0;
                std::memcpy(last_dc, start_dc, sizeof(last_dc));
                decode_sequential_mcu(br, false, tables, blocks, nb, mcu_ci,
                                      last_dc);
              }
              src.in_mcu = false;
              break;
            } catch (const NeedData&) {
              src.in_mcu = false;
              br = start;
              src.pos = start_pos;
              src.unread_marker = 0;
              std::memcpy(last_dc, start_dc, sizeof(last_dc));
              src.buffer_end = std::min(src.size, src.buffer_end + kReadSize);
            }
          }
        } else if (!br.insufficient) {
          for (int b = 0; b < nb; ++b) {
            const int si = mcu_ci[b];
            Component& c = comp[scan_comp[si]];
            int16_t* blk = blocks[b];
            if (dc_band && ah == 0) {
              int s = br.decode(tables[c.dc_tbl][0]);
              if (s) s = extend(br.get(s), s);
              const int64_t sum = int64_t(s) + last_dc[si];
              jcheck(sum >= INT32_MIN && sum <= INT32_MAX);
              last_dc[si] = int(sum);
              blk[0] = int16_t(unsigned(sum) << al);
            } else if (dc_band) {
              if (br.get(1)) blk[0] = int16_t(blk[0] | p1);
            } else if (ah == 0) {
              decode_ac_first(br, tables[c.ac_tbl][1], blk, &eobrun);
            } else {
              decode_ac_refine(br, tables[c.ac_tbl][1], blk, &eobrun, p1,
                               m1);
            }
          }
        }
        if (restart_interval) --restarts_to_go;
      }
    }
  }

  // One MCU of a sequential scan (decode_mcu_slow, or decode_mcu_fast
  // when `fast`): the same coefficients either way, read with different
  // refills.
  void decode_sequential_mcu(BitReader& br, bool fast,
                             const Derived (*tables)[2], int16_t* const* blocks,
                             int nb, const int* mcu_ci, int* last_dc) {
    auto decode = [&](const Derived& t) {
      return fast ? decode_fast(br, t) : br.decode(t);
    };
    auto get = [&](int n) {
      if (!fast) return br.get(n);
      fill_fast(br);
      return get_fast(br, n);
    };
    for (int b = 0; b < nb; ++b) {
      const int si = mcu_ci[b];
      const Component& c = comp[scan_comp[si]];
      int16_t* blk = blocks[b];
      int s = decode(tables[c.dc_tbl][0]);
      if (s) s = extend(get(s), s);
      s = int(unsigned(s) + unsigned(last_dc[si]));
      last_dc[si] = s;
      blk[0] = int16_t(s);
      const Derived& act = tables[c.ac_tbl][1];
      for (int k = 1; k < 64; ++k) {
        s = decode(act);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  void decode_ac_first(BitReader& br, const Derived& t, int16_t* blk,
                       int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = br.decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        --*eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, const Derived& t, int16_t* blk,
                        int* eobrun, int p1, int m1) {
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int s = br.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          // A newly nonzero coefficient is +-1 in the bit being coded
          // (a size other than 1 is corrupt; libjpeg warns and goes on).
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.get(r);
          break;
        }
        // Skip r zero coefficients, correcting the nonzero ones passed.
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
  }

  // jdcoefct.c's smoothing_ok: libjpeg smooths a progressive image whose
  // DC is known for every component and whose first nine AC coefficients
  // (zigzag 1-9) are not all complete.  The whole file is read before
  // output starts: block rows smooth by the final coef_bits, but for
  // those past the last good iMCU row (see last_good_imcu_row).
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component& c = comp[ci];
      if (!c.latched) return false;
      for (int q : kQ)
        if (c.qraw[q] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void decode_all() {
    for (int ci = 0; ci < ncomp; ++ci)
      comp[ci].coefs.assign(size_t(comp[ci].bw) * comp[ci].bh * 64, 0);
    multi_scan = scan_n < ncomp || progressive;
    if (!progressive) default_tables();
    decode_scan();
    for (;;) {
      int reached;
      try {
        reached = read_markers();
      } catch (const JpegError& e) {
        // The rows of a single-scan file are all decoded by now: PIL
        // ignores libjpeg's jpeg_finish_decompress suspending for an EOI
        // the file lacks.  A file of several scans is read to its EOI
        // before any row is output, so there it is an error.
        if (e.code == kJpegTruncated && !multi_scan) break;
        throw;
      }
      if (reached == kReachedEoi) break;
      jcheck(multi_scan);  // a second scan in a single-scan file
      decode_scan();
    }
    smooth = smoothing_ok();
  }

  void smoothed_block(const Component& c, const int* bits,
                      const int rows[5], int bx, int16_t* ws) const;
  void output(uint8_t* rgb, bool cmyk);
};

// ---------------------------------------------------------------------------
// Output: IDCT, upsampling, colour conversion
// ---------------------------------------------------------------------------

// The ISLOW IDCT of one block into 8x8 samples at `out`: jidctint.c's
// algorithm (CONST_BITS 13, PASS1_BITS 2, the same rounding), with the
// integer widths of libjpeg-turbo's x86 SIMD version (jidctint-sse2 and
// -avx2), which PIL's libjpeg-turbo runs on x86-64.  The two agree on
// every block an 8-bit image gives; they part only where a corrupt or
// synthetic block drives the IDCT far out of range:
//   * dequantization keeps the low 16 bits of coefficient * quantizer
//     (pmullw);
//   * a block whose rows 1-7 are all zero takes the DC row shifted left
//     by PASS1_BITS in 16 bits; any other block saturates its first
//     pass's outputs to 16 bits (packssdw);
//   * each pass adds in0 + in4, in0 - in4, in7 + in3 and in5 + in1 in 16
//     bits (paddw) and takes every product of the rotations as a sum of
//     two 16-bit products (pmaddwd), which no 16-bit input overflows;
//   * the output saturates to 0..255 (packsswb, then + 128), where the C
//     version wraps through its 1024-entry range-limit table.
void idct_islow(const int16_t* in, const int* quant, uint8_t* out,
                int stride) {
  const int kConstBits = 13, kPass1Bits = 2;
  const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int32_t x, int n) {
    return (x + (int32_t(1) << (n - 1))) >> n;
  };
  auto sat16 = [](int32_t x) {
    return int(std::min<int32_t>(std::max<int32_t>(x, -32768), 32767));
  };
  // One 1-D pass over x(0..7): its eight outputs before their descale.
  // The rotations are taken as the SIMD code takes them, each a sum of two
  // products (jidctint.c's algebra distributed), so that no sum leaves 32
  // bits: at most 2.12e9 for any 16-bit inputs.
  auto wrap16 = [](int32_t x) { return int32_t(int16_t(uint16_t(x))); };
  auto pass = [&](auto x, int32_t o[8]) {
    const int32_t tmp0e = wrap16(x(0) + x(4)) * (1 << kConstBits);
    const int32_t tmp1e = wrap16(x(0) - x(4)) * (1 << kConstBits);
    const int32_t tmp2e = x(2) * F0541 + x(6) * (F0541 - F1847);
    const int32_t tmp3e = x(2) * (F0541 + F0765) + x(6) * F0541;
    const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
    const int32_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
    const int32_t z3 = wrap16(x(7) + x(3)), z4 = wrap16(x(5) + x(1));
    const int32_t z3r = z3 * (F1175 - F1961) + z4 * F1175;
    const int32_t z4r = z3 * F1175 + z4 * (F1175 - F0390);
    const int32_t tmp0 = x(7) * (F0298 - F0899) + x(1) * -F0899 + z3r;
    const int32_t tmp1 = x(5) * (F2053 - F2562) + x(3) * -F2562 + z4r;
    const int32_t tmp2 = x(5) * -F2562 + x(3) * (F3072 - F2562) + z3r;
    const int32_t tmp3 = x(7) * -F0899 + x(1) * (F1501 - F0899) + z4r;
    o[0] = tmp10 + tmp3;
    o[7] = tmp10 - tmp3;
    o[1] = tmp11 + tmp2;
    o[6] = tmp11 - tmp2;
    o[2] = tmp12 + tmp1;
    o[5] = tmp12 - tmp1;
    o[3] = tmp13 + tmp0;
    o[4] = tmp13 - tmp0;
  };
  int deq[64];
  bool rows_zero = true;
  for (int i = 0; i < 64; ++i) {
    deq[i] = int16_t(in[i] * quant[i]);
    if (i >= 8 && in[i] != 0) rows_zero = false;
  }
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    if (rows_zero) {
      const int dc = int16_t(unsigned(deq[col]) << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + col] = dc;
      continue;
    }
    int32_t o[8];
    pass([&](int r) { return int32_t(deq[8 * r + col]); }, o);
    for (int r = 0; r < 8; ++r)
      ws[8 * r + col] = sat16(descale(o[r], kConstBits - kPass1Bits));
  }
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* dst = out + size_t(row) * stride;
    int32_t o[8];
    pass([&](int c) { return int32_t(w[c]); }, o);
    for (int c = 0; c < 8; ++c) {
      const int32_t v = descale(o[c], kConstBits + kPass1Bits + 3);
      dst[c] = uint8_t(std::min<int32_t>(std::max<int32_t>(v, -128), 127) +
                       128);
    }
  }
}

// One component's samples upsampled to the full image (jdsample.c with
// fancy upsampling): `in` holds dh rows of dw samples at `stride`.  Each
// filter replicates the component's last real row and column at the
// edges, which is what libjpeg's edge cases compute.
void upsample(const uint8_t* in, int stride, int dw, int dh, int hr, int vr,
              int width, int height, uint8_t* out) {
  auto row = [&](int y) {
    return in + size_t(std::min(std::max(y, 0), dh - 1)) * stride;
  };
  // Triangle-filter sums along a row (3 * nearer + further), with the
  // row's first and last entries repeated on each side.
  std::vector<int> sums(size_t(dw) + 2);
  int* t = sums.data() + 1;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + size_t(y) * width;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, row(y), size_t(width));
    } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* r = row(y);
      for (int i = 0; i < dw; ++i) t[i] = r[i];
      t[-1] = t[0];
      t[dw] = t[dw - 1];
      for (int x = 0; x + 1 < width; x += 2) {
        const int i = x >> 1;
        o[x] = uint8_t((3 * t[i] + t[i - 1] + 1) >> 2);
        o[x + 1] = uint8_t((3 * t[i] + t[i + 1] + 2) >> 2);
      }
      if (width & 1) {
        const int i = (width - 1) >> 1;
        o[width - 1] = uint8_t((3 * t[i] + t[i - 1] + 1) >> 2);
      }
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int i = y >> 1;
      const uint8_t* r0 = row(i);
      const uint8_t* r1 = row((y & 1) ? i + 1 : i - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        o[x] = uint8_t((3 * r0[x] + r1[x] + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int i = y >> 1;
      const uint8_t* r0 = row(i);
      const uint8_t* r1 = row((y & 1) ? i + 1 : i - 1);
      for (int j = 0; j < dw; ++j) t[j] = 3 * r0[j] + r1[j];
      t[-1] = t[0];
      t[dw] = t[dw - 1];
      for (int x = 0; x + 1 < width; x += 2) {
        const int j = x >> 1;
        o[x] = uint8_t((3 * t[j] + t[j - 1] + 8) >> 4);
        o[x + 1] = uint8_t((3 * t[j] + t[j + 1] + 7) >> 4);
      }
      if (width & 1) {
        const int j = (width - 1) >> 1;
        o[width - 1] = uint8_t((3 * t[j] + t[j - 1] + 8) >> 4);
      }
    } else {  // box replication (int_upsample, h2v1/h2v2_upsample)
      const uint8_t* r = row(y / vr);
      for (int x = 0; x < width; ++x) o[x] = r[x / hr];
    }
  }
}

// One block of jdcoefct.c's decompress_smooth_data: the coefficients of
// block (rows[2], bx) into `ws`, each of the first nine AC coefficients
// that is still zero and short of its last bit estimated from the DC
// values of the 5x5 blocks around it (rows[0..4], columns bx-2..bx+2,
// clamped); when no AC coefficient of the component was coded at all, the
// DC is interpolated too.
void Jpeg::smoothed_block(const Component& c, const int* bits,
                          const int rows[5], int bx, int16_t* ws) const {
  const int16_t* src =
      c.coefs.data() + (size_t(rows[2]) * c.bw + size_t(bx)) * 64;
  std::memcpy(ws, src, 64 * sizeof(int16_t));
  int dcv[5][5];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) {
      const int x = std::min(std::max(bx + j - 2, 0), c.wib - 1);
      dcv[i][j] = c.coefs[(size_t(rows[i]) * c.bw + size_t(x)) * 64];
    }
  const int64_t DC01 = dcv[0][0], DC02 = dcv[0][1], DC03 = dcv[0][2],
                DC04 = dcv[0][3], DC05 = dcv[0][4], DC06 = dcv[1][0],
                DC07 = dcv[1][1], DC08 = dcv[1][2], DC09 = dcv[1][3],
                DC10 = dcv[1][4], DC11 = dcv[2][0], DC12 = dcv[2][1],
                DC13 = dcv[2][2], DC14 = dcv[2][3], DC15 = dcv[2][4],
                DC16 = dcv[3][0], DC17 = dcv[3][1], DC18 = dcv[3][2],
                DC19 = dcv[3][3], DC20 = dcv[3][4], DC21 = dcv[4][0],
                DC22 = dcv[4][1], DC23 = dcv[4][2], DC24 = dcv[4][3],
                DC25 = dcv[4][4];
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t Q00 = c.qraw[0];
  // One estimate: the coefficient at natural position `pos` (zigzag `zz`)
  // from Q00 times the weighted DCs, clamped below 2^Al.
  auto estimate = [&](int zz, int pos, int64_t sum) {
    const int al = bits[zz];
    if (al == 0 || ws[pos] != 0) return;
    const int64_t q = c.qraw[pos];
    const int64_t num = Q00 * sum;
    int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = int16_t(num >= 0 ? pred : -pred);
  };
  estimate(1, 1, change_dc
      ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
            3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
            3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
            DC24 + DC25
      : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
  estimate(2, 8, change_dc
      ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
            38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
            13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
      : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
  estimate(3, 16, change_dc
      ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
            5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
      : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
  estimate(4, 9, change_dc
      ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
            DC25
      : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
            DC04 - DC06 + 10 * DC07 - 10 * DC09);
  estimate(5, 2, change_dc
      ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
            7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
      : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
  if (!change_dc) return;
  estimate(6, 3, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
  estimate(7, 10, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
  estimate(8, 17, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
  estimate(9, 24, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
  const int64_t num =
      Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
             6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
             8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
             6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
             2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
  const int pred = int(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
  ws[0] = int16_t(num >= 0 ? pred : -pred);
}

void Jpeg::output(uint8_t* rgb, bool cmyk) {
  std::vector<uint8_t> planes[4];
  const int imcu_rows = (height + 8 * maxv - 1) / (8 * maxv);
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comp[ci];
    const int stride = c.wib * 8;
    std::vector<uint8_t> samples(size_t(stride) * c.hib * 8);
    if (!smooth) {
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct_islow(c.block(by, bx), c.quant,
                     samples.data() + size_t(by) * 8 * stride + bx * 8,
                     stride);
    } else {
      // decompress_smooth_data walks iMCU rows, and numbers a block row
      // within the image by the rows of the iMCU row it is in (fewer in
      // the last one), which decides where the neighbours replicate.
      // Block rows below the last good iMCU row take the coefficients'
      // bits from before their last scan (jdcoefct.c, smoothing_ok's
      // prev_coef_bits_latch).
      int prev_bits[10];
      for (int k = 0; k < 10; ++k)
        prev_bits[k] = scans_read > 1 ? c.prev_bits[k] : -1;
      int16_t ws[64];
      for (int r = 0; r < imcu_rows; ++r) {
        const int* bits = r > last_good_imcu_row ? prev_bits : c.coef_bits;
        int block_rows = c.v;
        if (r == imcu_rows - 1 && c.hib % c.v) block_rows = c.hib % c.v;
        const int image_block_rows = block_rows * imcu_rows;
        for (int b = 0; b < block_rows; ++b) {
          const int row = r * c.v + b;
          const int ibr = r * block_rows + b;
          int rows[5];
          rows[2] = row;
          rows[1] = ibr > 0 ? row - 1 : row;
          rows[0] = ibr > 1 ? row - 2 : rows[1];
          rows[3] = ibr < image_block_rows - 1 ? row + 1 : row;
          rows[4] = ibr < image_block_rows - 2 ? row + 2 : rows[3];
          for (int bx = 0; bx < c.wib; ++bx) {
            smoothed_block(c, bits, rows, bx, ws);
            idct_islow(ws, c.quant,
                       samples.data() + size_t(row) * 8 * stride + bx * 8,
                       stride);
          }
        }
      }
    }
    planes[ci].resize(size_t(width) * height);
    upsample(samples.data(), stride, c.dw, c.dh, maxh / c.h, maxv / c.v,
             width, height, planes[ci].data());
  }
  const size_t n = size_t(width) * height;
  if (ncomp == 1) {
    const uint8_t* g = planes[0].data();
    for (size_t i = 0; i < n; ++i)
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
    return;
  }
  // jdcolor.c's tables: SCALEBITS 16, ONE_HALF folded into Cb_g.
  static const struct Tables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    Tables() {
      auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
        cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + 32768;
      }
    }
  } tab;
  // sample_range_limit: -384..639 clamped to 0..255.
  static const struct Clamp {
    uint8_t t[1024];
    Clamp() {
      for (int i = 0; i < 1024; ++i)
        t[i] = uint8_t(std::min(std::max(i - 384, 0), 255));
    }
  } range;
  const uint8_t* clamp_at = range.t + 384;
  auto clamp = [&](int v) { return clamp_at[v]; };
  const uint8_t* p0 = planes[0].data();
  const uint8_t* p1 = planes[1].data();
  const uint8_t* p2 = planes[2].data();
  // libjpeg's choice of colour space (jdapimin.c default_decompress_parms).
  if (ncomp == 3) {
    bool transform;
    if (jfif) {
      transform = true;
    } else if (adobe) {
      transform = adobe_transform != 0;
    } else {
      transform = !(comp[0].id == 'R' && comp[1].id == 'G' &&
                    comp[2].id == 'B');
    }
    if (!transform) {
      for (size_t i = 0; i < n; ++i) {
        rgb[3 * i] = p0[i];
        rgb[3 * i + 1] = p1[i];
        rgb[3 * i + 2] = p2[i];
      }
      return;
    }
    for (size_t i = 0; i < n; ++i) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      uint8_t* o = rgb + 3 * i;
      o[0] = clamp(y + tab.cr_r[cr]);
      o[1] = clamp(y + int((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
      o[2] = clamp(y + tab.cb_b[cb]);
    }
    return;
  }
  // Four components: CMYK, or YCCK under an Adobe marker with transform 2
  // (or any transform but 0).  PIL reads libjpeg's CMYK inverted ("CMYK;I")
  // and converts with nk = 255 - K, channel = nk - nk * C / 255.
  const bool ycck = adobe && adobe_transform != 0;
  const uint8_t* p3 = planes[3].data();
  auto muldiv255 = [](int a, int b) {
    const int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
  };
  for (size_t i = 0; i < n; ++i) {
    int cmy[3];
    if (ycck) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      cmy[0] = clamp(255 - (y + tab.cr_r[cr]));
      cmy[1] = clamp(255 - (y + int((tab.cb_g[cb] + tab.cr_g[cr]) >> 16)));
      cmy[2] = clamp(255 - (y + tab.cb_b[cb]));
    } else {
      cmy[0] = p0[i];
      cmy[1] = p1[i];
      cmy[2] = p2[i];
    }
    const int nk = p3[i];  // 255 - (255 - K)
    if (cmyk) {  // PIL's samples themselves
      for (int k = 0; k < 3; ++k) rgb[4 * i + k] = uint8_t(255 - cmy[k]);
      rgb[4 * i + 3] = uint8_t(255 - nk);
      continue;
    }
    for (int k = 0; k < 3; ++k)
      rgb[3 * i + k] = clamp(nk - muldiv255(255 - cmy[k], nk));
  }
}

}  // namespace

extern "C" {

// Height, width and component count of JPEG bytes from their header (the
// markers up to the first scan).  Returns 0, or a negative JpegCode.
int sn_jpeg_info_mem(const uint8_t* data, size_t size, int* h, int* w,
                     int* c) {
  try {
    Jpeg jpeg(data, size);
    jpeg.read_header();
    *h = jpeg.height;
    *w = jpeg.width;
    *c = jpeg.ncomp;
    return 0;
  } catch (const JpegError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kJpegMemory;
  }
}

// JPEG bytes -> (h, w, 3) uint8 RGB at `out`, or with `cmyk` set (a file
// of four components) the (h, w, 4) CMYK samples PIL reads ("CMYK;I"); h
// and w must be the file's (sn_jpeg_info_mem).  Returns 0, or a negative
// JpegCode; `out` is unspecified after an error.
int sn_decode_jpeg_mem(const uint8_t* data, size_t size, uint8_t* out, int h,
                       int w, int cmyk) {
  try {
    Jpeg jpeg(data, size);
    jpeg.read_header();
    jcheck(jpeg.height == h && jpeg.width == w && (!cmyk || jpeg.ncomp == 4));
    jpeg.decode_all();
    jpeg.output(out, cmyk != 0);
    return 0;
  } catch (const JpegError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kJpegMemory;
  }
}

}  // extern "C"
