// MPEG-4 Part 2 video (ISO/IEC 14496-2, Simple Profile) for the port's
// native host runtime (built into the same library as stereo_native.cc):
// the "mp4v" elementary stream the JAX package writes its context video
// with through OpenCV, encoded and decoded here.
//
// The encoder codes every frame as an I-VOP (intra only: no P-VOPs) at one
// quantiser per file, H.263 quantisation (quant_type 0):
//   * BGR uint8 -> BT.601 limited-range YCbCr, chroma 4:2:0 from the 2x2
//     average of RGB, each plane padded to whole macroblocks by edge
//     replication;
//   * an 8x8 DCT, the intra DC by the dc_scaler of Table 7-1 (rounded), the
//     AC coefficients by |F| / (2 QP) (truncated);
//   * per macroblock mcbpc (Table B-6), ac_pred_flag 0 and cbpy (B-8); per
//     block the DC difference to its gradient prediction (7.4.3) through
//     dct_dc_size (B-13, B-14), then the zigzag AC events through the intra
//     TCOEF table (B-16) with escape modes 1-3;
//   * VOS, VO and VOL headers (encoder_config) as libavcodec's mpeg4
//     encoder writes them: profile/level 1, rectangular shape,
//     vop_time_increment_resolution = fps, not interlaced, resync markers
//     off. The VOL is the decoder-specific info of the MP4's esds; each
//     sample is one VOP.
// Macroblock rows are transformed and quantised, then entropy coded, on
// worker threads (the DC prediction of a row reads the row above, so the
// two passes are separate); the rows' bit strings are then joined.
//
// The decoder reads exactly that: the VOL (refusing other shapes, interlace,
// sprites, MPEG quantisation, resync markers, data partitioning,
// scalability), then I-VOPs of mb_type 3 without AC prediction; P-, B- and
// S-VOPs, not-coded VOPs, dquant and AC prediction are refused with their
// own codes. Dequantisation as 7.4.4.1 (H.263), a separable float IDCT
// (IEEE 1180 conformant: tests/test_torch_video.py), and YCbCr back to BGR
// with each chroma sample on its 2x2 pixels, as libswscale's unscaled
// yuv420p converter does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

enum Mp4vCode {
  kMp4vTruncated = -1,     // the data ends inside a header or a macroblock
  kMp4vCorrupt = -2,       // an invalid VLC, a missing marker bit
  kMp4vNoVol = -3,         // no video object layer start code
  kMp4vShape = -4,         // a shape other than rectangular
  kMp4vInterlaced = -5,    // interlaced video
  kMp4vTool = -6,          // a tool beyond what the encoder writes
  kMp4vMpegQuant = -7,     // quant_type 1 (MPEG quantisation matrices)
  kMp4vNotIntra = -8,      // a P-, B- or S-VOP
  kMp4vNotCoded = -9,      // vop_coded 0
  kMp4vSize = -10,         // a frame of another size than the VOL's
  kMp4vMbTool = -11,       // dquant, AC prediction or intra_dc_vlc_thr
  kMp4vResources = -12,    // out of memory, or no thread could start
  kMp4vArgs = -13,         // odd or zero sizes, quantiser out of 1..31
  kMp4vNoVop = -14,        // no VOP start code in a sample
};

struct Vlc {
  uint16_t code;
  uint8_t len;
};

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Table B-16, intra TCOEF: entries 0-66 have last = 0, 67-101 last = 1.
const int kIntraEvents = 102;
const int kIntraLast0 = 67;
const Vlc kIntraVlc[kIntraEvents] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
    {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
    {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
    {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
    {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
    {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
    {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
    {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
    {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
    {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
    {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
    {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}};
const uint8_t kIntraRun[kIntraEvents] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
    0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,  2,  2,  2,  2,
    3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8,  8,  9,  9,  10,
    11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const uint8_t kIntraLevel[kIntraEvents] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3,
    4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1};
const Vlc kEscape = {0x3, 7};
const int kMaxTableLevel = 27;

// Table B-6, mcbpc of an I-VOP: mb_type 3 (cbpc 0-3), mb_type 4 (4-7),
// stuffing (8).
const Vlc kMcbpcIntra[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                            {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// Table B-8, cbpy of an intra macroblock (Y0 in the high bit).
const Vlc kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                       {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                       {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Tables B-13 and B-14, dct_dc_size of luminance and chrominance.
const Vlc kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                        {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                        {1, 9}, {1, 10}, {1, 11}};
const Vlc kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},
                          {1, 5}, {1, 6}, {1, 7}, {1, 8},  {1, 9},
                          {1, 10}, {1, 11}, {1, 12}};

// A prefix-code lookup on the next `bits` bits: the symbol and its length,
// or symbol -1 for bits that start no code.
struct Lookup {
  std::vector<int16_t> symbol;
  std::vector<uint8_t> len;
  int bits;
  Lookup(const Vlc* table, int n, int bits_) : bits(bits_) {
    symbol.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (int s = 0; s < n; ++s) {
      const int shift = bits - table[s].len;
      const uint32_t first = uint32_t(table[s].code) << shift;
      for (uint32_t i = 0; i < (1u << shift); ++i) {
        symbol[first + i] = int16_t(s);
        len[first + i] = table[s].len;
      }
    }
  }
};

struct Tables {
  int16_t event[2][64][kMaxTableLevel + 1];   // (last, run, level) -> entry
  uint8_t max_level[2][64];
  uint8_t max_run[2][kMaxTableLevel + 1];
  float dct[8][8];                            // dct[k][n], orthonormal
  Lookup tcoef, mcbpc, cbpy, dc_lum, dc_chrom;

  static std::vector<Vlc> with_escape() {
    std::vector<Vlc> v(kIntraVlc, kIntraVlc + kIntraEvents);
    v.push_back(kEscape);
    return v;
  }

  Tables()
      : tcoef(with_escape().data(), kIntraEvents + 1, 12),
        mcbpc(kMcbpcIntra, 9, 9),
        cbpy(kCbpy, 16, 6),
        dc_lum(kDcLum, 13, 12),
        dc_chrom(kDcChrom, 13, 12) {
    std::memset(event, -1, sizeof(event));
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    for (int i = 0; i < kIntraEvents; ++i) {
      const int last = i >= kIntraLast0, run = kIntraRun[i];
      const int level = kIntraLevel[i];
      event[last][run][level] = int16_t(i);
      max_level[last][run] = uint8_t(std::max<int>(max_level[last][run],
                                                   level));
      max_run[last][level] = uint8_t(std::max<int>(max_run[last][level],
                                                   run));
    }
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n)
        dct[k][n] = float((k ? 0.5 : std::sqrt(0.125)) *
                          std::cos((2 * n + 1) * k * M_PI / 16.0));
  }

  int lookup_event(int last, int run, int level) const {
    if (run > 63 || level > kMaxTableLevel) return -1;
    return event[last][run][level];
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int dc_scaler(int qp, bool luma) {
  if (qp <= 4) return 8;
  if (luma) return qp <= 8 ? 2 * qp : qp <= 24 ? qp + 8 : 2 * qp - 16;
  return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

int time_increment_bits(int resolution) {
  int bits = 1;
  while ((1 << bits) < resolution) ++bits;
  return bits;
}

// --- bits ------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int n = 0;   // bits in acc not yet written, < 8 between calls

  explicit BitWriter(std::vector<uint8_t>* o) : out(o) {}
  void put(uint32_t value, int bits) {   // bits <= 32
    acc = (acc << bits) | (value & ((bits == 32) ? 0xffffffffu
                                                 : ((1u << bits) - 1)));
    n += bits;
    while (n >= 8) {
      n -= 8;
      out->push_back(uint8_t(acc >> n));
    }
  }
  void put(const Vlc& v) { put(v.code, v.len); }
  size_t bit_count() const { return out->size() * 8 + n; }
  // next_start_code(): a zero bit, then ones up to the byte boundary.
  void stuffing() {
    put(0, 1);
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
  void start_code(uint32_t code) {
    put(0, 16);
    put(code, 16);
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;   // in bits; may pass the end (reads then give zeros)

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}
  uint32_t peek(int bits) const {   // bits <= 32
    uint64_t v = 0;
    const size_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i)
      v = (v << 8) | (byte + i < size ? data[byte + i] : 0);
    return uint32_t((v >> (40 - (pos & 7) - bits)) &
                    ((uint64_t(1) << bits) - 1));
  }
  uint32_t get(int bits) {
    const uint32_t v = peek(bits);
    pos += bits;
    return v;
  }
  bool overrun() const { return pos > size * 8; }
  int decode(const Lookup& t) {   // the symbol, or -1
    const uint32_t i = peek(t.bits);
    if (t.symbol[i] < 0) return -1;
    pos += t.len[i];
    return t.symbol[i];
  }
};

// --- transforms ------------------------------------------------------------

void aan_columns(float* d) {   // along the first index, 8 columns at once
  for (int k = 0; k < 8; ++k) {
    const float tmp0 = d[k] + d[56 + k], tmp7 = d[k] - d[56 + k];
    const float tmp1 = d[8 + k] + d[48 + k], tmp6 = d[8 + k] - d[48 + k];
    const float tmp2 = d[16 + k] + d[40 + k], tmp5 = d[16 + k] - d[40 + k];
    const float tmp3 = d[24 + k] + d[32 + k], tmp4 = d[24 + k] - d[32 + k];
    float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[k] = tmp10 + tmp11;
    d[32 + k] = tmp10 - tmp11;
    const float z1 = (tmp12 + tmp13) * 0.707106781f;
    d[16 + k] = tmp13 + z1;
    d[48 + k] = tmp13 - z1;
    tmp10 = tmp4 + tmp5;
    tmp11 = tmp5 + tmp6;
    tmp12 = tmp6 + tmp7;
    const float z5 = (tmp10 - tmp12) * 0.382683433f;
    const float z2 = 0.541196100f * tmp10 + z5;
    const float z4 = 1.306562965f * tmp12 + z5;
    const float z3 = tmp11 * 0.707106781f;
    const float z11 = tmp7 + z3, z13 = tmp7 - z3;
    d[40 + k] = z13 + z2;
    d[24 + k] = z13 - z2;
    d[8 + k] = z11 + z4;
    d[56 + k] = z11 - z4;
  }
}

void transpose8(float* d) {
  for (int i = 0; i < 8; ++i)
    for (int j = i + 1; j < 8; ++j) std::swap(d[i * 8 + j], d[j * 8 + i]);
}

// The forward DCT of Arai, Agui and Nakajima (libjpeg's jfdctflt.c), in
// place on data[y*8+x]: data[v*8+u] becomes the orthonormal coefficient
// F[v][u] times 8 aan[u] aan[v] (aan[0] = 1, aan[k] = sqrt(2) cos(k pi/16)),
// which the quantiser divides out. Both passes run down columns (the rows'
// between two transposes), where the compiler vectorises the butterfly.
void fdct_aan(float* data) {
  transpose8(data);
  aan_columns(data);
  transpose8(data);
  aan_columns(data);
}

// Separable inverse DCT in float, rounded to the nearest integer and
// clamped to [lo, hi].
void idct(const int* in, int* out, int lo, int hi) {
  const auto& a = tables().dct;
  float tmp[64];
  for (int v = 0; v < 8; ++v)
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int u = 0; u < 8; ++u) s += float(in[v * 8 + u]) * a[u][x];
      tmp[v * 8 + x] = s;
    }
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      float s = 0;
      for (int v = 0; v < 8; ++v) s += a[v][y] * tmp[v * 8 + x];
      const int r = int(std::lrint(s));
      out[y * 8 + x] = std::min(hi, std::max(lo, r));
    }
}

uint8_t clamp_u8(float v) {
  const int r = int(std::lrint(v));
  return uint8_t(std::min(255, std::max(0, r)));
}

// Runs fn(row) for rows 0..n-1 on up to `threads` threads; an exception
// of a worker is raised again here once every worker has ended.
template <class Fn>
void parallel_rows(int n, int threads, Fn fn) {
  threads = std::max(1, std::min(threads, n));
  if (threads == 1) {
    for (int r = 0; r < n; ++r) fn(r);
    return;
  }
  std::vector<std::exception_ptr> failed(threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      try {
        for (int r = t; r < n; r += threads) fn(r);
      } catch (...) {
        failed[t] = std::current_exception();
      }
    });
  for (auto& th : pool) th.join();
  for (auto& e : failed)
    if (e) std::rethrow_exception(e);
}

// --- DC prediction (7.4.3) --------------------------------------------------

// F (level times dc_scaler) of the block dx, dy blocks from block b of
// macroblock (mx, my) in b's plane (dx, dy in -1..0), from the quantised
// DC levels dc[mb][6] of a VOP mbw macroblocks wide; 1024 outside it.
int neighbour_f(const std::vector<int16_t>& dc, int mbw, int mx, int my,
                int b, int dx, int dy, int scale) {
  if (b >= 4) {
    const int x = mx + dx, y = my + dy;
    if (x < 0 || y < 0) return 1024;
    return dc[(size_t(y) * mbw + x) * 6 + b] * scale;
  }
  const int bx = 2 * mx + (b & 1) + dx, by = 2 * my + (b >> 1) + dy;
  if (bx < 0 || by < 0) return 1024;
  const size_t mb = size_t(by >> 1) * mbw + (bx >> 1);
  return dc[mb * 6 + (by & 1) * 2 + (bx & 1)] * scale;
}

// The DC level block b predicts: from the block above (C) where the
// gradient left (A) to above-left (B) is the smaller, else from A.
int predicted_dc(const std::vector<int16_t>& dc, int mbw, int mx, int my,
                 int b, int scale) {
  const int fa = neighbour_f(dc, mbw, mx, my, b, -1, 0, scale);
  const int fb = neighbour_f(dc, mbw, mx, my, b, -1, -1, scale);
  const int fc = neighbour_f(dc, mbw, mx, my, b, 0, -1, scale);
  const int pred = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
  return (pred + scale / 2) / scale;
}

// --- the encoder -----------------------------------------------------------

const size_t kMbBytes = 1536;

// A BGR uint8 frame as strides in bytes: `pixels` is its first pixel's
// blue byte, green and red follow `channel` bytes apart (negative for an
// RGB array read backwards), pixels `pixel` and rows `row` bytes apart.
struct Frame {
  const uint8_t* pixels;
  int64_t row, pixel, channel;
};

struct Encoder {
  int width, height, fps, qp, threads;
  int mbw, mbh;
  std::vector<int16_t> coef;          // [mb][6][64], natural order
  std::vector<uint8_t> cbp;           // [mb], bit 5 = block 0
  std::vector<int16_t> dc;            // [mb][6], quantised DC levels
  std::vector<std::vector<uint8_t>> rows;   // each MB row's bits
  std::vector<int> row_bits;
  std::vector<uint8_t> vop;
  std::vector<int64_t> column;   // byte offset of each padded column
  // What turns fdct_aan's outputs into levels: 1 / (8 aan[u] aan[v]) for
  // the DC, that over 2 QP for the AC (H.263 intra quantisation).
  float quant[64];

  Encoder(int w, int h, int f, int q, int t)
      : width(w), height(h), fps(f), qp(q), threads(t),
        mbw((w + 15) / 16), mbh((h + 15) / 16) {
    double aan[8] = {1.0};
    for (int k = 1; k < 8; ++k)
      aan[k] = std::sqrt(2.0) * std::cos(k * M_PI / 16);
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u)
        quant[v * 8 + u] = float(1.0 / (8.0 * aan[u] * aan[v]) /
                                 (v + u ? 2.0 * qp : 1.0));
    coef.resize(size_t(mbw) * mbh * 6 * 64);
    cbp.resize(size_t(mbw) * mbh);
    dc.resize(size_t(mbw) * mbh * 6);
    rows.resize(mbh);
    row_bits.resize(mbh);
    column.resize(size_t(mbw) * 16);
    // A macroblock codes to at most 11500 bits (every coefficient an
    // escape-3 event), so the row buffers never grow while threads fill
    // them.
    for (auto& r : rows) r.reserve(size_t(mbw) * kMbBytes);
    vop.reserve(size_t(mbw) * mbh * kMbBytes + 64);
  }

  // Pass 1 of a macroblock row: colour conversion, DCT and quantisation.
  void transform_row(const Frame& in, int my) {
    // The row's planes, edges replicated past the frame. BT.601 limited
    // range in 16.16 fixed point; chroma from the sum of each 2x2 of RGB.
    const int pw = mbw * 16, cw = mbw * 8;
    const int64_t g_at = in.channel, r_at = 2 * in.channel;
    std::vector<uint8_t> planes(size_t(16) * pw + size_t(16) * cw);
    uint8_t* yp = planes.data();
    uint8_t* up = yp + size_t(16) * pw;
    uint8_t* vp = up + size_t(8) * cw;
    for (int py = 0; py < 8; ++py) {
      const uint8_t* rows[2];
      for (int dy = 0; dy < 2; ++dy)
        rows[dy] = in.pixels +
                   std::min(height - 1, my * 16 + 2 * py + dy) * in.row;
      for (int px = 0; px < cw; ++px) {
        int sr = 0, sg = 0, sb = 0;
        for (int dy = 0; dy < 2; ++dy)
          for (int dx = 0; dx < 2; ++dx) {
            const uint8_t* p = rows[dy] + column[2 * px + dx];
            const int b = p[0], g = p[g_at], r = p[r_at];
            yp[size_t(2 * py + dy) * pw + 2 * px + dx] = uint8_t(
                (16829 * r + 33039 * g + 6416 * b + (16 << 16) + 32768) >> 16);
            sr += r;
            sg += g;
            sb += b;
          }
        const int u = (-9714 * sr - 19071 * sg + 28784 * sb + (257 << 17))
                      >> 18;
        const int v = (28784 * sr - 24103 * sg - 4681 * sb + (257 << 17))
                      >> 18;
        up[size_t(py) * cw + px] = uint8_t(std::min(255, std::max(0, u)));
        vp[size_t(py) * cw + px] = uint8_t(std::min(255, std::max(0, v)));
      }
    }
    const int scales[2] = {dc_scaler(qp, true), dc_scaler(qp, false)};
    float f[64];
    for (int mx = 0; mx < mbw; ++mx) {
      const size_t mb = size_t(my) * mbw + mx;
      uint8_t pattern = 0;
      for (int b = 0; b < 6; ++b) {
        const uint8_t* src;
        int src_stride;
        if (b < 4) {
          src = yp + size_t((b >> 1) * 8) * pw + mx * 16 + (b & 1) * 8;
          src_stride = pw;
        } else {
          src = (b == 4 ? up : vp) + mx * 8;
          src_stride = cw;
        }
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) f[y * 8 + x] = src[y * src_stride + x];
        fdct_aan(f);
        int16_t* out = &coef[(mb * 6 + b) * 64];
        const int scale = scales[b >= 4];
        const int level = int(f[0] * quant[0] / float(scale) + 0.5f);
        dc[mb * 6 + b] = int16_t(std::min(2047 / scale, std::max(0, level)));
        out[0] = 0;
        int any = 0;
        for (int i = 1; i < 64; ++i) {
          const int l = std::min(2047, int(std::fabs(f[i]) * quant[i]));
          out[i] = int16_t(f[i] < 0 ? -l : l);
          any |= l;
        }
        pattern |= uint8_t(any != 0) << (5 - b);
      }
      cbp[mb] = pattern;
    }
  }

  static void put_event(BitWriter& w, int last, int run, int level) {
    const Tables& t = tables();
    const int mag = std::abs(level), sign = level < 0;
    int e = t.lookup_event(last, run, mag);
    if (e >= 0) {
      w.put(kIntraVlc[e]);
      w.put(sign, 1);
      return;
    }
    const int level1 = mag - t.max_level[last][std::min(run, 63)];
    if (level1 > 0 && (e = t.lookup_event(last, run, level1)) >= 0) {
      w.put(kEscape);
      w.put(0, 1);
      w.put(kIntraVlc[e]);
      w.put(sign, 1);
      return;
    }
    if (mag <= kMaxTableLevel) {
      const int run1 = run - t.max_run[last][mag] - 1;
      if (run1 >= 0 && (e = t.lookup_event(last, run1, mag)) >= 0) {
        w.put(kEscape);
        w.put(2, 2);
        w.put(kIntraVlc[e]);
        w.put(sign, 1);
        return;
      }
    }
    w.put(kEscape);
    w.put(3, 2);
    w.put(last, 1);
    w.put(run, 6);
    w.put(1, 1);
    w.put(uint32_t(level) & 0xfff, 12);
    w.put(1, 1);
  }

  // Pass 2 of a macroblock row: its bits.
  void code_row(int my) {
    rows[my].clear();
    BitWriter w(&rows[my]);
    const int ys = dc_scaler(qp, true), cs = dc_scaler(qp, false);
    for (int mx = 0; mx < mbw; ++mx) {
      const size_t mb = size_t(my) * mbw + mx;
      const int pattern = cbp[mb];
      w.put(kMcbpcIntra[pattern & 3]);
      w.put(0, 1);                       // ac_pred_flag
      w.put(kCbpy[pattern >> 2]);
      for (int b = 0; b < 6; ++b) {
        const int scale = b < 4 ? ys : cs;
        const int diff =
            dc[mb * 6 + b] - predicted_dc(dc, mbw, mx, my, b, scale);
        const int mag = std::abs(diff);
        int size = 0;
        while ((1 << size) <= mag) ++size;
        w.put(b < 4 ? kDcLum[size] : kDcChrom[size]);
        if (size) {
          w.put(diff < 0 ? uint32_t(diff + (1 << size) - 1) : uint32_t(diff),
                size);
          if (size > 8) w.put(1, 1);     // marker bit
        }
        if (!(pattern >> (5 - b) & 1)) continue;
        const int16_t* c = &coef[(mb * 6 + b) * 64];
        int last_pos = 63;
        while (c[kZigzag[last_pos]] == 0) --last_pos;
        int run = 0;
        for (int i = 1; i <= last_pos; ++i) {
          const int level = c[kZigzag[i]];
          if (!level) {
            ++run;
            continue;
          }
          put_event(w, i == last_pos, run, level);
          run = 0;
        }
      }
    }
    row_bits[my] = int(w.bit_count());
    if (w.n) rows[my].push_back(uint8_t(w.acc << (8 - w.n)));
  }

  void encode(const Frame& in, int64_t index) {
    for (int x = 0; x < mbw * 16; ++x)
      column[x] = std::min(width - 1, x) * in.pixel;
    parallel_rows(mbh, threads, [&](int my) { transform_row(in, my); });
    parallel_rows(mbh, threads, [&](int my) { code_row(my); });
    vop.clear();
    BitWriter w(&vop);
    w.start_code(0x1b6);
    w.put(0, 2);                        // vop_coding_type I
    const int64_t seconds = index / fps;
    const int64_t previous = index > 0 ? (index - 1) / fps : 0;
    for (int64_t s = previous; s < seconds; ++s) w.put(1, 1);
    w.put(0, 1);                        // end of modulo_time_base
    w.put(1, 1);
    w.put(uint32_t(index % fps), time_increment_bits(fps));
    w.put(1, 1);
    w.put(1, 1);                        // vop_coded
    w.put(0, 3);                        // intra_dc_vlc_thr
    w.put(qp, 5);
    for (int my = 0; my < mbh; ++my) {
      const std::vector<uint8_t>& r = rows[my];
      const int full = row_bits[my] >> 3, rest = row_bits[my] & 7;
      for (int i = 0; i < full; ++i) w.put(r[i], 8);
      if (rest) w.put(r[full] >> (8 - rest), rest);
    }
    w.stuffing();
  }
};

// VOS, VO and VOL headers, as libavcodec's mpeg4 encoder writes them for
// the Simple Profile (without its user data).
std::vector<uint8_t> encoder_config(int width, int height, int fps) {
  std::vector<uint8_t> out;
  BitWriter w(&out);
  w.start_code(0x1b0);                  // visual_object_sequence
  w.put(1, 8);                          // profile_and_level: Simple L1
  w.start_code(0x1b5);                  // visual_object
  w.put(1, 1);                          // is_visual_object_identifier
  w.put(1, 4);                          // visual_object_verid
  w.put(1, 3);                          // visual_object_priority
  w.put(1, 4);                          // visual_object_type: video
  w.put(0, 1);                          // video_signal_type
  w.stuffing();
  w.start_code(0x100);                  // video_object 0
  w.start_code(0x120);                  // video_object_layer 0
  w.put(0, 1);                          // random_accessible_vol
  w.put(1, 8);                          // video_object_type: Simple
  w.put(1, 1);                          // is_object_layer_identifier
  w.put(1, 4);                          // video_object_layer_verid
  w.put(1, 3);                          // video_object_layer_priority
  w.put(1, 4);                          // aspect_ratio_info: square
  w.put(1, 1);                          // vol_control_parameters
  w.put(1, 2);                          // chroma_format 4:2:0
  w.put(1, 1);                          // low_delay
  w.put(0, 1);                          // vbv_parameters
  w.put(0, 2);                          // shape: rectangular
  w.put(1, 1);
  w.put(fps, 16);                       // vop_time_increment_resolution
  w.put(1, 1);
  w.put(0, 1);                          // fixed_vop_rate
  w.put(1, 1);
  w.put(width, 13);
  w.put(1, 1);
  w.put(height, 13);
  w.put(1, 1);
  w.put(0, 1);                          // interlaced
  w.put(1, 1);                          // obmc_disable
  w.put(0, 1);                          // sprite_enable
  w.put(0, 1);                          // not_8_bit
  w.put(0, 1);                          // quant_type: H.263
  w.put(1, 1);                          // complexity_estimation_disable
  w.put(1, 1);                          // resync_marker_disable
  w.put(0, 1);                          // data_partitioned
  w.put(0, 1);                          // scalability
  w.stuffing();
  return out;
}

// --- the decoder -----------------------------------------------------------

struct Vol {
  int width = 0, height = 0, resolution = 0;
};

bool marker(BitReader& r) { return r.get(1) == 1; }

int parse_vol(const uint8_t* d, size_t n, Vol* vol) {
  size_t i = 0;
  for (; i + 4 <= n; ++i)
    if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1 && (d[i + 3] >> 4) == 2)
      break;
  if (i + 4 > n) return kMp4vNoVol;
  BitReader r(d + i + 4, n - i - 4);
  r.get(1);                                    // random_accessible_vol
  if (r.get(8) != 1) return kMp4vTool;         // not the Simple type
  if (r.get(1)) {                              // is_object_layer_identifier
    if (r.get(4) != 1) return kMp4vTool;       // verid other than 1
    r.get(3);                                  // priority
  }
  if (r.get(4) == 15) r.get(16);               // extended PAR
  if (r.get(1)) {                              // vol_control_parameters
    if (r.get(2) != 1) return kMp4vTool;       // chroma other than 4:2:0
    r.get(1);                                  // low_delay
    if (r.get(1)) r.pos += 79;                 // vbv_parameters
  }
  if (r.get(2) != 0) return kMp4vShape;
  if (!marker(r)) return kMp4vCorrupt;
  const int resolution = int(r.get(16));
  if (!marker(r) || resolution == 0) return kMp4vCorrupt;
  if (r.get(1)) r.get(time_increment_bits(resolution));
  if (!marker(r)) return kMp4vCorrupt;
  const int width = int(r.get(13));
  if (!marker(r)) return kMp4vCorrupt;
  const int height = int(r.get(13));
  if (!marker(r)) return kMp4vCorrupt;
  if (r.get(1)) return kMp4vInterlaced;
  if (!r.get(1)) return kMp4vTool;             // OBMC
  if (r.get(1)) return kMp4vTool;              // sprites
  if (r.get(1)) return kMp4vTool;              // not 8 bits
  if (r.get(1)) return kMp4vMpegQuant;
  if (!r.get(1)) return kMp4vTool;             // complexity estimation
  if (!r.get(1)) return kMp4vTool;             // resync markers
  if (r.get(1)) return kMp4vTool;              // data partitioning
  if (r.get(1)) return kMp4vTool;              // scalability
  if (r.overrun()) return kMp4vTruncated;
  if (width == 0 || height == 0) return kMp4vCorrupt;
  vol->width = width;
  vol->height = height;
  vol->resolution = resolution;
  return 0;
}

struct Decoder {
  Vol vol;
  int mbw, mbh;
  std::vector<int16_t> coef;     // [mb][6][64] levels, DC un-predicted
  std::vector<int16_t> dc;       // [mb][6] DC levels, for the prediction
  std::vector<uint8_t> planes;   // Y (16 mbw x 16 mbh), Cb, Cr
  int qp = 0;

  explicit Decoder(const Vol& v)
      : vol(v), mbw((v.width + 15) / 16), mbh((v.height + 15) / 16) {
    coef.resize(size_t(mbw) * mbh * 6 * 64);
    dc.resize(size_t(mbw) * mbh * 6);
    planes.resize(size_t(mbw) * mbh * 384);
  }

  int block(BitReader& r, int mx, int my, int b, bool coded) {
    const Tables& t = tables();
    const bool luma = b < 4;
    const int scale = dc_scaler(qp, luma);
    const int size = r.decode(luma ? t.dc_lum : t.dc_chrom);
    if (size < 0) return kMp4vCorrupt;
    int diff = 0;
    if (size) {
      diff = int(r.get(size));
      if (!(diff >> (size - 1))) diff -= (1 << size) - 1;
      if (size > 8 && !marker(r)) return kMp4vCorrupt;
    }
    int level = predicted_dc(dc, mbw, mx, my, b, scale) + diff;
    // As the stored F of a DC is clipped to 0..2047 for later predictions.
    level = std::min(2047 / scale, std::max(0, level));
    const size_t at = (size_t(my) * mbw + mx) * 6 + b;
    dc[at] = int16_t(level);
    int16_t* c = &coef[at * 64];
    std::memset(c, 0, 64 * sizeof(int16_t));
    c[0] = int16_t(level);
    if (!coded) return 0;
    int i = 1;
    for (;;) {
      int e = r.decode(t.tcoef);
      if (e < 0) return kMp4vCorrupt;
      int last, run, lvl, sign;
      if (e < kIntraEvents) {
        last = e >= kIntraLast0;
        run = kIntraRun[e];
        lvl = kIntraLevel[e];
        sign = int(r.get(1));
      } else if (r.get(1) == 0) {                  // escape mode 1
        if ((e = r.decode(t.tcoef)) < 0 || e >= kIntraEvents)
          return kMp4vCorrupt;
        last = e >= kIntraLast0;
        run = kIntraRun[e];
        lvl = kIntraLevel[e] + t.max_level[last][run];
        sign = int(r.get(1));
      } else if (r.get(1) == 0) {                  // escape mode 2
        if ((e = r.decode(t.tcoef)) < 0 || e >= kIntraEvents)
          return kMp4vCorrupt;
        last = e >= kIntraLast0;
        lvl = kIntraLevel[e];
        run = kIntraRun[e] + t.max_run[last][lvl] + 1;
        sign = int(r.get(1));
      } else {                                     // escape mode 3
        last = int(r.get(1));
        run = int(r.get(6));
        if (!marker(r)) return kMp4vCorrupt;
        lvl = int(r.get(12));
        if (!marker(r)) return kMp4vCorrupt;
        if (lvl & 0x800) lvl -= 0x1000;
        if (lvl == 0 || lvl == -2048) return kMp4vCorrupt;
        sign = lvl < 0;
        lvl = std::abs(lvl);
      }
      i += run;
      if (i > 63) return kMp4vCorrupt;
      c[kZigzag[i]] = int16_t(sign ? -lvl : lvl);
      ++i;
      if (last) return 0;
      if (i > 63) return kMp4vCorrupt;
    }
  }

  int parse(const uint8_t* d, size_t n) {
    size_t i = 0;
    for (; i + 4 <= n; ++i)
      if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1 && d[i + 3] == 0xb6)
        break;
    if (i + 4 > n) return kMp4vNoVop;
    BitReader r(d + i + 4, n - i - 4);
    if (r.get(2) != 0) return kMp4vNotIntra;
    while (r.get(1))                               // modulo_time_base
      if (r.overrun()) return kMp4vTruncated;
    if (!marker(r)) return kMp4vCorrupt;
    r.get(time_increment_bits(vol.resolution));
    if (!marker(r)) return kMp4vCorrupt;
    if (!r.get(1)) return kMp4vNotCoded;
    if (r.get(3) != 0) return kMp4vMbTool;         // intra_dc_vlc_thr
    qp = int(r.get(5));
    if (qp == 0) return kMp4vCorrupt;
    const Tables& t = tables();
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        int mcbpc;
        while ((mcbpc = r.decode(t.mcbpc)) == 8)   // stuffing
          if (r.overrun()) return kMp4vTruncated;
        if (mcbpc < 0) return r.overrun() ? kMp4vTruncated : kMp4vCorrupt;
        if (mcbpc >= 4) return kMp4vMbTool;        // dquant
        if (r.get(1)) return kMp4vMbTool;          // ac_pred_flag
        const int cbpy = r.decode(t.cbpy);
        if (cbpy < 0) return r.overrun() ? kMp4vTruncated : kMp4vCorrupt;
        const int pattern = (cbpy << 2) | mcbpc;
        for (int b = 0; b < 6; ++b) {
          const int rc = block(r, mx, my, b, pattern >> (5 - b) & 1);
          if (r.overrun()) return kMp4vTruncated;
          if (rc) return rc;
        }
      }
    return r.overrun() ? kMp4vTruncated : 0;
  }

  // Dequantisation, IDCT and colour of one macroblock row into `bgr`.
  void reconstruct_row(int my, uint8_t* bgr) {
    const int pw = mbw * 16, cw = mbw * 8;
    uint8_t* yp = planes.data();
    uint8_t* cb_plane = yp + size_t(pw) * mbh * 16;
    uint8_t* cr_plane = cb_plane + size_t(cw) * mbh * 8;
    const int ys = dc_scaler(qp, true), cs = dc_scaler(qp, false);
    int f[64], px[64];
    for (int mx = 0; mx < mbw; ++mx) {
      const size_t mb = size_t(my) * mbw + mx;
      for (int b = 0; b < 6; ++b) {
        const int16_t* c = &coef[(mb * 6 + b) * 64];
        f[0] = c[0] * (b < 4 ? ys : cs);
        for (int k = 1; k < 64; ++k) {
          const int l = c[k];
          if (!l) {
            f[k] = 0;
            continue;
          }
          int m = qp * (2 * std::abs(l) + 1) - (qp % 2 == 0);
          m = l < 0 ? -m : m;
          f[k] = std::min(2047, std::max(-2048, m));
        }
        idct(f, px, 0, 255);
        uint8_t* dst;
        int stride;
        if (b < 4) {
          stride = pw;
          dst = yp + size_t(my * 16 + (b >> 1) * 8) * pw + mx * 16 +
                (b & 1) * 8;
        } else {
          stride = cw;
          dst = (b == 4 ? cb_plane : cr_plane) + size_t(my * 8) * cw +
                mx * 8;
        }
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            dst[size_t(y) * stride + x] = uint8_t(px[y * 8 + x]);
      }
    }
    const int y_end = std::min(vol.height, my * 16 + 16);
    for (int y = my * 16; y < y_end; ++y) {
      const uint8_t* yr = yp + size_t(y) * pw;
      const uint8_t* ur = cb_plane + size_t(y / 2) * cw;
      const uint8_t* vr = cr_plane + size_t(y / 2) * cw;
      uint8_t* out = bgr + size_t(y) * vol.width * 3;
      for (int x = 0; x < vol.width; ++x) {
        const float l = 1.164383f * (float(yr[x]) - 16.f);
        const float u = float(ur[x / 2]) - 128.f;
        const float v = float(vr[x / 2]) - 128.f;
        out[3 * x + 0] = clamp_u8(l + 2.017232f * u);
        out[3 * x + 1] = clamp_u8(l - 0.391762f * u - 0.812968f * v);
        out[3 * x + 2] = clamp_u8(l + 1.596027f * v);
      }
    }
  }
};

}  // namespace

extern "C" {

// The decoder-specific info (VOS, VO, VOL) of a width x height stream at
// `fps`: its length, written to `out` when it fits in `cap` bytes, or a
// negative Mp4vCode.
int sn_mp4v_config(int width, int height, int fps, uint8_t* out, int cap) {
  if (width <= 0 || height <= 0 || width > 8190 || height > 8190 ||
      (width | height) & 1 || fps <= 0 || fps > 65535)
    return kMp4vArgs;
  const std::vector<uint8_t> config = encoder_config(width, height, fps);
  if (int(config.size()) <= cap) std::memcpy(out, config.data(),
                                             config.size());
  return int(config.size());
}

// An encoder of even width x height frames at `fps` and quantiser `qp`
// (1-31), on up to `threads` threads; null with `*error` set to a
// negative Mp4vCode for arguments it refuses or out of memory.
void* sn_mp4v_encoder_create(int width, int height, int fps, int qp,
                             int threads, int* error) {
  *error = kMp4vArgs;
  if (width <= 0 || height <= 0 || width > 8190 || height > 8190 ||
      (width | height) & 1 || fps <= 0 || fps > 65535 || qp < 1 || qp > 31)
    return nullptr;
  *error = kMp4vResources;
  try {
    tables();
    Encoder* e = new Encoder(width, height, fps, qp, std::max(1, threads));
    *error = 0;
    return e;
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

// Encodes one BGR uint8 frame of the encoder's size, given by its strides
// in bytes (Frame), as the I-VOP of frame `index`. Returns the VOP's
// length in bytes (read it with sn_mp4v_encoder_output), or a negative
// Mp4vCode.
int64_t sn_mp4v_encoder_encode(void* handle, const uint8_t* pixels,
                               int64_t row, int64_t pixel, int64_t channel,
                               int64_t index) {
  Encoder* e = static_cast<Encoder*>(handle);
  if (index < 0) return kMp4vArgs;
  try {
    e->encode(Frame{pixels, row, pixel, channel}, index);
  } catch (const std::bad_alloc&) {
    return kMp4vResources;
  } catch (const std::system_error&) {
    return kMp4vResources;
  }
  return int64_t(e->vop.size());
}

// The bytes of the last VOP encoded.
const uint8_t* sn_mp4v_encoder_output(void* handle) {
  return static_cast<Encoder*>(handle)->vop.data();
}

void sn_mp4v_encoder_destroy(void* handle) {
  delete static_cast<Encoder*>(handle);
}

// Width, height and vop_time_increment_resolution from the VOL in `data`
// (a decoder-specific info). Returns 0 or a negative Mp4vCode.
int sn_mp4v_vol_info(const uint8_t* data, size_t n, int* width, int* height,
                     int* resolution) {
  Vol vol;
  const int rc = parse_vol(data, n, &vol);
  if (rc) return rc;
  *width = vol.width;
  *height = vol.height;
  *resolution = vol.resolution;
  return 0;
}

// Decodes one VOP of the stream whose VOL is in `config` into `bgr`
// (height x width x 3 uint8, the VOL's size), reconstructing on up to
// `threads` threads. Returns 0 or a negative Mp4vCode.
int sn_mp4v_decode(const uint8_t* config, size_t config_n,
                   const uint8_t* data, size_t n, uint8_t* bgr, int threads) {
  Vol vol;
  int rc = parse_vol(config, config_n, &vol);
  if (rc) return rc;
  try {
    Decoder d(vol);
    if ((rc = d.parse(data, n))) return rc;
    parallel_rows(d.mbh, threads,
                  [&](int my) { d.reconstruct_row(my, bgr); });
  } catch (const std::bad_alloc&) {
    return kMp4vResources;
  } catch (const std::system_error&) {
    return kMp4vResources;
  }
  return 0;
}

// The 8x8 inverse DCT of the decoder on `n` blocks of int32 coefficients
// (natural order), each output clamped to [lo, hi]: what IEEE 1180 tests.
void sn_mp4v_idct(const int* in, int* out, int n, int lo, int hi) {
  for (int i = 0; i < n; ++i) idct(in + 64 * i, out + 64 * i, lo, hi);
}

}  // extern "C"
