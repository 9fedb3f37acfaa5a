// WebP decoding for the port's native host runtime (built into the same
// library as stereo_native.cc).
//
// The decoder gives the pixels of PIL's Image.open(f) (Pillow 12.1, which
// decodes every WebP through libwebp's WebPAnimDecoder) for every file PIL
// opens, and refuses the files PIL refuses:
//
//   * the RIFF container as libwebp's demuxer reads it: simple files (one
//     "VP8 " or "VP8L" chunk) and extended ones ("VP8X": ALPH, ICCP, EXIF,
//     XMP and unknown chunks, ANIM and ANMF), with the demuxer's checks of
//     chunk sizes, frame bounds and chunk order;
//   * an animation's first frame, placed at its offset on a canvas that is
//     transparent black elsewhere, as WebPAnimDecoder composes a first
//     frame (the ANIM background colour is not used, as it does not use it);
//   * VP8L (lossless): Huffman codes, the meta-Huffman entropy image, the
//     colour cache, LZ77 with the 120 two-dimensional distance codes, and
//     the predictor, cross-colour, subtract-green and colour-indexing
//     transforms;
//   * VP8 (lossy, keyframes): the boolean decoder, segments, 1-8 token
//     partitions, the intra predictors, the inverse WHT and DCT, the simple
//     and normal loop filters; then libwebp's fancy upsampling of the 4:2:0
//     chroma and its 14-bit fixed-point YUV -> RGB;
//   * ALPH: raw or VP8L-compressed alpha, its three filters (dithering off,
//     as PIL leaves it), never premultiplied.
//
// The mode is PIL's: "RGBA" when libwebp's WebPGetFeatures says the file
// has alpha (or cannot say), else "RGB".  EXIF orientation is not applied
// (PIL does not apply it to WebP).  Canvases over 178956970 pixels (PIL's
// decompression-bomb limit) are refused before anything is allocated.
// Every length read from the file is checked before it is used.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

enum WebpCode {
  kTruncated = -1,     // the data ends before the RIFF size or a chunk does
  kCorrupt = -2,       // a container or bitstream libwebp refuses
  kNotWebp = -3,       // no RIFF....WEBP signature
  kTooLarge = -4,      // over PIL's decompression-bomb limit
  kMemory = -5,        // out of memory
  kNotKeyframe = -6,   // a VP8 frame that is not a displayable keyframe
};

struct WebpError {
  int code;
};

[[noreturn]] void fail(int code) { throw WebpError{code}; }

constexpr uint64_t kMaxPixels = 178956970;       // PIL's MAX_IMAGE_PIXELS
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = 1ull << 32;    // libwebp's MAX_IMAGE_AREA

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (uint32_t(p[3]) << 24);
}

// ---------------------------------------------------------------------------
// VP8L (lossless)

// Bits of a VP8L stream, least significant first, read as libwebp's
// VP8LBitReader reads them: a 64-bit window, bits past the data read as
// zeros (or, at a position of exactly 64, as the window wrapped), and an
// end-of-stream flag that rises once more bits were consumed than the
// data holds, whereupon the position restarts at 0.  The decoder fails on
// that flag wherever libwebp does.
class LBits {
 public:
  LBits(const uint8_t* data, size_t size) : data_(data), size_(size) {
    for (; pos_ < size_ && pos_ < 8; ++pos_)
      value_ |= uint64_t(data_[pos_]) << (8 * pos_);
  }
  uint32_t prefetch() const { return uint32_t(value_ >> (bit_pos_ & 63)); }
  void set_bit_pos(int pos) { bit_pos_ = pos; }
  int bit_pos() const { return bit_pos_; }
  uint32_t read(int n) {
    if (eos_ || n > 24) {
      set_eos();
      return 0;
    }
    const uint32_t v = prefetch() & ((1u << n) - 1);
    bit_pos_ += n;
    shift_bytes();
    return v;
  }
  // libwebp's VP8LFillBitWindow.
  void fill() {
    if (bit_pos_ >= 32) shift_bytes();
  }
  bool at_end() const { return eos_ || (pos_ == size_ && bit_pos_ > 64); }
  // The flag as libwebp sets it at its checks (VP8LIsEndOfStream).
  bool update_eos() { return eos_ = at_end(); }
  bool eos() const { return eos_; }

 private:
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  void shift_bytes() {
    while (bit_pos_ >= 8 && pos_ < size_) {
      value_ = (value_ >> 8) | (uint64_t(data_[pos_++]) << 56);
      bit_pos_ -= 8;
    }
    if (at_end()) set_eos();
  }
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint64_t value_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

// A canonical prefix code, as libwebp builds it: one used symbol is a code
// of no bits (whatever its length); otherwise the lengths must make a
// complete code.
class Huffman {
 public:
  static constexpr int kRoot = 8;

  // lengths[0..n); returns false where libwebp's table builder refuses.
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int used = 0, last = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = s;
      }
    }
    if (used == 0) return false;
    single_ = -1;
    if (used == 1) {
      single_ = last;
      return true;
    }
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = 2 * open - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    int offset[17] = {0};
    for (int len = 1; len <= 15; ++len) {
      offset[len + 1] = offset[len] + count[len];
      count_[len] = uint16_t(count[len]);
    }
    sorted_.assign(used, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted_[offset[lengths[s]]++] = uint16_t(s);
    std::memset(root_, 0, sizeof(root_));
    int code = 0, index = 0;
    for (int len = 1; len <= 15; ++len, code <<= 1) {
      for (int k = 0; k < count[len]; ++k, ++code, ++index) {
        if (len > kRoot) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int i = rev; i < (1 << kRoot); i += 1 << len)
          root_[i] = uint16_t((len << 12) | sorted_[index]);
      }
    }
    return true;
  }

  // One symbol, as libwebp's ReadSymbol reads it: the first 8 bits from
  // one window read, the rest of a longer code from a second read 8 bits
  // on.
  int decode(LBits& br) const {
    if (single_ >= 0) return single_;
    const uint32_t first8 = br.prefetch() & 0xff;
    const uint16_t e = root_[first8];
    if (e) {
      br.set_bit_pos(br.bit_pos() + (e >> 12));
      return e & 0xfff;
    }
    br.set_bit_pos(br.bit_pos() + kRoot);
    const uint32_t bits = first8 | ((br.prefetch() & 0x7f) << kRoot);
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int n = count_[len];
      if (code - first < n) {
        br.set_bit_pos(br.bit_pos() + len - kRoot);
        return sorted_[index + code - first];
      }
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    fail(kCorrupt);   // not reached: a complete code has every prefix
  }

  bool single() const { return single_ >= 0; }

 private:
  int single_ = -1;
  uint16_t root_[1 << kRoot];
  uint16_t count_[16] = {0};
  std::vector<uint16_t> sorted_;
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// The 120 two-dimensional distance codes of the lossless format: (dx, dy),
// a distance of dx + dy * xsize.
constexpr int8_t kDistanceOffsets[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1},
    {-2, 1}, {2, 2}, {-2, 2}, {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1},
    {-3, 1}, {2, 3}, {-2, 3}, {3, 2}, {-3, 2}, {0, 4}, {4, 0}, {1, 4},
    {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3}, {2, 4}, {-2, 4}, {4, 2},
    {-4, 2}, {0, 5}, {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0}, {1, 5},
    {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2}, {4, 4},
    {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0}, {1, 6},
    {-1, 6}, {6, 1}, {-6, 1}, {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5},
    {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6}, {6, 3}, {-6, 3}, {0, 7},
    {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1}, {4, 6},
    {-4, 6}, {6, 4}, {-6, 4}, {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7},
    {-3, 7}, {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5}, {8, 0},
    {4, 7}, {-4, 7}, {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3},
    {5, 7}, {-5, 7}, {7, 5}, {-7, 5}, {8, 4}, {6, 7}, {-6, 7}, {7, 6},
    {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7}};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                  int((c2 >> s) & 0xff);
    out |= clip255(uint32_t(v)) << s;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= clip255(uint32_t(a + (a - b) / 2)) << s;
  }
  return out;
}

// Predictor `mode` for the pixel at `out` (left is out[-1], top is
// out[-width]).
inline uint32_t predict(int mode, const uint32_t* out, int width) {
  const uint32_t* top = out - width;
  const uint32_t left = out[-1];
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return add_sub_full(left, top[0], top[-1]);
    case 13: return add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;   // 0, and 14 and 15 as libwebp reads them
  }
}

enum TransformType { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2,
                     kColorIndexing = 3 };

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

class VP8LDecoder {
 public:
  VP8LDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  // The 5-byte header: signature, width, height, alpha bit, version.
  void header(int* w, int* h, int* alpha) {
    if (br_.read(8) != 0x2f) fail(kCorrupt);
    *w = int(br_.read(14)) + 1;
    *h = int(br_.read(14)) + 1;
    *alpha = int(br_.read(1));
    if (br_.read(3) != 0 || br_.eos()) fail(kCorrupt);
  }

  // The coding tools the stream used: bits 0-3 its transforms (predictor,
  // cross-colour, subtract-green, colour indexing), bit 4 a colour cache,
  // bit 5 a meta-Huffman image.
  int coding() const { return seen_ | tools_; }

  // The ARGB pixels of a (width, height) level-0 image: transforms, then
  // the entropy-coded image, then the transforms undone.  An ALPH chunk's
  // stream (`alpha`) may take libwebp's 8-bit alpha path.
  std::vector<uint32_t> image(int width, int height, bool alpha = false) {
    int xsize = width;
    while (br_.read(1)) read_transform(&xsize, height);
    std::vector<uint32_t> pixels = stream(xsize, height, true, alpha);
    for (int i = int(transforms_.size()) - 1; i >= 0; --i)
      pixels = inverse(transforms_[i], pixels);
    return pixels;
  }

 private:
  struct Group {
    Huffman tree[5];   // green (+ lengths + cache), red, blue, alpha, distance
  };

  void read_transform(int* xsize, int ysize) {
    const int type = int(br_.read(2));
    if (seen_ & (1 << type)) fail(kCorrupt);
    seen_ |= 1 << type;
    Transform t{type, 0, *xsize, ysize, {}};
    if (type == kPredictor || type == kCrossColor) {
      t.bits = 2 + int(br_.read(3));
      t.data = stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits),
                      false);
    } else if (type == kColorIndexing) {
      const int colors = int(br_.read(8)) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> palette = stream(colors, 1, false);
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      t.data[0] = palette[0];
      for (int i = 1; i < colors; ++i)
        t.data[i] = add_pixels(palette[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
  }

  // One prefix code of `alphabet` symbols; false where libwebp refuses it.
  bool read_code(int alphabet, std::vector<int>& lengths, Huffman* out) {
    std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
    if (br_.read(1)) {   // simple code: one or two symbols of 1 or 8 bits
      const int symbols = int(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (symbols == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int n = int(br_.read(4)) + 4;
      for (int i = 0; i < n; ++i) cl_lengths[kCodeLengthOrder[i]] =
          int(br_.read(3));
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) return false;
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * int(br_.read(3));
        max_symbol = 2 + int(br_.read(nbits));
        if (max_symbol > alphabet) return false;
      }
      int prev = 8;
      for (int s = 0; s < alphabet;) {
        if (max_symbol-- == 0) break;
        br_.fill();
        const int code = cl.decode(br_);
        if (code < 16) {
          lengths[s++] = code;
          if (code) prev = code;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = int(br_.read(kExtra[code - 16])) + kOffset[code - 16];
          if (s + repeat > alphabet) return false;
          const int len = code == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = len;
        }
      }
    }
    if (br_.eos()) return false;
    Huffman scratch;
    return (out ? out : &scratch)->build(lengths.data(), alphabet);
  }

  static int copy_length(int symbol, LBits& br) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br.read(extra)) + 1;
  }

  // An entropy-coded image of (xsize, ysize) ARGB pixels: level 0 may have
  // a meta-Huffman image; sub-images (transform data, the meta image) not.
  // The stream must not run past its data, but for libwebp's 8-bit alpha
  // path (an ALPH stream whose one transform is a palette, with no colour
  // cache and red, blue and alpha codes of one symbol each), which reads
  // past it on the last pixels, as libwebp's DecodeAlphaData does.
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0,
                               bool alpha = false) {
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = int(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail(kCorrupt);
      tools_ |= 1 << 4;
    }
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int groups_max = 1;
    if (level0 && br_.read(1)) {
      tools_ |= 1 << 5;
      meta_bits = 2 + int(br_.read(3));
      meta_xsize = subsample(xsize, meta_bits);
      meta = stream(meta_xsize, subsample(ysize, meta_bits), false);
      groups_max = 0;
      for (uint32_t& p : meta) {
        p = (p >> 8) & 0xffff;
        groups_max = std::max(groups_max, int(p) + 1);
      }
    }
    // Only the groups the meta image names are kept; the others are read
    // and checked, as libwebp reads them.
    std::vector<int> slot(groups_max, -1);
    int groups = 0;
    if (meta.empty()) {
      slot[0] = groups++;
    } else {
      for (uint32_t p : meta)
        if (slot[p] < 0) slot[p] = groups++;
    }
    std::vector<Group> table(groups);
    const int alphabet[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0),
                             256, 256, 256, 40};
    std::vector<int> lengths(256 + 24 + (1 << 11), 0);
    // Whether the red, blue and alpha codes are one symbol each, in the
    // groups libwebp keeps (all of them, unless there are over 1000 or more
    // than pixels, when it keeps the used ones).
    const bool keeps_all = groups_max <= 1000 &&
                           int64_t(groups_max) <= int64_t(xsize) * ysize;
    bool rba_single = true;
    for (int g = 0; g < groups_max; ++g) {
      Huffman unused;
      for (int j = 0; j < 5; ++j) {
        Huffman* tree = slot[g] >= 0 ? &table[slot[g]].tree[j] : &unused;
        if (!read_code(alphabet[j], lengths, tree)) fail(kCorrupt);
        if (j >= 1 && j <= 3 && (slot[g] >= 0 || keeps_all) &&
            !tree->single())
          rba_single = false;
      }
    }
    if (!meta.empty())
      for (uint32_t& p : meta) p = uint32_t(slot[p]);
    const bool alpha_8b = alpha && level0 && transforms_.size() == 1 &&
                          transforms_[0].type == kColorIndexing &&
                          cache_bits == 0 && rba_single;

    const size_t total = size_t(xsize) * ysize;
    std::vector<uint32_t> data(total);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    const int mask = meta.empty() ? 0 : (1 << meta_bits) - 1;
    const Group* group = &table[0];
    while (pos < total && !(alpha_8b && br_.eos())) {
      if (!meta.empty() && (col & mask) == 0)
        group = &table[meta[size_t(row >> meta_bits) * meta_xsize +
                            (col >> meta_bits)]];
      br_.fill();
      const int code = group->tree[0].decode(br_);
      if (code < 256) {
        const uint32_t red = uint32_t(group->tree[1].decode(br_));
        br_.fill();
        const uint32_t blue = uint32_t(group->tree[2].decode(br_));
        const uint32_t alpha = uint32_t(group->tree[3].decode(br_));
        data[pos++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) |
                      blue;
        if (++col >= xsize) {
          col = 0;
          ++row;
        }
      } else if (code < 256 + 24) {
        const int length = copy_length(code - 256, br_);
        const int dist_symbol = group->tree[4].decode(br_);
        br_.fill();
        const int plane = copy_length(dist_symbol, br_);
        size_t dist;
        if (plane > 120) {
          dist = size_t(plane - 120);
        } else {
          const int8_t* o = kDistanceOffsets[plane - 1];
          const long d = long(o[1]) * xsize + o[0];
          dist = d >= 1 ? size_t(d) : 1;
        }
        if (!alpha_8b && br_.at_end()) fail(kCorrupt);
        if (pos < dist || total - pos < size_t(length)) fail(kCorrupt);
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= xsize) {
          col -= xsize;
          ++row;
        }
        if ((col & mask) && pos < total)
          group = &table[meta[size_t(row >> meta_bits) * meta_xsize +
                              (col >> meta_bits)]];
      } else {
        if (cache.empty()) fail(kCorrupt);
        flush_cache(data, pos, &cached, &cache, cache_shift);
        data[pos++] = cache[code - 256 - 24];
        if (++col >= xsize) {
          col = 0;
          ++row;
        }
      }
      if (alpha_8b) {
        br_.update_eos();
      } else if (br_.at_end()) {
        fail(kCorrupt);
      }
      if (!cache.empty()) flush_cache(data, pos, &cached, &cache, cache_shift);
    }
    if (br_.update_eos() && (!alpha_8b || pos < total)) fail(kCorrupt);
    return data;
  }

  static void flush_cache(const std::vector<uint32_t>& data, size_t pos,
                          size_t* cached, std::vector<uint32_t>* cache,
                          int shift) {
    for (; *cached < pos; ++*cached)
      (*cache)[(0x1e35a7bdu * data[*cached]) >> shift] = data[*cached];
  }

  static std::vector<uint32_t> inverse(const Transform& t,
                                       const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out(size_t(w) * h);
    if (t.type == kSubtractGreen) {
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t p = in[i], g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        out[i] = (p & 0xff00ff00u) | rb;
      }
    } else if (t.type == kPredictor) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = in.data() + size_t(y) * w;
        uint32_t* dst = out.data() + size_t(y) * w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : dst[x - 1];
          } else if (x == 0) {
            pred = dst[-w];
          } else {
            const int mode = (t.data[size_t(y >> t.bits) * tiles +
                                     (x >> t.bits)] >> 8) & 0xf;
            pred = predict(mode, dst + x, w);
          }
          dst[x] = add_pixels(src[x], pred);
        }
      }
    } else if (t.type == kCrossColor) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[size_t(y >> t.bits) * tiles +
                                    (x >> t.bits)];
          const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                       r2b = int8_t((m >> 16) & 0xff);
          const uint32_t p = in[size_t(y) * w + x];
          const int8_t green = int8_t((p >> 8) & 0xff);
          int red = int((p >> 16) & 0xff);
          int blue = int(p & 0xff);
          red += (int(g2r) * green) >> 5;
          red &= 0xff;
          blue += (int(g2b) * green) >> 5;
          blue += (int(r2b) * int8_t(red)) >> 5;
          blue &= 0xff;
          out[size_t(y) * w + x] = (p & 0xff00ff00u) | (uint32_t(red) << 16) |
                                   uint32_t(blue);
        }
      }
    } else {   // colour indexing, pixels bundled 1 << bits to a byte
      const int packed = subsample(w, t.bits);
      const int bits_per_pixel = 8 >> t.bits;
      const uint32_t index_mask = (1u << bits_per_pixel) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = in.data() + size_t(y) * packed;
        uint32_t* dst = out.data() + size_t(y) * w;
        for (int x = 0; x < w; ++x) {
          const uint32_t byte = (src[x >> t.bits] >> 8) & 0xff;
          const int shift = (x & ((1 << t.bits) - 1)) * bits_per_pixel;
          dst[x] = t.data[(byte >> shift) & index_mask];
        }
      }
    }
    return out;
  }

  LBits br_;
  int seen_ = 0, tools_ = 0;
  std::vector<Transform> transforms_;
};

// ---------------------------------------------------------------------------
// VP8 (lossy keyframes)

// The boolean decoder, loading a byte at a time as libwebp does, so that
// its end-of-data flag rises where libwebp's does.
class BoolDecoder {
 public:
  BoolDecoder() = default;
  BoolDecoder(const uint8_t* data, size_t size)
      : buf_(data), end_(data + size), eof_(size == 0) {}

  int bit(int prob) {
    if (bits_ < 0) load();
    const uint32_t split = (range_ * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value_ >> bits_);
    int b;
    if (v > split) {
      range_ -= split + 1;
      value_ -= uint64_t(split + 1) << bits_;
      b = 1;
    } else {
      range_ = split;
      b = 0;
    }
    // range_ is the range less one; renormalise the range to 128..255.
    const int shift = 7 - (31 - __builtin_clz(range_ + 1));
    range_ = ((range_ + 1) << shift) - 1;
    bits_ -= shift;
    return b;
  }
  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value(n);
    return bit(0x80) ? -v : v;
  }
  int flag() { return bit(0x80); }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (buf_ < end_) {
      value_ = (value_ << 8) | *buf_++;
      bits_ += 8;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = -8;
  uint32_t range_ = 254;
  bool eof_ = true;
};

// RFC 6386's tables.
constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};

constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};

// Default coefficient probabilities [type][band][context][node].
constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

// The probabilities that a coefficient probability is updated.
constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

// The 4x4 intra modes, in RFC 6386's order.
enum BMode { B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED,
             B_RD_PRED, B_VR_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
// The 16x16 and chroma modes, numbered as the 4x4 modes they imply.
constexpr int DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED,
              H_PRED = B_HE_PRED;

constexpr int8_t kBModeTree[18] = {
    -B_DC_PRED, 2,                  // "0"
    -B_TM_PRED, 4,                  // "10"
    -B_VE_PRED, 6,                  // "110"
    8, 12,
    -B_HE_PRED, 10,                 // "11100"
    -B_RD_PRED, -B_VR_PRED,         // "111010", "111011"
    -B_LD_PRED, 14,                 // "111101"
    -B_VL_PRED, 16,                 // "1111100"
    -B_HD_PRED, -B_HU_PRED};        // "11111010", "11111011"

// Keyframe 4x4 mode probabilities [above][left][node].
constexpr uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                             153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// The inverse DCT of one 4x4 block, added to the prediction at `dst`.
void transform(const int16_t* in, uint8_t* dst, int stride) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {   // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {   // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks (out[16 * i]).
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// Intra prediction in a work buffer of stride kBps, where dst[-1] is the
// left column, dst[-kBps] the row above and dst[-kBps - 1] the corner.
constexpr int kBps = 32;

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; ++y, dst += kBps)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, v, size);
}

// 16x16 (size 16) and chroma (size 8) prediction; DC by which edges exist.
void predict_block(uint8_t* dst, int size, int mode, bool has_top,
                   bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - kBps] + dst[i * kBps - 1];
        fill(dst, size, (dc + size) >> (shift + 1));
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - kBps];
        fill(dst, size, (dc + size / 2) >> shift);
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i * kBps - 1];
        fill(dst, size, (dc + size / 2) >> shift);
      } else {
        fill(dst, size, 0x80);
      }
      break;
    }
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y)
        std::memcpy(dst + y * kBps, dst - kBps, size);
      break;
    default:   // H_PRED
      for (int y = 0; y < size; ++y)
        std::memset(dst + y * kBps, dst[y * kBps - 1], size);
      break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3],
            E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[kBps - 1], K = dst[2 * kBps - 1],
            L = dst[3 * kBps - 1];
  auto at = [&](int x, int y) -> uint8_t& { return dst[x + y * kBps]; };
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * kBps - 1];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * kBps, v, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + kBps, avg3(I, J, K), 4);
      std::memset(dst + 2 * kBps, avg3(J, K, L), 4);
      std::memset(dst + 3 * kBps, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      at(0, 3) = avg3(J, K, L);
      at(1, 3) = at(0, 2) = avg3(I, J, K);
      at(2, 3) = at(1, 2) = at(0, 1) = avg3(X, I, J);
      at(3, 3) = at(2, 2) = at(1, 1) = at(0, 0) = avg3(A, X, I);
      at(3, 2) = at(2, 1) = at(1, 0) = avg3(B, A, X);
      at(3, 1) = at(2, 0) = avg3(C, B, A);
      at(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      at(0, 0) = avg3(A, B, C);
      at(1, 0) = at(0, 1) = avg3(B, C, D);
      at(2, 0) = at(1, 1) = at(0, 2) = avg3(C, D, E);
      at(3, 0) = at(2, 1) = at(1, 2) = at(0, 3) = avg3(D, E, F);
      at(3, 1) = at(2, 2) = at(1, 3) = avg3(E, F, G);
      at(3, 2) = at(2, 3) = avg3(F, G, H);
      at(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      at(0, 0) = at(1, 2) = avg2(X, A);
      at(1, 0) = at(2, 2) = avg2(A, B);
      at(2, 0) = at(3, 2) = avg2(B, C);
      at(3, 0) = avg2(C, D);
      at(0, 3) = avg3(K, J, I);
      at(0, 2) = avg3(J, I, X);
      at(0, 1) = at(1, 3) = avg3(I, X, A);
      at(1, 1) = at(2, 3) = avg3(X, A, B);
      at(2, 1) = at(3, 3) = avg3(A, B, C);
      at(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      at(0, 0) = avg2(A, B);
      at(1, 0) = at(0, 2) = avg2(B, C);
      at(2, 0) = at(1, 2) = avg2(C, D);
      at(3, 0) = at(2, 2) = avg2(D, E);
      at(0, 1) = avg3(A, B, C);
      at(1, 1) = at(0, 3) = avg3(B, C, D);
      at(2, 1) = at(1, 3) = avg3(C, D, E);
      at(3, 1) = at(2, 3) = avg3(D, E, F);
      at(3, 2) = avg3(E, F, G);
      at(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      at(0, 0) = at(2, 1) = avg2(I, X);
      at(0, 1) = at(2, 2) = avg2(J, I);
      at(0, 2) = at(2, 3) = avg2(K, J);
      at(0, 3) = avg2(L, K);
      at(3, 0) = avg3(A, B, C);
      at(2, 0) = avg3(X, A, B);
      at(1, 0) = at(3, 1) = avg3(I, X, A);
      at(1, 1) = at(3, 2) = avg3(J, I, X);
      at(1, 2) = at(3, 3) = avg3(K, J, I);
      at(1, 3) = avg3(L, K, J);
      break;
    default:   // B_HU_PRED
      at(0, 0) = avg2(I, J);
      at(2, 0) = at(0, 1) = avg2(J, K);
      at(2, 1) = at(0, 2) = avg2(K, L);
      at(1, 0) = avg3(I, J, K);
      at(3, 0) = at(1, 1) = avg3(J, K, L);
      at(3, 1) = at(1, 2) = avg3(K, L, L);
      at(3, 2) = at(2, 2) = at(0, 3) = at(1, 3) = at(2, 3) = at(3, 3) =
          uint8_t(L);
      break;
  }
}

// The loop filters (RFC 6386 section 15, as libwebp computes them).
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `size` positions along an edge; hstride crosses the edge, vstride runs
// along it.
void simple_filter(uint8_t* p, int hstride, int vstride, int size,
                   int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
    else if (mb_edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MacroblockModes {
  int segment = 0;
  bool skip = false, i4x4 = false;
  int ymode = DC_PRED, uvmode = DC_PRED;
  uint8_t bmodes[16];
};

// The Y, U and V planes of a decoded VP8 frame (whole macroblocks).
struct Yuv {
  int width = 0, height = 0, ystride = 0, uvstride = 0;
  std::vector<uint8_t> y, u, v;
};

class VP8Decoder {
 public:
  // `data` is the chunk's payload (with its padding byte, as libwebp's
  // demuxer hands it to the decoder).
  Yuv decode(const uint8_t* data, size_t size) {
    if (size < 10) fail(kCorrupt);
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(bits & 1);
    if (((bits >> 1) & 7) > 3) fail(kCorrupt);
    if (!((bits >> 4) & 1)) fail(kNotKeyframe);
    const uint32_t partition_length = bits >> 5;
    if (!key_frame) fail(kNotKeyframe);
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail(kCorrupt);
    Yuv out;
    out.width = le16(data + 6) & 0x3fff;
    out.height = le16(data + 8) & 0x3fff;
    mb_w_ = (out.width + 15) >> 4;
    mb_h_ = (out.height + 15) >> 4;
    data += 10;
    size -= 10;
    if (partition_length > size) fail(kCorrupt);
    br_ = BoolDecoder(data, partition_length);
    data += partition_length;
    size -= partition_length;
    br_.flag();   // colour space
    br_.flag();   // clamping type
    parse_segment_header();
    parse_filter_header();
    parse_partitions(data, size);
    parse_quant();
    br_.flag();   // refresh entropy probabilities: one frame, ignored
    parse_proba();

    out.ystride = mb_w_ * 16;
    out.uvstride = mb_w_ * 8;
    out.y.assign(size_t(out.ystride) * mb_h_ * 16, 0);
    out.u.assign(size_t(out.uvstride) * mb_h_ * 8, 0);
    out.v.assign(size_t(out.uvstride) * mb_h_ * 8, 0);
    std::vector<uint8_t> intra_t(size_t(4) * mb_w_, B_DC_PRED);
    std::vector<uint8_t> nz_top(mb_w_, 0), nz_dc_top(mb_w_, 0);
    std::vector<MacroblockModes> modes(mb_w_);
    std::vector<FilterInfo> finfo(size_t(mb_w_) * mb_h_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
        parse_intra_mode(&modes[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br_.eof()) fail(kCorrupt);
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t nz_left = 0, nz_dc_left = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MacroblockModes& m = modes[mb_x];
        int16_t coeffs[384];
        bool nonzero = false;
        if (!m.skip) {
          nonzero = parse_residuals(tokens, m, &nz_top[mb_x], &nz_dc_top[mb_x],
                                    &nz_left, &nz_dc_left, coeffs);
        } else {
          nz_left = nz_top[mb_x] = 0;
          if (!m.i4x4) nz_dc_left = nz_dc_top[mb_x] = 0;
        }
        if (tokens.eof()) fail(kCorrupt);
        if (filter_type_ > 0) {
          FilterInfo& f = finfo[size_t(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[m.segment][m.i4x4];
          f.inner = f.inner || nonzero;
        }
        reconstruct(out, mb_x, mb_y, m, nonzero ? coeffs : nullptr);
      }
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
          filter_macroblock(out, mb_x, mb_y,
                            finfo[size_t(mb_y) * mb_w_ + mb_x]);
    return out;
  }

 private:
  struct Quant {
    int y1[2], y2[2], uv[2];
  };

  void parse_segment_header() {
    use_segment_ = br_.flag();
    if (use_segment_) {
      update_map_ = br_.flag();
      if (br_.flag()) {   // update the segment data
        absolute_delta_ = br_.flag();
        for (int s = 0; s < 4; ++s)
          quantizer_[s] = br_.flag() ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength_[s] = br_.flag() ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          segment_proba_[s] = uint8_t(br_.flag() ? br_.value(8) : 255);
    } else {
      update_map_ = false;
    }
    if (br_.eof()) fail(kCorrupt);
  }

  void parse_filter_header() {
    const bool simple = br_.flag();
    const int level = br_.value(6);
    const int sharpness = br_.value(3);
    const bool use_lf_delta = br_.flag();
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    if (use_lf_delta && br_.flag()) {
      for (int i = 0; i < 4; ++i)
        if (br_.flag()) ref_lf_delta[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.flag()) mode_lf_delta[i] = br_.signed_value(6);
    }
    filter_type_ = level == 0 ? 0 : simple ? 1 : 2;
    if (br_.eof()) fail(kCorrupt);
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4 != 0;
      }
    }
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    num_parts_ = 1 << br_.value(2);
    const size_t last = size_t(num_parts_ - 1);
    if (size < 3 * last) fail(kCorrupt);
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts_[p] = BoolDecoder(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last] = BoolDecoder(start, left);
    if (left == 0) fail(kCorrupt);
  }

  void parse_quant() {
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.flag() ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.flag() ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q = base_q0;
      if (use_segment_) {
        q = quantizer_[s];
        if (!absolute_delta_) q += base_q0;
      }
      Quant& m = quant_[s];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = uint8_t(
                br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.value(8)
                                                        : kCoeffsProba0[t][b][c][p]);
    use_skip_proba_ = br_.flag();
    if (use_skip_proba_) skip_p_ = br_.value(8);
  }

  void parse_intra_mode(MacroblockModes* m, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      m->segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                               : br_.bit(segment_proba_[2]) + 2;
    } else {
      m->segment = 0;
    }
    m->skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
    m->i4x4 = !br_.bit(145);
    if (!m->i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      m->ymode = ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kBModeTree[br_.bit(prob[0])];
          while (i > 0) i = kBModeTree[i + br_.bit(prob[i >> 1])];
          ymode = -i;
          top[x] = uint8_t(ymode);
          m->bmodes[4 * y + x] = uint8_t(ymode);
        }
        left[y] = uint8_t(ymode);
      }
    }
    m->uvmode = !br_.bit(142) ? DC_PRED
                : !br_.bit(114) ? V_PRED
                : br_.bit(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
        v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // The tokens of one block from position n; returns the position after
  // the last one read (16 when the block runs to its end).
  int coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*next)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = next[1];
      } else {
        v = large_value(br, p);
        p = next[2];
      }
      const int s = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = int16_t(s * dq[n > 0]);
    }
    return 16;
  }

  // Returns whether any block has a non-zero coefficient (libwebp's
  // non_zero_y | non_zero_uv).
  bool parse_residuals(BoolDecoder& br, const MacroblockModes& m,
                       uint8_t* nz_top, uint8_t* nz_dc_top, uint8_t* nz_left,
                       uint8_t* nz_dc_left, int16_t* dst) {
    const Quant& q = quant_[m.segment];
    std::memset(dst, 0, 384 * sizeof(*dst));
    bool nonzero = false;
    int first, type;
    if (!m.i4x4) {
      int16_t dc[16] = {0};
      const int ctx = *nz_dc_top + *nz_dc_left;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      *nz_dc_top = *nz_dc_left = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    uint8_t tnz = *nz_top & 0x0f, lnz = *nz_left & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x, dst += 16) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nonzero = nonzero || nz > 1 || dst[0] != 0;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
    }
    uint8_t out_t = tnz, out_l = uint8_t(lnz >> 4);
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = uint8_t(*nz_top >> (4 + ch));
      lnz = uint8_t(*nz_left >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x, dst += 16) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nonzero = nonzero || nz > 1 || dst[0] != 0;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      out_t |= uint8_t((tnz << 4) << ch);
      out_l |= uint8_t((lnz & 0xf0) << ch);
    }
    *nz_top = out_t;
    *nz_left = out_l;
    return nonzero;
  }

  // Predicts one macroblock from the unfiltered frame around it, adds its
  // residual and stores it.
  void reconstruct(Yuv& f, int mb_x, int mb_y, const MacroblockModes& m,
                   const int16_t* coeffs) {
    uint8_t ws[17 * kBps];
    uint8_t* y_dst = ws + kBps + 8;
    const int ys = f.ystride;
    const uint8_t* ysrc = f.y.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
    if (mb_y == 0) {
      std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
    } else {
      std::memcpy(y_dst - kBps, ysrc - ys, 16);
      y_dst[-kBps - 1] = mb_x ? ysrc[-ys - 1] : 129;
      if (mb_x < mb_w_ - 1) std::memcpy(y_dst - kBps + 16, ysrc - ys + 16, 4);
      else std::memset(y_dst - kBps + 16, ysrc[-ys + 15], 4);
    }
    for (int j = 0; j < 16; ++j) y_dst[j * kBps - 1] = mb_x ? ysrc[j * ys - 1] : 129;
    if (m.i4x4) {
      uint8_t* top_right = y_dst - kBps + 16;
      for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * kBps, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        predict4(dst, m.bmodes[n]);
        if (coeffs) transform(coeffs + n * 16, dst, kBps);
      }
    } else {
      predict_block(y_dst, 16, m.ymode, mb_y > 0, mb_x > 0);
      if (coeffs)
        for (int n = 0; n < 16; ++n)
          transform(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps,
                    kBps);
    }
    uint8_t* yout = f.y.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
    for (int j = 0; j < 16; ++j) std::memcpy(yout + j * ys, y_dst + j * kBps, 16);

    for (int plane = 0; plane < 2; ++plane) {
      std::vector<uint8_t>& p = plane ? f.v : f.u;
      const int us = f.uvstride;
      uint8_t cw[9 * kBps];
      uint8_t* c_dst = cw + kBps + 8;
      uint8_t* src = p.data() + size_t(mb_y) * 8 * us + mb_x * 8;
      if (mb_y == 0) {
        std::memset(c_dst - kBps - 1, 127, 8 + 1);
      } else {
        std::memcpy(c_dst - kBps, src - us, 8);
        c_dst[-kBps - 1] = mb_x ? src[-us - 1] : 129;
      }
      for (int j = 0; j < 8; ++j) c_dst[j * kBps - 1] = mb_x ? src[j * us - 1] : 129;
      predict_block(c_dst, 8, m.uvmode, mb_y > 0, mb_x > 0);
      if (coeffs)
        for (int n = 0; n < 4; ++n)
          transform(coeffs + (16 + 4 * plane + n) * 16,
                    c_dst + (n & 1) * 4 + (n >> 1) * 4 * kBps, kBps);
      for (int j = 0; j < 8; ++j) std::memcpy(src + j * us, c_dst + j * kBps, 8);
    }
  }

  void filter_macroblock(Yuv& f, int mb_x, int mb_y, const FilterInfo& fi) {
    const int limit = fi.limit;
    if (limit == 0) return;
    const int ys = f.ystride, us = f.uvstride;
    uint8_t* y = f.y.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
      if (fi.inner)
        for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, 16, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
      if (fi.inner)
        for (int k = 4; k < 16; k += 4)
          simple_filter(y + k * ys, ys, 1, 16, limit);
      return;
    }
    uint8_t* u = f.u.data() + size_t(mb_y) * 8 * us + mb_x * 8;
    uint8_t* v = f.v.data() + size_t(mb_y) * 8 * us + mb_x * 8;
    const int il = fi.ilevel, hev_t = fi.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u, 1, us, 8, limit + 4, il, hev_t, true);
      filter_loop(v, 1, us, 8, limit + 4, il, hev_t, true);
    }
    if (fi.inner) {
      for (int k = 4; k < 16; k += 4)
        filter_loop(y + k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u + 4, 1, us, 8, limit, il, hev_t, false);
      filter_loop(v + 4, 1, us, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u, us, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v, us, 1, 8, limit + 4, il, hev_t, true);
    }
    if (fi.inner) {
      for (int k = 4; k < 16; k += 4)
        filter_loop(y + k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u + 4 * us, us, 1, 8, limit, il, hev_t, false);
      filter_loop(v + 4 * us, us, 1, 8, limit, il, hev_t, false);
    }
  }

  int mb_w_ = 0, mb_h_ = 0;
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  int filter_type_ = 0;
  FilterInfo fstrengths_[4][2];
  Quant quant_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
};

// libwebp's YUV -> RGB (yuv.h): 14-bit fixed point.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                      mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

// libwebp's fancy upsampler of one pair of output rows (upsampling.c):
// `top_*` chroma is the row nearer the top output row.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                  bottom_dst + 2 * x * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (len - 1) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (len - 1) * 4);
    }
  }
}

// The frame's RGBA rows into `dst` (stride in bytes), as libwebp's
// EmitFancyRGB emits a whole frame.
void yuv_to_rgba_frame(const Yuv& f, uint8_t* dst, size_t stride) {
  const int w = f.width, h = f.height;
  const uint8_t* y = f.y.data();
  const uint8_t* u = f.u.data();
  const uint8_t* v = f.v.data();
  upsample_pair(y, nullptr, u, v, u, v, dst, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* top_u = u + size_t(row / 2) * f.uvstride;
    const uint8_t* top_v = v + size_t(row / 2) * f.uvstride;
    upsample_pair(y + size_t(row + 1) * f.ystride, y + size_t(row + 2) * f.ystride,
                  top_u, top_v, top_u + f.uvstride, top_v + f.uvstride,
                  dst + (row + 1) * stride, dst + (row + 2) * stride, w);
  }
  if (!(h & 1)) {
    const uint8_t* cu = u + size_t(row / 2) * f.uvstride;
    const uint8_t* cv = v + size_t(row / 2) * f.uvstride;
    upsample_pair(y + size_t(h - 1) * f.ystride, nullptr, cu, cv, cu, cv,
                  dst + (h - 1) * stride, nullptr, w);
  }
}

// ---------------------------------------------------------------------------
// ALPH

// The alpha plane of a (w, h) frame from an ALPH chunk's payload, or false
// where libwebp cannot decode it.
bool decode_alpha(const uint8_t* data, size_t size, int w, int h,
                  std::vector<uint8_t>* alpha) {
  if (size <= 1) return false;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3,
            pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0) return false;
  const size_t n = size_t(w) * h;
  alpha->assign(n, 0);
  if (method == 0) {
    if (size - 1 < n) return false;
    std::memcpy(alpha->data(), data + 1, n);
  } else {
    try {
      VP8LDecoder dec(data + 1, size - 1);
      const std::vector<uint32_t> argb = dec.image(w, h, true);
      for (size_t i = 0; i < n; ++i) (*alpha)[i] = uint8_t(argb[i] >> 8);
    } catch (const WebpError& e) {
      if (e.code == kMemory) throw;
      return false;
    }
  }
  uint8_t* a = alpha->data();
  for (int y = 0; y < h && filter; ++y) {
    uint8_t* row = a + size_t(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (!prev || filter == 1) {   // horizontal, and every filter's first row
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = uint8_t(row[x] + pred);
    } else if (filter == 2) {     // vertical
      for (int x = 0; x < w; ++x) row[x] = uint8_t(row[x] + prev[x]);
    } else {                      // gradient
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x];
        const int g = left + top - top_left;
        left = uint8_t(row[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        row[x] = uint8_t(left);
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// The container, as libwebp's demuxer (demux.c) and decoder (webp_dec.c)
// read it.

struct Chunk {
  size_t offset = 0, size = 0;   // header included, payload padded
};

struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false, has_alpha = false;
  Chunk image, alpha;
};

enum Parse { kOk, kNeedMore, kError };

// The bitstream features libwebp's WebPGetFeatures reads from the start of
// a VP8 or VP8L chunk (header included) of `size` bytes.
bool chunk_features(const uint8_t* d, size_t size, int* w, int* h,
                    bool* alpha, bool* not_enough) {
  *not_enough = false;
  if (size < 8) {
    *not_enough = true;
    return false;
  }
  const bool lossless = std::memcmp(d, "VP8L", 4) == 0;
  const uint32_t csize = le32(d + 4);
  if (csize > kMaxChunkPayload) return false;
  d += 8;
  size -= 8;
  if (!lossless) {
    if (size < 10) {
      *not_enough = true;
      return false;
    }
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
        (bits >> 5) >= csize)
      return false;
    *w = le16(d + 6) & 0x3fff;
    *h = le16(d + 8) & 0x3fff;
    *alpha = false;
    return *w && *h;
  }
  if (size < 5) {
    *not_enough = true;
    return false;
  }
  if (d[0] != 0x2f || (d[4] >> 5) != 0) return false;
  const uint32_t bits = le32(d + 1);
  *w = int(bits & 0x3fff) + 1;
  *h = int((bits >> 14) & 0x3fff) + 1;
  *alpha = (bits >> 28) & 1;
  return true;
}

class Demuxer {
 public:
  Demuxer(const uint8_t* data, size_t size) : buf_(data), end_(size) {}

  // Returns 0 or a WebpCode; fills the canvas and the first frame.
  int parse() {
    if (end_ < 20) return kTruncated;
    const uint32_t riff_size = le32(buf_ + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) return kCorrupt;
    const size_t riff_end = size_t(riff_size) + 8;
    if (end_ < riff_end) return kTruncated;
    end_ = riff_end;
    start_ = 12;
    Parse status;
    const uint8_t* tag = buf_ + start_;
    if (!std::memcmp(tag, "VP8 ", 4) || !std::memcmp(tag, "VP8L", 4)) {
      status = parse_single_image();
      if (status != kError && !valid_simple()) status = kError;
    } else if (!std::memcmp(tag, "VP8X", 4)) {
      status = parse_vp8x();
      if (status != kError && !valid_extended()) status = kError;
    } else {
      return kCorrupt;
    }
    if (status == kNeedMore) return kTruncated;
    return status == kOk ? 0 : kCorrupt;
  }

  int canvas_width = 0, canvas_height = 0;
  std::vector<Frame> frames;

  // The bytes libwebp's demuxer hands the decoder for a frame: from its
  // ALPH chunk (if kept) to the end of its image chunk.
  void payload(const Frame& f, size_t* offset, size_t* size) const {
    *offset = f.image.offset;
    *size = f.image.size;
    if (f.alpha.size > 0) {
      const size_t inter = f.image.offset > 0
                               ? f.image.offset - (f.alpha.offset + f.alpha.size)
                               : 0;
      *offset = f.alpha.offset;
      *size += f.alpha.size + inter;
    }
  }

 private:
  size_t avail() const { return end_ - start_; }
  bool size_invalid(size_t n) const { return n > end_ - start_; }

  Parse store_frame(int frame_num, size_t min_size, Frame* frame) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < 8 || avail() < min_size) return kNeedMore;
    Parse status = kOk;
    bool done = false;
    do {
      const size_t chunk_start = start_;
      const uint8_t* tag = buf_ + start_;
      const uint32_t payload = le32(buf_ + start_ + 4);
      start_ += 8;
      if (payload > kMaxChunkPayload) return kError;
      const size_t padded = size_t(payload) + (payload & 1);
      const size_t available = std::min(padded, avail());
      const size_t chunk_size = 8 + available;
      if (size_invalid(padded)) return kError;
      if (padded > avail()) status = kNeedMore;
      const bool is_alph = !std::memcmp(tag, "ALPH", 4);
      const bool is_vp8l = !std::memcmp(tag, "VP8L", 4);
      const bool is_vp8 = !std::memcmp(tag, "VP8 ", 4);
      if (is_alph && alpha_chunks == 0) {
        ++alpha_chunks;
        frame->alpha = {chunk_start, chunk_size};
        frame->has_alpha = true;
        frame->frame_num = frame_num;
        start_ += available;
      } else if ((is_vp8l || is_vp8) && image_chunks == 0 &&
                 !(is_vp8l && alpha_chunks > 0)) {
        int w = 0, h = 0;
        bool alpha = false, not_enough = false;
        if (!chunk_features(buf_ + chunk_start, chunk_size, &w, &h, &alpha,
                            &not_enough))
          return status == kNeedMore && not_enough ? kNeedMore : kError;
        ++image_chunks;
        frame->image = {chunk_start, chunk_size};
        frame->width = w;
        frame->height = h;
        frame->has_alpha = frame->has_alpha || alpha;
        frame->frame_num = frame_num;
        frame->complete = status == kOk;
        start_ += available;
      } else if (is_vp8l && alpha_chunks > 0 && image_chunks == 0) {
        return kError;   // VP8L has its own alpha
      } else {
        start_ -= 8;     // not this frame's: leave it to the caller
        done = true;
      }
      if (start_ == end_) done = true;
      else if (avail() < 8) status = kNeedMore;
    } while (!done && status == kOk);
    return status;
  }

  bool add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(f);
    return true;
  }

  Parse parse_single_image() {
    if (!frames.empty()) return kError;
    if (size_invalid(8)) return kError;
    if (avail() < 8) return kNeedMore;
    Frame frame;
    const Parse status = store_frame(1, 0, &frame);
    if (status == kError) return status;
    if (!(flags_ & 0x10) && frame.alpha.size > 0) {   // no ALPHA flag
      frame.alpha = Chunk();
      frame.has_alpha = false;
    }
    if (!extended_ && frame.width > 0 && frame.height > 0) {
      canvas_width = frame.width;
      canvas_height = frame.height;
      flags_ |= frame.has_alpha ? 0x10 : 0;
    }
    if (!add_frame(frame)) return kError;
    num_frames_ = 1;
    return status;
  }

  Parse parse_vp8x() {
    if (avail() < 8) return kNeedMore;
    extended_ = true;
    start_ += 4;
    uint32_t size = le32(buf_ + start_);
    start_ += 4;
    if (size > kMaxChunkPayload || size < 10) return kError;
    size += size & 1;
    if (size_invalid(size)) return kError;
    if (avail() < size) return kNeedMore;
    flags_ = buf_[start_];
    canvas_width = int(le24(buf_ + start_ + 4)) + 1;
    canvas_height = int(le24(buf_ + start_ + 7)) + 1;
    if (uint64_t(canvas_width) * uint64_t(canvas_height) >= kMaxImageArea)
      return kError;
    start_ += size;
    if (size_invalid(8)) return kError;
    if (avail() < 8) return kNeedMore;
    return parse_vp8x_chunks();
  }

  Parse parse_vp8x_chunks() {
    const bool animation = flags_ & 0x02;
    int anim_chunks = 0;
    Parse status = kOk;
    do {
      const uint8_t* tag = buf_ + start_;
      const uint32_t size = le32(buf_ + start_ + 4);
      start_ += 8;
      if (size > kMaxChunkPayload) return kError;
      const size_t padded = size_t(size) + (size & 1);
      if (size_invalid(padded)) return kError;
      if (!std::memcmp(tag, "VP8X", 4)) return kError;
      if (!std::memcmp(tag, "ALPH", 4) || !std::memcmp(tag, "VP8 ", 4) ||
          !std::memcmp(tag, "VP8L", 4)) {
        if (anim_chunks > 0 || animation) return kError;
        start_ -= 8;
        status = parse_single_image();
      } else if (!std::memcmp(tag, "ANIM", 4)) {
        if (padded < 6) return kError;
        if (avail() < padded) {
          status = kNeedMore;
        } else {
          if (anim_chunks == 0) {
            ++anim_chunks;
            loop_count_ = int(le16(buf_ + start_ + 4));
          }
          start_ += padded;
        }
      } else if (!std::memcmp(tag, "ANMF", 4)) {
        if (anim_chunks == 0) return kError;
        status = parse_animation_frame(padded);
      } else {
        if (padded <= avail()) start_ += padded;
        else status = kNeedMore;
      }
      if (start_ == end_) break;
      if (avail() < 8) status = kNeedMore;
    } while (status == kOk);
    return status;
  }

  Parse parse_animation_frame(size_t chunk_size) {
    const bool animation = flags_ & 0x02;
    if (chunk_size < 16) return kError;
    if (size_invalid(chunk_size)) return kError;
    if (avail() < 16) return kNeedMore;
    const size_t anmf_payload = chunk_size - 16;
    Frame frame;
    const uint8_t* p = buf_ + start_;
    frame.x_offset = 2 * int(le24(p));
    frame.y_offset = 2 * int(le24(p + 3));
    frame.width = 1 + int(le24(p + 6));
    frame.height = 1 + int(le24(p + 9));
    start_ += 16;
    if (uint64_t(frame.width) * uint64_t(frame.height) >= kMaxImageArea)
      return kError;
    const size_t begin = start_;
    Parse status = store_frame(num_frames_ + 1, anmf_payload, &frame);
    if (status != kError && start_ - begin > anmf_payload) status = kError;
    if (status != kError && animation && frame.frame_num > 0) {
      if (add_frame(frame)) ++num_frames_;
      else status = kError;
    }
    return status;
  }

  bool valid_simple() const {
    if (canvas_width <= 0 || canvas_height <= 0) return false;
    if (frames.empty()) return false;
    return frames[0].width > 0 && frames[0].height > 0;
  }

  bool valid_extended() const {
    const bool animation = flags_ & 0x02;
    if (canvas_width <= 0 || canvas_height <= 0) return false;
    if (loop_count_ < 0) return false;
    if (frames.empty()) return false;
    if (flags_ & ~0x3eu) return false;
    for (const Frame& f : frames) {
      if (!animation && f.frame_num > 1) return false;
      if (!f.complete) return false;
      if (f.alpha.size == 0 && f.image.size == 0) return false;
      if (f.alpha.size > 0 && f.alpha.offset > f.image.offset) return false;
      if (f.width <= 0 || f.height <= 0) return false;
      if (!animation) {
        if (f.x_offset || f.y_offset || f.width != canvas_width ||
            f.height != canvas_height)
          return false;
      } else if (f.width + f.x_offset > canvas_width ||
                 f.height + f.y_offset > canvas_height) {
        return false;
      }
    }
    return true;
  }

  const uint8_t* buf_;
  size_t end_, start_ = 0;
  uint32_t flags_ = 0;
  bool extended_ = false;
  int loop_count_ = 0, num_frames_ = 0;
};

// Whether libwebp's WebPGetFeatures reports alpha for the whole file, which
// is how PIL picks "RGBA" over "RGB" (a file it cannot read is "RGBA").
bool features_alpha(const uint8_t* d, size_t size) {
  size_t riff_size = 0;
  if (size >= 12 && !std::memcmp(d, "RIFF", 4)) {
    if (std::memcmp(d + 8, "WEBP", 4)) return true;
    const uint32_t s = le32(d + 4);
    if (s < 12 || s > kMaxChunkPayload) return true;
    riff_size = s;
    d += 12;
    size -= 12;
  }
  if (size < 8) return true;
  bool found_vp8x = false, alpha = false;
  int canvas_w = 0, canvas_h = 0;
  if (!std::memcmp(d, "VP8X", 4)) {
    if (le32(d + 4) != 10) return true;
    if (size < 18) return true;
    const uint32_t flags = le32(d + 8);
    canvas_w = int(le24(d + 12)) + 1;
    canvas_h = int(le24(d + 15)) + 1;
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= kMaxImageArea) return true;
    alpha = flags & 0x10;
    if (flags & 0x02) return alpha;   // an animation: the flag alone
    d += 18;
    size -= 18;
    found_vp8x = true;
  }
  // From here, a NOT_ENOUGH_DATA answer with a VP8X chunk keeps the flag.
  const bool keep = found_vp8x;
  if (size < 4) return keep ? alpha : true;
  bool alpha_chunk = false;
  if (found_vp8x) {
    uint32_t total = 4 + 8 + 10;
    for (;;) {
      if (size < 8) return keep ? (alpha || alpha_chunk) : true;
      const uint32_t csize = le32(d + 4);
      if (csize > kMaxChunkPayload) return true;
      const uint32_t disk = (8 + csize + 1) & ~1u;
      total += disk;
      if (riff_size > 0 && total > riff_size) return true;
      if (!std::memcmp(d, "VP8 ", 4) || !std::memcmp(d, "VP8L", 4)) break;
      if (size < disk) return keep ? (alpha || alpha_chunk) : true;
      if (!std::memcmp(d, "ALPH", 4)) alpha_chunk = true;
      d += disk;
      size -= disk;
    }
  }
  if (size < 8) return keep ? (alpha || alpha_chunk) : true;
  const bool is_vp8 = !std::memcmp(d, "VP8 ", 4),
             is_vp8l = !std::memcmp(d, "VP8L", 4);
  bool lossless;
  size_t chunk_size = size;
  if (is_vp8 || is_vp8l) {
    const uint32_t csize = le32(d + 4);
    if (riff_size >= 12 && csize > riff_size - 12) return true;
    if (csize > kMaxChunkPayload) return true;
    chunk_size = csize;
    d += 8;
    size -= 8;
    lossless = is_vp8l;
  } else {
    lossless = size >= 5 && d[0] == 0x2f && (d[4] >> 5) == 0;
  }
  int w, h;
  if (!lossless) {
    if (size < 10) return keep ? (alpha || alpha_chunk) : true;
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return true;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
        (bits >> 5) >= chunk_size)
      return true;
    w = le16(d + 6) & 0x3fff;
    h = le16(d + 8) & 0x3fff;
    if (!w || !h) return true;
  } else {
    if (size < 5) return keep ? (alpha || alpha_chunk) : true;
    if (d[0] != 0x2f || (d[4] >> 5) != 0) return true;
    const uint32_t bits = le32(d + 1);
    w = int(bits & 0x3fff) + 1;
    h = int((bits >> 14) & 0x3fff) + 1;
    alpha = (bits >> 28) & 1;
  }
  if (found_vp8x && (canvas_w != w || canvas_h != h)) return true;
  return alpha || alpha_chunk;
}

// The payload of the chunk at `d` (size bytes left): libwebp's
// ParseHeadersInternal over a frame's fragment.  Sets the image data (after
// its chunk header, to the end of the fragment), whether it is VP8L, and
// the last ALPH payload before it.
bool fragment_headers(const uint8_t* d, size_t size, const uint8_t** image,
                      size_t* image_size, bool* lossless,
                      const uint8_t** alpha, size_t* alpha_size) {
  *alpha = nullptr;
  *alpha_size = 0;
  if (size < 8) return false;
  if (!std::memcmp(d, "ALPH", 4)) {
    for (;;) {
      if (size < 8) return false;
      const uint32_t csize = le32(d + 4);
      if (csize > kMaxChunkPayload) return false;
      const size_t disk = (size_t(8) + csize + 1) & ~size_t(1);
      if (!std::memcmp(d, "VP8 ", 4) || !std::memcmp(d, "VP8L", 4)) break;
      if (size < disk) return false;
      if (!std::memcmp(d, "ALPH", 4)) {
        *alpha = d + 8;
        *alpha_size = csize;
      }
      d += disk;
      size -= disk;
    }
  }
  if (size < 8) return false;
  const uint32_t csize = le32(d + 4);
  if (csize > size - 8) return false;
  *lossless = !std::memcmp(d, "VP8L", 4);
  *image = d + 8;
  *image_size = size - 8;
  return true;
}

struct Decoded {
  int width = 0, height = 0;
  bool has_alpha = false;
  int coding = 0;   // VP8LDecoder::coding() of a lossless first frame
  std::vector<uint8_t> rgba;   // the canvas, 4 bytes a pixel
};

Decoded decode_webp(const uint8_t* data, size_t size) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) ||
      std::memcmp(data + 8, "WEBP", 4))
    fail(kNotWebp);
  Demuxer demux(data, size);
  const int rc = demux.parse();
  if (rc) fail(rc);
  Decoded out;
  out.width = demux.canvas_width;
  out.height = demux.canvas_height;
  if (uint64_t(out.width) * uint64_t(out.height) > kMaxPixels) fail(kTooLarge);
  out.has_alpha = features_alpha(data, size);
  out.rgba.assign(size_t(out.width) * out.height * 4, 0);

  const Frame& frame = demux.frames[0];
  size_t offset, length;
  demux.payload(frame, &offset, &length);
  const uint8_t* image;
  const uint8_t* alpha_data;
  size_t image_size, alpha_size;
  bool lossless;
  if (!fragment_headers(data + offset, length, &image, &image_size, &lossless,
                        &alpha_data, &alpha_size))
    fail(kCorrupt);
  const size_t stride = size_t(out.width) * 4;
  uint8_t* dst = out.rgba.data() + size_t(frame.y_offset) * stride +
                 size_t(frame.x_offset) * 4;
  if (lossless) {
    VP8LDecoder dec(image, image_size);
    int w, h, has_alpha;
    dec.header(&w, &h, &has_alpha);
    const std::vector<uint32_t> argb = dec.image(w, h);
    out.coding = dec.coding() | (1 << 6);
    for (int y = 0; y < h; ++y) {
      uint8_t* row = dst + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[size_t(y) * w + x];
        row[4 * x] = uint8_t(p >> 16);
        row[4 * x + 1] = uint8_t(p >> 8);
        row[4 * x + 2] = uint8_t(p);
        row[4 * x + 3] = uint8_t(p >> 24);
      }
    }
  } else {
    VP8Decoder dec;
    const Yuv yuv = dec.decode(image, image_size);
    std::vector<uint8_t> alpha;
    if (alpha_data &&
        !decode_alpha(alpha_data, alpha_size, yuv.width, yuv.height, &alpha))
      fail(kCorrupt);
    yuv_to_rgba_frame(yuv, dst, stride);
    if (!alpha.empty())
      for (int y = 0; y < yuv.height; ++y)
        for (int x = 0; x < yuv.width; ++x)
          dst[y * stride + 4 * x + 3] = alpha[size_t(y) * yuv.width + x];
  }
  return out;
}

}  // namespace

extern "C" {

// Decodes WebP bytes into a new buffer at *out: the (h, w, channels) uint8
// samples of PIL's mode ("RGB": 3 channels, "RGBA": 4).  meta gets
// channels, h, w and the coding tools of a lossless first frame (bit 6 set,
// bits 0-5 VP8LDecoder::coding(); 0 for a lossy one).  Returns 0, or a
// negative WebpCode (nothing is allocated then).
int sn_webp_decode(const uint8_t* data, size_t size, int64_t* meta,
                   uint8_t** out) {
  try {
    const Decoded img = decode_webp(data, size);
    const int channels = img.has_alpha ? 4 : 3;
    const size_t pixels = size_t(img.width) * img.height;
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(pixels * channels));
    if (!buf) return kMemory;
    if (channels == 4) {
      std::memcpy(buf, img.rgba.data(), pixels * 4);
    } else {
      for (size_t i = 0; i < pixels; ++i)
        std::memcpy(buf + 3 * i, img.rgba.data() + 4 * i, 3);
    }
    meta[0] = channels;
    meta[1] = img.height;
    meta[2] = img.width;
    meta[3] = img.coding;
    *out = buf;
    return 0;
  } catch (const WebpError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kMemory;
  } catch (const std::length_error&) {
    return kMemory;
  }
}

}  // extern "C"
