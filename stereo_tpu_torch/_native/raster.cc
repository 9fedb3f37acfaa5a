// BMP, TIFF and GIF decoding for the port's native host runtime (built
// into the same library as stereo_native.cc).
//
// Each decoder gives the pixels of PIL's Image.open(f) (Pillow 12.1, with
// libtiff 4.7 behind its compressed TIFFs), in PIL's own mode, for every
// file PIL opens, and refuses the files PIL refuses.  The conversion to RGB
// and the stereo trainer's reading of ground truth happen in Python
// (utils/image_io.py), on the mode and samples decoded here:
//
//   * BMP: the OS/2 core header (12 bytes) and the Windows headers of 40,
//     52, 56, 64, 108 and 124 bytes; 1-, 4- and 8-bit palettes (a palette
//     of black and white is mode "1" and a grey ramp mode "L", as PIL makes
//     them), 16-bit 555 and BITFIELDS 565 (each field scaled by v * 255 /
//     max), 24 bits, 32 bits plain or with the BITFIELDS layouts PIL takes
//     (alpha dropped); RLE8 and RLE4 as PIL's Python decoder reads them;
//     rows bottom-up or top-down.
//   * TIFF: the first IFD, II or MM, classic or BigTIFF; strips or tiles;
//     no compression (PIL's own raw decoder), LZW, Deflate and PackBits
//     (as libtiff decodes them for PIL, with the strips libtiff's own
//     reading of the directory finds); predictor 2 at 8, 16 and 32 bits
//     and predictor 3; PIL's table of photometric, sample format, fill
//     order, bits and extra samples (OPEN_INFO), planar configuration 1
//     and 2.  The Orientation tag is returned for Python to apply.
//   * GIF: the first frame: global and local colour tables, interlace,
//     PIL's LZW decoder (GifDecode.c) with its fill of the pixels a frame
//     does not cover (the transparent index, else 0); a code stream that
//     ends before the last pixel is refused, as PIL refuses it.
//
// Images over 178956970 pixels (PIL's decompression-bomb limit) are
// refused.  TIFF variants PIL opens and this decoder does not are refused
// by name (see RasterCode).

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

struct RasterError {
  int code;
};

enum RasterCode {
  kTruncated = -1,        // the data ends before the pixels do
  kCorrupt = -2,          // a header, table or code stream PIL refuses
  kUnknownFormat = -3,    // not BMP, TIFF or GIF
  kTooLarge = -4,         // over PIL's decompression-bomb limit
  kMemory = -5,           // out of memory
  kBmpUnsupported = -6,   // a BMP header, depth, compression or bitfields
                          // layout PIL refuses
  kTiffUnsupported = -7,  // a TIFF layout PIL refuses (its OPEN_INFO)
  kTiffJpeg = -10,        // compression 6 or 7
  kTiffCcitt = -11,       // compression 2, 3 or 4
  kTiffLzma = -12,        // compression 34925
  kTiffZstd = -13,        // compression 50000
  kTiffWebp = -14,        // compression 50001
  kTiffOtherCodec = -15,  // ThunderScan, SGILog, 16-bit-padded raw
  kTiffYcbcr = -16,       // photometric 6
  kTiffLab = -17,         // photometric 8
};

[[noreturn]] void fail(int code) { throw RasterError{code}; }

inline void check(bool ok, int code = kCorrupt) {
  if (!ok) fail(code);
}

const uint64_t kMaxPixels = 2ull * 89478485;  // PIL's bomb limit, 2x

// PIL's modes, in the order of _native.RASTER_MODES.
enum Mode {
  kMode1 = 0,     // 0 or 255
  kModeL = 1,
  kModeP = 2,     // palette indices
  kModeLA = 3,
  kModePA = 4,
  kModeRGB = 5,
  kModeRGBA = 6,
  kModeCMYK = 7,
  kModeI16 = 8,   // uint16
  kModeI = 9,     // int32
  kModeF = 10,    // float32
};

const int kModeChannels[] = {1, 1, 1, 2, 2, 3, 4, 4, 1, 1, 1};
const int kModeBytes[] = {1, 1, 1, 1, 1, 1, 1, 1, 2, 4, 4};

struct Raster {
  int mode = kModeL;
  int64_t h = 0, w = 0;
  std::vector<uint8_t> pixels;   // (h, w, channels) samples of the mode
  std::vector<uint8_t> palette;  // RGB triples of mode P and PA
  int orientation = 1;           // TIFF's Orientation tag

  void allocate(int m, int64_t height, int64_t width) {
    check(width > 0 && height > 0);
    check(uint64_t(width) * uint64_t(height) <= kMaxPixels, kTooLarge);
    mode = m;
    h = height;
    w = width;
    pixels.assign(size_t(h) * size_t(w) * pixel_bytes(), 0);
  }
  size_t pixel_bytes() const {
    return size_t(kModeChannels[mode]) * kModeBytes[mode];
  }
  uint8_t* row(int64_t y) {
    return pixels.data() + size_t(y) * w * pixel_bytes();
  }
};

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// ---------------------------------------------------------------------------
// BMP (PIL's BmpImagePlugin)
// ---------------------------------------------------------------------------

// One BMP raw mode: the bytes of a pixel and how they map to RGB.
struct BmpLayout {
  int bits;        // bits a pixel takes in a row
  int r, g, b;     // byte of each channel in a 24/32-bit pixel
  int rgb16;       // 555 or 565 for 16-bit pixels, else 0
};

Raster decode_bmp(const uint8_t* d, size_t n) {
  check(n >= 14, kTruncated);
  uint64_t offset = le32(d + 10);
  size_t pos = 14;
  check(pos + 4 <= n, kTruncated);
  const uint32_t header_size = le32(d + pos);
  pos += 4;
  const bool known = header_size == 12 || header_size == 40 ||
                     header_size == 52 || header_size == 56 ||
                     header_size == 64 || header_size == 108 ||
                     header_size == 124;
  if (header_size > 4) check(pos + header_size - 4 <= n, kTruncated);
  check(known, kBmpUnsupported);
  const uint8_t* hd = d + pos;
  pos += header_size - 4;

  int64_t width, height;
  int bits, palette_padding, direction = -1;
  uint32_t compression = 0;
  uint64_t colors;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (header_size == 12) {
    width = le16(hd);
    height = le16(hd + 2);
    bits = le16(hd + 6);
    palette_padding = 3;
    colors = 0;
  } else {
    const bool y_flip = hd[7] == 0xFF;
    direction = y_flip ? 1 : -1;
    width = le32(hd);
    height = y_flip ? (int64_t(1) << 32) - le32(hd + 4) : le32(hd + 4);
    bits = le16(hd + 10);
    compression = le32(hd + 12);
    colors = le32(hd + 28);
    palette_padding = 4;
    if (compression == 3) {
      if (header_size - 4 >= 48) {
        for (int i = 0; i < 3; ++i) masks[i] = le32(hd + 36 + 4 * i);
        if (header_size - 4 >= 52) masks[3] = le32(hd + 48);
      } else {
        check(pos + 12 <= n, kTruncated);
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + pos + 4 * i);
        pos += 12;
      }
    }
  }
  if (colors == 0) colors = bits < 64 ? uint64_t(1) << bits : ~uint64_t(0);
  if (offset == 14 + uint64_t(header_size) && bits <= 8) offset += 4 * colors;

  int mode;
  BmpLayout layout{};
  switch (bits) {
    case 1: case 4: case 8:
      mode = kModeP;
      layout.bits = bits;
      break;
    case 16:
      mode = kModeRGB;
      layout = {16, 0, 0, 0, 555};
      break;
    case 24:
      mode = kModeRGB;
      layout = {24, 2, 1, 0, 0};
      break;
    case 32:
      mode = kModeRGB;
      layout = {32, 2, 1, 0, 0};  // BGRX
      break;
    default:
      fail(kBmpUnsupported);
  }
  bool rle = false;
  if (compression == 3) {
    // The layouts PIL's MASK_MODES takes; alpha, where there is one, is
    // dropped by the conversion to RGB, so only R, G and B are kept.
    const uint32_t r = masks[0], g = masks[1], b = masks[2], a = masks[3];
    auto byte_of = [](uint32_t m) {
      for (int i = 0; i < 4; ++i)
        if (m == 0xFFu << (8 * i)) return i;
      return -1;
    };
    bool ok = false;
    if (bits == 32) {
      const uint32_t known_masks[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0},       {0xFF000000, 0xFF0000, 0xFF00, 0},
          {0xFF000000, 0xFF00, 0xFF, 0},
          {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000},
          {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {0, 0, 0, 0}};
      for (const auto& m : known_masks)
        if (m[0] == r && m[1] == g && m[2] == b && m[3] == a) ok = true;
      if (ok && r == 0) {
        layout = {32, 2, 1, 0, 0};  // all zero masks read as BGRA
      } else if (ok) {
        layout = {32, byte_of(r), byte_of(g), byte_of(b), 0};
      }
    } else if (bits == 24) {
      ok = r == 0xFF0000 && g == 0xFF00 && b == 0xFF;
    } else if (bits == 16) {
      if (r == 0xF800 && g == 0x7E0 && b == 0x1F) {
        ok = true;
        layout.rgb16 = 565;
      } else if (r == 0x7C00 && g == 0x3E0 && b == 0x1F) {
        ok = true;
      }
    }
    check(ok, kBmpUnsupported);
  } else if (compression == 1 || compression == 2) {
    rle = true;
  } else {
    check(compression == 0, kBmpUnsupported);
  }

  Raster out;
  std::vector<uint8_t> palette;
  if (mode == kModeP) {
    check(colors > 0 && colors <= 65536, kBmpUnsupported);
    const size_t want = size_t(palette_padding) * colors;
    const size_t got = pos < n ? std::min(want, n - pos) : 0;
    const uint8_t* pal = d + pos;
    pos += got;
    bool grey = true;
    for (uint64_t ind = 0; ind < colors && grey; ++ind) {
      const uint8_t val = colors == 2 ? (ind ? 255 : 0) : uint8_t(ind & 255);
      const size_t at = ind * palette_padding;
      grey = at + 3 <= got && pal[at] == val && pal[at + 1] == val &&
             pal[at + 2] == val;
    }
    if (grey) {
      mode = colors == 2 ? kMode1 : kModeL;
      // PIL reads the rows with raw mode "1" or "L", whatever the depth.
      layout.bits = colors == 2 ? 1 : 8;
    } else {
      const size_t entries = got / palette_padding;
      check(entries <= 256);  // PIL: "invalid palette size"
      for (size_t i = 0; i < entries; ++i) {
        const uint8_t* e = pal + i * palette_padding;
        palette.insert(palette.end(), {e[2], e[1], e[0]});
      }
    }
  }

  // PIL's tile starts at the header's offset, or where its reading of the
  // header (and palette) stopped when that is 0.
  if (offset == 0) offset = pos;
  out.allocate(mode, height, width);
  out.palette = palette;
  if (rle) {
    // PIL's BmpRleDecoder: reads "P" (or "L") bytes into mode P or L only.
    check(mode == kModeP || mode == kModeL, kBmpUnsupported);
    const bool rle4 = compression == 2;
    const size_t dest = size_t(width) * size_t(height);
    std::vector<uint8_t> data;
    data.reserve(dest);
    size_t p = offset < n ? size_t(offset) : n;
    int64_t x = 0;
    while (data.size() < dest) {
      if (p + 2 > n) break;
      int64_t count = d[p];
      const uint8_t byte = d[p + 1];
      p += 2;
      if (count) {
        if (x + count > width) count = std::max<int64_t>(0, width - x);
        for (int64_t i = 0; i < count; ++i)
          data.push_back(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
        x += count;
      } else if (byte == 0) {  // end of line
        while (data.size() % width) data.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta: PIL skips two bytes, then reads two
        if (p + 2 > n) break;
        p += 2;
        check(p + 2 <= n);
        const size_t skip = d[p] + size_t(d[p + 1]) * width;
        p += 2;
        data.insert(data.end(), skip, 0);
        x = data.size() % width;
      } else {  // absolute run; RLE4 reads byte / 2 bytes
        const size_t want = rle4 ? byte / 2 : byte;
        const size_t got = std::min(want, n - p);
        for (size_t i = 0; i < got; ++i) {
          if (rle4) {
            data.push_back(d[p + i] >> 4);
            data.push_back(d[p + i] & 15);
          } else {
            data.push_back(d[p + i]);
          }
        }
        p += got;
        if (got < want) break;
        x += byte;
        if (p % 2) ++p;
      }
    }
    check(data.size() >= dest);  // PIL: "not enough image data"
    for (int64_t r = 0; r < height; ++r) {
      const int64_t y = direction < 0 ? height - 1 - r : r;
      std::memcpy(out.row(y), data.data() + size_t(r) * width, width);
    }
    return out;
  }

  const uint64_t stride = ((uint64_t(width) * bits + 31) >> 3) & ~uint64_t(3);
  const uint64_t row_bytes = (uint64_t(width) * layout.bits + 7) / 8;
  check(stride >= row_bytes);  // PIL's raw decoder: a negative skip
  check(offset + (height - 1) * stride + row_bytes <= n, kTruncated);
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* src = d + offset + r * stride;
    uint8_t* o = out.row(direction < 0 ? height - 1 - r : r);
    if (mode == kModeP || mode == kModeL || mode == kMode1) {
      const int b = layout.bits;
      for (int64_t x = 0; x < width; ++x) {
        int v;
        if (b == 8) {
          v = src[x];
        } else {
          const int64_t bit = x * b;
          v = (src[bit >> 3] >> (8 - b - (bit & 7))) & ((1 << b) - 1);
        }
        o[x] = mode == kMode1 ? (v ? 255 : 0) : v;
      }
    } else if (layout.bits == 16) {
      const bool is565 = layout.rgb16 == 565;
      for (int64_t x = 0; x < width; ++x) {
        const uint32_t v = le16(src + 2 * x);
        uint8_t* px = o + 3 * x;
        if (is565) {
          px[0] = ((v >> 11) & 31) * 255 / 31;
          px[1] = ((v >> 5) & 63) * 255 / 63;
        } else {
          px[0] = ((v >> 10) & 31) * 255 / 31;
          px[1] = ((v >> 5) & 31) * 255 / 31;
        }
        px[2] = (v & 31) * 255 / 31;
      }
    } else {
      const int step = layout.bits / 8;
      for (int64_t x = 0; x < width; ++x) {
        const uint8_t* s = src + step * x;
        uint8_t* px = o + 3 * x;
        px[0] = s[layout.r];
        px[1] = s[layout.g];
        px[2] = s[layout.b];
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// GIF (PIL's GifImagePlugin, first frame, and GifDecode.c)
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* d;
  size_t n, pos;
  // Up to `count` bytes from the position on (fewer at the end of the data).
  size_t read(size_t count, const uint8_t** at) {
    const size_t start = std::min(pos, n);
    const size_t got = std::min(count, n - start);
    *at = d + start;
    pos = start + got;
    return got;
  }
  int byte() {  // the next byte, or -1 at the end
    const uint8_t* at;
    return read(1, &at) ? *at : -1;
  }
};

// PIL's _is_palette_needed: false for the grey ramp 0, 1, 2, ...; raises
// (chained comparisons reach past a short last entry) where PIL raises.
bool gif_palette_needed(const uint8_t* p, size_t len) {
  for (size_t i = 0; i < len; i += 3) {
    if (p[i] != i / 3) return true;
    check(i + 1 < len);
    if (p[i + 1] != p[i]) return true;
    check(i + 2 < len);
    if (p[i + 2] != p[i]) return true;
  }
  return false;
}

// One data sub-block (PIL's GifImageFile.data): its bytes, or nothing at
// a zero length byte or the end of the data (returns false then).
bool gif_sub_block(Reader& r, const uint8_t** at, size_t* len) {
  const int size = r.byte();
  if (size <= 0) return false;
  *len = r.read(size, at);
  return true;
}

void gif_lzw(const uint8_t* data, size_t bytes, int bits, bool interlace,
             Raster& out, int64_t x0, int64_t y0, int64_t xsize,
             int64_t ysize) {
  // GifDecode.c, fed all of the remaining file at once: PIL feeds it in
  // reads, but it only ever takes whole sub-blocks, so the result is the
  // same.  The image is done at its last pixel; an end code before it, or
  // running out of data, is PIL's "image file is truncated".
  check(bits >= 0 && bits <= 12);
  constexpr int kTable = 4096, kBuffer = 4096, kMaxBits = 12;
  std::vector<uint8_t> data_of(kTable), buffer(kBuffer);
  std::vector<uint16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0, bufferindex = kBuffer;
  int lastdata = 0, lastcode = 0, state = 1;
  int step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int64_t x = 0, y = 0;
  size_t ptr = 0;
  uint8_t single = 0;
  uint8_t* row = out.row(y0) + x0;

  // GifDecode.c's NEWLINE: false once the image is complete.
  auto newline = [&]() {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    row = out.row(y0 + y) + x0;
    return true;
  };

  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kBuffer;
      state = 2;
    }
    const uint8_t* p;
    int count;
    if (bufferindex < kBuffer) {
      count = kBuffer - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kBuffer;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= uint32_t(data[ptr++]) << bitcount;
          --blocksize;
          bitcount += 8;
        } else {
          check(ptr < bytes, kTruncated);
          const int c = data[ptr];
          check(bytes - ptr >= size_t(c) + 1, kTruncated);
          blocksize = c;
          ++ptr;
        }
      }
      int c = int(bitbuffer & codemask);
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      // The end code before the last row: PIL's decoder waits for data
      // that never comes ("image file is truncated").
      check(c != end, kTruncated);
      count = 1;
      if (state == 2) {
        check(c <= clear);
        lastdata = lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        check(c <= next);
        if (c == next) {
          check(bufferindex > 0);
          buffer[--bufferindex] = uint8_t(lastdata);
          c = lastcode;
        }
        while (c >= clear) {
          check(bufferindex > 0 && c < kTable);
          buffer[--bufferindex] = data_of[c];
          c = link[c];
        }
        lastdata = c;
        if (next < kTable) {
          data_of[next] = uint8_t(c);
          link[next] = uint16_t(lastcode);
          if (next == codemask && codesize < kMaxBits) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
      }
      single = uint8_t(lastdata);
      p = &single;
    }
    for (int i = 0; i < count; ++i) {
      row[x] = p[i];
      if (++x >= xsize && !newline()) return;
    }
  }
}

Raster decode_gif(const uint8_t* d, size_t n) {
  check(n >= 13, kTruncated);
  int64_t width = le16(d + 6), height = le16(d + 8);
  const int flags = d[10];
  Reader r{d, n, 13};
  std::vector<uint8_t> global;
  bool has_global = false;
  if (flags & 128) {
    const uint8_t* p;
    const size_t got = r.read(size_t(3) << ((flags & 7) + 1), &p);
    if (gif_palette_needed(p, got)) {
      global.assign(p, p + got);
      has_global = true;
    }
  }
  int s = r.byte();
  check(s >= 0 && s != ';', kCorrupt);  // "no more images in GIF file"
  int transparency = -1;
  bool found = false, interlace = false;
  int palette_state = 0;  // 0: none, 1: local table, 2: local grey ramp
  std::vector<uint8_t> local;
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int lzw_bits = 0;
  for (;;) {
    if (s < 0) s = r.byte();
    if (s < 0 || s == ';') break;
    if (s == '!') {
      const int label = r.byte();
      check(label >= 0);
      const uint8_t* block;
      size_t len = 0;
      const bool has = gif_sub_block(r, &block, &len);
      if (label == 249 && has) {
        check(len >= 1);
        if (block[0] & 1) {
          check(len >= 4);
          transparency = block[3];
        }
        check(len >= 3);  // the delay, an i16 at byte 1
      } else if (label == 254) {
        bool more = has && len > 0;
        while (more) more = gif_sub_block(r, &block, &len) && len > 0;
        s = -1;
        continue;
      }
      while (gif_sub_block(r, &block, &len) && len > 0) {
      }
    } else if (s == ',') {
      const uint8_t* q;
      const size_t got = r.read(9, &q);
      check(got >= 8);
      x0 = le16(q);
      y0 = le16(q + 2);
      x1 = x0 + le16(q + 4);
      y1 = y0 + le16(q + 6);
      check(got == 9);
      if (x1 > width || y1 > height) {
        width = std::max(x1, width);
        height = std::max(y1, height);
        check(uint64_t(width) * uint64_t(height) <= kMaxPixels, kTooLarge);
      }
      const int frame_flags = q[8];
      interlace = frame_flags & 64;
      if (frame_flags & 128) {
        const uint8_t* p;
        const size_t pal = r.read(size_t(3) << ((frame_flags & 7) + 1), &p);
        if (gif_palette_needed(p, pal)) {
          local.assign(p, p + pal);
          palette_state = 1;
        } else {
          palette_state = 2;
        }
      }
      lzw_bits = r.byte();
      check(lzw_bits >= 0);
      found = true;
      break;
    }
    s = -1;
  }
  check(found);  // "image not found in GIF frame"
  check(uint64_t(width) * uint64_t(height) <= kMaxPixels, kTooLarge);
  // A local table that is the grey ramp leaves the frame in mode L, but PIL
  // then puts the global palette (where there is one) on it, which makes it
  // mode P again.
  const bool paletted = palette_state == 1 || has_global;
  Raster out;
  out.allocate(paletted ? kModeP : kModeL, height, width);
  if (paletted) {
    const std::vector<uint8_t>& pal = palette_state == 1 ? local : global;
    out.palette.assign(pal.begin(), pal.begin() + pal.size() / 3 * 3);
  }
  if (transparency >= 0)
    std::fill(out.pixels.begin(), out.pixels.end(), uint8_t(transparency));
  check(x1 > x0 && y1 > y0);  // "tile cannot extend outside image"
  gif_lzw(d + r.pos, n - r.pos, lzw_bits, interlace, out, x0, y0, x1 - x0,
          y1 - y0);
  return out;
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// TIFF (PIL's TiffImagePlugin; libtiff 4.7 for compressed files)
// ---------------------------------------------------------------------------

bool is_tiff(const uint8_t* d) {
  static const char* const kPrefixes[] = {"MM\x00\x2a", "II\x2a\x00",
                                          "MM\x2a\x00", "II\x00\x2a",
                                          "MM\x00\x2b", "II\x2b\x00"};
  for (const char* p : kPrefixes)
    if (std::memcmp(d, p, 4) == 0) return true;
  return false;
}

struct TiffTag {
  int type = 0;
  std::vector<uint8_t> data;  // the value's bytes, as stored
  // libtiff's strip and tile arrays, read when their length is known:
  // the declared count and where the values lie.
  uint64_t count = 0, offset = 0;
  bool at_offset = false;
  int source = 0;  // the tag the array came from (strip or tile)
};

// How a reading takes the types PIL loads as other than integers.
enum TiffAlso {
  kBytes = 1,        // BYTE, which PIL keeps as bytes, as its unsigned
                     // values (PIL iterates the offsets and the colour
                     // map; libtiff reads BYTE as an integer)
  kWholeNumbers = 2  // RATIONAL, SRATIONAL, FLOAT, DOUBLE as integers
                     // where every value is whole (PIL's dictionary keys
                     // take 2.0 as 2)
};

// The tags of one IFD, as PIL's ImageFileDirectory_v2.load keeps them.
struct Ifd {
  bool be = false, big = false;
  std::vector<std::pair<int, TiffTag>> tags;
  bool libtiff_refuses = false;  // libtiff's reading of it fails
  int also = 0;                  // TiffAlso bits every reading takes
  // libtiff's EstimateStripByteCounts: the bytes of the header, the
  // directory and the values stored apart from it, and whether an entry
  // of a type of no known size (or a size past 64 bits) fails it.
  uint64_t directory_space = 0;
  bool estimate_fails = false;

  uint64_t u(const uint8_t* p, int bytes) const {
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i)
      v |= uint64_t(p[be ? bytes - 1 - i : i]) << (8 * i);
    return v;
  }
  const TiffTag* find(int tag) const {
    for (const auto& t : tags)
      if (t.first == tag) return &t.second;
    return nullptr;
  }
  // The values of a RATIONAL, SRATIONAL, FLOAT or DOUBLE tag as PIL loads
  // them (a zero denominator is NaN).
  std::vector<double> numbers(const TiffTag& t) const {
    std::vector<double> out;
    const size_t unit = t.type == 11 ? 4 : 8;
    for (size_t i = 0; i + unit <= t.data.size(); i += unit) {
      const uint8_t* p = t.data.data() + i;
      if (t.type == 11 || t.type == 12) {
        const uint64_t bits = u(p, int(unit));
        if (unit == 4) {
          float f;
          const uint32_t b32 = uint32_t(bits);
          std::memcpy(&f, &b32, 4);
          out.push_back(f);
        } else {
          double f;
          std::memcpy(&f, &bits, 8);
          out.push_back(f);
        }
      } else {
        const uint64_t num = u(p, 4), den = u(p + 4, 4);
        const double n = t.type == 10 ? double(int32_t(num)) : double(num);
        const double d = t.type == 10 ? double(int32_t(den)) : double(den);
        out.push_back(den ? n / d : std::nan(""));
      }
    }
    return out;
  }
  // The integer values of a tag (SHORT, LONG, LONG8, the signed types and
  // IFD, and the types `extra` adds to this reading's); false when it is
  // absent, true with ok = false when it holds another type (bytes, text,
  // rationals or floats), which PIL's setup cannot use where these tags
  // are read.
  bool ints(int tag, std::vector<int64_t>* out, bool* ok,
            int extra = 0) const {
    const TiffTag* t = find(tag);
    if (!t) return false;
    *ok = values(*t, out, extra);
    return true;
  }
  // The integer values of one entry, or false (see ints).
  bool values(const TiffTag& t, std::vector<int64_t>* out,
              int extra = 0) const {
    const int with = also | extra;
    int unit;
    bool is_signed = false;
    switch (t.type) {
      case 1:
        if (!(with & kBytes)) return false;
        unit = 1;
        break;
      case 3: unit = 2; break;
      case 4: case 13: unit = 4; break;
      case 16: case 17: unit = 8; break;
      case 6: unit = 1; is_signed = true; break;
      case 8: unit = 2; is_signed = true; break;
      case 9: unit = 4; is_signed = true; break;
      case 5: case 10: case 11: case 12:
        if (!(with & kWholeNumbers)) return false;
        out->clear();
        for (double f : numbers(t)) {
          if (!(std::fabs(f) < 9e18 && std::floor(f) == f)) return false;
          out->push_back(int64_t(f));
        }
        return true;
      default: return false;
    }
    out->clear();
    for (size_t i = 0; i + unit <= t.data.size(); i += unit) {
      uint64_t v = u(t.data.data() + i, unit);
      if (is_signed && unit < 8 && (v >> (8 * unit - 1)))
        v |= ~uint64_t(0) << (8 * unit);
      out->push_back(int64_t(v));
    }
    return true;
  }
  // A tag PIL keeps as one value (its first, when there are more).
  int64_t scalar(int tag, int64_t fallback, int extra = 0) const {
    std::vector<int64_t> v;
    bool ok;
    if (!ints(tag, &v, &ok, extra)) return fallback;
    check(ok && !v.empty(), kTiffUnsupported);
    return v[0];
  }
  std::vector<int64_t> tuple(int tag, std::vector<int64_t> fallback,
                             int extra = 0) const {
    std::vector<int64_t> v;
    bool ok;
    if (!ints(tag, &v, &ok, extra)) return fallback;
    check(ok, kTiffUnsupported);
    return v;
  }
  // The first value of a tag as a number PIL compares (NaN for bytes or
  // text, which equal no number).
  double number(int tag, double fallback) const {
    const TiffTag* t = find(tag);
    if (!t) return fallback;
    std::vector<int64_t> v;
    bool ok;
    ints(tag, &v, &ok);
    if (ok) return v.empty() ? std::nan("") : double(v[0]);
    if (t->type == 5 || t->type == 10 || t->type == 11 || t->type == 12) {
      const std::vector<double> x = numbers(*t);
      return x.empty() ? std::nan("") : x[0];
    }
    return std::nan("");
  }
};

// Whether libtiff's 16- or 32-bit field for the tag holds every value of
// the entry (a negative value or one past the field is a bad entry).
bool lt_in_range(const Ifd& lt, int tag, const TiffTag& t) {
  const bool wide = tag == 256 || tag == 257 || tag == 278 || tag == 322 ||
                    tag == 323;
  const bool narrow = tag == 258 || tag == 259 || tag == 262 || tag == 266 ||
                      tag == 277 || tag == 280 || tag == 281 || tag == 284 ||
                      tag == 317 || tag == 320 || tag == 338 || tag == 339 ||
                      tag == 32996;
  if (!wide && !narrow) return true;
  std::vector<int64_t> v;
  lt.values(t, &v);  // only integer entries reach here
  const int64_t top = wide ? 0xFFFFFFFF : 0xFFFF;
  const bool is_unsigned64 = t.type == 16;
  for (int64_t x : v)
    if (is_unsigned64 ? uint64_t(x) > uint64_t(top) : x < 0 || x > top)
      return false;
  return true;
}

// Reads the first IFD twice over, as the two readers behind PIL read it:
//   * `pil`, PIL's ImageFileDirectory_v2.load, which decides the mode and,
//     for an uncompressed file, the strips: entries of unknown types and
//     empty values are skipped, a later entry of a tag replaces an earlier
//     one, and a read past the end of the data ends the directory (the
//     entries read so far stay);
//   * `lt`, libtiff's TIFFReadDirectory, which finds the strips of a
//     compressed file: the first entry of a tag counts, only integer types
//     are read, a bad entry of an optional tag is passed over, and a
//     directory whose entries run past the end of the data, or a bad entry
//     (type, count or value past the end) of a required tag, is refused.
void read_ifd(const uint8_t* d, size_t n, uint64_t at, Ifd& pil, Ifd& lt) {
  static const int kUnit[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4,
                                0, 0, 8, 8, 8};
  // Tags whose bad entry fails libtiff's directory.
  static const int kRequired[] = {256, 257, 258, 259, 273, 277, 278, 279,
                                  280, 281, 284, 322, 323, 324, 325, 338,
                                  339, 340, 341, 32996};
  // One value only (Compression may also give one a sample: decode_tiff).
  static const int kScalar[] = {256, 257, 262, 266, 277, 278, 284, 317,
                                322, 323};
  const int count_bytes = pil.big ? 8 : 2, entry = pil.big ? 20 : 12;
  const int inline_bytes = pil.big ? 8 : 4;
  lt.be = pil.be;
  lt.big = pil.big;
  lt.also = kBytes;
  lt.libtiff_refuses = true;
  if (at > n || n - at < size_t(count_bytes)) return;
  const uint64_t count = pil.u(d + at, count_bytes);
  size_t pos = at + count_bytes;
  lt.libtiff_refuses = count > (n - pos) / entry;
  lt.directory_space = (pil.big ? 16 + 8 + 8 : 8 + 2 + 4) + count * entry;
  bool pil_reading = true;
  for (uint64_t i = 0; i < count && n - pos >= size_t(entry); ++i) {
    const uint8_t* e = d + pos;
    pos += entry;
    const int tag = int(pil.u(e, 2)), type = int(pil.u(e + 2, 2));
    const uint64_t values = pil.u(e + 4, pil.big ? 8 : 4);
    const int width = type <= 18 ? kUnit[type] : 0;
    if (width == 0 || values > ~uint64_t(0) / width) {
      lt.estimate_fails = true;
    } else if (values * width > uint64_t(inline_bytes)) {
      lt.estimate_fails |= lt.directory_space > ~uint64_t(0) - values * width;
      lt.directory_space += values * width;
    }
    const uint8_t* value = e + (pil.big ? 12 : 8);
    const bool known = type <= 18 && kUnit[type] != 0;
    // The value's bytes, where they lie inside the data.
    TiffTag t;
    t.type = type;
    bool readable = false;
    if (known && values <= n) {
      const uint64_t size = values * kUnit[type];
      if (size <= uint64_t(inline_bytes)) {
        t.data.assign(value, value + size);
        readable = true;
      } else {
        const uint64_t off = pil.u(value, inline_bytes);
        if (off <= n && n - off >= size) {
          t.data.assign(d + off, d + off + size);
          readable = true;
        }
      }
    }
    // libtiff keeps one array of offsets and one of byte counts: of the
    // strip and the tile tag, the later entry fills it (a repeated entry
    // of one tag is passed over, as any repeated tag is).
    const bool strile = tag == 273 || tag == 279 || tag == 324 || tag == 325;
    const int lt_tag = tag == 324 ? 273 : tag == 325 ? 279 : tag;
    for (auto it = lt.tags.begin(); strile && it != lt.tags.end(); ++it)
      if (it->first == lt_tag && it->second.source != tag) {
        lt.tags.erase(it);
        break;
      }
    if (!lt.find(lt_tag)) {
      // The integer types libtiff reads these tags from (not IFD or IFD8).
      const bool integer = type == 1 || type == 3 || type == 4 ||
                           type == 6 || type == 8 || type == 9 ||
                           type == 16 || type == 17;
      auto in = [tag](const int* first_tag, const int* last_tag) {
        return std::find(first_tag, last_tag, tag) != last_tag;
      };
      const bool required = in(std::begin(kRequired), std::end(kRequired));
      const bool scalar = in(std::begin(kScalar), std::end(kScalar));
      if (strile && integer) {  // a count of 0 is padded like a short one
        TiffTag a;
        a.type = type;
        a.source = tag;
        a.count = values;
        a.at_offset = values > uint64_t(inline_bytes) / kUnit[type];
        if (a.at_offset)
          a.offset = pil.u(value, inline_bytes);
        else
          a.data.assign(value, value + values * kUnit[type]);
        lt.tags.emplace_back(lt_tag, a);
      } else if ((tag == 340 || tag == 341) && readable && values > 0 &&
                 (integer || (type >= 10 && type <= 12) || type == 5)) {
        // SMin/SMaxSampleValue, read as doubles: one a sample, checked
        // once SamplesPerPixel is known.
        t.count = values;
        lt.tags.emplace_back(tag, t);
      } else if (known && integer && readable && values > 0 &&
                 (!scalar || values == 1) && lt_in_range(lt, tag, t)) {
        lt.tags.emplace_back(tag, t);
      } else if (required) {
        lt.libtiff_refuses = true;
      }
    }
    // PIL has no loader for the BigTIFF types SLONG8 and IFD8.
    if (!pil_reading || !known || type > 16) continue;
    // PIL seeks to a value that is not inline before it reads it: a
    // BigTIFF offset past 2^63 is an OverflowError, and the file fails.
    if (values > uint64_t(inline_bytes) / kUnit[type])
      check(pil.u(value, inline_bytes) >> 63 == 0);
    if (!readable) {  // PIL's _safe_read of it fails
      pil_reading = false;
      continue;
    }
    if (t.data.empty()) continue;
    bool replaced = false;
    for (auto& old : pil.tags)
      if (old.first == tag) {
        old.second = t;
        replaced = true;
      }
    if (!replaced) pil.tags.emplace_back(tag, t);
  }
}

// A strip or tile array as libtiff reads it for `nstrips` strips: at most
// that many values, zeros after a shorter one; refused where the values
// lie past the end of the data.
std::vector<int64_t> strile_array(const Ifd& lt, int tag, int64_t nstrips,
                                  const uint8_t* d, size_t n) {
  const TiffTag* t = lt.find(tag);
  // libtiff pads a short array with zeros up to a million strips.
  check(t != nullptr && nstrips > 0 &&
            (t->count >= uint64_t(nstrips) || nstrips <= 1000000),
        kCorrupt);
  const int unit = t->type == 3 || t->type == 8   ? 2
                   : t->type == 1 || t->type == 6 ? 1
                   : t->type >= 16                ? 8
                                                  : 4;
  const uint64_t take = std::min<uint64_t>(t->count, uint64_t(nstrips));
  const uint8_t* src = t->data.data();
  if (t->at_offset) {
    check(t->offset <= n && (n - t->offset) / unit >= take, kCorrupt);
    src = d + t->offset;
  }
  std::vector<int64_t> out(size_t(nstrips), 0);
  const bool is_signed = t->type == 6 || t->type == 8 || t->type == 9;
  for (uint64_t i = 0; i < take; ++i) {
    const uint64_t v = lt.u(src + i * unit, unit);
    // libtiff refuses a negative offset or count ("bad value").
    check(!is_signed || !(v >> (8 * unit - 1)), kCorrupt);
    out[i] = int64_t(v);
  }
  return out;
}

// One of PIL's TIFF raw modes: how the stored samples of a pixel unpack
// into the samples of the mode.
struct RawMode {
  int mode;
  int bits;            // bits of a stored sample
  int samples;         // stored samples per pixel
  const char* order;   // per stored sample: its band in the mode ('0'-'3'),
                       // or 'x' when dropped
  bool big = false;    // multi-byte samples big-endian
  bool invert = false; // min-is-white
  bool reverse = false;  // FillOrder 2: bits reversed within each byte
  bool premultiplied = false;  // RGBa
  bool sign = false;   // signed integer samples
  bool is_float = false;
  bool packed12 = false;  // PIL's "I;12"
};

struct OpenInfo {
  int order;  // 0 II and MM, 1 II only, 2 MM only
  int photo, sample_format, fill;
  std::vector<int> bps, extra;
  int mode;
  RawMode raw;
};

const std::vector<OpenInfo>& open_info() {
  // PIL's OPEN_INFO (TiffImagePlugin.py), keyed by byte order, photometric,
  // sample format, fill order, bits per sample and extra samples.
  static const std::vector<OpenInfo> table = [] {
    std::vector<OpenInfo> t;
    auto add = [&](int order, int photo, int sf, int fill,
                   std::vector<int> bps, std::vector<int> extra, RawMode raw) {
      t.push_back({order, photo, sf, fill, bps, extra, raw.mode, raw});
    };
    auto grey = [](int mode, int bits, bool inv, bool rev) {
      RawMode r{mode, bits, 1, "0"};
      r.invert = inv;
      r.reverse = rev;
      return r;
    };
    for (int photo = 0; photo < 2; ++photo)
      for (int fill = 1; fill <= 2; ++fill) {
        const bool inv = photo == 0, rev = fill == 2;
        add(0, photo, 1, fill, {1}, {}, grey(kMode1, 1, inv, rev));
        add(0, photo, 1, fill, {2}, {}, grey(kModeL, 2, inv, rev));
        add(0, photo, 1, fill, {4}, {}, grey(kModeL, 4, inv, rev));
        add(0, photo, 1, fill, {8}, {}, grey(kModeL, 8, inv, rev));
      }
    add(0, 1, 2, 1, {8}, {}, grey(kModeL, 8, false, false));
    {
      RawMode r{kModeI16, 12, 1, "0"};
      r.packed12 = true;
      add(1, 1, 1, 1, {12}, {}, r);
    }
    add(1, 0, 1, 1, {16}, {}, RawMode{kModeI16, 16, 1, "0"});
    add(1, 1, 1, 1, {16}, {}, RawMode{kModeI16, 16, 1, "0"});
    {
      RawMode r{kModeI16, 16, 1, "0"};
      r.big = true;
      add(2, 1, 1, 1, {16}, {}, r);
      RawMode rv{kModeI16, 16, 1, "0"};
      rv.reverse = true;
      add(1, 1, 1, 2, {16}, {}, rv);
      RawMode s{kModeI, 16, 1, "0"};
      s.sign = true;
      add(1, 1, 2, 1, {16}, {}, s);
      s.big = true;
      add(2, 1, 2, 1, {16}, {}, s);
      RawMode f{kModeF, 32, 1, "0"};
      f.is_float = true;
      for (int photo = 0; photo < 2; ++photo) {
        f.big = false;
        add(1, photo, 3, 1, {32}, {}, f);
        f.big = true;
        add(2, photo, 3, 1, {32}, {}, f);
      }
      RawMode i32{kModeI, 32, 1, "0"};
      add(1, 1, 1, 1, {32}, {}, i32);
      i32.sign = true;
      add(1, 1, 2, 1, {32}, {}, i32);
      i32.big = true;
      add(2, 1, 2, 1, {32}, {}, i32);
    }
    add(0, 1, 1, 1, {8, 8}, {2}, RawMode{kModeLA, 8, 2, "01"});
    add(0, 2, 1, 1, {8, 8, 8}, {}, RawMode{kModeRGB, 8, 3, "012"});
    {
      RawMode r{kModeRGB, 8, 3, "012"};
      r.reverse = true;
      add(0, 2, 1, 2, {8, 8, 8}, {}, r);
    }
    add(0, 2, 1, 1, {8, 8, 8, 8}, {}, RawMode{kModeRGBA, 8, 4, "0123"});
    add(0, 2, 1, 1, {8, 8, 8, 8}, {0}, RawMode{kModeRGB, 8, 4, "012x"});
    add(0, 2, 1, 1, {8, 8, 8, 8, 8}, {0, 0}, RawMode{kModeRGB, 8, 5, "012xx"});
    add(0, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {0, 0, 0},
        RawMode{kModeRGB, 8, 6, "012xxx"});
    {
      RawMode r{kModeRGBA, 8, 4, "0123"};
      r.premultiplied = true;
      add(0, 2, 1, 1, {8, 8, 8, 8}, {1}, r);
      r.samples = 5;
      r.order = "0123x";
      add(0, 2, 1, 1, {8, 8, 8, 8, 8}, {1, 0}, r);
      r.samples = 6;
      r.order = "0123xx";
      add(0, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {1, 0, 0}, r);
    }
    add(0, 2, 1, 1, {8, 8, 8, 8}, {2}, RawMode{kModeRGBA, 8, 4, "0123"});
    add(0, 2, 1, 1, {8, 8, 8, 8, 8}, {2, 0}, RawMode{kModeRGBA, 8, 5, "0123x"});
    add(0, 2, 1, 1, {8, 8, 8, 8, 8, 8}, {2, 0, 0},
        RawMode{kModeRGBA, 8, 6, "0123xx"});
    add(0, 2, 1, 1, {8, 8, 8, 8}, {999}, RawMode{kModeRGBA, 8, 4, "0123"});
    for (int big = 0; big < 2; ++big) {
      const int order = big ? 2 : 1;
      RawMode r{kModeRGB, 16, 3, "012"};
      r.big = big;
      add(order, 2, 1, 1, {16, 16, 16}, {}, r);
      RawMode a{kModeRGBA, 16, 4, "0123"};
      a.big = big;
      add(order, 2, 1, 1, {16, 16, 16, 16}, {}, a);
      add(order, 2, 1, 1, {16, 16, 16, 16}, {2}, a);
      RawMode x{kModeRGB, 16, 4, "012x"};
      x.big = big;
      add(order, 2, 1, 1, {16, 16, 16, 16}, {0}, x);
      RawMode p{kModeRGBA, 16, 4, "0123"};
      p.big = big;
      p.premultiplied = true;
      add(order, 2, 1, 1, {16, 16, 16, 16}, {1}, p);
      RawMode c{kModeCMYK, 16, 4, "0123"};
      c.big = big;
      add(order, 5, 1, 1, {16, 16, 16, 16}, {}, c);
    }
    for (int fill = 1; fill <= 2; ++fill) {
      const bool rev = fill == 2;
      for (int bits : {1, 2, 4}) {
        RawMode r{kModeP, bits, 1, "0"};
        r.reverse = rev;
        add(0, 3, 1, fill, {bits}, {}, r);
      }
      RawMode r{kModeP, 8, 1, "0"};
      r.reverse = rev;
      add(0, 3, 1, fill, {8}, {}, r);
    }
    add(0, 3, 1, 1, {8, 8}, {0}, RawMode{kModeP, 8, 2, "0x"});
    add(0, 3, 1, 1, {8, 8}, {2}, RawMode{kModePA, 8, 2, "01"});
    add(0, 5, 1, 1, {8, 8, 8, 8}, {}, RawMode{kModeCMYK, 8, 4, "0123"});
    add(0, 5, 1, 1, {8, 8, 8, 8, 8}, {0}, RawMode{kModeCMYK, 8, 5, "0123x"});
    add(0, 5, 1, 1, {8, 8, 8, 8, 8, 8}, {0, 0},
        RawMode{kModeCMYK, 8, 6, "0123xx"});
    return t;
  }();
  return table;
}

inline uint8_t reverse_bits(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// Unpacks `count` pixels of one row (`src`, whose samples hold `raw`) into
// the mode's pixels at `dst`, as PIL's unpacker of that raw mode does.  With
// `band` >= 0 the row holds one plane (PlanarConfiguration 2) of that band.
void unpack_row(const RawMode& raw, const uint8_t* src, int64_t count,
                uint8_t* dst, int band, int plane_bits) {
  const int mode = raw.mode;
  const int channels = kModeChannels[mode];
  const size_t px_bytes = channels * kModeBytes[mode];
  if (band >= 0) {
    // One plane of one band, at plane_bits: 1 (0 or 255), 8, 16 (its high
    // byte) or 32 (a whole sample of mode I or F, little-endian).
    for (int64_t x = 0; x < count; ++x) {
      uint8_t* o = dst + x * px_bytes;
      if (plane_bits == 32) {
        std::memcpy(o, src + 4 * x, 4);
      } else if (plane_bits == 16) {
        o[band] = raw.big ? src[2 * x] : src[2 * x + 1];
      } else if (plane_bits == 1) {
        o[band] = (src[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
      } else {
        o[band] = src[x];
      }
    }
    return;
  }
  if (raw.packed12) {
    for (int64_t x = 0; x < count; ++x) {
      const uint8_t* in = src + (x / 2) * 3;
      const uint16_t v = x % 2 == 0 ? uint16_t((in[0] << 4) + (in[1] >> 4))
                                    : uint16_t(((in[1] & 15) << 8) + in[2]);
      std::memcpy(dst + 2 * x, &v, 2);
    }
    return;
  }
  const int bits = raw.bits;
  if (bits < 8) {
    const int mask = (1 << bits) - 1;
    for (int64_t x = 0; x < count; ++x) {
      const int64_t bit = x * bits;
      uint8_t byte = src[bit >> 3];
      if (raw.reverse) byte = reverse_bits(byte);
      int v = (byte >> (8 - bits - (bit & 7))) & mask;
      if (raw.invert) v = mask - v;
      uint8_t out;
      if (mode == kMode1) {
        out = v ? 255 : 0;
      } else if (mode == kModeL) {
        out = uint8_t(v * (255 / mask));
      } else {
        out = uint8_t(v);  // palette index
      }
      dst[x] = out;
    }
    return;
  }
  const int sb = bits / 8;
  if (sb == 1 && size_t(raw.samples) == px_bytes && !raw.invert &&
      !raw.reverse && !raw.premultiplied &&
      std::strncmp(raw.order, "0123", raw.samples) == 0) {
    std::memcpy(dst, src, size_t(count) * px_bytes);  // samples as stored
    return;
  }
  for (int64_t x = 0; x < count; ++x) {
    const uint8_t* in = src + x * raw.samples * sb;
    uint8_t* o = dst + x * px_bytes;
    if (mode == kModeI16) {
      uint16_t v = raw.big ? uint16_t(in[0] << 8 | in[1])
                           : uint16_t(in[1] << 8 | in[0]);
      if (raw.reverse)
        v = uint16_t(reverse_bits(uint8_t(v)) |
                     reverse_bits(uint8_t(v >> 8)) << 8);
      std::memcpy(o, &v, 2);
      continue;
    }
    if (mode == kModeI || mode == kModeF) {
      uint32_t v = 0;
      for (int i = 0; i < sb; ++i)
        v |= uint32_t(in[raw.big ? sb - 1 - i : i]) << (8 * i);
      if (mode == kModeI && sb == 2 && raw.sign)
        v = uint32_t(int32_t(int16_t(v)));
      std::memcpy(o, &v, 4);
      continue;
    }
    for (int s = 0; s < raw.samples; ++s) {
      if (raw.order[s] == 'x') continue;
      int v = sb == 1 ? in[s] : in[s * 2 + (raw.big ? 0 : 1)];  // high byte
      if (raw.reverse) v = reverse_bits(uint8_t(v));
      if (raw.invert) v = 255 - v;
      o[raw.order[s] - '0'] = uint8_t(v);
    }
    if (raw.premultiplied) {
      const int a = o[3];
      for (int c = 0; c < 3; ++c)
        o[c] = a == 0 ? 0 : a == 255 ? o[c]
                                     : uint8_t(std::min(255, o[c] * 255 / a));
    }
  }
}

// ---- libtiff's codecs, decoding one strip or tile to exactly `want` bytes;
// each fails where libtiff fails (PIL then raises "decoder error").

void lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  // tif_lzw.c (new-style codes: MSB-first, the width growing one code
  // early); the table as libtiff keeps it, each entry linked to its prefix.
  struct Code {
    int next;
    uint16_t length;
    uint8_t value, firstchar;
  };
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096;
  std::vector<Code> tab(kSize + 1);
  Code* const codetab = tab.data() + 1;  // codetab[-1] exists
  for (int c = 0; c < 256; ++c) codetab[c] = {-2, 1, uint8_t(c), uint8_t(c)};
  codetab[kClear] = codetab[kEoi] = {-2, 0, 0, 0};
  // Until the first clear code the table takes no entry: libtiff refuses
  // any other code there ("Using code not yet in table").
  int nbits = 9, free_ent = -1, oldcode = 0;
  int maxcode = (1 << nbits) - 2;
  uint64_t acc = 0;  // bits not yet taken, the next one highest
  int held = 0;
  size_t next_byte = 0, occ = want;
  uint8_t* op = out;
  auto next_code = [&]() -> int {
    while (held < nbits) {
      check(next_byte < n);  // the data ends before the strip: no EOI
      acc = acc << 8 | in[next_byte++];
      held += 8;
    }
    held -= nbits;
    return int(acc >> held) & ((1 << nbits) - 1);
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - 2;
      if (free_ent >= kSize) free_ent = -1;
    }
  };
  auto emit = [&](int code) {  // writes the string of `code`, cut to fit
    const int len = codetab[code].length;
    const int take = int(std::min<size_t>(len, occ));
    int c = code;
    for (int skip = len - take; skip > 0; --skip) c = codetab[c].next;
    for (int i = take - 1; i >= 0; --i) {
      op[i] = codetab[c].value;
      c = codetab[c].next;
    }
    op += take;
    occ -= take;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      maxcode = (1 << nbits) - 2;
      do code = next_code(); while (code == kClear);
      if (code == kEoi) break;
      check(code < kEoi);
      *op++ = uint8_t(code);
      --occ;
      oldcode = code;
      continue;
    }
    check(free_ent >= 0 && code <= free_ent);  // "code not yet in table"
    Code& e = codetab[free_ent];
    const Code& old = codetab[oldcode];
    e.value = code < free_ent ? codetab[code].firstchar : old.firstchar;
    if (code < 256) e.value = uint8_t(code);
    e.next = oldcode;
    e.firstchar = old.firstchar;
    e.length = uint16_t(old.length + 1);
    grow();
    oldcode = code;
    emit(code);
  }
  check(occ == 0);  // "Not enough data"
}

void deflate_decode(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  // tif_zip.c: inflate with Z_PARTIAL_FLUSH until the strip is full.
  z_stream zs{};
  check(inflateInit(&zs) == Z_OK, kMemory);
  zs.next_in = const_cast<uint8_t*>(in);
  zs.avail_in = uInt(std::min<size_t>(n, 0xFFFFFFFFu));
  zs.next_out = out;
  zs.avail_out = uInt(want);
  int rc = Z_OK;
  while (zs.avail_out > 0) {
    rc = inflate(&zs, Z_PARTIAL_FLUSH);
    if (rc != Z_OK) break;
  }
  const size_t left = zs.avail_out;
  inflateEnd(&zs);
  check(left == 0 && (rc == Z_OK || rc == Z_STREAM_END));
}

void packbits_decode(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  // tif_packbits.c: overlong runs are cut to the strip, a run the data
  // ends in stops the decode, and a short strip fails.
  size_t cc = n, occ = want;
  const uint8_t* bp = in;
  uint8_t* op = out;
  while (cc > 0 && occ > 0) {
    long count = *bp++;
    --cc;
    if (count >= 128) count -= 256;
    if (count < 0) {
      if (count == -128) continue;
      size_t run = size_t(-count + 1);
      if (occ < run) run = occ;
      if (cc == 0) break;
      occ -= run;
      const uint8_t b = *bp++;
      --cc;
      std::memset(op, b, run);
      op += run;
    } else {
      size_t run = size_t(count) + 1;
      if (occ < run) run = occ;
      if (cc < run) break;
      std::memcpy(op, bp, run);
      op += run;
      occ -= run;
      bp += run;
      cc -= run;
    }
  }
  check(occ == 0);  // "Not enough data for scanline"
}

Raster decode_tiff(const uint8_t* d, size_t n) {
  Ifd ifd;
  ifd.be = d[0] == 'M';
  ifd.big = d[2] == 43;  // PIL's test: "MM\0+" is read as classic TIFF
  const bool proper = ifd.be ? d[2] == 0 : d[3] == 0;
  uint64_t first;
  bool proper_header = proper;  // as libtiff reads a compressed file's
  if (ifd.big) {
    check(n >= 16, kTruncated);
    first = ifd.u(d + 8, 8);
    proper_header = proper && ifd.u(d + 4, 2) == 8 && ifd.u(d + 6, 2) == 0;
  } else {
    check(n >= 8, kTruncated);
    first = ifd.u(d + 4, 4);
    // libtiff reads "MM\0+" as BigTIFF, with another header.
    proper_header = proper && d[ifd.be ? 3 : 2] == 42;
  }
  check(first != 0);  // "no more images in TIFF file"
  check(first < (uint64_t(1) << 63));
  Ifd lt;
  read_ifd(d, n, first, ifd, lt);

  const int64_t compression = ifd.scalar(259, 1, kWholeNumbers);
  switch (compression) {
    case 1: case 5: case 8: case 32946: case 32773:
      break;
    case 2: case 3: case 4: fail(kTiffCcitt);
    case 6: case 7: fail(kTiffJpeg);
    case 34925: fail(kTiffLzma);
    case 50000: fail(kTiffZstd);
    case 50001: fail(kTiffWebp);
    case 32771: case 32809: case 34676: case 34677: fail(kTiffOtherCodec);
    default: fail(kTiffUnsupported);  // not in PIL's COMPRESSION_INFO
  }
  const bool raw_path = compression == 1;
  // PIL only compares PlanarConfiguration with 1 and 2.
  const double planar_value = ifd.number(284, 1);
  const int64_t planar =
      planar_value == 1 || planar_value == 2 ? int64_t(planar_value) : 0;
  const int64_t photo = ifd.scalar(262, 0, kWholeNumbers);
  const int64_t fill = ifd.scalar(266, 1, kWholeNumbers);
  std::vector<int64_t> v;
  bool ok;
  check(ifd.ints(256, &v, &ok) && ifd.ints(257, &v, &ok), kTiffUnsupported);
  const int64_t xsize = ifd.scalar(256, 0), ysize = ifd.scalar(257, 0);
  int64_t orientation = 1;  // not an integer: PIL applies none
  if (ifd.ints(274, &v, &ok) && ok && !v.empty()) orientation = v[0];
  std::vector<int64_t> sample_format = ifd.tuple(339, {1}, kWholeNumbers);
  if (sample_format.size() > 1 &&
      *std::max_element(sample_format.begin(), sample_format.end()) == 1 &&
      *std::min_element(sample_format.begin(), sample_format.end()) == 1)
    sample_format = {1};
  std::vector<int64_t> bps = ifd.tuple(258, {1}, kWholeNumbers);
  const std::vector<int64_t> extra = ifd.tuple(338, {}, kWholeNumbers);
  int bps_count = photo == 2 || photo == 6 || photo == 8 ? 3
                  : photo == 5                           ? 4
                                                         : 1;
  bps_count += int(extra.size());
  const int64_t spp = ifd.scalar(277, 1);
  check(spp <= 6, kTiffUnsupported);
  if (spp < int64_t(bps.size())) {
    bps.resize(std::max<int64_t>(spp, 0));
  } else if (spp > int64_t(bps.size()) && bps.size() == 1) {
    bps.assign(spp, bps[0]);
  }
  check(int64_t(bps.size()) == spp, kTiffUnsupported);

  // The OPEN_INFO key; libtiff reads FillOrder 2 itself (the key of
  // FillOrder 1, the compressed bytes reversed).
  const OpenInfo* info = nullptr;
  auto same = [](const std::vector<int>& a, const std::vector<int64_t>& b) {
    if (a.size() != b.size()) return false;
    for (size_t i = 0; i < a.size(); ++i)
      if (a[i] != b[i]) return false;
    return true;
  };
  auto lookup = [&](int64_t fill_order) -> const OpenInfo* {
    if (sample_format.size() != 1) return nullptr;
    for (const OpenInfo& e : open_info()) {
      if ((e.order == 1 && ifd.be) || (e.order == 2 && !ifd.be)) continue;
      if (e.photo == photo && e.sample_format == sample_format[0] &&
          e.fill == fill_order && same(e.bps, bps) && same(e.extra, extra))
        return &e;
    }
    return nullptr;
  };
  info = lookup(fill);
  if (!info) {
    if (photo == 6) fail(kTiffYcbcr);
    if (photo == 8) fail(kTiffLab);
    fail(kTiffUnsupported);  // "unknown pixel mode"
  }
  RawMode raw = info->raw;
  // PIL has no unpacker for the raw modes "P;1R", "P;2R" and "P;4R".
  if (raw_path)
    check(!(raw.mode == kModeP && raw.bits < 8 && raw.reverse),
          kTiffUnsupported);
  if (!raw_path) {
    if (fill == 2) {
      info = lookup(1);
      check(info != nullptr, kTiffUnsupported);
      raw = info->raw;
    }
    // libtiff hands PIL 16-bit samples in the machine's order, which PIL's
    // ";16N" raw modes read; its other multi-byte samples are swapped too,
    // but PIL still reads them in the file's order.
    if (raw.bits == 16 && !raw.sign) raw.big = false;
  }

  Raster out;
  out.allocate(info->mode, ysize, xsize);
  out.orientation = int(orientation);
  if (info->mode == kModeP || info->mode == kModePA) {
    const std::vector<int64_t> cmap = ifd.tuple(320, {}, kBytes);
    check(ifd.find(320) != nullptr, kTiffUnsupported);
    const size_t entries = cmap.size() / 3;
    check(entries <= 256);  // PIL: "invalid palette size"
    for (size_t i = 0; i < entries; ++i)
      for (int c = 0; c < 3; ++c)
        out.palette.push_back(uint8_t((cmap[c * entries + i] >> 8) & 255));
  }
  const int channels_bits = raw.bits * raw.samples;

  if (raw_path) {
    std::vector<int64_t> offsets;
    // A tile's size as PIL's raw decoder sees it.  Unsigned: a LONG8 past
    // 2^63 is a large size, not a negative.  A negative size of a signed
    // type gives tile extents the decoder refuses; so does a fractional
    // RowsPerStrip (RATIONAL, FLOAT) within the image, while one past it
    // acts as any larger size.  A fractional tile size PIL refuses
    // ("Invalid tile dimensions").
    auto tile_size = [&](int tag, int64_t fallback) -> uint64_t {
      const TiffTag* t = ifd.find(tag);
      if (t && (t->type == 5 || t->type == 10 || t->type == 11 ||
                t->type == 12)) {
        check(tag == 278 && ifd.number(tag, 0) > double(ysize));
        return ~uint64_t(0);
      }
      const int64_t v = ifd.scalar(tag, fallback);
      check(!t || t->type == 16 || v >= 0);
      return uint64_t(v);
    };
    uint64_t tw, th;
    if (ifd.find(273)) {
      offsets = ifd.tuple(273, {}, kBytes);
      tw = uint64_t(xsize);
      th = tile_size(278, ysize);
    } else if (ifd.find(324)) {
      offsets = ifd.tuple(324, {}, kBytes);
      check(ifd.find(322) && ifd.find(323), kTiffUnsupported);
      tw = tile_size(322, -1);
      th = tile_size(323, -1);
    } else {
      fail(kTiffUnsupported);  // "unknown data organization"
    }
    // PIL's raw decoder, one tile of the image per offset, in PIL's order.
    struct Tile {
      int64_t x0, y0, x1, y1, offset, stride;
      int layer;
    };
    std::vector<Tile> tiles;
    if (tw == uint64_t(xsize) && th == uint64_t(ysize) && planar != 2 &&
        !offsets.empty())
      offsets.erase(offsets.begin(), offsets.end() - 1);
    int64_t x = 0, y = 0;
    int layer = 0;
    check(tw == 0 || th > 0);  // a tile of no rows: "tile cannot extend..."
    for (int64_t off : offsets) {
      int64_t stride = 0;
      if (tw > uint64_t(xsize - x)) {
        int64_t sum = 0;
        for (int64_t b : bps) sum += b;
        // Python's float division, truncated; the raw decoder takes it as a
        // C int (an OverflowError past INT_MAX).
        double bytes = double(tw) * double(sum) / 8;
        if (planar == 2) bytes /= bps_count;
        check(bytes < 2147483648.0);
        stride = int64_t(bytes);
      }
      // PIL's decoder takes a tile from x = 0 to x = 0 (a width of 0) as
      // the whole image.
      if (tw == 0) {
        tiles.push_back({0, 0, xsize, ysize, off, 0, planar == 2 ? 0 : -1});
        continue;
      }
      tiles.push_back({x, y, x + int64_t(std::min<uint64_t>(tw, xsize - x)),
                       y + int64_t(std::min<uint64_t>(th, ysize - y)), off,
                       stride, planar == 2 ? layer : -1});
      if (tw < uint64_t(xsize - x)) {
        x += int64_t(tw);
      } else {
        x = 0;
        if (th < uint64_t(ysize - y)) {
          y += int64_t(th);
        } else {
          y = 0;
          ++layer;
        }
      }
    }
    // ImageFile.load: tiles sorted by offset (stably), and of consecutive
    // tiles alike but for their offset only the last is kept.
    std::stable_sort(tiles.begin(), tiles.end(),
                     [](const Tile& a, const Tile& b) {
                       return a.offset < b.offset;
                     });
    std::vector<Tile> kept;
    for (size_t i = 0; i < tiles.size(); ++i) {
      const Tile& t = tiles[i];
      if (i + 1 < tiles.size()) {
        const Tile& u = tiles[i + 1];
        if (u.x0 == t.x0 && u.y0 == t.y0 && u.x1 == t.x1 && u.y1 == t.y1 &&
            u.stride == t.stride && u.layer == t.layer)
          continue;
      }
      kept.push_back(t);
    }
    for (const Tile& t : kept) {
      int band = -1, bits = channels_bits;
      if (t.layer >= 0) {
        // PIL reads plane `layer` with the unpacker named by character
        // `layer` of the raw mode: a band letter ("R", "G", "L", "P",
        // "A", "1", "F", "I", ...) read at that letter's depth, whatever
        // the file's; anything else (";", "X", "a") it has no unpacker for.
        const int m = raw.mode, plane = t.layer;
        const bool letter =
            m == kMode1 || m == kModeL || m == kModeP || m == kModeI ||
                    m == kModeF
                ? plane == 0
            : m == kModeLA || m == kModePA ? plane < 2
            : m == kModeRGB                ? plane < 3
            : m == kModeRGBA ? plane < 3 || (plane == 3 && !raw.premultiplied)
            : m == kModeCMYK ? plane < 4
                             : false;
        check(letter, kTiffUnsupported);
        band = plane;
        bits = m == kMode1 ? 1 : m == kModeI || m == kModeF ? 32 : 8;
      }
      const int64_t w = t.x1 - t.x0, h = t.y1 - t.y0;
      check(w > 0 && h > 0);
      const uint64_t row = (uint64_t(w) * bits + 7) / 8;
      const uint64_t stride = t.stride ? uint64_t(t.stride) : row;
      check(t.stride == 0 || uint64_t(t.stride) >= row);
      check(t.offset >= 0);
      check(uint64_t(t.offset) + (h - 1) * stride + row <= n, kTruncated);
      for (int64_t r = 0; r < h; ++r) {
        uint8_t* dst = out.row(t.y0 + r) + t.x0 * out.pixel_bytes();
        const uint8_t* src = d + t.offset + r * stride;
        if (band >= 0) {
          unpack_row(raw, src, w, dst, band, bits);
        } else {
          unpack_row(raw, src, w, dst, -1, 0);
        }
      }
    }
    return out;
  }

  // libtiff: the file must be a proper TIFF for it, its own reading of the
  // directory must describe the image PIL set up, and every strip or tile
  // is decoded whole from its byte count.
  check(proper_header && !lt.libtiff_refuses, kCorrupt);
  const int64_t lt_spp = lt.scalar(277, 1);
  const std::vector<int64_t> lt_bps = lt.tuple(258, {1});
  // Compression, Min/MaxSampleValue and DataType: one value, or one a
  // sample (at least SamplesPerPixel of them, those alike);
  // SMin/SMaxSampleValue exactly one a sample.
  auto one_or_per_sample = [&](const std::vector<int64_t>& v) {
    return v.size() == 1 ||
           (int64_t(v.size()) >= lt_spp &&
            std::all_of(v.begin(), v.begin() + lt_spp,
                        [&](int64_t c) { return c == v[0]; }));
  };
  const std::vector<int64_t> lt_compression = lt.tuple(259, {1});
  check(one_or_per_sample(lt_compression), kCorrupt);
  for (int tag : {280, 281, 32996})
    check(!lt.find(tag) || one_or_per_sample(lt.tuple(tag, {})), kCorrupt);
  for (int tag : {340, 341})
    check(!lt.find(tag) || int64_t(lt.find(tag)->count) == lt_spp, kCorrupt);
  check(lt.scalar(256, -1) == xsize && lt.scalar(257, -1) == ysize &&
            lt_compression[0] == compression &&
            !lt_bps.empty() && lt_bps[0] == bps[0],
        kCorrupt);
  for (int64_t sf : lt.tuple(339, {1}))  // "Bad value ... SampleFormat"
    check(sf >= 1 && sf <= 6, kCorrupt);
  if (lt.scalar(262, -1) == 3 && lt_bps[0] < 8) {
    // libtiff keeps a colour map of 3 << bits entries only, and only once
    // it has read BitsPerSample; a palette image of under 8 bits needs one
    // ("missing required Colormap").
    std::vector<int64_t> cmap;
    bool ok;
    check(lt.ints(320, &cmap, &ok) && ok && lt.find(258) &&
              cmap.size() == (size_t(3) << lt_bps[0]),
          kCorrupt);
  }
  const int64_t lt_planar = lt.scalar(284, 1);
  check(lt_planar == 1 || lt_planar == 2, kCorrupt);
  const int64_t lt_fill = lt.scalar(266, 1);
  std::vector<int64_t> offsets, counts;
  // Either tile dimension makes the image tiled for libtiff, whose strip
  // and tile arrays are one (the tile tags where present, else the
  // strip tags).
  const bool tiled = lt.find(322) || lt.find(323);
  int64_t tw = xsize, th = lt.scalar(278, int64_t(0xFFFFFFFF));
  if (tiled) {  // a missing dimension is 0: "zero number of tiles"
    tw = lt.scalar(322, 0);
    th = lt.scalar(323, 0);
  }
  check(tw > 0 && th > 0, kCorrupt);
  // PIL's TiffDecode.c keeps tile dimensions and rows per strip in C ints
  // ("decoder error -9" past INT_MAX; libtiff refuses a LONG8 past 2^32 - 1
  // and 0xFFFFFFFF rows per strip mean one strip).
  constexpr int64_t kIntMax = 2147483647;
  check(tw <= kIntMax && (th <= kIntMax || (!tiled && th == 0xFFFFFFFF)),
        kMemory);
  const int offsets_tag = 273, counts_tag = 279;  // the shared arrays
  const int64_t predictor = lt.scalar(317, 1);
  // libtiff's planes; PIL reads one of them into a one-band image (the
  // rest of a directory PIL could not read past), else all of them.
  const bool separate = lt_planar == 2 && lt_spp > 1;
  check(lt_spp == spp || (separate && spp == 1), kCorrupt);
  const int64_t chunks = (tiled ? (xsize + tw - 1) / tw : 1) *
                         ((ysize + th - 1) / th) * (separate ? lt_spp : 1);
  offsets = strile_array(lt, offsets_tag, chunks, d, n);
  const bool have_counts = lt.find(counts_tag) != nullptr;
  if (have_counts) counts = strile_array(lt, counts_tag, chunks, d, n);
  // libtiff estimates missing byte counts for one strip (or one a plane),
  // and a zero count of a single strip that has an offset ("Bogus
  // StripByteCounts"): the data less the header and the directory, shared
  // by the planes, the last strip cut at the end of the data.
  if (!have_counts || (!tiled && chunks == 1 && counts[0] == 0 &&
                       offsets[0] != 0)) {
    check(chunks == (separate ? lt_spp : 1) && !lt.estimate_fails, kCorrupt);
    uint64_t space = lt.directory_space;
    space = n < space ? n : n - space;
    if (separate) space /= uint64_t(lt_spp);
    counts.assign(offsets.size(), int64_t(space));
    const uint64_t last = uint64_t(offsets.back());
    check(last <= ~uint64_t(0) - space, kCorrupt);
    if (last + space > n) counts.back() = last >= n ? 0 : int64_t(n - last);
  }
  const int planes = separate ? int(spp) : 1;
  const bool per_band = separate && spp > 1;
  const int64_t pixel_bits = separate ? raw.bits : int64_t(raw.bits) * spp;
  const uint64_t row_bytes = (uint64_t(tw) * pixel_bits + 7) / 8;
  // A tile is read whole into one buffer: PIL refuses one of over
  // INT_MAX - 1 bytes (libtiff, one whose size overflows 64 bits).
  if (tiled) check(row_bytes <= uint64_t(kIntMax - 1) / uint64_t(th), kMemory);
  if (predictor == 2) {
    check(raw.bits == 8 || raw.bits == 16 || raw.bits == 32, kCorrupt);
  } else if (predictor == 3) {
    check(lt.tuple(339, {1})[0] == 3 && raw.bits == 32, kCorrupt);
  } else {
    check(predictor == 1, kCorrupt);
  }
  const int64_t across = tiled ? (xsize + tw - 1) / tw : 1;
  const int64_t down = (ysize + th - 1) / th;
  std::vector<uint8_t> raw_bytes, buf;
  for (int p = 0; p < planes; ++p)
    for (int64_t ty = 0; ty < down; ++ty)
      for (int64_t tx = 0; tx < across; ++tx) {
        const size_t index = size_t((p * down + ty) * across + tx);
        const int64_t rows =
            tiled ? th : std::min(th, ysize - ty * th);
        const size_t want = size_t(row_bytes * rows);
        const uint64_t off = offsets[index], count = counts[index];
        check(count > 0 && off <= n && n - off >= count, kTruncated);
        const uint8_t* src = d + off;
        if (lt_fill == 2) {
          raw_bytes.assign(src, src + count);
          for (uint8_t& b : raw_bytes) b = reverse_bits(b);
          src = raw_bytes.data();
        }
        buf.assign(want, 0);
        if (compression == 5) {
          lzw_decode(src, count, buf.data(), want);
        } else if (compression == 8 || compression == 32946) {
          deflate_decode(src, count, buf.data(), want);
        } else {
          packbits_decode(src, count, buf.data(), want);
        }
        const int sb = raw.bits / 8;
        const int stride = separate ? 1 : int(spp);
        if (predictor == 2 && compression != 32773) {
          // horAcc8/16/32 on samples in the machine's order (swabbed
          // first from an MM file).
          for (int64_t r = 0; r < rows; ++r) {
            uint8_t* q = buf.data() + r * row_bytes;
            const size_t m = row_bytes / sb;
            if (sb > 1 && ifd.be)
              for (size_t i = 0; i < m; ++i)
                std::reverse(q + i * sb, q + (i + 1) * sb);
            for (size_t i = stride; i < m; ++i) {
              if (sb == 1) {
                q[i] = uint8_t(q[i] + q[i - stride]);
              } else if (sb == 2) {
                uint16_t a, b;
                std::memcpy(&a, q + 2 * i, 2);
                std::memcpy(&b, q + 2 * (i - stride), 2);
                a = uint16_t(a + b);
                std::memcpy(q + 2 * i, &a, 2);
              } else {
                uint32_t a, b;
                std::memcpy(&a, q + 4 * i, 4);
                std::memcpy(&b, q + 4 * (i - stride), 4);
                a += b;
                std::memcpy(q + 4 * i, &a, 4);
              }
            }
          }
        } else if (predictor == 3 && compression != 32773) {
          // fpAcc: byte planes, most significant first, differenced
          // bytewise across the row; out in the machine's order.
          std::vector<uint8_t> tmp(row_bytes);
          const size_t wc = row_bytes / sb;
          check(row_bytes % (size_t(sb) * stride) == 0);
          for (int64_t r = 0; r < rows; ++r) {
            uint8_t* q = buf.data() + r * row_bytes;
            for (size_t i = stride; i < row_bytes; ++i)
              q[i] = uint8_t(q[i] + q[i - stride]);
            std::memcpy(tmp.data(), q, row_bytes);
            for (size_t c = 0; c < wc; ++c)
              for (int b = 0; b < sb; ++b)
                q[sb * c + b] = tmp[(sb - b - 1) * wc + c];
          }
        } else if (sb > 1 && ifd.be) {
          for (size_t i = 0; i + sb <= want; i += sb)
            std::reverse(buf.data() + i, buf.data() + i + sb);
        }
        // Copy the rows of the tile that lie in the image.
        const int64_t x0 = tx * tw, y0 = ty * th;
        const int64_t w = std::min(tw, xsize - x0);
        for (int64_t r = 0; r < rows && y0 + r < ysize; ++r) {
          uint8_t* dst = out.row(y0 + r) + x0 * out.pixel_bytes();
          const uint8_t* q = buf.data() + r * row_bytes;
          if (per_band) {
            if (raw.order[p] == 'x') continue;
            unpack_row(raw, q, w, dst, raw.order[p] - '0', raw.bits);
          } else {
            unpack_row(raw, q, w, dst, -1, 0);
          }
        }
      }
  return out;
}

}  // namespace

extern "C" {

// Decodes BMP, TIFF or GIF bytes (told apart by their signature) into a new
// buffer at *out: the (h, w, channels) samples of PIL's mode, then the
// palette's RGB triples.  meta gets mode, h, w, palette entries,
// orientation and format (1 BMP, 2 TIFF, 3 GIF).  Returns 0, or a negative
// RasterCode (nothing is allocated then).
int sn_raster_decode(const uint8_t* data, size_t size, int64_t* meta,
                     uint8_t** out) {
  try {
    Raster img;
    int format;
    if (size >= 2 && data[0] == 'B' && data[1] == 'M') {
      img = decode_bmp(data, size);
      format = 1;
    } else if (size >= 6 && (std::memcmp(data, "GIF87a", 6) == 0 ||
                             std::memcmp(data, "GIF89a", 6) == 0)) {
      img = decode_gif(data, size);
      format = 3;
    } else if (size >= 4 && is_tiff(data)) {
      img = decode_tiff(data, size);
      format = 2;
    } else {
      return kUnknownFormat;
    }
    const size_t total = img.pixels.size() + img.palette.size();
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(total ? total : 1));
    if (!buf) return kMemory;
    std::memcpy(buf, img.pixels.data(), img.pixels.size());
    if (!img.palette.empty())
      std::memcpy(buf + img.pixels.size(), img.palette.data(),
                  img.palette.size());
    meta[0] = img.mode;
    meta[1] = img.h;
    meta[2] = img.w;
    meta[3] = int64_t(img.palette.size() / 3);
    meta[4] = img.orientation;
    meta[5] = format;
    *out = buf;
    return 0;
  } catch (const RasterError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kMemory;
  } catch (const std::length_error&) {
    return kMemory;
  }
}

}  // extern "C"
