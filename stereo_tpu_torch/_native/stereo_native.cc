// Native host runtime of the PyTorch/CUDA port (a copy of
// stereo_tpu/_native/stereo_native.cc with in-memory PNG entry points).
//
// What it owns is the host's input pipeline, which the device never sees:
//
//   * a zlib-based PNG decoder (grey at 1, 2, 4, 8 and 16 bits, palette
//     with or without tRNS, grey+alpha, RGB and RGBA at 8 and 16 bits,
//     plain or Adam7-interlaced, every filter type) from bytes in memory or
//     a file, straight to HWC uint8/uint16 samples or to padded planar
//     float32 RGB as an image library's RGB conversion gives it;
//   * fused layout conversions (HWC uint8 -> padded CHW float32, bilinear
//     resize, kxk mean pool, RGB -> luma) used by the cameras;
//   * a multi-threaded frame prefetcher over a ring of preallocated,
//     reusable output buffers, driven through a C ABI from ctypes;
//   * a zstd decoder (RFC 8878 frames without dictionaries: every block,
//     literal and sequence mode, the XXH64 checksum, concatenated and
//     skippable frames) and zlib/gzip inflation, for the Orbax checkpoints
//     that utils/ocdbt.py and utils/orbax.py read.  Malformed input is
//     refused whole: no partial output, no read outside the input.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread stereo_native.cc -lz
// (stereo_tpu_torch/_native/__init__.py does it on first use).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <exception>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decoding
// ---------------------------------------------------------------------------

struct Image {
  int height = 0;
  int width = 0;
  int channels = 0;
  int depth = 8;                // bits per sample: 8 or 16 (big-endian)
  std::vector<uint8_t> pixels;  // HWC samples, unfiltered and expanded

  int sample(size_t i) const {  // the i-th sample (HWC order)
    return depth == 16 ? (int(pixels[2 * i]) << 8) | pixels[2 * i + 1]
                       : pixels[i];
  }
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

struct Header {
  int width = 0, height = 0;
  int bit_depth = 8, color_type = 0, interlace = 0;
  int raw_channels = 0;          // samples per pixel as stored (palette: 1)
  int channels = 0;              // samples per decoded pixel
  int depth = 8;                 // bits per decoded sample: 8 or 16
  std::vector<uint8_t> palette;  // PLTE: r, g, b per entry
  std::vector<uint8_t> trns;     // tRNS of a palette image: alpha per entry
  std::vector<uint8_t> idat;
};

// Walks the chunks; fills the header, the palette and, when `idat` is set,
// the concatenated IDAT payload.  Returns 0 for a PNG the decoder takes:
// colour type 0 (grey) at 1, 2, 4, 8 or 16 bits, 2 (RGB), 4 (grey+alpha)
// and 6 (RGBA) at 8 or 16, 3 (palette) at 1, 2, 4 or 8, plain or Adam7
// interlaced.  Decoded samples are 8-bit but for bit depth 16; a palette
// image decodes to RGB, or RGBA when it has a tRNS chunk.
int parse_png(const uint8_t* data, size_t size, Header* hdr, bool idat) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || std::memcmp(data, kSig, 8) != 0) return -1;

  size_t pos = 8;
  bool have_header = false;
  while (pos + 8 <= size) {
    uint32_t len = read_be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* payload = data + pos + 8;
    if (pos + 12 + size_t(len) > size) return -2;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      hdr->width = int(read_be32(payload));
      hdr->height = int(read_be32(payload + 4));
      hdr->bit_depth = payload[8];
      hdr->color_type = payload[9];
      hdr->interlace = payload[12];
      have_header = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len > 768) return -3;
      hdr->palette.assign(payload, payload + len);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      hdr->trns.assign(payload, payload + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (idat) hdr->idat.insert(hdr->idat.end(), payload, payload + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(len);
  }
  const int d = hdr->bit_depth;
  const bool low = d == 1 || d == 2 || d == 4 || d == 8;
  bool depth_ok = false;
  switch (hdr->color_type) {
    case 0: hdr->raw_channels = 1; depth_ok = low || d == 16; break;
    case 2: hdr->raw_channels = 3; depth_ok = d == 8 || d == 16; break;
    case 3: hdr->raw_channels = 1; depth_ok = low; break;
    case 4: hdr->raw_channels = 2; depth_ok = d == 8 || d == 16; break;
    case 6: hdr->raw_channels = 4; depth_ok = d == 8 || d == 16; break;
    default: return -5;
  }
  if (!have_header || hdr->width <= 0 || hdr->height <= 0 || !depth_ok ||
      hdr->interlace > 1)
    return -4;
  if (hdr->color_type == 3) {
    if (hdr->palette.empty()) return -8;
    hdr->channels = hdr->trns.empty() ? 3 : 4;
  } else {
    hdr->channels = hdr->raw_channels;
    hdr->trns.clear();           // a grey or RGB colour key: not an alpha
  }
  hdr->depth = d == 16 ? 16 : 8;
  return 0;
}

// Reverses one row's filter: `prior` is the previous row of the same pass
// (zeros for its first row), `bpp` the filters' byte distance.
bool unfilter_row(int filter, const uint8_t* src, const uint8_t* prior,
                  uint8_t* dst, size_t stride, size_t bpp) {
  switch (filter) {
    case 0:
      std::memcpy(dst, src, stride);
      return true;
    case 1:  // Sub
      for (size_t i = 0; i < stride; ++i)
        dst[i] = uint8_t(src[i] + (i >= bpp ? dst[i - bpp] : 0));
      return true;
    case 2:  // Up
      for (size_t i = 0; i < stride; ++i) dst[i] = uint8_t(src[i] + prior[i]);
      return true;
    case 3:  // Average
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= bpp ? dst[i - bpp] : 0;
        dst[i] = uint8_t(src[i] + ((a + prior[i]) >> 1));
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= bpp ? dst[i - bpp] : 0;
        int c = i >= bpp ? prior[i - bpp] : 0;
        dst[i] = uint8_t(src[i] + paeth(a, prior[i], c));
      }
      return true;
    default:
      return false;
  }
}

// Writes pixel `x` of an unfiltered row into `dst` (the pixel's first
// decoded byte): samples below 8 bits are scaled to 0..255 for grey and
// looked up for a palette, where an index past the palette is black (as
// image libraries read it), opaque unless tRNS says otherwise.
void put_pixel(const Header& hdr, const uint8_t* row, int x, uint8_t* dst) {
  const int bd = hdr.bit_depth;
  if (bd == 16 || (bd == 8 && hdr.color_type != 3)) {
    const size_t n = size_t(hdr.raw_channels) * (bd / 8);
    std::memcpy(dst, row + size_t(x) * n, n);
    return;
  }
  int v;
  if (bd == 8) {
    v = row[x];
  } else {
    const size_t bit = size_t(x) * bd;
    v = (row[bit / 8] >> (8 - bd - int(bit % 8))) & ((1 << bd) - 1);
  }
  if (hdr.color_type != 3) {
    dst[0] = uint8_t(v * 255 / ((1 << bd) - 1));
    return;
  }
  if (size_t(v) * 3 < hdr.palette.size())
    std::memcpy(dst, hdr.palette.data() + size_t(v) * 3, 3);
  else
    dst[0] = dst[1] = dst[2] = 0;
  if (hdr.channels == 4)
    dst[3] = size_t(v) < hdr.trns.size() ? hdr.trns[v] : 255;
}

struct Pass {
  int x0, y0, dx, dy;
};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                        {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                        {0, 1, 1, 2}};
const Pass kWhole[1] = {{0, 0, 1, 1}};

int pass_size(int extent, int start, int step) {
  return extent > start ? (extent - start + step - 1) / step : 0;
}

// Raw (filtered) sizes above this are checked against the IDAT stream
// before they are allocated.
constexpr size_t kStreamCheckBytes = size_t(64) << 20;

// Whether the IDAT stream inflates to exactly `total` bytes (as zlib's
// uncompress into a buffer of that size would succeed), with a filter
// type of 0-4 at the start of every row of `row_bytes` (0: no row check),
// through a small window, so that nothing of the declared size is
// allocated.
bool idat_inflates_to(const std::vector<uint8_t>& idat, size_t total,
                      size_t row_bytes) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  std::vector<uint8_t> window(size_t(1) << 16);
  const uint8_t* next = idat.data();
  size_t left = idat.size();
  size_t produced = 0;
  bool ok = true;
  int rc = Z_OK;
  while (ok && rc != Z_STREAM_END) {
    if (zs.avail_in == 0 && left > 0) {
      const size_t n = std::min(left, size_t(1) << 30);
      zs.next_in = const_cast<Bytef*>(next);
      zs.avail_in = uInt(n);
      next += n;
      left -= n;
    }
    zs.next_out = window.data();
    zs.avail_out = uInt(window.size());
    rc = inflate(&zs, Z_NO_FLUSH);
    const size_t n = window.size() - zs.avail_out;
    if ((rc != Z_OK && rc != Z_STREAM_END) || n > total - produced) {
      ok = false;
      break;
    }
    if (row_bytes)
      for (size_t k = (row_bytes - produced % row_bytes) % row_bytes; k < n;
           k += row_bytes)
        if (window[k] > 4) ok = false;
    produced += n;
    if (rc == Z_OK && n == 0 && zs.avail_in == 0 && left == 0) ok = false;
  }
  inflateEnd(&zs);
  return ok && rc == Z_STREAM_END && produced == total;
}

// Returns 0 on success; fills `out`.
int decode_png(const uint8_t* data, size_t size, Image* out) {
  Header hdr;
  int rc = parse_png(data, size, &hdr, true);
  if (rc) return rc;
  const Pass* passes = hdr.interlace ? kAdam7 : kWhole;
  const int n_passes = hdr.interlace ? 7 : 1;
  const size_t bits = size_t(hdr.raw_channels) * hdr.bit_depth;  // a pixel
  // Filters work on bytes, a pixel's bytes apart (at least one).
  const size_t bpp = bits >= 8 ? bits / 8 : 1;

  // Every size product is checked: a header may declare up to 2^31 - 1
  // by 2^31 - 1 pixels of 8 bytes, which would wrap a size_t.
  size_t total = 0;
  for (int p = 0; p < n_passes; ++p) {
    const int pw = pass_size(hdr.width, passes[p].x0, passes[p].dx);
    const int ph = pass_size(hdr.height, passes[p].y0, passes[p].dy);
    size_t rows;
    if (pw && ph &&
        (__builtin_mul_overflow(size_t(ph), 1 + (size_t(pw) * bits + 7) / 8,
                                &rows) ||
         __builtin_add_overflow(total, rows, &total)))
      return -12;
  }
  const size_t pixel_bytes = size_t(hdr.channels) * (hdr.depth / 8);
  size_t out_bytes;
  if (__builtin_mul_overflow(size_t(hdr.width), size_t(hdr.height),
                             &out_bytes) ||
      __builtin_mul_overflow(out_bytes, pixel_bytes, &out_bytes))
    return -12;
  // A large image is allocated only once its data is known to fill it.
  if (total > kStreamCheckBytes &&
      !idat_inflates_to(hdr.idat, total,
                        hdr.interlace ? 0 : 1 + (size_t(hdr.width) * bits + 7) / 8))
    return -6;
  std::vector<uint8_t> raw(total);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, hdr.idat.data(), hdr.idat.size()) !=
          Z_OK ||
      raw_len != raw.size())
    return -6;

  out->height = hdr.height;
  out->width = hdr.width;
  out->channels = hdr.channels;
  out->depth = hdr.depth;
  out->pixels.assign(out_bytes, 0);
  size_t pos = 0;
  std::vector<uint8_t> prior, cur;
  for (int p = 0; p < n_passes; ++p) {
    const Pass& ps = passes[p];
    const int pw = pass_size(hdr.width, ps.x0, ps.dx);
    const int ph = pass_size(hdr.height, ps.y0, ps.dy);
    if (!pw || !ph) continue;
    const size_t stride = (size_t(pw) * bits + 7) / 8;
    prior.assign(stride, 0);
    cur.assign(stride, 0);
    for (int y = 0; y < ph; ++y) {
      if (!unfilter_row(raw[pos], raw.data() + pos + 1, prior.data(),
                        cur.data(), stride, bpp))
        return -7;
      pos += stride + 1;
      const size_t row0 = size_t(ps.y0 + y * ps.dy) * hdr.width;
      for (int x = 0; x < pw; ++x) {
        uint8_t* dst = out->pixels.data() +
                       (row0 + ps.x0 + size_t(x) * ps.dx) * pixel_bytes;
        put_pixel(hdr, cur.data(), x, dst);
      }
      std::swap(prior, cur);
    }
  }
  return 0;
}

// HWC samples (any of 1/2/3/4 channels) -> padded planar CHW float32 *
// scale, with the RGB values an image library's RGB conversion gives
// (PIL's convert("RGB")): grey replicated, alpha dropped, 16-bit samples
// taken by their high byte, but 16-bit grey clipped to 255.
// Output: 3 x (top+h+bottom) x (left+w+right).
void to_padded_chw(const Image& im, int left, int top, int right, int bottom,
                   float scale, float* out) {
  const int oh = top + im.height + bottom;
  const int ow = left + im.width + right;
  const size_t plane = size_t(oh) * ow;
  std::memset(out, 0, sizeof(float) * 3 * plane);
  const int in_c = im.channels;
  for (int c = 0; c < 3; ++c) {
    const int src_c = in_c >= 3 ? c : 0;
    float* dst_plane = out + plane * c;
    for (int y = 0; y < im.height; ++y) {
      const size_t row = size_t(y) * im.width * in_c + src_c;
      float* dst = dst_plane + size_t(y + top) * ow + left;
      for (int x = 0; x < im.width; ++x) {
        int v = im.sample(row + size_t(x) * in_c);
        if (im.depth == 16) v = in_c == 1 ? std::min(v, 255) : v >> 8;
        dst[x] = float(v) * scale;
      }
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(size_t(n));
  size_t got = std::fread(buf->data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

}  // namespace

extern "C" {

// (H, W, C) and bit depth of PNG bytes in memory, from the header alone:
// returns 0 for a PNG the decoder takes, else its error code.
int sn_png_info_mem(const uint8_t* data, size_t size, int* h, int* w,
                    int* c, int* depth) {
  Header hdr;
  int rc = parse_png(data, size, &hdr, false);
  if (rc) return rc;
  *h = hdr.height;
  *w = hdr.width;
  *c = hdr.channels;
  *depth = hdr.depth;
  return 0;
}

// PNG bytes in memory -> HWC samples in `out`: h * w * c uint8 for bit
// depth 8, uint16 (native byte order) for 16 (the shape and depth that
// sn_png_info_mem gives).  Returns 0, or a negative error code.
int sn_decode_png_hwc_mem(const uint8_t* data, size_t size, void* out,
                          int h, int w, int c, int depth) {
  try {
    Image im;
    int rc = decode_png(data, size, &im);
    if (rc) return rc;
    if (im.height != h || im.width != w || im.channels != c ||
        im.depth != depth)
      return -11;
    const size_t n = size_t(h) * w * c;
    if (depth == 8) {
      std::memcpy(out, im.pixels.data(), n);
    } else {
      uint16_t* dst = static_cast<uint16_t*>(out);
      for (size_t i = 0; i < n; ++i) dst[i] = uint16_t(im.sample(i));
    }
    return 0;
  } catch (const std::exception&) {  // a size no allocation can hold
    return -12;
  }
}

// PNG bytes in memory -> padded CHW float32 (3 x (top+h+bottom) x
// (left+w+right)), values scaled by `scale` (1.0 => 0..255).
int sn_decode_png_chw_mem(const uint8_t* data, size_t size, int left,
                          int top, int right, int bottom, float scale,
                          float* out, int out_h, int out_w) {
  try {
    Image im;
    int rc = decode_png(data, size, &im);
    if (rc) return rc;
    if (top + im.height + bottom != out_h || left + im.width + right != out_w)
      return -11;
    to_padded_chw(im, left, top, right, bottom, scale, out);
    return 0;
  } catch (const std::exception&) {
    return -12;
  }
}

// 0 when the JAX package's native PNG decoder decodes these bytes whole:
// bit depth 8, not interlaced, grey, RGB, grey+alpha or RGBA, and an IDAT
// stream that fills the image exactly with filter types 0-4.  Checked
// through a small window, whatever size the header declares.
int sn_png_whole_mem(const uint8_t* data, size_t size) {
  try {
    Header hdr;
    int rc = parse_png(data, size, &hdr, true);
    if (rc) return rc;
    if (hdr.bit_depth != 8 || hdr.interlace || hdr.color_type == 3) return -4;
    const size_t stride = size_t(hdr.width) * hdr.raw_channels;
    size_t total;
    if (__builtin_mul_overflow(stride + 1, size_t(hdr.height), &total))
      return -12;
    return idat_inflates_to(hdr.idat, total, stride + 1) ? 0 : -6;
  } catch (const std::exception&) {
    return -12;
  }
}

// The file entries read the file and call the in-memory ones.
int sn_png_shape(const char* path, int* h, int* w, int* c) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -10;
  int depth = 0;
  return sn_png_info_mem(buf.data(), buf.size(), h, w, c, &depth);
}

int sn_decode_png_chw(const char* path, int left, int top, int right,
                      int bottom, float scale, float* out, int out_h,
                      int out_w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -10;
  return sn_decode_png_chw_mem(buf.data(), buf.size(), left, top, right,
                               bottom, scale, out, out_h, out_w);
}

// uint8 HWC -> padded CHW float32 (the numpy-free fast path for in-memory
// frames).
void sn_hwc_to_padded_chw(const uint8_t* hwc, int h, int w, int channels,
                          int left, int top, int right, int bottom,
                          float scale, float* out) {
  Image im;
  im.height = h;
  im.width = w;
  im.channels = channels;
  im.pixels.assign(hwc, hwc + size_t(h) * w * channels);
  to_padded_chw(im, left, top, right, bottom, scale, out);
}

// Triangle-filter (bilinear) resize with half-pixel centers and
// anti-aliasing on downscale — the same kernel family jax.image.resize and
// PIL use, so host-side preprocessing matches the in-graph resize.
inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct ResampleAxis {
  std::vector<int> start;       // first source index per output index
  std::vector<int> count;       // number of taps
  std::vector<float> weights;   // taps, flattened, `max_taps` stride
  int max_taps = 0;
};

ResampleAxis make_axis(int in, int out) {
  ResampleAxis ax;
  const float scale = float(in) / out;
  const float support = scale > 1.f ? scale : 1.f;
  ax.max_taps = int(std::ceil(support)) * 2 + 1;
  ax.start.resize(out);
  ax.count.resize(out);
  ax.weights.assign(size_t(out) * ax.max_taps, 0.f);
  for (int o = 0; o < out; ++o) {
    const float center = (o + 0.5f) * scale - 0.5f;
    // Taps outside the image are dropped and the rest renormalized
    // (jax.image.resize semantics), not clamped to the edge.
    int lo = clampi(int(std::floor(center - support + 1e-4f)), 0, in - 1);
    int hi = clampi(int(std::ceil(center + support - 1e-4f)), 0, in - 1);
    float total = 0.f;
    std::vector<float> taps;
    for (int i = lo; i <= hi; ++i) {
      float wgt = 1.f - std::abs(i - center) / support;
      if (wgt <= 0.f) {
        if (taps.empty()) continue;
        wgt = 0.f;  // keep contiguity once started
      }
      if (taps.empty()) ax.start[o] = i;
      taps.push_back(wgt);
      total += wgt;
    }
    ax.count[o] = int(taps.size());
    for (size_t t = 0; t < taps.size(); ++t)
      ax.weights[size_t(o) * ax.max_taps + t] = taps[t] / total;
  }
  return ax;
}

void sn_resize_bilinear_chw(const float* in, int c, int h, int w, float* out,
                            int oh, int ow) {
  ResampleAxis ay = make_axis(h, oh);
  ResampleAxis axx = make_axis(w, ow);
  std::vector<float> row(static_cast<size_t>(w), 0.f);
  for (int ch = 0; ch < c; ++ch) {
    const float* plane = in + size_t(ch) * h * w;
    float* dst = out + size_t(ch) * oh * ow;
    for (int y = 0; y < oh; ++y) {
      // vertical pass into a temp row
      std::fill(row.begin(), row.end(), 0.f);
      for (int t = 0; t < ay.count[y]; ++t) {
        const int src_y = clampi(ay.start[y] + t, 0, h - 1);
        const float wgt = ay.weights[size_t(y) * ay.max_taps + t];
        const float* src = plane + size_t(src_y) * w;
        for (int x = 0; x < w; ++x) row[x] += wgt * src[x];
      }
      // horizontal pass
      for (int x = 0; x < ow; ++x) {
        float acc = 0.f;
        for (int t = 0; t < axx.count[x]; ++t) {
          const int src_x = clampi(axx.start[x] + t, 0, w - 1);
          acc += axx.weights[size_t(x) * axx.max_taps + t] * row[src_x];
        }
        dst[size_t(y) * ow + x] = acc;
      }
    }
  }
}

// k x k mean pool with ceil-div output and edge replication for the ragged
// tail (the cuda_imageops.mean_pool analog for host-side tooling).
void sn_mean_pool(const float* in, int h, int w, int k, float* out) {
  const int oh = (h + k - 1) / k, ow = (w + k - 1) / k;
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      float acc = 0.f;
      for (int i = 0; i < k; ++i) {
        int yy = y * k + i;
        if (yy >= h) yy = h - 1;
        for (int j = 0; j < k; ++j) {
          int xx = x * k + j;
          if (xx >= w) xx = w - 1;
          acc += in[size_t(yy) * w + xx];
        }
      }
      out[size_t(y) * ow + x] = acc / float(k * k);
    }
  }
}

// ITU-R 601 luma, CHW float in -> HW float out (rgb_to_grayscale analog).
void sn_rgb_to_gray(const float* chw, int h, int w, float* out) {
  const float* r = chw;
  const float* g = chw + size_t(h) * w;
  const float* b = chw + 2 * size_t(h) * w;
  for (size_t i = 0; i < size_t(h) * w; ++i)
    out[i] = (0.2989f * r[i] + 0.5870f * g[i]) + 0.1140f * b[i];
}

// ---------------------------------------------------------------------------
// Threaded frame prefetcher
// ---------------------------------------------------------------------------
//
// A fixed ring of preallocated CHW float32 buffers filled by worker threads
// decoding PNG paths in submission order; consumers pop completed frames in
// order.  This is the host-side analog of the reference's persistent
// device_buffer: allocate once, reuse forever, never block the compute
// thread on disk or codec work.

struct Prefetcher {
  int slots;
  int out_h, out_w;
  int pad[4];  // left, top, right, bottom
  float scale;
  std::vector<std::vector<float>> buffers;
  std::vector<int> status;  // per in-flight slot: 1 ready, <0 error
  std::queue<std::pair<int64_t, std::string>> work;  // (ticket, path)
  int64_t next_ticket = 0;
  int64_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> threads;
  bool stopping = false;
};

void prefetch_worker(Prefetcher* p) {
  for (;;) {
    std::pair<int64_t, std::string> job;
    {
      std::unique_lock<std::mutex> lock(p->mu);
      // An idle worker waits for work without a bound: destroy() wakes it.
      p->cv_work.wait(lock, [&] { return p->stopping || !p->work.empty(); });
      if (p->stopping && p->work.empty()) return;
      job = std::move(p->work.front());
      p->work.pop();
    }
    const int slot = int(job.first % p->slots);
    int rc = sn_decode_png_chw(job.second.c_str(), p->pad[0], p->pad[1],
                               p->pad[2], p->pad[3], p->scale,
                               p->buffers[slot].data(), p->out_h, p->out_w);
    {
      std::lock_guard<std::mutex> lock(p->mu);
      p->status[slot] = rc ? rc : 1;
    }
    p->cv_done.notify_all();
  }
}

void* sn_prefetcher_create(int slots, int out_h, int out_w, int pad_left,
                           int pad_top, int pad_right, int pad_bottom,
                           float scale, int n_threads) {
  auto* p = new Prefetcher;
  p->slots = slots;
  p->out_h = out_h;
  p->out_w = out_w;
  p->pad[0] = pad_left;
  p->pad[1] = pad_top;
  p->pad[2] = pad_right;
  p->pad[3] = pad_bottom;
  p->scale = scale;
  p->buffers.assign(slots, std::vector<float>(size_t(3) * out_h * out_w));
  p->status.assign(slots, 0);
  for (int i = 0; i < n_threads; ++i)
    p->threads.emplace_back(prefetch_worker, p);
  return p;
}

// Submit a path; returns the ticket (consume in order).  Blocks if the ring
// is full (submission more than `slots` ahead of consumption).
int64_t sn_prefetcher_submit(void* handle, const char* path) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  // Bounded by the consumer: the Python wrapper never submits more than
  // `slots` ahead of the frames it takes (FramePrefetcher).
  p->cv_done.wait(lock, [&] {
    return p->next_ticket - p->next_consume < p->slots;
  });
  int64_t ticket = p->next_ticket++;
  p->status[ticket % p->slots] = 0;
  p->work.emplace(ticket, path);
  lock.unlock();
  p->cv_work.notify_one();
  return ticket;
}

// Pop the next frame in order into `out` (3*out_h*out_w floats).
// Returns 0 on success, the decoder error code otherwise.
int sn_prefetcher_next(void* handle, float* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  const int64_t ticket = p->next_consume;
  const int slot = int(ticket % p->slots);
  // Bounded by one decode of a submitted file (the wrapper takes only
  // tickets it submitted); a decoder error ends it too.
  p->cv_done.wait(lock, [&] { return p->status[slot] != 0; });
  const int rc = p->status[slot];
  if (rc == 1)
    std::memcpy(out, p->buffers[slot].data(),
                sizeof(float) * 3 * p->out_h * p->out_w);
  p->status[slot] = 0;
  p->next_consume = ticket + 1;
  lock.unlock();
  p->cv_done.notify_all();
  return rc == 1 ? 0 : rc;
}

void sn_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stopping = true;
  }
  p->cv_work.notify_all();
  // Each worker ends after the decode it is in, if any.
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// zstd frame decoding (RFC 8878, without dictionaries) and zlib/gzip
// inflation, for the chunks and the OCDBT nodes of Orbax checkpoints
// ---------------------------------------------------------------------------

namespace {

// A malformed frame: thrown anywhere below, caught at the C entry point,
// which then returns the code and discards what was decoded.
struct ZstdError {
  int code;
};

enum ZstdCode {
  kZstdTruncated = -1,   // the input ends inside a frame
  kZstdCorrupt = -2,     // a field or a bit stream that cannot be decoded
  kZstdDictionary = -3,  // the frame names a dictionary
  kZstdChecksum = -4,    // the content checksum does not match
  kZstdMagic = -5,       // neither a zstd nor a skippable frame
  kZstdSize = -6,        // the content differs from its declared size
};

[[noreturn]] void zfail(int code) { throw ZstdError{code}; }

inline void zcheck(bool ok, int code = kZstdCorrupt) {
  if (!ok) zfail(code);
}

inline int highbit32(uint32_t v) {  // index of the highest set bit; v > 0
  return 31 - __builtin_clz(v);
}

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline uint64_t read_le64(const uint8_t* p) {
  return uint64_t(read_le32(p)) | (uint64_t(read_le32(p + 4)) << 32);
}

// Bits [pos, pos + n) of the little-endian bit string `data` (bit i is bit
// i % 8 of byte i / 8) as an integer; bits outside the string read as 0.
inline uint64_t le_bits(const uint8_t* data, size_t size, int64_t pos,
                        int n) {
  if (n == 0) return 0;
  int64_t end = pos + n;
  if (end <= 0) return 0;
  int lost = 0;  // bits below the string's start
  if (pos < 0) {
    lost = int(-pos);
    pos = 0;
  }
  const size_t byte = size_t(pos >> 3);
  const int shift = int(pos & 7);
  uint64_t word = 0;
  if (byte + 8 <= size) {
    std::memcpy(&word, data + byte, 8);
  } else {
    for (size_t i = byte; i < size && i < byte + 8; ++i)
      word |= uint64_t(data[i]) << (8 * (i - byte));
  }
  const int width = n - lost;  // <= 57, so the shift below stays in range
  const uint64_t v = (word >> shift) & ((uint64_t(1) << width) - 1);
  return v << lost;
}

// A bit stream read backwards, as zstd writes Huffman and FSE streams: it
// starts below the highest set bit of its last byte and is read towards
// its first bit.  Reads past the first bit give zeros and count as
// overflow (the FSE weight decoder relies on that).
struct BackBits {
  const uint8_t* data;
  size_t size;
  int64_t pos;  // bits not yet read

  BackBits(const uint8_t* d, size_t n) : data(d), size(n) {
    zcheck(n > 0 && d[n - 1] != 0);
    pos = int64_t(n - 1) * 8 + highbit32(d[n - 1]);
  }
  uint32_t read(int n) {
    pos -= n;
    return uint32_t(le_bits(data, size, pos, n));
  }
  uint32_t peek(int n) const { return uint32_t(le_bits(data, size, pos - n, n)); }
  void skip(int n) { pos -= n; }
  bool overflowed() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

// ---- FSE -----------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;  // next state before the bits read are added
};

struct FseTable {
  int log = -1;  // accuracy log; -1: no table yet
  std::vector<FseEntry> entries;
};

// The decoding table of a normalized distribution (-1: "less than one").
void fse_build(const int16_t* norm, int nsym, int log, FseTable* t) {
  const int size = 1 << log;
  t->log = log;
  t->entries.assign(size_t(size), FseEntry{0, 0, 0});
  std::vector<uint32_t> next(size_t(nsym), 0);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      zcheck(high >= 0);
      t->entries[size_t(high--)].symbol = uint16_t(s);
      next[size_t(s)] = 1;
    } else {
      next[size_t(s)] = uint32_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t->entries[size_t(pos)].symbol = uint16_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  zcheck(pos == 0);
  for (int u = 0; u < size; ++u) {
    FseEntry& e = t->entries[size_t(u)];
    const uint32_t state = next[e.symbol]++;
    zcheck(state > 0);
    e.bits = uint8_t(log - highbit32(state));
    e.base = uint16_t((state << e.bits) - uint32_t(size));
  }
}

// Reads an FSE table description at `src`; returns the bytes it took.
size_t fse_read(const uint8_t* src, size_t size, int max_symbol, int max_log,
                FseTable* t) {
  zcheck(size > 0, kZstdTruncated);
  int64_t bit = 0;
  auto peek = [&](int n) { return uint32_t(le_bits(src, size, bit, n)); };
  const int log = int(peek(4)) + 5;
  bit += 4;
  zcheck(log <= max_log);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  std::vector<int16_t> norm(size_t(max_symbol) + 1, 0);
  int sym = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      uint32_t code;
      while ((code = peek(2)) == 3) {
        sym += 3;
        bit += 2;
        zcheck(int64_t(bit) <= int64_t(size) * 8, kZstdTruncated);
      }
      sym += int(code);
      bit += 2;
      zcheck(sym <= max_symbol);
    }
    zcheck(sym <= max_symbol);
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = peek(nbits - 1);
    if (int(low & uint32_t(threshold - 1)) < max) {
      count = int(low & uint32_t(threshold - 1));
      bit += nbits - 1;
    } else {
      count = int(peek(nbits) & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;  // -1: probability "less than 1"
    remaining -= count < 0 ? -count : count;
    norm[size_t(sym++)] = int16_t(count);
    previous0 = count == 0;
    zcheck(remaining >= 1);
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit32(uint32_t(remaining)) + 1;
      threshold = 1 << (nbits - 1);
    }
  }
  zcheck(remaining == 1);
  const size_t used = size_t((bit + 7) >> 3);
  zcheck(used <= size, kZstdTruncated);
  fse_build(norm.data(), sym, log, t);
  return used;
}

void fse_rle(int symbol, FseTable* t) {
  t->log = 0;
  t->entries.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// ---- Huffman literals ----------------------------------------------------

struct HufTable {
  int log = 0;  // 0: no table yet
  std::vector<uint8_t> symbol, bits;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t huf_read(const uint8_t* src, size_t size, HufTable* t) {
  zcheck(size > 0, kZstdTruncated);
  uint8_t weights[256] = {0};
  int nweights;
  const int header = src[0];
  size_t used;
  if (header >= 128) {  // 4-bit weights, packed two per byte
    nweights = header - 127;
    used = 1 + size_t((nweights + 1) / 2);
    zcheck(used <= size, kZstdTruncated);
    for (int i = 0; i < nweights; ++i) {
      const uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + size_t(header);
    zcheck(used <= size, kZstdTruncated);
    FseTable fse;
    const size_t desc = fse_read(src + 1, size_t(header), 255, 6, &fse);
    zcheck(desc < size_t(header));
    BackBits br(src + 1 + desc, size_t(header) - desc);
    uint32_t s1 = br.read(fse.log), s2 = br.read(fse.log);
    nweights = 0;
    auto emit = [&](uint32_t* s) {
      const FseEntry& e = fse.entries[*s];
      zcheck(nweights < 255);
      weights[nweights++] = uint8_t(e.symbol);
      *s = e.base + br.read(e.bits);
    };
    for (;;) {
      emit(&s1);
      if (br.overflowed()) {
        zcheck(nweights < 255);
        weights[nweights++] = uint8_t(fse.entries[s2].symbol);
        break;
      }
      emit(&s2);
      if (br.overflowed()) {
        zcheck(nweights < 255);
        weights[nweights++] = uint8_t(fse.entries[s1].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    zcheck(weights[i] <= 12);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  zcheck(total > 0);
  const int log = highbit32(total) + 1;
  zcheck(log <= 12);
  const uint32_t rest = (1u << log) - total;
  zcheck((rest & (rest - 1)) == 0);  // a power of two
  weights[nweights++] = uint8_t(highbit32(rest) + 1);
  // Symbols fill the table by increasing weight, then by value.
  uint32_t start[14] = {0};
  for (int i = 0; i < nweights; ++i)
    if (weights[i]) start[weights[i] + 1] += 1u << (weights[i] - 1);
  for (int w = 1; w < 14; ++w) start[w] += start[w - 1];
  t->log = log;
  t->symbol.assign(size_t(1) << log, 0);
  t->bits.assign(size_t(1) << log, 0);
  for (int i = 0; i < nweights; ++i) {
    const int w = weights[i];
    if (!w) continue;
    const uint32_t n = 1u << (w - 1);
    for (uint32_t j = 0; j < n; ++j) {
      t->symbol[start[w] + j] = uint8_t(i);
      t->bits[start[w] + j] = uint8_t(log + 1 - w);
    }
    start[w] += n;
  }
  return used;
}

void huf_stream(const HufTable& t, const uint8_t* src, size_t size,
                uint8_t* out, size_t n) {
  BackBits br(src, size);
  size_t i = 0;
  // Four symbols per 8-byte load while 56 bits lie below the position
  // (four codes take at most 48), then one symbol per read.
  const uint32_t mask = (1u << t.log) - 1;
  while (i + 4 <= n && br.pos >= 64) {
    const size_t byte = size_t(br.pos >> 3) - 7;
    uint64_t word;
    std::memcpy(&word, src + byte, 8);
    int top = int(br.pos - int64_t(byte) * 8);
    for (int k = 0; k < 4; ++k, ++i) {
      const uint32_t idx = uint32_t(word >> (top - t.log)) & mask;
      out[i] = t.symbol[idx];
      top -= t.bits[idx];
    }
    br.pos = int64_t(byte) * 8 + top;
  }
  for (; i < n; ++i) {
    const uint32_t idx = br.peek(t.log);
    out[i] = t.symbol[idx];
    br.skip(t.bits[idx]);
  }
  zcheck(br.done());
}

// ---- sequences -----------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// What persists from block to block within a frame.
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

// Reads the table of one symbol type in `mode`; returns the bytes taken.
size_t seq_table(int mode, const uint8_t* src, size_t size,
                 const int16_t* dflt, int ndflt, int dflt_log, int max_symbol,
                 int max_log, FseTable* t) {
  switch (mode) {
    case 0:
      fse_build(dflt, ndflt, dflt_log, t);
      return 0;
    case 1:
      zcheck(size >= 1, kZstdTruncated);
      zcheck(src[0] <= max_symbol);
      fse_rle(src[0], t);
      return 1;
    case 2:
      return fse_read(src, size, max_symbol, max_log, t);
    default:
      zcheck(t->log >= 0);  // repeat: the previous block's table
      return 0;
  }
}

// Decodes one compressed block of `size` bytes, appending to `out`;
// `frame_start` is where the frame's output begins.
void decode_block(const uint8_t* src, size_t size, FrameState* fs,
                  std::vector<uint8_t>* out, size_t frame_start) {
  // Literals section.
  zcheck(size >= 1, kZstdTruncated);
  const int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  bool four = false;
  if (ltype < 2) {
    if ((sf & 1) == 0) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      zcheck(size >= hsize, kZstdTruncated);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hsize = 3;
      zcheck(size >= hsize, kZstdTruncated);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    hsize = sf < 2 ? 3 : size_t(sf + 2);
    zcheck(size >= hsize, kZstdTruncated);
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= uint64_t(src[i]) << (8 * i);
    const int bits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = size_t((h >> 4) & ((1u << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
    four = sf != 0;
  }
  zcheck(regen <= (size_t(1) << 17));
  std::vector<uint8_t> lit(regen);
  size_t pos = hsize;
  if (ltype == 0) {
    zcheck(size - pos >= regen, kZstdTruncated);
    if (regen) std::memcpy(lit.data(), src + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    zcheck(size - pos >= 1, kZstdTruncated);
    std::memset(lit.data(), src[pos], regen);
    pos += 1;
  } else {
    zcheck(size - pos >= csize, kZstdTruncated);
    const uint8_t* p = src + pos;
    size_t n = csize;
    if (ltype == 2) {
      const size_t tree = huf_read(p, n, &fs->huf);
      p += tree;
      n -= tree;
    } else {
      zcheck(fs->huf.log > 0);  // treeless: the previous block's table
    }
    if (!four) {
      huf_stream(fs->huf, p, n, lit.data(), regen);
    } else {
      zcheck(n >= 6, kZstdTruncated);
      const size_t s1 = p[0] | (size_t(p[1]) << 8);
      const size_t s2 = p[2] | (size_t(p[3]) << 8);
      const size_t s3 = p[4] | (size_t(p[5]) << 8);
      zcheck(6 + s1 + s2 + s3 <= n, kZstdTruncated);
      const size_t s4 = n - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      zcheck(3 * seg <= regen);
      const uint8_t* q = p + 6;
      huf_stream(fs->huf, q, s1, lit.data(), seg);
      huf_stream(fs->huf, q + s1, s2, lit.data() + seg, seg);
      huf_stream(fs->huf, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huf_stream(fs->huf, q + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                 regen - 3 * seg);
    }
    pos += csize;
  }

  // Sequences section.
  zcheck(size - pos >= 1, kZstdTruncated);
  size_t nseq = src[pos];
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    zcheck(size - pos >= 2, kZstdTruncated);
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    zcheck(size - pos >= 3, kZstdTruncated);
    nseq = src[pos + 1] + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_used = 0;
  if (nseq > 0) {
    zcheck(size - pos >= 1, kZstdTruncated);
    const int modes = src[pos++];
    zcheck((modes & 3) == 0);
    pos += seq_table(modes >> 6, src + pos, size - pos, kLLDefault, 36, 6, 35,
                     9, &fs->ll);
    pos += seq_table((modes >> 4) & 3, src + pos, size - pos, kOFDefault, 29,
                     5, 31, 8, &fs->of);
    pos += seq_table((modes >> 2) & 3, src + pos, size - pos, kMLDefault, 53,
                     6, 52, 9, &fs->ml);
    zcheck(pos < size, kZstdTruncated);
    BackBits br(src + pos, size - pos);
    uint32_t sll = br.read(fs->ll.log), sof = br.read(fs->of.log),
             sml = br.read(fs->ml.log);
    uint32_t* rep = fs->rep;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& ell = fs->ll.entries[sll];
      const FseEntry& eof = fs->of.entries[sof];
      const FseEntry& eml = fs->ml.entries[sml];
      const int ofcode = eof.symbol;
      zcheck(ofcode <= 31 && ell.symbol <= 35 && eml.symbol <= 52);
      uint32_t ofvalue = (1u << ofcode) + br.read(ofcode);
      const size_t ml = kMLBase[eml.symbol] + br.read(kMLBits[eml.symbol]);
      const size_t ll = kLLBase[ell.symbol] + br.read(kLLBits[ell.symbol]);
      uint32_t offset;
      if (ofvalue > 3) {
        offset = ofvalue - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        if (ll == 0) ++ofvalue;
        if (ofvalue == 1) {
          offset = rep[0];
        } else {
          offset = ofvalue == 4 ? rep[0] - 1 : rep[ofvalue - 1];
          if (ofvalue != 2) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = ell.base + br.read(ell.bits);
        sml = eml.base + br.read(eml.bits);
        sof = eof.base + br.read(eof.bits);
      }
      zcheck(!br.overflowed());
      zcheck(ll <= regen - lit_used);
      out->insert(out->end(), lit.begin() + lit_used,
                  lit.begin() + lit_used + ll);
      lit_used += ll;
      const size_t have = out->size() - frame_start;
      zcheck(offset > 0 && offset <= have);
      const size_t to = out->size();
      out->resize(to + ml);
      uint8_t* o = out->data();
      if (offset >= ml) {
        std::memcpy(o + to, o + to - offset, ml);
      } else {
        for (size_t k = 0; k < ml; ++k)  // the overlap repeats the pattern
          o[to + k] = o[to - offset + k];
      }
    }
    zcheck(br.done());
  } else {
    zcheck(pos == size);
  }
  out->insert(out->end(), lit.begin() + lit_used, lit.end());
}

// ---- XXH64, for the content checksum ------------------------------------

const uint64_t kP1 = 11400714785074694791ULL, kP2 = 14029467366897019727ULL,
               kP3 = 1609587929392839161ULL, kP4 = 9650029242287828579ULL,
               kP5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t v) {
  return rotl64(acc + v * kP2, 31) * kP1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = kP5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl64(h ^ xxh_round(0, read_le64(p)), 27) * kP1 + kP4;
  if (p + 4 <= end) {
    h = rotl64(h ^ (uint64_t(read_le32(p)) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ (uint64_t(*p) * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---- frames --------------------------------------------------------------

// Decodes the zstd frame at `src` (after its magic number has been
// checked), appending to `out`; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t size,
                    std::vector<uint8_t>* out) {
  size_t pos = 4;
  zcheck(size - pos >= 1, kZstdTruncated);
  const int fhd = src[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  zcheck((fhd & 8) == 0);  // reserved bit
  if (!single) {
    zcheck(size - pos >= 1, kZstdTruncated);
    zcheck((src[pos] >> 3) <= 31 - 10);  // window log at most 31
    ++pos;
  }
  const size_t did_size = did_flag == 3 ? 4 : size_t(did_flag);
  zcheck(size - pos >= did_size, kZstdTruncated);
  uint32_t did = 0;
  for (size_t i = 0; i < did_size; ++i) did |= uint32_t(src[pos + i]) << (8 * i);
  if (did != 0) zfail(kZstdDictionary);
  pos += did_size;
  const size_t fcs_size =
      fcs_flag == 0 ? size_t(single) : size_t(1) << fcs_flag;
  zcheck(size - pos >= fcs_size, kZstdTruncated);
  uint64_t content = 0;
  for (size_t i = 0; i < fcs_size; ++i)
    content |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) content += 256;
  pos += fcs_size;
  const size_t start = out->size();
  if (fcs_size && content < (uint64_t(1) << 31)) out->reserve(start + content);
  FrameState fs;
  for (bool last = false; !last;) {
    zcheck(size - pos >= 3, kZstdTruncated);
    const uint32_t bh =
        src[pos] | (uint32_t(src[pos + 1]) << 8) | (uint32_t(src[pos + 2]) << 16);
    pos += 3;
    last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    zcheck(bsize <= (size_t(1) << 17));
    if (type == 0) {
      zcheck(size - pos >= bsize, kZstdTruncated);
      out->insert(out->end(), src + pos, src + pos + bsize);
      pos += bsize;
    } else if (type == 1) {
      zcheck(size - pos >= 1, kZstdTruncated);
      out->insert(out->end(), bsize, src[pos]);
      pos += 1;
    } else {
      zcheck(type == 2);
      zcheck(size - pos >= bsize, kZstdTruncated);
      decode_block(src + pos, bsize, &fs, out, start);
      pos += bsize;
    }
    if (fcs_size) zcheck(out->size() - start <= content, kZstdSize);
  }
  if (fcs_size) zcheck(out->size() - start == content, kZstdSize);
  if (checksum) {
    zcheck(size - pos >= 4, kZstdTruncated);
    const uint32_t want = read_le32(src + pos);
    const uint32_t got =
        uint32_t(xxh64(out->data() + start, out->size() - start));
    if (want != got) zfail(kZstdChecksum);
    pos += 4;
  }
  return pos;
}

// Every frame of `src`, zstd frames decoded and skippable frames skipped.
void zstd_decompress(const uint8_t* src, size_t size,
                     std::vector<uint8_t>* out) {
  zcheck(size > 0, kZstdTruncated);
  size_t pos = 0;
  while (pos < size) {
    zcheck(size - pos >= 4, kZstdTruncated);
    const uint32_t magic = read_le32(src + pos);
    if (magic == 0xFD2FB528u) {
      pos += decode_frame(src + pos, size - pos, out);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      zcheck(size - pos >= 8, kZstdTruncated);
      const uint64_t skip = read_le32(src + pos + 4);
      zcheck(size - pos - 8 >= skip, kZstdTruncated);
      pos += 8 + size_t(skip);
    } else {
      zfail(kZstdMagic);
    }
  }
}

// Hands `buf`'s bytes to the caller in a malloc'd block (freed by
// sn_free); returns their count, or -7 when memory runs out.
int64_t hand_over(const std::vector<uint8_t>& buf, uint8_t** out) {
  *out = static_cast<uint8_t*>(std::malloc(buf.empty() ? 1 : buf.size()));
  if (!*out) return -7;
  if (!buf.empty()) std::memcpy(*out, buf.data(), buf.size());
  return int64_t(buf.size());
}

}  // namespace

extern "C" {

// Decodes every frame of `src` (zstd frames, skippable frames skipped)
// into a new buffer at *out; returns its size, or a negative ZstdCode
// (nothing is returned for a frame that fails anywhere).
int64_t sn_zstd_decompress(const uint8_t* src, size_t size, uint8_t** out) {
  *out = nullptr;
  std::vector<uint8_t> buf;
  try {
    zstd_decompress(src, size, &buf);
  } catch (const ZstdError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return -7;
  }
  return hand_over(buf, out);
}

// Inflates a zlib or gzip stream (its header tells which) into a new
// buffer at *out; returns its size, or -2 for a stream zlib refuses or
// that ends early.
int64_t sn_inflate(const uint8_t* src, size_t size, uint8_t** out) {
  *out = nullptr;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return -2;
  std::vector<uint8_t> buf;
  uint8_t chunk[1 << 16];
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = uInt(size);
  int rc;
  do {
    zs.next_out = chunk;
    zs.avail_out = sizeof(chunk);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) break;
    buf.insert(buf.end(), chunk, chunk + (sizeof(chunk) - zs.avail_out));
  } while (rc != Z_STREAM_END);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return -2;
  return hand_over(buf, out);
}

void sn_free(void* p) { std::free(p); }

}  // extern "C"
