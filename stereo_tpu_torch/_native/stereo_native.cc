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
//     reusable output buffers, driven through a C ABI from ctypes.
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

  size_t total = 0;
  for (int p = 0; p < n_passes; ++p) {
    const int pw = pass_size(hdr.width, passes[p].x0, passes[p].dx);
    const int ph = pass_size(hdr.height, passes[p].y0, passes[p].dy);
    if (pw && ph) total += size_t(ph) * (1 + (size_t(pw) * bits + 7) / 8);
  }
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
  const size_t pixel_bytes = size_t(hdr.channels) * (hdr.depth / 8);
  out->pixels.assign(size_t(hdr.width) * hdr.height * pixel_bytes, 0);
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
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"
