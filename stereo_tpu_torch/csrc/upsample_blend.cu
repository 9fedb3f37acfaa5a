// upsample_blend: Deep3D's view-synthesis tail,
//     out[n, c, y, x] = sum_d up(prob)[n, d, y, x] * view[n, c, y, x + d],
// where up() is the bilinear upsample by s (half-pixel centres,
// align_corners=False, clamped at the edges) and the view is zero past the
// right edge.  The full-resolution (D, H, W) volume is never stored.
//
// Replaces the TPU kernel stereo_tpu/ops/pallas/blend.py::upsample_blend
// (_upsample_rows_blend / _blend_kernel, with the column upsample that ran
// beside it in XLA).  Plain version:
// stereo_tpu_torch/ops/cuda/blend.py::upsample_blend_plain.
//
// What bounds it on an H100: the bytes.  It reads the low-resolution
// volume (8.0 MB at 65x96x320) and the view (5.9 MB at 3x384x1280) and
// writes the output (5.9 MB): 19.8 MB, 5.9 us at 3.35 TB/s.  The
// operations it needs, the blend's three FMAs and the separable
// interpolation's share, about 9 per pixel and plane, take 4.2 us at the
// float32 rate.  A thread per pixel (the first design) spent its time on
// loads instead: every pixel loaded its four low-resolution neighbours and
// three view values per plane, neighbours that 16 pixels share, and redid
// the interpolation.
//
// Design, at s = 2 and 4 (the scales Deep3D has):
//   1. A block of 8 warps owns 8 output rows by 64*s columns.  It stages
//      the view rows once, with the D - 1 columns the shift reads beyond
//      them (zeros past W and H), and the low-resolution band its pixels
//      interpolate from: 8/s + 2 rows by 66 columns, the edge rows and
//      columns replicated, as the TPU kernel's edge padding does.  The
//      volume goes in chunks of 24 planes through two buffers (cp.async):
//      chunk c + 1 loads while chunk c is blended, and shared memory does
//      not grow with D.  Each thread copies the same elements of every
//      row or plane, so its offsets are computed once.
//   2. Each thread owns 2s neighbouring pixels of one row: two low columns.
//      Per plane it interpolates the four low columns they read along y
//      once (two 8-byte loads per low row), then each pixel along x with
//      its phase's weight, (r + 0.5)/s - 0.5 from the nearer pair, a
//      compile-time constant; the two pixels of a pair share the
//      difference.  The separable form of the JAX wrapper's column phases.
//   3. The view's values for a thread's pixels at plane d are those of
//      plane d - 1 moved by one column, so each thread keeps them in a
//      register window and loads one new value per channel and plane.  The
//      staged view rows are split into 2s column phases, so that the warp's
//      loads fall on 32 consecutive words, and the plane loop is unrolled
//      by 2s, so that every phase is a constant and the window's registers
//      rotate without moves; the last D mod 2s planes run without it.
// Per pixel and plane that is about 5.4 float instructions (three of them
// the blend's FMAs) and 1.4 shared-memory words.  At the main path's shape
// the plane loop's float issue takes most of the run, and the staging of
// the view and the first chunk, which every block of the single wave waits
// for, and the write-back most of the rest (PERF.md).  The operations keep
// the plain version's weights; the order differs, so the result agrees to
// float rounding (edges exactly: a replicated pair has no difference).
// Any other scale runs the first design, a thread per pixel with run-time
// weights, and so does a view narrower than one block's 64*s columns: there
// most of a block's lanes would have no pixel, and each thread's 2s pixels
// by D planes run in series on a grid too small to fill the card.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kTH = kWarps;   // output rows of a block, one per warp
constexpr int kDC = 24;       // planes of one staged chunk of the volume

template <int kS>
struct Tile {
    static constexpr int kP = 2 * kS;           // pixels of a thread
    static constexpr int kTW = 32 * kP;         // output columns of a block
    static constexpr int kLR = kTH / kS + 2;    // low rows staged
    static constexpr int kLW = kTW / kS + 2;    // low columns staged
    static constexpr int kChunk = kDC * kLR * kLW;
    // Words of one column phase of a staged view row: the block's columns
    // and at least D - 1 more, in kP phases.
    static __host__ __device__ int phase_width(int num_d) {
        return 32 + (num_d + kP - 1) / kP;
    }
    static size_t smem_bytes(int num_d) {
        return sizeof(float) * (3 * kTH * kP * (size_t)phase_width(num_d)
                                + 2 * kChunk);
    }
};

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <int kS>
__global__ void __launch_bounds__(kThreads, 2)
upsample_blend_tiled(const float* __restrict__ prob,
                     const float* __restrict__ view, float* __restrict__ out,
                     int num_d, int hl, int wl, int H, int W) {
    using T = Tile<kS>;
    constexpr int kP = T::kP, kLR = T::kLR, kLW = T::kLW;
    extern __shared__ __align__(16) float smem[];
    const int pw = T::phase_width(num_d);
    const int vch = kTH * kP * pw;   // floats of one staged view channel
    float* sv = smem;                // [3][kTH][kP][pw]
    float* sp = smem + 3 * vch;      // [2][kDC][kLR][kLW]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = blockIdx.z;
    const int x0 = blockIdx.x * T::kTW, y0 = blockIdx.y * kTH;
    // Band row i is low row y0/s - 1 + i, band column j low column
    // x0/s - 1 + j, both clamped.
    const int p0 = y0 / kS - 1, q0 = x0 / kS - 1;

    // View rows y0 .. y0 + 7 of the three channels, columns x0 + k for
    // k < kP * pw, column k at [k % kP][k / kP]: thread t copies columns
    // t, t + 256, ... of every row, so its offsets are computed once.
    const int vcols = kP * pw;
    const size_t plane = (size_t)H * W;
    const float* vn = view + (size_t)n * 3 * plane + (size_t)y0 * W + x0;
    for (int k = threadIdx.x; k < vcols; k += kThreads) {
        float* d = sv + (k % kP) * pw + k / kP;
        const bool in_w = x0 + k < W;
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int i = 0; i < kTH; ++i) {
                float* di = d + (c * kTH + i) * vcols;
                if (in_w && y0 + i < H)
                    __pipeline_memcpy_async(di, vn + c * plane + i * W + k,
                                            sizeof(float));
                else
                    *di = 0.0f;
            }
    }
    // The band of one plane is kLR x kLW floats; thread t copies elements
    // t, t + 256, ... of every plane (row e / kLW, column e % kLW).
    constexpr int kBand = kLR * kLW;
    constexpr int kPer = (kBand + kThreads - 1) / kThreads;
    int off[kPer];   // in a low-resolution plane; -1: none
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const int e = threadIdx.x + u * kThreads;
        off[u] = e < kBand ? clamp_index(p0 + e / kLW, hl) * wl
                                 + clamp_index(q0 + e % kLW, wl)
                           : -1;
    }
    const size_t plane_lo = (size_t)hl * wl;
    const float* pn = prob + (size_t)n * num_d * plane_lo;
    auto stage_chunk = [&](int chunk) {
        const int d0 = chunk * kDC, nd = min(kDC, num_d - d0);
        float* dst = sp + (chunk & 1) * T::kChunk + threadIdx.x;
        const float* src = pn + d0 * plane_lo;
        for (int i = 0; i < nd; ++i, dst += kBand, src += plane_lo)
#pragma unroll
            for (int u = 0; u < kPer; ++u)
                if (off[u] >= 0)
                    __pipeline_memcpy_async(dst + u * kThreads, src + off[u],
                                            sizeof(float));
    };

    // Output row y = s*p + ry interpolates low rows (p-1, p) in the upper
    // half of its phases and (p, p+1) in the lower, at fraction fy.
    const int ry = warp % kS;
    const bool upper = ry < kS / 2;
    const int band_row = warp / kS + (upper ? 0 : 1);
    const float fy = (ry + 0.5f) / kS + (upper ? 0.5f : -0.5f);
    // The weights of the thread's kP pixels at the plane whose band rows
    // start at pp: low columns q-1 .. q+2 of the thread's q, q+1 along y,
    // then pixel i, phase r of low column i / s, between rv[k] and
    // rv[k + 1] along x.
    auto pixel_weights = [fy](const float* pp, float (&w)[kP]) {
        float rv[4], dv[3];
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
            const float2 t = *reinterpret_cast<const float2*>(pp + k);
            const float2 b = *reinterpret_cast<const float2*>(pp + kLW + k);
            rv[k] = t.x + fy * (b.x - t.x);
            rv[k + 1] = t.y + fy * (b.y - t.y);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) dv[k] = rv[k + 1] - rv[k];
#pragma unroll
        for (int i = 0; i < kP; ++i) {
            constexpr int kHalf = kS / 2;
            const int r = i % kS;
            const int k = i / kS + (r < kHalf ? 0 : 1);
            const float fx = (r + 0.5f) / kS + (r < kHalf ? 0.5f : -0.5f);
            w[i] = rv[k] + fx * dv[k];
        }
    };
    const float* vw = sv + warp * kP * pw + lane;
    float win[3][kP], acc[3][kP];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < kP; ++i) acc[c][i] = 0.0f;

    const int chunks = (num_d + kDC - 1) / kDC;
    stage_chunk(0);
    __pipeline_commit();
    for (int ch = 0; ch < chunks; ++ch) {
        // Chunk ch is in; the other buffer was last read before this
        // barrier, so chunk ch + 1 can go there now, while ch is blended.
        // (Queued earlier, it would share the memory system with the view
        // and chunk 0 at the start, when every block waits for those.)
        __pipeline_wait_prior(0);
        __syncthreads();
        if (ch + 1 < chunks) {
            stage_chunk(ch + 1);
            __pipeline_commit();
        }
        if (ch == 0) {
            // win[c][i] = view[c, y, x + i + d], x = x0 + kP*lane, at d = 0.
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int i = 0; i < kP; ++i) win[c][i] = vw[c * vch + i * pw];
        }
        const float* pb =
            sp + (ch & 1) * T::kChunk + band_row * kLW + 2 * lane;
        const int d0 = ch * kDC, nd = min(kDC, num_d - d0);
        int b = 0;
        for (; b + kP <= nd; b += kP) {
            const int m = (d0 + b) / kP;
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                float w[kP];
                pixel_weights(pb + (b + j) * kLR * kLW, w);
#pragma unroll
                for (int i = 0; i < kP; ++i)
#pragma unroll
                    for (int c = 0; c < 3; ++c) acc[c][i] += w[i] * win[c][i];
                // Plane d + 1 reads one column further: the new column
                // x + kP + d is phase j, word lane + m + 1.  Unrolled by
                // kP, the window's registers rotate back into place.
#pragma unroll
                for (int c = 0; c < 3; ++c) {
#pragma unroll
                    for (int i = 0; i < kP - 1; ++i) win[c][i] = win[c][i + 1];
                    win[c][kP - 1] = vw[c * vch + j * pw + m + 1];
                }
            }
        }
        // The last D mod kP planes, without the window: pixel i reads view
        // column x + i + d, phase (i + d) % kP, word lane + (i + d) / kP.
        for (; b < nd; ++b) {
            const int d = d0 + b;
            float w[kP];
            pixel_weights(pb + b * kLR * kLW, w);
#pragma unroll
            for (int i = 0; i < kP; ++i)
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    acc[c][i] += w[i] * vw[c * vch + ((i + d) % kP) * pw
                                           + (i + d) / kP];
        }
    }

    const int y = y0 + warp, x = x0 + kP * lane;
    if (y >= H) return;
    float* o = out + (size_t)n * 3 * plane + (size_t)y * W + x;
    if ((W & 3) == 0 && x + kP <= W) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int i = 0; i < kP; i += 4)
                *reinterpret_cast<float4*>(o + c * plane + i) = make_float4(
                    acc[c][i], acc[c][i + 1], acc[c][i + 2], acc[c][i + 3]);
        return;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < kP; ++i)
            if (x + i < W) o[c * plane + i] = acc[c][i];
}

// Any scale: a thread per output pixel, with run-time bilinear weights
// (PyTorch's formula) and the four low-resolution neighbours and three
// view values loaded per plane from global memory.
__global__ void upsample_blend_any_scale(const float* __restrict__ prob,
                                         const float* __restrict__ view,
                                         float* __restrict__ out, int num_d,
                                         int hl, int wl, int H, int W,
                                         float ry, float rx) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int n = blockIdx.z;
    if (x >= W) return;

    float sy = ry * ((float)y + 0.5f) - 0.5f;
    sy = sy < 0.0f ? 0.0f : sy;
    const int y0 = (int)sy;
    const int y1 = y0 + (y0 < hl - 1 ? 1 : 0);
    const float ly1 = sy - (float)y0, ly0 = 1.0f - ly1;
    float sx = rx * ((float)x + 0.5f) - 0.5f;
    sx = sx < 0.0f ? 0.0f : sx;
    const int x0 = (int)sx;
    const int x1 = x0 + (x0 < wl - 1 ? 1 : 0);
    const float lx1 = sx - (float)x0, lx0 = 1.0f - lx1;

    const size_t plane_lo = (size_t)hl * wl;
    const float* p = prob + (size_t)n * num_d * plane_lo;
    const int o00 = y0 * wl + x0, o01 = y0 * wl + x1;
    const int o10 = y1 * wl + x0, o11 = y1 * wl + x1;

    const size_t plane = (size_t)H * W;
    const float* v = view + (size_t)n * 3 * plane + (size_t)y * W;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
    const int d_end = num_d < W - x ? num_d : W - x;   // view is 0 past W
    for (int d = 0; d < d_end; ++d) {
        const float* pd = p + d * plane_lo;
        const float w = ly0 * (lx0 * __ldg(pd + o00) + lx1 * __ldg(pd + o01))
                      + ly1 * (lx0 * __ldg(pd + o10) + lx1 * __ldg(pd + o11));
        acc0 += w * __ldg(v + x + d);
        acc1 += w * __ldg(v + plane + x + d);
        acc2 += w * __ldg(v + 2 * plane + x + d);
    }
    float* o = out + (size_t)n * 3 * plane + (size_t)y * W + x;
    o[0] = acc0;
    o[plane] = acc1;
    o[2 * plane] = acc2;
}

template <int kS>
int launch_tiled(const float* prob, const float* view, float* out, int n,
                 int num_d, int hl, int wl, int H, int W,
                 cudaStream_t stream) {
    using T = Tile<kS>;
    const size_t smem = T::smem_bytes(num_d);
    auto kernel = upsample_blend_tiled<kS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + T::kTW - 1) / T::kTW, (H + kTH - 1) / kTH, n);
    kernel<<<grid, kThreads, smem, stream>>>(prob, view, out, num_d, hl, wl,
                                             H, W);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stereo_upsample_blend(const float* prob, const float* view,
                                     float* out, int n, int num_d, int hl,
                                     int wl, int H, int W, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (n == 0 || hl == 0 || wl == 0) return (int)cudaSuccess;   // no pixels
    const int s = H / hl;
    if (H != s * hl || W != s * wl) return (int)cudaErrorInvalidValue;
    if (s == 4 && W >= Tile<4>::kTW)
        return launch_tiled<4>(prob, view, out, n, num_d, hl, wl, H, W, st);
    if (s == 2 && W >= Tile<2>::kTW)
        return launch_tiled<2>(prob, view, out, n, num_d, hl, wl, H, W, st);
    const dim3 block(128);
    const dim3 grid((W + block.x - 1) / block.x, H, n);
    upsample_blend_any_scale<<<grid, block, 0, st>>>(
        prob, view, out, num_d, hl, wl, H, W, (float)hl / (float)H,
        (float)wl / (float)W);
    return (int)cudaGetLastError();
}
