// sampled_window: for each downscaled pixel, the (2k+3)-tap window of
// full-resolution inverted-SAD similarities that secondary matching scans,
// centred at full-res pixel (k*y, k*x) at disparities
// k*(d_mbm - 1) - 1 + s, s = 0 .. 2k+2.  Disparities may be negative; rows
// and columns wrap mod H and W.
//
// Replaces the TPU kernel stereo_tpu/ops/pallas/kernels.py::sampled_window
// (body _sampled_window_kernel).  Plain version:
// stereo_tpu_torch/ops/cuda/matching.py::sampled_window_plain.
//
// What bounds it on an H100: not memory.  It reads two full-res planes and
// the winners and writes the windows, about 7.8 MB at 384x1280 with k=2,
// a few microseconds at 3.35 TB/s.  The work is (2k+3) * (2r+1)^2 absolute
// differences per downscaled pixel (847 at k=2, r=5), about 0.3 GFLOP, and
// the loads that feed them.
//
// Design: the TPU kernel scans every one of the k*(D+1)+3 dense disparity
// planes and selects each pixel's taps by mask, because its lanes cannot
// gather.  Here each thread owns one downscaled pixel and computes only its
// own 2k+3 taps.  A block owns 64x4 downscaled pixels and stages, once, the
// full-res left rows and columns their patches cover and the right band
// for every disparity the config allows (k*(D+1)+2 more columns, so the
// band does not depend on the data), wrapping rows and columns as it
// stages them.  Both are stored split into their k column phases, as the
// TPU wrapper's to_phases does: neighbouring threads sit k full-res columns
// apart, so after the split a warp reads consecutive words.  At the
// headline shape (k, r) = (2, 5) every offset is a compile-time constant:
// for each patch column j the thread loads the left column's 11 values
// once and uses them for all 7 taps, and keeps the right columns of taps s
// and s+1 (neighbours) in a register window that slides with j, so it
// reads 11*11 + 17*11 values from shared memory instead of 2*7*11*11.  Each
// tap still sums a column's rows in index order, then the columns in index
// order: the plain version's order, so results agree bit for bit.
//
// Row-halo mode (the TPU kernel's rows_prepadded, run per row shard by the
// sharded engine): the inputs carry pad = r extra full-res rows above and
// below, from the neighbouring shards, and only the columns wrap.  It is
// the same kernel: the staging reads row i + pad instead of row i mod H.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kAny = -1;    // given at run time
constexpr int kTQ = 64, kTX = 4, kThreads = kTQ * kTX;

template <int kK, int kR>
struct Shape {
    static constexpr bool kFixed = kK != kAny;
    int k_, r_;
    __host__ __device__ int k() const { return kFixed ? kK : k_; }
    __host__ __device__ int r() const { return kFixed ? kR : r_; }
    __host__ __device__ int patch() const { return 2 * r() + 1; }
    __host__ __device__ int rows() const { return k() * (kTX - 1) + patch(); }
    __host__ __device__ int left_cols() const { return k() * (kTQ - 1) + patch(); }
    __host__ __device__ int right_cols(int num_d) const {
        return left_cols() + k() * (num_d + 1) + 2;
    }
    // Columns of one column phase.
    __host__ __device__ int phase_width(int cols) const { return (cols + k() - 1) / k(); }
    __host__ __device__ int left_floats() const {
        return k() * rows() * phase_width(left_cols());
    }
    __host__ __device__ int right_floats(int num_d) const {
        return k() * rows() * phase_width(right_cols(num_d));
    }
};

__device__ __forceinline__ int wrap_index(int i, int n) {
    if (i >= 0 && i < n) return i;
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// The input row that holds image row i.  pad == 0: the input is the image,
// and rows wrap mod H.  pad > 0: the input carries pad more rows above and
// below, and nothing wraps; rows staged only for the outputs past the last
// row, which are not stored, are clamped.
__device__ __forceinline__ int input_row(int i, int H, int pad) {
    if (pad == 0) return wrap_index(i, H);
    return min(max(i + pad, 0), H + 2 * pad - 1);
}

// Copy image rows top.. and columns col0.. (`rows` x `cols`, wrapped) into
// `dst`, split into the k column phases and stored column by column:
// column c, row y at dst[((c % k) * pw + c / k) * rows + y].  A warp then
// reads a patch row at a stride of `rows` words (odd, so no bank
// conflicts), and every row and column offset of a thread is a constant.
__device__ __forceinline__ void stage(float* dst, const float* src, int H,
                                      int W, int pad, int top, int col0,
                                      int rows, int cols, int k, int pw) {
    const int drow = kThreads / cols, dc = kThreads - drow * cols;
    for (int y = threadIdx.x / cols, c = threadIdx.x % cols; y < rows;) {
        __pipeline_memcpy_async(
            dst + ((c % k) * pw + c / k) * rows + y,
            src + (size_t)input_row(top + y, H, pad) * W + wrap_index(col0 + c, W),
            sizeof(float));
        y += drow;
        c += dc;
        if (c >= cols) {
            c -= cols;
            ++y;
        }
    }
}

template <int kK, int kR>
__global__ void __launch_bounds__(kThreads, 2)
sampled_window_kernel(const float* __restrict__ left,
                      const float* __restrict__ right,
                      const float* __restrict__ disp, float* __restrict__ out,
                      int H, int W, int hd, int wd, int min_dd, int num_d,
                      int pad, Shape<kK, kR> g) {
    extern __shared__ float smem[];
    const int k = g.k(), patch = g.patch(), win = 2 * k + 3;
    const int rows = g.rows();
    const int lpw = g.phase_width(g.left_cols());
    const int rpw = g.phase_width(g.right_cols(num_d));
    float* sL = smem;
    float* sR = smem + g.left_floats();

    // Left: the patches' rows and columns.  Right: the same shifted by
    // every disparity a tap can ask for, k*(min_dd-1)-1 .. that +
    // k*(D+1)+2, so band column c is right column lcol - dhi + c.
    const int q0 = blockIdx.x * kTQ, x0 = blockIdx.y * kTX;
    const int top = k * x0 - g.r(), lcol = k * q0 - g.r();
    const int dhi = k * (min_dd - 1) - 1 + k * (num_d + 1) + 2;
    stage(sL, left, H, W, pad, top, lcol, rows, g.left_cols(), k, lpw);
    stage(sR, right, H, W, pad, top, lcol - dhi, rows, g.right_cols(num_d), k,
          rpw);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int ql = threadIdx.x % kTQ, xl = threadIdx.x / kTQ;
    const int q = q0 + ql, x = x0 + xl;
    if (q >= wd || x >= hd) return;
    // Winners come from matching_core and lie in the range; clamping keeps
    // any other value inside the staged band.
    const int d_idx = min(max((int)disp[x * wd + q] - min_dd, 0), num_d - 1);
    // Tap s, patch column j reads left band column k*ql + j and right band
    // column k*(ql + D - 1 - d_idx) + u, u = j - s + 2k + 2 in 0 .. 2r+2k+2,
    // from patch row k*xl on.
    const float* lp = sL + ql * rows + k * xl;
    const float* rp = sR + (ql + num_d - 1 - d_idx) * rows + k * xl;
    const int lps = rows * lpw, rps = rows * rpw;   // phase strides
    const float area255 = (float)(patch * patch) * 255.0f;
    float* o = out + (size_t)x * wd + q;
    const size_t tap_stride = (size_t)hd * wd;

    if constexpr (Shape<kK, kR>::kFixed) {
        // j, u and i are compile-time here, so every phase, word and row
        // offset below is a constant.
        constexpr int P = 2 * kR + 1, WIN = 2 * kK + 3;
        float rw[WIN][P];   // rw[c]: right column u = j + c
#pragma unroll
        for (int c = 0; c < WIN - 1; ++c)
#pragma unroll
            for (int i = 0; i < P; ++i)
                rw[c][i] = rp[(c % kK) * rps + (c / kK) * rows + i];
        float acc[WIN];
#pragma unroll
        for (int s = 0; s < WIN; ++s) acc[s] = 0.0f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            constexpr int kLast = WIN - 1;
            const int u = j + kLast;
            float lv[P];
#pragma unroll
            for (int i = 0; i < P; ++i) {
                rw[kLast][i] = rp[(u % kK) * rps + (u / kK) * rows + i];
                lv[i] = lp[(j % kK) * lps + (j / kK) * rows + i];
            }
#pragma unroll
            for (int s = 0; s < WIN; ++s) {
                float cs = 0.0f;
#pragma unroll
                for (int i = 0; i < P; ++i) cs = cs + fabsf(lv[i] - rw[kLast - s][i]);
                acc[s] = acc[s] + cs;
            }
#pragma unroll
            for (int c = 0; c < kLast; ++c)
#pragma unroll
                for (int i = 0; i < P; ++i) rw[c][i] = rw[c + 1][i];
        }
#pragma unroll
        for (int s = 0; s < WIN; ++s) o[s * tap_stride] = area255 - acc[s];
    } else {
        // Tap by tap; the phase and word of each column are stepped, not
        // divided.  u starts at 2k+2 - s.
        int pu0 = (win - 1) % k, tu0 = (win - 1) / k;
#pragma unroll 1
        for (int s = 0; s < win; ++s) {
            int pl = 0, tl = 0, pu = pu0, tu = tu0;
            float acc = 0.0f;
            for (int j = 0; j < patch; ++j) {
                const float* lc = lp + pl * lps + tl * rows;
                const float* rc = rp + pu * rps + tu * rows;
                float cs = 0.0f;
                for (int i = 0; i < patch; ++i) cs = cs + fabsf(lc[i] - rc[i]);
                acc = acc + cs;
                if (++pl == k) {
                    pl = 0;
                    ++tl;
                }
                if (++pu == k) {
                    pu = 0;
                    ++tu;
                }
            }
            o[s * tap_stride] = area255 - acc;
            if (--pu0 < 0) {
                pu0 = k - 1;
                --tu0;
            }
        }
    }
}

template <int kK, int kR>
int launch(const float* left, const float* right, const float* disp,
           float* out, int H, int W, int hd, int wd, int min_dd, int num_d,
           int pad, Shape<kK, kR> g, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (g.left_floats() + g.right_floats(num_d));
    auto kernel = sampled_window_kernel<kK, kR>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((wd + kTQ - 1) / kTQ, (hd + kTX - 1) / kTX);
    kernel<<<grid, kThreads, smem, stream>>>(left, right, disp, out, H, W, hd,
                                             wd, min_dd, num_d, pad, g);
    return (int)cudaGetLastError();
}

}  // namespace

// H is the image's row count.  pad == 0: the images are (H, W) and rows
// wrap.  pad > 0: they are (H + 2 * pad, W), H == k * hd and pad >= r.
extern "C" int stereo_sampled_window(const float* left, const float* right,
                                     const float* disp, float* out, int H,
                                     int W, int hd, int wd, int k, int r,
                                     int min_dd, int num_d, int pad,
                                     void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (pad != 0 && (pad < r || H != k * hd)) return (int)cudaErrorInvalidValue;
    if (k == 2 && r == 5)   // MatchingConfig's defaults
        return launch(left, right, disp, out, H, W, hd, wd, min_dd, num_d, pad,
                      Shape<2, 5>{k, r}, st);
    return launch(left, right, disp, out, H, W, hd, wd, min_dd, num_d, pad,
                  Shape<kAny, kAny>{k, r}, st);
}
