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
// own 2k+3 taps straight from the full-res images (cached in L1/L2), so the
// work does not grow with D.  Each tap sums rows first, then columns, each
// in index order: the plain version's order, so results agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int wrap_index(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

__global__ void sampled_window_kernel(const float* __restrict__ left,
                                      const float* __restrict__ right,
                                      const float* __restrict__ disp,
                                      float* __restrict__ out,
                                      int H, int W, int hd, int wd, int k,
                                      int r, int min_dd) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    const int x = blockIdx.y * blockDim.y + threadIdx.y;
    if (q >= wd || x >= hd) return;

    const int win = 2 * k + 3;
    const int patch = 2 * r + 1;
    const float area255 = (float)(patch * patch) * 255.0f;
    const int d_idx = (int)disp[x * wd + q] - min_dd;
    const int d_first = k * (min_dd - 1) - 1 + k * d_idx;
    const int cy = k * x, cx = k * q;

    for (int s = 0; s < win; ++s) {
        const int dd = d_first + s;
        float acc = 0.0f;
        for (int j = 0; j < patch; ++j) {
            const int col = cx - r + j;
            const int cl = wrap_index(col, W);
            const int cr = wrap_index(col - dd, W);
            float cs = 0.0f;
            for (int i = 0; i < patch; ++i) {
                const int row = wrap_index(cy - r + i, H) * W;
                const float dv = fabsf(__ldg(left + row + cl) - __ldg(right + row + cr));
                cs = (i == 0) ? dv : cs + dv;
            }
            acc = (j == 0) ? cs : acc + cs;
        }
        out[((size_t)s * hd + x) * wd + q] = area255 - acc;
    }
}

}  // namespace

extern "C" int stereo_sampled_window(const float* left, const float* right,
                                     const float* disp, float* out, int H,
                                     int W, int hd, int wd, int k, int r,
                                     int min_dd, void* stream) {
    const dim3 block(64, 4);
    const dim3 grid((wd + block.x - 1) / block.x, (hd + block.y - 1) / block.y);
    sampled_window_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        left, right, disp, out, H, W, hd, wd, k, r, min_dd);
    return (int)cudaGetLastError();
}
