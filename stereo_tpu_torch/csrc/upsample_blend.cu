// upsample_blend: Deep3D's view-synthesis tail,
//     out[n, c, y, x] = sum_d up(prob)[n, d, y, x] * view[n, c, y, x + d],
// where up() is the bilinear upsample by `scale` (half-pixel centres,
// align_corners=False, clamped at the edges) and the view is zero past the
// right edge.  The full-resolution (D, H, W) volume is never stored.
//
// Replaces the TPU kernel stereo_tpu/ops/pallas/blend.py::upsample_blend
// (_upsample_rows_blend / _blend_kernel, with the column upsample that ran
// beside it).  Plain version:
// stereo_tpu_torch/ops/cuda/blend.py::upsample_blend_plain.
//
// What bounds it on an H100: memory, in principle.  It reads the
// low-resolution volume (8.0 MB at 65x96x320) and the view (5.9 MB at
// 3x384x1280) and writes the output (5.9 MB): 19.8 MB, 5.9 us at
// 3.35 TB/s.  The arithmetic, about 13 flops per pixel and plane
// (0.4 GFLOP), is of the same order at the float32 rate, so the kernel
// is close to balanced.
//
// Design: one thread per output pixel.  Its bilinear coordinates and
// weights depend only on (y, x), so they are computed once; the thread
// then loops over d, interpolates prob[d] from its four low-resolution
// neighbours (which neighbouring threads share, so they come from L1/L2)
// and accumulates the three channels of view[y, x + d], whose loads are
// coalesced across the warp.  The TPU's selection-matmul row interpolation
// and its separate column phases have no counterpart: on this card the
// interpolation is a handful of FMAs.  The weights follow PyTorch's
// bilinear formula, so the result tracks the plain version to float
// rounding.

#include <cuda_runtime.h>

namespace {

__global__ void upsample_blend_kernel(const float* __restrict__ prob,
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

}  // namespace

extern "C" int stereo_upsample_blend(const float* prob, const float* view,
                                     float* out, int n, int num_d, int hl,
                                     int wl, int H, int W, void* stream) {
    const dim3 block(128);
    const dim3 grid((W + block.x - 1) / block.x, H, n);
    upsample_blend_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        prob, view, out, num_d, hl, wl, H, W, (float)hl / (float)H,
        (float)wl / (float)W);
    return (int)cudaGetLastError();
}
