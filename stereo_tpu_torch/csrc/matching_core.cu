// matching_core: inverted-SAD cost volume + multi-block-matching aggregation
// + first-max winner-take-all + the three MBM parabola costs, in one pass
// over the downscaled grayscale pair.  The (H_d, W_d, D) volume is never
// stored.
//
// Replaces the TPU kernel stereo_tpu/ops/pallas/kernels.py::matching_core
// (body _matching_core_kernel).  Plain version:
// stereo_tpu_torch/ops/cuda/matching.py::matching_core_plain.
//
// What bounds it on an H100: not memory.  It reads two (H_d, W_d) planes and
// writes four, about 2.9 MB at 192x640, which is under a microsecond at
// 3.35 TB/s.  The work is about 100 float adds per pixel and plane (the 3x3
// SAD and three box sums), which is 0.4 GFLOP at D=33 and a few
// microseconds of the card's float32 rate.  What costs is traffic through
// shared memory and the block barriers between the stages of each plane.
//
// Design: one block owns a 32x16 output tile.  It loads the left tile with
// an 11-pixel halo (MBM radius + cost radius) and the right band that covers
// every disparity shift once, with wrap-around borders on both axes.  It
// then loops over the D planes itself: each plane's cost over the tile plus
// halo, the column-direction box sums of the three MBM windows and the
// row-direction sums per pixel.  The winner and its neighbours are carried
// in registers (best, index, previous plane, plane 0, last plane, the
// pending flag and the two neighbours), so nothing of the volume leaves
// the SM.  Every sum is taken in the plain version's order (columns first,
// then rows, each in index order), the product is (horizontal * vertical)
// * center and the winner test is a strict '>' (first maximum wins), so
// the kernel gives the plain version's result bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

__device__ __forceinline__ int wrap_index(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ float box_run(const float* p, int stride, int taps) {
    float acc = p[0];
    for (int t = 1; t < taps; ++t) acc = acc + p[t * stride];
    return acc;
}

__global__ void matching_core_kernel(const float* __restrict__ left,
                                     const float* __restrict__ right,
                                     float* __restrict__ disp,
                                     float* __restrict__ mbm,
                                     int h, int w, int min_dd, int num_d,
                                     int r, int s, int m, int L, int halo) {
    extern __shared__ float smem[];
    const int CH = kTileH + 2 * halo, CW = kTileW + 2 * halo;  // cost region
    const int PH = CH + 2 * r, PW = CW + 2 * r;                // pixel region
    const int RW = PW + num_d - 1;                             // right band
    float* sL = smem;
    float* sR = sL + PH * PW;
    float* sC = sR + PH * RW;
    float* sH = sC + CH * CW;
    float* sV = sH + (kTileH + 2 * s) * kTileW;
    float* sM = sV + (kTileH + 2 * L) * kTileW;

    const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTileW + tx, nthreads = kTileW * kTileH;
    const int max_dd = min_dd + num_d - 1;

    for (int i = tid; i < PH * PW; i += nthreads) {
        const int py = i / PW, px = i - py * PW;
        sL[i] = left[wrap_index(y0 - halo - r + py, h) * w
                     + wrap_index(x0 - halo - r + px, w)];
    }
    // sR column c holds right[x0 - halo - r - max_dd + c]: plane d reads it
    // at offset (max_dd - (min_dd + d)) from the left tile's column.
    for (int i = tid; i < PH * RW; i += nthreads) {
        const int py = i / RW, px = i - py * RW;
        sR[i] = right[wrap_index(y0 - halo - r + py, h) * w
                      + wrap_index(x0 - halo - r - max_dd + px, w)];
    }
    __syncthreads();

    const int patch = 2 * r + 1;
    const float area255 = (float)(patch * patch) * 255.0f;
    float best = -INFINITY, best_idx = 0.0f, prev = 0.0f, plane0 = 0.0f;
    float last = 0.0f, mprev = 0.0f, mnext = 0.0f;
    bool pending = false;

    for (int d = 0; d < num_d; ++d) {
        const int roff = num_d - 1 - d;
        for (int i = tid; i < CH * CW; i += nthreads) {
            const int cy = i / CW, cx = i - cy * CW;
            float box = 0.0f;
            for (int a = 0; a < patch; ++a) {
                const float* lrow = sL + (cy + a) * PW + cx;
                const float* rrow = sR + (cy + a) * RW + cx + roff;
                float cs = fabsf(lrow[0] - rrow[0]);
                for (int b = 1; b < patch; ++b)
                    cs = cs + fabsf(lrow[b] - rrow[b]);
                box = (a == 0) ? cs : box + cs;
            }
            sC[i] = area255 - box;
        }
        __syncthreads();

        // Column-direction sums of each MBM window, on the rows its
        // row-direction sum will need.
        for (int i = tid; i < (kTileH + 2 * s) * kTileW; i += nthreads) {
            const int j = i / kTileW, x = i - j * kTileW;
            sH[i] = box_run(sC + (halo - s + j) * CW + halo + x - L, 1, 2 * L + 1);
        }
        for (int i = tid; i < (kTileH + 2 * L) * kTileW; i += nthreads) {
            const int j = i / kTileW, x = i - j * kTileW;
            sV[i] = box_run(sC + (halo - L + j) * CW + halo + x - s, 1, 2 * s + 1);
        }
        for (int i = tid; i < (kTileH + 2 * m) * kTileW; i += nthreads) {
            const int j = i / kTileW, x = i - j * kTileW;
            sM[i] = box_run(sC + (halo - m + j) * CW + halo + x - m, 1, 2 * m + 1);
        }
        __syncthreads();

        const float hrz = box_run(sH + ty * kTileW + tx, kTileW, 2 * s + 1);
        const float vrt = box_run(sV + ty * kTileW + tx, kTileW, 2 * L + 1);
        const float ctr = box_run(sM + ty * kTileW + tx, kTileW, 2 * m + 1);
        const float agg = (hrz * vrt) * ctr;

        if (d == 0) plane0 = agg;
        const bool is_new_best = agg > best;
        if (is_new_best) mprev = prev;
        if (pending) mnext = agg;
        pending = is_new_best;
        if (is_new_best) {
            best_idx = (float)d;
            best = agg;
        }
        prev = agg;
        if (d == num_d - 1) last = agg;
    }

    const int y = y0 + ty, x = x0 + tx;
    if (y < h && x < w) {
        const int o = y * w + x;
        const int plane = h * w;
        disp[o] = best_idx + (float)min_dd;
        mbm[o] = (best_idx == 0.0f) ? last : mprev;             // mod-D wrap
        mbm[plane + o] = best;
        mbm[2 * plane + o] = (best_idx == (float)(num_d - 1)) ? plane0 : mnext;
    }
}

size_t matching_core_smem_bytes(int num_d, int r, int s, int m, int L, int halo) {
    const size_t CH = kTileH + 2 * halo, CW = kTileW + 2 * halo;
    const size_t PH = CH + 2 * r, PW = CW + 2 * r;
    const size_t RW = PW + num_d - 1;
    const size_t floats = PH * PW + PH * RW + CH * CW
        + (size_t)(kTileH + 2 * s) * kTileW + (size_t)(kTileH + 2 * L) * kTileW
        + (size_t)(kTileH + 2 * m) * kTileW;
    return floats * sizeof(float);
}

}  // namespace

extern "C" int stereo_matching_core(const float* left, const float* right,
                                    float* disp, float* mbm, int h, int w,
                                    int min_dd, int num_d, int r, int s, int m,
                                    int L, void* stream) {
    int halo = s > m ? s : m;
    halo = halo > L ? halo : L;
    const size_t smem = matching_core_smem_bytes(num_d, r, s, m, L, halo);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            matching_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(kTileW, kTileH);
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
    matching_core_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        left, right, disp, mbm, h, w, min_dd, num_d, r, s, m, L, halo);
    return (int)cudaGetLastError();
}
