// gwc_volume: GwcNet's group-wise correlation volume,
//     vol[n, g, d, h, w] = mean_{c in group g} L[n, c, h, w] * R[n, c, h, w - d],
// and 0 where w < d.  Features are NCHW (float32 or bf16), the volume is
// (N, G, D, H, W) in the features' dtype: the layout the 3-D convolutions
// after it read, so no permute copy of the volume is needed.
//
// Replaces the TPU kernel stereo_tpu/ops/pallas/gwc_volume.py::
// build_gwc_volume_pallas (_kernel / _build_one), whose function is that of
// the XLA build stereo_tpu/models/cost_volumes.py::build_gwc_volume.
// Plain version: stereo_tpu_torch/ops/cuda/gwc_volume.py::gwc_volume_plain.
//
// What bounds it on an H100: memory.  At GwcNet's serving shape (C=320,
// G=40, 96x320 features, D=16 planes, float32) it reads 78.6 MB of
// features and writes a 78.6 MB volume, 47 us at 3.35 TB/s; its
// 2*D*H*W*C = 0.31 GFLOP take about 5 us at the float32 rate.  At D=48 the
// volume alone is 236 MB (94 us).
//
// Design: one thread per (n, g, h, w).  It loads its group's 8 left
// channels once into registers and loops over d, reading the right row at
// w - d and writing vol[n, g, d, h, w].  Consecutive threads take
// consecutive w, so every load and store of a warp is one contiguous run;
// the right row is re-read for each d at a shift of one element, which L1
// and L2 serve, so device memory sees each input about once.  The sum is
// taken in float32 and rounded to the volume's dtype on the store, as the
// Pallas kernel's float32 accumulator is.  The Pallas kernel's unrolled
// static D loop and two-row blocks exist only for Mosaic's sublane
// alignment and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// Channels per group: GwcNet's 320 features in 40 groups.
constexpr int kCpg = 8;

template <typename T>
__global__ void gwc_volume_kernel(const T* __restrict__ left,
                                  const T* __restrict__ right,
                                  T* __restrict__ out, int G, int D, int H,
                                  int W) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int h = blockIdx.y * blockDim.y + threadIdx.y;
    const int ng = blockIdx.z;              // n * G + g
    if (w >= W || h >= H) return;
    const int n = ng / G;
    const int g = ng - n * G;

    const size_t plane = (size_t)H * W;
    const int C = G * kCpg;
    // Channel c0 = g * kCpg of image n, at row h.
    const size_t base = ((size_t)n * C + (size_t)g * kCpg) * plane
                        + (size_t)h * W;
    float l[kCpg];
#pragma unroll
    for (int k = 0; k < kCpg; ++k) l[k] = to_float(left[base + k * plane + w]);

    const T* r = right + base;
    T* o = out + (size_t)ng * D * plane + (size_t)h * W + w;
    const float inv = 1.0f / (float)kCpg;
    for (int d = 0; d < D; ++d) {
        float acc = 0.0f;
        if (w >= d) {
#pragma unroll
            for (int k = 0; k < kCpg; ++k)
                acc = fmaf(l[k], to_float(__ldg(r + k * plane + w - d)), acc);
            acc *= inv;
        }
        store(o + (size_t)d * plane, acc);
    }
}

template <typename T>
int launch(const void* left, const void* right, void* out, int n, int c,
           int h, int w, int g, int d, cudaStream_t stream) {
    const dim3 block(64, 4);
    const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y,
                    n * g);
    const T* l = static_cast<const T*>(left);
    const T* r = static_cast<const T*>(right);
    T* o = static_cast<T*>(out);
    if (c != g * kCpg) return (int)cudaErrorInvalidValue;
    gwc_volume_kernel<T><<<grid, block, 0, stream>>>(l, r, o, g, d, h, w);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Channels per group (c / g) must be
// kCpg = 8; the wrapper checks this before the launch.
extern "C" int stereo_gwc_volume(const void* left, const void* right,
                                 void* out, int n, int c, int h, int w, int g,
                                 int d, int dtype, void* stream) {
    if (n * g == 0 || h == 0 || w == 0 || d == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch<float>(left, right, out, n, c, h, w, g, d, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(left, right, out, n, c, h, w, g, d, s);
    return (int)cudaErrorInvalidValue;
}
