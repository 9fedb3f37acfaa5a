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
// Design: one thread per (n, g, h, w).  It loops over d, reading the right
// row at w - d and writing vol[n, g, d, h, w].  The group size is a
// run-time argument.  At GwcNet's 8 channels per group it is a
// compile-time instance that loads its group's left channels once into
// registers; any other size walks its channels in a loop, the left values
// re-read from L1 for each plane: more loads per output, slower against
// its bound (PERF.md section 6 has its times), and run by no configuration.
// Consecutive threads take consecutive w, so every load and store of a
// warp is one contiguous run; the right row is re-read for each d at a
// shift of one element, which L1 and L2 serve, so device memory sees each
// input about once.  Channels are summed in index order in float32, scaled
// by 1/cpg (the Pallas kernel's averaging matrix) and rounded to the
// volume's dtype on the store, as the Pallas kernel's float32 accumulator
// is.  The Pallas kernel's unrolled static D loop and two-row blocks exist
// only for Mosaic's sublane alignment and have no counterpart here.

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

// Channels per group of the compile-time instance: GwcNet's 320 features
// in 40 groups.
constexpr int kCpg = 8;

// CPG > 0: exactly CPG channels per group, known at compile time.
// CPG == 0: `cpg` channels, known at run time.
template <typename T, int CPG>
__global__ void gwc_volume_kernel(const T* __restrict__ left,
                                  const T* __restrict__ right,
                                  T* __restrict__ out, int G, int cpg, int D,
                                  int H, int W) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int h = blockIdx.y * blockDim.y + threadIdx.y;
    const int ng = blockIdx.z;              // n * G + g
    if (w >= W || h >= H) return;
    if (CPG > 0) cpg = CPG;
    const int n = ng / G;
    const int g = ng - n * G;

    const size_t plane = (size_t)H * W;
    const int C = G * cpg;
    // Channel c0 = g * cpg of image n, at row h.
    const size_t base = ((size_t)n * C + (size_t)g * cpg) * plane
                        + (size_t)h * W;
    const T* l = left + base + w;
    const T* r = right + base;
    T* o = out + (size_t)ng * D * plane + (size_t)h * W + w;
    const float inv = 1.0f / (float)cpg;
    if (CPG > 0) {
        float lv[CPG > 0 ? CPG : 1];
#pragma unroll
        for (int k = 0; k < CPG; ++k) lv[k] = to_float(l[k * plane]);
        for (int d = 0; d < D; ++d) {
            float acc = 0.0f;
            if (w >= d) {
#pragma unroll
                for (int k = 0; k < CPG; ++k)
                    acc = fmaf(lv[k], to_float(__ldg(r + k * plane + w - d)),
                               acc);
                acc *= inv;
            }
            store(o + (size_t)d * plane, acc);
        }
        return;
    }
    for (int d = 0; d < D; ++d) {
        float acc = 0.0f;
        if (w >= d) {
#pragma unroll 8
            for (int k = 0; k < cpg; ++k) {
                const size_t off = (size_t)k * plane;
                acc = fmaf(to_float(__ldg(l + off)),
                           to_float(__ldg(r + off + w - d)), acc);
            }
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
    if (g <= 0 || c % g != 0) return (int)cudaErrorInvalidValue;
    const int cpg = c / g;
    if (cpg == kCpg)
        gwc_volume_kernel<T, kCpg><<<grid, block, 0, stream>>>(l, r, o, g, cpg,
                                                               d, h, w);
    else
        gwc_volume_kernel<T, 0><<<grid, block, 0, stream>>>(l, r, o, g, cpg,
                                                            d, h, w);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  g must divide c; the channels per
// group (c / g) may be any number, with 8 the compile-time instance.
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
