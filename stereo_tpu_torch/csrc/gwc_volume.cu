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
// volume alone is 236 MB (94 us); in bf16 every byte count halves.  A
// device-to-device copy of the same bytes takes about 1.22x that bound on
// the card (chip_smoke.py --compare prints it beside every variant), so
// the copy rate, not the bound, is the reachable floor.
//
// The one-thread-per-output design before this one was held back by load
// instructions, not by device memory: each output re-read its channel
// group through L1 (cpg loads, 2 * cpg at a group size other than 8),
// 2 bytes a thread in bf16, so bf16 ran barely faster than float32 and 32
// channels per group took 13x the bound.
//
// Design:
// - A thread owns a strip of V columns (one 16-byte vector: 4 float32 or
//   8 bf16) of one (n, g, h) row and P planes (8 in float32, 4 in bf16),
//   32 float32 sums in registers.  Per channel it reads its left strip and
//   a window of P + V right values from shared memory and does P * V FMAs
//   from registers: the window slides one column a plane.
// - A block (about 256 threads: S strips x nPb plane chunks x R rows)
//   stages, for its R rows and at most 8 of the group's channels at a
//   time, the left rows of its column tile and the right rows from `padl`
//   columns further left, zero-filled outside the image, as 16-byte
//   cp.async copies that bypass L1.  Every input element thus leaves
//   device memory once per block.  A unit (rows x channel chunk) is
//   double-buffered: the next unit's copies are in flight while this one
//   is summed, so a group of any size streams through in chunks, and a
//   block with many rows walks up to kMaxSteps of them in turn.
// - Each output's channels are summed in channel order with fmaf from 0,
//   then multiplied by 1/cpg and rounded once on the store (0 where
//   w < d): the arithmetic of the earlier design, so the volume is the
//   same bit for bit.
// - Planes are stored as 16-byte vectors marked evict-first: the volume
//   is not read again here and should not push the features out of L2
//   (the row shards' features and volume fit in L2 together).
// - In bf16 a window starts on 8 bytes; neighbouring threads take
//   neighbouring plane chunks, so its reads are 8 bytes apart and free of
//   bank conflicts.  In float32 strips go fastest, 16 bytes apart.
// - The host's plan (make_plan) picks the column tile (at most 128
//   strips), the planes of a block (a multiple of 8; plane groups where
//   S * D is large, run next to each other so that they share the
//   features in L2), the rows side by side (about 256 threads, at most
//   48 KB of shared memory) and the rows a block walks.
// A width whose rows are not 16-byte aligned takes the same code with 8-,
// 4- or (odd bf16 widths) 2-byte copies and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 8;        // channels staged at a time, at most
constexpr int kPlaneStep = 8;       // a block's planes are a multiple of it
constexpr int kMaxStrips = 128;     // strips of a column tile
constexpr int kThreads = 256;       // threads a block aims at, and its bound
constexpr int kBlocksPerSM = 3;     // blocks of kThreads an SM must hold
constexpr int kMaxRows = 8;         // rows side by side in a block
constexpr int kMaxSteps = 4;        // row groups a block walks in turn
constexpr int kMinBlocks = 1024;    // blocks a launch keeps when it walks
constexpr size_t kSmemBytes = 48 * 1024;

// V: a strip's columns, one 16-byte vector.  P: the planes a thread sums,
// P * V = 32 sums in registers in either dtype.  Both divide kPlaneStep.
// planes_first: a block's threads take plane chunks fastest, then strips.
// In bf16 a window starts on 4 elements (8 bytes); with neighbouring
// threads on neighbouring chunks its reads are 8 bytes apart, free of
// bank conflicts.  In float32 strips go fastest, 16 bytes apart.
template <typename T>
struct Strip;
template <>
struct Strip<float> {
    static constexpr int V = 4, P = 8;
    static constexpr bool planes_first = false;
};
template <>
struct Strip<__nv_bfloat16> {
    static constexpr int V = 8, P = 4;
    static constexpr bool planes_first = true;
};

// The launch plan, computed on the host for one launch.  Grid: (row
// blocks * plane groups, the group fastest, so that the groups of a row
// read its features from L2; column tiles); block: (S, nPb, R), or
// (nPb, S, R) where planes go first.
struct Plan {
    int cpg, D, H, W, rows;  // rows = N * G * H
    int S, Wt;               // strips of a column tile, its columns S * V
    int nPb, padl, groups;   // plane chunks of a block, its planes nPb * P,
                             // plane groups
    int R, steps;            // rows side by side, row groups walked
    int kc, chunks, units;   // channels per stage, stages per row group,
                             // stages per block (steps * chunks)
    int seg, buf;            // elements per staged (row, channel), per buffer
    float inv;               // 1 / cpg
};

// Four elements from shared memory (16 bytes of float32, 8 of bf16).
__device__ __forceinline__ void unpack4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
}
__device__ __forceinline__ void unpack4(const __nv_bfloat16* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    // Element 2i is a word's low half; a bf16 is a float's high half.
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// A strip's V values rounded to T, as the four 32-bit words of 16 bytes.
__device__ __forceinline__ void pack(const float* f, unsigned* w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void pack_bf16(const float* f, unsigned* w) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
}

// Piece e of GB bytes of the 16 bytes in w, to global memory, marked to be
// evicted first: the volume is written once and not read here again, so
// it should not push the features out of L2.
template <int GB>
__device__ __forceinline__ void put(void* p, const unsigned* w, int e) {
    if constexpr (GB == 16)
        __stcs(reinterpret_cast<uint4*>(p),
               make_uint4(w[0], w[1], w[2], w[3]));
    else if constexpr (GB == 8)
        __stcs(reinterpret_cast<uint2*>(p),
               make_uint2(w[2 * e], w[2 * e + 1]));
    else if constexpr (GB == 4)
        __stcs(reinterpret_cast<unsigned*>(p), w[e]);
    else
        __stcs(reinterpret_cast<unsigned short*>(p),
               (unsigned short)(w[e >> 1] >> (16 * (e & 1))));
}

// GB (4, 8 or 16) bytes from global to shared memory, 16 bypassing L1; a
// piece outside the image writes zeros and reads nothing.
template <int GB>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool in) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (GB == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(d), "l"(src), "r"(in ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     ::"r"(d), "l"(src), "n"(GB), "r"(in ? GB : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A row block walks `steps` groups of R consecutive (n, g, h) rows; a unit
// is one row group and one chunk of channels; units alternate between two
// shared-memory buffers (one when a block has one unit).  GB: the bytes of
// each copy and store, the largest of 16, 8, 4 (and 2 in bf16) that the
// row stride and the pointers allow; under 4 the copies are plain loads.
// Every instance is held to kBlocksPerSM blocks of kThreads an SM (80
// registers, a few bytes of spill in some instances): unbounded, the
// narrower instances took 96-123 registers and 2 blocks an SM.
template <typename T, int GB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right,
                      T* __restrict__ out, const Plan p) {
    constexpr int V = Strip<T>::V;
    constexpr int P = Strip<T>::P;
    constexpr bool kPlanesFirst = Strip<T>::planes_first;
    constexpr int GE = GB / (int)sizeof(T);   // elements of a piece
    static_assert(P % 4 == 0 && V % 4 == 0, "windows are read 4 at a time");
    extern __shared__ uint4 smem_vec[];
    T* const smem = reinterpret_cast<T*>(smem_vec);

    const int rb = blockIdx.x / p.groups;       // the row block
    const int D0 = (blockIdx.x - rb * p.groups) * p.padl;
    const int wt0 = blockIdx.y * p.Wt;
    const int xs = (kPlanesFirst ? threadIdx.y : threadIdx.x) * V;
    const int pc = kPlanesFirst ? threadIdx.x : threadIdx.y;
    const size_t plane = (size_t)p.H * p.W;

    // Copy unit u's rows into buffer u & 1, the columns outside the image
    // as zeros: teams of 32 threads (one team in a smaller block), a team
    // to a staged (row, channel).
    auto stage = [&](int u) {
        const int step = u / p.chunks;
        const int k0 = (u - step * p.chunks) * p.kc;
        const int kn = min(p.kc, p.cpg - k0);
        const int threads = blockDim.x * blockDim.y * blockDim.z;
        const int tid = threadIdx.x + blockDim.x * (threadIdx.y
                                                    + blockDim.y
                                                      * threadIdx.z);
        const int span = min(32, threads);
        const int teams = threads / span;
        const int team = tid / span, member = tid - team * span;
        if (team >= teams) return;
        T* const dst = smem + (u & 1) * p.buf;
        const int q0 = (rb * p.steps + step) * p.R;
        const int cstart = wt0 - D0 - p.padl;
        for (int rk = team; rk < p.R * kn; rk += teams) {
            const int rr = rk / kn, k = rk - rr * kn;
            const int q = q0 + rr;
            if (q >= p.rows) continue;
            const int ng = q / p.H, h = q - ng * p.H;
            // Channel ng * cpg + k0 + k of image n is the group's k0 + k.
            const size_t base = ((size_t)ng * p.cpg + k0 + k) * plane
                                + (size_t)h * p.W;
            T* const drow = dst + (rr * p.kc + k) * p.seg;
            const int lvec = p.Wt / V;
            for (int j = member; j < p.seg / V; j += span) {
                const bool is_left = j < lvec;
                const T* const src = (is_left ? left : right) + base;
                const int col = is_left ? wt0 + j * V
                                        : cstart + (j - lvec) * V;
#pragma unroll
                for (int e = 0; e < V; e += GE) {
                    const int ce = col + e;
                    const bool in = ce >= 0 && ce < p.W;
                    if constexpr (GB >= 4)
                        copy_async<GB>(drow + j * V + e, in ? src + ce : src,
                                       in);
                    else
                        drow[j * V + e] = in ? src[ce]
                                             : __float2bfloat16(0.0f);
                }
            }
        }
    };

    float acc[P][V];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;

    // Sum unit u's channels into acc, in channel order.
    auto compute = [&](int u) {
        const int kn = min(p.kc, p.cpg - (u % p.chunks) * p.kc);
        const T* src = smem + (u & 1) * p.buf + threadIdx.z * p.kc * p.seg;
        // The window starts P columns left of the strip's shift.
        const int woff = p.Wt + p.padl + xs - pc * P - P;
#pragma unroll 1
        for (int k = 0; k < kn; ++k, src += p.seg) {
            float lv[V], win[P + V];
#pragma unroll
            for (int i = 0; i < V; i += 4) unpack4(src + xs + i, lv + i);
#pragma unroll
            for (int i = 0; i < P + V; i += 4)
                unpack4(src + woff + i, win + i);
#pragma unroll
            for (int j = 0; j < P; ++j)
#pragma unroll
                for (int v = 0; v < V; ++v)
                    acc[j][v] = fmaf(lv[v], win[P + v - j], acc[j][v]);
        }
    };

    // Write the strip's planes of row group `step`, then clear acc.
    auto store = [&](int step) {
        const int q = (rb * p.steps + step) * p.R + threadIdx.z;
        const int w0 = wt0 + xs;
        if (q < p.rows && w0 < p.W) {
            const int ng = q / p.H, h = q - ng * p.H;
            const int d0 = D0 + pc * P;
            T* const o = out + ((size_t)ng * p.D + d0) * plane
                         + (size_t)h * p.W + w0;
#pragma unroll
            for (int j = 0; j < P; ++j) {
                const int d = d0 + j;
                if (d >= p.D) break;
                float vals[V];
                unsigned words[4];
#pragma unroll
                for (int v = 0; v < V; ++v)
                    vals[v] = w0 + v >= d ? acc[j][v] * p.inv : 0.0f;
                if constexpr (sizeof(T) == 4)
                    pack(vals, words);
                else
                    pack_bf16(vals, words);
                T* const od = o + (size_t)j * plane;
#pragma unroll
                for (int e = 0; e < V; e += GE)
                    if (w0 + e < p.W) put<GB>(od + e, words, e / GE);
            }
        }
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[j][v] = 0.0f;
    };

    stage(0);
    cp_async_commit();
    for (int u = 0; u < p.units; ++u) {
        if (u + 1 < p.units) {
            stage(u + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        compute(u);
        if (u % p.chunks == p.chunks - 1) store(u / p.chunks);
        __syncthreads();   // buffer u & 1 is free for unit u + 2
    }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

size_t smem_bytes(const Plan& p, int elem) {
    return (size_t)min(p.units, 2) * p.R * p.kc * p.seg * elem;
}

Plan make_plan(int n, int c, int h, int w, int g, int d, int V, int P,
               int elem) {
    Plan p;
    p.cpg = c / g;
    p.D = d;
    p.H = h;
    p.W = w;
    p.rows = n * g * h;
    p.S = clampi(ceil_div(w, V), 1, kMaxStrips);
    p.Wt = p.S * V;
    // Planes go to a block 8 at a time (a multiple of P and of V, so that
    // staged rows start on a vector): as many as about kThreads threads
    // hold, the rest in plane groups of (nearly) equal size.
    const int per8 = kPlaneStep / P;            // threads' chunks per 8
    const int eights = ceil_div(d, kPlaneStep);
    p.groups = ceil_div(eights, clampi(kThreads / (p.S * per8), 1, eights));
    p.nPb = ceil_div(eights, p.groups) * per8;
    p.padl = p.nPb * P;
    p.seg = 2 * p.Wt + p.padl;
    p.kc = clampi(p.cpg, 1, kMaxChunk);
    p.chunks = ceil_div(p.cpg, p.kc);
    p.R = clampi(kThreads / (p.S * p.nPb), 1, kMaxRows);
    const int blocks = ceil_div(p.rows, p.R) * ceil_div(w, p.Wt) * p.groups;
    p.steps = clampi(blocks / kMinBlocks, 1, kMaxSteps);
    p.units = p.steps * p.chunks;
    while (smem_bytes(p, elem) > kSmemBytes && p.R > 1) --p.R;
    while (smem_bytes(p, elem) > kSmemBytes && p.kc > 1) {
        --p.kc;
        p.chunks = ceil_div(p.cpg, p.kc);
        p.units = p.steps * p.chunks;
    }
    p.buf = p.R * p.kc * p.seg;
    p.inv = 1.0f / (float)p.cpg;
    return p;
}

template <typename T, int GB>
void run(const T* l, const T* r, T* o, const Plan& p, size_t smem,
         cudaStream_t stream) {
    const dim3 grid(ceil_div(ceil_div(p.rows, p.R), p.steps) * p.groups,
                    ceil_div(p.W, p.Wt));
    const dim3 block(Strip<T>::planes_first ? p.nPb : p.S,
                     Strip<T>::planes_first ? p.S : p.nPb, p.R);
    gwc_volume_kernel<T, GB><<<grid, block, smem, stream>>>(l, r, o, p);
}

template <typename T>
int launch(const void* left, const void* right, void* out, int n, int c,
           int h, int w, int g, int d, cudaStream_t stream) {
    if (g <= 0 || c % g != 0) return (int)cudaErrorInvalidValue;
    constexpr int elem = (int)sizeof(T);
    const Plan p = make_plan(n, c, h, w, g, d, Strip<T>::V, Strip<T>::P,
                             elem);
    const size_t smem = smem_bytes(p, elem);
    if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
    const T* l = static_cast<const T*>(left);
    const T* r = static_cast<const T*>(right);
    T* o = static_cast<T*>(out);
    // The bytes every row start and pointer is a multiple of.
    const uintptr_t align = (uintptr_t)w * elem | (uintptr_t)left
                            | (uintptr_t)right | (uintptr_t)out;
    if (align % 16 == 0)
        run<T, 16>(l, r, o, p, smem, stream);
    else if (align % 8 == 0)
        run<T, 8>(l, r, o, p, smem, stream);
    else if (align % 4 == 0)
        run<T, 4>(l, r, o, p, smem, stream);
    else if (elem == 2 && align % 2 == 0)
        run<T, elem == 2 ? 2 : 4>(l, r, o, p, smem, stream);
    else
        return (int)cudaErrorMisalignedAddress;
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  g must divide c; the channels per
// group (c / g) may be any number.
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
