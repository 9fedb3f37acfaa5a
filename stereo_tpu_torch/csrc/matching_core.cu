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
// writes four, about 2.9 MB at 192x640, under a microsecond at 3.35 TB/s.
// The work is about 70 float operations per pixel and plane at the headline
// radii (r, s, m, L) = (1, 1, 4, 10): the 3x3 SAD and the three box sums,
// every sum a run of direct adds in index order (no sliding sums), which is
// what keeps the result equal to the plain version's bit for bit.  With the
// halos of a 32x32 tile it issues about 100 adds per pixel and plane, one
// instruction each, and the loads that feed them: the SM's instruction
// issue is the limit, and one block of 8 warps nearly saturates it.
//
// Design.  A cluster of blocks owns a 32x32 output tile; block q of the
// cluster walks the q-th contiguous chunk of the D planes.  Each block
// stages the left tile and the right band of its chunk (rows and columns
// wrapped mod H and W once, here, with cp.async), then per plane:
//   1. cost over the tile and its halo: each thread takes one column of a
//      band of kBand rows, so the |L-R| differences and the horizontal
//      3-sums of a row are computed once and reused by the three cost rows
//      that need them (the separable 3x3: ((a+b)+c) across, then down);
//   2. the horizontal runs of the three MBM windows (2L+1, 2s+1, 2m+1
//      taps), each thread eight neighbouring output columns of one row,
//      so the loads of overlapping runs are shared;
//   3. the vertical runs, the product (h*v)*c and the winner test, each
//      thread four rows of one column, whose winner state stays in
//      registers across the planes.
// Shapes are compile-time for the headline radii (every index is a
// constant offset, every loop unrolled); other radii run the same kernel
// with run-time radii.  After the last plane each block leaves, per
// output pixel, its chunk's best, index, neighbours inside the chunk and
// its first and last plane's aggregate in shared memory, and the blocks
// merge through distributed shared memory in chunk order: a later chunk
// wins only with a strictly greater best (first maximum wins), a winner on
// a chunk's edge takes its neighbour from the adjacent chunk, and planes
// 0 and D-1 wrap mod D.  Every aggregate is computed with the plain
// version's arithmetic, so the merged result is bit-identical.  Since a
// split only adds staging and a merge to the same work per plane, the
// launcher splits a tile only into as many chunks as leave every block on
// the card at once (cluster_size): 2 at the KITTI main path, where the
// 120 tiles would leave SM slots empty, and 1 at Middlebury, 510 tiles.
//
// Row-halo mode (the TPU kernel's rows_prepadded, run per row shard by the
// sharded engine): the inputs carry pad extra rows above and below, taken
// from the neighbouring shards, and only the columns wrap.  It is the same
// kernel: the staging reads row i + pad instead of row i mod h.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kAny = -1;           // radius given at run time
constexpr int kTileW = 32, kTileH = 32, kThreads = 256;
constexpr int kOut = kTileW * kTileH;
constexpr int kRowsPerThread = kOut / kThreads;   // step 3: 4 rows of a column
constexpr int kSeg = 8;                            // step 2: 8 columns of a row
constexpr int kSegs = kTileW / kSeg;
constexpr int kHS = kTileW + 1;    // row stride of the horizontal runs
constexpr int kState = 6;          // per-pixel fields of a chunk's result

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Radii and the shapes that follow from them: compile-time when the
// template fixes the radii, else taken from the arguments.
template <int kR, int kS, int kM, int kL>
struct Shape {
    static constexpr bool kFixed = kR != kAny;
    static constexpr int kHaloC = imax(kS, imax(kM, kL));
    static constexpr int kCHC = kTileH + 2 * kHaloC;
    // Cost rows per thread: a quarter of the cost region (13) at the
    // headline radii.
    static constexpr int kBand = kFixed ? kCHC / 4 : 8;
    // The bands cover the cost rows exactly: no row needs a guard.
    static constexpr bool kExactBands = kFixed && kCHC % kBand == 0;

    int r_, s_, m_, l_;
    __host__ __device__ int r() const { return kFixed ? kR : r_; }
    __host__ __device__ int s() const { return kFixed ? kS : s_; }
    __host__ __device__ int m() const { return kFixed ? kM : m_; }
    __host__ __device__ int l() const { return kFixed ? kL : l_; }
    __host__ __device__ int halo() const { return imax(s(), imax(m(), l())); }
    __host__ __device__ int ch() const { return kTileH + 2 * halo(); }  // cost rows
    __host__ __device__ int cw() const { return kTileW + 2 * halo(); }  // cost cols
    __host__ __device__ int cws() const { return cw() | 1; }            // its stride
    __host__ __device__ int ph() const { return ch() + 2 * r(); }       // pixel rows
    __host__ __device__ int pw() const { return cw() + 2 * r(); }       // pixel cols
    // The staged images are stored column by column, at this (odd) stride.
    __host__ __device__ int phs() const { return ph() | 1; }
    // Float offsets of the arrays in dynamic shared memory; the right band
    // (its width depends on the chunk) comes last.
    __host__ __device__ int off_c() const { return pw() * phs(); }
    __host__ __device__ int off_xl() const { return off_c() + ch() * cws(); }
    __host__ __device__ int off_xs() const { return off_xl() + (kTileH + 2 * s()) * kHS; }
    __host__ __device__ int off_xm() const { return off_xs() + (kTileH + 2 * l()) * kHS; }
    __host__ __device__ int off_r() const { return off_xm() + (kTileH + 2 * m()) * kHS; }
};

__device__ __forceinline__ int wrap_index(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// The input row that holds image row i (-pad <= i < h + pad for every row
// an output row of the image reads).  pad == 0: the input is the image, and
// rows wrap mod h.  pad > 0: the input carries pad more rows above and
// below (a row shard extended by its neighbours' rows), and nothing wraps;
// the rows of a tile's outputs past h, which are not stored, are clamped.
__device__ __forceinline__ int input_row(int i, int h, int pad) {
    if (pad == 0) return wrap_index(i, h);
    return min(max(i + pad, 0), h + 2 * pad - 1);
}

// This thread's items of a grid with `cols` columns, row-major, in steps
// of kThreads: set up once, then stepped without a division.
struct Walk {
    int row, col, drow, dcol, cols;
    __device__ explicit Walk(int cols_) : cols(cols_) {
        row = threadIdx.x / cols;
        col = threadIdx.x - row * cols;
        drow = kThreads / cols;
        dcol = kThreads - drow * cols;
    }
    __device__ void next() {
        row += drow;
        col += dcol;
        if (col >= cols) {
            col -= cols;
            ++row;
        }
    }
};

// Sum of taps p[0], p[stride], ... in index order.
__device__ __forceinline__ float run(const float* p, int stride, int taps) {
    float acc = p[0];
#pragma unroll
    for (int t = 1; t < taps; ++t) acc = acc + p[t * stride];
    return acc;
}

template <int kR, int kS, int kM, int kL>
__global__ void __launch_bounds__(kThreads, 2)
matching_core_kernel(const float* __restrict__ left,
                     const float* __restrict__ right,
                     float* __restrict__ disp, float* __restrict__ mbm,
                     int h, int w, int min_dd, int num_d, int pad,
                     Shape<kR, kS, kM, kL> g) {
    using G = Shape<kR, kS, kM, kL>;
    extern __shared__ float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cl = (int)cluster.num_blocks();
    const int q = (int)cluster.block_rank();
    const int d0 = q * num_d / cl, d1 = (q + 1) * num_d / cl;

    const int r = g.r(), s = g.s(), m = g.m(), L = g.l(), halo = g.halo();
    const int CH = g.ch(), CW = g.cw(), CWS = g.cws();
    const int PH = g.ph(), PW = g.pw(), PHS = g.phs();
    const int RW = PW + (d1 - d0) - 1;
    float* sL = smem;
    float* sC = smem + g.off_c();
    float* sXL = smem + g.off_xl();   // runs of 2L+1 across, rows halo-s ..
    float* sXS = smem + g.off_xs();   // runs of 2s+1 across, rows halo-L ..
    float* sXM = smem + g.off_xm();   // runs of 2m+1 across, rows halo-m ..
    float* sR = smem + g.off_r();

    const int tid = threadIdx.x;
    const int x0 = (blockIdx.x / cl) * kTileW, y0 = blockIdx.y * kTileH;

    // Stage the left tile and the right band, wrapping once (rows only
    // without a row pad, see input_row), column by column (pixel (py, px)
    // at px * PHS + py): every row and column offset a thread reads below
    // is then a constant.  sR column c holds right
    // column x0 - halo - r - (min_dd + d1 - 1) + c, so plane d reads it at
    // offset d1 - 1 - d from the left tile's column.
    const int top = y0 - halo - r, lcol = x0 - halo - r;
    const int rcol = lcol - (min_dd + d1 - 1);
    for (Walk it(PW); it.row < PH; it.next())
        __pipeline_memcpy_async(
            sL + it.col * PHS + it.row,
            left + input_row(top + it.row, h, pad) * w + wrap_index(lcol + it.col, w),
            sizeof(float));
    for (Walk it(RW); it.row < PH; it.next())
        __pipeline_memcpy_async(
            sR + it.col * PHS + it.row,
            right + input_row(top + it.row, h, pad) * w + wrap_index(rcol + it.col, w),
            sizeof(float));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const float area255 = (float)((2 * r + 1) * (2 * r + 1)) * 255.0f;
    const int nbands = (CH + G::kBand - 1) / G::kBand;
    const Walk cost_items(CW);      // (band, cost column)
    const Walk run_items(kSegs);    // (cost row, 8-column segment)
    const int x = tid % kTileW, yt = (tid / kTileW) * kRowsPerThread;

    float best[kRowsPerThread], prev[kRowsPerThread], first[kRowsPerThread];
    float mprev[kRowsPerThread], mnext[kRowsPerThread];
    int bidx[kRowsPerThread];
    bool pending[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
        best[t] = -INFINITY;
        prev[t] = first[t] = mprev[t] = mnext[t] = 0.0f;
        bidx[t] = d0;
        pending[t] = false;
    }

    for (int d = d0; d < d1; ++d) {
        // 1. Cost over the tile and its halo, a band of rows per thread.
        const float* rband = sR + (d1 - 1 - d) * PHS;
        for (Walk it = cost_items; it.row < nbands; it.next()) {
            const int cx = it.col, c0 = it.row * G::kBand;
            const float* lp = sL + cx * PHS + c0;
            const float* rp = rband + cx * PHS + c0;
            float out[G::kBand];
#pragma unroll
            for (int t = 0; t < G::kBand; ++t) {
                if (!G::kExactBands && c0 + t >= CH) break;
                float box = 0.0f;
#pragma unroll
                for (int a = 0; a <= 2 * r; ++a) {
                    const float* la = lp + t + a;
                    const float* ra = rp + t + a;
                    float hs = fabsf(la[0] - ra[0]);
#pragma unroll
                    for (int b = 1; b <= 2 * r; ++b)
                        hs = hs + fabsf(la[b * PHS] - ra[b * PHS]);
                    box = (a == 0) ? hs : box + hs;
                }
                out[t] = area255 - box;
            }
#pragma unroll
            for (int t = 0; t < G::kBand; ++t) {
                if (!G::kExactBands && c0 + t >= CH) break;
                sC[(c0 + t) * CWS + cx] = out[t];
            }
        }
        __syncthreads();

        // 2. Horizontal runs of the three windows, 8 columns of a row per
        // thread.  Every row computes all three runs and keeps those its
        // windows read: branch-free, the runs share their loads (measured
        // faster than computing only the runs a row needs).
        for (Walk it = run_items; it.row < CH; it.next()) {
            const int row = it.row, xs = it.col * kSeg;
            const float* c = sC + row * CWS + halo + xs;
            float xl[kSeg], xsh[kSeg], xm[kSeg];
#pragma unroll
            for (int j = 0; j < kSeg; ++j) {
                xl[j] = run(c + j - L, 1, 2 * L + 1);
                xsh[j] = run(c + j - s, 1, 2 * s + 1);
                xm[j] = run(c + j - m, 1, 2 * m + 1);
            }
            const int rl = row - (halo - s), rs = row - (halo - L),
                      rm = row - (halo - m);
#pragma unroll
            for (int j = 0; j < kSeg; ++j) {
                if (rl >= 0 && rl < kTileH + 2 * s) sXL[rl * kHS + xs + j] = xl[j];
                if (rs >= 0 && rs < kTileH + 2 * L) sXS[rs * kHS + xs + j] = xsh[j];
                if (rm >= 0 && rm < kTileH + 2 * m) sXM[rm * kHS + xs + j] = xm[j];
            }
        }
        __syncthreads();

        // 3. Vertical runs, the aggregate and the winner test.
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t) {
            const int y = yt + t;
            const float hrz = run(sXL + y * kHS + x, kHS, 2 * s + 1);
            const float vrt = run(sXS + y * kHS + x, kHS, 2 * L + 1);
            const float ctr = run(sXM + y * kHS + x, kHS, 2 * m + 1);
            const float agg = (hrz * vrt) * ctr;
            if (d == d0) first[t] = agg;
            const bool is_new_best = agg > best[t];
            if (is_new_best) mprev[t] = prev[t];
            if (pending[t]) mnext[t] = agg;
            pending[t] = is_new_best;
            if (is_new_best) {
                best[t] = agg;
                bidx[t] = d;
            }
            prev[t] = agg;
        }
    }

    // The chunk's result per pixel, over the staging arrays (once every
    // thread is done with the last plane).
    __syncthreads();
    float* st = smem;
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
        const int o = (yt + t) * kTileW + x;
        st[0 * kOut + o] = best[t];
        st[1 * kOut + o] = (float)bidx[t];
        st[2 * kOut + o] = mprev[t];   // at bidx - 1 when bidx > d0
        st[3 * kOut + o] = mnext[t];   // at bidx + 1 when bidx < d1 - 1
        st[4 * kOut + o] = first[t];   // at d0
        st[5 * kOut + o] = prev[t];    // at d1 - 1
    }
    cluster.sync();

    // Merge in chunk order; block q writes its share of the tile's pixels.
    const int plane = h * w;
    for (int o = q * kOut / cl + tid; o < (q + 1) * kOut / cl; o += kThreads) {
        float top_best = -INFINITY;
        int win = 0;
        for (int c = 0; c < cl; ++c) {
            const float b = cluster.map_shared_rank(st, c)[o];
            if (b > top_best) {
                top_best = b;
                win = c;
            }
        }
        const float* ws = cluster.map_shared_rank(st, win);
        const int idx = (int)ws[1 * kOut + o];
        const int w0 = win * num_d / cl, w1 = (win + 1) * num_d / cl;
        float mp, mn;
        if (idx == 0)
            mp = cluster.map_shared_rank(st, cl - 1)[5 * kOut + o];   // mod-D wrap
        else if (idx == w0)
            mp = cluster.map_shared_rank(st, win - 1)[5 * kOut + o];
        else
            mp = ws[2 * kOut + o];
        if (idx == num_d - 1)
            mn = cluster.map_shared_rank(st, 0)[4 * kOut + o];         // mod-D wrap
        else if (idx == w1 - 1)
            mn = cluster.map_shared_rank(st, win + 1)[4 * kOut + o];
        else
            mn = ws[3 * kOut + o];
        const int y = y0 + o / kTileW, xx = x0 + o % kTileW;
        if (y < h && xx < w) {
            const int p = y * w + xx;
            disp[p] = (float)(idx + min_dd);
            mbm[p] = mp;
            mbm[plane + p] = top_best;
            mbm[2 * plane + p] = mn;
        }
    }
    // No block may leave while another still reads its shared memory.
    cluster.sync();
}

template <int kR, int kS, int kM, int kL>
size_t smem_bytes(Shape<kR, kS, kM, kL> g, int chunk) {
    const size_t floats = (size_t)g.off_r() + (size_t)g.phs() * (g.pw() + chunk - 1);
    const size_t state = (size_t)kState * kOut;
    return sizeof(float) * (floats > state ? floats : state);
}

// The split pays only while the tiles leave block slots of the card empty:
// one block already keeps an SM's issue slots busy (a block of a split
// tile does the same work per plane, and stages its own copy of the
// tile).  So take the largest size in 1, 2, 4, 8 (at most D) whose
// blocks all fit on the card at once.
int cluster_size(int tiles, int num_d, int blocks_per_sm) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    int cl = 1;
    while (cl < 8 && 2 * cl <= num_d && tiles * 2 * cl <= sms * blocks_per_sm)
        cl *= 2;
    return cl;
}

template <int kR, int kS, int kM, int kL>
int launch(const float* left, const float* right, float* disp, float* mbm,
           int h, int w, int min_dd, int num_d, int pad,
           Shape<kR, kS, kM, kL> g, cudaStream_t stream) {
    auto kernel = matching_core_kernel<kR, kS, kM, kL>;
    const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + kTileH - 1) / kTileH;
    // The most shared memory a block takes (no split) bounds every size.
    // Keeping these runtime queries per device and shape saved no host
    // time measurably (PERF.md section 6), so every launch makes them.
    const size_t most = smem_bytes(g, num_d);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    int blocks_per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                        kThreads, most);
    if (err != cudaSuccess) return (int)err;
    const int cl = cluster_size(tiles_x * tiles_y, num_d, blocks_per_sm);
    const size_t smem = smem_bytes(g, (num_d + cl - 1) / cl);

    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(tiles_x * cl, tiles_y);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cl;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, left, right, disp, mbm, h, w,
                             min_dd, num_d, pad, g);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// h is the output's row count.  pad == 0: the inputs are (h, w) and rows
// wrap.  pad > 0: they are (h + 2 * pad, w), pad >= max(s, m, L) + r, and
// row y of the output reads input rows y + pad - (max(s, m, L) + r) ..
// y + pad + max(s, m, L) + r.
extern "C" int stereo_matching_core(const float* left, const float* right,
                                    float* disp, float* mbm, int h, int w,
                                    int min_dd, int num_d, int r, int s, int m,
                                    int L, int pad, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (pad != 0 && pad < imax(s, imax(m, L)) + r)
        return (int)cudaErrorInvalidValue;
    if (r == 1 && s == 1 && m == 4 && L == 10)   // MatchingConfig's defaults
        return launch(left, right, disp, mbm, h, w, min_dd, num_d, pad,
                      Shape<1, 1, 4, 10>{r, s, m, L}, st);
    return launch(left, right, disp, mbm, h, w, min_dd, num_d, pad,
                  Shape<kAny, kAny, kAny, kAny>{r, s, m, L}, st);
}
