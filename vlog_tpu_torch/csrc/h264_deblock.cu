// H.264 in-loop deblocking (spec 8.7) for Hopper (sm_90a): the whole
// wavefront of one codecs/h264/deblock.py::deblock_frame call, every frame
// of the batch and all three planes, in one launch.
//
// Replaces no Pallas kernel. The JAX package's filter
// (vlog_tpu/codecs/h264/deblock.py) is plain jnp that XLA fuses; the port's
// plain PyTorch version of it launched a gather, 30-40 elementwise
// operations, a where and a scatter for each of 12 edge passes of each
// anti-diagonal of macroblocks: about 15,000 host launches a 360p frame of
// the ladder, with the card idle between them. This kernel is new, written
// for this card; the plain version stays as the CPU path and the version the
// tests hold it to.
//
// What it computes, bit for bit as the plain version. Op `idx` (0-3 the
// vertical edges at x = 16c + 4 idx, 4-7 the horizontal edges at y = 16r +
// 4 (idx - 4)) of macroblock (r, c) runs at phase 8 (r + c) + idx, a linear
// extension of the spec's raster order; the macroblocks of one anti-diagonal
// k = r + c run one phase together (their windows are disjoint). Chroma
// takes the even edges at the chroma positions (x = 8c + 2 idx), each with
// the luma edge's bS, two lines a bS segment. The picture-left edge (c == 0,
// idx 0) and the picture-top edge (r == 0, idx 4) are left alone. A line
// with bS <= 0, or outside the alpha/beta gate, is left as it is. The line
// filters are _filter_luma_lines (bS 1-3 with tc0[clip(bS, 1, 3) - 1],
// bS 4 the strong filter) and _filter_chroma_lines, in int32 arithmetic.
// indexA = indexB = clip(qp, 0, 51) per frame, the chroma QP from table
// 8-15 of it; no filter offsets.
//
// Bound. The filter is in-loop: a phase reads what the one before wrote,
// so each plane is a chain of dependent steps, separated by block barriers:
// (mbh + mbw - 1) diagonals x 8 edge steps for luma (4 for chroma), 496 at
// 360p (23 x 40 macroblocks) and 1,496 at 1080p (68 x 120), whatever the
// batch. The least a step can cost is a barrier and a dependent write and
// read of device memory: vt_h264_deblock_barrier_probe measures it, 41 ns
// at the 360p call's 384 threads and 62 ns at 1080p's 1,024 on an H100
// (700 W), so the chain bound is 0.020 ms at 360p and 0.093 ms at 1080p.
// The bytes are small beside it: the ladder's call (6 frames of 368 x
// 640) reads 2.1 MB of uint8 planes and writes 8.5 MB of int32, 3 us at
// 3.35 TB/s; the filters' operations, about 100 per line of 8 pixels, are
// a few microseconds of the card's int32 lanes. So the chain bounds the
// call (chip_smoke.py's h264_deblock_kernel phase states it beside the
// kernel's time). A real step also reads its bS and its pixel windows
// from L1/L2, filters and stores: about 0.8 us a step at 360p.
//
// Design: one thread block per (frame, plane), luma blocks first, then U,
// then V; they run at the same time, since each plane's filter reads only
// that plane and all three take the same bS.
//   * The block first copies its input plane (uint8) into the int32
//     output plane, then filters the output plane in place in device memory
//     (the 360p luma plane, 235 KB even as bytes, does not fit a block's
//     shared memory; the working set stays in L1 and L2).
//   * It walks the diagonals in order and, on each, the edge steps 0-7 in
//     order (chroma: 0, 2, 4, 6), with __syncthreads() after each step. A
//     thread takes one (macroblock on the diagonal, line of the edge) and
//     loops where the diagonal holds more lines than the block has threads;
//     the host sizes the block to the longest luma diagonal (16 lines a
//     macroblock), at most 1,024 threads.
//   * A vertical luma edge's window is 8 aligned int32 of one row (two
//     16-byte loads); a horizontal edge's window is 8 rows of one column,
//     and a warp's 32 lines are 32 adjacent columns (coalesced).
//   * Tables 8-16 (alpha, beta), 8-17 (tc0) and 8-15 (chroma QP) live in
//     constant memory; each block reads its frame's qp from the device.
//     The host reads nothing back.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define VT_ALPHA {                                                          \
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8,        \
    9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63,       \
    71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255}
#define VT_BETA {                                                           \
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3,        \
    3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13,          \
    13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18}
#define VT_TC0 {                                                            \
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,       \
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5,       \
     6, 6, 7, 8, 9, 10, 11, 13},                                             \
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,       \
     1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7,       \
     8, 8, 10, 11, 12, 13, 15, 17},                                          \
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,       \
     1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9,          \
     10, 11, 13, 14, 16, 18, 20, 23, 25}}
#define VT_CHROMA_QP {                                                      \
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,   \
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34,  \
    35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39}

namespace {

constexpr int QPS = 52;
constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 128;        // the copy's width on tiny frames

__constant__ int kAlpha[QPS] = VT_ALPHA;
__constant__ int kBeta[QPS] = VT_BETA;
__constant__ int kTc0[3][QPS] = VT_TC0;
__constant__ int kChromaQp[QPS] = VT_CHROMA_QP;

const int hAlpha[QPS] = VT_ALPHA;
const int hBeta[QPS] = VT_BETA;
const int hTc0[3][QPS] = VT_TC0;
const int hChromaQp[QPS] = VT_CHROMA_QP;

struct Thr {
    int alpha, beta, tc0_1, tc0_2, tc0_3;   // tc0 for bS 1, 2, 3
};

__device__ inline int clip3(int lo, int hi, int x) { return x < lo ? lo : (x > hi ? hi : x); }

__device__ inline int tc0_of(int bs, const Thr& t) {
    return bs <= 1 ? t.tc0_1 : (bs == 2 ? t.tc0_2 : t.tc0_3);
}

// Spec 8.7.2.3 (bS 1-3) and 8.7.2.4 (bS 4) on one line w = [p3 .. q3], in
// place, select for select as _filter_luma_lines (every candidate is
// computed, so a warp's lines of different bS do not diverge); false
// where the line stays as it was.
__device__ inline bool filter_luma(int (&w)[8], int bs, const Thr& t) {
    const int p3 = w[0], p2 = w[1], p1 = w[2], p0 = w[3];
    const int q0 = w[4], q1 = w[5], q2 = w[6], q3 = w[7];
    if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta && abs(q1 - q0) < t.beta))
        return false;
    const bool ap = abs(p2 - p0) < t.beta, aq = abs(q2 - q0) < t.beta;
    const int c0 = tc0_of(bs, t);
    const int tc = c0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    const int p0n = clip3(0, 255, p0 + delta), q0n = clip3(0, 255, q0 - delta);
    const int p1n = ap ? p1 + clip3(-c0, c0, (p2 + avg - 2 * p1) >> 1) : p1;
    const int q1n = aq ? q1 + clip3(-c0, c0, (q2 + avg - 2 * q1) >> 1) : q1;

    const bool small = abs(p0 - q0) < ((t.alpha >> 2) + 2);
    const bool sp = ap && small, sq = aq && small;
    const int p0s = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                       : (2 * p1 + p0 + q1 + 2) >> 2;
    const int p1s = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    const int p2s = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    const int q0s = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                       : (2 * q1 + q0 + p1 + 2) >> 2;
    const int q1s = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    const int q2s = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;

    const bool is4 = bs == 4;
    w[1] = is4 ? p2s : p2;
    w[2] = is4 ? p1s : p1n;
    w[3] = is4 ? p0s : p0n;
    w[4] = is4 ? q0s : q0n;
    w[5] = is4 ? q1s : q1n;
    w[6] = is4 ? q2s : q2;
    return true;
}

// The chroma edge filter on w = [p1 p0 q0 q1], in place, as
// _filter_chroma_lines.
__device__ inline bool filter_chroma(int (&w)[4], int bs, const Thr& t) {
    const int p1 = w[0], p0 = w[1], q0 = w[2], q1 = w[3];
    if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta && abs(q1 - q0) < t.beta))
        return false;
    const int tc = tc0_of(bs, t) + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const bool is4 = bs == 4;
    w[1] = is4 ? (2 * p1 + p0 + q1 + 2) >> 2 : clip3(0, 255, p0 + delta);
    w[2] = is4 ? (2 * q1 + q0 + p1 + 2) >> 2 : clip3(0, 255, q0 - delta);
    return true;
}

// One edge step of one line: `px` is the window's first pixel, `stride`
// the distance between its pixels (1 across a vertical edge, the row
// pitch across a horizontal one).
template <int MB>
__device__ inline void edge_line(int32_t* px, long long stride, int bs, const Thr& t) {
    if (MB == 16) {
        int w[8];
        if (stride == 1) {                  // 16-byte aligned: x = 16c + 4i - 4
            const int4 a = reinterpret_cast<const int4*>(px)[0];
            const int4 b = reinterpret_cast<const int4*>(px)[1];
            w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
            w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) w[i] = px[i * stride];
        }
        if (!filter_luma(w, bs, t)) return;
        if (stride == 1) {
            reinterpret_cast<int4*>(px)[0] = make_int4(w[0], w[1], w[2], w[3]);
            reinterpret_cast<int4*>(px)[1] = make_int4(w[4], w[5], w[6], w[7]);
        } else {
#pragma unroll
            for (int i = 1; i < 7; ++i) px[i * stride] = w[i];
        }
    } else {
        int w[4];
        if (stride == 1) {                  // 8-byte aligned: x = 8c + 2i - 2
            const int2 a = reinterpret_cast<const int2*>(px)[0];
            const int2 b = reinterpret_cast<const int2*>(px)[1];
            w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = px[i * stride];
        }
        if (!filter_chroma(w, bs, t)) return;
        px[stride] = w[1];
        px[2 * stride] = w[2];
    }
}

// The in-place wavefront over one plane (MB = 16 luma, 8 chroma).
template <int MB>
__device__ void filter_plane(int32_t* plane, const int32_t* __restrict__ bs_v,
                             const int32_t* __restrict__ bs_h, int mbh, int mbw,
                             const Thr& t) {
    constexpr int SEG = MB / 4;             // lines a bS segment
    const int W = MB * mbw;
    for (int k = 0; k < mbh + mbw - 1; ++k) {
        const int r0 = k - mbw + 1 > 0 ? k - mbw + 1 : 0;
        const int r1 = k < mbh - 1 ? k : mbh - 1;
        const int items = (r1 - r0 + 1) * MB;
        for (int step = 0; step < 8; ++step) {
            const int e = step & 3;
            if (MB == 8 && (e & 1)) continue;   // chroma: even edges only
            const bool vertical = step < 4;
            for (int it = threadIdx.x; it < items; it += blockDim.x) {
                const int r = r0 + it / MB, l = it % MB, c = k - r;
                if (e == 0 && (vertical ? c == 0 : r == 0)) continue;
                const int seg = ((r * mbw + c) * 4 + e) * 4 + l / SEG;
                const int bs = vertical ? bs_v[seg] : bs_h[seg];
                if (bs <= 0) continue;
                // chroma edge e (0 or 2) sits at 2e in its MB, luma's at 4e
                const int off = (MB / 4) * e - MB / 4;
                if (vertical)
                    edge_line<MB>(plane + static_cast<long long>(MB * r + l) * W
                                  + MB * c + off, 1, bs, t);
                else
                    edge_line<MB>(plane + static_cast<long long>(MB * r + off) * W
                                  + MB * c + l, W, bs, t);
            }
            __syncthreads();
        }
    }
}

// dst[i] = src[i] over `count` samples (a multiple of 64); with `vec`
// (both 16-byte aligned) 16 bytes a load, so that a thread has several
// loads in flight.
__device__ void copy_plane(const uint8_t* __restrict__ src, int32_t* __restrict__ dst,
                           long long count, bool vec) {
    if (!vec) {
        for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
        return;
    }
    const uint4* s = reinterpret_cast<const uint4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll 4
    for (long long i = threadIdx.x; i < count / 16; i += blockDim.x) {
        const uint4 x = s[i];
        const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
            d[4 * i + j] = make_int4(words[j] & 255, (words[j] >> 8) & 255,
                                     (words[j] >> 16) & 255, words[j] >> 24);
    }
}

// blockIdx.x: [0, n) luma of frame f, [n, 2n) its U, [2n, 3n) its V.
__global__ void __launch_bounds__(MAX_THREADS)
h264_deblock_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v, const int32_t* __restrict__ qp,
                    const int32_t* __restrict__ bs_v, const int32_t* __restrict__ bs_h,
                    long long bs_stride_v, long long bs_stride_h, int32_t* oy,
                    int32_t* ou, int32_t* ov, int n, int mbh, int mbw, bool vec) {
    const int plane = blockIdx.x / n, f = blockIdx.x % n;
    int q = qp[f];
    q = q < 0 ? 0 : (q > QPS - 1 ? QPS - 1 : q);
    if (plane > 0) q = kChromaQp[q];
    const Thr t{kAlpha[q], kBeta[q], kTc0[0][q], kTc0[1][q], kTc0[2][q]};
    const int32_t* bv = bs_v + f * bs_stride_v;
    const int32_t* bh = bs_h + f * bs_stride_h;
    if (plane == 0) {
        const long long count = 256LL * mbh * mbw;
        int32_t* out = oy + f * count;
        copy_plane(y + f * count, out, count, vec);
        __syncthreads();
        filter_plane<16>(out, bv, bh, mbh, mbw, t);
    } else {
        const long long count = 64LL * mbh * mbw;
        int32_t* out = (plane == 1 ? ou : ov) + f * count;
        copy_plane((plane == 1 ? u : v) + f * count, out, count, vec);
        __syncthreads();
        filter_plane<8>(out, bv, bh, mbh, mbw, t);
    }
}

// `steps` dependent steps of one block barrier each: a thread writes a
// cell, the barrier, then it reads its neighbour's (two buffers, so one
// barrier a step is enough). The cells are in shared memory, or with
// `global_mem` in device memory (`out`, 2 x blockDim int32), as the
// kernel's planes are: the latency of a wavefront step with no filter
// work, for the chain bound.
__global__ void __launch_bounds__(MAX_THREADS)
h264_deblock_barrier_probe(int steps, bool global_mem, int32_t* out) {
    __shared__ int shared_cells[2 * MAX_THREADS];
    int* cell = global_mem ? out : shared_cells;
    const int n = blockDim.x;
    int acc = threadIdx.x;
    for (int s = 0; s < steps; ++s) {
        cell[(s & 1) * n + threadIdx.x] = acc;
        __syncthreads();
        acc += cell[(s & 1) * n + (threadIdx.x + 1) % n];
    }
    if (acc == INT_MIN) out[threadIdx.x] = acc;   // never true; keeps the loop
}

int threads_for(int mbh, int mbw) {
    const int lines = 16 * (mbh < mbw ? mbh : mbw);
    const int t = (lines + 31) / 32 * 32;
    return t < MIN_THREADS ? MIN_THREADS : (t > MAX_THREADS ? MAX_THREADS : t);
}

}  // namespace

// The tables the kernel holds, for the wrapper to compare with its own:
// out[0..51] alpha, [52..103] beta, [104..259] tc0 (bS 1, 2, 3),
// [260..311] the chroma QP.
extern "C" void vt_h264_deblock_tables(int* out) {
    for (int i = 0; i < QPS; ++i) {
        out[i] = hAlpha[i];
        out[QPS + i] = hBeta[i];
        for (int b = 0; b < 3; ++b) out[(2 + b) * QPS + i] = hTc0[b][i];
        out[5 * QPS + i] = hChromaQp[i];
    }
}

// The block size a call on an mbh x mbw frame launches with.
extern "C" int vt_h264_deblock_threads(int mbh, int mbw) { return threads_for(mbh, mbw); }

// y (n, 16 mbh, 16 mbw), u and v (n, 8 mbh, 8 mbw) uint8 planes; qp (n,)
// int32; bs_v and bs_h (mbh, mbw, 4, 4) int32
// blocks, frame f's at f * bs_stride (0: one for every frame); oy, ou, ov
// int32 planes of the inputs' shapes. All contiguous on the current device.
// Launches one kernel on `stream`; returns cudaErrorInvalidValue for
// arguments it does not take, else cudaGetLastError() after the launch.
extern "C" int vt_h264_deblock(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                               const int32_t* qp,
                               const int32_t* bs_v, const int32_t* bs_h,
                               long long bs_stride_v, long long bs_stride_h,
                               int32_t* oy, int32_t* ou, int32_t* ov, int n,
                               int mbh, int mbw, void* stream) {
    if (n < 1 || mbh < 1 || mbw < 1
        || n > INT_MAX / 3 || bs_stride_v < 0 || bs_stride_h < 0
        || static_cast<long long>(mbh) * mbw > INT_MAX / 256)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int threads = threads_for(mbh, mbw);
    const bool vec = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(u)
                       | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(oy)
                       | reinterpret_cast<uintptr_t>(ou) | reinterpret_cast<uintptr_t>(ov))
                      & 15) == 0;
    h264_deblock_kernel<<<3 * n, threads, 0, st>>>(y, u, v, qp, bs_v, bs_h, bs_stride_v,
                                                   bs_stride_h, oy, ou, ov, n, mbh,
                                                   mbw, vec);
    return static_cast<int>(cudaGetLastError());
}

// One block of `threads` running `steps` barrier steps, its cells in
// shared memory or (global_mem) in `out`, 2 x threads int32.
extern "C" int vt_h264_deblock_barrier_probe(int threads, int steps, int global_mem,
                                             int32_t* out, void* stream) {
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    h264_deblock_barrier_probe<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        steps, global_mem != 0, out);
    return static_cast<int>(cudaGetLastError());
}
