// Fused ladder resize for Hopper (sm_90a): out = uint8(clip(rint((A_h . f32(x)) . A_w^T), 0, 255)).
//
// Replaces the TPU kernel vlog_tpu/ops/pallas_ladder.py::fused_resize_plane
// (l.101; body _rung_kernel, l.90-98): per plane, two float32 products in a
// fixed order -- first T = A_h . x (rows), rounded to float32, then T . A_w^T
// (columns) -- and a quantising epilogue that rounds half to even (rintf, as
// jnp.round and torch.round; not roundf), clamps to [0, 255] and stores uint8.
//
// Bound. Per 24-frame dispatch of the 1080p ladder (9 plane calls: Y 1080x1920
// -> 720x1280, 480x854, 360x640; U and V 540x960 -> 360x640, 240x427,
// 180x320) the function must read each uint8 source once per call and write
// each uint8 rung once: about 281 MB, 0.084 ms at 3.35 TB/s. A_h and A_w are
// bands (lanczos3: 5-17 contiguous nonzero taps per row), and a zero tap
// leaves an fmaf sum exactly as it was, so the arithmetic the function needs
// is the bands' nonzero taps: about 2.0 G fmaf (3.9 GFLOP), 0.058 ms at
// 67 TFLOP/s. The function is bound by bytes.
//
// Design: one banded launch per plane call, T kept in shared memory.
//   * Band form (ops/resize.py::band_form, built once per matrix and cached
//     by the wrapper): rows in groups of G = 4; group g has one window of
//     `span` source indices from first[g], and taps[g][s][i] =
//     A[4g+i][first[g]+s] (zero outside row 4g+i's band). The wrapper pads
//     the groups to whole tiles and gives each output tile the source window
//     [lo, hi) that its groups need, on both axes.
//   * A work item is a 32x64 output tile of one frame. Its block stages the
//     tile's uint8 source window in shared memory, runs the vertical pass
//     into a float32 T tile in shared memory, then the horizontal pass from
//     it, quantises, and stores the tile's rows coalesced. T never goes to
//     device memory; each source byte is read from device memory about once
//     (tile halos mostly hit L2) and each rung byte is written once.
//   * Vertical pass: a thread owns 4 output rows (one group) x 4 source
//     columns; it walks the group's window in ascending source row, loads 4
//     source bytes with one 32-bit shared load, converts them exactly
//     (2^23 + b as float bits, minus 2^23) and does 16 fmaf with the 4 rows'
//     taps (one 16-byte shared load). Horizontal pass: a thread owns 2 tile
//     rows x one group of 4 output columns and walks the group's window of T
//     in ascending column with 8 fmaf per 16-byte tap load.
//   * streaming_resize_kernel, when every tile window fits one chunk (all
//     lanczos, bilinear and box downscales of the ladder): persistent blocks
//     walk the items and copy the next item's window, taps and first indices
//     into a second slot with cp.async while they compute this one.
//   * chunked_resize_kernel, for any other band (a dense matrix, say): one
//     block per tile and frame walks the window in chunks of up to 128 source
//     rows x 256 columns; the partial T stays in shared memory across row
//     chunks and the partial outputs in registers across column chunks.
//     Chunks go in ascending order, so the order of every sum is unchanged.
//
// Why the bytes equal the dense two-GEMM kernel this replaces: that kernel
// summed fmaf(A[r][k], x[k][c], acc) over every k in ascending order from
// 0.0f, zeros included, then the same over T's columns, then rintf and clamp.
// This one sums the same products in the same ascending order, with the same
// fmaf and the same float32 T, and leaves out only taps outside the window,
// which are zero: fmaf(0, v, acc) == acc for finite v (acc starts at +0 and
// can never become -0). So every T value and every output byte is the same.
// The build passes -fmad=false, so nvcc contracts nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 4;                    // rows (columns) per band group
constexpr int TILE_H = 32;              // output rows per tile: 8 row groups
constexpr int TILE_W = 64;              // output columns per tile: 16 column groups
constexpr int THREADS = 256;
constexpr int GROUPS_H = TILE_H / G;
constexpr int GROUPS_W = TILE_W / G;
constexpr int MIN_BLOCKS = 4;           // blocks per SM: at most 64 registers a thread
// The horizontal pass: a thread owns HR tile rows x one column group; the
// (row block, group) pairs go round the block's threads PAIRS times.
constexpr int HR = 2;
constexpr int ROW_BLOCKS = TILE_H / HR;
constexpr int PAIRS = (ROW_BLOCKS * GROUPS_W + THREADS - 1) / THREADS;
constexpr int OUT_PITCH = TILE_W + 4;   // bytes; keeps the lanes' word stores conflict-free
constexpr int COL_ALIGN = 16;           // column windows start on a multiple: 16-byte copies
constexpr int MAX_ROWS = 128;           // source rows per chunk
constexpr int MAX_COLS = 256;           // source columns per chunk
static_assert(TILE_H % HR == 0 && ROW_BLOCKS * GROUPS_W % 32 == 0,
              "the horizontal pass's pairs fill whole warps");
static_assert(GROUPS_H % 4 == 0 && GROUPS_W % 4 == 0, "first indices copy 16 bytes at a time");

struct Band {
    const int* first;     // (groups,) first source index of each group's window
    const float4* taps;   // (groups, span) x G taps
    const int* win;       // (tiles, 2): [lo, hi) source window of each output tile
    int span;
    int groups;           // groups with rows in the matrix; the arrays hold
                          // a whole number of tiles, padded with zero taps
};

// Exact uint8 -> float32: the bits 0x4B0000bb are the float 2^23 + b.
__device__ __forceinline__ float byte_to_float(uint32_t word, uint32_t sel) {
    return __int_as_float(__byte_perm(word, 0x4B000000u, sel)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t quantise(float v) {
    return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

// Rows [s0, s0 + sn) and columns [q0, q0 + nc) of one frame into src
// (pitch qc). With vec (W % 16 == 0, aligned base; q0 is a multiple of 16
// and the window ends at or before W, so every vector lies in the row)
// 16-byte cp.async copies that land while the block computes; otherwise
// byte loads, with zeros past qn.
__device__ __forceinline__ void stage_src(const uint8_t* __restrict__ xf, int W,
                                          int s0, int sn, int q0, int qn, int nc,
                                          uint8_t* src, int qc, bool vec) {
    if (vec) {
        const int nv = (qn + 15) / 16;
        for (int i = threadIdx.x; i < sn * nv; i += THREADS) {
            const int r = i / nv, v = i - r * nv;
            cp_async16(src + r * qc + v * 16,
                       xf + static_cast<long long>(s0 + r) * W + q0 + v * 16);
        }
    } else {
        for (int i = threadIdx.x; i < sn * nc; i += THREADS) {
            const int r = i / nc, c = i - r * nc;
            src[r * qc + c] = c < qn ? xf[static_cast<long long>(s0 + r) * W + q0 + c] : 0;
        }
    }
}

// Vertical pass over one staged chunk of rows [s0, s0 + sn): T[4rg+i][q] +=
// taps x source, in ascending source row; T starts at zero when `fresh`.
// taps[rg * l + k] is tap (lo - first) + k of row group rg, lo = max(first, s0).
__device__ __forceinline__ void vertical(const uint8_t* src, int qc, const float4* taps,
                                         int l, const int* first, int span, int valid,
                                         int s0, int sn, int nquad, bool fresh,
                                         float* t, int tp) {
    for (int it = threadIdx.x; it < GROUPS_H * nquad; it += THREADS) {
        const int rg = it / nquad, qd = it - rg * nquad;
        float* tcell = t + rg * G * tp + qd * 4;
        float a[G][4];
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = fresh ? 0.0f : tcell[i * tp + j];
        const int fg = first[rg];
        const int lo = max(fg, s0);
        const int hi = rg < valid ? min(fg + span, s0 + sn) : lo;
        const float4* tap = taps + rg * l;
        const uint8_t* sp = src + (lo - s0) * qc + qd * 4;
#pragma unroll 2
        for (int k = 0; k < hi - lo; ++k) {
            const uint32_t word = *reinterpret_cast<const uint32_t*>(sp + k * qc);
            const float4 t4 = tap[k];
            const float tr[G] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float v = byte_to_float(word, 0x7440u + j);
#pragma unroll
                for (int i = 0; i < G; ++i) a[i][j] = fmaf(tr[i], v, a[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) tcell[i * tp + j] = a[i][j];
    }
}

// Horizontal pass over one T chunk of columns [q0, q0 + qn): out[r][4g+j]
// += taps x T, in ascending column; taps as in vertical().
__device__ __forceinline__ void horizontal(const float* t, int tp, const float4* taps,
                                           int l, const int* first, int span, int valid,
                                           int q0, int qn, float (&acc)[PAIRS][HR][G]) {
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
        const int p = threadIdx.x + k * THREADS;
        const int rb = p % ROW_BLOCKS, jg = p / ROW_BLOCKS;
        if (jg >= GROUPS_W) continue;
        const int fg = first[jg];
        const int lo = max(fg, q0);
        const int hi = jg < valid ? min(fg + span, q0 + qn) : lo;
        const float* tv = t + rb * HR * tp + (lo - q0);
        const float4* tap = taps + jg * l;
#pragma unroll 2
        for (int q = 0; q < hi - lo; ++q) {
            const float4 t4 = tap[q];
#pragma unroll
            for (int i = 0; i < HR; ++i) {
                const float v = tv[i * tp + q];
                acc[k][i][0] = fmaf(t4.x, v, acc[k][i][0]);
                acc[k][i][1] = fmaf(t4.y, v, acc[k][i][1]);
                acc[k][i][2] = fmaf(t4.z, v, acc[k][i][2]);
                acc[k][i][3] = fmaf(t4.w, v, acc[k][i][3]);
            }
        }
    }
}

// Quantise the tile into `tile`, then store its rows coalesced; zeroes acc.
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ out, int h, int w,
                                           int f, int ty, int tx, uint8_t* tile,
                                           bool vec_out, float (&acc)[PAIRS][HR][G]) {
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
        const int p = threadIdx.x + k * THREADS;
        const int rb = p % ROW_BLOCKS, jg = p / ROW_BLOCKS;
        if (jg >= GROUPS_W) continue;
#pragma unroll
        for (int i = 0; i < HR; ++i) {
            *reinterpret_cast<uint32_t*>(tile + (rb * HR + i) * OUT_PITCH + jg * 4) =
                quantise(acc[k][i][0]) | quantise(acc[k][i][1]) << 8
                | quantise(acc[k][i][2]) << 16 | quantise(acc[k][i][3]) << 24;
#pragma unroll
            for (int j = 0; j < G; ++j) acc[k][i][j] = 0.0f;
        }
    }
    __syncthreads();
    const int r0 = ty * TILE_H, c0 = tx * TILE_W;
    const int rows = min(TILE_H, h - r0), cols = min(TILE_W, w - c0);
    uint8_t* of = out + static_cast<long long>(f) * h * w + static_cast<long long>(r0) * w + c0;
    if (vec_out && cols == TILE_W) {
        for (int i = threadIdx.x; i < rows * (TILE_W / 4); i += THREADS) {
            const int r = i / (TILE_W / 4), v = i - r * (TILE_W / 4);
            *reinterpret_cast<uint32_t*>(of + static_cast<long long>(r) * w + v * 4) =
                *reinterpret_cast<const uint32_t*>(tile + r * OUT_PITCH + v * 4);
        }
    } else {
        for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
            const int r = i / cols, c = i - r * cols;
            of[static_cast<long long>(r) * w + c] = tile[r * OUT_PITCH + c];
        }
    }
}

// One shared-memory slot of the streaming kernel: a tile's source window,
// its row and column groups' taps and first indices.
struct Slot {
    uint8_t* src;         // rc x qc
    float4* taps_h;       // GROUPS_H x span_h
    float4* taps_w;       // GROUPS_W x span_w
    int* first_h;         // GROUPS_H
    int* first_w;         // GROUPS_W
};

__device__ __forceinline__ Slot slot_at(unsigned char* base, int rc, int qc,
                                        int span_h, int span_w) {
    Slot s;
    s.taps_h = reinterpret_cast<float4*>(base);
    s.taps_w = s.taps_h + GROUPS_H * span_h;
    s.first_h = reinterpret_cast<int*>(s.taps_w + GROUPS_W * span_w);
    s.first_w = s.first_h + GROUPS_H;
    s.src = reinterpret_cast<uint8_t*>(s.first_w + GROUPS_W);
    return s;
}

__host__ __device__ int slot_bytes(int rc, int qc, int span_h, int span_w) {
    return (GROUPS_H * span_h + GROUPS_W * span_w) * 16 + (GROUPS_H + GROUPS_W) * 4 + rc * qc;
}

// Work item `item` = (frame, tile row, tile column), tile column fastest.
struct Item {
    int f, ty, tx, rlo, rhi, clo, chi;
};

__device__ __forceinline__ Item item_at(int item, int ntx, int tiles, const Band& bh,
                                        const Band& bw) {
    Item it;
    it.f = item / tiles;
    const int k = item - it.f * tiles;
    it.ty = k / ntx;
    it.tx = k - it.ty * ntx;
    it.rlo = __ldg(bh.win + 2 * it.ty);
    it.rhi = __ldg(bh.win + 2 * it.ty + 1);
    it.clo = __ldg(bw.win + 2 * it.tx);
    it.chi = __ldg(bw.win + 2 * it.tx + 1);
    return it;
}

// Start copying everything item `it` needs into slot s.
__device__ __forceinline__ void stage_item(const uint8_t* __restrict__ x, int H, int W,
                                           const Band& bh, const Band& bw, const Item& it,
                                           const Slot& s, int qc, bool vec) {
    const float4* th = bh.taps + static_cast<long long>(it.ty) * GROUPS_H * bh.span;
    for (int i = threadIdx.x; i < GROUPS_H * bh.span; i += THREADS) cp_async16(s.taps_h + i, th + i);
    const float4* tw = bw.taps + static_cast<long long>(it.tx) * GROUPS_W * bw.span;
    for (int i = threadIdx.x; i < GROUPS_W * bw.span; i += THREADS) cp_async16(s.taps_w + i, tw + i);
    if (threadIdx.x < GROUPS_H / 4)
        cp_async16(s.first_h + 4 * threadIdx.x, bh.first + it.ty * GROUPS_H + 4 * threadIdx.x);
    else if (threadIdx.x < GROUPS_H / 4 + GROUPS_W / 4) {
        const int k = threadIdx.x - GROUPS_H / 4;
        cp_async16(s.first_w + 4 * k, bw.first + it.tx * GROUPS_W + 4 * k);
    }
    const int qn = it.chi - it.clo;
    stage_src(x + static_cast<long long>(it.f) * H * W, W, it.rlo, it.rhi - it.rlo, it.clo,
              qn, (qn + 3) / 4 * 4, s.src, qc, vec);
}

// The streaming kernel, for bands whose every tile window fits one chunk.
// A persistent block walks the items blockIdx.x, + gridDim.x, ... (the
// blocks in flight work on neighbouring tiles and share halos through
// L2) and copies the next item's window, taps and first indices into the
// other slot while it computes this one.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
streaming_resize_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                        int n, int H, int W, int h, int w, Band bh, Band bw,
                        int rc, int qc, int vec_in, int vec_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int sb = slot_bytes(rc, qc, bh.span, bw.span);
    const int tp = qc + 1;                                  // odd pitch: conflict-free rows
    float* t = reinterpret_cast<float*>(smem + 2 * sb);
    uint8_t* tile = reinterpret_cast<uint8_t*>(t + TILE_H * tp);
    const int ntx = (w + TILE_W - 1) / TILE_W;
    const int tiles = ntx * ((h + TILE_H - 1) / TILE_H), total = n * tiles;
    const bool vec = vec_in != 0;

    int item = blockIdx.x;
    Item cur = item_at(item, ntx, tiles, bh, bw);
    stage_item(x, H, W, bh, bw, cur, slot_at(smem, rc, qc, bh.span, bw.span), qc, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    int nxt_item = item + gridDim.x;
    Item nxt = item_at(nxt_item < total ? nxt_item : item, ntx, tiles, bh, bw);
    float acc[PAIRS][HR][G];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k)
#pragma unroll
        for (int i = 0; i < HR; ++i)
#pragma unroll
            for (int j = 0; j < G; ++j) acc[k][i][j] = 0.0f;

    for (int b = 0; item < total; b ^= 1) {
        const Slot s = slot_at(smem + b * sb, rc, qc, bh.span, bw.span);
        if (nxt_item < total)
            stage_item(x, H, W, bh, bw, nxt, slot_at(smem + (b ^ 1) * sb, rc, qc, bh.span, bw.span),
                       qc, vec);
        asm volatile("cp.async.commit_group;\n" ::);
        // the descriptor after next: loads that land during this item
        const int after = nxt_item + gridDim.x;
        const Item later = item_at(after < total ? after : item, ntx, tiles, bh, bw);
        asm volatile("cp.async.wait_group 1;\n" ::);
        __syncthreads();                    // this item's copies have landed
        const int qn = cur.chi - cur.clo;
        vertical(s.src, qc, s.taps_h, bh.span, s.first_h, bh.span, bh.groups - cur.ty * GROUPS_H,
                 cur.rlo, cur.rhi - cur.rlo, (qn + 3) / 4, true, t, tp);
        __syncthreads();                    // T is complete
        horizontal(t, tp, s.taps_w, bw.span, s.first_w, bw.span, bw.groups - cur.tx * GROUPS_W,
                   cur.clo, qn, acc);
        store_tile(out, h, w, cur.f, cur.ty, cur.tx, tile, vec_out != 0, acc);
        __syncthreads();                    // the slot, T and the tile are free again
        item = nxt_item;
        cur = nxt;
        nxt_item = after;
        nxt = later;
    }
}

// The chunked kernel, for any band: one block per tile and frame walks the
// tile's window in chunks of rc source rows x qc columns; the partial T
// stays in shared memory across row chunks and the partial outputs in
// registers across column chunks.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
chunked_resize_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                      int n, int H, int W, int h, int w, Band bh, Band bw,
                      int rc, int qc, int vec_in, int vec_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lh = min(bh.span, rc), lw = min(bw.span, qc), tp = qc + 1;
    float4* taps_h = reinterpret_cast<float4*>(smem);
    float4* taps_w = taps_h + GROUPS_H * lh;
    float* t = reinterpret_cast<float*>(taps_w + GROUPS_W * lw);
    int* first_h = reinterpret_cast<int*>(t + TILE_H * tp);
    int* first_w = first_h + GROUPS_H;
    uint8_t* tile = reinterpret_cast<uint8_t*>(first_w + GROUPS_W);
    uint8_t* src = tile + TILE_H * OUT_PITCH;

    const int ty = blockIdx.y, tx = blockIdx.x;
    const int rlo = bh.win[2 * ty], rhi = bh.win[2 * ty + 1];
    const int clo = bw.win[2 * tx], chi = bw.win[2 * tx + 1];
    const int gh0 = ty * GROUPS_H, gw0 = tx * GROUPS_W;
    if (threadIdx.x < GROUPS_H) first_h[threadIdx.x] = bh.first[gh0 + threadIdx.x];
    else if (threadIdx.x < GROUPS_H + GROUPS_W)
        first_w[threadIdx.x - GROUPS_H] = bw.first[gw0 + threadIdx.x - GROUPS_H];
    __syncthreads();
    float acc[PAIRS][HR][G];
#pragma unroll
    for (int k = 0; k < PAIRS; ++k)
#pragma unroll
        for (int i = 0; i < HR; ++i)
#pragma unroll
            for (int j = 0; j < G; ++j) acc[k][i][j] = 0.0f;

    for (int f = blockIdx.z; f < n; f += gridDim.z) {
        const uint8_t* xf = x + static_cast<long long>(f) * H * W;
        for (int q0 = clo; q0 < chi; q0 += qc) {
            const int qn = min(qc, chi - q0);
            for (int s0 = rlo; s0 < rhi; s0 += rc) {
                const int sn = min(rc, rhi - s0);
                __syncthreads();            // earlier readers of the chunk are done
                stage_src(xf, W, s0, sn, q0, qn, (qn + 3) / 4 * 4, src, qc, vec_in != 0);
                // row taps [max(first, s0) - first, ...) of each group
                for (int i = threadIdx.x; i < GROUPS_H * lh; i += THREADS) {
                    const int rg = i / lh, k = i - rg * lh, fg = first_h[rg];
                    const int lo = max(fg, s0);
                    if (lo + k < min(fg + bh.span, s0 + sn))
                        taps_h[i] = bh.taps[static_cast<long long>(gh0 + rg) * bh.span + lo - fg + k];
                }
                asm volatile("cp.async.commit_group;\n" ::);
                asm volatile("cp.async.wait_group 0;\n" ::);
                __syncthreads();
                vertical(src, qc, taps_h, lh, first_h, bh.span, bh.groups - gh0,
                         s0, sn, (qn + 3) / 4, s0 == rlo, t, tp);
            }
            for (int i = threadIdx.x; i < GROUPS_W * lw; i += THREADS) {
                const int jg = i / lw, k = i - jg * lw, fg = first_w[jg];
                const int lo = max(fg, q0);
                if (lo + k < min(fg + bw.span, q0 + qn))
                    taps_w[i] = bw.taps[static_cast<long long>(gw0 + jg) * bw.span + lo - fg + k];
            }
            __syncthreads();                // T and the column taps are complete
            horizontal(t, tp, taps_w, lw, first_w, bw.span, bw.groups - gw0, q0, qn, acc);
        }
        store_tile(out, h, w, f, ty, tx, tile, vec_out != 0, acc);
    }
}

int chunked_bytes(int rc, int qc, int span_h, int span_w) {
    const int lh = span_h < rc ? span_h : rc, lw = span_w < qc ? span_w : qc;
    return (GROUPS_H * lh + GROUPS_W * lw) * 16 + TILE_H * (qc + 1) * 4
        + (GROUPS_H + GROUPS_W) * 4 + TILE_H * OUT_PITCH + rc * qc;
}

int round16(int v) { return (v + COL_ALIGN - 1) / COL_ALIGN * COL_ALIGN; }

// The streaming kernel takes a band only while two slots, T and the tile
// fit this much shared memory (two blocks per SM); the chunked kernel's
// largest request, with 128 x 256 chunks and the widest taps, stays below
// CHUNKED_SMEM_MAX.
constexpr int STREAMING_SMEM_MAX = 113 * 1024;
constexpr int CHUNKED_SMEM_MAX = 150 * 1024;

// Per kernel and device: whether its shared-memory limit has been raised,
// and the card's SM count and the blocks per SM at the last size asked for.
// Calls from several host threads may race here; each field is only ever
// set to the same value for the same request, and a stale occupancy only
// changes the number of persistent blocks, never the result.
struct LaunchCache {
    bool smem_raised = false;
    int occ_smem = -1;
    int per_sm = 1;
    int sms = 1;
};
constexpr int MAX_DEVICES = 64;
LaunchCache g_streaming[MAX_DEVICES], g_chunked[MAX_DEVICES];

template <typename Kernel>
cudaError_t prepare(Kernel kernel, LaunchCache* caches, int smem_max, int smem,
                    int* slots) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    LaunchCache& c = caches[dev];
    if (!c.smem_raised) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
        if (err != cudaSuccess) return err;
        c.smem_raised = true;
    }
    if (slots == nullptr) return cudaSuccess;
    if (c.occ_smem != smem) {
        int count = 0, blocks = 0;
        err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
        if (err != cudaSuccess) return err;
        c.sms = count > 0 ? count : 1;
        c.per_sm = blocks > 0 ? blocks : 1;
        c.occ_smem = smem;
    }
    *slots = c.sms * c.per_sm;
    return cudaSuccess;
}

}  // namespace

// The layout the wrapper builds the band form and tile windows for: group
// size, tile rows, tile columns, column alignment.
extern "C" void vt_fused_resize_layout(int* out) {
    out[0] = G;
    out[1] = TILE_H;
    out[2] = TILE_W;
    out[3] = COL_ALIGN;
}

// x (n, H, W) uint8; out (n, h, w) uint8; per axis the band form, padded
// to whole tiles of groups: first (tiles * groups per tile,) int32, taps
// (same, span, 4) float32, win (tiles, 2) int32 with 32-row tiles for A_h
// and 64-column tiles (lo a multiple of 16) for A_w; `groups` counts the
// groups with rows in the matrix and `widest` the widest tile window.
// All contiguous, on the current device. Launches one kernel on `stream`
// (streaming when every window fits one chunk and two slots fit
// STREAMING_SMEM_MAX, else chunked); returns
// cudaGetLastError() after it, or the error of a launch attribute call
// (0 = ok).
extern "C" int vt_fused_resize_plane(const uint8_t* x, uint8_t* out, int n,
                                     int H, int W, int h, int w,
                                     const int* first_h, const float* taps_h,
                                     const int* win_h, int span_h, int groups_h,
                                     int widest_h, const int* first_w,
                                     const float* taps_w, const int* win_w,
                                     int span_w, int groups_w, int widest_w,
                                     void* stream) {
    const Band bh{first_h, reinterpret_cast<const float4*>(taps_h), win_h, span_h, groups_h};
    const Band bw{first_w, reinterpret_cast<const float4*>(taps_w), win_w, span_w, groups_w};
    const int vec_in = (W % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_out = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 4 == 0);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int ntx = (w + TILE_W - 1) / TILE_W, nty = (h + TILE_H - 1) / TILE_H;
    const int rc_s = widest_h, qc_s = round16(widest_w);
    const int smem_s = 2 * slot_bytes(rc_s, qc_s, span_h, span_w) + TILE_H * (qc_s + 1) * 4
        + TILE_H * OUT_PITCH;
    cudaError_t err;
    if (rc_s <= MAX_ROWS && qc_s <= MAX_COLS && smem_s <= STREAMING_SMEM_MAX) {
        int slots = 1;
        err = prepare(streaming_resize_kernel, g_streaming, STREAMING_SMEM_MAX, smem_s, &slots);
        if (err != cudaSuccess) return static_cast<int>(err);
        const long long items = static_cast<long long>(n) * ntx * nty;
        streaming_resize_kernel<<<static_cast<int>(items < slots ? items : slots), THREADS, smem_s, st>>>(
            x, out, n, H, W, h, w, bh, bw, rc_s, qc_s, vec_in, vec_out);
    } else {
        const int rc = widest_h < MAX_ROWS ? widest_h : MAX_ROWS;
        const int qc = round16(widest_w) < MAX_COLS ? round16(widest_w) : MAX_COLS;
        err = prepare(chunked_resize_kernel, g_chunked, CHUNKED_SMEM_MAX, 0, nullptr);
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid(ntx, nty, n < 65535 ? n : 65535);
        chunked_resize_kernel<<<grid, THREADS, chunked_bytes(rc, qc, span_h, span_w), st>>>(
            x, out, n, H, W, h, w, bh, bw, rc, qc, vec_in, vec_out);
    }
    return static_cast<int>(cudaGetLastError());
}
