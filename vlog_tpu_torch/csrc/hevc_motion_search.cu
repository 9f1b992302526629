// HEVC motion search for Hopper (sm_90a): for every n x n block of every
// chain, the integer full search and the half- and quarter-pel refinement
// through the spec's luma interpolation, in one launch.
//
// Replaces no Pallas kernel. The JAX package's search
// (vlog_tpu/codecs/hevc/jax_core.py: _integer_search, _subpel_refine) is
// plain jnp that XLA fuses; the port's plain PyTorch version of it
// (codecs/hevc/core.py, same names) launched about 1,800 kernels a P frame
// and rung, and kept int64 SAD volumes of B x H x 17 x W a row of offsets
// in device memory. This kernel is new, written for this card; the plain
// functions stay as the CPU path and the version the tests hold it to.
//
// What it computes, bit for bit as the plain version:
//   1. Integer: per offset (dy, dx) within `search`, cost = SAD(cur, ref
//      shifted) + lam*4*(|dy|+|dx|) in int32; the first minimum in the
//      order (0, 0) first, then raster over (dy, dx), wins.
//   2. Half-pel: the 8 neighbours (dy, dx) in {-1, 0, 1}^2 \ (0, 0), in
//      raster order, at 2 quarter pels around the integer MV; each
//      candidate's prediction is the spec's vertical 8-tap over the
//      horizontally filtered planes (`hplanes`, fraction fx's plane),
//      ((acc >> 6) + 32) >> 6 clamped to 0..255; cost = SAD +
//      lam*(|mvy|+|mvx|) in quarter pels. A candidate replaces the best
//      only when its cost is strictly lower: the first candidate at the
//      stage's minimum, if it beats the base.
//   3. Quarter-pel: the same at 1 quarter pel around the half-pel best.
//
// Bound. At the 1080p rung of a 144-frame dispatch (6 chains, 1088x1920,
// n = 32, search 8) the function must read cur, the padded reference and
// the four fraction planes (int32, as the caller holds them) once:
// about 4 B x (1 + 1 + 4) x 6 x 1088 x 1920 = 301 MB, 0.090 ms at
// 3.35 TB/s. Its operations are the integer SADs, 6 x 2040 blocks x 289
// offsets x 1024 pixels = 3.6 G byte differences packed four to a 32-bit
// lane operation (0.91 G), and the refinement's 16 candidates x 8 taps a
// pixel, 6 x 2040 x 1024 x 128 = 1.60 G: 2.51 G int32 operations, 0.150 ms
// at 16.7 T a second (132 SMs x 64 int32 lanes x 1.98 GHz). So it is
// bound by its operations, the refinement's taps the larger part.
//
// Design: one thread block of 256 threads per (chain, block).
//   * The block stages the current n x n block and the (n + 2 search)^2
//     reference window in shared memory as bytes (the caller's int32
//     planes hold uint8 samples), read once from device memory.
//   * Integer search: a work item is one offset over 4 rows of the block;
//     a thread walks each row a word (4 pixels) at a time: the current
//     block's word (a broadcast load), the reference's unaligned word from
//     two aligned ones (__funnelshift_r, one new load a word), and
//     __vsadu4 for the four differences. Each item adds its partial SAD to
//     the offset's shared-memory sum. Then each thread scans its offsets'
//     costs as 64-bit keys (cost << 32 | order index) and the block
//     reduces the keys with warp shuffles: the least key is the first
//     minimum in the reference's order.
//   * Refinement: the block stages, over the integer stage's memory, the
//     window of the four fraction planes that every candidate of both
//     stages reads (n + 8 rows from 4 above the MV's row minus one, n + 1
//     columns from the MV's column minus one), then each warp evaluates
//     one of the 8 candidates of a stage (a lane a column, 8 taps a pixel
//     from shared memory, the taps from constant memory), a warp sum gives
//     its SAD, and every thread picks the same winner in the reference's
//     order with strict improvement.
//   * `n` (16 or 32) is a template parameter; `search` (1..32), `lam`
//     and the pads are arguments. Shared memory is at most 27.5 KB (n =
//     32, search 32).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NEIGH = 8;                // refinement candidates a stage: one a warp
constexpr int ROWS_PER_ITEM = 4;        // block rows of one integer work item
constexpr int MAX_SEARCH = 32;
constexpr int MAX_LAM = 1 << 16;        // keeps every cost a nonnegative int32
constexpr int FRACS = 4;                // luma quarter-pel fractions
static_assert(WARPS == NEIGH, "one warp per refinement candidate");

__constant__ int kLTaps[FRACS][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1},
};
// (dy, dx) of the 8 neighbours, in the reference's order
__constant__ int kNeigh[NEIGH][2] = {
    {-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1},
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory, in bytes: the current block at 0; the reference window
// (rows of `ref_pitch` bytes, a spare word at each row's end) and the
// per-offset SADs for the integer stage; the refinement's window of the
// four fraction planes over the same bytes once the integer stage is done.
struct Layout {
    int ref_pitch, ref_off, sad_off, hw_off, total;
};

__host__ __device__ inline Layout layout(int n, int s) {
    Layout L;
    const int win = n + 2 * s, span = 2 * s + 1;
    L.ref_pitch = ((win + 3) / 4 + 1) * 4;
    L.ref_off = align16(n * n);
    L.sad_off = L.ref_off + align16(win * L.ref_pitch);
    L.hw_off = L.ref_off;
    const int int_end = L.sad_off + span * span * 4;
    const int hw_end = L.hw_off + FRACS * (n + 8) * (n + 1) * 4;
    L.total = align16(int_end > hw_end ? int_end : hw_end);
    return L;
}

__device__ inline unsigned long long block_min(unsigned long long v,
                                               unsigned long long* red) {
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
        v = u < v ? u : v;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < WARPS; ++w) v = red[w] < v ? red[w] : v;
    return v;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
hevc_motion_search_kernel(const int32_t* __restrict__ cur,
                          const int32_t* __restrict__ refp,
                          const int32_t* __restrict__ hplanes,
                          int32_t* __restrict__ mv_out,
                          int32_t* __restrict__ cost_out, int H, int W,
                          int pad, int s, int lam) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned long long red[WARPS];
    __shared__ int cand_cost[NEIGH];
    static_assert(N == 16 || N == 32, "block sizes 16 and 32");
    constexpr int WORDS = N / 4;
    constexpr int GROUPS = N / ROWS_PER_ITEM;
    constexpr int HR = N + 8, HC = N + 1;     // fraction-plane window

    const Layout L = layout(N, s);
    const int R = H / N, C = W / N;
    const long long blk = blockIdx.x;
    const int c = static_cast<int>(blk % C);
    const int r = static_cast<int>((blk / C) % R);
    const long long b = blk / (static_cast<long long>(C) * R);
    const int Hp = H + 2 * pad, Wp = W + 2 * pad;
    const int tid = threadIdx.x;
    const int span = 2 * s + 1, win = N + 2 * s, offsets = span * span;

    unsigned char* cur_s = smem;
    unsigned char* ref_s = smem + L.ref_off;
    int* sad_s = reinterpret_cast<int*>(smem + L.sad_off);

    // the current block and the reference window, as bytes
    const int32_t* cur_b = cur + (b * H + r * N) * W + c * N;
    for (int i = tid; i < N * N; i += THREADS)
        cur_s[i] = static_cast<unsigned char>(cur_b[(i / N) * W + i % N]);
    const int32_t* ref_b = refp + (b * Hp + pad + r * N - s) * Wp + pad + c * N - s;
    for (int i = tid; i < win * L.ref_pitch; i += THREADS) {
        const int y = i / L.ref_pitch, x = i % L.ref_pitch;
        ref_s[i] = x < win ? static_cast<unsigned char>(ref_b[static_cast<long long>(y) * Wp + x])
                           : 0;
    }
    for (int k = tid; k < offsets; k += THREADS) sad_s[k] = 0;
    __syncthreads();

    // 1. integer SADs: an item is one offset over ROWS_PER_ITEM rows
    const uint32_t* cur_w = reinterpret_cast<const uint32_t*>(cur_s);
    const uint32_t* ref_w = reinterpret_cast<const uint32_t*>(ref_s);
    const int pitch_w = L.ref_pitch / 4;
    for (int item = tid; item < offsets * GROUPS; item += THREADS) {
        const int k = item % offsets, g = item / offsets;
        const int dyi = k / span, dxi = k % span;
        const unsigned shift = (dxi & 3) * 8;
        unsigned acc = 0;
#pragma unroll
        for (int ii = 0; ii < ROWS_PER_ITEM; ++ii) {
            const int i = g * ROWS_PER_ITEM + ii;
            const uint32_t* rrow = ref_w + (i + dyi) * pitch_w + (dxi >> 2);
            const uint32_t* crow = cur_w + i * WORDS;
            uint32_t lo = rrow[0];
#pragma unroll
            for (int w = 0; w < WORDS; ++w) {
                const uint32_t hi = rrow[w + 1];
                acc += __vsadu4(crow[w], __funnelshift_r(lo, hi, shift));
                lo = hi;
            }
        }
        atomicAdd(&sad_s[k], static_cast<int>(acc));
    }
    __syncthreads();

    // the first minimum of cost in the order (0, 0), then raster
    const int center = s * span + s;
    unsigned long long key = ~0ull;
    for (int k = tid; k < offsets; k += THREADS) {
        const int dy = k / span - s, dx = k % span - s;
        const int cost = sad_s[k] + lam * 4 * (abs(dy) + abs(dx));
        const unsigned ord = k == center ? 0u : static_cast<unsigned>(k < center ? k + 1 : k);
        const unsigned long long kk =
            (static_cast<unsigned long long>(static_cast<unsigned>(cost)) << 32) | ord;
        key = kk < key ? kk : key;
    }
    key = block_min(key, red);
    const unsigned ord = static_cast<unsigned>(key & 0xffffffffu);
    const int kbest = ord == 0 ? center : (ord <= static_cast<unsigned>(center) ? ord - 1 : ord);
    const int my = kbest / span - s, mx = kbest % span - s;
    int best_c = static_cast<int>(key >> 32);
    __syncthreads();                    // the integer stage's memory is free

    // the fraction planes' window every candidate of both stages reads:
    // rows from (my - 1) - 3, columns from mx - 1, relative to the block
    int* hw = reinterpret_cast<int*>(smem + L.hw_off);
    const long long plane = static_cast<long long>(Hp) * Wp;
    const int32_t* hb = hplanes + b * FRACS * plane
        + static_cast<long long>(pad + r * N + my - 4) * Wp + pad + c * N + mx - 1;
    for (int i = tid; i < FRACS * HR * HC; i += THREADS) {
        const int f = i / (HR * HC), rem = i % (HR * HC);
        hw[i] = hb[f * plane + static_cast<long long>(rem / HC) * Wp + rem % HC];
    }
    __syncthreads();

    // 2., 3. half- then quarter-pel: a warp a candidate
    const int warp = tid >> 5, lane = tid & 31;
    constexpr int RSTEP = 32 / N;       // rows a warp covers at once
    const int j = lane % N, i0 = lane / N;
    int best_y = 4 * my, best_x = 4 * mx;
    for (int step = 2; step >= 1; --step) {
        const int cy = best_y + kNeigh[warp][0] * step;
        const int cx = best_x + kNeigh[warp][1] * step;
        const int fy = cy & 3, fx = cx & 3;
        const int ly = (cy >> 2) - (my - 1), lx = (cx >> 2) - (mx - 1);   // 0 or 1
        const int* pl = hw + fx * HR * HC + ly * HC + lx + j;
        unsigned sad = 0;
        for (int i = i0; i < N; i += RSTEP) {
            int acc = 0;
#pragma unroll
            for (int t = 0; t < 8; ++t) acc += kLTaps[fy][t] * pl[(i + t) * HC];
            int p = ((acc >> 6) + 32) >> 6;
            p = p < 0 ? 0 : (p > 255 ? 255 : p);
            sad += abs(static_cast<int>(cur_s[i * N + j]) - p);
        }
        for (int o = 16; o > 0; o >>= 1) sad += __shfl_xor_sync(0xffffffffu, sad, o);
        if (lane == 0) cand_cost[warp] = static_cast<int>(sad) + lam * (abs(cy) + abs(cx));
        __syncthreads();
        int pick = -1;
        for (int q = 0; q < NEIGH; ++q) {
            if (cand_cost[q] < best_c) {
                best_c = cand_cost[q];
                pick = q;
            }
        }
        if (pick >= 0) {
            best_y += kNeigh[pick][0] * step;
            best_x += kNeigh[pick][1] * step;
        }
        __syncthreads();                // cand_cost is written again
    }
    if (tid == 0) {
        mv_out[2 * blk] = best_y;
        mv_out[2 * blk + 1] = best_x;
        cost_out[blk] = best_c;
    }
}

}  // namespace

// The limits the kernel takes: search 1..out[0], lam 0..out[1].
extern "C" void vt_hevc_motion_search_limits(int* out) {
    out[0] = MAX_SEARCH;
    out[1] = MAX_LAM;
}

// cur (b, h, w), refp (b, h + 2 pad, w + 2 pad) int32 holding uint8
// samples (refp edge-padded); hplanes (b, 4, h + 2 pad, w + 2 pad) int32,
// the horizontal 8-tap pass per quarter-pel fraction; all contiguous on
// the current device. mv (b, h/n, w/n, 2) int32 quarter pels (y, x) and
// cost (b, h/n, w/n) int32 are written. Launches one kernel on `stream`;
// returns cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError() after the launch (0 = ok).
extern "C" int vt_hevc_motion_search(const int32_t* cur, const int32_t* refp,
                                     const int32_t* hplanes, int32_t* mv,
                                     int32_t* cost, int b, int h, int w,
                                     int pad, int search, int lam, int n,
                                     void* stream) {
    if ((n != 16 && n != 32) || search < 1 || search > MAX_SEARCH || lam < 0
        || lam > MAX_LAM || pad < search + 4 || b < 1 || h < n || w < n
        || h % n != 0 || w % n != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = static_cast<long long>(b) * (h / n) * (w / n);
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = layout(n, search).total;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n == 32)
        hevc_motion_search_kernel<32><<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
            cur, refp, hplanes, mv, cost, h, w, pad, search, lam);
    else
        hevc_motion_search_kernel<16><<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
            cur, refp, hplanes, mv, cost, h, w, pad, search, lam);
    return static_cast<int>(cudaGetLastError());
}
