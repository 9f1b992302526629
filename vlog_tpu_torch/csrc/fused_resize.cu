// Fused ladder resize for Hopper (sm_90a): out = uint8(clip(rint((A_h . f32(x)) . A_w^T), 0, 255)).
//
// Replaces the TPU kernel vlog_tpu/ops/pallas_ladder.py::fused_resize_plane
// (body _rung_kernel): per plane, two float32 products in a fixed order --
// first T = A_h . x (rows), kept in float32, then T . A_w^T (columns) -- and
// a quantising epilogue that rounds half to even (rintf, like jnp.round and
// torch.round; NOT roundf, which rounds half away from zero), clamps to
// [0, 255] and stores uint8. The intermediate rounding of T to float32 is
// part of the function, so the order of the two products is kept.
//
// Bound. At the slice's shapes (1080p source; Y 1080x1920 -> 720x1280,
// 480x854 and 360x640; U/V 540x960 -> 360x640, 240x427, 180x320) the dense
// products cost 2*(h*H*W + h*W*w) FLOP per plane: 15.6 GFLOP per source frame
// over the three scaled rungs, about 0.37 TFLOP per 24-frame dispatch. But
// A_h and A_w are lanczos3 bands, 9-17 nonzero taps per row (0.6-1.5% dense),
// and a zero tap leaves an fmaf sum exactly as it was, so the function itself
// needs only 2*(nnz(A_h)*W + h*nnz(A_w)) FLOP per plane: about 3.9 GFLOP per
// dispatch, 0.06 ms at the H100 SXM data sheet's 67 TFLOP/s (non-tensor
// FP32). Each plane call reads its uint8 source once and writes its uint8
// rung once, about 281 MB per dispatch (every rung re-reads the source),
// 0.084 ms at 3.35 TB/s. So the function is bound by memory traffic, not by
// the FP32 cores.
//
// Design (a simple, correct first version). Each product is a tiled SIMT
// GEMM: a 64x64 output tile per 256-thread block, 16-deep K slices staged in
// shared memory, 4x4 outputs per thread accumulated with fmaf in ascending k.
// Two launches share one templated kernel; the float32 intermediate T lives
// in a device scratch buffer the Python wrapper allocates. Bounds are masked
// on every load and store, so odd widths (the 427-wide 480p chroma) and any
// size (4K included) need no special case. What it does about the bound:
// little: it multiplies the dense matrices, zeros included, so it does ~100x
// the work the function needs and runs far from its memory bound. It keeps
// the arithmetic in registers and reuses each staged value 4 times per
// thread. Tensor-core TF32 is not an option (it would change the rounded
// pixels); band-limited taps (the later work) skip the zero taps, which
// changes no pixel, and make the kernel a streaming pass over the source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;   // (BM / TM) * (BN / TN)

// C[b] (M x N) = A[b] (M x K, row stride lda) . B[b] (K x N, strides
// b_sk / b_sn). QUANT stores uint8(clip(rint(acc), 0, 255)); else float.
template <typename TB, bool QUANT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A, long long a_batch, long long lda,
            const TB* __restrict__ B, long long b_batch, long long b_sk,
            long long b_sn, void* __restrict__ C, long long c_batch,
            long long ldc, int M, int N, int K) {
    __shared__ float As[BK][BM + 4];   // As[k][m]
    __shared__ float Bs[BK][BN + 4];   // Bs[k][n]

    const int b = blockIdx.z;
    const float* Ab = A + b * a_batch;
    const TB* Bb = B + b * b_batch;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // A tile: k fastest across threads (A rows are k-contiguous).
        for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
            const int mm = i / BK, kk = i % BK;
            const int gm = m0 + mm, gk = k0 + kk;
            As[kk][mm] = (gm < M && gk < K) ? Ab[gm * lda + gk] : 0.0f;
        }
        // B tile: walk the contiguous axis fastest so loads coalesce.
        if (b_sn == 1) {
            for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
                const int kk = i / BN, nn = i % BN;
                const int gk = k0 + kk, gn = n0 + nn;
                Bs[kk][nn] = (gk < K && gn < N)
                    ? static_cast<float>(Bb[gk * b_sk + gn]) : 0.0f;
            }
        } else {
            for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
                const int nn = i / BK, kk = i % BK;
                const int gk = k0 + kk, gn = n0 + nn;
                Bs[kk][nn] = (gk < K && gn < N)
                    ? static_cast<float>(Bb[gk * b_sk + gn * b_sn]) : 0.0f;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty * TM + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gn = n0 + tx * TN + j;
            if (gn >= N) continue;
            const long long off = b * c_batch + gm * ldc + gn;
            if (QUANT) {
                const float r = fminf(fmaxf(rintf(acc[i][j]), 0.0f), 255.0f);
                static_cast<uint8_t*>(C)[off] = static_cast<uint8_t>(r);
            } else {
                static_cast<float*>(C)[off] = acc[i][j];
            }
        }
    }
}

}  // namespace

// x (n, H, W) uint8; a_h (h, H) f32; a_w (w, W) f32; scratch (n, h, W) f32;
// out (n, h, w) uint8. All contiguous, on the current device. Launches on
// ``stream`` and returns cudaGetLastError() after each launch (0 = ok).
extern "C" int vt_fused_resize_plane(const uint8_t* x, const float* a_h,
                                     const float* a_w, float* scratch,
                                     uint8_t* out, int n, int H, int W,
                                     int h, int w, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(THREADS);
    // T = A_h . x   (M = h, N = W, K = H); A_h is shared by every frame.
    const dim3 g1((W + BN - 1) / BN, (h + BM - 1) / BM, n);
    gemm_kernel<uint8_t, false><<<g1, block, 0, s>>>(
        a_h, 0, H, x, (long long)H * W, W, 1, scratch, (long long)h * W, W,
        h, W, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // out = T . A_w^T   (M = h, N = w, K = W); B[k][j] = A_w[j][k].
    const dim3 g2((w + BN - 1) / BN, (h + BM - 1) / BM, n);
    gemm_kernel<float, true><<<g2, block, 0, s>>>(
        scratch, (long long)h * W, W, a_w, 0, 1, W, out, (long long)h * w, w,
        h, w, W);
    return static_cast<int>(cudaGetLastError());
}
