// Sparsity-aware fixed-point matmul with a stochastic-rounding epilogue.
//
// Replaces the Pallas TPU kernel `masked_matmul_pallas` / `_mm_kernel`
// (repro/kernels/masked_matmul/mm_kernel.py).  Computes
//   out = x @ w            (x: (M, K) fp32, w: (K, N) fp32, row-major)
// where a K-step of an output tile is issued only when the joint occupancy
// x_occ[i, k] & w_occ[k, j] of its two operand tiles is set.  Skipping a
// tile whose joint occupancy is empty adds exactly +0.0, so the result equals
// the dense product of the same operands; the tile size is therefore this
// kernel's own choice (64 x 64 output, 32 deep) and need not match the
// reference's 128.  With apply_sr the epilogue clips, floors and rounds up
// with probability frac, drawing u from the murmur3 finalizer of
// counter = row * n_pad + col, n_pad being N rounded up to the REFERENCE's
// 128 (mm_kernel.py:85,115), so the random stream is the JAX one bit for bit.
//
// What bounds it on the H100: the serving path calls it with M = 4 (decode)
// or M = prompt length (prefill) against K x N weights of 1-64 MB, so it
// reads each weight once and does 2*M FLOPs per weight element: far below
// the 67 TFLOP/s fp32 CUDA-core rate, it is bound by the 3.35 TB/s of
// device memory.  The design answers that only in the simplest way: w tiles
// are read with coalesced loads exactly once per output tile (one row of
// output tiles at decode, so once in all), x rows past M are never loaded,
// and skipped tiles load nothing.  No tensor cores: TF32 keeps 11 bits of a
// Q4.16 value's 21 (see ROADMAP), so the product runs as fp32 FMAs.  Known
// waste left for later work: at M = 4 a 64-row tile computes 60 rows of
// zeros, and N / 64 blocks (8 to 128) cannot fill 132 SMs or hide latency;
// split-K and a deeper load pipeline are the next steps.
//
// tile_occupancy computes the per-tile any-nonzero flags that the Pallas
// wrapper builds with jnp outside its kernel (masked_matmul/ops.py:25-28),
// one block per tile, one read of the operand.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so the Python wrapper can raise.  Nothing is allocated
// here: the wrapper passes every buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output cols per block
constexpr int BK = 32;   // K depth per step (the occupancy tile depth)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ uint32_t hash_uint32(uint32_t counter, uint32_t seed) {
    uint32_t z = counter + seed * 0x9E3779B9u;
    z = (z ^ (z >> 16)) * 0x7FEB352Du;
    z = (z ^ (z >> 15)) * 0x846CA68Bu;
    return z ^ (z >> 16);
}

__global__ void __launch_bounds__(THREADS)
masked_mm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ x_occ, const int* __restrict__ w_occ,
                 float* __restrict__ out, int M, int N, int K, int n_pad,
                 uint32_t seed, int apply_sr, float scale, float eps,
                 float min_v, float max_v) {
    // x tile stored transposed (k-major) and padded by one column so the
    // transposing store is free of bank conflicts
    __shared__ float xs[BK][BM + 1];
    __shared__ __align__(16) float ws[BK][BN];

    const int bi = blockIdx.y, bj = blockIdx.x;
    const int k_tiles = (K + BK - 1) / BK;
    const int n_tiles = gridDim.x;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int kt = 0; kt < k_tiles; ++kt) {
        // block-uniform gate: both __syncthreads below are skipped together
        if (!(x_occ[bi * k_tiles + kt] & w_occ[kt * n_tiles + bj])) continue;
#pragma unroll
        for (int it = 0; it < BM * BK / THREADS; ++it) {
            const int e = tid + it * THREADS;
            const int r = e / BK, c = e % BK;
            const int gr = bi * BM + r, gc = kt * BK + c;
            xs[c][r] = (gr < M && gc < K) ? x[(int64_t)gr * K + gc] : 0.0f;
        }
#pragma unroll
        for (int it = 0; it < BK * BN / THREADS; ++it) {
            const int e = tid + it * THREADS;
            const int r = e / BN, c = e % BN;
            const int gr = kt * BK + r, gc = bj * BN + c;
            ws[r][c] = (gr < K && gc < N) ? w[(int64_t)gr * N + gc] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
            const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
                acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
                acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
                acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = bi * BM + ty * 4 + i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = bj * BN + tx * 4 + j;
            if (col >= N) continue;
            float v = acc[i][j];
            if (apply_sr) {
                const float xc = fminf(fmaxf(v, min_v), max_v);
                const float scaled = xc * scale;
                const float lo = floorf(scaled);
                const float frac = scaled - lo;
                const uint32_t counter = (uint32_t)row * (uint32_t)n_pad + (uint32_t)col;
                const float u = (float)(hash_uint32(counter, seed) >> 8) * (1.0f / 16777216.0f);
                const float rounded = lo + (u < frac ? 1.0f : 0.0f);
                v = fminf(fmaxf(rounded * eps, min_v), max_v);
            }
            out[(int64_t)row * N + col] = v;
        }
    }
}

// occ[ti * n_tile_cols + tj] = any(a[tile (ti, tj)] != 0), one block per tile
__global__ void tile_occupancy_kernel(const float* __restrict__ a, int rows, int cols,
                                      int tile_rows, int tile_cols, int* __restrict__ occ) {
    const int ti = blockIdx.y, tj = blockIdx.x;
    int any = 0;
    for (int e = threadIdx.x; e < tile_rows * tile_cols; e += blockDim.x) {
        const int r = ti * tile_rows + e / tile_cols, c = tj * tile_cols + e % tile_cols;
        if (r < rows && c < cols && a[(int64_t)r * cols + c] != 0.0f) any = 1;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) occ[ti * gridDim.x + tj] = any;
}

}  // namespace

extern "C" {

// tile sizes the Python wrapper must size the occupancy grids with
void masked_matmul_tiles(int* bm_bn_bk) {
    bm_bn_bk[0] = BM;
    bm_bn_bk[1] = BN;
    bm_bn_bk[2] = BK;
}

int tile_occupancy_launch(const float* a, int rows, int cols, int tile_rows,
                          int tile_cols, int* occ, void* stream) {
    dim3 grid((cols + tile_cols - 1) / tile_cols, (rows + tile_rows - 1) / tile_rows);
    tile_occupancy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, rows, cols, tile_rows, tile_cols, occ);
    return static_cast<int>(cudaGetLastError());
}

int masked_matmul_launch(const float* x, const float* w, const int* x_occ,
                         const int* w_occ, float* out, int m, int n, int k,
                         int n_pad, unsigned int seed, int apply_sr, float scale,
                         float eps, float min_v, float max_v, void* stream) {
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    masked_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, w, x_occ, w_occ, out, m, n, k, n_pad, seed, apply_sr, scale, eps,
        min_v, max_v);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
