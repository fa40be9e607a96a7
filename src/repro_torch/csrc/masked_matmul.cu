// Sparsity-aware fixed-point matmul with a stochastic-rounding epilogue.
//
// Replaces the Pallas TPU kernel `masked_matmul_pallas` / `_mm_kernel`
// (repro/kernels/masked_matmul/mm_kernel.py), in both of its uses: the
// forward `x @ w` and, with SR off, the backward GEMMs `g @ w^T` and
// `x^T @ g` (`_kernel_dot`, repro/kernels/masked_matmul/backward.py:85-128).
// Computes
//   out = a @ b            (a: (M, K) fp32, b: (K, N) fp32)
// where each operand is row-major or column-major with a leading dimension
// of its own, so a transposed operand (w^T, x^T) is read in place.  A K-step
// of an output tile is issued only when the joint occupancy
// a_occ[i, k] & b_occ[k, j] of its two operand tiles is set.  Skipping a
// tile whose joint occupancy is empty adds exactly +0.0, so the result equals
// the dense product of the same operands; the tile size is therefore this
// kernel's own choice (64 x 64 output, 32 deep) and need not match the
// reference's 128.  With apply_sr the epilogue clips, floors and rounds up
// with probability frac, drawing u from the murmur3 finalizer of
// counter = row * n_pad + col, n_pad being N rounded up to the REFERENCE's
// 128 (mm_kernel.py:85,115), so the random stream is the JAX one bit for bit.
//
// Split-K with a fixed split.  K is cut into chunks of `chunk_tiles` K-tiles
// that depend only on K (the wrapper's choice), never on M or N.  Grid:
// x = row tiles (no 65,535 cap), y = column tiles, z = K chunks.  With one
// chunk a block applies the epilogue itself; with more, each (tile, chunk)
// block writes its partial sum to a workspace and `splitk_reduce_kernel`
// adds the chunks in chunk order, then applies the epilogue.  So results are
// deterministic, and a row's sums never depend on M: batch invariant.
//
// What bounds it on the H100: at decode (M = 4) it reads each weight once
// and does 2*M FLOPs per weight element: bound by the 3.35 TB/s of device
// memory.  The training GEMMs (im2col patches of 0.4-3.7 GB against
// 64-512 wide weights or cotangents) do 2*K FLOPs per output over K in the
// hundreds to millions: bound by the 67 TFLOP/s of fp32 FMAs.  The design
// answers both only in the simplest way: coalesced loads in either layout,
// nothing loaded for skipped tiles, the next occupied tile's loads in
// flight (in registers) while the current one is multiplied, split-K so a
// tiny output over a huge K still fills the 132 SMs.  No tensor cores: TF32
// keeps 11 bits of a Q4.16 value's 21 (see ROADMAP), so the product runs as
// fp32 FMAs.  Known waste left for later work: at M = 4 a 64-row tile
// computes 60 rows of zeros; a 4 x 4 register tile per thread; no cp.async
// or TMA pipeline.
//
// tile_occupancy computes the per-tile any-nonzero flags that the Pallas
// wrapper builds with jnp outside its kernel (masked_matmul/ops.py:25-28),
// one block per tile, one read of the operand.  The flags of a transposed
// operand are the transposed flags of the untransposed one.
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
constexpr int WS_PAD = 4;     // b tile row padding: keeps float4 reads aligned

__device__ __forceinline__ uint32_t hash_uint32(uint32_t counter, uint32_t seed) {
    uint32_t z = counter + seed * 0x9E3779B9u;
    z = (z ^ (z >> 16)) * 0x7FEB352Du;
    z = (z ^ (z >> 15)) * 0x846CA68Bu;
    return z ^ (z >> 16);
}

struct Epilogue {
    int n_pad;
    uint32_t seed;
    int apply_sr;
    float scale, eps, min_v, max_v;

    __device__ __forceinline__ float operator()(float v, int row, int col) const {
        if (!apply_sr) return v;
        const float xc = fminf(fmaxf(v, min_v), max_v);
        const float scaled = xc * scale;
        const float lo = floorf(scaled);
        const float frac = scaled - lo;
        const uint32_t counter = (uint32_t)row * (uint32_t)n_pad + (uint32_t)col;
        const float u = (float)(hash_uint32(counter, seed) >> 8) * (1.0f / 16777216.0f);
        const float rounded = lo + (u < frac ? 1.0f : 0.0f);
        return fminf(fmaxf(rounded * eps, min_v), max_v);
    }
};

// A_COL: a is column-major, a[i][k] at a[k * lda + i] (else a[i * lda + k]).
// B_COL: b is column-major, b[k][j] at b[j * ldb + k] (else b[k * ldb + j]).
template <bool A_COL, bool B_COL>
__global__ void __launch_bounds__(THREADS)
masked_mm_kernel(const float* __restrict__ a, int64_t lda,
                 const float* __restrict__ b, int64_t ldb,
                 const int* __restrict__ a_occ, int64_t ao_i, int64_t ao_k,
                 const int* __restrict__ b_occ, int64_t bo_k, int64_t bo_j,
                 float* __restrict__ out, float* __restrict__ partial,
                 int M, int N, int K, int chunk_tiles, Epilogue ep) {
    // a tile stored k-major, padded by one column so the transposing store
    // of a row-major a is free of bank conflicts
    __shared__ float as[BK][BM + 1];
    __shared__ __align__(16) float bs[BK][BN + WS_PAD];

    const int bi = blockIdx.x, bj = blockIdx.y, chunk = blockIdx.z;
    const int k_tiles = (K + BK - 1) / BK;
    const int kt0 = chunk * chunk_tiles;
    const int kt1 = min(k_tiles, kt0 + chunk_tiles);
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    // Register double buffering: the next occupied tile's loads are issued
    // before the current tile's FMAs, so device-memory latency overlaps
    // compute.  Each output still sums its K-tiles in increasing order.
    constexpr int A_PER = BM * BK / THREADS, B_PER = BK * BN / THREADS;
    float ra[A_PER], rb[B_PER];
    // block-uniform: every thread reads the same flags, so the loop and its
    // __syncthreads are taken by all threads together
    auto occupied = [&](int kt) {
        return (a_occ[bi * ao_i + kt * ao_k] & b_occ[kt * bo_k + bj * bo_j]) != 0;
    };
    auto load = [&](int kt) {
#pragma unroll
        for (int it = 0; it < A_PER; ++it) {
            const int e = tid + it * THREADS;
            // neighbouring threads walk the operand's contiguous axis
            const int r = A_COL ? e % BM : e / BK, c = A_COL ? e / BM : e % BK;
            const int gr = bi * BM + r, gc = kt * BK + c;
            ra[it] = (gr < M && gc < K)
                ? (A_COL ? a[(int64_t)gc * lda + gr] : a[(int64_t)gr * lda + gc]) : 0.0f;
        }
#pragma unroll
        for (int it = 0; it < B_PER; ++it) {
            const int e = tid + it * THREADS;
            const int r = B_COL ? e % BK : e / BN, c = B_COL ? e / BK : e % BN;
            const int gr = kt * BK + r, gc = bj * BN + c;
            rb[it] = (gr < K && gc < N)
                ? (B_COL ? b[(int64_t)gc * ldb + gr] : b[(int64_t)gr * ldb + gc]) : 0.0f;
        }
    };

    int kt = kt0;
    while (kt < kt1 && !occupied(kt)) ++kt;
    if (kt < kt1) load(kt);
    while (kt < kt1) {
#pragma unroll
        for (int it = 0; it < A_PER; ++it) {
            const int e = tid + it * THREADS;
            const int r = A_COL ? e % BM : e / BK, c = A_COL ? e / BM : e % BK;
            as[c][r] = ra[it];
        }
#pragma unroll
        for (int it = 0; it < B_PER; ++it) {
            const int e = tid + it * THREADS;
            const int r = B_COL ? e % BK : e / BN, c = B_COL ? e / BK : e % BN;
            bs[r][c] = rb[it];
        }
        __syncthreads();
        int next = kt + 1;
        while (next < kt1 && !occupied(next)) ++next;
        if (next < kt1) load(next);
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
            const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
                acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
                acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
                acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
            }
        }
        __syncthreads();
        kt = next;
    }

    float* dst = partial == nullptr ? out : partial + (int64_t)chunk * M * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = bi * BM + ty * 4 + i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = bj * BN + tx * 4 + j;
            if (col >= N) continue;
            const float v = acc[i][j];
            dst[(int64_t)row * N + col] = partial == nullptr ? ep(v, row, col) : v;
        }
    }
}

// out[i] = epilogue(sum over chunks c = 0, 1, ... of partial[c][i]), in
// chunk order
__global__ void splitk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                     int M, int N, int n_chunks, Epilogue ep) {
    const int64_t total = (int64_t)M * N;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
         i += (int64_t)gridDim.x * blockDim.x) {
        float s = partial[i];
        for (int c = 1; c < n_chunks; ++c) s += partial[(int64_t)c * total + i];
        out[i] = ep(s, (int)(i / N), (int)(i % N));
    }
}

// occ[ti * n_tile_cols + tj] = any(a[tile (ti, tj)] != 0), one block per
// tile; row tiles on grid x (no 65,535 cap), column tiles on grid y
__global__ void tile_occupancy_kernel(const float* __restrict__ a, int rows, int cols,
                                      int tile_rows, int tile_cols, int* __restrict__ occ) {
    const int ti = blockIdx.x, tj = blockIdx.y;
    int any = 0;
    for (int e = threadIdx.x; e < tile_rows * tile_cols; e += blockDim.x) {
        const int r = ti * tile_rows + e / tile_cols, c = tj * tile_cols + e % tile_cols;
        if (r < rows && c < cols && a[(int64_t)r * cols + c] != 0.0f) any = 1;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) occ[(int64_t)ti * gridDim.y + tj] = any;
}

template <bool A_COL, bool B_COL>
void launch_mm(dim3 grid, cudaStream_t s, const float* a, int64_t lda, const float* b,
               int64_t ldb, const int* a_occ, int64_t ao_i, int64_t ao_k, const int* b_occ,
               int64_t bo_k, int64_t bo_j, float* out, float* partial, int m, int n, int k,
               int chunk_tiles, Epilogue ep) {
    masked_mm_kernel<A_COL, B_COL><<<grid, THREADS, 0, s>>>(
        a, lda, b, ldb, a_occ, ao_i, ao_k, b_occ, bo_k, bo_j, out, partial, m, n, k,
        chunk_tiles, ep);
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
    dim3 grid((rows + tile_rows - 1) / tile_rows, (cols + tile_cols - 1) / tile_cols);
    tile_occupancy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, rows, cols, tile_rows, tile_cols, occ);
    return static_cast<int>(cudaGetLastError());
}

// a_col / b_col: operand layout (see masked_mm_kernel); a_occ is indexed
// [i * ao_i + k * ao_k], b_occ [k * bo_k + j * bo_j].  n_chunks > 1 needs
// `partial` of n_chunks * m * n floats and launches the reduce as well.
int masked_matmul_launch(const float* a, long long lda, int a_col, const float* b,
                         long long ldb, int b_col, const int* a_occ, long long ao_i,
                         long long ao_k, const int* b_occ, long long bo_k, long long bo_j,
                         float* out, float* partial, int m, int n, int k, int chunk_tiles,
                         int n_chunks, int n_pad, unsigned int seed, int apply_sr,
                         float scale, float eps, float min_v, float max_v, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Epilogue ep{n_pad, seed, apply_sr, scale, eps, min_v, max_v};
    float* part = n_chunks > 1 ? partial : nullptr;
    dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, n_chunks);
    if (a_col && b_col)
        launch_mm<true, true>(grid, s, a, lda, b, ldb, a_occ, ao_i, ao_k, b_occ, bo_k, bo_j,
                              out, part, m, n, k, chunk_tiles, ep);
    else if (a_col)
        launch_mm<true, false>(grid, s, a, lda, b, ldb, a_occ, ao_i, ao_k, b_occ, bo_k, bo_j,
                               out, part, m, n, k, chunk_tiles, ep);
    else if (b_col)
        launch_mm<false, true>(grid, s, a, lda, b, ldb, a_occ, ao_i, ao_k, b_occ, bo_k, bo_j,
                               out, part, m, n, k, chunk_tiles, ep);
    else
        launch_mm<false, false>(grid, s, a, lda, b, ldb, a_occ, ao_i, ao_k, b_occ, bo_k, bo_j,
                                out, part, m, n, k, chunk_tiles, ep);
    return static_cast<int>(cudaGetLastError());
}

int splitk_reduce_launch(const float* partial, float* out, int m, int n, int n_chunks,
                         int n_pad, unsigned int seed, int apply_sr, float scale, float eps,
                         float min_v, float max_v, void* stream) {
    const Epilogue ep{n_pad, seed, apply_sr, scale, eps, min_v, max_v};
    const int64_t total = (int64_t)m * n;
    const int blocks = (int)((total + THREADS - 1) / THREADS < 132 * 32
                             ? (total + THREADS - 1) / THREADS : 132 * 32);
    splitk_reduce_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        partial, out, m, n, n_chunks, ep);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
