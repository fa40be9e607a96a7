// Sparsity-aware fixed-point matmul with a stochastic-rounding epilogue,
// as two kernels shaped for the H100.
//
// Both replace the Pallas TPU kernel `masked_matmul_pallas` / `_mm_kernel`
// (repro/kernels/masked_matmul/mm_kernel.py:91) in both of its uses: the
// forward `x @ w` and, with SR off, the backward GEMMs `g @ w^T` and
// `x^T @ g` (`_kernel_dot`, repro/kernels/masked_matmul/backward.py:85-128).
// They compute
//   out = a @ b            (a: (M, K) fp32, b: (K, N) fp32)
// where each operand is row-major or column-major with a leading dimension
// of its own, so a transposed operand (w^T, x^T) is read in place.  A K-step
// (BK = 32 deep) is issued only when the operands' tiles are jointly
// occupied.  Skipping a step whose joint occupancy is empty adds exactly
// +0.0 (the accumulator starts at +0 and never becomes -0), so the result
// equals the dense product of the same operands.  With apply_sr the
// epilogue clips, floors and rounds up with probability frac, drawing u
// from the murmur3 finalizer of counter = row * n_pad + col, n_pad being N
// rounded up to the REFERENCE's 128 (mm_kernel.py:85,115), so the random
// stream is the JAX one bit for bit.
//
// The same bits on either kernel.  Each output is one fp32 fmaf chain over
// k in increasing order within each K chunk; chunks are `chunk_tiles`
// K-tiles long (8192 elements, a function of K alone) and
// `splitk_reduce_kernel` adds their partial sums in chunk order, then
// applies the epilogue.  Both kernels keep exactly this order, so a row's
// bits depend neither on M nor on which kernel ran it: deterministic and
// batch invariant.
//
// masked_mm_skinny_kernel, M <= SKINNY_M (decode ticks, prompts of up to
// 32 tokens, VGG-19's fc layers at batch 32).  At 2 M FLOPs per 4-byte
// weight, M = 4 does 2 FLOPs per byte against the H100's ridge of about 20
// (67 TFLOP/s over 3.35 TB/s): the product is a weight stream, bound by
// 4 K N bytes, and each output's chain of K dependent FMAs (4 cycles each)
// sets a second floor that no split of the work can lower.  Design: a
// block owns a 16-column strip of the output for all M rows, so even
// N = 2048 spreads over 128 SMs; a computing thread owns one column and
// M / (2 computing warps) rows, keeping the chain order.  Separate loading
// warps stream the strip's weight rows and x's K-tiles into a ring of
// shared-memory stages, a plain 16-byte load per thread held a few stages
// ahead in registers (cp.async, tried first, stalls its issuing warps long
// before the memory system is busy); loading and computing meet only at
// one pair of mbarriers per ring slot, so neither waits on the other's
// issue.  Skipping needs no pre-pass: while the ring's head fills, the
// block reads x's chunk once and flags its all-zero K-tiles (NaN counts as
// nonzero, as `!= 0` says); the loaders then fetch only the occupied tiles
// after the head, and a head tile whose x is empty is not multiplied.
// Weight occupancy is not computed: learning that a weight tile is empty
// costs the same bytes as multiplying it, and the bits are the same.  A
// column-major b (fc dX reads w^T in place) is staged column by column with
// 16-byte chunks permuted by column, and read back along k as float4
// without bank conflicts; lanes never reduce across each other.
//
// masked_mm_kernel, every other M (prefill, dX, dW).  2 K FLOPs per output
// over K in the hundreds to millions: bound by the 67 TFLOP/s of fp32 FMAs.
// Design: 128 x 128 block tiles with 8 x 8 outputs per thread, or 128 x 64
// with 8 x 4 (N <= 64, the c0_1 GEMMs, or when they fill the card in fewer
// waves), fragments read from shared memory as float4, the k loop fully
// unrolled, a 3-stage cp.async ring in dynamic shared memory (101 KB at
// 128 x 128, two blocks per SM).  Row-major a and column-major b tiles are
// stored k-major through 4-byte copies whose lanes cover 4 rows x 8 k,
// which with a row stride of BM + 4 writes every bank once; the other
// layouts copy 16 bytes at a time.  Before its main loop a block compacts
// its jointly occupied K-tiles (from the pre-pass flags) into a list in
// shared memory, and the ring prefetches along that list, so a skipped tile
// costs no bubble.  No tensor cores: TF32 keeps 11 bits of a Q4.16 value's
// 21 (see ROADMAP), so the product runs as fp32 FMAs.
//
// tile_occupancy computes the per-tile any-nonzero flags that the Pallas
// wrapper builds with jnp outside its kernel (masked_matmul/ops.py:25-28),
// the tile kernel's pre-pass: bound by one read of the operand, so a block
// reads a row of tiles across 8 column tiles with 16-byte loads.  Its
// flags are FLAG_M x BK (a) and BK x FLAG_N (b); a 128-wide block ORs the
// flags it covers.  The flags of a transposed operand are the transposed
// flags of the untransposed one.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() (or the error of a refused attribute) so the Python
// wrapper can raise.  Nothing is allocated here: the wrapper passes every
// buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FLAG_M = 64;    // rows of an a occupancy flag
constexpr int FLAG_N = 64;    // columns of a b occupancy flag
constexpr int BK = 32;        // K depth of a step and of a flag
constexpr int SKINNY_M = 32;  // the skinny kernel takes M <= this
constexpr int MAX_CHUNK_TILES = 256;  // K-tiles per chunk (8192 / BK)
constexpr int OCC_THREADS = 256;

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

// -- cp.async ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes; valid = false writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes from a 16-byte aligned src; the first n_valid floats are read,
// the rest of the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int n_valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(4 * n_valid));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers in shared memory: init with an arrival count, arrive, wait
// for the phase of a given parity to complete, and arrive once this
// thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
                 "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n"
        "}\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
        "r"(parity));
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
        static_cast<uint32_t>(__cvta_generic_to_shared(bar))));
}

__device__ __forceinline__ int clamp4(int n) { return n < 0 ? 0 : (n > 4 ? 4 : n); }

// Operand views.  A_COL: a[i][k] at a[k * lda + i] (else a[i * lda + k]).
// B_COL: b[k][j] at b[j * ldb + k] (else b[k * ldb + j]).
template <bool COL>
__device__ __forceinline__ int64_t at(int r, int c, int64_t ld) {
    return COL ? (int64_t)c * ld + r : (int64_t)r * ld + c;
}

// Warp 0 writes the K-tiles kt0 <= kt < kt1 for which occupied(kt) holds,
// in increasing order, to list[] and their count to *count.
template <typename Occ>
__device__ __forceinline__ void compact_tiles(int kt0, int kt1, Occ occupied, int* list,
                                              int* count) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = kt0; base < kt1; base += 32) {
        const int kt = base + lane;
        const bool occ = kt < kt1 && occupied(kt);
        const unsigned mask = __ballot_sync(0xffffffffu, occ);
        if (occ) list[n + __popc(mask & ((1u << lane) - 1u))] = kt;
        n += __popc(mask);
    }
    if (lane == 0) *count = n;
}

// -- the tile kernel --------------------------------------------------------------

// BM x BN outputs per block, 8 x (4 NH) per thread
template <int BM_, int BN_, int NH_>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, NH = NH_;
    static constexpr int TN = 4 * NH;                        // columns per thread
    static constexpr int TX = BN / TN, TY = BM / 8;          // threads along n and m
    static constexpr int THREADS = TX * TY;
    static constexpr int AS = BM + 4, BS = BN + 4;          // k-major row strides
    static constexpr int STAGE = BK * (AS + BS);            // floats per stage
    static constexpr int STAGES = 3;
    static constexpr int LIST = MAX_CHUNK_TILES + 4;        // ints ahead of the stages
    static constexpr int SMEM = (LIST + STAGES * STAGE) * 4;
    static constexpr int MIN_BLOCKS = 2;
};

// One K-tile of a (BM rows from row0) and b (BN cols from col0) into a
// stage: as[k][i], bs[k][j].
template <class T, bool A_COL, bool B_COL>
__device__ __forceinline__ void tile_load(float* sa, float* sb, const float* __restrict__ a,
                                          int64_t lda, bool a_vec, const float* __restrict__ b,
                                          int64_t ldb, bool b_vec, int row0, int col0, int kt,
                                          int M, int N, int K) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    constexpr int NW = T::THREADS / 32;
    const int k0 = kt * BK;
    // a
    if (!A_COL) {
        // transposing copy: a warp covers 4 rows x 8 k, so the stores hit
        // banks 4 k + i, all 32 distinct
        constexpr int CHUNKS = (T::BM / 4) * (BK / 8);
#pragma unroll
        for (int q = warp; q < CHUNKS; q += NW) {
            const int i = (q % (T::BM / 4)) * 4 + lane / 8, k = (q / (T::BM / 4)) * 8 + lane % 8;
            const int gi = row0 + i, gk = k0 + k;
            const bool ok = gi < M && gk < K;
            cp_async4(&sa[k * T::AS + i], ok ? a + at<false>(gi, gk, lda) : a, ok);
        }
    } else if (a_vec) {
        constexpr int V = BK * T::BM / 4;
#pragma unroll
        for (int e = tid; e < V; e += T::THREADS) {
            const int k = e / (T::BM / 4), i = (e % (T::BM / 4)) * 4;
            const int gi = row0 + i, gk = k0 + k;
            const int nv = gk < K ? clamp4(M - gi) : 0;
            cp_async16(&sa[k * T::AS + i], nv ? a + at<true>(gi, gk, lda) : a, nv);
        }
    } else {
#pragma unroll 4
        for (int e = tid; e < BK * T::BM; e += T::THREADS) {
            const int k = e / T::BM, i = e % T::BM;
            const int gi = row0 + i, gk = k0 + k;
            const bool ok = gi < M && gk < K;
            cp_async4(&sa[k * T::AS + i], ok ? a + at<true>(gi, gk, lda) : a, ok);
        }
    }
    // b
    if (B_COL) {
        constexpr int CHUNKS = (T::BN / 4) * (BK / 8);
#pragma unroll
        for (int q = warp; q < CHUNKS; q += NW) {
            const int j = (q % (T::BN / 4)) * 4 + lane / 8, k = (q / (T::BN / 4)) * 8 + lane % 8;
            const int gj = col0 + j, gk = k0 + k;
            const bool ok = gj < N && gk < K;
            cp_async4(&sb[k * T::BS + j], ok ? b + at<true>(gk, gj, ldb) : b, ok);
        }
    } else if (b_vec) {
        constexpr int V = BK * T::BN / 4;
#pragma unroll
        for (int e = tid; e < V; e += T::THREADS) {
            const int k = e / (T::BN / 4), j = (e % (T::BN / 4)) * 4;
            const int gj = col0 + j, gk = k0 + k;
            const int nv = gk < K ? clamp4(N - gj) : 0;
            cp_async16(&sb[k * T::BS + j], nv ? b + at<false>(gk, gj, ldb) : b, nv);
        }
    } else {
#pragma unroll 4
        for (int e = tid; e < BK * T::BN; e += T::THREADS) {
            const int k = e / T::BN, j = e % T::BN;
            const int gj = col0 + j, gk = k0 + k;
            const bool ok = gj < N && gk < K;
            cp_async4(&sb[k * T::BS + j], ok ? b + at<false>(gk, gj, ldb) : b, ok);
        }
    }
}

// Grid: x = row tiles (no 65,535 cap), y = column tiles, z = K chunks.
// Thread (ty, tx) owns rows h BM/2 + 4 ty + i (h in {0, 1}) and columns
// h BN/NH + 4 tx + j (h < NH), i, j < 4, so a warp's float4 fragment reads
// are conflict-free.  With one chunk a block applies the epilogue itself; with
// more, it writes its partial sum to partial[chunk].
template <class T, bool A_COL, bool B_COL>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
masked_mm_kernel(const float* __restrict__ a, int64_t lda, int a_vec,
                 const float* __restrict__ b, int64_t ldb, int b_vec,
                 const int* __restrict__ a_occ, int64_t ao_i, int64_t ao_k, int a_flag_rows,
                 const int* __restrict__ b_occ, int64_t bo_k, int64_t bo_j, int b_flag_cols,
                 float* __restrict__ out, float* __restrict__ partial, int M, int N, int K,
                 int chunk_tiles, int out_vec, Epilogue ep) {
    extern __shared__ __align__(16) float smem[];
    int* list = reinterpret_cast<int*>(smem);
    float* stages = smem + T::LIST;

    const int bi = blockIdx.x, bj = blockIdx.y, chunk = blockIdx.z;
    const int row0 = bi * T::BM, col0 = bj * T::BN;
    const int k_tiles = (K + BK - 1) / BK;
    const int kt0 = chunk * chunk_tiles;
    const int kt1 = min(k_tiles, kt0 + chunk_tiles);
    const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;

    // the flags this block covers: a rows [fi0, fi1), b columns [fj0, fj1)
    const int fi0 = row0 / FLAG_M, fi1 = min(a_flag_rows, (row0 + T::BM) / FLAG_M);
    const int fj0 = col0 / FLAG_N, fj1 = min(b_flag_cols, (col0 + T::BN) / FLAG_N);
    compact_tiles(kt0, kt1, [&](int kt) {
        int ao = 0, bo = 0;
        for (int f = fi0; f < fi1; ++f) ao |= a_occ[f * ao_i + kt * ao_k];
        for (int f = fj0; f < fj1; ++f) bo |= b_occ[kt * bo_k + f * bo_j];
        return (ao & bo) != 0;
    }, list, list + MAX_CHUNK_TILES);
    __syncthreads();
    const int n = list[MAX_CHUNK_TILES];

    float acc[8][T::TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

    auto load = [&](int t) {
        float* sa = stages + (t % T::STAGES) * T::STAGE;
        tile_load<T, A_COL, B_COL>(sa, sa + BK * T::AS, a, lda, a_vec, b, ldb, b_vec, row0,
                                   col0, list[t], M, N, K);
    };
#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) {
        if (s < n) load(s);
        cp_async_commit();
    }
    for (int t = 0; t < n; ++t) {
        cp_async_wait<T::STAGES - 2>();  // tile t has landed
        __syncthreads();                 // ... for every thread; tile t-1's stage is free
        if (t + T::STAGES - 1 < n) load(t + T::STAGES - 1);
        cp_async_commit();
        const float* sa = stages + (t % T::STAGES) * T::STAGE;
        const float* sb = sa + BK * T::AS;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk * T::AS + ty * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&sa[kk * T::AS + T::BM / 2 + ty * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            float bv[T::TN];
#pragma unroll
            for (int h = 0; h < T::NH; ++h) {
                const float4 b4 = *reinterpret_cast<const float4*>(
                    &sb[kk * T::BS + h * (T::BN / T::NH) + tx * 4]);
                bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z, bv[4 * h + 3] = b4.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();

    float* dst = partial == nullptr ? out : partial + (int64_t)chunk * M * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int row = row0 + (i / 4) * (T::BM / 2) + ty * 4 + i % 4;
        if (row >= M) continue;
#pragma unroll
        for (int h = 0; h < T::NH; ++h) {
            const int col = col0 + h * (T::BN / T::NH) + tx * 4;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                v[j] = partial == nullptr ? ep(acc[i][h * 4 + j], row, col + j)
                                          : acc[i][h * 4 + j];
            float* p = dst + (int64_t)row * N + col;
            if (out_vec && col + 3 < N) {
                *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (col + j < N) p[j] = v[j];
            }
        }
    }
}

// -- the skinny kernel ------------------------------------------------------------

template <int STAGES_, int CWARPS_, int MAXR_>
struct Skinny {
    static constexpr int SN = 16;                    // output columns per block
    static constexpr int CWARPS = CWARPS_;           // computing warps: 2 rows each per pass
    static constexpr int PWARPS = 4;                 // loading warps
    static constexpr int PTHREADS = 32 * PWARPS;
    static constexpr int THREADS = 32 * (CWARPS + PWARPS);
    static constexpr int MAXR = MAXR_;               // rows per computing thread
    static constexpr int MAX_M = 2 * CWARPS * MAXR;
    static constexpr int KB = MAXR == 1 ? 16 : 8;    // k per batch of fragment loads
    static constexpr int G = 4;                      // K-tiles per stage
    static constexpr int WTILE = BK * SN;            // floats of one tile's weights
    static constexpr int XV = (MAX_M * BK / 4 + PTHREADS - 1) / PTHREADS;  // x float4s per thread
    static constexpr int P = MAXR == 1 ? 3 : 2;      // stages a loading thread holds in registers
    static constexpr int STAGES = STAGES_;
    // ints: flags, list, count; then 2 STAGES mbarriers (8 bytes each)
    static constexpr int INTS = 2 * MAX_CHUNK_TILES + 8 + 4 * STAGES;
    // a stage: G weight tiles, then G x tiles of M x BK
    __host__ __device__ static constexpr int stage_floats(int m) { return G * (WTILE + m * BK); }
    static constexpr int smem_bytes(int m) { return (INTS + STAGES * stage_floats(m)) * 4; }
};

// Where element (k, j) of a weight tile sits: row-major b as [k][j];
// column-major b as [j][k] with its 16-byte chunks permuted by j % 8, so a
// warp reading 4 k of 8 columns touches 8 distinct bank groups.
template <bool B_COL>
__device__ __forceinline__ int w_at(int k, int j) {
    return B_COL ? j * BK + ((((k >> 2) ^ (j & 7)) << 2) | (k & 3)) : k * 16 + j;
}

// Grid: x = column strips of 16, y = K chunks.  Warps 0 to CWARPS - 1
// compute: lane l of warp w owns column l % 16 of the strip and rows
// 2 w + l / 16 + 2 CWARPS i, and each of its outputs is one fmaf chain over
// the chunk's occupied K-tiles in increasing k.  The 4 warps after them
// load: with both operands 16-byte aligned and x row-major, each thread
// one 16-byte vector of every tile, held P stages ahead in registers (a
// plain vector load keeps more bytes in flight per SM than cp.async);
// otherwise 4-byte cp.async copies.  Loading and computing meet at one
// pair of mbarriers per ring slot (full: its data is in; empty: every
// computing thread is done with it), so a load held up by the memory
// system never holds up the chains.
template <class S, bool A_COL, bool B_COL>
__global__ void __launch_bounds__(S::THREADS)
masked_mm_skinny_kernel(const float* __restrict__ a, int64_t lda, int a_vec,
                        const float* __restrict__ b, int64_t ldb, int b_vec,
                        float* __restrict__ out, float* __restrict__ partial, int M, int N,
                        int K, int chunk_tiles, Epilogue ep) {
    extern __shared__ __align__(16) float smem[];
    int* flags = reinterpret_cast<int*>(smem);
    int* list = flags + MAX_CHUNK_TILES;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * MAX_CHUNK_TILES + 8);
    uint64_t* empty = full + S::STAGES;
    float* stages = smem + S::INTS;
    const int stage_floats = S::stage_floats(M);

    const int col0 = blockIdx.x * S::SN, chunk = blockIdx.y;
    const int k_tiles = (K + BK - 1) / BK;
    const int kt0 = chunk * chunk_tiles;
    const int kt1 = min(k_tiles, kt0 + chunk_tiles);
    const int nt = kt1 - kt0;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int computing = min(S::CWARPS, (M + 1) / 2);  // computing warps with rows
    const bool loader = warp >= S::CWARPS;
    const int lt = tid - 32 * S::CWARPS;  // a loading thread's index
    const bool vec = !A_COL && a_vec && b_vec;  // the register-staged loads

    if (tid == 0) {
        for (int s = 0; s < S::STAGES; ++s) {
            mbar_init(&full[s], S::PTHREADS);
            mbar_init(&empty[s], 32 * computing);
        }
    }
    for (int t = tid; t < nt; t += S::THREADS) flags[t] = 0;
    __syncthreads();  // barriers initialised, flags cleared

    // The first STAGES stages take the chunk's first tiles in order, their
    // loads started before x's flags are known; the later stages take the
    // occupied tiles after those.  A head tile whose x is empty is loaded
    // but not multiplied.
    constexpr int HEAD = S::STAGES * S::G;
    const int head_stages = min(S::STAGES, (nt + S::G - 1) / S::G);
    int n_list = 0, n_stages = head_stages;  // known once the flags are
    auto tiles_in = [&](int s) {  // tiles in stage s
        return s >= n_stages ? 0
               : s < S::STAGES ? min(S::G, nt - s * S::G)
                               : min(S::G, n_list - (s - S::STAGES) * S::G);
    };
    auto tile_of = [&](int s, int g) {  // the K-tile in slot g < tiles_in(s) of stage s
        return s < S::STAGES ? kt0 + s * S::G + g : list[(s - S::STAGES) * S::G + g];
    };

    // register-staged loads: this thread's vector of a weight tile is
    // (bk, bj..bj+3) row-major or (bk..bk+3, bj) column-major; of x, the
    // vectors lt, lt + PTHREADS, ... of the M x BK tile
    const int bk = B_COL ? (lt % 8) * 4 : lt / 4, bj = B_COL ? lt / 8 : (lt % 4) * 4;
    const float* b_src = b + (B_COL ? (int64_t)(col0 + bj) * ldb + bk : (int64_t)bk * ldb + col0 + bj);
    const int b_nv = B_COL ? (col0 + bj < N ? 4 : 0) : clamp4(N - col0 - bj);
    auto ldg4 = [](const float* p, int nv) {  // the first nv floats at p, the rest 0
        return nv == 4 ? __ldg(reinterpret_cast<const float4*>(p))
                       : make_float4(nv > 0 ? __ldg(p) : 0.0f, nv > 1 ? __ldg(p + 1) : 0.0f,
                                     nv > 2 ? __ldg(p + 2) : 0.0f, 0.0f);
    };
    float4 wr[S::P][S::G], xr[S::P][S::G][S::XV];
    auto fetch = [&](int s, float4 (&w)[S::G], float4 (&x)[S::G][S::XV]) {
        const int tiles = tiles_in(s);
#pragma unroll
        for (int g = 0; g < S::G; ++g) {
            if (g >= tiles) break;
            const int k0 = tile_of(s, g) * BK;
            w[g] = ldg4(b_src + (B_COL ? (int64_t)k0 : (int64_t)k0 * ldb),
                        B_COL ? min(b_nv, clamp4(K - k0 - bk)) : (k0 + bk < K ? b_nv : 0));
#pragma unroll
            for (int v = 0; v < S::XV; ++v) {
                const int e = lt + v * S::PTHREADS, r = e / (BK / 4), k = (e % (BK / 4)) * 4;
                x[g][v] = ldg4(a + (int64_t)min(r, M - 1) * lda + k0 + k,
                               r < M ? clamp4(K - k0 - k) : 0);
            }
        }
    };
    auto store = [&](int s, const float4 (&w)[S::G], const float4 (&x)[S::G][S::XV]) {
        float* sw = stages + (s % S::STAGES) * stage_floats;
        float* sx = sw + S::G * S::WTILE;
        const int tiles = tiles_in(s);
#pragma unroll
        for (int g = 0; g < S::G; ++g) {
            if (g >= tiles) break;
            *reinterpret_cast<float4*>(&sw[g * S::WTILE + w_at<B_COL>(bk, bj)]) = w[g];
#pragma unroll
            for (int v = 0; v < S::XV; ++v) {
                const int e = lt + v * S::PTHREADS;
                if (e < M * BK / 4) *reinterpret_cast<float4*>(&sx[g * M * BK + e * 4]) = x[g][v];
            }
        }
        mbar_arrive(&full[s % S::STAGES]);  // release: the stores above are in
    };
    // 4-byte cp.async copies into the same layout, for the other operands
    auto copy = [&](int s) {
        float* sw = stages + (s % S::STAGES) * stage_floats;
        float* sx = sw + S::G * S::WTILE;
        const int tiles = tiles_in(s);
        for (int g = 0; g < tiles; ++g) {
            const int k0 = tile_of(s, g) * BK;
            for (int e = lt; e < BK * S::SN; e += S::PTHREADS) {
                const int k = B_COL ? e % BK : e / S::SN, j = B_COL ? e / BK : e % S::SN;
                const bool ok = k0 + k < K && col0 + j < N;
                cp_async4(&sw[g * S::WTILE + w_at<B_COL>(k, j)],
                          ok ? b + at<B_COL>(k0 + k, col0 + j, ldb) : b, ok);
            }
            for (int e = lt; e < M * BK; e += S::PTHREADS) {
                const int r = A_COL ? e % M : e / BK, k = A_COL ? e / M : e % BK;
                const bool ok = k0 + k < K;
                cp_async4(&sx[g * M * BK + r * BK + k], ok ? a + at<A_COL>(r, k0 + k, lda) : a,
                          ok);
            }
        }
        cp_async_arrive(&full[s % S::STAGES]);
    };
    if (loader) {
        if (vec) {
#pragma unroll
            for (int p = 0; p < S::P; ++p) fetch(p, wr[p], xr[p]);
        } else {
            for (int s = 0; s < head_stages; ++s) copy(s);
        }
    }

    // x's all-zero K-tiles of this chunk (NaN != 0 counts as nonzero), by
    // every thread.  Row-major x in float4s: 8 lanes test one (tile, row)
    // pair, so a warp tests 4 per step; 16 steps' loads are in flight before
    // any is tested.  Blocks start at different tiles, so they do not all
    // read the same lines of x at once.
    {
        constexpr int U = 16;
        const int pairs = nt * M;
        const bool xvec = !A_COL && a_vec;
        const int per_step = xvec ? S::THREADS / 8 : S::THREADS / 32;
        const int step_t = per_step / M, step_r = per_step % M;  // per_step as tiles, rows
        const int rot = (int)(8 * blockIdx.x % nt);
        for (int base = 0; base < pairs; base += per_step * U) {  // uniform: ballots below
            // this thread's pair p = t M + r walks p0, p0 + per_step, ...;
            // tile[u] is the flag it sets, rotated by rot
            const int p0 = base + (xvec ? tid / 8 : warp);
            int t = p0 / M, r = p0 % M, tile[U];
            bool nz[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const bool live = p0 + u * per_step < pairs;
                tile[u] = t + rot < nt ? t + rot : t + rot - nt;
                bool z = false;
                if (live) {
                    if (xvec) {
                        const int k = (kt0 + tile[u]) * BK + (lane % 8) * 4;
                        if (k < K) {  // K % 4 == 0 when a_vec: a whole float4 or none
                            const float4 v = *reinterpret_cast<const float4*>(
                                a + at<false>(r, k, lda));
                            z = v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
                        }
                    } else {
                        const int k = (kt0 + tile[u]) * BK + lane;
                        z = k < K && a[at<A_COL>(r, k, lda)] != 0.0f;
                    }
                }
                nz[u] = live && z;
                t += step_t, r += step_r;
                if (r >= M) t += 1, r -= M;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const unsigned mask = __ballot_sync(0xffffffffu, nz[u]);
                const bool leader = xvec ? lane % 8 == 0 : lane == 0;
                const unsigned group = xvec ? (mask >> (lane & ~7)) & 0xffu : mask;
                if (leader && group) flags[tile[u]] = 1;
            }
        }
    }
    __syncthreads();
    compact_tiles(min(kt1, kt0 + HEAD), kt1, [&](int kt) { return flags[kt - kt0] != 0; },
                  list, list + MAX_CHUNK_TILES);
    __syncthreads();
    n_list = list[MAX_CHUNK_TILES];
    n_stages = head_stages + (n_list + S::G - 1) / S::G;

    if (loader) {
        if (vec) {
            for (int s0 = 0; s0 < n_stages; s0 += S::P) {
#pragma unroll
                for (int p = 0; p < S::P; ++p) {
                    const int s = s0 + p;
                    if (s >= n_stages) break;
                    if (s >= S::STAGES) mbar_wait(&empty[s % S::STAGES], (s / S::STAGES - 1) & 1);
                    store(s, wr[p], xr[p]);
                    fetch(s + S::P, wr[p], xr[p]);
                }
            }
        } else {
            for (int s = head_stages; s < n_stages; ++s) {
                mbar_wait(&empty[s % S::STAGES], (s / S::STAGES - 1) & 1);  // slot consumed
                copy(s);
            }
            cp_async_wait<0>();
        }
        return;
    }
    if (warp >= computing) return;  // a computing warp without rows

    float acc[S::MAXR];
#pragma unroll
    for (int i = 0; i < S::MAXR; ++i) acc[i] = 0.0f;
    const int c = lane % 16, row0 = 2 * warp + lane / 16;

    // fragments of batch b (KB k) of a tile into registers; a row past M
    // repeats row M - 1, computed and never stored
    float4 w0[S::KB / 4], x0[S::MAXR][S::KB / 4], w1[S::KB / 4], x1[S::MAXR][S::KB / 4];
    auto frag = [&](const float* tw, const float* tx, int b, float4 (&w)[S::KB / 4],
                    float4 (&x)[S::MAXR][S::KB / 4]) {
#pragma unroll
        for (int q = 0; q < S::KB / 4; ++q) {
            const int kk = b * S::KB + 4 * q;
            if (B_COL) {
                w[q] = *reinterpret_cast<const float4*>(&tw[w_at<true>(kk, c)]);
            } else {
                w[q] = make_float4(tw[w_at<false>(kk, c)], tw[w_at<false>(kk + 1, c)],
                                   tw[w_at<false>(kk + 2, c)], tw[w_at<false>(kk + 3, c)]);
            }
#pragma unroll
            for (int i = 0; i < S::MAXR; ++i)
                x[i][q] = *reinterpret_cast<const float4*>(
                    &tx[min(row0 + 2 * S::CWARPS * i, M - 1) * BK + kk]);
        }
    };
    auto chains = [&](const float4 (&w)[S::KB / 4], const float4 (&x)[S::MAXR][S::KB / 4]) {
#pragma unroll
        for (int q = 0; q < S::KB / 4; ++q)
#pragma unroll
            for (int i = 0; i < S::MAXR; ++i) {
                acc[i] = fmaf(x[i][q].x, w[q].x, acc[i]);
                acc[i] = fmaf(x[i][q].y, w[q].y, acc[i]);
                acc[i] = fmaf(x[i][q].z, w[q].z, acc[i]);
                acc[i] = fmaf(x[i][q].w, w[q].w, acc[i]);
            }
    };

    for (int s = 0; s < n_stages; ++s) {
        mbar_wait(&full[s % S::STAGES], (s / S::STAGES) & 1);  // the slot is in
        const float* sw = stages + (s % S::STAGES) * stage_floats;
        const float* sx = sw + S::G * S::WTILE;
        const int tiles = tiles_in(s);
        for (int g = 0; g < tiles; ++g) {
            if (s < S::STAGES && !flags[s * S::G + g]) continue;  // a head tile, x empty
            const float* tw = sw + g * S::WTILE;
            const float* tx = sx + g * M * BK;
            // batches of KB k, the next batch's fragments loaded while the
            // current one's chains run
            constexpr int NB = BK / S::KB;  // 2 or 4
            frag(tw, tx, 0, w0, x0);
#pragma unroll
            for (int b = 0; b < NB; b += 2) {
                frag(tw, tx, b + 1, w1, x1);
                chains(w0, x0);
                if (b + 2 < NB) frag(tw, tx, b + 2, w0, x0);
                chains(w1, x1);
            }
        }
        mbar_arrive(&empty[s % S::STAGES]);  // this thread is done with the slot
    }

    const int col = col0 + c;
    if (col >= N) return;
    float* dst = partial == nullptr ? out : partial + (int64_t)chunk * M * N;
#pragma unroll
    for (int i = 0; i < S::MAXR; ++i) {
        const int r = row0 + 2 * S::CWARPS * i;
        if (r < M) dst[(int64_t)r * N + col] = partial == nullptr ? ep(acc[i], r, col) : acc[i];
    }
}

// out[i] = epilogue(sum over chunks c = 0, 1, ... of partial[c][i]), in
// chunk order: the order is the bit contract with both matmul kernels, so
// the sum over chunks is never split into a tree.  What bounds it on the
// H100 is bytes: every partial is read once (28.9 MB for VGG-19 c0_1's dW,
// 196 chunks of 576 x 64), against only 36,864 outputs, so the card must
// keep many chunks' loads in flight for few threads.  A thread that issues
// a batch of loads into registers and then adds them lets its loads drain
// to none before the next batch, and stays latency-bound far below the
// memory rate.  Here a thread owns V = 4 adjacent outputs (16-byte
// copies; V = 1, 4-byte copies, where the chunk stride or a pointer is not
// 16-byte aligned) and keeps RED_RING chunks in flight at every step in its
// own slots of a shared-memory ring with cp.async: it waits for the next
// RED_BATCH chunks, adds them in order, and refills their slots with the
// chunks RED_RING further on.  No thread reads another's slots, so no
// barrier is needed; blocks of one warp spread the few threads over every
// SM.  The SR epilogue's row and column come from one 32-bit division per
// thread, and only when SR is on.
constexpr int RED_THREADS = 32;
constexpr int RED_RING = 32;
constexpr int RED_BATCH = 8;

template <int V>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src) {
    if constexpr (V == 4)
        cp_async16(dst, src, 4);
    else
        cp_async4(dst, src, true);
}

template <int V>
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int total, int N,
                     int n_chunks, Epilogue ep) {
    __shared__ __align__(16) float ring[RED_RING][RED_THREADS * V];
    const int i0 = (blockIdx.x * RED_THREADS + threadIdx.x) * V;
    if (i0 >= total) return;
    const float* p = partial + i0;
    float* slot = &ring[0][threadIdx.x * V];  // chunk c lands at slot + (c % RED_RING) * stride
    constexpr int stride = RED_THREADS * V;
#pragma unroll
    for (int r = 0; r < RED_RING; r += RED_BATCH) {
#pragma unroll
        for (int q = 0; q < RED_BATCH; ++q)
            if (r + q < n_chunks)
                cp_async_v<V>(slot + (r + q) * stride, p + (int64_t)(r + q) * total);
        cp_async_commit();  // one group per batch, empty past the last chunk
    }
    float s[V];
    for (int c = 0; c < n_chunks; c += RED_BATCH) {
        cp_async_wait<RED_RING / RED_BATCH - 1>();  // chunks c .. c + RED_BATCH - 1 landed
        float* sl = slot + (c % RED_RING) * stride;
        float v[RED_BATCH][V];
#pragma unroll
        for (int q = 0; q < RED_BATCH; ++q)
#pragma unroll
            for (int e = 0; e < V; ++e) v[q][e] = sl[q * stride + e];
#pragma unroll
        for (int q = 0; q < RED_BATCH; ++q)
            if (c + q < n_chunks)
#pragma unroll
                for (int e = 0; e < V; ++e) s[e] = c + q == 0 ? v[q][e] : s[e] + v[q][e];
        // the slots were read into registers above, so they can be refilled
#pragma unroll
        for (int q = 0; q < RED_BATCH; ++q)
            if (c + q + RED_RING < n_chunks)
                cp_async_v<V>(sl + q * stride, p + (int64_t)(c + q + RED_RING) * total);
        cp_async_commit();
    }
    if (ep.apply_sr) {
        int row = (int)((unsigned)i0 / (unsigned)N), col = i0 - row * N;
#pragma unroll
        for (int e = 0; e < V; ++e) {
            s[e] = ep(s[e], row, col);
            if (++col == N) col = 0, ++row;
        }
    }
    if constexpr (V == 4)
        *reinterpret_cast<float4*>(out + i0) = make_float4(s[0], s[1], s[2], s[3]);
    else
        out[i0] = s[0];
}

// occ[ti * n_tile_cols + tj] = any(a[tile (ti, tj)] != 0).  A block reads
// one row of tiles across OCC_GROUP column tiles, 16 bytes at a time where
// the rows allow it: row tiles on grid x (no 65,535 cap), groups of column
// tiles on grid y.
constexpr int OCC_GROUP = 8;

__global__ void __launch_bounds__(OCC_THREADS)
tile_occupancy_kernel(const float* __restrict__ a, int rows, int cols, int tile_rows,
                      int tile_cols, int n_tile_cols, int vec, int* __restrict__ occ) {
    __shared__ int any[OCC_GROUP];
    const int ti = blockIdx.x, tj0 = blockIdx.y * OCC_GROUP;
    const int r0 = ti * tile_rows, c0 = tj0 * tile_cols;
    const int width = min(OCC_GROUP, n_tile_cols - tj0) * tile_cols;  // columns of the group
    if (threadIdx.x < OCC_GROUP) any[threadIdx.x] = 0;
    __syncthreads();
    if (vec) {  // cols and tile_cols multiples of 4, a 16-byte aligned
        const int w4 = width / 4;
#pragma unroll 8
        for (int e = threadIdx.x; e < tile_rows * w4; e += OCC_THREADS) {
            const int r = r0 + e / w4, c = c0 + (e % w4) * 4;
            if (r < rows && c < cols) {
                const float4 v = *reinterpret_cast<const float4*>(a + (int64_t)r * cols + c);
                if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
                    any[(c - c0) / tile_cols] = 1;
            }
        }
    } else {
#pragma unroll 8
        for (int e = threadIdx.x; e < tile_rows * width; e += OCC_THREADS) {
            const int r = r0 + e / width, c = c0 + e % width;
            if (r < rows && c < cols && a[(int64_t)r * cols + c] != 0.0f)
                any[(c - c0) / tile_cols] = 1;
        }
    }
    __syncthreads();
    if (threadIdx.x < OCC_GROUP && tj0 + threadIdx.x < n_tile_cols)
        occ[(int64_t)ti * n_tile_cols + tj0 + threadIdx.x] = any[threadIdx.x];
}

// Raise the kernel's dynamic shared memory limit to `bytes` (once per
// kernel); the error if the attribute is refused.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
    if (done) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done = true;
    return err;
}

template <class T, bool A_COL, bool B_COL>
cudaError_t launch_tile(cudaStream_t s, const float* a, int64_t lda, int a_vec, const float* b,
                        int64_t ldb, int b_vec, const int* a_occ, int64_t ao_i, int64_t ao_k,
                        const int* b_occ, int64_t bo_k, int64_t bo_j, float* out,
                        float* partial, int m, int n, int k, int chunk_tiles, int n_chunks,
                        int out_vec, Epilogue ep) {
    static bool ready = false;
    const cudaError_t err = allow_smem(masked_mm_kernel<T, A_COL, B_COL>, T::SMEM, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN, n_chunks);
    masked_mm_kernel<T, A_COL, B_COL><<<grid, T::THREADS, T::SMEM, s>>>(
        a, lda, a_vec, b, ldb, b_vec, a_occ, ao_i, ao_k, (m + FLAG_M - 1) / FLAG_M, b_occ, bo_k,
        bo_j, (n + FLAG_N - 1) / FLAG_N, out, partial, m, n, k, chunk_tiles, out_vec, ep);
    return cudaGetLastError();
}

template <class T>
cudaError_t launch_tile_layout(int a_col, int b_col, cudaStream_t s, const float* a,
                               int64_t lda, int a_vec, const float* b, int64_t ldb, int b_vec,
                               const int* a_occ, int64_t ao_i, int64_t ao_k, const int* b_occ,
                               int64_t bo_k, int64_t bo_j, float* out, float* partial, int m,
                               int n, int k, int chunk_tiles, int n_chunks, int out_vec,
                               Epilogue ep) {
#define MM_TILE(AC, BC)                                                                     \
    launch_tile<T, AC, BC>(s, a, lda, a_vec, b, ldb, b_vec, a_occ, ao_i, ao_k, b_occ, bo_k, \
                           bo_j, out, partial, m, n, k, chunk_tiles, n_chunks, out_vec, ep)
    if (a_col && b_col) return MM_TILE(true, true);
    if (a_col) return MM_TILE(true, false);
    if (b_col) return MM_TILE(false, true);
    return MM_TILE(false, false);
#undef MM_TILE
}

template <class S, bool A_COL, bool B_COL>
cudaError_t launch_skinny(cudaStream_t s, const float* a, int64_t lda, int a_vec,
                          const float* b, int64_t ldb, int b_vec, float* out, float* partial,
                          int m, int n, int k, int chunk_tiles, int n_chunks, Epilogue ep) {
    static bool ready = false;
    const cudaError_t err = allow_smem(masked_mm_skinny_kernel<S, A_COL, B_COL>,
                                       S::smem_bytes(S::MAX_M), ready);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + S::SN - 1) / S::SN, n_chunks);
    masked_mm_skinny_kernel<S, A_COL, B_COL><<<grid, S::THREADS, S::smem_bytes(m), s>>>(
        a, lda, a_vec, b, ldb, b_vec, out, partial, m, n, k, chunk_tiles, ep);
    return cudaGetLastError();
}

template <class S>
cudaError_t launch_skinny_layout(int a_col, int b_col, cudaStream_t s, const float* a,
                                 int64_t lda, int a_vec, const float* b, int64_t ldb, int b_vec,
                                 float* out, float* partial, int m, int n, int k,
                                 int chunk_tiles, int n_chunks, Epilogue ep) {
#define MM_SKINNY(AC, BC)                                                                   \
    launch_skinny<S, AC, BC>(s, a, lda, a_vec, b, ldb, b_vec, out, partial, m, n, k,       \
                             chunk_tiles, n_chunks, ep)
    if (a_col && b_col) return MM_SKINNY(true, true);
    if (a_col) return MM_SKINNY(true, false);
    if (b_col) return MM_SKINNY(false, true);
    return MM_SKINNY(false, false);
#undef MM_SKINNY
}

// 128 x 64 tiles when N <= 64, or when their grid fills the card in fewer
// waves of two blocks per SM than 128 x 128 tiles take for the same work
bool narrow_tiles(int m, int n, int n_chunks) {
    if (n <= 64) return true;
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    const long long slots = 2LL * sms, rows = (m + 127) / 128;
    const long long wide = rows * ((n + 127) / 128) * n_chunks;
    const long long narrow = rows * ((n + 63) / 64) * n_chunks;
    return (narrow + slots - 1) / slots < 2 * ((wide + slots - 1) / slots);
}

// 16-byte copies need a 16-byte aligned base and a leading dimension that
// keeps every row (column) start aligned
bool vec_ok(const void* p, long long ld) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

}  // namespace

extern "C" {

// [FLAG_M, FLAG_N, BK, SKINNY_M, MAX_CHUNK_TILES], which the Python wrapper
// sizes the flags and chunks with and checks
void masked_matmul_config(int* out) {
    out[0] = FLAG_M;
    out[1] = FLAG_N;
    out[2] = BK;
    out[3] = SKINNY_M;
    out[4] = MAX_CHUNK_TILES;
}

int tile_occupancy_launch(const float* a, int rows, int cols, int tile_rows,
                          int tile_cols, int* occ, void* stream) {
    const int n_tile_cols = (cols + tile_cols - 1) / tile_cols;
    const dim3 grid((rows + tile_rows - 1) / tile_rows, (n_tile_cols + OCC_GROUP - 1) / OCC_GROUP);
    const int vec = vec_ok(a, cols) && tile_cols % 4 == 0;
    tile_occupancy_kernel<<<grid, OCC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, rows, cols, tile_rows, tile_cols, n_tile_cols, vec, occ);
    return static_cast<int>(cudaGetLastError());
}

// The tile kernel.  a_col / b_col: operand layout (see at<>); a_occ is
// indexed [i * ao_i + k * ao_k] over FLAG_M x BK tiles, b_occ
// [k * bo_k + j * bo_j] over BK x FLAG_N tiles.  n_chunks > 1 needs
// `partial` of n_chunks * m * n floats; the caller then runs the reduce.
int masked_matmul_launch(const float* a, long long lda, int a_col, const float* b,
                         long long ldb, int b_col, const int* a_occ, long long ao_i,
                         long long ao_k, const int* b_occ, long long bo_k, long long bo_j,
                         float* out, float* partial, int m, int n, int k, int chunk_tiles,
                         int n_chunks, int n_pad, unsigned int seed, int apply_sr,
                         float scale, float eps, float min_v, float max_v, void* stream) {
    if (chunk_tiles > MAX_CHUNK_TILES) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Epilogue ep{n_pad, seed, apply_sr, scale, eps, min_v, max_v};
    float* part = n_chunks > 1 ? partial : nullptr;
    const int a_vec = vec_ok(a, lda), b_vec = vec_ok(b, ldb);
    const int out_vec = vec_ok(part ? part : out, n);
    const cudaError_t err =
        narrow_tiles(m, n, n_chunks)
            ? launch_tile_layout<Tile<128, 64, 1>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                     b_vec, a_occ, ao_i, ao_k, b_occ, bo_k,
                                                     bo_j, out, part, m, n, k, chunk_tiles,
                                                     n_chunks, out_vec, ep)
            : launch_tile_layout<Tile<128, 128, 2>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                      b_vec, a_occ, ao_i, ao_k, b_occ, bo_k,
                                                      bo_j, out, part, m, n, k, chunk_tiles,
                                                      n_chunks, out_vec, ep);
    return static_cast<int>(err);
}

// The skinny kernel, m <= SKINNY_M; no occupancy flags.  Same layouts,
// chunks and epilogue as masked_matmul_launch.
int masked_matmul_skinny_launch(const float* a, long long lda, int a_col, const float* b,
                                long long ldb, int b_col, float* out, float* partial, int m,
                                int n, int k, int chunk_tiles, int n_chunks, int n_pad,
                                unsigned int seed, int apply_sr, float scale, float eps,
                                float min_v, float max_v, void* stream) {
    if (m > SKINNY_M || chunk_tiles > MAX_CHUNK_TILES)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Epilogue ep{n_pad, seed, apply_sr, scale, eps, min_v, max_v};
    float* part = n_chunks > 1 ? partial : nullptr;
    const int a_vec = vec_ok(a, lda), b_vec = vec_ok(b, ldb);
    const cudaError_t err =
        m <= 4    ? launch_skinny_layout<Skinny<8, 2, 1>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                           b_vec, out, part, m, n, k, chunk_tiles,
                                                           n_chunks, ep)
        : m <= 8  ? launch_skinny_layout<Skinny<8, 4, 1>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                           b_vec, out, part, m, n, k, chunk_tiles,
                                                           n_chunks, ep)
        : m <= 16 ? launch_skinny_layout<Skinny<8, 8, 1>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                           b_vec, out, part, m, n, k, chunk_tiles,
                                                           n_chunks, ep)
                  : launch_skinny_layout<Skinny<6, 8, 2>>(a_col, b_col, s, a, lda, a_vec, b, ldb,
                                                           b_vec, out, part, m, n, k, chunk_tiles,
                                                           n_chunks, ep);
    return static_cast<int>(err);
}

int splitk_reduce_launch(const float* partial, float* out, int m, int n, int n_chunks,
                         int n_pad, unsigned int seed, int apply_sr, float scale, float eps,
                         float min_v, float max_v, void* stream) {
    const Epilogue ep{n_pad, seed, apply_sr, scale, eps, min_v, max_v};
    const int64_t total = (int64_t)m * n;
    if (m <= 0 || n <= 0 || n_chunks <= 0 || total > INT32_MAX - 3)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = total % 4 == 0 && reinterpret_cast<uintptr_t>(partial) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int64_t threads = vec ? total / 4 : total;
    const unsigned blocks = (unsigned)((threads + RED_THREADS - 1) / RED_THREADS);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        splitk_reduce_kernel<4><<<blocks, RED_THREADS, 0, st>>>(partial, out, (int)total, n,
                                                                 n_chunks, ep);
    else
        splitk_reduce_kernel<1><<<blocks, RED_THREADS, 0, st>>>(partial, out, (int)total, n,
                                                                 n_chunks, ep);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
