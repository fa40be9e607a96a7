// Blockwise online-softmax (flash) attention with GQA, causal and
// sliding-window masks.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_fa_kernel`
// (repro/kernels/flash_attention/fa_kernel.py:99).  Computes, per (b, h),
//   out = softmax(mask(q k^T * scale)) v,   kv head = h / (H / HKV)
// with the reference's online-softmax state and guards: the running max m,
// denominator l and accumulator live in fp32; alpha = 0 while m is still
// -1e30 (a row with no live key yet); a row whose l stays 0 outputs 0.
//
// Design.  The Pallas grid (B, H, Sq/128, Skv/128) carries (m, l, acc) in
// VMEM across its sequential kv axis; here one CTA of 4 warps owns a tile of
// query rows and walks the kv tiles (32 keys each) in a loop, keeping the
// state in registers.
// - Query tiles packed by GQA group.  A tile has BQ = 128 rows (64 at
//   D 128, or when 128-row tiles would give the card too few CTAs: the
//   wrapper's `plan` chooses) that are `heads_per_cta` heads of one kv group
//   (the largest power of two dividing the group, at most 8) at the same
//   BQ / heads_per_cta positions: llama3.2-1b's group of 4 is 4 heads x 32
//   positions.  Each K/V tile is fetched once for the whole group, and the
//   causal loop ends at the tile's own strip of positions.  Query tiles are
//   issued latest-first, over every head and batch, so the longest causal
//   walks start first.
// - Register tiles.  A warp owns 4 * TM rows (TM = 8 rows per lane in the
//   128-row tile, 4 in the 64-row one) as 4 row groups x 8 lanes; a lane
//   holds TM rows x 4 keys of the score tile and TM rows x D / 8 columns of
//   the output, so a row's max and sum are 8-lane shuffles.  Q is staged
//   once as fp32, transposed (d-major), so 4 rows are one float4 read; K
//   rows are read along d as float4 (rows padded by 16 bytes,
//   conflict-free); P goes through shared memory transposed (key-major) for
//   P @ V.  Every row of P belongs to one warp, so P needs only
//   `__syncwarp`.  The loops are unrolled by 2 steps of 4 d (Q K^T) and 8
//   keys (P V): fully unrolled, the compiler hoisted loads until 255
//   registers spilled.
// - A cp.async ring of K/V tiles (3 stages in the 128-row tile, 2 in the
//   64-row one): the copy of tile t + STAGES - 1 is issued before the math
//   of tile t, and one `__syncthreads` per tile both publishes tile t and
//   frees the slot of tile t - 1.  Copies are 16 bytes where the base and
//   the (b, h, s) strides allow it, 4 bytes where they allow that, plain
//   loads otherwise; keys at index >= Skv are zero-filled.  A thread's copy
//   addresses advance by a constant (hoisted per-copy offsets held dozens
//   of registers across the loop).  bf16 K/V are staged raw and up-cast on
//   the read from shared memory.
// - Masks on boundary tiles only: a tile that crosses the causal diagonal,
//   the window's edge or Skv tests each element by absolute index (keys at
//   index >= Skv are masked, as the oracle does, not padded in as the
//   Pallas route does); interior tiles take no test.  The causal and window
//   block skips bound the loop, so skipped tiles are never loaded.
// - exp2 (ex2.approx) on scores scaled by scale * log2(e); each lane keeps
//   a partial l, summed across the row's lanes once at the end.
// - D 256 (recurrentgemma's local attention) splits D over two warp
//   groups: 8 warps, warps w and w + 4 own the same 16 rows, each half of
//   the d axis.  A lane of one row at D 256 would hold 4 x 32 accumulators
//   and spill; split, it holds 4 x 16, as at D 128.  Each group sums its
//   half of Q K^T, the two partial score tiles are swapped through shared
//   memory between the pair (two 64-thread named barriers a tile) and added
//   (IEEE addition commutes, so both groups hold the same scores, maxima and
//   sums); each group then accumulates P V for its half of the output
//   columns.  The 64-row tile, 2 stages, one CTA (8 warps) per SM.
// q/k/v are read through (b, h, s) strides with a contiguous D axis, so the
// model's (B, S, H, D) projections are read in place; the output is
// written in the input type.
//
// Shared memory per CTA (fp32): 101 KB for the 128-row tile at D 64; 108 KB
// for the 64-row tile at D 128, 60 KB at D 64, 211 KB at D 256 (Q 64 KB, a
// 2-stage K/V ring of 130 KB, a P / partial-score tile per warp group).
// Registers (nvcc 12.8, no spills): 219 a lane in the 128-row tile at D 64,
// 155 in the 64-row tile at D 64 (three CTAs per SM), 238 at D 128; two
// CTAs per SM otherwise; 240 at D 256 (195 in bf16), one CTA of 8 warps
// per SM.  bf16 halves the K/V ring.
//
// What bounds it on the H100: at llama3.2-1b's prefill (H 32, HKV 8, D 64,
// S 4096, causal) it does 2 * 2 * H * S^2 * D / 2 = 68.7 GFLOP per layer on
// 16.8 MB of q/k/v/out: bound by operations, 1.03 ms at 67 TFLOP/s of fp32
// FMAs.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit: 1.79 ms there (38 TFLOP/s, 57% of that peak; the first
// version of this kernel took 3.04 ms), 7.08 ms at S 8192, 3.73 ms at D 128,
// and 3.10 ms at recurrentgemma-9b's local attention (H 16, HKV 1, D 256,
// S 4096, window 2048: 103.1 GFLOP, bound 1.54 ms; 33 TFLOP/s).
// What is left is issue and latency: the inner loops issue 12 shared-memory
// reads per 128 FMAs (Q K^T) and 4 per 64 (P V), plus about 40 softmax
// instructions per lane and tile, from eight warps per SM.  No tensor
// cores: the repo keeps TF32 off, so the products run as fp32 FMAs.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BKV = 32;           // keys per kv tile
constexpr int TK = BKV / 8;       // keys per lane in the score tile
constexpr int MAX_HEADS_PER_CTA = 8;
// unroll factors of the Q K^T loop (steps of 4 d) and of the P V loop (keys):
// full unrolling lets the compiler hoist loads until the registers spill
constexpr int UNROLL_D = 2, UNROLL_J = 8;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BIG_TM = 8, SMALL_TM = 4;  // rows per lane of the 128- and 64-row tiles
constexpr int BIG_ROWS = WARPS * 4 * BIG_TM, SMALL_ROWS = WARPS * 4 * SMALL_TM;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, s;
};

struct Params {
    const void *q, *k, *v;
    void* o;
    Strides qs, ks, vs, os;
    int batch, group, sq, skv, causal, window;
    int heads_per_cta, pos_shift;  // positions per tile = 1 << pos_shift
    int n_head_tiles, n_pos_tiles;
    int q_vec, kv_mode;  // q: 4-element vector loads; kv: copy bytes 16, 4 or 0 (plain)
    float c;             // scale * log2(e)
};

// TM rows per lane; STAGES slots in the K/V ring; DSPLIT warp groups, each
// owning D / DSPLIT of the d axis for the same rows
template <int D, typename T, int TM, int STAGES, int DSPLIT>
struct Cfg {
    static constexpr int NT = THREADS * DSPLIT;                 // threads per CTA
    static constexpr int BQ = WARPS * 4 * TM;                   // query rows per CTA
    static constexpr int WR = 4 * TM;                           // rows per warp
    static constexpr int DH = D / DSPLIT;                       // d columns per warp group
    static constexpr int LD = D + 16 / (int)sizeof(T);          // staged K/V row, elements
    static constexpr int PLD = BQ + 4;                          // P^T row, floats
    static constexpr int NC = DH / 8;                           // output columns per lane
    static constexpr int Q_BYTES = D * BQ * 4;                  // Q^T, fp32
    static constexpr int KV_BYTES = 2 * BKV * LD * (int)sizeof(T);  // one slot: K, then V
    static constexpr int P_FLOATS = BKV * PLD;                  // one group's P^T
    static constexpr int SMEM = Q_BYTES + STAGES * KV_BYTES + DSPLIT * P_FLOATS * 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

// 4 (or 2) consecutive elements as floats; bf16 is the high half of an fp32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// -- cp.async -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16 or 4) from src; valid = false writes zeros and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                     "l"(src), "r"(valid ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                     "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier `id` (1..WARPS; 0 is __syncthreads) over the two warps of a pair
__device__ __forceinline__ void pair_sync(int id) {
    asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// Copy BKV rows of D elements into dst (row stride LD), BYTES per cp.async:
// row r from base + (j0 + r) * stride, zeros at key j0 + r >= skv.  A thread
// copies one column chunk of every STEP-th row, so its addresses advance by
// a constant and few registers stay live across the kv loop.
template <int BYTES, int D, int LD, int NT, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* base, long long stride, int j0,
                                          int skv) {
    constexpr int CH = BYTES / (int)sizeof(T);  // elements per copy
    constexpr int NCH = D / CH;                 // copies per row (a power of two <= NT)
    constexpr int STEP = NT / NCH;              // rows between a thread's copies
    const int r0 = threadIdx.x / NCH, c = (threadIdx.x % NCH) * CH;
    if (STEP > BKV && r0 >= BKV) return;
    const T* src = base + (j0 + r0) * stride + c;
#pragma unroll
    for (int it = 0; it < (BKV + STEP - 1) / STEP; ++it) {
        const bool ok = j0 + r0 + it * STEP < skv;
        cp_async<BYTES>(dst + (r0 + it * STEP) * LD + c, ok ? src + it * STEP * stride : base,
                        ok);
    }
}

// Stage one K or V tile: 16- or 4-byte copies (mode), else plain loads
template <int D, int LD, int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* base, long long stride, int j0,
                                           int skv, int mode) {
    if (mode == 16) {
        copy_rows<16, D, LD, NT>(dst, base, stride, j0, skv);
    } else if (mode == 4) {
        copy_rows<4, D, LD, NT>(dst, base, stride, j0, skv);
    } else {
        for (int e = threadIdx.x; e < BKV * D; e += NT) {
            const int r = e / D, c = e % D;
            dst[r * LD + c] = j0 + r < skv ? base[(j0 + r) * stride + c] : zero<T>();
        }
    }
}

template <int D, typename T, int TM, int STAGES, int DSPLIT>
__global__ void __launch_bounds__(THREADS * DSPLIT, DSPLIT == 1 ? 2 : 1) fa_kernel(const Params p) {
    using C = Cfg<D, T, TM, STAGES, DSPLIT>;
    constexpr int BQ = C::BQ, LD = C::LD, PLD = C::PLD, NC = C::NC, NT = C::NT, DH = C::DH;
    extern __shared__ __align__(16) unsigned char smem[];
    float* Qt = reinterpret_cast<float*>(smem);                  // [D][BQ]
    T* ring = reinterpret_cast<T*>(smem + C::Q_BYTES);           // [STAGES][K|V][BKV][LD]
    // [DSPLIT][BKV][PLD]: each warp group's P^T (and, with DSPLIT 2, its
    // partial scores on their way to the other group)
    float* Pt_all = reinterpret_cast<float*>(smem + C::Q_BYTES + STAGES * C::KV_BYTES);

    // the tile: latest positions first, over every head tile and batch
    const int lin = blockIdx.x;
    const int ht = lin % p.n_head_tiles, rest = lin / p.n_head_tiles;
    const int b = rest % p.batch, pt = p.n_pos_tiles - 1 - rest / p.batch;
    const int npos = 1 << p.pos_shift;
    const int q0 = pt * npos, h0 = ht * p.heads_per_cta, hkv = h0 / p.group;
    const int q_hi = min(q0 + npos, p.sq) - 1;  // last real position of the tile
    const T* qp = static_cast<const T*>(p.q) + b * p.qs.b + h0 * p.qs.h;
    const T* kp = static_cast<const T*>(p.k) + b * p.ks.b + hkv * p.ks.h;
    const T* vp = static_cast<const T*>(p.v) + b * p.vs.b + hkv * p.vs.h;

    int kv_begin = 0, kv_end = p.skv;
    if (p.causal) kv_end = min(kv_end, q_hi + 1);
    if (p.window > 0) kv_begin = max(0, q0 - (p.window - 1)) / BKV * BKV;
    const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

    auto load_kv = [&](int t) {
        T* ks = ring + (t % STAGES) * 2 * BKV * LD;
        const int j0 = kv_begin + t * BKV;
        stage_rows<D, LD, NT>(ks, kp, p.ks.s, j0, p.skv, p.kv_mode);
        stage_rows<D, LD, NT>(ks + BKV * LD, vp, p.vs.s, j0, p.skv, p.kv_mode);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_tiles) load_kv(s);
        cp_async_commit();
    }

    // Q^T, fp32, while the first K/V tiles are in flight: every load is
    // issued before the first store; lanes take consecutive rows, so the
    // transposed stores hit distinct banks
    {
        constexpr int QIT = BQ * (D / 4) / NT;
        float4 x[QIT];
#pragma unroll
        for (int it = 0; it < QIT; ++it) {
            const int e = it * NT + threadIdx.x, i = e % BQ, d = (e / BQ) * 4;
            const int pos = q0 + (i & (npos - 1));
            const T* src = qp + (i >> p.pos_shift) * p.qs.h + pos * p.qs.s + d;
            x[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (pos < p.sq)
                x[it] = p.q_vec ? ld4(src)
                                : make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]),
                                              to_f(src[3]));
        }
#pragma unroll
        for (int it = 0; it < QIT; ++it) {
            const int e = it * NT + threadIdx.x, i = e % BQ, d = (e / BQ) * 4;
            Qt[(d + 0) * BQ + i] = x[it].x;
            Qt[(d + 1) * BQ + i] = x[it].y;
            Qt[(d + 2) * BQ + i] = x[it].z;
            Qt[(d + 3) * BQ + i] = x[it].w;
        }
    }

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rw = warp % WARPS, dg = warp / WARPS;  // row warp, warp group (d half)
    const int d0 = dg * DH;                          // the group's first d column
    const int ty = lane / 8, tx = lane % 8;
    const int rbase = rw * C::WR + ty * 4;  // row(r) = rbase + (r / 4) * 16 + r % 4
    auto row = [&](int r) { return rbase + (r / 4) * 16 + r % 4; };
    float* Pt = Pt_all + dg * C::P_FLOATS;  // [BKV][PLD], this group's
    // the partial score tile (TK keys x TM rows) through P^T's layout
    auto put_t = [&](float* dst, const float (&x)[TM][TK]) {
#pragma unroll
        for (int u = 0; u < TK; ++u)
#pragma unroll
            for (int g = 0; g < TM / 4; ++g)
                *reinterpret_cast<float4*>(&dst[(tx + 8 * u) * PLD + rbase + g * 16]) =
                    make_float4(x[4 * g][u], x[4 * g + 1][u], x[4 * g + 2][u], x[4 * g + 3][u]);
    };

    float m[TM], l[TM], acc[TM][NC];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.0f;
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[r][e] = 0.0f;
    }

    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
        __syncthreads();              // ... every thread's; tile t - 1's slot is free
        if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
        cp_async_commit();
        const T* ks = ring + (t % STAGES) * 2 * BKV * LD;
        const T* vs = ks + BKV * LD;

        // S = Q K^T: TM rows x keys tx + 8u
        float s[TM][TK];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int u = 0; u < TK; ++u) s[r][u] = 0.0f;
#pragma unroll(UNROLL_D)
        for (int dd0 = 0; dd0 < DH; dd0 += 4) {
            const int d = d0 + dd0;
            float4 kf[TK];
#pragma unroll
            for (int u = 0; u < TK; ++u) kf[u] = ld4(ks + (tx + 8 * u) * LD + d);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
                float qv[TM];
#pragma unroll
                for (int g = 0; g < TM / 4; ++g) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        &Qt[(d + dd) * BQ + rbase + g * 16]);
                    qv[4 * g] = x.x, qv[4 * g + 1] = x.y, qv[4 * g + 2] = x.z, qv[4 * g + 3] = x.w;
                }
#pragma unroll
                for (int u = 0; u < TK; ++u) {
                    const float kd = dd == 0 ? kf[u].x : dd == 1 ? kf[u].y : dd == 2 ? kf[u].z : kf[u].w;
#pragma unroll
                    for (int r = 0; r < TM; ++r) s[r][u] = fmaf(qv[r], kd, s[r][u]);
                }
            }
        }

        if constexpr (DSPLIT == 2) {
            // swap partial scores with the other group's warp of these rows:
            // own + other in both (addition commutes: the same bits)
            put_t(Pt, s);
            pair_sync(1 + rw);
            const float* other = Pt_all + (1 - dg) * C::P_FLOATS;
#pragma unroll
            for (int u = 0; u < TK; ++u)
#pragma unroll
                for (int g = 0; g < TM / 4; ++g) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        &other[(tx + 8 * u) * PLD + rbase + g * 16]);
                    s[4 * g][u] += x.x, s[4 * g + 1][u] += x.y;
                    s[4 * g + 2][u] += x.z, s[4 * g + 3][u] += x.w;
                }
            pair_sync(1 + rw);  // the other warp has read this one's partials
        }

        // online softmax; element masks only on a boundary tile
        const int j0 = kv_begin + t * BKV;
        const bool boundary = j0 + BKV > p.skv || (p.causal && j0 + BKV - 1 > q0) ||
                              (p.window > 0 && j0 <= q_hi - p.window);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            bool live[TK];
#pragma unroll
            for (int u = 0; u < TK; ++u) live[u] = true;
            if (boundary) {
                const int pos = q0 + (row(r) & (npos - 1));
#pragma unroll
                for (int u = 0; u < TK; ++u) {
                    const int key = j0 + tx + 8 * u;
                    live[u] = key < p.skv && (!p.causal || pos >= key) &&
                              (p.window <= 0 || key > pos - p.window);
                    if (!live[u]) s[r][u] = NEG_INF;
                }
            }
            float mx = s[r][0];
#pragma unroll
            for (int u = 1; u < TK; ++u) mx = fmaxf(mx, s[r][u]);
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            const float alpha = m[r] == NEG_INF ? 0.0f : exp2_ftz((m[r] - m_new) * p.c);
            const float mc = m_new * p.c;
            float sum = 0.0f;
#pragma unroll
            for (int u = 0; u < TK; ++u) {
                const float e = exp2_ftz(fmaf(s[r][u], p.c, -mc));
                s[r][u] = live[u] ? e : 0.0f;
                sum += s[r][u];
            }
            l[r] = fmaf(alpha, l[r], sum);
            m[r] = m_new;
#pragma unroll
            for (int e = 0; e < NC; ++e) acc[r][e] *= alpha;
        }

        // P^T for this warp's rows, then acc += P V over the group's columns
        put_t(Pt, s);
        __syncwarp();
#pragma unroll(UNROLL_J)
        for (int j = 0; j < BKV; ++j) {
            float pf[TM], vf[NC];
#pragma unroll
            for (int g = 0; g < TM / 4; ++g) {
                const float4 x = *reinterpret_cast<const float4*>(&Pt[j * PLD + rbase + g * 16]);
                pf[4 * g] = x.x, pf[4 * g + 1] = x.y, pf[4 * g + 2] = x.z, pf[4 * g + 3] = x.w;
            }
            const T* vrow = vs + j * LD + d0;
            if constexpr (NC >= 4) {
#pragma unroll
                for (int g = 0; g < NC / 4; ++g) {
                    const float4 x = ld4(vrow + g * 32 + tx * 4);
                    vf[4 * g] = x.x, vf[4 * g + 1] = x.y, vf[4 * g + 2] = x.z, vf[4 * g + 3] = x.w;
                }
            } else {
                const float2 x = ld2(vrow + tx * 2);
                vf[0] = x.x, vf[1] = x.y;
            }
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int e = 0; e < NC; ++e) acc[r][e] = fmaf(pf[r], vf[e], acc[r][e]);
        }
        __syncwarp();  // this warp's P reads are done before its next P writes
    }
    cp_async_wait<0>();

    T* op = static_cast<T*>(p.o) + b * p.os.b + h0 * p.os.h;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        float lr = l[r];
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) lr += __shfl_xor_sync(0xffffffffu, lr, off);
        const int i = row(r), pos = q0 + (i & (npos - 1));
        if (pos >= p.sq) continue;
        const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);
        T* dst = op + (i >> p.pos_shift) * p.os.h + pos * p.os.s;
#pragma unroll
        for (int e = 0; e < NC; ++e) {
            const int col = d0 + (NC >= 4 ? (e / 4) * 32 + tx * 4 + e % 4 : tx * NC + e);
            store(&dst[col], acc[r][e] * inv);
        }
    }
}

template <int D, typename T, int TM, int STAGES, int DSPLIT>
int launch(const Params& p, int n_ctas, cudaStream_t stream) {
    using C = Cfg<D, T, TM, STAGES, DSPLIT>;
    auto kernel = fa_kernel<D, T, TM, STAGES, DSPLIT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_ctas, C::NT, C::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

// The query tiles: 128 rows (D <= 64, 3 stages) and 64 rows (2 stages); at
// D 256 only the 64-row tile, its d axis split over two warp groups.
template <int D, typename T>
int launch_rows(int rows, const Params& p, int n_ctas, cudaStream_t stream) {
    if constexpr (D > 128) {
        if (rows != SMALL_ROWS) return (int)cudaErrorInvalidValue;
        return launch<D, T, SMALL_TM, 2, 2>(p, n_ctas, stream);
    } else {
        if (rows == BIG_ROWS) {
            if constexpr (D <= 64) return launch<D, T, BIG_TM, 3, 1>(p, n_ctas, stream);
            return (int)cudaErrorInvalidValue;
        }
        return launch<D, T, SMALL_TM, 2, 1>(p, n_ctas, stream);
    }
}

template <typename T>
int launch_d(int head_dim, int rows, const Params& p, int n_ctas, cudaStream_t stream) {
    switch (head_dim) {
        case 16: return launch_rows<16, T>(rows, p, n_ctas, stream);
        case 32: return launch_rows<32, T>(rows, p, n_ctas, stream);
        case 64: return launch_rows<64, T>(rows, p, n_ctas, stream);
        case 128: return launch_rows<128, T>(rows, p, n_ctas, stream);
        case 256: return launch_rows<256, T>(rows, p, n_ctas, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

bool aligned(const void* ptr, const Strides& s, int elem, int bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && (s.b * elem) % bytes == 0 &&
           (s.h * elem) % bytes == 0 && (s.s * elem) % bytes == 0;
}

int copy_mode(const void* ptr, const Strides& s, int elem) {
    return aligned(ptr, s, elem, 16) ? 16 : aligned(ptr, s, elem, 4) ? 4 : 0;
}

}  // namespace

extern "C" {

// [rows of the big tile, rows of the small tile, MAX_HEADS_PER_CTA], which
// the Python wrapper plans the query tiles with and checks (D 256 takes the
// small tile only)
void flash_attention_config(int* out) {
    out[0] = BIG_ROWS;
    out[1] = SMALL_ROWS;
    out[2] = MAX_HEADS_PER_CTA;
}

// q (B, H, Sq, D), k/v (B, HKV, Skv, D), out (B, H, Sq, D): element strides
// of the (b, h, s) axes, D contiguous.  window <= 0 means no window.  The
// tile plan: `rows` query rows per CTA (128, or 64; 64 at D 128) made of
// `heads_per_cta` heads of one kv group (a power of two dividing the group,
// at most 8) at rows / heads_per_cta positions each.  head_dim: 16, 32, 64,
// 128 or 256.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int batch,
                           int n_heads, int n_kv_heads, int sq, int skv, int head_dim,
                           int is_bf16, long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, int window, float scale, int rows,
                           int heads_per_cta, void* stream) {
    if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || sq <= 0 || batch <= 0 || skv < 0)
        return (int)cudaErrorInvalidValue;
    const int group = n_heads / n_kv_heads, hpc = heads_per_cta;
    if ((rows != BIG_ROWS && rows != SMALL_ROWS) || hpc < 1 || hpc > MAX_HEADS_PER_CTA ||
        (hpc & (hpc - 1)) || group % hpc != 0)
        return (int)cudaErrorInvalidValue;
    const int elem = is_bf16 ? 2 : 4;
    Params p;
    p.q = q, p.k = k, p.v = v, p.o = o;
    p.qs = {q_sb, q_sh, q_ss}, p.ks = {k_sb, k_sh, k_ss}, p.vs = {v_sb, v_sh, v_ss};
    p.os = {o_sb, o_sh, o_ss};
    p.batch = batch, p.group = group, p.sq = sq, p.skv = skv, p.causal = causal;
    p.window = window;
    p.heads_per_cta = hpc;
    const int npos = rows / hpc;
    p.pos_shift = 0;
    while ((1 << p.pos_shift) < npos) ++p.pos_shift;
    p.n_head_tiles = n_heads / hpc;
    p.n_pos_tiles = (sq + npos - 1) / npos;
    p.q_vec = copy_mode(q, p.qs, elem) == 16;
    const int km = copy_mode(k, p.ks, elem), vm = copy_mode(v, p.vs, elem);
    p.kv_mode = km < vm ? km : vm;
    p.c = scale * LOG2E;
    const long long n_ctas = (long long)p.n_pos_tiles * p.n_head_tiles * batch;
    if (n_ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16) return launch_d<__nv_bfloat16>(head_dim, rows, p, (int)n_ctas, st);
    return launch_d<float>(head_dim, rows, p, (int)n_ctas, st);
}

}  // extern "C"
