// Mamba-2 SSD (state-space duality) chunked scan, with the final state.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` / `_ssd_kernel`
// (repro/kernels/ssd_scan/ssd_kernel.py:71).  Per head (state N, head dim P)
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T      (N x P)
//   y_t = C_t h_t
// evaluated chunkwise over L = 128 steps, B/C grouped G -> H (head h reads
// group h / (H / G)).  It also returns the final (N, P) state, as the
// reference's chunked jnp form does for the prefill -> decode cache handoff
// (repro/kernels/ssd_scan/ops.py:24-82); the Pallas kernel keeps that state
// in scratch and drops it.
//
// Design.  The Pallas grid (B, H, S/L) walks the chunks of one (b, h) in
// order and carries the state in VMEM; on 132 SMs that would be 48 CTAs for
// a batch-1 mamba2-780m prefill.  So the scan is the chunked decomposition
// of the Mamba-2 authors' own kernels, four kernels in stream order, each
// with a plain version in kernels/ssd_scan/ref.py:
//   1. ssd_chunk_scores_kernel, per (b, chunk, group, 16-row tile):
//      cb[t, j] = C_t . B_j for j <= t, once per GROUP (it does not depend
//      on the head: the first design computed it 48 times), into a
//      (B, NC, G, L, L) workspace that stays in L2; the tile's C rows and
//      the live B rows are staged whole in one round of loads;
//   2. ssd_chunk_state_kernel, per (b, chunk, head, 128-row tile of N): the
//      chunk's cumulative log decay cum (a warp scan of dt * a, written out
//      for stages 3 and 4) and its own state
//      sum_j B_j exp(cum_L - cum_j) dt_j x_j^T;
//   3. ssd_state_passing_kernel, one thread per 4 state elements of a
//      (b, head): h = h * exp(cum_L) + state_c in chunk order, the loads of
//      the next chunks issued ahead; writes the state entering each chunk
//      and the final state;
//   4. ssd_chunk_scan_kernel, per (b, chunk, head):
//      y = exp(cum_t) C_t h_prev + sum_{j <= t} cb[t, j] exp(cum_t - cum_j)
//      dt_j x_j, written once in x's type (the first design round-tripped
//      an fp32 y through device memory between two kernels).
// Stages 2 and 4 are fp32 GEMMs of K = 128 (and K = N for C h_prev) on the
// CUDA cores: a CTA of 128 threads owns a 128 x P output tile, 8 rows x
// P / 8 columns per thread read from shared memory as float4 fragments, and
// stages its operands in KS-deep slabs, double buffered: the next slab's
// global loads are in registers while the current one is multiplied, one
// barrier per slab, about 25 KB of shared memory, so three CTAs share an
// SM (the first design held one 134 KB CTA per SM); the first slab's loads
// are issued before the decays are read.  Stage 4 loads its C and score
// slabs coalesced along k and stores them transposed, and warp w, which
// owns rows 32w..32w+31, skips the score slabs right of them.  TF32 stays
// off: the products are fp32 FMAs.
//
// The exponent is masked, not the exp (ssd_kernel.py:52-55): j > t gives
// exp(-inf) = 0, never inf * 0.  Steps at t >= S read as dt = x = B = C = 0,
// the reference's zero padding: they decay by exp(0) = 1 and add nothing,
// so the final state is exactly the state at step S.  x, B, C and dt are
// read through (b, s, head | group) strides with the last axis contiguous;
// bf16 inputs are up-cast on load.
//
// What bounds it on the H100: at mamba2-780m's prefill (S 2000 in 16
// chunks, H 48, P 64, N 128, G 1) the function needs C B^T once per group
// over the live (t, j <= t) pairs, and per head the masked scores @ x, the
// chunk state and C h_prev: 3.96 GFLOP over the 2000 real steps on 53 MB of
// fp32 x, B, C, dt, y and state, so bound by operations, 59 us at 67 TFLOP/s
// of fp32 FMAs (chip_smoke.py computes it).  The chunk states and the
// states entering each chunk (25 MB each) go through device memory between
// stages 2, 3 and 4; they fit in the 50 MB L2.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int L = 128;        // chunk length (the reference's CHUNK)
constexpr int THREADS = 128;  // every CTA
constexpr int KS = 16;        // slab depth staged per pass in stages 2 and 4
constexpr int ROWS = 128;     // output rows of a stage-2 / stage-4 CTA
constexpr int APAD = ROWS + 4;  // stage 4's transposed slab rows: 2-way store conflicts at most
constexpr int TR1 = 16;       // score rows of a stage-1 CTA
constexpr int PASS_UNROLL = 8;
constexpr int LOAD_BATCH = 32;  // stage 1's loads in flight per thread

struct Strides {
    long long b, s, h;  // batch, step, head (x, dt) or group (B, C)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
}

// cum[t] = inclusive cumsum of dt[t] * a over the chunk, by warp 0 (4 steps
// per lane); dts[t] = dt[t], zero past S.  The caller synchronises.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt, Strides dts, int b,
                                             int h, int t0, int s_len, float ah, float* cum,
                                             float* dtv) {
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    float d[4], v[4], run = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int t = t0 + 4 * lane + q;
        d[q] = t < s_len ? dt[b * dts.b + t * dts.s + h * dts.h] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        run += d[q] * ah;
        v[q] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        cum[4 * lane + q] = excl + v[q];
        dtv[4 * lane + q] = d[q];
    }
}

// acc[i][q] += sum_k A[k][r0 + i] * Bm[k][col(q)] over one KS-deep slab.
// A is (KS, LDA) and Bm (KS, P) in shared memory; a thread owns rows
// r0..r0+7 and columns 4tc..4tc+3 (and 32+4tc.. when P = 64), so a warp's
// float4 reads hit distinct banks.
template <int P, int LDA>
__device__ __forceinline__ void slab_fma(float (&acc)[8][P / 8], const float* __restrict__ A,
                                         const float* __restrict__ Bm, int r0, int tc) {
    constexpr int TP = P / 8;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + k * LDA + r0);
        const float4 a1 = *reinterpret_cast<const float4*>(A + k * LDA + r0 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[TP];
#pragma unroll
        for (int q4 = 0; q4 < TP / 4; ++q4) {
            const float4 b4 = *reinterpret_cast<const float4*>(Bm + k * P + 32 * q4 + 4 * tc);
            bv[4 * q4] = b4.x, bv[4 * q4 + 1] = b4.y, bv[4 * q4 + 2] = b4.z, bv[4 * q4 + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int q = 0; q < TP; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
}

// -- stage 1 -------------------------------------------------------------------

// cb (B, NC, G, L, L): rows [16 rt, 16 rt + 16) of one (b, chunk, group),
// zero above the diagonal.  The CTA stages its 16 rows of C and the live
// rows j < 16 (rt + 1) of B whole, (row, N + 1) in dynamic shared memory:
// a warp loads rows, its lanes KQ = ceil(N / 32) elements of each, coalesced
// along N with LOAD_BATCH loads in flight per thread and no integer
// division.  Then a thread owns 4 rows x the columns lane + 32 q: the B
// reads of a warp hit 32 banks, the C reads broadcast.
template <int KQ, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scores_kernel(const T* __restrict__ bm, const T* __restrict__ cm, int s_len, int n,
                        Strides bs, Strides cs, float* __restrict__ cb) {
    constexpr int WARPS = THREADS / 32, RR = LOAD_BATCH / KQ;  // rows per warp per round
    extern __shared__ float smem1[];
    const int ld = n + 1;
    float* Bs = smem1;              // (jn, n + 1)
    float* Cs = smem1 + L * ld;     // (TR1, n + 1)
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int chunk = blockIdx.x, rt = blockIdx.y % (L / TR1), g = blockIdx.y / (L / TR1);
    const int b = blockIdx.z, t0 = chunk * L, r0 = rt * TR1, jn = r0 + TR1;
    const T* bp = bm + b * bs.b + g * bs.h;
    const T* cp = cm + b * cs.b + g * cs.h;
    const int rows = jn + TR1;  // B rows 0..jn-1, then the tile's C rows
    for (int base = 0; base < rows; base += RR * WARPS) {
        float v[RR][KQ];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
            const int row = base + rr * WARPS + warp;
            const bool is_b = row < jn;
            const int t = t0 + (is_b ? row : r0 + row - jn);
            const T* src = is_b ? bp + t * bs.s : cp + t * cs.s;
#pragma unroll
            for (int kq = 0; kq < KQ; ++kq) {
                const int k = lane + 32 * kq;
                v[rr][kq] = row < rows && t < s_len && k < n ? to_f(src[k]) : 0.0f;
            }
        }
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
            const int row = base + rr * WARPS + warp;
            if (row < rows) {
                float* dst = row < jn ? Bs + row * ld : Cs + (row - jn) * ld;
#pragma unroll
                for (int kq = 0; kq < KQ; ++kq)
                    if (lane + 32 * kq < n) dst[lane + 32 * kq] = v[rr][kq];
            }
        }
    }
    __syncthreads();
    const int tr = warp;  // rows 4 tr .. 4 tr + 3 of the tile
    const int nq = (jn + 31) / 32;  // column blocks of 32 with a live column
    float acc[4][4] = {};
    for (int k = 0; k < n; ++k) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(4 * tr + i) * ld + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q < nq) {
                const float bv = Bs[(lane + 32 * q) * ld + k];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(cv[i], bv, acc[i][q]);
            }
        }
    }
    const long long tile = ((long long)b * gridDim.x + chunk) * (gridDim.y / (L / TR1)) + g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = r0 + 4 * tr + i;
        float* row = cb + (tile * L + t) * L;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = lane + 32 * q;
            row[j] = j <= t ? acc[i][q] : 0.0f;
        }
    }
}

// -- stage 2 -------------------------------------------------------------------

// chunk_state (B, NC, H, N, P) rows [n0, n0 + 128) of one (b, chunk, head),
// and cum (B, NC, H, L) from the CTAs of the first row tile.
template <int P, typename T>
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm, int s_len,
                       int group, int n, Strides xs, Strides dts, Strides bs,
                       float* __restrict__ chunk_state, float* __restrict__ cum_out) {
    constexpr int TP = P / 8, XR = KS * P / THREADS, BR = KS * ROWS / THREADS;
    __shared__ __align__(16) float As[2][KS * ROWS];  // B slab, [step][state row]
    __shared__ __align__(16) float Xs[2][KS * P];     // w_j x_j slab, [step][column]
    __shared__ float cum[L], dtv[L], w[L];
    const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
    const int n_tiles = (n + ROWS - 1) / ROWS;
    const int chunk = blockIdx.x, h = blockIdx.y / n_tiles, nt = blockIdx.y % n_tiles;
    const int b = blockIdx.z, g = h / group, t0 = chunk * L, n0 = nt * ROWS;
    const int n_chunks = gridDim.x, n_heads = gridDim.y / n_tiles;
    const long long bch = ((long long)b * n_chunks + chunk) * n_heads + h;

    const T* bp = bm + b * bs.b + g * bs.h;
    const T* xp = x + b * xs.b + h * xs.h;
    float rb[BR], rx[XR];
    auto load = [&](int j0) {  // slab j0's operands into registers
#pragma unroll
        for (int r = 0; r < BR; ++r) {
            const int e = tid + r * THREADS, k = e / ROWS, nn = n0 + e % ROWS, t = t0 + j0 + k;
            rb[r] = t < s_len && nn < n ? to_f(bp[t * bs.s + nn]) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < XR; ++r) {
            const int e = tid + r * THREADS, k = e / P, t = t0 + j0 + k;
            rx[r] = t < s_len ? to_f(xp[t * xs.s + e % P]) : 0.0f;
        }
    };
    auto stage = [&](int buf, int j0) {  // registers into shared slab buf
#pragma unroll
        for (int r = 0; r < BR; ++r) As[buf][tid + r * THREADS] = rb[r];
#pragma unroll
        for (int r = 0; r < XR; ++r) {
            const int e = tid + r * THREADS;
            Xs[buf][e] = rx[r] * w[j0 + e / P];
        }
    };

    float acc[8][TP] = {};
    load(0);  // in flight while the decays are scanned
    chunk_cumsum(dt, dts, b, h, t0, s_len, a[h], cum, dtv);
    __syncthreads();
    for (int t = tid; t < L; t += THREADS) {
        w[t] = expf(cum[L - 1] - cum[t]) * dtv[t];
        if (nt == 0) cum_out[bch * L + t] = cum[t];
    }
    __syncthreads();
    stage(0, 0);
    __syncthreads();
    constexpr int NS = L / KS;
    for (int s = 0; s < NS; ++s) {
        if (s + 1 < NS) load((s + 1) * KS);
        slab_fma<P, ROWS>(acc, As[s & 1], Xs[s & 1], 8 * tr, tc);
        if (s + 1 < NS) stage((s + 1) & 1, (s + 1) * KS);
        __syncthreads();
    }
    float* st = chunk_state + bch * n * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int nn = n0 + 8 * tr + i;
        if (nn < n) {
#pragma unroll
            for (int q4 = 0; q4 < TP / 4; ++q4) {
                const float v[4] = {acc[i][4 * q4], acc[i][4 * q4 + 1], acc[i][4 * q4 + 2],
                                    acc[i][4 * q4 + 3]};
                store4(st + (long long)nn * P + 32 * q4 + 4 * tc, v);
            }
        }
    }
}

// -- stage 3 -------------------------------------------------------------------

// One thread per 4 elements of a (b, head)'s (N, P) state: h_prev[c] = h,
// h = h * exp(cum[c][L - 1]) + chunk_state[c], in chunk order.
__global__ void __launch_bounds__(THREADS)
ssd_state_passing_kernel(const float* __restrict__ chunk_state, const float* __restrict__ cum,
                         int n_chunks, int n_heads, int np4, long long total4,
                         float* __restrict__ h_prev, float* __restrict__ final_state) {
    const long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (idx >= total4) return;
    const long long bh = idx / np4;
    const int e = (int)(idx % np4), h = (int)(bh % n_heads);
    const long long b = bh / n_heads;
    const float4* src = reinterpret_cast<const float4*>(chunk_state);
    float4* dst = reinterpret_cast<float4*>(h_prev);
    float4 hc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < n_chunks; c0 += PASS_UNROLL) {
        float4 v[PASS_UNROLL];
        float d[PASS_UNROLL];
#pragma unroll
        for (int u = 0; u < PASS_UNROLL; ++u) {
            if (c0 + u < n_chunks) {
                const long long bch = (b * n_chunks + c0 + u) * n_heads + h;
                v[u] = src[bch * np4 + e];
                d[u] = expf(cum[bch * L + L - 1]);
            }
        }
#pragma unroll
        for (int u = 0; u < PASS_UNROLL; ++u) {
            if (c0 + u < n_chunks) {
                const long long bch = (b * n_chunks + c0 + u) * n_heads + h;
                dst[bch * np4 + e] = hc;
                hc.x = hc.x * d[u] + v[u].x;
                hc.y = hc.y * d[u] + v[u].y;
                hc.z = hc.z * d[u] + v[u].z;
                hc.w = hc.w * d[u] + v[u].w;
            }
        }
    }
    reinterpret_cast<float4*>(final_state)[idx] = hc;
}

// -- stage 4 -------------------------------------------------------------------

// y rows of one (b, chunk, head).  Slabs 0..NA-1 run C h_prev over the
// state (K = N), slabs NA.. the masked scores @ x over the steps (K = L).
// The A slab is staged transposed, [k][row] with rows padded to APAD: a
// thread loads element k = tid % 16 of rows tid / 16 + 8 r, so a warp reads
// two rows' 16 contiguous values at a time.
template <int P, typename T>
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ cm, const float* __restrict__ cb,
                      const float* __restrict__ cum_in, const float* __restrict__ h_prev,
                      int s_len, int group, int n, Strides xs, Strides dts, Strides cs,
                      T* __restrict__ y) {
    constexpr int TP = P / 8, XR = KS * P / THREADS, AR = KS * ROWS / THREADS;
    __shared__ __align__(16) float As[2][KS * APAD];  // C^T or masked-score^T slab, [k][row]
    __shared__ __align__(16) float Bs[2][KS * P];     // h_prev or x slab, [k][column]
    __shared__ float cum[L], dtv[L];
    const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8, warp = tid / 32;
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / group;
    const int n_chunks = gridDim.x, n_heads = gridDim.y, n_groups = n_heads / group;
    const int t0 = chunk * L;
    const long long bch = ((long long)b * n_chunks + chunk) * n_heads + h;

    const int na = (n + KS - 1) / KS, ns = na + L / KS;
    const T* cp = cm + b * cs.b + g * cs.h;
    const T* xp = x + b * xs.b + h * xs.h;
    const float* hp = h_prev + bch * n * P;
    const float* cbt = cb + (((long long)b * n_chunks + chunk) * n_groups + g) * L * L;
    const int ka = tid % KS, ta = tid / KS;  // this thread's A element: k, and its first row
    float ra[AR], rb[XR];
    auto load = [&](int s) {
        if (s < na) {
            const int k = s * KS + ka;
#pragma unroll
            for (int r = 0; r < AR; ++r) {
                const int t = t0 + ta + r * (THREADS / KS);
                ra[r] = t < s_len && k < n ? to_f(cp[t * cs.s + k]) : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < XR; ++r) {
                const int e = tid + r * THREADS, kk = s * KS + e / P;
                rb[r] = kk < n ? hp[(long long)kk * P + e % P] : 0.0f;
            }
        } else {
            const int j0 = (s - na) * KS;
#pragma unroll
            for (int r = 0; r < AR; ++r) {
                const int t = ta + r * (THREADS / KS);
                ra[r] = t >= j0 ? cbt[t * L + j0 + ka] : 0.0f;  // rows t < j0: all masked
            }
#pragma unroll
            for (int r = 0; r < XR; ++r) {
                const int e = tid + r * THREADS, t = t0 + j0 + e / P;
                rb[r] = t < s_len ? to_f(xp[t * xs.s + e % P]) : 0.0f;
            }
        }
    };
    auto stage = [&](int buf, int s) {
        float* A = As[buf] + ka * APAD;
        if (s < na) {
#pragma unroll
            for (int r = 0; r < AR; ++r) A[ta + r * (THREADS / KS)] = ra[r];
        } else {
            const int j = (s - na) * KS + ka;
            const float cj = cum[j], dj = dtv[j];
#pragma unroll
            for (int r = 0; r < AR; ++r) {
                const int t = ta + r * (THREADS / KS);
                // the exponent is masked before the exp: j > t gives exp(-inf) = 0
                A[t] = ra[r] * expf(j <= t ? cum[t] - cj : -CUDART_INF_F) * dj;
            }
        }
#pragma unroll
        for (int r = 0; r < XR; ++r) Bs[buf][tid + r * THREADS] = rb[r];
    };

    load(0);  // in flight while the decays load
    for (int t = tid; t < L; t += THREADS) {
        cum[t] = cum_in[bch * L + t];
        dtv[t] = t0 + t < s_len ? dt[b * dts.b + (t0 + t) * dts.s + h * dts.h] : 0.0f;
    }
    stage(0, 0);  // a C h_prev slab: reads no decays
    __syncthreads();
    float acc[8][TP] = {};
    for (int s = 0; s < ns; ++s) {
        if (s + 1 < ns) load(s + 1);
        if (s == na) {  // C h_prev done: scale each row by exp(cum_t)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float ec = expf(cum[8 * tr + i]);
#pragma unroll
                for (int q = 0; q < TP; ++q) acc[i][q] *= ec;
            }
        }
        // warp w owns rows 32w..32w+31: score slabs right of them are empty
        if (s < na || (s - na) * KS <= 32 * warp + 31)
            slab_fma<P, APAD>(acc, As[s & 1], Bs[s & 1], 8 * tr, tc);
        if (s + 1 < ns) stage((s + 1) & 1, s + 1);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int t = t0 + 8 * tr + i;
        if (t < s_len) {
            T* row = y + (((long long)b * s_len + t) * n_heads + h) * P;
#pragma unroll
            for (int q4 = 0; q4 < TP / 4; ++q4) {
                const float v[4] = {acc[i][4 * q4], acc[i][4 * q4 + 1], acc[i][4 * q4 + 2],
                                    acc[i][4 * q4 + 3]};
                store4(row + 32 * q4 + 4 * tc, v);
            }
        }
    }
}

template <int KQ, typename T>
int scores(const void* bm, const void* cm, int batch, int s_len, int n_groups, int n, Strides bs,
           Strides cs, float* cb, cudaStream_t stream) {
    const int n_chunks = (s_len + L - 1) / L;
    const int smem = (L + TR1) * (n + 1) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scores_kernel<KQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_scores_kernel<KQ, T><<<dim3(n_chunks, n_groups * (L / TR1), batch), THREADS, smem,
                                     stream>>>(static_cast<const T*>(bm),
                                               static_cast<const T*>(cm), s_len, n, bs, cs, cb);
    return (int)cudaGetLastError();
}

template <typename T>
int scores_n(const void* bm, const void* cm, int batch, int s_len, int n_groups, int n,
             Strides bs, Strides cs, float* cb, cudaStream_t stream) {
    if (n <= 32) return scores<1, T>(bm, cm, batch, s_len, n_groups, n, bs, cs, cb, stream);
    if (n <= 64) return scores<2, T>(bm, cm, batch, s_len, n_groups, n, bs, cs, cb, stream);
    if (n <= 128) return scores<4, T>(bm, cm, batch, s_len, n_groups, n, bs, cs, cb, stream);
    return scores<8, T>(bm, cm, batch, s_len, n_groups, n, bs, cs, cb, stream);
}

template <int P, typename T>
int state(const void* x, const float* dt, const float* a, const void* bm, int batch, int s_len,
          int n_heads, int n_groups, int n, Strides xs, Strides dts, Strides bs,
          float* chunk_state, float* cum, cudaStream_t stream) {
    const int n_chunks = (s_len + L - 1) / L, n_tiles = (n + ROWS - 1) / ROWS;
    ssd_chunk_state_kernel<P, T><<<dim3(n_chunks, n_heads * n_tiles, batch), THREADS, 0,
                                   stream>>>(static_cast<const T*>(x), dt, a,
                                             static_cast<const T*>(bm), s_len,
                                             n_heads / n_groups, n, xs, dts, bs, chunk_state,
                                             cum);
    return (int)cudaGetLastError();
}

template <int P, typename T>
int scan(const void* x, const float* dt, const void* cm, const float* cb, const float* cum,
         const float* h_prev, int batch, int s_len, int n_heads, int n_groups, int n, Strides xs,
         Strides dts, Strides cs, void* y, cudaStream_t stream) {
    const int n_chunks = (s_len + L - 1) / L;
    ssd_chunk_scan_kernel<P, T><<<dim3(n_chunks, n_heads, batch), THREADS, 0, stream>>>(
        static_cast<const T*>(x), dt, static_cast<const T*>(cm), cb, cum, h_prev, s_len,
        n_heads / n_groups, n, xs, dts, cs, static_cast<T*>(y));
    return (int)cudaGetLastError();
}

bool bad_shape(int batch, int s_len, int n_heads, int n_groups, int n) {
    return batch <= 0 || s_len <= 0 || n_groups <= 0 || n_heads % n_groups != 0 || n <= 0 ||
           n > 256;
}

}  // namespace

extern "C" {

// Stage 1.  b/c (B, S, G, N) in fp32 or bf16 through element strides of
// their (b, s, group) axes, the last axis contiguous; cb (B, NC, G, L, L)
// fp32 contiguous.
int ssd_chunk_scores_launch(const void* bm, const void* cm, int is_bf16, int batch, int s_len,
                            int n_groups, int d_state, long long b_sb, long long b_ss,
                            long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                            float* cb, void* stream) {
    if (bad_shape(batch, s_len, n_groups, n_groups, d_state)) return (int)cudaErrorInvalidValue;
    const Strides bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16
               ? scores_n<__nv_bfloat16>(bm, cm, batch, s_len, n_groups, d_state, bs, cs, cb, st)
               : scores_n<float>(bm, cm, batch, s_len, n_groups, d_state, bs, cs, cb, st);
}

// Stage 2.  x (B, S, H, P) and b (B, S, G, N) in fp32 or bf16, dt (B, S, H)
// and a (H,) fp32, through element strides as above; chunk_state
// (B, NC, H, N, P) and cum (B, NC, H, L) fp32 contiguous.
int ssd_chunk_state_launch(const void* x, const float* dt, const float* a, const void* bm,
                           int is_bf16, int batch, int s_len, int n_heads, int head_dim,
                           int n_groups, int d_state, long long x_sb, long long x_ss,
                           long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                           long long b_sb, long long b_ss, long long b_sg, float* chunk_state,
                           float* cum, void* stream) {
    if (bad_shape(batch, s_len, n_heads, n_groups, d_state)) return (int)cudaErrorInvalidValue;
    const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, b_sg};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_STATE(P, T) \
    state<P, T>(x, dt, a, bm, batch, s_len, n_heads, n_groups, d_state, xs, dts, bs, chunk_state, \
                cum, st)
    if (head_dim == 64) return is_bf16 ? SSD_STATE(64, __nv_bfloat16) : SSD_STATE(64, float);
    if (head_dim == 32) return is_bf16 ? SSD_STATE(32, __nv_bfloat16) : SSD_STATE(32, float);
#undef SSD_STATE
    return (int)cudaErrorInvalidValue;
}

// Stage 3.  chunk_state and h_prev (B, NC, H, N, P), cum (B, NC, H, L),
// final_state (B, H, N, P), all fp32 contiguous; np = N * P.
int ssd_state_passing_launch(const float* chunk_state, const float* cum, int batch, int n_chunks,
                             int n_heads, int np, float* h_prev, float* final_state,
                             void* stream) {
    if (batch <= 0 || n_chunks <= 0 || n_heads <= 0 || np <= 0 || np % 4 != 0)
        return (int)cudaErrorInvalidValue;
    const long long total4 = (long long)batch * n_heads * (np / 4);
    ssd_state_passing_kernel<<<(unsigned)((total4 + THREADS - 1) / THREADS), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        chunk_state, cum, n_chunks, n_heads, np / 4, total4, h_prev, final_state);
    return (int)cudaGetLastError();
}

// Stage 4.  x (B, S, H, P) and c (B, S, G, N) in fp32 or bf16, dt (B, S, H)
// fp32, through element strides as above; cb, cum and h_prev as stages 1-3
// write them; y (B, S, H, P) contiguous in x's type.
int ssd_chunk_scan_launch(const void* x, const float* dt, const void* cm, const float* cb,
                          const float* cum, const float* h_prev, int is_bf16, int batch,
                          int s_len, int n_heads, int head_dim, int n_groups, int d_state,
                          long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                          long long dt_ss, long long dt_sh, long long c_sb, long long c_ss,
                          long long c_sg, void* y, void* stream) {
    if (bad_shape(batch, s_len, n_heads, n_groups, d_state)) return (int)cudaErrorInvalidValue;
    const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, cs{c_sb, c_ss, c_sg};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_SCAN(P, T) \
    scan<P, T>(x, dt, cm, cb, cum, h_prev, batch, s_len, n_heads, n_groups, d_state, xs, dts, cs, \
               y, st)
    if (head_dim == 64) return is_bf16 ? SSD_SCAN(64, __nv_bfloat16) : SSD_SCAN(64, float);
    if (head_dim == 32) return is_bf16 ? SSD_SCAN(32, __nv_bfloat16) : SSD_SCAN(32, float);
#undef SSD_SCAN
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
