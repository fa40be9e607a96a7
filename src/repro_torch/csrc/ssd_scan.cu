// Mamba-2 SSD (state-space duality) chunked scan, with the final state.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` / `_ssd_kernel`
// (repro/kernels/ssd_scan/ssd_kernel.py:71).  Per head (state N, head dim P)
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T      (N x P)
//   y_t = C_t h_t
// evaluated chunkwise over 128 steps, B/C grouped G -> H (head h reads group
// h / (H / G)).  It also returns the final (N, P) state, as the reference's
// chunked jnp form does for the prefill -> decode cache handoff
// (repro/kernels/ssd_scan/ops.py:24-82); the Pallas kernel keeps that state
// in scratch and drops it.
//
// Design.  The Pallas grid (B, H, S/128) walks the chunks of one (b, h) in
// order and carries the state in VMEM.  Here that would be one CTA per
// (b, h): 48 CTAs for a batch-1 mamba2-780m prefill on 132 SMs.  So the
// chunked jnp form's three stages are three kernels:
//   1. ssd_chunk_kernel, one CTA per (b, chunk, h): the cumulative log
//      decay cum, the intra-chunk y = (C B^T * exp(cum_t - cum_j) * dt_j,
//      j <= t) @ x, the chunk's own state sum_j B_j exp(cum_L - cum_j) dt_j
//      x_j^T and its decay exp(cum_L);
//   2. ssd_state_scan_kernel, one thread per (b, h, n, p): the in-order
//      scan h = h * decay_c + state_c over the chunks, which leaves the
//      state entering each chunk in place of the chunk's state and writes
//      the final state;
//   3. ssd_inter_kernel, one CTA per (b, chunk, h): y += exp(cum_t) C_t h_prev.
// The exponent is masked, not the exp (ssd_kernel.py:52-55): j > t gives 0,
// never inf * 0.  A (128, 128) score tile with fp32 B, C and x tiles does not
// fit in shared memory, so stage 1 tiles the score matrix by 32 rows and
// skips the column blocks above the diagonal.  Steps at t >= S read as
// dt = x = B = C = 0, the reference's zero padding: they decay by exp(0) = 1
// and add nothing, so the final state is exactly the state at step S.
// x, B, C and dt are read through (b, s, head/group) strides with the last
// axis contiguous; bf16 inputs are up-cast on load.
//
// What bounds it on the H100: at mamba2-780m's prefill (S 2000 in 16
// chunks, H 48, P 64, N 128, G 1) the function needs C B^T once per group
// over the live (t, j <= t) pairs, and per head the masked scores @ x, the
// chunk state and C h_prev: 3.96 GFLOP over the 2000 real steps on 53 MB
// of fp32 x, B, C, dt, y and state, so bound by operations, 59 us at
// 67 TFLOP/s of fp32 FMAs (chip_smoke.py computes it).  This first
// version runs fp32 FMAs from shared memory with one CTA per SM in stage 1
// (134 KB of shared memory), computes the C B^T scores once per head although they
// depend only on the group, and round-trips the chunk states through
// device memory (25 MB each way); those are the next steps.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 128;      // chunk length (the reference's CHUNK)
constexpr int TR = 32;      // score-tile rows in stage 1
constexpr int THREADS = 256;

struct Strides {
    long long b, s, h;  // batch, step, head (x, dt) or group (B, C)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__host__ __device__ constexpr int chunk_smem_floats(int n, int p) {
    return L * (n + 1) + L * (p + 1) + TR * (n + 1) + TR * (L + 1) + 3 * L;
}

__host__ __device__ constexpr int inter_smem_floats(int n, int p) { return L * (n + 1) + n * p; }

// rows [0, L) of a (b, s, g|h) strided operand at step offset t0, zero past S
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, Strides st, int b,
                                          int head, int t0, int rows, int cols, int s_len) {
    const T* base = src + b * st.b + head * st.h;
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
        const int r = e / cols, c = e % cols, t = t0 + r;
        dst[r * ld + c] = t < s_len ? to_f(base[t * st.s + c]) : 0.0f;
    }
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, int s_len, int group, int n, Strides xs, Strides dts,
                 Strides bs, Strides cs, float* __restrict__ y_acc, float* __restrict__ cum_out,
                 float* __restrict__ decay_out, float* __restrict__ state_out) {
    constexpr int PE = P / 32;  // output columns per thread
    extern __shared__ float4 smem4[];
    float* Bs = reinterpret_cast<float*>(smem4);  // (L, n + 1)
    float* Xs = Bs + L * (n + 1);                 // (L, P + 1)
    float* Cs = Xs + L * (P + 1);                 // (TR, n + 1)
    float* Ss = Cs + TR * (n + 1);                // (TR, L + 1)
    float* cum = Ss + TR * (L + 1);               // (L,)
    float* dtv = cum + L;                         // (L,)
    float* wend = dtv + L;                        // (L,) exp(cum_L - cum_j) dt_j

    const int tid = threadIdx.x, tr = tid / 32, tc = tid % 32;
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int n_chunks = gridDim.x, n_heads = gridDim.y, g = h / group;
    const int t0 = chunk * L;

    for (int t = tid; t < L; t += THREADS)
        dtv[t] = t0 + t < s_len ? dt[b * dts.b + (t0 + t) * dts.s + h * dts.h] : 0.0f;
    load_rows(Bs, n + 1, bm, bs, b, g, t0, L, n, s_len);
    load_rows(Xs, P + 1, x, xs, b, h, t0, L, P, s_len);
    __syncthreads();

    // cum = inclusive cumsum of dt * a over the chunk: 4 steps per lane of warp 0
    if (tid < 32) {
        const float ah = a[h];
        float v[4], run = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            run += dtv[4 * tid + q] * ah;
            v[q] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, incl, off);
            if (tid >= off) incl += o;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (tid == 0) excl = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) cum[4 * tid + q] = excl + v[q];
    }
    __syncthreads();
    const long long bch = ((long long)b * n_chunks + chunk) * n_heads + h;
    for (int t = tid; t < L; t += THREADS) {
        wend[t] = expf(cum[L - 1] - cum[t]) * dtv[t];
        cum_out[bch * L + t] = cum[t];
    }
    if (tid == 0) decay_out[bch] = expf(cum[L - 1]);
    __syncthreads();

    // intra-chunk y, one 32-row tile of the score matrix at a time
    for (int r0 = 0; r0 < L; r0 += TR) {
        load_rows(Cs, n + 1, cm, cs, b, g, t0 + r0, TR, n, s_len);
        __syncthreads();
        const int n_cols = r0 / 32 + 1;  // column blocks at or below the diagonal
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) sc[i][cc] = 0.0f;
        for (int k = 0; k < n; ++k) {
            float cv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Cs[(tr * 4 + i) * (n + 1) + k];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                if (cc < n_cols) {
                    const float bv = Bs[(tc + 32 * cc) * (n + 1) + k];
#pragma unroll
                    for (int i = 0; i < 4; ++i) sc[i][cc] = fmaf(cv[i], bv, sc[i][cc]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int tl = tr * 4 + i, t = r0 + tl;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                if (cc < n_cols) {
                    const int j = tc + 32 * cc;
                    Ss[tl * (L + 1) + j] =
                        j <= t ? sc[i][cc] * expf(cum[t] - cum[j]) * dtv[j] : 0.0f;
                }
            }
        }
        __syncthreads();
        float acc[4][PE];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < PE; ++e) acc[i][e] = 0.0f;
        const int j_end = r0 + TR;
        for (int j = 0; j < j_end; ++j) {
            float xv[PE];
#pragma unroll
            for (int e = 0; e < PE; ++e) xv[e] = Xs[j * (P + 1) + tc + 32 * e];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float s = Ss[(tr * 4 + i) * (L + 1) + j];
#pragma unroll
                for (int e = 0; e < PE; ++e) acc[i][e] = fmaf(s, xv[e], acc[i][e]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = t0 + r0 + tr * 4 + i;
            if (t < s_len) {
                float* yrow = y_acc + (((long long)b * s_len + t) * n_heads + h) * P;
#pragma unroll
                for (int e = 0; e < PE; ++e) yrow[tc + 32 * e] = acc[i][e];
            }
        }
        __syncthreads();  // Cs and Ss are reused by the next tile
    }

    // the chunk's own state: sum_j (B_j * wend_j) x_j^T, 32 state rows at a time
    float* st = state_out + bch * n * P;
    for (int n0 = 0; n0 < n; n0 += 32) {
        float acc[4][PE];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < PE; ++e) acc[i][e] = 0.0f;
        for (int j = 0; j < L; ++j) {
            const float w = wend[j];
            float xv[PE];
#pragma unroll
            for (int e = 0; e < PE; ++e) xv[e] = Xs[j * (P + 1) + tc + 32 * e];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int k = n0 + tr * 4 + i;
                const float bw = k < n ? Bs[j * (n + 1) + k] * w : 0.0f;
#pragma unroll
                for (int e = 0; e < PE; ++e) acc[i][e] = fmaf(bw, xv[e], acc[i][e]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = n0 + tr * 4 + i;
            if (k < n) {
#pragma unroll
                for (int e = 0; e < PE; ++e) st[k * P + tc + 32 * e] = acc[i][e];
            }
        }
    }
}

// in-order scan over the chunks of each (b, h, n, p): the chunk-state
// buffer becomes the state entering each chunk; the last is the final state
__global__ void __launch_bounds__(THREADS)
ssd_state_scan_kernel(float* __restrict__ chunk_state, const float* __restrict__ decay,
                      float* __restrict__ final_state, int n_chunks, int n_heads, int np,
                      long long total) {
    const long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
    if (idx >= total) return;
    const long long bh = idx / np;
    const int e = (int)(idx % np), h = (int)(bh % n_heads);
    const long long b = bh / n_heads;
    float hcur = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        const long long bch = (b * n_chunks + c) * n_heads + h;
        const float s = chunk_state[bch * np + e];
        chunk_state[bch * np + e] = hcur;
        hcur = hcur * decay[bch] + s;
    }
    final_state[idx] = hcur;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_inter_kernel(const T* __restrict__ cm, int s_len, int group, int n, Strides cs,
                 const float* __restrict__ cum, const float* __restrict__ h_prev,
                 const float* y_acc, T* y) {
    constexpr int PE = P / 32;
    constexpr int RT = L / 8;  // rows per thread
    extern __shared__ float4 smem4[];
    float* Cs = reinterpret_cast<float*>(smem4);  // (L, n + 1)
    float* Hs = Cs + L * (n + 1);                 // (n, P)

    const int tid = threadIdx.x, tr = tid / 32, tc = tid % 32;
    const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int n_chunks = gridDim.x, n_heads = gridDim.y, g = h / group;
    const int t0 = chunk * L;
    const long long bch = ((long long)b * n_chunks + chunk) * n_heads + h;

    load_rows(Cs, n + 1, cm, cs, b, g, t0, L, n, s_len);
    const float* hp = h_prev + bch * n * P;
    for (int e = tid; e < n * P; e += THREADS) Hs[e] = hp[e];
    __syncthreads();

    float acc[RT][PE];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < PE; ++e) acc[i][e] = 0.0f;
    for (int k = 0; k < n; ++k) {
        float hv[PE];
#pragma unroll
        for (int e = 0; e < PE; ++e) hv[e] = Hs[k * P + tc + 32 * e];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const float c = Cs[(tr + 8 * i) * (n + 1) + k];
#pragma unroll
            for (int e = 0; e < PE; ++e) acc[i][e] = fmaf(c, hv[e], acc[i][e]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int tl = tr + 8 * i, t = t0 + tl;
        if (t < s_len) {
            const float ec = expf(cum[bch * L + tl]);
            const long long row = (((long long)b * s_len + t) * n_heads + h) * P;
#pragma unroll
            for (int e = 0; e < PE; ++e) {
                const int p = tc + 32 * e;
                store(&y[row + p], y_acc[row + p] + ec * acc[i][e]);
            }
        }
    }
}

template <int P, typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           int batch, int s_len, int n_heads, int n_groups, int n, Strides xs, Strides dts,
           Strides bs, Strides cs, void* y, float* y_acc, float* cum, float* decay,
           float* chunk_state, float* final_state, cudaStream_t stream) {
    const int n_chunks = (s_len + L - 1) / L, group = n_heads / n_groups;
    const dim3 grid(n_chunks, n_heads, batch);
    const int smem1 = chunk_smem_floats(n, P) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_kernel<P, T><<<grid, THREADS, smem1, stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
        s_len, group, n, xs, dts, bs, cs, y_acc, cum, decay, chunk_state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long total = (long long)batch * n_heads * n * P;
    ssd_state_scan_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        chunk_state, decay, final_state, n_chunks, n_heads, n * P, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int smem3 = inter_smem_floats(n, P) * (int)sizeof(float);
    err = cudaFuncSetAttribute(ssd_inter_kernel<P, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
    if (err != cudaSuccess) return (int)err;
    ssd_inter_kernel<P, T><<<grid, THREADS, smem3, stream>>>(
        static_cast<const T*>(cm), s_len, group, n, cs, cum, chunk_state, y_acc,
        static_cast<T*>(y));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_p(int p, const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, int batch, int s_len, int n_heads, int n_groups, int n, Strides xs,
             Strides dts, Strides bs, Strides cs, void* y, float* y_acc, float* cum,
             float* decay, float* chunk_state, float* final_state, cudaStream_t stream) {
    switch (p) {
        case 32: return launch<32, T>(x, dt, a, bm, cm, batch, s_len, n_heads, n_groups, n, xs,
                                      dts, bs, cs, y, y_acc, cum, decay, chunk_state,
                                      final_state, stream);
        case 64: return launch<64, T>(x, dt, a, bm, cm, batch, s_len, n_heads, n_groups, n, xs,
                                      dts, bs, cs, y, y_acc, cum, decay, chunk_state,
                                      final_state, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// x (B, S, H, P) and b/c (B, S, G, N) in fp32 or bf16, dt (B, S, H) and
// a (H,) fp32: element strides of the (b, s, head | group) axes, the last
// axis contiguous.  Outputs: y (B, S, H, P) contiguous in x's type; y_acc,
// the fp32 intra-chunk y (may alias y when it is fp32); cum (B, NC, H, 128),
// decay (B, NC, H) and chunk_state (B, NC, H, N, P) workspaces; final_state
// (B, H, N, P) fp32.
int ssd_scan_launch(const void* x, const float* dt, const float* a, const void* bm,
                    const void* cm, int batch, int s_len, int n_heads, int head_dim,
                    int n_groups, int d_state, int is_bf16, long long x_sb, long long x_ss,
                    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
                    long long c_ss, long long c_sg, void* y, float* y_acc, float* cum,
                    float* decay, float* chunk_state, float* final_state, void* stream) {
    if (batch <= 0 || s_len <= 0 || n_groups <= 0 || n_heads % n_groups != 0 || d_state <= 0 ||
        d_state > 256)
        return (int)cudaErrorInvalidValue;
    const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, b_sg},
        cs{c_sb, c_ss, c_sg};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_p<__nv_bfloat16>(head_dim, x, dt, a, bm, cm, batch, s_len, n_heads,
                                       n_groups, d_state, xs, dts, bs, cs, y, y_acc, cum, decay,
                                       chunk_state, final_state, st);
    return launch_p<float>(head_dim, x, dt, a, bm, cm, batch, s_len, n_heads, n_groups, d_state,
                           xs, dts, bs, cs, y, y_acc, cum, decay, chunk_state, final_state, st);
}

}  // extern "C"
