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
// VMEM across its sequential kv axis; here one CTA owns one 64-row query
// block of one (b, h) and walks the kv tiles in a loop, keeping the state in
// registers.  The causal block skip (tiles after the block's last row) and
// the window block skip (tiles before its first row's window) bound that
// loop, so skipped tiles are never loaded.  Element masks use absolute
// indices, and keys at index >= Skv are masked too, so a ragged Skv needs no
// padding (the reference pads with zero keys and masks them only causally).
// q/k/v are read through (b, h, s) strides with a contiguous D axis, so the
// model's (B, S, H, D) projections are read in place; bf16 inputs are
// up-cast on load and the output is written in the input type.
//
// Threads: 256 as 16 x 16.  For the 64 x 64 score tile a thread owns rows
// 4*ty..4*ty+3 and columns tx + 16c (c < 4), so a row's max and sum are
// 16-lane shuffles; P goes through shared memory for P @ V, where a thread
// owns the same rows and D/16 output columns.  Q, K, V and P tiles sit in
// shared memory with rows padded by 4 floats (16-byte aligned float4 reads,
// no bank conflicts on the K-row reads).  Query blocks are issued
// latest-first, so the longest causal blocks start first.
//
// What bounds it on the H100: at llama3.2-1b's prefill (H 32, HKV 8, D 64,
// S 4096, causal) it does 2 * 2 * H * S^2 * D / 2 = 68.7 GFLOP per layer on
// 16.8 MB of q/k/v/out: bound by operations, 1.03 ms at 67 TFLOP/s of fp32
// FMAs.  No tensor cores: the repo keeps TF32 off, and this first version
// runs fp32 FMAs from shared memory; wgmma, TMA and a pipelined K/V ring are
// later work.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BKV = 64;      // keys per kv tile
constexpr int THREADS = 256;
constexpr int LDP = BKV + 4;  // padded row of the P tile
constexpr float NEG_INF = -1e30f;

struct Strides {
    long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
    return 3 * BQ * (D + 4) + BQ * LDP;
}

// output column of a thread's e-th accumulator
template <int D>
__device__ __forceinline__ int out_col(int tx, int e) {
    if constexpr (D >= 64) {
        return (e / 4) * 64 + 4 * tx + (e % 4);
    } else {
        return tx * (D / 16) + e;
    }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int group, int sq, int skv, Strides qs, Strides ks, Strides vs,
          Strides os, int causal, int window, float scale) {
    constexpr int LD = D + 4;
    constexpr int NC = D / 16;  // output columns per thread
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BKV * LD;
    float* Ps = Vs + BKV * LD;

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z, hkv = h / group;
    const T* qp = q + b * qs.b + h * qs.h;
    const T* kp = k + b * ks.b + hkv * ks.h;
    const T* vp = v + b * vs.b + hkv * vs.h;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, c = e % D, row = q0 + r;
        Qs[r * LD + c] = row < sq ? to_f(qp[row * qs.s + c]) : 0.0f;
    }
    int kv_begin = 0, kv_end = skv;
    if (causal) kv_end = min(kv_end, q0 + BQ);
    if (window > 0) kv_begin = max(0, q0 - (window - 1)) / BKV * BKV;

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[i][e] = 0.0f;
    }

    for (int j0 = kv_begin; j0 < kv_end; j0 += BKV) {
        __syncthreads();  // the previous tile's K/V/P reads are done
        for (int e = tid; e < BKV * D; e += THREADS) {
            const int r = e / D, c = e % D, key = j0 + r;
            const bool in = key < skv;
            Ks[r * LD + c] = in ? to_f(kp[key * ks.s + c]) : 0.0f;
            Vs[r * LD + c] = in ? to_f(vp[key * vs.s + c]) : 0.0f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
                    s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
                    s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
                    s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
                }
        }

        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty * 4 + i;
            bool live[4];
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = j0 + tx + 16 * c;
                live[c] = col < skv && (!causal || row >= col) &&
                          (window <= 0 || col > row - window);
                s[i][c] = live[c] ? s[i][c] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][c]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
            const float m_new = fmaxf(m[i], mx);
            alpha[i] = m[i] == NEG_INF ? 0.0f : expf(m[i] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = live[c] ? expf(s[i][c] - m_new) : 0.0f;
                Ps[(ty * 4 + i) * LDP + tx + 16 * c] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
            l[i] = alpha[i] * l[i] + sum;
            m[i] = m_new;
        }
        __syncthreads();  // P is complete

#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < NC; ++e) acc[i][e] *= alpha[i];
#pragma unroll 2
        for (int j = 0; j < BKV; j += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LDP + j]);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float* vrow = &Vs[(j + t) * LD];
                float vv[NC];
                if constexpr (D >= 64) {
#pragma unroll
                    for (int g = 0; g < D / 64; ++g) {
                        const float4 x4 = *reinterpret_cast<const float4*>(&vrow[g * 64 + 4 * tx]);
                        vv[4 * g] = x4.x;
                        vv[4 * g + 1] = x4.y;
                        vv[4 * g + 2] = x4.z;
                        vv[4 * g + 3] = x4.w;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < NC; ++e) vv[e] = vrow[out_col<D>(tx, e)];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
                    for (int e = 0; e < NC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
                }
            }
        }
    }

    T* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= sq) continue;
        const float safe_l = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
        for (int e = 0; e < NC; ++e) store(&op[row * os.s + out_col<D>(tx, e)], acc[i][e] / safe_l);
    }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
           int group, int sq, int skv, Strides qs, Strides ks, Strides vs, Strides os,
           int causal, int window, float scale, cudaStream_t stream) {
    const int smem = smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fa_kernel<D, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sq + BQ - 1) / BQ, n_heads, batch);
    fa_kernel<D, T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), group, sq, skv, qs, ks, vs, os, causal, window, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v, void* o, int batch,
             int n_heads, int group, int sq, int skv, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, float scale, cudaStream_t stream) {
    switch (head_dim) {
        case 16: return launch<16, T>(q, k, v, o, batch, n_heads, group, sq, skv, qs, ks, vs, os,
                                      causal, window, scale, stream);
        case 32: return launch<32, T>(q, k, v, o, batch, n_heads, group, sq, skv, qs, ks, vs, os,
                                      causal, window, scale, stream);
        case 64: return launch<64, T>(q, k, v, o, batch, n_heads, group, sq, skv, qs, ks, vs, os,
                                      causal, window, scale, stream);
        case 128: return launch<128, T>(q, k, v, o, batch, n_heads, group, sq, skv, qs, ks, vs,
                                        os, causal, window, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k/v (B, HKV, Skv, D), out (B, H, Sq, D): element strides
// of the (b, h, s) axes, D contiguous.  window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int batch,
                           int n_heads, int n_kv_heads, int sq, int skv, int head_dim,
                           int is_bf16, long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, int window, float scale, void* stream) {
    if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || sq <= 0 || batch <= 0)
        return (int)cudaErrorInvalidValue;
    const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
        os{o_sb, o_sh, o_ss};
    const int group = n_heads / n_kv_heads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, batch, n_heads, group, sq, skv, qs,
                                       ks, vs, os, causal, window, scale, st);
    return launch_d<float>(head_dim, q, k, v, o, batch, n_heads, group, sq, skv, qs, ks, vs, os,
                           causal, window, scale, st);
}

}  // extern "C"
