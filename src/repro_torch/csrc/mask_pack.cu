// Binary-mask packing: (n_blocks, block_len) values -> (n_blocks, n_words)
// uint32 words, n_words = ceil(block_len / 32), bit i of word w set iff
// element 32*w + i of the block is non-zero (-0.0 packs as 0, NaN as 1).
// Bits past block_len are 0.  Values are bf16, fp16 or fp32; the test is on
// the raw bits with the sign masked off (0x7fff, 0x7fffffff), so nothing is
// converted and subnormals, infinities and NaNs pack as non-zero.
//
// Replaces the Pallas TPU kernel `mask_pack_pallas` / `_pack_kernel`
// (repro/kernels/mask_compress/mc_kernel.py), which packs (R, 1024) fp32
// lane rows by a shift-and-reduce over 32-lane groups.  One launch covers a
// whole KV leaf -- every (layer, slot) block -- as the vmapped JAX pack does
// per block (repro/serving/kvpool.py:97-99).
//
// What bounds it on the H100: it reads 2 or 4 bytes per value and writes
// 1/8 byte, with no arithmetic to speak of, so device memory (3.35 TB/s)
// bounds it.  At the 4096-token serve's leaf (64 blocks of 2,105,856 bf16,
// 269.5 MB) the bound is 0.0855 ms, and a kernel reaches it only with
// enough bytes in flight per SM to cover DRAM latency.  Two routes, chosen
// by the wrapper's planner (kernels/mask_compress/ops.py `plan`):
//
// * stream -- block_len % 32 == 0 and a 16-byte aligned operand (every
//   serving leaf: block_len = max_len * kv_heads * head_dim).  Every block
//   then ends on a word boundary, so the input is one flat stream of words
//   and the (n_blocks, n_words) output is the same stream.  A warp step
//   makes 32 contiguous words: each lane loads UNROLL 16-byte chunks (8
//   16-bit or 4 fp32 values) with streaming loads, all issued before the
//   first is used, turns each into 8 or 4 bits, and ORs them into words
//   across the LANES_PER_WORD lanes that share one with __shfl_xor_sync.
//   UNROLL equals LANES_PER_WORD, so each lane then stores exactly one of
//   the step's words and the warp's 32 stores are one 128-byte run.  About
//   four 256-thread CTAs per SM walk the steps with a grid-stride loop: 64
//   KB (16-bit) or 128 KB (fp32) in flight per SM.  The index arithmetic is
//   multiplies and shifts; only the last, partial step checks its chunks.
// * lane -- everything else (ragged block lengths, views whose offset breaks
//   16-byte alignment).  Warp w loads the 32 values of word w, one per lane,
//   and __ballot_sync(0xffffffff, x != 0) returns bit i = lane i, which is
//   exactly the word layout; blocks of any length, no padding.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // both routes: 8 warps a CTA
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// bit i set iff value i of a 16-byte chunk is non-zero (little-endian: value
// 2k is the low half of 32-bit word k)
template <int kBytes>
__device__ __forceinline__ uint32_t chunk_bits(uint4 v);

template <>
__device__ __forceinline__ uint32_t chunk_bits<2>(uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        bits |= static_cast<uint32_t>((w[k] & 0x7fffu) != 0) << (2 * k);
        bits |= static_cast<uint32_t>((w[k] & 0x7fff0000u) != 0) << (2 * k + 1);
    }
    return bits;
}

template <>
__device__ __forceinline__ uint32_t chunk_bits<4>(uint4 v) {
    return static_cast<uint32_t>((v.x & 0x7fffffffu) != 0) |
           static_cast<uint32_t>((v.y & 0x7fffffffu) != 0) << 1 |
           static_cast<uint32_t>((v.z & 0x7fffffffu) != 0) << 2 |
           static_cast<uint32_t>((v.w & 0x7fffffffu) != 0) << 3;
}

// words: n_words of the whole stream (n_blocks * block_len / 32); steps:
// ceil(words / 32), one per warp visit
template <int kBytes>
__global__ void __launch_bounds__(THREADS)
mask_pack_stream_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out,
                        int64_t words, int64_t steps) {
    constexpr int VALUES = 16 / kBytes;             // values per chunk
    constexpr int LANES_PER_WORD = 32 / VALUES;     // 4 or 8
    constexpr int GROUPS = 32 / LANES_PER_WORD;     // words per chunk set
    constexpr int UNROLL = LANES_PER_WORD;          // chunk sets per step
    const int lane = threadIdx.x & 31;
    const int sub = lane % LANES_PER_WORD, group = lane / LANES_PER_WORD;
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * WARPS;
    const int64_t chunks = words * LANES_PER_WORD;
    // lane's word within a step: chunk set `sub`, group `group`
    const int my_word = sub * GROUPS + group;
    for (int64_t step = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
         step < steps; step += n_warps) {
        const uint4* src = x + step * (32 * UNROLL) + lane;
        uint4 v[UNROLL];
        if ((step + 1) * 32 <= words) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(src + 32 * u);
        } else {  // the last, partial step: whole words only, chunk by chunk
            const int64_t left = chunks - step * (32 * UNROLL) - lane;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = 32 * u < left ? __ldcs(src + 32 * u) : make_uint4(0, 0, 0, 0);
        }
        uint32_t mine = 0;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            uint32_t w = chunk_bits<kBytes>(v[u]) << (sub * VALUES);
#pragma unroll
            for (int off = 1; off < LANES_PER_WORD; off <<= 1) w |= __shfl_xor_sync(FULL, w, off);
            mine = sub == u ? w : mine;
        }
        const int64_t word = step * 32 + my_word;
        if (word < words) out[word] = mine;
    }
}

template <typename Bits, Bits kMagnitude>
__global__ void __launch_bounds__(THREADS)
mask_pack_lane_kernel(const Bits* __restrict__ x, uint32_t* __restrict__ out,
                      int64_t n_blocks, int64_t block_len, int64_t n_words) {
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= n_blocks * n_words) return;  // warp-uniform: all 32 lanes leave together
    const int64_t block = warp / n_words;
    const int64_t idx = (warp % n_words) * 32 + lane;
    const bool nz = idx < block_len && (x[block * block_len + idx] & kMagnitude) != 0;
    const uint32_t word = __ballot_sync(FULL, nz);
    if (lane == 0) out[warp] = word;
}

}  // namespace

extern "C" {

// elem_bytes: 2 for bf16 or fp16 rows, 4 for fp32; stream: 1 for the stream
// route (needs block_len % 32 == 0 and x 16-byte aligned), 0 for the lane
// route; ctas: the grid the planner chose
int mask_pack_launch(const void* x, uint32_t* out, long long n_blocks, long long block_len,
                     int elem_bytes, int stream, int ctas, void* cuda_stream) {
    const int64_t n_words = (block_len + 31) / 32;
    if (n_blocks * n_words == 0) return 0;
    if (ctas <= 0 || (elem_bytes != 2 && elem_bytes != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
    if (stream) {
        if (block_len % 32 != 0 || (reinterpret_cast<uintptr_t>(x) & 15u) != 0)
            return static_cast<int>(cudaErrorInvalidValue);
        const int64_t words = n_blocks * n_words, steps = (words + 31) / 32;
        const uint4* v = static_cast<const uint4*>(x);
        if (elem_bytes == 2)
            mask_pack_stream_kernel<2><<<ctas, THREADS, 0, s>>>(v, out, words, steps);
        else
            mask_pack_stream_kernel<4><<<ctas, THREADS, 0, s>>>(v, out, words, steps);
    } else if (elem_bytes == 2) {
        mask_pack_lane_kernel<uint16_t, 0x7fffu><<<ctas, THREADS, 0, s>>>(
            static_cast<const uint16_t*>(x), out, n_blocks, block_len, n_words);
    } else {
        mask_pack_lane_kernel<uint32_t, 0x7fffffffu><<<ctas, THREADS, 0, s>>>(
            static_cast<const uint32_t*>(x), out, n_blocks, block_len, n_words);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
