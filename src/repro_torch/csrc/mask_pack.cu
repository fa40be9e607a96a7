// Binary-mask packing: (n_blocks, block_len) values -> (n_blocks, n_words)
// uint32 words, n_words = ceil(block_len / 32), bit i of word w set iff
// element 32*w + i of the block is non-zero (-0.0 packs as 0, NaN as 1).
// Bits past block_len are 0.
//
// Replaces the Pallas TPU kernel `mask_pack_pallas` / `_pack_kernel`
// (repro/kernels/mask_compress/mc_kernel.py), which packs (R, 1024) fp32
// lane rows by a shift-and-reduce over 32-lane groups.  On Hopper the word
// is one warp vote: warp w loads the 32 elements of word w, one per lane,
// and __ballot_sync(0xffffffff, x != 0) returns bit i = lane i, which is
// exactly the word layout.  One launch covers a whole KV leaf — every
// (layer, slot) block — as the vmapped JAX pack does per block
// (repro/serving/kvpool.py:97-99); blocks of any length, no lane padding.
//
// What bounds it on the H100: it reads 2 (bf16) or 4 (fp32) bytes per
// element and writes 1/8 byte, with no arithmetic to speak of, so device
// memory bandwidth (3.35 TB/s) bounds it.  Each warp's load is one
// contiguous 64- or 128-byte segment, so the reads are fully coalesced; the
// test for non-zero is a bit test on the raw bits (exponent and mantissa),
// so bf16 is never converted.  At the serving path's sizes (a few MB per
// leaf) launch overhead, not bandwidth, dominates.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one word each

template <typename Bits, Bits kMagnitude>
__global__ void __launch_bounds__(THREADS)
mask_pack_kernel(const Bits* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t n_blocks, int64_t block_len, int64_t n_words) {
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (warp >= n_blocks * n_words) return;  // warp-uniform: all 32 lanes leave together
    const int64_t block = warp / n_words;
    const int64_t idx = (warp % n_words) * 32 + lane;
    const bool nz = idx < block_len && (x[block * block_len + idx] & kMagnitude) != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) out[warp] = word;
}

}  // namespace

extern "C" {

// elem_bytes: 2 for bf16 rows, 4 for fp32 rows
int mask_pack_launch(const void* x, uint32_t* out, long long n_blocks,
                     long long block_len, int elem_bytes, void* stream) {
    const int64_t n_words = (block_len + 31) / 32;
    const int64_t warps = n_blocks * n_words;
    if (warps == 0) return 0;
    const unsigned int blocks = static_cast<unsigned int>((warps * 32 + THREADS - 1) / THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem_bytes == 2) {
        mask_pack_kernel<uint16_t, 0x7fffu><<<blocks, THREADS, 0, s>>>(
            static_cast<const uint16_t*>(x), out, n_blocks, block_len, n_words);
    } else if (elem_bytes == 4) {
        mask_pack_kernel<uint32_t, 0x7fffffffu><<<blocks, THREADS, 0, s>>>(
            static_cast<const uint32_t*>(x), out, n_blocks, block_len, n_words);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
