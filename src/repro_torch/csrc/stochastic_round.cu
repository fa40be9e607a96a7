// Elementwise stochastic rounding onto the Q(il, fl) fixed-point grid.
//
// Replaces the Pallas TPU kernel `sr_pallas` / `_sr_kernel`
// (repro/kernels/stochastic_round/sr_kernel.py:51).  The Pallas kernel
// walks the flattened array in (8, 1024) VMEM blocks with the counter
// block * 8192 + row * 1024 + col, which is the flat element index; here one
// thread takes one element (a grid-stride loop over a 64-bit index) and
// uses the same counter, the same murmur3 finalizer and the top 24 bits of
// the hash as the uniform, so the result is the reference's bit for bit:
//   out = clip((floor(clip(x) * 2^fl) + (u < frac)) * 2^-fl)
//
// What bounds it on the H100: 8 bytes moved per element (one fp32 read,
// one fp32 write) against about 20 integer and float operations: bound by
// the 3.35 TB/s of device memory.  The design answers that with coalesced
// 4-byte accesses, neighbouring threads on neighbouring elements, and no
// other traffic; the flat counter needs no index arithmetic beyond the
// element index itself.  Vector (16-byte) accesses are left for later.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t hash_uint32(uint32_t counter, uint32_t seed) {
    uint32_t z = counter + seed * 0x9E3779B9u;
    z = (z ^ (z >> 16)) * 0x7FEB352Du;
    z = (z ^ (z >> 15)) * 0x846CA68Bu;
    return z ^ (z >> 16);
}

__global__ void __launch_bounds__(THREADS)
sr_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n, uint32_t seed,
          float scale, float eps, float min_v, float max_v) {
    for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * THREADS) {
        const float xc = fminf(fmaxf(x[i], min_v), max_v);
        const float scaled = xc * scale;
        const float lo = floorf(scaled);
        const float frac = scaled - lo;
        // the counter is the flat index, taken mod 2^32 as the reference's uint32
        const float u = (float)(hash_uint32((uint32_t)i, seed) >> 8) * (1.0f / 16777216.0f);
        const float rounded = lo + (u < frac ? 1.0f : 0.0f);
        out[i] = fminf(fmaxf(rounded * eps, min_v), max_v);
    }
}

}  // namespace

extern "C" {

int stochastic_round_launch(const float* x, float* out, long long n, unsigned int seed,
                            float scale, float eps, float min_v, float max_v, void* stream) {
    const long long want = (n + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    sr_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, n, seed, scale, eps, min_v, max_v);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
