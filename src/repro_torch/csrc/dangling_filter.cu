// The pre-compute sparsity filter (paper Figs. 7a/7b) on dense operands:
//   joint = (a != 0) & (w != 0);  a_out = joint ? a : +0;  w_out = joint ? w : +0
// over two flattened operands of n elements each.  -0.0 counts as zero and
// NaN as non-zero, as `!= 0` does; a dropped entry is written as +0.0.
//
// Replaces the Pallas TPU kernel `dangling_filter_pallas` / `_filter_kernel`
// (repro/kernels/mask_compress/mc_kernel.py:50-80), which filters (R, 1024)
// fp32 lane rows in (8, 1024) VMEM blocks after its wrapper pads both
// operands to whole blocks (mask_compress/ops.py:23-29, :60-64).  The
// padding exists only for the TPU's tiles: here one pass walks the
// flattened operands, so nothing is padded, copied or sliced.
//
// What bounds it on the H100: per element it reads a and w and writes both
// outputs (16 bytes in fp32, 8 in bf16) and does two bit tests and two
// selects, so device memory (3.35 TB/s) bounds it.  The design answers that
// with 16-byte loads and stores (4 fp32 or 8 bf16 elements a thread per
// access, neighbouring threads on neighbouring vectors) where all four
// pointers are 16-byte aligned, a scalar loop for the tail (and for
// unaligned views), and no other traffic.  The zero test is a bit test on
// the raw bits with the sign masked off, so bf16 is never converted and
// outputs are the inputs' own bits.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError().  Nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 32;  // a grid-stride loop past this

template <typename Bits>
union Vec16 {
    uint4 raw;
    Bits e[16 / sizeof(Bits)];
};

template <typename Bits, Bits kMagnitude>
__device__ __forceinline__ void filter_one(Bits& a, Bits& w) {
    const bool joint = (a & kMagnitude) != 0 && (w & kMagnitude) != 0;
    a = joint ? a : Bits(0);
    w = joint ? w : Bits(0);
}

template <typename Bits, Bits kMagnitude>
__global__ void __launch_bounds__(THREADS)
dangling_filter_kernel(const Bits* __restrict__ a, const Bits* __restrict__ w,
                       Bits* __restrict__ a_out, Bits* __restrict__ w_out, int64_t n,
                       int64_t n_vec) {
    constexpr int VEC = 16 / sizeof(Bits);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    for (int64_t v = tid; v < n_vec; v += stride) {
        Vec16<Bits> av, wv;
        av.raw = __ldg(reinterpret_cast<const uint4*>(a) + v);
        wv.raw = __ldg(reinterpret_cast<const uint4*>(w) + v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) filter_one<Bits, kMagnitude>(av.e[i], wv.e[i]);
        reinterpret_cast<uint4*>(a_out)[v] = av.raw;
        reinterpret_cast<uint4*>(w_out)[v] = wv.raw;
    }
    for (int64_t i = n_vec * VEC + tid; i < n; i += stride) {
        Bits x = a[i], y = w[i];
        filter_one<Bits, kMagnitude>(x, y);
        a_out[i] = x;
        w_out[i] = y;
    }
}

template <typename Bits, Bits kMagnitude>
int launch(const void* a, const void* w, void* a_out, void* w_out, int64_t n,
           cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(Bits);
    const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(a_out) |
                           reinterpret_cast<uintptr_t>(w_out)) & 15u) == 0;
    const int64_t n_vec = aligned ? n / VEC : 0;
    const int64_t work = n_vec > 0 ? n_vec : n;  // the loop with the most iterations
    const int64_t want = (work + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
    dangling_filter_kernel<Bits, kMagnitude><<<blocks, THREADS, 0, stream>>>(
        static_cast<const Bits*>(a), static_cast<const Bits*>(w), static_cast<Bits*>(a_out),
        static_cast<Bits*>(w_out), n, n_vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// elem_bytes: 4 for fp32 operands, 2 for bf16; a, w, a_out, w_out hold n
// elements each, contiguous
int dangling_filter_launch(const void* a, const void* w, void* a_out, void* w_out,
                           long long n, int elem_bytes, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem_bytes == 4) return launch<uint32_t, 0x7fffffffu>(a, w, a_out, w_out, n, s);
    if (elem_bytes == 2) return launch<uint16_t, 0x7fffu>(a, w, a_out, w_out, n, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
