// Signed, zero-padded Walsh-Hadamard transform of rows: out = H_{d'} (pad(x) * signs).
//
// Replaces the Pallas kernel src/repro/kernels/hadamard.py::_hadamard_kernel
// (launched by fwht_pallas).  The TPU kernel computes H_a X H_b as two small
// matrix products because its vector unit is poor at shuffles.  Hopper has no
// such limit, so this kernel runs the plain butterfly: one block per row, the
// row held in shared memory, log2(d') stages separated by __syncthreads().
// The zero pad d -> d' and the +-1 sign multiply of the RHDH rotation are
// fused into the load, so the rotated row is written once and nothing else
// goes through device memory.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: each row is read once (4 d bytes) and written once
// (4 d' bytes) against d' log2(d') adds, so the kernel is memory-bound
// (at [45000, 1024]: 369 MB, about 110 us at 3.35 TB/s).
//
// The butterfly sums in another order than the reference's Kronecker einsum,
// so a rotated value close to a Lloyd-Max boundary may round to the next code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhadamard.so hadamard.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDPad = 32768;  // 128 KB of shared memory per row

__global__ void fwht_rows_kernel(const float* __restrict__ x,
                                 const float* __restrict__ signs,
                                 float* __restrict__ out,
                                 int d, int d_pad, int log2_dpad) {
    extern __shared__ float row[];
    const int64_t r = blockIdx.x;
    const float* xr = x + r * d;
    for (int i = threadIdx.x; i < d_pad; i += blockDim.x) {
        row[i] = (i < d) ? xr[i] * signs[i] : 0.0f;
    }
    __syncthreads();
    const int half = d_pad >> 1;
    for (int s = 0; s < log2_dpad; ++s) {
        const int h = 1 << s;
        for (int p = threadIdx.x; p < half; p += blockDim.x) {
            // Pair p of stage s: (i, i + h) with i = the p-th index whose bit s is 0.
            const int i = ((p >> s) << (s + 1)) | (p & (h - 1));
            const float a = row[i];
            const float b = row[i + h];
            row[i] = a + b;
            row[i + h] = a - b;
        }
        __syncthreads();
    }
    float* o = out + r * d_pad;
    for (int i = threadIdx.x; i < d_pad; i += blockDim.x) {
        o[i] = row[i];
    }
}

}  // namespace

extern "C" const char* hadamard_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [n, d] f32, signs: [d_pad] f32, out: [n, d_pad] f32, all contiguous on
// `device`.  d_pad is a power of two with d <= d_pad <= 32768.  Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int fwht_rows(const float* x, const float* signs, float* out,
                         int n, int d, int d_pad, int device, void* stream) {
    if (d_pad < 1 || d_pad > kMaxDPad || (d_pad & (d_pad - 1)) || d > d_pad) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return 0;
    int log2_dpad = 0;
    while ((1 << log2_dpad) < d_pad) ++log2_dpad;
    int threads = d_pad / 2;
    if (threads < 32) threads = 32;
    if (threads > 1024) threads = 1024;
    const size_t smem = static_cast<size_t>(d_pad) * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(fwht_rows_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    fwht_rows_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, signs, out, d, d_pad, log2_dpad);
    return static_cast<int>(cudaGetLastError());
}
