// Gathered 4-bit rescore: out[q, i] = <q_rot[q], deq(packed[cand[q, i]])>.
//
// Replaces the Pallas kernel src/repro/kernels/gather_dot.py::_gather_nibble_kernel
// (launched by gather_nibble_dot_raw).  The reference gathers the candidate
// rows into a [b, m, d'/2] array with jnp.take before its kernel
// (kernels/ops.py::score_gathered_raw); here the gather is fused: each
// thread reads its candidate row packed[cand[q, i]] itself, so the gathered
// copy never exists.  A candidate outside [0, n) scores 0 and its row is
// never read.
//
// Design: one block scores 128 candidates of one query, one thread per
// candidate.  The query is staged in shared memory 1024 dims at a time; each
// thread reads its row in 16-byte loads (32 dims), eight loads in flight at
// a time, and updates ONE f32
// accumulator with fmaf over dims 0..d'-1 ascending: the low nibble of byte i
// is dim 2i, its high nibble dim 2i+1.  That is the order of the full-scan
// kernel (csrc/nibble_dot.cu), so a gathered score is byte-equal to the full
// scan's score of the same (query, row), and the cascade returns the full
// scan's scores for its survivors.  No split-K, no atomics; a ragged m is
// masked in the kernel.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: the candidate rows, b m d'/2 bytes, plus the
// queries and the output.  At b=64, m=320, d'=1024 that is 10.5 MB (3.1 us
// at 3.35 TB/s) against 21 M f32 FMAs (0.3 us at 67 TFLOP/s): bytes bound
// it.  Each row is read once, in 16-byte loads.  The launch holds few warps
// (b m / 32), so what the kernel costs beyond the bound is latency: of its
// row loads, which it overlaps eight at a time, and of its one dependent
// chain of d' FMAs per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgather_dot.so gather_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // candidates per block, one per thread
constexpr int KC = 1024;        // query dims staged in shared memory per step

// kVec: d' is a multiple of 32, so rows are read as 16-byte vectors.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_nibble_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ q,
                     const int32_t* __restrict__ cand,
                     const float* __restrict__ lut_g,
                     float* __restrict__ out,
                     int b, int m, int n, int d_pad) {
    __shared__ __align__(16) float qs[KC];
    __shared__ float lut[16];

    const int tid = threadIdx.x;
    const int qi = blockIdx.y;
    const int i = blockIdx.x * kThreads + tid;
    if (tid < 16) lut[tid] = lut_g[tid];

    const int row = i < m ? cand[static_cast<int64_t>(qi) * m + i] : -1;
    const bool valid = row >= 0 && row < n;
    const uint8_t* prow = packed + static_cast<int64_t>(valid ? row : 0) * (d_pad / 2);
    const float* qrow = q + static_cast<int64_t>(qi) * d_pad;

    float acc = 0.0f;
    for (int k0 = 0; k0 < d_pad; k0 += KC) {
        const int kc = min(KC, d_pad - k0);
        __syncthreads();   // the previous chunk is consumed
        for (int t = tid; t < kc; t += kThreads) qs[t] = qrow[k0 + t];
        __syncthreads();
        if (!valid) continue;
        if (kVec) {
            // Issue the loads of 8 vectors (256 dims) before their FMAs, so a
            // thread waits on memory once per 256 dims, not once per 32.
            const uint4* src = reinterpret_cast<const uint4*>(prow + k0 / 2);
            const int nu = kc / 32;
            for (int u0 = 0; u0 < nu; u0 += 8) {
                uint4 v[8];
#pragma unroll
                for (int g = 0; g < 8; ++g)
                    if (u0 + g < nu) v[g] = src[u0 + g];
#pragma unroll
                for (int g = 0; g < 8; ++g) {
                    if (u0 + g >= nu) break;
                    const uint32_t w[4] = {v[g].x, v[g].y, v[g].z, v[g].w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const uint32_t byte = (w[e] >> (8 * j)) & 0xFFu;
                            const int dim = 32 * (u0 + g) + 8 * e + 2 * j;
                            acc = fmaf(qs[dim], lut[byte & 15u], acc);
                            acc = fmaf(qs[dim + 1], lut[byte >> 4], acc);
                        }
                }
            }
        } else {
            for (int t = 0; t < kc / 2; ++t) {
                const uint32_t byte = prow[k0 / 2 + t];
                acc = fmaf(qs[2 * t], lut[byte & 15u], acc);
                acc = fmaf(qs[2 * t + 1], lut[byte >> 4], acc);
            }
        }
    }
    if (i < m) out[static_cast<int64_t>(qi) * m + i] = valid ? acc : 0.0f;
}

}  // namespace

extern "C" const char* gather_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// packed: [n, d_pad/2] u8, q: [b, d_pad] f32, cand: [b, m] i32, lut: [16]
// f32, out: [b, m] f32, all contiguous on `device`, packed 16-byte aligned;
// d_pad even, b <= 65535.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int gather_nibble_dot(const uint8_t* packed, const float* q, const int32_t* cand,
                                 const float* lut, float* out, int b, int m, int n,
                                 int d_pad, int device, void* stream) {
    if (d_pad < 2 || (d_pad & 1) || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || m == 0) return 0;
    const dim3 grid((m + kThreads - 1) / kThreads, b);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d_pad % 32 == 0) {
        gather_nibble_kernel<true><<<grid, kThreads, 0, s>>>(packed, q, cand, lut, out,
                                                              b, m, n, d_pad);
    } else {
        gather_nibble_kernel<false><<<grid, kThreads, 0, s>>>(packed, q, cand, lut, out,
                                                               b, m, n, d_pad);
    }
    return static_cast<int>(cudaGetLastError());
}
