// Gathered rescores: out[q, i] = <q_rot[q], deq(packed[cand[q, i]])>, for
// 4-bit and 2-bit codes.
//
// gather_nibble_dot: Replaces the Pallas kernel src/repro/kernels/gather_dot.py::_gather_nibble_kernel
// (launched by gather_nibble_dot_raw): 4-bit rows, the low nibble of byte i
// is dim 2i.
// gather_crumb_dot: Replaces the Pallas kernel src/repro/kernels/gather_dot.py::_gather_crumb_kernel
// (launched by gather_crumb_dot_raw): 2-bit rows, bits 2s..2s+1 of byte i
// are dim 4i+s.
// The reference gathers the candidate rows into a [b, m, bytes] array with
// jnp.take before its kernel (kernels/ops.py::score_gathered_raw); here the
// gather is fused: each thread reads its candidate row packed[cand[q, i]]
// itself, so the gathered copy never exists.  A candidate outside [0, n)
// scores 0 and its row is never read.  Rows lie code_stride bytes apart and
// queries q_stride floats apart, so the blocks of a mixed corpus are
// rescored as column views, as in nibble_dot.cu.
//
// Design: one block scores 128 candidates of one query, one thread per
// candidate.  The query is staged in shared memory 1024 dims at a time; in
// the kVec instance each thread reads its row in 16-byte loads (32 dims of
// 4-bit, 64 of 2-bit codes), eight loads in flight at a time, and updates
// ONE f32 accumulator with fmaf over dims 0..d-1 ascending.  That is the
// order of the full-scan kernels (csrc/nibble_dot.cu), so a gathered score
// is byte-equal to the full scan's score of the same (query, row), and the
// cascade returns the full scan's scores for its survivors.  No split-K, no
// atomics; a ragged m is masked in the kernel.  Where d is not a multiple
// of a load or the block starts or strides off 16 bytes (the small mixed
// splits), the same chain runs with one-byte loads.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: the candidate rows, b m d' bits/8 bytes, plus the
// queries and the output.  At b=64, m=320, d'=1024 that is 10.5 MB of
// 4-bit rows (3.1 us at 3.35 TB/s) or 5.2 MB of 2-bit rows (1.6 us) against
// 21 M f32 FMAs (0.3 us at 67 TFLOP/s): bytes bound it.  Each row is read
// once.  The launch holds few warps (b m / 32), so what the kernel costs
// beyond the bound is latency: of its row loads, which it overlaps eight at
// a time, and of its one dependent chain of d FMAs per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgather_dot.so gather_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // candidates per block, one per thread
constexpr int KC = 1024;        // query dims staged in shared memory per step

template <int kBits, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* __restrict__ packed, int64_t code_stride,
              const float* __restrict__ q, int64_t q_stride,
              const int32_t* __restrict__ cand,
              const float* __restrict__ lut_g,
              float* __restrict__ out,
              int b, int m, int n, int d) {
    constexpr int kCodes = 8 / kBits;          // codes per byte
    constexpr int kMask = (1 << kBits) - 1;
    constexpr int kLevels = 1 << kBits;
    constexpr int kVecDims = 16 * kCodes;      // dims per 16-byte load

    __shared__ __align__(16) float qs[KC];
    __shared__ float lut[kLevels];

    const int tid = threadIdx.x;
    const int qi = blockIdx.y;
    const int i = blockIdx.x * kThreads + tid;
    if (tid < kLevels) lut[tid] = lut_g[tid];

    const int row = i < m ? cand[static_cast<int64_t>(qi) * m + i] : -1;
    const bool valid = row >= 0 && row < n;
    const uint8_t* prow = packed + static_cast<int64_t>(valid ? row : 0) * code_stride;
    const float* qrow = q + static_cast<int64_t>(qi) * q_stride;

    float acc = 0.0f;
    for (int k0 = 0; k0 < d; k0 += KC) {
        const int kc = min(KC, d - k0);
        __syncthreads();   // the previous chunk is consumed
        for (int t = tid; t < kc; t += kThreads) qs[t] = qrow[k0 + t];
        __syncthreads();
        if (!valid) continue;
        if (kVec) {
            // Issue the loads of 8 vectors before their FMAs, so a thread
            // waits on memory once per 8 vectors, not once per vector.
            const uint4* src = reinterpret_cast<const uint4*>(prow + k0 / kCodes);
            const int nu = kc / kVecDims;
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
                            const int dim = kVecDims * (u0 + g) + (4 * e + j) * kCodes;
#pragma unroll
                            for (int c = 0; c < kCodes; ++c)
                                acc = fmaf(qs[dim + c], lut[(byte >> (kBits * c)) & kMask],
                                           acc);
                        }
                }
            }
        } else {
            for (int t = 0; t < kc / kCodes; ++t) {
                const uint32_t byte = prow[k0 / kCodes + t];
#pragma unroll
                for (int c = 0; c < kCodes; ++c)
                    acc = fmaf(qs[kCodes * t + c], lut[(byte >> (kBits * c)) & kMask], acc);
            }
        }
    }
    if (i < m) out[static_cast<int64_t>(qi) * m + i] = valid ? acc : 0.0f;
}

template <int kBits>
int launch_gather(const uint8_t* packed, int64_t code_stride, const float* q,
                  int64_t q_stride, const int32_t* cand, const float* lut, float* out,
                  int b, int m, int n, int d, int device, void* stream) {
    constexpr int kCodes = 8 / kBits;
    if (d < kCodes || d % kCodes || code_stride < d / kCodes || q_stride < d ||
        b > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || m == 0) return 0;
    const dim3 grid((m + kThreads - 1) / kThreads, b);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % (16 * kCodes) == 0 &&
                     reinterpret_cast<uintptr_t>(packed) % 16 == 0 && code_stride % 16 == 0;
    if (vec) {
        gather_kernel<kBits, true><<<grid, kThreads, 0, s>>>(packed, code_stride, q, q_stride,
                                                             cand, lut, out, b, m, n, d);
    } else {
        gather_kernel<kBits, false><<<grid, kThreads, 0, s>>>(packed, code_stride, q,
                                                              q_stride, cand, lut, out, b, m,
                                                              n, d);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* gather_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// packed: n rows of d/2 u8 codes, code_stride bytes apart; q: b rows of d
// f32, q_stride floats apart; cand: [b, m] i32 and out: [b, m] f32,
// contiguous; lut: [16] f32; all on `device`; d even, b <= 65535.  Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int gather_nibble_dot(const uint8_t* packed, int64_t code_stride, const float* q,
                                 int64_t q_stride, const int32_t* cand, const float* lut,
                                 float* out, int b, int m, int n, int d, int device,
                                 void* stream) {
    return launch_gather<4>(packed, code_stride, q, q_stride, cand, lut, out, b, m, n, d,
                            device, stream);
}

// As gather_nibble_dot for 2-bit codes: rows of d/4 u8, lut: [4] f32; d % 4 == 0.
extern "C" int gather_crumb_dot(const uint8_t* packed, int64_t code_stride, const float* q,
                                int64_t q_stride, const int32_t* cand, const float* lut,
                                float* out, int b, int m, int n, int d, int device,
                                void* stream) {
    return launch_gather<2>(packed, code_stride, q, q_stride, cand, lut, out, b, m, n, d,
                            device, stream);
}
