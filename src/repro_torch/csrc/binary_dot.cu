// Binarized coarse-scan proxies (the cascade's first stage): int32 [b, n].
//
// Replaces the Pallas kernel src/repro/kernels/binary_dot.py::_sign_hamming_kernel
// (launched by sign_hamming_raw) and the Pallas kernel ::_crumb_cross_kernel
// of the same file (launched by crumb_affinity_raw, which adds the rank-1
// terms of _crumb_corrections outside its grid; here the epilogue adds them).
//
//   sign:  out[q, r] = popcount(qbits[q] ^ cbits[r])            (Hamming distance)
//   crumb: out[q, r] = 16 pc(qH & cH) + 8 pc(qH & cL) + 8 pc(qL & cH) + 4 pc(qL & cL)
//                      + 9 d' - 12 pc(qH) - 6 pc(qL) - 12 pc(cH) - 6 pc(cL)
//
// A sign row is d'/8 bytes; a crumb row is its hi bit plane then its lo bit
// plane, d'/8 bytes each (core/binary.py).  Zero bytes past a plane's end
// XOR and AND to 0 and so add nothing; the constant is 9 d' exactly.
//
// Design: one block computes a 64-query x 128-row tile.  Each step stages 8
// 32-bit words of each plane of both operands in shared memory, and every
// thread updates a 4 x 8 register tile with XOR/AND + __popc, accumulating
// in int32.  Each word loaded from shared memory feeds 4 or 8 popcounts.
// Output columns are tx + 16 j, so neighbouring threads store neighbouring
// ints of a row.  The crumb kernel's per-row and per-query popcounts are
// summed by threads 0..191 from the staged words, and the epilogue adds
// them.  Integer sums are exact in any order, so the result equals the
// plain version bit for bit.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: each proxy is an exact int8 dot product (sign: the +-1
// planes give d' - 2 hamming; crumb: the levels {-3, -1, 1, 3}), 2 b n d'
// operations that the tensor cores run at 1979 TOP/s.  At b=64, n=45000,
// d'=1024 that is 3.0 us against 17.3 MB (sign) or 23.0 MB (crumb) of codes
// and int32 output, 5.2 us and 6.9 us at 3.35 TB/s: bytes bound both.  This
// kernel does not reach that bound.  It runs on the CUDA cores, where
// __popc issues at 16 per clock per SM (CUDA C++ Programming Guide,
// arithmetic instruction throughput, compute capability 9.0): 132 x 16 x
// 1.98 GHz = 4.18e12 per second, so the sign proxy's b n d'/32 = 92.2 M
// popcounts take at least 22 us and the crumb proxy's four times as many
// 88 us.  The register tile keeps the shared-memory reads and the XOR/AND/
// add work below the popcount rate; an int8 or binary tensor-core (mma
// AND+popc) formulation is what would approach the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbinary_dot.so binary_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BN = 128;   // corpus rows per block
constexpr int BW = 8;     // 32-bit words of each plane per step (32 bytes)
constexpr int TQ = 4;     // queries per thread
constexpr int TN = 8;     // corpus rows per thread: columns tx + 16 j
constexpr int kThreads = (BQ / TQ) * (BN / TN);   // 256

// Word w of a plane of `nbytes` bytes, assembled byte by byte, zero past
// its end (planes of 1 or 2 bytes, or rows not aligned to 4 bytes).
__device__ __forceinline__ uint32_t word_at(const uint8_t* plane, int w, int nbytes) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int i = 4 * w + j;
        if (i < nbytes) v |= static_cast<uint32_t>(plane[i]) << (8 * j);
    }
    return v;
}

// Stage words [w0, w0 + 8) of every plane of `row` (nullptr = zero row):
// this thread's half (4 words) of them, stored as dst[plane][word][slot].
// kVec: the plane is a multiple of 32 bytes and 16-byte aligned, so each
// half is one 16-byte load.
template <int kPlanes, bool kVec, int kStride>
__device__ __forceinline__ void stage(uint32_t (*dst)[BW][kStride], const uint8_t* row,
                                      int slot, int half, int w0, int dkp) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (row != nullptr) {
            const uint8_t* plane = row + static_cast<int64_t>(p) * dkp;
            if (kVec) {
                const uint4 u = *reinterpret_cast<const uint4*>(plane + 4 * w0 + 16 * half);
                v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) v[e] = word_at(plane, w0 + 4 * half + e, dkp);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[p][4 * half + e][slot] = v[e];
    }
}

// kPlanes = 1: sign Hamming distance; kPlanes = 2: crumb affinity.
template <int kPlanes, bool kVec>
__global__ void __launch_bounds__(kThreads)
binary_dot_kernel(const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ qcodes,
                  int32_t* __restrict__ out,
                  int b, int n, int dkp) {
    // Rows padded by 4 words, so the two halves of a staged row land in
    // other banks (and qs rows stay 16-byte aligned for the uint4 reads).
    __shared__ uint32_t cs[kPlanes][BW][BN + 4];
    __shared__ __align__(16) uint32_t qs[kPlanes][BW][BQ + 4];
    __shared__ int32_t row_corr[BN];
    __shared__ int32_t query_corr[BQ];

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * BQ;
    const int tx = tid % 16;              // columns tx + 16 j
    const int ty = tid / 16;              // queries ty * 4 + i
    const int64_t row_bytes = static_cast<int64_t>(kPlanes) * dkp;
    const int words = (dkp + 3) / 4;      // words per plane
    const bool active = q0 + ty * TQ < b; // a warp past the last query skips the math

    // Loader roles: corpus row c_slot, query row q_slot (threads < 128), half.
    const int c_slot = tid / 2;
    const int half = tid % 2;
    const int q_slot = tid / 2;
    const uint8_t* crow = n0 + c_slot < n ? codes + (n0 + c_slot) * row_bytes : nullptr;
    const uint8_t* qrow = q0 + q_slot < b ? qcodes + (q0 + q_slot) * row_bytes : nullptr;

    int32_t acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    int32_t corr = 0;   // crumb: this thread's row (tid < 128) or query (128..191) term

    for (int w0 = 0; w0 < words; w0 += BW) {
        stage<kPlanes, kVec, BN + 4>(cs, crow, c_slot, half, w0, dkp);
        if (tid < 2 * BQ) stage<kPlanes, kVec, BQ + 4>(qs, qrow, q_slot, half, w0, dkp);
        __syncthreads();

        if constexpr (kPlanes == 2) {
            if (tid < BN) {
#pragma unroll
                for (int w = 0; w < BW; ++w)
                    corr += 12 * __popc(cs[0][w][tid]) + 6 * __popc(cs[1][w][tid]);
            } else if (tid < BN + BQ) {
#pragma unroll
                for (int w = 0; w < BW; ++w)
                    corr += 12 * __popc(qs[0][w][tid - BN]) + 6 * __popc(qs[1][w][tid - BN]);
            }
        }

        if (active) {
#pragma unroll
            for (int w = 0; w < BW; ++w) {
                uint32_t a[kPlanes][TQ], c[kPlanes][TN];
#pragma unroll
                for (int p = 0; p < kPlanes; ++p) {
                    const uint4 av = *reinterpret_cast<const uint4*>(&qs[p][w][ty * TQ]);
                    a[p][0] = av.x; a[p][1] = av.y; a[p][2] = av.z; a[p][3] = av.w;
#pragma unroll
                    for (int j = 0; j < TN; ++j) c[p][j] = cs[p][w][tx + 16 * j];
                }
#pragma unroll
                for (int i = 0; i < TQ; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) {
                        if constexpr (kPlanes == 1) {
                            acc[i][j] += __popc(a[0][i] ^ c[0][j]);
                        } else {
                            acc[i][j] += 16 * __popc(a[0][i] & c[0][j])
                                       + 8 * (__popc(a[0][i] & c[1][j]) + __popc(a[1][i] & c[0][j]))
                                       + 4 * __popc(a[1][i] & c[1][j]);
                        }
                    }
            }
        }
        __syncthreads();
    }

    if constexpr (kPlanes == 2) {
        if (tid < BN) row_corr[tid] = corr;
        else if (tid < BN + BQ) query_corr[tid - BN] = corr;
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        const int q = q0 + ty * TQ + i;
        if (q >= b) continue;
        int32_t* orow = out + static_cast<int64_t>(q) * n;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = n0 + tx + 16 * j;
            if (col >= n) continue;
            int32_t v = acc[i][j];
            if constexpr (kPlanes == 2)
                v += 9 * 8 * dkp - query_corr[ty * TQ + i] - row_corr[tx + 16 * j];
            orow[col] = v;
        }
    }
}

template <int kPlanes>
int launch(const uint8_t* codes, const uint8_t* qcodes, int32_t* out, int b, int n,
           int dkp, int device, void* stream) {
    if (dkp < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    const dim3 grid((n + BN - 1) / BN, (b + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dkp % (4 * BW) == 0) {
        binary_dot_kernel<kPlanes, true><<<grid, kThreads, 0, s>>>(codes, qcodes, out, b, n, dkp);
    } else {
        binary_dot_kernel<kPlanes, false><<<grid, kThreads, 0, s>>>(codes, qcodes, out, b, n, dkp);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* binary_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cbits: [n, dk] u8, qbits: [b, dk] u8, out: [b, n] i32, all contiguous on
// `device`, the codes 16-byte aligned.  Returns cudaGetLastError() (0 = ok).
extern "C" int sign_hamming(const uint8_t* cbits, const uint8_t* qbits, int32_t* out,
                            int b, int n, int dk, int device, void* stream) {
    return launch<1>(cbits, qbits, out, b, n, dk, device, stream);
}

// ccodes: [n, 2 dkp] u8 (hi plane || lo plane), qplanes: [b, 2 dkp] u8 in the
// same layout, out: [b, n] i32; d' = 8 dkp.  Same contract as sign_hamming.
extern "C" int crumb_affinity(const uint8_t* ccodes, const uint8_t* qplanes, int32_t* out,
                              int b, int n, int dkp, int device, void* stream) {
    return launch<2>(ccodes, qplanes, out, b, n, dkp, device, stream);
}
