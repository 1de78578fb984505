// Raw asymmetric full scans: out[b, n] = <q[b], deq(packed[n])>, for 4-bit
// and 2-bit codes.
//
// nibble_dot: Replaces the Pallas kernel src/repro/kernels/nibble_dot.py::_nibble_dot_kernel
// (launched by nibble_dot_raw): byte i of a row holds code 2i in its low
// nibble and code 2i+1 in its high nibble; deq maps a code through the 16
// Lloyd-Max centroids.
// crumb_dot: Replaces the Pallas kernel src/repro/kernels/nibble_dot.py::_crumb_dot_kernel
// (launched by crumb_dot_raw): byte i holds code 4i+s in bits 2s..2s+1
// ("crumbs"); deq maps a code through the 4 Lloyd-Max centroids.
// The TPU kernels split the query into 2 or 4 de-interleaved planes to suit
// its lane layout; these kernels read q[k] in place, so the wrapper passes
// the rotated query as it is.
//
// Strides: rows of `packed` lie code_stride bytes apart and rows of `q`
// q_stride floats apart, so the two blocks of a mixed corpus
// ([n4/2 bytes of nibbles | (d'-n4)/4 bytes of crumbs] per row) are scanned
// as column views of one tensor, with no copy.
//
// Design: one block computes a 64-query x 128-row tile.  Each step loads 32
// dims of both operands into shared memory, dequantizing the codes through
// a 16- or 4-float table on the way, and every thread then updates a 4 x 8
// register tile with f32 FMAs on the CUDA cores (no TF32 tensor cores: they
// would change the numbers).  A step reads 16 bytes of a 4-bit row or 8 of
// a 2-bit row, split between two loader threads.
//
// Determinism: every score is ONE f32 accumulator updated with k ascending
// over 0..d-1.  No atomics, no split-K, so a score depends only on its query
// row and corpus row, never on b or on which queries share the launch, and
// the gathered kernels of gather_dot.cu, which keep the same order, give
// the same bytes.  A ragged n or b is masked inside the kernel.
//
// Loads: the kVec instance reads codes in 8-byte (4-bit) or 4-byte (2-bit)
// words and queries in 16-byte vectors; the entry points launch it where
// d % 32 == 0 and the pointers and strides are aligned for those loads.
// Otherwise (d < 32, or a block that starts or strides off alignment, as
// the small mixed splits do) the same arithmetic runs with bounds-checked
// scalar loads.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: 2 b n d' flops against (n d' bits/8 + 4 b d' + 4 b n)
// bytes.  At b=64, n=45000, d'=1024 that is 5.90 GFLOP (88 us at 67 TFLOP/s
// of non-tensor f32) against 34.8 MB (4-bit, 10 us at 3.35 TB/s) or 23.3 MB
// (2-bit, 7 us): both compute-bound, so 2 bits buy memory, not time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnibble_dot.so nibble_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BN = 128;   // corpus rows per block
constexpr int BK = 32;    // dims per shared-memory step
constexpr int TQ = 4;     // queries per thread
constexpr int TN = 8;     // corpus rows per thread: columns tx*4+j and 64+tx*4+j
constexpr int kThreads = (BQ / TQ) * (BN / TN);   // 256

template <int kBits, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint8_t* __restrict__ packed, int64_t code_stride,
            const float* __restrict__ q, int64_t q_stride,
            const float* __restrict__ lut_g,
            float* __restrict__ out,
            int b, int n, int d) {
    constexpr int kCodes = 8 / kBits;              // codes per byte
    constexpr int kMask = (1 << kBits) - 1;
    constexpr int kLevels = 1 << kBits;
    constexpr int kPart = BK / kCodes / 2;         // bytes a loader thread reads per step

    __shared__ __align__(16) float qs[BK][BQ];
    __shared__ __align__(16) float cs[BK][BN];
    __shared__ float lut[kLevels];

    const int tid = threadIdx.x;
    if (tid < kLevels) lut[tid] = lut_g[tid];

    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * BQ;
    const int tx = tid % (BN / TN);     // 0..15
    const int ty = tid / (BN / TN);     // 0..15
    const int dk = d / kCodes;          // packed bytes per row

    // Loader roles: corpus row c_row, bytes [c_part*kPart, +kPart) of the
    // step (dims [c_part*16, +16)); query row q_row, dims [q_part*8, +8).
    const int c_row = tid % BN;
    const int c_part = tid / BN;
    const int q_row = tid / 4;
    const int q_part = tid % 4;
    const int gr = n0 + c_row;
    const int gq = q0 + q_row;
    const uint8_t* prow = packed + static_cast<int64_t>(gr) * code_stride;
    const float* qrow = q + static_cast<int64_t>(gq) * q_stride;

    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    __syncthreads();   // the table is in shared memory

    for (int k0 = 0; k0 < d; k0 += BK) {
        // ---- corpus: kPart bytes -> 16 dequantized dims, stored [dim][row]
        const int kb = k0 / kCodes + c_part * kPart;
        uint8_t bytes[kPart];
        bool valid[kPart];
        if (kVec) {
            uint32_t w[2] = {0u, 0u};
            if (gr < n) {
                if constexpr (kPart == 8) {
                    const uint2 v = *reinterpret_cast<const uint2*>(prow + kb);
                    w[0] = v.x;
                    w[1] = v.y;
                } else {
                    w[0] = *reinterpret_cast<const uint32_t*>(prow + kb);
                }
            }
#pragma unroll
            for (int j = 0; j < kPart; ++j) {
                bytes[j] = static_cast<uint8_t>(w[j / 4] >> (8 * (j % 4)));
                valid[j] = gr < n;
            }
        } else {
#pragma unroll
            for (int j = 0; j < kPart; ++j) {
                valid[j] = gr < n && kb + j < dk;
                bytes[j] = valid[j] ? prow[kb + j] : 0;
            }
        }
#pragma unroll
        for (int j = 0; j < kPart; ++j)
#pragma unroll
            for (int c = 0; c < kCodes; ++c) {
                const int dim = c_part * (BK / 2) + j * kCodes + c;
                cs[dim][c_row] = valid[j] ? lut[(bytes[j] >> (kBits * c)) & kMask] : 0.0f;
            }

        // ---- queries: 8 dims, stored [dim][query]
        const int kq = k0 + q_part * 8;
        if (kVec) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            float4 c = a;
            if (gq < b) {
                a = *reinterpret_cast<const float4*>(qrow + kq);
                c = *reinterpret_cast<const float4*>(qrow + kq + 4);
            }
            const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) qs[q_part * 8 + j][q_row] = v[j];
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                qs[q_part * 8 + j][q_row] = (gq < b && kq + j < d) ? qrow[kq + j] : 0.0f;
            }
        }
        __syncthreads();

#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&qs[k][ty * TQ]);
            const float4 c0 = *reinterpret_cast<const float4*>(&cs[k][tx * 4]);
            const float4 c1 = *reinterpret_cast<const float4*>(&cs[k][64 + tx * 4]);
            const float av[TQ] = {a.x, a.y, a.z, a.w};
            const float cv[TN] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        const int row = q0 + ty * TQ + i;
        if (row >= b) continue;
        float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (col < n) orow[col] = acc[i][j];
        }
    }
}

bool aligned(const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kBits>
int launch_scan(const uint8_t* packed, int64_t code_stride, const float* q,
                int64_t q_stride, const float* lut, float* out, int b, int n, int d,
                int device, void* stream) {
    constexpr int kCodes = 8 / kBits;
    constexpr int kWord = BK / kCodes / 2;   // bytes of one code load in the kVec instance
    if (d < kCodes || d % kCodes || code_stride < d / kCodes || q_stride < d) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    const dim3 grid((n + BN - 1) / BN, (b + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % BK == 0 && aligned(packed, kWord) && code_stride % kWord == 0 &&
                     aligned(q, 16) && q_stride % 4 == 0;
    if (vec) {
        scan_kernel<kBits, true><<<grid, kThreads, 0, s>>>(packed, code_stride, q, q_stride,
                                                           lut, out, b, n, d);
    } else {
        scan_kernel<kBits, false><<<grid, kThreads, 0, s>>>(packed, code_stride, q, q_stride,
                                                            lut, out, b, n, d);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* nibble_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// packed: n rows of d/2 u8 codes, code_stride bytes apart; q: b rows of d
// f32, q_stride floats apart; lut: [16] f32; out: [b, n] f32 contiguous; all
// on `device`; d even.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int nibble_dot(const uint8_t* packed, int64_t code_stride, const float* q,
                          int64_t q_stride, const float* lut, float* out, int b, int n,
                          int d, int device, void* stream) {
    return launch_scan<4>(packed, code_stride, q, q_stride, lut, out, b, n, d, device,
                          stream);
}

// As nibble_dot for 2-bit codes: n rows of d/4 u8, lut: [4] f32; d % 4 == 0.
extern "C" int crumb_dot(const uint8_t* packed, int64_t code_stride, const float* q,
                         int64_t q_stride, const float* lut, float* out, int b, int n,
                         int d, int device, void* stream) {
    return launch_scan<2>(packed, code_stride, q, q_stride, lut, out, b, n, d, device,
                          stream);
}
