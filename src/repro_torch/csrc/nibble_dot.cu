// Raw asymmetric 4-bit scan: out[b, n] = <q_rot[b], deq(packed[n])>.
//
// Replaces the Pallas kernel src/repro/kernels/nibble_dot.py::_nibble_dot_kernel
// (launched by nibble_dot_raw).  Byte i of a packed row holds code 2i in its
// low nibble and code 2i+1 in its high nibble; deq maps a code through the
// 16 Lloyd-Max centroids.  The TPU kernel splits the query into even/odd
// planes to suit its lane layout; this kernel reads q_rot[2i] and q_rot[2i+1]
// in place, so the wrapper passes the rotated query as it is.
//
// Design: one block computes a 64-query x 128-row tile.  Each step loads 32
// dims of both operands into shared memory, dequantizing the codes through a
// 16-float table on the way, and every thread then updates a 4 x 8 register
// tile with f32 FMAs on the CUDA cores (no TF32 tensor cores: they would
// change the numbers).
//
// Determinism: every score is ONE f32 accumulator updated with k ascending
// over 0..d'-1.  No atomics, no split-K, so a score depends only on its query
// row and corpus row, never on b or on which queries share the launch.  A
// ragged n or b is masked inside the kernel.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: 2 b n d' flops against (n d'/2 + 4 b d' + 4 b n)
// bytes.  At b=64, n=45000, d'=1024 that is 5.90 GFLOP (88 us at 67 TFLOP/s
// of non-tensor f32) against 34.8 MB (10 us at 3.35 TB/s): compute-bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnibble_dot.so nibble_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BN = 128;   // corpus rows per block
constexpr int BK = 32;    // dims per shared-memory step (16 packed bytes)
constexpr int TQ = 4;     // queries per thread
constexpr int TN = 8;     // corpus rows per thread: columns tx*4+j and 64+tx*4+j
constexpr int kThreads = (BQ / TQ) * (BN / TN);   // 256

// kFull: d' is a multiple of BK, so every step is a whole tile in k and the
// loads can be vectorized.  Otherwise (d' < 32) each element is bounds-checked.
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
nibble_dot_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ q,
                  const float* __restrict__ lut_g,
                  float* __restrict__ out,
                  int b, int n, int d_pad) {
    __shared__ __align__(16) float qs[BK][BQ];
    __shared__ __align__(16) float cs[BK][BN];
    __shared__ float lut[16];

    const int tid = threadIdx.x;
    if (tid < 16) lut[tid] = lut_g[tid];

    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * BQ;
    const int tx = tid % (BN / TN);     // 0..15
    const int ty = tid / (BN / TN);     // 0..15
    const int dk = d_pad / 2;           // packed bytes per row

    // Loader roles: corpus row c_row, bytes [c_part*8, c_part*8+8) of the step;
    // query row q_row, dims [q_part*8, q_part*8+8) of the step.
    const int c_row = tid % BN;
    const int c_part = tid / BN;
    const int q_row = tid / 4;
    const int q_part = tid % 4;
    const int gr = n0 + c_row;
    const int gq = q0 + q_row;
    const uint8_t* prow = packed + static_cast<int64_t>(gr) * dk;
    const float* qrow = q + static_cast<int64_t>(gq) * d_pad;

    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    __syncthreads();   // the table is in shared memory

    for (int k0 = 0; k0 < d_pad; k0 += BK) {
        // ---- corpus: 8 bytes -> 16 dequantized dims, stored [dim][row]
        const int kb = k0 / 2 + c_part * 8;
        uint8_t bytes[8];
        bool valid[8];
        if (kFull) {
            uint2 v = make_uint2(0u, 0u);
            if (gr < n) v = *reinterpret_cast<const uint2*>(prow + kb);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                bytes[j] = static_cast<uint8_t>(v.x >> (8 * j));
                bytes[4 + j] = static_cast<uint8_t>(v.y >> (8 * j));
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) valid[j] = gr < n;
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                valid[j] = gr < n && kb + j < dk;
                bytes[j] = valid[j] ? prow[kb + j] : 0;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int dim = c_part * 16 + 2 * j;
            cs[dim][c_row] = valid[j] ? lut[bytes[j] & 15] : 0.0f;
            cs[dim + 1][c_row] = valid[j] ? lut[bytes[j] >> 4] : 0.0f;
        }

        // ---- queries: 8 dims, stored [dim][query]
        const int kq = k0 + q_part * 8;
        if (kFull) {
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
                qs[q_part * 8 + j][q_row] =
                    (gq < b && kq + j < d_pad) ? qrow[kq + j] : 0.0f;
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

}  // namespace

extern "C" const char* nibble_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// packed: [n, d_pad/2] u8, q: [b, d_pad] f32, lut: [16] f32, out: [b, n] f32,
// all contiguous on `device`, packed and q 16-byte aligned; d_pad even.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int nibble_dot(const uint8_t* packed, const float* q, const float* lut,
                          float* out, int b, int n, int d_pad, int device,
                          void* stream) {
    if (d_pad < 2 || (d_pad & 1)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    const dim3 grid((n + BN - 1) / BN, (b + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d_pad % BK == 0) {
        nibble_dot_kernel<true><<<grid, kThreads, 0, s>>>(packed, q, lut, out, b, n, d_pad);
    } else {
        nibble_dot_kernel<false><<<grid, kThreads, 0, s>>>(packed, q, lut, out, b, n, d_pad);
    }
    return static_cast<int>(cudaGetLastError());
}
