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
// The numbers: every score is ONE f32 accumulator that starts at 0.0f and
// is updated as fmaf(q[k], lut[code_k], acc) for k = 0..d-1 ascending.  No
// split-K, no atomics, no tensor cores, so a score depends only on its
// query row and corpus row, never on b, n or the tile it falls in.  The
// gathered rescores of gather_dot.cu run the same chain, which is why a
// cascade returns the full scan's scores byte for byte; a change of order
// here would have to be made there in the same change.  Dims past d in the
// last step have q = 0, and fmaf(0, x, acc) == acc (the accumulator is
// never -0).
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: 2 b n d' flops against (n d' bits/8 + 4 b d' + 4 b n)
// bytes.  At b=64, n=45000, d'=1024 that is 5.90 GFLOP (88 us at 67 TFLOP/s
// of non-tensor f32) against 34.8 MB (4-bit, 10 us at 3.35 TB/s) or 23.3 MB
// (2-bit, 7 us): both bound by the f32 FMA rate, so 2 bits buy memory, not
// time, and the design is about keeping the FMA pipes issuing.
//
// Design.  A block of 128 threads computes a 64-query x 128-row tile and at
// most 3 blocks share an SM (registers capped at 168 a thread, 69 KB of
// shared memory a block), so the 352 tiles of the main shape run in one
// wave on 132 SMs.  d' is walked in steps of 32 dims:
//   - a ring of 3 stages in shared memory is filled with cp.async: thread t
//     copies row t's 16 (4-bit) or 8 (2-bit) code bytes of a step and 4 of
//     the step's 512 16-byte query chunks, so two steps are in flight while
//     this step's FMAs run;
//   - each thread decodes the code bytes it copied itself (its own
//     cp.async.wait makes them visible to it) through the 16- or 4-float
//     table into a double-buffered f32 level tile, stored [row][dim] with
//     16-byte stores, so every code is decoded once a block and its level
//     serves all 64 queries;
//   - one barrier a step publishes the next step's levels and queries;
//   - each thread holds an 8 x 8 register tile (queries ty + 8i, rows
//     tx + 16j).  Per 4 dims it reads 8 query and 8 level vectors of 4
//     dims (16-byte loads; rows padded to 36 floats, so the 8 rows a
//     quarter-warp reads cover the 32 banks once) and runs 256 FMAs.
// The output leaves in 64-byte coalesced runs of a row.  Where d % 32 != 0,
// d < 32, or a pointer or stride is off a load's alignment (the small mixed
// splits), the same kernel's scalar instance fills the ring with
// bounds-checked synchronous loads instead of cp.async; the steps, the
// decode and the chain are the same.
//
// What holds it below the bound (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
// ablation probes (not kept) found the FMA loop itself, with its operands
// already in registers, issuing well below the f32 rate (register-file
// bank conflicts left by ptxas's allocation, which CUDA C does not
// control), and at n=45000 the 352 tiles fill 3 of an SM's slots on 88 SMs
// and 2 on 44, so the time is that of 396 tiles (chip_smoke.py times both).
// The decode, the copies and the barrier cost less than either.
//
// Why not tensor cores: any mma/wgmma form sums products in the hardware's
// order, so the scores would change bits and the gathered kernels would
// have to move with them in the same change.  On the CUDA cores this
// kernel takes 0.157 ms (4-bit) and 0.159-0.160 ms (2-bit) of device time
// at b=64, n=45000, d'=1024, 55-56% of the f32 rate, against 0.19 ms for
// the single-buffered 64 x 128 kernel it replaced (chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700.00 W).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnibble_dot.so nibble_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BN = 128;      // corpus rows per block
constexpr int BK = 32;       // dims per pipeline step
constexpr int TQ = 8;        // queries per thread: ty + 8 i
constexpr int TN = 8;        // corpus rows per thread: tx + 16 j
constexpr int kThreads = (BQ / TQ) * (BN / TN);   // 128: one corpus row each to load
constexpr int kStages = 3;   // ring depth
constexpr int kMinBlocks = 3;  // resident blocks an SM: caps registers at 168
constexpr int RP = BK + 4;   // staged row of a step, floats (padded against bank conflicts)
constexpr int kQueryChunks = BQ * BK / 4 / kThreads;   // 16-byte query chunks a thread copies
static_assert(kThreads == BN, "each thread copies and decodes one corpus row");

template <int kBits>
struct Layout {
    static constexpr int kCodes = 8 / kBits;           // codes per byte
    static constexpr int kMask = (1 << kBits) - 1;
    static constexpr int kLevels = 1 << kBits;
    static constexpr int kRowBytes = BK / kCodes;      // code bytes of a row a step: 16 or 8
    static constexpr int kQFloats = kStages * BQ * RP;
    static constexpr int kCFloats = 2 * BN * RP;
    static constexpr int kRawBytes = kStages * BN * kRowBytes;
    static constexpr int kSmemBytes = 4 * (kQFloats + kCFloats) + kRawBytes + 4 * kLevels;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of kBytes (16 or 8) from global to shared memory;
// with valid false nothing is read and the destination is zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const int n = valid ? kBytes : 0;
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

template <int kBits, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const uint8_t* __restrict__ packed, int64_t code_stride,
            const float* __restrict__ q, int64_t q_stride,
            const float* __restrict__ lut_g,
            float* __restrict__ out,
            int b, int n, int d) {
    using L = Layout<kBits>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);               // [kStages][BQ][RP] queries
    float* cs = qs + L::kQFloats;                             // [2][BN][RP] decoded levels
    uint8_t* raw = reinterpret_cast<uint8_t*>(cs + L::kCFloats);   // [kStages][BN][kRowBytes]
    float* lut = reinterpret_cast<float*>(raw + L::kRawBytes);

    const int tid = threadIdx.x;
    if (tid < L::kLevels) lut[tid] = lut_g[tid];

    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * BQ;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);     // 0..7
    const int dk = d / L::kCodes;       // packed bytes per row
    const int steps = (d + BK - 1) / BK;

    // Loader role: corpus row n0 + tid.  A row past n is never read (its
    // copies zero-fill from row 0's address) and its column is not written.
    const bool row_ok = n0 + tid < n;
    const uint8_t* prow = packed + static_cast<int64_t>(row_ok ? n0 + tid : 0) * code_stride;

    // Fill ring slot s % kStages with step s: this thread's code bytes and
    // query chunks.  Every call commits one cp.async group (empty past the
    // last step), so the wait below always counts the same groups.
    auto copy_step = [&](int s) {
        if (s < steps) {
            const int slot = s % kStages;
            const int k0 = s * BK;
            const int kb = k0 / L::kCodes;
            uint8_t* craw = raw + (slot * BN + tid) * L::kRowBytes;
            if constexpr (kVec) {
                cp_async<L::kRowBytes>(craw, prow + kb, row_ok);
            } else {
#pragma unroll
                for (int j = 0; j < L::kRowBytes; ++j) {
                    craw[j] = (row_ok && kb + j < dk) ? prow[kb + j] : 0;
                }
            }
            float* qslot = qs + slot * BQ * RP;
#pragma unroll
            for (int r = 0; r < kQueryChunks; ++r) {
                const int c = tid + kThreads * r;
                const int qr = c / (BK / 4);
                const int kq = k0 + (c % (BK / 4)) * 4;
                const int gq = q0 + qr;
                float* dst = qslot + qr * RP + (c % (BK / 4)) * 4;
                const float* src = q + static_cast<int64_t>(gq < b ? gq : 0) * q_stride + kq;
                if constexpr (kVec) {
                    cp_async<16>(dst, src, gq < b);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) dst[e] = (gq < b && kq + e < d) ? src[e] : 0.0f;
                }
            }
        }
        cp_async_commit();
    };

    // Decode this thread's code bytes of step s into row tid of level tile
    // s & 1 (stored [row][dim], four dims a 16-byte store).
    auto decode = [&](int s) {
        const uint8_t* craw = raw + ((s % kStages) * BN + tid) * L::kRowBytes;
        uint32_t w[L::kRowBytes / 4];
        if constexpr (L::kRowBytes == 16) {
            const uint4 x = *reinterpret_cast<const uint4*>(craw);
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
        } else {
            const uint2 x = *reinterpret_cast<const uint2*>(craw);
            w[0] = x.x; w[1] = x.y;
        }
        float level[BK];
#pragma unroll
        for (int j = 0; j < L::kRowBytes; ++j) {
#pragma unroll
            for (int c = 0; c < L::kCodes; ++c) {
                level[j * L::kCodes + c] = lut[(w[j / 4] >> (8 * (j % 4) + kBits * c)) & L::kMask];
            }
        }
        float* crow = cs + (s & 1) * BN * RP + tid * RP;
#pragma unroll
        for (int m = 0; m < BK / 4; ++m) {
            *reinterpret_cast<float4*>(crow + 4 * m) =
                make_float4(level[4 * m], level[4 * m + 1], level[4 * m + 2], level[4 * m + 3]);
        }
    };

    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    __syncthreads();   // the table is in shared memory
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) copy_step(s);
    cp_async_wait<kStages - 2>();    // step 0 has landed
    decode(0);
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
        // Slot (t-1) % kStages is free: its queries were read by the FMAs of
        // step t-1 and its codes decoded before them, all before the last
        // barrier.  Level tile (t+1) & 1 was last read by step t-1's FMAs.
        copy_step(t + kStages - 1);
        cp_async_wait<kStages - 2>();    // this thread's copies of step t+1 have landed
        if (t + 1 < steps) decode(t + 1);

        const float* qslot = qs + (t % kStages) * BQ * RP;
        const float* cbuf = cs + (t & 1) * BN * RP;
#pragma unroll 4
        for (int k4 = 0; k4 < BK; k4 += 4) {
            float4 a[TQ], c[TN];
#pragma unroll
            for (int i = 0; i < TQ; ++i) {
                a[i] = *reinterpret_cast<const float4*>(qslot + (ty + BQ / TQ * i) * RP + k4);
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                c[j] = *reinterpret_cast<const float4*>(cbuf + (tx + BN / TN * j) * RP + k4);
            }
            // Dim k4 for every (query, row) pair, then k4 + 1, k4 + 2, k4 + 3.
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, c[j].x, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, c[j].y, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, c[j].z, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, c[j].w, acc[i][j]);
        }
        __syncthreads();   // step t+1's level tile and queries are visible to all
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        const int row = q0 + ty + BQ / TQ * i;
        if (row >= b) continue;
        float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = n0 + tx + BN / TN * j;
            if (col < n) orow[col] = acc[i][j];
        }
    }
}

bool aligned(const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Opts an instance into its dynamic shared memory (above the 48 KB default)
// and the largest shared-memory carveout, once per device.
template <int kBits, bool kVec>
cudaError_t configure(int device) {
    constexpr int kDevices = 64;
    static bool done[kDevices] = {};
    if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
    auto kernel = scan_kernel<kBits, kVec>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<kBits>::kSmemBytes);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
    return err;
}

template <int kBits, bool kVec>
cudaError_t launch(const dim3& grid, cudaStream_t s, int device, const uint8_t* packed,
                   int64_t code_stride, const float* q, int64_t q_stride, const float* lut,
                   float* out, int b, int n, int d) {
    cudaError_t err = configure<kBits, kVec>(device);
    if (err != cudaSuccess) return err;
    scan_kernel<kBits, kVec><<<grid, kThreads, Layout<kBits>::kSmemBytes, s>>>(
        packed, code_stride, q, q_stride, lut, out, b, n, d);
    return cudaGetLastError();
}

template <int kBits>
int launch_scan(const uint8_t* packed, int64_t code_stride, const float* q,
                int64_t q_stride, const float* lut, float* out, int b, int n, int d,
                int device, void* stream) {
    constexpr int kCodes = 8 / kBits;
    constexpr int kRowBytes = Layout<kBits>::kRowBytes;   // one cp.async of codes
    if (d < kCodes || d % kCodes || code_stride < d / kCodes || q_stride < d) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    const dim3 grid((n + BN - 1) / BN, (b + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % BK == 0 && aligned(packed, kRowBytes) && code_stride % kRowBytes == 0 &&
                     aligned(q, 16) && q_stride % 4 == 0;
    err = vec ? launch<kBits, true>(grid, s, device, packed, code_stride, q, q_stride, lut,
                                    out, b, n, d)
              : launch<kBits, false>(grid, s, device, packed, code_stride, q, q_stride, lut,
                                     out, b, n, d);
    return static_cast<int>(err);
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
