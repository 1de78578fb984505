// Binarized coarse-scan proxies (the cascade's first stage): int32 [b, n].
//
// Replaces the Pallas kernel src/repro/kernels/binary_dot.py::_sign_hamming_kernel
// (launched by sign_hamming_raw) and the Pallas kernel ::_crumb_cross_kernel
// of the same file (launched by crumb_affinity_raw, which adds the rank-1
// terms of _crumb_corrections outside its grid).
//
//   sign:  out[q, r] = popcount(qbits[q] ^ cbits[r])            (Hamming distance)
//   crumb: out[q, r] = sum_i L(q_i) L(c_i),  L = 4 hi + 2 lo - 3 in {-3, -1, 1, 3}
//
// A sign row is d'/8 bytes; a crumb row is its hi bit plane then its lo bit
// plane, d'/8 bytes each; bit j of byte k is dim 8k + j (core/binary.py).
// Expanding (4qH + 2qL - 3)(4cH + 2cL - 3) gives the reference's four
// weighted AND+popcounts plus _crumb_corrections term for term.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: each proxy is an exact int8 dot product (sign: the +-1
// planes give d' - 2 hamming; crumb: the levels), 2 b n d' operations that
// the tensor cores run at 1979 TOP/s.  At b=64, n=45000, d'=1024 that is
// 3.0 us against 17.3 MB (sign) or 23.0 MB (crumb) of codes and int32
// output, 5.2 us and 6.9 us at 3.35 TB/s: bytes bound both.
//
// Sign (sign_hamming): one block computes a 64-query x 128-row tile on the
// CUDA cores.  Each step stages 8 32-bit words of both operands in shared
// memory, and every thread updates a 4 x 8 register tile with XOR + __popc.
// Output columns are tx + 16 j, so neighbouring threads store neighbouring
// ints of a row.  __popc issues at 16 per clock per SM (CUDA C++
// Programming Guide, compute capability 9.0): the b n d'/32 = 92.2 M
// popcounts take at least 22 us, so this kernel does not reach the bound.
//
// Crumb (crumb_affinity): the tensor cores' AND + popc on the bit planes
// themselves.  The affinity is 16 pc(qH & cH) + 8 pc(qH & cL) + 8 pc(qL & cH)
// + 4 pc(qL & cL) + 9 d' - 12 pc(qH) - 6 pc(qL) - 12 pc(cH) - 6 pc(cL), and
// mma.sync m16n8k256 b1 (and.popc) gives each popcount for a 16 x 8 tile
// over 256 dims; nothing is decoded.  A block computes 64 queries x 128
// rows with 8 warps of 32 x 32 (64-row tiles at three blocks an SM were
// slower), over chunks of 256 dims:
//   * 16-byte cp.async copies stream each chunk's 32 hi and 32 lo plane
//     bytes of the rows and the queries into a 3-stage ring (rows of other
//     widths or alignment take a scalar copy into the same ring); zero
//     bytes past a plane's end AND to 0 and count 0;
//   * ldmatrix feeds the planes as they are (both operands are
//     K-contiguous); rows are 80 bytes apart, so the 8 rows of an ldmatrix
//     hit 8 different bank groups;
//   * two accumulators a tile, 2 hh + hl + lh (the hh product issued
//     twice) and ll, keep the registers at 2 blocks an SM where three
//     would not; the epilogue forms 8 acc2 + 4 accl and subtracts the
//     per-row and per-query popcounts each thread counted from the bytes it
//     copied;
//   * one barrier a chunk; the int32 tile goes out through shared memory,
//     16 bytes a lane.
// An int8 form (decode each plane pair to levels 4h + 2l - 3 in shared
// memory, mma.sync m16n8k32 s8) gave the same bits more slowly: its
// decode, not the tensor cores, held it (PERF.md).  Integer sums
// are exact in any order, so both kernels equal their plain versions bit
// for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbinary_dot.so binary_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

bool aligned(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------------
// sign_hamming: XOR + __popc on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;    // queries per block
constexpr int BN = 128;   // corpus rows per block
constexpr int BW = 8;     // 32-bit words of the plane per step (32 bytes)
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

// Stage words [w0, w0 + 8) of `row` (nullptr = zero row): this thread's
// half (4 words) of them, stored as dst[word][slot].  kVec: the plane is a
// multiple of 32 bytes and 16-byte aligned, so each half is one 16-byte load.
template <bool kVec, int kStride>
__device__ __forceinline__ void stage(uint32_t (*dst)[kStride], const uint8_t* row, int slot,
                                      int half, int w0, int dk) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row != nullptr) {
        if (kVec) {
            const uint4 u = *reinterpret_cast<const uint4*>(row + 4 * w0 + 16 * half);
            v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = word_at(row, w0 + 4 * half + e, dk);
        }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * half + e][slot] = v[e];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sign_hamming_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qcodes,
                    int32_t* __restrict__ out, int b, int n, int dk) {
    // Rows padded by 4 words, so the two halves of a staged row land in
    // other banks (and qs rows stay 16-byte aligned for the uint4 reads).
    __shared__ uint32_t cs[BW][BN + 4];
    __shared__ __align__(16) uint32_t qs[BW][BQ + 4];

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN;
    const int q0 = blockIdx.y * BQ;
    const int tx = tid % 16;              // columns tx + 16 j
    const int ty = tid / 16;              // queries ty * 4 + i
    const int words = (dk + 3) / 4;
    const bool active = q0 + ty * TQ < b; // a warp past the last query skips the math

    // Loader roles: corpus row c_slot, query row q_slot (threads < 128), half.
    const int c_slot = tid / 2;
    const int half = tid % 2;
    const int q_slot = tid / 2;
    const uint8_t* crow = n0 + c_slot < n ? codes + static_cast<int64_t>(n0 + c_slot) * dk
                                          : nullptr;
    const uint8_t* qrow = q0 + q_slot < b ? qcodes + static_cast<int64_t>(q0 + q_slot) * dk
                                          : nullptr;

    int32_t acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < words; w0 += BW) {
        stage<kVec, BN + 4>(cs, crow, c_slot, half, w0, dk);
        if (tid < 2 * BQ) stage<kVec, BQ + 4>(qs, qrow, q_slot, half, w0, dk);
        __syncthreads();
        if (active) {
#pragma unroll
            for (int w = 0; w < BW; ++w) {
                uint32_t a[TQ], c[TN];
                const uint4 av = *reinterpret_cast<const uint4*>(&qs[w][ty * TQ]);
                a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
#pragma unroll
                for (int j = 0; j < TN; ++j) c[j] = cs[w][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < TQ; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) acc[i][j] += __popc(a[i] ^ c[j]);
            }
        }
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
            if (col < n) orow[col] = acc[i][j];
        }
    }
}

// ---------------------------------------------------------------------------
// crumb_affinity: the bit planes on the tensor cores (AND + popc).
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 32;   // corpus rows a warp (queries a warp: 32)
constexpr int CQ = 64;          // queries a block
constexpr int CN = 4 * kWarpRows;   // corpus rows a block
constexpr int kNT = kWarpRows / 8;  // n-tiles of 8 rows a warp
constexpr int CB = 32;          // bytes of each plane a chunk: 256 dims, one mma's k
constexpr int kStages = 3;      // plane ring
constexpr int kPlaneRow = 2 * CB + 16;   // bytes between rows: hi | lo | 16 apart
constexpr int kOutRow = CN + 8;          // int32s between staged output rows
constexpr int kCThreads = 256;           // 8 warps: 2 along queries x 4 along rows
constexpr int kCopies = CN * (2 * CB / 16) / kCThreads;   // corpus 16-byte copies a thread
static_assert(CQ * (2 * CB / 16) == kCThreads, "one query copy a thread");

struct CrumbSmem {
    union {
        struct {
            uint8_t c[kStages][CN][kPlaneRow];   // [row][hi 32 | lo 32 | pad]
            uint8_t q[kStages][CQ][kPlaneRow];
        } planes;
        int32_t out[CQ][kOutRow];                // the epilogue's int32 tile
    };
    int32_t row_corr[CN];        // 12 pc(hi) + 6 pc(lo) of each corpus row
    int32_t query_corr[CQ];      // and of each query
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with valid false nothing is read
// and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += popcount(a AND b) over 256 dims, a 16 x 256 and b 256 x 8 bits.
__device__ __forceinline__ void mma_and_popc(int32_t (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int popc16(const uint8_t* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// kVec: planes a multiple of 32 bytes, both tensors 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kCThreads)
crumb_mma_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qcodes,
                 int32_t* __restrict__ out, int b, int n, int dkp) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    CrumbSmem& S = *reinterpret_cast<CrumbSmem*>(smem_raw);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n0 = blockIdx.x * CN;
    const int q0 = blockIdx.y * CQ;
    const int chunks = (dkp + CB - 1) / CB;
    const int64_t row_bytes = 2 * static_cast<int64_t>(dkp);
    if (tid < CN) S.row_corr[tid] = 0;
    if (tid < CQ) S.query_corr[tid] = 0;

    // Copy roles: 16-byte part p (hi, hi, lo, lo) of corpus rows
    // (tid + 256 j) / 4 and of query tid / 4.  Each thread also counts the
    // set bits of what it copied, weighted 12 (hi) or 6 (lo).
    int c_row[kCopies], c_part[kCopies], c_pop[kCopies];
    bool c_ok[kCopies];
    const uint8_t* c_src[kCopies];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
        const int idx = tid + kCThreads * j;
        c_row[j] = idx >> 2;
        c_part[j] = idx & 3;
        c_ok[j] = n0 + c_row[j] < n;
        c_src[j] = codes + (c_ok[j] ? n0 + c_row[j] : 0) * row_bytes +
                   (c_part[j] >> 1) * dkp + 16 * (c_part[j] & 1);
        c_pop[j] = 0;
    }
    const int q_row = tid >> 2;
    const int q_part = tid & 3;
    const bool q_ok = q0 + q_row < b;
    const uint8_t* q_src = qcodes + (q_ok ? q0 + q_row : 0) * row_bytes +
                           (q_part >> 1) * dkp + 16 * (q_part & 1);
    int q_pop = 0;

    // Bytes [byte0, byte0 + 16) of a plane past which it is zero-filled.
    auto copy_sync = [&](uint8_t* dst, const uint8_t* src, bool ok, int byte0) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            if (ok && byte0 + i < dkp) {
                v[i / 4] |= static_cast<uint32_t>(src[i]) << (8 * (i % 4));
            }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    };
    auto fetch = [&](int c) {
        if (c < chunks) {
            const int st = c % kStages;
#pragma unroll
            for (int j = 0; j < kCopies; ++j) {
                uint8_t* dst = &S.planes.c[st][c_row[j]][16 * c_part[j]];
                if (kVec) cp_async16(dst, c_src[j] + CB * c, c_ok[j]);
                else copy_sync(dst, c_src[j] + CB * c, c_ok[j], CB * c + 16 * (c_part[j] & 1));
            }
            uint8_t* dst = &S.planes.q[st][q_row][16 * q_part];
            if (kVec) cp_async16(dst, q_src + CB * c, q_ok);
            else copy_sync(dst, q_src + CB * c, q_ok, CB * c + 16 * (q_part & 1));
        }
        cp_async_commit();
    };

    // Warp (wq, wn) takes queries 32 wq + [0, 32) by rows kWarpRows wn + [0, kWarpRows).
    // acc2 = 2 hh + hl + lh and accl = ll, so the affinity is 8 acc2 + 4 accl
    // plus the rank-1 terms: the hh product runs twice, and two
    // accumulators a tile fit the registers where three would not.
    const int wq = warp & 1;
    const int wn = warp >> 1;
    int32_t acc2[2][kNT][4], accl[2][kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc2[i][j][e] = accl[i][j][e] = 0;

    __syncthreads();                  // the corrections are zeroed
    fetch(0);
    fetch(1);
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - 2>();   // this thread's copies of chunk c have landed
        __syncthreads();                // everyone's have; the multiply of c - 1 is done
        fetch(c + 2);                   // into the stage chunk c - 1 left
        const int st = c % kStages;
#pragma unroll
        for (int j = 0; j < kCopies; ++j) {
            c_pop[j] += popc16(&S.planes.c[st][c_row[j]][16 * c_part[j]]);
        }
        q_pop += popc16(&S.planes.q[st][q_row][16 * q_part]);

        uint32_t a[2][2][4], bm[2][kNT / 2][4];     // [plane][tile][register]
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                ldmatrix_x4(a[p][mi], &S.planes.q[st][32 * wq + 16 * mi + (lane & 15)]
                                                 [CB * p + 16 * (lane >> 4)]);
            }
#pragma unroll
            for (int nj = 0; nj < kNT / 2; ++nj) {
                ldmatrix_x4(bm[p][nj],
                            &S.planes.c[st][kWarpRows * wn + 16 * nj + (lane & 7) + 8 * (lane >> 4)]
                                       [CB * p + 16 * ((lane >> 3) & 1)]);
            }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni) {
                const uint32_t* bh = &bm[0][ni >> 1][2 * (ni & 1)];
                const uint32_t* bl = &bm[1][ni >> 1][2 * (ni & 1)];
                mma_and_popc(acc2[mi][ni], a[0][mi], bh[0], bh[1]);
                mma_and_popc(acc2[mi][ni], a[0][mi], bh[0], bh[1]);
                mma_and_popc(acc2[mi][ni], a[0][mi], bl[0], bl[1]);
                mma_and_popc(acc2[mi][ni], a[1][mi], bh[0], bh[1]);
                mma_and_popc(accl[mi][ni], a[1][mi], bl[0], bl[1]);
            }
    }
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
        atomicAdd(&S.row_corr[c_row[j]], (c_part[j] < 2 ? 12 : 6) * c_pop[j]);
    }
    atomicAdd(&S.query_corr[q_row], (q_part < 2 ? 12 : 6) * q_pop);
    __syncthreads();                    // the planes become the output tile

    const int k9 = 9 * 8 * dkp;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
            const int col = kWarpRows * wn + 8 * ni + 2 * (lane & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 32 * wq + 16 * mi + (lane >> 2) + 8 * h;
                const int32_t base = k9 - S.query_corr[r];
                *reinterpret_cast<int2*>(&S.out[r][col]) = make_int2(
                    base + 8 * acc2[mi][ni][2 * h] + 4 * accl[mi][ni][2 * h] - S.row_corr[col],
                    base + 8 * acc2[mi][ni][2 * h + 1] + 4 * accl[mi][ni][2 * h + 1] -
                        S.row_corr[col + 1]);
            }
        }
    __syncthreads();

    const bool vec_out = n % 4 == 0;
#pragma unroll
    for (int it = 0; it < CQ * CN / 4 / kCThreads; ++it) {
        const int idx = tid + kCThreads * it;
        const int r = idx / (CN / 4);
        const int col = 4 * (idx % (CN / 4));
        const int q = q0 + r;
        if (q >= b || n0 + col >= n) continue;
        int32_t* dst = out + static_cast<int64_t>(q) * n + n0 + col;
        const int4 v = *reinterpret_cast<const int4*>(&S.out[r][col]);
        if (vec_out) {
            *reinterpret_cast<int4*>(dst) = v;
        } else {
            const int32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (n0 + col + i < n) dst[i] = e[i];
        }
    }
}

// Opts a crumb instance into its dynamic shared memory and the largest
// shared-memory carveout, once per device.
template <bool kVec>
cudaError_t configure_crumb(int device) {
    constexpr int kDevices = 64;
    static bool done[kDevices] = {};
    if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
    auto kernel = crumb_mma_kernel<kVec>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(CrumbSmem)));
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
    return err;
}

template <bool kVec>
cudaError_t launch_crumb(const dim3& grid, cudaStream_t s, int device, const uint8_t* codes,
                         const uint8_t* qcodes, int32_t* out, int b, int n, int dkp) {
    const cudaError_t err = configure_crumb<kVec>(device);
    if (err != cudaSuccess) return err;
    crumb_mma_kernel<kVec><<<grid, kCThreads, sizeof(CrumbSmem), s>>>(codes, qcodes, out, b, n,
                                                                      dkp);
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* binary_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cbits: [n, dk] u8, qbits: [b, dk] u8, out: [b, n] i32, all contiguous on
// `device`, the codes 16-byte aligned.  Returns cudaGetLastError() (0 = ok).
extern "C" int sign_hamming(const uint8_t* cbits, const uint8_t* qbits, int32_t* out,
                            int b, int n, int dk, int device, void* stream) {
    if (dk < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    const dim3 grid((n + BN - 1) / BN, (b + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dk % (4 * BW) == 0) {
        sign_hamming_kernel<true><<<grid, kThreads, 0, s>>>(cbits, qbits, out, b, n, dk);
    } else {
        sign_hamming_kernel<false><<<grid, kThreads, 0, s>>>(cbits, qbits, out, b, n, dk);
    }
    return static_cast<int>(cudaGetLastError());
}

// ccodes: [n, 2 dkp] u8 (hi plane || lo plane), qplanes: [b, 2 dkp] u8 in the
// same layout, out: [b, n] i32 (16-byte aligned); d' = 8 dkp.  Same contract
// as sign_hamming.
extern "C" int crumb_affinity(const uint8_t* ccodes, const uint8_t* qplanes, int32_t* out,
                              int b, int n, int dkp, int device, void* stream) {
    if (dkp < 1 || !aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    if ((b + CQ - 1) / CQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + CN - 1) / CN, (b + CQ - 1) / CQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = dkp % CB == 0 && aligned(ccodes, 16) && aligned(qplanes, 16);
    err = vec ? launch_crumb<true>(grid, s, device, ccodes, qplanes, out, b, n, dkp)
              : launch_crumb<false>(grid, s, device, ccodes, qplanes, out, b, n, dkp);
    return static_cast<int>(err);
}
