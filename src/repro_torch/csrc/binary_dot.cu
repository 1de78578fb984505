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
// A sign row is one bit plane of d'/8 bytes; a crumb row is its hi bit
// plane then its lo bit plane, d'/8 bytes each; bit j of byte k is dim
// 8k + j (core/binary.py).  Both proxies are AND + popcounts of the planes
// plus rank-1 terms, which the tensor cores' mma.sync m16n8k256 b1
// (and.popc) computes for a 16 x 8 tile over 256 dims, nothing decoded:
//
//   sign:  pc(q) + pc(c) - 2 pc(q & c)
//   crumb: 16 pc(qH & cH) + 8 pc(qH & cL) + 8 pc(qL & cH) + 4 pc(qL & cL)
//          + 9 d' - 12 pc(qH) - 6 pc(qL) - 12 pc(cH) - 6 pc(cL)
//
// (expanding (4qH + 2qL - 3)(4cH + 2cL - 3) gives the reference's four
// weighted AND+popcounts plus _crumb_corrections term for term).  Zero
// bytes past a plane's end add 0 to every term, and integer sums are exact
// in any order, so both kernels equal their plain versions bit for bit.
// (The binary mma's xor.popc form would give the sign proxy directly; it
// is not relied on for sm_90a, where and.popc is the form both run.)
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: each proxy is an exact int8 dot product (sign: the +-1
// planes give d' - 2 hamming; crumb: the levels), 2 b n d' operations that
// the tensor cores run at 1979 TOP/s.  At b=64, n=45000, d'=1024 that is
// 3.0 us against 17.3 MB (sign) or 23.0 MB (crumb) of codes and int32
// output, 5.2 us and 6.9 us at 3.35 TB/s: bytes bound both, and two thirds
// (sign) or half (crumb) of the bytes are the output.
//
// One template over the number of planes (1 sign, 2 crumb).  A block
// computes 64 queries by 256 (sign) or 128 (crumb) rows with 8 warps of 32
// queries x 64 or 32 rows, over chunks of 256 dims:
//   * 16-byte cp.async copies stream each chunk's 32 bytes of every plane
//     of the rows and the queries into a 3-stage ring (rows of other widths
//     or alignment take a scalar copy into the same ring); bytes past a
//     plane's end are zero-filled;
//   * each thread counts the set bits of what it copied for the rank-1
//     terms (weighted 1 for sign, 12 hi / 6 lo for crumb);
//   * ldmatrix feeds the planes as they are (both operands are
//     K-contiguous); staged rows are 32 P + 16 bytes apart, an odd number
//     of 16-byte units, so the 8 rows of an ldmatrix hit 8 bank groups;
//   * sign keeps one accumulator a tile (one mma a tile and chunk); crumb
//     two, 2 hh + hl + lh (the hh product issued twice) and ll, which keep
//     it within 128 registers where three accumulators would not;
//   * one barrier a chunk; the int32 tile goes out through shared memory,
//     16 bytes a lane, a scalar tail when n % 4 != 0.
// At d'=1024 a block runs only 4 chunks, so its own ring barely overlaps
// anything; the overlap of one block's output stores with another's loads
// comes from 2 blocks resident on each SM (128 registers a thread).  Sign's
// single accumulator leaves room for 64-row warp tiles, which halve the
// query reloads and the blocks: on the card they beat 32-row tiles at 2 or
// 4 blocks an SM and 3 blocks an SM (80 registers, spilling); a 4-stage
// ring gained 2% at 1M rows and nothing at 45,000, so both keep 3 stages
// (tools/proxy_probe.py; PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbinary_dot.so binary_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

bool aligned(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

constexpr int CQ = 64;              // queries a block (2 warps of 32)
constexpr int CB = 32;              // bytes of each plane a chunk: 256 dims, one mma's k
constexpr int kStages = 3;          // plane ring
constexpr int kThreads = 256;       // 8 warps: 2 along queries x 4 along rows

// The tile of each instance.  Sign, one accumulator a tile, takes 64-row
// warp tiles (a block of 64 x 256); crumb, two, takes 32 rows (64 x 128).
// Both are compiled for 2 blocks an SM (at most 128 registers a thread).
template <int kPlanes>
struct Tile {
    static constexpr int kWarpRows = kPlanes == 1 ? 64 : 32;   // corpus rows a warp
    static constexpr int kRows = 4 * kWarpRows;                 // corpus rows a block
    static constexpr int kMinBlocks = 2;
    static constexpr int kRowBytes = kPlanes * CB + 16;   // bytes between staged rows
    static constexpr int kOutRow = kRows + 8;             // int32s between staged output rows
};

template <int kPlanes>
struct ProxySmem {
    using T = Tile<kPlanes>;
    union {
        struct {
            uint8_t c[kStages][T::kRows][T::kRowBytes];   // [row][plane 0 | plane 1 | pad]
            uint8_t q[kStages][CQ][T::kRowBytes];
        } planes;
        int32_t out[CQ][T::kOutRow];        // the epilogue's int32 tile
    };
    int32_t row_corr[T::kRows];    // weighted popcounts of each corpus row
    int32_t query_corr[CQ];        // and of each query
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

// kPlanes 1: sign_hamming (dkp = d'/8 bytes a row); 2: crumb_affinity
// (rows of 2 dkp bytes, hi || lo).  kVec: dkp a multiple of 32 bytes, both
// code tensors 16-byte aligned.
template <int kPlanes, bool kVec>
__global__ void __launch_bounds__(kThreads, Tile<kPlanes>::kMinBlocks)
proxy_mma_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qcodes,
                 int32_t* __restrict__ out, int b, int n, int dkp) {
    using Smem = ProxySmem<kPlanes>;
    constexpr int kWarpRows = Tile<kPlanes>::kWarpRows;
    constexpr int CN = Tile<kPlanes>::kRows;
    constexpr int kNT = kWarpRows / 8;    // n-tiles of 8 rows a warp
    extern __shared__ __align__(16) uint8_t smem_raw[];
    Smem& S = *reinterpret_cast<Smem*>(smem_raw);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n0 = blockIdx.x * CN;
    const int q0 = blockIdx.y * CQ;
    const int chunks = (dkp + CB - 1) / CB;
    const int64_t row_bytes = static_cast<int64_t>(kPlanes) * dkp;
    if (tid < CN) S.row_corr[tid] = 0;
    if (tid < CQ) S.query_corr[tid] = 0;

    // Copy roles: 16-byte part p (plane p / 2, half p % 2) of a corpus row
    // (the first kCCopies) or of a query; each thread also counts the set
    // bits of what it copies.
    constexpr int kParts = 2 * kPlanes;
    constexpr int kCCopies = CN * kParts / kThreads;
    constexpr int kQCopies = (CQ * kParts + kThreads - 1) / kThreads;
    constexpr int kCopies = kCCopies + kQCopies;
    static_assert(CN * kParts % kThreads == 0 && CN <= kThreads, "whole corpus copies a thread");
    int row[kCopies], part[kCopies], pop[kCopies];
    bool has[kCopies], ok[kCopies];
    const uint8_t* src[kCopies];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
        const bool query = j >= kCCopies;
        const int idx = tid + kThreads * (query ? j - kCCopies : j);
        // Threads outnumber the query parts only for sign; the middle term
        // makes has[] a constant true for crumb.
        has[j] = !query || (j - kCCopies + 1) * kThreads <= CQ * kParts || idx < CQ * kParts;
        row[j] = idx / kParts;
        part[j] = idx % kParts;
        const int g = (query ? q0 : n0) + row[j];
        ok[j] = has[j] && g < (query ? b : n);
        src[j] = (query ? qcodes : codes) + (ok[j] ? g : 0) * row_bytes +
                 (part[j] >> 1) * dkp + 16 * (part[j] & 1);
        pop[j] = 0;
    }
    auto staged = [&](int st, int j) -> uint8_t* {
        return j >= kCCopies ? &S.planes.q[st][row[j]][16 * part[j]]
                             : &S.planes.c[st][row[j]][16 * part[j]];
    };

    // Bytes [byte0, byte0 + 16) of a plane, zero past its end.
    auto copy_sync = [&](uint8_t* dst, const uint8_t* from, bool valid, int byte0) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            if (valid && byte0 + i < dkp) {
                v[i / 4] |= static_cast<uint32_t>(from[i]) << (8 * (i % 4));
            }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    };
    auto fetch = [&](int c) {
        if (c < chunks) {
            const int st = c % kStages;
#pragma unroll
            for (int j = 0; j < kCopies; ++j) {
                if (!has[j]) continue;
                if (kVec) cp_async16(staged(st, j), src[j] + CB * c, ok[j]);
                else copy_sync(staged(st, j), src[j] + CB * c, ok[j], CB * c + 16 * (part[j] & 1));
            }
        }
        cp_async_commit();
    };

    // Warp (wq, wn) takes queries 32 wq + [0, 32) by rows kWarpRows wn + [0, kWarpRows).
    // Sign: acc[0] = pc(q & c).  Crumb: acc[0] = 2 hh + hl + lh and
    // acc[1] = ll, so the affinity is 8 acc[0] + 4 acc[1] plus the rank-1
    // terms.
    const int wq = warp & 1;
    const int wn = warp >> 1;
    int32_t acc[kPlanes][2][kNT][4];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0;

    __syncthreads();                  // the corrections are zeroed
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) fetch(c);
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - 2>();   // this thread's copies of chunk c have landed
        __syncthreads();                // everyone's have; the multiply of c - 1 is done
        fetch(c + kStages - 1);         // into the stage chunk c - 1 left
        const int st = c % kStages;
#pragma unroll
        for (int j = 0; j < kCopies; ++j) {
            if (has[j]) pop[j] += popc16(staged(st, j));
        }

        uint32_t a[kPlanes][2][4], bm[kPlanes][kNT / 2][4];   // [plane][tile][register]
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
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
                const uint32_t* b0 = &bm[0][ni >> 1][2 * (ni & 1)];
                if constexpr (kPlanes == 1) {
                    mma_and_popc(acc[0][mi][ni], a[0][mi], b0[0], b0[1]);
                } else {
                    const uint32_t* b1 = &bm[1][ni >> 1][2 * (ni & 1)];
                    mma_and_popc(acc[0][mi][ni], a[0][mi], b0[0], b0[1]);
                    mma_and_popc(acc[0][mi][ni], a[0][mi], b0[0], b0[1]);
                    mma_and_popc(acc[0][mi][ni], a[0][mi], b1[0], b1[1]);
                    mma_and_popc(acc[0][mi][ni], a[1][mi], b0[0], b0[1]);
                    mma_and_popc(acc[1][mi][ni], a[1][mi], b1[0], b1[1]);
                }
            }
    }
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
        if (!has[j]) continue;
        const int weight = kPlanes == 1 ? 1 : (part[j] < 2 ? 12 : 6);
        atomicAdd(j >= kCCopies ? &S.query_corr[row[j]] : &S.row_corr[row[j]],
                  weight * pop[j]);
    }
    __syncthreads();                    // the planes become the output tile

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
            const int col = kWarpRows * wn + 8 * ni + 2 * (lane & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 32 * wq + 16 * mi + (lane >> 2) + 8 * h;
                const int32_t* a = acc[0][mi][ni] + 2 * h;
                int32_t v[2];
                if constexpr (kPlanes == 1) {
                    const int32_t base = S.query_corr[r];
                    v[0] = base - 2 * a[0] + S.row_corr[col];
                    v[1] = base - 2 * a[1] + S.row_corr[col + 1];
                } else {
                    const int32_t base = 9 * 8 * dkp - S.query_corr[r];
                    const int32_t* l = acc[1][mi][ni] + 2 * h;
                    v[0] = base + 8 * a[0] + 4 * l[0] - S.row_corr[col];
                    v[1] = base + 8 * a[1] + 4 * l[1] - S.row_corr[col + 1];
                }
                *reinterpret_cast<int2*>(&S.out[r][col]) = make_int2(v[0], v[1]);
            }
        }
    __syncthreads();

    const bool vec_out = n % 4 == 0;
#pragma unroll
    for (int it = 0; it < CQ * CN / 4 / kThreads; ++it) {
        const int idx = tid + kThreads * it;
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

// Opts an instance into its dynamic shared memory and the largest
// shared-memory carveout, once per device.
template <int kPlanes, bool kVec>
cudaError_t configure(int device) {
    constexpr int kDevices = 64;
    static bool done[kDevices] = {};
    if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
    auto kernel = proxy_mma_kernel<kPlanes, kVec>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(ProxySmem<kPlanes>)));
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
    return err;
}

template <int kPlanes, bool kVec>
cudaError_t launch(const dim3& grid, cudaStream_t s, int device, const uint8_t* codes,
                   const uint8_t* qcodes, int32_t* out, int b, int n, int dkp) {
    const cudaError_t err = configure<kPlanes, kVec>(device);
    if (err != cudaSuccess) return err;
    proxy_mma_kernel<kPlanes, kVec><<<grid, kThreads, sizeof(ProxySmem<kPlanes>), s>>>(
        codes, qcodes, out, b, n, dkp);
    return cudaGetLastError();
}

// The C entry points' common body.  A launch takes at most 65,535 blocks of
// 64 queries (the grid's y); the wrappers launch over chunks of queries.
template <int kPlanes>
int proxy(const uint8_t* codes, const uint8_t* qcodes, int32_t* out, int b, int n, int dkp,
          int device, void* stream) {
    if (dkp < 1 || !aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0 || n == 0) return 0;
    if ((b + CQ - 1) / CQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int CN = Tile<kPlanes>::kRows;
    const dim3 grid((n + CN - 1) / CN, (b + CQ - 1) / CQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = dkp % CB == 0 && aligned(codes, 16) && aligned(qcodes, 16);
    err = vec ? launch<kPlanes, true>(grid, s, device, codes, qcodes, out, b, n, dkp)
              : launch<kPlanes, false>(grid, s, device, codes, qcodes, out, b, n, dkp);
    return static_cast<int>(err);
}

}  // namespace

extern "C" const char* binary_dot_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cbits: [n, dk] u8, qbits: [b, dk] u8, out: [b, n] i32 (16-byte aligned),
// all contiguous on `device`; b <= 64 x 65535.  Returns cudaGetLastError()
// (0 = ok).
extern "C" int sign_hamming(const uint8_t* cbits, const uint8_t* qbits, int32_t* out,
                            int b, int n, int dk, int device, void* stream) {
    return proxy<1>(cbits, qbits, out, b, n, dk, device, stream);
}

// ccodes: [n, 2 dkp] u8 (hi plane || lo plane), qplanes: [b, 2 dkp] u8 in the
// same layout, out: [b, n] i32; d' = 8 dkp.  Same contract as sign_hamming.
extern "C" int crumb_affinity(const uint8_t* ccodes, const uint8_t* qplanes, int32_t* out,
                              int b, int n, int dkp, int device, void* stream) {
    return proxy<2>(ccodes, qplanes, out, b, n, dkp, device, stream);
}
