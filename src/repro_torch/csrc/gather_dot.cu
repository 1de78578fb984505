// Gathered rescores: out[q, i] = <q_rot[q], deq(packed[cand[q, i]])>, for
// 4-bit and 2-bit codes.
//
// gather_nibble_dot: Replaces the Pallas kernel src/repro/kernels/gather_dot.py::_gather_nibble_kernel
// (launched by gather_nibble_dot_raw): 4-bit rows, the low nibble of byte i
// is dim 2i, the high nibble dim 2i+1.
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
// The numbers: every score is ONE f32 accumulator updated as
// fmaf(q[k], lut[code_k], acc) for k = 0..d-1 ascending, the order of the
// full-scan kernels (csrc/nibble_dot.cu), so a gathered score is byte-equal
// to the full scan's score of the same (query, row) and the cascade returns
// the full scan's scores.  No split-K, no atomics, no tensor cores.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: the candidate rows, b m d' bits/8 bytes, plus the
// queries and the output.  At b=64, d'=1024 that is 2.6 MB of 4-bit rows at
// m=80 (0.8 us at 3.35 TB/s) and 10.5 MB at m=320 (3.1 us); 2-bit rows are
// half that.  The FMAs (21 M at m=320, 0.3 us at 67 TFLOP/s) do not bound
// it.  Each row is read once.
//
// The chain floor: the order above makes each score d' dependent FMAs, 4
// cycles apart, so no launch ends before d' x 4 cycles (2.1 us at d'=1024
// and 1.98 GHz), whatever the row bytes.  At m=80 that lies above the byte
// bound, and it stays until the full scans change their order too.
//
// Design (the pipelined instance): one-warp blocks over a grid of
// (ceil(m/32), b), one thread a candidate, so the b m / 32 warps spread
// over the card's schedulers.  Each block stages its query in shared memory
// (16-byte loads) and issues its threads' first row loads before its one
// barrier.  A thread then runs its chain in units of 16 dims and keeps the
// FMA chain the only wait:
//   - rows: a register ring of 16-byte loads (8 of 4-bit or 4 of 2-bit,
//     256 dims ahead) is refilled as each load is decoded, so row bytes
//     arrive long before their FMAs;
//   - operands: while the FMAs of one unit run, the next unit's 16 query
//     values (four broadcast 16-byte shared loads) and 16 levels are loaded
//     into a second register set.  4-bit levels come from a 16-float table
//     in shared memory (conflict-free: 16 entries in 16 banks), one load a
//     dim; 2-bit levels from a 16-entry table of level pairs indexed by a
//     nibble, one 8-byte load per two dims.
// The next unit's loads sit in the same basic block as this unit's FMAs, so
// the compiler issues them in the FMAs' latency slots.  Where d' is not a
// multiple of one 16-byte load, d' > 8192, or a pointer or stride is off 16
// bytes (the small mixed splits), the scalar instance runs the same chain
// with one-byte loads and the query staged 1024 dims at a time.
// On an NVIDIA H100 80GB HBM3 (700.00 W) a lone candidate costs ~8 (4-bit)
// and ~5.4 (2-bit) cycles a dim (chip_smoke.py): the decode, table and
// query loads around each FMA, not its latency, set the pace.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgather_dot.so gather_dot.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;       // candidates per block (one warp), one per thread
constexpr int kUnit = 16;          // dims per pipeline step
constexpr int kMaxVecDims = 8192;  // pipelined instance: query dims staged at once
constexpr int KC = 1024;           // scalar instance: query dims staged per step

template <int kBits>
struct Layout {
    static constexpr int kCodes = 8 / kBits;              // codes per byte
    static constexpr int kChunkDims = 16 * kCodes;        // dims per 16-byte row load
    static constexpr int kUnits = kChunkDims / kUnit;     // units per row load
    static constexpr int kRing = kBits == 4 ? 8 : 4;      // row loads in flight: 256 dims
};

// The operands of one unit: the 16 query values at qk and the 16 levels of
// unit s of the 16-byte row load v.
template <int kBits>
__device__ __forceinline__ void prep(const uint4& v, int s, const float* __restrict__ qk,
                                     const float* __restrict__ tab, float (&qv)[kUnit],
                                     float (&lv)[kUnit]) {
    const float4* q4 = reinterpret_cast<const float4*>(qk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float4 t = q4[j];
        qv[4 * j] = t.x;
        qv[4 * j + 1] = t.y;
        qv[4 * j + 2] = t.z;
        qv[4 * j + 3] = t.w;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const char* base = reinterpret_cast<const char*>(tab);
    if constexpr (kBits == 4) {
        // Unit s is words 2s and 2s+1; byte j of word h holds dims 8h+2j
        // (low nibble) and 8h+2j+1 (high).  Each nibble becomes its byte
        // offset into the table, then one byte is picked out per dim.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t lo = (w[2 * s + h] << 2) & 0x3C3C3C3Cu;
            const uint32_t hi = (w[2 * s + h] >> 2) & 0x3C3C3C3Cu;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                lv[8 * h + 2 * j] =
                    *reinterpret_cast<const float*>(base + __byte_perm(lo, 0, 0x4440 + j));
                lv[8 * h + 2 * j + 1] =
                    *reinterpret_cast<const float*>(base + __byte_perm(hi, 0, 0x4440 + j));
            }
        }
    } else {
        // Unit s is word s; byte j holds dims 4j..4j+3, two to a nibble.
        // The table holds (lut[c & 3], lut[c >> 2]) at entry c of a nibble.
        const uint32_t lo = (w[s] << 3) & 0x78787878u;
        const uint32_t hi = (w[s] >> 1) & 0x78787878u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 a =
                *reinterpret_cast<const float2*>(base + __byte_perm(lo, 0, 0x4440 + j));
            const float2 c =
                *reinterpret_cast<const float2*>(base + __byte_perm(hi, 0, 0x4440 + j));
            lv[4 * j] = a.x;
            lv[4 * j + 1] = a.y;
            lv[4 * j + 2] = c.x;
            lv[4 * j + 3] = c.y;
        }
    }
}

__device__ __forceinline__ void chain(const float (&qv)[kUnit], const float (&lv)[kUnit],
                                      float& acc) {
#pragma unroll
    for (int t = 0; t < kUnit; ++t) acc = fmaf(qv[t], lv[t], acc);
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
gather_pipelined(const uint8_t* __restrict__ packed, int64_t code_stride,
                 const float* __restrict__ q, int64_t q_stride,
                 const int32_t* __restrict__ cand,
                 const float* __restrict__ lut_g,
                 float* __restrict__ out,
                 int m, int n, int d) {
    using L = Layout<kBits>;
    extern __shared__ __align__(16) float qs[];    // the query, d + kUnit floats
    __shared__ __align__(16) float tab[32];        // 4-bit levels, or 2-bit level pairs

    const int tid = threadIdx.x;
    const int qi = blockIdx.y;
    const int i = blockIdx.x * kThreads + tid;
    const bool live = i < m;
    const int row = live ? cand[static_cast<int64_t>(qi) * m + i] : -1;

    // Stage the query, four 16-byte loads in flight per thread.
    const float4* q4 = reinterpret_cast<const float4*>(q + static_cast<int64_t>(qi) * q_stride);
    float4* qs4 = reinterpret_cast<float4*>(qs);
    const int d4 = d / 4;
    for (int t0 = 0; t0 < d4; t0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = t0 + j * kThreads + tid;
            if (t < d4) v[j] = q4[t];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int t = t0 + j * kThreads + tid;
            if (t < d4) qs4[t] = v[j];
        }
    }
    if (tid < 16) {
        if constexpr (kBits == 4) {
            tab[tid] = lut_g[tid];
        } else {
            tab[2 * tid] = lut_g[tid & 3];
            tab[2 * tid + 1] = lut_g[tid >> 2];
        }
    }

    // The first row loads of the ring, before the barrier.
    const bool valid = row >= 0 && row < n;
    const uint4* src =
        reinterpret_cast<const uint4*>(packed + static_cast<int64_t>(valid ? row : 0) * code_stride);
    const int nchunks = d / L::kChunkDims;
    uint4 ring[L::kRing];
#pragma unroll
    for (int r = 0; r < L::kRing; ++r) {
        ring[r] = make_uint4(0u, 0u, 0u, 0u);
        if (valid) ring[r] = __ldg(src + min(r, nchunks - 1));
    }
    __syncthreads();
    if (!valid) {
        if (live) out[static_cast<int64_t>(qi) * m + i] = 0.0f;
        return;
    }

    float qa[kUnit], la[kUnit], qb[kUnit], lb[kUnit];
    prep<kBits>(ring[0], 0, qs, tab, qa, la);
    float acc = 0.0f;
    for (int c0 = 0; c0 < nchunks; c0 += L::kRing) {
#pragma unroll
        for (int r = 0; r < L::kRing; ++r) {
            if (c0 + r >= nchunks) break;
#pragma unroll
            for (int s = 0; s < L::kUnits; ++s) {
                // Load the operands of the next unit (past the last dim they
                // read the query's padding and are never used), then run this
                // unit's 16 FMAs.  The ring holds 16 units, so which register
                // set a unit uses is fixed at compile time.
                const int u = r * L::kUnits + s;
                const int rn = s + 1 == L::kUnits ? (r + 1) % L::kRing : r;
                const int sn = (s + 1) % L::kUnits;
                const float* qn = qs + (c0 + r) * L::kChunkDims + (s + 1) * kUnit;
                if (u % 2 == 0) {
                    prep<kBits>(ring[rn], sn, qn, tab, qb, lb);
                    chain(qa, la, acc);
                } else {
                    prep<kBits>(ring[rn], sn, qn, tab, qa, la);
                    chain(qb, lb, acc);
                }
            }
            // This load is decoded: refill it with the load kRing ahead (the
            // last one again past the row's end).
            ring[r] = __ldg(src + min(c0 + r + L::kRing, nchunks - 1));
        }
    }
    out[static_cast<int64_t>(qi) * m + i] = acc;
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
gather_scalar(const uint8_t* __restrict__ packed, int64_t code_stride,
              const float* __restrict__ q, int64_t q_stride,
              const int32_t* __restrict__ cand,
              const float* __restrict__ lut_g,
              float* __restrict__ out,
              int m, int n, int d) {
    constexpr int kCodes = 8 / kBits;
    constexpr int kMask = (1 << kBits) - 1;
    __shared__ float qs[KC];
    __shared__ float lut[1 << kBits];

    const int tid = threadIdx.x;
    const int qi = blockIdx.y;
    const int i = blockIdx.x * kThreads + tid;
    if (tid < (1 << kBits)) lut[tid] = lut_g[tid];
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
        for (int t = 0; t < kc / kCodes; ++t) {
            const uint32_t byte = prow[k0 / kCodes + t];
#pragma unroll
            for (int c = 0; c < kCodes; ++c)
                acc = fmaf(qs[kCodes * t + c], lut[(byte >> (kBits * c)) & kMask], acc);
        }
    }
    if (i < m) out[static_cast<int64_t>(qi) * m + i] = valid ? acc : 0.0f;
}

bool aligned(const void* p, int64_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
    const bool pipelined = d % Layout<kBits>::kChunkDims == 0 && d <= kMaxVecDims &&
                           aligned(packed, 16) && code_stride % 16 == 0 &&
                           aligned(q, 16) && q_stride % 4 == 0;
    if (pipelined) {
        const size_t smem = sizeof(float) * (d + kUnit);
        gather_pipelined<kBits><<<grid, kThreads, smem, s>>>(packed, code_stride, q, q_stride,
                                                             cand, lut, out, m, n, d);
    } else {
        gather_scalar<kBits><<<grid, kThreads, 0, s>>>(packed, code_stride, q, q_stride, cand,
                                                       lut, out, m, n, d);
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
