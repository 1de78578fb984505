// Signed, zero-padded Walsh-Hadamard transform of rows: out = H_{d'} (pad(x) * signs).
//
// Replaces the Pallas kernel src/repro/kernels/hadamard.py::_hadamard_kernel
// (launched by fwht_pallas).  The TPU kernel computes H_a X H_b as two small
// matrix products because its vector unit is poor at shuffles.  Hopper has no
// such limit, so this kernel runs the butterfly.  The zero pad d -> d' and
// the +-1 sign multiply of the RHDH rotation are fused into the load, so the
// rotated row is written once and nothing else goes through device memory.
//
// Bits.  Every output is the same IEEE result as the plain stage-by-stage
// butterfly (kernels/hadamard.py signed_fwht_butterfly): the load is x * sign
// (exact), the pad +0.0, and the stages run in ascending order s = 0 ..
// log2(d') - 1, each pair (i, i + 2^s) becoming (a + b, a - b).  Where a value
// sits (registers, shuffles, shared or global memory) changes no bit.  The
// shuffle stages compute fmaf(v, +-1, partner): the product is exact, so the
// one rounding is that of a + b or a - b.  Build without --use_fast_math, so
// denormals are kept as the plain version keeps them.
//
// Design.  A segment of D = 2^k floats is spread over the threads so that
// index bits 0-1 sit in a lane's float4, the next bits in the lane number
// and the top bits in the lane's J float4s (and for D > 2048 in the warp
// number):
//   * stages 0-1 in registers, the lane stages by __shfl_xor_sync, the
//     float4 stages in registers again;
//   * D <= 128: D/4 lanes take a segment, 32/(D/4) segments a warp;
//     D <= 2048: a warp takes a segment, J = D/128 float4s a lane;
//     D <= 32768 (the largest one block holds): 16 float4s a lane, D/2048
//     warps a block, and the warp stages go through one shared-memory
//     transpose (stride 2048 columns, coalesced stores);
//   * loads and stores are 16 bytes a lane, neighbouring lanes on
//     neighbouring addresses; a scalar load instance takes rows whose d is
//     not a multiple of 4 or that are not 16-byte aligned;
//   * eight warps a block in the warp forms, so one SM keeps many rows'
//     loads in flight while others compute.  Under 1024 warps of work (a
//     search's batch) one warp's serial stages set the time instead: rows
//     of 512 .. 2048 then spread over D/256 warps (2 float4s a lane, the
//     top stages through shared memory) and smaller ones take one-warp
//     blocks, so the rows spread over the SMs.
// A row of d' = 2^L > 32768 takes two passes over global memory in the same
// stage order: pass 1 runs stages 0 .. k-1 on contiguous segments of 2^k
// (k = min(L - 5, 15), the load fusing pad and signs as above); pass 2 runs
// stages k .. L-1 in place on the stride-2^k columns, a warp taking a tile
// of 32 contiguous columns x 2^g rows (g <= 5 stages a launch, one value a
// row in each lane's registers), so every load and store is a 128-byte
// line.  Offsets are 64-bit; d' goes up to 2^30.
//
// Bound on an NVIDIA H100 80GB HBM3 (700.00 W power limit), from its
// published rates: each row is read once (4 d bytes) and written once
// (4 d' bytes) against d' log2(d') adds, so the kernel is memory-bound
// (at [45000, 1024]: 369 MB, about 110 us at 3.35 TB/s).  The single pass
// moves those bytes once; the two-pass form moves the output twice more.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhadamard.so hadamard.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;        // warps a block in the warp forms
constexpr int kFewWarps = 1024;  // below this many warps of work, one warp a block
constexpr int kMaxLogD = 15;     // the largest segment one block holds (128 KB)
constexpr int kMaxLogDPad = 30;
constexpr int kColStages = 5;    // column-pass stages a launch: 32 values a lane

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// How a segment of D = 2^kLogD floats (D >= 4) spreads over the threads:
// kW warps share the segment (by default one up to 2048 floats, then 16
// float4s a lane); T lanes share a warp's part, each holding J float4s; C
// floats are one warp's part.
template <int kLogD, int kW = (kLogD <= 11 ? 1 : 1 << (kLogD - 11))>
struct Seg {
    static constexpr int D = 1 << kLogD;
    static constexpr int W = kW;
    static constexpr int T = D / 4 < 32 ? D / 4 : 32;
    static constexpr int J = D / (4 * T * W);
    static constexpr int C = 4 * T * J;
    static constexpr int kLogT = ilog2(T);
    static_assert(J >= 1 && (W == 1 || (T == 32 && 4 * J >= W)), "no such spread");
};

__device__ __forceinline__ void bfly(float& a, float& b) {
    const float s = a + b;
    b = a - b;
    a = s;
}

__device__ __forceinline__ void bfly4(float4& a, float4& b) {
    bfly(a.x, b.x);
    bfly(a.y, b.y);
    bfly(a.z, b.z);
    bfly(a.w, b.w);
}

// Elements [col, col + 4) of pad(x_row) * signs: past d the pad is +0.0,
// never 0 * sign (which is -0.0 for a negative sign).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ xrow,
                                        const float* __restrict__ signs, int col, int d) {
    if (kVec) {
        if (col >= d) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 a = __ldg(reinterpret_cast<const float4*>(xrow + col));
        const float4 s = __ldg(reinterpret_cast<const float4*>(signs + col));
        return make_float4(a.x * s.x, a.y * s.y, a.z * s.z, a.w * s.w);
    }
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        e[c] = col + c < d ? __ldg(xrow + col + c) * __ldg(signs + col + c) : 0.0f;
    }
    return make_float4(e[0], e[1], e[2], e[3]);
}

// Stages 0 .. log2(C) - 1 of a warp's part: index bits 0-1 in the float4,
// bits 2 .. 2 + log2(T) - 1 in the lane, the rest in j.  Every lane of the
// warp takes part in the shuffles.
template <typename S>
__device__ __forceinline__ void warp_stages(float4 (&v)[S::J], int lane) {
#pragma unroll
    for (int j = 0; j < S::J; ++j) {
        bfly(v[j].x, v[j].y);
        bfly(v[j].z, v[j].w);
    }
#pragma unroll
    for (int j = 0; j < S::J; ++j) {
        bfly(v[j].x, v[j].z);
        bfly(v[j].y, v[j].w);
    }
#pragma unroll
    for (int k = 0; k < S::kLogT; ++k) {
        // The lane with bit k clear holds a and gets a + b; its partner
        // holds b and gets a - b = fmaf(b, -1, a).
        const float sgn = (lane >> k) & 1 ? -1.0f : 1.0f;
#pragma unroll
        for (int j = 0; j < S::J; ++j) {
            v[j].x = fmaf(v[j].x, sgn, __shfl_xor_sync(kFull, v[j].x, 1 << k));
            v[j].y = fmaf(v[j].y, sgn, __shfl_xor_sync(kFull, v[j].y, 1 << k));
            v[j].z = fmaf(v[j].z, sgn, __shfl_xor_sync(kFull, v[j].z, 1 << k));
            v[j].w = fmaf(v[j].w, sgn, __shfl_xor_sync(kFull, v[j].w, 1 << k));
        }
    }
#pragma unroll
    for (int h = 1; h < S::J; h <<= 1) {
#pragma unroll
        for (int j = 0; j < S::J; ++j) {
            if (!(j & h)) bfly4(v[j], v[j + h]);
        }
    }
}

// Segment `seg` of the output: row seg >> log_chunks, columns
// [col0, col0 + D) with col0 = (seg mod 2^log_chunks) D.
struct Where {
    int64_t row;
    int col0;
};

template <int kLogD>
__device__ __forceinline__ Where where(int64_t seg, int log_chunks) {
    return {seg >> log_chunks,
            static_cast<int>(seg & ((int64_t{1} << log_chunks) - 1)) << kLogD};
}

// D <= 2048: T lanes a segment, 32 / T segments a warp.
template <int kLogD, bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
fwht_warp_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                 float* __restrict__ out, int64_t segs, int log_chunks, int d, int d_pad) {
    using S = Seg<kLogD>;
    const int lane = threadIdx.x & 31;
    const int64_t seg = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                         (threadIdx.x >> 5)) * (32 / S::T) + lane / S::T;
    const bool active = seg < segs;
    const Where at = where<kLogD>(active ? seg : 0, log_chunks);
    const int li = lane % S::T;
    const float* xrow = x + at.row * d;
    float4 v[S::J];
#pragma unroll
    for (int j = 0; j < S::J; ++j) {
        v[j] = active ? load4<kVec>(xrow, signs, at.col0 + 4 * (li + S::T * j), d)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    warp_stages<S>(v, lane);
    if (!active) return;
    float* orow = out + at.row * d_pad + at.col0;
#pragma unroll
    for (int j = 0; j < S::J; ++j) {
        *reinterpret_cast<float4*>(orow + 4 * (li + S::T * j)) = v[j];
    }
}

// One segment a block of W warps (2048 < D <= 32768, or a few rows of
// 512 <= D <= 2048 spread thinner).  Each warp runs the stages of its C
// columns; the top log2(W) stages go through shared memory, each thread
// taking W values C columns apart.
template <int kLogD, int kW, bool kVec>
__global__ void __launch_bounds__(32 * kW)
fwht_block_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                  float* __restrict__ out, int log_chunks, int d, int d_pad) {
    using S = Seg<kLogD, kW>;
    extern __shared__ float4 part4[];
    const float* part = reinterpret_cast<const float*>(part4);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const Where at = where<kLogD>(blockIdx.x, log_chunks);
    const float* xrow = x + at.row * d;
    float4 v[S::J];
#pragma unroll
    for (int j = 0; j < S::J; ++j) {
        v[j] = load4<kVec>(xrow, signs, at.col0 + warp * S::C + 4 * (lane + 32 * j), d);
    }
    warp_stages<S>(v, lane);
#pragma unroll
    for (int j = 0; j < S::J; ++j) part4[warp * (S::C / 4) + lane + 32 * j] = v[j];
    __syncthreads();
    float* orow = out + at.row * d_pad + at.col0;
#pragma unroll
    for (int r = 0; r < S::C / (32 * S::W); ++r) {
        const int base = tid + 32 * S::W * r;
        float u[S::W];
#pragma unroll
        for (int w = 0; w < S::W; ++w) u[w] = part[base + w * S::C];
#pragma unroll
        for (int h = 1; h < S::W; h <<= 1) {
#pragma unroll
            for (int w = 0; w < S::W; ++w) {
                if (!(w & h)) bfly(u[w], u[w + h]);
            }
        }
#pragma unroll
        for (int w = 0; w < S::W; ++w) orow[base + w * S::C] = u[w];
    }
}

// d' of 1 or 2: a thread a row.
template <int kLogD>
__global__ void fwht_tiny_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                                 float* __restrict__ out, int n, int d) {
    constexpr int D = 1 << kLogD;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= n) return;
    float v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = i < d ? x[row * d + i] * signs[i] : 0.0f;
    if (D == 2) bfly(v[0], v[1]);
#pragma unroll
    for (int i = 0; i < D; ++i) out[row * D + i] = v[i];
}

// Pass 2: stages log_c .. log_c + kLogM - 1 in place.  A row's index is
// i = c + 2^log_c m + 2^(log_c + kLogM) h; a warp takes one h and 32
// neighbouring c and holds the 2^kLogM values of m in each lane.
template <int kLogM>
__global__ void __launch_bounds__(32 * kWarps)
fwht_columns_kernel(float* __restrict__ out, int64_t tiles, int log_c) {
    constexpr int M = 1 << kLogM;
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (tile >= tiles) return;
    const int lane = threadIdx.x & 31;
    const int log_groups = log_c - 5;          // tiles of 32 columns in 2^log_c
    const int64_t group = tile & ((int64_t{1} << log_groups) - 1);
    float* p = out + ((tile >> log_groups) << (log_c + kLogM)) + (group << 5) + lane;
    const int64_t stride = int64_t{1} << log_c;
    float u[M];
#pragma unroll
    for (int m = 0; m < M; ++m) u[m] = p[m * stride];
#pragma unroll
    for (int h = 1; h < M; h <<= 1) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
            if (!(m & h)) bfly(u[m], u[m + h]);
        }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) p[m * stride] = u[m];
}

bool aligned(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Opts a block-form instance into its dynamic shared memory, once per device.
template <int kLogD, int kW, bool kVec>
cudaError_t configure(int device) {
    constexpr int kDevices = 64;
    static bool done[kDevices] = {};
    if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_block_kernel<kLogD, kW, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * Seg<kLogD, kW>::D));
    if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
    return err;
}

template <int kLogD, int kW, bool kVec>
cudaError_t launch_blocks(const float* x, const float* signs, float* out, int64_t segs,
                          int log_chunks, int d, int d_pad, int device, cudaStream_t s) {
    if (segs > 0x7fffffff) return cudaErrorInvalidValue;
    const cudaError_t err = configure<kLogD, kW, kVec>(device);
    if (err != cudaSuccess) return err;
    fwht_block_kernel<kLogD, kW, kVec>
        <<<static_cast<unsigned>(segs), 32 * kW, sizeof(float) * Seg<kLogD, kW>::D, s>>>(
            x, signs, out, log_chunks, d, d_pad);
    return cudaGetLastError();
}

// Stages 0 .. kLogD - 1 of `segs` segments of D = 2^kLogD columns.
template <int kLogD, bool kVec>
cudaError_t launch_segments(const float* x, const float* signs, float* out, int64_t segs,
                            int log_chunks, int d, int d_pad, int device, cudaStream_t s) {
    using S = Seg<kLogD>;
    if constexpr (S::W == 1) {
        // Few rows (a search's batch): one warp's serial stages set the
        // time, so rows of 512 .. 2048 spread over D/256 warps (2 float4s a
        // lane) and smaller ones over one-warp blocks on as many SMs.
        const int64_t warps = (segs + 32 / S::T - 1) / (32 / S::T);
        if constexpr (kLogD >= 9) {
            if (warps < kFewWarps) {
                return launch_blocks<kLogD, (1 << (kLogD - 8)), kVec>(
                    x, signs, out, segs, log_chunks, d, d_pad, device, s);
            }
        }
        const int per_block = warps < kFewWarps ? 1 : kWarps;
        const int64_t blocks = (warps + per_block - 1) / per_block;
        if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
        fwht_warp_kernel<kLogD, kVec><<<static_cast<unsigned>(blocks), 32 * per_block, 0, s>>>(
            x, signs, out, segs, log_chunks, d, d_pad);
        return cudaGetLastError();
    } else {
        return launch_blocks<kLogD, S::W, kVec>(x, signs, out, segs, log_chunks, d, d_pad,
                                                device, s);
    }
}

template <int kLogD>
cudaError_t segments(bool vec, const float* x, const float* signs, float* out, int64_t segs,
                     int log_chunks, int d, int d_pad, int device, cudaStream_t s) {
    return vec ? launch_segments<kLogD, true>(x, signs, out, segs, log_chunks, d, d_pad,
                                              device, s)
               : launch_segments<kLogD, false>(x, signs, out, segs, log_chunks, d, d_pad,
                                               device, s);
}

cudaError_t first_pass(int log_d, bool vec, const float* x, const float* signs, float* out,
                       int64_t segs, int log_chunks, int d, int d_pad, int device,
                       cudaStream_t s) {
#define FWHT_SEGMENTS(L) \
    case L: return segments<L>(vec, x, signs, out, segs, log_chunks, d, d_pad, device, s);
    switch (log_d) {
        FWHT_SEGMENTS(2) FWHT_SEGMENTS(3) FWHT_SEGMENTS(4) FWHT_SEGMENTS(5)
        FWHT_SEGMENTS(6) FWHT_SEGMENTS(7) FWHT_SEGMENTS(8) FWHT_SEGMENTS(9)
        FWHT_SEGMENTS(10) FWHT_SEGMENTS(11) FWHT_SEGMENTS(12) FWHT_SEGMENTS(13)
        FWHT_SEGMENTS(14) FWHT_SEGMENTS(15)
        default: return cudaErrorInvalidValue;
    }
#undef FWHT_SEGMENTS
}

cudaError_t columns(int log_m, float* out, int64_t tiles, int log_c, cudaStream_t s) {
    const int64_t blocks = (tiles + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    const unsigned grid = static_cast<unsigned>(blocks);
    switch (log_m) {
        case 1: fwht_columns_kernel<1><<<grid, 32 * kWarps, 0, s>>>(out, tiles, log_c); break;
        case 2: fwht_columns_kernel<2><<<grid, 32 * kWarps, 0, s>>>(out, tiles, log_c); break;
        case 3: fwht_columns_kernel<3><<<grid, 32 * kWarps, 0, s>>>(out, tiles, log_c); break;
        case 4: fwht_columns_kernel<4><<<grid, 32 * kWarps, 0, s>>>(out, tiles, log_c); break;
        case 5: fwht_columns_kernel<5><<<grid, 32 * kWarps, 0, s>>>(out, tiles, log_c); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* hadamard_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [n, d] f32, signs: [d_pad] f32, out: [n, d_pad] f32, all contiguous on
// `device`, out 16-byte aligned.  d_pad is a power of two with
// d <= d_pad <= 2^30.  Returns the launches' cudaGetLastError() (0 on success).
extern "C" int fwht_rows(const float* x, const float* signs, float* out,
                         int n, int d, int d_pad, int device, void* stream) {
    if (n < 0 || d < 0 || d_pad < 1 || (d_pad & (d_pad - 1)) || d > d_pad ||
        d_pad > (1 << kMaxLogDPad) || !aligned(out, 16)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int log_dpad = ilog2(d_pad);
    if (log_dpad < 2) {
        const unsigned grid = static_cast<unsigned>((n + 255) / 256);
        if (log_dpad == 0) {
            fwht_tiny_kernel<0><<<grid, 256, 0, s>>>(x, signs, out, n, d);
        } else {
            fwht_tiny_kernel<1><<<grid, 256, 0, s>>>(x, signs, out, n, d);
        }
        return static_cast<int>(cudaGetLastError());
    }
    const bool vec = d % 4 == 0 && aligned(x, 16) && aligned(signs, 16);
    const int log_d = log_dpad <= kMaxLogD ? log_dpad
                      : (log_dpad - kColStages <= kMaxLogD ? log_dpad - kColStages : kMaxLogD);
    const int log_chunks = log_dpad - log_d;
    err = first_pass(log_d, vec, x, signs, out, static_cast<int64_t>(n) << log_chunks,
                     log_chunks, d, d_pad, device, s);
    for (int s0 = log_d; err == cudaSuccess && s0 < log_dpad; s0 += kColStages) {
        const int log_m = log_dpad - s0 < kColStages ? log_dpad - s0 : kColStages;
        err = columns(log_m, out, (static_cast<int64_t>(n) << log_dpad) >> (5 + log_m), s0, s);
    }
    return static_cast<int>(err);
}
