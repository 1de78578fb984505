// Top-k select over the last axis of f32 scores: the k best of each row,
// best first, as (value, column) pairs, with an optional live mask over the
// columns (a dead column scores `neg`).
//
// Replaces no TPU kernel: the reference takes its top-k with lax.top_k, a
// library op (src/repro/core/scoring.py), and the port took it with a full
// stable torch.sort of every row cut to k.  This kernel was added because
// that sort was most of a full scan's device time: at [256 x 1,000,000] it
// moved the 1 GB of scores and 2 GB of int64 indices through several radix
// passes, to keep 10 of each row.
//
// The order is the sort's, total and unique: each element's rank is
//   (order key of its value) * 2^31 + (2^31 - 1 - column),
// larger ranks first.  The order key is the f32's bits as CUB's radix sort
// ranks them: -0.0 as +0.0, a value with its sign bit set with every bit
// flipped, any other with its sign bit set; so +NaN ranks above +inf and a
// NaN with its sign bit set below -inf.  Among equal keys the lower column
// ranks higher: the stable sort's tie rule.  Every step keeps the k highest
// ranks of what it has seen, so the answer does not depend on how blocks
// are scheduled.  No float atomics, no atomics at all.
//
// Bound: the [b, n] f32 scores read once, 4 b n bytes: 1.02 GB at
// [256 x 1,000,000], 0.31 ms at the NVIDIA H100's 3.35 TB/s; 92 MB, 0.027
// ms, at [512 x 45,000].  The candidates and outputs are b n k 8 / chunk
// bytes more (0.4% at chunk 8,192, k 10).
//
// Design, two launches:
//   - select_chunks: one warp a (row, chunk of columns) unit, 8 warps a
//     block.  The warp streams its chunk with 16-byte streaming loads, 4 in
//     flight a lane (the chunk's first and last < 4 columns off 16-byte
//     alignment one a lane), a dead column's value replaced by `neg` (the
//     live bytes of 4 columns read as one word), and keeps the chunk's k
//     best ranks so far as a list sorted best first across its lanes,
//     entry w * 32 + lane in a lane's word w (k <= 32: one word, k <= 64:
//     two).  A rank is rejected
//     with one 64-bit compare against the list's k-th entry, held on every
//     lane; a warp vote skips the insert path for 512 elements at a time.
//     An insert is warp-wide: each lane takes its left neighbour's entry
//     (one shuffle a word) where the newcomer ranks above it.  The warp
//     writes its k entries (0 where the chunk had fewer) to the scratch.
//   - merge_rows: one warp a row keeps the k best of the row's chunks * k
//     candidates the same way and writes each value (re-read from the
//     scores, or `neg` where the column is dead) and its column.
// The wrapper (kernels/topk_select.py) sizes the chunk so that the units
// fill the card several times over, and allocates the scratch and outputs
// with torch.empty: the kernels allocate nothing and never synchronise, so
// a CUDA graph captures them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (kernels/cuda_build.py); loaded through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBlockWarps = 8;
constexpr int kThreads = kWarp * kBlockWarps;
constexpr int kUnroll = 4;         // 16-byte loads a lane keeps in flight (select_chunks)
constexpr int kMergeUnroll = 8;    // candidates a lane loads at once (merge_rows)
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kColMask = 0x7fffffffu;

// The f32's place in CUB's radix order of floats, as an unsigned key.
__device__ __forceinline__ uint32_t order_key(float v) {
    uint32_t u = __float_as_uint(v);
    if (u == 0x80000000u) u = 0u;    // -0.0 ranks as +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// An element's rank in its row: higher is better, unique per column, >= 1
// for every column < 2^31 - 1 (0 marks an empty entry).
__device__ __forceinline__ uint64_t rank_of(float v, int col) {
    return (static_cast<uint64_t>(order_key(v)) << 31) | (kColMask - static_cast<uint32_t>(col));
}

__device__ __forceinline__ int col_of(uint64_t rank) {
    return static_cast<int>(kColMask - static_cast<uint32_t>(rank & kColMask));
}

template <bool kLive>
__device__ __forceinline__ float masked(float v, const uint8_t* __restrict__ live, int col,
                                        float neg) {
    return (kLive && !__ldg(live + col)) ? neg : v;
}

// The k best ranks a warp has been offered, best first: entry w * 32 + lane
// in word w of that lane; `floor` is entry k - 1 on every lane.
template <int kWords>
struct WarpTop {
    uint64_t e[kWords];
    uint64_t floor;
    int last_word;
    int last_lane;

    __device__ __forceinline__ void init(int k) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) e[w] = 0;
        floor = 0;
        last_word = (k - 1) / kWarp;
        last_lane = (k - 1) % kWarp;
    }

    // Insert x, the same on every lane, above `floor` and unlike every entry.
    __device__ __forceinline__ void insert(uint64_t x, int lane) {
        uint64_t prev[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
            const uint64_t up = __shfl_up_sync(kFull, e[w], 1);
            const uint64_t carry = w ? __shfl_sync(kFull, e[w > 0 ? w - 1 : 0], kWarp - 1)
                                     : ~0ull;
            prev[w] = lane ? up : carry;
        }
        uint64_t last = e[0];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
            e[w] = e[w] > x ? e[w] : (prev[w] > x ? x : prev[w]);
            if (w == last_word) last = e[w];
        }
        floor = __shfl_sync(kFull, last, last_lane);
    }

    // Insert each lane's x that ranks above the floor (0: none), lowest lane first.
    __device__ __forceinline__ void offer(uint64_t x, int lane) {
        unsigned pending = __ballot_sync(kFull, x > floor);
        while (pending) {
            const int src = __ffs(pending) - 1;
            insert(__shfl_sync(kFull, x, src), lane);
            pending &= (pending - 1) & __ballot_sync(kFull, x > floor);
        }
    }
};

__device__ __forceinline__ float lane_of(const float4& q, int j) {
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

template <int kWords, bool kLive>
__global__ void __launch_bounds__(kThreads)
select_chunks(const float* __restrict__ scores, int64_t row_stride,
              const uint8_t* __restrict__ live, float neg, uint64_t* __restrict__ cand,
              int b, int n, int chunk, int chunks, int k) {
    const int lane = threadIdx.x % kWarp;
    const int64_t unit = static_cast<int64_t>(blockIdx.x) * kBlockWarps + threadIdx.x / kWarp;
    if (unit >= static_cast<int64_t>(b) * chunks) return;    // the whole warp
    const int r = static_cast<int>(unit / chunks);
    const int c0 = static_cast<int>(unit % chunks) * chunk;
    const int c1 = min(n, c0 + chunk);
    const float* row = scores + r * row_stride;

    // Columns [v0, v1) in 16-byte loads; the < 4 before and after one a lane.
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row + c0) / 4) % 4);
    const int v0 = min(c1, c0 + (4 - mis) % 4);
    const int nvec = (c1 - v0) / 4;
    const int v1 = v0 + 4 * nvec;

    WarpTop<kWords> top;
    top.init(k);
    {
        const int head = v0 - c0;
        int col = -1;
        if (lane < head) col = c0 + lane;
        else if (lane - head < c1 - v1) col = v1 + lane - head;
        top.offer(col >= 0 ? rank_of(masked<kLive>(row[col], live, col, neg), col) : 0, lane);
    }
    const float4* body = reinterpret_cast<const float4*>(row + v0);
    // The live bytes of a float4's 4 columns as one word where they lie on
    // a 4-byte boundary (the rule: rows 16-byte aligned), else byte by byte.
    const bool live_words = kLive && reinterpret_cast<uintptr_t>(live + v0) % 4 == 0;
    for (int base = 0; base < nvec; base += kWarp * kUnroll) {
        float4 q[kUnroll];
        uint32_t lv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int i = base + u * kWarp + lane;
            q[u] = i < nvec ? __ldcs(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int i = base + u * kWarp + lane;
            lv[u] = 0x01010101u;
            if (kLive && i < nvec) {
                const uint8_t* l = live + v0 + 4 * i;
                lv[u] = live_words ? __ldg(reinterpret_cast<const uint32_t*>(l))
                                   : (__ldg(l) | __ldg(l + 1) << 8 | __ldg(l + 2) << 16 |
                                      static_cast<uint32_t>(__ldg(l + 3)) << 24);
            }
        }
        // Column v0 + 4 i + j's rank (0 past the chunk's end).
        auto rank_at = [&](int u, int j) -> uint64_t {
            const int i = base + u * kWarp + lane;
            const float v = ((lv[u] >> (8 * j)) & 0xffu) ? lane_of(q[u], j) : neg;
            return i < nvec ? rank_of(v, v0 + 4 * i + j) : 0;
        };
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int j = 0; j < 4; ++j) hit |= rank_at(u, j) > top.floor;
        }
        if (!__any_sync(kFull, hit)) continue;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int j = 0; j < 4; ++j) top.offer(rank_at(u, j), lane);
        }
    }
    uint64_t* out = cand + unit * k;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
        const int pos = w * kWarp + lane;
        if (pos < k) out[pos] = top.e[w];
    }
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
merge_rows(const uint64_t* __restrict__ cand, int m, const float* __restrict__ scores,
           int64_t row_stride, const uint8_t* __restrict__ live, float neg,
           float* __restrict__ vals, int64_t* __restrict__ idx, int b, int k) {
    const int lane = threadIdx.x % kWarp;
    const int r = blockIdx.x * kBlockWarps + threadIdx.x / kWarp;
    if (r >= b) return;    // the whole warp
    const uint64_t* rc = cand + static_cast<int64_t>(r) * m;

    WarpTop<kWords> top;
    top.init(k);
    for (int base = 0; base < m; base += kWarp * kMergeUnroll) {
        uint64_t x[kMergeUnroll];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) {
            const int i = base + u * kWarp + lane;
            x[u] = i < m ? rc[i] : 0;
            hit |= x[u] > top.floor;
        }
        if (!__any_sync(kFull, hit)) continue;
#pragma unroll
        for (int u = 0; u < kMergeUnroll; ++u) top.offer(x[u], lane);
    }
    const float* row = scores + r * row_stride;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
        const int pos = w * kWarp + lane;
        if (pos < k) {
            const int col = col_of(top.e[w]);
            float v = row[col];
            if (live != nullptr && !live[col]) v = neg;
            vals[static_cast<int64_t>(r) * k + pos] = v;
            idx[static_cast<int64_t>(r) * k + pos] = col;
        }
    }
}

template <int kWords>
void launch(const float* scores, int64_t row_stride, const uint8_t* live, float neg,
            uint64_t* cand, float* vals, int64_t* idx, int b, int n, int k, int chunk,
            int chunks, cudaStream_t s) {
    const int64_t units = static_cast<int64_t>(b) * chunks;
    const unsigned blocks = static_cast<unsigned>((units + kBlockWarps - 1) / kBlockWarps);
    if (live != nullptr) {
        select_chunks<kWords, true><<<blocks, kThreads, 0, s>>>(scores, row_stride, live, neg,
                                                                 cand, b, n, chunk, chunks, k);
    } else {
        select_chunks<kWords, false><<<blocks, kThreads, 0, s>>>(scores, row_stride, live, neg,
                                                                  cand, b, n, chunk, chunks, k);
    }
    if (cudaPeekAtLastError() != cudaSuccess) return;
    merge_rows<kWords><<<(b + kBlockWarps - 1) / kBlockWarps, kThreads, 0, s>>>(
        cand, chunks * k, scores, row_stride, live, neg, vals, idx, b, k);
}

}  // namespace

extern "C" const char* topk_select_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scores: b rows of n f32, row_stride floats apart (columns contiguous);
// live: [n] bool (one byte each) or null; cand: [b, ceil(n / chunk), k]
// uint64 scratch; vals: [b, k] f32 and idx: [b, k] int64, contiguous; all on
// `device`.  1 <= k <= 64, k <= n < 2^31 - 1, chunk a positive multiple of
// 4.  Two launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int topk_select(const float* scores, int64_t row_stride, const uint8_t* live,
                           float neg, uint64_t* cand, float* vals, int64_t* idx, int b, int n,
                           int k, int chunk, int device, void* stream) {
    if (k < 1 || k > kMaxK || n < k || n >= static_cast<int>(kColMask) || chunk < 4 ||
        chunk % 4 || row_stride < n || b < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b == 0) return 0;
    const int chunks = (n + chunk - 1) / chunk;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= kWarp) {
        launch<1>(scores, row_stride, live, neg, cand, vals, idx, b, n, k, chunk, chunks, s);
    } else {
        launch<2>(scores, row_stride, live, neg, cand, vals, idx, b, n, k, chunk, chunks, s);
    }
    return static_cast<int>(cudaGetLastError());
}
