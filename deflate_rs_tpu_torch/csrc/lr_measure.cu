// lr_measure: the long-range dominant-distance measurement.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/lr_kernel.py::_kernel
// (lr_measure_batched, wrapped by longrange.local_dominant_lengths_tpu).
// Plain twin: deflate_rs_tpu_torch/ops/lr_kernel.py::lr_measure_plain.
//
// One block of 8 warps per (segment, chunk).  A block whose dominant row has
// no live slot (most segments of text) writes "no winner" and leaves.  The
// others stage the segment's base window (LW words: owned words plus the
// MAX_MATCH overhang, padded to whole steps) in shared memory once.  Then a
// WARP owns a dominant: warp v takes the live slots among v, v + 8, ... (dead
// slots, d <= 0, are skipped wherever they sit) and walks the window from its
// last step of 128 words to its first, each lane on 4 neighbouring words.
// Per step a lane reads its 4 aligned 32-bit words of the window d bytes back
// (loaded one step ahead), gets the word after them from its neighbour by
// shuffle (lane 31 from the step before, which held the words above), and
// builds the unaligned words with funnel shifts by 8 * (offset & 3); bytes
// outside the chunk's buffer read as zero, by masked loads that only the
// dominants near the buffer's ends pay for.  "First mismatching byte at or
// after word w" is a select chain over the lane's own 4 words, then a ballot
// of the lanes with any mismatch, a find-first-set above the lane and one
// shuffle; what lies above the step rides in a register from step to step.
// The dominant loop has no block barrier at all.
//
// Winners are combined per word across dominants in shared memory as a
// maximum over run << 6 | (63 - slot): the longest run wins and, among equal
// runs, the first slot (the twin's strict >).  The maximum is an atomicMax
// behind a plain read, since most dominants lose most words.  After one
// barrier the XOR of word w under the winner of word w + 1 is one more
// shifted load per word: 0 where word w + 1 has no winner and at the
// window's last word.
//
// Bound on the card: bytes on text (the three outputs, 16 bytes a word),
// integer instructions where most slots are live: a step costs a warp about
// 80 of them for 128 words, and the card runs integer work at half rate.
//
// The tiled path (lr_measure_tiled) takes the geometries the block above
// cannot: a window of more than kMaxWindow words (the lr_global pass
// measures the whole chunk as one segment: 9,283 words at the 4 KiB tier,
// 24,643 at 64 KiB, 73,795 at 256 KiB) or more than 64 slots (its union
// holds up to dom_segs * num_dom distances).  The window is cut into tiles
// of kTile words, one block per (tile, segment, chunk), so a batch of 64
// chunks fills the card.  A run from a word start must be exact over the
// whole window, not clipped at its tile's end (two dominants whose runs both
// pass 258 bytes are told apart by their true lengths), so it takes two
// passes.  Pass 1: per tile after the first and live slot, a warp scans the
// tile forwards to its first mismatching byte and stops there (one step on
// most text).  Pass 2: per tile, a warp per live slot takes the least of
// those positions over the tiles after its own (the carry) and walks its
// tile as the block above walks a window, starting from that carry.  The
// winner key is 64 bits, run << 32 | ~slot, so any slot count keeps "longest
// run, then first slot"; the first word of the next tile gets its key from
// the carry too, which gives the tile's last word its xor_next.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWordsPerLane = 4;
constexpr int kSpan = 32 * kWordsPerLane;  // words of a step
constexpr int kMaxSlots = 64;  // the slot rides in the key's low 6 bits
// Words of a window at most: base words and winner keys of the padded window
// and the dominant row fit the 48 KB of shared memory a block has without
// asking for more (a 256 KiB chunk in 32 segments measures 2,371 words).
constexpr int kMaxWindow = 5632;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One chunk's buffer seen as aligned words: `words` is the row's address
// rounded down to 4 bytes, `r` what was rounded off, `len` the row's bytes.
struct Row {
    const uint32_t* words;
    int r;
    int len;
};

// Chunk b's row of the batch's buffers.
__device__ __forceinline__ Row row_of(const uint8_t* bufs, int buf_len, int b) {
    const uint8_t* rowp = bufs + (size_t)b * buf_len;
    Row row;
    row.r = (int)(reinterpret_cast<uintptr_t>(rowp) & 3);
    row.words = reinterpret_cast<const uint32_t*>(rowp - row.r);
    row.len = buf_len;
    return row;
}

// Aligned word k of the row, bytes 4k - r .. 4k - r + 3 of the buffer; bytes
// outside [0, len) read as 0 (and a word wholly outside is not loaded).
__device__ __forceinline__ uint32_t aligned_word(const Row& row, int k) {
    const int lo = 4 * k - row.r;
    if (lo <= -4 || lo >= row.len) return 0u;
    uint32_t v = __ldg(row.words + k);
    if (lo < 0) v &= 0xFFFFFFFFu << (8 * -lo);
    if (lo + 4 > row.len) v &= 0xFFFFFFFFu >> (8 * (lo + 4 - row.len));
    return v;
}

// Packed little-endian bytes p..p+3 of the buffer, any p.
__device__ __forceinline__ uint32_t word_at(const Row& row, int p) {
    const int q = p + row.r;
    const int sh = 8 * (q & 3);
    const uint32_t lo = aligned_word(row, q >> 2);
    const uint32_t hi = sh ? aligned_word(row, (q >> 2) + 1) : 0u;
    return __funnelshift_r(lo, hi, sh);
}

// Matched low bytes of an XOR word: 0..3 up to its first non-zero byte, 4 if 0.
__device__ __forceinline__ int low_bytes(uint32_t x) {
    return __clz(__brev(x)) >> 3;
}

// One live dominant measured by one warp: the walk from the window's last
// step (kSpan = 32 * kWordsPerLane words) to its first; a lane owns
// kWordsPerLane neighbouring words of a step.  `kEdge`: the words d bytes back
// may lie outside the chunk's buffer and are loaded with bounds tests and
// masks; otherwise plain.  Positions are bytes of the window; `none` = 4 * LW
// stands for no mismatch, and `carry` is the first mismatch after the steps
// (`none` for a whole window, the later tiles' for a tile).  Words between LW
// and the end of the last step are measured like any other: their
// mismatches lie at or above `none` and are clamped to it, and their keys
// land in the padding of `best`.  Keys are run << kShift | tag, a maximum
// per word: an int with tag 63 - m for the block path (kShift 6), 64 bits
// with tag ~m for the tiled path (kShift 32).
template <bool kEdge, class Key, int kShift>
__device__ __forceinline__ void walk(const Row& row, int k0, int sh, const uint32_t* base,
                                     Key* best, int none, int carry, int steps, Key tag,
                                     int lane) {
    constexpr int W = kWordsPerLane;
    const uint32_t* src = row.words + k0 + W * lane;
    auto word = [&](int at) {
        return kEdge ? aligned_word(row, k0 + W * lane + at) : __ldg(src + at);
    };
    const int from = (lane + 1) & 31;
    uint32_t above = lane == 0 ? word(steps * kSpan) : 0u;  // the first word past the steps
    uint32_t ahead[W];
#pragma unroll
    for (int i = 0; i < W; ++i) ahead[i] = word((steps - 1) * kSpan + i);
    for (int c = steps - 1; c >= 0; --c) {
        uint32_t a[W + 1];
#pragma unroll
        for (int i = 0; i < W; ++i) a[i] = ahead[i];
        if (c > 0) {
#pragma unroll
            for (int i = 0; i < W; ++i) ahead[i] = word((c - 1) * kSpan + i);
        }
        // The word after a lane's last is the next lane's first; lane 31
        // takes the first word of the step above, which lane 0 holds.
        a[W] = __shfl_sync(kFull, lane == 0 ? above : a[0], from);
        above = a[0];
        const int w0 = c * kSpan + W * lane;
        uint32_t x[W];
        uint32_t any = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) {
            x[i] = base[w0 + i] ^ __funnelshift_r(a[i], a[i + 1], sh);
            any |= x[i];
        }
        // own[i]: the first mismatch at or after word i inside this lane.
        int own[W];
        int later = INT_MAX;
#pragma unroll
        for (int i = W - 1; i >= 0; --i) {
            later = x[i] ? 4 * (w0 + i) + low_bytes(x[i]) : later;
            own[i] = later;
        }
        const unsigned rest = (__ballot_sync(kFull, any != 0) >> lane) >> 1;  // lanes above
        const int theirs = __shfl_sync(kFull, own[0], lane + __ffs(rest));
        const int after = min(rest ? theirs : carry, none);
        const Key kw = tag - ((Key)w0 << (kShift + 2));  // key = (first - 4w) << kShift | tag
#pragma unroll
        for (int i = 0; i < W; ++i) {
            const int first = min(own[i], after);
            if (i == 0) carry = __shfl_sync(kFull, first, 0);
            const Key key = ((Key)first << kShift) + kw - ((Key)i << (kShift + 2));
            if (key > best[w0 + i]) atomicMax(&best[w0 + i], key);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
lr_measure_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                  const int* __restrict__ doms, int S, int M, int L, int LW,
                  int* __restrict__ run_out, int* __restrict__ dist_out,
                  long long* __restrict__ xn_out) {
    extern __shared__ int smem[];
    const int steps = (LW + kSpan - 1) / kSpan;
    const int padded = steps * kSpan;
    uint32_t* base = reinterpret_cast<uint32_t*>(smem);  // [padded] base words
    int* best = smem + padded;                           // [padded] winning keys
    int* dist = smem + 2 * padded;                       // [M] the dominant row
    const int s = blockIdx.x;
    const int b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Row row = row_of(bufs, buf_len, b);
    const int pos0 = s * L;
    const int* drow = doms + ((size_t)b * S + s) * M;
    const size_t o = ((size_t)b * S + s) * LW;  // this segment's row of the outputs
    int alive = 0;
    for (int m = threadIdx.x; m < M; m += kThreads) {
        dist[m] = drow[m];
        alive |= dist[m] > 0;
    }
    if (!__syncthreads_or(alive)) {
        // No live dominant (most segments of text): nothing wins anywhere.
        for (int w = threadIdx.x; w < LW; w += kThreads) {
            run_out[o + w] = -1;
            dist_out[o + w] = 0;
            xn_out[o + w] = 0;
        }
        return;
    }
    for (int w = threadIdx.x; w < padded; w += kThreads) {
        base[w] = word_at(row, pos0 + 4 * w);
        best[w] = -1;
    }
    __syncthreads();

    for (int m = warp; m < M; m += kWarps) {
        const int d = dist[m];
        if (d <= 0) continue;  // dead slot: never wins (uniform per warp)
        const int q0 = pos0 - d + row.r;
        const int k0 = q0 >> 2;  // aligned word under the window's first byte
        const int sh = 8 * (q0 & 3);
        const int slot = kMaxSlots - 1 - m;
        // The walk reads aligned words k0 .. k0 + padded.
        if (4 * k0 - row.r >= 0 && 4 * (k0 + padded + 1) - row.r <= row.len) {
            walk<false, int, 6>(row, k0, sh, base, best, 4 * LW, 4 * LW, steps, slot, lane);
        } else {
            walk<true, int, 6>(row, k0, sh, base, best, 4 * LW, 4 * LW, steps, slot, lane);
        }
    }
    __syncthreads();

    for (int w = threadIdx.x; w < LW; w += kThreads) {
        const int key = best[w];
        const int next = w + 1 < LW ? best[w + 1] : -1;
        uint32_t xn = 0;
        if (next >= 0) {
            xn = base[w] ^ word_at(row, pos0 + 4 * w - dist[kMaxSlots - 1 - (next & 63)]);
        }
        run_out[o + w] = key < 0 ? -1 : key >> 6;
        dist_out[o + w] = key < 0 ? 0 : dist[kMaxSlots - 1 - (key & 63)];
        xn_out[o + w] = (long long)xn;
    }
}

constexpr int kTile = 16 * kSpan;  // words of a tile of the tiled path

// Pass 1, block (t - 1, s, b) for tile t >= 1: per live slot m, the window
// byte of the tile's first mismatch (4 * LW where the tile has none) into
// first_out[b, s, m, t].  A warp steps forwards through the tile, each lane
// on 4 words, and stops at the first step with a mismatch.
__global__ void __launch_bounds__(kThreads)
lr_tile_first_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                     const int* __restrict__ doms, int S, int M, int L, int LW, int tiles,
                     int* __restrict__ first_out) {
    __shared__ uint32_t base[kTile];
    const int t = blockIdx.x + 1;
    const int s = blockIdx.y;
    const int b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Row row = row_of(bufs, buf_len, b);
    const int tw0 = t * kTile;
    const int nw = min(kTile, LW - tw0);  // the tile's words inside the window
    const int pos0 = s * L + 4 * tw0;     // the tile's first byte in the buffer
    const int* drow = doms + ((size_t)b * S + s) * M;
    int alive = 0;
    for (int m = threadIdx.x; m < M; m += kThreads) alive |= __ldg(drow + m) > 0;
    if (!__syncthreads_or(alive)) return;
    for (int w = threadIdx.x; w < nw; w += kThreads) base[w] = word_at(row, pos0 + 4 * w);
    __syncthreads();

    constexpr int W = kWordsPerLane;
    for (int m = warp; m < M; m += kWarps) {
        const int d = __ldg(drow + m);
        if (d <= 0) continue;  // uniform per warp
        const int q0 = pos0 - d + row.r;
        const int k0 = q0 >> 2;
        const int sh = 8 * (q0 & 3);
        int found = 4 * LW;
        for (int w0 = 0; w0 < nw; w0 += kSpan) {
            const int w = w0 + W * lane;
            uint32_t a[W + 1];
#pragma unroll
            for (int i = 0; i <= W; ++i) a[i] = aligned_word(row, k0 + w + i);
            int own = INT_MAX;
#pragma unroll
            for (int i = W - 1; i >= 0; --i) {
                if (w + i < nw) {
                    const uint32_t x = base[w + i] ^ __funnelshift_r(a[i], a[i + 1], sh);
                    if (x) own = 4 * (w + i) + low_bytes(x);
                }
            }
            const unsigned hit = __ballot_sync(kFull, own != INT_MAX);
            if (hit) {
                found = 4 * tw0 + __shfl_sync(kFull, own, __ffs(hit) - 1);
                break;
            }
        }
        if (lane == 0) first_out[(((size_t)b * S + s) * M + m) * tiles + t] = found;
    }
}

// Pass 2, block (t, s, b): the tile's words, as lr_measure_kernel measures a
// window, each live slot's walk starting from the least first mismatch of
// the tiles after this one.
__global__ void __launch_bounds__(kThreads)
lr_tile_walk_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                    const int* __restrict__ doms, int S, int M, int L, int LW, int tiles,
                    const int* __restrict__ first_in, int* __restrict__ run_out,
                    int* __restrict__ dist_out, long long* __restrict__ xn_out) {
    __shared__ uint32_t base[kTile];
    __shared__ unsigned long long best[kTile + 1];  // and the next tile's first word
    const int t = blockIdx.x;
    const int s = blockIdx.y;
    const int b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Row row = row_of(bufs, buf_len, b);
    const int tw0 = t * kTile;
    const int nw = min(kTile, LW - tw0);
    const int steps = (nw + kSpan - 1) / kSpan;
    const int padded = steps * kSpan;
    const int pos0 = s * L + 4 * tw0;
    const int* drow = doms + ((size_t)b * S + s) * M;
    const size_t o = ((size_t)b * S + s) * LW + tw0;  // the tile's first output
    int alive = 0;
    for (int m = threadIdx.x; m < M; m += kThreads) alive |= __ldg(drow + m) > 0;
    if (!__syncthreads_or(alive)) {
        for (int w = threadIdx.x; w < nw; w += kThreads) {
            run_out[o + w] = -1;
            dist_out[o + w] = 0;
            xn_out[o + w] = 0;
        }
        return;
    }
    for (int w = threadIdx.x; w < padded; w += kThreads) {
        base[w] = word_at(row, pos0 + 4 * w);
        best[w] = 0;
    }
    if (threadIdx.x == 0) best[kTile] = 0;
    __syncthreads();

    const int none = 4 * (LW - tw0);  // tile bytes from here on
    for (int m = warp; m < M; m += kWarps) {
        const int d = __ldg(drow + m);
        if (d <= 0) continue;
        const int* f = first_in + (((size_t)b * S + s) * M + m) * tiles;
        int c = 4 * LW;
        for (int u = t + 1 + lane; u < tiles; u += 32) c = min(c, __ldg(f + u));
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) c = min(c, __shfl_xor_sync(kFull, c, k));
        const int carry = c - 4 * tw0;
        const unsigned long long tag = ~(unsigned)m;
        // The next tile's first word starts its run at the carry.
        if (lane == 0 && t + 1 < tiles) {
            atomicMax(&best[kTile], (unsigned long long)(carry - 4 * kTile) << 32 | tag);
        }
        const int q0 = pos0 - d + row.r;
        const int k0 = q0 >> 2;
        const int sh = 8 * (q0 & 3);
        if (4 * k0 - row.r >= 0 && 4 * (k0 + padded + 1) - row.r <= row.len) {
            walk<false, unsigned long long, 32>(row, k0, sh, base, best, none, carry, steps, tag,
                                                lane);
        } else {
            walk<true, unsigned long long, 32>(row, k0, sh, base, best, none, carry, steps, tag,
                                               lane);
        }
    }
    __syncthreads();

    for (int w = threadIdx.x; w < nw; w += kThreads) {
        const unsigned long long key = best[w];
        const unsigned long long next = tw0 + w + 1 < LW ? best[w + 1] : 0ull;
        uint32_t xn = 0;
        if (next) xn = base[w] ^ word_at(row, pos0 + 4 * w - __ldg(drow + ~(unsigned)next));
        run_out[o + w] = key ? (int)(key >> 32) : -1;
        dist_out[o + w] = key ? __ldg(drow + ~(unsigned)key) : 0;
        xn_out[o + w] = (long long)xn;
    }
}

}  // namespace

extern "C" int lr_measure(const uint8_t* bufs, int buf_len, const int* doms, int B,
                          int S, int M, int L, int LW, int* run_out, int* dist_out,
                          long long* xn_out, cudaStream_t stream) {
    if (M > kMaxSlots || LW > kMaxWindow) return (int)cudaErrorInvalidValue;
    const int padded = (LW + kSpan - 1) / kSpan * kSpan;
    const size_t shmem = (2 * padded + M) * sizeof(int);
    dim3 grid(S, B);
    lr_measure_kernel<<<grid, kThreads, shmem, stream>>>(bufs, buf_len, doms, S, M, L, LW,
                                                        run_out, dist_out, xn_out);
    return (int)cudaGetLastError();
}

// The tiled path: any window width and slot count.  `first_scratch` holds
// int32[B, S, M, tiles] (tiles = ceil(LW / kTile)); its entries of dead
// slots and of tile 0 are never written or read.
extern "C" int lr_measure_tiled(const uint8_t* bufs, int buf_len, const int* doms, int B,
                                int S, int M, int L, int LW, int* first_scratch,
                                int* run_out, int* dist_out, long long* xn_out,
                                cudaStream_t stream) {
    const int tiles = (LW + kTile - 1) / kTile;
    if (tiles > 1) {
        lr_tile_first_kernel<<<dim3(tiles - 1, S, B), kThreads, 0, stream>>>(
            bufs, buf_len, doms, S, M, L, LW, tiles, first_scratch);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    lr_tile_walk_kernel<<<dim3(tiles, S, B), kThreads, 0, stream>>>(
        bufs, buf_len, doms, S, M, L, LW, tiles, first_scratch, run_out, dist_out, xn_out);
    return (int)cudaGetLastError();
}
