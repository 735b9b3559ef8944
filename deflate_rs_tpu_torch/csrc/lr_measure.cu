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
// stands for no mismatch.  Words between LW and the end of the last step are
// measured like any other: their mismatches lie at or above `none` and are
// clamped to it, and their keys land in the padding of `best`.
template <bool kEdge>
__device__ __forceinline__ void walk(const Row& row, int k0, int sh, const uint32_t* base,
                                     int* best, int none, int steps, int slot, int lane) {
    constexpr int W = kWordsPerLane;
    const uint32_t* src = row.words + k0 + W * lane;
    auto word = [&](int at) {
        return kEdge ? aligned_word(row, k0 + W * lane + at) : __ldg(src + at);
    };
    const int from = (lane + 1) & 31;
    int carry = none;
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
        const int kw = slot - (w0 << 8);  // key = (first - 4w) << 6 | slot
#pragma unroll
        for (int i = 0; i < W; ++i) {
            const int first = min(own[i], after);
            if (i == 0) carry = __shfl_sync(kFull, first, 0);
            const int key = (first << 6) + kw - (i << 8);
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
    const uint8_t* rowp = bufs + (size_t)b * buf_len;
    Row row;
    row.r = (int)(reinterpret_cast<uintptr_t>(rowp) & 3);
    row.words = reinterpret_cast<const uint32_t*>(rowp - row.r);
    row.len = buf_len;
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
            walk<false>(row, k0, sh, base, best, 4 * LW, steps, slot, lane);
        } else {
            walk<true>(row, k0, sh, base, best, 4 * LW, steps, slot, lane);
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
