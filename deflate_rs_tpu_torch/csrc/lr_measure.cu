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
// holds up to dom_segs * num_dom distances, 3,072 at Default).  Its work is
// a walk per (live slot, tile of kTile words), the block path's walk, and
// it is bound by integer instructions (about 80 a step of 128 words per
// warp) and the L2 reads of the windows d bytes back.  What held it back was
// how that work was spread: one block per (tile, chunk), whose 8 warps took
// the live slots in turn, made 13 blocks for one 64 KiB chunk on 132 SMs,
// each warp walking 5 slots one after another, and at 64 chunks let the
// chunk with the most live slots set the pace.  So the grid runs over
// (tile, group of live slots, chunk x segment): every block does the same
// work.  A group is 8 live slots (a warp each) where that is needed to make
// kMinBlocks blocks (one chunk at D = 64: about 125 blocks that work), and
// 16 or 32 (the warps take them in turn) where the grid is large anyway,
// which saves the per-block costs (ranking the slots, staging the tile's
// words, merging the keys).  A block ranks the row's live slots itself
// (dead slots, d <= 0, are skipped wherever they sit) and leaves where its
// group is empty.
//
// A run from a word start must be exact over the whole window, not clipped
// at its tile's end (two dominants whose runs both pass 258 bytes are told
// apart by their true lengths), so the walk of a tile starts from a carry:
// the least first mismatch of the tiles after it.  Three launches:
// lr_tile_first_kernel zeroes the winner keys and, per tile after the first
// and live slot, scans the tile forwards to its first mismatching byte (one
// step on most text); lr_tile_walk_kernel walks each tile from its carry and
// keeps the block's per-word maxima in shared memory, then merges them into
// one key per word in device memory with an atomicMax a word (6.3 MB at 64
// chunks of 64 KiB: it stays in L2); lr_tile_finish_kernel turns the keys
// into run, dist and xor_next.
//
// A key is (run + 1) << sb | (2^sb - 1 - slot), 0 for no winner: the longest
// run wins and, among equal runs, the first slot (the twin's strict >, as
// jax.lax.top_k's lower index).  sb is the fewest bits that hold a slot
// index; the key is 32 bits wide wherever (4 LW + 1) << sb fits them (a run
// is at most 4 LW bytes: 295,180 at the widest window, so up to 8,192 slots
// there), which makes the shared-memory maximum one native ATOMS.MAX (a
// 64-bit one is a compare-and-swap loop).  Wider ones take 64-bit keys with
// sb = 32.  The walk reads its base words and keys four at a time
// (LDS.128), so the lane stride of 4 words costs no bank conflicts.

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

// Four keys from a 16-byte aligned address of shared memory.
template <class Key>
__device__ __forceinline__ void load4(const Key* p, Key* v) {
    if constexpr (sizeof(Key) == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        v[0] = (Key)q.x; v[1] = (Key)q.y; v[2] = (Key)q.z; v[3] = (Key)q.w;
    } else {
        const ulonglong2 lo = reinterpret_cast<const ulonglong2*>(p)[0];
        const ulonglong2 hi = reinterpret_cast<const ulonglong2*>(p)[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    }
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
// land in the padding of `best`.  Keys are run << shift | tag, a maximum
// per word: an int with tag 63 - m for the block path (shift 6); for the
// tiled path 32 or 64 bits, tag 2^sb + 2^sb - 1 - m (the run plus one) and
// shift sb.  `kVec`: base words and keys are read four at a time (`base`
// and `best` 16-byte aligned); the block path reads them one at a time,
// which keeps it at 48 registers (four at a time: 80, and 13-21 % slower).
template <bool kEdge, bool kVec, class Key>
__device__ __forceinline__ void walk(const Row& row, int k0, int sh, const uint32_t* base,
                                     Key* best, int none, int carry, int steps, Key tag,
                                     int shift, int lane) {
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
        uint32_t bw[W];
        if constexpr (kVec) {
            load4(base + w0, bw);
        } else {
#pragma unroll
            for (int i = 0; i < W; ++i) bw[i] = base[w0 + i];
        }
        uint32_t x[W];
        uint32_t any = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) {
            x[i] = bw[i] ^ __funnelshift_r(a[i], a[i + 1], sh);
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
        const Key kw = tag - ((Key)w0 << (shift + 2));  // key = (first - 4w) << shift | tag
        Key cur[W];
        if constexpr (kVec) load4(best + w0, cur);
#pragma unroll
        for (int i = 0; i < W; ++i) {
            const int first = min(own[i], after);
            if (i == 0) carry = __shfl_sync(kFull, first, 0);
            const Key key = ((Key)first << shift) + kw - ((Key)i << (shift + 2));
            if (key > (kVec ? cur[i] : best[w0 + i])) atomicMax(&best[w0 + i], key);
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
            walk<false, false, int>(row, k0, sh, base, best, 4 * LW, 4 * LW, steps, slot, 6,
                                    lane);
        } else {
            walk<true, false, int>(row, k0, sh, base, best, 4 * LW, 4 * LW, steps, slot, 6,
                                   lane);
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

constexpr int kTile = 8 * kSpan;  // words of a tile of the tiled path
// Live slots of a block of the tiled path: 8, 16 or 32, the most that still
// makes kMinBlocks blocks (the warps take a group's slots in turn).
constexpr int kMaxGroup = 32;
constexpr int kMinBlocks = 2048;

// The tiled path's block (t, g, b * S + s) ranks the live slots of its
// dominant row and takes those of rank g * group .. g * group + group - 1
// into slots[]; returns how many (0 where the group is empty).  Every
// thread of the block calls it (it holds barriers).
__device__ int group_slots(const int* drow, int M, int g, int group, int* slots, int* counts) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int lo = g * group;
    int before = 0;  // live slots before this round's
    for (int m0 = 0; m0 < M; m0 += kThreads) {
        const int m = m0 + threadIdx.x;
        const bool alive = m < M && __ldg(drow + m) > 0;
        const unsigned bal = __ballot_sync(kFull, alive);
        if (lane == 0) counts[warp] = __popc(bal);
        __syncthreads();
        int rank = before + __popc(bal & ((1u << lane) - 1));
        for (int v = 0; v < kWarps; ++v) {
            rank += v < warp ? counts[v] : 0;
            before += counts[v];
        }
        if (alive && rank >= lo && rank < lo + group) slots[rank - lo] = m;
        __syncthreads();
    }
    return max(0, min(group, before - lo));
}

// One warp's first mismatch in a tile of nw words: the tile byte of the
// first byte where the base words (aligned words from kb, shifted by shb)
// and the words d bytes back (from k0, shifted by sh) differ, or `none`.
// The warp steps forwards, each lane on 4 words, and stops at the first
// step with a mismatch (one step on most text).
__device__ int first_mismatch(const Row& row, int kb, int shb, int k0, int sh, int nw, int none,
                              int lane) {
    constexpr int W = kWordsPerLane;
    for (int w0 = 0; w0 < nw; w0 += kSpan) {
        const int w = w0 + W * lane;
        uint32_t a[W + 1], c[W + 1];
#pragma unroll
        for (int i = 0; i <= W; ++i) {
            a[i] = aligned_word(row, k0 + w + i);
            c[i] = aligned_word(row, kb + w + i);
        }
        int own = INT_MAX;
#pragma unroll
        for (int i = W - 1; i >= 0; --i) {
            if (w + i < nw) {
                const uint32_t x = __funnelshift_r(c[i], c[i + 1], shb) ^
                                   __funnelshift_r(a[i], a[i + 1], sh);
                if (x) own = 4 * (w + i) + low_bytes(x);
            }
        }
        const unsigned hit = __ballot_sync(kFull, own != INT_MAX);
        if (hit) return __shfl_sync(kFull, own, __ffs(hit) - 1);
    }
    return none;
}

// Pass 1, block (t, g, b * S + s).  Group 0 zeroes the tile's winner keys.
// For t >= 1, the warps take the group's live slots in turn and write, per
// slot m, the window byte of the tile's first mismatch (4 * LW where the tile
// has none) into first_out[b, s, m, t].
template <class Key>
__global__ void __launch_bounds__(kThreads)
lr_tile_first_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                     const int* __restrict__ doms, int S, int M, int L, int LW, int tiles,
                     int group, int* __restrict__ first_out, Key* __restrict__ keys) {
    __shared__ int slots[kMaxGroup];
    __shared__ int counts[kWarps];
    const int t = blockIdx.x;
    const int g = blockIdx.y;
    const int bs = blockIdx.z;
    const int tw0 = t * kTile;
    const int nw = min(kTile, LW - tw0);  // the tile's words inside the window
    if (g == 0) {
        for (int w = threadIdx.x; w < nw; w += kThreads) keys[(size_t)bs * LW + tw0 + w] = 0;
    }
    if (t == 0) return;
    const int* drow = doms + (size_t)bs * M;
    const int n = group_slots(drow, M, g, group, slots, counts);
    const int lane = threadIdx.x & 31;
    const Row row = row_of(bufs, buf_len, bs / S);
    const int pos0 = (bs % S) * L + 4 * tw0;  // the tile's first byte in the buffer
    const int kb = (pos0 + row.r) >> 2;      // aligned word under it
    const int shb = 8 * ((pos0 + row.r) & 3);
    for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
        const int m = slots[j];
        const int q0 = pos0 - __ldg(drow + m) + row.r;
        const int first = first_mismatch(row, kb, shb, q0 >> 2, 8 * (q0 & 3), nw,
                                         4 * (LW - tw0), lane);
        if (lane == 0) first_out[((size_t)bs * M + m) * tiles + t] = 4 * tw0 + first;
    }
}

// Pass 2, block (t, g, b * S + s): the warps take the group's live slots in
// turn and walk the tile for each, as lr_measure_kernel walks a window,
// starting from the least first mismatch of the tiles after this one; the
// block's maxima per word are then merged into keys[b, s, :] with one
// atomicMax a word.
template <class Key>
__global__ void __launch_bounds__(kThreads)
lr_tile_walk_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                    const int* __restrict__ doms, int S, int M, int L, int LW, int tiles,
                    int group, int sb, const int* __restrict__ first_in,
                    Key* __restrict__ keys) {
    __shared__ __align__(16) uint32_t base[kTile];
    __shared__ __align__(16) Key best[kTile];
    __shared__ int slots[kMaxGroup];
    __shared__ int counts[kWarps];
    const int t = blockIdx.x;
    const int g = blockIdx.y;
    const int bs = blockIdx.z;
    const int* drow = doms + (size_t)bs * M;
    const int n = group_slots(drow, M, g, group, slots, counts);
    if (n == 0) return;  // uniform: no live slot of this rank
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const Row row = row_of(bufs, buf_len, bs / S);
    const int tw0 = t * kTile;
    const int nw = min(kTile, LW - tw0);
    const int steps = (nw + kSpan - 1) / kSpan;
    const int padded = steps * kSpan;
    const int pos0 = (bs % S) * L + 4 * tw0;
    for (int w = threadIdx.x; w < padded; w += kThreads) {
        base[w] = word_at(row, pos0 + 4 * w);
        best[w] = 0;
    }
    __syncthreads();

    for (int j = warp; j < n; j += kWarps) {
        const int m = slots[j];
        const int d = __ldg(drow + m);
        const int* f = first_in + ((size_t)bs * M + m) * tiles;
        int c = 4 * LW;
        for (int u = t + 1 + lane; u < tiles; u += 32) c = min(c, __ldg(f + u));
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) c = min(c, __shfl_xor_sync(kFull, c, k));
        const Key one = (Key)1 << sb;
        const Key tag = one + (one - 1 - (Key)m);  // the run plus one, then the slot
        const int none = 4 * (LW - tw0);  // tile bytes from here on
        const int q0 = pos0 - d + row.r;
        const int k0 = q0 >> 2;
        const int sh = 8 * (q0 & 3);
        if (4 * k0 - row.r >= 0 && 4 * (k0 + padded + 1) - row.r <= row.len) {
            walk<false, true, Key>(row, k0, sh, base, best, none, c - 4 * tw0, steps, tag, sb,
                                   lane);
        } else {
            walk<true, true, Key>(row, k0, sh, base, best, none, c - 4 * tw0, steps, tag, sb,
                                  lane);
        }
    }
    __syncthreads();
    Key* out = keys + (size_t)bs * LW + tw0;
    for (int w = threadIdx.x; w < nw; w += kThreads) atomicMax(out + w, best[w]);
}

// Pass 3, block (word block, b * S + s): the keys into run, dist and the XOR
// of word w under the distance that wins word w + 1 (0 where none does and
// at the window's last word).
template <class Key>
__global__ void __launch_bounds__(kThreads)
lr_tile_finish_kernel(const uint8_t* __restrict__ bufs, int buf_len,
                      const int* __restrict__ doms, int S, int M, int L, int LW, int sb,
                      const Key* __restrict__ keys, int* __restrict__ run_out,
                      int* __restrict__ dist_out, long long* __restrict__ xn_out) {
    const int bs = blockIdx.y;
    const int w = blockIdx.x * kThreads + threadIdx.x;
    if (w >= LW) return;
    const size_t o = (size_t)bs * LW + w;
    const Key mask = ((Key)1 << sb) - 1;
    const Key key = keys[o];
    const Key next = w + 1 < LW ? keys[o + 1] : 0;
    const int* drow = doms + (size_t)bs * M;
    uint32_t xn = 0;
    if (next) {
        const Row row = row_of(bufs, buf_len, bs / S);
        const int p = (bs % S) * L + 4 * w;
        xn = word_at(row, p) ^ word_at(row, p - __ldg(drow + (int)(mask - (next & mask))));
    }
    run_out[o] = key ? (int)(key >> sb) - 1 : -1;
    dist_out[o] = key ? __ldg(drow + (int)(mask - (key & mask))) : 0;
    xn_out[o] = (long long)xn;
}

template <class Key>
int launch_tiled(const uint8_t* bufs, int buf_len, const int* doms, int B, int S, int M, int L,
                 int LW, int tiles, int sb, int* first, Key* keys, int* run_out, int* dist_out,
                 long long* xn_out, cudaStream_t stream) {
    // The most slots a block that still leaves kMinBlocks blocks (those of
    // empty groups leave at once, so count the groups of M slots).
    int group = kMaxGroup;
    while (group > kWarps && (size_t)tiles * B * S * ((M + group - 1) / group) < kMinBlocks) {
        group /= 2;
    }
    const dim3 grid(tiles, (M + group - 1) / group, B * S);
    lr_tile_first_kernel<Key><<<grid, kThreads, 0, stream>>>(bufs, buf_len, doms, S, M, L, LW,
                                                              tiles, group, first, keys);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lr_tile_walk_kernel<Key><<<grid, kThreads, 0, stream>>>(bufs, buf_len, doms, S, M, L, LW,
                                                             tiles, group, sb, first, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lr_tile_finish_kernel<Key><<<dim3((LW + kThreads - 1) / kThreads, B * S), kThreads, 0,
                                 stream>>>(bufs, buf_len, doms, S, M, L, LW, sb, keys, run_out,
                                           dist_out, xn_out);
    return (int)cudaGetLastError();
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

// The tiled path: any window width and slot count.  `scratch` holds
// int32[B, S, M, tiles] of first mismatches (tiles = ceil(LW / kTile); the
// entries of dead slots and of tile 0 are never written or read), then, from
// the next 8-byte boundary, the winner keys [B, S, LW]: 32-bit where
// (4 LW + 1) << sb < 2^32 for sb the fewest bits that hold a slot index,
// else 64-bit with sb = 32.
extern "C" int lr_measure_tiled(const uint8_t* bufs, int buf_len, const int* doms, int B,
                                int S, int M, int L, int LW, int* scratch, int* run_out,
                                int* dist_out, long long* xn_out, cudaStream_t stream) {
    const int tiles = (LW + kTile - 1) / kTile;
    if (M < 1 || (M + kWarps - 1) / kWarps > 65535 || B * S > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    int sb = 1;
    while (sb < 31 && (1 << sb) < M) ++sb;
    const size_t nfirst = (size_t)B * S * M * tiles;
    void* keys = scratch + (nfirst + 1) / 2 * 2;
    if (((unsigned long long)(4 * LW + 1) << sb) < (1ull << 32)) {
        return launch_tiled<uint32_t>(bufs, buf_len, doms, B, S, M, L, LW, tiles, sb, scratch,
                                      static_cast<uint32_t*>(keys), run_out, dist_out, xn_out,
                                      stream);
    }
    return launch_tiled<unsigned long long>(bufs, buf_len, doms, B, S, M, L, LW, tiles, 32,
                                            scratch, static_cast<unsigned long long*>(keys),
                                            run_out, dist_out, xn_out, stream);
}
