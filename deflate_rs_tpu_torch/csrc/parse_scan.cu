// parse_scan: token-start mask of each chunk's parse.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/parse_scan.py::_kernel
// (_parse_scan_groups, entry parse_scan_batched).
// Plain twin: deflate_rs_tpu_torch/ops/parse_scan.py::parse_scan_plain.
//
// The parse is the orbit of position 0 under next[i] = i + steps[i], cut at
// n.  One block per chunk; the chunk is cut into segments of 64 positions,
// one thread each, so a segment's marks are one 64-bit word that only its
// thread writes.  The chunk width is any multiple of 16 (the JAX package's
// rule): a window whose width is no multiple of 64 ends in a partial segment
// of 16, 32 or 48 positions, which its thread loads, walks and stores as
// far as the window goes (the walks stop at the payload's end, which lies
// inside the window).  A chunk wider than 65,536 positions (1,024 segments,
// what a block's threads and shared memory hold) is parsed in windows of
// that width, one after the other in the same block: a window's true parse
// enters where the last token of the window before it lands, and that entry
// takes the place of "position 0" below.
//
// Bound on the card: bytes.  The function reads 4 B and writes 1 B per
// position (10.5 MB at 32 chunks of 64 KiB, about 3 us at 3.35 TB/s); the
// orbit itself is a serial chain of dependent loads, so the design's work is
// to keep that chain short:
//
//   load    16-byte loads of the int32 steps, held as uint16 in shared
//           memory with one pad word per segment, so that threads walking
//           their segments in step hit different banks.
//   phase 1 every thread parses its segment from the segment's first
//           position (the hypothesis): marks in a register, exit in shared
//           memory.
//   phase 2 speculation: every thread walks its segment again from the
//           previous segment's hypothesis exit until it lands on a
//           hypothesis mark (the two parses coincide from there on, next[]
//           being a function) or leaves the segment; that gives the
//           segment's exit under this entry.  Where the predecessor's exit
//           under its own assumed entry is the one assumed here, and so on
//           down to segment 0 (which enters at 0), the walk is the true one.
//   repair  one thread reads the "entry differs from the predecessor's exit"
//           flags (a ballot word per warp).  Up to the first flag every
//           segment is true; from there it follows the true parse position
//           by position, discarding the marks of the segments it passes,
//           until it lands on a hypothesis mark of a segment whose successor
//           assumed just that exit; then it skips to the next flag.
//           Hypotheses that never converge (runs of maximal matches) leave
//           this walk serial, one step per token, and right.
//   store   16 mask bytes per thread per turn, expanded from the bit words.
//
// A thread-block cluster sharing one chunk (2, 4 or 8 blocks, each holding
// a slice of the steps and handing the repair on through distributed shared
// memory) was built and timed: within 6 % of one block at 32 chunks, the
// cluster barriers costing about what the shorter phases save.  It was not
// kept.  Nor were
// further rounds of phase 2 (re-walking the segments whose predecessor's exit
// moved, up to four times, before the repair): equal on text, slower on
// operands that do not converge.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 64;         // positions per segment (one mark word)
constexpr int kSegWords = 33;    // 32 words of uint16 steps + 1 pad word
constexpr int kNone = 64;        // "no convergence inside the segment"
constexpr int kWindow = 65536;   // positions parsed in one pass of the block

struct Smem {
    unsigned long long* hyp;     // [S] hypothesis marks
    unsigned long long* fix;     // [S] fix-up marks
    uint32_t* st;                // [S * kSegWords] steps as uint16 pairs
    int* hexit;                  // [S] hypothesis exit (chunk position)
    int* exit;                   // [S] exit under the assumed entry
    int* entry;                  // [S] the assumed entry
    uint32_t* broken;            // [S / 32 rounded up] ballot words
    uint8_t* conv;               // [S] convergence offset, kNone if none
};

inline size_t smem_bytes(int S) {
    return (size_t)S * (8 + 8 + 4 * kSegWords + 4 + 4 + 4 + 1) + (S + 31) / 32 * 4 + 16;
}

__device__ inline Smem carve(unsigned char* base, int S) {
    Smem s;
    s.hyp = reinterpret_cast<unsigned long long*>(base);
    s.fix = s.hyp + S;
    s.st = reinterpret_cast<uint32_t*>(s.fix + S);
    s.hexit = reinterpret_cast<int*>(s.st + (size_t)S * kSegWords);
    s.exit = s.hexit + S;
    s.entry = s.exit + S;
    s.broken = reinterpret_cast<uint32_t*>(s.entry + S);
    s.conv = reinterpret_cast<uint8_t*>(s.broken + (S + 31) / 32);
    return s;
}

__device__ __forceinline__ int step_at(const uint32_t* st, int p) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(st);
    return h[(p >> 6) * (2 * kSegWords) + (p & 63)];
}

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
    // 4 bits -> 4 bytes of 0/1.
    return (nibble * 0x00204081u) & 0x01010101u;
}

// ceil(min(E, kWindow) / 64) threads, rounded up to whole warps; thread t
// holds segment t of the window in hand.  kWide: the chunk has more than one
// window; a chunk of one window compiles without the loop and the hand-over.
template <bool kWide>
__global__ void parse_scan_kernel(const int* __restrict__ steps, const int* __restrict__ ns,
                                  int E, bool* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int carry_out;    // the next window's entry, relative to its start
    const Smem s = carve(smem_raw, (min(E, kWindow) + kSeg - 1) / kSeg);
    const int t = threadIdx.x;
    const int b = blockIdx.x;
    int carry = 0;               // this window's entry (0 for the chunk's first)

  for (int base = 0; base < (kWide ? E : 1); base += kWindow) {
    const int EW = kWide ? min(kWindow, E - base) : E;   // positions of this window
    const int S = (EW + kSeg - 1) / kSeg;    // the last one partial where EW % 64 != 0
    const int n = ns[b] - base;              // payload left from the window's start
    const bool live = t < S;
    if (n <= 0) {
        // The payload ended before this window: no token starts here.
        int4* dst = reinterpret_cast<int4*>(out + (size_t)b * E + base);
        for (int i = t; i < EW / 16; i += blockDim.x) dst[i] = make_int4(0, 0, 0, 0);
        continue;
    }

    // ------------------------------------------------------------- load
    if (live) {
        const int4* src = reinterpret_cast<const int4*>(steps + (size_t)b * E + base);
        const int nv = EW / 4;                 // int4 of the window (EW % 16 == 0)
        int4 v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            // Past a partial segment's end: never read (walks stop at n <= EW).
            v[k] = t + k * S < nv ? src[t + k * S] : make_int4(1, 1, 1, 1);
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int i = t + k * S;       // 16 int4 per segment
            uint32_t* w = s.st + (i >> 4) * kSegWords + (i & 15) * 2;
            w[0] = (uint32_t)(v[k].x & 0xFFFF) | ((uint32_t)v[k].y << 16);
            w[1] = (uint32_t)(v[k].z & 0xFFFF) | ((uint32_t)v[k].w << 16);
        }
    }
    __syncthreads();

    // ---------------------------------------- phase 1: hypothesis parses
    // Walks run on offsets inside the segment: o in [0, lim).
    const int seg_start = t * kSeg;
    const uint16_t* seg = reinterpret_cast<const uint16_t*>(s.st + t * kSegWords);
    const int lim = min(kSeg, n - seg_start);
    unsigned long long hyp = 0;
    int hexit = seg_start;
    if (live) {
        int o = 0;
        while (o < lim) {
            hyp |= 1ull << o;
            o += seg[o];
        }
        hexit = seg_start + o;
        s.hyp[t] = hyp;
        s.hexit[t] = hexit;
        s.exit[t] = hexit;
    }
    __syncthreads();

    // ----------------------------- phase 2: speculative walk of each segment
    // The hypothesis is the walk from the segment's own start, which
    // converges with itself at offset 0; a segment whose predecessor's
    // hypothesis leaves exactly there keeps it.
    int entry = seg_start;
    unsigned long long fix = 0;
    int conv = 0;
    const int want = !live ? entry : t > 0 ? s.hexit[t - 1] : kWide ? carry : entry;
    if (want != entry) {
        entry = want;
        int o = max(entry - seg_start, 0);
        conv = kNone;
        while (o < lim) {
            if ((hyp >> o) & 1ull) {
                conv = o;
                break;
            }
            fix |= 1ull << o;
            o += seg[o];
        }
        s.exit[t] = conv == kNone ? seg_start + o : hexit;
    }
    __syncthreads();
    // The walk is the true one if the predecessor did leave where assumed.
    const bool stale = live && t > 0 && s.exit[t - 1] != entry;
    if (live) {
        s.fix[t] = fix;
        s.conv[t] = (uint8_t)conv;
        s.entry[t] = entry;
    }
    {
        const unsigned word = __ballot_sync(0xFFFFFFFFu, stale);
        if ((t & 31) == 0 && (t >> 5) < (S + 31) / 32) s.broken[t >> 5] = word;
    }
    __syncthreads();

    // ------------------------------------------------------------ repair
    const int nw = (S + 31) / 32;
    uint32_t flagged = 0;        // ballot words that hold a flag
    if (t < 32) flagged = __ballot_sync(0xFFFFFFFFu, t < nw && s.broken[t] != 0);
    if (t == 0) {
        // Segments at or after the payload's end hold no marks at all.
        const int last_marked = n > 0 ? min(S - 1, (n - 1) >> 6) : -1;
        int next = 1;            // first segment not yet known to be true
        while (true) {
            int j = S;
            uint32_t words = (next >> 5) < nw ? flagged & (~0u << (next >> 5)) : 0u;
            for (; words; words &= words - 1) {
                const int w = __ffs(words) - 1;
                uint32_t bits = s.broken[w];
                if (w == (next >> 5)) bits &= ~0u << (next & 31);
                if (bits) {
                    j = w * 32 + __ffs(bits) - 1;
                    break;
                }
            }
            if (j >= S) break;
            // Segments below j are true: follow the true parse from j's entry.
            int p = s.exit[j - 1];
            int cur = j - 1;     // last segment whose marks are final
            bool holds = false;
            while (p < n && p < EW) {
                const int g = p >> 6;
                for (int k = cur + 1; k <= g; ++k) {
                    s.fix[k] = 0;
                    s.conv[k] = kNone;
                }
                cur = g;
                const int o = p & 63;
                if ((s.hyp[g] >> o) & 1ull) {
                    // From here g follows its hypothesis and leaves at hexit.
                    s.conv[g] = (uint8_t)o;
                    p = s.hexit[g];
                    if (g + 1 >= S || s.entry[g + 1] == p) {
                        holds = true;
                        next = g + 2;
                        break;
                    }
                    continue;
                }
                s.fix[g] |= 1ull << o;
                p += step_at(s.st, p);
            }
            if (!holds) {        // the parse left the window or the payload
                for (int k = cur + 1; k <= last_marked; ++k) {
                    s.fix[k] = 0;
                    s.conv[k] = kNone;
                }
                break;
            }
        }
        // Where payload follows this window, its last token (inside the last
        // 258 positions) lands at the next window's entry.
        int c = 0;
        if (kWide && n > EW) {
            for (int g = S - 1; g >= 0; --g) {
                const int cv = s.conv[g];
                const unsigned long long m =
                    s.fix[g] | (s.hyp[g] & (cv >= kNone ? 0ull : ~0ull << cv));
                if (m) {
                    const int p = g * kSeg + 63 - __clzll((long long)m);
                    c = p + step_at(s.st, p) - EW;
                    break;
                }
            }
        }
        if (kWide) carry_out = c;
    }
    __syncthreads();
    if (kWide) carry = carry_out;

    // ------------------------------------------------------------ store
    // token = fix-up mark, or hypothesis mark at or after the convergence.
    int4* dst = reinterpret_cast<int4*>(out + (size_t)b * E + base);
    for (int i = t; i < EW / 16; i += blockDim.x) {
        const int g = i >> 2;
        const int c = s.conv[g];
        const unsigned long long keep = c >= kNone ? 0ull : ~0ull << c;
        const unsigned long long m = s.fix[g] | (s.hyp[g] & keep);
        const uint32_t bits = (uint32_t)(m >> ((i & 3) * 16)) & 0xFFFFu;
        int4 v;
        v.x = (int)spread4(bits & 15u);
        v.y = (int)spread4((bits >> 4) & 15u);
        v.z = (int)spread4((bits >> 8) & 15u);
        v.w = (int)spread4(bits >> 12);
        dst[i] = v;
    }
  }
}

}  // namespace

extern "C" int parse_scan(const int* steps, const int* ns, int B, int E, bool* out,
                          cudaStream_t stream) {
    if (B <= 0) return 0;
    if (E <= 0 || E % 16) return (int)cudaErrorInvalidValue;
    const int S = ((E < kWindow ? E : kWindow) + kSeg - 1) / kSeg;
    const size_t shmem = smem_bytes(S);
    auto kernel = E > kWindow ? parse_scan_kernel<true> : parse_scan_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, (S + 31) / 32 * 32, shmem, stream>>>(steps, ns, E, out);
    return (int)cudaGetLastError();
}
