// sa_scan: the suffix-order matcher's scan, from the sorted permutation to
// each position's packed best score, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this scan in XLA
// (deflate_rs_tpu/ops/matching.py::sa_scan_xla), as the plain twin runs it
// in elementwise passes, some thirty a depth.
// Plain twin: deflate_rs_tpu_torch/ops/matching.py::sa_scan_plain.
//
// Rows are the positions of a chunk in the sort's order (perm).  Row r's
// string is S(p) = (valid(p) ? buf[p : p + 4 NKEY] : 0xFF x 4 NKEY) ++
// buf[p + 4 NKEY : p + 4 PW] for p = perm[r], valid(p) = hstart <= p <=
// n_total - 3; al[r] is the byte LCP of rows r - 1 and r (al[0] = 0, and 0
// outside the rows).  The match length with the row d away is the running
// minimum of al over the rows between: every depth 1..K on both sides, then
// the tail's jumps of 2^j rows.  A candidate c scores (run << 16 |
// (WINDOW + 1 - dist)) where run >= 3, 1 <= dist = p - c <= WINDOW and c >=
// hstart; each valid row's best score is written at its position, 0 at the
// others'.  Every value is an integer and the scores are reduced with max, so
// the result is exact in any order of evaluation.
//
// Bound on the card: integer operations (a depth costs some ten; the bytes
// in are a few a row: perm, the rows' strings, and 4 out).  The design keeps
// the walk short and off device memory:
//
//   block   kRows sorted rows of one chunk, plus a halo of `deep` rows (K and
//           the tail's jumps) on each side.
//   al      the halo's LCPs, computed by the block from buf (two aligned
//           4-byte loads and a funnel shift a word, stopping at the first
//           differing word), one byte a row in shared memory, with the dense
//           scan's positions as int32.
//   tables  where the tail jumps 2^4 rows or more, the minimum over the 16
//           and the 256 rows ending at each row, built by doubling with
//           4-byte __vminu4 steps; a jump of 2^j reads at most 8 entries of
//           one table (2^(j-8) above j = 11).
//   walk    a thread walks each of its rows' two sides and stops a side where
//           the running minimum falls below 3, or where no deeper candidate
//           can beat the best score found ((run << 16) + WINDOW <= best).  So
//           runs of one byte (distance 1 at the first depth) end at once;
//           text walks until its LCPs fall under the best's.
//   groups  rows that share a sort key (al >= 4 NKEY) lie in position order,
//           since perm is the stable sort: before row i their distances grow
//           with depth, so the nearest outscores them, and after it none can
//           score.  A side that is still live past its first depth skips its
//           key group with probes of 256, 16 and 1 rows, and resumes past it
//           from the cap (the group's edge holds the lower al), so periods
//           and repeated records cost tens of probes a row, not 2 K + tail.
//   out     a row's score is written at its position: the scatter that
//           restores position order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8192;  // sorted rows a block scores
constexpr int kWindow = 32768;
constexpr int kMaxTail = 16;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper, opted in

struct Params {
    const uint8_t* buf;
    long long W;  // bytes of a chunk's row in buf
    const long long* perm;
    const long long* hstart;
    const long long* n_total;
    int* out;
    int N, K, PW, NKEY;
    int deep;   // K plus the tail's jumps
    int span;   // rows of al a block holds: kRows + 2 * deep, rounded up to 16
    int levels; // 0, 4 or 8: the min-tables built
    int ntail;
    int jumps[kMaxTail];
};

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// The four bytes of a row at `pos`, in memory order (byte pos in the low bits).
__device__ __forceinline__ uint32_t word_at(const uint32_t* w32, int pos) {
    const int a = pos >> 2;
    const int s = pos & 3;
    const uint32_t lo = __ldg(w32 + a);
    const uint32_t hi = __ldg(w32 + a + (s != 0));
    return __funnelshift_r(lo, hi, 8 * s);
}

__device__ __forceinline__ int lcp(const uint32_t* w32, int p, int q, bool vp, bool vq, int PW,
                                   int NKEY) {
    for (int w = 0; w < PW; ++w) {
        const uint32_t x = (w < NKEY && !vp) ? 0xFFFFFFFFu : word_at(w32, p + 4 * w);
        const uint32_t y = (w < NKEY && !vq) ? 0xFFFFFFFFu : word_at(w32, q + 4 * w);
        const uint32_t d = x ^ y;
        if (d) return 4 * w + ((__ffs(d) - 1) >> 3);
    }
    return 4 * PW;
}

// min over the 2^j rows from local row lo: level 8 / 4 entries end a window
// of 256 / 16 rows.
__device__ __forceinline__ int window_min(const uint8_t* a0, const uint8_t* a4,
                                          const uint8_t* a8, int lo, int j) {
    int m = 255;
    if (j >= 8) {
        for (int q = 0; q < (1 << (j - 8)); ++q) m = min(m, (int)a8[lo + 255 + (q << 8)]);
    } else if (j >= 4) {
        for (int q = 0; q < (1 << (j - 4)); ++q) m = min(m, (int)a4[lo + 15 + (q << 4)]);
    } else {
        for (int q = 0; q < (1 << j); ++q) m = min(m, (int)a0[lo + q]);
    }
    return m;
}

// The score of candidate c at match length run for the row at pos.
__device__ __forceinline__ int score(int run, int pos, int c, int hst) {
    const int dist = pos - c;
    return (dist >= 1 && dist <= kWindow && c >= hst) ? (run << 16) | (kWindow + 1 - dist) : 0;
}

__device__ __forceinline__ bool spent(int run, int best) {
    return run < 3 || (run << 16) + kWindow <= best;
}

// The depths 1..t (at most `limit`) whose rows share row i's sort key on one
// side: al >= kk all the way, taken 256 and 16 rows at a time through the
// min-tables where they exist, then row by row.  Local row u is the first
// probed row's in a0; dir -1 walks the rows before it (depth d reads al of
// row i - d + 1), +1 those after (i + d).
__device__ __forceinline__ int same_key(const uint8_t* a0, const uint8_t* a4,
                                        const uint8_t* a8, int u, int dir, int kk, int limit,
                                        int levels) {
    int t = 0;
    while (t < limit) {
        if (levels >= 8 && t + 256 <= limit && a8[dir < 0 ? u - t : u + t + 255] >= kk) {
            t += 256;
        } else if (levels >= 4 && t + 16 <= limit && a4[dir < 0 ? u - t : u + t + 15] >= kk) {
            t += 16;
        } else if (a0[dir < 0 ? u - t : u + t] >= kk) {
            t += 1;
        } else {
            break;
        }
    }
    return t;
}

// Block (x, b): sorted rows [x * kRows, (x + 1) * kRows) of chunk b.
__global__ void __launch_bounds__(kThreads, 2) sa_scan_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * kRows;
    const int N = p.N, K = p.K, deep = p.deep, span = p.span;
    const int spn = round16(kRows + 2 * K);
    int* sp = reinterpret_cast<int*>(smem);  // perm of rows r0 - K ..
    uint8_t* a0 = smem + 4 * spn;            // al of rows r0 - deep ..
    uint8_t* a4 = a0 + span;
    uint8_t* a8 = a4 + span;
    uint8_t* tmp = a8 + span;

    const long long* perm = p.perm + (size_t)b * N;
    const int hst = (int)p.hstart[b];
    const int last = (int)(p.n_total[b] - 3);  // the last valid start
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(p.buf + (size_t)b * p.W);

    for (int u = threadIdx.x; u < kRows + 2 * K; u += kThreads) {
        const int r = r0 - K + u;
        sp[u] = (r >= 0 && r < N) ? (int)__ldg(perm + r) : 0;
    }
    const int base = r0 - deep;
    for (int u = threadIdx.x; u < span; u += kThreads) {
        const int r = base + u;
        int l = 0;
        if (r >= 1 && r < N) {
            const int pp = (int)__ldg(perm + r);
            const int qq = (int)__ldg(perm + r - 1);
            l = lcp(w32, pp, qq, pp >= hst && pp <= last, qq >= hst && qq <= last, p.PW,
                    p.NKEY);
        }
        a0[u] = (uint8_t)l;
    }
    __syncthreads();

    // Level l at local row u: min(a0[u - 2^l + 1 .. u]) (fewer rows below
    // u = 2^l - 1, which no window reads).  Levels 1..4 end in a4, 5..8 in a8.
    for (int l = 1; l <= p.levels; ++l) {
        const uint8_t* src = (l & 1) ? (l == 1 ? a0 : l <= 5 ? a4 : a8) : tmp;
        uint8_t* dst = (l & 1) ? tmp : (l <= 4 ? a4 : a8);
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
        uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
        const int s = 1 << (l - 1);
        for (int v = threadIdx.x; v < (span >> 2); v += kThreads) {
            const uint32_t cur = s32[v];
            uint32_t shifted;
            if (s < 4) {
                const uint32_t prev = v >= 1 ? s32[v - 1] : 0xFFFFFFFFu;
                shifted = __funnelshift_r(prev, cur, 32 - 8 * s);
            } else {
                shifted = v >= (s >> 2) ? s32[v - (s >> 2)] : 0xFFFFFFFFu;
            }
            d32[v] = __vminu4(cur, shifted);
        }
        __syncthreads();
    }

    const int cap = 4 * p.PW;
    const int kk = 4 * p.NKEY;  // al >= kk: the two rows share a sort key
    for (int m = 0; m < kRows / kThreads; ++m) {
        const int i = r0 + m * kThreads + threadIdx.x;
        if (i >= N) break;
        const int pos = sp[i - r0 + K];
        int best = 0;
        if (pos >= hst && pos <= last) {
            const int u = i - base;      // row i in a0
            const int v = i - r0 + K;    // row i in sp
            // Rows before i: depth d reads al of rows i - d + 1 .. i.  Where
            // row i - 1 shares i's sort key, so do the next g - 1 rows: their
            // positions fall with depth (the sort is stable), so the nearest
            // outscores them.  Past them the running minimum is al of the
            // group's first row, below every al inside it: the walk resumes
            // from cap.
            int run = min(cap, (int)a0[u]);
            int g = 1;
            bool live = run >= 3;
            if (live) {
                best = score(run, pos, sp[v - 1], hst);
                if (run >= kk) {
                    live = !spent(run, best);
                    if (live) {
                        g = 1 + same_key(a0, a4, a8, u - 1, -1, kk, deep - 1, p.levels);
                        run = cap;
                    }
                }
            }
            live = live && g < deep;
            for (int d = g + 1; live && d <= K; ++d) {
                run = min(run, (int)a0[u - d + 1]);
                if (spent(run, best)) { live = false; break; }
                best = max(best, score(run, pos, sp[v - d], hst));
            }
            for (int t = 0, k = K; live && t < p.ntail; ++t) {
                const int k2 = k + (1 << p.jumps[t]);
                if (k2 > g) {
                    run = min(run, window_min(a0, a4, a8, u - k2 + 1, p.jumps[t]));
                    if (spent(run, best)) break;
                    best = max(best, score(run, pos, (int)__ldg(perm + i - k2), hst));
                }
                k = k2;
            }
            // Rows after i: depth d reads al of rows i + 1 .. i + d.  Where
            // row i + 1 shares i's key, so do the next f - 1 rows, and all lie
            // after i: none scores.
            run = min(cap, (int)a0[u + 1]);
            int f = 0;
            live = !spent(run, best);
            if (live && run >= kk) {
                f = 1 + same_key(a0, a4, a8, u + 2, 1, kk, deep - 1, p.levels);
            }
            run = cap;
            live = live && f < deep;
            for (int d = f + 1; live && d <= K; ++d) {
                run = min(run, (int)a0[u + d]);
                if (spent(run, best)) { live = false; break; }
                best = max(best, score(run, pos, sp[v + d], hst));
            }
            for (int t = 0, k = K; live && t < p.ntail; ++t) {
                const int k2 = k + (1 << p.jumps[t]);
                if (k2 > f) {
                    run = min(run, window_min(a0, a4, a8, u + k + 1, p.jumps[t]));
                    if (spent(run, best)) break;
                    best = max(best, score(run, pos, (int)__ldg(perm + i + k2), hst));
                }
                k = k2;
            }
        }
        p.out[(size_t)b * N + pos] = best;
    }
}

// Shared memory of one block, or -1 where the arguments are out of range.
long long smem_bytes(int K, int PW, int NKEY, const int* jumps, int ntail) {
    if (K < 1 || PW < 1 || PW > 18 || NKEY < 1 || NKEY > 4 || NKEY > PW || ntail < 0
        || ntail > kMaxTail) {
        return -1;
    }
    long long deep = K;
    int maxj = -1;
    for (int t = 0; t < ntail; ++t) {
        if (jumps[t] < 0 || jumps[t] > 14) return -1;
        deep += 1LL << jumps[t];
        maxj = jumps[t] > maxj ? jumps[t] : maxj;
    }
    const long long span = (kRows + 2 * deep + 15) & ~15LL;
    const int levels = maxj >= 8 ? 8 : maxj >= 4 ? 4 : 0;
    const long long spn = (kRows + 2LL * K + 15) & ~15LL;
    return 4 * spn + span * (levels ? 4 : 1);
}

}  // namespace

extern "C" int sa_scan(const uint8_t* buf, long long W, const long long* perm,
                       const long long* hstart, const long long* n_total, int B, int N, int K,
                       int PW, int NKEY, const int* jumps, int ntail, int* out,
                       cudaStream_t stream) {
    const long long smem = smem_bytes(K, PW, NKEY, jumps, ntail);
    if (smem < 0 || smem > kMaxSmem || B < 1 || B > 65535 || N < 1) {
        return (int)cudaErrorInvalidValue;
    }
    Params p;
    p.buf = buf;
    p.W = W;
    p.perm = perm;
    p.hstart = hstart;
    p.n_total = n_total;
    p.out = out;
    p.N = N;
    p.K = K;
    p.PW = PW;
    p.NKEY = NKEY;
    p.ntail = ntail;
    int deep = K, maxj = -1;
    for (int t = 0; t < ntail; ++t) {
        p.jumps[t] = jumps[t];
        deep += 1 << jumps[t];
        maxj = jumps[t] > maxj ? jumps[t] : maxj;
    }
    p.deep = deep;
    p.span = (kRows + 2 * deep + 15) & ~15;
    p.levels = maxj >= 8 ? 8 : maxj >= 4 ? 4 : 0;

    // Opt in to more than 48 KiB of shared memory, once a card.
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(sa_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = true;
    }
    dim3 grid((N + kRows - 1) / kRows, B);
    sa_scan_kernel<<<grid, kThreads, (size_t)smem, stream>>>(p);
    return (int)cudaGetLastError();
}
