// package_merge: optimal length-limited Huffman code lengths by rank.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/pm_kernel.py::_pm_kernel
// (_pm_call, entry package_merge_rows_tpu).
// Plain twin: deflate_rs_tpu_torch/ops/pm_kernel.py::lengths_by_rank_plain.
//
// Bound on the card: neither bytes nor operations but latency.  A call moves
// about a megabyte and needs a few million integer operations, both under a
// microsecond; what takes time is the chain of max_len - 1 levels, each of
// which needs the level before it, and a launch lasts as long as its largest
// row.  So the design keeps a level short, and sizes every row by its live
// leaves m instead of the padded width A:
//
//   One block of 128 threads per row and one block barrier per level (a row
//   of at most 48 live leaves keeps only its first warp).  A level's list
//   holds the m live leaves and the packages of the level before, a package
//   being the sum of two neighbours clamped at BIG.  In the padded form of
//   the plain twin every other entry is a BIG leaf or a BIG package, sorts
//   behind all entries below BIG (leaves first), and pairs into BIG packages
//   again, so the padded list is fully described by this one and its counts.
//
//   A level merges two sorted lists, leaves and packages, ties leaf first.
//   The packages are not stored: each is formed from the previous level's
//   merged list where it is read (two loads and an add), which saves a pass
//   and a barrier per level.  Each thread owns c = ceil(2m / threads)
//   consecutive places of the merged list (made odd, so the threads' stores
//   spread over the banks): one binary search along its first place's
//   diagonal tells how many leaves come before it, then it merges c entries
//   serially and without branches, keeping their leaf flags as one bit word.
//   A distance or code-length row (m <= 30) has c <= 3 on one warp; a full
//   litlen row (m = 286) c = 5 on four.  Packages at BIG ride along at the
//   tail and are only counted (an atomic add, on adversarial inputs alone).
//
//   The backward pass is the serial chain n_sel -> take -> leaf_count over the
//   levels, run by the first warp: each step is a masked popcount per bit word
//   and a warp sum.  Places past the entries below BIG count BIG leaves first
//   (A - m of them), exactly as the padded list would.  Rank r's code length is
//   the number of levels whose leaf count exceeds r.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 29;
constexpr int kMaxLevels = 16;
constexpr int kMaxA = 512;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t low_mask(int k) {
    return k >= 32 ? ~0u : k <= 0 ? 0u : (1u << k) - 1u;
}

__global__ void __launch_bounds__(kThreads)
package_merge_kernel(const int* __restrict__ leaves, int A, int AP, int max_len,
                     int* __restrict__ out) {
    // leaves [AP], two merged lists [2 AP] each (a level reads the one and
    // writes the other), leaf bits [kMaxLevels][kThreads], then the small
    // per-level arrays.
    extern __shared__ int smem[];
    int* lv = smem;
    int* cur = lv + AP;
    int* other = cur + 2 * AP;
    uint16_t* bits = reinterpret_cast<uint16_t*>(other + 2 * AP);
    int* nbig = reinterpret_cast<int*>(bits + kMaxLevels * kThreads);  // BIG packages per level
    int* nlist = nbig + kMaxLevels;        // entries per level, BIG packages included
    int* leaf_count = nlist + kMaxLevels;
    int* live = leaf_count + kMaxLevels;   // [1]
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int row = blockIdx.x;

    if (t < kMaxLevels) nbig[t] = 0;
    if (t == 0) *live = 0;
    __syncthreads();
    {
        const int* src = leaves + (size_t)row * A;
        int cnt = 0;
        for (int i = t; i < A; i += kThreads) {
            const int v = src[i];
            lv[i] = v;
            cnt += v < kBig;
        }
        cnt = __reduce_add_sync(kFull, cnt);
        if (lane == 0 && cnt) atomicAdd(live, cnt);
    }
    __syncthreads();
    const int m = *live;
    // A row of at most 48 live leaves (every distance and code-length row)
    // goes on with its first warp alone: three places per thread at most.
    const int nt = 2 * m <= 96 ? 32 : kThreads;
    if (t >= nt) return;

    const int c = ((2 * m + nt - 1) / nt) | 1;  // a level holds at most 2m - 1 entries
    const int q0 = t * c;
    if (t == 0) nlist[0] = m;

    // Level 0 is the leaves alone.  A level's packages are the pairwise sums
    // of the level before, clamped at BIG, and are formed where they are read.
    const int* prev = lv;
    int n_prev = m;
    for (int lvl = 1; lvl < max_len; ++lvl) {
        const int np = n_prev >> 1;
        const int N = m + np;
        auto package = [&](int j) { return min(prev[2 * j] + prev[2 * j + 1], kBig); };
        // Leaves among the first q0 merged entries (merge-path search).
        int lo = max(0, q0 - np), hi = min(q0, m);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (lv[mid] <= package(q0 - mid - 1)) lo = mid + 1; else hi = mid;
        }
        int i = lo, j = q0 - lo;
        int a = i < m ? lv[i] : INT32_MAX;
        int b = j < np ? package(j) : INT32_MAX;
        uint32_t word = 0;
        int big = 0;
        const int q1 = min(q0 + c, N);
        for (int q = q0; q < q1; ++q) {
            const bool leaf = a <= b;  // leaf first on ties; live leaves are below BIG
            const int v = leaf ? a : b;
            cur[q] = v;
            word |= (uint32_t)leaf << (q - q0);
            big += v >= kBig;
            i += leaf;
            j += !leaf;
            // The next candidate of the side that moved, without a branch.
            const bool more = leaf ? i < m : j < np;
            const int* from = leaf ? lv : prev;
            const int at = leaf ? i : 2 * j;
            const int v0 = more ? from[at] : 0;
            const int v1 = more && !leaf ? from[at + 1] : 0;
            const int next = !more ? INT32_MAX : leaf ? v0 : min(v0 + v1, kBig);
            a = leaf ? next : a;
            b = leaf ? b : next;
        }
        bits[lvl * kThreads + t] = (uint16_t)word;
        if (big) atomicAdd(&nbig[lvl], big);  // only where sums reach the clamp
        if (t == 0) nlist[lvl] = N;
        __syncthreads();
        prev = cur;
        int* swap = cur;
        cur = other;
        other = swap;
        n_prev = N;
    }

    // Backward pass: leaves inside each level's selected prefix.
    if (t < 32) {
        int n_sel = max(2 * m - 2, 0);
        for (int lvl = max_len - 1; lvl >= 0; --lvl) {
            const int take = min(max(n_sel, 0), 2 * A);
            const int N = nlist[lvl] - nbig[lvl];  // real entries
            const int tr = min(take, N);
            int cnt = tr;
            if (lvl > 0) {
                cnt = 0;
                for (int k = lane; k < nt; k += 32)
                    cnt += __popc(bits[lvl * kThreads + k] & low_mask(tr - k * c));
                cnt = __reduce_add_sync(kFull, cnt);
            }
            cnt += min(max(take - N, 0), A - m);
            if (lane == 0) leaf_count[lvl] = cnt;
            n_sel = 2 * (take - cnt);
        }
    }
    __syncthreads();
    int* dst = out + (size_t)row * A;
    for (int r = t; r < A; r += nt) {
        int len = 0;
        for (int lvl = 0; lvl < max_len; ++lvl) len += r < leaf_count[lvl];
        dst[r] = len;
    }
}

}  // namespace

extern "C" int package_merge(const int* leaves, int R, int A, int max_len, int* out,
                             cudaStream_t stream) {
    if (R <= 0) return 0;
    if (A < 1 || A > kMaxA || max_len < 2 || max_len > kMaxLevels)
        return (int)cudaErrorInvalidValue;
    const int AP = (A + 31) / 32 * 32;
    const size_t shmem = (size_t)(5 * AP + 3 * kMaxLevels + 1) * sizeof(int) +
                         (size_t)kMaxLevels * kThreads * sizeof(uint16_t);
    package_merge_kernel<<<R, kThreads, shmem, stream>>>(leaves, A, AP, max_len, out);
    return (int)cudaGetLastError();
}
