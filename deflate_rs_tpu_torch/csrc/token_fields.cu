// token_fields: per-position token bit fields of each chunk.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/field_kernel.py::_kernel
// (_field_call, entry token_fields_batched).
// Plain twin: deflate_rs_tpu_torch/ops/field_kernel.py::token_fields_plain.
//
// Each position's litlen symbol and distance code are looked up in its
// quarter's packed code | len << 16 tables (288 litlen + 30 distance
// entries) and written as t1v/t1b (litlen code with the length extra bits
// above it, width) and t2v/t2b (distance code with its extra bits, width).
// The rules are the Pallas kernel's: a position is a token where its symbol
// is below 288 (below 30 for a distance) in a chunk with huff set, negative
// symbols included; a symbol outside the table looks up 0; an entry's width
// is its high half shifted arithmetically, and a shift by a width outside
// [0, 32) gives 0 (uint32 semantics).  Widths are summed as int32 and wrap.
//
// Bound on the card: device-memory bandwidth -- 7 int32 reads and 4 int32
// writes per position; the table lookups hit shared memory.  To reach it at
// every batch the grid is cut from the positions, not the quarters: a block
// of kThreads threads takes a tile of kTile positions, so one 64 KiB chunk
// already makes 128 blocks and a batch of 64 makes 8,192 (the grid of one
// block per (quarter, chunk) made 8 blocks at B = 1).  A tile may straddle
// quarters (the 4 KiB tier at nq = 8 has quarters of 512 positions): the
// block copies the tables of every quarter it touches, which lie side by
// side in l_pack_q / d_pack_q, into shared memory and finds each position's
// quarter as p / QL.  A thread takes 4 neighbouring positions with 16-byte
// loads and stores where the operands allow it (E % 4 == 0 and every pointer
// 16-byte aligned, checked by the entry point), else with scalar loads of 4
// positions kThreads apart.  The operand loads are issued before the table
// copy and the barrier, so their latency overlaps it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNL = 288;
constexpr int kND = 30;
constexpr int kThreads = 128;
constexpr int kTile = 4 * kThreads;  // positions of a block
constexpr int kMaxSmem = 48 * 1024;  // a block's shared memory without opting in

__device__ __forceinline__ uint32_t shl32(uint32_t v, uint32_t s) {
    return s < 32 ? (v << s) : 0u;
}

// The fields of one position: ls / dc its symbols, len_en .. dist_ev its
// extra bits, ltbl / dtbl its quarter's tables in shared memory.
struct Fields {
    int t1v, t1b, t2v, t2b;
};

__device__ __forceinline__ Fields fields_of(bool on, int ls, int len_en, int len_ev, int dc,
                                            int dist_en, int dist_ev, const int* ltbl,
                                            const int* dtbl) {
    const int lp = (ls >= 0 && ls < kNL) ? ltbl[ls] : 0;
    const int dp = (dc >= 0 && dc < kND) ? dtbl[dc] : 0;
    const int ll = lp >> 16;  // arithmetic, as the Pallas kernel's int32 shift
    const int dl = dp >> 16;
    Fields f;
    f.t1v = (int)(((uint32_t)lp & 0xFFFFu) | shl32((uint32_t)len_ev, (uint32_t)ll));
    f.t1b = (on && ls < kNL) ? (int)((uint32_t)ll + (uint32_t)len_en) : 0;
    f.t2v = (int)(((uint32_t)dp & 0xFFFFu) | shl32((uint32_t)dist_ev, (uint32_t)dl));
    f.t2b = (on && dc < kND) ? (int)((uint32_t)dl + (uint32_t)dist_en) : 0;
    return f;
}

// Block (tile, chunk).  kVec: 16-byte loads and stores, a thread on the 4
// positions from 4 * threadIdx.x; else scalar ones, a thread on the
// positions threadIdx.x + k * kThreads.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
token_fields_kernel(const int* __restrict__ huff, const int* __restrict__ lsym,
                    const int* __restrict__ len_en, const int* __restrict__ len_ev,
                    const int* __restrict__ dcode, const int* __restrict__ dist_en,
                    const int* __restrict__ dist_ev, const int* __restrict__ l_pack_q,
                    const int* __restrict__ d_pack_q, int E, int nq,
                    int* __restrict__ t1v, int* __restrict__ t1b, int* __restrict__ t2v,
                    int* __restrict__ t2b) {
    extern __shared__ int tbl[];  // [nqt][288] litlen tables, then [nqt][30] distance
    const int b = blockIdx.y;
    const int p0 = blockIdx.x * kTile;
    const int QL = E / nq;
    const int q_lo = p0 / QL;
    const int nqt = (min(p0 + kTile, E) - 1) / QL - q_lo + 1;
    const size_t row = (size_t)b * E;

    // This thread's positions: operands first, so the loads overlap the copy.
    int ls[4], le[4], lv[4], dc[4], de[4], dv[4];
    int pos[4];
    if constexpr (kVec) {
        const int p = p0 + 4 * threadIdx.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) pos[i] = p + i;
        if (p < E) {
            auto ld = [&](const int* a, int* v) {
                const int4 x = __ldg(reinterpret_cast<const int4*>(a + row + p));
                v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
            };
            ld(lsym, ls); ld(len_en, le); ld(len_ev, lv);
            ld(dcode, dc); ld(dist_en, de); ld(dist_ev, dv);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            pos[i] = p0 + threadIdx.x + i * kThreads;
            if (pos[i] < E) {
                const size_t o = row + pos[i];
                ls[i] = __ldg(lsym + o); le[i] = __ldg(len_en + o); lv[i] = __ldg(len_ev + o);
                dc[i] = __ldg(dcode + o); de[i] = __ldg(dist_en + o); dv[i] = __ldg(dist_ev + o);
            }
        }
    }
    const bool on = __ldg(huff + b) != 0;

    // The tables: nl litlen entries, then nd distance ones, four loads a
    // thread in flight before their stores (one round trip for nqt <= 1).
    const int nl = nqt * kNL;
    const int nd = nqt * kND;
    const int* lsrc = l_pack_q + ((size_t)b * nq + q_lo) * kNL;
    const int* dsrc = d_pack_q + ((size_t)b * nq + q_lo) * kND - nl;
    for (int k0 = threadIdx.x; k0 < nl + nd; k0 += 4 * kThreads) {
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + j * kThreads;
            v[j] = k < nl ? __ldg(lsrc + k) : k < nl + nd ? __ldg(dsrc + k) : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (k0 + j * kThreads < nl + nd) tbl[k0 + j * kThreads] = v[j];
        }
    }
    const int* ltbl = tbl;
    const int* dtbl = tbl + nl;
    __syncthreads();

    Fields f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = pos[i] / QL - q_lo;
        if (pos[i] < E) {
            f[i] = fields_of(on, ls[i], le[i], lv[i], dc[i], de[i], dv[i], ltbl + q * kNL,
                             dtbl + q * kND);
        }
    }
    if constexpr (kVec) {
        const int p = pos[0];
        if (p < E) {
            const size_t o = row + p;
            *reinterpret_cast<int4*>(t1v + o) = make_int4(f[0].t1v, f[1].t1v, f[2].t1v, f[3].t1v);
            *reinterpret_cast<int4*>(t1b + o) = make_int4(f[0].t1b, f[1].t1b, f[2].t1b, f[3].t1b);
            *reinterpret_cast<int4*>(t2v + o) = make_int4(f[0].t2v, f[1].t2v, f[2].t2v, f[3].t2v);
            *reinterpret_cast<int4*>(t2b + o) = make_int4(f[0].t2b, f[1].t2b, f[2].t2b, f[3].t2b);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (pos[i] < E) {
                const size_t o = row + pos[i];
                t1v[o] = f[i].t1v; t1b[o] = f[i].t1b; t2v[o] = f[i].t2v; t2b[o] = f[i].t2b;
            }
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int token_fields(const int* huff, const int* lsym, const int* len_en,
                            const int* len_ev, const int* dcode, const int* dist_en,
                            const int* dist_ev, const int* l_pack_q, const int* d_pack_q,
                            int B, int E, int nq, int* t1v, int* t1b, int* t2v, int* t2b,
                            cudaStream_t stream) {
    if (B == 0 || E == 0) return (int)cudaSuccess;
    if (nq < 1 || E % nq) return (int)cudaErrorInvalidValue;
    const int touched = (kTile - 1) / (E / nq) + 2;  // quarters a tile touches at most
    const int quarters = touched < nq ? touched : nq;
    const size_t smem = (size_t)quarters * (kNL + kND) * sizeof(int);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    const dim3 grid((E + kTile - 1) / kTile, B);
    const void* ptrs[] = {lsym, len_en, len_ev, dcode, dist_en, dist_ev, t1v, t1b, t2v, t2b};
    bool vec = E % 4 == 0;
    for (const void* p : ptrs) vec = vec && aligned16(p);
    if (vec) {
        token_fields_kernel<true><<<grid, kThreads, smem, stream>>>(
            huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev, l_pack_q, d_pack_q, E, nq,
            t1v, t1b, t2v, t2b);
    } else {
        token_fields_kernel<false><<<grid, kThreads, smem, stream>>>(
            huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev, l_pack_q, d_pack_q, E, nq,
            t1v, t1b, t2v, t2b);
    }
    return (int)cudaGetLastError();
}
