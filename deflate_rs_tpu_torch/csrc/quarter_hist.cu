// quarter_hist: per-quarter litlen and distance histograms of each chunk.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/hist_kernel.py::_kernel
// (_hist_call, entry quarter_histograms_batched).
// Plain twin: deflate_rs_tpu_torch/ops/hist_kernel.py::quarter_histograms_plain.
//
// Bound on the card: device-memory reads, 8 bytes per position.  To reach it
// the card needs a few blocks on every SM whatever nq is, so the grid is cut
// loose from nq: every quarter is split over k blocks, k chosen on the host
// so that nq * k * B is about three blocks per SM while a block keeps at
// least kMinSlice positions (one chunk alone, B = 1, still spreads over tens
// of SMs).  A block of 256 threads reads its slice of both operands with
// 16-byte loads (scalar loads where the shape does not allow them); each
// warp owns a private copy of the 286 + 30 bins in shared memory, so the
// atomics of a text-heavy slice (a few hot symbols) contend only inside one
// warp.  A litlen symbol outside [0, 286) or a distance code outside [0, 30),
// negatives included, counts nowhere (the encoder marks non-token positions
// 999 / 99).  The warp copies are summed per bin.  With k = 1 the sums are
// stored; with k > 1 the outputs are zeroed by a memset on the same stream
// just before the launch and every block adds its non-zero sums with
// atomicAdd.  Counts are integers, so any order gives the same result.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNL = 286;
constexpr int kND = 30;
constexpr int kBins = kNL + kND;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSlice = 1024;   // positions a block keeps at least
constexpr int kBlocksPerSM = 3;   // blocks aimed at per SM

__device__ __forceinline__ void count(int* mine, int ls, int dc) {
    if ((unsigned)ls < (unsigned)kNL) atomicAdd(&mine[ls], 1);
    if ((unsigned)dc < (unsigned)kND) atomicAdd(&mine[kNL + dc], 1);
}

// Block (q * k + j, b) counts positions [j * C, min((j + 1) * C, QL)) of
// quarter q of chunk b.  `vec`: the slice may be read as int4.
__global__ void __launch_bounds__(kThreads)
quarter_hist_kernel(const int* __restrict__ lsym, const int* __restrict__ dcode, int E,
                    int nq, int k, int C, int vec, int* __restrict__ lf,
                    int* __restrict__ df) {
    __shared__ int bins[kWarps * kBins];
    const int q = blockIdx.x / k;
    const int j = blockIdx.x - q * k;
    const int b = blockIdx.y;
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) bins[i] = 0;
    __syncthreads();

    int* mine = bins + (threadIdx.x >> 5) * kBins;
    const int QL = E / nq;
    const int lo = j * C;
    const int n = min(QL, lo + C) - lo;
    const size_t base = (size_t)b * E + (size_t)q * QL + lo;
    if (vec) {
        const int4* l4 = reinterpret_cast<const int4*>(lsym + base);
        const int4* d4 = reinterpret_cast<const int4*>(dcode + base);
        for (int p = threadIdx.x; p < (n >> 2); p += kThreads) {
            const int4 ls = __ldg(l4 + p);
            const int4 dc = __ldg(d4 + p);
            count(mine, ls.x, dc.x);
            count(mine, ls.y, dc.y);
            count(mine, ls.z, dc.z);
            count(mine, ls.w, dc.w);
        }
    } else {
        for (int p = threadIdx.x; p < n; p += kThreads) {
            count(mine, lsym[base + p], dcode[base + p]);
        }
    }
    __syncthreads();

    const size_t row = (size_t)b * nq + q;
    for (int i = threadIdx.x; i < kBins; i += kThreads) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += bins[w * kBins + i];
        int* out = i < kNL ? lf + row * kNL + i : df + row * kND + (i - kNL);
        if (k == 1) {
            *out = s;
        } else if (s != 0) {
            atomicAdd(out, s);
        }
    }
}

}  // namespace

extern "C" int quarter_hist(const int* lsym, const int* dcode, int B, int E, int nq, int* lf,
                            int* df, cudaStream_t stream) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        }
        if (err != cudaSuccess) return (int)err;
    }
    const int QL = E / nq;
    int k = (kBlocksPerSM * sms + nq * B - 1) / (nq * B);
    if (k > QL / kMinSlice) k = QL / kMinSlice;
    if (k < 1) k = 1;
    const int C = ((QL + k - 1) / k + 3) & ~3;  // a multiple of 4 keeps slices 16-byte aligned
    k = (QL + C - 1) / C;
    const int vec = E % 4 == 0 && QL % 4 == 0
                    && reinterpret_cast<uintptr_t>(lsym) % 16 == 0
                    && reinterpret_cast<uintptr_t>(dcode) % 16 == 0;
    if (k > 1) {
        const size_t rows = (size_t)B * nq;
        cudaError_t err;
        if (df == lf + rows * kNL) {  // one allocation: one memset
            err = cudaMemsetAsync(lf, 0, rows * kBins * sizeof(int), stream);
        } else {
            err = cudaMemsetAsync(lf, 0, rows * kNL * sizeof(int), stream);
            if (err == cudaSuccess) err = cudaMemsetAsync(df, 0, rows * kND * sizeof(int), stream);
        }
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(nq * k, B);
    quarter_hist_kernel<<<grid, kThreads, 0, stream>>>(lsym, dcode, E, nq, k, C, vec, lf, df);
    return (int)cudaGetLastError();
}
