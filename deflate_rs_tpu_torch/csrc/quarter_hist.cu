// quarter_hist: per-quarter litlen and distance histograms of each chunk.
//
// Replaces the Pallas TPU kernel deflate_rs_tpu/ops/hist_kernel.py::_kernel
// (_hist_call, entry quarter_histograms_batched).
// Plain twin: deflate_rs_tpu_torch/ops/hist_kernel.py::quarter_histograms_plain.
//
// One block per (quarter, chunk), 256 threads.  Each warp owns a private
// copy of the 286 + 30 bins in shared memory, so the atomics of a text-heavy
// quarter (a few hot symbols) contend only inside one warp.  Threads stride
// over the quarter's positions with coalesced loads; a litlen symbol outside
// [0, 286) or a distance code outside [0, 30) counts nowhere (the encoder
// marks non-token positions 999 / 99).  The warp copies are then summed per
// bin and stored once.  Counts are integers, so any atomic order gives the
// same result.
//
// Bound on the card: device-memory reads, 8 bytes per position; the TPU
// kernel's 286-pass compare loop over the whole chunk is gone.  With nq = 1
// there is one block per chunk, so a batch of 32 chunks fills 32 of the
// card's SMs; splitting a quarter over several blocks is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNL = 286;
constexpr int kND = 30;
constexpr int kBins = kNL + kND;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
quarter_hist_kernel(const int* __restrict__ lsym, const int* __restrict__ dcode, int E,
                    int nq, int* __restrict__ lf, int* __restrict__ df) {
    __shared__ int bins[kWarps * kBins];
    const int q = blockIdx.x;
    const int b = blockIdx.y;
    for (int k = threadIdx.x; k < kWarps * kBins; k += kThreads) bins[k] = 0;
    __syncthreads();

    int* mine = bins + (threadIdx.x >> 5) * kBins;
    const int QL = E / nq;
    const size_t base = (size_t)b * E + (size_t)q * QL;
    for (int p = threadIdx.x; p < QL; p += kThreads) {
        const int ls = lsym[base + p];
        const int dc = dcode[base + p];
        if ((unsigned)ls < (unsigned)kNL) atomicAdd(&mine[ls], 1);
        if ((unsigned)dc < (unsigned)kND) atomicAdd(&mine[kNL + dc], 1);
    }
    __syncthreads();

    const size_t row = (size_t)b * nq + q;
    for (int k = threadIdx.x; k < kBins; k += kThreads) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += bins[w * kBins + k];
        if (k < kNL) {
            lf[row * kNL + k] = s;
        } else {
            df[row * kND + (k - kNL)] = s;
        }
    }
}

}  // namespace

extern "C" int quarter_hist(const int* lsym, const int* dcode, int B, int E, int nq, int* lf,
                            int* df, cudaStream_t stream) {
    dim3 grid(nq, B);
    quarter_hist_kernel<<<grid, kThreads, 0, stream>>>(lsym, dcode, E, nq, lf, df);
    return (int)cudaGetLastError();
}
