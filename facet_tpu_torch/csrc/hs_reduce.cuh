// The H-S entropy's second half, shared by kernel 1 (hs_entropy.cu) and
// kernel 4 (fused_stats.cu): the 180x256 histogram of each image, summed
// from the histogram blocks' shared-memory histograms (exact integers), and
// -sum p*log2(p) over it with p = count * (1 / denominator) in float32 per
// bin and a float64 sum. The denominator is the in-range pixel count, or
// n_valid when it is given (> 0): the fixed denominator of
// facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas.
//
// Design, two steps spread over the card:
// - Each histogram block adds the non-zero bins of its shared histogram
//   into the image's (46080,) int32 histogram in device memory with
//   integer atomics (hs_hist_add), and writes the number of in-range pixels
//   it counted, so the denominator needs no sweep over the bins. Integer
//   sums do not depend on their order: the histogram is exact and the same
//   every run. At B = 24 this writes a few thousand bins a block into a
//   4.4 MB histogram that stays in L2, where per-block partial histograms
//   (11 an image) wrote 48.7 MB and the reduce read it back; on photos it
//   took 0.127 ms against 0.150, on hue and saturation drawn uniformly
//   (every bin filled, the most atomics) 0.184 against 0.151 (PERF.md).
// - The reduce runs a grid of (bin range, image) blocks, kRanges = 45
//   ranges of 1024 bins an image (1,080 blocks at B = 24): each block reads
//   its bins once, one 16-byte load per thread, and forms its share of
//   -sum p*log2 p in float64. The last block of an image to finish (an
//   atomic ticket) adds the image's shares in range order. Every float sum
//   is taken in a fixed order, so the entropy is bit-identical from run to
//   run; the ticket only decides which block adds them.
// hs_workspace_clear zeroes the histograms and the tickets before the
// histogram pass, in the same stream.
//
// Everything here has internal linkage (an unnamed namespace), so each .cu
// file that includes it gets its own copy and the shared library links.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHueBins = 180;
constexpr int kSatBins = 256;
constexpr int kBins = kHueBins * kSatBins;          // 46080
constexpr int kReduceThreads = 256;
constexpr int kRangeBins = 4 * kReduceThreads;      // 1024 bins a reduce block
constexpr int kRanges = kBins / kRangeBins;         // 45 an image
static_assert(kRanges * kRangeBins == kBins, "bin ranges must tile the histogram");

// One int32 workspace holds, in order: the histograms (B, kBins) int32;
// the shares (B, kRanges) float64; the tickets (B,) uint32; the histogram
// blocks' in-range counts (B, slices) int32. The first three are cleared
// before each call.
struct HsWorkspace {
  int* hist;
  double* shares;
  unsigned* tickets;
  int* counts;
};

__host__ __device__ inline long long hs_workspace_ints(int batch, int slices) {
  return (long long)batch * kBins + 2LL * batch * kRanges + batch +
         (long long)batch * slices;
}

__host__ __device__ inline HsWorkspace hs_workspace(void* base, int batch) {
  HsWorkspace ws;
  ws.hist = static_cast<int*>(base);
  ws.shares = reinterpret_cast<double*>(ws.hist + (long long)batch * kBins);
  ws.tickets = reinterpret_cast<unsigned*>(ws.shares + (long long)batch * kRanges);
  ws.counts = reinterpret_cast<int*>(ws.tickets + batch);
  return ws;
}

// Sum of v over the block; every thread gets the result. scratch holds one
// value per warp.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? scratch[threadIdx.x] : T(0);
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();
  return v;
}

// A histogram block's epilogue, by all its threads after a __syncthreads:
// the non-zero bins of its shared histogram `hist` (kBins int32) added to
// image b's histogram, and its in-range pixel count as count (b, slice).
__device__ void hs_hist_add(const int4* hist, const HsWorkspace& ws, int b, int slice,
                            int slices, int count) {
  int* out = ws.hist + (long long)b * kBins;
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) {
    const int4 v = hist[i];
    if (v.x) atomicAdd(out + 4 * i, v.x);
    if (v.y) atomicAdd(out + 4 * i + 1, v.y);
    if (v.z) atomicAdd(out + 4 * i + 2, v.z);
    if (v.w) atomicAdd(out + 4 * i + 3, v.w);
  }
  if (threadIdx.x == 0) ws.counts[(long long)b * slices + slice] = count;
}

// Grid (kRanges, B), kReduceThreads threads. out: (B,) float32.
__global__ void __launch_bounds__(kReduceThreads)
hs_entropy_reduce(HsWorkspace ws, float* __restrict__ out, int slices, long long n_valid) {
  __shared__ double scratch[32];
  __shared__ bool last;
  const int range = blockIdx.x;
  const int b = blockIdx.y;

  long long total = 0;     // the image's in-range count, in slice order
  for (int s = 0; s < slices; ++s) total += __ldg(ws.counts + (long long)b * slices + s);
  const long long denom = n_valid > 0 ? n_valid : total;
  const float inv = denom > 0 ? 1.0f / (float)denom : 0.0f;

  const int4 c = __ldg(reinterpret_cast<const int4*>(
      ws.hist + (long long)b * kBins + range * kRangeBins) + threadIdx.x);
  const int bins[4] = {c.x, c.y, c.z, c.w};
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bins[i] > 0) {
      const float p = (float)bins[i] * inv;
      acc += (double)(p * log2f(p));
    }
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    ws.shares[(long long)b * kRanges + range] = acc;
    __threadfence();                   // the share, before the ticket
    last = atomicAdd(ws.tickets + b, 1u) == kRanges - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile double* shares = ws.shares + (long long)b * kRanges;
    double sum = 0.0;
    for (int r = 0; r < kRanges; ++r) sum += shares[r];
    out[b] = total > 0 ? (float)(-sum) : 0.0f;
  }
}

// zero the histograms, shares and tickets (one memset: they are adjacent)
inline cudaError_t hs_workspace_clear(const HsWorkspace& ws, int batch, cudaStream_t st) {
  return cudaMemsetAsync(ws.hist, 0, reinterpret_cast<char*>(ws.tickets + batch) -
                                         reinterpret_cast<char*>(ws.hist), st);
}

inline cudaError_t launch_hs_entropy_reduce(const HsWorkspace& ws, float* out, int batch,
                                            int slices, long long n_valid,
                                            cudaStream_t stream) {
  hs_entropy_reduce<<<dim3(kRanges, batch), kReduceThreads, 0, stream>>>(ws, out, slices,
                                                                        n_valid);
  return cudaGetLastError();
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// process and device: `done` keeps one bit per device ordinal.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace
