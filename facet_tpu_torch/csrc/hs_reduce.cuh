// The H-S entropy's second half, shared by kernel 1 (hs_entropy.cu) and
// kernel 4 (fused_stats.cu): sum the per-block partial 180x256 histograms of
// one image (exact integers), then reduce -sum p*log2(p) with p = count *
// (1 / denominator) in float32 per bin and a float64 sum. The denominator is
// the in-range pixel count, or n_valid when it is given (> 0): the fixed
// denominator of facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas.
//
// One block per image; no global atomics, so the result is reproducible.
// Everything here has internal linkage (an unnamed namespace), so each .cu
// file that includes it gets its own copy and the shared library links.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kHueBins = 180;
constexpr int kSatBins = 256;
constexpr int kBins = kHueBins * kSatBins;          // 46080
constexpr int kReduceThreads = 1024;

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

// partial: (B, slices, kBins) int32; out: (B,) float32. Launch with
// kReduceThreads threads and one block per image.
__global__ void __launch_bounds__(kReduceThreads)
hs_entropy_reduce(const int* __restrict__ partial, float* __restrict__ out,
                  int slices, long long n_valid) {
  __shared__ long long scratch_i[32];
  __shared__ double scratch_d[32];
  const int b = blockIdx.x;
  const int* base = partial + (long long)b * slices * kBins;

  long long count = 0;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    for (int s = 0; s < slices; ++s) count += base[(long long)s * kBins + i];
  }
  const long long total = block_sum(count, scratch_i);
  const long long denom = n_valid > 0 ? n_valid : total;

  const float inv = denom > 0 ? 1.0f / (float)denom : 0.0f;
  double acc = 0.0;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    int c = 0;
    for (int s = 0; s < slices; ++s) c += base[(long long)s * kBins + i];
    if (c > 0) {
      const float p = (float)c * inv;
      acc += (double)(p * log2f(p));
    }
  }
  acc = block_sum(acc, scratch_d);
  if (threadIdx.x == 0) out[b] = total > 0 ? (float)(-acc) : 0.0f;
}

}  // namespace
