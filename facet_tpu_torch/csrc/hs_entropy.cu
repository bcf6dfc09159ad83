// H-S joint entropy: the 180x256 histogram of (hue, saturation) per image
// and its Shannon entropy in bits.
//
// Replaces: facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas_ilp (the TPU
// kernel builds the histogram as a one-hot matmul on the MXU, because the
// TPU has no fast scatter).
//
// What bounds it on an H100: the bytes read (two int32 planes, 8 B per
// pixel, so 12.6 MB per 1.5 MP image) and, on images whose hue/saturation
// is concentrated in few bins, contention on shared-memory atomics.
//
// Design: the whole 46,080-bin int32 histogram (184,320 B) lives in one
// block's dynamic shared memory. Grid (slices, batch): each block zeroes its
// histogram, walks its slice of the image's pixel stream (every stride-th
// pixel) with four independent coalesced loads in flight per thread and
// shared-memory atomicAdd, then writes its partial histogram to a
// (B, slices, 46080) scratch. A second kernel (hs_reduce.cuh) sums the
// partials of each image (exact integers), then reduces -sum p*log2(p) with
// p = count * (1 / denominator) in float32 per bin and a float64 sum.
// No global atomics: the histogram is exact and the entropy reproducible
// run to run. Pixels with hue outside 0..179 (or saturation outside
// 0..255) land in no bin and are not counted in the total.
//
// Kernel 3 (facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas) is the same
// computation with a fixed denominator: n_valid > 0 replaces the in-range
// count in the reduce. No new histogram kernel is needed.

#include <cuda_runtime.h>

#include "hs_reduce.cuh"

namespace {

constexpr int kHistThreads = 1024;
constexpr int kUnroll = 4;

__device__ __forceinline__ void add_pixel(int* hist, int h, int s) {
  if ((unsigned)h < (unsigned)kHueBins && (unsigned)s < (unsigned)kSatBins) {
    atomicAdd(&hist[h * kSatBins + s], 1);
  }
}

__global__ void __launch_bounds__(kHistThreads)
hs_hist_partial(const int* __restrict__ hue, const int* __restrict__ sat,
                int* __restrict__ partial, long long n, int stride,
                long long n_eff) {
  extern __shared__ int4 smem4[];
  int* hist = reinterpret_cast<int*>(smem4);
  const int slice = blockIdx.x;
  const int slices = gridDim.x;
  const int b = blockIdx.y;

  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) {
    smem4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const long long per = (n_eff + slices - 1) / slices;
  const long long lo = (long long)slice * per;
  const long long hi = lo + per < n_eff ? lo + per : n_eff;
  const int* h_img = hue + (long long)b * n;
  const int* s_img = sat + (long long)b * n;
  const long long step = (long long)blockDim.x;

  long long j = lo + threadIdx.x;
  // main loop: kUnroll independent pixel loads in flight per thread
  for (; j + (kUnroll - 1) * step < hi; j += kUnroll * step) {
    int hv[kUnroll], sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = (j + u * step) * stride;
      hv[u] = __ldg(h_img + p);
      sv[u] = __ldg(s_img + p);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_pixel(hist, hv[u], sv[u]);
  }
  for (; j < hi; j += step) {
    const long long p = j * stride;
    add_pixel(hist, __ldg(h_img + p), __ldg(s_img + p));
  }
  __syncthreads();

  int4* out = reinterpret_cast<int4*>(
      partial + ((long long)b * slices + slice) * kBins);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) out[i] = smem4[i];
}

}  // namespace

// hue, sat: (B, n) int32, contiguous. partial: (B, slices, 46080) int32
// scratch. out: (B,) float32. n_valid: 0 normalizes by the in-range count,
// > 0 is a fixed denominator. Returns the cudaError_t of the launches.
extern "C" int facet_hs_entropy(const void* hue, const void* sat,
                                void* partial, void* out, int batch,
                                long long n, int stride, int slices,
                                long long n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      hs_hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBins * (int)sizeof(int));
  if (err != cudaSuccess) return (int)err;
  const long long n_eff = (n + stride - 1) / stride;
  hs_hist_partial<<<dim3(slices, batch), kHistThreads,
                    kBins * sizeof(int), st>>>(
      static_cast<const int*>(hue), static_cast<const int*>(sat),
      static_cast<int*>(partial), n, stride, n_eff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hs_entropy_reduce<<<batch, kReduceThreads, 0, st>>>(
      static_cast<const int*>(partial), static_cast<float*>(out), slices,
      n_valid);
  return (int)cudaGetLastError();
}
