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
// (B, slices, 46080) scratch. A second kernel sums the partials of each
// image (exact integers), then reduces -sum p*log2(p) with
// p = count * (1 / in-range total) in float32 per bin and a float64 sum.
// No global atomics: the histogram is exact and the entropy reproducible
// run to run. Pixels with hue outside 0..179 (or saturation outside
// 0..255) land in no bin and are not counted in the total.

#include <cuda_runtime.h>

namespace {

constexpr int kHueBins = 180;
constexpr int kSatBins = 256;
constexpr int kBins = kHueBins * kSatBins;          // 46080
constexpr int kHistThreads = 1024;
constexpr int kReduceThreads = 1024;
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

__global__ void __launch_bounds__(kReduceThreads)
hs_entropy_reduce(const int* __restrict__ partial, float* __restrict__ out,
                  int slices) {
  __shared__ long long scratch_i[32];
  __shared__ double scratch_d[32];
  const int b = blockIdx.x;
  const int* base = partial + (long long)b * slices * kBins;

  long long count = 0;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    for (int s = 0; s < slices; ++s) count += base[(long long)s * kBins + i];
  }
  const long long total = block_sum(count, scratch_i);

  const float inv = total > 0 ? 1.0f / (float)total : 0.0f;
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

// hue, sat: (B, n) int32, contiguous. partial: (B, slices, 46080) int32
// scratch. out: (B,) float32. Returns the cudaError_t of the launches.
extern "C" int facet_hs_entropy(const void* hue, const void* sat,
                                void* partial, void* out, int batch,
                                long long n, int stride, int slices,
                                void* stream) {
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
      static_cast<const int*>(partial), static_cast<float*>(out), slices);
  return (int)cudaGetLastError();
}
