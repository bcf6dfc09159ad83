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
// adds each in-range pixel with a shared-memory atomicAdd, then adds its
// non-zero bins into the image's histogram in device memory and writes its
// in-range count (hs_reduce.cuh, which also holds the reduce, spread over
// (bin range, image) blocks). At B = 24 the pass reads 302 MB of planes;
// 16-byte loads of the planes changed it by under 2% on the card and were
// not kept. Integer atomics only: the histogram is exact and the entropy
// reproducible run to run. Pixels with hue outside 0..179 (or saturation
// outside 0..255) land in no bin and are not counted in the total.
//
// Kernel 3 (facet_tpu/ops/pallas_entropy.py:hs_entropy_pallas) is the same
// computation with a fixed denominator: n_valid > 0 replaces the in-range
// count in the reduce. No new histogram kernel is needed.

#include <cuda_runtime.h>

#include "hs_reduce.cuh"

namespace {

constexpr int kHistThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kHistSmem = kBins * (int)sizeof(int);

// adds the pixel to the histogram when it is in range; returns 1 if it was
__device__ __forceinline__ int add_pixel(int* hist, int h, int s) {
  if ((unsigned)h < (unsigned)kHueBins && (unsigned)s < (unsigned)kSatBins) {
    atomicAdd(&hist[h * kSatBins + s], 1);
    return 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kHistThreads)
hs_hist_partial(const int* __restrict__ hue, const int* __restrict__ sat, HsWorkspace ws,
                long long n, int stride, long long n_eff) {
  extern __shared__ int4 smem4[];
  __shared__ int scratch[32];
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
  int count = 0;

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
    for (int u = 0; u < kUnroll; ++u) count += add_pixel(hist, hv[u], sv[u]);
  }
  for (; j < hi; j += step) {
    const long long p = j * stride;
    count += add_pixel(hist, __ldg(h_img + p), __ldg(s_img + p));
  }
  count = block_sum(count, scratch);   // its __syncthreads also fence the atomics
  hs_hist_add(smem4, ws, b, slice, slices, count);
}

unsigned long long g_smem_allowed = 0;   // devices where the opt-in is made

}  // namespace

// The workspace of a call, in int32: the (B, 46080) histograms first, then
// the reduce's shares and tickets and the blocks' counts (hs_reduce.cuh).
extern "C" int facet_hs_workspace(int batch, int slices, long long* ints) {
  *ints = hs_workspace_ints(batch, slices);
  return 0;
}

// hue, sat: (B, n) int32, contiguous. workspace: facet_hs_workspace's ints,
// 16-byte aligned. out: (B,) float32. n_valid: 0 normalizes by the in-range
// count, > 0 is a fixed denominator. Returns the cudaError_t of the launches.
extern "C" int facet_hs_entropy(const void* hue, const void* sat, void* workspace,
                                void* out, int batch, long long n, int stride, int slices,
                                long long n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem_once(hs_hist_partial, kHistSmem, g_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const HsWorkspace ws = hs_workspace(workspace, batch);
  const long long n_eff = (n + stride - 1) / stride;
  err = hs_workspace_clear(ws, batch, st);
  if (err != cudaSuccess) return (int)err;
  hs_hist_partial<<<dim3(slices, batch), kHistThreads, kHistSmem, st>>>(
      static_cast<const int*>(hue), static_cast<const int*>(sat), ws, n, stride, n_eff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_hs_entropy_reduce(ws, static_cast<float*>(out), batch, slices, n_valid,
                                       st);
}
