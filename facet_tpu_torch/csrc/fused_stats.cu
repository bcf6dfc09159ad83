// One pass over uint8 RGB: per image, the exact-cv2 gray 256-bin histogram,
// the exact-cv2 HSV saturation sum and the H-S joint entropy in bits.
//
// Replaces: facet_tpu/ops/pallas_fused_stats.py:fused_stats_pallas (kernel
// 4; the TPU kernel packs four uint8 pixels per int32 lane, pads to a
// 262,144-pixel block and builds both histograms as one-hot matmuls on the
// MXU).
//
// What bounds it on an H100: the bytes read, 3 B per pixel (4.7 MB per
// 1.5 MP image) against the 8 B per pixel of int32 hue and saturation
// planes that kernel 1 reads after rgb_to_hsv has written them; and the
// contention of shared-memory histogram atomics on smooth photos.
//
// Design: kernel 1's, with RGB as its input. Grid (slices, batch), 1024
// threads. Each block keeps the whole 46,080-bin H-S histogram (184,320 B)
// and a 256-bin gray histogram in dynamic shared memory, with cv2's two
// 256-entry reciprocal tables beside them (187,392 B of the 227 KB
// opt-in). It walks its slice of the interleaved pixels, computes per pixel
// the exact cv2 gray, S and H (the tables give round((255<<12)/v) and
// round((180<<12)/(6d)), so H and S equal ops/colorspace.py:rgb_to_hsv bit
// for bit), adds to both histograms with shared atomics and to a per-thread
// int64 saturation sum. It adds its H-S histogram into kernel 1's
// workspace and writes its in-range count there (hs_hist_add), and writes
// exact partials of the gray histogram (int32) and the saturation (int64).
// Then kernel 1's reduce (hs_reduce.cuh, spread over (bin range, image)
// blocks) reduces the entropy normalized by the in-range count, and a
// small kernel sums the gray partials and the saturation, and splits the
// saturation total into the (>> 12, & 4095) pair.
// No padding: the tail of the pixel stream is guarded by the pixel index.
// Integer atomics only, so every output is reproducible run to run.

#include <cuda_runtime.h>

#include "hs_reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kHsvShift = 12;
constexpr int kHalf = 1 << (kHsvShift - 1);
// shared memory: H-S histogram, gray histogram, the two reciprocal tables
constexpr int kSmemInts = kBins + 256 + 2 * 256;

struct Pixel {
  int gray, h, s;
};

// exact cv2 8-bit gray, S and H of one pixel (ops/colorspace.py)
__device__ __forceinline__ Pixel convert(int r, int g, int b,
                                         const int* sdiv, const int* hdiv) {
  Pixel p;
  p.gray = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15;
  const int v = max(max(r, g), b);
  const int diff = v - min(min(r, g), b);
  // sdiv[0] = hdiv[0] = 0: v == 0 gives S = 0 and diff == 0 gives H = 0
  p.s = (diff * sdiv[v] + kHalf) >> kHsvShift;
  const int h_num = v == r ? g - b : (v == g ? (b - r) + 2 * diff
                                             : (r - g) + 4 * diff);
  int h = (h_num * hdiv[diff] + kHalf) >> kHsvShift;   // arithmetic shift
  p.h = h < 0 ? h + 180 : h;
  return p;
}

// cv2's H lies in 0..179 and S in 0..255; the check only keeps a fault
// from writing past the H-S histogram (kernel 1 checks the same way)
__device__ __forceinline__ void add_pixel(int* hs, int* gh, long long& sat, int& count,
                                          const Pixel& p) {
  if ((unsigned)p.h < (unsigned)kHueBins && (unsigned)p.s < (unsigned)kSatBins) {
    atomicAdd(&hs[p.h * kSatBins + p.s], 1);
    ++count;
  }
  atomicAdd(&gh[p.gray], 1);
  sat += p.s;
}

__global__ void __launch_bounds__(kThreads)
fused_stats_partial(const unsigned char* __restrict__ rgb, HsWorkspace ws,
                    int* __restrict__ gray_partial, long long* __restrict__ sat_partial,
                    long long n) {
  extern __shared__ int4 smem4[];
  int* hs = reinterpret_cast<int*>(smem4);
  int* gh = hs + kBins;
  int* sdiv = gh + 256;
  int* hdiv = sdiv + 256;
  __shared__ long long scratch[32];
  __shared__ int scratch_count[32];
  const int slice = blockIdx.x;
  const int slices = gridDim.x;
  const int b = blockIdx.y;

  for (int i = threadIdx.x; i < (kBins + 256) / 4; i += blockDim.x) {
    smem4[i] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x < 256) {
    // cv2's tables with exact integer rounding: round(a / b) = (2a + b) / 2b
    const int i = threadIdx.x;
    sdiv[i] = i ? (2 * (255 << kHsvShift) + i) / (2 * i) : 0;
    hdiv[i] = i ? (2 * (180 << kHsvShift) + 6 * i) / (12 * i) : 0;
  }
  __syncthreads();

  const long long per = (n + slices - 1) / slices;
  const long long lo = (long long)slice * per;
  const long long hi = lo + per < n ? lo + per : n;
  const unsigned char* img = rgb + (long long)b * n * 3;
  const long long step = (long long)blockDim.x;
  long long sat = 0;
  int count = 0;

  long long j = lo + threadIdx.x;
  // main loop: kUnroll independent pixels in flight per thread
  for (; j + (kUnroll - 1) * step < hi; j += kUnroll * step) {
    int r[kUnroll], g[kUnroll], bl[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned char* px = img + (j + u * step) * 3;
      r[u] = __ldg(px);
      g[u] = __ldg(px + 1);
      bl[u] = __ldg(px + 2);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_pixel(hs, gh, sat, count, convert(r[u], g[u], bl[u], sdiv, hdiv));
    }
  }
  for (; j < hi; j += step) {
    const unsigned char* px = img + j * 3;
    add_pixel(hs, gh, sat, count,
              convert(__ldg(px), __ldg(px + 1), __ldg(px + 2), sdiv, hdiv));
  }
  sat = block_sum(sat, scratch);   // its __syncthreads also fences the atomics
  count = block_sum(count, scratch_count);

  hs_hist_add(smem4, ws, b, slice, slices, count);
  const long long part = (long long)b * slices + slice;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    gray_partial[part * 256 + i] = gh[i];
  }
  if (threadIdx.x == 0) sat_partial[part] = sat;
}

// One block of 256 threads per image: gray histogram and saturation totals.
__global__ void __launch_bounds__(256)
fused_stats_finish(const int* __restrict__ gray_partial,
                   const long long* __restrict__ sat_partial,
                   int* __restrict__ gray_hist, long long* __restrict__ sat_pair,
                   int slices) {
  const int b = blockIdx.x;
  const int* base = gray_partial + (long long)b * slices * 256;
  int count = 0;
  for (int s = 0; s < slices; ++s) count += base[s * 256 + threadIdx.x];
  gray_hist[b * 256 + threadIdx.x] = count;
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int s = 0; s < slices; ++s) total += sat_partial[(long long)b * slices + s];
    sat_pair[2 * b] = total >> 12;
    sat_pair[2 * b + 1] = total & 4095;
  }
}

unsigned long long g_smem_allowed = 0;   // devices where the opt-in is made

}  // namespace

// rgb: (B, n, 3) uint8, contiguous. Scratch: hs_workspace, kernel 1's
// workspace (facet_hs_workspace's int32s, 16-byte aligned), gray_partial
// (B, slices, 256) int32, sat_partial (B, slices) int64. Outputs: entropy
// (B,) float32, gray_hist (B, 256) int32, sat_pair (B, 2) int64. Returns
// the cudaError_t of the launches.
extern "C" int facet_fused_stats(const void* rgb, void* hs_workspace_base,
                                 void* gray_partial, void* sat_partial,
                                 void* entropy, void* gray_hist, void* sat_pair,
                                 int batch, long long n, int slices,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err = allow_smem_once(fused_stats_partial, smem, g_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const HsWorkspace ws = hs_workspace(hs_workspace_base, batch);
  err = hs_workspace_clear(ws, batch, st);
  if (err != cudaSuccess) return (int)err;
  fused_stats_partial<<<dim3(slices, batch), kThreads, smem, st>>>(
      static_cast<const unsigned char*>(rgb), ws, static_cast<int*>(gray_partial),
      static_cast<long long*>(sat_partial), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_hs_entropy_reduce(ws, static_cast<float*>(entropy), batch, slices, 0, st);
  if (err != cudaSuccess) return (int)err;
  fused_stats_finish<<<batch, 256, 0, st>>>(
      static_cast<const int*>(gray_partial),
      static_cast<const long long*>(sat_partial), static_cast<int*>(gray_hist),
      static_cast<long long*>(sat_pair), slices);
  return (int)cudaGetLastError();
}
