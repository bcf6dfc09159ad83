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
// planes that kernel 1 reads after rgb_to_hsv has written them. Measured
// (PERF.md), the pass takes about three times that bound, held by
// its four shared-memory accesses a pixel: two table reads and two
// histogram adds. Without the adds it took 0.074 ms at B = 24, without the
// table reads 0.0705, against 0.106 with both; exact reciprocals computed
// in registers instead of read (a float estimate and an integer
// correction) took 0.157.
//
// Design: one block of 1024 threads per SM (a persistent grid), each with
// the whole 46,080-bin H-S histogram (184,320 B), one 256-bin gray
// histogram per warp (32,768 B, so the gray adds of different warps never
// meet) and cv2's two 256-entry reciprocal tables in dynamic shared memory
// (219,136 B of the 227 KB opt-in). The blocks split the batch's pixels,
// flattened image after image, into equal ranges of whole 16-pixel
// groups: one wave, one zeroing of the histograms per block. A thread
// reads a group as three 16-byte loads (48 B) and
// computes per pixel the exact cv2 gray, S and H (the tables give
// round((255<<12)/v) and round((180<<12)/(6d)), so H and S equal
// ops/colorspace.py:rgb_to_hsv bit for bit), adds to both histograms with
// shared atomics and sums the saturation. Pixels before the first or after
// the last whole group of an image's part (image boundaries not on a group,
// a base not 16-byte aligned) go one by one. Where a block's range leaves
// an image, it flushes that image's part: the non-zero H-S bins are added
// into kernel 1's workspace histogram with integer atomics and cleared, and
// so are the gray bins (all warps' copies summed) into the image's gray
// histogram, the in-range count into the image's count (slices = 1) and the
// saturation into its int64 total. Kernel 1's reduce (hs_reduce.cuh) then
// forms the entropy normalized by the in-range count, and a small kernel
// copies the gray histograms out and splits the saturation total into the
// (>> 12, & 4095) pair. One memset clears the whole scratch first. Integer
// atomics only, so every output is exact and the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hs_reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                  // pixels a thread loads at once (48 B)
constexpr int kHsvShift = 12;
constexpr int kHalf = 1 << (kHsvShift - 1);
// shared memory: H-S histogram, the warps' gray histograms, the two tables
constexpr int kSmemInts = kBins + kWarps * 256 + 2 * 256;

// The scratch of a call, in int32s: kernel 1's workspace for one slice an
// image, then the gray histograms (B, 256) int32, then the saturation
// totals (B,) int64 (8-byte aligned).
struct Scratch {
  HsWorkspace ws;
  int* gray;
  unsigned long long* sat;
  long long ints;
};

Scratch scratch_of(void* base, int batch) {
  Scratch s;
  const long long ws_ints = hs_workspace_ints(batch, 1);
  const long long sat_at = (ws_ints + 256LL * batch + 1) / 2 * 2;
  s.ws = hs_workspace(base, batch);
  s.gray = static_cast<int*>(base) + ws_ints;
  s.sat = reinterpret_cast<unsigned long long*>(static_cast<int*>(base) + sat_at);
  s.ints = sat_at + 2LL * batch;
  return s;
}

// one pixel: cv2's gray, S and H (ops/colorspace.py), added to the
// histograms. cv2's H lies in 0..179 and S in 0..255 for every RGB triple
// (ops/colorspace.py's formulas, checked on all 2^24 in
// tests/test_torch_ops.py), so every pixel lands in the H-S histogram and
// an image's in-range count is its pixel count; the clamp only keeps a
// fault from writing past the histogram.
__device__ __forceinline__ void add_pixel(int r, int g, int b, int* hs, int* gh,
                                          const int* sdiv, const int* hdiv, int& sat) {
  const int v = max(max(r, g), b);
  const int diff = v - min(min(r, g), b);
  // sdiv[0] = hdiv[0] = 0: v == 0 gives S = 0 and diff == 0 gives H = 0
  const int s = (diff * sdiv[v] + kHalf) >> kHsvShift;
  const int h_num = v == r ? g - b : (v == g ? (b - r) + 2 * diff : (r - g) + 4 * diff);
  int h = (h_num * hdiv[diff] + kHalf) >> kHsvShift;   // arithmetic shift
  h += h < 0 ? 180 : 0;
  atomicAdd(&hs[min((unsigned)(h * kSatBins + s), (unsigned)kBins - 1)], 1);
  atomicAdd(&gh[(r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15], 1);
  sat += s;
}

// the 16 pixels of one group, from its 48 bytes
__device__ __forceinline__ void add_group(const uint4 (&q)[3], int* hs, int* gh,
                                          const int* sdiv, const int* hdiv,
                                          long long& sat) {
  const unsigned w[12] = {q[0].x, q[0].y, q[0].z, q[0].w, q[1].x, q[1].y,
                          q[1].z, q[1].w, q[2].x, q[2].y, q[2].z, q[2].w};
  int group_sat = 0;     // at most 16 * 255
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    int c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = 3 * i + j;
      c[j] = (w[k >> 2] >> (8 * (k & 3))) & 255;
    }
    add_pixel(c[0], c[1], c[2], hs, gh, sdiv, hdiv, group_sat);
  }
  sat += group_sat;
}

__device__ __forceinline__ void load_group(const uint4* src, long long group, uint4 (&q)[3]) {
  q[0] = __ldg(src + 3 * group);
  q[1] = __ldg(src + 3 * group + 1);
  q[2] = __ldg(src + 3 * group + 2);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_stats_pass(const unsigned char* __restrict__ rgb, Scratch sc, long long n,
                 long long total, long long per) {
  extern __shared__ int4 smem4[];
  int* hs = reinterpret_cast<int*>(smem4);
  int* gh_all = hs + kBins;
  int* sdiv = gh_all + kWarps * 256;
  int* hdiv = sdiv + 256;
  int* gh = gh_all + (threadIdx.x >> 5) * 256;
  __shared__ long long scratch[32];

  for (int i = threadIdx.x; i < (kBins + kWarps * 256) / 4; i += kThreads) {
    smem4[i] = make_int4(0, 0, 0, 0);
  }
  if (threadIdx.x < 256) {
    // cv2's tables with exact integer rounding: round(a / b) = (2a + b) / 2b
    const int i = threadIdx.x;
    sdiv[i] = i ? (2 * (255 << kHsvShift) + i) / (2 * i) : 0;
    hdiv[i] = i ? (2 * (180 << kHsvShift) + 6 * i) / (12 * i) : 0;
  }
  __syncthreads();

  const bool wide = (reinterpret_cast<uintptr_t>(rgb) & 15) == 0;
  const uint4* src4 = reinterpret_cast<const uint4*>(rgb);
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < total ? lo + per : total;
  for (long long s0 = lo; s0 < hi;) {
    const int b = (int)(s0 / n);
    const long long s1 = (long long)(b + 1) * n < hi ? (long long)(b + 1) * n : hi;
    // whole groups inside [s0, s1); the rest goes pixel by pixel
    long long g0 = (s0 + kGroup - 1) / kGroup, g1 = s1 / kGroup;
    if (!wide || g0 >= g1) g0 = g1 = s1 / kGroup + 1;
    const long long head_end = g0 * kGroup < s1 ? g0 * kGroup : s1;
    const long long tail_start = g1 * kGroup > head_end ? g1 * kGroup : head_end;
    long long sat = 0;
    int pixel_sat = 0;
    for (long long p = s0 + threadIdx.x; p < head_end; p += kThreads) {
      const unsigned char* px = rgb + 3 * p;
      add_pixel(px[0], px[1], px[2], hs, gh, sdiv, hdiv, pixel_sat);
    }
    for (long long p = tail_start + threadIdx.x; p < s1; p += kThreads) {
      const unsigned char* px = rgb + 3 * p;
      add_pixel(px[0], px[1], px[2], hs, gh, sdiv, hdiv, pixel_sat);
    }
    sat += pixel_sat;
    for (long long g = g0 + threadIdx.x; g < g1; g += kThreads) {
      uint4 q[3];
      load_group(src4, g, q);
      add_group(q, hs, gh, sdiv, hdiv, sat);
    }
    sat = block_sum(sat, scratch);   // its __syncthreads also fence the atomics

    // flush image b's part, clearing the histograms for the next
    int* out = sc.ws.hist + (long long)b * kBins;
    for (int i = threadIdx.x; i < kBins / 4; i += kThreads) {
      const int4 v = smem4[i];
      if (v.x) atomicAdd(out + 4 * i, v.x);
      if (v.y) atomicAdd(out + 4 * i + 1, v.y);
      if (v.z) atomicAdd(out + 4 * i + 2, v.z);
      if (v.w) atomicAdd(out + 4 * i + 3, v.w);
      smem4[i] = make_int4(0, 0, 0, 0);
    }
    if (threadIdx.x < 256) {
      int v = 0;
      for (int w = 0; w < kWarps; ++w) {
        v += gh_all[w * 256 + threadIdx.x];
        gh_all[w * 256 + threadIdx.x] = 0;
      }
      if (v) atomicAdd(sc.gray + b * 256 + threadIdx.x, v);
    }
    if (threadIdx.x == 0) {
      atomicAdd(sc.ws.counts + b, (int)(s1 - s0));    // slices = 1
      if (sat) atomicAdd(sc.sat + b, (unsigned long long)sat);
    }
    __syncthreads();   // cleared before the next image's adds
    s0 = s1;
  }
}

// One block of 256 threads per image: the gray histogram out, and the
// saturation total as its pair.
__global__ void __launch_bounds__(256)
fused_stats_finish(Scratch sc, int* __restrict__ gray_hist, long long* __restrict__ sat_pair) {
  const int b = blockIdx.x;
  gray_hist[b * 256 + threadIdx.x] = sc.gray[b * 256 + threadIdx.x];
  if (threadIdx.x == 0) {
    const long long total = (long long)sc.sat[b];
    sat_pair[2 * b] = total >> 12;
    sat_pair[2 * b + 1] = total & 4095;
  }
}

unsigned long long g_smem_allowed = 0;   // devices where the opt-in is made

}  // namespace

// The scratch of a call, in int32s (Scratch above).
extern "C" int facet_fused_stats_scratch(int batch, long long* ints) {
  *ints = scratch_of(nullptr, batch).ints;
  return 0;
}

// rgb: (B, n, 3) uint8, contiguous. scratch: facet_fused_stats_scratch's
// int32s, 16-byte aligned, cleared here. Outputs: entropy (B,) float32,
// gray_hist (B, 256) int32, sat_pair (B, 2) int64. sm_count: the card's
// SMs, one block each. Returns the cudaError_t of the launches.
extern "C" int facet_fused_stats(const void* rgb, void* scratch, void* entropy,
                                 void* gray_hist, void* sat_pair, int batch, long long n,
                                 int sm_count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err = allow_smem_once(fused_stats_pass, smem, g_smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const Scratch sc = scratch_of(scratch, batch);
  err = cudaMemsetAsync(scratch, 0, sc.ints * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  // equal ranges of whole groups, one block an SM
  const long long total = (long long)batch * n;
  const long long groups = (total + kGroup - 1) / kGroup;
  const long long per = (groups + sm_count - 1) / sm_count * kGroup;
  const int grid = (int)((total + per - 1) / per);
  fused_stats_pass<<<grid, kThreads, smem, st>>>(static_cast<const unsigned char*>(rgb), sc,
                                                 n, total, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_hs_entropy_reduce(sc.ws, static_cast<float*>(entropy), batch, 1, 0, st);
  if (err != cudaSuccess) return (int)err;
  fused_stats_finish<<<batch, 256, 0, st>>>(sc, static_cast<int*>(gray_hist),
                                            static_cast<long long*>(sat_pair));
  return (int)cudaGetLastError();
}
