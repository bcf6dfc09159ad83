// Cross-attention softmax(Q K^T) V for TOPIQ's finest level, head dim 64.
//
// Replaces: facet_tpu/ops/pallas_attn.py:cross_attention_pallas (kernel
// _attn_kernel). Numerics follow that kernel exactly: q, k, v rounded to
// bf16; scores accumulated in f32; softmax in f32; p normalized THEN
// rounded to bf16; P V accumulated in f32. q arrives pre-scaled by
// 1/sqrt(64). There is no mask.
//
// What bounds it on an H100: at 9216 queries x 2304 keys per (batch, head)
// the work is ~2.7 GFLOP per (b, h) of bf16 tensor-core products, and the
// score matrix (85 MB per (b, h) in f32) must never reach device memory.
// The TPU kernel kept all of K and V resident in VMEM; in bf16 they take
// 576 KB for one (b, h) at 2304 keys, more than the 227 KB of shared memory
// a block can hold, so this kernel streams K/V tiles instead.
//
// Design (first right version, two passes): one block of 4 warps per
// (b*h, 64-query tile); each warp owns 16 query rows. The block converts
// its Q tile to bf16 in shared memory once. Pass 1 streams 64-key K tiles,
// computes the 64x64 score tile with bf16 wmma (m16n16k16, f32 accumulate)
// into shared memory and keeps each row's running max and running sum of
// exp. Pass 2 streams K and V again, recomputes the scores, forms
// bf16(exp(s - m) / l) exactly as the TPU kernel does, and accumulates P V
// with wmma in registers. The only difference from the TPU kernel's
// rounding is the order of the f32 sums (the row sum is built tile by tile
// with rescaling), which stays at float32 rounding level. wgmma, TMA, a
// single online pass and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kQT = 64;         // query rows per block
constexpr int kKT = 64;         // keys per tile
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kLdb = kD + 8;    // bf16 smem row stride (144 B, keeps 32 B alignment)
constexpr int kLds = kKT + 4;   // f32 score row stride (272 B)
constexpr int kTileBf16 = kQT * kLdb;
constexpr size_t kSmemBytes =
    4 * kTileBf16 * sizeof(__nv_bfloat16) + kQT * kLds * sizeof(float);

// rows x 64 f32 (contiguous) -> bf16 rows with stride kLdb
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const float* __restrict__ src,
                                               int rows) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < rows * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    const float4 f = __ldg(src4 + i);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + r * kLdb + c);
    d[0] = __floats2bfloat162_rn(f.x, f.y);
    d[1] = __floats2bfloat162_rn(f.z, f.w);
  }
}

// The warp's 16x64 score rows: S = Q[r0:r0+16] K_tile^T -> ss (f32).
__device__ __forceinline__ void score_tile(const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks, float* ss,
                                           int r0) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kKT / 16];
#pragma unroll
  for (int n = 0; n < kKT / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + r0 * kLdb + kk * 16, kLdb);
#pragma unroll
    for (int n = 0; n < kKT / 16; ++n) {
      // K^T as a column-major (dim x key) operand: column n is key n's row
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + n * 16 * kLdb + kk * 16, kLdb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kKT / 16; ++n) {
    wmma::store_matrix_sync(ss + r0 * kLds + n * 16, acc[n], kLds,
                            wmma::mem_row_major);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTileBf16;
  __nv_bfloat16* vs = ks + kTileBf16;
  __nv_bfloat16* ps = vs + kTileBf16;
  float* ss = reinterpret_cast<float*>(ps + kTileBf16);

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const float* qg = q + (bh * nq + q0) * kD;
  const float* kg = k + bh * nk * kD;
  const float* vg = v + bh * nk * kD;
  float* og = o + (bh * nq + q0) * kD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile_bf16(qs, qg, kQT);

  // running row max / row sum of exp for the warp's 16 rows (all lanes hold them)
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  // ---- pass 1: row max and row sum of exp
  for (int t = 0; t < nk; t += kKT) {
    __syncthreads();
    load_tile_bf16(ks, kg + (long long)t * kD, kKT);
    __syncthreads();
    score_tile(qs, ks, ss, r0);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* row = ss + (r0 + r) * kLds;
      const float a = row[lane];
      const float b = row[lane + 32];
      const float mn = fmaxf(m[r], warp_max(fmaxf(a, b)));
      const float e = warp_sum(expf(a - mn) + expf(b - mn));
      l[r] = l[r] * expf(m[r] - mn) + e;
      m[r] = mn;
    }
  }

  // ---- pass 2: P = bf16(exp(s - m) / l), O += P V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  for (int t = 0; t < nk; t += kKT) {
    __syncthreads();
    load_tile_bf16(ks, kg + (long long)t * kD, kKT);
    load_tile_bf16(vs, vg + (long long)t * kD, kKT);
    __syncthreads();
    score_tile(qs, ks, ss, r0);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* row = ss + (r0 + r) * kLds;
      __nv_bfloat16* prow = ps + (r0 + r) * kLdb;
      prow[lane] = __float2bfloat16(expf(row[lane] - m[r]) / l[r]);
      prow[lane + 32] = __float2bfloat16(expf(row[lane + 32] - m[r]) / l[r]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + r0 * kLdb + kk * 16, kLdb);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, vs + kk * 16 * kLdb + n * 16, kLdb);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(og + r0 * kD + n * 16, acc[n], kD, wmma::mem_row_major);
  }
}

}  // namespace

// q: (BH, nq, 64), k/v: (BH, nk, 64), o: (BH, nq, 64), all f32 contiguous.
// nq and nk must be multiples of 64. Returns the launch's cudaError_t.
extern "C" int facet_cross_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int nq,
                                     int nk, int d, void* stream) {
  if (d != kD || nq % kQT != 0 || nk % kKT != 0 || bh <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cross_attention_kernel<<<dim3(nq / kQT, bh), kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), nq, nk);
  return (int)cudaGetLastError();
}
