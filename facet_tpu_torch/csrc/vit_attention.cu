// Self-attention of the CLIP ViT (257 tokens, heads of 64), bf16.
//
// Replaces: JAX's Pallas TPU flash-attention kernel as
// facet_tpu/models/clip.py:_flash_attention calls it. At the engine's
// schedule the 257 tokens, padded to 384, form one key block, so that
// kernel's pallas_call runs _flash_attention_kernel_single_batch_single_step.
// Numerics follow that body:
//   - scores accumulated in f32 from the unscaled bf16 q and k, then
//     multiplied by `scale` in f32;
//   - keys at or past the sequence length excluded (the TPU kernel masks its
//     padding by segment ids; the masked exp is exactly 0);
//   - the row max, p = exp(s - max) and the row sum l in f32;
//   - p / l rounded to bf16 (normalized before the rounding);
//   - P V accumulated in f32 and rounded once to bf16.
//
// What bounds it on an H100: bytes. At the engine's batch of 24, q, k, v
// and the output, (24, 257, 16, 64) bf16 each, are 50.5 MB: 0.0151 ms at
// 3.35 TB/s, against 6.49 GFLOP of tensor-core work, 0.0066 ms at 989
// TFLOP/s. The scores (24 x 16 x 257 x 257 in f32, 102 MB) must not reach
// device memory.
//
// Design (first right version): no padding in device memory. One block of
// 4 warps per (batch, head, 64-query tile): five tiles per head at 257
// tokens, the last holding one row. The block stages its query tile and all
// of the head's keys and values in shared memory as bf16, zero-filled to
// s_pad, the sequence rounded up to 16. Each warp owns 16 query rows:
//   1. their 16 x s_pad f32 scores with bf16 wmma (m16n16k16, f32
//      accumulate) into shared memory;
//   2. each row's softmax with warp shuffles, its bf16 p written over the
//      row's own scores (zero for the excluded keys);
//   3. P V with wmma, the f32 result staged over the same rows and written
//      as bf16 rows of the (B, S, H, 64) output; rows >= S were computed on
//      zero queries and are not written.
// Shared memory is 10,240 + 544 * s_pad bytes for s_pad >= 64 (158,208 at
// s_pad = 272), so one block fits an SM. wgmma, TMA and more blocks per SM are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kD = 64;           // head dim
constexpr int kQT = 64;          // query rows per block
constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr int kLdb = kD + 8;     // bf16 row stride of q, k, v (144 B)
constexpr int kMaxSeq = 400;     // s_pad <= 400 keeps shared memory <= 227 KB
constexpr int kMaxPerLane = (kMaxSeq + 31) / 32;

// f32 row stride of the score tile, whose rows later hold the 64-wide output
__host__ __device__ constexpr int score_stride(int s_pad) {
  return (s_pad > kD ? s_pad : kD) + 4;
}

__host__ __device__ constexpr size_t smem_bytes(int s_pad) {
  return (size_t)(kQT + 2 * s_pad) * kLdb * sizeof(__nv_bfloat16) +
         (size_t)kQT * score_stride(s_pad) * sizeof(float);
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

// rows [t0, t0 + n_rows) of one head's (seq, 64) slab -> dst (stride kLdb),
// zero for tokens >= seq; 16-byte loads, 8 per 64-wide row
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* __restrict__ src, int t0,
                                      int n_rows, int seq, long long row_stride) {
  for (int i = threadIdx.x; i < n_rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < seq) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (long long)(t0 + r) * row_stride + c));
    }
    *reinterpret_cast<uint4*>(dst + r * kLdb + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int seq, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = (seq + 15) & ~15;
  const int lds = score_stride(s_pad);
  const int ldp = 2 * lds;         // bf16 stride of p, written over the scores
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kQT * kLdb;
  __nv_bfloat16* vs = ks + s_pad * kLdb;
  float* ss = reinterpret_cast<float*>(vs + s_pad * kLdb);

  const int tile0 = blockIdx.x * kQT;
  const long long row_stride = (long long)heads * kD;
  const long long base = ((long long)blockIdx.z * seq * heads + blockIdx.y) * kD;
  stage(qs, q + base, tile0, kQT, seq, row_stride);
  stage(ks, k + base, 0, s_pad, seq, row_stride);
  stage(vs, v + base, 0, s_pad, seq, row_stride);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  // ---- 1. S = Q K^T for the warp's 16 rows, 16 keys at a time
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], qs + r0 * kLdb + kk * 16, kLdb);
  }
  for (int n = 0; n < s_pad / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      // K^T as a column-major (dim x key) operand: column j is key j's row
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, ks + n * 16 * kLdb + kk * 16, kLdb);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(ss + r0 * lds + n * 16, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // ---- 2. p = bf16(exp(s * scale - max) / l), over each row's own scores
  for (int r = 0; r < 16; ++r) {
    float* row = ss + (r0 + r) * lds;
    float x[kMaxPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      x[i] = c < seq ? row[c] * scale : -INFINITY;
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      x[i] = c < seq ? expf(x[i] - m) : 0.0f;
      l += x[i];
    }
    l = warp_sum(l);
    __syncwarp();    // every lane has read the row before any lane overwrites it
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < s_pad) prow[c] = __float2bfloat16_rn(x[i] / l);
    }
  }
  __syncwarp();

  // ---- 3. O = P V, f32 accumulate
  const __nv_bfloat16* ps = reinterpret_cast<const __nv_bfloat16*>(ss);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(oacc[n], 0.0f);
  for (int kk = 0; kk < s_pad / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, ps + r0 * ldp + kk * 16, ldp);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, vs + kk * 16 * kLdb + n * 16, kLdb);
      wmma::mma_sync(oacc[n], pa, vb, oacc[n]);
    }
  }
  __syncwarp();      // p is read; its rows now hold the f32 output
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(ss + r0 * lds + n * 16, oacc[n], lds, wmma::mem_row_major);
  }
  __syncwarp();
  // one 128-byte output row per warp step: lane j writes dims 2j, 2j + 1
  for (int r = 0; r < 16; ++r) {
    const int t = tile0 + r0 + r;
    if (t >= seq) break;
    const float* orow = ss + (r0 + r) * lds;
    *reinterpret_cast<__nv_bfloat162*>(o + base + (long long)t * row_stride + 2 * lane) =
        __floats2bfloat162_rn(orow[2 * lane], orow[2 * lane + 1]);
  }
}

}  // namespace

// q, k, v, o: (batch, seq, heads, 64) bf16 contiguous, 16-byte aligned.
// o = softmax(q k^T * scale) v per (batch, head). Returns the launch's
// cudaError_t.
extern "C" int facet_vit_attention(const void* q, const void* k, const void* v, void* o,
                                   int batch, int seq, int heads, int d, float scale,
                                   void* stream) {
  if (d != kD || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      seq <= 0 || seq > kMaxSeq) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes((seq + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kQT - 1) / kQT, heads, batch);
  vit_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, heads,
      scale);
  return (int)cudaGetLastError();
}
