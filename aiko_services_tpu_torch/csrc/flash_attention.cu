// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: aiko_services_tpu/parallel/attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _flash_impl).  Same function, not the
// same block structure:
//
//   O[b,h,i,:] = softmax_j(mask(q_i . k_j * sm_scale)) @ V[b,h,:,:]
//   LSE[b,h,i] = m_i + log(max(l_i, 1e-30))
//
//   mask: keys at or past Lk are dropped; when causal, key j is kept only
//   if j <= i + q_offset + (Lk - Lq).  Masked scores are -1e30 (the TPU
//   kernel's constant), rows are normalised with max(l, 1e-30).
//
// Inputs q (B*H, Lq, D), k and v (B*H, Lk, D), contiguous, all float32 or
// all bfloat16; D in {16, 32, 64, 128}.  O has q's type; LSE is float32
// (B*H, Lq).  All arithmetic is float32.
//
// Bound on an H100 SXM.  The kernel must read q, k, v once and write o and
// lse once: at the speech-serving shape (B*H = 1536, Lq = Lk = 251, D = 64,
// bf16) that is 4 * 1536*251*64*2 B + 1536*251*4 B = 199 MB, 59 us at
// 3.35 TB/s; its 4*Lq*Lk*D*B*H = 24.8 GFLOP take 25 us at the bf16
// tensor-core peak of 989 TFLOP/s.  So the bound is the bytes.
//
// Design.  One block of 256 threads per (b*h, 64-row q tile).  The k axis,
// which the TPU walked as a sequential grid dimension with m/l/acc in
// scratch memory, is a loop inside the block here, because CUDA blocks run
// in no order and share nothing.  Each k step stages a 64-row K tile and
// V tile in shared memory (converted to float32), every thread computes a
// 4x4 patch of the 64x64 score tile from shared memory, the online-softmax
// statistics of a row live in registers of the 16 threads that own the
// row (reduced with warp shuffles), the probabilities go through shared
// memory once, and each thread accumulates a 4 x D/16 patch of O in
// registers.  Tiles entirely above the causal diagonal or past Lk are
// skipped.  q, k and v are each read from device memory once per q tile
// (k and v once per q tile: at Lq = 251 that is 4 tiles, so the K/V
// traffic is 4x the bound's; L2 holds a (b,h)'s K/V for the tiles that
// share it).  The products run on the float32 CUDA cores, not the tensor
// cores: simple and exact first; wgmma, TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int lq, int lk, int causal,
                     float sm_scale, int diag_offset) {
  constexpr int kCols = D / 16;          // O columns owned by a thread
  // row strides padded so that the rows a warp reads at once fall in
  // different shared-memory banks
  constexpr int kStrideQ = D + 1;
  constexpr int kStrideK = D + 1;
  constexpr int kStrideP = kBlockK + 16;
  extern __shared__ float smem[];
  float* qs = smem;                                  // [kBlockQ][D + 1]
  float* ks = qs + kBlockQ * kStrideQ;               // [kBlockK][D + 1]
  float* vs = ks + kBlockK * kStrideK;               // [kBlockK][D]
  float* ps = vs + kBlockK * D;                      // [kBlockQ][kBlockK + 16]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qg = q + (size_t)bh * lq * D;
  const T* kg = k + (size_t)bh * lk * D;
  const T* vg = v + (size_t)bh * lk * D;

  // the q tile, pre-scaled as the TPU kernel scales it
  for (int index = tid; index < kBlockQ * D; index += kThreads) {
    const int row = index / D;
    const int col = index % D;
    const int qrow = q0 + row;
    qs[row * kStrideQ + col] =
        qrow < lq ? to_float(qg[(size_t)qrow * D + col]) * sm_scale : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // last key any row of this tile may see
  const int last_row = min(q0 + kBlockQ, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(lk, last_row + diag_offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous step's readers of ks/vs/ps are done
    for (int index = tid; index < kBlockK * D; index += kThreads) {
      const int row = index / D;
      const int col = index % D;
      const int krow = k0 + row;
      float kval = 0.0f, vval = 0.0f;
      if (krow < lk) {
        kval = to_float(kg[(size_t)krow * D + col]);
        vval = to_float(vg[(size_t)krow * D + col]);
      }
      ks[row * kStrideK + col] = kval;
      vs[index] = vval;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kStrideQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kStrideK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + diag_offset;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < lk;
        if (causal) keep = keep && kpos <= qpos;
        if (!keep) s[i][j] = kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1)
        row_max = fmaxf(row_max,
                        __shfl_xor_sync(0xffffffffu, row_max, offset));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        ps[(ty + 16 * i) * kStrideP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, offset);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P @ V: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kStrideP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const float inv = 1.0f / denom;
    T* orow = o + ((size_t)bh * lq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0) lse[(size_t)bh * lq + row] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch_heads, int lq, int lk, int causal,
                   float sm_scale, int diag_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                                       kBlockK * D + kBlockQ * (kBlockK + 16));
  cudaError_t error = cudaFuncSetAttribute(
      flash_forward_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (error != cudaSuccess) return error;
  dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch_heads);
  flash_forward_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lq, lk, causal,
      sm_scale, diag_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch_heads, int lq,
                         int lk, int head_dim, int causal, float sm_scale,
                         int diag_offset, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch_heads, lq, lk, causal,
                           sm_scale, diag_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch_heads, lq, lk, causal,
                           sm_scale, diag_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch_heads, lq, lk, causal,
                           sm_scale, diag_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch_heads, lq, lk, causal,
                            sm_scale, diag_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  diag_offset is q_offset + (Lk - Lq)
// when causal (ignored otherwise).  Returns the launch's cudaError_t.
extern "C" int aiko_flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch_heads, int lq, int lk, int head_dim, int dtype, int causal,
    float sm_scale, int diag_offset, void* stream) {
  if (batch_heads <= 0 || lq <= 0 || lk <= 0) return cudaErrorInvalidValue;
  if (batch_heads > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, o, lse_out, batch_heads, lq, lk,
                               head_dim, causal, sm_scale, diag_offset, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse_out, batch_heads, lq,
                                       lk, head_dim, causal, sm_scale,
                                       diag_offset, s);
  return cudaErrorInvalidValue;
}
