// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, dQ and dK/dV.
//
// Replaces: aiko_services_tpu/parallel/attention.py::_flash_dq_kernel and
// ::_flash_dkv_kernel (the Pallas TPU kernels launched by _flash_bwd_impl).
// Same function, not the same block structure.  With s = q.k * sm_scale
// and the forward's per-row logsumexp LSE:
//
//   p_ij  = mask_ij ? exp(s_ij - LSE_i) : 0        (exactly 0 when masked)
//   ds_ij = p_ij * (dO_i . v_j - delta_i),   delta_i = rowsum(dO_i * O_i)
//   dQ_i  = sm_scale * sum_j ds_ij k_j                      (dQ kernel)
//   dV_j  = sum_i p_ij dO_i,  dK_j = sm_scale * sum_i ds_ij q_i  (dK/dV)
//
//   mask: keys at or past Lk and rows at or past Lq contribute nothing;
//   when causal, key j is kept only if j <= i + diag_offset, where
//   diag_offset = q_offset + (Lk - Lq), as the forward kernel takes it.
//   Tiles wholly above the causal diagonal are skipped.
//
// Inputs q and dO (B*H, Lq, D), k and v (B*H, Lk, D), contiguous, all
// float32 or all bfloat16; LSE and delta float32 (B*H, Lq); D in
// {16, 32, 64, 128}.  dQ, dK, dV have the inputs' type.  All arithmetic
// is float32.
//
// Bound on an H100 SXM at the llama32_1b training shape (B*H = 128,
// Lq = Lk = 1024, D = 64, bf16, causal).  dQ must read q, k, v, dO
// (4 x 16.8 MB) and LSE, delta (1 MB) and write dQ (16.8 MB): 85 MB, 25 us
// at 3.35 TB/s; its 6*D FLOP per visible (i, j) pair over the 67.2 M pairs
// of the causal triangle are 25.8 GFLOP, 26 us at the bf16 tensor-core
// peak of 989 TFLOP/s.  dK/dV reads the same 68 MB and writes 33.6 MB
// (30 us) for 8*D FLOP per pair, 34.4 GFLOP (35 us).  So both are bound
// by their operations, barely.
//
// Design.  The TPU walked one sequence axis as a sequential grid
// dimension with the accumulator in scratch memory; CUDA blocks run in no
// order and share nothing, so that axis is a loop inside the block and no
// block writes another's output (no atomics):
//   dQ:    one block of 256 threads per (b*h, 64-row q tile).  q (pre-
//          scaled) and dO stay in shared memory; each k step stages a K and
//          V tile (as float32), every thread computes a 4x4 patch of the
//          64x64 score and dO.V^T tiles, turns them into dS in shared
//          memory, and accumulates a 4 x D/16 patch of dQ in registers.
//   dK/dV: one block per (b*h, 64-row k tile).  K and V stay in shared
//          memory; each q step stages q (pre-scaled, so that dK needs no
//          final scale), dO, LSE and delta, builds P^T and dS^T in shared
//          memory, and accumulates 4 x D/16 patches of dK and dV in
//          registers.
// Shared-memory rows are padded to D + 1 floats so that the rows a warp
// reads at once fall in different banks.  The products run on the
// float32 CUDA cores, not the tensor cores: at about 2 FLOP per byte of
// shared memory read this is far from both bounds.  Tensor cores
// (mma.sync / wgmma), TMA staging and one fused kernel are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr int kStrideP = kBlockK + 16;  // row stride of the P / dS tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a (length, D) matrix into shared memory as
// float32 times `scale`, row stride D + 1; rows past `length` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int length, float scale) {
  for (int index = threadIdx.x; index < 64 * D; index += kThreads) {
    const int row = index / D;
    const int col = index % D;
    const int r = row0 + row;
    dst[row * (D + 1) + col] =
        r < length ? to_float(src[(size_t)r * D + col]) * scale : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int lq,
                int lk, int causal, float sm_scale, int diag_offset) {
  constexpr int kCols = D / 16;  // dQ columns owned by a thread
  constexpr int kStride = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBlockQ][D + 1], q * sm_scale
  float* dos = qs + kBlockQ * kStride;     // [kBlockQ][D + 1]
  float* ks = dos + kBlockQ * kStride;     // [kBlockK][D + 1]
  float* vs = ks + kBlockK * kStride;      // [kBlockK][D + 1]
  float* dss = vs + kBlockK * kStride;     // [kBlockQ][kStrideP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qg = q + (size_t)bh * lq * D;
  const T* dog = dout + (size_t)bh * lq * D;
  const T* kg = k + (size_t)bh * lk * D;
  const T* vg = v + (size_t)bh * lk * D;

  load_tile<T, D>(qs, qg, q0, lq, sm_scale);
  load_tile<T, D>(dos, dog, q0, lq, 1.0f);

  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < lq ? lse[(size_t)bh * lq + row] : 0.0f;
    row_delta[i] = row < lq ? delta[(size_t)bh * lq + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // last key any row of this tile may see
  const int last_row = min(q0 + kBlockQ, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(lk, last_row + diag_offset + 1);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous step's readers of ks/vs/dss are done
    load_tile<T, D>(ks, kg, k0, lk, 1.0f);
    load_tile<T, D>(vs, vg, k0, lk, 1.0f);
    __syncthreads();

    // scores and dO.V^T: rows ty + 16 i, columns (keys) tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * kStride + d];
        ov[i] = dos[(ty + 16 * i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kStride + d];
        vv[j] = vs[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < lk && row < lq;
        if (causal) keep = keep && kpos <= row + diag_offset;
        const float p = keep ? expf(s[i][j] - row_lse[i]) : 0.0f;
        dss[(ty + 16 * i) * kStrideP + tx + 16 * j] =
            p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

    // acc += dS @ K: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kStrideP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    T* out = dq + ((size_t)bh * lq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(out + tx + 16 * j, acc[i][j] * sm_scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int lq, int lk, int causal,
                 float sm_scale, int diag_offset) {
  constexpr int kCols = D / 16;  // dK/dV columns owned by a thread
  constexpr int kStride = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                        // [kBlockK][D + 1]
  float* vs = ks + kBlockK * kStride;      // [kBlockK][D + 1]
  float* qs = vs + kBlockK * kStride;      // [kBlockQ][D + 1], q * sm_scale
  float* dos = qs + kBlockQ * kStride;     // [kBlockQ][D + 1]
  float* pts = dos + kBlockQ * kStride;    // [kBlockK][kStrideP], P^T
  float* dsts = pts + kBlockK * kStrideP;  // [kBlockK][kStrideP], dS^T
  float* lses = dsts + kBlockK * kStrideP; // [kBlockQ]
  float* deltas = lses + kBlockQ;          // [kBlockQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const T* qg = q + (size_t)bh * lq * D;
  const T* dog = dout + (size_t)bh * lq * D;
  const T* kg = k + (size_t)bh * lk * D;
  const T* vg = v + (size_t)bh * lk * D;
  const float* lseg = lse + (size_t)bh * lq;
  const float* deltag = delta + (size_t)bh * lq;

  load_tile<T, D>(ks, kg, k0, lk, 1.0f);
  load_tile<T, D>(vs, vg, k0, lk, 1.0f);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // first q tile with a row that sees a key of this tile: a row sees key
  // k0 only from k0 - diag_offset on, so tiles ending before it are skipped
  int q_begin = 0;
  if (causal) {
    const int first = k0 - diag_offset - (kBlockQ - 1);
    if (first > 0) q_begin = (first + kBlockQ - 1) / kBlockQ * kBlockQ;
  }

  for (int q0 = q_begin; q0 < lq; q0 += kBlockQ) {
    __syncthreads();  // the previous step's readers of qs/dos/pts/dsts done
    load_tile<T, D>(qs, qg, q0, lq, sm_scale);
    load_tile<T, D>(dos, dog, q0, lq, 1.0f);
    if (tid < kBlockQ) {
      const int row = q0 + tid;
      lses[tid] = row < lq ? lseg[row] : 0.0f;
      deltas[tid] = row < lq ? deltag[row] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: rows are keys ty + 16 i, columns q rows tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * kStride + d];
        vv[i] = vs[(ty + 16 * i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * kStride + d];
        ov[j] = dos[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int row = q0 + col;
        bool keep = kpos < lk && row < lq;
        if (causal) keep = keep && kpos <= row + diag_offset;
        const float p = keep ? expf(s[i][j] - lses[col]) : 0.0f;
        pts[(ty + 16 * i) * kStrideP + col] = p;
        dsts[(ty + 16 * i) * kStrideP + col] = p * (dp[i][j] - deltas[col]);
      }
    }
    __syncthreads();

    // dV += P^T @ dO, dK += dS^T @ (q * sm_scale): rows ty + 16 i,
    // columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBlockQ; ++c) {
      float pv[4], dsv[4], ov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pts[(ty + 16 * i) * kStrideP + c];
        dsv[i] = dsts[(ty + 16 * i) * kStrideP + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ov[j] = dos[c * kStride + tx + 16 * j];
        qv[j] = qs[c * kStride + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= lk) continue;
    T* dk_row = dk + ((size_t)bh * lk + row) * D;
    T* dv_row = dv + ((size_t)bh * lk + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store(dk_row + tx + 16 * j, acc_k[i][j]);
      store(dv_row + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch_heads, int lq, int lk, int causal,
                      float sm_scale, int diag_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBlockQ * (D + 1) + 2 * kBlockK * (D + 1) +
                       kBlockQ * kStrideP);
  cudaError_t error = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (error != cudaSuccess) return error;
  dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch_heads);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), lq, lk, causal, sm_scale, diag_offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       int batch_heads, int lq, int lk, int causal,
                       float sm_scale, int diag_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBlockK * (D + 1) + 2 * kBlockQ * (D + 1) +
                       2 * kBlockK * kStrideP + 2 * kBlockQ);
  cudaError_t error = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (error != cudaSuccess) return error;
  dim3 grid((lk + kBlockK - 1) / kBlockK, batch_heads);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, causal, sm_scale,
      diag_offset);
  return cudaGetLastError();
}

template <typename T>
struct TypeTag {
  using type = T;
};

// calls launcher(TypeTag<T>{}, std::integral_constant<int, D>{}) for the
// element type and head dimension the caller names
template <typename Launcher>
cudaError_t dispatch(int dtype, int head_dim, Launcher launcher) {
  auto by_dim = [&](auto tag) -> cudaError_t {
    switch (head_dim) {
      case 16: return launcher(tag, std::integral_constant<int, 16>{});
      case 32: return launcher(tag, std::integral_constant<int, 32>{});
      case 64: return launcher(tag, std::integral_constant<int, 64>{});
      case 128: return launcher(tag, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_dim(TypeTag<float>{});
  if (dtype == 1) return by_dim(TypeTag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

cudaError_t check_sizes(int batch_heads, int lq, int lk) {
  if (batch_heads <= 0 || lq <= 0 || lk <= 0) return cudaErrorInvalidValue;
  if (batch_heads > 65535) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  diag_offset is q_offset + (Lk - Lq)
// when causal (ignored otherwise).  Each returns the launch's cudaError_t.
extern "C" int aiko_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch_heads, int lq,
    int lk, int head_dim, int dtype, int causal, float sm_scale,
    int diag_offset, void* stream) {
  cudaError_t error = check_sizes(batch_heads, lq, lk);
  if (error != cudaSuccess) return error;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_in = static_cast<const float*>(lse);
  const float* delta_in = static_cast<const float*>(delta);
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(dim)::value;
    return launch_dq<T, D>(q, k, v, dout, lse_in, delta_in, dq, batch_heads,
                           lq, lk, causal, sm_scale, diag_offset, s);
  });
}

extern "C" int aiko_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch_heads,
    int lq, int lk, int head_dim, int dtype, int causal, float sm_scale,
    int diag_offset, void* stream) {
  cudaError_t error = check_sizes(batch_heads, lq, lk);
  if (error != cudaSuccess) return error;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_in = static_cast<const float*>(lse);
  const float* delta_in = static_cast<const float*>(delta);
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(dim)::value;
    return launch_dkv<T, D>(q, k, v, dout, lse_in, delta_in, dk, dv,
                            batch_heads, lq, lk, causal, sm_scale,
                            diag_offset, s);
  });
}
