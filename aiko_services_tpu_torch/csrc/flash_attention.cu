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
// (B*H, Lq).  The C entry point chooses the kernel by dtype (declared
// dispatch, not a fallback):
//   bfloat16 -> flash_forward_kernel_tc, on the tensor cores: bf16
//               operands, f32 sums and softmax;
//   float32  -> flash_forward_kernel, on the f32 CUDA cores, every product
//               in f32 as on the TPU (TF32 would not hold the f32 checks).
//
// Bound on an H100 SXM.  The kernel must read q, k, v once and write o and
// lse once.  At the speech-serving shape (B*H = 1536, Lq = Lk = 251,
// D = 64, bf16) that is 4 * 1536*251*64*2 B + 1536*251*4 B = 199 MB, 59 us
// at 3.35 TB/s, against 4*Lq*Lk*D*B*H = 24.8 GFLOP, 25 us at the bf16
// tensor-core peak of 989 TFLOP/s.  At the llama32_1b training shape
// (B*H = 128, Lq = Lk = 1024, D = 64, bf16, causal) it is 67.6 MB, 20 us,
// against 4*D FLOP on each of the 0.52 M visible pairs of a head: 17.2
// GFLOP, 17 us.  So both are bound by the bytes, and the products must run
// on the tensor cores for the kernel to come near that bound.
//
// Design of the bf16 kernel.  The TPU walked the k axis as a sequential
// grid dimension with m, l and acc in scratch memory; CUDA blocks run in no
// order and share nothing, so the k axis is a loop inside the block.  One
// block of two warpgroups (256 threads) per (b*h, 128-row q tile), each
// warpgroup owning 64 rows; two blocks an SM (at most 128 registers a
// thread), so that one block's products overlap the other's exponentials.
// The q tile is loaded once; K and V stream in tiles of 64 keys (32 at
// D = 128) through a two-stage cp.async ring, so the next tile's copy
// overlaps this tile's work.  Per tile a warpgroup computes S = q K^T with
// wgmma (m64nNk16, bf16 in, f32 out) from shared memory, and runs the
// online softmax in registers: each row's scores lie in the four lanes of
// a quad, so the row max is two shuffles; the exponential is one
// ex2.approx of fmaf(s, sm_scale * log2(e), -m), so m and l live in the
// log2 domain; l sums the f32 p, and acc is rescaled by exp2(m_old - m).
// P is rounded to bf16 in place (the accumulator fragment of two adjacent
// 8-key blocks is the A fragment of one 16-deep k-step) and O += P V runs
// as wgmma with P from registers and V read MN-major from the same
// swizzled tile K-major reads take: P never touches shared memory.  Whole
// key tiles above the causal diagonal are skipped, per block and per
// warpgroup; only diagonal and ragged tiles pay for the element mask
// (decided per warp).  The last q tile, the heaviest when causal, runs
// first across all b*h.  The epilogue divides by max(l, 1e-30), rounds O
// to bf16 in the q tile's shared memory and stores 16 bytes per thread;
// LSE = m * ln 2 + logf(max(l, 1e-30)) in natural units, as the backward
// kernels read it.  Not done yet: TMA loads from a producer warp, and
// overlapping one tile's products with the next tile's exponentials.
//
// Accuracy against the TPU kernel, which scales q in f32 before q.k and
// multiplies P.V in f32: here the bf16 products q.k are exact in f32 and
// the scale comes after (one f32 rounding apart, none at D = 16 or 64,
// where sm_scale is a power of two), and P is rounded to bf16 before P.V
// (2^-9 relative per entry).  A masked score takes part in the row max as
// the TPU's -1e30 and gets p = 2^(-1e30 * log2(e) - m): 1 while no key of
// its row has been kept, as on the TPU, and 0 after.
//
// The f32 kernel: one block of 256 threads per (b*h, 64-row q tile); each
// k step stages a 64-row K and V tile in shared memory, every thread
// computes a 4x4 patch of the score tile, the softmax statistics of a row
// live in the 16 threads that own it, the probabilities go through shared
// memory once, and each thread accumulates a 4 x D/16 patch of O.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel (every product in f32)
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (building blocks in hopper_tiles.cuh)
// ---------------------------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;
// the TPU's masked score, -1e30, in the log2 domain m and l are kept in
constexpr float kNegInfLog2 = kNegInf * kLog2e;

// tile shapes: q rows a block owns (two warpgroups of 64 rows), keys
// streamed a step; two blocks an SM
template <int D>
struct FwdTiles {
  static constexpr int kRows = 128;
  static constexpr int kThreads = 256;
  static constexpr int kBlocksPerSm = 2;
  static constexpr int kKeys = D <= 64 ? 64 : 32;
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes
  static constexpr size_t kSmem = SwizzledTile<D, kRows>::kBytes +
                                  4 * SwizzledTile<D, kKeys>::kBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads,
                                  FwdTiles<D>::kBlocksPerSm)
flash_forward_kernel_tc(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int lq, int lk, int causal,
                        float sm_scale, int diag_offset) {
  using Tiles = FwdTiles<D>;
  constexpr int BQ = Tiles::kRows;
  constexpr int BK = Tiles::kKeys;
  using QTile = SwizzledTile<D, BQ>;
  using KTile = SwizzledTile<D, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);    // QTile
  unsigned char* ks = qs + QTile::kBytes;      // [2] KTile
  unsigned char* vs = ks + 2 * KTile::kBytes;  // [2] KTile

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = warp / 4;      // warpgroup: rows group * 64 ..
  const int bh = blockIdx.x;
  // the last q tile, the heaviest when causal, goes first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* kg = k + (size_t)bh * lk * D;
  const bf16* vg = v + (size_t)bh * lk * D;
  const uint32_t qs_u = smem_u32(qs);
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs);

  load_tile_async<D, BQ>(qs_u, q + (size_t)bh * lq * D, q0, lq);

  // the key tiles any row of this tile may see
  const int last_row = min(q0 + BQ, lq) - 1;
  int k_end = lk;
  if (causal) k_end = min(lk, last_row + diag_offset + 1);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  auto load_step = [&](int t, int stage) {
    load_tile_async<D, BK>(ks_u + stage * KTile::kBytes, kg, t * BK, lk);
    load_tile_async<D, BK>(vs_u + stage * KTile::kBytes, vg, t * BK, lk);
  };
  if (n_tiles > 0) load_step(0, 0);
  cp_async_commit();  // q and the first step

  const int group_row = q0 + group * 64;  // first row of this warpgroup
  const int warp_row = q0 + warp * 16;    // first row of this warp
  const int row_a = warp_row + lane / 4;  // this thread's rows: row_a and
                                          // row_a + 8
  // the online softmax of the thread's two rows in the log2 domain: m the
  // running max of s * sm_scale * log2(e), l the sum of 2^(that - m) over
  // the thread's own columns (a quad's four sums make the row's)
  float m[2] = {kNegInfLog2, kNegInfLog2};
  float l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const float scale_log2 = sm_scale * kLog2e;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_step(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the step just issued has landed
    fence_async_shared();
    __syncthreads();

    const int k0 = t * BK;
    bool visible = group_row < lq;
    if (causal) visible = visible && k0 <= group_row + 63 + diag_offset;
    if (visible) {
      const uint32_t k_tile = ks_u + stage * KTile::kBytes;
      const uint32_t v_tile = vs_u + stage * KTile::kBytes;

      // S = q K^T: 64 rows x BK keys a warpgroup
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      fence_operands<BK / 8>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s, QTile::k_major(qs_u, group * 64, kk),
                     KTile::k_major(k_tile, 0, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<BK / 8>(s);

      // no key of this warp's 16 x BK tile is masked for any of its rows
      const bool full = k0 + BK <= lk &&
                        (!causal || k0 + BK - 1 <= warp_row + diag_offset);
      // the rows' max over their kept scores; a masked score is -inf here
      // and takes the TPU's -1e30 below
      float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          if (!full) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            bool keep = key < lk;
            if (causal) keep = keep && key <= row_a + 8 * h + diag_offset;
            s[j][e] = keep ? s[j][e] : -INFINITY;
          }
          row_max[h] = fmaxf(row_max[h], s[j][e]);
        }
      }
      float alpha[2], p_masked[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_max[h] = fmaxf(row_max[h],
                           __shfl_xor_sync(0xffffffffu, row_max[h], 1));
        row_max[h] = fmaxf(row_max[h],
                           __shfl_xor_sync(0xffffffffu, row_max[h], 2));
        // the masked scores (-1e30) take part in the max as the TPU's do:
        // m never falls below kNegInfLog2
        const float m_new = fmaxf(m[h], row_max[h] * scale_log2);
        alpha[h] = exp2_approx(m[h] - m_new);
        p_masked[h] = exp2_approx(kNegInfLog2 - m_new);  // 0 once a key
        m[h] = m_new;                                     // was kept
      }
      float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -m[h]));
          if (!full && s[j][e] == -INFINITY) p = p_masked[h];
          row_sum[h] += p;
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + row_sum[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // O += P V, P from registers, V read transposed
      uint32_t p_frag[BK / 16][4];
      to_a_fragments<BK>(s, p_frag);
      fence_operands<BK / 16>(p_frag);
      fence_operands<D / 8>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_t<D>(acc, p_frag[kk], KTile::mn_major(v_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<D / 8>(acc);
      fence_operands<BK / 16>(p_frag);
    }
    __syncthreads();  // this stage may be refilled by the next step
  }
  cp_async_wait<0>();
  __syncthreads();

  // O = acc / max(l, 1e-30) and LSE in natural units; q's tile becomes the
  // staging
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
    inv[h] = 1.0f / denom;
    const int row = row_a + 8 * h;
    if (lane % 4 == 0 && row < lq)
      lse[(size_t)bh * lq + row] = m[h] * kLn2 + logf(denom);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= inv[0];
    acc[j][1] *= inv[0];
    acc[j][2] *= inv[1];
    acc[j][3] *= inv[1];
  }
  stage_rows<D, BQ>(qs, acc, warp * 16 + lane / 4, 1.0f, lane);
  __syncthreads();
  store_rows<D, BQ>(o + (size_t)bh * lq * D, qs, q0, lq);
}

// ---------------------------------------------------------------------------
// launchers and the C interface
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch_heads, int lq, int lk, int causal,
                   float sm_scale, int diag_offset, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    using Tiles = FwdTiles<D>;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
      return cudaErrorMisalignedAddress;
    cudaError_t error = allow_smem(flash_forward_kernel_tc<D>, Tiles::kSmem);
    if (error != cudaSuccess) return error;
    dim3 grid(batch_heads, (lq + Tiles::kRows - 1) / Tiles::kRows);
    flash_forward_kernel_tc<D>
        <<<grid, Tiles::kThreads, Tiles::kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, lq, lk,
        causal, sm_scale, diag_offset);
  } else {
    const size_t smem =
        sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                         kBlockK * D + kBlockQ * (kBlockK + 16));
    cudaError_t error = allow_smem(flash_forward_kernel<float, D>, smem);
    if (error != cudaSuccess) return error;
    dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch_heads);
    flash_forward_kernel<float, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, lq, lk,
        causal, sm_scale, diag_offset);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  diag_offset is q_offset + (Lk - Lq)
// when causal (ignored otherwise).  bfloat16 tensors must start on a
// 16-byte boundary.  Returns the launch's cudaError_t.
extern "C" int aiko_flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch_heads, int lq, int lk, int head_dim, int dtype, int causal,
    float sm_scale, int diag_offset, void* stream) {
  cudaError_t error = check_sizes(batch_heads, lq, lk);
  if (error != cudaSuccess) return error;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(q, k, v, o, lse_out, batch_heads, lq, lk, causal,
                        sm_scale, diag_offset, s);
  });
}
