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
//
// Inputs q and dO (B*H, Lq, D), k and v (B*H, Lk, D), contiguous, all
// float32 or all bfloat16; LSE and delta float32 (B*H, Lq); D in
// {16, 32, 64, 128}.  dQ, dK, dV have the inputs' type.  The C entry
// points choose the kernels by dtype (declared dispatch, not a fallback):
//   bfloat16 -> the tensor-core kernels (flash_dq_kernel_tc,
//               flash_dkv_kernel_tc): bf16 operands, f32 accumulation;
//   float32  -> the f32 CUDA-core kernels (flash_dq_kernel,
//               flash_dkv_kernel), which keep every product in f32 as the
//               TPU kernels do (TF32 would not hold the f32 checks).
//
// Bound on an H100 SXM at the llama32_1b training shape (B*H = 128,
// Lq = Lk = 1024, D = 64, bf16, causal).  dQ must read q, k, v, dO
// (4 x 16.8 MB) and LSE, delta (1 MB) and write dQ (16.8 MB): 85 MB, 25 us
// at 3.35 TB/s; its 6*D FLOP per visible (i, j) pair over the 67.2 M pairs
// of the causal triangle are 25.8 GFLOP, 26 us at the bf16 tensor-core
// peak of 989 TFLOP/s.  dK/dV reads the same 68 MB and writes 33.6 MB
// (30 us) for 8*D FLOP per pair, 34.4 GFLOP (35 us).  So both are bound
// by their operations: the products must run on the tensor cores, fed
// from shared memory without copies.
//
// Design of the bf16 kernels.  The TPU walked one sequence axis as a
// sequential grid dimension with the accumulator in scratch memory; CUDA
// blocks run in no order and share nothing, so that axis is a loop inside
// the block, and each output tile has exactly one owner block (no atomics:
// the result is the same bit for bit from run to run).  The products are
// Hopper's warpgroup MMAs (wgmma.mma_async m64nNk16, bf16 in, f32 out):
// two warpgroups of 4 warps per block, each owning 64 rows of the output.
//   dK/dV: one block per (b*h, 128-key tile), one block an SM (the four
//          64-row accumulators take about 200 registers a thread).  K and
//          V stay in shared memory.  The block streams q, dO, LSE and delta
//          in tiles of 64 rows (32 at D = 128) through a two-stage cp.async
//          ring, so the next tile's copy overlaps this tile's products.
//          Per tile a warpgroup computes S^T = K q^T and dP^T = V dO^T with
//          both operands in shared memory, forms P^T and dS^T in
//          registers, rounds them to bf16 there and feeds them as the
//          register A operand of dV += P^T dO and dK += dS^T q: the
//          accumulator fragment of two adjacent 8-column blocks is exactly
//          the A fragment of one 16-deep k-step, so P and dS never touch
//          shared memory.  q and dO are the K-major B operand of the first
//          two products and, from the same bytes, the MN-major
//          (transposed) B operand of the last two.
//   dQ:    one block per (b*h, 128-row q tile), two blocks an SM (at most
//          128 registers a thread), so that one block's products overlap
//          the other's exponentials.  q and dO stay in shared memory; K and
//          V stream in tiles of 64 keys (32 at D = 128) through the same
//          ring.  S = q K^T, dP = dO V^T, then dQ += dS K with dS from
//          registers and K read MN-major.
// Shared-memory tiles are kept in the layout wgmma's descriptors read:
// column blocks of min(D, 64) elements, each with the 128-, 64- or 32-byte
// swizzle of its row width, so that one tile is legal both K-major and
// MN-major.  The exponential is one ex2.approx with log2(e) folded into
// the score scale and into LSE.  Whole tiles above the causal diagonal are
// skipped, per block and per warpgroup; only diagonal and ragged tiles pay
// for the element mask (decided per warp).  Blocks run heavy first (key
// tile 0 in dK/dV, the last q tile in dQ, across all b*h), so the grid's
// tail is made of light blocks.  The epilogue rounds the accumulators to
// bf16 in shared memory and stores 16 bytes per thread.  Not done yet: TMA
// loads from a producer warp, and overlapping one step's products with
// the next step's.

#include "hopper_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels (every product in f32)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kStrideP = kBlockK + 16;  // row stride of the P / dS tiles

// rows [row0, row0 + 64) of a (length, D) matrix into shared memory times
// `scale`, row stride D + 1; rows past `length` are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int length, float scale) {
  for (int index = threadIdx.x; index < 64 * D; index += kThreads) {
    const int row = index / D;
    const int col = index % D;
    const int r = row0 + row;
    dst[row * (D + 1) + col] =
        r < length ? src[(size_t)r * D + col] * scale : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int lq, int lk, int causal, float sm_scale,
                int diag_offset) {
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
  const float* qg = q + (size_t)bh * lq * D;
  const float* dog = dout + (size_t)bh * lq * D;
  const float* kg = k + (size_t)bh * lk * D;
  const float* vg = v + (size_t)bh * lk * D;

  load_tile<D>(qs, qg, q0, lq, sm_scale);
  load_tile<D>(dos, dog, q0, lq, 1.0f);

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
    load_tile<D>(ks, kg, k0, lk, 1.0f);
    load_tile<D>(vs, vg, k0, lk, 1.0f);
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
    float* out = dq + ((size_t)bh * lq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[tx + 16 * j] = acc[i][j] * sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int lq, int lk, int causal,
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
  const float* qg = q + (size_t)bh * lq * D;
  const float* dog = dout + (size_t)bh * lq * D;
  const float* kg = k + (size_t)bh * lk * D;
  const float* vg = v + (size_t)bh * lk * D;
  const float* lseg = lse + (size_t)bh * lq;
  const float* deltag = delta + (size_t)bh * lq;

  load_tile<D>(ks, kg, k0, lk, 1.0f);
  load_tile<D>(vs, vg, k0, lk, 1.0f);

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
    load_tile<D>(qs, qg, q0, lq, sm_scale);
    load_tile<D>(dos, dog, q0, lq, 1.0f);
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
    float* dk_row = dk + ((size_t)bh * lk + row) * D;
    float* dv_row = dv + ((size_t)bh * lk + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk_row[tx + 16 * j] = acc_k[i][j];
      dv_row[tx + 16 * j] = acc_v[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels (building blocks in hopper_tiles.cuh)
// ---------------------------------------------------------------------------

// tile shapes of the tensor-core kernels; each warpgroup (128 threads)
// owns 64 rows of its block's output tile
template <int D>
struct TcTiles {
  // dK/dV: keys a block owns (two warpgroups), q rows streamed a step;
  // one block an SM (its accumulators take about 200 registers a thread)
  static constexpr int kDkvKeys = 128;
  static constexpr int kDkvThreads = 256;
  static constexpr int kDkvBlocksPerSm = 1;
  static constexpr int kDkvRows = D <= 64 ? 64 : 32;
  // dQ: q rows a block owns (two warpgroups), keys streamed a step; two
  // blocks an SM (at most 128 registers a thread), so that one block's
  // products overlap the other's exponentials
  static constexpr int kDqRows = 128;
  static constexpr int kDqThreads = 256;
  static constexpr int kDqBlocksPerSm = 2;
  static constexpr int kDqKeys = D <= 64 ? 64 : 32;
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes
  static constexpr size_t kDkvSmem =
      2 * SwizzledTile<D, kDkvKeys>::kBytes +
      4 * SwizzledTile<D, kDkvRows>::kBytes + sizeof(float) * 4 * kDkvRows +
      1024;
  static constexpr size_t kDqSmem = 2 * SwizzledTile<D, kDqRows>::kBytes +
                                    4 * SwizzledTile<D, kDqKeys>::kBytes +
                                    1024;
};

template <int D>
__global__ void __launch_bounds__(TcTiles<D>::kDkvThreads,
                                  TcTiles<D>::kDkvBlocksPerSm)
flash_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int lq, int lk, int causal,
                    float sm_scale, int diag_offset) {
  using Tiles = TcTiles<D>;
  constexpr int BK = Tiles::kDkvKeys;
  constexpr int BQ = Tiles::kDkvRows;
  using KTile = SwizzledTile<D, BK>;
  using QTile = SwizzledTile<D, BQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);     // KTile
  unsigned char* vs = ks + KTile::kBytes;       // KTile
  unsigned char* qs = vs + KTile::kBytes;       // [2] QTile
  unsigned char* dos = qs + 2 * QTile::kBytes;  // [2] QTile
  float* lses = reinterpret_cast<float*>(dos + 2 * QTile::kBytes);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                                    // [2][BQ]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = warp / 4;      // warpgroup: keys group * 64 ..
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // key tile 0, the heaviest, goes first
  const bf16* qg = q + (size_t)bh * lq * D;
  const bf16* dog = dout + (size_t)bh * lq * D;
  const float* lseg = lse + (size_t)bh * lq;
  const float* deltag = delta + (size_t)bh * lq;
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs);
  const uint32_t qs_u = smem_u32(qs), dos_u = smem_u32(dos);

  load_tile_async<D, BK>(ks_u, k + (size_t)bh * lk * D, k0, lk);
  load_tile_async<D, BK>(vs_u, v + (size_t)bh * lk * D, k0, lk);

  // the q tiles this key tile needs: a row sees key k0 only from
  // k0 - diag_offset on, so the tiles before the one holding that row are
  // skipped
  const int n_tiles = (lq + BQ - 1) / BQ;
  int t_begin = 0;
  if (causal && k0 - diag_offset > 0) t_begin = (k0 - diag_offset) / BQ;

  auto load_step = [&](int t, int stage) {
    const int q0 = t * BQ;
    load_tile_async<D, BQ>(qs_u + stage * QTile::kBytes, qg, q0, lq);
    load_tile_async<D, BQ>(dos_u + stage * QTile::kBytes, dog, q0, lq);
    for (int i = threadIdx.x; i < 2 * BQ; i += blockDim.x) {
      const int row = q0 + i % BQ;
      const bool valid = row < lq;
      const float* src = (i < BQ ? lseg : deltag) + (valid ? row : 0);
      float* dst = (i < BQ ? lses : deltas) + stage * BQ + i % BQ;
      cp_async_4(smem_u32(dst), src, valid);
    }
  };
  if (t_begin < n_tiles) load_step(t_begin, 0);
  cp_async_commit();  // K, V and the first step

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.0f;

  const float scale_log2 = sm_scale * kLog2e;
  const int group_key = k0 + group * 64;    // first key of this warpgroup
  const int warp_key = k0 + warp * 16;      // first key of this warp
  const int key_a = warp_key + lane / 4;    // this thread's keys: key_a
                                            // and key_a + 8
  for (int t = t_begin; t < n_tiles; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < n_tiles) load_step(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the step just issued has landed
    fence_async_shared();
    __syncthreads();

    const int q0 = t * BQ;
    bool visible = group_key < lk;
    if (causal) visible = visible && group_key <= q0 + BQ - 1 + diag_offset;
    if (visible) {
      const uint32_t q_tile = qs_u + stage * QTile::kBytes;
      const uint32_t do_tile = dos_u + stage * QTile::kBytes;
      const int stats = stage * BQ;  // this step's LSE and delta

      // S^T = K q^T and dP^T = V dO^T: 64 keys x BQ rows a warpgroup
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      fence_operands<BQ / 8>(s);
      fence_operands<BQ / 8>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, KTile::k_major(ks_u, group * 64, kk),
                     QTile::k_major(q_tile, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, KTile::k_major(vs_u, group * 64, kk),
                     QTile::k_major(do_tile, 0, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<BQ / 8>(s);
      fence_operands<BQ / 8>(dp);

      // no element of this warp's 16 x BQ tile is masked
      const bool full = q0 + BQ <= lq && warp_key + 16 <= lk &&
                        (!causal || warp_key + 15 <= q0 + diag_offset);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float lse_log2[2] = {lses[stats + col] * kLog2e,
                                   lses[stats + col + 1] * kLog2e};
        const float row_delta[2] = {deltas[stats + col],
                                    deltas[stats + col + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -lse_log2[c]));
          if (!full) {
            const int key = key_a + (e >> 1) * 8;
            const int row = q0 + col + c;
            bool keep = row < lq && key < lk;
            if (causal) keep = keep && key <= row + diag_offset;
            p = keep ? p : 0.0f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - row_delta[c]);
        }
      }

      // dV += P^T dO and dK += dS^T q, P^T and dS^T from registers, dO
      // and q read transposed from the same tiles
      uint32_t p_frag[BQ / 16][4], ds_frag[BQ / 16][4];
      to_a_fragments<BQ>(s, p_frag);
      to_a_fragments<BQ>(dp, ds_frag);
      fence_operands<BQ / 16>(p_frag);
      fence_operands<BQ / 16>(ds_frag);
      fence_operands<D / 8>(acc_dv);
      fence_operands<D / 8>(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_t<D>(acc_dv, p_frag[kk], QTile::mn_major(do_tile, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_t<D>(acc_dk, ds_frag[kk], QTile::mn_major(q_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<D / 8>(acc_dv);
      fence_operands<D / 8>(acc_dk);
      fence_operands<BQ / 16>(p_frag);
      fence_operands<BQ / 16>(ds_frag);
    }
    __syncthreads();  // this stage may be refilled by the next step
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK = sm_scale * sum dS^T q; K's and V's tiles become the staging
  stage_rows<D, BK>(ks, acc_dk, warp * 16 + lane / 4, sm_scale, lane);
  stage_rows<D, BK>(vs, acc_dv, warp * 16 + lane / 4, 1.0f, lane);
  __syncthreads();
  store_rows<D, BK>(dk + (size_t)bh * lk * D, ks, k0, lk);
  store_rows<D, BK>(dv + (size_t)bh * lk * D, vs, k0, lk);
}

template <int D>
__global__ void __launch_bounds__(TcTiles<D>::kDqThreads,
                                  TcTiles<D>::kDqBlocksPerSm)
flash_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int lq, int lk, int causal, float sm_scale,
                   int diag_offset) {
  using Tiles = TcTiles<D>;
  constexpr int BQ = Tiles::kDqRows;
  constexpr int BK = Tiles::kDqKeys;
  using QTile = SwizzledTile<D, BQ>;
  using KTile = SwizzledTile<D, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);   // QTile
  unsigned char* dos = qs + QTile::kBytes;    // QTile
  unsigned char* ks = dos + QTile::kBytes;    // [2] KTile
  unsigned char* vs = ks + 2 * KTile::kBytes; // [2] KTile

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = warp / 4;      // warpgroup: rows group * 64 ..
  const int bh = blockIdx.x;
  // the last q tile, the heaviest when causal, goes first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* kg = k + (size_t)bh * lk * D;
  const bf16* vg = v + (size_t)bh * lk * D;
  const uint32_t qs_u = smem_u32(qs), dos_u = smem_u32(dos);
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs);

  load_tile_async<D, BQ>(qs_u, q + (size_t)bh * lq * D, q0, lq);
  load_tile_async<D, BQ>(dos_u, dout + (size_t)bh * lq * D, q0, lq);

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
  cp_async_commit();  // q, dO and the first step

  const int group_row = q0 + group * 64;  // first row of this warpgroup
  const int warp_row = q0 + warp * 16;    // first row of this warp
  const int row_a = warp_row + lane / 4;  // this thread's rows: row_a and
  float lse_log2[2], row_delta[2];        // row_a + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    lse_log2[h] = row < lq ? lse[(size_t)bh * lq + row] * kLog2e : 0.0f;
    row_delta[h] = row < lq ? delta[(size_t)bh * lq + row] : 0.0f;
  }

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
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();

    const int k0 = t * BK;
    bool visible = group_row < lq;
    if (causal) visible = visible && k0 <= group_row + 63 + diag_offset;
    if (visible) {
      const uint32_t k_tile = ks_u + stage * KTile::kBytes;
      const uint32_t v_tile = vs_u + stage * KTile::kBytes;

      // S = q K^T and dP = dO V^T: 64 rows x BK keys a warpgroup
      float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      fence_operands<BK / 8>(s);
      fence_operands<BK / 8>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s, QTile::k_major(qs_u, group * 64, kk),
                     KTile::k_major(k_tile, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, QTile::k_major(dos_u, group * 64, kk),
                     KTile::k_major(v_tile, 0, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<BK / 8>(s);
      fence_operands<BK / 8>(dp);

      const bool full = warp_row + 16 <= lq && k0 + BK <= lk &&
                        (!causal || k0 + BK - 1 <= warp_row + diag_offset);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -lse_log2[h]));
          if (!full) {
            const int row = row_a + 8 * h;
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            bool keep = row < lq && key < lk;
            if (causal) keep = keep && key <= row + diag_offset;
            p = keep ? p : 0.0f;
          }
          dp[j][e] = p * (dp[j][e] - row_delta[h]);
        }
      }

      // dQ += dS K, dS from registers, K read transposed
      uint32_t ds_frag[BK / 16][4];
      to_a_fragments<BK>(dp, ds_frag);
      fence_operands<BK / 16>(ds_frag);
      fence_operands<D / 8>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_t<D>(acc, ds_frag[kk], KTile::mn_major(k_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<D / 8>(acc);
      fence_operands<BK / 16>(ds_frag);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // dQ = sm_scale * sum dS K; q's tile becomes the staging
  stage_rows<D, BQ>(qs, acc, warp * 16 + lane / 4, sm_scale, lane);
  __syncthreads();
  store_rows<D, BQ>(dq + (size_t)bh * lq * D, qs, q0, lq);
}

// ---------------------------------------------------------------------------
// launchers and the C interface
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch_heads, int lq, int lk, int causal,
                      float sm_scale, int diag_offset, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    using Tiles = TcTiles<D>;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
        !aligned16(dq))
      return cudaErrorMisalignedAddress;
    cudaError_t error = allow_smem(flash_dq_kernel_tc<D>, Tiles::kDqSmem);
    if (error != cudaSuccess) return error;
    dim3 grid(batch_heads, (lq + Tiles::kDqRows - 1) / Tiles::kDqRows);
    flash_dq_kernel_tc<D>
        <<<grid, Tiles::kDqThreads, Tiles::kDqSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), lq, lk, causal, sm_scale,
        diag_offset);
  } else {
    const size_t smem =
        sizeof(float) * (2 * kBlockQ * (D + 1) + 2 * kBlockK * (D + 1) +
                         kBlockQ * kStrideP);
    cudaError_t error = allow_smem(flash_dq_kernel<D>, smem);
    if (error != cudaSuccess) return error;
    dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch_heads);
    flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), lq, lk, causal, sm_scale,
        diag_offset);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv,
                       int batch_heads, int lq, int lk, int causal,
                       float sm_scale, int diag_offset, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    using Tiles = TcTiles<D>;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
        !aligned16(dk) || !aligned16(dv))
      return cudaErrorMisalignedAddress;
    cudaError_t error = allow_smem(flash_dkv_kernel_tc<D>, Tiles::kDkvSmem);
    if (error != cudaSuccess) return error;
    dim3 grid(batch_heads, (lk + Tiles::kDkvKeys - 1) / Tiles::kDkvKeys);
    flash_dkv_kernel_tc<D>
        <<<grid, Tiles::kDkvThreads, Tiles::kDkvSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lq, lk,
        causal, sm_scale, diag_offset);
  } else {
    const size_t smem =
        sizeof(float) * (2 * kBlockK * (D + 1) + 2 * kBlockQ * (D + 1) +
                         2 * kBlockK * kStrideP + 2 * kBlockQ);
    cudaError_t error = allow_smem(flash_dkv_kernel<D>, smem);
    if (error != cudaSuccess) return error;
    dim3 grid((lk + kBlockK - 1) / kBlockK, batch_heads);
    flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), lq, lk,
        causal, sm_scale, diag_offset);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  diag_offset is q_offset + (Lk - Lq)
// when causal (ignored otherwise).  bfloat16 tensors must start on a
// 16-byte boundary.  Each returns the launch's cudaError_t.
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
