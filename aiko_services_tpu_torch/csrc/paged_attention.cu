// Paged GQA decode attention for Hopper (sm_90a), with a plain C interface:
// K4.
//
// Replaces no TPU kernel.  The JAX package runs the paged decode step's
// attention (aiko_services_tpu/models/transformer.py::_paged_window) as
// a masked einsum over every slot's whole block table; the port's
// gather path (models/transformer.py::paged_gather_attention), K4's
// plain version, does the same: it gathers each slot's MB * bs
// positions, expands the KV heads to the query heads and casts K to f32
// before the two products.  K4
// computes the same function from the pool in place:
//
//   out[s,h,w,:] = softmax_j(q[s,h,w,:] . k_j * sm_scale) @ V,  over the
//                  keys j < min(positions[s] + w + 1, MB * bs) of slot s,
//                  key j at (tables[s, j / bs], j % bs) of KV head
//                  h / (H / H_kv) in the pool,
//
// the reference's mask (k_pos > q_pos), keys past the table dropped.
//
// Inputs: q (S, H, W, D) bf16 after rotary; one layer's K and V pools,
// each (num_blocks, H_kv, bs, D) bf16, read where they lie; tables
// (S, MB) and positions (S,) int32 on the device (read by the kernel,
// never by the host, so the launch can be captured in a CUDA graph).
// Output (S, H, W, D) bf16.  D in {16, 32, 64, 128} (K1's), any bs,
// W <= 16, H a multiple of H_kv; all contiguous.
//
// Bound on an H100 SXM: the bytes.  A decoding slot needs its live keys
// once: 2 * H_kv * D * 2 bytes a position a layer (4 KB for Mistral-7B),
// against 4 * (H / H_kv) * W * D operations a position a KV head: about
// one operation a byte at W = 1, far below the 295 the card can do per
// byte.  At the mistral_7b.serve_chat step (64 slots, 44 of them decoding
// at ~1,500 positions) that is ~0.27 GB a layer, ~80 us at 3.35 TB/s.
// The gather path instead writes and reads again the whole table
// expanded to 32 heads (and K to f32) whatever the slots hold.
//
// Design.  Grid (split, KV head x row chunk, slot).  A split is a fixed
// run of kSplitKeys = 512 positions; a CTA whose split starts past its
// slot's last visible key exits at once, so the work follows the live
// lengths and the grid follows only S, H_kv and MB.  A CTA serves every
// query row of its KV head -- the H / H_kv heads times the W window
// rows, up to 32 rows, more rows taking more row chunks; its layouts are
// compiled for 4, 8, 16 and 32 rows and it takes the fewest that hold
// them -- so each K/V position is read from device memory once for all
// of them.  K and V
// stream through shared memory in tiles of 64 positions, 16-byte
// cp.async copies per (position, 8 columns), two stages: the next tile's
// copy is in flight while this one is computed; positions past the
// CTA's last visible key are zero-filled, not read.  The CTA reads its
// slice of the block table once into shared memory.  Per tile, on the
// CUDA cores (one operation a byte leaves the tensor cores nothing to
// do): scores q.k from bf16 operands with products and sums in f32, in
// a fixed order over D, times sm_scale; masked keys are -inf; the online
// softmax in f32 (running max m, sum l, a warp per row, the sum over the
// tile's keys in a fixed butterfly); acc = acc * alpha + sum_j p_j v_j
// in f32, P kept in f32 (the reference rounds its normalised weights to
// bf16 before P.V; the difference is at most 2^-9 of each weight).  Each
// split leaves (m, l, acc) in f32 scratch; a second small launch merges
// a row's splits in split order, divides by l and rounds once to bf16.
// No float atomics: every row's arithmetic is fixed by its own keys, so
// a row's result does not depend on W, on the other rows or slots, or
// on the run -- a verify window's rows equal the decode step's.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;
constexpr int kSplitKeys = 512;
constexpr int kMaxRows = 32;                  // query rows a CTA serves
constexpr int kStages = 2;
constexpr int kScorePitch = kTileKeys + 1;    // floats a score row
constexpr int kMaxWindow = 16;

// a CTA of ROWS query rows (4, 8, 16 or 32: the fewest that hold its KV
// head's rows), so that no thread of the layouts below idles on rows
// that do not exist
template <int D, int ROWS>
struct PagedTiles {
  static constexpr int kPitch = D + 8;        // bf16 a staged K/V row
  static constexpr int kChunks = D / 8;       // 16-byte chunks a row
  static constexpr int kTileElems = kTileKeys * kPitch;
  // the P.V layout: a thread owns kCols columns of kRowsEach rows (2
  // columns at 4 rows, so that every thread of a D = 128 CTA has a row)
  static constexpr int kCols = ROWS >= 8 ? 4 : 2;
  static constexpr int kColGroups = D / kCols;
  static constexpr int kRowGroups = kThreads / kColGroups;
  static constexpr int kRowsEach = (ROWS + kRowGroups - 1) / kRowGroups;
  // the q.k layout: a thread owns one key of kQkRowsEach rows
  static constexpr int kQkRowGroups = kThreads / kTileKeys;
  static constexpr int kQkRowsEach = ROWS / kQkRowGroups;

  static size_t smem_bytes(int table_entries) {
    return sizeof(bf16) * (kStages * 2 * kTileElems + ROWS * D) +
           sizeof(float) * (ROWS * kScorePitch + 3 * ROWS) +
           sizeof(int) * table_entries;
  }
};

// the CTA's rows for a KV head's rows
int cta_rows(int group_rows) {
  return group_rows <= 4 ? 4 : group_rows <= 8 ? 8 : group_rows <= 16 ? 16
                                                                      : 32;
}

// the bf16 pairs packed in 32-bit words as f32, exactly (a bf16 is the
// top half of an f32), without taking the words' address
template <int N>
__device__ __forceinline__ void widen(const uint32_t (&words)[N],
                                      float (&out)[2 * N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    out[2 * e] = __uint_as_float(words[e] << 16);
    out[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
  }
}

// positions of keys row `w` of a slot at `position` sees: at least one,
// at most the table's capacity
__device__ __forceinline__ int visible_keys(int position, int w,
                                            int capacity) {
  return min(max(position + w + 1, 1), capacity);
}

// one tile of K and V (keys tile0 ...) into a stage: 16 bytes a thread a
// copy, each key looked up in the CTA's slice of the block table; keys
// at or past key_stop zero-filled, not read
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(
    bf16* k_tile, bf16* v_tile, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* table, int first_block,
    int tile0, int key_stop, int kv_heads, int kv_head, int block_size) {
  using Tiles = PagedTiles<D, ROWS>;
  for (int c = threadIdx.x; c < kTileKeys * Tiles::kChunks; c += kThreads) {
    const int key = c / Tiles::kChunks;
    const int part = c % Tiles::kChunks;
    const int at = tile0 + key;
    const bool valid = at < key_stop;
    size_t offset = 0;
    if (valid) {
      const int block = table[at / block_size - first_block];
      offset = (((size_t)block * kv_heads + kv_head) * block_size +
                at % block_size) * D + part * 8;
    }
    const int dst = key * Tiles::kPitch + part * 8;
    cp_async_16(smem_u32(k_tile + dst), k_pool + offset, valid);
    cp_async_16(smem_u32(v_tile + dst), v_pool + offset, valid);
  }
}

// at least three CTAs an SM (85 registers a thread): left to itself,
// ptxas squeezes some D = 64 variants into 48 registers and spills
template <int D, int ROWS>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int heads, int kv_heads, int window,
    int max_blocks, int block_size, int row_chunks, int splits,
    float sm_scale) {
  using Tiles = PagedTiles<D, ROWS>;
  const int split = blockIdx.x;
  const int kv_head = blockIdx.y / row_chunks;
  const int chunk = blockIdx.y % row_chunks;
  const int slot = blockIdx.z;
  const int group = heads / kv_heads;
  const int row0 = chunk * ROWS;
  const int rows = min(ROWS, group * window - row0);
  const int capacity = max_blocks * block_size;
  const int position = positions[slot];
  const int key0 = split * kSplitKeys;
  const int key_stop =
      min(key0 + kSplitKeys, visible_keys(position, window - 1, capacity));
  if (key0 >= key_stop) return;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* qs = stages + kStages * 2 * Tiles::kTileElems;
  float* scores = reinterpret_cast<float*>(qs + ROWS * D);
  float* alpha_s = scores + ROWS * kScorePitch;
  float* m_s = alpha_s + ROWS;
  float* l_s = m_s + ROWS;
  int* table = reinterpret_cast<int*>(l_s + ROWS);

  // the rows' first index in (S * H * W): rows of one KV head are
  // contiguous in q, (group heads) x (window rows)
  const size_t row_base =
      ((size_t)slot * heads + (size_t)kv_head * group) * window + row0;
  const int first_block = key0 / block_size;
  const int table_entries = (key_stop - 1) / block_size - first_block + 1;
  for (int i = tid; i < table_entries; i += kThreads)
    table[i] = tables[(size_t)slot * max_blocks + first_block + i];
  for (int c = tid; c < rows * Tiles::kChunks; c += kThreads)
    reinterpret_cast<uint4*>(qs)[c] =
        reinterpret_cast<const uint4*>(q + row_base * D)[c];
  if (tid < ROWS) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  float acc[Tiles::kRowsEach][Tiles::kCols];
#pragma unroll
  for (int i = 0; i < Tiles::kRowsEach; ++i)
#pragma unroll
    for (int c = 0; c < Tiles::kCols; ++c) acc[i][c] = 0.0f;

  const int tiles = (key_stop - key0 + kTileKeys - 1) / kTileKeys;
  // stage s: K at stages + 2 s kTileElems, V after it
  load_tile<D, ROWS>(stages, stages + Tiles::kTileElems, k_pool, v_pool, table,
               first_block, key0, key_stop, kv_heads, kv_head, block_size);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      bf16* next = stages + ((tile + 1) % kStages) * 2 * Tiles::kTileElems;
      load_tile<D, ROWS>(next, next + Tiles::kTileElems, k_pool, v_pool, table,
                   first_block, key0 + (tile + 1) * kTileKeys, key_stop,
                   kv_heads, kv_head, block_size);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_tile = stages + (tile % kStages) * 2 * Tiles::kTileElems;
    const bf16* v_tile = k_tile + Tiles::kTileElems;
    const int tile0 = key0 + tile * kTileKeys;

    // scores: thread (key, row group) over D in order, f32 products
    {
      const int key = tid % kTileKeys;
      const int rgroup = tid / kTileKeys;
      float dot[Tiles::kQkRowsEach];
#pragma unroll
      for (int i = 0; i < Tiles::kQkRowsEach; ++i) dot[i] = 0.0f;
#pragma unroll
      for (int part = 0; part < Tiles::kChunks; ++part) {
        const uint4 kk = *reinterpret_cast<const uint4*>(
            k_tile + key * Tiles::kPitch + part * 8);
        float kf[8];
        widen<4>({kk.x, kk.y, kk.z, kk.w}, kf);
#pragma unroll
        for (int i = 0; i < Tiles::kQkRowsEach; ++i) {
          const int r = rgroup + i * Tiles::kQkRowGroups;
          if (r < rows) {
            const uint4 qq = *reinterpret_cast<const uint4*>(
                qs + r * D + part * 8);
            float qf[8];
            widen<4>({qq.x, qq.y, qq.z, qq.w}, qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) dot[i] = fmaf(qf[e], kf[e], dot[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < Tiles::kQkRowsEach; ++i) {
        const int r = rgroup + i * Tiles::kQkRowGroups;
        if (r < rows) {
          const int w = (row0 + r) % window;
          const bool visible =
              tile0 + key < visible_keys(position, w, capacity);
          scores[r * kScorePitch + key] =
              visible ? dot[i] * sm_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: a warp a row, two keys a lane
    for (int r = warp; r < rows; r += kWarps) {
      float* row = scores + r * kScorePitch;
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      float top = fmaxf(s0, s1);
#pragma unroll
      for (int width = 16; width > 0; width /= 2)
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, width));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, top);
      // a row with no visible key yet keeps m = -inf, p = 0, alpha = 1
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = expf(s0 - m_use);
      const float p1 = expf(s1 - m_use);
      float sum = p0 + p1;
#pragma unroll
      for (int width = 16; width > 0; width /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, width);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.0f : expf(m_old - m_use);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread (kCols columns, row group), keys
    // in order; keys past key_stop hold p = 0 and zero-filled V
    {
      const int col = (tid % Tiles::kColGroups) * Tiles::kCols;
      const int rgroup = tid / Tiles::kColGroups;
      const int keys = min(kTileKeys, key_stop - tile0);
#pragma unroll
      for (int i = 0; i < Tiles::kRowsEach; ++i) {
        const int r = rgroup + i * Tiles::kRowGroups;
        if (r < rows) {
          const float alpha = alpha_s[r];
#pragma unroll
          for (int c = 0; c < Tiles::kCols; ++c) acc[i][c] *= alpha;
        }
      }
#pragma unroll 4
      for (int key = 0; key < (rgroup < rows ? keys : 0); ++key) {
        const bf16* at = v_tile + key * Tiles::kPitch + col;
        float vf[Tiles::kCols];
        if constexpr (Tiles::kCols == 4) {
          const uint2 vv = *reinterpret_cast<const uint2*>(at);
          widen<2>({vv.x, vv.y}, vf);
        } else {
          widen<1>({*reinterpret_cast<const uint32_t*>(at)}, vf);
        }
#pragma unroll
        for (int i = 0; i < Tiles::kRowsEach; ++i) {
          const int r = rgroup + i * Tiles::kRowGroups;
          if (r < rows) {
            const float p = scores[r * kScorePitch + key];
#pragma unroll
            for (int c = 0; c < Tiles::kCols; ++c)
              acc[i][c] = fmaf(p, vf[c], acc[i][c]);
          }
        }
      }
    }
    __syncthreads();  // this stage and the scores may be refilled
  }
  cp_async_wait<0>();

  // the split's (m, l, acc) of every row that sees a key here
  {
    const int col = (tid % Tiles::kColGroups) * Tiles::kCols;
    const int rgroup = tid / Tiles::kColGroups;
#pragma unroll
    for (int i = 0; i < Tiles::kRowsEach; ++i) {
      const int r = rgroup + i * Tiles::kRowGroups;
      if (r < rows &&
          visible_keys(position, (row0 + r) % window, capacity) > key0) {
        const size_t at = (row_base + r) * splits + split;
#pragma unroll
        for (int c = 0; c < Tiles::kCols; ++c)
          part_acc[at * D + col + c] = acc[i][c];
        if (col == 0) {
          part_ml[at * 2] = m_s[r];
          part_ml[at * 2 + 1] = l_s[r];
        }
      }
    }
  }
}

// a row's splits merged in split order, divided by l, rounded once to
// bf16: 4 columns a thread, kThreads / (D / 4) rows a CTA
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             const int* __restrict__ positions,
                             bf16* __restrict__ out, int total_rows,
                             int heads, int window, int capacity,
                             int splits) {
  constexpr int kColGroups = D / 4;
  const int row = blockIdx.x * (kThreads / kColGroups) +
                  threadIdx.x / kColGroups;
  if (row >= total_rows) return;
  const int col = (threadIdx.x % kColGroups) * 4;
  const int slot = row / (heads * window);
  const int keys = visible_keys(positions[slot], row % window, capacity);
  const int used = (keys + kSplitKeys - 1) / kSplitKeys;
  const float* ml = part_ml + (size_t)row * splits * 2;
  const float* acc = part_acc + (size_t)row * splits * D + col;
  float top = -INFINITY;
  for (int p = 0; p < used; ++p) top = fmaxf(top, ml[p * 2]);
  float l = 0.0f;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = 0; p < used; ++p) {
    const float scale = expf(ml[p * 2] - top);
    l = fmaf(ml[p * 2 + 1], scale, l);
    const float4 part = *reinterpret_cast<const float4*>(acc + (size_t)p * D);
    sum[0] = fmaf(part.x, scale, sum[0]);
    sum[1] = fmaf(part.y, scale, sum[1]);
    sum[2] = fmaf(part.z, scale, sum[2]);
    sum[3] = fmaf(part.w, scale, sum[3]);
  }
  const float inv = 1.0f / l;
  bf16* dst = out + (size_t)row * D + col;
  uint2 packed;
  packed.x = pack_bf16(sum[0] * inv, sum[1] * inv);
  packed.y = pack_bf16(sum[2] * inv, sum[3] * inv);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <int D, int ROWS>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const int* tables,
                         const int* positions, float* part_ml,
                         float* part_acc, int slots, int heads,
                         int kv_heads, int window, int max_blocks,
                         int block_size, int splits, float sm_scale,
                         cudaStream_t stream) {
  const int row_chunks = ((heads / kv_heads) * window + ROWS - 1) / ROWS;
  const int table_entries = kSplitKeys / block_size + 2;
  const size_t smem = PagedTiles<D, ROWS>::smem_bytes(table_entries);
  cudaError_t error =
      allow_smem(paged_attention_split_kernel<D, ROWS>, smem);
  if (error != cudaSuccess) return error;
  dim3 grid(splits, kv_heads * row_chunks, slots);
  paged_attention_split_kernel<D, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), tables, positions, part_ml,
      part_acc, heads, kv_heads, window, max_blocks, block_size, row_chunks,
      splits, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_merge(const float* part_ml, const float* part_acc,
                         const int* positions, void* out, int slots,
                         int heads, int window, int capacity, int splits,
                         cudaStream_t stream) {
  const int total_rows = slots * heads * window;
  const int rows_per_cta = kThreads / (D / 4);
  const int ctas = (total_rows + rows_per_cta - 1) / rows_per_cta;
  paged_attention_merge_kernel<D><<<ctas, kThreads, 0, stream>>>(
      part_ml, part_acc, positions, static_cast<bf16*>(out), total_rows,
      heads, window, capacity, splits);
  return cudaGetLastError();
}

cudaError_t check_shapes(int slots, int heads, int kv_heads, int window,
                         int head_dim, int max_blocks, int block_size,
                         int splits) {
  if (slots <= 0 || heads <= 0 || kv_heads <= 0 || window <= 0 ||
      max_blocks <= 0 || block_size <= 0 || heads % kv_heads != 0 ||
      window > kMaxWindow ||
      (head_dim != 16 && head_dim != 32 && head_dim != 64 &&
       head_dim != 128))
    return cudaErrorInvalidValue;
  if ((long long)max_blocks * block_size > (1LL << 30) ||
      splits != (max_blocks * block_size + kSplitKeys - 1) / kSplitKeys)
    return cudaErrorInvalidValue;
  const int group_rows = (heads / kv_heads) * window;
  const int rows = cta_rows(group_rows);
  const int row_chunks = (group_rows + rows - 1) / rows;
  if (slots > 65535 || (long long)kv_heads * row_chunks > 65535)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace

// K4's first launch: every split's (m, l, acc) of every query row into
// part_ml (S * H * W, splits, 2) and part_acc (S * H * W, splits, D), f32.
// splits = ceil(max_blocks * block_size / 512).  q, the pools and the
// scratch must start on a 16-byte boundary.  Returns the launch's
// cudaError_t.
extern "C" int aiko_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* part_ml,
    void* part_acc, int slots, int heads, int kv_heads, int window,
    int head_dim, int max_blocks, int block_size, int splits,
    float sm_scale, void* stream) {
  cudaError_t error = check_shapes(slots, heads, kv_heads, window, head_dim,
                                   max_blocks, block_size, splits);
  if (error != cudaSuccess) return error;
  if (!aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool) ||
      !aligned16(part_acc))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table_ptr = static_cast<const int*>(tables);
  const int* position_ptr = static_cast<const int*>(positions);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  auto launch = [&](auto dim, auto rows) {
    return launch_split<decltype(dim)::value, decltype(rows)::value>(
        q, k_pool, v_pool, table_ptr, position_ptr, ml, acc, slots, heads,
        kv_heads, window, max_blocks, block_size, splits, sm_scale, s);
  };
  auto by_rows = [&](auto dim) {
    switch (cta_rows((heads / kv_heads) * window)) {
      case 4: return launch(dim, std::integral_constant<int, 4>{});
      case 8: return launch(dim, std::integral_constant<int, 8>{});
      case 16: return launch(dim, std::integral_constant<int, 16>{});
      default: return launch(dim, std::integral_constant<int, kMaxRows>{});
    }
  };
  switch (head_dim) {
    case 16: return by_rows(std::integral_constant<int, 16>{});
    case 32: return by_rows(std::integral_constant<int, 32>{});
    case 64: return by_rows(std::integral_constant<int, 64>{});
    default: return by_rows(std::integral_constant<int, 128>{});
  }
}

// K4's second launch: each row's splits merged into out (S, H, W, D) bf16,
// which must start on an 8-byte boundary.  Returns the launch's
// cudaError_t.
extern "C" int aiko_paged_decode_attention_merge(
    const void* part_ml, const void* part_acc, const void* positions,
    void* out, int slots, int heads, int kv_heads, int window, int head_dim,
    int max_blocks, int block_size, int splits, void* stream) {
  cudaError_t error = check_shapes(slots, heads, kv_heads, window, head_dim,
                                   max_blocks, block_size, splits);
  if (error != cudaSuccess) return error;
  if (!aligned16(part_acc) || (reinterpret_cast<uintptr_t>(out) & 7))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ml = static_cast<const float*>(part_ml);
  const float* acc = static_cast<const float*>(part_acc);
  const int* position_ptr = static_cast<const int*>(positions);
  const int capacity = max_blocks * block_size;
  auto merge = [&](auto dim) {
    return launch_merge<decltype(dim)::value>(
        ml, acc, position_ptr, out, slots, heads, window, capacity, splits,
        s);
  };
  switch (head_dim) {
    case 16: return merge(std::integral_constant<int, 16>{});
    case 32: return merge(std::integral_constant<int, 32>{});
    case 64: return merge(std::integral_constant<int, 64>{});
    default: return merge(std::integral_constant<int, 128>{});
  }
}
