// Building blocks shared by the port's Hopper (sm_90a) kernels: cp.async
// copies, warpgroup MMAs (wgmma) and their fences, the swizzled
// shared-memory tiles wgmma's descriptors read, and the conversions between
// accumulator and operand fragments.  Included by flash_attention.cu and
// flash_attention_backward.cu; each source is built into a library of its
// own, so the helpers live in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory written by the threads (cp.async) made visible to the
// async proxy that wgmma reads it through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving other reads or writes of these registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[j][e])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[j][e])::"memory");
}

// d (64 x N f32, the warpgroup's accumulator) += A . B, m64nNk16 bf16:
//   wgmma_ss:   A (64 x 16) and B (16 x N) both K-major in shared memory;
//   wgmma_rs_t: A (64 x 16) in registers, B MN-major (read transposed).
// Each of the 4 warps holds 16 rows of d: d[j][0..1] at (row g, cols
// 8j + 2t, +1), d[j][2..3] at row g + 8 (lane = 4 g + t), and A likewise:
// a[0] (g, 2t..), a[1] (g+8, 2t..), a[2] (g, 2t+8..), a[3] (g+8, 2t+8..).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4],
                                         uint64_t desc_a, uint64_t desc_b);
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float (&d)[2][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4],
                                            uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<32>(float (&d)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4],
                                            uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// 2^x in one SFU instruction (relative error about 2^-22, far below the
// bf16 rounding that P and dS take next; exp2f adds range handling)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulators of column tiles 2kk and 2kk+1, rounded to bf16, are the
// A fragment of k-step kk (the layouts above).
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&acc)[N / 8][4],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// A ROWS x D bf16 tile in shared memory as wgmma's descriptors read it:
// column blocks of W = min(D, 64) elements (two at D = 128), each ROWS x W
// row-major in rows of 2W bytes, with the hardware swizzle of that width
// (128, 64 or 32 bytes: address bits 4.. XOR bits 7..).  The same bytes
// serve as a K-major operand (rows are M or N) and as an MN-major one
// (rows are K).  Tiles start on 1024-byte boundaries.
template <int D, int ROWS>
struct SwizzledTile {
  static constexpr int W = D < 64 ? D : 64;
  static constexpr uint32_t kBlockBytes = ROWS * W * 2;
  static constexpr uint32_t kBytes = ROWS * D * 2;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
  static constexpr uint32_t kGroupBytes = 8 * W * 2;  // 8 rows

  // byte offset of element (row, col)
  __device__ static uint32_t offset(int row, int col) {
    const uint32_t o = row * (W * 2) + (col % W) * 2;
    return (col / W) * kBlockBytes + (o ^ (((o >> 7) & (W / 8 - 1)) << 4));
  }
  // leading byte offset: between the column blocks; stride byte offset:
  // between groups of 8 rows
  __device__ static uint64_t descriptor(uint32_t address, uint32_t lbo) {
    return ((address & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(kGroupBytes >> 4) << 32) | (kLayout << 62);
  }
  // K-major operand: rows from row0 on, the 16 columns of k-step kk
  __device__ static uint64_t k_major(uint32_t base, int row0, int kk) {
    const int col = kk * 16;
    return descriptor(base + (col / W) * kBlockBytes + row0 * W * 2 +
                          (col % W) * 2,
                      16);
  }
  // MN-major operand: the 16 rows of k-step kk, all D columns
  __device__ static uint64_t mn_major(uint32_t base, int kk) {
    return descriptor(base + kk * 16 * W * 2, kBlockBytes);
  }
};

// rows [row0, row0 + ROWS) of a (length, D) bf16 matrix into a swizzled
// tile, asynchronously; rows past `length` are zero
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t tile,
                                                const bf16* src, int row0,
                                                int length) {
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += blockDim.x) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int r = row0 + row;
    const bool valid = r < length;
    cp_async_16(tile + SwizzledTile<D, ROWS>::offset(row, col),
                src + (size_t)(valid ? r : 0) * D + col, valid);
  }
}

// a warp's 16 x D float accumulators (tile rows `row` and `row` + 8)
// times `scale`, rounded to bf16 into a swizzled tile
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&acc)[D / 8][4],
                                           int row, float scale, int lane) {
  using Tile = SwizzledTile<D, ROWS>;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + Tile::offset(row, col)) =
        pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(tile + Tile::offset(row + 8, col)) =
        pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// a swizzled tile's rows to rows [row0, ...) of a (length, D) matrix, 16
// bytes per thread; rows past `length` are not written
template <int D, int ROWS>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const unsigned char* tile,
                                           int row0, int length) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += blockDim.x) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    if (row0 + row < length)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + row) * D + col) =
          *reinterpret_cast<const uint4*>(
              tile + SwizzledTile<D, ROWS>::offset(row, col));
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// launch helpers and the dtype / head-size dispatch of the C entry points
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* pointer) {
  return (reinterpret_cast<uintptr_t>(pointer) & 15) == 0;
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
  if (dtype == 1) return by_dim(TypeTag<bf16>{});
  return cudaErrorInvalidValue;
}

cudaError_t check_sizes(int batch_heads, int lq, int lk) {
  if (batch_heads <= 0 || lq <= 0 || lk <= 0) return cudaErrorInvalidValue;
  if (batch_heads > 65535) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace
