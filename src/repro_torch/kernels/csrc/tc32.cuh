// Hopper (sm_90a) building blocks shared by the SLA kernels at 32 x 32
// blocks on warp-level mma.sync (sla_fwd_tc32.cu, sla_bwd_tc32.cu):
// cp.async staging of 32 x D bf16 tiles into shared rows padded by 16 bytes
// (so that ldmatrix reads them free of bank conflicts), the ldmatrix
// fragment addresses of an A operand and of a B operand stored [n][k] or
// [k][n], the m16n8k16 bf16 product with f32 accumulators, a 16 x 32 score
// fragment, its repacking into bf16 A fragments, and the 16 x D product
// that consumes them.
//
// Every kernel built on them runs two warps (64 threads) per CTA, each
// owning 16 rows of a 32-row output tile, at head dims 64 and 128 (the
// wrappers zero-pad narrower heads). kernels/_build.py hashes this header
// with each source, so an edited header rebuilds every library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc32 {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 32;  // block_q == block_kv
constexpr int kWarps = 2;   // each owns 16 rows of the 32-row output tile
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // bf16 a shared row (16 B pad)
  static constexpr int kTileBytes = kBlock * kStride * 2;  // a 32 x D tile
  static constexpr int kStages = D <= 64 ? 3 : 2;  // the streamed ring
  static constexpr int kSteps = D / 16;  // k16 steps of a product over D
  static constexpr int kNT = D / 8;      // n8 tiles of a D-wide output row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 m .. 8 m + 7
// giving matrix m's row addresses; .trans hands each thread the
// transposed elements.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += A B, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 32 x D bf16 tile (row stride D in global memory) into padded shared
// rows, 16 bytes a copy.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int u = 0; u < kBlock * kChunks / kThreads; ++u) {
    const int idx = tid + u * kThreads;
    const int row = idx / kChunks, cc = idx % kChunks;
    cp_async16(dst + (row * Tile<D>::kStride + cc * 8) * 2,
               src + (size_t)row * D + cc * 8);
  }
}

// ldmatrix row addresses, in bytes from a shared tile.
// A fragment (16 x 16, row-major): rows r0.., columns c0..; registers
// a0..a3 = (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0,
                                           int lane) {
  return tile +
         ((r0 + (lane & 15)) * Tile<D>::kStride + c0 + (lane >> 4) * 8) * 2;
}
// B fragments of two n8 tiles from a tile stored [n][k] (n rows n0..n0+15,
// k columns k0..k0+15): registers {0, 1} for n0, {2, 3} for n0 + 8.
template <int D>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int k0,
                                           int lane) {
  return tile + ((n0 + (lane & 7) + ((lane >> 4) << 3)) * Tile<D>::kStride +
                 k0 + (((lane >> 3) & 1) << 3)) *
                    2;
}
// The same from a tile stored [k][n] (k rows k0..k0+15, n columns
// n0..n0+15), read with .trans.
template <int D>
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int k0, int n0,
                                            int lane) {
  return tile + ((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                     Tile<D>::kStride +
                 n0 + ((lane >> 4) << 3)) *
                    2;
}

// acc = rows r0..r0+15 of tile `ta` times the 32 rows of tile `tb`,
// transposed (both stored [row][D]): a 16 x 32 score fragment, n8 tile
// nt holding columns 8 nt .. 8 nt + 7.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[4][4], uint32_t ta,
                                       int r0, uint32_t tb, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Tile<D>::kSteps; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr<D>(ta, r0, ks * 16, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_addr<D>(tb, np * 16, ks * 16, lane));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A 16 x 32 f32 fragment as the bf16 A operands of two k16 steps: the
// m16n8 accumulator's (row, column pair) of n8 tiles 2 kk and 2 kk + 1
// are the m16n8k16 A layout's.
__device__ __forceinline__ void to_a(uint32_t (&af)[2][4],
                                     const float (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    af[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    af[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    af[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    af[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (16 x D) += A (16 x 32, from `to_a`) times tile `tb` (32 x D,
// stored [row][D]).
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[Tile<D>::kNT][4],
                                             const uint32_t (&af)[2][4],
                                             uint32_t tb, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < Tile<D>::kNT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt_addr<D>(tb, kk * 16, np * 16, lane));
      mma_bf16(acc[2 * np], af[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], af[kk], b[2], b[3]);
    }
}

// The launch attributes of one instantiation: its dynamic shared memory
// (above the 48 KB default where it must be) and the largest shared-memory
// carve out, so that as many CTAs as the registers allow sit on an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// CTAs of `kernel` that fit on one SM, or a negative cudaError_t value.
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int smem) {
  int blocks = 0;
  cudaError_t err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace tc32
