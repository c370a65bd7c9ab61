// Hopper (sm_90a) building blocks shared by the tensor-core SLA kernels
// (sla_fwd_tc.cu, sla_bwd_tc.cu): cp.async staging of 64 x 128 bf16 tiles
// into the 128-byte-swizzled layout wgmma reads, the wgmma shared-memory
// descriptors for K-major and MN-major operands, the m64n64k16 bf16
// products with f32 accumulators, and the accumulator's register layout.
//
// Every kernel built on them runs one warpgroup (128 threads) per CTA at
// 64 x 64 blocks and a head dim of 128 (the wrappers zero-pad narrower
// heads). kernels/_build.py hashes this header with each source, so an
// edited header rebuilds every library that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kBlock = 64;        // block_q == block_kv
constexpr int kD = 128;           // head dim built for (the wrapper pads)
constexpr int kAtoms = kD / 64;   // 128-byte swizzle atoms along D
constexpr int kSteps = kD / 16;   // k16 steps of a product over D
constexpr int kThreads = 128;     // one warpgroup
constexpr int kTileBytes = kBlock * kD * 2;  // a 64 x D bf16 tile
constexpr int kAtomBytes = kBlock * 128;     // 64 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the
// async proxy: each writer fences before the barrier that publishes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 64 x kD bf16 tile (row stride kD in global memory) into kAtoms
// 64-row x 128-byte atoms, each 16-byte chunk c of row r at chunk
// c ^ (r % 8): the 128-byte swizzle (Swizzle<3,4,3>) wgmma decodes.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int tid) {
#pragma unroll
  for (int u = 0; u < kBlock * kD / 8 / kThreads; ++u) {
    const int idx = tid + u * kThreads;
    const int row = idx / (kD / 8);
    const int cc = idx % (kD / 8);
    const uint32_t off = (cc >> 3) * kAtomBytes + row * 128 +
                         (((cc & 7) ^ (row & 7)) << 4);
    cp_async16(dst + off, src + (size_t)row * kD + cc * 8);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (rows x D, D contiguous) at k16 step ks: atoms along D,
// 32 bytes a step inside an atom, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int ks) {
  return make_desc(tile + (ks >> 2) * kAtomBytes + (ks & 3) * 32, 16, 1024);
}
// MN-major operand: B = tile (K = tile rows, N = D), the 64 columns of
// atom `na`, k16 step kk = rows 16 kk .. 16 kk + 15; 8-row groups 1024
// bytes apart (SBO), atoms kAtomBytes apart along N (LBO).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int na,
                                                 int kk) {
  return make_desc(tile + na * kAtomBytes + kk * 16 * 128, kAtomBytes,
                   1024);
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
// Keep the compiler from moving reads or writes of registers an
// asynchronous wgmma owns across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) asm volatile("" : "+f"(r[t])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(r[t][x])::"memory");
}

#define SM90_WGMMA_D32                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define SM90_WGMMA_OUT32(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (four bf16x2 per thread), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64n64 f32 accumulator of thread (warp, lane): element t sits at
// row warp * 16 + lane / 4 + 8 * ((t >> 1) & 1) and column
// (t >> 2) * 8 + (lane % 4) * 2 + (t & 1). As the A operand of a k16 step
// kk, columns 16 kk .. 16 kk + 15 are elements 8 kk .. 8 kk + 7, packed in
// pairs: the layouts coincide.
__device__ __forceinline__ int acc_row(int t, int warp, int lane) {
  return warp * 16 + (lane >> 2) + 8 * ((t >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int lane) {
  return (t >> 2) * 8 + (lane & 3) * 2 + (t & 1);
}

template <int NA>
__device__ __forceinline__ void zero(float (&acc)[NA][32]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int t = 0; t < 32; ++t) acc[a][t] = 0.f;
}

}  // namespace sm90
