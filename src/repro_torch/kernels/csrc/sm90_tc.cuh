// Hopper (sm_90a) building blocks shared by the tensor-core SLA kernels
// (sla_fwd_tc.cu, sla_fwd_split.cu, sla_bwd_tc.cu): cp.async staging of
// 64 x 128 bf16 tiles into the 128-byte-swizzled layout wgmma reads, the
// wgmma shared-memory descriptors for K-major and MN-major operands, the
// m64n64k16 bf16 products with f32 accumulators, the accumulator's
// register layout, and the forwards' f32 linear-branch epilogue.
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

// d (+)= A B, m64n64k16, A from registers, B K-major in shared memory
// (the split forward's S = Q K^T with Q's lower parts held in registers).
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
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

// The forward kernels' linear branch, in f32 FMAs (not TF32 or bf16: H_i is
// a sum over many blocks): rows of query block i of O^l = phi(Q_i) H_i /
// (phi(Q_i) Z_i), zero where the denominator is <= 1e-6, at the true head
// dim d. phi(Q_i) (64 rows of stride d + 4 floats) and Z_i are staged by
// cp.async into the freed shared memory at `sbase` (1024-byte aligned,
// kLinearSmemBytes long), H_i streams through it in 32-row chunks, two
// deep, and each of the 128 threads owns an 8 x 8 tile of the 64 x d
// output (4-wide shared loads, ~72 FMAs per 24 load wavefronts a warp).
// Call when no product still reads that memory; it waits for the caller's
// own copies first.
constexpr float kDenEps = 1e-6f;
constexpr int kHRows = 32;                    // H_i rows per chunk
constexpr int kPQFloats = kBlock * (kD + 4);  // phi(Q_i) at d = 128
constexpr int kZOff = kPQFloats;              // Z_i (floats from the base)
constexpr int kHOff = kZOff + kD;             // H_i chunk 0, then chunk 1
constexpr int kLinearSmemBytes = (kHOff + 2 * kHRows * kD) * 4;

// `fbase` is the generic pointer to the shared address `sbase`.
__device__ __forceinline__ void linear_branch(
    uint32_t sbase, const float* fbase, const float* qp_blk,
    const float* hi_blk, const float* zi_row, float* o_l_blk, int d,
    int tid) {
  cp_async_wait_all();
  __syncthreads();  // every product that read the ring is done
  const int ps = d + 4;  // phi(Q_i) row stride in floats
  const int d4 = d >> 2;
  const uint32_t f0 = sbase;
  for (int idx = tid; idx < kBlock * d4; idx += kThreads) {
    const int r = idx / d4, c4 = idx - r * d4;
    cp_async16(f0 + (r * ps + c4 * 4) * 4, qp_blk + (size_t)r * d + c4 * 4);
  }
  if (tid < d4) cp_async16(f0 + (kZOff + tid * 4) * 4, zi_row + tid * 4);
  const int n_chunks = (d + kHRows - 1) / kHRows;
  auto load_h = [&](int c) {
    const int rows = min(kHRows, d - c * kHRows);
    const uint32_t dst = f0 + (kHOff + (c & 1) * kHRows * kD) * 4;
    const float* src = hi_blk + (size_t)c * kHRows * d;
    for (int idx = tid; idx < rows * d4; idx += kThreads)
      cp_async16(dst + idx * 16, src + idx * 4);
  };
  load_h(0);
  cp_async_commit();
  if (n_chunks > 1) load_h(1);
  cp_async_commit();

  const int tx = tid & 15, ty = tid >> 4;  // rows ty + 8 rr; columns
  const int c0 = 4 * tx, c1 = 64 + 4 * tx;  // c0..c0+3 and c1..c1+3
  const bool ok0 = c0 < d, ok1 = c1 < d;
  const int cr0 = ok0 ? c0 : 0, cr1 = ok1 ? c1 : 0;  // clamped reads
  const float* sPQ = fbase;
  const float* sZ = fbase + kZOff;
  float num[8][8], den[8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    den[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) num[rr][e] = 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // chunk c (and phi(Q_i), Z_i) landed
    __syncthreads();
    const float* sH = fbase + kHOff + (c & 1) * kHRows * kD;
    const int rows = min(kHRows, d - c * kHRows);
    for (int dd = 0; dd < rows; dd += 4) {
      float4 q4[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
        q4[rr] = *reinterpret_cast<const float4*>(
            sPQ + (ty + 8 * rr) * ps + c * kHRows + dd);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 h0 =
            *reinterpret_cast<const float4*>(sH + (dd + u) * d + cr0);
        const float4 h1 =
            *reinterpret_cast<const float4*>(sH + (dd + u) * d + cr1);
        const float z = sZ[c * kHRows + dd + u];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const float qv = u == 0   ? q4[rr].x
                           : u == 1 ? q4[rr].y
                           : u == 2 ? q4[rr].z
                                    : q4[rr].w;
          num[rr][0] = fmaf(qv, h0.x, num[rr][0]);
          num[rr][1] = fmaf(qv, h0.y, num[rr][1]);
          num[rr][2] = fmaf(qv, h0.z, num[rr][2]);
          num[rr][3] = fmaf(qv, h0.w, num[rr][3]);
          num[rr][4] = fmaf(qv, h1.x, num[rr][4]);
          num[rr][5] = fmaf(qv, h1.y, num[rr][5]);
          num[rr][6] = fmaf(qv, h1.z, num[rr][6]);
          num[rr][7] = fmaf(qv, h1.w, num[rr][7]);
          den[rr] = fmaf(qv, z, den[rr]);
        }
      }
    }
    __syncthreads();  // everyone is done with this chunk's buffer
    if (c + 2 < n_chunks) load_h(c + 2);
    cp_async_commit();
  }
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const bool live = den[rr] > kDenEps;
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = live ? num[rr][e] / den[rr] : 0.f;
    float* dst = o_l_blk + (size_t)(ty + 8 * rr) * d;
    if (ok0)
      *reinterpret_cast<float4*>(dst + c0) =
          make_float4(out[0], out[1], out[2], out[3]);
    if (ok1)
      *reinterpret_cast<float4*>(dst + c1) =
          make_float4(out[4], out[5], out[6], out[7]);
  }
}

}  // namespace sm90
