// SLA sparse-branch backward kernels on Hopper's bf16 tensor cores
// (sm_90a, wgmma): dQ over the row LUT and dK, dV over the column LUT.
//
// Replaces, for bf16 q, k, v at 64 x 64 blocks and head dims up to 128,
// the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/sla_bwd.py (launched by `sla_bwd_dq`, `sla_bwd_dkv`).
// Every other case takes the f32-FMA kernels of sla_bwd.cu. With
// P_ij = exp(S_ij * scale - L_i) recomputed from the forward's row LSE,
// dP_ij = dO_i V_j^T and dS_ij = P_ij * (dP_ij - D_i) * scale:
//   dQ_i = sum over j in lut[bh,i,:counts]          of dS_ij K_j,
//   dK_j = sum over i in col_lut[bh,j,:col_counts]  of dS_ij^T Q_i,
//   dV_j = sum over the same i                      of P_ij^T dO_i,
// per query head bh (K_j, V_j from kv head bh / group; the caller sums
// dK, dV over a GQA group), with an optional causal mask on absolute rows
// and columns.
//
// Precision (FlashAttention's contract): q, k, v and dO are bf16; P and
// dS are rounded to bf16 before their products; every sum is f32 and the
// outputs are f32. L, D and the row scale stay f32.
//
// What bounds them. Per live tile the dQ kernel does three 64 x 64 x D
// products (S, dP, dS K: 6 * 64 * 64 * D operations), the dK/dV kernel
// four (S^T, dP^T, P^T dO, dS^T Q: 8 * 64 * 64 * D); against one read of
// q, k, v, dO and one write of the gradients that is hundreds of
// operations per byte at the Wan shape, so both are bound by the 989
// TFLOP/s of bf16 tensor cores.
//
// What the design does about it. One warpgroup (128 threads) per output
// tile walks its LUT row and stops at its count, so padded slots are never
// read and no sum crosses blocks (no atomics: two launches on the same
// operands are bitwise equal). All products are wgmma m64n64k16 with f32
// accumulators in registers: the scores S and dP with both operands in
// shared memory (K-major), the gradient products with P / dS as the
// register A operand straight from the score accumulators (the wgmma
// accumulator and A-fragment layouts coincide for 16-bit types) and B read
// MN-major from the same shared tiles, so K_j (dQ) and Q_i, dO_i (dK/dV)
// serve both of their products. Tiles are staged by cp.async into the
// 128-byte-swizzled layout wgmma reads, two stages deep: the next LUT
// entry's tiles load while this one computes. Each step waits for its own
// products before the next begins: no other instruction touches a
// register that an in-flight wgmma owns, so ptxas keeps the products in
// one batch instead of serializing them (its C7515 report), and the dK/dV
// kernel's two 64 x D accumulators, scores and fragments fit 255
// registers without spilling. Shared memory (~97 KB) and registers admit
// two CTAs per SM, so one CTA's exponentials overlap the other's
// products. The accumulators are written once, at the end of the walk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;        // block_q == block_kv
constexpr int kD = 128;           // head dim built for (the wrapper pads)
constexpr int kAtoms = kD / 64;   // 128-byte swizzle atoms along D
constexpr int kSteps = kD / 16;   // k16 steps of the score products
constexpr int kThreads = 128;     // one warpgroup
constexpr int kTileBytes = kBlock * kD * 2;  // a 64 x D bf16 tile
constexpr int kAtomBytes = kBlock * 128;     // 64 rows x 128 bytes
constexpr int kVecBytes = 2 * kBlock * 4;    // L_i and D_i (dK/dV stage)
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

#define WGMMA_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define WGMMA_OUT32(d)                                                    \
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
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (four bf16x2 per thread), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT32(d)
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

// Write a 64 x kD f32 accumulator (atoms along D) to rows of `out`.
__device__ __forceinline__ void store_acc(float* out,
                                          const float (&acc)[kAtoms][32],
                                          int warp, int lane) {
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int t = 0; t < 32; t += 2) {
      float2* dst = reinterpret_cast<float2*>(
          out + (size_t)acc_row(t, warp, lane) * kD + a * 64 +
          acc_col(t, lane));
      *dst = make_float2(acc[a][t], acc[a][t + 1]);
    }
}

// smem: the resident pair (Q_i, dO_i for dQ; K_j, V_j for dK/dV), then two
// stages of the streamed pair (+ L_i, D_i for dK/dV), 1024-byte aligned.
// The dK/dV kernel keeps both stages' L_i, D_i after the six tiles.
constexpr int kStageBytesDq = 2 * kTileBytes;
constexpr size_t kSmemDq = 1024 + 2 * kTileBytes + 2 * kStageBytesDq;
constexpr size_t kSmemDkv = 1024 + 6 * kTileBytes + 2 * kVecBytes;

__global__ void __launch_bounds__(kThreads, 2)
    sla_bwd_dq_tc_kernel(const int32_t* __restrict__ lut,
                         const int32_t* __restrict__ counts,
                         const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         float* __restrict__ dq, int n, int tm, int k_sel,
                         int group, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sDO = base + kTileBytes;
  const uint32_t sKV = base + 2 * kTileBytes;  // stage s: K, then V

  const int i = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row_base = (size_t)bh * n + (size_t)i * kBlock;
  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_rows = (size_t)(bh / group) * n;

  load_tile(sQ, q + row_base * kD, tid);
  load_tile(sDO, dout + row_base * kD, tid);
  if (cnt > 0) {
    const size_t r = kv_rows + (size_t)lut_row[0] * kBlock;
    load_tile(sKV, k + r * kD, tid);
    load_tile(sKV + kTileBytes, v + r * kD, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const float lse2[2] = {lse[row_base + r0] * kLog2e,
                         lse[row_base + r0 + 8] * kLog2e};
  const float dsv[2] = {dsum[row_base + r0], dsum[row_base + r0 + 8]};
  const float sl2 = scale * kLog2e;

  float acc[kAtoms][32];
  zero(acc);
  uint32_t dsf[4][4];  // dS as bf16 A fragments, one per k16 step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) dsf[kk][x] = 0u;

  // S, dP; then P, dS (no other instruction writes them while a product
  // is in flight)
  float sc[32], dp[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) sc[t] = dp[t] = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    const uint32_t sK = sKV + (s & 1) * kStageBytesDq;
    const uint32_t sV = sK + kTileBytes;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // step s's tiles are in; step s-1 is done with its own
    if (s + 1 < cnt) {
      const size_t r = kv_rows + (size_t)lut_row[s + 1] * kBlock;
      const uint32_t nK = sKV + ((s + 1) & 1) * kStageBytesDq;
      load_tile(nK, k + r * kD, tid);
      load_tile(nK + kTileBytes, v + r * kD, tid);
    }
    cp_async_commit();

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss(sc, desc_kmajor(sQ, ks), desc_kmajor(sK, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss(dp, desc_kmajor(sDO, ks), desc_kmajor(sV, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P and dS in registers; the causal mask only on tiles that straddle
    // the diagonal
    const bool straddle = causal && (j * kBlock + kBlock - 1 > i * kBlock);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int h = (t >> 1) & 1;
      float p = exp2f(sc[t] * sl2 - lse2[h]);
      if (straddle &&
          i * kBlock + acc_row(t, warp, lane) < j * kBlock + acc_col(t, lane))
        p = 0.f;
      sc[t] = p * (dp[t] - dsv[h]) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dsf[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    // dQ_i += dS K_j: B = K_j read MN-major (K = kv rows, N = D)
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[a], dsf[kk], desc_mnmajor(sK, a, kk));
    wgmma_commit();
    wgmma_wait_all();  // before the next step refills this stage
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) fence_regs(acc[a]);
    fence_regs(dsf);
  }
  store_acc(dq + row_base * kD, acc, warp, lane);
}

__global__ void __launch_bounds__(kThreads, 2)
    sla_bwd_dkv_tc_kernel(const int32_t* __restrict__ col_lut,
                          const int32_t* __restrict__ col_counts,
                          const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int n, int tn, int w_col, int group, float scale,
                          int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + kTileBytes;
  const uint32_t sQD = base + 2 * kTileBytes;  // stage s: Q, dO, L, D
  float* vec_base = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + 6 * kTileBytes);

  const int j = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t kv_row = (size_t)(bh / group) * n + (size_t)j * kBlock;
  const int col_blk = bh * tn + j;
  int cnt = col_counts[col_blk];
  cnt = cnt < w_col ? cnt : w_col;
  const int32_t* lut_col = col_lut + (size_t)col_blk * w_col;
  const size_t q_head = (size_t)bh * n;

  // stage st of the (Q_i, dO_i) ring and of its (L_i, D_i)
  auto stage_tiles = [&](int st) { return sQD + st * 2 * kTileBytes; };
  auto stage_vec = [&](int st) { return vec_base + st * 2 * kBlock; };
  auto load_stage = [&](int st, int i) {
    const size_t r = q_head + (size_t)i * kBlock;
    load_tile(stage_tiles(st), q + r * kD, tid);
    load_tile(stage_tiles(st) + kTileBytes, dout + r * kD, tid);
    if (tid < kVecBytes / 16) {  // 16-byte chunks: 16 of L, 16 of D
      const float* src = tid < 16 ? lse + r + tid * 4
                                  : dsum + r + (tid - 16) * 4;
      cp_async16(smem_u32(stage_vec(st)) + tid * 16, src);
    }
  };

  load_tile(sK, k + kv_row * kD, tid);
  load_tile(sV, v + kv_row * kD, tid);
  if (cnt > 0) load_stage(0, lut_col[0]);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc_k[kAtoms][32], acc_v[kAtoms][32];
  zero(acc_k);
  zero(acc_v);
  uint32_t pf[4][4], dsf[4][4];  // P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pf[kk][x] = dsf[kk][x] = 0u;

  float sc[32], dp[32];  // S^T, dP^T; then P^T, dS^T
#pragma unroll
  for (int t = 0; t < 32; ++t) sc[t] = dp[t] = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const int i = lut_col[s];
    const uint32_t sQ = stage_tiles(s & 1), sDO = sQ + kTileBytes;
    const float* vec = stage_vec(s & 1);  // L_i[64], then D_i[64]
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (s + 1 < cnt) load_stage((s + 1) & 1, lut_col[s + 1]);
    cp_async_commit();

    // S^T = K_j Q_i^T and dP^T = V_j dO_i^T (rows: kv, columns: queries)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss(sc, desc_kmajor(sK, ks), desc_kmajor(sQ, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss(dp, desc_kmajor(sV, ks), desc_kmajor(sDO, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T in registers, L_i and D_i along the columns
    const bool straddle = causal && (j * kBlock + kBlock - 1 > i * kBlock);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int c = acc_col(t, lane);
      float p = exp2f(sc[t] * sl2 - vec[c] * kLog2e);
      if (straddle &&
          i * kBlock + acc_col(t, lane) < j * kBlock + acc_row(t, warp, lane))
        p = 0.f;
      dp[t] = p * (dp[t] - vec[kBlock + c]) * scale;
      sc[t] = p;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pf[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        dsf[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }

    // dV_j += P^T dO_i, dK_j += dS^T Q_i: B read MN-major (K = query rows,
    // N = D)
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_v[a], pf[kk], desc_mnmajor(sDO, a, kk));
        wgmma_rs(acc_k[a], dsf[kk], desc_mnmajor(sQ, a, kk));
      }
    wgmma_commit();
    wgmma_wait_all();  // before the next step refills this stage
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      fence_regs(acc_k[a]);
      fence_regs(acc_v[a]);
    }
    fence_regs(pf);
    fence_regs(dsf);
  }
  const size_t out = ((size_t)bh * n + (size_t)j * kBlock) * kD;
  store_acc(dk + out, acc_k, warp, lane);
  store_acc(dv + out, acc_v, warp, lane);
}

int check_shape(int d, int block_q, int block_kv) {
  return (d == kD && block_q == kBlock && block_kv == kBlock)
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v and dout are bf16 with head dim d == 128 (the wrapper zero-pads
// narrower heads), q, dout, dq, dk, dv (bh_q, n, d), k and v (bh_kv, n,
// d), lse and dsum f32 (bh_q, n), the LUTs int32, block_q == block_kv ==
// 64, every row 16-byte aligned. Returns a cudaError_t value (0 on
// success); each launch is asynchronous on `stream` and allocates nothing.
extern "C" int sla_bwd_dq_tc_launch(const int32_t* lut, const int32_t* counts,
                                    const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* dsum,
                                    float* dq, int bh_q, int bh_kv, int n,
                                    int d, int k_sel, int block_q,
                                    int block_kv, float scale, int causal,
                                    void* stream) {
  if (int err = check_shape(d, block_q, block_kv)) return err;
  cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDq);
  if (err != cudaSuccess) return (int)err;
  const int tm = n / kBlock;
  sla_bwd_dq_tc_kernel<<<dim3(tm, bh_q), kThreads, kSmemDq,
                         static_cast<cudaStream_t>(stream)>>>(
      lut, counts, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dsum,
      dq, n, tm, k_sel, bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int sla_bwd_dkv_tc_launch(const int32_t* col_lut,
                                     const int32_t* col_counts,
                                     const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* dsum,
                                     float* dk, float* dv, int bh_q,
                                     int bh_kv, int n, int d, int w_col,
                                     int block_q, int block_kv, float scale,
                                     int causal, void* stream) {
  if (int err = check_shape(d, block_q, block_kv)) return err;
  cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDkv);
  if (err != cudaSuccess) return (int)err;
  const int tn = n / kBlock;
  sla_bwd_dkv_tc_kernel<<<dim3(tn, bh_q), kThreads, kSmemDkv,
                          static_cast<cudaStream_t>(stream)>>>(
      col_lut, col_counts, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, dsum, dk, dv, n, tn, w_col,
      bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" const char* sla_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
