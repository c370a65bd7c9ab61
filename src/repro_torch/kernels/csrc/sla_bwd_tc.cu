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
// The staging, descriptor and wgmma helpers live in sm90_tc.cuh, shared
// with the tensor-core forward (sla_fwd_tc.cu).
#include "sm90_tc.cuh"

namespace {

using namespace sm90;

constexpr int kVecBytes = 2 * kBlock * 4;    // L_i and D_i (dK/dV stage)

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
