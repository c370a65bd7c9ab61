// Fused SLA forward kernel on Hopper's bf16 tensor cores (sm_90a, wgmma):
// sparse softmax over the critical KV blocks of each query block, plus the
// linear-branch merge.
//
// Replaces, for bf16 q, k, v at 64 x 64 blocks and head dims up to 128,
// the Pallas TPU kernel `_fwd_kernel` in src/repro/kernels/sla_fwd.py
// (launched by `sla_fwd`). f32 at those blocks takes sla_fwd_split.cu,
// every other case the f32-FMA kernel of sla_fwd.cu. For each (batch*head bh, query block i) it computes
//   O^s_i = softmax(Q_i K_J^T * scale) V_J   over the counts[bh,i] critical
//           blocks J = lut[bh,i,:counts], online (running max m, sum l, acc),
//   lse_i = m + log l,
//   O^l_i = phi(Q_i) H_i / (phi(Q_i) Z_i), zero where the denominator is
//           <= 1e-6, from the pre-aggregated marginal state (H_i, Z_i),
// with an optional causal mask on absolute rows (base + i) * 64 + r (the
// reference's -1e30 on masked scores) and KV head bh / group.
//
// Precision (FlashAttention's contract): q, k, v are bf16 and S = Q K^T
// accumulates in f32; P is rounded to bf16 before P V; l sums the
// unrounded f32 P; every sum is f32. m, l, lse and the whole linear branch
// (phi(Q), H_i, Z_i, its products and its division) are f32, as in the
// f32 kernel.
//
// What bounds it. Per live tile the sparse branch does two 64 x 64 x D
// products (4 * 64 * 64 * D operations); the linear branch adds 2 * 64 *
// D^2 per query block. Against one read of q, k, v, qp, H_i, Z_i and one
// f32 write of O^s, O^l and lse that is ~270 operations per byte at the
// Wan shape (~5% of the blocks live), under the H100's ~295 bf16 tensor
// operations per byte of device memory: the bound is bytes (mostly H_i,
// qp and the f32 outputs), and the tensor-core work sits just under it.
//
// What the design does about it. One warpgroup (128 threads) per (bh, i)
// walks its own LUT row and stops at its count, so padded slots are never
// read and no sum crosses CTAs (no atomics: two launches on the same
// operands are bitwise equal). S = Q_i K_j^T is wgmma m64n64k16 with both
// operands K-major in shared memory (Q_i staged once, K_j per LUT entry);
// O += P V_j takes P, rounded to bf16, straight from the S accumulators as
// wgmma's register A operand (the accumulator and A-fragment layouts
// coincide for 16-bit types) and V_j as the MN-major B operand, so P never
// touches shared memory. K_j and V_j are staged by cp.async into the
// 128-byte-swizzled atoms wgmma reads, two stages deep: the next LUT
// entry's tiles load while this one computes. The online softmax runs in
// registers: each row's max and sum reduce over the 4 threads of its quad
// by shuffles (the sum once, at the end), the exponent is exp2 with the
// scale folded into log2(e), and the causal mask touches only tiles that
// straddle the diagonal. Each step waits for its own products before the
// next begins (no instruction touches a register an in-flight wgmma owns,
// so ptxas does not serialize them). The linear branch runs after O^s and
// lse are written, in f32 FMAs (not TF32 or bf16: H_i is a sum over many
// blocks, and its arithmetic stays the f32 kernel's): phi(Q_i) and Z_i
// are staged in the freed tile ring, H_i streams through it in 32-row
// chunks, two deep, and each thread owns an 8 x 8 tile of the 64 x D
// output (4-wide shared loads, ~72 FMAs per 24 load wavefronts a warp;
// sm90_tc.cuh's `linear_branch`, shared with sla_fwd_split.cu).
// Shared memory (~81 KB) and registers admit two CTAs per SM, so one
// CTA's exponentials and epilogue overlap the other's products. The
// helpers shared with the tensor-core backward are in sm90_tc.cuh.
#include "sm90_tc.cuh"

namespace {

using namespace sm90;

constexpr float kLn2 = 0.6931471805599453f;
// the reference's masked score, -1e30, in the exp2 domain
constexpr float kMasked2 = -1e30f * kLog2e;

// smem: Q_i, then two stages of (K_j, V_j), 1024-byte aligned. The
// linear-branch epilogue reuses it for phi(Q_i), Z_i and H_i chunks.
constexpr int kStageBytes = 2 * kTileBytes;
constexpr size_t kSmem = 1024 + kTileBytes + 2 * kStageBytes;
static_assert(kLinearSmemBytes <= kTileBytes + 2 * kStageBytes,
              "the epilogue's tiles must fit the freed ring");

__global__ void __launch_bounds__(kThreads, 2)
    sla_fwd_tc_kernel(const int32_t* __restrict__ lut,
                      const int32_t* __restrict__ counts, int base,
                      const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ qp,
                      const float* __restrict__ hi,
                      const float* __restrict__ zi, float* __restrict__ o_s,
                      float* __restrict__ o_l, float* __restrict__ lse,
                      int nq, int nkv, int d, int tm, int k_sel, int group,
                      float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  const uint32_t sbase = smem_u32(smem_raw) + pad;
  const uint32_t sQ = sbase;
  const uint32_t sKV = sbase + kTileBytes;  // stage s: K, then V

  const int i = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row_base = (size_t)bh * nq + (size_t)i * kBlock;
  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_rows = (size_t)(bh / group) * nkv;

  load_tile(sQ, q + row_base * kD, tid);
  if (cnt > 0) {
    const size_t r = kv_rows + (size_t)lut_row[0] * kBlock;
    load_tile(sKV, k + r * kD, tid);
    load_tile(sKV + kTileBytes, v + r * kD, tid);
  }
  cp_async_commit();

  const int row0 = (base + i) * kBlock;  // absolute row of the tile's top
  const float sl2 = scale * kLog2e;
  float acc[kAtoms][32];
  zero(acc);
  uint32_t pf[4][4];  // P as bf16 A fragments, one per k16 step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pf[kk][x] = 0u;
  // rows r0 = warp * 16 + lane / 4 (h = 0) and r0 + 8 (h = 1): running max
  // (exp2 domain) and this thread's partial sum over its own columns
  float m2[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};

  float sc[32];  // S, then P (no other instruction writes it in flight)
#pragma unroll
  for (int t = 0; t < 32; ++t) sc[t] = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    const uint32_t sK = sKV + (s & 1) * kStageBytes;
    const uint32_t sV = sK + kTileBytes;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // step s's tiles are in; step s-1 is done with its own
    if (s + 1 < cnt) {
      const size_t r = kv_rows + (size_t)lut_row[s + 1] * kBlock;
      const uint32_t nK = sKV + ((s + 1) & 1) * kStageBytes;
      load_tile(nK, k + r * kD, tid);
      load_tile(nK + kTileBytes, v + r * kD, tid);
    }
    cp_async_commit();

    // S = Q_i K_j^T
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss(sc, desc_kmajor(sQ, ks), desc_kmajor(sK, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the exp2 domain; the causal mask only on tiles
    // that straddle the diagonal
    const bool straddle = causal && (j * kBlock + kBlock - 1 > row0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      float x = sc[t] * sl2;
      if (straddle &&
          row0 + acc_row(t, warp, lane) < j * kBlock + acc_col(t, lane))
        x = kMasked2;
      sc[t] = x;
      const int h = (t >> 1) & 1;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m2[h] - mx[h]);
      m2[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int h = (t >> 1) & 1;
      const float p = exp2f(sc[t] - m2[h]);
      l[h] += p;  // the unrounded P
      sc[t] = p;
    }
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int t = 0; t < 32; ++t) acc[a][t] *= alpha[(t >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pf[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    // O += P V_j: B = V_j read MN-major (K = kv rows, N = D)
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[a], pf[kk], desc_mnmajor(sV, a, kk));
    wgmma_commit();
    wgmma_wait_all();  // before the next step refills this stage
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) fence_regs(acc[a]);
    fence_regs(pf);
  }

  // Sparse finalize: O^s = acc / l, lse = m + log l (l > 0: the diagonal
  // block is forced critical, so every row has a live block), written at
  // the true head dim d.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int t = 0; t < 32; t += 2) {
      const int col = a * 64 + acc_col(t, lane);
      if (col >= d) continue;
      const int h = (t >> 1) & 1;
      float2* dst = reinterpret_cast<float2*>(
          o_s + (row_base + acc_row(t, warp, lane)) * d + col);
      *dst = make_float2(acc[a][t] * inv_l[h], acc[a][t + 1] * inv_l[h]);
    }
  if ((lane & 3) == 0) {
    const int r0 = warp * 16 + (lane >> 2);
    lse[row_base + r0] = m2[0] * kLn2 + logf(l[0]);
    lse[row_base + r0 + 8] = m2[1] * kLn2 + logf(l[1]);
  }

  // Linear branch in f32, in the freed ring (sm90_tc.cuh).
  linear_branch(sbase, reinterpret_cast<const float*>(smem_raw + pad),
                qp + row_base * d, hi + (size_t)row_blk * d * d,
                zi + (size_t)row_blk * d, o_l + row_base * d, d, tid);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v are bf16 with head dim 128 (the wrapper zero-pads narrower
// heads: zero columns leave S unchanged), q (bh_q, nq, 128), k and v
// (bh_kv, nkv, 128); `d` is the true head dim (a multiple of 4, at most
// 128) of qp (bh_q, nq, d), hi (bh_q, tm, d, d), zi (bh_q, tm, d) and the
// f32 outputs o_s, o_l (bh_q, nq, d) and lse (bh_q, nq); the LUTs int32,
// block_q == block_kv == 64, every operand 16-byte aligned. Returns a
// cudaError_t value (0 on success); the launch is asynchronous on
// `stream` and allocates nothing.
extern "C" int sla_fwd_tc_launch(const int32_t* lut, const int32_t* counts,
                                 int base, const void* q, const void* k,
                                 const void* v, const float* qp,
                                 const float* hi, const float* zi,
                                 float* o_s, float* o_l, float* lse,
                                 int bh_q, int bh_kv, int nq, int nkv, int d,
                                 int tm, int k_sel, int block_q,
                                 int block_kv, float scale, int causal,
                                 void* stream) {
  if (block_q != kBlock || block_kv != kBlock || d < 4 || d > kD || d % 4 ||
      tm != nq / kBlock)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sla_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  sla_fwd_tc_kernel<<<dim3(tm, bh_q), kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      lut, counts, base, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), qp, hi, zi,
      o_s, o_l, lse, nq, nkv, d, tm, k_sel, bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" const char* sla_fwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
