// SLA sparse-branch backward kernels at 32 x 32 blocks on Hopper's bf16
// tensor cores (sm_90a, warp-level mma.sync): dQ over the row LUT and dK,
// dV over the column LUT.
//
// Replaces, for bf16 q, k, v at 32 x 32 blocks and head dims up to 128
// (the paper's fine-tune, examples_torch/finetune_dit.py), the Pallas TPU
// kernels `_dq_kernel` and `_dkv_kernel` in src/repro/kernels/sla_bwd.py
// (launched by `sla_bwd_dq`, `sla_bwd_dkv`). 64 x 64 blocks take the
// wgmma kernels of sla_bwd_tc.cu; f32, other blocks and head dims above 128
// the f32-FMA kernels of sla_bwd.cu. With P_ij = exp(S_ij * scale - L_i)
// recomputed from the forward's row LSE, dP_ij = dO_i V_j^T and
// dS_ij = P_ij * (dP_ij - D_i) * scale:
//   dQ_i = sum over j in lut[bh,i,:counts]          of dS_ij K_j,
//   dK_j = sum over i in col_lut[bh,j,:col_counts]  of dS_ij^T Q_i,
//   dV_j = sum over the same i                      of P_ij^T dO_i,
// per query head bh (K_j, V_j from kv head bh / group; the caller sums
// dK, dV over a GQA group), with an optional causal mask on absolute rows
// and columns.
//
// Precision (FlashAttention's contract, as sla_bwd_tc.cu): q, k, v and dO
// are bf16; P and dS are rounded to bf16 before their products; every sum
// is f32 and the outputs are f32. L, D and the row scale stay f32.
//
// What bounds them. At the fine-tune's shape (BH 24, N 4,096, D 64, K 13,
// 39,932 live tiles) the dQ kernel does 6 * 32 * 32 * 64 operations a live
// tile, 15.7 GFLOP (0.016 ms at 989 TFLOP/s), against 89 MB read and
// written once (0.027 ms at 3.35 TB/s); the dK/dV kernel 8 * 32 * 32 * 64,
// 20.9 GFLOP (0.021 ms), against 114 MB (0.034 ms). Both are bound by
// bytes, narrowly. But a CTA walks only ~13 LUT entries of a 32 x D tile
// (~25 KFLOP of tensor-core work an entry and warp): what holds them back
// is latency (the first tiles' load, the walk's pipeline, the epilogue),
// not a peak.
//
// What the design does about it. wgmma needs 64-row tiles, and a 32-row
// output tile walks its own LUT row: two tiles could share a 64-row
// product only by walking the union of their LUTs under a mask. So each
// CTA is two warps (64 threads), each owning 16 rows of the 32-row output
// tile and issuing mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// ldmatrix fragments. S (S^T for dK/dV) and dP (dP^T) are 16 x 32
// fragments over k16 steps of D; P and dS turn into the A fragments of
// the gradient products straight from the accumulator registers (the
// m16n8 C layout pairs into the m16n8k16 A layout), and the B operands of
// those products are read by ldmatrix.trans from the same shared tiles
// that served S and dP. The CTAs are small (36.9 KB of shared memory at
// D 64, 52 KB at D 128, and ~100-200 registers a thread), so several sit
// on each SM and one CTA's loads hide behind the others' products; within
// a CTA a cp.async ring (3 stages at D 64, 2 at D 128) keeps the next LUT
// entries' tiles in flight. Shared rows are padded by 16 bytes, so the
// ldmatrix reads are free of bank conflicts. Each CTA stops at its count
// (padded LUT slots are never read), and every sum runs in one fixed
// order without atomics: two launches on the same operands are bitwise
// equal. The causal mask is applied only on tiles that straddle the
// diagonal. The helpers shared with the forward at these blocks
// (sla_fwd_tc32.cu) are in tc32.cuh.
#include "tc32.cuh"

namespace {

using namespace tc32;

template <int D>
struct Cfg : Tile<D> {
  using T = Tile<D>;
  // dQ: Q_i, dO_i, then each stage's K_j, V_j
  static constexpr int kSmemDq = (2 + 2 * T::kStages) * T::kTileBytes;
  // dK/dV: K_j, V_j, each stage's Q_i, dO_i, then each stage's L_i, D_i
  static constexpr int kVecOff = (2 + 2 * T::kStages) * T::kTileBytes;
  static constexpr int kSmemDkv = kVecOff + T::kStages * 2 * kBlock * 4;
};

// Rows r0 + g and r0 + g + 8 of a 16 x D accumulator to `out` (row
// stride D), two floats a store.
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[Cfg<D>::kNT][4],
                                           int r0, int lane) {
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < Cfg<D>::kNT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)(r0 + g + 8 * h) * D +
                                 nt * 8 + c) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sla_bwd_dq_tc32_kernel(const int32_t* __restrict__ lut,
                           const int32_t* __restrict__ counts,
                           const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ dq, int n, int tm, int k_sel,
                           int group, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw), sDO = sQ + C::kTileBytes;
  const uint32_t sKV = sQ + 2 * C::kTileBytes;  // stage st: K_j, then V_j

  const int i = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = warp * 16;  // this warp's rows of the query block
  const size_t row_base = (size_t)bh * n + (size_t)i * kBlock;
  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_rows = (size_t)(bh / group) * n;

  auto load_kv = [&](int st, int j) {
    const size_t r = kv_rows + (size_t)j * kBlock;
    const uint32_t t = sKV + st * 2 * C::kTileBytes;
    load_tile<D>(t, k + r * D, tid);
    load_tile<D>(t + C::kTileBytes, v + r * D, tid);
  };
  if (cnt > 0) {
    load_tile<D>(sQ, q + row_base * D, tid);
    load_tile<D>(sDO, dout + row_base * D, tid);
  }
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {  // group st: stage st
    if (st < cnt) load_kv(st, lut_row[st]);
    cp_async_commit();
  }

  const float lse2[2] = {lse[row_base + r0 + g] * kLog2e,
                         lse[row_base + r0 + g + 8] * kLog2e};
  const float dsv[2] = {dsum[row_base + r0 + g], dsum[row_base + r0 + g + 8]};
  const float sl2 = scale * kLog2e;

  float acc[C::kNT][4];
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int s = 0; s < cnt; ++s) {
    cp_async_wait<C::kStages - 2>();  // step s's tiles have landed
    __syncthreads();  // ... for every thread; step s-1 is done with its own
    const int nx = s + C::kStages - 1;
    if (nx < cnt) load_kv(nx % C::kStages, lut_row[nx]);
    cp_async_commit();

    const int j = lut_row[s];
    const uint32_t sK = sKV + (s % C::kStages) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    float sc[4][4], dp[4][4];
    scores<D>(sc, sQ, r0, sK, lane);   // S = Q_i K_j^T
    scores<D>(dp, sDO, r0, sV, lane);  // dP = dO_i V_j^T

    // dS in place of S; the causal mask only on tiles that straddle the
    // diagonal
    const bool straddle = causal && (j * kBlock + kBlock - 1 > i * kBlock);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(sc[nt][e] * sl2 - lse2[h]);
        if (straddle && i * kBlock + r0 + g + 8 * h <
                            j * kBlock + nt * 8 + c2 + (e & 1))
          p = 0.f;
        sc[nt][e] = p * (dp[nt][e] - dsv[h]) * scale;
      }
    uint32_t dsf[2][4];
    to_a(dsf, sc);
    tile_product<D>(acc, dsf, sK, lane);  // dQ_i += dS K_j
  }
  cp_async_wait<0>();
  store_rows<D>(dq + row_base * D, acc, r0, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sla_bwd_dkv_tc32_kernel(const int32_t* __restrict__ col_lut,
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
  using C = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sK = smem_u32(smem_raw), sV = sK + C::kTileBytes;
  const uint32_t sQD = sK + 2 * C::kTileBytes;  // stage st: Q_i, then dO_i
  const uint32_t sVec = sK + C::kVecOff;        // stage st: L_i, then D_i
  const float* vec_base =
      reinterpret_cast<const float*>(smem_raw + C::kVecOff);

  const int j = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = warp * 16;  // this warp's rows of the kv block
  const size_t kv_row = (size_t)(bh / group) * n + (size_t)j * kBlock;
  const int col_blk = bh * tn + j;
  int cnt = col_counts[col_blk];
  cnt = cnt < w_col ? cnt : w_col;
  const int32_t* lut_col = col_lut + (size_t)col_blk * w_col;
  const size_t q_head = (size_t)bh * n;

  auto load_qd = [&](int st, int i) {
    const size_t r = q_head + (size_t)i * kBlock;
    const uint32_t t = sQD + st * 2 * C::kTileBytes;
    load_tile<D>(t, q + r * D, tid);
    load_tile<D>(t + C::kTileBytes, dout + r * D, tid);
    if (tid < 16)  // 16-byte chunks: 8 of L_i, then 8 of D_i
      cp_async16(sVec + (st * 2 * kBlock) * 4 + tid * 16,
                 tid < 8 ? lse + r + tid * 4 : dsum + r + (tid - 8) * 4);
  };
  if (cnt > 0) {
    load_tile<D>(sK, k + kv_row * D, tid);
    load_tile<D>(sV, v + kv_row * D, tid);
  }
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {  // group st: stage st
    if (st < cnt) load_qd(st, lut_col[st]);
    cp_async_commit();
  }

  const float sl2 = scale * kLog2e;
  float acc_k[C::kNT][4], acc_v[C::kNT][4];
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  for (int s = 0; s < cnt; ++s) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    const int nx = s + C::kStages - 1;
    if (nx < cnt) load_qd(nx % C::kStages, lut_col[nx]);
    cp_async_commit();

    const int i = lut_col[s];
    const int st = s % C::kStages;
    const uint32_t sQ = sQD + st * 2 * C::kTileBytes;
    const uint32_t sDO = sQ + C::kTileBytes;
    const float* lv = vec_base + st * 2 * kBlock;  // L_i[32], then D_i[32]
    float sc[4][4], dp[4][4];
    scores<D>(sc, sK, r0, sQ, lane);   // S^T = K_j Q_i^T
    scores<D>(dp, sV, r0, sDO, lane);  // dP^T = V_j dO_i^T

    // P^T in place of S^T, dS^T in place of dP^T; L_i and D_i run along
    // the columns (query rows)
    const bool straddle = causal && (j * kBlock + kBlock - 1 > i * kBlock);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + c2 + (e & 1);
        float p = exp2f(sc[nt][e] * sl2 - lv[c] * kLog2e);
        if (straddle && i * kBlock + c < j * kBlock + r0 + g + 8 * (e >> 1))
          p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - lv[kBlock + c]) * scale;
        sc[nt][e] = p;
      }
    uint32_t pf[2][4], dsf[2][4];
    to_a(pf, sc);
    to_a(dsf, dp);
    tile_product<D>(acc_v, pf, sDO, lane);  // dV_j += P^T dO_i
    tile_product<D>(acc_k, dsf, sQ, lane);  // dK_j += dS^T Q_i
  }
  cp_async_wait<0>();
  const size_t out = ((size_t)bh * n + (size_t)j * kBlock) * D;
  store_rows<D>(dk + out, acc_k, r0, lane);
  store_rows<D>(dv + out, acc_v, r0, lane);
}

template <int D>
int launch_dq(const int32_t* lut, const int32_t* counts, const void* q,
              const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, float* dq, int bh_q,
              int bh_kv, int n, int k_sel, float scale, int causal,
              cudaStream_t stream) {
  auto kernel = sla_bwd_dq_tc32_kernel<D>;
  if (cudaError_t err = prepare(kernel, Cfg<D>::kSmemDq)) return (int)err;
  const int tm = n / kBlock;
  kernel<<<dim3(tm, bh_q), kThreads, Cfg<D>::kSmemDq, stream>>>(
      lut, counts, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dsum,
      dq, n, tm, k_sel, bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const int32_t* col_lut, const int32_t* col_counts,
               const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, float* dk, float* dv,
               int bh_q, int bh_kv, int n, int w_col, float scale,
               int causal, cudaStream_t stream) {
  auto kernel = sla_bwd_dkv_tc32_kernel<D>;
  if (cudaError_t err = prepare(kernel, Cfg<D>::kSmemDkv)) return (int)err;
  const int tn = n / kBlock;
  kernel<<<dim3(tn, bh_q), kThreads, Cfg<D>::kSmemDkv, stream>>>(
      col_lut, col_counts, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, dsum, dk, dv, n, tn, w_col,
      bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

int check_shape(int bh_q, int bh_kv, int n, int block_q, int block_kv) {
  return (block_q == kBlock && block_kv == kBlock && n > 0 &&
          n % kBlock == 0 && bh_kv > 0 && bh_q % bh_kv == 0)
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v and dout are bf16 with head dim d == 64 or 128 (the wrapper
// zero-pads other widths up to 128 to the next of them), q, dout, dq, dk,
// dv (bh_q, n, d), k and v (bh_kv, n, d), lse and dsum f32 (bh_q, n), the
// LUTs int32, block_q == block_kv == 32, every row 16-byte aligned.
// Returns a cudaError_t value (0 on success); each launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int sla_bwd_dq_tc32_launch(const int32_t* lut,
                                      const int32_t* counts, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* dsum, float* dq, int bh_q,
                                      int bh_kv, int n, int d, int k_sel,
                                      int block_q, int block_kv, float scale,
                                      int causal, void* stream) {
  if (int err = check_shape(bh_q, bh_kv, n, block_q, block_kv)) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(lut, counts, q, k, v, dout, lse, dsum, dq, bh_q,
                         bh_kv, n, k_sel, scale, causal, s);
  if (d == 128)
    return launch_dq<128>(lut, counts, q, k, v, dout, lse, dsum, dq, bh_q,
                          bh_kv, n, k_sel, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sla_bwd_dkv_tc32_launch(const int32_t* col_lut,
                                       const int32_t* col_counts,
                                       const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dsum,
                                       float* dk, float* dv, int bh_q,
                                       int bh_kv, int n, int d, int w_col,
                                       int block_q, int block_kv,
                                       float scale, int causal,
                                       void* stream) {
  if (int err = check_shape(bh_q, bh_kv, n, block_q, block_kv)) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(col_lut, col_counts, q, k, v, dout, lse, dsum, dk,
                          dv, bh_q, bh_kv, n, w_col, scale, causal, s);
  if (d == 128)
    return launch_dkv<128>(col_lut, col_counts, q, k, v, dout, lse, dsum, dk,
                           dv, bh_q, bh_kv, n, w_col, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of one kernel (0: dQ, 1: dK/dV) at head dim d (64 or 128) that fit
// on one SM of the current device at their launch attributes; a negative
// cudaError_t value on failure.
extern "C" int sla_bwd_tc32_ctas_per_sm(int dkv, int d) {
  if (d == 64)
    return dkv ? ctas_per_sm(sla_bwd_dkv_tc32_kernel<64>, Cfg<64>::kSmemDkv)
               : ctas_per_sm(sla_bwd_dq_tc32_kernel<64>, Cfg<64>::kSmemDq);
  if (d == 128)
    return dkv
               ? ctas_per_sm(sla_bwd_dkv_tc32_kernel<128>, Cfg<128>::kSmemDkv)
               : ctas_per_sm(sla_bwd_dq_tc32_kernel<128>, Cfg<128>::kSmemDq);
  return -(int)cudaErrorInvalidValue;
}

extern "C" const char* sla_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
