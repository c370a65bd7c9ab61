// SLA sparse-branch backward kernels for Hopper (sm_90a): dQ over the row
// LUT and dK, dV over the column LUT.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/sla_bwd.py (launched by `sla_bwd_dq`, `sla_bwd_dkv`).
// With P_ij = exp(S_ij * scale - L_i) recomputed from the forward's row
// log-sum-exp L (no N x N residual is kept), dP_ij = dO_i V_j^T and
// dS_ij = P_ij * (dP_ij - D_i) * scale, where D = rowsum(dO^s * O^s):
//   dQ_i  = sum over j in lut[bh,i,:counts]      of dS_ij K_j,
//   dK_j  = sum over i in col_lut[bh,j,:col_counts] of dS_ij^T Q_i,
//   dV_j  = sum over the same i                  of P_ij^T dO_i,
// per query head bh (K_j, V_j are read from kv head bh / group; the
// caller sums dK, dV over a GQA group). An optional causal mask zeroes P
// where the absolute row i * block_q + r is below the column
// j * block_kv + c. Inputs q, k, v are f32 or bf16; dO, L, D and all
// outputs are f32, and every sum is taken in f32.
//
// What bounds them. Per live tile the dQ kernel does three
// block_q x block_kv x D products (S, dP, dS K: 6 * bq * bkv * D
// operations) and the dK/dV kernel four (S, dP, P^T dO, dS^T Q); against
// one read of q, k, v, dO and one write of the gradients that is tens of
// operations per byte at the DiT shapes (D = 128, 64 x 64 blocks), so both
// are bound by arithmetic: 67 TFLOP/s of f32 FMA on CUDA cores in this
// version, not the 3.35 TB/s of device memory.
//
// What the design does about it. The TPU kernels carry their accumulators
// across a sequential grid axis in VMEM; here one thread block owns one
// output tile for its whole LUT walk, so the accumulators stay in
// registers and no sum crosses blocks (no atomics: the column-LUT form is
// deterministic and consumes the same plan as the forward). Each block
// reads its own LUT row and stops at its count, so padded slots are never
// read. Tiles are staged in shared memory in f32 with padded strides
// (D + 1, block + 1) so the inner products read without bank conflicts:
// K^T and V^T are stored transposed and serve both S / dP and, for dQ,
// the dS K product. Each of the 256 threads owns a 4 x 4 tile of the
// 64 x 64 scores and 4 x 8 tiles of the 64 x 128 accumulators (one for
// dQ, two for dK and dV). Shared memory (~130 KB for dQ, ~162 KB for
// dK/dV at D = 128) allows one block per SM, which leaves the dK/dV
// kernel its two accumulators in registers without spilling. The tensor
// cores (wgmma, TMA) are not used yet: that is the next step for speed.
//
// Head dims 129-256 (gemma3's 256-wide heads). Staged as above, a D-256
// tile set needs 265 KB (dQ) and 298 KB (dK/dV) of shared memory, past a
// block's 227 KB, and 8 columns a thread no longer cover the output. Of
// the two ways out (bf16 K^T / V^T stages with 16 columns a thread, as
// the forward's wide instantiation; or splitting the output columns over
// the grid) this takes the split, because it serves f32 operands too and
// keeps both the register tiles and the staging of D <= 128: the `wide`
// kernels below. gridDim.z = ceil(D / 128); block z owns head-dim columns
// [128 z, 128 z + 128) of dQ, or of dK and dV, with the same 4 x 8
// accumulators a thread. S and dP still need the full D, so each LUT step
// runs them in 128-column passes, staging one pass's K^T and V^T (and for
// dK/dV its Q and dO columns) at a time; the passes are ordered so that
// the block's own columns come last and stay staged for its product. That
// recomputes S and dP once per column half (about 10 / 6 of the dQ
// kernel's operations and 12 / 8 of the dK/dV kernel's at D 256) and
// re-reads K and V each LUT step from L2. dQ keeps Q and dO at full D for
// its whole walk: 198 KB at D 256 and 64 x 64 blocks; dK/dV stages 166
// KB. The summation order of S over the passes differs between the two
// halves, which changes no result beyond f32 rounding; each launch is
// deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;    // tile rows per thread: ty + 16 * r
constexpr int kCols = 4;    // kv columns per thread: tx + 16 * c
constexpr int kDCols = 8;   // head-dim columns per thread: tx + 16 * e
constexpr int kPassCols = 16 * kDCols;  // a wide block's output columns,
                                        // and the columns of one S pass
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlock = 64;  // the wrappers' largest block_q / block_kv
constexpr float kNegInf = -1e30f;  // the reference's masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Per-thread tile indices, clamped so that threads past a small tile read
// valid shared memory; their results are never stored.
struct TileIdx {
  int row[kRows];    // clamped tile row (query row for scores)
  bool row_ok[kRows];
  int col[kCols];    // clamped kv column
  bool col_ok[kCols];
  int dcol[kDCols];  // clamped head-dim column
  bool dcol_ok[kDCols];

  __device__ TileIdx(int ty, int tx, int rows, int cols, int d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row_ok[r] = ty + 16 * r < rows;
      row[r] = row_ok[r] ? ty + 16 * r : rows - 1;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      col_ok[c] = tx + 16 * c < cols;
      col[c] = col_ok[c] ? tx + 16 * c : cols - 1;
    }
#pragma unroll
    for (int e = 0; e < kDCols; ++e) {
      dcol_ok[e] = tx + 16 * e < d;
      dcol[e] = dcol_ok[e] ? tx + 16 * e : d - 1;
    }
  }
};

// Stage a block_kv x d tile of k or v transposed: sT[e * kts + c].
template <typename T>
__device__ __forceinline__ void stage_transposed(float* sT, const T* src,
                                                 int tile, int d, int kts,
                                                 int tid) {
  for (int idx = tid; idx < tile; idx += kThreads) {
    const int c = idx / d;
    sT[(idx - c * d) * kts + c] = to_f32(src[idx]);
  }
}

// Stage a block_q x d tile row-major with padded stride qs.
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, const T* src, int tile,
                                           int d, int qs, int tid) {
  for (int idx = tid; idx < tile; idx += kThreads) {
    const int r = idx / d;
    s[r * qs + (idx - r * d)] = to_f32(src[idx]);
  }
}

// Stage columns [c0, c0 + w) of a rows x d tile of k or v transposed:
// sT[e * kts + c].
template <typename T>
__device__ __forceinline__ void stage_cols_transposed(float* sT, const T* src,
                                                      int rows, int d, int c0,
                                                      int w, int kts,
                                                      int tid) {
  for (int idx = tid; idx < rows * w; idx += kThreads) {
    const int c = idx / w;
    const int e = idx - c * w;
    sT[e * kts + c] = to_f32(src[(size_t)c * d + c0 + e]);
  }
}

// Stage columns [c0, c0 + w) of a rows x d tile row-major with stride qs.
template <typename T>
__device__ __forceinline__ void stage_cols(float* s, const T* src, int rows,
                                           int d, int c0, int w, int qs,
                                           int tid) {
  for (int idx = tid; idx < rows * w; idx += kThreads) {
    const int r = idx / w;
    const int e = idx - r * w;
    s[r * qs + e] = to_f32(src[(size_t)r * d + c0 + e]);
  }
}

__device__ __forceinline__ void zero_tile(float (&x)[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) x[r][c] = 0.f;
}

// S += Q K^T and dP += dO V^T over d head-dim columns for this thread's
// 4 x 4 tile (sQ / sDO with row stride qs, sKT / sVT with stride kts).
__device__ __forceinline__ void score_products(
    const float* sQ, const float* sDO, const float* sKT, const float* sVT,
    const TileIdx& t, int d, int qs, int kts, float (&sc)[kRows][kCols],
    float (&dp)[kRows][kCols]) {
  for (int dd = 0; dd < d; ++dd) {
    float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qv[r] = sQ[t.row[r] * qs + dd];
      ov[r] = sDO[t.row[r] * qs + dd];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      kv[c] = sKT[dd * kts + t.col[c]];
      vv[c] = sVT[dd * kts + t.col[c]];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
}

// P and dS in place from the finished S and dP: sc <- P, dp <- dS.
// lse / dsum are this thread's rows' L and D; row0 / col0 are the tile's
// absolute first row and column.
__device__ __forceinline__ void grads_from_scores(
    const TileIdx& t, const float (&lse)[kRows], const float (&dsum)[kRows],
    float scale, int causal, int row0, int col0, float (&sc)[kRows][kCols],
    float (&dp)[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float x = sc[r][c] * scale;
      if (causal && row0 + t.row[r] < col0 + t.col[c]) x = kNegInf;
      const float p = expf(x - lse[r]);
      sc[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dsum[r]) * scale;
    }
}

// S = Q K^T and dP = dO V^T for this thread's 4 x 4 tile, then P and dS in
// place: sc <- P, dp <- dS.
__device__ __forceinline__ void scores_to_grads(
    const float* sQ, const float* sDO, const float* sKT, const float* sVT,
    const TileIdx& t, int d, int qs, int kts, const float (&lse)[kRows],
    const float (&dsum)[kRows], float scale, int causal, int row0, int col0,
    float (&sc)[kRows][kCols], float (&dp)[kRows][kCols]) {
  zero_tile(sc);
  zero_tile(dp);
  score_products(sQ, sDO, sKT, sVT, t, d, qs, kts, sc, dp);
  grads_from_scores(t, lse, dsum, scale, causal, row0, col0, sc, dp);
}

size_t dq_smem_floats(int d, int block_q, int block_kv) {
  // Q + dO tiles, K^T, then V^T (reused for dS, block_q x (block_kv + 1))
  const int kts = block_kv + 1;
  return 2 * (size_t)block_q * (d + 1) + (size_t)d * kts +
         (size_t)(d > block_q ? d : block_q) * kts;
}

size_t dkv_smem_floats(int d, int block_q, int block_kv) {
  // K^T + V^T (whole walk), Q + dO tiles, P + dS tiles
  const int kts = block_kv + 1;
  return 2 * (size_t)d * kts + 2 * (size_t)block_q * (d + 1) +
         2 * (size_t)block_q * kts;
}

size_t dq_wide_smem_floats(int d, int block_q, int block_kv) {
  // Q + dO tiles at full D, one pass's K^T, then its V^T (reused for dS)
  return 2 * (size_t)block_q * (d + 1) +
         2 * (size_t)kPassCols * (block_kv + 1);
}

size_t dkv_wide_smem_floats(int block_q, int block_kv) {
  // one pass's K^T + V^T, one pass's Q + dO columns, P + dS tiles
  const int kts = block_kv + 1;
  return 2 * (size_t)kPassCols * kts +
         2 * (size_t)block_q * (kPassCols + 1) + 2 * (size_t)block_q * kts;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sla_bwd_dq_kernel(const int32_t* __restrict__ lut,
                      const int32_t* __restrict__ counts,
                      const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      float* __restrict__ dq, int n, int d, int tm,
                      int k_sel, int group, int block_q, int block_kv,
                      float scale, int causal) {
  extern __shared__ float smem[];
  const int qs = d + 1;          // Q / dO tile stride (padded)
  const int kts = block_kv + 1;  // K^T / V^T / dS stride (padded)
  float* sQ = smem;                  // block_q x qs
  float* sDO = sQ + block_q * qs;    // block_q x qs
  float* sKT = sDO + block_q * qs;   // d x kts
  float* sVT = sKT + d * kts;        // d x kts, then dS (block_q x kts)
  float* sDS = sVT;

  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const TileIdx t(ty, tx, block_q, block_kv, d);

  const size_t row_base = (size_t)bh * n + (size_t)i * block_q;
  stage_rows(sQ, q + row_base * d, block_q * d, d, qs, tid);
  stage_rows(sDO, dout + row_base * d, block_q * d, d, qs, tid);
  float lse_r[kRows], dsum_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    lse_r[r] = lse[row_base + t.row[r]];
    dsum_r[r] = dsum[row_base + t.row[r]];
  }

  float acc[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kDCols; ++e) acc[r][e] = 0.f;

  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_head = (size_t)(bh / group) * n * d;
  const int tile = block_kv * d;

  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    __syncthreads();  // Q, dO staged; the previous step is done with sKT/sDS
    stage_transposed(sKT, k + kv_head + (size_t)j * tile, tile, d, kts, tid);
    stage_transposed(sVT, v + kv_head + (size_t)j * tile, tile, d, kts, tid);
    __syncthreads();

    float p[kRows][kCols], ds[kRows][kCols];
    scores_to_grads(sQ, sDO, sKT, sVT, t, d, qs, kts, lse_r, dsum_r, scale,
                    causal, i * block_q, j * block_kv, p, ds);
    __syncthreads();  // V_j^T fully read: its buffer takes dS
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (t.row_ok[r] && t.col_ok[c]) sDS[t.row[r] * kts + t.col[c]] = ds[r][c];
    __syncthreads();

    // dQ_i += dS K_j, with K_j[c][e] = sKT[e * kts + c]
    for (int c = 0; c < block_kv; ++c) {
      float dv[kRows], kv[kDCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dv[r] = sDS[t.row[r] * kts + c];
#pragma unroll
      for (int e = 0; e < kDCols; ++e) kv[e] = sKT[t.dcol[e] * kts + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kDCols; ++e)
          acc[r][e] = fmaf(dv[r], kv[e], acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!t.row_ok[r]) continue;
    float* out = dq + (row_base + t.row[r]) * d;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (t.dcol_ok[e]) out[t.dcol[e]] = acc[r][e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sla_bwd_dkv_kernel(const int32_t* __restrict__ col_lut,
                       const int32_t* __restrict__ col_counts,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int n, int d, int tn, int w_col, int group,
                       int block_q, int block_kv, float scale, int causal) {
  extern __shared__ float smem[];
  const int qs = d + 1;          // Q / dO tile stride (padded)
  const int kts = block_kv + 1;  // K^T / V^T / P / dS stride (padded)
  float* sKT = smem;                 // d x kts, for the whole walk
  float* sVT = sKT + d * kts;        // d x kts, for the whole walk
  float* sQ = sVT + d * kts;         // block_q x qs
  float* sDO = sQ + block_q * qs;    // block_q x qs
  float* sP = sDO + block_q * qs;    // block_q x kts
  float* sDS = sP + block_q * kts;   // block_q x kts

  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const TileIdx t(ty, tx, block_q, block_kv, d);  // score tile
  // accumulator rows: kv rows ty + 16 * r of the block_kv x d tile
  int kvrow[kRows];
  bool kvrow_ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    kvrow_ok[r] = ty + 16 * r < block_kv;
    kvrow[r] = kvrow_ok[r] ? ty + 16 * r : block_kv - 1;
  }

  const int tile = block_kv * d;
  const size_t kv_off = (size_t)(bh / group) * n * d + (size_t)j * tile;
  stage_transposed(sKT, k + kv_off, tile, d, kts, tid);
  stage_transposed(sVT, v + kv_off, tile, d, kts, tid);

  float acc_k[kRows][kDCols], acc_v[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kDCols; ++e) acc_k[r][e] = acc_v[r][e] = 0.f;

  const int col_blk = bh * tn + j;
  int cnt = col_counts[col_blk];
  cnt = cnt < w_col ? cnt : w_col;
  const int32_t* lut_col = col_lut + (size_t)col_blk * w_col;

  for (int s = 0; s < cnt; ++s) {
    const int i = lut_col[s];
    const size_t row_base = (size_t)bh * n + (size_t)i * block_q;
    __syncthreads();  // K^T, V^T staged; the previous step is done
    stage_rows(sQ, q + row_base * d, block_q * d, d, qs, tid);
    stage_rows(sDO, dout + row_base * d, block_q * d, d, qs, tid);
    float lse_r[kRows], dsum_r[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      lse_r[r] = lse[row_base + t.row[r]];
      dsum_r[r] = dsum[row_base + t.row[r]];
    }
    __syncthreads();

    float p[kRows][kCols], ds[kRows][kCols];
    scores_to_grads(sQ, sDO, sKT, sVT, t, d, qs, kts, lse_r, dsum_r, scale,
                    causal, i * block_q, j * block_kv, p, ds);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (t.row_ok[r] && t.col_ok[c]) {
          sP[t.row[r] * kts + t.col[c]] = p[r][c];
          sDS[t.row[r] * kts + t.col[c]] = ds[r][c];
        }
    __syncthreads();

    // dV_j += P^T dO_i, dK_j += dS^T Q_i over the block_q query rows
    for (int qr = 0; qr < block_q; ++qr) {
      float pv[kRows], dsv[kRows], ov[kDCols], qv[kDCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pv[r] = sP[qr * kts + kvrow[r]];
        dsv[r] = sDS[qr * kts + kvrow[r]];
      }
#pragma unroll
      for (int e = 0; e < kDCols; ++e) {
        ov[e] = sDO[qr * qs + t.dcol[e]];
        qv[e] = sQ[qr * qs + t.dcol[e]];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kDCols; ++e) {
          acc_v[r][e] = fmaf(pv[r], ov[e], acc_v[r][e]);
          acc_k[r][e] = fmaf(dsv[r], qv[e], acc_k[r][e]);
        }
    }
  }

  const size_t out_base = (size_t)bh * n + (size_t)j * block_kv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!kvrow_ok[r]) continue;
    const size_t off = (out_base + kvrow[r]) * d;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (t.dcol_ok[e]) {
        dk[off + t.dcol[e]] = acc_k[r][e];
        dv[off + t.dcol[e]] = acc_v[r][e];
      }
  }
}

// dQ at head dims 129-256: block (i, bh, z) owns dQ's head-dim columns
// [128 z, 128 z + 128) of query block i (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sla_bwd_dq_wide_kernel(const int32_t* __restrict__ lut,
                           const int32_t* __restrict__ counts,
                           const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ dq, int n, int d, int tm,
                           int k_sel, int group, int block_q, int block_kv,
                           float scale, int causal) {
  extern __shared__ float smem[];
  const int qs = d + 1;          // Q / dO tile stride (padded)
  const int kts = block_kv + 1;  // K^T / V^T / dS stride (padded)
  float* sQ = smem;                   // block_q x qs
  float* sDO = sQ + block_q * qs;     // block_q x qs
  float* sKT = sDO + block_q * qs;    // kPassCols x kts: a pass's K^T
  float* sVT = sKT + kPassCols * kts; // kPassCols x kts, then dS
  float* sDS = sVT;

  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int npass = gridDim.z;
  const int own = blockIdx.z * kPassCols;  // this block's first dQ column
  const int own_w = min(kPassCols, d - own);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const TileIdx t(ty, tx, block_q, block_kv, own_w);

  const size_t row_base = (size_t)bh * n + (size_t)i * block_q;
  stage_rows(sQ, q + row_base * d, block_q * d, d, qs, tid);
  stage_rows(sDO, dout + row_base * d, block_q * d, d, qs, tid);
  float lse_r[kRows], dsum_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    lse_r[r] = lse[row_base + t.row[r]];
    dsum_r[r] = dsum[row_base + t.row[r]];
  }

  float acc[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kDCols; ++e) acc[r][e] = 0.f;

  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_head = (size_t)(bh / group) * n * d;

  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    const T* kj = k + kv_head + (size_t)j * block_kv * d;
    const T* vj = v + kv_head + (size_t)j * block_kv * d;
    float p[kRows][kCols], ds[kRows][kCols];
    zero_tile(p);
    zero_tile(ds);
    for (int pass = 1; pass <= npass; ++pass) {
      // the other columns first, this block's own last: its K^T stays
      const int c0 = (blockIdx.z + pass) % npass * kPassCols;
      const int w = min(kPassCols, d - c0);
      __syncthreads();  // Q, dO staged; the last pass or step is done
      stage_cols_transposed(sKT, kj, block_kv, d, c0, w, kts, tid);
      stage_cols_transposed(sVT, vj, block_kv, d, c0, w, kts, tid);
      __syncthreads();
      score_products(sQ + c0, sDO + c0, sKT, sVT, t, w, qs, kts, p, ds);
    }
    grads_from_scores(t, lse_r, dsum_r, scale, causal, i * block_q,
                      j * block_kv, p, ds);
    __syncthreads();  // V_j^T fully read: its buffer takes dS
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (t.row_ok[r] && t.col_ok[c]) sDS[t.row[r] * kts + t.col[c]] = ds[r][c];
    __syncthreads();

    // dQ_i[:, own..] += dS K_j[:, own..], K_j^T's own columns staged
    for (int c = 0; c < block_kv; ++c) {
      float dv[kRows], kv[kDCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dv[r] = sDS[t.row[r] * kts + c];
#pragma unroll
      for (int e = 0; e < kDCols; ++e) kv[e] = sKT[t.dcol[e] * kts + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kDCols; ++e)
          acc[r][e] = fmaf(dv[r], kv[e], acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!t.row_ok[r]) continue;
    float* out = dq + (row_base + t.row[r]) * d + own;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (t.dcol_ok[e]) out[t.dcol[e]] = acc[r][e];
  }
}

// dK / dV at head dims 129-256: block (j, bh, z) owns the head-dim
// columns [128 z, 128 z + 128) of kv block j's dK and dV (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sla_bwd_dkv_wide_kernel(const int32_t* __restrict__ col_lut,
                            const int32_t* __restrict__ col_counts,
                            const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int n, int d, int tn, int w_col, int group,
                            int block_q, int block_kv, float scale,
                            int causal) {
  extern __shared__ float smem[];
  const int qs = kPassCols + 1;  // a pass's Q / dO stride (padded)
  const int kts = block_kv + 1;  // K^T / V^T / P / dS stride (padded)
  float* sKT = smem;                   // kPassCols x kts: a pass's K^T
  float* sVT = sKT + kPassCols * kts;  // kPassCols x kts
  float* sQ = sVT + kPassCols * kts;   // block_q x qs: a pass's Q columns
  float* sDO = sQ + block_q * qs;      // block_q x qs
  float* sP = sDO + block_q * qs;      // block_q x kts
  float* sDS = sP + block_q * kts;     // block_q x kts

  const int j = blockIdx.x;
  const int bh = blockIdx.y;
  const int npass = gridDim.z;
  const int own = blockIdx.z * kPassCols;  // this block's first column
  const int own_w = min(kPassCols, d - own);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const TileIdx t(ty, tx, block_q, block_kv, own_w);  // score tile
  // accumulator rows: kv rows ty + 16 * r of the block_kv x own_w tile
  int kvrow[kRows];
  bool kvrow_ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    kvrow_ok[r] = ty + 16 * r < block_kv;
    kvrow[r] = kvrow_ok[r] ? ty + 16 * r : block_kv - 1;
  }

  const size_t kv_off =
      (size_t)(bh / group) * n * d + (size_t)j * block_kv * d;
  float acc_k[kRows][kDCols], acc_v[kRows][kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < kDCols; ++e) acc_k[r][e] = acc_v[r][e] = 0.f;

  const int col_blk = bh * tn + j;
  int cnt = col_counts[col_blk];
  cnt = cnt < w_col ? cnt : w_col;
  const int32_t* lut_col = col_lut + (size_t)col_blk * w_col;

  for (int s = 0; s < cnt; ++s) {
    const int i = lut_col[s];
    const size_t row_base = (size_t)bh * n + (size_t)i * block_q;
    float lse_r[kRows], dsum_r[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      lse_r[r] = lse[row_base + t.row[r]];
      dsum_r[r] = dsum[row_base + t.row[r]];
    }
    float p[kRows][kCols], ds[kRows][kCols];
    zero_tile(p);
    zero_tile(ds);
    for (int pass = 1; pass <= npass; ++pass) {
      // the other columns first, this block's own last: they stay staged
      const int c0 = (blockIdx.z + pass) % npass * kPassCols;
      const int w = min(kPassCols, d - c0);
      __syncthreads();  // the last pass or step is done with the stages
      stage_cols_transposed(sKT, k + kv_off, block_kv, d, c0, w, kts, tid);
      stage_cols_transposed(sVT, v + kv_off, block_kv, d, c0, w, kts, tid);
      stage_cols(sQ, q + row_base * d, block_q, d, c0, w, qs, tid);
      stage_cols(sDO, dout + row_base * d, block_q, d, c0, w, qs, tid);
      __syncthreads();
      score_products(sQ, sDO, sKT, sVT, t, w, qs, kts, p, ds);
    }
    grads_from_scores(t, lse_r, dsum_r, scale, causal, i * block_q,
                      j * block_kv, p, ds);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (t.row_ok[r] && t.col_ok[c]) {
          sP[t.row[r] * kts + t.col[c]] = p[r][c];
          sDS[t.row[r] * kts + t.col[c]] = ds[r][c];
        }
    __syncthreads();

    // dV_j += P^T dO_i, dK_j += dS^T Q_i on this block's own columns
    for (int qr = 0; qr < block_q; ++qr) {
      float pv[kRows], dsv[kRows], ov[kDCols], qv[kDCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pv[r] = sP[qr * kts + kvrow[r]];
        dsv[r] = sDS[qr * kts + kvrow[r]];
      }
#pragma unroll
      for (int e = 0; e < kDCols; ++e) {
        ov[e] = sDO[qr * qs + t.dcol[e]];
        qv[e] = sQ[qr * qs + t.dcol[e]];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kDCols; ++e) {
          acc_v[r][e] = fmaf(pv[r], ov[e], acc_v[r][e]);
          acc_k[r][e] = fmaf(dsv[r], qv[e], acc_k[r][e]);
        }
    }
  }

  const size_t out_base = (size_t)bh * n + (size_t)j * block_kv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!kvrow_ok[r]) continue;
    const size_t off = (out_base + kvrow[r]) * d + own;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (t.dcol_ok[e]) {
        dk[off + t.dcol[e]] = acc_k[r][e];
        dv[off + t.dcol[e]] = acc_v[r][e];
      }
  }
}

// The wide kernels' shared-memory opt-in, set once per instantiation for
// the largest stage they take (D 256, 64 x 64 blocks): 198 KB / 166 KB.
template <typename T>
cudaError_t allow_dq_wide() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dq_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(dq_wide_smem_floats(kMaxHeadDim, kMaxBlock, kMaxBlock) *
            sizeof(float)));
  return err;
}

template <typename T>
cudaError_t allow_dkv_wide() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dkv_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(dkv_wide_smem_floats(kMaxBlock, kMaxBlock) * sizeof(float)));
  return err;
}

template <typename T>
int launch_dq(const int32_t* lut, const int32_t* counts, const void* q,
              const void* k, const void* v, const float* dout,
              const float* lse, const float* dsum, float* dq, int bh_q,
              int n, int d, int k_sel, int group, int block_q, int block_kv,
              float scale, int causal, cudaStream_t stream) {
  const int tm = n / block_q;
  if (d > kMaxHeadDim || block_q > kMaxBlock || block_kv > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  if (d > kPassCols) {
    cudaError_t err = allow_dq_wide<T>();
    if (err != cudaSuccess) return (int)err;
    sla_bwd_dq_wide_kernel<T><<<dim3(tm, bh_q, (d + kPassCols - 1) /
                                                  kPassCols),
                                kThreads,
                                dq_wide_smem_floats(d, block_q, block_kv) *
                                    sizeof(float),
                                stream>>>(
        lut, counts, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), dout, lse, dsum, dq, n, d, tm, k_sel,
        group, block_q, block_kv, scale, causal);
    return (int)cudaGetLastError();
  }
  const size_t smem = dq_smem_floats(d, block_q, block_kv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sla_bwd_dq_kernel<T><<<dim3(tm, bh_q), kThreads, smem, stream>>>(
      lut, counts, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, lse, dsum, dq, n, d, tm, k_sel, group,
      block_q, block_kv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const int32_t* col_lut, const int32_t* col_counts,
               const void* q, const void* k, const void* v,
               const float* dout, const float* lse, const float* dsum,
               float* dk, float* dv, int bh_q, int n, int d, int w_col,
               int group, int block_q, int block_kv, float scale, int causal,
               cudaStream_t stream) {
  const int tn = n / block_kv;
  if (d > kMaxHeadDim || block_q > kMaxBlock || block_kv > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  if (d > kPassCols) {
    cudaError_t err = allow_dkv_wide<T>();
    if (err != cudaSuccess) return (int)err;
    sla_bwd_dkv_wide_kernel<T><<<dim3(tn, bh_q, (d + kPassCols - 1) /
                                                   kPassCols),
                                 kThreads,
                                 dkv_wide_smem_floats(block_q, block_kv) *
                                     sizeof(float),
                                 stream>>>(
        col_lut, col_counts, static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v), dout, lse, dsum,
        dk, dv, n, d, tn, w_col, group, block_q, block_kv, scale, causal);
    return (int)cudaGetLastError();
  }
  const size_t smem = dkv_smem_floats(d, block_q, block_kv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sla_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sla_bwd_dkv_kernel<T><<<dim3(tn, bh_q), kThreads, smem, stream>>>(
      col_lut, col_counts, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), dout, lse, dsum,
      dk, dv, n, d, tn, w_col, group, block_q, block_kv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); q, dout, dq, dk, dv
// are (bh_q, n, d), k and v (bh_kv, n, d), lse and dsum (bh_q, n); the
// LUTs are int32; d <= 256 (above 128 the wide kernels), blocks <= 64.
// Returns a cudaError_t value (0 on success). Each launch is asynchronous
// on `stream` and allocates nothing.
extern "C" int sla_bwd_dq_launch(const int32_t* lut, const int32_t* counts,
                                 const void* q, const void* k, const void* v,
                                 const float* dout, const float* lse,
                                 const float* dsum, float* dq, int bh_q,
                                 int bh_kv, int n, int d, int k_sel,
                                 int block_q, int block_kv, float scale,
                                 int causal, int is_bf16, void* stream) {
  const int group = bh_q / bh_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq<__nv_bfloat16>(lut, counts, q, k, v, dout, lse, dsum, dq,
                                    bh_q, n, d, k_sel, group, block_q,
                                    block_kv, scale, causal, st);
  return launch_dq<float>(lut, counts, q, k, v, dout, lse, dsum, dq, bh_q, n,
                          d, k_sel, group, block_q, block_kv, scale, causal,
                          st);
}

extern "C" int sla_bwd_dkv_launch(const int32_t* col_lut,
                                  const int32_t* col_counts, const void* q,
                                  const void* k, const void* v,
                                  const float* dout, const float* lse,
                                  const float* dsum, float* dk, float* dv,
                                  int bh_q, int bh_kv, int n, int d,
                                  int w_col, int block_q, int block_kv,
                                  float scale, int causal, int is_bf16,
                                  void* stream) {
  const int group = bh_q / bh_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dkv<__nv_bfloat16>(col_lut, col_counts, q, k, v, dout, lse,
                                     dsum, dk, dv, bh_q, n, d, w_col, group,
                                     block_q, block_kv, scale, causal, st);
  return launch_dkv<float>(col_lut, col_counts, q, k, v, dout, lse, dsum, dk,
                           dv, bh_q, n, d, w_col, group, block_q, block_kv,
                           scale, causal, st);
}

extern "C" const char* sla_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
