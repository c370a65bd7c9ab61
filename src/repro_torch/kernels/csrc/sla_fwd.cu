// Fused SLA forward kernel for Hopper (sm_90a): sparse softmax over the
// critical KV blocks of each query block, plus the linear-branch merge.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// src/repro/kernels/sla_fwd.py (launched by `sla_fwd`). For each
// (batch*head bh, query block i) it computes
//   O^s_i = softmax(Q_i K_J^T * scale) V_J   over the counts[bh,i] critical
//           blocks J = lut[bh,i,:counts], online (running max m, sum l, acc),
//   lse_i = m + log l,
//   O^l_i = phi(Q_i) H_i / (phi(Q_i) Z_i), zero where the denominator is
//           <= 1e-6, from the pre-aggregated marginal state (H_i, Z_i).
// An optional causal mask uses absolute rows (base + i) * block_q + r, and
// GQA maps q head bh to kv head bh / group.
//
// What bounds it. At the DiT shapes (D = 128, 64 x 64 blocks, ~5% critical
// blocks) the sparse softmax does 4 * block_q * block_kv * D operations per
// live block, against one read of q, qp, k, v, hi and one write of o_s, o_l:
// about 24 operations per byte in f32, so the kernel is bound by arithmetic
// (67 TFLOP/s of f32 FMA on CUDA cores in this version), not by the
// 3.35 TB/s of device memory.
//
// What the design does about it. The TPU kernel walks the LUT as a
// sequential grid axis with its running state in VMEM scratch; here one
// thread block owns one query tile for the whole walk, so the running
// state never leaves registers and the Q tile is staged in shared memory
// once. The block reads its own LUT row and stops at counts[bh,i]: padded
// LUT slots are never read. K_j is staged transposed and V_j row-major in
// one reused shared buffer, with padded strides so the inner products read
// shared memory without bank conflicts; each of the 256 threads owns a
// 4 x 4 tile of the 64 x 64 scores and a 4 x 8 tile of the 64 x 128
// accumulator, with row reductions done by warp shuffles inside 16-lane
// groups. Tiles are kept in f32 whatever the input type (about 82 KB of
// shared memory at D = 128), so two blocks fit on an SM. It takes the
// calls the tensor-core kernels do not (blocks other than 64 x 64): at
// 64 x 64 blocks and D <= 128, f32 runs on sla_fwd_split.cu and bf16 on
// sla_fwd_tc.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;    // query rows per thread: ty + 16 * r
constexpr int kCols = 4;    // kv columns per thread: tx + 16 * c
constexpr int kDCols = 8;   // head-dim columns per thread: tx + 16 * e
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_floats(int d, int block_q, int block_kv) {
  // Q tile + (K^T tile, reused for V) + P tile + Z row
  return (size_t)block_q * (d + 1) + (size_t)d * (block_kv + 1) +
         (size_t)block_q * (block_kv + 1) + d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    sla_fwd_kernel(const int32_t* __restrict__ lut,
                   const int32_t* __restrict__ counts, int base,
                   const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ qp,
                   const float* __restrict__ hi,
                   const float* __restrict__ zi, float* __restrict__ o_s,
                   float* __restrict__ o_l, float* __restrict__ lse, int nq,
                   int nkv, int d, int tm, int k_sel, int group,
                   int block_q, int block_kv, float scale, int causal) {
  extern __shared__ float smem[];
  const float neg_inf = __int_as_float(0xff800000);
  const int qs = d + 1;         // Q / phi(Q) tile stride (padded)
  const int kts = block_kv + 1;  // K^T tile stride (padded)
  const int ps = block_kv + 1;   // P tile stride (padded)
  float* sQ = smem;                    // block_q x qs
  float* sKV = sQ + block_q * qs;      // K_j^T (d x kts), then V_j
  float* sP = sKV + d * kts;           // block_q x ps
  float* sZ = sP + block_q * ps;       // d, finalize only

  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  // Per-thread row / column indices, clamped so that threads past a
  // small tile read valid shared memory; their results are never stored.
  int rowq[kRows], rowp[kRows], colk[kCols], cold[kDCols];
  bool row_ok[kRows], colk_ok[kCols], cold_ok[kDCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + 16 * r;
    row_ok[r] = row < block_q;
    const int rc = row_ok[r] ? row : block_q - 1;
    rowq[r] = rc * qs;
    rowp[r] = rc * ps;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = tx + 16 * c;
    colk_ok[c] = col < block_kv;
    colk[c] = colk_ok[c] ? col : block_kv - 1;
  }
#pragma unroll
  for (int e = 0; e < kDCols; ++e) {
    const int col = tx + 16 * e;
    cold_ok[e] = col < d;
    cold[e] = cold_ok[e] ? col : d - 1;
  }

  const size_t q_off = ((size_t)bh * nq + (size_t)i * block_q) * d;
  for (int idx = tid; idx < block_q * d; idx += kThreads) {
    const int r = idx / d;
    sQ[r * qs + (idx - r * d)] = to_f32(q[q_off + idx]);
  }

  float acc[kRows][kDCols];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDCols; ++e) acc[r][e] = 0.f;
  }

  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_head = (size_t)kvh * nkv * d;
  const int tile = block_kv * d;

  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    const T* kj = k + kv_head + (size_t)j * tile;
    const T* vj = v + kv_head + (size_t)j * tile;
    __syncthreads();  // Q staged; the previous step is done with sKV / sP
    for (int idx = tid; idx < tile; idx += kThreads) {
      const int c = idx / d;
      sKV[(idx - c * d) * kts + c] = to_f32(kj[idx]);
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sQ[rowq[r] + dd];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = sKV[dd * kts + colk[c]];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row_abs = (base + i) * block_q + ty + 16 * r;
      float mx = neg_inf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float x = sc[r][c] * scale;
        if (causal && row_abs < j * block_kv + tx + 16 * c) x = kNegInf;
        if (!colk_ok[c]) x = neg_inf;  // outside the kv tile
        sc[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[r], group16_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(sc[r][c] - m_new);
        sc[r][c] = p;
        rs += p;
      }
      l_run[r] = l_run[r] * alpha + group16_sum(rs);
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < kDCols; ++e) acc[r][e] *= alpha;
      if (row_ok[r]) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (colk_ok[c]) sP[rowp[r] + tx + 16 * c] = sc[r][c];
      }
    }
    __syncthreads();  // K_j^T fully read; P complete
    for (int idx = tid; idx < tile; idx += kThreads)
      sKV[idx] = to_f32(vj[idx]);
    __syncthreads();

    for (int c = 0; c < block_kv; ++c) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = sP[rowp[r] + c];
#pragma unroll
      for (int e = 0; e < kDCols; ++e) vv[e] = sKV[c * d + cold[e]];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kDCols; ++e)
          acc[r][e] = fmaf(pv[r], vv[e], acc[r][e]);
    }
  }

  // Sparse finalize: o_s = acc / l, lse = m + log l (l > 0: the diagonal
  // block is forced critical, so every row has a live block).
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!row_ok[r]) continue;
    const size_t row_off = q_off + (size_t)(ty + 16 * r) * d;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (cold_ok[e]) o_s[row_off + tx + 16 * e] = acc[r][e] / l_run[r];
    if (tx == 0)
      lse[(size_t)bh * nq + (size_t)i * block_q + ty + 16 * r] =
          m_run[r] + logf(l_run[r]);
  }

  // Linear branch: num = phi(Q_i) H_i, den = phi(Q_i) Z_i, with H_i read
  // straight from global memory (coalesced along the head dim).
  __syncthreads();  // everyone is done with sQ / sKV
  for (int idx = tid; idx < block_q * d; idx += kThreads) {
    const int r = idx / d;
    sQ[r * qs + (idx - r * d)] = qp[q_off + idx];
  }
  for (int idx = tid; idx < d; idx += kThreads)
    sZ[idx] = zi[(size_t)row_blk * d + idx];
  __syncthreads();

  const float* hi_blk = hi + (size_t)row_blk * d * d;
  float num[kRows][kDCols], den[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    den[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDCols; ++e) num[r][e] = 0.f;
  }
  for (int dd = 0; dd < d; ++dd) {
    float qv[kRows], hv[kDCols];
    const float z = sZ[dd];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qv[r] = sQ[rowq[r] + dd];
      den[r] = fmaf(qv[r], z, den[r]);
    }
#pragma unroll
    for (int e = 0; e < kDCols; ++e) hv[e] = hi_blk[(size_t)dd * d + cold[e]];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < kDCols; ++e)
        num[r][e] = fmaf(qv[r], hv[e], num[r][e]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!row_ok[r]) continue;
    const size_t row_off = q_off + (size_t)(ty + 16 * r) * d;
    const bool live = den[r] > kEps;
#pragma unroll
    for (int e = 0; e < kDCols; ++e)
      if (cold_ok[e])
        o_l[row_off + tx + 16 * e] = live ? num[r][e] / den[r] : 0.f;
  }
}

template <typename T>
int launch(const int32_t* lut, const int32_t* counts, int base,
           const void* q, const void* k, const void* v, const float* qp,
           const float* hi, const float* zi, float* o_s, float* o_l,
           float* lse, int bh_q, int nq, int nkv, int d, int tm, int k_sel,
           int group, int block_q, int block_kv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_floats(d, block_q, block_kv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sla_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tm, bh_q);
  sla_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      lut, counts, base, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), qp, hi, zi, o_s,
      o_l, lse, nq, nkv, d, tm, k_sel, group, block_q, block_kv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); everything else is
// f32 / int32. Returns a cudaError_t value (0 on success). The launch is
// asynchronous on `stream` and allocates nothing.
extern "C" int sla_fwd_launch(const int32_t* lut, const int32_t* counts,
                              int base, const void* q, const void* k,
                              const void* v, const float* qp,
                              const float* hi, const float* zi, float* o_s,
                              float* o_l, float* lse, int bh_q, int bh_kv,
                              int nq, int nkv, int d, int tm, int k_sel,
                              int block_q, int block_kv, float scale,
                              int causal, int is_bf16, void* stream) {
  const int group = bh_q / bh_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(lut, counts, base, q, k, v, qp, hi, zi,
                                 o_s, o_l, lse, bh_q, nq, nkv, d, tm, k_sel,
                                 group, block_q, block_kv, scale, causal, st);
  return launch<float>(lut, counts, base, q, k, v, qp, hi, zi, o_s, o_l,
                       lse, bh_q, nq, nkv, d, tm, k_sel, group, block_q,
                       block_kv, scale, causal, st);
}

extern "C" const char* sla_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
