// Fused SLA decode kernels for Hopper (sm_90a): for each decode token, the
// sparse softmax over the live plan row's critical KV blocks plus the
// subtractive linear branch against the running H/Z state.
//
// Replaces two Pallas TPU kernels with one templated body:
//   `_decode_kernel` in src/repro/kernels/sla_decode.py:52 (launched by
//   `_fused_decode`, :172): monolithic per-slot K/V/hblk/zblk;
//   `_decode_kernel_paged` in src/repro/kernels/sla_decode.py:181
//   (launched by `_fused_decode_paged`, :255): K/V/hblk/zblk read from the
//   global page pools at page pt[b, j] for logical block j of slot b.
// For each (batch*head bh, chunk token c) at position p = pos[bh] + c it
// computes, over the cnt[bh,c] blocks J = lut[bh,c,:cnt]:
//   O^s = softmax(q K_J^T * scale) V_J   with columns j*bkv + t <= p,
//         online (running max m, sum l, acc); zero when no block is live;
//   O^l = phi(q) (Htot - sum_J H_j) / (phi(q) (Ztot - sum_J Z_j)), zero
//         where marg[bh,c] == 0 or the denominator is <= 1e-6,
// where H_j, Z_j are the per-block linear states hblk/zblk, except that
// the in-flight diagonal block j == p / bkv reads the per-token partials
// hdiag/zdiag when they are given (null for live-row decode, where the
// partial IS the stored block, so the kernel reads hblk/zblk in place).
// Htot/Ztot are per-token snapshots or one running total per kv head.
// GQA maps q head bh to kv head bh / group. K/V are f32 or bf16, turned
// into f32 as they load; everything accumulates in f32.
//
// What bounds it. Per token the kernel reads, for each selected block, a
// bkv x D tile each of K and V and a D x D f32 hblk tile (64 KB at D 128:
// twice a bf16 K+V tile pair) and does ~4 bkv D + 2 D^2 operations: about
// one operation per byte, so device memory bounds it. At the Qwen3-1.7B
// decode shape (B 2, H 16, Hkv 8, D 128, bkv 64, K 26 of Tn 512) one
// layer's step streams ~40-80 MB (each (kv head, block) that a q head of
// its group selects), 12-24 us at 3.35 TB/s.
//
// What the design does about it. The TPU kernel walks the LUT as a
// sequential grid axis with its softmax state and a D x D hsel sum in VMEM
// scratch. Here one 256-thread block owns one (bh, c) for the whole walk:
// it reads its own LUT row, stops at cnt (padded slots are never read),
// and keeps m, l and its share of acc in registers. The linear branch uses
// the equal form phi(q) Htot - sum_j phi(q) H_j, so each hblk tile is
// dotted with phi(q) as it streams and the block keeps a D-vector instead
// of a D x D sum. Lanes own 4 consecutive head-dim columns and warps
// interleave rows (keys of K/V, head-dim rows of H), so every load is a
// 16-byte (f32) or 8-byte (bf16) coalesced vector load and a block keeps a
// whole 64 KB H tile in flight. K, V, hblk and zblk are addressed through
// explicit head and block strides with the block id read from the LUT, so
// the paged variant only swaps in the page id and the pool strides.
// Occupancy: one block per (bh, c), so B H C blocks (32 at batch 2, 64 at
// batch 4) on 132 SMs; a split of the LUT walk over several blocks with a
// combine pass (flash-decoding) is the next step for speed.
//
// Paged decode (`pt` given, single token, live row). The logical block
// id j = lut[s] drives the column mask and the diagonal test; the
// physical page pt[b * tn + j], b = bh / heads, drives the addresses. The
// page is looked up here, not gathered into a `plut` operand by the
// wrapper (one launch and one allocation fewer per layer). The pools stay
// where they are, (P, Hkv, ...) per layer: the kv head stride is one
// page's head slab and the page stride Hkv of them, and the kv head is
// (bh / group) % hkv. The diagonal block's partial is the pool's own
// (hdiag null) and the totals are one running total per (b, kv head).
// Both ids are clamped into range (j to [0, tn), the page to [0, pages)),
// so a runaway inactive slot past max_len reads garbage, never out of
// bounds. With one body, the paged kernel on the pools and the monolithic
// one on the gathered view sum in the same order: bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;      // 4 columns for each of the 32 lanes
constexpr int kMaxBlock = 64;   // scores of one KV block in shared memory
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr float kEps = 1e-6f;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// kPaged selects the page-table addressing at compile time, so that the
// monolithic instantiation carries no per-slot branch or page load.
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    sla_decode_kernel(const int32_t* __restrict__ lut,
                      const int32_t* __restrict__ cnt,
                      const int32_t* __restrict__ marg,
                      const int32_t* __restrict__ posv,
                      const float* __restrict__ q,
                      const float* __restrict__ qp,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ hblk,
                      const float* __restrict__ zblk,
                      const float* __restrict__ hdiag,
                      const float* __restrict__ zdiag,
                      const float* __restrict__ htot,
                      const float* __restrict__ ztot,
                      const int32_t* __restrict__ pt,
                      float* __restrict__ o_s, float* __restrict__ o_l,
                      int c_len, int k_sel, int tn, int num_blocks, int d,
                      int block_kv, int group, int heads, int kv_mod,
                      float scale, long long kv_head_stride,
                      long long kv_blk_stride, long long h_head_stride,
                      long long h_blk_stride, long long z_head_stride,
                      long long z_blk_stride, int tot_per_token) {
  __shared__ float sQp[kMaxD];
  __shared__ float sS[kMaxBlock];   // masked scores of the current block
  __shared__ float sP[kMaxBlock];   // their probabilities
  __shared__ float sAcc[kWarps][kMaxD];
  __shared__ float sNum[kWarps][kMaxD];
  __shared__ float sDen;

  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvrow = bh / group;     // per-token kv-operand row (htot, hdiag)
  const int kvh = kPaged ? kvrow % kv_mod : kvrow;  // in the K/V layout
  const size_t tok = (size_t)bh * c_len + c;       // q, lut, outputs row
  const size_t kvtok = (size_t)kvrow * c_len + c;  // hdiag row
  const size_t totrow = tot_per_token ? kvtok : (size_t)kvrow;  // htot row
  const int32_t* pt_row = kPaged ? pt + (size_t)(bh / heads) * tn : nullptr;
  const int pos = posv[bh] + c;
  const int diag = pos / block_kv;
  const int col0 = 4 * lane;  // this lane's 4 head-dim columns
  const bool col_ok = col0 < d;

  for (int i = tid; i < d; i += kThreads) sQp[i] = qp[tok * d + i];
  float qv[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) load4(q + tok * d + col0, qv);
  __syncthreads();

  float m_run = kNegInf, l_run = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // O^s columns, this warp's keys
  float hsel[4] = {0.f, 0.f, 0.f, 0.f};  // phi(q) H_sel, this warp's rows
  float zsel = 0.f;                       // phi(q) Z_sel (warp 0)
  int n = cnt[tok];
  n = n < k_sel ? n : k_sel;
  const int32_t* lut_row = lut + tok * k_sel;
  const T* k_head = k + kvh * kv_head_stride;
  const T* v_head = v + kvh * kv_head_stride;

  for (int s = 0; s < n; ++s) {
    int j = lut_row[s];
    j = j < 0 ? 0 : (j < tn ? j : tn - 1);  // memory-safe on a bad LUT
    int blk = j;  // the block's storage: itself, or its physical page
    if (kPaged) {
      blk = pt_row[j];
      blk = blk < 0 ? 0 : (blk < num_blocks ? blk : num_blocks - 1);
    }
    const T* kj = k_head + blk * kv_blk_stride;
    const T* vj = v_head + blk * kv_blk_stride;
    const bool is_diag = hdiag != nullptr && j == diag;
    const float* hj = is_diag
        ? hdiag + kvtok * d * d
        : hblk + kvh * h_head_stride + blk * h_blk_stride;
    const float* zj = is_diag
        ? zdiag + kvtok * d
        : zblk + kvh * z_head_stride + blk * z_blk_stride;

    // scores: warp w takes keys w, w + 8, ...; lanes split the head dim
#pragma unroll 4
    for (int t = warp; t < block_kv; t += kWarps) {
      float kk[4] = {0.f, 0.f, 0.f, 0.f};
      if (col_ok) load4(kj + (size_t)t * d + col0, kk);
      float dot = qv[0] * kk[0];
      dot = fmaf(qv[1], kk[1], dot);
      dot = fmaf(qv[2], kk[2], dot);
      dot = fmaf(qv[3], kk[3], dot);
      dot = warp_sum(dot);
      if (lane == 0)
        sS[t] = (j * block_kv + t <= pos) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax (every thread holds the same m, l)
    float mx = kNegInf;
    for (int t = 0; t < block_kv; ++t) mx = fmaxf(mx, sS[t]);
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    if (tid < block_kv) sP[tid] = expf(sS[tid] - m_new);
    __syncthreads();
    float ps = 0.f;
    for (int t = 0; t < block_kv; ++t) ps += sP[t];
    l_run = l_run * alpha + ps;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= alpha;

    // acc += P V (keys by warp), hsel += phi(q) H_j (rows by warp)
    if (col_ok) {
#pragma unroll 4
      for (int t = warp; t < block_kv; t += kWarps) {
        float vv[4];
        load4(vj + (size_t)t * d + col0, vv);
        const float p = sP[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
      }
#pragma unroll 8
      for (int r = warp; r < d; r += kWarps) {
        float hv[4];
        load4(hj + (size_t)r * d + col0, hv);
        const float w = sQp[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) hsel[i] = fmaf(w, hv[i], hsel[i]);
      }
      if (warp == 0) {
        float zv[4];
        load4(zj + col0, zv);
#pragma unroll
        for (int i = 0; i < 4; ++i) zsel = fmaf(sQp[col0 + i], zv[i], zsel);
      }
    }
  }

  // linear branch against the running totals: phi(q) Htot - hsel
  const float* ht = htot + totrow * d * d;
  float num[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) {
#pragma unroll 8
    for (int r = warp; r < d; r += kWarps) {
      float hv[4];
      load4(ht + (size_t)r * d + col0, hv);
      const float w = sQp[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) num[i] = fmaf(w, hv[i], num[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sAcc[warp][col0 + i] = acc[i];
      sNum[warp][col0 + i] = num[i] - hsel[i];
    }
  }
  if (warp == 0) {
    float zt = 0.f;
    if (col_ok) {
      float zv[4];
      load4(ztot + totrow * d + col0, zv);
#pragma unroll
      for (int i = 0; i < 4; ++i) zt = fmaf(sQp[col0 + i], zv[i], zt);
    }
    const float den = warp_sum(zt - zsel);
    if (lane == 0) sDen = den;
  }
  __syncthreads();

  const float l = l_run > 0.f ? l_run : 1.f;
  const float den = sDen;
  const bool live = den > kEps && marg[tok] > 0;
  for (int e = tid; e < d; e += kThreads) {
    float a = 0.f, nm = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sAcc[w][e];
      nm += sNum[w][e];
    }
    o_s[tok * d + e] = a / l;
    o_l[tok * d + e] = live ? nm / den : 0.f;
  }
}

template <typename T>
int launch(const int32_t* lut, const int32_t* cnt, const int32_t* marg,
           const int32_t* posv, const float* q, const float* qp,
           const void* k, const void* v, const float* hblk,
           const float* zblk, const float* hdiag, const float* zdiag,
           const float* htot, const float* ztot, const int32_t* pt,
           float* o_s, float* o_l, int bh_q, int c_len, int k_sel, int tn,
           int num_blocks, int d, int block_kv, int group, int heads,
           int kv_mod, float scale, long long kv_head_stride,
           long long kv_blk_stride, long long h_head_stride,
           long long h_blk_stride, long long z_head_stride,
           long long z_blk_stride, int tot_per_token, cudaStream_t stream) {
  const dim3 grid(c_len, bh_q);
  auto kernel = pt != nullptr ? sla_decode_kernel<T, true>
                              : sla_decode_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      lut, cnt, marg, posv, q, qp, static_cast<const T*>(k),
      static_cast<const T*>(v), hblk, zblk, hdiag, zdiag, htot, ztot, pt,
      o_s, o_l, c_len, k_sel, tn, num_blocks, d, block_kv, group, heads,
      kv_mod, scale, kv_head_stride, kv_blk_stride, h_head_stride,
      h_blk_stride, z_head_stride, z_blk_stride, tot_per_token);
  return (int)cudaGetLastError();
}

int launch_any(int is_bf16, const int32_t* lut, const int32_t* cnt,
               const int32_t* marg, const int32_t* posv, const float* q,
               const float* qp, const void* k, const void* v,
               const float* hblk, const float* zblk, const float* hdiag,
               const float* zdiag, const float* htot, const float* ztot,
               const int32_t* pt, float* o_s, float* o_l, int bh_q,
               int c_len, int k_sel, int tn, int num_blocks, int d,
               int block_kv, int group, int heads, int kv_mod, float scale,
               long long kv_head_stride, long long kv_blk_stride,
               long long h_head_stride, long long h_blk_stride,
               long long z_head_stride, long long z_blk_stride,
               int tot_per_token, void* stream) {
  if (d > kMaxD || d % 4 || block_kv > kMaxBlock || block_kv < 1 ||
      (hdiag == nullptr) != (zdiag == nullptr) || group < 1 || kv_mod < 1 ||
      heads < 1 || num_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag,
                     zdiag, htot, ztot, pt, o_s, o_l, bh_q, c_len, k_sel,
                     tn, num_blocks, d, block_kv, group, heads, kv_mod,
                     scale, kv_head_stride, kv_blk_stride, h_head_stride,
                     h_blk_stride, z_head_stride, z_blk_stride,
                     tot_per_token, st);
  };
  return is_bf16 ? go(__nv_bfloat16()) : go(float());
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// k and v are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), everything else is
// f32 / int32. Per-token operands (lut, cnt, marg, q, qp, outputs: rows
// bh * c_len + c; hdiag, zdiag: rows (bh / group) * c_len + c) are
// contiguous; hdiag and zdiag may both be null (no diagonal substitution).
// htot, ztot have rows (bh / group) * c_len + c when tot_per_token, else
// one row per kv head (bh / group). k, v, hblk and zblk are addressed as
// base + kv_head * head_stride + block * blk_stride (elements) with rows
// of d contiguous elements inside a block. Requires d <= 128, d % 4 == 0
// and block_kv <= 64 (the wrapper checks). Returns a cudaError_t value (0
// on success). The launch is asynchronous on `stream` and allocates
// nothing.
extern "C" int sla_decode_launch(
    const int32_t* lut, const int32_t* cnt, const int32_t* marg,
    const int32_t* posv, const float* q, const float* qp, const void* k,
    const void* v, const float* hblk, const float* zblk, const float* hdiag,
    const float* zdiag, const float* htot, const float* ztot, float* o_s,
    float* o_l, int bh_q, int c_len, int k_sel, int tn, int d, int block_kv,
    int group, float scale, long long kv_head_stride,
    long long kv_blk_stride, long long h_head_stride, long long h_blk_stride,
    long long z_head_stride, long long z_blk_stride, int tot_per_token,
    int is_bf16, void* stream) {
  const int bh_kv = group > 0 ? bh_q / group : 0;
  return launch_any(is_bf16, lut, cnt, marg, posv, q, qp, k, v, hblk, zblk,
                    hdiag, zdiag, htot, ztot, nullptr, o_s, o_l, bh_q, c_len,
                    k_sel, tn, tn, d, block_kv, group, 1, bh_kv, scale,
                    kv_head_stride, kv_blk_stride, h_head_stride,
                    h_blk_stride, z_head_stride, z_blk_stride, tot_per_token,
                    stream);
}

// The paged kernel (single token, live row). lut, cnt, marg, q, qp and the
// outputs have one row per bh = b * heads + h, heads = group * hkv; posv
// one entry per bh; pt is (B, tn) int32 with rows b = bh / heads; htot,
// ztot one running total per (b, kv head), row bh / group. k and v are the
// layer's pools (pages, hkv, block_kv, d), hblk (pages, hkv, d, d) and zblk
// (pages, hkv, d), addressed as base + ((bh / group) % hkv) * head_stride +
// page * page_stride (elements), rows of d contiguous elements. Same
// limits and return value as sla_decode_launch.
extern "C" int sla_decode_paged_launch(
    const int32_t* lut, const int32_t* pt, const int32_t* cnt,
    const int32_t* marg, const int32_t* posv, const float* q,
    const float* qp, const void* k, const void* v, const float* hblk,
    const float* zblk, const float* htot, const float* ztot, float* o_s,
    float* o_l, int bh_q, int k_sel, int tn, int num_pages, int d,
    int block_kv, int group, int hkv, float scale,
    long long kv_head_stride, long long kv_page_stride,
    long long h_head_stride, long long h_page_stride,
    long long z_head_stride, long long z_page_stride, int is_bf16,
    void* stream) {
  if (pt == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(is_bf16, lut, cnt, marg, posv, q, qp, k, v, hblk, zblk,
                    nullptr, nullptr, htot, ztot, pt, o_s, o_l, bh_q, 1,
                    k_sel, tn, num_pages, d, block_kv, group, group * hkv,
                    hkv, scale, kv_head_stride, kv_page_stride,
                    h_head_stride, h_page_stride, z_head_stride,
                    z_page_stride, 0, stream);
}

extern "C" const char* sla_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
