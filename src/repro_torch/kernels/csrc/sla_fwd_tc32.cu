// Fused SLA forward kernel at 32 x 32 blocks on Hopper's bf16 tensor cores
// (sm_90a, warp-level mma.sync): sparse softmax over the critical KV blocks
// of each query block, plus the linear-branch merge.
//
// Replaces, for bf16 q, k, v at 32 x 32 blocks and head dims up to 128 (the
// paper's fine-tune, examples_torch/finetune_dit.py), the Pallas TPU kernel
// `_fwd_kernel` in src/repro/kernels/sla_fwd.py (launched by `sla_fwd`).
// 64 x 64 blocks take sla_fwd_tc.cu (bf16) or sla_fwd_split.cu (f32); f32
// at 32 x 32, other blocks and head dims above 128 the f32-FMA kernel of
// sla_fwd.cu. For each (batch*head bh, query block i) it computes
//   O^s_i = softmax(Q_i K_J^T * scale) V_J   over the counts[bh,i] critical
//           blocks J = lut[bh,i,:counts], online (running max m, sum l, acc),
//   lse_i = m + log l,
//   O^l_i = phi(Q_i) H_i / (phi(Q_i) Z_i), zero where the denominator is
//           <= 1e-6, from the pre-aggregated marginal state (H_i, Z_i),
// with an optional causal mask on absolute rows (base + i) * 32 + r (the
// reference's -1e30 on masked scores) and KV head bh / group.
//
// Precision (FlashAttention's contract, as sla_fwd_tc.cu and the backward
// at these blocks, sla_bwd_tc32.cu): q, k, v are bf16 and S = Q K^T
// accumulates in f32; P is rounded to bf16 before P V; l sums the unrounded
// f32 P; m, l, lse, every sum and the whole linear branch (phi(Q), H_i,
// Z_i, its products and its division) are f32; the outputs are f32.
//
// What bounds it. At the fine-tune's shape (BH 24, N 4,096, D 64, K 13,
// 39,932 live tiles) the sparse branch does 4 * 32 * 32 * 64 operations a
// live tile and the linear branch 2 * 32 * 64^2 a query block: 11.3 GFLOP
// (0.011 ms at 989 TFLOP/s) against 165 MB read and written once (0.049 ms
// at 3.35 TB/s). It is bound by bytes, and by the linear branch's bytes
// more than the walk's: H_i (50 MB), phi(Q) (25 MB) and the f32 O^l (25 MB)
// are 100 MB of the 165, while a head's K and V (1 MB at D 64) serve its
// 128 query blocks from L2.
//
// What the design does about it. As the backward at these blocks (wgmma
// needs 64-row tiles, and a 32-row tile walks its own LUT row), each CTA
// is two warps (64 threads), each owning 16 of the 32 query rows and
// issuing mma.sync m16n8k16 (bf16 in, f32 accumulate) on ldmatrix
// fragments. Q_i is staged once and held in registers as A fragments for
// the whole walk; K_j and V_j stream through a cp.async ring (3 stages at D
// 64, 2 at D 128) of shared rows padded by 16 bytes, so that ldmatrix
// reads them free of bank conflicts. S = Q_i K_j^T is a 16 x 32 fragment a
// warp; the online softmax runs on it in registers (each row's max by
// shuffles in its quad of lanes, the sum once at the end, exp2 with the
// scale folded into log2(e), the causal mask only on tiles that straddle
// the diagonal); P, rounded to bf16, becomes the A fragments of
// O += P V_j straight from the accumulators (the m16n8 C layout pairs into
// the m16n8k16 A layout), and V_j's B fragments are read by ldmatrix.trans.
// The grid runs a head's query blocks next to each other (blockIdx.x), so
// a head's K and V stay in L2. Each CTA stops at its count (padded LUT
// slots are never read) and no sum crosses CTAs (no atomics: two launches
// on the same operands are bitwise equal). After the walk the linear
// branch runs in f32 FMAs (not TF32 or bf16: H_i is a sum over many
// blocks) in the freed shared memory: phi(Q_i) and Z_i staged by
// cp.async, H_i streamed through in chunks two deep (at D 64 the whole
// 16 KB is in flight at once), each thread an 8 x 4 (D 64) or 8 x 8 (D
// 128) tile of the 32 x D output. The bytes that bound the kernel are
// then in flight from the CTAs of an SM that are past their walks while
// the others walk (7 CTAs an SM at D 64, 4 at D 128). Shared memory is
// 31.5 KB a CTA at D 64 and 42.5 KB at D 128; the helpers shared with the
// backward are in tc32.cuh.
#include "tc32.cuh"

namespace {

using namespace tc32;

constexpr float kLn2 = 0.6931471805599453f;
// the reference's masked score, -1e30, in the exp2 domain
constexpr float kMasked2 = -1e30f * kLog2e;
constexpr float kDenEps = 1e-6f;

template <int D>
struct Cfg : Tile<D> {
  using T = Tile<D>;
  // the walk: Q_i, then each stage's K_j, V_j
  static constexpr int kSmemWalk = (1 + 2 * T::kStages) * T::kTileBytes;
  // the linear branch, in floats from the base: phi(Q_i) (32 rows of
  // stride d + 4), Z_i, then two chunks of kHRows rows of H_i
  static constexpr int kHRows = D <= 64 ? 32 : 16;
  static constexpr int kZOff = kBlock * (D + 4);
  static constexpr int kHOff = kZOff + D;
  static constexpr int kSmemLinear = (kHOff + 2 * kHRows * D) * 4;
  static constexpr int kSmem =
      kSmemWalk > kSmemLinear ? kSmemWalk : kSmemLinear;
  static constexpr int kColGroups = D / 64;  // 4-column groups a thread
};

// The linear branch of query block i in f32 FMAs: rows of O^l = phi(Q_i)
// H_i / (phi(Q_i) Z_i), zero where the denominator is <= 1e-6, at the true
// head dim d (a multiple of 4, at most D). phi(Q_i) (32 rows of stride
// d + 4 floats) and Z_i are staged by cp.async into shared memory at
// `smem`, H_i streams through it in kHRows-row chunks, two deep, and
// thread (tx, ty) owns rows ty + 4 rr (rr < 8) and columns 64 cg + 4 tx ..
// + 3 (cg < D / 64). Waits for the caller's own copies and for every
// thread to be done with that memory first.
template <int D>
__device__ __forceinline__ void linear_branch(uint8_t* smem,
                                              const float* qp_blk,
                                              const float* hi_blk,
                                              const float* zi_row,
                                              float* o_l_blk, int d,
                                              int tid) {
  using C = Cfg<D>;
  cp_async_wait<0>();
  __syncthreads();  // every product that read the ring is done
  const uint32_t f0 = smem_u32(smem);
  const float* fb = reinterpret_cast<const float*>(smem);
  const int ps = d + 4;  // phi(Q_i) row stride in floats
  const int d4 = d >> 2;
  for (int idx = tid; idx < kBlock * d4; idx += kThreads) {
    const int r = idx / d4, c4 = idx - r * d4;
    cp_async16(f0 + (r * ps + c4 * 4) * 4, qp_blk + (size_t)r * d + c4 * 4);
  }
  if (tid < d4) cp_async16(f0 + (C::kZOff + tid * 4) * 4, zi_row + tid * 4);
  const int n_chunks = (d + C::kHRows - 1) / C::kHRows;
  auto load_h = [&](int c) {
    const int rows = min(C::kHRows, d - c * C::kHRows);
    const uint32_t dst = f0 + (C::kHOff + (c & 1) * C::kHRows * D) * 4;
    const float* src = hi_blk + (size_t)c * C::kHRows * d;
    for (int idx = tid; idx < rows * d4; idx += kThreads)
      cp_async16(dst + idx * 16, src + idx * 4);
  };
  load_h(0);
  cp_async_commit();  // group: phi(Q_i), Z_i and chunk 0
  if (n_chunks > 1) load_h(1);
  cp_async_commit();

  const int tx = tid & 15, ty = tid >> 4;
  int col[C::kColGroups];
  bool ok[C::kColGroups];
#pragma unroll
  for (int cg = 0; cg < C::kColGroups; ++cg) {
    col[cg] = 64 * cg + 4 * tx;
    ok[cg] = col[cg] < d;
    if (!ok[cg]) col[cg] = 0;  // a clamped read, never stored
  }
  const float* sPQ = fb;
  const float* sZ = fb + C::kZOff;
  float num[8][4 * C::kColGroups], den[8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    den[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * C::kColGroups; ++e) num[rr][e] = 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // chunk c (and phi(Q_i), Z_i) landed
    __syncthreads();
    const float* sH = fb + C::kHOff + (c & 1) * C::kHRows * D;
    const int rows = min(C::kHRows, d - c * C::kHRows);
    for (int dd = 0; dd < rows; dd += 4) {
      float4 q4[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
        q4[rr] = *reinterpret_cast<const float4*>(
            sPQ + (ty + 4 * rr) * ps + c * C::kHRows + dd);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 h[C::kColGroups];
#pragma unroll
        for (int cg = 0; cg < C::kColGroups; ++cg)
          h[cg] =
              *reinterpret_cast<const float4*>(sH + (dd + u) * d + col[cg]);
        const float z = sZ[c * C::kHRows + dd + u];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const float qv = u == 0   ? q4[rr].x
                           : u == 1 ? q4[rr].y
                           : u == 2 ? q4[rr].z
                                    : q4[rr].w;
#pragma unroll
          for (int cg = 0; cg < C::kColGroups; ++cg) {
            num[rr][4 * cg] = fmaf(qv, h[cg].x, num[rr][4 * cg]);
            num[rr][4 * cg + 1] = fmaf(qv, h[cg].y, num[rr][4 * cg + 1]);
            num[rr][4 * cg + 2] = fmaf(qv, h[cg].z, num[rr][4 * cg + 2]);
            num[rr][4 * cg + 3] = fmaf(qv, h[cg].w, num[rr][4 * cg + 3]);
          }
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
    float* dst = o_l_blk + (size_t)(ty + 4 * rr) * d;
#pragma unroll
    for (int cg = 0; cg < C::kColGroups; ++cg) {
      if (!ok[cg]) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[e] = live ? num[rr][4 * cg + e] / den[rr] : 0.f;
      *reinterpret_cast<float4*>(dst + col[cg]) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sla_fwd_tc32_kernel(const int32_t* __restrict__ lut,
                        const int32_t* __restrict__ counts, int base,
                        const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ qp,
                        const float* __restrict__ hi,
                        const float* __restrict__ zi,
                        float* __restrict__ o_s, float* __restrict__ o_l,
                        float* __restrict__ lse, int nq, int nkv, int d,
                        int tm, int k_sel, int group, float scale,
                        int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sKV = sQ + C::kTileBytes;  // stage st: K_j, then V_j

  const int i = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = warp * 16;  // this warp's rows of the query block
  const size_t row_base = (size_t)bh * nq + (size_t)i * kBlock;
  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t kv_rows = (size_t)(bh / group) * nkv;

  auto load_kv = [&](int st, int j) {
    const size_t r = kv_rows + (size_t)j * kBlock;
    const uint32_t t = sKV + st * 2 * C::kTileBytes;
    load_tile<D>(t, k + r * D, tid);
    load_tile<D>(t + C::kTileBytes, v + r * D, tid);
  };
  load_tile<D>(sQ, q + row_base * D, tid);
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {  // group st: stage st
    if (st < cnt) load_kv(st, lut_row[st]);        // (group 0: and Q_i)
    cp_async_commit();
  }
  cp_async_wait<C::kStages - 2>();  // Q_i has landed
  __syncthreads();
  uint32_t qf[C::kSteps][4];  // this warp's 16 rows of Q_i, A fragments
#pragma unroll
  for (int ks = 0; ks < C::kSteps; ++ks)
    ldsm_x4(qf[ks], a_addr<D>(sQ, r0, ks * 16, lane));

  const int row0 = (base + i) * kBlock;  // absolute row of the tile's top
  const float sl2 = scale * kLog2e;
  float acc[C::kNT][4];
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // rows r0 + g (h = 0) and r0 + g + 8 (h = 1): running max (exp2 domain)
  // and this thread's partial sum over its own columns
  float m2[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};

  for (int s = 0; s < cnt; ++s) {
    cp_async_wait<C::kStages - 2>();  // step s's tiles have landed
    __syncthreads();  // ... for every thread; step s-1 is done with its own
    const int nx = s + C::kStages - 1;
    if (nx < cnt) load_kv(nx % C::kStages, lut_row[nx]);
    cp_async_commit();

    const int j = lut_row[s];
    const uint32_t sK = sKV + (s % C::kStages) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    float sc[4][4];  // S = Q_i K_j^T, then P
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<D>(sK, np * 16, ks * 16, lane));
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }

    // online softmax in the exp2 domain; the causal mask only on tiles
    // that straddle the diagonal
    const bool straddle = causal && (j * kBlock + kBlock - 1 > row0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = sc[nt][e] * sl2;
        if (straddle && row0 + r0 + g + 8 * h <
                            j * kBlock + nt * 8 + c2 + (e & 1))
          x = kMasked2;
        sc[nt][e] = x;
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
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = exp2f(sc[nt][e] - m2[h]);
        l[h] += p;  // the unrounded P
        sc[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    uint32_t pf[2][4];  // P rounded to bf16, as A fragments
    to_a(pf, sc);
    tile_product<D>(acc, pf, sV, lane);  // O += P V_j
  }

  // Sparse finalize: O^s = acc / l, lse = m + log l (l > 0: the diagonal
  // block is forced critical, so every row has a live block), written at
  // the true head dim d.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt) {
    const int col = nt * 8 + c2;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(o_s + (row_base + r0 + g + 8 * h) * d +
                                 col) =
          make_float2(acc[nt][2 * h] / l[h], acc[nt][2 * h + 1] / l[h]);
  }
  if ((lane & 3) == 0) {
    lse[row_base + r0 + g] = m2[0] * kLn2 + logf(l[0]);
    lse[row_base + r0 + g + 8] = m2[1] * kLn2 + logf(l[1]);
  }

  linear_branch<D>(smem_raw, qp + row_base * d, hi + (size_t)row_blk * d * d,
                   zi + (size_t)row_blk * d, o_l + row_base * d, d, tid);
}

template <int D>
int launch(const int32_t* lut, const int32_t* counts, int base,
           const void* q, const void* k, const void* v, const float* qp,
           const float* hi, const float* zi, float* o_s, float* o_l,
           float* lse, int bh_q, int bh_kv, int nq, int nkv, int d, int tm,
           int k_sel, float scale, int causal, cudaStream_t stream) {
  auto kernel = sla_fwd_tc32_kernel<D>;
  if (cudaError_t err = prepare(kernel, Cfg<D>::kSmem)) return (int)err;
  kernel<<<dim3(tm, bh_q), kThreads, Cfg<D>::kSmem, stream>>>(
      lut, counts, base, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), qp, hi, zi,
      o_s, o_l, lse, nq, nkv, d, tm, k_sel, bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers;
// q, k, v are bf16, zero-padded by the wrapper to the head dim the kernel
// is built for (64 when d <= 64, else 128: zero columns leave S
// unchanged), q (bh_q, nq, 64 or 128), k and v (bh_kv, nkv, 64 or 128);
// `d` is the true head dim (a multiple of 4, at most 128) of qp (bh_q, nq,
// d), hi (bh_q, tm, d, d), zi (bh_q, tm, d) and the f32 outputs o_s, o_l
// (bh_q, nq, d) and lse (bh_q, nq); the LUTs int32, block_q == block_kv ==
// 32, every operand 16-byte aligned. Returns a cudaError_t value (0 on
// success); the launch is asynchronous on `stream` and allocates nothing.
extern "C" int sla_fwd_tc32_launch(const int32_t* lut, const int32_t* counts,
                                   int base, const void* q, const void* k,
                                   const void* v, const float* qp,
                                   const float* hi, const float* zi,
                                   float* o_s, float* o_l, float* lse,
                                   int bh_q, int bh_kv, int nq, int nkv,
                                   int d, int tm, int k_sel, int block_q,
                                   int block_kv, float scale, int causal,
                                   void* stream) {
  if (block_q != kBlock || block_kv != kBlock || d < 4 || d > 128 ||
      d % 4 || nq % kBlock || nkv % kBlock || tm != nq / kBlock ||
      bh_kv <= 0 || bh_q % bh_kv)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(lut, counts, base, q, k, v, qp, hi, zi, o_s, o_l, lse,
                      bh_q, bh_kv, nq, nkv, d, tm, k_sel, scale, causal, s);
  return launch<128>(lut, counts, base, q, k, v, qp, hi, zi, o_s, o_l, lse,
                     bh_q, bh_kv, nq, nkv, d, tm, k_sel, scale, causal, s);
}

// CTAs of the kernel at head dim d (64 or 128) that fit on one SM of the
// current device at its launch attributes; a negative cudaError_t value on
// failure.
extern "C" int sla_fwd_tc32_ctas_per_sm(int d) {
  if (d == 64) return ctas_per_sm(sla_fwd_tc32_kernel<64>, Cfg<64>::kSmem);
  if (d == 128)
    return ctas_per_sm(sla_fwd_tc32_kernel<128>, Cfg<128>::kSmem);
  return -(int)cudaErrorInvalidValue;
}

extern "C" const char* sla_fwd_tc32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
