// Fused SLA forward kernel for f32 operands on Hopper's tensor cores
// (sm_90a, wgmma), with split-precision products that keep f32 accuracy:
// sparse softmax over the critical KV blocks of each query block, plus the
// linear-branch merge.
//
// Replaces, for f32 q, k, v at 64 x 64 blocks and head dims up to 128 (the
// f32 DiT serving path), the Pallas TPU kernel `_fwd_kernel` in
// src/repro/kernels/sla_fwd.py (launched by `sla_fwd`). bf16 operands at
// those blocks take sla_fwd_tc.cu, every other case sla_fwd.cu. For each
// (batch*head bh, query block i) it computes
//   O^s_i = softmax(Q_i K_J^T * scale) V_J   over the counts[bh,i] critical
//           blocks J = lut[bh,i,:counts], online (running max m, sum l, acc),
//   lse_i = m + log l,
//   O^l_i = phi(Q_i) H_i / (phi(Q_i) Z_i), zero where the denominator is
//           <= 1e-6, from the pre-aggregated marginal state (H_i, Z_i),
// with an optional causal mask on absolute rows (base + i) * 64 + r (the
// reference's -1e30 on masked scores) and KV head bh / group.
//
// Why the split holds f32 accuracy. Each f32 operand x of Q K^T and P V is
// cut into three bf16 parts by truncation,
//   x0 = hi16(x), x1 = hi16(x - x0), x2 = hi16(x - x0 - x1),
// hi16 keeping the upper 16 bits (one AND; it never rounds up past the
// largest bf16, so no part overflows). Both subtractions are exact, and
// for every x whose lowest set bit is at or above 2^-133 (bf16's denormal
// step; every normal x down to 2^-110) x0 + x1 + x2 == x, with |x1| <
// 2^-7 |x| and |x2| < 2^-15 |x|; below that the parts miss x by less than
// 2^-133. A tile product is the sum of the six part products x2y0, x1y1,
// x0y2, x1y0, x0y1, x0y0 (smallest first), each exact on the tensor cores
// (8-bit by 8-bit significands) and summed in their f32 accumulators. The
// three dropped products are below 2^-21 |x||y|, under the f32 sum's own
// rounding over 128 (S) or 64 (P V) terms. So the kernel is held to the
// f32 twin at the f32 criterion; `sla_fwd_plain(mma_dtype="bf16x3")` cuts
// and sums alike.
//
// What bounds it. Per live tile two 64 x 64 x D products, each six times
// at the bf16 tensor-core rate (989 TFLOP/s: 165 TFLOP/s of f32-accurate
// products), plus 2 * 64 * D^2 f32 FMA operations of the linear branch per
// query block; at the Wan shape (~5% of the blocks live) ~2.0 ms of
// products and ~0.2 ms of FMAs against ~0.5 ms of device-memory bytes, so
// operations bound it. The planes of a live K/V tile (96 KB) also stream
// from L2 for every query block that reads the tile.
//
// What the design does about it. A pre-pass kernel (split_kv_kernel) cuts
// K and V once per call into three bf16 planes each, zero-padded to D =
// 128: every K/V tile is read by many query blocks, so the cut is not
// repeated per read. Q is cut in the main kernel, once per CTA: Q_0 into
// shared memory (wgmma's A from shared memory), Q_1 and Q_2 into registers
// as A fragments. One warpgroup (128 threads) per (bh, i) walks its own LUT
// row and stops at its count, so padded slots are never read and no sum
// crosses CTAs (no atomics: two launches on the same operands are bitwise
// equal). K_j's three planes and V_j's three planes have a 48 KB buffer
// each, filled by cp.async into the 128-byte-swizzled atoms wgmma reads:
// K_{j+1} loads while the softmax and P V_j run, V_{j+1} while S_{j+1}
// runs. P is cut in registers straight from the S accumulators (the
// accumulator and A-fragment layouts coincide for 16-bit types) into three
// A fragments per k16 step; l sums the uncut P (their sum, exactly). The
// online softmax stays in registers as in sla_fwd_tc.cu (quad shuffles,
// exp2 with the scale folded into log2(e), the causal mask only on tiles
// that straddle the diagonal), and each step waits for its own products
// before the next begins (no instruction touches a register an in-flight
// wgmma owns). Shared memory (113 KB) admits two CTAs per SM, so one CTA's
// softmax, cuts and epilogue overlap the other's products. The linear
// branch is sla_fwd_tc.cu's f32 epilogue (sm90_tc.cuh), in the freed
// buffers.
#include "sm90_tc.cuh"

namespace {

using namespace sm90;

constexpr float kLn2 = 0.6931471805599453f;
// the reference's masked score, -1e30, in the exp2 domain
constexpr float kMasked2 = -1e30f * kLog2e;
constexpr int kPlanes = 3;
constexpr int kPlanesBytes = kPlanes * kTileBytes;  // a K or V tile, cut
// smem, 1024-byte aligned: Q_0, K_j's planes, V_j's planes. The
// linear-branch epilogue reuses it for phi(Q_i), Z_i and H_i chunks.
constexpr size_t kSmem = 1024 + kTileBytes + 2 * kPlanesBytes;
static_assert(kLinearSmemBytes <= kTileBytes + 2 * kPlanesBytes,
              "the epilogue's tiles must fit the freed buffers");
// the part products of a tile product, smallest first: product u takes
// part part_x(u) of the left operand and part part_y(u) of the right one
// (x2y0, x1y1, x0y2, x1y0, x0y1, x0y0)
constexpr int kProducts = 6;
__host__ __device__ constexpr int part_x(int u) {
  return u == 0 ? 2 : (u == 1 || u == 3) ? 1 : 0;
}
__host__ __device__ constexpr int part_y(int u) {
  return u == 2 ? 2 : (u == 1 || u == 4) ? 1 : 0;
}

__device__ __forceinline__ float hi16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}
// x's three bf16 parts, each held exactly in an f32
__device__ __forceinline__ void cut3(float x, float (&p)[kPlanes]) {
  p[0] = hi16(x);
  const float r = x - p[0];
  p[1] = hi16(r);
  p[2] = hi16(r - p[1]);
}
// two parts as one bf16x2 (lo in the low half): their upper halves
__device__ __forceinline__ uint32_t pack_hi16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// K and V (rows, d) f32 -> three planes (3, rows, kD) bf16 each, zero past
// column d; blockIdx.y picks K (0) or V (1).
__global__ void split_kv_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                bf16* __restrict__ k3, bf16* __restrict__ v3,
                                int rows, int d) {
  const float* src = blockIdx.y ? v : k;
  bf16* dst = blockIdx.y ? v3 : k3;
  const size_t plane = (size_t)rows * kD;
  const size_t n4 = plane / 4;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n4;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t row = idx / (kD / 4);
    const int col = (int)(idx % (kD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < d) x = *reinterpret_cast<const float4*>(src + row * d + col);
    float a[kPlanes], b[kPlanes], c[kPlanes], e[kPlanes];
    cut3(x.x, a);
    cut3(x.y, b);
    cut3(x.z, c);
    cut3(x.w, e);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      *reinterpret_cast<uint2*>(dst + p * plane + row * kD + col) =
          make_uint2(pack_hi16(a[p], b[p]), pack_hi16(c[p], e[p]));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    sla_fwd_split_kernel(const int32_t* __restrict__ lut,
                         const int32_t* __restrict__ counts, int base,
                         const float* __restrict__ q,
                         const bf16* __restrict__ k3,
                         const bf16* __restrict__ v3,
                         const float* __restrict__ qp,
                         const float* __restrict__ hi,
                         const float* __restrict__ zi,
                         float* __restrict__ o_s, float* __restrict__ o_l,
                         float* __restrict__ lse, int nq, int nkv, int bh_kv,
                         int d, int tm, int k_sel, int group, float scale,
                         int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  const uint32_t sbase = smem_u32(smem_raw) + pad;
  const uint32_t sQ = sbase;                 // Q_0
  const uint32_t sK = sbase + kTileBytes;    // K_j's planes 0, 1, 2
  const uint32_t sV = sK + kPlanesBytes;     // V_j's planes 0, 1, 2

  const int i = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row_base = (size_t)bh * nq + (size_t)i * kBlock;
  const int row_blk = bh * tm + i;
  int cnt = counts[row_blk];
  cnt = cnt < k_sel ? cnt : k_sel;
  const int32_t* lut_row = lut + (size_t)row_blk * k_sel;
  const size_t plane = (size_t)bh_kv * nkv * kD;  // elements of one plane
  const size_t kv_rows = (size_t)(bh / group) * nkv;
  auto load_planes = [&](uint32_t dst, const bf16* src, int j) {
    const bf16* tile = src + (kv_rows + (size_t)j * kBlock) * kD;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      load_tile(dst + p * kTileBytes, tile + p * plane, tid);
  };

  if (cnt > 0) load_planes(sK, k3, lut_row[0]);
  cp_async_commit();
  if (cnt > 0) load_planes(sV, v3, lut_row[0]);
  cp_async_commit();

  // Q_i, cut once: Q_1 and Q_2 as A fragments of the k16 steps (element x
  // of step ks at row warp * 16 + lane / 4 + 8 (x & 1), column 16 ks +
  // (lane % 4) * 2 + 8 (x >> 1), a pair), Q_0 into the swizzled tile.
  uint32_t qf1[kSteps][4], qf2[kSteps][4];
  {
    const float* q_blk = q + row_base * d;
    uint8_t* sq = smem_raw + pad;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = warp * 16 + (lane >> 2) + 8 * (x & 1);
        const int col = 16 * ks + (lane & 3) * 2 + 8 * (x >> 1);
        float2 val = make_float2(0.f, 0.f);
        if (col < d)
          val = *reinterpret_cast<const float2*>(q_blk + (size_t)row * d +
                                                 col);
        float a[kPlanes], b[kPlanes];
        cut3(val.x, a);
        cut3(val.y, b);
        qf1[ks][x] = pack_hi16(a[1], b[1]);
        qf2[ks][x] = pack_hi16(a[2], b[2]);
        const uint32_t off = (col >> 6) * kAtomBytes + row * 128 +
                             ((((col & 63) >> 3) ^ (row & 7)) << 4) +
                             (col & 7) * 2;
        *reinterpret_cast<uint32_t*>(sq + off) = pack_hi16(a[0], b[0]);
      }
  }

  const int row0 = (base + i) * kBlock;  // absolute row of the tile's top
  const float sl2 = scale * kLog2e;
  float acc[kAtoms][32];
  zero(acc);
  // rows r0 = warp * 16 + lane / 4 (h = 0) and r0 + 8 (h = 1): running max
  // (exp2 domain) and this thread's partial sum over its own columns
  float m2[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};

  float sc[32];  // S, then P (no other instruction writes it in flight)
#pragma unroll
  for (int t = 0; t < 32; ++t) sc[t] = 0.f;
  for (int s = 0; s < cnt; ++s) {
    const int j = lut_row[s];
    // K_j landed (and V_j, at s == 0, may be in flight); every warp is
    // done with P V_{j-1}, so V_j may fill its buffer
    if (s == 0)
      cp_async_wait<1>();
    else
      cp_async_wait_all();
    fence_proxy_async();  // Q_0's stores and the copies, for wgmma
    __syncthreads();
    if (s > 0) load_planes(sV, v3, j);
    cp_async_commit();

    // S = Q_i K_j^T from the six part products, smallest first
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kProducts; ++u)
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const uint64_t db = desc_kmajor(sK + part_y(u) * kTileBytes, ks);
        const int accumulate = u > 0 || ks > 0;
        if (part_x(u) == 0)
          wgmma_ss(sc, desc_kmajor(sQ, ks), db, accumulate);
        else if (part_x(u) == 1)
          wgmma_rs_kmajor(sc, qf1[ks], db, accumulate);
        else
          wgmma_rs_kmajor(sc, qf2[ks], db, accumulate);
      }
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
    // P, its sum, and its three parts as A fragments per k16 step kk
    uint32_t pf[kPlanes][4][4];
#pragma unroll
    for (int t = 0; t < 32; t += 2) {
      const int h = (t >> 1) & 1;
      const float p0 = exp2f(sc[t] - m2[h]);
      const float p1 = exp2f(sc[t + 1] - m2[h]);
      l[h] += p0 + p1;
      float a[kPlanes], b[kPlanes];
      cut3(p0, a);
      cut3(p1, b);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        pf[p][t >> 3][(t & 7) >> 1] = pack_hi16(a[p], b[p]);
    }
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int t = 0; t < 32; ++t) acc[a][t] *= alpha[(t >> 1) & 1];

    // V_j landed; every warp is done with S, so K_{j+1} may fill K's buffer
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (s + 1 < cnt) load_planes(sK, k3, lut_row[s + 1]);
    cp_async_commit();

    // O += P V_j from the six part products, smallest first; B = V_j's
    // planes read MN-major (K = kv rows, N = D)
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kProducts; ++u)
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[a], pf[part_x(u)][kk],
                   desc_mnmajor(sV + part_y(u) * kTileBytes, a, kk));
    wgmma_commit();
    wgmma_wait_all();  // before the next step refills V's buffer
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) fence_regs(acc[a]);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) fence_regs(pf[p]);
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

  // Linear branch in f32, in the freed buffers (sm90_tc.cuh).
  linear_branch(sbase, reinterpret_cast<const float*>(smem_raw + pad),
                qp + row_base * d, hi + (size_t)row_blk * d * d,
                zi + (size_t)row_blk * d, o_l + row_base * d, d, tid);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers,
// every operand 16-byte aligned; returns a cudaError_t value (0 on
// success); each launch is asynchronous on `stream` and allocates nothing.
//
// sla_fwd_split_planes_launch: k and v f32 (rows, d) -> k3 and v3 bf16
// (3, rows, 128), the three parts of each element, zero past column d
// (d a multiple of 4, at most 128).
extern "C" int sla_fwd_split_planes_launch(const float* k, const float* v,
                                           void* k3, void* v3, int rows,
                                           int d, void* stream) {
  if (rows < 1 || d < 4 || d > kD || d % 4) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)rows * (kD / 4);
  const size_t want = (n4 + 255) / 256;
  const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
  split_kv_kernel<<<dim3(grid, 2), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      k, v, static_cast<bf16*>(k3), static_cast<bf16*>(v3), rows, d);
  return (int)cudaGetLastError();
}

// sla_fwd_split_launch: q f32 (bh_q, nq, d), k3 and v3 the planes of k and
// v (bh_kv, nkv, d) from sla_fwd_split_planes_launch; `d` is the true head
// dim of q, qp (bh_q, nq, d), hi (bh_q, tm, d, d), zi (bh_q, tm, d) and the
// f32 outputs o_s, o_l (bh_q, nq, d) and lse (bh_q, nq); the LUTs int32,
// block_q == block_kv == 64.
extern "C" int sla_fwd_split_launch(const int32_t* lut, const int32_t* counts,
                                    int base, const float* q, const void* k3,
                                    const void* v3, const float* qp,
                                    const float* hi, const float* zi,
                                    float* o_s, float* o_l, float* lse,
                                    int bh_q, int bh_kv, int nq, int nkv,
                                    int d, int tm, int k_sel, int block_q,
                                    int block_kv, float scale, int causal,
                                    void* stream) {
  if (block_q != kBlock || block_kv != kBlock || d < 4 || d > kD || d % 4 ||
      tm != nq / kBlock || bh_kv < 1 || bh_q % bh_kv)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sla_fwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  sla_fwd_split_kernel<<<dim3(tm, bh_q), kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      lut, counts, base, q, static_cast<const bf16*>(k3),
      static_cast<const bf16*>(v3), qp, hi, zi, o_s, o_l, lse, nq, nkv,
      bh_kv, d, tm, k_sel, bh_q / bh_kv, scale, causal);
  return (int)cudaGetLastError();
}

// CTAs of the main kernel resident on one SM at its shared memory and
// registers (its design wants 2), or a negative cudaError_t value.
extern "C" int sla_fwd_split_ctas_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      sla_fwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return -(int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, sla_fwd_split_kernel, kThreads, kSmem);
  return err == cudaSuccess ? ctas : -(int)err;
}

extern "C" const char* sla_fwd_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
