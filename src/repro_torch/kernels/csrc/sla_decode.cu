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
// What the design does about it. The TPU kernel walks the LUT as a sequential
// grid axis with its softmax state and a D x D hsel sum in VMEM scratch; one
// block a (bh, c) for the whole walk would leave most of the 132 SMs idle (32
// rows at batch 2) with one slot's loads in flight each. So the walk is split
// (flash-decoding): the split kernel's grid is (nsplit + 1, C, BH), and the
// block at split s < nsplit walks slots [s w, min((s + 1) w, cnt)) of its row,
// the width w chosen by the wrapper from the shapes and the SM count alone
// (the grid covers the SMs twice, and no block walks more than 4 slots). A
// split past cnt writes a neutral partial (m = -1e30, l = 0, zeros). Block
// `nsplit` of a row computes phi(q) Htot and phi(q) Ztot, in parallel with the
// walk. The linear branch uses the equal form phi(q) Htot - sum_j phi(q) H_j,
// so each hblk tile is dotted with phi(q) as it streams and a split keeps a
// D-vector instead of a D x D sum. Loads: per-thread vector loads of a whole
// slot (~96 KB a block in flight) stalled well short of the memory rate
// whatever the grid (the SM's limit on outstanding loads, not latency); so
// thread 0 moves each slot with four 1-D bulk copies (TMA, `cp.async.bulk`)
// into the block's stage in shared memory (bf16 at D 128, bkv 64: 96.5 KB, two
// blocks an SM; f32 128.5 KB, one), K and V on one mbarrier, H and Z on
// another, and refills K and V with the next slot as soon as they are read,
// while the warps read H (a two-stage ring in one block was slower than two
// one-stage blocks an SM). The eight warps keep separate online softmaxes:
// warp w owns keys w, w + 8, ... of every block and H rows w, w + 8, ...,
// reduces its scores with shuffles (every lane holds them), and keeps m, l and
// acc in registers; lanes own 4 consecutive head-dim columns. The warps'
// states merge once, at the end, in warp order, into one partial record per
// (bh, c, split) in an f32 workspace the wrapper allocates: m, l, the
// unnormalised acc[D], hpart[D] = phi(q) sum H_j and zpart = phi(q) sum Z_j.
// The combine kernel (one block a (bh, c)), launched to start while the split
// grid drains (programmatic dependent launch), reads the records in split
// order: m* = max m_s, l = sum l_s e^(m_s - m*), acc the same way, hsel = sum
// hpart_s, zsel = sum zpart_s, and writes O^s = acc / l (l = 1 where l = 0)
// and O^l from the totals' record. The -1e30 sentinel (never -inf: e^(-inf -
// (-inf)) is NaN) makes a split whose columns are all masked weigh in as in
// the unsplit walk: it vanishes against any live score. Fixed orders
// everywhere, no atomics: two launches are bitwise equal. The bulk copies need
// K/V tiles of a multiple of 16 bytes (bkv D % 8 == 0 in bf16) and 16-byte
// strides.
//
// Head dims up to 256 (gemma3's 256-wide heads). The columns a lane owns are
// a template parameter, kCols: 4 up to D 128 (the layout above, unchanged),
// 8 up to D 256. At D 256 a slot's H tile is 256 KB of f32, more than a
// block's shared memory, so H streams through the stage in row slices of
// kHRows rows (64 rows, 64 KB at D 256; at D <= 128 one slice holds the
// whole tile) on the H mbarrier: the warps dot slice n with phi(q) while
// nothing else is in flight on that barrier, then thread 0 refills the
// slice buffer with slice n + 1, or with slice 0 of the next slot. K and V
// (32 KB each in bf16 at D 256) keep their own barrier and are refilled as
// before. The stage is then 129 KB (bf16) or 193 KB (f32): one block an SM.
// The split width, the record layout and the combine kernel are the same at
// every width, and a warp sums its H rows in the same order whether they
// arrive in one slice or in four.
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
// bounds. With one body and a width that depends on the shapes only, the
// paged kernel on the pools and the monolithic one on the gathered view
// split and sum in the same order: bitwise equal.
//
// Partial mode (`sla_decode_partial_launch`: a rank's span of a cache
// whose sequence is split over several ranks; one token or a chunk of C,
// each row at its own position). A rank holds some of the live row's
// blocks and none of the global totals, so it cannot divide.
// The split grid runs without its totals' block, and the combine kernel
// (its kPartial instantiation) merges the split records in split order
// as above but writes the merged record itself, (m, l, acc[D], hsel[D],
// zsel), for a combine across ranks (`distributed/serving.py`
// `sla_decode_combine`), which applies the marg and den tests on the
// global sums. The wrapper passes the LUT slots in this rank's span in
// its own block ids and the positions shifted by the span's start, so the
// masks see global columns. The paged partial mode
// (`sla_decode_paged_partial_launch`) is the same split grid at kPaged
// with the combine's kPartial instantiation: a span's re-based LUT and the
// span's columns of the page table, the rank's pools read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowCols = 4;  // columns a lane owns up to D 128
constexpr int kWideCols = 8;    // and up to D 256
constexpr int kMaxD = 32 * kWideCols;
constexpr int kMaxBlock = 64;   // keys of one KV block
constexpr int kKeys = kMaxBlock / kWarps;  // a block's keys per warp
constexpr int kMaxGrid = 65535;            // grid y (C) and z (BH)

// The largest head dim of an instantiation, and the H rows one slice of
// its stage holds (at D <= 128 the whole tile, so one slice a slot).
__host__ __device__ constexpr int dim_of(int cols) { return 32 * cols; }
__host__ __device__ constexpr int h_rows_of(int cols) {
  return cols == kNarrowCols ? dim_of(kNarrowCols) : 64;
}
constexpr int kBatch = 8;  // records the combine reads at once
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr float kEps = 1e-6f;

// One partial record per (bh, c, split) in the workspace, in floats:
// [m, l, zpart, 0, acc[d], hpart[d]]; d % 4 == 0 keeps records 16-byte
// aligned. Record `nsplit` of a row holds the totals' products (zpart =
// phi(q) Ztot, hpart = phi(q) Htot).
__host__ __device__ constexpr int record(int d) { return 4 + 2 * d; }

// The H rows of one slice at head dim d: h_rows, or the whole tile.
__host__ __device__ constexpr int slice_rows(int d, int h_rows) {
  return d < h_rows ? d : h_rows;
}

// A block's stage: a slot's K tile, V tile (bkv x d of T each), one slice
// of its H tile (slice_rows x d f32) and its Z row (d f32), each a
// multiple of 16 bytes.
__host__ __device__ constexpr int stage_bytes(int d, int block_kv, int esize,
                                              int h_rows) {
  return 2 * block_kv * d * esize + (slice_rows(d, h_rows) * d + d) * 4;
}

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

// mbarrier and 1-D bulk copy (TMA) primitives, shared::cta addresses
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Loads kCols columns from col0 on, 4 at a time, each group of 4 only
// where it lies inside the d columns (zeros past them).
template <int kCols, typename T>
__device__ __forceinline__ void load_cols(const T* p, int col0, int d,
                                          float out[kCols]) {
#pragma unroll
  for (int g = 0; g < kCols / 4; ++g) {
    if (col0 + 4 * g < d) {
      load4(p + col0 + 4 * g, out + 4 * g);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * g + e] = 0.f;
    }
  }
}

// hs += sum over this warp's rows r of one H slice in shared memory (rows
// row0 .. row0 + nrows of the tile, slice row r - row0) of
// phi(q)[r] * h[r, col0:col0+kCols]
template <int kCols>
__device__ __forceinline__ void dot_h(const float* h, const float* sQp,
                                     int d, int row0, int nrows, int warp,
                                     int col0, float hs[kCols]) {
#pragma unroll
  for (int i = 0; i < h_rows_of(kCols) / kWarps; ++i) {
    const int r = warp + kWarps * i;
    if (r < nrows) {
      float hv[kCols];
      load_cols<kCols>(h + r * d, col0, d, hv);
      const float w = sQp[row0 + r];
#pragma unroll
      for (int e = 0; e < kCols; ++e) hs[e] = fmaf(w, hv[e], hs[e]);
    }
  }
}

// in warp 0, zs += phi(q)[cols] . z[cols] over the lane's columns
template <int kCols>
__device__ __forceinline__ void dot_z(const float* z, const float* sQp,
                                     int d, int warp, int col0, float& zs) {
  if (warp != 0) return;
#pragma unroll
  for (int g = 0; g < kCols / 4; ++g) {
    const int c = col0 + 4 * g;
    if (c < d) {
      float zv[4];
      load4(z + c, zv);
#pragma unroll
      for (int e = 0; e < 4; ++e) zs = fmaf(sQp[c + e], zv[e], zs);
    }
  }
}

// The split kernel: one block per (split, c, bh). kPaged selects the
// page-table addressing at compile time, so that the monolithic
// instantiation carries no per-slot branch or page load; kCols the
// columns a lane owns (and with them the H slice). Thread 0 fills the
// block's stage with a slot's tiles by bulk copies: K and V on one
// mbarrier, H slices and Z on another. Every warp reads its keys of K and
// V once theirs completes; a block barrier then lets thread 0 refill K
// and V with the next slot while the warps read H; a barrier after each
// slice frees the slice buffer for the next.
template <typename T, bool kPaged, int kCols>
__global__ void __launch_bounds__(kThreads)
    sla_decode_split_kernel(const int32_t* __restrict__ lut,
                            const int32_t* __restrict__ cnt,
                            const int32_t* __restrict__ posv,
                            const float* __restrict__ q,
                            const float* __restrict__ qp,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ hblk,
                            const float* __restrict__ zblk,
                            const float* __restrict__ hdiag,
                            const float* __restrict__ zdiag,
                            const float* __restrict__ htot,
                            const float* __restrict__ ztot,
                            const int32_t* __restrict__ pt,
                            float* __restrict__ work, int c_len, int k_sel,
                            int tn, int num_blocks, int d, int block_kv,
                            int group, int heads, int kv_mod, float scale,
                            long long kv_head_stride,
                            long long kv_blk_stride, long long h_head_stride,
                            long long h_blk_stride, long long z_head_stride,
                            long long z_blk_stride, int tot_per_token,
                            int width, int nsplit) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t kv_full;  // K, V landed
  __shared__ __align__(8) uint64_t h_full;   // H, Z landed
  constexpr int kDim = dim_of(kCols);
  __shared__ float sQp[kDim];
  __shared__ float sM[kWarps], sL[kWarps];
  __shared__ float sAcc[kWarps][kDim];
  __shared__ float sH[kWarps][kDim];
  __shared__ float sZ;

  const int split = blockIdx.x;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvrow = bh / group;     // per-token kv-operand row (htot, hdiag)
  const int kvh = kPaged ? kvrow % kv_mod : kvrow;  // in the K/V layout
  const size_t tok = (size_t)bh * c_len + c;       // q, lut, outputs row
  const size_t kvtok = (size_t)kvrow * c_len + c;  // hdiag row
  const size_t totrow = tot_per_token ? kvtok : (size_t)kvrow;  // htot row
  const int col0 = kCols * lane;  // this lane's kCols head-dim columns
  const bool col_ok = col0 < d;
  const int kv_elems = block_kv * d;
  const uint32_t kv_bytes = kv_elems * sizeof(T);
  const uint32_t z_bytes = d * 4;
  // H arrives in nslices slices of srows rows (the last may be shorter)
  const int srows = slice_rows(d, h_rows_of(kCols));
  const int nslices = (d + srows - 1) / srows;
  auto rows_in = [&](int n) { return d - n * srows < srows ? d - n * srows
                                                           : srows; };
  float* part = work + (tok * (nsplit + 1) + split) * record(d);
  // let the combine kernel launch now and wait for this grid
  // (programmatic dependent launch)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid == 0) {
    mbar_init(&kv_full);
    mbar_init(&h_full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < d; i += kThreads) sQp[i] = qp[tok * d + i];
  __syncthreads();

  float m_run = kNegInf, l_run = 0.f;
  float acc[kCols], hs[kCols];  // O^s columns, this warp's keys; phi(q) H
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = hs[e] = 0.f;
  float zs = 0.f;  // phi(q) Z, per lane (warp 0)

  if (split == nsplit) {  // the totals: phi(q) Htot, phi(q) Ztot
    float* sh = reinterpret_cast<float*>(stage);
    float* sz = sh + srows * d;
    for (int n = 0; n < nslices; ++n) {
      if (tid == 0) {
        const uint32_t bytes = rows_in(n) * d * 4;
        mbar_expect(&h_full, bytes + (n == 0 ? z_bytes : 0));
        bulk_load(sh, htot + totrow * d * d + (size_t)n * srows * d, bytes,
                  &h_full);
        if (n == 0) bulk_load(sz, ztot + totrow * d, z_bytes, &h_full);
      }
      mbar_wait(&h_full, n & 1);
      if (col_ok) {
        dot_h<kCols>(sh, sQp, d, n * srows, rows_in(n), warp, col0, hs);
        if (n == 0) dot_z<kCols>(sz, sQp, d, warp, col0, zs);
      }
      __syncthreads();  // the slice is read: it may be refilled
    }
  } else {
    int n = cnt[tok];
    n = n < k_sel ? n : k_sel;
    const int s0 = split * width;
    const int s1 = s0 + width < n ? s0 + width : n;
    const int pos = posv[bh] + c;
    // a token before a span's first column (partial mode) has no
    // diagonal block in it
    const int diag = pos >= 0 ? pos / block_kv : -1;
    const int32_t* lut_row = lut + tok * k_sel;
    const int32_t* pt_row = kPaged ? pt + (size_t)(bh / heads) * tn
                                   : nullptr;
    // the block id (mask, diagonal test), clamped: memory-safe on a bad
    // LUT; its storage is itself, or its physical page (clamped too)
    auto block_id = [&](int s) {
      const int j = lut_row[s];
      return j < 0 ? 0 : (j < tn ? j : tn - 1);
    };
    // where slot s's four tiles live (its storage: the block itself, or
    // its physical page, clamped too)
    struct Tiles {
      const T* k;
      const T* v;
      const float* h;
      const float* z;
    };
    auto tiles = [&](int s) {
      const int j = block_id(s);
      int blk = j;
      if (kPaged) {
        blk = pt_row[j];
        blk = blk < 0 ? 0 : (blk < num_blocks ? blk : num_blocks - 1);
      }
      const bool is_diag = hdiag != nullptr && j == diag;
      const long long kv_off = kvh * kv_head_stride + blk * kv_blk_stride;
      return Tiles{k + kv_off, v + kv_off,
                   is_diag ? hdiag + kvtok * d * d
                           : hblk + kvh * h_head_stride + blk * h_blk_stride,
                   is_diag ? zdiag + kvtok * d
                           : zblk + kvh * z_head_stride + blk * z_blk_stride};
    };
    // thread 0: a slot's K and V tiles, or its H tile and Z row, into
    // the stage
    const T* sk = reinterpret_cast<const T*>(stage);
    const T* sv = sk + kv_elems;
    unsigned char* h_stage = stage + 2 * kv_bytes;
    const float* sh = reinterpret_cast<const float*>(h_stage);
    const float* sz = sh + srows * d;
    auto fill_kv = [&](const Tiles& t) {
      mbar_expect(&kv_full, 2 * kv_bytes);
      bulk_load(stage, t.k, kv_bytes, &kv_full);
      bulk_load(stage + kv_bytes, t.v, kv_bytes, &kv_full);
    };
    // slice n of a slot's H tile, and with slice 0 its Z row
    auto fill_h = [&](const Tiles& t, int n) {
      const uint32_t bytes = rows_in(n) * d * 4;
      mbar_expect(&h_full, bytes + (n == 0 ? z_bytes : 0));
      bulk_load(h_stage, t.h + (size_t)n * srows * d, bytes, &h_full);
      if (n == 0)
        bulk_load(h_stage + srows * d * 4, t.z, z_bytes, &h_full);
    };
    Tiles cur{};  // thread 0: the slot whose H slices are in flight
    if (tid == 0 && s0 < s1) {
      cur = tiles(s0);
      fill_kv(cur);
      fill_h(cur, 0);
    }
    float qv[kCols];
    load_cols<kCols>(q + tok * d, col0, d, qv);
    uint32_t h_parity = 0;

    for (int s = s0; s < s1; ++s) {
      const uint32_t parity = (s - s0) & 1;
      const bool refill = tid == 0 && s + 1 < s1;
      const int j = block_id(s);
      Tiles next{};
      if (refill) next = tiles(s + 1);  // looked up ahead of its use
      mbar_wait(&kv_full, parity);

      // this warp's scores, every lane holding all of them
      float p[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int t = warp + kWarps * u;
        float kk[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) kk[e] = 0.f;
        if (col_ok && t < block_kv) load_cols<kCols>(sk + t * d, col0, d, kk);
        float dot = qv[0] * kk[0];
#pragma unroll
        for (int e = 1; e < kCols; ++e) dot = fmaf(qv[e], kk[e], dot);
        dot = warp_sum(dot);
        p[u] = (j * block_kv + t <= pos) ? dot * scale : kNegInf;
        if (t < block_kv) mx = fmaxf(mx, p[u]);
      }
      // this warp's online softmax
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        p[u] = warp + kWarps * u < block_kv ? expf(p[u] - m_new) : 0.f;
        ps += p[u];
      }
      l_run = l_run * alpha + ps;
      m_run = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] *= alpha;
      if (col_ok) {
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const int t = warp + kWarps * u;
          if (t < block_kv) {
            float vv[kCols];
            load_cols<kCols>(sv + t * d, col0, d, vv);
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[e] = fmaf(p[u], vv[e], acc[e]);
          }
        }
      }
      // K and V are read: refill them with the next slot while the warps
      // read H, a slice at a time
      __syncthreads();
      if (refill) fill_kv(next);
      for (int sl = 0; sl < nslices; ++sl) {
        mbar_wait(&h_full, h_parity);
        h_parity ^= 1;
        if (col_ok) {
          dot_h<kCols>(sh, sQp, d, sl * srows, rows_in(sl), warp, col0, hs);
          if (sl == 0) dot_z<kCols>(sz, sQp, d, warp, col0, zs);
        }
        __syncthreads();  // the slice is read: it may be refilled
        if (tid == 0) {
          if (sl + 1 < nslices)
            fill_h(cur, sl + 1);
          else if (refill)
            fill_h(next, 0);
        }
      }
      if (refill) cur = next;
    }
  }

  // merge the warps' states, in warp order, into this split's record
  if (lane == 0) {
    sM[warp] = m_run;
    sL[warp] = l_run;
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    if (col0 + e < d) {
      sAcc[warp][col0 + e] = acc[e];
      sH[warp][col0 + e] = hs[e];
    }
  }
  if (warp == 0) {
    const float z = warp_sum(zs);
    if (lane == 0) sZ = z;
  }
  __syncthreads();
  float m = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sM[w]);
  for (int e = tid; e < d; e += kThreads) {
    float a = 0.f, h = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sAcc[w][e] * expf(sM[w] - m);
      h += sH[w][e];
    }
    part[4 + e] = a;
    part[4 + d + e] = h;
  }
  if (tid == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += sL[w] * expf(sM[w] - m);
    part[0] = m;
    part[1] = l;
    part[2] = sZ;
    part[3] = 0.f;
  }
}

// The combine kernel: one block per (bh, c) row of kMaxThreads threads
// (128, or 256 for head dims above 128), thread e owns column e.
// It waits for the split grid (programmatic dependent launch), stages the
// row's record headers (m, l, zpart) in shared memory in one parallel
// pass, reads the nsplit split records in index order, kBatch at a time
// (their loads in flight together), then the totals' record, and writes
// O^s and O^l. With kPartial (a rank's span of a sharded cache) the split
// grid has no totals' block: the merged record itself is written, before
// any divide, as (m, l, acc[d], hsel[d], zsel) into `rec`, 2 d + 3 floats
// a row, for a combine across ranks; the marg / den test needs the global
// sums, so it is left to that combine.
template <int kMaxThreads, bool kPartial>
__global__ void __launch_bounds__(kMaxThreads)
    sla_decode_combine_kernel(const int32_t* __restrict__ marg,
                              const float* __restrict__ work,
                              float* __restrict__ o_s,
                              float* __restrict__ o_l,
                              float* __restrict__ rec_out, int d,
                              int nsplit) {
  extern __shared__ float head[];  // (nsplit + 1) x (m, l, zpart)
  const size_t tok = blockIdx.x;
  const int e = threadIdx.x;
  const bool col = e < d;
  const int rec = record(d);
  const int nrec = kPartial ? nsplit : nsplit + 1;  // headers to stage
  const float* row = work + tok * (nsplit + 1) * rec;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = e; i < 3 * nrec; i += blockDim.x)
    head[i] = row[(size_t)(i / 3) * rec + i % 3];
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, head[3 * s]);
  float l = 0.f, z = 0.f, a = 0.f, h = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += kBatch) {
    float av[kBatch], hv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float* r = row + (size_t)(s0 + u) * rec;
      const bool in = col && s0 + u < nsplit;
      av[u] = in ? r[4 + e] : 0.f;
      hv[u] = in ? r[4 + d + e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u;
      if (s < nsplit) {
        const float f = expf(head[3 * s] - m);
        l += head[3 * s + 1] * f;
        z += head[3 * s + 2];
        a += av[u] * f;
        h += hv[u];
      }
    }
  }
  if (kPartial) {
    float* out = rec_out + tok * (2 * d + 3);
    if (col) {
      out[2 + e] = a;
      out[2 + d + e] = h;
    }
    if (e == 0) {
      out[0] = m;
      out[1] = l;
      out[2 + 2 * d] = z;
    }
    return;
  }
  const float den = head[3 * nsplit + 2] - z;
  const bool live = den > kEps && marg[tok] > 0;
  if (col) {
    o_s[tok * d + e] = a / (l > 0.f ? l : 1.f);
    o_l[tok * d + e] =
        live ? (row[(size_t)nsplit * rec + 4 + d + e] - h) / den : 0.f;
  }
}

// The split kernel's stage takes dynamic shared memory past 48 KB (the
// largest of an instantiation at its widest head dim and bkv 64: f32 at D
// 128 128.5 KB, at D 256 193 KB): allow it, once per instantiation.
template <typename T, bool kPaged, int kCols>
cudaError_t allow_stage() {
  static const cudaError_t err = cudaFuncSetAttribute(
      sla_decode_split_kernel<T, kPaged, kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      stage_bytes(dim_of(kCols), kMaxBlock, sizeof(T), h_rows_of(kCols)));
  return err;
}

template <typename T, bool kPaged, int kCols>
int launch(const int32_t* lut, const int32_t* cnt, const int32_t* marg,
           const int32_t* posv, const float* q, const float* qp,
           const void* k, const void* v, const float* hblk,
           const float* zblk, const float* hdiag, const float* zdiag,
           const float* htot, const float* ztot, const int32_t* pt,
           float* work, float* o_s, float* o_l, float* rec_out, int bh_q,
           int c_len, int k_sel, int tn, int num_blocks, int d,
           int block_kv, int group, int heads, int kv_mod, float scale,
           long long kv_head_stride, long long kv_blk_stride,
           long long h_head_stride, long long h_blk_stride,
           long long z_head_stride, long long z_blk_stride,
           int tot_per_token, int width, int nsplit, cudaStream_t stream) {
  cudaError_t err = allow_stage<T, kPaged, kCols>();
  if (err != cudaSuccess) return (int)err;
  // a partial launch (rec_out given) runs no totals' block: the rank
  // holds no global totals
  const bool partial = rec_out != nullptr;
  const dim3 grid(partial ? nsplit : nsplit + 1, c_len, bh_q);
  sla_decode_split_kernel<T, kPaged, kCols><<<
      grid, kThreads,
      stage_bytes(d, block_kv, sizeof(T), h_rows_of(kCols)), stream>>>(
      lut, cnt, posv, q, qp, static_cast<const T*>(k),
      static_cast<const T*>(v), hblk, zblk, hdiag, zdiag, htot, ztot, pt,
      work, c_len, k_sel, tn, num_blocks, d, block_kv, group, heads, kv_mod,
      scale, kv_head_stride, kv_blk_stride, h_head_stride, h_blk_stride,
      z_head_stride, z_blk_stride, tot_per_token, width, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the combine kernel may start while the split grid drains; it waits
  // for the split grid's records itself (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh_q * c_len);
  cfg.blockDim = dim3(dim_of(kCols));
  cfg.dynamicSmemBytes = 3 * (nsplit + 1) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (partial)
    err = cudaLaunchKernelEx(&cfg,
                             sla_decode_combine_kernel<dim_of(kCols), true>,
                             marg, (const float*)work, o_s, o_l, rec_out, d,
                             nsplit);
  else
    err = cudaLaunchKernelEx(&cfg,
                             sla_decode_combine_kernel<dim_of(kCols), false>,
                             marg, (const float*)work, o_s, o_l, rec_out, d,
                             nsplit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_any(int is_bf16, const int32_t* lut, const int32_t* cnt,
               const int32_t* marg, const int32_t* posv, const float* q,
               const float* qp, const void* k, const void* v,
               const float* hblk, const float* zblk, const float* hdiag,
               const float* zdiag, const float* htot, const float* ztot,
               const int32_t* pt, float* work, float* o_s, float* o_l,
               float* rec_out, int bh_q, int c_len, int k_sel, int tn,
               int num_blocks, int d,
               int block_kv, int group, int heads, int kv_mod, float scale,
               long long kv_head_stride, long long kv_blk_stride,
               long long h_head_stride, long long h_blk_stride,
               long long z_head_stride, long long z_blk_stride,
               int tot_per_token, int width, int nsplit, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  const int align = 16 / esize;  // K/V elements in 16 bytes
  if (d > kMaxD || d % 4 || block_kv > kMaxBlock || block_kv < 1 ||
      (block_kv * d) % align || kv_head_stride % align ||
      kv_blk_stride % align || h_head_stride % 4 || h_blk_stride % 4 ||
      z_head_stride % 4 || z_blk_stride % 4 ||
      (hdiag == nullptr) != (zdiag == nullptr) || group < 1 || kv_mod < 1 ||
      heads < 1 || num_blocks < 1 || k_sel < 1 || width < 1 ||
      width > k_sel || nsplit != (k_sel + width - 1) / width ||
      c_len < 1 || c_len > kMaxGrid || bh_q < 1 || bh_q > kMaxGrid ||
      work == nullptr ||
      (rec_out == nullptr && (htot == nullptr || ztot == nullptr ||
                              o_s == nullptr || o_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tag, auto paged, auto cols) {
    using T = decltype(tag);
    return launch<T, decltype(paged)::value, decltype(cols)::value>(
        lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag, htot,
        ztot, pt, work, o_s, o_l, rec_out, bh_q, c_len, k_sel, tn,
        num_blocks, d,
        block_kv, group, heads, kv_mod, scale, kv_head_stride,
        kv_blk_stride, h_head_stride, h_blk_stride, z_head_stride,
        z_blk_stride, tot_per_token, width, nsplit, st);
  };
  auto at_width = [&](auto cols) {
    using Paged = std::true_type;
    using Flat = std::false_type;
    if (pt != nullptr)
      return is_bf16 ? go(__nv_bfloat16(), Paged(), cols)
                     : go(float(), Paged(), cols);
    return is_bf16 ? go(__nv_bfloat16(), Flat(), cols)
                   : go(float(), Flat(), cols);
  };
  if (d <= dim_of(kNarrowCols))
    return at_width(std::integral_constant<int, kNarrowCols>());
  return at_width(std::integral_constant<int, kWideCols>());
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
// of d contiguous elements inside a block. `work` is an f32 workspace of
// bh_q * c_len * (nsplit + 1) * (4 + 2 d) floats (its contents need not be
// set); each block walks `width` LUT slots of its row and nsplit =
// ceil(k_sel / width). Requires d <= 256, d % 4 == 0, block_kv <= 64,
// K/V tiles (block_kv x d) of a multiple of 16 bytes and strides of 16
// bytes, 1 <= width <= k_sel, and c_len, bh_q <= 65535 (the wrapper
// checks).
// Returns a cudaError_t value (0 on success). The two launches (split,
// combine) are asynchronous on `stream` and allocate nothing.
extern "C" int sla_decode_launch(
    const int32_t* lut, const int32_t* cnt, const int32_t* marg,
    const int32_t* posv, const float* q, const float* qp, const void* k,
    const void* v, const float* hblk, const float* zblk, const float* hdiag,
    const float* zdiag, const float* htot, const float* ztot, float* work,
    float* o_s, float* o_l, int bh_q, int c_len, int k_sel, int tn, int d,
    int block_kv, int group, float scale, long long kv_head_stride,
    long long kv_blk_stride, long long h_head_stride, long long h_blk_stride,
    long long z_head_stride, long long z_blk_stride, int tot_per_token,
    int width, int nsplit, int is_bf16, void* stream) {
  const int bh_kv = group > 0 ? bh_q / group : 0;
  return launch_any(is_bf16, lut, cnt, marg, posv, q, qp, k, v, hblk, zblk,
                    hdiag, zdiag, htot, ztot, nullptr, work, o_s, o_l,
                    nullptr, bh_q, c_len, k_sel, tn, tn, d, block_kv, group,
                    1, bh_kv,
                    scale, kv_head_stride, kv_blk_stride, h_head_stride,
                    h_blk_stride, z_head_stride, z_blk_stride, tot_per_token,
                    width, nsplit, stream);
}

// The paged kernel (single token, live row). lut, cnt, marg, q, qp and the
// outputs have one row per bh = b * heads + h, heads = group * hkv; posv
// one entry per bh; pt is (B, tn) int32 with rows b = bh / heads; htot,
// ztot one running total per (b, kv head), row bh / group. k and v are the
// layer's pools (pages, hkv, block_kv, d), hblk (pages, hkv, d, d) and zblk
// (pages, hkv, d), addressed as base + ((bh / group) % hkv) * head_stride +
// page * page_stride (elements), rows of d contiguous elements. The same
// workspace, width, limits and return value as sla_decode_launch.
extern "C" int sla_decode_paged_launch(
    const int32_t* lut, const int32_t* pt, const int32_t* cnt,
    const int32_t* marg, const int32_t* posv, const float* q,
    const float* qp, const void* k, const void* v, const float* hblk,
    const float* zblk, const float* htot, const float* ztot, float* work,
    float* o_s, float* o_l, int bh_q, int k_sel, int tn, int num_pages,
    int d, int block_kv, int group, int hkv, float scale,
    long long kv_head_stride, long long kv_page_stride,
    long long h_head_stride, long long h_page_stride,
    long long z_head_stride, long long z_page_stride, int width, int nsplit,
    int is_bf16, void* stream) {
  if (pt == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(is_bf16, lut, cnt, marg, posv, q, qp, k, v, hblk, zblk,
                    nullptr, nullptr, htot, ztot, pt, work, o_s, o_l,
                    nullptr, bh_q, 1, k_sel, tn, num_pages, d, block_kv,
                    group, group * hkv,
                    hkv, scale, kv_head_stride, kv_page_stride,
                    h_head_stride, h_page_stride, z_head_stride,
                    z_page_stride, 0, width, nsplit, stream);
}

// The partial mode (a rank's span of a sharded decode cache): the operands
// of sla_decode_launch without the totals and marg, the outputs replaced
// by `rec`, (bh_q, c_len, 2 d + 3) f32 rows (m, l, acc[d], hsel[d],
// zsel): the row max over the walked columns (-1e30 where the row walks
// none), the sum of exponentials against it, the unnormalised sparse
// output, hsel = phi(q) sum H_j and zsel = phi(q) sum Z_j over the walked
// blocks. The LUT holds this rank's blocks in its own block ids, a row
// per (bh, c); posv (one a row, so each slot's rows carry its own
// position) is shifted by the span's first position, so the causal mask
// sees global columns: token c sits at posv + c, below 0 where it comes
// before the span. hdiag and zdiag (per-token diagonal partials, rows
// (bh / group) * c_len + c, as sla_decode_launch's) or both null: a chunk
// whose tokens fill the diagonal block in this span reads its at-time
// partial there. The same workspace, width, limits and return value as
// sla_decode_launch.
extern "C" int sla_decode_partial_launch(
    const int32_t* lut, const int32_t* cnt, const int32_t* posv,
    const float* q, const float* qp, const void* k, const void* v,
    const float* hblk, const float* zblk, const float* hdiag,
    const float* zdiag, float* work, float* rec, int bh_q, int c_len,
    int k_sel, int tn, int d, int block_kv, int group, float scale,
    long long kv_head_stride, long long kv_blk_stride,
    long long h_head_stride, long long h_blk_stride,
    long long z_head_stride, long long z_blk_stride, int width, int nsplit,
    int is_bf16, void* stream) {
  if (rec == nullptr) return (int)cudaErrorInvalidValue;
  const int bh_kv = group > 0 ? bh_q / group : 0;
  return launch_any(is_bf16, lut, cnt, nullptr, posv, q, qp, k, v, hblk,
                    zblk, hdiag, zdiag, nullptr, nullptr, nullptr, work,
                    nullptr, nullptr, rec, bh_q, c_len, k_sel, tn, tn, d,
                    block_kv, group, 1, bh_kv, scale, kv_head_stride,
                    kv_blk_stride, h_head_stride, h_blk_stride,
                    z_head_stride, z_blk_stride, 0, width, nsplit, stream);
}

// The paged partial mode (a rank's span of a sharded paged decode cache,
// single token, live row): the partial mode's record, read through a page
// table as the paged kernel reads it. lut holds the live row's blocks that
// lie in the span, in the span's own logical ids (0 .. tn - 1); pt is the
// span's page table, (B, tn) int32, logical block j of slot b in page
// pt[b * tn + j] of the rank's pools; posv is each row's position less the
// span's first position. The pools, heads and strides as
// sla_decode_paged_launch's; rec as sla_decode_partial_launch's, one row
// per bh. The same split width and record order as the partial mode on the
// page-gathered view of the span: bitwise equal to it.
extern "C" int sla_decode_paged_partial_launch(
    const int32_t* lut, const int32_t* pt, const int32_t* cnt,
    const int32_t* posv, const float* q, const float* qp, const void* k,
    const void* v, const float* hblk, const float* zblk, float* work,
    float* rec, int bh_q, int k_sel, int tn, int num_pages, int d,
    int block_kv, int group, int hkv, float scale,
    long long kv_head_stride, long long kv_page_stride,
    long long h_head_stride, long long h_page_stride,
    long long z_head_stride, long long z_page_stride, int width, int nsplit,
    int is_bf16, void* stream) {
  if (pt == nullptr || rec == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(is_bf16, lut, cnt, nullptr, posv, q, qp, k, v, hblk,
                    zblk, nullptr, nullptr, nullptr, nullptr, pt, work,
                    nullptr, nullptr, rec, bh_q, 1, k_sel, tn, num_pages, d,
                    block_kv, group, group * hkv, hkv, scale,
                    kv_head_stride, kv_page_stride, h_head_stride,
                    h_page_stride, z_head_stride, z_page_stride, 0, width,
                    nsplit, stream);
}

extern "C" const char* sla_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
