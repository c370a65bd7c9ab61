#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py             # the check, on one card
    python3 chip_smoke.py --profile   # also profile one full-width forward,
                                      # one full-width training step,
                                      # 8 full-width LM decode steps, one
                                      # full-width LM prefill and 8 paged
                                      # LM decode steps

Phases, in order; any failure exits non-zero before the result line:
  1. card: nvidia-smi name and power limit; TF32 off for matmul and cuDNN.
  2. build: every CUDA kernel source of the port, one nvcc each, all
     started together, with the -Xptxas -v report.
  3. kernel vs plain twin: `sla_fwd` against `sla_fwd_plain` on the same
     card tensors at the Wan2.1 shape (B=1, H=12, N=32768, D=128) and the
     LightningDiT shape (H=16, N=1024, D=108), 64x64 blocks, LUTs from
     `plan_attention`, in f32 and bf16, each on the route
     `sla_fwd.forward_route` picks, checked by that route's counters. The
     f32 cases take the split kernel (tensor cores, bf16x3 products) and
     its K/V pre-pass: o_s, o_l and lse each within 5e-5 x max(1, max
     |twin|) of the f32 twin (the twin that cuts and sums alike printed
     beside it), two launches bitwise equal; the pre-pass is held bitwise
     to its twin on the Wan K/V, and the f32-FMA kernel, forced, is held
     (max abs error against 5e-5) and timed beside the split kernel at the
     Wan case. The bf16 cases take the tensor-core kernel, held on (o_s,
     lse) by `cases.tc_criterion` against the f32 twin and the twin that
     rounds P to bf16, on o_l to 5e-5 x max(1, max |twin|), two launches
     bitwise equal; so are a causal GQA-2 case (H 12, BH_kv 6, N 4096, D
     128, the query span from block 32 on, base 32) and the Wan operands
     in both dtypes with every row cut to its diagonal block (count 1: the
     time of the linear-branch epilogue and one tile). The f32-FMA kernel's
     own calls, the LightningDiT shape at 32x32 blocks in f32 and bf16, are
     held to 5e-5. CUDA-event times of the kernel, the plain twin, the
     gather backend, and dense scaled_dot_product_attention (a yardstick
     for dense attention, not the same function), the route's bound and
     its fraction (the split route's beside the f32-FMA one).
  4. main path: the DiffusionScheduler serving wan2_1_1_3b at full width
     and depth (30 layers, random seeded weights) on the kernel backend in
     f32: 3 requests at seq_len 32768 (t_start 1.0, 0.75, 1.0; 4 steps
     each) through 2 slots. Checks every request finished with finite
     latents and that the kernel ran 30 times per forward, every launch on
     the split route with one pre-pass launch each, none on the bf16
     tensor-core route.
  5. cross-check: one full-width forward on the kernel backend and again
     on the gather backend with the same inputs and plans (1e-4 of max
     |v|); then the kernel against its twin on that forward's own
     sparse, uneven LUTs of the first and last layer at the Wan shape (f32
     on the split route, and the f32-FMA kernel forced beside it, as in
     phase 3; bf16 on tensor cores by phase 3's criterion). `--profile`
     adds a profile of one full-width f32 forward: kernel 1's launches,
     mean times and share of the device time.
  6. plan cache (on phase 4's model, with phase 5's plans alive): the
     DiffusionScheduler as in phase 4 but with the reference plan-cache
     stage's policy (adaptive refresh, drift threshold 0.3, 8 timestep
     buckets) drains the same 4 seeded requests (each its own latent and
     text condition, 3 steps from t 1.0) twice, the cache off and then
     on. Checks every latent finite and of shape (32768, 64); with the
     cache on 3 hits, 1 miss, 0 evictions, 60 entries and 60 puts plus
     the invalidations; 30 plan builds on, 120 off; 30 `sla_fwd` launches
     a forward in both runs, all on the split route with one pre-pass
     each, none on the bf16 route; on each hit, every layer the drift
     check kept bitwise equal to its cache entry; and one full-width
     30-layer stack (phase 5's) through `serialize_plan` ->
     `deserialize_plan` bitwise on all six leaves. Prints the
     invalidations, re-plans, reuses, the lowest retention, each
     request's admission wall and latency in both runs, max |latent(on)
     - latent(off)| against max |latent|, the stack's bytes and its
     serialize (device->host) and deserialize (host->device) times, the
     host bytes the cache holds, and peak device memory.
  7. backward kernels vs plain twins: `sla_bwd_dq` and `sla_bwd_dkv`
     against `sla_bwd_dq_plain` / `sla_bwd_dkv_plain` on the same card
     tensors (L and O^s from the forward kernel, a seeded dO), at both
     shapes of phase 3 with their random LUTs, a causal GQA-2 case (H 12,
     N 4096, D 128) and on the full-width forward's layer-0 and layer-29
     LUTs, f32 and bf16. The f32 cases take the f32-FMA kernels, held to
     5e-5 x max(1, max |twin|). The bf16 cases (all at 64 x 64 blocks)
     take the tensor-core kernels (checked by their own launch counters),
     held by `cases.tc_criterion`: err(kernel, f32 twin) <= 2 err(rounded
     twin, f32 twin) + 5e-5 m and <= 5e-2 m, m = max(1, max |twin|), the
     rounded twin rounding dO, P and dS to bf16 where the kernels do; two
     launches bitwise equal. CUDA-event times of kernel and twin, live
     tiles, the bound and its fraction, and the backward of dense
     scaled_dot_product_attention as a yardstick (not the same function).
     At the Wan shape and on the path's LUTs also the library call:
     compiled flex_attention on a BlockMask of the same row LUT, whose
     backward computes the same dQ, dK and dV as both kernels together
     (its f32 gradients held to 1e-4 x max(1, max |g|) of the kernels').
  8. gradient cross-check: at the Wan shape on layer 0's plan, one
     `sla_attention_core` call on the kernel backend (both backward
     kernels) against the gather backend's autograd: in f32, grads of q,
     k, v, qp and kp within 1e-4 x max(1, max |g|); in bf16 (the
     tensor-core kernels) against the gather backend's f32 autograd on
     the same bf16-rounded inputs, by `cases.tc_criterion` with the kernel
     backend run once more through the rounded twins (the forward's too)
     as the "rounded" term; one tensor-core launch of each kernel.
  9. training main path: `make_train_step` (AdamW, bf16 compute over f32
     masters, kernel backend) on the phase-4 model under per-layer remat,
     3 steps at seq_len 32768, batch 1 (`dit_video_32k` has 16), on
     `latent_batch` data. Checks finite losses and grad norms, that the
     parameters moved, and per step exactly 60 `sla_fwd` launches (30
     layers, each run twice: the forward and its remat recompute), 30
     `sla_bwd_dq`, 30 `sla_bwd_dkv` (all 120 on the tensor-core route) and
     30 plan builds. `--profile` adds the tensor-core kernels' mean device
     time per launch on the training step's own plans.
 10. train CLI on the card (its loss runs the gather backend, as the
     reference's CLI): the lightningdit_1b smoke fine-tuning recipe
     (distillation, learned routing, routing + sla_proj trained, warm
     init), 3 steps, finite losses (exactly 0: the frozen output
     projection is zero); then 2 steps of the plain flow-matching loop,
     whose losses must be non-zero and change.
 11. decode kernel vs plain twin: `sla_decode` (the split kernel and its
     combine) against `sla_decode_plain` on the same card tensors at the
     Qwen3-1.7B decode shape (B 2, H 16, Hkv 8, D 128, 64-token blocks,
     Tn 512 = max_len 32768, K 26), a random live row at a position
     mid-block, C = 1 (live-row layout: one running total per kv head, no
     diagonal partials) and C = 4 (per-token hdiag / htot), K/V in f32
     and bf16, rows with marg = 0 and padded LUT slots naming another
     block; at the chosen split width and at widths 1 and 2, each printed
     with its splits and grid size: max abs error against 5e-5 x max(1,
     max |twin|), exact zeros where marg = 0, two launches bitwise equal;
     device times (CUDA events around CUDA-graph replays: an eager call's
     host dispatch outlasts the kernels) of each width, the eager call's
     time, the twin's, the bound, and dense scaled_dot_product_attention
     of one bf16 query token over the whole 32768-token cache (a
     yardstick, not the same function: no PyTorch call computes O^l).
 12. LM main path (after the DiT models are freed): the static
     ServingEngine serving qwen3-1.7b at full width and depth (28
     layers, random seeded weights, sla_proj redrawn) on the kernel
     backend with decode-time SLA, bf16 compute over f32 weights, batch
     2, max_len 32768: 4 requests (prompts 32000, 31937, 32000, 31990 in
     a 32000 bucket; 96, 80, 96, 80 new tokens), 2 groups of 95 decode
     steps, each crossing the block boundaries at 32000 and 32064.
     Checks every request's token count, finite logits, 28 x 190
     `sla_decode`, 0 `sla_decode_paged` and 28 x 2 `sla_fwd` launches
     (all on the tensor-core route), and the decode-plan
     counters (56 builds, 56 extends, 112 re-plans + reuses).
 13. LM cross-checks on the main path's own state after its last
     boundary: decode_execute on the kernel vs the gather backend and
     `sla_decode` vs its twin on the live LUTs of layers 0 and 27 as in
     phase 11 (three widths, 5e-5 x max(1, max |twin|), two launches
     bitwise equal, device times); one full decode step's logits, kernel
     vs gather backend from the same cache (5e-2 x max(1, max |logits|),
     bf16 compute), with the greedy-token agreement; `sla_fwd` vs its
     twin on the Qwen3 prefill's layer-0 and layer-27 LUTs (causal, bf16,
     tensor cores, phase 3's criterion, K/V repeated to the 16 query heads
     as the kernel backend gives them), and the same call on the 8 kv
     heads unrepeated (group 2), bitwise equal and timed. `--profile`
     adds a profile of 8 decode steps (the decode kernels' device time
     among it) and one of a prefill (the forward kernel's share of its
     device time).
 14. paged decode kernel vs plain twin: `sla_decode_paged` against
     `sla_decode_paged_plain` on the same card tensors at the Qwen3-1.7B
     decode shape with 4 slots (B 4, H 16, Hkv 8, D 128, bkv 64, Tn 512,
     K 26) over a pool of 1,029 pages whose page table shares the slots'
     first 480 pages and gives each 32 distinct shuffled ones (608 in
     use), a live row mid-block (row 500), K/V in f32 and bf16, rows with
     marg = 0, and padded LUT slots whose pages hold NaN; at the chosen
     split width and at widths 1 and 2, each printed with its splits and
     grid size: max abs error against 5e-5 x max(1, max |twin|), finite
     outputs, exact zeros where marg = 0, two launches bitwise equal, and
     bitwise equality with `sla_decode` (kernel 4) at the same width on
     the page-gathered monolithic view of the same state; device times
     (CUDA-graph replays) of each width and of kernel 4 on the view, the
     eager call's and the twin's, and the bound.
 15. paged LM main path (after phase 12's engine and state are freed, on
     phase 12's model): first a probe of the prefix-sharing premise at the
     default column capacity (two batch-1 prefills of prompts sharing
     30,720 tokens; the elements of their shared pages that differ are
     measured, not checked). Then the continuous `Scheduler` with a paged,
     prefix-shared KV cache (4 slots, max_len 32768, a pool of 1,029
     pages, prefill bucket 32000, decode-SLA, kernel backend, bf16
     compute, the default config, whose col_capacity_factor the paged
     Scheduler lifts to None) drains 6 requests of 32,000-token
     prompts submitted at once: requests 0-3 and 5 share their first
     30,720 tokens (480 pages), request 4 repeats request 1 (a
     full-prompt snapshot hit, no prefill), request 5 samples
     (temperature 0.8, seed 3); 96, 64, 80, 48, 72 and 64 new tokens.
     Checks every request's token count, finite logits, the trace's
     counters (126 decode steps, 28 x 126 `sla_decode_paged`, 0
     `sla_decode` and 28 x 5 `sla_fwd` launches, all on tensor cores,
     1 full-prompt hit,
     2,420 / 580 prefix hits / misses, 9 CoW copies, 593 allocations,
     418 decode tokens, 504 slot-steps, 140 / 84 / 252 decode-plan
     builds / extends / decisions), 5 prefills, pages peak <= 1,029
     (printed against the 2,053 of an unshared pool), and through a hook
     on `insert_slot_paged` that every prefix page an admission rewrites
     (4 x 480) is bitwise what the pool held. Prints prefill time per
     admission, each request's TTFT, decode ms per step and per token,
     and peak memory; `--profile` adds a profile of 8 paged decode
     steps with 4 slots decoding.
 16. paged cross-checks, by a hook inside phase 15's trace right after
     the last block boundary, with 2 slots decoding: decode_execute on
     the kernel vs the gather backend and `sla_decode_paged` vs its twin
     on the live LUTs of layers 0 and 27 (5e-5 x max(1, max |ref|)) as in
     phase 14 (three widths, bitwise repeats, bitwise equal to kernel 4
     on the gathered view, device times); one
     full decode step's bf16 logits, kernel vs gather, from the same
     cache (5e-2 x max(1, max |logits|)), with the greedy-token
     agreement; the step's writes are put back, and the checks'
     launches are not counted.
 17. unpaged mixed tick (after phase 15's scheduler is freed, on phase
     12's model, default config): the continuous `Scheduler` with its
     unpaged per-slot cache (3 slots, max_len 32768, prefill bucket
     32000, decode-SLA, kernel backend, bf16 compute) drains 3 requests
     of phase 15's first 3 prompts: request 0 samples (temperature 0.8,
     seed 3, 6 new tokens) beside greedy requests of 65 and 70, so the
     drain alternates masked sampling steps and masked greedy rolls (the
     whole batch runs and the frozen slots' writes are put back). Checks
     the token counts, finite logits, the counters (74 decode steps,
     28 x 74 `sla_decode`, 0 `sla_decode_paged` and 28 x 3 `sla_fwd`
     launches, all on tensor cores, 138 decode tokens, 222 slot-steps),
     and that in the
     second sampling step the greedy slot frozen at the block boundary
     32064, which appends a plan row, comes back with every leaf bitwise
     as before (a whole-slot copy, ~11 GiB); prints the masked step's
     time, decode ms per step and peak memory.
 18. chunked admission (on phase 12's model): the paged continuous
     `Scheduler` (4 slots, max_len 32768, 1,160 pages, bucket 32000,
     decode-SLA, kernel backend, bf16) runs one trace twice, blocking and
     with `prefill_chunk_blocks=125` (8,000-token chunks, 4 an
     admission): r0 (32,000 tokens, 96 new) until its first token, then
     r1 (unrelated, 64 new) until its first token, then r2 (r1's first
     24,000 tokens and its own 8,000, 48 new) and r3 (r0 again, 32 new),
     stepped one decode token a tick to the end (the gaps between
     emissions are then the stalls admission work causes). Checks the
     token counts, finite logits, 3 chunked
     admissions, 9 chunks, 72,000 prefill tokens, one full-prompt hit
     (r3 makes no dispatch), r2's resume at 24,000 with its 375 shared
     pages claimed from the intern index, 28 x 9 `sla_fwd` launches all
     on tensor cores, one `sla_decode_paged` a layer and step, r0's 3 or
     more tokens between r1's start and first token, every rewritten
     prefix page bitwise what the pool held (both runs), and r0's K/V
     after 4 tokens chunked vs blocking within 5e-2 x max(1, max |x|)
     (elements that differ counted). Prints max_decode_gap_s, TTFTs,
     prefill per chunk and per admission, greedy agreement, the
     snapshots' bytes and peak memory of both runs. Then kernel 1 against
     its twin on r1's last chunk at layers 0 and 27 (base 375, 125 query
     blocks against 500 KV blocks, causal, K/V repeated as the path gives
     them; `cases.tc_criterion`, two launches bitwise equal), with its
     CUDA-event time and bound.
 19. verify-style decode (on phase 12's model): a static decode-SLA
     state of 2 x 32,000-token prompts (`prefill(decode_max_len=32768)`,
     ~24 GiB, one clone kept); two `decode_chunk` calls of 16 fed tokens
     from 32000 and 32016 on the kernel backend beside 32 `decode_step`s
     from the clone. Checks logits and float cache leaves within 5e-2 x
     max(1, max |x|) (integer leaves: differing entries counted), 28
     `sla_decode` launches a chunk, and on the first chunk's own
     per-token state at layers 0 and 27 `decode_execute_chunk` kernel vs
     gather on f32 queries (5e-5 x max(1, max |ref|)) and `sla_decode`
     vs its twin at
     three split widths (two launches bitwise equal, CUDA-graph times,
     bound). Prints each chunk's wall against 16 steps'.
 20. disaggregated serving (on phase 12's model, col_capacity_factor
     lifted to None, printed): 8 prompts of 4,500-8,000 tokens (r4 r0's
     first 6,144 tokens and 1,856 of its own), 32-64 new tokens, r0-r3
     submitted, 3 ticks, r4-r7, drained; three runs freed one after
     another: the paged single `Scheduler` (2 slots, max_len 8192, bucket
     8000, blocking), then the `DisaggScheduler` (2 prefill workers, 3
     decode workers of 2 slots, paged, 2,048-token chunks) healthy
     (rolled decode) and faulted (per-token decode, the virtual clock, a
     flake on decode:1 at tick 2, a x10 straggle on decode:2 at tick 4,
     a kill of decode:0 at tick 7 with r0 mid-stream). Checks equal
     tokens across the three runs, 8 completions and handoffs, 28 chunks
     and 55,808 prefill tokens (r4 resumes at 6,144, r6 at 2,048: its
     first chunk is left padding, as r3's), one kill, retry and drain
     and a replay of r0 from its bundle, 28 x 28 `sla_fwd` launches on
     tensor cores and 28 `sla_decode_paged` a decode step of each worker
     (no `sla_decode`), r0's bundle bitwise its host clone after the
     drain, r0's slot state and 125 prompt pages after the replayed
     admission bitwise what its first admission left (host copies), kernel
     5 against its twin on the replayed worker's live LUT rows after its
     first step there (layers 0 and 27, three widths, repeats bitwise) and
     kernel 1 on r1's last chunk (base 96, 29 query blocks against 125,
     `cases.tc_criterion`). Prints each run's wall and TTFTs (p50, p95),
     handoff waits in ticks, `admit_external` seconds, a bundle's bytes
     (k/v, hblk, the rest) and the most held at once, occupancies, the
     pool rows, ms a decode step by worker and peak memory.
 21. the kernels line (JSON): `sla_fwd` carries the split route's fields
     at the top (the f32 serving route) and the f32-FMA and bf16
     tensor-core routes' beside them; `sla_fwd_split_planes` is the split
     route's pre-pass; then the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The compiled flex_attention of phase 7 (a library yardstick) compiles in
# this process and keeps its caches in the checkout's build directory.
for _var, _dir in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / _dir))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import DIT_SHAPES, get_arch  # noqa: E402
from repro_torch.core import phi as phi_lib  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core.block_sparse_xla import sla_forward_gather  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_iterator  # noqa: E402
from repro_torch.distributed import ctx as actx  # noqa: E402
from repro_torch.core import backends as backend_lib  # noqa: E402
from repro_torch.kernels import _build, ops, sla_bwd, sla_fwd  # noqa: E402
from repro_torch.kernels import cases, sla_decode  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import dit  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.serving.diffusion import (DenoiseParams,  # noqa: E402
                                           DiffusionScheduler)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# Kernel vs plain twin: both read the same (possibly bf16) inputs and
# accumulate in f32, so bf16 is held to the f32 limit too; the 5e-2 of
# tests/test_conformance.py is for the port's bf16 path against JAX's.
# The exception is the tensor-core route (bf16 at 64 x 64 blocks), which
# rounds P (forward) and dO, P and dS (backward) to bf16 before their
# products: it is held by `cases.tc_criterion` against the twin that
# rounds alike (the forward's O^l, f32 arithmetic, stays at 5e-5).
TWIN_TOL = 5e-5
FWD_TOL = 1e-4  # kernel vs gather velocity, relative to max(1, max |v|)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,  # f32 FMA on CUDA cores
              torch.bfloat16: 989e12,  # bf16 dense tensor cores
              "fma": 67e12, "tc": 989e12}  # the forward's routes
SHAPES = {  # name: (arch, heads, seq_len, head_dim)
    "wan2_1_1_3b": ("wan2_1_1_3b", 12, 32768, 128),
    "lightningdit_1b": ("lightningdit_1b", 16, 1024, 108),
}
MAIN_SEQ, MAIN_SLOTS, MAIN_STEPS = 32768, 2, 4
MAIN_T_STARTS = (1.0, 0.75, 1.0)
# the plan-cache trace (phase 6): a fleet denoising at one resolution and
# schedule, the reference plan-cache stage's policy, cache off then on
PC_REQUESTS, PC_STEPS, PC_THRESHOLD, PC_BUCKETS = 4, 3, 0.3, 8
GRAD_TOL = 1e-4  # kernel vs gather gradients, relative to max(1, max |g|)
TRAIN_STEPS, TRAIN_BATCH = 3, 1  # dit_video_32k's global batch 16, cut
PROBES = ("layers.0.wq", "layers.29.sla_proj", "patch_out")
# backward kernels: (kernel, plain twin, operations per live tile / bq bkv D)
BWD = {"sla_bwd_dq": (sla_bwd.sla_bwd_dq, sla_bwd.sla_bwd_dq_plain, 6),
       "sla_bwd_dkv": (sla_bwd.sla_bwd_dkv, sla_bwd.sla_bwd_dkv_plain, 8)}
# the LM main path and the decode kernel's shape (qwen3-1.7b decode)
LM_ARCH, LM_BATCH, LM_MAX_LEN = "qwen3-1.7b", 2, 32768
LM_PROMPTS, LM_MAX_NEW = (32000, 31937, 32000, 31990), (96, 80, 96, 80)
LM_LOGIT_TOL = 5e-2  # kernel vs gather logits in bf16 compute
# the paged LM main path: 4 slots over a pool of 1,029 pages (2,053 hold 4
# unshared slots); 6 prompts of 32,000 tokens, 5 sharing their first
# 30,720 (480 pages), request 4 a repeat of request 1, request 5 sampling
PG_SLOTS, PG_POOL, PG_PROMPT, PG_SHARED = 4, 1029, 32000, 30720
PG_NEW = (96, 64, 80, 48, 72, 64)
PG_SAMPLED = 5
# the trace's counters, from the reference scheduler's rules (28 layers)
PG_EXPECT = dict(steps=126, sla_decode_paged=28 * 126, sla_decode=0,
                 sla_fwd=28 * 5, tc_sla_fwd=28 * 5, prefix_full_hits=1,
                 prefix_hits=2420,
                 prefix_misses=580, cow_copies=9, page_allocs=593,
                 decode_tokens=418, slot_steps_total=504,
                 decode_plan_builds=140, decode_plan_extends=84,
                 decode_plan_decisions=252)
# the unpaged mixed tick: request 0 samples beside two greedy ones in 3
# slots; 1 + 64 + 1 + 5 + 3 decode steps (a sampling step, a masked roll
# of 64, a sampling step with greedy slot 2 frozen at the appending
# boundary 32064, a masked roll of 5, then 3 sampling steps alone)
PU_NEW = (6, 65, 70)
PU_EXPECT = dict(steps=74, sla_decode=28 * 74, sla_decode_paged=0,
                 sla_fwd=28 * 3, tc_sla_fwd=28 * 3,
                 decode_tokens=5 + 64 + 69,
                 slot_steps_total=3 * 74)
# chunked admission (phase 18): 8,000-token chunks of a 32,000 bucket; r0
# and r1 unrelated, r2 shares r1's first 24,000 tokens, r3 repeats r0. The
# pool holds the trace's 1,125 prompt pages with all four live (1 + 4 +
# 1,125 + decode pages), which 1,029 cannot
PC_CHUNK_BLOCKS, PC_POOL, PC_SHARED = 125, 1160, 24000
PC_NEW = (96, 64, 48, 32)
PC_EXPECT = dict(chunked_admissions=3, prefill_chunks=9,
                 prefill_tokens=72000, prefix_full_hits=1,
                 sla_fwd=28 * 9, tc_sla_fwd=28 * 9)
DC_C = 16  # verify-style decode_chunk (phase 19): tokens a chunk
# disaggregated serving (phase 20): 2 slots a decode worker, 2,048-token
# chunks of an 8,000 bucket (32, 32, 32, 29 blocks), r4 shares r0's first
# three chunks. r6's first 2,048 tokens are left padding, as are r3's, so
# r6 resumes from r3's first snapshot too: 28 chunks, 7 x 8,000 + 1,856 -
# 2,048 tokens
DG_LENS = (8000, 6000, 7000, 5000, 8000, 8000, 4500, 6000)
DG_NEW = (48, 64, 32, 56, 40, 64, 48, 32)
DG_SLOTS, DG_BUCKET, DG_MAX_LEN, DG_CHUNK_BLOCKS = 2, 8000, 8192, 32
DG_SHARED, DG_EARLY_TICKS, DG_LAST_BASE = 6144, 3, 96
DG_FAULTS = (dict(tick=2, kind="flake", pool="decode", worker=1),
             dict(tick=4, kind="straggle", pool="decode", worker=2,
                  factor=10.0),
             dict(tick=7, kind="kill", pool="decode", worker=0))
DG_RESUMES = ((4, 6144), (6, 2048))
DG_EXPECT = dict(submitted=8, completed=8, handoffs=8, prefill_chunks=28,
                 prefill_tokens=7 * 8000 + 1856 - 2048)
DEV = torch.device("cuda")


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device time of fn() from CUDA events around replays of one
    CUDA graph that holds `reps` calls: for kernels shorter than the
    host's dispatch of their call, where `cuda_ms` times the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


# --------------------------------------------------------------------------
def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[1 card] torch {torch.__version__} (CUDA {torch.version.cuda}) | "
        f"{torch.cuda.get_device_name(0)} | {torch.cuda.device_count()} "
        f"device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.time()
    logs = _build.build_all()
    say(f"[2 build] {len(logs)} kernel source(s) in {time.time() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if re.search(r"registers|spill|smem|stack frame", line):
                say(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------------
def _kernel_inputs(arch: str, h: int, n: int, d: int, seed: int,
                   block=None):
    """Seeded q/k/v at one shape and the port's plan for them (at the
    arch's blocks, or `block` x `block`)."""
    cfg = get_arch(arch)
    sla = cfg.sla.replace(causal=False)
    if block is not None:
        sla = sla.replace(block_q=block, block_kv=block)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    plan = plan_lib.plan_attention(q, k, sla)
    return sla, q, k, v, plan


def _operands(sla, q, k, v, marginal, lut, counts, dtype):
    """The kernel's flattened operands in `dtype` for one plan's
    (B, H, ...) marginal / lut / counts, with hi/zi aggregated as the
    kernel backend does, plus the 4-D inputs for the backends."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi_lib.phi(q, sla.phi), phi_lib.phi(k, sla.phi)
    fq, fk, fv, fqp, fkp = map(ops._flat, (q, k, v, qp, kp))
    a, lut, counts = map(ops._flat, (marginal, lut, counts))
    hb, zb = ops._hz_blocks(fkp, fv, sla.block_kv)
    hi, zi = ops._aggregate(a, hb, zb)
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=q.shape[-1] ** -0.5, causal=False,
              block_q=sla.block_q, block_kv=sla.block_kv)
    return args, kw, (q, k, v, qp, kp)


def _bound(args, kw, route=None):
    """Least time for this call on `route` (default: the one
    `sla_fwd.forward_route` picks): the larger of bytes (each input read
    once, each output written once) over HBM bandwidth and this data's
    operations (live critical tiles + linear merge) at the route's rate:
    all at 67 TFLOP/s on the f32-FMA route, all at 989 on the tensor-core
    route, and on the split route the tile products six times at 989 (its
    six bf16 part products) plus the linear merge's f32 FMAs at 67."""
    lut, counts, q, k, v, qp, hi, zi = args
    bh, nq, d = q.shape
    bq, bkv = kw["block_q"], kw["block_kv"]
    route = route or sla_fwd.forward_route(q.dtype, bq, bkv, d)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += 2 * bh * nq * d * 4 + bh * nq * 4  # o_s, o_l, lse
    live = int(torch.clamp(counts, max=lut.shape[-1]).sum())
    tile_flops = live * 4 * bq * bkv * d
    lin_flops = (nq // bq) * bh * (2 * bq * d * d + 2 * bq * d)
    flops = tile_flops + lin_flops
    if route == "split":
        t_ops = (sla_fwd.SPLIT_PRODUCTS * tile_flops / PEAK_FLOPS["tc"]
                 + lin_flops / PEAK_FLOPS["fma"])
    else:
        t_ops = flops / PEAK_FLOPS[route]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            live)


FWD_TC_ROUTE = "tensor cores, wgmma m64n64k16 (sla_fwd_tc.cu)"
FWD_SPLIT_ROUTE = ("tensor cores, bf16x3 split products on wgmma m64n64k16 "
                   "(sla_fwd_split.cu)")
FWD_F32_ROUTE = "f32 FMA on CUDA cores (sla_fwd.cu)"
FWD_ROUTES = {"tc": FWD_TC_ROUTE, "split": FWD_SPLIT_ROUTE,
              "fma": FWD_F32_ROUTE}


def _fwd_counters():
    return (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES, sla_fwd.SPLIT_LAUNCHES,
            sla_fwd.PLANES_LAUNCHES)


def _fwd_call(args, kw, route=None):
    """The forward on `route`: through `sla_fwd.sla_fwd` where the rule
    picks that route, else forced through `sla_fwd._launch`."""
    q = args[2]
    if route is None or route == sla_fwd.forward_route(
            q.dtype, kw["block_q"], kw["block_kv"], q.shape[-1]):
        return lambda: sla_fwd.sla_fwd(*args, **kw)
    return lambda: sla_fwd._launch(*args, **{"base": 0, **kw}, route=route)


def _fwd_check(args, kw, what: str, route=None) -> dict:
    """The forward kernel of `route` (default: the rule's) against its plain
    twin on the same card operands. The f32-FMA route: max abs error over
    o_s, o_l and lse against 5e-5. The split route: each of o_s, o_l and
    lse within 5e-5 x max(1, max |twin|) of the f32 twin (the distance
    from the twin that cuts and sums alike, `mma_dtype="bf16x3"`, is
    printed beside it). The tensor-core route: (o_s, lse) by
    `cases.tc_criterion` against the f32 twin and the twin that rounds P
    to bf16, o_l (f32 arithmetic on either route) within 5e-5 x max(1, max
    |twin|). Both tensor-core routes: a second launch bitwise equal to the
    first. Raises on a non-finite output or when the route's counters did
    not move as they should."""
    q = args[2]
    route = route or sla_fwd.forward_route(q.dtype, kw["block_q"],
                                           kw["block_kv"], q.shape[-1])
    call = _fwd_call(args, kw, route)
    before = _fwd_counters()
    got = call()
    moved = tuple(a - b for a, b in zip(_fwd_counters(), before))
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    split = int(route == "split")
    if moved != (1, int(route == "tc"), split, split):
        raise RuntimeError(f"sla_fwd {what}: counters (launches, tc, split, "
                           f"planes) moved {moved} on the {route} route")
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise RuntimeError(f"sla_fwd {what}: non-finite output")
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    if route == "fma":
        err = max(errs)
        return dict(route=FWD_F32_ROUTE, errs=errs, max_abs_err=err,
                    limit=TWIN_TOL, ok=err <= TWIN_TOL)
    again = call()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if route == "split":
        limits = [TWIN_TOL * max(1.0, float(w.abs().max())) for w in want]
        cut = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype="bf16x3")
        cut_errs = [float((c - w).abs().max()) for c, w in zip(cut, want)]
        return dict(route=FWD_SPLIT_ROUTE, errs=errs, max_abs_err=max(errs),
                    limits=limits, cut_twin_errs=cut_errs,
                    bitwise_repeat=bitwise,
                    ok=bitwise and all(e <= m for e, m in zip(errs, limits)))
    rounded = sla_fwd.sla_fwd_plain(*args, **kw, mma_dtype=torch.bfloat16)
    res = cases.tc_criterion((got[0], got[2]), (want[0], want[2]),
                             (rounded[0], rounded[2]))
    res["bitwise_repeat"] = bitwise
    res.update(errs=errs, o_l_err=errs[1], o_l_limit=TWIN_TOL * max(
        1.0, float(want[1].abs().max())))
    res["ok"] = (res["ok"] and res["bitwise_repeat"]
                 and res["o_l_err"] <= res["o_l_limit"])
    return dict(route=FWD_TC_ROUTE, **res)


def _fwd_text(c: dict) -> str:
    e = c["errs"]
    verdict = "OK" if c["ok"] else "FAIL"
    if c["route"] == FWD_F32_ROUTE:
        return (f"f32 FMA: max abs err o_s {e[0]:.3g} o_l {e[1]:.3g} lse "
                f"{e[2]:.3g} (tol {TWIN_TOL:g}) {verdict}")
    if c["route"] == FWD_SPLIT_ROUTE:
        m, t = c["limits"], c["cut_twin_errs"]
        return (f"split: max abs err o_s {e[0]:.3g} o_l {e[1]:.3g} lse "
                f"{e[2]:.3g} vs f32 twin (limits {m[0]:.3g} / {m[1]:.3g} / "
                f"{m[2]:.3g}; the cut twin's own {t[0]:.3g} / {t[1]:.3g} / "
                f"{t[2]:.3g}), bitwise repeat {c['bitwise_repeat']} "
                f"{verdict}")
    return (f"tensor cores: max abs err o_s {e[0]:.3g} lse {e[2]:.3g} vs f32 "
            f"twin (rounded twin {c['rounded_err']:.3g}, limit "
            f"{c['limit']:.3g}), o_l {e[1]:.3g} (limit {c['o_l_limit']:.3g})"
            f", bitwise repeat {c['bitwise_repeat']} {verdict}")


def _planes_case(k, v) -> dict:
    """The split route's pre-pass against its twin on the same card K/V:
    bitwise, timed, with its bound (bytes: f32 k and v read, six bf16
    planes written)."""
    before = sla_fwd.PLANES_LAUNCHES
    got = sla_fwd.split_kv_planes(k, v)
    want = sla_fwd.split_kv_planes_plain(k, v)
    torch.cuda.synchronize()
    if sla_fwd.PLANES_LAUNCHES != before + 1:
        raise RuntimeError("split_kv_planes did not launch its kernel")
    bitwise = all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                  for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del got, want
    ms = cuda_ms(lambda: sla_fwd.split_kv_planes(k, v), 20)
    plain_ms = cuda_ms(lambda: sla_fwd.split_kv_planes_plain(k, v), 5,
                       warmup=1)
    nbytes = 2 * k.numel() * 4 + 2 * sla_fwd.SPLIT_PARTS * (
        k.shape[0] * k.shape[1] * sla_fwd.TC_HEAD_DIM * 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[3 kernel] split_kv_planes (the split route's pre-pass) on the Wan "
        f"f32 K/V {tuple(k.shape)}: bitwise equal to its twin {bitwise} "
        f"{'OK' if bitwise else 'FAIL'} | kernel {ms:.3f} ms | bound "
        f"{bound_ms:.3f} ms by bytes ({nbytes / 1e6:.0f} MB; "
        f"{bound_ms / ms:.1%} of it) | plain twin {plain_ms:.3f} ms")
    if not bitwise:
        raise RuntimeError("split_kv_planes disagrees with its twin")
    return dict(shape="wan2_1_1_3b", max_abs_err=err, bitwise=bitwise,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", bound_fraction=bound_ms / ms,
                mbytes=nbytes / 1e6)


def _gqa_fwd_operands(h, group, n, d, base, seed):
    """The forward's bf16 operands for a causal span of query blocks from
    block `base` to the end against the full KV with GQA (h // group kv
    heads) at 64 x 64 blocks: a plan of seeded q/k, h_j and z_j per kv
    head repeated to the query heads and aggregated per query head (the
    marginal set is per query head)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device=DEV)
    k, v = (torch.randn((1, h // group, n, d), generator=gen, device=DEV)
            for _ in range(2))
    sla = get_arch("wan2_1_1_3b").sla.replace(causal=True)
    plan = plan_lib.plan_attention(q, k, sla)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    fq, fk, fv = map(ops._flat, (q, k, v))
    fqp = ops._flat(phi_lib.phi(q, sla.phi))
    hb, zb = ops._hz_blocks(ops._flat(phi_lib.phi(k, sla.phi)), fv,
                            sla.block_kv)
    hi, zi = ops._aggregate(ops._flat(plan.marginal),
                            torch.repeat_interleave(hb, group, dim=0),
                            torch.repeat_interleave(zb, group, dim=0))
    lut, counts = ops._flat(plan.lut), ops._flat(plan.counts)
    rows = slice(base, n // sla.block_q)
    cols = slice(base * sla.block_q, n)
    args = tuple(x.contiguous() for x in (
        lut[:, rows], counts[:, rows], fq[:, cols], fk, fv, fqp[:, cols],
        hi[:, rows], zi[:, rows]))
    return args, dict(scale=d ** -0.5, causal=True, block_q=sla.block_q,
                      block_kv=sla.block_kv, base=base)


def _diagonal_only(args):
    """The same operands with every row's LUT cut to its diagonal block
    (count 1): the kernel's time is then its linear-branch epilogue and
    one tile."""
    lut, counts = args[:2]
    lut = lut.clone()
    lut[..., 0] = torch.arange(lut.shape[1], dtype=lut.dtype,
                               device=lut.device)
    return (lut, torch.ones_like(counts)) + tuple(args[2:])


def phase_kernel_vs_plain():
    rows, planes = [], None
    for shape, (arch, h, n, d) in SHAPES.items():
        sla, q, k, v, plan = _kernel_inputs(arch, h, n, d, seed=1)
        for dtype in (torch.float32, torch.bfloat16):
            args, kw, (qd, kd, vd, qpd, kpd) = _operands(
                sla, q, k, v, plan.marginal, plan.lut, plan.counts, dtype)
            c = _fwd_check(args, kw, f"{shape} {dtype}")
            ms = cuda_ms(_fwd_call(args, kw), 20)
            plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw),
                               10, warmup=1)
            gather_ms = cuda_ms(lambda: sla_forward_gather(
                qd, kd, vd, qpd, kpd, plan, sla), 10, warmup=1)
            backend_ms = cuda_ms(lambda: ops.sla_attention_core(
                qd, kd, vd, qpd, kpd, plan, sla), 10, warmup=1)
            sdpa_ms = cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(qd, kd, vd),
                              10, warmup=1)
            bound_ms, bound_by, flops, nbytes, live = _bound(args, kw)
            extra = {}
            if c["route"] == FWD_SPLIT_ROUTE:
                extra["bound_ms_f32_fma"] = _bound(args, kw, "fma")[0]
            dname = "f32" if dtype == torch.float32 else "bf16"
            say(f"[3 kernel] {shape} {dname} (BH={args[2].shape[0]}, "
                f"N={n}, D={d}, K={plan.k_sel}, live tiles {live}): "
                f"{_fwd_text(c)}")
            say(f"  kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by "
                f"{bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB;"
                f" {bound_ms / ms:.1%} of it)"
                + (f" | f32-FMA bound {extra['bound_ms_f32_fma']:.3f} ms"
                   if extra else "")
                + f" | plain twin {plain_ms:.3f} ms "
                f"| gather backend {gather_ms:.3f} ms | kernel backend (h/z "
                f"+ aggregate + kernel) {backend_ms:.3f} ms | dense SDPA "
                f"yardstick (not the same function) {sdpa_ms:.3f} ms")
            rows.append(dict(shape=shape, dtype=dname, bh=args[2].shape[0],
                             n=n, d=d, k_sel=plan.k_sel, live_tiles=live,
                             ms=ms, plain_ms=plain_ms, gather_ms=gather_ms,
                             kernel_backend_ms=backend_ms,
                             dense_sdpa_ms=sdpa_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_fraction=bound_ms / ms,
                             gflop=flops / 1e9, mbytes=nbytes / 1e6, **extra,
                             **c))
            if shape == "wan2_1_1_3b":
                if dtype == torch.float32:
                    planes = _planes_case(args[3], args[4])
                    rows.append(_fwd_case("wan2_1_1_3b", args, kw,
                                          plain=False, route="fma"))
                rows.append(_fwd_case("wan2_1_1_3b count 1 (epilogue)",
                                      _diagonal_only(args), kw, plain=False))
            del args
        del q, k, v, plan
        torch.cuda.empty_cache()
    # sla_fwd.cu's own calls: blocks other than 64 x 64, f32 and bf16
    arch, h, n, d = SHAPES["lightningdit_1b"]
    sla, q, k, v, plan = _kernel_inputs(arch, h, n, d, seed=3, block=32)
    for dtype in (torch.float32, torch.bfloat16):
        args, kw, _ = _operands(sla, q, k, v, plan.marginal, plan.lut,
                                plan.counts, dtype)
        rows.append(_fwd_case("lightningdit_1b 32x32 blocks", args, kw))
    del args, q, k, v, plan
    h, n, d = SHAPES["wan2_1_1_3b"][1], 4096, 128
    args, kw = _gqa_fwd_operands(h, 2, n, d, base=32, seed=6)
    rows.append(_fwd_case("causal GQA-2 base 32", args, kw))
    del args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain twin: {bad}")
    return rows, planes


def _fwd_case(shape, args, kw, plain=True, route=None) -> dict:
    """Check and time the forward kernel of `route` (default: the rule's)
    on one extra case of phase 3."""
    c = _fwd_check(args, kw, shape, route)
    ms = cuda_ms(_fwd_call(args, kw, route), 20)
    plain_ms = (cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw), 3,
                        warmup=1) if plain else None)
    dtype = args[2].dtype
    bound_ms, bound_by, flops, nbytes, live = _bound(args, kw, route)
    extra = {}
    if c["route"] == FWD_SPLIT_ROUTE:
        extra["bound_ms_f32_fma"] = _bound(args, kw, "fma")[0]
    dname = "f32" if dtype == torch.float32 else "bf16"
    say(f"[3 kernel] {shape} {dname} (BH={args[2].shape[0]}, BH_kv="
        f"{args[3].shape[0]}, Nq={args[2].shape[1]}, Nkv={args[3].shape[1]}"
        f", D={args[2].shape[-1]}, blocks {kw['block_q']}, causal "
        f"{kw['causal']}, base {kw.get('base', 0)}, live tiles {live}): "
        f"{_fwd_text(c)}")
    say(f"  kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by {bound_by} "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB; "
        f"{bound_ms / ms:.1%} of it)"
        + (f" | f32-FMA bound {extra['bound_ms_f32_fma']:.3f} ms"
           if extra else "")
        + (f" | plain twin {plain_ms:.3f} ms" if plain else ""))
    return dict(shape=shape, dtype=dname, bh=args[2].shape[0],
                bh_kv=args[3].shape[0], n=args[2].shape[1],
                d=args[2].shape[-1], block=kw["block_q"],
                causal=kw["causal"], base=kw.get("base", 0),
                live_tiles=live, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_fraction=bound_ms / ms, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, **extra, **c)


# --------------------------------------------------------------------------
def _main_model(seed: int):
    """Full-width wan2_1_1_3b with random weights from a seeded generator.
    The zero-initialized output projection and SLA Proj (AdaLN-zero and
    the paper's Proj init) are redrawn so that the velocity and the
    linear branch are not identically zero."""
    cfg = get_arch("wan2_1_1_3b")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = dit.init(gen, cfg, device=DEV)
    with torch.no_grad():
        params.patch_out.copy_(dense_init(gen, cfg.d_model, cfg.patch_dim,
                                          device=DEV))
        for layer in params.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device=DEV))
    return cfg, params


def phase_main_path(cfg, params):
    rs = np.random.default_rng(0)
    sched = DiffusionScheduler(cfg, params, num_slots=MAIN_SLOTS,
                               seq_len=MAIN_SEQ, backend="kernel",
                               compute_dtype=torch.float32, device=DEV)
    for t_start in MAIN_T_STARTS:
        sched.submit(rs.standard_normal((MAIN_SEQ, cfg.patch_dim),
                                        dtype=np.float32),
                     DenoiseParams(num_steps=MAIN_STEPS, t_start=t_start),
                     cond=rs.standard_normal((cfg.cond_len, cfg.d_model),
                                             dtype=np.float32))
    forwards = 0
    orig_forward = dit.forward

    def counted_forward(*a, **kw):
        nonlocal forwards
        forwards += 1
        return orig_forward(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    sla_fwd.PLANES_LAUNCHES = 0
    dit.forward = counted_forward
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = orig_forward
    wall = time.time() - t0
    launches, tc_launches, split_launches, planes_launches = \
        _fwd_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sched.stats
    ticks = st.slot_steps_total // MAIN_SLOTS
    say(f"[4 main] {len(done)} requests x {MAIN_STEPS} steps at seq_len "
        f"{MAIN_SEQ} through {MAIN_SLOTS} slots in {wall:.2f}s | "
        f"{st.admissions} admissions + {ticks} ticks = {forwards} forwards "
        f"| plans built {st.plan_builds}, reused {st.plan_reuses}, "
        f"re-planned {st.plan_replans} | peak memory {peak:.2f} GiB")
    lat = []
    for r in done:
        m = r.metrics
        lat.append(m.latency_s)
        finite = r.result is not None and bool(np.isfinite(r.result).all())
        say(f"  request {r.rid} (t_start {r.params.t_start}): latency "
            f"{m.latency_s:.3f}s, queue {m.queue_s:.3f}s, first step "
            f"{m.ttft_s:.3f}s, {m.decode_tokens} steps, state "
            f"{r.state.value}, latent finite {finite}, |latent| max "
            f"{float(np.abs(r.result).max()):.3f}")
        if r.state.value != "finished" or not finite \
                or r.result.shape != (MAIN_SEQ, cfg.patch_dim):
            raise RuntimeError(f"request {r.rid} did not finish with a "
                               f"finite latent of the expected shape")
    want = cfg.num_layers * forwards
    say(f"  sla_fwd launches {launches} (expected {cfg.num_layers} x "
        f"{forwards} forwards = {want}), on the split route "
        f"{split_launches} with {planes_launches} pre-pass launches "
        f"(expected all: f32 compute at 64 x 64 blocks), on the bf16 "
        f"tensor-core route {tc_launches} (expected 0)")
    if launches != want or launches == 0 or tc_launches != 0 \
            or split_launches != want or planes_launches != want:
        raise RuntimeError(f"main path launched sla_fwd {launches} times "
                           f"({split_launches} split, {planes_launches} "
                           f"pre-pass, {tc_launches} bf16 tensor cores), "
                           f"expected {want} ({want}, {want}, 0)")
    return dict(launches=launches, tc_launches=tc_launches,
                split_launches=split_launches,
                planes_launches=planes_launches,
                forwards=forwards, wall_s=wall,
                peak_gib=peak, latency_s=lat, ticks=ticks,
                plan_builds=st.plan_builds, plan_replans=st.plan_replans,
                plan_reuses=st.plan_reuses)


def phase_cross_check(cfg, params, profile: bool):
    rs = np.random.default_rng(1)
    lat = torch.from_numpy(rs.standard_normal(
        (1, MAIN_SEQ, cfg.patch_dim), dtype=np.float32)).to(DEV)
    cond = torch.from_numpy(rs.standard_normal(
        (1, cfg.cond_len, cfg.d_model), dtype=np.float32)).to(DEV)
    t = torch.full((1,), 0.6, device=DEV)

    def run(backend, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            out = dit.forward(params, cfg, lat, t, cond, torch.float32,
                              backend, **kw)
        torch.cuda.synchronize()
        return out, time.time() - t0

    (vel_k, plans), s_plan = run("kernel", return_plans=True)
    vel_k2, s_k = run("kernel", plans=plans)
    vel_g, s_g = run("gather", plans=plans)
    diff = float((vel_k2 - vel_g).abs().max())
    scale = float(vel_g.abs().max())
    replay = float((vel_k2 - vel_k).abs().max())
    ok = bool(np.isfinite(diff)) and diff <= FWD_TOL * max(1.0, scale)
    k_sel = plans.lut.shape[-1]
    live = int(torch.clamp(plans.counts, max=k_sel).sum())
    say(f"[5 plans] the forward's plans hold {live} live critical tiles over "
        f"{cfg.num_layers} layers ({live / plans.counts.numel():.2f} per "
        f"query block of at most K={k_sel}; "
        f"{float((plans.mc == 1).float().mean()):.4f} critical, "
        f"{float((plans.mc == 0).float().mean()):.4f} marginal)")
    say(f"[5 cross-check] full-width forward (B=1, N={MAIN_SEQ}): kernel "
        f"vs gather max |dv| {diff:.3g} (max |v| {scale:.3g}, tol "
        f"{FWD_TOL:g} x max(1, max |v|)) {'OK' if ok else 'FAIL'} | kernel "
        f"with given plans vs with inline planning {replay:.3g} | forward "
        f"wall: kernel+planning {s_plan:.3f}s, kernel {s_k:.3f}s, gather "
        f"{s_g:.3f}s")
    if not ok:
        raise RuntimeError("kernel and gather backends disagree on the "
                           "full-width forward")
    share = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            _, s_prof = run("kernel", plans=plans)
        say(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=15))
        share = _fwd_kernel_share(prof, s_prof)
        say(f"[5 profile] one full-width f32 forward (kernel backend, given "
            f"plans), {s_prof:.3f}s wall under the profiler: {share}")
    return plans, dict(max_abs_diff=diff, max_abs_v=scale,
                       kernel_fwd_s=s_k, gather_fwd_s=s_g,
                       plan_fwd_s=s_plan, live_tiles=live,
                       kernel1_profile=share)


def _fwd_kernel_share(prof, wall_s: float) -> dict:
    """Kernel 1's device time in a profile of a forward: the split
    kernel and its pre-pass (and any other forward kernel), their launches
    and mean times, and their share of the device time."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in evs)
    out = dict(device_s=dev_us / 1e6, busy=dev_us / 1e6 / wall_s)
    total = 0.0
    for name in ("sla_fwd_split_kernel", "split_kv_kernel",
                 "sla_fwd_tc_kernel", "sla_fwd_kernel"):
        mine = [e for e in evs if name in e.key]  # no name holds another
        us = sum(e.self_device_time_total for e in mine)
        n = sum(e.count for e in mine)
        total += us
        out[name] = dict(launches=n, ms_mean=us / n / 1e3 if n else None,
                         s=us / 1e6)
    out["kernel1_s"] = total / 1e6
    out["kernel1_share"] = total / max(dev_us, 1e-9)
    return out


def phase_kernel_on_path_plans(cfg, plans):
    """The kernel against its twin on the LUTs the full-width forward
    built (sparse, uneven counts after the column cap), at the Wan shape
    with seeded q/k/v: the first and the last layer, f32 (the split route,
    and the f32-FMA kernel forced beside it) and bf16 (tensor-core route),
    by `_fwd_check`."""
    sla = cfg.sla
    h, n, d = cfg.num_heads, MAIN_SEQ, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(2)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    rows = []
    for layer in (0, cfg.num_layers - 1):
        lp = [x[layer] for x in (plans.marginal, plans.lut, plans.counts)]
        live = int(torch.clamp(lp[2], max=lp[1].shape[-1]).sum())
        for dtype, route in ((torch.float32, None), (torch.float32, "fma"),
                             (torch.bfloat16, None)):
            args, kw, _ = _operands(sla, q, k, v, *lp, dtype)
            c = _fwd_check(args, kw, f"layer {layer} plans {dtype}", route)
            ms = cuda_ms(_fwd_call(args, kw, route), 20)
            bound_ms, bound_by, _, _, _ = _bound(args, kw, route)
            extra = {}
            if c["route"] == FWD_SPLIT_ROUTE:
                extra["bound_ms_f32_fma"] = _bound(args, kw, "fma")[0]
            dname = "f32" if dtype == torch.float32 else "bf16"
            say(f"[5 path plans] wan2_1_1_3b layer {layer} {dname} (live "
                f"tiles {live} of {lp[1].numel()}): {_fwd_text(c)} | kernel "
                f"{ms:.3f} ms | bound {bound_ms:.3f} ms by {bound_by} "
                f"({bound_ms / ms:.1%} of it)"
                + (f" | f32-FMA bound {extra['bound_ms_f32_fma']:.3f} ms"
                   if extra else ""))
            rows.append(dict(shape=f"wan2_1_1_3b layer {layer} plans",
                             dtype=dname, live_tiles=live, ms=ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_fraction=bound_ms / ms, **extra, **c))
            del args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain twin on the "
                           f"path's plans: {bad}")
    return rows


# --------------------------------------------------------------------------
def _time_calls(obj, name: str, parts: dict) -> None:
    """Wrap `obj.name` so that each call's wall, synchronized at both
    ends, is appended to parts[name]."""
    orig = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(time.time() - t0)
        return out

    setattr(obj, name, timed)


def _plan_cache_run(cfg, params, reqs, cache: bool) -> dict:
    """One drain of the phase-6 trace, the launch counts set to 0 just
    before it and read just after. The admission forwards and the
    cache's calls are timed. With the cache on, each cached admission's
    plans, drift info and the cache entries it was handed are kept for
    the kept-layers check."""
    nl = cfg.num_layers
    sched = DiffusionScheduler(
        cfg, params, num_slots=MAIN_SLOTS, seq_len=MAIN_SEQ,
        backend="kernel", compute_dtype=torch.float32,
        refresh_mode="adaptive", drift_threshold=PC_THRESHOLD,
        plan_cache=cache, t_buckets=PC_BUCKETS, device=DEV)
    for lat, cond in reqs:
        sched.submit(lat, DenoiseParams(num_steps=PC_STEPS, t_start=1.0),
                     cond=cond)
    hits, parts = [], {}
    for name in ("_admit_fresh", "_admit_cached"):
        _time_calls(sched, name, parts)
    if cache:
        for name in ("get", "put", "update", "put_if_absent"):
            _time_calls(sched.cache, name, parts)
        orig_cached = sched._admit_cached

        def admit_cached(lat1, t1, dt1, cond1, cached):
            pc = sched.cache
            bucket = pc.bucket(float(t1[0]))
            entries = [pc._entries[(pc._compat, layer, bucket)]
                       for layer in range(nl)]
            out = orig_cached(lat1, t1, dt1, cond1, cached)
            hits.append(dict(entries=entries, plans=out[1], info=out[2]))
            return out

        sched._admit_cached = admit_cached
    forwards = 0
    orig_forward = dit.forward

    def counted_forward(*a, **kw):
        nonlocal forwards
        forwards += 1
        return orig_forward(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    sla_fwd.PLANES_LAUNCHES = 0
    dit.forward = counted_forward
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = orig_forward
    wall = time.time() - t0
    launches, tc_launches, split_launches, planes_launches = \
        _fwd_counters()
    return dict(sched=sched, done=done, hits=hits, parts=parts, wall_s=wall,
                forwards=forwards, launches=launches,
                tc_launches=tc_launches, split_launches=split_launches,
                planes_launches=planes_launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_plan_cache(cfg, params, plans):
    """Phase 6: the cross-request plan cache on the full-width DiT
    service. The same 4 seeded requests (each its own latent and text
    condition, 3 steps from t 1.0) drain with the cache off, then on."""
    nl = cfg.num_layers
    rs = np.random.default_rng(6)
    reqs = [(rs.standard_normal((MAIN_SEQ, cfg.patch_dim),
                                dtype=np.float32),
             rs.standard_normal((cfg.cond_len, cfg.d_model),
                                dtype=np.float32))
            for _ in range(PC_REQUESTS)]
    runs = {name: _plan_cache_run(cfg, params, reqs, name == "on")
            for name in ("off", "on")}
    bad = []
    for name, run in runs.items():
        st = run["sched"].stats
        want = nl * run["forwards"]
        say(f"[6 plan cache {name}] {len(run['done'])} requests x "
            f"{PC_STEPS} steps at seq_len {MAIN_SEQ} through {MAIN_SLOTS} "
            f"slots in {run['wall_s']:.2f}s | {st.admissions} admissions + "
            f"{st.slot_steps_total // MAIN_SLOTS} ticks = {run['forwards']} "
            f"forwards | plans built {st.plan_builds}, reused "
            f"{st.plan_reuses}, re-planned {st.plan_replans}, last "
            f"retention {st.last_retention:.4f} | sla_fwd launches "
            f"{run['launches']} (expected {want}), split "
            f"{run['split_launches']}, pre-pass {run['planes_launches']}, "
            f"bf16 tensor cores {run['tc_launches']} | peak memory "
            f"{run['peak_gib']:.2f} GiB")
        say(f"  timed parts (s, in call order; forwards and cache calls "
            f"synchronized at both ends): "
            + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                        for k, v in run["parts"].items()))
        for r in run["done"]:
            m = r.metrics
            finite = (r.result is not None
                      and bool(np.isfinite(r.result).all()))
            say(f"  request {r.rid}: admission "
                f"{m.first_token_t - m.admit_t:.3f}s, latency "
                f"{m.latency_s:.3f}s, queue {m.queue_s:.3f}s, state "
                f"{r.state.value}, latent finite {finite}")
            if r.state.value != "finished" or not finite \
                    or r.result.shape != (MAIN_SEQ, cfg.patch_dim):
                bad.append(f"{name}: request {r.rid} did not finish with "
                           f"a finite latent of the expected shape")
        if (run["launches"], run["split_launches"], run["planes_launches"],
                run["tc_launches"]) != (want, want, want, 0) or want == 0:
            bad.append(f"{name}: sla_fwd launches {run['launches']} "
                       f"(split {run['split_launches']}, pre-pass "
                       f"{run['planes_launches']}, bf16 "
                       f"{run['tc_launches']}), expected {want}, {want}, "
                       f"{want}, 0")
        builds = nl * (1 if name == "on" else PC_REQUESTS)
        if st.plan_builds != builds:
            bad.append(f"{name}: {st.plan_builds} plan builds, expected "
                       f"{builds}")
    on, off = runs["on"], runs["off"]
    cache = on["sched"].cache
    cs = cache.stats()
    say(f"  cache {cs} | host bytes held {cache.host_bytes()} | "
        f"invalidations {cs['invalidations']} of {len(on['hits']) * nl} "
        f"validated layers")
    want_cs = dict(hits=PC_REQUESTS - 1, misses=1, evictions=0,
                   entries=2 * nl, puts=2 * nl + cs["invalidations"])
    if any(cs[k] != v for k, v in want_cs.items()):
        bad.append(f"cache counters {cs}, expected {want_cs}")
    # on each hit, the layers the drift check kept are the entries, bitwise
    kept = mismatched = 0
    min_ret = 1.0
    for hit in on["hits"]:
        replanned = hit["info"]["replanned"].cpu().numpy().reshape(nl)
        min_ret = min(min_ret, float(hit["info"]["retention"].min()))
        for layer in np.flatnonzero(~replanned):
            kept += 1
            for n in plan_lib.PLAN_LEAVES:
                got = getattr(hit["plans"], n)[layer:layer + 1].cpu().numpy()
                ent = hit["entries"][layer][n]
                if got.dtype != ent.dtype or got.tobytes() != ent.tobytes():
                    mismatched += 1
    say(f"  cached admissions {len(on['hits'])}: {kept} kept layers, "
        f"{mismatched} leaves differing from their cache entry; lowest "
        f"retention at a cached admission {min_ret:.4f}")
    if mismatched or len(on["hits"]) != PC_REQUESTS - 1:
        bad.append(f"{mismatched} kept-layer leaves differ from the cache "
                   f"entries ({len(on['hits'])} cached admissions)")
    diffs = []
    for a, b in zip(on["done"], off["done"]):
        d = float(np.abs(a.result - b.result).max())
        diffs.append(dict(rid=a.rid, max_abs_diff=d,
                          max_abs_latent=float(np.abs(b.result).max())))
    say(f"  latent, cache on vs off: {diffs}")
    # one full-width 30-layer stack through the wire format
    torch.cuda.synchronize()
    t0 = time.time()
    data = plan_lib.serialize_plan(plans)
    ser_s = time.time() - t0
    t0 = time.time()
    back = plan_lib.deserialize_plan(data, DEV)
    torch.cuda.synchronize()
    de_s = time.time() - t0
    nbytes = sum(getattr(plans, n).nbytes for n in plan_lib.PLAN_LEAVES)
    same = {n: bool(getattr(back, n).dtype == getattr(plans, n).dtype
                    and torch.equal(getattr(back, n), getattr(plans, n)))
            for n in plan_lib.PLAN_LEAVES}
    say(f"  one {nl}-layer stack ({nbytes} bytes, "
        f"{ {n: getattr(plans, n).nbytes for n in plan_lib.PLAN_LEAVES} }): "
        f"serialize (device->host) {ser_s:.4f}s, deserialize (host->"
        f"device) {de_s:.4f}s, bitwise {same}")
    if not all(same.values()):
        bad.append(f"the stack does not round-trip bitwise: {same}")
    if bad:
        raise RuntimeError("plan-cache phase failed: " + "; ".join(bad))

    def req_times(run):
        return [dict(rid=r.rid, admission_s=r.metrics.first_token_t
                     - r.metrics.admit_t, latency_s=r.metrics.latency_s)
                for r in run["done"]]

    return dict(
        cache=cs, host_bytes=cache.host_bytes(), kept_layers=kept,
        min_retention=min_ret, latent_diff=diffs,
        stack_bytes=nbytes, serialize_s=ser_s, deserialize_s=de_s,
        **{name: dict(
            wall_s=run["wall_s"], forwards=run["forwards"],
            launches=run["launches"], split_launches=run["split_launches"],
            planes_launches=run["planes_launches"],
            tc_launches=run["tc_launches"], peak_gib=run["peak_gib"],
            parts_s=run["parts"],
            requests=req_times(run),
            **{k: getattr(run["sched"].stats, k) for k in (
                "plan_builds", "plan_replans", "plan_reuses",
                "plan_cache_hits", "plan_cache_misses",
                "plan_cache_invalidations", "plan_cache_evictions")})
           for name, run in runs.items()})


# --------------------------------------------------------------------------
def _bwd_operands(sla, q, k, v, leaves, dtype, seed: int):
    """Operands of both backward kernels for one plan's (B, H, ...)
    leaves (marginal, lut, counts, col_lut, col_counts) in `dtype`: L and
    O^s from the forward kernel on the same inputs, a seeded dO^s and
    D = rowsum(dO^s * O^s). Returns (dq args, dkv args, keywords)."""
    marginal, lut, counts, col_lut, col_counts = leaves
    args, kw, _ = _operands(sla, q, k, v, marginal, lut, counts, dtype)
    o_s, _, lse = sla_fwd.sla_fwd(*args, **kw)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    do = torch.randn(o_s.shape, generator=gen, device=DEV)
    tail = (*args[2:5], do, lse, (do * o_s).sum(dim=-1))
    return (args[:2] + tail,
            (ops._flat(col_lut), ops._flat(col_counts)) + tail, kw)


def _bwd_bound(name, args, kw, dtype):
    """Least time for one backward call, as `_bound`: bytes (inputs read
    once, f32 gradients written once) over HBM bandwidth against this
    data's operations (6 bq bkv D per live row-LUT tile for dQ, 8 per
    live column-LUT tile for dK/dV) over the peak rate."""
    lut, counts, q = args[:3]
    bh, n, d = q.shape
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += (1 if name == "sla_bwd_dq" else 2) * bh * n * d * 4
    live = int(torch.clamp(counts, max=lut.shape[-1]).sum())
    flops = live * BWD[name][2] * kw["block_q"] * kw["block_kv"] * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            live)


TC_ROUTE = "tensor cores, wgmma m64n64k16 (sla_bwd_tc.cu)"
F32_ROUTE = "f32 FMA on CUDA cores (sla_bwd.cu)"


def _tc_launches(name: str) -> int:
    return (sla_bwd.TC_LAUNCHES_DQ if name == "sla_bwd_dq"
            else sla_bwd.TC_LAUNCHES_DKV)


def _bwd_check(name, args, kw, what: str) -> dict:
    """Kernel against its twin on the same card operands. The f32-FMA
    route: max abs error against 5e-5 x max(1, max |twin|). The
    tensor-core route (`sla_bwd.use_tensor_cores`): `cases.tc_criterion`
    against the f32 twin and the twin that rounds dO, P and dS to bf16,
    and a second launch bitwise equal to the first. Raises on a
    non-finite output or when the route's counter did not move."""
    kernel, plain, _ = BWD[name]
    q = args[2]
    tc = sla_bwd.use_tensor_cores(q.dtype, kw["block_q"], kw["block_kv"],
                                  q.shape[-1])
    before = _tc_launches(name)
    got = kernel(*args, **kw)
    launched = _tc_launches(name) - before
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if launched != int(tc):
        raise RuntimeError(f"{name} {what}: {launched} tensor-core "
                           f"launches, expected {int(tc)}")
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise RuntimeError(f"{name} {what}: non-finite output")
    if not tc:
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        limit = TWIN_TOL * max(1.0, max(float(w.abs().max())
                                        for w in want))
        return dict(route=F32_ROUTE, max_abs_err=err, limit=limit,
                    ok=err <= limit)
    rounded = plain(*args, **kw, mma_dtype=torch.bfloat16)
    res = cases.tc_criterion(got, want, rounded)
    again = kernel(*args, **kw)
    again = (again,) if torch.is_tensor(again) else again
    res["bitwise_repeat"] = all(torch.equal(a, b)
                                for a, b in zip(got, again))
    res["ok"] = res["ok"] and res["bitwise_repeat"]
    return dict(route=TC_ROUTE, **res)


def _check_text(c: dict) -> str:
    if c["route"] == F32_ROUTE:
        return (f"max abs err {c['max_abs_err']:.3g} (limit "
                f"{c['limit']:.3g}) {'OK' if c['ok'] else 'FAIL'}")
    return (f"tensor cores: max abs err {c['max_abs_err']:.3g} vs f32 twin "
            f"(rounded twin {c['rounded_err']:.3g}, limit {c['limit']:.3g}"
            f"), bitwise repeat {c['bitwise_repeat']} "
            f"{'OK' if c['ok'] else 'FAIL'}")


def _gqa_bwd_operands(h, group, n, d, seed, causal):
    """Both backward kernels' bf16 operands for GQA (h // group kv heads)
    at 64 x 64 blocks: a plan of seeded q/k, L and O^s from the forward
    kernel, a seeded dO. Returns (dq args, dkv args, keywords)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device=DEV)
    k, v = (torch.randn((1, h // group, n, d), generator=gen, device=DEV)
            for _ in range(2))
    sla = get_arch("wan2_1_1_3b").sla.replace(causal=causal)
    plan = plan_lib.plan_attention(q, k, sla)
    fq, fk, fv = (ops._flat(x.to(torch.bfloat16)) for x in (q, k, v))
    lut, counts = ops._flat(plan.lut), ops._flat(plan.counts)
    tm = n // sla.block_q
    kw = dict(scale=d ** -0.5, causal=causal, block_q=sla.block_q,
              block_kv=sla.block_kv)
    o_s, _, lse = sla_fwd.sla_fwd(
        lut, counts, fq, fk, fv, torch.zeros_like(fq, dtype=torch.float32),
        torch.zeros((fq.shape[0], tm, d, d), device=DEV),
        torch.zeros((fq.shape[0], tm, d), device=DEV), **kw)
    do = torch.randn(o_s.shape, generator=gen, device=DEV)
    tail = (fq, fk, fv, do, lse, (do * o_s).sum(dim=-1))
    return ((lut, counts) + tail,
            (ops._flat(plan.col_lut), ops._flat(plan.col_counts)) + tail, kw)


def _sdpa_bwd_ms(q, k, v) -> float:
    """Device time of the backward of dense scaled_dot_product_attention
    at this shape (a yardstick for dense attention, not the same
    function)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    g = torch.randn_like(out)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                               retain_graph=True), 3,
                   warmup=1)


_FLEX = []


def _flex_block_mask(lut, counts, n: int, block: int):
    """flex_attention's BlockMask for one plan's (B, H, Tm, K) row LUT:
    each query block's live LUT entries as full blocks (no mask_mod
    inside them) and no partial blocks. Its column side, which flex's
    backward walks for dK/dV, is derived by BlockMask itself."""
    from torch.nn.attention.flex_attention import BlockMask
    b, h, tq, k = lut.shape
    live = torch.clamp(counts, max=k).to(torch.int32)
    idx = torch.zeros((b, h, tq, n // block), dtype=torch.int32,
                      device=lut.device)
    idx[..., :k] = torch.where(
        torch.arange(k, device=lut.device) < live[..., None], lut, 0)
    none = torch.zeros((b, h, tq), dtype=torch.int32, device=lut.device)
    return BlockMask.from_kv_blocks(
        none, torch.zeros_like(idx), full_kv_num_blocks=live,
        full_kv_indices=idx, BLOCK_SIZE=block, seq_lengths=(n, n))


@contextlib.contextmanager
def _flex_tiles_within(block: int):
    """flex_attention's tiles must divide the BlockMask's blocks, and on
    Hopper its one default bf16 configuration at head dim 128 takes
    128-row tiles (forward and backward), which do not divide 64. While
    flex compiles, cap each tile of its default configurations at
    `block`, keeping their stages and warps; its f32 tiles already divide
    64 and stay as they are."""
    try:
        from torch._inductor.template_heuristics.triton import \
            CUDAConfigHeuristic as heuristic
    except ImportError:
        from torch._inductor.template_heuristics import \
            CUDAConfigHeuristic as heuristic
    saved = {name: getattr(heuristic, name) for name in
             ("get_flex_attn_fwd_configs", "get_flex_attn_bwd_configs")}

    def capped(orig):
        def configs(self, *a, **kw):
            return [dataclasses.replace(c, **{
                f.name: min(getattr(c, f.name), block)
                for f in dataclasses.fields(c) if f.name.startswith("block_")})
                for c in orig(self, *a, **kw)]
        return configs

    for name, orig in saved.items():
        setattr(heuristic, name, capped(orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(heuristic, name, orig)


def _flex_library(q, k, v, do, lut, counts, block: int, dq, dk, dv):
    """The library call for both backward kernels: compiled flex_attention
    on a BlockMask of the same row LUT computes the sparse branch O^s and,
    through autograd, the same dQ, dK and dV as sla_bwd_dq and sla_bwd_dkv
    together (scale D^-0.5, its own rowsum(dO * O^s)
    inside). q, k, v are
    (1, H, N, D); do and the kernels' dq, dk, dv are (H, N, D). Returns
    the CUDA-event times of its forward and forward+backward, their
    difference as the backward's time, and the max abs error of its
    gradients against the kernels' with its limit 1e-4 x max(1, max |g|)
    (flex's gradients come out in the inputs' dtype)."""
    if not _FLEX:
        from torch.nn.attention.flex_attention import flex_attention
        _FLEX.append(torch.compile(flex_attention))
    flex = _FLEX[0]
    mask = _flex_block_mask(lut, counts, q.shape[-2], block)
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    do = do.to(q.dtype).view(q.shape)

    def fwd():
        return flex(*ins, block_mask=mask)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), ins, do)

    with _flex_tiles_within(block):  # flex compiles at its first call
        got = fwd_bwd()
    torch.cuda.synchronize()
    err = max(float((g.float().view(w.shape) - w).abs().max())
              for g, w in zip(got, (dq, dk, dv)))
    limit = GRAD_TOL * max(1.0, max(float(w.abs().max())
                                    for w in (dq, dk, dv)))
    del got
    fwd_ms = cuda_ms(fwd, 5)
    fwd_bwd_ms = cuda_ms(fwd_bwd, 5)
    return dict(library_ms=fwd_bwd_ms - fwd_ms, library_fwd_ms=fwd_ms,
                library_fwd_bwd_ms=fwd_bwd_ms, library_err=err,
                library_limit=limit)


def _with_library(sla, q, k, v, lut, counts, dq_args, dkv_args, kw,
                  dtype, what: str):
    """`_flex_library` for one case of phase 7, on the kernels' own
    gradients of the same operands. In f32 it raises when flex's
    gradients disagree with the kernels' (then it is not the same
    function); in bf16 its gradients are rounded to bf16, and the error
    is only reported."""
    dq = BWD["sla_bwd_dq"][0](*dq_args, **kw)
    dk, dv = BWD["sla_bwd_dkv"][0](*dkv_args, **kw)
    try:
        lib = _flex_library(*(x.to(dtype) for x in (q, k, v)), dq_args[5],
                            lut, counts, sla.block_kv, dq, dk, dv)
    except Exception as e:  # the yardstick only: the port does not use it
        say(f"  library: compiled flex_attention failed ({what}): "
            f"{type(e).__name__}: {str(e).splitlines()[0][:300]}")
        return dict(library_ms=None, library_error=str(e)[:300])
    ok = lib["library_err"] <= lib["library_limit"]
    say(f"  library: compiled flex_attention on the same LUT, backward "
        f"(dQ, dK, dV together) {lib['library_ms']:.3f} ms (forward "
        f"{lib['library_fwd_ms']:.3f} ms, forward+backward "
        f"{lib['library_fwd_bwd_ms']:.3f} ms) | its grads vs the kernels' "
        f"max abs err {lib['library_err']:.3g} (limit "
        f"{lib['library_limit']:.3g}"
        + (f") {'OK' if ok else 'FAIL'}" if dtype == torch.float32
           else ", bf16 grads: reported only)"))
    if dtype == torch.float32 and not ok:
        raise RuntimeError(f"flex_attention's gradients disagree with the "
                           f"backward kernels' ({what}): {lib}")
    return lib


def _bwd_case(shape, dname, dq_args, dkv_args, kw, n, d, extra):
    """Check and time both backward kernels on one case's operands."""
    rows = []
    for name, args in (("sla_bwd_dq", dq_args), ("sla_bwd_dkv", dkv_args)):
        kernel, plain, _ = BWD[name]
        c = _bwd_check(name, args, kw, f"{shape} {dname}")
        ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 2, warmup=1)
        bound_ms, bound_by, flops, nbytes, live = _bwd_bound(
            name, args, kw, args[2].dtype)
        if c["route"] == TC_ROUTE:  # the wrapper's dO cast and D padding
            c["prep_ms"] = cuda_ms(lambda: sla_bwd._tc_operands(
                name, *args[2:]), 10)
        say(f"[7 bwd] {name} {shape} {dname} (BH={args[2].shape[0]}, "
            f"BH_kv={args[3].shape[0]}, N={n}, D={d}, causal "
            f"{kw['causal']}, LUT width {args[0].shape[-1]}, live tiles "
            f"{live}): {_check_text(c)}")
        say(f"  kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by {bound_by} "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB; "
            f"{bound_ms / ms:.1%} of it) | plain twin {plain_ms:.3f} ms"
            + (f" | of the kernel's time, the wrapper's dO cast and head-dim"
               f" padding {c['prep_ms']:.3f} ms" if "prep_ms" in c else "")
            + (f" | dense SDPA backward yardstick (not the same function) "
               f"{extra['dense_sdpa_bwd_ms']:.3f} ms"
               if "dense_sdpa_bwd_ms" in extra else ""))
        rows.append(dict(kernel=name, shape=shape, dtype=dname,
                         bh=args[2].shape[0], bh_kv=args[3].shape[0], n=n,
                         d=d, causal=kw["causal"],
                         lut_width=args[0].shape[-1], live_tiles=live,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_fraction=bound_ms / ms,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6, **c,
                         **extra))
    return rows


def phase_bwd_vs_plain():
    rows = []
    for shape, (arch, h, n, d) in SHAPES.items():
        sla, q, k, v, plan = _kernel_inputs(arch, h, n, d, seed=1)
        leaves = (plan.marginal, plan.lut, plan.counts, plan.col_lut,
                  plan.col_counts)
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            dq_args, dkv_args, kw = _bwd_operands(sla, q, k, v, leaves,
                                                  dtype, seed=4)
            extra = dict(dense_sdpa_bwd_ms=_sdpa_bwd_ms(
                *(x.to(dtype) for x in (q, k, v))))
            if shape == "wan2_1_1_3b":
                extra.update(_with_library(sla, q, k, v, plan.lut,
                                           plan.counts, dq_args, dkv_args,
                                           kw, dtype, f"{shape} {dname}"))
            rows += _bwd_case(shape, dname, dq_args, dkv_args, kw, n, d,
                              extra)
            del dq_args, dkv_args
        del q, k, v, plan
        torch.cuda.empty_cache()
    h, n, d = SHAPES["wan2_1_1_3b"][1], 4096, 128
    dq_args, dkv_args, kw = _gqa_bwd_operands(h, 2, n, d, seed=6,
                                              causal=True)
    rows += _bwd_case("causal GQA-2", "bf16", dq_args, dkv_args, kw, n, d,
                      {})
    del dq_args, dkv_args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"backward kernel disagrees with its plain "
                           f"twin: {bad}")
    return rows


def phase_bwd_on_path_plans(cfg, plans):
    """Both backward kernels against their twins on the full-width
    forward's own row and column LUTs of the first and the last layer, at
    the Wan shape with seeded q/k/v, f32 and bf16."""
    sla = cfg.sla
    h, n, d = cfg.num_heads, MAIN_SEQ, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(2)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    rows = []
    for layer in (0, cfg.num_layers - 1):
        leaves = [x[layer] for x in (plans.marginal, plans.lut, plans.counts,
                                     plans.col_lut, plans.col_counts)]
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            dq_args, dkv_args, kw = _bwd_operands(sla, q, k, v, leaves,
                                                  dtype, seed=5)
            lib = _with_library(sla, q, k, v, leaves[1], leaves[2],
                                dq_args, dkv_args, kw, dtype,
                                f"layer {layer} plans {dname}")
            for name, args in (("sla_bwd_dq", dq_args),
                               ("sla_bwd_dkv", dkv_args)):
                c = _bwd_check(name, args, kw, f"layer {layer} plans {dname}")
                ms = cuda_ms(lambda: BWD[name][0](*args, **kw), 10)
                bound_ms, bound_by, _, _, live = _bwd_bound(name, args, kw,
                                                            dtype)
                say(f"[7 bwd path plans] {name} wan2_1_1_3b layer {layer} "
                    f"{dname} (live tiles {live} of {args[0].numel()}): "
                    f"{_check_text(c)} | kernel {ms:.3f} ms | bound "
                    f"{bound_ms:.3f} ms by {bound_by} ({bound_ms / ms:.1%} "
                    f"of it)")
                rows.append(dict(kernel=name, shape=f"wan2_1_1_3b layer "
                                 f"{layer} plans", dtype=dname,
                                 live_tiles=live, ms=ms, bound_ms=bound_ms,
                                 bound_by=bound_by,
                                 bound_fraction=bound_ms / ms, **c, **lib))
            del dq_args, dkv_args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"backward kernel disagrees with its plain twin "
                           f"on the path's plans: {bad}")
    return rows


def phase_grad_cross_check(cfg, plans):
    """Gradients of q, k, v, qp and kp through the kernel backend's
    autograd.Function against the gather backend's autograd, at the Wan
    shape on layer 0's plan, for one random cotangent of (O^s, O^l). In
    f32 (the f32-FMA backward kernels) within 1e-4 x max(1, max |g|); in
    bf16 (the tensor-core kernels) against the gather backend's f32
    autograd on the same bf16-rounded inputs by `cases.tc_criterion`, the
    "rounded" term from the kernel backend run through the twins that
    round dO, P and dS to bf16."""
    sla = cfg.sla
    plan = plan_lib.plan_map(lambda leaf: leaf[0], plans)
    h, n, d = cfg.num_heads, MAIN_SEQ, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(3)
    q, k, v, g_s, g_l = (torch.randn((1, h, n, d), generator=gen,
                                     device=DEV) for _ in range(5))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        xs = [x.to(dtype) for x in (q, k, v)]
        xs += [phi_lib.phi(xs[0], sla.phi), phi_lib.phi(xs[1], sla.phi)]
        ins = [x.detach().requires_grad_() for x in xs]
        sla_bwd.LAUNCHES_DQ = sla_bwd.LAUNCHES_DKV = 0
        sla_bwd.TC_LAUNCHES_DQ = sla_bwd.TC_LAUNCHES_DKV = 0
        sla_fwd.TC_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        got = torch.autograd.grad(ops.sla_attention_core(*ins, plan, sla),
                                  ins, (g_s, g_l))
        torch.cuda.synchronize()
        s_kernel = time.time() - t0
        launches = (sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV)
        tc = (sla_fwd.TC_LAUNCHES, sla_bwd.TC_LAUNCHES_DQ,
              sla_bwd.TC_LAUNCHES_DKV)
        f32_ins = [x.detach().float().requires_grad_() for x in xs]
        t0 = time.time()
        want = torch.autograd.grad(sla_forward_gather(*f32_ins, plan, sla),
                                   f32_ins, (g_s, g_l))
        torch.cuda.synchronize()
        s_gather = time.time() - t0
        rounded = (_through_rounded_twins(ins, plan, sla, (g_s, g_l))
                   if dtype == torch.bfloat16 else None)
        res = {}
        for i, name in enumerate(("q", "k", "v", "qp", "kp")):
            a, b = got[i], want[i]
            if rounded is not None:
                res[name] = cases.tc_criterion(a, b, rounded[i])
                continue
            err = float((a - b).abs().max())
            limit = GRAD_TOL * max(1.0, float(b.abs().max()))
            res[name] = dict(max_abs_err=err, limit=limit,
                             ok=bool(np.isfinite(err)) and err <= limit)
        want_tc = (0, 0, 0) if rounded is None else (1, 1, 1)
        ok = all(r["ok"] for r in res.values()) and launches == (1, 1) \
            and tc == want_tc
        say(f"[8 grads] Wan shape, layer-0 plan, {dname}: kernel vs gather "
            f"backend grads " + ", ".join(
                f"d{k} {r['max_abs_err']:.3g} (limit {r['limit']:.3g}"
                + (f", rounded twins {r['rounded_err']:.3g})"
                   if "rounded_err" in r else ")") for k, r in res.items())
            + f" | dQ, dK/dV launches {launches}, tensor-core (forward, "
            f"dQ, dK/dV) {tc} | "
            f"forward+backward wall: kernel {s_kernel:.3f}s, gather "
            f"{s_gather:.3f}s {'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel and gather gradients disagree "
                               f"({dname}): {res}, launches {launches}, "
                               f"tensor-core {tc}")
        out[dname] = dict(grads=res, kernel_s=s_kernel, gather_s=s_gather,
                          tc_launches=tc)
        del got, want, rounded, ins, f32_ins
    return out


def _through_rounded_twins(ins, plan, sla, cot):
    """The kernel backend's gradients with its forward and backward kernels
    replaced by the plain twins that round P (forward) and dO, P and dS
    (backward) to bf16: the rounding alone, with every other operation as
    in the kernel run."""
    saved = ops.sla_fwd, ops.sla_bwd_dq, ops.sla_bwd_dkv
    ops.sla_fwd = functools.partial(sla_fwd.sla_fwd_plain,
                                    mma_dtype=torch.bfloat16)
    ops.sla_bwd_dq = functools.partial(sla_bwd.sla_bwd_dq_plain,
                                       mma_dtype=torch.bfloat16)
    ops.sla_bwd_dkv = functools.partial(sla_bwd.sla_bwd_dkv_plain,
                                        mma_dtype=torch.bfloat16)
    try:
        ins = [x.detach().requires_grad_() for x in ins]
        return torch.autograd.grad(ops.sla_attention_core(*ins, plan, sla),
                                   ins, cot)
    finally:
        ops.sla_fwd, ops.sla_bwd_dq, ops.sla_bwd_dkv = saved


def phase_train(cfg, params, profile: bool):
    """The training main path: AdamW steps through make_train_step on the
    kernel backend under per-layer remat, with per-step launch and plan
    counts."""
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                total_steps=TRAIN_STEPS)
    shape = dataclasses.replace(DIT_SHAPES["wan2_1_1_3b"],
                                global_batch=TRAIN_BATCH)
    data = make_iterator(cfg, shape, DataConfig(seed=0))
    step_fn = train_steps.make_train_step(cfg, opt_cfg, backend="kernel")
    named = dict(params.named_parameters())
    opt_state = adamw.init(named)
    probe = {n: named[n].detach().clone() for n in PROBES}
    builds = [0]
    orig_plan = plan_lib.plan_attention

    def counted_plan(*a, **kw):
        builds[0] += 1
        return orig_plan(*a, **kw)

    def step(batch):
        return step_fn(params, opt_state, {k: torch.from_numpy(x).to(DEV)
                                           for k, x in batch.items()})

    want = dict(sla_fwd=2 * cfg.num_layers, sla_bwd_dq=cfg.num_layers,
                sla_bwd_dkv=cfg.num_layers, tc_sla_fwd=2 * cfg.num_layers,
                tc_sla_bwd_dq=cfg.num_layers, tc_sla_bwd_dkv=cfg.num_layers,
                plan_builds=cfg.num_layers)
    rows, totals = [], dict.fromkeys(want, 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plan_lib.plan_attention = counted_plan
    try:
        with actx.activation_sharding(remat=True):
            for i in range(TRAIN_STEPS):
                batch = next(data)
                torch.cuda.synchronize()
                sla_fwd.LAUNCHES = sla_bwd.LAUNCHES_DQ = 0
                sla_bwd.LAUNCHES_DKV = builds[0] = 0
                sla_bwd.TC_LAUNCHES_DQ = sla_bwd.TC_LAUNCHES_DKV = 0
                sla_fwd.TC_LAUNCHES = 0
                t0 = time.time()
                params, opt_state, loss, gnorm = step(batch)
                loss, gnorm = float(loss), float(gnorm)
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = dict(sla_fwd=sla_fwd.LAUNCHES,
                           sla_bwd_dq=sla_bwd.LAUNCHES_DQ,
                           sla_bwd_dkv=sla_bwd.LAUNCHES_DKV,
                           tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                           tc_sla_bwd_dq=sla_bwd.TC_LAUNCHES_DQ,
                           tc_sla_bwd_dkv=sla_bwd.TC_LAUNCHES_DKV,
                           plan_builds=builds[0])
                for key in totals:
                    totals[key] += got[key]
                say(f"[9 train] step {i}: loss {loss:.6f} grad norm "
                    f"{gnorm:.6f} | {wall:.3f}s | launches {got} (expected "
                    f"{want})")
                rows.append(dict(step=i, loss=loss, grad_norm=gnorm,
                                 wall_s=wall, **got))
                if not (np.isfinite(loss) and np.isfinite(gnorm)):
                    raise RuntimeError(f"training step {i}: non-finite loss "
                                       f"{loss} or grad norm {gnorm}")
                if got != want:
                    raise RuntimeError(f"training step {i}: launches {got}, "
                                       f"expected {want}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            per_launch = None
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                batch = next(data)
                torch.cuda.synchronize()
                t0 = time.time()
                with prof_ctx(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    step(batch)
                    torch.cuda.synchronize()
                say(f"[9 train profile] one more step, {time.time() - t0:.3f}"
                    f"s wall under the profiler")
                say(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25))
                per_launch = _kernel_means(prof, ("sla_fwd_tc_kernel",
                                                  "sla_bwd_dq_tc_kernel",
                                                  "sla_bwd_dkv_tc_kernel"))
                say(f"[9 train profile] tensor-core SLA kernels on the "
                    f"training plans, (mean device ms, launches): "
                    f"{per_launch}")
    finally:
        plan_lib.plan_attention = orig_plan
    moved = {n: bool((named[n].detach() != probe[n]).any()) for n in PROBES}
    say(f"[9 train] {TRAIN_STEPS} steps of wan2_1_1_3b at seq_len "
        f"{shape.seq_len}, batch {shape.global_batch}: step walls "
        f"{[round(r['wall_s'], 3) for r in rows]} s | peak memory "
        f"{peak:.2f} GiB | parameters moved {moved}")
    if not all(moved.values()):
        raise RuntimeError(f"training did not move the parameters: {moved}")
    return dict(steps=rows, launches=totals, peak_gib=peak, moved=moved,
                ms_per_launch=per_launch)


def _kernel_means(prof, names) -> dict:
    """{name: (mean device ms per launch, launches)} of the profiled
    kernels whose symbol contains each name."""
    out = {}
    for name in names:
        evs = [e for e in prof.key_averages() if name in e.key]
        total = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0) for e in evs)
        count = sum(e.count for e in evs)
        out[name] = (total / count / 1e3 if count else None, count)
    return out


def phase_train_cli():
    """The smoke fine-tuning recipe (distillation against the frozen,
    zero-initialized output projection: its losses are exactly 0) and a
    plain flow-matching run whose losses must be non-zero and move."""
    recipe = ["--arch", "lightningdit_1b", "--smoke", "--distill",
              "--routing-mode", "learned", "--train-only", "routing,sla_proj",
              "--routing-warm-init", "--steps", "3", "--log-every", "1"]
    flow = ["--arch", "lightningdit_1b", "--smoke", "--steps", "2",
            "--log-every", "1"]
    out = {}
    for what, argv in (("recipe", recipe), ("flow", flow)):
        t0 = time.time()
        losses = train_cli.main(argv)
        ok = len(losses) == int(argv[argv.index("--steps") + 1]) \
            and bool(np.isfinite(losses).all())
        if what == "flow":
            ok = ok and min(losses) > 0 and losses[1] != losses[0]
        say(f"[10 train CLI] {what}: repro_torch.launch.train "
            f"{' '.join(argv)}: losses {losses} in {time.time() - t0:.1f}s "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"train CLI ({what}) losses {losses}")
        out[what] = losses
    return out



# --------------------------------------------------------------------------
def _decode_operands(seed: int, c: int, kv_dtype, pos: int, b=2, hkv=8, g=2,
                     d=128, bkv=64, tn=LM_MAX_LEN // 64, k_sel=26):
    """The decode kernel's flat operands at the Qwen3 decode shape: C
    tokens from base position `pos` (mid-block), a live LUT per (bh, c)
    with the diagonal block first and other distinct valid blocks after
    it, cnt in [1, K], padded slots naming another valid block, every
    third marg 0, and per-token totals and diagonal partials that grow
    token by token (C = 1: the live-row layout of the main path, one
    running total per kv head and no partials)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    bh, bh_kv, row = b * hkv * g, b * hkv, pos // bkv

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=DEV)

    k = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=DEV)
    v = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=DEV)
    hblk, zblk = rnd(bh_kv, tn, d, d) * 0.2, rnd(bh_kv, tn, d) + 0.1
    hblk[:, row + 1:] = 0
    zblk[:, row + 1:] = 0
    others = torch.argsort(rnd(bh, c, row), dim=-1)[..., :k_sel - 1]
    lut = torch.cat([torch.full((bh, c, 1), row, device=DEV), others], -1)
    cnt = torch.randint(1, k_sel + 1, (bh, c), generator=gen, device=DEV)
    dead = torch.arange(k_sel, device=DEV) >= cnt[..., None]
    pad = torch.randint(0, row, (bh, c, k_sel), generator=gen, device=DEV)
    lut = torch.where(dead, pad, lut).int().contiguous()
    marg = torch.randint(0, 4, (bh, c), generator=gen, device=DEV).int()
    marg.view(-1)[::3] = 0
    grow, growz = rnd(bh_kv, c, d, d) * 0.05, rnd(bh_kv, c, d) * 0.05
    htot = (hblk.sum(1)[:, None] + grow.cumsum(1)).contiguous()
    ztot = (zblk.sum(1)[:, None] + growz.cumsum(1)).contiguous()
    if c == 1:
        hdiag = zdiag = None
        htot, ztot = htot[:, 0], ztot[:, 0]
    else:
        hdiag = (hblk[:, row][:, None] * 0.5 + grow.cumsum(1)).contiguous()
        zdiag = (zblk[:, row][:, None] * 0.5 + growz.cumsum(1)).contiguous()
    q = torch.randn((bh, c, d), generator=gen, device=DEV)
    qp = torch.softmax(torch.randn((bh, c, d), generator=gen, device=DEV),
                       dim=-1)
    posv = torch.full((bh,), pos, dtype=torch.int32, device=DEV)
    args = (lut, cnt.int(), marg, posv, q, qp, k.to(kv_dtype),
            v.to(kv_dtype), hblk, zblk, hdiag, zdiag, htot, ztot)
    return args, dict(scale=d ** -0.5, block_kv=bkv, group=g)


def _decode_bound(args, kw):
    """Least time for one decode call: bytes over HBM bandwidth against
    operations over the f32 peak. Bytes: each (kv head, block) that any
    query head of its group selects (live slots only) once for its K and
    V tiles, and once for its hblk and zblk tiles unless only the
    diagonal slot selects it and per-token partials stand in for it;
    each (kv head, token) diagonal partial that a live diagonal slot
    reads; the totals (per token or one per kv head); q, qp, the outputs
    and the integer operands. Operations: 4 bkv D + 2 D^2 per live
    (bh, c, block) plus the totals' 2 D^2 + 2 D per (bh, c)."""
    lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag, htot, \
        ztot = args
    bh, c, k_sel = lut.shape
    bh_kv, tn, bkv, d = k.shape
    live = torch.arange(k_sel, device=DEV) < torch.clamp(
        cnt, max=k_sel)[..., None]
    kvrow = (torch.arange(bh, device=DEV) // kw["group"])[:, None, None]
    tile = (kvrow * tn + lut.long()).expand(bh, c, k_sel)
    blocks = int(torch.unique(tile[live]).numel())
    h_tiles, diag_reads = blocks, 0
    if hdiag is not None:  # the diagonal slot reads hdiag/zdiag instead
        diag = ((posv.long()[:, None] + torch.arange(c, device=DEV))
                // bkv)[..., None]
        on_diag = live & (lut.long() == diag)
        h_tiles = int(torch.unique(tile[live & ~on_diag]).numel())
        kvtok = (kvrow * c + torch.arange(c, device=DEV)[:, None]).expand(
            bh, c, k_sel)
        diag_reads = int(torch.unique(kvtok[on_diag]).numel())
    slots = int(live.sum())
    nbytes = (blocks * 2 * bkv * d * k.element_size()
              + (h_tiles + diag_reads) * (d * d + d) * 4
              + sum(t.numel() * 4 for t in (htot, ztot))
              + 4 * bh * c * d * 4
              + sum(t.numel() * 4 for t in (lut, cnt, marg, posv)))
    flops = slots * (4 * bkv * d + 2 * d * d) + bh * c * (2 * d * d + 2 * d)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            blocks, slots)


DECODE_WIDTHS = (None, 1, 2)  # the chosen split width, then forced ones


def _split_runs(fn, args, kw, q, lut, want, zeros_of, extra=None):
    """Kernel 4 or 5 (`fn`) at each of DECODE_WIDTHS against the unsplit
    twin's `want`: max abs error, exact zeros where marg = 0 (`zeros_of`
    picks them), two launches bitwise equal, `extra(width, got)` (False
    fails), and the device time (`cuda_graph_ms`). Returns one dict a
    width, the chosen first."""
    limit = TWIN_TOL * max(1.0, max(float(w.abs().max()) for w in want))
    runs = []
    for width in DECODE_WIDTHS:
        geo = sla_decode.split_geometry(q, lut, width)
        got = fn(*args, **kw, split_width=width)
        again = fn(*args, **kw, split_width=width)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not np.isfinite(err):
            raise RuntimeError(f"decode kernel at split width {width}: "
                               f"non-finite output")
        run = dict(width=width, **geo, max_abs_err=err, limit=limit,
                   zeros=bool((zeros_of(got) == 0).all()),
                   bitwise_repeat=all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
                   extra=True if extra is None else extra(width, got))
        run["ok"] = (err <= limit and run["zeros"] and run["bitwise_repeat"]
                     and run["extra"])
        del got, again
        run["ms"] = cuda_graph_ms(lambda: fn(*args, **kw, split_width=width))
        runs.append(run)
    return runs


def _runs_text(runs) -> str:
    return "; ".join(
        f"width {r['split_width']}{' (chosen)' if r['width'] is None else ''}"
        f", {r['nsplit']} splits, grid {r['grid_ctas']} + {r['rows']} "
        f"blocks: err {r['max_abs_err']:.3g}, bitwise repeat "
        f"{r['bitwise_repeat']}, {r['ms']:.4f} ms"
        f"{' OK' if r['ok'] else ' FAIL'}" for r in runs)


def _split_summary(runs, bound_ms) -> dict:
    """The chosen width's numbers and width 1's time beside them."""
    chosen = runs[0]
    return dict(max_abs_err=max(r["max_abs_err"] for r in runs),
                limit=chosen["limit"], ok=all(r["ok"] for r in runs),
                ms=chosen["ms"], split_width=chosen["split_width"],
                nsplit=chosen["nsplit"], grid_ctas=chosen["grid_ctas"],
                ms_width1=runs[1]["ms"], ms_width2=runs[2]["ms"],
                bitwise_repeat=all(r["bitwise_repeat"] for r in runs),
                bound_fraction=bound_ms / chosen["ms"],
                widths=[{k: r[k] for k in ("split_width", "nsplit",
                                           "grid_ctas", "max_abs_err",
                                           "ms", "ok")} for r in runs])


def _decode_case(args, kw, what: str, reps: int = 50):
    """The decode kernel against its twin on one set of card operands at
    the chosen split width and at widths 1 and 2: errors, exact zeros
    where marg = 0, two launches bitwise equal, device times (CUDA graph
    replays), the eager call's time, and the bound."""
    want = sla_decode.sla_decode_plain(*args, **kw)
    runs = _split_runs(sla_decode.sla_decode, args, kw, args[4], args[0],
                       want, lambda got: got[1][args[2] == 0])
    for r in runs:
        r["rows"] = args[4].shape[0] * args[4].shape[1]
    eager_ms = cuda_ms(lambda: sla_decode.sla_decode(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: sla_decode.sla_decode_plain(*args, **kw), 5,
                       warmup=1)
    bound_ms, bound_by, flops, nbytes, blocks, slots = _decode_bound(args,
                                                                     kw)
    row = _split_summary(runs, bound_ms)
    say(f"  {what}: {_runs_text(runs)} (limit {row['limit']:.3g}, marg-0 "
        f"rows exact zeros {all(r['zeros'] for r in runs)}) | eager call "
        f"{eager_ms:.4f} ms | bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {blocks} (kv head, block) tiles, {slots} "
        f"live slots; {row['bound_fraction']:.1%} of it) | plain twin "
        f"{plain_ms:.3f} ms")
    return dict(row, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, blocks_read=blocks, live_slots=slots)


def phase_decode_vs_plain():
    """sla_decode vs its plain twin at the Qwen3 decode shape, random
    LUTs, and the dense SDPA yardstick."""
    rows = []
    pos = 300 * 64 + 32  # row 300 of 512, mid-block
    for c in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            args, kw = _decode_operands(21 + c, c, dtype, pos)
            say(f"[11 decode kernel] qwen3-1.7b decode shape (BH=32, "
                f"BH_kv=16, C={c}, D=128, bkv=64, Tn=512, K=26, pos {pos}) "
                f"K/V {dname}")
            row = _decode_case(args, kw, f"C={c} {dname}")
            rows.append(dict(shape=f"qwen3-1.7b decode C={c}", dtype=dname,
                             c=c, pos=pos, **row))
            del args
    gen = torch.Generator(device=DEV).manual_seed(9)
    q = torch.randn((LM_BATCH, 16, 1, 128), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    kv = [torch.randn((LM_BATCH, 8, LM_MAX_LEN, 128), generator=gen,
                      device=DEV, dtype=torch.bfloat16) for _ in range(2)]
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, *kv, enable_gqa=True), 50)
    say(f"  dense SDPA yardstick (one bf16 query token per head over the "
        f"whole {LM_MAX_LEN}-token cache, GQA; not the same function): "
        f"{sdpa_ms:.4f} ms")
    del q, kv
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"decode kernel disagrees with its plain twin: "
                           f"{bad}")
    return rows, sdpa_ms


# --------------------------------------------------------------------------
def _lm_model(seed: int):
    """Full-width qwen3-1.7b with random weights from a seeded generator;
    sla_proj (zero-initialized) is redrawn so that O^l reaches the
    logits."""
    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = transformer.init(gen, cfg, device=DEV)
    with torch.no_grad():
        for layer in params.layers:
            layer.sla_proj.copy_(0.1 * torch.randn(
                layer.sla_proj.shape, generator=gen, device=DEV))
    return cfg, params


def phase_lm_main(cfg, params):
    """The LM serving main path: the static engine on the kernel backend
    with decode-time SLA. Keeps the last group's decode state, its last
    token, its prefill plans and the first group's prefill tokens for
    phase 13."""
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rs.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LM_PROMPTS, LM_MAX_NEW))]
    engine = ServingEngine(cfg, params, batch_size=LM_BATCH,
                           max_len=LM_MAX_LEN, backend="kernel",
                           decode_sla=True)
    last, plans, groups, first = {}, [], [], {}
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    run_prefill, decode_loop = engine._run_prefill, engine._decode_loop
    one, run_group = engine._one, engine._run_group

    def prefill_hook(toks):  # frees the previous group's state first
        last.clear()
        plans.clear()
        first.setdefault("toks", toks)
        return run_prefill(toks)

    def decode_loop_hook(p, token, cache, n):
        token, cache, buf = decode_loop(p, token, cache, n)
        last.update(token=token, cache=cache)
        return token, cache, buf

    def one_hook(p, token, cache):
        logits, cache = one(p, token, cache)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    def group_hook(group):
        st = engine.stats
        before = (st.prefill_s, st.decode_s, st.decode_tokens)
        out = run_group(group)
        groups.append(dict(prefill_s=st.prefill_s - before[0],
                           decode_s=st.decode_s - before[1],
                           decode_tokens=st.decode_tokens - before[2],
                           steps=max(r.max_new_tokens for r in group) - 1))
        return out

    orig_plan = backend_lib.plan_attention

    def plan_hook(*a, **kw):
        plan = orig_plan(*a, **kw)
        plans.append(plan)
        return plan

    engine._run_prefill, engine._decode_loop = prefill_hook, decode_loop_hook
    engine._one, engine._run_group = one_hook, group_hook
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    backend_lib.plan_attention = plan_hook
    t0 = time.time()
    try:
        done = engine.run(reqs)
    finally:
        backend_lib.plan_attention = orig_plan
    wall = time.time() - t0
    launches = dict(sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = engine.stats
    n_steps = sum(g["steps"] for g in groups)
    want = dict(sla_decode=cfg.num_layers * n_steps, sla_decode_paged=0,
                sla_fwd=cfg.num_layers * len(groups),
                tc_sla_fwd=cfg.num_layers * len(groups))
    say(f"[12 lm main] {len(done)} requests, {LM_ARCH} at full width and "
        f"depth ({cfg.num_layers} layers, bf16 compute), batch {LM_BATCH}, "
        f"max_len "
        f"{LM_MAX_LEN}, kernel backend, decode-SLA, in {wall:.2f}s | peak "
        f"memory {peak:.2f} GiB")
    for i, g in enumerate(groups):
        say(f"  group {i}: prefill {g['prefill_s']:.3f}s ({LM_BATCH} x "
            f"{engine._bucket} tokens) | decode {g['decode_s']:.3f}s for "
            f"{g['steps']} steps = {1e3 * g['decode_s'] / g['steps']:.2f} "
            f"ms per step, {1e3 * g['decode_s'] / g['decode_tokens']:.2f} "
            f"ms per generated token")
    say(f"  stats: prefill {st.prefill_tokens} tok / {st.prefill_s:.3f}s, "
        f"decode {st.decode_tokens} tok / {st.decode_s:.3f}s | decode plans"
        f" {st.decode_plan_builds} built, {st.decode_plan_extends} extended,"
        f" {st.decode_plan_replans} re-planned, {st.decode_plan_reuses} "
        f"reused, retention {st.decode_last_retention:.4f}")
    say(f"  launches {launches} (expected {want}) | logits finite "
        f"{bool(finite)}")
    for r in done:
        say(f"  request {r.rid}: prompt {len(r.prompt)}, "
            f"{len(r.tokens_out)} tokens, TTFT {r.metrics.ttft_s:.3f}s, "
            f"latency {r.metrics.latency_s:.3f}s, first tokens "
            f"{r.tokens_out[:4]}")
    # each group decodes positions bucket .. bucket + steps - 1; every
    # multiple of block_q there is a boundary (a re-plan or reuse per
    # layer), and every one but the first (the prompt's end) appends a row
    bq, nl = cfg.sla.block_q, cfg.num_layers
    bounds = [len(range(-(-engine._bucket // bq) * bq,
                        engine._bucket + g["steps"], bq)) for g in groups]
    want_counters = (nl * len(groups), nl * sum(n - 1 for n in bounds),
                     nl * sum(bounds))
    counters = (st.decode_plan_builds, st.decode_plan_extends,
                st.decode_plan_replans + st.decode_plan_reuses)
    want_steps = sum(max(LM_MAX_NEW[i:i + LM_BATCH]) - 1
                     for i in range(0, len(LM_MAX_NEW), LM_BATCH))
    say(f"  decode-plan counters (builds, extends, re-plans + reuses) "
        f"{counters} (expected {want_counters}) | {n_steps} decode steps "
        f"(expected {want_steps})")
    if [len(r.tokens_out) for r in done] != list(LM_MAX_NEW):
        raise RuntimeError("an LM request did not finish with its tokens")
    if not bool(finite):
        raise RuntimeError("non-finite logits on the LM main path")
    if launches != want or n_steps != want_steps or launches[
            "sla_decode"] == 0:
        raise RuntimeError(f"LM main path launches {launches}, steps "
                           f"{n_steps}; expected {want} over {want_steps}")
    if counters != want_counters:
        raise RuntimeError(f"decode-plan counters {counters}, expected "
                           f"{want_counters}")
    return dict(engine=engine, last=last, plans=plans,
                prefill_toks=first["toks"], summary=dict(
        wall_s=wall, peak_gib=peak, groups=groups, launches=launches,
        prefill_s=st.prefill_s, decode_s=st.decode_s,
        decode_tokens=st.decode_tokens,
        decode_plan_builds=st.decode_plan_builds,
        decode_plan_extends=st.decode_plan_extends,
        decode_plan_replans=st.decode_plan_replans,
        decode_plan_reuses=st.decode_plan_reuses,
        decode_last_retention=st.decode_last_retention))


def _step_snapshot(cache, bkv: int):
    """What one SLA decode step at cache["pos"] writes, copied: the K/V
    and hblk slices at that position and every smaller leaf of the
    decode state (the plan included). `_restore` puts it back."""
    pos = cache["pos"]
    st = cache["sla"]
    snap = {"pos": pos, "k": cache["k"][..., pos, :].clone(),
            "v": cache["v"][..., pos, :].clone(),
            "hblk": st["hblk"][:, :, :, pos // bkv].clone(), "sla": {}}
    for name, leaf in st.items():
        if name == "hblk":
            continue
        if torch.is_tensor(leaf):
            leaf = leaf.clone()
        elif isinstance(leaf, plan_lib.SLAPlan):
            leaf = plan_lib.plan_map(torch.clone, leaf)
        snap["sla"][name] = leaf
    return snap


def _restore(cache, snap, bkv: int):
    pos = snap["pos"]
    cache["pos"] = pos
    cache["k"][..., pos, :] = snap["k"]
    cache["v"][..., pos, :] = snap["v"]
    cache["sla"]["hblk"][:, :, :, pos // bkv] = snap["hblk"]
    cache["sla"].update(snap["sla"])


def _profile_prefill(engine, toks):
    """torch.profiler over one LM prefill as the engine runs it (decode
    state seeded): device time, the device's busy share and the forward
    kernel's share of the device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    torch.cuda.synchronize()
    t0 = time.time()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = engine._prefill(engine._cparams, toks)
        torch.cuda.synchronize()
    wall = time.time() - t0
    del out
    torch.cuda.empty_cache()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    fwd = [e for e in kernels if "sla_fwd_kernel" in e.key
           or "sla_fwd_tc_kernel" in e.key]
    fwd_us = sum(e.self_device_time_total for e in fwd)
    fwd_n = sum(e.count for e in fwd)
    res = dict(wall_s=wall, device_s=dev_us / 1e6, busy=dev_us / 1e6 / wall,
               sla_fwd_s=fwd_us / 1e6, sla_fwd_launches=fwd_n,
               sla_fwd_share=fwd_us / max(dev_us, 1e-9))
    say(f"[13 lm prefill profile] one prefill ({tuple(toks.shape)} tokens): "
        f"{wall:.3f}s wall under the profiler, {dev_us / 1e6:.3f}s device "
        f"time, device busy {res['busy']:.3f} | sla_fwd {fwd_n} launches, "
        f"{fwd_us / 1e6:.3f}s = {res['sla_fwd_share']:.3f} of device time")
    say(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=15))
    return res


def _decode_kernel_time(events):
    """The decode kernels' device time (us) in a profile's key averages,
    split and combine kernels together, and the split kernel's launches."""
    mine = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and re.search(r"sla_decode_(split|combine)_kernel", e.key)]
    return (sum(e.self_device_time_total for e in mine),
            sum(e.count for e in mine if "split" in e.key))


def phase_lm_cross_check(cfg, run, profile: bool):
    engine, last, plans = run["engine"], run["last"], run["plans"]
    cache, token = last["cache"], last["token"]
    params = engine._cparams
    st = cache["sla"]
    sla = cfg.sla
    bkv = sla.block_kv
    tn = cache["k"].shape[-2] // bkv
    dcfg = sla.decode_plan_cfg(tn)
    pos = cache["pos"] - 1  # the last token the state holds
    hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    gen = torch.Generator(device=DEV).manual_seed(6)
    dec_rows, res = [], {}
    for layer in (0, cfg.num_layers - 1):
        state = {"k": cache["k"][layer], "v": cache["v"][layer],
                 "hblk": st["hblk"][layer], "zblk": st["zblk"][layer],
                 "htot": st["htot"][layer], "ztot": st["ztot"][layer],
                 "lut": st["live_lut"][layer], "cnt": st["live_cnt"][layer],
                 "marg": st["live_marg"][layer]}
        q = torch.randn((LM_BATCH, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device=DEV)
        proj = {"proj": params.layers[layer].sla_proj}
        with torch.no_grad():
            o_k = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="kernel")
            o_g = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="gather")
        err = float((o_k - o_g).abs().max())
        limit = TWIN_TOL * max(1.0, float(o_g.abs().max()))
        qg = backend_lib._group_heads(q[:, :, 0].float(), hkv)[..., None, :]
        qpg = backend_lib._group_heads(phi_lib.phi(q[:, :, 0], sla.phi),
                                       hkv)[..., None, :]
        flat = sla_decode._flat_args(
            *sla_decode.decode_operands(state, qg, qpg, pos), bkv)
        kw = dict(scale=cfg.head_dim ** -0.5, block_kv=bkv, group=g)
        live = int(torch.clamp(state["cnt"], max=state["lut"].shape[-1])
                   .sum())
        say(f"[13 lm cross-check] layer {layer} at pos {pos} (live row "
            f"{pos // bkv}, {live} live LUT slots of {state['lut'].numel()})"
            f": decode_execute kernel vs gather max abs err {err:.3g} (limit"
            f" {limit:.3g}) {'OK' if err <= limit else 'FAIL'}")
        row = _decode_case(flat, kw, f"sla_decode vs twin on layer {layer}'s"
                           f" path LUTs (K/V bf16)")
        row["ok"] = row["ok"] and err <= limit
        dec_rows.append(dict(shape=f"qwen3-1.7b path LUTs layer {layer}",
                             dtype="bf16", c=1, pos=pos,
                             backend_err=err, backend_limit=limit, **row))
        del state, flat
    # one full decode step, kernel vs gather backend, from the same cache
    bad = [r for r in dec_rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"decode kernel disagrees on the path's state: "
                           f"{bad}")
    snap = _step_snapshot(cache, bkv)
    with torch.no_grad():
        l_k, _ = transformer.decode_step(
            params, cfg, token, cache, backend="kernel",
            drift_threshold=engine.drift_threshold)
        _restore(cache, snap, bkv)
        l_g, _ = transformer.decode_step(
            params, cfg, token, cache, backend="gather",
            drift_threshold=engine.drift_threshold)
    del snap
    diff = float((l_k - l_g).abs().max())
    limit = LM_LOGIT_TOL * max(1.0, float(l_g.abs().max()))
    agree = float((l_k.argmax(-1) == l_g.argmax(-1)).float().mean())
    ok = bool(torch.isfinite(l_k).all()) and diff <= limit
    say(f"[13 lm cross-check] one full decode step at pos {pos + 1}, logits"
        f" kernel vs gather max abs diff {diff:.3g} (limit {limit:.3g}, max "
        f"|logits| {float(l_g.abs().max()):.3g}) {'OK' if ok else 'FAIL'} |"
        f" greedy tokens agree on {agree:.2f} of the batch")
    if not ok:
        raise RuntimeError("kernel and gather LM decode steps disagree")
    res.update(step_logit_diff=diff, step_logit_limit=limit,
               greedy_agreement=agree)
    # 8 more decode steps, timed, and profiled under --profile
    tok = l_g.argmax(-1)

    def steps8():
        nonlocal tok, cache
        with torch.no_grad():
            for _ in range(8):
                logits, cache = transformer.decode_step(
                    params, cfg, tok, cache, backend="kernel",
                    drift_threshold=engine.drift_threshold)
                tok = logits.argmax(-1)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.time()
    steps8()
    res["steps8_ms_per_step"] = (time.time() - t0) / 8 * 1e3
    say(f"  8 more decode steps: {res['steps8_ms_per_step']:.2f} ms per step")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof_ctx
        t0 = time.time()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            steps8()
        wall = time.time() - t0
        events = prof.key_averages()
        # kernel-level device events only (an op's row repeats its
        # kernels' time), as the profiler's own table total
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        k4_us, k4_n = _decode_kernel_time(events)
        res["profile"] = dict(wall_s=wall, device_s=dev_us / 1e6,
                              busy=dev_us / 1e6 / wall,
                              kernel_s=k4_us / 1e6, kernel_launches=k4_n)
        say(f"[13 lm profile] 8 decode steps: {wall:.3f}s wall under the "
            f"profiler, {dev_us / 1e6:.3f}s device time, device busy "
            f"{dev_us / 1e6 / wall:.3f} | decode kernels {k4_n} launches, "
            f"{k4_us / 1e6:.4f}s")
        say(events.table(sort_by="self_cuda_time_total", row_limit=20))
    last.clear()
    del cache, token
    torch.cuda.empty_cache()
    if profile:
        res["prefill_profile"] = _profile_prefill(engine, run["prefill_toks"])
    # the forward kernel against its twin on the prefill's own LUTs, at
    # the layout the path gives it: the kernel backend repeats K/V to the
    # query heads before the kernel (`execute`, as the reference does)
    fwd_rows = []
    n, d, h = LM_PROMPTS[0], cfg.head_dim, cfg.num_heads
    gen = torch.Generator(device=DEV).manual_seed(7)
    q = torch.randn((LM_BATCH, h, n, d), generator=gen, device=DEV)
    k, v = (torch.randn((LM_BATCH, hkv, n, d), generator=gen, device=DEV)
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    fk_g, fv_g = ops._flat(k), ops._flat(v)  # the kv heads, unrepeated
    k, v = (plan_lib.repeat_kv(x, h) for x in (k, v))
    qp, kp = phi_lib.phi(q, sla.phi), phi_lib.phi(k, sla.phi)
    fq, fk, fv, fqp = map(ops._flat, (q, k, v, qp))
    hb, zb = ops._hz_blocks(ops._flat(kp), fv, bkv)
    for layer in (0, cfg.num_layers - 1):
        plan = plans[layer]
        a, lut, counts = map(ops._flat, (plan.marginal, plan.lut,
                                         plan.counts))
        hi, zi = ops._aggregate(a, hb, zb)
        args = (lut, counts, fq, fk, fv, fqp, hi, zi)
        kw = dict(scale=d ** -0.5, causal=True, block_q=sla.block_q,
                  block_kv=bkv)
        c = _fwd_check(args, kw, f"lm prefill layer {layer}")
        ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 10)
        bound_ms, bound_by, _, _, live = _bound(args, kw)
        # the same call on the unrepeated kv heads (group 2): the kernel
        # reads a kv head for each of its 2 query heads, bitwise as on
        # the repeated copy (the path keeps `_repeat_kv`, as the reference)
        args_g = (lut, counts, fq, fk_g, fv_g, fqp, hi, zi)
        rep, grp = sla_fwd.sla_fwd(*args, **kw), sla_fwd.sla_fwd(*args_g,
                                                                **kw)
        c["group2_bitwise"] = all(torch.equal(a, b)
                                  for a, b in zip(rep, grp))
        del rep, grp
        c["group2_ms"] = cuda_ms(lambda: sla_fwd.sla_fwd(*args_g, **kw), 10)
        c["ok"] = c["ok"] and c["group2_bitwise"]
        say(f"[13 lm prefill plans] sla_fwd qwen3-1.7b prefill layer {layer}"
            f" bf16 causal, K/V repeated to the {h} query heads as on the "
            f"path (BH={fq.shape[0]}, BH_kv={fk.shape[0]}, "
            f"N={n}, K={lut.shape[-1]}, live tiles {live} of {lut.numel()})"
            f": {_fwd_text(c)} | kernel {ms:.3f} ms | bound {bound_ms:.3f} "
            f"ms by {bound_by} ({bound_ms / ms:.1%} of it)")
        say(f"  the same on the unrepeated kv heads (BH_kv={fk_g.shape[0]},"
            f" group 2): {c['group2_ms']:.3f} ms, bitwise equal to the "
            f"repeated run {c['group2_bitwise']}")
        fwd_rows.append(dict(shape=f"qwen3-1.7b prefill layer {layer} plans",
                             dtype="bf16", live_tiles=live, ms=ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_fraction=bound_ms / ms, **c))
        del args, args_g, hi, zi
    if not all(r["ok"] for r in fwd_rows):
        raise RuntimeError(f"sla_fwd disagrees with its twin on the LM "
                           f"prefill plans: {fwd_rows}")
    return dec_rows, fwd_rows, res


# --------------------------------------------------------------------------
def _paged_operands(seed: int, kv_dtype, pos: int):
    """The paged kernel's operands at the Qwen3 decode shape
    (`kernels/cases.py`): 4 slots over a pool of PG_POOL pages (page 0 the
    zero page) sharing their first PG_SHARED / 64 pages, with distinct
    shuffled pages after them, every slot's live row at `pos`, NaN in the
    pages behind the padded LUT slots."""
    return cases.paged_decode_operands(
        seed, kv_dtype, pos, b=PG_SLOTS, hkv=8, g=2, d=128, bkv=64,
        tn=LM_MAX_LEN // 64, k_sel=26, npages=PG_POOL,
        shared=PG_SHARED // 64, device=DEV)


def _paged_bound(args, kw):
    """Kernel 4's convention on the paged operands: each (kv head, page)
    tile that a live slot selects read once (K and V tiles, the hblk and
    zblk tiles: no per-token partials), the totals, q, qp, the outputs,
    the integer operands and the page id of every live slot; operations
    4 bkv D + 2 D^2 per live slot plus 2 D^2 + 2 D per (bh)."""
    lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot, ztot = args
    bh, _, k_sel = lut.shape
    npages, hkv, bkv, d = k.shape
    b, tn = pt.shape
    live = torch.arange(k_sel, device=DEV) < torch.clamp(
        cnt, max=k_sel)[..., None]
    rows = torch.arange(bh, device=DEV)
    slot = (rows // (bh // b))[:, None, None]
    kvh = ((rows // kw["group"]) % hkv)[:, None, None]
    page = pt.long()[slot, lut.long().clamp(0, tn - 1)]
    tiles = int(torch.unique((kvh * npages + page)[live]).numel())
    slots = int(live.sum())
    nbytes = (tiles * (2 * bkv * d * k.element_size() + (d * d + d) * 4)
              + sum(t.numel() * 4 for t in (htot, ztot))
              + 4 * bh * d * 4 + slots * 4
              + sum(t.numel() * 4 for t in (lut, cnt, marg, posv)))
    flops = slots * (4 * bkv * d + 2 * d * d) + bh * (2 * d * d + 2 * d)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            tiles, slots)


def _paged_case(args, kw, what: str, reps: int = 50):
    """Kernel 5 against its twin, and bitwise against kernel 4 on the
    monolithic view of the same state at the same split width (the
    chosen one, 1 and 2): errors, exact zeros where marg = 0, finite
    outputs, two launches bitwise equal, device times, the bound."""
    want = sla_decode.sla_decode_paged_plain(*args, **kw)
    dense = cases.paged_dense_operands(args)

    def same_as_kernel4(width, got):
        mono = sla_decode.sla_decode(*dense, **kw, split_width=width)
        return (all(bool(torch.isfinite(x).all()) for x in got)
                and all(torch.equal(g, m) for g, m in zip(got, mono)))

    runs = _split_runs(sla_decode.sla_decode_paged, args, kw, args[5],
                       args[0], want, lambda got: got[1][args[3] == 0],
                       same_as_kernel4)
    for r in runs:
        r["rows"] = args[5].shape[0]
    mono_ms = cuda_graph_ms(lambda: sla_decode.sla_decode(*dense, **kw))
    eager_ms = cuda_ms(lambda: sla_decode.sla_decode_paged(*args, **kw),
                       reps)
    plain_ms = cuda_ms(lambda: sla_decode.sla_decode_paged_plain(
        *args, **kw), 5, warmup=1)
    bound_ms, bound_by, flops, nbytes, tiles, slots = _paged_bound(args, kw)
    row = _split_summary(runs, bound_ms)
    say(f"  {what}: {_runs_text(runs)} (limit {row['limit']:.3g}; finite, "
        f"marg-0 rows exact zeros and bitwise equal to sla_decode on the "
        f"monolithic view at each width: "
        f"{all(r['extra'] and r['zeros'] for r in runs)}) | sla_decode on "
        f"the view {mono_ms:.4f} ms | eager call {eager_ms:.4f} ms | bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, {tiles} "
        f"(kv head, page) tiles, {slots} live slots; "
        f"{row['bound_fraction']:.1%} of it) | plain twin {plain_ms:.3f} ms")
    del dense
    return dict(row, bitwise_vs_sla_decode=all(r["extra"] for r in runs),
                sla_decode_view_ms=mono_ms, eager_ms=eager_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                gflop=flops / 1e9, mbytes=nbytes / 1e6, tiles_read=tiles,
                live_slots=slots)


def phase_paged_vs_plain():
    """sla_decode_paged vs its twin (and vs sla_decode on the monolithic
    view) at the Qwen3 decode shape with a prefix-shared page table."""
    rows = []
    pos = 500 * 64 + 32  # row 500 of 512 (a slot's own page), mid-block
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        args, kw = _paged_operands(41, dtype, pos)
        say(f"[14 paged decode kernel] qwen3-1.7b paged decode shape (B "
            f"{PG_SLOTS}, BH=64, Hkv 8, D=128, bkv=64, Tn=512, K=26, pool "
            f"{PG_POOL} pages, {PG_SHARED // 64} shared + 32 own pages a "
            f"slot, pos {pos}, NaN pages behind the padded LUT slots) K/V "
            f"{dname}")
        row = _paged_case(args, kw, dname)
        rows.append(dict(shape="qwen3-1.7b paged decode B=4", dtype=dname,
                         pos=pos, **row))
        del args
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"paged decode kernel disagrees: {bad}")
    return rows


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor, for bitwise comparisons."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _pg_prompts(cfg):
    rs = np.random.default_rng(5)
    shared = rs.integers(0, cfg.vocab_size, PG_SHARED).astype(np.int32)
    own = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, PG_PROMPT - PG_SHARED).astype(np.int32)])
        for _ in range(5)]
    return own[:4] + [own[1].copy(), own[4]]  # request 4 repeats 1


def _paged_live_case(cfg, cache, layer: int, q, pos) -> dict:
    """Kernel 5 against its twin on a paged scheduler's own state: the
    live LUT rows of `layer` for the queries `q` (B, H, 1, D) at `pos`, at
    three split widths (two launches bitwise equal, bitwise equal to
    kernel 4 on the gathered view), with its CUDA-graph time, an eager
    call's, the twin's and the bound. Returns the row (`ok` its verdict)."""
    st, slap, sla = cache["sla"], cache["slap"], cfg.sla
    hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    b = q.shape[0]
    bh, k_sel = b * cfg.num_heads, st["live_lut"].shape[-1]
    qg = backend_lib._group_heads(q[:, :, 0].float(), hkv)
    qpg = backend_lib._group_heads(phi_lib.phi(q[:, :, 0], sla.phi), hkv)
    args = (st["live_lut"][layer].reshape(bh, 1, k_sel).contiguous(),
            cache["pt"], st["live_cnt"][layer].reshape(bh, 1).contiguous(),
            st["live_marg"][layer].reshape(bh, 1).contiguous(),
            pos.int().repeat_interleave(cfg.num_heads).contiguous(),
            qg.reshape(bh, 1, -1).contiguous(),
            qpg.float().reshape(bh, 1, -1).contiguous(),
            cache["kp"][layer], cache["vp"][layer], slap["hblk"][layer],
            slap["zblk"][layer],
            st["htot"][layer].reshape(b * hkv, *st["htot"].shape[3:]),
            st["ztot"][layer].reshape(b * hkv, -1))
    kw = dict(scale=cfg.head_dim ** -0.5, block_kv=sla.block_kv, group=g)
    want = sla_decode.sla_decode_paged_plain(*args, **kw)
    dense = cases.paged_dense_operands(args)

    def same_as_kernel4(width, got):
        mono = sla_decode.sla_decode(*dense, **kw, split_width=width)
        return all(torch.equal(g, m) for g, m in zip(got, mono))

    runs = _split_runs(sla_decode.sla_decode_paged, args, kw, args[5],
                       args[0], want, lambda got: got[1][args[3] == 0],
                       same_as_kernel4)
    for r in runs:
        r["rows"] = bh
    del dense
    eager_ms = cuda_ms(lambda: sla_decode.sla_decode_paged(*args, **kw), 50)
    plain_ms = cuda_ms(lambda: sla_decode.sla_decode_paged_plain(
        *args, **kw), 5, warmup=1)
    bound_ms, bound_by, _, nbytes, tiles, slots = _paged_bound(args, kw)
    split = _split_summary(runs, bound_ms)
    return dict(split, runs=runs,
                bitwise_vs_sla_decode=all(r["extra"] for r in runs),
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, mbytes=nbytes / 1e6, tiles_read=tiles,
                live_slots=slots)


def _pg_cross_check(cfg, sched, logits, res):
    """On the scheduler's own paged state mid-trace: decode_execute on the
    kernel vs the gather backend, kernel 5 vs its twin on the live LUTs of
    the first and last layer, and one full decode step's logits kernel vs
    gather from the same cache (restored afterwards, so the trace goes on
    as if nothing ran)."""
    cache = sched._live
    st, slap = cache["sla"], cache["slap"]
    sla = cfg.sla
    tn = cache["pt"].shape[1]
    dcfg = sla.decode_plan_cfg(tn)
    pos = cache["pos"] - 1  # the last token the state holds
    gen = torch.Generator(device=DEV).manual_seed(16)
    rows = []
    params = sched._cparams
    for layer in (0, cfg.num_layers - 1):
        state = {"k": cache["kp"][layer], "v": cache["vp"][layer],
                 "hblk": slap["hblk"][layer], "zblk": slap["zblk"][layer],
                 "htot": st["htot"][layer], "ztot": st["ztot"][layer],
                 "lut": st["live_lut"][layer], "cnt": st["live_cnt"][layer],
                 "marg": st["live_marg"][layer], "pt": cache["pt"]}
        q = torch.randn((PG_SLOTS, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device=DEV)
        proj = {"proj": params.layers[layer].sla_proj}
        with torch.no_grad():
            o_k = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="kernel")
            o_g = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="gather")
        err = float((o_k - o_g).abs().max())
        limit = TWIN_TOL * max(1.0, float(o_g.abs().max()))
        split = _paged_live_case(cfg, cache, layer, q, pos)
        runs = split.pop("runs")
        ok = err <= limit and split["ok"]
        say(f"[16 paged cross-check] layer {layer} at positions "
            f"{pos.tolist()}: decode_execute kernel vs gather max abs err "
            f"{err:.3g} (limit {limit:.3g}); sla_decode_paged vs twin, "
            f"bitwise equal to sla_decode on the gathered view at each "
            f"width {split['bitwise_vs_sla_decode']}: {_runs_text(runs)} "
            f"(limit {split['limit']:.3g}) {'OK' if ok else 'FAIL'} | eager "
            f"call {split['eager_ms']:.4f} ms | bound "
            f"{split['bound_ms']:.4f} ms by {split['bound_by']} "
            f"({split['mbytes']:.1f} MB, {split['tiles_read']} tiles, "
            f"{split['live_slots']} live slots; "
            f"{split['bound_fraction']:.1%} of it) | plain twin "
            f"{split['plain_ms']:.3f} ms")
        rows.append(dict(split, shape=f"qwen3-1.7b paged path layer {layer}",
                         dtype="bf16", pos=pos.tolist(), backend_err=err,
                         backend_limit=limit, ok=ok))
        del state
    if not all(r["ok"] for r in rows):
        raise RuntimeError(f"paged decode disagrees on the path's state: "
                           f"{rows}")
    token = logits.argmax(-1)
    snap = transformer.snapshot_slots(cache, range(PG_SLOTS))
    outs = {}
    with torch.no_grad():
        for backend in ("kernel", "gather"):
            outs[backend], _ = transformer.decode_step(
                params, cfg, token, cache, backend=backend,
                drift_threshold=sched.drift_threshold)
            transformer.restore_slots(cache, snap)
    del snap
    l_k, l_g = outs["kernel"], outs["gather"]
    diff = float((l_k - l_g).abs().max())
    limit = LM_LOGIT_TOL * max(1.0, float(l_g.abs().max()))
    agree = float((l_k.argmax(-1) == l_g.argmax(-1)).float().mean())
    ok = bool(torch.isfinite(l_k).all()) and diff <= limit
    say(f"[16 paged cross-check] one full decode step from the path's "
        f"paged cache, logits kernel vs gather max abs diff {diff:.3g} "
        f"(limit {limit:.3g}) {'OK' if ok else 'FAIL'} | greedy tokens "
        f"agree on {agree:.2f} of the slots")
    if not ok:
        raise RuntimeError("kernel and gather paged decode steps disagree")
    res.update(rows=rows, step_logit_diff=diff, step_logit_limit=limit,
               greedy_agreement=agree)


def _prefix_premise_probe(cfg, params, prompts):
    """The premise of prefix sharing, measured at `cfg`: the pages that
    two prompts share (their first PG_SHARED tokens) after two batch-1
    prefills as the scheduler runs them. Returns the elements that are not
    bitwise equal and their max abs difference, over every layer's K/V
    and h/z/kpool blocks of the shared pages."""
    nb = PG_SHARED // cfg.sla.block_kv
    caches = []
    cparams = transformer.compute_params(params)
    with torch.no_grad():
        for prompt in prompts[:2]:
            toks = torch.from_numpy(prompt[None]).long().to(DEV)
            caches.append(transformer.prefill(
                cparams, cfg, toks, backend="kernel",
                decode_max_len=LM_MAX_LEN)[1])
    a, b = caches
    bits, diff = 0, 0.0
    for layer in range(cfg.num_layers):
        pairs = [(a[key][layer, :, :, :PG_SHARED], b[key][layer, :, :,
                                                          :PG_SHARED])
                 for key in ("k", "v")]
        pairs += [(a["sla"][key][layer, :, :, :nb],
                   b["sla"][key][layer, :, :, :nb])
                  for key in transformer.PAGED_POOL_KEYS]
        for x, y in pairs:
            bits += int((_bits(x) != _bits(y)).sum())
            diff = max(diff, float((x.float() - y.float()).abs().max()))
    del caches, a, b, cparams
    torch.cuda.empty_cache()
    return bits, diff


def phase_paged_main(cfg, params, profile: bool):
    """The paged LM main path: the continuous Scheduler over a paged,
    prefix-shared KV cache on the kernel backend with decode-time SLA,
    6 requests of 32,000-token prompts through 4 slots. Checks the
    trace's counters, that every rewritten prefix page is bitwise what
    the pool held, and (phase 16) the kernel against the gather backend
    and its twin on the path's own state.

    Sharing a prompt page needs its contents to be a pure function of the
    tokens below its end. SLA's column-capacity demotion
    (`col_capacity_factor`, 2.0 by default) ranks a column's critical
    blocks over every query row, later rows included, so with it a
    shared page's K/V from layer 1 on can depend on the prompt's suffix:
    the probe measures that at the default. The trace runs the default
    config, which the paged Scheduler serves with the capacity lifted
    (None), where the premise holds and is checked bitwise."""
    from repro_torch.serving.api import SamplingParams, Scheduler
    prompts = _pg_prompts(cfg)
    torch.cuda.synchronize()
    t0 = time.time()
    probe_bits, probe_diff = _prefix_premise_probe(cfg, params, prompts)
    say(f"[15 paged lm main] prefix-sharing premise at the default "
        f"col_capacity_factor {cfg.sla.col_capacity_factor}: requests 0 and"
        f" 1's prefills hold {probe_bits} elements of their {PG_SHARED // 64}"
        f" shared pages that are not bitwise equal (max abs difference "
        f"{probe_diff:g}; {time.time() - t0:.1f}s); the paged Scheduler "
        f"lifts it to None")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.time()
    sched = Scheduler(cfg, params, num_slots=PG_SLOTS, max_len=LM_MAX_LEN,
                      backend="kernel", decode_sla=True,
                      prefill_bucket=PG_PROMPT, paged=True,
                      pool_pages=PG_POOL)
    torch.cuda.synchronize()
    t_build = time.time() - t_build
    if sched.cfg.sla.col_capacity_factor is not None:
        raise RuntimeError("the paged Scheduler kept the column capacity")
    cfg = sched.cfg
    bq = cfg.sla.block_q
    steps, prefills, hits = [0], [], []
    rewrite = dict(pages=0, max_diff=0.0, bits=0)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    cross, prof = {}, {}
    one, run_prefill = sched._one, sched._run_prefill
    claim, admit_paged = sched._claim_page, sched._admit_paged

    def done_with_boundaries():
        """>= 2 slots decoding and none of them crosses another block
        boundary before its budget ends."""
        active = sched._decoding()
        ph = sched._live["pos_host"]
        return len(active) >= 2 and all(
            (ph[j] + bq - 1) // bq * bq
            > sched._slot_base[j] + sched._slots[j].sampling.max_new_tokens
            - 2 for j in active)

    def one_hook(token):
        logits = one(token)
        steps[0] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        if profile and steps[0] == 64:  # 8 steps with 4 slots decoding
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as prof_ctx
            torch.cuda.synchronize()
            prof["ctx"] = prof_ctx(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
            prof["ctx"].__enter__()
            prof["t0"] = time.time()
        if profile and steps[0] == 72:
            torch.cuda.synchronize()
            prof["wall"] = time.time() - prof["t0"]
            prof["ctx"].__exit__(None, None, None)
        if not cross and done_with_boundaries():
            counts = (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES,
                      sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES)
            _pg_cross_check(cfg, sched, logits, cross)
            (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES,
             sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES) = counts  # not counted
            cross["step"] = steps[0]
        return logits

    def prefill_hook(toks):
        torch.cuda.synchronize()
        t0 = time.time()
        out = run_prefill(toks)
        torch.cuda.synchronize()
        prefills.append(time.time() - t0)
        return out

    def claim_hook(key):
        before = sched._pool.stats.prefix_hits
        pid = claim(key)
        hits.append(sched._pool.stats.prefix_hits > before)
        return pid

    def admit_hook(live, single, slot, pids):
        """Every interned page this admission rewrites must already hold
        bitwise what the new prefill computed for it."""
        idx = [i for i, hit in enumerate(hits) if hit]
        hits.clear()
        if idx:
            sel = torch.tensor(idx, device=DEV)
            pid = torch.tensor([pids[i] for i in idx], device=DEV)
            npp, hkv = len(pids), cfg.num_kv_heads
            for layer in range(cfg.num_layers):
                pairs = []
                for key, pool in (("k", live["kp"]), ("v", live["vp"])):
                    x = single[key][layer, 0, :, :npp * bq].reshape(
                        hkv, npp, bq, -1).movedim(0, 1)
                    pairs.append((x[sel], pool[layer, pid]))
                for key in transformer.PAGED_POOL_KEYS:
                    x = single["sla"][key][layer, 0, :, :npp].movedim(0, 1)
                    pairs.append((x[sel], live["slap"][key][layer, pid]))
                for new, old in pairs:
                    rewrite["max_diff"] = max(rewrite["max_diff"], float(
                        (new.float() - old.float()).abs().max()))
                    rewrite["bits"] += int((_bits(new) != _bits(old)).sum())
            rewrite["pages"] += len(idx)
        return admit_paged(live, single, slot, pids)

    sched._one, sched._run_prefill = one_hook, prefill_hook
    sched._claim_page, sched._admit_paged = claim_hook, admit_hook
    for i, (prompt, n) in enumerate(zip(prompts, PG_NEW)):
        sched.submit(prompt, SamplingParams(
            max_new_tokens=n, temperature=0.8 if i == PG_SAMPLED else 0.0,
            seed=3))
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    t0 = time.time()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_decode=sla_decode.LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sched.stats
    got = dict(steps=steps[0], **launches,
               prefix_full_hits=st.prefix_full_hits,
               prefix_hits=st.prefix_hits, prefix_misses=st.prefix_misses,
               cow_copies=st.cow_copies, page_allocs=st.page_allocs,
               decode_tokens=st.decode_tokens,
               slot_steps_total=st.slot_steps_total,
               decode_plan_builds=st.decode_plan_builds,
               decode_plan_extends=st.decode_plan_extends,
               decode_plan_decisions=st.decode_plan_replans
               + st.decode_plan_reuses)
    unshared = 1 + PG_SLOTS + PG_SLOTS * (LM_MAX_LEN // bq)
    say(f"[15 paged lm main] {len(done)} requests, {LM_ARCH} at full width "
        f"and depth ({cfg.num_layers} layers, bf16 compute), continuous "
        f"scheduler, {PG_SLOTS} slots, paged KV ({PG_POOL} pages of "
        f"{bq} tokens), max_len {LM_MAX_LEN}, kernel backend, decode-SLA, "
        f"in {wall:.2f}s (cache built in {t_build:.2f}s) | peak memory "
        f"{peak:.2f} GiB")
    say(f"  prefills {len(prefills)} (one per admission but the snapshot "
        f"hit): {[round(t, 3) for t in prefills]} s | decode "
        f"{st.decode_s:.3f}s for {steps[0]} steps = "
        f"{1e3 * st.decode_s / steps[0]:.2f} ms per step, "
        f"{1e3 * st.decode_s / st.decode_tokens:.2f} ms per generated token"
        f" | pages peak {st.pages_peak} (limit {PG_POOL}; {unshared} "
        f"without sharing), in use at the end {st.pages_in_use}")
    say(f"  prefix pages rewritten by admissions: {rewrite['pages']} "
        f"compared, max abs difference {rewrite['max_diff']:g}, "
        f"{rewrite['bits']} elements not bitwise equal | logits finite "
        f"{bool(finite)}")
    say(f"  counters {got}")
    say(f"  expected {PG_EXPECT}")
    for r in done:
        kind = ("snapshot hit" if r.rid == 4 else
                "sampled" if r.rid == PG_SAMPLED else "greedy")
        say(f"  request {r.rid} ({kind}): {len(r.tokens_out)} tokens, "
            f"queue {r.metrics.queue_s:.3f}s, TTFT {r.metrics.ttft_s:.3f}s, "
            f"latency {r.metrics.latency_s:.3f}s, first tokens "
            f"{r.tokens_out[:4]}")
    res = dict(wall_s=wall, cache_build_s=t_build, peak_gib=peak,
               prefill_s=prefills, decode_s=st.decode_s,
               ms_per_step=1e3 * st.decode_s / steps[0],
               ms_per_token=1e3 * st.decode_s / st.decode_tokens,
               ttft_s={r.rid: r.metrics.ttft_s for r in done},
               pages_peak=st.pages_peak, pages_unshared=unshared,
               rewritten_pages=rewrite["pages"],
               rewritten_max_diff=rewrite["max_diff"],
               rewritten_bit_mismatches=rewrite["bits"],
               default_capacity_probe=dict(bit_mismatches=probe_bits,
                                           max_abs_diff=probe_diff),
               counters=got,
               cross_check_step=cross.get("step"))
    if "ctx" in prof:
        events = prof["ctx"].key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        k5_us, k5_n = _decode_kernel_time(events)
        res["profile"] = dict(wall_s=prof["wall"], device_s=dev_us / 1e6,
                              busy=dev_us / 1e6 / prof["wall"],
                              kernel_s=k5_us / 1e6, kernel_launches=k5_n)
        say(f"[15 paged lm profile] 8 paged decode steps (4 slots): "
            f"{prof['wall']:.3f}s wall under the profiler, "
            f"{dev_us / 1e6:.3f}s device time, device busy "
            f"{dev_us / 1e6 / prof['wall']:.3f} | decode kernel "
            f"{res['profile']['kernel_launches']} launches, "
            f"{k5_us / 1e6:.4f}s")
        say(events.table(sort_by="self_cuda_time_total", row_limit=20))
    if [len(r.tokens_out) for r in done] != list(PG_NEW):
        raise RuntimeError("a paged LM request did not finish with its "
                           "tokens")
    if not bool(finite):
        raise RuntimeError("non-finite logits on the paged LM main path")
    if got != PG_EXPECT or len(prefills) != 5:
        raise RuntimeError(f"paged LM main path counters {got} (prefills "
                           f"{len(prefills)}); expected {PG_EXPECT} and 5")
    if st.pages_peak > PG_POOL:
        raise RuntimeError(f"pages peak {st.pages_peak} > {PG_POOL}")
    if (rewrite["pages"] != 4 * PG_SHARED // bq or rewrite["max_diff"] != 0
            or rewrite["bits"] != 0):
        raise RuntimeError(f"rewritten prefix pages {rewrite}: expected "
                           f"{4 * PG_SHARED // bq} pages, all bitwise equal")
    if not cross:
        raise RuntimeError("the paged cross-checks never ran")
    res["cross"] = {k: v for k, v in cross.items() if k != "rows"}
    return res, cross["rows"]


def _slot_leaves(cache: dict, j: int, prefix: str = ""):
    """Every tensor leaf of batch row j of a per-slot cache (plan fields
    included), as views: row j of the batch axis (1, or 0 for (B,))."""
    for key, val in cache.items():
        name = prefix + key
        if isinstance(val, dict):
            yield from _slot_leaves(val, j, name + ".")
        elif key == "plan":
            for leaf in plan_lib.PLAN_LEAVES:
                x = getattr(val, leaf)
                yield f"{name}.{leaf}", x[:, j]
        elif torch.is_tensor(val):
            yield name, val[j] if val.dim() == 1 else val[:, j]


def phase_unpaged_mixed(cfg, params):
    """The unpaged continuous Scheduler at full width with a masked mixed
    tick: one sampling request beside two greedy ones in 3 slots, so each
    greedy roll freezes the sampling slot and each sampling step freezes
    the greedy slots (the whole batch runs, the frozen slots' writes are
    put back). The second sampling step freezes a greedy slot at a block
    boundary that appends a plan row; every leaf of that slot must be
    bitwise as before the step."""
    from repro_torch.serving.api import SamplingParams, Scheduler
    prompts = _pg_prompts(cfg)[:3]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = Scheduler(cfg, params, num_slots=3, max_len=LM_MAX_LEN,
                      backend="kernel", decode_sla=True,
                      prefill_bucket=PG_PROMPT, paged=False)
    steps, finite, frozen = [0], torch.ones((), dtype=torch.bool,
                                            device=DEV), {}
    one, ctl_step = sched._one, sched._masked_ctl_step

    def one_hook(token):
        logits = one(token)
        steps[0] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        return logits

    def ctl_hook(ctl):
        frozen["calls"] = frozen.get("calls", 0) + 1
        if frozen["calls"] != 2:
            return ctl_step(ctl)
        j = next(i for i in sched._decoding() if i not in ctl)
        live, p = sched._live, int(sched._live["pos_host"][j])
        st = live["sla"]
        frozen.update(slot=j, pos=p, appends=bool(
            p % cfg.sla.block_q == 0
            and int(st["rows"][j]) < p // cfg.sla.block_q))
        before = {n: x.clone() for n, x in _slot_leaves(live, j)}
        cc = st["plan"].col_counts[:, j].clone()
        torch.cuda.synchronize()
        t0 = time.time()
        out = ctl_step(ctl)
        torch.cuda.synchronize()
        frozen["step_ms"] = 1e3 * (time.time() - t0)
        after = dict(_slot_leaves(live, j))
        frozen["differ"] = sorted(n for n, x in before.items()
                                  if not torch.equal(x, after[n]))
        frozen["leaves"] = len(before)
        frozen["gib"] = sum(x.numel() * x.element_size()
                            for x in before.values()) / 2**30
        del before
        return out

    sched._one, sched._masked_ctl_step = one_hook, ctl_hook
    for i, (prompt, n) in enumerate(zip(prompts, PU_NEW)):
        sched.submit(prompt, SamplingParams(
            max_new_tokens=n, temperature=0.8 if i == 0 else 0.0, seed=3))
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    t0 = time.time()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = sched.stats
    got = dict(steps=steps[0], **launches, decode_tokens=st.decode_tokens,
               slot_steps_total=st.slot_steps_total)
    say(f"[17 unpaged mixed] {len(done)} requests ({PU_NEW} new tokens, "
        f"request 0 sampling), {LM_ARCH} at full width and depth, "
        f"continuous scheduler, 3 slots, unpaged per-slot cache, max_len "
        f"{LM_MAX_LEN}, kernel backend, decode-SLA, in {wall:.2f}s | "
        f"prefill {st.prefill_s:.3f}s for 3 admissions | decode "
        f"{st.decode_s:.3f}s for {steps[0]} steps = "
        f"{1e3 * st.decode_s / steps[0]:.2f} ms per step | peak memory "
        f"{peak:.2f} GiB")
    say(f"  masked sampling step with greedy slot {frozen.get('slot')} "
        f"frozen at position {frozen.get('pos')} (appends a plan row "
        f"{frozen.get('appends')}): {frozen.get('step_ms', 0):.2f} ms; "
        f"{frozen.get('leaves')} leaves ({frozen.get('gib', 0):.2f} GiB) of "
        f"the frozen slot compared, not bitwise equal: "
        f"{frozen.get('differ')} | logits finite {bool(finite)}")
    say(f"  counters {got}")
    say(f"  expected {PU_EXPECT}")
    res = dict(wall_s=wall, peak_gib=peak, prefill_s=st.prefill_s,
               decode_s=st.decode_s,
               ms_per_step=1e3 * st.decode_s / steps[0],
               masked_step_ms=frozen.get("step_ms"), counters=got,
               frozen_slot_pos=frozen.get("pos"),
               frozen_slot_appends=frozen.get("appends"),
               frozen_leaves_differ=frozen.get("differ"))
    counts = [len(r.tokens_out) for r in done]
    del sched, done
    torch.cuda.empty_cache()
    if counts != list(PU_NEW):
        raise RuntimeError(f"unpaged mixed requests finished with {counts} "
                           f"tokens, expected {PU_NEW}")
    if not bool(finite):
        raise RuntimeError("non-finite logits on the unpaged mixed path")
    if got != PU_EXPECT:
        raise RuntimeError(f"unpaged mixed counters {got}; expected "
                           f"{PU_EXPECT}")
    if not frozen.get("appends") or frozen.get("differ") != []:
        raise RuntimeError(f"the frozen slot at an appending boundary was "
                           f"not put back bitwise: {frozen}")
    return res


# --------------------------------------------------------------------------
def _pc_prompts(cfg):
    """Phase 18's prompts: r0 and r1 unrelated, r2 r1's first PC_SHARED
    tokens and its own last chunk, r3 a repeat of r0."""
    rs = np.random.default_rng(18)
    r0, r1 = (rs.integers(0, cfg.vocab_size, PG_PROMPT).astype(np.int32)
              for _ in range(2))
    r2 = np.concatenate([r1[:PC_SHARED], rs.integers(
        0, cfg.vocab_size, PG_PROMPT - PC_SHARED).astype(np.int32)])
    return [r0, r1, r2, r0.copy()]


def _pc_run(cfg, params, chunk, capture: bool):
    """One run of phase 18's trace through the paged Scheduler, blocking
    (`chunk` None) or chunked. Hooks time each prefill chunk and dispatch,
    check every rewritten prefix page against the pool (as phase 15),
    record the prefix resumes and page claims, copy r0's K/V after its 4th
    token to the host, and (`capture`) keep kernel 1's operands of r1's
    last chunk at the first and last layer."""
    from repro_torch.serving.api import SamplingParams, Scheduler
    gc.collect()  # an earlier run's scheduler, held in cycles by its hooks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = Scheduler(cfg, params, num_slots=PG_SLOTS, max_len=LM_MAX_LEN,
                      backend="kernel", decode_sla=True,
                      prefill_bucket=PG_PROMPT, paged=True,
                      pool_pages=PC_POOL, prefill_chunk_blocks=chunk)
    cfg = sched.cfg
    bq, nl = cfg.sla.block_q, cfg.num_layers
    rec = dict(steps=0, chunks=[], dispatches=[], completions=[],
               resumes=[], claims=[], kv0=None, rows={}, admission={},
               gaps=[], capture=None)
    rewrite = dict(pages=0, max_diff=0.0, bits=0)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    hits = []
    one, claim, admit_paged = sched._one, sched._claim_page, \
        sched._admit_paged
    pf_chunk, carry_get = sched._pf.chunk, sched._pf.carry_get
    advance, complete, dispatch = (sched._advance_job, sched._complete_job,
                                   sched._dispatch_paged)
    claim_job = sched._claim_job_pages
    rows_fn, layer_no, cur = ops.sla_attention_rows, [0], {}

    def one_hook(token):
        logits = one(token)
        rec["steps"] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        return logits

    def timed(fn, out, rid):
        """fn timed with the stream synchronized; the seconds go to the
        list `out` and to the admission of request rid()."""
        def hook(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append(time.time() - t0)
            key = rid(*a)
            rec["admission"][key] = rec["admission"].get(key, 0.0) + out[-1]
            return res
        return hook

    def advance_hook(slot, events):
        job = sched._job_by_slot[slot]
        cur.update(rid=job.r.rid, chunk=job.next_chunk)
        layer_no[0] = 0
        return advance(slot, events)

    chunk_timed = timed(pf_chunk, rec["chunks"], lambda *a: cur["rid"])

    def chunk_hook(span, carry, start):
        out = chunk_timed(span, carry, start)
        rec["chunks"][-1] = (cur["rid"], start, rec["chunks"][-1])
        return out

    def rows_hook(*a, **kw):
        li = layer_no[0]
        layer_no[0] += 1
        if (capture and cur.get("rid") == 1 and cur.get("chunk") == 3
                and li in (0, nl - 1)):
            rec["rows"][li] = (a, kw)
        return rows_fn(*a, **kw)

    def carry_get_hook(key):
        snap = carry_get(key)
        if snap is not None:
            rec["resumes"].append((cur.get("admit"), len(key[1]) // 4))
        return snap

    def claim_job_hook(job, lo, hi):
        before = sched._pool.stats.prefix_hits
        claim_job(job, lo, hi)
        rec["claims"].append((job.r.rid, lo, hi,
                              sched._pool.stats.prefix_hits - before))

    def claim_hook(key):
        before = sched._pool.stats.prefix_hits
        pid = claim(key)
        hits.append(sched._pool.stats.prefix_hits > before)
        return pid

    def admit_hook(live, single, slot, pids):
        idx = [i for i, hit in enumerate(hits) if hit]
        hits.clear()
        if idx:
            sel = torch.tensor(idx, device=DEV)
            pid = torch.tensor([pids[i] for i in idx], device=DEV)
            npp, hkv = len(pids), cfg.num_kv_heads
            for layer in range(nl):
                pairs = []
                for key, pool in (("k", live["kp"]), ("v", live["vp"])):
                    x = single[key][layer, 0, :, :npp * bq].reshape(
                        hkv, npp, bq, -1).movedim(0, 1)
                    pairs.append((x[sel], pool[layer, pid]))
                for key in transformer.PAGED_POOL_KEYS:
                    x = single["sla"][key][layer, 0, :, :npp].movedim(0, 1)
                    pairs.append((x[sel], live["slap"][key][layer, pid]))
                for new, old in pairs:
                    rewrite["max_diff"] = max(rewrite["max_diff"], float(
                        (new.float() - old.float()).abs().max()))
                    rewrite["bits"] += int((_bits(new) != _bits(old)).sum())
            rewrite["pages"] += len(idx)
        return admit_paged(live, single, slot, pids)

    admit_next, note_gap = sched._admit_next, sched._note_gap

    def gap_hook(now):
        if sched._last_token_t is not None:
            rec["gaps"].append(now - sched._last_token_t)
        note_gap(now)

    sched._note_gap = gap_hook

    def admit_hook_next(slot, events):
        cur["admit"] = sched._queue[0].rid
        return admit_next(slot, events)

    sched._one, sched._claim_page, sched._admit_paged = one_hook, \
        claim_hook, admit_hook
    sched._pf.chunk, sched._pf.carry_get = chunk_hook, carry_get_hook
    sched._advance_job, sched._claim_job_pages = advance_hook, claim_job_hook
    sched._admit_next = admit_hook_next
    sched._complete_job = timed(complete, rec["completions"],
                                lambda slot, job, ev: job.r.rid)
    sched._dispatch_paged = timed(dispatch, rec["dispatches"],
                                  lambda *a: cur["admit"])
    prompts = _pc_prompts(cfg)
    events = []

    def tick():
        """One step(); once r0 has emitted 4 tokens, its K/V (positions
        before its 4th token) go to the host between two ticks, with the
        scheduler's clocks (the gap's last emission, the submit times of
        requests still waiting for a first token) moved past the copy."""
        events.extend(sched.step())
        r0 = sched._requests[0]
        if rec["kv0"] is None and len(r0.tokens_out) == 4:
            torch.cuda.synchronize()
            t0 = time.time()
            pt = sched._live["pt"][r0.slot:r0.slot + 1]
            rec["kv0"] = {key: [transformer._page_gather_kv(
                sched._live[key][li], pt)[0, :, :PG_PROMPT + 3].cpu()
                for li in range(nl)] for key in ("kp", "vp")}
            dt = time.time() - t0
            rec["capture"] = (len(rec["gaps"]), dt)
            sched._last_token_t += dt
            for r in sched._requests:
                if not r.tokens_out:
                    r.metrics.submit_t += dt

    def until_first(rid):
        r = sched._requests[rid]
        while not r.tokens_out:
            tick()

    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    ops.sla_attention_rows = rows_hook
    t0 = time.time()
    try:
        for rid, prompt in enumerate(prompts):
            sched.submit(prompt, SamplingParams(max_new_tokens=PC_NEW[rid]))
            if rid < 2:
                until_first(rid)
        while sched.has_work:  # one token a tick: the gaps are the stalls
            tick()
        done = list(sched._requests)
        torch.cuda.synchronize()
    finally:
        ops.sla_attention_rows = rows_fn
    wall = time.time() - t0
    st = sched.stats
    start1 = next(i for i, e in enumerate(events)
                  if e.rid == 1 and e.kind == "start")
    tok1 = next(i for i, e in enumerate(events)
                if e.rid == 1 and e.kind == "token")
    res = dict(
        wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        steps=rec["steps"], finite=bool(finite),
        tokens=[list(r.tokens_out) for r in done],
        ttft_s=[r.metrics.ttft_s for r in done],
        chunk_s=[c[2] for c in rec["chunks"]], chunks=rec["chunks"],
        dispatch_s=rec["dispatches"], completion_s=rec["completions"],
        resumes=rec["resumes"], claims=rec["claims"],
        r0_between=sum(1 for e in events[start1:tok1]
                       if e.rid == 0 and e.kind == "token"),
        max_decode_gap_s=st.max_decode_gap_s, rewrite=rewrite,
        counters=dict(chunked_admissions=st.chunked_admissions,
                      prefill_chunks=st.prefill_chunks,
                      prefill_tokens=st.prefill_tokens,
                      prefix_full_hits=st.prefix_full_hits,
                      prefix_hits=st.prefix_hits,
                      pages_peak=st.pages_peak,
                      sla_fwd=sla_fwd.LAUNCHES,
                      tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                      sla_decode_paged=sla_decode.PAGED_LAUNCHES),
        gaps_top=sorted(((g, i) for i, g in enumerate(rec["gaps"])),
                        reverse=True)[:4], capture=rec["capture"],
        carry_bytes=sched._pf.carry_bytes(),
        carry_snapshots=len(sched._pf._carry_snaps),
        kv0=rec["kv0"], rows=rec["rows"],
        # per admission: its chunks and completion, or its dispatch
        admission_s=rec["admission"])
    del sched, done
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _chunk_fwd_rows(captured: dict, what: str, tag: str) -> list:
    """Kernel 1 against its twin on a prefill chunk's own operands, as
    `sla_attention_rows` received them (`captured`: layer -> (args, kw)),
    by `cases.tc_criterion` with two launches bitwise equal; with its
    CUDA-event time, the twin's and the bound. Returns one row a layer."""
    rows = []
    for li, (a, kw) in sorted(captured.items()):
        q, k, v, qp, kp, marginal, lut, counts, pcfg = a[:9]
        base = kw["row_offset"]
        fq, fk, fv, fqp, fkp = map(ops._flat, (q, k, v, qp, kp))
        fa, flut, fcounts = map(ops._flat, (marginal, lut, counts))
        hb, zb = ops._hz_blocks(fkp, fv, pcfg.block_kv)
        hi, zi = ops._aggregate(fa, hb, zb)
        del hb, zb
        args = (flut, fcounts, fq, fk, fv, fqp, hi, zi)
        fkw = dict(scale=q.shape[-1] ** -0.5, causal=True,
                   block_q=pcfg.block_q, block_kv=pcfg.block_kv, base=base)
        c = _fwd_check(args, fkw, f"lm prefill chunk layer {li}")
        ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **fkw), 10)
        plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **fkw), 2,
                           warmup=1)
        bound_ms, bound_by, _, nbytes, live = _bound(args, fkw)
        say(f"[{tag}] sla_fwd on {what}, layer {li}: base {base}, "
            f"{fq.shape[1] // pcfg.block_q} query blocks against "
            f"{fk.shape[1] // pcfg.block_kv} KV blocks, causal, bf16, K/V "
            f"repeated (BH={fq.shape[0]}, BH_kv={fk.shape[0]}, "
            f"K={flut.shape[-1]}, live tiles {live} of {flut.numel()}): "
            f"{_fwd_text(c)} | kernel {ms:.3f} ms | bound {bound_ms:.3f} ms "
            f"by {bound_by} ({nbytes / 1e6:.0f} MB; {bound_ms / ms:.1%} of "
            f"it) | plain twin {plain_ms:.2f} ms")
        rows.append(dict(shape=f"qwen3-1.7b prefill chunk layer {li} "
                               f"(base {base})", dtype="bf16", base=base,
                         live_tiles=live, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_fraction=bound_ms / ms, **c))
        del args, hi, zi
    return rows


def phase_chunked_admission(cfg, params):
    """Phase 18: chunked admission prefill on the paged continuous
    Scheduler at full Qwen3-1.7B width, blocking then chunked, stepped
    one decode token a tick to the end (so `max_decode_gap_s` is the
    longest stall a tick's admission work causes); checks the
    chunked run's counters, resumes and interleave, the rewritten prefix
    pages, r0's mid-decode K/V against the blocking run, and kernel 1 on
    r1's last chunk against its twin. Returns (summary, fwd rows)."""
    runs = {}
    for name, chunk in (("blocking", None), ("chunked", PC_CHUNK_BLOCKS)):
        runs[name] = _pc_run(cfg, params, chunk, capture=chunk is not None)
        r = runs[name]
        say(f"[18 chunked admission] {name}: {LM_ARCH}, paged Scheduler, "
            f"{PG_SLOTS} slots, {PC_POOL} pages, bucket {PG_PROMPT}, "
            f"chunks of {PC_CHUNK_BLOCKS} blocks" if chunk else
            f"[18 chunked admission] {name}: {LM_ARCH}, paged Scheduler, "
            f"{PG_SLOTS} slots, {PC_POOL} pages, bucket {PG_PROMPT}, "
            f"blocking admission")
        say(f"  {r['wall_s']:.2f}s, {r['steps']} decode steps, peak memory "
            f"{r['peak_gib']:.2f} GiB | max_decode_gap_s "
            f"{r['max_decode_gap_s']:.4f} (largest gaps (s, emission): "
            f"{[(round(g, 4), i) for g, i in r['gaps_top']]}; r0's K/V copied"
            f" after emission {r['capture'][0]} in {r['capture'][1]:.3f}s, "
            f"outside the clocks) | TTFT "
            f"{[round(t, 3) for t in r['ttft_s']]} s | prefill per chunk "
            f"{[round(t, 4) for t in r['chunk_s']]} s, per admission "
            f"{ {k: round(v, 4) for k, v in r['admission_s'].items()} } s | "
            f"completions {[round(t, 4) for t in r['completion_s']]} s")
        say(f"  counters {r['counters']} | resumes (rid, tokens) "
            f"{r['resumes']} | claims (rid, lo, hi, hits) {r['claims']} | "
            f"r0 tokens between r1's start and first token "
            f"{r['r0_between']} | rewritten prefix pages {r['rewrite']} | "
            f"carry snapshots {r['carry_snapshots']} holding "
            f"{r['carry_bytes']} bytes | logits finite {r['finite']}")
    blk, chk = runs["blocking"], runs["chunked"]
    agree = [sum(a == b for a, b in zip(x, y)) / max(1, len(y))
             for x, y in zip(chk["tokens"], blk["tokens"])]
    kv = dict(elements=0, differ=0, max_diff=0.0, limit=0.0)
    if chk["kv0"] is None or blk["kv0"] is None:
        raise RuntimeError("r0's K/V were not captured after 4 tokens")
    for key in ("kp", "vp"):
        for li in range(cfg.num_layers):
            x = chk["kv0"][key][li].to(DEV).float()
            y = blk["kv0"][key][li].to(DEV).float()
            kv["elements"] += x.numel()
            kv["differ"] += int((x != y).sum())
            kv["max_diff"] = max(kv["max_diff"], float((x - y).abs().max()))
            kv["limit"] = max(kv["limit"], LM_LOGIT_TOL * max(
                1.0, float(y.abs().max())))
    say(f"[18 chunked admission] chunked vs blocking: max_decode_gap_s "
        f"{chk['max_decode_gap_s']:.4f} vs {blk['max_decode_gap_s']:.4f} | "
        f"TTFT {[round(t, 3) for t in chk['ttft_s']]} vs "
        f"{[round(t, 3) for t in blk['ttft_s']]} s | greedy agreement per "
        f"request {[round(a, 3) for a in agree]} | r0's K/V after 4 tokens "
        f"(positions < {PG_PROMPT + 3}): {kv['differ']} of {kv['elements']} "
        f"elements differ, max abs diff {kv['max_diff']:.4g} (limit "
        f"{kv['limit']:.4g}) | peak {chk['peak_gib']:.2f} vs "
        f"{blk['peak_gib']:.2f} GiB | snapshots hold {chk['carry_bytes']} "
        f"bytes")
    # kernel 1 against its twin on r1's last chunk (base 375, 125 query
    # blocks against the 500-block bucket, K/V repeated as the path gives
    # them); the check's launches come after the run's counts
    rows = _chunk_fwd_rows(chk["rows"], "r1's last chunk",
                           "18 chunk kernel")
    del chk["rows"], chk["kv0"], blk["kv0"]
    torch.cuda.empty_cache()
    cc = chk["counters"]
    want = dict(PC_EXPECT)
    got = {key: cc[key] for key in want}
    summary = dict(
        max_decode_gap_s=dict(chunked=chk["max_decode_gap_s"],
                              blocking=blk["max_decode_gap_s"]),
        ttft_s=dict(chunked=chk["ttft_s"], blocking=blk["ttft_s"]),
        chunk_s=chk["chunk_s"], admission_s=dict(
            chunked=chk["admission_s"], blocking=blk["admission_s"]),
        completion_s=chk["completion_s"], greedy_agreement=agree,
        r0_kv=kv, carry_bytes=chk["carry_bytes"],
        peak_gib=dict(chunked=chk["peak_gib"], blocking=blk["peak_gib"]),
        wall_s=dict(chunked=chk["wall_s"], blocking=blk["wall_s"]),
        counters=cc, blocking_counters=blk["counters"],
        resumes=chk["resumes"], r0_between=chk["r0_between"],
        rewrite=chk["rewrite"], blocking_rewrite=blk["rewrite"])
    bad = []
    if [len(t) for t in chk["tokens"]] != list(PC_NEW) or \
            [len(t) for t in blk["tokens"]] != list(PC_NEW):
        bad.append("a request did not finish with its tokens")
    if not (chk["finite"] and blk["finite"]):
        bad.append("non-finite logits")
    if got != want:
        bad.append(f"chunked counters {got}, expected {want}")
    for name, r in (("chunked", chk), ("blocking", blk)):
        n = r["counters"]["sla_decode_paged"]
        if n != cfg.num_layers * r["steps"]:
            bad.append(f"{name}: {n} sla_decode_paged launches in "
                       f"{r['steps']} decode steps")
    if blk["counters"]["sla_fwd"] != 3 * cfg.num_layers or \
            blk["counters"]["prefix_full_hits"] != 1:
        bad.append(f"blocking counters {blk['counters']}")
    shared_pages = PC_SHARED // cfg.sla.block_q
    if chk["resumes"] != [(2, PC_SHARED)] or \
            (2, 0, PC_SHARED, shared_pages) not in chk["claims"]:
        bad.append(f"r2 did not resume at {PC_SHARED} with {shared_pages} "
                   f"shared pages: {chk['resumes']} {chk['claims']}")
    if any(c[0] == 3 for c in chk["chunks"]) or len(chk["dispatch_s"]):
        bad.append("r3 (a full-prompt repeat) made a dispatch")
    if chk["r0_between"] < 3:
        bad.append(f"r0 emitted {chk['r0_between']} tokens during r1's "
                   "chunked admission, fewer than 3")
    for name, r in (("chunked", chk), ("blocking", blk)):
        rw = r["rewrite"]
        if rw["pages"] != shared_pages or rw["bits"] or rw["max_diff"]:
            bad.append(f"{name} rewritten prefix pages {rw}: expected "
                       f"{shared_pages}, all bitwise equal")
    if kv["max_diff"] > kv["limit"]:
        bad.append(f"r0's mid-decode K/V chunked vs blocking {kv}")
    if len(rows) != 2 or not all(r["ok"] for r in rows):
        bad.append(f"sla_fwd on the chunk rows {rows}")
    if bad:
        raise RuntimeError("chunked admission phase failed: "
                           + "; ".join(bad))
    return summary, rows


def _clone_cache(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_cache(v) for k, v in x.items()}
    if isinstance(x, plan_lib.SLAPlan):
        return plan_lib.plan_map(torch.clone, x)
    return x


def _cache_diffs(a: dict, b: dict, nl: int) -> dict:
    """Float leaves of two static decode caches: the max abs difference
    and the limit 5e-2 x max(1, max |b|) (layer by layer, so no
    whole-cache temporary); integer leaves: the count of entries (plan:
    blocks) that differ."""
    out = {}
    floats = [("k", a["k"], b["k"]), ("v", a["v"], b["v"])]
    sa, sb = a["sla"], b["sla"]
    floats += [(key, sa[key], sb[key]) for key in
               ("hblk", "zblk", "htot", "ztot", "kpool", "qpool")]
    for name, x, y in floats:
        diff = ref = 0.0
        for li in range(nl):
            diff = max(diff, float((x[li].float() - y[li].float())
                                   .abs().max()))
            ref = max(ref, float(y[li].float().abs().max()))
        out[name] = dict(max_diff=diff, limit=LM_LOGIT_TOL * max(1.0, ref))
    ints = [(f"plan.{n}", getattr(sa["plan"], n), getattr(sb["plan"], n))
            for n in plan_lib.PLAN_LEAVES]
    ints += [(key, sa[key], sb[key]) for key in
             ("live_lut", "live_cnt", "live_marg", "extends", "replans",
              "reuses")]
    for name, x, y in ints:
        out[name] = dict(differ=int((x != y).sum()))
    out["rows"] = dict(differ=int(sa["rows"] != sb["rows"]))
    return out


def phase_decode_chunk(cfg, params):
    """Phase 19: verify-style `decode_chunk` (C = 16, twice) from a static
    decode-SLA state of 2 x 32,000-token prompts, beside 32 `decode_step`s
    from a clone of it; checks and times kernel 4 on the chunk's own
    per-token state. Returns (summary, decode rows)."""
    rs = np.random.default_rng(19)
    gc.collect()
    cparams = transformer.compute_params(params)
    toks = torch.from_numpy(rs.integers(0, cfg.vocab_size, (
        LM_BATCH, PG_PROMPT))).to(DEV)
    fed = torch.from_numpy(rs.integers(0, cfg.vocab_size, (
        LM_BATCH, 2 * DC_C))).to(DEV)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _, cache = transformer.prefill(cparams, cfg, toks, backend="kernel",
                                       decode_max_len=LM_MAX_LEN)
    del toks
    steps = _clone_cache(cache)
    state_gib = sum(t.numel() * t.element_size() for t in
                    _tensors(cache)) / 2**30
    nl, hkv = cfg.num_layers, cfg.num_kv_heads
    caught, calls = {}, [0]
    execute_chunk = backend_lib.decode_execute_chunk

    def chunk_hook(state, params_, q, pos, dcfg, **kw):
        li = calls[0] % nl
        if calls[0] < nl and li in (0, nl - 1):  # the first chunk's
            caught[li] = ({k: v.clone() for k, v in state.items()},
                          params_, q.clone(), pos, dcfg)
        calls[0] += 1
        return execute_chunk(state, params_, q, pos, dcfg, **kw)

    sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
    launches, walls, logits = [], [], []
    backend_lib.decode_execute_chunk = chunk_hook
    try:
        for i in range(2):
            before = sla_decode.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.time()
            lg, cache = transformer.decode_chunk(
                cparams, cfg, fed[:, i * DC_C:(i + 1) * DC_C], cache,
                backend="kernel")
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            launches.append(sla_decode.LAUNCHES - before)
            logits.append(lg)
    finally:
        backend_lib.decode_execute_chunk = execute_chunk
    paged_launches = sla_decode.PAGED_LAUNCHES
    step_logits, step_walls = [], []
    with torch.no_grad():
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            for c in range(i * DC_C, (i + 1) * DC_C):
                lg, steps = transformer.decode_step(
                    cparams, cfg, fed[:, c], steps, backend="kernel")
                step_logits.append(lg)
            torch.cuda.synchronize()
            step_walls.append(time.time() - t0)
    lc = torch.cat(logits, dim=1)
    ls = torch.stack(step_logits, dim=1)
    diff = float((lc - ls).abs().max())
    limit = LM_LOGIT_TOL * max(1.0, float(ls.abs().max()))
    agree = float((lc.argmax(-1) == ls.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(lc).all())
    leaves = _cache_diffs(cache, steps, nl)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[19 decode_chunk] {LM_ARCH} static decode-SLA state of "
        f"{LM_BATCH} x {PG_PROMPT}-token prompts (max_len {LM_MAX_LEN}, "
        f"{state_gib:.2f} GiB, one clone kept), kernel backend, bf16: 2 "
        f"decode_chunk calls of C={DC_C} from {PG_PROMPT} vs {2 * DC_C} "
        f"decode_steps | logits max abs diff {diff:.4g} (limit "
        f"{limit:.4g}), greedy agreement {agree:.3f}, finite {finite} | "
        f"sla_decode launches per chunk {launches} | wall per chunk "
        f"{[round(w, 4) for w in walls]} s (the first with the state "
        f"copies of the checks) vs 16 steps {[round(w, 4) for w in step_walls]}"
        f" s | peak {peak:.2f} GiB")
    say(f"  cache leaves, chunks vs steps: {leaves}")
    # the chunk's own per-token state at the first and last layer; the
    # backends compared on f32 queries (the path's are bf16, and its
    # output is rounded to them), as phase 13 compares decode_execute
    rows, backend_errs = [], {}
    g = cfg.num_heads // hkv
    for li, (state, proj, q, pos, dcfg) in sorted(caught.items()):
        with torch.no_grad():
            o_k = backend_lib.decode_execute_chunk(state, proj, q.float(),
                                                   pos, dcfg,
                                                   backend="kernel")
            o_g = backend_lib.decode_execute_chunk(state, proj, q.float(),
                                                   pos, dcfg,
                                                   backend="gather")
        err = float((o_k - o_g).abs().max())
        lim = TWIN_TOL * max(1.0, float(o_g.abs().max()))
        backend_errs[li] = dict(err=err, limit=lim)
        qg = backend_lib._group_heads(q.float(), hkv)
        qpg = backend_lib._group_heads(phi_lib.phi(q, cfg.sla.phi), hkv)
        flat = sla_decode._flat_args(
            *sla_decode.decode_operands(state, qg, qpg, pos),
            cfg.sla.block_kv)
        kw = dict(scale=cfg.head_dim ** -0.5, block_kv=cfg.sla.block_kv,
                  group=g)
        say(f"[19 decode_chunk kernel] layer {li} at pos {pos}, C={DC_C}, "
            f"per-token rows: decode_execute_chunk kernel vs gather max abs "
            f"err {err:.3g} (limit {lim:.3g}) "
            f"{'OK' if err <= lim else 'FAIL'}")
        row = _decode_case(flat, kw, f"sla_decode vs twin on layer {li}'s "
                           f"decode_chunk rows (K/V bf16)")
        row["ok"] = row["ok"] and err <= lim
        rows.append(dict(shape=f"qwen3-1.7b decode_chunk C={DC_C} layer "
                               f"{li}", dtype="bf16", c=DC_C, pos=pos,
                         backend_err=err, backend_limit=lim, **row))
        del flat, state
    del cache, steps, caught, cparams
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(state_gib=state_gib, launches=launches,
                   chunk_wall_s=walls, steps16_wall_s=step_walls,
                   logit_diff=diff, logit_limit=limit,
                   greedy_agreement=agree, peak_gib=peak,
                   leaves=leaves, backend_errs=backend_errs)
    bad = []
    if not finite or diff > limit:
        bad.append(f"logits chunk vs steps {diff} (limit {limit})")
    if launches != [nl, nl] or paged_launches:
        bad.append(f"sla_decode launches {launches} (paged "
                   f"{paged_launches}), expected {nl} a chunk")
    bad += [f"{name} {v}" for name, v in leaves.items()
            if "max_diff" in v and v["max_diff"] > v["limit"]]
    if len(rows) != 2 or not all(r["ok"] for r in rows):
        bad.append(f"sla_decode on the chunk rows {rows}")
    if bad:
        raise RuntimeError("decode_chunk phase failed: " + "; ".join(bad))
    return summary, rows


# --------------------------------------------------------------------------
class TickClock:
    """A virtual clock for the watchdog (tests/test_disagg.py's): every
    call advances 0.5 s, so each measured decode tick spans 0.5 s and
    only a straggle factor makes one slow."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _dg_prompts(cfg):
    """Phase 20's prompts: DG_LENS tokens from a seeded rng, r4 r0's first
    DG_SHARED tokens followed by its own."""
    rs = np.random.default_rng(20)
    ps = [rs.integers(0, cfg.vocab_size, n).astype(np.int32)
          for n in DG_LENS]
    ps[4] = np.concatenate([ps[0][:DG_SHARED], ps[4][DG_SHARED:]])
    return ps


def _bundle_bytes(bundle) -> dict:
    """A handoff bundle's device bytes: K/V rows, the per-block h
    partials and the rest (z / kpool partials, totals, plan rows, LUTs)."""
    c = bundle.cache
    kv = sum(c[k].numel() * c[k].element_size() for k in ("k", "v"))
    h = c["sla"]["hblk"]
    hblk = h.numel() * h.element_size()
    total = sum(t.numel() * t.element_size() for t in _tensors(c))
    return dict(kv=kv, hblk=hblk, rest=total - kv - hblk, total=total)


def _host_bits(x: torch.Tensor) -> torch.Tensor:
    """A host copy whose equality is bitwise (floats as raw bits)."""
    x = x.detach().contiguous()
    if x.is_floating_point():
        x = _bits(x)
    return x.to("cpu", copy=True)


def _slot_capture(sched, slot: int, npages: int) -> dict:
    """Host copies of a paged slot's state (position, decode-SLA per-slot
    leaves) and of the contents of its first `npages` pages in every pool,
    keyed by name: what a replayed admission must reproduce bitwise while
    the page ids differ."""
    live = sched._live
    out = {name: _host_bits(x) for name, x in _slot_leaves(
        {"pos": live["pos"], "sla": live["sla"]}, slot)}
    pid = torch.tensor(sched._slot_pids[slot][:npages], device=DEV)
    for key in ("kp", "vp"):
        out[f"pages.{key}"] = _host_bits(live[key][:, pid])
    for key, pool in live["slap"].items():
        out[f"pages.{key}"] = _host_bits(pool[:, pid])
    return out


def _dg_counts():
    return dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                sla_decode=sla_decode.LAUNCHES)


def _dg_set_counts(c):
    sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES = c["sla_fwd"], c["tc_sla_fwd"]
    sla_decode.PAGED_LAUNCHES = c["sla_decode_paged"]
    sla_decode.LAUNCHES = c["sla_decode"]


def _dg_baseline(cfg, params) -> dict:
    """Run 1: the port's paged single Scheduler on the trace, blocking."""
    from repro_torch.serving.api import SamplingParams, Scheduler
    sched = Scheduler(cfg, params, num_slots=DG_SLOTS, max_len=DG_MAX_LEN,
                      backend="kernel", decode_sla=True,
                      prefill_bucket=DG_BUCKET, paged=True)
    prompts = _dg_prompts(cfg)
    _dg_set_counts(dict.fromkeys(_dg_counts(), 0))
    torch.cuda.synchronize()
    t0 = time.time()
    for p, n in zip(prompts[:4], DG_NEW[:4]):
        sched.submit(p, SamplingParams(max_new_tokens=n))
    for _ in range(DG_EARLY_TICKS):
        sched._drain_tick()
    for p, n in zip(prompts[4:], DG_NEW[4:]):
        sched.submit(p, SamplingParams(max_new_tokens=n))
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    st = sched.stats
    steps = st.slot_steps_total // DG_SLOTS
    res = dict(wall_s=wall, tokens=[list(r.tokens_out) for r in done],
               ttft_s=[r.metrics.ttft_s for r in done],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               counters=_dg_counts(), steps=steps,
               ms_per_step=1e3 * st.decode_s / max(1, steps),
               prefill_s=st.prefill_s, occupancy=st.occupancy())
    del sched, done
    return res


def _dg_disagg(cfg, params, faulted: bool) -> dict:
    """Run 2 (healthy, rolled decode) or 3 (faulted, per-token decode,
    virtual clock, flake / straggle / kill) of the trace through the
    DisaggScheduler. Hooks time each admit_external, record each handoff's
    wait in ticks, the bytes the retained bundles hold, the carry resumes
    and each worker's decode steps; the healthy run keeps kernel 1's
    operands of r1's last chunk, the faulted one checks r0's replay (its
    bundle against a host clone, its slot and prompt pages against its
    first admission, kernel 5 against its twin after its first step on
    the new worker). The checks' time is taken off the wall and the TTFTs
    of requests still waiting."""
    from repro_torch.distributed.fault_tolerance import (FaultEvent,
                                                         FaultPlan,
                                                         StragglerWatchdog)
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.disagg import DisaggScheduler
    kw = {}
    if faulted:
        kw = dict(decode_step_mode="token", clock=TickClock(),
                  watchdog=StragglerWatchdog(threshold=2.0, warmup=3),
                  max_requeues=2, sleep=lambda s: None,
                  fault_plan=FaultPlan([FaultEvent(**e)
                                        for e in DG_FAULTS]))
    dis = DisaggScheduler(cfg, params, prefill_workers=2, decode_workers=3,
                          slots_per_worker=DG_SLOTS, max_len=DG_MAX_LEN,
                          backend="kernel", decode_sla=True,
                          prefill_bucket=DG_BUCKET, paged=True,
                          prefill_chunk_blocks=DG_CHUNK_BLOCKS, **kw)
    nl = cfg.num_layers
    npages = DG_BUCKET // cfg.sla.block_kv
    rec = dict(handoff_tick={}, waits=[], admit_s=[], resumes=[],
               held_max=0, bundle_bytes=None, steps={}, overhead=0.0,
               kills=[], r0=[], rows={}, paged_rows=[], r0_clone=None,
               r0_bundle=None, admissions=[])
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    cur = dict(rid=None, chunk=None, layer=0)
    rows_fn, carry_get = ops.sla_attention_rows, dis._engine.carry_get

    def off_clock(fn):
        """Run a check outside the clocks: its seconds go to the overhead
        and to the submit times of requests without a first token, and
        its kernel launches are not counted."""
        counts = _dg_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
        _dg_set_counts(counts)
        rec["overhead"] += dt
        for r in dis._requests:
            if not r.tokens_out:
                r.metrics.submit_t += dt

    def rows_hook(*a, **kw):
        li = cur["layer"]
        cur["layer"] += 1
        if (not faulted and cur["rid"] == 1 and cur["chunk"] == 3
                and li in (0, nl - 1)):
            rec["rows"][li] = (a, kw)
        return rows_fn(*a, **kw)

    def carry_get_hook(key):
        snap = carry_get(key)
        if snap is not None:
            rec["resumes"].append((cur["assign"], len(key[1]) // 4))
        return snap

    def held(extra=()):
        live = {id(b): b for b in list(dis._bundles.values()) + list(extra)}
        return sum(_bundle_bytes(b)["total"] for b in live.values())

    for w in dis._prefill_pool:
        def tick_hook(stats, w=w, tick=w.tick):
            cur.update(rid=w.task.r.rid, chunk=w.task.next_chunk, layer=0)
            done = tick(stats)
            if done is not None:
                r, bundle = done
                rec["handoff_tick"][r.rid] = dis._tick_no
                rec["held_max"] = max(rec["held_max"], held((bundle,)))
                if rec["bundle_bytes"] is None:
                    rec["bundle_bytes"] = _bundle_bytes(bundle)
                if faulted and r.rid == 0:
                    rec["r0_bundle"] = bundle

                    def clone():
                        rec["r0_clone"] = {
                            i: _host_bits(t)
                            for i, t in enumerate(_tensors(bundle.cache))}
                    off_clock(clone)
            return done
        w.tick = tick_hook

        def assign_hook(r, toks, bucket, w=w, assign=w.assign):
            cur["assign"] = r.rid
            return assign(r, toks, bucket)
        w.assign = assign_hook

    for w in dis._decode_pool:
        sched = w.sched
        rec["steps"][w.wid] = 0

        def admit_hook(r, bundle, *, plan_built, prefilled, w=w,
                       admit=w.admit):
            rec["waits"].append((r.rid, dis._tick_no
                                 - rec["handoff_tick"][r.rid]))
            rec["admissions"].append((r.rid, w.wid, prefilled))
            return admit(r, bundle, plan_built=plan_built,
                         prefilled=prefilled)
        w.admit = admit_hook

        def ext_hook(r, slot, *a, sched=sched, ext=sched.admit_external,
                     **k):
            torch.cuda.synchronize()
            t0 = time.time()
            evs = ext(r, slot, *a, **k)
            torch.cuda.synchronize()
            rec["admit_s"].append(time.time() - t0)
            if faulted and r.rid == 0:
                off_clock(lambda: rec["r0"].append(
                    _slot_capture(sched, slot, npages)))
            return evs
        sched.admit_external = ext_hook

        def one_hook(token, w=w, sched=sched, one=sched._one):
            logits = one(token)
            rec["steps"][w.wid] += 1
            finite.logical_and_(torch.isfinite(logits).all())
            r0 = dis._requests[0]
            if (faulted and len(rec["r0"]) == 2 and not rec["paged_rows"]
                    and r0.slot is not None
                    and sched._slots[r0.slot] is r0):
                off_clock(lambda: rec["paged_rows"].extend(
                    _dg_paged_check(cfg, sched, r0.slot)))
            return logits
        sched._one = one_hook

    kill = dis._kill_worker

    def kill_hook(pool, w):
        if pool == "decode":
            rec["kills"].append((w.wid, [(r.rid, len(r.tokens_out))
                                         for r in w.in_flight()]))
        return kill(pool, w)
    dis._kill_worker = kill_hook
    dis._engine.carry_get = carry_get_hook
    prompts = _dg_prompts(cfg)
    ops.sla_attention_rows = rows_hook
    _dg_set_counts(dict.fromkeys(_dg_counts(), 0))
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        for p, n in zip(prompts[:4], DG_NEW[:4]):
            dis.submit(p, SamplingParams(max_new_tokens=n))
        for _ in range(DG_EARLY_TICKS):
            dis.tick()
        for p, n in zip(prompts[4:], DG_NEW[4:]):
            dis.submit(p, SamplingParams(max_new_tokens=n))
        done = dis.drain()
        torch.cuda.synchronize()
    finally:
        ops.sla_attention_rows = rows_fn
    wall = time.time() - t0 - rec["overhead"]
    counts = _dg_counts()
    st = dis.stats
    res = dict(
        wall_s=wall, overhead_s=rec["overhead"], finite=bool(finite),
        tokens=[list(r.tokens_out) for r in done],
        ttft_s=[r.metrics.ttft_s for r in done],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        counters=counts, steps=rec["steps"],
        stats={k: v for k, v in dataclasses.asdict(st).items()},
        prefill_occupancy=st.prefill_occupancy(),
        decode_occupancy=dis.decode_occupancy(), pool=dis.pool_stats(),
        ms_per_step={w.wid: 1e3 * w.sched.stats.decode_s
                     / max(1, rec["steps"][w.wid])
                     for w in dis._decode_pool},
        waits=rec["waits"], admit_s=rec["admit_s"],
        resumes=rec["resumes"], held_max=rec["held_max"],
        bundle_bytes=rec["bundle_bytes"], kills=rec["kills"],
        admissions=rec["admissions"], rows=rec["rows"],
        paged_rows=rec["paged_rows"])
    if faulted:
        b = rec["r0_bundle"]
        res["r0_bundle_bitwise"] = b is not None and all(
            torch.equal(_host_bits(t), rec["r0_clone"][i])
            for i, t in enumerate(_tensors(b.cache)))
        first, again = (rec["r0"] + [None, None])[:2]
        res["r0_replay"] = dict(
            admissions=len(rec["r0"]),
            leaves=0 if first is None else len(first),
            differ=None if again is None else sorted(
                k for k in first if not torch.equal(first[k], again[k])))
        del b, rec["r0_bundle"], rec["r0_clone"], rec["r0"], first, again
    del dis, done
    return res


def _dg_paged_check(cfg, sched, slot: int) -> list:
    """Kernel 5 against its twin on a decode worker's live LUT rows at
    the first and last layer, right after the replayed request's first
    decode step there (random queries, as phase 16)."""
    cache = sched._live
    pos = cache["pos"] - 1
    gen = torch.Generator(device=DEV).manual_seed(20)
    rows = []
    for layer in (0, cfg.num_layers - 1):
        q = torch.randn((sched.num_slots, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device=DEV)
        row = _paged_live_case(cfg, cache, layer, q, pos)
        runs = row.pop("runs")
        say(f"[20 disagg kernel] sla_decode_paged on the replayed slot's "
            f"worker, layer {layer} at positions {pos.tolist()} (slot "
            f"{slot}): vs twin, bitwise equal to sla_decode on the gathered "
            f"view at each width {row['bitwise_vs_sla_decode']}: "
            f"{_runs_text(runs)} (limit {row['limit']:.3g}) | eager call "
            f"{row['eager_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({row['mbytes']:.1f} MB, {row['tiles_read']} "
            f"tiles, {row['live_slots']} live slots; "
            f"{row['bound_fraction']:.1%} of it) | plain twin "
            f"{row['plain_ms']:.3f} ms")
        rows.append(dict(row, shape=f"qwen3-1.7b disagg replay layer "
                                    f"{layer}", dtype="bf16",
                         pos=pos.tolist()))
    return rows


def _dg_free():
    gc.collect()  # a run's schedulers, held in cycles by its hooks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _ttft_text(ttfts) -> str:
    from repro_torch.serving.api import percentile
    return (f"TTFT {[round(t, 3) for t in ttfts]} s (p50 "
            f"{percentile(ttfts, 0.5):.3f}, p95 "
            f"{percentile(ttfts, 0.95):.3f})")


def phase_disagg(cfg, params):
    """Phase 20: disaggregated prefill/decode serving at full Qwen3-1.7B
    width: the trace through the paged single Scheduler (blocking), then
    the DisaggScheduler healthy and under a flake, a straggle and a kill,
    each freed before the next. Returns (summary, kernel-1 rows, kernel-5
    rows)."""
    cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(
        col_capacity_factor=None))
    say(f"[20 disagg] {LM_ARCH} ({cfg.num_layers} layers, bf16 compute over "
        f"f32 weights, kernel backend, decode-SLA), col_capacity_factor "
        f"lifted to {cfg.sla.col_capacity_factor} (a shared prompt page is "
        f"a pure function of its prefix only uncapped); prompts {DG_LENS} "
        f"(r4 = r0's first {DG_SHARED} + its own), new {DG_NEW}, bucket "
        f"{DG_BUCKET}, max_len {DG_MAX_LEN}")
    _dg_free()
    base = _dg_baseline(cfg, params)
    say(f"[20 disagg] baseline, paged Scheduler ({DG_SLOTS} slots, "
        f"blocking): {base['wall_s']:.2f}s, {_ttft_text(base['ttft_s'])} | "
        f"{base['steps']} decode steps, {base['ms_per_step']:.2f} ms a step,"
        f" occupancy {base['occupancy']:.3f}, prefill {base['prefill_s']:.3f}"
        f"s | peak {base['peak_gib']:.2f} GiB | counters {base['counters']}")
    runs = {}
    for name, faulted in (("healthy", False), ("faulted", True)):
        _dg_free()
        r = runs[name] = _dg_disagg(cfg, params, faulted)
        bb = r["bundle_bytes"]
        say(f"[20 disagg] {name}: DisaggScheduler (2 prefill workers, 3 "
            f"decode workers of {DG_SLOTS} slots, chunks of "
            f"{DG_CHUNK_BLOCKS} blocks, "
            + ("per-token decode, virtual clock, faults "
               f"{[(e['tick'], e['kind'], e['worker']) for e in DG_FAULTS]}"
               if faulted else "rolled decode")
            + f"): {r['wall_s']:.2f}s (checks {r['overhead_s']:.2f}s taken "
            f"off), {_ttft_text(r['ttft_s'])} | peak {r['peak_gib']:.2f} GiB")
        say(f"  stats {r['stats']} | prefill occupancy "
            f"{r['prefill_occupancy']:.3f}, decode occupancy "
            f"{r['decode_occupancy']:.3f} | decode ms a step by worker "
            f"{ {k: round(v, 2) for k, v in r['ms_per_step'].items()} } over "
            f"steps {r['steps']}")
        say(f"  pool {r['pool']}")
        say(f"  handoff waits (rid, ticks) {r['waits']} | admit_external "
            f"{[round(t, 4) for t in r['admit_s']]} s | admissions (rid, "
            f"worker, prefilled) {r['admissions']} | resumes (rid, tokens) "
            f"{r['resumes']} | kills {r['kills']}")
        say(f"  a bundle {bb['total']} bytes (k/v {bb['kv']}, hblk "
            f"{bb['hblk']}, rest {bb['rest']}); most held at once "
            f"{r['held_max']} | counters {r['counters']} | logits finite "
            f"{r['finite']}")
        if faulted:
            say(f"  r0's bundle bitwise its clone after the drain "
                f"{r['r0_bundle_bitwise']} | r0's replay {r['r0_replay']}")
    hl, fl = runs["healthy"], runs["faulted"]
    fwd_rows = _chunk_fwd_rows(hl.pop("rows"), "r1's last chunk",
                               "20 disagg kernel")
    paged_rows = fl.pop("paged_rows")
    fl.pop("rows")
    torch.cuda.empty_cache()
    bad = []
    if not (hl["tokens"] == fl["tokens"] == base["tokens"]):
        bad.append("tokens differ across the baseline, healthy and faulted "
                   "runs: " + str([
                       [sum(a == b for a, b in zip(x, y)) for x, y in zip(
                           run["tokens"], base["tokens"])]
                       for run in (hl, fl)]))
    if [len(t) for t in base["tokens"]] != list(DG_NEW):
        bad.append("a request did not finish with its tokens")
    for name, r in runs.items():
        st, c = r["stats"], r["counters"]
        got = {k: st[k] for k in DG_EXPECT}
        if got != DG_EXPECT:
            bad.append(f"{name}: {got}, expected {DG_EXPECT}")
        if r["resumes"] != list(DG_RESUMES):
            bad.append(f"{name}: resumes {r['resumes']}, expected "
                       f"{list(DG_RESUMES)}")
        if c["sla_fwd"] != c["tc_sla_fwd"] or \
                c["sla_fwd"] != cfg.num_layers * DG_EXPECT["prefill_chunks"]:
            bad.append(f"{name}: sla_fwd launches {c}")
        steps = sum(r["steps"].values())
        if c["sla_decode_paged"] != cfg.num_layers * steps or \
                c["sla_decode"]:
            bad.append(f"{name}: {c} in {steps} decode steps")
        if not r["finite"]:
            bad.append(f"{name}: non-finite logits")
    st = fl["stats"]
    if (st["kills"], st["retries"], st["straggler_drains"]) != (1, 1, 1) \
            or st["requeues"] < 1:
        bad.append(f"faulted counters {st}")
    replays = [a for a in fl["admissions"] if a[2] == 0]
    if not replays or replays[0][0] != 0:
        bad.append(f"no replay of r0 from its bundle: {fl['admissions']}")
    r0_at_kill = dict(sum((k[1] for k in fl["kills"]), []))
    if not 1 < r0_at_kill.get(0, 0) < DG_NEW[0]:
        bad.append(f"the kill did not land while r0 was mid-stream: "
                   f"{fl['kills']}")
    if not fl["r0_bundle_bitwise"]:
        bad.append("r0's bundle changed after its handoff")
    rp = fl["r0_replay"]
    if rp["admissions"] != 2 or rp["differ"]:
        bad.append(f"r0's replayed admission is not bitwise its first: {rp}")
    if len(paged_rows) != 2 or not all(r["ok"] for r in paged_rows):
        bad.append(f"sla_decode_paged on the replay's state {paged_rows}")
    if len(fwd_rows) != 2 or not all(r["ok"] for r in fwd_rows) or \
            any(r["base"] != DG_LAST_BASE for r in fwd_rows):
        bad.append(f"sla_fwd on r1's last chunk {fwd_rows}")
    summary = dict(
        wall_s=dict(baseline=base["wall_s"], healthy=hl["wall_s"],
                    faulted=fl["wall_s"]),
        ttft_s=dict(baseline=base["ttft_s"], healthy=hl["ttft_s"],
                    faulted=fl["ttft_s"]),
        peak_gib=dict(baseline=base["peak_gib"], healthy=hl["peak_gib"],
                      faulted=fl["peak_gib"]),
        bundle_bytes=hl["bundle_bytes"],
        held_max=dict(healthy=hl["held_max"], faulted=fl["held_max"]),
        admit_s=dict(healthy=hl["admit_s"], faulted=fl["admit_s"]),
        waits=dict(healthy=hl["waits"], faulted=fl["waits"]),
        ms_per_step=dict(baseline=base["ms_per_step"],
                         healthy=hl["ms_per_step"],
                         faulted=fl["ms_per_step"]),
        occupancy=dict(healthy=(hl["prefill_occupancy"],
                                hl["decode_occupancy"]),
                       faulted=(fl["prefill_occupancy"],
                                fl["decode_occupancy"])),
        counters=dict(baseline=base["counters"], healthy=hl["counters"],
                      faulted=fl["counters"]),
        stats=dict(healthy=hl["stats"], faulted=fl["stats"]),
        r0_replay=rp, kills=fl["kills"])
    if bad:
        raise RuntimeError("disaggregated serving phase failed: "
                           + "; ".join(bad))
    return summary, fwd_rows, paged_rows


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, plan_lib.SLAPlan):
        for n in plan_lib.PLAN_LEAVES:
            yield getattr(x, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over one full-width "
                         "forward, one full-width training step, 8 "
                         "full-width LM decode steps and one full-width LM "
                         "prefill and print the top device-time entries")
    args = ap.parse_args(argv)
    t_all = time.time()
    phase_card()
    phase_build()
    rows, planes = phase_kernel_vs_plain()
    cfg, params = _main_model(seed=0)
    main_run = phase_main_path(cfg, params)
    plans, cross = phase_cross_check(cfg, params, args.profile)
    rows += phase_kernel_on_path_plans(cfg, plans)
    pcache = phase_plan_cache(cfg, params, plans)
    bwd_rows = phase_bwd_vs_plain()
    bwd_rows += phase_bwd_on_path_plans(cfg, plans)
    grads = phase_grad_cross_check(cfg, plans)
    del plans
    train = phase_train(cfg, params, args.profile)
    cli = phase_train_cli()
    del cfg, params  # the LM phases get the whole card
    torch.cuda.empty_cache()
    dec_rows, sdpa_ms = phase_decode_vs_plain()
    lm_cfg, lm_params = _lm_model(seed=0)
    lm_run = phase_lm_main(lm_cfg, lm_params)
    path_rows, lm_fwd_rows, lm_cross = phase_lm_cross_check(lm_cfg, lm_run,
                                                            args.profile)
    dec_rows += path_rows
    rows += lm_fwd_rows
    lm = lm_run["summary"]
    del lm_run  # phase 12's engine and decode state
    gc.collect()  # the hooks hold the engine in reference cycles
    torch.cuda.empty_cache()
    pg_rows = phase_paged_vs_plain()
    pg, pg_path_rows = phase_paged_main(lm_cfg, lm_params, args.profile)
    pg_rows += pg_path_rows
    pgc = pg["counters"]
    gc.collect()  # phase 15's scheduler, held in cycles by its hooks
    torch.cuda.empty_cache()
    pu = phase_unpaged_mixed(lm_cfg, lm_params)
    puc = pu["counters"]
    gc.collect()
    torch.cuda.empty_cache()
    pc, pc_rows = phase_chunked_admission(lm_cfg, lm_params)
    rows += pc_rows
    pcc = pc["counters"]
    gc.collect()
    torch.cuda.empty_cache()
    dchunk, dc_rows = phase_decode_chunk(lm_cfg, lm_params)
    dec_rows += dc_rows
    gc.collect()
    torch.cuda.empty_cache()
    dg, dg_fwd_rows, dg_pg_rows = phase_disagg(lm_cfg, lm_params)
    rows += dg_fwd_rows
    pg_rows += dg_pg_rows
    dgc = {key: sum(dg["counters"][run][key]
                    for run in ("healthy", "faulted"))
           for key in dg["counters"]["healthy"]}
    def row(shape, dtype, route):
        return next(r for r in rows if r["shape"] == shape
                    and r["dtype"] == dtype and r["route"] == route)

    wan32 = row("wan2_1_1_3b", "f32", FWD_SPLIT_ROUTE)
    wan32_fma = row("wan2_1_1_3b", "f32", FWD_F32_ROUTE)
    wan16 = row("wan2_1_1_3b", "bf16", FWD_TC_ROUTE)
    ldit32 = row("lightningdit_1b", "f32", FWD_SPLIT_ROUTE)
    layers = {f"path_layer{layer}": {
        route: row(f"wan2_1_1_3b layer {layer} plans", "f32", route)
        for route in (FWD_SPLIT_ROUTE, FWD_F32_ROUTE)}
        for layer in (0, 29)}
    fwd_tc = [r for r in rows if r["route"] == FWD_TC_ROUTE]
    fwd_split = [r for r in rows if r["route"] == FWD_SPLIT_ROUTE]
    fwd_fma = [r for r in rows if r["route"] == FWD_F32_ROUTE]
    wan_bwd = {r["kernel"]: r for r in bwd_rows
               if r["shape"] == "wan2_1_1_3b" and r["dtype"] == "f32"}
    wan_tc = {r["kernel"]: r for r in bwd_rows
              if r["shape"] == "wan2_1_1_3b" and r["dtype"] == "bf16"}
    # compiled flex_attention's forward on the same inputs and LUT (phase
    # 7): O^s and L only, no linear branch, so not the kernel's function
    flex16 = wan_tc["sla_bwd_dq"].get("library_fwd_ms")
    say(f"[21] sla_fwd at the Wan bf16 case (tensor cores): "
        f"{wan16['ms']:.3f} ms against its bound {wan16['bound_ms']:.3f} ms "
        f"({wan16['bound_fraction']:.1%}) | compiled flex_attention forward "
        f"on the same LUT (O^s and L only, lacks O^l): "
        + (f"{flex16:.3f} ms" if flex16 is not None else "not measured"))
    say(f"[21] sla_fwd at the Wan f32 case: split route {wan32['ms']:.3f} ms "
        f"against its bound {wan32['bound_ms']:.3f} ms "
        f"({wan32['bound_fraction']:.1%}; the f32-FMA bound "
        f"{wan32['bound_ms_f32_fma']:.3f} ms) | f32-FMA kernel "
        f"{wan32_fma['ms']:.3f} ms | path layer 0 / 29: split "
        f"{layers['path_layer0'][FWD_SPLIT_ROUTE]['ms']:.3f} / "
        f"{layers['path_layer29'][FWD_SPLIT_ROUTE]['ms']:.3f} ms, f32-FMA "
        f"{layers['path_layer0'][FWD_F32_ROUTE]['ms']:.3f} / "
        f"{layers['path_layer29'][FWD_F32_ROUTE]['ms']:.3f} ms")
    pc_runs = (pcache["off"], pcache["on"])
    pc_launches = {key: sum(r[key] for r in pc_runs) for key in (
        "launches", "split_launches", "planes_launches", "tc_launches")}
    tc_paths = {"serve": main_run["tc_launches"],
                "serve_plan_cache": pc_launches["tc_launches"],
                "train": train["launches"]["tc_sla_fwd"],
                "lm_prefill": lm["launches"]["tc_sla_fwd"],
                "lm_paged_prefill": pgc["tc_sla_fwd"],
                "lm_unpaged_prefill": puc["tc_sla_fwd"],
                "lm_chunked_prefill": pcc["tc_sla_fwd"],
                "lm_disagg": dgc["tc_sla_fwd"]}
    # the other paths compute in bf16: every launch there is a tensor-core
    # one (phases 9, 12, 15, 17 check), so none is on the split route
    split_paths = {"serve": main_run["split_launches"],
                   "serve_plan_cache": pc_launches["split_launches"],
                   "train": 0,
                   "lm_prefill": 0, "lm_paged_prefill": 0,
                   "lm_unpaged_prefill": 0, "lm_chunked_prefill": 0,
                   "lm_disagg": 0}
    kernels = [{
        "name": "sla_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_fwd_split.cu",
        "replaces": "src/repro/kernels/sla_fwd.py:34",
        "launches": (main_run["launches"] + pc_launches["launches"]
                     + train["launches"]["sla_fwd"]
                     + lm["launches"]["sla_fwd"] + pgc["sla_fwd"]
                     + puc["sla_fwd"] + pcc["sla_fwd"] + dgc["sla_fwd"]),
        "launches_by_path": {"serve": main_run["launches"],
                             "serve_plan_cache": pc_launches["launches"],
                             "train": train["launches"]["sla_fwd"],
                             "lm_prefill": lm["launches"]["sla_fwd"],
                             "lm_paged_prefill": pgc["sla_fwd"],
                             "lm_unpaged_prefill": puc["sla_fwd"],
                             "lm_chunked_prefill": pcc["sla_fwd"],
                             "lm_disagg": dgc["sla_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in fwd_split),
        "ms": wan32["ms"], "plain_ms": wan32["plain_ms"],
        "bound_ms": wan32["bound_ms"], "bound_by": wan32["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes O^l with the sparse "
                   "softmax",
        "route_f32": FWD_SPLIT_ROUTE,
        "split_launches": sum(split_paths.values()),
        "split_launches_by_path": split_paths,
        "bound_fraction": wan32["bound_fraction"],
        "bound_ms_f32_fma": wan32["bound_ms_f32_fma"],
        "split_ctas_per_sm": sla_fwd.split_ctas_per_sm(),
        "ms_lightningdit": ldit32["ms"],
        "split_limits_all_ok": all(r["ok"] for r in fwd_split),
        "dense_sdpa_ms": wan32["dense_sdpa_ms"],
        "gather_ms": wan32["gather_ms"],
        "kernel_backend_ms": wan32["kernel_backend_ms"],
        "flex_sparse_branch_fwd_ms": wan_bwd["sla_bwd_dq"].get(
            "library_fwd_ms"),
        **{f"ms_{name}": {"split": by[FWD_SPLIT_ROUTE]["ms"],
                          "f32_fma": by[FWD_F32_ROUTE]["ms"],
                          "bound_split": by[FWD_SPLIT_ROUTE]["bound_ms"],
                          "bound_f32_fma": by[FWD_F32_ROUTE]["bound_ms"]}
           for name, by in layers.items()},
        "serve_profile": cross["kernel1_profile"],
        "route_fma": FWD_F32_ROUTE,
        "source_fma": "src/repro_torch/kernels/csrc/sla_fwd.cu",
        "ms_fma": wan32_fma["ms"], "bound_ms_fma": wan32_fma["bound_ms"],
        "max_abs_err_fma": max(r["max_abs_err"] for r in fwd_fma),
        "route_bf16": FWD_TC_ROUTE,
        "source_bf16": "src/repro_torch/kernels/csrc/sla_fwd_tc.cu",
        "tc_launches": sum(tc_paths.values()),
        "tc_launches_by_path": tc_paths,
        "ms_bf16": wan16["ms"], "plain_ms_bf16": wan16["plain_ms"],
        "bound_ms_bf16": wan16["bound_ms"],
        "bound_by_bf16": wan16["bound_by"],
        "bound_fraction_bf16": wan16["bound_fraction"],
        "flex_sparse_branch_fwd_ms_bf16": flex16,
        "max_abs_err_bf16": max(r["max_abs_err"] for r in fwd_tc),
        "o_l_max_abs_err_bf16": max(r["o_l_err"] for r in fwd_tc),
        "tc_criterion_all_ok": all(r["ok"] for r in fwd_tc),
        "train_ms_per_launch": (train["ms_per_launch"] or {}).get(
            "sla_fwd_tc_kernel"),
        "cases": rows,
    }, {
        "name": "sla_fwd_split_planes", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_fwd_split.cu",
        "replaces": "src/repro/kernels/sla_fwd.py:34",
        "part_of": "sla_fwd's split route: its K/V pre-pass",
        "launches": (main_run["planes_launches"]
                     + pc_launches["planes_launches"]),
        "launches_by_path": {
            "serve": main_run["planes_launches"],
            "serve_plan_cache": pc_launches["planes_launches"]},
        "max_abs_err": planes["max_abs_err"], "ms": planes["ms"],
        "plain_ms": planes["plain_ms"], "bound_ms": planes["bound_ms"],
        "bound_by": planes["bound_by"], "library_ms": None,
        "library": "none: no one PyTorch call cuts f32 into bf16 parts",
        "bitwise_vs_twin": planes["bitwise"],
        "bound_fraction": planes["bound_fraction"],
    }]
    for name, line in (("sla_bwd_dq", 48), ("sla_bwd_dkv", 76)):
        mine = [r for r in bwd_rows if r["kernel"] == name]
        tc_cases = [r for r in mine if r["route"] == TC_ROUTE]
        wan, tc = wan_bwd[name], wan_tc[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sla_bwd.cu",
            "replaces": f"src/repro/kernels/sla_bwd.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["route"] == F32_ROUTE),
            "ms": wan["ms"], "plain_ms": wan["plain_ms"],
            "bound_ms": wan["bound_ms"], "bound_by": wan["bound_by"],
            "library_ms": wan["library_ms"],
            "library": "compiled flex_attention backward on a BlockMask of "
                       "the same LUT; computes dQ, dK and dV together",
            "dq_plus_dkv_ms": sum(r["ms"] for r in wan_bwd.values()),
            "dense_sdpa_bwd_ms": wan["dense_sdpa_bwd_ms"],
            "route_bf16": TC_ROUTE,
            "source_bf16": "src/repro_torch/kernels/csrc/sla_bwd_tc.cu",
            "tc_launches": train["launches"][f"tc_{name}"],
            "ms_bf16": tc["ms"], "plain_ms_bf16": tc["plain_ms"],
            "bound_ms_bf16": tc["bound_ms"],
            "bound_by_bf16": tc["bound_by"],
            "bound_fraction_bf16": tc["bound_fraction"],
            "library_ms_bf16": tc["library_ms"],
            "dq_plus_dkv_ms_bf16": sum(r["ms"] for r in wan_tc.values()),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in tc_cases),
            "tc_criterion_all_ok": all(r["ok"] for r in tc_cases),
            "train_ms_per_launch": (train["ms_per_launch"] or {}).get(
                f"{name}_tc_kernel"),
            "cases": mine,
        })
    head = next(r for r in dec_rows if r["shape"] == "qwen3-1.7b decode C=1"
                and r["dtype"] == "bf16")
    split_keys = ("split_width", "nsplit", "grid_ctas", "ms_width1",
                  "ms_width2", "eager_ms", "bitwise_repeat")
    kernels.append({
        "name": "sla_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_decode.cu",
        "replaces": "src/repro/kernels/sla_decode.py:52",
        "launches": (lm["launches"]["sla_decode"] + pgc["sla_decode"]
                     + puc["sla_decode"] + sum(dchunk["launches"])
                     + dgc["sla_decode"]),
        "launches_by_path": {"lm_decode": lm["launches"]["sla_decode"],
                             "lm_paged_decode": pgc["sla_decode"],
                             "lm_unpaged_decode": puc["sla_decode"],
                             "lm_decode_chunk": sum(dchunk["launches"]),
                             "lm_disagg": dgc["sla_decode"]},
        "max_abs_err": max(r["max_abs_err"] for r in dec_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes O^l (the subtractive "
                   "linear branch) with the sparse softmax",
        "dense_sdpa_ms": sdpa_ms,
        **{key: head[key] for key in split_keys},
        "timing": "ms: CUDA events around CUDA-graph replays (device time "
                  "of the split and combine kernels); eager_ms: CUDA events "
                  "around eager calls (host dispatch included)",
        "cases": dec_rows,
    })
    head5 = next(r for r in pg_rows if r["shape"] ==
                 "qwen3-1.7b paged decode B=4" and r["dtype"] == "bf16")
    kernels.append({
        "name": "sla_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_decode.cu",
        "replaces": "src/repro/kernels/sla_decode.py:181",
        "launches": (lm["launches"]["sla_decode_paged"]
                     + pgc["sla_decode_paged"] + puc["sla_decode_paged"]
                     + pcc["sla_decode_paged"] + dgc["sla_decode_paged"]),
        "launches_by_path": {"lm_decode": lm["launches"]["sla_decode_paged"],
                             "lm_paged_decode": pgc["sla_decode_paged"],
                             "lm_unpaged_decode": puc["sla_decode_paged"],
                             "lm_chunked_decode": pcc["sla_decode_paged"],
                             "lm_disagg": dgc["sla_decode_paged"]},
        "max_abs_err": max(r["max_abs_err"] for r in pg_rows),
        "ms": head5["ms"], "plain_ms": head5["plain_ms"],
        "bound_ms": head5["bound_ms"], "bound_by": head5["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes O^l (the subtractive "
                   "linear branch) with the sparse softmax",
        "sla_decode_on_view_ms": head5["sla_decode_view_ms"],
        "bitwise_vs_sla_decode": all(r["bitwise_vs_sla_decode"]
                                     for r in pg_rows),
        **{key: head5[key] for key in split_keys},
        "cases": pg_rows,
    })
    say(f"[21] main path {main_run} | cross-check {cross} | plan cache "
        f"{pcache} | grads {grads} | "
        f"train {train} | train CLI {cli} | lm {lm} | lm cross-check "
        f"{lm_cross} | paged lm {pg} | unpaged mixed {pu} | chunked "
        f"admission {pc} | decode_chunk {dchunk} | disagg {dg} | total "
        f"{time.time() - t_all:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
