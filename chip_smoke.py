#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py             # the check, on one card
    python3 chip_smoke.py --profile   # also profile one full-width forward,
                                      # one full-width training step,
                                      # 8 full-width LM decode steps, one
                                      # full-width LM prefill, 8 paged
                                      # LM decode steps, one full-width
                                      # LM training step, one MoE
                                      # decode step and one zamba2,
                                      # one whisper and one gemma3
                                      # training step

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
     time of the linear-branch epilogue and one tile). The LightningDiT
     shape at 32x32 blocks: in f32 on the f32-FMA kernel, held to 5e-5; in
     bf16 on the "tc32" tensor-core kernel (`sla_fwd_tc32.cu`, D 108
     padded to 128), held as the tensor-core route is, with the f32-FMA
     kernel forced beside it. CUDA-event times of the kernel, the plain twin, the
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
     LUTs, f32 and bf16, and four bf16 cases at 32 x 32 blocks (causal
     and bidirectional GQA-2, H 12, N 4096, at D 64 and D 128), with the
     forward kernel's "tc32" route held beside them on the same four
     cases (phase 3's tensor-core criterion, a bitwise repeat; causal on
     the query span from block 32, base 32). The f32
     cases take the f32-FMA kernels, held to 5e-5 x max(1, max |twin|).
     The bf16 cases take the tensor-core kernels of their blocks (64 x 64:
     `sla_bwd_tc.cu`; 32 x 32: `sla_bwd_tc32.cu`, its CTAs an SM printed;
     each checked by its route's own launch counters),
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
 21. LM training (on phase 12's model, which it trains in place):
     qwen3-1.7b at full width and depth (28 layers, d_model 2048, 16 / 8
     heads of 128, vocab 151,936), `train_4k` (seq 4096) with its global
     batch 256 cut to 1, `token_batch` data. First one batch's `loss_fn`
     on the kernel against the gather backend (bf16 compute) within 5e-2
     x max(1, |loss|); then `make_train_step` (AdamW over the f32
     masters, bf16 compute, kernel backend) under per-layer remat: 3
     `loss_fn` steps and one `distill_loss_fn` step. Checks finite losses
     and grad norms, moved parameters, and per step exactly 56 `sla_fwd`
     launches (28 layers, each run twice: the forward and its remat
     recompute), 28 `sla_bwd_dq` and 28 `sla_bwd_dkv`, all on the tensor
     cores, and 28 plan builds; prints each step's wall, loss, grad norm
     and peak memory. Then kernels 1-3 against their twins on the last
     `loss_fn` step's plans of layers 0 and 27 (seeded q and k/v repeated
     to the 16 query heads as the kernel backend gives them, causal;
     `cases.tc_criterion`, two launches bitwise equal), timed with their
     bounds; then the train CLI on the card (`--arch qwen3-1.7b --smoke
     --steps 3`). `--profile` adds a profile of one more `loss_fn` step.
 22. MoE serving (after phase 21's model is freed): the static
     ServingEngine serving moonshot-v1-16b-a3b at full width and depth
     (48 layers, d_model 2048, 16 / 16 heads of 128, 64 experts top-6 of
     1408 plus the shared expert, vocab 163,840; weights made in bf16,
     since f32 masters of its ~28.1 B parameters would not fit the card)
     with decode-time SLA on the kernel backend: batch 2, prompts of
     4,000 and 3,980 tokens (a 4,032-token bucket), max_len 4,096, 32 new
     tokens each. Checks the token counts, finite logits, 48 `sla_fwd`
     launches (all on tensor cores), 48 x 31 `sla_decode` and no
     `sla_decode_paged`, and 48 MoE calls in the prefill and 48 a decode
     step; prints the prefill wall, decode ms a step, peak memory, and the
     MoE capacity and dropped (token, slot) pairs in prefill and decode.
     Then kernel 4 against its twin on the path's decode state of layers
     0 and 47 (group 1, three split widths, two launches bitwise equal,
     CUDA-graph times, decode_execute kernel vs gather within 5e-5), the
     prefill's last-position logits on the kernel against the gather
     backend (5e-2 x max(1, max |logits|), greedy agreement), and kernel
     1 against its twin on the prefill's layer-0 plans (BH 32, group 1,
     N 4,032). `--profile` adds a profile of one decode step.
 23. hybrid (after phase 22's model is freed): zamba2-1.2b at full
     width and depth (38 Mamba2 layers, d_model 2048, 64 SSM heads of 64,
     state 64, the shared SLA block of 32 heads of 64 after each of the
     segments 6,6,6,6,6,6,2, vocab 32,000; f32 masters), train_4k (seq
     4,096) with its global batch cut to 1, `token_batch` data. One
     batch's `loss_fn` kernel vs gather (bf16 compute) within 5e-2 x
     max(1, |loss|); 3 `make_train_step` steps (AdamW, bf16 compute,
     kernel backend, the reference's remat: Mamba layers only), each with
     finite loss and grad norm and exactly 7 `sla_fwd`, 7 `sla_bwd_dq`
     and 7 `sla_bwd_dkv` launches, all on the tensor cores, and 7 plan
     builds; the probes (a Mamba `in_proj`, `shared_attn.sla_proj`,
     `embed`) moved. The chunked scan's CUDA-event time at a layer's
     shape and its share of a step. Kernels 1-3 against their twins on
     the last step's plans of the first and last application (causal,
     BH 32, N 4,096, D 64; `cases.tc_criterion`, two launches bitwise
     equal), timed, each with its bound for the D-64 work and for the
     operands zero-padded to D 128. Then `prefill` of 2 x 4,096 tokens (7
     tensor-core `sla_fwd` launches), the K/V grown by 16 zero rows, and
     16 greedy `decode_step`s (dense attention, no SLA launch): finite
     logits, `pos` 4,112; prefill wall, decode ms a step, peak memory.
     Then the train CLI (`--arch zamba2-1.2b --smoke --steps 2`).
     `--profile` adds a profile of one more training step.
 24. encdec: whisper-small at full width and depth (12 + 12 layers, d
     768, 12 heads of 64, vocab 51,865; f32 masters), train_4k (4,096
     audio frames, 512 text tokens), batch 1. As phase 23: the loss
     kernel vs gather, 3 steps with 24 `sla_fwd` (12 encoder layers, the
     forward and its remat recompute), 12 `sla_bwd_dq` and 12
     `sla_bwd_dkv` a step on the tensor cores and 12 plan builds,
     kernels 1-3 on the plans of encoder layers 0 and 11 (non-causal, BH
     12, D 64) with both bounds; `prefill` of 2 x 4,096 frames (12
     `sla_fwd` launches, every decoder layer's cross K/V) and 32 greedy
     `decode_step`s with finite logits; the train CLI.
 25. ssm: rwkv6-7b at full width and depth (32 layers, d 4096, 64 heads
     of 64, d_ff 14,336, vocab 65,536; 7.2 B parameters made in bf16:
     f32 masters and moments would not fit a training step). `prefill`
     of 2 x 2,048 tokens and 16 `decode_step`s fed the next tokens, in
     bf16 and again in f32 compute, each against one `forward` over the
     same 2,064 tokens: the f32 run held within 5e-2 x max(1, max
     |logits|) (the reference test's decode-against-forward
     consistency), the bf16 run's drift and greedy agreement measured
     (the chunked forward rounds what the step does not, in the
     reference too); finite logits; no SLA kernel launches. Prints walls
     and peaks.
 26. head dim 256: kernels 1, 2 and 3 against their twins at gemma3-1b's
     prefill shape (BH 4 on BH_kv 1, N 32,768, D 256, 64x64 blocks,
     causal, LUTs from `plan_attention`) in f32 and bf16, all on the
     f32-FMA route (the tensor-core and split counters do not move; kernels
     2-3 through their wide kernels, which split the gradients' head-dim
     columns over the grid), each output within 5e-5 x max(1, max |twin|),
     two launches bitwise equal, kernels 2-3 also at D 192 (N 4,096) and
     beside compiled flex_attention's backward on the same causal LUT at D
     256 (the library time, or its error); kernel 4 on a
     gemma3 decode state (B 2, H 4, Hkv 1, D 256, Tn 512, K 26, bf16 K/V)
     at C 1 and 4 and kernel 5 on a paged state of 4 slots sharing 96
     pages, at three split widths, kernel 5 bitwise equal to kernel 4 on
     the gathered view; each timed (CUDA events; the decode kernels by
     CUDA-graph replay) beside its bound.
 27. gemma3-1b at full width and depth (26 layers: 22 sliding-window
     layers with a 512-token window, 4 SLA layers; 4 / 1 heads of 256;
     vocab 262,144; f32 masters, bf16 compute): the static engine with
     decode-time SLA, 2 prompts of 32,000 tokens and 64 new (prefill_32k's
     batch 32 cut to 2): 4 kernel-1 launches a prefill forward, all on the
     f32-FMA route, 4 kernel-4 launches a decode step, kernel 4 against
     its twin on the path's state of the first and last SLA layer, the
     prefill's last-position logits on the kernel and the gather backend
     on the kernel run's plans within 5e-2 x max(1, max |logits|); then
     the paged continuous Scheduler, 4 prompts of 8,000 tokens sharing
     their first 6,144 and 16 new each: 4 kernel-1 launches an
     admission, 4 kernel-5 launches a step, kernel 5 against its twin on
     the live state at one step. Prefill walls, decode ms a step, pages,
     peak memory.
 28. h2o-danube-3-4b at full width and depth (24 SLA layers, 32 / 8 heads
     of 120, window 8,192 inside the SLA mask): the static engine with
     dense decode (decode-time SLA refuses a window, as the reference),
     2 prompts of 32,000 tokens and 32 new: 24 kernel-1 launches a
     prefill, all on the tensor-core route (D 120 padded to 128); the
     prefill logits kernel vs gather on shared plans; no block of those
     plans classified at a distance of window + block_kv or more.
 29. internvl2-1b at full width and depth (24 layers, 14 / 2 heads of 64,
     256 patch embeddings ahead of 3,840 tokens), train_4k at batch 1, f32
     masters: the loss kernel vs gather, 3 AdamW steps under remat with
     48 / 24 / 24 tensor-core launches of kernels 1 / 2 / 3 a step,
     kernels 1-3 on the last step's plans of layers 0 and 23, the train
     CLI.
     mistral-large-123b is not driven: its 122 B parameters take 228 GiB
     even in bf16, past one card; `launch/dryrun.py` places it on the
     production meshes on the meta device (not on the card).
 30. gemma3-1b trained at full width and depth (phase 27's model, 26
     layers, ~1.0 B parameters), train_4k at batch 1, f32 masters, bf16
     compute, kernel backend, remat: the loss kernel vs gather, 3 AdamW
     steps with exactly 8 / 4 / 4 launches of kernels 1 / 2 / 3 a step,
     none on tensor cores, all at head dim 256 in the wrappers' records,
     4 plans; the probes (`layers.5.sla_proj`, `layers.0.wq`, `embed`)
     moved. The trained state (masters, moments, step; ~12 GB) saved once
     by `checkpoint.manager.CheckpointManager` into build/ (free disk
     printed; under twice the state's bytes a smoke-width state instead),
     the loop's blocking time and the writer's printed, restored onto the
     card bitwise and deleted. Kernels 1-3 on the last step's plans of SLA
     layers 5 and 23 with their bounds. Then the train CLI at smoke
     gemma3 with `--ckpt-every 1 --compress-grads` into a temporary
     directory under build/: 4 steps, every checkpoint past step_2
     deleted, the same command resumed at step 2: its losses within 5e-2
     of the straight run's last two (bitwise equality printed).
 32. the mesh path at world size 1 (NCCL, a FileStore under a temporary
     directory, the group destroyed at the end): phase 21's model and
     batches (full-width Qwen3-1.7B, train_4k at batch 1) for LT_STEPS
     AdamW steps on the plain path, then the same steps with the
     parameters and moments held as DTensors on `make_host_mesh(1, 1)`
     (`sharding.place_module`) under `activation_sharding(mesh,
     default_residual_spec(...), remat=True)`: losses, grad norms and
     every final parameter bitwise equal, 56 / 28 / 28 tensor-core
     launches of kernels 1 / 2 / 3 a step on both, walls and peaks beside
     phase 21's. Then the train CLI at smoke qwen3 on that world (so on
     the mesh: its placement and `restore(shardings=)` are counted):
     MESH_CLI_STEPS steps saving every MESH_CLI_EVERY, the last
     checkpoint deleted, the same command resumed: its losses and the
     rewritten checkpoint's files bitwise the straight run's. The dry run
     does not run here (its fake process group cannot share the process
     with NCCL).
 33. phase 32 for the other families (`P33_MODELS`), in one NCCL group of
     world size 1: zamba2-1.2b and whisper-small at full width and depth,
     moonshot-v1-16b-a3b at full width cut from 48 to 4 layers (~580 M
     parameters a layer at ~18 bytes of training state, beside the plain
     run's parameters held for the comparison), rwkv6-7b at full width
     cut from 32 to 4 layers; train_4k at batch 1, LT_STEPS AdamW steps
     on the plain path, then over `make_host_mesh(1, 1)`: losses, grad
     norms, final parameters and every MoE router call's kept slots
     bitwise equal, launches of kernels 1 / 2 / 3 and plan builds a step
     equal and as the family's layers say (7 / 7 / 7, 24 / 12 / 12,
     8 / 4 / 4, none); walls, peaks and the MoE's dropped slots printed.
 34. sharded serving's path at world size 1 (`phase_serve_mesh`):
     full-width Qwen3-1.7B with seeded bf16 weights, 2 prompts of 32,000
     tokens prefilled into 32,768-position caches (7.5 GB of K/V) through
     `make_prefill_step(cfg, "kernel", cache_len=)` and 16 greedy dense
     decode steps through `make_serve_step`, on the plain path and then
     with the parameters on `make_host_mesh(1, 1)` (NCCL, world size 1)
     under `activation_sharding`: logits, K/V caches and greedy tokens
     bitwise, 28 tensor-core launches of kernel 1 a prefill on both, none
     of the decode kernels; walls a step printed for both paths. Then the
     flash-decoding partial softmax and combine of
     `distributed/serving.py` over layer 0's cache cut into 4 and 16
     spans (layouts B and C), shared and per-slot positions, against
     `_dense_decode_attn` on the whole cache: f32 within 5e-5 x max(1,
     max |o|), bf16 within 5e-2 x max(1, max |o|), the combine bitwise on
     repeat, CUDA-event times beside the whole cache's attention. b. plan
     reuse at the model API on both paths: `prefill(return_plans=True)`
     of the first prompts, then a same-shape `prefill(plans=,
     drift_threshold=0.3, return_plans=True)` of 2 x 32,000 other tokens:
     its logits, K/V cache, every plan leaf and drift info bitwise, 28
     tensor-core launches of kernel 1 on both; its walls, re-planned
     layers and lowest retention printed.
 35. sharded serving of the other families at world size 1
     (`phase_serve_mesh_families`, `P35_MODELS`): zamba2-1.2b (2 x 4,096
     tokens into 4,112-position K/V caches, 16 greedy steps),
     whisper-small (2 x 4,096 audio frames, 32 greedy steps from start
     token 0) and rwkv6-7b (2 x 2,048 tokens, 16 greedy steps), each at
     full width and depth with seeded bf16 weights, through
     `make_prefill_step(cfg, "kernel", cache_len=)` and `make_serve_step`
     on the plain path and then with the parameters on `make_host_mesh(1,
     1)` (one NCCL group of world size 1) under `activation_sharding`:
     logits, every cache leaf and the greedy tokens bitwise, kernel 1's
     launches a prefill 7 / 12 / 0 on both paths, all on tensor cores,
     no decode kernel; walls a step printed for both paths.
 36. the examples on the card (`examples_torch/`, each through its own
     entry point with the counters zeroed before it and read after): a.
     `quickstart.main(["--backend", "kernel"])`: kernel vs reference and
     gather vs reference within 5e-5 x max(1, max |ref|), kernel 1 twice
     on the split route with its pre-pass (f32, 64 x 64 blocks, D 64
     padded to 128), kernels 2-3 once each on `sla_bwd.cu` (f32), its
     FLOPs dict equal to the host's; b-c. `serve_lm`, `serve_stream`
     (greedy tokens equal to the static engine's) and `serve_routing`
     (learned routing at identity init emits the threshold router's
     tokens) at their
     reference sizes, then `ablations` at its defaults, each with its own
     assertions and no SLA kernel launch (gather and reference backends),
     walls printed; d. `finetune_dit` at the 100m preset's widths and depth
     (12 layers, d_model 768, 12 heads of 64, d_ff 3,072, 4,096 tokens)
     through its `build` and `train` on the kernel backend, bf16 compute
     over f32 masters: pretrain with full attention, then fine-tune a copy
     in each of sla, sparse_only, linear_only and l_plus_s; at every step
     the launches (sla: 12 / 12 / 12 of kernels 1 / 2 / 3 at 32 x 32
     blocks, all on the tensor-core "tc32" routes, none on `sla_fwd.cu`
     or `sla_bwd.cu`; every other mode none), a finite loss, wall and
     peak memory (the sla steps' wall printed on its own line), then
     torch.profiler over one more sla step (the third of three on the
     fine-tuned copy): its wall, device time, the device's busy share and
     the top device ops by time; the first sla step's
     kernel loss within 5e-2 x max(1, |loss|) of the gather backend's on
     the same params and batch; the example's quality table and its "SLA
     best among accelerated modes" line printed, not held (the reference's
     example does not assert them). Cuts, printed: the preset's batch 32
     to `FT_BATCH`, its steps to `FT_PRETRAIN_STEPS` + `FT_FINETUNE_STEPS`
     a mode. e. kernels 1-3 at the finetune's shape (BH = batch x 12, N
     4,096, D 64, 32 x 32 blocks, bf16, K 13 from `plan_attention` on
     seeded q and k) against their twins on their "tc32" routes
     (`cases.tc_criterion`, kernel 1's O^l within 5e-5 x max(1, max
     |twin|), two launches bitwise equal), timed beside their bounds
     (operations at the route's peak, and the f32-FMA peak), with kernel
     1's f32-FMA kernel forced beside it (held within 5e-5, timed in the
     same call), the CTAs an SM of the "tc32" kernels, and phase 7's
     library call at that shape:
     compiled flex_attention on a BlockMask of the same LUT, its forward
     (O^s and L only) and its backward (dQ, dK and dV together; its bf16
     gradients' error reported) and the ratio of kernels 2 + 3 to its
     backward, with the card's name and power limit.
 37. decode-time SLA over the mesh's path at world size 1
     (`phase_serve_mesh_sla`): a. full-width Qwen3-1.7B with seeded bf16
     weights, 2 prompts of 32,000 tokens seeded by
     `prefill(decode_max_len=32768)` on the kernel backend (15.0 GB of
     per-block h_j beside 7.5 GB of K/V) and 72 greedy `decode_step`s on
     the kernel backend, crossing the block boundaries at 32,000 and
     32,064, on the plain path (its final leaves kept on the host) and
     then with the parameters on `make_host_mesh(1, 1)` (NCCL, world size
     1) under `activation_sharding`: logits, greedy tokens and every leaf
     of the cache and of its "sla" state bitwise, compared a layer at a
     time; 28 tensor-core launches of kernel 1 a prefill and 28 of kernel
     4 a step on both paths, none of its partial mode (a one-rank mesh is
     layout A); walls a step printed for both. b. kernel 4's partial mode
     (`sla_decode_partial`) over the mesh run's layer-0 live state with a
     seeded query, cut into 4 and 16 spans as ranks of layouts B and C
     hold them: each span's records against the twin's (5e-5 x max(1, max
     |twin|), field by field), two launches bitwise equal, the spans'
     records combined across spans (`sla_decode.sla_decode_combine`) against
     unsplit kernel 4 (5e-5 x max(1, max |o|)); CUDA-graph times of the
     spans' launches and of unsplit kernel 4, the bytes bound, the card's
     name and power limit.
 38. DiT serving over the mesh's path at world size 1
     (`phase_dit_serve_mesh`, run just after phase 4 on its model:
     full-width Wan2.1-1.3B, 30 layers, f32, 32,768 tokens, kernel
     backend): a. `dit.sample` of 4 steps with adaptive refresh (drift
     threshold 0.3) at batch 1 with a seeded text condition, on the plain
     path and then on a copy of the parameters on `make_host_mesh(1, 1)`
     (NCCL, world size 1) inside `activation_sharding`: latents, trace and
     every plan leaf of every forward bitwise; b. phase 4's trace (3
     requests, t_start 1.0 / 0.75 / 1.0, 4 steps, 2 slots) through a
     `DiffusionScheduler` on that copy in the same scope: every request's
     final latent bitwise phase 4's and the plan counters equal; 30
     launches of kernel 1 a forward, all on the split route with one
     pre-pass launch each. Each request's latency on both paths and the
     card's name and power limit printed.
 39. continuous-batching decode over the mesh's path at world size 1
     (`phase_slots_mesh`, run just after phase 37 on its model and
     state), each path on the plain path and then on a copy of the
     parameters on `make_host_mesh(1, 1)` (NCCL, world size 1) under
     `activation_sharding`, bitwise: b. from phase 37's state advanced to
     8 tokens short of a block boundary, one `decode_chunk` of 16 seeded
     tokens (every leaf it writes compared), and 16 `decode_step`s on
     them within phase 19's logit limit; d. learned routing (a seeded
     random scorer a layer) in 16 `decode_step`s across that boundary;
     a. a per-slot cache of two slots (max_len 32,768): prompts of 32,000
     and 30,976 tokens (whole 64-token blocks) admitted with `insert_slot`
     after batch-1 prefills at steps 0 and 4, 72 greedy steps, logits and
     every leaf of the cache and of its "sla" state bitwise; kernel 4 one
     launch a layer a step (a chunk: a layer), kernel 1 28 tensor-core
     launches a prefill; c. kernel 4's partial mode over layer 0's
     operands of b's chunk (C = 16, per-token rows and diagonal partials)
     and of a's last step (each slot's rows at its own position), cut
     into 4 and 16 spans, as 37b, with the card's name and power limit.
 40. paged caches and chunked admission over the mesh's path at world
     size 1 (`phase_paged_mesh`, run just after phase 39 on phase 37's
     model, `col_capacity_factor` lifted as the paged Scheduler lifts
     it), each path on the plain path and then on a copy of the
     parameters on `make_host_mesh(1, 1)` (NCCL, world size 1) under
     `activation_sharding`, bitwise: a. a paged cache of two slots (536
     pages) whose 32,000-token prompts share their first 30,720 tokens
     (480 pages), admitted with `insert_slot_paged` after batch-1
     prefills at steps 0 and 4, slot 0's shared page of block 1 copied on
     write at step 8, a fresh zeroed page whenever a slot enters a block,
     72 greedy steps across the block boundaries at 32,000 and 32,064:
     logits and every leaf (pools, page table, "sla" state) bitwise;
     kernel 5 one launch a layer a step, kernel 1 28 tensor-core launches
     a prefill; c. kernel 5's partial mode (`sla_decode_paged_partial`)
     over the mesh run's layer-0 paged state with a seeded query, cut
     into 4 and 16 spans: each span's records against the twin's (5e-5 x
     max(1, max |twin|), field by field), bitwise kernel 4's partial mode
     on the page-gathered view of the span, two launches bitwise equal,
     the spans combined against unsplit kernel 5; CUDA-graph times of 20
     calls, the bytes bound, the card's name and power limit; b. slot 0's
     prompt admitted in 4 chunks of 8,000 tokens (`prefill_chunk`,
     `finalize_chunked_prefill`): the last chunk's logits and every
     finalized leaf bitwise, the plain run within phase 18's limits of
     a's blocking prefill (logits and the prompt's K/V), kernel 1 28
     tensor-core launches a chunk, the carry's bytes a rank.
 31. the kernels line (JSON): `sla_fwd` carries the split route's fields
     at the top (the f32 serving route) and the f32-FMA and bf16
     tensor-core routes' beside them, kernels 1-3 the D-64 cases of
     phases 23, 24 and 29 (`d64_cases`), kernels 1-5 their D-256 cases,
     kernels 1-3 phase 30's (`gemma3_train_cases`) and phase 36e's
     (`finetune_cases`), kernels 1-3 their "tc32" route's launches, time,
     bound and library time (`*_tc32`); every kernel the head
     dims its launches on the main paths
     ran at (`head_dims`, `head_dims_by_path`: what its wrapper recorded
     after padding, zeroed with the counters before each path) and,
     apart, those of the archs it served (`arch_head_dims`);
     `sla_fwd_split_planes` is the split route's pre-pass; `sla_decode`
     and `sla_decode_paged` carry their partial modes' fields and
     counters under `partial`; then the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

from repro_torch.configs import DIT_SHAPES, get_arch, get_shape  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import flops as flops_lib  # noqa: E402
from repro_torch.core.phi import phi  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core.block_sparse_xla import sla_forward_gather  # noqa: E402
from repro_torch.data.pipeline import DataConfig, latent_batch  # noqa: E402
from repro_torch.data.pipeline import make_iterator  # noqa: E402
from repro_torch.distributed import ctx as actx  # noqa: E402
from repro_torch.core import backends as backend_lib  # noqa: E402
from repro_torch.kernels import _build, ops, sla_bwd, sla_fwd  # noqa: E402
from repro_torch.kernels import cases, sla_decode  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import dit, encdec, hybrid  # noqa: E402
from repro_torch.models import linear_scan, rwkv6  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402
from repro_torch.serving.diffusion import (DenoiseParams,  # noqa: E402
                                           DiffusionScheduler)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from examples_torch import ablations, finetune_dit, quickstart  # noqa: E402
from examples_torch import serve_lm, serve_routing, serve_stream  # noqa: E402

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
# LM training (phase 21): qwen3-1.7b's train_4k, global batch 256 cut to 1
LT_STEPS, LT_BATCH, LT_SEQ = 3, 1, 4096
LT_LOSS_TOL = 5e-2  # kernel vs gather loss, relative to max(1, |loss|)
LT_PROBES = ("layers.0.wq", "layers.27.sla_proj", "embed")
# MoE serving (phase 22): 2 prompts of ~4,000 tokens (8K context cut) in a
# 4,032-token bucket, batch 2 (decode_32k's 128 cut), 32 new tokens
MOE_ARCH, MOE_BATCH, MOE_MAX_LEN, MOE_NEW = ("moonshot-v1-16b-a3b", 2,
                                             4096, 32)
MOE_PROMPTS = (4000, 3980)
# the recurrent and encoder-decoder families (phases 23-25): zamba2's and
# whisper's train_4k with the global batch 256 cut to 1; zamba2 served by
# prefill of 2 x 4,096 tokens and 16 decode steps, whisper by prefill of
# 2 x 4,096 frames and 32 decode steps, rwkv6 (bf16 weights) by prefill of
# 2 x 2,048 tokens and 16 decode steps
HY_ARCH, HY_STEPS, HY_BATCH, HY_SEQ = "zamba2-1.2b", 3, 1, 4096
HY_PROBES = ("layers.0.in_proj", "shared_attn.sla_proj", "embed")
HY_PREFILL, HY_NEW = 2, 16
ED_ARCH, ED_STEPS, ED_BATCH, ED_FRAMES = "whisper-small", 3, 1, 4096
ED_PROBES = ("enc.0.wq", "enc.11.sla_proj", "embed")
ED_PREFILL, ED_NEW = 2, 32
RW_ARCH, RW_BATCH, RW_PROMPT, RW_NEW = "rwkv6-7b", 2, 2048, 16
FAM_LOSS_TOL = 5e-2  # kernel vs gather loss and decode vs forward logits
# head dim 256, sliding-window attention and the VLM prefix (phases 26-29):
# kernel 1 at gemma3's prefill shape; gemma3 served static (prefill_32k's
# batch 32 cut to 2, 64 new) and paged (4 prompts of 8,000 sharing 6,144,
# 16 new); danube served static with dense decode (2 x 32,000, 32 new);
# internvl2 trained at train_4k (batch 256 cut to 1)
D256_N, D256_K, D192_N = 32768, 26, 4096
D256_DECODE_POS, D256_PAGED_POS = 300 * 64 + 32, 500 * 64 + 32
G3_ARCH, G3_BATCH, G3_PROMPT, G3_NEW = "gemma3-1b", 2, 32000, 64
G3_PG_SLOTS, G3_PG_PROMPT, G3_PG_SHARED, G3_PG_NEW = 4, 8000, 6144, 16
G3_PG_MAX_LEN = 8192
DN_ARCH, DN_BATCH, DN_PROMPT, DN_NEW = "h2o-danube-3-4b", 2, 32000, 32
VL_ARCH, VL_STEPS, VL_BATCH = "internvl2-1b", 3, 1
# gemma3 training (phase 30): train_4k with its global batch 256 cut to 1
G3T_STEPS, G3T_BATCH = 3, 1
# the mesh path (phase 32): phase 21's first LT_STEPS steps over a 1 x 1
# DeviceMesh, and the train CLI's sharded checkpoint resume at smoke qwen3
MESH_CLI_STEPS, MESH_CLI_EVERY = 4, 2
# the other families over the mesh (phase 33): LT_STEPS steps of train_4k
# at batch 1 each on the plain path and over a 1 x 1 DeviceMesh; zamba2
# and whisper at full depth, Moonlight and rwkv6 at full width with the
# depth cut to what two runs' training state fits on one card (arch,
# layers or None for the full depth, seed)
P33_MODELS = (("zamba2-1.2b", None, 0), ("whisper-small", None, 1),
              ("moonshot-v1-16b-a3b", 4, 2), ("rwkv6-7b", 4, 3))
# sharded serving (phase 34): Qwen3-1.7B in bf16, 2 prompts of 32,000
# tokens (decode_32k's batch 128 cut to 2) into 32,768-position caches,
# P34_NEW dense decode steps, on the plain path and over a 1 x 1 mesh;
# then the flash-decoding functions over layer 0's cache cut into spans
P34_BATCH, P34_PROMPT, P34_MAX_LEN, P34_NEW = 2, 32000, 32768, 16
P34_DRIFT = 0.3  # the plan-reusing prefill's drift threshold (phase 34b)
P34_SPANS = (4, 16)
# sharded serving of the other families (phase 35), each at full width and
# depth with bf16 weights on the plain path and over a 1 x 1 mesh: (arch,
# batch, prompt tokens or audio frames, K/V positions or None for the
# family's own sizing, greedy decode steps, seed)
P35_MODELS = (("zamba2-1.2b", 2, 4096, 4112, 16, 35),
              ("whisper-small", 2, 4096, None, 32, 36),
              ("rwkv6-7b", 2, 2048, None, 16, 37))
# the examples (phase 36): the quickstart's errors held as its kernel
# backend's outputs; finetune_dit at the 100m preset's widths and depth,
# its batch of 32 cut to 2 (the sparse_only and l_plus_s modes' dense f32
# (B, 12, 4096, 4096) scores peak at 72-73 GiB at batch 2 and run out of
# memory at 3), and its 150 pretraining and 150 fine-tuning steps a mode
# cut to 40 and 30: at 150 + 150 the phase took 454 s and the script
# 1,206 s on a card whose host ran the earlier phases 1.3x slower than
# usual (PERF.md §6)
QS_TOL = TWIN_TOL
# decode-time SLA over the mesh (phase 37): Qwen3-1.7B in bf16, 2 prompts
# of 32,000 tokens (decode_32k's batch 128 cut to 2) seeded by
# prefill(decode_max_len=32,768) and P37_NEW greedy decode_step's that
# cross the block boundaries at 32,000 and 32,064, on the plain path and
# over a 1 x 1 mesh; then kernel 4's partial mode over layer 0's live state
# cut into spans (layout B's 4 "model" ranks, 16 as a 4 x 4 layout C)
P37_BATCH, P37_PROMPT, P37_MAX_LEN, P37_NEW = 2, 32000, 32768, 72
P37_SPANS = (4, 16)
# DiT serving over the mesh (phase 38): Wan2.1-1.3B at full width and
# depth in f32 on the kernel backend; `dit.sample` of P38_STEPS steps with
# adaptive refresh at drift threshold P38_DRIFT on a batch of 1, then
# phase 4's trace (MAIN_T_STARTS through MAIN_SLOTS slots), each on the
# plain path and over a 1 x 1 mesh
P38_STEPS, P38_DRIFT = 4, 0.3
P38_COUNTERS = ("admissions", "denoise_steps", "plan_builds", "plan_replans",
                "plan_reuses", "last_retention")
# continuous-batching decode over the mesh (phase 39), on phase 37's model
# and state: a per-slot cache of two slots whose prompts (whole 64-token
# blocks) arrive at different steps, decode_chunk and learned routing
P39_PROMPTS, P39_ADMIT, P39_NEW = (32000, 30976), (0, 4), 72
P39_C = 16  # decode_chunk's tokens (39b) and learned routing's steps (39d)
# paged caches and chunked admission over the mesh (phase 40), on phase
# 37's model: a paged cache of two slots whose 32,000-token prompts share
# their first 30,720 tokens (480 whole pages), slot 1 admitted at step 4,
# slot 0's page of block 1 copied on write at step 8, P37_NEW greedy
# steps crossing the block boundaries at 32,000 and 32,064; slot 0's prompt
# admitted again in PC_CHUNK_BLOCKS chunks. Pages: 0 the zero page, 1-2
# the slots' scratch pages, then the prompts', the copy, the decode pages
P40_ADMIT, P40_SHARED, P40_COW_STEP = (0, 4), 30720, 8
P40_POOL = 536
FT_CASE_KEYS = ("shape", "dtype", "route", "bh", "n", "d", "k_sel",
                "live_tiles", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_fraction", "bound_ms_f32_fma", "max_abs_err", "ok",
                "library_ms")
# and the backward's on the tc32 route
FT_TC32_KEYS = ("bitwise_repeat", "rounded_err", "limit", "prep_ms",
                "ctas_per_sm", "dq_plus_dkv_ms", "ratio_to_library")
# and the forward's, with the f32-FMA kernel forced beside it
FT_FWD_TC32_KEYS = ("bitwise_repeat", "rounded_err", "limit", "o_l_err",
                    "o_l_limit", "ctas_per_sm", "ms_fma", "fma_max_abs_err",
                    "ratio_to_flex_fwd")
# phase 36e's compiled flex_attention times beside a finetune case
FT_FLEX_KEYS = ("flex_sparse_branch_fwd_ms", "library_fwd_ms",
                "library_err", "library_error")
FT_PRESET, FT_BATCH, FT_LR, FT_SEED = "100m", 2, 3e-4, 0
FT_PRETRAIN_STEPS, FT_FINETUNE_STEPS = 20, 15
FT_MODES = ("sla", "sparse_only", "linear_only", "l_plus_s")
DEV = torch.device("cuda")
CARD: list = []  # nvidia-smi's name and power limit (phase 1)


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
    CARD.append(card)
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


def _operands(sla, q, k, v, marginal, lut, counts, dtype, causal=False):
    """The kernel's flattened operands in `dtype` for one plan's
    (B, H, ...) marginal / lut / counts, with hi/zi aggregated as the
    kernel backend does, plus the 4-D inputs for the backends."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi(q, sla.phi), phi(k, sla.phi)
    fq, fk, fv, fqp, fkp = map(ops._flat, (q, k, v, qp, kp))
    a, lut, counts = map(ops._flat, (marginal, lut, counts))
    hb, zb = ops._hz_blocks(fkp, fv, sla.block_kv)
    hi, zi = ops._aggregate(a, hb, zb)
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal,
              block_q=sla.block_q, block_kv=sla.block_kv)
    return args, kw, (q, k, v, qp, kp)


def _bound(args, kw, route=None):
    """Least time for this call on `route` (default: the one
    `sla_fwd.forward_route` picks): the larger of bytes (each input read
    once, each output written once) over HBM bandwidth and this data's
    operations (live critical tiles + linear merge) at the card's peak
    for the operands' type: bf16 operands all at 989 TFLOP/s (bf16
    tensor cores) whatever route runs them; f32 operands all at 67 on
    the f32-FMA route, and on the split route the tile products six
    times at 989 (its six bf16 part products) plus the linear merge's f32
    FMAs at 67."""
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
    elif q.dtype == torch.bfloat16:
        t_ops = flops / PEAK_FLOPS[torch.bfloat16]
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
FWD_TC32_ROUTE = ("tensor cores at 32 x 32 blocks, mma.sync m16n8k16 "
                  "(sla_fwd_tc32.cu)")
FWD_ROUTES = {"tc": FWD_TC_ROUTE, "tc32": FWD_TC32_ROUTE,
              "split": FWD_SPLIT_ROUTE, "fma": FWD_F32_ROUTE}


def _fwd_counters():
    return (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES, sla_fwd.SPLIT_LAUNCHES,
            sla_fwd.PLANES_LAUNCHES, sla_fwd.TC32_LAUNCHES)


def _head_dim_records() -> dict:
    """Each kernel's wrapper record: its launches by the head dim the
    kernel ran at (after the wrapper's padding)."""
    return {"sla_fwd": sla_fwd.HEAD_DIMS,
            "sla_fwd_split_planes": sla_fwd.PLANES_HEAD_DIMS,
            "sla_bwd_dq": sla_bwd.HEAD_DIMS_DQ,
            "sla_bwd_dkv": sla_bwd.HEAD_DIMS_DKV,
            "sla_decode": sla_decode.HEAD_DIMS,
            "sla_decode_paged": sla_decode.PAGED_HEAD_DIMS,
            "sla_decode_partial": sla_decode.PARTIAL_HEAD_DIMS,
            "sla_decode_paged_partial": sla_decode.PAGED_PARTIAL_HEAD_DIMS}


# kernel -> main path -> the head dims its launches there ran at
PATH_HEAD_DIMS: dict = {name: {} for name in _head_dim_records()}


def _zero_head_dims():
    """Clear the wrappers' head-dim records, with the launch counters,
    just before a main path runs."""
    for rec in _head_dim_records().values():
        rec.clear()


def _read_head_dims(path: str):
    """Keep under `path` the head dims each kernel launched at since
    `_zero_head_dims`, read just after the path ran."""
    for name, rec in _head_dim_records().items():
        if rec:
            PATH_HEAD_DIMS[name].setdefault(path, set()).update(rec)


def _head_dim_snapshot():
    """A copy of the records, to restore after launches made only to
    compare a kernel with its twin inside a path."""
    return {name: rec.copy() for name, rec in _head_dim_records().items()}


def _restore_head_dims(snap):
    for name, rec in _head_dim_records().items():
        rec.clear()
        rec.update(snap[name])


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
    printed beside it). The tensor-core routes ("tc" at 64 x 64 blocks,
    "tc32" at 32 x 32): (o_s, lse) by `cases.tc_criterion` against the f32
    twin and the twin that rounds P to bf16, o_l (f32 arithmetic on every
    route) within 5e-5 x max(1, max |twin|). The split and tensor-core
    routes: a second launch bitwise equal to the first. Raises on a
    non-finite output or when the route's counters did not move as they
    should."""
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
    if moved != (1, int(route == "tc"), split, split, int(route == "tc32")):
        raise RuntimeError(f"sla_fwd {what}: counters (launches, tc, split, "
                           f"planes, tc32) moved {moved} on the {route} "
                           f"route")
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
    return dict(route=FWD_ROUTES[route], **res)


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
    where = "tensor cores" if c["route"] == FWD_TC_ROUTE else "tc32"
    return (f"{where}: max abs err o_s {e[0]:.3g} lse {e[2]:.3g} vs f32 "
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


def _gqa_fwd_operands(h, group, n, d, base, seed, causal=True, block=None):
    """The forward's bf16 operands for a span of query blocks from block
    `base` to the end (causal) or every query block (`base` 0) against
    the full KV with GQA (h // group kv heads) at 64 x 64 blocks (or
    `block` x `block`): a plan of seeded q/k, h_j and z_j per kv head
    repeated to the query heads and aggregated per query head (the
    marginal set is per query head)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device=DEV)
    k, v = (torch.randn((1, h // group, n, d), generator=gen, device=DEV)
            for _ in range(2))
    sla = get_arch("wan2_1_1_3b").sla.replace(causal=causal)
    if block is not None:
        sla = sla.replace(block_q=block, block_kv=block)
    plan = plan_lib.plan_attention(q, k, sla)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    fq, fk, fv = map(ops._flat, (q, k, v))
    fqp = ops._flat(phi(q, sla.phi))
    hb, zb = ops._hz_blocks(ops._flat(phi(k, sla.phi)), fv,
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
    return args, dict(scale=d ** -0.5, causal=causal, block_q=sla.block_q,
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
    # 32 x 32 blocks: f32 on sla_fwd.cu, bf16 on the "tc32" route (D 108
    # padded to 128) with sla_fwd.cu forced beside it
    arch, h, n, d = SHAPES["lightningdit_1b"]
    sla, q, k, v, plan = _kernel_inputs(arch, h, n, d, seed=3, block=32)
    for dtype in (torch.float32, torch.bfloat16):
        args, kw, _ = _operands(sla, q, k, v, plan.marginal, plan.lut,
                                plan.counts, dtype)
        rows.append(_fwd_case("lightningdit_1b 32x32 blocks", args, kw))
        if dtype == torch.bfloat16:
            rows.append(_fwd_case("lightningdit_1b 32x32 blocks", args, kw,
                                  plain=False, route="fma"))
    if [r["route"] for r in rows[-3:]] != [FWD_F32_ROUTE, FWD_TC32_ROUTE,
                                           FWD_F32_ROUTE]:
        raise RuntimeError(f"the 32 x 32 cases left their routes: "
                           f"{[r['route'] for r in rows[-3:]]}")
    del args, q, k, v, plan
    h, n, d = SHAPES["wan2_1_1_3b"][1], 4096, 128
    args, kw = _gqa_fwd_operands(h, 2, n, d, base=32, seed=6)
    rows.append(_fwd_case("causal GQA-2 base 32", args, kw))
    del args
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its plain twin: {bad}")
    return rows, planes


def _fwd_case(shape, args, kw, plain=True, route=None,
              tag="3 kernel") -> dict:
    """Check and time the forward kernel of `route` (default: the rule's)
    on one extra case of phase 3 (or of the phase `tag` names)."""
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
    say(f"[{tag}] {shape} {dname} (BH={args[2].shape[0]}, BH_kv="
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


def _main_requests(cfg) -> list:
    """The main path's requests: (latent, text condition, t_start) each,
    drawn from a seeded generator in that order."""
    rs = np.random.default_rng(0)
    return [(rs.standard_normal((MAIN_SEQ, cfg.patch_dim), dtype=np.float32),
             rs.standard_normal((cfg.cond_len, cfg.d_model),
                                dtype=np.float32), t_start)
            for t_start in MAIN_T_STARTS]


def phase_main_path(cfg, params):
    sched = DiffusionScheduler(cfg, params, num_slots=MAIN_SLOTS,
                               seq_len=MAIN_SEQ, backend="kernel",
                               compute_dtype=torch.float32, device=DEV)
    for lat, cond, t_start in _main_requests(cfg):
        sched.submit(lat, DenoiseParams(num_steps=MAIN_STEPS,
                                        t_start=t_start), cond=cond)
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
    _zero_head_dims()
    dit.forward = counted_forward
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = orig_forward
    wall = time.time() - t0
    launches, tc_launches, split_launches, planes_launches, _ = \
        _fwd_counters()
    _read_head_dims("serve")
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
                plan_reuses=st.plan_reuses,
                results=[r.result for r in done],
                counters={k: getattr(st, k) for k in P38_COUNTERS})


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
    _zero_head_dims()
    dit.forward = counted_forward
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = orig_forward
    wall = time.time() - t0
    launches, tc_launches, split_launches, planes_launches, _ = \
        _fwd_counters()
    _read_head_dims("serve_plan_cache")
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
def _bwd_operands(sla, q, k, v, leaves, dtype, seed: int, causal=False):
    """Operands of both backward kernels for one plan's (B, H, ...)
    leaves (marginal, lut, counts, col_lut, col_counts) in `dtype`: L and
    O^s from the forward kernel on the same inputs, a seeded dO^s and
    D = rowsum(dO^s * O^s). Returns (dq args, dkv args, keywords)."""
    marginal, lut, counts, col_lut, col_counts = leaves
    args, kw, _ = _operands(sla, q, k, v, marginal, lut, counts, dtype,
                            causal)
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
TC32_ROUTE = ("tensor cores at 32 x 32 blocks, mma.sync m16n8k16 "
              "(sla_bwd_tc32.cu)")
F32_ROUTE = "f32 FMA on CUDA cores (sla_bwd.cu)"
BWD_ROUTES = {"tc": TC_ROUTE, "tc32": TC32_ROUTE, "fma": F32_ROUTE}


def _route_launches(name: str) -> tuple:
    """The backward kernel `name`'s launches on the "tc" and "tc32"
    routes."""
    if name == "sla_bwd_dq":
        return sla_bwd.TC_LAUNCHES_DQ, sla_bwd.TC32_LAUNCHES_DQ
    return sla_bwd.TC_LAUNCHES_DKV, sla_bwd.TC32_LAUNCHES_DKV


def _bwd_check(name, args, kw, what: str) -> dict:
    """Kernel against its twin on the same card operands. The f32-FMA
    route: max abs error against 5e-5 x max(1, max |twin|). The
    tensor-core routes ("tc" at 64 x 64 blocks, "tc32" at 32 x 32,
    `sla_bwd.backward_route`): `cases.tc_criterion` against the f32 twin
    and the twin that rounds dO, P and dS to bf16. On all, a second
    launch bitwise equal to the first. Raises on a non-finite output or
    when the routes' counters did not move as the rule says."""
    kernel, plain, _ = BWD[name]
    q = args[2]
    route = sla_bwd.backward_route(q.dtype, kw["block_q"], kw["block_kv"],
                                   q.shape[-1])
    before = _route_launches(name)
    got = kernel(*args, **kw)
    launched = tuple(a - b for a, b in zip(_route_launches(name), before))
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    expected = (int(route == "tc"), int(route == "tc32"))
    if launched != expected:
        raise RuntimeError(f"{name} {what}: (tc, tc32) launches "
                           f"{launched}, expected {expected}")
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise RuntimeError(f"{name} {what}: non-finite output")
    again = kernel(*args, **kw)
    again = (again,) if torch.is_tensor(again) else again
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    if route == "fma":
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        limit = TWIN_TOL * max(1.0, max(float(w.abs().max())
                                        for w in want))
        return dict(route=F32_ROUTE, max_abs_err=err, limit=limit,
                    bitwise_repeat=bitwise, ok=err <= limit and bitwise)
    rounded = plain(*args, **kw, mma_dtype=torch.bfloat16)
    res = cases.tc_criterion(got, want, rounded)
    res["bitwise_repeat"] = bitwise
    res["ok"] = res["ok"] and res["bitwise_repeat"]
    return dict(route=BWD_ROUTES[route], **res)


def _check_text(c: dict) -> str:
    if c["route"] == F32_ROUTE:
        return (f"max abs err {c['max_abs_err']:.3g} (limit "
                f"{c['limit']:.3g}), bitwise repeat {c['bitwise_repeat']} "
                f"{'OK' if c['ok'] else 'FAIL'}")
    where = "" if c["route"] == TC_ROUTE else " at 32 x 32"
    return (f"tensor cores{where}: max abs err {c['max_abs_err']:.3g} vs "
            f"f32 twin (rounded twin {c['rounded_err']:.3g}, limit "
            f"{c['limit']:.3g}), bitwise repeat {c['bitwise_repeat']} "
            f"{'OK' if c['ok'] else 'FAIL'}")


def _gqa_bwd_operands(h, group, n, d, seed, causal, dtype=torch.bfloat16,
                      arch="wan2_1_1_3b", block=None):
    """Both backward kernels' operands in `dtype` for GQA (h // group kv
    heads) at `arch`'s blocks (or `block` x `block`): a plan of seeded
    q/k, L and O^s from the forward kernel, a seeded dO. Returns (dq
    args, dkv args, keywords, (q, k, v, plan) as f32 (1, H, N, D) tensors
    and the plan)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device=DEV)
    k, v = (torch.randn((1, h // group, n, d), generator=gen, device=DEV)
            for _ in range(2))
    sla = get_arch(arch).sla.replace(causal=causal)
    if block is not None:
        sla = sla.replace(block_q=block, block_kv=block)
    plan = plan_lib.plan_attention(q, k, sla)
    fq, fk, fv = (ops._flat(x.to(dtype)) for x in (q, k, v))
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
            (ops._flat(plan.col_lut), ops._flat(plan.col_counts)) + tail, kw,
            (q, k, v, plan))


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


def _flex_block_mask(lut, counts, n: int, block: int, causal=False):
    """flex_attention's BlockMask for one plan's (B, H, Tm, K) row LUT:
    each query block's live LUT entries as full blocks (no mask_mod
    inside them), except, when `causal`, the diagonal block, a partial
    block under the causal mask_mod. Its column side, which flex's
    backward walks for dK/dV, is derived by BlockMask itself."""
    from torch.nn.attention.flex_attention import BlockMask
    b, h, tq, k = lut.shape
    slots = torch.arange(k, device=lut.device)
    live = slots < torch.clamp(counts, max=k)[..., None]
    diag = live & causal & (lut == torch.arange(tq, device=lut.device)
                            [:, None])

    def packed(sel):
        """(count, indices): the selected LUT entries moved to the front
        of a (B, H, Tm, N / block) index table."""
        order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)
        num = sel.sum(dim=-1, dtype=torch.int32)
        idx = torch.zeros((b, h, tq, n // block), dtype=torch.int32,
                          device=lut.device)
        idx[..., :k] = torch.where(slots < num[..., None],
                                   torch.gather(lut, -1, order), 0)
        return num, idx

    def causal_mod(b, h, q_idx, kv_idx):
        return q_idx >= kv_idx

    return BlockMask.from_kv_blocks(
        *packed(diag), *packed(live & ~diag), BLOCK_SIZE=block,
        mask_mod=causal_mod if causal else None, seq_lengths=(n, n))


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


def _flex_library(q, k, v, do, lut, counts, block: int, dq, dk, dv,
                  causal=False):
    """The library call for both backward kernels: compiled flex_attention
    on a BlockMask of the same row LUT computes the sparse branch O^s and,
    through autograd, the same dQ, dK and dV as sla_bwd_dq and sla_bwd_dkv
    together (scale D^-0.5, its own rowsum(dO * O^s) inside; `causal`
    masks the diagonal blocks). q, k, v are (1, H, N, D), k and v
    repeated to the H query heads for GQA, as the kernels' dk and dv are
    per query head; do and the kernels' dq, dk, dv are (H, N, D). Returns
    the CUDA-event times of its forward and forward+backward, their
    difference as the backward's time, and the max abs error of its
    gradients against the kernels' with its limit 1e-4 x max(1, max |g|)
    (flex's gradients come out in the inputs' dtype)."""
    if not _FLEX:
        from torch.nn.attention.flex_attention import flex_attention
        _FLEX.append(torch.compile(flex_attention))
    flex = _FLEX[0]
    mask = _flex_block_mask(lut, counts, q.shape[-2], block, causal)
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
                            lut, counts, sla.block_kv, dq, dk, dv,
                            kw["causal"])
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


def _bwd_case(shape, dname, dq_args, dkv_args, kw, n, d, extra,
              tag="7 bwd"):
    """Check and time both backward kernels on one case's operands."""
    rows = []
    for name, args in (("sla_bwd_dq", dq_args), ("sla_bwd_dkv", dkv_args)):
        kernel, plain, _ = BWD[name]
        c = _bwd_check(name, args, kw, f"{shape} {dname}")
        ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 2, warmup=1)
        bound_ms, bound_by, flops, nbytes, live = _bwd_bound(
            name, args, kw, args[2].dtype)
        if c["route"] != F32_ROUTE:  # the wrapper's dO cast and D padding
            width = (sla_bwd.TC_HEAD_DIM if c["route"] == TC_ROUTE
                     else sla_bwd.tc32_head_dim(d))
            c["prep_ms"] = cuda_ms(lambda: sla_bwd._tc_operands(
                name, *args[2:], width), 10)
        if c["route"] == TC32_ROUTE:
            c["head_dim_run"] = width
            c["ctas_per_sm"] = sla_bwd.ctas_per_sm(name, width)
        say(f"[{tag}] {name} {shape} {dname} (BH={args[2].shape[0]}, "
            f"BH_kv={args[3].shape[0]}, N={n}, D={d}, causal "
            f"{kw['causal']}, LUT width {args[0].shape[-1]}, live tiles "
            f"{live}): {_check_text(c)}")
        say(f"  kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by {bound_by} "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB; "
            f"{bound_ms / ms:.1%} of it) | plain twin {plain_ms:.3f} ms"
            + (f" | of the kernel's time, the wrapper's dO cast and head-dim"
               f" padding {c['prep_ms']:.3f} ms" if "prep_ms" in c else "")
            + (f" | {c['ctas_per_sm']} CTAs an SM at D {c['head_dim_run']}"
               if "ctas_per_sm" in c else "")
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
    """Phase 7. Returns (backward rows, the forward's 32 x 32 rows)."""
    rows, fwd_rows = [], []
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
    dq_args, dkv_args, kw, _ = _gqa_bwd_operands(h, 2, n, d, seed=6,
                                                 causal=True)
    rows += _bwd_case("causal GQA-2", "bf16", dq_args, dkv_args, kw, n, d,
                      {})
    del dq_args, dkv_args
    for d in (64, 128):  # the "tc32" route: the fine-tune's D and the widest
        for causal in (True, False):
            dq_args, dkv_args, kw, _ = _gqa_bwd_operands(
                h, 2, n, d, seed=7 + d + int(causal), causal=causal,
                block=32)
            mode = "causal" if causal else "bidirectional"
            rows += _bwd_case(f"32x32 {mode} GQA-2 D{d}", "bf16", dq_args,
                              dkv_args, kw, n, d, {})
            del dq_args, dkv_args
            # the forward's "tc32" route on the same case's shape
            fargs, fkw = _gqa_fwd_operands(h, 2, n, d, 32 if causal else 0,
                                           seed=9 + d + int(causal),
                                           causal=causal, block=32)
            row = _fwd_case(f"32x32 {mode} GQA-2 D{d}", fargs, fkw,
                            tag="7 fwd")
            row["head_dim_run"] = sla_fwd.tc32_head_dim(d)
            row["ctas_per_sm"] = sla_fwd.tc32_ctas_per_sm(
                row["head_dim_run"])
            fwd_rows.append(row)
            del fargs
    bad = [r for r in rows + fwd_rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"backward kernel disagrees with its plain "
                           f"twin: {bad}")
    tc32 = [r for r in rows if r["shape"].startswith("32x32")]
    if (len(tc32) != 8 or any(r["route"] != TC32_ROUTE for r in tc32)
            or any(r["route"] != FWD_TC32_ROUTE for r in fwd_rows)):
        raise RuntimeError(f"the 32 x 32 bf16 cases left the tc32 routes: "
                           f"{[(r['shape'], r['route']) for r in tc32]}, "
                           f"forward {[r['route'] for r in fwd_rows]}")
    say(f"[7 fwd] the forward's tc32 kernel at D 64 / 128: "
        f"{fwd_rows[0]['ctas_per_sm']} / {fwd_rows[-1]['ctas_per_sm']} CTAs "
        f"an SM")
    return rows, fwd_rows


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
        xs += [phi(xs[0], sla.phi), phi(xs[1], sla.phi)]
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
                _zero_head_dims()
                t0 = time.time()
                params, opt_state, loss, gnorm = step(batch)
                loss, gnorm = float(loss), float(gnorm)
                torch.cuda.synchronize()
                wall = time.time() - t0
                _read_head_dims("train")
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


def _busy(prof, wall_s: float) -> dict:
    """Device time (kernel-level events, as the profiler's own table
    total) and the busy share of `wall_s`."""
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation)
    return dict(wall_s=wall_s, device_s=dev_us / 1e6,
                busy=dev_us / 1e6 / wall_s)


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
def _zero_kernel_counts():
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.TC32_LAUNCHES = 0
    sla_bwd.LAUNCHES_DQ = sla_bwd.LAUNCHES_DKV = 0
    sla_bwd.TC_LAUNCHES_DQ = sla_bwd.TC_LAUNCHES_DKV = 0
    sla_bwd.TC32_LAUNCHES_DQ = sla_bwd.TC32_LAUNCHES_DKV = 0
    _zero_head_dims()


def _kernel_counts(plans: list, path: str) -> dict:
    _read_head_dims(path)
    return dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                sla_bwd_dq=sla_bwd.LAUNCHES_DQ,
                tc_sla_bwd_dq=sla_bwd.TC_LAUNCHES_DQ,
                sla_bwd_dkv=sla_bwd.LAUNCHES_DKV,
                tc_sla_bwd_dkv=sla_bwd.TC_LAUNCHES_DKV,
                plan_builds=len(plans))


def _redraw(gen, projs):
    """Redraw zero-initialized sla_proj tensors so that O^l reaches the
    output."""
    with torch.no_grad():
        for p in projs:
            p.copy_(0.1 * torch.randn(p.shape, generator=gen, device=DEV))


def _lm_model(seed: int):
    """Full-width qwen3-1.7b with random weights from a seeded generator;
    sla_proj (zero-initialized) is redrawn so that O^l reaches the
    logits."""
    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = transformer.init(gen, cfg, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
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

    orig_plan = plan_lib.plan_attention

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
    _zero_head_dims()
    plan_lib.plan_attention = plan_hook
    t0 = time.time()
    try:
        done = engine.run(reqs)
    finally:
        plan_lib.plan_attention = orig_plan
    wall = time.time() - t0
    launches = dict(sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    _read_head_dims("lm_static")
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


def _span_snapshot(cache, pos: int, tokens: int, bkv: int) -> dict:
    """What `tokens` decode-SLA tokens from `pos` write, copied: their
    K/V rows, the h_j blocks they fill and every smaller leaf of the
    decode state (the plan included); `pos` itself."""
    st = cache["sla"]
    rows = slice(pos // bkv, (pos + tokens - 1) // bkv + 1)
    snap = {"pos": cache["pos"],
            "k": cache["k"][..., pos:pos + tokens, :].clone(),
            "v": cache["v"][..., pos:pos + tokens, :].clone(),
            "hblk": st["hblk"][:, :, :, rows].clone(),
            "sla": {name: _clone_cache(leaf) for name, leaf in st.items()
                    if name != "hblk"}}
    return snap


def _span_restore(cache, snap: dict, pos: int, tokens: int, bkv: int):
    """Put `_span_snapshot`'s copy back (copies of it: the snapshot can
    be restored again)."""
    cache["pos"] = snap["pos"]
    cache["k"][..., pos:pos + tokens, :] = snap["k"]
    cache["v"][..., pos:pos + tokens, :] = snap["v"]
    st = cache["sla"]
    st["hblk"][:, :, :, pos // bkv:(pos + tokens - 1) // bkv + 1] = \
        snap["hblk"]
    st.update({name: _clone_cache(leaf) for name, leaf in snap["sla"].items()})


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
        qpg = backend_lib._group_heads(phi(q[:, :, 0], sla.phi),
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
    at = cache["pos"]
    snap = _span_snapshot(cache, at, 1, bkv)
    with torch.no_grad():
        l_k, _ = transformer.decode_step(
            params, cfg, token, cache, backend="kernel",
            drift_threshold=engine.drift_threshold)
        _span_restore(cache, snap, at, 1, bkv)
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
        events = prof.key_averages()
        k4_us, k4_n = _decode_kernel_time(events)
        res["profile"] = p = dict(_busy(prof, time.time() - t0),
                                  kernel_s=k4_us / 1e6, kernel_launches=k4_n)
        say(f"[13 lm profile] 8 decode steps: {p['wall_s']:.3f}s wall under "
            f"the profiler, {p['device_s']:.3f}s device time, device busy "
            f"{p['busy']:.3f} | decode kernels {k4_n} launches, "
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
    qp, kp = phi(q, sla.phi), phi(k, sla.phi)
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
    qpg = backend_lib._group_heads(phi(q[:, :, 0], sla.phi), hkv)
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
    snap = transformer.snapshot_slots(cache, range(PG_SLOTS), cfg)
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
            dims = _head_dim_snapshot()
            _pg_cross_check(cfg, sched, logits, cross)
            (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES,
             sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES) = counts  # not counted
            _restore_head_dims(dims)
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

    def admit_hook(live, single, slot, pids, cfg):
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
        return admit_paged(live, single, slot, pids, cfg)

    sched._one, sched._run_prefill = one_hook, prefill_hook
    sched._claim_page, sched._admit_paged = claim_hook, admit_hook
    for i, (prompt, n) in enumerate(zip(prompts, PG_NEW)):
        sched.submit(prompt, SamplingParams(
            max_new_tokens=n, temperature=0.8 if i == PG_SAMPLED else 0.0,
            seed=3))
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    _zero_head_dims()
    t0 = time.time()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_decode=sla_decode.LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    _read_head_dims("lm_paged")
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
    _zero_head_dims()
    t0 = time.time()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES)
    _read_head_dims("lm_unpaged")
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

    def admit_hook(live, single, slot, pids, cfg):
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
        return admit_paged(live, single, slot, pids, cfg)

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
    _zero_head_dims()
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
    _read_head_dims("lm_chunked")
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
    _zero_head_dims()
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
    _read_head_dims("lm_decode_chunk")
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
        qpg = backend_lib._group_heads(phi(q, cfg.sla.phi), hkv)
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
    _zero_head_dims()
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
    _read_head_dims("lm_disagg")
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
        counts, dims = _dg_counts(), _head_dim_snapshot()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
        _dg_set_counts(counts)
        _restore_head_dims(dims)
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
    _zero_head_dims()
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
    _read_head_dims("lm_disagg")
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


# --------------------------------------------------------------------------
def phase_lm_train(cfg, params, profile: bool):
    """Phase 21: LM training at full Qwen3-1.7B width and depth. The
    kernel-vs-gather loss on one batch, LT_STEPS `loss_fn` steps and one
    `distill_loss_fn` step through `make_train_step` (AdamW, bf16 compute
    over the f32 masters, kernel backend, per-layer remat), kernels 1-3
    against their twins on the last `loss_fn` step's plans of layers 0 and
    27, then the train CLI on the card. Trains `params` in place."""
    nl = cfg.num_layers
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=LT_BATCH)
    data = make_iterator(cfg, shape, DataConfig(seed=0))

    def tensors(batch):
        return {k: torch.from_numpy(x).to(DEV) for k, x in batch.items()}

    batches = [tensors(next(data)) for _ in range(LT_STEPS + 1)]
    # one batch's loss, kernel against gather backend (bf16 compute)
    losses = {}
    with torch.no_grad():
        tree = train_steps.cast_params_bf16(params)
        for backend in ("kernel", "gather"):
            losses[backend] = float(transformer.loss_fn(
                tree, cfg, batches[0], backend=backend))
        del tree
    limit = LT_LOSS_TOL * max(1.0, abs(losses["gather"]))
    diff = abs(losses["kernel"] - losses["gather"])
    say(f"[21 lm train] {LM_ARCH} at full width and depth ({nl} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, vocab {cfg.vocab_size}), train_4k seq "
        f"{shape.seq_len}, batch {LT_BATCH} (global 256 cut) | one batch's "
        f"loss_fn: kernel {losses['kernel']:.6f}, gather "
        f"{losses['gather']:.6f}, diff {diff:.3g} (limit {limit:.3g}) "
        f"{'OK' if diff <= limit else 'FAIL'}")
    if not (np.isfinite(diff) and diff <= limit):
        raise RuntimeError(f"LM loss kernel {losses['kernel']} vs gather "
                           f"{losses['gather']}")
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                total_steps=LT_STEPS + 1)
    step_fns = {False: train_steps.make_train_step(cfg, opt_cfg,
                                                   backend="kernel"),
                True: train_steps.make_train_step(cfg, opt_cfg,
                                                  backend="kernel",
                                                  distill=True)}
    named = dict(params.named_parameters())
    opt_state = adamw.init(named)
    probe = {n: named[n].detach().clone() for n in LT_PROBES}
    plans = []  # this step's, in layer order
    orig_plan = plan_lib.plan_attention

    def counted_plan(*a, **kw):
        plans.append(orig_plan(*a, **kw))
        return plans[-1]

    want = dict(sla_fwd=2 * nl, tc_sla_fwd=2 * nl, sla_bwd_dq=nl,
                tc_sla_bwd_dq=nl, sla_bwd_dkv=nl, tc_sla_bwd_dkv=nl,
                plan_builds=nl)
    rows, totals = [], dict.fromkeys(want, 0)
    plan_lib.plan_attention = counted_plan
    try:
        with actx.activation_sharding(remat=True):
            for i, batch in enumerate(batches):
                distill = i == LT_STEPS
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_kernel_counts()
                t0 = time.time()
                params, opt_state, loss, gnorm = step_fns[distill](
                    params, opt_state, batch)
                loss, gnorm = float(loss), float(gnorm)
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = _kernel_counts(plans, "lm_train")
                peak = torch.cuda.max_memory_allocated() / 2**30
                for key in totals:
                    totals[key] += got[key]
                what = "distill_loss_fn" if distill else "loss_fn"
                say(f"[21 lm train] step {i} ({what}): loss {loss:.6f} grad "
                    f"norm {gnorm:.6f} | {wall:.3f}s | peak {peak:.2f} GiB "
                    f"| launches {got} (expected {want})")
                rows.append(dict(step=i, loss_fn=what, loss=loss,
                                 grad_norm=gnorm, wall_s=wall, peak_gib=peak,
                                 **got))
                if not (np.isfinite(loss) and np.isfinite(gnorm)):
                    raise RuntimeError(f"LM training step {i}: loss {loss}, "
                                       f"grad norm {gnorm}")
                if got != want:
                    raise RuntimeError(f"LM training step {i}: launches "
                                       f"{got}, expected {want}")
                if i == LT_STEPS - 1:
                    step_plans = {li: plans[li] for li in (0, nl - 1)}
                plans.clear()
            prof_res = None
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                torch.cuda.synchronize()
                t0 = time.time()
                with prof_ctx(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    step_fns[False](params, opt_state, batches[0])
                    torch.cuda.synchronize()
                wall = time.time() - t0
                prof_res = _busy(prof, wall)
                prof_res["kernels"] = _kernel_means(
                    prof, ("sla_fwd_tc_kernel", "sla_bwd_dq_tc_kernel",
                           "sla_bwd_dkv_tc_kernel"))
                say(f"[21 lm train profile] one more loss_fn step: "
                    f"{prof_res}")
                say(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25))
    finally:
        plan_lib.plan_attention = orig_plan
    moved = {n: bool((named[n].detach() != probe[n]).any())
             for n in LT_PROBES}
    del opt_state, named, batches
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[21 lm train] {len(rows)} steps: walls "
        f"{[round(r['wall_s'], 3) for r in rows]} s | peaks "
        f"{[round(r['peak_gib'], 2) for r in rows]} GiB | parameters moved "
        f"{moved}")
    if not all(moved.values()):
        raise RuntimeError(f"LM training did not move the parameters: "
                           f"{moved}")
    fwd_rows, bwd_rows = _family_kernel_rows(
        "21 lm train", LM_ARCH, {f"layer {li}": plan
                                 for li, plan in step_plans.items()},
        causal=True, batch=LT_BATCH, n=LT_SEQ)
    del step_plans
    argv = ["--arch", LM_ARCH, "--smoke", "--steps", "3", "--device", "cuda",
            "--log-every", "1"]
    t0 = time.time()
    cli = train_cli.main(argv)
    ok = len(cli) == 3 and bool(np.isfinite(cli).all()) and min(cli) > 0
    say(f"[21 lm train CLI] repro_torch.launch.train {' '.join(argv)}: "
        f"losses {cli} in {time.time() - t0:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"LM train CLI losses {cli}")
    return dict(steps=rows, launches=totals, moved=moved, loss_check=dict(
        kernel=losses["kernel"], gather=losses["gather"], diff=diff,
        limit=limit), cli_losses=cli, profile=prof_res), fwd_rows, bwd_rows


# --------------------------------------------------------------------------
def _moe_model(seed: int):
    """Full-width moonshot-v1-16b-a3b with random weights made in bf16 on
    the card (f32 masters of its ~28.1 B parameters would not fit);
    sla_proj redrawn so that O^l reaches the logits."""
    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = transformer.init(gen, cfg, dtype=torch.bfloat16, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
    return cfg, params


def _moe_cross_check(cfg, cparams, toks) -> dict:
    """The prefill's last-position logits on the kernel against the gather
    backend. Each backend plans its blocks and routes its tokens from its
    own activations, so one ulp can flip a near-tied block or expert, and
    a flipped expert (or a slot another flip pushed past capacity) moves
    every later layer: that run is measured (logit difference, greedy
    agreement, routing slots and plan blocks that differ from the kernel
    run's), not held. The gather backend then runs again on the kernel
    run's plans and routing, which isolates execution: held to 5e-2 x
    max(1, max |logits|)."""
    orig_route, orig_plan = moe_lib.route, plan_lib.plan_attention
    rec = {"route": [], "plan": []}
    seen = dict(route=0, plan=0, slots=0, blocks=0, first_layer=None)

    def record_route(router, tokens, cfg_):
        rec["route"].append(orig_route(router, tokens, cfg_))
        return rec["route"][-1]

    def record_plan(*a, **kw):
        rec["plan"].append(orig_plan(*a, **kw))
        return rec["plan"][-1]

    def free_route(router, tokens, cfg_):
        r = orig_route(router, tokens, cfg_)
        want = rec["route"][seen["route"]]
        differ = int((r["eidx"] != want["eidx"]).sum()
                     + (r["keep"] != want["keep"]).sum())
        if differ and seen["first_layer"] is None:
            seen["first_layer"] = seen["route"]
        seen["slots"] += differ
        seen["route"] += 1
        return r

    def free_plan(*a, **kw):
        p = orig_plan(*a, **kw)
        seen["blocks"] += int((p.mc != rec["plan"][seen["plan"]].mc).sum())
        seen["plan"] += 1
        return p

    def replay_route(router, tokens, cfg_):
        return rec["route"].pop(0)

    def replay_plan(*a, **kw):
        return rec["plan"].pop(0)

    logits = {}
    try:
        with torch.no_grad():
            for run, backend, hooks in (
                    ("kernel", "kernel", (record_route, record_plan)),
                    ("free", "gather", (free_route, free_plan)),
                    ("shared", "gather", (replay_route, replay_plan))):
                moe_lib.route, plan_lib.plan_attention = hooks
                x, _ = transformer.forward(cparams, cfg, toks,
                                           backend=backend)
                logits[run] = logits_from_hidden(cparams, x[:, -1])
                del x
    finally:
        moe_lib.route, plan_lib.plan_attention = orig_route, orig_plan
    if rec["route"] or rec["plan"]:
        raise RuntimeError("the replayed gather run left recorded routing "
                           "or plans unused")
    want = logits.pop("kernel")
    limit = LM_LOGIT_TOL * max(1.0, float(want.abs().max()))
    out = dict(limit=limit, routing_slots_differ=seen["slots"],
               first_layer_differ=seen["first_layer"],
               plan_blocks_differ=seen["blocks"])
    for run, got in logits.items():
        out[run] = dict(diff=float((got - want).abs().max()),
                        greedy_agreement=float(
                            (got.argmax(-1) == want.argmax(-1)).float()
                            .mean()))
    say(f"[22 moe cross-check] prefill logits at the last position, kernel "
        f"vs gather | each planning and routing by itself: max abs diff "
        f"{out['free']['diff']:.3g}, greedy agreement "
        f"{out['free']['greedy_agreement']:.2f}, {seen['slots']} routing "
        f"entries (top-k experts and keep) differ from the kernel run's, "
        f"first in layer {seen['first_layer']}, {seen['blocks']} plan blocks"
        f" | gather on the kernel run's plans and routing: max abs diff "
        f"{out['shared']['diff']:.3g} (limit {limit:.3g}) "
        f"{'OK' if out['shared']['diff'] <= limit else 'FAIL'}, greedy "
        f"agreement {out['shared']['greedy_agreement']:.2f}")
    return out


def phase_moe_serving(cfg, params, profile: bool):
    """Phase 22: the static engine serving moonshot-v1-16b-a3b at full
    width and depth with decode-time SLA on the kernel backend; kernel 4
    against its twin on the path's decode state (group 1), kernel 1 on
    the prefill's plans, and the prefill's logits kernel against gather.
    Returns (summary, kernel-1 rows, kernel-4 rows)."""
    nl, hkv = cfg.num_layers, cfg.num_kv_heads
    g = cfg.num_heads // hkv
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rs.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=MOE_NEW)
            for i, n in enumerate(MOE_PROMPTS)]
    engine = ServingEngine(cfg, params, batch_size=MOE_BATCH,
                           max_len=MOE_MAX_LEN, backend="kernel",
                           decode_sla=True)
    last, plans, first = {}, [], {}
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    run_prefill, decode_loop, one = (engine._run_prefill,
                                     engine._decode_loop, engine._one)
    drops = {"prefill": [], "decode": []}
    orig_route, orig_plan = moe_lib.route, plan_lib.plan_attention

    def route_hook(router, tokens, cfg_):
        r = orig_route(router, tokens, cfg_)
        # tokens (B, S, d): one a row in a decode step
        kind = ("decode" if tokens.shape[:-1].numel() == MOE_BATCH
                else "prefill")
        drops[kind].append(((~r["keep"]).sum(), r["cap"],
                            r["keep"].numel()))
        return r

    def plan_hook(*a, **kw):
        plan = orig_plan(*a, **kw)
        plans.append(plan)
        return plan

    def prefill_hook(toks):
        first["toks"] = toks
        return run_prefill(toks)

    def decode_loop_hook(p, token, cache, n):
        token, cache, buf = decode_loop(p, token, cache, n)
        last.update(token=token, cache=cache)
        return token, cache, buf

    def one_hook(p, token, cache):
        logits, cache = one(p, token, cache)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    engine._run_prefill, engine._decode_loop = prefill_hook, decode_loop_hook
    engine._one = one_hook
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = sla_fwd.LAUNCHES = 0
    sla_fwd.TC_LAUNCHES = 0
    _zero_head_dims()
    moe_lib.route, plan_lib.plan_attention = route_hook, plan_hook
    t0 = time.time()
    try:
        done = engine.run(reqs)
    finally:
        moe_lib.route, plan_lib.plan_attention = orig_route, orig_plan
    wall = time.time() - t0
    _read_head_dims("moe")
    launches = dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                    sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = engine.stats
    steps = MOE_NEW - 1
    want = dict(sla_fwd=nl, tc_sla_fwd=nl, sla_decode=nl * steps,
                sla_decode_paged=0)
    moe = {kind: dict(calls=len(v), cap=sorted({c for _, c, _ in v}),
                      slots=sum(n for _, _, n in v),
                      dropped=int(sum(int(d) for d, _, _ in v)))
           for kind, v in drops.items()}
    moe["prefill"]["dropped_by_layer"] = [int(d) for d, _, _ in
                                          drops["prefill"]]
    say(f"[22 moe serve] {MOE_ARCH} at full width and depth ({nl} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} / {hkv} heads of "
        f"{cfg.head_dim}, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token} of {cfg.moe_d_ff} + a shared expert, vocab "
        f"{cfg.vocab_size}; bf16 weights, "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
        f"parameters), batch {MOE_BATCH}, prompts {MOE_PROMPTS} (bucket "
        f"{engine._bucket}), max_len {MOE_MAX_LEN}, {MOE_NEW} new tokens, "
        f"kernel backend, decode-SLA, in {wall:.2f}s | peak {peak:.2f} GiB")
    say(f"  prefill {st.prefill_s:.3f}s ({MOE_BATCH} x {engine._bucket} "
        f"tokens) | decode {st.decode_s:.3f}s for {steps} steps = "
        f"{1e3 * st.decode_s / steps:.2f} ms a step | decode plans "
        f"{st.decode_plan_builds} built, {st.decode_plan_extends} extended, "
        f"{st.decode_plan_replans} re-planned, {st.decode_plan_reuses} "
        f"reused")
    say(f"  MoE calls, capacity and dropped (token, slot) pairs: {moe} | "
        f"launches {launches} (expected {want}) | logits finite "
        f"{bool(finite)} | tokens {[r.tokens_out[:6] for r in done]}")
    bad = []
    if [len(r.tokens_out) for r in done] != [MOE_NEW] * len(MOE_PROMPTS):
        bad.append("a request did not finish with its tokens")
    if not bool(finite):
        bad.append("non-finite logits")
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if (moe["prefill"]["calls"], moe["decode"]["calls"]) != (nl, nl * steps):
        bad.append(f"MoE calls {moe}")
    if bad:
        raise RuntimeError("MoE serving phase failed: " + "; ".join(bad))
    prof_res = None
    cache, token = last["cache"], last["token"]
    cparams = engine._cparams
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof_ctx
        at = cache["pos"]
        snap = _span_snapshot(cache, at, 1, cfg.sla.block_kv)
        torch.cuda.synchronize()
        t0 = time.time()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                transformer.decode_step(cparams, cfg, token, cache,
                                        backend="kernel",
                                        drift_threshold=engine.
                                        drift_threshold)
            torch.cuda.synchronize()
        _span_restore(cache, snap, at, 1, cfg.sla.block_kv)
        del snap
        prof_res = _busy(prof, time.time() - t0)
        k4_us, k4_n = _decode_kernel_time(prof.key_averages())
        prof_res.update(decode_kernel_s=k4_us / 1e6, decode_launches=k4_n)
        say(f"[22 moe profile] one decode step: {prof_res}")
        say(prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=20))
    # kernel 4 against its twin on the path's live rows (group 1)
    st_ = cache["sla"]
    bkv = cfg.sla.block_kv
    dcfg = cfg.sla.decode_plan_cfg(cache["k"].shape[-2] // bkv)
    pos = cache["pos"] - 1
    gen = torch.Generator(device=DEV).manual_seed(16)
    dec_rows = []
    for layer in (0, nl - 1):
        state = {"k": cache["k"][layer], "v": cache["v"][layer],
                 "hblk": st_["hblk"][layer], "zblk": st_["zblk"][layer],
                 "htot": st_["htot"][layer], "ztot": st_["ztot"][layer],
                 "lut": st_["live_lut"][layer], "cnt": st_["live_cnt"][layer],
                 "marg": st_["live_marg"][layer]}
        q = torch.randn((MOE_BATCH, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device=DEV)
        proj = {"proj": cparams.layers[layer].sla_proj}
        with torch.no_grad():
            o_k = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="kernel")
            o_g = backend_lib.decode_execute(state, proj, q, pos, dcfg,
                                             backend="gather")
        err = float((o_k - o_g).abs().max())
        limit = TWIN_TOL * max(1.0, float(o_g.abs().max()))
        qg = backend_lib._group_heads(q[:, :, 0].float(), hkv)[..., None, :]
        qpg = backend_lib._group_heads(phi(q[:, :, 0], cfg.sla.phi),
                                       hkv)[..., None, :]
        flat = sla_decode._flat_args(
            *sla_decode.decode_operands(state, qg, qpg, pos), bkv)
        kw = dict(scale=cfg.head_dim ** -0.5, block_kv=bkv, group=g)
        say(f"[22 moe decode kernel] layer {layer} at pos {pos} (BH="
            f"{flat[4].shape[0]}, BH_kv={flat[6].shape[0]}, group {g}): "
            f"decode_execute kernel vs gather max abs err {err:.3g} (limit "
            f"{limit:.3g}) {'OK' if err <= limit else 'FAIL'}")
        row = _decode_case(flat, kw, f"sla_decode vs twin on layer {layer}'s"
                           f" path LUTs (K/V bf16, group {g})")
        row["ok"] = row["ok"] and err <= limit
        dec_rows.append(dict(shape=f"moonshot path LUTs layer {layer}",
                             dtype="bf16", c=1, pos=pos, group=g,
                             backend_err=err, backend_limit=limit, **row))
        del state, flat
    last.clear()
    del cache, token
    gc.collect()
    torch.cuda.empty_cache()
    cross = _moe_cross_check(cfg, cparams, first["toks"])
    diff, limit = cross["shared"]["diff"], cross["limit"]
    # kernel 1 against its twin on the prefill's layer-0 plans
    fwd_rows = []
    n, d, h = engine._bucket, cfg.head_dim, cfg.num_heads
    q = torch.randn((MOE_BATCH, h, n, d), generator=gen, device=DEV)
    k, v = (plan_lib.repeat_kv(torch.randn(
        (MOE_BATCH, hkv, n, d), generator=gen, device=DEV), h)
        for _ in range(2))  # as the kernel backend gives them (group 1)
    plan = plans[0]
    args, kw, _ = _operands(cfg.sla, q, k, v, plan.marginal, plan.lut,
                            plan.counts, torch.bfloat16, causal=True)
    c = _fwd_check(args, kw, "moonshot prefill layer 0")
    ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw), 2,
                       warmup=1)
    bound_ms, bound_by, _, _, live = _bound(args, kw)
    say(f"[22 moe prefill plans] sla_fwd moonshot prefill layer 0 bf16 "
        f"causal (BH={args[2].shape[0]}, BH_kv={args[3].shape[0]}, N={n}, "
        f"K={args[0].shape[-1]}, live tiles {live} of {args[0].numel()}): "
        f"{_fwd_text(c)} | kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by "
        f"{bound_by} ({bound_ms / ms:.1%} of it) | plain twin "
        f"{plain_ms:.3f} ms")
    fwd_rows.append(dict(shape="moonshot prefill layer 0 plans",
                         dtype="bf16", live_tiles=live, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_fraction=bound_ms / ms, **c))
    del args, q, k, v, plans[:]
    torch.cuda.empty_cache()
    if diff > limit or not np.isfinite(diff):
        bad.append(f"prefill logits kernel vs gather {diff} > {limit}")
    bad += [f"sla_decode {r['shape']}" for r in dec_rows if not r["ok"]]
    bad += [f"sla_fwd {r['shape']}" for r in fwd_rows if not r["ok"]]
    if bad:
        raise RuntimeError("MoE serving checks failed: " + "; ".join(bad))
    summary = dict(wall_s=wall, peak_gib=peak, prefill_s=st.prefill_s,
                   decode_s=st.decode_s,
                   decode_ms_per_step=1e3 * st.decode_s / steps,
                   launches=launches, moe=moe, cross_check=cross,
                   profile=prof_res)
    return summary, fwd_rows, dec_rows


# --------------------------------------------------------------------------
# the recurrent and encoder-decoder families (phases 23-25)
# --------------------------------------------------------------------------
def _padded_fwd_bound(args, kw):
    """`_bound` of the tensor-core forward on what it reads at a head dim
    below `TC_HEAD_DIM`: q, k and v zero-padded to it (bf16) and the tile
    products at that width; qp, hi, zi, the outputs and the linear merge
    at their own D. Returns (ms, "bytes" or "operations")."""
    lut, counts, q, k, v, qp, hi, zi = args
    bh, nq, d = q.shape
    pad = sla_fwd.TC_HEAD_DIM
    bq, bkv = kw["block_q"], kw["block_kv"]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (lut, counts, qp, hi, zi))
    nbytes += sum(t.numel() // d * pad * t.element_size() for t in (q, k, v))
    nbytes += 2 * bh * nq * d * 4 + bh * nq * 4
    live = int(torch.clamp(counts, max=lut.shape[-1]).sum())
    flops = (live * 4 * bq * bkv * pad
             + (nq // bq) * bh * (2 * bq * d * d + 2 * bq * d))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["tc"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _padded_bwd_bound(name, args, kw):
    """`_bwd_bound` of a tensor-core backward kernel on what it reads and
    writes at a head dim below `TC_HEAD_DIM`: q, k, v and dO zero-padded
    to it in bf16, its f32 gradients written at that width, the tile
    products at that width. Returns (ms, "bytes" or "operations")."""
    lut, counts, q, k, v, do, lse, dd = args
    bh, n, d = q.shape
    pad = sla_fwd.TC_HEAD_DIM
    nbytes = sum(t.numel() * t.element_size() for t in (lut, counts, lse,
                                                         dd))
    nbytes += sum(t.numel() // d * pad * 2 for t in (q, k, v, do))
    nbytes += (1 if name == "sla_bwd_dq" else 2) * bh * n * pad * 4
    live = int(torch.clamp(counts, max=lut.shape[-1]).sum())
    flops = live * BWD[name][2] * kw["block_q"] * kw["block_kv"] * pad
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _family_kernel_rows(tag: str, arch: str, plans: dict, causal: bool,
                        batch: int, n: int) -> tuple:
    """Kernels 1-3 against their twins on a training step's own plans
    ({application or layer: plan}): seeded bf16 q, k and v at the step's
    (B, H, N, D) with k/v repeated to the query heads as the kernel
    backend gives them; `cases.tc_criterion`, two launches bitwise equal.
    Each timed with its bound for the D-wide work and, below
    `TC_HEAD_DIM`, for the operands zero-padded to it that the tensor-core
    routes read. Returns (forward rows, backward rows)."""
    cfg = get_arch(arch)
    sla, h, d = cfg.sla, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(11)
    q = torch.randn((batch, h, n, d), generator=gen, device=DEV)
    k, v = (plan_lib.repeat_kv(torch.randn(
        (batch, cfg.num_kv_heads, n, d), generator=gen, device=DEV), h)
        for _ in range(2))
    kind = "causal" if causal else "non-causal"
    padded = d < sla_fwd.TC_HEAD_DIM

    def pad_text(pad_ms, pad_by, ms):
        if not padded:
            return ""
        return (f"; padded to D {sla_fwd.TC_HEAD_DIM}: {pad_ms:.3f} ms by "
                f"{pad_by} ({pad_ms / ms:.1%})")

    fwd_rows, bwd_rows = [], []
    for at, plan in sorted(plans.items()):
        leaves = [plan.marginal, plan.lut, plan.counts, plan.col_lut,
                  plan.col_counts]
        shape = f"{arch} train {at} plans"
        args, kw, _ = _operands(sla, q, k, v, *leaves[:3], torch.bfloat16,
                                causal=causal)
        c = _fwd_check(args, kw, shape)
        ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw), 2,
                           warmup=1)
        bound_ms, bound_by, _, _, live = _bound(args, kw)
        pad_ms, pad_by = (_padded_fwd_bound(args, kw) if padded
                          else (None, None))
        say(f"[{tag} kernels] sla_fwd {shape} bf16 {kind} D {d} (BH="
            f"{args[2].shape[0]}, N={n}, K={args[0].shape[-1]}, live tiles "
            f"{live} of {args[0].numel()}): {_fwd_text(c)} | kernel "
            f"{ms:.3f} ms | bound {bound_ms:.3f} ms by {bound_by} "
            f"({bound_ms / ms:.1%} of it){pad_text(pad_ms, pad_by, ms)} | "
            f"plain twin {plain_ms:.3f} ms")
        fwd_rows.append(dict(shape=shape, dtype="bf16", head_dim=d,
                             causal=causal, live_tiles=live, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             bound_fraction=bound_ms / ms,
                             bound_ms_padded=pad_ms, bound_by_padded=pad_by,
                             bound_fraction_padded=pad_ms and pad_ms / ms,
                             **c))
        del args
        dq_args, dkv_args, kw = _bwd_operands(sla, q, k, v, leaves,
                                              torch.bfloat16, seed=12,
                                              causal=causal)
        for name, args in (("sla_bwd_dq", dq_args),
                           ("sla_bwd_dkv", dkv_args)):
            c = _bwd_check(name, args, kw, shape)
            ms = cuda_ms(lambda: BWD[name][0](*args, **kw), 10)
            plain_ms = cuda_ms(lambda: BWD[name][1](*args, **kw), 2,
                               warmup=1)
            bound_ms, bound_by, _, _, live = _bwd_bound(name, args, kw,
                                                        torch.bfloat16)
            pad_ms, pad_by = (_padded_bwd_bound(name, args, kw) if padded
                              else (None, None))
            say(f"[{tag} kernels] {name} {shape} bf16 {kind} D {d} (live "
                f"tiles {live} of {args[0].numel()}): {_check_text(c)} | "
                f"kernel {ms:.3f} ms | bound {bound_ms:.3f} ms by "
                f"{bound_by} ({bound_ms / ms:.1%} of it)"
                f"{pad_text(pad_ms, pad_by, ms)} | plain twin "
                f"{plain_ms:.3f} ms")
            bwd_rows.append(dict(kernel=name, shape=shape, dtype="bf16",
                                 head_dim=d, causal=causal, live_tiles=live,
                                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by,
                                 bound_fraction=bound_ms / ms,
                                 bound_ms_padded=pad_ms,
                                 bound_by_padded=pad_by,
                                 bound_fraction_padded=pad_ms and pad_ms / ms,
                                 **c))
        del dq_args, dkv_args
    torch.cuda.empty_cache()
    bad = [r for r in fwd_rows + bwd_rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"a kernel disagrees with its twin on the {arch} "
                           f"training plans: {bad}")
    return fwd_rows, bwd_rows


def _family_train(tag: str, cfg, mdl, params, batches, want: dict,
                  probes, keep: tuple, profile: bool, path: str,
                  want_dims=None, keep_state: bool = False,
                  kernel_names=("sla_fwd_tc_kernel", "sla_bwd_dq_tc_kernel",
                                "sla_bwd_dkv_tc_kernel")) -> tuple:
    """Phases 23, 24, 29 and 30's training: one batch's `loss_fn` on the
    kernel against the gather backend (bf16 compute) within FAM_LOSS_TOL
    x max(1, |loss|), then one `make_train_step` step a batch (AdamW over
    the f32 masters, bf16 compute, kernel backend, the reference's
    remat), each checked for finite loss and grad norm and exactly the
    launches and plan builds of `want` (and, with `want_dims`, exactly
    the wrappers' head-dim records {kernel: {D: launches}} of the step);
    the parameters named in `probes` must move; each step's head dims are
    kept under `path`. `profile` adds a profile of one more step: the
    busy share and the mean device time of the `kernel_names` kernels.
    Returns (summary, {i: the last step's i-th plan for i in keep}, and
    with `keep_state` the trained {"params": named parameters, "opt":
    AdamW state}, else None)."""
    losses = {}
    with torch.no_grad():
        tree = train_steps.cast_params_bf16(params)
        for backend in ("kernel", "gather"):
            losses[backend] = float(mdl.loss_fn(tree, cfg, batches[0],
                                                backend=backend))
        del tree
    limit = FAM_LOSS_TOL * max(1.0, abs(losses["gather"]))
    diff = abs(losses["kernel"] - losses["gather"])
    say(f"[{tag}] one batch's loss_fn: kernel {losses['kernel']:.6f}, "
        f"gather {losses['gather']:.6f}, diff {diff:.3g} (limit "
        f"{limit:.3g}) {'OK' if diff <= limit else 'FAIL'}")
    if not (np.isfinite(diff) and diff <= limit):
        raise RuntimeError(f"{cfg.name} loss kernel {losses['kernel']} vs "
                           f"gather {losses['gather']}")
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                total_steps=len(batches))
    step_fn = train_steps.make_train_step(cfg, opt_cfg, backend="kernel")
    named = dict(params.named_parameters())
    opt_state = adamw.init(named)
    probe = {n: named[n].detach().clone() for n in probes}
    plans = []
    orig_plan = plan_lib.plan_attention

    def counted_plan(*a, **kw):
        plans.append(orig_plan(*a, **kw))
        return plans[-1]

    rows = []
    plan_lib.plan_attention = counted_plan
    try:
        with actx.activation_sharding(remat=True):
            for i, batch in enumerate(batches):
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_kernel_counts()
                plans.clear()
                t0 = time.time()
                params, opt_state, loss, gnorm = step_fn(params, opt_state,
                                                         batch)
                loss, gnorm = float(loss), float(gnorm)
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = _kernel_counts(plans, path)
                dims = {name: dict(rec) for name, rec in
                        _head_dim_records().items() if rec}
                peak = torch.cuda.max_memory_allocated() / 2**30
                say(f"[{tag}] step {i}: loss {loss:.6f} grad norm "
                    f"{gnorm:.6f} | {wall:.3f}s | peak {peak:.2f} GiB | "
                    f"launches {got} (expected {want}) | head dims {dims}")
                rows.append(dict(step=i, loss=loss, grad_norm=gnorm,
                                 wall_s=wall, peak_gib=peak, **got))
                if not (np.isfinite(loss) and np.isfinite(gnorm)):
                    raise RuntimeError(f"{cfg.name} training step {i}: loss "
                                       f"{loss}, grad norm {gnorm}")
                if got != want:
                    raise RuntimeError(f"{cfg.name} training step {i}: "
                                       f"launches {got}, expected {want}")
                if want_dims is not None and dims != want_dims:
                    raise RuntimeError(f"{cfg.name} training step {i}: head "
                                       f"dims {dims}, expected {want_dims}")
            kept = {at: plans[at] for at in keep}
            prof_res = None
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                torch.cuda.synchronize()
                t0 = time.time()
                with prof_ctx(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    step_fn(params, opt_state, batches[0])
                    torch.cuda.synchronize()
                prof_res = _busy(prof, time.time() - t0)
                prof_res["kernels"] = _kernel_means(prof, kernel_names)
                say(f"[{tag} profile] one more step: {prof_res}")
                say(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25))
    finally:
        plan_lib.plan_attention = orig_plan
    moved = {n: bool((named[n].detach() != probe[n]).any()) for n in probes}
    state = {"params": named, "opt": opt_state} if keep_state else None
    del opt_state, named
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[{tag}] {len(rows)} steps: walls "
        f"{[round(r['wall_s'], 3) for r in rows]} s | peaks "
        f"{[round(r['peak_gib'], 2) for r in rows]} GiB | parameters moved "
        f"{moved}")
    if not all(moved.values()):
        raise RuntimeError(f"{cfg.name} training did not move the "
                           f"parameters: {moved}")
    totals = {key: sum(r[key] for r in rows) for key in want}
    return dict(steps=rows, launches=totals, moved=moved, profile=prof_res,
                loss_check=dict(kernel=losses["kernel"],
                                gather=losses["gather"], diff=diff,
                                limit=limit)), kept, state


def _family_cli(tag: str, arch: str, steps: int) -> list:
    argv = ["--arch", arch, "--smoke", "--steps", str(steps), "--device",
            "cuda", "--log-every", "1"]
    t0 = time.time()
    cli = train_cli.main(argv)
    ok = len(cli) == steps and bool(np.isfinite(cli).all()) and min(cli) > 0
    say(f"[{tag} CLI] repro_torch.launch.train {' '.join(argv)}: losses "
        f"{cli} in {time.time() - t0:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{arch} train CLI losses {cli}")
    return cli


def _scan_cost(cfg, nlayers: int, step_wall: float) -> dict:
    """The chunked scan (`linear_scan.decayed_la_chunked`, scalar decay)
    at one Mamba2 layer's training shape (B, H, N, state) x (B, H, N, P)
    in bf16, B and C broadcast over the heads as `mamba_apply` gives
    them: CUDA-event time of the forward alone and of forward plus
    backward; a remat step runs nlayers x (both). Its share of a step's
    wall."""
    b, h, n = HY_BATCH, cfg.ssm_heads, HY_SEQ
    st, p = cfg.ssm_state, cfg.ssm_head_dim
    gen = torch.Generator(device=DEV).manual_seed(5)
    bc = [torch.randn((b, 1, n, st), generator=gen, device=DEV,
                      dtype=torch.bfloat16).expand(b, h, n, st)
          for _ in range(2)]
    x = torch.randn((b, h, n, p), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    la = -torch.nn.functional.softplus(torch.randn(
        (b, h, n), generator=gen, device=DEV))

    def fwd():
        with torch.no_grad():
            linear_scan.decayed_la_chunked(bc[0], bc[1], x, la,
                                           inclusive=True,
                                           scalar_decay=True, chunk=64)

    xg = x.clone().requires_grad_()
    lag = la.clone().requires_grad_()

    def fwd_bwd():
        o, s = linear_scan.decayed_la_chunked(bc[0], bc[1], xg, lag,
                                              inclusive=True,
                                              scalar_decay=True, chunk=64)
        (o.sum() + s.sum()).backward()

    f_ms, fb_ms = cuda_ms(fwd, 5), cuda_ms(fwd_bwd, 5)
    step_ms = nlayers * (f_ms + fb_ms)
    res = dict(fwd_ms=f_ms, fwd_bwd_ms=fb_ms, per_step_ms=step_ms,
               share_of_step=step_ms / (step_wall * 1e3))
    say(f"[23 hybrid scan] decayed_la_chunked at (B {b}, H {h}, N {n}, "
        f"state {st}, P {p}) bf16, chunk 64: forward {f_ms:.3f} ms, forward "
        f"+ backward {fb_ms:.3f} ms; {nlayers} layers x both = "
        f"{step_ms:.1f} ms a step, {res['share_of_step']:.1%} of the "
        f"{step_wall:.3f} s step")
    return res


def _finite(flag, logits):
    return flag & torch.isfinite(logits).all()


def phase_hybrid(profile: bool):
    """Phase 23: zamba2-1.2b at full width and depth. Training through
    `_family_train` (7 shared-block applications a step), the chunked
    scan's cost, kernels 1-3 on the last step's plans of the first and
    last application (causal, D 64), `prefill` of HY_PREFILL x HY_SEQ
    tokens and HY_NEW `decode_step`s, then the train CLI. Returns
    (summary, forward rows, backward rows)."""
    cfg = get_arch(HY_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = hybrid.init(gen, cfg, device=DEV)
    _redraw(gen, [params.shared_attn.sla_proj])
    nparams = sum(p.numel() for p in params.parameters())
    segs = hybrid.segments(cfg)
    napp = len(segs)
    say(f"[23 hybrid] {HY_ARCH} at full width and depth: {cfg.num_layers} "
        f"Mamba2 layers (d_model {cfg.d_model}, {cfg.ssm_heads} SSM heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}) in segments {segs}, a "
        f"shared SLA block of {cfg.num_heads} heads of {cfg.head_dim} after "
        f"each ({napp} applications), vocab {cfg.vocab_size}: {nparams:,} "
        f"parameters in f32 | train_4k seq {HY_SEQ}, batch {HY_BATCH} "
        f"(global 256 cut)")
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=HY_BATCH)
    data = make_iterator(cfg, shape, DataConfig(seed=0))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in next(data).items()}
               for _ in range(HY_STEPS)]
    want = dict(sla_fwd=napp, tc_sla_fwd=napp, sla_bwd_dq=napp,
                tc_sla_bwd_dq=napp, sla_bwd_dkv=napp, tc_sla_bwd_dkv=napp,
                plan_builds=napp)
    train, plans, _ = _family_train("23 hybrid", cfg, hybrid, params,
                                    batches, want, HY_PROBES, (0, napp - 1),
                                    profile, "hybrid_train")
    del batches
    train["scan"] = _scan_cost(cfg, cfg.num_layers,
                               min(r["wall_s"] for r in train["steps"]))
    fwd_rows, bwd_rows = _family_kernel_rows(
        "23 hybrid", HY_ARCH, {f"application {at}": plan
                               for at, plan in plans.items()},
        causal=True, batch=HY_BATCH, n=HY_SEQ)
    del plans
    # serving through the model API: prefill, the K/V grown by zeros as
    # the reference's test grows them, greedy decode steps
    toks = torch.randint(0, cfg.vocab_size, (HY_PREFILL, HY_SEQ),
                         generator=gen, device=DEV)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    with torch.no_grad():
        tree = train_steps.cast_params_bf16(params)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        t0 = time.time()
        last, cache = hybrid.prefill(tree, cfg, toks, backend="kernel")
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        launches = (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES)
        _read_head_dims("hybrid_prefill")
        for key in ("attn_k", "attn_v"):
            cache[key] = torch.nn.functional.pad(cache[key],
                                                 (0, 0, 0, HY_NEW))
        logits = logits_from_hidden(tree, last)
        finite = _finite(finite, logits)
        token = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(HY_NEW):
            logits, cache = hybrid.decode_step(tree, cfg, token, cache)
            finite = _finite(finite, logits)
            token = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        decode_ms = (time.time() - t0) / HY_NEW * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        dec_launches = sla_fwd.LAUNCHES - launches[0]
    ok = (bool(finite) and cache["pos"] == HY_SEQ + HY_NEW
          and launches == (napp, napp) and dec_launches == 0)
    say(f"[23 hybrid serve] prefill {HY_PREFILL} x {HY_SEQ} tokens "
        f"{prefill_s:.3f}s (sla_fwd launches {launches[0]}, tensor cores "
        f"{launches[1]}, expected {napp}) | {HY_NEW} decode steps "
        f"{decode_ms:.2f} ms a step (dense attention over the shared "
        f"block's cache; sla_fwd launches {dec_launches}) | pos "
        f"{cache['pos']} | finite {bool(finite)} | peak {peak:.2f} GiB "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("zamba2 prefill/decode failed its checks")
    del tree, cache, last, logits, params
    gc.collect()
    torch.cuda.empty_cache()
    cli = _family_cli("23 hybrid", HY_ARCH, 2)
    train.update(params=nparams, prefill_s=prefill_s, decode_ms=decode_ms,
                 serve_peak_gib=peak, prefill_launches=launches[0],
                 cli_losses=cli)
    return train, fwd_rows, bwd_rows


def phase_encdec(profile: bool):
    """Phase 24: whisper-small at full width and depth. Training through
    `_family_train` (12 encoder layers, each SLA forward run twice under
    remat), kernels 1-3 on the last step's plans of encoder layers 0 and
    11 (non-causal, D 64), `prefill` of ED_PREFILL x ED_FRAMES frames and
    ED_NEW `decode_step`s. Returns (summary, forward rows, backward
    rows)."""
    cfg = get_arch(ED_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = encdec.init(gen, cfg, device=DEV)
    _redraw(gen, [block.sla_proj for block in params.enc])
    nparams = sum(p.numel() for p in params.parameters())
    ne = cfg.encoder_layers
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=ED_BATCH)
    data = make_iterator(cfg, shape, DataConfig(seed=0))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in next(data).items()}
               for _ in range(ED_STEPS)]
    say(f"[24 encdec] {ED_ARCH} at full width and depth: {ne} + "
        f"{cfg.decoder_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}: "
        f"{nparams:,} parameters in f32 | train_4k: "
        f"{batches[0]['audio_embeds'].shape[1]} audio frames and "
        f"{batches[0]['tokens'].shape[1]} text tokens, batch {ED_BATCH}")
    want = dict(sla_fwd=2 * ne, tc_sla_fwd=2 * ne, sla_bwd_dq=ne,
                tc_sla_bwd_dq=ne, sla_bwd_dkv=ne, tc_sla_bwd_dkv=ne,
                plan_builds=ne)
    train, plans, _ = _family_train("24 encdec", cfg, encdec, params,
                                    batches, want, ED_PROBES, (0, ne - 1),
                                    profile, "encdec_train")
    del batches
    fwd_rows, bwd_rows = _family_kernel_rows(
        "24 encdec", ED_ARCH, {f"encoder layer {at}": plan
                               for at, plan in plans.items()},
        causal=False, batch=ED_BATCH, n=ED_FRAMES)
    del plans
    audio = torch.randn((ED_PREFILL, ED_FRAMES, cfg.d_model), generator=gen,
                        device=DEV)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    with torch.no_grad():
        tree = train_steps.cast_params_bf16(params)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        t0 = time.time()
        enc, cache = encdec.prefill(tree, cfg, {"audio_embeds": audio},
                                    backend="kernel")
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        launches = (sla_fwd.LAUNCHES, sla_fwd.TC_LAUNCHES)
        _read_head_dims("encdec_prefill")
        finite = _finite(finite, enc)
        token = torch.zeros((ED_PREFILL,), dtype=torch.long, device=DEV)
        t0 = time.time()
        for _ in range(ED_NEW):
            logits, cache = encdec.decode_step(tree, cfg, token, cache)
            finite = _finite(finite, logits)
            token = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        decode_ms = (time.time() - t0) / ED_NEW * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        dec_launches = sla_fwd.LAUNCHES - launches[0]
    ok = (bool(finite) and cache["pos"] == ED_NEW
          and launches == (ne, ne) and dec_launches == 0)
    say(f"[24 encdec serve] prefill {ED_PREFILL} x {ED_FRAMES} frames "
        f"{prefill_s:.3f}s (sla_fwd launches {launches[0]}, tensor cores "
        f"{launches[1]}, expected {ne}; cross K/V "
        f"{tuple(cache['cross_k'].shape)}, self cache "
        f"{cache['self_k'].shape[3]} tokens) | {ED_NEW} decode steps "
        f"{decode_ms:.2f} ms a step | finite {bool(finite)} | peak "
        f"{peak:.2f} GiB {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("whisper prefill/decode failed its checks")
    del tree, cache, enc, params
    gc.collect()
    torch.cuda.empty_cache()
    cli = _family_cli("24 encdec", ED_ARCH, 2)
    train.update(params=nparams, prefill_s=prefill_s, decode_ms=decode_ms,
                 serve_peak_gib=peak, prefill_launches=launches[0],
                 cli_losses=cli)
    return train, fwd_rows, bwd_rows


def _rwkv_run(params, cfg, toks, dtype, hold: bool) -> dict:
    """Prefill the first RW_PROMPT tokens, decode the next RW_NEW fed
    tokens, and the forward over all of them: the decode logits against
    the forward's at the same positions
    (`tests/test_models.py::test_rwkv_decode_consistent_with_forward`),
    held to FAM_LOSS_TOL x max(1, max |logits|) when `hold`, and their
    greedy agreement. Finite logits are always held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, cache = rwkv6.prefill(params, cfg, toks[:, :RW_PROMPT], dtype)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    dec = []
    t0 = time.time()
    for i in range(RW_NEW):
        logits, cache = rwkv6.decode_step(params, cfg,
                                          toks[:, RW_PROMPT + i], cache,
                                          dtype)
        dec.append(logits)
    torch.cuda.synchronize()
    decode_ms = (time.time() - t0) / RW_NEW * 1e3
    del cache
    x, _ = rwkv6.forward(params, cfg, toks, dtype)
    fwd = logits_from_hidden(params, x[:, RW_PROMPT:RW_PROMPT + RW_NEW]
                             ).transpose(0, 1)
    del x
    dec = torch.stack(dec)
    diff = float((dec - fwd).abs().max())
    limit = FAM_LOSS_TOL * max(1.0, float(fwd.abs().max()))
    finite = bool(torch.isfinite(dec).all())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    return dict(prefill_s=prefill_s, decode_ms=decode_ms, max_diff=diff,
                limit=limit, held=hold, greedy_agreement=agree,
                finite=finite,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                ok=finite and (diff <= limit or not hold))


def phase_rwkv6():
    """Phase 25: rwkv6-7b at full width and depth, weights made in bf16:
    `prefill` of RW_BATCH x RW_PROMPT tokens and RW_NEW `decode_step`s in
    bf16 compute and again in f32 compute, each against one `forward`
    over the same tokens. The f32 run (the reference test's) is held; the
    bf16 run's drift is measured: the chunked forward rounds its (C, C)
    matrices to bf16 and the step does not, in the reference as here
    (`tests/test_torch_rwkv6.py::test_bf16_decode_drift_is_the_reference_
    drift`). No SLA kernel may launch. Returns the summary."""
    cfg = get_arch(RW_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(2)
    t0 = time.time()
    params = rwkv6.init(gen, cfg, dtype=torch.bfloat16, device=DEV)
    nparams = sum(p.numel() for p in params.parameters())
    init_s = time.time() - t0
    say(f"[25 ssm] {RW_ARCH} at full width and depth: {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.ssm_heads} heads of "
        f"{cfg.d_model // cfg.ssm_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {nparams:,} parameters in bf16 "
        f"({nparams * 2 / 1e9:.2f} GB, made in {init_s:.1f}s)")
    toks = torch.randint(0, cfg.vocab_size, (RW_BATCH, RW_PROMPT + RW_NEW),
                         generator=gen, device=DEV)
    before = (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
              sla_decode.LAUNCHES, sla_decode.PAGED_LAUNCHES)
    runs = {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            runs[name] = _rwkv_run(params, cfg, toks, dtype,
                                   hold=name == "f32")
            r = runs[name]
            held = (f"limit {r['limit']:.4g}" if r["held"] else
                    f"5e-2 x max |logits| = {r['limit']:.4g}, measured, not "
                    f"held")
            say(f"[25 ssm] {name} compute: prefill {RW_BATCH} x {RW_PROMPT} "
                f"tokens {r['prefill_s']:.3f}s | {RW_NEW} decode steps "
                f"{r['decode_ms']:.2f} ms a step | decode logits vs "
                f"forward max |diff| {r['max_diff']:.4g} ({held}), greedy "
                f"agreement {r['greedy_agreement']:.3f} | finite "
                f"{r['finite']} | peak {r['peak_gib']:.2f} GiB "
                f"{'OK' if r['ok'] else 'FAIL'}")
            gc.collect()
            torch.cuda.empty_cache()
    sla = tuple(a - b for a, b in zip(
        (sla_fwd.LAUNCHES, sla_bwd.LAUNCHES_DQ, sla_bwd.LAUNCHES_DKV,
         sla_decode.LAUNCHES, sla_decode.PAGED_LAUNCHES), before))
    say(f"[25 ssm] SLA kernel launches (fwd, dq, dkv, decode, paged "
        f"decode): {sla} (expected none)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in runs.values()) or any(sla):
        raise RuntimeError(f"rwkv6 decode/forward consistency or launches "
                           f"failed: {runs}, {sla}")
    return dict(params=nparams, init_s=init_s, sla_launches=sla, **runs)


# --------------------------------------------------------------------------
# head dim 256, sliding-window attention and the VLM prefix (phases 26-29)
# --------------------------------------------------------------------------
def _d256_fwd_operands(dtype, seed: int):
    """Kernel 1's operands at gemma3's prefill shape: BH 4 on BH_kv 1, N
    D256_N, D 256, the arch's 64 x 64 blocks, causal, with the plan
    `plan_attention` gives seeded q and k and h/z aggregated per query
    head (the kv head's block states repeated over its group)."""
    cfg = get_arch(G3_ARCH)
    sla = cfg.sla.replace(causal=True)
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((1, h, D256_N, d), generator=gen, device=DEV)
    k, v = (torch.randn((1, hkv, D256_N, d), generator=gen, device=DEV)
            for _ in range(2))
    plan = plan_lib.plan_attention(q, k, sla)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi(q, sla.phi), phi(k, sla.phi)
    fq, fk, fv, fqp, fkp = map(ops._flat, (q, k, v, qp, kp))
    a, lut, counts = map(ops._flat, (plan.marginal, plan.lut, plan.counts))
    hb, zb = ops._hz_blocks(fkp, fv, sla.block_kv)
    hb, zb = (torch.repeat_interleave(x, h // hkv, dim=0) for x in (hb, zb))
    hi, zi = ops._aggregate(a, hb, zb)
    del hb, zb, plan
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=d ** -0.5, causal=True, block_q=sla.block_q,
              block_kv=sla.block_kv)
    return args, kw


def _d256_fwd_case(dtype) -> dict:
    """Kernel 1 at D 256 against its twin: every output within 5e-5 x
    max(1, max |twin|), two launches bitwise equal, both on the f32-FMA
    route (the tensor-core and split counters do not move); CUDA-event
    times of the kernel and the twin, the bound and its fraction."""
    dname = "f32" if dtype == torch.float32 else "bf16"
    args, kw = _d256_fwd_operands(dtype, seed=31)
    route = sla_fwd.forward_route(dtype, kw["block_q"], kw["block_kv"], 256)
    before = _fwd_counters()
    got = sla_fwd.sla_fwd(*args, **kw)
    again = sla_fwd.sla_fwd(*args, **kw)
    moved = tuple(a - b for a, b in zip(_fwd_counters(), before))
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    limits = [TWIN_TOL * max(1.0, float(w.abs().max())) for w in want]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (route == "fma" and moved == (2, 0, 0, 0, 0) and bitwise
          and all(e <= m for e, m in zip(errs, limits)))
    del got, again, want
    ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw), 1,
                       warmup=1)
    bound_ms, bound_by, flops, nbytes, live = _bound(args, kw)
    say(f"[26 d256] sla_fwd {G3_ARCH} prefill shape {dname} (BH "
        f"{args[2].shape[0]}, BH_kv {args[3].shape[0]}, N {D256_N}, D "
        f"{args[2].shape[-1]}, {kw['block_q']}x{kw['block_kv']} blocks, "
        f"causal, K {args[0].shape[-1]}, live tiles {live}): "
        f"route {route}, counters (launches, tc, split, planes, tc32) "
        f"moved "
        f"{moved} for two calls | max abs err o_s {errs[0]:.3g} o_l "
        f"{errs[1]:.3g} lse {errs[2]:.3g} (limits {limits[0]:.3g} / "
        f"{limits[1]:.3g} / {limits[2]:.3g}), bitwise repeat {bitwise} "
        f"{'OK' if ok else 'FAIL'} | kernel {ms:.3f} ms | bound "
        f"{bound_ms:.3f} ms by {bound_by} ({bound_ms / ms:.1%} of it; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB) | plain twin "
        f"{plain_ms:.3f} ms")
    del args
    torch.cuda.empty_cache()
    return dict(shape=f"{G3_ARCH} prefill D 256", dtype=dname, head_dim=256,
                route=FWD_F32_ROUTE, live_tiles=live, errs=errs,
                limits=limits, max_abs_err=max(errs), bitwise_repeat=bitwise,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_fraction=bound_ms / ms, ok=ok)


def _d256_bwd_cases() -> list:
    """Kernels 2 and 3 above head dim 128, on their f32-FMA route (the
    wide kernels) in f32 and bf16: at gemma3's prefill shape (BH 4 on
    BH_kv 1, N D256_N, D 256, causal, the arch's 64 x 64 blocks and its
    plan of seeded q and k) and at D 192 (N D192_N). Each held to its f32
    twin within 5e-5 x max(1, max |twin|), two launches bitwise equal,
    timed (CUDA events) with its bound; at D 256 compiled flex_attention's
    backward on the same causal LUT (k and v repeated to the query heads)
    is the library time, or its error the library cell."""
    cfg = get_arch(G3_ARCH)
    h, group = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    rows = []
    for d, n in ((256, D256_N), (192, D192_N)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            dq_args, dkv_args, kw, (q, k, v, plan) = _gqa_bwd_operands(
                h, group, n, d, seed=33, causal=True, dtype=dtype,
                arch=G3_ARCH)
            extra = {}
            if d == 256:
                extra = _with_library(
                    cfg.sla, q, *(plan_lib.repeat_kv(x, h).contiguous()
                                  for x in (k, v)),
                    plan.lut, plan.counts, dq_args, dkv_args, kw, dtype,
                    f"{G3_ARCH} D 256 {dname}")
            del q, k, v, plan
            shape = (f"{G3_ARCH} prefill D 256" if d == 256
                     else f"{G3_ARCH} heads at D 192")
            rows += [dict(r, head_dim=d) for r in _bwd_case(
                shape, dname, dq_args, dkv_args, kw, n, d, extra,
                tag="26 d256")]
            del dq_args, dkv_args
            torch.cuda.empty_cache()
    for r in rows:
        if r["route"] != F32_ROUTE:
            r["ok"] = False  # above 128 every call takes the f32-FMA route
    return rows


def phase_d256_kernels():
    """Phase 26: kernels 1-5 at head dim 256 against their twins. Kernel
    1 on the f32-FMA route in f32 and bf16 at gemma3's prefill shape;
    kernels 2 and 3 on theirs there and at D 192 (`_d256_bwd_cases`);
    kernel 4 on a gemma3 decode state (B 2, H 4, Hkv 1, Tn 512, K 26, bf16
    K/V) at C 1 and 4; kernel 5 on a paged state of 4 slots sharing 96
    pages, bitwise equal to kernel 4 on the gathered view at every split
    width. Returns (forward rows, backward rows, decode rows, paged
    rows)."""
    fwd_rows = [_d256_fwd_case(dtype)
                for dtype in (torch.float32, torch.bfloat16)]
    bwd_rows = _d256_bwd_cases()
    dec_rows = []
    pos = D256_DECODE_POS
    for c in (1, 4):
        args, kw = _decode_operands(35 + c, c, torch.bfloat16, pos, b=2,
                                    hkv=1, g=4, d=256, bkv=64,
                                    tn=LM_MAX_LEN // 64, k_sel=D256_K)
        say(f"[26 d256 decode kernel] {G3_ARCH} decode state (B 2, H 4, Hkv "
            f"1, D 256, bkv 64, Tn {LM_MAX_LEN // 64}, K {D256_K}, C {c}, "
            f"pos {pos}) K/V bf16")
        row = _decode_case(args, kw, f"C={c} bf16 D 256")
        dec_rows.append(dict(shape=f"{G3_ARCH} decode C={c} D 256",
                             dtype="bf16", c=c, pos=pos, head_dim=256,
                             **row))
        del args
    pos = D256_PAGED_POS
    shared = G3_PG_SHARED // 64
    npages = 2 + shared + G3_PG_SLOTS * (LM_MAX_LEN // 64 - shared)
    args, kw = cases.paged_decode_operands(
        37, torch.bfloat16, pos, b=G3_PG_SLOTS, hkv=1, g=4, d=256, bkv=64,
        tn=LM_MAX_LEN // 64, k_sel=D256_K, npages=npages, shared=shared,
        device=DEV)
    say(f"[26 d256 paged decode kernel] {G3_ARCH} paged state (B "
        f"{G3_PG_SLOTS}, H 4, Hkv 1, D 256, bkv 64, Tn {LM_MAX_LEN // 64}, "
        f"K {D256_K}, {npages} pages, {shared} shared, pos {pos}) K/V bf16")
    pg_rows = [dict(shape=f"{G3_ARCH} paged decode B={G3_PG_SLOTS} D 256",
                    dtype="bf16", pos=pos, head_dim=256,
                    **_paged_case(args, kw, "bf16 D 256"))]
    del args
    torch.cuda.empty_cache()
    bad = [(r["shape"], r.get("kernel"), r["dtype"])
           for r in fwd_rows + bwd_rows + dec_rows + pg_rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"head dim 256 kernels failed: {bad}")
    return fwd_rows, bwd_rows, dec_rows, pg_rows


def _lm_full(arch: str, seed: int):
    """Full-width `arch` with seeded random f32 weights on the card;
    sla_proj redrawn so that O^l reaches the logits."""
    cfg = get_arch(arch)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = transformer.init(gen, cfg, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
    return cfg, params


def _prefill_cross_check(tag: str, cfg, cparams, toks) -> dict:
    """The prefill's last-position logits on the kernel backend and on the
    gather backend given the kernel run's plans (execution isolated from
    planning): within LM_LOGIT_TOL x max(1, max |logits|). Returns the
    numbers and the kernel run's plans."""
    with torch.no_grad():
        x, _, plans = transformer.forward(cparams, cfg, toks,
                                          backend="kernel", return_plans=True)
        l_k = logits_from_hidden(cparams, x[:, -1])
        del x
        x, _ = transformer.forward(cparams, cfg, toks, backend="gather",
                                   plans=plans)
        l_g = logits_from_hidden(cparams, x[:, -1])
        del x
    diff = float((l_k - l_g).abs().max())
    limit = LM_LOGIT_TOL * max(1.0, float(l_k.abs().max()))
    agree = float((l_k.argmax(-1) == l_g.argmax(-1)).float().mean())
    ok = bool(torch.isfinite(l_k).all()) and diff <= limit
    say(f"[{tag} cross-check] prefill logits at the last position, kernel "
        f"vs gather on the kernel run's plans: max abs diff {diff:.3g} "
        f"(limit {limit:.3g}) {'OK' if ok else 'FAIL'}, greedy agreement "
        f"{agree:.2f}")
    return dict(diff=diff, limit=limit, greedy_agreement=agree, ok=ok), plans


def _static_run(tag: str, cfg, params, prompts, new: int, decode_sla: bool):
    """The static ServingEngine over `prompts` (one group) on the kernel
    backend: walls, peak, launches of kernels 1, 4 and 5 and the group's
    prefill tokens and decode state (kept by hooks)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    engine = ServingEngine(cfg, params, batch_size=len(prompts),
                           max_len=LM_MAX_LEN, backend="kernel",
                           decode_sla=decode_sla)
    kept = {}
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    run_prefill, decode_loop, one = (engine._run_prefill,
                                     engine._decode_loop, engine._one)

    def prefill_hook(toks):
        kept["toks"] = toks
        return run_prefill(toks)

    def decode_loop_hook(p, token, cache, n):
        token, cache, buf = decode_loop(p, token, cache, n)
        kept.update(token=token, cache=cache)
        return token, cache, buf

    def one_hook(p, token, cache):
        logits, cache = one(p, token, cache)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    engine._run_prefill, engine._decode_loop = prefill_hook, decode_loop_hook
    engine._one = one_hook
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = 0
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    _zero_head_dims()
    t0 = time.time()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    _read_head_dims(f"{cfg.name} static")
    launches = dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                    split_sla_fwd=sla_fwd.SPLIT_LAUNCHES,
                    sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES)
    st = engine.stats
    steps = new - 1
    res = dict(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               prefill_s=st.prefill_s, decode_s=st.decode_s,
               decode_ms_per_step=1e3 * st.decode_s / steps, steps=steps,
               launches=launches, bucket=int(kept["toks"].shape[1]),
               tokens_ok=[len(r.tokens_out) for r in done] == [new] * len(
                   prompts), finite=bool(finite),
               first_tokens=[r.tokens_out[:6] for r in done])
    say(f"[{tag}] static engine, {len(prompts)} prompts of "
        f"{[len(p) for p in prompts]} tokens (bucket {res['bucket']}), {new} "
        f"new, kernel backend, decode-SLA {decode_sla}, in {wall:.2f}s | "
        f"prefill {st.prefill_s:.3f}s | decode {st.decode_s:.3f}s for "
        f"{steps} steps = {res['decode_ms_per_step']:.2f} ms a step | peak "
        f"{res['peak_gib']:.2f} GiB | launches {launches} | finite "
        f"{res['finite']} | first tokens {res['first_tokens']}")
    return res, engine, kept


def _g3_paged_run(cfg, params) -> tuple:
    """gemma3's paged continuous Scheduler: G3_PG_SLOTS prompts of
    G3_PG_PROMPT tokens sharing their first G3_PG_SHARED, G3_PG_NEW new
    tokens each; kernel 5 against its twin on the live state of the first
    SLA layer at one step (`_paged_live_case`, uncounted)."""
    from repro_torch.serving.api import SamplingParams, Scheduler
    rs = np.random.default_rng(27)
    shared = rs.integers(0, cfg.vocab_size, G3_PG_SHARED).astype(np.int32)
    prompts = [np.concatenate([shared, rs.integers(
        0, cfg.vocab_size, G3_PG_PROMPT - G3_PG_SHARED).astype(np.int32)])
        for _ in range(G3_PG_SLOTS)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = Scheduler(cfg, params, num_slots=G3_PG_SLOTS,
                      max_len=G3_PG_MAX_LEN, backend="kernel",
                      decode_sla=True, prefill_bucket=G3_PG_PROMPT,
                      paged=True)
    scfg = sched.cfg
    sla_layer = transformer.layer_kinds_list(scfg).index(transformer.KIND_SLA)
    steps, prefills, live = [0], [], {}
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    one, run_prefill = sched._one, sched._run_prefill

    def one_hook(token):
        logits = one(token)
        steps[0] += 1
        finite.logical_and_(torch.isfinite(logits).all())
        if steps[0] == G3_PG_NEW // 2 and len(sched._decoding()) == \
                G3_PG_SLOTS:
            counts = (sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES)
            dims = _head_dim_snapshot()
            cache = sched._live
            gen = torch.Generator(device=DEV).manual_seed(17)
            q = torch.randn((G3_PG_SLOTS, scfg.num_heads, 1, scfg.head_dim),
                            generator=gen, device=DEV)
            live.update(_paged_live_case(scfg, cache, sla_layer, q,
                                         cache["pos"] - 1))
            sla_decode.PAGED_LAUNCHES, sla_decode.LAUNCHES = counts
            _restore_head_dims(dims)
        return logits

    def prefill_hook(toks):
        torch.cuda.synchronize()
        t0 = time.time()
        out = run_prefill(toks)
        torch.cuda.synchronize()
        prefills.append(time.time() - t0)
        return out

    sched._one, sched._run_prefill = one_hook, prefill_hook
    for p in prompts:
        sched.submit(p, SamplingParams(max_new_tokens=G3_PG_NEW,
                                       temperature=0.0))
    sla_decode.PAGED_LAUNCHES = sla_decode.LAUNCHES = 0
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    _zero_head_dims()
    t0 = time.time()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    _read_head_dims(f"{cfg.name} paged")
    launches = dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                    split_sla_fwd=sla_fwd.SPLIT_LAUNCHES,
                    sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES)
    st = sched.stats
    nsla = transformer.layer_kinds_list(scfg).count(transformer.KIND_SLA)
    want = dict(sla_fwd=nsla * len(prefills), tc_sla_fwd=0, split_sla_fwd=0,
                sla_decode=0, sla_decode_paged=nsla * steps[0])
    runs = live.pop("runs", [])
    res = dict(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               prefill_s=prefills, decode_s=st.decode_s, steps=steps[0],
               decode_ms_per_step=1e3 * st.decode_s / max(steps[0], 1),
               pages_peak=st.pages_peak, prefix_hits=st.prefix_hits,
               prefix_misses=st.prefix_misses, launches=launches,
               finite=bool(finite),
               tokens_ok=[len(r.tokens_out) for r in done]
               == [G3_PG_NEW] * len(prompts))
    ok = (res["tokens_ok"] and res["finite"] and launches == want
          and bool(live) and live.get("ok", False))
    say(f"[27 gemma3 paged] continuous Scheduler, {G3_PG_SLOTS} prompts of "
        f"{G3_PG_PROMPT} tokens sharing {G3_PG_SHARED}, {G3_PG_NEW} new, "
        f"paged (max_len {G3_PG_MAX_LEN}), kernel backend, decode-SLA, in "
        f"{wall:.2f}s | prefills {[round(t, 3) for t in prefills]} s | "
        f"decode {st.decode_s:.3f}s for {steps[0]} steps = "
        f"{res['decode_ms_per_step']:.2f} ms a step | pages peak "
        f"{st.pages_peak}, prefix hits {st.prefix_hits} / misses "
        f"{st.prefix_misses} | peak {res['peak_gib']:.2f} GiB | launches "
        f"{launches} (expected {want})")
    if live:
        say(f"[27 gemma3 paged] sla_decode_paged vs twin on layer "
            f"{sla_layer}'s live state (D 256), bitwise equal to sla_decode "
            f"on the gathered view at each width "
            f"{live['bitwise_vs_sla_decode']}: {_runs_text(runs)} (limit "
            f"{live['limit']:.3g}) {'OK' if live['ok'] else 'FAIL'} | eager "
            f"call {live['eager_ms']:.4f} ms | bound {live['bound_ms']:.4f} "
            f"ms by {live['bound_by']} ({live['mbytes']:.1f} MB; "
            f"{live['bound_fraction']:.1%} of it) | plain twin "
            f"{live['plain_ms']:.3f} ms")
    row = dict(live, shape=f"{G3_ARCH} paged path layer {sla_layer} D 256",
               dtype="bf16", head_dim=256) if live else None
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"gemma3 paged serving failed its checks: {res}, "
                           f"kernel 5 on the live state {live.get('ok')}")
    return res, row


def phase_gemma3_serving():
    """Phase 27: gemma3-1b at full width and depth (26 layers: 22
    sliding-window layers with a 512-token window, 4 SLA layers; 4 query
    heads on 1 kv head of 256; vocab 262,144), f32 masters, bf16 compute.
    The static engine with decode-time SLA (G3_BATCH prompts of G3_PROMPT
    tokens, G3_NEW new): 4 kernel-1 launches a prefill forward, all on the
    f32-FMA route, 4 kernel-4 launches a decode step; the prefill logits
    kernel vs gather on the kernel run's plans; kernel 4 against its twin
    on the path's decode state. Then the paged continuous Scheduler
    (`_g3_paged_run`). Returns (summary, decode rows, paged rows)."""
    cfg, params = _lm_full(G3_ARCH, seed=0)
    kinds = transformer.layer_kinds_list(cfg)
    nsla = kinds.count(transformer.KIND_SLA)
    nparams = sum(p.numel() for p in params.parameters())
    say(f"[27 gemma3] {G3_ARCH} at full width and depth: {cfg.num_layers} "
        f"layers ({kinds.count(transformer.KIND_SWA)} sliding-window, window "
        f"{cfg.local_window}; {nsla} SLA), d_model {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}: {nparams:,} parameters in f32")
    rs = np.random.default_rng(26)
    prompts = [rs.integers(0, cfg.vocab_size, G3_PROMPT).astype(np.int32)
               for _ in range(G3_BATCH)]
    res, engine, kept = _static_run("27 gemma3", cfg, params, prompts,
                                     G3_NEW, decode_sla=True)
    want = dict(sla_fwd=nsla, tc_sla_fwd=0, split_sla_fwd=0,
                sla_decode=nsla * res["steps"], sla_decode_paged=0)
    bad = []
    if not (res["tokens_ok"] and res["finite"]):
        bad.append("a request did not finish with finite logits")
    if res["launches"] != want:
        bad.append(f"launches {res['launches']}, expected {want}")
    # kernel 4 against its twin on the path's live rows (the first and
    # last SLA layer)
    cache, cparams = kept.pop("cache"), engine._cparams
    st_ = cache["sla"]
    bkv, hkv = cfg.sla.block_kv, cfg.num_kv_heads
    g = cfg.num_heads // hkv
    pos = cache["pos"] - 1
    gen = torch.Generator(device=DEV).manual_seed(18)
    dec_rows = []
    for layer in (kinds.index(transformer.KIND_SLA), len(kinds) - 1 -
                  kinds[::-1].index(transformer.KIND_SLA)):
        state = {"k": cache["k"][layer], "v": cache["v"][layer],
                 "hblk": st_["hblk"][layer], "zblk": st_["zblk"][layer],
                 "htot": st_["htot"][layer], "ztot": st_["ztot"][layer],
                 "lut": st_["live_lut"][layer], "cnt": st_["live_cnt"][layer],
                 "marg": st_["live_marg"][layer]}
        q = torch.randn((G3_BATCH, cfg.num_heads, 1, cfg.head_dim),
                        generator=gen, device=DEV)
        qg = backend_lib._group_heads(q[:, :, 0].float(), hkv)[..., None, :]
        qpg = backend_lib._group_heads(phi(q[:, :, 0], cfg.sla.phi),
                                       hkv)[..., None, :]
        flat = sla_decode._flat_args(
            *sla_decode.decode_operands(state, qg, qpg, pos), bkv)
        kw = dict(scale=cfg.head_dim ** -0.5, block_kv=bkv, group=g)
        row = _decode_case(flat, kw, f"[27 gemma3] sla_decode vs twin on "
                           f"layer {layer}'s path state (D 256, K/V bf16, "
                           f"pos {pos})")
        dec_rows.append(dict(shape=f"{G3_ARCH} path layer {layer} D 256",
                             dtype="bf16", c=1, pos=pos, head_dim=256, **row))
        del state, flat
    del cache, kept["token"], st_
    gc.collect()
    torch.cuda.empty_cache()
    cross, plans = _prefill_cross_check("27 gemma3", cfg, cparams,
                                        kept["toks"])
    del plans, engine, cparams, kept
    gc.collect()
    torch.cuda.empty_cache()
    paged, pg_row = _g3_paged_run(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not cross["ok"]:
        bad.append(f"prefill logits kernel vs gather {cross}")
    bad += [r["shape"] for r in dec_rows if not r["ok"]]
    if bad:
        raise RuntimeError("gemma3 serving failed: " + "; ".join(bad))
    res.update(params=nparams, cross_check=cross, paged=paged)
    return res, dec_rows, [pg_row]


def phase_danube_serving():
    """Phase 28: h2o-danube-3-4b at full width and depth (24 SLA layers,
    32 / 8 heads of 120, window 8,192 inside the SLA mask), f32 masters,
    bf16 compute: the static engine with dense decode (decode-time SLA
    refuses a window, as the reference), DN_BATCH prompts of DN_PROMPT
    tokens and DN_NEW new. 24 kernel-1 launches a prefill on the
    tensor-core route (D 120 padded to 128), none of kernels 4-5; the
    prefill logits kernel vs gather on the kernel run's plans; no block of
    those plans classified (critical or marginal) at a distance of window
    + block_kv or more (`core/masks.py::block_valid`). Returns the
    summary."""
    cfg, params = _lm_full(DN_ARCH, seed=0)
    nl = cfg.num_layers
    nparams = sum(p.numel() for p in params.parameters())
    say(f"[28 danube] {DN_ARCH} at full width and depth: {nl} SLA layers "
        f"with window {cfg.sliding_window}, d_model {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"vocab {cfg.vocab_size}: {nparams:,} parameters in f32")
    rs = np.random.default_rng(28)
    prompts = [rs.integers(0, cfg.vocab_size, DN_PROMPT).astype(np.int32)
               for _ in range(DN_BATCH)]
    res, engine, kept = _static_run("28 danube", cfg, params, prompts,
                                    DN_NEW, decode_sla=False)
    route = sla_fwd.forward_route(torch.bfloat16, cfg.sla.block_q,
                                  cfg.sla.block_kv, cfg.head_dim)
    want = dict(sla_fwd=nl, tc_sla_fwd=nl * (route == "tc"), split_sla_fwd=0,
                sla_decode=0, sla_decode_paged=0)
    bad = []
    if not (res["tokens_ok"] and res["finite"]):
        bad.append("a request did not finish with finite logits")
    if res["launches"] != want:
        bad.append(f"launches {res['launches']}, expected {want}")
    cparams, toks = engine._cparams, kept["toks"]
    del kept, engine
    gc.collect()
    torch.cuda.empty_cache()
    cross, plans = _prefill_cross_check("28 danube", cfg, cparams, toks)
    sla = cfg.sla
    tm, tn = plans.mc.shape[-2:]
    qi = torch.arange(tm, device=DEV)[:, None] * sla.block_q
    kj = torch.arange(tn, device=DEV)[None, :] * sla.block_kv
    far = (qi - kj).abs() >= cfg.sliding_window + sla.block_kv
    classified = plans.mc != -1
    outside = int((classified & far).sum())
    inside = int(classified.sum())
    reach = int(((qi - kj) * classified.any(dim=(0, 1, 2))).max())
    say(f"[28 danube] the prefill plans ({nl} layers, {tm} x {tn} blocks): "
        f"{inside} classified blocks, {outside} of them at a distance of "
        f"window + block_kv = {cfg.sliding_window + sla.block_kv} tokens or "
        f"more (the farthest classified block starts {reach} tokens before "
        f"its query block) {'OK' if outside == 0 else 'FAIL'}")
    del plans, cparams, params
    gc.collect()
    torch.cuda.empty_cache()
    if not cross["ok"]:
        bad.append(f"prefill logits kernel vs gather {cross}")
    if outside:
        bad.append(f"{outside} classified blocks outside the window")
    if bad:
        raise RuntimeError("danube serving failed: " + "; ".join(bad))
    res.update(params=nparams, cross_check=cross, classified_blocks=inside,
               classified_outside_window=outside, farthest_block_tokens=reach)
    return res


def phase_vlm_train():
    """Phase 29: internvl2-1b at full width and depth (24 layers, 14 / 2
    heads of 64, 256 patch embeddings ahead of 3,840 tokens, vocab
    151,655), f32 masters, at train_4k with the global batch 256 cut to
    VL_BATCH: `_family_train` (48 / 24 / 24 tensor-core launches of
    kernels 1 / 2 / 3 a step, 24 plans), kernels 1-3 on the last step's
    plans of layers 0 and 23, and the train CLI. Returns (summary,
    forward rows, backward rows)."""
    cfg = get_arch(VL_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = transformer.init(gen, cfg, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
    nl = cfg.num_layers
    nparams = sum(p.numel() for p in params.parameters())
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=VL_BATCH)
    say(f"[29 vlm train] {VL_ARCH} at full width and depth: {nl} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, {cfg.num_patches} patches + "
        f"{shape.seq_len - cfg.num_patches} tokens, vocab {cfg.vocab_size}: "
        f"{nparams:,} parameters in f32 | train_4k, batch {VL_BATCH} (global "
        f"256 cut)")
    data = make_iterator(cfg, shape, DataConfig(seed=0))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in next(data).items()}
               for _ in range(VL_STEPS)]
    tc = int(sla_fwd.use_tensor_cores(torch.bfloat16, cfg.sla.block_q,
                                      cfg.sla.block_kv, cfg.head_dim))
    want = dict(sla_fwd=2 * nl, tc_sla_fwd=2 * nl * tc, sla_bwd_dq=nl,
                tc_sla_bwd_dq=nl * tc, sla_bwd_dkv=nl,
                tc_sla_bwd_dkv=nl * tc, plan_builds=nl)
    probes = ("layers.0.wq", f"layers.{nl - 1}.sla_proj", "embed")
    train, plans, _ = _family_train("29 vlm train", cfg, transformer,
                                    params, batches, want, probes,
                                    (0, nl - 1), profile=False,
                                    path="vlm_train")
    del batches, params
    gc.collect()
    torch.cuda.empty_cache()
    fwd_rows, bwd_rows = _family_kernel_rows(
        "29 vlm train", VL_ARCH, {f"layer {li}": plan
                                  for li, plan in plans.items()},
        causal=True, batch=VL_BATCH, n=shape.seq_len)
    del plans
    cli = _family_cli("29 vlm train", VL_ARCH, 2)
    train.update(params=nparams, cli_losses=cli)
    return train, fwd_rows, bwd_rows


def _g3_checkpoint(state: dict) -> dict:
    """The gemma3 training state (f32 masters, AdamW's moments and step)
    saved once through `CheckpointManager` into the checkout's ignored
    build/ directory, restored onto the card, held bitwise, deleted. The
    free disk space is printed first; below twice the state's bytes the
    save runs on a smoke-width model's state instead (a disk limit, not
    the card's). Times: the save's blocking part (the snapshot to host
    memory, what the training loop waits for), the writer thread's rest,
    and the restore."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(state))
    root = ROOT / "build" / "g3_checkpoint"
    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free
    width = "full"
    say(f"[30 gemma3 train] checkpoint: state {nbytes / 1e9:.3f} GB "
        f"({len(list(_tensors(state)))} tensors), free disk "
        f"{free / 1e9:.1f} GB")
    if free < 2 * nbytes:
        say(f"[30 gemma3 train] free disk {free / 1e9:.1f} GB is under "
            f"twice the state's {nbytes / 1e9:.3f} GB: the checkpoint is "
            f"saved at smoke width instead")
        width = "smoke"
        cfg = get_arch(G3_ARCH).smoke()
        model = transformer.init(torch.Generator(device=DEV).manual_seed(1),
                                 cfg, device=DEV)
        small = dict(model.named_parameters())
        state = {"params": small, "opt": adamw.init(small)}
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(state))
    mgr = CheckpointManager(root, keep=1)
    torch.cuda.synchronize()
    t0 = time.time()
    mgr.save(1, state)
    blocked = time.time() - t0
    mgr.wait()
    written = time.time() - t0 - blocked
    t0 = time.time()
    back = mgr.restore(1, state)
    torch.cuda.synchronize()
    restored = time.time() - t0
    bitwise = all(a.device == b.device and torch.equal(a, b) for a, b in
                  zip(_tensors(back), _tensors(state)))
    del back
    shutil.rmtree(root)
    say(f"[30 gemma3 train] checkpoint at {width} width, {nbytes / 1e9:.3f} "
        f"GB: save blocked the loop {blocked:.3f}s (device->host snapshot), "
        f"the writer {written:.3f}s more; restore onto the card "
        f"{restored:.3f}s, bitwise {bitwise} {'OK' if bitwise else 'FAIL'}")
    return dict(width=width, gbytes=nbytes / 1e9, free_disk_gb=free / 1e9,
                save_blocked_s=blocked, writer_s=written,
                restore_s=restored, bitwise=bitwise)


def _g3_cli_resume() -> dict:
    """The train CLI at smoke gemma3 on the card with error-feedback
    compression, checkpointing every step into a temporary directory
    under build/: 4 steps straight, then every checkpoint past step 2
    deleted and the same command again, which resumes at step 2. Its two
    losses within 5e-2 of the straight run's last two (the CPU tests'
    LOSS_TOL: the compression error is not checkpointed, so the resumed
    run's updates start from a zero error); whether they are bitwise
    equal is printed."""
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        argv = ["--arch", G3_ARCH, "--smoke", "--steps", "4", "--ckpt-dir",
                tmp, "--ckpt-every", "1", "--compress-grads", "--device",
                "cuda", "--log-every", "1"]
        t0 = time.time()
        straight = train_cli.main(argv)
        kept = sorted(p.name for p in Path(tmp).iterdir())
        for p in Path(tmp).iterdir():
            if int(p.name.split("_")[1].split(".")[0]) > 2:
                shutil.rmtree(p)
        resumed = train_cli.main(argv)
        wall = time.time() - t0
    diffs = [abs(a - b) for a, b in zip(resumed, straight[2:])]
    bitwise = [a == b for a, b in zip(resumed, straight[2:])]
    ok = (len(straight) == 4 and len(resumed) == 2
          and bool(np.isfinite(straight).all()) and max(diffs) <= 5e-2)
    say(f"[30 gemma3 train CLI] repro_torch.launch.train {' '.join(argv)}: "
        f"straight {straight} (checkpoints kept {kept}); after deleting "
        f"those past step_2, resumed {resumed} | diffs {diffs} (limit "
        f"5e-2), bitwise {bitwise} | {wall:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"gemma3 train CLI resume: straight {straight}, "
                           f"resumed {resumed}")
    return dict(straight=straight, resumed=resumed, diffs=diffs,
                bitwise=bitwise, wall_s=wall)


def phase_gemma3_train(profile: bool):
    """Phase 30: gemma3-1b trained at full width and depth (26 layers: 22
    sliding-window layers through the gather `_swa_attention`, 4 SLA
    layers of 4 query heads on 1 kv head of 256; d_model 1152; vocab
    262,144), f32 masters, bf16 compute, kernel backend, the reference's
    remat, at train_4k with the global batch 256 cut to G3T_BATCH:
    `_family_train` (8 / 4 / 4 launches of kernels 1 / 2 / 3 a step, all
    on the f32-FMA route at head dim 256 in the wrappers' records, 4
    plans), with the state saved and restored once (`_g3_checkpoint`);
    kernels 1-3 on the last step's plans of SLA layers 5 and 23; the train
    CLI's checkpoint resume (`_g3_cli_resume`). `profile` adds a profile
    of one more step (the f32-FMA kernels' mean device times). Returns
    (summary, forward rows, backward rows)."""
    cfg, params = _lm_full(G3_ARCH, seed=0)
    kinds = transformer.layer_kinds_list(cfg)
    sla_layers = [li for li, kind in enumerate(kinds)
                  if kind == transformer.KIND_SLA]
    nsla = len(sla_layers)
    nparams = sum(p.numel() for p in params.parameters())
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=G3T_BATCH)
    say(f"[30 gemma3 train] {G3_ARCH} at full width and depth: "
        f"{cfg.num_layers} layers ({kinds.count(transformer.KIND_SWA)} "
        f"sliding-window, window {cfg.local_window}; SLA layers "
        f"{sla_layers}), d_model {cfg.d_model}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}: {nparams:,} parameters, {4 * nparams / 1e9:.2f} "
        f"GB of f32 masters, {12 * nparams / 1e9:.2f} GB with AdamW's "
        f"moments | train_4k (seq {shape.seq_len}), batch {G3T_BATCH} "
        f"(global 256 cut)")
    data = make_iterator(cfg, shape, DataConfig(seed=0))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in next(data).items()}
               for _ in range(G3T_STEPS)]
    want = dict(sla_fwd=2 * nsla, tc_sla_fwd=0, sla_bwd_dq=nsla,
                tc_sla_bwd_dq=0, sla_bwd_dkv=nsla, tc_sla_bwd_dkv=0,
                plan_builds=nsla)
    d = cfg.head_dim
    want_dims = {"sla_fwd": {d: 2 * nsla}, "sla_bwd_dq": {d: nsla},
                 "sla_bwd_dkv": {d: nsla}}
    probes = (f"layers.{sla_layers[0]}.sla_proj", "layers.0.wq", "embed")
    train, plans, state = _family_train(
        "30 gemma3 train", cfg, transformer, params, batches, want, probes,
        (0, nsla - 1), profile=profile, path="gemma3_train",
        want_dims=want_dims, keep_state=True,
        kernel_names=("sla_fwd_kernel", "sla_bwd_dq_wide_kernel",
                      "sla_bwd_dkv_wide_kernel"))
    del batches
    train["checkpoint"] = _g3_checkpoint(state)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    if not train["checkpoint"]["bitwise"]:
        raise RuntimeError(f"gemma3 checkpoint round trip: "
                           f"{train['checkpoint']}")
    fwd_rows, bwd_rows = _family_kernel_rows(
        "30 gemma3 train", G3_ARCH,
        {f"layer {sla_layers[i]}": plan for i, plan in plans.items()},
        causal=True, batch=G3T_BATCH, n=shape.seq_len)
    del plans
    cli = _g3_cli_resume()
    train.update(params=nparams, cli_resume=cli)
    return train, fwd_rows, bwd_rows


def _mesh_train_run(batches, mesh, path: str, profile: bool = False,
                    make=None) -> dict:
    """LT_STEPS `loss_fn` steps of phase 21 (its weights from
    `_lm_model(0)`, or the (cfg, params) `make()` returns; its AdamW
    settings, kernel backend, bf16 compute, remat) on the plain path
    (`mesh` None) or with every parameter and moment a DTensor on `mesh`.
    Returns the losses and grad norms (as tensors), each step's wall,
    peak and launches, and the final parameters (local tensors). With
    `profile`, one more step (on the first batch, after the final
    parameters were copied aside) runs under torch.profiler: its device
    time and busy share ("profile")."""
    from repro_torch.distributed import sharding
    cfg, params = (make or functools.partial(_lm_model, seed=0))()
    if mesh is not None:
        sharding.place_module(params, mesh)
    named = dict(params.named_parameters())
    opt_state = adamw.init(named)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=1,
                                total_steps=LT_STEPS + 1)
    step_fn = train_steps.make_train_step(cfg, opt_cfg, backend="kernel")
    rows_seq = next(iter(batches[0].values())).shape[:2]
    residual = (None if mesh is None else actx.default_residual_spec(
        mesh, *rows_seq))
    plans, orig_plan = [], plan_lib.plan_attention

    def counted_plan(*a, **kw):
        plans.append(orig_plan(*a, **kw))
        return plans[-1]

    rows, losses, gnorms = [], [], []
    plan_lib.plan_attention = counted_plan
    try:
        with actx.activation_sharding(mesh, residual, remat=True):
            for batch in batches[:LT_STEPS]:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_kernel_counts()
                t0 = time.time()
                params, opt_state, loss, gnorm = step_fn(params, opt_state,
                                                         batch)
                torch.cuda.synchronize()
                wall = time.time() - t0
                rows.append(dict(wall_s=wall, peak_gib=torch.cuda
                                 .max_memory_allocated() / 2**30,
                                 **_kernel_counts(plans, path)))
                plans.clear()
                losses.append(loss)
                gnorms.append(gnorm)
            final = {n: sharding.local(p).detach() for n, p in
                     named.items()}
            prof_res = None
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                final = {n: t.clone() for n, t in final.items()}
                torch.cuda.synchronize()
                t0 = time.time()
                with prof_ctx(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    step_fn(params, opt_state, batches[0])
                    torch.cuda.synchronize()
                prof_res = _busy(prof, time.time() - t0)
                say(f"[32 lm train mesh profile] {path}: one more step "
                    f"{prof_res}")
                say(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=15))
    finally:
        plan_lib.plan_attention = orig_plan
    return dict(losses=losses, gnorms=gnorms, rows=rows, final=final,
                profile=prof_res)


def _mesh_cli_resume() -> dict:
    """The train CLI at smoke qwen3 on the initialized world of one (so
    on a 1 x 1 mesh): MESH_CLI_STEPS steps checkpointing every
    MESH_CLI_EVERY into a temporary directory under build/, the last
    checkpoint copied aside and deleted, the same command again, which
    resumes from the one before. Its losses, and the checkpoint it
    writes again, bitwise the straight run's. `place_module` and
    `restore(shardings=)` are counted: the CLI took the mesh path."""
    from repro_torch.distributed import sharding
    calls = dict(place_module=0, restore_shardings=0)
    place, restore = sharding.place_module, CheckpointManager.restore

    def placed(*a, **kw):
        calls["place_module"] += 1
        return place(*a, **kw)

    def restored(self, *a, **kw):
        calls["restore_shardings"] += kw.get("shardings") is not None
        return restore(self, *a, **kw)

    sharding.place_module, CheckpointManager.restore = placed, restored
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            argv = ["--arch", LM_ARCH, "--smoke", "--steps",
                    str(MESH_CLI_STEPS), "--ckpt-dir", tmp, "--ckpt-every",
                    str(MESH_CLI_EVERY), "--device", "cuda", "--log-every",
                    "1"]
            t0 = time.time()
            straight = train_cli.main(argv)
            last = Path(tmp) / f"step_{MESH_CLI_STEPS}"
            aside = Path(tmp) / "straight_last"
            shutil.copytree(last, aside)
            shutil.rmtree(last)
            resumed = train_cli.main(argv)
            names = sorted(p.name for p in aside.iterdir())
            same_files = names == sorted(p.name for p in last.iterdir()) \
                and all((aside / n).read_bytes() == (last / n).read_bytes()
                        for n in names)
            wall = time.time() - t0
    finally:
        sharding.place_module, CheckpointManager.restore = place, restore
    resume_at = MESH_CLI_STEPS - MESH_CLI_EVERY
    bitwise = resumed == straight[resume_at:]
    ok = (len(straight) == MESH_CLI_STEPS and bitwise and same_files
          and calls == dict(place_module=2, restore_shardings=1))
    say(f"[32 mesh train CLI] repro_torch.launch.train {' '.join(argv)} on "
        f"a world of 1: straight {straight}; step_{MESH_CLI_STEPS} deleted, "
        f"resumed from step_{resume_at}: {resumed} | losses bitwise "
        f"{bitwise}, step_{MESH_CLI_STEPS} files ({len(names)}) bitwise "
        f"{same_files} | {calls} | {wall:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"mesh train CLI resume: straight {straight}, "
                           f"resumed {resumed}, files {same_files}, {calls}")
    return dict(straight=straight, resumed=resumed, files_bitwise=same_files,
                calls=calls, wall_s=wall)


def phase_lm_train_mesh(lt: dict, profile: bool = False) -> dict:
    """Phase 32: the training path over a DeviceMesh, at world size 1 on
    this card (NCCL in this process through a FileStore; the group is
    destroyed before returning). Phase 21's first LT_STEPS steps on the
    plain path and then on `make_host_mesh(1, 1)`: bitwise the same
    losses, grad norms and final parameters, the same launches of kernels
    1-3 (all on tensor cores); then the train CLI's sharded checkpoint
    resume (`_mesh_cli_resume`). `lt` is phase 21's summary (its walls
    and peaks printed beside). With `profile`, each run profiles one more
    step (`_mesh_train_run`). Returns the summary."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    nl = get_arch(LM_ARCH).num_layers
    want = dict(sla_fwd=2 * nl, tc_sla_fwd=2 * nl, sla_bwd_dq=nl,
                tc_sla_bwd_dq=nl, sla_bwd_dkv=nl, tc_sla_bwd_dkv=nl,
                plan_builds=nl)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=LT_BATCH)
    data = make_iterator(get_arch(LM_ARCH), shape, DataConfig(seed=0))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in
                next(data).items()} for _ in range(LT_STEPS)]
    t_all = time.time()
    plain = _mesh_train_run(batches, None, "lm_train", profile)
    final = plain.pop("final")
    # the plain run's final parameters stay on the card for the
    # comparison: the mesh run's peaks are printed without them
    held = sum(t.numel() * t.element_size() for t in final.values()) / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        sharded = _mesh_train_run(batches, mesh, "lm_train_mesh", profile)
        got = sharded.pop("final")
        diff = [n for n in final if not torch.equal(got[n], final[n])]
        del got, final
        gc.collect()
        torch.cuda.empty_cache()
        cli = _mesh_cli_resume()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    same_loss = all(torch.equal(a, b) for a, b in
                    zip(sharded["losses"], plain["losses"]))
    same_gnorm = all(torch.equal(a, b) for a, b in
                     zip(sharded["gnorms"], plain["gnorms"]))
    counts = {k: [r[k] for r in sharded["rows"]] for k in want}
    p21 = lt["steps"][:LT_STEPS]
    for i, (a, b) in enumerate(zip(plain["rows"], sharded["rows"])):
        b["peak_gib"] -= held
        say(f"[32 lm train mesh] step {i}: loss "
            f"{float(sharded['losses'][i]):.6f} grad norm "
            f"{float(sharded['gnorms'][i]):.6f} | mesh 1x1 {b['wall_s']:.3f}s "
            f"peak {b['peak_gib']:.2f} GiB (without the {held:.2f} GiB of "
            f"plain parameters held) | plain {a['wall_s']:.3f}s peak "
            f"{a['peak_gib']:.2f} GiB | phase 21 {p21[i]['wall_s']:.3f}s "
            f"peak {p21[i]['peak_gib']:.2f} GiB | launches "
            f"{ {k: b[k] for k in want} }")
    ok = (same_loss and same_gnorm and not diff
          and all({k: r[k] for k in want} == want
                  for r in plain["rows"] + sharded["rows"]))
    say(f"[32 lm train mesh] {LM_ARCH} full width over make_host_mesh(1, 1): "
        f"losses bitwise {same_loss}, grad norms bitwise {same_gnorm}, "
        f"final parameters differing {len(diff)} {diff[:5]} | launches a "
        f"step expected {want} | {time.time() - t_all:.1f}s "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"mesh path vs plain path: losses {same_loss}, "
                           f"grad norms {same_gnorm}, params {diff[:5]}, "
                           f"launches {counts}")
    launches = {k: sum(r[k] for r in sharded["rows"]) for k in want}
    return dict(steps=[dict(step=i, loss=float(sharded["losses"][i]),
                            grad_norm=float(sharded["gnorms"][i]),
                            wall_s=b["wall_s"], peak_gib=b["peak_gib"],
                            plain_wall_s=a["wall_s"],
                            plain_peak_gib=a["peak_gib"],
                            phase21_wall_s=p21[i]["wall_s"],
                            phase21_peak_gib=p21[i]["peak_gib"])
                       for i, (a, b) in enumerate(zip(plain["rows"],
                                                      sharded["rows"]))],
                bitwise=dict(losses=same_loss, grad_norms=same_gnorm,
                             params=not diff),
                held_gib=held, launches=launches, cli=cli,
                profile=dict(plain=plain["profile"],
                             mesh=sharded["profile"]),
                wall_s=time.time() - t_all)


def _family_mesh_check(arch: str, layers, seed: int, mesh) -> dict:
    """Phase 33 for one model: `arch` at full width (its depth cut to
    `layers` when given), f32 masters from `seed` with every sla_proj
    redrawn, LT_STEPS AdamW steps of train_4k at batch 1 on the plain
    path, then the same steps on `mesh` (`_mesh_train_run`). Losses, grad
    norms and final parameters must be bitwise equal, the launches of
    kernels 1-3 and the plan builds equal step by step, and an MoE
    model's kept slots (`keep_all` of every router call) bitwise equal.
    Returns the summary."""
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    mdl = registry.get_model(cfg)
    # SLA launches of kernels 1 / 2 / 3 a step (tensor cores: bf16
    # compute) and plan builds: an MoE layer's SLA forward runs twice
    # under remat, as an encoder layer's; the hybrid's shared block is
    # not rematerialized; rwkv6 does not attend
    n = {"moe": (2 * cfg.num_layers, cfg.num_layers),
         "encdec": (2 * cfg.encoder_layers, cfg.encoder_layers),
         "hybrid": (len(hybrid.segments(cfg)), len(hybrid.segments(cfg))),
         "ssm": (0, 0)}[cfg.family]
    want = dict(sla_fwd=n[0], tc_sla_fwd=n[0], sla_bwd_dq=n[1],
                tc_sla_bwd_dq=n[1], sla_bwd_dkv=n[1], tc_sla_bwd_dkv=n[1],
                plan_builds=n[1])

    def make():
        gen = torch.Generator(device=DEV).manual_seed(seed)
        params = mdl.init(gen, cfg, device=DEV)
        _redraw(gen, [p for n, p in params.named_parameters()
                      if n.endswith("sla_proj")])
        return cfg, params

    shape = dataclasses.replace(get_shape("train_4k"), global_batch=1)
    data = make_iterator(cfg, shape, DataConfig(seed=seed))
    batches = [{k: torch.from_numpy(x).to(DEV) for k, x in
                next(data).items()} for _ in range(LT_STEPS)]
    orig_route = moe_lib.route
    t_all = time.time()
    runs = {}
    try:
        for name, m in (("plain", None), ("mesh", mesh)):
            slots = []

            def route(*a, **kw):
                r = orig_route(*a, **kw)
                slots.append(r["keep_all"])
                return r

            moe_lib.route = route
            runs[name] = _mesh_train_run(batches, m, f"{cfg.family}"
                                         f"_train_mesh_{name}", make=make)
            runs[name]["slots"] = slots
            if name == "plain":
                # the plain run's final parameters stay on the card for
                # the comparison: the mesh run's peaks are printed
                # without them
                held = sum(t.numel() * t.element_size() for t in
                           runs[name]["final"].values()) / 2**30
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        moe_lib.route = orig_route
    plain, sharded = runs["plain"], runs["mesh"]
    final, got = plain.pop("final"), sharded.pop("final")
    diff = [n for n in final if not torch.equal(got[n], final[n])]
    nparams = sum(t.numel() for t in final.values())
    del got, final
    same_loss = all(torch.equal(a, b) for a, b in
                    zip(sharded["losses"], plain["losses"]))
    same_gnorm = all(torch.equal(a, b) for a, b in
                     zip(sharded["gnorms"], plain["gnorms"]))
    same_slots = (len(plain["slots"]) == len(sharded["slots"]) and all(
        torch.equal(a, b) for a, b in zip(plain["slots"], sharded["slots"])))
    dropped = [int((~k).sum()) for k in sharded["slots"]]
    counts, plain_counts = ([{k: v for k, v in r.items()
                              if k not in ("wall_s", "peak_gib")}
                             for r in run["rows"]] for run in (sharded, plain))
    same_launches = counts == plain_counts and all(c == want for c in counts)
    tag = "[33 family train mesh]"
    cut = (f"depth cut {get_arch(arch).num_layers} -> {layers} layers"
           if layers is not None else "full depth")
    for i, (a, b) in enumerate(zip(plain["rows"], sharded["rows"])):
        b["peak_gib"] -= held
        say(f"{tag} {arch} step {i}: loss {float(sharded['losses'][i]):.6f} "
            f"grad norm {float(sharded['gnorms'][i]):.6f} | mesh 1x1 "
            f"{b['wall_s']:.3f}s peak {b['peak_gib']:.2f} GiB (without the "
            f"{held:.2f} GiB of plain parameters held) | plain "
            f"{a['wall_s']:.3f}s peak {a['peak_gib']:.2f} GiB | launches "
            f"{counts[i]} (plain {plain_counts[i]}, expected {want})")
    ok = (same_loss and same_gnorm and not diff and same_slots
          and same_launches and all(np.isfinite(float(x))
                                    for x in sharded["losses"]))
    say(f"{tag} {arch} ({cfg.family}, full width, {cut}, {nparams:,} "
        f"parameters in f32) over make_host_mesh(1, 1): losses bitwise "
        f"{same_loss}, grad norms bitwise {same_gnorm}, final parameters "
        f"differing {len(diff)} {diff[:5]}, launches equal "
        f"{same_launches}"
        + (f", MoE kept slots bitwise {same_slots} over {len(dropped)} "
           f"router calls, dropped slots a call {dropped}" if dropped
           else "")
        + f" | {time.time() - t_all:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(
            f"{arch} mesh path vs plain path: losses {same_loss}, grad "
            f"norms {same_gnorm}, params {diff[:5]}, slots {same_slots}, "
            f"launches {counts} vs {plain_counts}, expected {want}")
    return dict(arch=arch, family=cfg.family, layers=cfg.num_layers,
                depth_cut=layers is not None, params=nparams,
                steps=[dict(step=i, loss=float(sharded["losses"][i]),
                            grad_norm=float(sharded["gnorms"][i]),
                            wall_s=b["wall_s"], peak_gib=b["peak_gib"],
                            plain_wall_s=a["wall_s"],
                            plain_peak_gib=a["peak_gib"])
                       for i, (a, b) in enumerate(zip(plain["rows"],
                                                      sharded["rows"]))],
                held_gib=held, dropped_slots=dropped,
                launches={k: sum(r[k] for r in counts)
                          for k in counts[0]},
                wall_s=time.time() - t_all)


def phase_family_train_mesh() -> dict:
    """Phase 33: phase 32 for the hybrid, encdec, MoE and ssm families
    (`P33_MODELS`): each model's plain and 1 x 1 mesh runs
    (`_family_mesh_check`) in one NCCL group of world size 1 through a
    FileStore under build/, destroyed at the end. Returns {arch:
    summary}."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        for arch, layers, seed in P33_MODELS:
            out[arch] = _family_mesh_check(arch, layers, seed, mesh)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    say(f"[33 family train mesh] {len(out)} models bitwise on the mesh path "
        f"| {time.time() - t_all:.1f}s")
    return out


def _serve_run(cfg, params, batch, cache_len, new: int, path: str) -> dict:
    """`make_prefill_step(cfg, "kernel", cache_len=)` on `batch` and `new`
    greedy `make_serve_step` steps (bf16 compute), under the caller's
    scope: an LM decodes from its prefill's logits, whisper from start
    token 0 of each row. Returns the logits (f32, on the card), the
    greedy tokens, the cache, the walls and the kernels' launches in the
    prefill (`path` records kernel 1's head dims)."""
    prefill = train_steps.make_prefill_step(cfg, "kernel",
                                            cache_len=cache_len)
    serve = train_steps.make_serve_step(cfg)
    rows = next(iter(batch.values())).shape[0]
    with torch.no_grad():
        torch.cuda.synchronize()
        _zero_kernel_counts()
        sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
        t0 = time.time()
        first, cache = prefill(params, batch)
        logits = ([] if cfg.family == "encdec"
                  else [logits_from_hidden(params, first)])
        del first
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        launches = _kernel_counts([], path)
        tokens, walls = [], []
        for _ in range(new):
            tok = (logits[-1].argmax(-1).to(torch.int32) if logits else
                   torch.zeros((rows,), dtype=torch.int32, device=DEV))
            tokens.append(tok)
            t0 = time.time()
            step, cache = serve(params, tok, cache)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            logits.append(step)
        launches.update(sla_decode=sla_decode.LAUNCHES,
                        sla_decode_paged=sla_decode.PAGED_LAUNCHES)
    return dict(logits=torch.stack(logits), tokens=torch.stack(tokens),
                cache=cache, prefill_s=prefill_s, walls=walls,
                launches=launches)


def _reuse_prefill_run(cfg, params, toks, toks2, path: str) -> dict:
    """Phase 34b under the caller's scope: `prefill(return_plans=True)`
    of `toks`, then a same-shape `prefill(plans=, drift_threshold=
    P34_DRIFT, return_plans=True)` of `toks2` (bf16 compute, kernel
    backend), the static engine's group-to-group plan reuse at the model
    API. Returns the second prefill's logits, K/V cache, plans and drift
    info, its wall and kernel 1's launches in it (`path` records their
    head dims)."""
    with torch.no_grad():
        _, cache, plans = transformer.prefill(params, cfg, toks,
                                              torch.bfloat16, "kernel",
                                              return_plans=True)
        del cache
        torch.cuda.synchronize()
        _zero_kernel_counts()
        t0 = time.time()
        last, cache, plans, info = transformer.prefill(
            params, cfg, toks2, torch.bfloat16, "kernel", plans=plans,
            drift_threshold=P34_DRIFT, return_plans=True)
        logits = logits_from_hidden(params, last)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _kernel_counts([], path)
    return dict(logits=logits, k=cache["k"], v=cache["v"], plans=plans,
                info=info, wall_s=wall, launches=launches)


def _flash_decode_cases(cfg, kc, vc, pos: int) -> list:
    """The flash-decoding functions of `distributed/serving.py` on the
    card over one layer's cache kc, vc (B, Hkv, S, D) cut into
    P34_SPANS spans (layout B's 4 "model" ranks, layout C's 4 x 4 ranks
    over ("data", "model")): a seeded query (B, H, D) per slot, a shared
    position and per-slot ones, against `_dense_decode_attn` on the whole
    cache, in f32 (5e-5 x max(1, max |o|)) and bf16 (5e-2 x max(1, max
    |o|)); the combine run twice, bitwise; CUDA-event times of the spans'
    partials and the combine beside the whole cache's attention."""
    from repro_torch.distributed import serving
    b, hkv, n, d = kc.shape
    gen = torch.Generator(device=DEV).manual_seed(34)
    q0 = torch.randn((b, cfg.num_heads, 1, d), generator=gen, device=DEV)
    rows = []
    for spans in P34_SPANS:
        step = n // spans
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q0.to(dtype), kc.to(dtype), vc.to(dtype)
            for pos_kind in ("shared", "per-slot"):
                p = (pos if pos_kind == "shared" else torch.tensor(
                    [pos, pos // 2 + 7], device=DEV))
                want = transformer._dense_decode_attn(
                    q, k, v, p, transformer.KIND_SLA, cfg)

                def parts():
                    return torch.stack([serving.decode_partial(
                        q[:, :, 0], k[:, :, i * step:(i + 1) * step],
                        v[:, :, i * step:(i + 1) * step], p, i * step)
                        for i in range(spans)])

                got = serving.decode_combine(parts())
                again = serving.decode_combine(parts())
                bitwise = bool(torch.equal(got, again))
                got = got.to(dtype).reshape(want.shape)
                err = float((got.float() - want.float()).abs().max())
                tol = TWIN_TOL if dtype == torch.float32 else LM_LOGIT_TOL
                limit = tol * max(1.0, float(want.float().abs().max()))
                ms = cuda_ms(lambda: serving.decode_combine(parts()), 10)
                whole_ms = cuda_ms(lambda: transformer._dense_decode_attn(
                    q, k, v, p, transformer.KIND_SLA, cfg), 10)
                ok = err <= limit and bitwise
                rows.append(dict(spans=spans, dtype=str(dtype)[6:],
                                 pos=pos_kind, max_abs_err=err, limit=limit,
                                 bitwise_repeat=bitwise, ms=ms,
                                 whole_ms=whole_ms, ok=ok))
                say(f"[34 flash decode] layer 0's cache (B {b}, Hkv {hkv}, "
                    f"S {n}, D {d}) in {spans} spans, {rows[-1]['dtype']}, "
                    f"{pos_kind} pos: max abs err {err:.3g} (limit "
                    f"{limit:.3g}), combine bitwise on repeat {bitwise} | "
                    f"partials + combine {ms:.3f} ms, the whole cache's "
                    f"attention {whole_ms:.3f} ms {'OK' if ok else 'FAIL'}")
            del q, k, v
    return rows


def phase_serve_mesh() -> dict:
    """Phase 34: sharded serving's path at world size 1 on this card.
    Full-width Qwen3-1.7B with seeded bf16 weights (sla_proj redrawn)
    prefills P34_BATCH prompts of P34_PROMPT tokens into P34_MAX_LEN-
    position caches through `make_prefill_step` and decodes P34_NEW
    greedy tokens through `make_serve_step` (dense decode) on the plain
    path, then the same with the parameters placed on `make_host_mesh(1,
    1)` (NCCL through a FileStore under build/, destroyed after) under
    `activation_sharding(mesh, default_residual_spec(...))`: logits, K/V
    caches and greedy tokens bitwise the plain path's, kernel 1's launches
    equal (one a layer a prefill, on tensor cores; no decode kernel).
    Then the flash-decoding functions over the mesh run's layer-0 cache
    (`_flash_decode_cases`): the card is one H100, so this is where it
    runs the sharded math. Returns the summary."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(34)
    params = transformer.init(gen, cfg, dtype=torch.bfloat16, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
    toks = torch.randint(0, cfg.vocab_size, (P34_BATCH, P34_PROMPT),
                         generator=gen, device=DEV, dtype=torch.int32)
    toks2 = torch.randint(0, cfg.vocab_size, (P34_BATCH, P34_PROMPT),
                          generator=gen, device=DEV, dtype=torch.int32)
    plain = _serve_run(cfg, params, {"tokens": toks}, P34_MAX_LEN, P34_NEW,
                       "lm_serve")
    reuse = {"plain": _reuse_prefill_run(cfg, params, toks, toks2,
                                         "lm_prefill_reuse")}
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        sharding.place_module(params, mesh)
        residual = actx.default_residual_spec(mesh, P34_BATCH, P34_MAX_LEN)
        with actx.activation_sharding(mesh, residual, remat=False):
            sharded = _serve_run(cfg, params, {"tokens": toks}, P34_MAX_LEN,
                                 P34_NEW, "lm_serve_mesh")
            reuse["mesh 1x1"] = _reuse_prefill_run(
                cfg, params, toks, toks2, "lm_prefill_reuse_mesh")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del params
    reuse_same = {key: torch.equal(reuse["mesh 1x1"][key],
                                   reuse["plain"][key])
                  for key in ("logits", "k", "v")}
    reuse_same["plans"] = all(
        torch.equal(getattr(reuse["mesh 1x1"]["plans"], n),
                    getattr(reuse["plain"]["plans"], n))
        for n in plan_lib.PLAN_LEAVES)
    reuse_same["info"] = all(
        torch.equal(reuse["mesh 1x1"]["info"][k], reuse["plain"]["info"][k])
        for k in ("retention", "replanned"))
    want_reuse = dict(sla_fwd=cfg.num_layers, tc_sla_fwd=cfg.num_layers)
    reuse_launches = {name: {k: run["launches"][k] for k in want_reuse}
                      for name, run in reuse.items()}
    replans = int(reuse["plain"]["info"]["replanned"].sum())
    min_retention = float(reuse["plain"]["info"]["retention"].min())
    for name, run in reuse.items():
        say(f"[34b reuse prefill] {name}: prefill(plans=, drift_threshold="
            f"{P34_DRIFT}) of {P34_BATCH} x {P34_PROMPT} tokens on the "
            f"first prefill's plans {run['wall_s']:.3f}s | launches "
            f"{reuse_launches[name]} on {CARD[0]}")
    reuse_ok = (all(reuse_same.values())
                and all(v == want_reuse for v in reuse_launches.values()))
    say(f"[34b reuse prefill] {LM_ARCH} over make_host_mesh(1, 1) bitwise "
        f"the plain path: {reuse_same} | {replans} of {cfg.num_layers} "
        f"layers re-planned, lowest retention {min_retention:.4f} | kernel "
        f"1 launches expected {cfg.num_layers} on tensor cores "
        f"{'OK' if reuse_ok else 'FAIL'}")
    reuse_walls = {name: run["wall_s"] for name, run in reuse.items()}
    del reuse
    runs = {"plain": plain, "mesh 1x1": sharded}
    same = {"logits": torch.equal(sharded["logits"], plain["logits"]),
            "tokens": torch.equal(sharded["tokens"], plain["tokens"])}
    for key in ("k", "v"):
        same[key] = torch.equal(sharded["cache"][key], plain["cache"][key])
    pos = int(sharded["cache"]["pos"])
    finite = bool(torch.isfinite(sharded["logits"]).all())
    nl = cfg.num_layers
    want = dict(sla_fwd=nl, tc_sla_fwd=nl, sla_decode=0, sla_decode_paged=0)
    launches = {name: {k: run["launches"][k] for k in want}
                for name, run in runs.items()}
    kv_gb = sum(plain["cache"][k].numel() * plain["cache"][k].element_size()
                for k in ("k", "v")) / 1e9
    walls = {}
    for name, run in runs.items():
        w = sorted(run["walls"][1:])
        walls[name] = dict(prefill_s=run["prefill_s"],
                           decode_first_s=run["walls"][0],
                           decode_ms_min=1e3 * w[0],
                           decode_ms_median=1e3 * w[len(w) // 2],
                           decode_ms_max=1e3 * w[-1])
        say(f"[34 serve mesh] {name}: prefill of {P34_BATCH} x {P34_PROMPT} "
            f"tokens into {P34_MAX_LEN}-position caches ({kv_gb:.2f} GB of "
            f"K/V) {run['prefill_s']:.3f}s | {P34_NEW} decode steps: first "
            f"{run['walls'][0] * 1e3:.1f} ms, then "
            f"{walls[name]['decode_ms_min']:.1f}-"
            f"{walls[name]['decode_ms_max']:.1f} ms a step (median "
            f"{walls[name]['decode_ms_median']:.1f}) | launches "
            f"{launches[name]}")
    del plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    flash = _flash_decode_cases(cfg, sharded["cache"]["k"][0],
                                sharded["cache"]["v"][0], pos - 1)
    ok = (all(same.values()) and finite and pos == P34_PROMPT + P34_NEW
          and all(v == want for v in launches.values())
          and all(r["ok"] for r in flash) and reuse_ok)
    say(f"[34 serve mesh] {LM_ARCH} full width over make_host_mesh(1, 1): "
        f"bitwise {same}, finite {finite}, pos {pos} | kernel 1 launches a "
        f"prefill expected {nl} on tensor cores | flash decode "
        f"{sum(r['ok'] for r in flash)}/{len(flash)} OK | "
        f"{time.time() - t_all:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"sharded serving: bitwise {same}, finite "
                           f"{finite}, pos {pos}, launches {launches}, "
                           f"flash {[r for r in flash if not r['ok']]}, "
                           f"plan reuse bitwise {reuse_same}, launches "
                           f"{reuse_launches}")
    return dict(bitwise=same, launches=launches["mesh 1x1"],
                plain_launches=launches["plain"], walls=walls,
                kv_cache_gb=kv_gb, flash=flash,
                reuse=dict(bitwise=reuse_same, walls=reuse_walls,
                           replans=replans, min_retention=min_retention,
                           launches=reuse_launches["mesh 1x1"],
                           plain_launches=reuse_launches["plain"]),
                wall_s=time.time() - t_all)


def _family_serve_model(arch: str, batch: int, prompt: int, seed: int):
    """The family's model at full width and depth in bf16 from `seed`
    (the SLA layers' zero-initialized sla_proj redrawn) and its prefill
    batch: `batch` prompts of `prompt` tokens, or of whisper's audio
    frames."""
    cfg = get_arch(arch)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    mdl = registry.get_model(cfg)
    params = mdl.init(gen, cfg, dtype=torch.bfloat16, device=DEV)
    if cfg.family == "hybrid":
        _redraw(gen, [params.shared_attn.sla_proj])
    elif cfg.family == "encdec":
        _redraw(gen, [block.sla_proj for block in params.enc])
    if cfg.family == "encdec":
        inputs = {"audio_embeds": torch.randn(
            (batch, prompt, cfg.d_model), generator=gen, device=DEV)}
    else:
        inputs = {"tokens": torch.randint(
            0, cfg.vocab_size, (batch, prompt), generator=gen, device=DEV,
            dtype=torch.int32)}
    return cfg, params, inputs


def phase_serve_mesh_families() -> dict:
    """Phase 35: sharded serving of the hybrid, encdec and ssm families at
    world size 1 on this card. For each of `P35_MODELS` (zamba2-1.2b,
    whisper-small and rwkv6-7b at full width and depth, seeded bf16
    weights) `make_prefill_step` and greedy `make_serve_step` steps on the
    plain path, then the same with the parameters placed on
    `make_host_mesh(1, 1)` (one NCCL group through a FileStore under
    build/, destroyed after) under `activation_sharding(mesh,
    default_residual_spec(mesh, batch, cache length))`: logits, every
    cache leaf (SSM states, conv tails, token shifts, K/V) and the greedy
    tokens bitwise the plain path's; kernel 1's launches a prefill equal
    on both paths and one a shared-block application (zamba2) or encoder
    layer (whisper), all on the tensor cores, none for rwkv6; no decode
    kernel. Returns the summary by arch."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    out, bad = {}, []
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        for arch, batch, prompt, cache_len, new, seed in P35_MODELS:
            t0 = time.time()
            cfg, params, inputs = _family_serve_model(arch, batch, prompt,
                                                      seed)
            path = cfg.family + "_serve"
            plain = _serve_run(cfg, params, inputs, cache_len, new, path)
            sharding.place_module(params, mesh)
            length = cache_len or prompt
            residual = actx.default_residual_spec(mesh, batch, length)
            with actx.activation_sharding(mesh, residual, remat=False):
                sharded = _serve_run(cfg, params, inputs, cache_len, new,
                                     path + "_mesh")
            del params, inputs
            leaves = [k for k, v in plain["cache"].items()
                      if torch.is_tensor(v)]
            same = {"logits": torch.equal(sharded["logits"],
                                          plain["logits"]),
                    "tokens": torch.equal(sharded["tokens"],
                                          plain["tokens"])}
            for key in leaves:
                same[key] = torch.equal(sharded["cache"][key],
                                        plain["cache"][key])
            pos = int(sharded["cache"]["pos"])
            want_pos = new + (0 if cfg.family == "encdec" else prompt)
            finite = bool(torch.isfinite(sharded["logits"]).all())
            napp = {"hybrid": len(hybrid.segments(cfg)),
                    "encdec": cfg.encoder_layers, "ssm": 0}[cfg.family]
            want = dict(sla_fwd=napp, tc_sla_fwd=napp, sla_decode=0,
                        sla_decode_paged=0)
            runs = {"plain": plain, "mesh 1x1": sharded}
            launches = {name: {k: run["launches"][k] for k in want}
                        for name, run in runs.items()}
            cache_gb = sum(plain["cache"][k].numel()
                           * plain["cache"][k].element_size()
                           for k in leaves) / 1e9
            walls = {}
            for name, run in runs.items():
                w = sorted(run["walls"][1:])
                walls[name] = dict(prefill_s=run["prefill_s"],
                                   decode_first_s=run["walls"][0],
                                   decode_ms_min=1e3 * w[0],
                                   decode_ms_median=1e3 * w[len(w) // 2],
                                   decode_ms_max=1e3 * w[-1])
                unit = "frames" if cfg.family == "encdec" else "tokens"
                say(f"[35 serve mesh] {arch} {name}: prefill {batch} x "
                    f"{prompt} {unit} ({cache_gb:.3f} GB of cache) "
                    f"{run['prefill_s']:.3f}s | {new} decode steps: first "
                    f"{run['walls'][0] * 1e3:.1f} ms, then "
                    f"{walls[name]['decode_ms_min']:.2f}-"
                    f"{walls[name]['decode_ms_max']:.2f} ms a step (median "
                    f"{walls[name]['decode_ms_median']:.2f}) | launches "
                    f"{launches[name]}")
            ok = (all(same.values()) and finite and pos == want_pos
                  and all(v == want for v in launches.values()))
            say(f"[35 serve mesh] {arch} over make_host_mesh(1, 1): bitwise "
                f"{same}, finite {finite}, pos {pos} | kernel 1 launches a "
                f"prefill expected {napp} on tensor cores | "
                f"{time.time() - t0:.1f}s {'OK' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{arch}: bitwise {same}, finite {finite}, pos "
                           f"{pos}, launches {launches}")
            out[arch] = dict(bitwise=same, launches=launches["mesh 1x1"],
                             plain_launches=launches["plain"], walls=walls,
                             cache_gb=cache_gb, wall_s=time.time() - t0)
            del plain, sharded, runs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    say(f"[35 serve mesh] {len(P35_MODELS) - len(bad)}/{len(P35_MODELS)} "
        f"families bitwise over the mesh | {time.time() - t_all:.1f}s "
        f"{'OK' if not bad else 'FAIL'}")
    if bad:
        raise RuntimeError("sharded family serving: " + "; ".join(bad))
    return out


# --------------------------------------------------------------------------
def _counts36() -> dict:
    """Every launch counter of kernels 1-3 (the split route's pre-pass
    among them)."""
    return dict(sla_fwd=sla_fwd.LAUNCHES, tc_sla_fwd=sla_fwd.TC_LAUNCHES,
                tc32_sla_fwd=sla_fwd.TC32_LAUNCHES,
                split_sla_fwd=sla_fwd.SPLIT_LAUNCHES,
                planes=sla_fwd.PLANES_LAUNCHES,
                sla_bwd_dq=sla_bwd.LAUNCHES_DQ,
                tc_sla_bwd_dq=sla_bwd.TC_LAUNCHES_DQ,
                sla_bwd_dkv=sla_bwd.LAUNCHES_DKV,
                tc_sla_bwd_dkv=sla_bwd.TC_LAUNCHES_DKV,
                tc32_sla_bwd_dq=sla_bwd.TC32_LAUNCHES_DQ,
                tc32_sla_bwd_dkv=sla_bwd.TC32_LAUNCHES_DKV,
                sla_decode=sla_decode.LAUNCHES,
                sla_decode_paged=sla_decode.PAGED_LAUNCHES)


def _zero36():
    """Every launch counter to 0 and the head-dim records cleared, just
    before an example's path runs."""
    _zero_kernel_counts()
    sla_fwd.SPLIT_LAUNCHES = sla_fwd.PLANES_LAUNCHES = 0
    sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0


def _quickstart36() -> dict:
    """Phase 36a: `examples_torch.quickstart` on the kernel backend: its
    printed errors within 5e-5 x max(1, max |ref|), kernel 1 twice on the
    split route with its pre-pass (step 3's call and the gradient's
    forward), kernels 2-3 once each on `sla_bwd.cu` (f32), the FLOPs dict
    the host's."""
    _zero36()
    t0 = time.time()
    out = quickstart.main(["--backend", "kernel"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _counts36()
    _read_head_dims("quickstart")
    want = dict(sla_fwd=2, tc_sla_fwd=0, tc32_sla_fwd=0, split_sla_fwd=2,
                planes=2,
                sla_bwd_dq=1, tc_sla_bwd_dq=0, sla_bwd_dkv=1,
                tc_sla_bwd_dkv=0, tc32_sla_bwd_dq=0, tc32_sla_bwd_dkv=0,
                sla_decode=0, sla_decode_paged=0)
    limit = QS_TOL * max(1.0, out["ref_max_abs"])
    host = flops_lib.sla_flops(32768, 128, 12, quickstart.CFG)
    ok = (counts == want and out["kernel_err"] <= limit
          and out["gather_err"] <= limit and out["flops"] == host
          and np.isfinite(out["grad_proj"]) and np.isfinite(out["grad_q"]))
    say(f"[36 examples] quickstart --backend kernel: kernel vs reference "
        f"{out['kernel_err']:.3g}, gather vs reference "
        f"{out['gather_err']:.3g} (limit {limit:.3g}) | launches {counts} "
        f"(expected {want}) | sla_flops equal to the host's "
        f"{out['flops'] == host} | {wall:.2f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"quickstart: {out} launches {counts}")
    return dict(wall_s=wall, launches=counts, limit=limit,
                **{k: out[k] for k in ("kernel_err", "gather_err",
                                       "grad_proj", "grad_q", "stats")})


def _example36(name: str, fn) -> dict:
    """Phase 36b-c: one example's `main()` at its defaults on the card
    (its own assertions), its wall and launches (none: these run the
    gather and reference backends)."""
    _zero36()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fn([])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _counts36()
    _read_head_dims(name)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = not any(counts.values())
    say(f"[36 examples] {name}: its assertions passed | {wall:.2f}s | peak "
        f"{peak:.2f} GiB | launches {counts} (expected none) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} launched an SLA kernel: {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_s=wall, peak_gib=peak, launches=counts)


def _ft_train(path: str, cfg, params, shape, steps: int, lr: float,
              seed: int, mode) -> dict:
    """`finetune_dit.train` on the kernel backend with the launch counters
    zeroed before it; after each step the step's launches (12 / 12 / 12
    in `sla` mode, kernels 1-3 all on their "tc32" routes, so none on
    `sla_fwd.cu` or `sla_bwd.cu`; none in the others), a finite loss, its
    wall and its peak memory are held and kept."""
    nl = cfg.num_layers
    per = nl if mode == "sla" else 0
    want = dict(sla_fwd=per, tc_sla_fwd=0, tc32_sla_fwd=per,
                split_sla_fwd=0, planes=0,
                sla_bwd_dq=per, tc_sla_bwd_dq=0, sla_bwd_dkv=per,
                tc_sla_bwd_dkv=0, tc32_sla_bwd_dq=per,
                tc32_sla_bwd_dkv=per, sla_decode=0, sla_decode_paged=0)
    recs = []
    _zero36()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = dict(t=time.time(), counts=_counts36())

    def on_step(s, loss):
        now = _counts36()
        delta = {k: now[k] - state["counts"][k] for k in now}
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        recs.append(dict(loss=loss, wall_s=t - state["t"], peak_gib=peak))
        state.update(t=t, counts=now)
        if delta != want or not np.isfinite(loss):
            raise RuntimeError(f"{path} step {s}: launches {delta} "
                               f"(expected {want}), loss {loss}")

    t0 = time.time()
    _, hist = finetune_dit.train(cfg, params, shape, steps, lr, seed,
                                 sla_mode=mode, backend="kernel",
                                 on_step=on_step, log_every=50)
    wall = time.time() - t0
    _read_head_dims(path)
    walls = sorted(r["wall_s"] for r in recs[1:]) or [recs[0]["wall_s"]]
    return dict(steps=len(hist), hist=hist, wall_s=wall,
                first_step_s=recs[0]["wall_s"], step_s_min=walls[0],
                step_s_median=walls[len(walls) // 2], step_s_max=walls[-1],
                peak_gib=max(r["peak_gib"] for r in recs),
                launches={k: v * steps for k, v in want.items()},
                launches_per_step=want)


def _ft_summary(tag: str, r: dict):
    say(f"[36 finetune] {tag}: {r['steps']} steps in {r['wall_s']:.1f}s "
        f"(first {r['first_step_s']:.3f}s, then {r['step_s_min']:.3f}-"
        f"{r['step_s_max']:.3f}s a step, median {r['step_s_median']:.3f}) "
        f"| peak {r['peak_gib']:.2f} GiB | launches a step "
        f"{r['launches_per_step']} held at every step | loss "
        f"{r['hist'][0]:.5f} -> {r['hist'][-1]:.5f}")


def _finetune36(batch: int, pretrain_steps: int, finetune_steps: int
                ) -> dict:
    """Phase 36d: `examples_torch.finetune_dit` at the 100m preset's
    widths and depth (12 layers, d_model 768, 12 heads of 64, d_ff 3,072,
    4,096 tokens) with its `build` and `train` on the kernel backend, bf16
    compute over f32 masters: pretrain with full attention, then fine-tune
    a copy in each mode of `FT_MODES`. The preset's batch of 32 is cut to
    `batch` (the dense modes' (B, 12, 4096, 4096) f32 scores and
    probabilities, kept a layer for the backward, fill the card), its 150
    + 150 steps to the counts given. At the first `sla` step the kernel
    backend's loss is held to the gather backend's on the same params and
    batch (5e-2 x max(1, |loss|): both plan inline in bf16, and a
    near-tied block may flip)."""
    p = finetune_dit.PRESETS[FT_PRESET]
    shape = ShapeConfig("dit", p["seq"], batch, "train")
    say(f"[36 finetune] preset {FT_PRESET}: {p['num_layers']} layers, "
        f"d_model {p['d_model']}, {p['num_heads']} heads of "
        f"{p['head_dim']}, d_ff {p['d_ff']}, seq {p['seq']} | cut: batch "
        f"{p['batch']} -> {batch}, steps 150 + 150 -> {pretrain_steps} + "
        f"{finetune_steps} a mode")
    cfg_full = finetune_dit.build(FT_PRESET, "full")
    gen = torch.Generator(device=DEV).manual_seed(FT_SEED)
    params = dit.init(gen, cfg_full, device=DEV)
    nparams = sum(x.numel() for x in params.parameters())
    runs = {"full": _ft_train("dit_pretrain", cfg_full, params, shape,
                              pretrain_steps, FT_LR, FT_SEED, None)}
    _ft_summary(f"pretrain, full attention, {nparams / 1e6:.1f}M params",
                runs["full"])
    hist = runs["full"]["hist"]
    results = {"full_attention": sum(hist[-10:]) / len(hist[-10:])}
    cross = None
    for mode in FT_MODES:
        cfg = finetune_dit.build(FT_PRESET, mode)
        ft = copy.deepcopy(params)
        if mode == "sla":
            batch0 = finetune_dit.to_device(latent_batch(
                cfg, shape, DataConfig(seed=FT_SEED + 1), 0), DEV)
            with torch.no_grad():
                gather_loss = float(dit.loss_fn(ft, cfg, batch0,
                                                backend="gather",
                                                sla_mode="sla"))
            del batch0
        r = _ft_train(f"dit_finetune_{mode}", cfg, ft, shape,
                      finetune_steps, FT_LR * 0.5, FT_SEED + 1, mode)
        if mode == "sla":
            r["profile"] = _profile36(cfg, ft, shape)
        del ft
        gc.collect()
        torch.cuda.empty_cache()
        _ft_summary(f"finetune {mode}", r)
        if mode == "sla":
            say(f"[36 finetune] sla step wall (bf16, batch {batch}; "
                f"kernels 1-3 on the tc32 routes, 12 launches each a step, "
                f"none on sla_fwd.cu or sla_bwd.cu): median "
                f"{r['step_s_median']:.4f} s, "
                f"{r['step_s_min']:.4f}-{r['step_s_max']:.4f} s after the "
                f"first ({r['first_step_s']:.4f} s) on {CARD[0]}")
            kernel_loss = r["hist"][0]
            limit = LT_LOSS_TOL * max(1.0, abs(gather_loss))
            ok = abs(kernel_loss - gather_loss) <= limit
            cross = dict(kernel_loss=kernel_loss, gather_loss=gather_loss,
                         diff=abs(kernel_loss - gather_loss), limit=limit,
                         ok=ok)
            say(f"[36 finetune] sla step 0, same params and batch: kernel "
                f"loss {kernel_loss:.6f} vs gather {gather_loss:.6f} (diff "
                f"{cross['diff']:.3g}, limit {limit:.3g}) "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"finetune sla: kernel vs gather loss "
                                   f"{cross}")
        h = r["hist"]
        results[mode] = sum(h[-10:]) / len(h[-10:])
        say(f"[finetune:{mode}] first-5 {sum(h[:5]) / 5:.5f} -> final "
            f"{results[mode]:.5f}")
        runs[mode] = r
    order_ok = finetune_dit.report(results)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs.values():
        h = r.pop("hist")
        r.update(loss_first=h[0], loss_last=h[-1])
    return dict(batch=batch, pretrain_steps=pretrain_steps,
                finetune_steps=finetune_steps, params_m=nparams / 1e6,
                results=results, sla_best=order_ok, cross_check=cross,
                runs=runs)


def _profile36(cfg, params, shape) -> dict:
    """Phase 36d's profile: `finetune_dit.train` takes three more `sla`
    steps on the fine-tuned copy, and torch.profiler records the third
    (its batch, forward, backward and update): its wall, device time, the
    device's busy share, the host's own time in the ops it ran, the SLA
    kernels' device time, and the top ops by the device time of the
    kernels each launched (name, ms, calls)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    prof = prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {}

    def on_step(s, loss):
        torch.cuda.synchronize()
        if s == 1:
            prof.__enter__()
            state["t0"] = time.time()
        elif s == 2:
            state["wall_s"] = time.time() - state["t0"]
            prof.__exit__(None, None, None)

    finetune_dit.train(cfg, params, shape, 3, FT_LR * 0.5, FT_SEED + 2,
                       sla_mode="sla", backend="kernel", on_step=on_step,
                       log_every=50)
    res = _busy(prof, state["wall_s"])
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    res["host_op_s"] = sum(e.self_cpu_time_total for e in host) / 1e6
    res["host_ops"] = sum(e.count for e in host)
    res["sla_kernels"] = {
        name: (ms * n if ms is not None else 0.0, n) for name, (ms, n) in
        _kernel_means(prof, ("sla_fwd_tc32_kernel", "sla_bwd_dq_tc32_kernel",
                             "sla_bwd_dkv_tc32_kernel")).items()}
    top = sorted((e for e in host if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    res["top"] = [(e.key, e.self_device_time_total / 1e3, e.count)
                  for e in top[:10]]
    say(f"[36 profile] one sla step at the {FT_PRESET} widths under "
        f"torch.profiler: {res['wall_s']:.4f} s wall, {res['device_s']:.4f} "
        f"s device time, device busy {res['busy']:.3f}, {res['host_ops']} "
        f"host ops taking {res['host_op_s']:.4f} s of host time on their "
        f"own | SLA kernels (device ms, launches) {res['sla_kernels']} | "
        f"on {CARD[0]}")
    for name, ms, calls in res["top"]:
        say(f"  {ms:9.3f} ms of device time  {calls:5d}x  {name}")
    return res


def _fma_bound(nbytes: float, flops: float) -> float:
    """The least time on the f32-FMA route: bytes over HBM bandwidth
    against the operations at the f32 FMA peak (the CUDA cores these
    kernels run on, beside `_bound`'s tensor-core peak for bf16
    operands)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["fma"]) * 1e3


def _ft_kernels36(batch: int) -> tuple:
    """Phase 36e: kernels 1-3 at the finetune's shape (BH = batch x 12,
    N 4,096, D 64, 32 x 32 blocks, bf16; K = num_critical(128) from
    `plan_attention` on seeded q and k) against their twins on the same
    card tensors, all on their "tc32" routes (`cases.tc_criterion`,
    kernel 1's O^l within 5e-5 x max(1, max |twin|), a bitwise repeat);
    kernel 1's f32-FMA kernel forced beside it (5e-5) and timed in the
    same call; timed beside their bounds (operations at the route's peak,
    and at the f32-FMA peak) and beside compiled flex_attention's forward
    (kernel 1) and backward (kernels 2 + 3), with the ratios. Returns
    (forward rows, backward rows)."""
    sla = finetune_dit.build(FT_PRESET, "sla").sla
    p = finetune_dit.PRESETS[FT_PRESET]
    h, n, d = p["num_heads"], p["seq"], p["head_dim"]
    gen = torch.Generator(device=DEV).manual_seed(36)
    q, k, v = (torch.randn((batch, h, n, d), generator=gen, device=DEV)
               for _ in range(3))
    plan = plan_lib.plan_attention(q, k, sla)
    shape = f"dit-{FT_PRESET} finetune"
    args, kw, _ = _operands(sla, q, k, v, plan.marginal, plan.lut,
                            plan.counts, torch.bfloat16)
    c = _fwd_check(args, kw, shape)
    forced = _fwd_check(args, kw, f"{shape} (f32-FMA forced)", route="fma")
    # the tc32 kernel, then the f32-FMA kernel it replaces, in one call
    ms = cuda_ms(lambda: sla_fwd.sla_fwd(*args, **kw), 20)
    ms_fma = cuda_ms(_fwd_call(args, kw, "fma"), 20)
    plain_ms = cuda_ms(lambda: sla_fwd.sla_fwd_plain(*args, **kw), 3,
                       warmup=1)
    bound_ms, bound_by, flops, nbytes, live = _bound(args, kw)
    fma_ms = _fma_bound(nbytes, flops)
    width = sla_fwd.tc32_head_dim(d)
    ctas = sla_fwd.tc32_ctas_per_sm(width)
    say(f"[36 kernels] sla_fwd {shape} bf16 (BH={args[2].shape[0]}, N={n}, "
        f"D={d}, blocks 32, K={plan.k_sel}, live tiles {live} of "
        f"{args[0].numel()}): {_fwd_text(c)} | kernel {ms:.3f} ms | bound "
        f"{bound_ms:.3f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.0f} MB; {bound_ms / ms:.1%} of it) | f32-FMA "
        f"bound {fma_ms:.3f} ms ({fma_ms / ms:.1%}) | {ctas} CTAs an SM "
        f"at D {width} | plain twin {plain_ms:.3f} ms")
    say(f"[36 kernels] sla_fwd {shape}, the f32-FMA kernel forced in the "
        f"same call: {_fwd_text(forced)} | {ms_fma:.3f} ms "
        f"({bound_ms / ms_fma:.1%} of the bound) against the tc32 kernel's "
        f"{ms:.3f} ms "
        f"({ms_fma / ms:.1f}x) on {CARD[0]}")
    fwd = [dict(shape=shape, dtype="bf16", bh=args[2].shape[0], n=n, d=d,
                block=kw["block_q"], k_sel=plan.k_sel, live_tiles=live,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_fraction=bound_ms / ms,
                bound_ms_f32_fma=fma_ms, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, library_ms=None, head_dim_run=width,
                ctas_per_sm=ctas, ms_fma=ms_fma,
                fma_max_abs_err=forced["max_abs_err"], fma_ok=forced["ok"],
                **c)]
    del args
    leaves = (plan.marginal, plan.lut, plan.counts, plan.col_lut,
              plan.col_counts)
    dq_args, dkv_args, kw = _bwd_operands(sla, q, k, v, leaves,
                                          torch.bfloat16, seed=37)
    # the library call at this shape: compiled flex_attention on a
    # BlockMask of the same LUT, phase 7's yardstick (its forward computes
    # O^s and L only: the forward kernel's library_ms stays null)
    lib = _with_library(sla, q, k, v, plan.lut, plan.counts, dq_args,
                        dkv_args, kw, torch.bfloat16, shape)
    flex_fwd = lib.get("library_fwd_ms")
    fwd[0]["flex_sparse_branch_fwd_ms"] = flex_fwd
    fwd[0]["ratio_to_flex_fwd"] = (ms / flex_fwd if flex_fwd is not None
                                   else None)
    say(f"[36 kernels] compiled flex_attention at {shape} bf16 on "
        f"{CARD[0]}: forward (O^s and L only) "
        + (f"{flex_fwd:.3f} ms against kernel 1's tc32 {ms:.3f} ms (ratio "
           f"{ms / flex_fwd:.3f}), backward (dQ, dK, dV) "
           f"{lib['library_ms']:.3f} ms against kernels 2 + 3"
           if lib.get("library_ms") is not None else "failed"))
    bwd = _bwd_case(shape, "bf16", dq_args, dkv_args, kw, n, d, lib,
                    tag="36 kernels")
    for r, args in zip(bwd, (dq_args, dkv_args)):
        r["bound_ms_f32_fma"] = _fma_bound(r["mbytes"] * 1e6,
                                           r["gflop"] * 1e9)
        r["k_sel"] = plan.k_sel
        say(f"  {r['kernel']} f32-FMA bound {r['bound_ms_f32_fma']:.3f} ms "
            f"({r['bound_ms_f32_fma'] / r['ms']:.1%})")
    both = sum(r["ms"] for r in bwd)
    flex_ms = lib.get("library_ms")
    for r in bwd:
        r["dq_plus_dkv_ms"] = both
        r["ratio_to_library"] = (both / flex_ms if flex_ms is not None
                                 else None)
    say(f"[36 kernels] kernels 2 + 3 on the tc32 route {both:.3f} ms | "
        f"compiled flex_attention backward "
        + (f"{flex_ms:.3f} ms | ratio {both / flex_ms:.3f}"
           if flex_ms is not None else "failed")
        + f" | on {CARD[0]}")
    del dq_args, dkv_args, q, k, v, plan
    torch.cuda.empty_cache()
    bad = [r for r in fwd if not (r["ok"] and r["fma_ok"])
           or r["route"] != FWD_TC32_ROUTE]
    bad += [r for r in bwd if not r["ok"] or r["route"] != TC32_ROUTE]
    if bad:
        raise RuntimeError(f"a kernel disagrees with its twin or left its "
                           f"route at the finetune shape (tc32 in both "
                           f"directions): {bad}")
    return fwd, bwd


def phase_examples(batch: int = None, pretrain_steps: int = None,
                   finetune_steps: int = None) -> tuple:
    """Phase 36: the port's examples on the card (a-c: quickstart,
    serve_lm, serve_stream, serve_routing, ablations; d: finetune_dit at
    the 100m preset; e: kernels 1-3 at the finetune's shape). Returns
    (summary, forward rows, backward rows)."""
    t0 = time.time()
    say(f"[36 examples] device memory held from earlier phases "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {"quickstart": _quickstart36()}
    for name, mod in (("serve_lm", serve_lm), ("serve_stream", serve_stream),
                      ("serve_routing", serve_routing),
                      ("ablations", ablations)):
        out[name] = _example36(name, mod.main)
    out["finetune"] = _finetune36(batch or FT_BATCH,
                                  pretrain_steps or FT_PRETRAIN_STEPS,
                                  finetune_steps or FT_FINETUNE_STEPS)
    fwd, bwd = _ft_kernels36(batch or FT_BATCH)
    out["wall_s"] = time.time() - t0
    say(f"[36 examples] every example passed | {out['wall_s']:.1f}s")
    return out, fwd, bwd


def _sla_serve_run(cfg, params, toks, path: str) -> dict:
    """`prefill(decode_max_len=P37_MAX_LEN)` on the kernel backend and
    P37_NEW greedy `decode_step`s on it (bf16 compute) under the caller's
    scope, the counters zeroed just before and read just after. Returns
    the logits (f32, on the card), the greedy tokens, the cache, the walls
    and the launches (kernel 1's in the prefill; kernel 4's, its partial
    mode's and a step's)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        _zero_kernel_counts()
        sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
        sla_decode.PARTIAL_LAUNCHES = 0
        t0 = time.time()
        hidden, cache = transformer.prefill(params, cfg, toks,
                                            torch.bfloat16, "kernel",
                                            decode_max_len=P37_MAX_LEN)
        logits = [logits_from_hidden(params, hidden)]
        del hidden
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        launches = _kernel_counts([], path)
        tokens, walls, per_step = [], [], []
        for _ in range(P37_NEW):
            tok = logits[-1].argmax(-1).to(torch.int32)
            tokens.append(tok)
            before = sla_decode.LAUNCHES
            t0 = time.time()
            step, cache = transformer.decode_step(
                params, cfg, tok, cache, torch.bfloat16, backend="kernel")
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            per_step.append(sla_decode.LAUNCHES - before)
            logits.append(step)
        _read_head_dims(path)
        launches.update(sla_decode=sla_decode.LAUNCHES,
                        sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                        sla_decode_partial=sla_decode.PARTIAL_LAUNCHES,
                        per_step=sorted(set(per_step)))
    return dict(logits=torch.stack(logits), tokens=torch.stack(tokens),
                cache=cache, prefill_s=prefill_s, walls=walls,
                launches=launches)


def _partial_bound(ops, kw):
    """Least time for one span's partial call: bytes over HBM bandwidth
    against operations over the f32 peak. Bytes: each (kv head, block)
    of the span that a live slot of its group selects, once, for its K
    and V tiles and its h_j and z_j; a chunk's per-token diagonal
    partials of the tokens whose block is in the span (`hdiag`, `zdiag`);
    q, phi(q), the integer operands and the records written. Operations:
    4 bkv D + 2 D^2 + 2 D per live (bh, block)."""
    lut, cnt, posv, q, qp, k = ops[:6]
    bh, c, k_sel = lut.shape
    _, tn, bkv, d = k.shape
    live = torch.arange(k_sel, device=DEV) < cnt[..., None]
    kvrow = (torch.arange(bh, device=DEV) // kw["group"])[:, None, None]
    tile = (kvrow * tn + lut.long()).expand(bh, c, k_sel)
    blocks = int(torch.unique(tile[live]).numel())
    slots = int(live.sum())
    diag = 0
    if len(ops) > 9 and ops[9] is not None:  # the tokens' diagonal partials
        tok = posv[::kw["group"], None].long() + torch.arange(c, device=DEV)
        diag = int(((tok >= 0) & (tok < tn * bkv)).sum()) * (d * d + d) * 4
    nbytes = (blocks * (2 * bkv * d * k.element_size() + (d * d + d) * 4)
              + diag + 2 * bh * c * d * 4 + (lut.numel() + cnt.numel()
                                             + posv.numel()) * 4
              + bh * c * (2 * d + 3) * 4)
    flops = slots * (4 * bkv * d + 2 * d * d + 2 * d)
    return nbytes, flops


def _partial_cases(cfg, cache, pos: int) -> list:
    """Phase 37b: `_span_cases` over layer 0's live state of the mesh
    run's cache, with a seeded query (B, H, D) at its last position."""
    st = cache["sla"]
    state = {"k": cache["k"][0], "v": cache["v"][0], "hblk": st["hblk"][0],
             "zblk": st["zblk"][0], "htot": st["htot"][0],
             "ztot": st["ztot"][0], "lut": st["live_lut"][0],
             "cnt": st["live_cnt"][0], "marg": st["live_marg"][0]}
    b, hkv, n, d = state["k"].shape
    g = cfg.num_heads // hkv
    gen = torch.Generator(device=DEV).manual_seed(37)
    q = torch.randn((b, hkv, g, 1, d), generator=gen, device=DEV)
    grouped = sla_decode.decode_operands(state, q, phi(q, cfg.sla.phi), pos)
    flat = sla_decode._flat_args(*grouped, cfg.sla.block_kv)
    return _span_cases(cfg, flat, "37b partial", f"{LM_ARCH} layer 0 live "
                       f"state B {b}, H {cfg.num_heads}, Hkv {hkv}, D {d}, "
                       f"Tn {n // cfg.sla.block_kv}, K {flat[0].shape[-1]}, "
                       f"pos {pos}")


def _span_cases(cfg, flat, tag: str, shape: str) -> list:
    """Kernel 4's partial mode on the card over kernel 4's flat operands
    `flat` (`sla_decode`'s: one token or a chunk of C, each row at its
    own position), cut into each of P37_SPANS spans as a rank of layouts B
    and C holds them (`cases.span_operands`): every span's records
    against the twin's at the kernel's width (5e-5 x max(1, max |twin|),
    field by field), two launches bitwise equal, and the spans' records
    combined (`sla_decode.sla_decode_combine`) against unsplit kernel 4
    on the whole (5e-5 x max(1, max |o|)). CUDA-graph times of every
    span's launch (one after another on this one card) and of unsplit
    kernel 4, CUDA-event times of the twin and the combine, the bytes
    bound; the launches here are checks, not a main path's. Returns a
    row a span count."""
    bkv = cfg.sla.block_kv
    tn = flat[6].shape[1]
    g = flat[4].shape[0] // flat[6].shape[0]
    d = flat[4].shape[-1]
    kw = dict(scale=d ** -0.5, block_kv=bkv, group=g)
    snap = (sla_decode.LAUNCHES, sla_decode.PARTIAL_LAUNCHES,
            _head_dim_snapshot())
    want = sla_decode.sla_decode(*flat, **kw)
    whole_ms = cuda_graph_ms(lambda: sla_decode.sla_decode(*flat, **kw))
    rows = []
    for spans in P37_SPANS:
        nb = tn // spans
        ops = [cases.span_operands(flat, r * nb, nb) for r in range(spans)]
        records, errs, neutral = [], [], True
        for o in ops:
            got = sla_decode.sla_decode_partial(*o, **kw)
            width = sla_decode.split_geometry(o[3], o[0])["split_width"]
            err = cases.record_error(got, sla_decode.sla_decode_partial_plain(
                *o, **kw, split_width=width))
            errs.append(err["err"])
            neutral = neutral and err["neutral_ok"]
            records.append(got)
        bitwise = bool(torch.equal(
            records[0], sla_decode.sla_decode_partial(*ops[0], **kw)))
        o_s, o_l = cases.span_combine(torch.stack(records), flat, g)
        comb = [float((x - w).abs().max()) / max(1.0, float(w.abs().max()))
                for x, w in zip((o_s, o_l), want)]
        ms = cuda_graph_ms(lambda: [sla_decode.sla_decode_partial(*o, **kw)
                                    for o in ops])
        plain_ms = cuda_ms(lambda: [sla_decode.sla_decode_partial_plain(
            *o, **kw) for o in ops], 3)
        combine_ms = cuda_ms(lambda: cases.span_combine(
            torch.stack(records), flat, g), 10)
        work = [_partial_bound(o, kw) for o in ops]
        nbytes, flops = sum(w[0] for w in work), sum(w[1] for w in work)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.float32]
        bound_ms = max(t_bytes, t_ops) * 1e3
        live = int(sum((o[1] > 0).sum() for o in ops))
        ok = (max(errs) <= TWIN_TOL and neutral and bitwise
              and max(comb) <= TWIN_TOL)
        rows.append(dict(
            spans=spans, blocks_a_span=nb, shape=shape, c=flat[0].shape[1],
            positions=sorted(set(flat[3].tolist())), max_abs_err=max(errs),
            combine_err=max(comb), neutral_ok=neutral, bitwise_repeat=bitwise,
            rows_with_live_slots=live, ms=ms, ms_a_span=ms / spans,
            plain_ms=plain_ms, combine_ms=combine_ms, whole_ms=whole_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_bytes=nbytes, bound_flops=flops,
            bound_fraction=bound_ms / ms, library_ms=None, ok=ok))
        say(f"[{tag}] {shape} in {spans} spans of {nb} "
            f"blocks: records vs twin max err {max(errs):.3g} (limit "
            f"{TWIN_TOL:g}, relative), neutral rows {neutral}, bitwise on "
            f"repeat {bitwise} | combined vs unsplit kernel 4 {max(comb):.3g} "
            f"| every span's launch {ms:.4f} ms ({ms / spans:.4f} a span), "
            f"twin {plain_ms:.3f} ms, combine {combine_ms:.3f} ms, unsplit "
            f"kernel 4 {whole_ms:.4f} ms | bound {bound_ms:.4f} ms by "
            f"{rows[-1]['bound_by']} ({nbytes / 1e6:.2f} MB, "
            f"{bound_ms / ms:.3f} of it reached) on {CARD[0]} "
            f"{'OK' if ok else 'FAIL'}")
        del ops, records
    sla_decode.LAUNCHES, sla_decode.PARTIAL_LAUNCHES = snap[:2]
    _restore_head_dims(snap[2])
    return rows


def _leaf_bitwise(got, host) -> bool:
    """A card leaf against a host copy, a layer at a time."""
    if not torch.is_tensor(got):
        return got == host
    if got.shape != host.shape or got.dtype != host.dtype:
        return False
    if got.ndim == 0:
        return bool(torch.equal(got.cpu(), host))
    return all(torch.equal(got[i], host[i].to(DEV))
               for i in range(got.shape[0]))


def phase_serve_mesh_sla() -> dict:
    """Phase 37: decode-time SLA over the mesh's path at world size 1 on
    this card. a. Full-width Qwen3-1.7B with seeded bf16 weights (sla_proj
    redrawn) prefills P37_BATCH prompts of P37_PROMPT tokens with
    `prefill(decode_max_len=P37_MAX_LEN)` on the kernel backend (the
    decode-SLA state seeded: 15.0 GB of h_j beside 7.5 GB of K/V) and
    takes P37_NEW greedy `decode_step`s on the kernel backend, on the plain
    path, whose final leaves go to the host, then with the parameters
    placed on `make_host_mesh(1, 1)` (NCCL through a FileStore under
    build/, destroyed after) under `activation_sharding(mesh,
    default_residual_spec(...))`: logits, greedy tokens and every leaf of
    the cache and of its "sla" state bitwise the plain path's, compared a
    layer at a time; kernel 1 one launch a layer a prefill on tensor
    cores and kernel 4 one a layer a step on both paths, its partial mode
    none (a one-rank mesh is layout A). b. `_partial_cases` over the mesh
    run's layer 0. Returns the summary, the partial mode's rows and (cfg,
    the plain parameters, the mesh run's cache) for phase 39 (the mesh
    run places a copy of the parameters)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    cfg = get_arch(LM_ARCH)
    nl = cfg.num_layers
    gen = torch.Generator(device=DEV).manual_seed(37)
    params = transformer.init(gen, cfg, dtype=torch.bfloat16, device=DEV)
    _redraw(gen, [layer.sla_proj for layer in params.layers])
    toks = torch.randint(0, cfg.vocab_size, (P37_BATCH, P37_PROMPT),
                         generator=gen, device=DEV, dtype=torch.int32)
    plain = _sla_serve_run(cfg, params, toks, "lm_serve_sla")
    t0 = time.time()
    held = {path: (leaf.cpu() if torch.is_tensor(leaf) else leaf)
            for path, leaf in sharding.tree_leaves(plain["cache"])}
    to_host_s = time.time() - t0
    state_gb = sum(leaf.numel() * leaf.element_size()
                   for leaf in held.values() if torch.is_tensor(leaf)) / 1e9
    plain["cache"] = None
    gc.collect()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        placed = copy.deepcopy(params)
        sharding.place_module(placed, mesh)
        residual = actx.default_residual_spec(mesh, P37_BATCH, P37_MAX_LEN)
        with actx.activation_sharding(mesh, residual, remat=False):
            sharded = _sla_serve_run(cfg, placed, toks, "lm_serve_sla_mesh")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del placed
    runs = {"plain": plain, "mesh 1x1": sharded}
    same = {"logits": torch.equal(sharded["logits"], plain["logits"]),
            "tokens": torch.equal(sharded["tokens"], plain["tokens"])}
    leaves = dict(sharding.tree_leaves(sharded["cache"]))
    same["leaves"] = sorted(leaves) == sorted(held)
    bad_leaves = [path for path in sorted(held)
                  if not _leaf_bitwise(leaves.get(path), held[path])]
    same["every_leaf"] = not bad_leaves
    del held
    pos = int(sharded["cache"]["pos"])
    st = sharded["cache"]["sla"]
    counters = {key: st[key].tolist() for key in ("extends", "replans",
                                                   "reuses")}
    finite = bool(torch.isfinite(sharded["logits"]).all())
    want = dict(sla_fwd=nl, tc_sla_fwd=nl, sla_decode=nl * P37_NEW,
                sla_decode_paged=0, sla_decode_partial=0, per_step=[nl])
    launches = {name: {k: run["launches"][k] for k in want}
                for name, run in runs.items()}
    walls = {}
    for name, run in runs.items():
        w = sorted(run["walls"][1:])
        walls[name] = dict(prefill_s=run["prefill_s"],
                           decode_first_s=run["walls"][0],
                           decode_ms_min=1e3 * w[0],
                           decode_ms_median=1e3 * w[len(w) // 2],
                           decode_ms_max=1e3 * w[-1])
        say(f"[37a serve mesh sla] {name}: prefill(decode_max_len="
            f"{P37_MAX_LEN}) of {P37_BATCH} x {P37_PROMPT} tokens "
            f"{run['prefill_s']:.3f}s | {P37_NEW} decode-time SLA steps: "
            f"first {run['walls'][0] * 1e3:.1f} ms, then "
            f"{walls[name]['decode_ms_min']:.1f}-"
            f"{walls[name]['decode_ms_max']:.1f} ms a step (median "
            f"{walls[name]['decode_ms_median']:.1f}) | launches "
            f"{launches[name]} on {CARD[0]}")
    del plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    partial = _partial_cases(cfg, sharded["cache"], pos - 1)
    ok = (all(same.values()) and finite and pos == P37_PROMPT + P37_NEW
          and all(v == want for v in launches.values())
          and all(r["ok"] for r in partial))
    say(f"[37a serve mesh sla] {LM_ARCH} full width over make_host_mesh(1, "
        f"1): bitwise {same} (leaves that differ: {bad_leaves}), finite "
        f"{finite}, pos {pos}, counters {counters} | the plain state's "
        f"{state_gb:.2f} GB to the host in {to_host_s:.1f}s | partial mode "
        f"{sum(r['ok'] for r in partial)}/{len(partial)} OK | "
        f"{time.time() - t_all:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"decode-time SLA over the mesh: bitwise {same} "
                           f"({bad_leaves}), finite {finite}, pos {pos}, "
                           f"launches {launches}, partial "
                           f"{[r for r in partial if not r['ok']]}")
    return dict(bitwise=same, launches=launches["mesh 1x1"],
                plain_launches=launches["plain"], walls=walls,
                counters=counters, state_gb=state_gb,
                wall_s=time.time() - t_all), partial, (
                    cfg, params, sharded["cache"])


def _snap_differ(a: dict, b: dict) -> list:
    """The leaves of two `_span_snapshot`s that are not bitwise equal."""
    def flat(s):
        out = {"pos": s["pos"], "k": s["k"], "v": s["v"], "hblk": s["hblk"]}
        for name, leaf in s["sla"].items():
            if isinstance(leaf, plan_lib.SLAPlan):
                out.update({f"plan.{n}": getattr(leaf, n)
                            for n in plan_lib.PLAN_LEAVES})
            else:
                out[name] = leaf
        return out

    fa, fb = flat(a), flat(b)
    return sorted(k for k in fa if not (
        torch.equal(fa[k], fb[k]) if torch.is_tensor(fa[k])
        else fa[k] == fb[k]))


def _p39_run(cfg, params, cache, toks, chunk: bool, path: str,
             capture=None) -> dict:
    """toks (B, C) on the decode-SLA `cache`: one `decode_chunk` (`chunk`)
    or C `decode_step`s, on the kernel backend in bf16 under the caller's
    scope, kernel 4's counters zeroed just before and read just after.
    `capture` (a dict) keeps a copy of layer 0's operands of kernel 4 in
    the chunk (`backends.decode_execute_chunk`), the clock stopped while
    it copies."""
    calls, paused = [0], [0.0]
    execute_chunk = backend_lib.decode_execute_chunk

    def hook(state, proj, q, pos, dcfg, **kw):
        if calls[0] == 0:
            torch.cuda.synchronize()
            t = time.time()
            capture.update(state={k: v.clone() for k, v in state.items()},
                           q=q.clone(), pos=pos)
            torch.cuda.synchronize()
            paused[0] += time.time() - t
        calls[0] += 1
        return execute_chunk(state, proj, q, pos, dcfg, **kw)

    if capture is not None:
        backend_lib.decode_execute_chunk = hook
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
            sla_decode.PARTIAL_LAUNCHES = 0
            _zero_head_dims()
            t0 = time.time()
            if chunk:
                logits, cache = transformer.decode_chunk(
                    params, cfg, toks, cache, torch.bfloat16,
                    backend="kernel")
            else:
                out = []
                for c in range(toks.shape[1]):
                    lg, cache = transformer.decode_step(
                        params, cfg, toks[:, c].contiguous(), cache,
                        torch.bfloat16, backend="kernel")
                    out.append(lg)
                logits = torch.stack(out, dim=1)
            torch.cuda.synchronize()
            wall = time.time() - t0 - paused[0]
            _read_head_dims(path)
    finally:
        backend_lib.decode_execute_chunk = execute_chunk
    return dict(logits=logits, wall_s=wall, launches=dict(
        sla_decode=sla_decode.LAUNCHES,
        sla_decode_paged=sla_decode.PAGED_LAUNCHES,
        sla_decode_partial=sla_decode.PARTIAL_LAUNCHES))


def _p39_scope(mesh, batch: int):
    if mesh is None:
        return contextlib.nullcontext()
    return actx.activation_sharding(
        mesh, actx.default_residual_spec(mesh, batch, P37_MAX_LEN),
        remat=False)


def _slots_run(cfg, params, prompts, path: str, mesh=None,
               capture=None) -> dict:
    """Phase 39a's run: a per-slot decode-SLA cache of len(prompts) slots
    (`make_cache(per_slot=True)`, K/V bf16), slot j admitting prompts[j]
    at step P39_ADMIT[j] (`prefill(decode_max_len=)` at batch 1, kernel
    backend, then `insert_slot`), P39_NEW greedy `decode_step`s (an idle
    slot decodes token 0), bf16, on the plain path (`mesh` None) or under
    the mesh's scopes (batch 1 for a prefill, the batch's for the rest),
    the counters zeroed just before and read just after. `capture` keeps
    a copy of layer 0's operands of kernel 4 at the last step, the clock
    stopped while it copies."""
    b = len(prompts)
    execute = backend_lib.decode_execute
    calls, paused = [0], [0.0]

    def hook(state, proj, q, pos, dcfg, **kw):
        if calls[0] == (P39_NEW - 1) * cfg.num_layers:
            torch.cuda.synchronize()
            t = time.time()
            capture.update(state={k: v.clone() for k, v in state.items()},
                           q=q.clone(), pos=pos.clone())
            torch.cuda.synchronize()
            paused[0] += time.time() - t
        calls[0] += 1
        return execute(state, proj, q, pos, dcfg, **kw)

    with torch.no_grad():
        with _p39_scope(mesh, b):
            cache = transformer.make_cache(cfg, b, P37_MAX_LEN,
                                           dtype=torch.bfloat16,
                                           decode_sla=True, per_slot=True,
                                           device=DEV)
        torch.cuda.synchronize()
        _zero_kernel_counts()
        sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
        sla_decode.PARTIAL_LAUNCHES = 0
        tok = torch.zeros((b,), dtype=torch.int32, device=DEV)
        logits, walls, per_step, admit_s = [], [], [], []
        if capture is not None:
            backend_lib.decode_execute = hook
        try:
            for i in range(P39_NEW):
                for slot, at in enumerate(P39_ADMIT):
                    if at != i:
                        continue
                    t0 = time.time()
                    with _p39_scope(mesh, 1):
                        hidden, single = transformer.prefill(
                            params, cfg, prompts[slot], torch.bfloat16,
                            "kernel", decode_max_len=P37_MAX_LEN)
                        first = logits_from_hidden(params, hidden).argmax(-1)
                    with _p39_scope(mesh, b):
                        transformer.insert_slot(cache, single, slot, cfg)
                    del hidden, single
                    tok[slot] = first[0].to(torch.int32)
                    torch.cuda.synchronize()
                    admit_s.append(time.time() - t0)
                before = sla_decode.LAUNCHES
                t0 = time.time()
                with _p39_scope(mesh, b):
                    lg, cache = transformer.decode_step(
                        params, cfg, tok, cache, torch.bfloat16,
                        backend="kernel")
                torch.cuda.synchronize()
                walls.append(time.time() - t0 - paused[0])
                paused[0] = 0.0
                per_step.append(sla_decode.LAUNCHES - before)
                logits.append(lg)
                active = torch.tensor([at <= i for at in P39_ADMIT],
                                      device=DEV)
                tok = torch.where(active, lg.argmax(-1).to(torch.int32),
                                  torch.zeros_like(tok))
        finally:
            backend_lib.decode_execute = execute
        launches = _kernel_counts([], path)
        launches.update(sla_decode=sla_decode.LAUNCHES,
                        sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                        sla_decode_partial=sla_decode.PARTIAL_LAUNCHES,
                        per_step=sorted(set(per_step)))
    return dict(logits=torch.stack(logits), cache=cache, walls=walls,
                admit_s=admit_s, launches=launches)


def _captured_flat(cfg, cap: dict):
    """Kernel 4's flat operands (`sla_decode`'s) of a captured call."""
    state, q, pos = cap["state"], cap["q"], cap["pos"]
    hkv = state["k"].shape[1]
    qg = backend_lib._group_heads(q.float(), hkv)
    qpg = backend_lib._group_heads(phi(q, cfg.sla.phi), hkv)
    return sla_decode._flat_args(
        *sla_decode.decode_operands(state, qg, qpg, pos), cfg.sla.block_kv)


def phase_slots_mesh(p37: dict) -> tuple:
    """Phase 39: continuous-batching decode over the mesh's path at world
    size 1 on this card, on phase 37's model (full-width Qwen3-1.7B, bf16)
    and state (P37_BATCH x P37_PROMPT tokens and P37_NEW steps, max_len
    P37_MAX_LEN), each path run plain and then under
    `activation_sharding` over `make_host_mesh(1, 1)` (NCCL through a
    FileStore under build/, destroyed after) on a placed copy of the
    parameters, the two bitwise equal:

    b. from phase 37's state advanced to P39_C // 2 tokens short of a
       block boundary, one `decode_chunk` of P39_C seeded tokens (kernel 4
       once a layer), every leaf it writes compared; then P39_C
       `decode_step`s on the same tokens, within phase 19's logit limit;
    d. learned routing (`routing_mode="learned"`, a seeded random scorer
       a layer) in P39_C `decode_step`s across that boundary;
    c. kernel 4's partial mode (`_span_cases`) over layer 0's operands of
       (ii) b's chunk (C = P39_C, per-token rows and diagonal partials)
       and (i) a's last step (each slot's rows at its own position);
    a. a per-slot cache of two slots (`_slots_run`): prompts of
       P39_PROMPTS tokens admitted with `insert_slot` at steps P39_ADMIT,
       P39_NEW greedy steps, each slot crossing its own block boundaries;
       logits, tokens and every leaf of the cache and of its "sla" state
       bitwise (the plain run's to the host, compared a layer at a time).
    Kernel 4 launches one a layer a step (a chunk: one a layer), its
    partial mode none (a one-rank mesh is layout A); kernel 1 one a layer
    a prefill on tensor cores. `p37` is phase 37's {"cfg", "params",
    "cache"}; its cache is taken from it and freed before a. Returns
    (summary, partial-mode rows)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    cfg, params, cache = p37["cfg"], p37["params"], p37.pop("cache")
    nl, bkv = cfg.num_layers, cfg.sla.block_kv
    gen = torch.Generator(device=DEV).manual_seed(39)
    h, dh = cfg.num_heads, cfg.head_dim
    for layer in params.layers:  # the scorer 39d reads (threshold: unread)
        layer.routing = torch.nn.ParameterDict({
            name: torch.nn.Parameter((torch.randn(
                (h, dh, dh), generator=gen, device=DEV) * dh ** -0.5).to(
                    torch.bfloat16)) for name in ("wq", "wk")})
    learned = dataclasses.replace(cfg, sla=cfg.sla.replace(
        routing_mode="learned"))
    b = cache["k"].shape[1]
    # b and d: P39_C tokens crossing a block boundary at their middle
    pos = int(cache["pos"])
    walk = (-(pos + P39_C // 2)) % bkv
    with torch.no_grad():
        for _ in range(walk):
            tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                                device=DEV, dtype=torch.int32)
            _, cache = transformer.decode_step(params, cfg, tok, cache,
                                               torch.bfloat16,
                                               backend="kernel")
    pos = int(cache["pos"])
    toks = torch.randint(0, cfg.vocab_size, (b, P39_C), generator=gen,
                         device=DEV, dtype=torch.int32)
    start = _span_snapshot(cache, pos, P39_C, bkv)
    chunk_cap = {}
    runs, after = {}, {}

    def run(name, model, cfg_, chunk, path, mesh=None, capture=None):
        _span_restore(cache, start, pos, P39_C, bkv)
        with _p39_scope(mesh, b):
            runs[name] = _p39_run(cfg_, model, cache, toks, chunk, path,
                                  capture)
        after[name] = _span_snapshot(cache, pos, P39_C, bkv)

    run("chunk plain", params, cfg, True, "lm_slots_p39", capture=chunk_cap)
    run("steps plain", params, cfg, False, "lm_slots_p39")
    run("learned plain", params, learned, False, "lm_slots_p39")
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=DEV, dtype=torch.int32)
               for n in P39_PROMPTS]
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        placed = copy.deepcopy(params)
        sharding.place_module(placed, mesh)
        run("chunk mesh 1x1", placed, cfg, True, "lm_slots_mesh", mesh)
        run("learned mesh 1x1", placed, learned, False, "lm_slots_mesh",
            mesh)
        same = {"chunk logits": torch.equal(
                    runs["chunk plain"]["logits"],
                    runs["chunk mesh 1x1"]["logits"]),
                "chunk state": not _snap_differ(after["chunk plain"],
                                                after["chunk mesh 1x1"]),
                "learned logits": torch.equal(
                    runs["learned plain"]["logits"],
                    runs["learned mesh 1x1"]["logits"]),
                "learned state": not _snap_differ(
                    after["learned plain"], after["learned mesh 1x1"])}
        lc, ls = runs["chunk plain"]["logits"], runs["steps plain"]["logits"]
        diff = float((lc - ls).abs().max())
        limit = LM_LOGIT_TOL * max(1.0, float(ls.abs().max()))
        learned_differs = bool((runs["learned plain"]["logits"] != ls).any())
        finite = all(bool(torch.isfinite(r["logits"]).all())
                     for r in runs.values())
        for r in runs.values():
            del r["logits"]
        del cache, start, after, lc, ls
        gc.collect()
        torch.cuda.empty_cache()
        # a: the plain run's state to the host, then the mesh run
        slot_cap = {}
        plain = _slots_run(cfg, params, prompts, "lm_slots_p39",
                           capture=slot_cap)
        t0 = time.time()
        held = {path: (leaf.cpu() if torch.is_tensor(leaf) else leaf)
                for path, leaf in sharding.tree_leaves(plain["cache"])}
        to_host_s = time.time() - t0
        plain["cache"] = None
        gc.collect()
        torch.cuda.empty_cache()
        sharded = _slots_run(cfg, placed, prompts, "lm_slots_mesh", mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del placed
    for layer in params.layers:
        del layer.routing
    leaves = dict(sharding.tree_leaves(sharded["cache"]))
    bad = [path for path in sorted(held)
           if path == "pos_host" and not np.array_equal(leaves[path],
                                                        held[path])
           or path != "pos_host" and not _leaf_bitwise(leaves.get(path),
                                                      held[path])]
    same.update({
        "slots logits": torch.equal(plain["logits"], sharded["logits"]),
        "slots leaves": sorted(leaves) == sorted(held) and not bad})
    del held, leaves
    counters = {key: sharded["cache"]["sla"][key].tolist()
                for key in ("extends", "replans", "reuses")}
    slot_pos = sharded["cache"]["pos"].tolist()
    sharded["cache"] = None
    gc.collect()
    torch.cuda.empty_cache()
    finite = finite and all(bool(torch.isfinite(r["logits"]).all())
                            for r in (plain, sharded))
    want_runs = {name: dict(sla_decode=nl * (1 if "chunk" in name
                                             else P39_C),
                            sla_decode_paged=0, sla_decode_partial=0)
                 for name in runs}
    want_slots = dict(sla_fwd=nl * len(P39_PROMPTS),
                      tc_sla_fwd=nl * len(P39_PROMPTS),
                      sla_decode=nl * P39_NEW, sla_decode_paged=0,
                      sla_decode_partial=0, per_step=[nl])
    slots = {"plain": plain, "mesh 1x1": sharded}
    launches = {name: r["launches"] for name, r in runs.items()}
    launches.update({f"slots {name}": {k: r["launches"][k]
                                       for k in want_slots}
                     for name, r in slots.items()})
    launch_ok = (all(launches[k] == want_runs[k] for k in want_runs)
                 and all(launches[f"slots {k}"] == want_slots
                         for k in slots))
    walls = {name: r["wall_s"] for name, r in runs.items()}
    for name, r in slots.items():
        w = sorted(r["walls"])
        walls[f"slots {name}"] = dict(
            admit_s=r["admit_s"], decode_ms_min=1e3 * w[0],
            decode_ms_median=1e3 * w[len(w) // 2], decode_ms_max=1e3 * w[-1])
        say(f"[39a slots] {name}: per-slot cache of {len(P39_PROMPTS)} "
            f"slots (max_len {P37_MAX_LEN}), prompts {P39_PROMPTS} admitted "
            f"at steps {P39_ADMIT} in {[round(x, 3) for x in r['admit_s']]}"
            f" s (prefill and insert_slot) | {P39_NEW} steps "
            f"{walls[f'slots {name}']['decode_ms_min']:.1f}-"
            f"{walls[f'slots {name}']['decode_ms_max']:.1f} ms (median "
            f"{walls[f'slots {name}']['decode_ms_median']:.1f}) | launches "
            f"{launches[f'slots {name}']} on {CARD[0]}")
    say(f"[39b decode_chunk] C={P39_C} from pos {pos} (a block boundary at "
        f"{pos + P39_C // 2}) on phase 37's state: chunk plain "
        f"{walls['chunk plain'] * 1e3:.1f} ms, mesh 1x1 "
        f"{walls['chunk mesh 1x1'] * 1e3:.1f} ms, {P39_C} steps "
        f"{walls['steps plain'] * 1e3:.1f} ms | chunk vs steps logits max "
        f"abs diff {diff:.4g} (limit {limit:.4g}) | launches "
        f"{ {k: v['sla_decode'] for k, v in launches.items()} }")
    say(f"[39d learned routing] {P39_C} steps across the boundary at "
        f"{pos + P39_C // 2}: plain {walls['learned plain'] * 1e3:.1f} ms, "
        f"mesh 1x1 {walls['learned mesh 1x1'] * 1e3:.1f} ms | logits differ "
        f"from threshold routing's: {learned_differs}")
    kernel1 = {name: r["launches"]["tc_sla_fwd"] for name, r in slots.items()}
    del runs, slots, plain
    gc.collect()
    torch.cuda.empty_cache()
    flat_rows = _captured_flat(cfg, slot_cap)
    flat_chunk = _captured_flat(cfg, chunk_cap)
    del slot_cap, chunk_cap
    hkv = cfg.num_kv_heads
    rows = _span_cases(cfg, flat_rows, "39c partial slots", f"{LM_ARCH} "
                       f"layer 0 per-slot rows B {b}, H {h}, Hkv {hkv}, D "
                       f"{dh}, Tn {P37_MAX_LEN // bkv}, K "
                       f"{flat_rows[0].shape[-1]}, slot positions "
                       f"{sorted(set(flat_rows[3].tolist()))}")
    rows += _span_cases(cfg, flat_chunk, "39c partial chunk", f"{LM_ARCH} "
                        f"layer 0 decode_chunk rows B {b}, H {h}, Hkv "
                        f"{hkv}, D {dh}, Tn {P37_MAX_LEN // bkv}, K "
                        f"{flat_chunk[0].shape[-1]}, C {P39_C} from pos "
                        f"{pos}")
    del flat_rows, flat_chunk, sharded
    gc.collect()
    torch.cuda.empty_cache()
    ok = (all(same.values()) and finite and diff <= limit and launch_ok
          and learned_differs and all(r["ok"] for r in rows)
          and slot_pos == [P39_PROMPTS[j] + P39_NEW - P39_ADMIT[j]
                           for j in range(len(P39_PROMPTS))])
    say(f"[39 slots mesh] {LM_ARCH} full width over make_host_mesh(1, 1): "
        f"bitwise {same} (slot leaves that differ: {bad}), finite {finite},"
        f" slot positions {slot_pos}, counters {counters} | the plain "
        f"per-slot state to the host in {to_host_s:.1f}s | partial mode "
        f"{sum(r['ok'] for r in rows)}/{len(rows)} OK | "
        f"{time.time() - t_all:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(
            f"continuous-batching decode over the mesh: bitwise {same} "
            f"({bad}), finite {finite}, chunk vs steps {diff} (limit "
            f"{limit}), launches {launches}, learned differs "
            f"{learned_differs}, positions {slot_pos}, partial "
            f"{[r for r in rows if not r['ok']]}")
    total = {k: sum(v[k] for name, v in launches.items() if "mesh" in name)
             for k in ("sla_decode", "sla_decode_partial")}
    plain_total = {k: sum(v[k] for name, v in launches.items()
                          if "mesh" not in name)
                   for k in ("sla_decode", "sla_decode_partial")}
    return dict(bitwise=same, launches=total, plain_launches=plain_total,
                launches_by_run=launches, kernel1=kernel1, walls=walls,
                chunk_vs_steps=dict(diff=diff, limit=limit),
                counters=counters, wall_s=time.time() - t_all), rows

def _dit_sample_run(cfg, params, noise, cond, path: str) -> dict:
    """Phase 38a under the caller's scope: `dit.sample` of P38_STEPS steps
    with adaptive refresh at P38_DRIFT (f32, kernel backend), every
    forward's returned plan stack kept. Returns the latents, the trace,
    the stacks, the wall and kernel 1's launches by route (`path` records
    their head dims)."""
    stacks, forward = [], dit.forward

    def recorded(*a, **kw):
        out = forward(*a, **kw)
        if kw.get("return_plans"):
            stacks.append(out[1])
        return out

    torch.cuda.synchronize()
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    sla_fwd.PLANES_LAUNCHES = 0
    _zero_head_dims()
    dit.forward = recorded
    t0 = time.time()
    try:
        x, trace = dit.sample(params, cfg, noise, num_steps=P38_STEPS,
                              cond=cond, compute_dtype=torch.float32,
                              backend="kernel", refresh_mode="adaptive",
                              drift_threshold=P38_DRIFT, return_trace=True)
        torch.cuda.synchronize()
    finally:
        dit.forward = forward
    wall = time.time() - t0
    launches = dict(zip(("sla_fwd", "tc_sla_fwd", "split_sla_fwd",
                         "planes"), _fwd_counters()))
    _read_head_dims(path)
    return dict(x=x, trace=trace, stacks=stacks, wall_s=wall,
                forwards=P38_STEPS, launches=launches)


def _dit_serve_run(cfg, params, reqs, path: str) -> dict:
    """Phase 38b under the caller's scope: phase 4's trace (`reqs`: latent,
    condition and t_start a request) through a `DiffusionScheduler` of
    MAIN_SLOTS slots at MAIN_SEQ tokens, MAIN_STEPS steps each, its
    default refresh, f32 on the kernel backend. Returns each request's
    final latent and latency, the plan counters, the forwards, the wall
    and kernel 1's launches by route."""
    sched = DiffusionScheduler(cfg, params, num_slots=MAIN_SLOTS,
                               seq_len=MAIN_SEQ, backend="kernel",
                               compute_dtype=torch.float32, device=DEV)
    for lat, cond, t_start in reqs:
        sched.submit(lat, DenoiseParams(num_steps=MAIN_STEPS,
                                        t_start=t_start), cond=cond)
    forwards, forward = [0], dit.forward

    def counted(*a, **kw):
        forwards[0] += 1
        return forward(*a, **kw)

    torch.cuda.synchronize()
    sla_fwd.LAUNCHES = sla_fwd.TC_LAUNCHES = sla_fwd.SPLIT_LAUNCHES = 0
    sla_fwd.PLANES_LAUNCHES = 0
    _zero_head_dims()
    dit.forward = counted
    t0 = time.time()
    try:
        done = sched.drain()
    finally:
        dit.forward = forward
    wall = time.time() - t0
    launches = dict(zip(("sla_fwd", "tc_sla_fwd", "split_sla_fwd",
                         "planes"), _fwd_counters()))
    _read_head_dims(path)
    st = sched.stats
    return dict(results=[r.result for r in done],
                finished=all(r.state.value == "finished" for r in done),
                latency_s=[r.metrics.latency_s for r in done],
                counters={k: getattr(st, k) for k in P38_COUNTERS},
                forwards=forwards[0], wall_s=wall, launches=launches)


def phase_dit_serve_mesh(cfg, params, main_run: dict) -> dict:
    """Phase 38: DiT serving over the mesh's path at world size 1 on this
    card, on phase 4's model (full-width Wan2.1-1.3B, 30 layers, f32) at
    32,768 tokens on the kernel backend, run just after phase 4: a.
    `dit.sample` (P38_STEPS steps, adaptive refresh at P38_DRIFT, batch 1,
    a seeded text condition) on the plain path, then on a copy of the
    parameters placed on `make_host_mesh(1, 1)` (NCCL through a FileStore
    under build/, destroyed after) inside `activation_sharding(mesh,
    default_residual_spec(mesh, 1, MAIN_SEQ))`; b. phase 4's trace
    (`_main_requests`) through a `DiffusionScheduler` on that copy in the
    same scope, where the scheduler enters its own spec a call, against
    phase 4's run of it (`main_run`: the plain path). Held bitwise: the
    sample's latents, trace and every plan leaf of every forward; every
    request's final latent; the plan counters equal. Kernel 1: 30
    launches a forward, all on the split route with one pre-pass launch
    each. Prints each request's latency on both paths beside the card's
    name and power limit. Returns the summary."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    nl = cfg.num_layers
    rs = np.random.default_rng(38)
    noise = torch.from_numpy(rs.standard_normal(
        (1, MAIN_SEQ, cfg.patch_dim), dtype=np.float32)).to(DEV)
    cond = torch.from_numpy(rs.standard_normal(
        (1, cfg.cond_len, cfg.d_model), dtype=np.float32)).to(DEV)
    plain = _dit_sample_run(cfg, params, noise, cond, "dit_serve_p38")
    placed = copy.deepcopy(params)
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        sharding.place_module(placed, mesh)
        residual = actx.default_residual_spec(mesh, 1, MAIN_SEQ)
        with actx.activation_sharding(mesh, residual, remat=False):
            sample = _dit_sample_run(cfg, placed, noise, cond,
                                     "dit_serve_mesh")
            serve = _dit_serve_run(cfg, placed, _main_requests(cfg),
                                   "dit_serve_mesh")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    same = {"latents": torch.equal(plain["x"], sample["x"]),
            "trace": all(torch.equal(plain["trace"][k], sample["trace"][k])
                         for k in plain["trace"]),
            "plans": len(plain["stacks"]) == P38_STEPS
            and len(sample["stacks"]) == P38_STEPS
            and all(torch.equal(getattr(x, n), getattr(y, n))
                    for x, y in zip(plain["stacks"], sample["stacks"])
                    for n in plan_lib.PLAN_LEAVES),
            "served_latents": len(serve["results"]) == len(MAIN_T_STARTS)
            and all(np.array_equal(x, y) for x, y in zip(
                main_run["results"], serve["results"])),
            "counters": serve["counters"] == main_run["counters"]}
    del plain["stacks"], sample["stacks"]
    finite = (all(bool(torch.isfinite(run["x"]).all())
                  for run in (plain, sample))
              and all(np.isfinite(r).all() for r in serve["results"])
              and serve["finished"])
    replans = plain["trace"]["replanned"].sum(dim=1).tolist()
    launches = {"plain sample": plain["launches"],
                "mesh 1x1 sample": sample["launches"],
                "mesh 1x1 serve": serve["launches"]}
    forwards = {"plain sample": P38_STEPS, "mesh 1x1 sample": P38_STEPS,
                "mesh 1x1 serve": serve["forwards"]}
    want = {k: dict(sla_fwd=nl * n, tc_sla_fwd=0, split_sla_fwd=nl * n,
                    planes=nl * n) for k, n in forwards.items()}
    say(f"[38 dit serve mesh] dit.sample of {P38_STEPS} adaptive steps "
        f"(threshold {P38_DRIFT}) at {MAIN_SEQ} tokens, batch 1: plain "
        f"{plain['wall_s']:.3f}s, mesh 1x1 {sample['wall_s']:.3f}s | phase "
        f"4's trace, {len(MAIN_T_STARTS)} requests x {MAIN_STEPS} steps "
        f"through {MAIN_SLOTS} slots in {serve['forwards']} forwards: "
        f"latencies plain (phase 4) "
        + ", ".join(f"{x:.3f}" for x in main_run["latency_s"])
        + " s, mesh 1x1 " + ", ".join(f"{x:.3f}" for x in serve["latency_s"])
        + f" s | counters {serve['counters']} | on {CARD[0]}")
    ok = (all(same.values()) and finite
          and all(launches[k] == want[k] for k in want))
    say(f"[38 dit serve mesh] {cfg.name} full width over make_host_mesh(1, "
        f"1): bitwise {same}, finite {finite} | the sample re-planned "
        f"{replans} layers a step after step 0 | kernel 1 launches "
        f"{launches} (expected {nl} a forward, all on the split route, one "
        f"pre-pass each) | {time.time() - t_all:.1f}s "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"DiT serving over the mesh: bitwise {same}, "
                           f"finite {finite}, launches {launches}")
    total = {k: sample["launches"][k] + serve["launches"][k]
             for k in want["mesh 1x1 serve"]}
    return dict(bitwise=same, launches=total,
                plain_launches=plain["launches"], launches_by_run=launches,
                sample_replans=replans,
                walls=dict(sample_plain_s=plain["wall_s"],
                           sample_mesh_s=sample["wall_s"],
                           serve_mesh_s=serve["wall_s"],
                           serve_plain_s=main_run["wall_s"],
                           latency_plain_s=main_run["latency_s"],
                           latency_mesh_s=serve["latency_s"]),
                counters=serve["counters"], wall_s=time.time() - t_all)


def _p40_scope(mesh, batch: int, length: int = P37_MAX_LEN):
    if mesh is None:
        return contextlib.nullcontext()
    return actx.activation_sharding(
        mesh, actx.default_residual_spec(mesh, batch, length), remat=False)


def _p40_zero():
    _zero_kernel_counts()
    sla_decode.LAUNCHES = sla_decode.PAGED_LAUNCHES = 0
    sla_decode.PARTIAL_LAUNCHES = sla_decode.PAGED_PARTIAL_LAUNCHES = 0


def _p40_counts(path: str) -> dict:
    launches = _kernel_counts([], path)
    launches.update(sla_decode=sla_decode.LAUNCHES,
                    sla_decode_paged=sla_decode.PAGED_LAUNCHES,
                    sla_decode_partial=sla_decode.PARTIAL_LAUNCHES,
                    sla_decode_paged_partial=(
                        sla_decode.PAGED_PARTIAL_LAUNCHES))
    return launches


def _paged_mesh_run(cfg, params, prompts, path: str, mesh=None,
                    keep: bool = False) -> dict:
    """Phase 40a's run: a paged decode-SLA cache of two slots
    (`make_paged_cache`, P40_POOL pages, K/V bf16), slot j admitting
    prompts[j] at step P40_ADMIT[j] (`prefill(decode_max_len=)` at batch 1
    on the kernel backend, then `insert_slot_paged` into pages 3 ..;
    slot 1's first P40_SHARED // bkv pages are slot 0's), slot 0's page of
    block 1 copied on write (`copy_page`) at step P40_COW_STEP, a fresh
    zeroed page (`copy_page(new, 0)`) whenever an admitted slot enters a
    block, P37_NEW greedy `decode_step`s (an idle slot decodes token 0 on
    its scratch page), bf16, on the plain path (`mesh` None) or under the
    mesh's scopes, the counters zeroed just before and read just after.
    Returns the logits, the cache, with `keep` slot 0's prompt logits and
    K/V (phase 40b's blocking yardstick), the walls and the launches."""
    b, bkv = len(prompts), cfg.sla.block_kv
    tn = P37_MAX_LEN // bkv
    npp = prompts[0].shape[1] // bkv
    shared = P40_SHARED // bkv
    pages = [list(range(3, 3 + npp)),
             list(range(3, 3 + shared))
             + list(range(3 + npp, 3 + 2 * npp - shared))]
    fresh = 3 + 2 * npp - shared
    cow, fresh = fresh, fresh + 1
    pt = np.zeros((b, tn), np.int32)
    for slot in range(b):
        pt[slot] = 1 + slot  # its scratch page
    with torch.no_grad():
        with _p40_scope(mesh, b):
            cache = transformer.make_paged_cache(
                cfg, b, P37_MAX_LEN, P40_POOL, dtype=torch.bfloat16,
                decode_sla=True, device=DEV)
        torch.cuda.synchronize()
        _p40_zero()
        tok = torch.zeros((b,), dtype=torch.int32, device=DEV)
        logits, walls, per_step, admit_s, first = [], [], [], [], {}
        active = set()
        for i in range(P37_NEW):
            for slot, at in enumerate(P40_ADMIT):
                if at != i:
                    continue
                t0 = time.time()
                with _p40_scope(mesh, 1):
                    hidden, single = transformer.prefill(
                        params, cfg, prompts[slot], torch.bfloat16, "kernel",
                        decode_max_len=P37_MAX_LEN)
                    lg = logits_from_hidden(params, hidden)
                with _p40_scope(mesh, b):
                    transformer.insert_slot_paged(cache, single, slot,
                                                  pages[slot], cfg)
                if slot == 0 and keep:
                    n = prompts[0].shape[1]
                    first = dict(logits=lg, k=single["k"][..., :n, :].clone(),
                                 v=single["v"][..., :n, :].clone())
                del hidden, single
                pt[slot] = 0
                pt[slot, :npp] = pages[slot]
                active.add(slot)
                tok[slot] = lg.argmax(-1)[0].to(torch.int32)
                torch.cuda.synchronize()
                admit_s.append(time.time() - t0)
            if i == P40_COW_STEP:
                transformer.copy_page(cache, cow, int(pt[0, 1]))
                pt[0, 1] = cow
            for slot in sorted(active):
                p = int(cache["pos_host"][slot])
                if p % bkv == 0 and p // bkv < tn:
                    transformer.copy_page(cache, fresh, 0)
                    pt[slot, p // bkv] = fresh
                    fresh += 1
            transformer.set_page_table(cache, pt)
            before = sla_decode.PAGED_LAUNCHES
            t0 = time.time()
            with _p40_scope(mesh, b):
                lg, cache = transformer.decode_step(
                    params, cfg, tok, cache, torch.bfloat16,
                    backend="kernel")
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            per_step.append(sla_decode.PAGED_LAUNCHES - before)
            logits.append(lg)
            on = torch.tensor([s in active for s in range(b)], device=DEV)
            tok = torch.where(on, lg.argmax(-1).to(torch.int32),
                              torch.zeros_like(tok))
        launches = _p40_counts(path)
        launches["per_step"] = sorted(set(per_step))
    return dict(logits=torch.stack(logits), cache=cache, first=first,
                walls=walls, admit_s=admit_s, launches=launches,
                pages_used=fresh)


def _chunked_mesh_run(cfg, params, prompt, path: str, mesh=None) -> dict:
    """Phase 40b's run: `make_prefill_carry` of the prompt's bucket
    (decode rows kept), `prefill_chunk` in chunks of PC_CHUNK_BLOCKS
    blocks on the kernel backend, `finalize_chunked_prefill` for a
    P37_MAX_LEN cache, bf16, on the plain path or under the mesh's scopes
    (the bucket's for the chunks, the cache's for the finalize), the
    counters zeroed just before and read just after. Returns the last
    chunk's logits, the cache, the carry's bytes, the wall and the
    launches."""
    bucket = prompt.shape[1]
    chunk = PC_CHUNK_BLOCKS * cfg.sla.block_kv
    with torch.no_grad():
        torch.cuda.synchronize()
        _p40_zero()
        t0 = time.time()
        with _p40_scope(mesh, 1, bucket):
            carry = transformer.make_prefill_carry(
                cfg, bucket, torch.bfloat16, decode_sla=True, device=DEV)
            nbytes = sum(t.numel() * t.element_size() for t in carry.values())
            for start in range(0, bucket, chunk):
                carry, hidden = transformer.prefill_chunk(
                    params, cfg, prompt[:, start:start + chunk], carry, start,
                    torch.bfloat16, "kernel", decode_max_len=P37_MAX_LEN)
            lg = logits_from_hidden(params, hidden)
        with _p40_scope(mesh, 1):
            cache = transformer.finalize_chunked_prefill(cfg, carry,
                                                         P37_MAX_LEN)
        del carry, hidden
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _p40_counts(path)
    return dict(logits=lg, cache=cache, carry_bytes=nbytes, wall_s=wall,
                launches=launches)


def _leaves_equal(a: dict, b: dict) -> list:
    """The paths of two caches' leaves that are not bitwise equal (a leaf
    missing from either counts)."""
    from repro_torch.distributed import sharding
    la, lb = dict(sharding.tree_leaves(a)), dict(sharding.tree_leaves(b))
    return sorted(set(la) ^ set(lb)) + [
        path for path in sorted(set(la) & set(lb))
        if not (np.array_equal(la[path], lb[path])
                if isinstance(la[path], np.ndarray)
                else _leaf_bitwise(la[path], lb[path]))]


def _paged_partial_cases(cfg, cache) -> list:
    """Phase 40c: kernel 5's partial mode (`sla_decode_paged_partial`) over
    layer 0's paged state of the mesh run's cache (its pools, page table,
    live rows and totals) with a seeded query at each slot's last
    position, cut into each of P37_SPANS spans as a rank of layouts B and
    C holds them (`cases.paged_span_operands`): every span's records
    against the twin's at the kernel's width (5e-5 x max(1, max |twin|),
    field by field), bitwise kernel 4's partial mode on the page-gathered
    view of the span at the same width, two launches bitwise equal, and
    the spans' records combined (`sla_decode.sla_decode_combine`) against
    unsplit kernel 5 (5e-5 x max(1, max |o|)). CUDA-graph times of 20
    calls (every span's launch, one after another on this one card) and
    of unsplit kernel 5, CUDA-event times of the twin and the combine, the
    bytes bound; the launches here are checks, not a main path's."""
    st = cache["sla"]
    b, tn = cache["pt"].shape
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g, bh = h // hkv, b * h
    gen = torch.Generator(device=DEV).manual_seed(40)
    q = torch.randn((bh, 1, d), generator=gen, device=DEV)
    posv = (torch.as_tensor(cache["pos_host"], device=DEV) - 1).int() \
        .repeat_interleave(h).contiguous()
    args = (st["live_lut"][0].reshape(bh, 1, -1).contiguous(),
            cache["pt"].contiguous(),
            st["live_cnt"][0].reshape(bh, 1).contiguous(),
            st["live_marg"][0].reshape(bh, 1).contiguous(), posv, q,
            phi(q, cfg.sla.phi).float().contiguous(), cache["kp"][0],
            cache["vp"][0], cache["slap"]["hblk"][0],
            cache["slap"]["zblk"][0],
            st["htot"][0].reshape(b * hkv, d, d).contiguous(),
            st["ztot"][0].reshape(b * hkv, d).contiguous())
    kw = dict(scale=d ** -0.5, block_kv=cfg.sla.block_kv, group=g)
    snap = (sla_decode.PAGED_LAUNCHES, sla_decode.PARTIAL_LAUNCHES,
            sla_decode.PAGED_PARTIAL_LAUNCHES, _head_dim_snapshot())
    want = sla_decode.sla_decode_paged(*args, **kw)
    whole_ms = cuda_graph_ms(lambda: sla_decode.sla_decode_paged(*args,
                                                                 **kw))
    dense_all = cases.paged_dense_operands(args)
    shape = (f"{LM_ARCH} layer 0 paged state B {b}, H {h}, Hkv {hkv}, D "
             f"{d}, Tn {tn}, K {args[0].shape[-1]}, pool "
             f"{cache['kp'].shape[1]} pages, slot positions "
             f"{sorted(set(posv.tolist()))}")
    rows = []
    for spans in P37_SPANS:
        nb = tn // spans
        ops = [cases.paged_span_operands(args, r * nb, nb)
               for r in range(spans)]
        records, errs, neutral, vs_k4, bitwise = [], [], True, True, True
        for paged, dense in ops:
            got = sla_decode.sla_decode_paged_partial(*paged, **kw)
            again = sla_decode.sla_decode_paged_partial(*paged, **kw)
            bitwise = bitwise and bool(torch.equal(got, again))
            vs_k4 = vs_k4 and bool(torch.equal(
                got, sla_decode.sla_decode_partial(*dense, **kw)))
            width = sla_decode.split_geometry(paged[4], paged[0])[
                "split_width"]
            err = cases.record_error(
                got, sla_decode.sla_decode_paged_partial_plain(
                    *paged, **kw, split_width=width))
            errs.append(err["err"])
            neutral = neutral and err["neutral_ok"]
            records.append(got)
        o_s, o_l = cases.span_combine(torch.stack(records), dense_all, g)
        comb = [float((x - w).abs().max()) / max(1.0, float(w.abs().max()))
                for x, w in zip((o_s, o_l), want)]
        ms = cuda_graph_ms(lambda: [sla_decode.sla_decode_paged_partial(
            *o[0], **kw) for o in ops])
        plain_ms = cuda_ms(lambda: [sla_decode.sla_decode_paged_partial_plain(
            *o[0], **kw) for o in ops], 3)
        combine_ms = cuda_ms(lambda: cases.span_combine(
            torch.stack(records), dense_all, g), 10)
        work = [_partial_bound(o[1], kw) for o in ops]
        # and each span's columns of the page table
        nbytes = sum(w[0] for w in work) + b * tn * 4
        flops = sum(w[1] for w in work)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.float32]
        bound_ms = max(t_bytes, t_ops) * 1e3
        ok = (max(errs) <= TWIN_TOL and neutral and bitwise and vs_k4
              and max(comb) <= TWIN_TOL)
        rows.append(dict(
            spans=spans, blocks_a_span=nb, shape=shape,
            max_abs_err=max(errs), combine_err=max(comb), neutral_ok=neutral,
            bitwise_repeat=bitwise, bitwise_vs_partial=vs_k4, ms=ms,
            ms_a_span=ms / spans, plain_ms=plain_ms, combine_ms=combine_ms,
            whole_ms=whole_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_bytes=nbytes, bound_flops=flops,
            bound_fraction=bound_ms / ms, library_ms=None, ok=ok))
        say(f"[40c paged partial] {shape} in {spans} spans of {nb} blocks: "
            f"records vs twin max err {max(errs):.3g} (limit {TWIN_TOL:g}, "
            f"relative), neutral rows {neutral}, bitwise on repeat "
            f"{bitwise}, bitwise kernel 4's partial mode on the gathered "
            f"view {vs_k4} | combined vs unsplit kernel 5 {max(comb):.3g} | "
            f"every span's launch {ms:.4f} ms ({ms / spans:.4f} a span), "
            f"twin {plain_ms:.3f} ms, combine {combine_ms:.3f} ms, unsplit "
            f"kernel 5 {whole_ms:.4f} ms | bound {bound_ms:.4f} ms by "
            f"{rows[-1]['bound_by']} ({nbytes / 1e6:.2f} MB, "
            f"{bound_ms / ms:.3f} of it reached) on {CARD[0]} "
            f"{'OK' if ok else 'FAIL'}")
        del ops, records
    sla_decode.PAGED_LAUNCHES, sla_decode.PARTIAL_LAUNCHES = snap[:2]
    sla_decode.PAGED_PARTIAL_LAUNCHES = snap[2]
    _restore_head_dims(snap[3])
    return rows


def phase_paged_mesh(p37: dict) -> tuple:
    """Phase 40: paged caches and chunked admission over the mesh's path
    at world size 1 on this card, on phase 37's model (full-width
    Qwen3-1.7B, bf16), each path run plain and then under
    `activation_sharding` over `make_host_mesh(1, 1)` (NCCL through a
    FileStore under build/, destroyed after) on a placed copy of the
    parameters, the two bitwise equal:

    a. a paged cache of two slots (`_paged_mesh_run`): P37_PROMPT-token
       prompts sharing their first P40_SHARED tokens (whole pages),
       admitted with `insert_slot_paged` at steps P40_ADMIT, a copy on
       write, P37_NEW greedy steps across the block boundaries: logits,
       tokens and every leaf of the cache (pools, page table, "sla"
       state) bitwise; kernel 5 one launch a layer a step, its partial
       mode none (a one-rank mesh is layout A), kernel 1 one tensor-core
       launch a layer a prefill;
    c. kernel 5's partial mode over the mesh run's layer 0
       (`_paged_partial_cases`);
    b. slot 0's prompt admitted in chunks of PC_CHUNK_BLOCKS blocks
       (`_chunked_mesh_run`): the last chunk's logits and every leaf of
       the finalized cache bitwise; the plain run held to a's blocking
       prefill of the same prompt within phase 18's limits (logits and
       K/V within LM_LOGIT_TOL x max(1, max |blocking|)); kernel 1 one
       tensor-core launch a layer a chunk.
    Both run phase 37's config with `col_capacity_factor` lifted to None,
    as the paged `Scheduler` serves it. `p37` is phase 37's {"cfg",
    "params"}. Returns (summary, partial-mode rows)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    t_all = time.time()
    params = p37["params"]
    # as the paged Scheduler serves it: chunk plan rows and shared pages
    # need per-row critical sets (`check_chunked_prefill`)
    cfg = dataclasses.replace(p37["cfg"], sla=p37["cfg"].sla.replace(
        col_capacity_factor=None))
    nl, bkv = cfg.num_layers, cfg.sla.block_kv
    gen = torch.Generator(device=DEV).manual_seed(40)
    p0 = torch.randint(0, cfg.vocab_size, (1, P37_PROMPT), generator=gen,
                       device=DEV, dtype=torch.int32)
    tail = torch.randint(0, cfg.vocab_size, (1, P37_PROMPT - P40_SHARED),
                         generator=gen, device=DEV, dtype=torch.int32)
    prompts = [p0, torch.cat([p0[:, :P40_SHARED], tail], dim=1)]
    plain = _paged_mesh_run(cfg, params, prompts, "lm_paged_p40", keep=True)
    blocking = plain.pop("first")
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, "cuda")
        placed = copy.deepcopy(params)
        sharding.place_module(placed, mesh)
        sharded = _paged_mesh_run(cfg, placed, prompts, "lm_paged_mesh",
                                  mesh)
        bad_a = _leaves_equal(plain["cache"], sharded["cache"])
        same = {"paged logits": torch.equal(plain["logits"],
                                            sharded["logits"]),
                "paged leaves": not bad_a}
        finite = all(bool(torch.isfinite(r["logits"]).all())
                     for r in (plain, sharded))
        pos = sharded["cache"]["pos"].tolist()
        counters = {key: sharded["cache"]["sla"][key].tolist()
                    for key in ("extends", "replans", "reuses")}
        plain["cache"] = None
        gc.collect()
        torch.cuda.empty_cache()
        rows = _paged_partial_cases(cfg, sharded["cache"])
        sharded["cache"] = None
        gc.collect()
        torch.cuda.empty_cache()
        chunk_plain = _chunked_mesh_run(cfg, params, p0, "lm_chunked_p40")
        chunk_mesh = _chunked_mesh_run(cfg, placed, p0, "lm_chunked_mesh",
                                       mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del placed
    bad_b = _leaves_equal(chunk_plain["cache"], chunk_mesh["cache"])
    same.update({"chunked logits": torch.equal(chunk_plain["logits"],
                                               chunk_mesh["logits"]),
                 "chunked leaves": not bad_b})
    # chunked against blocking (phase 18's limits): the last logits, the
    # prompt's K/V
    x, y = chunk_plain["logits"].float(), blocking["logits"].float()
    vs_blocking = dict(logits=float((x - y).abs().max()), logits_limit=(
        LM_LOGIT_TOL * max(1.0, float(y.abs().max()))), kv=0.0, kv_limit=0.0,
        kv_differ=0)
    for key in ("k", "v"):
        got = chunk_plain["cache"][key][..., :P37_PROMPT, :]
        for li in range(nl):
            a, w = got[li].float(), blocking[key][li].float()
            vs_blocking["kv"] = max(vs_blocking["kv"],
                                    float((a - w).abs().max()))
            vs_blocking["kv_limit"] = max(vs_blocking["kv_limit"], (
                LM_LOGIT_TOL * max(1.0, float(w.abs().max()))))
            vs_blocking["kv_differ"] += int((a != w).sum())
    chunk_pos = (chunk_plain["cache"]["pos"], chunk_mesh["cache"]["pos"])
    del blocking, x, y
    chunk_plain["cache"] = chunk_mesh["cache"] = None
    gc.collect()
    torch.cuda.empty_cache()
    finite = finite and all(bool(torch.isfinite(r["logits"]).all())
                            for r in (chunk_plain, chunk_mesh))
    want_paged = dict(sla_fwd=nl * len(prompts),
                      tc_sla_fwd=nl * len(prompts), sla_decode=0,
                      sla_decode_paged=nl * P37_NEW, sla_decode_partial=0,
                      sla_decode_paged_partial=0, per_step=[nl])
    nchunks = -(-P37_PROMPT // (PC_CHUNK_BLOCKS * bkv))
    want_chunked = dict(sla_fwd=nl * nchunks, tc_sla_fwd=nl * nchunks,
                        sla_decode=0, sla_decode_paged=0,
                        sla_decode_partial=0, sla_decode_paged_partial=0)
    runs = {"paged plain": plain, "paged mesh 1x1": sharded,
            "chunked plain": chunk_plain, "chunked mesh 1x1": chunk_mesh}
    launches = {name: {k: r["launches"][k] for k in (
        want_paged if "paged" in name else want_chunked)}
        for name, r in runs.items()}
    launch_ok = all(v == (want_paged if "paged" in name else want_chunked)
                    for name, v in launches.items())
    walls = {}
    for name in ("paged plain", "paged mesh 1x1"):
        r = runs[name]
        w = sorted(r["walls"])
        walls[name] = dict(admit_s=r["admit_s"], decode_ms_min=1e3 * w[0],
                           decode_ms_median=1e3 * w[len(w) // 2],
                           decode_ms_max=1e3 * w[-1])
        say(f"[40a paged mesh] {name}: paged cache of {len(prompts)} slots "
            f"({P40_POOL} pages, {r['pages_used']} named), prompts of "
            f"{P37_PROMPT} tokens sharing {P40_SHARED} admitted at steps "
            f"{P40_ADMIT} in {[round(t, 3) for t in r['admit_s']]} s "
            f"(prefill and insert_slot_paged) | {P37_NEW} steps "
            f"{walls[name]['decode_ms_min']:.1f}-"
            f"{walls[name]['decode_ms_max']:.1f} ms (median "
            f"{walls[name]['decode_ms_median']:.1f}) | launches "
            f"{launches[name]} on {CARD[0]}")
    for name in ("chunked plain", "chunked mesh 1x1"):
        walls[name] = runs[name]["wall_s"]
    say(f"[40b chunked mesh] {P37_PROMPT} tokens in {nchunks} chunks of "
        f"{PC_CHUNK_BLOCKS * bkv}, finalized for {P37_MAX_LEN}: plain "
        f"{walls['chunked plain']:.3f} s, mesh 1x1 "
        f"{walls['chunked mesh 1x1']:.3f} s, carry "
        f"{chunk_plain['carry_bytes'] / 1e9:.3f} GB a rank | vs blocking: "
        f"logits {vs_blocking['logits']:.4g} (limit "
        f"{vs_blocking['logits_limit']:.4g}), K/V {vs_blocking['kv']:.4g} "
        f"(limit {vs_blocking['kv_limit']:.4g}; "
        f"{vs_blocking['kv_differ']} elements differ) | launches "
        f"{ {k: launches[k] for k in ('chunked plain', 'chunked mesh 1x1')} }")
    del runs, plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    ok = (all(same.values()) and finite and launch_ok
          and all(r["ok"] for r in rows)
          and vs_blocking["logits"] <= vs_blocking["logits_limit"]
          and vs_blocking["kv"] <= vs_blocking["kv_limit"]
          and pos == [P37_PROMPT + P37_NEW - at for at in P40_ADMIT]
          and chunk_pos == (P37_PROMPT, P37_PROMPT))
    say(f"[40 paged mesh] {LM_ARCH} full width over make_host_mesh(1, 1): "
        f"bitwise {same} (paged leaves that differ: {bad_a}; chunked: "
        f"{bad_b}), finite {finite}, slot positions {pos}, counters "
        f"{counters} | kernel 5's partial mode {sum(r['ok'] for r in rows)}/"
        f"{len(rows)} OK | {time.time() - t_all:.1f}s "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(
            f"paged caches and chunked admission over the mesh: bitwise "
            f"{same} ({bad_a}, {bad_b}), finite {finite}, launches "
            f"{launches}, vs blocking {vs_blocking}, positions {pos}, "
            f"{chunk_pos}, partial {[r for r in rows if not r['ok']]}")
    total = {k: sum(v.get(k, 0) for name, v in launches.items()
                    if "mesh" in name)
             for k in ("tc_sla_fwd", "sla_decode_paged",
                       "sla_decode_paged_partial")}
    plain_total = {k: sum(v.get(k, 0) for name, v in launches.items()
                          if "mesh" not in name)
                   for k in ("tc_sla_fwd", "sla_decode_paged",
                             "sla_decode_paged_partial")}
    return dict(bitwise=same, launches=total, plain_launches=plain_total,
                launches_by_run=launches, walls=walls,
                vs_blocking=vs_blocking,
                carry_bytes=chunk_plain["carry_bytes"], counters=counters,
                wall_s=time.time() - t_all), rows


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
                         "full-width LM decode steps, one full-width LM "
                         "prefill, 8 paged decode steps, one full-width LM "
                         "training step, one MoE decode step, one zamba2, "
                         "one whisper and one gemma3 training step and "
                         "print the top device-time entries")
    args = ap.parse_args(argv)
    t_all = time.time()
    phase_card()
    phase_build()
    rows, planes = phase_kernel_vs_plain()
    cfg, params = _main_model(seed=0)
    main_run = phase_main_path(cfg, params)
    dsm = phase_dit_serve_mesh(cfg, params, main_run)
    del main_run["results"]
    plans, cross = phase_cross_check(cfg, params, args.profile)
    rows += phase_kernel_on_path_plans(cfg, plans)
    pcache = phase_plan_cache(cfg, params, plans)
    bwd_rows, fwd7_rows = phase_bwd_vs_plain()
    rows += fwd7_rows
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
    gc.collect()
    torch.cuda.empty_cache()
    lt, lt_fwd_rows, lt_bwd_rows = phase_lm_train(lm_cfg, lm_params,
                                                  args.profile)
    rows += lt_fwd_rows
    bwd_rows += lt_bwd_rows
    ltc = lt["launches"]
    del lm_cfg, lm_params  # the MoE model needs 56 GB of the card
    gc.collect()
    torch.cuda.empty_cache()
    moe_cfg, moe_params = _moe_model(seed=0)
    moe, moe_fwd_rows, moe_dec_rows = phase_moe_serving(moe_cfg, moe_params,
                                                        args.profile)
    rows += moe_fwd_rows
    dec_rows += moe_dec_rows
    moec = moe["launches"]
    del moe_cfg, moe_params
    gc.collect()
    torch.cuda.empty_cache()
    hy, hy_fwd_rows, hy_bwd_rows = phase_hybrid(args.profile)
    ed, ed_fwd_rows, ed_bwd_rows = phase_encdec(args.profile)
    rw = phase_rwkv6()
    rows += hy_fwd_rows + ed_fwd_rows
    bwd_rows += hy_bwd_rows + ed_bwd_rows
    hyc, edc = hy["launches"], ed["launches"]
    d256_fwd, d256_bwd, d256_dec, d256_pg = phase_d256_kernels()
    g3, g3_dec, g3_pg = phase_gemma3_serving()
    dn = phase_danube_serving()
    vl, vl_fwd_rows, vl_bwd_rows = phase_vlm_train()
    g3t, g3t_fwd_rows, g3t_bwd_rows = phase_gemma3_train(args.profile)
    mt = phase_lm_train_mesh(lt, args.profile)
    mtc = mt["launches"]
    fm = phase_family_train_mesh()
    fmc = {k: sum(r["launches"][k] for r in fm.values()) for k in mtc}
    sm = phase_serve_mesh()
    smc = sm["launches"]
    sf = phase_serve_mesh_families()
    sfc = {k: sum(r["launches"][k] for r in sf.values()) for k in smc}
    ex, ex_fwd_rows, ex_bwd_rows = phase_examples()
    sls, partial_rows, (cfg37, params37, cache37) = phase_serve_mesh_sla()
    p37 = {"cfg": cfg37, "params": params37, "cache": cache37}
    del cfg37, params37, cache37  # phase 39 frees the cache in p37
    slm, slot_rows = phase_slots_mesh(p37)
    pm, pm_rows = phase_paged_mesh(p37)
    del p37
    gc.collect()
    torch.cuda.empty_cache()
    slsc, slpc = sls["launches"], sls["plain_launches"]
    smsc, smpc = slm["launches"], slm["plain_launches"]
    pmr = pm["launches_by_run"]
    pm_paths = {"lm_paged_p40": pmr["paged plain"],
                "lm_paged_mesh": pmr["paged mesh 1x1"],
                "lm_chunked_p40": pmr["chunked plain"],
                "lm_chunked_mesh": pmr["chunked mesh 1x1"]}
    dsc, dspc = dsm["launches"], dsm["plain_launches"]
    rsc, rspc = sm["reuse"]["launches"], sm["reuse"]["plain_launches"]
    qsc = ex["quickstart"]["launches"]
    ftc = ex["finetune"]["runs"]["sla"]["launches"]
    rows += ex_fwd_rows
    bwd_rows += ex_bwd_rows
    rows += d256_fwd + vl_fwd_rows + g3t_fwd_rows
    dec_rows += d256_dec + g3_dec
    pg_rows += d256_pg + g3_pg
    bwd_rows += d256_bwd + vl_bwd_rows + g3t_bwd_rows
    g3c, g3pc = g3["launches"], g3["paged"]["launches"]
    dnc, vlc, g3tc = dn["launches"], vl["launches"], g3t["launches"]

    def arch_head_dims(*archs):
        return sorted({get_arch(a).head_dim for a in archs})

    def ran_at(name):
        """The head dims `name` launched at on the main paths (its
        wrapper's record, padding included), overall and by path."""
        by = {path: sorted(dims)
              for path, dims in PATH_HEAD_DIMS[name].items()}
        return {"head_dims": sorted(set().union(*by.values())),
                "head_dims_by_path": by}
    d64_keys = ("shape", "causal", "ms", "bound_ms", "bound_by",
                "bound_fraction", "bound_ms_padded", "bound_by_padded",
                "bound_fraction_padded", "ok")
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
    fwd_tc32 = [r for r in rows if r["route"] == FWD_TC32_ROUTE]
    fwd_split = [r for r in rows if r["route"] == FWD_SPLIT_ROUTE]
    ft_fwd = ex_fwd_rows[0]  # phase 36e: the finetune shape, tc32
    fwd7 = [r for r in fwd_tc32 if r["shape"].startswith("32x32")]
    fwd_fma = [r for r in rows if r["route"] == FWD_F32_ROUTE]
    wan_bwd = {r["kernel"]: r for r in bwd_rows
               if r["shape"] == "wan2_1_1_3b" and r["dtype"] == "f32"}
    wan_tc = {r["kernel"]: r for r in bwd_rows
              if r["shape"] == "wan2_1_1_3b" and r["dtype"] == "bf16"}
    # compiled flex_attention's forward on the same inputs and LUT (phase
    # 7): O^s and L only, no linear branch, so not the kernel's function
    flex16 = wan_tc["sla_bwd_dq"].get("library_fwd_ms")
    say(f"[31] sla_fwd at the Wan bf16 case (tensor cores): "
        f"{wan16['ms']:.3f} ms against its bound {wan16['bound_ms']:.3f} ms "
        f"({wan16['bound_fraction']:.1%}) | compiled flex_attention forward "
        f"on the same LUT (O^s and L only, lacks O^l): "
        + (f"{flex16:.3f} ms" if flex16 is not None else "not measured"))
    say(f"[31] sla_fwd at the Wan f32 case: split route {wan32['ms']:.3f} ms "
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
                "lm_disagg": dgc["tc_sla_fwd"],
                "lm_train": ltc["tc_sla_fwd"],
                "moe_prefill": moec["tc_sla_fwd"],
                "hybrid_train": hyc["tc_sla_fwd"],
                "hybrid_prefill": hy["prefill_launches"],
                "encdec_train": edc["tc_sla_fwd"],
                "encdec_prefill": ed["prefill_launches"],
                "gemma3_prefill": g3c["tc_sla_fwd"],
                "gemma3_paged_prefill": g3pc["tc_sla_fwd"],
                "danube_prefill": dnc["tc_sla_fwd"],
                "vlm_train": vlc["tc_sla_fwd"],
                "gemma3_train": g3tc["tc_sla_fwd"],
                "lm_train_mesh": mtc["tc_sla_fwd"],
                "family_train_mesh": fmc["tc_sla_fwd"],
                "lm_serve_mesh": smc["tc_sla_fwd"],
                "family_serve_mesh": sfc["tc_sla_fwd"],
                "lm_serve_sla": slpc["tc_sla_fwd"],
                "lm_serve_sla_mesh": slsc["tc_sla_fwd"],
                "lm_slots_p39": slm["kernel1"]["plain"],
                "lm_slots_mesh": slm["kernel1"]["mesh 1x1"],
                "quickstart": qsc["tc_sla_fwd"],
                "dit_finetune_sla": ftc["tc_sla_fwd"],
                "lm_prefill_reuse": rspc["tc_sla_fwd"],
                "lm_prefill_reuse_mesh": rsc["tc_sla_fwd"],
                "dit_serve_p38": dspc["tc_sla_fwd"],
                "dit_serve_mesh": dsc["tc_sla_fwd"],
                **{path: r["tc_sla_fwd"] for path, r in pm_paths.items()}}
    # the other paths compute in bf16: every launch there is a tensor-core
    # one (phases 9, 12, 15, 17 check), so none is on the split route
    split_paths = {"serve": main_run["split_launches"],
                   "serve_plan_cache": pc_launches["split_launches"],
                   "train": 0,
                   "lm_prefill": 0, "lm_paged_prefill": 0,
                   "lm_unpaged_prefill": 0, "lm_chunked_prefill": 0,
                   "lm_disagg": 0, "lm_train": 0, "moe_prefill": 0,
                   "hybrid_train": 0, "hybrid_prefill": 0,
                   "encdec_train": 0, "encdec_prefill": 0,
                   "gemma3_prefill": g3c["split_sla_fwd"],
                   "gemma3_paged_prefill": g3pc["split_sla_fwd"],
                   "danube_prefill": dnc["split_sla_fwd"], "vlm_train": 0,
                   "gemma3_train": 0, "lm_train_mesh": 0,
                   "family_train_mesh": 0, "lm_serve_mesh": 0,
                   "family_serve_mesh": 0, "lm_serve_sla": 0,
                   "lm_serve_sla_mesh": 0,
                   "quickstart": qsc["split_sla_fwd"],
                   "dit_finetune_sla": ftc["split_sla_fwd"],
                   "lm_prefill_reuse": 0, "lm_prefill_reuse_mesh": 0,
                   "dit_serve_p38": dspc["split_sla_fwd"],
                   "dit_serve_mesh": dsc["split_sla_fwd"],
                   **{path: 0 for path in pm_paths}}
    kernels = [{
        "name": "sla_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_fwd_split.cu",
        "replaces": "src/repro/kernels/sla_fwd.py:34",
        "launches": (main_run["launches"] + pc_launches["launches"]
                     + train["launches"]["sla_fwd"]
                     + lm["launches"]["sla_fwd"] + pgc["sla_fwd"]
                     + puc["sla_fwd"] + pcc["sla_fwd"] + dgc["sla_fwd"]
                     + ltc["sla_fwd"] + moec["sla_fwd"] + hyc["sla_fwd"]
                     + hy["prefill_launches"] + edc["sla_fwd"]
                     + ed["prefill_launches"] + g3c["sla_fwd"]
                     + g3pc["sla_fwd"] + dnc["sla_fwd"] + vlc["sla_fwd"]
                     + g3tc["sla_fwd"] + mtc["sla_fwd"]
                     + fmc["sla_fwd"] + smc["sla_fwd"]
                     + sfc["sla_fwd"] + slpc["sla_fwd"] + slsc["sla_fwd"]
                     + sum(slm["kernel1"].values())
                     + qsc["sla_fwd"] + ftc["sla_fwd"] + rspc["sla_fwd"]
                     + rsc["sla_fwd"] + dspc["sla_fwd"] + dsc["sla_fwd"]
                     + sum(r["sla_fwd"] for r in pm_paths.values())),
        "launches_by_path": {"serve": main_run["launches"],
                             "serve_plan_cache": pc_launches["launches"],
                             "train": train["launches"]["sla_fwd"],
                             "lm_prefill": lm["launches"]["sla_fwd"],
                             "lm_paged_prefill": pgc["sla_fwd"],
                             "lm_unpaged_prefill": puc["sla_fwd"],
                             "lm_chunked_prefill": pcc["sla_fwd"],
                             "lm_disagg": dgc["sla_fwd"],
                             "lm_train": ltc["sla_fwd"],
                             "moe_prefill": moec["sla_fwd"],
                             "hybrid_train": hyc["sla_fwd"],
                             "hybrid_prefill": hy["prefill_launches"],
                             "encdec_train": edc["sla_fwd"],
                             "encdec_prefill": ed["prefill_launches"],
                             "gemma3_prefill": g3c["sla_fwd"],
                             "gemma3_paged_prefill": g3pc["sla_fwd"],
                             "danube_prefill": dnc["sla_fwd"],
                             "vlm_train": vlc["sla_fwd"],
                             "gemma3_train": g3tc["sla_fwd"],
                             "lm_train_mesh": mtc["sla_fwd"],
                             "family_train_mesh": fmc["sla_fwd"],
                             "lm_serve_mesh": smc["sla_fwd"],
                             "family_serve_mesh": sfc["sla_fwd"],
                             "lm_serve_sla": slpc["sla_fwd"],
                             "lm_serve_sla_mesh": slsc["sla_fwd"],
                             "lm_slots_p39": slm["kernel1"]["plain"],
                             "lm_slots_mesh": slm["kernel1"]["mesh 1x1"],
                             "quickstart": qsc["sla_fwd"],
                             "dit_finetune_sla": ftc["sla_fwd"],
                             "lm_prefill_reuse": rspc["sla_fwd"],
                             "lm_prefill_reuse_mesh": rsc["sla_fwd"],
                             "dit_serve_p38": dspc["sla_fwd"],
                             "dit_serve_mesh": dsc["sla_fwd"],
                             **{path: r["sla_fwd"]
                                for path, r in pm_paths.items()}},
        **ran_at("sla_fwd"),
        "arch_head_dims": arch_head_dims(
            "wan2_1_1_3b", "lightningdit_1b", LM_ARCH, MOE_ARCH, HY_ARCH,
            ED_ARCH, G3_ARCH, DN_ARCH, VL_ARCH),
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
        "d64_cases": [{k: r[k] for k in d64_keys}
                      for r in hy_fwd_rows + ed_fwd_rows + vl_fwd_rows],
        "d256_cases": [{k: r[k] for k in (
            "shape", "dtype", "route", "max_abs_err", "bitwise_repeat", "ms",
            "plain_ms", "bound_ms", "bound_by", "bound_fraction", "ok")}
            for r in d256_fwd],
        "gemma3_train_cases": [{k: r[k] for k in (
            "shape", "head_dim", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fraction", "max_abs_err", "ok")} for r in g3t_fwd_rows],
        "finetune_cases": [{**{k: r[k] for k in FT_CASE_KEYS},
                            **{k: r[k] for k in FT_FLEX_KEYS if k in r},
                            **{k: r[k] for k in FT_FWD_TC32_KEYS if k in r}}
                           for r in ex_fwd_rows],
        "route_tc32": FWD_TC32_ROUTE,
        "source_tc32": "src/repro_torch/kernels/csrc/sla_fwd_tc32.cu",
        "tc32_launches": ftc["tc32_sla_fwd"] + qsc["tc32_sla_fwd"],
        "tc32_launches_by_path": {"dit_finetune_sla": ftc["tc32_sla_fwd"],
                                  "quickstart": qsc["tc32_sla_fwd"]},
        "tc32_shape": ft_fwd["shape"],
        "ms_tc32": ft_fwd["ms"], "plain_ms_tc32": ft_fwd["plain_ms"],
        "bound_ms_tc32": ft_fwd["bound_ms"],
        "bound_by_tc32": ft_fwd["bound_by"],
        "bound_fraction_tc32": ft_fwd["bound_fraction"],
        "ms_fma_at_tc32_shape": ft_fwd["ms_fma"],
        "flex_sparse_branch_fwd_ms_tc32": ft_fwd.get(
            "flex_sparse_branch_fwd_ms"),
        "ctas_per_sm_tc32": {r["head_dim_run"]: r["ctas_per_sm"]
                             for r in fwd7 + [ft_fwd]},
        "ms_tc32_phase7": {r["shape"]: r["ms"] for r in fwd7},
        "max_abs_err_tc32": max(r["max_abs_err"] for r in fwd_tc32),
        "o_l_max_abs_err_tc32": max(r["o_l_err"] for r in fwd_tc32),
        "tc_criterion_all_ok_tc32": all(r["ok"] for r in fwd_tc32),
        "profile_sla_step": ex["finetune"]["runs"]["sla"]["profile"],
        "cases": rows,
    }, {
        "name": "sla_fwd_split_planes", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_fwd_split.cu",
        "replaces": "src/repro/kernels/sla_fwd.py:34",
        "part_of": "sla_fwd's split route: its K/V pre-pass",
        "launches": (main_run["planes_launches"]
                     + pc_launches["planes_launches"] + qsc["planes"]
                     + dspc["planes"] + dsc["planes"]),
        "launches_by_path": {
            "serve": main_run["planes_launches"],
            "serve_plan_cache": pc_launches["planes_launches"],
            "quickstart": qsc["planes"],
            "dit_serve_p38": dspc["planes"],
            "dit_serve_mesh": dsc["planes"]},
        "max_abs_err": planes["max_abs_err"], "ms": planes["ms"],
        "plain_ms": planes["plain_ms"], "bound_ms": planes["bound_ms"],
        "bound_by": planes["bound_by"], "library_ms": None,
        "library": "none: no one PyTorch call cuts f32 into bf16 parts",
        **ran_at("sla_fwd_split_planes"),
        "arch_head_dims": arch_head_dims("wan2_1_1_3b", "lightningdit_1b"),
        "bitwise_vs_twin": planes["bitwise"],
        "bound_fraction": planes["bound_fraction"],
    }]
    d256_keys = ("shape", "dtype", "head_dim", "route", "max_abs_err",
                 "limit", "bitwise_repeat", "live_tiles", "ms", "plain_ms",
                 "bound_ms", "bound_by", "bound_fraction", "ok")
    for name, line in (("sla_bwd_dq", 48), ("sla_bwd_dkv", 76)):
        mine = [r for r in bwd_rows if r["kernel"] == name]
        tc_cases = [r for r in mine if r["route"] == TC_ROUTE]
        tc32_cases = [r for r in mine if r["route"] == TC32_ROUTE]
        ft32 = next(r for r in ex_bwd_rows if r["kernel"] == name)
        wan, tc = wan_bwd[name], wan_tc[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sla_bwd.cu",
            "replaces": f"src/repro/kernels/sla_bwd.py:{line}",
            "launches": (train["launches"][name] + ltc[name] + hyc[name]
                         + edc[name] + vlc[name] + g3tc[name] + mtc[name]
                         + fmc[name] + qsc[name] + ftc[name]),
            "launches_by_path": {"train": train["launches"][name],
                                 "lm_train": ltc[name],
                                 "hybrid_train": hyc[name],
                                 "encdec_train": edc[name],
                                 "vlm_train": vlc[name],
                                 "gemma3_train": g3tc[name],
                                 "lm_train_mesh": mtc[name],
                                 "family_train_mesh": fmc[name],
                                 "quickstart": qsc[name],
                                 "dit_finetune_sla": ftc[name]},
            **ran_at(name),
            "arch_head_dims": arch_head_dims(
                "wan2_1_1_3b", "lightningdit_1b", LM_ARCH, HY_ARCH, ED_ARCH,
                VL_ARCH, G3_ARCH),
            "d256_cases": [
                {**{k: r[k] for k in d256_keys},
                 **{k: r.get(k) for k in ("library_ms", "library_error")}}
                for r in d256_bwd if r["kernel"] == name],
            "gemma3_train_cases": [{k: r[k] for k in (
                "shape", "head_dim", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_fraction", "max_abs_err",
                "bitwise_repeat", "ok")} for r in g3t_bwd_rows
                if r["kernel"] == name],
            "finetune_cases": [{**{k: r[k] for k in FT_CASE_KEYS},
                                **{k: r[k] for k in FT_FLEX_KEYS if k in r},
                                **{k: r[k] for k in FT_TC32_KEYS if k in r}}
                               for r in ex_bwd_rows if r["kernel"] == name],
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
            "tc_launches": (train["launches"][f"tc_{name}"]
                            + ltc[f"tc_{name}"] + hyc[f"tc_{name}"]
                            + edc[f"tc_{name}"] + vlc[f"tc_{name}"]
                            + g3tc[f"tc_{name}"] + mtc[f"tc_{name}"]
                            + fmc[f"tc_{name}"] + qsc[f"tc_{name}"]
                            + ftc[f"tc_{name}"]),
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
            "d64_cases": [{k: r[k] for k in d64_keys}
                          for r in hy_bwd_rows + ed_bwd_rows + vl_bwd_rows
                          if r["kernel"] == name],
            "route_tc32": TC32_ROUTE,
            "source_tc32": "src/repro_torch/kernels/csrc/sla_bwd_tc32.cu",
            "tc32_launches": ftc[f"tc32_{name}"] + qsc[f"tc32_{name}"],
            "tc32_launches_by_path": {
                "dit_finetune_sla": ftc[f"tc32_{name}"],
                "quickstart": qsc[f"tc32_{name}"]},
            "tc32_shape": ft32["shape"],
            "ms_tc32": ft32["ms"], "plain_ms_tc32": ft32["plain_ms"],
            "bound_ms_tc32": ft32["bound_ms"],
            "bound_by_tc32": ft32["bound_by"],
            "bound_fraction_tc32": ft32["bound_fraction"],
            "library_ms_tc32": ft32["library_ms"],
            "dq_plus_dkv_ms_tc32": ft32["dq_plus_dkv_ms"],
            "ratio_to_library_tc32": ft32["ratio_to_library"],
            "ctas_per_sm_tc32": ft32["ctas_per_sm"],
            "max_abs_err_tc32": max(r["max_abs_err"] for r in tc32_cases),
            "tc_criterion_all_ok_tc32": all(r["ok"] for r in tc32_cases),
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
                     + dgc["sla_decode"] + moec["sla_decode"]
                     + g3c["sla_decode"] + g3pc["sla_decode"]
                     + dnc["sla_decode"] + slpc["sla_decode"]
                     + slsc["sla_decode"] + smpc["sla_decode"]
                     + smsc["sla_decode"]),
        "launches_by_path": {"lm_decode": lm["launches"]["sla_decode"],
                             "lm_paged_decode": pgc["sla_decode"],
                             "lm_unpaged_decode": puc["sla_decode"],
                             "lm_decode_chunk": sum(dchunk["launches"]),
                             "lm_disagg": dgc["sla_decode"],
                             "moe_decode": moec["sla_decode"],
                             "gemma3_decode": g3c["sla_decode"],
                             "gemma3_paged_decode": g3pc["sla_decode"],
                             "danube_decode": dnc["sla_decode"],
                             "lm_serve_sla": slpc["sla_decode"],
                             "lm_serve_sla_mesh": slsc["sla_decode"],
                             "lm_slots_p39": smpc["sla_decode"],
                             "lm_slots_mesh": smsc["sla_decode"]},
        "launches_p39": slm["launches_by_run"],
        **ran_at("sla_decode"),
        "arch_head_dims": arch_head_dims(LM_ARCH, MOE_ARCH, G3_ARCH),
        "d256": {k: d256_dec[0][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fraction", "max_abs_err", "split_width", "ok")},
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
        "partial": {
            "entry": "sla_decode_partial (csrc/sla_decode.cu "
                     "sla_decode_partial_launch: the split kernel without "
                     "its totals' block, the combine kernel's kPartial "
                     "mode)",
            "launches": slsc["sla_decode_partial"]
            + slpc["sla_decode_partial"] + smsc["sla_decode_partial"]
            + smpc["sla_decode_partial"],
            "launches_note": "a one-card mesh is layout A, where kernel 4 "
                             "runs unsplit on the rank's heads; the partial "
                             "mode runs where a mesh of more than one rank "
                             "splits the sequence (held on the CPU over "
                             "gloo) and in phases 37b's and 39c's checks",
            **{key: partial_rows[0][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_fraction", "combine_err", "library_ms")},
            "cases": partial_rows,
            "slot_rows_cases": [r for r in slot_rows if r["c"] == 1],
            "chunk_cases": [r for r in slot_rows if r["c"] > 1]},
    })
    head5 = next(r for r in pg_rows if r["shape"] ==
                 "qwen3-1.7b paged decode B=4" and r["dtype"] == "bf16")
    kernels.append({
        "name": "sla_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sla_decode.cu",
        "replaces": "src/repro/kernels/sla_decode.py:181",
        "launches": (lm["launches"]["sla_decode_paged"]
                     + pgc["sla_decode_paged"] + puc["sla_decode_paged"]
                     + pcc["sla_decode_paged"] + dgc["sla_decode_paged"]
                     + moec["sla_decode_paged"] + g3c["sla_decode_paged"]
                     + g3pc["sla_decode_paged"] + dnc["sla_decode_paged"]
                     + pmr["paged plain"]["sla_decode_paged"]
                     + pmr["paged mesh 1x1"]["sla_decode_paged"]),
        "launches_by_path": {"lm_decode": lm["launches"]["sla_decode_paged"],
                             "lm_paged_decode": pgc["sla_decode_paged"],
                             "lm_unpaged_decode": puc["sla_decode_paged"],
                             "lm_chunked_decode": pcc["sla_decode_paged"],
                             "lm_disagg": dgc["sla_decode_paged"],
                             "moe_decode": moec["sla_decode_paged"],
                             "gemma3_decode": g3c["sla_decode_paged"],
                             "gemma3_paged_decode": g3pc["sla_decode_paged"],
                             "danube_decode": dnc["sla_decode_paged"],
                             "lm_paged_p40": pmr["paged plain"][
                                 "sla_decode_paged"],
                             "lm_paged_mesh": pmr["paged mesh 1x1"][
                                 "sla_decode_paged"]},
        **ran_at("sla_decode_paged"),
        "arch_head_dims": arch_head_dims(LM_ARCH, G3_ARCH),
        "d256": {k: d256_pg[0][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fraction", "max_abs_err", "split_width",
            "bitwise_vs_sla_decode", "ok")},
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
        "partial": {
            "entry": "sla_decode_paged_partial (csrc/sla_decode.cu "
                     "sla_decode_paged_partial_launch: the paged split "
                     "kernel without its totals' block, the combine "
                     "kernel's kPartial mode)",
            "launches": sum(r["sla_decode_paged_partial"]
                            for r in pmr.values()),
            "launches_note": "a one-card mesh is layout A, where kernel 5 "
                             "runs unsplit on the rank's heads; the partial "
                             "mode runs where a mesh of more than one rank "
                             "splits the sequence (held on the CPU over "
                             "gloo) and in phase 40c's checks",
            **{key: pm_rows[0][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_fraction", "combine_err", "bitwise_vs_partial",
                "library_ms")},
            "cases": pm_rows},
    })
    say(f"[31] main path {main_run} | cross-check {cross} | plan cache "
        f"{pcache} | grads {grads} | "
        f"train {train} | train CLI {cli} | lm {lm} | lm cross-check "
        f"{lm_cross} | paged lm {pg} | unpaged mixed {pu} | chunked "
        f"admission {pc} | decode_chunk {dchunk} | disagg {dg} | lm train "
        f"{lt} | moe serve {moe} | hybrid {hy} | encdec {ed} | ssm {rw} | "
        f"gemma3 serve {g3} | danube serve {dn} | vlm train {vl} | gemma3 "
        f"train {g3t} | lm train mesh {mt} | family train mesh {fm} | "
        f"lm serve mesh {sm} | family serve mesh {sf} | examples {ex} | "
        f"lm serve sla mesh {sls} | slots mesh {slm} | paged mesh {pm} | "
        f"dit serve mesh "
        f"{dsm} | total "
        f"{time.time() - t_all:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
