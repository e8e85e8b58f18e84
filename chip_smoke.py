#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: builds the kernels,
drives the port's main paths at full size, and checks them.

    python3 chip_smoke.py [--seed S] [--insert-batches B]

Phases, in order; any mismatch raises and the script exits non-zero:

1. Edge cases, on the card: each kernel and its plain version in
   kernels/ref.py must agree on small inputs. amo_apply, fused_apply,
   hash_find and hash_insert bit for bit, with masked rows, offsets outside
   the shard, every opcode and a full table; moe_dispatch bit for bit at
   T = 1, at a T that is not a multiple of its block, with every token on
   one expert, with ids outside [0, E), and at (T, E) = (48, 64) and
   (6144, 64); flash_decode within the stated tolerance on a cache of W
   = 321 keys (not a multiple of its key chunk c) at lengths 0, 1, c - 1,
   c, c + 1 (a split boundary and either side), 200 and W, with 1 and 8
   query heads per kv head at d 128 and 16 at d 256, in float32 and
   bfloat16; rg_lru_scan bit for
   bit at S = 1 with a given h0 and at S = 5 (its column kernel), S
   shorter than one ring stage of 32 steps, S not a multiple of a stage,
   D not a multiple of 32 (and not of 4: 4-byte copies), more blocks of
   32 columns than the card has SMs, and h0 = None; flash_attention
   within kernels/ref.py's
   mha_tol in float32 and bfloat16 with 1, 4 and 16 query heads per kv
   head, head dims 16, 64, 128 and 256, S == Skv and end-aligned S < Skv,
   windows 0 and > 0, non-causal, and S and Skv that are not multiples of
   its tiles. The train path's kernels on kernels/lane_cases.py's
   FLASH_BWD_CASES (1, 3 and 16 query heads per kv head; d 64, 128, 256;
   S == Skv and end-aligned S < Skv; windows 0 and shorter than S;
   non-causal; S and Skv off the 32-row tiles; rows without a key), in
   float32 and bfloat16: flash_attention with its lse (the output within
   mha_tol, the lse within LSE_TOL) and flash_attention_bwd (dq, dk, dv
   within kernels/ref.py's flash_bwd_tol, a limit that must also reject
   the plain version with the causal frontier, or the window, one key
   short; the bf16 case over 1,100 keys, whose dK/dV grid splits the 16
   query heads into groups, run twice must give the same bits);
   rg_lru_scan_bwd bit for bit on RG_LRU_BWD_CASES (S = 1 and 5, D off a
   warp and off 4, B > 1, h0 given and None, S inside one ring stage, S
   wrapping its ring and ending mid-stage, S a whole number of stages).
   Then the owner-lane cases of kernels/lane_cases.py, the
   inputs tests/test_torch_cuda.py holds amo_apply and fused_apply to: every
   op on one word (16,384 FAAs, mixed codes with offsets outside [0, L) in
   the chain, a CAS chain), live counts below, at and past the kernels'
   chunk, m = 65,536 with 1.6% live, all rows masked, and fused winners
   with overlapping V = 3 puts and gathers of the words they wrote; and
   its hash_insert cases: every request on one start (one component of
   600), windows wrapping past slot nslots - 1 into those at slot 0,
   components W - 1 and W slots apart, duplicate keys in a component and
   full windows, starts outside [0, nslots), max_probes past nslots,
   shards longer and shorter (clamped) than their records, m = 65,536
   with 1.6% live, live counts past the chunk, all rows masked; and its
   txn_group_apply (B9) cases: a group split into two runs, a failing
   guard after writes to its word, gid outside [0, ngroups), chain flags
   on rows that are not CAS, an all-masked owner, offsets outside [0, L),
   64 groups of 4 rows, 3,500 rows across staging chunks: the kernel on
   the card against its plain version on the CPU, bit for bit.
   Then, kernel and plain version both on the card, bit for bit, the
   moe_dispatch cases of kernels/lane_cases.py (196,608 ids over 64
   experts, every id on one expert across ten tiles, ids outside [0, E)
   at warp and tile edges beside in-range ids of the column they wrap
   onto, T = 0, 1, 48 and either side of its 2,048-id tile, E = 1, 128,
   2,048 with tiles of two rounds, and E past its shared-memory cut-off)
   and its hash_find cases (m not a multiple of 16 with vw 1, 2 and 3, no
   live slot, every slot live, live slots only at index 15 of a 16-slot
   group and at a row's last index, a full table without EMPTY, windows
   wrapping past slot nslots - 1, starts outside [0, nslots), and a
   routed batch at slice shape).
2. The data structures at full size: a distributed hash table of 64 ranks
   x 2**18 slots (val_words 1; a 201 MB window) filled to load 0.25 with
   4,194,304 keys in batches of 1024 keys per rank, then 16 find batches
   of the same size (half present, half absent), on three arms (RDMA fused,
   RDMA unfused, RPC), each on a fresh table; and a hosted queue (host 0,
   capacity 2**20, 2 words a slot) pushed with 256 values per rank for 16
   batches and popped until empty, on the RDMA and RPC arms. Results are
   held against a host oracle. Kernel launch counters are zeroed just
   before this phase and read just after. The drive keeps the inputs of
   the first kernel call of each kernel in each marked batch: the first
   and the last insert batch (a fresh table and one at load 0.25), the
   first find batch and the first queue push and pop, on every arm. Every
   timed batch is in the medians. After each arm's drive, its last insert
   and find, last push and first pop run once more, on a copy of the
   state they started from, traced with torch.profiler: their device busy
   time, idle share and the owner lanes' time (amo_apply's and
   fused_apply's two kernels each) are printed. These re-runs are main
   path batches too, and their launches count.
3. Kernel against plain version on those captured inputs: each kernel and
   its plain version must agree bit for bit. Times of both are taken with
   CUDA events, the kernel's on single calls after an L2 flush; the bound
   counts the bytes these inputs need. For hash_insert, the longest
   component its grouping walks (kernels/lane_cases.py
   insert_components) is printed beside the busiest owner's live count.
4. CPU against GPU at a small size (8 ranks x 4096 slots): the same op
   streams through the port on both devices; every reply and the final
   windows must be equal.
5. Serving deepseek-moe-16b at full width (28 layers, d_model 2048, 16
   heads of 128, 64 routed experts top-6 and 2 shared, vocab 102,400,
   bfloat16, 16.67 B seeded random weights) through
   repro_torch.launch.serve: 8 requests of a 256-token prompt, 64 tokens
   generated, 320 decode steps. Counters are zeroed just before and read
   just after; flash_decode and moe_dispatch must each launch 28 times a
   step. The inputs of each kernel's first call at the first and the last
   step are kept and then held against the plain versions (moe_dispatch
   bit for bit, flash_decode within the tolerance), timed as in phase 3. The
   last PROFILE_STEPS steps are traced with torch.profiler for the device
   time per step by kernel and the device's idle share.
5b. The prefill step (repro_torch.launch.steps.make_prefill_step) of the
   same deepseek-moe-16b (phase 5's caches freed first) on 1 x 32,768
   tokens: the prefill_32k shape with its batch cut from 32 to 1
   (printed). Three prefills as in phase 8: the first keeps the inputs of
   the last call of each kernel (the last layer's moe_dispatch of 196,608
   ids, and its last query chunk of 4,096 rows over 32,768 keys, full
   causal attention with 16 heads of 128), held against the plain
   versions (moe_dispatch bit for bit, flash_attention within mha_tol,
   whose limit must also reject the plain version with the causal
   frontier one key short at that call) and timed as in phase 3; the
   second is timed, with peak memory; the third is traced. In each,
   moe_dispatch must launch 28 times and flash_attention 224 (28 layers x
   8 query chunks), nothing else, and the logits must be finite.
6. CPU against GPU for the model: reduced deepseek-moe-16b in float32,
   the same seeded weights built once and moved, 8 teacher-forced decode
   steps; logits within the stated tolerance, greedy tokens printed.
7. Serving recurrentgemma-9b at full width (38 layers: 26 RG-LRU and 12
   local-attention layers of window 2048, each with an MLP; d_model 4096,
   16 heads of 256, 1 kv head, d_ff 12,288, RG-LRU width 4096, vocab
   256,000, bfloat16, 8.96 B seeded random weights; deepseek-moe-16b is
   freed first) through repro_torch.launch.serve as in phase 5:
   rg_lru_scan must launch 26 times a step and flash_attention never; the
   first and last step's rg_lru_scan inputs are kept and held bit for bit
   against the plain version; the last PROFILE_STEPS steps are traced.
8. The prefill step (repro_torch.launch.steps.make_prefill_step) of
   recurrentgemma-9b at full width on 1 x 32,768 tokens: the prefill_32k
   shape with its batch cut from 32 to 1 (printed). Three prefills: the
   first keeps the inputs of the last call of each kernel (the last query
   chunk of the last local-attention layer, the last RG-LRU layer), which
   are then held against the plain versions (rg_lru_scan bit for bit,
   flash_attention within mha_tol, whose limit must also reject the plain
   version with the window one key short at that call) and timed as in
   phase 3; the second is timed, with peak memory; the third is traced.
   In each, flash_attention must launch 96 times (12 layers x 8 query
   chunks) and rg_lru_scan 26 times, and the logits must be finite.
   Printed, not gated: the last-position logits of a prefill of phase 7's
   8 x 256 prompts against a decode of the same prompts. The plain
   attention evaluates slices of query heads whose f32 scores stay within
   MHA_SCORE_BYTES (heads are independent).
9. CPU against GPU for reduced recurrentgemma-9b in float32 (window 32),
   weights built once and moved, TF32 off: logits of the train-mode
   forward at every position of 48 tokens, and 48 teacher-forced decode
   steps at max_len 48 (the rings wrap), each within LOGITS_TOL; and on
   both devices, decode at each step equal to the forward at that position
   within DECODE_VS_PREFILL_TOL. Then the forward's logits at every
   position of SPLIT_LEN tokens, CPU against GPU within LOGITS_TOL: past
   2 x 1024 tokens chunked_flash splits the queries into chunks that
   read end-aligned S < Skv slices of the keys in place, as the full-width
   prefill does, and flash_attention must launch once a chunk.

10. The paper's component operations (Fig. 3 / Table I) at phase 2's
   size: put, get, fetch-and-add at random words and at one word a rank,
   a single CAS, a persistent CAS (8 rounds, unplanned and planned), the
   fused claim+write, claim+write+publish and fetch-and-op+gather
   descriptors on a window of 64 ranks x 786,432 words, and the AM round
   trip as an RPC insert into a hash table of phase 2's shape; 64 x 1,024
   ops a call, the median of 15 calls (host time, each ending in a
   synchronize) per op. The rows are fitted into a ComponentCosts with
   costmodel.calibrate, as the JAX package's benchmarks/components.py
   `calibrated_costs` does (printed with the two Fig. 3 ratios,
   cas_persistent / cas_single and fad_single / fad).
11. The adaptive chooser, backend="auto", at phase 2's full size, after
   the method of the JAX package's benchmarks/adaptive_bench.py: a hash
   table of 64 ranks x 2**18 slots, batches of 64 x 1,024 distinct keys
   whose owners follow a mix (uniform; zipfian, p(owner r) ∝
   1/(r+1)^1.5; hot, every key on owner 0; inattentive, uniform with the
   `am` arm waiting half of busy_us around each call and `am_pt` paying
   pt_overhead instead, busy_us = 2x the uniform mix's median fused-RDMA
   insert+find pair), 16 batches a mix, each an insert (C_RW) and a find
   (C_R: the inserted keys in even columns, keys never inserted in odd
   ones) from the same empty table, on the four fixed arms and then
   through hashtable.insert / find with no backend argument: an
   AdaptiveEngine with the AM engine, phase 10's calibration,
   explore_every 8 and its EWMAs seeded by 3 reps of each arm. Then the
   same for the hosted queue of phase 2's shape (a push of 64 x 256 items
   and a pop of 256 a rank, from an empty queue), and each arm once more
   through backend="auto" with `force_arm`, on both structures. Printed
   per mix: each fixed arm's median µs per batch, AUTO's (decide()
   included), regret (AUTO / best fixed - 1), the arms chosen, and the
   calibrated model's predict_arm per arm beside the measured µs per op
   with whether their argmins agree. Gates: inserted keys are found with
   their values and no other key is, pops return the pushes in ticket
   order, every AUTO call logs one Decision with scores for all four
   arms, and the launch counts show amo_apply / fused_apply on the
   one-sided arms and hash_find / hash_insert on the AM arms. Regret is
   printed, not gated. Then the hot mix once more with a hot-bucket
   cache on the chooser: per batch an AUTO insert and find from the empty
   table (the cache flushed with it), and the find twice more through the
   cached fused arm, each held to the oracle; printed: AUTO's arms, the
   re-reads' ms and hit rates, cache.stats().
12. The pipelined engine (core/pipeline.py, the async front doors) at
   phase 2's size, after the method of the JAX package's
   benchmarks/pipeline_bench.py: a stream of PIPE_PAIRS pairs (8 of the
   16 of the full stream, a printed cut), each an insert of
   64 x 1,024 keys and a find of as many (the insert's keys in even
   columns, keys never inserted in odd ones), passed as host arrays,
   through `Pipeline(table, depth=d, am_engine=...)` for d in 1, 2, 3 on
   rpc (deferred), rdma_fused, rdma (unfused: fixed probe rounds, so its
   staging reads no device value) and AUTO (phase 10's fit, EWMAs seeded
   by 3 reps of each arm, measure=False); AUTO once more with auto_depth (cap
   3); the hosted queue (pushes of 64 x 256 and pops of 256 a rank) at
   depths 1 and 2 on its two arms. After every submit the host busy-waits
   busy_us, the median submit time of a depth-1 pass with no wait. Gates:
   depth 1 equals the synchronous front doors bit for bit; every depth,
   and a pass forced in reverse order, equals depth 1 (outputs and final
   window); every pass launches the same kernels; the slot-tagged phase
   log of each depth is depth 1's with slot = seq % depth; inserted keys
   are found and pops return the pushes in ticket order; and the same
   streams at phase 4's small size give equal outputs, windows, dispatch
   points and phase logs on the CPU and on the card. Printed: the median
   stream time per depth (5 interleaved passes) and the depth-2 / depth-1
   speedup, the device idle share of one traced pass per depth, the
   implicit host syncs per submit (torch.cuda.set_sync_debug_mode) by
   file:line, and the service latency of a deferred rpc find at busy
   windows of 0, 1 and 4 x busy_us.
13. The fault plane (core/faults.py) at phase 2's size: insert + find
   batches (CHAOS_BATCHES of CHAOS_FULL, a printed cut: the plane
   simulates delivery on the host) on rdma, rdma_fused, am and AUTO (round
   robin), and queue push + pop batches on its rdma and am arms, under the
   three seeded schedules of tests/test_faults.py (drops; duplicates;
   drops, duplicates, delays and owner 1 dead until round 3). Gates:
   every result and final window equals the fault-free run of the same
   stream bit for bit (AUTO: results and every final read) and the host
   oracle; under an owner dead forever, AUTO fails its rows of the first
   insert over to the one-sided lane (fused_apply beside hash_insert),
   quarantines it, and runs the next insert one-sided (fused_apply, no
   hash_insert); a depth-2 pipelined stream under wire faults and a queue
   stalled for 2 rounds equals its fault-free run; a queue stalled forever
   raises RemoteTimeout at Handle.result(timeout=8), twice; a pipeline
   left on an exception fails its stranded handle and runs it never; and
   a small pipelined chaos stream gives the same replies, windows and
   plane statistics on the CPU and on the card. The arms include
   "cached" (the fused arm with a hot-bucket cache, its finds read twice,
   the second from the cache), and TXN_CHAOS_BATCHES batches of phase
   15's txn stream run on rdma_fused and am under each schedule, equal to
   their fault-free runs and their serial replays. Printed: plan.stats()
   and the median time per batch pair (per txn batch) under each schedule
   beside the fault-free time, per arm, and the cached arm's
   cache.stats().
14. The hot-bucket cache (core/cache.py) on phase 2's table (64 ranks x
   2**18 slots, filled with its 4,194,304 keys through the RPC insert),
   after the JAX package's bench_cache: 16 find batches of 64 x 1,024 keys
   drawn zipf(1.1) from the filled keys, an insert batch of fresh keys
   after every 8 finds (about 90% reads), on the fused CR find without a
   cache, the same with a BucketCache(capacity 4096, ways 4, max_probes
   8), and AUTO with a cache. Gates: every find equals the host oracle and
   the uncached run's, the final windows are equal with and without the
   cache, a batch of the 64 hottest present keys found a second time is
   all-hit, launches no kernel and logs only its cache_hit, a depth-2
   pipelined stream of cached finds adds no host sync to the uncached one
   (SyncCounter), and a small stream gives the same outputs, windows and
   cache.stats() on the CPU and the card. Printed: the median ms per find
   batch of each arm, hit rates, cache.stats(), the host ms of lookup and
   drain_fills, AUTO's arms.
15. The transaction engine (core/txn.py) after the JAX package's
   bench_txn: 6 batches, every rank of 64 running one txn of 4 ops a
   batch on words drawn zipf(1.1) from 24 hot words, over a window of
   phase 2's table shape, on rdma, rdma_fused, am, am_pt and auto (priced
   with phase 10's fit). Gates: each batch's committed order replayed
   through serial_apply gives its replies and window bit for bit; B9
   launches on every arm and B1 on the one-sided ones; the last B9 call
   of each arm, kept, equals its plain version bit for bit (timed as in
   phase 3). Then `move` of 64 present keys to fresh ones on phase 14's
   full table and `pop_then_insert` of 64 items from a queue of phase 2's
   capacity (one value word, the table's) into it, each held to a host
   oracle. Printed per arm: µs per txn, abort rate, rounds, saved reads,
   host syncs per round; the composites' times.
16. Training smollm-135m at full width and depth (30 layers, d_model 576,
   9 heads of 64, 3 kv heads, d_ff 1,536, vocab 49,152, bf16, 135 M
   seeded random weights) through repro_torch.launch.steps
   .make_train_step (AdamW, remat per layer) fed by data.SyntheticLM at
   the train_4k shape (seq 4,096, accum 2) with the global batch cut from
   256 to 8, 4 a microbatch (printed): one warm-up step under a Capture
   keeping the first call of flash_attention (with its lse) and of
   flash_attention_bwd, held against the plain versions (B10's limit
   must also reject the causal frontier one key short there) and timed
   as in phase 3; then TRAIN_STEPS timed steps and one traced. Every step
   zeroes the counts before and reads them after: flash_attention must
   launch twice (forward and remat recompute) and flash_attention_bwd once
   for each of min(8, 4096 // 1024) = 4 query chunks of each of the 30
   layers in each microbatch (expected_train_launches), nothing else;
   loss and grad norm finite. The state after the last step is written
   through runtime.AsyncCheckpointer and restored into a fresh model and
   optimizer state, equal bit for bit. Printed: the step's median ms,
   tokens/s, peak memory, the traced step's device busy time, idle share
   and time by kernel, the losses, and the bound (the model's flops over
   the bf16 peak).
17. The same for recurrentgemma-9b at full width with its depth cut from
   38 to the first three layers of its pattern (RG-LRU + MLP twice, local
   attention + MLP; 1.67 B weights; printed with the reason), seq 4,096
   (the 2048 window binds), accum 2 of 1 sequence: also rg_lru_scan twice
   and rg_lru_scan_bwd once a RG-LRU layer a microbatch, their first
   calls held bit for bit, and flash_attention_bwd at d = 256.
18. CPU against GPU for the train step: reduced smollm-135m and
   recurrentgemma-9b in float32, the same seeded weights built once and
   moved, TF32 off, two steps of make_train_step on the same batches:
   loss and grad norm within 1e-5, the weights within 1e-4 (relative, and
   of max(1, each leaf's largest magnitude) absolute); the train kernels
   must launch on the card.

Before the last line it prints the card's name and power limit, the
median time per batch of each data-structure arm and per decode step, the
prefills' and train steps' times, one JSON line with the report, and one
JSON line with
every kernel's launches, error, times and bound. The last line is
{"ok": true, "device": {...}}. It needs one card and exits non-zero where
torch sees none.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the slice at full size
P, NSLOTS, VW, N = 64, 2 ** 18, 1, 1024
TARGET_KEYS = 4_194_304                 # load factor 0.25
FIND_BATCHES = 16
Q_HOST, Q_CAP, Q_VW, Q_N, Q_BATCHES = 0, 2 ** 20, 2, 256, 16
# phase 4
SMALL = dict(P=8, NSLOTS=4096, N=128, BATCHES=3, Q_CAP=4096, Q_N=64)
# phase 5: the serving path at full width, and phase 6 at the reduced size
SERVE = dict(arch="deepseek-moe-16b", batch=8, prompt_len=256, gen_len=64)
MODEL_STEPS = 8
PROFILE_STEPS = 4       # the last decode steps of phase 5, traced
# flash_decode against its plain version: f32 math over the same inputs in
# another order and with an online softmax
DECODE_TOL = dict(o_rtol=1e-4, o_atol=1e-5, m_atol=1e-5, l_rtol=1e-4)
# phase 6: f32 logits of the reduced model, CPU against GPU (TF32 off)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# phases 7-9: recurrentgemma-9b served as in phase 5, its prefill step at
# the prefill_32k shape (configs/base.std_shapes) with the batch cut from
# 32 to 1 (as deepseek-moe-16b's in phase 5b): eager PyTorch holds 3 MLP
# intermediates of 25.8 GB each at batch 32 beside 17.9 GB of weights; and
# the reduced model at phase 9
RGEMMA = "recurrentgemma-9b"
RGEMMA_SERVE = dict(arch=RGEMMA, batch=8, prompt_len=256, gen_len=64)
PREFILL = dict(batch=1, seq_len=32768, shape="prefill_32k", shape_batch=32)
RGEMMA_STEPS = 48
# f32 scores the plain attention evaluates at once (a slice of heads)
MHA_SCORE_BYTES = 2 ** 31
SPLIT_LEN = 2304        # > 2 x 1024: chunked_flash's causal-skip split
# phase 9: the port's decode against its own forward (f32, 38 layers)
DECODE_VS_PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
# phases 16-18: the train path. Phase 16 trains smollm-135m at full width
# and depth at its train_4k shape (configs/base.std_shapes: seq 4,096,
# accum 2) with the global batch cut from 256 to 8, 4 a microbatch (at 256
# the f32 logits alone are 103 GB a microbatch); phase 17
# recurrentgemma-9b at full width with its depth cut from 38 to the first
# three layers of its pattern (at 38 its 8.96 B weights, their f32
# gradient sums and AdamW's two f32 moments need about 125 GB), seq 4,096
# (the 2048 window binds), accum 2 of 1; phase 18 both reduced models in
# f32, CPU against GPU
SMOLLM = "smollm-135m"
SMOLLM_TRAIN = dict(shape="train_4k", seq_len=4096, accum=2, batch=8,
                    shape_batch=256)
RGEMMA_TRAIN = dict(layers=3, seq_len=4096, accum=2, batch=2,
                    shape_batch=256)
TRAIN_STEPS = 4          # timed, after one warm-up step (captured)
# flash_attention_bwd's launch plans printed for each head dim: (B, S, Skv,
# H, Hkv, d) of smollm-135m's first train call (d 64), deepseek-moe-16b's
# heads on a 1,024-row chunk of 4,096 tokens (d 128, not trained here) and
# recurrentgemma-9b's first train call (d 256, keys cut to its window)
BWD_PLAN_SHAPES = (("smollm-135m train", (4, 1024, 4096, 9, 3, 64)),
                   ("deepseek-moe-16b heads", (1, 1024, 4096, 16, 16, 128)),
                   ("recurrentgemma-9b train", (1, 1024, 3071, 16, 1, 256)))
TRAIN_LR = dict(lr=3e-4, warmup=2, total_steps=100)
TRAIN_CHECK = dict(batch=4, seq_len=64, accum=2, steps=2,
                   lr=dict(lr=1e-3, warmup=1, total_steps=4))
# phase 18: loss and grad norm CPU against GPU (f32 sums in other orders);
# the weights within 1e-4 relative and 1e-4 of max(1, the leaf's largest
# magnitude) absolute. AdamW's step lr m / (sqrt(v) + eps) moves a weight
# by about lr whatever its gradient's size, so where a gradient is near
# eps = 1e-8 the two devices' f32 sums can move it by a fraction of lr
# (a zero-initialized norm leaf has a scale of about lr after two steps);
# a gradient of the other sign would move it by 2 lr = 2e-3
TRAIN_CHECK_TOL = dict(loss_rtol=1e-5, weight_rtol=1e-4)
# written before each timed call: > the 50 MB L2, and about 0.3 ms of
# work, so the host has launched the timed call before the card reaches it
L2_FLUSH_BYTES = 2 ** 30

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet
# dense peaks of one H100 SXM at 700 W (data sheet): bf16 tensor cores,
# f32 outside them
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
ARMS = ("rdma_fused", "rdma_unfused", "rpc")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Data, made from the seed with numpy
# ---------------------------------------------------------------------------
def make_keys(seed: int, count: int) -> np.ndarray:
    """`count` distinct non-negative int32 keys: i -> (a*i + b) mod 2**31
    with odd a is a bijection, so distinct indices give distinct keys."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(1, 2 ** 30)) * 2 + 1
    b = int(rng.integers(0, 2 ** 31))
    i = np.arange(count, dtype=np.uint64)
    return ((i * np.uint64(a) + np.uint64(b)) & np.uint64(0x7FFFFFFF)
            ).astype(np.int32)


def val_of(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.uint64)
    return ((k * np.uint64(2654435761) + np.uint64(12345))
            & np.uint64(0x7FFFFFFF)).astype(np.int32)


def find_queries(seed: int, n_present: int, absent: np.ndarray,
                 batches: int, p: int, n: int):
    """Per batch: half the rows name inserted-key indices, half absent
    keys, shuffled. Returns (idx (B, p, n) with -1 for absent, absent-key
    pick (B, p, n))."""
    rng = np.random.default_rng(seed + 1)
    half = p * n // 2
    idx = np.full((batches, p * n), -1, np.int64)
    pick = np.zeros((batches, p * n), np.int32)
    for b in range(batches):
        rows = rng.permutation(p * n)
        idx[b, rows[:half]] = rng.integers(0, n_present, half)
        pick[b, rows[half:]] = absent[b * half:(b + 1) * half]
    return idx.reshape(batches, p, n), pick.reshape(batches, p, n)


# ---------------------------------------------------------------------------
# The main path: hash table and queue arms through the entry points
# ---------------------------------------------------------------------------
def no_mark(tag) -> None:
    pass


def warm_profiler(device) -> None:
    """Start and stop torch.profiler once on a trivial op, so that the
    tracer's start-up does not land in the first traced batch."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize()


def traced(fn, sync):
    """fn() once under torch.profiler, between two synchronizes. Returns
    (profile, wall s). The tracer slows the host, so the drives time their
    batches untraced and trace one more of each operation afterwards, on a
    copy of the state the timed batch started from."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync()
    return prof, time.perf_counter() - t0


def state_copy(s):
    """A hash table or queue with a copy of its window."""
    import dataclasses
    return dataclasses.replace(s, win=dataclasses.replace(
        s.win, data=s.win.data.clone()))


def ht_arm(arm: str, keys, vals, queries, nslots: int, device, sync,
           mark=no_mark, trace: bool = False):
    """Insert every batch, then run every find batch, on a fresh table.
    `mark(tag)` names the first and last insert batch and the first find
    batch (None for the others). With trace, the last insert and the last
    find batch run once more, traced, on copies of the table they started
    from. Returns replies (on the device), the final window, batch times
    and the traces."""
    from repro_torch.core import am, hashtable as ht
    p = keys.shape[1]
    table = ht.make_hashtable(p, nslots, VW, device=device)
    engine = None
    if arm == "rpc":
        engine = am.AMEngine(p)
        ht.build_am_handlers(table, engine)

    def insert(t, b):
        if arm == "rpc":
            return ht.insert_rpc(t, engine, keys[b], vals[b])
        return ht.insert_rdma(t, keys[b], vals[b], fused=arm == "rdma_fused")

    def find(t, b):
        if arm == "rpc":
            return (t, *ht.find_rpc(t, engine, queries[b]))
        return ht.find_rdma(t, queries[b], fused=arm == "rdma_fused")

    ok, probes, found, got, t_ins, t_find = [], [], [], [], [], []
    last, last_find = keys.shape[0] - 1, queries.shape[0] - 1
    for b in range(keys.shape[0]):
        stage = "first" if b == 0 else "last" if b == last else None
        mark(stage and f"ht {arm} insert {stage}")
        if trace and b == last:
            before_last = state_copy(table)
        sync()
        t0 = time.perf_counter()
        table, o, pr = insert(table, b)
        sync()
        t_ins.append(time.perf_counter() - t0)
        ok.append(o)
        probes.append(pr)
    for b in range(queries.shape[0]):
        mark(f"ht {arm} find" if b == 0 else None)
        if trace and b == last_find:
            before_find = state_copy(table)
        sync()
        t0 = time.perf_counter()
        table, f, v = find(table, b)
        sync()
        t_find.append(time.perf_counter() - t0)
        found.append(f)
        got.append(v)
    mark(None)
    traces = {}
    if trace:
        traces["insert"] = traced(lambda: insert(before_last, last), sync)
        traces["find"] = traced(lambda: find(before_find, last_find), sync)
        del before_last, before_find
    import torch
    return dict(ok=torch.stack(ok), probes=torch.stack(probes),
                found=torch.stack(found), vals=torch.stack(got),
                data=table.win.data, t_insert=t_ins, t_find=t_find,
                traces=traces)


def q_arm(arm: str, items, host: int, cap: int, device, sync,
          mark=no_mark, trace: bool = False):
    """Push every batch (C_RW), then pop (C_R) until a pop gets nothing.
    `mark(tag)` names the first push and the first pop batch. With trace,
    the last push and the first pop run once more, traced, on copies of
    the queue they started from."""
    from repro_torch.core import am, queue as dq
    from repro_torch.core.types import Promise
    p, n = items.shape[1], items.shape[2]
    q = dq.make_queue(p, host, cap, Q_VW, device=device)
    engine = None
    if arm == "rpc":
        engine = am.AMEngine(p)
        dq.build_am_handlers(q, engine)

    def push(q, b):
        if arm == "rpc":
            return dq.push_rpc(q, engine, items[b])
        return dq.push_rdma(q, items[b], promise=Promise.CRW)

    def pop(q):
        if arm == "rpc":
            return dq.pop_rpc(q, engine, n)
        return dq.pop_rdma(q, n, promise=Promise.CR)

    pushed, got, popped, t_push, t_pop = [], [], [], [], []
    last = items.shape[0] - 1
    for b in range(items.shape[0]):
        mark(f"queue {arm} push" if b == 0 else None)
        if trace and b == last:
            before_last = state_copy(q)
        sync()
        t0 = time.perf_counter()
        q, ok = push(q, b)
        sync()
        t_push.append(time.perf_counter() - t0)
        pushed.append(ok)
    if trace:
        full = state_copy(q)
    for b in range(items.shape[0] + 2):
        mark(f"queue {arm} pop" if b == 0 else None)
        sync()
        t0 = time.perf_counter()
        q, g, v = pop(q)
        sync()
        t_pop.append(time.perf_counter() - t0)
        got.append(g)
        popped.append(v)
        if not bool(g.any()):
            break
    mark(None)
    traces = {}
    if trace:
        traces["push"] = traced(lambda: push(before_last, last), sync)
        traces["pop"] = traced(lambda: pop(full), sync)
        del before_last, full
    import torch
    return dict(pushed=torch.stack(pushed), got=torch.stack(got),
                popped=torch.stack(popped), data=q.win.data,
                t_push=t_push, t_pop=t_pop, traces=traces)


def queue_items(seed: int, batches: int, p: int, n: int) -> np.ndarray:
    """Item id in word 0 (global push order), a mix of it in word 1."""
    ids = np.arange(batches * p * n, dtype=np.int64) + seed
    mix = ((ids.astype(np.uint64) * np.uint64(0x9E3779B1))
           & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return np.stack([ids.astype(np.int32), mix], -1).reshape(
        batches, p, n, 2)


# ---------------------------------------------------------------------------
# Checks against the host oracle
# ---------------------------------------------------------------------------
def check_ht(res: dict, arm: str, present, idx, pick) -> None:
    ok = res["ok"].cpu().numpy().reshape(-1)
    found = res["found"].cpu().numpy()
    vals = res["vals"].cpu().numpy()[..., 0]
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    want_found = np.where(idx >= 0, ok[np.maximum(idx, 0)], False)
    if not np.array_equal(found, want_found):
        bad = int((found != want_found).sum())
        raise AssertionError(f"{arm}: {bad} finds disagree with the oracle")
    want_vals = np.where(want_found, val_of(qkeys), 0)
    if not np.array_equal(vals, want_vals):
        raise AssertionError(f"{arm}: found values disagree with val_of")


def check_queue(res: dict, arm: str, items: np.ndarray) -> None:
    if not bool(res["pushed"].all()):
        raise AssertionError(f"queue {arm}: a push failed")
    got = res["got"].cpu().numpy()
    popped = res["popped"].cpu().numpy()
    seq = popped[got]                       # (batch, src, slot) order
    flat = items.reshape(-1, Q_VW)
    if seq.shape != flat.shape or not np.array_equal(seq, flat):
        raise AssertionError(f"queue {arm}: pops are not the pushed items "
                             f"in ticket order")
    if bool(got[-1].any()):
        raise AssertionError(f"queue {arm}: not drained")


# ---------------------------------------------------------------------------
# Kernel capture, comparison, timing
# ---------------------------------------------------------------------------
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "amo_apply": ("src/repro_torch/kernels/csrc/owner_lane.cu",
                  "src/repro/kernels/amo_apply.py:161"),
    "fused_apply": ("src/repro_torch/kernels/csrc/owner_lane.cu",
                    "src/repro/kernels/amo_apply.py:292"),
    "hash_find": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                  "src/repro/kernels/hash_probe.py:73"),
    "hash_insert": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                    "src/repro/kernels/hash_probe.py:163"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:81"),
    "moe_dispatch": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                     "src/repro/kernels/moe_dispatch.py:66"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94"),
    "rg_lru_scan": ("src/repro_torch/kernels/csrc/rg_lru.cu",
                    "src/repro/kernels/rg_lru.py:53"),
    # no TPU kernel: the JAX model's custom backward of flash_train (jnp)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/lm.py:138"),
    # no TPU kernel: JAX differentiates the oracle's scan
    "rg_lru_scan_bwd": ("src/repro_torch/kernels/csrc/rg_lru.cu",
                        "src/repro/kernels/ref.py:428"),
    # no TPU counterpart: the JAX package's lane is jnp only (no
    # pallas_call); `replaces` names it
    "txn_group_apply": ("src/repro_torch/kernels/csrc/txn_lane.cu",
                        "src/repro/kernels/ops.py:74"),
}
# the kernels each main path runs (phase 2, phase 5, phase 7; a prefill's
# come from expected_prefill_launches)
DS_KERNELS = ("amo_apply", "fused_apply", "hash_find", "hash_insert")
# with the transactional owner lane (phases 13 and 15)
OWNER_KERNELS = DS_KERNELS + ("txn_group_apply",)
MODEL_KERNELS = ("flash_decode", "moe_dispatch")
RGEMMA_DECODE_KERNELS = ("rg_lru_scan",)
# the train path's kernels (phases 16 and 17)
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")
RGEMMA_TRAIN_KERNELS = TRAIN_KERNELS + ("rg_lru_scan", "rg_lru_scan_bwd")
# the model kernels: their plain versions are timed as the kernels are
# (cold, 10 calls); the data structures' serial walks once
FLOAT_KERNELS = MODEL_KERNELS + RGEMMA_TRAIN_KERNELS
# why a kernel's row has no library time
NO_LIBRARY = {
    "amo_apply": "no single PyTorch call",
    "fused_apply": "no single PyTorch call",
    "hash_find": "no single PyTorch call",
    "hash_insert": "no single PyTorch call",
    "moe_dispatch": "bincount gives counts, not positions",
    "rg_lru_scan": "PyTorch has no eager linear-recurrence scan",
    "rg_lru_scan_bwd": "PyTorch has no eager reverse linear-recurrence "
                       "scan",
    "txn_group_apply": "no TPU counterpart; no single PyTorch call",
}


def wrappers():
    from repro_torch.kernels import (amo_apply as kamo, flash_attention as kfa,
                                     flash_attention_bwd as kfab,
                                     flash_decode as kfd, hash_probe as khp,
                                     moe_dispatch as kmd, rg_lru as krg,
                                     txn_lane as ktx)
    return {"amo_apply": kamo.amo_apply, "fused_apply": kamo.fused_apply,
            "txn_group_apply": ktx.txn_group_apply,
            "hash_find": khp.hash_find, "hash_insert": khp.hash_insert,
            "flash_decode": kfd.flash_decode,
            "moe_dispatch": kmd.moe_dispatch,
            "flash_attention": kfa.flash_attention,
            "flash_attention_bwd": kfab.flash_attention_bwd,
            "rg_lru_scan": krg.rg_lru_scan,
            "rg_lru_scan_bwd": krg.rg_lru_scan_bwd}


def plain_versions():
    from repro_torch.kernels import ref as kref
    return {name: getattr(kref, name) for name in OWNER_KERNELS} | {
        "flash_decode": kref.decode_attention,
        "moe_dispatch": kref.moe_dispatch,
        "flash_attention": plain_mha,
        "flash_attention_bwd": kref.flash_bwd,
        "rg_lru_scan": kref.rg_lru_scan,
        "rg_lru_scan_bwd": kref.rg_lru_scan_bwd}


def plain_mha(q, k, v, return_lse=False, **kw):
    """kernels/ref.py mha (flash_fwd_lse with return_lse), over slices of
    query heads whose f32 scores stay within MHA_SCORE_BYTES, concatenated
    (heads are independent; a slice holds whole groups of query heads
    sharing a kv head, or a divisor of one group)."""
    import torch
    from repro_torch.kernels import ref as kref
    fn = kref.flash_fwd_lse if return_lse else kref.mha
    B, H, S, _ = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    per = max(1, MHA_SCORE_BYTES // (4 * B * S * max(Skv, 1)))
    if per >= H:
        return fn(q, k, v, **kw)
    per = (g * (per // g) if per >= g else
           max(d for d in range(1, per + 1) if g % d == 0))
    outs = []
    for h0 in range(0, H, per):
        kv0, kv1 = h0 // g, (h0 + per - 1) // g + 1
        outs.append(fn(q[:, h0:h0 + per], k[:, kv0:kv1], v[:, kv0:kv1],
                       **kw))
    if return_lse:
        return torch.cat([o for o, _ in outs], 1), torch.cat(
            [lse for _, lse in outs], 1)
    return torch.cat(outs, 1)


def launch_counter():
    """A function returning the launches of each kernel since its last
    call (it reads the wrappers' counters; it resets nothing)."""
    last = {name: fn.launches for name, fn in wrappers().items()}

    def since():
        now = {name: fn.launches for name, fn in wrappers().items()}
        delta = {name: now[name] - last[name] for name in now}
        last.update(now)
        return delta
    return since


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts(names) -> dict:
    """The launches since zero_counts(); raises if a kernel of the path
    never launched."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"{name} never launched on its main path")
    return counts


class Capture:
    """While entered, it sits over the kernels in kernels/ops.py and keeps
    the inputs of the first call (with last=True: the last call) of each
    kernel under each tag that `mark` names (tag None: keeps nothing). It
    launches nothing of its own: every call goes on to the wrapper, which
    counts it. The inputs of flash_attention and flash_decode keep their
    strides (the kernels read views)."""

    def __init__(self, last: bool = False):
        self.tag = None
        self.last = last
        self.calls = {}            # (kernel, tag) -> (args, kwargs)

    def mark(self, tag) -> None:
        self.tag = tag

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops as kops
        self._saved = {name: getattr(kops, name) for name in KERNELS}

        def hook(name, fn):
            fmt = (torch.preserve_format
                   if name in ("flash_decode", "flash_attention",
                               "flash_attention_bwd")
                   else torch.contiguous_format)

            def call(*args, **kw):
                key = (name, self.tag)
                if self.tag is not None and (self.last
                                             or key not in self.calls):
                    self.calls.pop(key, None)
                    self.calls[key] = ([None if a is None
                                        else a.clone(memory_format=fmt)
                                        for a in args], dict(kw))
                return fn(*args, **kw)
            return call

        for name, fn in self._saved.items():
            setattr(kops, name, hook(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops as kops
        for name, fn in self._saved.items():
            setattr(kops, name, fn)
        self.tag = None


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Median ms of one call with the L2 cache flushed before it (writing
    `flush`, larger than L2, which also keeps the card busy while the
    host launches the call)."""
    import torch
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in evs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def max_abs_err(a, b) -> int:
    import torch
    outs = []
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype mismatch {x.shape} {y.shape}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        outs.append(int(d.max()) if d.numel() else 0)
    return max(outs)


def decode_err(got, want, what: str) -> float:
    """flash_decode against its plain version: m, l and o / l within
    DECODE_TOL (raises otherwise). Returns max |o/l - o'/l'|."""
    import torch
    (o, m, l), (o_r, m_r, l_r) = got, want
    t = DECODE_TOL
    try:
        torch.testing.assert_close(m, m_r, rtol=0, atol=t["m_atol"])
        torch.testing.assert_close(l, l_r, rtol=t["l_rtol"], atol=0)
        out = o / l.clamp(min=1e-30)[..., None]
        out_r = o_r / l_r.clamp(min=1e-30)[..., None]
        torch.testing.assert_close(out, out_r, rtol=t["o_rtol"],
                                   atol=t["o_atol"])
    except AssertionError as e:
        raise AssertionError(f"flash_decode at {what}: kernel != plain "
                             f"version: {e}") from None
    return float((out - out_r).abs().max()) if out.numel() else 0.0


# flash_attention's log-sum-exp against the plain version's: f32 sums of
# the same scores in another order (+inf on rows without a key)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


def kernel_err(name: str, got, want, what: str):
    """Bit for bit for the integer kernels, rg_lru_scan and
    rg_lru_scan_bwd; DECODE_TOL for flash_decode, kernels/ref.py's mha_tol
    for flash_attention (LSE_TOL for its lse) and flash_bwd_tol for each
    of flash_attention_bwd's outputs."""
    import torch
    from repro_torch.kernels import ref as kref
    if name == "flash_decode":
        return decode_err(got, want, what)
    if name == "flash_attention" and isinstance(got, tuple):
        try:
            torch.testing.assert_close(got[1], want[1], **LSE_TOL)
        except AssertionError as e:
            raise AssertionError(f"flash_attention lse at {what}: kernel != "
                                 f"plain version: {e}") from None
        return kernel_err(name, got[0], want[0], what)
    if name in ("flash_attention_bwd", "rg_lru_scan_bwd"):
        errs = []
        for part, g, w in zip(("d0", "d1", "d2"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} at {what}: {g.dtype} "
                                     f"{tuple(g.shape)} against {w.dtype} "
                                     f"{tuple(w.shape)}")
            errs.append(float((g.float() - w.float()).abs().max())
                        if g.numel() else 0.0)
            if name == "rg_lru_scan_bwd" and not torch.equal(g, w):
                raise AssertionError(f"rg_lru_scan_bwd at {what}: output "
                                     f"{part} != plain version (max abs err "
                                     f"{errs[-1]})")
            if name == "flash_attention_bwd":
                try:
                    torch.testing.assert_close(g, w, **kref.flash_bwd_tol(w))
                except AssertionError as e:
                    raise AssertionError(f"flash_attention_bwd at {what}: "
                                         f"output {part} != plain version: "
                                         f"{e}") from None
        return max(errs)
    if name in ("flash_attention", "rg_lru_scan"):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} at {what}: {got.dtype} "
                                 f"{tuple(got.shape)} against {want.dtype} "
                                 f"{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max()
                    ) if got.numel() else 0.0
        if name == "rg_lru_scan" and not torch.equal(got, want):
            raise AssertionError(f"rg_lru_scan at {what}: kernel != plain "
                                 f"version (max abs err {err})")
        if name == "flash_attention":
            try:
                torch.testing.assert_close(got, want, **kref.mha_tol(want))
            except AssertionError as e:
                raise AssertionError(f"flash_attention at {what}: kernel != "
                                     f"plain version: {e}") from None
        return err
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} at {what}: kernel != plain version "
                             f"(max abs err {err})")
    return err


def find_probes(table, starts, keys, mask, nslots, rec_w, max_probes=8):
    """Records each live lookup reads before it decides (data-dependent
    bytes of the find bound)."""
    import torch
    P_, L = table.shape
    stop = ~mask
    taken = torch.zeros(starts.shape, dtype=torch.int64,
                        device=table.device)
    for j in range(max_probes):
        s = (starts.to(torch.int64) + j) % nslots
        base = s * rec_w
        state = torch.gather(table, 1, base) & 255
        k = torch.gather(table, 1, base + 1)
        taken += (~stop).to(torch.int64)
        stop = stop | ((state == 2) & (k == keys)) | (state == 0)
    return int(taken.sum())


def live_pairs(args, kw) -> int:
    """flash_attention and its backward: the (query row, key) pairs of one
    head that the end-aligned causal / window mask keeps, times B x H."""
    q, k = args[0], args[1]
    B, H, S, _ = q.shape
    Skv = k.shape[2]
    pos = np.arange(S, dtype=np.int64) + (Skv - S)
    hi = np.minimum(pos, Skv - 1) if kw.get("causal", True) else np.full(
        S, Skv - 1)
    window = kw.get("window", 0)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(S)
    return int(np.clip(hi - lo + 1, 0, None).sum()) * B * H


def bound_flops(name: str, args, kw) -> tuple:
    """(operations the function must do on these inputs, the card's peak
    rate for their type): 4 d per live (q, k) pair and head for
    flash_attention (q . k and p v), 10 d for its backward (q . k again,
    dO . v, and the three products of dv, dk and dq: 2.5 times the
    forward), 2 per element for rg_lru_scan and 3 for its backward; the
    other kernels do next to no arithmetic (0)."""
    if name in ("flash_attention", "flash_attention_bwd"):
        per = 4 if name == "flash_attention" else 10
        return (per * args[0].shape[-1] * live_pairs(args, kw),
                PEAK_FLOPS[str(args[0].dtype)])
    if name in ("rg_lru_scan", "rg_lru_scan_bwd"):
        per = 2 if name == "rg_lru_scan" else 3
        return per * args[0].numel(), PEAK_FLOPS["torch.float32"]
    return 0, PEAK_FLOPS["torch.float32"]


def bound(name: str, args, kw, out) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate."""
    byte_ms = bound_bytes(name, args, kw, out) / HBM_BYTES_PER_S * 1e3
    ops, peak = bound_flops(name, args, kw)
    op_ms = ops / peak * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def bound_bytes(name: str, args, kw, out) -> float:
    """Bytes the function must move on these inputs, each once: every
    output in full. flash_decode reads q, the lengths, and K and V of each
    row's valid prefix only; moe_dispatch reads the ids; flash_attention
    q, K and V (already cut to the chunk's live keys by chunked_flash),
    its backward q, K, V, o, lse and dO, rg_lru_scan a, b and h0 and its
    backward a, h, h0 and dh, in full. Of the owner-lane
    and handler kernels' inputs: the mask in full; of the request inputs
    (descriptors, starts, keys, vals) only the live rows, since a masked
    row is decided by its mask byte; the shard in full where the function
    returns a new one (amo_apply, fused_apply, hash_insert), and for the
    find only the records its live probes read."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    if name == "flash_decode":
        q, k, v, length = args
        B, Hkv, S, d = k.shape
        valid = int(length.to("cpu").clamp(0, S).sum())
        kv = 2 * valid * Hkv * d * k.element_size()
        return kv + nbytes([q, length, *out])
    if name == "moe_dispatch":
        return nbytes([args[0], *out])
    if name in FLOAT_KERNELS:
        outs = list(out) if isinstance(out, tuple) else [out]
        return nbytes([a for a in args if a is not None] + outs)
    mask = args[-1]
    n_live = int(mask.sum())

    def live(t):
        return n_live * (t.numel() // mask.numel()) * t.element_size()
    if name == "hash_find":
        table, starts, keys, mask = args
        probed = find_probes(table, starts, keys, mask, kw["nslots"],
                             kw["rec_w"]) * kw["rec_w"] * 4
        return probed + live(starts) + live(keys) + nbytes([mask, *out])
    shard, requests = args[0], args[1:-1]
    return (nbytes([shard, mask, *out])
            + sum(live(t) for t in requests))


def serial_chain(name: str, args):
    """Live ops at the busiest owner, the length of its list (None for the
    kernels without an owner list): hash_insert walks it serially."""
    if name not in ("amo_apply", "fused_apply", "hash_insert",
                    "txn_group_apply"):
        return None
    return int(args[-1].sum(1).max())


def component_chain(name: str, args, kw):
    """hash_insert: the most requests in one component its kernel walks
    serially (kernels/lane_cases.py insert_components; None for the other
    kernels)."""
    if name != "hash_insert":
        return None
    from repro_torch.kernels import lane_cases
    table, starts, _, _, mask = args
    comps = lane_cases.insert_components(
        starts.cpu().numpy(), mask.cpu().numpy(), L=table.shape[1], **kw)
    return max(map(len, comps), default=0)


def word_chain(name: str, args):
    """Live ops on the busiest word of any owner (fused_apply: in its
    atomic sub-phase), the longest chain the owner lanes keep in order
    (None for the other kernels)."""
    if name not in ("amo_apply", "fused_apply"):
        return None
    import torch
    local, ops, mask = args
    P, L = local.shape
    if not bool(mask.any()):
        return 0
    w = ops[..., 0].to(torch.int64)
    w = torch.where(w < 0, w + L, w).clamp(0, L - 1)
    owner = torch.arange(P, device=w.device)[:, None] * L
    return int(torch.unique((owner + w)[mask], return_counts=True)[1].max())


def library_call(name: str, args, kw):
    """One PyTorch call computing the same function on the same inputs,
    timed as a yardstick and used nowhere in the port (None where there is
    none: NO_LIBRARY says why). flash_decode: scaled_dot_product_attention
    of the one query over the masked cache, normalized output instead of
    the partials; flash_attention: scaled_dot_product_attention with the
    end-aligned causal / window mask; flash_attention_bwd: the backward of
    that call (torch.autograd.grad of its output, the forward run once
    before timing)."""
    import torch
    import torch.nn.functional as F
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, v = args[:3]
        S, Skv = q.shape[2], k.shape[2]
        qpos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
        if kw.get("causal", True):
            mask &= kpos <= qpos
        if kw.get("window", 0) > 0:
            mask &= kpos > qpos - kw["window"]
        gqa = q.shape[1] != k.shape[1]      # else any backend may take it
        if name == "flash_attention":
            return lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=gqa)
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                                 enable_gqa=gqa)
        return lambda: torch.autograd.grad(out, qkv, args[5],
                                           retain_graph=True)
    if name != "flash_decode":
        return None
    q, k, v, length = args
    S = k.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :]
            < length.to(torch.int64)[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True)


def edge_cases(device) -> None:
    """Small inputs with masked rows, offsets outside [0, L) both ways,
    every opcode, CAS chains, aux0 out of range, a full table; expert ids
    at T = 1, T not a multiple of the block, all on one expert, outside
    [0, E), and the serving shapes; decode lengths 0, 1, either side of
    and at a split boundary, and W, g = 1 and 8 (d 128) and 16 (d 256),
    float32 and bfloat16; the RG-LRU scan at S = 1 and 5, S short of and
    off its ring stage, D off its warp and off 4, more column blocks than
    SMs, h0 None; attention over the cases listed below, in float32 and
    bfloat16; and the owner-lane and hash_insert cases of
    kernels/lane_cases.py."""
    import torch
    from repro_torch.kernels import ops as kops, ref as kref
    rng = np.random.default_rng(3)

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    Pe, L, m = 3, 64, 96
    local = t(rng.integers(-4, 4, (Pe, L)))
    off = rng.integers(0, 6, (Pe, m))
    off = np.where(rng.random((Pe, m)) < 0.2,
                   rng.choice([-L - 3, -1, L, L + 9], (Pe, m)), off)
    mask = t(rng.random((Pe, m)) > 0.25, torch.bool)
    ops4 = t(np.stack([off, rng.integers(0, 12, (Pe, m)),
                       rng.integers(-4, 4, (Pe, m)),
                       rng.integers(-4, 4, (Pe, m))], -1))
    cases = [("amo_apply", kops.amo_apply, kref.amo_apply,
              (local, ops4, mask), {})]
    for V, G in ((2, 3), (0, 1)):
        ops = np.concatenate([np.stack([
            off, rng.integers(0, 12, (Pe, m)), rng.integers(-4, 4, (Pe, m)),
            rng.integers(0, 10, (Pe, m)), rng.integers(-3, L + 3, (Pe, m)),
            rng.integers(-5, 5, (Pe, m))], -1),
            rng.integers(0, 99, (Pe, m, V))], -1)
        cases.append(("fused_apply", kops.fused_apply, kref.fused_apply,
                      (local, t(ops), mask), {"reply_width": 1 + G}))
    nslots, rec_w = 16, 4
    for fill in (0.6, 1.0):
        tab = np.zeros((Pe, nslots, rec_w), np.int64)
        st = np.where(rng.random((Pe, nslots)) < fill,
                      rng.choice([1, 2, 2, 2], (Pe, nslots)), 0)
        tab[..., 0] = st + 256 * rng.integers(0, 2, (Pe, nslots)) * (st > 0)
        tab[..., 1] = rng.integers(0, 8, (Pe, nslots))
        tab[..., 2:] = rng.integers(0, 99, (Pe, nslots, 2))
        tab = t(tab.reshape(Pe, -1))
        starts = t(rng.integers(nslots - 4, nslots, (Pe, 40)))
        keys = t(rng.integers(0, 8, (Pe, 40)))
        vals = t(rng.integers(0, 99, (Pe, 40, 2)))
        mk = t(rng.random((Pe, 40)) > 0.2, torch.bool)
        kw = dict(nslots=nslots, rec_w=rec_w, max_probes=8)
        cases.append(("hash_find", kops.hash_find, kref.hash_find,
                      (tab, starts, keys, mk), kw))
        cases.append(("hash_insert", kops.hash_insert, kref.hash_insert,
                      (tab, starts, keys, vals, mk), kw))
    for T, E, kind in ((1, 64, "one token"), (1000, 7, "ragged"),
                       (700, 64, "one expert"), (500, 16, "outside"),
                       (48, 64, "serve"), (6144, 64, "wide")):
        ids = rng.integers(0, E, T)
        if kind == "one expert":
            ids[:] = 5
        if kind == "outside":
            ids = rng.integers(-2 * E - 2, 2 * E + 2, T)
        cases.append(("moe_dispatch", kops.moe_dispatch, kref.moe_dispatch,
                      (t(ids),), {"n_experts": E}))
    # W is not a multiple of the key chunk c; the lengths sit at a split
    # boundary and either side of it, at 0, 1, W and in between
    from repro_torch.kernels.flash_decode import KEY_CHUNK as c
    B, W, Hkv = 7, 321, 2
    for g, d in ((1, 128), (8, 128), (16, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            q = t(rng.normal(size=(B, Hkv * g, d)), torch.float32)
            ck, cv = (t(rng.normal(size=(B, W, Hkv, d)), torch.float32)
                      for _ in range(2))
            args = (q.to(dtype), ck.to(dtype).transpose(1, 2),
                    cv.to(dtype).transpose(1, 2),
                    t([0, 1, c - 1, c, c + 1, 200, W]))
            cases.append(("flash_decode", kops.flash_decode,
                          kref.decode_attention, args, {}))
    for Bs, S, D, given_h0 in ((8, 1, 4096, True), (2, 37, 50, True),
                               (3, 300, 96, False), (1, 1000, 33, True),
                               (3, 5, 64, True), (1, 20, 4096, True),
                               (5, 100, 1000, False)):
        a = t(rng.uniform(0.7, 1.0, (Bs, S, D)), torch.float32)
        b = t(rng.normal(size=(Bs, S, D)), torch.float32)
        h0 = t(rng.normal(size=(Bs, D)), torch.float32) if given_h0 else None
        cases.append(("rg_lru_scan", kops.rg_lru_scan, kref.rg_lru_scan,
                      (a, b, h0), {}))
    # g, d, S, Skv, causal, window: S == Skv and end-aligned S < Skv,
    # ragged tiles, non-causal, rows without a key (S > Skv); d 128 is
    # deepseek-moe-16b's head
    for g, d, S, Skv, causal, window in (
            (1, 16, 64, 64, True, 0), (4, 64, 100, 130, True, 0),
            (16, 256, 70, 150, True, 48), (16, 256, 128, 128, True, 0),
            (4, 256, 200, 200, True, 64), (1, 64, 33, 33, False, 0),
            (4, 16, 65, 97, False, 20), (1, 16, 12, 5, True, 0),
            (1, 128, 130, 130, True, 0), (4, 128, 96, 160, True, 40)):
        Bs, Hkv = 2, 1 if g == 16 else 2
        q = t(rng.normal(size=(Bs, S, Hkv * g, d)), torch.float32)
        k, v = (t(rng.normal(size=(Bs, Skv, Hkv, d)), torch.float32)
                for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            args = tuple(x.to(dtype).transpose(1, 2) for x in (q, k, v))
            cases.append(("flash_attention", kops.flash_attention, kref.mha,
                          args, dict(causal=causal, window=window)))
    # the train path's kernels on kernels/lane_cases.py's cases: B5 with
    # its lse and B10 in float32 and bfloat16, B11 bit for bit
    from repro_torch.kernels import lane_cases as lc
    edge_checks = []     # B10 cases whose limit must reject a key off
    for i, case in enumerate(lc.FLASH_BWD_CASES):
        kw = dict(causal=case[6], window=case[7])
        q, k, v, do = (t(x, torch.float32) for x in lc.flash_bwd_inputs(case))
        for dtype in (torch.float32, torch.bfloat16):
            qkv = tuple(x.to(dtype).transpose(1, 2) for x in (q, k, v))
            cases.append(("flash_attention", kops.flash_attention, plain_mha,
                          qkv, dict(kw, return_lse=True)))
            o, lse = kref.flash_fwd_lse(*qkv, **kw)
            args = qkv + (o, lse, do.to(dtype).transpose(1, 2))
            cases.append(("flash_attention_bwd", kops.flash_attention_bwd,
                          kref.flash_bwd, args, kw))
            if i in (1, 3) and dtype == torch.bfloat16:
                edge_checks.append((args, kw))
    for case in lc.RG_LRU_BWD_CASES:
        a, b, h0, dh = (None if x is None else t(x, torch.float32)
                        for x in lc.rg_lru_bwd_inputs(case))
        cases.append(("rg_lru_scan_bwd", kops.rg_lru_scan_bwd,
                      kref.rg_lru_scan_bwd,
                      (a, kref.rg_lru_scan(a, b, h0), h0, dh), {}))
    for name, kernel, plain, args, kw in cases:
        kernel_err(name, kernel(*args, **kw), plain(*args, **kw),
                   "edge cases")
    # B10's limit must reject a backward whose mask edge is one key off
    # (the frontier of a causal case; the window of a windowed one)
    for args, kw in edge_checks:
        r = bwd_edge_fault_rejected(args, kw, "1")
        log(f"phase 1: the flash_attention_bwd limit rejects the "
            f"{r['edge']} one key short on {r['output']} of "
            f"{tuple(args[0].shape)} {args[0].dtype} (max abs err "
            f"{r['max_abs_err']:.6g}, rtol {r['rtol']:.6g}, atol "
            f"{r['atol']:.6g})")
    # the owner lanes' cases of the card tests: the plain version on the
    # CPU, where its op-by-op loop is quicker
    from repro_torch.kernels import lane_cases
    for label, name, args, kw in (lane_cases.owner_lane_cases()
                                  + lane_cases.txn_group_apply_cases()
                                  + lane_cases.hash_insert_cases()):
        got = getattr(kops, name)(*(t(a, torch.from_numpy(a).dtype)
                                    for a in args), **kw)
        want = getattr(kref, name)(*map(torch.from_numpy, args), **kw)
        kernel_err(name, [g.cpu() for g in got], want, label)
    # the expert dispatch's and the find's cases: both on the card
    for label, name, args, kw in (lane_cases.moe_dispatch_cases()
                                  + lane_cases.hash_find_cases()):
        xs = [t(a, torch.from_numpy(a).dtype) for a in args]
        kernel_err(name, getattr(kops, name)(*xs, **kw),
                   getattr(kref, name)(*xs, **kw), label)


# The call whose numbers stand in a kernel's row of the kernels line: its
# main arm at the highest load the run reaches, or the last decode step
# (every call is listed too).
HEADLINE = {"amo_apply": "ht rdma_unfused insert last",
            "fused_apply": "ht rdma_fused insert last",
            "hash_find": "ht rpc find",
            "hash_insert": "ht rpc insert last",
            "flash_decode": "serve last step",
            "moe_dispatch": "serve last step",
            "flash_attention": "prefill",
            "flash_attention_bwd": "smollm train",
            "rg_lru_scan": "prefill",
            "rg_lru_scan_bwd": "rgemma train",
            "txn_group_apply": "txn rdma_fused"}


def live_count(name: str, args, kw) -> int:
    """What a call works on: live ops (data structures), valid cache rows
    (flash_decode), tokens (moe_dispatch), live (q, k) pairs x heads
    (flash_attention and its backward), (B, S, D) elements (rg_lru_scan
    and its backward)."""
    if name in OWNER_KERNELS:
        return int(args[-1].sum())
    if name == "flash_decode":
        return int(args[3].sum())
    if name in ("flash_attention", "flash_attention_bwd"):
        return live_pairs(args, kw)
    return int(args[0].numel())


def bwd_rates(args, kw, ms: float) -> dict:
    """flash_attention_bwd at one call: the rate of the bound's 10 d flops
    a live pair and head, the rate of the flops the kernels issue (bf16:
    20 d on the tensor cores, S and dP in both passes and dV, dK and dQ
    two products each, P and dS split in hi and lo; 24 d at d = 256, where
    two warps share a key tile's S and dP; f32: 14 d on the CUDA cores)
    and the launch plan (blocks, blocks an SM, shared memory, groups of
    query heads)."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k = args[0], args[1]
    B, H, S, d = q.shape
    pairs = live_pairs(args, kw)
    issued = (14 if q.dtype != torch.bfloat16 else 24 if d == 256 else 20)
    return dict(tflops=10 * d * pairs / (ms * 1e-3) / 1e12,
                issued_tflops=issued * d * pairs / (ms * 1e-3) / 1e12,
                plan=kfab.launch_plan(B, S, k.shape[2], H, k.shape[1], d,
                                      q.dtype, q.device))


def phase_captured(calls: dict, names, phase: int) -> dict:
    """Each captured main-path call: kernel against plain version, both
    timed, and the bound of these inputs. A kernel's ms is the median of
    single calls each after an L2 flush (the main paths find their shards,
    caches and weights cold); warm_ms is the mean of calls back to back;
    read_ms is one torch reduction over as many bytes as the bound counts,
    timed as ms is (the floor this timing shows for moving those bytes).
    A flash_attention call made without its lse is timed with it too
    (lse_ms). Returns the rows of each kernel, one per captured call."""
    import torch
    wrap, plain_fns = wrappers(), plain_versions()
    rows = {name: [] for name in names}
    flush = None
    for (name, tag), (args, kw) in calls.items():
        if name not in names:
            continue
        kernel, plain = wrap[name], plain_fns[name]
        if flush is None:
            flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                device=args[0].device)
        out_k = kernel(*args, **kw)
        torch.cuda.synchronize()
        if name in FLOAT_KERNELS:
            out_p = plain(*args, **kw)
            plain_ms = cuda_ms_cold(lambda: plain(*args, **kw), 10, flush)
        else:                       # the serial walks take seconds: once
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out_p = plain(*args, **kw)
            t1.record()
            torch.cuda.synchronize()
            plain_ms = t0.elapsed_time(t1)
        err = kernel_err(name, out_k, out_p, tag)
        reps = 20 if serial_chain(name, args) is not None else 100
        ms = cuda_ms_cold(lambda: kernel(*args, **kw), reps, flush)
        warm_ms = cuda_ms(lambda: kernel(*args, **kw), reps)
        lse_ms = None
        if name == "flash_attention" and not kw.get("return_lse"):
            lse_ms = cuda_ms_cold(
                lambda: kernel(*args, return_lse=True, **kw), reps, flush)
        lib = library_call(name, args, kw)
        library_ms = None
        if lib is not None:
            lib()
            library_ms = cuda_ms_cold(lib, reps, flush)
        bound_ms, bound_by = bound(name, args, kw, out_k)
        # the same bytes read once by one torch reduction, timed the same
        # way: what this timing method shows for the bound's bytes
        nbytes = int(bound_bytes(name, args, kw, out_k))
        buf = torch.empty(max(1, nbytes // 8), dtype=torch.int64,
                          device=args[0].device)
        read_ms = cuda_ms_cold(lambda: buf.sum(), reps, flush)
        del buf
        shapes = [None if a is None else tuple(a.shape) for a in args]
        live = live_count(name, args, kw)
        extra = {}
        if name == "flash_attention_bwd":
            extra = bwd_rates(args, kw, ms)
        out_rms = (float(out_p.float().square().mean().sqrt())
                   if torch.is_tensor(out_p) and out_p.is_floating_point()
                   and out_p.numel() else None)
        rows[name].append(dict(at=tag, ms=ms, warm_ms=warm_ms, lse_ms=lse_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, read_ms=read_ms,
                               library_ms=library_ms,
                               max_abs_err=err, out_rms=out_rms, live=live,
                               shapes=shapes,
                               serial_chain=serial_chain(name, args),
                               word_chain=word_chain(name, args),
                               component_chain=component_chain(name, args,
                                                               kw), **extra))
        lib_txt = ("" if library_ms is None
                   else f", library {library_ms:.4f} ms") + (
            "" if lse_ms is None else f", with lse {lse_ms:.4f} ms")
        log(f"phase {phase}: {name} == plain at {tag} on {shapes} {kw} "
            f"({live} live): kernel {ms:.4f} ms (back to back "
            f"{warm_ms:.4f}), plain {plain_ms:.1f} ms{lib_txt}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), read of the bound's bytes "
            f"{read_ms:.4f} ms, max err {err}"
            + ("" if rows[name][-1]["word_chain"] is None else
               f", longest word chain {rows[name][-1]['word_chain']} of "
               f"{rows[name][-1]['serial_chain']} live at the busiest owner")
            + ("" if rows[name][-1]["component_chain"] is None else
               f", longest component {rows[name][-1]['component_chain']} "
               f"of {rows[name][-1]['serial_chain']} live at the busiest "
               f"owner")
            + ("" if out_rms is None else f" (output RMS {out_rms:.6g})")
            + ("" if not extra else
               f"; {extra['tflops']:.1f} TFLOP/s of the bound's 10 d flops "
               f"a live pair and head, {extra['issued_tflops']:.1f} of the "
               f"flops issued, launch plan {extra['plan']}"))
        del out_k, out_p
    for name in names:
        if not rows[name]:
            raise AssertionError(f"the main path never called {name}")
    return rows


def kernel_row(name: str, calls: list, launches: dict) -> dict:
    """One entry of the kernels line: the launches on the main paths (in
    all, and by phase: one prefill for phase 8), the headline call's
    numbers (with its output's RMS for the float kernels, the scale of
    its error), the largest error of any call, and every call."""
    source, replaces = KERNELS[name]
    head = next((r for r in calls if r["at"] == HEADLINE[name]), calls[-1])
    if head["at"] != HEADLINE[name]:
        log(f"{name} was not called at {HEADLINE[name]}; its row shows "
            f"{head['at']}")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=sum(launches.values()), launches_by_phase=launches,
        max_abs_err=max(r["max_abs_err"] for r in calls),
        out_rms=head["out_rms"], ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], read_ms=head["read_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        library_note=NO_LIBRARY.get(name), at=head["at"],
        serial_chain=head["serial_chain"], word_chain=head["word_chain"],
        component_chain=head["component_chain"],
        calls=[{k: r[k] for k in ("at", "live", "ms", "warm_ms", "lse_ms",
                                  "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "read_ms",
                                  "max_abs_err", "out_rms",
                                  "serial_chain", "word_chain",
                                  "component_chain", "tflops",
                                  "issued_tflops", "plan") if k in r}
               for r in calls])


# ---------------------------------------------------------------------------
# Phases 2 and 4
# ---------------------------------------------------------------------------
def slice_inputs(seed: int, insert_batches: int, device) -> dict:
    """Phase 2's inputs, made from the seed: the keys inserted (`present`,
    and on the device `keys` with their `vals`), the find batches
    (`queries`: present[idx] where idx >= 0, else the absent key in
    `pick`) and the queue's `items`, as host arrays and device tensors."""
    import torch
    n_keys = insert_batches * P * N
    allkeys = make_keys(seed, n_keys + FIND_BATCHES * P * N // 2)
    present, absent = allkeys[:n_keys], allkeys[n_keys:]
    keys = present.reshape(insert_batches, P, N)
    idx, pick = find_queries(seed, n_keys, absent, FIND_BATCHES, P, N)
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    items = queue_items(seed, Q_BATCHES, P, Q_N)
    return dict(present=present, idx=idx, pick=pick, items=items,
                keys=torch.as_tensor(keys, device=device),
                vals=torch.as_tensor(val_of(keys)[..., None], device=device),
                queries=torch.as_tensor(qkeys, device=device),
                items_dev=torch.as_tensor(items, device=device))


def phase_slice(seed: int, insert_batches: int, device,
                mark=no_mark) -> dict:
    import torch
    sync = torch.cuda.synchronize
    n_keys = insert_batches * P * N
    x = slice_inputs(seed, insert_batches, device)
    present, idx, pick = x["present"], x["idx"], x["pick"]
    k, v, qk = x["keys"], x["vals"], x["queries"]
    report = {}
    res = {}
    warm_profiler(device)
    counts = launch_counter()
    for arm in ARMS:
        r = ht_arm(arm, k, v, qk, NSLOTS, device, sync, mark, trace=True)
        check_ht(r, arm, present, idx, pick)
        failed = int((~r["ok"]).sum())
        log(f"phase 2: hash table {arm}: {n_keys - failed} of {n_keys} "
            f"keys in, {failed} out of probe window; finds match oracle")
        report[arm] = dict(insert_failed=failed,
                           insert_ms=statistics.median(r["t_insert"]) * 1e3,
                           find_ms=statistics.median(r["t_find"]) * 1e3,
                           insert_batches=insert_batches,
                           find_batches=FIND_BATCHES, launches=counts())
        for op in ("insert", "find"):
            report[arm][f"profile_{op}"] = batch_profile(
                *r["traces"][op], report[arm][f"{op}_ms"])
        if arm == "rpc":
            r.pop("data")
        res[arm] = r
    a, b = res["rdma_fused"], res["rdma_unfused"]
    for key in ("ok", "probes", "found", "vals", "data"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"rdma fused != unfused on {key}")
    # RPC places keys serially per request, RDMA probe-phase by probe-phase
    # across the batch: the tables differ, and so may the few keys whose
    # probe window fills up; every other visible result must agree.
    both = (a["ok"] == res["rpc"]["ok"]).all()
    differ = int((a["ok"] != res["rpc"]["ok"]).sum())
    same_q = torch.equal(a["found"], res["rpc"]["found"]) and torch.equal(
        a["vals"], res["rpc"]["vals"])
    if bool(both) and not same_q:
        raise AssertionError("rdma and rpc finds differ on equal tables")
    ok_a = a["ok"].reshape(-1).cpu().numpy()
    ok_r = res["rpc"]["ok"].reshape(-1).cpu().numpy()
    agree = np.where(idx >= 0, ok_a[np.maximum(idx, 0)]
                     == ok_r[np.maximum(idx, 0)], True)
    fa, fr = a["found"].cpu().numpy(), res["rpc"]["found"].cpu().numpy()
    va, vr = a["vals"].cpu().numpy(), res["rpc"]["vals"].cpu().numpy()
    if not (np.array_equal(fa[agree], fr[agree])
            and np.array_equal(va[agree], vr[agree])):
        raise AssertionError("rdma and rpc finds differ on agreed keys")
    log(f"phase 2: rdma fused == unfused bit for bit (replies and window); "
        f"rpc agrees on every find of a key both arms hold "
        f"({differ} keys in one arm's probe window only)")
    report["rdma_vs_rpc_insert_differ"] = differ
    del res, a, b
    items, it = x["items"], x["items_dev"]
    for arm in ("rdma", "rpc"):
        r = q_arm(arm, it, Q_HOST, Q_CAP, device, sync, mark, trace=True)
        check_queue(r, arm, items)
        log(f"phase 2: queue {arm}: {items.shape[0] * P * Q_N} pushed and "
            f"popped in ticket order")
        rq = report[f"queue_{arm}"] = dict(
            push_ms=statistics.median(r["t_push"]) * 1e3,
            pop_ms=statistics.median(r["t_pop"][:-1]) * 1e3,
            push_batches=len(r["t_push"]), pop_batches=len(r["t_pop"]),
            launches=counts())
        for op in ("push", "pop"):
            rq[f"profile_{op}"] = batch_profile(*r["traces"][op],
                                                rq[f"{op}_ms"])
    return report


def run_small(device, sync, seed: int) -> list:
    """The phase-3 streams at the small size; returns every reply and
    final window as host arrays."""
    from repro_torch.core.types import Promise
    from repro_torch.core import hashtable as ht
    import torch
    s = SMALL
    n_keys = s["BATCHES"] * s["P"] * s["N"]
    allkeys = make_keys(seed + 3, n_keys + s["P"] * s["N"] // 2)
    present, absent = allkeys[:n_keys], allkeys[n_keys:]
    keys = present.reshape(s["BATCHES"], s["P"], s["N"])
    idx, pick = find_queries(seed + 3, n_keys, absent, 1, s["P"], s["N"])
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    k = torch.as_tensor(keys, device=device)
    v = torch.as_tensor(val_of(keys)[..., None], device=device)
    qk = torch.as_tensor(qkeys, device=device)
    out = []
    for arm in ARMS:
        r = ht_arm(arm, k, v, qk, s["NSLOTS"], device, sync)
        out += [r[x] for x in ("ok", "probes", "found", "vals", "data")]
    for fused in (True, False):       # the C_RW find and the C_W insert
        table = ht.make_hashtable(s["P"], s["NSLOTS"], VW, device=device)
        table, ok, pr = ht.insert_rdma(table, k[0], v[0], promise=Promise.CW,
                                       fused=fused)
        table, f, vv = ht.find_rdma(table, qk[0], promise=Promise.CRW,
                                    fused=fused)
        out += [ok, pr, f, vv, table.win.data]
    items = torch.as_tensor(queue_items(seed, 3, s["P"], s["Q_N"]),
                            device=device)
    for arm in ("rdma", "rpc"):
        r = q_arm(arm, items, 1, s["Q_CAP"], device, sync)
        out += [r[x] for x in ("pushed", "got", "popped", "data")]
    return [x.cpu().numpy() for x in out]


def phase_cpu_vs_gpu(seed: int, device) -> int:
    import torch
    gpu = run_small(device, torch.cuda.synchronize, seed)
    cpu = run_small("cpu", lambda: None, seed)
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if g.shape != c.shape or not np.array_equal(g, c):
            raise AssertionError(f"phase 4: output {i} differs CPU vs GPU")
    return len(gpu)


# ---------------------------------------------------------------------------
# Phases 10 and 11: the cost model calibrated on the card, and the adaptive
# chooser (backend="auto") against every fixed arm
# ---------------------------------------------------------------------------
COMPONENT_ROWS = ("put", "get", "fad", "fad_single", "cas_single",
                  "cas_persistent", "cas_persistent_planned", "cas_put",
                  "cas_put_pub", "fao_get", "am_rt")
COMPONENT_ITERS, COMPONENT_WARMUP = 15, 3
AUTO_ARMS = ("rdma", "rdma_fused", "am", "am_pt")
AUTO_MIXES = ("uniform", "zipfian", "hot", "inattentive")
AUTO_BATCHES = 16
AUTO_SEED_REPS = 3          # reps per arm that seed the chooser's EWMAs
AUTO_EXPLORE_EVERY = 8


def component_rows(seed: int, device, sync, p: int = P, n: int = N,
                   nslots: int = NSLOTS, iters: int = COMPONENT_ITERS
                   ) -> dict:
    """Phase 10: median host µs per op of one call of each component
    operation (the rows of the JAX package's benchmarks/components.py,
    copied here), p x n ops a call on a window of p ranks x nslots x 3
    words, each call ending in a synchronize."""
    import torch
    from repro_torch.core import am, hashtable as ht, routing, window
    from repro_torch.core.types import AmoKind
    local = nslots * (2 + VW)
    rng = np.random.default_rng(seed)
    dst = torch.as_tensor(rng.integers(0, p, (p, n)), dtype=torch.int32,
                          device=device)
    off = torch.as_tensor(rng.integers(0, local, (p, n)), dtype=torch.int32,
                          device=device)
    win = window.make_window(p, local, device=device)
    zero_off = torch.zeros_like(off)
    ones = torch.ones((p, n, 1), dtype=torch.int32, device=device)
    vals2 = torch.ones((p, n, 2), dtype=torch.int32, device=device)

    def persistent(w, plan):
        # poll until success: swap cur -> cur + 1, retry on conflict
        cur = window.rdma_get(w, dst, zero_off, width=1, plan=plan)[..., 0]
        pending = torch.ones((p, n), dtype=torch.bool, device=device)
        for _ in range(8):
            old, w = window.rdma_cas(w, dst, zero_off, cur, cur + 1,
                                     valid=pending, plan=plan)
            pending = pending & ~(old == cur)
            cur = old
        return w

    table = ht.make_hashtable(p, nslots, VW, device=device)
    engine = am.AMEngine(p)
    ht.build_am_handlers(table, engine)
    keys = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        1, 1 << 20, (p, n)), dtype=torch.int32, device=device)
    calls = {
        "put": lambda: window.rdma_put(win, dst, off, ones),
        "get": lambda: window.rdma_get(win, dst, off, width=1),
        "fad": lambda: window.rdma_fao(win, dst, off, 1, AmoKind.FAA),
        "fad_single": lambda: window.rdma_fao(win, dst, zero_off, 1,
                                              AmoKind.FAA),
        "cas_single": lambda: window.rdma_cas(win, dst, off, 0, 1),
        "cas_persistent": lambda: persistent(win, None),
        "cas_persistent_planned": lambda: persistent(
            win, routing.make_plan(dst, cap=n)),
        "cas_put": lambda: window.rdma_cas_put(win, dst, off, 0, 1, off + 1,
                                               vals2),
        "cas_put_pub": lambda: window.rdma_cas_put_publish(
            win, dst, off, 0, 1, off + 1, vals2, 3),
        "fao_get": lambda: window.rdma_fao_get(win, dst, off, 1, AmoKind.FAA,
                                               off, 3),
        "am_rt": lambda: ht.insert_rpc(table, engine, keys, keys[..., None]),
    }
    rows = {}
    for name in COMPONENT_ROWS:
        for _ in range(COMPONENT_WARMUP):
            calls[name]()
            sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            calls[name]()
            sync()
            times.append(time.perf_counter() - t0)
        rows[name] = statistics.median(times) / (p * n) * 1e6
    return rows


def calibrated_costs(rows: dict):
    """The JAX package's benchmarks/components.py `calibrated_costs`: the
    rows as the model's components, handler time folded into am_rt."""
    from repro_torch.core import costmodel as cm
    return cm.calibrate({
        "W": rows["put"], "R": rows["get"], "A_cas": rows["cas_single"],
        "A_fao": rows["fad"], "am_rt": rows["am_rt"],
        "A_cas_put": rows.get("cas_put"),
        "A_cas_put_pub": rows.get("cas_put_pub"),
        "A_fao_get": rows.get("fao_get"),
        "handler": 0.0,
    })


def owner_targets(p: int, n: int, mix: str, rng) -> np.ndarray:
    """(p, n) target owner per op, as the JAX package's
    benchmarks/common.py: uniform; zipfian, p(owner r) ∝ 1/(r+1)^1.5;
    hot, every op to owner 0 (the inattentive mix is uniform)."""
    if mix in ("uniform", "inattentive"):
        return rng.integers(0, p, (p, n))
    if mix == "zipfian":
        probs = 1.0 / np.arange(1, p + 1) ** 1.5
        probs /= probs.sum()
        return rng.choice(p, size=(p, n), p=probs)
    if mix == "hot":
        return np.zeros((p, n), np.int64)
    raise ValueError(f"unknown mix {mix!r}")


def _scramble26(i: np.ndarray) -> np.ndarray:
    """A bijection of [0, 2**26): odd multiplies and xorshifts."""
    m = np.uint64(2 ** 26 - 1)
    x = i.astype(np.uint64) & m
    for c in (0x2545F491, 0x9E3779B1):
        x = (x * np.uint64(c)) & m
        x ^= x >> np.uint64(13)
    return x


def _unmix(h: np.ndarray) -> np.ndarray:
    """The inverse of the hash table's 32-bit mix (hashtable.hash_mix_np)."""
    k = h.astype(np.uint32)
    k = k ^ (k >> np.uint32(16))
    k = k * np.uint32(pow(0xC2B2AE35, -1, 2 ** 32))
    k = k ^ (k >> np.uint32(13)) ^ (k >> np.uint32(26))
    k = k * np.uint32(pow(0x85EBCA6B, -1, 2 ** 32))
    return k ^ (k >> np.uint32(16))


def keys_for_owners(targets: np.ndarray, p: int, first: int) -> np.ndarray:
    """Distinct int32 keys, key i of `targets` owned by targets[i]: the
    mix value owner + p * j for j the scrambled index first + i (distinct
    indices give distinct keys), mapped back through the inverse mix."""
    i = np.arange(targets.size, dtype=np.int64) + first
    h = (targets.reshape(-1).astype(np.uint64)
         + np.uint64(p) * _scramble26(i))
    return _unmix(h).view(np.int32).reshape(targets.shape)


def auto_stream(seed: int, mix: str, p: int, n: int, batches: int) -> list:
    """Per batch: (insert keys, find keys, present mask of the find), the
    find holding the inserted key in even columns and a key never
    inserted, of the same owner, in odd columns; keys distinct across the
    whole stream."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(batches):
        targets = owner_targets(p, n, mix, rng)
        keys = keys_for_owners(targets, p, 2 * b * p * n)
        absent = keys_for_owners(targets, p, (2 * b + 1) * p * n)
        present = np.zeros((p, n), bool)
        present[:, ::2] = True
        out.append((keys, np.where(present, keys, absent), present))
    return out


def busy_wait(us: float) -> None:
    """Spin for `us` microseconds: the inattentive owner's compute."""
    t_end = time.perf_counter() + us * 1e-6
    while time.perf_counter() < t_end:
        pass


class Accounted:
    """Host µs of a call ending in a synchronize, as the JAX package's
    adaptive_bench accounts it: the `am` arm also waits half of the
    owner's busy time, `am_pt` pays the progress-thread factor instead."""

    def __init__(self, sync, busy_us: float, pt_overhead: float):
        self.sync, self.busy, self.pt = sync, busy_us, pt_overhead

    def __call__(self, arm: str, fn):
        """(accounted µs, fn()) for a fixed arm."""
        t0 = time.perf_counter()
        if arm == "am" and self.busy:
            busy_wait(self.busy / 2.0)
        out = fn()
        self.sync()
        us = (time.perf_counter() - t0) * 1e6
        return (us * self.pt if arm == "am_pt" else us), out

    def auto(self, chooser, spent: list, fn):
        """(accounted µs, decision, fn()) for one front-door call with the
        default backend: the accounting of the arm the chooser took, plus
        the time its decide() took (in `spent`, see timed_decide), which
        is charged but not observed; the chooser observes the rest, as
        adaptive_bench does."""
        n_spent = len(spent)
        t0 = time.perf_counter()
        out = fn()
        dec = chooser.last_decision
        if dec.arm == "am" and self.busy:
            busy_wait(self.busy / 2.0)
        self.sync()
        decide_us = sum(spent[n_spent:])
        us = (time.perf_counter() - t0) * 1e6 - decide_us
        if dec.arm == "am_pt":
            us *= self.pt
        chooser.observe(dec, us / dec.batch_ops)
        return us + decide_us, dec, out


def timed_decide(chooser) -> list:
    """Wrap chooser.decide to record the µs of each call (returned list)."""
    spent = []
    decide = chooser.decide

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        dec = decide(*a, **kw)
        spent.append((time.perf_counter() - t0) * 1e6)
        return dec
    chooser.decide = wrapped
    return spent


def check_auto_ht(what: str, ok, found, got, keys, fkeys, present) -> None:
    """Every key whose insert returned ok is found with val_of(key); keys
    never inserted, and keys whose insert failed, are not found."""
    ok, found = ok.cpu().numpy(), found.cpu().numpy()
    got = got.cpu().numpy()[..., 0]
    want = present & ok
    if not np.array_equal(found, want):
        raise AssertionError(f"phase 11: {what}: {int((found != want).sum())}"
                             f" finds disagree with the inserts")
    if not np.array_equal(got, np.where(want, val_of(fkeys), 0)):
        raise AssertionError(f"phase 11: {what}: found values differ")


def check_queue_batch(what: str, ok, got, vals, items: np.ndarray) -> None:
    """Every push succeeded and the pops return them in ticket order."""
    got, vals = got.cpu().numpy(), vals.cpu().numpy()
    if not (bool(ok.all()) and got.all() and np.array_equal(
            vals[got], items.reshape(-1, Q_VW))):
        raise AssertionError(f"phase 11: queue {what}: pops are not the "
                             f"pushes in ticket order")


def check_logged(chooser, n_log: int, decs, what: str) -> None:
    if len(chooser.log) != n_log + len(decs) or any(
            set(d.scores) != set(AUTO_ARMS) for d in decs):
        raise AssertionError(f"phase 11: {what}: a call did not log one "
                             f"Decision with scores for the four arms")


def add_launches(arm_launches: dict, key: str, delta: dict) -> None:
    """Add the nonzero launch counts of `delta` to arm_launches[key]."""
    tot = arm_launches.setdefault(key, {})
    for k, v in delta.items():
        if v:
            tot[k] = tot.get(k, 0) + v


class Stream:
    """One stream of phase 11: per batch the four fixed arms, then AUTO
    (an AdaptiveEngine with the AM engine, the calibrated `params` and
    explore_every 8), each a pair of calls (insert + find, or push + pop)
    from the same empty state. `fixed_pair(arm, b)` and `auto_pair(b)`
    return (µs, µs, results...); the launches of each pair go to
    arm_launches under `prefix` + the arm."""

    def __init__(self, chooser, acc, counts, arm_launches, prefix: str):
        self.chooser, self.acc, self.counts = chooser, acc, counts
        self.arm_launches, self.prefix = arm_launches, prefix
        self.spent = None
        self.fixed = {a: ([], []) for a in AUTO_ARMS}
        self.auto, self.chosen = [], ({}, {})

    def seed(self, ops_of, fixed_pair) -> None:
        """One untimed pair of each arm (warm-up), then the chooser's EWMAs
        seeded with the median of AUTO_SEED_REPS accounted reps of each
        arm on the first batch, as adaptive_bench does. ops_of: the
        (DSOp, ops) of the pair's two calls."""
        from repro_torch.core.adaptive import Decision
        from repro_torch.core.types import Promise
        for arm in AUTO_ARMS:
            fixed_pair(arm, 0)
        for arm in AUTO_ARMS:
            reps = [fixed_pair(arm, 0)[:2] for _ in range(AUTO_SEED_REPS)]
            for idx, (op, ops) in enumerate(ops_of):
                dec = Decision(op=op, promise=Promise.CRW, arm=arm,
                               skew=1.0, scores={}, source="calibration",
                               batch_ops=ops)
                self.chooser.observe(
                    dec, float(np.median([r[idx] for r in reps])) / ops)
        self.counts()
        self.spent = timed_decide(self.chooser)

    def batch(self, b: int, fixed_pair, auto_pair, check) -> None:
        for arm in AUTO_ARMS:
            out = fixed_pair(arm, b)
            add_launches(self.arm_launches, self.prefix + arm, self.counts())
            check(arm, *out[2:])
            self.fixed[arm][0].append(out[0])
            self.fixed[arm][1].append(out[1])
        n_log = len(self.chooser.log)
        decs, out = auto_pair(b)
        delta = self.counts()
        if decs[0].arm == decs[1].arm:
            add_launches(self.arm_launches,
                         f"{self.prefix}auto {decs[0].arm}", delta)
        check_logged(self.chooser, n_log, decs, self.prefix + "auto")
        check("auto", *out[2:])
        self.auto.append(out[0] + out[1])
        for chosen, d in zip(self.chosen, decs):
            chosen[d.arm] = chosen.get(d.arm, 0) + 1

    def report(self, ops: int, ops_of, mstats, params) -> dict:
        """Medians of µs per batch; regret = AUTO / best fixed - 1; the
        arms chosen; the model beside the measured µs per op."""
        pairs = {a: [x + y for x, y in zip(*v)]
                 for a, v in self.fixed.items()}
        med = {a: statistics.median(v) for a, v in pairs.items()}
        best = min(med, key=med.get)
        auto = statistics.median(self.auto)
        return dict(
            fixed_us=med, best_fixed=best, auto_us=auto,
            regret=auto / med[best] - 1.0, ops=ops,
            chosen={name: c for (name, _, _), c in zip(ops_of, self.chosen)},
            decide_us_per_batch=sum(self.spent) / len(self.auto),
            sources=sorted({d.source for d in self.chooser.log}),
            model={name: model_vs_measured(
                op, promise, mstats, params,
                {a: statistics.median(self.fixed[a][idx]) / ops
                 for a in AUTO_ARMS})
                for idx, (name, op, promise) in enumerate(ops_of)})


def model_vs_measured(op, promise, stats, params, measured: dict) -> dict:
    """The calibrated model's predict_arm per arm beside the measured µs
    per op, and whether their argmins agree (the paper's §VI question;
    the model's ties go as the chooser breaks them)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.adaptive import AdaptiveEngine
    model = {a: cm.predict_arm(op, promise, a, stats, params)
             for a in AUTO_ARMS}
    rank = AdaptiveEngine._ARM_RANK
    m_arg = min(model, key=lambda a: (model[a], rank[a]))
    x_arg = min(measured, key=measured.get)
    return dict(model_us_per_op=model, measured_us_per_op=measured,
                model_argmin=m_arg, measured_argmin=x_arg,
                agree=m_arg == x_arg)


def phase_auto_ht(seed: int, device, sync, params, counts, arm_launches,
                  p: int = P, n: int = N, nslots: int = NSLOTS,
                  batches: int = AUTO_BATCHES) -> dict:
    """Phase 11's hash-table mixes: per batch, the four fixed arms and
    AUTO back to back, each an insert (C_RW) and a find (C_R) from the
    same empty table, through the front doors. `counts()` gives the
    kernel launches since its last call."""
    import torch
    from repro_torch.core import adaptive as ad, am, hashtable as ht
    from repro_torch.core.costmodel import DSOp
    from repro_torch.core.types import OpStats, Promise
    ops = p * n
    t0 = ht.make_hashtable(p, nslots, VW, device=device)
    engine = am.AMEngine(p)
    ht.build_am_handlers(t0, engine)
    ops_of = (("insert", DSOp.HT_INSERT, Promise.CRW),
              ("find", DSOp.HT_FIND, Promise.CR))
    report, busy_ref = {}, 0.0
    for mi, mix in enumerate(AUTO_MIXES):
        busy = busy_ref if mix == "inattentive" else 0.0
        acc = Accounted(sync, busy, params.pt_overhead)
        stats = OpStats(target_busy_us=busy)
        batch_np = auto_stream(seed + 100 + mi, mix, p, n, batches)
        batch = [[torch.as_tensor(x, device=device)
                  for x in (k, val_of(k)[..., None], f)]
                 for k, f, _ in batch_np]

        def fixed_pair(arm, b):
            keys, vals, fkeys = batch[b]
            if arm in ("am", "am_pt"):
                kw = dict(backend="rpc", engine=engine)
            else:
                kw = dict(backend="rdma", fused=arm == "rdma_fused")
            us_i, (t, ok, _) = acc(arm, lambda: ht.insert(
                t0, keys, vals, promise=Promise.CRW, **kw))
            us_f, (_, found, got) = acc(arm, lambda: ht.find(
                t, fkeys, promise=Promise.CR, **kw))
            return us_i, us_f, ok, found, got, b

        def auto_pair(b):
            keys, vals, fkeys = batch[b]
            us_i, dec_i, (t, ok, _) = acc.auto(
                chooser, s.spent, lambda: ht.insert(
                    t0, keys, vals, promise=Promise.CRW, engine=engine,
                    adaptive=chooser, stats=stats))
            us_f, dec_f, (_, found, got) = acc.auto(
                chooser, s.spent, lambda: ht.find(
                    t, fkeys, promise=Promise.CR, engine=engine,
                    adaptive=chooser, stats=stats))
            return (dec_i, dec_f), (us_i, us_f, ok, found, got, b)

        def check(arm, ok, found, got, b):
            k, f, present = batch_np[b]
            check_auto_ht(f"{mix} {arm}", ok, found, got, k, f, present)

        chooser = ad.AdaptiveEngine(p, am_engine=engine, params=params,
                                    explore_every=AUTO_EXPLORE_EVERY)
        s = Stream(chooser, acc, counts, arm_launches, "")
        counts()
        s.seed(((DSOp.HT_INSERT, ops), (DSOp.HT_FIND, ops)), fixed_pair)
        for b in range(batches):
            s.batch(b, fixed_pair, auto_pair, check)
        skew = float(np.mean([ad.batch_skew(
            ht.place_np(p, nslots, k)[0], p) for k, _, _ in batch_np]))
        report[mix] = s.report(ops, ops_of, OpStats(
            target_busy_us=busy, skew=skew, nranks=p), params)
        report[mix].update(busy_us=busy, skew_mean=skew)
        if mix == "uniform":
            busy_ref = 2.0 * statistics.median(
                x + y for x, y in zip(*s.fixed["rdma_fused"]))
    return report


def phase_auto_hot_cached(seed: int, device, sync, params, counts,
                          p: int = P, n: int = N, nslots: int = NSLOTS,
                          batches: int = AUTO_BATCHES) -> dict:
    """Phase 11's hot owner mix once more with a hot-bucket cache on the
    chooser: per batch, from the empty table (the cache flushed, since the
    table was reset behind it), an AUTO insert and find, then the find
    twice more through the cached fused arm (forced), the second served
    from the cache. Every find is held to the oracle."""
    import torch
    from repro_torch.core import adaptive as ad, cache, hashtable as ht
    mix = "hot"
    batch_np = auto_stream(seed + 100 + AUTO_MIXES.index(mix), mix, p, n,
                           batches)
    t0, engine = fresh_ht(p, nslots, device)
    c = cache.BucketCache(p, nslots, VW, **CACHE_KW)
    chooser = ad.AdaptiveEngine(p, am_engine=engine, params=params, cache=c)
    arms, hits, ms = [], [], ([], [])
    counts()
    for b, (k, f, present) in enumerate(batch_np):
        c.invalidate_all()
        chooser.force_arm = None
        t, ok, _ = ht.insert(t0, k, val_of(k)[..., None], engine=engine,
                             adaptive=chooser)
        t, found, got = ht.find(t, f, engine=engine, adaptive=chooser)
        arms.append((chooser.log[-2].arm, chooser.log[-1].arm))
        check_auto_ht(f"hot cached auto {b}", ok, found, got, k, f, present)
        chooser.force_arm = "rdma_fused"
        for i in range(2):
            sync()
            s0 = time.perf_counter()
            t, found2, got2 = ht.find(t, f, engine=engine, adaptive=chooser)
            sync()
            ms[i].append((time.perf_counter() - s0) * 1e3)
            if not (torch.equal(found2, found) and torch.equal(got2, got)):
                raise AssertionError(f"phase 11: hot cached batch {b}: a "
                                     f"cached re-read differs")
        hits.append(c.last_hit_rate)
    launched = {k: v for k, v in counts().items() if v}
    return dict(auto_arms=arms, hit_rate_second_reread=hits,
                fill_ms=statistics.median(ms[0]),
                cached_ms=statistics.median(ms[1]), stats=c.stats(),
                launches=launched)


def phase_auto_queue(seed: int, device, sync, params, counts, arm_launches,
                     p: int = P, n: int = Q_N, cap: int = Q_CAP,
                     batches: int = AUTO_BATCHES) -> dict:
    """Phase 11's queue stream: per batch, a push (C_RW) of p x n items
    and a pop (C_R) of n a rank from the same empty queue, on the four
    fixed arms and AUTO; the pops must return the pushes in ticket
    order."""
    import torch
    from repro_torch.core import adaptive as ad, am, queue as dq
    from repro_torch.core.costmodel import DSOp
    from repro_torch.core.types import OpStats, Promise
    ops = p * n
    q0 = dq.make_queue(p, Q_HOST, cap, Q_VW, device=device)
    engine = am.AMEngine(p)
    dq.build_am_handlers(q0, engine)
    acc = Accounted(sync, 0.0, params.pt_overhead)
    items = queue_items(seed + 200, batches, p, n)
    it_dev = torch.as_tensor(items, device=device)

    def fixed_pair(arm, b):
        if arm in ("am", "am_pt"):
            kw = dict(backend="rpc", engine=engine)
        else:
            kw = dict(backend="rdma", planned=arm == "rdma_fused")
        us_p, (q, ok) = acc(arm, lambda: dq.push(
            q0, it_dev[b], promise=Promise.CRW, **kw))
        us_o, (_, got, vals) = acc(arm, lambda: dq.pop(
            q, n, promise=Promise.CR, **kw))
        return us_p, us_o, ok, got, vals, b

    def auto_pair(b):
        us_p, dec_p, (q, ok) = acc.auto(chooser, s.spent, lambda: dq.push(
            q0, it_dev[b], promise=Promise.CRW, engine=engine,
            adaptive=chooser))
        us_o, dec_o, (_, got, vals) = acc.auto(
            chooser, s.spent, lambda: dq.pop(
                q, n, promise=Promise.CR, engine=engine, adaptive=chooser))
        return (dec_p, dec_o), (us_p, us_o, ok, got, vals, b)

    def check(arm, ok, got, vals, b):
        check_queue_batch(arm, ok, got, vals, items[b])

    chooser = ad.AdaptiveEngine(p, am_engine=engine, params=params,
                                explore_every=AUTO_EXPLORE_EVERY)
    s = Stream(chooser, acc, counts, arm_launches, "queue ")
    counts()
    s.seed(((DSOp.Q_PUSH, ops), (DSOp.Q_POP, ops)), fixed_pair)
    for b in range(batches):
        s.batch(b, fixed_pair, auto_pair, check)
    return s.report(ops, (("push", DSOp.Q_PUSH, Promise.CRW),
                          ("pop", DSOp.Q_POP, Promise.CR)),
                    OpStats(skew=float(p), nranks=p), params)


def forced_arms(device, sync, counts, arm_launches, p: int = P,
                n: int = N, nslots: int = NSLOTS, qn: int = Q_N,
                cap: int = Q_CAP) -> None:
    """Each of the four arms once through the AUTO front doors
    (`force_arm`), on a hash-table batch and a queue batch: every arm
    really runs behind backend="auto", whatever the chooser picked in the
    timed streams. Launches go to arm_launches under "forced <arm>"."""
    import torch
    from repro_torch.core import adaptive as ad, am, hashtable as ht
    from repro_torch.core import queue as dq
    (k_np, f_np, present), = auto_stream(7, "uniform", p, n, 1)
    keys, fkeys = (torch.as_tensor(x, device=device) for x in (k_np, f_np))
    vals = torch.as_tensor(val_of(k_np)[..., None], device=device)
    items = queue_items(300, 1, p, qn)
    t0 = ht.make_hashtable(p, nslots, VW, device=device)
    q0 = dq.make_queue(p, Q_HOST, cap, Q_VW, device=device)
    for arm in AUTO_ARMS:
        e_ht, e_q = am.AMEngine(p), am.AMEngine(p)
        a_ht = ad.AdaptiveEngine(p, am_engine=e_ht)
        a_q = ad.AdaptiveEngine(p, am_engine=e_q)
        a_ht.force_arm = a_q.force_arm = arm
        counts()
        t, ok, _ = ht.insert(t0, keys, vals, engine=e_ht, adaptive=a_ht)
        _, found, got = ht.find(t, fkeys, engine=e_ht, adaptive=a_ht)
        sync()
        add_launches(arm_launches, f"forced {arm}", counts())
        check_auto_ht(f"forced {arm}", ok, found, got, k_np, f_np, present)
        q, okq = dq.push(q0, torch.as_tensor(items[0], device=device),
                         engine=e_q, adaptive=a_q)
        _, gq, vq = dq.pop(q, qn, engine=e_q, adaptive=a_q)
        sync()
        add_launches(arm_launches, f"forced queue {arm}", counts())
        check_queue_batch(f"forced {arm}", okq, gq, vq, items[0])
        if {d.arm for d in a_ht.log} | {d.arm for d in a_q.log} != {arm}:
            raise AssertionError(f"phase 11: forced {arm} ran another arm")


def log_auto(auto: dict, card: str) -> None:
    """Phase 11's lines: per stream the medians, regret and arms chosen,
    and per op the model beside the measurements."""
    hc = auto.get("hot_cached")
    if hc is not None:
        log(f"phase 11: hot mix with the cache: AUTO's (insert, find) arms "
            f"{hc['auto_arms']}; forced cached re-reads: median ms "
            f"{hc['fill_ms']:.3f} (filling) then {hc['cached_ms']:.3f} "
            f"(hit rates {hc['hit_rate_second_reread']}); stats "
            f"{hc['stats']}; launches {hc['launches']} ({card})")
    for name, rep in auto.items():
        if name == "hot_cached":
            continue
        log(f"phase 11: {name}: median us per batch (insert + find, or push "
            f"+ pop; {rep['ops']} ops each): "
            + ", ".join(f"{a} {v:.1f}" for a, v in rep["fixed_us"].items())
            + f"; auto {rep['auto_us']:.1f} (decide "
            f"{rep['decide_us_per_batch']:.1f} a batch); regret "
            f"{rep['regret']:+.4f} against {rep['best_fixed']}; chosen "
            f"{rep['chosen']} ({', '.join(rep['sources'])}; {card})")
        for op, m in rep["model"].items():
            log(f"phase 11: {name} {op}: model us/op "
                + ", ".join(f"{a} {v:.6f}" for a, v in
                            m["model_us_per_op"].items())
                + "; measured " + ", ".join(
                    f"{a} {v:.6f}" for a, v in
                    m["measured_us_per_op"].items())
                + f"; argmin model {m['model_argmin']}, measured "
                f"{m['measured_argmin']}: "
                + ("agree" if m["agree"] else "DISAGREE"))


# the owner-lane kernels each arm must (and must not) launch
ARM_KERNELS = {"rdma": ({"amo_apply"}, {"hash_find", "hash_insert"}),
               "rdma_fused": ({"fused_apply"}, {"hash_find", "hash_insert"}),
               "am": ({"hash_find", "hash_insert"},
                      {"amo_apply", "fused_apply"}),
               "am_pt": ({"hash_find", "hash_insert"},
                         {"amo_apply", "fused_apply"})}
# the hosted queue: its one-sided arms run B1; its handlers are plain torch
QUEUE_KERNELS = {"rdma": ({"amo_apply"}, set(DS_KERNELS) - {"amo_apply"}),
                 "rdma_fused": ({"amo_apply"},
                                set(DS_KERNELS) - {"amo_apply"}),
                 "am": (set(), set(DS_KERNELS)),
                 "am_pt": (set(), set(DS_KERNELS))}


def check_arm_launches(arm_launches: dict) -> None:
    """B1/B2 on the one-sided arms, B3/B4 on the AM arms, in every entry
    of arm_launches (fixed, AUTO-chosen and forced)."""
    for key, got in arm_launches.items():
        arm = key.split()[-1]
        table = QUEUE_KERNELS if "queue" in key else ARM_KERNELS
        need, never = table[arm]
        bad = [k for k in need if not got.get(k)] + [
            k for k in never if got.get(k)]
        if bad:
            raise AssertionError(f"phase 11: {key} launched {got}; "
                                 f"{sorted(bad)} wrong for that arm")


# ---------------------------------------------------------------------------
# Phases 12 and 13: the pipelined engine and the fault plane at phase 2's
# size
# ---------------------------------------------------------------------------
PIPE_FULL_PAIRS = 16        # phase 12: insert + find pairs of a stream
PIPE_PAIRS = 8              # run (a printed cut: 16 pairs took 154 s)
PIPE_DEPTHS = (1, 2, 3)
PIPE_ITERS = 5              # interleaved timed passes per depth
# rdma (unfused) runs fixed probe rounds: its staging reads no device value
PIPE_ARMS = ("rpc", "rdma_fused", "rdma", "auto")
PIPE_Q_DEPTHS = (1, 2)
PIPE_BUSY_FACTORS = (0.0, 1.0, 4.0)   # the attentiveness line
PIPE_SMALL_PAIRS = 4        # the CPU-against-GPU stream at SMALL's size
CHAOS_FULL = 8              # phase 13: insert + find batches an arm
CHAOS_BATCHES = 2           # run: the plane's host simulation takes about
                            # 0.5 s a phase of 65,536 rows (printed cut)
CHAOS_ARMS = ("rdma", "rdma_fused", "am", "auto", "cached")
# tests/test_faults.py::_schedules()
CHAOS_SCHEDULES = (
    ("drops", dict(seed=101, drop_rate=0.30)),
    ("dups", dict(seed=202, dup_rate=0.40)),
    ("mixed", dict(seed=303, drop_rate=0.15, dup_rate=0.15,
                   delay_rate=0.20, delay_rounds=2, dead_owners={1: 3})),
)


def pipe_stream(seed: int, pairs: int, p: int, n: int) -> list:
    """Per pair (host arrays): insert keys (p, n), their values
    (p, n, 1), and find keys: the insert's keys in even columns, keys
    never inserted in odd ones. Keys are distinct across the stream."""
    keys = make_keys(seed, 2 * pairs * p * n).reshape(2 * pairs, p, n)
    present = np.zeros((p, n), bool)
    present[:, ::2] = True
    return [(keys[2 * b], val_of(keys[2 * b])[..., None],
             np.where(present, keys[2 * b], keys[2 * b + 1]))
            for b in range(pairs)]


def check_pipe_ht(what: str, outs: list, stream: list) -> None:
    """Every inserted key is found with val_of(key) in its pair's find;
    the keys never inserted are not."""
    for b, (k, _, f) in enumerate(stream):
        (ok, _), (found, got) = outs[2 * b], outs[2 * b + 1]
        ok, found = ok.cpu().numpy(), found.cpu().numpy()
        want = np.zeros_like(found)
        want[:, ::2] = ok[:, ::2]
        if not ok.all() or not np.array_equal(found, want):
            raise AssertionError(f"{what}: pair {b}: inserts failed or "
                                 f"finds disagree with them")
        if not np.array_equal(got.cpu().numpy()[..., 0],
                              np.where(want, val_of(f), 0)):
            raise AssertionError(f"{what}: pair {b}: found values differ")


def ht_kwargs(arm: str, engine, ewma, params):
    """(front-door keyword arguments, chooser) of one arm: a fixed backend,
    or AUTO with a chooser holding the seeded EWMAs (measure=False)."""
    from repro_torch.core import adaptive as ad
    if arm in ("rpc", "am"):
        return dict(backend="rpc", engine=engine), None
    if arm in ("rdma", "rdma_fused"):
        return dict(backend="rdma", fused=arm == "rdma_fused"), None
    kw = {} if params is None else dict(params=params)
    chooser = ad.AdaptiveEngine(engine.nranks, am_engine=engine, **kw)
    chooser.ewma = dict(ewma or {})
    return dict(engine=engine, adaptive=chooser), chooser


def fresh_ht(p: int, nslots: int, device):
    from repro_torch.core import am, hashtable as ht
    table = ht.make_hashtable(p, nslots, VW, device=device)
    engine = am.AMEngine(p)
    ht.build_am_handlers(table, engine)
    return table, engine


def fresh_queue(p: int, device):
    """Phase 2's hosted queue, empty, with its AM handlers."""
    from repro_torch.core import am, queue as dq
    q = dq.make_queue(p, Q_HOST, Q_CAP, Q_VW, device=device)
    engine = am.AMEngine(p)
    dq.build_am_handlers(q, engine)
    return q, engine


def ht_pipe_run(arm: str, stream: list, depth: int, busy_us: float, device,
                p: int = P, nslots: int = NSLOTS, ewma=None, params=None,
                auto_depth: bool = False, reverse: bool = False,
                per_submit=None) -> dict:
    """One pass of the stream through `Pipeline(table, depth)` and the
    async front doors, busy-waiting busy_us after every submit, then
    forcing every handle (in reverse submission order with reverse) and
    flushing. per_submit(fn) wraps each submit (the sync counter)."""
    from repro_torch.core import hashtable as ht, pipeline as pl, window
    from repro_torch.core.types import Promise
    table, engine = fresh_ht(p, nslots, device)
    kw, chooser = ht_kwargs(arm, engine, ewma, params)
    pipe = pl.Pipeline(table, depth=depth, am_engine=engine,
                       auto_depth=auto_depth)
    window.drain_phase_log()
    handles, per = [], []
    wrap = per_submit or (lambda fn: fn())
    t0 = time.perf_counter()
    for k, v, f in stream:
        for kind in ("insert", "find"):
            tb = time.perf_counter()
            if kind == "insert":
                h = wrap(lambda: ht.insert_async(pipe, k, v,
                                                 promise=Promise.CRW, **kw))
            else:
                h = wrap(lambda: ht.find_async(pipe, f, promise=Promise.CR,
                                               **kw))
            busy_wait(busy_us)
            handles.append(h)
            per.append(time.perf_counter() - tb)
    for h in (reversed(handles) if reverse else handles):
        h.result()
    table = pipe.flush()
    wall = time.perf_counter() - t0
    log = [(role, info["slot"], info["seq"])
           for role, _, info in window.drain_phase_log()]
    return dict(outs=[h.result() for h in handles], data=table.win.data,
                wall=wall, per=per, dispatch_points=engine.dispatch_points,
                log=log, chooser=chooser)


def ht_sync_run(arm: str, stream: list, device, p: int = P,
                nslots: int = NSLOTS, ewma=None, params=None) -> dict:
    """The same stream through the synchronous front doors."""
    from repro_torch.core import hashtable as ht
    from repro_torch.core.types import Promise
    table, engine = fresh_ht(p, nslots, device)
    kw, _ = ht_kwargs(arm, engine, ewma, params)
    outs = []
    for k, v, f in stream:
        table, ok, pr = ht.insert(table, k, v, promise=Promise.CRW, **kw)
        outs.append((ok, pr))
        table, found, got = ht.find(table, f, promise=Promise.CR, **kw)
        outs.append((found, got))
    return dict(outs=outs, data=table.win.data)


def same_outs(a: list, b: list, what: str) -> None:
    """Two runs' outputs (tensors or tuples of them) equal, bit for bit."""
    import torch
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} against {len(b)} outputs")
    for i, (x, y) in enumerate(zip(a, b)):
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        for u, w in zip(x, y):
            if not torch.equal(u.to(w.device), w):
                raise AssertionError(f"{what}: output {i} differs")


def same_run(a: dict, b: dict, what: str) -> None:
    """Every output and the final window equal, bit for bit."""
    import torch
    same_outs(a["outs"], b["outs"], what)
    if not torch.equal(a["data"].to(b["data"].device), b["data"]):
        raise AssertionError(f"{what}: final windows differ")


def seed_ewma(stream: list, device, sync, params, p: int = P,
              nslots: int = NSLOTS) -> dict:
    """The AUTO chooser's EWMAs, as phase 11 seeds them: the median of
    AUTO_SEED_REPS synchronized reps of each arm's insert and find of the
    stream's first pair on an empty table, µs per op (am_pt: am times
    pt_overhead)."""
    from repro_torch.core import hashtable as ht
    from repro_torch.core.costmodel import DSOp
    from repro_torch.core.types import Promise
    k, v, f = stream[0]
    ops = k.size
    pt = params.pt_overhead
    ewma = {}
    for arm in ("rdma", "rdma_fused", "am"):
        reps = []
        for _ in range(AUTO_SEED_REPS + 1):
            table, engine = fresh_ht(p, nslots, device)
            kw, _ = ht_kwargs(arm, engine, None, None)
            sync()
            t0 = time.perf_counter()
            table, _, _ = ht.insert(table, k, v, promise=Promise.CRW, **kw)
            sync()
            t1 = time.perf_counter()
            ht.find(table, f, promise=Promise.CR, **kw)
            sync()
            reps.append(((t1 - t0) * 1e6 / ops,
                         (time.perf_counter() - t1) * 1e6 / ops))
        ins, fnd = (float(np.median([r[i] for r in reps[1:]]))
                    for i in (0, 1))
        for a, scale in ((arm, 1.0),) + ((("am_pt", pt),)
                                         if arm == "am" else ()):
            ewma[(DSOp.HT_INSERT, a)] = ins * scale
            ewma[(DSOp.HT_FIND, a)] = fnd * scale
    return ewma


class SyncCounter:
    """Counts the implicit host syncs of the calls it wraps, through
    torch.cuda.set_sync_debug_mode("warn"), by the file:line of the
    Python caller."""

    def __init__(self):
        self.calls, self.total, self.sites = 0, 0, {}

    def __call__(self, fn):
        import warnings
        import torch
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        self.calls += 1
        for w in caught:
            if "synchroniz" not in str(w.message).lower():
                continue
            self.total += 1
            site = f"{Path(w.filename).name}:{w.lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1
        return out

    def report(self) -> dict:
        return dict(per_submit=self.total / max(1, self.calls),
                    submits=self.calls,
                    sites=dict(sorted(self.sites.items(),
                                      key=lambda kv: -kv[1])))


def calibrate_busy(run, depth1_passes: int = 2) -> tuple:
    """(busy_us, the median µs of each kind of submit): busy_us is the
    median per-submit time of a depth-1 pass over the stream with no busy
    wait (after an untimed warm-up pass), as the JAX package's
    benchmarks/pipeline_bench.py sizes its window (it takes the p90; this
    run takes the median)."""
    for _ in range(depth1_passes - 1):
        run(1, 0.0)
    per = run(1, 0.0)["per"]
    return (statistics.median(per) * 1e6,
            [statistics.median(per[i::2]) * 1e6 for i in (0, 1)])


def depth_sweep(run, depths, busy_us: float, iters: int, counts) -> dict:
    """Interleaved passes per depth (the JAX bench's method): wall time
    medians, the launches of each pass (equal across depths), and the
    first pass of each depth for the equality gates."""
    walls = {d: [] for d in depths}
    first, launches = {}, {}
    for _ in range(iters):
        for d in depths:
            counts()
            r = run(d, busy_us)
            got = {k: v for k, v in counts().items() if v}
            if launches.setdefault(d, got) != got:
                raise AssertionError(f"launches differ between passes at "
                                     f"depth {d}: {launches[d]} / {got}")
            walls[d].append(r["wall"])
            first.setdefault(d, r)
    return dict(walls=walls, first=first, launches=launches,
                median_s={d: statistics.median(v) for d, v in walls.items()})


def stream_idle(run, depth: int, busy_us: float, sync,
                untraced_s: float) -> dict:
    """One stream pass traced with torch.profiler: device busy ms and the
    idle share against its traced wall time."""
    prof, wall = traced(lambda: run(depth, busy_us), sync)
    pr = profile_summary(prof, [wall], untraced_s * 1e3, 12)
    return dict(device_ms=pr.get("device_ms_per_step"),
                traced_wall_ms=pr.get("traced_wall_ms_per_step"),
                idle_share=pr.get("idle_share_traced"),
                idle_vs_untraced=pr.get("idle_share_vs_median"))


def attentiveness(stream: list, busy_us: float, device, sync, reps: int = 5,
                  p: int = P, nslots: int = NSLOTS) -> dict:
    """The service latency of a deferred find_async (rpc) at busy windows
    of 0, 1 and 4 x busy_us between its submit and the next dispatch
    point (its result()): the wait until the dispatch point staged it,
    measured inside the op, as benchmarks/pipeline_bench.py does; median
    of `reps`."""
    from repro_torch.core import hashtable as ht, pipeline as pl
    k, v, f = stream[0]
    out = {}
    for factor in PIPE_BUSY_FACTORS:
        waits, totals = [], []
        for _ in range(reps):
            table, engine = fresh_ht(p, nslots, device)
            table, _, _ = ht.insert_rpc(table, engine, k, v)
            pipe = pl.Pipeline(table, depth=2, am_engine=engine)
            staged = {}

            def op(t):
                staged["t"] = time.perf_counter()
                found, vals = ht.find_rpc(t, engine, f)
                return t, (found, vals)

            sync()
            t0 = time.perf_counter()
            h = pipe.submit(op, deferred=True, label="att_find")
            busy_wait(factor * busy_us)
            h.result()
            totals.append((time.perf_counter() - t0) * 1e6)
            waits.append((staged["t"] - t0) * 1e6)
        out[factor] = dict(busy_us=factor * busy_us,
                           wait_us=statistics.median(waits),
                           result_us=statistics.median(totals))
    return out


def q_pipe_run(arm: str, items: np.ndarray, depth: int, busy_us: float,
               device, p: int = P, reverse: bool = False,
               per_submit=None) -> dict:
    """Push batch b then pop Q_N a rank, for every batch, through
    `Pipeline(queue, depth)` and push_async / pop_async."""
    from repro_torch.core import pipeline as pl, queue as dq
    from repro_torch.core.types import Promise
    q, engine = fresh_queue(p, device)
    kw = (dict(backend="rpc", engine=engine) if arm == "rpc"
          else dict(backend="rdma"))
    pipe = pl.Pipeline(q, depth=depth, am_engine=engine)
    handles, per = [], []
    wrap = per_submit or (lambda fn: fn())
    n = items.shape[2]
    t0 = time.perf_counter()
    for b in range(items.shape[0]):
        for kind in ("push", "pop"):
            tb = time.perf_counter()
            if kind == "push":
                h = wrap(lambda: dq.push_async(pipe, items[b],
                                               promise=Promise.CRW, **kw))
            else:
                h = wrap(lambda: dq.pop_async(pipe, n, promise=Promise.CR,
                                              **kw))
            busy_wait(busy_us)
            handles.append(h)
            per.append(time.perf_counter() - tb)
    for h in (reversed(handles) if reverse else handles):
        h.result()
    q = pipe.flush()
    return dict(outs=[h.result() for h in handles], data=q.win.data,
                wall=time.perf_counter() - t0, per=per,
                dispatch_points=engine.dispatch_points)


def q_sync_run(arm: str, items: np.ndarray, device, p: int = P) -> dict:
    from repro_torch.core import queue as dq
    from repro_torch.core.types import Promise
    q, engine = fresh_queue(p, device)
    kw = (dict(backend="rpc", engine=engine) if arm == "rpc"
          else dict(backend="rdma"))
    outs = []
    for b in range(items.shape[0]):
        q, ok = dq.push(q, items[b], promise=Promise.CRW, **kw)
        q, got, vals = dq.pop(q, items.shape[2], promise=Promise.CR, **kw)
        outs += [ok, (got, vals)]
    return dict(outs=outs, data=q.win.data)


def pipe_arm(name: str, run, sync_ref: dict, depths, sync, counts,
             check, iters: int = PIPE_ITERS, trace: bool = True) -> dict:
    """Phase 12 for one arm: busy calibration, the interleaved depth
    sweep, the gates (depth 1 == the synchronous front doors; every depth
    and a reverse-forced pass == depth 1; equal launches; the slot-tagged
    phase log of each depth is depth 1's with slot = seq % depth), the
    syncs per submit at depth 2, and one traced pass per depth."""
    busy, by_kind = calibrate_busy(run)
    sweep = depth_sweep(run, depths, busy, iters, counts)
    d1 = sweep["first"][1]
    same_run(d1, sync_ref, f"phase 12: {name} depth 1 vs sync")
    check(f"phase 12: {name}", d1["outs"])
    for d in depths[1:]:
        same_run(sweep["first"][d], d1, f"phase 12: {name} depth {d}")
    counts()
    rev = run(depths[-1] + len(d1["outs"]), 0.0, reverse=True)
    same_run(rev, d1, f"phase 12: {name} forced in reverse")
    counts()
    launches = sweep["launches"]
    if any(launches[d] != launches[1] for d in depths):
        raise AssertionError(f"phase 12: {name}: launches differ by depth "
                             f"{launches}")
    for d in depths:
        log = sweep["first"][d].get("log", [])
        want = [(role, seq % d, seq) for role, _, seq in d1.get("log", [])]
        if log != want:
            raise AssertionError(f"phase 12: {name}: the phase log at "
                                 f"depth {d} is not depth 1's re-slotted")
    syncs = SyncCounter()
    run(2, 0.0, per_submit=syncs)
    counts()
    rep = dict(busy_us=busy, submit_us_by_kind=by_kind,
               median_s=sweep["median_s"],
               walls=sweep["walls"], launches=launches[1],
               speedup_d2=sweep["median_s"][1] / sweep["median_s"][2],
               syncs=syncs.report(), phase_log_len=len(d1.get("log", [])),
               dispatch_points={d: sweep["first"][d].get("dispatch_points")
                                for d in depths})
    if trace:
        rep["idle"] = {d: stream_idle(run, d, busy, sync,
                                      sweep["median_s"][d]) for d in depths}
        counts()
    return rep


def phase_pipeline(seed: int, device, sync, params, counts,
                   p: int = P, nslots: int = NSLOTS, n: int = N,
                   pairs: int = PIPE_PAIRS, qn: int = Q_N,
                   iters: int = PIPE_ITERS, trace: bool = True) -> dict:
    """Phase 12: the pipelined engine at phase 2's size. Hash-table
    streams of `pairs` insert + find pairs on rpc (deferred), rdma_fused,
    rdma and AUTO at depths 1-3, AUTO once more with auto_depth (cap 3); the
    queue's two arms at depths 1 and 2; the attentiveness line."""
    stream = pipe_stream(seed + 1200, pairs, p, n)
    ewma = seed_ewma(stream, device, sync, params, p, nslots)
    counts()
    report = {}
    for arm in PIPE_ARMS:
        def run(d, busy, reverse=False, per_submit=None, arm=arm, **kw):
            return ht_pipe_run(arm, stream, d, busy, device, p, nslots,
                               ewma, params, reverse=reverse,
                               per_submit=per_submit, **kw)
        ref = ht_sync_run(arm, stream, device, p, nslots, ewma, params)
        counts()
        report[arm] = pipe_arm(arm, run, ref, PIPE_DEPTHS, sync, counts,
                               lambda what, outs: check_pipe_ht(
                                   what, outs, stream), iters, trace)
        del ref
    # AUTO choosing its own window count, capped at 3
    busy = report["auto"]["busy_us"]
    r = ht_pipe_run("auto", stream, 3, busy, device, p, nslots, ewma, params,
                    auto_depth=True)
    same_run(r, ht_pipe_run("auto", stream, 1, 0.0, device, p, nslots, ewma,
                            params), "phase 12: auto_depth vs depth 1")
    depths = [d.depth for d in r["chooser"].log]
    arms = sorted({d.arm for d in r["chooser"].log})
    report["auto_depth"] = dict(wall_s=r["wall"], depths=sorted(set(depths)),
                                arms=arms, decisions=len(depths))
    counts()
    # the queue: push + pop pairs
    items = queue_items(seed + 1210, pairs, p, qn)

    def q_check(what, outs):
        for b in range(items.shape[0]):
            ok, (got, vals) = outs[2 * b], outs[2 * b + 1]
            check_queue_batch(what, ok, got, vals, items[b])

    for arm in ("rdma", "rpc"):
        def run(d, busy, reverse=False, per_submit=None, arm=arm):
            return q_pipe_run(arm, items, d, busy, device, p, reverse,
                              per_submit)
        ref = q_sync_run(arm, items, device, p)
        counts()
        report[f"queue_{arm}"] = pipe_arm(f"queue {arm}", run, ref,
                                          PIPE_Q_DEPTHS, sync, counts,
                                          q_check, iters, trace)
    report["attentiveness"] = attentiveness(
        stream, report["rpc"]["busy_us"], device, sync, p=p, nslots=nslots)
    counts()
    return report


def pipe_small_cpu_vs_gpu(seed: int, device, params) -> dict:
    """Phase 12's gate against the CPU: the same pipelined streams at
    SMALL's size (every arm of PIPE_ARMS at depth 2) on both devices:
    equal outputs, windows, dispatch points and slot-tagged phase logs."""
    s = SMALL
    stream = pipe_stream(seed + 1220, PIPE_SMALL_PAIRS, s["P"], s["N"])
    ewma = seed_ewma(stream, "cpu", lambda: None, params, s["P"],
                     s["NSLOTS"])
    for arm in PIPE_ARMS:
        a, b = (ht_pipe_run(arm, stream, 2, 0.0, dev, s["P"], s["NSLOTS"],
                            ewma, params) for dev in (device, "cpu"))
        same_run(a, b, f"phase 12: small {arm} GPU vs CPU")
        if a["dispatch_points"] != b["dispatch_points"] or \
                a["log"] != b["log"]:
            raise AssertionError(f"phase 12: small {arm}: dispatch points "
                                 f"or phase log differ GPU vs CPU")
        if arm == "auto" and [d.arm for d in a["chooser"].log] != \
                [d.arm for d in b["chooser"].log]:
            raise AssertionError("phase 12: small auto: arms differ")
    return dict(pairs=PIPE_SMALL_PAIRS, p=s["P"], nslots=s["NSLOTS"],
                n=s["N"])


def log_pipeline(rep: dict, card: str) -> None:
    for name, r in rep.items():
        if not isinstance(r, dict) or "median_s" not in r:
            continue
        walls = ", ".join(f"depth {d} {v * 1e3:.3f} ms"
                          for d, v in r["median_s"].items())
        kinds = "/".join(f"{v:.1f}" for v in r["submit_us_by_kind"])
        log(f"phase 12: {name}: busy {r['busy_us']:.1f} us a submit (depth "
            f"1, alternate submits {kinds} us); median stream {walls}; "
            f"depth-2 / depth-1 speedup "
            f"{r['speedup_d2']:.4f}; syncs per submit "
            f"{r['syncs']['per_submit']:.2f} at "
            f"{r['syncs']['sites']}; launches a pass {r['launches']}; "
            f"dispatch points {r['dispatch_points']} ({card})")
        for d, idle in r.get("idle", {}).items():
            if idle["device_ms"] is not None:
                log(f"phase 12: {name}: traced stream at depth {d}: device "
                    f"busy {idle['device_ms']:.3f} ms, idle "
                    f"{idle['idle_vs_untraced']:.4f} of the untraced "
                    f"median stream ({idle['idle_share']:.4f} of the "
                    f"traced {idle['traced_wall_ms']:.3f} ms) ({card})")
    a = rep["auto_depth"]
    log(f"phase 12: auto with auto_depth (cap 3): depths {a['depths']}, "
        f"arms {a['arms']}, {a['decisions']} decisions, stream "
        f"{a['wall_s'] * 1e3:.3f} ms ({card})")
    for f, r in rep["attentiveness"].items():
        log(f"phase 12: attentiveness: busy {r['busy_us']:.1f} us -> "
            f"deferred rpc find waits {r['wait_us']:.1f} us for its "
            f"dispatch point, result after {r['result_us']:.1f} us "
            f"({card})")


# -- phase 13 ----------------------------------------------------------------
class ChaosArm:
    """A stream of insert + find batches on one arm through the chooser's
    wrappers (forced, or round robin for auto), as tests/test_faults.py
    runs its arms; "cached" is the fused arm with a hot-bucket cache,
    whose finds run twice (the second served from the cache)."""

    def __init__(self, arm: str, device, p: int, nslots: int, params=None):
        from repro_torch.core import adaptive as ad, cache
        self.table, self.engine = fresh_ht(p, nslots, device)
        kw = {} if params is None else dict(params=params)
        self.auto = ad.AdaptiveEngine(p, am_engine=self.engine,
                                      policy="round_robin", **kw)
        self.cached = arm == "cached"
        if self.cached:
            self.auto.attach_cache(cache.BucketCache(p, nslots, VW,
                                                     **CACHE_KW))
            arm = "rdma_fused"
        if arm != "auto":
            self.auto.policy = "cost"
            self.auto.force_arm = arm
        self.device = device

    def pair(self, k, v, f):
        import torch
        dev = self.device
        self.table, ok, probes = self.auto.ht_insert(
            self.table, torch.as_tensor(k, device=dev),
            torch.as_tensor(v, device=dev))
        self.table, found, got = self.auto.ht_find(
            self.table, torch.as_tensor(f, device=dev))
        if self.cached:
            self.table, f2, g2 = self.auto.ht_find(self.table, f)
            if not (torch.equal(f2, found) and torch.equal(g2, got)):
                raise AssertionError("phase 13: a cached re-read differs")
        return (ok, probes), (found, got)


def chaos_ht(arm: str, stream: list, cfg, device, sync, params, p: int,
             nslots: int) -> dict:
    """One arm's stream with cfg's plan in scope (None: fault-free):
    outputs, window, ms per pair, the plan's stats."""
    from repro_torch.core import faults as flt
    runner = ChaosArm(arm, device, p, nslots, params)
    plan = None if cfg is None else flt.FaultPlan(p, **cfg)
    outs, per = [], []
    with flt.fault_scope(plan):
        for k, v, f in stream:
            sync()
            t0 = time.perf_counter()
            outs += list(runner.pair(k, v, f))
            sync()
            per.append(time.perf_counter() - t0)
    return dict(outs=outs, data=runner.table.win.data, per=per,
                stats=None if plan is None else plan.stats(),
                runner=runner)


def chaos_queue(arm: str, items: np.ndarray, cfg, device, sync, p: int,
                n: int) -> dict:
    from repro_torch.core import adaptive as ad, am, faults as flt
    from repro_torch.core import queue as dq
    q = dq.make_queue(p, Q_HOST, Q_CAP, Q_VW, device=device)
    auto = ad.AdaptiveEngine(p, am_engine=am.AMEngine(p))
    auto.force_arm = arm
    plan = None if cfg is None else flt.FaultPlan(p, **cfg)
    outs, per = [], []
    import torch
    with flt.fault_scope(plan):
        for b in range(items.shape[0]):
            sync()
            t0 = time.perf_counter()
            q, ok = auto.q_push(q, torch.as_tensor(items[b], device=device))
            q, got, vals = auto.q_pop(q, n)
            sync()
            per.append(time.perf_counter() - t0)
            outs += [ok, (got, vals)]
    return dict(outs=outs, data=q.win.data, per=per,
                stats=None if plan is None else plan.stats())


def chaos_pipelined(stream: list, cfg, device, p: int, nslots: int) -> dict:
    """A depth-2 pipelined stream of fused inserts, every other batch
    deferred, under cfg's plan: handles forced with timeout=32."""
    import torch
    from repro_torch.core import faults as flt, hashtable as ht
    from repro_torch.core import pipeline as pl
    table, engine = fresh_ht(p, nslots, device)
    plan = None if cfg is None else flt.FaultPlan(p, **cfg)
    outs = []

    def step(k, v):
        k, v = (torch.as_tensor(x, device=device) for x in (k, v))

        def op(st):
            st2, ok, pr = ht.insert_rdma(st, k, v)
            return st2, (ok, pr)
        return op

    with flt.fault_scope(plan):
        with pl.Pipeline(table, depth=2, am_engine=engine) as pipe:
            hs = [pipe.submit(step(k, v), deferred=i % 2 == 1,
                              label=f"b{i}")
                  for i, (k, v, _) in enumerate(stream)]
            outs = [h.result(timeout=32) for h in hs]
            table = pipe.flush()
    return dict(outs=outs, data=table.win.data,
                stats=None if plan is None else plan.stats())


def phase_faults(seed: int, device, sync, params, counts,
                 p: int = P, nslots: int = NSLOTS, n: int = N,
                 batches: int = CHAOS_BATCHES, qn: int = Q_N,
                 small: dict = SMALL) -> dict:
    """Phase 13: the fault plane at phase 2's size. Every arm under each
    schedule against its fault-free run and the host oracle; an owner dead
    forever under AUTO; a pipelined stream under a stalled queue; a queue
    stalled forever; a pipeline left on an exception; and a small
    pipelined chaos stream on both devices."""
    import torch
    from repro_torch.core import adaptive as ad, faults as flt
    from repro_torch.core import hashtable as ht, pipeline as pl
    from repro_torch.core import queue as dq
    from repro_torch.core.costmodel import DSOp
    stream = pipe_stream(seed + 1300, batches, p, n)
    items = queue_items(seed + 1310, batches, p, qn)
    report = dict(batches=batches, full_batches=CHAOS_FULL, ht={}, queue={})
    for arm in CHAOS_ARMS:
        clean = chaos_ht(arm, stream, None, device, sync, params, p, nslots)
        check_pipe_ht(f"phase 13: {arm} fault-free", clean["outs"], stream)
        rep = report["ht"][arm] = dict(
            clean_ms=statistics.median(clean["per"]) * 1e3)
        for name, cfg in CHAOS_SCHEDULES:
            r = chaos_ht(arm, stream, cfg, device, sync, params, p, nslots)
            what = f"phase 13: {arm} under {name}"
            check_pipe_ht(what, r["outs"], stream)
            if arm == "auto":
                # a quarantine re-route may run a batch on another
                # (conformant) arm: results and every read must agree
                same_outs(r["outs"], clean["outs"], what)
                for k, _, f in stream:
                    _, a_f, a_v = r["runner"].auto.ht_find(
                        r["runner"].table, torch.as_tensor(f, device=device))
                    _, b_f, b_v = clean["runner"].auto.ht_find(
                        clean["runner"].table,
                        torch.as_tensor(f, device=device))
                    if not (torch.equal(a_f, b_f) and torch.equal(a_v, b_v)):
                        raise AssertionError(f"{what}: final reads differ")
            else:
                same_run(r, clean, what)
            rep[name] = dict(ms=statistics.median(r["per"]) * 1e3,
                             stats=r["stats"])
            if arm == "cached":
                rep[name]["cache"] = r["runner"].auto.cache.stats()
        del clean
    counts()
    report["txn"] = txn_chaos(seed, device, sync, params, p,
                              nslots * (2 + VW))
    counts()
    for arm in ("rdma", "am"):
        clean = chaos_queue(arm, items, None, device, sync, p, qn)
        rep = report["queue"][arm] = dict(
            clean_ms=statistics.median(clean["per"]) * 1e3)
        for name, cfg in CHAOS_SCHEDULES:
            r = chaos_queue(arm, items, cfg, device, sync, p, qn)
            what = f"phase 13: queue {arm} under {name}"
            same_run(r, clean, what)
            for b in range(items.shape[0]):
                ok, (got, vals) = r["outs"][2 * b], r["outs"][2 * b + 1]
                check_queue_batch(what, ok, got, vals, items[b])
            rep[name] = dict(ms=statistics.median(r["per"]) * 1e3,
                             stats=r["stats"])
    counts()
    # an owner dead forever under AUTO (cost policy, AM cheapest by its
    # EWMAs): its rows of the first insert fail over one-sided (B2 beside
    # B4), it is quarantined, and the next insert re-routes one-sided
    # (B2 where B4 would run)
    dead = 5
    table, engine = fresh_ht(p, nslots, device)
    chooser = ad.AdaptiveEngine(p, am_engine=engine)
    for op in (DSOp.HT_INSERT, DSOp.HT_FIND):
        for a, us in (("am", 1e-6), ("am_pt", 2e-6), ("rdma_fused", 1.0),
                      ("rdma", 2.0)):
            chooser.ewma[(op, a)] = us
    plan = flt.FaultPlan(p, seed=505, dead_owners={dead: None})
    inserts, outs, quarantined = [], [], []
    with flt.fault_scope(plan):
        for k, v, _ in stream:
            counts()
            table, ok, _ = chooser.ht_insert(
                table, *(torch.as_tensor(x, device=device) for x in (k, v)))
            sync()
            inserts.append(counts())
            quarantined.append(sorted(chooser.quarantined))
            outs.append(ok)
        for b, (_, _, f) in enumerate(stream):
            table, found, got = chooser.ht_find(
                table, torch.as_tensor(f, device=device))
            outs.insert(2 * b + 1, (found, got))
    decs = list(chooser.log)
    check_pipe_ht("phase 13: dead owner", [o if isinstance(o, tuple)
                                           else (o, None) for o in outs],
                  stream)
    first, second = inserts[0], inserts[1]
    if quarantined[0] != [dead] or not (first["hash_insert"]
                                        and first["fused_apply"]):
        raise AssertionError(f"phase 13: dead owner: quarantined "
                             f"{quarantined[0]}, first insert launched "
                             f"{first}")
    if decs[1].source != "quarantine" or second["hash_insert"] or \
            not second["fused_apply"]:
        raise AssertionError(f"phase 13: dead owner: the second insert ran "
                             f"{decs[1].arm} ({decs[1].source}) launching "
                             f"{second}")
    report["dead_owner"] = dict(
        owner=dead, quarantined=quarantined[0],
        arms=[d.arm for d in decs], sources=[d.source for d in decs],
        first_launches={a: c for a, c in first.items() if c},
        second_launches={a: c for a, c in second.items() if c},
        unserviced_rows=int((ht.place_np(p, nslots, stream[0][0])[0]
                             == dead).sum()))
    # a pipelined depth-2 stream under a stalled queue and wire faults
    pcfg = dict(seed=11, drop_rate=0.2, dup_rate=0.2, stall_rounds=2)
    a = chaos_pipelined(stream, None, device, p, nslots)
    b = chaos_pipelined(stream, pcfg, device, p, nslots)
    same_run(b, a, "phase 13: pipelined under stall_rounds=2")
    if b["stats"]["stall_hits"] == 0:
        raise AssertionError("phase 13: the stalled queue never stalled")
    report["pipelined"] = dict(cfg=pcfg, stats=b["stats"])
    # a queue stalled forever: the typed timeout within its deadline, twice
    q, qeng = fresh_queue(p, device)
    plan = flt.FaultPlan(p, seed=1, stall_forever=True)
    raised = []
    with flt.fault_scope(plan):
        pipe = pl.Pipeline(q, depth=4, am_engine=qeng)
        h = dq.push_async(pipe, items[0], backend="rpc")
        for _ in range(2):
            t0 = time.perf_counter()
            try:
                h.result(timeout=8)
            except flt.RemoteTimeout as e:
                raised.append(((time.perf_counter() - t0) * 1e6, str(e)))
    if len(raised) != 2 or not h.done():
        raise AssertionError("phase 13: the dead queue did not raise "
                             "RemoteTimeout twice")
    report["stall_forever"] = dict(raise_us=[r[0] for r in raised],
                                   message=raised[0][1],
                                   stall_hits=plan.stall_hits)
    # a pipeline left on an exception fails its stranded handles
    table, engine = fresh_ht(p, nslots, device)
    plan = flt.FaultPlan(p, seed=5, stall_forever=True)

    class Left(Exception):
        pass

    try:
        with flt.fault_scope(plan):
            with pl.Pipeline(table, depth=4, am_engine=engine) as pipe:
                h = ht.insert_async(pipe, *stream[0][:2], backend="rpc")
                raise Left()
    except Left:
        pass
    try:
        h.result()
        raise AssertionError("phase 13: a stranded handle did not fail")
    except flt.RemoteTimeout:
        pass
    engine.drain_dispatch_queue()
    if engine.pending_dispatches or pipe.staged_state is not table:
        raise AssertionError("phase 13: a failed batch ran after close")
    counts()
    # a small pipelined chaos stream: the same replies, windows and plane
    # stats on the CPU and on the card
    s = small
    sstream = pipe_stream(seed + 1320, 3, s["P"], s["N"])
    name, cfg = CHAOS_SCHEDULES[-1]
    runs = [chaos_pipelined(sstream, cfg, dev, s["P"], s["NSLOTS"])
            for dev in (device, "cpu")]
    same_run(runs[0], runs[1], "phase 13: small pipelined chaos GPU vs CPU")
    if runs[0]["stats"] != runs[1]["stats"]:
        raise AssertionError("phase 13: small chaos: plane stats differ GPU "
                             "vs CPU")
    report["small"] = dict(schedule=name, stats=runs[0]["stats"],
                           p=s["P"], nslots=s["NSLOTS"], n=s["N"])
    return report


def log_faults(rep: dict, card: str) -> None:
    for kind in ("ht", "queue"):
        for arm, r in rep[kind].items():
            per = ", ".join(f"{name} {r[name]['ms']:.1f} ms "
                            f"({r[name]['ms'] / r['clean_ms']:.1f}x)"
                            for name, _ in CHAOS_SCHEDULES)
            pair = "insert + find" if kind == "ht" else "push + pop"
            log(f"phase 13: {kind} {arm}: median ms per {pair}: fault-free "
                f"{r['clean_ms']:.3f}, {per} ({card})")
            for name, _ in CHAOS_SCHEDULES:
                log(f"phase 13: {kind} {arm} {name}: plan.stats() "
                    f"{r[name]['stats']}")
    for name, _ in CHAOS_SCHEDULES:
        log(f"phase 13: ht cached {name}: cache stats "
            f"{rep['ht']['cached'][name]['cache']}")
    for arm, r in rep["txn"].items():
        per = ", ".join(f"{name} {r[name]['ms']:.1f} ms "
                        f"({r[name]['ms'] / r['clean_ms']:.1f}x, rounds "
                        f"{r[name]['rounds']})" for name, _ in CHAOS_SCHEDULES)
        log(f"phase 13: txn {arm}: median ms per batch of {P} txns: "
            f"fault-free {r['clean_ms']:.3f}, {per} ({card})")
        for name, _ in CHAOS_SCHEDULES:
            log(f"phase 13: txn {arm} {name}: plan.stats() "
                f"{r[name]['stats']}")
    d = rep["dead_owner"]
    log(f"phase 13: owner {d['owner']} dead forever under auto: "
        f"quarantined {d['quarantined']} after batch 1 "
        f"({d['unserviced_rows']} rows failed over); arms {d['arms']} "
        f"({d['sources']}); launches {d['first_launches']} then "
        f"{d['second_launches']}")
    log(f"phase 13: pipelined depth 2 under {rep['pipelined']['cfg']}: equal "
        f"to fault-free; stats {rep['pipelined']['stats']}")
    s = rep["stall_forever"]
    log(f"phase 13: queue stalled forever: RemoteTimeout after "
        f"{s['raise_us'][0]:.1f} us and again after {s['raise_us'][1]:.1f} "
        f"us ({s['message']})")
    log(f"phase 13: small pipelined chaos ({rep['small']['schedule']}, "
        f"{rep['small']['p']} ranks x {rep['small']['nslots']} slots) "
        f"equal on CPU and GPU, stats {rep['small']['stats']}")


# ---------------------------------------------------------------------------
# Phases 14 and 15: the hot-bucket cache and the transaction engine
# ---------------------------------------------------------------------------
CACHE_FINDS = 16            # phase 14: find batches of P x N keys
CACHE_INSERT_EVERY = 8      # an insert batch of fresh keys after as many
CACHE_ALPHA = 1.1
CACHE_KW = dict(capacity=4096, ways=4, max_probes=8)
CACHE_PIPE_FINDS = 8        # the depth-2 cached stream counting syncs
CACHE_SMALL = dict(p=8, nslots=4096, n=128, fill=4, finds=8)
HOT_KEYS = 64               # the all-hit batch's keys
TXN_NOPS, TXN_BATCHES, TXN_ALPHA, TXN_HOT = 4, 6, 1.1, 24
TXN_WORDS = 64              # a hot key k addresses word k % 64 of rank k % P
TXN_RUN_ARMS = ("rdma", "rdma_fused", "am", "am_pt", "auto")
TXN_CHAOS_ARMS = ("rdma_fused", "am")
TXN_CHAOS_BATCHES = 2       # phase 13: of TXN_BATCHES


def zipf_draw(rng, universe: np.ndarray, shape, alpha: float) -> np.ndarray:
    """Keys drawn from `universe` with p(index r) ∝ 1/(r+1)^alpha (the
    caller shuffles the universe, so rank carries no other meaning)."""
    probs = 1.0 / np.arange(1, universe.size + 1, dtype=np.float64) ** alpha
    probs /= probs.sum()
    return universe[rng.choice(universe.size, size=shape, p=probs)]


class HostTimer:
    """Host seconds and calls of one method of an object (wrapped in
    place; a nested call counts in its caller's time too)."""

    def __init__(self, obj, name: str):
        self.s, self.calls = 0.0, 0
        fn = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0
                self.calls += 1
        setattr(obj, name, timed)

    def ms_per_call(self) -> float:
        return self.s * 1e3 / max(1, self.calls)


def cache_inputs(seed: int, p: int, n: int, fill_batches: int,
                 finds: int) -> dict:
    """Phase 14's stream from the seed: the fill (fill_batches x (p, n)
    distinct keys), the fresh insert batches, and the find batches drawn
    zipf(CACHE_ALPHA) from the filled keys (a shuffled universe)."""
    n_fresh = finds // CACHE_INSERT_EVERY
    keys = make_keys(seed + 1400, (fill_batches + n_fresh) * p * n)
    fill = keys[:fill_batches * p * n].reshape(fill_batches, p, n)
    fresh = keys[fill_batches * p * n:].reshape(n_fresh, p, n)
    rng = np.random.default_rng(seed + 1401)
    universe = fill.reshape(-1).copy()
    rng.shuffle(universe)
    return dict(fill=fill, fresh=fresh, universe=universe,
                finds=[zipf_draw(rng, universe, (p, n), CACHE_ALPHA)
                       for _ in range(finds)])


def filled_table(fill: np.ndarray, device, nslots: int):
    """A table filled with `fill` through the RPC insert (the quickest
    arm), its AM engine, and the keys whose insert succeeded (sorted)."""
    from repro_torch.core import hashtable as ht
    p = fill.shape[1]
    table, engine = fresh_ht(p, nslots, device)
    present = []
    for k in fill:
        table, ok, _ = ht.insert_rpc(table, engine, k, val_of(k)[..., None])
        present.append(k[ok.cpu().numpy()])
    return table, engine, np.sort(np.concatenate(present))


def is_in(keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """np.isin against a sorted array, without sorting it again."""
    i = np.searchsorted(sorted_keys, keys).clip(0, sorted_keys.size - 1)
    return sorted_keys[i] == keys


def check_finds(what: str, found, got, keys, present: np.ndarray) -> None:
    """found == the key is in `present` (sorted); its value val_of(key),
    0 otherwise."""
    want = is_in(keys, present)
    found, got = found.cpu().numpy(), got.cpu().numpy()[..., 0]
    if not np.array_equal(found, want):
        raise AssertionError(f"{what}: {int((found != want).sum())} finds "
                             f"disagree with the host oracle")
    if not np.array_equal(got, np.where(want, val_of(keys), 0)):
        raise AssertionError(f"{what}: found values differ from the "
                             f"host oracle")


def cache_arm(arm: str, table, engine, inputs: dict, present, device, sync,
              params, cache=None) -> dict:
    """Phase 14's stream on one arm from `table`: "plain" (the fused CR
    find, coalesced, no cache; inserts fused), "cached" (the same with
    `cache`, told of each insert first, the insert inside cache_scope) or
    "auto" (the front doors with a chooser holding `cache`). Every find is
    checked against the host oracle. Returns outputs, window, ms per find
    batch and the chooser."""
    from repro_torch.core import adaptive as ad, hashtable as ht, window
    chooser = None
    if arm == "auto":
        kw = {} if params is None else dict(params=params)
        chooser = ad.AdaptiveEngine(table.nranks, am_engine=engine,
                                    cache=cache, **kw)
    present = present.copy()
    outs, per, ins = [], [], 0
    for i, f in enumerate(inputs["finds"]):
        sync()
        t0 = time.perf_counter()
        if chooser is not None:
            table, found, got = ht.find(table, f, engine=engine,
                                        adaptive=chooser)
        else:
            table, found, got = ht.find_rdma(table, f, coalesce=True,
                                             cache=cache)
        sync()
        per.append(time.perf_counter() - t0)
        check_finds(f"phase 14: {arm} find {i}", found, got, f, present)
        outs.append((found, got))
        if (i + 1) % CACHE_INSERT_EVERY == 0:
            k = inputs["fresh"][ins]
            ins += 1
            v = val_of(k)[..., None]
            if chooser is not None:
                table, ok, _ = ht.insert(table, k, v, engine=engine,
                                         adaptive=chooser)
            else:
                if cache is not None:
                    cache.on_insert_keys(k, None, CACHE_KW["max_probes"])
                with window.cache_scope(cache):
                    table, ok, _ = ht.insert_rdma(table, k, v)
            present = np.sort(np.concatenate([present, k[ok.cpu().numpy()]]))
            outs.append(ok)
    return dict(outs=outs, data=table.win.data, per=per, table=table,
                chooser=chooser, present=present)


def all_hit_batch(table, engine, universe, present, device, counts,
                  p: int, n: int) -> dict:
    """A batch of the HOT_KEYS hottest present keys through a chooser
    forced to the cached fused arm, with a cache of its own: found until
    the cache holds the batch (a fill may evict a line that hit in the
    same batch), then once more, all-hit: that find must launch no kernel
    and log only its cache_hit."""
    import torch
    from repro_torch.core import adaptive as ad, cache as cm_
    from repro_torch.core import hashtable as ht, window
    hot = universe[is_in(universe, present)][:HOT_KEYS]
    keys = np.resize(hot, (p, n)).astype(np.int32)
    cache = cm_.BucketCache(p, table.nslots, VW, **CACHE_KW)
    chooser = ad.AdaptiveEngine(p, am_engine=engine, cache=cache)
    chooser.force_arm = "rdma_fused"
    for fills in range(1, 4):
        table, _, _ = ht.find(table, keys, engine=engine, adaptive=chooser)
        if cache.lookup(keys).all_hit:
            break
    torch.cuda.synchronize()
    counts()
    window.drain_phase_log()
    _, found, got = ht.find(table, keys, engine=engine, adaptive=chooser)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    roles = [(role, info) for role, _, info in window.drain_phase_log()]
    check_finds("phase 14: all-hit batch", found, got, keys, present)
    if launched or cache.last_hit_rate != 1.0 or [r for r, _ in roles] != [
            "cache_hit"] or not roles[0][1].get("all_hit"):
        raise AssertionError(f"phase 14: the all-hit batch launched "
                             f"{launched}, hit rate {cache.last_hit_rate}, "
                             f"logged {roles}")
    return dict(keys=int(hot.size), filling_finds=fills, launched=launched,
                logged=[r for r, _ in roles])


def cache_pipe_syncs(table, engine, finds: list, device, cache) -> dict:
    """The first CACHE_PIPE_FINDS find batches (host arrays) at depth 2
    through find_async, the chooser forced to the fused arm, with or
    without `cache`: the host syncs per submit and the outputs."""
    from repro_torch.core import adaptive as ad, hashtable as ht
    from repro_torch.core import pipeline as pl
    chooser = ad.AdaptiveEngine(table.nranks, am_engine=engine, cache=cache)
    chooser.force_arm = "rdma_fused"
    pipe = pl.Pipeline(table, depth=2, am_engine=engine)
    counter = SyncCounter()
    hs = [counter(lambda: ht.find_async(pipe, f, engine=engine,
                                        adaptive=chooser))
          for f in finds[:CACHE_PIPE_FINDS]]
    outs = [h.result() for h in hs]
    pipe.flush()
    return dict(syncs=counter.report(), outs=outs)


def cache_small(seed: int, device) -> dict:
    """Phase 14's cached and AUTO arms at CACHE_SMALL's size on `device`:
    outputs and windows on the host, and cache.stats() of each."""
    from repro_torch.core import cache as cm_
    s = CACHE_SMALL
    inputs = cache_inputs(seed + 7, s["p"], s["n"], s["fill"], s["finds"])
    out = {}
    for arm in ("cached", "auto"):
        table, engine, present = filled_table(inputs["fill"], device,
                                              s["nslots"])
        c = cm_.BucketCache(s["p"], s["nslots"], VW, **CACHE_KW)
        r = cache_arm(arm, table, engine, inputs, present, device,
                      lambda: None, None, c)
        out[arm] = dict(outs=[tuple(x.cpu() for x in o) if isinstance(o,
                              tuple) else o.cpu() for o in r["outs"]],
                        data=r["data"].cpu(), stats=c.stats())
    return out


def phase_cache(seed: int, device, sync, params, counts,
                fill_batches: int) -> dict:
    """Phase 14: the hot-bucket cache on phase 2's table (filled through
    the RPC insert), the zipf find stream with an insert batch of fresh
    keys after every CACHE_INSERT_EVERY finds, on the plain fused find, the
    same with a cache, and AUTO with a cache; then the all-hit batch, the
    depth-2 cached stream's syncs, and the small stream on both devices."""
    import torch
    from repro_torch.core import cache as cm_
    inputs = cache_inputs(seed, P, N, fill_batches, CACHE_FINDS)
    base, engine, present = filled_table(inputs["fill"], device, NSLOTS)
    sync()
    counts()
    runs, caches, timers = {}, {}, {}
    for arm in ("plain", "cached", "auto"):
        table = state_copy(base)
        c = None
        if arm != "plain":
            c = caches[arm] = cm_.BucketCache(P, NSLOTS, VW, **CACHE_KW)
            timers[arm] = (HostTimer(c, "lookup"),
                           HostTimer(c, "drain_fills"))
        runs[arm] = cache_arm(arm, table, engine, inputs, present, device,
                              sync, params, c)
        runs[arm]["launches"] = {k: v for k, v in counts().items() if v}
    plain, cached, auto = runs["plain"], runs["cached"], runs["auto"]
    same_outs(cached["outs"], plain["outs"], "phase 14: cached == plain")
    if not torch.equal(cached["data"], plain["data"]):
        raise AssertionError("phase 14: the final windows differ with and "
                             "without the cache")
    finds_auto = [o for o in auto["outs"] if isinstance(o, tuple)]
    finds_plain = [o for o in plain["outs"] if isinstance(o, tuple)]
    if not np.array_equal(auto["present"], plain["present"]):
        log("phase 14: AUTO's inserts succeeded on other keys than the "
            "fused arm's (RDMA and RPC fill differently); its finds are "
            "held to its own oracle")
    else:
        same_outs(finds_auto, finds_plain, "phase 14: auto == plain")
    hit = all_hit_batch(cached["table"], engine, inputs["universe"],
                        cached["present"], device, counts, P, N)
    syncs = {}
    for name, c in (("uncached", None), ("cached", cm_.BucketCache(
            P, NSLOTS, VW, **CACHE_KW))):
        syncs[name] = cache_pipe_syncs(base, engine, inputs["finds"],
                                       device, c)
    same_outs(syncs["cached"]["outs"], syncs["uncached"]["outs"],
              "phase 14: depth-2 cached == uncached")
    if syncs["cached"]["syncs"]["per_submit"] > \
            syncs["uncached"]["syncs"]["per_submit"]:
        raise AssertionError(f"phase 14: the cache adds host syncs at "
                             f"depth 2: {syncs['cached']['syncs']} against "
                             f"{syncs['uncached']['syncs']}")
    small_g, small_c = cache_small(seed, device), cache_small(seed, "cpu")
    for arm in small_c:
        same_outs(small_g[arm]["outs"], small_c[arm]["outs"],
                  f"phase 14: small {arm} GPU vs CPU")
        if not torch.equal(small_g[arm]["data"], small_c[arm]["data"]) or \
                small_g[arm]["stats"] != small_c[arm]["stats"]:
            raise AssertionError(f"phase 14: small {arm}: window or cache "
                                 f"stats differ GPU vs CPU")
    med = {arm: statistics.median(r["per"]) * 1e3 for arm, r in runs.items()}
    return dict(
        table=cached["table"], engine=engine,
        present_keys=cached["present"],
        finds=CACHE_FINDS, insert_every=CACHE_INSERT_EVERY,
        fill_batches=fill_batches, present=int(present.size), ms=med,
        stats={arm: c.stats() for arm, c in caches.items()},
        host_ms={arm: dict(lookup=t[0].ms_per_call(),
                           drain_fills=t[1].ms_per_call(),
                           lookups=t[0].calls)
                 for arm, t in timers.items()},
        launches={arm: r["launches"] for arm, r in runs.items()},
        auto_arms=[d.arm for d in auto["chooser"].log],
        auto_cached=sum(d.cached for d in auto["chooser"].log),
        all_hit=hit,
        depth2_syncs={k: v["syncs"] for k, v in syncs.items()},
        small=dict(stats={a: small_c[a]["stats"] for a in small_c},
                   **CACHE_SMALL))


def log_cache(rep: dict, card: str) -> None:
    ms = rep["ms"]
    log(f"phase 14: median ms per find batch of {P} x {N}: plain fused "
        f"{ms['plain']:.3f}, cached {ms['cached']:.3f} "
        f"({ms['cached'] / ms['plain']:.3f}x), auto with the cache "
        f"{ms['auto']:.3f} ({card})")
    for arm, st in rep["stats"].items():
        h = rep["host_ms"][arm]
        log(f"phase 14: {arm}: hit rate {st['hit_rate']:.4f}; stats {st}; "
            f"host ms per lookup {h['lookup']:.3f} (drain included), per "
            f"drain_fills {h['drain_fills']:.3f}")
    log(f"phase 14: launches by arm {rep['launches']}; AUTO's arms "
        f"{rep['auto_arms']} ({rep['auto_cached']} cached)")
    log(f"phase 14: all-hit batch of the {rep['all_hit']['keys']} hottest "
        f"keys (after {rep['all_hit']['filling_finds']} filling finds): "
        f"launched {rep['all_hit']['launched']}, logged "
        f"{rep['all_hit']['logged']}")
    log(f"phase 14: depth-2 finds, host syncs per submit: uncached "
        f"{rep['depth2_syncs']['uncached']}, cached "
        f"{rep['depth2_syncs']['cached']}")
    log(f"phase 14: small stream ({rep['small']['p']} ranks x "
        f"{rep['small']['nslots']} slots) equal on CPU and GPU, stats "
        f"{rep['small']['stats']}")


def txn_inputs(seed: int, p: int, batches: int = TXN_BATCHES) -> dict:
    """Phase 15's stream after the JAX package's bench_txn: per batch and
    op, a (p,) column of keys drawn zipf(TXN_ALPHA) from TXN_HOT hot keys,
    each addressing word k % TXN_WORDS of rank k % p, an op kind and its
    operands; and the hot words' initial values."""
    rng = np.random.default_rng(seed + 1500)
    universe = rng.choice(2 ** 30, TXN_HOT, replace=False) + 1
    hot = zipf_draw(rng, universe, (p, TXN_NOPS * batches), TXN_ALPHA)
    ops = []
    for b in range(batches):
        brng = np.random.default_rng(seed * 1000 + b)
        for j in range(TXN_NOPS):
            k = hot[:, b * TXN_NOPS + j]
            kind = int(brng.integers(0, 4))
            a = (brng.integers(-50, 50, p) if kind == 2 else
                 brng.integers(-3, 4, p) if kind == 3 else None)
            bb = (brng.integers(-9, 9, p) if kind in (0, 2) else None)
            ops.append((b, kind, k % p, k % TXN_WORDS, a, bb))
    return dict(ops=ops, batches=batches,
                init=rng.integers(-50, 50, (p, TXN_WORDS)).astype(np.int32))


def txn_stage(inputs: dict, b: int, p: int):
    from repro_torch.core import txn
    t = txn.Txn(p)
    for bb, kind, dst, off, a, v in inputs["ops"]:
        if bb != b:
            continue
        if kind == 0:
            t.put(dst, off, v)
        elif kind == 1:
            t.get(dst, off)
        elif kind == 2:
            t.cas(dst, off, a, v)
        else:
            t.fao(dst, off, a)
    return t


def txn_window(inputs: dict, device, p: int, words: int):
    """A window of `words` words a rank whose first TXN_WORDS hold the
    hot words' initial values."""
    import torch
    from repro_torch.core import window
    data = torch.zeros((p, words), dtype=torch.int32, device=device)
    data[:, :TXN_WORDS] = torch.as_tensor(inputs["init"], device=device)
    return window.Window(data=data)


def txn_run(arm: str, inputs: dict, device, sync, params, p: int,
            words: int, batches: int, cfg=None, counter=None,
            mark=no_mark) -> dict:
    """`batches` txn batches on `arm` (a fresh engine; "auto" prices with
    `params`), under cfg's plan when given. Each batch is held to the
    serial oracle: its committed order replayed through serial_apply on
    the hot words gives its replies and window, and no other word moves."""
    from repro_torch.core import adaptive as ad, am, faults as flt, txn
    eng_am = am.AMEngine(p)
    kw = {} if params is None else dict(params=params)
    chooser = (ad.AdaptiveEngine(p, am_engine=eng_am, **kw)
               if arm == "auto" else None)
    eng = txn.TxnEngine(p, am_engine=eng_am, adaptive=chooser)
    win = txn_window(inputs, device, p, words)
    plan = None if cfg is None else flt.FaultPlan(p, **cfg)
    wrap = counter or (lambda fn: fn())
    res_all, per = [], []
    with flt.fault_scope(plan):
        for b in range(batches):
            t = txn_stage(inputs, b, p)
            st0 = {"ht": win.data[:, :TXN_WORDS].cpu().numpy()}
            mark(f"txn {arm}" if cfg is None else None)
            sync()
            t0 = time.perf_counter()
            res = wrap(lambda: eng.run(win, t, arm=arm))
            sync()
            per.append(time.perf_counter() - t0)
            mark(None)
            win = res.wins["ht"]
            rep, st = txn.serial_apply(st0, t, [q for _, q in res.order])
            hot_now = win.data[:, :TXN_WORDS].cpu().numpy()
            if not (np.array_equal(rep, res.replies)
                    and np.array_equal(st["ht"], hot_now)
                    and not bool(win.data[:, TXN_WORDS:].any())):
                raise AssertionError(f"phase 15: {arm} batch {b}"
                                     f"{'' if cfg is None else ' ' + str(cfg)}"
                                     f": the serial replay of its order "
                                     f"differs")
            res_all.append(res)
    return dict(res=res_all, per=per, data=win.data,
                stats=None if plan is None else plan.stats())


def same_txn(a: dict, b: dict, what: str) -> None:
    import torch
    for i, (x, y) in enumerate(zip(a["res"], b["res"])):
        if not (np.array_equal(x.replies, y.replies)
                and np.array_equal(x.committed, y.committed)
                and np.array_equal(x.chain_ok, y.chain_ok)):
            raise AssertionError(f"{what}: batch {i} differs")
    if not torch.equal(a["data"], b["data"]):
        raise AssertionError(f"{what}: final windows differ")


def phase_txn(seed: int, device, sync, params, counts, table, engine,
              present: np.ndarray, mark=no_mark) -> dict:
    """Phase 15: the txn stream on every arm over a window of phase 2's
    shape, then `move` of P keys on phase 14's full table and
    `pop_then_insert` of P items from a queue of phase 2's capacity into
    it, each against a host oracle."""
    import torch
    from repro_torch.core import hashtable as ht, queue as dq, txn
    words = NSLOTS * (2 + VW)
    inputs = txn_inputs(seed, P)
    report = dict(arms={}, batches=TXN_BATCHES, nops=TXN_NOPS,
                  hot=TXN_HOT, alpha=TXN_ALPHA, words=words)
    counts()
    for arm in TXN_RUN_ARMS:
        counter = SyncCounter()
        r = txn_run(arm, inputs, device, sync, params, P, words,
                    TXN_BATCHES, counter=counter, mark=mark)
        launched = {k: v for k, v in counts().items() if v}
        res = r["res"]
        rounds = sorted(x.rounds for x in res)
        attempts = sum(int(x.attempts.sum()) for x in res)
        one_sided = {x.arm for x in res} <= {"rdma", "rdma_fused"}
        if not launched.get("txn_group_apply") or (
                one_sided and not launched.get("amo_apply")):
            raise AssertionError(f"phase 15: {arm} launched {launched}")
        report["arms"][arm] = dict(
            us_per_txn=sum(r["per"]) / (TXN_BATCHES * P) * 1e6,
            abort_rate=sum(x.aborts for x in res) / max(1, attempts),
            rounds_median=rounds[len(rounds) // 2],
            rounds=[x.rounds for x in res],
            saved_reads=sum(x.saved_reads for x in res),
            chain_aborts=sum(x.chain_aborts for x in res),
            syncs_per_round=counter.total / max(1, sum(rounds)),
            arms_run=sorted({x.arm for x in res}), launches=launched)
    # move P present keys (one a rank) to fresh keys on the full table
    rng = np.random.default_rng(seed + 1510)
    k1 = rng.choice(present, P, replace=False).astype(np.int32)
    k2 = make_keys(seed + 1511, 4 * P)
    k2 = k2[~is_in(k2, present)][:P]
    eng = txn.TxnEngine(P, am_engine=engine)
    sync()
    t0 = time.perf_counter()
    table, moved, mvals = ht.move(table, k1, k2, eng, arm="rdma_fused")
    sync()
    move_s = time.perf_counter() - t0
    _, f1, _ = ht.find_rdma(table, k1[:, None])
    _, f2, v2 = ht.find_rdma(table, k2[:, None])
    if not (moved.all() and np.array_equal(mvals[:, 0], val_of(k1))
            and not bool(f1.any()) and bool(f2.all())
            and np.array_equal(v2.cpu().numpy()[:, 0, 0], val_of(k1))):
        raise AssertionError(f"phase 15: move: moved {int(moved.sum())} of "
                             f"{P}, or the table disagrees with the oracle")
    # pop P items from a queue of phase 2's capacity (payload cut to the
    # table's one value word) into the table
    q = dq.make_queue(P, Q_HOST, Q_CAP, VW, device=device)
    items = make_keys(seed + 1512, 4 * P)
    items = items[~is_in(items, present) & ~np.isin(items, k2)][:P]
    q, pushed = dq.push_rdma(q, items.reshape(P, 1, 1))
    if not bool(pushed.all()):
        raise AssertionError("phase 15: the queue push failed")
    counts()
    sync()
    t0 = time.perf_counter()
    q, table, popped, pvals = dq.pop_then_insert(q, table, eng,
                                                 arm="rdma_fused")
    sync()
    pop_s = time.perf_counter() - t0
    pop_launches = {k: v for k, v in counts().items() if v}
    _, f, got = ht.find_rdma(table, pvals[:, 0][:, None])
    head = int(q.win.data[Q_HOST, dq.HEAD])
    if not (popped.all() and sorted(pvals[:, 0]) == sorted(items)
            and bool(f.all()) and head == P
            and np.array_equal(got.cpu().numpy()[:, 0, 0], pvals[:, 0])):
        raise AssertionError(f"phase 15: pop_then_insert: popped "
                             f"{int(popped.sum())} of {P}, head {head}, or "
                             f"the table disagrees with the oracle")
    report.update(move=dict(keys=P, s=move_s), pop_then_insert=dict(
        items=P, s=pop_s, launches=pop_launches))
    return report


def log_txn(rep: dict, card: str) -> None:
    for arm, r in rep["arms"].items():
        log(f"phase 15: txn {arm} (ran {r['arms_run']}): "
            f"{r['us_per_txn']:.1f} us per txn, abort rate "
            f"{r['abort_rate']:.4f}, rounds {r['rounds']} (median "
            f"{r['rounds_median']}), saved reads {r['saved_reads']}, chain "
            f"aborts {r['chain_aborts']}, host syncs per round "
            f"{r['syncs_per_round']:.2f}; launches {r['launches']} ({card})")
    log(f"phase 15: move of {rep['move']['keys']} keys on the full table "
        f"{rep['move']['s'] * 1e3:.1f} ms; pop_then_insert of "
        f"{rep['pop_then_insert']['items']} items "
        f"{rep['pop_then_insert']['s']:.2f} s, launches "
        f"{rep['pop_then_insert']['launches']} ({card})")


def txn_chaos(seed: int, device, sync, params, p: int, words: int) -> dict:
    """Phase 13's txn streams: TXN_CHAOS_BATCHES batches of phase 15's
    stream on each of TXN_CHAOS_ARMS under each schedule, equal to the
    fault-free run."""
    inputs = txn_inputs(seed, p, TXN_CHAOS_BATCHES)
    out = {}
    for arm in TXN_CHAOS_ARMS:
        clean = txn_run(arm, inputs, device, sync, params, p, words,
                        TXN_CHAOS_BATCHES)
        rep = out[arm] = dict(clean_ms=statistics.median(clean["per"]) * 1e3)
        for name, cfg in CHAOS_SCHEDULES:
            r = txn_run(arm, inputs, device, sync, params, p, words,
                        TXN_CHAOS_BATCHES, cfg=cfg)
            same_txn(r, clean, f"phase 13: txn {arm} under {name}")
            rep[name] = dict(ms=statistics.median(r["per"]) * 1e3,
                             stats=r["stats"],
                             rounds=[x.rounds for x in r["res"]])
    return out


# ---------------------------------------------------------------------------
# Phases 5 to 9: the serving and prefill paths
# ---------------------------------------------------------------------------
def describe(cfg, model) -> tuple:
    """(a line of the config's widths and the parameters and bytes on the
    card, the bytes); raises unless the count is the config's
    (params_count() leaves out the final norm, the padded vocab rows and
    the RG-LRU blocks' a_param)."""
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    R = cfg.rnn_width or cfg.d_model
    n_rglru = sum(kinds.count("rglru") for kinds in cfg.layer_pattern())
    want = (cfg.params_count() + cfg.d_model
            + (cfg.vocab_padded - cfg.vocab) * cfg.d_model
            + cfg.n_groups * n_rglru * R)
    if n_params != want:
        raise AssertionError(f"{cfg.name}: {n_params} parameters on the "
                             f"card, the config gives {want}")
    kinds = sorted({k for ks in cfg.layer_pattern() for k in ks})
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k} + "
           f"{cfg.n_shared_experts} shared" if cfg.n_experts else "")
    rnn = (f", RG-LRU width {R}, window {cfg.local_window}"
           if n_rglru else "")
    return (f"{cfg.name}: {cfg.n_layers} layers of {kinds}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} ({cfg.n_kv_heads}"
            f" kv), d_ff {cfg.d_ff}{moe}{rnn}, vocab {cfg.vocab}, "
            f"{cfg.dtype}: {n_params} parameters ({cfg.params_count()} "
            f"by params_count), {w_bytes} bytes on the card"), w_bytes


def state_bytes(state, steps: int) -> int:
    """Bytes a decode step must move besides the weights, at step `steps`:
    K and V of the valid slots of every attention cache, each RG-LRU
    state read and written."""
    total = 0
    for caches in state["caches"]:
        for c in caches:
            if isinstance(c, dict):
                B, W = c["k"].shape[:2]
                row = c["k"][0, 0].numel() * c["k"].element_size()
                total += 2 * B * min(steps, W) * row
            elif c is not None:
                total += 2 * c.numel() * c.element_size()
    return total


def phase_serve(serve_cfg: dict, seed: int, device, phase: int,
                mark=no_mark) -> dict:
    """The config at full width through repro_torch.launch.serve:
    serve_cfg["batch"] requests, prompts fed token by token, then greedy
    generation. `mark(tag)` names the first and the last decode step
    ("<arch> first step" / "<arch> last step"; "serve ..." for phase 5).
    The caller zeroes the launch counts before and reads them after."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = registry.get(serve_cfg["arch"])
    B, P_len = serve_cfg["batch"], serve_cfg["prompt_len"]
    G = serve_cfg["gen_len"]
    steps = P_len + G
    tag = "serve" if phase == 5 else cfg.name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    text, w_bytes = describe(cfg, model)
    log(f"phase {phase}: {text}, built in {init_s:.2f} s")
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                    (B, P_len))

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])

    def on_step(t):
        mark(f"{tag} first step" if t == 1 else
             f"{tag} last step" if t == steps else None)
        if t == steps - PROFILE_STEPS + 1:
            prof.__enter__()

    t0 = time.perf_counter()
    gen, times, state = serve.generate(model, prompts, G, on_step=on_step,
                                       sync=torch.cuda.synchronize)
    total_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    mark(None)
    max_mem = torch.cuda.max_memory_allocated(device)
    gen = gen.cpu()
    if tuple(gen.shape) != (B, G + 1) or len(times) != steps:
        raise AssertionError(f"serve: {tuple(gen.shape)} tokens in "
                             f"{len(times)} steps")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError("serve: a generated token is outside the vocab")
    # bound of one step: every weight read once, plus the caches and
    # states of the last step
    extra = state_bytes(state, steps)
    step_ms = statistics.median(times) * 1e3
    return dict(model=model, state=state, gen=gen, prompts=prompts,
                report=dict(
        arch=cfg.name, layers=cfg.n_layers, batch=B, prompt_len=P_len,
        gen_len=G, steps=steps,
        params=sum(p.numel() for p in model.parameters()),
        weight_bytes=w_bytes, init_s=init_s, max_memory_allocated=max_mem,
        step_ms_median=step_ms, step_ms_min=min(times) * 1e3,
        step_ms_max=max(times) * 1e3, total_s=total_s,
        tok_per_s=B * steps / sum(times),
        generated_tok_per_s=B * G / total_s,
        step_bound_ms_weights=w_bytes / HBM_BYTES_PER_S * 1e3,
        step_bound_ms=(w_bytes + extra) / HBM_BYTES_PER_S * 1e3,
        backends={k: v.value for k, v in sorted(state["backends"].items())},
        first_tokens=gen[:2, :8].tolist(),
        profile=profile_summary(prof, times[-PROFILE_STEPS:], step_ms,
                                phase)))


def expected_prefill_launches(cfg, S: int) -> dict:
    """The kernels a forward over S tokens launches, each at least once:
    flash_attention once per attention layer, or min(8, S // 1024) query
    chunks each past 2 x 1024 tokens (chunked_flash's causal-skip split);
    rg_lru_scan once per RG-LRU layer; moe_dispatch once per MoE layer."""
    kinds = [k for ks in cfg.layer_pattern() for k in ks] * cfg.n_groups
    chunks = min(8, S // 1024) if S > 2 * 1024 else 1
    want = {"flash_attention": chunks * sum(k in ("attn", "lattn")
                                            for k in kinds),
            "rg_lru_scan": kinds.count("rglru"),
            "moe_dispatch": kinds.count("moe")}
    return {name: n for name, n in want.items() if n}


def edge_fault_rejected(args, kw, phase: str) -> dict:
    """The limit flash_attention is held to must reject a kernel whose
    mask edge is one key off: here the plain version with the window one
    key short (each row loses its oldest key) or, without a window, the
    causal frontier one key short (each row loses its newest key: the
    last key dropped, so the end alignment moves one back) against the
    plain version, on the kept inputs. Returns that output's max abs
    error, the limit and which edge moved."""
    import torch
    from repro_torch.kernels import ref as kref
    q, k, v = args
    want = plain_mha(q, k, v, **kw)
    if kw.get("window", 0) > 0:
        edge = "window"
        short = plain_mha(q, k, v, **{**kw, "window": kw["window"] - 1})
    else:
        edge = "causal frontier"
        short = plain_mha(q, k[:, :, :-1], v[:, :, :-1], **kw)
    tol = kref.mha_tol(want)
    try:
        torch.testing.assert_close(short, want, **tol)
    except AssertionError:
        return dict(max_abs_err=float((short.float() - want.float()).abs()
                                      .max()), edge=edge, **tol)
    raise AssertionError(f"phase {phase}: the flash_attention limit {tol} "
                         f"accepts the {edge} one key short")


def bwd_same_bits(device, case=(1, 16, 1, 256, 1100, 256, True, 300)
                  ) -> str:
    """flash_attention_bwd has no atomics: two runs of a bf16 case whose
    dK/dV grid splits the query heads into groups (their partials summed
    in group order) must give the same bits. Returns what it checked."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as kfab, ref as kref
    from repro_torch.kernels import lane_cases as lc
    kw = dict(causal=case[6], window=case[7])
    q, k, v, do = (torch.as_tensor(x).to(device, torch.bfloat16
                                         ).transpose(1, 2)
                   for x in lc.flash_bwd_inputs(case))
    o, lse = kref.flash_fwd_lse(q, k, v, **kw)
    B, H, S, d = q.shape
    plan = kfab.launch_plan(B, S, k.shape[2], H, k.shape[1], d, q.dtype,
                            device)
    if plan["groups"] < 2:
        raise AssertionError(f"phase 1: the same-bits case does not split "
                             f"its query heads: {plan}")
    runs = [kfab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            for _ in range(2)]
    for part, x, y in zip(("dq", "dk", "dv"), *runs):
        if not torch.equal(x.view(torch.int16), y.view(torch.int16)):
            raise AssertionError(f"phase 1: flash_attention_bwd's {part} "
                                 f"differs between two runs of {case}")
    return (f"flash_attention_bwd gives the same bits twice on {case} "
            f"(bf16, {plan['groups']} groups of query heads)")


def bwd_edge_fault_rejected(args, kw, phase: str) -> dict:
    """The limit flash_attention_bwd is held to (kernels/ref.py
    flash_bwd_tol) must reject a backward whose mask edge is one key off:
    the plain version with the window one key short or, without a
    window, the causal frontier one key short (the last key dropped, so
    each row loses its newest key; its dk and dv rows stay 0), on the
    same inputs. Returns the first output it rejects, that output's max
    abs error, the limit and which edge moved."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    q, k, v, o, lse, do = args
    want = kref.flash_bwd(*args, **kw)
    if kw.get("window", 0) > 0:
        edge = "window"
        short = kref.flash_bwd(*args, **{**kw, "window": kw["window"] - 1})
    else:
        edge = "causal frontier"
        dq, dk, dv = kref.flash_bwd(q, k[:, :, :-1], v[:, :, :-1], o, lse,
                                    do, **kw)
        short = (dq, F.pad(dk, (0, 0, 0, 1)), F.pad(dv, (0, 0, 0, 1)))
    for part, got, w in zip(("dq", "dk", "dv"), short, want):
        tol = kref.flash_bwd_tol(w)
        try:
            torch.testing.assert_close(got, w, **tol)
        except AssertionError:
            return dict(edge=edge, output=part, max_abs_err=float(
                (got.float() - w.float()).abs().max()), **tol)
    raise AssertionError(f"phase {phase}: the flash_attention_bwd limit "
                         f"accepts the {edge} one key short")


def prefill_flops(model, B: int, S: int) -> tuple:
    """(matrix-product flops, attention flops) a prefill must do: 2 per
    weight and token in the products (each token through its top_k
    experts; the embedding read as rows; the logits of the last position
    only) and 4 d per live (q, k) pair and head in each attention layer
    (full causal, or over its window for local attention)."""
    import torch
    cfg = model.cfg
    n_mat = sum(p.numel() for name, p in model.named_parameters()
                if p.dim() == 2 and name != "embed")
    n_expert = sum(p[0].numel() for p in model.parameters() if p.dim() == 3)
    mat = (2 * (n_mat + cfg.top_k * n_expert) * B * S
           + 2 * cfg.d_model * cfg.vocab_padded * B)
    q = torch.empty((B, cfg.n_heads, S, cfg.hd), device="meta")
    k = torch.empty((B, cfg.n_kv_heads, S, cfg.hd), device="meta")
    attn = 0
    kinds = [kd for ks in cfg.layer_pattern() for kd in ks] * cfg.n_groups
    for kind in kinds:
        if kind in ("attn", "lattn"):
            window = cfg.local_window if kind == "lattn" else 0
            attn += 4 * cfg.hd * live_pairs((q, k), dict(causal=True,
                                                          window=window))
    return mat, attn


def phase_prefill(model, seed: int, device, phase: str, tag: str,
                  prompts=None, gen_len: int = 0):
    """make_prefill_step on PREFILL["batch"] x PREFILL["seq_len"] tokens
    (the cut printed), three times: under a Capture keeping the last call
    of each kernel (marked `tag`; held against the plain versions and
    timed right after; the limit of flash_attention must reject its mask
    edge one key short there), timed (with peak memory), traced. Each run
    zeroes the counts before and reads them after: every kernel must
    launch as expected_prefill_launches says, and no other. Then, not
    gated and only given `prompts`, the last-position logits of a prefill
    of the prompts against a decode of them over a cache of their length
    + gen_len + 1. Returns (report, kernel rows)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = model.cfg
    B, S = PREFILL["batch"], PREFILL["seq_len"]
    cut = (f"batch {PREFILL['shape_batch']} -> {B} of the "
           f"{PREFILL['shape']} shape")
    log(f"cut: phase {phase} prefills {B} x {S} tokens of {cfg.name}, "
        f"{cut}")
    want = expected_prefill_launches(cfg, S)
    step = steps.make_prefill_step(cfg)
    tokens = torch.as_tensor(np.random.default_rng(seed + 8).integers(
        0, cfg.vocab, (B, S)).astype(np.int32), device=device)
    sync = torch.cuda.synchronize

    def run(what: str):
        zero_counts()
        sync()
        t0 = time.perf_counter()
        logits = step(model, {"tokens": tokens})
        sync()
        dt = time.perf_counter() - t0
        counts = read_counts(tuple(want))
        got = {name: counts[name] for name in want}
        if got != want or any(counts[n] for n in counts if n not in want):
            raise AssertionError(f"phase {phase} ({what}): launches "
                                 f"{counts}, want {want}")
        if (tuple(logits.shape) != (B, cfg.vocab_padded)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"phase {phase} ({what}): logits "
                                 f"{tuple(logits.shape)} or not finite")
        return logits, dt, got

    with Capture(last=True) as capture:
        capture.mark(tag)
        logits, first_s, counts = run("captured")
    rows = phase_captured(capture.calls, tuple(want), phase)
    limit_check = edge_fault_rejected(
        *capture.calls[("flash_attention", tag)], phase)
    lc = limit_check
    log(f"phase {phase}: the flash_attention limit (rtol {lc['rtol']:.6g}, "
        f"atol {lc['atol']:.6g}) rejects the {lc['edge']} one key short at "
        f"the last call (max abs err {lc['max_abs_err']:.6g})")
    del capture
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base_mem = torch.cuda.memory_allocated(device)
    logits, prefill_s, _ = run("timed")
    max_mem = torch.cuda.max_memory_allocated(device)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        _, traced_s, _ = run("traced")
    profile = profile_summary(prof, [traced_s], prefill_s * 1e3, phase)
    del logits
    mat_flops, attn_flops = prefill_flops(model, B, S)
    bound_s = (mat_flops + attn_flops) / PEAK_FLOPS["torch.bfloat16"]
    report = dict(arch=cfg.name, batch=B, seq_len=S, cut=cut,
                  launches=counts,
                  first_s=first_s, prefill_s=prefill_s, traced_s=traced_s,
                  tok_per_s=B * S / prefill_s, max_memory_allocated=max_mem,
                  memory_before=base_mem, matmul_flops=mat_flops,
                  attention_flops=attn_flops, bound_s=bound_s,
                  profile=profile, limit_check=limit_check)
    if prompts is None:
        return report, rows
    # cross-check against a decode of the prompts (printed, not gated)
    prompts = torch.as_tensor(prompts.astype(np.int32), device=device)
    state = lm.init_decode_state(cfg, prompts.shape[0], prompts.shape[1]
                                 + gen_len + 1, device=device)
    for t in range(prompts.shape[1]):
        ref, state = lm.decode_step(model, state, prompts[:, t])
    del state
    ref = ref.float()
    cross = step(model, {"tokens": prompts}).float()
    report["cross_check"] = dict(
        prompts=list(prompts.shape),
        max_abs_err=float((cross - ref).abs().max()),
        argmax_agree=float((cross.argmax(-1) == ref.argmax(-1)).float()
                           .mean()),
        logits_scale=float(ref.abs().max()))
    return report, rows


def phase_rgemma_cpu_vs_gpu(seed: int, device) -> dict:
    """Reduced recurrentgemma-9b in float32, weights built once on the CPU
    and moved, TF32 off: the train-mode forward's logits at every one of
    RGEMMA_STEPS positions, and RGEMMA_STEPS teacher-forced decode steps at
    max_len RGEMMA_STEPS (rings of local_window slots wrap), CPU against
    GPU within LOGITS_TOL; on each device, decode at step t against the
    forward at position t within DECODE_VS_PREFILL_TOL. Then the forward
    over SPLIT_LEN tokens, CPU against GPU within LOGITS_TOL at every
    position, where flash_attention must launch once for each query chunk
    of chunked_flash's split in each local-attention layer."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get(RGEMMA).reduced()
    cpu = lm.init_lm(cfg, seed, "cpu")
    gpu = copy.deepcopy(cpu).to(device)
    B, L = 2, RGEMMA_STEPS
    tok = torch.as_tensor(np.random.default_rng(seed + 9).integers(
        0, cfg.vocab, (B, L)).astype(np.int32))
    full = {}
    for dev, m in (("cpu", cpu), ("gpu", gpu)):
        full[dev] = lm.logits_fn(m, cfg, lm._forward(
            m, cfg, tok.to(m.embed.device))).cpu()
    try:
        torch.testing.assert_close(full["gpu"], full["cpu"], **LOGITS_TOL)
    except AssertionError as e:
        raise AssertionError(f"phase 9: forward logits differ CPU vs GPU: "
                             f"{e}") from None
    worst = dict(cpu_vs_gpu=float((full["gpu"] - full["cpu"]).abs().max()),
                 decode_vs_forward=0.0)
    states = {"cpu": lm.init_decode_state(cfg, B, L, device="cpu"),
              "gpu": lm.init_decode_state(cfg, B, L, device=device)}
    for t in range(L):
        out = {}
        for dev, m in (("cpu", cpu), ("gpu", gpu)):
            lg, states[dev] = lm.decode_step(m, states[dev],
                                             tok[:, t].to(m.embed.device))
            out[dev] = lg.cpu()
            try:
                torch.testing.assert_close(out[dev], full[dev][:, t],
                                           **DECODE_VS_PREFILL_TOL)
            except AssertionError as e:
                raise AssertionError(f"phase 9: {dev} decode != forward at "
                                     f"step {t}: {e}") from None
            worst["decode_vs_forward"] = max(
                worst["decode_vs_forward"],
                float((out[dev] - full[dev][:, t]).abs().max()))
        try:
            torch.testing.assert_close(out["gpu"], out["cpu"], **LOGITS_TOL)
        except AssertionError as e:
            raise AssertionError(f"phase 9: decode logits differ CPU vs GPU "
                                 f"at step {t}: {e}") from None
        worst["cpu_vs_gpu"] = max(worst["cpu_vs_gpu"], float(
            (out["gpu"] - out["cpu"]).abs().max()))
    ring = min(cfg.local_window, L)
    tok = torch.as_tensor(np.random.default_rng(seed + 10).integers(
        0, cfg.vocab, (1, SPLIT_LEN)).astype(np.int32))
    split = {"cpu": lm.logits_fn(cpu, cfg, lm._forward(cpu, cfg, tok))}
    zero_counts()
    split["gpu"] = lm.logits_fn(gpu, cfg, lm._forward(
        gpu, cfg, tok.to(device))).cpu()
    counts = read_counts(())
    want = expected_prefill_launches(cfg, SPLIT_LEN)
    if {name: counts[name] for name in want} != want:
        raise AssertionError(f"phase 9: the forward over {SPLIT_LEN} tokens "
                             f"launched {counts}, want {want}")
    try:
        torch.testing.assert_close(split["gpu"], split["cpu"], **LOGITS_TOL)
    except AssertionError as e:
        raise AssertionError(f"phase 9: forward logits over {SPLIT_LEN} "
                             f"tokens differ CPU vs GPU: {e}") from None
    return dict(steps=L, ring=ring, wraps=L > ring, split_len=SPLIT_LEN,
                split_launches=want, split_cpu_vs_gpu=float(
                    (split["gpu"] - split["cpu"]).abs().max()), **worst)


def profile_summary(prof, window_s, step_ms: float, phase: int) -> dict:
    """Device time per step by kernel over the traced steps, and the
    device's idle share: against the traced steps' own wall time (the
    tracer slows the host), and against the untraced median step."""
    from torch.autograd import DeviceType
    n = len(window_s)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in rows) / 1e3 / n
    if not rows:
        log(f"phase {phase}: the profiler recorded no device time")
        return dict(steps=n, device_ms_per_step=None)
    wall_ms = sum(window_s) * 1e3 / n
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return dict(
        steps=n, traced_wall_ms_per_step=wall_ms,
        device_ms_per_step=busy_ms,
        idle_share_traced=1 - busy_ms / wall_ms,
        idle_share_vs_median=1 - busy_ms / step_ms,
        top=[dict(name=k[:100], ms_per_step=t / 1e3 / n,
                  calls_per_step=c / n) for k, t, c in top])


def batch_profile(prof, wall_s: float, median_ms: float) -> dict:
    """One traced data-structure batch: profile_summary's device busy time
    and idle shares, and the device ms of each owner lane (its copy and
    apply kernels) in the batch."""
    from torch.autograd import DeviceType
    pr = profile_summary(prof, [wall_s], median_ms, 2)
    pr["lane_ms"] = {name: sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and name in e.key) / 1e3
        for name in ("amo_apply", "fused_apply")}
    return pr


def log_batch_profile(what: str, pr: dict, card: str) -> None:
    if pr.get("device_ms_per_step") is None:
        return
    lanes = ", ".join(f"{k} {v:.3f} ms" for k, v in pr["lane_ms"].items())
    log(f"profile of one {what} batch: device busy "
        f"{pr['device_ms_per_step']:.3f} ms of a traced "
        f"{pr['traced_wall_ms_per_step']:.3f} ms (idle "
        f"{pr['idle_share_traced']:.3f}), idle "
        f"{pr['idle_share_vs_median']:.3f} of the untraced median; owner "
        f"lanes {lanes} ({card})")


def check_last_logits(served: dict) -> None:
    """One more decode step past the run: logits of the full vocab for
    every request, all finite."""
    import torch
    from repro_torch.models import lm
    model, gen = served["model"], served["gen"]
    logits, _ = lm.decode_step(model, served["state"],
                               gen[:, -1].to(model.embed.device))
    want = (gen.shape[0], model.cfg.vocab_padded)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"serve: logits {tuple(logits.shape)} (want "
                             f"{want}) or not finite")


def phase_model_cpu_vs_gpu(seed: int, device) -> dict:
    """Reduced deepseek-moe-16b in float32, weights built once on the CPU
    and moved, MODEL_STEPS teacher-forced decode steps on both devices:
    logits within LOGITS_TOL. Returns the greedy tokens of both and the
    largest difference."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get(SERVE["arch"]).reduced()
    cpu = lm.init_lm(cfg, seed, "cpu")
    gpu = copy.deepcopy(cpu).to(device)
    B = 4
    states = [lm.init_decode_state(cfg, B, MODEL_STEPS, device=d)
              for d in ("cpu", device)]
    rng = np.random.default_rng(seed + 6)
    toks, worst, gap = {"cpu": [], "gpu": []}, 0.0, float("inf")
    for step in range(MODEL_STEPS):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, B).astype(np.int32))
        lc, states[0] = lm.decode_step(cpu, states[0], tok)
        lg, states[1] = lm.decode_step(gpu, states[1], tok.to(device))
        lg = lg.cpu()
        try:
            torch.testing.assert_close(lg, lc, **LOGITS_TOL)
        except AssertionError as e:
            raise AssertionError(f"phase 6: logits differ CPU vs GPU at "
                                 f"step {step}: {e}") from None
        worst = max(worst, float((lg - lc).abs().max()))
        top2 = lc.topk(2, -1).values
        gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
        toks["cpu"].append(lc.argmax(-1).tolist())
        toks["gpu"].append(lg.argmax(-1).tolist())
    return dict(max_abs_err=worst, smallest_top2_gap=gap, tokens=toks,
                same_tokens=toks["cpu"] == toks["gpu"])


# ---------------------------------------------------------------------------
# Phases 16 to 18: the train path
# ---------------------------------------------------------------------------
def expected_train_launches(cfg, S: int, accum: int) -> dict:
    """The kernels a train step over accum microbatches of S tokens
    launches: each attention layer calls attention min(8, S // 1024) times
    a microbatch past 2 x 1024 tokens (chunked_flash's split), else once,
    and each call launches flash_attention twice (the forward and its
    recompute under remat) and flash_attention_bwd once; each RG-LRU
    layer rg_lru_scan twice and rg_lru_scan_bwd once; each MoE layer
    moe_dispatch twice (once each without remat)."""
    kinds = [k for ks in cfg.layer_pattern() for k in ks] * cfg.n_groups
    chunks = min(8, S // 1024) if S > 2 * 1024 else 1
    fwd = 2 if cfg.remat else 1
    n_attn = sum(k in ("attn", "lattn") for k in kinds)
    want = {"flash_attention": fwd * chunks * n_attn * accum,
            "flash_attention_bwd": chunks * n_attn * accum,
            "rg_lru_scan": fwd * kinds.count("rglru") * accum,
            "rg_lru_scan_bwd": kinds.count("rglru") * accum,
            "moe_dispatch": fwd * kinds.count("moe") * accum}
    return {name: n for name, n in want.items() if n}


def train_flops(model, B: int, S: int) -> tuple:
    """(matrix-product flops, attention flops) of one train step over B x S
    tokens, the model's own (no remat recompute): 6 per weight and token
    in the products (2 forward, 4 backward; the tied table as the logits'
    product; each token through its top_k experts) and 3.5 times the
    forward's 4 d per live (q, k) pair and head (the backward 2.5 times
    the forward)."""
    cfg = model.cfg
    n_mat = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    n_expert = sum(p[0].numel() for p in model.parameters() if p.dim() == 3)
    _, attn = prefill_flops(model, B, S)
    return 6 * (n_mat + cfg.top_k * n_expert) * B * S, 3.5 * attn


def rgemma_train_cfg():
    """recurrentgemma-9b at full width, its depth cut to the first three
    layers of its pattern (one group)."""
    from repro_torch.configs import registry
    cfg = registry.get(RGEMMA)
    n = RGEMMA_TRAIN["layers"]
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[:n])


def phase_train(cfg, seed: int, device, phase: int, tag: str, batch: int,
                seq: int, accum: int, cut: str):
    """make_train_step (AdamW) on `batch` sequences of `seq` tokens of
    SyntheticLM data in `accum` microbatches: one warm-up step under a
    Capture keeping the first call of each kernel (marked `tag`; held
    against the plain versions and timed right after; B10's limit must
    reject its mask edge one key off there), TRAIN_STEPS timed steps (peak
    memory), one traced step. Every step zeroes the counts before and
    reads them after: each kernel must launch as expected_train_launches
    says and no other, and loss and grad norm must be finite. Then the
    state goes through AsyncCheckpointer and is restored into a fresh
    model and optimizer state, equal bit for bit. Returns (report, kernel
    rows)."""
    import math
    import shutil
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps, train as train_mod
    from repro_torch.models import lm
    from repro_torch.runtime import AsyncCheckpointer
    from repro_torch.runtime import checkpoint as ckpt_mod
    log(f"cut: phase {phase} trains {cfg.name}: {cut}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed, device)
    init_fn, train_step = steps.make_train_step(cfg, **TRAIN_LR)
    opt = init_fn(model)
    torch.cuda.synchronize()
    text, w_bytes = describe(cfg, model)
    log(f"phase {phase}: {text}, built with its optimizer state in "
        f"{time.perf_counter() - t0:.2f} s")
    want = expected_train_launches(cfg, seq, accum)
    names = tuple(want)
    shape = ShapeSpec("train", seq, batch, "train", grad_accum=accum)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=seed)
    sync = torch.cuda.synchronize
    losses, gnorms, total = [], [], dict.fromkeys(names, 0)

    def run(step: int) -> float:
        nonlocal model, opt
        batch_ = data.train_batch(cfg, shape, step, device=device)
        zero_counts()
        sync()
        t0 = time.perf_counter()
        model, opt, m = train_step(model, opt, batch_, step)
        sync()
        dt = time.perf_counter() - t0
        counts = read_counts(names)
        got = {name: counts[name] for name in names}
        if got != want or any(counts[n] for n in counts if n not in want):
            raise AssertionError(f"phase {phase} step {step}: launches "
                                 f"{counts}, want {want}")
        for name in names:
            total[name] += counts[name]
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"phase {phase} step {step}: loss {loss} "
                                 f"grad norm {gn}")
        losses.append(loss)
        gnorms.append(gn)
        return dt

    with Capture() as capture:
        capture.mark(tag)
        first_s = run(0)
    rows = phase_captured(capture.calls, names, phase)
    edge = bwd_edge_fault_rejected(
        *capture.calls[("flash_attention_bwd", tag)], str(phase))
    log(f"phase {phase}: the flash_attention_bwd limit rejects the "
        f"{edge['edge']} one key short at the first call (on "
        f"{edge['output']}, max abs err {edge['max_abs_err']:.6g})")
    del capture
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    times = [run(step) for step in range(1, 1 + TRAIN_STEPS)]
    max_mem = torch.cuda.max_memory_allocated(device)
    step_ms = statistics.median(times) * 1e3
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        traced_s = run(1 + TRAIN_STEPS)
    profile = profile_summary(prof, [traced_s], step_ms, phase)
    # the state after the last step, written behind and restored
    t0 = time.perf_counter()
    ckdir = ROOT / "build" / f"chip_smoke_ckpt_{phase}"
    shutil.rmtree(ckdir, ignore_errors=True)
    writer = AsyncCheckpointer(str(ckdir), keep=1)
    writer.submit(len(losses), train_mod.state_tree(model, opt))
    writer.wait()
    writer.close()
    fresh = lm.init_lm(cfg, seed + 1, device)
    fresh_opt = init_fn(fresh)
    train_mod.restore_state(str(ckdir), ckpt_mod.latest_step(str(ckdir)),
                            fresh, fresh_opt)
    pairs = list(zip(*(
        ckpt_mod.tree_flatten(train_mod.state_tree(m, o))[0]
        for m, o in ((model, opt), (fresh, fresh_opt)))))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"phase {phase}: the restored state differs")
    ckpt_bytes = sum(a.numel() * a.element_size() for a, _ in pairs)
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt_s = time.perf_counter() - t0
    del fresh, fresh_opt
    mat_flops, attn_flops = train_flops(model, batch, seq)
    report = dict(arch=cfg.name, layers=cfg.n_layers, batch=batch,
                  seq_len=seq, accum=accum, cut=cut,
                  params=sum(p.numel() for p in model.parameters()),
                  launches_per_step=want, launches=total, losses=losses,
                  grad_norms=gnorms, first_s=first_s, step_ms=times,
                  step_ms_median=step_ms,
                  tok_per_s=batch * seq / (step_ms / 1e3),
                  max_memory_allocated=max_mem, traced_s=traced_s,
                  matmul_flops=mat_flops, attention_flops=attn_flops,
                  bound_ms=(mat_flops + attn_flops)
                  / PEAK_FLOPS["torch.bfloat16"] * 1e3,
                  profile=profile, limit_check=edge,
                  checkpoint=dict(leaves=len(pairs), bytes=ckpt_bytes,
                                  seconds=ckpt_s))
    del model, opt
    torch.cuda.empty_cache()
    return report, rows


def phase_train_cpu_vs_gpu(seed: int, device) -> dict:
    """Reduced smollm-135m and recurrentgemma-9b in float32, weights built
    once on the CPU and moved, TF32 off: TRAIN_CHECK["steps"] steps of
    make_train_step on each device on the same batches. Loss and grad norm
    of every step within TRAIN_CHECK_TOL's loss_rtol, the weights after
    the last within its weight_rtol (relative, and of max(1, each leaf's
    largest magnitude) absolute); on the card the train kernels must
    launch."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    c, tol = TRAIN_CHECK, TRAIN_CHECK_TOL
    out = {}
    for name, names in ((SMOLLM, TRAIN_KERNELS),
                        (RGEMMA, RGEMMA_TRAIN_KERNELS)):
        cfg = registry.get(name).reduced()
        cpu = lm.init_lm(cfg, seed, "cpu")
        gpu = copy.deepcopy(cpu).to(device)
        rng = np.random.default_rng(seed + 18)
        toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (
            c["accum"], c["batch"] // c["accum"], c["seq_len"])).astype(
                np.int32)) for _ in range(c["steps"])]
        metrics = {}
        for dev, model in (("cpu", cpu), ("gpu", gpu)):
            init_fn, train_step = steps.make_train_step(cfg, **c["lr"])
            opt = init_fn(model)
            zero_counts()
            metrics[dev] = [
                [float(x) for x in train_step(
                    model, opt, {"tokens": t.to(model.embed.device)},
                    i)[2].values()] for i, t in enumerate(toks)]
            if dev == "gpu":
                read_counts(names)
        if not np.allclose(metrics["gpu"], metrics["cpu"], atol=0,
                           rtol=tol["loss_rtol"]):
            raise AssertionError(f"phase 18: {name} loss / grad norm CPU "
                                 f"{metrics['cpu']} GPU {metrics['gpu']}")
        worst = 0.0
        for a, b in zip(cpu.parameters(), gpu.parameters()):
            a, b = a.detach(), b.detach().cpu()
            scale = max(float(a.abs().max()), 1.0)
            try:
                torch.testing.assert_close(b, a, rtol=tol["weight_rtol"],
                                           atol=tol["weight_rtol"] * scale)
            except AssertionError as e:
                raise AssertionError(f"phase 18: {name} weights differ CPU "
                                     f"vs GPU: {e}") from None
            worst = max(worst, float((a - b).abs().max()) / scale)
        out[name] = dict(loss_gnorm_cpu=metrics["cpu"],
                         loss_gnorm_gpu=metrics["gpu"],
                         worst_weight_err_of_scale=worst)
    return out


def log_train(v: dict, card: str) -> None:
    log(f"train {v['arch']} ({v['layers']} layers): {v['batch']} x "
        f"{v['seq_len']} tokens a step in {v['accum']} microbatches: median "
        f"{v['step_ms_median']:.1f} ms a step ({v['tok_per_s']:.0f} tok/s; "
        f"steps {', '.join(f'{t * 1e3:.1f}' for t in v['step_ms'])} ms; "
        f"first step {v['first_s']:.2f} s captured), bound "
        f"{v['bound_ms']:.1f} ms ({v['matmul_flops'] / 1e12:.2f} TFLOP of "
        f"matrix products + {v['attention_flops'] / 1e12:.2f} of attention "
        f"at the bf16 peak); peak memory "
        f"{v['max_memory_allocated'] / 1e9:.2f} GB ({card})")
    log(f"train {v['arch']}: losses {[round(x, 4) for x in v['losses']]}, "
        f"grad norms {[round(x, 4) for x in v['grad_norms']]}; launches a "
        f"step {v['launches_per_step']} (the formula); checkpoint of "
        f"{v['checkpoint']['leaves']} leaves, "
        f"{v['checkpoint']['bytes'] / 1e9:.2f} GB, written, restored and "
        f"compared in {v['checkpoint']['seconds']:.1f} s")
    log_profile(f"train {v['arch']}", v["profile"], "step")


# ---------------------------------------------------------------------------
def log_profile(what: str, pr: dict, unit: str) -> None:
    if pr.get("device_ms_per_step") is None:
        return
    log(f"{what} profile over {pr['steps']} {unit}(s): device busy "
        f"{pr['device_ms_per_step']:.3f} ms per {unit}, idle "
        f"{pr['idle_share_vs_median']:.3f} of the untraced {unit}")
    for r in pr["top"]:
        log(f"  {r['ms_per_step']:8.3f} ms/{unit} {r['calls_per_step']:7.1f}"
            f" calls/{unit}  {r['name']}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--insert-batches", type=int,
                    default=TARGET_KEYS // (P * N),
                    help="insert batches per arm (64 fill the table to "
                         "load 0.25; fewer is a cut, printed as such)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    full = TARGET_KEYS // (P * N)
    if args.insert_batches != full:
        log(f"cut: {args.insert_batches} insert batches per arm instead of "
            f"{full} (load {args.insert_batches / full * 0.25:.4f})")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"ptxas {name}: {line.strip()}")
    for lib, fn, what in (("owner_lane", "repro_owner_lane_smem_bytes",
                           "an apply block"),
                          ("hash_probe", "repro_hash_insert_smem_bytes",
                           "a hash_insert block")):
        smem = getattr(_build.load(lib), fn)
        smem.restype = ctypes.c_longlong
        log(f"{lib}: {smem()} bytes of dynamic shared memory {what}")
    from repro_torch.kernels import flash_attention_bwd as kfab
    for what, shape in BWD_PLAN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            log(f"flash_attention_bwd launches at {what} {shape} {dtype}: "
                f"{kfab.launch_plan(*shape, dtype, device)}")

    edge_cases(device)
    log("phase 1: " + bwd_same_bits(device))
    log(f"phase 1: edge cases equal on all {len(KERNELS)} kernels")
    launches = {name: {} for name in KERNELS}    # kernel -> phase -> count

    def record(phase: str, counts: dict, names) -> None:
        for name in names:
            launches[name][phase] = counts[name]

    with Capture() as capture:
        zero_counts()
        t0 = time.perf_counter()
        report = phase_slice(args.seed, args.insert_batches, device,
                             capture.mark)
        slice_s = time.perf_counter() - t0
        counts = read_counts(DS_KERNELS)
    record("phase 2", counts, DS_KERNELS)
    log(f"phase 2: launches {counts} in {slice_s:.1f} s")

    rows = {name: [] for name in KERNELS}

    def add_rows(new: dict) -> None:
        for name, calls in new.items():
            rows[name].extend(calls)

    add_rows(phase_captured(capture.calls, DS_KERNELS, 3))
    del capture

    n_out = phase_cpu_vs_gpu(args.seed, device)
    log(f"phase 4: {n_out} outputs equal on CPU and GPU")

    with Capture() as capture:
        zero_counts()
        served = phase_serve(SERVE, args.seed, device, 5, capture.mark)
        counts = read_counts(MODEL_KERNELS)
    sv = served["report"]
    want = sv["layers"] * sv["steps"]
    for name in MODEL_KERNELS:
        if counts[name] != want:
            raise AssertionError(f"phase 5: {name} launched "
                                 f"{counts[name]} times, want "
                                 f"{sv['layers']} a step = {want}")
    record("phase 5", counts, MODEL_KERNELS)
    check_last_logits(served)
    ds_model = served["model"]
    del served                          # the caches
    log(f"phase 5: launches {counts} ({sv['layers']} a step for "
        f"each model kernel over {sv['steps']} steps); backends "
        f"{sv['backends']}; logits finite")
    add_rows(phase_captured(capture.calls, MODEL_KERNELS, 5))
    del capture
    torch.cuda.empty_cache()

    dpf, ds_rows = phase_prefill(ds_model, args.seed, device, "5b",
                                 "ds prefill")
    del ds_model
    add_rows(ds_rows)
    record("phase 5b", dpf["launches"], tuple(dpf["launches"]))
    log(f"phase 5b: launches {dpf['launches']} per prefill (3 runs); logits "
        f"finite")
    torch.cuda.empty_cache()

    model_check = phase_model_cpu_vs_gpu(args.seed, device)
    log(f"phase 6: reduced {SERVE['arch']} logits equal CPU vs GPU within "
        f"{LOGITS_TOL} over {MODEL_STEPS} steps (max abs err "
        f"{model_check['max_abs_err']:.3e}, smallest top-2 gap "
        f"{model_check['smallest_top2_gap']:.3e}); greedy tokens CPU "
        f"{model_check['tokens']['cpu']} GPU {model_check['tokens']['gpu']}")
    torch.cuda.empty_cache()

    with Capture() as capture:
        zero_counts()
        rg = phase_serve(RGEMMA_SERVE, args.seed, device, 7, capture.mark)
        counts = read_counts(RGEMMA_DECODE_KERNELS)
    rv = rg["report"]
    n_rglru = expected_prefill_launches(rg["model"].cfg, 1)["rg_lru_scan"]
    want = {name: 0 for name in KERNELS} | {
        "rg_lru_scan": n_rglru * rv["steps"]}
    if counts != want:
        raise AssertionError(f"phase 7: launches {counts}, want {want} "
                             f"({n_rglru} rg_lru_scan a step)")
    record("phase 7", counts, RGEMMA_DECODE_KERNELS + ("flash_attention",))
    check_last_logits(rg)
    log(f"phase 7: launches {counts} ({n_rglru} rg_lru_scan a step over "
        f"{rv['steps']} steps, no flash_attention); backends "
        f"{rv['backends']}; logits finite; LATTN ring of "
        f"{min(rg['model'].cfg.local_window, rv['steps'] + 1)} slots does "
        f"not wrap at {rv['steps']} steps")
    add_rows(phase_captured(capture.calls, RGEMMA_DECODE_KERNELS, 7))
    del capture

    pf, prefill_rows = phase_prefill(rg["model"], args.seed, device, "8",
                                     "prefill", rg["prompts"],
                                     RGEMMA_SERVE["gen_len"])
    add_rows(prefill_rows)
    record("phase 8", pf["launches"], tuple(pf["launches"]))
    cc = pf["cross_check"]
    log(f"phase 8: launches {pf['launches']} per prefill (3 runs); logits "
        f"finite; cross-check (not gated): prefill of the {cc['prompts']} "
        f"serve prompts against a decode of them (their step-"
        f"{RGEMMA_SERVE['prompt_len']} logits): max abs err "
        f"{cc['max_abs_err']:.4f} (logits up to "
        f"{cc['logits_scale']:.2f}), argmax agrees on "
        f"{cc['argmax_agree']:.3f} of the requests")
    del rg
    torch.cuda.empty_cache()

    rg_check = phase_rgemma_cpu_vs_gpu(args.seed, device)
    log(f"phase 9: reduced {RGEMMA} forward and {rg_check['steps']} decode "
        f"steps (ring of {rg_check['ring']} slots wraps: "
        f"{rg_check['wraps']}) equal CPU vs GPU within {LOGITS_TOL} (max "
        f"abs err {rg_check['cpu_vs_gpu']:.3e}); decode == forward within "
        f"{DECODE_VS_PREFILL_TOL} on both (max abs err "
        f"{rg_check['decode_vs_forward']:.3e}); forward over "
        f"{rg_check['split_len']} tokens (chunked_flash split, launches "
        f"{rg_check['split_launches']}) equal CPU vs GPU (max abs err "
        f"{rg_check['split_cpu_vs_gpu']:.3e})")

    zero_counts()
    t0 = time.perf_counter()
    comp = component_rows(args.seed, device, torch.cuda.synchronize)
    fitted = calibrated_costs(comp)
    counts = read_counts(("amo_apply", "fused_apply", "hash_insert"))
    record("phase 10", counts, DS_KERNELS)
    log(f"phase 10: component us per op ({P} ranks x {N} ops a call, "
        f"median of {COMPONENT_ITERS} calls; {card}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in comp.items()))
    log(f"phase 10: fitted {fitted}")
    log(f"phase 10: Fig. 3 ratios: cas_persistent / cas_single "
        f"{comp['cas_persistent'] / comp['cas_single']:.3f}, fad_single / "
        f"fad {comp['fad_single'] / comp['fad']:.3f}; launches {counts} in "
        f"{time.perf_counter() - t0:.1f} s")
    report["components"] = dict(us_per_op=comp, fitted=dataclasses.asdict(
        fitted), launches=counts)

    zero_counts()
    t0 = time.perf_counter()
    counter, arm_launches = launch_counter(), {}
    sync = torch.cuda.synchronize
    auto = phase_auto_ht(args.seed, device, sync, fitted, counter,
                         arm_launches)
    auto["queue"] = phase_auto_queue(args.seed, device, sync, fitted,
                                     counter, arm_launches)
    forced_arms(device, sync, counter, arm_launches)
    auto["hot_cached"] = phase_auto_hot_cached(args.seed, device, sync,
                                               fitted, counter)
    counts = read_counts(DS_KERNELS)
    record("phase 11", counts, DS_KERNELS)
    check_arm_launches(arm_launches)
    taken = {a for rep in auto.values() if "chosen" in rep
             for per_op in rep["chosen"].values() for a in per_op}
    log_auto(auto, card)
    log(f"phase 11: arms the chooser took: {sorted(taken)}; each of "
        f"{list(AUTO_ARMS)} also ran forced through backend='auto'; "
        f"launches by arm {arm_launches}; in all {counts} in "
        f"{time.perf_counter() - t0:.1f} s")
    report["auto"] = auto
    report["auto_launches_by_arm"] = arm_launches

    zero_counts()
    t0 = time.perf_counter()
    log(f"phase 12: cut: streams of {PIPE_PAIRS} insert + find (push + pop) "
        f"pairs instead of {PIPE_FULL_PAIRS}")
    pipe = phase_pipeline(args.seed, device, sync, fitted, launch_counter())
    pipe["small_cpu_vs_gpu"] = pipe_small_cpu_vs_gpu(args.seed, device,
                                                     fitted)
    counts = read_counts(DS_KERNELS)
    record("phase 12", counts, DS_KERNELS)
    log_pipeline(pipe, card)
    log(f"phase 12: every depth and arm equal to depth 1 and to the "
        f"synchronous front doors bit for bit (also forced in reverse); "
        f"the same launches at every depth; small streams equal on CPU and "
        f"GPU (outputs, windows, dispatch points, phase logs); launches "
        f"{counts} in {time.perf_counter() - t0:.1f} s")
    report["pipeline"] = pipe

    zero_counts()
    t0 = time.perf_counter()
    log(f"phase 13: cut: {CHAOS_BATCHES} insert + find batches per arm and "
        f"schedule instead of {CHAOS_FULL} (the plane simulates delivery "
        f"on the host)")
    chaos = phase_faults(args.seed, device, sync, fitted, launch_counter())
    counts = read_counts(OWNER_KERNELS)
    record("phase 13", counts, OWNER_KERNELS)
    log_faults(chaos, card)
    log(f"phase 13: every arm and the queue equal to their fault-free runs "
        f"and the host oracle under {[n for n, _ in CHAOS_SCHEDULES]}; "
        f"launches {counts} in {time.perf_counter() - t0:.1f} s")
    report["faults"] = chaos
    log(f"phase 13: seconds {time.perf_counter() - t0:.1f}")

    zero_counts()
    t0 = time.perf_counter()
    cache_rep = phase_cache(args.seed, device, sync, fitted,
                            launch_counter(), args.insert_batches)
    counts = read_counts(("fused_apply",))
    record("phase 14", counts, OWNER_KERNELS)
    log_cache(cache_rep, card)
    log(f"phase 14: every find equal to the uncached run's and the host "
        f"oracle; windows equal with and without the cache; the all-hit "
        f"batch launched nothing; no sync added at depth 2; the small "
        f"stream equal on CPU and GPU; launches {counts} in "
        f"{time.perf_counter() - t0:.1f} s")
    report["cache"] = cache_rep

    with Capture(last=True) as capture:
        zero_counts()
        t0 = time.perf_counter()
        txn_rep = phase_txn(args.seed, device, sync, fitted,
                            launch_counter(), cache_rep.pop("table"),
                            cache_rep.pop("engine"),
                            cache_rep.pop("present_keys"), capture.mark)
        counts = read_counts(("amo_apply", "txn_group_apply"))
    record("phase 15", counts, OWNER_KERNELS)
    log_txn(txn_rep, card)
    log(f"phase 15: every batch of every arm equal to the serial replay of "
        f"its order; move and pop_then_insert equal to the host oracle; "
        f"launches {counts} in {time.perf_counter() - t0:.1f} s")
    add_rows(phase_captured(capture.calls, ("txn_group_apply",), 15))
    del capture
    report["txn"] = txn_rep

    from repro_torch.configs import registry
    t0 = time.perf_counter()
    st = SMOLLM_TRAIN
    cfg = registry.get(SMOLLM)
    micro = st["shape_batch"] // st["accum"]
    cut = (f"global batch {st['shape_batch']} -> {st['batch']} "
           f"({st['batch'] // st['accum']} a microbatch) of the "
           f"{st['shape']} shape (seq {st['seq_len']}, accum {st['accum']}):"
           f" at {st['shape_batch']} the f32 logits alone are "
           f"{micro * st['seq_len'] * cfg.vocab_padded * 4 / 1e9:.0f} GB a "
           f"microbatch")
    tr16, train_rows = phase_train(cfg, args.seed, device, 16,
                                   "smollm train", st["batch"],
                                   st["seq_len"], st["accum"], cut)
    add_rows(train_rows)
    record("phase 16", tr16["launches"], tuple(tr16["launches"]))
    log(f"phase 16: launches {tr16['launches_per_step']} a step (the "
        f"formula) in each of {len(tr16['losses'])} steps; losses and grad "
        f"norms finite; the checkpoint restored bit for bit; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rt = RGEMMA_TRAIN
    cfg = rgemma_train_cfg()
    full = registry.get(RGEMMA)
    cut = (f"depth {full.n_layers} -> {cfg.n_layers} (the first layers of "
           f"its pattern: {[list(k) for k in cfg.pattern]}): at "
           f"{full.n_layers} layers its {full.params_count() / 1e9:.2f} B "
           f"weights, their f32 gradient sums and AdamW's two f32 moments "
           f"need {full.params_count() * 14 / 1e9:.0f} GB; global batch "
           f"{rt['shape_batch']} -> {rt['batch']} "
           f"({rt['batch'] // rt['accum']} a microbatch), seq "
           f"{rt['seq_len']}, accum {rt['accum']}")
    tr17, train_rows = phase_train(cfg, args.seed, device, 17,
                                   "rgemma train", rt["batch"],
                                   rt["seq_len"], rt["accum"], cut)
    add_rows(train_rows)
    record("phase 17", tr17["launches"], tuple(tr17["launches"]))
    log(f"phase 17: launches {tr17['launches_per_step']} a step (the "
        f"formula) in each of {len(tr17['losses'])} steps; losses and grad "
        f"norms finite; the checkpoint restored bit for bit; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_check = phase_train_cpu_vs_gpu(args.seed, device)
    log(f"phase 18: {TRAIN_CHECK['steps']} train steps of reduced "
        f"{SMOLLM} and {RGEMMA} (f32) equal CPU vs GPU within "
        f"{TRAIN_CHECK_TOL}: " + "; ".join(
            f"{n}: loss, grad norm CPU {v['loss_gnorm_cpu']} GPU "
            f"{v['loss_gnorm_gpu']}, worst weight error "
            f"{v['worst_weight_err_of_scale']:.3e} of max(1, its leaf's "
            f"scale)"
            for n, v in train_check.items())
        + f"; {time.perf_counter() - t0:.1f} s")

    for arm in ARMS:
        r = report[arm]
        log(f"median ms per batch, hash table {arm}: insert "
            f"{r['insert_ms']:.3f}, find {r['find_ms']:.3f} ({card})")
        for op in ("insert", "find"):
            log_batch_profile(f"hash table {arm} {op}", r[f"profile_{op}"],
                              card)
    for arm in ("rdma", "rpc"):
        r = report[f"queue_{arm}"]
        log(f"median ms per batch, queue {arm}: push {r['push_ms']:.3f}, "
            f"pop {r['pop_ms']:.3f} ({card})")
        for op in ("push", "pop"):
            log_batch_profile(f"queue {arm} {op}", r[f"profile_{op}"], card)
    for v in (sv, rv):
        log(f"serve {v['arch']}: median {v['step_ms_median']:.3f} ms per "
            f"decode step of {v['batch']} tokens (bound "
            f"{v['step_bound_ms']:.3f} ms, weights alone "
            f"{v['step_bound_ms_weights']:.3f}), {v['tok_per_s']:.1f} tok/s "
            f"over {v['steps']} steps, {v['generated_tok_per_s']:.1f} "
            f"generated tok/s; init {v['init_s']:.2f} s; peak memory "
            f"{v['max_memory_allocated'] / 1e9:.2f} GB ({card})")
        log_profile(f"serve {v['arch']}", v["profile"], "step")
    for v in (dpf, pf):
        log(f"prefill {v['arch']}: {v['batch']} x {v['seq_len']} tokens in "
            f"{v['prefill_s']:.3f} s ({v['tok_per_s']:.0f} tok/s; first run "
            f"{v['first_s']:.3f} s), bound {v['bound_s']:.3f} s "
            f"({v['matmul_flops'] / 1e12:.1f} TFLOP of matrix products + "
            f"{v['attention_flops'] / 1e12:.1f} of attention at the bf16 "
            f"peak); peak memory {v['max_memory_allocated'] / 1e9:.2f} GB "
            f"({v['memory_before'] / 1e9:.2f} before) ({card})")
        log_profile(f"prefill {v['arch']}", v["profile"], "prefill")
    report["serve"] = sv
    report["prefill_ds"] = dpf
    report["model_cpu_vs_gpu"] = model_check
    report["serve_rgemma"] = rv
    report["prefill"] = pf
    report["rgemma_cpu_vs_gpu"] = rg_check
    for v in (tr16, tr17):
        log_train(v, card)
    report["train_smollm"] = tr16
    report["train_rgemma"] = tr17
    report["train_cpu_vs_gpu"] = train_check
    kernels = [kernel_row(name, rows[name], launches[name])
               for name in KERNELS]
    shapes = {f"{name} at {r['at']}": r["shapes"]
              for name, calls in rows.items() for r in calls}
    log(json.dumps({"report": report, "card": card, "build_s": build_s,
                    "slice_s": slice_s, "seed": args.seed,
                    "total_s": time.perf_counter() - start,
                    "shapes": shapes}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
