#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line or block each:

  1. environment: torch / CUDA versions, the card, its power limit; TF32
     off for matmul and cuDNN (the plain versions must be full fp32);
  2. build: all six CUDA sources (the serving path's two re-id kernels and
     the kernel benchmark's four), with nvcc for sm_90a, one nvcc per
     source, all started together; each kernel's registers and spills,
     the gallery-split kernels' merge pass (``merge_slices``) among them,
     the flash kernel's per (padded head width, dtype) variant and the
     decode kernel's per (padded head width, heads a block, dtype)
     template, none of which may spill;
  3. each serving kernel against its plain PyTorch version on the card, on
     ragged, tied, masked, k > G, G == 0, C = 130 (and C*T*T = 8,320
     cells) and C = 8,192 (the camera call past 4,096 cameras, on the tile
     kernel) inputs and at a stress shape: scores within rtol/atol 1e-5,
     indices exact on integer-valued inputs and exact elsewhere except
     between scores within 1e-5 of each other; every shape is timed
     (kernel, plain version, library yardstick) beside its bound and its
     plan (q-blocks x gallery slices S, ``reid_topk.split_plan``, the same
     for both kernels) and the share of (64-row, 64-row) tiles that hold
     an eligible pair; both kernels also on split edge cases (ties across
     slice boundaries, k = 16 over one-tile slices, wholly masked slices,
     G one past a tile), with exact indices, and the tile kernel on a cell
     axis past its first design's limit (C*T*T = 61,440 > 54,688); the
     tile kernel with every tile admitted must equal the camera kernel bit
     for bit, at a split shape too (Q = 256, G = 8,192, C = 130); both
     stress shapes must split (S > 1);
  4. the camera-granular main path: the duke world at the benchmark's
     scale (8 cameras, 2,700 entities, 5,100 steps, 100 queries) served
     through ``repro_torch.api.serve(device="cuda")`` until every query is
     done or the world's horizon ends; every kernel's launch count is reset
     just before and read just after: the camera kernel's must equal the
     rounds that ranked a non-empty gallery, the tile kernel's must be 0.
     The same ticks run again with ``device="cpu"`` (the plain versions)
     and the two traces must agree;
  5. the camera kernel against its plain version at every round shape
     phase 4 produced; the most frequent and the largest are timed as in
     phase 3 and go into the kernels line, beside the stress shape; the
     most frequent must run unsplit (S = 1);
  6. the tile path: the same world profiled with ``tile_grid=8`` and served
     with ``api.serve(tile_grid=8, topk=3)`` until every query is done or
     the world's horizon ends; the counts are reset just before and read
     just after: the tile kernel's must equal the non-empty rounds, the
     camera kernel's must be 0.  A CPU rerun must agree on the trace and
     on all four cost counters (admitted and unique frames and tiles); it
     also counts the (64-row, 64-row) tiles of each round that hold an
     eligible pair, the kernel's live tiles (it skips the others before
     staging their operands);
  7. the tile kernel against its plain version at every round shape phase
     6 produced; the most frequent and the largest are timed as in phase 3;
     the most frequent must run unsplit (S = 1);
  8. the kernel benchmark's four kernels (unmasked re-id top-k, flash
     attention, decode attention, Mamba scan) against their plain versions
     on edge inputs: ragged Q and G, integer-valued ties, k > G, G == 0 and
     Q == 0, and for the unmasked top-k the split edge cases of phase 3;
     flash attention in MHA, GQA and MQA at hd 8, 32, 40, 64, 80, 96, 128,
     136 and 256, causal or not, S = T, S < T and S > T, float32 and
     bfloat16; decode at hd 8, 32, 40, 64, 80, 128, 136 and 256 with 1, 4,
     8, 12 and 40 q heads a kv head, lengths of 0, 1, partial, T and past
     T, float32 and bfloat16, and under forced plans (one split, many, a
     split off the tile, 1 to 8 heads a block, 4 or 8 warps);
     the scan at state sizes 1, 3, 4, 8, 16, 17, 64 and 300 (tiled), L of
     1, one below, at and one past the plan's chunk and 4,097 at D of 1,
     63 and 65, B = 65,536 at L = D = N = 1, A = 0 over 4,096 steps (the
     state only accumulates) and dt = 0 (y must be 0), and under 8 forced
     plans with the end state h_L as well.  Top-k scores
     within 1e-5 (indices as in phase 3), attention within 2e-5 in float32
     and 2e-2 in bfloat16, where besides at least 99 % of the outputs must
     equal the plain version's bit for bit (p stays float32, as in the
     Pallas kernels), the scan within 1e-4;
  9. the kernel benchmark path: ``repro_torch.benchmarks.kernels_bench
     .run(device="cuda")``, the four kernels at the JAX benchmark's shapes;
     the four counts are reset just before and read just after, and each
     must equal the calls the benchmark made; every output is held to its
     plain version, the CSV rows are printed, and each kernel's library
     yardstick is timed beside the benchmark's kernel and plain times (the
     re-id top-k with its plan, which must split; the scan with its plan,
     ``mamba_scan.scan_plan``; decode with its plan,
     ``decode_attention.decode_plan``, and the device times of its partial
     pass alone and with the combine);
 10. the same kernels held and timed at the widths of models the repo
     configures: flash attention at yi-6b's layout (H = 32, KV = 4,
     hd = 128) over ``train_4k``'s 4,096 tokens, causal, in float32 and
     bfloat16, at zamba2-2.7b's (H = KV = 32, hd = 80) likewise, and at the
     benchmark's shape in bfloat16; decode attention at yi-6b's layout
     over ``decode_32k``'s 32,768-key cache, lengths drawn in [1, T], at
     its batch of 128 in bfloat16 and float32 (held in 8-row slices) and
     at batch 8 in float32 (comparable with earlier runs), and at
     zamba2-2.7b's layout in bfloat16 (batch 32, so the plain version's
     float32 copies of the cache fit), each with its plan and its
     partial and combine
     times; the scan at falcon-mamba-7b's D = 8,192, N = 16 over 4,096
     steps, with its plan.  Attention (float32) and scan within 1e-4,
     bfloat16 attention held as in phase 8.  Then the scan's end state
     (``final_state=True``, one launch writing y and h_L) held, y and h_L
     within 1e-4, at four shapes (``END_STATE_SHAPES``: the bench shape,
     three passes; falcon-mamba-7b's width, one pass; N = 320, two tiles;
     L = 1,001), its y equal bit for bit to the call without the end
     state;
 11. the batched tracker (``repro_torch.api.track``) on the card: (a) the
     quickstart world through ``repro_torch.examples.quickstart.main``
     (1,200 entities, 2,400 steps, profiled to 1,600, K = 24, 25 queries,
     ``all`` and S5-T2), whose printed lines must equal a CPU rerun's;
     (b) fig11's duke world (``benchmarks.scenarios.duke()``: 2,700
     entities, 5,100 steps, profiled to 3,000, K = 24, 100 queries) under
     ``all``, ``geo`` and S5-T2, and ``trace_queries`` over the first 600
     steps of S5-T2; (c) fig12's 130-camera porto world
     (``scenarios.porto(130)``: history 6,000 x 7,200, seed 11; live
     2,000 x 3,600, seed 2; K = 16; 400 feature clusters; 100 queries)
     under S5-T2 (porto's ``all`` run is left out to keep the script
     inside its time limit: the ``all`` scheme is held on the quickstart
     and duke worlds).  The loop state must live on the card.  Every
     ``TrackResult`` field and every trace array must equal the CPU
     rerun's.  One query may part at a step whose winning distance lies
     within 1e-5 of the match threshold: its margin is printed and its
     fields (and ``rescue_pairs``) are not compared.  Each run prints its
     wall seconds, steps, steps/s, cost, recall, precision, savings, mean
     delay and rescues; 200 steps of the duke S5-T2 trace run again under
     ``torch.profiler`` give the device's busy share and its operations a
     step;
 12. identity detection on the card through the ported table,
     ``repro_torch.benchmarks.tables.fig17_identity_detection`` (the duke
     world of phase 11, 40 lost identities from t = 3,200, seed 1): the
     baseline and theta 0.95, 0.85 and 0.75; every row's count fields
     (cost, recall, precision, savings, rounds) and every run's whole
     summary (cost, recall, precision, found_rate, rounds, at full
     precision) must equal the CPU rerun's; each row's wall a query is
     printed;
 13. recalibration (the §6 drift loop) on the card, at the reference's own
     sizes (``repro_torch.benchmarks.scenarios``, ``.drift``): (a)
     ``drift_sweep``'s re-permuted duke world (8 cameras, history
     2,000 x 4,000, live 300 x 400 then 800 x 1,800, 32 queries), frozen
     and recalibrated; at least one swap and recalibrated recall above
     frozen; (b) the same world profiled and served with ``tile_grid=8``
     and recalibration on, the learned masks carried across the swap;
     (a) ends with the recalibrating run on an 8-worker fleet
     (``recalibrated_shards8``: admitted steps, swap ticks and recall equal
     to the single engine's); (c) ``soak_130`` (the 130-camera clustered
     city, history 6,000 x 4,000, live 150 x 260 then 300 x 640, 12
     queries, a late wave at step 60): exhaustive and full rebuilds on one
     engine, row-targeted on an 8-worker fleet that loses w1 at step 120
     (one rebalance), under the reference's gates (savings >= 20x,
     targeted recall within 5 % of exhaustive and 2 % of full, fewer rows
     than C a swap), and the targeted configuration on one engine again
     under ``torch.profiler`` for the device's busy share; (d)
     ``sec6_drift``'s two tracker rows that see the drift (stale profile,
     with its hot pair, and re-profiled; the no-drift reference row, one
     more tracker run on an unchanged duke world as phase 11 runs, is
     left out: ``drift.run(reference=False)``).  Each kernel's count is reset
     before and read after (a) to (c), must equal the rounds that ranked
     a non-empty gallery (a fleet's round once a worker holding a row; the
     other kernel's 0), each fleet's launches must equal its
     ``worker_dispatches``, and every round shape is held to the plain
     version.  Every run has a CPU rerun that
     must agree record for record, with no parting forgiven: scores
     within 1e-5, the counters, swap ticks, epochs, the controller's
     events, polls, ``rows_reprofiled``, ``targeted_swaps`` and
     ``full_rebuilds`` exact.  Each run prints ticks/s, tick p50 / p99,
     the swap ticks and each swap's profile and swap milliseconds;
 14. the serving fleet (``repro_torch.api.serve(shards=...)``) on the
     duke world of phase 4 with phase 4's engine settings: (a) 4 workers
     on the card, the sharded gallery, w1 lost at tick 1,000; (b) the
     same at ``tile_grid=8``; (c) 8 workers behind a
     ``FakeRpcTransport`` on a virtual clock (latency 2 ms, jitter 1 ms;
     w3 drops every attempt, so its first fetch exhausts the retry
     budget, re-homes the gallery mid-round and the fleet scales down at
     the end of that tick) with prefetch; each serves the first 2,000
     ticks (the single engines of phases 4 and 6 serve to the horizon).  Each trace must equal phase 4's (phase 6's for (b))
     card trace over the same ticks record for record — masks, indices,
     counters and epochs exact, scores within 1e-5, with the count of
     scores that differ at all printed — and the cost counters and
     ``rescue_pairs`` the single engine's at the same tick (phases 4 and
     6 keep them at tick 2,000); the per-worker rows must tile the totals,
     the lost worker must have served rounds, each kernel's launches must
     equal the fleet's ``worker_dispatches`` (the other kernel's 0) and
     every per-worker round shape is held to the plain version; (c) must
     see one dead peer, remote fetches and prefetch hits.  200 ticks of
     (a) under ``torch.profiler`` print the busy share, the device
     operations and the device-to-host copies a tick beside phase 4's
     (phases 4, 6 and 13 print the same two counts).  Each run prints
     ticks/s and tick p50 / p99;
 15. the benchmark suite's sweeps and tables on the card, called as
     functions (not through the suite's catching command line) at their
     own sizes: the serving sweeps of ``repro_torch.benchmarks.scenarios``
     on the duke world of ``scenarios.duke(60)`` (8 cameras, 64-d features, 16 queries,
     180-600 ticks): ``serving_sweep`` (four schemes, three replay
     modes), ``tile_sweep`` (camera, all tiles admitted, learned masks;
     >= 2x fewer tiles at recall no lower), ``serving_shard_sweep`` (1, 2,
     4 and 8 workers), ``gallery_sweep`` (local and sharded, 4 workers),
     ``transport_sweep`` (4 workers behind a real-clock
     ``FakeRpcTransport`` whose RTT is the measured p50 tick: blocking at
     1x, 4x and 8x, prefetched at 1x, under the three gates, the
     prefetch gate on medians of three drives) and
     ``query_churn_sweep`` (N = 8, 64 and 256: the consolidated 8-worker
     fleet trace-identical to the unconsolidated engine, which ranks
     through ``reid_topk_masked``; sublinear in N); then ``sec3_potential``
     and ``fig10_anoncampus`` (``repro_torch.benchmarks.tables``).  Every
     CSV row and ``BENCH`` record must equal the CPU rerun's with the
     clock readings taken out (``scenarios.strip_clock_row`` /
     ``strip_clock_records``).  Each kernel's count is reset before and
     read after each entry, and every drive of a sweep must launch as many
     times as it ranked non-empty (worker) rounds, a fleet's also its
     ``worker_dispatches``, on one kernel (the tile kernel for tile runs);
     an unconsolidated drive only through ``reid_topk_masked``; the
     tables none; every round shape is held to the plain version.  Each
     entry prints its seconds and its largest run's ticks/s.
     ``policy_sweep``, ``fig11``-``fig17`` and ``sec6_drift`` run on the
     card through phases 11-13's tracker, detection and drift runs on the
     same worlds; ``scripts/torch_bench_counts.py`` holds their counts to
     the JAX reference on the CPU.
 16. the dense backbone zoo's serving path (``repro_torch.models``) at
     yi-6b's full width (configs/yi_6b.py: d_model 4,096, 32 query heads
     over 4 kv heads, hd 128, d_ff 11,008, vocab 64,000), random weights
     drawn on the card from a seeded ``torch.Generator``: (a) two layers
     in float32, B = 2: ``forward`` over 132 tokens, ``prefill`` of 128
     and 4 ``decode_step``s, held to a CPU rerun on the same weights
     (logits and caches within 2e-4, the CPU tests' float32 tolerance),
     and the card's decode logits to its forward logits; (b) all 32
     layers in bfloat16 (12.1 GB of weights), B = 8: ``prefill`` of
     1,024 tokens into 2,048 cache slots, then 32 greedy decode steps,
     timed (prefill tokens/s and decode ms a step, beside an operations
     bound and a byte bound); a warm-up run first holds the first and
     last layer's attention, at the prefill and at the last step, to
     ``ref.flash_attention_ref`` and ``ref.decode_attention_ref`` on the
     card as phase 10 holds bfloat16.  The counts are reset before and
     read after each driven run: flash once a layer a pass (4 in (a), 32
     in (b)), decode once a layer a step (8 and 1,024).  No logit may be
     NaN or infinite.  A prefill and 4 more steps under ``torch.profiler``
     give the device's busy share; both kernels are timed at the model's
     shapes beside their plain versions, bounds and library calls (the
     ``zoo`` entries of the kernels line).
 17. the Mamba1 zoo's serving path at falcon-mamba-7b's full width
     (configs/falcon_mamba_7b.py: d_model 4,096, d_inner 8,192, N 16,
     dt_rank 256, conv 4, vocab 65,024, tied embeddings), random weights
     drawn on the card from a seeded ``torch.Generator``, phase 16's
     freed first: (a) two layers in float32, B = 2: ``forward`` over 132
     tokens, ``prefill`` of 128 and 4 ``decode_step``s, held to a CPU
     rerun on the same weights (logits, the prefill's h and conv and the
     last step's, within 2e-4), and the card's decode logits to its
     forward logits; scan launches 2 a forward, 2 a prefill, none in the
     steps; (b) all 64 layers in bfloat16 (14.0 GB of weights), B = 8:
     ``prefill`` of 1,024 tokens, then 32 greedy decode steps, timed
     (prefill tokens/s against the matmuls' operations at the bfloat16
     peak plus the scan's at the fp32 peak; decode ms a step against the
     bytes of every weight and of the state read and written); a warm-up
     run first holds the first and last layer's scan, y and h_L, to the
     plain version on the card within 1e-4; scan launches 64 a prefill
     and none a step; no logit NaN or infinite; a profiled prefill and 4
     steps; the scan timed at the model's activations (B 8, L 1,024, D
     8,192, N 16) with and without the end state, beside its plain
     version and its byte bound (the scan's ``zoo`` entry of the kernels
     line, with phase 10's end-state holds).
 18. the hybrid zoo's serving path at zamba2-2.7b's full width
     (configs/zamba2_2p7b.py: d_model 2,560, 54 Mamba2 layers of d_inner
     5,120 in 80 heads of 64, N 64, chunk 256, conv 4; every 6 layers the
     one shared dense block, 32 heads over 32 kv heads of hd 80, d_ff
     10,240; vocab 32,000, untied), random weights drawn on the card from
     a seeded ``torch.Generator``, phase 17's freed first: (a) 12 layers
     (two super-blocks, so the shared block's weights serve two caches) in
     float32, B = 2: ``forward`` over 132 tokens, ``prefill`` of 128 and 4
     ``decode_step``s, held to a CPU rerun on the same weights (logits,
     every layer's h and conv and both super-blocks' K/V after the prefill
     and after the steps, within 2e-4), and the card's decode logits to its
     forward logits; flash launches 2 a forward and 2 a prefill, decode 2
     a step, scan none; (b) all 54 layers in bfloat16, B = 8: ``prefill``
     of 1,024 tokens into 2,048 slots, then 32 greedy decode steps, timed
     (prefill tokens/s against the matmuls' and attention's operations at
     the bfloat16 peak plus the SSD's matmuls at the fp32 peak; decode ms
     a step against the bytes of every weight, the shared block's once a
     super-block, of the live caches and of the state read and written); a
     warm-up run first holds the first and last super-block's attention,
     at the prefill and at the last step, to the plain versions on the
     card as phase 16 does; launches flash 9 a prefill, decode 9 a step,
     scan none; no logit NaN or infinite; one more step under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
     step); a profiled prefill, its SSD timed with CUDA events around each
     ``ssm.ssd_chunked`` call (its share of the prefill's device time),
     and 4 profiled steps; both kernels timed at the model's activations
     beside their plain versions, bounds and library calls (the
     ``zoo_hybrid`` entries of the kernels line);
 19. the MoE zoo's serving path (``repro_torch.models`` with
     ``models.moe``) at qwen3-moe-30b's full width (48 layers, d_model
     2,048, 32 query heads over 4 kv heads of 64, 128 experts top-8 of
     d_ff 768, capacity factor 1.25; vocab 151,936, untied), random
     weights drawn on the card from a seeded ``torch.Generator``, phase
     18's freed first: (a) 2 layers in float32, B = 2: ``forward`` over
     132 tokens (C = 21 slots an expert, entries drop), ``prefill`` of
     128 and 4 ``decode_step``s, held to a CPU rerun on the same weights
     (logits, caches, ``moe_aux`` and ``moe_z``, within 2e-4), and the
     card's decode logits to its forward logits at ``capacity_factor = E
     / k`` = 16 (C the whole chunk: nothing drops, where at 1.25 a
     forward's tokens compete for slots a step's never fill); flash
     launches 2 a forward and 2 a prefill, decode 2 a step; (b) all 48
     layers in bfloat16, B = 8: ``prefill`` of 1,024 tokens into 2,048
     slots (one chunk of 8,192 tokens, C = 640), then 32 greedy decode
     steps (C = 4), timed (prefill tokens/s against the operations of
     the experts over all E x C slots, as the reference computes them,
     the projections and attention at the bfloat16 peak and the float32
     routers at the fp32 peak; decode ms a step against the bytes of
     every weight, each step running every expert over its 4 slots, and
     of the live caches); the entries capacity drops at layer 0 in the
     prefill and in the first step (the port's ``_route`` and
     ``_dispatch_indices`` on that layer's input); a warm-up run first
     holds the first and last layer's attention, at the prefill and at
     the last step, to the plain versions on the card as phase 16 does;
     launches flash 48 a prefill, decode 48 a step; no logit NaN or
     infinite; a prefill and a step under
     ``torch.cuda.set_sync_debug_mode("error")``; a profiled prefill and
     4 profiled steps; both kernels timed at the model's activations
     beside their plain versions, bounds and library calls (the
     ``zoo_moe`` entries of the kernels line).

The CPU reruns of phases 11, 12, 13 and 15 run in three worker processes
of one thread each (``cpu_job``) while the card runs go on: the
quickstart's, phase 12's, phase 13's and phase 15's start with the build,
the duke and porto worlds' as phase 11 builds them.  Phases 4 and 6 rerun
in line; phase 11's host-clock rates are taken with the workers busy
beside them.  On the host the sweeps' wall gates give their ratios
unasserted (``suite_rerun``): they judge the card's walls.

Times are device times per call: CUDA-graph replays of back-to-back calls,
timed with CUDA events, median over replays
(``repro_torch.benchmarks.kernels_bench.device_ms``).  ``bound_ms`` is the
larger of the bytes the call must move (each input read once, of the
re-id kernels' admission only the columns the gallery names; each output
written once) over 3.35 TB/s and the operations this run's data needs
(for the re-id kernels two per eligible (query, gallery row) pair and
feature; for attention four per (query, key) pair the mask or the lengths
leave, per head dim) over the peak of the unit the kernel computes on:
67 TFLOP/s, the CUDA cores' fp32, for the re-id kernels and the scan;
for attention the tensor cores, 989 TFLOP/s in bfloat16 and 495 / 3 =
165 TFLOP/s in float32 (three TF32 products; ``kernels_bench.peak_flops``);
the H100 SXM data sheet's peaks.  ``library_ms`` times one PyTorch call of
the same function, which the port never calls: ``torch.matmul`` with
masking and ``torch.topk`` for the re-id kernels,
``scaled_dot_product_attention`` for attention, in the inputs' dtype (for
decode on q viewed as (B, KV, G, hd) with the length mask, G query rows a
kv head; at batch 8 or less also the expanding form, q as (B, H, 1, hd)
with ``enable_gqa``, which expands K and V to all H heads); the scan has
none.

Exits non-zero, before the last line, on any failed phase, and without a
result when no card is present or the repository is not beside it.  The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
TOL = 1e-5
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_SHARE = 0.99           # bfloat16 attention outputs equal bit for bit
MODEL_TOL = 1e-4            # attention and scan at model widths
SCAN_TOL = 1e-4
TICKS = 200                 # ticks of the tile path's profiled window
DEVICE = "cuda"
TILE_GRID = 8
CAMERA = dict(name="reid_topk_segment_masked", route="cuda",
              source="src/repro_torch/kernels/csrc/reid_topk.cu",
              replaces="src/repro/kernels/reid_topk.py:139")
TILES = dict(name="reid_topk_tiles", route="cuda",
             source="src/repro_torch/kernels/csrc/reid_topk_tiles.cu",
             replaces="src/repro/kernels/reid_topk.py:265")
#: the kernel benchmark's four kernels, in the benchmark's order
BENCH = {
    "reid_topk": dict(name="reid_topk", route="cuda",
                      source="src/repro_torch/kernels/csrc/reid_topk_plain.cu",
                      replaces="src/repro/kernels/reid_topk.py:63"),
    "flash_attention": dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:22"),
    "decode_attention": dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:21"),
    "mamba_scan": dict(name="mamba_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                       replaces="src/repro/kernels/mamba_scan.py:19"),
}
#: phase 10's shapes: yi-6b's attention layout (configs/yi_6b.py) at
#: train_4k's length and at decode_32k's cache (its batch of 128, and the
#: batch 8 of earlier runs), zamba2-2.7b's decode at batch 32,
#: falcon-mamba-7b's scan (configs/falcon_mamba_7b.py: d_model 4,096 x
#: expand 2, N = 16) over 4,096 steps
#: each (kernel, label, shape, dtype); flash also at zamba2-2.7b's layout
#: (configs/zamba2_2p7b.py: d_model 2,560 over 32 heads, hd 80, no GQA)
#: and at the benchmark's shape in bfloat16
MODEL_SHAPES = [
    ("flash_attention", "yi-6b", dict(B=1, H=32, KV=4, S=4096, T=4096,
                                      hd=128, causal=True), "float32"),
    ("flash_attention", "yi-6b", dict(B=1, H=32, KV=4, S=4096, T=4096,
                                      hd=128, causal=True), "bfloat16"),
    ("flash_attention", "zamba2-2.7b", dict(B=1, H=32, KV=32, S=4096,
                                            T=4096, hd=80, causal=True),
     "float32"),
    ("flash_attention", "zamba2-2.7b", dict(B=1, H=32, KV=32, S=4096,
                                            T=4096, hd=80, causal=True),
     "bfloat16"),
    ("flash_attention", "bench", dict(B=1, H=8, KV=2, S=1024, T=1024, hd=64,
                                      causal=True), "bfloat16"),
    ("decode_attention", "yi-6b", dict(B=8, H=32, KV=4, T=32768, hd=128,
                                       length="random"), "float32"),
    ("decode_attention", "yi-6b", dict(B=128, H=32, KV=4, T=32768, hd=128,
                                       length="random"), "bfloat16"),
    ("decode_attention", "yi-6b", dict(B=128, H=32, KV=4, T=32768, hd=128,
                                       length="random"), "float32"),
    ("decode_attention", "zamba2-2.7b", dict(B=32, H=32, KV=32, T=32768,
                                             hd=80, length="random"),
     "bfloat16"),
    ("mamba_scan", "falcon-mamba-7b", dict(B=1, L=4096, D=8192, N=16),
     "float32"),
    # no model layer runs the re-id top-k; phase 3's stress width, a
    # ResNet-50 re-id embedding's 2,048 features
    ("reid_topk", "stress", dict(Q=256, G=8192, D=2048, k=16), "float32"),
]
#: phase 10's holds of the scan's end state h_L: the bench shape (three
#: passes), falcon-mamba-7b's width (one pass), a state axis of two tiles
#: and a ragged L
END_STATE_SHAPES = [
    ("bench", dict(B=1, L=1024, D=256, N=16)),
    ("falcon-mamba-7b", dict(B=1, L=4096, D=8192, N=16)),
    ("two tiles", dict(B=2, L=300, D=65, N=320)),
    ("ragged", dict(B=2, L=1001, D=192, N=16)),
]
TILE = 64                   # the split kernels' (query, gallery) tile,
                            # reid_topk.SPLIT_QB = SPLIT_GB
HOLD_ROWS = 8               # decode rows the plain version holds at once
#: steps of phase 11's duke trace
TRACE_STEPS = 600
#: phase 14's fleets: workers of the camera and tile fleets, the tick w1
#: is lost at, workers of the transport fleet, and the ticks each fleet
#: serves
FLEET_SHARDS, FLEET_LOSE_AT, TRANSPORT_SHARDS = 4, 1000, 8
FLEET_CUT_TICKS = 2000
#: phase 15's entries on the card, each beside a CPU rerun: the serving
#: sweeps (``repro_torch.benchmarks.scenarios``) and two tables
#: (``repro_torch.benchmarks.tables``); fig17's rerun serves phase 12
SUITE_SWEEPS = ("serving_sweep", "tile_sweep", "serving_shard_sweep",
                 "gallery_sweep", "transport_sweep", "query_churn_sweep")
SUITE_TABLES = ("sec3_potential", "fig10_anoncampus")
FLEET_COUNTERS = ("admitted_steps", "unique_frames", "content_steps",
                  "replay_steps", "model_epoch", "admitted_tiles",
                  "unique_tiles")
#: the tracker's per-query result fields, compared query by query
TRACK_FIELDS = ("cost", "n_match", "n_correct", "visit_hits", "gt_count",
                "delay", "rescued")
#: what phase 13's comparisons read of a serving engine
ENGINE_FIELDS = ("admitted_steps", "unique_frames", "content_steps",
                 "replay_steps", "model_epoch", "model_swaps",
                 "rescue_pairs", "admitted_tiles", "unique_tiles")
#: phase 16's model, the dense zoo's yi-6b (configs/yi_6b.py) at full
#: width: (a) two layers in float32, held to a CPU rerun, forward over
#: S + steps tokens, prefill of S, then ``steps`` decode steps; (b) all 32
#: layers in bfloat16, prefill of S tokens into ``max_len`` slots, then
#: ``steps`` greedy decode steps
ZOO_ARCH = "yi_6b"
ZOO_CHECK = dict(layers=2, B=2, S=128, steps=4)
ZOO_SERVE = dict(B=8, S=1024, max_len=2048, steps=32)
#: the CPU tests' float32 tolerance (tests/test_torch_models.py), the
#: reference's own decode-against-forward bound
ZOO_TOL = 2e-4
#: decode steps of phase 16's profiled window
ZOO_PROFILED = 4
#: phase 17's model, the Mamba1 zoo's falcon-mamba-7b
#: (configs/falcon_mamba_7b.py) at full width: (a) 2 layers in float32
#: beside a CPU rerun, (b) all 64 layers in bfloat16, served
SSM_ARCH = "falcon_mamba_7b"
SSM_CHECK = dict(layers=2, B=2, S=128, steps=4)
SSM_SERVE = dict(B=8, S=1024, steps=32)
#: decode steps of phase 17's profiled window
SSM_PROFILED = 4
#: phase 18's model, the hybrid zoo's zamba2-2.7b
#: (configs/zamba2_2p7b.py) at full width: (a) 12 of 54 layers (two
#: super-blocks, the shared block over two caches) in float32 beside a
#: CPU rerun, (b) all 54 layers in bfloat16, served
HYBRID_ARCH = "zamba2_2p7b"
HYBRID_CHECK = dict(layers=12, B=2, S=128, steps=4)
HYBRID_SERVE = dict(B=8, S=1024, max_len=2048, steps=32)
#: decode steps of phase 18's profiled window
HYBRID_PROFILED = 4
#: phase 19's model, the MoE zoo's qwen3-moe-30b (configs/qwen3_moe_30b.py)
#: at full width: (a) 2 of 48 layers in float32 beside a CPU rerun, (b)
#: all 48 layers in bfloat16, served
MOE_ARCH = "qwen3_moe_30b"
MOE_CHECK = dict(layers=2, B=2, S=128, steps=4)
MOE_SERVE = dict(B=8, S=1024, max_len=2048, steps=32)
#: decode steps of phase 19's profiled window
MOE_PROFILED = 4
#: worker processes for the CPU reruns of phases 11, 12, 13 and 15
#: (``cpu_job``)
CPU_WORKERS = 3
CPU_POOL = None
RERUN_WAIT = 600            # seconds a phase waits for a rerun's result


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# CPU reruns in worker processes
# ---------------------------------------------------------------------------

def _cpu_worker_init() -> None:
    """One thread a worker: the card runs beside it are host-bound."""
    import torch

    torch.set_num_threads(1)


def _timed(fn, args, kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def cpu_job(fn, *args, **kw):
    """Start ``fn(*args, **kw)``, a CPU rerun, in a worker process, so that
    it runs while the card runs go on; ``.get(RERUN_WAIT)`` on the handle
    returns (its result, its seconds) or raises what it raised.  ``fn`` is a
    function of the port or of this script, and its arguments are
    pickled.  The workers are spawned (they never touch the card) with
    this process's ``sys.path``, at the first job, and run one thread
    each; ``main``'s caller terminates them."""
    global CPU_POOL
    if CPU_POOL is None:
        import multiprocessing

        CPU_POOL = multiprocessing.get_context("spawn").Pool(
            CPU_WORKERS, _cpu_worker_init)
    return CPU_POOL.apply_async(_timed, (fn, args, kw))


def engine_view(eng):
    """What phase 13's comparisons read of a serving engine
    (``ENGINE_FIELDS``, the queries' matches, the controller's events,
    polls and counters), as a picklable namespace."""
    from types import SimpleNamespace as NS

    rc = eng.recal
    return NS(**{f: getattr(eng, f) for f in ENGINE_FIELDS},
              queries={k: NS(matches=q.matches)
                       for k, q in eng.queries.items()},
              recal=None if rc is None else NS(
                  events=rc.events, polls=rc.polls,
                  rows_reprofiled=rc.rows_reprofiled,
                  targeted_swaps=rc.targeted_swaps,
                  full_rebuilds=rc.full_rebuilds))


def recal_rerun(which: str):
    """Phase 13's CPU rerun of ``which`` (``drift_sweep``, ``tile drift``,
    ``soak_130`` or ``sec6_drift``): for ``sec6_drift`` its rows, else
    each configuration's trace and ``engine_view``."""
    from repro_torch.benchmarks import drift, scenarios
    from repro_torch.core.profiler import build_model

    if which == "sec6_drift":
        return drift.run(device="cpu", reference=False)
    runs = {}
    if which == "drift_sweep":
        scenarios.drift_sweep(device="cpu", runs=runs)
    elif which == "soak_130":
        scenarios.soak_130(device="cpu", runs=runs)
    else:
        sc = scenarios.drifted_duke()
        hist, trace = sc["hist"], []
        tile_model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out,
                                 hist.n_cams, tile_xy=hist.tile_xy,
                                 tile_grid=TILE_GRID, device="cpu")
        eng, _, _ = scenarios.drive(
            sc, scenarios.DRIFT_POLICY, device="cpu",
            recal=scenarios.DRIFT_RECAL, tile_grid=TILE_GRID,
            model=tile_model, trace=trace)
        runs = {"tiles": dict(eng=eng, trace=trace)}
    return {config: dict(trace=r["trace"], eng=engine_view(r["eng"]))
            for config, r in runs.items()}


def quickstart_rerun():
    """Phase 11's CPU rerun of the quickstart: its printed lines and the
    ``TrackResult`` of each ``api.track`` call, in order."""
    import contextlib
    import io

    from repro_torch import api
    from repro_torch.examples import quickstart as qs

    real_track, results = api.track, []

    def track(*a, **kw):
        results.append(real_track(*a, **kw))
        return results[-1]

    api.track, out = track, io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            qs.main("cpu")
    finally:
        api.track = real_track
    return out.getvalue().splitlines(), results


def suite_rerun(name: str):
    """The CPU rerun of the benchmark entry ``name``
    (``repro_torch.benchmarks.run.ALL``): its rows and records.  The
    sweeps' wall gates (``transport_gates``, ``sublinear_gate``) judge the
    card run's walls; here, on a one-thread host worker, the sublinear gate
    gives its ratios unasserted and the transport gates are not applied.
    Every count assert stays."""
    from repro_torch.benchmarks import run, scenarios

    gates = scenarios.transport_gates, scenarios.sublinear_gate
    scenarios.transport_gates = lambda *a, **kw: None
    scenarios.sublinear_gate = scenarios.sublinear_ratios
    try:
        scenarios.pop_bench_records(name)
        rows = run.ALL[name](device="cpu")
        return rows, scenarios.pop_bench_records(name)
    finally:
        scenarios.transport_gates, scenarios.sublinear_gate = gates


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def eligible(torch, q_tag, admit, gal_cam, gal_tag):
    """(Q, G) bool: the pairs a kernel may score (cell or camera in range
    and admitted, tags equal)."""
    C = admit.shape[1]
    ok = (gal_cam >= 0) & (gal_cam < C)
    cams = torch.where(ok, gal_cam, 0).long()
    return admit[:, cams] & ok[None, :] & (gal_tag[None, :] == q_tag[:, None])


def live_tiles(torch, args):
    """(live, total) (64-row, 64-row) tiles of one call: a tile is live
    when it holds an eligible pair, and the tile kernel runs the product of
    live tiles only."""
    valid = eligible(torch, args[1], args[2], args[4], args[5])
    Q, G = valid.shape
    nq, ng = -(-Q // TILE), -(-G // TILE)
    padded = torch.zeros((nq * TILE, ng * TILE), dtype=torch.bool,
                         device=valid.device)
    padded[:Q, :G] = valid
    live = padded.reshape(nq, TILE, ng, TILE).any(dim=3).any(dim=1)
    return int(live.sum()), nq * ng


def bound(torch, args, k: int):
    """(ms, "bytes" or "operations"): the least time of one masked top-k
    call.  Of admit the function reads only the columns that the gallery's
    in-range cameras or cells name, one byte a query row each."""
    q, q_tag, admit, g, gal_cam, gal_tag = args
    Q, D = q.shape
    C = admit.shape[1]
    named = gal_cam[(gal_cam >= 0) & (gal_cam < C)]
    nbytes = (q.numel() * 4 + q_tag.numel() * 4
              + Q * int(torch.unique(named).numel())
              + g.numel() * 4 + gal_cam.numel() * 4 + gal_tag.numel() * 4
              + Q * k * 8)
    ops = 2 * D * int(eligible(torch, q_tag, admit, gal_cam, gal_tag).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(torch, neg_inf):
    """One PyTorch composition of the masked top-k (yardstick); the same
    for both kernels, whose camera or cell axis is admit's columns."""
    def run(q, q_tag, admit, g, gal_cam, gal_tag, k):
        s = torch.matmul(q, g.T)
        C = admit.shape[1]
        ok = (gal_cam >= 0) & (gal_cam < C)
        valid = admit[:, torch.where(ok, gal_cam, 0).long()] & ok[None, :] \
            & (gal_tag[None, :] == q_tag[:, None])
        return torch.topk(torch.where(valid, s, neg_inf), min(k, g.shape[0]),
                          dim=1)
    return run


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def check_against_plain(torch, kern, name, args, k, exact_idx, got=None):
    """Kernel vs plain version on the same card inputs; returns the max
    absolute score error.  Slots past the plain version's k + 1-th band let
    a near-tie at the last slot be recognised.  ``kern`` holds the wrapper
    (``call``) and the plain version (``plain``); ``got``, when given, is
    the kernel's output on ``args``, computed elsewhere."""
    kv, ki = kern["call"](*args, k) if got is None else got
    pv, pi = kern["plain"](*args, k + 1)
    torch.cuda.synchronize()
    if kv.shape != (args[0].shape[0], k) or ki.dtype != torch.int32:
        fail(f"{name}: kernel returned {tuple(kv.shape)} {ki.dtype}")
    if not torch.isfinite(kv).all():
        fail(f"{name}: non-finite kernel scores")
    err = float((kv - pv[:, :k]).abs().max()) if kv.numel() else 0.0
    if not torch.allclose(kv, pv[:, :k], rtol=TOL, atol=TOL):
        fail(f"{name}: scores differ from the plain version (max abs {err})")
    bad = ki != pi[:, :k]
    if exact_idx:
        if bad.any():
            fail(f"{name}: indices differ on integer-valued inputs")
    else:
        near = torch.zeros_like(bad)
        gap = (pv[:, 1:] - pv[:, :-1]).abs() <= TOL * (1 + pv[:, 1:].abs())
        near[:, 1:] |= gap[:, :k - 1]
        near |= gap[:, :k]
        if (bad & ~near).any():
            fail(f"{name}: indices differ away from any near-tie")
    return err


def synthetic_inputs(torch, rng, Q, G, D, C, *, ties=False, n_tags=3,
                     p_admit=0.6, masked_row=False, pad_rows=0,
                     boundary_ties=False, masked_slices=False):
    """Seeded inputs of a masked top-k.  ``boundary_ties`` makes the rows
    either side of every 64-row slice boundary equal; ``masked_slices``
    gives the gallery's second and fourth 64-row tiles one camera that no
    query admits."""
    import numpy as np

    if ties:
        qf = rng.integers(0, 2, (Q, D)).astype(np.float32)
        gf = rng.integers(0, 2, (G, D)).astype(np.float32)
    else:
        qf = rng.normal(size=(Q, D)).astype(np.float32)
        gf = rng.normal(size=(G, D)).astype(np.float32)
    if boundary_ties:
        for b in range(TILE, G - 1, TILE):
            gf[b] = gf[b - 1]
            gf[b + 1] = gf[b - 2]
    q_tag = rng.integers(0, n_tags, Q).astype(np.int32)
    gal_tag = rng.integers(0, n_tags, G).astype(np.int32)
    admit = rng.random((Q, C)) < p_admit
    gal_cam = rng.integers(0, C, G).astype(np.int32)
    if masked_slices:
        gal_cam[TILE:2 * TILE] = gal_cam[3 * TILE:4 * TILE] = C - 1
        admit[:, C - 1] = False
    if masked_row and Q:
        admit[0] = False
    if pad_rows:
        gal_cam[G - pad_rows:] = -1
        gal_tag[G - pad_rows:] = -1
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (qf, q_tag, admit, gf, gal_cam, gal_tag))


def measure(torch, kern, lib, args, k):
    from repro_torch.benchmarks.kernels_bench import device_ms

    b_ms, b_by = bound(torch, args, k)
    return dict(
        ms=device_ms(lambda: kern["call"](*args, k)),
        plain_ms=device_ms(lambda: kern["plain"](*args, k)),
        library_ms=(device_ms(lambda: lib(*args, k))
                    if args[3].shape[0] >= k else None),
        bound_ms=b_ms, bound_by=b_by)


def check_and_time(torch, kern, lib, label, args, k, exact_idx):
    """Hold the kernel to its plain version on ``args``, time both and the
    library yardstick, print one line; returns (max abs err, timings)."""
    err = check_against_plain(torch, kern, label, args, k, exact_idx)
    t = measure(torch, kern, lib, args, k)
    Q, D = args[0].shape
    lib_ms = "n/a (k > G)" if t["library_ms"] is None \
        else f"{t['library_ms']:.4f} ms"
    live, total = live_tiles(torch, args)
    t["plan"] = kern["plan"](Q, args[3].shape[0])
    say(f"  {label}: Q={Q} G={args[3].shape[0]} D={D} "
        f"{kern['axis']}={args[2].shape[1]} k={k} agree (max abs err "
        f"{err:.3g}); plan {t['plan']}; kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {lib_ms}, bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']}); live tiles "
        f"{live}/{total}")
    return err, t


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def device_share(torch, serve, tag: str, ticks: int = 200):
    """Where a tick's time goes: the main path served again for ``ticks``
    ticks under ``torch.profiler``; prints the device's busy time (kernels
    and copies) against the host clock, the device operations and the
    device-to-host copies a tick, and the operations that took the most
    device time; returns the busy share and the two per-tick counts.  Only
    device activity is recorded (the host's operations would multiply the
    profiler's own work, which grows with every event it must sort out);
    its overhead still lengthens the host clock, so the busy share it gives
    is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, tick_s = serve(DEVICE, None, ticks)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): a host op's device time
    # repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = sum(tick_s) * 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    rank_ms = sum(e.self_device_time_total for e in events
                  if "reid_topk" in e.key or "merge_slices" in e.key) / 1e3
    n = len(tick_s)
    share = dict(busy=busy_ms / wall_ms,
                 ops=sum(e.count for e in events) / n,
                 d2h=sum(e.count for e in events if "DtoH" in e.key) / n)
    say(f"{tag} profiled {n} ticks: device busy "
        f"{busy_ms:.3f} ms of {wall_ms:.3f} ms host clock "
        f"({100 * share['busy']:.2f} % busy), of it the re-id top-k "
        f"kernels (and their merges) {rank_ms:.3f} ms; "
        f"{share['ops']:.1f} device operations a tick, "
        f"{share['d2h']:.1f} of them device-to-host copies; most device "
        f"time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))
    return share


def record_key(r, with_idx=True):
    return (r["qid"], r["f_curr"], r["phase"], r["epoch"],
            tuple(bool(x) for x in r["mask"]), bool(r["matched"]),
            int(r["match_cam"]), int(r["match_idx"]) if with_idx else None,
            tuple((c, f) for _, c, f in r["topk"]))


def same_record(a, b, with_idx=True):
    vals_a = [a["match_val"]] + [v for v, _, _ in a["topk"]]
    vals_b = [b["match_val"]] + [v for v, _, _ in b["topk"]]
    return record_key(a, with_idx) == record_key(b, with_idx) and all(
        abs(x - y) <= TOL * (1 + abs(y)) for x, y in zip(vals_a, vals_b))


def compare_traces(gpu, cpu, match_thresh):
    """Query by query, record by record: everything exact but the scores
    (1e-5).  The one difference forgiven is a record whose band-0 score
    lies within 1e-5 of the match threshold, where fp32 rounding may
    decide the match: it is printed and that query's later records are
    not compared, since its two runs may rightly part there.  The other
    queries' records are all compared; their ``match_idx`` only before the
    forgiven record, because the parted query's admitted frames shift the
    later round galleries' rows (band cameras and frames still name each
    row).  Fails if a second query parts.  Returns the number of records
    compared and the parted query (or None)."""
    if not gpu:
        fail("empty trace")
    by_q = {}
    for side, trace in enumerate((gpu, cpu)):
        for pos, r in enumerate(trace):
            by_q.setdefault(r["qid"], ([], []))[side].append((pos, r))
    # pass 1: where each query first differs, row indices aside
    parted = None           # (qid, cuda trace position of the record)
    for qid, (ra, rb) in sorted(by_q.items()):
        for (pos, a), (_, b) in zip(ra, rb):
            if same_record(a, b, with_idx=False):
                continue
            v0 = b["topk"][0][0]
            if parted is None and abs((1.0 - v0) - match_thresh) <= TOL:
                say(f"  query {qid} parts at an fp32 near-threshold "
                    f"record; its later records are not compared:\n"
                    f"    cuda {a}\n    cpu  {b}")
                parted = (qid, pos)
                break
            fail(f"trace record of query {qid} differs:\n  cuda {a}\n  "
                 f"cpu  {b}")
        else:
            if len(ra) != len(rb):
                fail(f"query {qid}: cuda has {len(ra)} records, cpu "
                     f"{len(rb)}")
    # pass 2: the row indices, up to the parting
    stop = len(gpu) if parted is None else parted[1]
    n = 0
    for qid, (ra, rb) in sorted(by_q.items()):
        for (pos, a), (_, b) in zip(ra, rb):
            if parted is not None and qid == parted[0] and pos >= stop:
                break
            if pos < stop and not same_record(a, b):
                fail(f"trace record of query {qid} differs in match_idx:"
                     f"\n  cuda {a}\n  cpu  {b}")
            n += 1
    return n, None if parted is None else parted[0]


def first_parting(tracker, np, trace_of, q, thresh):
    """Trace query ``q`` alone (queries do not interact) on the card and
    on the host and return (step, margin) of the first step where the two
    differ, the margin being the least |d - match_thresh| of the two
    winning distances there; None if the traces agree."""
    a, b = trace_of(q, "cuda"), trace_of(q, "cpu")
    diff = np.zeros(len(a["live"]), bool)
    for k in tracker.TRACE_KEYS + ("best_d",):
        diff |= (a[k] != b[k]).reshape(len(diff), -1).any(1)
    if not diff.any():
        return None
    s = int(np.flatnonzero(diff)[0])
    return s, float(min(abs(a["best_d"][s, 0] - thresh),
                        abs(b["best_d"][s, 0] - thresh)))


def compare_tracks(tracker, np, label, gpu, cpu, trace_of, thresh):
    """Hold the card's ``TrackResult`` to the host rerun's: every
    per-query field and ``rescue_pairs`` exact.  One query may part at a
    near-threshold step (|d - match_thresh| <= 1e-5): it is printed and
    left out.  Returns the parted query or None."""
    n = len(cpu.cost)
    bad = sorted({int(i) for f in TRACK_FIELDS for i in np.flatnonzero(
        (getattr(gpu, f) != getattr(cpu, f)).reshape(n, -1).any(1))})
    parted = None
    for q in bad:
        where = first_parting(tracker, np, trace_of, q, thresh)
        if parted is None and where is not None and where[1] <= TOL:
            say(f"  {label}: query {q} parts at step {where[0]}, "
                f"|d - match_thresh| = {where[1]:.3g} (near threshold); "
                f"its fields are not compared")
            parted = q
            continue
        fail(f"{label}: query {q} differs from the cpu rerun "
             + ("" if where is None else f"from step {where[0]}, "
                f"|d - match_thresh| = {where[1]:.3g} ")
             + "; ".join(f"{f} cuda {getattr(gpu, f)[q]} cpu "
                         f"{getattr(cpu, f)[q]}" for f in TRACK_FIELDS))
    if parted is None and not np.array_equal(gpu.rescue_pairs,
                                             cpu.rescue_pairs):
        fail(f"{label}: rescue_pairs differ from the cpu rerun")
    return parted


def track_line(r, wall, base_cost=None):
    """One tracker run; savings against ``base_cost``, the all-camera
    run's cost, where that run was made."""
    return (f"{wall:.2f} s, {r.steps} steps, {r.steps / wall:.1f} steps/s; "
            f"cost {r.total_cost:.0f}, recall {r.recall:.4f}, precision "
            f"{r.precision:.4f}, "
            + (f"savings {base_cost / r.total_cost:.3f}x, " if base_cost
               else "")
            + f"mean delay {r.mean_delay:.3f}, rescues "
            f"{int(r.rescued.sum())}")


def tracker_share(run, tag: str, steps: int):
    """Where a tracker step's time goes: ``run()`` (``steps`` steps of the
    tracker on the card) under ``torch.profiler``; prints the device's
    busy time against the host clock, the device operations (kernels and
    copies) a step, and those that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()                            # ends with the trace on the host
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    copies = sum(e.count for e in events if "Memcpy" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    say(f"{tag} profiled {steps} steps: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms host clock ({100 * busy_ms / wall_ms:.2f} % "
        f"busy); {ops / steps:.1f} device operations a step, "
        f"{copies / steps:.1f} of them copies; most device time: "
        + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in top))


def phase_tracker(np, qs_rerun, device=DEVICE):
    """Phase 11 (see the module docstring): the runs on ``device`` against
    their reruns on the CPU, which run in worker processes meanwhile
    (``qs_rerun``: the quickstart's, started with the build)."""
    import contextlib
    import io

    from repro_torch import api
    from repro_torch.benchmarks import scenarios
    from repro_torch.core import tracker
    from repro_torch.examples import quickstart as qs

    t_phase = time.perf_counter()
    seen = set()                       # devices of the loop state
    real_step, real_track = tracker._track_step, api.track

    def step(st, w, windows):
        seen.update(t.device.type for t in (
            st.q_feat, st.cost, st.visit_hits, st.rescue_pairs,
            st.ps.f_curr, st.ps.done, w.gallery, w.feats, w.model.S))
        return real_step(st, w, windows)

    records = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = real_track(*a, **kw)
        records.append((time.perf_counter() - t0, r))
        return r

    def on_card(fn):
        seen.clear()
        tracker._track_step = step
        try:
            return fn()
        finally:
            tracker._track_step = real_step
            if seen != {device}:
                fail(f"the tracker's loop state lived on {sorted(seen)}, "
                     f"not {device}")

    # (a) the quickstart world, through the example's own main()
    api.track = timed
    try:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            on_card(lambda: qs.main(device))
        say(f"[11 track] quickstart on {device}: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        api.track = real_track
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"  | {line}")
    for (wall, r), name in zip(records, ("all", "S5-T2")):
        say(f"[11 track] quickstart {name} on {device}: "
            + track_line(r, wall, records[0][1].total_cost))
    (cpu_lines, cpu_results), secs = qs_rerun.get(RERUN_WAIT)
    if lines != cpu_lines:
        fail("the quickstart's lines differ from the cpu rerun's:\n"
             + "\n".join(cpu_lines))
    for (_, a), b in zip(records, cpu_results, strict=True):
        for f in TRACK_FIELDS + ("rescue_pairs",):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                fail(f"quickstart: {f} differs from the cpu rerun's")
    say(f"[11 track] quickstart cpu rerun in {secs:.1f} s: lines and every "
        f"TrackResult field equal, rescue_pairs too")

    def run_world(label, model, vis, gal, feats, q, gt, runs):
        """Each (name, policy, geo_adj) on the card; the reruns on the host
        start first, in the worker processes."""
        model_cpu = model.to("cpu")
        reruns = [cpu_job(api.track, model_cpu, vis, gal, feats, q, gt, pol,
                          geo_adj=geo, device="cpu") for _, pol, geo in runs]
        base = None
        for (name, pol, geo), rerun in zip(runs, reruns):
            t0 = time.perf_counter()
            r = on_card(lambda: api.track(model, vis, gal, feats, q, gt, pol,
                                          geo_adj=geo, device=device))
            wall = time.perf_counter() - t0
            base = base or r.total_cost
            say(f"[11 track] {label} {name} on {device}: "
                + track_line(r, wall, base))
            c, secs = rerun.get(RERUN_WAIT)

            def trace_of(i, dev, pol=pol, geo=geo, steps=r.steps):
                return tracker.trace_queries(
                    model if dev == device else model_cpu, vis, gal, feats,
                    q[i:i + 1], gt[i:i + 1], pol, geo_adj=geo, n_steps=steps,
                    device=device if dev == device else "cpu",
                    with_dist=True)

            parted = compare_tracks(tracker, np, f"{label} {name}", r, c,
                                    trace_of, pol.match_thresh)
            say(f"[11 track] {label} {name} cpu rerun in {secs:.1f} s: "
                + ("every field equal, rescue_pairs too" if parted is None
                   else f"every field equal but query {parted}'s"))

    s5t2 = api.SearchPolicy(scheme="rexcam", s_thresh=.05, t_thresh=.02)

    # (b) fig11's duke world (``scenarios.duke``, the tables' world)
    t0 = time.perf_counter()
    trace_steps = TRACE_STEPS
    sc = scenarios.duke()
    net, vis, gal, feats = sc["net"], sc["vis"], sc["gal"], sc["feats"]
    q, gt, model = sc["q_vids"], sc["gt_vids"], sc["model"].to(device)
    say(f"[11 track] duke world: {net.n_cams} cameras, {len(vis)} visits, "
        f"horizon {vis.horizon}, {len(q)} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")
    trace_rerun = cpu_job(tracker.trace_queries, model.to("cpu"), vis, gal,
                          feats, q, gt, s5t2, n_steps=trace_steps,
                          device="cpu", with_dist=True)
    run_world("duke", model, vis, gal, feats, q, gt,
              [("all", api.SearchPolicy(scheme="all"), None),
               ("geo", api.SearchPolicy(scheme="geo"), net.geo_adjacent),
               ("S5-T2", s5t2, None)])
    t0 = time.perf_counter()
    tr = {device: on_card(lambda: tracker.trace_queries(
        model, vis, gal, feats, q, gt, s5t2, n_steps=trace_steps,
        device=device, with_dist=True))}
    tr["cpu"], secs = trace_rerun.get(RERUN_WAIT)
    diff = np.zeros((trace_steps, len(q)), bool)       # (step, query)
    for k in tracker.TRACE_KEYS + ("best_d",):
        diff |= (tr[device][k] != tr["cpu"][k]).reshape(
            trace_steps, len(q), -1).any(2)
    for i in np.flatnonzero(diff.any(0)):
        s = int(np.flatnonzero(diff[:, i])[0])
        margin = min(abs(tr[dev]["best_d"][s, i] - s5t2.match_thresh)
                     for dev in tr)
        if diff.any(0).sum() > 1 or margin > TOL:
            fail(f"duke S5-T2 trace: query {i} differs from the cpu rerun "
                 f"from step {s} (|d - match_thresh| = {margin:.3g})")
        say(f"  duke S5-T2 trace: query {i} parts at step {s}, "
            f"|d - match_thresh| = {margin:.3g} (near threshold)")
    say(f"[11 track] duke S5-T2 trace_queries, {trace_steps} steps x "
        f"{len(q)} queries: every array equal to the cpu rerun's "
        f"({int(tr[device]['live'].sum())} live query-steps, "
        f"{int(tr[device]['matched'].sum())} matches) in "
        f"{time.perf_counter() - t0:.1f} s on {device}, the rerun "
        f"{secs:.1f} s")

    tracker_share(lambda: tracker.trace_queries(
        model, vis, gal, feats, q, gt, s5t2, n_steps=200, device=device),
        "[11 track] duke S5-T2", 200)

    # (c) fig12's 130-camera porto world (``scenarios.porto``)
    t0 = time.perf_counter()
    sc = scenarios.porto(130)
    net, vis, gal, feats = sc["net"], sc["vis"], sc["gal"], sc["feats"]
    q, gt, model = sc["q_vids"], sc["gt_vids"], sc["model"].to(device)
    say(f"[11 track] porto world: {net.n_cams} cameras, {len(vis)} visits, "
        f"horizon {vis.horizon}, {len(q)} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")
    run_world("porto", model, vis, gal, feats, q, gt,
              [("S5-T2", s5t2, None)])
    say(f"[11 track] phase seconds {time.perf_counter() - t_phase:.1f}")


def detection_rerun():
    """Phase 12's CPU rerun: fig17's rows and its runs' full summaries."""
    from repro_torch.benchmarks import tables

    summaries = []
    rows = tables.fig17_identity_detection(device="cpu", summaries=summaries)
    return rows, summaries


def phase_detection(rerun, device=DEVICE):
    """Phase 12 (see the module docstring): ``tables.fig17_identity_detection``
    on ``device`` against its CPU rerun (``rerun``, a ``detection_rerun``
    handle): the rows, and each run's whole summary (cost, recall,
    precision, found_rate, rounds) exactly."""
    from repro_torch.benchmarks import tables

    t_phase = time.perf_counter()
    say(f"[12 detect] fig17 on the duke world, {tables.DETECT_QUERIES} lost "
        f"identities from t={tables.DETECT_START}")
    summaries = []
    rows = tables.fig17_identity_detection(device=device,
                                           summaries=summaries)
    secs = time.perf_counter() - t_phase
    (cpu_rows, cpu_summaries), cpu_secs = rerun.get(RERUN_WAIT)
    for (name, us, derived), (c_name, _, c_derived) in zip(
            rows, cpu_rows, strict=True):
        if (name, derived) != (c_name, c_derived):
            fail(f"[12 detect] {name}: cuda {derived} != cpu {c_derived}")
        say(f"[12 detect] {name}: {us / 1e6:.4f} s a query on {device}; "
            f"{derived}; equal to the cpu rerun")
    base = None
    for (name, r), (c_name, c_r) in zip(summaries, cpu_summaries,
                                        strict=True):
        if (name, r) != (c_name, c_r):
            fail(f"[12 detect] {name}: cuda {r} != cpu {c_r}")
        base = base or r["cost"]
        say(f"[12 detect] {name} summary: cost {r['cost']:.0f} "
            f"({base / r['cost']:.3f}x), recall {r['recall']:.4f}, "
            f"precision {r['precision']:.4f}, found_rate "
            f"{r['found_rate']:.4f}, rounds {r['rounds']}; equal to the cpu "
            f"rerun")
    say(f"[12 detect] fig17 {secs:.1f} s on {device}, the cpu rerun "
        f"{cpu_secs:.1f} s")
    say(f"[12 detect] phase seconds {time.perf_counter() - t_phase:.1f}")


def recal_line(run):
    """ticks/s, tick p50/p99, the swap ticks and each swap's profile and
    swap seconds of one serving run (``scenarios.drive``'s outputs)."""
    import numpy as np

    eng, lat = run["eng"], np.asarray(run["tick_s"]) * 1e3
    walls = [] if eng.recal is None else eng.recal.walls
    return (f"{len(lat)} ticks, {len(lat) / (lat.sum() / 1e3):.1f} ticks/s, "
            f"tick p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms; admitted_steps="
            f"{eng.admitted_steps} unique_frames={eng.unique_frames} "
            f"epoch {eng.model_epoch}, swaps at "
            f"{[t for t, _ in eng.model_swaps]}"
            + "".join(f"; swap {i + 1}: profile {p * 1e3:.3f} ms, swap "
                      f"{w * 1e3:.3f} ms" for i, (p, w) in enumerate(walls)))


def same_recal_runs(label, gpu_runs, cpu_runs, match_thresh):
    """Hold each configuration's card run to its CPU rerun: every trace
    record (scores within 1e-5, no parting forgiven: a swap moves with the
    rescues), the engine's counters and swaps, and the controller's
    events (scores within 1e-5), polls and counters."""
    for config, g in gpu_runs.items():
        c = cpu_runs[config]
        n, parted = compare_traces(g["trace"], c["trace"], match_thresh)
        if parted is not None:
            fail(f"[13 recal] {label} {config}: query {parted} parted from "
                 f"the cpu rerun")
        ge, ce = g["eng"], c["eng"]
        for f in ("admitted_steps", "unique_frames", "content_steps",
                  "replay_steps", "model_epoch", "model_swaps"):
            if getattr(ge, f) != getattr(ce, f):
                fail(f"[13 recal] {label} {config}: {f} cuda "
                     f"{getattr(ge, f)} cpu {getattr(ce, f)}")
        if (ge.rescue_pairs != ce.rescue_pairs).any() or [
                q.matches for q in ge.queries.values()] != [
                q.matches for q in ce.queries.values()]:
            fail(f"[13 recal] {label} {config}: rescues or matches differ")
        if ge.recal is not None:
            gc, cc = ge.recal, ce.recal
            pairs = list(zip(gc.events, cc.events)) + list(zip(gc.polls,
                                                               cc.polls))
            if len(gc.events) != len(cc.events) or \
                    len(gc.polls) != len(cc.polls) or any(
                    {k: v for k, v in a.items() if k != "score"}
                    != {k: v for k, v in b.items() if k != "score"}
                    or abs(a["score"] - b["score"])
                    > TOL * (1 + abs(b["score"])) for a, b in pairs):
                fail(f"[13 recal] {label} {config}: controller events or "
                     f"polls differ:\n  cuda {gc.events}\n  cpu  "
                     f"{cc.events}")
            for f in ("rows_reprofiled", "targeted_swaps", "full_rebuilds"):
                if getattr(gc, f) != getattr(cc, f):
                    fail(f"[13 recal] {label} {config}: {f} differs")
        say(f"[13 recal] {label} {config}: {n} trace records, counters, "
            f"swaps" + (" and controller" if ge.recal is not None else "")
            + " equal to the cpu rerun's")


def phase_recalibration(np, torch, recorder, kernels, max_err, reruns):
    """Phase 13 (see the module docstring).  ``recorder`` wraps an
    ``ops`` entry to record its round shapes and keep one input of each;
    ``kernels`` are the camera and tile kernels' dicts (``call``,
    ``plain``) and ``max_err`` their largest errors so far; ``reruns``
    the handles of the CPU reruns (``recal_rerun``), started with the
    build.  Returns each kernel's launches over the phase's card runs."""
    from repro_torch.benchmarks import drift, scenarios
    from repro_torch.core.profiler import build_model
    from repro_torch.kernels import ops, reid_topk

    t_phase = time.perf_counter()
    camera, tiles = kernels
    launches = {}
    fleet_runs = []         # (launches, engine) of each fleet run on the card
    real_drive = scenarios.drive

    def counted_drive(*a, **kw):
        """``scenarios.drive`` keeping each fleet run's kernel launches."""
        n0 = reid_topk.LAUNCHES + reid_topk.TILE_LAUNCHES
        out = real_drive(*a, **kw)
        if kw.get("shards"):
            fleet_runs.append((reid_topk.LAUNCHES + reid_topk.TILE_LAUNCHES
                               - n0, out[0]))
        return out

    def fleet_launches(label, shards):
        """The one fleet run of ``label``: its launches must equal its
        rank dispatches, one per worker holding a row of a ranked round."""
        n, eng = fleet_runs.pop()
        fleet_runs.clear()
        if eng.n_shards + eng.rebalances != shards or \
                n != eng.worker_dispatches or n == 0:
            fail(f"[13 recal] {label}: {shards}-worker fleet launched "
                 f"{n} times against {eng.worker_dispatches} worker "
                 f"dispatches ({eng.n_shards} live workers)")
        say(f"[13 recal] {label}: fleet of {shards} workers, "
            f"{eng.rebalances} rebalances, camera kernel launches {n} (= "
            f"worker_dispatches, over {len(eng.model_swaps)} swaps)")
        return eng

    def on_card(label, entry, fn):
        """``fn()`` on the card with its kernel's count reset just before
        and read just after; the count must equal the rounds that ranked
        a non-empty gallery (a fleet's round one a worker holding a row),
        the other kernel's must be 0."""
        rounds, kept = [], {}
        real, wrapped = recorder(entry, rounds, kept)
        setattr(ops, entry, wrapped)
        scenarios.drive = counted_drive
        reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
        try:
            out = fn()
        finally:
            setattr(ops, entry, real)
            scenarios.drive = real_drive
            cam_n, tile_n = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
        n, other = (cam_n, tile_n) if entry == "reid_topk_segments" \
            else (tile_n, cam_n)
        nonempty = sum(1 for q, g in rounds if q > 0 and g > 0)
        if n == 0 or n != nonempty or other:
            fail(f"[13 recal] {label}: {entry} launches {n}, non-empty "
                 f"rounds {nonempty}, the other kernel's launches {other}")
        kern = camera if entry == "reid_topk_segments" else tiles
        for shape, (args, k) in kept.items():
            err = check_against_plain(torch, kern, f"{label} {shape}", args,
                                      k, exact_idx=False)
            max_err[kern["name"]] = max(max_err[kern["name"]], err)
        launches[label] = n
        say(f"[13 recal] {label}: {kern['name']} launches {n} (= non-empty "
            f"rounds), the other kernel 0; {len(kept)} round shapes held "
            f"to the plain version")
        return out

    # (1) drift_sweep's world, frozen and recalibrated
    t0 = time.perf_counter()
    sc = scenarios.drifted_duke()
    say(f"[13 recal] duke-drift world: {sc['net'].n_cams} cameras, "
        f"{len(sc['vis'])} live visits, horizon {sc['vis'].horizon}, shift "
        f"at {sc['t_shift']}, {len(sc['q_vids'])} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")
    runs, rows, recs = {DEVICE: {}}, {}, {}
    scenarios.pop_bench_records("drift_sweep")
    t0 = time.perf_counter()
    rows[DEVICE] = on_card("drift_sweep", "reid_topk_segments",
                           lambda: scenarios.drift_sweep(
                               device=DEVICE, runs=runs[DEVICE]))
    recs[DEVICE] = scenarios.pop_bench_records("drift_sweep")
    say(f"[13 recal] drift_sweep on {DEVICE}: "
        f"{time.perf_counter() - t0:.1f} s")
    runs["cpu"], secs = reruns["drift_sweep"].get(RERUN_WAIT)
    say(f"[13 recal] drift_sweep on cpu: {secs:.1f} s")
    for name, _, derived in rows[DEVICE]:
        say(f"  | {name}: {derived}")
    for config, run in runs[DEVICE].items():
        say(f"[13 recal] drift_sweep {config} on {DEVICE}: "
            + recal_line(run))
    frozen, fresh = recs[DEVICE][:2]
    if not runs[DEVICE]["recalibrated"]["eng"].recal.events or \
            fresh["recall"] <= frozen["recall"]:
        fail(f"[13 recal] drift_sweep: no swap, or recalibrated recall "
             f"{fresh['recall']} not above frozen {frozen['recall']}")
    fleet_launches("drift_sweep recalibrated_shards8", 8)
    same_recal_runs("drift_sweep", runs[DEVICE], runs["cpu"],
                    scenarios.DRIFT_POLICY.match_thresh)

    # (2) the same world profiled and served with tile_grid=8
    hist = sc["hist"]
    tile_model = build_model(hist.ent, hist.cam, hist.t_in, hist.t_out,
                             hist.n_cams, tile_xy=hist.tile_xy,
                             tile_grid=TILE_GRID, device="cpu")
    trace = []
    eng, wall, lat = on_card("tile drift", "reid_topk_tiles",
                             lambda: scenarios.drive(
                                 sc, scenarios.DRIFT_POLICY, device=DEVICE,
                                 recal=scenarios.DRIFT_RECAL,
                                 tile_grid=TILE_GRID, model=tile_model,
                                 trace=trace))
    t_runs = {DEVICE: {"tiles": dict(eng=eng, wall=wall, tick_s=lat,
                                     trace=trace)}}
    say(f"[13 recal] tile drift on {DEVICE}: {wall:.1f} s")
    t_runs["cpu"], secs = reruns["tile drift"].get(RERUN_WAIT)
    say(f"[13 recal] tile drift on cpu: {secs:.1f} s")
    say(f"[13 recal] tile drift (tile_grid={TILE_GRID}) on {DEVICE}: "
        + recal_line(t_runs[DEVICE]["tiles"])
        + f"; admitted_tiles={eng.admitted_tiles} "
        f"unique_tiles={eng.unique_tiles}, masks learned "
        f"{eng.model.tile_learned}")
    if not eng.recal.events or not eng.model.tile_learned:
        fail("[13 recal] tile drift: no swap, or the learned masks were "
             "not carried across it")
    if (eng.admitted_tiles, eng.unique_tiles) != (
            t_runs["cpu"]["tiles"]["eng"].admitted_tiles,
            t_runs["cpu"]["tiles"]["eng"].unique_tiles):
        fail("[13 recal] tile drift: tile counters differ from the cpu "
             "rerun's")
    same_recal_runs("tile drift", t_runs[DEVICE], t_runs["cpu"],
                    scenarios.DRIFT_POLICY.match_thresh)

    # (3) soak_130: exhaustive and full on one engine, targeted on 8 workers
    t0 = time.perf_counter()
    sc = scenarios.soak_city()
    say(f"[13 recal] city-130 world: {sc['net'].n_cams} cameras, "
        f"{len(sc['vis'])} live visits, horizon {sc['vis'].horizon}, "
        f"drifted rows {[int(r) for r in sc['drift_rows']]}, "
        f"{len(sc['q_vids'])} "
        f"queries; built in {time.perf_counter() - t0:.1f} s")
    runs = {DEVICE: {}}
    scenarios.pop_bench_records("soak_130")
    t0 = time.perf_counter()
    rows[DEVICE] = on_card("soak_130", "reid_topk_segments",
                           lambda: scenarios.soak_130(device=DEVICE,
                                                      runs=runs[DEVICE]))
    recs[DEVICE] = scenarios.pop_bench_records("soak_130")
    say(f"[13 recal] soak_130 on {DEVICE}: "
        f"{time.perf_counter() - t0:.1f} s")
    runs["cpu"], secs = reruns["soak_130"].get(RERUN_WAIT)
    say(f"[13 recal] soak_130 on cpu: {secs:.1f} s")
    for name, _, derived in rows[DEVICE]:
        say(f"  | {name}: {derived}")
    for config, run in runs[DEVICE].items():
        say(f"[13 recal] soak_130 {config} on {DEVICE}: " + recal_line(run))
    gate = recs[DEVICE][-1]
    C = sc["net"].n_cams
    if gate["savings_x"] < 20 or \
            gate["recall_targeted"] < gate["recall_exhaustive"] - .05 or \
            gate["recall_targeted"] < gate["recall_full"] - .02 or \
            gate["rows_per_targeted_swap"] >= C:
        fail(f"[13 recal] soak_130 gate: {gate}")
    fleet = fleet_launches("soak_130 targeted_fleet", 8)
    if recs[DEVICE][1]["shards"] != 8 or fleet.rebalances != 1:
        fail("[13 recal] soak_130: targeted_fleet must run 8 workers and "
             "rebalance once")
    same_recal_runs("soak_130", runs[DEVICE], runs["cpu"],
                    scenarios.SOAK_POLICY.match_thresh)

    def soak_targeted(dev, _trace, _ticks):
        eng, _, lat = scenarios.drive(
            sc, scenarios.SOAK_POLICY, device=dev,
            recal=scenarios.SOAK_RECAL_TARGETED, churn_wave=60)
        return eng, lat

    # the targeted run on one engine, as in earlier runs (phase 14
    # profiles the fleet)
    device_share(torch, soak_targeted,
                 "[13 recal] soak_130 targeted (one engine)")

    # (4) sec6_drift through the tracker: the two rows that see the drift
    t0 = time.perf_counter()
    out = {DEVICE: drift.run(device=DEVICE, reference=False)}
    say(f"[13 recal] sec6_drift on {DEVICE}: "
        f"{time.perf_counter() - t0:.1f} s")
    out["cpu"], secs = reruns["sec6_drift"].get(RERUN_WAIT)
    say(f"[13 recal] sec6_drift on cpu: {secs:.1f} s")
    for name, _, derived in out[DEVICE]:
        say(f"  | {name}: {derived}")
    if out[DEVICE] != out["cpu"]:
        fail(f"[13 recal] sec6_drift rows differ from the cpu rerun's: "
             f"{out['cpu']}")
    say("[13 recal] sec6_drift: the stale-profile and re-profiled rows "
        "equal the cpu rerun's")
    say(f"[13 recal] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def snapshot_at(step: int, trace: list, into: dict):
    """A ``run_stream`` hook that keeps, in ``into``, the engine's
    ``FLEET_COUNTERS``, its ``rescue_pairs`` and the trace's length as they
    stand after ``step`` ticks (before that step's ingest): what a fleet
    serving only the first ``step`` ticks must equal."""
    import numpy as np

    def hook(eng, i):
        if i == step:
            into.update({f: getattr(eng, f) for f in FLEET_COUNTERS},
                        rescue_pairs=np.array(eng.rescue_pairs),
                        records=len(trace))
    return hook


def fleet_trace_equal(label, got, want):
    """A fleet's card trace against the single engine's, record by record
    with no parting forgiven: masks, indices, bands' cameras and frames,
    counters and epochs exact, scores within 1e-5.  Returns how many
    scores differ at all."""
    if len(got) != len(want):
        fail(f"[14 fleet] {label}: {len(got)} trace records, the single "
             f"engine {len(want)}")
    n_diff = 0
    for a, b in zip(got, want):
        if not same_record(a, b):
            fail(f"[14 fleet] {label}: trace record differs from the single "
                 f"engine's:\n  fleet  {a}\n  single {b}")
        n_diff += sum(x != y for x, y in zip(
            [a["match_val"]] + [v for v, _, _ in a["topk"]],
            [b["match_val"]] + [v for v, _, _ in b["topk"]]))
    return n_diff


def phase_fleet(np, torch, serve_stream, singles, recorder, kernels,
                max_err):
    """Phase 14 (see the module docstring).  ``serve_stream(model_key,
    trace, ticks, on_step, **serve_kw)`` serves the duke world of phase 4
    with its engine settings through ``api.serve(device="cuda",
    **serve_kw)`` and returns (engine, tick seconds); ``singles`` holds
    phase 4's and phase 6's card traces and engines (and phase 4's
    profile).  Returns each kernel's launches over the fleet runs."""
    from repro_torch.kernels import ops, reid_topk
    from repro_torch.runtime.transport import (FakeRpcTransport,
                                               FaultProfile, manual_clock)

    t_phase = time.perf_counter()
    camera, tiles = kernels
    launches = {"camera": 0, "tiles": 0}

    def run(label, entry, single, model_key, lose_at=None, **serve_kw):
        """One fleet run, its first ``FLEET_CUT_TICKS`` ticks, held to the
        single engine's card run over the same ticks (``single``: its
        trace, engine and, at ``FLEET_CUT_TICKS``, its counters and trace
        length, unless it ended before)."""
        rounds, kept = [], {}
        real, wrapped = recorder(entry, rounds, kept)
        setattr(ops, entry, wrapped)
        trace = []

        def on_step(eng, step):
            if step == lose_at:
                eng.lose_worker(1)

        reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
        try:
            eng, tick_s = serve_stream(model_key, trace, FLEET_CUT_TICKS,
                                       on_step, **serve_kw)
        finally:
            setattr(ops, entry, real)
            cam_n, tile_n = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
        n, other = (cam_n, tile_n) if entry == "reid_topk_segments" \
            else (tile_n, cam_n)
        nonempty = sum(1 for q, g in rounds if q > 0 and g > 0)
        if n == 0 or n != eng.worker_dispatches or n != nonempty or other:
            fail(f"[14 fleet] {label}: {entry} launches {n}, "
                 f"worker_dispatches {eng.worker_dispatches}, non-empty "
                 f"worker rounds {nonempty}, the other kernel {other}")
        launches["camera" if entry == "reid_topk_segments" else "tiles"] += n
        if not single["at"]:
            ref = single["eng"]
            ref = dict({f: getattr(ref, f) for f in FLEET_COUNTERS},
                       rescue_pairs=ref.rescue_pairs,
                       records=len(single["trace"]))
        else:
            ref = single["at"]
        n_diff = fleet_trace_equal(label, trace,
                                   single["trace"][:ref["records"]])
        counters = list(FLEET_COUNTERS[:5])
        if eng.tile_grid:
            counters += ["admitted_tiles", "unique_tiles"]
        for f in counters:
            if getattr(eng, f) != ref[f]:
                fail(f"[14 fleet] {label}: {f} {getattr(eng, f)}, the "
                     f"single engine {ref[f]}")
        if (eng.rescue_pairs != ref["rescue_pairs"]).any():
            fail(f"[14 fleet] {label}: rescue_pairs differ")
        rep = eng.shard_report()
        if sum(r["admitted_steps"] for r in rep) != eng.admitted_steps or \
                sum(r["owned_frames"] for r in rep) != eng.unique_frames:
            fail(f"[14 fleet] {label}: per-worker rows do not tile the "
                 f"totals: {rep}")
        for shape, (args, k) in kept.items():
            kern = camera if entry == "reid_topk_segments" else tiles
            err = check_against_plain(torch, kern, f"{label} {shape}", args,
                                      k, exact_idx=False)
            max_err[kern["name"]] = max(max_err[kern["name"]], err)
        lat = np.asarray(tick_s) * 1e3
        say(f"[14 fleet] {label}: {len(tick_s)} ticks, "
            f"{len(tick_s) / sum(tick_s):.1f} ticks/s, tick p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms; {entry} launches {n} (= "
            f"worker_dispatches, over {len(rounds)} worker rounds), the "
            f"other kernel 0; {len(trace)} trace records equal to the single "
            f"engine's, {n_diff} scores differ at all; "
            + " ".join(f"{f}={getattr(eng, f)}" for f in counters)
            + f"; {eng.n_shards} live workers, {eng.rebalances} "
            f"rebalances; {len(kept)} worker round shapes held to the plain "
            f"version")
        for r in rep:
            say(f"  {r['worker']} [{'live' if r['alive'] else 'lost'}]: "
                + " ".join(f"{k}={v}" for k, v in r.items()
                           if k not in ("worker", "alive")))
        return eng, rep

    # (a) the camera fleet: 4 workers, w1 lost at tick 1,000, its first
    # FLEET_CUT_TICKS ticks
    eng, rep = run("camera fleet", "reid_topk_segments", singles["camera"],
                   "camera", lose_at=FLEET_LOSE_AT, shards=FLEET_SHARDS,
                   gallery="sharded")
    lost = {r["worker"]: r for r in rep}["w1"]
    if eng.rebalances != 1 or lost["alive"] or lost["admitted_steps"] == 0:
        fail("[14 fleet] camera fleet: w1 was not lost after serving rounds")
    share = device_share(
        torch, lambda dev, trace, ticks: serve_stream(
            "camera", trace, ticks, None, shards=FLEET_SHARDS,
            gallery="sharded"),
        f"[14 fleet] camera fleet ({FLEET_SHARDS} workers)")
    p4 = singles["camera"]["share"]
    say(f"[14 fleet] camera fleet profile beside phase 4's: busy "
        f"{100 * share['busy']:.2f} % ({100 * p4['busy']:.2f} %), "
        f"{share['ops']:.1f} device operations a tick ({p4['ops']:.1f}), "
        f"{share['d2h']:.1f} device-to-host copies a tick "
        f"({p4['d2h']:.1f})")

    # (b) the tile fleet, its first FLEET_CUT_TICKS ticks
    eng, _ = run("tile fleet", "reid_topk_tiles", singles["tiles"], "tiles",
                 lose_at=FLEET_LOSE_AT, shards=FLEET_SHARDS,
                 gallery="sharded")
    if eng.rebalances != 1:
        fail("[14 fleet] tile fleet: no rebalance")

    # (c) the transport fleet: 8 workers, fake RPC, prefetch, w3 dead
    clock, sleep = manual_clock()
    transport = FakeRpcTransport(
        {"w3": FaultProfile(drop=1.0)},
        default=FaultProfile(latency=.002, jitter=.001), clock=clock,
        sleep=sleep)
    eng, rep = run("transport fleet", "reid_topk_segments",
                   singles["camera"], "camera", shards=TRANSPORT_SHARDS,
                   transport=transport, prefetch=True)
    c = eng.gallery.counters()
    if c["dead_peers"] != 1 or "w3" in eng._workers or \
            eng.rebalances != 1 or c["remote_fetches"] == 0 or \
            c["prefetch_hits"] == 0 or \
            sum(r["remote_fetches"] for r in rep) != c["remote_fetches"]:
        fail(f"[14 fleet] transport fleet: counters {c}, live workers "
             f"{eng._workers}")
    say(f"[14 fleet] transport fleet: {c['remote_fetches']} remote fetches "
        f"({c['prefetch_hits']} served by prefetch, {c['prefetch_wasted']} "
        f"wasted), {c['retries']} retries, {c['timeouts']} timeouts, "
        f"{c['dead_peers']} dead peer (w3, re-homed mid-round, "
        f"{c['rehomed_blocks']} blocks moved), {clock():.3f} s of virtual "
        f"fetch time")
    say(f"[14 fleet] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_suite(torch, recorder, kernels, max_err, reruns):
    """Phase 15 (see the module docstring): the serving sweeps and two
    tables on the card, called as functions, each against its CPU rerun
    (``reruns``: ``suite_rerun`` handles by entry), with every drive's
    kernel launches counted.  ``kernels`` are the camera and tile kernels'
    dicts and ``max_err`` their largest errors so far.  Returns the camera
    and tile kernels' launches by sweep."""
    from repro_torch.benchmarks import scenarios, tables
    from repro_torch.benchmarks.scenarios import (strip_clock_records,
                                                  strip_clock_row)
    from repro_torch.kernels import ops, ref, reid_topk

    t_phase = time.perf_counter()
    camera, tiles = kernels
    masked = dict(camera, call=ops.reid_topk_masked,
                  plain=ref.reid_topk_masked_ref)
    by_entry = {"reid_topk_segments": camera, "reid_topk_masked": masked,
                "reid_topk_tiles": tiles}
    rounds = {e: [] for e in by_entry}       # (Q, G) of each worker round
    kept = {e: {} for e in by_entry}         # first inputs of each shape
    drives = []                              # each drive of the running sweep
    real_serving, real_churn = scenarios._drive_serving, scenarios._drive_churn

    def counted(real, eng_at, lat_at):
        """A drive loop that also keeps its engine, tick latencies, kernel
        launches and non-empty (worker) rounds by entry."""
        def drive(*a, **kw):
            n0 = {e: len(r) for e, r in rounds.items()}
            c0, t0 = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
            out = real(*a, **kw)
            drives.append(dict(
                eng=out[eng_at], tick_s=out[lat_at],
                cam=reid_topk.LAUNCHES - c0, tile=reid_topk.TILE_LAUNCHES - t0,
                rounds={e: sum(1 for q, g in r[n0[e]:] if q > 0 and g > 0)
                        for e, r in rounds.items()},
                consolidate=kw.get("consolidate", True),
                tile_grid=kw.get("tile_grid", 0)))
            return out
        return drive

    reals = {}
    for e in by_entry:
        reals[e], wrapped = recorder(e, rounds[e], kept[e])
        setattr(ops, e, wrapped)
    scenarios._drive_serving = counted(real_serving, 0, 3)
    scenarios._drive_churn = counted(real_churn, 0, 2)
    launches = {"camera": {}, "tiles": {}}
    try:
        for name in SUITE_SWEEPS + SUITE_TABLES:
            sweep = name in SUITE_SWEEPS
            fn = getattr(scenarios if sweep else tables, name)
            drives.clear()
            scenarios.pop_bench_records(name)
            reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
            t0 = time.perf_counter()
            rows = fn(device=DEVICE)
            secs = time.perf_counter() - t0
            recs = scenarios.pop_bench_records(name)
            cam_n, tile_n = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
            for r in rows:
                say(f"  | {r[0]}: {r[2]}")
            for r in recs:
                say("  | record " + " ".join(f"{k}={v}" for k, v in r.items()
                                            if k != "scenario"))
            # every drive: launches = its non-empty (worker) rounds, a
            # fleet's also its worker_dispatches; one kernel a drive; the
            # unconsolidated engine through reid_topk_masked
            for i, d in enumerate(drives):
                eng, n = d["eng"], d["cam"] + d["tile"]
                fleet = hasattr(eng, "worker_dispatches")
                ranked = sum(d["rounds"].values())
                if n == 0 or n != ranked or \
                        (fleet and n != eng.worker_dispatches) or \
                        (d["tile"] if not d["tile_grid"] else d["cam"]):
                    fail(f"[15 suite] {name} drive {i}: camera launches "
                         f"{d['cam']}, tile launches {d['tile']}, non-empty "
                         f"rounds {d['rounds']}"
                         + (f", worker_dispatches {eng.worker_dispatches}"
                            if fleet else ""))
                masked_n = d["rounds"]["reid_topk_masked"]
                if (masked_n != d["cam"]) if not d["consolidate"] \
                        else masked_n:
                    fail(f"[15 suite] {name} drive {i}: consolidate="
                         f"{d['consolidate']} but {masked_n} frame-masked "
                         f"rounds of {d['cam']} camera launches")
            if cam_n != sum(d["cam"] for d in drives) or \
                    tile_n != sum(d["tile"] for d in drives) or \
                    (not sweep and (cam_n or tile_n)):
                fail(f"[15 suite] {name}: launches {cam_n} + {tile_n} "
                     f"outside the counted drives")
            if sweep:
                launches["camera"][name] = cam_n
                if tile_n:
                    launches["tiles"][name] = tile_n
            line = ""
            if drives:
                big = max(drives, key=lambda d: (len(d["tick_s"]),
                                                 len(d["eng"].queries)))
                fleets = [d["eng"].worker_dispatches for d in drives
                          if hasattr(d["eng"], "worker_dispatches")]
                masked_n = sum(d["rounds"]["reid_topk_masked"]
                               for d in drives)
                line += (f"{len(drives)} drives, reid_topk launches "
                         f"{cam_n}, reid_topk_tiles launches {tile_n} (= "
                         f"non-empty rounds"
                         + (f", of them {sum(fleets)} the fleets' "
                            f"worker_dispatches" if fleets else "")
                         + (f", {masked_n} frame-masked" if masked_n else "")
                         + f"); largest run {len(big['tick_s'])} ticks x "
                         f"{len(big['eng'].queries)} queries at "
                         f"{len(big['tick_s']) / sum(big['tick_s']):.1f} "
                         f"ticks/s")
            else:
                line += "the re-id kernels launched 0 times"
            (cpu_rows, cpu_recs), cpu_secs = reruns[name].get(RERUN_WAIT)
            if [strip_clock_row(r) for r in rows] != \
                    [strip_clock_row(r) for r in cpu_rows]:
                fail(f"[15 suite] {name}: rows differ from the cpu "
                     f"rerun's:\n" + "\n".join(map(str, cpu_rows)))
            if strip_clock_records(recs) != strip_clock_records(cpu_recs):
                fail(f"[15 suite] {name}: records differ from the cpu "
                     f"rerun's:\n" + "\n".join(map(str, cpu_recs)))
            line = (f"[15 suite] {name} on {DEVICE}: {secs:.1f} s "
                    f"(cpu rerun {cpu_secs:.1f} s); {len(rows)} rows and "
                    f"{len(recs)} records equal to the cpu rerun's; "
                    + line)
            say(line)
            if name == "query_churn_sweep" and not any(
                    not d["consolidate"] and d["rounds"]["reid_topk_masked"]
                    for d in drives):
                fail("[15 suite] query_churn_sweep: the unconsolidated "
                     "runs never launched reid_topk_masked")
    finally:
        for e, real in reals.items():
            setattr(ops, e, real)
        scenarios._drive_serving, scenarios._drive_churn = \
            real_serving, real_churn
    n_shapes = 0
    for e, kern in by_entry.items():
        for shape, (args, k) in kept[e].items():
            err = check_against_plain(torch, kern, f"[15 suite] {e} "
                                      f"{shape}", args, k, exact_idx=False)
            max_err[kern["name"]] = max(max_err[kern["name"]], err)
            n_shapes += 1
    say(f"[15 suite] {n_shapes} round shapes held to the plain version "
        f"({', '.join(f'{len(kept[e])} {e}' for e in by_entry)})")
    say(f"[15 suite] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


#: (label, share of bfloat16 outputs equal to the plain version's) of
#: every bfloat16 hold
BF16_SHARES: list[tuple[str, float]] = []


def close_enough(torch, name, got, want, tol):
    """Fail unless ``got`` (the kernel) equals ``want`` (the plain version)
    in shape and dtype and within rtol = atol = ``tol``, compared in
    float32, and, in bfloat16, on at least ``BF16_SHARE`` of the elements
    bit for bit; returns the max absolute error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel returned {tuple(got.shape)} {got.dtype}, "
             f"plain {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        fail(f"{name}: differs from the plain version (max abs {err:.3g}, "
             f"tolerance {tol})")
    if got.dtype == torch.bfloat16 and got.numel():
        share = float((got == want).float().mean())
        BF16_SHARES.append((name, share))
        if share < BF16_SHARE:
            fail(f"{name}: {share:.4f} of the bfloat16 outputs equal the "
                 f"plain version's, below {BF16_SHARE}")
    return err


def min_share(prefix: str) -> str:
    """The least bit-equal share of the bfloat16 holds whose label starts
    with ``prefix``, and its count."""
    shares = [v for k, v in BF16_SHARES if k.startswith(prefix)]
    return f"{min(shares):.4f} (least of {len(shares)})" if shares else "none"


def library_yardstick(torch, name, args, kwargs):
    """One PyTorch call computing ``ops.<name>`` on the same inputs (in
    their dtype), as a zero-argument callable, or None where there is none
    (the scan)."""
    F = torch.nn.functional
    if name == "reid_topk":
        q, g, k = args
        return lambda: torch.topk(torch.matmul(q, g.T), k, dim=1)
    if name == "flash_attention":
        q, k, v = args
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs["causal"], enable_gqa=True)
    if name == "decode_attention":
        q, k, v, length = args
        B, H, hd = q.shape
        KV = k.shape[1]
        mask = (torch.arange(k.shape[2], device=q.device)[None]
                < length[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q.view(B, KV, H // KV, hd), k, v, attn_mask=mask)
    return None


def decode_gqa_yardstick(torch, args):
    """The expanding decode yardstick: q as (B, H, 1, hd) against K and
    V with ``enable_gqa``, which expands them to all H heads."""
    q, k, v, length = args
    mask = (torch.arange(k.shape[2], device=q.device)[None]
            < length[:, None])[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


def decode_parts(torch, decode_attention, args, n_sms):
    """The plan of one decode call and the device times of its partial
    pass alone and with the combine (``decode_attention.launch``, which
    counts nothing); the combine's time is their difference."""
    from repro_torch.benchmarks.kernels_bench import device_ms

    q, k, v, length = args
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    plan = decode_attention.decode_plan(B, H, KV, T, hd, q.dtype, n_sms)
    out = torch.empty_like(q)
    length = length.to(torch.int32)
    partial = device_ms(lambda: decode_attention.launch(
        q, k, v, length, out, plan, passes=1))
    full = device_ms(lambda: decode_attention.launch(q, k, v, length, out,
                                                     plan))
    return dict(plan=str(plan), splits=plan.splits, partial_ms=partial,
                full_ms=full, combine_ms=full - partial)


def parts_text(t) -> str:
    """The partial and combine times of ``decode_parts`` as printed."""
    if t["splits"] == 1:
        return (f"one split, no partials: {t['full_ms']:.4f} ms in one "
                f"pass")
    return (f"partials {t['partial_ms']:.4f} ms, with the combine "
            f"{t['full_ms']:.4f} ms (combine {t['combine_ms']:.4f} ms)")


def hold_output(torch, name, label, args, kwargs, out, tol):
    """Hold a benchmark kernel's output ``out`` on ``args`` to its plain
    version: the re-id top-k as in phase 3, the others within rtol = atol
    = ``tol``; returns the max absolute error."""
    from repro_torch.benchmarks.kernels_bench import plain

    if name == "reid_topk":
        kern = dict(call=None, plain=plain(name))
        return check_against_plain(torch, kern, label, args[:2], args[2],
                                   exact_idx=False, got=out)
    return close_enough(torch, label, out, plain(name)(*args, **kwargs), tol)


def profile_passes(torch, label, fn, n, kernels, what):
    """Run ``fn`` (``n`` passes) under ``torch.profiler``, device activity
    only, and print the device's busy time against the host clock, the
    share of it in the kernels whose names hold one of ``kernels`` (the
    ``what`` kernels), the device operations and the four longest; returns
    them a pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    mine = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in kernels)) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    say(f"{label} profiled: device busy {busy / n:.3f} ms of "
        f"{wall / n:.3f} ms host clock a pass ({100 * busy / wall:.1f} "
        f"% busy), the {what} kernels {mine / n:.3f} ms of it; "
        f"{sum(e.count for e in events) / n:.0f} device operations a "
        f"pass; most device time: " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3 / n:.3f} ms "
            f"x{e.count / n:g}" for e in top))
    return {"busy_share": busy / wall, "device_ms": busy / n,
            f"{what}_ms": mine / n, "ops": sum(e.count for e in events) / n}


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) copied to
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def hold_to_cpu(torch, tag, card, host):
    """Fail unless each tensor of the card run ``card`` equals the CPU
    rerun's of the same name in ``host`` in shape and within rtol = atol
    = ``ZOO_TOL``; returns the max absolute differences by name."""
    diffs = {}
    for name, want in host.items():
        g = card[name].cpu()
        if g.shape != want.shape:
            fail(f"{tag} {name}: card {tuple(g.shape)}, CPU rerun "
                 f"{tuple(want.shape)}")
        diffs[name] = float((g - want).abs().max())
        if not torch.allclose(g, want, rtol=ZOO_TOL, atol=ZOO_TOL):
            fail(f"{tag} {name}: card differs from the CPU rerun (max abs "
                 f"{diffs[name]:.3g}, tolerance {ZOO_TOL})")
    return diffs


def decode_against_forward(torch, tag, card, S, steps):
    """Fail unless the card's prefill and decode logits (``steps``)
    equal its forward logits at the same positions within ``ZOO_TOL``;
    returns the max absolute difference."""
    along = card["forward"][:, S - 1:S + steps]
    own = float((card["steps"] - along).abs().max())
    if not torch.allclose(card["steps"], along, rtol=ZOO_TOL, atol=ZOO_TOL):
        fail(f"{tag}: card decode differs from card forward (max abs "
             f"{own:.3g}, tolerance {ZOO_TOL})")
    return own


def serve_greedy(torch, models, params, cfg, prompt, steps, timed,
                 **prefill_kw):
    """Prefill ``prompt`` on the card, then ``steps`` greedy decode steps;
    with ``timed`` each is synchronised before its clock reading.  Returns
    (prefill seconds, per-step ms, logits (B, 1 + steps, V), the last
    logits and state)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, st = models.prefill(params, {"tokens": prompt}, cfg, device=DEVICE,
                            **prefill_kw)
    if timed:
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, step_ms = [lg], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lg, st = models.decode_step(params, st, lg.argmax(-1), cfg,
                                    device=DEVICE)
        if timed:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(lg)
    return prefill_s, step_ms, torch.stack(out, 1), lg, st


def attention_holds(torch, tag, run, flash_at, decode_at, steps):
    """Run ``run()`` with ``models.attention``'s two kernel calls hooked:
    the flash calls numbered in ``flash_at`` and the decode calls in
    ``decode_at`` ({call: "first layer", ...}) are held to
    ``ref.flash_attention_ref`` and ``ref.decode_attention_ref`` on the
    card as phase 10 holds bfloat16.  Returns (the holds, [(label, max abs
    err, bit-equal share)], and the first held call's inputs of each
    kernel, {name: (args, kwargs)})."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    holds, kept, calls = [], {}, {"flash": 0, "decode": 0}
    base_flash = attention.blockwise_attention
    base_decode = attention.decode_attention

    def flash_hook(q, k, v, cfg_, *, causal=True):
        out = base_flash(q, k, v, cfg_, causal=causal)
        n, calls["flash"] = calls["flash"], calls["flash"] + 1
        if n in flash_at:
            label = f"{tag} flash_attention, prefill, {flash_at[n]}"
            holds.append((label, close_enough(
                torch, label, out, ref.flash_attention_ref(
                    q, k, v, causal=causal), ATTN_TOL["bfloat16"]),
                BF16_SHARES[-1][1]))
            kept.setdefault("flash_attention", ((q, k, v),
                                                dict(causal=causal)))
        return out

    def decode_hook(q, k_cache, v_cache, length, cfg_):
        out = base_decode(q, k_cache, v_cache, length, cfg_)
        n, calls["decode"] = calls["decode"], calls["decode"] + 1
        if n in decode_at:
            label = (f"{tag} decode_attention, decode step {steps}, "
                     f"{decode_at[n]}")
            holds.append((label, close_enough(
                torch, label, out, ref.decode_attention_ref(
                    q, k_cache, v_cache, length), ATTN_TOL["bfloat16"]),
                BF16_SHARES[-1][1]))
            kept.setdefault("decode_attention", (
                (q, k_cache.clone(), v_cache.clone(), length), {}))
        return out

    attention.blockwise_attention = flash_hook
    attention.decode_attention = decode_hook
    try:
        run()
    finally:
        attention.blockwise_attention = base_flash
        attention.decode_attention = base_decode
    want = len(flash_at) + len(decode_at)
    if len(holds) != want:
        fail(f"{tag}: {len(holds)} attention holds, want {want}")
    return holds, kept


def attention_zoo(torch, tag, model_name, kept, holds, launches, errs):
    """The flash and decode kernels timed at a model's shapes, the held
    calls' inputs ``kept``, beside their plain versions, bounds and
    library calls: each kernel's ``zoo`` entry of the kernels line, with
    ``launches`` ({name: count}) and the holds' largest error, which
    ``errs`` also takes."""
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks.kernels_bench import device_ms
    from repro_torch.kernels import decode_attention, flash_attention

    zoo = {}
    for name, (args, kwargs) in kept.items():
        op = getattr(flash_attention if name == "flash_attention"
                     else decode_attention, name)
        base = kernels_bench.plain(name)
        b_ms, b_by = kernels_bench.bound_ms(
            *kernels_bench.cost(name, args, kwargs),
            kernels_bench.peak_flops(name, args))
        lib = library_yardstick(torch, name, args, kwargs)
        err = max(e for label, e, _ in holds if name in label)
        errs[name] = max(errs[name], err)
        zoo[name] = dict(
            launches=launches[name],
            shape=dict(B=args[0].shape[0], H=args[0].shape[1],
                       KV=args[1].shape[1], T=args[1].shape[2],
                       hd=args[0].shape[-1], dtype="bfloat16",
                       **({"S": args[0].shape[2], "causal": True}
                          if name == "flash_attention" else
                          {"length": int(args[3].max())})),
            ms=device_ms(lambda: op(*args, **kwargs)),
            plain_ms=device_ms(lambda: base(*args, **kwargs), calls=1,
                               replays=3),
            library_ms=device_ms(lib), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err)
        plan = flash_attention.flash_plan(args[0].shape[-1], args[0].dtype) \
            if name == "flash_attention" else decode_attention.decode_plan(
                *args[0].shape[:2], *args[1].shape[1:3], args[0].shape[-1],
                args[0].dtype, torch.cuda.get_device_properties(
                    0).multi_processor_count)
        zoo[name]["shape"]["plan"] = str(plan)
        t = zoo[name]
        say(f"{tag} {name} at {model_name}'s {t['shape']}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return zoo


def phase_zoo(torch, np, errs):
    """Phase 16, the dense zoo's serving path (see the module docstring).
    ``errs`` takes the attention holds' errors; returns the flash and
    decode kernels' ``zoo`` entries for the kernels line."""
    import dataclasses

    from repro_torch import models
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention

    t_phase = time.perf_counter()
    full = get_config(ZOO_ARCH)
    rng = np.random.default_rng(16)

    def reset():
        flash_attention.LAUNCHES = decode_attention.LAUNCHES = 0

    def launches():
        return flash_attention.LAUNCHES, decode_attention.LAUNCHES

    # (a) two layers at full width in float32, the card against the CPU
    a = ZOO_CHECK
    cfg = dataclasses.replace(full, num_layers=a["layers"], dtype="float32")
    S, steps = a["S"], a["steps"]
    tokens = rng.integers(0, cfg.vocab_size, (a["B"], S + steps))

    def check_run(params, device):
        toks = torch.as_tensor(tokens, device=device)
        whole = models.forward(params, {"tokens": toks}, cfg,
                               device=device)[0]
        lg, st = models.prefill(params, {"tokens": toks[:, :S]}, cfg,
                                max_len=S + steps, device=device)
        out = [lg]
        for i in range(steps):
            lg, st = models.decode_step(params, st, toks[:, S + i], cfg,
                                        device=device)
            out.append(lg)
        return dict(forward=whole, steps=torch.stack(out, 1),
                    k=st["kv"]["k"], v=st["kv"]["v"])

    params = models.init_params(cfg, seed=16, device=DEVICE)
    reset()
    card = check_run(params, DEVICE)
    got = launches()
    if got != (a["layers"] * 2, a["layers"] * steps):
        fail(f"[16 zoo] (a): launches flash {got[0]}, decode {got[1]}; "
             f"want {a['layers'] * 2} (layers x 2 passes) and "
             f"{a['layers'] * steps} (layers x steps)")
    t0 = time.perf_counter()
    host = check_run(tree_to(params, "cpu"), "cpu")
    host_s = time.perf_counter() - t0
    diffs = hold_to_cpu(torch, "[16 zoo] (a)", card, host)
    own = decode_against_forward(torch, "[16 zoo] (a)", card, S, steps)
    say(f"[16 zoo] (a) {full.name} at full width, {a['layers']} layers, "
        f"float32, B {a['B']}: forward over {S + steps} tokens, prefill of "
        f"{S}, {steps} decode steps; card against the CPU rerun (max abs "
        f"err: forward {diffs['forward']:.3g}, prefill and decode logits "
        f"{diffs['steps']:.3g}, caches {max(diffs['k'], diffs['v']):.3g}; "
        f"tolerance {ZOO_TOL}); card decode against card forward "
        f"{own:.3g}; launches flash {got[0]}, decode {got[1]}; CPU rerun "
        f"{host_s:.1f} s")
    del params, card, host
    torch.cuda.empty_cache()

    # (b) all 32 layers in bfloat16: prefill, then greedy decode
    b = ZOO_SERVE
    cfg, L = full, full.num_layers
    S, steps = b["S"], b["steps"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=17, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    item = leaves[0].element_size()
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b["B"], S)),
                             device=DEVICE)

    def serve(timed: bool):
        return serve_greedy(torch, models, params, cfg, prompt, steps, timed,
                            max_len=b["max_len"])

    # the warm-up run holds the first and last layer's attention, at the
    # prefill and at the last decode step, to the plain versions
    holds, kept = attention_holds(
        torch, "[16 zoo]", lambda: serve(timed=False),
        {0: "first layer", L - 1: "last layer"},
        {(steps - 1) * L: "first layer", steps * L - 1: "last layer"}, steps)

    reset()
    prefill_s, step_ms, logits, lg, st = serve(timed=True)
    got = launches()
    if got != (L, L * steps):
        fail(f"[16 zoo] (b): launches flash {got[0]}, decode {got[1]}; "
             f"want {L} (layers x 1 pass) and {L * steps} (layers x "
             f"steps)")
    if not bool(torch.isfinite(logits).all()):
        fail("[16 zoo] (b): a logit is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # yardsticks: prefill's operations (the layers' matmuls, causal
    # attention, the last position's unembedding) at the bfloat16 peak;
    # a decode step's bytes (every weight but the embedding table once, B
    # embedding rows, the live cache at the last step) over HBM's rate
    tok = params["embed"]["tok"]
    layer_elems = sum(t.numel() for t in tree_leaves(params["layers"]))
    pairs = S * (S + 1) / 2
    prefill_flops = (2.0 * layer_elems * b["B"] * S
                     + 4.0 * L * b["B"] * cfg.num_heads * pairs
                     * cfg.head_dim
                     + 2.0 * cfg.d_model * cfg.vocab_size * b["B"])
    prefill_bound = prefill_flops / kernels_bench.BF16_FLOPS * 1e3
    cache_live = (2.0 * L * b["B"] * cfg.num_kv_heads * (S + steps)
                  * cfg.head_dim * item)
    step_bytes = (weight_bytes - tok.numel() * item
                  + b["B"] * cfg.d_model * item + cache_live)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    ms = sorted(step_ms)
    zoo_line = dict(
        config=f"{cfg.name} {L} layers bfloat16 B {b['B']} prefill "
               f"{S} max_len {b['max_len']} steps {steps}",
        weights_gb=weight_bytes / 1e9, init_s=init_s, prefill_s=prefill_s,
        prefill_tokens_per_s=b["B"] * S / prefill_s,
        prefill_bound_ms=prefill_bound,
        decode_ms_mean=sum(step_ms) / steps, decode_ms_p50=ms[steps // 2],
        decode_ms_min=ms[0], decode_ms_max=ms[-1],
        decode_bound_ms=step_bound, peak_gb=peak_gb)
    say(f"[16 zoo] (b) {cfg.name}, {L} layers, bfloat16, weights "
        f"{weight_bytes / 1e9:.2f} GB made in {init_s:.1f} s; prefill B "
        f"{b['B']} x S {S} into max_len {b['max_len']}: "
        f"{prefill_s * 1e3:.1f} ms, {b['B'] * S / prefill_s:.0f} tokens/s "
        f"(operations bound {prefill_bound:.1f} ms: "
        f"{prefill_flops / 1e12:.2f} TFLOP at 989 TFLOP/s); {steps} greedy "
        f"decode steps: mean {zoo_line['decode_ms_mean']:.3f} ms/step, p50 "
        f"{ms[steps // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f} (byte "
        f"bound {step_bound:.3f} ms: {step_bytes / 1e9:.2f} GB, the live "
        f"cache {cache_live / 1e9:.3f} GB of it, over 3.35 TB/s); "
        f"launches flash {got[0]} (= {L} layers x 1 pass), decode {got[1]} "
        f"(= {L} layers x {steps} steps); every logit finite; peak memory "
        f"{peak_gb:.2f} GB")
    for label, err, share in holds:
        say(f"{label}: agrees with the plain version (max abs err "
            f"{err:.3g}, bfloat16 bit-equal {share:.4f})")

    # where the time goes: a prefill and ZOO_PROFILED further decode steps
    # under torch.profiler (device activity only), after the counted run
    def profiled(label, fn, n):
        return profile_passes(torch, f"[16 zoo] {label}", fn, n,
                              ("flash", "decode_"), "attention")

    state = {"lg": lg, "st": st}

    def more_steps():
        for _ in range(ZOO_PROFILED):
            state["lg"], state["st"] = models.decode_step(
                params, state["st"], state["lg"].argmax(-1), cfg,
                device=DEVICE)

    prefill_profile = profiled("prefill", lambda: models.prefill(
        params, {"tokens": prompt}, cfg, max_len=b["max_len"],
        device=DEVICE), 1)
    decode_profile = profiled(f"{ZOO_PROFILED} decode steps", more_steps,
                              ZOO_PROFILED)
    del state, lg, st
    zoo_line.update(prefill_profile=prefill_profile,
                    decode_profile=decode_profile)

    # the two kernels at the model's shapes, the warm-up run's inputs
    zoo = attention_zoo(torch, "[16 zoo]", cfg.name, kept, holds,
                        {"flash_attention": got[0],
                         "decode_attention": got[1]}, errs)
    zoo["flash_attention"]["serving"] = zoo_line
    say(f"[16 zoo] phase {time.perf_counter() - t_phase:.1f} s")
    return zoo


def phase_ssm_zoo(torch, np, errs):
    """Phase 17, the Mamba1 zoo's serving path (see the module docstring).
    ``errs`` takes the scan holds' errors; returns the scan's ``zoo``
    entry for the kernels line."""
    import dataclasses

    from repro_torch import models
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks.kernels_bench import device_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan, ref

    t_phase = time.perf_counter()
    gc.collect()                    # phase 16's weights go first
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    full = get_config(SSM_ARCH)
    rng = np.random.default_rng(17)

    # (a) two layers at full width in float32, the card against the CPU
    a = SSM_CHECK
    cfg = dataclasses.replace(full, num_layers=a["layers"], dtype="float32")
    S, steps = a["S"], a["steps"]
    tokens = rng.integers(0, cfg.vocab_size, (a["B"], S + steps))

    def check_run(params, device):
        """Forward, prefill and decode steps; with each pass's scan
        launches on the card."""
        toks = torch.as_tensor(tokens, device=device)
        counts = []
        mamba_scan.LAUNCHES = 0
        whole = models.forward(params, {"tokens": toks}, cfg,
                               device=device)[0]
        counts.append(mamba_scan.LAUNCHES)
        lg, st = models.prefill(params, {"tokens": toks[:, :S]}, cfg,
                                device=device)
        counts.append(mamba_scan.LAUNCHES - sum(counts))
        out = dict(forward=whole, prefill_h=st["ssm"]["h"].clone(),
                   prefill_conv=st["ssm"]["conv"].clone())
        logits = [lg]
        for i in range(steps):
            lg, st = models.decode_step(params, st, toks[:, S + i], cfg,
                                        device=device)
            logits.append(lg)
        counts.append(mamba_scan.LAUNCHES - sum(counts))
        out.update(steps=torch.stack(logits, 1), h=st["ssm"]["h"],
                   conv=st["ssm"]["conv"])
        return out, counts

    params = models.init_params(cfg, seed=18, device=DEVICE)
    card, got = check_run(params, DEVICE)
    want = [a["layers"], a["layers"], 0]
    if got != want:
        fail(f"[17 ssm] (a): scan launches forward {got[0]}, prefill "
             f"{got[1]}, decode {got[2]}; want {want} (a launch a layer a "
             f"pass, none a step)")
    t0 = time.perf_counter()
    host, _ = check_run(tree_to(params, "cpu"), "cpu")
    host_s = time.perf_counter() - t0
    diffs = hold_to_cpu(torch, "[17 ssm] (a)", card, host)
    own = decode_against_forward(torch, "[17 ssm] (a)", card, S, steps)
    say(f"[17 ssm] (a) {full.name} at full width, {a['layers']} layers, "
        f"float32, B {a['B']}: forward over {S + steps} tokens, prefill of "
        f"{S}, {steps} decode steps; card against the CPU rerun (max abs "
        f"err: forward {diffs['forward']:.3g}, prefill and decode logits "
        f"{diffs['steps']:.3g}, prefill h {diffs['prefill_h']:.3g} and "
        f"conv {diffs['prefill_conv']:.3g}, final h {diffs['h']:.3g} and "
        f"conv {diffs['conv']:.3g}; tolerance {ZOO_TOL}); card decode "
        f"against card forward {own:.3g}; scan launches forward {got[0]}, "
        f"prefill {got[1]}, decode {got[2]}; CPU rerun {host_s:.1f} s")
    del params, card, host
    torch.cuda.empty_cache()

    # (b) all 64 layers in bfloat16: prefill, then greedy decode
    b = SSM_SERVE
    cfg, L = full, full.num_layers
    S, steps = b["S"], b["steps"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=19, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b["B"], S)),
                             device=DEVICE)

    def serve(timed: bool):
        return serve_greedy(torch, models, params, cfg, prompt, steps, timed)

    # the warm-up run holds the first and last layer's scan, y and h_L at
    # the prefill, to the plain version on the card
    holds, kept, calls = [], {}, [0]
    base_scan = mamba_scan.mamba_scan

    def scan_hook(*args, final_state=False):
        out = base_scan(*args, final_state=final_state)
        n, calls[0] = calls[0], calls[0] + 1
        if n in (0, L - 1):
            label = (f"[17 ssm] mamba_scan, prefill, "
                     f"{'first' if n == 0 else 'last'} layer")
            u = args[0]
            want_y, want_h = ref.mamba_scan_ref(*args, torch.zeros(
                (u.shape[0], u.shape[2], args[2].shape[2]), device=DEVICE))
            holds.append((label,
                          close_enough(torch, label, out[0], want_y,
                                       SCAN_TOL),
                          close_enough(torch, f"{label} h_L", out[1],
                                       want_h, SCAN_TOL)))
            kept.setdefault("args", args)
        return out

    mamba_scan.mamba_scan = scan_hook
    try:
        serve(timed=False)
    finally:
        mamba_scan.mamba_scan = base_scan
    if len(holds) != 2 or calls[0] != L:
        fail(f"[17 ssm] (b): {len(holds)} scan holds over {calls[0]} scan "
             f"calls, want 2 over {L}")

    mamba_scan.LAUNCHES = 0
    prefill_s, step_ms, logits, lg, st = serve(timed=True)
    launched = mamba_scan.LAUNCHES
    if launched != L:
        fail(f"[17 ssm] (b): scan launches {launched}, want {L} (layers x "
             f"1 prefill, none in {steps} decode steps)")
    if not bool(torch.isfinite(logits).all()):
        fail("[17 ssm] (b): a logit is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # yardsticks: prefill's operations (the four projections' matmuls at
    # the bfloat16 peak, the scan's at the fp32 CUDA cores', the last
    # position's unembedding); a decode step's bytes (every weight, the
    # tied embedding table read whole by the unembedding, and each layer's
    # h and conv read and written) over HBM's rate
    di, N, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    proj_elems = sum(lp["mamba"][n].numel() for lp in params["layers"]
                     for n in ("in_proj", "x_proj", "dt_proj", "out_proj"))
    mm_flops = (2.0 * proj_elems * b["B"] * S
                + 2.0 * cfg.d_model * cfg.vocab_size * b["B"])
    scan_flops = L * b["B"] * S * di * (7.0 * N + 1)
    prefill_bound = (mm_flops / kernels_bench.BF16_FLOPS
                     + scan_flops / kernels_bench.FP32_FLOPS) * 1e3
    state_bytes = sum(t.numel() * t.element_size()
                      for t in st["ssm"].values())
    step_bytes = (weight_bytes + b["B"] * cfg.d_model * 2
                  + 2.0 * state_bytes)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    ms = sorted(step_ms)
    ssm_line = dict(
        config=f"{cfg.name} {L} layers bfloat16 B {b['B']} prefill {S} "
               f"steps {steps}",
        weights_gb=weight_bytes / 1e9, init_s=init_s, prefill_s=prefill_s,
        prefill_tokens_per_s=b["B"] * S / prefill_s,
        prefill_bound_ms=prefill_bound,
        decode_ms_mean=sum(step_ms) / steps, decode_ms_p50=ms[steps // 2],
        decode_ms_min=ms[0], decode_ms_max=ms[-1],
        decode_bound_ms=step_bound, state_gb=state_bytes / 1e9,
        peak_gb=peak_gb)
    say(f"[17 ssm] (b) {cfg.name}, {L} layers, bfloat16, weights "
        f"{weight_bytes / 1e9:.2f} GB made in {init_s:.1f} s ({held_gb:.2f} "
        f"GB held before); prefill B {b['B']} x S {S}: "
        f"{prefill_s * 1e3:.1f} ms, {b['B'] * S / prefill_s:.0f} tokens/s "
        f"(operations bound {prefill_bound:.1f} ms: {mm_flops / 1e12:.2f} "
        f"TFLOP of matmuls at 989 TFLOP/s and {scan_flops / 1e12:.3f} of "
        f"the scan at 67); {steps} greedy decode steps: mean "
        f"{ssm_line['decode_ms_mean']:.3f} ms/step, p50 {ms[steps // 2]:.3f}"
        f", min {ms[0]:.3f}, max {ms[-1]:.3f} (byte bound "
        f"{step_bound:.3f} ms: {step_bytes / 1e9:.2f} GB, the state "
        f"{state_bytes / 1e9:.3f} GB read and written, over 3.35 TB/s); "
        f"scan launches {launched} (= {L} layers x 1 prefill, 0 a step); "
        f"every logit finite; peak memory {peak_gb:.2f} GB")
    for label, err_y, err_h in holds:
        say(f"{label}: y and h_L agree with the plain version (max abs err "
            f"{err_y:.3g} and {err_h:.3g})")

    state = {"lg": lg, "st": st}

    def more_steps():
        for _ in range(SSM_PROFILED):
            state["lg"], state["st"] = models.decode_step(
                params, state["st"], state["lg"].argmax(-1), cfg,
                device=DEVICE)

    prefill_profile = profile_passes(
        torch, "[17 ssm] prefill", lambda: models.prefill(
            params, {"tokens": prompt}, cfg, device=DEVICE), 1,
        ("scan_kernel",), "scan")
    decode_profile = profile_passes(
        torch, f"[17 ssm] {SSM_PROFILED} decode steps", more_steps,
        SSM_PROFILED, ("scan_kernel",), "scan")
    del state, lg, st, logits
    ssm_line.update(prefill_profile=prefill_profile,
                    decode_profile=decode_profile)

    # the scan at the model's shape, the warm-up run's first layer
    args = kept["args"]
    u = args[0]
    B_, L_, D_ = u.shape
    N_ = args[2].shape[2]
    plan = mamba_scan.scan_plan(
        B_, L_, D_, N_, torch.cuda.get_device_properties(
            0).multi_processor_count)
    h0 = torch.zeros((B_, D_, N_), device=DEVICE)
    b_ms, b_by = kernels_bench.bound_ms(*kernels_bench.cost(
        "mamba_scan", args, {"final_state": True}))
    err_y = max(e for _, e, _ in holds)
    err_h = max(e for _, _, e in holds)
    errs["mamba_scan"] = max(errs["mamba_scan"], err_y, err_h)
    zoo = dict(
        launches=launched,
        shape=dict(B=B_, L=L_, D=D_, N=N_, final_state=True, plan=str(plan)),
        ms=device_ms(lambda: mamba_scan.mamba_scan(*args, final_state=True)),
        ms_without_state=device_ms(lambda: mamba_scan.mamba_scan(*args)),
        plain_ms=device_ms(lambda: ref.mamba_scan_ref(*args, h0), calls=1,
                           replays=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(err_y, err_h), max_abs_err_y=err_y,
        max_abs_err_h=err_h, serving=ssm_line)
    say(f"[17 ssm] mamba_scan at {cfg.name}'s {zoo['shape']}: kernel "
        f"{zoo['ms']:.4f} ms ({zoo['ms_without_state']:.4f} without the end "
        f"state), plain {zoo['plain_ms']:.4f} ms, library none, bound "
        f"{b_ms:.6f} ms ({b_by})")
    del params, kept, args
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[17 ssm] phase {time.perf_counter() - t_phase:.1f} s")
    return zoo


def ssd_operations(cfg, B: int, L: int) -> float:
    """The SSD's matmul operations over L steps of B rows, one layer: the
    four products a chunk of ``ssm.ssd_chunked`` (C.B, the intra-chunk
    weights over x dt, C.h and the carry)."""
    nh, hd, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    chunk = min(cfg.ssm_chunk, L)
    ops = 0.0
    for s in range(0, L, chunk):
        c = min(chunk, L - s)
        ops += 2.0 * B * c * c * (N + nh * hd) + 4.0 * B * nh * c * hd * N
    return ops


def phase_hybrid_zoo(torch, np, errs):
    """Phase 18, the hybrid zoo's serving path (see the module docstring).
    ``errs`` takes the attention holds' errors; returns the flash and
    decode kernels' ``zoo_hybrid`` entries for the kernels line."""
    import dataclasses

    from repro_torch import models
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import mamba_scan
    from repro_torch.models import ssm

    t_phase = time.perf_counter()
    gc.collect()                    # phase 17's weights go first
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    full = get_config(HYBRID_ARCH)
    rng = np.random.default_rng(20)
    counters = (flash_attention, decode_attention, mamba_scan)

    def reset():
        for mod in counters:
            mod.LAUNCHES = 0

    def launches():
        return tuple(mod.LAUNCHES for mod in counters)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    # (a) two super-blocks at full width in float32, the card against the
    # CPU: the shared block's weights over two caches
    a = HYBRID_CHECK
    cfg = dataclasses.replace(full, num_layers=a["layers"], dtype="float32")
    n_super = cfg.num_layers // cfg.attn_every
    S, steps = a["S"], a["steps"]
    tokens = rng.integers(0, cfg.vocab_size, (a["B"], S + steps))

    def check_run(params, device):
        """Forward, prefill and decode steps; with each pass's launches
        (flash, decode, scan) on the card."""
        toks = torch.as_tensor(tokens, device=device)
        counts = []
        reset()
        whole = models.forward(params, {"tokens": toks}, cfg,
                               device=device)[0]
        counts.append(launches())
        reset()
        lg, st = models.prefill(params, {"tokens": toks[:, :S]}, cfg,
                                max_len=S + steps, device=device)
        counts.append(launches())
        reset()
        out = {"forward": whole,
               **{f"prefill_{n}": st["ssm"][n].clone() for n in ("h", "conv")},
               **{f"prefill_{n}": st["kv"][n].clone() for n in ("k", "v")}}
        logits = [lg]
        for i in range(steps):
            lg, st = models.decode_step(params, st, toks[:, S + i], cfg,
                                        device=device)
            logits.append(lg)
        counts.append(launches())
        out.update(steps=torch.stack(logits, 1), **st["ssm"], **st["kv"])
        return out, counts

    params = models.init_params(cfg, seed=20, device=DEVICE)
    card, got = check_run(params, DEVICE)
    want = [(n_super, 0, 0), (n_super, 0, 0), (0, n_super * steps, 0)]
    if got != want:
        fail(f"[18 hybrid] (a): launches (flash, decode, scan) forward "
             f"{got[0]}, prefill {got[1]}, decode {got[2]}; want {want} (a "
             f"flash launch a super-block a pass, a decode launch a "
             f"super-block a step, no scan)")
    t0 = time.perf_counter()
    host, _ = check_run(tree_to(params, "cpu"), "cpu")
    host_s = time.perf_counter() - t0
    diffs = hold_to_cpu(torch, "[18 hybrid] (a)", card, host)
    own = decode_against_forward(torch, "[18 hybrid] (a)", card, S, steps)
    say(f"[18 hybrid] (a) {full.name} at full width, {a['layers']} layers "
        f"({n_super} super-blocks of {cfg.attn_every} Mamba2 layers and "
        f"the shared block), float32, B {a['B']}: forward over "
        f"{S + steps} tokens, prefill of {S}, {steps} decode steps; card "
        f"against the CPU rerun (max abs err: forward "
        f"{diffs['forward']:.3g}, prefill and decode logits "
        f"{diffs['steps']:.3g}, prefill h {diffs['prefill_h']:.3g}, conv "
        f"{diffs['prefill_conv']:.3g}, K/V "
        f"{max(diffs['prefill_k'], diffs['prefill_v']):.3g}; final h "
        f"{diffs['h']:.3g}, conv {diffs['conv']:.3g}, K/V "
        f"{max(diffs['k'], diffs['v']):.3g}; tolerance {ZOO_TOL}); card "
        f"decode against card forward {own:.3g}; launches (flash, decode, "
        f"scan) forward {got[0]}, prefill {got[1]}, decode {got[2]}; CPU "
        f"rerun {host_s:.1f} s")
    del params, card, host
    torch.cuda.empty_cache()

    # (b) all 54 layers in bfloat16: prefill, then greedy decode
    b = HYBRID_SERVE
    cfg, L = full, full.num_layers
    n_super = L // cfg.attn_every
    S, steps = b["S"], b["steps"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=21, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = nbytes(params)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b["B"], S)),
                             device=DEVICE)

    def serve(timed: bool):
        return serve_greedy(torch, models, params, cfg, prompt, steps, timed,
                            max_len=b["max_len"])

    # the warm-up run holds the first and last super-block's attention, at
    # the prefill and at the last decode step, to the plain versions
    holds, kept = attention_holds(
        torch, "[18 hybrid]", lambda: serve(timed=False),
        {0: "first super-block", n_super - 1: "last super-block"},
        {(steps - 1) * n_super: "first super-block",
         steps * n_super - 1: "last super-block"}, steps)

    reset()
    prefill_s, step_ms, logits, lg, st = serve(timed=True)
    got = launches()
    if got != (n_super, n_super * steps, 0):
        fail(f"[18 hybrid] (b): launches flash {got[0]}, decode {got[1]}, "
             f"scan {got[2]}; want {n_super} (super-blocks x 1 pass), "
             f"{n_super * steps} (super-blocks x steps) and 0")
    if not bool(torch.isfinite(logits).all()):
        fail("[18 hybrid] (b): a logit is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # a step waits for nothing on the host: one more under the sync
    # debugger, which raises at any synchronising call
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, st = models.decode_step(params, st, lg.argmax(-1), cfg,
                                    device=DEVICE)
    except RuntimeError as e:
        fail(f"[18 hybrid] (b): a decode step synchronised with the host: "
             f"{e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)

    # yardsticks: prefill's operations (the Mamba2 projections and the
    # shared block's matmuls and causal attention once a super-block, the
    # last position's unembedding, at the bfloat16 peak; the SSD's matmuls
    # at the fp32 CUDA cores'); a decode step's bytes (every weight, the
    # shared block's once a super-block, the untied head read whole, B
    # embedding rows, the live caches at the last step, each layer's h and
    # conv read and written) over HBM's rate
    shared = params["shared_attn"]
    layer_mm = sum(lp["mamba"][n].numel() for lp in params["layers"]
                   for n in ("in_proj", "out_proj"))
    shared_mm = sum(t.numel() for g in ("attn", "mlp")
                    for t in shared[g].values())
    pairs = S * (S + 1) / 2
    mm_flops = (2.0 * (layer_mm + n_super * shared_mm) * b["B"] * S
                + 4.0 * n_super * b["B"] * cfg.num_heads * pairs
                * cfg.head_dim
                + 2.0 * cfg.d_model * cfg.vocab_size * b["B"])
    ssd_flops = L * ssd_operations(cfg, b["B"], S)
    prefill_bound = (mm_flops / kernels_bench.BF16_FLOPS
                     + ssd_flops / kernels_bench.FP32_FLOPS) * 1e3
    item = params["embed"]["tok"].element_size()
    state_bytes = nbytes(st["ssm"])
    cache_live = (2.0 * n_super * b["B"] * cfg.num_kv_heads * (S + steps)
                  * cfg.head_dim * item)
    step_bytes = (nbytes(params["layers"]) + n_super * nbytes(shared)
                  + nbytes(params["embed"]["head"])
                  + nbytes(params["final_norm"])
                  + b["B"] * cfg.d_model * item + cache_live
                  + 2.0 * state_bytes)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    ms = sorted(step_ms)
    line = dict(
        config=f"{cfg.name} {L} layers bfloat16 B {b['B']} prefill {S} "
               f"max_len {b['max_len']} steps {steps}",
        weights_gb=weight_bytes / 1e9, init_s=init_s, prefill_s=prefill_s,
        prefill_tokens_per_s=b["B"] * S / prefill_s,
        prefill_bound_ms=prefill_bound,
        decode_ms_mean=sum(step_ms) / steps, decode_ms_p50=ms[steps // 2],
        decode_ms_min=ms[0], decode_ms_max=ms[-1],
        decode_bound_ms=step_bound, state_gb=state_bytes / 1e9,
        cache_gb=nbytes(st["kv"]) / 1e9, peak_gb=peak_gb)
    say(f"[18 hybrid] (b) {cfg.name}, {L} layers ({n_super} super-blocks), "
        f"bfloat16, weights {weight_bytes / 1e9:.2f} GB made in "
        f"{init_s:.1f} s ({held_gb:.2f} GB held before); prefill B "
        f"{b['B']} x S {S} into max_len {b['max_len']}: "
        f"{prefill_s * 1e3:.1f} ms, {b['B'] * S / prefill_s:.0f} tokens/s "
        f"(operations bound {prefill_bound:.1f} ms: {mm_flops / 1e12:.2f} "
        f"TFLOP of matmuls and attention at 989 TFLOP/s and "
        f"{ssd_flops / 1e12:.3f} of the SSD at 67); {steps} greedy decode "
        f"steps: mean {line['decode_ms_mean']:.3f} ms/step, p50 "
        f"{ms[steps // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f} (byte "
        f"bound {step_bound:.3f} ms: {step_bytes / 1e9:.2f} GB, the state "
        f"{state_bytes / 1e9:.3f} GB read and written, the live caches "
        f"{cache_live / 1e9:.3f} GB, over 3.35 TB/s); launches flash "
        f"{got[0]} (= {n_super} super-blocks x 1 pass), decode {got[1]} (= "
        f"{n_super} x {steps} steps), scan {got[2]}; every logit finite; a "
        f"step under the sync debugger ran without a host sync; caches "
        f"{line['cache_gb']:.2f} GB, state {line['state_gb']:.2f} GB; peak "
        f"memory {peak_gb:.2f} GB")
    for label, err, share in holds:
        say(f"{label}: agrees with the plain version (max abs err "
            f"{err:.3g}, bfloat16 bit-equal {share:.4f})")

    # where the time goes: a prefill, its SSD timed with CUDA events, and
    # HYBRID_PROFILED further decode steps under torch.profiler
    marks = []
    base_ssd = ssm.ssd_chunked

    def ssd_marked(*args):
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ends[0].record()
        out = base_ssd(*args)
        ends[1].record()
        marks.append(ends)
        return out

    def marked_prefill():
        ssm.ssd_chunked = ssd_marked
        try:
            models.prefill(params, {"tokens": prompt}, cfg,
                           max_len=b["max_len"], device=DEVICE)
        finally:
            ssm.ssd_chunked = base_ssd

    state = {"lg": lg, "st": st}

    def more_steps():
        for _ in range(HYBRID_PROFILED):
            state["lg"], state["st"] = models.decode_step(
                params, state["st"], state["lg"].argmax(-1), cfg,
                device=DEVICE)

    prefill_profile = profile_passes(
        torch, "[18 hybrid] prefill", marked_prefill, 1,
        ("flash", "decode_"), "attention")
    if len(marks) != L:
        fail(f"[18 hybrid] (b): {len(marks)} SSD calls in a prefill, want "
             f"{L}")
    ssd_ms = sum(start.elapsed_time(end) for start, end in marks)
    prefill_profile.update(ssd_ms=ssd_ms,
                           ssd_share=ssd_ms / prefill_profile["device_ms"])
    say(f"[18 hybrid] prefill's SSD ({L} calls, CUDA events around each): "
        f"{ssd_ms:.3f} ms, {100 * prefill_profile['ssd_share']:.1f} % of "
        f"the prefill's device time ({ssd_flops / 1e12:.3f} TFLOP, "
        f"{ssd_flops / ssd_ms / 1e9:.1f} TFLOP/s against 67)")
    decode_profile = profile_passes(
        torch, f"[18 hybrid] {HYBRID_PROFILED} decode steps", more_steps,
        HYBRID_PROFILED, ("flash", "decode_"), "attention")
    del state, lg, st, logits
    line.update(prefill_profile=prefill_profile,
                decode_profile=decode_profile)

    # the two kernels at the model's shapes, the warm-up run's inputs
    zoo = attention_zoo(torch, "[18 hybrid]", cfg.name, kept, holds,
                        {"flash_attention": got[0],
                         "decode_attention": got[1]}, errs)
    zoo["flash_attention"]["serving"] = line
    del params, kept
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[18 hybrid] phase {time.perf_counter() - t_phase:.1f} s")
    return zoo


def moe_drops(torch, cfg, router, x):
    """The (token, expert) entries that capacity drops in one moe call on
    x (B, S, D) with ``router``, reckoned with the port's own ``_route``
    and ``_dispatch_indices``; returns (dropped, entries, C).  One chunk
    (T <= ``moe.MOE_CHUNK``)."""
    from repro_torch.models import moe

    tokens = x.reshape(-1, x.shape[-1])
    T = tokens.shape[0]
    if T > moe.MOE_CHUNK:
        fail(f"[19 moe] {T} tokens are more than one chunk")
    C = moe.capacity(cfg, T)
    ids = moe._route(tokens.float(), router, cfg.experts_per_token)[1]
    valid = moe._dispatch_indices(ids, cfg.num_experts, C)[1]
    return int((~valid).sum()), valid.numel(), C


def phase_moe_zoo(torch, np, errs):
    """Phase 19, the MoE zoo's serving path (see the module docstring).
    ``errs`` takes the attention holds' errors; returns the flash and
    decode kernels' ``zoo_moe`` entries for the kernels line."""
    import dataclasses

    from repro_torch import models
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    gc.collect()                    # phase 18's weights go first
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    full = get_config(MOE_ARCH)
    E, k = full.num_experts, full.experts_per_token
    rng = np.random.default_rng(22)

    def reset():
        flash_attention.LAUNCHES = decode_attention.LAUNCHES = 0

    def launches():
        return flash_attention.LAUNCHES, decode_attention.LAUNCHES

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    # (a) two layers at full width in float32, the card against the CPU
    a = MOE_CHECK
    cfg = dataclasses.replace(full, num_layers=a["layers"], dtype="float32")
    S, steps = a["S"], a["steps"]
    tokens = rng.integers(0, cfg.vocab_size, (a["B"], S + steps))

    def check_run(params, device, cfg):
        toks = torch.as_tensor(tokens, device=device)
        whole, aux = models.forward(params, {"tokens": toks}, cfg,
                                    device=device)
        lg, st = models.prefill(params, {"tokens": toks[:, :S]}, cfg,
                                max_len=S + steps, device=device)
        out = [lg]
        for i in range(steps):
            lg, st = models.decode_step(params, st, toks[:, S + i], cfg,
                                        device=device)
            out.append(lg)
        return dict(forward=whole, steps=torch.stack(out, 1),
                    k=st["kv"]["k"], v=st["kv"]["v"], **aux)

    params = models.init_params(cfg, seed=22, device=DEVICE)
    weights_gb = nbytes(params) / 1e9
    reset()
    card = check_run(params, DEVICE, cfg)
    got = launches()
    if got != (a["layers"] * 2, a["layers"] * steps):
        fail(f"[19 moe] (a): launches flash {got[0]}, decode {got[1]}; "
             f"want {a['layers'] * 2} (layers x 2 passes) and "
             f"{a['layers'] * steps} (layers x steps)")
    if not all(float(card[n]) > 0 for n in ("moe_aux", "moe_z")):
        fail("[19 moe] (a): the aux and z losses are not positive")
    t0 = time.perf_counter()
    host = check_run(tree_to(params, "cpu"), "cpu", cfg)
    host_s = time.perf_counter() - t0
    diffs = hold_to_cpu(torch, "[19 moe] (a)", card, host)
    # decode against forward only where nothing can drop: at the config's
    # 1.25 the forward's B x (S + steps) tokens compete for C slots an
    # expert that a step's B tokens never fill, so the reference's decode
    # parts from its forward too; at capacity_factor E / k, C is the chunk
    roomy = dataclasses.replace(cfg, capacity_factor=E / k)
    own = decode_against_forward(torch, "[19 moe] (a)",
                                 check_run(params, DEVICE, roomy), S, steps)
    T = a["B"] * (S + steps)
    say(f"[19 moe] (a) {full.name} at full width, {a['layers']} layers, "
        f"float32 ({weights_gb:.2f} GB), B {a['B']}: forward over "
        f"{S + steps} tokens (C = {moe.capacity(cfg, T)} slots an expert "
        f"of {E}, top-{k}), prefill of {S}, {steps} decode steps; card "
        f"against the CPU rerun (max abs err: forward "
        f"{diffs['forward']:.3g}, prefill and decode logits "
        f"{diffs['steps']:.3g}, caches {max(diffs['k'], diffs['v']):.3g}, "
        f"moe_aux {diffs['moe_aux']:.3g} of {float(card['moe_aux']):.4f}, "
        f"moe_z {diffs['moe_z']:.3g} of {float(card['moe_z']):.4f}; "
        f"tolerance {ZOO_TOL}); card decode against card forward {own:.3g} "
        f"at capacity_factor E/k = {E // k} (C = "
        f"{moe.capacity(roomy, T)}, the whole chunk: nothing drops, where "
        f"at 1.25 a forward's tokens compete for slots a step's never "
        f"fill); launches flash {got[0]}, decode {got[1]}; CPU rerun "
        f"{host_s:.1f} s")
    del params, card, host
    gc.collect()
    torch.cuda.empty_cache()

    # (b) all 48 layers in bfloat16: prefill, then greedy decode
    b = MOE_SERVE
    cfg, L = full, full.num_layers
    S, steps = b["S"], b["steps"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=23, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = nbytes(params)
    router_bytes = sum(nbytes(lp["moe"]["router"])
                       for lp in params["layers"])
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b["B"], S)),
                             device=DEVICE)

    def serve(timed: bool):
        return serve_greedy(torch, models, params, cfg, prompt, steps, timed,
                            max_len=b["max_len"])

    # the warm-up run holds the first and last layer's attention, at the
    # prefill and at the last decode step, to the plain versions, and
    # keeps layer 0's moe input at the prefill and at the first step
    base_block, inputs = moe.moe_block, {}

    def moe_kept(p, x, cfg_):
        n = inputs.setdefault("calls", 0)
        inputs["calls"] = n + 1
        if n in (0, L):
            inputs["prefill" if n == 0 else "step"] = (p["router"],
                                                      x.clone())
        return base_block(p, x, cfg_)

    moe.moe_block = moe_kept
    try:
        holds, kept = attention_holds(
            torch, "[19 moe]", lambda: serve(timed=False),
            {0: "first layer", L - 1: "last layer"},
            {(steps - 1) * L: "first layer", steps * L - 1: "last layer"},
            steps)
    finally:
        moe.moe_block = base_block
    if inputs.get("calls") != L * (1 + steps):
        fail(f"[19 moe] (b): {inputs.get('calls')} moe calls in a prefill "
             f"and {steps} steps, want {L * (1 + steps)}")
    drops = {n: moe_drops(torch, cfg, *inputs[n])
             for n in ("prefill", "step")}
    del inputs

    reset()
    prefill_s, step_ms, logits, lg, st = serve(timed=True)
    got = launches()
    if got != (L, L * steps):
        fail(f"[19 moe] (b): launches flash {got[0]}, decode {got[1]}; "
             f"want {L} (layers x 1 pass) and {L * steps} (layers x "
             f"steps)")
    if not bool(torch.isfinite(logits).all()):
        fail("[19 moe] (b): a logit is not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # a prefill and a step wait for nothing on the host: one of each
    # under the sync debugger, which raises at any synchronising call
    torch.cuda.set_sync_debug_mode("error")
    try:
        models.prefill(params, {"tokens": prompt}, cfg,
                       max_len=b["max_len"], device=DEVICE)
        lg, st = models.decode_step(params, st, lg.argmax(-1), cfg,
                                    device=DEVICE)
    except RuntimeError as e:
        fail(f"[19 moe] (b): a prefill or a decode step synchronised with "
             f"the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)

    # yardsticks: prefill's operations at the bfloat16 peak (the experts
    # over all E x C slots, as the reference computes them whether a slot
    # is filled or not; the attention projections; causal attention; the
    # last position's unembedding) and the float32 router's at the fp32
    # peak; a decode step's bytes (every weight but the embedding table
    # once: each step runs every expert over its C = 4 slots; B embedding
    # rows; the live caches at the last step) over HBM's rate
    T = b["B"] * S
    C = moe.capacity(cfg, T)
    D, F = cfg.d_model, cfg.d_ff
    attn_elems = sum(t.numel() for t in params["layers"][0]["attn"].values())
    pairs = S * (S + 1) / 2
    expert_flops = 6.0 * E * C * D * F
    mm_flops = (L * (expert_flops + 2.0 * attn_elems * T
                     + 4.0 * b["B"] * cfg.num_heads * pairs * cfg.head_dim)
                + 2.0 * D * cfg.vocab_size * b["B"])
    router_flops = L * 2.0 * T * D * E
    prefill_bound = (mm_flops / kernels_bench.BF16_FLOPS
                     + router_flops / kernels_bench.FP32_FLOPS) * 1e3
    tok = params["embed"]["tok"]
    item = tok.element_size()
    cache_live = (2.0 * L * b["B"] * cfg.num_kv_heads * (S + steps)
                  * cfg.head_dim * item)
    step_bytes = (weight_bytes - nbytes(tok) + b["B"] * D * item
                  + cache_live)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    ms = sorted(step_ms)
    line = dict(
        config=f"{cfg.name} {L} layers bfloat16 B {b['B']} prefill {S} "
               f"max_len {b['max_len']} steps {steps}",
        weights_gb=weight_bytes / 1e9, router_gb=router_bytes / 1e9,
        init_s=init_s, prefill_s=prefill_s,
        prefill_tokens_per_s=T / prefill_s, prefill_bound_ms=prefill_bound,
        decode_ms_mean=sum(step_ms) / steps, decode_ms_p50=ms[steps // 2],
        decode_ms_min=ms[0], decode_ms_max=ms[-1],
        decode_bound_ms=step_bound, cache_gb=nbytes(st["kv"]) / 1e9,
        peak_gb=peak_gb, held_gb=held_gb,
        dropped={n: dict(zip(("dropped", "entries", "C"), d))
                 for n, d in drops.items()})
    say(f"[19 moe] (b) {cfg.name}, {L} layers, bfloat16, {E} experts "
        f"top-{k}, weights {weight_bytes / 1e9:.2f} GB (the float32 "
        f"routers {router_bytes / 1e9:.3f} of it) made in {init_s:.1f} s "
        f"({held_gb:.2f} GB held before); prefill B {b['B']} x S {S} into "
        f"max_len {b['max_len']}: {prefill_s * 1e3:.1f} ms, "
        f"{T / prefill_s:.0f} tokens/s (operations bound "
        f"{prefill_bound:.1f} ms: {mm_flops / 1e12:.2f} TFLOP at 989 "
        f"TFLOP/s, the experts over all {E} x {C} slots "
        f"{L * expert_flops / 1e12:.2f} of it, and the routers' "
        f"{router_flops / 1e12:.3f} at 67); {steps} greedy decode steps: "
        f"mean {line['decode_ms_mean']:.3f} ms/step, p50 "
        f"{ms[steps // 2]:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f} (byte "
        f"bound {step_bound:.3f} ms: {step_bytes / 1e9:.2f} GB, every "
        f"expert over its C = {moe.capacity(cfg, b['B'])} slots, the live "
        f"caches {cache_live / 1e9:.3f} GB, over 3.35 TB/s); launches "
        f"flash {got[0]} (= {L} layers x 1 pass), decode {got[1]} (= {L} "
        f"x {steps} steps); every logit finite; a prefill and a step under "
        f"the sync debugger ran without a host sync; caches "
        f"{line['cache_gb']:.2f} GB; peak memory {peak_gb:.2f} GB")
    for n, (dropped, entries, cap) in drops.items():
        say(f"[19 moe] (b) layer 0's {n} ({entries // k} tokens, C = "
            f"{cap}): {dropped} of {entries} (token, expert) entries "
            f"dropped by capacity ({100 * dropped / entries:.2f} %)")
    for label, err, share in holds:
        say(f"{label}: agrees with the plain version (max abs err "
            f"{err:.3g}, bfloat16 bit-equal {share:.4f})")

    # where the time goes: a prefill and MOE_PROFILED further decode steps
    # under torch.profiler (device activity only), after the counted run
    state = {"lg": lg, "st": st}

    def more_steps():
        for _ in range(MOE_PROFILED):
            state["lg"], state["st"] = models.decode_step(
                params, state["st"], state["lg"].argmax(-1), cfg,
                device=DEVICE)

    prefill_profile = profile_passes(
        torch, "[19 moe] prefill", lambda: models.prefill(
            params, {"tokens": prompt}, cfg, max_len=b["max_len"],
            device=DEVICE), 1, ("flash", "decode_"), "attention")
    decode_profile = profile_passes(
        torch, f"[19 moe] {MOE_PROFILED} decode steps", more_steps,
        MOE_PROFILED, ("flash", "decode_"), "attention")
    del state, lg, st, logits
    line.update(prefill_profile=prefill_profile,
                decode_profile=decode_profile)

    # the two kernels at the model's shapes, the warm-up run's inputs
    zoo = attention_zoo(torch, "[19 moe]", cfg.name, kept, holds,
                        {"flash_attention": got[0],
                         "decode_attention": got[1]}, errs)
    zoo["flash_attention"]["serving"] = line
    del params, kept
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[19 moe] phase {time.perf_counter() - t_phase:.1f} s")
    return zoo


def scan_end_state(torch, errs):
    """The scan's end state (``mamba_scan(..., final_state=True)``) held to
    the plain version's h at ``END_STATE_SHAPES``, with y: one launch a
    call, and y equal bit for bit to the call without the end state.
    Returns {label: (plan, max abs err of y, of h_L)}."""
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.kernels import mamba_scan, ref

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, shape in END_STATE_SHAPES:
        B, L, D, N = shape["B"], shape["L"], shape["D"], shape["N"]
        args, _ = kernels_bench.make_inputs("mamba_scan", shape, DEVICE,
                                            seed=L + N)
        plan = mamba_scan.scan_plan(B, L, D, N, n_sms)
        before = mamba_scan.LAUNCHES
        y, h = mamba_scan.mamba_scan(*args, final_state=True)
        if mamba_scan.LAUNCHES != before + 1:
            fail(f"[10 model] mamba_scan end state {label}: "
                 f"{mamba_scan.LAUNCHES - before} launches counted")
        if not torch.equal(mamba_scan.mamba_scan(*args), y):
            fail(f"[10 model] mamba_scan end state {label}: y differs from "
                 f"the call without the end state")
        want_y, want_h = ref.mamba_scan_ref(
            *args, torch.zeros((B, D, N), device=DEVICE))
        tag = f"[10 model] mamba_scan end state {label} {shape}"
        err_y = close_enough(torch, tag, y, want_y, SCAN_TOL)
        err_h = close_enough(torch, f"{tag} h_L", h, want_h, SCAN_TOL)
        errs["mamba_scan"] = max(errs["mamba_scan"], err_y, err_h)
        out[label] = dict(shape, plan=str(plan), max_abs_err_y=err_y,
                          max_abs_err_h=err_h)
        say(f"{tag}: plan {plan}; y and h_L agree with the plain version "
            f"(max abs err {err_y:.3g} and {err_h:.3g}); y equal bit for "
            f"bit to the call without the end state")
        del args, y, h, want_y, want_h
    if {o["plan"].split()[-3] for o in out.values()} != {"1-pass", "3-pass"}:
        fail("[10 model] the end-state holds must reach both the one-pass "
             "and the three-pass plan")
    torch.cuda.empty_cache()
    return out


def ptxas_summary(log: str) -> list[str]:
    """One ``kernel<template args>: R registers, S/L bytes spilled`` item
    per entry function of an ``nvcc -Xptxas -v`` log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"\d+([a-z_]+)I(.*?)EEv", m.group(1))
            plain = re.search(r"\d+([a-z_]+)E", m.group(1))
            entry = (m.group(1) if plain is None else plain.group(1)) \
                if name is None else (
                f"{name.group(1)}<"
                + name.group(2).replace("13__nv_bfloat16", "bf16")
                .replace("Li", "").replace("Lb1", "true")
                .replace("Lb0", "false").replace("E", ",").rstrip(",")
                + ">")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            spill = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append(f"{entry} {m.group(1)} regs, {spill}")
            entry = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch import api
        from repro_torch.kernels import build, ops, ref, reid_topk
        from repro_torch.launch.serve import duke_world, run_stream
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")

    # -- phase 1: environment ------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device '{kind}' x{torch.cuda.device_count()} ({n_sms} SMs); "
        f"nvidia-smi: {smi}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- phase 2: build, one nvcc per source, all started together -------
    # (the CPU reruns that need nothing from the card start with it)
    qs_rerun = cpu_job(quickstart_rerun)
    recal_reruns = {which: cpu_job(recal_rerun, which) for which in (
        "drift_sweep", "tile drift", "soak_130", "sec6_drift")}
    detect_rerun = cpu_job(detection_rerun)
    suite_reruns = {name: cpu_job(suite_rerun, name)
                    for name in SUITE_SWEEPS + SUITE_TABLES}
    t0 = time.perf_counter()
    sources = ("reid_topk", "reid_topk_tiles", "reid_topk_plain",
               "flash_attention", "decode_attention", "mamba_scan")
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(build.build, name) for name in sources}
        lib_paths = {name: f.result() for name, f in futures.items()}
    say(f"[2 build] nvcc sm_90a: {', '.join(f'{n}.cu' for n in sources)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, path in lib_paths.items():
        entries = ptxas_summary(path.with_suffix(".log").read_text())
        say(f"  ptxas {name}.cu: " + "; ".join(entries))
        if name == "decode_attention":
            regs = [int(re.search(r" (\d+) regs", e).group(1))
                    for e in entries]
            spilled = [e for e in entries if " 0/0 B spilled" not in e]
            say(f"  decode templates: {len(entries)}, {min(regs)} to "
                f"{max(regs)} registers, {len(spilled)} spilling")
            if spilled:
                fail("decode templates spill: " + "; ".join(spilled))

    if (reid_topk.SPLIT_QB, reid_topk.SPLIT_GB) != (TILE, TILE):
        fail(f"the split kernels' tile is not {TILE} x {TILE}")

    def plan_of(Q, G):
        """q-blocks x gallery slices of the three re-id kernels."""
        nq, S = reid_topk.split_plan(Q, G, n_sms)
        return f"{nq}x{S}"

    camera = dict(CAMERA, call=ops.reid_topk_segments,
                  plain=ref.reid_topk_segments_ref, axis="C",
                  plan=plan_of)
    tiles = dict(TILES, call=ops.reid_topk_tiles,
                 plain=ref.reid_topk_tiles_ref, axis="CT", plan=plan_of)

    # -- phase 3: kernels vs plain on synthetic inputs -------------------
    rng = np.random.default_rng(0)
    lib = library_call(torch, ref.NEG_INF)
    max_err = {CAMERA["name"]: 0.0, TILES["name"]: 0.0}
    TT = TILE_GRID * TILE_GRID
    cases = [
        # kernel, name, Q, G, D, C (camera) or C*T*T (tiles), k, inputs
        (camera, "ragged 33x517 masked-row pad", 33, 517, 64, 8, 3,
         dict(masked_row=True, pad_rows=40)),
        (camera, "ragged 7x70 k16", 7, 70, 64, 8, 16, {}),
        (camera, "k>G 5x3 k8", 5, 3, 64, 8, 8, {}),
        (camera, "ties 40x300 int", 40, 300, 16, 8, 5, dict(ties=True)),
        (camera, "ties 130cams 96x700 int", 96, 700, 32, 130, 8,
         dict(ties=True, pad_rows=12)),
        (camera, "130cams 64x1000", 64, 1000, 64, 130, 4,
         dict(masked_row=True)),
        (camera, "k1 128x256", 128, 256, 64, 8, 1, {}),
        (tiles, "tiles 8cams T8 ragged 33x517 masked-row unlabeled", 33,
         517, 64, 8 * TT, 3, dict(masked_row=True, pad_rows=40)),
        (tiles, "tiles 8cams T8 ragged 7x70 k16", 7, 70, 64, 8 * TT, 16, {}),
        (tiles, "tiles k>G 5x3 k8", 5, 3, 64, 8 * TT, 8, {}),
        (tiles, "tiles 8cams T8 ties 40x300 int", 40, 300, 16, 8 * TT, 5,
         dict(ties=True)),
        (tiles, "tiles 130cams T8 ties 96x700 int", 96, 700, 32, 130 * TT,
         8, dict(ties=True, pad_rows=12)),
        (tiles, "tiles 130cams T8 64x1000", 64, 1000, 64, 130 * TT, 4,
         dict(masked_row=True)),
        (tiles, "tiles 8cams T8 k1 128x256", 128, 256, 64, 8 * TT, 1, {}),
        (tiles, "tiles 8cams T8 sparse 128x2048", 128, 2048, 64, 8 * TT, 3,
         dict(p_admit=0.0005)),
    ]
    say("[3 kernel] against the plain version on the card, times per call:")
    for kern, name, Q, G, D, C, k, kw in cases:
        args = synthetic_inputs(torch, rng, Q, G, D, C, **kw)
        err, _ = check_and_time(torch, kern, lib, name, args, k,
                                exact_idx=kw.get("ties", False))
        max_err[kern["name"]] = max(max_err[kern["name"]], err)
    # past the camera kernel's 4,096 cameras a camera-masked call runs on
    # the tile kernel (the same eligibility over any cell axis) and still
    # counts as a camera call; on its own seed
    name, Q, G, D, C, k = "ties 8192cams 96x700 int", 96, 700, 32, 8192, 8
    args = synthetic_inputs(torch, np.random.default_rng(C), Q, G, D, C,
                            ties=True, pad_rows=12)
    before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    ops.reid_topk_segments(*args, k)
    if (reid_topk.LAUNCHES - before[0], reid_topk.TILE_LAUNCHES
            - before[1]) != (1, 0):
        fail(f"{name}: not one camera call on the tile kernel")
    err, _ = check_and_time(torch, camera, lib, name, args, k, exact_idx=True)
    max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    # the gallery split's edge cases, on their own seed: every shape splits
    split_rng = np.random.default_rng(15)
    split_cases = [
        # name, Q, G, D, C, k, inputs
        ("split ties across slice boundaries 64x2048 int", 64, 2048, 16, 8,
         16, dict(ties=True, boundary_ties=True)),
        ("split one-tile slices 33x700 k16 int", 33, 700, 16, 8, 16,
         dict(ties=True)),
        ("split masked slices 40x1000 int", 40, 1000, 16, 8, 8,
         dict(ties=True, masked_slices=True, pad_rows=9)),
        ("split G one past a tile 256x8193 130cams", 256, 8193, 64, 130, 16,
         dict(pad_rows=20)),
    ]
    for name, Q, G, D, C, k, kw in split_cases:
        if reid_topk.split_plan(Q, G, n_sms)[1] < 2:
            fail(f"{name}: the plan does not split Q={Q} G={G}")
        args = synthetic_inputs(torch, split_rng, Q, G, D, C, **kw)
        err, _ = check_and_time(torch, camera, lib, name, args, k,
                                exact_idx=kw.get("ties", False))
        max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    # the same through the tile kernel over C*T*T cells (the masked slices
    # hold only the last cell, which nobody admits), and a cell axis past
    # the first tile kernel's limit of 54,688; their own seed
    tile_rng = np.random.default_rng(16)
    tile_split_cases = [
        (f"tiles {name}", Q, G, D, C * TT, k, kw)
        for name, Q, G, D, C, k, kw in split_cases] + [
        ("tiles split CT=61440 past the old limit 70x700 int", 70, 700, 16,
         15 * 64 * 64, 5, dict(ties=True, pad_rows=9))]
    for name, Q, G, D, CT, k, kw in tile_split_cases:
        if reid_topk.split_plan(Q, G, n_sms)[1] < 2:
            fail(f"{name}: the plan does not split Q={Q} G={G}")
        args = synthetic_inputs(torch, tile_rng, Q, G, D, CT, **kw)
        err, _ = check_and_time(torch, tiles, lib, name, args, k,
                                exact_idx=kw.get("ties", False))
        max_err[TILES["name"]] = max(max_err[TILES["name"]], err)
    for kern in (camera, tiles):
        empty = synthetic_inputs(torch, rng, 4, 0, 64, 8)
        before = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
        ev, ei = kern["call"](*empty, 3)
        if (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES) != before or \
                (ei != -1).any() or not (ev < -1e29).all():
            fail(f"{kern['name']}: G == 0 must return the sentinel bands "
                 f"without a launch")
    say("  G=0: sentinel bands, no launch (both kernels)")
    # every tile of each admitted camera admitted: the camera kernel's
    # eligibility and FMA order, so its exact bits
    for Q, G, C, k in ((33, 517, 8, 3), (64, 1000, 130, 16),
                       (256, 8192, 130, 16)):
        cam_args = synthetic_inputs(torch, rng, Q, G, 64, C, pad_rows=9)
        tile_of = torch.from_numpy(rng.integers(0, TT, G).astype(
            np.int32)).to(DEVICE)
        gal_ct = torch.where(cam_args[4] >= 0, cam_args[4] * TT + tile_of,
                             -1).to(torch.int32)
        tile_args = (cam_args[0], cam_args[1],
                     cam_args[2].repeat_interleave(TT, dim=1).contiguous(),
                     cam_args[3], gal_ct, cam_args[5])
        sv, si = ops.reid_topk_segments(*cam_args, k)
        tv, ti = ops.reid_topk_tiles(*tile_args, k)
        if not (torch.equal(sv, tv) and torch.equal(si, ti)):
            fail(f"all tiles admitted: the tile kernel differs from the "
                 f"camera kernel at Q={Q} G={G} C={C} k={k}")
    say("  all tiles admitted: the tile kernel equals the camera kernel bit "
        "for bit (Q=33 G=517 C=8 k=3; Q=64 G=1000 C=130 k=16; Q=256 G=8192 "
        f"C=130 k=16, both plans {plan_of(256, 8192)})")

    stress = synthetic_inputs(torch, rng, 256, 8192, 2048, 130, n_tags=2,
                              p_admit=0.75, pad_rows=80)
    err, st = check_and_time(torch, camera, lib, "stress", stress, 16,
                             exact_idx=False)
    if reid_topk.split_plan(256, 8192, n_sms)[1] < 2:
        fail("the stress shape does not split the gallery")
    max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    stress_t = synthetic_inputs(torch, rng, 256, 8192, 2048, 130 * TT,
                                n_tags=2, p_admit=0.75, pad_rows=80)
    err, st_t = check_and_time(torch, tiles, lib, "tiles stress", stress_t,
                               16, exact_idx=False)
    if st_t["plan"] != st["plan"]:
        fail(f"the tile stress plan {st_t['plan']} is not the camera "
             f"kernel's {st['plan']}")
    max_err[TILES["name"]] = max(max_err[TILES["name"]], err)
    del stress, stress_t

    # -- phase 4: the camera-granular main path, until every query is done
    t0 = time.perf_counter()
    world = duke_world(100)
    model = api.profile(world.vis, time_limit=3000, device=DEVICE)
    policy = api.SearchPolicy()
    horizon_ticks = world.vis.horizon - int(world.vis.t_out[world.q_vids]
                                            .min())
    say(f"[4 main] duke world: {world.net.n_cams} cameras, "
        f"{len(world.vis)} visits, horizon {world.vis.horizon}, "
        f"{len(world.q_vids)} queries; built in "
        f"{time.perf_counter() - t0:.1f} s")

    def recorder(entry, rounds, kept, hook=None):
        """A stand-in for ``ops.<entry>`` that records each ranked round's
        (Q, G), keeps a copy of the first inputs of each shape, and calls
        ``hook`` on the inputs before the real wrapper runs."""
        real = getattr(ops, entry)

        def call(*a):
            shape = (a[0].shape[0], a[3].shape[0])
            rounds.append(shape)
            if kept is not None and shape not in kept:
                kept[shape] = (tuple(t.clone() for t in a[:6]), a[6])
            if hook is not None:
                hook(a)
            return real(*a)
        return real, call

    def serve(device, trace, ticks=horizon_ticks, on_step=None):
        eng = api.serve(model.to(device), lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        consolidate=True, device=device)
        return eng, run_stream(eng, world, ticks, trace, on_step)

    rounds, kept = [], {}      # (Q, G) of every ranked round; inputs by shape
    gpu_trace, cam_at = [], {}
    real_call, ops.reid_topk_segments = recorder("reid_topk_segments",
                                                 rounds, kept)
    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    try:
        eng, tick_s = serve(DEVICE, gpu_trace,
                            on_step=snapshot_at(FLEET_CUT_TICKS, gpu_trace,
                                                cam_at))
    finally:
        launches, stray = reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES
        ops.reid_topk_segments = real_call
    nonempty = sum(1 for q, g in rounds if q > 0 and g > 0)
    if launches == 0 or launches != nonempty:
        fail(f"reid_topk launches {launches} != non-empty rounds {nonempty}")
    if stray:
        fail(f"the camera path launched the tile kernel {stray} times")
    naive = eng.content_steps * world.net.n_cams   # all-camera search
    matches = sum(len(q.matches) for q in eng.queries.values())
    rescues = sum(q.rescued for q in eng.queries.values())
    lat = np.asarray(tick_s) * 1e3
    served = len({r["qid"] for r in gpu_trace})
    done = sum(q.done for q in eng.queries.values())
    say(f"[4 main] cuda: {len(tick_s)} ticks (horizon {horizon_ticks}), "
        f"{served} of {len(world.q_vids)} queries served, {done} done, "
        f"{len(rounds)} ranked rounds, "
        f"reid_topk launches {launches} (= non-empty rounds), "
        f"reid_topk_tiles launches 0; "
        f"admitted_steps={eng.admitted_steps} "
        f"unique_frames={eng.unique_frames} over {eng.content_steps} query "
        f"rounds, savings vs all-camera search of those rounds "
        f"{naive / max(eng.admitted_steps, 1):.2f}x; matches={matches} "
        f"replay rescues={rescues}; {len(tick_s) / sum(tick_s):.1f} ticks/s; "
        f"tick p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms")

    cpu_trace = []
    t0 = time.perf_counter()
    eng_cpu, _ = serve("cpu", cpu_trace)
    n, parted = compare_traces(gpu_trace, cpu_trace, policy.match_thresh)
    if parted is None and (eng_cpu.admitted_steps, eng_cpu.unique_frames) \
            != (eng.admitted_steps, eng.unique_frames):
        fail("cuda and cpu runs disagree on the cost counters")
    say(f"[4 main] cpu rerun (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: {n} of {len(gpu_trace)} trace "
        f"records agree"
        + ("; cost counters equal" if parted is None else
           f"; query {parted} parted at a near-threshold record, so the "
           f"cost counters are not compared"))

    singles = {"camera": dict(trace=gpu_trace, eng=eng, at=cam_at,
                              share=device_share(torch, serve, "[4 main]"))}

    # -- phase 5: the camera path's round shapes --------------------------
    shapes = sorted(kept, key=lambda s: s[0] * s[1])
    main_shape = max(kept, key=lambda s: (rounds.count(s), s[0] * s[1]))
    largest = shapes[-1]
    for shape in shapes:
        args, k = kept[shape]
        err = check_against_plain(torch, camera, f"round {shape}", args, k,
                                  exact_idx=False)
        max_err[CAMERA["name"]] = max(max_err[CAMERA["name"]], err)
    if reid_topk.split_plan(*main_shape, n_sms)[1] != 1:
        fail(f"the main round shape {main_shape} splits the gallery")
    say(f"[5 rounds] {len(shapes)} round shapes (Q, G), all agree with the "
        f"plain version (max abs err {max_err[CAMERA['name']]:.3g}); the "
        f"most frequent is Q={main_shape[0]} G={main_shape[1]} "
        f"({rounds.count(main_shape)} rounds), the largest Q={largest[0]} "
        f"G={largest[1]}")
    timings = {}
    for shape in dict.fromkeys((main_shape, largest)):
        args, k = kept[shape]
        _, timings[shape] = check_and_time(
            torch, camera, lib, f"round {shape}", args, k, exact_idx=False)
    row = timings[main_shape]
    args, k = kept[main_shape]
    big = timings[largest]
    camera_row = dict(
        launches=launches, max_abs_err=max_err[CAMERA["name"]], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=dict(Q=main_shape[0], G=main_shape[1], D=int(args[0].shape[1]),
                   C=int(args[2].shape[1]), k=k, plan=row["plan"]),
        largest=dict(Q=largest[0], G=largest[1], ms=big["ms"],
                     plain_ms=big["plain_ms"], library_ms=big["library_ms"],
                     bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     plan=big["plan"]),
        stress=dict(Q=256, G=8192, D=2048, C=130, k=16, ms=st["ms"],
                    plain_ms=st["plain_ms"], library_ms=st["library_ms"],
                    bound_ms=st["bound_ms"], bound_by=st["bound_by"],
                    plan=st["plan"]))
    del kept

    # -- phase 6: the tile path, until every query is done ----------------
    t0 = time.perf_counter()
    tile_model = api.profile(world.vis, time_limit=3000, tile_grid=TILE_GRID,
                             device=DEVICE)
    say(f"[6 tiles] profiled with tile_grid={TILE_GRID} in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{int(tile_model.tile_admit.sum())} of "
        f"{tile_model.tile_admit.numel()} (src, dst, tile) cells admitted")

    def serve_tiles(device, trace, ticks=horizon_ticks, on_step=None):
        eng = api.serve(tile_model.to(device), lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        tile_grid=TILE_GRID, device=device)
        return eng, run_stream(eng, world, ticks, trace, on_step)

    t_rounds, t_kept = [], {}
    gpu_trace, tiles_at = [], {}
    real_call, ops.reid_topk_tiles = recorder("reid_topk_tiles", t_rounds,
                                              t_kept)
    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    try:
        eng, tick_s = serve_tiles(DEVICE, gpu_trace,
                                  on_step=snapshot_at(FLEET_CUT_TICKS,
                                                      gpu_trace, tiles_at))
    finally:
        t_launches, stray = reid_topk.TILE_LAUNCHES, reid_topk.LAUNCHES
        ops.reid_topk_tiles = real_call
    nonempty = sum(1 for q, g in t_rounds if q > 0 and g > 0)
    if t_launches == 0 or t_launches != nonempty:
        fail(f"reid_topk_tiles launches {t_launches} != non-empty rounds "
             f"{nonempty}")
    if stray:
        fail(f"the tile path launched the camera kernel {stray} times")
    done = sum(q.done for q in eng.queries.values())
    served = len({r["qid"] for r in gpu_trace})
    lat = np.asarray(tick_s) * 1e3
    base_tiles = TT * eng.admitted_steps
    counters = ("admitted_steps", "unique_frames", "admitted_tiles",
                "unique_tiles")
    say(f"[6 tiles] cuda: {len(tick_s)} ticks (horizon {horizon_ticks}), "
        f"{served} of {len(world.q_vids)} queries served, {done} done; "
        f"{len(t_rounds)} ranked rounds, reid_topk_tiles launches "
        f"{t_launches} (= non-empty rounds), reid_topk launches 0; "
        + " ".join(f"{c}={getattr(eng, c)}" for c in counters)
        + f"; admitted tiles {eng.admitted_tiles} of {base_tiles} "
        f"camera-granular ({base_tiles / max(eng.admitted_tiles, 1):.3f}x), "
        f"unique {eng.unique_tiles} of {TT * eng.unique_frames}; "
        f"matches={sum(len(q.matches) for q in eng.queries.values())}; "
        f"{len(tick_s) / sum(tick_s):.1f} ticks/s; tick p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} "
        f"ms")

    live = [0, 0]

    def count_live(a):
        n_live, n_total = live_tiles(torch, a)
        live[0] += n_live
        live[1] += n_total

    cpu_trace = []
    t0 = time.perf_counter()
    real_call, ops.reid_topk_tiles = recorder("reid_topk_tiles", [], None,
                                              count_live)
    try:
        eng_cpu, _ = serve_tiles("cpu", cpu_trace)
    finally:
        ops.reid_topk_tiles = real_call
    n, parted = compare_traces(gpu_trace, cpu_trace, policy.match_thresh)
    if parted is None and any(getattr(eng_cpu, c) != getattr(eng, c)
                              for c in counters):
        fail("cuda and cpu tile runs disagree on the cost counters: "
             + " ".join(f"{c} {getattr(eng, c)}/{getattr(eng_cpu, c)}"
                        for c in counters))
    live_share = live[0] / max(live[1], 1)
    say(f"[6 tiles] cpu rerun (plain versions) in "
        f"{time.perf_counter() - t0:.1f} s: {n} of {len(gpu_trace)} trace "
        f"records agree"
        + ("; all four cost counters equal" if parted is None else
           f"; query {parted} parted at a near-threshold record, so the "
           f"cost counters are not compared")
        + f"; live (64-row, 64-row) tiles over the run's rounds: {live[0]} "
          f"of {live[1]} ({100 * live_share:.2f} %)")

    device_share(torch, serve_tiles, "[6 tiles]", ticks=TICKS)
    singles["tiles"] = dict(trace=gpu_trace, eng=eng, at=tiles_at)

    # -- phase 7: the tile path's round shapes ----------------------------
    t_shapes = sorted(t_kept, key=lambda s: s[0] * s[1])
    t_main = max(t_kept, key=lambda s: (t_rounds.count(s), s[0] * s[1]))
    largest = t_shapes[-1]
    for shape in t_shapes:
        args, k = t_kept[shape]
        err = check_against_plain(torch, tiles, f"tile round {shape}", args,
                                  k, exact_idx=False)
        max_err[TILES["name"]] = max(max_err[TILES["name"]], err)
    if reid_topk.split_plan(*t_main, n_sms)[1] != 1:
        fail(f"the main tile round shape {t_main} splits the gallery")
    say(f"[7 tile rounds] {len(t_shapes)} round shapes (Q, G), all agree "
        f"with the plain version (max abs err "
        f"{max_err[TILES['name']]:.3g}); the most frequent is "
        f"Q={t_main[0]} G={t_main[1]} ({t_rounds.count(t_main)} rounds), "
        f"the largest Q={largest[0]} G={largest[1]}")
    t_timings = {}
    for shape in dict.fromkeys((t_main, largest)):
        args, k = t_kept[shape]
        _, t_timings[shape] = check_and_time(
            torch, tiles, lib, f"tile round {shape}", args, k,
            exact_idx=False)
    row = t_timings[t_main]
    args, k = t_kept[t_main]
    big = t_timings[largest]
    tiles_row = dict(
        launches=t_launches, max_abs_err=max_err[TILES["name"]],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=dict(Q=t_main[0], G=t_main[1], D=int(args[0].shape[1]),
                   CT=int(args[2].shape[1]), k=k, plan=row["plan"]),
        largest=dict(Q=largest[0], G=largest[1], ms=big["ms"],
                     plain_ms=big["plain_ms"], library_ms=big["library_ms"],
                     bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     plan=big["plan"]),
        live_tile_share=live_share,
        stress=dict(Q=256, G=8192, D=2048, CT=130 * TT, k=16, ms=st_t["ms"],
                    plain_ms=st_t["plain_ms"],
                    library_ms=st_t["library_ms"],
                    bound_ms=st_t["bound_ms"], bound_by=st_t["bound_by"],
                    plan=st_t["plan"]))

    # -- phase 8: the benchmark's kernels on edge inputs ------------------
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks.kernels_bench import device_ms
    from repro_torch.kernels import decode_attention, flash_attention, \
        mamba_scan

    errs = {name: 0.0 for name in BENCH}
    gen = torch.Generator(device=DEVICE).manual_seed(8)

    def randn(*size, dtype=torch.float32, scale=1.0):
        return (torch.randn(size, generator=gen, device=DEVICE)
                * scale).to(dtype)

    unmasked = dict(call=ops.reid_topk, plain=ref.reid_topk_ref)
    topk_cases = ((33, 517, 16, 5, False), (7, 70, 8, 3, False),
                  (1, 1, 64, 1, False), (64, 513, 64, 16, False),
                  (40, 300, 16, 5, True), (130, 1000, 32, 16, True),
                  (5, 3, 16, 8, False),
                  # the gallery split: ties across slice boundaries, k = 16
                  # over one-tile slices, G one past a tile
                  (64, 2048, 16, 16, "boundary"), (33, 700, 16, 16, True),
                  (256, 8193, 64, 16, False))
    for Q, G, D, k, ties in topk_cases:
        if ties:
            q = torch.randint(0, 2, (Q, D), generator=gen, device=DEVICE)
            g = torch.randint(0, 2, (G, D), generator=gen, device=DEVICE)
            q, g = q.float(), g.float()
            if ties == "boundary":
                for b in range(TILE, G - 1, TILE):
                    g[b] = g[b - 1]
                    g[b + 1] = g[b - 2]
        else:
            q, g = randn(Q, D), randn(G, D)
        errs["reid_topk"] = max(errs["reid_topk"], check_against_plain(
            torch, unmasked, f"reid_topk {Q}x{G}x{D} k{k}", (q, g), k,
            exact_idx=ties or G < k))
    for Q, G in ((4, 0), (0, 12)):
        before = reid_topk.UNMASKED_LAUNCHES
        ev, ei = ops.reid_topk(randn(Q, 8), randn(G, 8), 3)
        if reid_topk.UNMASKED_LAUNCHES != before or ev.shape != (Q, 3) or \
                (ei != -1).any() or not (ev < -1e29).all():
            fail(f"reid_topk Q={Q} G={G}: must return sentinel bands "
                 f"without a launch")
    say(f"[8 edge] reid_topk: {len(topk_cases)} shapes (ragged, ties on "
        f"integer-valued inputs with exact indices, k > G, split plans "
        + ", ".join(plan_of(Q, G) for Q, G, *_ in topk_cases[-3:])
        + ") agree with the "
        f"plain version (max abs err {errs['reid_topk']:.3g}); G == 0 and "
        f"Q == 0 give sentinels without a launch")

    n_flash = 0
    flash_hds = (8, 32, 40, 64, 80, 96, 128, 136, 256)
    for hd in flash_hds:
        for H, KV in ((4, 4), (8, 2), (8, 1)):          # MHA, GQA, MQA
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    for S, T in ((192, 192), (100, 260), (260, 100)):
                        q = randn(2, H, S, hd, dtype=dtype)
                        k = randn(2, KV, T, hd, dtype=dtype)
                        v = randn(2, KV, T, hd, dtype=dtype)
                        label = (f"flash H={H} KV={KV} S={S} T={T} hd={hd} "
                                 f"causal={causal} {dtype}")
                        errs["flash_attention"] = max(
                            errs["flash_attention"], close_enough(
                                torch, label,
                                ops.flash_attention(q, k, v, causal=causal),
                                ref.flash_attention_ref(q, k, v,
                                                        causal=causal),
                                ATTN_TOL[str(dtype).split(".")[1]]))
                        n_flash += 1
    say(f"[8 edge] flash_attention: {n_flash} cases (MHA, GQA, MQA; hd "
        + ", ".join(map(str, flash_hds)) + "; causal or not; S = T, S < T, "
        f"S > T; float32 and bfloat16) agree with the plain version (max "
        f"abs err {errs['flash_attention']:.3g}); bfloat16 outputs "
        f"bit-equal: {min_share('flash')}; plans "
        + ", ".join(f"hd{hd} {flash_attention.flash_plan(hd, dt)}"
                    for hd in (64, 128, 256)
                    for dt in (torch.float32, torch.bfloat16)))

    n_dec = 0
    T = 700                 # not a whole number of the kernel's tiles
    length = torch.tensor([0, 1, 333, T, T + 5], dtype=torch.int32,
                          device=DEVICE)
    dec_hds = (8, 32, 40, 64, 80, 128, 136, 256)
    dec_heads = ((4, 4), (8, 2), (8, 1), (12, 1), (40, 1))  # G 1 to 40
    for hd in dec_hds:
        for H, KV in dec_heads:
            for dtype in (torch.float32, torch.bfloat16):
                q = randn(5, H, hd, dtype=dtype)
                k = randn(5, KV, T, hd, dtype=dtype)
                v = randn(5, KV, T, hd, dtype=dtype)
                before = decode_attention.LAUNCHES
                out = ops.decode_attention(q, k, v, length)
                label = f"decode H={H} KV={KV} hd={hd} {dtype}"
                if decode_attention.LAUNCHES != before + 1:
                    fail(f"{label}: {decode_attention.LAUNCHES - before} "
                         f"launches counted")
                if (out[0] != 0).any():
                    fail("decode_attention: length 0 must give zeros")
                errs["decode_attention"] = max(
                    errs["decode_attention"], close_enough(
                        torch, label, out,
                        ref.decode_attention_ref(q, k, v, length),
                        ATTN_TOL[str(dtype).split(".")[1]]))
                n_dec += 1
    say(f"[8 edge] decode_attention: {n_dec} cases (hd "
        + ", ".join(map(str, dec_hds)) + "; "
        + ", ".join(str(H // KV) for H, KV in dec_heads)
        + f" q heads a kv head; float32 and bfloat16; lengths 0, 1, 333, "
        f"T = {T} and T + 5) agree with the plain version (max abs err "
        f"{errs['decode_attention']:.3g}); bfloat16 outputs bit-equal: "
        f"{min_share('decode')}; length 0 gives zeros; one launch a call")
    # every path of the kernel, whatever decode_plan picks: one split or
    # many (combined by a row's last block), ragged splits and tiles, 1 to
    # 8 heads a block, 4 or 8 warps (``launch``, which counts nothing)
    forced = ((8, 8, 10000, 4), (8, 8, 32, 4), (4, 8, 37, 4),
              (1, 16, 100, 4), (2, 8, 3, 4), (8, 2, 13, 4), (8, 8, 100, 8),
              (4, 8, 10000, 8))
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(5, 8, 64, dtype=dtype)
        k = randn(5, 1, T, 64, dtype=dtype)
        v = randn(5, 1, T, 64, dtype=dtype)
        want = ref.decode_attention_ref(q, k, v, length)
        item = q.element_size()
        for heads, tile, split, warps in forced:
            if item == 2:    # the tensor-core kernel: 8 heads, 16-key blocks
                heads, tile = 8, 16 * max(1, tile // 8)
            sk = decode_attention.score_keys(64, heads, item)
            plan = decode_attention.make_plan(
                5, 8, 1, T, 64, dtype, heads=heads,
                tile=max(sk, tile // sk * sk), split=split, warps=warps)
            out = torch.empty_like(q)
            decode_attention.launch(q, k, v, length, out, plan)
            errs["decode_attention"] = max(
                errs["decode_attention"], close_enough(
                    torch, f"decode forced plan {plan} {dtype}", out, want,
                    ATTN_TOL[str(dtype).split(".")[1]]))
    say(f"[8 edge] decode_attention: {len(forced)} forced plans x 2 dtypes "
        f"(one split, 1 to 234 splits, splits of 3, 13 and 37 keys, float32 "
        f"blocks of 1 to 8 heads, bfloat16 tiles of 16 or 32 keys, 4 or 8 "
        f"warps) agree with the plain version at "
        f"B=5 H=8 KV=1 T={T} hd=64; bfloat16 bit-equal "
        f"{min_share('decode forced')}; decode plans: "
        + ", ".join(f"hd{hd} G{G} {dt_name} "
                    f"{decode_attention.decode_plan(5, G, 1, T, hd, dt, n_sms)}"
                    for hd, G in ((64, 8), (80, 1), (256, 40))
                    for dt, dt_name in ((torch.float32, 'fp32'),
                                        (torch.bfloat16, 'bf16'))))

    def scan_plan(B, L, D, N):
        return mamba_scan.scan_plan(B, L, D, N, n_sms)

    def chunk_at(B, D, N):
        """The chunk of the plan at an L equal to that chunk."""
        T = scan_plan(B, 4097, D, N).chunk
        while scan_plan(B, T, D, N).chunk != T:
            T = scan_plan(B, T, D, N).chunk
        return T

    # (B, L, D, N, inputs): the state sizes, L around the plan's chunk at
    # ragged D, a batch past the old grid limit, A = 0, dt = 0
    scan_cases = [(2, 300, 200, 4, ""), (2, 300, 200, 8, ""),
                  (2, 300, 200, 16, ""), (1, 33, 64, 16, "")]
    scan_cases += [(2, 300, 65, N, "") for N in (1, 3, 4, 8, 16, 17, 64, 300)]
    for D in (1, 63, 65):
        T = chunk_at(2, D, 16)
        scan_cases += [(2, L, D, 16, "") for L in (1, T - 1, T, T + 1, 4097)]
    scan_cases += [(65536, 1, 1, 1, ""), (1, 4096, 64, 16, "A=0"),
                   (2, 300, 65, 16, "dt=0")]
    n_seg = n_tiled = 0
    lanes = set()
    for B, L, D, N, inputs in scan_cases:
        args, _ = kernels_bench.make_inputs(
            "mamba_scan", dict(B=B, L=L, D=D, N=N), DEVICE, seed=L + N)
        if inputs == "A=0":
            args = args[:4] + (torch.zeros_like(args[4]),)
        elif inputs == "dt=0":
            args = (args[0], torch.zeros_like(args[1])) + args[2:]
        before = mamba_scan.LAUNCHES
        got = ops.mamba_scan(*args)
        plan = scan_plan(B, L, D, N)
        label = f"mamba_scan B={B} L={L} D={D} N={N} {inputs} (plan {plan})"
        if mamba_scan.LAUNCHES != before + 1:
            fail(f"{label}: {mamba_scan.LAUNCHES - before} launches counted")
        if inputs == "dt=0" and (got != 0).any():
            fail(f"{label}: dt = 0 must give y = 0")
        errs["mamba_scan"] = max(errs["mamba_scan"], close_enough(
            torch, label, got, kernels_bench.plain("mamba_scan")(*args),
            SCAN_TOL))
        n_seg += plan.segments > 1
        n_tiled += plan.tiles > 1
        lanes.add(plan.nl)
    say(f"[8 edge] mamba_scan: {len(scan_cases)} cases (N = 1, 3, 4, 8, 16, "
        f"17, 64, 300; L = 1, chunk - 1, chunk, chunk + 1, 4,097 at D = 1, "
        f"63, 65; B = 65,536; A = 0 over 4,096 steps; dt = 0 gives 0) agree "
        f"with the plain version (max abs err {errs['mamba_scan']:.3g}); "
        f"{n_seg} cases segmented, {n_tiled} with the state axis tiled, "
        f"lanes a channel {sorted(lanes)}")
    # every path of the kernel, whatever the plan picks: 1 to 32 lanes a
    # channel, 1, 4 or 8 entries a lane, several chunks a segment,
    # segments, a tiled state axis (``launch``, which counts nothing)
    args, _ = kernels_bench.make_inputs(
        "mamba_scan", dict(B=2, L=333, D=45, N=17), DEVICE, seed=17)
    want, want_h = ref.mamba_scan_ref(
        *args, torch.zeros((2, 45, 17), device=DEVICE))
    forced = ((1, 1, 1, 8, 1), (4, 8, 4, 64, 1), (4, 8, 4, 16, 3),
              (2, 4, 8, 8, 1), (8, 1, 2, 24, 5), (32, 1, 8, 8, 1),
              (16, 4, 1, 64, 2), (1, 8, 1, 32, 1))
    for nl, eg, warps, chunk, segments in forced:
        plan = mamba_scan.make_plan(2, 333, 45, 17, nl=nl, eg=eg,
                                    warps=warps, chunk=chunk,
                                    segments=segments)
        got = torch.empty_like(args[0])
        got_h = torch.empty_like(want_h)
        mamba_scan.launch(*args, got, plan, h=got_h)
        label = f"mamba_scan B=2 L=333 D=45 N=17 plan {plan}"
        errs["mamba_scan"] = max(
            errs["mamba_scan"],
            close_enough(torch, label, got, want, SCAN_TOL),
            close_enough(torch, f"{label} h_L", got_h, want_h, SCAN_TOL))
    say(f"[8 edge] mamba_scan: {len(forced)} forced plans (1 to 32 lanes a "
        f"channel, 1, 4 or 8 entries a lane, 1 to 17 tiles, 1 to 5 "
        f"segments) agree with the plain version at B=2 L=333 D=45 N=17, "
        f"y and the end state h_L")
    if not n_seg or not n_tiled or 1 not in lanes:
        fail("the scan's edge cases must reach a segmented plan, a tiled "
             "state axis and a plan of one lane a channel")

    # -- phase 9: the kernel benchmark path -------------------------------
    counters = {"reid_topk": (reid_topk, "UNMASKED_LAUNCHES"),
                "flash_attention": (flash_attention, "LAUNCHES"),
                "decode_attention": (decode_attention, "LAUNCHES"),
                "mamba_scan": (mamba_scan, "LAUNCHES")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    reid_topk.LAUNCHES = reid_topk.TILE_LAUNCHES = 0
    record = {}
    t0 = time.perf_counter()
    try:
        rows = kernels_bench.run(device=DEVICE, record=record)
    finally:
        bench_launches = {name: getattr(mod, attr)
                          for name, (mod, attr) in counters.items()}
        stray = (reid_topk.LAUNCHES, reid_topk.TILE_LAUNCHES)
    say(f"[9 bench] kernels_bench.run(device='cuda') in "
        f"{time.perf_counter() - t0:.1f} s:")
    say("  name,us_per_call,derived")
    bench = {}
    for row_name, us, derived in rows:
        say(f"  {row_name},{us:.1f},{derived}")
        name = row_name.split("/", 1)[1]
        fields = dict(f.split("=") for f in derived.split(";"))
        calls = int(fields["calls"])
        if bench_launches[name] != calls or calls == 0:
            fail(f"{name}: {bench_launches[name]} launches, but the "
                 f"benchmark made {calls} calls")
        args, kwargs, out = record[name]
        errs[name] = max(errs[name], hold_output(
            torch, name, f"bench {name}", args, kwargs, out,
            SCAN_TOL if name == "mamba_scan" else ATTN_TOL["float32"]))
        b_ms, b_by = kernels_bench.bound_ms(
            *kernels_bench.cost(name, args, kwargs),
            kernels_bench.peak_flops(name, args))
        lib = library_yardstick(torch, name, args, kwargs)
        bench[name] = dict(
            ms=us / 1e3, plain_ms=float(fields["plain_us"]) / 1e3,
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if lib is None else device_ms(lib),
            shape=kernels_bench.SHAPES[name])
        if name == "mamba_scan":
            bench[name]["shape"] = dict(bench[name]["shape"], plan=str(
                scan_plan(*args[0].shape, args[2].shape[2])))
        if name == "decode_attention":
            parts = decode_parts(torch, decode_attention, args, n_sms)
            bench[name].update(
                library_gqa_ms=device_ms(decode_gqa_yardstick(torch, args)),
                **{key: parts[key] for key in ("partial_ms", "combine_ms")})
            bench[name]["shape"] = dict(bench[name]["shape"],
                                        plan=parts["plan"])
            decode_line = f"; {parts_text(parts)}"
        if name == "reid_topk":
            bench[name]["shape"] = dict(bench[name]["shape"], plan=plan_of(
                args[0].shape[0], args[1].shape[0]))
            if reid_topk.split_plan(args[0].shape[0], args[1].shape[0],
                                    n_sms)[1] < 2:
                fail("the benchmark's re-id shape does not split the gallery")
    if stray != (0, 0):
        fail(f"the benchmark launched the serving kernels {stray} times")
    say("[9 bench] launches " + ", ".join(
        f"{n} {c}" for n, c in bench_launches.items())
        + " (= the benchmark's calls); every output agrees with its plain "
        "version; per call at the benchmark's shapes:")
    for name, t in bench.items():
        lib_ms = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        if "library_gqa_ms" in t:
            lib_ms += f" (with enable_gqa {t['library_gqa_ms']:.4f} ms)"
        plan = t["shape"].get("plan")
        say(f"  {name}: " + (f"plan {plan}; " if plan else "")
            + f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, library {lib_ms}, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})"
            + (decode_line if name == "decode_attention" else ""))
    del record

    # -- phase 10: the kernels at model widths ----------------------------
    widths = {name: [] for name in BENCH}
    for name, label, shape, dtype in MODEL_SHAPES:
        t0 = time.perf_counter()
        args, kwargs = kernels_bench.make_inputs(name, shape, DEVICE, seed=1)
        if dtype == "bfloat16":
            args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                         for a in args)
        op, base = getattr(ops, name), kernels_bench.plain(name)
        tag = f"{name} {label} {dtype} {shape}"
        tol = ATTN_TOL[dtype] if dtype == "bfloat16" else MODEL_TOL
        out = op(*args, **kwargs)
        if name == "decode_attention":
            # the plain version holds 8 rows at a time: its float32 copies
            # of a bfloat16 cache at batch 128 would take 17 GB
            err, shares = 0.0, []
            for b0 in range(0, shape["B"], HOLD_ROWS):
                err = max(err, hold_output(
                    torch, name, f"{tag} rows {b0}:{b0 + HOLD_ROWS}",
                    tuple(a[b0:b0 + HOLD_ROWS] for a in args), kwargs,
                    out[b0:b0 + HOLD_ROWS], tol))
                if dtype == "bfloat16":
                    shares.append(BF16_SHARES[-1][1])
            if shares:
                BF16_SHARES.append((tag, min(shares)))
        else:
            err = hold_output(torch, name, tag, args, kwargs, out, tol)
        del out
        errs[name] = max(errs[name], err)
        b_ms, b_by = kernels_bench.bound_ms(
            *kernels_bench.cost(name, args, kwargs),
            kernels_bench.peak_flops(name, args))
        lib = library_yardstick(torch, name, args, kwargs)
        t = dict(shape, label=label, dtype=dtype,
                 ms=device_ms(lambda: op(*args, **kwargs)),
                 plain_ms=device_ms(lambda: base(*args, **kwargs), calls=1,
                                    replays=3),
                 library_ms=None if lib is None else device_ms(lib),
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        if name == "reid_topk":
            t["plan"] = plan_of(shape["Q"], shape["G"])
        if name == "mamba_scan":
            t["plan"] = str(scan_plan(
                shape["B"], shape["L"], shape["D"], shape["N"]))
        if name == "flash_attention":
            t["plan"] = str(flash_attention.flash_plan(shape["hd"],
                                                       args[0].dtype))
        if name in ("flash_attention", "decode_attention") and \
                dtype == "bfloat16":
            t["bf16_share"] = BF16_SHARES[-1][1]
        parts = ""
        if name == "decode_attention":
            d = decode_parts(torch, decode_attention, args, n_sms)
            t.update(plan=d["plan"], partial_ms=d["partial_ms"],
                     combine_ms=d["combine_ms"])
            parts = f"; {parts_text(d)}"
            if shape["B"] <= HOLD_ROWS:
                t["library_gqa_ms"] = device_ms(decode_gqa_yardstick(torch,
                                                                     args))
                parts += (f"; library with enable_gqa "
                          f"{t['library_gqa_ms']:.4f} ms")
        widths[name].append(t)
        lib_ms = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        say(f"[10 model] {tag}: agrees (max abs err {err:.3g}"
            + (f", bfloat16 bit-equal {t['bf16_share']:.4f}"
               if "bf16_share" in t else "") + "); "
            + (f"plan {t['plan']}; " if "plan" in t else "")
            + f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {lib_ms}, bound {b_ms:.6f} ms ({b_by}){parts}; "
            f"{time.perf_counter() - t0:.1f} s")
        del args, kwargs, lib
        torch.cuda.empty_cache()
    end_state = scan_end_state(torch, errs)

    # -- phase 11: the batched tracker ----------------------------------
    phase_tracker(np, qs_rerun)

    # -- phase 12: identity detection ------------------------------------
    phase_detection(detect_rerun)

    # -- phase 13: recalibration ------------------------------------------
    recal_launches = phase_recalibration(np, torch, recorder,
                                         (camera, tiles), max_err,
                                         recal_reruns)

    # -- phase 14: the serving fleet ----------------------------------------
    def serve_stream(model_key, trace, ticks, on_step, **serve_kw):
        m = model if model_key == "camera" else tile_model
        eng = api.serve(m, lambda x: x, policy,
                        geo_adj=world.net.geo_adjacent, topk=3,
                        consolidate=True, device=DEVICE,
                        tile_grid=TILE_GRID if model_key == "tiles" else 0,
                        **serve_kw)
        return eng, run_stream(eng, world, ticks or horizon_ticks, trace,
                               on_step)

    fleet = phase_fleet(np, torch, serve_stream, singles, recorder,
                        (camera, tiles), max_err)

    # -- phase 15: the benchmark suite --------------------------------------
    suite = phase_suite(torch, recorder, (camera, tiles), max_err,
                            suite_reruns)
    # -- phase 16: the dense zoo's serving path ------------------------------
    zoo = phase_zoo(torch, np, errs)
    # -- phase 17: the Mamba1 zoo's serving path ---------------------------
    zoo["mamba_scan"] = dict(phase_ssm_zoo(torch, np, errs),
                             end_state=end_state)
    # -- phase 18: the hybrid zoo's serving path ---------------------------
    hybrid = phase_hybrid_zoo(torch, np, errs)
    # -- phase 19: the MoE zoo's serving path ------------------------------
    moe_zoo = phase_moe_zoo(torch, np, errs)
    camera_row["max_abs_err"] = max_err[CAMERA["name"]]
    tiles_row["max_abs_err"] = max_err[TILES["name"]]

    say(smi)
    say(json.dumps({"kernels": [
        dict(CAMERA, **camera_row, recal_launches={
            k: recal_launches[k] for k in ("drift_sweep", "soak_130")},
             fleet_launches=fleet["camera"],
             suite_launches=suite["camera"]),
        dict(TILES, **tiles_row,
             recal_launches={"tile drift": recal_launches["tile drift"]},
             fleet_launches=fleet["tiles"],
             suite_launches=suite["tiles"])]
        + [dict(BENCH[name], launches=bench_launches[name],
                max_abs_err=errs[name], **bench[name], model=widths[name],
                **({"zoo": zoo[name]} if name in zoo else {}),
                **({"zoo_hybrid": hybrid[name]} if name in hybrid else {}),
                **({"zoo_moe": moe_zoo[name]} if name in moe_zoo else {}))
           for name in BENCH]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if CPU_POOL is not None:
            CPU_POOL.terminate()
            CPU_POOL.join()
    sys.exit(code)
