"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  Phases, each printing one JSON line, any
failure raising (exit code != 0):

1. device — the card, as ``nvidia-smi`` names it, and its power limit;
2. build — compiles every CUDA source of the port with ``nvcc`` (one
   process per library, started together), with each kernel's registers
   and spills, the flash kernels' dynamic shared memory and their count of
   tensor-core (HMMA) instructions in the SASS (``cuobjdump -sass``): the
   bf16 prefill kernel must have some, and no spills at D <= 128, nor any
   flash kernel at the examples' D = 8 and 12 (either dtype); the same
   for B6's kernels (its two bf16 product kernels must have HMMA
   instructions, and none of its bf16 route may spill) and their dynamic
   shared memory;
3. kernel vs plain — B1 and B2 at full width (paper-3tier, R=1024) on
   seeded inputs shaped like a real model cache, against their plain
   PyTorch versions on the same inputs on the card;
4. small slice — the fused ``Experiment(R=4, T=30)`` on the card and on the
   CPU with the same draws: actions equal, metrics within 1e-4;
5. the slice — ``repro_torch.api.run(Experiment(router="aif",
   scenario="paper-burst", n_cells=1024, n_windows=300))`` on the card, with
   every kernel's launch count read around it;
   then the per-call times of the held-tick posterior and the slow step on
   its final state;
6. mega kernel vs plain — B3 (one whole window) at R=1024 and full width
   from a mid-run state (t0=100), float32 and bfloat16 slots on
   paper-burst (both then timed) and float32 slots on the two
   masked-telemetry scenarios, against its plain version
   ``core.mega.mega_window`` on the same inputs on the card;
7. mega small slice — ``Experiment(mega=True, R=4, T=23)`` on the card and
   on the CPU with the same draws: actions equal;
8. mega slice — ``Experiment(mega=True, n_cells=4096, n_windows=300)`` on
   paper-burst, every kernel's launch count read around it (B3: one launch
   per window, 30); then the per-call times of its slow step and watchdog;
9. table1 small — ``compare(table1_grid(n_cells=4, n_windows=30,
   seed=1))``, the AIF rows fused and then unfused, on the card and on the
   CPU with the same draws: actions equal in all 16 rows, success/P50/P95
   within 1e-4 relative;
10. table1 — the grid at R=1024 x T=300 (8 routers x paper-burst and
   flaky-telemetry), every kernel's count read around each row (each AIF
   row: B1 60 times and nothing else; each baseline row: no launch), each
   row's wall and metrics, then the markdown table; then
   ``Experiment(router="aif", fused=False)`` on paper-burst at the same
   size (plain PyTorch: no launch), with its wall; then the device time of
   one uniform, Thompson, fused and unfused AIF run at R=1024 x T=50
   beside its wall (``torch.profiler``);
11. hetero — B1 against its plain version at the continuum-5tier widths
   (R=1024, S=128, A=37), then ``hetero_fleet_rollout`` over a paper-3tier
   and a continuum-5tier group, fused, R=1024 each, T=300, B1's launches
   read for each group (60 each);
12. chaos — each of the five chaos presets at R=1024 x T=300 with fused
   AIF, its recovery metrics (against the control run on paper-burst,
   whose B1 launches are counted with it) finite;
13. resume — at R=32 x T=300, ``checkpoint_every=100`` into a temporary
   directory, then ``resume_from`` it: the final carry and n_success equal
   the uninterrupted run's to the bit, per-tick (zone-outage, B1) and mega
   (paper-burst, B3); with the checkpoint's size and the seconds to
   restore and to write one; the directory is deleted;
14. graph kernel vs plain — B1 at the graph worlds' widths (the paper's
   testbed with the neighbor-pressure modality: R=1024, S=243, A=20, M=5),
   unmasked and masked, against its plain version, each launched twice with
   the two outputs equal to the bit;
15. graph small — ``Experiment(scenario="ring-spillover", n_cells=6,
   n_windows=30)`` on the card and on the CPU with the same draws: actions
   equal, success/P50/P95/offload within 1e-4 relative;
16. graph — ``Experiment(router="aif", scenario="ring-spillover",
   n_cells=1024, n_windows=300)``, fused, with every kernel's count read
   around it (B1: 60), beside its ``graph="none"`` control on the same
   schedules; the graphed run again through the engine with the same
   draws, equal to the bit (the spillover's per-cell sums have no
   atomics), and fleet mass conserved on that run's final state; then
   ``grid-hotspot`` and ``hier-continuum`` at R=256;
17. warm kernel vs plain — a fused per-tick run at R=1024 stopped at
   t=150 and promoted onto the mega path (its dense transition counts
   become B3's ``b_base`` baseline): one B3 window of the warm branch
   against its plain version at the promotion and two windows later (the
   replayed slots then carry weight too), the first launched twice with
   the outputs equal to the bit, then timed beside its bound;
18. warm — from that state, 150 more ticks on the mega path (15 B3
   launches, counted) and, on the same draws, 150 on the per-tick path
   (30 B1 launches): the count of differing actions; then a small warm run
   (R=4) on the card against the CPU: actions equal;
19. mega chaos kernel vs plain — B3 on chaos windows at R=4096 from the
   mega path's own states: zone-outage's and straggler-storm's schedules
   at t0=150 and zone-outage at t0=120 (inside its outage), each against
   its plain version ``core.mega.mega_window`` within MEGA_TOL and
   launched twice with the outputs equal to the bit; straggler-storm's
   window timed beside its plain version and its bound;
20. mega graph kernel vs plain — the same on a ring-spillover window
   (M=5, every ``spill_*`` field and the neighbor pressure; a graph window
   is 11 launches: one a tick, and one more to publish the last tick);
21. mega chaos — the five chaos presets with ``mega=True`` at R=4096 x
   T=300, each with its mega control (B3 for every window of both, 60
   launches, counted), walls, recovery metrics; and each at R=1024 on the
   per-tick and the mega path with the same draws (``TickNoise``): the
   share of actions that differ;
22. mega chaos resume — zone-outage on the mega path at R=32,
   checkpointed and resumed as in phase 13, equal to the bit;
23. mega graph — ring-spillover with ``mega=True`` at R=4096 x T=300 (330
   B3 launches, counted) beside its ``graph="none"`` mega control (30);
   the graphed run again through the engine, equal to the bit, with the
   fleet's mass balance closed; at R=1024 against the per-tick run on the
   same draws: the actions that differ, offload_frac within 1e-5;
24. shard kernel vs plain — B3 on row blocks: the R=4096 mega path's
   state at t0=150 cut into 4 blocks of 1024 on the card, on a fresh
   (paper-burst), a zone-outage and a ring-spillover window (M=5, the
   blocks' 44 launches interleaved over a shared exchange buffer indexed
   by global row), each block within MEGA_TOL of its plain version with
   the same row block (``core.mega.mega_window_blocks``), launched twice
   with the outputs equal to the bit, the blocks put together equal to the
   bit to the unsharded B3 window; then R=4093 padded to 4096 on
   ring-spillover from the sharded run's own state, its phantom rows
   inert; one block of the fresh window timed;
25. shard small — the sharded engine at R=7 over 4 shards (padded to 8),
   T=30, fused AIF, mega AIF and least_loaded, on the card against the CPU
   with the same draws: the final carry's integers equal, its floats and
   the metrics within 1e-4;
26. shard — ``Experiment(shard=ShardSpec(devices=1))`` mega at R=4096 x
   T=300 and fused at R=1024 x T=300 on paper-burst against the unsharded
   runs: final carry and env state equal to the bit, metrics within 1e-5,
   walls side by side; then the mega experiment and ring-spillover on 4
   shards laid on the card (B3: 4 x 30 and 4 x 330 launches) and the fused
   one (B1: 4 x 60), metrics within 1e-4 of the unsharded runs;
27. shard resume — zone-outage on the mega path at R=256 over 4 shards,
   checkpointed every 100 windows and resumed: carry, env state and
   metrics equal to the bit; the engine in two chunks against one piece:
   carry and the reducer's stats equal to the bit;
28. mega fleet — the reference's acceptance workload,
   ``Experiment(router="least_loaded", n_cells=1_000_000, n_windows=25,
   shard="auto")``, beside the unsharded engine's rollout of the same world:
   wall_s, cell-windows/s and peak device memory of each;
29. attention kernel vs plain — B4 (flash prefill) and B5 (flash decode)
   against their plain versions ``mha_ref``/``decode_ref`` on the card:
   internlm2-1.8b's heads (Hq=16, Hkv=8, D=128) at b=1, Sq=Skv=1024 causal
   in bf16 and f32, a chunked prefill (q_offset > 0, ragged Sq), gemma3-1b's
   heads (Hq=4, Hkv=1, D=256) with window 512, B5 at B=8, S=2048 with
   ragged positions that include 0 and S-1 in bf16 and f32,
   mixtral-8x7b's heads (Hq=32, Hkv=8, D=128) past its 4096-token window
   (B4 at Sq=Skv=8192; B5 at B=8 over 8192 slots with positions on both
   sides of 4096), seamless-m4t-medium's (16/16, D=64) unmasked with Sq !=
   Skv allowed (B4 for its encoder at b=8, 1024 x 1024, and its
   cross-attention, 16 x 1024; B5 over the cross cache at position 1023)
   and causal for its decoder (B4 at b=8, 16 x 16; B5 at b=8 over 80
   slots), jamba-1.5-large's (Hq=64, Hkv=8, D=128: B4 at b=1, Sq=Skv=1024
   causal; B5 at B=8 over 2048 slots with positions 0 and S-1 among
   them), the other head dims (16, 32, 64) at small shapes, and D = 8 and
   12 (the multitier example's light and medium tiers, 4/2 heads) in bf16
   and f32 at that example's shapes (a 16-token prompt in its 16-token
   bucket; decode waves of 2 and 3 over 64 slots) and at ragged, windowed
   and q_offset shapes; each case
   launched twice, the two outputs equal to the bit; then each kernel
   against the plain model
   of its algebra (``ref.decode_split_model`` at the wrapper's chunk: f32
   within 1e-6; bf16 B4 and B5 within one bf16 ulp of their model, B4
   closer to ``ref.prefill_two_half_model`` than to the model that drops
   p_lo);
30. serve small — internlm2-1.8b's widths at 2 layers in f32, one
   ``ServingEngine`` on the card and one on the CPU with the same weights
   (drawn once on the card, copied to the host), 4 prompts of 64 tokens,
   8 new tokens each: tokens equal, the logits of the first prompt's
   prefill and of one decode step after it within 1e-4 relative, the
   kernels launched as expected;
31. serve — ``ServingEngine(get_arch("internlm2-1.8b").full, max_batch=8,
   max_len=2048)`` in bf16, all 24 layers, answering 8 requests of
   1000-1024 prompt tokens with 64 new tokens each, every kernel's count
   read around it (B4: 24 per request, B5: 24 per decode wave);
32. multitier — ``MultiTierServer`` with the port's ``AifRouter`` over three
   engines sharing the serve phase's weights (max_batch 2/3/8,
   steps_per_tick 1/1/3, max_len 512), 60 ticks at 4 arrivals per tick of
   128-token prompts with 16 new tokens, counts read around it;
33. event small — the port's ``AifRouter`` on the paper's event simulator
   (``SimConfig()``, 50 RPS), 300 control windows on the card and on the
   CPU, both fed one host generator's draws: the action traces and the
   two ``RunResult``s equal field by field; a flip passes only at a
   near-tie (the two actions' scores within 1e-4 |G|, printed with its
   window), and comparing stops there; no kernel launched (the
   single-agent tick is plain PyTorch);
34. event table1 — the paper's Table-1 protocol at CI speed
   (``tools/event_table1.py``): ``evaluate_strategy`` with 3 runs x 600 s
   for aif, uniform, capacity, round_robin, least_loaded, thompson and ucb,
   AIF's tick on the card; the table, the Δ(AIF−Base) line beside the
   paper's, each strategy's wall; then AIF's first run again window by
   window (equal to it) with the host ms of the snapshot, the tick, the
   weights' copy back and the world's window, the tick's device ms from a
   profiler trace of 100 windows, and the card's idle share;
35. times — each kernel's ms per launch (CUDA events around one
   synchronized call, warmed up, median) and its device ms (30 calls
   queued back to back behind a busy-wait, so the host's cost per call
   stays off the clock) beside its bound and its plain version's ms; B3 at the mega slice's
   R=4096 from its states at window starts t0 = 0, 150 and 290, each
   first held against its plain version like phase 6 (the kernels line
   reports t0=150); B4 and B5 at the serve phase's shapes beside
   ``scaled_dot_product_attention``'s time on the same inputs (a yardstick
   the port never calls), and B5 at the multitier phase's shapes (B = 2,
   3, 8 over S=512), each with the blocks its launch puts to work; B1
   also at the hetero phase's 5-tier widths and at the graph phase's M=5
   (its own row of the kernels line, as B3's warm branch from phase 17
   and B3 on chaos and graph windows from phases 19-20 and on row blocks
   from phase 24);
36. ssd kernel vs plain — B6 (the SSD chunked scan) against its plain
   version ``kernels/ssd/ref.py::ssd_chunked`` on the card: mamba2-2.7b's
   widths (H=80, P=64, G=1, N=128, Q=256) at b=1, S=1024 in bf16 and f32,
   at the mamba serve-small phase's S=64, a ragged S=1000 and a short
   S=80 (under one chunk) with an initial state, b=2, G=2 at small
   widths, and jamba-1.5-large's widths (H=256, P=64, G=1, N=128, Q=256)
   at b=1, S=1024; y within 1e-4 (f32) / 3e-2 (bf16) of max(1, |y|), the state
   within 10x that; each case launched twice, the two outputs equal to the
   bit; the bf16 cases (the chunk-parallel tensor-core route) also within
   one bf16 ulp + 1e-5 max(1, |y|) of ``ref.ssd_chunk_parallel_model``,
   the plain model of that route's algebra, and closer to it than to the
   model that drops the lo halves;
37. mamba serve small — mamba2-2.7b's widths at 2 layers in f32, one
   ``ServingEngine`` on the card and one on the CPU with the same weights,
   4 prompts of 37-64 tokens (right-padded to the 64-token bucket), 8 new
   tokens each, checked as in phase 30 (B6: 2 per admission);
38. mamba serve — ``ServingEngine(get_arch("mamba2-2.7b").full,
   max_batch=8, max_len=2048)`` in bf16, all 64 layers, answering 8
   requests of 1000-1024 prompt tokens with 32 new tokens each, every
   kernel's count read around it (B6: 64 per request), then one prefill's
   and one decode wave's host and device time; the weights are freed
   after it;
39. ssd times — B6 at the mamba serve phase's prefill shape (b=1, S=1024,
   bf16) beside its bound and its plain version's ms;
40. moe serve small — mixtral-8x7b's widths (8 experts, top-2) at 2
   layers in f32, checked as in phase 30;
41. moe serve — ``ServingEngine(mixtral-8x7b cut to 16 of its 32 layers,
   max_batch=8, max_len=8192)`` in bf16, answering 8 requests of
   4200-5000 prompt tokens with 32 new tokens each, past the 4096-token
   window in every prefill and decode wave, every kernel's count read
   around it (B4: 16 per request, B5: 16 per decode wave), wall, tokens/s,
   peak memory, then one prefill's and one decode wave's host and device
   time; the weights are freed after it;
42. encdec small — seamless-m4t-medium's widths at 2 encoder + 2 decoder
   layers in f32, the card's model against the CPU's with the same
   weights (2 sources of 200 frames, an 8-token prefix, 8 greedy steps):
   tokens equal, every step's logits within 1e-4 relative, the kernels
   launched as expected;
43. encdec — seamless-m4t-medium whole (12 + 12 layers, bf16): 8 sources
   of 1024 frame embeddings, a 16-token prefix and 64 greedy decode steps
   through ``prefill`` and ``decode_step`` (B4: 36, B5: 1536, counted),
   wall, tokens/s, peak memory, then one prefill's and one step's host and
   device time;
44. moe/encdec attention times — B4 and B5 at the shapes of phases 41 and
   43 (mixtral's windowed prefill at the 8192 bucket and its decode wave;
   seamless's encoder, cross prefill, self and cross decode) beside their
   plain versions (each within ATTN_TOL of it, or the phase fails) and
   SDPA, under ``moe_encdec_shapes`` in B4's and B5's
   rows of the kernels line with the launches those phases counted;
45. train small — the training path (``make_train_step``: AdamW,
   Adafactor, ``accum_steps=2``, ``int8_ef``) for 3 steps on the card and
   on the CPU from the same weights and batches, in float32 (TF32 off), on
   the reference tests' TINY and the internlm2, mixtral, mamba2, seamless
   and jamba (hybrid) smoke configs: loss, aux and gradient norm within 1e-4
   relative, parameters within rtol 1e-4 / atol 1e-5; then TINY trained
   for 50 steps through ``Trainer`` on the card (the last 5 losses under
   0.7 of the first 5); then ``run_with_restarts`` preempted at step 25
   against the uninterrupted run, parameters within 1e-5, whether they are
   equal to the bit and which ops ``torch.use_deterministic_algorithms``
   names as nondeterministic in a step; no kernel launched throughout;
46. train — internlm2-1.8b at its published widths and depth (bf16
   parameters, AdamW with a float32 master and moments) trained through
   ``Trainer.run`` for 4 steps at sequence 4096, global batch 8 as 4
   microbatches of 2: every loss and gradient norm finite, lr equal to the
   schedule, every parameter's master moved, no kernel launched; each
   step's wall ms, tokens/s, peak memory and model FLOP utilization, then
   one more step's device ms and top device ops under ``torch.profiler``,
   with the card's idle share of an unprofiled step (the profiler slows
   the host, not the card);
47. jamba serve small — jamba-1.5-large's widths at 2 layers
   (``mamba_mlp``, ``mamba_moe``) in f32, 48.6 GB a side, checked as in
   phase 30 (B6: 2 per admission), with the card's peak memory and the
   host's available memory and peak resident set beside it;
48. jamba serve small dense — phase 47 again on the same weights with
   the MoE's dense switch (``moe.DENSE_MODE_MAX_TOKENS``) set to 4 on
   both sides for this run only: every decode step's MoE takes
   ``Moe.dense`` (its calls counted, one per decode step a side), each
   64-token prefill the capacity dispatch, under the same bars;
49. jamba serve — ``ServingEngine(jamba-1.5-large cut to its first 4 of
   72 layers, max_batch=8, max_len=2048)`` in bf16 (46.5 GB of weights;
   the first attention layer is layer 7, and 8 layers do not fit one
   card), answering 8 requests of 1000-1024 prompt tokens with 32 new
   tokens each, every kernel's count read around it (B6: 4 per request,
   B4 and B5: none), wall, tokens/s, peak memory, then one prefill's and
   one decode wave's host and device time with the top device kernels
   and the card's idle share; the weights are freed after it;
50. jamba times — B4 and B5 at jamba's attention widths (b=1 1024 x 1024
   causal; B=8 over 2048 slots at the jamba serve prompts' lengths + 31)
   beside their plain versions and SDPA, and B6 at its Mamba widths
   (b=1, S=1024, H=256) beside its plain version, under ``jamba_shape`` in
   the B4, B5 and B6 rows of the kernels line with phase 49's launches;
51. dryrun — the dry run (``repro_torch.launch.dryrun``) of every (arch x
   shape x mesh) cell the registry's ``cells()`` yield, on the ``meta``
   device against the (16, 16) and (2, 16, 16) meshes, 6 records at a
   time in spawned processes: one line per cell (per-card argument and
   temporary GB, FLOPs, the compute, memory and collective terms on H100
   cards and the dominant one); it raises if a cell fails.  In the same
   pool, phase 52's three runs counted on ``meta`` at mesh (1, 1); phase
   52's work on the card runs in this process meanwhile;
52. dryrun card — that accounting held to internlm2-1.8b whole on the card
   at mesh (1, 1), with the serve phase's weights (seed 0): the argument
   bytes of the parameters, of the caches of a decode wave (B=8 over 2048
   slots) and of the AdamW state predicted against the growth of
   ``torch.cuda.memory_allocated()`` as each is placed (within 1 %); a
   prefill of 8 x 1024 tokens, that decode wave and phase 46's train step
   (4 microbatches of 2 x 4096) each run once more under
   ``op_cost.FlopCount``: the aten FLOPs plus the kernels' launches
   (equal to the meta count's) times their FLOPs a launch equal the meta
   count exactly; the predicted temporary bytes against the card's peak
   less its allocation, and max(compute, memory) against the measured
   device ms (prefill and decode from a ``torch.profiler`` trace here,
   the train step's from phase 46's profile), as reported ratios; then every parameter distributed
   on the one-rank ``make_debug_mesh(1, 1)`` by ``to_placements``, its
   local shape equal to ``shard_shape``, and the process group destroyed;
53. examples — the port's nine examples (``examples/*_torch.py``) at
   their default sizes on the card, one after another in one subprocess
   with its own temporary directory, each under its own timeout: each
   one's wall, its headline lines (success, P50,
   completions, loss, parameter divergence) and every kernel's launches
   read around its ``main()``, which must include the kernels its path
   runs (B1 for the four fleet examples, B4 and B5 for serve_multitier, at
   D = 8, 12 and 16) and no other; a non-zero exit fails the run;
54. example attention times — B4 and B5 at serve_multitier's D = 8 and 12
   shapes in float32, beside their plain versions and SDPA, with the
   launches phase 53 counted at each head dim, under
   ``serve_multitier_shapes`` in the B4 and B5 rows of the kernels line;
55. moe dispatch — one mixtral-8x7b MoE layer at its widths in bf16,
   dropless (capacity factor 4.0 = E / k, as the benchmark's config), at
   N = 8192, 4096, 64 and 8 tokens: ``Moe.dispatch`` (the kept pairs
   packed by expert, three grouped products) against the capacity path it
   replaced (:func:`capacity_dispatch`: (E, C, D) buffers, three ``bmm``)
   within ``MOE_DISPATCH_TOL`` of max(1, |y|), every output finite; both
   timed (the whole dispatch and the experts' products alone, queued)
   beside the bound (the real pairs' operations at 989 TFLOP/s, or the
   experts' weights read once at 3.35 TB/s, whichever is longer); at a
   capacity factor of 1.0 a dispatch that drops pairs, its dropped tokens
   exactly zero; ``grouped_mm`` in float32 against float64 per group, and
   whether that call waited for the card (PyTorch's float32 route reads
   the offsets on the host).

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.

A kernel's count is its wrapper's ``launches``, except B4's and B5's in
the phases that serve through ``ServingEngine`` (30, 31, 32, 37, 38, 40,
41, 47-49 and serve_multitier in 53): there they are read from a device
trace of the run by kernel name (:func:`device_counted`), since the
engine records its decode wave once as a CUDA graph and replays it, and a
replay calls no wrapper.  Those runs' walls are taken under the trace.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate, dense fp32 rate outside the tensor
# cores and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
R_FULL, T_FULL = 1024, 300
# table1_breakdown profiles its four rows over the first 100 windows (10
# periods): reading a 300-window trace took ~35 s a row
T_BREAKDOWN = 100
R_MEGA, T0_MEGA = 4096, 150   # the mega slice's fleet; B3's timed window
T0_OUTAGE = 120               # a window inside zone-outage's outage (90-149)
DEVICE = "cuda"
G_TOL, Q_TOL = 1e-4, 1e-5     # kernel vs plain version, max abs error
# B3 vs its plain version: every float output within MEGA_TOL·max(1, |plain|)
# (absolute on probabilities, relative on the env's growing request sums)
MEGA_TOL = 1e-4
# B4/B5 vs their plain versions, max abs error: the reference's kernel bar
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# B5 in float32 against ref.decode_split_model, its algebra at the
# wrapper's chunk: the two differ only in the order of float32 sums.
MODEL_TOL_F32 = 1e-6
SERVE_ARCH = "internlm2-1.8b"
MAMBA_ARCH = "mamba2-2.7b"
MOE_ARCH = "mixtral-8x7b"
# moe_serve: mixtral-8x7b cut from 32 to 16 layers (46.4 GB of layer
# weights in bf16, 0.5 GB of embeddings, 4.3 GB of KV cache at 8 lanes of
# 8192), serving prompts past its sliding window of 4096
MOE_LAYERS, MOE_MAX_LEN, MOE_WINDOW = 16, 8192, 4096
# moe_dispatch: one mixtral-8x7b MoE layer at these token counts (a
# longdoc prefill's bucket, a code prefill's, the decode waves' lanes); the
# grouped dispatch against the capacity path within this share of
# max(1, |y|): both sum in float32 and round each product to bf16, in
# other orders
MOE_DISPATCH_TOKENS = (8192, 4096, 64, 8)
MOE_DISPATCH_TOL = 2e-2
MOE_PROMPTS = (4200, 5001)     # prompt lengths drawn from [4200, 5001)
ENCDEC_ARCH = "seamless-m4t-medium"
JAMBA_ARCH = "jamba-1.5-large-398b"
# jamba_serve: jamba-1.5-large cut to its first 4 of 72 layers (mamba_mlp,
# mamba_moe, mamba_mlp, mamba_moe: 46.5 GB of weights in bf16); its first
# attention layer is layer 7, and the first 8 layers (90.3 GB) do not fit
# one 80 GB card
JAMBA_LAYERS = 4
# jamba_serve_small's repeat with the MoE's dense switch on: decode waves
# of at most this many tokens (its 4 lanes) take Moe.dense, its 64-token
# prefill buckets the capacity dispatch
JAMBA_DENSE_MAX = 4
# encdec: 8 sources of 1024 frame embeddings, a 16-token target prefix,
# then 64 greedy decode steps
ENCDEC_B, ENCDEC_FRAMES, ENCDEC_PREFIX, ENCDEC_STEPS = 8, 1024, 16, 64
# B6 vs its plain version: y's max abs error over max(1, |y|), the state's
# below 10x that: the reference's kernel bar
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# bf16 B6 vs ref.ssd_chunk_parallel_model, the algebra of its route: one
# bf16 ulp of the model's output plus this share of max(1, |model|), a
# tenth of the float32 bar (kernel and model differ only in the order of
# their float32 sums, over terms up to ~|y|)
SSD_MODEL_TOL = 1e-5
# The port's examples (examples/<name>_torch.py), each run once at its
# default size, in this order, under a timeout of its own (seconds), and the
# kernels each one's path must launch
EXAMPLES = {"quickstart": 240, "fleet_quickstart": 180,
            "unreliable_telemetry": 180, "hetero_fleet": 180,
            "networked_fleet": 180, "mega_fleet": 240,
            "serve_multitier": 180, "train_small_lm": 240,
            "elastic_failover": 180}
EXAMPLE_KERNELS = {"fleet_quickstart": ("belief_efe_fleet",),
                   "unreliable_telemetry": ("belief_efe_fleet",),
                   "hetero_fleet": ("belief_efe_fleet",),
                   "networked_fleet": ("belief_efe_fleet",),
                   "serve_multitier": ("flash_prefill", "flash_decode")}
# The examples that serve through ServingEngine: B4's and B5's launches
# read from a device trace (device_counted)
EXAMPLES_TRACED = ("serve_multitier",)
# serve_multitier's light and medium tiers: d_model 32 and 48 over 4 heads
EXAMPLE_HEAD_DIMS = (8, 12)
# An example's lines that carry its headline numbers
EXAMPLE_HEADLINE = re.compile(
    r"success|P50|completed|loss:|divergence|preemptions"
    r"|^\| |^ring|^no graph")
# Marks the runner's result lines among the examples' own output
EXAMPLE_MARK = "@example "
# Run in one subprocess for all the examples, one after another: each
# example's main() at its default size under SIGALRM at its timeout, with
# every kernel's count read around it (chip_smoke.counted; for
# EXAMPLES_TRACED chip_smoke.device_counted, which also tallies B4's and
# B5's launches by head dim); then one marked JSON line each
EXAMPLE_RUNNER = """
import importlib.util, json, os, signal, sys, time
root, timeouts = sys.argv[1], json.loads(sys.argv[2])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke
def expired(signum, frame):
    raise TimeoutError("the example ran past its timeout")
signal.signal(signal.SIGALRM, expired)
for name, timeout in timeouts.items():
    path = os.path.join(root, "examples", f"{name}_torch.py")
    sys.argv = [path]
    by_d = {}
    signal.alarm(timeout)
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if name in chip_smoke.EXAMPLES_TRACED:
        lines, launches, by_d, _ = chip_smoke.device_counted(
            lambda: mod.main([]))
    else:
        lines, launches = chip_smoke.counted(lambda: mod.main([]))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    signal.alarm(0)
    print(chip_smoke.EXAMPLE_MARK + json.dumps(
        {"example": name, "lines": lines, "launches": launches,
         "by_head_dim": by_d, "main_s": main_s}), flush=True)
"""


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and the seconds since the
    script started (``elapsed_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median ms of one call, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, iters: int = 30) -> tuple[float, bool]:
    """Device ms of one call: ``iters`` calls queued back to back behind a
    busy-wait kernel, so the host's cost per call (Python, checks,
    allocation, launch) stays off the card's clock, timed with CUDA events
    over the batch.  Also returns whether the host had queued every call
    before the card reached the first (else host time leaked in)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))   # >= 2x at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    ahead = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, ahead


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=line, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return name


def phase_build() -> None:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.efe import efe
    from repro_torch.kernels.efe import mega as mega_kernel
    from repro_torch.kernels.ssd import ssd
    libraries = {"efe_fleet": (efe.SOURCES, ()),
                 "mega_window": (mega_kernel.SOURCES,
                                 mega_kernel.EXTRA_FLAGS),
                 "flash_attn": (flash.SOURCES, ()),
                 "ssd_scan": (ssd.SOURCES, ())}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        futs = {name: pool.submit(build.build, name, *spec)
                for name, spec in libraries.items()}
        paths = {name: f.result() for name, f in futs.items()}
    secs = time.perf_counter() - t0
    efe.library()               # load once, so later timings exclude them
    mega_kernel.library()
    flash.library()
    ssd.library()
    ptxas = {name: ptxas_summary((p.parent / "ptxas.log").read_text())
             for name, p in paths.items()}
    smem = {f"{kern}_{dt}_d{d}" + (f"_g{g}" if kern == "decode" else ""):
            flash.smem_bytes(kern, d, g, dtype)
            for kern, g in (("prefill", 1), ("decode", 2), ("decode", 4))
            for dtype, dt in ((torch.bfloat16, "bf16"),
                              (torch.float32, "f32"))
            for d in flash.HEAD_DIMS}
    hmma = sass_hmma(paths["flash_attn"])
    tc = {k: n for k, n in hmma.items() if "prefill_tc_kernel" in k}
    if len(tc) != len(flash.HEAD_DIMS) or min(tc.values()) == 0:
        raise AssertionError(f"the bf16 prefill kernels do not all run on "
                             f"the tensor cores: HMMA counts {hmma}")
    head_dim = {k: int(re.search(r"Li(\d+)E", k).group(1))
                for k in ptxas["flash_attn"]}
    spilled = {k: v for k, v in ptxas["flash_attn"].items()
               if ("prefill_tc_kernel" in k and head_dim[k] <= 128
                   or head_dim[k] in EXAMPLE_HEAD_DIMS)
               and not v.endswith(" 0 B spill stores, 0 B spill loads")}
    if spilled:
        raise AssertionError(f"the bf16 prefill kernel spills at D <= 128, "
                             f"or a flash kernel at D = 8 or 12: {spilled}")
    # B6's bf16 route: both product kernels on the tensor cores, no spills
    ssd_hmma = sass_hmma(paths["ssd_scan"])
    ssd_tc = {k: n for k, n in ssd_hmma.items() if "_tc_kernel" in k}
    if len(ssd_tc) != 2 * len(ssd.TC_HEAD_DIMS) or min(ssd_tc.values()) == 0:
        raise AssertionError(f"the bf16 SSD kernels do not all run on the "
                             f"tensor cores: HMMA counts {ssd_hmma}")
    spilled = {k: v for k, v in ptxas["ssd_scan"].items()
               if ("_tc_kernel" in k or "ssd_pass_kernel" in k)
               and not v.endswith(" 0 B spill stores, 0 B spill loads")}
    if spilled:
        raise AssertionError(f"the bf16 SSD kernels spill: {spilled}")
    mamba = get_arch(MAMBA_ARCH).full
    emit("build", seconds=secs, libraries=sorted(libraries), ptxas=ptxas,
         flash_attn_dynamic_smem_bytes=smem, flash_attn_sass_hmma=hmma,
         ssd_scan_sass_hmma=ssd_hmma,
         ssd_scan_dynamic_smem_bytes={
             f"{str(dtype)[6:]}_p{p}_n{n}_q{q}": ssd.smem_bytes(
                 p, n, q, dtype, mamba.ssm_heads, mamba.ssm_ngroups)
             for dtype in (torch.bfloat16, torch.float32)
             for p, n, q in ((64, 128, 256), (16, 16, 16), (64, 256, 1024))})


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as name<mangled template args>."""
    k = re.search(r"(?<=\d)([A-Za-z_]+_kernel)(I\w*?E)?Ev", mangled)
    return (k.group(1) + (k.group(2) or "")) if k else mangled[:60]


def sass_hmma(lib) -> dict:
    """Count of tensor-core (HMMA) instructions per kernel in the SASS of
    the library ``lib``, read with the toolkit's ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name and "HMMA" in ln:
            counts[name] += 1
    return counts


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output as {kernel<template args>: "N registers,
    S bytes spill stores, L bytes spill loads"}."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if name and spill:
            out[name] = f"{spill.group(1)} B spill stores, " \
                        f"{spill.group(2)} B spill loads"
        if name and regs:
            out[name] = f"{regs.group(1)} registers, " + out.get(name, "")
    return out


def full_width_operands(masked: bool, seed: int = 0, topo=None):
    """Inputs shaped like a real model cache at the widths of ``topo`` (the
    paper's testbed by default), R=1024: column-stochastic nb, normalized
    na, finite log-preferences."""
    from repro_torch.core import generative, policies, spaces
    from repro_torch.core.topology import default_topology
    topo = topo or default_topology()
    cfg = generative.AifConfig(topology=topo)
    r, s, a = R_FULL, topo.n_states, cfg.n_actions
    m, nbin = topo.n_modalities, topo.max_bins
    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    nb = torch.from_numpy(rng.random((r, a, s, s), dtype=np.float32)
                          ).to(dev).add_(0.01)
    nb /= nb.sum(dim=-2, keepdim=True)
    mask_bins = spaces.bins_mask(topo, dev)
    na = torch.from_numpy(rng.random((r, m, nbin, s), dtype=np.float32)
                          ).to(dev).add_(0.01) * mask_bins[:, :, None]
    na /= na.sum(dim=-2, keepdim=True)
    c_log = torch.from_numpy(rng.normal(0.0, 2.0, (r, m, nbin))
                             .astype(np.float32)).to(dev)
    logc = generative.masked_log_c(c_log, topo)
    q = torch.from_numpy(rng.dirichlet(np.ones(s), r).astype(np.float32)
                         ).to(dev)
    prev = torch.from_numpy(rng.integers(0, a, r)).to(dev)
    obs = torch.from_numpy(rng.integers(0, 2, (r, m))).to(dev)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.integers(0, 2, (r, m)).astype(np.float32)
                                ).to(dev)
    from repro_torch.core import belief
    loglik = belief.log_likelihood_from_normalized(na, obs, mask)
    amb_m = generative.modality_ambiguity_from_normalized(na, topo)
    amb = (amb_m.sum(dim=-2) if mask is None
           else generative.masked_ambiguity(amb_m, mask))
    cost = cfg.cost_weight * policies.policy_concentration_cost(topo, dev)
    return dict(nb=nb, prev=prev, q=q, loglik=loglik, na=na, logc=logc,
                amb=amb, cost=cost, mask=mask)


def kernel_calls(d):
    """(kernel, plain version) closures for B1 and B2 on operands ``d``."""
    from repro_torch.kernels.efe import efe, ref
    b1 = (lambda: efe.belief_efe_fleet(d["nb"], d["prev"], d["q"],
                                       d["loglik"], d["na"], d["logc"],
                                       d["amb"], d["cost"], d["mask"]),
          lambda: ref.belief_efe_fleet_ref(
              ref.gather_prev_b(d["nb"], d["prev"]), d["q"], d["loglik"],
              d["nb"], d["na"], d["logc"], d["amb"], d["cost"], d["mask"]))
    b2 = (lambda: (efe.efe_fleet(d["nb"], d["q"], d["na"], d["logc"],
                                 d["amb"], d["cost"], d["mask"]),),
          lambda: (ref.efe_fleet_ref(d["nb"], d["q"], d["na"], d["logc"],
                                     d["amb"], d["cost"], d["mask"]),))
    return {"belief_efe_fleet": b1, "efe_fleet": b2}


def phase_kernel_vs_plain() -> dict:
    errs = {}
    for masked in (False, True):
        d = full_width_operands(masked)
        for name, (kern, plain) in kernel_calls(d).items():
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            g_err = (out_k[0] - out_p[0]).abs().max().item()
            q_err = ((out_k[1] - out_p[1]).abs().max().item()
                     if len(out_k) > 1 else 0.0)
            finite = bool(torch.isfinite(out_k[0]).all())
            emit("kernel_vs_plain", kernel=name, masked=masked, r=R_FULL,
                 g_max_abs_err=g_err, q_max_abs_err=q_err,
                 g_tol=G_TOL, q_tol=Q_TOL)
            if not (finite and g_err <= G_TOL and q_err <= Q_TOL):
                raise AssertionError(
                    f"{name} (masked={masked}) disagrees with its plain "
                    f"version: G err {g_err}, q err {q_err}")
            errs[name] = max(errs.get(name, 0.0), g_err, q_err)
        del d
    torch.cuda.empty_cache()
    return errs


class MirroredNoise:
    """Draws from a CPU generator, handed out on ``device``: two runs on
    two devices see the same random numbers."""

    def __init__(self, seed: int, device: str):
        from repro_torch.noise import GeneratorNoise
        self.src = GeneratorNoise(seed, "cpu")
        self.device = torch.device(device)

    def gumbel(self, t, shape):
        return self.src.gumbel(t, shape).to(self.device)

    def replay_indices(self, t, size, batch):
        return self.src.replay_indices(t, size.cpu(), batch).to(self.device)

    def env_uniforms(self, t, shape):
        return tuple(u.to(self.device) for u in self.src.env_uniforms(t,
                                                                     shape))

    def normal(self, t, shape):
        return self.src.normal(t, shape).to(self.device)


def phase_small_slice(mega: bool = False) -> None:
    """The card's path against the CPU's on a small slice, same draws:
    the fused path (R=4, T=30) or the mega path (R=4, T=23, ending in a
    remainder window)."""
    from repro_torch import api
    runs = {}
    t = 23 if mega else 30
    for dev in (DEVICE, "cpu"):
        e = api.Experiment(router="aif", scenario="paper-burst", n_cells=4,
                           n_windows=t, seed=1, mega=mega, device=dev)
        runs[dev] = api.run(e, noise=MirroredNoise(1, dev))
    gpu, cpu = runs[DEVICE], runs["cpu"]
    same_actions = bool(torch.equal(gpu.trace.actions.cpu(),
                                    cpu.trace.actions))
    rel = {k: abs(getattr(gpu, k) - getattr(cpu, k))
           / max(abs(getattr(cpu, k)), 1e-9)
           for k in ("success_pct", "p50_ms", "p95_ms")}
    belief_err = (gpu.final_carry.belief.cpu()
                  - cpu.final_carry.belief).abs().max().item()
    emit("mega_small_slice" if mega else "small_slice", n_cells=4,
         n_windows=t, actions_equal=same_actions, rel_err=rel,
         belief_max_abs_err=belief_err)
    if not same_actions or max(rel.values()) > 1e-4 or belief_err > 1e-5:
        raise AssertionError("the CUDA path disagrees with the CPU path on "
                             "the small slice")


def all_kernels() -> dict:
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``)."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.efe import efe
    from repro_torch.kernels.efe import mega as mega_kernel
    from repro_torch.kernels.ssd import ssd
    return {"belief_efe_fleet": efe.belief_efe_fleet,
            "efe_fleet": efe.efe_fleet,
            "mega_window": mega_kernel.mega_window_cuda,
            "flash_prefill": flash.flash_prefill,
            "flash_decode": flash.flash_decode,
            "ssd_scan": ssd.ssd_scan}


def counted(fn):
    """``fn()`` with every kernel's count set to 0 just before and read
    just after: (result, launches by kernel)."""
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    res = fn()
    return res, {name: k.launches for name, k in kernels.items()}


def flash_kernels(prof) -> dict:
    """B4's and B5's launches in a ``torch.profiler`` trace, by kernel
    name and head dim: ``flash_prefill_d<D>`` (``prefill_kernel<D>``,
    ``prefill_tc_kernel<D>``) and ``flash_decode_d<D>``
    (``decode_split_kernel<T, D>``, one a launch, beside its merge)."""
    import collections
    by_d = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        for kernel, name in (("flash_prefill", r"prefill_(?:tc_)?kernel"),
                             ("flash_decode", r"decode_split_kernel")):
            if not re.search(name, e.key):
                continue
            d = re.search(name + r"<(?:[^<>,]+,\s*)?(?:\(int\))?(\d+)>",
                          e.key)
            if d is None:
                raise AssertionError(f"no head dim in the kernel name "
                                     f"{e.key!r}")
            by_d[f"{kernel}_d{d.group(1)}"] += e.count
    return dict(by_d)


def device_counted(fn):
    """:func:`counted` under a device trace: (result, launches by kernel,
    B4's and B5's launches by head dim, B5's wrapper calls).  B4's and
    B5's launches are the trace's (:func:`flash_kernels`): a wrapper counts
    its calls, which for a serving engine's decode wave are its eager wave
    and the recording of its CUDA graph, never a replay.  B4 is never
    recorded, so its wrapper's count must equal the trace's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, launches = counted(fn)
        torch.cuda.synchronize()
    by_d = flash_kernels(prof)
    traced = {k: sum(n for name, n in by_d.items()
                     if name.startswith(k + "_d"))
              for k in ("flash_prefill", "flash_decode")}
    if traced["flash_prefill"] != launches["flash_prefill"]:
        raise AssertionError(f"B4: {launches['flash_prefill']} wrapper calls "
                             f"but {traced['flash_prefill']} launches traced")
    b5_calls = launches["flash_decode"]
    return res, dict(launches, **traced), by_d, b5_calls


def run_counted(e):
    """``api.run(e)`` with every kernel's count read around it."""
    from repro_torch import api
    return counted(lambda: api.run(e))


NO_LAUNCHES = {"belief_efe_fleet": 0, "efe_fleet": 0, "mega_window": 0,
               "flash_prefill": 0, "flash_decode": 0, "ssd_scan": 0}


def phase_slice() -> dict:
    from repro_torch import api
    e = api.Experiment(router="aif", scenario="paper-burst", n_cells=R_FULL,
                       n_windows=T_FULL, seed=0, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_counted(e)
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                   p95_ms=res.p95_ms)
    q = res.final_carry.belief
    belief_ok = bool(torch.isfinite(q).all()) and float(
        (q.sum(-1) - 1).abs().max()) < 1e-4
    emit("slice", scenario=e.scenario, n_cells=R_FULL, n_windows=T_FULL,
         wall_s=res.wall_s, launches=launches, selecting_ticks=selecting,
         tier_share=[float(x) for x in res.tier_share],
         obs_frac=res.obs_frac, watchdog_events=res.watchdog_events,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         actions_shape=list(res.trace.actions.shape), beliefs_ok=belief_ok,
         **metrics)
    if launches != dict(NO_LAUNCHES, belief_efe_fleet=selecting):
        raise AssertionError(f"the fused slice launched {launches}, "
                             f"expected {selecting} belief_efe_fleet")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite slice metrics {metrics}")
    if tuple(res.trace.actions.shape) != (T_FULL, R_FULL) or not belief_ok:
        raise AssertionError("slice outputs have the wrong shape or "
                             "unnormalized beliefs")
    layer_times(res.final_carry)
    del res
    torch.cuda.empty_cache()
    return launches


def layer_times(carry) -> None:
    """Per-call times of the plain PyTorch layers around the kernel at the
    slice's shapes, on the slice's final state: the held-tick posterior
    (4 of every 5 ticks) and the slow step (1 of every 10 ticks)."""
    from repro_torch import api
    from repro_torch.core import fleet
    from repro_torch.kernels.efe import ops
    from repro_torch.noise import GeneratorNoise
    cfg = api.AifRouter().cfg
    loglik = torch.zeros_like(carry.belief)
    held_ms = time_ms(lambda: ops.fleet_belief_posterior(
        carry.cache.nb, carry.belief, carry.prev_action, loglik))
    idx = GeneratorNoise(0, carry.belief.device).replay_indices(
        0, carry.replay.size, cfg.replay_batch)
    slow_ms = time_ms(lambda: fleet.fleet_slow_step(carry, idx, cfg),
                      warmup=1, iters=5)
    emit("layers", n_cells=carry.belief.shape[0],
         held_posterior_ms=held_ms, slow_step_ms=slow_ms)


def bound(d, name: str) -> tuple[float, str]:
    """Least time for the work: bytes of inputs read once and outputs
    written once over the HBM rate, against fp32 operations over the fp32
    rate; the larger one bounds it."""
    r, a, s, _ = d["nb"].shape
    m, nbin = d["na"].shape[1], d["na"].shape[2]
    ins = ["nb", "q", "na", "logc", "amb", "cost", "mask"]
    outs = r * a * 4
    flops = r * a * (2 * s * s + 3 * s + 2 * m * nbin * s + 4 * m * nbin)
    if name == "belief_efe_fleet":
        ins += ["prev", "loglik"]
        outs += r * s * 4
        flops += r * (2 * s * s + 8 * s)
    nbytes = sum(d[k].numel() * d[k].element_size()
                 for k in ins if d[k] is not None) + outs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ mega path
def mega_midrun(r: int, t0: int, slot: str, scenario: str = "paper-burst",
                horizon: int = T_FULL, seed: int = 0):
    """The mega path on the card stopped at tick ``t0`` of a ``horizon``-tick
    run: (router, env_step, state, env state, obs carry, noise).  A graph
    scenario attaches its fleet graph, as ``Experiment`` does."""
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.core import mega
    from repro_torch.envsim import batched
    from repro_torch.noise import GeneratorNoise
    e = api.Experiment(router="aif", scenario=scenario, n_cells=r,
                       n_windows=horizon, seed=seed, mega=True,
                       mega_slot_dtype=slot, device=DEVICE)
    g = e.resolve_graph()
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, r, horizon, e.window_s, seed,
        torch.device(DEVICE), g)
    router = e.resolve_router(scfg, g)
    noise = GeneratorNoise(seed, DEVICE)
    est = batched.init_fluid_state(params, env_step.n_obs_modalities)
    if t0 == 0:                 # the first window starts on a fresh fleet
        dtype = torch.bfloat16 if slot == "bfloat16" else torch.float32
        state = mega.init_mega_state(router.cfg, r, horizon, dtype, DEVICE)
        obs = engine._fresh_obs_carry(r, router.n_modalities,
                                      router.n_tiers, torch.device(DEVICE))
    else:
        state, est, _, obs = engine.mega_rollout(router, est, env_step, t0,
                                                 noise, n_total=horizon)
    return router, env_step, state, est, obs, noise


def mega_window_inputs(router, env_step, noise, r: int, t0: int):
    """(positional args after the carries, keyword args) of one window;
    the fault schedules' slices and the fleet graph where the world has
    them."""
    fl = env_step.fluid
    ticks = range(t0, t0 + router.period)
    k = fl.params.n_tiers
    gumbel = torch.stack([noise.gumbel(t, (r, router.cfg.n_actions))
                          for t in ticks])
    uniforms = torch.stack([torch.stack(noise.env_uniforms(t, (r, k)))
                            for t in ticks])
    sl = slice(t0, t0 + router.period)
    ov = None if fl.obs_valid is None else fl.obs_valid[sl]
    args = (fl.params, fl.arrival_rate[sl], fl.hazard_scale[sl], ov,
            uniforms, gumbel, t0)
    kw = dict(cfg=router.cfg, disc=router.resolved_disc,
              util_edges=router.resolved_util_edges,
              util_period=router.util_period, dt=fl.dt,
              scrape_every=fl.scrape_every,
              restart_blackout=fl.restart_blackout,
              emits_mask=bool(env_step.emits_mask))
    extra = dict(forced_down=None if fl.forced_down is None
                 else fl.forced_down[sl],
                 speed=None if fl.speed is None else fl.speed[sl],
                 graph=fl.graph)
    kw.update({k: v for k, v in extra.items() if v is not None})
    return args, kw


def clone_state(st):
    """A copy of a MegaFleetState (the windows push into the tape in
    place)."""
    from repro_torch.core import mega
    return mega.MegaFleetState(
        a_counts=st.a_counts.clone(),
        slots=mega.MegaSlots(*(x.clone() for x in st.slots)),
        cache=mega.MegaCache(*(None if x is None else x.clone()
                               for x in st.cache)),
        **{f: getattr(st, f).clone() for f in mega.MegaFleetState._fields[3:]})


def mega_errors(out_k, out_p, t0: int) -> dict:
    """B3's outputs against its plain version's: whether every integer
    output (actions, pushed bins and actions) is equal, the max abs error
    of the probabilities (posterior, pushed slot rows) and the max of
    |kernel - plain| / max(1, |plain|) over every float output."""
    (sk, ek, ok, yk), (sp, ep, op, yp) = out_k, out_p
    w = yk[0].shape[0]
    cols = slice(t0, t0 + w)
    ints = [(yk[0], yp[0]), (sk.prev_action, sp.prev_action),
            (sk.slots.obs_bins[:, cols], sp.slots.obs_bins[:, cols]),
            (sk.slots.action[:, cols], sp.slots.action[:, cols]),
            (yk[3], yp[3]), (sk.unstable, sp.unstable)]
    probs = [(sk.belief, sp.belief),
             (sk.slots.q_prev[:, cols], sp.slots.q_prev[:, cols]),
             (sk.slots.q_next[:, cols], sp.slots.q_next[:, cols])]
    floats = probs + [
        (sk.dt_since_change, sp.dt_since_change),
        (sk.error_ema, sp.error_ema),
        (sk.slots.obs_mask[:, cols], sp.slots.obs_mask[:, cols]),
        (sk.slots.dt_since_change[:, cols], sp.slots.dt_since_change[:, cols])]
    floats += list(zip(ek, ep)) + list(zip(ok, op))
    floats += [(yk[i], yp[i]) for i in (1, 2, 4)]   # weights, raw, frac
    floats += [(a, b) for a, b in zip(yk[5], yp[5]) if b is not None]

    def f(x):
        return x.float()

    finite = all(bool(torch.isfinite(f(a)).all()) for a, _ in floats)
    return dict(
        ints_equal=all(torch.equal(a, b) for a, b in ints),
        finite=finite,
        max_abs_err=max((f(a) - f(b)).abs().max().item() for a, b in probs),
        max_scaled_err=max(
            ((f(a) - f(b)).abs() / f(b).abs().clamp(min=1.0)).max().item()
            for a, b in floats))


def mega_check(router, env_step, state, est, obs, noise, r: int, t0: int,
               phase: str = "mega_kernel_vs_plain", **fields) -> float:
    """One B3 window against its plain version on copies of the same
    state: every integer output equal, every float finite and within
    MEGA_TOL of the plain version's; returns the max abs error."""
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    args, kw = mega_window_inputs(router, env_step, noise, r, t0)
    out_k = mega_kernel.mega_window_cuda(clone_state(state), est, obs,
                                         *args, **kw)
    out_p = mega.mega_window(clone_state(state), est, obs, *args, **kw)
    torch.cuda.synchronize()
    err = mega_errors(out_k, out_p, t0)
    weighted = int((state.cache.coefw[:, :t0] != 0).sum())
    emit(phase, r=r, t0=t0,
         slot=router.mega_slot_dtype, **fields,
         weighted_slots_per_router=weighted / r, tol=MEGA_TOL, **err)
    if not (err["ints_equal"] and err["finite"]
            and err["max_scaled_err"] <= MEGA_TOL):
        raise AssertionError(f"mega_window (R={r}, t0={t0}, {fields}, "
                             f"{router.mega_slot_dtype} slots) disagrees "
                             f"with its plain version: {err}")
    return err["max_abs_err"]


def phase_mega_kernel_vs_plain() -> float:
    """B3 against its plain version, one window at R=1024 from t0=100:
    paper-burst with float32 and bf16 slots (then timed), and the two
    masked-telemetry scenarios (dropout, restart blackout) with float32
    slots."""
    from repro_torch.kernels.efe import mega as mega_kernel
    worst, t0 = 0.0, 100
    for scenario, slot in (("paper-burst", "float32"),
                           ("paper-burst", "bfloat16"),
                           ("flaky-telemetry", "float32"),
                           ("scrape-blackout", "float32")):
        router, env_step, state, est, obs, noise = mega_midrun(
            R_FULL, t0, slot, scenario)
        worst = max(worst, mega_check(router, env_step, state, est, obs,
                                      noise, R_FULL, t0, scenario=scenario))
        if scenario == "paper-burst":
            args, kw = mega_window_inputs(router, env_step, noise, R_FULL,
                                          t0)
            emit("times", kernel="mega_window", r=R_FULL, t0=t0, slot=slot,
                 ms=time_ms(lambda: mega_kernel.mega_window_cuda(
                     state, est, obs, *args, **kw)))
            del args
        del state, est, obs
    torch.cuda.empty_cache()
    return worst


def phase_mega_slice() -> dict:
    from repro_torch import api
    e = api.Experiment(router="aif", scenario="paper-burst", n_cells=R_MEGA,
                       n_windows=T_FULL, seed=0, mega=True, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_counted(e)
    windows = math.ceil(T_FULL / api.AifRouter().period)
    metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                   p95_ms=res.p95_ms)
    q = res.final_carry.belief
    belief_ok = bool(torch.isfinite(q).all()) and float(
        (q.sum(-1) - 1).abs().max()) < 1e-4
    emit("mega_slice", scenario=e.scenario, n_cells=R_MEGA,
         n_windows=T_FULL, wall_s=res.wall_s, launches=launches,
         windows=windows, tier_share=[float(x) for x in res.tier_share],
         obs_frac=res.obs_frac, watchdog_events=res.watchdog_events,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         actions_shape=list(res.trace.actions.shape), beliefs_ok=belief_ok,
         **metrics)
    if launches != dict(NO_LAUNCHES, mega_window=windows):
        raise AssertionError(f"the mega slice launched {launches}, expected "
                             f"{windows} mega_window launches only")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite mega slice metrics {metrics}")
    if tuple(res.trace.actions.shape) != (T_FULL, R_MEGA) or not belief_ok:
        raise AssertionError("mega slice outputs have the wrong shape or "
                             "unnormalized beliefs")
    mega_layer_times(res.final_carry)
    del res
    torch.cuda.empty_cache()
    return launches


def mega_layer_times(state) -> None:
    """Per-window times of the mega loop's other parts at the slice's
    shapes, on its final state: the slow step, the watchdog (with its
    host sync) and the window's noise block."""
    from repro_torch import api
    from repro_torch.core import mega
    from repro_torch.noise import GeneratorNoise
    cfg = api.AifRouter().cfg
    r, j = state.slots.action.shape
    noise = GeneratorNoise(1, DEVICE)
    idx = noise.replay_indices(j - 1, torch.clamp(state.t, max=j),
                               cfg.replay_batch)
    slow_ms = time_ms(lambda: mega.mega_slow_step(state, idx, cfg),
                      warmup=1, iters=5)
    watchdog_ms = time_ms(lambda: bool(mega.mega_watchdog_bad(state).any()))
    noise_ms = time_ms(lambda: [
        (noise.gumbel(t, (r, cfg.n_actions)), noise.env_uniforms(t, (r, 3)))
        for t in range(10)])
    emit("mega_layers", n_cells=r, slow_step_ms=slow_ms,
         watchdog_ms=watchdog_ms, noise_block_ms=noise_ms)


def mega_bound(state, args, t0: int, dwell: int) -> tuple[float, float]:
    """Least times for one B3 window, (bytes ms, operations ms).  Bytes:
    inputs read once (the tape, qnproj and sumqn rows of the slots that
    carry weight, the coefact rows below t0 that decide which do, the rest
    of the cache, carries, params, schedules and noise) and outputs written
    once (pushes, traces, carries).  Operations: fp32, counted with every
    weighted slot in every prior (an upper bound; the prior skips the
    other actions' slots)."""
    params, arrival, hazard, ov, uniforms, gumbel, _ = args
    sl, c = state.slots, state.cache
    r, j, s = sl.q_prev.shape
    elt = sl.q_prev.element_size()
    a_n, p = c.coefact.shape[2], c.proj.shape[1]
    m, k, w = sl.obs_bins.shape[2], params.n_tiers, gumbel.shape[0]
    n_w = int((c.coefw[:, :t0] != 0).sum())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    ins = (n_w * (2 * s * elt + 4 * p + 4) + r * t0 * a_n * 4
           + nbytes(c.colsum, c.proj, c.projsum, c.logna, state.belief,
                    state.prev_action, state.dt_since_change,
                    state.error_ema, state.t, arrival, hazard, ov,
                    uniforms, gumbel)
           + r * 4 * (12 * k + 8 * k + 9 + 3 * m + k))
    outs = (w * r * (2 * s * elt + m * 8 + m * 4 + 8 + 4)
            + w * r * (8 + 8 * k * 4 + 4 * 4 + 3 * m * 4)
            + r * (s * 4 + 8 + 8) + r * 4 * (8 * k + 9 + 3 * m + k))
    n_sel = math.ceil(w / dwell)            # selecting ticks: the EFE runs
    flops = (w * (4 * s * n_w + 20 * s * r)
             + n_sel * (2 * s * n_w + 2 * n_w * (p + 1)
                        + r * (2 * a_n * p * s + 2 * a_n * s)))
    return (1e3 * (ins + outs) / HBM_BYTES_PER_S,
            1e3 * flops / FP32_FLOP_PER_S)


def mega_times(errs: dict, launches: dict) -> dict:
    """B3 at the mega slice's fleet (R=4096) from the slice's own states at
    window starts t0 = 0, 150 and 290: held against its plain version on
    each (the main path's shapes), then its ms per launch beside its plain
    version's and its bound.  The kernels line reports t0=150; the three
    times, interpolated linearly over the slice's 30 window starts, give
    an estimate of B3's total time in the slice."""
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    row, by_t0 = None, {}
    for t0 in (0, T0_MEGA, T_FULL - 10):
        router, env_step, state, est, obs, noise = mega_midrun(
            R_MEGA, t0, "float32")
        errs["mega_window"] = max(errs["mega_window"], mega_check(
            router, env_step, state, est, obs, noise, R_MEGA, t0,
            scenario="paper-burst"))
        args, kw = mega_window_inputs(router, env_step, noise, R_MEGA, t0)
        kern = lambda: mega_kernel.mega_window_cuda(state, est, obs, *args,
                                                    **kw)
        plain = lambda: mega.mega_window(state, est, obs, *args, **kw)
        ms = time_ms(kern)
        plain_ms = time_ms(plain, warmup=1, iters=3)
        ms2 = time_ms(kern)
        dev, ahead = queued_ms(kern)
        bytes_ms, ops_ms = mega_bound(state, args, t0, router.dwell)
        b_ms = max(bytes_ms, ops_ms)
        b_by = "bytes" if bytes_ms >= ops_ms else "operations"
        emit("times", kernel="mega_window", r=R_MEGA, t0=t0, ms=ms,
             ms_repeat=ms2, plain_ms=plain_ms, device_ms=dev,
             queued_ahead=ahead, bound_ms=b_ms, bound_by=b_by,
             bytes_ms=bytes_ms, ops_ms=ops_ms,
             weighted_slots_per_router=float(
                 (state.cache.coefw[:, :t0] != 0).sum()) / R_MEGA)
        by_t0[t0] = ms
        if t0 == T0_MEGA:
            row = {"name": "mega_window", "route": "cuda",
                   "source": "src/repro_torch/csrc/mega_window.cu",
                   "replaces": "src/repro/kernels/efe/mega.py:85",
                   "launches": launches["mega_window"],
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None,
                   "device_ms": dev, "library_device_ms": None}
        del state, est, obs, args, kern, plain
        torch.cuda.empty_cache()
    starts = np.arange(0, T_FULL, router.period)
    est_ms = float(np.interp(starts, list(by_t0), list(by_t0.values())).sum())
    emit("mega_window_in_slice", windows=len(starts), ms_by_t0=by_t0,
         total_ms_interpolated=est_ms)
    row["max_abs_err"] = row["max_err"] = errs["mega_window"]
    return row


# ------------------------------------------- Table 1, hetero, chaos, resume
def phase_table1_small() -> None:
    """``compare(table1_grid(n_cells=4, n_windows=30, seed=1))`` on the card
    and on the CPU with the same draws, the AIF rows fused and unfused:
    actions equal in every row, success/P50/P95 within 1e-4 relative."""
    from repro_torch import api
    for fused in (True, False):
        comps = {}
        for dev in (DEVICE, "cpu"):
            grid = api.table1_grid(n_cells=4, n_windows=30, seed=1,
                                   fused=fused, device=dev)
            comps[dev] = api.Comparison(
                [api.run(e, noise=MirroredNoise(e.seed, dev)) for e in grid])
        same, worst = True, 0.0
        for gpu, cpu in zip(comps[DEVICE].results, comps["cpu"].results):
            same &= bool(torch.equal(gpu.trace.actions.cpu(),
                                     cpu.trace.actions))
            worst = max([worst] + [
                abs(getattr(gpu, k) - getattr(cpu, k))
                / max(abs(getattr(cpu, k)), 1e-9)
                for k in ("success_pct", "p50_ms", "p95_ms")])
        emit("table1_small", fused=fused, rows=len(comps["cpu"].results),
             n_cells=4, n_windows=30, actions_equal=same, max_rel_err=worst)
        if not same or worst > 1e-4:
            raise AssertionError(f"the Table-1 grid (fused={fused}) on the "
                                 f"card disagrees with the CPU's")


def phase_table1() -> None:
    """The Table-1 grid at R=1024 x T=300 on the card, every kernel's count
    read around each row (AIF: B1 on each selecting tick; baselines: no
    launch); then the unfused AIF path on paper-burst (plain PyTorch, no
    launch)."""
    from repro_torch import api
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    rows = []
    for e in api.table1_grid(n_cells=R_FULL, n_windows=T_FULL, seed=0,
                             device=DEVICE):
        res, launches = run_counted(e)
        metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                       p95_ms=res.p95_ms)
        emit("table1_row", scenario=e.scenario, router=e.router,
             n_cells=R_FULL, n_windows=T_FULL, wall_s=res.wall_s,
             launches=launches, success_std=res.success_std,
             tier_share=[float(x) for x in res.tier_share],
             obs_frac=res.obs_frac, **metrics)
        want = (dict(NO_LAUNCHES, belief_efe_fleet=selecting)
                if e.router == "aif" else NO_LAUNCHES)
        if launches != want:
            raise AssertionError(f"{e.router} on {e.scenario} launched "
                                 f"{launches}, expected {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite {e.router} metrics {metrics}")
        res.final_carry = res.trace = None      # keep the row's numbers only
        rows.append(res)
        torch.cuda.empty_cache()
    comp = api.Comparison(rows)
    print(comp.markdown(), flush=True)
    emit("table1", rows=len(rows), table=comp.to_json())
    e = api.Experiment(router="aif", fused=False, scenario="paper-burst",
                       n_cells=R_FULL, n_windows=T_FULL, seed=0,
                       device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_counted(e)
    metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                   p95_ms=res.p95_ms)
    emit("table1_unfused", scenario=e.scenario, n_cells=R_FULL,
         n_windows=T_FULL, wall_s=res.wall_s, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **metrics)
    if launches != NO_LAUNCHES or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"the unfused path launched {launches} or gave "
                             f"non-finite metrics {metrics}")
    del res
    torch.cuda.empty_cache()
    table1_breakdown()


def table1_breakdown() -> None:
    """The device's share of four Table-1 rows on paper-burst at R=1024 x
    ``T_BREAKDOWN`` (a static baseline, a bandit, AIF fused and unfused):
    the device time of one ``api.run`` from a ``torch.profiler`` trace
    beside the rollout's wall, and the kernels that took longest."""
    from repro_torch import api
    for router, fused in (("uniform", True), ("thompson", True),
                          ("aif", True), ("aif", False)):
        e = api.Experiment(router=router, fused=fused, scenario="paper-burst",
                           n_cells=R_FULL, n_windows=T_BREAKDOWN, seed=0,
                           device=DEVICE)
        walls = []
        dev = device_ms(lambda: walls.append(api.run(e).wall_s))
        emit("table1_breakdown", router=router, fused=fused,
             n_cells=R_FULL, n_windows=T_BREAKDOWN, wall_s=walls[-1],
             device_ms=dev["all"],
             device_idle_share=1.0 - dev["all"] / (1e3 * walls[-1]),
             top=dev["top"])
        torch.cuda.empty_cache()


def phase_kernel_vs_plain_5tier() -> float:
    """B1 against its plain version at the continuum-5tier widths (R=1024,
    S=128, A=37), unmasked and masked, as phase 3 at the paper's."""
    from repro_torch.core.topology import five_tier_topology
    worst = 0.0
    for masked in (False, True):
        d = full_width_operands(masked, topo=five_tier_topology())
        kern, plain = kernel_calls(d)["belief_efe_fleet"]
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        g_err = (out_k[0] - out_p[0]).abs().max().item()
        q_err = (out_k[1] - out_p[1]).abs().max().item()
        finite = bool(torch.isfinite(out_k[0]).all())
        emit("kernel_vs_plain", kernel="belief_efe_fleet",
             topology="continuum-5tier", masked=masked, r=R_FULL,
             shape=list(d["nb"].shape), g_max_abs_err=g_err,
             q_max_abs_err=q_err, g_tol=G_TOL, q_tol=Q_TOL)
        if not (finite and g_err <= G_TOL and q_err <= Q_TOL):
            raise AssertionError(
                f"belief_efe_fleet at the 5-tier widths (masked={masked}) "
                f"disagrees with its plain version: G err {g_err}, q err "
                f"{q_err}")
        worst = max(worst, g_err, q_err)
        del d
    return worst


def hetero_group(name: str, topo_name: str, r: int, t: int):
    """A fused FleetGroup of ``r`` cells of one topology on paper-burst,
    its env_step watched: ``seen[name]`` is B1's count at its last window."""
    from repro_torch.core import fleet, generative
    from repro_torch.core.topology import get_topology
    from repro_torch.envsim import batched, scenarios
    from repro_torch.envsim.config import (SimConfig, discretization_for,
                                           sim_config_for)
    from repro_torch.kernels.efe import efe
    topo = get_topology(topo_name)
    scfg = SimConfig() if topo_name == "paper-3tier" else sim_config_for(topo)
    sc = scenarios.build_scenario("paper-burst", scfg, r, t, seed=0)
    params = batched.params_from_config(scfg, r, sc.capacity_scale,
                                        device=DEVICE)
    env_step = batched.make_scenario_env_step(params, sc)
    seen = {}

    def watched(*args):
        seen[name] = efe.belief_efe_fleet.launches
        return env_step(*args)

    watched.__dict__.update(vars(env_step))
    cfg = generative.AifConfig(topology=topo)
    group = fleet.FleetGroup(
        name=name, cfg=cfg,
        agent_state=fleet.init_fleet_state(cfg, r, DEVICE),
        env_state=batched.init_fluid_state(params), env_step=watched,
        fused=True, disc=(None if topo_name == "paper-3tier"
                          else discretization_for(scfg)))
    return group, seen


def phase_hetero() -> tuple[float, int]:
    """B1 at the 5-tier widths against its plain version, then
    ``hetero_fleet_rollout`` over a paper-3tier and a continuum-5tier group
    (fused, R=1024 each, T=300), B1's launches read for each group.
    Returns B1's error at the 5-tier shape and its launches in that group."""
    from repro_torch.core import fleet
    from repro_torch.envsim import batched
    from repro_torch import api
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    err = phase_kernel_vs_plain_5tier()
    g3, seen = hetero_group("paper-3tier", "paper-3tier", R_FULL, T_FULL)
    g5, seen5 = hetero_group("continuum-5tier", "continuum-5tier", R_FULL,
                             T_FULL)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, launches = counted(
        lambda: fleet.hetero_fleet_rollout([g3, g5], T_FULL, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del g3, g5
    per_group = {"paper-3tier": seen["paper-3tier"],
                 "continuum-5tier": (launches["belief_efe_fleet"]
                                     - seen["paper-3tier"])}
    for name, (carry, est, trace) in out.items():
        res = batched.summarize(est, trace.env)
        q = carry.belief
        ok = bool(torch.isfinite(q).all()) and float(
            (q.sum(-1) - 1).abs().max()) < 1e-4
        emit("hetero_group", group=name, n_cells=R_FULL, n_windows=T_FULL,
             states=q.shape[-1], actions=carry.cache.nb.shape[1],
             b1_launches=per_group[name],
             success_pct=float(100 * res.success_rate.mean()),
             p95_ms=float(res.p95_ms.mean()), beliefs_ok=ok)
        if not ok or per_group[name] != selecting:
            raise AssertionError(f"hetero group {name}: beliefs_ok={ok}, "
                                 f"B1 launches {per_group[name]}")
    emit("hetero", wall_s=wall, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (launches != dict(NO_LAUNCHES, belief_efe_fleet=2 * selecting)
            or seen5["continuum-5tier"] != launches["belief_efe_fleet"]):
        raise AssertionError(f"hetero_fleet_rollout launched {launches}")
    del out
    torch.cuda.empty_cache()
    return err, per_group["continuum-5tier"]


def phase_chaos() -> None:
    """Each chaos preset at R=1024 x T=300 with fused AIF, and its control
    run on paper-burst for the recovery metrics."""
    from repro_torch import api
    from repro_torch.envsim import chaos
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    for scenario in sorted(chaos.CHAOS_PRESETS):
        e = api.Experiment(router="aif", scenario=scenario, n_cells=R_FULL,
                           n_windows=T_FULL, seed=0, device=DEVICE)
        t0 = time.perf_counter()
        res, launches = run_counted(e)
        total = time.perf_counter() - t0
        rec = res.recovery
        metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                       p95_ms=res.p95_ms, **{
                           k: v for k, v in rec.items()
                           if isinstance(v, float)})
        emit("chaos", scenario=scenario, n_cells=R_FULL, n_windows=T_FULL,
             wall_s=res.wall_s, with_control_s=total, launches=launches,
             restarts=res.restarts, recovery=rec)
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite {scenario} metrics {metrics}")
        if launches != dict(NO_LAUNCHES, belief_efe_fleet=2 * selecting):
            raise AssertionError(f"{scenario} (with its control) launched "
                                 f"{launches}")
        del res
        torch.cuda.empty_cache()


R_CKPT = 32        # a checkpoint of R=1024 AIF carries would be ~20 GB
CKPT_EVERY = 100


def phase_resume(cases=(("zone-outage", False), ("paper-burst", True)),
                 phase: str = "resume") -> None:
    """Checkpointed runs at R=32 x T=300 (checkpoint_every=100), then
    resumed from the newest checkpoint: the final carry and n_success must
    equal the uninterrupted run's to the bit, per-tick (zone-outage, fused
    AIF, B1) and mega (paper-burst, B3), or the given (scenario, mega)
    cases.  Also the checkpoint's size and the seconds to write and to
    restore one."""
    import shutil
    import tempfile
    from repro_torch import api
    from repro_torch.api import experiment
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.noise import GeneratorNoise
    dev = torch.device(DEVICE)
    for scenario, mega in cases:
        base = dict(router="aif", scenario=scenario, n_cells=R_CKPT,
                    n_windows=T_FULL, seed=0, mega=mega, device=DEVICE)
        r0, l0 = run_counted(api.Experiment(**base))
        d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            r1, l1 = run_counted(api.Experiment(
                **base, checkpoint_every=CKPT_EVERY, checkpoint_dir=d))
            steps = Checkpointer(d).all_steps()
            step_dir = os.path.join(d, f"step_{steps[-1]:08d}")
            size = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
            r2, l2 = run_counted(api.Experiment(**base, resume_from=d))
            # one restore and one blocking write, timed alone
            e = api.Experiment(**base)
            scfg, params, env_step = experiment._build_world(
                e.resolve_topology(), scenario, R_CKPT, T_FULL, 1.0, 0, dev)
            router = e.resolve_router(scfg)
            noise = GeneratorNoise(0, dev)
            like = experiment._ckpt_template(e, router, params, noise,
                                             env_step.n_obs_modalities)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, _ = Checkpointer(d).restore(like, device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Checkpointer(os.path.join(d, "timed")).save(
                steps[-1], tree, blocking=True)
            write_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)

        def same(a, b):
            fa, fb = flatten(a), flatten(b)
            return fa.keys() == fb.keys() and all(
                torch.equal(fa[k], fb[k]) for k in fa)

        kernel = "mega_window" if mega else "belief_efe_fleet"
        checks = dict(
            checkpointed_carry_equal=same(r0.final_carry, r1.final_carry),
            resumed_carry_equal=same(r0.final_carry, r2.final_carry),
            checkpointed_n_success_equal=bool(np.array_equal(
                r0.fluid.n_success, r1.fluid.n_success)),
            resumed_n_success_equal=bool(np.array_equal(
                r0.fluid.n_success, r2.fluid.n_success)))
        emit(phase, path="mega" if mega else "per-tick",
             scenario=scenario, n_cells=R_CKPT, n_windows=T_FULL,
             checkpoint_every=CKPT_EVERY, resume_points=[r1.resume_points,
                                                  r2.resume_points],
             checkpoint_bytes=size, write_s=write_s, restore_s=restore_s,
             wall_s=[r0.wall_s, r1.wall_s, r2.wall_s],
             launches=[l0[kernel], l1[kernel], l2[kernel]], **checks)
        if not all(checks.values()) or min(
                l0[kernel], l1[kernel], l2[kernel]) < 1:
            raise AssertionError(f"the {scenario} resume is not equal to "
                                 f"the bit on the card, or {kernel} did not "
                                 f"run: {checks}")
        del r0, r1, r2, tree, like
        torch.cuda.empty_cache()


# ------------------------------------------------- graph worlds, warm fleets
class TickNoise:
    """Draws that depend on (seed, tick, kind) alone, from a CPU generator
    seeded per draw and handed out on ``device``: two paths that ask for
    them in different orders (the per-tick engine draws a tick's Gumbel
    noise on selecting ticks only, the mega path on every tick) see the
    same numbers."""

    def __init__(self, seed: int, device: str):
        self.seed = seed
        self.device = torch.device(device)

    def _gen(self, t: int, kind: int) -> torch.Generator:
        g = torch.Generator()
        g.manual_seed(self.seed * 1_000_003 + 8 * t + kind)
        return g

    def gumbel(self, t, shape):
        u = torch.rand(shape, generator=self._gen(t, 0)).clamp(
            min=torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(self.device)

    def replay_indices(self, t, size, batch):
        hi = torch.clamp(size.cpu(), min=1)[:, None]
        u = torch.rand((hi.shape[0], batch), generator=self._gen(t, 1))
        return torch.minimum((u * hi).long(), hi - 1).to(self.device)

    def env_uniforms(self, t, shape):
        g = self._gen(t, 2)
        return (torch.rand(shape, generator=g).to(self.device),
                torch.rand(shape, generator=g).to(self.device))

    def normal(self, t, shape):
        return torch.randn(shape, generator=self._gen(t, 3)).to(self.device)


def graph_operands(masked: bool) -> dict:
    """B1's operands at the graph worlds' widths: the paper's testbed with
    the neighbor-pressure modality (M=5, 15 observation rows), R=1024."""
    from repro_torch.core import graph
    from repro_torch.core.topology import default_topology
    return full_width_operands(
        masked, topo=graph.with_neighbor_modality(default_topology()))


def phase_graph_kernel_vs_plain() -> float:
    """B1 against its plain version at M=5, unmasked and masked, each
    launched twice with the two outputs equal to the bit."""
    worst = 0.0
    for masked in (False, True):
        d = graph_operands(masked)
        kern, plain = kernel_calls(d)["belief_efe_fleet"]
        out_k, out_k2, out_p = kern(), kern(), plain()
        torch.cuda.synchronize()
        g_err = (out_k[0] - out_p[0]).abs().max().item()
        q_err = (out_k[1] - out_p[1]).abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        finite = bool(torch.isfinite(out_k[0]).all())
        emit("graph_kernel_vs_plain", kernel="belief_efe_fleet",
             masked=masked, shape=list(d["nb"].shape),
             modalities=d["na"].shape[1], obs_rows=d["na"].shape[1]
             * d["na"].shape[2], g_max_abs_err=g_err, q_max_abs_err=q_err,
             g_tol=G_TOL, q_tol=Q_TOL, launches_bit_equal=same)
        if not (finite and same and g_err <= G_TOL and q_err <= Q_TOL):
            raise AssertionError(
                f"belief_efe_fleet at M=5 (masked={masked}) disagrees with "
                f"its plain version or between launches: G err {g_err}, "
                f"q err {q_err}, bit-equal {same}")
        worst = max(worst, g_err, q_err)
        del d, out_k, out_k2, out_p
    torch.cuda.empty_cache()
    return worst


def phase_graph_small() -> None:
    """A small ring-spillover run on the card against the CPU, same draws."""
    from repro_torch import api
    runs = {}
    for dev in (DEVICE, "cpu"):
        e = api.Experiment(router="aif", scenario="ring-spillover",
                           n_cells=6, n_windows=30, seed=1, device=dev)
        runs[dev] = api.run(e, noise=MirroredNoise(1, dev))
    gpu, cpu = runs[DEVICE], runs["cpu"]
    same_actions = bool(torch.equal(gpu.trace.actions.cpu(),
                                    cpu.trace.actions))
    rel = {k: abs(getattr(gpu, k) - getattr(cpu, k))
           / max(abs(getattr(cpu, k)), 1e-9)
           for k in ("success_pct", "p50_ms", "p95_ms", "offload_frac")}
    spill_err = (gpu.trace.env.spill_admitted.cpu()
                 - cpu.trace.env.spill_admitted).abs().max().item()
    emit("graph_small", n_cells=6, n_windows=30, actions_equal=same_actions,
         rel_err=rel, spill_admitted_max_abs_err=spill_err,
         offload_frac=gpu.offload_frac,
         modalities=int(gpu.trace.raw_obs.shape[-1]))
    if (not same_actions or max(rel.values()) > 1e-4
            or gpu.trace.raw_obs.shape[-1] != 5 or gpu.offload_frac <= 0):
        raise AssertionError("the CUDA path disagrees with the CPU path on "
                             "the small ring-spillover run")


R_GRAPH_SMALL = 256     # grid-hotspot and hier-continuum


def phase_graph() -> int:
    """The graphed fused slice and its ungraphed control, the graphed run
    again through the engine (equal to the bit, mass conserved), then the
    other two graph scenarios at a smaller R.  Returns B1's launches in
    the graphed slice."""
    import dataclasses
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.envsim import batched
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    want = dict(NO_LAUNCHES, belief_efe_fleet=selecting)
    e = api.Experiment(router="aif", scenario="ring-spillover",
                       n_cells=R_FULL, n_windows=T_FULL, seed=0,
                       device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_counted(e)
    ctl, ctl_launches = run_counted(dataclasses.replace(e, graph="none"))
    ctl.final_carry = ctl.trace = None    # ~20 GB: keep the numbers only
    torch.cuda.empty_cache()

    def fleet(r):
        return float(r.fluid.n_success.sum()) / float(
            r.fluid.n_requests.sum())

    # the same run through the engine, with the same draws: equal to the
    # bit, and its final state closes the fleet's mass balance
    dev = torch.device(DEVICE)
    g = e.resolve_graph()
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, R_FULL, T_FULL, 1.0, 0, dev, g)
    router = e.resolve_router(scfg, g)
    carry, est, trace = engine.rollout(
        router, router.init_carry(R_FULL, dev),
        batched.init_fluid_state(params, env_step.n_obs_modalities),
        env_step, T_FULL, seed=0)
    bits = (torch.equal(trace.actions, res.trace.actions)
            and torch.equal(trace.env.spill_admitted,
                            res.trace.env.spill_admitted)
            and all(torch.equal(a, b) for a, b in zip(
                flatten(carry).values(), flatten(res.final_carry).values()))
            and np.array_equal(est.n_success.cpu().numpy(),
                               res.fluid.n_success))

    def tot(x):
        return float(x.double().sum())

    offered = tot(est.n_requests)
    accounted = (tot(est.n_success) + tot(est.err_timeout)
                 + tot(est.err_overflow) + tot(est.err_refused)
                 + tot(est.err_restart) + tot(est.backlog))
    mass_rel = abs(accounted - offered) / offered
    emit("graph", scenario=e.scenario, n_cells=R_FULL, n_windows=T_FULL,
         wall_s=res.wall_s, launches=launches,
         success_pct=res.success_pct, p50_ms=res.p50_ms, p95_ms=res.p95_ms,
         offload_frac=res.offload_frac, fleet_success=fleet(res),
         control_wall_s=ctl.wall_s, control_launches=ctl_launches,
         control_success_pct=ctl.success_pct,
         control_fleet_success=fleet(ctl),
         control_offload_frac=ctl.offload_frac, rerun_bit_equal=bits,
         mass_offered=offered, mass_accounted=accounted,
         mass_rel_err=mass_rel, modalities=int(res.trace.raw_obs.shape[-1]),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != want or ctl_launches != want:
        raise AssertionError(f"the graph slice launched {launches} (control "
                             f"{ctl_launches}), expected {want}")
    if not bits or mass_rel > 1e-5 or res.offload_frac <= 0.0:
        raise AssertionError(f"the graph slice is not reproducible to the "
                             f"bit ({bits}), leaks mass ({mass_rel}) or "
                             f"spilled nothing ({res.offload_frac})")
    if not all(math.isfinite(v) for v in (res.success_pct, res.p50_ms,
                                          res.p95_ms)):
        raise AssertionError("non-finite graph slice metrics")
    b1 = launches["belief_efe_fleet"]
    del res, ctl, carry, est, trace
    torch.cuda.empty_cache()
    for scenario in ("grid-hotspot", "hier-continuum"):
        e = api.Experiment(router="aif", scenario=scenario,
                           n_cells=R_GRAPH_SMALL, n_windows=T_FULL, seed=0,
                           device=DEVICE)
        res, launches = run_counted(e)
        emit("graph", scenario=scenario, n_cells=R_GRAPH_SMALL,
             n_windows=T_FULL, wall_s=res.wall_s, launches=launches,
             success_pct=res.success_pct, p50_ms=res.p50_ms,
             p95_ms=res.p95_ms, offload_frac=res.offload_frac,
             fleet_success=fleet(res))
        if launches != want or not math.isfinite(res.success_pct) or \
                res.offload_frac <= 0.0:
            raise AssertionError(f"{scenario}: launches {launches}, success "
                                 f"{res.success_pct}, offload "
                                 f"{res.offload_frac}")
        del res
        torch.cuda.empty_cache()
    return b1


def graph_times(err: float, launches: int) -> dict:
    """B1 at M=5 (R=1024): times beside its bound and plain version, with
    the launches of the graphed slice."""
    d = graph_operands(masked=False)
    kern, plain = kernel_calls(d)["belief_efe_fleet"]
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    dev, ahead = queued_ms(kern)
    b_ms, b_by = bound(d, "belief_efe_fleet")
    row = {"name": "belief_efe_fleet", "variant": "graph_m5",
           "route": "cuda", "source": "src/repro_torch/csrc/efe_fleet.cu",
           "replaces": "src/repro/kernels/efe/efe.py:250",
           "shape": list(d["nb"].shape) + [d["na"].shape[1]],
           "launches": launches, "max_abs_err": err, "max_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "device_ms": dev,
           "library_device_ms": None}
    emit("times", kernel="belief_efe_fleet", topology="paper-3tier+neighbor",
         queued_ahead=ahead, **{k: v for k, v in row.items()
                                if k not in ("name", "route", "source",
                                             "replaces")})
    del d
    torch.cuda.empty_cache()
    return row


T_WARM = 150            # the per-tick prefix, then as many mega ticks


def warm_prefix(r: int, t1: int, horizon: int, device: str, noise):
    """A fused per-tick run of ``r`` cells on paper-burst stopped at tick
    ``t1`` of a ``horizon``-tick world: (per-tick router, mega router,
    env_step, dense carry, env state, snapshot)."""
    import dataclasses
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.envsim import batched
    dev = torch.device(device)
    e = api.Experiment(router="aif", scenario="paper-burst", n_cells=r,
                       n_windows=horizon, seed=0, device=device)
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, r, horizon, 1.0, 0, dev)
    pt = e.resolve_router(scfg)
    mg = dataclasses.replace(pt, mega=True)
    carry, est, _, snap = engine.resumable_rollout(
        pt, pt.init_carry(r, dev), batched.init_fluid_state(params),
        env_step, t1, noise)
    return pt, mg, env_step, carry, est, snap


def warm_bound(state, args, t0: int, dwell: int) -> tuple[float, float]:
    """Least times for one warm B3 window, (bytes ms, operations ms): the
    fresh window's (``mega_bound``) plus the baseline b_base read once,
    and its matvecs: one (S, S) row block a tick for the prior, all A of
    them on each selecting tick for the EFE."""
    bytes_ms, ops_ms = mega_bound(state, args, t0, dwell)
    bb = state.cache.b_base
    r, a_n, s, _ = bb.shape
    w = args[5].shape[0]
    n_sel = math.ceil(w / dwell)
    flops = 2 * r * s * s * (w + n_sel * a_n)
    return (bytes_ms + 1e3 * bb.numel() * 4 / HBM_BYTES_PER_S,
            ops_ms + 1e3 * flops / FP32_FLOP_PER_S)


def phase_warm() -> dict:
    """Warm promotion at R=1024: a fused per-tick run to t=150, promoted
    onto the mega path; one warm B3 window against its plain version at
    the promotion and two windows later (then the replayed slots carry
    weight too), the first launched twice (equal to the bit) and timed;
    then 150 more ticks on the mega path (15 B3 launches) and, on the same
    draws, 150 on the per-tick path (30 B1 launches), with the count of
    differing actions; then a small warm run on the card against the CPU.
    Returns the warm B3 row of the kernels line."""
    from repro_torch.api import engine
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    horizon = 2 * T_WARM
    noise = TickNoise(0, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    pt, mg, env_step, carry, est, snap = warm_prefix(R_FULL, T_WARM,
                                                     horizon, DEVICE, noise)
    obs = snap[0]
    state = mega.init_mega_state(mg.cfg, R_FULL, horizon, torch.float32,
                                 DEVICE, from_agent_state=carry)
    err = mega_check(mg, env_step, state, est, obs, noise, R_FULL, T_WARM,
                     scenario="paper-burst", warm=True)
    # two windows later the replayed slots carry weight beside the baseline
    st2, est2, _, obs2 = engine.mega_rollout(
        mg, est, env_step, 2 * mg.period, noise, carry=carry, obs_carry=obs,
        n_total=horizon - T_WARM)
    err = max(err, mega_check(mg, env_step, st2, est2, obs2, noise, R_FULL,
                              T_WARM + 2 * mg.period, scenario="paper-burst",
                              warm=True))
    del st2, est2, obs2
    args, kw = mega_window_inputs(mg, env_step, noise, R_FULL, T_WARM)
    out1 = mega_kernel.mega_window_cuda(clone_state(state), est, obs, *args,
                                        **kw)
    out2 = mega_kernel.mega_window_cuda(clone_state(state), est, obs, *args,
                                        **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(flatten(out1).values(),
                                                 flatten(out2).values()))
    del out1, out2
    kern = lambda: mega_kernel.mega_window_cuda(state, est, obs, *args, **kw)
    plain = lambda: mega.mega_window(state, est, obs, *args, **kw)
    ms = time_ms(kern)
    plain_ms = time_ms(plain, warmup=1, iters=3)
    dev, ahead = queued_ms(kern)
    bytes_ms, ops_ms = warm_bound(state, args, T_WARM, mg.dwell)
    b_ms, b_by = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                         else "operations")
    emit("warm_kernel_vs_plain", r=R_FULL, t0=T_WARM,
         b_base_gb=state.cache.b_base.numel() * 4 / 1e9,
         launches_bit_equal=same, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, device_ms=dev, queued_ahead=ahead,
         bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms, ops_ms=ops_ms)
    if not same:
        raise AssertionError("two launches of B3's warm branch differ")
    del state, args, kern, plain
    torch.cuda.empty_cache()

    # 150 more ticks on the mega path, then the per-tick continuation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (st_m, est_m, tr_m, _), l_mega = counted(lambda: engine.mega_rollout(
        mg, est, env_step, T_WARM, noise, carry=carry, obs_carry=obs))
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    t0 = time.perf_counter()
    (_, est_p, tr_p, _), l_tick = counted(lambda: engine.resumable_rollout(
        pt, carry, est, env_step, T_WARM, noise, t_begin=T_WARM,
        snapshot=snap))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    diff = int((tr_m.actions != tr_p.actions).sum())
    windows = T_WARM // mg.period
    selecting = T_WARM // mg.dwell

    def succ(e):
        return float(e.n_success.double().sum() / e.n_requests.double().sum())

    q = st_m.belief
    ok = bool(torch.isfinite(q).all()) and float(
        (q.sum(-1) - 1).abs().max()) < 1e-4
    emit("warm", n_cells=R_FULL, t_promote=T_WARM, n_more=T_WARM,
         mega_wall_s=wall_m, mega_launches=l_mega, per_tick_wall_s=wall_p,
         per_tick_launches=l_tick, action_diffs=diff,
         actions=int(tr_m.actions.numel()),
         mega_fleet_success=succ(est_m), per_tick_fleet_success=succ(est_p),
         clock=st_m.t.unique().tolist(), beliefs_ok=ok,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if l_mega != dict(NO_LAUNCHES, mega_window=windows):
        raise AssertionError(f"the warm mega run launched {l_mega}, "
                             f"expected {windows} mega_window")
    if l_tick != dict(NO_LAUNCHES, belief_efe_fleet=selecting):
        raise AssertionError(f"the per-tick continuation launched {l_tick}")
    if not ok or st_m.t.unique().tolist() != [2 * T_WARM]:
        raise AssertionError("the warm mega run's beliefs or clock are off")
    del st_m, est_m, tr_m, est_p, tr_p, carry, est, snap, obs
    torch.cuda.empty_cache()

    # a small warm run, card against CPU, same draws
    acts = {}
    for dev_name in (DEVICE, "cpu"):
        nz = MirroredNoise(3, dev_name)
        _, mg_s, env_s, c_s, e_s, sn_s = warm_prefix(4, 20, 40, dev_name, nz)
        st_s, e_s, tr_s, _ = engine.mega_rollout(
            mg_s, e_s, env_s, 20, nz, carry=c_s, obs_carry=sn_s[0])
        acts[dev_name] = (tr_s.actions.cpu(), st_s.belief.cpu(),
                          e_s.n_success.cpu())
    same_small = torch.equal(acts[DEVICE][0], acts["cpu"][0])
    b_err = (acts[DEVICE][1] - acts["cpu"][1]).abs().max().item()
    s_rel = ((acts[DEVICE][2] - acts["cpu"][2]).abs()
             / acts["cpu"][2].abs().clamp(min=1.0)).max().item()
    emit("warm_small", n_cells=4, t_promote=20, n_more=20,
         actions_equal=same_small, belief_max_abs_err=b_err,
         n_success_rel_err=s_rel)
    if not same_small or b_err > 1e-5 or s_rel > 1e-4:
        raise AssertionError("the warm mega run on the card disagrees with "
                             "the CPU's")
    return {"name": "mega_window", "variant": "warm_b_base", "route": "cuda",
            "source": "src/repro_torch/csrc/mega_window.cu",
            "replaces": "src/repro/kernels/efe/mega.py:85",
            "shape": [R_FULL, mg.cfg.n_actions, mg.cfg.topology.n_states],
            "t0": T_WARM, "launches": l_mega["mega_window"],
            "max_abs_err": err, "max_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": dev, "library_device_ms": None}


# ------------------------------------ chaos and fleet graphs on the mega path
def world_bound(state, args, kw, t0: int, dwell: int) -> tuple[float, float]:
    """Least times for one B3 window on a chaos or graph world, (bytes ms,
    operations ms): the fresh window's (``mega_bound``; a graph world's
    M=5 comes with the slots) plus the fault schedules' slices and the
    graph's edge arrays and padded lists read once, and the spill traces
    written once."""
    bytes_ms, ops_ms = mega_bound(state, args, t0, dwell)
    extra = [kw.get("forced_down"), kw.get("speed")]
    g = kw.get("graph")
    nbytes = sum(x.numel() * x.element_size()
                 for x in extra + list(g or ()) if x is not None)
    if g is not None:
        nbytes += args[5].shape[0] * 4 * state.belief.shape[0] * 4
    return bytes_ms + 1e3 * nbytes / HBM_BYTES_PER_S, ops_ms


def mega_world_check(scenario: str, t0: int, phase: str,
                     timed: bool = True) -> dict:
    """B3 on one window of a chaos or graph world at R=4096, from the mega
    path's own state at ``t0``: against its plain version (``mega_check``),
    launched twice with the outputs equal to the bit, then (``timed``)
    beside its plain version and its bound."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    router, env_step, state, est, obs, noise = mega_midrun(
        R_MEGA, t0, "float32", scenario)
    args, kw = mega_window_inputs(router, env_step, noise, R_MEGA, t0)
    fd, sp = kw.get("forced_down"), kw.get("speed")
    live = dict(admin_down_tier_ticks=0 if fd is None else int(fd.sum()),
                slow_tier_ticks=0 if sp is None else int((sp < 1).sum()),
                graph="graph" in kw, modalities=router.n_modalities)
    err = mega_check(router, env_step, state, est, obs, noise, R_MEGA, t0,
                     phase=phase, scenario=scenario, **live)
    n0 = mega_kernel.mega_window_cuda.launches
    out1 = mega_kernel.mega_window_cuda(clone_state(state), est, obs, *args,
                                        **kw)
    per_window = mega_kernel.mega_window_cuda.launches - n0
    out2 = mega_kernel.mega_window_cuda(clone_state(state), est, obs, *args,
                                        **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(flatten(out1).values(),
                                                 flatten(out2).values()))
    del out1, out2
    row = dict(scenario=scenario, r=R_MEGA, t0=t0, max_abs_err=err,
               launches_per_window=per_window, launches_bit_equal=same,
               **live)
    if timed:
        kern = lambda: mega_kernel.mega_window_cuda(state, est, obs, *args,
                                                    **kw)
        plain = lambda: mega.mega_window(state, est, obs, *args, **kw)
        row["ms"] = time_ms(kern)
        row["plain_ms"] = time_ms(plain, warmup=1, iters=3)
        row["device_ms"], ahead = queued_ms(kern)
        bytes_ms, ops_ms = world_bound(state, args, kw, t0, router.dwell)
        row.update(bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes_ms=bytes_ms, ops_ms=ops_ms, queued_ahead=ahead)
        del kern, plain
    emit(phase + "_times" if timed else phase + "_bits", **row)
    if not same:
        raise AssertionError(f"two launches of B3 on {scenario} differ")
    del state, est, obs, args, kw
    torch.cuda.empty_cache()
    return row


def world_row(variant: str, checks: list, main: dict) -> dict:
    """A kernels-line row of B3 on chaos or graph windows: the times of
    ``main``, the worst error over ``checks``."""
    err = max(c["max_abs_err"] for c in checks)
    return {"name": "mega_window", "variant": variant, "route": "cuda",
            "source": "src/repro_torch/csrc/mega_window.cu",
            "replaces": "src/repro/kernels/efe/mega.py:85",
            "scenario": main["scenario"], "r": main["r"], "t0": main["t0"],
            "launches_per_window": main["launches_per_window"],
            "max_abs_err": err, "max_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "device_ms": main["device_ms"], "library_device_ms": None}


def phase_mega_chaos_kernel_vs_plain() -> dict:
    """B3 against its plain version on chaos windows at R=4096, t0=150:
    zone-outage's schedules (its outage has ended by then, ticks 90-149)
    and straggler-storm's (stragglers live; timed), then zone-outage at
    t0=120, inside the outage.  Returns the kernels line's chaos row."""
    phase = "mega_chaos_kernel_vs_plain"
    checks = [mega_world_check("zone-outage", T0_MEGA, phase, timed=False),
              mega_world_check("straggler-storm", T0_MEGA, phase),
              mega_world_check("zone-outage", T0_OUTAGE, phase, timed=False)]
    if checks[2]["admin_down_tier_ticks"] == 0:
        raise AssertionError(f"zone-outage's outage is not live at "
                             f"t0={T0_OUTAGE}")
    return world_row("chaos", checks, checks[1])


def phase_mega_graph_kernel_vs_plain() -> dict:
    """B3 against its plain version on a ring-spillover window at R=4096,
    t0=150 (M=5, every spill field; 11 launches a window), launched twice
    with the outputs equal to the bit, timed.  Returns the kernels line's
    graph row."""
    check = mega_world_check("ring-spillover", T0_MEGA,
                             "mega_graph_kernel_vs_plain")
    if check["launches_per_window"] != api_period() + 1:
        raise AssertionError(f"a graph window took "
                             f"{check['launches_per_window']} launches")
    return world_row("graph", [check], check)


def api_period() -> int:
    from repro_torch import api
    return api.AifRouter().period


def per_tick_vs_mega(scenario: str, r: int) -> dict:
    """``scenario`` at R x T=300 on the per-tick (fused) path and on the
    mega path with the same draws (``TickNoise``): the actions that differ,
    both walls and both results."""
    import dataclasses
    from repro_torch import api
    e = api.Experiment(router="aif", scenario=scenario, n_cells=r,
                       n_windows=T_FULL, seed=0, device=DEVICE)
    out = {}
    for mega in (False, True):
        res = api.run(dataclasses.replace(e, mega=mega),
                      noise=TickNoise(0, DEVICE))
        out[mega] = (res.trace.actions, res.wall_s, res.success_pct,
                     res.offload_frac, res.recovery)
        del res
        torch.cuda.empty_cache()
    diff = int((out[True][0] != out[False][0]).sum())
    n = int(out[True][0].numel())
    return dict(n_cells=r, action_diffs=diff, actions=n, diff_share=diff / n,
                per_tick_wall_s=out[False][1], mega_wall_s=out[True][1],
                per_tick_success_pct=out[False][2],
                mega_success_pct=out[True][2],
                per_tick_offload_frac=out[False][3],
                mega_offload_frac=out[True][3])


def phase_mega_chaos() -> int:
    """The five chaos presets on the mega path at R=4096 x T=300, each with
    its mega control (B3 for every window of both: 60 launches, counted),
    their walls and recovery metrics; then each at R=1024 on the per-tick
    and the mega path with the same draws, with the share of actions that
    differ.  Returns B3's launches over the five runs with their
    controls."""
    from repro_torch import api
    from repro_torch.envsim import chaos
    windows = math.ceil(T_FULL / api_period())
    total = 0
    for scenario in sorted(chaos.CHAOS_PRESETS):
        e = api.Experiment(router="aif", scenario=scenario, n_cells=R_MEGA,
                           n_windows=T_FULL, seed=0, mega=True, device=DEVICE)
        t0 = time.perf_counter()
        res, launches = run_counted(e)
        with_control = time.perf_counter() - t0
        rec = res.recovery
        metrics = dict(success_pct=res.success_pct, p50_ms=res.p50_ms,
                       p95_ms=res.p95_ms, **{k: v for k, v in rec.items()
                                             if isinstance(v, float)})
        q = res.final_carry.belief
        ok = bool(torch.isfinite(q).all()) and float(
            (q.sum(-1) - 1).abs().max()) < 1e-4
        wall = res.wall_s
        del res, q
        torch.cuda.empty_cache()
        cmp = per_tick_vs_mega(scenario, R_FULL)
        emit("mega_chaos", scenario=scenario, n_cells=R_MEGA,
             n_windows=T_FULL, wall_s=wall, with_control_s=with_control,
             launches=launches, recovery=rec, beliefs_ok=ok, **{
                 k: metrics[k] for k in ("success_pct", "p50_ms", "p95_ms")},
             r1024=cmp)
        if launches != dict(NO_LAUNCHES, mega_window=2 * windows):
            raise AssertionError(f"mega {scenario} (with its control) "
                                 f"launched {launches}")
        if not ok or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"mega {scenario}: non-finite metrics "
                                 f"{metrics} or beliefs")
        total += launches["mega_window"]
    return total


def phase_mega_graph() -> int:
    """ring-spillover on the mega path at R=4096 x T=300 (B3: 11 launches a
    window, counted) beside its ``graph="none"`` mega control; the graphed
    run again through the engine with the same draws, equal to the bit,
    with the fleet's mass balance closed; then at R=1024 against the
    per-tick ring-spillover run on the same draws: the actions that differ
    and offload_frac within 1e-5.  Returns B3's launches in the graphed
    run."""
    import dataclasses
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.envsim import batched
    windows = math.ceil(T_FULL / api_period())
    e = api.Experiment(router="aif", scenario="ring-spillover",
                       n_cells=R_MEGA, n_windows=T_FULL, seed=0, mega=True,
                       device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_counted(e)
    ctl, ctl_launches = run_counted(dataclasses.replace(e, graph="none"))
    ctl_nums = dict(control_wall_s=ctl.wall_s,
                    control_launches=ctl_launches,
                    control_success_pct=ctl.success_pct,
                    control_fleet_success=float(ctl.fluid.n_success.sum())
                    / float(ctl.fluid.n_requests.sum()),
                    control_offload_frac=ctl.offload_frac)
    del ctl
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    g = e.resolve_graph()
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, R_MEGA, T_FULL, 1.0, 0, dev, g)
    router = e.resolve_router(scfg, g)
    carry, est, trace = engine.rollout(
        router, None, batched.init_fluid_state(params,
                                               env_step.n_obs_modalities),
        env_step, T_FULL, seed=0)
    bits = (torch.equal(trace.actions, res.trace.actions)
            and torch.equal(trace.env.spill_admitted,
                            res.trace.env.spill_admitted)
            and all(torch.equal(a, b) for a, b in zip(
                flatten(carry).values(), flatten(res.final_carry).values()))
            and np.array_equal(est.n_success.cpu().numpy(),
                               res.fluid.n_success))

    def tot(x):
        return float(x.double().sum())

    offered = tot(est.n_requests)
    accounted = (tot(est.n_success) + tot(est.err_timeout)
                 + tot(est.err_overflow) + tot(est.err_refused)
                 + tot(est.err_restart) + tot(est.backlog))
    mass_rel = abs(accounted - offered) / offered
    nums = dict(wall_s=res.wall_s, launches=launches,
                success_pct=res.success_pct, p50_ms=res.p50_ms,
                p95_ms=res.p95_ms, offload_frac=res.offload_frac,
                modalities=int(res.trace.raw_obs.shape[-1]))
    del res, carry, est, trace
    torch.cuda.empty_cache()
    cmp = per_tick_vs_mega("ring-spillover", R_FULL)
    offload_gap = abs(cmp["mega_offload_frac"] - cmp["per_tick_offload_frac"])
    emit("mega_graph", scenario=e.scenario, n_cells=R_MEGA,
         n_windows=T_FULL, **nums, **ctl_nums, rerun_bit_equal=bits,
         mass_offered=offered, mass_accounted=accounted,
         mass_rel_err=mass_rel, r1024=cmp, offload_gap=offload_gap,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != dict(NO_LAUNCHES, mega_window=windows * (api_period() + 1)):
        raise AssertionError(f"the mega graph run launched {launches}")
    if ctl_launches != dict(NO_LAUNCHES, mega_window=windows):
        raise AssertionError(f"its control launched {ctl_launches}")
    if not bits or mass_rel > 1e-5 or nums["offload_frac"] <= 0.0:
        raise AssertionError(f"the mega graph run is not reproducible to the "
                             f"bit ({bits}), leaks mass ({mass_rel}) or "
                             f"spilled nothing ({nums['offload_frac']})")
    if offload_gap > 1e-5 or not math.isfinite(nums["success_pct"]):
        raise AssertionError(f"mega and per-tick ring-spillover at R=1024 "
                             f"differ in offload by {offload_gap}")
    return launches["mega_window"]


# ------------------------------------------------------ the sharded engine
R_ODD = R_MEGA - 3      # an R that 4 shards pad: 4093 -> 4096
N_SHARDS = 4
R_SHARD_CKPT = 256      # the sharded resume's fleet (4 shards of 64)
R_FLEET, T_FLEET = 1_000_000, 25   # the reference's mega_fleet workload


def shard_mesh() -> list:
    """``N_SHARDS`` shards laid on the one card."""
    return [torch.device(DEVICE)] * N_SHARDS


def block_outputs(outs: list):
    """B3's outputs of the row blocks put together: the carries along
    rows, the (W, r, ...) traces along their cell axis."""
    from repro_torch.api import shard
    dev = torch.device(DEVICE)
    state, est, obs = (shard.gather_rows([o[i] for o in outs], dev)
                       for i in range(3))
    ys = [o[3] for o in outs]
    trace = tuple(torch.cat([y[i] for y in ys], dim=1) for i in range(5))
    win = type(ys[0][5])(*(None if f[0] is None else torch.cat(f, dim=1)
                           for f in zip(*(y[5] for y in ys))))
    return state, est, obs, trace + (win,)


def same_bits(a, b) -> bool:
    from repro_torch.checkpoint.checkpointer import flatten
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def split_window(state, est, obs, args, r_pad: int, n_true: int):
    """The row blocks of one window's carries and noise (clones of the
    state, which the window's pushes write in place), and the blocks."""
    from repro_torch.api import shard
    mesh = shard_mesh()
    r_local = r_pad // len(mesh)
    uniforms, gumbel = args[4], args[5]
    states = shard.split_rows(clone_state(state), mesh, r_local)
    ests = shard.split_rows(est, mesh, r_local)
    obss = shard.split_rows(obs, mesh, r_local)
    return [(states[d], ests[d], obss[d],
             uniforms[:, :, d * r_local:(d + 1) * r_local].contiguous(),
             gumbel[:, d * r_local:(d + 1) * r_local].contiguous(),
             (d * r_local, n_true, r_pad)) for d in range(len(mesh))]


def shard_window_check(scenario: str, state, est, obs, router, env_step,
                       noise, t0: int, r_pad: int, n_true: int) -> dict:
    """B3 on the 4 row blocks of one window against its plain version
    (``core.mega.mega_window_blocks``: per block ``mega_window`` with the
    same row block, or on a graph the blocks launch by launch), launched
    twice with the outputs equal to the bit and, at an R that needs no
    padding, put together against the unsharded B3 window to the bit."""
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    args, kw = mega_window_inputs(router, env_step, noise, r_pad, t0)
    params, arrival, hazard, ov = args[:4]
    n0 = mega_kernel.mega_window_cuda.launches
    out_k = mega_kernel.mega_window_blocks_cuda(
        split_window(state, est, obs, args, r_pad, n_true), params, arrival,
        hazard, ov, t0, **kw)
    launches = mega_kernel.mega_window_cuda.launches - n0
    out_k2 = mega_kernel.mega_window_blocks_cuda(
        split_window(state, est, obs, args, r_pad, n_true), params, arrival,
        hazard, ov, t0, **kw)
    out_p = mega.mega_window_blocks(
        split_window(state, est, obs, args, r_pad, n_true), params, arrival,
        hazard, ov, t0, **kw)
    torch.cuda.synchronize()
    errs = [mega_errors(k, p, t0) for k, p in zip(out_k, out_p)]
    row = dict(scenario=scenario, r=r_pad, n_true=n_true, t0=t0,
               blocks=len(out_k), launches=launches,
               ints_equal=all(e["ints_equal"] for e in errs),
               finite=all(e["finite"] for e in errs),
               max_abs_err=max(e["max_abs_err"] for e in errs),
               max_scaled_err=max(e["max_scaled_err"] for e in errs),
               launches_bit_equal=all(same_bits(a, b)
                                      for a, b in zip(out_k, out_k2)))
    whole = block_outputs(out_k)
    if n_true == r_pad:
        full = mega_kernel.mega_window_cuda(clone_state(state), est, obs,
                                            *args, **kw)
        row["blocks_equal_unsharded"] = same_bits(whole, full)
        del full
    else:
        fin = whole[1]
        row["phantom_inert"] = bool(
            float(fin.n_requests[n_true:].abs().sum()) == 0.0
            and float(fin.tier_requests[n_true:].abs().sum()) == 0.0
            and float(fin.n_restarts[n_true:].abs().sum()) == 0.0
            and float(fin.n_requests[:n_true].sum()) > 0.0)
    del out_k, out_k2, out_p, whole
    return row


def sharded_midrun(scenario: str, n_true: int, t0: int):
    """A sharded mega run on ``scenario`` at ``n_true`` cells padded for 4
    shards on the card, stopped at ``t0``: (router, env_step, gathered
    state, env state, obs carry, noise at t0)."""
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.envsim import batched
    from repro_torch.noise import GeneratorNoise
    dev = torch.device(DEVICE)
    e = api.Experiment(router="aif", scenario=scenario, n_cells=n_true,
                       n_windows=T_FULL, seed=0, mega=True, device=DEVICE)
    spec = api.ShardSpec()
    r_pad, _ = spec.padded(n_true, N_SHARDS)
    g = e.resolve_graph()
    scfg, params, env_step = experiment._build_world_padded(
        e.resolve_topology(), scenario, n_true, T_FULL, 1.0, 0, r_pad,
        N_SHARDS, dev, g)
    router = e.resolve_router(scfg, g)
    noise = GeneratorNoise(0, dev)
    est = batched.init_fluid_state(params, env_step.n_obs_modalities)
    state, est, _, snap = engine.sharded_resumable_rollout(
        router, None, est, env_step, t0, noise, shard=spec, n_cells=n_true,
        reducer=api.FleetMetricsReducer(n_cells=n_true), n_total=T_FULL,
        mesh=shard_mesh())
    return router, env_step, state, est, snap[0], noise, r_pad


def phase_shard_kernel_vs_plain() -> dict:
    """B3 on row blocks: R=4096 at t0=150 as 4 blocks of 1024 on the card,
    on a fresh (paper-burst), a zone-outage and a ring-spillover window
    (M=5), each block within MEGA_TOL of its plain version with the same
    row block, two launches equal to the bit, the blocks put together
    equal to the bit to the unsharded B3 window; then R=4093 padded to
    4096 (ring-spillover, the sharded run's own state at t0=150) with the
    phantom rows inert; then one block of the fresh window timed.
    Returns the kernels line's row."""
    from repro_torch.core import mega
    from repro_torch.kernels.efe import mega as mega_kernel
    phase = "shard_kernel_vs_plain"
    rows = []
    for scenario in ("paper-burst", "zone-outage", "ring-spillover"):
        router, env_step, state, est, obs, noise = mega_midrun(
            R_MEGA, T0_MEGA, "float32", scenario)
        noise_t0 = noise.get_state()
        row = shard_window_check(scenario, state, est, obs, router,
                                 env_step, noise, T0_MEGA, R_MEGA, R_MEGA)
        emit(phase, **row)
        rows.append(row)
        if scenario == "paper-burst":
            noise.set_state(noise_t0)
            args, kw = mega_window_inputs(router, env_step, noise, R_MEGA,
                                          T0_MEGA)
            timed = (state, est, obs, args, kw, router.dwell)
        else:
            del state
        del est, obs
        torch.cuda.empty_cache()
    router, env_step, state, est, obs, noise, r_pad = sharded_midrun(
        "ring-spillover", R_ODD, T0_MEGA)
    row = shard_window_check("ring-spillover", state, est, obs, router,
                             env_step, noise, T0_MEGA, r_pad, R_ODD)
    emit(phase, **row)
    rows.append(row)
    del state, est, obs
    torch.cuda.empty_cache()
    for row in rows:
        ok = (row["ints_equal"] and row["finite"]
              and row["max_scaled_err"] <= MEGA_TOL
              and row["launches_bit_equal"]
              and row.get("blocks_equal_unsharded", True)
              and row.get("phantom_inert", True))
        if not ok:
            raise AssertionError(f"B3 on row blocks disagrees: {row}")
    graph_launches = [r["launches"] for r in rows
                      if r["scenario"] == "ring-spillover"]
    if rows[0]["launches"] != N_SHARDS or graph_launches != [
            N_SHARDS * (api_period() + 1)] * 2:
        raise AssertionError(f"row-block launches {rows}")

    # one block of the fresh window, timed beside its plain version
    state, est, obs, args, kw, dwell = timed
    block = split_window(state, est, obs, args, R_MEGA, R_MEGA)[0]
    st, es, ob, u, g, rb = block
    params, arrival, hazard, ov = args[:4]

    def kern():
        return mega_kernel.mega_window_cuda(st, es, ob, params, arrival,
                                            hazard, ov, u, g, T0_MEGA,
                                            row_block=rb, **kw)

    def plain():
        return mega.mega_window(st, es, ob, params, arrival, hazard, ov, u,
                                g, T0_MEGA, row_block=rb, **kw)

    t = dict(ms=time_ms(kern), plain_ms=time_ms(plain, warmup=1, iters=3))
    t["device_ms"], ahead = queued_ms(kern)
    r_loc = R_MEGA // N_SHARDS
    cut = (params, arrival[:, :r_loc], hazard[:, :r_loc], ov, u, g, T0_MEGA)
    bytes_ms, ops_ms = mega_bound(st, cut, T0_MEGA, dwell)
    t.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             queued_ahead=ahead)
    emit(phase + "_times", scenario="paper-burst", r=R_MEGA,
         block_rows=r_loc, t0=T0_MEGA, **t)
    del timed, state, est, obs, args, block, st, es, ob, u, g
    torch.cuda.empty_cache()
    err = max(r["max_abs_err"] for r in rows)
    return {"name": "mega_window", "variant": "row_blocks", "route": "cuda",
            "source": "src/repro_torch/csrc/mega_window.cu",
            "replaces": "src/repro/kernels/efe/mega.py:85",
            "scenario": "paper-burst", "r": R_MEGA, "block_rows": r_loc,
            "blocks": N_SHARDS, "t0": T0_MEGA, "max_abs_err": err,
            "max_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "device_ms": t["device_ms"],
            "library_device_ms": None}


def phase_shard_small() -> None:
    """The sharded engine on the card against the CPU: R=7 over 4 shards
    (padded to 8), T=30, fused AIF, mega AIF and least_loaded, the same
    draws: every integer of the final carry equal, its floats and the
    metrics within 1e-4."""
    from repro_torch import api
    from repro_torch.api import experiment
    from repro_torch.checkpoint.checkpointer import flatten
    for kw in (dict(router="aif"), dict(router="aif", mega=True),
               dict(router="least_loaded")):
        runs = {}
        for dev in (DEVICE, "cpu"):
            e = api.Experiment(scenario="paper-burst", n_cells=7,
                               n_windows=30, seed=1, device=dev, **kw)
            runs[dev] = experiment._run_sharded(
                e, torch.device(dev), api.ShardSpec(),
                MirroredNoise(1, dev), mesh=[torch.device(dev)] * N_SHARDS)
        gpu, cpu = runs[DEVICE], runs["cpu"]
        fg, fc = flatten(gpu.final_carry), flatten(cpu.final_carry)
        ints = all(torch.equal(fg[k].cpu(), fc[k]) for k in fc
                   if not fc[k].is_floating_point())
        carry_err = max([(fg[k].cpu() - fc[k]).abs().max().item()
                         for k in fc if fc[k].is_floating_point()
                         and fc[k].numel()], default=0.0)
        rel = {k: abs(getattr(gpu, k) - getattr(cpu, k))
               / max(abs(getattr(cpu, k)), 1e-9)
               for k in ("success_pct", "p50_ms", "p95_ms", "obs_frac")}
        emit("shard_small", n_cells=7, shards=N_SHARDS, n_windows=30,
             cells_per_device=gpu.cells_per_device, ints_equal=ints,
             carry_max_abs_err=carry_err, rel_err=rel, **kw)
        if not ints or carry_err > 1e-4 or max(rel.values()) > 1e-4:
            raise AssertionError(f"the sharded engine on the card disagrees "
                                 f"with the CPU ({kw})")


def shard_metrics_gap(a, b) -> float:
    """Largest gap between two runs' success %, obs fraction, offload and
    tier / routed shares."""
    gaps = [abs(a.success_pct - b.success_pct), abs(a.obs_frac - b.obs_frac),
            abs(a.offload_frac - b.offload_frac),
            float(np.abs(a.tier_share - b.tier_share).max()),
            float(np.abs(a.routed_share - b.routed_share).max())]
    return max(gaps)


def phase_shard() -> dict:
    """``Experiment(shard=ShardSpec(devices=1))`` against the unsharded run:
    mega at R=4096 x T=300 and fused at R=1024 x T=300 on paper-burst, the
    final carry and env state equal to the bit, the metrics within 1e-5;
    then the mega experiment and ring-spillover on 4 shards laid on the
    card (B3: 4 x 30 and 4 x 330 launches), the metrics within 1e-4 of the
    unsharded run; and the fused run on 4 shards (B1: 4 x 60 launches),
    whose host loop steps every shard.  Returns B3's launches of the 4-shard
    mega runs by scenario."""
    import dataclasses
    from repro_torch import api
    from repro_torch.api import experiment
    dev = torch.device(DEVICE)
    windows = math.ceil(T_FULL / api_period())
    out = {}
    for name, r, mega in (("mega", R_MEGA, True), ("fused", R_FULL, False)):
        e = api.Experiment(router="aif", scenario="paper-burst", n_cells=r,
                           n_windows=T_FULL, seed=0, mega=mega, device=DEVICE)
        r0, l0 = run_counted(e)
        r1, l1 = run_counted(dataclasses.replace(
            e, shard=api.ShardSpec(devices=1)))
        bits = same_bits(r0.final_carry, r1.final_carry) and all(
            np.array_equal(getattr(r0.fluid, f), getattr(r1.fluid, f))
            for f in ("n_requests", "n_success", "tier_requests",
                      "tier_success", "n_restarts"))
        gap = shard_metrics_gap(r0, r1)
        emit("shard", path=name, shards=1, n_cells=r, n_windows=T_FULL,
             wall_s=r1.wall_s, unsharded_wall_s=r0.wall_s, launches=l1,
             unsharded_launches=l0, bits_equal_unsharded=bits,
             metrics_gap=gap, success_pct=r1.success_pct,
             p95_ms=r1.p95_ms, unsharded_p95_ms=r0.p95_ms)
        if not bits or gap > 1e-5 or l0 != l1:
            raise AssertionError(f"the 1-shard {name} run differs from the "
                                 f"unsharded run (bits {bits}, gap {gap})")
        out[name] = r0
        del r1
        torch.cuda.empty_cache()
    launches = {}
    selecting = math.ceil(T_FULL / api.AifRouter().dwell)
    for scenario, mega in (("paper-burst", True), ("ring-spillover", True),
                           ("paper-burst", False)):
        r = R_MEGA if mega else R_FULL
        e = api.Experiment(router="aif", scenario=scenario, n_cells=r,
                           n_windows=T_FULL, seed=0, mega=mega, device=DEVICE)
        r0 = (out["mega" if mega else "fused"] if scenario == "paper-burst"
              else run_counted(e)[0])
        r4, l4 = counted(lambda: experiment._run_sharded(
            e, dev, api.ShardSpec(), None, mesh=shard_mesh()))
        per_window = api_period() + 1 if scenario == "ring-spillover" else 1
        expect = (dict(NO_LAUNCHES,
                       mega_window=N_SHARDS * windows * per_window) if mega
                  else dict(NO_LAUNCHES,
                            belief_efe_fleet=N_SHARDS * selecting))
        gap = shard_metrics_gap(r0, r4)
        emit("shard", path="mega" if mega else "fused", shards=N_SHARDS,
             scenario=scenario, n_cells=r, n_windows=T_FULL,
             wall_s=r4.wall_s, unsharded_wall_s=r0.wall_s, launches=l4,
             metrics_gap=gap, success_pct=r4.success_pct,
             unsharded_success_pct=r0.success_pct,
             offload_frac=r4.offload_frac,
             cells_per_device=r4.cells_per_device)
        if l4 != expect:
            raise AssertionError(f"the 4-shard {scenario} run launched {l4}")
        if gap > 1e-4 or not math.isfinite(r4.success_pct):
            raise AssertionError(f"the 4-shard {scenario} run is {gap} off "
                                 f"the unsharded run")
        if mega:
            launches[scenario] = l4["mega_window"]
        del r0, r4
        torch.cuda.empty_cache()
    del out
    return launches


def phase_shard_resume() -> None:
    """zone-outage on the mega path at R=256 over 4 shards on the card,
    checkpointed every 100 windows and resumed from the newest checkpoint:
    the final carry, the env state and the fleet metrics equal to the bit
    to the uninterrupted sharded run; and at the engine, a run in two
    chunks against one piece: carry and the reducer's stats equal to the
    bit."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.envsim import batched
    dev = torch.device(DEVICE)
    e = api.Experiment(router="aif", scenario="zone-outage",
                       n_cells=R_SHARD_CKPT, n_windows=T_FULL, seed=0,
                       mega=True, device=DEVICE)
    spec = api.ShardSpec()

    def sharded(x):
        return counted(lambda: experiment._run_sharded(
            x, dev, spec, None, mesh=shard_mesh()))

    r0, l0 = sharded(e)
    d = tempfile.mkdtemp(prefix="chip_smoke_shard_ckpt_")
    try:
        r1, l1 = sharded(dataclasses.replace(e, checkpoint_every=CKPT_EVERY,
                                             checkpoint_dir=d))
        r2, l2 = sharded(dataclasses.replace(e, resume_from=d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    fields = ("success_pct", "p50_ms", "p95_ms", "obs_frac", "offload_frac")

    def equal(a, b):
        return (same_bits(a.final_carry, b.final_carry)
                and all(getattr(a, f) == getattr(b, f) for f in fields)
                and np.array_equal(a.fluid.n_success, b.fluid.n_success))

    # the engine in two chunks against one piece, stats compared raw
    r_pad, _ = spec.padded(R_SHARD_CKPT, N_SHARDS)
    scfg, params, env_step = experiment._build_world_padded(
        e.resolve_topology(), e.scenario, R_SHARD_CKPT, T_FULL, 1.0, 0,
        r_pad, N_SHARDS, dev, None)
    router = e.resolve_router(scfg)
    red = api.FleetMetricsReducer(n_cells=R_SHARD_CKPT)
    kw = dict(shard=spec, n_cells=R_SHARD_CKPT, reducer=red,
              mesh=shard_mesh())

    def fresh():
        return batched.init_fluid_state(params, env_step.n_obs_modalities)

    c_u, e_u, s_u = engine.sharded_rollout(router, fresh(), env_step, T_FULL,
                                           seed=0, **kw)
    half = T_FULL // 2
    c1, e1, _, snap = engine.sharded_resumable_rollout(
        router, None, fresh(), env_step, half, seed=0, n_total=T_FULL, **kw)
    c2, e2, s2, _ = engine.sharded_resumable_rollout(
        router, c1, e1, env_step, T_FULL - half, seed=0, t_begin=half,
        snapshot=snap, **kw)
    s_c = engine.sharded_finalize(s2, shard=spec, reducer=red)
    checks = dict(checkpointed_equal=equal(r0, r1), resumed_equal=equal(r0, r2),
                  engine_carry_equal=same_bits(c_u, c2),
                  engine_env_equal=same_bits(e_u, e2),
                  engine_stats_equal=same_bits(s_u, s_c))
    emit("shard_resume", scenario=e.scenario, n_cells=R_SHARD_CKPT,
         shards=N_SHARDS, n_windows=T_FULL, checkpoint_every=CKPT_EVERY,
         resume_points=[r1.resume_points, r2.resume_points],
         wall_s=[r0.wall_s, r1.wall_s, r2.wall_s],
         launches=[l0["mega_window"], l1["mega_window"], l2["mega_window"]],
         **checks)
    if not all(checks.values()) or min(l0["mega_window"],
                                       l2["mega_window"]) < 1:
        raise AssertionError(f"the sharded resume is not equal to the bit: "
                             f"{checks}")
    del r0, r1, r2, c_u, e_u, c1, e1, c2, e2
    torch.cuda.empty_cache()


def phase_mega_fleet() -> None:
    """The reference's acceptance workload, ``Experiment(router=
    "least_loaded", n_cells=1_000_000, n_windows=25, shard="auto")`` (one
    card: one shard), beside the unsharded engine's rollout of the same
    world (its trace kept): wall_s, cell-windows/s and the peak device
    memory of each."""
    from repro_torch import api
    from repro_torch.api import engine, experiment
    from repro_torch.envsim import batched
    dev = torch.device(DEVICE)
    e = api.Experiment(router="least_loaded", scenario="paper-burst",
                       n_cells=R_FLEET, n_windows=T_FLEET, seed=0,
                       shard="auto", device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = run_counted(e)
    with_build = time.perf_counter() - t0
    sharded = dict(wall_s=res.wall_s, with_build_s=with_build,
                   cell_windows_per_s=R_FLEET * T_FLEET / res.wall_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   success_pct=res.success_pct, p50_ms=res.p50_ms,
                   p95_ms=res.p95_ms, cells_per_device=res.cells_per_device,
                   launches=launches)
    finite = all(math.isfinite(v) for v in (res.success_pct, res.p95_ms))
    del res
    torch.cuda.empty_cache()
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, R_FLEET, T_FLEET, 1.0, 0, dev)
    router = e.resolve_router(scfg)
    est = batched.init_fluid_state(params)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, est, trace = engine.rollout(router, router.init_carry(R_FLEET, dev),
                                   est, env_step, T_FLEET, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dense = dict(wall_s=wall, cell_windows_per_s=R_FLEET * T_FLEET / wall,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del est, trace, params, env_step
    torch.cuda.empty_cache()
    emit("mega_fleet", router="least_loaded", n_cells=R_FLEET,
         n_windows=T_FLEET, sharded=sharded, unsharded=dense)
    if not finite or launches != NO_LAUNCHES:
        raise AssertionError(f"the million-cell run failed: {sharded}")


# ---------------------------------------------------- attention and serving
def attn_operands(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                  dtype: torch.dtype, seed: int = 0):
    """Seeded q (b, sq, hq, d) and k/v (b, skv, hkv, d) on the card."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    return q, k, v


def ragged_positions(b: int, s: int, seed: int = 0) -> torch.Tensor:
    """(b,) int32 decode positions on the card, the first two 0 and s-1."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, s, b)
    pos[:2] = (0, s - 1)
    return torch.from_numpy(pos.astype(np.int32)).to(DEVICE)


def attn_cases():
    """(name, kernel call, plain call, models, dtype) of every B4/B5
    check, in bf16 and f32.  ``models`` holds calls of ``ref``'s plain
    model of the kernel's algebra (``model``: B5's chunks and merge at the
    wrapper's chunk; B4's two-half P product in bf16, with ``p_hi_only``
    and the float32 ``f32`` beside it), or is None (B4 in f32).  Shapes:
    those the serve phase (b=1 Sq=1024 prefill, B=8 S=2048 decode) and the
    multitier phase (b=1 prefill at the 128-token bucket, decode over
    max_len 512 lanes at the tiers' B = 2, 3, 8) give each kernel, a
    chunked prefill (q_offset, ragged Sq), gemma3-1b's heads (D=256, window
    512), mixtral-8x7b's (Hq=32, Hkv=8, D=128) past its 4096-token window
    (prefill at the moe_serve phase's 8192 bucket, decode over its 8192
    slots with positions on both sides of 4096), seamless-m4t-medium's
    (16/16, D=64) unmasked for its encoder (Sq=Skv=1024) and its
    cross-attention (Sq=16 against 1024 frames), B5 over the cross cache at
    position S_enc - 1, the decoder's causal self-attention at the encdec
    phase's shapes (prefill over the 16-token prefix, decode over 80
    slots), jamba-1.5-large's (Hq=64, Hkv=8, D=128: causal prefill at b=1,
    Sq=Skv=1024; decode at B=8 over 2048 slots, ragged positions with 0
    and S-1), and the smoke configs' head dims (f32)."""
    from repro_torch.kernels.attention import flash, ref

    def prefill(name, b, sq, skv, hq, hkv, d, dtype, seed, **kw):
        q, k, v = attn_operands(b, sq, skv, hq, hkv, d, dtype, seed)
        # bf16 runs prefill_tc_kernel, whose key tile (PrefillTC<D>::kBK)
        # is 32 keys at D=256 and 64 below; f32 runs the CUDA-core kernel.
        two_half = lambda p_lo: lambda: ref.prefill_two_half_model(  # noqa
            q, k, v, block_k=32 if d >= 256 else 64, p_lo=p_lo, **kw)
        models = None if dtype != torch.bfloat16 else dict(
            model=two_half(True), p_hi_only=two_half(False),
            f32=lambda: ref.mha_ref(q.float(), k.float(), v.float(), **kw))
        return (f"prefill_{name}_{str(dtype)[6:]}",
                lambda: flash.flash_prefill(q, k, v, **kw),
                lambda: ref.mha_ref(q, k, v, **kw), models, dtype)

    def decode(name, b, s, hq, hkv, d, dtype, seed, pos=None, **kw):
        q, k, v = attn_operands(b, 1, s, hq, hkv, d, dtype, seed)
        pos = ragged_positions(b, s, seed) if pos is None else pos
        return (f"decode_{name}_{str(dtype)[6:]}",
                lambda: flash.flash_decode(q, k, v, position=pos, **kw),
                lambda: ref.decode_ref(q, k, v, position=pos, **kw),
                dict(model=lambda: ref.decode_split_model(
                    q, k, v, position=pos, chunk=flash.decode_chunk(b, s, hkv),
                    **kw)), dtype)

    # the moe_serve phase's decode: both sides of the window's edge
    moe_pos = torch.tensor([0, MOE_MAX_LEN - 1, MOE_WINDOW - 1, MOE_WINDOW,
                            MOE_WINDOW + 1, 2500, 4731, 6000],
                           dtype=torch.int32, device=DEVICE)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            prefill("internlm2_1024", 1, 1024, 1024, 16, 8, 128, dtype, 0),
            decode("internlm2_b8_s2048", 8, 2048, 16, 8, 128, dtype, 1),
            prefill("internlm2_bucket128", 1, 128, 128, 16, 8, 128, dtype, 7),
            *(decode(f"internlm2_b{b}_s512", b, 512, 16, 8, 128, dtype, 8 + b)
              for b in (2, 3, 8)),
            prefill("chunk_q_offset_667_sq_333", 1, 333, 1000, 16, 8, 128,
                    dtype, 2, q_offset=667),
            prefill("gemma3_window512", 1, 1024, 1024, 4, 1, 256, dtype, 3,
                    window=512),
            decode("gemma3_window512", 8, 2048, 4, 1, 256, dtype, 4,
                   window=512),
            prefill("mixtral_8192_window4096", 1, MOE_MAX_LEN, MOE_MAX_LEN,
                    32, 8, 128, dtype, 30, window=MOE_WINDOW),
            decode("mixtral_b8_s8192_window4096", 8, MOE_MAX_LEN, 32, 8, 128,
                   dtype, 31, pos=moe_pos, window=MOE_WINDOW),
            prefill("seamless_encoder_b8_1024", 8, 1024, 1024, 16, 16, 64,
                    dtype, 32, causal=False),
            prefill("seamless_cross_b8_16x1024", 8, 16, 1024, 16, 16, 64,
                    dtype, 33, causal=False),
            decode("seamless_cross_b8_s1024_last", 8, 1024, 16, 16, 64,
                   dtype, 34, pos=1023),
            prefill("seamless_self_b8_16", ENCDEC_B, ENCDEC_PREFIX,
                    ENCDEC_PREFIX, 16, 16, 64, dtype, 35),
            decode("seamless_self_b8_s80", ENCDEC_B,
                   ENCDEC_PREFIX + ENCDEC_STEPS, 16, 16, 64, dtype, 36),
            prefill("jamba_1024", 1, 1024, 1024, 64, 8, 128, dtype, 50),
            decode("jamba_b8_s2048", 8, 2048, 64, 8, 128, dtype, 51)]
    for d in (16, 32, 64):                # the smoke configs' head dims
        cases += [prefill(f"d{d}_window48", 2, 200, 200, 8, 2, d,
                          torch.float32, d, window=48),
                  decode(f"d{d}", 2, 200, 8, 2, d, torch.float32, d)]
    # serve_multitier's light and medium tiers (d_model 32 and 48 over 4
    # heads): a 16-token prompt in its 16-token bucket, decode waves of
    # max_batch 2 and 3 over 64 slots; and ragged, windowed twins
    for dtype in (torch.bfloat16, torch.float32):
        for d, b in zip(EXAMPLE_HEAD_DIMS, (2, 3)):
            cases += [
                prefill(f"multitier_d{d}_16", 1, 16, 16, 4, 2, d, dtype,
                        70 + d),
                decode(f"multitier_d{d}_b{b}_s64", b, 64, 4, 2, d, dtype,
                       80 + d),
                prefill(f"d{d}_window48", 2, 200, 200, 8, 2, d, dtype, d,
                        window=48),
                prefill(f"d{d}_q_offset_67_sq_133", 1, 133, 200, 8, 2, d,
                        dtype, d + 1, q_offset=67),
                decode(f"d{d}_window48", 3, 200, 8, 2, d, dtype, d + 2,
                       window=48)]
    return cases


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each element of ``x`` (float32 holding
    bf16 values): 2^(e - 8) for |x| in [2^(e-1), 2^e), 0 at 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def attn_model_check(name: str, out_k: torch.Tensor, models: dict,
                     dtype: torch.dtype) -> dict:
    """Hold a B4/B5 output against ``models["model"]``, the plain model of
    its kernel's algebra on the same inputs (float32).  float32: within
    ``MODEL_TOL_F32``.  bfloat16: the model rounded to bf16 within one bf16
    ulp plus the float32 bar (the kernel sums in another order before it
    rounds); for B4 the kernel must also match the two-half model on more
    elements than ``models["p_hi_only"]`` (P V on one bf16 p), which ties
    the kernel to the p_hi/p_lo split, and both models' errors against
    float32 attention on the same values are reported.  Returns the
    line's fields."""
    want = models["model"]()
    got = out_k.float()
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        row = dict(max_abs_err=err, tol=MODEL_TOL_F32)
        ok = err <= MODEL_TOL_F32
    else:
        wb = want.bfloat16().float()
        diff = (got - wb).abs()
        excess = (diff - bf16_ulp(wb)).max().item()
        ulps = (diff / bf16_ulp(wb).clamp_min(2.0 ** -133)).max().item()
        row = dict(max_abs_err=diff.max().item(), max_ulps=ulps,
                   max_excess_over_one_ulp=excess, tol=ATTN_TOL[torch.float32],
                   share_differing=(diff != 0).float().mean().item())
        ok = excess <= ATTN_TOL[torch.float32]
        if "p_hi_only" in models:
            hi, ref32 = models["p_hi_only"](), models["f32"]()
            share_hi = (got != hi.bfloat16().float()).float().mean().item()
            row.update(share_differing_from_p_hi_only=share_hi,
                       model_err_vs_f32=(want - ref32).abs().max().item(),
                       p_hi_only_err_vs_f32=(hi - ref32).abs().max().item())
            ok = ok and row["share_differing"] < share_hi
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the model of "
                             f"its algebra: {row}")
    return row


def phase_attn_kernel_vs_plain() -> dict:
    """B4 and B5 against their plain versions on the same inputs on the
    card, each kernel launched twice (the two outputs must be equal to the
    bit), and against the plain model of its algebra
    (:func:`attn_model_check`); returns the max abs error of each kernel
    against its plain version."""
    errs = {"flash_prefill": 0.0, "flash_decode": 0.0}
    for name, kern, plain, models, dtype in attn_cases():
        out_k, out_k2, out_p = kern(), kern(), plain()
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        finite = bool(torch.isfinite(out_k.float()).all())
        same_bits = bool(torch.equal(out_k, out_k2))
        emit("attn_kernel_vs_plain", case=name, max_abs_err=err,
             tol=ATTN_TOL[dtype], plain_max_abs=out_p.abs().max().item(),
             shape=list(out_k.shape), repeat_bits_equal=same_bits)
        if not (finite and out_k.dtype == out_p.dtype
                and out_k.shape == out_p.shape and err <= ATTN_TOL[dtype]):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max abs err {err}")
        if not same_bits:
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 f"differ")
        if models is not None:
            emit("attn_kernel_vs_model", case=name,
                 **attn_model_check(name, out_k, models, dtype))
        kernel = "flash_prefill" if name.startswith("prefill") else \
            "flash_decode"
        errs[kernel] = max(errs[kernel], err)
    torch.cuda.empty_cache()
    return errs


def serve_requests(engine, prompts, n_new: int):
    """Submit ``prompts`` and step ``engine`` until all are answered:
    (requests, wall seconds, synchronized)."""
    from repro_torch.serving import Request
    reqs = [Request(id=i, tokens=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    while not all(r.finished_at for r in reqs):
        engine.step()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def serve_launches(cfg, admissions: int, waves: int) -> dict:
    """The kernel launches an engine of ``cfg`` makes for ``admissions``
    prefills and ``waves`` decode waves: B4 per attention layer per
    admission and B5 per attention layer per wave, B6 per Mamba layer per
    admission (its decode is plain PyTorch); a hybrid stack mixes both."""
    n_mamba = sum(cfg.layer_kind(i).startswith("mamba")
                  for i in range(cfg.n_layers))
    n_attn = cfg.n_layers - n_mamba
    return dict(NO_LAUNCHES, flash_prefill=n_attn * admissions,
                flash_decode=n_attn * waves, ssd_scan=n_mamba * admissions)


def host_mem_gb() -> dict:
    """The host's available memory (``MemAvailable``) and this process's
    peak resident set, in GB."""
    import resource
    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) for line in f}
    return dict(available_gb=info["MemAvailable"] * 1024 / 1e9,
                total_gb=info["MemTotal"] * 1024 / 1e9,
                process_peak_rss_gb=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9)


class DenseCalls:
    """Within the block, the MoE's dense switch
    (``moe.DENSE_MODE_MAX_TOKENS``) set to ``max_tokens`` and the calls of
    ``Moe.dense`` counted in ``.calls``."""

    def __init__(self, max_tokens: int):
        self.max_tokens, self.calls = max_tokens, 0

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = moe.DENSE_MODE_MAX_TOKENS, moe.Moe.dense
        dense = moe.Moe.dense

        def counting(module, *args):
            self.calls += 1
            return dense(module, *args)
        moe.DENSE_MODE_MAX_TOKENS, moe.Moe.dense = self.max_tokens, counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.DENSE_MODE_MAX_TOKENS, moe.Moe.dense = self.saved


def phase_serve_small(arch: str = SERVE_ARCH, lengths=(64, 64, 64, 64),
                      phase: str = "serve_small", weights=None,
                      dense_max: int = 0):
    """``arch``'s widths at 2 layers in f32: the card's engine (kernels)
    against the CPU's (plain versions) with the same weights, 4 prompts of
    ``lengths`` tokens (right-padded to their bucket), 8 new tokens each:
    tokens equal, and the logits of the first prompt's prefill and of one
    decode step after it within 1e-4 relative (with random weights greedy
    decode can repeat one token, so the logits carry the check).  The
    weights are drawn once on the card and copied to the host; ``weights``
    (the pair this returns) reuses them.  ``dense_max`` > 0 sets the MoE's
    dense switch to it on both sides for this run only: every call of at
    most that many tokens (each decode step) takes ``Moe.dense``, whose
    calls are counted and must be one per MoE layer per decode step."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_arch(arch).full, n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    host_before = host_mem_gb()
    torch.cuda.reset_peak_memory_stats()
    if weights is None:
        on_card = build_model(cfg, DEVICE, seed=0).state_dict()
        weights = (on_card, {k: v.cpu() for k, v in on_card.items()})
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in lengths]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    outs, logits, dense_calls, want_dense = {}, {}, {}, {}
    for dev, sd in ((DEVICE, weights[0]), ("cpu", weights[1])):
        eng = ServingEngine(cfg, sd, max_batch=4, max_len=128, device=dev)
        with DenseCalls(dense_max) as dense:
            lg, caches = eng.model.prefill(torch.tensor(prompts[:1]),
                                           max_len=128)
            lg2, _ = eng.model.decode_step(
                lg[:, -1].argmax(-1, keepdim=True), caches, lengths[0])
            logits[dev] = torch.cat([lg, lg2], 1).cpu()
            del caches
            (reqs, _), launches, _, b5_calls = device_counted(
                lambda: serve_requests(eng, prompts, 8))
        outs[dev] = [r.output for r in reqs]
        dense_calls[dev] = dense.calls
        # Moe.dense's Python runs at the decode step above, at each eager
        # wave and at the recording of the wave's graph, never at a replay
        python_waves = (eng.busy_steps - eng.graph_waves
                        + (eng._graph is not None))
        want_dense[dev] = n_moe * (python_waves + 1) if dense_max else 0
        if dev == DEVICE:
            want = serve_launches(cfg, len(prompts), eng.busy_steps)
            card_launches, card_b5_calls = launches, b5_calls
            graph_waves = eng.graph_waves
        del eng
    rel = ((logits[DEVICE] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    emit(phase, arch=arch, n_layers=2, dtype="float32",
         kinds=[cfg.layer_kind(i) for i in range(cfg.n_layers)],
         prompt_lengths=list(lengths),
         tokens_equal=outs[DEVICE] == outs["cpu"], logits_rel_err=rel,
         launches=card_launches, expected_launches=want,
         b5_wrapper_calls=card_b5_calls, graph_waves=graph_waves,
         moe_dense_max_tokens=dense_max, moe_dense_calls=dense_calls,
         expected_moe_dense_calls=want_dense,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         host_mem_before=host_before, host_mem_after=host_mem_gb(),
         tokens=outs[DEVICE])
    if outs[DEVICE] != outs["cpu"] or not rel <= 1e-4:
        raise AssertionError(f"{phase}: the card's engine disagrees "
                             f"with the CPU's (logits rel err {rel})")
    if card_launches != want:
        raise AssertionError(f"{phase}: the card's engine launched "
                             f"{card_launches}, expected {want}")
    if dense_calls != want_dense:
        raise AssertionError(f"{phase}: Moe.dense ran {dense_calls} times, "
                             f"expected {want_dense}")
    torch.cuda.empty_cache()
    return weights


def phase_serve(arch: str = SERVE_ARCH, n_new: int = 64,
                phase: str = "serve", n_layers: int | None = None,
                max_len: int = 2048, prompt_range=(1000, 1025)):
    """The full ``arch`` (bf16; all layers, or its first ``n_layers``)
    answering 8 prompts of lengths drawn from ``prompt_range`` with
    ``n_new`` new tokens each, 8 lanes of ``max_len``; returns (its
    weights, launches, prompt lengths)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.serving import ServingEngine
    full = get_arch(arch).full
    cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, max_batch=8, max_len=max_len, seed=0,
                        device=DEVICE)
    rng = np.random.default_rng(1)
    lengths = rng.integers(*prompt_range, 8)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in lengths]
    (reqs, wall), launches, _, b5_calls = device_counted(
        lambda: serve_requests(eng, prompts, n_new))
    waves = eng.busy_steps
    want = serve_launches(cfg, len(prompts), waves)
    tokens = sum(len(r.output) for r in reqs)
    ok = all(len(r.output) == n_new
             and all(0 <= t < cfg.vocab_size for t in r.output)
             for r in reqs)
    emit(phase, arch=arch, n_layers=cfg.n_layers,
         published_n_layers=full.n_layers,
         kinds=sorted({cfg.layer_kind(i) for i in range(cfg.n_layers)}),
         window=cfg.sliding_window if cfg.attn_type == "swa" else 0,
         params=cfg.param_count(), dtype=cfg.param_dtype, max_batch=8,
         max_len=max_len, prompt_lengths=[int(n) for n in lengths],
         new_tokens=n_new, decode_waves=waves, wall_s=wall,
         tokens_per_s=tokens / wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, expected_launches=want, outputs_ok=ok,
         b5_wrapper_calls=b5_calls, graph_waves=eng.graph_waves,
         wall_under_device_trace=True, first_tokens=reqs[0].output[:8])
    if launches != want or waves != n_new - 1 or not ok:
        raise AssertionError(f"{phase} launched {launches} over {waves} "
                             f"waves, expected {want}; outputs ok: {ok}")
    serve_breakdown(eng, prompts[0], lengths, arch)
    weights = eng.model.state_dict()
    del eng
    torch.cuda.empty_cache()
    return weights, launches, lengths


def host_ms(fn, iters: int = 3) -> float:
    """Median wall ms of one synchronized call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_ms(fn) -> dict:
    """Device time of one call from a ``torch.profiler`` trace: all kernels
    and copies, those of B4 (``prefill_tc_kernel``, or ``prefill_kernel``
    in f32), B5 (``decode_split_kernel`` and ``decode_merge_kernel``) and
    B6 (``ssd_scan_kernel`` in f32; ``ssd_state_tc_kernel``,
    ``ssd_pass_kernel`` and ``ssd_out_tc_kernel`` in bf16), and the six
    kernels that took longest."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"all": 0.0, "b4": 0.0, "b5": 0.0, "b6": 0.0}
    by_kernel = []
    for e in prof.key_averages():
        # device-side events only: an operator's own entry repeats the time
        # of the kernels it launched
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        ms = e.self_device_time_total / 1e3
        out["all"] += ms
        out["b4"] += ms if re.search(r"prefill_(tc_)?kernel", e.key) else 0.0
        out["b5"] += ms if re.search(r"decode_(split|merge)_kernel",
                                     e.key) else 0.0
        out["b6"] += ms if re.search(
            r"ssd_(scan|state_tc|pass|out_tc)_kernel", e.key) else 0.0
        if ms > 0:
            by_kernel.append((ms, e.count, e.key[:80]))
    out["top"] = sorted(by_kernel, reverse=True)[:6]
    return out


def serve_breakdown(eng, prompt, lengths, arch: str) -> None:
    """Where the serve phase's time goes: one admission prefill of the
    first prompt at its bucket, one 8-slot decode wave run eagerly
    (``decode_wave_eager``: the model's ``decode_step``, each slot at its
    prompt length + 31) and, where the engine recorded its wave, one replay
    of that graph (``decode_wave_replay``: the decode step and the argmax
    at the engine's last positions, as its waves ran), host wall
    (synchronized) beside the device time a profiler trace shows."""
    model = eng.model
    bucket = eng._bucket(len(prompt))
    toks = torch.tensor([list(prompt) + [0] * (bucket - len(prompt))],
                        device=DEVICE)
    pos = torch.from_numpy(np.asarray(lengths, np.int64) + 31).to(DEVICE)
    last = eng.last_tokens

    def prefill():
        return model.prefill(toks, max_len=eng.max_len,
                             last_index=len(prompt) - 1)

    def wave():
        return model.decode_step(last, eng.caches, pos)

    calls = [("prefill", prefill), ("decode_wave_eager", wave)]
    if eng._graph is not None:
        calls.append(("decode_wave_replay", eng._graph.replay))
    emit("serve_breakdown", arch=arch, bucket=bucket, **breakdown(calls))


def breakdown(calls) -> dict:
    """Host wall ms (synchronized) and profiler device ms of each named
    call, with the device's idle share."""
    parts = {}
    for name, fn in calls:
        wall = host_ms(fn)
        dev = device_ms(fn)
        parts[name] = dict(host_ms=wall, device_ms=dev["all"],
                           b4_ms=dev["b4"], b5_ms=dev["b5"],
                           b6_ms=dev["b6"],
                           top_kernels_ms_count_name=dev["top"],
                           device_idle_share=(None if dev["all"] <= 0 else
                                              max(0.0, 1 - dev["all"] / wall)))
    return parts


def phase_multitier(weights) -> dict:
    """AIF-routed multi-tier serving: three engines with the serve phase's
    weights, 60 ticks of Poisson arrivals."""
    from repro_torch.configs import get_arch
    from repro_torch.core import DiscretizationConfig
    from repro_torch.envsim.routers import AifRouter
    from repro_torch.serving import (MultiTierServer, ServingEngine,
                                     TierRuntime)
    cfg = get_arch(SERVE_ARCH).full
    tiers = [TierRuntime(ServingEngine(cfg, weights, max_batch=mb,
                                       max_len=512, name=name,
                                       device=DEVICE), steps_per_tick=st)
             for name, mb, st in (("light", 2, 1), ("medium", 3, 1),
                                  ("heavy", 8, 3))]
    disc = DiscretizationConfig(latency_edges_s=(3.0, 6.0),
                                rps_edges=(3.0, 6.0), queue_edges=(3.0, 10.0))
    router = AifRouter(disc=disc, seed=0, device=DEVICE)
    srv = MultiTierServer(tiers, router, slo_ticks=8, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, launches, _, b5_calls = device_counted(lambda: srv.run(
        n_ticks=60, arrival_rate=4.0, prompt_len=128, max_new_tokens=16))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    admitted = sum(len(t.engine.completed) + t.engine.active_count
                   for t in tiers)
    waves = sum(t.engine.busy_steps for t in tiers)
    want = serve_launches(cfg, admitted, waves)
    routed = out["tier_routed"]
    weights_ok = all(np.isfinite(w).all() and abs(w.sum() - 1) < 1e-9
                     for w in srv.weights_trace)
    emit("multitier", arch=SERVE_ARCH, n_ticks=60, completed=out["completed"],
         p50_ticks=out["p50_ticks"], p95_ticks=out["p95_ticks"],
         slo_violation_rate=out["slo_violation_rate"],
         tier_share=[float(x) for x in routed / max(routed.sum(), 1)],
         tier_completed=[int(x) for x in out["tier_completed"]],
         mean_weights=[float(x) for x in out["mean_weights"]],
         late_weights=[float(x) for x in out["late_weights"]],
         wall_s=wall, admitted=admitted, decode_waves=waves,
         graph_waves=sum(t.engine.graph_waves for t in tiers),
         b5_wrapper_calls=b5_calls, launches=launches,
         expected_launches=want)
    if launches != want or out["completed"] <= 0 or not weights_ok:
        raise AssertionError(f"multitier: launches {launches} (expected "
                             f"{want}), completed {out['completed']}, "
                             f"weights ok {weights_ok}")
    del tiers, srv
    torch.cuda.empty_cache()
    return launches



# ------------------------------------------------- the event simulator
T_EVENT_SMALL = 300       # event_small's control windows (one a second)
EVENT_DURATION_S = 600.0  # event_table1: 3 runs x 10 simulated minutes
EVENT_RUNS = 3
T_EVENT_PROFILE = 100     # windows of the AIF tick under the profiler


class RecordingNoise(MirroredNoise):
    """:class:`MirroredNoise` that keeps each tick's Gumbel draw (on the
    host), so a flip can be read against the draw that decided it."""

    def __init__(self, seed: int, device: str):
        super().__init__(seed, device)
        self.gumbels = {}

    def gumbel(self, t, shape):
        g = self.src.gumbel(t, shape)
        self.gumbels[t] = g[0]
        return g.to(self.device)


class GTrace:
    """An event-simulator router around a port ``AifRouter`` that keeps
    each tick's G (expected free energy of every action) on the host."""

    def __init__(self, router):
        self.router, self.g = router, []

    @property
    def actions(self):
        return self.router.actions

    def __call__(self, snapshot):
        w = self.router(snapshot)
        self.g.append(self.router.last_info.efe.g[0].cpu())
        return w


def event_result_diffs(a, b) -> list:
    """Fields of two simulator ``RunResult``s that differ (arrays in value
    or dtype, scalars in value or type)."""
    import dataclasses
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y))
        else:
            same = x == y and type(x) is type(y)
        if not same:
            out.append(f.name)
    return out


def phase_event_small() -> None:
    """The port's AifRouter on the paper's world (``SimConfig()``, 50 RPS),
    T_EVENT_SMALL windows on the card and on the CPU, both fed one host
    generator's draws: the action traces and the two ``RunResult``s equal.
    A flip passes only at a near-tie: at the first window whose action
    differs, the two actions' scores (``-β G + gumbel``) must lie within
    1e-4 |G| of each other (in G's units) on both devices; the traces
    before it must be equal, and comparing stops there."""
    from repro_torch.envsim import AifRouter, SimConfig, run_experiment
    runs, traces, noises, launches = {}, {}, {}, {}
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        noises[side] = RecordingNoise(0, dev)
        traces[side] = GTrace(AifRouter(seed=0, noise=noises[side],
                                        device=dev))
        runs[side], launches[side] = counted(lambda: run_experiment(
            traces[side], SimConfig(), float(T_EVENT_SMALL), seed=0))
    gpu, cpu = runs["card"], runs["cpu"]
    card_launches = launches["card"]
    beta = traces["card"].router.cfg.beta
    differ = np.nonzero(gpu.action_trace != cpu.action_trace)[0]
    fields = dict(n_windows=T_EVENT_SMALL, launches=card_launches,
                  n_requests=cpu.n_requests, success_rate=cpu.success_rate,
                  p50_ms=cpu.p50_ms, distinct_actions=len(set(cpu.action_trace)))
    if differ.size == 0:
        diffs = event_result_diffs(gpu, cpu)
        emit("event_small", actions_equal=True, results_differ=diffs,
             **fields)
        if diffs:
            raise AssertionError(f"event_small: equal actions but the "
                                 f"RunResults differ in {diffs}")
    else:
        w = int(differ[0])
        a1, a2 = int(gpu.action_trace[w]), int(cpu.action_trace[w])
        gaps, bars = {}, {}
        for side in ("card", "cpu"):
            g = traces[side].g[w].double()
            gum = noises[side].gumbels[w].double()
            score = -beta * g + gum
            gaps[side] = float(abs(score[a1] - score[a2])) / beta
            bars[side] = 1e-4 * float(max(abs(g[a1]), abs(g[a2])))
        prefix_ok = (np.array_equal(gpu.weights_trace[:w],
                                    cpu.weights_trace[:w])
                     and np.array_equal(gpu.p95_trace[:w + 1],
                                        cpu.p95_trace[:w + 1])
                     and np.array_equal(gpu.error_trace[:w + 1],
                                        cpu.error_trace[:w + 1]))
        emit("event_small", actions_equal=False, flip_window=w,
             flip_actions={"card": a1, "cpu": a2}, gap_in_g=gaps,
             bar=bars, prefix_equal=prefix_ok, **fields)
        if not prefix_ok or any(gaps[k] > bars[k] for k in gaps):
            raise AssertionError(f"event_small: the card's action at window "
                                 f"{w} differs from the CPU's away from a "
                                 f"near-tie (gap {gaps}, bar {bars})")
    if card_launches != NO_LAUNCHES:
        raise AssertionError(f"event_small launched {card_launches}: the "
                             f"single-agent tick reaches no kernel")


def event_window_breakdown(aif_run0, aif_wall_s: float) -> dict:
    """Where an AIF control window's host time goes, on the first run of
    event_table1's AIF row rerun window by window (same seeds: the result
    must equal that run's): the snapshot, the tick (queued and waited for
    by its action read), the weights' copy back to the host, and the
    world's window; then the tick's device time from a profiler trace of
    T_EVENT_PROFILE windows, and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.envsim import AifRouter, EdgeSimulator, SimConfig
    cfg = SimConfig()
    n = int(round(EVENT_DURATION_S))
    router = AifRouter(seed=0, device=DEVICE)
    sim = EdgeSimulator(cfg, seed=0)
    parts = {"snapshot": 0.0, "tick": 0.0, "copy": 0.0, "world": 0.0}
    torch.cuda.synchronize()
    for _ in range(n):
        t0 = time.perf_counter()
        snap = sim.snapshot()
        t1 = time.perf_counter()
        w_dev = router.step(snap)
        t2 = time.perf_counter()
        w = w_dev.cpu().numpy().astype(np.float64)
        t3 = time.perf_counter()
        sim.run_window(w)
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k] += dt
    host_ms = {k: 1e3 * v / n for k, v in parts.items()}
    same_run = (sim.n_requests == aif_run0.n_requests
                and sim.n_success == aif_run0.n_success
                and router.actions == list(aif_run0.action_trace))
    # the tick's device time: T_EVENT_PROFILE windows of a fresh run
    router = AifRouter(seed=0, device=DEVICE)
    sim = EdgeSimulator(cfg, seed=0)
    snaps = []
    for _ in range(T_EVENT_PROFILE):
        snaps.append(sim.snapshot())
        sim.run_window(router(snaps[-1]))
    router = AifRouter(seed=0, device=DEVICE)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for snap in snaps:
            router.step(snap)
        end.record()
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU)
    tick_device_ms = busy_ms / T_EVENT_PROFILE
    window_ms = sum(host_ms.values())
    aif_windows = EVENT_RUNS * n
    out = dict(windows=n, host_ms_per_window=window_ms,
               host_ms=host_ms, equals_run0=same_run,
               tick_device_ms=tick_device_ms,
               tick_event_ms=start.elapsed_time(end) / T_EVENT_PROFILE,
               device_ops_per_tick=kernels / T_EVENT_PROFILE,
               idle_share_window=1.0 - tick_device_ms / window_ms,
               idle_share_aif_rows=1.0 - tick_device_ms * aif_windows
               / (1e3 * aif_wall_s))
    if not same_run:
        raise AssertionError("event_table1: the AIF run rerun window by "
                             "window differs from the same seeds' run")
    return out


def phase_event_table1() -> None:
    """The paper's Table-1 protocol at CI speed on the card: the seven
    event-engine strategies, EVENT_RUNS runs of EVENT_DURATION_S simulated
    seconds each (``tools/event_table1.py``), AIF's tick on the card; the
    table, the Δ(AIF−Base) line beside the paper's, each strategy's wall;
    then AIF's control window taken apart (``event_window_breakdown``)."""
    from repro_torch.envsim import table1
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tools.event_table1 import (PAPER_DELTA, STRATEGIES, delta_line,
                                    run_event, summary_json)
    (summaries, walls), launches = counted(lambda: run_event(
        EVENT_DURATION_S, EVENT_RUNS, STRATEGIES, DEVICE))
    print(table1(summaries), flush=True)
    delta = delta_line(summaries)
    print(f"{delta}\n{PAPER_DELTA}", flush=True)
    by = {s.name: s for s in summaries}
    aif = by["aif"]
    if aif.runs[0].action_trace is None:
        raise AssertionError("event_table1: the AIF rows kept no actions")
    breakdown = event_window_breakdown(aif.runs[0], walls["aif"])
    emit("event_table1", n_runs=EVENT_RUNS, duration_s=EVENT_DURATION_S,
         aif_device=DEVICE, launches=launches, delta=delta,
         paper=PAPER_DELTA,
         rows={s.name: summary_json(s, walls[s.name]) for s in summaries},
         aif_window=breakdown)
    if launches != NO_LAUNCHES:
        raise AssertionError(f"event_table1 launched {launches}: the "
                             f"single-agent tick reaches no kernel")
    for s in summaries:
        vals = [s.success_pct_mean, s.p50_ms_mean, s.p95_ms_mean,
                *s.tier_share_mean]
        if len(s.runs) != EVENT_RUNS or not all(
                math.isfinite(v) for v in vals) or not (
                0.0 < s.success_pct_mean <= 100.0):
            raise AssertionError(f"event_table1: {s.name} gave {vals}")


def attn_bound(q, k, out, pairs: int) -> tuple[float, str]:
    """Least time for one attention launch: q, the K/V rows it must read
    and the output, each once, over the HBM rate, against 4·D·Hq FLOP per
    visible (query, key) pair over the dense bf16 rate (float32 inputs:
    the float32 rate outside the tensor cores)."""
    d, hq, hkv = q.shape[3], q.shape[2], k.shape[2]
    elt = q.element_size()
    kv_rows = pairs if q.shape[1] == 1 else k.shape[0] * k.shape[1]
    nbytes = (q.numel() + out.numel()) * elt + 2 * kv_rows * hkv * d * elt
    t_bytes = nbytes / HBM_BYTES_PER_S
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops = 4 * d * hq * pairs / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def decode_blocks(b: int, s: int, hkv: int, pos, window: int = 0) -> dict:
    """The blocks one B5 launch runs: its chunk plan, the split kernel's
    blocks (``blocks``), those whose chunk holds a key visible at ``pos``
    (``blocks_live``; the rest exit without a load) and the merge's."""
    from repro_torch.kernels.attention import flash
    chunk = flash.decode_chunk(b, s, hkv)
    n_split = -(-s // chunk)
    live = 0
    for p in (int(x) for x in pos):
        lo = max(0, p - window + 1) if window > 0 else 0
        live += sum(1 for c0 in range(0, s, chunk)
                    if c0 <= p and min(s, c0 + chunk) > lo)
    return dict(chunk=chunk, n_split=n_split, blocks=n_split * hkv * b,
                blocks_live=live * hkv, merge_blocks=hkv * b)


def decode_times_row(b: int, s: int, positions, seed: int, hq: int = 16,
                     hkv: int = 8, d: int = 128, window: int = 0,
                     dtype: torch.dtype = torch.bfloat16) -> tuple:
    """B5 at (b, s) with ``hq``/``hkv``/``d`` heads (internlm2-1.8b's by
    default) in ``dtype`` and ``positions``: (kernel call, plain call, SDPA
    call with a per-slot mask, (bound ms, bound by), fields of its times
    line)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import flash, ref
    q, k, v = attn_operands(b, 1, s, hq, hkv, d, dtype, seed=seed)
    pos = torch.from_numpy(np.asarray(positions, np.int32)).to(DEVICE)
    mask = ref._mask(pos.long()[:, None], s, True, window)[:, None]
    calls = (lambda: flash.flash_decode(q, k, v, position=pos, window=window),
             lambda: ref.decode_ref(q, k, v, position=pos, window=window),
             lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 attn_mask=mask, enable_gqa=True))
    pairs = int(mask.sum())
    return (calls, attn_bound(q, k, q, pairs),
            dict(b=b, s=s, heads=[hq, hkv, d], window=window,
                 positions=[int(x) for x in positions],
                 **decode_blocks(b, s, hkv, positions, window)))


def prefill_times_row(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                      seed: int, causal: bool = True, window: int = 0,
                      dtype: torch.dtype = torch.bfloat16) -> tuple:
    """B4 at (b, sq, skv) in ``dtype``, as :func:`decode_times_row`; SDPA
    is causal with no mask where it can be, else given the mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import flash, ref
    q, k, v = attn_operands(b, sq, skv, hq, hkv, d, dtype, seed)
    kw = dict(causal=causal, window=window)
    mask = ref._mask(torch.arange(sq, device=DEVICE), skv, causal, window)
    plain_causal = causal and window == 0 and sq == skv
    sdpa_kw = (dict(is_causal=True) if plain_causal else
               dict(attn_mask=mask) if causal else {})
    calls = (lambda: flash.flash_prefill(q, k, v, **kw),
             lambda: ref.mha_ref(q, k, v, **kw),
             lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 enable_gqa=True, **sdpa_kw))
    return (calls, attn_bound(q, k, q, b * int(mask.sum())),
            dict(b=b, sq=sq, skv=skv, heads=[hq, hkv, d], causal=causal,
                 window=window, blocks=hq * b * -(-sq // 64)))


def attn_time_fields(name: str, calls, bound, shape: dict,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Time one B4/B5 shape (in ``dtype``): kernel, plain version and SDPA
    on the same inputs, ``ms`` one synchronized call (:func:`time_ms`, the
    host's cost included, as for every kernel), ``device_ms`` the card's
    time a call when calls queue back to back (:func:`queued_ms`); emits
    its times line and returns its fields.  Raises where the kernel
    disagrees with its plain version beyond ``ATTN_TOL``."""
    kern, plain, lib = calls
    out_k = kern().float()
    plain_err = (out_k - plain().float()).abs().max().item()
    lib_err = (out_k - lib().transpose(1, 2).float()).abs().max().item()
    del out_k
    if not plain_err <= ATTN_TOL[dtype]:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version, max abs err {plain_err}")
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
    ms2 = time_ms(kern)
    (dev, ahead), (plain_dev, plain_ahead), (lib_dev, lib_ahead) = (
        queued_ms(kern), queued_ms(plain), queued_ms(lib))
    dev2, _ = queued_ms(kern)
    fields = dict(**shape, ms=ms, ms_repeat=ms2, plain_ms=plain_ms,
                  library_ms=lib_ms, device_ms=dev, device_ms_repeat=dev2,
                  plain_device_ms=plain_dev, library_device_ms=lib_dev,
                  queued_ahead=[ahead, plain_ahead, lib_ahead],
                  plain_max_abs_err=plain_err, library_max_abs_diff=lib_err, bound_ms=bound[0],
                  bound_by=bound[1])
    emit("times", kernel=name, dtype=str(dtype)[6:], **fields)
    return fields


def attn_times(errs: dict, launches: dict, lengths) -> list:
    """B4 at the serve phase's prefill (b=1, Sq=1024) and B5 at its decode
    (B=8, S=2048, each slot at its prompt length + 31, mid-run), bf16:
    kernel, plain version and SDPA (with GQA; causal, or a per-slot
    mask) on the same inputs; then B5 at the multitier phase's shapes
    (B = 2, 3, 8 over S=512, positions 128-143).  The kernels line takes
    the serve shapes."""
    rows = [("flash_prefill", "src/repro/kernels/attention/flash.py:94",
             *prefill_times_row(1, 1024, 1024, 16, 8, 128, seed=5))]
    rows.append(("flash_decode", "src/repro/kernels/attention/flash.py:190",
                 *decode_times_row(8, 2048,
                                   np.asarray(lengths, np.int64) + 31,
                                   seed=6)))
    rng = np.random.default_rng(11)
    for b in (2, 3, 8):
        rows.append((None, None, *decode_times_row(
            b, 512, rng.integers(128, 144, b), seed=20 + b)))
    out = []
    for name, replaces, calls, bound, shape in rows:
        f = attn_time_fields(name or "flash_decode", calls, bound, shape)
        if name is None:         # a multitier shape: not in the kernels line
            continue
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attn.cu",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "max_err": errs[name],
                    "ms": f["ms"], "plain_ms": f["plain_ms"],
                    "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                    "library_ms": f["library_ms"],
                    "device_ms": f["device_ms"],
                    "library_device_ms": f["library_device_ms"]})
    torch.cuda.empty_cache()
    return out


def moe_encdec_attn_times(moe_launches: dict, moe_lengths,
                          encdec_launches: dict) -> dict:
    """B4 and B5 at the moe_serve phase's shapes (mixtral-8x7b's heads:
    one admission at the 8192 bucket with window 4096; a decode wave over
    8 x 8192 slots with each slot at its prompt length + 31) and the
    encdec phase's (seamless-m4t-medium's heads, B=8: the encoder's
    unmasked 1024 x 1024, the cross-attention's 16 x 1024 at prefill; a
    self decode step at position 48 of 80 slots and a cross step over the
    1024 frames), each beside its plain version and SDPA on the same
    inputs; with the launches each phase counted.  Returns, per kernel,
    {shape: times fields} for its row of the kernels line."""
    h = (32, 8, 128)
    e = (16, 16, 64)
    out = {"flash_prefill": dict(
        moe_serve_launches=moe_launches["flash_prefill"],
        encdec_launches=encdec_launches["flash_prefill"]),
        "flash_decode": dict(
        moe_serve_launches=moe_launches["flash_decode"],
        encdec_launches=encdec_launches["flash_decode"])}
    rows = [
        ("flash_prefill", "mixtral_prefill_8192_window4096",
         prefill_times_row(1, MOE_MAX_LEN, MOE_MAX_LEN, *h, seed=40,
                           window=MOE_WINDOW)),
        ("flash_decode", "mixtral_decode_b8_s8192_window4096",
         decode_times_row(8, MOE_MAX_LEN,
                          np.asarray(moe_lengths, np.int64) + 31, 41, *h,
                          window=MOE_WINDOW)),
        ("flash_prefill", "seamless_encoder_b8_1024",
         prefill_times_row(ENCDEC_B, ENCDEC_FRAMES, ENCDEC_FRAMES, *e,
                           seed=42, causal=False)),
        ("flash_prefill", "seamless_cross_b8_16x1024",
         prefill_times_row(ENCDEC_B, ENCDEC_PREFIX, ENCDEC_FRAMES, *e,
                           seed=43, causal=False)),
        ("flash_decode", "seamless_self_b8_s80",
         decode_times_row(ENCDEC_B, ENCDEC_PREFIX + ENCDEC_STEPS,
                          [ENCDEC_PREFIX + ENCDEC_STEPS // 2] * ENCDEC_B, 44,
                          *e)),
        ("flash_decode", "seamless_cross_b8_s1024",
         decode_times_row(ENCDEC_B, ENCDEC_FRAMES,
                          [ENCDEC_FRAMES - 1] * ENCDEC_B, 45, *e))]
    for kernel, shape_name, (calls, bound, shape) in rows:
        out[kernel][shape_name] = attn_time_fields(kernel, calls, bound,
                                                   dict(shape=shape_name,
                                                        **shape))
    torch.cuda.empty_cache()
    return out


def phase_examples() -> dict:
    """The port's examples (:data:`EXAMPLES`) at their default sizes on the
    card, one after another in one subprocess (so they share its start-up)
    with its own temporary directory, each under its own timeout: its wall
    (its module's import and ``main()``), its headline lines and every
    kernel's launches, which must include the kernels its path runs
    (:data:`EXAMPLE_KERNELS`) and nothing else.  A non-zero exit fails the
    run.  Returns serve_multitier's B4 and B5 launches by head dim."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    env = dict(os.environ, TMPDIR=tmp)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER, ROOT, json.dumps(EXAMPLES)],
            env=env, capture_output=True, text=True,
            timeout=sum(EXAMPLES.values()) + 60)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    results = [json.loads(x[len(EXAMPLE_MARK):])
               for x in proc.stdout.splitlines() if x.startswith(EXAMPLE_MARK)]
    by_d = {}
    for res in results:
        name, launches = res["example"], res["launches"]
        emit("example", example=name, main_wall_s=res["main_s"],
             launches=launches, by_head_dim=res["by_head_dim"],
             headline=[x.strip() for line in res["lines"]
                       for x in line.splitlines()
                       if EXAMPLE_HEADLINE.search(x)])
        need = EXAMPLE_KERNELS.get(name, ())
        missing = [k for k in need if launches[k] == 0]
        other = {k: n for k, n in launches.items() if n and k not in need}
        if missing or other:
            raise AssertionError(f"example {name}: kernels {missing} not "
                                 f"launched, or others launched: {other}")
        if name == "serve_multitier":
            by_d = res["by_head_dim"]
            want = [f"{k}_d{d}" for k in need
                    for d in EXAMPLE_HEAD_DIMS + (16,)]
            if any(by_d.get(k, 0) == 0 for k in want):
                raise AssertionError(f"serve_multitier: B4/B5 by head dim "
                                     f"{by_d}, expected {want}")
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        failed = list(EXAMPLES)[len(results)]
        raise AssertionError(f"example {failed} failed: the examples' "
                             f"process exited with {proc.returncode}")
    main_s = sum(r["main_s"] for r in results)
    emit("examples", wall_s=wall, main_wall_s=main_s,
         start_up_s=wall - main_s)
    return by_d


def example_attn_times(by_d: dict) -> dict:
    """B4 and B5 at serve_multitier's light and medium tiers' shapes, in
    the float32 the example runs: a 16-token prompt in its 16-token bucket
    (b=1, 4/2 heads, causal) and a decode wave of max_batch 2 (D=8) or 3
    (D=12) over 64 slots at positions 16-19; kernel, plain version and SDPA
    timed as :func:`attn_time_fields` does, with the launches the example's
    run counted at that head dim."""
    rng = np.random.default_rng(12)
    out = {"flash_prefill": {}, "flash_decode": {}}
    for d, b in zip(EXAMPLE_HEAD_DIMS, (2, 3)):
        shapes = (
            ("flash_prefill", prefill_times_row(
                1, 16, 16, 4, 2, d, seed=90 + d, dtype=torch.float32)),
            ("flash_decode", decode_times_row(
                b, 64, rng.integers(16, 20, b), seed=95 + d, hq=4, hkv=2,
                d=d, dtype=torch.float32)))
        for kernel, (calls, bound, shape) in shapes:
            out[kernel][f"d{d}"] = dict(
                launches=by_d.get(f"{kernel}_d{d}", 0),
                **attn_time_fields(kernel, calls, bound, shape,
                                   torch.float32))
    torch.cuda.empty_cache()
    return out


def jamba_kernel_times(launches: dict, lengths) -> dict:
    """B4 and B5 at jamba-1.5-large's attention widths (64/8 heads, D=128,
    bf16: a causal prefill at b=1, Sq=Skv=1024; a decode wave over 8 x
    2048 slots with each slot at a jamba_serve prompt length + 31) beside
    their plain versions and SDPA, and B6 at its Mamba widths (H=256) at
    the jamba_serve phase's prefill shape; each with the launches that
    phase counted (its 4 layers hold no attention).  Returns, per kernel,
    the fields for its row of the kernels line."""
    h = (64, 8, 128)
    rows = (("flash_prefill", "jamba_prefill_1024",
             prefill_times_row(1, 1024, 1024, *h, seed=60)),
            ("flash_decode", "jamba_decode_b8_s2048",
             decode_times_row(8, 2048, np.asarray(lengths, np.int64) + 31,
                              61, *h)))
    out = {}
    for kernel, shape_name, (calls, bound, shape) in rows:
        out[kernel] = dict(
            jamba_serve_launches=launches[kernel],
            **attn_time_fields(kernel, calls, bound,
                               dict(shape=shape_name, **shape)))
    out["ssd_scan"] = dict(jamba_serve_launches=launches["ssd_scan"],
                           **ssd_time_fields(JAMBA_ARCH, seed=62))
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ Mamba-2 / SSD
def ssd_operands(b: int, s: int, h: int, p: int, g: int, n: int,
                 dtype: torch.dtype, init: bool = False, seed: int = 0):
    """Seeded B6 inputs on the card: x (b, s, h, p), dt = softplus(N(0, 1))
    and a = -exp(0.3 N(0, 1)) in f32, b/c (b, s, g, n), and an initial
    state (b, h, p, n) when ``init``."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    a = -torch.exp(0.3 * randn(h))
    bb, cc = randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)
    st = randn(b, h, p, n).to(dtype) if init else None
    return x, dt, a, bb, cc, st


def ssd_widths(arch: str) -> tuple:
    """(H, P, G, N, Q) of ``arch``'s Mamba-2 mixer at its published
    widths."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).full
    return (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_ngroups, cfg.ssm_state,
            cfg.ssm_chunk)


def ssd_cases():
    """(name, B, S, H, P, G, N, Q, dtype, init) of every B6 check, in bf16
    and f32: mamba2-2.7b's widths at the mamba serve phase's prefill
    (b=1, S=1024) and the serve-small phase's bucket (S=64), a ragged
    S=1000 and a short S=80 (under one chunk) from an initial state, b=2,
    G=2 at the reference sweep's small widths, and jamba-1.5-large's
    widths (H=256) at the jamba serve phase's prefill (b=1, S=1024)."""
    cases = []
    m, jm = ssd_widths(MAMBA_ARCH), ssd_widths(JAMBA_ARCH)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("mamba_b1_s1024", 1, 1024, *m, dtype, False),
                  ("mamba_b1_s64", 1, 64, *m, dtype, False),
                  ("mamba_ragged_s1000_init", 1, 1000, *m, dtype, True),
                  ("mamba_short_s80_init", 1, 80, *m, dtype, True),
                  ("mamba_b2_s512", 2, 512, *m, dtype, False),
                  ("g2_small", 1, 128, 4, 32, 2, 16, 32, dtype, False)]
    cases += [("jamba_b1_s1024", 1, 1024, *jm, dtype, False)
              for dtype in (torch.bfloat16, torch.float32)]
    return cases


def ssd_model_check(name: str, out_k, args) -> dict:
    """Hold a bf16 B6 output (y, state) against
    ``ref.ssd_chunk_parallel_model`` on the same inputs: within one bf16
    ulp of the model rounded to bf16 plus ``SSD_MODEL_TOL`` of max(1,
    |model|), y and state, and closer to it (fewer elements differing) than
    to the model that drops the lo halves.  Returns the line's fields."""
    from repro_torch.kernels.ssd import ref
    row, ok = {}, True
    models = [ref.ssd_chunk_parallel_model(*args, split_bf16=True,
                                           keep_lo=keep_lo)
              for keep_lo in (True, False)]
    for i, key in enumerate(("y", "state")):
        want, hi_only = models[0][i], models[1][i]
        wb, got = want.bfloat16().float(), out_k[i].float()
        diff = (got - wb).abs()
        tol = SSD_MODEL_TOL * max(1.0, want.abs().max().item())
        share = (diff != 0).float().mean().item()
        share_hi = (got != hi_only.bfloat16().float()).float().mean().item()
        row[key] = dict(
            max_abs_err=diff.max().item(),
            max_excess_over_one_ulp=(diff - bf16_ulp(wb)).max().item(),
            tol=tol, share_differing=share,
            share_differing_from_hi_only=share_hi)
        ok = ok and row[key]["max_excess_over_one_ulp"] <= tol and \
            share < share_hi
    if not ok:
        raise AssertionError(f"ssd_scan {name}: kernel disagrees with the "
                             f"model of its algebra: {row}")
    return row


def phase_ssd_kernel_vs_plain() -> dict:
    """B6 against its plain version on the same inputs on the card, each
    case launched twice (the two outputs must be equal to the bit), the
    bf16 route also against the model of its algebra
    (:func:`ssd_model_check`); returns its worst max abs error and worst
    scaled error (y's over max(1, |y|), the state's over 10 max(1,
    |state|))."""
    from repro_torch.kernels.ssd import ref, ssd
    worst = {"max_abs_err": 0.0, "max_scaled_err": 0.0}
    for i, (name, b, s, h, p, g, n, q, dtype, init) in enumerate(ssd_cases()):
        x, dt, a, bb, cc, st = ssd_operands(b, s, h, p, g, n, dtype, init,
                                            seed=20 + i)
        (yk, sk), (yk2, sk2), (yp, sp) = (
            ssd.ssd_scan(x, dt, a, bb, cc, q, st),
            ssd.ssd_scan(x, dt, a, bb, cc, q, st),
            ref.ssd_chunked(x, dt, a, bb, cc, q, st))
        torch.cuda.synchronize()
        if not (torch.equal(yk, yk2) and torch.equal(sk, sk2)):
            raise AssertionError(f"ssd_scan {name} ({dtype}): two launches "
                                 f"on the same inputs differ")
        if ssd.library().ssd_scan_route(1 if dtype == torch.bfloat16 else 0,
                                        p, min(q, s)):
            emit("ssd_kernel_vs_model", case=f"{name}_{str(dtype)[6:]}",
                 **ssd_model_check(name, (yk, sk),
                                   (x, dt, a, bb, cc, q, st)))
        errs = {}
        for key, k, pl in (("y", yk, yp), ("state", sk, sp)):
            k32, p32 = k.float(), pl.float()
            errs[key] = ((k32 - p32).abs().max().item(),
                         max(1.0, p32.abs().max().item()))
        finite = bool(torch.isfinite(yk.float()).all()
                      and torch.isfinite(sk.float()).all())
        tol = SSD_TOL[dtype]
        y_scaled = errs["y"][0] / errs["y"][1]
        s_scaled = errs["state"][0] / errs["state"][1]
        emit("ssd_kernel_vs_plain", case=f"{name}_{str(dtype)[6:]}",
             shape=dict(B=b, S=s, H=h, P=p, G=g, N=n, Q=q), init=init,
             y_max_abs_err=errs["y"][0], y_plain_max_abs=errs["y"][1],
             y_scaled_err=y_scaled, state_max_abs_err=errs["state"][0],
             state_plain_max_abs=errs["state"][1],
             state_scaled_err=s_scaled, tol=tol)
        if not (finite and yk.dtype == yp.dtype and sk.dtype == sp.dtype
                and yk.shape == yp.shape and sk.shape == sp.shape
                and y_scaled <= tol and s_scaled <= 10 * tol):
            raise AssertionError(f"ssd_scan {name} ({dtype}) disagrees with "
                                 f"its plain version: {errs}")
        worst["max_abs_err"] = max(worst["max_abs_err"], errs["y"][0],
                                   errs["state"][0])
        worst["max_scaled_err"] = max(worst["max_scaled_err"], y_scaled,
                                      s_scaled / 10)
        del x, dt, a, bb, cc, st, yk, sk, yp, sp
    torch.cuda.empty_cache()
    return worst


def ssd_bound(b: int, s: int, h: int, p: int, g: int, n: int, q: int,
              elt: int) -> dict:
    """Least time for one B6 launch without an initial state.  Bytes: x,
    dt, a, B and C read once, y and the final state written once.
    Operations, counted on what this run needs: C B^T over the causal
    (row, key) pairs of each chunk once per group (all H/G heads of a group
    share it), then per head the intra-chunk product over those pairs, the
    carried state's contribution and the state update, at the dense bf16
    rate.  ``ops_tpu_way_ms`` counts full Q x Q planes per head, as the TPU
    kernel computes them."""
    rows = [min(q, s - c) for c in range(0, s, q)]
    pairs = sum(r * (r + 1) // 2 for r in rows)
    flops = b * (g * pairs * 2 * n + h * (pairs * 2 * p + s * 4 * n * p))
    flops_tpu = b * h * len(rows) * (2 * q * q * (n + p) + 4 * q * n * p)
    nbytes = (2 * b * s * h * p * elt + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * elt + b * h * p * n * elt)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / BF16_FLOP_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, bytes_ms=bytes_ms, flops=flops, ops_ms=ops_ms,
                flops_tpu_way=flops_tpu,
                ops_tpu_way_ms=1e3 * flops_tpu / BF16_FLOP_PER_S)


def ssd_time_fields(arch: str, seed: int) -> dict:
    """B6 at a serve phase's prefill shape (b=1, S=1024, ``arch``'s widths,
    bf16): ms per launch beside its plain version's and its bound; emits
    its times line and returns its fields."""
    from repro_torch.kernels.ssd import ref, ssd
    h, p, g, n, q = ssd_widths(arch)
    x, dt, a, bb, cc, _ = ssd_operands(1, 1024, h, p, g, n, torch.bfloat16,
                                       seed=seed)
    kern = lambda: ssd.ssd_scan(x, dt, a, bb, cc, q)          # noqa: E731
    plain = lambda: ref.ssd_chunked(x, dt, a, bb, cc, q)      # noqa: E731
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    ms2 = time_ms(kern)
    dev, ahead = queued_ms(kern)
    bnd = ssd_bound(1, 1024, h, p, g, n, q, x.element_size())
    fields = dict(arch=arch, shape=dict(B=1, S=1024, H=h, P=p, G=g, N=n,
                                        Q=q),
                  ms=ms, ms_repeat=ms2, plain_ms=plain_ms, library_ms=None,
                  device_ms=dev, queued_ahead=ahead, **bnd)
    emit("times", kernel="ssd_scan", dtype="bfloat16", **fields)
    del x, dt, a, bb, cc
    torch.cuda.empty_cache()
    return fields


def ssd_times(errs: dict, launches: dict) -> dict:
    """B6's row of the kernels line: its times at the mamba serve phase's
    prefill shape (mamba2-2.7b's widths), with that phase's launches."""
    f = ssd_time_fields(MAMBA_ARCH, seed=9)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:76",
            "launches": launches["ssd_scan"],
            "max_abs_err": errs["max_abs_err"],
            "max_err": errs["max_abs_err"],
            "max_scaled_err": errs["max_scaled_err"],
            "ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None, "device_ms": f["device_ms"],
            "library_device_ms": None}


# ------------------------------------------- MoE and the encoder-decoder
def encdec_generate(model, embeds, prefix, n_steps: int,
                    keep_logits: bool = False):
    """``model.prefill`` over the source frames ``embeds`` and the target
    ``prefix``, then ``n_steps`` greedy ``decode_step``s: (tokens (B,
    n_steps + 1), every step's logits in float32 on the host if
    ``keep_logits``, whether every logit was finite)."""
    s = prefix.shape[1]
    lg, caches = model.prefill(embeds, prefix, max_len=s + n_steps)
    toks, logits, finite = [], [], torch.ones((), dtype=torch.bool,
                                              device=lg.device)
    for step in range(n_steps + 1):
        finite &= torch.isfinite(lg).all()
        if keep_logits:
            logits.append(lg.float().cpu())
        toks.append(lg[:, -1].argmax(-1, keepdim=True))
        if step < n_steps:
            lg, caches = model.decode_step(toks[-1], caches, s + step)
    return torch.cat(toks, 1), logits, bool(finite)


def encdec_launches(cfg, n_steps: int) -> dict:
    """B4 once per encoder layer and twice per decoder layer (self and
    cross) at prefill; B5 twice per decoder layer at each decode step."""
    return dict(NO_LAUNCHES, flash_prefill=cfg.n_enc_layers + 2 * cfg.n_layers,
                flash_decode=2 * cfg.n_layers * n_steps)


def phase_encdec_small() -> None:
    """seamless-m4t-medium's widths at 2 encoder + 2 decoder layers in
    f32, one model on the card and one on the CPU with the same weights:
    2 sources of 200 frames, an 8-token prefix and 8 greedy steps; tokens
    equal, every step's logits within 1e-4 relative, the kernels launched
    as expected."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, convert
    cfg = dataclasses.replace(get_arch(ENCDEC_ARCH).full, n_layers=2,
                              n_enc_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    weights = build_model(cfg, "cpu", seed=0).state_dict()
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(
        rng.standard_normal((2, 200, cfg.d_model)).astype(np.float32))
    prefix = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    out = {}
    for dev in (DEVICE, "cpu"):
        model = convert.model_from_state_dict(cfg, weights, dev)
        out[dev] = counted(lambda: encdec_generate(
            model, embeds.to(dev), prefix.to(dev), 8, keep_logits=True))
        del model
    (toks_k, lg_k, fin_k), launches = out[DEVICE]
    (toks_c, lg_c, _), _ = out["cpu"]
    lg_k, lg_c = torch.cat(lg_k, 1), torch.cat(lg_c, 1)
    rel = ((lg_k - lg_c).abs().max() / lg_c.abs().max()).item()
    want = encdec_launches(cfg, 8)
    equal = torch.equal(toks_k.cpu(), toks_c)
    emit("encdec_small", arch=ENCDEC_ARCH, n_enc_layers=2, n_layers=2,
         dtype="float32", frames=200, prefix=8, steps=8, tokens_equal=equal,
         logits_rel_err=rel, launches=launches, expected_launches=want,
         tokens=toks_k.tolist())
    if not (equal and fin_k and rel <= 1e-4):
        raise AssertionError(f"encdec_small: the card disagrees with the "
                             f"CPU (logits rel err {rel})")
    if launches != want:
        raise AssertionError(f"encdec_small launched {launches}, expected "
                             f"{want}")
    torch.cuda.empty_cache()


def phase_encdec() -> dict:
    """seamless-m4t-medium whole (12 + 12 layers, bf16): 8 sources of 1024
    frame embeddings from a seed, a 16-token target prefix and 64 greedy
    decode steps, every kernel's count read around it; then one prefill's
    and one decode step's host and device ms.  Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(ENCDEC_ARCH).full
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, DEVICE, seed=0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    embeds = torch.randn((ENCDEC_B, ENCDEC_FRAMES, cfg.d_model),
                         generator=gen, device=DEVICE)
    prefix = torch.randint(0, cfg.vocab_size, (ENCDEC_B, ENCDEC_PREFIX),
                           generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (toks, _, finite), launches = counted(lambda: encdec_generate(
        model, embeds, prefix, ENCDEC_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = encdec_launches(cfg, ENCDEC_STEPS)
    ok = (finite and tuple(toks.shape) == (ENCDEC_B, ENCDEC_STEPS + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))
    emit("encdec", arch=ENCDEC_ARCH, n_enc_layers=cfg.n_enc_layers,
         n_layers=cfg.n_layers, params=cfg.param_count(),
         dtype=cfg.param_dtype, batch=ENCDEC_B, frames=ENCDEC_FRAMES,
         prefix=ENCDEC_PREFIX, steps=ENCDEC_STEPS, wall_s=wall,
         tokens_per_s=toks.numel() / wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, expected_launches=want, outputs_ok=ok,
         first_tokens=toks[0, :8].tolist())
    if launches != want or not ok:
        raise AssertionError(f"encdec launched {launches}, expected {want};"
                             f" outputs ok: {ok}")
    max_len = ENCDEC_PREFIX + ENCDEC_STEPS
    _, caches = model.prefill(embeds, prefix, max_len=max_len)
    last = toks[:, ENCDEC_PREFIX // 2:ENCDEC_PREFIX // 2 + 1]
    emit("encdec_breakdown", arch=ENCDEC_ARCH, **breakdown((
        ("prefill", lambda: model.prefill(embeds, prefix, max_len=max_len)),
        ("decode_step", lambda: model.decode_step(
            last, caches, ENCDEC_PREFIX + ENCDEC_STEPS // 2)))))
    del model, caches
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- training
# the reference training tests' TINY (tests/test_training.py)
TINY_FIELDS = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=211,
                   param_dtype="float32")
TRAIN_SMALL_ARCHS = ("internlm2-1.8b", "mixtral-8x7b", "mamba2-2.7b",
                     "seamless-m4t-medium", "jamba-1.5-large-398b")
TRAIN_SMALL_STEPS = 3
TRAIN_ARCH = "internlm2-1.8b"
# train: the train_4k cell's sequence, its global batch of 256 cut to 8
# (4 microbatches of 2) for the time limit, 4 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 8, 4, 4


def train_variants() -> dict:
    """The train step's variants held card against CPU.  Their peak rate
    is 3e-4 (warmup 5): at the reference tests' 3e-3, Adam's and
    Adafactor's normalization turns the float32 noise of near-zero
    gradients (|g| near eps = 1e-8, where card and CPU differ by ~1e-9)
    into parameter differences up to 2.6x the bar; at 3e-4 that noise
    stays under a third of it, and an update of the wrong sign would
    still miss it tenfold."""
    from repro_torch.training import OptimizerConfig, TrainConfig
    from repro_torch.training.grad_compression import CompressionConfig

    def opt(**kw):
        return OptimizerConfig(peak_lr=3e-4, warmup_steps=5,
                               total_steps=100, **kw)
    return {"adamw": TrainConfig(optimizer=opt()),
            "adafactor": TrainConfig(optimizer=opt(name="adafactor",
                                                   factored_min_dim=32)),
            "accum2": TrainConfig(optimizer=opt(), accum_steps=2),
            "int8_ef": TrainConfig(optimizer=opt(), compression=(
                CompressionConfig(mode="int8_ef")))}


def train_params(state) -> list:
    """The train state's parameters, flat, in float32 on the host."""
    from repro_torch.training.optimizer import members
    return [p.detach().float().cpu() for leaf in state.params.values()
            for p in members(leaf)]


def int8_ties(ties: list):
    """A stand-in for ``grad_compression.compress_int8_ef`` that ORs into
    ``ties`` (one bool tensor a parameter, on the host) the elements whose
    scaled gradient sits within 1e-3 of a half-integer, the quantizer's
    rounding ties, where float32 noise picks the int8 value; then
    quantizes as the original does."""
    from repro_torch.training import grad_compression
    from repro_torch.training.optimizer import members
    orig = grad_compression.compress_int8_ef

    def compress(grads, residual):
        i = 0
        for path, leaf in grads.items():
            r = residual[path]
            g32 = [g.float() + ri for g, ri in zip(
                members(leaf), r.unbind(0) if isinstance(leaf, list)
                else [r])]
            scale = torch.clamp(torch.stack(
                [x.abs().amax() for x in g32]).amax(), min=1e-12) / 127.0
            for x in g32:
                t = (x / scale).abs()
                tie = ((t - t.floor() - 0.5).abs() < 1e-3).cpu()
                if len(ties) <= i:
                    ties.append(tie)
                else:
                    ties[i] |= tie
                i += 1
        return orig(grads, residual)
    return compress


def train_run(cfg, weights: dict, tcfg, batches: list, device: str,
              ties: list | None = None):
    """``TRAIN_SMALL_STEPS`` steps of ``make_train_step`` on ``device`` from
    ``weights`` (copied) over ``batches``: (each step's (loss, aux, grad
    norm), final parameters).  With ``ties`` the int8 quantizer's rounding
    ties are recorded there (:func:`int8_ties`)."""
    from repro_torch.models import convert
    from repro_torch.training import (grad_compression, init_train_state,
                                      make_train_step)
    model = convert.model_from_state_dict(
        cfg, {k: v.clone() for k, v in weights.items()}, device)
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    metrics = []
    orig = grad_compression.compress_int8_ef
    if ties is not None:
        grad_compression.compress_int8_ef = int8_ties(ties)
    try:
        for b in batches:
            state, m = step(state, {k: v.to(device) for k, v in b.items()})
            metrics.append((float(m.loss), float(m.aux_loss),
                            float(m.grad_norm)))
    finally:
        grad_compression.compress_int8_ef = orig
    return metrics, train_params(state)


def small_trainer(ckpt_dir: str, total: int, injector=None):
    """The reference tests' ``_trainer``: TINY (bf16 compute) on the card,
    batches of 8 x 32 tokens, AdamW at peak 3e-3, a checkpoint every 10
    steps."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.training import (OptimizerConfig, TrainConfig, Trainer,
                                      TrainerConfig)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        peak_lr=3e-3, warmup_steps=5, total_steps=100))
    dcfg = DataConfig(vocab_size=211, seq_len=32, global_batch=8)
    return Trainer(build_model(ModelConfig(**TINY_FIELDS), DEVICE), tcfg,
                   SyntheticPipeline(dcfg, device=DEVICE),
                   TrainerConfig(total_steps=total, checkpoint_every=10,
                                 log_every=1000, ckpt_dir=ckpt_dir),
                   failure_injector=injector, log_fn=lambda s: None)


def nondeterministic_ops(trainer, state) -> list:
    """The ops ``torch.use_deterministic_algorithms`` warns about in one
    train step of ``trainer`` (on a copy of its next batch; the step's
    result is dropped)."""
    import warnings
    batch = trainer.data._batch_for(0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.step_fn(state, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0][:120]
                   for w in caught})


def phase_train_small() -> None:
    """The training path on the card against the CPU, then TINY trained
    and preempted on the card (see the module docstring, phase 45)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.training import FailureInjector, run_with_restarts
    from repro_torch.training.optimizer import members
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_small compares float32 steps: TF32 "
                             "must be off")
    cfgs = {"tiny": ModelConfig(**TINY_FIELDS, compute_dtype="float32")}
    for arch in TRAIN_SMALL_ARCHS:
        cfgs[arch] = dataclasses.replace(
            get_arch(arch).smoke, param_dtype="float32",
            compute_dtype="float32")
    worst = {"metrics_rel": 0.0, "params_excess": 0.0}
    rows = []

    def compare():
        for name, cfg in cfgs.items():
            weights = build_model(cfg, "cpu", seed=0).state_dict()
            pipe = SyntheticPipeline(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                input_mode=cfg.input_mode, d_model=cfg.d_model),
                device="cpu")
            batches = [next(pipe) for _ in range(TRAIN_SMALL_STEPS)]
            for variant, tcfg in train_variants().items():
                # int8_ef: an element whose quantization was a rounding tie
                # on either side at any step is held apart (its int8 value
                # is float32 noise's pick); every other parameter element
                # is held to the bar
                ties = [] if tcfg.compression.mode == "int8_ef" else None
                mk, pk = train_run(cfg, weights, tcfg, batches, DEVICE, ties)
                mc, pc = train_run(cfg, weights, tcfg, batches, "cpu", ties)
                rel = max(abs(a - b) / max(abs(b), 1e-6)
                          for sk, sc in zip(mk, mc) for a, b in zip(sk, sc))
                # the largest |card - cpu| over the bar's allowance
                over = [(a - b).abs() / (1e-5 + 1e-4 * b.abs())
                        for a, b in zip(pk, pc)]
                tied = ties or [torch.zeros_like(o, dtype=torch.bool)
                                for o in over]
                excess = max(float(o.masked_fill(t, 0.0).max())
                             for o, t in zip(over, tied))
                worst["metrics_rel"] = max(worst["metrics_rel"], rel)
                worst["params_excess"] = max(worst["params_excess"], excess)
                rows.append({"config": name, "variant": variant,
                             "losses": [m[0] for m in mk],
                             "aux": mk[-1][1], "metrics_rel_err": rel,
                             "params_err_over_bar": excess,
                             "int8_ties": sum(int(t.sum()) for t in tied),
                             "tied_err_over_bar": max(
                                 float(o.masked_fill(~t, 0.0).max())
                                 for o, t in zip(over, tied))})

    _, cmp_launches = counted(compare)
    for row in rows:
        emit("train_small_step", **row)

    def trained():
        with tempfile.TemporaryDirectory() as d:
            tr = small_trainer(os.path.join(d, "a"), 50)
            tr.run()
            return tr.losses
    losses, fit_launches = counted(trained)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))

    def restarted():
        with tempfile.TemporaryDirectory() as d:
            inj = FailureInjector(fail_at_steps=(25,))
            state_r, restarts = run_with_restarts(
                lambda: small_trainer(os.path.join(d, "x"), 40, inj))
            whole = small_trainer(os.path.join(d, "y"), 40)
            state_c = whole.run()
            pr, pc = train_params(state_r), train_params(state_c)
            ids = {id(p): n for n, p in whole.model.named_parameters()}
            names = [ids[id(p)] for leaf in state_c.params.values()
                     for p in members(leaf)]
            differ = {n: float((a - b).abs().max())
                      for n, a, b in zip(names, pr, pc)
                      if not torch.equal(a, b)}
            gap = max(float((a - b).abs().max()) for a, b in zip(pr, pc))
            nondet = nondeterministic_ops(whole, state_c)
            return restarts, gap, differ, nondet, len(names)
    (restarts, gap, differ, nondet, n_params), rs_launches = counted(
        restarted)
    launches = {k: cmp_launches[k] + fit_launches[k] + rs_launches[k]
                for k in cmp_launches}
    emit("train_small", configs=list(cfgs), variants=list(train_variants()),
         steps=TRAIN_SMALL_STEPS, dtype="float32",
         metrics_max_rel_err=worst["metrics_rel"],
         params_max_err_over_bar=worst["params_excess"],
         tiny_50_steps_first5=first, tiny_50_steps_last5=last,
         restarts=restarts, resume_max_abs_diff=gap,
         resume_bit_equal=not differ, resume_params_differing=differ,
         resume_n_params=n_params, nondeterministic_ops=nondet,
         launches=launches)
    if worst["metrics_rel"] > 1e-4 or worst["params_excess"] > 1.0:
        raise AssertionError(f"train_small: the card's steps disagree with "
                             f"the CPU's ({worst})")
    if not last < 0.7 * first:
        raise AssertionError(f"train_small: TINY's loss fell from {first} "
                             f"to only {last}")
    if restarts != 1 or not gap <= 1e-5:
        raise AssertionError(f"train_small: the resumed run is {gap} from "
                             f"the uninterrupted one ({restarts} restarts)")
    if launches != NO_LAUNCHES:
        raise AssertionError(f"train_small launched {launches}")
    torch.cuda.empty_cache()


def strided_sample(t: torch.Tensor, n: int = 1 << 20) -> torch.Tensor:
    """Up to ``n`` evenly strided elements of ``t``, as float32."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // n)].float().clone()


def master_samples(state) -> list:
    """A strided sample of each parameter's float32 master (the parameter
    itself where it has none), in the grouped order."""
    from repro_torch.training.optimizer import members
    out = []
    for path, leaf in state.params.items():
        st = state.opt.inner[path]
        rows = ((st["master"].unbind(0) if isinstance(leaf, list)
                 else [st["master"]]) if "master" in st else members(leaf))
        out += [strided_sample(r) for r in rows]
    return out


def train_model_flops(cfg, tokens: int) -> float:
    """Model FLOPs of one training step on ``tokens`` tokens: 6 x the
    parameters that multiply (all but the token table, a gather) per
    token, plus the causal attention products (QK^T and PV over half the
    sequence on average, 3x for forward and backward); recompute is not
    counted."""
    n = cfg.param_count() - cfg.vocab_size * cfg.d_model
    attn = 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * TRAIN_SEQ
    return tokens * (6 * n + attn)


def device_time(prof) -> tuple[float, list]:
    """(device ms, [(ms, count, name)] by kernel name, longest first) of a
    ``torch.profiler`` trace, summed straight from its raw events: a
    training step has some 10^6 of them, which ``key_averages`` takes
    minutes to build."""
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        row = by_name.setdefault(e.name()[:80], [0.0, 0])
        row[0] += (e.end_ns() - e.start_ns()) / 1e6
        row[1] += 1
    top = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                 reverse=True)
    return sum(r[0] for r in top), top


def phase_train() -> None:
    """internlm2-1.8b trained at its published widths and depth (see the
    module docstring, phase 46)."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.models.convert import group_params
    from repro_torch.training import (OptimizerConfig, TrainConfig, Trainer,
                                      TrainerConfig)
    from repro_torch.training.optimizer import members, schedule
    from torch.profiler import ProfilerActivity, profile
    cfg = get_arch(TRAIN_ARCH).full
    # the reference's train_config_for below 150 B parameters
    ocfg = OptimizerConfig(name="adamw", master_fp32=True,
                           moment_dtype="float32")
    tcfg = TrainConfig(optimizer=ocfg, accum_steps=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, DEVICE, seed=0)
    # before training the masters are the parameters, widened
    before = [strided_sample(p) for leaf in group_params(model).values()
              for p in members(leaf)]
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH),
                             device=DEVICE)
    stamps = []
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(model, tcfg, data, TrainerConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=10 * TRAIN_STEPS,
            log_every=1, ckpt_dir=d),
            log_fn=lambda s: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, launches = counted(lambda: trainer.run(seed=0))
    walls = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = master_samples(state)
    moved = [bool((a != b).any()) for a, b in zip(before, after)]
    moved_share = float(sum((a != b).float().mean() for a, b in
                            zip(before, after)) / len(before))
    m = trainer.metrics
    lr_want = [float(schedule(ocfg, i + 1)) for i in range(TRAIN_STEPS)]
    finite = all(math.isfinite(x.loss) and math.isfinite(x.grad_norm)
                 for x in m)
    lr_ok = all(abs(x.lr - w) <= 1e-6 * w for x, w in zip(m, lr_want))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = statistics.median(walls[1:])
    flops = train_model_flops(cfg, tokens)
    emit("train", arch=TRAIN_ARCH, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=cfg.param_count(),
         dtype=cfg.param_dtype, optimizer="adamw f32 master + moments",
         seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
         accum_steps=TRAIN_ACCUM, steps=TRAIN_STEPS,
         losses=[x.loss for x in m], grad_norms=[x.grad_norm for x in m],
         lr=[x.lr for x in m], lr_schedule=lr_want, step_wall_ms=walls,
         steady_step_ms=steady, tokens_per_s=tokens / (steady / 1e3),
         peak_mem_gb=peak, model_flops_per_step=flops,
         mfu=flops / (steady / 1e3) / BF16_FLOP_PER_S,
         params_moved=sum(moved), n_params=len(moved),
         master_elements_moved_share=moved_share, launches=launches)
    if not (finite and lr_ok and all(moved)) or launches != NO_LAUNCHES:
        raise AssertionError(
            f"train: finite {finite}, lr equal to the schedule {lr_ok}, "
            f"{sum(moved)} of {len(moved)} parameters moved, launches "
            f"{launches}")

    # one more step (the run warmed everything up) under the profiler
    batch = next(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    dev, top = device_time(prof)
    emit("train_breakdown", arch=TRAIN_ARCH, profiled_step_wall_ms=wall,
         steady_step_ms=steady, device_ms=dev,
         device_idle_share=max(0.0, 1 - dev / steady),
         profiled_idle_share=max(0.0, 1 - dev / wall),
         top_device_ops_ms_count_name=top[:10],
         profile_read_s=time.perf_counter() - t1)
    del trainer, state, model, batch
    torch.cuda.empty_cache()
    return {"device_ms": dev, "steady_step_ms": steady}


def phase_times(errs: dict, launches: dict, launches_5tier: int) -> list:
    d = full_width_operands(masked=False)
    rows = []
    replaces = {"belief_efe_fleet": "src/repro/kernels/efe/efe.py:250",
                "efe_fleet": "src/repro/kernels/efe/efe.py:118"}
    for name, (kern, plain) in kernel_calls(d).items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        ms2 = time_ms(kern)
        dev, ahead = queued_ms(kern)
        b_ms, b_by = bound(d, name)
        emit("times", kernel=name, r=R_FULL, ms=ms, ms_repeat=ms2,
             plain_ms=plain_ms, device_ms=dev, queued_ahead=ahead,
             bound_ms=b_ms, bound_by=b_by,
             achieved_tb_s=None if b_by != "bytes" else
             b_ms / ms * HBM_BYTES_PER_S / 1e12)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/efe_fleet.cu",
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "max_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "device_ms": dev, "library_device_ms": None})
    del d
    rows[0]["continuum_5tier"] = b1_5tier_times(errs, launches_5tier)
    torch.cuda.empty_cache()
    rows.append(mega_times(errs, launches))
    return rows


def b1_5tier_times(errs: dict, launches: int) -> dict:
    """B1 at the continuum-5tier widths (R=1024, S=128, A=37), the shape of
    the hetero phase's second group: times beside its bound and plain
    version, with the launches that group's run counted."""
    from repro_torch.core.topology import five_tier_topology
    d = full_width_operands(masked=False, topo=five_tier_topology())
    kern, plain = kernel_calls(d)["belief_efe_fleet"]
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    dev, ahead = queued_ms(kern)
    b_ms, b_by = bound(d, "belief_efe_fleet")
    row = {"shape": list(d["nb"].shape), "launches": launches,
           "max_abs_err": errs["belief_efe_fleet_5tier"], "ms": ms,
           "plain_ms": plain_ms, "device_ms": dev, "bound_ms": b_ms,
           "bound_by": b_by}
    emit("times", kernel="belief_efe_fleet", topology="continuum-5tier",
         queued_ahead=ahead, **row)
    del d
    return row


# the dry run's records in spawned processes; dryrun_card's card work runs
# meanwhile in this one (its host-bound counted train step on one core)
DRYRUN_WORKERS = 6
# dryrun_card: a prefill of 8 x 1024 tokens and a decode wave of 8 over
# 2048 slots (the serve phase's lanes), and phase 46's train step
CARD_PREFILL, CARD_DECODE = (8, 1024), (8, 2048)
CARD_ARG_TOL = 0.01


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def card_cells() -> dict:
    """dryrun_card's three runs as dry-run cells of internlm2-1.8b."""
    from repro_torch.configs.base import ShapeCell
    return {"prefill": ShapeCell("card_prefill", CARD_PREFILL[1],
                                 CARD_PREFILL[0], "prefill"),
            "decode": ShapeCell("card_decode", CARD_DECODE[1],
                                CARD_DECODE[0], "decode"),
            "train": ShapeCell("card_train", TRAIN_SEQ, TRAIN_BATCH,
                               "train")}


def phase_dryrun(meanwhile) -> dict:
    """Every cell's dry run (see the module docstring, phase 51), with
    ``meanwhile()`` (dryrun_card's card work) run while the records are
    made; returns dryrun_card's three runs counted on ``meta`` at mesh
    (1, 1)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    arch = get_arch(TRAIN_ARCH)
    card = {name: dryrun.cell_jobs(arch, cell, ("one",), accum=TRAIN_ACCUM)
            for name, cell in card_cells().items()}
    t0 = time.perf_counter()
    recs, done = dryrun.sweep(
        outdir=None, workers=DRYRUN_WORKERS,
        echo=lambda line: print(line, flush=True),
        extra_jobs=[j for parts in card.values() for j, _, _ in parts],
        meanwhile=meanwhile)
    failed = [f"{r['arch']}|{r['shape']}|{r['mesh']}" for r in recs
              if r.get("ok") is False]
    failed += [f"{TRAIN_ARCH}|{j.shape[0]}" for j, r in done.items()
               if isinstance(r, Exception)]
    emit("dryrun", cells=len(recs), ok=sum(bool(r.get("ok")) for r in recs),
         failed=failed, skipped=sum(r.get("ok") is None for r in recs),
         workers=DRYRUN_WORKERS, wall_s=time.perf_counter() - t0)
    if failed:
        bad = next((r for r in recs if r.get("ok") is False), None)
        raise AssertionError(f"dryrun: {len(failed)} cells failed: "
                             f"{failed[:5]}; first: "
                             f"{(bad or {}).get('error', '')[:2000]}")
    return {name: dryrun.combine([(done[j], w, pw) for j, w, pw in parts],
                                 "one")
            for name, parts in card.items()}


def card_count(fn) -> dict:
    """One more call of ``fn`` under ``op_cost.FlopCount`` with every
    kernel's count read around it: its aten FLOPs, launches and the card's
    peak less its allocation before the call."""
    from repro_torch.launch import op_cost
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counter = op_cost.FlopCount()
    with counter:
        res, launches = counted(fn)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    del res
    return {"aten_flops": counter.flops, "temp_bytes": temp,
            "launches": {k: v for k, v in launches.items() if v},
            "count_s": time.perf_counter() - t0}


def card_runs(train_run: dict) -> dict:
    """dryrun_card's work on the card: the argument bytes as parameters,
    caches and optimizer state are placed, each run's aten count and
    device ms, every parameter laid out on the one-rank (1, 1) mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import sharding as shd
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.models.convert import group_params
    from repro_torch.training import OptimizerConfig, TrainConfig
    from repro_torch.training.optimizer import members, stacked_shape
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    t_start = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH).full

    def placed(fn):
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.memory_allocated() - a0

    torch.cuda.empty_cache()
    out = {"placed": {}, "runs": {}, "device_ms": {}, "problems": []}
    # the serve phase's weights: seed 0
    model, out["placed"]["params"] = placed(
        lambda: build_model(cfg, DEVICE, seed=0))
    caches, out["placed"]["caches"] = placed(
        lambda: model.init_caches(*CARD_DECODE))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, CARD_PREFILL, device=DEVICE,
                           generator=gen)
    step_tokens = torch.randint(0, cfg.vocab_size, (CARD_DECODE[0], 1),
                                device=DEVICE, generator=gen)

    def prefill():
        return model.prefill(tokens)

    def decode():
        return model.decode_step(step_tokens, caches, CARD_PREFILL[1])

    for name, fn in (("prefill", prefill), ("decode", decode)):
        out["device_ms"][name] = device_ms(fn)["all"]
        out["runs"][name] = card_count(fn)
    del caches
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        name="adamw", master_fp32=True, moment_dtype="float32"),
        accum_steps=TRAIN_ACCUM)
    state, out["placed"]["train_state"] = placed(
        lambda: init_train_state(model, tcfg))
    step = make_train_step(model, tcfg)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                              device=DEVICE, generator=gen)
             for k in ("tokens", "labels")}
    out["runs"]["train"] = card_count(lambda: step(state, batch))
    out["device_ms"]["train"] = train_run["device_ms"]
    del state, batch

    t0 = time.perf_counter()
    mesh = make_debug_mesh(1, 1)
    checked = 0
    try:
        param_specs = model.param_specs()
        for path, leaf in group_params(model).items():
            spec = shd.resolve_spec(stacked_shape(leaf), param_specs[path],
                                    shd.RULE_PROFILES["train"], mesh)
            row = spec[1:] if isinstance(leaf, list) else spec
            for p in members(leaf):
                d = distribute_tensor(p.detach(), mesh,
                                      shd.to_placements(row, mesh))
                if tuple(d.to_local().shape) != shd.shard_shape(
                        tuple(p.shape), row, mesh):
                    out["problems"].append(f"{path}: local {tuple(d.shape)}")
                checked += 1
                del d
    finally:
        dist.destroy_process_group()
    out["dtensor_leaves"], out["dtensor_s"] = checked, time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    out["card_s"] = time.perf_counter() - t_start
    return out


def phase_dryrun_card(card: dict, meta: dict) -> None:
    """The dry run's accounting against the card (see the module
    docstring, phase 52): ``card`` from :func:`card_runs`, ``meta`` from
    :func:`phase_dryrun`."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, op_cost, roofline as rl, specs
    arch = get_arch(TRAIN_ARCH)
    one = dryrun.named_mesh("one")
    cells = card_cells()
    whole = {name: dryrun.build(arch, cell, None, TRAIN_ACCUM)
             for name, cell in cells.items()}

    def predicted(name: str, role: str) -> float:
        return op_cost.argument_bytes(
            [a for a in specs.arguments(whole[name]) if a[2].role == role],
            one)

    pred = {"params": predicted("prefill", "param"),
            "caches": predicted("decode", "cache"),
            "train_state": predicted("train", "state")}
    arg_rows = {k: {"pred_bytes": p, "card_bytes": card["placed"][k],
                    "rel_err": abs(card["placed"][k] - p) / p}
                for k, p in pred.items()}
    problems = list(card["problems"])
    problems += [f"{k} bytes: {r}" for k, r in arg_rows.items()
                 if r["rel_err"] > CARD_ARG_TOL]
    rows = {}
    for name, run in card["runs"].items():
        m = meta[name]
        meta_launches = {k: int(v) for k, v in m.launches.items() if v}
        card_flops = run["aten_flops"] + sum(m.kernel_flops.values())
        roof = rl.analyze(m, whole[name].meta, cells[name].step, 1, 0.0)
        bound_ms = 1e3 * max(roof.compute_s, roof.memory_s)
        dev = card["device_ms"][name]
        rows[name] = {
            "meta_flops": m.flops, "card_aten_flops": run["aten_flops"],
            "kernel_flops_per_launch": {
                k: m.kernel_flops[k] / m.launches[k] for k in m.launches},
            "launches_card": run["launches"],
            "launches_meta": meta_launches,
            "flops_equal": card_flops == m.flops
            and run["launches"] == meta_launches,
            "temp_pred_gb": m.peak_bytes / 1e9,
            "temp_card_gb": run["temp_bytes"] / 1e9,
            "temp_ratio": m.peak_bytes / max(run["temp_bytes"], 1),
            "compute_ms": 1e3 * roof.compute_s,
            "memory_ms": 1e3 * roof.memory_s, "device_ms": dev,
            "roofline_fraction": bound_ms / dev,
            "hbm_bytes_pred": m.hbm_bytes, "count_s": run["count_s"]}
        if not rows[name]["flops_equal"]:
            problems.append(f"{name}: card {card_flops} (launches "
                            f"{run['launches']}) != meta {m.flops} "
                            f"({meta_launches})")
    emit("dryrun_card", arch=TRAIN_ARCH, nvidia_smi=smi_line(), mesh=[1, 1],
         arguments=arg_rows, runs=rows,
         dtensor_leaves=card["dtensor_leaves"],
         dtensor_s=card["dtensor_s"], card_s=card["card_s"])
    if problems:
        raise AssertionError(f"dryrun_card: {problems}")


def capacity_dispatch(port, xf: torch.Tensor, gates: torch.Tensor,
                      expert_idx: torch.Tensor) -> torch.Tensor:
    """The capacity path that ``Moe.dispatch``'s grouped products replaced:
    every token gathered into (E, C, D) buffers (the rows no pair fills
    zero), three ``bmm`` over every row, each slot's gated output gathered
    back and summed in k order."""
    from repro_torch.models import layers, moe
    cfg = port.cfg
    e, k = cfg.n_experts, cfg.top_k
    n, d = xf.shape
    c = moe.capacity(n, cfg)
    slot = port.slots(expert_idx, c)
    tok = torch.full((e * c + 1,), n, dtype=torch.long, device=xf.device)
    tok[slot] = torch.arange(n * k, device=xf.device) // k
    gate = torch.zeros(e * c + 1, dtype=torch.float32, device=xf.device)
    gate[slot] = gates.reshape(-1)
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xd = x_pad[tok[:e * c]].reshape(e, c, d)
    h = torch.bmm(xd, port.wi.to(xd.dtype))
    g = layers.gate_act(torch.bmm(xd, port.wg.to(xd.dtype)), cfg.mlp_act)
    yd = torch.bmm(h * g, port.wo.to(xd.dtype)).reshape(e * c, d)
    yw = torch.cat([yd * gate[:e * c, None].to(yd.dtype),
                    yd.new_zeros((1, d))], dim=0)
    pairs = yw[slot].reshape(n, k, d)
    y = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        y = y + pairs[:, j].to(xf.dtype)
    return y


def phase_moe_dispatch() -> dict:
    """The grouped dispatch against the capacity path on one mixtral-8x7b
    MoE layer (see the module docstring, phase 55)."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(MOE_ARCH).full, n_layers=1,
                              capacity_factor=4.0, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    e, k, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    port = moe.Moe(cfg, device=DEVICE)
    port.init_weights(gen)
    problems, rows = [], {}
    for n in MOE_DISPATCH_TOKENS:
        x = torch.randn((n, d), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        _, gates, idx = port.route(x)
        got = port.dispatch(x, gates, idx)
        want = capacity_dispatch(port, x, gates, idx)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        c = moe.capacity(n, cfg)
        _, _, count = port._positions(idx)
        offs = torch.cumsum(torch.clamp(count, max=c), 0, dtype=torch.int32)
        xp = torch.randn((n * k, d), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        xd = torch.randn((e, c, d), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        grouped_ms, g_ahead = queued_ms(lambda: port.dispatch(x, gates, idx))
        capacity_ms, c_ahead = queued_ms(
            lambda: capacity_dispatch(port, x, gates, idx))
        experts_ms, e_ahead = queued_ms(lambda: port._ffn(xp, offs))
        bmm_ms, b_ahead = queued_ms(lambda: port._ffn(xd))
        rows[n] = {
            "capacity_rows": e * c, "packed_rows": n * k,
            "kept_pairs": int(offs[-1]), "max_abs_diff": err,
            "rel_diff": err / scale, "finite": bool(torch.isfinite(got).all()),
            "dispatch_ms": {"grouped": grouped_ms, "capacity": capacity_ms},
            "experts_ms": {"grouped": experts_ms, "capacity": bmm_ms},
            "queued_ahead": g_ahead and c_ahead and e_ahead and b_ahead,
            # the real pairs' operations at 989 TFLOP/s, or every expert's
            # three weights read once at 3.35 TB/s
            "bound_ms": 1e3 * max(3 * 2 * n * k * d * f / 989e12,
                                  3 * e * d * f * 2 / 3.35e12)}
        if err / scale > MOE_DISPATCH_TOL or not rows[n]["finite"]:
            problems.append(f"N={n}: {rows[n]}")
        del x, got, want, xp, xd
        torch.cuda.empty_cache()
    # a capacity that drops pairs: dropped tokens exactly zero
    tight = moe.Moe(dataclasses.replace(cfg, capacity_factor=1.0),
                    device=DEVICE)
    tight.load_state_dict(port.state_dict())
    x = torch.randn((4096, d), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    _, gates, idx = tight.route(x)
    c = moe.capacity(4096, tight.cfg)
    gone = (tight.slots(idx, c) == e * c).reshape(-1, k).all(-1)
    got = tight.dispatch(x, gates, idx)
    want = capacity_dispatch(tight, x, gates, idx)
    drop = {"capacity": c, "tokens_dropped": int(gone.sum()),
            "dropped_zero": bool((got[gone] == 0).all()),
            "finite": bool(torch.isfinite(got).all()),
            "rel_diff": (got.float() - want.float()).abs().max().item()
            / max(1.0, want.float().abs().max().item())}
    if not (drop["tokens_dropped"] and drop["dropped_zero"] and drop["finite"]
            and drop["rel_diff"] <= MOE_DISPATCH_TOL):
        problems.append(f"drops: {drop}")
    del port, tight, x, got, want
    torch.cuda.empty_cache()
    # grouped_mm in float32: empty, unaligned and full groups
    a = torch.randn((48, 64), generator=gen, device=DEVICE)
    w = torch.randn((4, 64, 96), generator=gen, device=DEVICE)
    offs = torch.tensor([3, 3, 17, 48], dtype=torch.int32, device=DEVICE)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = F.grouped_mm(a, w, offs=offs)
        waited = False
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        waited = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if waited:
        y = F.grouped_mm(a, w, offs=offs)
    bounds = [0] + offs.tolist()
    ref = torch.cat([a[s:t].double() @ w[g].double() for g, (s, t) in
                     enumerate(zip(bounds[:-1], bounds[1:]))])
    f32 = {"max_abs_diff": (y.double() - ref).abs().max().item(),
           "waited_for_card": waited}
    if f32["max_abs_diff"] > 1e-4:
        problems.append(f"float32: {f32}")
    emit("moe_dispatch", nvidia_smi=smi_line(), arch=MOE_ARCH, rows=rows,
         drops=drop, float32=f32, phase_s=time.perf_counter() - t0)
    if problems:
        raise AssertionError(f"moe_dispatch: {problems}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs = phase_kernel_vs_plain()
    phase_small_slice()
    launches = phase_slice()
    errs["mega_window"] = phase_mega_kernel_vs_plain()
    phase_small_slice(mega=True)
    launches["mega_window"] = phase_mega_slice()["mega_window"]
    phase_table1_small()
    phase_table1()
    errs["belief_efe_fleet_5tier"], launches_5tier = phase_hetero()
    phase_chaos()
    phase_resume()
    graph_err = phase_graph_kernel_vs_plain()
    phase_graph_small()
    graph_launches = phase_graph()
    warm_row = phase_warm()
    chaos_row = phase_mega_chaos_kernel_vs_plain()
    graph_row = phase_mega_graph_kernel_vs_plain()
    chaos_row["launches"] = phase_mega_chaos()
    phase_resume((("zone-outage", True),), "mega_chaos_resume")
    graph_row["launches"] = phase_mega_graph()
    shard_row = phase_shard_kernel_vs_plain()
    phase_shard_small()
    shard_launches = phase_shard()
    shard_row["launches"] = shard_launches["paper-burst"]
    shard_row["graph_launches"] = shard_launches["ring-spillover"]
    phase_shard_resume()
    phase_mega_fleet()
    errs.update(phase_attn_kernel_vs_plain())
    phase_serve_small()
    weights, serve_counts, lengths = phase_serve()
    phase_multitier(weights)
    del weights
    phase_event_small()
    phase_event_table1()
    rows = phase_times(errs, launches, launches_5tier)
    rows += [graph_times(graph_err, graph_launches), warm_row, chaos_row,
             graph_row, shard_row]
    rows += attn_times(errs, serve_counts, lengths)
    ssd_errs = phase_ssd_kernel_vs_plain()
    phase_serve_small(MAMBA_ARCH, (64, 50, 37, 64), "mamba_serve_small")
    weights, mamba_launches, _ = phase_serve(MAMBA_ARCH, 32, "mamba_serve")
    del weights
    rows.append(ssd_times(ssd_errs, mamba_launches))
    phase_serve_small(MOE_ARCH, (64, 50, 37, 64), "moe_serve_small")
    weights, moe_launches, moe_lengths = phase_serve(
        MOE_ARCH, 32, "moe_serve", n_layers=MOE_LAYERS, max_len=MOE_MAX_LEN,
        prompt_range=MOE_PROMPTS)
    del weights
    torch.cuda.empty_cache()
    phase_encdec_small()
    encdec_launches = phase_encdec()
    shapes = moe_encdec_attn_times(moe_launches, moe_lengths, encdec_launches)
    for row in rows:
        if row["name"] in shapes:
            row["moe_encdec_shapes"] = shapes[row["name"]]
    phase_train_small()
    train_run = phase_train()
    jamba_weights = phase_serve_small(JAMBA_ARCH, (64, 50, 37, 64),
                                      "jamba_serve_small")
    phase_serve_small(JAMBA_ARCH, (64, 50, 37, 64), "jamba_serve_small_dense",
                      weights=jamba_weights, dense_max=JAMBA_DENSE_MAX)
    del jamba_weights
    torch.cuda.empty_cache()
    weights, jamba_launches, jamba_lengths = phase_serve(
        JAMBA_ARCH, 32, "jamba_serve", n_layers=JAMBA_LAYERS)
    del weights
    torch.cuda.empty_cache()
    jamba = jamba_kernel_times(jamba_launches, jamba_lengths)
    for row in rows:
        if row["name"] in jamba:
            row["jamba_shape"] = jamba[row["name"]]
    card = {}
    meta = phase_dryrun(lambda: card.update(card_runs(train_run)))
    phase_dryrun_card(card, meta)
    example = example_attn_times(phase_examples())
    for row in rows:
        if row["name"] in example:
            row["serve_multitier_shapes"] = example[row["name"]]
    phase_moe_dispatch()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
