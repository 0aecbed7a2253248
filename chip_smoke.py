#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root (no arguments needed; ``--seed`` picks the
stream)::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device   -- the card's name and power limit (``nvidia-smi``);
2. build    -- the CUDA kernels are compiled from ``src/repro_torch/kernels/
               csrc`` (``nvcc``, ``sm_90a``) and loaded;
3. kernels  -- each of the four kernels against its plain PyTorch version
               on the card, at the main path's shapes and on edge cases
               (integers bit-exact, float32 within 3e-5), with its time, the
               plain version's time, one PyTorch library call's time where
               one computes the same function, and its bound; segment_sum
               is the sorted reduce-by-key (the main path's: one kernel a
               call, checked, float32 bit-identical from call to call, runs
               at its tile edges), with the order-blind scatter and its fill
               beside it, and both segment kernels also on a skewed input
               (a hot cell holding half of 1,048,576 rows) and with ptxas's
               registers and spills; the lookups
               on a steady-state table that holds the probe-window
               invariant, their edge cases on one that breaks it (kernel
               and plain version compute the same probe-window function
               there), their bound the probe window's bytes with the old
               full scan's reported apart; the two segment kernels, the
               lookups and the ``index_add_`` yardsticks also by device
               time per call under ``torch.profiler``; then every
               kernel wrapper's host microseconds per call at its main
               path's shape (beside ``index_add_``'s for the segment
               kernels), a ``cProfile`` of ``scatter_add_`` and the shared
               launch helper's steps timed one by one (``--host-only``
               runs this part alone after the build);
4. main     -- ``StreamExecutor`` + ``KeyedWindowAdapter`` (fused,
               ``device_table``) over a 1,048,576-key sliding-window stream
               at a real state size (8 x 262,144 table rows on the card),
               with a shrink and a grow; launch counters prove the path ran
               the kernels; a second, traced run gives each of the six
               fused stages' share; the run is held bit-exact against the same
               stream in ops mode ``ref`` and against a numpy group-by of
               every pane assignment; a ``fused=False`` run of the first
               8 chunks drives ``table_lookup``;
5. small    -- spill, TTL and early firing at a small size: kernels vs
               plain, fused vs loop, and the card vs the CPU, bit-identical;
6. attention kernels -- flash and decode attention against their plain
               versions on the card in bfloat16 (2e-2, and one bfloat16
               rounding step of each value) and float32 (3e-5), at
               the serve phase's shapes (prefill 6,144 tokens of Gemma2-27B's
               32/16 heads, window 4,096 and 0, softcap 50; decode 8 slots of
               an 8,192-row cache at ragged lengths), at the moe-serve
               phase's (16/16 heads, no window, softcap 0) and on edge
               cases, with
               the kernel's time, the plain version's, the bound, and
               ``scaled_dot_product_attention``'s time at softcap 0 as the
               yardstick (for decode with a per-slot mask and
               ``enable_gqa``); for flash also its TFLOP/s, its share of the
               bound, the first version's recorded time, ptxas's registers,
               spills and shared memory, and the HGMMA (``wgmma``)
               instructions ``cuobjdump -sass`` finds in the bf16 kernel;
               for decode its share of the bound, the first version's
               recorded time, the split count, the blocks that hold rows,
               its device time at 6 short slots (the serve phases' profiled
               step) and ptxas's registers and spills of every instance;
               then head_dim 256 (PaliGemma-3B's 8 q heads over 1 kv head:
               flash over 4,096 tokens, decode over the same slots) and
               decode at 16 q heads per kv head, each against its plain
               version in both dtypes, timed beside SDPA at softcap 0;
               then flash at phase 15's shapes: the prefix-LM mask at
               PaliGemma-3B's (8 q heads over 1, hd 256, 256 of 4,096
               positions) and on the wgmma route (hd 128, 200 of 1,000),
               SeamlessM4T-medium's bidirectional encoder (16/16 heads, hd
               64, 1,024 frames) and cross prefill (4,096 queries x 1,024
               frames), each in both dtypes, timed beside SDPA on the same
               boolean mask; then the training path's flash backward (three
               kernels a call: D, dK/dV, dQ) and the forward's row
               log-sum-exp against their plain versions in both dtypes at
               MiniCPM-2B's layer (36/36 heads, 4,096 tokens, hd 64),
               Gemma2's (softcap 50, window 4,096, 32/16, hd 128, 5,000
               tokens), PaliGemma's prefix-LM (hd 256, 8/1, P 256),
               Seamless's encoder and cross attention, and edges (Sq off
               the tile, a window shorter than a tile, one kv head, rows
               that admit no key): float32 gradients within 1e-4 of each
               one's largest magnitude, bfloat16 within 2e-2 of it and one
               rounding step of each value, a second call bit-identical; at
               MiniCPM's shape and Gemma2's local layer's (bf16: the wgmma
               kernels) its time beside the plain version's, the bound and
               SDPA's backward, ptxas's registers and spills of its kernels
               and the HGMMA instructions of the two bf16 ones, which must
               have some (``--train-only`` runs this part and phase 16
               after the build);
7. gemma2-serve -- ``ServingEngine`` over Gemma2-27B at full width (16 of
               46 layers, random weights from the seed, bfloat16), 8 slots
               of 8,192 positions, 16 requests of 256-6,144 prompt tokens and
               32-64 new tokens, a resize to 6 slots after tick 20; launch
               counters must equal layers x prefills (flash) and layers x
               decode steps (decode attention); check (i) runs the same
               schedule again in ops mode ``ref``, serving the kernel run's
               tokens, and holds every request's last logits to the kernel
               run's (RMS share of their spread, ``BF16_LOGIT_RMS``) and its
               argmax to the kernel run's token; check (ii) a float32 2-layer
               model at full width gives the same tokens with kernels, in
               ``ref`` mode (last logits within 1e-4) and served one request
               at a time; a profiled decode step and long prefill;
8. ssm-moe kernels -- the SSD scan against its plain version in float32
               (2e-4) and bfloat16 (5e-2, and one bfloat16 rounding step of
               each value) at Mamba2-780M's shapes (48 heads of 64, state
               128, one shared B/C group) for the longest prompt of phase 9
               (8,192 tokens), on edges (one token, lengths no chunk
               divides) and with B/C per head, at dt about 0.7 and at a
               trained model's small dt, where the state carried across
               chunks decides the result (checked); its time beside the
               first version's, its device time per pass under
               ``torch.profiler``, TFLOP/s, share of the bound, chunk, the
               chunk states' bytes and ptxas's registers and spills of
               every instance; the MoE gather bit-exact at
               DeepSeekMoE-16B's dispatch of a 6,144-token prompt and of one
               8-slot decode step, a sequence of only dummy rows and rows of
               12 and 10 bytes; times (by events and by device time),
               bounds, and ``index_select`` on the zero-padded input as the
               gather's yardstick, at both shapes; then the training path's
               two backward kernels: the scan's (five launches a call) against
               ``ssd_scan_backward_ref`` at Mamba2-780M's layer at 4,096 and
               8,192 tokens, one token, a ragged tail, B/C per head, a
               trained model's small dt and a final-state gradient, float32
               within 2e-4 of each gradient's largest magnitude, bfloat16
               within 5e-2 of it and one rounding step of each value, two
               calls bit-identical, its time beside the plain version's and
               the bound (device time per launch, ptxas's registers and
               spills); the gather's at DeepSeekMoE-16B's dispatch of a
               4,096-token row bit-exact against its plain version, within
               one rounding step of a float32 ``index_add_``, on only dummy
               rows, its time beside the bound and ``index_add_``'s
               (``--train-only`` runs this part too);
9. mamba2-serve -- phase 7's run over Mamba2-780M at full width and
               depth (48 layers, ``dt_bias`` as a trained model's), 8 slots,
               ``s_max`` 16,384, one prompt of 5-16 tokens and 15 of
               256-8,192: the scan launches once per layer per prefill, and
               the long prefill's profile names its three kernels;
               checks (i) and (ii) as in phase 7, (i) to its own limits
               (``MAMBA_LOGIT_RMS``, ``MAMBA_LEAD``);
10. moe-serve  -- the same over DeepSeekMoE-16B at full width and depth (a
               dense layer, then 27 MoE layers of 64 experts, top 6, plus 2
               shared), 8 slots of 8,192: flash and decode attention as in
               phase 7, the gather once per MoE layer per prefill and per
               decode step; checks (i) (its replay taking the kernel run's
               expert choices) and (ii), where (ii)'s two layers are the
               dense one and one MoE layer;
11. supervised -- phase 4's stream and configuration under the port's
               ``Supervisor``: a checkpoint every 6 chunks into a temporary
               directory (removed at the end), a failure before chunk 15, a
               restore of chunk 12's checkpoint, a shrink to 4 and a grow
               back to 8 four chunks later; every chunk's emissions, early
               and late channels and the final rows bit-exact against phase
               4's run, every event kind logged, the black box a Chrome
               trace holding the 15 ``chunk`` spans before the failure, the
               three keyed kernels launched on each replayed chunk; the
               checkpoint's bytes, the seconds to save and restore it, the
               recovery time as the reference defines it and the first
               replayed chunk's wall (which puts the restored rows back on
               the card).  Then the same stream under ``Autoscaler`` with
               ``SLOLatencyPolicy`` (an objective of 3x phase 4's chunk
               median) and no schedule: the degree must change, the run stay
               bit-exact; the decisions are printed with their signals;
12. serving-runtime -- ``ServingRuntime`` over phase 7's Gemma2-27B (16
               layers, bfloat16, 8,192 positions a slot, slot counts 2, 4
               and 8), requests from ``request_source`` with prompts of
               256-2,048 tokens and 32 new tokens: (a) a burst of 12 under
               ``QueueDepthPolicy`` must grow the slot count; (b) a burst of
               8 from 8 slots under an objective no decode step meets, read
               through an ``SLOTracker`` fed from the engine's
               ``serving.decode_step_s`` histogram, must breach and shrink
               it; every request completes, and flash (decode) attention
               launches once per layer per prefill (decode step); (a) again
               on check (ii)'s float32 two-layer model must give each
               request the tokens it gets alone;
13. patterns -- the paper's five state access patterns on the card
               through their entry points: ``SerialState.run`` on a
               ``WorkerMesh``, and ``StreamExecutor`` with the SPMD
               adapters (default mesh factory: the card) over 1,048,576
               int64 slots (S2 block, degrees 8 -> 4 -> 2 -> 8; S2 slotmap
               replicated per worker, 3 -> 5 -> 7) and streams of 65,536
               tasks (S3 at ``flush_every`` 1, 16 and 256 and 8 -> 4 -> 8;
               S4 on a float32 fitness stream at ``sync_every`` 1 and 64,
               8 -> 2 -> 8; S5 4 -> 8), each bit-exact against the port's
               CPU oracle (``core.semantics``) and its schedule-dependent
               outputs (S3's stale-view ys, S4's traces) against the same
               run on the CPU; then S3 under ``Supervisor`` with a failure,
               equal to the unfailed 8 -> 4 -> 8 run.  Per run: the wall,
               microseconds per scan step, and one chunk under
               ``torch.profiler`` (kernels per step, the device's busy
               share) and CUDA's sync debug mode (the chunk's host
               synchronizations: its copy to the card and nothing else);
               no kernel of ours runs here;
14. dist    -- phase 4's stream and configuration through
               ``DistributedKeyedPlane``: 8 spawned shard-host processes,
               each with its own CUDA context running its shard's engine
               (``device_table``, 262,144 rows) and the keyed kernels on
               the card.  (a) the ring transport under ``StreamExecutor``
               with the scatter-ahead pipeline, a warm spare, the shrink to
               5 and the grow to 8: every chunk's outputs, the chunk-8 and
               final snapshots and the migrated rows and slots equal to
               phase 4's, ``step_ahead`` on every chunk but each run's
               first, no fault event, the workers' launches of
               segment_sum, table_lookup and scatter_add (shipped on their
               ``shard_step`` spans) each above 0; printed: the seconds
               from spawn to the last HELLO, each worker's card memory, the
               wall, items/s and chunk median beside phase 4's, the
               workers' ``shard_step`` time a chunk, the wire bytes by
               family and transport, the launches; (b) the same plane under
               ``Supervisor`` (a checkpoint every 6 chunks), shard 3's
               worker killed before chunk 15: the spare promoted, outputs
               and final rows equal to phase 4's, one death and one
               recovery, the plane's MTTR beside phase 11's; (c) the pipe
               transport over the first 8 chunks, equal to phase 4's; (d)
               after each plane closes, none of its workers alive and none
               of its ring segments left.  ``--dist-only`` runs phases 4
               and 14 alone after the build;
15. families -- every other architecture the JAX package registers, at
               full width, one after another (random bfloat16 weights from
               the seed, each freed before the next): Kimi-K2 (its dense
               first layer and one MoE layer of 384 experts) and
               Jamba-1.5-Large (layers 0-3 of its unit: Mamba with dense,
               Mamba with MoE, Mamba with dense, attention with MoE) first,
               then PaliGemma-3B at full depth (four requests of 256 patch
               embeddings and 768-3,840 tokens, the prefix-LM mask),
               SeamlessM4T-medium at full depth (12 encoder and 12 decoder
               layers; 1,024 source frames and 1,024-4,096 tokens a
               request, each slot decoding against its own encoder output)
               and CodeQwen1.5-7B, Granite-8B and MiniCPM-2B at 4 layers.
               Each request is prefilled alone into its slot of a 4-slot
               cache through ``prefill_forward``, then the slots decode
               together (32 steps; 16 for the cut models) through
               ``decode_forward`` at their own positions.  Launch counts
               (flash per attention, encoder and cross layer per run,
               decode per self and cross layer per step, the scan per Mamba
               layer per prefill, the gather per MoE layer per prefill and
               step), check (i) against a replay in ops mode ``ref`` on the
               kernel run's tokens and MoE routing (limits per model), and
               check (ii) on a float32 2-layer model at full width (not for
               the two largest); printed per model: the cut, prefill ms per
               prompt position, decode step ms, generated tokens/s, weight
               bytes and ``max_memory_allocated``; one profiled PaliGemma
               prefill names the flash kernel and its share of device time.
               ``--families-only`` runs it alone after the build.
16. train   -- in a child process with ``CUBLAS_WORKSPACE_CONFIG`` set and
               ``torch.use_deterministic_algorithms(True)``: (a)
               MiniCPM-2B at full width and depth (40 layers, bf16, random
               weights from the seed) trained 8 steps by
               ``build_train_step`` under ``TrainLoop`` on ``SyntheticLM``
               (4 microbatches of one 4,096-token row, remat, float32
               accumulation, AdamW with the WSD schedule): finite losses
               whose last 3 average below the first, per step flash forward
               = layers x microbatches x 2 and the backward layers x
               microbatches; step ms, tokens/s, model FLOP/s
               (``model_flops_per_token``) and its share of 989 TFLOP/s,
               ``max_memory_allocated``, one profiled step's device time by
               kernel class, the AdamW update and one microbatch's cross
               entropy by events; (b) check (ii) for training: a float32
               2-layer model, one step in ops mode ``kernel`` against
               ``ref`` (loss 1e-5, each gradient leaf 1e-4 of its largest,
               the parameters after the step), then bf16 at full depth the
               first step's loss and gradient norm against ref mode
               (calibrated limits); (c) ``TrainLoop`` on 2 layers at full
               width, 6 steps, a checkpoint every 3, an ``InjectedFailure``
               before step 4 (the loop's ``fail_at=4``): the final
               parameters and optimizer state bit-identical to the
               uninterrupted run's, every bfloat16 leaf written with descr
               ``'<V2'``, a checkpoint's bytes and the save and restore
               seconds (on tmpfs when it has room).
17. train-ssm-moe -- in phase 16's child: (a) Mamba2-780M at full width and
               depth (48 layers, Mamba-2's published ``dt_bias`` init) and
               DeepSeekMoE-16B at full width cut to its dense first layer
               and 3 MoE layers, each trained 8 steps as phase 16 (4
               microbatches of one 4,096-token row, remat, float32
               accumulation): finite losses, the first batch's loss lower
               after the 8 steps, and (Mamba2, whose stream loss falls in 8
               steps) the last 3 averaging below the first; per step the
               scan's forward and backward launches =
               Mamba layers x microbatches x 2 and x 1, the same for the
               gather per MoE layer and flash per attention layer; step ms,
               tokens/s, model FLOP/s and its share, peak memory and one
               profiled step's device time by kernel class (the two new
               backward kernels named); (b) check (ii): a float32 2-layer
               model, one step kernel against ref (loss 1e-5, gradients 1e-4,
               a Mamba mixer's 2e-4, parameters), then bf16 at (a)'s depth
               the first step's loss and gradient norm against ref mode
               (limits calibrated with ``--plant-fault``; MoE routes pinned
               to the kernel run's); (c) Jamba-1.5-Large's first 4 layers at
               d_model 1,024, one float32 step kernel against ref: the scan,
               the gather and flash backward in one model.

The last lines are a ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM published peaks (dense, 700 W): HBM bytes/s and the
#: 32-bit non-tensor-core operation rate (the float32 rate of the data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: the bf16 tensor-core rate, the bound of attention's products
PEAK_BF16_S = 989e12
#: the first flash kernel's time for phase 6's bf16 pair (float32 FMAs on the
#: CUDA cores; PERF.md kernel table, row 5, H100 80GB HBM3 at 700 W), printed
#: beside the tensor-core kernel's for reference
FLASH_FIRST_VERSION_MS = 23.9582
#: the first decode kernel's time for phase 6's bf16 pair (one block per
#: slot and kv head; PERF.md kernel table, row 6, H100 80GB HBM3 at 700 W),
#: printed beside the split-KV kernel's for reference
DECODE_FIRST_VERSION_MS = 0.88111
#: the first SSD scan kernel's time for phase 8's bf16 Mamba2-780M layer (one
#: block per head and 32 columns walking the chunks in series, float32 FMAs;
#: PERF.md kernel table, row 7, H100 80GB HBM3 at 700 W), printed beside the
#: chunk-parallel kernels' for reference
SSD_FIRST_VERSION_MS = 2.8495
F32_TOL = 3e-5
BF16_TOL = 2e-2
#: one bfloat16 rounding step relative to the value (8 significant bits):
#: a kernel and its plain version both do float32 math and round once, so
#: their bfloat16 outputs differ by at most this much of each value (plus
#: the float32 tolerance)
BF16_STEP = 2.0 ** -7
#: check (i): the bfloat16 main run's last logits against its replay in ops
#: mode ref may differ by this share of the logits' standard deviation (RMS
#: over the vocabulary).  The two differ only where an attention output
#: rounds to the other neighbouring bfloat16 value, and 16 layers of a
#: bfloat16 residual stream spread that to 0.0142 (PERF.md); the limit is
#: about twice the reading.
BF16_LOGIT_RMS = 0.03
#: check (ii): float32 logits, absolute and relative, as the CPU tests hold
#: the port's model to the reference's
F32_MODEL_TOL = 1e-4

# main-phase configuration: a Nexmark Query 5 style sliding "hot items"
# window, sum + count per key
N_KEYS = 1 << 20
CHUNK = 16384
N_CHUNKS = 36
DEGREE = 8
SCHEDULE = {12: 5, 24: 8}
NUM_SLOTS = 256
CAPACITY = 262144
MAX_PROBES = 16
SIZE, SLIDE, LATENESS = 131072, 32768, 4096
DISORDER = 1024
LOOP_CHUNKS = 8

KERNEL_META = {
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                    "src/repro/kernels/segment_reduce.py:115"),
    "scatter_add": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                    "src/repro/kernels/segment_reduce.py:160"),
    "table_lookup": ("src/repro_torch/kernels/csrc/hash_table.cu",
                     "src/repro/kernels/hash_table.py:111"),
    "batched_table_lookup": ("src/repro_torch/kernels/csrc/hash_table.cu",
                             "src/repro/kernels/hash_table.py:206"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:125"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:99"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:98"),
    "moe_gather": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                   "src/repro/kernels/moe_dispatch.py:54"),
    # no Pallas site: the reference trains through its jnp block-chunked
    # attention, which jax.grad differentiates
    "flash_attention_backward": (
        "src/repro_torch/kernels/csrc/flash_attention_backward.cu",
        "src/repro/models/attention.py:171"),
    # no Pallas site either: the reference trains through its jnp chunked
    # scan and take_along_axis, which jax.grad differentiates
    "ssd_scan_backward": ("src/repro_torch/kernels/csrc/ssd_scan_backward.cu",
                          "src/repro/models/mamba2.py:79"),
    "moe_gather_backward": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                            "src/repro/models/moe.py:140"),
}

# the attention kernels' phase-6 shapes: the Gemma2-27B serve phase's, and
# DeepSeekMoE-16B's 16 heads over 16 kv heads (softcap 0, no window)
MOE_HEADS = 16
#: tokens of phase 6's head_dim 256 flash layer (PaliGemma-3B's 8 q heads
#: over 1 kv head)
PALI_PROMPT = 4096
SERVE_SLOTS = 8
SERVE_SMAX = 8192
SERVE_PROMPT = (256, 6144)
F32_NEW = 8
#: the SSD scan's tolerances, the reference's for its own kernel
SSD_F32_TOL = 2e-4
SSD_BF16_TOL = 5e-2
#: the Mamba2 serve phase's prompt lengths (phase 8 times the longest)
MAMBA_PROMPT = (256, 8192)
#: dt = softplus(randn - SMALL_DT_SHIFT): 3e-4 to 0.1, a trained Mamba-2's
#: range, where the state carries across many chunks
SMALL_DT_SHIFT = 5.0

#: check (i)'s limits for Mamba2-780M, whose 48 bfloat16 layers spread a
#: rounding step further than Gemma2's 16 (PERF.md, H100): the sound run
#: reads 0.0391 RMS and a lead of 1.46; with the scan's carry into its
#: final state's last chunk dropped (a planted fault) it reads 0.0536 and
#: 1.85.  Check (ii), in float32, reads that fault at 60x its tolerance.
MAMBA_LOGIT_RMS = 0.046
MAMBA_LEAD = 1.65

#: every serve phase: 8 slots (SERVE_SLOTS), 16 requests of 32-64 new
#: tokens, a resize to 6 slots after tick 20
SERVE_REQUESTS = 16
SERVE_NEW = (32, 64)
SERVE_RESIZE = (20, 6)
#: the serve phases: each model at full width; ``rms`` and ``lead`` are
#: check (i)'s limits: the RMS share of the last logits' spread (see
#: BF16_LOGIT_RMS), and the lead of the ref run's own argmax over the
#: kernel run's token in units of the bfloat16 tolerance
SERVES = {
    # phase 7: Gemma2-27B cut to 16 of 46 layers
    "gemma2-serve": dict(
        model="gemma2-27b", layers=16, s_max=SERVE_SMAX, prompt=SERVE_PROMPT,
        f32_prompts=(4200, 300, 5000, 4700), rms=BF16_LOGIT_RMS, lead=1.0),
    # phase 9: Mamba2-780M at full depth, one short prompt of 5-16 tokens,
    # dt_bias as a trained model's (trained_dt_bias_)
    "mamba2-serve": dict(
        model="mamba2-780m", layers=48, s_max=16384, prompt=MAMBA_PROMPT,
        short=(5, 16), trained_dt=True, f32_prompts=(7000, 9, 300, 5000),
        rms=MAMBA_LOGIT_RMS, lead=MAMBA_LEAD,
        # the prefill profile lists the scan's three kernels
        watch=("ssd::",), watched=3),
    # phase 10: DeepSeekMoE-16B at full depth; with its replay's routing
    # pinned, check (i) holds it to Gemma2's limits (PERF.md, H100: 0.0168
    # RMS and a lead of 0.55 sound, 0.0755 and 2.08 with a gather row off
    # by one)
    "moe-serve": dict(
        model="deepseek-moe-16b", layers=28, s_max=SERVE_SMAX,
        prompt=SERVE_PROMPT, f32_prompts=(4200, 300, 5000, 4700),
        rms=BF16_LOGIT_RMS, lead=1.0),
}


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def in_turns(measure, fns, rounds):
    """The median of ``rounds`` readings ``measure(fn)`` of each of ``fns``
    (a dict), taken in turns (a, b, b, a, ...) so that a drift of the host
    or the card falls on all of them alike."""
    got = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(measure(fns[k]))
    return {k: float(np.median(v)) for k, v in got.items()}


def _device_us(event):
    """A profiler row's own device time in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms_by_kernel(torch, fn, reps):
    """Device milliseconds per call of ``fn`` by kernel name, under
    ``torch.profiler`` over ``reps`` calls after one warm-up call: each
    kernel's own time on the card, without the host time between launches
    that back-to-back CUDA events also count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: _device_us(e) / reps / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e)}


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def make_stream(seed, keyed_stream):
    """1,048,576 distinct int64 keys; items pick one uniformly, values in
    [0, 100), one timestamp per item with +-1,024 disorder."""
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(-2 ** 63, 2 ** 63 - 1,
                                      size=N_KEYS + 4096, dtype=np.int64))
    universe = rng.permutation(universe)[:N_KEYS]
    check(len(universe) == N_KEYS, "key universe too small")
    n = CHUNK * N_CHUNKS
    keys = universe[rng.integers(0, N_KEYS, size=n)]
    values = rng.integers(0, 100, size=n)
    ts = np.arange(n, dtype=np.int64) + rng.integers(-DISORDER, DISORDER + 1,
                                                     size=n)
    return keyed_stream(keys, values, ts)


def pane_assignments(items):
    """Every (key, start, value) pane assignment of the sliding window, in
    numpy — the independent reference's input."""
    ts = items["ts"].astype(np.int64)
    panes = -(-SIZE // SLIDE)
    hi = (ts // SLIDE) * SLIDE
    starts = hi[:, None] - np.arange(panes, dtype=np.int64)[None, :] * SLIDE
    sel = (starts > (ts - SIZE)[:, None]).reshape(-1)
    rep = np.repeat(np.arange(len(ts)), panes)[sel]
    return (items["key"][rep].astype(np.int64), starts.reshape(-1)[sel],
            items["value"][rep].astype(np.int64))


def group_by(key, start, value):
    order = np.lexsort((start, key))
    k, s, v = key[order], start[order], value[order]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]) | (s[1:] != s[:-1])
    g = np.flatnonzero(new)
    return (k[g], s[g], np.add.reduceat(v, g),
            np.diff(np.append(g, len(k))).astype(np.int64))


def sorted_rows(key, start, value, count):
    order = np.lexsort((start, key))
    return np.stack([key[order], start[order], value[order], count[order]])


# ---------------------------------------------------------------------------
# output comparison
# ---------------------------------------------------------------------------

def outputs_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for ch in ("emissions", "late", "early"):
            if set(x[ch]) != set(y[ch]):
                return False
            for k in x[ch]:
                if x[ch][k].dtype != y[ch][k].dtype or \
                        not np.array_equal(x[ch][k], y[ch][k]):
                    return False
    return True


def states_equal(a, b):
    return set(a) == set(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(a[k], b[k]) for k in a
    )


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, items):
    from repro_torch.keyed import cell_hash, dedup_cells, expand_panes
    from repro_torch.keyed import hash_to_slot, WindowSpec
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)

    def t(a):
        return torch.as_tensor(a, device=dev)

    records = {}

    # -- the main path's shapes: chunk 0 of the stream ------------------------
    chunk = items[:CHUNK]
    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    a_key, a_val, _, _, a_start = expand_panes(
        spec, t(chunk["key"].copy()), t(chunk["value"].copy()),
        t(chunk["ts"].copy()), t(np.arange(CHUNK)),
    )
    cells, inv = dedup_cells(a_key, a_start)
    n_cells, n_rows = len(cells), len(a_key)
    order = torch.argsort(inv, stable=True)
    seg_ids = inv[order].to(torch.int32).contiguous()
    seg_vals = torch.stack([a_val, torch.ones_like(a_val)], 1)[order] \
        .to(torch.int32).contiguous()

    # -- segment_sum: the sorted reduce-by-key (the main path's) ---------------
    errs = []
    got = sr.segment_sum_sorted(seg_vals, seg_ids, n_cells)
    check(torch.equal(got, ref.segment_sum_sorted(seg_vals, seg_ids, n_cells))
          and torch.equal(got, ref.segment_sum_ref(seg_vals, seg_ids,
                                                   n_cells)),
          "segment_sum_sorted main shape")
    errs.append(0.0)
    # edge cases: runs that end one row before, at and after the kernel's
    # tile edges, one run of two tiles + 1, ids out of range at both ends,
    # int32 wraparound, empty, float32 (bit-identical from call to call)
    tile = sr.SORTED_TILE
    lengths = [tile - 1, 1, tile, 1, 2 * tile + 1, tile - 2, 3, tile + 1]
    te_ids = t(np.repeat(np.arange(0, 3 * len(lengths), 3), lengths)
               .astype(np.int32))
    te_n = 3 * len(lengths) + 1
    te_vals = t(rng.integers(2 ** 31 - 200, 2 ** 31, (len(te_ids), 2))
                .astype(np.int32))
    check(torch.equal(sr.segment_sum_sorted(te_vals, te_ids, te_n),
                      ref.segment_sum_sorted(te_vals, te_ids, te_n)),
          "segment_sum_sorted tile edges / wraparound")
    o_ids = t(np.sort(rng.integers(-600, 1500, 3 * tile + 5))
              .astype(np.int32))
    o_vals = t(rng.integers(2 ** 31 - 200, 2 ** 31, (len(o_ids), 2))
               .astype(np.int32))
    check(torch.equal(sr.segment_sum_sorted(o_vals, o_ids, 1000),
                      ref.segment_sum_ref(o_vals, o_ids, 1000)),
          "segment_sum_sorted ids out of range at both ends")
    empty = sr.segment_sum_sorted(
        torch.zeros((0, 2), dtype=torch.int32, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev), 7)
    check(empty.shape == (7, 2) and not empty.any(),
          "segment_sum_sorted empty")
    f_vals = t(rng.standard_normal((len(te_ids), 2)).astype(np.float32))
    f_got = sr.segment_sum_sorted(f_vals, te_ids, te_n)
    f_want = ref.segment_sum_ref(f_vals, te_ids, te_n)
    f_err = float((f_got - f_want).abs().max())
    check(torch.allclose(f_got, f_want, atol=F32_TOL, rtol=F32_TOL),
          f"segment_sum_sorted float32 error {f_err}")
    check(torch.equal(f_got, sr.segment_sum_sorted(f_vals, te_ids, te_n)),
          "segment_sum_sorted float32: a second call differs")
    errs.append(f_err)
    # the order-blind kernel (no main-path caller): a scatter into zeros
    e_ids = t(rng.integers(0, 70, 5000).astype(np.int32))
    e_vals = t(rng.integers(2 ** 31 - 200, 2 ** 31, (5000, 3)).astype(np.int32))
    check(torch.equal(sr.segment_sum(e_vals, e_ids, 50),
                      ref.segment_sum_ref(e_vals, e_ids, 50)),
          "segment_sum wraparound / dropped ids")
    f_vals = t(rng.standard_normal((5000, 2)).astype(np.float32))
    f_got = sr.segment_sum(f_vals, e_ids, 50)
    f_want = ref.segment_sum_ref(f_vals, e_ids, 50)
    f_err = float((f_got - f_want).abs().max())
    check(torch.allclose(f_got, f_want, atol=F32_TOL, rtol=F32_TOL),
          f"segment_sum float32 error {f_err}")
    errs.append(f_err)

    def kernel_fn():
        return sr.segment_sum_sorted(seg_vals, seg_ids, n_cells)

    def blind_fn():
        return sr.segment_sum(seg_vals, seg_ids, n_cells)

    ids_l = seg_ids.to(torch.int64)

    def library_fn():
        return torch.zeros((n_cells, 2), dtype=torch.int32,
                           device=dev).index_add_(0, ids_l, seg_vals)

    ms = cuda_ms(torch, kernel_fn, 50)
    plain = cuda_ms(torch, lambda: ref.segment_sum_sorted(
        seg_vals, seg_ids, n_cells), 20)
    lib = cuda_ms(torch, library_fn, 50)
    b_ms, b_by = bound(n_rows * 4 + n_rows * 2 * 4 + n_cells * 2 * 4,
                       n_rows * 2)
    turns = in_turns(lambda f: cuda_ms(torch, f, 50),
                     {"kernel": kernel_fn, "library": library_fn,
                      "order_blind": blind_fn}, 7)
    device = device_ms_by_kernel(torch, kernel_fn, 50)
    check(len(device) == 1, f"segment_sum_sorted launched {device}")
    blind_device = device_ms_by_kernel(torch, blind_fn, 50)
    lib_device = device_ms_by_kernel(torch, library_fn, 50)
    # a hot cell: half of 1,048,576 rows in one cell, the rest spread over
    # 200,000 (Nexmark's hot items), through the look-back over records
    n_skew = 1 << 20
    sk_ids = torch.sort(torch.cat([
        torch.randint(0, 200_000, (n_skew // 2,), generator=gen, device=dev),
        torch.full((n_skew // 2,), 70_001, device=dev)])).values \
        .to(torch.int32)
    sk_vals = torch.randint(0, 100, (n_skew, 2), dtype=torch.int32,
                            generator=gen, device=dev)
    check(torch.equal(sr.segment_sum_sorted(sk_vals, sk_ids, 200_000),
                      ref.segment_sum_sorted(sk_vals, sk_ids, 200_000)),
          "segment_sum_sorted skewed input")
    sk_l = sk_ids.to(torch.int64)

    def skew_kernel():
        return sr.segment_sum_sorted(sk_vals, sk_ids, 200_000)

    def skew_library():
        return torch.zeros((200_000, 2), dtype=torch.int32,
                           device=dev).index_add_(0, sk_l, sk_vals)

    sk_bound, _ = bound(n_skew * 12 + 200_000 * 8, n_skew * 2)
    sk_turns = in_turns(lambda f: cuda_ms(torch, f, 20),
                        {"kernel": skew_kernel, "library": skew_library}, 3)
    ptxas = build_report("segment_reduce.cu")
    records["segment_sum"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        ms_median_of_7_in_turns=turns["kernel"],
        library_ms_median_of_7_in_turns=turns["library"],
        order_blind_ms_median_of_7_in_turns=turns["order_blind"],
        device_ms=device, device_ms_sum=sum(device.values()),
        order_blind_device_ms=blind_device,
        order_blind_device_ms_sum=sum(blind_device.values()),
        library_device_ms=lib_device,
        library_device_ms_sum=sum(lib_device.values()),
        skewed=dict(ms_median_of_3_in_turns=sk_turns["kernel"],
                    library_ms_median_of_3_in_turns=sk_turns["library"],
                    device_ms=device_ms_by_kernel(torch, skew_kernel, 20),
                    library_device_ms=device_ms_by_kernel(
                        torch, skew_library, 20),
                    bound_ms=sk_bound,
                    shape=f"values [{n_skew},2] i32, half in one cell "
                          "-> [200000,2]"),
        ptxas={k: v for k, v in ptxas.items() if "sorted" in k}
        if isinstance(ptxas, dict) else ptxas,
        shape=f"values [{n_rows},2] i32 -> [{n_cells},2], sorted ids")

    # -- scatter_add: the table accumulate, int64 ------------------------------
    total = DEGREE * CAPACITY
    table = t(rng.integers(0, 1000, (total, 2)))
    rows_at = t(rng.choice(total, size=n_cells, replace=False)
                .astype(np.int32))
    partial = t(rng.integers(0, 400, (n_cells, 2)))
    got = sr.scatter_add_(table.clone(), rows_at, partial)
    want = ref.scatter_add_ref(table, rows_at, partial)
    check(torch.equal(got, want), "scatter_add main shape")
    # edge cases: ids >= C dropped, repeats, int64 and int32 wraparound,
    # rows at an 8-byte offset (the generic column loop), float32, empty
    e_tab = t(rng.integers(2 ** 62, 2 ** 63 - 1, (64, 2)))
    e_ids = t(rng.integers(-8, 80, 4000).astype(np.int32))
    e_rows = t(rng.integers(2 ** 61, 2 ** 62, (4000, 2)))
    check(torch.equal(sr.scatter_add_(e_tab.clone(), e_ids, e_rows),
                      ref.scatter_add_ref(e_tab, e_ids, e_rows)),
          "scatter_add int64 wraparound / dropped ids")
    shifted = torch.empty(2 * 4000 + 1, dtype=torch.int64, device=dev)
    shifted[1:] = e_rows.flatten()
    check(torch.equal(sr.scatter_add_(e_tab.clone(), e_ids,
                                      shifted[1:].view(4000, 2)),
                      ref.scatter_add_ref(e_tab, e_ids, e_rows)),
          "scatter_add rows at an 8-byte offset")
    i_tab = e_tab.to(torch.int32)
    i_rows = t(rng.integers(2 ** 30, 2 ** 31 - 1, (4000, 2)).astype(np.int32))
    check(torch.equal(sr.scatter_add_(i_tab.clone(), e_ids, i_rows),
                      ref.scatter_add_ref(i_tab, e_ids, i_rows)),
          "scatter_add int32 wraparound")
    f_tab = t(rng.standard_normal((64, 2)).astype(np.float32))
    f_rows = t(rng.standard_normal((4000, 2)).astype(np.float32))
    f_got = sr.scatter_add_(f_tab.clone(), e_ids, f_rows)
    f_want = ref.scatter_add_ref(f_tab, e_ids, f_rows)
    f_err = float((f_got - f_want).abs().max())
    check(torch.allclose(f_got, f_want, atol=F32_TOL, rtol=F32_TOL),
          f"scatter_add float32 error {f_err}")
    check(torch.equal(sr.scatter_add_(
        e_tab.clone(), torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros((0, 2), dtype=torch.int64, device=dev)), e_tab),
        "scatter_add empty")
    work = table.clone()
    rows_l = rows_at.to(torch.int64)

    def kernel_fn():
        return sr.scatter_add_(work, rows_at, partial)

    def library_fn():
        return work.index_add_(0, rows_l, partial)

    ms = cuda_ms(torch, kernel_fn, 50)
    plain = cuda_ms(torch, lambda: ref.scatter_add_ref_(work, rows_at,
                                                        partial), 20)
    lib = cuda_ms(torch, library_fn, 50)
    b_ms, b_by = bound(n_cells * 4 + n_cells * 2 * 8 + 2 * n_cells * 2 * 8,
                       n_cells * 2)
    turns = in_turns(lambda f: cuda_ms(torch, f, 50),
                     {"kernel": kernel_fn, "library": library_fn}, 7)
    device = device_ms_by_kernel(torch, kernel_fn, 50)
    lib_device = device_ms_by_kernel(torch, library_fn, 50)
    # a hot cell: half of 1,048,576 rows into one table row, the rest into
    # random rows (repeats), bit-exact, timed beside index_add_
    sk_at = torch.where(
        torch.rand(n_skew, generator=gen, device=dev) < 0.5,
        torch.randint(0, total, (n_skew,), generator=gen, device=dev),
        70_001).to(torch.int32)
    sk_rows = torch.randint(0, 400, (n_skew, 2), generator=gen, device=dev)
    check(torch.equal(sr.scatter_add_(table.clone(), sk_at, sk_rows),
                      ref.scatter_add_ref(table, sk_at, sk_rows)),
          "scatter_add skewed input")
    sk_l = sk_at.to(torch.int64)

    def skew_kernel():
        return sr.scatter_add_(work, sk_at, sk_rows)

    def skew_library():
        return work.index_add_(0, sk_l, sk_rows)

    # ids and rows read once, each table row they touch read and written
    sk_bound, _ = bound(n_skew * 20 + 2 * 16 * len(torch.unique(sk_at)),
                        n_skew * 2)
    sk_turns = in_turns(lambda f: cuda_ms(torch, f, 20),
                        {"kernel": skew_kernel, "library": skew_library}, 3)
    records["scatter_add"] = dict(
        max_abs_err=f_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        ms_median_of_7_in_turns=turns["kernel"],
        library_ms_median_of_7_in_turns=turns["library"],
        device_ms=device, device_ms_sum=sum(device.values()),
        library_device_ms=lib_device,
        library_device_ms_sum=sum(lib_device.values()),
        skewed=dict(ms_median_of_3_in_turns=sk_turns["kernel"],
                    library_ms_median_of_3_in_turns=sk_turns["library"],
                    device_ms=device_ms_by_kernel(torch, skew_kernel, 20),
                    library_device_ms=device_ms_by_kernel(
                        torch, skew_library, 20),
                    bound_ms=sk_bound,
                    shape=f"{n_skew} rows i64, half into one of {total}"),
        ptxas={k: v for k, v in ptxas.items() if "scatter_rows" in k}
        if isinstance(ptxas, dict) else ptxas,
        shape=f"table [{total},2] i64, {n_cells} rows")

    # -- the lookups: a steady-state table of ~23% load ------------------------
    c_keys, c_starts = cells[:, 0].contiguous(), cells[:, 1].contiguous()
    slot_table = t((np.arange(NUM_SLOTS) * DEGREE) // NUM_SLOTS)
    c_own = slot_table[hash_to_slot(c_keys, NUM_SLOTS)].to(torch.int32)
    occ = t(rng.random(total) < 0.23)
    tk = t(rng.integers(-2 ** 63, 2 ** 63 - 1, total, dtype=np.int64))
    tst = c_starts[t(rng.integers(0, n_cells, total))].clone()
    # ~12% of the cells are open already (hits), each placed at a random
    # probe of its own window in its owner's segment, as the table's claim
    # places rows (the invariant the lookup relies on)
    hit = rng.random(n_cells) < 0.12
    hit_idx = t(np.flatnonzero(hit))
    hit_rows = c_own[hit_idx].to(torch.int64) * CAPACITY + torch.remainder(
        cell_hash(c_keys[hit_idx], c_starts[hit_idx], CAPACITY)
        + t(rng.integers(0, MAX_PROBES, len(hit_idx))), CAPACITY)
    tk[hit_rows] = c_keys[hit_idx]
    tst[hit_rows] = c_starts[hit_idx]
    occ[hit_rows] = True

    def lookup_pairs(out, n_tab):
        # cell-row pairs the full-scan kernel this one replaced compared: a
        # hit scans up to its row, a miss the whole table
        o = out.to(torch.int64)
        return int(torch.where(o < n_tab, o + 1, n_tab).sum())

    def lookup_bound(n_cells, cell_bytes, n_tab, row_bytes, planes, pairs):
        # the probe window's bound: each cell read once and its row written,
        # and its window's max_probes rows read, capped at the whole table;
        # `planes` 32-bit compares per probe.  The full scan's bound (the
        # whole table read once) and its compares, `planes` per cell-row
        # pair, are reported apart
        window = min(n_cells * MAX_PROBES * row_bytes, n_tab * row_bytes)
        b_ms, b_by = bound(n_cells * (cell_bytes + 4) + window,
                           n_cells * MAX_PROBES * planes)
        return dict(bound_ms=b_ms, bound_by=b_by,
                    full_scan_bound_ms=bound(
                        n_cells * (cell_bytes + 4) + n_tab * row_bytes,
                        (n_cells + n_tab) * planes)[0],
                    scan_pairs=pairs, scan_ops_ms=bound(0, pairs * planes)[0])

    lk = (c_own, c_keys, c_starts, tk, tst, occ, CAPACITY, MAX_PROBES)
    got = ht.batched_table_lookup(*lk)
    want = ref.batched_table_lookup_ref(*lk)
    check(torch.equal(got, want), "batched_table_lookup main shape")
    _lookup_edges(torch, t, rng, ht, ref)
    pairs = lookup_pairs(got, total)
    ms = cuda_ms(torch, lambda: ht.batched_table_lookup(*lk), 50)
    plain = cuda_ms(torch, lambda: ref.batched_table_lookup_ref(*lk), 20)
    records["batched_table_lookup"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain,
        **lookup_bound(n_cells, 20, total, 17, 5, pairs),
        library_ms=None, hits=int((got < total).sum()),
        device_ms=device_ms_by_kernel(
            torch, lambda: ht.batched_table_lookup(*lk), 50),
        shape=f"{n_cells} cells x {total} rows, {MAX_PROBES} probes")

    # per-shard lookup: shard 0's cells against its own segment
    s0 = torch.nonzero(c_own == 0).flatten()
    seg = slice(0, CAPACITY)
    l1 = (c_keys[s0].contiguous(), c_starts[s0].contiguous(), tk[seg],
          tst[seg], occ[seg], MAX_PROBES)
    got = ht.table_lookup(*l1)
    want = ref.table_lookup_ref(*l1)
    check(torch.equal(got, want), "table_lookup main shape")
    pairs = lookup_pairs(got, CAPACITY)
    ms = cuda_ms(torch, lambda: ht.table_lookup(*l1), 50)
    plain = cuda_ms(torch, lambda: ref.table_lookup_ref(*l1), 20)
    records["table_lookup"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain,
        **lookup_bound(len(s0), 16, CAPACITY, 17, 5, pairs),
        library_ms=None, hits=int((got < CAPACITY).sum()),
        device_ms=device_ms_by_kernel(torch, lambda: ht.table_lookup(*l1),
                                      50),
        shape=f"{len(s0)} cells x {CAPACITY} rows, {MAX_PROBES} probes")
    for name, rec in records.items():
        say("kernels", kernel=name, **rec)
    return records


def _lookup_edges(torch, t, rng, ht, ref):
    """Misses, negative and extreme int64 keys, 33 probes (three passes of
    the kernel's 16 lanes), windows that wrap a segment's end, an empty
    input and an empty table, owners outside the segments (misses), and a
    table that breaks the invariant (duplicate cells anywhere, unoccupied
    copies): the kernel and its plain version compute the same
    probe-window function there."""
    dev = torch.device("cuda")
    i64 = np.iinfo(np.int64)
    n_tab, n_w, probes = 3000, 4, 33
    cap = n_tab // n_w
    tk = t(rng.choice(np.array([i64.min, i64.max, -1, 0, 1, -(2 ** 40)],
                               np.int64), n_tab))
    tst = t(rng.integers(-3, 3, n_tab))
    occ = t(rng.random(n_tab) < 0.7)
    ck = t(rng.choice(np.array([i64.min, i64.max, -1, 0, 1, 7], np.int64),
                      700))
    cs = t(rng.integers(-4, 4, 700))
    c_own = t(rng.integers(0, n_w, 700).astype(np.int32))
    c_own[:2] = t(np.array([-1, n_w], np.int32))
    one = (ck, cs, tk, tst, occ, probes)
    got = ht.table_lookup(*one)
    check(torch.equal(got, ref.table_lookup_ref(*one)),
          "table_lookup edge cases")
    check(bool((got == n_tab).any()) and bool((got < n_tab).any()),
          "table_lookup edge cases need hits and misses")
    lk = (c_own, ck, cs, tk, tst, occ, cap, probes)
    got = ht.batched_table_lookup(*lk)
    check(torch.equal(got, ref.batched_table_lookup_ref(*lk)),
          "batched_table_lookup edge cases")
    check(bool((got == n_tab).any()) and bool((got < n_tab).any())
          and bool((got[:2] == n_tab).all()),
          "batched_table_lookup edge cases need hits and misses")
    z64 = torch.zeros(0, dtype=torch.int64, device=dev)
    z32 = torch.zeros(0, dtype=torch.int32, device=dev)
    zb = torch.zeros(0, dtype=torch.bool, device=dev)
    check(len(ht.table_lookup(z64, z64, tk, tst, occ, probes)) == 0,
          "table_lookup empty")
    check(len(ht.batched_table_lookup(z32, z64, z64, tk, tst, occ, cap,
                                      probes)) == 0,
          "batched_table_lookup empty")
    check(not ht.batched_table_lookup(c_own, ck, cs, z64, z64, zb, cap,
                                      probes).any(),
          "batched_table_lookup on an empty table: all misses")


def host_us(torch, fn, n):
    """Host microseconds per call of ``fn`` over ``n`` back-to-back calls
    after a warm-up call and a synchronize: the time to check and enqueue,
    with the launches queued, not waited for (``n`` stays below the launch
    queue's depth)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_profile(fn, n, top=10):
    """The ``top`` functions by own time under ``cProfile`` over ``n`` calls
    of ``fn``, in microseconds per call of ``fn`` (the profiler's own cost
    inflates every entry; read them as shares)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"function": f"{os.path.basename(f)}:{line}({name})",
             "calls": nc / n, "own_us": tt / n * 1e6, "cum_us": ct / n * 1e6}
            for (f, line, name), (_, nc, tt, ct, _) in rows]


def phase_host(torch):
    """Each kernel wrapper's host time per call at its main path's shape
    (the lookups' at a small table: their host path does not depend on
    it), beside one PyTorch call's where one computes the same function
    (medians of 5 readings in turns); a
    ``cProfile`` of ``scatter_add_``, and where the shared launch helper
    exists, its steps timed one by one."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_table as ht
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels import ssd_scan as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ints(hi, n, dtype=torch.int32):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=dtype)

    # keyed: phase 3's scatter into 8 x 262,144 rows and segment sum
    total, n_cells, n_rows = DEGREE * CAPACITY, 65044, 65536
    table = torch.zeros((total, 2), dtype=torch.int64, device=dev)
    rows_at = torch.randperm(total, generator=gen, device=dev)[:n_cells] \
        .to(torch.int32)
    partial = torch.ones((n_cells, 2), dtype=torch.int64, device=dev)
    rows_l = rows_at.long()
    seg_ids = torch.sort(ints(n_cells, n_rows)).values
    seg_vals = ints(100, 2 * n_rows).reshape(n_rows, 2)
    seg_l = seg_ids.long()
    n_tab = 8 * 4096
    keys, starts = (ints(1 << 20, n_tab, torch.int64) for _ in range(2))
    occ = torch.rand(n_tab, generator=gen, device=dev) < 0.25
    c_keys, c_starts = keys[:4096].clone(), starts[:4096].clone()
    c_own = ints(8, 4096)
    # serving: phase 6's and phase 8's shapes
    S, HQ, HKV, HD = SERVE_PROMPT[1], 32, 16, 128
    q, k, v = randn(1, HQ, S, HD), randn(1, HKV, S, HD), randn(1, HKV, S, HD)
    qd = randn(SERVE_SLOTS, HQ, HD)
    ck, cv = (randn(SERVE_SLOTS, HKV, SERVE_SMAX, HD) for _ in range(2))
    valid = ints(SERVE_SMAX, SERVE_SLOTS) + 1
    s_m, H, P, N = MAMBA_PROMPT[1], 48, 64, 128
    x = randn(1, s_m, H, P).transpose(1, 2)
    dt = torch.rand((1, H, s_m), generator=gen, device=dev)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = (randn(1, s_m, N)[:, None].expand(1, H, s_m, N)
              for _ in range(2))
    xt = randn(SERVE_SLOTS, 2048)
    tok = torch.where(torch.rand(2048, generator=gen, device=dev) < 48 / 2048,
                      ints(SERVE_SLOTS, 2048), SERVE_SLOTS).to(torch.int32)

    calls = {
        "segment_sum": (lambda: sr.segment_sum_sorted(seg_vals, seg_ids,
                                                      n_cells),
                        lambda: torch.zeros((n_cells, 2), dtype=torch.int32,
                                            device=dev).index_add_(
                            0, seg_l, seg_vals), 500),
        "segment_sum (order-blind)": (
            lambda: sr.segment_sum(seg_vals, seg_ids, n_cells), None, 500),
        "scatter_add": (lambda: sr.scatter_add_(table, rows_at, partial),
                        lambda: table.index_add_(0, rows_l, partial), 500),
        "table_lookup": (lambda: ht.table_lookup(
            c_keys, c_starts, keys, starts, occ, MAX_PROBES), None, 20),
        "batched_table_lookup": (lambda: ht.batched_table_lookup(
            c_own, c_keys, c_starts, keys, starts, occ, 4096, MAX_PROBES),
            None, 20),
        "flash_attention": (lambda: fa.flash_attention(
            q, k, v, causal=True, window=4096, softcap=50.0), None, 20),
        "decode_attention": (lambda: da.decode_attention(
            qd, ck, cv, valid, window=4097, softcap=50.0), None, 200),
        "ssd_scan": (lambda: ss.ssd_scan(x, dt, A, Bm, Cm), None, 20),
        "moe_gather": (lambda: md.moe_gather(xt, tok), None, 500),
    }
    out = {}
    for name, (fn, lib, n) in calls.items():
        fns = {"host_us": fn} if lib is None else \
            {"host_us": fn, "library_host_us": lib}
        out[name] = in_turns(lambda f: host_us(torch, f, n), fns, 5)
    profile = host_profile(lambda: sr.scatter_add_(table, rows_at, partial),
                           1000)
    steps = None
    from repro_torch.kernels import _build
    if hasattr(_build, "launch"):   # the shared launch helper's steps
        idx = rows_at.get_device()
        fn = _build.library().keyed_scatter_add_i64
        stream = _build.current_stream(idx)
        ptrs = (rows_at.data_ptr(), partial.data_ptr(), table.data_ptr())
        steps = {
            "check_cuda": host_us(torch, lambda: _build.check_cuda(
                ("table", "ids", "rows"), table, rows_at, partial), 2000),
            "shape checks": host_us(
                torch, lambda: sr._scatter_shapes(partial, rows_at, total,
                                                  "scatter_add"), 2000),
            "current device and raw stream": host_us(
                torch, lambda: (torch._C._cuda_getDevice(),
                                _build.current_stream(idx)), 2000),
            "three data_ptr": host_us(torch, lambda: (
                rows_at.data_ptr(), partial.data_ptr(), table.data_ptr()),
                2000),
            "entry point (ctypes, cudaLaunchKernel)": host_us(
                torch, lambda: fn(*ptrs, n_cells, 2, total, stream), 500),
        }
    say("kernels", host_us_per_call=out, scatter_add_cprofile=profile,
        scatter_add_launch_steps_us=steps)
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main(torch, items):
    from repro_torch.keyed import (
        FUSED_STAGES,
        KeyedWindowAdapter,
        WindowSpec,
        dedup_cells,
        expand_panes,
    )
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.runtime import StreamExecutor

    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]

    def adapter(fused=True):
        return KeyedWindowAdapter(
            spec, num_slots=NUM_SLOTS, impl="segment",
            backend="device_table", capacity=CAPACITY,
            max_probes=MAX_PROBES, fused=fused,
        )

    def drive(ad, n_chunks, tracer=None):
        ex = StreamExecutor(ad, degree=DEGREE, chunk_size=CHUNK,
                            tracer=tracer)
        t0 = time.perf_counter()
        outs = ex.run(chunks[:LOOP_CHUNKS])
        snap8 = ex.snapshot_barrier()
        if n_chunks > LOOP_CHUNKS:
            sched = {i - LOOP_CHUNKS: d for i, d in SCHEDULE.items()}
            outs += ex.run(chunks[LOOP_CHUNKS:n_chunks], schedule=sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ex, outs, snap8, ex.snapshot_barrier(), wall

    # -- the fused main path on the kernels, tracing off -----------------------
    ops.use_kernels("auto")
    ad = adapter()
    ops.reset_launch_counts()
    ex, outs, snap8, final, wall = drive(ad, N_CHUNKS)
    fused_counts = ops.launch_counts()
    say("main", run="fused kernels", launches=fused_counts)
    for k in ("segment_sum", "batched_table_lookup", "scatter_add"):
        check(fused_counts[k] > 0, f"fused main path launched no {k}")
    active_b, alloc_b = ad._batched.plane_bytes()
    registry = MetricsRegistry()
    ad.export_health(registry)
    gauges = registry.snapshot()["gauges"]
    svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
    say("main", items=len(items), chunks=N_CHUNKS, wall_s=wall,
        items_per_s=len(items) / wall, chunk_ms_median=float(np.median(svc)),
        chunk_ms_max=float(svc.max()), chunk_samples=len(svc),
        plane_bytes_active=active_b, plane_bytes_allocated=alloc_b,
        resident_rows=gauges["keyed.plane.resident_rows"],
        spill_rows=gauges["keyed.plane.spill_rows"],
        resizes=ex.metrics.migration_volume())

    # -- the table's lookup on its live planes: the CUDA probe-window kernel
    # against its plain version, which ops mode ``ref`` runs ----------------
    dev = torch.device("cuda")
    last = chunks[-1]
    a_key, _, _, _, a_start = expand_panes(
        spec, torch.as_tensor(last["key"].copy(), device=dev),
        torch.as_tensor(last["value"].copy(), device=dev),
        torch.as_tensor(last["ts"].copy(), device=dev),
        torch.arange(len(last), device=dev),
    )
    cells, _ = dedup_cells(a_key, a_start)
    c_keys, c_starts = cells[:, 0], cells[:, 1]
    c_own = ad._cell_owners(c_keys)
    table = ad._batched
    k_rows = table.lookup(c_own, c_keys, c_starts)
    k_ms = cuda_ms(torch, lambda: table.lookup(c_own, c_keys, c_starts), 20)
    ops.use_kernels("ref")
    try:
        p_rows = table.lookup(c_own, c_keys, c_starts)
        p_ms = cuda_ms(torch, lambda: table.lookup(c_own, c_keys, c_starts),
                       20)
    finally:
        ops.use_kernels("auto")
    check(torch.equal(k_rows, p_rows),
          "live-table lookup: kernel and plain version differ")
    say("main", lookup="live table", cells=len(c_keys),
        rows=table.total_rows, hits=int((k_rows >= 0).sum()),
        kernel_ms=k_ms, plain_ms=p_ms)

    # -- a traced run: per-stage shares (each span synchronizes the card) -----
    tracer = Tracer(recorder=None)
    t_ex, traced_outs, _, _, traced_wall = drive(adapter(), N_CHUNKS, tracer)
    check(outputs_equal(traced_outs, outs), "traced run differs")
    totals = tracer.total_by_name()
    chunk_s = totals["chunk"][1]
    shares = {s: totals.get(s, (0, 0.0))[1] / chunk_s for s in FUSED_STAGES}
    t_svc = np.array([c.service_time for c in t_ex.metrics.chunks]) * 1e3
    say("main", run="traced", wall_s=traced_wall,
        chunk_ms_median=float(np.median(t_svc)),
        tracing_overhead=float(np.median(t_svc) / np.median(svc)),
        stage_share=shares, stage_coverage=sum(shares.values()),
        stage_ms_per_chunk={s: totals.get(s, (0, 0.0))[1] / N_CHUNKS * 1e3
                            for s in FUSED_STAGES})

    # -- the per-shard loop over the first chunks: table_lookup ---------------
    ops.reset_launch_counts()
    _, loop_outs, loop_snap8, _, loop_wall = drive(adapter(fused=False),
                                                   LOOP_CHUNKS)
    loop_counts = ops.launch_counts()
    say("main", run="loop kernels", chunks=LOOP_CHUNKS, wall_s=loop_wall,
        launches=loop_counts)
    for k in ("segment_sum", "table_lookup", "scatter_add"):
        check(loop_counts[k] > 0, f"loop main path launched no {k}")
    check(outputs_equal(loop_outs, outs[:LOOP_CHUNKS]),
          "fused=False outputs differ from the fused run")
    check(states_equal(loop_snap8, snap8),
          "fused=False barrier snapshot differs from the fused run")

    # -- (b) the same stream on the plain versions, on the card ---------------
    ops.use_kernels("ref")
    try:
        ref_ex, ref_outs, ref_snap8, ref_final, ref_wall = drive(adapter(),
                                                                 N_CHUNKS)
    finally:
        ops.use_kernels("auto")
    check(outputs_equal(ref_outs, outs), "kernel run differs from ref mode")
    check(states_equal(ref_snap8, snap8) and states_equal(ref_final, final),
          "kernel barrier snapshot differs from ref mode")
    ref_svc = np.array([c.service_time for c in ref_ex.metrics.chunks]) * 1e3
    say("main", run="ref mode", wall_s=ref_wall,
        chunk_ms_median=float(np.median(ref_svc)),
        kernel_over_ref_wall=wall / ref_wall, bit_identical=True)

    # -- (c) late count 0; emissions + open rows == numpy group-by ------------
    check(int(final["late_count"]) == 0, "main stream produced late items")
    check(all(len(o["late"]["key"]) == 0 for o in outs), "late records")
    em = {k: np.concatenate([o["emissions"][k] for o in outs])
          for k in ("key", "start", "value", "count")}
    got = sorted_rows(
        np.concatenate([em["key"], final["w_key"]]),
        np.concatenate([em["start"], final["w_start"]]),
        np.concatenate([em["value"], final["w_value"]]),
        np.concatenate([em["count"], final["w_count"]]),
    )
    want = sorted_rows(*group_by(*pane_assignments(items)))
    check(got.shape == want.shape and np.array_equal(got, want),
          "emissions + open rows differ from the numpy group-by")
    say("main", groupby_cells=int(want.shape[1]),
        emitted_cells=int(len(em["key"])), open_cells=int(len(final["w_key"])),
        bit_identical=True)
    return {"fused": fused_counts, "loop": loop_counts, "outs": outs,
            "snap8": snap8, "final": final,
            "volume": ex.metrics.migration_volume(), "wall_s": wall,
            "items_per_s": len(items) / wall, "first_chunk_ms": float(svc[0]),
            "chunk_ms_median": float(np.median(svc))}


# ---------------------------------------------------------------------------
# phase 5: spill, TTL and early firing at a small size
# ---------------------------------------------------------------------------

def phase_small(torch):
    from repro_torch.keyed import (
        KeyedWindowAdapter,
        WindowSpec,
        synthetic_keyed_items,
    )
    from repro_torch.kernels import ops
    from repro_torch.runtime import StreamExecutor

    # (a) the reference benchmark's oracle configuration (its windows close
    # within a chunk, so it forces spill but no eviction and no late item);
    # (b) short chunks and a small lateness that force all three
    configs = {
        "oracle": dict(
            ch=256, nch=12, schedule={4: 3, 8: 7}, capacity=64, ttl=6,
            spec=WindowSpec("sliding", size=96, slide=32, lateness=16,
                            late_policy="side", early_every=2),
            items=dict(num_keys=64, disorder=8, seed=0),
            need=("t_spilled",),
        ),
        "evict": dict(
            ch=16, nch=24, schedule={8: 3, 16: 7}, capacity=16, ttl=4,
            spec=WindowSpec("sliding", size=48, slide=16, lateness=3,
                            late_policy="side", early_every=2),
            items=dict(num_keys=40, disorder=10, seed=0),
            need=("t_spilled", "t_evicted", "late_count"),
        ),
    }
    for label, cfg in configs.items():
        ch = cfg["ch"]
        items = synthetic_keyed_items(ch * cfg["nch"], **cfg["items"])
        chunks = [items[i: i + ch] for i in range(0, len(items), ch)]

        def run(device, fused=True, mode="auto"):
            ops.use_kernels(mode)
            try:
                ad = KeyedWindowAdapter(
                    cfg["spec"], num_slots=20, impl="segment",
                    backend="device_table", capacity=cfg["capacity"],
                    max_probes=4, ttl=cfg["ttl"], fused=fused, device=device,
                )
                ex = StreamExecutor(ad, degree=2, chunk_size=ch)
                outs = ex.run(chunks, schedule=cfg["schedule"])
                return outs, ex.state
            finally:
                ops.use_kernels("auto")

        ops.reset_launch_counts()
        kern = run("cuda")
        counts = ops.launch_counts()
        for k in cfg["need"]:
            check(int(kern[1][k]) > 0, f"small phase {label}: {k} is 0")
        check(any(len(o["early"]["key"]) for o in kern[0]),
              f"small phase {label}: no early firing")
        plain = run("cuda", mode="ref")
        loop = run("cuda", fused=False)
        cpu = run("cpu")
        for name, other in (("plain", plain), ("loop", loop), ("cpu", cpu)):
            check(outputs_equal(kern[0], other[0]),
                  f"small phase {label}: kernels vs {name} outputs differ")
            check(states_equal(kern[1], other[1]),
                  f"small phase {label}: kernels vs {name} snapshot differs")
        say("small", config=label, launches=counts,
            spilled=int(kern[1]["t_spilled"]),
            evicted=int(kern[1]["t_evicted"]),
            late=int(kern[1]["late_count"]),
            bit_identical=["plain", "loop", "cpu"])


# ---------------------------------------------------------------------------
# phase 6: the attention kernels vs their plain versions
# ---------------------------------------------------------------------------

def admitted_pairs(sq, skv, causal, window, prefix=0):
    """(q, k) pairs the flash mask admits for one (batch, head): with
    ``causal`` the keys ``k <= q`` and, with a prefix, every ``k <
    prefix``."""
    q = np.arange(sq, dtype=np.int64)
    hi = (np.minimum(np.maximum(q + 1, prefix), skv) if causal
          else np.full(sq, skv))
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def decode_rows(valid, window, s):
    """Cache rows the decode kernel reads for one kv head, summed over the
    slots, by the kernel's own rule: positions ``[first, hi)`` with
    ``hi = min(valid, S)`` and ``first = max(0, valid - window + 1)`` for
    a window, else 0."""
    valid = np.asarray(valid, np.int64)
    hi = np.minimum(valid, s)
    first = np.maximum(valid - window + 1, 0) if window else 0
    return int(np.maximum(hi - first, 0).sum())


def decode_blocks(da, valid, window, s, splits, tile):
    """Blocks of the split-KV decode kernel that hold admitted rows, per kv
    head, summed over the slots: each slot's runs of ``da.split_length``."""
    n = 0
    for v in valid:
        rows = min(int(v), s) - (max(int(v) - window + 1, 0) if window else 0)
        if rows > 0:
            n += -(-rows // da.split_length(rows, splits, tile))
    return n


def attention_bound(pairs, heads, hd, nbytes):
    """4 * hd flops per admitted (query, key) pair and head at the bf16
    tensor-core rate, or the bytes read and written once, whichever is
    larger."""
    t_ops = pairs * heads * 4 * hd / PEAK_BF16_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def ptxas_entries(report):
    """Each kernel's registers, spills and static shared memory from an
    ``nvcc -Xptxas -v`` report, by mangled name."""
    entries, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            entries[name] = {}
        elif name and "spill stores" in ln:
            f = ln.replace(",", "").split()
            entries[name].update(stack_bytes=int(f[0]),
                                 spill_store_bytes=int(f[4]),
                                 spill_load_bytes=int(f[8]))
        elif name and "Used" in ln and "registers" in ln:
            f = ln.replace(",", "").split()
            entries[name]["registers"] = int(f[f.index("Used") + 1])
            entries[name]["static_smem_bytes"] = (
                int(f[f.index("smem") - 2]) if "smem" in f else 0)
    return entries


def sass_opcode_counts(library, opcode):
    """Instructions whose text holds ``opcode`` in each function of a built
    library, from ``cuobjdump -sass``; None where the toolkit has no
    ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            counts[name] = 0
        elif name and opcode in ln:
            counts[name] += 1
    return counts


def wgmma_build_report(source, kernels):
    """The kernels of one source as built: ptxas's registers, spills and
    static shared memory, and the HGMMA (wgmma) instructions in each
    kernel's machine code; both instances (hd 64 and 128) of each of
    ``kernels`` must have some where ``cuobjdump`` can tell."""
    from repro_torch.kernels import _build

    text = _build.BUILD_INFO["ptxas"].get(source)
    report = {"ptxas": (ptxas_entries(text) if text
                        else "not compiled in this run")}
    hgmma = sass_opcode_counts(_build.BUILD_INFO["libraries"][source],
                               "HGMMA")
    report["hgmma_instructions"] = (hgmma if hgmma is not None
                                    else "no cuobjdump in the toolkit")
    if hgmma is not None:
        for kernel in kernels:
            wg = {k: n for k, n in hgmma.items() if kernel in k}
            check(len(wg) == 2 and min(wg.values()) > 0,
                  f"{kernel} without HGMMA instructions: {hgmma}")
    return report


def build_report(source):
    """ptxas's registers, spills and static shared memory of every kernel
    instance of one source (for decode: dtype, head dim, q heads per kv
    head; for the scan: each pass and dtype)."""
    from repro_torch.kernels import _build

    text = _build.BUILD_INFO["ptxas"].get(source)
    return ptxas_entries(text) if text else "not compiled in this run"


def _close(torch, got, want, tol, what, steps):
    """Largest absolute difference, held to ``tol`` (absolute and relative);
    a bfloat16 output is also held to one rounding step of each value
    (``BF16_STEP``), and its largest share of that step goes to
    ``steps[what]``."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=tol, rtol=tol),
          f"{what}: max abs error {err} exceeds {tol}")
    if bf16:
        steps[what] = float(((got - want).abs()
                             / (F32_TOL + BF16_STEP * want.abs())).max())
        check(steps[what] <= 1.0, f"{what}: a bfloat16 output differs by "
              f"{steps[what]} of a rounding step")
    return err


def phase_attention(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    S, HQ, HKV, HD = SERVE_PROMPT[1], 32, 16, 128

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    records = {}
    steps = {}
    # -- flash: the serve phase's longest prompt through one local and one
    # global layer (window 4,096 and 0) with Gemma2-27B's heads --------------
    errs = {}
    for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
        q = randn(1, HQ, S, HD, dtype=dtype)
        k, v = randn(1, HKV, S, HD, dtype=dtype), randn(1, HKV, S, HD,
                                                         dtype=dtype)
        for window in (4096, 0):
            kw = dict(causal=True, window=window, softcap=50.0)
            errs[f"{dtype} window {window}"] = _close(
                torch, fa.flash_attention(q, k, v, **kw),
                ref.flash_attention_ref(q, k, v, **kw), tol,
                f"flash_attention {dtype} window {window}", steps)
        del q, k, v
    # edge cases: a ragged last tile with head_dim 64, and a non-causal
    # short query against a longer key range with 4 q heads per kv head
    for b, hq, hkv, sq, skv, hd, window, causal in (
            (2, 8, 2, 1000, 1000, 64, 300, True),
            (1, 4, 1, 77, 513, 128, 0, False)):
        for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
            q = randn(b, hq, sq, hd, dtype=dtype)
            k, v = randn(b, hkv, skv, hd, dtype=dtype), randn(
                b, hkv, skv, hd, dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=30.0)
            errs[f"{dtype} {sq}x{skv}"] = _close(
                torch, fa.flash_attention(q, k, v, **kw),
                ref.flash_attention_ref(q, k, v, **kw), tol,
                f"flash_attention edge {dtype} {sq}x{skv}", steps)
    # DeepSeekMoE-16B's prefill in the moe-serve phase: 16 q heads over 16
    # kv heads (one per group), causal, no window, no softcap
    for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
        q, k, v = (randn(1, MOE_HEADS, S, HD, dtype=dtype) for _ in range(3))
        kw = dict(causal=True, window=0, softcap=0.0)
        errs[f"moe-serve {dtype}"] = _close(
            torch, fa.flash_attention(q, k, v, **kw),
            ref.flash_attention_ref(q, k, v, **kw), tol,
            f"flash_attention moe-serve {dtype}", steps)
        del q, k, v
    q, k, v = randn(1, HQ, S, HD), randn(1, HKV, S, HD), randn(1, HKV, S, HD)
    times = {}
    for window in (4096, 0):
        for cap in (50.0, 0.0):
            kw = dict(causal=True, window=window, softcap=cap)
            times[("kernel", window, cap)] = cuda_ms(
                torch, lambda: fa.flash_attention(q, k, v, **kw), 5)
        kw = dict(causal=True, window=window, softcap=50.0)
        times[("plain", window)] = cuda_ms(
            torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 2)
        # the library yardstick: SDPA at softcap 0 on the same mask, the kv
        # heads expanded beforehand (not timed); the port never calls it
        kx = k.repeat_interleave(HQ // HKV, dim=1)
        vx = v.repeat_interleave(HQ // HKV, dim=1)
        if window:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)
            times[("library", window)] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, attn_mask=mask), 5)
        else:
            times[("library", window)] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, is_causal=True), 5)
        del kx, vx
    pairs = {w: admitted_pairs(S, S, True, w) for w in (4096, 0)}
    nbytes = 2 * (2 * HQ * S * HD + 2 * HKV * S * HD)  # q, o, k, v in bf16
    bounds = {w: attention_bound(pairs[w], HQ, HD, nbytes) for w in pairs}
    flops = sum(pairs.values()) * HQ * 4 * HD   # the function's, both layers
    pair_ms = {cap: times[("kernel", 4096, cap)] + times[("kernel", 0, cap)]
               for cap in (50.0, 0.0)}
    bound_ms = bounds[4096][0] + bounds[0][0]
    records["flash_attention"] = dict(
        max_abs_err=max(errs.values()),
        ms=pair_ms[50.0],
        plain_ms=times[("plain", 4096)] + times[("plain", 0)],
        bound_ms=bound_ms, bound_by=bounds[0][1],
        library_ms=times[("library", 4096)] + times[("library", 0)],
        ms_softcap0=pair_ms[0.0],
        tflops={f"softcap {c:g}": flops / (t * 1e-3) / 1e12
                for c, t in pair_ms.items()},
        bound_share={f"softcap {c:g}": bound_ms / t
                     for c, t in pair_ms.items()},
        first_version_ms=FLASH_FIRST_VERSION_MS,
        speedup_over_first_version=FLASH_FIRST_VERSION_MS / pair_ms[50.0],
        build=wgmma_build_report("flash_attention.cu",
                                 ("flash_forward_wgmma",)),
        per_layer={f"window {w}": dict(
            kernel_ms=times[("kernel", w, 50.0)],
            kernel_softcap0_ms=times[("kernel", w, 0.0)],
            plain_ms=times[("plain", w)], sdpa_ms=times[("library", w)],
            bound_ms=bounds[w][0], admitted_pairs=pairs[w] * HQ)
            for w in (4096, 0)},
        errors=errs, bf16_rounding_steps=steps,
        shape=f"q [1,{HQ},{S},{HD}] bf16, k/v {HKV} heads; one local "
              f"(window 4096) + one global layer, softcap 50")
    del q, k, v

    # -- decode: 8 slots of an 8,192-row cache at ragged lengths --------------
    rng = np.random.default_rng(6)
    valid_np = np.sort(rng.integers(1, SERVE_SMAX + 1, SERVE_SLOTS))
    valid_np[0] = 1                     # a slot at its first position
    valid = torch.as_tensor(valid_np.astype(np.int32), device=dev)
    errs, steps = {}, {}
    for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        qd = randn(SERVE_SLOTS, HQ, HD, dtype=dtype)
        ck = randn(SERVE_SLOTS, HKV, SERVE_SMAX, HD, dtype=dtype)
        cv = randn(SERVE_SLOTS, HKV, SERVE_SMAX, HD, dtype=dtype)
        for window in (4097, 0):         # a local layer passes window + 1
            kw = dict(softcap=50.0, window=window)
            errs[f"{dtype} window {window}"] = _close(
                torch, da.decode_attention(qd, ck, cv, valid, **kw),
                ref.decode_attention_ref(qd, ck, cv, valid, **kw), tol,
                f"decode_attention {dtype} window {window}", steps)
    # DeepSeekMoE-16B's decode: 16 heads over 16, no window, no softcap
    for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        qm = randn(SERVE_SLOTS, MOE_HEADS, HD, dtype=dtype)
        km, vm = (randn(SERVE_SLOTS, MOE_HEADS, SERVE_SMAX, HD, dtype=dtype)
                  for _ in range(2))
        kw = dict(softcap=0.0, window=0)
        errs[f"moe-serve {dtype}"] = _close(
            torch, da.decode_attention(qm, km, vm, valid, **kw),
            ref.decode_attention_ref(qm, km, vm, valid, **kw), tol,
            f"decode_attention moe-serve {dtype}", steps)
        del qm, km, vm
    times = {}
    pos = torch.arange(SERVE_SMAX, device=dev)
    for window in (4097, 0):             # qd, ck, cv are the bf16 ones
        kw = dict(softcap=50.0, window=window)
        times[("kernel", window)] = cuda_ms(
            torch, lambda: da.decode_attention(qd, ck, cv, valid, **kw), 20)
        times[("kernel softcap 0", window)] = cuda_ms(
            torch, lambda: da.decode_attention(qd, ck, cv, valid, softcap=0.0,
                                               window=window), 20)
        times[("plain", window)] = cuda_ms(
            torch, lambda: ref.decode_attention_ref(qd, ck, cv, valid, **kw),
            3)
        # the library yardstick: SDPA at softcap 0 over the same ragged
        # slots, a per-slot boolean mask [B, 1, 1, S] built beforehand (not
        # timed), the kv heads grouped by SDPA itself; the port never calls
        # it
        mask = pos[None, :] < valid[:, None]
        if window:
            mask &= pos[None, :] > valid[:, None] - window
        mask = mask[:, None, None, :]
        q4 = qd[:, :, None, :]
        times[("library", window)] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, ck, cv, attn_mask=mask, enable_gqa=True), 20)
    # the serve phases' profiled decode step: 6 slots of about 260 rows,
    # where back-to-back events time the host; the kernel's own device time
    short = torch.arange(257, 263, dtype=torch.int32, device=dev)
    short_ms = {f"window {w}": sum(device_ms_by_kernel(
        torch, lambda: da.decode_attention(qd[:6], ck[:6], cv[:6], short,
                                           softcap=50.0, window=w),
        20).values()) for w in (4097, 0)}
    rows = {w: decode_rows(valid_np, w, SERVE_SMAX) for w in (4097, 0)}
    qo_bytes = 2 * SERVE_SLOTS * HQ * HD * 2
    bounds = {w: attention_bound(rows[w], HQ, HD,
                                 rows[w] * HKV * HD * 2 * 2 + qo_bytes)
              for w in rows}
    pair_ms = times[("kernel", 4097)] + times[("kernel", 0)]
    pair_ms0 = (times[("kernel softcap 0", 4097)]
                + times[("kernel softcap 0", 0)])
    bound_ms = bounds[4097][0] + bounds[0][0]
    splits = da.num_splits(SERVE_SLOTS, HKV, SERVE_SMAX, HD, 2)
    tile = da.tile_rows(HD, 2)
    records["decode_attention"] = dict(
        max_abs_err=max(errs.values()),
        ms=pair_ms,
        plain_ms=times[("plain", 4097)] + times[("plain", 0)],
        bound_ms=bound_ms, bound_by=bounds[0][1],
        library_ms=times[("library", 4097)] + times[("library", 0)],
        ms_softcap0=pair_ms0,
        bound_share={"softcap 50": bound_ms / pair_ms,
                     "softcap 0": bound_ms / pair_ms0},
        first_version_ms=DECODE_FIRST_VERSION_MS,
        speedup_over_first_version=DECODE_FIRST_VERSION_MS / pair_ms,
        splits=splits, tile_rows=tile,
        short_slots=dict(valid_len=short.tolist(), device_ms=short_ms),
        build=build_report("decode_attention.cu"),
        per_layer={f"window {w}": dict(
            kernel_ms=times[("kernel", w)],
            kernel_softcap0_ms=times[("kernel softcap 0", w)],
            plain_ms=times[("plain", w)], sdpa_ms=times[("library", w)],
            bound_ms=bounds[w][0], admitted_rows=rows[w],
            blocks_with_rows=decode_blocks(da, valid_np, w, SERVE_SMAX,
                                           splits, tile) * HKV)
            for w in (4097, 0)},
        valid_len=valid_np.tolist(), errors=errs, bf16_rounding_steps=steps,
        shape=f"q [{SERVE_SLOTS},{HQ},{HD}] bf16, cache "
              f"[{SERVE_SLOTS},{HKV},{SERVE_SMAX},{HD}]; one local + one "
              f"global layer, softcap 50")
    del qd, ck, cv
    torch.cuda.empty_cache()
    wide = phase_attention_wide(torch, randn, valid, valid_np)
    records["flash_attention"]["head_dim_256"] = wide["flash"]
    records["flash_attention"]["families"] = phase_attention_families(
        torch, randn)
    records["decode_attention"]["head_dim_256"] = wide["decode"]
    records["decode_attention"]["group_16"] = wide["group_16"]
    for name, rec in records.items():
        say("attention", kernel=name, **rec)
    return records


def phase_attention_wide(torch, randn, valid, valid_np):
    """The instances this repository's other configurations need: head_dim
    256 (PaliGemma-3B's 8 q heads over 1 kv head) in flash (the CUDA-core
    kernel in both dtypes) and in decode, and decode at 16 q heads per kv
    head; each against its plain version in float32 and bfloat16, with the
    kernel's time beside the plain version's, SDPA's at softcap 0 and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    S, HQ, HKV, HD = PALI_PROMPT, 8, 1, 256
    out = {}
    errs, steps = {}, {}
    kw = dict(causal=True, window=0, softcap=0.0)
    for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
        q = randn(1, HQ, S, HD, dtype=dtype)
        k, v = (randn(1, HKV, S, HD, dtype=dtype) for _ in range(2))
        errs[str(dtype)] = _close(
            torch, fa.flash_attention(q, k, v, **kw),
            ref.flash_attention_ref(q, k, v, **kw), tol,
            f"flash_attention hd 256 {dtype}", steps)
    # q, k, v are the float32 ones; the times are bf16's
    q, k, v = (x.to(bf16) for x in (q, k, v))
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), 5)
    plain = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 2)
    kx, vx = k.repeat_interleave(HQ, dim=1), v.repeat_interleave(HQ, dim=1)
    sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kx, vx, is_causal=True), 5)
    pairs = admitted_pairs(S, S, True, 0)
    b_ms, b_by = attention_bound(pairs, HQ, HD,
                                 2 * (2 * HQ * S * HD + 2 * HKV * S * HD))
    out["flash"] = dict(
        ms=ms, plain_ms=plain, sdpa_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
        tflops=pairs * HQ * 4 * HD / (ms * 1e-3) / 1e12, errors=errs,
        bf16_rounding_steps=steps,
        shape=f"q [1,{HQ},{S},{HD}] bf16, k/v {HKV} head, causal, "
              f"softcap 0")
    del q, k, v, kx, vx

    # decode at head_dim 256 over phase 6's ragged slots, and at a group of
    # 16 (16 q heads over 1 kv head, hd 128)
    for label, hq, hd in (("decode", HQ, HD), ("group_16", 16, 128)):
        errs, steps = {}, {}
        for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
            qd = randn(SERVE_SLOTS, hq, hd, dtype=dtype)
            ck, cv = (randn(SERVE_SLOTS, HKV, SERVE_SMAX, hd, dtype=dtype)
                      for _ in range(2))
            for window, cap in ((0, 0.0), (4097, 50.0)):
                kw = dict(softcap=cap, window=window)
                errs[f"{dtype} window {window}"] = _close(
                    torch, da.decode_attention(qd, ck, cv, valid, **kw),
                    ref.decode_attention_ref(qd, ck, cv, valid, **kw), tol,
                    f"decode_attention {label} {dtype} window {window}",
                    steps)
        kw = dict(softcap=0.0, window=0)   # qd, ck, cv are the bf16 ones
        ms = cuda_ms(torch, lambda: da.decode_attention(qd, ck, cv, valid,
                                                        **kw), 20)
        plain = cuda_ms(torch, lambda: ref.decode_attention_ref(
            qd, ck, cv, valid, **kw), 3)
        pos = torch.arange(SERVE_SMAX, device=dev)
        mask = (pos[None, :] < valid[:, None])[:, None, None, :]
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qd[:, :, None, :], ck, cv, attn_mask=mask, enable_gqa=True), 20)
        rows = decode_rows(valid_np, 0, SERVE_SMAX)
        b_ms, b_by = attention_bound(
            rows, hq, hd,
            rows * HKV * hd * 2 * 2 + 2 * SERVE_SLOTS * hq * hd * 2)
        out[label] = dict(
            ms=ms, plain_ms=plain, sdpa_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
            splits=da.num_splits(SERVE_SLOTS, HKV * da.chunks(hq, HKV),
                                 SERVE_SMAX, hd, 2),
            errors=errs, bf16_rounding_steps=steps,
            shape=f"q [{SERVE_SLOTS},{hq},{hd}] bf16, cache "
                  f"[{SERVE_SLOTS},{HKV},{SERVE_SMAX},{hd}], softcap 0")
        del qd, ck, cv
    torch.cuda.empty_cache()
    return out


#: phase 6's flash cases of phase 15's models: (label, heads, kv heads,
#: queries, keys, head_dim, causal, prefix)
FAMILY_FLASH = (
    # PaliGemma-3B's prefix-LM prefill: 256 image positions of 4,096
    ("paligemma prefix-LM", 8, 1, 4096, 4096, 256, True, 256),
    # the prefix-LM mask on the wgmma route (bf16, hd 128)
    ("prefix-LM wgmma", 8, 2, 1000, 1000, 128, True, 200),
    # SeamlessM4T-medium's encoder over 1,024 frames, bidirectional
    ("seamless encoder", 16, 16, 1024, 1024, 64, False, 0),
    # its decoder's cross attention at prefill: 4,096 queries x 1,024 frames
    ("seamless cross", 16, 16, 4096, 1024, 64, False, 0),
)


def phase_attention_families(torch, randn):
    """Flash at phase 15's new shapes: the prefix-LM mask (PaliGemma's hd
    256 on the float32-FMA kernel, and hd 128 on the wgmma one) and the
    encoder-decoder's bidirectional and cross attention, each against its
    plain version in bfloat16 and float32, with the kernel's time, the plain
    version's, the bound and SDPA's on the same boolean mask (bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for label, hq, hkv, sq, skv, hd, causal, prefix in FAMILY_FLASH:
        kw = dict(causal=causal, prefix_len=prefix)
        errs, steps = {}, {}
        for dtype, tol in ((bf16, BF16_TOL), (f32, F32_TOL)):
            q = randn(1, hq, sq, hd, dtype=dtype)
            k, v = (randn(1, hkv, skv, hd, dtype=dtype) for _ in range(2))
            errs[str(dtype)] = _close(
                torch, fa.flash_attention(q, k, v, **kw),
                ref.flash_attention_ref(q, k, v, **kw), tol,
                f"flash_attention {label} {dtype}", steps)
        q, k, v = (x.to(bf16) for x in (q, k, v))   # the times are bf16's
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), 5)
        plain = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                        2)
        qp = torch.arange(sq, device=dev)[:, None]
        kp = torch.arange(skv, device=dev)[None, :]
        mask = ((kp <= qp) | (kp < prefix)) if causal \
            else torch.ones(sq, skv, dtype=torch.bool, device=dev)
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), 5)
        pairs = admitted_pairs(sq, skv, causal, 0, prefix)
        nbytes = 2 * (2 * hq * sq * hd + 2 * hkv * skv * hd)
        b_ms, b_by = attention_bound(pairs, hq, hd, nbytes)
        out[label] = dict(
            ms=ms, plain_ms=plain, sdpa_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / ms,
            tflops=pairs * hq * 4 * hd / (ms * 1e-3) / 1e12,
            admitted_pairs=pairs * hq, errors=errs,
            bf16_rounding_steps=steps,
            shape=f"q [1,{hq},{sq},{hd}] bf16, k/v [1,{hkv},{skv},{hd}], "
                  f"causal {causal}, prefix_len {prefix}, softcap 0")
        del q, k, v, kx, vx, mask
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the SSD scan and the MoE gather vs their plain versions
# ---------------------------------------------------------------------------

def ssd_work(b, h, s, p, n, chunk):
    """Operations of the chunked formulation at ``chunk`` positions:
    per chunk and head, the masked scores ``C B^T`` and their product with
    ``x dt`` over the causal half (``c (c + 1) / 2`` pairs, ``N + P`` each)
    and the carry-in and state products (``c N P`` each), 2 flops per
    multiply-add."""
    full, tail = divmod(s, chunk)
    pairs = full * chunk * (chunk + 1) // 2 + tail * (tail + 1) // 2
    return 2 * b * h * (pairs * (n + p) + 2 * s * n * p)


def old_state_effect(scan, x, dt, A, Bm, Cm, tol, chunk):
    """How far the contributions older than one whole ``chunk`` move y, in
    units of ``tol`` (absolute and relative): y from position ``S/2 +
    chunk`` on against the second half scanned alone from a zero state.
    Only the state carried across at least one whole chunk (its decay
    ``exp(total)``) separates the two."""
    half = x.shape[2] // 2
    alone, _ = scan(x[:, :, half:], dt[:, :, half:], A, Bm[:, :, half:],
                    Cm[:, :, half:])
    full, _ = scan(x, dt, A, Bm, Cm)
    full = full[:, :, half + chunk:].float()
    return float(((full - alone[:, :, chunk:].float()).abs()
                  / (tol * (1 + full.abs()))).max())


def phase_ssm_moe(torch):
    from repro_torch import configs
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import moe as tmoe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    records = {}

    # -- ssd_scan: Mamba2-780M's shapes (48 heads of 64, state 128, one
    # shared B/C group) in the model's layouts, at the serve phase's longest
    # prompt and on edges: one token, and lengths no chunk divides.  Two
    # regimes of dt: softplus(randn), about 0.7, where the state forgets
    # within a few positions, and softplus(randn - 5), 3e-4 to 0.1 as in a
    # trained Mamba-2, where it carries across many chunks ----------------
    H, P, N = 48, 64, 128

    def scan_inputs(b, s, dtype, dt_shift, per_head=False):
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        x = randn(b, s, H, P, scale=0.5).to(dtype).transpose(1, 2)
        dt = torch.nn.functional.softplus(randn(b, s, H) - dt_shift) \
            .transpose(1, 2)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        if per_head:  # B and C of every head (a nonzero head stride)
            return (x, dt, A, randn(b, H, s, N, scale=0.3).to(dtype),
                    randn(b, H, s, N, scale=0.3).to(dtype))
        Bm = randn(b, s, N, scale=0.3).to(dtype)[:, None].expand(b, H, s, N)
        Cm = randn(b, s, N, scale=0.3).to(dtype)[:, None].expand(b, H, s, N)
        return x, dt, A, Bm, Cm

    errs, carry, steps = {}, {}, {}
    for dtype, tol in ((f32, SSD_F32_TOL), (bf16, SSD_BF16_TOL)):
        for b, s, shift, per_head in (
                (1, MAMBA_PROMPT[1], 0.0, False), (1, 1, 0.0, False),
                (2, 300, 0.0, False), (1, 4097, 0.0, False),
                (1, MAMBA_PROMPT[1], SMALL_DT_SHIFT, False),
                (2, 4097, SMALL_DT_SHIFT, False),
                (1, 4097, SMALL_DT_SHIFT, True)):
            case = f"{dtype} S={s} dt shift {shift}" + \
                (" per-head B/C" if per_head else "")
            args = scan_inputs(b, s, dtype, shift, per_head)
            y, h = ss.ssd_scan(*args)
            want_y, want_h = ref.ssd_scan_ref(*args)
            for what, got, want in (("y", y, want_y), ("h", h, want_h)):
                got, want = got.float(), want.float()
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, atol=tol, rtol=tol),
                      f"ssd_scan {case} B={b} {what}: max abs error {err} "
                      f"exceeds {tol}")
                errs[f"{case} {what}"] = err
            if dtype == bf16:  # both round y once: one step at most, past
                # the float32 tolerance of two orders of summation
                steps[case] = float(((y.float() - want_y.float()).abs()
                                     / (SSD_F32_TOL + BF16_STEP
                                        * want_y.float().abs())).max())
                check(steps[case] <= 1.0, f"ssd_scan {case}: y differs by "
                      f"{steps[case]} of a bfloat16 rounding step")
            if s == MAMBA_PROMPT[1] and dtype == f32:
                # across a whole chunk of either route's kernel
                carry[f"dt shift {shift}"] = old_state_effect(
                    ref.ssd_scan_ref, *args, tol, max(ss.CHUNK.values()))
            del args, y, h, want_y, want_h
    check(carry[f"dt shift {SMALL_DT_SHIFT}"] > 10.0,
          f"ssd_scan: the small-dt case does not depend on the state "
          f"carried across a whole chunk ({carry})")
    b, s = 1, MAMBA_PROMPT[1]
    args = scan_inputs(b, s, bf16, 0.0)
    ms = cuda_ms(torch, lambda: ss.ssd_scan(*args), 20)
    plain = cuda_ms(torch, lambda: ref.ssd_scan_ref(*args), 3)
    by_kernel = device_ms_by_kernel(torch, lambda: ss.ssd_scan(*args), 10)
    # the same layer in float32, its B/C group still shared (head stride 0)
    args32 = [args[0].float(), args[1], args[2]] + [
        g[:, 0].float()[:, None].expand_as(g) for g in args[3:]]
    ms_f32 = cuda_ms(torch, lambda: ss.ssd_scan(*args32), 5)
    del args32
    chunk = ss.CHUNK[bf16]
    nc = -(-s // chunk)
    nbytes = (2 * b * s * H * P * 2 + 2 * b * s * N * 2 + b * s * H * 4
              + H * 4 + b * H * N * P * 4)
    # the function's least work is the recurrence's: per position and head,
    # h <- decay h + B (x dt)^T and y = C h, 2 N P multiply-adds
    ops_n = 4 * b * H * s * N * P
    t_ops, t_bytes = ops_n / PEAK_BF16_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    chunked_ops = ssd_work(b, H, s, P, N, chunk)
    records["ssd_scan"] = dict(
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
        bound_ms=bound_ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, bound_ops_ms=t_ops, bound_bytes_ms=t_bytes,
        bound_share=bound_ms / ms, first_version_ms=SSD_FIRST_VERSION_MS,
        speedup_over_first_version=SSD_FIRST_VERSION_MS / ms,
        device_ms_by_kernel=by_kernel,
        device_ms=sum(by_kernel.values()),
        ms_float32=ms_f32, chunk_float32=ss.CHUNK[f32],
        chunk=chunk, chunked_ops=chunked_ops,
        tflops_chunked=chunked_ops / ms / 1e9,
        recurrence_ops=ops_n, tflops_recurrence=ops_n / ms / 1e9,
        chunk_state_bytes=b * H * nc * N * P * 4,
        state_traffic_bytes=4 * b * H * nc * N * P * 4,
        workspace_bytes=ss.workspace_bytes(b, H, s, P, N, bf16, True),
        ptxas=build_report("ssd_scan.cu"), bf16_rounding_steps=steps,
        errors=errs, carry_over_tolerance=carry,
        tolerance={"float32": SSD_F32_TOL, "bfloat16": SSD_BF16_TOL},
        shape=f"x [1,{H},{s},{P}] bf16 (a [1,{s},{H},{P}] view), B/C one "
              f"group [1,{s},{N}] expanded over the heads, one layer")
    del args

    # -- moe_gather: DeepSeekMoE-16B's dispatch (64 experts, top 6, d 2,048)
    # of the serve phase's longest prompt (capacity 720) and of one decode
    # step of 8 slots (capacity 4); edges: a sequence of only dummy rows,
    # rows of 12 and 10 bytes -------------------------------------------------
    moe_cfg = configs.get("deepseek-moe-16b").moe
    d = 2048

    def dispatch(b, s):
        logits = torch.randn((b, s, moe_cfg.num_experts), generator=gen,
                             device=dev)
        ids = torch.topk(logits, moe_cfg.top_k, dim=-1).indices
        cap = tmoe.capacity(s, moe_cfg)
        tok, _ = tmoe.dispatch_indices(ids, torch.ones_like(ids).float(),
                                       moe_cfg, cap)
        base = torch.arange(b, dtype=torch.int32, device=dev)[:, None] * s
        return torch.where(tok < s, tok + base, b * s).reshape(-1), cap

    cases = {}
    for b, s in ((1, SERVE_PROMPT[1]), (SERVE_SLOTS, 1)):
        rows, cap = dispatch(b, s)
        cases[(b, s)] = (torch.randn((b * s, d), generator=gen,
                                     device=dev).to(bf16), rows, cap)
        for dtype in (bf16, f32):
            x = cases[(b, s)][0].to(dtype)
            check(torch.equal(md.moe_gather(x, rows),
                              ref.moe_gather_ref(x, rows)),
                  f"moe_gather {dtype} B={b} S={s} differs from plain")
    x = cases[(1, SERVE_PROMPT[1])][0]
    dummies = torch.full((4 * moe_cfg.num_experts,), x.shape[0],
                         dtype=torch.int32, device=dev)
    check(not md.moe_gather(x, dummies).any(), "moe_gather: dummy rows")
    for dtype, width in ((f32, 3), (bf16, 5)):
        xs = torch.randn((50, width), generator=gen, device=dev).to(dtype)
        tok = torch.randint(-2, 53, (200,), generator=gen, device=dev,
                            dtype=torch.int32)
        check(torch.equal(md.moe_gather(xs, tok), ref.moe_gather_ref(xs, tok)),
              f"moe_gather edge rows of {width} {dtype}")
    per = {}
    for (b, s), (x, rows, cap) in cases.items():
        x_pad = torch.cat([x, x.new_zeros((1, d))])
        idx = rows.long()
        live = int((rows < x.shape[0]).sum())
        nbytes = rows.numel() * 4 + live * d * 2 + rows.numel() * d * 2

        def kernel_fn():
            return md.moe_gather(x, rows)

        def library_fn():
            return torch.index_select(x_pad, 0, idx)

        # by device time too: at a decode step's size, events measure the
        # host's launch as much as the kernel
        dev_k = device_ms_by_kernel(torch, kernel_fn, 50)
        dev_l = device_ms_by_kernel(torch, library_fn, 50)
        per[f"B={b} S={s}"] = dict(
            rows=rows.numel(), live_rows=live, capacity=cap,
            kernel_ms=cuda_ms(torch, kernel_fn, 50),
            plain_ms=cuda_ms(torch, lambda: ref.moe_gather_ref(x, rows), 20),
            library_ms=cuda_ms(torch, library_fn, 50),
            kernel_device_ms=sum(dev_k.values()),
            library_device_ms=sum(dev_l.values()),
            device_kernels={**dev_k, **dev_l},
            bound_ms=nbytes / PEAK_BYTES_S * 1e3)
    prefill = per[f"B=1 S={SERVE_PROMPT[1]}"]
    step = per[f"B={SERVE_SLOTS} S=1"]   # one decode step of every slot
    records["moe_gather"] = dict(
        max_abs_err=0.0, ms=prefill["kernel_ms"], plain_ms=prefill["plain_ms"],
        bound_ms=prefill["bound_ms"], bound_by="bytes",
        library_ms=prefill["library_ms"], decode_step_ms=step["kernel_ms"],
        decode_step_library_ms=step["library_ms"],
        decode_step_bound_ms=step["bound_ms"],
        device_ms=prefill["kernel_device_ms"],
        library_device_ms=prefill["library_device_ms"],
        decode_step_device_ms=step["kernel_device_ms"],
        decode_step_library_device_ms=step["library_device_ms"],
        per_call=per,
        shape=f"x [{SERVE_PROMPT[1]},{d}] bf16, {prefill['rows']} rows "
              f"(64 experts x capacity {prefill['capacity']}); library: "
              f"index_select on the zero-padded x")
    del cases, x, x_pad
    torch.cuda.empty_cache()
    for name, rec in records.items():
        say("ssm-moe kernels", kernel=name, **rec)
    return records


# ---------------------------------------------------------------------------
# phase 8 (training): the scan's and the gather's backward vs plain
# ---------------------------------------------------------------------------

#: the scan's backward cases at Mamba2-780M's layer (48 heads of 64, state
#: 128): (label, B, S, dt shift, B/C per head, with a final-state gradient);
#: phase 17's training length, the serve phase's longest prompt, and edges
SCAN_BWD_SHAPES = (
    ("train 4096", 1, 4096, 0.0, False, False),
    ("long 8192", 1, 8192, 0.0, False, False),
    ("one token", 1, 1, 0.0, False, True),
    ("ragged", 2, 4097, 0.0, False, True),
    ("per-head B/C", 1, 1000, SMALL_DT_SHIFT, True, True),
    ("small dt", 1, 4096, SMALL_DT_SHIFT, False, True),
)
#: DeepSeekMoE-16B's dispatch of one training row: 64 experts, top 6,
#: capacity 480 at 4,096 tokens
GATHER_BWD_TOKENS = 4096


def scan_backward_bound(b, h, s, p, n, groups, elem):
    """The scan backward's least time: its bytes (x, dy, dx and B, C, dB,
    dC of the groups in ``elem`` bytes, dt and ddt float32, each once) at
    the memory rate, or its least operations, the recurrence's backward (per
    position and head the state recomputed, its gradient passed back and
    dx, dB, dC: 5 N P multiply-adds) at the bf16 tensor-core rate."""
    nbytes = elem * (3 * b * h * s * p + 4 * b * groups * s * n) \
        + 4 * (2 * b * h * s + 2 * h)
    ops_n = 10 * b * h * s * n * p
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_n / PEAK_BF16_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops_n


def phase_ssm_moe_backward(torch):
    """The training path's two new kernels against their plain versions on
    the card: the scan's backward at Mamba2-780M's layer in both dtypes
    (float32 within 2e-4 of each gradient's largest magnitude; bfloat16
    within 5e-2 of it and one rounding step of each value), on edges, a
    second call bit-identical, and its time beside the plain version's and
    the bound at 4,096 and 8,192 tokens (device time per launch under the
    profiler, ptxas's registers and spills); the gather's backward at
    DeepSeekMoE-16B's dispatch of a 4,096-token row bit-exact against its
    plain version and within one rounding step of a float32
    ``index_add_``, on a sequence of only dummy rows, and its time beside
    the bound and ``index_add_``'s.  Returns the two records."""
    from repro_torch import configs
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import moe as tmoe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    bf16, f32 = torch.bfloat16, torch.float32
    t_phase = time.perf_counter()
    H, P, N = 48, 64, 128

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(b, s, dtype, shift, per_head, with_dh):
        g = H if per_head else 1
        x = randn(b, s, H, P, scale=0.5).to(dtype).transpose(1, 2)
        dt = torch.nn.functional.softplus(randn(b, s, H) - shift) \
            .transpose(1, 2)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        Bm = randn(b, s, g, N, scale=0.3).to(dtype).transpose(1, 2)
        Cm = randn(b, s, g, N, scale=0.3).to(dtype).transpose(1, 2)
        dy = randn(b, s, H, P).to(dtype).transpose(1, 2)
        dh = randn(b, H, N, P) if with_dh else None
        return (x, dt, A, Bm, Cm), dy, dh

    def states_of(args):
        return ss.ssd_scan(*args[:3], ss.heads_view(args[3], H),
                           ss.heads_view(args[4], H), keep_states=True)[2]

    errs, abs_errs, steps, identical = {}, [], {}, {}
    for label, b, s, shift, per_head, with_dh in SCAN_BWD_SHAPES:
        for dtype in (bf16, f32):
            what = f"scan backward {label} {dtype}"
            args, dy, dh = inputs(b, s, dtype, shift, per_head, with_dh)
            st = states_of(args)
            got = ss.ssd_scan_backward(*args, dy, dh, states=st)
            again = ss.ssd_scan_backward(*args, dy, dh, states=st)
            identical[what] = all(torch.equal(x, y)
                                  for x, y in zip(got, again))
            check(identical[what], f"{what}: two calls differ")
            want = ref.ssd_scan_backward_ref(*args, dy, dh,
                                             chunk=ss.CHUNK[dtype])
            shares = []
            for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                  want):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{what} {name}: {g.shape} {g.dtype} against "
                      f"{w.shape} {w.dtype}")
                share, err = _grad_close(torch, g, w, f"{what} {name}", steps,
                                         f32_rel=SSD_F32_TOL,
                                         bf16_rel=SSD_BF16_TOL)
                shares.append(share)
                abs_errs.append(err)
            errs[what] = max(shares)
            del args, dy, dh, st, got, again, want
            torch.cuda.empty_cache()

    # -- time at 4,096 and 8,192 tokens, bf16 --------------------------------
    timed = {}
    for s in (4096, 8192):
        args, dy, _ = inputs(1, s, bf16, 0.0, False, False)
        st = states_of(args)
        ms = cuda_ms(torch, lambda: ss.ssd_scan_backward(*args, dy,
                                                         states=st), 10)
        plain = cuda_ms(torch, lambda: ref.ssd_scan_backward_ref(
            *args, dy, chunk=ss.CHUNK[bf16]), 2)
        fwd = cuda_ms(torch, lambda: ss.ssd_scan(
            *args[:3], ss.heads_view(args[3], H), ss.heads_view(args[4], H),
            keep_states=True), 10)
        by_kernel = device_ms_by_kernel(
            torch, lambda: ss.ssd_scan_backward(*args, dy, states=st), 5)
        b_ms, b_by, nbytes, ops_n = scan_backward_bound(1, H, s, P, N, 1, 2)
        timed[s] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        bound_bytes=nbytes, bound_ops=ops_n,
                        bound_share=b_ms / ms, forward_with_states_ms=fwd,
                        device_ms_by_kernel=by_kernel,
                        device_ms=sum(by_kernel.values()),
                        states_kept_bytes=st.numel())
        del args, dy, st
        torch.cuda.empty_cache()
    scan = dict(timed[4096])
    scan.update(
        library_ms=None, max_abs_err=max(abs_errs), errors=errs,
        bf16_rounding_steps=steps, bit_identical=identical,
        long_8192=timed[8192], ptxas=build_report("ssd_scan_backward.cu"),
        tolerance={"float32": SSD_F32_TOL, "bfloat16": SSD_BF16_TOL},
        library="none: no single PyTorch call computes the scan's gradient",
        shape=f"Mamba2-780M layer: x, dy [1,{H},4096,{P}] bf16 ([1,4096,"
              f"{H},{P}] views), B/C one group [1,1,4096,{N}]")
    say("ssm-moe kernels", kernel="ssd_scan_backward", **scan)

    # -- the gather's backward: DeepSeekMoE-16B's dispatch of a row ---------
    moe_cfg = configs.get("deepseek-moe-16b").moe
    d, t = 2048, GATHER_BWD_TOKENS
    logits = torch.randn((1, t, moe_cfg.num_experts), generator=gen,
                         device=dev)
    ids = torch.topk(logits, moe_cfg.top_k, dim=-1).indices
    cap = tmoe.capacity(t, moe_cfg)
    tok, _ = tmoe.dispatch_indices(ids, torch.ones_like(ids).float(),
                                   moe_cfg, cap)
    rows = tok.reshape(-1)
    k = moe_cfg.top_k
    g_errs, g_steps = {}, {}
    for dtype in (bf16, f32):
        dout = torch.randn((rows.numel(), d), generator=gen,
                           device=dev).to(dtype)
        got = md.moe_gather_backward(dout, rows, t, max_rows_per_token=k)
        again = md.moe_gather_backward(dout, rows, t, max_rows_per_token=k)
        check(torch.equal(got, again), f"gather backward {dtype}: two calls "
              f"differ")
        check(torch.equal(got, ref.moe_gather_backward_ref(
            dout, rows, t, max_rows_per_token=k)),
              f"gather backward {dtype}: differs from its plain version")
        live = rows < t
        yard = torch.zeros((t, d), device=dev).index_add_(
            0, rows[live].long(), dout[live].float())
        g_steps[str(dtype)] = float(((got.float() - yard).abs()
                                     / (F32_TOL + BF16_STEP * yard.abs()))
                                    .max())
        check(g_steps[str(dtype)] <= 1.0, f"gather backward {dtype}: "
              f"{g_steps[str(dtype)]} of a rounding step from a float32 "
              f"index_add_")
        g_errs[str(dtype)] = float((got.float() - yard).abs().max())
        dummies = torch.full((4 * moe_cfg.num_experts,), t, dtype=torch.int32,
                             device=dev)
        check(not md.moe_gather_backward(dout[:dummies.numel()], dummies, t,
                                         max_rows_per_token=k).any(),
              f"gather backward {dtype}: dummy rows")
    dout = dout.to(bf16)
    live = int((rows < t).sum())
    idx = rows.clamp(max=t).long()

    def kernel_fn():
        return md.moe_gather_backward(dout, rows, t, max_rows_per_token=k)

    def library_fn():   # the dummy rows land in a spare row t
        return torch.zeros((t + 1, d), dtype=bf16, device=dev).index_add_(
            0, idx, dout)

    nbytes = live * d * 2 + rows.numel() * 4 + t * d * 2
    dev_k = device_ms_by_kernel(torch, kernel_fn, 20)
    dev_l = device_ms_by_kernel(torch, library_fn, 20)
    gather = dict(
        max_abs_err=0.0, index_add_f32_abs_err=g_errs,
        index_add_f32_rounding_steps=g_steps,
        ms=cuda_ms(torch, kernel_fn, 50),
        plain_ms=cuda_ms(torch, lambda: ref.moe_gather_backward_ref(
            dout, rows, t, max_rows_per_token=k), 10),
        library_ms=cuda_ms(torch, library_fn, 50),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes",
        bound_bytes=nbytes, device_ms=sum(dev_k.values()),
        library_device_ms=sum(dev_l.values()),
        device_kernels={**dev_k, **dev_l}, rows=rows.numel(),
        live_rows=live, capacity=cap,
        ptxas=build_report("moe_dispatch.cu"),
        shape=f"dout [{rows.numel()},{d}] bf16 (64 experts x capacity "
              f"{cap}) onto x [{t},{d}]; library: zeros + index_add_ "
              f"(bf16, atomics' order)",
        seconds=time.perf_counter() - t_phase)
    say("ssm-moe kernels", kernel="moe_gather_backward", **gather)
    del dout, logits
    torch.cuda.empty_cache()
    return {"ssd_scan_backward": scan, "moe_gather_backward": gather}


# ---------------------------------------------------------------------------
# phase 7: serving Gemma2-27B at full width
# ---------------------------------------------------------------------------

def _serve_requests(Request, seed, vocab, lengths, new):
    rng = np.random.default_rng(seed)
    return [Request(rid=rid,
                    prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=int(m))
            for rid, (n, m) in enumerate(zip(lengths, new))]


def _run_engine(engine, reqs, resize=None):
    """Submit everything and tick to the end, resizing after tick
    ``resize[0]`` to ``resize[1]`` slots; returns the wall seconds."""
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    tick = 0
    while engine.active or engine.waiting:
        if resize is not None and tick == resize[0]:
            engine.resize(resize[1])
        engine.step()
        tick += 1
        check(tick < 10_000, "engine did not drain")
    return time.perf_counter() - t0


def _logit_errs(got, want, tol):
    """``got`` against ``want`` (``[vocab]``): the largest absolute
    difference, its largest share of ``tol + tol * |want|``, and the RMS
    difference over ``want``'s standard deviation."""
    diff = (got - want).abs()
    return dict(max_abs=float(diff.max()),
                over_tol=float((diff / (tol * (1 + want.abs()))).max()),
                rms_over_std=float(diff.pow(2).mean().sqrt() / want.std()))


def _replay_class(ServingEngine):
    """A ``ServingEngine`` that serves given tokens in place of its own
    argmax: ``script[rid]`` lists the tokens another run generated for
    request ``rid``.  It follows that run's schedule exactly.  Where its own
    argmax was another token, ``own_lead`` keeps that token's lead over the
    script's one and the script token's logit."""

    class Replay(ServingEngine):
        def __init__(self, *args, script, **kw):
            super().__init__(*args, **kw)
            self.script, self.reqs, self.own_lead = script, [], []

        def submit(self, req):
            self.reqs.append(req)
            super().submit(req)

        def _admit(self):
            # a request admitted here decodes in this same tick, so its
            # first token is replaced before the decode reads it
            super()._admit()
            self._follow()

        def step(self):
            super().step()
            self._follow()

        def _follow(self):
            for r in self.reqs:
                want = self.script[r.rid][:len(r.generated)]
                if r.generated and r.generated[-1] != want[-1]:
                    self.own_lead.append((
                        float(r.logits[r.generated[-1]]
                              - r.logits[want[-1]]),
                        float(r.logits[want[-1]])))
                r.generated[:] = want
            for slot, r in self.active.items():
                self.last_token[slot] = r.generated[-1]

    return Replay


class _PinnedRoutes:
    """Pins the MoE routing of check (i)'s replay to the kernel run's:
    :meth:`record` keeps the expert ids of every ``route`` call of one run,
    and :meth:`replay` makes the next run, on the same schedule, take them,
    with weights and load-balance loss from its own router probabilities
    (phase 17 pins a training step's routes the same way).  The two runs then
    differ only in how the kernels' functions are computed, and not in a
    top-k choice that a rounding step flipped; ``rerouted`` counts the
    tokens whose own choice was another set."""

    def __init__(self, tmoe):
        self.tmoe, self.route = tmoe, tmoe.route
        self.ids, self.calls, self.rerouted, self.routed = [], None, 0, 0

    def record(self):
        def route(x, params, moe):
            out = self.route(x, params, moe)
            self.ids.append(out[0])
            return out

        self.tmoe.route = route

    def replay(self):
        import torch

        self.calls = iter(self.ids)

        def route(x, params, moe):
            own, _, aux = self.route(x, params, moe)
            ids = next(self.calls, None)
            check(ids is not None and ids.shape == own.shape,
                  "pinned routes: the replay routed other calls")
            self.rerouted = self.rerouted + (
                own.sort(-1).values != ids.sort(-1).values).any(-1).sum()
            self.routed += own.shape[0] * own.shape[1]
            probs = torch.softmax(x.float() @ params.router, dim=-1)
            w = probs.gather(-1, ids)
            # the load-balance loss of the pinned choice (training's aux)
            e = probs.shape[-1]
            frac = torch.nn.functional.one_hot(ids, e).float().sum(2) \
                .mean(1)
            aux = e * (frac * probs.mean(dim=1)).sum(-1).mean()
            return ids, w / w.sum(-1, keepdim=True).clamp_min(1e-9), aux

        self.tmoe.route = route

    def restore(self):
        self.tmoe.route = self.route


def trained_dt_bias_(torch, model, seed):
    """Mamba-2's published ``dt_bias`` initialization in every Mamba layer
    of ``model``: dt log-uniform in [1e-3, 1e-1], the bias its inverse
    softplus.  The reference's zero bias gives dt about 0.7, where the state
    forgets within a few positions; a trained model's carries across
    hundreds, through the scan's chunk boundaries and the decode steps."""
    gen = torch.Generator(device=model.embed.device).manual_seed(seed)
    lo, hi = np.log(1e-3), np.log(1e-1)
    for layer in model.layers:
        bias = getattr(layer.mixer, "dt_bias", None)
        if bias is not None:
            u = torch.rand(bias.shape, generator=gen, device=bias.device)
            dt = torch.exp(lo + u * (hi - lo))
            bias.data.copy_(dt + torch.log(-torch.expm1(-dt)))


def profile_steps(torch, step, n, watch=()):
    """Wall time and device kernel time of ``n`` calls of ``step`` under
    ``torch.profiler``; the busy share is their ratio.  Kernels whose name
    holds one of ``watch`` are also listed with their rank by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # kernels are the events on the device; summing them counts each once
    kernels = sorted((e for e in rows if e.device_type
                      == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -_device_us(e))
    dev_us = sum(_device_us(e) for e in kernels)
    return dict(
        steps=n, wall_ms_per_step=wall / n * 1e3,
        device_ms_per_step=dev_us / n / 1e3 if dev_us else "not measured",
        device_busy_share=dev_us / 1e6 / wall if dev_us else "not measured",
        kernels_per_step=sum(e.count for e in kernels) / n,
        top_kernels_ms_per_step={e.key[:60]: _device_us(e) / n / 1e3
                                 for e in kernels[:8]},
        **({"watched_kernels": {
            e.key[:60]: dict(rank=i + 1, ms_per_step=_device_us(e) / n / 1e3,
                             launches_per_step=e.count / n)
            for i, e in enumerate(kernels)
            if any(w in e.key for w in watch)}} if watch else {}))


def expected_launches(cfg, prefills, steps):
    """Launches of each model kernel in a run of ``prefills`` prefills and
    ``steps`` decode steps: flash once per attention layer per prefill,
    decode attention once per attention layer per step, the scan once per
    Mamba layer per prefill, the gather once per MoE layer per prefill and
    per step."""
    from repro_torch.models.config import MAMBA, MOE

    specs = cfg.layer_specs()
    n_mamba = sum(sp.mixer == MAMBA for sp in specs)
    n_attn = len(specs) - n_mamba
    n_moe = sum(sp.mlp == MOE for sp in specs)
    return {"flash_attention": n_attn * prefills,
            "decode_attention": n_attn * steps,
            "ssd_scan": n_mamba * prefills,
            "moe_gather": n_moe * (prefills + steps)}


def phase_serve(torch, seed, label, spec):
    """One serve phase: the configuration ``spec["model"]`` at full width
    and ``spec["layers"]`` layers, bfloat16, random weights from the seed,
    served through ``ServingEngine``; its launch counts, checks (i) and
    (ii), a profiled decode step and a profiled long prefill."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as TT
    from repro_torch.obs import Tracer
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(spec["model"]),
                              num_layers=spec["layers"])
    slots, s_max = SERVE_SLOTS, spec["s_max"]

    def make_params(config, weights_seed):
        params = TT.init_params(config, weights_seed, device=dev)
        if spec.get("trained_dt"):
            trained_dt_bias_(torch, params, weights_seed)
        return params

    t0 = time.perf_counter()
    params = make_params(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lengths = rng.integers(spec["prompt"][0], spec["prompt"][1] + 1,
                           SERVE_REQUESTS)
    if spec.get("short"):
        lengths[0] = rng.integers(spec["short"][0], spec["short"][1] + 1)
    new = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, SERVE_REQUESTS)
    reqs = _serve_requests(Request, seed, cfg.vocab_size, lengths, new)
    tracer = Tracer(recorder=None)
    engine = ServingEngine(cfg, params, num_slots=slots, s_max=s_max,
                           policy="ondemand", seed=seed, tracer=tracer,
                           device=dev)
    weight_bytes = TT.param_bytes(params)
    cache_bytes = TT.cache_bytes(engine.caches)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts set to 0 just before, read just after ---------
    ops.use_kernels("auto")
    pins = _PinnedRoutes(tmoe)
    pins.record()
    ops.reset_launch_counts()
    try:
        wall = _run_engine(engine, reqs, SERVE_RESIZE)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        pins.restore()
    main_steps, main_events = engine.steps, list(engine.resize_events)
    prefills = [sp for sp in tracer.spans if sp.name == "prefill"]
    decodes = [sp for sp in tracer.spans if sp.name == "decode"]
    want = expected_launches(cfg, len(prefills), engine.steps)
    main_counts = {k: counts[k] for k, n in want.items() if n}
    check(all(len(r.generated) == r.max_new_tokens for r in reqs),
          f"{label}: a request did not finish")
    for k, n in want.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, "
              f"expected {n} ({len(prefills)} prefills, {engine.steps} "
              f"decode steps)")
    per_tok = [sp.duration / sp.args["plen"] * 1e3 for sp in prefills]
    dec_ms = np.array([sp.duration for sp in decodes]) * 1e3
    say(label, model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        requests=len(reqs), prompt_tokens=int(lengths.sum()),
        prompt_lengths=[int(n) for n in (lengths.min(), lengths.max())],
        new_tokens=int(new.sum()), tokens_out=engine.tokens_out, wall_s=wall,
        tokens_per_s=engine.tokens_out / wall,
        prefill_ms_per_prompt_token_median=float(np.median(per_tok)),
        prefill_s_total=float(sum(sp.duration for sp in prefills)),
        decode_step_ms_median=float(np.median(dec_ms)),
        decode_step_ms_max=float(dec_ms.max()), decode_steps=engine.steps,
        prefills=len(prefills), resize_events=engine.resize_events,
        weight_bytes=weight_bytes, cache_bytes=cache_bytes,
        peak_bytes=torch.cuda.max_memory_allocated(), init_s=init_s,
        launches=main_counts)
    # -- device busy share of decode steps: short requests fill every slot
    n = engine.num_slots
    for r in _serve_requests(Request, seed + 2, cfg.vocab_size,
                             [spec["prompt"][0]] * n, [8] * n):
        engine.submit(r)
    engine.step()                       # admits all, first decode step
    torch.cuda.synchronize()
    say(label, profile="decode step", **profile_steps(torch, engine.step, 6))
    # -- and one prefill of the longest prompt (it ends at its first token)
    check(not engine.active and not engine.waiting, "short requests left")
    engine.submit(_serve_requests(Request, seed + 3, cfg.vocab_size,
                                  [spec["prompt"][1]], [1])[0])
    prof = profile_steps(torch, engine.step, 1, spec.get("watch", ()))
    say(label, profile=f"prefill of {spec['prompt'][1]} tokens", **prof)
    if spec.get("watch"):
        check(len(prof["watched_kernels"]) == spec["watched"],
              f"{label}: the prefill profile names "
              f"{list(prof['watched_kernels'])}, expected {spec['watched']} "
              f"kernels holding {spec['watch']}")
    engine.caches = engine._one_caches = None
    del engine
    torch.cuda.empty_cache()

    # -- check (i): the same run in ops mode ref, serving the kernel run's
    # tokens and taking its MoE routing, so that both runs take one
    # schedule (admissions, decode steps, the resize, the experts) and
    # differ only in how the kernels' functions are computed.  Each
    # request's last logits are held to spec["rms"]; where
    # the ref run's own argmax is another token, that token's lead over the
    # kernel run's one must stay inside spec["lead"] times the repo's
    # bfloat16 tolerance.
    Replay = _replay_class(ServingEngine)
    replay = Replay(cfg, params, num_slots=slots, s_max=s_max,
                    policy="ondemand", seed=seed, device=dev,
                    script={r.rid: list(r.generated) for r in reqs})
    ref_reqs = _serve_requests(Request, seed, cfg.vocab_size, lengths, new)
    ops.use_kernels("ref")
    pins.replay()
    try:
        _run_engine(replay, ref_reqs, SERVE_RESIZE)
    finally:
        ops.use_kernels("auto")
        pins.restore()
    check(next(pins.calls, None) is None,
          f"{label}: the ref run routed fewer calls than the kernel run")
    rerouted, pins_routed = int(pins.rerouted), pins.routed
    del pins
    check(replay.steps == main_steps
          and replay.resize_events == main_events,
          f"{label}: the ref run took another schedule than the kernel run")
    errs = [_logit_errs(a.logits, b.logits, BF16_TOL)
            for a, b in zip(reqs, ref_reqs)]
    leads = [lead / (BF16_TOL * (1 + abs(logit)))
             for lead, logit in replay.own_lead]
    rms = max(e["rms_over_std"] for e in errs)
    say(label, check="(i) the kernel run against ops mode ref on its "
        "schedule", max_rms_err_over_logit_std=rms, rms_limit=spec["rms"],
        rms_per_request=[e["rms_over_std"] for e in errs],
        max_abs_logit_err=max(e["max_abs"] for e in errs),
        max_err_over_elementwise_tol=max(e["over_tol"] for e in errs),
        elementwise_tol=f"{BF16_TOL} + {BF16_TOL} x |ref logit| (reported)",
        tokens_compared=sum(len(r.generated) for r in reqs),
        argmax_differs=len(leads),
        max_lead_over_tolerance=max(leads, default=0.0),
        lead_limit=spec["lead"], moe_tokens_routed=pins_routed,
        moe_tokens_rerouted_unpinned=rerouted)
    check(rms <= spec["rms"],
          f"{label}: last logits differ from ops mode ref by {rms} of their "
          f"standard deviation (RMS), limit {spec['rms']}")
    lead = max(leads, default=0.0)
    check(lead <= spec["lead"],
          f"{label}: the ref run's argmax leads the kernel run's token by "
          f"{lead} of the tolerance, limit {spec['lead']}")
    replay.caches = replay._one_caches = None
    del replay
    del params
    torch.cuda.empty_cache()

    # -- check (ii): float32, 2 layers at full width --------------------------
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    params = make_params(cfg32, seed + 1)
    lengths = np.array(spec["f32_prompts"])
    new = np.full(len(lengths), F32_NEW)

    # the kernel run, then its replay in ops mode ref on the same schedule:
    # equal tokens, and last logits within F32_MODEL_TOL
    reqs = _serve_requests(Request, seed + 1, cfg32.vocab_size, lengths, new)
    eng = ServingEngine(cfg32, params, num_slots=3, s_max=s_max, device=dev)
    ops.reset_launch_counts()
    _run_engine(eng, reqs)
    f32_counts = {k: ops.launch_counts()[k] for k in main_counts}
    kern = [r.generated for r in reqs]
    replay = Replay(cfg32, params, num_slots=3, s_max=s_max, device=dev,
                    script={r.rid: list(r.generated) for r in reqs})
    ref_reqs = _serve_requests(Request, seed + 1, cfg32.vocab_size, lengths,
                               new)
    ops.use_kernels("ref")
    try:
        _run_engine(replay, ref_reqs)
    finally:
        ops.use_kernels("auto")
    errs = [_logit_errs(a.logits, b.logits, F32_MODEL_TOL)
            for a, b in zip(reqs, ref_reqs)]
    worst = max(e["over_tol"] for e in errs)
    say(label, check="(ii) float32 kernel run against ops mode ref",
        max_abs_logit_err=max(e["max_abs"] for e in errs),
        max_err_over_tolerance=worst,
        tolerance=f"{F32_MODEL_TOL} + {F32_MODEL_TOL} x |ref logit|",
        argmax_differs=len(replay.own_lead))
    check(not replay.own_lead,
          f"{label} float32 run: kernels and ref mode give other tokens")
    check(worst <= 1.0, f"{label} float32 run: last logits differ from ops "
          f"mode ref beyond the tolerance")
    del eng, replay
    sequential = []
    for r in _serve_requests(Request, seed + 1, cfg32.vocab_size, lengths,
                             new):
        caches = TT.init_caches(cfg32, 1, s_max, device=dev)
        logits, caches = TT.prefill_forward(
            params, {"tokens": torch.as_tensor(r.prompt, device=dev).long()
                     [None]}, cfg32, caches)
        out = [int(logits[0, -1].argmax())]
        for pos in range(len(r.prompt), len(r.prompt) + F32_NEW - 1):
            logits, caches = TT.decode_forward(
                params, {"tokens": torch.tensor([[out[-1]]], device=dev)},
                cfg32, caches,
                torch.tensor([pos], dtype=torch.int32, device=dev))
            out.append(int(logits[0, -1].argmax()))
        sequential.append(out)
        del caches
    check(kern == sequential, f"{label} float32 run: continuous batching and "
          f"sequential prefill + decode give other tokens")
    check(min(f32_counts.values()) > 0,
          f"{label} float32 run launched no kernel of its path")
    say(label, check="(ii) float32, 2 layers at full width",
        prompts=lengths.tolist(), new_tokens=F32_NEW, kernel_eq_ref=True,
        logits_within_tol=True, batched_eq_sequential=True,
        launches=f32_counts)
    del params
    torch.cuda.empty_cache()
    return main_counts


# ---------------------------------------------------------------------------
# phase 11: the keyed main path under the supervisor and the autoscaler
# ---------------------------------------------------------------------------

KEYED_KERNELS = ("segment_sum", "scatter_add", "batched_table_lookup")
#: the supervised run: a checkpoint every SUP_CKPT_EVERY chunks, a failure
#: before chunk SUP_FAIL_AT, the capacity back SUP_RECOVER chunks after the
#: restored checkpoint
SUP_CKPT_EVERY, SUP_FAIL_AT, SUP_RECOVER = 6, 15, 4


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def phase_supervised(torch, items, main, smi):
    """Phase 4's stream and configuration under ``Supervisor``, then under
    ``Autoscaler`` with an SLO latency policy and no schedule; both
    bit-exact against phase 4's run."""
    import shutil
    import tempfile

    from repro_torch.interop import ROW_COLUMNS
    from repro_torch.keyed import KeyedWindowAdapter, WindowSpec
    from repro_torch.kernels import ops
    from repro_torch.obs import FlightRecorder, MetricsRegistry, Tracer
    from repro_torch.runtime import (
        Autoscaler,
        FailurePlan,
        SLOLatencyPolicy,
        StreamExecutor,
        Supervisor,
    )

    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]
    scalars = ("wm", "wm_valid", "max_ts", "max_ts_valid", "late_count")

    def adapter():
        return KeyedWindowAdapter(
            spec, num_slots=NUM_SLOTS, impl="segment",
            backend="device_table", capacity=CAPACITY,
            max_probes=MAX_PROBES)

    def check_run(label, outs, state):
        check(outputs_equal(outs, main["outs"]),
              f"{label}: emissions differ from phase 4's run")
        for k in ROW_COLUMNS + scalars:
            check(np.array_equal(state[k], main["final"][k]),
                  f"{label}: final state {k} differs from phase 4's run")

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # -- (a) the supervised run: counts set to 0 just before ------------
        ring = FlightRecorder()
        tracer = Tracer(recorder=ring)
        registry = MetricsRegistry()
        ex = StreamExecutor(adapter(), degree=DEGREE, chunk_size=CHUNK,
                            tracer=tracer)
        order, per_chunk = [], []
        process = ex.process

        def counted(chunk, **kw):
            before = ops.launch_counts()
            out = process(chunk, **kw)
            after = ops.launch_counts()
            per_chunk.append({k: after[k] - before[k] for k in KEYED_KERNELS})
            return out

        def chunk_fn(i):
            order.append(i)
            return chunks[i]

        ex.process = counted
        sup = Supervisor(ex, chunk_fn, N_CHUNKS, ckpt_dir=ckpt_dir,
                         ckpt_every=SUP_CKPT_EVERY,
                         failure_plan=FailurePlan(fail_at=SUP_FAIL_AT,
                                                  recover_after=SUP_RECOVER),
                         registry=registry)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = sup.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sup_counts = ops.launch_counts()
        main["supervised_mttr_s"] = sup.mttr_s  # phase 14 prints it beside
        check(sorted(outs) == list(range(N_CHUNKS)),
              "supervised: a chunk's output is missing")
        check_run("supervised", [outs[i] for i in range(N_CHUNKS)],
                  ex.snapshot_barrier())
        kinds = [e.kind for e in sup.events]
        need = {"ckpt", "failure", "restore", "shrink", "grow", "blackbox"}
        check(need <= set(kinds), f"supervised: events {sorted(set(kinds))} "
              f"lack {sorted(need - set(kinds))}")
        # the replayed chunks: processed after the failure, before its cursor
        restored = next(e.chunk_index for e in sup.events
                        if e.kind == "restore")
        replayed = [c for pos, (i, c) in enumerate(zip(order, per_chunk))
                    if pos >= SUP_FAIL_AT and restored <= i < SUP_FAIL_AT]
        check(len(replayed) == SUP_FAIL_AT - restored and all(
            c[k] > 0 for c in replayed for k in KEYED_KERNELS),
            f"supervised: replayed chunks launched {replayed}")
        with open(sup.blackbox_paths[0]) as f:
            box = json.load(f)
        fail_t = next(e["ts"] for e in box["traceEvents"]
                      if e["ph"] == "i" and e["name"] == "failure")
        box_chunks = [e for e in box["traceEvents"]
                      if e["ph"] == "X" and e["name"] == "chunk"]
        check(len(box_chunks) == SUP_FAIL_AT and all(
            e["ts"] < fail_t for e in box_chunks),
            f"supervised: the black box holds {len(box_chunks)} chunk spans "
            f"before the failure, expected {SUP_FAIL_AT}")
        spans = {}
        for sp in tracer.spans:
            spans.setdefault(sp.name, []).append(sp.duration)
        step_bytes = {int(d[5:]): _dir_bytes(os.path.join(ckpt_dir, d))
                      for d in os.listdir(ckpt_dir) if d.startswith("step_")}
        svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
        say("supervised", run="Supervisor", chunks_processed=len(order),
            wall_s=wall, launches=sup_counts, events=[
                (e.chunk_index, e.kind) for e in sup.events],
            checkpoint_bytes=step_bytes[restored],
            checkpoint_bytes_by_step=step_bytes,
            ckpt_s=spans["ckpt"], barrier_s=spans["barrier"],
            restore_s=spans["restore"], mttr_s=sup.mttr_s,
            first_replayed_chunk_s=ex.metrics.chunks[
                SUP_FAIL_AT].service_time,
            chunk_ms_median=float(np.median(svc)),
            phase4_chunk_ms_median=main["chunk_ms_median"],
            blackbox_chunk_spans=len(box_chunks),
            replayed_chunk_launches=replayed, bit_identical=True, card=smi)
        del ex, sup, outs, tracer, ring

        # -- (b) the autoscaled run: the degree from an SLO policy ----------
        objective = 3 * main["chunk_ms_median"] / 1e3
        policy = SLOLatencyPolicy(objective=objective, q=0.5, window=4)
        scaler = Autoscaler(policy, [2, 4, 8], cooldown_chunks=2)
        ex = StreamExecutor(adapter(), degree=DEGREE, chunk_size=CHUNK)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = ex.run(chunks, autoscaler=scaler)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        auto_counts = ops.launch_counts()
        check_run("autoscaled", outs, ex.snapshot_barrier())
        check(any(d.applied for d in scaler.decisions),
              "autoscaled: the policy never changed the degree")
        for k in KEYED_KERNELS:
            check(auto_counts[k] > 0, f"autoscaled run launched no {k}")
        svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
        say("supervised", run="Autoscaler(SLOLatencyPolicy)",
            objective_s=objective, wall_s=wall, launches=auto_counts,
            chunk_ms_median=float(np.median(svc)), decisions=[
                dict(chunk=d.chunk_index, current=d.current,
                     proposed=d.proposed, applied=d.applied,
                     handoff_rows=d.handoff_rows, signal=d.signal)
                for d in scaler.decisions],
            bit_identical=True, card=smi)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return [{k: sup_counts[k] for k in KEYED_KERNELS},
            {k: auto_counts[k] for k in KEYED_KERNELS}]


# ---------------------------------------------------------------------------
# phase 12: ServingRuntime over Gemma2-27B with online slot scaling
# ---------------------------------------------------------------------------

#: phase 12's traffic: bursts of requests with prompts of 256-2,048 tokens
#: and 32 new tokens each, slot counts 2, 4 and 8 of 8,192 positions
RT_PROMPT = (256, 2048)
RT_NEW = 32
RT_SLOTS = (2, 4, 8)
RT_GROW_REQUESTS = 12
RT_SHRINK_REQUESTS = 8


def phase_serving_runtime(torch, seed, smi):
    """``ServingRuntime`` over phase 7's Gemma2-27B (16 layers, bfloat16):
    (a) a burst under ``QueueDepthPolicy`` grows the slot count, (b) an
    objective no decode step meets, read through an ``SLOTracker`` fed from
    the engine's decode histogram, shrinks it; then (a) again on check
    (ii)'s float32 two-layer model, held to one request at a time."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TT
    from repro_torch.obs import MetricsRegistry, SLOSpec, SLOTracker, Tracer
    from repro_torch.runtime import BurstyRate, SLOLatencyPolicy
    from repro_torch.serving import ServingEngine, ServingRuntime, \
        request_source

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("gemma2-27b"), num_layers=16)
    prompt_lens = [int(n) for n in np.random.default_rng(seed + 7).integers(
        RT_PROMPT[0], RT_PROMPT[1] + 1, RT_GROW_REQUESTS)]

    def run(config, params, slots, total, policy=None, registry=None):
        tracer = Tracer(recorder=None)
        engine = ServingEngine(config, params, num_slots=slots,
                               s_max=SERVE_SMAX, device=dev)
        rt = ServingRuntime(
            engine,
            request_source(vocab=config.vocab_size, prompt_lens=prompt_lens,
                           max_new_tokens=RT_NEW, total=total, seed=seed),
            BurstyRate(base=0, burst=total, period=64, duty=1),
            slot_candidates=RT_SLOTS, queue_capacity=total + 2,
            policy=policy, cooldown_ticks=1, tracer=tracer,
            registry=registry)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rt.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        prefills = sum(sp.name == "prefill" for sp in tracer.spans)
        want = expected_launches(config, prefills, engine.steps)
        for k in ("flash_attention", "decode_attention"):
            check(counts[k] == want[k] > 0,
                  f"serving-runtime: {k} launched {counts[k]} times, "
                  f"expected {want[k]} ({prefills} prefills, "
                  f"{engine.steps} decode steps)")
        check(engine.tokens_out == total * RT_NEW and all(
            len(r.generated) == RT_NEW for r in rt.requests),
            f"serving-runtime: {engine.tokens_out} tokens out, expected "
            f"{total * RT_NEW}")
        ticks = np.array([sp.duration for sp in tracer.spans
                          if sp.name == "tick"]) * 1e3
        summary = dict(
            requests=total, tokens_out=engine.tokens_out, wall_s=wall,
            tokens_per_s=engine.tokens_out / wall, ticks=len(rt.reports),
            tick_ms_median=float(np.median(ticks)),
            tick_ms_max=float(ticks.max()), prefills=prefills,
            decode_steps=engine.steps, resize_events=engine.resize_events,
            slots_by_tick=[r.num_slots for r in rt.reports],
            launches={k: counts[k] for k in ("flash_attention",
                                             "decode_attention")})
        tokens = {r.rid: list(r.generated) for r in rt.requests}
        engine.caches = engine._one_caches = None
        return summary, tokens, summary["launches"]

    params = TT.init_params(cfg, seed, device=dev)
    grow, _, grow_counts = run(cfg, params, RT_SLOTS[0], RT_GROW_REQUESTS)
    check(any(e["new"] > e["old"] for e in grow["resize_events"]),
          "serving-runtime (a): the burst did not grow the slot count")
    say("serving-runtime", run="(a) burst, QueueDepthPolicy, bf16",
        model=cfg.name, layers=cfg.num_layers, prompt_lengths=prompt_lens,
        **grow, card=smi)

    registry = MetricsRegistry()
    tracker = SLOTracker(SLOSpec(
        name="decode", objective=1e-4, compliance=0.9, short_window=2,
        long_window=4, fast_burn=2.0, slow_burn=1.0))
    policy = SLOLatencyPolicy(objective=1e-4, mode="serving", tracker=tracker)
    shrink, _, shrink_counts = run(cfg, params, RT_SLOTS[-1],
                                   RT_SHRINK_REQUESTS, policy, registry)
    check(policy.histogram is registry.histogram("serving.decode_step_s"),
          "serving-runtime (b): the tracker is not fed from the engine")
    check(any(e["new"] < e["old"] for e in shrink["resize_events"]),
          "serving-runtime (b): the breach did not shrink the slot count")
    check(tracker.breaches >= 1, "serving-runtime (b): no breach")
    say("serving-runtime", run="(b) unmeetable SLOLatencyPolicy, bf16",
        **shrink, tracker_percentile_s=tracker.percentile(),
        tracker_breaches=tracker.breaches,
        tracker_samples=tracker.total_n, last_signal=policy.last_signal,
        card=smi)
    del params
    torch.cuda.empty_cache()

    # -- (a) in float32, 2 layers at full width: batched == one at a time ----
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    params = TT.init_params(cfg32, seed + 1, device=dev)
    f32, tokens, _ = run(cfg32, params, RT_SLOTS[0], RT_GROW_REQUESTS)
    check(any(e["new"] > e["old"] for e in f32["resize_events"]),
          "serving-runtime float32: the burst did not grow the slot count")
    source = request_source(vocab=cfg32.vocab_size, prompt_lens=prompt_lens,
                            max_new_tokens=RT_NEW, total=RT_GROW_REQUESTS,
                            seed=seed)
    for req in source.take(RT_GROW_REQUESTS):
        caches = TT.init_caches(cfg32, 1, SERVE_SMAX, device=dev)
        logits, caches = TT.prefill_forward(
            params, {"tokens": torch.as_tensor(req.prompt, device=dev).long()
                     [None]}, cfg32, caches)
        out = [int(logits[0, -1].argmax())]
        for pos in range(len(req.prompt), len(req.prompt) + RT_NEW - 1):
            logits, caches = TT.decode_forward(
                params, {"tokens": torch.tensor([[out[-1]]], device=dev)},
                cfg32, caches,
                torch.tensor([pos], dtype=torch.int32, device=dev))
            out.append(int(logits[0, -1].argmax()))
        check(tokens[req.rid] == out, f"serving-runtime float32: request "
              f"{req.rid} differs from one request at a time")
        del caches
    say("serving-runtime", run="(a) float32, 2 layers at full width",
        **f32, batched_eq_sequential=True, card=smi)
    del params
    torch.cuda.empty_cache()
    return [grow_counts, shrink_counts]


# ---------------------------------------------------------------------------
# phase 13: the paper's five state access patterns through StreamExecutor
# ---------------------------------------------------------------------------

#: the patterns' state: the keyed plane's key space, int64 slots (8 MiB)
PAT_SLOTS = 1 << 20
#: S1 and S2: tasks in chunks of 2,048 (slotmap: 2,100, a multiple of its
#: degrees 3, 5 and 7); S3-S5: 65,536 tasks in chunks of 8,192
PAT_S1_TASKS = 4096
PAT_S2_TASKS, PAT_S2_CHUNK = 16384, 2048
PAT_SLOTMAP_CHUNK = 2100
PAT_TASKS, PAT_CHUNK = 65536, 8192


def pattern_profile(torch, process, chunk, steps):
    """One chunk under ``torch.profiler``: kernels launched per scan step,
    device time and the device's busy share of the chunk's wall
    (``process`` ends in a synchronize); and, by CUDA's sync debug mode,
    the host synchronizations the chunk made (a copy from or to the host
    or a value read back; the explicit synchronize is not one).  The
    profiler can drop device events late in a long process, so its counts
    are floors; the sync count does not depend on it."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            process(chunk)
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
    dev_us = sum(e.time_range.elapsed_us() for e in events)
    return dict(
        profiled_steps=steps, kernels_per_step=len(events) / steps,
        host_syncs=sum("synchronizing CUDA operation" in str(w.message)
                       for w in syncs),
        profiled_wall_ms=wall * 1e3,
        device_ms=dev_us / 1e3 if dev_us else "not measured",
        device_busy_share=dev_us / 1e6 / wall if dev_us else "not measured")


def phase_patterns(torch, seed, smi):
    """S1-S5 on the card through their entry points (S1: ``SerialState.run``
    on a card mesh; S2-S5: ``StreamExecutor`` with the SPMD adapters, online
    resizes, the default mesh factory: the card), each held to the port's
    CPU oracle (``core.semantics``) and the schedule-dependent outputs to
    the same batched run on the CPU; then S3 under ``Supervisor`` with a
    failure, equal to the unfailed run with the same degrees."""
    import functools
    import shutil
    import tempfile

    from repro_torch.core import WorkerMesh, patterns as P, semantics as S
    from repro_torch.runtime import (
        AccumulatorAdapter,
        FailurePlan,
        PartitionedAdapter,
        SeparateAdapter,
        StreamExecutor,
        SuccessiveAdapter,
        Supervisor,
        default_mesh_factory,
    )

    t_phase = time.perf_counter()
    cpu_factory = functools.partial(default_mesh_factory, device="cpu")
    rng = np.random.default_rng(seed + 13)
    tasks = rng.integers(0, 1 << 40, PAT_TASKS)              # int64
    v0 = rng.integers(-1000, 1000, PAT_SLOTS)                # int64, 8 MiB
    # S4's fitness stream, drawn as the simulator draws it
    fitness = np.random.default_rng(seed).random(PAT_TASKS).astype(np.float32)
    i64 = functools.partial(torch.tensor, dtype=torch.int64)

    def same(a, b):
        if isinstance(b, dict):
            return all(same(a[k], b[k]) for k in b)
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        return a.dtype == b.dtype and torch.equal(a, b)

    def cat(outs, key=None):
        return torch.cat([(o if key is None else o[key]).cpu() for o in outs])

    def drive(make, xs, chunk, degree, schedule, factory=None, steps=None,
              label=None):
        """The stream through ``StreamExecutor`` at ``degree`` with
        ``schedule``.  On the card (``factory`` None) the chunks but the
        last are timed, and the last runs under the profiler."""
        kw = {} if factory is None else dict(mesh_factory=factory)
        ex = StreamExecutor(make(), degree=degree, chunk_size=chunk, **kw)
        chunks = [xs[i: i + chunk] for i in range(0, len(xs), chunk)]
        if factory is not None:
            outs = ex.run(chunks, schedule=schedule)
            return dict(outs=outs, state=ex.state)
        t0 = time.perf_counter()
        outs = ex.run(chunks[:-1], schedule=schedule)
        wall = time.perf_counter() - t0
        last = len(chunks) - 1
        if schedule and last in schedule:
            ex.set_degree(schedule[last])
        degrees = [c.n_workers for c in ex.metrics.chunks]
        prof = pattern_profile(
            torch, lambda c: outs.append(ex.process(c)), chunks[-1],
            steps(chunk, ex.degree))
        total = sum(steps(chunk, d) for d in degrees)
        record = dict(
            run=label, wall_s=wall, timed_chunks=len(degrees), steps=total,
            step_us=wall / total * 1e6,
            chunk_ms_median=float(np.median(
                [c.service_time for c in ex.metrics.chunks[:-1]]) * 1e3),
            degrees=degrees + [ex.degree], resizes=[
                (r.n_old, r.n_new, r.protocol, r.handoff_items)
                for r in ex.metrics.resizes], **prof)
        return dict(outs=outs, state=ex.state, record=record)

    records = []

    def timed(fn, *args, **kw):
        """``fn``'s result and its seconds (the CPU checks' cost)."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t

    def report(res, cpu_s, **checks):
        for what, ok in checks.items():
            check(ok, f"patterns {res['record']['run']}: {what} differs")
        res["record"]["cpu_check_s"] = cpu_s
        records.append(res["record"])
        say("patterns", **res["record"], bit_exact=sorted(checks), card=smi)

    # -- S1: the serial fold on a card mesh --------------------------------
    s1 = P.SerialState(f=lambda x, s: x - s, ns=lambda x, s: s * 3 + x)
    xs1 = torch.as_tensor(tasks[:PAT_S1_TASKS])
    t0 = time.perf_counter()
    ys, s = s1.run(WorkerMesh(8), "workers", xs1, i64(7))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (ys_ref, s_ref), cpu_s = timed(S.serial, s1.f, s1.ns, xs1, i64(7))
    check(ys.is_cuda and same(ys, ys_ref) and same(s, s_ref),
          "patterns S1: the card's fold differs from the CPU oracle")
    prof = pattern_profile(
        torch, lambda c: (s1.run(WorkerMesh(8), "workers", c, i64(7)),
                          torch.cuda.synchronize()), xs1[:512], 512)
    rec = dict(run="S1 serial", wall_s=wall, steps=PAT_S1_TASKS,
               step_us=wall / PAT_S1_TASKS * 1e6, **prof, cpu_check_s=cpu_s)
    records.append(rec)
    say("patterns", **rec, bit_exact=["ys", "state"], card=smi)

    # -- S2 block: 1,048,576 int64 slots, degrees 8 -> 4 -> 2 -> 8 --------
    def s2(ownership):
        return P.PartitionedState(
            f=lambda x, s: x - s, ns=lambda x, s: s * 3 + x,
            h=lambda x: (x * 2654435761) % PAT_SLOTS, num_slots=PAT_SLOTS,
            ownership=ownership)

    xs2 = torch.as_tensor(tasks[:PAT_S2_TASKS])
    (ys_ref, v_ref), cpu_s = timed(S.partitioned, s2("block").f,
                                   s2("block").ns, s2("block").h, xs2,
                                   torch.as_tensor(v0))
    res = drive(lambda: PartitionedAdapter(s2("block"), v0), xs2,
                PAT_S2_CHUNK, 8, {2: 4, 4: 2, 6: 8},
                steps=lambda m, n: m, label="S2 block")
    check(res["state"].is_cuda and res["record"]["host_syncs"] == 1,
          f"patterns S2 block: state left the card, or the chunk made "
          f"{res['record']['host_syncs']} host synchronizations (1: its "
          f"copy to the card)")
    report(res, cpu_s, ys=same(cat(res["outs"]), ys_ref),
           v=same(res["state"], v_ref))

    # -- S2 slotmap: the same slots replicated [n, N], degrees 3 -> 5 -> 7 --
    xs2m = torch.as_tensor(tasks[:8 * PAT_SLOTMAP_CHUNK])
    (ys_ref, v_ref), cpu_s = timed(S.partitioned, s2("slotmap").f,
                                   s2("slotmap").ns, s2("slotmap").h, xs2m,
                                   torch.as_tensor(v0))
    res = drive(lambda: PartitionedAdapter(s2("slotmap"), v0), xs2m,
                PAT_SLOTMAP_CHUNK, 3, {3: 5, 6: 7},
                steps=lambda m, n: m, label="S2 slotmap")
    report(res, cpu_s, ys=same(cat(res["outs"]), ys_ref),
           v=same(res["state"], v_ref))
    del ys_ref, v_ref

    # -- S3: flush_every 1, 16, 256 at degree 8; 8 -> 4 -> 8 at 16 ----------
    s3 = P.AccumulatorState(f=lambda x, view: view - x, g=lambda x: x,
                            combine=lambda a, b: a + b, zero=lambda: i64(0))
    xs3 = torch.as_tensor(tasks)
    (_, s3_ref), oracle_s = timed(S.accumulator, s3.f, s3.g, s3.combine, xs3,
                                  i64(0))
    resized = {2: 4, 4: 8}
    for fe, schedule in ((1, None), (16, None), (256, None), (16, resized)):
        def make(fe=fe):
            return AccumulatorAdapter(s3, flush_every=fe)

        label = f"S3 flush_every={fe}" + (" 8->4->8" if schedule else "")
        res = drive(make, xs3, PAT_CHUNK, 8, schedule,
                    steps=lambda m, n: m // n, label=label)
        cpu, cpu_s = timed(drive, make, xs3, PAT_CHUNK, 8, schedule,
                           factory=cpu_factory)
        report(res, cpu_s + oracle_s / 4, state=same(res["state"], s3_ref),
               ys_vs_cpu_run=same(cat(res["outs"]), cat(cpu["outs"])))
        if schedule:
            s3_resized = cat(res["outs"]), res["state"]

    # -- S4: a float32 fitness stream, sync_every 1 and 64, 8 -> 2 -> 8 -----
    s4 = P.SuccessiveApproximationState(
        c=lambda x, s: x < s, s_prime=lambda x, s: torch.minimum(x, s))
    xs4 = torch.as_tensor(fitness)
    inf = torch.tensor(np.inf, dtype=torch.float32)
    (_, s4_ref), oracle_s = timed(S.successive_approximation, s4.c,
                                  s4.s_prime, xs4, inf)
    for se in (1, 64):
        def make(se=se):
            return SuccessiveAdapter(s4, inf, sync_every=se)

        res = drive(make, xs4, PAT_CHUNK, 8, {3: 2, 5: 8},
                    steps=lambda m, n: m // n,
                    label=f"S4 sync_every={se} 8->2->8")
        cpu, cpu_s = timed(drive, make, xs4, PAT_CHUNK, 8, {3: 2, 5: 8},
                           factory=cpu_factory)
        report(res, cpu_s + oracle_s / 2, state=same(res["state"], s4_ref),
               trace_vs_cpu_run=same(cat(res["outs"], "trace"),
                                     cat(cpu["outs"], "trace")))

    # -- S5: 65,536 int64 tasks, degrees 4 -> 8 -----------------------------
    s5 = P.SeparateTaskState(f=lambda x: x * x, s=lambda y, s: s * 31 + y)
    (ys_ref, tr_ref, s5_ref), cpu_s = timed(S.separate_task_state, s5.f,
                                            s5.s, xs3, i64(1))
    res = drive(lambda: SeparateAdapter(s5, i64(1)), xs3, PAT_CHUNK, 4,
                {4: 8}, steps=lambda m, n: m, label="S5 4->8")
    report(res, cpu_s, ys=same(cat(res["outs"], "ys"), ys_ref),
           trace=same(cat(res["outs"], "trace"), tr_ref),
           state=same(res["state"], s5_ref))

    # -- S3 under Supervisor: a failure before chunk 3 ----------------------
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_patterns_")
    try:
        ex = StreamExecutor(AccumulatorAdapter(s3, flush_every=16), degree=8,
                            chunk_size=PAT_CHUNK)
        sup = Supervisor(ex, lambda i: tasks[i * PAT_CHUNK:
                                             (i + 1) * PAT_CHUNK],
                         PAT_TASKS // PAT_CHUNK, ckpt_dir=ckpt_dir,
                         ckpt_every=2,
                         failure_plan=FailurePlan(fail_at=3, recover_after=2))
        t0 = time.perf_counter()
        outs = sup.run()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    events = [(e.chunk_index, e.kind) for e in sup.events]
    # restore of chunk 2 at 8 -> 4, growth back to 8 before chunk 4: the
    # degrees of the 8 -> 4 -> 8 run above
    check(same(cat([outs[i] for i in range(len(outs))]), s3_resized[0])
          and same(ex.state, s3_resized[1]),
          "patterns supervised S3: outputs differ from the unfailed run")
    kinds = {k for _, k in events}
    check({"failure", "restore", "shrink", "grow"} <= kinds,
          f"patterns supervised S3: events {events}")
    rec = dict(run="S3 flush_every=16 supervised", wall_s=wall,
               events=events, mttr_s=sup.mttr_s,
               degrees=[c.n_workers for c in ex.metrics.chunks])
    records.append(rec)
    say("patterns", **rec, bit_exact=["ys", "state"], card=smi)
    say("patterns", seconds=time.perf_counter() - t_phase, card=smi)
    return records


# ---------------------------------------------------------------------------
# phase 14: the multi-process keyed plane, shard hosts on the card
# ---------------------------------------------------------------------------

#: per-direction ring bytes of each shard host: a STEP frame (about 64 KB)
#: and a STEP_OUT frame (up to about 0.7 MB of emissions a shard) fit with
#: room to spare; snapshot, ATTACH and migration frames of several MB may
#: take the pipe, which the transport does by itself
DIST_SHM_CAPACITY = 8 << 20
DIST_KERNELS = ("segment_sum", "table_lookup", "scatter_add")
#: phase 14 (c): the pipe transport over the first chunks
DIST_PIPE_CHUNKS = 8


def card_memory():
    """The card's used MiB and its compute processes' ``(pid, used MiB)``
    as ``nvidia-smi`` reports them (a pid as the driver sees it, which in
    a container need not be the process's own)."""
    def query(what):
        out = subprocess.run(["nvidia-smi", what,
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
        return [[int(v) for v in line.split(",") if v.strip().isdigit()]
                for line in out.stdout.strip().splitlines()]

    return (query("--query-gpu=memory.used")[0][0],
            [tuple(r) for r in query("--query-compute-apps=pid,used_memory")
             if len(r) == 2])


def phase_dist(torch, items, main, smi):
    """Phase 4's stream through ``DistributedKeyedPlane`` with 8 shard-host
    processes on the card: (a) the ring transport with the scatter-ahead
    pipeline, (b) a worker killed under ``Supervisor``, (c) the pipe
    transport, (d) nothing left behind; each bit-exact against phase 4."""
    import multiprocessing
    import shutil
    import tempfile

    from repro_torch.dist import DistributedKeyedPlane
    from repro_torch.interop import ROW_COLUMNS
    from repro_torch.keyed import WindowSpec
    from repro_torch.obs import Tracer
    from repro_torch.runtime import StreamExecutor, Supervisor

    spec = WindowSpec("sliding", size=SIZE, slide=SLIDE, lateness=LATENESS)
    chunks = [items[i: i + CHUNK] for i in range(0, len(items), CHUNK)]
    scalars = ("wm", "wm_valid", "max_ts", "max_ts_valid", "late_count")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t_phase = time.perf_counter()
    planes = []

    def plane(transport, spares):
        ad = DistributedKeyedPlane(
            spec, num_slots=NUM_SLOTS, impl="segment",
            backend="device_table", capacity=CAPACITY,
            max_probes=MAX_PROBES, transport=transport, shards_per_host=1,
            spares=spares, prespawn=DEGREE, shm_capacity=DIST_SHM_CAPACITY,
            blackbox_dir=os.path.join(tmp, f"bb_{transport}"))
        planes.append(ad)
        t0 = time.perf_counter()
        ad._ensure_pool(DEGREE)  # spawn, then every HELLO
        return ad, time.perf_counter() - t0

    def hosts(ad):
        return [h for h in ad._pool + ad._spares if h is not None]

    def close(ad, seen):
        """Close a plane; none of its workers ``seen`` (the dead ones too)
        may live on, and none of their rings remain."""
        rings = [r.name for h in seen for r in (h.rings or ())]
        ad.close()
        alive = [h.pid for h in seen if h.proc.is_alive()]
        left = [r for r in rings if os.path.exists(f"/dev/shm/{r}")]
        check(not alive, f"dist: worker processes {alive} outlive close()")
        check(not left, f"dist: ring segments {left} outlive close()")
        return len(seen), len(rings)

    def check_rows(label, outs, state):
        check(outputs_equal(outs, main["outs"][:len(outs)]),
              f"dist {label}: emissions differ from phase 4's run")
        for k in ROW_COLUMNS + scalars:
            check(np.array_equal(state[k], main["final"][k]),
                  f"dist {label}: final state {k} differs from phase 4's")

    try:
        # -- (a) the ring transport, the scatter-ahead pipeline -------------
        used0, _ = card_memory()
        ad, startup_s = plane("shm", spares=1)
        seen = hosts(ad)
        say("dist", run="startup", workers=DEGREE, spares=1,
            spawn_to_last_hello_s=startup_s,
            worker_pids=[h.pid for h in ad._pool], card=smi)
        hits = []
        inner = ad.step_ahead

        def counting(chunk, prepared=None):
            ok = inner(chunk, prepared=prepared)
            hits.append(ok)
            return ok

        ad.step_ahead = counting
        tracer = Tracer(recorder=None)
        ad.tracer = tracer  # the workers' spans; the executor is untraced
        ex = StreamExecutor(ad, degree=DEGREE, chunk_size=CHUNK,
                            pipeline=True)
        ad.kernel_launches.clear()
        t0 = time.perf_counter()
        outs = ex.run(chunks[:LOOP_CHUNKS])
        snap8 = ex.snapshot_barrier()
        sched = {i - LOOP_CHUNKS: d for i, d in SCHEDULE.items()}
        outs += ex.run(chunks[LOOP_CHUNKS:], schedule=sched)
        wall = time.perf_counter() - t0
        launches = dict(ad.kernel_launches)
        used1, apps = card_memory()  # the workers' CUDA contexts are up
        final = ex.snapshot_barrier()
        check(outputs_equal(outs, main["outs"]),
              "dist (a): emissions differ from phase 4's run")
        check(states_equal(snap8, main["snap8"]),
              "dist (a): chunk-8 barrier snapshot differs from phase 4's")
        check(states_equal(final, main["final"]),
              "dist (a): final state differs from phase 4's")
        vol = ex.metrics.migration_volume()
        check(vol["rows"] == main["volume"]["rows"]
              and vol["slots"] == main["volume"]["slots"],
              f"dist (a): migration {vol} differs from phase 4's "
              f"{main['volume']}")
        want_hits = N_CHUNKS - 2  # each run's first chunk is synchronous
        check(len(hits) == want_hits and all(hits),
              f"dist (a): step_ahead engaged {sum(hits)} of {want_hits}")
        check(not any(ad.fault_events.values()),
              f"dist (a): fault events {ad.fault_events}")
        for k in DIST_KERNELS:
            check(launches.get(k, 0) > 0, f"dist (a): workers launched no {k}")
        steps = [sp.duration for sp in tracer.spans
                 if sp.name == "shard_step"]
        degrees = [DEGREE if i < 12 or i >= 24 else 5
                   for i in range(N_CHUNKS)]
        check(len(steps) == sum(degrees),
              f"dist (a): {len(steps)} shard_step spans, want {sum(degrees)}")
        svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
        say("dist", run="(a) shm", items=len(items), chunks=N_CHUNKS,
            wall_s=wall, items_per_s=len(items) / wall,
            # without the first chunk, whose attach starts each worker's
            # CUDA context
            items_per_s_after_first=(len(items) - CHUNK)
            / (wall - svc[0] / 1e3),
            first_chunk_ms=float(svc[0]),
            chunk_ms_median=float(np.median(svc)),
            chunk_ms_max=float(svc.max()),
            phase4_items_per_s=main["items_per_s"],
            phase4_items_per_s_after_first=(len(items) - CHUNK)
            / (main["wall_s"] - main["first_chunk_ms"] / 1e3),
            phase4_chunk_ms_median=main["chunk_ms_median"],
            card_mib_used_by_plane=used1 - used0,
            card_mib_per_worker=(used1 - used0) / DEGREE,
            compute_apps_mib=apps,
            shard_step_ms_per_chunk=float(np.sum(steps)) / N_CHUNKS * 1e3,
            shard_step_ms_median=float(np.median(steps)) * 1e3,
            shard_step_ms_max=float(np.max(steps)) * 1e3,
            wire_bytes=ad.wire_bytes, launches=launches, resizes=vol,
            step_ahead=f"{sum(hits)}/{want_hits}", bit_identical=True,
            card=smi)
        del ex, outs, snap8, final

        # -- (b) a worker killed under Supervisor on the same plane ---------
        spare = ad._spares[0]
        ad.tracer = Tracer(recorder=None)
        ex = StreamExecutor(ad, degree=DEGREE, chunk_size=CHUNK)
        ad.kernel_launches.clear()
        killed = []

        def chunk_fn(i):
            if i == SUP_FAIL_AT and not killed:
                killed.append(ad._pool[3].pid)
                ad.kill_worker(3)
            return chunks[i]

        sup = Supervisor(ex, chunk_fn, N_CHUNKS,
                         ckpt_dir=os.path.join(tmp, "ckpt"),
                         ckpt_every=SUP_CKPT_EVERY)
        t0 = time.perf_counter()
        souts = sup.run()
        swall = time.perf_counter() - t0
        sup_launches = dict(ad.kernel_launches)
        seen += [h for h in hosts(ad) if h not in seen]
        check(sorted(souts) == list(range(N_CHUNKS)),
              "dist (b): a chunk's output is missing")
        check_rows("(b)", [souts[i] for i in range(N_CHUNKS)],
                   ex.snapshot_barrier())
        kinds = {e.kind for e in sup.events}
        check({"failure", "restore", "shrink", "grow"} <= kinds,
              f"dist (b): supervisor events {sorted(kinds)}")
        ev = ad.fault_events
        check(ev["death_dead"] == 1 and ev["recoveries"] == 1,
              f"dist (b): fault events {ev}")
        check(spare in ad._pool and len(ad._spares) == 1,
              "dist (b): the warm spare was not promoted and replaced")
        for k in DIST_KERNELS:
            check(sup_launches.get(k, 0) > 0,
                  f"dist (b): workers launched no {k}")
        say("dist", run="(b) kill_worker(3) under Supervisor",
            killed_pid=killed, wall_s=swall, mttr_s=ad.mttr_s,
            supervisor_mttr_s=sup.mttr_s,
            phase11_mttr_s=main.get("supervised_mttr_s"),
            events=[(e.chunk_index, e.kind) for e in sup.events],
            fault_events=ev, blackboxes=len(ad.collected_blackboxes),
            launches=sup_launches, bit_identical=True, card=smi)
        n_hosts, n_rings = close(ad, seen)
        say("dist", run="(d) closed shm plane", processes=n_hosts,
            rings=n_rings, alive=0, rings_left=0)
        del ex, sup, souts

        # -- (c) the pipe transport over the first chunks ---------------------
        ad, pipe_startup_s = plane("pipe", spares=0)
        ex = StreamExecutor(ad, degree=DEGREE, chunk_size=CHUNK,
                            pipeline=True)
        ad.kernel_launches.clear()
        t0 = time.perf_counter()
        pouts = ex.run(chunks[:DIST_PIPE_CHUNKS])
        pwall = time.perf_counter() - t0
        pipe_launches = dict(ad.kernel_launches)
        check(outputs_equal(pouts, main["outs"][:DIST_PIPE_CHUNKS]),
              "dist (c): pipe emissions differ from phase 4's run")
        check(states_equal(ex.snapshot_barrier(), main["snap8"]),
              "dist (c): pipe barrier snapshot differs from phase 4's")
        check(ad.wire_bytes["shm"] == 0, "dist (c): the pipe used a ring")
        svc = np.array([c.service_time for c in ex.metrics.chunks]) * 1e3
        say("dist", run="(c) pipe", chunks=DIST_PIPE_CHUNKS,
            spawn_to_last_hello_s=pipe_startup_s, wall_s=pwall,
            items_per_s=DIST_PIPE_CHUNKS * CHUNK / pwall,
            chunk_ms_median=float(np.median(svc)),
            wire_bytes=ad.wire_bytes, launches=pipe_launches,
            bit_identical=True, card=smi)
        del ex, pouts
        n_hosts, n_rings = close(ad, hosts(ad))
        left = multiprocessing.active_children()
        check(not left, f"dist (d): child processes left: {left}")
        say("dist", run="(d) closed pipe plane", processes=n_hosts,
            rings=n_rings, children_left=0,
            phase_s=time.perf_counter() - t_phase)
    finally:
        for ad in planes:
            ad.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [launches, sup_launches, pipe_launches]


# ---------------------------------------------------------------------------
# phase 15: every other architecture the JAX package registers
# ---------------------------------------------------------------------------

#: phase 15's slots
FAMILY_SLOTS = 4
#: phase 15's models at full width, the two largest first: ``layers`` their
#: depth (cut where it is less than the published one; Jamba's cut takes
#: the first ``layers`` of its unit), ``prompt`` the range of the prompts'
#: token counts, ``new`` the decode steps, ``prefix`` / ``src`` the stub
#: frontend's positions (PaliGemma's patch embeddings, Seamless's frames),
#: ``f32`` whether check (ii) runs, and ``rms`` / ``lead`` check (i)'s
#: limits (see SERVES), each between the sound run's reading and that of a
#: fault planted in the kernel route on a throwaway copy (PERF.md, H100):
#: Kimi 0.0063 / 0 sound, 0.162 / 2.86 with every 64th gather row off by
#: one; Jamba 0.0029 / 0.196 sound, 0.0082 / 0.207 with the scan's last
#: position's dt zeroed; PaliGemma 0.0183 / 0 sound, 0.0339 / 0 with the
#: prefix one key short; Seamless 0.0140 / 0.224 sound, 0.108 / 0.943 with
#: one cross layer's output dropped; the dense three 0.0085 / 0 at most
#: sound, CodeQwen 0.0517 / 1.117 with decode one key short
FAMILIES = {
    "kimi-k2-1t-a32b": dict(layers=2, prompt=(256, 1024), new=16,
                            rms=0.02, lead=1.0, f32=False),
    "jamba-1.5-large-398b": dict(layers=4, prompt=(256, 1024), new=16,
                                 rms=0.0055, lead=1.0, f32=False),
    "paligemma-3b": dict(layers=18, prompt=(768, 3840), prefix=256, new=32,
                         rms=0.026, lead=1.0, f32=True),
    "seamless-m4t-medium": dict(layers=12, prompt=(1024, 4096), src=1024,
                                new=32, rms=0.03, lead=1.0, f32=True),
    "codeqwen1.5-7b": dict(layers=4, prompt=(256, 1024), new=16, rms=0.02,
                           lead=1.0, f32=True),
    "granite-8b": dict(layers=4, prompt=(256, 1024), new=16, rms=0.02,
                       lead=1.0, f32=True),
    "minicpm-2b": dict(layers=4, prompt=(256, 1024), new=16, rms=0.02,
                       lead=1.0, f32=True),
}


def family_config(configs, name, layers, **over):
    """``name``'s configuration cut to ``layers`` layers (a unit that does
    not divide the cut is cut to fit), with ``over`` replaced."""
    cfg = configs.get(name)
    unit = cfg.unit
    rest = layers - len(cfg.prefix)
    if rest % len(unit):
        unit = unit[:rest]
    return dataclasses.replace(cfg, num_layers=layers, unit=unit, **over)


def family_launches(cfg, prefills, steps, encodes):
    """``expected_launches`` plus an encoder-decoder's: flash once per
    encoder layer per encoder run (one in each prefill and in each
    ``encodes``) and once per cross layer per prefill, decode attention
    once per cross layer per step."""
    want = expected_launches(cfg, prefills, steps)
    if cfg.encoder_layers:
        want["flash_attention"] += (cfg.num_layers * prefills
                                    + cfg.encoder_layers
                                    * (prefills + encodes))
        want["decode_attention"] += cfg.num_layers * steps
    return want


def family_requests(torch, cfg, spec, seed, lengths):
    """Each request's batch for ``TT.prefill_forward``: its tokens and the
    stub frontend's embeddings (bf16 normals from the seed), and its
    prompt positions."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for n in lengths:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, int(n))), device=dev)}
        for key, what in (("prefix_embeds", "prefix"), ("src_embeds", "src")):
            if spec.get(what):
                batch[key] = torch.randn(
                    (1, spec[what], cfg.frontend_dim), generator=gen,
                    device=dev).to(cfg.cdtype)
        out.append((batch, int(n) + spec.get("prefix", 0)))
    return out


def family_serve(torch, TT, cfg, params, reqs, steps, s_max, script=None):
    """Prefill each request alone into its slot of a ``len(reqs)``-slot
    cache of ``s_max`` positions (the prefill writes through views of the
    slot's rows), then
    decode every slot together ``steps`` times at its own positions; an
    encoder-decoder's slots decode against their own encoder output
    (``TT._encode``).  With ``script`` (one token list per request) the
    run serves those tokens in place of its own argmax and keeps, where its
    own was another token, that token's lead over the script's and the
    script token's logit.  Returns the tokens, each request's last logits,
    the prefills' walls and prompt positions, the steps' walls, the
    leads and the run's wall."""
    dev = torch.device("cuda")
    n = len(reqs)
    caches = TT.init_caches(cfg, n, s_max, device=dev)
    tokens, enc, prefill_s, leads = [], [], [], []

    def take(row, i, k):
        own = int(row.argmax())
        if script is None:
            return own
        want = script[i][k]
        if own != want:
            leads.append((float(row[own] - row[want]), float(row[want])))
        return want

    t_run = time.perf_counter()
    for i, (batch, _) in enumerate(reqs):
        view = [{k: v[i:i + 1] for k, v in c.items()} for c in caches]
        t0 = time.perf_counter()
        logits, _ = TT.prefill_forward(params, batch, cfg, view)
        tokens.append([take(logits[0, -1], i, 0)])
        prefill_s.append(time.perf_counter() - t0)
        if "src_embeds" in batch:
            enc.append(TT._encode(params, batch["src_embeds"], cfg))
    extra = {"enc_out": torch.cat(enc)} if enc else {}
    pos = torch.tensor([p for _, p in reqs], dtype=torch.int32, device=dev)
    step_s = []
    for k in range(steps):
        t0 = time.perf_counter()
        tok = torch.tensor([[t[-1]] for t in tokens], device=dev)
        logits, _ = TT.decode_forward(params, {"tokens": tok, **extra}, cfg,
                                      caches, pos + k)
        rows = logits[:, -1].cpu()
        for i in range(n):
            tokens[i].append(take(rows[i], i, k + 1))
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_run
    del caches, extra
    return dict(tokens=tokens, last=[rows[i] for i in range(n)],
                prefill_s=prefill_s, positions=[p for _, p in reqs],
                step_s=step_s, leads=leads, wall=wall)


def phase_families(torch, seed, smi):
    """Phase 15: each model of ``FAMILIES`` at full width (random bf16
    weights from the seed, freed before the next), four requests prefilled
    one at a time into a 4-slot cache and decoded together, through
    ``TT.prefill_forward`` / ``TT.decode_forward`` with the batch keys a
    user passes (``prefix_embeds``, ``src_embeds``, ``enc_out``); launch
    counts, check (i) against a replay in ops mode ``ref`` on the kernel
    run's tokens and MoE routing, and check (ii) on a float32 2-layer model
    at full width.  Returns the main runs' launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as TT

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    paths = []
    for m, (name, spec) in enumerate(FAMILIES.items()):
        t_model = time.perf_counter()
        cfg = family_config(configs, name, spec["layers"])
        full = configs.get(name)
        cut = {}
        if cfg.num_layers < full.num_layers:
            cut["layers"] = f"{cfg.num_layers} of {full.num_layers}"
        if cfg.unit != full.unit:
            cut["unit"] = (f"layers 0-{len(cfg.unit) - 1} of its unit of "
                           f"{len(full.unit)}")
        torch.cuda.reset_peak_memory_stats()
        params = TT.init_params(cfg, seed + m, device=dev)
        rng = np.random.default_rng(seed + 100 + m)
        lengths = rng.integers(spec["prompt"][0], spec["prompt"][1] + 1,
                               FAMILY_SLOTS)
        reqs = family_requests(torch, cfg, spec, seed + 200 + m, lengths)
        # every prompt of the spec's range fits, and its decode steps
        s_max = spec["prompt"][1] + spec.get("prefix", 0) + spec["new"]

        # -- the main path: counts set to 0 just before, read just after -----
        ops.use_kernels("auto")
        pins = _PinnedRoutes(tmoe)
        pins.record()
        ops.reset_launch_counts()
        try:
            run = family_serve(torch, TT, cfg, params, reqs, spec["new"],
                               s_max)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        finally:
            pins.restore()
        want = family_launches(cfg, len(reqs), spec["new"],
                               len(reqs) if cfg.encoder_layers else 0)
        main_counts = {k: counts[k] for k, n in want.items() if n}
        for k, n in want.items():
            check(counts[k] == n, f"{name}: {k} launched {counts[k]} times, "
                  f"expected {n}")
        paths.append(main_counts)
        generated = sum(len(t) for t in run["tokens"])
        say("families", model=cfg.name, cut=cut or "none",
            d_model=cfg.d_model, layers=cfg.num_layers,
            encoder_layers=cfg.encoder_layers, requests=len(reqs),
            prompt_positions=run["positions"], decode_steps=spec["new"],
            cache_positions=s_max,
            generated_tokens=generated, wall_s=run["wall"],
            generated_tokens_per_s=generated / run["wall"],
            prefill_ms_per_prompt_token=[
                s / p * 1e3 for s, p in zip(run["prefill_s"],
                                            run["positions"])],
            decode_step_ms_median=float(np.median(run["step_s"]) * 1e3),
            weight_bytes=TT.param_bytes(params),
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=main_counts)
        if name == "paligemma-3b":
            batch = reqs[0][0]
            one = TT.init_caches(cfg, 1, reqs[0][1], device=dev)
            prof = profile_steps(torch, lambda: TT.prefill_forward(
                params, batch, cfg, one), 1, ("flash_forward",))
            flash = sum(k["ms_per_step"]
                        for k in prof["watched_kernels"].values())
            say("families", model=cfg.name,
                profile=f"prefill of {reqs[0][1]} positions", **prof,
                flash_share_of_device_time=(
                    flash / prof["device_ms_per_step"]
                    if prof["watched_kernels"] else "not measured"))
            check(len(prof["watched_kernels"]) == 1,
                  f"{name}: the prefill profile names "
                  f"{list(prof['watched_kernels'])}, expected the flash "
                  f"kernel")
            del one

        # -- check (i): the same schedule in ops mode ref ---------------------
        ops.use_kernels("ref")
        pins.replay()
        try:
            ref = family_serve(torch, TT, cfg, params, reqs, spec["new"],
                               s_max, script=run["tokens"])
        finally:
            ops.use_kernels("auto")
            pins.restore()
        check(next(pins.calls, None) is None,
              f"{name}: the ref run routed fewer calls than the kernel run")
        errs = [_logit_errs(a, b, BF16_TOL)
                for a, b in zip(run["last"], ref["last"])]
        leads = [lead / (BF16_TOL * (1 + abs(logit)))
                 for lead, logit in ref["leads"]]
        rms = max(e["rms_over_std"] for e in errs)
        lead = max(leads, default=0.0)
        say("families", model=cfg.name,
            check="(i) the kernel run against ops mode ref on its schedule",
            max_rms_err_over_logit_std=rms, rms_limit=spec["rms"],
            rms_per_request=[e["rms_over_std"] for e in errs],
            max_abs_logit_err=max(e["max_abs"] for e in errs),
            tokens_compared=generated, argmax_differs=len(leads),
            max_lead_over_tolerance=lead, lead_limit=spec["lead"],
            moe_tokens_routed=pins.routed,
            moe_tokens_rerouted_unpinned=int(pins.rerouted))
        check(rms <= spec["rms"], f"{name}: last logits differ from ops mode "
              f"ref by {rms} of their standard deviation (RMS), limit "
              f"{spec['rms']}")
        check(lead <= spec["lead"], f"{name}: the ref run's argmax leads the "
              f"kernel run's token by {lead} of the tolerance, limit "
              f"{spec['lead']}")
        del params, run, ref, pins
        torch.cuda.empty_cache()

        # -- check (ii): float32, 2 layers (and 2 encoder layers) at full
        # width, kernels against ops mode ref on the same requests
        if spec["f32"]:
            cfg32 = family_config(
                configs, name, 2, param_dtype="float32",
                compute_dtype="float32",
                encoder_layers=min(cfg.encoder_layers, 2))
            params = TT.init_params(cfg32, seed + m + 1, device=dev)
            reqs = family_requests(torch, cfg32, spec, seed + 300 + m,
                                   lengths)
            ops.reset_launch_counts()
            kern = family_serve(torch, TT, cfg32, params, reqs, F32_NEW,
                                s_max)
            f32_counts = {k: ops.launch_counts()[k] for k in main_counts}
            ops.use_kernels("ref")
            try:
                ref = family_serve(torch, TT, cfg32, params, reqs, F32_NEW,
                                   s_max, script=kern["tokens"])
            finally:
                ops.use_kernels("auto")
            errs = [_logit_errs(a, b, F32_MODEL_TOL)
                    for a, b in zip(kern["last"], ref["last"])]
            worst = max(e["over_tol"] for e in errs)
            say("families", model=cfg.name,
                check="(ii) float32, 2 layers at full width, kernels "
                      "against ops mode ref",
                max_abs_logit_err=max(e["max_abs"] for e in errs),
                max_err_over_tolerance=worst,
                tolerance=f"{F32_MODEL_TOL} + {F32_MODEL_TOL} x |ref logit|",
                argmax_differs=len(ref["leads"]), launches=f32_counts)
            check(not ref["leads"], f"{name} float32 run: kernels and ref "
                  f"mode give other tokens")
            check(worst <= 1.0, f"{name} float32 run: last logits differ "
                  f"from ops mode ref beyond the tolerance")
            check(min(f32_counts.values()) > 0,
                  f"{name} float32 run launched no kernel of its path")
            del params, kern, ref
            torch.cuda.empty_cache()
        say("families", model=cfg.name,
            model_s=time.perf_counter() - t_model)
    say("families", seconds=time.perf_counter() - t_phase, card=smi)
    return paths


# ---------------------------------------------------------------------------
# phase 6 (training): the flash backward vs its plain version
# ---------------------------------------------------------------------------

#: the flash backward's shapes: (label, B, Hq, Hkv, Sq, Skv, hd, causal,
#: window, softcap, prefix_len)
BWD_SHAPES = (
    # MiniCPM-2B's layer at phase 16's train shape (the timed one)
    ("minicpm", 1, 36, 36, 4096, 4096, 64, True, 0, 0.0, 0),
    # Gemma2-27B's local layer: softcap 50, window 4,096 (past the window)
    ("gemma2", 1, 32, 16, 5000, 5000, 128, True, 4096, 50.0, 0),
    # PaliGemma-3B's prefix-LM: hd 256, 8 q heads over 1, 256 patches
    ("paligemma prefix-LM", 1, 8, 1, PALI_PROMPT, PALI_PROMPT, 256, True, 0,
     0.0, 256),
    # SeamlessM4T-medium's encoder (1,024 frames) and cross attention
    ("seamless encoder", 1, 16, 16, 1024, 1024, 64, False, 0, 0.0, 0),
    ("seamless cross", 1, 16, 16, 4096, 1024, 64, False, 0, 0.0, 0),
    # edges: Sq off the tile (with GQA, window, softcap), a window shorter
    # than a tile, one kv head, and rows that admit no key (Sq > Skv +
    # window - 1: rows from 149 on)
    ("ragged tile", 2, 8, 2, 1000, 1000, 128, True, 300, 30.0, 0),
    ("short window", 1, 4, 2, 333, 333, 64, True, 20, 0.0, 0),
    ("one kv head", 1, 8, 1, 777, 777, 128, True, 0, 0.0, 0),
    ("rows without keys", 1, 4, 2, 300, 100, 64, True, 50, 0.0, 0),
)
#: float32 gradients within this share of each gradient's largest
#: magnitude: the kernel and the plain version each sum up to Sq (dK, dV)
#: or Skv (dQ) float32 products, in another order (at most 8.3e-6 on an
#: H100 at these shapes, PERF.md)
F32_GRAD_REL = 1e-4
#: the forward's row log-sum-exp, absolute (values about 5-15)
LSE_TOL = 1e-4


def _grad_close(torch, got, want, what, steps, f32_rel=F32_GRAD_REL,
                bf16_rel=BF16_TOL):
    """The largest error as a share of ``want``'s largest magnitude, held to
    ``f32_rel`` (float32) or ``bf16_rel`` (bfloat16); a bfloat16 gradient
    is also held to one rounding step of each value plus ``f32_rel`` of the
    largest (its share of that goes to ``steps[what]``).  Returns (share,
    absolute error)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    err = float((g - w).abs().max())
    if got.dtype == torch.bfloat16:
        check(err <= bf16_rel * scale, f"{what}: error {err} exceeds "
              f"{bf16_rel} of the largest gradient {scale}")
        steps[what] = float(((g - w).abs()
                             / (f32_rel * scale + BF16_STEP * w.abs()))
                            .max())
        check(steps[what] <= 1.0, f"{what}: a bfloat16 gradient differs by "
              f"{steps[what]} of a rounding step")
    else:
        check(err <= f32_rel * scale, f"{what}: error {err} exceeds "
              f"{f32_rel} of the largest gradient {scale}")
    return err / scale, err


def flash_backward_bound(pairs, hq, hkv, sq, skv, hd, elem):
    """The backward's least time: 2.5x the forward's products (10 * hd
    flops per admitted pair and head) at the bf16 tensor-core rate, or the
    bytes read once (q, k, v, o, dO, lse) and written once (dq, dk, dv)."""
    t_ops = pairs * hq * 10 * hd / PEAK_BF16_S * 1e3
    nbytes = elem * (3 * hq * sq * hd + 2 * hkv * skv * hd) + 4 * hq * sq \
        + elem * (hq * sq * hd + 2 * hkv * skv * hd)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def phase_flash_backward(torch):
    """The training path's flash backward (three kernels a call) and the
    forward's row log-sum-exp against their plain versions on the card, at
    each of ``BWD_SHAPES`` in bfloat16 and float32, with a second call
    bit-identical (no atomics); at MiniCPM-2B's shape and Gemma2's local
    layer's (bf16) its time beside the plain version's, the bound and the
    backward of SDPA at softcap 0 (:func:`time_flash_backward`); ptxas's
    report of its kernels and the HGMMA instructions of the bf16 ones.
    Returns the ``flash_attention_backward`` record (MiniCPM-2B's numbers
    at its top level)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32
    t_phase = time.perf_counter()

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs, abs_errs, steps, lse_errs, identical = {}, [], {}, {}, {}
    for (label, b, hq, hkv, sq, skv, hd, causal, window, cap,
         prefix) in BWD_SHAPES:
        kw = dict(causal=causal, window=window, softcap=cap,
                  prefix_len=prefix)
        for dtype in (bf16, f32):
            what = f"flash backward {label} {dtype}"
            q, do = randn(b, hq, sq, hd, dtype=dtype), randn(
                b, hq, sq, hd, dtype=dtype)
            k, v = (randn(b, hkv, skv, hd, dtype=dtype) for _ in range(2))
            lse = torch.empty((b, hq, sq), dtype=f32, device=dev)
            o = fa.flash_attention(q, k, v, lse=lse, **kw)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            identical[what] = all(torch.equal(x, y)
                                  for x, y in zip(got, again))
            check(identical[what], f"{what}: two calls differ")
            del again
            lse_want = ref.flash_attention_lse_ref(q, k, **kw)
            finite = torch.isfinite(lse_want)
            check(torch.equal(torch.isinf(lse), ~finite),
                  f"{what}: lse is +inf on other rows than the plain one")
            lse_errs[what] = float((lse[finite] - lse_want[finite]).abs()
                                   .max()) if bool(finite.any()) else 0.0
            check(lse_errs[what] <= LSE_TOL,
                  f"{what}: lse error {lse_errs[what]} exceeds {LSE_TOL}")
            if not bool(finite.all()):   # the dead rows' output
                _close(torch, o, ref.flash_attention_ref(q, k, v, **kw),
                       BF16_TOL if dtype == bf16 else F32_TOL,
                       f"{what} forward", steps)
            want = ref.flash_attention_backward_ref(q, k, v, o, lse, do, **kw)
            shares = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                share, err = _grad_close(torch, g, w, f"{what} {name}", steps)
                shares.append(share)
                abs_errs.append(err)
            errs[what] = max(shares)
            del q, k, v, o, do, lse, got, want, lse_want
            torch.cuda.empty_cache()

    # -- time at MiniCPM-2B's and Gemma2's local layer's shapes, bf16 --------
    timed = {shape[0]: time_flash_backward(torch, randn, shape)
             for shape in BWD_SHAPES[:2]}
    # MiniCPM-2B's (phase 16's) numbers stand for the kernel in the
    # kernels line
    rec = dict(timed[BWD_SHAPES[0][0]])
    rec.update(
        max_abs_err=max(abs_errs), errors=errs, lse_errors=lse_errs,
        bf16_rounding_steps=steps, bit_identical=identical,
        gemma2_local=timed[BWD_SHAPES[1][0]],
        build=wgmma_build_report("flash_attention_backward.cu",
                                 ("flash_bwd_dkdv_wgmma",
                                  "flash_bwd_dq_wgmma")),
        seconds=time.perf_counter() - t_phase)
    say("attention", kernel="flash_attention_backward", **rec)
    return rec


def time_flash_backward(torch, randn, shape):
    """The bf16 flash backward at one of ``BWD_SHAPES`` by events, beside
    the plain version's time, the bound, its device time by kernel and the
    library yardstick: SDPA's backward at softcap 0 on the same inputs
    (``torch.autograd.grad`` of SDPA timed, minus SDPA's forward; the kv
    heads expanded to the q heads beforehand, not timed; a window as
    SDPA's boolean mask).  The port never calls SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    label, b, hq, hkv, sq, skv, hd, causal, window, cap, prefix = shape
    kw = dict(causal=causal, window=window, softcap=cap, prefix_len=prefix)
    q, do = randn(b, hq, sq, hd), randn(b, hq, sq, hd)
    k, v = randn(b, hkv, skv, hd), randn(b, hkv, skv, hd)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    o = fa.flash_attention(q, k, v, lse=lse, **kw)
    ms = cuda_ms(torch, lambda: fa.flash_attention_backward(
        q, k, v, o, lse, do, **kw), 5)
    fwd_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, lse=lse,
                                                       **kw), 5)
    plain = cuda_ms(torch, lambda: ref.flash_attention_backward_ref(
        q, k, v, o, lse, do, **kw), 2)
    dev_ms = device_ms_by_kernel(torch, lambda: fa.flash_attention_backward(
        q, k, v, o, lse, do, **kw), 3)
    sdpa_kw = {"is_causal": causal}
    if window:
        pos = torch.arange(sq, device=q.device)
        sdpa_kw = {"attn_mask": (pos[None, :] <= pos[:, None])
                   & (pos[None, :] > pos[:, None] - window)}
    qg = q.detach().requires_grad_(True)
    kg, vg = (x.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
              for x in (k, v))
    with torch.enable_grad():
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qg, kg, vg, **sdpa_kw), 5)
        sdpa_both = cuda_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw),
            (qg, kg, vg), do), 5)
    pairs = admitted_pairs(sq, skv, causal, window, prefix)
    b_ms, b_by = flash_backward_bound(pairs, hq, hkv, sq, skv, hd, 2)
    fma_ms = pairs * hq * 7 * hd * 2 / PEAK_OPS_S * 1e3
    rec = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=sdpa_both - sdpa_fwd, library_fwd_bwd_ms=sdpa_both,
        library_fwd_ms=sdpa_fwd, forward_with_lse_ms=fwd_ms,
        device_ms_by_kernel=dev_ms, bound_share=b_ms / ms,
        float32_fma_bound_ms=fma_ms, float32_fma_share=fma_ms / ms,
        tflops=pairs * hq * 10 * hd / (ms * 1e-3) / 1e12,
        admitted_pairs=pairs * hq,
        shape=(f"{label}: q, o, dO [{b},{hq},{sq},{hd}] bf16, k/v {hkv} "
               f"heads, causal {causal}, window {window}, softcap {cap}"))
    del q, k, v, o, do, lse, qg, kg, vg
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 16: training MiniCPM-2B on the card
# ---------------------------------------------------------------------------

TRAIN_MODEL = "minicpm-2b"
TRAIN_SEQ = 4096              # the reference's TRAIN_4K
TRAIN_ROWS = 1                # rows a microbatch (the reference's 256 / 64)
TRAIN_STEPS = 8
#: the step's AdamW: WSD, as the reference picks for MiniCPM, at the
#: reference's default peak (3e-4) with a warm-up of one step (PERF.md:
#: 1e-3 and above overshoot at this width, and the stream's batches share
#: little, so 8 steps lower the loss on new batches by about 0.1)
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS,
                 schedule="wsd")
#: check (ii) for training (float32, 2 layers at full width, kernel vs ref
#: mode): the loss, each gradient leaf as a share of its largest
#: magnitude (the two modes sum the attention's products in another
#: order), the parameters after the step (AdamW moves an element whose
#: gradient is near that noise by up to its learning rate, 1e-3 / 2 at
#: step 1, either way; every other element agrees to float32 rounding, so
#: at most TRAIN_F32_LOOSE of the elements may differ by more than 1e-6)
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_GRAD_REL = 1e-4
TRAIN_F32_PARAM_ATOL = 1e-3
TRAIN_F32_LOOSE = 1e-3
#: bf16 at full depth, the first step's loss and gradient norm in kernel
#: mode against ref mode (relative), calibrated as check (i) was (PERF.md,
#: H100): the sound run reads 2.69e-6 and 1.08e-4; with the backward's dQ
#: dropping each q tile's last kv tile (a planted fault) 2.69e-6 (the loss
#: is the forward's) and 2.96e-3.  The gradient norm's limit lies between;
#: the loss's is about 20x its sound reading
TRAIN_BF16_LOSS_REL = 5e-5
TRAIN_BF16_GNORM_REL = 1e-3
#: the fault-tolerance run: 2 layers at full width, bf16
FT_LAYERS, FT_STEPS, FT_CKPT_EVERY, FT_FAIL_AT = 2, 6, 3, 4


#: the port's kernels by class in a profiled step (checked in order)
KERNEL_CLASSES = (("flash_bwd", "flash backward"),
                  ("flash_forward", "flash forward"),
                  ("ssdb::", "scan backward"), ("ssd::", "scan forward"),
                  ("gather_rows_backward", "gather backward"),
                  ("gather_rows", "gather forward"))


def _kernel_class(name):
    for key, label in KERNEL_CLASSES:
        if key in name:
            return label
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                               "matmul", "sm90_")):
        return "products"
    return "other"


def _profiled_step(torch, accumulate, apply, batch):
    """One step under ``torch.profiler``: device ms by kernel class, the
    AdamW update by CUDA events, the wall and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads = accumulate(batch)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        apply(grads)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del grads
    by_class, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + _device_us(e) / 1e3
        if c not in ("products", "other"):
            launches[e.key[:60]] = e.count
    busy = sum(by_class.values())
    return dict(wall_ms=wall * 1e3,
                device_ms=busy if busy else "not measured",
                device_ms_by_class=by_class, kernel_launches=launches,
                adamw_ms_by_events=e0.elapsed_time(e1),
                busy_share=busy / (wall * 1e3) if busy else "not measured")


def _ckpt_root(need_bytes):
    """A temporary directory on the host's tmpfs when it has room for
    ``need_bytes``, else in the default temporary directory."""
    import shutil
    import tempfile

    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free > 2 * need_bytes:
        return tempfile.mkdtemp(prefix="repro_train_", dir=shm), "tmpfs"
    return tempfile.mkdtemp(prefix="repro_train_"), "disk"


def _npy_descr(path):
    with open(path, "rb") as f:
        head = f.read(128).decode("latin1")
    return head.split("'descr': '")[1].split("'")[0]


def _timed_train_run(torch, step, data, cfg, params, opt):
    """``TrainLoop`` over ``TRAIN_STEPS`` steps of ``step`` on ``data``
    (no checkpoint in the run), each step's wall ending in a synchronize and
    its launches counted; every count is reset just before the run and read
    just after it.  Returns (params, opt, {walls, metrics, per_step,
    counts, best, logs})."""
    import shutil
    import tempfile

    from repro_torch.ft.driver import TrainLoop
    from repro_torch.kernels import ops

    walls, metrics, per_step, logs = [], [], [], []

    def timed(p, o, batch):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(p, o, batch)
        m = {key: float(val) for key, val in out[2].items()}
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        after = ops.launch_counts()
        per_step.append({key: after[key] - before[key] for key in after})
        return out

    ckpt_dir = tempfile.mkdtemp(prefix="repro_train_")
    try:
        loop = TrainLoop(train_step=timed, data=data, ckpt_dir=ckpt_dir,
                         cfg=cfg, ckpt_every=TRAIN_STEPS + 1,
                         metric_flush_every=1)
        ops.reset_launch_counts()
        params, opt, best = loop.run(params, opt, TRAIN_STEPS,
                                     log=logs.append)
        counts = ops.launch_counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return params, opt, dict(walls=walls, metrics=metrics, per_step=per_step,
                             counts=counts, best=best, logs=logs)


def phase_train(torch, seed, smi):
    """Phase 16: MiniCPM-2B trained on the card (a), check (ii) for
    training (b) and the fault-tolerant loop (c).  Runs in a child process
    (``--train-child``) under ``torch.use_deterministic_algorithms(True)``
    with ``CUBLAS_WORKSPACE_CONFIG`` set.  Returns (a)'s launch counts."""
    import dataclasses
    import shutil

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft.driver import TrainLoop
    from repro_torch.kernels import ops
    from repro_torch.launch.cells import knobs_for
    from repro_torch.launch.steps import accumulate_grads, build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    torch.use_deterministic_algorithms(True)
    t_phase = time.perf_counter()
    base = configs.get(TRAIN_MODEL)
    knobs = knobs_for(base)
    check(knobs.microbatches == 4 and knobs.remat
          and knobs.grad_accum_dtype == "float32",
          f"knobs_for({TRAIN_MODEL}) gave {knobs}")
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    data = SyntheticLM(vocab=base.padded_vocab, seq_len=TRAIN_SEQ,
                       batch=TRAIN_ROWS, microbatches=knobs.microbatches,
                       seed=seed)
    tokens_per_step = TRAIN_SEQ * TRAIN_ROWS * knobs.microbatches
    L, k = base.num_layers, knobs.microbatches

    # -- (a) the run -----------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(base, seed)
    opt = adamw.init_state(params)
    step = build_train_step(base, knobs, opt_cfg)
    params, opt, run = _timed_train_run(torch, step, data, base, params, opt)
    walls, metrics, per_step = run["walls"], run["metrics"], run["per_step"]
    counts, best, logs = run["counts"], run["best"], run["logs"]
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train losses {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"the loss did not decrease: {losses}")
    for i, c in enumerate(per_step):
        check(c["flash_attention"] == L * k * 2,
              f"step {i}: flash forward {c['flash_attention']}, expected "
              f"{L * k * 2} (layers x microbatches x 2, remat)")
        check(c["flash_attention_backward"] == L * k,
              f"step {i}: flash backward {c['flash_attention_backward']}, "
              f"expected {L * k}")
        check(all(v == 0 for key, v in c.items()
                  if key not in ("flash_attention",
                                 "flash_attention_backward")),
              f"step {i}: another kernel launched: {c}")
    step_ms = float(np.median(walls[1:])) * 1e3
    flops_tok = T.model_flops_per_token(base, params)
    mflops = flops_tok * tokens_per_step / (step_ms * 1e-3)
    # one more step, profiled, its AdamW update timed by events
    run_cfg = dataclasses.replace(base, remat=knobs.remat)
    prof = _profiled_step(
        torch, lambda batch: accumulate_grads(params, batch, run_cfg)[1],
        lambda grads: adamw.apply_updates(params, grads, opt, opt_cfg),
        data.batch_at(TRAIN_STEPS))
    # the cross entropy of one microbatch's logits, forward and backward
    logits = torch.randn((TRAIN_SEQ, base.padded_vocab), device="cuda",
                         requires_grad=True)
    labels = data.batch_at(0)["labels"][0, 0].long()
    from repro_torch.models.layers import cross_entropy_loss
    with torch.enable_grad():
        ce_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            cross_entropy_loss(logits, labels), logits), 3)
    del logits
    say("train", part="a", model=TRAIN_MODEL, layers=L, d_model=base.d_model,
        heads=f"{base.num_heads}/{base.num_kv_heads}", d_ff=base.d_ff,
        vocab=base.padded_vocab, params=T.count_params(params),
        reduced=dict(global_batch=f"256 -> {TRAIN_ROWS * k} rows (one card, "
                     f"a smoke run's time)", depth="all 40 layers kept"),
        seq_len=TRAIN_SEQ, microbatches=k, rows_per_microbatch=TRAIN_ROWS,
        tokens_per_step=tokens_per_step, remat=knobs.remat, opt=TRAIN_OPT,
        losses=losses, grad_norms=[m["grad_norm"] for m in metrics],
        lrs=[m["lr"] for m in metrics], best=best.best,
        step_ms=[w * 1e3 for w in walls], step_ms_median=step_ms,
        tokens_per_s=tokens_per_step / (step_ms * 1e-3),
        model_flops_per_token=flops_tok, model_flops_per_s=mflops,
        mfu_bf16_dense=mflops / PEAK_BF16_S,
        max_memory_allocated=peak, launches=counts,
        launches_per_step=per_step[0], profiled_step=prof,
        cross_entropy_ms_per_microbatch=ce_ms, logs=logs,
        nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
    first = metrics[0]
    del params, opt, step
    torch.cuda.empty_cache()

    # -- (b) check (ii) for training --------------------------------------------
    t_b = time.perf_counter()
    batch = data.batch_at(0)
    f32cfg = dataclasses.replace(base, num_layers=2, param_dtype="float32",
                                 compute_dtype="float32", remat=True)
    got = {}
    for mode in ("kernel", "ref"):
        ops.use_kernels(mode)
        ops.reset_launch_counts()
        p = T.init_params(f32cfg, seed)
        o = adamw.init_state(p)
        loss, grads = accumulate_grads(p, batch, f32cfg)
        adamw.apply_updates(p, grads, o, opt_cfg)
        got[mode] = (float(loss), grads,
                     {n: t.detach() for n, t in p.named_parameters()},
                     ops.launch_counts())
        del p, o
    ops.use_kernels("auto")
    (lk, gk, pk, ck), (lr_, gr, pr, cr) = got["kernel"], got["ref"]
    check(ck["flash_attention_backward"] == 2 * k
          and cr["flash_attention_backward"] == 0,
          f"check (ii): backward launches kernel {ck} ref {cr}")
    loss_rel = abs(lk - lr_) / abs(lr_)
    check(loss_rel <= TRAIN_F32_LOSS_REL,
          f"check (ii): loss {lk} vs ref {lr_} ({loss_rel})")
    grad_rel = {n: float((gk[n] - gr[n]).abs().max()
                         / gr[n].abs().max().clamp_min(1e-30)) for n in gk}
    worst = max(grad_rel, key=grad_rel.get)
    check(grad_rel[worst] <= TRAIN_F32_GRAD_REL,
          f"check (ii): gradient {worst} differs by {grad_rel[worst]} of "
          f"its largest magnitude")
    diffs = torch.cat([(pk[n] - pr[n]).abs().flatten() for n in pk])
    param_max = float(diffs.max())
    loose = float((diffs > 1e-6).float().mean())
    check(param_max <= TRAIN_F32_PARAM_ATOL and loose <= TRAIN_F32_LOOSE,
          f"check (ii): parameters after the step differ by {param_max} "
          f"({loose} of them by more than 1e-6)")
    del got, gk, gr, pk, pr, diffs
    torch.cuda.empty_cache()
    # bf16 at full depth: the first step's loss and gradient norm in ref
    # mode against (a)'s first step (kernel mode), from the same weights
    ops.use_kernels("ref")
    p = T.init_params(base, seed)
    loss_ref, grads = accumulate_grads(p, batch, run_cfg)
    gnorm_ref = float(adamw.global_norm(grads))
    loss_ref = float(loss_ref)
    ops.use_kernels("auto")
    del p, grads
    torch.cuda.empty_cache()
    bf16_loss_rel = abs(first["loss"] - loss_ref) / abs(loss_ref)
    bf16_gnorm_rel = abs(first["grad_norm"] - gnorm_ref) / gnorm_ref
    say("train", part="b", f32_layers=2, f32_loss_rel=loss_rel,
        f32_loss=(lk, lr_), f32_grad_rel_worst=grad_rel[worst],
        f32_grad_rel_worst_leaf=worst, f32_param_max_diff=param_max,
        f32_params_off_by_1e6_share=loose,
        limits=dict(loss_rel=TRAIN_F32_LOSS_REL,
                    grad_rel=TRAIN_F32_GRAD_REL,
                    param_atol=TRAIN_F32_PARAM_ATOL,
                    loose_share=TRAIN_F32_LOOSE,
                    bf16_loss_rel=TRAIN_BF16_LOSS_REL,
                    bf16_gnorm_rel=TRAIN_BF16_GNORM_REL),
        bf16_full_depth=dict(loss_kernel=first["loss"], loss_ref=loss_ref,
                             loss_rel=bf16_loss_rel,
                             grad_norm_kernel=first["grad_norm"],
                             grad_norm_ref=gnorm_ref,
                             grad_norm_rel=bf16_gnorm_rel),
        seconds=time.perf_counter() - t_b)
    check(bf16_loss_rel <= TRAIN_BF16_LOSS_REL,
          f"bf16 first step: loss {first['loss']} vs ref {loss_ref}")
    check(bf16_gnorm_rel <= TRAIN_BF16_GNORM_REL,
          f"bf16 first step: grad norm {first['grad_norm']} vs ref "
          f"{gnorm_ref}")

    # -- (c) fault tolerance ------------------------------------------------------
    t_c = time.perf_counter()
    ftcfg = dataclasses.replace(base, num_layers=FT_LAYERS)
    n_params = T.count_params(T.Transformer(ftcfg, device="meta"))
    ckpt_bytes_expected = n_params * (2 + 4 + 4)
    root, medium = _ckpt_root(4 * ckpt_bytes_expected)
    timings = {"save": [], "restore": []}

    class TimedLoop(TrainLoop):
        def _save(self, *a):
            t0 = time.perf_counter()
            super()._save(*a)
            timings["save"].append(time.perf_counter() - t0)

        def _restore(self, *a):
            t0 = time.perf_counter()
            out = super()._restore(*a)
            torch.cuda.synchronize()
            timings["restore"].append(time.perf_counter() - t0)
            return out

    finals, ft_logs = {}, []
    try:
        for label, fail_at in (("clean", None), ("failed", FT_FAIL_AT)):
            p = T.init_params(ftcfg, seed)
            o = adamw.init_state(p)
            lp = TimedLoop(train_step=build_train_step(ftcfg, knobs, opt_cfg),
                           data=data, ckpt_dir=os.path.join(root, label),
                           cfg=ftcfg, ckpt_every=FT_CKPT_EVERY,
                           metric_flush_every=1, fail_at=fail_at)
            p, o, _ = lp.run(p, o, FT_STEPS, log=ft_logs.append)
            finals[label] = (p, o)
        (pa, oa), (pb, ob) = finals["clean"], finals["failed"]
        same = all(torch.equal(x, y) for x, y in zip(pa.parameters(),
                                                      pb.parameters()))
        same = same and all(torch.equal(oa[key][n], ob[key][n])
                            for key in ("m", "v") for n in oa["m"])
        same = same and int(oa["step"]) == int(ob["step"]) == FT_STEPS
        check(any("injected failure" in line for line in ft_logs)
              and any("restarting" in line for line in ft_logs),
              f"no injected failure: {ft_logs}")
        step_dir = os.path.join(root, "clean", f"step_{FT_CKPT_EVERY}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        bf16 = [name for name, meta in leaves.items()
                if meta["dtype"] == "bfloat16"]
        descrs = {_npy_descr(os.path.join(step_dir, name + ".npy"))
                  for name in bf16}
        ckpt_bytes = _dir_bytes(step_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("train", part="c", layers=FT_LAYERS, steps=FT_STEPS,
        ckpt_every=FT_CKPT_EVERY, fail_at=FT_FAIL_AT,
        bit_identical=same, logs=ft_logs, checkpoint_bytes=ckpt_bytes,
        checkpoint_bytes_expected=ckpt_bytes_expected,
        bf16_leaves=len(bf16), bf16_descrs=sorted(descrs),
        save_s=timings["save"], restore_s=timings["restore"],
        directory=medium, seconds=time.perf_counter() - t_c)
    check(same, "the restarted run's parameters or optimizer state differ "
          "from the uninterrupted run's")
    check(bf16 and descrs == {"<V2"},
          f"bf16 leaves written with descr {descrs}")
    del finals, pa, oa, pb, ob, p, o
    torch.cuda.empty_cache()
    say("train", phase_seconds=time.perf_counter() - t_phase)
    return counts


# ---------------------------------------------------------------------------
# phase 17: training the SSM and MoE families on the card
# ---------------------------------------------------------------------------

#: phase 17's models at full width: Mamba2-780M at its full depth,
#: DeepSeekMoE-16B cut to its dense first layer and 3 MoE layers (4 of 28:
#: about 2.3B parameters, with AdamW's float32 moments and the float32
#: accumulation near 40 GB)
SSM_MOE_TRAIN = {"mamba2-780m": 48, "deepseek-moe-16b": 4}
#: phase 16's microbatches (knobs_for gives 2 for both models)
SSM_MOE_MICROBATCHES = 4
#: (a)'s loss checks: every model's first batch, evaluated again after the 8
#: steps, below its first-step loss (the run fits what it trained on); and
#: where the stream's next batches fall too, the last 3 steps' average
#: below the first.  DeepSeekMoE-16B's cut does not lower the stream's loss
#: in 8 steps at any peak rate tried (1e-4 to 1e-3, in ops mode ref alike:
#: its untied 102,400-row head fits each batch's own window of tokens, which
#: the next batch's window pays for), so it takes the first check only
STREAM_LOSS_FALLS = {"mamba2-780m": True, "deepseek-moe-16b": False}
#: check (ii)'s bf16 limits at (a)'s depth, the first step's loss and
#: gradient norm in kernel mode against ref mode (relative; the MoE routes
#: of the ref run pinned to the kernel run's), calibrated with one fault
#: planted in each new kernel's route (``--plant-fault``; PERF.md, H100):
#: the gradient norm reads 1.54e-5 sound and 3.94e-5 with the scan's fault
#: (Mamba2), 2.69e-5 sound and 1.06e-3 with the gather's (DeepSeekMoE), and
#: each limit lies between; the loss is the forward's, which neither fault
#: moves (2.29e-5 and 7.74e-6 either way), and keeps phase 16's limit.  The
#: float32 part reads the two faults at 2,787x and 635x its limits
SSM_MOE_BF16_LIMITS = {"mamba2-780m": (5e-5, 2.5e-5),
                       "deepseek-moe-16b": (5e-5, 3e-4)}
#: the faults ``--plant-fault`` plants (calibration only): the scan's
#: backward reads zero states entering the chunks (the carry-in's share of
#: dC and of d total dropped); the gather's backward drops each token's
#: last row
FAULT_MODEL = {"scan": "mamba2-780m", "gather": "deepseek-moe-16b"}
#: (c): Jamba-1.5-Large's first 4 layers (Mamba + dense, Mamba + MoE,
#: Mamba + dense, attention + MoE) at a width cut to fit beside the rest
JAMBA_CUT = dict(d_model=1024, num_heads=8, num_kv_heads=1, d_ff=4096)
JAMBA_EXPERT_FF = 4096
JAMBA_SEQ = 2048


def _plant_fault(torch, kind):
    """A fault in a new backward kernel's route, planted at run time for
    the calibration of check (ii) (nothing on disk changes); returns the
    function that removes it."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ssd_scan as ss

    if kind == "scan":
        orig = ss.ssd_scan_backward

        def faulty(x, dt, A, Bm, Cm, dy, dh_final=None, *, states):
            b, h, s, p = x.shape
            hprev_at, decay_at, _ = ss._layout(
                b, h, s, p, Bm.shape[-1], x.dtype, Bm.shape[1] == 1)
            states = states.clone()
            states[hprev_at:decay_at].zero_()
            return orig(x, dt, A, Bm, Cm, dy, dh_final, states=states)

        ss.ssd_scan_backward = faulty
        return lambda: setattr(ss, "ssd_scan_backward", orig)
    orig = md.moe_gather_backward

    def faulty(dout, row_token, num_tokens, *, max_rows_per_token):
        return orig(dout, row_token, num_tokens,
                    max_rows_per_token=max_rows_per_token - 1)

    md.moe_gather_backward = faulty
    return lambda: setattr(md, "moe_gather_backward", orig)


def _ssm_moe_expected(cfg, k):
    """Phase 17's launches per step: the scan per Mamba layer, flash per
    attention layer, the gather per MoE layer, each forward twice (remat)
    and backward once per microbatch."""
    from repro_torch.models.config import FULL, MAMBA, MOE

    specs = cfg.layer_specs()
    out = {}
    for key, n in (("ssd_scan", sum(x.mixer == MAMBA for x in specs)),
                   ("flash_attention", sum(x.mixer == FULL for x in specs)),
                   ("moe_gather", sum(x.mlp == MOE for x in specs))):
        if n:
            out[key] = n * k * 2
            out[key + "_backward"] = n * k
    return out


def _train_step_pair(torch, cfg, batch, seed, init, modes=("kernel", "ref"),
                     opt_cfg=None, fault=None):
    """One step's loss and gradients (and, with ``opt_cfg``, the parameters
    after AdamW) in each ops mode from the same weights; the MoE routes of
    the later modes pinned to the first mode's; ``fault`` planted in the
    first mode only.  Returns {mode: (loss, grads, params, launches)}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import accumulate_grads
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    pins, got = _PinnedRoutes(tmoe), {}
    try:
        for i, mode in enumerate(modes):
            ops.use_kernels(mode)
            ops.reset_launch_counts()
            p = T.init_params(cfg, seed)
            init(p)
            undo = _plant_fault(torch, fault) if fault and i == 0 else None
            (pins.record if i == 0 else pins.replay)()
            try:
                loss, grads = accumulate_grads(p, batch, cfg)
            finally:
                pins.restore()
                if undo:
                    undo()
            params = None
            if opt_cfg is not None:
                adamw.apply_updates(p, grads, adamw.init_state(p), opt_cfg)
                params = {n: t.detach() for n, t in p.named_parameters()}
            got[mode] = (float(loss), grads, params, ops.launch_counts())
            del p
    finally:
        ops.use_kernels("auto")
    return got, pins


def _f32_check(torch, got, what, cfg, enforce=True):
    """Check (ii) in float32: kernel mode against ref mode, the loss, each
    gradient leaf (a Mamba mixer's at the scan's tolerance) and the
    parameters after the step, as phase 16 holds them (with ``enforce``
    False only read: a planted fault's calibration)."""
    def check(cond, msg):
        if enforce and not cond:
            raise SmokeFailure(msg)

    from repro_torch.models.config import MAMBA

    mixers = tuple(f"layers.{i}.mixer." for i, x in
                   enumerate(cfg.layer_specs()) if x.mixer == MAMBA)
    (lk, gk, pk, _), (lr_, gr, pr, _) = got["kernel"], got["ref"]
    loss_rel = abs(lk - lr_) / abs(lr_)
    check(loss_rel <= TRAIN_F32_LOSS_REL,
          f"{what}: loss {lk} vs ref {lr_} ({loss_rel})")
    rel = {n: float((gk[n] - gr[n]).abs().max()
                    / gr[n].abs().max().clamp_min(1e-30)) for n in gk}
    worst = {}
    for n, r in rel.items():
        limit = SSD_F32_TOL if n.startswith(mixers) else TRAIN_F32_GRAD_REL
        check(r <= limit, f"{what}: gradient {n} differs by {r} of its "
              f"largest magnitude (limit {limit})")
        if r > worst.get("rel", -1):
            worst = dict(rel=r, leaf=n, limit=limit)
    diffs = torch.cat([(pk[n] - pr[n]).abs().flatten() for n in pk])
    param_max = float(diffs.max())
    loose = float((diffs > 1e-6).float().mean())
    check(param_max <= TRAIN_F32_PARAM_ATOL and loose <= TRAIN_F32_LOOSE,
          f"{what}: parameters after the step differ by {param_max} "
          f"({loose} of them by more than 1e-6)")
    return dict(loss=(lk, lr_), loss_rel=loss_rel, grad_worst=worst,
                param_max_diff=param_max, params_off_by_1e6_share=loose)


def phase_train_ssm_moe(torch, seed, smi, fault=None):
    """Phase 17: Mamba2-780M (full width and depth) and DeepSeekMoE-16B
    (full width, 4 layers) trained 8 steps each as phase 16 trains
    MiniCPM-2B (a), check (ii) for each (b), and Jamba's first 4 layers at a
    reduced width, one float32 step kernel against ref (c).  With
    ``fault`` (calibration) only (b)'s bf16 comparison of the model the
    fault touches runs, reading (not enforcing) its limits.  Returns
    (a)'s launch counts, summed."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.cells import knobs_for
    from repro_torch.launch.steps import accumulate_grads, build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    total = {}
    for name, layers in SSM_MOE_TRAIN.items():
        if fault and FAULT_MODEL[fault] != name:
            continue
        t_model = time.perf_counter()
        cfg = family_config(configs, name, layers)
        knobs = knobs_for(cfg, microbatches=SSM_MOE_MICROBATCHES)
        k = knobs.microbatches
        data = SyntheticLM(vocab=cfg.padded_vocab, seq_len=TRAIN_SEQ,
                           batch=TRAIN_ROWS, microbatches=k, seed=seed)
        expected = _ssm_moe_expected(cfg, k)
        run_cfg = dataclasses.replace(cfg, remat=knobs.remat)
        tokens_per_step = TRAIN_SEQ * TRAIN_ROWS * k

        def init(p):
            if cfg.ssm is not None:
                trained_dt_bias_(torch, p, seed)

        if not fault:
            # -- (a) the run --------------------------------------------------
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = T.init_params(cfg, seed)
            init(params)
            opt = adamw.init_state(params)
            step = build_train_step(cfg, knobs, opt_cfg)
            params, opt, run = _timed_train_run(torch, step, data, cfg,
                                                params, opt)
            walls, metrics = run["walls"], run["metrics"]
            per_step, counts = run["per_step"], run["counts"]
            peak = torch.cuda.max_memory_allocated()
            for key, v in counts.items():
                total[key] = total.get(key, 0) + v
            losses = [m["loss"] for m in metrics]
            check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
                  f"{name}: train losses {losses}")
            first = data.batch_at(0)
            with torch.no_grad():
                refit = float(sum(T.train_forward(
                    params, {key: v[i] for key, v in first.items()},
                    run_cfg)[0] for i in range(k))) / k
            check(refit < losses[0], f"{name}: the first batch's loss "
                  f"{losses[0]} did not fall after training ({refit})")
            check(not STREAM_LOSS_FALLS[name]
                  or np.mean(losses[-3:]) < losses[0],
                  f"{name}: the loss did not decrease: {losses}")
            for i, c in enumerate(per_step):
                got_c = {key: v for key, v in c.items() if v}
                check(got_c == expected, f"{name} step {i}: launches "
                      f"{got_c}, expected {expected}")
            step_ms = float(np.median(walls[1:])) * 1e3
            flops_tok = T.model_flops_per_token(cfg, params)
            mflops = flops_tok * tokens_per_step / (step_ms * 1e-3)
            prof = _profiled_step(
                torch, lambda batch: accumulate_grads(params, batch,
                                                      run_cfg)[1],
                lambda grads: adamw.apply_updates(params, grads, opt,
                                                  opt_cfg),
                data.batch_at(TRAIN_STEPS))
            for cls in ("scan backward", "gather backward"):
                kind = "ssd_scan_backward" if "scan" in cls \
                    else "moe_gather_backward"
                if kind in expected:
                    check(prof["device_ms_by_class"].get(cls),
                          f"{name}: the profiled step names no {cls}")
            cut = ("all 48 layers kept" if name == "mamba2-780m" else
                   f"{layers} of {configs.get(name).num_layers} layers: the "
                   f"dense first layer and {layers - 1} MoE layers (one card "
                   f"with AdamW's moments)")
            say("train-ssm-moe", part="a", model=name, layers=layers,
                d_model=cfg.d_model, params=T.count_params(params),
                reduced=dict(depth=cut, global_batch=f"{TRAIN_ROWS * k} rows "
                             f"of {TRAIN_SEQ} (one card, a smoke run's time)",
                             microbatches=f"knobs_for gives "
                             f"{knobs_for(cfg).microbatches}; phase 16's "
                             f"{k} taken"),
                trained_dt_bias=cfg.ssm is not None, seq_len=TRAIN_SEQ,
                microbatches=k, tokens_per_step=tokens_per_step,
                remat=knobs.remat, opt=TRAIN_OPT, losses=losses,
                first_batch_loss_after=refit,
                stream_loss_checked=STREAM_LOSS_FALLS[name],
                grad_norms=[m["grad_norm"] for m in metrics],
                step_ms=[w * 1e3 for w in walls], step_ms_median=step_ms,
                tokens_per_s=tokens_per_step / (step_ms * 1e-3),
                model_flops_per_token=flops_tok, model_flops_per_s=mflops,
                mfu_bf16_dense=mflops / PEAK_BF16_S,
                max_memory_allocated=peak, launches=counts,
                launches_per_step=per_step[0], profiled_step=prof,
                nvidia_smi=smi, seconds=time.perf_counter() - t_model)
            del params, opt, step
            torch.cuda.empty_cache()

        # -- (b) check (ii) ---------------------------------------------------
        t_b = time.perf_counter()
        batch = data.batch_at(0)
        f32cfg = dataclasses.replace(
            family_config(configs, name, 2), param_dtype="float32",
            compute_dtype="float32", remat=True)
        got, _ = _train_step_pair(torch, f32cfg, batch, seed, init,
                                  opt_cfg=opt_cfg, fault=fault)
        launched = {key: v for key, v in got["kernel"][3].items() if v}
        check(launched == _ssm_moe_expected(f32cfg, k)
              and not any(got["ref"][3].values()),
              f"{name} check (ii): launches kernel {launched} ref "
              f"{got['ref'][3]}")
        f32 = _f32_check(torch, got, f"{name} check (ii)", f32cfg,
                         enforce=not fault)
        del got
        torch.cuda.empty_cache()
        got, pins = _train_step_pair(torch, run_cfg, batch, seed, init,
                                     fault=fault)
        (lk, gk, _, _), (lr_, gr, _, _) = got["kernel"], got["ref"]
        gnorm_k = float(adamw.global_norm(gk))
        gnorm_r = float(adamw.global_norm(gr))
        del got, gk, gr
        torch.cuda.empty_cache()
        loss_lim, gnorm_lim = SSM_MOE_BF16_LIMITS[name]
        bf16 = dict(loss_kernel=lk, loss_ref=lr_,
                    loss_rel=abs(lk - lr_) / abs(lr_),
                    grad_norm_kernel=gnorm_k, grad_norm_ref=gnorm_r,
                    grad_norm_rel=abs(gnorm_k - gnorm_r) / gnorm_r,
                    rerouted_tokens=int(pins.rerouted),
                    routed_tokens=pins.routed,
                    limits=dict(loss_rel=loss_lim, grad_norm_rel=gnorm_lim))
        say("train-ssm-moe", part="b", model=name, fault=fault,
            f32_layers=2, f32=f32, bf16_depth=layers,
            bf16=bf16, seconds=time.perf_counter() - t_b)
        if not fault:
            check(bf16["loss_rel"] <= loss_lim,
                  f"{name} bf16 first step: loss {lk} vs ref {lr_}")
            check(bf16["grad_norm_rel"] <= gnorm_lim,
                  f"{name} bf16 first step: grad norm {gnorm_k} vs ref "
                  f"{gnorm_r}")

    if fault:
        return total
    # -- (c) Jamba's first 4 layers: the scan, the gather and flash -----------
    t_c = time.perf_counter()
    name = "jamba-1.5-large-398b"
    base = configs.get(name)
    jcfg = family_config(
        configs, name, 4, param_dtype="float32", compute_dtype="float32",
        remat=True, moe=dataclasses.replace(base.moe,
                                            d_ff_expert=JAMBA_EXPERT_FF),
        **JAMBA_CUT)
    jdata = SyntheticLM(vocab=jcfg.padded_vocab, seq_len=JAMBA_SEQ, batch=1,
                        microbatches=2, seed=seed)

    def jinit(p):
        trained_dt_bias_(torch, p, seed)

    got, pins = _train_step_pair(torch, jcfg, jdata.batch_at(0), seed, jinit,
                                 opt_cfg=opt_cfg)
    want = _ssm_moe_expected(jcfg, 2)
    launched = {key: v for key, v in got["kernel"][3].items() if v}
    check(launched == want, f"jamba (c): launches {launched}, expected {want}")
    jamba = _f32_check(torch, got, "jamba (c)", jcfg)
    del got
    torch.cuda.empty_cache()
    say("train-ssm-moe", part="c", model=name,
        cut=dict(layers="the first 4 of its unit: Mamba + dense, Mamba + "
                 "MoE, Mamba + dense, attention + MoE", width=JAMBA_CUT,
                 d_ff_expert=JAMBA_EXPERT_FF, seq_len=JAMBA_SEQ,
                 microbatches=2, dtype="float32"),
        launches=launched, rerouted_tokens=int(pins.rerouted), **jamba,
        seconds=time.perf_counter() - t_c)
    say("train-ssm-moe", phase_seconds=time.perf_counter() - t_phase)
    return total


def phase_train_child(torch, seed, smi, fault=None):
    """Phases 16 and 17 in a child process with a deterministic cuBLAS
    workspace (set before the child's first cuBLAS call); the child prints
    its lines and, last, its main paths' launch counts, summed, which are
    returned.  With ``fault`` only phase 17's calibration part runs."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--train-child",
         "--seed", str(seed)] + (["--plant-fault", fault] if fault else []),
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    if proc.returncode or not lines:
        print("\n".join(lines), flush=True)
        sys.stderr.write(proc.stderr[-20000:])
        raise SmokeFailure(f"phases 16-17 (train) failed with code "
                           f"{proc.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    return json.loads(lines[-1])["launches"]


def train_child(torch, seed, smi, fault):
    """The child's work: phase 16 then phase 17 under deterministic
    algorithms (with ``fault``, phase 17's calibration part alone); returns
    the main paths' launch counts, summed."""
    torch.use_deterministic_algorithms(True)
    if fault:
        return phase_train_ssm_moe(torch, seed, smi, fault)
    counts = phase_train(torch, seed, smi)
    for key, v in phase_train_ssm_moe(torch, seed, smi).items():
        counts[key] = counts.get(key, 0) + v
    return counts


def kernels_line(records, path_counts):
    """The ``kernels`` object: each kernel's measured numbers and its
    launches summed over the main paths' runs (``path_counts``: one count
    dict per run, each read just after the run it counts)."""
    kernels = []
    for k, (source, replaces) in KERNEL_META.items():
        rec = records[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c.get(k, 0) for c in path_counts),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    return {"kernels": kernels}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--host-only", action="store_true",
                        help="build, then only time each kernel wrapper's "
                             "host path (phase 3's host part) and stop")
    parser.add_argument("--dist-only", action="store_true",
                        help="build, then run only the keyed main path "
                             "(phase 4) and the multi-process plane "
                             "(phase 14) and stop")
    parser.add_argument("--families-only", action="store_true",
                        help="build, then run only phase 15 (the other "
                             "architectures at full width) and stop")
    parser.add_argument("--train-only", action="store_true",
                        help="build, then run only the training "
                             "kernels' checks (the flash backward's part of "
                             "phase 6, the scan's and the gather's backward "
                             "in phase 8) and phases 16-17 (training "
                             "MiniCPM-2B, Mamba2-780M, DeepSeekMoE-16B, "
                             "Jamba's cut) and stop")
    parser.add_argument("--train-child", action="store_true",
                        help=argparse.SUPPRESS)  # phases 16-17's process
    parser.add_argument("--plant-fault", choices=sorted(FAULT_MODEL),
                        help="calibration only: build, then run phase 17's "
                             "bf16 check (ii) for the model the fault "
                             "touches, with the fault planted in the new "
                             "backward kernel's route, and stop")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.keyed import keyed_stream
    except ImportError as e:
        print(f"FAIL: the repro_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = nvidia_smi_line()
        name = torch.cuda.get_device_name(0)
        say("device", nvidia_smi=smi, torch_name=name,
            count=torch.cuda.device_count(), torch=torch.__version__,
            cuda=torch.version.cuda)

        t0 = time.perf_counter()
        _build.library()
        report = "".join(_build.BUILD_INFO["ptxas"].values())
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "Performance Loss" in ln]
        say("build", seconds=time.perf_counter() - t0,
            compiled=_build.BUILD_INFO["compiled"],
            compiler_cpu_seconds=_build.BUILD_INFO["compiler_cpu_seconds"],
            ptxas=ptxas)

        if args.host_only:
            phase_host(torch)
            print(smi)
            return 0
        if args.families_only:
            phase_families(torch, args.seed, smi)
            print(smi)
            return 0
        if args.train_child:
            counts = train_child(torch, args.seed, smi, args.plant_fault)
            print(json.dumps({"launches": counts}))
            return 0
        if args.plant_fault:
            phase_train_child(torch, args.seed, smi, args.plant_fault)
            print(smi)
            return 0
        if args.train_only:
            phase_flash_backward(torch)
            phase_ssm_moe_backward(torch)
            phase_train_child(torch, args.seed, smi)
            print(smi)
            return 0
        items = make_stream(args.seed, keyed_stream)
        if args.dist_only:
            phase_dist(torch, items, phase_main(torch, items), smi)
            print(smi)
            return 0
        records = phase_kernels(torch, items)
        phase_host(torch)
        main = phase_main(torch, items)
        paths = [main["fused"], main["loop"]]
        phase_small(torch)
        records.update(phase_attention(torch))
        records["flash_attention_backward"] = phase_flash_backward(torch)
        paths.append(phase_serve(torch, args.seed, "gemma2-serve",
                                 SERVES["gemma2-serve"]))
        records.update(phase_ssm_moe(torch))
        records.update(phase_ssm_moe_backward(torch))
        for label in ("mamba2-serve", "moe-serve"):
            paths.append(phase_serve(torch, args.seed, label, SERVES[label]))
        paths += phase_supervised(torch, items, main, smi)
        paths += phase_dist(torch, items, main, smi)
        del items, main
        paths += phase_serving_runtime(torch, args.seed, smi)
        phase_patterns(torch, args.seed, smi)
        paths += phase_families(torch, args.seed, smi)
        paths.append(phase_train_child(torch, args.seed, smi))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        ops.use_kernels("auto")

    print(json.dumps(kernels_line(records, paths)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
