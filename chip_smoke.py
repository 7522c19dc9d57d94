#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also trace four decode steps of each
                                      # model four ways (per-call and
                                      # prequantized weights, eager and
                                      # graphed; and of llama under w20)
    python3 chip_smoke.py --profile-path llama3.2-1b:w24:forced
                                      # only trace one path (here under its
                                      # forcing table)
    python3 chip_smoke.py --chunk-study
                                      # only report phase 5r and compare
                                      # chunked with single-shot prefill
                                      # (5c's gate, each run twice)

Phases, each fatal on failure (non-zero exit, no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per build unit of every source, started together);
  3. hold each kernel to its plain PyTorch version on the card with
     ``torch.equal``, at the shapes the serve paths give it: the dense
     fused GEMM in mode mm1 (csrc/fused_mm1.cu: every w=8 projection of
     llama3.2-1b and granite-moe-3b-a800m, llama's wi and wd also at
     M=256 and 2048, and an unaligned decode shape, 4x2050x8200, whose
     rows take the byte-load path), kmm2 (lm_head and the MoE router at
     w=12), and
     mm2 and kmm4 (every one of those GEMMs at w=16, and at w=20 and
     w=24), and the grouped ragged fused GEMM (granite's 40 expert GEMMs in
     every mode, at the decode and prefill capacities, with router-like
     live counts and an edge case of zero-count experts and full
     segments), raw and dequantized outputs; then kmm4 at every width
     17-26, with +-2^25 operands at w=26 and, at w=24, rows whose int32
     sums wrap as the reference's do; the split modes' kernel
     (csrc/fused_split.cu) at every width, kmm2 9-14, mm2 15-16 and kmm4
     at 9, 12, 16, 17, 20, 22, 23, 24 and 26, at a split-K decode shape,
     M=64, the router, the unaligned shape and a split ending inside the
     padded K (kmm4 also at a K that is not a multiple of 4), raw, bf16 and
     int32-ring; and kmm4 timed at w=22 and w=23, where its bound moves
     from 9 to 12 products, from decode to a compute-bound prefill (M = 4
     to 2048);
  4. small-input agreement: the smoke-size models in float32 on the card
     against the same models on the CPU (the kernels' plain versions,
     which the test suite holds to the JAX reference);
  5. serve full-width llama3.2-1b and granite-moe-3b-a800m under the mixed
     policy through ``repro_torch.serve.Engine`` (random weights from a
     seeded generator; 4 slots, max_seq 256, 6 requests of 8-64 prompt
     tokens, 16 new tokens, one at temperature 0.8), with the launch
     counts set to 0 just before each run and read just after: every
     quantized GEMM must have gone through the kernels, exactly as many
     launches as the model has quantized GEMMs per prefill and per decode
     step; a second identical run must repeat every greedy stream.  Then
     every GEMM at one width: llama under w16 (mm2; the same 6 requests,
     twice, greedy streams repeating) and w20 (kmm4), and granite under w12
     (kmm2), w16 (mm2), w20 and w24 (kmm4), 2 requests of 4 new tokens
     each, every dense and grouped GEMM of a step launching that width's
     mode and no other;
  6. time each kernel against its bound, its plain version and the
     library call that computes the same product where there is one (CUDA
     events, warm-up excluded; every fused and staged kernel in device
     time, its calls queued behind a device sleep, and ``torch._int_mm``
     beside mm1, on A zero-padded to 32 rows where M <= 16, which it
     refuses), and each model's prefill and decode tokens/s, step ms and
     peak device memory.

The RWKV path (rwkv6-3b: models/rwkv.py, the WKV recurrence kernel
kernels/wkv_gemm.py on csrc/wkv.cu) adds, within the phases above:

  3w. the WKV kernel against its plain version (``allclose``, rtol = atol =
      WKV_TOL, on y and the final state): decode on 1, 2 and 4 lanes x 40
      heads (S = 1, D = 64) from a nonzero state, prefill of 1 x 40 heads at
      every prompt bucket 8-64, ``wkv_apply``'s own (BH, S, D) layout at
      (160, 256, 64) with chunk 128 and 32, an S that no chunk divides, and
      the smoke model's D = 16, D = 8 and 4, and streams whose rows are not
      16-byte aligned; timed against its bound and plain version at
      decode on 4 lanes, prefill S = 64 and (160, 256, 64); and the fused
      kernel (torch.equal) at rwkv's GEMM shapes: mm1 at its time-mix
      (2560 x 2560) and channel-mix (2560 x 8960, 8960 x 2560) projections
      and kmm2 at its untied lm_head (2560 x 65536), M 1, 4 and 64;
  4.  the rwkv smoke model in float32, card against CPU;
  5.  full-width rwkv6-3b under mixed (the same 6 requests, twice): per
      prefill and per decode step exactly 224 fused mm1 + 1 fused kmm2 + 32
      WKV launches, and no other kernel; greedy streams repeat.

Serving in its steady state (quant/prequant.py, serve/executor.py's decode
graphs, serve/engine.py's warm(), chunked prefill and prefix cache) adds,
within phase 5:

  5g. every serve engine is warmed first (``Engine.warm()``: one CUDA graph
      per decode width, every prefill width run once); in each counted run
      the wrappers' counters (which a graph replay does not reach) hold
      exactly prefills x the per-call launches, the graph replays equal
      the decode steps, and every width's graph captured exactly the
      per-call launches, and every graph holds exactly those integer-GEMM
      and WKV kernels as nodes (read from the driver: what each replay
      launches; under the forcing and tuned tables too); on each mixed
      path one decode step runs eagerly and through the graph from the
      same pool contents (logits and every pool tensor torch.equal);
  5p. llama, granite and rwkv under mixed and llama under w16 served again
      on prequantized weights (``prequantize``; the fp32 leaves that became
      records freed and the peak memory reset first), graphed: tokens and
      full-width prefill logits torch.equal to the per-call run, the same
      exact launch and graph-node gates, one step graphed against eager,
      under mixed a profiler witness (the integer-GEMM, WKV and
      row-invariant kernels the profiler sees in each of two replayed
      decode steps equal what the graph captured; not under --profile,
      whose earlier long sessions make the profiler lose records) and
      then four decode steps profiled (device busy ms, kernels a step),
      and every record's codes reaching the kernel as stored (no
      weight-sized cast or copy);
  5c. llama and rwkv on the mixed records with chunked prefill (chunks of
      32) and prefix sharing (2 slots, four prompts sharing an 80-token
      head): at least 2 prefix hits, greedy tokens equal to the chunked
      engine without prefix sharing (a hit restores what a cold chunked
      prefill computes), exact launch gates over the prefill chunks and
      decode steps; and chunked prefill against a single-shot prefill, on
      that prompt set (seed 5) and a second (seed 6), 8 greedy tokens a
      stream: every token and every sampled logits row torch.equal, as
      the reference's ``start=`` contract makes them;
  5r. the row-invariant kernels (csrc/rowinv.cu, kernels/rowinv.py), which
      every norm and rwkv's decay LoRA products run on so that 5c holds:
      rwkv's LoRA products (2560 x 64, 64 x 2560, fp32) and the norms
      (LayerNorm over 2560 on fp32 and bf16 rows, RMSNorm over 2048 on
      bf16 and over 6144 on fp32 rows) at M 1-256, every row torch.equal
      to the same row of M = 256, and held to their plain versions
      (allclose rtol 1e-5, atol 1e-6 on fp32 rows, one bf16 ulp on bf16
      rows); ATen's own change with M reported beside; timed at M = 4 and
      64 next to the ATen call each replaces.  Every serve path's exact
      launch gates count their launches too: a norm launch a norm call
      site, two LoRA products a rwkv layer.

The dense configurations beside llama add:

  5n. gemma-2b, stablelm-12b and nemotron-4-15b under mixed at full width
      and depth (2 requests of 8 and 64 prompt tokens, 4 new tokens,
      twice, greedy streams repeating; 126 / 280 / 192 fused mm1 + 1 fused
      kmm2, plus 37 / 81 / 65 norm launches, a prefill and a decode step,
      through the wrappers and in every decode graph's kernel nodes):
      gemma per call, eager and graphed, then on records from the
      leaf-wise init (``lm.init_params(..., prequant=)``), which must
      equal ``prequantize(init_params)`` leaf for leaf and give the
      per-call tokens and full-width prefill logits; stablelm and
      nemotron only on leaf-wise records (their fp32 trees never sit on
      the card whole), the init's peak memory at most the records plus
      16 GB; each records path profiled (device busy ms, kernels a step),
      its decode step beside its bound (record bytes read a step over the
      card's memory rate).

With ``--profile`` each model's mixed path also runs eagerly, per call and
on records (tokens equal to the graphed run), and is traced four ways:
per-call and prequantized weights, eager and graphed.

The staged path (kernels/ops.py's run_plan and its kernels: mm1_gemm,
kmm2_gemm_planes and mm2_gemm_planes on csrc/staged_pipe.cu) and the tuner
add, within the phases above:

  3a. each staged kernel torch.equal to its plain version on int8 planes
      at every dense serve (K, N) at M 1, 4, 16, 64, at granite's expert
      (K, N) at M 8, 16, 32, at 5x300x130 and at M=2048, both combines
      (mm1 at w=8, kmm2 at 12 and 14, mm2 at 15 and 16), every kernel with
      B row-major and K-major and split-K as planned, forced off and
      forced on, timed in both layouts beside torch._int_mm (mm1); a sweep
      of the staged_pipe.cu kernels at M 1, 3, 16, 17, 64, 65, 2048, K not
      a multiple of 16 and odd N, kmm2 at every split point 1-7 on int8
      and int16 planes, mm2 at every split point 1-8; the int16 planes
      of the depth-2 staged path (kmm2's s8 route at w 17, 20, 22, its
      split route at 23, 24, 26) through run_plan against its mirror, at
      every llama projection at M 1-64 for w 20 and 24, with +-2^25 codes
      and wrapping rows;
  3b. run_plan on the card: staged == fused == mirror in each numerics
      class, staged and fused timed side by side at llama's lm_head and
      wi;
  3c. the tuner (python -m repro_torch.tune) over llama's five (K, N) at
      M 4 and 64, w 8, 12, 16 and 20, writing its table (TUNED_TABLE):
      each candidate timed in device time behind a sleep lead, one
      candidate a distinct launch, only what select_plan serves as it is;
      no candidate rejected, every winner in its served class, re-timed
      here within 10 % of the tuner's time and at most 3 % slower than its
      default;
  3e. staged KMM2 (both B layouts) against staged MM2 at w=12, M = 4 to
      2048, and the fused pair (csrc/fused_split.cu) on the same codes;
  5.  serve paths under a table, each held to the same path without one
      (tokens and full-width prefill logits torch.equal): llama mixed
      under the tuned table, and forced onto the staged kernels — llama
      mixed (112 mm1_gemm + 1 kmm2_gemm_planes a step), w16 (113
      mm2_gemm_planes), w24 (339 split kmm2_gemm_planes), granite mixed
      (128 + 3,840 per-expert mm1_gemm + 33 kmm2_gemm_planes) — with
      exact launch counts and no fused launch; and on llama's mixed
      records the tuned table against none in device time: the width-4
      decode graph replayed between CUDA events, six runs of each in
      turns, one step's logits equal under both.

The line before the last is a JSON object with one entry per kernel (the
five TPU kernels' counterparts, and the port-only rowinv_matmul and
rowinv_norm); the last line is ``{"ok": true, "device": {...}}``.  The
details go to
``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

# (K, N) of llama3.2-1b's w=8 projections: wq/wo, wk/wv, wi/wg, mlp.wo
MM1_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
KMM2_KN = [(2048, 128512)]                          # lm_head (tied embed.T)
# granite-moe-3b-a800m: attention at w=8 (wq/wo, wk/wv); router and the
# tied lm_head (vocab 49155 padded to 49664) at w=12
GRANITE_MM1_KN = [(1536, 1536), (1536, 512)]
GRANITE_KMM2_KN = [(1536, 40), (1536, 49664)]
ROWS = [1, 4, 16, 64]                               # decode widths, prefill
RAGGED = (5, 300, 130)
# Under w16 (mm2), w20 and w24 (kmm4) every one of those GEMMs runs at that
# width.  The kmm4 width sweep covers its analytic window and the
# +-2^(w-1) edge.
WIDE_MODES = [("mm2", 16), ("kmm4", 20), ("kmm4", 24)]
KMM4_WIDTHS = [17, 20, 22, 23, 24, 25, 26]
SWEEP_SHAPES = [(4, 2048, 8192), (64, 1536, 512), RAGGED]
# kmm4 at w=22 and w=23 (one digit layout; its bound counts 9 products
# through w=22 and 12 from w=23) at llama's wi/wg (K, N) from decode to a
# compute-bound prefill.
ROUTE_ROWS = [4, 64, 512, 2048]
ROUTE_KN = (2048, 8192)

# granite's grouped expert GEMMs: (K, N) of wi/wg and of wo, 40 experts,
# top-8 routing
GROUPED_KN = [(1536, 512), (512, 1536)]
N_EXPERTS, TOP_K = 40, 8
# The rows of one expert's GEMM: the capacities of GROUPED_CASES.
EXPERT_ROWS = [8, 16, 32]
# (label, C, seg, segments, tokens per segment): decode at widths 1, 2, 4
# (capacity 8 per lane, S = 1), a prefill bucket of 8-32 tokens (capacity
# 8) and of 64 tokens (capacity 16, overflow drops), and an edge case
# (tokens 0: zero-count experts, full segments, counts seg - 1 and 1).
GROUPED_CASES = [("decode W=1", 8, 8, 1, 1), ("decode W=2", 16, 8, 2, 1),
                 ("decode W=4", 32, 8, 4, 1), ("prefill S=32", 8, 8, 1, 32),
                 ("prefill S=64", 16, 16, 1, 64), ("edge", 32, 8, 4, 0)]

# rwkv6-3b (32 layers, d_model 2560, d_ff 8960, untied lm_head over vocab
# 65536): mm1 at its w=8 projections — 5 time-mix (wr, wk, wv, wg, wo)
# and 2 channel-mix (wi, wo) — and kmm2 at the w=12 lm_head; its first K
# that is not a power of two (8960: 35 blocks of 256) and first untied
# lm_head.  The fused kernel is held to its plain version there at M 1, 4
# and 64.
RWKV_MM1_KN = [(2560, 2560), (2560, 8960), (8960, 2560)]
RWKV_KMM2_KN = [(2560, 65536)]
RWKV_ROWS = [1, 4, 64]
# The mm1 kernel (csrc/fused_mm1.cu) also at a compute-bound prefill
# (llama's wi and wd at M 256 and 2048) and at an unaligned decode shape:
# K and N not multiples of 16, so its rows take the byte-load path, and a
# split K whose last split is ragged.
MM1_EXTRA = [(m, k, n) for k, n in ((2048, 8192), (8192, 2048))
             for m in (256, 2048)] + [(4, 2050, 8200)]
MM1_SOURCE = "src/repro_torch/kernels/csrc/fused_mm1.cu"
# The split modes' kernel (csrc/fused_split.cu): every width at one split-K
# decode shape (llama's wq, M=4: K split 7-10 ways), at prefill M=64 (wi),
# at granite's router (N=40, one tile, split), at the unaligned 5x300x130
# (element loads) and at a K whose padded kp ends a split past K
# (3x1560x100, block_k 256: kp 1792; kmm2's splits end at 1568), raw, bf16
# and combine_int32; kmm4 (int32 carrier) also at a K that is not a
# multiple of 4 (4x2050x8200: A's rows take element loads); fused kmm2
# against fused mm2 at w=12 beside the staged pair (phase 3e).
SPLIT_SOURCE = "src/repro_torch/kernels/csrc/fused_split.cu"
SPLIT_WIDTHS = ([("kmm2", w) for w in range(9, 15)]
                + [("mm2", 15), ("mm2", 16)]
                + [("kmm4", w) for w in (9, 12, 16, 17, 20, 22, 23, 24, 26)])
SPLIT_SHAPES = [(4, 2048, 2048), (64, 2048, 8192), (4, 1536, 40), RAGGED,
                (3, 1560, 100)]
KMM4_SPLIT_EXTRA = [(4, 2050, 8200)]
# The WKV kernel (row 5): tolerance against its plain version (fp32 sums
# over i in another order), the full-width heads, and its check cases:
# (label, entry, B or BH, S, H, D, chunk, nonzero initial state, timed);
# the "unaligned" case's streams are views one float into a wider tensor
# (rows not 16-byte aligned: the kernel's 4-byte staging copies).
WKV_TOL = 1e-5
WKV_HEADS, WKV_D = 40, 64
WKV_CASES = (
    [(f"decode W={w}", "stateful", w, 1, WKV_HEADS, WKV_D, None, True,
      w == 4) for w in (1, 2, 4)]
    + [(f"prefill S={s}", "stateful", 1, s, WKV_HEADS, WKV_D, None, False,
        s == 64) for s in (8, 16, 32, 64)]
    + [("apply", "apply", 160, 256, 1, WKV_D, 128, False, True),
       ("apply", "apply", 160, 256, 1, WKV_D, 32, False, False),
       ("apply S=37", "apply", 160, 37, 1, WKV_D, 32, False, False),
       ("smoke D=16", "stateful", 2, 16, 4, 16, None, True, False),
       ("smoke decode D=16", "stateful", 2, 1, 4, 16, None, True, False),
       ("D=8", "stateful", 3, 9, 5, 8, None, True, False),
       ("decode D=4", "stateful", 3, 1, 5, 4, None, True, False),
       ("unaligned S=20", "stateful", 2, 20, 3, WKV_D, None, True, False)])
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv.cu"
# Published fp32 peak of one H100 SXM outside the tensor cores.
PEAK_FP32_OPS_PER_S = 67e12

# The serve paths: (arch, policy, requests, new tokens, identical runs,
# launches per prefill and per decode step: dense, grouped).  llama's 16
# layers have 7 w=8 projections each and w=12 lm_head; granite's 32 have
# 4 attention projections, the w=12 router, and 3 expert GEMMs (wi, wg,
# wo) as grouped launches; under one width every GEMM runs in that width's
# mode (w12 kmm2, w16 mm2, w20 and w24 kmm4).
PATHS = [
    ("llama3.2-1b", "mixed", 6, 16, 2, {"mm1": 112, "kmm2": 1}, {}),
    ("llama3.2-1b", "w16", 6, 16, 2, {"mm2": 113}, {}),
    ("llama3.2-1b", "w20", 2, 4, 1, {"kmm4": 113}, {}),
    ("granite-moe-3b-a800m", "mixed", 6, 16, 2, {"mm1": 128, "kmm2": 33},
     {"mm1": 96}),
    ("granite-moe-3b-a800m", "w12", 2, 4, 1, {"kmm2": 161}, {"kmm2": 96}),
    ("granite-moe-3b-a800m", "w16", 2, 4, 1, {"mm2": 161}, {"mm2": 96}),
    ("granite-moe-3b-a800m", "w20", 2, 4, 1, {"kmm4": 161}, {"kmm4": 96}),
    ("granite-moe-3b-a800m", "w24", 2, 4, 1, {"kmm4": 161}, {"kmm4": 96}),
    ("rwkv6-3b", "mixed", 6, 16, 2, {"mm1": 224, "kmm2": 1}, {}),
]
# Every full-width engine's prompt buckets (the prompts are 8-64 tokens),
# so ``Engine.warm()`` runs four prefill widths.
SERVE_BUCKETS = (8, 16, 32, 64)
# The paths served again on prequantized weights (quant/prequant.py),
# eager and graphed, held to the per-call run of the same path (tokens and
# full-width prefill logits torch.equal).
PREQUANT_PATHS = [("llama3.2-1b", "mixed"), ("llama3.2-1b", "w16"),
                  ("granite-moe-3b-a800m", "mixed"), ("rwkv6-3b", "mixed")]
# Chunked prefill with prefix sharing at full width, on the mixed records:
# the chunk, the prompts' shared head and their tails (tokens).
CHUNKED_PATHS = [("llama3.2-1b", "mixed"), ("rwkv6-3b", "mixed")]
CHUNK, SHARED_HEAD, TAILS = 32, 80, (10, 25, 17, 40)
# Phase 5r, the row-invariant kernels (csrc/rowinv.cu): the rows each is
# run at (every one held to the same rows of the largest), the rows timed
# (rwkv's decode and prefill), the tolerance against the plain version
# (rtol, atol; fp32 rows), rwkv's LoRA width and the cases: rwkv's decay
# LoRA products, rwkv's LayerNorms (ln_x on fp32 rows, ln1 / ln2 / ln_f on
# bf16), llama's RMSNorm and nemotron's width.
ROWINV_ROWS = [1, 2, 4, 8, 32, 64, 128, 256]
ROWINV_TIMED = [4, 64]
ROWINV_TOL = (1e-5, 1e-6)
ROWINV_LORA = 64
ROWINV_MATMULS = [(2560, ROWINV_LORA), (ROWINV_LORA, 2560)]
ROWINV_NORMS = [("ln", 2560, "float32"), ("ln", 2560, "bfloat16"),
                ("rms", 2048, "bfloat16"), ("rms", 6144, "float32")]
ROWINV_KEYS = ("rowinv_matmul", "rowinv_norm")
ROWINV_SOURCE = "src/repro_torch/kernels/csrc/rowinv.cu"
# The dense configs served at full width and depth under mixed: (arch,
# integer-GEMM launches per prefill and per decode step, served per call
# too).  gemma's 18 layers have 7 w=8 projections each (q, k, v, o, wi,
# wg, wo) and its tied w=12 lm_head (embed.T, 2048 x 256000); stablelm's
# 40 layers the same 7 and an untied lm_head (5120 x 100352); nemotron's
# 32 layers 6 (no GLU) and an untied lm_head (6144 x 256000).  gemma runs
# per call too, its fp32 tree beside its records; stablelm (48.6 GB in
# fp32) and nemotron (62.5 GB) only on records from the leaf-wise init.
# Each serves 2 requests of 8 and 64 prompt tokens, 4 new tokens, twice
# (the other two prompts feed the 4-lane checks and the profile).
DENSE_PATHS = [("gemma-2b", {"mm1": 126, "kmm2": 1}, True),
               ("stablelm-12b", {"mm1": 280, "kmm2": 1}, False),
               ("nemotron-4-15b", {"mm1": 192, "kmm2": 1}, False)]
DENSE_PROMPTS = (8, 64, 23, 41)
DENSE_REQUESTS, DENSE_NEW = 2, 4
# What the leaf-wise init may hold on the card beyond the records it makes.
INIT_HEADROOM_GB = 16
# Replayed decode steps the profiler witness counts kernels over.
WITNESS_STEPS = 2
# The one-width paths that --profile traces beside each model's mixed one:
# llama under w20, every GEMM on the kmm4 kernel.
PROFILED_WIDE = {("llama3.2-1b", "w20")}
# WKV launches per prefill and per decode step: one a RWKV layer.
WKV_PER_CALL = {"rwkv6-3b": 32}


# The staged kernels (rows 2-4 of PERF.md's table) on their digit planes:
# mm1 at w=8, kmm2 at w=12 and 14, mm2 at w=15 and 16, at every dense
# serve (K, N) at ROWS and RAGGED plus a compute-bound M=2048 at llama's
# wi, both combines; timed at decode M=4 and prefill M=64 at wi and
# lm_head and at M=2048.  The depth-2 staged path runs kmm2 on int16
# planes (s8 route through w=22, split from w=23), checked through run_plan.
# Every staged kernel (csrc/staged_pipe.cu) is held in both B layouts
# (row-major and K-major) with split-K as planned, forced off and forced to
# STAGED_FORCED_SPLIT ways.
STAGED_MODES = [("mm1", 8), ("kmm2", 12), ("kmm2", 14), ("mm2", 15),
                ("mm2", 16)]
STAGED_TIMED = [(4, 2048, 8192), (64, 2048, 8192), (4, 2048, 128512),
                (64, 2048, 128512), (2048, 2048, 8192)]
STAGED_FORCED_SPLIT = 3
# The staged_pipe.cu sweep: every tile edge (M 1, 3, 16, 17, 64, 65, 2048),
# K not a multiple of 16 (150 values: byte loads for int8 and int16 rows;
# 1000: 16-byte copies of int16 rows, byte loads of int8 ones) and odd N;
# kmm2 at every split point h 1-7, int8 planes at w = 2h and the int16
# depth-2 branch planes of the width whose leaves split at h; mm2 at every
# split point h 1-8 on int8 planes at w = 2h.
STAGED_SWEEP_ROWS = [1, 3, 16, 17, 64, 65, 2048]
STAGED_SWEEP_KN = [(150, 129), (1000, 1001)]
STAGED_SWEEP_BRANCH_W = {1: 2, 2: 4, 3: 10, 4: 14, 5: 18, 6: 22, 7: 26}
DEPTH2_WIDTHS = [17, 20, 22, 23, 24, 26]
# ... and at every llama projection at the serve rows: w=24 is the forced
# w24 path's split route, w=20 the s8 route on int16 planes.
DEPTH2_SERVE_WIDTHS = [20, 24]
# run_plan's numerics classes, staged against fused on the same operands
# and block_k: (w, staged variant, depth, int32 combine).  Depth 2 at w=12
# runs the fused kmm4 mode below its analytic window, as the tuner may.
CLASSES = [(8, "mm1", 0, True), (12, "kmm2", 1, False),
           (12, "kmm2", 1, True), (16, "mm2", 1, False),
           (12, "kmm2", 2, False), (20, "kmm2", 2, False),
           (24, "kmm2", 2, False)]
CLASS_SHAPES = [(4, 2048, 128512), (4, 2048, 8192), (64, 2048, 8192),
                RAGGED]
# Staged KMM2 against staged MM2 at w=12 on the same planes.
KMM_VS_MM_ROWS = [4, 64, 512, 2048]
# The tuner: llama's five (K, N) at M in {4, 64} and four widths.
TUNE_ROWS = [4, 64]
TUNE_WIDTHS = [8, 12, 16, 20]
# A winner may be at most this much slower than its default, and a re-time
# this far from the tuner's time (both device time).
TUNE_SLOWER, TUNE_AGREE = 0.03, 0.10
# Serve paths under a tuning table, 2 requests of 4 new tokens each, held
# to the same path without a table: (arch, policy, table, staged launches
# per prefill and decode step; None for the tuned table, whose mix of
# fused and staged plans the sweep decides).  "forced" pins the staged
# plan of each width's numerics class at every key, so no fused kernel
# runs: llama w24 runs kmm2 at depth 2 (three split launches a GEMM), and
# granite's expert GEMMs run one staged mm1 per expert (40 a GEMM).
TABLE_PATHS = [
    ("llama3.2-1b", "mixed", "tuned", None),
    ("llama3.2-1b", "mixed", "forced",
     {"mm1_gemm": 112, "kmm2_gemm_planes_s8": 1}),
    ("llama3.2-1b", "w16", "forced", {"mm2_gemm_planes": 113}),
    ("llama3.2-1b", "w24", "forced", {"kmm2_gemm_planes_split": 339}),
    ("granite-moe-3b-a800m", "mixed", "forced",
     {"mm1_gemm": 128 + 96 * N_EXPERTS, "kmm2_gemm_planes_s8": 33}),
]
TUNED_TABLE = ROOT / "chiprun_out" / "tuned-h100.json"
# The tuned table's A/B on the llama mixed records (tuned_ab): graph
# replays a run, and the order of the runs, six with the table and six
# without.
AB_REPLAYS = 10
TUNED_AB_PATH = ("llama3.2-1b", "mixed")
AB_ORDER = ("plain", "tuned", "tuned", "plain") * 3
STAGED_SOURCES = {
    "mm1_gemm": "src/repro_torch/kernels/csrc/staged_pipe.cu",
    "kmm2_gemm_planes_s8": "src/repro_torch/kernels/csrc/staged_pipe.cu",
    "kmm2_gemm_planes_split": "src/repro_torch/kernels/csrc/staged_pipe.cu",
    "mm2_gemm_planes": "src/repro_torch/kernels/csrc/staged_pipe.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            lead_ms: float = 0.0) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).
    Where a call's host work outlasts its kernels, the events measure the
    host; ``lead_ms`` > 0 first queues a device sleep of about that long
    (``torch.cuda._sleep``, at most 2 GHz of clock), so the calls queue up
    behind it and run back to back: the interval is device time.  If
    enqueuing the calls took the host longer than the lead (a slow call, a
    pause), the measurement is taken again behind a lead twice that long,
    up to three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        if lead_ms > 0:
            torch.cuda._sleep(int(lead_ms * 2e6))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if lead_ms <= 0 or enqueue_ms < lead_ms:
            break
        lead_ms = 2 * enqueue_ms
    return start.elapsed_time(end) / iters


# Operand bytes of each mode's carrier (int8, int16 through w=16, int32).
CARRIER_BYTES = {"mm1": 1, "kmm2": 2, "mm2": 2, "kmm4": 4}


def passes(mode: str, w: int) -> int:
    """s8 tensor-core products per output element and K step that the
    width needs: 1, 3, 4, or 9 for kmm4 — 12 from w=23, where the three
    nested pre-adder products do not fit s8 and each costs its leaves'
    cross products.  The kmm4 kernel runs 12 at every width (six leaf
    planes); the bound counts what the width needs."""
    return {"mm1": 1, "kmm2": 3, "mm2": 4}.get(mode, 12 if w >= 23 else 9)


def gemm_bound_ms(mode: str, w: int, m: int, k: int, n: int,
                  out_bytes: int, dequant: bool):
    """Least time for one fused GEMM: each input read once, the output
    written once, at the card's memory rate; or its int8 tensor-core
    operations (``passes`` s8 products) at the int8 peak."""
    nbytes = (m * k + k * n) * CARRIER_BYTES[mode] + m * n * out_bytes
    if dequant:
        nbytes += 4 * (m + n)
    ops = 2 * m * k * n * passes(mode, w)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def operands(torch, fg, gen, mode: str, w: int, shape_a, shape_b):
    """Random w-bit operands in the mode's carrier, on the card."""
    q = 2 ** (w - 1) - 1
    carrier = fg.resolve(w, mode=mode)[3]
    return tuple(torch.randint(-q, q + 1, shape, generator=gen,
                               device="cuda", dtype=torch.int32).to(carrier)
                 for shape in (shape_a, shape_b))


def kernel_checks(torch, fg):
    """Phase 3 and the per-shape half of phase 6."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    every_kn = MM1_KN + KMM2_KN + GRANITE_MM1_KN + GRANITE_KMM2_KN
    cases = ([("mm1", 8, m, k, n) for k, n in MM1_KN + GRANITE_MM1_KN
              for m in ROWS]
             + [("kmm2", 12, m, k, n) for k, n in KMM2_KN + GRANITE_KMM2_KN
                for m in ROWS]
             + [("mm1", 8) + RAGGED, ("kmm2", 12) + RAGGED]
             + [("mm1", 8, m, k, n) for k, n in RWKV_MM1_KN
                for m in RWKV_ROWS]
             + [("mm1", 8) + shape for shape in MM1_EXTRA]
             + [("kmm2", 12, m, k, n) for k, n in RWKV_KMM2_KN
                for m in RWKV_ROWS]
             + [(mode, w, m, k, n) for mode, w in WIDE_MODES
                for k, n in every_kn for m in ROWS]
             + [(mode, w) + RAGGED for mode, w in WIDE_MODES])
    for mode, w, m, k, n in cases:
        _, h, z, _ = fg.resolve(w, mode=mode)
        a, b = operands(torch, fg, gen, mode, w, (m, k), (k, n))
        sx = torch.rand((m, 1), generator=gen, device=dev) * 1e-3 + 1e-4
        sw = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-4
        # the serve path's tile clamp (qmatmul._shrink_tiles) fixes kp
        block_k = min(256, 1 << max(3, (k - 1).bit_length()))
        kp = fg.padded_k(k, block_k)
        row = {"mode": mode, "w": w, "M": m, "K": k, "N": n, "kp": kp}
        for label, scales, out_dtype in (
                ("dequant_bf16", True, torch.bfloat16),
                ("raw", False, None)):
            s_x, s_w = (sx, sw) if scales else (None, None)
            got = fg.fused_gemm(a, b, s_x, s_w, w=w, mode=mode,
                                block_k=block_k, out_dtype=out_dtype)
            ref = fg.fused_gemm_reference(
                a, b, s_x, s_w, mode=mode, h=h, z=z, kp=kp,
                combine_int32=False,
                out_dtype=got.dtype)
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or got.shape != (m, n):
                fail(f"{mode} {m}x{k}x{n} {label}: dtype/shape "
                     f"{got.dtype}{tuple(got.shape)}")
            err = (got.double() - ref.double()).abs().max().item()
            if not torch.equal(got, ref):
                fail(f"{mode} {m}x{k}x{n} {label}: kernel != plain version "
                     f"(max abs err {err})")
            row[f"max_abs_err_{label}"] = err

            def kernel():
                return fg.fused_gemm(a, b, s_x, s_w, w=w, mode=mode,
                                     block_k=block_k, out_dtype=out_dtype)

            row[f"ms_{label}"], row[f"host_ms_{label}"] = device_ms(
                torch, kernel)
            if label == "dequant_bf16":
                def plain():
                    return fg.fused_gemm_reference(
                        a, b, sx, sw, mode=mode, h=h, z=z, kp=kp,
                        combine_int32=False, out_dtype=torch.bfloat16)
                row["plain_ms"] = cuda_ms(torch, plain, iters=5, warmup=1)
                row["bound_ms"], row["bound_by"] = gemm_bound_ms(
                    mode, w, m, k, n, 2, True)
        row["bound_ms_raw"], _ = gemm_bound_ms(mode, w, m, k, n, 4, False)
        # torch._int_mm computes the raw mm1 product (int8 x int8 -> int32);
        # it takes only M > 16 and K, N multiples of 8, so at M <= 16 it is
        # timed on A zero-padded to 32 rows (library_ms_raw_padded32).  No
        # single library call computes the kmm2, mm2 or kmm4 function.
        key = "library_ms_raw" if m > 16 else "library_ms_raw_padded32"
        row["library_ms_raw"] = row["library_ms_raw_padded32"] = None
        if mode == "mm1" and k % 8 == 0 and n % 8 == 0:
            row[key], row[key + "_b_col_major"] = library_int_mm_ms(
                torch, fg, a, b)
        rows.append(row)
        lib = (f" | _int_mm raw{'' if m > 16 else ', A padded to 32 rows'}"
               f" {row[key]} (B column-major "
               f"{row.get(key + '_b_col_major')})") if mode == "mm1" else ""
        log(f"  {mode:4s} w={w} M={m:<4d} K={k:<5d} N={n:<6d} equal | "
            f"kernel {row['ms_dequant_bf16']:.4f} ms (raw "
            f"{row['ms_raw']:.4f}) | bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | plain {row['plain_ms']:.3f} ms{lib}")
    return rows


def routed_counts(torch, gen, c: int, seg: int, n_seg: int, tokens: int):
    """(E, n_seg) live rows per expert and segment, as the MoE dispatch
    makes them: each of ``tokens`` tokens per segment picks TOP_K distinct
    experts at random, and each expert keeps at most ``seg`` of them.
    ``tokens`` 0 gives the edge case: experts 0-3 get no token, the others
    cycle through seg, seg - 1, 1 and 0 live rows."""
    counts = torch.zeros((N_EXPERTS, n_seg), dtype=torch.int64)
    for s in range(n_seg):
        if tokens == 0:
            for e in range(4, N_EXPERTS):
                counts[e, s] = (seg, seg - 1, 1, 0)[(e + s) % 4]
            continue
        picks = torch.stack([torch.randperm(N_EXPERTS, generator=gen)[:TOP_K]
                             for _ in range(tokens)])
        counts[:, s] = torch.bincount(picks.reshape(-1),
                                      minlength=N_EXPERTS).clamp(max=seg)
    return counts.to(torch.int32)


def grouped_bound_ms(mode: str, w: int, live, k: int, n: int,
                     out_bytes: int, dequant: bool):
    """Least time for one ragged grouped GEMM with these live rows (E, C):
    the live rows of A and the B of every expert with a live row, each
    read once, the whole (E, C, N) output written once, at the card's
    memory rate; or the live rows' int8 tensor-core operations at the
    int8 peak."""
    e, c = live.shape
    rows = int(live.sum())
    experts = int(live.any(dim=1).sum())
    nbytes = ((rows * k + experts * k * n) * CARRIER_BYTES[mode]
              + e * c * n * out_bytes)
    if dequant:
        nbytes += 4 * (rows + experts * n)
    ops = 2 * rows * k * n * passes(mode, w)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grouped_checks(torch, fg):
    """Phase 3 and the per-shape half of phase 6 for the grouped kernel."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(2)
    rows = []
    for mode, w in [("mm1", 8), ("kmm2", 12)] + WIDE_MODES:
        _, h, z, _ = fg.resolve(w, mode=mode)
        for k, n in GROUPED_KN:
            block_k = min(256, 1 << max(3, (k - 1).bit_length()))
            kp = fg.padded_k(k, block_k)
            for label, c, seg, n_seg, tokens in GROUPED_CASES:
                e = N_EXPERTS
                a, b = operands(torch, fg, gen, mode, w, (e, c, k), (e, k, n))
                sx = torch.rand((e, c, 1), generator=gen, device=dev) * 1e-3 \
                    + 1e-4
                sw = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-3 \
                    + 1e-4
                counts = routed_counts(torch, cpu_gen, c, seg, n_seg,
                                       tokens).to(dev)
                live = fg.ragged_row_mask(counts, seg, c)[..., 0]
                row = {"mode": mode, "w": w, "case": label, "E": e, "C": c,
                       "K": k, "N": n, "seg": seg, "kp": kp,
                       "live_rows": int(live.sum()),
                       "live_experts": int(live.any(dim=1).sum())}
                for out_label, scales, out_dtype in (
                        ("dequant_bf16", True, torch.bfloat16),
                        ("raw", False, None)):
                    s_x, s_w = (sx, sw) if scales else (None, None)

                    def kernel():
                        return fg.fused_gemm_grouped(
                            a, b, s_x, s_w, counts, w=w, mode=mode, seg=seg,
                            block_k=block_k, out_dtype=out_dtype)

                    got = kernel()
                    ref = fg.fused_gemm_grouped_reference(
                        a, b, s_x, s_w, counts, seg=seg, mode=mode, h=h,
                        z=z, kp=kp, combine_int32=False, out_dtype=got.dtype)
                    torch.cuda.synchronize()
                    what = f"grouped {mode} {label} {e}x{c}x{k}x{n} {out_label}"
                    if got.dtype != ref.dtype or got.shape != (e, c, n):
                        fail(f"{what}: dtype/shape {got.dtype}"
                             f"{tuple(got.shape)}")
                    err = (got.double() - ref.double()).abs().max().item()
                    if not torch.equal(got, ref):
                        fail(f"{what}: kernel != plain version (max abs err "
                             f"{err})")
                    if got[~live].any():
                        fail(f"{what}: a dead row is not zero")
                    row[f"max_abs_err_{out_label}"] = err
                    row[f"ms_{out_label}"], row[f"host_ms_{out_label}"] = \
                        device_ms(torch, kernel)
                    if scales:
                        row["plain_ms"] = cuda_ms(
                            torch, lambda: fg.fused_gemm_grouped_reference(
                                a, b, sx, sw, counts, seg=seg, mode=mode,
                                h=h, z=z, kp=kp, combine_int32=False,
                                out_dtype=torch.bfloat16),
                            iters=5, warmup=1)
                        row["bound_ms"], row["bound_by"] = grouped_bound_ms(
                            mode, w, live, k, n, 2, True)
                row["library_ms"] = None      # no single call computes it
                rows.append(row)
                log(f"  grouped {mode:4s} w={w} {label:<13s} C={c:<3d} "
                    f"K={k:<5d} N={n:<5d} live rows {row['live_rows']:<4d} "
                    f"experts {row['live_experts']:<3d} equal | kernel "
                    f"{row['ms_dequant_bf16']:.4f} ms (raw "
                    f"{row['ms_raw']:.4f}) | bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}) | plain {row['plain_ms']:.3f} ms")
    return rows


def width_sweep(torch, fg):
    """Phase 3 for every kmm4 width: dense kernel == plain version, raw
    and bf16, at a few shapes, timed at llama's wi/wg decode shape; then
    the +-2^(w-1) operands at w=26 (the quantizer's one-past-qmax values)
    and, at w=24, rows of +-2^22 over K=8192, whose int32 row sums wrap in
    the reference and must wrap the same way here."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rows = []

    def check(what, w, a, b, block_k, timed=False):
        _, h, z, _ = fg.resolve(w, mode="kmm4")
        kp = fg.padded_k(a.shape[1], block_k)
        n = b.shape[1]
        sx = torch.rand((a.shape[0], 1), generator=gen, device="cuda") \
            * 1e-3 + 1e-4
        sw = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        row = {"mode": "kmm4", "case": what, "w": w, "M": a.shape[0],
               "K": a.shape[1], "N": n, "kp": kp}
        for label, s_x, s_w, out_dtype in (
                ("dequant_bf16", sx, sw, torch.bfloat16),
                ("raw", None, None, None)):
            def kernel():
                return fg.fused_gemm(a, b, s_x, s_w, w=w, mode="kmm4",
                                     block_k=block_k, out_dtype=out_dtype)

            got = kernel()
            ref = fg.fused_gemm_reference(
                a, b, s_x, s_w, mode="kmm4", h=h, z=z, kp=kp,
                combine_int32=False, out_dtype=got.dtype)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            if not torch.equal(got, ref):
                fail(f"kmm4 {what} w={w}: kernel != plain version (max abs "
                     f"err {err})")
            row[f"max_abs_err_{label}"] = err
            if timed:
                row[f"ms_{label}"] = device_ms(torch, kernel)[0]
        rows.append(row)
        return got

    for w in KMM4_WIDTHS:
        for m, k, n in SWEEP_SHAPES:
            a, b = operands(torch, fg, gen, "kmm4", w, (m, k), (k, n))
            check("sweep", w, a, b, min(256, 1 << max(3, (k - 1).bit_length())),
                  timed=(m, k, n) == SWEEP_SHAPES[0])
        r = rows[-len(SWEEP_SHAPES)]
        log(f"  kmm4 w={w}: equal at {len(SWEEP_SHAPES)} shapes | "
            f"{r['M']}x{r['K']}x{r['N']} {r['ms_dequant_bf16']:.4f} ms (raw "
            f"{r['ms_raw']:.4f})")
    w, top = 26, 2 ** 25
    a, b = operands(torch, fg, gen, "kmm4", w, (64, 1536), (1536, 512))
    a[0], a[1], a[2, ::2] = top, -top, top
    b[:, 0], b[:, 1], b[::3, 2] = top, -top, top
    check("edge +-2^25", w, a, b, 256)
    log("  kmm4 w=26 with +-2^25 rows and columns: equal")
    w, k = 24, 8192
    a, b = operands(torch, fg, gen, "kmm4", w, (4, k), (k, 256))
    a[0], a[1] = 2 ** 22, -2 ** 22
    got = check("biased rows", w, a, b, 256)
    exact = a.double() @ b.double()
    rel = ((got.double() - exact).abs().amax(dim=1)
           / exact.abs().amax(dim=1)).tolist()
    rows[-1]["rel_err_vs_exact_by_row"] = rel
    log(f"  kmm4 w=24 K=8192 rows of +-2^22 (int32 row sums wrap, as in the "
        f"reference): equal; max error vs the exact product by row, "
        f"relative to the row's largest: {[f'{x:.2e}' for x in rel]}")
    return rows


def split_sweep(torch, fg):
    """Phase 3 for the split modes' kernel (csrc/fused_split.cu) at every
    width: kmm2 at w 9-14, mm2 at 15-16, kmm4 at SPLIT_WIDTHS' nine, at
    SPLIT_SHAPES (split-K decode, M=64, the router, element loads, a split
    ending inside [K, kp); kmm4 also KMM4_SPLIT_EXTRA), each torch.equal to
    its plain version raw, dequantized to bf16 and under the int32-ring
    combine, with +-qmax rows and columns (and -2^13 at w=14, the
    pre-adder's -128; for kmm4 -2^(w-1), and the quantizer's +2^25 at
    w=26); the plan's split count recorded."""
    from repro_torch.kernels import mm1_plan
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode, w in SPLIT_WIDTHS:
        _, h, z, _ = fg.resolve(w, mode=mode)
        q = 2 ** (w - 1) - 1
        shapes = SPLIT_SHAPES + (KMM4_SPLIT_EXTRA if mode == "kmm4" else [])
        for m, k, n in shapes:
            a, b = operands(torch, fg, gen, mode, w, (m, k), (k, n))
            a[0], a[1 % m] = q, -q
            b[:, 0], b[:, 1 % n] = q, -q
            if w == 14:
                a[-1, ::2] = -2 ** 13
                b[::3, -1] = -2 ** 13
            if mode == "kmm4":
                a[-1, ::2] = -2 ** (w - 1)
                b[::3, -1] = -2 ** (w - 1)
                if w == 26:
                    a[-1, 1::2] = 2 ** 25
                    b[1::3, -1] = 2 ** 25
            sx = torch.rand((m, 1), generator=gen, device="cuda") * 1e-3 \
                + 1e-4
            sw = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 \
                + 1e-4
            kp = fg.padded_k(k, 256)
            plan = mm1_plan.plan_split(mode, 1, m, kp, n, sms)
            row = {"mode": mode, "w": w, "M": m, "K": k, "N": n, "kp": kp,
                   "split": plan.split, "k_split": plan.k_split}
            for label, s_x, s_w, ci, out_dtype in (
                    ("dequant_bf16", sx, sw, False, torch.bfloat16),
                    ("raw", None, None, False, None),
                    ("raw_int32", None, None, True, None)):
                got = fg.fused_gemm(a, b, s_x, s_w, w=w, mode=mode,
                                    block_k=256, combine_int32=ci,
                                    out_dtype=out_dtype)
                ref = fg.fused_gemm_reference(
                    a, b, s_x, s_w, mode=mode, h=h, z=z, kp=kp,
                    combine_int32=ci, out_dtype=got.dtype)
                torch.cuda.synchronize()
                err = (got.double() - ref.double()).abs().max().item()
                if not torch.equal(got, ref):
                    fail(f"{mode} w={w} {m}x{k}x{n} {label}: kernel != "
                         f"plain version (max abs err {err})")
                row[f"max_abs_err_{label}"] = err
            rows.append(row)
        log(f"  {mode} w={w}: equal at {len(shapes)} shapes (raw, bf16, "
            f"int32 ring; splits "
            f"{[r['split'] for r in rows[-len(shapes):]]})")
    return rows


def route_timing(torch, fg):
    """The kmm4 kernel (one digit layout, twelve leaf products) at w=22 and
    w=23, where its bound moves from 9 to 12 products, from decode to a
    compute-bound prefill, dequant to bf16; each held to its plain version
    before it is timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k, n = ROUTE_KN
    rows = []
    for m in ROUTE_ROWS:
        row = {"M": m, "K": k, "N": n}
        for w in (22, 23):
            _, h, z, _ = fg.resolve(w, mode="kmm4")
            a, b = operands(torch, fg, gen, "kmm4", w, (m, k), (k, n))
            sx = torch.rand((m, 1), generator=gen, device="cuda") * 1e-3 \
                + 1e-4
            sw = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 \
                + 1e-4

            def kernel():
                return fg.fused_gemm(a, b, sx, sw, w=w, mode="kmm4",
                                     block_k=256, out_dtype=torch.bfloat16)

            got = kernel()
            ref = fg.fused_gemm_reference(
                a, b, sx, sw, mode="kmm4", h=h, z=z, kp=fg.padded_k(k, 256),
                combine_int32=False, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"kmm4 w={w} {m}x{k}x{n}: kernel != plain version")
            row[f"w{w}_ms"] = device_ms(torch, kernel)[0]
            row[f"w{w}_bound_ms"], row[f"w{w}_bound_by"] = \
                gemm_bound_ms("kmm4", w, m, k, n, 2, True)
        rows.append(row)
        log(f"  kmm4 at M={m:<4d} K={k} N={n}: w=22 {row['w22_ms']:.4f} ms, "
            f"w=23 {row['w23_ms']:.4f} ms; bounds "
            f"{row['w22_bound_ms']:.4f} / {row['w23_bound_ms']:.4f} ms "
            f"({row['w22_bound_by']} / {row['w23_bound_by']})")
    return rows


def device_ms(torch, fn, iters: int = 20):
    """(device ms, host ms) of ``fn``: timed back to back first, which
    measures the host where its work outlasts the kernel, then queued
    behind a device sleep that covers that host time."""
    host = cuda_ms(torch, fn, iters=iters)
    return cuda_ms(torch, fn, iters=iters, lead_ms=2 * iters * host + 1), host


def library_int_mm_ms(torch, fg, a, b):
    """Device times of ``torch._int_mm`` on the same int8 operands (the
    yardstick; the port never calls it), after checking it computes the
    same product: (B row-major, as the port holds it; the same values laid
    out column-major beforehand, a layout cuBLASLt runs on a faster path).
    It refuses M <= 16, so there A is zero-padded to 32 rows.  None for a
    layout it refuses, with the reason printed."""
    m, k = a.shape
    want = fg.fused_gemm(a, b, w=8)
    if m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, k))])
    out = []
    for b_lib in (b, b.t().contiguous().t()):
        try:
            got = torch._int_mm(a, b_lib)
        except RuntimeError as exc:
            log(f"  torch._int_mm refused B strides {b_lib.stride()}: "
                f"{str(exc).splitlines()[0]}")
            out.append(None)
            continue
        if not torch.equal(got[:m], want) or got[m:].any():
            fail(f"torch._int_mm disagrees with the kernel at "
                 f"{tuple(a.shape)} x {tuple(b.shape)}")
        out.append(device_ms(torch, lambda: torch._int_mm(a, b_lib))[0])
    return tuple(out)


def staged_modules():
    """The staged kernels' wrapper modules (each keeps its launch counts)."""
    from repro_torch.kernels import kmm_gemm, mm1_gemm, mm2_gemm
    return mm1_gemm, kmm_gemm, mm2_gemm


def staged_launches() -> dict:
    out = {}
    for mod in staged_modules():
        out.update(mod.launches)
    return out


def reset_all(fg) -> None:
    from repro_torch.kernels import rowinv, wkv_gemm
    fg.reset_launches()
    for mod in (wkv_gemm, rowinv) + staged_modules():
        mod.reset_launches()


def wkv_bound_ms(b: int, s: int, h: int, d: int, u_elems: int,
                 state: bool):
    """Least time for one WKV call: the r, k, v, w streams and u read once,
    y written once, and a carried state read and written once, at the
    card's memory rate; or its 7 fp32 operations per state element and step
    at the fp32 peak outside the tensor cores."""
    nbytes = 4 * (5 * b * s * h * d + u_elems + (2 * b * h * d * d
                                                 if state else 0))
    ops = 7 * b * h * s * d * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_checks(torch):
    """Phase 3w and the WKV half of phase 6: the kernel against its plain
    version (allclose within WKV_TOL on y and the final state) at every
    WKV_CASES entry, timed where marked."""
    from repro_torch.kernels import wkv_gemm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    for label, entry, b, s, h, d, chunk, warm, timed in WKV_CASES:
        shape = (b, s, h, d) if entry == "stateful" else (b, s, d)
        pad = 1 if label.startswith("unaligned") else 0
        wide = shape[:-1] + (d + pad,)
        r, k, v = ((torch.randn(wide, generator=gen, device="cuda")
                    * 0.5)[..., pad:] for _ in range(3))
        w = (torch.rand(wide, generator=gen, device="cuda") * 0.199
             + 0.8)[..., pad:]
        u = torch.randn((h, d) if entry == "stateful" else (b, d),
                        generator=gen, device="cuda") * 0.1
        if entry == "stateful":
            st0 = torch.zeros((b, h, d, d), device="cuda")
            if warm:
                st0 = torch.randn((b, h, d, d), generator=gen,
                                  device="cuda") * 0.2

            def kernel():
                return wkv_gemm.wkv_stateful(r, k, v, w, u, st0)

            def plain():
                return wkv_gemm.wkv_stateful_reference(r, k, v, w, u, st0)
        else:
            def kernel():
                return (wkv_gemm.wkv_apply(r, k, v, w, u, chunk=chunk),)

            def plain():
                return (wkv_gemm.wkv_reference(r, k, v, w, u),)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs = [(g - p).abs().max().item() for g, p in zip(got, want)]
        what = f"wkv {label} {shape}" + (f" chunk {chunk}" if chunk else "")
        for g, p in zip(got, want):
            if g.shape != p.shape or not torch.isfinite(g).all() or \
                    not torch.allclose(g, p, rtol=WKV_TOL, atol=WKV_TOL):
                fail(f"{what}: kernel != plain version (max abs err "
                     f"{errs}, tolerance {WKV_TOL})")
        row = {"case": label, "entry": entry, "B": b, "S": s, "H": h, "D": d,
               "chunk": chunk, "state0": "random" if warm else "zero",
               "max_abs_err_y": errs[0],
               "max_abs_err_state": errs[1] if len(errs) > 1 else None,
               "max_abs_err": max(errs)}
        if timed:
            # A call's host work (the wrapper's checks, the ctypes call)
            # outlasts the kernel: timed back to back, the events measure
            # the host (host_ms); queued behind a device sleep that covers
            # the host's enqueueing, they measure the device (ms).
            row["host_ms"] = cuda_ms(torch, kernel)
            row["ms"] = cuda_ms(torch, kernel,
                                lead_ms=2 * 20 * row["host_ms"] + 1)
            row["plain_host_ms"] = cuda_ms(torch, plain, iters=3, warmup=1)
            row["plain_ms"] = cuda_ms(torch, plain, iters=3, warmup=1,
                                      lead_ms=2 * 3 * row["plain_host_ms"]
                                      + 1)
            row["bound_ms"], row["bound_by"] = wkv_bound_ms(
                b, s, h, d, u.numel(), entry == "stateful")
        rows.append(row)
        log(f"  {what}: allclose ({WKV_TOL}), max abs err y "
            f"{errs[0]:.3e}" + (f", state {errs[1]:.3e}" if len(errs) > 1
                                else "")
            + (f" | kernel {row['ms']:.4f} ms (host-bound back to back: "
               f"{row['host_ms']:.4f}) | bound {row['bound_ms']:.5f} ms "
               f"({row['bound_by']}) | plain {row['plain_ms']:.3f} ms "
               f"({row['plain_host_ms']:.3f})" if timed else ""))
    return rows


def pow2_cover(k: int) -> int:
    return 1 << max(3, (k - 1).bit_length())


# s8 tensor-core products per output element and K step of each staged
# kernel, and its input planes per operand.
STAGED_PRODUCTS = {"mm1_gemm": 1, "kmm2_gemm_planes_s8": 3,
                   "kmm2_gemm_planes_split": 4, "mm2_gemm_planes": 4}


def staged_bound_ms(kernel: str, m: int, k: int, n: int, plane_bytes: int,
                    out_bytes: int = 4):
    """Least time for one staged kernel: its input planes read once and
    the output written once at the card's memory rate, or its s8
    tensor-core products at the int8 peak."""
    nin = 1 if kernel == "mm1_gemm" else 2
    nbytes = nin * (m * k + k * n) * plane_bytes + m * n * out_bytes
    ops = 2 * m * k * n * STAGED_PRODUCTS[kernel]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_bits(torch, gen, w: int, shape):
    q = 2 ** (w - 1) - 1
    return torch.randint(-q, q + 1, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def staged_call(kernel: str, planes, h: int, ci: bool, plain: bool):
    """A zero-argument call of one staged kernel's wrapper (or its plain
    version) on ``planes``."""
    from repro_torch.kernels import ref
    mm1_gemm, kmm_gemm, mm2_gemm = staged_modules()
    if kernel == "mm1_gemm":
        fn = ref.ref_int_gemm if plain else mm1_gemm.mm1_gemm
        return lambda: fn(*planes)
    if kernel.startswith("kmm2"):
        if plain:
            return lambda: ref.ref_kmm2_planes(*planes, h, combine_int32=ci)
        return lambda: kmm_gemm.kmm2_gemm_planes(*planes, h=h,
                                                 combine_int32=ci)
    if plain:
        return lambda: ref.ref_mm2_planes(*planes, h, combine_int32=ci)
    return lambda: mm2_gemm.mm2_gemm_planes(*planes, h=h, combine_int32=ci)


def k_major_planes(planes):
    """The same planes with B's (the second half) laid out K-major: each
    the transpose of a contiguous (N, K) copy."""
    half = len(planes) // 2
    return tuple(planes[:half]) + tuple(t.t().contiguous().t()
                                        for t in planes[half:])


def pipe_variants(kernel: str, planes, h: int, ci: bool):
    """(label, call) of every staged_pipe.cu instance one staged kernel
    runs on ``planes``: B row-major and K-major, each through its wrapper
    (the plan's split-K) and straight through the binding with split-K
    forced off and forced to STAGED_FORCED_SPLIT ways (those calls count
    no launch)."""
    from repro_torch.kernels import staged_pipe
    layout = {"mm1_gemm": "mm1", "kmm2_gemm_planes_s8": "kmm2",
              "kmm2_gemm_planes_split": "kmm2_split",
              "mm2_gemm_planes": "mm2"}[kernel]
    out = []
    for label, p in (("n_major", planes), ("k_major", k_major_planes(planes))):
        a1, b1 = p[0], p[len(p) // 2]
        a0, b0 = (p[1], p[3]) if len(p) == 4 else (None, None)
        out.append((f"{label} plan", staged_call(kernel, p, h, ci, False)))
        for split in (1, STAGED_FORCED_SPLIT):
            out.append((f"{label} split={split}", lambda a1=a1, a0=a0,
                        b1=b1, b0=b0, split=split, km=label == "k_major":
                        staged_pipe.launch(layout, a1, a0, b1, b0, h=h,
                                           combine_int32=ci or layout == "mm1",
                                           b_kmajor=km, split=split)))
    return out


def check_staged(torch, kernel, planes, h, ci, what, timed, rows, extra=()):
    """One staged kernel against its plain version (``torch.equal``) in
    both B layouts with split-K as planned, forced off and forced on
    (pipe_variants); timed in both layouts with its plain version and
    bound when ``timed``."""
    want = staged_call(kernel, planes, h, ci, True)()
    calls = pipe_variants(kernel, planes, h, ci)
    err = 0.0
    for label, call in calls:
        got = call()
        torch.cuda.synchronize()
        e = (got.double() - want.double()).abs().max().item()
        err = max(err, e)
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"{kernel} {what} B {label}: kernel != plain version (max "
                 f"abs err {e})")
    m, k = planes[0].shape
    n = planes[-1].shape[1]
    row = {"kernel": kernel, "case": what, "M": m, "K": k, "N": n,
           "combine_int32": ci, "plane_dtype": str(planes[0].dtype),
           "max_abs_err": err, "checked": [label for label, _ in calls],
           **dict(extra)}
    if timed:
        row["ms_n_major"], row["host_ms"] = device_ms(
            torch, staged_call(kernel, planes, h, ci, False))
        row["ms_k_major"] = device_ms(
            torch, staged_call(kernel, k_major_planes(planes), h, ci,
                               False))[0]
        # the layout the serve path hands the kernel at the result line's
        # shapes: kmm2's and mm2's at the tied lm_head K-major (embed.T's
        # planes), mm1's row-major codes
        row["ms"] = row["ms_n_major" if kernel == "mm1_gemm"
                        else "ms_k_major"]
        row["plain_ms"] = cuda_ms(torch, staged_call(kernel, planes, h, ci,
                                                     True), iters=3,
                                  warmup=1)
        row["bound_ms"], row["bound_by"] = staged_bound_ms(
            kernel, m, k, n, planes[0].element_size())
    rows.append(row)
    return row


def log_staged(row, prefix="") -> None:
    log(f"  {row['kernel']:22s} {prefix}{row['case']}: equal | kernel "
        f"B row-major {row['ms_n_major']:.4f} ms, K-major "
        f"{row['ms_k_major']:.4f} ms | bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | plain "
        f"{row['plain_ms']:.3f} ms"
        + (f" | _int_mm {row['library_ms']} [B column-major "
           f"{row['library_ms_b_col_major']}]" if "library_ms" in row
           else ""))


def staged_checks(torch, fg):
    """Phase 3 (a) and (e) for the staged kernels on int8 planes: every
    dense serve (K, N) at ROWS, granite's expert (K, N) at EXPERT_ROWS (one
    expert's GEMM, as a table's batched redirect runs it), RAGGED and
    M=2048 at llama's wi, both combines (mm1 is int32 only), the K padded
    as the staged path pads it; every kernel in both B layouts with
    split-K as planned, off and on; timed at STAGED_TIMED with the fp32
    combine the serve redirect runs, and torch._int_mm (B row-major and
    column-major) beside mm1 at each timed shape."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    every_kn = MM1_KN + KMM2_KN + GRANITE_MM1_KN + GRANITE_KMM2_KN
    shapes = ([(m, k, n) for k, n in every_kn for m in ROWS]
              + [(m, k, n) for k, n in GROUPED_KN for m in EXPERT_ROWS]
              + [RAGGED, (2048, 2048, 8192)])
    rows = []
    for mode, w in STAGED_MODES:
        h = -(-w // 2)
        kernel = {"mm1": "mm1_gemm", "kmm2": "kmm2_gemm_planes_s8",
                  "mm2": "mm2_gemm_planes"}[mode]
        for m, k, n in shapes:
            bk = min(256, pow2_cover(k))
            a = ops._pad_to(rand_bits(torch, gen, w, (m, k)), 1, bk)
            b = ops._pad_to(rand_bits(torch, gen, w, (k, n)), bk, 1)
            if mode == "mm1":
                planes = (a.to(torch.int8), b.to(torch.int8))
            else:
                planes = ops._planes(a, h)[:2] + ops._planes(b, h)[:2]
            for ci in ((True,) if mode == "mm1" else (False, True)):
                timed = (m, k, n) in STAGED_TIMED and (mode == "mm1"
                                                       or not ci)
                row = check_staged(torch, kernel, planes, h, ci,
                                   f"w={w} {m}x{k}x{n}", timed, rows,
                                   {"w": w})
                if timed and mode == "mm1":
                    row["library_ms"], row["library_ms_b_col_major"] = \
                        library_int_mm_ms(torch, fg, a[:, :k].to(torch.int8),
                                          b[:k].to(torch.int8))
                if timed:
                    log_staged(row)
        log(f"  {kernel} w={w}: equal to its plain version at "
            f"{len(shapes)} shapes, B row-major and K-major, split-K as "
            f"planned, off and on")
    return rows


def staged_sweep(torch):
    """Phase 3 (a): the staged_pipe.cu kernels at hostile shapes — M in
    STAGED_SWEEP_ROWS, K not a multiple of 16 (byte loads for int8; int16
    rows of 150 values too) and odd N (STAGED_SWEEP_KN) — mm1 on int8
    codes, kmm2 on int8 centered planes split at h 1-7 (w = 2h) and on the
    int16 depth-2 branch planes split at h2 1-7 (the s8 route through 6,
    the split route at 7), mm2 on int8 centered planes split at h 1-8 (w =
    2h), both combines, both B layouts, split-K as planned, off and on."""
    from repro_torch.kernels import kmm_gemm, ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    for m in STAGED_SWEEP_ROWS:
        for k, n in STAGED_SWEEP_KN:
            what = f"sweep {m}x{k}x{n}"
            check_staged(torch, "mm1_gemm",
                         (rand_bits(torch, gen, 8, (m, k)).to(torch.int8),
                          rand_bits(torch, gen, 8, (k, n)).to(torch.int8)),
                         0, True, what, False, rows, {"w": 8})
            for h in range(1, 8):
                a, b = (rand_bits(torch, gen, 2 * h, (m, k)),
                        rand_bits(torch, gen, 2 * h, (k, n)))
                int8 = ops._planes(a, h)[:2] + ops._planes(b, h)[:2]
                w16 = STAGED_SWEEP_BRANCH_W[h]
                int16, h2 = kmm4_branch_planes(
                    rand_bits(torch, gen, w16, (m, k)),
                    rand_bits(torch, gen, w16, (k, n)), w16)
                for planes, hh, w in ((int8, h, 2 * h), (int16, h2, w16)):
                    kernel = ("kmm2_gemm_planes_"
                              + kmm_gemm.route(planes[0].dtype, hh))
                    for ci in (False, True):
                        check_staged(torch, kernel, planes, hh, ci, what,
                                     False, rows, {"w": w})
            for h in range(1, 9):
                a, b = (rand_bits(torch, gen, 2 * h, (m, k)),
                        rand_bits(torch, gen, 2 * h, (k, n)))
                planes = ops._planes(a, h)[:2] + ops._planes(b, h)[:2]
                for ci in (False, True):
                    check_staged(torch, "mm2_gemm_planes", planes, h, ci,
                                 what, False, rows, {"w": 2 * h})
        log(f"  staged_pipe sweep M={m}: mm1, kmm2 (int8 h 1-7, int16 "
            f"h2 1-7) and mm2 (h 1-8) equal at {STAGED_SWEEP_KN}, both "
            f"combines, B row-major and K-major, split-K as planned, off "
            f"and on")
    return rows


def kmm4_branch_planes(a, b, w: int):
    """The int16 planes of the depth-2 staged path's middle branch
    (A1 + A0bar), as ops._kmm4_core forms them, and its split point."""
    import torch
    h = -(-w // 2)
    z = 1 << (h - 1)
    h2 = -(-(h + 1) // 2)
    av = (a >> h) + ((a & ((1 << h) - 1)) - z)
    bv = (b >> h) + ((b & ((1 << h) - 1)) - z)
    m2 = (1 << h2) - 1
    return ((av >> h2).to(torch.int16), (av & m2).to(torch.int16),
            (bv >> h2).to(torch.int16), (bv & m2).to(torch.int16)), h2


def depth2_checks(torch, rows):
    """Phase 3 (a) for the int16 route: run_plan's staged depth-2 path
    (three kmm2_gemm_planes launches on int16 planes, s8 route through
    w=22, split from w=23) equal to its mirror at SWEEP_SHAPES and llama's
    lm_head in both combines, at every llama projection (K, N) at ROWS for
    DEPTH2_SERVE_WIDTHS, with rows whose int32 sums wrap at w=24 and
    +-2^25 codes at w=26; the middle branch's kernel timed directly at
    llama's wi and lm_head (decode)."""
    from repro_torch.core.dispatch import ExecPlan
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = []

    def run(what, w, a, b):
        bk = min(256, pow2_cover(a.shape[1]))
        for ci in (False, True):
            plan = ExecPlan("kmm2", w, block_k=bk, combine_int32=ci,
                            depth=2)
            got = ops.run_plan(a, b, plan=plan)
            want = ops.run_plan(a, b, plan=plan, use_ref_kernels=True)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"staged depth 2 {what} w={w} int32={ci}: kernels != "
                     f"mirror")
        out.append({"case": what, "w": w, "M": a.shape[0], "K": a.shape[1],
                    "N": b.shape[1], "equal": True})

    for w in DEPTH2_WIDTHS:
        for m, k, n in SWEEP_SHAPES + [(4, 2048, 128512)]:
            run("sweep", w, rand_bits(torch, gen, w, (m, k)),
                rand_bits(torch, gen, w, (k, n)))
        log(f"  run_plan kmm2 depth 2 w={w} "
            f"({'split' if w >= 23 else 's8'} route, int16 planes): equal "
            f"to the mirror at {len(SWEEP_SHAPES) + 1} shapes, both "
            f"combines")
    for w in DEPTH2_SERVE_WIDTHS:
        for k, n in MM1_KN:
            for m in ROWS:
                run("serve", w, rand_bits(torch, gen, w, (m, k)),
                    rand_bits(torch, gen, w, (k, n)))
        log(f"  run_plan kmm2 depth 2 w={w}: equal to the mirror at every "
            f"llama projection (K, N) at M {ROWS}, both combines")
    top = 2 ** 25
    a, b = (rand_bits(torch, gen, 26, (64, 1536)),
            rand_bits(torch, gen, 26, (1536, 512)))
    a[0], a[1], a[2, ::2] = top, -top, top
    b[:, 0], b[:, 1], b[::3, 2] = top, -top, top
    run("edge +-2^25", 26, a, b)
    a, b = (rand_bits(torch, gen, 24, (4, 8192)),
            rand_bits(torch, gen, 24, (8192, 256)))
    a[0], a[1] = 2 ** 22, -2 ** 22
    run("wrapping rows", 24, a, b)
    log("  run_plan kmm2 depth 2: +-2^25 at w=26 and wrapping rows at w=24 "
        "equal to the mirror")
    for w in (20, 24):
        for m, k, n in [(4, 2048, 8192), (4, 2048, 128512)]:
            planes, h2 = kmm4_branch_planes(rand_bits(torch, gen, w, (m, k)),
                                            rand_bits(torch, gen, w, (k, n)),
                                            w)
            kernel = ("kmm2_gemm_planes_split" if w >= 23 else
                      "kmm2_gemm_planes_s8")
            row = check_staged(torch, kernel, planes, h2, False,
                               f"w={w} branch {m}x{k}x{n}", True, rows,
                               {"w": w})
            log_staged(row, "int16 ")
    return out


def class_checks(torch):
    """Phase 3 (b) and (e): run_plan on the card, staged == fused ==
    mirror (torch.equal) in each numerics class at llama's lm_head and wi
    and RAGGED, the staged and fused plans timed side by side."""
    from repro_torch.core.dispatch import ExecPlan
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    rows = []
    for w, variant, depth, ci in CLASSES:
        fused_variant = "fused_mm2" if variant == "mm2" else "fused"
        for m, k, n in CLASS_SHAPES:
            bk = 32 if (m, k, n) == RAGGED else min(256, pow2_cover(k))
            staged = ExecPlan(variant, w, block_k=bk, combine_int32=ci,
                              depth=depth)
            fused = ExecPlan(fused_variant, w, block_k=bk, combine_int32=ci,
                             depth=depth)
            a = rand_bits(torch, gen, w, (m, k))
            b = rand_bits(torch, gen, w, (k, n))
            got = [ops.run_plan(a, b, plan=staged),
                   ops.run_plan(a, b, plan=fused),
                   ops.run_plan(a, b, plan=fused, use_ref_kernels=True)]
            torch.cuda.synchronize()
            what = (f"w={w} {variant} depth {depth} int32={ci} "
                    f"{m}x{k}x{n} block_k={bk}")
            if not (torch.equal(got[0], got[1])
                    and torch.equal(got[0], got[2])):
                fail(f"run_plan {what}: staged, fused and mirror differ")
            row = {"w": w, "variant": variant, "depth": depth,
                   "combine_int32": ci, "M": m, "K": k, "N": n,
                   "block_k": bk, "equal": True}
            if (m, k, n) != RAGGED:
                row["staged_ms"] = cuda_ms(
                    torch, lambda: ops.run_plan(a, b, plan=staged), iters=10)
                row["fused_ms"] = cuda_ms(
                    torch, lambda: ops.run_plan(a, b, plan=fused), iters=10)
                log(f"  {what}: staged == fused == mirror | staged "
                    f"{row['staged_ms']:.4f} ms, fused "
                    f"{row['fused_ms']:.4f} ms "
                    f"({row['staged_ms'] / row['fused_ms']:.2f}x)")
            rows.append(row)
    log(f"  run_plan: staged == fused == mirror in {len(CLASSES)} classes "
        f"at {len(CLASS_SHAPES)} shapes")
    return rows


def kmm2_vs_mm2(torch, fg):
    """Phase 3 (e): staged KMM2 (3 products) against staged MM2 (4) at
    w=12 on the same int8 planes (B row-major; both also held and timed on
    K-major B, with split-K off and on), kernel alone and through
    run_plan, and
    fused kmm2 against fused mm2 (csrc/fused_split.cu) on the same int16
    codes, from decode to a compute-bound prefill at llama's wi (K=2048,
    N=8192); kernels in device time, run_plan back to back."""
    from repro_torch.core.dispatch import ExecPlan
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    w, h, (k, n) = 12, 6, ROUTE_KN
    rows = []
    for m in KMM_VS_MM_ROWS:
        a, b = rand_bits(torch, gen, w, (m, k)), rand_bits(torch, gen, w,
                                                           (k, n))
        planes = ops._planes(a, h)[:2] + ops._planes(b, h)[:2]
        row = {"w": w, "M": m, "K": k, "N": n}
        for kernel, variant in (("kmm2_gemm_planes_s8", "kmm2"),
                                ("mm2_gemm_planes", "mm2")):
            r = check_staged(torch, kernel, planes, h, False,
                             f"w=12 {m}x{k}x{n}", True, [])
            plan = ExecPlan(variant, w, block_k=256)
            row[variant] = {
                "kernel_ms": r["ms_n_major"],
                "kernel_ms_k_major": r.get("ms_k_major"),
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "run_plan_ms": cuda_ms(
                    torch, lambda: ops.run_plan(a, b, plan=plan), iters=10)}
        row["kernel_ratio"] = (row["kmm2"]["kernel_ms"]
                               / row["mm2"]["kernel_ms"])
        a16, b16 = a.to(torch.int16), b.to(torch.int16)
        sx = torch.rand((m, 1), generator=gen, device="cuda") * 1e-3 + 1e-4
        sw = torch.rand((1, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        for mode in ("kmm2", "mm2"):
            def fused(mode=mode):
                return fg.fused_gemm(a16, b16, sx, sw, w=w, mode=mode,
                                     out_dtype=torch.bfloat16)
            _, hh, zz, _ = fg.resolve(w, mode=mode)
            want = fg.fused_gemm_reference(
                a16, b16, sx, sw, mode=mode, h=hh, z=zz, kp=k,
                combine_int32=False, out_dtype=torch.bfloat16)
            if not torch.equal(fused(), want):
                fail(f"fused {mode} w=12 {m}x{k}x{n}: kernel != plain")
            bound, by = gemm_bound_ms(mode, w, m, k, n, 2, True)
            row[f"fused_{mode}"] = {"kernel_ms": device_ms(torch, fused)[0],
                                    "bound_ms": bound, "bound_by": by}
        row["fused_ratio"] = (row["fused_kmm2"]["kernel_ms"]
                              / row["fused_mm2"]["kernel_ms"])
        rows.append(row)
        log(f"  staged w=12 M={m:<4d} K={k} N={n}: kmm2 "
            f"{row['kmm2']['kernel_ms']:.4f} ms (B K-major "
            f"{row['kmm2']['kernel_ms_k_major']:.4f}), mm2 "
            f"{row['mm2']['kernel_ms']:.4f} ms (B K-major "
            f"{row['mm2']['kernel_ms_k_major']:.4f}; kmm2/mm2 "
            f"{row['kernel_ratio']:.2f}; bounds "
            f"{row['kmm2']['bound_ms']:.4f} / {row['mm2']['bound_ms']:.4f} "
            f"ms, {row['kmm2']['bound_by']}); run_plan "
            f"{row['kmm2']['run_plan_ms']:.4f} / "
            f"{row['mm2']['run_plan_ms']:.4f} ms; fused kmm2 "
            f"{row['fused_kmm2']['kernel_ms']:.4f} ms, mm2 "
            f"{row['fused_mm2']['kernel_ms']:.4f} ms (kmm2/mm2 "
            f"{row['fused_ratio']:.2f}; bounds "
            f"{row['fused_kmm2']['bound_ms']:.4f} / "
            f"{row['fused_mm2']['bound_ms']:.4f} ms, "
            f"{row['fused_kmm2']['bound_by']})")
    return rows


def tuner_phase(torch):
    """Phase 3 (c): ``python -m repro_torch.tune`` over llama's five (K, N)
    at M in TUNE_ROWS and TUNE_WIDTHS on the card, writing TUNED_TABLE: in
    device time behind a sleep lead, one candidate a distinct launch, only
    the candidates ``select_plan`` serves as they are.  No candidate
    rejected (a launch failure raises out of the sweep); every winner in
    the class ``select_plan`` serves and passing check_plan again at its
    shape; every winner and its default re-timed here, in turns, three
    times each (median), with ``cuda_ms`` behind a lead: a winner more
    than TUNE_SLOWER slower than its default, or a re-time more than
    TUNE_AGREE off the tuner's own time, fails."""
    from repro_torch.core.dispatch import analytic_plan
    from repro_torch.quant.qmatmul import run_plan_dequant
    from repro_torch.tune import runner
    from repro_torch.tune.__main__ import main as tune_main
    from repro_torch.tune.table import TuningTable, key_for

    shapes = [(m, k, n) for k, n in MM1_KN + KMM2_KN for m in TUNE_ROWS]
    TUNED_TABLE.parent.mkdir(exist_ok=True)
    TUNED_TABLE.unlink(missing_ok=True)
    t0 = time.monotonic()
    rc = tune_main(["--shapes", *(f"{m}x{k}x{n}" for m, k, n in shapes),
                    "--w", *map(str, TUNE_WIDTHS), "--out", str(TUNED_TABLE),
                    "--device", "cuda", "--iters", "3"])
    seconds = time.monotonic() - t0
    table = TuningTable.load(TUNED_TABLE)
    if rc != 0 or len(table) != len(shapes) * len(TUNE_WIDTHS):
        fail(f"the tuner wrote {len(table)} entries (rc {rc})")
    rejected = {k: r["n_rejected"] for k, r in table.entries.items()
                if r["n_rejected"]}
    if rejected:
        fail(f"the tuner rejected candidates that passed validate (each "
             f"must run and be exact; its log names them): {rejected}")
    rows = []
    for w in TUNE_WIDTHS:
        for shape in shapes:
            plan = table.lookup("cuda", shape, w)
            if not runner.served_as_is(plan, shape):
                fail(f"tuned winner {plan} at {shape} is not what "
                     f"select_plan serves from the table")
            a, b = runner.make_operands(shape, w, seed=1, device="cuda")
            ok, err = runner.check_plan(plan, a, b)
            if not ok:
                fail(f"tuned winner {plan} at {shape}: {err}")
            rec = table.entries[key_for("cuda", shape, w)]
            a, b = runner.make_operands(shape, w, seed=0, device="cuda")
            sx = torch.full((a.shape[0], 1), 1e-3, device="cuda")
            sw = torch.full((1, b.shape[1]), 1e-3, device="cuda")
            calls = {label: (lambda p=p: run_plan_dequant(
                a, b, sx, sw, p, torch.bfloat16))
                for label, p in (("default", analytic_plan(w)),
                                 ("winner", plan))}
            ms = {label: [] for label in calls}
            for _ in range(3):
                for label in ("default", "winner"):
                    ms[label].append(device_ms(torch, calls[label])[0])
            ms = {label: statistics.median(v) for label, v in ms.items()}
            row = {"shape": shape, "w": w, "variant": plan.variant,
                   "block_k": plan.block_k, "depth": plan.depth,
                   "combine_int32": plan.combine_int32,
                   "us": rec["us"], "us_default": rec["us_default"],
                   "lead_ms": rec.get("lead_ms"),
                   "speedup_vs_default": rec["us_default"] / rec["us"],
                   "n_candidates": rec["n_candidates"],
                   "retimed_us": ms["winner"] * 1e3,
                   "retimed_us_default": ms["default"] * 1e3}
            rows.append(row)
            if ms["winner"] > (1 + TUNE_SLOWER) * ms["default"]:
                fail(f"tuned winner {plan} at {shape} w={w}: "
                     f"{ms['winner'] * 1e3:.2f} us against its default's "
                     f"{ms['default'] * 1e3:.2f} us, re-timed in device time")
            for got, tuned in ((ms["winner"] * 1e3, rec["us"]),
                               (ms["default"] * 1e3, rec["us_default"])):
                if abs(got - tuned) > TUNE_AGREE * tuned:
                    fail(f"at {shape} w={w} the re-time {got:.2f} us and the "
                         f"tuner's {tuned:.2f} us disagree by more than "
                         f"{TUNE_AGREE:.0%}: {row}")
    log(f"  tuner: {len(table)} keys in {seconds:.1f} s; every winner in its "
        f"served class, passing check_plan again, re-timed within "
        f"{TUNE_AGREE:.0%} of the tuner and at most {TUNE_SLOWER:.0%} slower "
        f"than its default; table in {TUNED_TABLE.name}")
    for r in rows:
        log(f"    w={r['w']} {r['shape']}: {r['variant']} bk={r['block_k']} "
            f"{r['us']:.2f} us (default {r['us_default']:.2f}; re-timed "
            f"{r['retimed_us']:.2f} / {r['retimed_us_default']:.2f}), "
            f"{r['n_candidates']} timed")
    return {"seconds": seconds, "winners": rows}


def forcing_table(cfg):
    """A table pinning the staged plan of each width's numerics class at
    every key the serve paths hit (M buckets 8-256, the model's (K, N),
    widths 8, 12, 16 and 24): mm1, kmm2, mm2, kmm2 at depth 2, each with
    block_k 256, which keeps the fp32 classes' padded K."""
    from repro_torch.core.dispatch import ExecPlan
    from repro_torch.tune.space import gemm_kn
    from repro_torch.tune.table import TuningTable
    staged = {8: ("mm1", 0, True), 12: ("kmm2", 1, False),
              16: ("mm2", 1, False), 24: ("kmm2", 2, False)}
    table = TuningTable(device="forcing")
    for m in (8, 16, 32, 64, 128, 256):
        for k, n in gemm_kn(cfg):
            for w, (variant, depth, ci) in staged.items():
                table.put("cuda", (m, k, n), w, ExecPlan(
                    variant, w, block_k=256, combine_int32=ci, depth=depth))
    return table


def table_paths(torch, fg, arch, params, prompts):
    """Phase 5 (d): each TABLE_PATHS entry of ``arch`` run twice — without
    a table, then under it — each engine warmed, with the launch counts set
    to 0 just before each run and read just after: the same greedy tokens
    and full-width prefill logits (torch.equal), and under a forcing table
    exactly the staged launches per prefill, in every decode graph, and no
    fused launch.  A policy under two tables shares its untabled run."""
    from repro_torch.core.context import ExecContext
    from repro_torch.serve.engine import Request
    from repro_torch.tune.table import TuningTable, set_active_table

    out, plain_runs = {}, {}
    for _, policy, kind, per_call in [p for p in TABLE_PATHS
                                      if p[0] == arch]:
        pcfg = path_config(arch, policy)
        table = (TuningTable.load(TUNED_TABLE) if kind == "tuned" else
                 forcing_table(pcfg))
        what = f"{arch} {policy} under the {kind} table"
        runs = {}
        for label, tbl in (("plain", None), (kind, table)):
            if label == "plain" and policy in plain_runs:
                runs[label] = plain_runs[policy]
                continue
            set_active_table(None)
            eng = serve_engine(torch, pcfg, params,
                               context=ExecContext(tuning_table=tbl))
            reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts[:2]]
            run = serve_counted(torch, fg, eng, reqs)
            run["logits"] = full_logits(torch, eng, prompts[0])
            path = next((p for p in PATHS if p[:2] == (arch, policy)),
                        None)
            if label == "plain" and path is not None:
                run["launches"] = check_counted(
                    f"{arch} {policy}", eng, run,
                    path_per_call(arch, path[5], path[6]))
            elif label == "plain" or per_call is None:
                # the tuned table's mix of fused and staged plans is the
                # sweep's (and llama w24 without a table has no PATHS
                # entry): no staged launch without a table, and at least
                # one launch a GEMM, in every graph too
                staged = [k for c in [run["host"]] + list(
                    eng.executor.captured.values()) for k in c
                    if k in STAGED_SOURCES]

                def gemms(c):
                    return sum(n for k, n in c.items()
                               if k not in ROWINV_KEYS)

                if (label == "plain" and staged) or \
                        gemms(run["host"]) < 113 * run["prefills"] \
                        or any(gemms(c) < 113 for c in
                               eng.executor.captured.values()):
                    fail(f"{what} ({label}): launches {run['host']}, in "
                         f"the graphs {eng.executor.captured}")
                run["launches"] = {"host": run["host"]} | graph_launches(
                    f"{what} ({label})", eng, run)
            else:
                run["launches"] = check_counted(
                    what, eng, run, per_call | rowinv_per_call(arch))
            runs[label] = run
            if label == "plain":
                plain_runs[policy] = run
        set_active_table(None)
        r0, r1 = runs["plain"], runs[kind]
        if r0["tokens"] != r1["tokens"] or not torch.equal(r0["logits"],
                                                           r1["logits"]):
            diff = (r0["logits"].float() - r1["logits"].float()).abs().max()
            fail(f"{what}: tokens {r1['tokens']} against {r0['tokens']} "
                 f"without a table, prefill logits max |diff| {float(diff)}")
        stats, stats0 = r1["stats"], r0["stats"]
        out[f"{arch} {policy} {kind}"] = r = {
            "prefills": r1["prefills"], "launches": r1["launches"],
            "launches_plain": r0["launches"],
            "decode_steps": stats.decode_steps,
            "decode_step_ms": stats.decode_s / stats.decode_steps * 1e3,
            "decode_step_ms_plain": stats0.decode_s / stats0.decode_steps
            * 1e3,
            "prefill_ms_per_request": stats.prefill_s / 2 * 1e3,
            "wall_s": r1["wall"]}
        log(f"  {what}: tokens and prefill logits equal to the path without "
            f"a table; launches {r1['host']} over {r1['prefills']} "
            f"prefills, and in each decode graph {per_call or 'the mix'}; "
            f"{r['decode_step_ms']:.2f} ms a decode step "
            f"({r['decode_step_ms_plain']:.2f} without the table)")
    return out


def tuned_ab(torch, pcfg, qparams, prompts, table) -> dict:
    """Decode device ms a step on the records without the table and under
    it: two warmed engines, each with the same four requests prefilled and
    decoded once, the first step's logits equal under both; then the runs
    in turns (AB_ORDER), each AB_REPLAYS decode steps at 4 lanes replayed
    back to back through the width-4 graph between two CUDA events (a
    replay's host work is a few small copies, so the device is never idle
    and the events time it)."""
    import numpy as np
    from repro_torch.core.context import ExecContext
    from repro_torch.serve.engine import Request
    from repro_torch.tune.table import set_active_table

    set_active_table(None)
    steps = {}
    for label, tbl in (("plain", None), ("tuned", table)):
        eng = serve_engine(torch, pcfg, qparams,
                           context=ExecContext(tuning_table=tbl))
        for p in prompts[:4]:
            eng.submit(Request(prompt=p, max_new_tokens=4))
        eng.step()
        n_live, lanes = eng.scheduler.decode_lanes()
        slots = eng.scheduler.slots
        toks = np.array([slots[j].last_tok for j in lanes], np.int32)
        pos = np.array([slots[j].pos for j in lanes], np.int32)
        if n_live != 4:
            fail(f"tuned A/B: {n_live} live lanes, expected 4")
        logits = eng.executor.decode(lanes, toks, pos).clone()
        steps[label] = (eng, lanes, toks, pos, logits)
    if not torch.equal(steps["plain"][4], steps["tuned"][4]):
        fail("tuned A/B: a decode step's logits differ under the tuned "
             "table")
    runs = []
    for label in AB_ORDER:
        eng, lanes, toks, pos, _ = steps[label]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(AB_REPLAYS):
            eng.executor.decode(lanes, toks, pos)
        end.record()
        end.synchronize()
        runs.append((label, start.elapsed_time(end) / AB_REPLAYS))
    for eng, *_ in steps.values():
        while eng.num_active:
            eng.step()
    set_active_table(None)
    med = {lab: statistics.median(ms for l, ms in runs if l == lab)
           for lab in ("plain", "tuned")}
    log(f"  tuned table A/B on the records, decode device ms a step at 4 "
        f"lanes in turns ({AB_REPLAYS} replays a run; "
        f"{' / '.join(AB_ORDER)}): "
        + " / ".join(f"{ms:.4f}" for _, ms in runs)
        + f"; median untabled {med['plain']:.4f}, tuned {med['tuned']:.4f}"
        f" ({med['plain'] / med['tuned']:.4f}x)")
    return {"runs": runs, "median_ms": med,
            "speedup": med["plain"] / med["tuned"]}


def smoke_parity(torch, np, arch: str):
    """Phase 4: the smoke-size model on the card against the CPU."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(3)
    params_cpu = lm.init_params(gen, cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16)))
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 9, 3)]
    logits, tokens = {}, {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), params_cpu)
        cache = lm.init_cache(cfg, 2, 32, device=dev)
        with torch.inference_mode():
            out, _, _ = lm.prefill(params, cfg, toks.to(dev), cache)
        logits[dev] = out.float().cpu()
        eng = Engine(cfg, params, max_seq=32, batch_size=2, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
        eng.generate(reqs)
        tokens[dev] = [r.generated for r in reqs]
    diff = (logits["cpu"] - logits["cuda"]).abs()[:, :cfg.vocab_size].max()
    if not torch.isfinite(logits["cuda"]).all() or diff > 1e-4:
        fail(f"{arch} smoke logits on the card differ from the CPU by {diff}")
    if tokens["cpu"] != tokens["cuda"]:
        fail(f"{arch} smoke greedy tokens differ: {tokens}")
    log(f"  {arch} smoke float32: prefill logits max |cuda - cpu| = "
        f"{float(diff)}; greedy tokens equal on 3 requests")
    return float(diff)


def path_config(arch: str, policy: str):
    """The full-width config of ``arch`` under a named policy: the
    registry's (``mixed``, ``w12``), ``POLICY_W16``, or every site at the
    width a ``wNN`` name gives, as ``QuantConfig(enabled=True,
    default_bits=NN)``."""
    from repro_torch.configs import QUANT_POLICIES, get_config
    from repro_torch.quant.policy import POLICY_W16, QuantConfig

    if policy in QUANT_POLICIES:
        return get_config(arch, quant=policy)
    quant = (POLICY_W16 if policy == "w16" else
             QuantConfig(enabled=True, default_bits=int(policy[1:])))
    return get_config(arch).with_quant(quant)


def serve_inputs(torch, np, arch: str):
    """The full-width config of ``arch``'s first path, its weights (from a
    generator seeded 0) and the 6 prompts of 8-64 tokens every path
    serves."""
    from repro_torch.models import lm

    cfg = path_config(arch, next(p[1] for p in PATHS if p[0] == arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = lm.init_params(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"  {arch} full width: "
        f"{sum(t.numel() for t in _leaves(params))} parameters (fp32, "
        f"{time.monotonic() - t0:.1f} s to init on the card)")
    rng = np.random.default_rng(0)
    lens = [8, 64] + [int(x) for x in rng.integers(8, 65, size=4)]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in lens]
    return cfg, params, prompts


def nonzero(counts: dict) -> dict:
    return {k: c for k, c in counts.items() if c}


def rowinv_per_call(arch: str) -> dict:
    """The row-invariant kernels' launches per prefill and per decode step:
    one norm launch a norm call site (ln1 and ln2 a layer, ln_f, and rwkv's
    ln_x a layer), and two LoRA products a rwkv layer."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    rwkv = sum(b.kind == "rwkv" for b in cfg.pattern) * cfg.n_periods
    out = {"rowinv_norm": 2 * cfg.n_layers + 1 + rwkv}
    if rwkv:
        out["rowinv_matmul"] = 2 * rwkv
    return out


def path_per_call(arch: str, dense: dict, grouped: dict) -> dict:
    """A path's kernel launches per prefill and per decode step, by the
    executor's kernel keys (``repro_torch.kernels.launch_counts``): the
    integer GEMMs', the WKV recurrence's and the row-invariant kernels'."""
    out = {f"dense_{m}": c for m, c in dense.items()}
    out.update({f"grouped_{m}": c for m, c in grouped.items()})
    if WKV_PER_CALL.get(arch):
        out["wkv"] = WKV_PER_CALL[arch]
    return out | rowinv_per_call(arch)


def serve_counted(torch, fg, eng, reqs, graphs: bool = True):
    """One ``generate`` with every launch count set to 0 just before and
    read just after, decode graphed or eager; also the run's prefill calls
    (the script wraps the executor's entry to count them) and graph
    replays."""
    from repro_torch.kernels import launch_counts
    ex = eng.executor
    n_prefill = [0]
    inner = ex.prefill

    def counted(*args, **kw):
        n_prefill[0] += 1
        return inner(*args, **kw)

    ex.prefill, ex.graphs = counted, graphs
    replays0 = dict(ex.replays)
    reset_all(fg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    del ex.prefill
    ex.graphs = True
    replays = {w: n - replays0.get(w, 0) for w, n in ex.replays.items()}
    return {"stats": stats, "wall": wall, "host": nonzero(launch_counts()),
            "replays": nonzero(replays), "prefills": n_prefill[0],
            "graphs": graphs, "tokens": [r.generated for r in reqs]}


def check_counted(what: str, eng, run: dict, per_call: dict) -> dict:
    """The exact launch gates of one counted run.  Graphed: the host
    counters hold prefills x per-call launches (a replay launches through
    no wrapper), replays equal decode steps and every width's graph
    captured exactly the per-call launches.  Eager: (prefills + decode
    steps) x per-call.  Graphed, every width's graph also holds exactly
    those kernels as nodes (``check_graph_nodes``).  Returns the run's
    wrapper launches by kind and, graphed, the kernels the replays
    launched by profile bucket (``replayed``)."""
    stats = run["stats"]
    out = {"host": run["host"]}
    calls = run["prefills"] + (0 if run["graphs"] else stats.decode_steps)
    want = {k: c * calls for k, c in per_call.items()}
    if run["host"] != want:
        fail(f"{what}: launches {run['host']} over {calls} calls, expected "
             f"{want}: a quantized GEMM bypassed the kernels")
    if run["graphs"]:
        if sum(run["replays"].values()) != stats.decode_steps:
            fail(f"{what}: {run['replays']} graph replays for "
                 f"{stats.decode_steps} decode steps")
        for w, got in eng.executor.captured.items():
            if got != per_call:
                fail(f"{what}: the width-{w} decode graph captured {got}, "
                     f"expected {per_call}")
        out.update(graph_launches(what, eng, run))
    return out | {"prefill_calls": run["prefills"],
                  "decode_steps": stats.decode_steps}


def graph_launches(what: str, eng, run: dict) -> dict:
    """A graphed run's decode graphs, their kernel nodes held to their
    captures (``check_graph_nodes``), its replays, and the kernels those
    replays launched, by profile bucket: each graph's nodes times its
    replays."""
    nodes = check_graph_nodes(what, eng)
    replayed = {}
    for w, n in run["replays"].items():
        for k, c in nodes[w].items():
            if k != "all":
                replayed[k] = replayed.get(k, 0) + c * n
    return {"graph_nodes": nodes, "replays": run["replays"],
            "replayed": replayed}


def check_graph_nodes(what: str, eng) -> dict:
    """Every decode graph's integer-GEMM and WKV kernel nodes (what each
    replay launches, read from the driver) equal the launches its capture
    counted through the wrappers.  Each graph is read once.  Returns the
    kernel nodes by width (``all``: every kernel node)."""
    out = {}
    for w, graph in eng.executor.decode_graphs.items():
        if not hasattr(graph, "kernel_nodes"):
            got = graph_kernels(graph)
            nodes = {k: c for k, c in got.items() if k != "all"}
            want = bucket_counts(eng.executor.captured[w])
            if nodes != want:
                fail(f"{what}: the width-{w} decode graph holds the kernel "
                     f"nodes {nodes}, its capture launched {want}")
            graph.kernel_nodes = got
        out[w] = graph.kernel_nodes
    return out


def serve_engine(torch, pcfg, params, graphs: bool = True, **kw):
    """A full-width engine as every serve path builds it (4 slots, max_seq
    256, prompt buckets 8-64), warmed: its decode widths captured as graphs
    (or, with ``graphs`` False, run eagerly) and its prefill widths run."""
    from repro_torch.serve.engine import Engine
    eng = Engine(pcfg, params, max_seq=256, batch_size=4, device="cuda",
                 prompt_buckets=SERVE_BUCKETS, **kw)
    eng.executor.graphs = graphs
    eng.warm()
    return eng


def full_logits(torch, eng, prompt):
    """Full-width prefill logits of one prompt through ``lm.prefill``."""
    from repro_torch.models import lm
    with torch.inference_mode():
        cache = lm.init_cache(eng.cfg, 1, 256, device="cuda")
        logits, _, _ = lm.prefill(eng.params, eng.cfg, torch.tensor(
            [prompt], device="cuda"), cache)
    return logits


def graph_vs_eager(torch, eng, prompts):
    """Graphed decode against the eager executor on the same pool state:
    four requests prefilled and decoded once, then one decode step at 4
    lanes run eagerly and, from the same pool contents, through the graph;
    logits and every pool tensor ``torch.equal``.  The pool is put back
    and the requests drained."""
    import numpy as np
    from repro_torch.serve.engine import Request
    for p in prompts[:4]:
        eng.submit(Request(prompt=p, max_new_tokens=4))
    eng.step()
    n_live, lanes = eng.scheduler.decode_lanes()
    slots = eng.scheduler.slots
    toks = np.array([slots[j].last_tok for j in lanes], np.int32)
    pos = np.array([slots[j].pos for j in lanes], np.int32)
    ex = eng.executor
    saved = {p: {k: t.clone() for k, t in leaves.items()}
             for p, leaves in eng.pool.pools.items()}

    def put_back():
        for p, leaves in eng.pool.pools.items():
            for k, t in leaves.items():
                t.copy_(saved[p][k])

    results = []
    for graphs in (False, True):
        put_back()
        ex.graphs = graphs
        logits = ex.decode(lanes, toks, pos).clone()
        results.append((logits, {p: {k: t.clone() for k, t in leaves.items()}
                                 for p, leaves in eng.pool.pools.items()}))
    ex.graphs = True
    put_back()
    (le, pe), (lg, pg) = results
    if n_live != 4 or not torch.equal(le, lg) or any(
            not torch.equal(pe[p][k], pg[p][k]) for p in pe for k in pe[p]):
        fail("graphed decode differs from the eager executor on the same "
             "pool state")
    while eng.num_active:
        eng.step()
    return float((le.float() - lg.float()).abs().max())


def serve_full(torch, np, fg, arch: str, profile: bool):
    """Phase 5 and the engine half of phase 6 for every path of ``arch``:
    one set of full-width weights; each path's engine warmed (its decode
    graphs captured), then its runs with the launch counts set to 0 just
    before and read just after, its graphs' kernel nodes held to their
    captures.  The mixed path also runs one step graphed against eager on
    the same pool state (with ``profile``, also a whole eager run first,
    its tokens equal to the graphed ones).  Then the table paths, and the
    paths of PREQUANT_PATHS again on prequantized weights, after the fp32
    leaves that became records are freed: graphed (with ``profile``, eager
    too), tokens and prefill logits equal to the per-call run."""
    from repro_torch.quant.prequant import prequantize
    from repro_torch.serve.engine import Request

    paths = [p for p in PATHS if p[0] == arch]
    cfg, params, prompts = serve_inputs(torch, np, arch)
    lens = [len(p) for p in prompts]
    temps = [0.0, 0.0, 0.0, 0.8, 0.0, 0.0]
    out = {"arch": arch, "parameters": sum(t.numel()
                                           for t in _leaves(params)),
           "param_gb": tree_gb(params)}
    launches_by_path, baseline = {}, {}
    for _, policy, n_req, new, n_runs, dense, grouped in paths:
        pcfg = path_config(arch, policy)
        per_call = path_per_call(arch, dense, grouped)
        what = f"{arch} {policy}"

        def requests():
            return [Request(prompt=p, max_new_tokens=new, temperature=t)
                    for p, t in zip(prompts[:n_req], temps)]

        modes = ({"eager": serve_mode(torch, fg, pcfg, params, requests,
                                      what, per_call, False, 1, profile,
                                      prompts)}
                 if policy == "mixed" and profile else {})
        modes["graphed"] = serve_mode(
            torch, fg, pcfg, params, requests, what, per_call, True, n_runs,
            profile and (policy == "mixed" or (arch, policy)
                         in PROFILED_WIDE), prompts,
            check_eager=policy == "mixed")
        first = modes["graphed"].pop("first")
        logits = modes["graphed"].pop("logits")
        if "eager" in modes and \
                modes["eager"].pop("first")["tokens"] != first["tokens"]:
            fail(f"{what}: graphed decode changed a token against the "
                 f"eager executor")
        for r in first["tokens"]:
            if len(r) != new or not all(0 <= t < cfg.vocab_size
                                        for t in r):
                fail(f"{what}: bad token stream {r}")
        launches_by_path[what] = modes["graphed"]["launches"]
        if (arch, policy) in PREQUANT_PATHS:
            baseline[policy] = (first["tokens"], logits)
        out[f"{policy}_run"] = modes
        log(f"  {what}: " + "; ".join(
            f"{m} {r['decode_step_ms']:.2f} ms a decode step, "
            f"{r['prefill_tokens_per_s']:.1f} prefill tok/s, peak "
            f"{r['peak_mem_gb']:.2f} GB" for m, r in modes.items())
            + ("; graphed == eager (one step's logits and pool"
               + (", tokens" if "eager" in modes else "") + ")"
               if policy == "mixed" else ""))
    seconds = {"paths": sum(m["seconds"] for r in out.values()
                            if isinstance(r, dict)
                            for m in r.values() if isinstance(m, dict))}
    t0 = time.monotonic()
    out["table_paths"] = table_paths(torch, fg, arch, params, prompts)
    seconds["table_paths"] = time.monotonic() - t0

    # Prequantized weights: records for every policy served on them (all
    # but the first kept on the host until their turn), then the fp32
    # leaves that became records freed before the peak is reset.
    from repro_torch.bridge import tree_map
    pols = [pol for a, pol in PREQUANT_PATHS if a == arch]
    records = {}
    for i, pol in enumerate(pols):
        rec = prequantize(params, path_config(arch, pol).quant)
        records[pol] = rec if i == 0 else tree_map(lambda t: t.cpu(), rec)
        del rec
    fp32_gb = out["param_gb"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["prequant"] = {}
    for pol in pols:
        _, _, n_req, new, n_runs, dense, grouped = next(
            p for p in paths if p[1] == pol)
        pcfg = path_config(arch, pol)
        per_call = path_per_call(arch, dense, grouped)
        what = f"{arch} {pol} prequantized"
        qparams = tree_map(lambda t: t.to("cuda"), records.pop(pol))

        def requests():
            return [Request(prompt=p, max_new_tokens=new, temperature=t)
                    for p, t in zip(prompts[:n_req], temps)]

        # On the mixed records the graphed decode is profiled in every run
        # (device busy ms, kernels a step) after the profiler witness.
        # Under --profile the witness is not run: after that mode's long
        # profiler sessions of every path, a one-step session on granite's
        # records lost ~15 of its ~7,017 kernel records, one of them a
        # norm kernel, while the default run, a standalone probe and the
        # graph's own kernel nodes all give every kernel.
        modes = {"graphed": serve_mode(
            torch, fg, pcfg, qparams, requests, what, per_call, True, n_runs,
            pol == "mixed", prompts, check_eager=True,
            witness=pol == "mixed" and not profile, uncopied=True)}
        if profile:
            modes["eager"] = serve_mode(
                torch, fg, pcfg, qparams, requests, what, per_call, False, 1,
                pol == "mixed", prompts)
        tokens, logits = baseline[pol]
        for mode, r in list(modes.items()):
            if r.pop("first")["tokens"] != tokens:
                fail(f"{what} ({mode}): tokens differ from the per-call "
                     f"weights' run")
        if not torch.equal(modes["graphed"].pop("logits"), logits):
            fail(f"{what}: full-width prefill logits differ from the "
                 f"per-call weights'")
        modes["weights_gb"] = tree_gb(qparams)
        modes["fp32_weights_gb"] = fp32_gb
        launches_by_path[what] = modes["graphed"]["launches"]
        out["prequant"][pol] = modes
        log(f"  {what}: weights {modes['weights_gb']:.2f} GB (fp32 "
            f"{fp32_gb:.2f}); tokens and prefill logits equal to the "
            f"per-call run; " + "; ".join(
                f"{m} {r['decode_step_ms']:.2f} ms a decode step, "
                f"peak {r['peak_mem_gb']:.2f} GB"
                for m, r in modes.items() if isinstance(r, dict)))
        seconds[f"prequant {pol}"] = sum(
            r["seconds"] for r in modes.values() if isinstance(r, dict))
        if (arch, pol) in CHUNKED_PATHS:
            t0 = time.monotonic()
            out["prequant"][pol]["chunked_prefix"] = chunked_prefix_run(
                torch, np, fg, arch, pcfg, qparams, per_call)
            seconds["chunked_prefix"] = time.monotonic() - t0
            t0 = time.monotonic()
            out["prequant"][pol]["chunked_gate"] = chunked_gate(
                torch, np, arch, pcfg, qparams)
            seconds["chunked_gate"] = time.monotonic() - t0
        if (arch, pol) == TUNED_AB_PATH:
            from repro_torch.tune.table import TuningTable
            t0 = time.monotonic()
            out["prequant"][pol]["tuned_ab"] = tuned_ab(
                torch, pcfg, qparams, prompts, TuningTable.load(TUNED_TABLE))
            seconds["tuned_ab"] = time.monotonic() - t0
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    log(f"  {arch} serve seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return out, launches_by_path


def record_bytes(tree) -> int:
    """Bytes of every prequantized record (codes and scale) in ``tree``."""
    from repro_torch.quant.prequant import is_prequantized
    if is_prequantized(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())
    if isinstance(tree, dict):
        return sum(record_bytes(v) for v in tree.values())
    return 0


def leafwise_init(torch, cfg):
    """Records from the leaf-wise init (``lm.init_params(...,
    prequant=)``, a generator seeded 0), and what it took: seconds, the
    peak device memory it added, the records' GB; fails if the peak
    exceeds the records by more than INIT_HEADROOM_GB."""
    from repro_torch.models import lm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.monotonic()
    qparams = lm.init_params(gen, cfg, device="cuda", prequant=cfg.quant)
    torch.cuda.synchronize()
    out = {"init_s": time.monotonic() - t0,
           "init_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "records_gb": tree_gb(qparams)}
    if out["init_peak_gb"] > out["records_gb"] + INIT_HEADROOM_GB:
        fail(f"{cfg.name} leaf-wise init peaked at {out['init_peak_gb']:.2f} "
             f"GB for {out['records_gb']:.2f} GB of records")
    return qparams, out


def serve_dense(torch, np, fg, arch: str, dense: dict, per_call_too: bool):
    """Phase 5n: one dense config at full width and depth under mixed.
    With ``per_call_too`` (gemma) its fp32 tree from a generator seeded 0
    serves per call, eager and graphed (one step graphed against eager),
    is prequantized, and is freed; then the leaf-wise init builds the
    records from a generator seeded 0 (its peak memory gated), equal leaf
    for leaf to ``prequantize(init_params)``, and they serve graphed: the
    per-call run's tokens and full-width prefill logits (torch.equal).
    Every run is counted under the exact launch gates (wrappers and decode
    graph nodes), twice, greedy streams repeating; the records path is
    profiled over its decode steps (device busy ms, kernels a step)."""
    from repro_torch.models import lm
    from repro_torch.quant.prequant import prequantize
    from repro_torch.serve.engine import Request

    t_start = time.monotonic()
    pcfg = path_config(arch, "mixed")
    per_call = path_per_call(arch, dense, {})
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, pcfg.vocab_size, n)]
               for n in DENSE_PROMPTS]

    def requests():
        return [Request(prompt=p, max_new_tokens=DENSE_NEW)
                for p in prompts[:DENSE_REQUESTS]]

    out = {"arch": arch, "per_call_launches": per_call}
    want = baseline = None
    if per_call_too:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = lm.init_params(gen, pcfg, device="cuda")
        out["fp32_gb"] = tree_gb(params)
        modes = {"eager": serve_mode(torch, fg, pcfg, params, requests, arch,
                                     per_call, False, 2, False, prompts)}
        modes["graphed"] = serve_mode(torch, fg, pcfg, params, requests,
                                      arch, per_call, True, 2, False,
                                      prompts, check_eager=True)
        tokens = modes["graphed"].pop("first")["tokens"]
        if modes["eager"].pop("first")["tokens"] != tokens:
            fail(f"{arch}: graphed decode changed a token against eager")
        baseline = (tokens, modes["graphed"].pop("logits"))
        out["per_call"] = modes
        want = prequantize(params, pcfg.quant)
        del params
    qparams, out["init"] = leafwise_init(torch, pcfg)
    if want is not None:
        got = dict(_paths(qparams))
        ref = dict(_paths(want))
        if got.keys() != ref.keys() or not all(
                got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])
                for k in ref):
            fail(f"{arch}: the leaf-wise records differ from "
                 f"prequantize(init_params)")
        del want, got, ref
    out["parameters"] = param_count(qparams)
    rbytes = record_bytes(qparams)
    read = rbytes + (qparams["embed"].numel() * 4 if pcfg.tie_embeddings
                     else 0)
    rec = serve_mode(torch, fg, pcfg, qparams, requests, f"{arch} records",
                     per_call, True, 2, True, prompts, check_eager=True,
                     uncopied=True)
    first, logits = rec.pop("first"), rec.pop("logits")
    for r in first["tokens"]:
        if len(r) != DENSE_NEW or not all(0 <= t < pcfg.vocab_size
                                          for t in r):
            fail(f"{arch}: bad token stream {r}")
    if baseline is not None and (first["tokens"] != baseline[0]
                                 or not torch.equal(logits, baseline[1])):
        fail(f"{arch}: the leaf-wise records' tokens or full-width prefill "
             f"logits differ from the per-call run")
    prof = rec.pop("profile")
    rec.update({
        "record_bytes": rbytes, "bytes_read_a_step": read,
        "bound_ms": read / PEAK_BYTES_PER_S * 1e3,
        "device_busy_ms": prof["device_busy_ms_per_step"],
        "kernels_a_step": prof["kernels_per_step"],
        "launches_per_profiled_step": prof["launches_per_step"],
        "idle_share": prof["idle_share"]})
    out["records"] = rec
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_start
    init = out["init"]
    log(f"  {arch} mixed: {out['parameters']} parameters; leaf-wise init "
        f"{init['init_s']:.1f} s, peak {init['init_peak_gb']:.2f} GB for "
        f"{init['records_gb']:.2f} GB of records"
        + (" (equal to prequantize(init_params)); per call "
           + "; ".join(f"{m} {r['decode_step_ms']:.2f} ms a decode step"
                       for m, r in out["per_call"].items())
           + ", records' tokens and prefill logits equal to it"
           if per_call_too else "")
        + f"; on records graphed {rec['decode_step_ms']:.2f} ms a decode "
        f"step ({rec['decode_tokens_per_s']:.1f} tokens/s), device busy "
        f"{rec['device_busy_ms']:.2f} ms and {rec['kernels_a_step']:.0f} "
        f"kernels a step at 4 lanes, bound {rec['bound_ms']:.3f} ms "
        f"({read / 1e9:.2f} GB read a step), peak serving "
        f"{rec['peak_mem_gb']:.2f} GB; launches {per_call} a call "
        f"({out['seconds']:.1f} s)")
    return out


def param_count(tree) -> int:
    """Parameters of a tree whose weight leaves may be records (a record
    counts its codes)."""
    from repro_torch.quant.prequant import is_prequantized
    if is_prequantized(tree):
        return tree["q"].numel()
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()


def tree_gb(tree) -> float:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)) / 1e9


def serve_mode(torch, fg, pcfg, params, requests, what, per_call,
               graphs: bool, n_runs: int, profile: bool, prompts,
               check_eager: bool = False, witness: bool = False,
               uncopied: bool = False):
    """One path on one engine, decode graphed or eager: ``n_runs``
    identical counted runs (greedy streams repeat), each gated; timings
    from the last; peak device memory from the engine's construction on;
    with ``check_eager`` one step graphed against eager on the same pool
    state, with ``witness`` a profiler count of the kernels replayed, with
    ``uncopied`` the records' codes followed to the kernel, and with
    ``profile`` a device-time profile."""
    label = f"{what} {'graphed' if graphs else 'eager'}"
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = serve_engine(torch, pcfg, params, graphs)
    runs = []
    for _ in range(n_runs):
        reqs = requests()
        runs.append(serve_counted(torch, fg, eng, reqs, graphs))
        launches = check_counted(label, eng, runs[-1], per_call)
    for r1, r2, req in zip(runs[0]["tokens"], runs[-1]["tokens"], reqs):
        if req.temperature == 0.0 and r1 != r2:
            fail(f"{label}: greedy output changed on an identical run")
    stats, n = runs[-1]["stats"], len(reqs)
    out = {
        "first": runs[0], "runs": n_runs, "launches": launches,
        "decode_steps": stats.decode_steps,
        "decode_step_ms": stats.decode_s / stats.decode_steps * 1e3,
        "prefill_ms_per_request": stats.prefill_s / n * 1e3,
        "prefill_tokens_per_s": sum(len(r.prompt) for r in reqs)
        / stats.prefill_s,
        "decode_tokens_per_s": (stats.generated_tokens - n) / stats.decode_s,
        "wall_s": runs[-1]["wall"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if graphs:
        out["graph_widths"] = sorted(eng.executor.captured)
        out["logits"] = full_logits(torch, eng, prompts[0])
        lg = out["logits"]
        if not torch.isfinite(lg[:, :pcfg.vocab_size].float()).all() or \
                not (lg[:, pcfg.vocab_size:].float() < -1e29).all():
            fail(f"{label}: full-width logits are not finite or the padded "
                 f"vocab is not masked")
    if check_eager:
        out["graph_vs_eager_max_abs"] = graph_vs_eager(torch, eng, prompts)
    if witness:
        out["witness"] = profile_witness(torch, eng, prompts, label)
    if uncopied:
        out["records_uncopied"] = records_uncopied(torch, fg, eng, prompts,
                                                   label)
        log(f"  {label}: all {out['records_uncopied']} record slices "
            f"reached the kernel uncopied")
    if profile:
        eng.executor.graphs = graphs
        out["profile"] = profile_decode(torch, eng, prompts,
                                        out["decode_step_ms"])
        eng.executor.graphs = True
    out["seconds"] = time.monotonic() - t0
    return out


def records_uncopied(torch, fg, eng, prompts, label: str) -> int:
    """Every record's codes reach the kernel as stored, with no
    weight-sized cast or copy: two short requests run eagerly with the
    fused kernel's launch spied on, and the storage of every record (each
    period's slice of a stacked one) must be a B operand the kernel got.
    Returns how many record slices were checked."""
    from repro_torch.quant.prequant import is_prequantized
    from repro_torch.serve.engine import Request
    want = set()

    def walk(tree, stacked):
        if is_prequantized(tree):
            q = tree["q"]
            want.update(q[i].data_ptr() for i in range(q.shape[0])) \
                if stacked else want.add(q.data_ptr())
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, stacked or k == "blocks")

    walk(eng.params, False)
    seen = set()
    launch = fg._launch

    def spy(a, b, *args, **kw):
        seen.add(b.data_ptr())
        return launch(a, b, *args, **kw)

    fg._launch, eng.executor.graphs = spy, False
    try:
        eng.generate([Request(prompt=p, max_new_tokens=2)
                      for p in prompts[:2]])
    finally:
        fg._launch, eng.executor.graphs = launch, True
    if not want or want - seen:
        fail(f"{label}: {len(want - seen)} of {len(want)} records reached "
             f"the kernel copied")
    return len(want)


# The profile buckets (kernel_bucket) of the staged wrappers' counters.
WITNESS_KEYS = {"mm1_gemm": "staged_mm1",
                "kmm2_gemm_planes_s8": "staged_kmm2_s8",
                "kmm2_gemm_planes_split": "staged_kmm2_split",
                "mm2_gemm_planes": "staged_mm2"}


def bucket_counts(captured: dict) -> dict:
    """A graph's captured launches under the profile buckets' names."""
    return {WITNESS_KEYS.get(k, k[len("dense_"):] if k.startswith("dense_")
                             else k): c for k, c in captured.items()}


def profile_witness(torch, eng, prompts, label: str) -> dict:
    """The profiler's count of the integer-GEMM and WKV kernels in
    WITNESS_STEPS replayed decode steps at 4 lanes, one profiler session
    a step (CUPTI drops records from a session of ~20,000 kernels and
    more): each step must launch exactly what the width-4 graph
    captured."""
    want = bucket_counts(eng.executor.captured[4])
    steps = []
    for _ in range(WITNESS_STEPS):
        prof = profile_decode(torch, eng, prompts, None, n=1)
        got = {k: c for k, c in prof["launches_per_step"].items() if c}
        if got != want:
            fail(f"{label}: the profiler saw {got} kernels in a replayed "
                 f"step ({prof['kernels_per_step']:.0f} kernels in all), "
                 f"the graph captured {want}")
        steps.append(prof["kernels_per_step"])
    log(f"  {label}: profiler witness, {WITNESS_STEPS} replayed steps: "
        f"{want} a step, as captured")
    return {"launches_per_step": want, "kernels_per_step": steps}


def graph_kernels(graph) -> dict:
    """The kernel nodes of a captured CUDA graph, by profile bucket
    (``kernel_bucket`` of each node's demangled function name), read from
    the driver: exactly what every replay of the graph launches.  Also
    ``"all"``, every kernel node."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                    ("shared_mem_bytes", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")
    cxx = ctypes.CDLL("libstdc++.so.6")
    libc = ctypes.CDLL(None)
    demangle = cxx.__cxa_demangle
    demangle.restype = ctypes.c_void_p
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)]

    def check(err, what):
        if err != 0:
            fail(f"{what} failed: CUresult {err}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names, out = {}, {"all": 0}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        key = (params.func, params.kern)
        if key not in names:
            raw = ctypes.c_char_p()
            if params.func:
                check(cu.cuFuncGetName(ctypes.byref(raw),
                                       ctypes.c_void_p(params.func)),
                      "cuFuncGetName")
            else:
                check(cu.cuKernelGetName(ctypes.byref(raw),
                                         ctypes.c_void_p(params.kern)),
                      "cuKernelGetName")
            status = ctypes.c_int()
            text = demangle(raw.value, None, None, ctypes.byref(status))
            names[key] = (ctypes.string_at(text).decode() if text
                          else raw.value.decode())
            if text:
                libc.free(ctypes.c_void_p(text))
        out["all"] += 1
        bucket = kernel_bucket(names[key])
        if bucket is not None:
            out[bucket] = out.get(bucket, 0) + 1
    return out


def chunked_prefix_run(torch, np, fg, arch, pcfg, qparams, per_call):
    """Chunked prefill with prefix sharing at full width, on records: four
    prompts sharing an 80-token head, 2 slots, chunks of CHUNK tokens,
    snapshots at 64 tokens (lcm of page 64, chunk 32 and 8), each engine
    warmed and its run under the exact launch gates: with prefix sharing
    (at least 2 hits) and chunked without it.  A hit restores what a cold
    chunked prefill computes at the same chunk boundaries, so the prefix
    engine's greedy tokens must equal the chunked engine's (and
    ``chunked_gate`` holds chunked to single-shot prefill)."""
    from repro_torch.serve.engine import Engine, Request
    prompts = shared_head_prompts(np, pcfg, 5)
    runs = {}
    for label, kw in (("prefix", dict(prefill_chunk=CHUNK,
                                      prefix_cache=True)),
                      ("chunked", dict(prefill_chunk=CHUNK))):
        eng = Engine(pcfg, qparams, max_seq=256, batch_size=2,
                     device="cuda", **kw)
        eng.warm()
        reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
        run = serve_counted(torch, fg, eng, reqs)
        run["launches"] = check_counted(f"{arch} {label}", eng, run,
                                        per_call)
        if label == "prefix":
            run["prefix_cache"] = eng.prefix.stats()
        runs[label] = run
    st = runs["prefix"]["prefix_cache"]
    if runs["prefix"]["tokens"] != runs["chunked"]["tokens"] \
            or st["hits"] < 2:
        fail(f"{arch} chunked prefill with prefix sharing: tokens differ "
             f"from the chunked engine's or too few hits ({st})")
    log(f"  {arch} chunked (chunk {CHUNK}) with prefix sharing: tokens "
        f"equal to the chunked engine without it; prefix cache {st}; "
        f"{runs['prefix']['prefills']} prefill chunks, launches exact")
    return {label: {"tokens": r["tokens"], "launches": r["launches"],
                    "prefill_s": r["stats"].prefill_s,
                    "decode_s": r["stats"].decode_s,
                    "decode_steps": r["stats"].decode_steps}
            for label, r in runs.items()} | {"prefix_cache": st}


def shared_head_prompts(np, pcfg, seed: int):
    """Four prompts sharing a SHARED_HEAD-token head, tails TAILS long."""
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(1, pcfg.vocab_size, SHARED_HEAD)]
    return [head + [int(t) for t in rng.integers(1, pcfg.vocab_size, n)]
            for n in TAILS]


def chunk_compare(torch, np, pcfg, qparams, runs: int = 1) -> dict:
    """Chunked prefill (CHUNK) against single-shot prefill on the card, on
    records: two warmed engines (2 slots, 8 new greedy tokens), the 5c
    prompts (seed 5) and a second set (seed 6), each served ``runs`` times
    by both.  Every logits row the engines sample from is kept, so for
    each stream it reports whether the tokens are equal, the first token
    that differs, the first step whose logits differ at all and the max
    |difference| there, and, with two runs, whether the second repeats the
    first bit for bit."""
    from repro_torch.serve.engine import Engine, Request

    engines = {}
    for label, kw in (("chunked", dict(prefill_chunk=CHUNK)),
                      ("unchunked", {})):
        eng = engines[label] = Engine(pcfg, qparams, max_seq=256,
                                      batch_size=2, device="cuda", **kw)
        eng.warm()

    def serve(eng, prompts):
        """Greedy tokens by request, and the logits row each token was
        sampled from, by (request, step)."""
        rows, ex = {}, eng.executor
        inner = ex.sample

        def keep(seed, logits, temps, rids, steps):
            # a padding lane (request id 0, step 0) comes after the real
            # (0, 0) row, which the engine samples at prefill
            for lane, (rid, step) in enumerate(zip(rids, steps)):
                rows.setdefault((int(rid), int(step)),
                                logits[lane].float().cpu())
            return inner(seed, logits, temps, rids, steps)

        ex.sample = keep
        reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
        try:
            eng.generate(reqs)
        finally:
            del ex.sample
        return [r.generated for r in reqs], {
            (i, j): rows[(r.stats.rid, j)] for i, r in enumerate(reqs)
            for j in range(len(r.generated))}

    out = {}
    for seed in (5, 6):
        prompts = shared_head_prompts(np, pcfg, seed)
        done = [{label: serve(eng, prompts)
                 for label, eng in engines.items()} for _ in range(runs)]
        streams = []
        for i in range(len(prompts)):
            (tc, lc), (tu, lu) = done[0]["chunked"], done[0]["unchunked"]
            first_tok = next((j for j, (a, b) in enumerate(
                zip(tc[i], tu[i])) if a != b), None)
            first_logit, max_abs = None, 0.0
            for j in range(len(tc[i]) if first_tok is None
                           else first_tok + 1):
                a, b = lc[(i, j)], lu[(i, j)]
                if not torch.equal(a, b):
                    first_logit = j
                    max_abs = float((a - b).abs().max())
                    break
            streams.append({
                "tokens_equal": first_tok is None and tc[i] == tu[i],
                "first_token_differs": first_tok,
                "first_logits_differ": first_logit,
                "max_abs_logit_diff_there": max_abs,
                "tokens": len(tc[i])})
        out[f"seed {seed}"] = {"streams": streams}
        if runs > 1:
            out[f"seed {seed}"]["second_run_repeats"] = all(
                done[0][k][0] == done[1][k][0] and all(
                    torch.equal(done[0][k][1][key], done[1][k][1][key])
                    for key in done[0][k][1])
                for k in engines)
    return out


def describe_streams(streams) -> str:
    return "; ".join(
        "equal" if st["tokens_equal"] and st["first_logits_differ"] is None
        else f"token {st['first_token_differs']} differs (logits first at "
        f"step {st['first_logits_differ']}, max |diff| "
        f"{st['max_abs_logit_diff_there']:.4g})" for st in streams)


def chunked_gate(torch, np, arch, pcfg, qparams) -> dict:
    """Phase 5c's gate: chunked prefill (chunks of CHUNK) against a
    single-shot prefill on the mixed records, both prompt sets, 8 greedy
    tokens a stream: every token and every sampled logits row
    torch.equal, as the reference's ``start=`` contract makes them."""
    t0 = time.monotonic()
    out = chunk_compare(torch, np, pcfg, qparams)
    for seed, rec in out.items():
        sts = rec["streams"]
        if not all(st["tokens_equal"] and st["first_logits_differ"] is None
                   and st["tokens"] == 8 for st in sts):
            fail(f"{arch} chunked prefill (chunk {CHUNK}) differs from a "
                 f"single-shot prefill, {seed}: {describe_streams(sts)}")
    log(f"  {arch} chunked (chunk {CHUNK}) against single-shot prefill: "
        f"every token and sampled logits row equal, "
        f"{sum(len(r['streams']) for r in out.values())} streams of 8 "
        f"greedy tokens, seeds 5 and 6 ({time.monotonic() - t0:.1f} s)")
    return out


def chunk_study(torch, np, fg):
    """``--chunk-study``: the chunked gate's comparison as a report, each
    prompt set served twice by the same two engines (does a second run
    repeat the first bit for bit), for each model of CHUNKED_PATHS on its
    mixed records; phase 5r's kernels reported first.  Not gated."""
    from repro_torch.quant.prequant import prequantize

    out = {"rowinv": rowinv_checks(torch, gate=False)}
    for arch, pol in CHUNKED_PATHS:
        pcfg = path_config(arch, pol)
        _, params, _ = serve_inputs(torch, np, arch)
        qparams = prequantize(params, pcfg.quant)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for seed, rec in chunk_compare(torch, np, pcfg, qparams,
                                       runs=2).items():
            out[f"{arch} {seed}"] = rec
            log(f"  {arch} {seed}: chunked vs unchunked per stream "
                f"{describe_streams(rec['streams'])}; second run repeats "
                f"bit for bit: {rec['second_run_repeats']}")
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rowinv_checks(torch, gate: bool = True) -> list:
    """Phase 5r: the row-invariant kernels (csrc/rowinv.cu) at every M of
    ROWINV_ROWS against the same rows of M = 256 (torch.equal), and against
    their plain versions (ATen) on the same inputs: fp32 rows allclose at
    ROWINV_TOL, bf16 rows within one bf16 ulp (the same fp32 value may
    round either way once the sums differ in the last bit).  ATen's own
    change with the row count (what the kernels cure) is reported beside
    them: the max |difference| of its rows at M < 256 from the same rows
    at M = 256.  Timed at rwkv's decode (M = 4) and prefill (M = 64) rows
    in device time next to the ATen call it replaces and, for fp32 norms,
    the one library call that computes the same function
    (``F.layer_norm``, ``F.rms_norm``; the matmul's is ``x @ w``, its plain
    version), with its bound (bytes over the card's rate).  ``gate`` False
    only reports."""
    import torch.nn.functional as F
    from repro_torch.kernels import rowinv as R

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    top = max(ROWINV_ROWS)
    rtol, atol = ROWINV_TOL
    out = []

    def check(name, fn, plain, inputs, nbytes, bf16, library=None):
        full = fn(*inputs)
        ref = plain(*inputs)
        torch.cuda.synchronize()
        varies = [m for m in ROWINV_ROWS
                  if not torch.equal(fn(inputs[0][:m], *inputs[1:]),
                                     full[:m])]
        aten = max(float((plain(inputs[0][:m], *inputs[1:]).float()
                          - ref[:m].float()).abs().max())
                   for m in ROWINV_ROWS)
        diff = (full.float() - ref.float()).abs()
        tol = (2.0 ** -7 if bf16 else rtol) * ref.float().abs() + atol
        n_out = int((diff > tol).sum())
        row = {"kernel": name, "rows_differing_from_M256": varies,
               "max_abs_err": float(diff.max()), "outside_tol": n_out,
               "aten_rows_max_abs_change": aten}
        for m in ROWINV_TIMED:
            sub = (inputs[0][:m],) + tuple(inputs[1:])
            row[f"ms_M{m}"] = device_ms(torch, lambda: fn(*sub))[0]
            row[f"plain_ms_M{m}"] = device_ms(torch, lambda: plain(*sub))[0]
            row[f"library_ms_M{m}"] = (
                row[f"plain_ms_M{m}"] if library == "plain" else
                device_ms(torch, lambda: library(*sub))[0] if library
                else None)
            row[f"bound_ms_M{m}"] = nbytes(m) / PEAK_BYTES_PER_S * 1e3
        out.append(row)
        log(f"  {name}: rows equal to M={top}'s at every M "
            f"{'(NOT at ' + str(varies) + ')' if varies else ''}; max |err| "
            f"vs plain {row['max_abs_err']:.3g} ({n_out} outside tol); ATen "
            f"changes rows by up to {aten:.3g}; " + ", ".join(
                f"M={m} {row[f'ms_M{m}']:.4f} ms (ATen "
                f"{row[f'plain_ms_M{m}']:.4f}, bound "
                f"{row[f'bound_ms_M{m}']:.5f})" for m in ROWINV_TIMED))
        if gate and (varies or n_out):
            fail(f"{name}: rows differ with M at {varies}, or {n_out} "
                 f"outputs outside the tolerance of the plain version")

    for k, n in ROWINV_MATMULS:
        x = torch.randn(top, k, generator=gen, device="cuda")
        if k == ROWINV_LORA:                  # tanh of the first product
            x = torch.tanh(x)
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        check(f"rowinv_matmul {k}x{n}", R.rowinv_matmul,
              R.rowinv_matmul_reference, (x, w),
              lambda m, k=k, n=n: 4 * (m * k + k * n + m * n), False,
              "plain")
    for kind, d, dtype in ROWINV_NORMS:
        dt = getattr(torch, dtype)
        x = (torch.randn(top, d, generator=gen, device="cuda") + 0.5).to(dt)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
        esz = x.element_size()
        library = None
        if dtype == "float32":
            library = ((lambda x, s, b, d=d: F.layer_norm(x, (d,), s, b,
                                                          1e-6))
                       if kind == "ln" else
                       (lambda x, s, b, d=d: F.rms_norm(x, (d,), s, 1e-6)))
        check(f"rowinv_norm {kind} {d} {dtype}",
              lambda x, s, b, kind=kind: R.rowinv_norm(x, s, b, kind=kind),
              lambda x, s, b, kind=kind: R.rowinv_norm_reference(
                  x, s, b, kind, 1e-6), (x, scale, bias),
              lambda m, d=d, esz=esz, kind=kind: (2 * m * d * esz + 4 * d * (
                  2 if kind == "ln" else 1)), dtype == "bfloat16", library)
    return out


def profile_path(torch, np, fg, arch: str, policy: str,
                 table_kind: str = ""):
    """``--profile-path``: one run of one serve path (its requests, the
    launch counts printed), then its decode steps traced as phase 6 traces
    them; with ``table_kind`` "forced", the TABLE_PATHS path of ``arch``
    and ``policy`` under its forcing table (its 2 requests of 4 new
    tokens).  It uses nothing but the port's public entries, so a copy of
    this script beside another checkout traces that checkout the same
    way."""
    from repro_torch.core.context import ExecContext
    from repro_torch.serve.engine import Engine, Request

    pcfg = path_config(arch, policy)
    if table_kind:
        n_req, new = 2, 4
        context = ExecContext(tuning_table=forcing_table(pcfg))
    else:
        _, _, n_req, new, _, _, _ = next(
            p for p in PATHS if p[:2] == (arch, policy))
        context = None
    _, params, prompts = serve_inputs(torch, np, arch)
    eng = Engine(pcfg, params, max_seq=256, batch_size=4, device="cuda",
                 context=context)
    if hasattr(eng, "warm"):
        eng.warm()
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts[:n_req]]
    reset_all(fg)
    stats = eng.generate(reqs)
    torch.cuda.synchronize()
    log(f"  {arch} {policy}{' ' + table_kind if table_kind else ''}: "
        f"{stats.decode_steps} decode steps, launches dense "
        f"{dict(fg.launches)} grouped {dict(fg.grouped_launches)} staged "
        f"{staged_launches()} (decode graphs: "
        f"{getattr(eng.executor, 'captured', 'none')})")
    return profile_decode(torch, eng, prompts,
                          stats.decode_s / stats.decode_steps * 1e3)


def kernel_bucket(name: str):
    """The integer-GEMM, WKV or row-invariant kernel a profiler event (or
    graph node) name is, or None:
    mm1 is fused_mm1_kernel<tile rows, grouped>; kmm2, mm2 and kmm4
    fused_split_kernel<layout, tile rows, grouped> (layout 2, 3, 4); the
    staged mm1, kmm2 s8, kmm2 split and mm2 kernels staged_pipe_kernel<
    layout, ...> (layout 1, 2, 3, 4; in older checkouts
    staged_gemm_kernel<layout, ...>, and mm2 the untemplated
    staged_gemm_kernel); the WKV kernels wkv_kernel<D> and
    wkv_step_kernel<D>; rowinv_matmul_kernel<KW> and
    rowinv_norm_kernel<T>."""
    for mode, prefix in (("mm1", "fused_mm1_kernel<"),
                         ("kmm2", "fused_split_kernel<2,"),
                         ("mm2", "fused_split_kernel<3,"),
                         ("kmm4", "fused_split_kernel<4,")):
        if prefix in name:
            grouped = name.split(">")[0].endswith("true")
            return ("grouped_" if grouped else "") + mode
    for key, layout in (("staged_mm1", 1), ("staged_kmm2_s8", 2),
                        ("staged_kmm2_split", 3), ("staged_mm2", 4)):
        if (f"staged_pipe_kernel<{layout}," in name
                or f"staged_gemm_kernel<{layout}," in name
                or (layout == 4 and "staged_gemm_kernel(" in name)):
            return key
    if "wkv_kernel<" in name or "wkv_step_kernel<" in name:
        return "wkv"
    for key in ROWINV_KEYS:
        if f"{key}_kernel" in name:
            return key
    return None


def profile_decode(torch, eng, prompts, step_ms, n: int = 4):
    """Device time by kernel over decode steps only (torch.profiler): four
    requests are admitted and prefilled first, then ``n`` engine steps at 4
    live lanes are traced (graph replays or eager steps, as the executor
    is set).  Only GPU kernel events are summed (the profiler also lists
    each ATen op with its kernels' time), less a short sleep kernel run
    first in the session, which puts the device tracing under way before
    the first traced step.  The device's idle share is 1 - busy /
    ``step_ms``, the un-profiled decode step."""
    from repro_torch.serve.engine import Request
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:4]:
        eng.submit(Request(prompt=p, max_new_tokens=n + 2))
    eng.step()                          # admit + prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a kernel the profiler sees first (dropped from the rows below),
        # so the traced steps start with its device tracing under way
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    while eng.num_active:
        eng.step()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or "spin_kernel" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append({"name": ev.key[:120], "ms_per_step": dev_us / 1e3 / n,
                     "per_step": ev.count / n, "count": ev.count})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    gemm = {f"{kind}{mode}": 0.0 for mode in ("mm1", "kmm2", "mm2", "kmm4")
            for kind in ("", "grouped_")}
    gemm.update({f"staged_{k}": 0.0 for k in ("mm1", "kmm2_s8",
                                              "kmm2_split", "mm2")})
    counts = {"wkv": 0, **{k: 0 for k in gemm}, **{k: 0 for k in ROWINV_KEYS}}
    for r in rows:
        key = kernel_bucket(r["name"])
        if key is not None:
            gemm[key] = gemm.get(key, 0.0) + r["ms_per_step"]
            counts[key] += r["count"]
    out = {"steps": n, "lanes": 4, "device_busy_ms_per_step": busy,
           "gemm_ms_per_step": gemm,
           "launches_per_step": {k: c / n for k, c in counts.items()},
           "kernels_per_step": sum(r["per_step"] for r in rows),
           "profiled_step_wall_ms": wall_ms, "step_ms": step_ms,
           "idle_share": 1 - busy / step_ms if step_ms else None,
           "by_kernel": rows[:30]}
    if step_ms is None:
        return out
    log(f"  profile, {n} decode steps at 4 lanes: device busy {busy:.2f} "
        f"ms/step (integer GEMM, WKV and row-invariant kernels " + ", ".join(
            f"{k} {v:.3f}" for k, v in gemm.items() if v) + f"), "
        f"{out['kernels_per_step']:.0f} kernels/step; idle share "
        f"{out['idle_share']:.2f} of the {step_ms:.2f} ms step")
    for r in rows[:10]:
        log(f"    {r['ms_per_step']:8.3f} ms/step  x{r['per_step']:<6.0f} "
            f"{r['name'][:90]}")
    return out


def _paths(tree, path=()):
    """(key path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _leaves(tree):
    for _, leaf in _paths(tree):
        yield leaf


def kernel_entries(rows, grouped_rows, sweep_rows, split_rows,
                   launches_by_path, staged_rows, sweep_staged, table_runs,
                   wkv_rows, rowinv_rows):
    """One entry per kernel (dense and grouped; mm1, kmm2, mm2 and kmm4)
    for the result line.  ``launches`` sums the wrapper's counts over the
    last counted run of every serve path (``launches_by_path`` has each):
    prefills, as a decode graph's replay passes no wrapper;
    ``launches_in_graph_replays`` beside it is what the decode graphs'
    replays in those runs launched: each graph's kernel nodes, read from
    the driver, times the replays counted in the run.

    Dense mm1 at the prefill shape of llama's wi/wg (M=64, where
    torch._int_mm, which needs M > 16, can run on the same inputs; its
    decode time at M=4 beside it, with _int_mm on A padded to 32 rows);
    dense kmm2, mm2 (w=16) and kmm4 (w=20, and w=24 beside it) at decode on
    4 lanes (llama's lm_head); the grouped kernel at granite's decode on 4
    lanes (wi/wg, C=32).  No library call computes the kmm2, mm2 or kmm4
    function or the ragged grouped product."""
    def total(kind, mode):
        return sum(counts["host"].get(f"{kind}_{mode}", 0)
                   for counts in launches_by_path.values())

    def replayed(bucket, runs):
        return sum(c.get("replayed", {}).get(bucket, 0) for c in runs)

    def entry(name, kind, mode, row, all_rows, shape, library_ms):
        return {
            "name": name,
            "route": "cuda",
            "source": MM1_SOURCE if mode == "mm1" else SPLIT_SOURCE,
            "replaces": ("src/repro/kernels/fused_gemm.py:119"
                         if kind == "dense" else
                         "src/repro/kernels/fused_gemm.py:437"),
            "launches": total(kind, mode),
            "launches_in_graph_replays": replayed(
                mode if kind == "dense" else f"grouped_{mode}",
                launches_by_path.values()),
            "max_abs_err": max(max(r["max_abs_err_dequant_bf16"],
                                   r["max_abs_err_raw"])
                               for r in all_rows if r["mode"] == mode),
            "ms": row["ms_dequant_bf16"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": library_ms,
            "shape": shape,
            "ms_raw": row["ms_raw"],
            "host_ms": row.get("host_ms_dequant_bf16"),
        }

    def w24(entry_, row_24):
        # kmm4 at w=24 beside w=20: the same kernel, a 12-product bound
        entry_.update({"w24_ms": row_24["ms_dequant_bf16"],
                       "w24_plain_ms": row_24["plain_ms"],
                       "w24_bound_ms": row_24["bound_ms"],
                       "w24_bound_by": row_24["bound_by"]})

    out = []
    pick = {"mm1": (64, 2048, 8192), "kmm2": (4, 2048, 128512),
            "mm2": (4, 2048, 128512), "kmm4": (4, 2048, 128512)}
    for mode, (m, k, n) in pick.items():
        row = next(r for r in rows if r["mode"] == mode
                   and (r["M"], r["K"], r["N"]) == (m, k, n))
        out.append(entry(f"fused_gemm_{mode}", "dense", mode, row,
                         rows + sweep_rows + split_rows,
                         f"w={row['w']} M={m} K={k} N={n}, dequant to bf16",
                         row["library_ms_raw"]))
        if mode == "kmm4":
            w24(out[-1], next(r for r in rows if r["mode"] == mode
                              and r["w"] == 24
                              and (r["M"], r["K"], r["N"]) == (m, k, n)))
        if mode == "mm1":
            dec = next(r for r in rows if r["mode"] == "mm1"
                       and (r["M"], r["K"], r["N"]) == (4, k, n))
            out[-1].update({
                "library_ms_b_col_major": row["library_ms_raw_b_col_major"],
                "decode_ms": dec["ms_dequant_bf16"],
                "decode_bound_ms": dec["bound_ms"],
                "decode_library_ms_padded32":
                    dec["library_ms_raw_padded32"],
                "decode_library_ms_padded32_b_col_major":
                    dec["library_ms_raw_padded32_b_col_major"]})
    for mode in pick:
        dec = [r for r in grouped_rows if r["mode"] == mode
               and r["case"] == "decode W=4" and r["K"] == 1536]
        row = dec[0]
        out.append(entry(
            f"fused_gemm_grouped_{mode}", "grouped", mode, row, grouped_rows,
            f"w={row['w']} E={row['E']} C={row['C']} K={row['K']} "
            f"N={row['N']}, "
            f"{row['live_rows']} live rows in {row['live_experts']} "
            f"experts, dequant to bf16", None))
        if mode == "kmm4":
            w24(out[-1], next(r for r in dec if r["w"] == 24))
    # The staged kernels: launches summed over the serve paths under a
    # table; mm1 at the prefill shape of llama's wi (where torch._int_mm
    # runs), kmm2 (w=12) and mm2 (w=16) on int8 planes and kmm2's split
    # route on the int16 planes of w=24's middle branch at llama's lm_head
    # on 4 lanes, fp32 combine.  ``ms`` is the B layout the serve path
    # hands the kernel there (mm1: the row-major codes; kmm2: the tied
    # lm_head's K-major planes), both layouts beside it.
    pick = {"mm1_gemm": (8, (64, 2048, 8192)),
            "kmm2_gemm_planes_s8": (12, (4, 2048, 128512)),
            "kmm2_gemm_planes_split": (24, (4, 2048, 128512)),
            "mm2_gemm_planes": (16, (4, 2048, 128512))}
    replaces = {"mm1_gemm": "src/repro/kernels/mm1_gemm.py:23",
                "kmm2_gemm_planes_s8": "src/repro/kernels/kmm_gemm.py:45",
                "kmm2_gemm_planes_split": "src/repro/kernels/kmm_gemm.py:45",
                "mm2_gemm_planes": "src/repro/kernels/mm2_gemm.py:24"}
    for name, (w, shape) in pick.items():
        row = next(r for r in staged_rows
                   if r["kernel"] == name and r["w"] == w and "ms" in r
                   and (r["M"], r["K"], r["N"]) == shape)
        out.append({
            "name": name, "route": "cuda", "source": STAGED_SOURCES[name],
            "replaces": replaces[name],
            "launches": sum(run["launches"]["host"].get(name, 0)
                            for runs in table_runs.values()
                            for run in runs.values()),
            "launches_in_graph_replays": replayed(
                WITNESS_KEYS[name], [run["launches"] for runs in
                                     table_runs.values()
                                     for run in runs.values()]),
            "max_abs_err": max(r["max_abs_err"]
                               for r in staged_rows + sweep_staged
                               if r["kernel"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            "library_ms_b_col_major": row.get("library_ms_b_col_major"),
            "ms_b_row_major": row["ms_n_major"],
            "ms_b_k_major": row.get("ms_k_major"),
            "shape": f"w={w} M={shape[0]} K={shape[1]} N={shape[2]}, "
                     f"{row['plane_dtype']} planes, "
                     + ("int32 out" if name == "mm1_gemm" else
                        "fp32 combine"),
        })
    # The WKV kernel at decode on 4 lanes (40 heads of 64, S = 1), the
    # shape it runs at each decode step of the rwkv path; no single
    # library call computes the recurrence.
    row = next(r for r in wkv_rows if r["case"] == "decode W=4")
    out.append({
        "name": "wkv", "route": "cuda", "source": WKV_SOURCE,
        "replaces": "src/repro/kernels/wkv_gemm.py:33",
        "launches": sum(c["host"].get("wkv", 0)
                        for c in launches_by_path.values()),
        "launches_in_graph_replays": replayed("wkv",
                                              launches_by_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "shape": f"B={row['B']} S={row['S']} H={row['H']} D={row['D']}, "
                 f"fp32, state in and out",
    })
    # The row-invariant kernels, port-only (no TPU kernel: the reference
    # runs these as jnp ops), at rwkv's decode rows (M = 4): the LoRA
    # product K 2560 -> N 64, and ln_x (LayerNorm over 2560, fp32 rows).
    # Their plain versions are single ATen calls (x @ w; the norm a few
    # ops); the library call is x @ w itself and F.layer_norm.
    for key, case, replaces in (
            ("rowinv_matmul", "rowinv_matmul 2560x64",
             "src/repro/models/rwkv.py:67 (_decay's jnp LoRA products; no "
             "TPU kernel)"),
            ("rowinv_norm", "rowinv_norm ln 2560 float32",
             "src/repro/models/layers.py:32 (norm_apply in jnp; no TPU "
             "kernel)")):
        row = next(r for r in rowinv_rows if r["kernel"] == case)
        mine = [r for r in rowinv_rows if r["kernel"].startswith(key)]
        out.append({
            "name": key, "route": "cuda", "source": ROWINV_SOURCE,
            "replaces": replaces,
            "launches": sum(c["host"].get(key, 0)
                            for c in launches_by_path.values()),
            "launches_in_graph_replays": replayed(
                key, launches_by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if "bfloat16" not in r["kernel"]),
            "max_abs_err_bf16_rows": max(
                [r["max_abs_err"] for r in mine
                 if "bfloat16" in r["kernel"]] or [None]),
            "ms": row["ms_M4"], "plain_ms": row["plain_ms_M4"],
            "bound_ms": row["bound_ms_M4"], "bound_by": "bytes",
            "library_ms": row["library_ms_M4"],
            "prefill_ms": row["ms_M64"],
            "prefill_plain_ms": row["plain_ms_M64"],
            "prefill_bound_ms": row["bound_ms_M64"],
            "shape": f"{case}, M=4 (M=64 as prefill_*)",
        })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short serve run with torch.profiler")
    ap.add_argument("--chunk-study", action="store_true",
                    help="only build and compare chunked with single-shot "
                    "prefill at full width, two prompt sets, two runs "
                    "(writes chiprun_out/chunk_study.json)")
    ap.add_argument("--profile-path", metavar="ARCH:POLICY[:forced]",
                    help="only build, serve this one path of PATHS (with "
                    ":forced, of TABLE_PATHS under its forcing table) once "
                    "and trace its decode steps (writes "
                    "chiprun_out/profile_ARCH_POLICY[_forced].json)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels import fused_gemm as fg
    except ImportError as exc:
        fail(f"the port (src/repro_torch) is not beside this script: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("[2] build kernels")
    t0 = time.monotonic()
    libs = build.build()
    log(f"  built {sorted(libs)} in {time.monotonic() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                log(f"  {name}: {line.strip()}")

    if args.profile_path:
        arch, policy, *kind = args.profile_path.split(":")
        prof = profile_path(torch, np, fg, arch, policy, *kind)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        tag = "_".join([arch, policy] + kind)
        (out_dir / f"profile_{tag}.json").write_text(json.dumps(
            {"card": card, "path": args.profile_path, "profile": prof},
            indent=1))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.chunk_study:
        study = chunk_study(torch, np, fg)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chunk_study.json").write_text(json.dumps(
            {"card": card, "chunk": CHUNK, "study": study}, indent=1))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    seconds = {"build": time.monotonic() - t0}
    t0 = time.monotonic()
    log("[3] kernels vs plain versions (torch.equal) at the paths' shapes")
    rows = kernel_checks(torch, fg)
    grouped_rows = grouped_checks(torch, fg)
    sweep_rows = width_sweep(torch, fg)
    split_rows = split_sweep(torch, fg)
    route_rows = route_timing(torch, fg)
    seconds["fused_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log("[3a] staged kernels vs plain versions (torch.equal): int8 planes "
        "at the serve shapes, int16 planes through run_plan at depth 2")
    staged_rows = staged_checks(torch, fg)
    sweep_staged = staged_sweep(torch)
    depth2_rows = depth2_checks(torch, staged_rows)
    log("[3b] run_plan on the card: staged == fused == mirror by class")
    class_rows = class_checks(torch)
    log("[3e] KMM2 against MM2 at w=12: staged, then fused")
    kvm_rows = kmm2_vs_mm2(torch, fg)
    seconds["staged_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log(f"[3w] WKV kernel vs plain version (allclose, rtol = atol = "
        f"{WKV_TOL})")
    wkv_rows = wkv_checks(torch)
    seconds["wkv_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log("[5r] row-invariant kernels: rows equal at every M, against their "
        "plain versions")
    rowinv_rows = rowinv_checks(torch)
    seconds["rowinv_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log("[3c] tune llama's GEMMs on the card")
    tuner = tuner_phase(torch)
    seconds["tuner"] = time.monotonic() - t0

    t0 = time.monotonic()
    archs = list(dict.fromkeys(p[0] for p in PATHS))
    log("[4] smoke-size models: card vs CPU")
    smoke_diff = {arch: smoke_parity(torch, np, arch) for arch in archs}
    seconds["smoke"] = time.monotonic() - t0

    engines, launches_by_path = {}, {}
    for arch in archs:
        log(f"[5] serve full-width {arch} ("
            + ", then ".join(p[1] for p in PATHS if p[0] == arch)
            + " policies)")
        t0 = time.monotonic()
        engines[arch], by_path = serve_full(torch, np, fg, arch,
                                            args.profile)
        seconds[f"serve {arch}"] = time.monotonic() - t0
        launches_by_path.update(by_path)
        torch.cuda.empty_cache()

    for arch, dense, per_call_too in DENSE_PATHS:
        log(f"[5n] serve full-width {arch} under mixed"
            + (", per call and" if per_call_too else "")
            + " on records from the leaf-wise init")
        t0 = time.monotonic()
        engines[arch] = serve_dense(torch, np, fg, arch, dense, per_call_too)
        seconds[f"serve {arch}"] = time.monotonic() - t0
        launches_by_path[f"{arch} mixed records"] = \
            engines[arch]["records"]["launches"]
        if per_call_too:
            for mode, run in engines[arch]["per_call"].items():
                launches_by_path[f"{arch} mixed {mode}"] = run["launches"]
        torch.cuda.empty_cache()

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_shapes": rows,
              "grouped_shapes": grouped_rows, "kmm4_sweep": sweep_rows,
              "split_sweep": split_rows,
              "kmm4_w22_w23": route_rows, "staged_shapes": staged_rows,
              "staged_sweep": sweep_staged,
              "staged_depth2": depth2_rows, "run_plan_classes": class_rows,
              "kmm2_vs_mm2": kvm_rows, "wkv_shapes": wkv_rows,
              "tuner": tuner,
              "smoke_max_abs_logit_diff": smoke_diff, "engines": engines,
              "launches_by_path": launches_by_path,
              "rowinv": rowinv_rows,
              "phase_seconds": seconds,
              "seconds": time.monotonic() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[6] details in chiprun_out/chip_smoke.json; "
        f"{report['seconds']:.1f} s in all ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    print(card, flush=True)
    table_runs = {arch: eng["table_paths"] for arch, eng in engines.items()
                  if "table_paths" in eng}
    print(json.dumps({"kernels": kernel_entries(
        rows, grouped_rows, sweep_rows, split_rows, launches_by_path,
        staged_rows, sweep_staged, table_runs, wkv_rows, rowinv_rows)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
