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
    python3 chip_smoke.py --train-mesh-study [ARCH]
                                      # only run phase 5d (b)'s granite (or
                                      # 5d (c)'s rwkv6-3b, 5d (d)'s llava or
                                      # seamless) step 1 over init seeds, no
                                      # gate applied

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

qwen3-moe-30b-a3b (128 experts top-8) and the ATen route add:

  3.  the fused kernel at qwen3's shapes (mm1 at its attention
      projections, kmm2 at its router, 2048 x 128, and its untied lm_head,
      2048 x 152064, M 1-64) and the grouped kernel in mm1 at its expert
      GEMMs (128 experts, 2048 x 768 and 768 x 2048, decode on 1 and 4
      lanes, a 64-token prefill whose capacity of 8 drops, and the edge
      case), torch.equal to their plain versions;
  3k. the ATen route (backend "aten", the reference's "xla": the KMM digit
      recursion of core/kmm.py on exact ATen leaf products, float64 on the
      card): kmm_n and mm_n at llama's wi (2048 x 8192), M 4 and 64, at w
      12, 16, 20, 24 and 28 with n from select_mode; quantized_matmul on
      "aten" at w 8, 12 and 28; strassen and strassen+kmm2 at 64 x 2048 x
      2048, w 8 and 12, equal to xla_ref (strassen+kmm2: exactly 7 fused
      kmm2 launches a GEMM); the FFIP literal at 8 x 64 x 8 — each card
      result torch.equal to the same call on the CPU (on 1024 of B's
      columns), timed in device time beside the fused kernel at the same
      width;
  5n. qwen3-moe-30b-a3b under mixed on leaf-wise records only (init peak
      gated like nemotron's): 192 fused mm1 + 49 fused kmm2 + 144 grouped
      mm1 + 97 norm launches a prefill and a decode step, the same twice,
      graphed, profiled at 4 lanes, its byte bound on every record and on
      the experts the profiled steps routed (counted in an eager run of the
      same steps);
  5a. llama3.2-1b per call on the ATen route: under mixed on "aten" (113
      GEMMs a call on the route, prefill logits within one bfloat16 ulp of
      the "cuda" route's on the same weights) and with every site at w=28
      on "cuda" (113 fallbacks to the route a call), 2 requests of 4 new
      tokens, twice, graphed, with no integer-GEMM kernel in any count or
      decode graph.  Every path before these takes no ATen route (every
      counted run's routes are read).

jamba-v0.1-52b (mamba, attention and MoE: models/ssm.py and the port-only
selective-scan kernel kernels/ssm_scan.py on csrc/ssm_scan.cu) adds:

  3.  the fused kernel at jamba's shapes (mm1 at its mamba projections:
      in_proj 4096 x 16384, x_proj 8192 x 288, dt_proj 256 x 8192, out_proj
      8192 x 4096; at its attention projections and dense MLP; kmm2 at its
      router, 4096 x 16, and its untied lm_head, 4096 x 65536; M 1-64) and
      the grouped kernel in mm1 at its expert GEMMs (16 experts of 4096 x
      14336 and 14336 x 4096, top-2: decode on 1 and 4 lanes, a 64-token
      prefill at capacity 16, the edge case), torch.equal to their plain
      versions;
  3s. the selective-scan kernel against its plain version (``allclose``,
      rtol = atol = SSM_TOL, on y and the final state): decode on 1, 2 and
      4 lanes from a nonzero state, a 64-token prefill with a mask, bf16
      and fp32 z, d_state 16 at d_inner 8192 and the smoke model's d_state
      8; timed against its bound and plain version at decode on 4 lanes and
      the 64-token prefill;
  4.  the jamba smoke model in float32, card against CPU;
  5n. jamba-v0.1-52b under mixed on leaf-wise records only (init peak
      gated like nemotron's): 176 fused mm1 + 17 fused kmm2 + 48 grouped
      mm1 + 28 selective scans + 65 norm launches a prefill and a decode
      step, the same twice, graphed, profiled at 4 lanes, its byte bound
      on every record and on the experts the profiled steps routed;
  5b. one full-width mamba block on those records, 120 tokens from a
      zero state in chunks of CHUNK against one shot: output, conv tail
      and SSM state torch.equal (the gate); and the whole model's chunked
      prefill against a single shot, reported (tokens, logits and the MoE
      dispatch's dropped pairs in each), not gated, since the MoE capacity
      of a chunk is taken from the chunk's length, by the reference's own
      rule.

llava-next-mistral-7b (a vision prefix of projected patch embeddings) and
seamless-m4t-medium (an encoder-decoder on projected fbank frames) add:

  3.  the fused kernel at their shapes: mm1 at llava's projector over 2 x
      576 patch embeddings (1024 x 4096, 4096 x 4096) and Mistral's
      attention and MLP at decode on 4 lanes (4096 x 4096, 4096 x 1024,
      4096 x 14336, 14336 x 4096), at seamless's projector over 2 x 512
      frames (160 x 1024) and its attention, memory and MLP GEMMs (1024 x
      1024, 1024 x 4096, 4096 x 1024) at M 2 and 1024; kmm2 at llava's
      untied lm_head (4096 x 32256) and seamless's tied one (1024 x
      256512), M 1, 2 and 4; torch.equal to their plain versions;
  4.  both smoke models in float32, card against CPU (llava with a vision
      prefix; seamless through lm.prefill and SMOKE_STEPS decode steps on
      its memory, which the engine refuses);
  5n. llava under mixed on leaf-wise records, served text-only through the
      engine: 224 fused mm1 + 1 fused kmm2 + 65 norm launches a prefill
      and a decode step, with every gate of 5n;
  5v. llava with its vision prefix on those records (2 streams of 576
      patch embeddings and 16 tokens, 16 greedy decode steps, through
      lm.prefill / lm.decode_step): a prefill launches the projector's 2
      mm1 beside the text call's, a step the text call's; a second run's
      tokens torch.equal; decode against a fresh prefill of the sequence
      extended by one token, at the first and last step (tokens equal
      where the prefill's top-2 gap exceeds CONTINUE_GAP, max |diff|
      reported);
  5e. seamless under mixed on leaf-wise records (2 streams of 512 frames
      and 4 decoder tokens, 16 greedy decode steps on the memory): 194
      mm1 + 1 kmm2 + 62 norm launches a prefill (the projector, the
      encoder, the memory's projections, the decoder), 96 mm1 + 1 kmm2 +
      37 norms a step; the repeat and continuation gates of 5v; four
      decode steps profiled (device busy ms, kernels a step) beside the
      step's byte bound.

Observability (repro_torch/obs: the metrics registry, the span tracer,
the analytic traffic model) adds:

  5o. the launcher on the card at full width (llama3.2-1b, mixed, 4
      requests) with --metrics-out / --trace-out: both files parse, the
      snapshot holds every metric name of the reference the port registers
      (OBS_METRICS) and the trace the engine_step, decode_step,
      prefill_chunk, request and run_plan spans; llama on mixed records
      from the leaf-wise init, warmed, graphed, with metrics and tracing
      enabled before the build, then the same requests with them off:
      greedy streams equal, the exact launch and graph-node gates of
      5g/5p in both, the obs-off graphs' kernel nodes equal to 5p's and
      the obs-on ones too, admitted = finished = TTFT count = requests,
      decode-step count = lane-width count = decode steps, retraces =
      n_traces(); decode-step ms on and off reported, not gated; granite on
      records the same way, its ``repro_moe_tokens_per_expert`` count per
      layer equal to what the host dispatched — (prefills + graph replays
      x width) x experts x periods — which only the decode graphs' replays
      can reach; and, beside the launcher, Nsight Compute asked for the
      DRAM byte counters (reported, not gated: the measured traffic is not
      ported while they cannot be read).

Training (launch/steps.py, train/{optim,loop,checkpoint}.py, the STE
cores of quant/qmatmul.py, the norm's and the LoRA matmul's backwards in
kernels/rowinv.py and, since recurrent training, the backward kernels of
csrc/wkv.cu and csrc/ssm_scan.cu) adds:

  3w. (its backward half) the WKV backward kernel against its plain
      reverse sweep (``allclose`` at rtol BWD_TOL, atol BWD_TOL x each
      gradient's largest entry, on dr, dk, dv, dw and du) at rwkv6-3b's
      train microbatch (2 x 256, 40 heads of 64) and D = 16, 8 and 4, a
      second launch torch.equal to the first; timed beside its bound (the
      function's own bytes and operations), this design's bound with its
      state scratch written and read (``scratch_bound_ms``) and its plain
      version;
  3s. (its backward half) the scan's backward kernel the same way (dx,
      d delta, db, dc, dz in bf16 within one ulp, da, d d_skip) at
      jamba's train microbatch (1 x 256, d_inner 8192, d_state 16, bf16
      z) and d_state 8 and 4;

  5t. the smoke llama, granite, rwkv6-3b and jamba in float32 under
      mixed: loss and every gradient leaf, card against CPU
      (TRAIN_SMOKE_LOSS_RTOL, TRAIN_SMOKE_TOL); full-width
      llama3.2-1b under mixed (seq 256, global batch 8, its 2
      microbatches, fp32 params from a seeded generator, the bf16 compute
      copy): step 1's loss and gradients with the kernels against the
      same step with the kernels' plain versions on the card
      (TRAIN_PLAIN_LOSS_RTOL, TRAIN_PLAIN_GRAD_RTOL), every leaf's
      gradient finite and nonzero (every ln scale and embed too), then 4
      AdamW steps through ``train.loop.run_training`` with exactly the
      derived launches (``train_launches``: each period's GEMMs and norms
      twice a microbatch under remat, the head's GEMM twice a loss
      chunk) and every quantized GEMM on the kernels, step ms, tokens/s
      and peak memory reported; at TRAIN_RESTART_PERIODS of its periods,
      2 steps, the run's AsyncCheckpointer save, a fresh run resuming for
      2 more: params and optimizer state torch.equal to 4 straight steps
      (under
      ``torch.use_deterministic_algorithms``, ``CUBLAS_WORKSPACE_CONFIG``
      set before CUDA starts); granite-moe-3b-a800m at full width, 4 of
      its 32 periods, 8 microbatches: the ragged STE at its expert shape
      (dead rows get exactly zero dx), step 1 against the plain versions,
      every leaf's gradient nonzero, 2 counted steps with the grouped
      kernel carrying every expert GEMM; rwkv6-3b at full width, 4 of
      its 32 periods (TRAIN_RWKV_PERIODS: the whole model would need ~85
      GB, and 24, then 16 and 8, took the script past its time limit), 4
      microbatches: step 1 with every launch (the LoRA products,
      the WKV forward and backward too) against its plain version and
      against the step on the plain versions, every leaf's gradient (u,
      w0, mix, the LoRA and ln_x too) finite and nonzero, the same step
      under quant none, kernels against plain versions, in bf16 (the
      TRAIN_PLAIN_* gates) and fp32 compute (TRAIN_FP32_*: no code flip and
      no bf16 rounding carries a last bit there), and the kernels' step
      with the WKV output one ulp off (reported), 2 counted steps
      with exactly the derived launches (per rwkv layer and microbatch
      under remat 7 GEMMs, 2 LoRA products, 3 norms and the WKV forward
      twice, its backward once); one full-width jamba mamba layer's
      ``mamba_apply`` forward and backward at seq 256 (no whole jamba step
      trains on one card: one 8-layer period holds ~12.8 B params, ~400 GB
      of training state), every launch against its plain version, the
      gradients against the plain versions', exact launches, ms and peak
      memory.

Distributed serving (repro_torch/dist, launch/mesh.py, the engine's
``mesh=``; the machine holds one H100, so no run spans cards) adds:

  5m. (a) a world of one on NCCL (``single_device_mesh()``): full-width
      llama3.2-1b on mixed records from the leaf-wise init, 4 requests
      (8, 64, 23 and 41 tokens, MESH_NEW new), the engine without a mesh
      and with ``mesh=``, each warmed and graphed under the exact launch
      and graph-node gates: tokens and every sampled logits row
      torch.equal; and an NCCL all-gather and all-reduce captured in a
      CUDA graph and replayed (no rule shards anything on 1x1, so the
      engine's graphs hold no collective);
      (b) MESH_RANKS ranks on gloo sharing cuda:0 (a MESH_SHAPE mesh),
      started by this script (``--mesh-rank``) before (a), each
      loading the built libraries (a rank that finds one missing fails: no
      rank builds): which gloo collectives run on CUDA tensors, failing
      where one of ``GLOO_CUDA_OPS`` does not in a dtype the port sends it
      (bf16 weight gathers and the fp32 reduce-scatter of training among
      them; the point-to-point ops, which abort a process on CUDA tensors,
      probed by two processes of their own, ``--gloo-p2p-probe``); the
      sharded fused
      kernel at llama's wi (mm1, w=8) and tied lm_head (kmm2, w=12) at M=4
      on records torch.equal to the unsharded kernel on the same rank, one
      launch a rank; the K-sharded staged mm1 at wi equal to the int64
      oracle; granite's grouped experts (E=40, 1536 x 512, ragged counts)
      torch.equal to unsharded; the ring all-gather matmul (its hops through
      the host) at w=8 equal to the unsharded integer product; then the
      full-width llama3.2-1b engine at MESH_PERIODS of its 16 periods on
      mixed records with ``mesh=`` (eager: gloo cannot be captured), built
      from the records of the unsharded engine the parent serves at that
      depth (graphed, exact launches), which it saves to the host
      (MESH_PARAMS; a ready file releases the ranks) and each rank maps
      from there, so the card receives a rank's blocks alone; each rank
      holding exactly its ``leaf_spec`` block of every record (compared
      with the whole), exactly 28 mm1 + 1 kmm2 + 9 norm launches a model
      call on each rank, tokens torch.equal to that unsharded engine;
      per-rank resident bytes, the rank's peak device memory at load and
      over serving, launches and host-clock step ms reported (a transport
      check on one card, not a multi-card number), and the logits' distance
      from the unsharded engine's.
      MoE (granite-moe-3b-a800m, expert-parallel): (a) also full-width,
      full-depth granite on mixed records the same way (128 mm1 + 33 kmm2
      + 96 grouped mm1 + 65 norms a model call, exact, graph nodes too),
      tokens and every sampled logits row torch.equal with and without
      ``mesh=``; (b) the same rank processes, after llama, granite at
      MESH_MOE_PERIODS of its 32 periods on the 2x2 mesh, 20 of the 40
      experts a model rank, from the records of the unsharded engine the
      parent serves at that depth (graphed, exact launches; saved to
      MESH_MOE_PARAMS): each rank holding exactly its ``leaf_spec`` block
      of every record, exact launches a model call, every grouped launch
      over 20 experts, tokens torch.equal to that unsharded engine;
      per-rank resident bytes, the ranks' peak and host-clock step ms
      reported.
      The recurrent blocks (c): (a) also full-width, full-depth rwkv6-3b
      and jamba-v0.1-52b at MESH_JAMBA_PERIODS of its 4 periods on mixed
      records, 2 requests of 8 and 64 tokens, with and without ``mesh=``
      the same way (exact launches and graph nodes, WKV and the scan
      among them; tokens and every sampled row torch.equal); (b) the same
      rank processes, after granite, rwkv6-3b at MESH_RWKV_PERIODS periods
      and jamba at MESH_JAMBA_PERIODS on the 2x2 mesh, each rank drawing
      its blocks of the records leaf by leaf (``lm.init_params(mesh=)``,
      the ranks in turn; resident bytes those the abstract specs place),
      against the unsharded engine at that depth (rwkv's served here after
      (a), jamba's (a)'s own): exact launches a model call, every WKV launch
      over 20 of the 40 heads, every scan over 4096 of the 8192 channels,
      every grouped launch over 8 of the 16 experts, tokens and every
      logits row torch.equal; per-rank resident bytes, peak and step ms
      reported.

Training under a mesh (``train.loop.run_training(mesh=...)``) adds 5d:
its (a) runs before 5m, its (b) beside 5m's ranks once they have loaded
their last large model (jamba's), after 5m (a) (both phases' ranks are
gloo transport checks on this card, and neither waits on the other):

  5d. (a) a world of one on NCCL: full-width, full-depth llama3.2-1b under
      mixed (5t's seq 256, global batch 8, 2 microbatches),
      TRAIN_MESH_STEPS AdamW steps through ``run_training`` with no mesh
      and with ``mesh=``, under deterministic algorithms: losses and every
      leaf of params, mu, nu and step torch.equal, launches exact
      (``train_launches``) and equal;
      (b) MESH_RANKS gloo ranks sharing cuda:0 (``--train-mesh-rank``,
      started first: they join their mesh and wait) on a MESH_SHAPE mesh,
      llama at TRAIN_MESH_PERIODS periods, the same batch: the unsharded
      step 1 and its update at that depth here (saved for the ranks, which
      it releases); on each rank what
      ``run_training``'s loop
      runs a step — the seeded init's blocks, step 1 and its AdamW update
      (each rank's blocks of the gradients, params, mu and nu, and its grad
      norm, held to the unsharded step's, gates below), the
      AsyncCheckpointer's save of step 1 (each leaf gathered to rank 0),
      step 2 through ``make_train_step`` — each step's launches exactly the
      unsharded step's (every rank runs every GEMM on its block), every
      rank's losses equal, step 1's within TRAIN_MESH_LOSS_RTOL of the
      unsharded, resident params + mu + nu at most TRAIN_MESH_RESIDENT of
      the unsharded and equal to what the abstract specs place; the
      checkpoint loaded here with no mesh, each rank's block of every leaf
      equal (SHA-256) to what the rank held; step ms (host clock: a
      transport check) and each rank's device peak reported.  No run
      spans cards: no gradient collective ran across cards, or under NCCL
      with more than one rank.
      MoE: (a) also granite at TRAIN_GRANITE_PERIODS periods (5t's depth),
      TRAIN_MESH_STEPS steps, no mesh against the world of one under
      deterministic algorithms, every leaf torch.equal, launches exact;
      (b) the same rank processes, after llama, granite at
      TRAIN_MESH_MOE_PERIODS periods with TRAIN_MESH_MOE_MICRO
      microbatches of 2 sequences (its 8 microbatches of one sequence do
      not split over 2 data ranks; the unsharded step runs the same),
      against the unsharded step 1 (``step1_moe.pt``): the gates above,
      the expert leaves' gradients within TRAIN_MESH_MOE_GRAD_TOL, every
      layer's load-balance loss a microbatch within TRAIN_MESH_MOE_AUX_RTOL
      (its means over the global microbatch), every grouped launch over 20
      experts, the checkpoint equal to every rank's blocks; each model's
      gates as soon as its ranks are done (llama's while granite trains).
      The recurrent blocks (c): (a) also rwkv6-3b at
      TRAIN_MESH_RWKV_PERIODS periods, no mesh against the world of one,
      every leaf torch.equal; (b) after granite, rwkv6-3b at that depth
      (its 4 microbatches of 2 sequences, one a data rank) against the
      unsharded step 1 (``step1_rwkv.pt``): the gates above, every WKV and
      WKV backward launch over 20 of the 40 heads; then one full-width
      jamba mamba layer, forward and backward in fp32 on 2 sequences of
      TRAIN_SEQ (one a data rank), against the unsharded layer on the same
      rank: y and every gradient leaf within BWD_TOL of its largest entry,
      4 mm1, one ``ssm_scan`` and one ``ssm_scan_bwd`` over 4096 of the
      8192 channels a rank.

The line before the last is a JSON object with one entry per kernel (the
five TPU kernels' counterparts, and the port-only rowinv_matmul,
rowinv_norm, ssm_scan, wkv_bwd and ssm_scan_bwd); the last line is
``{"ok": true, "device": {...}}``.  The
details go to
``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# qwen3-moe-30b-a3b: attention at w=8 (wq 2048 x 4096, wk / wv 2048 x
# 512, wo 4096 x 2048), the router (2048 x 128) and the untied lm_head
# (vocab 151936 padded to 152064) at w=12
QWEN_MM1_KN = [(2048, 4096), (2048, 512), (4096, 2048)]
QWEN_KMM2_KN = [(2048, 128), (2048, 152064)]
# jamba-v0.1-52b: the mamba projections at w=8 (in_proj 4096 x 16384,
# x_proj 8192 x 288, dt_proj 256 x 8192, out_proj 8192 x 4096), attention
# (wq / wo 4096 x 4096, wk / wv 4096 x 1024) and the dense MLP (4096 x
# 14336, 14336 x 4096); the router (4096 x 16) and the untied lm_head
# (4096 x 65536) at w=12
JAMBA_MM1_KN = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
                (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
JAMBA_KMM2_KN = [(4096, 16), (4096, 65536)]
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
# qwen3-moe-30b-a3b's expert GEMMs at w=8: (K, N) of wi/wg and of wo, 128
# experts top-8; capacity 8 at decode and at every prompt bucket up to 64
# tokens (64 x 8 x 1.25 / 128 = 5, floor 8), so a 64-token prompt drops.
QWEN_GROUPED_KN = [(2048, 768), (768, 2048)]
QWEN_EXPERTS, QWEN_TOP_K = 128, 8
QWEN_GROUPED_CASES = [("decode W=1", 8, 8, 1, 1), ("decode W=4", 32, 8, 4, 1),
                      ("prefill S=64", 8, 8, 1, 64), ("edge", 32, 8, 4, 0)]
# jamba-v0.1-52b's expert GEMMs at w=8: 16 experts of 4096 x 14336 (wi,
# wg) and 14336 x 4096 (wo), top-2; capacity 8 a lane at decode and 16 at a
# 64-token prompt (64 x 2 x 1.25 / 16 = 10, rounded up to 16).
JAMBA_GROUPED_KN = [(4096, 14336), (14336, 4096)]
JAMBA_EXPERTS, JAMBA_TOP_K = 16, 2
JAMBA_GROUPED_CASES = [("decode W=1", 8, 8, 1, 1),
                       ("decode W=4", 32, 8, 4, 1),
                       ("prefill S=64", 16, 16, 1, 64),
                       ("edge", 32, 8, 4, 0)]

# llava-next-mistral-7b: the vision projector at w=8 over 2 streams of 576
# patch embeddings (frontend.w1 1024 x 4096, w2 4096 x 4096), Mistral's
# attention (wq / wo 4096 x 4096, wk / wv 4096 x 1024) and MLP (4096 x
# 14336, 14336 x 4096) at decode on 4 lanes; its untied lm_head (vocab
# 32000 padded to 32256) at w=12.  seamless-m4t-medium: the audio
# projector's frontend.w1 (160 x 1024: K inside one padded block of 256)
# over 2 streams of 512 frames, its 1024 x 1024 attention and memory
# projections and its MLP (1024 x 4096, 4096 x 1024), at decode on 2 lanes
# and over the encoder's 2 x 512 frames; the tied lm_head (embed.T, vocab
# 256206 padded to 256512) at w=12 — quantized per call from the K-major
# view and made contiguous before the launch, as qmatmul does.  Each
# lm_head at M 1, 2 and 4.
LLAVA_MM1 = [(2 * 576, 1024, 4096), (2 * 576, 4096, 4096)] + [
    (4, k, n) for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                           (14336, 4096))]
SEAMLESS_MM1 = [(2 * 512, 160, 1024)] + [
    (m, k, n) for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))
    for m in (2, 2 * 512)]
ENCDEC_KMM2_KN = [(4096, 32256), (1024, 256512)]
ENCDEC_KMM2_ROWS = [1, 2, 4]

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
# The selective-scan kernel (port-only, csrc/ssm_scan.cu): tolerance
# against its plain version (expf and SiLU's division are not ATen's),
# jamba's widths, and its check cases: (label, B, S, d_inner, d_state,
# nonzero initial state, mask, z dtype, timed).  The masked prefill's
# rows end in pads, as a bucketed prompt's do.
SSM_TOL = 1e-5
SSM_DI, SSM_DS = 8192, 16
SSM_CASES = (
    [(f"decode W={w}", w, 1, SSM_DI, SSM_DS, True, False, "bfloat16",
      w == 4) for w in (1, 2, 4)]
    + [("prefill S=64 masked", 1, 64, SSM_DI, SSM_DS, False, True,
        "bfloat16", True),
       ("prefill S=64 x4 masked", 4, 64, SSM_DI, SSM_DS, True, True,
        "bfloat16", False),
       ("decode W=4 fp32 z", 4, 1, SSM_DI, SSM_DS, True, False, "float32",
        False),
       ("smoke d_state=8", 2, 16, 128, 8, True, True, "float32", False),
       ("S=37 d_inner=200", 3, 37, 200, 16, True, True, "bfloat16",
        False)])
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
# The backward kernels (training, port-only: the TPU kernel has none, the
# reference differentiates its jnp scans).  Their plain versions are
# explicit reverse sweeps in ATen, the same fp32 products summed in other
# orders, so each gradient is held allclose at rtol BWD_TOL with an atol of
# BWD_TOL times its largest entry (dz in bf16: rtol 2^-7, one bf16 ulp);
# written before the first card run.  WKV cases (label, B, S, H, D, timed):
# rwkv6-3b's train microbatch (2 x 256, 40 heads of 64) and the smaller
# head sizes; scan cases (label, B, S, d_inner, d_state, z dtype, timed):
# jamba's train microbatch (1 x 256, d_inner 8192, d_state 16, bf16 z) and
# the smaller state sizes.
BWD_TOL = 1e-4
WKV_BWD_CASES = [("rwkv6-3b train", 2, 256, WKV_HEADS, WKV_D, True),
                 ("smoke D=16", 2, 32, 4, 16, False),
                 ("D=8", 3, 20, 5, 8, False), ("D=4", 2, 37, 5, 4, False)]
SSM_BWD_CASES = [("jamba train", 1, 256, SSM_DI, SSM_DS, "bfloat16", True),
                 ("d_state=8", 2, 64, 512, 8, "bfloat16", False),
                 ("d_state=4 fp32 z", 2, 37, 200, 4, "float32", False)]
# Selective-scan launches per prefill and per decode step: one a mamba
# layer (jamba: 7 of every 8, 28 of 32).
SSM_PER_CALL = {"jamba-v0.1-52b": 28}
# Phase 5b: the tokens of the block-level chunked gate (chunks of CHUNK;
# the last chunk and the single shot padded to a multiple of 8, as the
# engine pads them).
MAMBA_GATE_TOKENS = 120

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
# qwen3-moe-30b-a3b (MoE, 48 layers): 4 attention projections a layer at
# w=8 (192 mm1), the w=12 router a layer and the untied lm_head (49 kmm2,
# 2048 x 128 and 2048 x 152064), and the 3 expert GEMMs a layer as grouped
# mm1 launches (144; 128 experts top-8, each expert C = lanes x 8 rows at
# decode); only on leaf-wise records (122.1 GB in fp32).  jamba-v0.1-52b
# (32 layers: 28 mamba, 4 attention; 16 MoE, 16 dense MLP): 4 mamba
# projections a mamba layer, 4 attention projections an attention layer
# and 3 dense MLP GEMMs a dense layer at w=8 (112 + 16 + 48 = 176 mm1), the
# w=12 router of each MoE layer and the untied lm_head (17 kmm2, 4096 x 16
# and 4096 x 65536), the 3 expert GEMMs of each MoE layer as grouped mm1
# launches (48; 16 experts top-2) and a selective scan a mamba layer
# (SSM_PER_CALL); only on leaf-wise records (206 GB in fp32).
# llava-next-mistral-7b served text-only, as the reference's engine serves
# it: Mistral's 32 layers with 7 w=8 projections each and the untied w=12
# lm_head (4096 x 32256); only on leaf-wise records (29.1 GB in fp32),
# then phase 5v on them.  The last item: grouped launches a call.
DENSE_PATHS = [("gemma-2b", {"mm1": 126, "kmm2": 1}, True, {}),
               ("stablelm-12b", {"mm1": 280, "kmm2": 1}, False, {}),
               ("nemotron-4-15b", {"mm1": 192, "kmm2": 1}, False, {}),
               ("qwen3-moe-30b-a3b", {"mm1": 192, "kmm2": 49}, False,
                {"mm1": 144}),
               ("jamba-v0.1-52b", {"mm1": 176, "kmm2": 17}, False,
                {"mm1": 48}),
               ("llava-next-mistral-7b", {"mm1": 224, "kmm2": 1}, False,
                {})]
DENSE_PROMPTS = (8, 64, 23, 41)
# Phase 4's decode steps on an encoder-decoder's memory.
SMOKE_STEPS = 5
# Phase 5v, llava with its vision prefix on the records of 5n: 2 streams,
# each 576 seeded patch embeddings of dimension 1024 and 16 text tokens,
# then 16 greedy decode steps; a prefill launches the projector's 2 mm1
# beside a text call's 224 mm1 + 1 kmm2 and 65 norms, a decode step a text
# call's.  Phase 5e, seamless-m4t-medium on leaf-wise records: 2 streams of
# 512 seeded fbank frames of dimension 160 (about 10 s of speech at 50
# frames a second), 4 decoder prompt tokens, 16 greedy decode steps; a
# prefill launches the projector's 2 mm1, 12 encoder layers x 6 (wq, wk,
# wv, wo, wi, wo), the memory's wk / wv in 12 decoder layers and the
# decoder's 12 x 8 (4 self-attention, cross-attention wq / wo, 2 MLP):
# 194 mm1, and the tied w=12 lm_head (1 kmm2); its norms are the
# encoder's 12 x 2 + enc_ln_f and the decoder's 12 x 3 (ln1, lnx, ln2) +
# ln_f; a decode step launches the decoder's.  Both repeat their run
# (tokens torch.equal) and check decode against a fresh prefill of the
# sequence extended by one token: tokens equal wherever the prefill's
# top-2 gap exceeds CONTINUE_GAP (twice test_torch_dense_configs.py's bf16
# tolerance), the largest |logit difference| reported.
VISION_ARCH, ENCDEC_ARCH = "llava-next-mistral-7b", "seamless-m4t-medium"
VISION_STREAMS, VISION_TEXT, VISION_NEW, VISION_MAX_SEQ = 2, 16, 16, 640
VISION_PREFILL = {"dense_mm1": 226, "dense_kmm2": 1, "rowinv_norm": 65}
VISION_STEP = {"dense_mm1": 224, "dense_kmm2": 1, "rowinv_norm": 65}
ENCDEC_STREAMS, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 2, 512, 4, 16
ENCDEC_MAX_SEQ = 32
ENCDEC_PREFILL = {"dense_mm1": 194, "dense_kmm2": 1, "rowinv_norm": 62}
ENCDEC_STEP = {"dense_mm1": 96, "dense_kmm2": 1, "rowinv_norm": 37}
CONTINUE_GAP = 0.25
ENCDEC_PROFILED_STEPS = 4
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


# Phase 3k, the ATen route (the reference's "xla" backend: the KMM digit
# recursion of core/kmm.py on exact ATen leaf products, float64 on the
# card): kmm_n and mm_n at llama's wi at M 4 and 64, each width with
# select_mode's digits; the quantized matmul on "aten"; Strassen's two
# variants against xla_ref; the FFIP literal.  Each card result is held to
# the same call on the CPU (int64 leaves), torch.equal, on ATEN_CPU_COLS of
# B's columns (its first and last halves: an output column depends on its
# own B column alone, and the CPU's int64 product takes ~1 s a leaf at
# M=64 over all 8192).
ATEN_KN = (2048, 8192)
ATEN_ROWS = [4, 64]
# the rows timed (the comparisons run at every ATEN_ROWS), each call over
# ATEN_ITERS calls, or ATEN_FEW_ITERS where its host time passes
# ATEN_SLOW_HOST_MS (the sleep lead grows with iterations x host time)
ATEN_TIMED_ROWS = [64]
ATEN_SLOW_HOST_MS = 5.0
ATEN_ITERS = 10
ATEN_FEW_ITERS = 3
ATEN_WIDTHS = [12, 16, 20, 24, 28]
ATEN_QMM_WIDTHS = [8, 12, 28]
ATEN_CPU_COLS = 1024
STRASSEN_SHAPE = (64, 2048, 2048)
STRASSEN_WIDTHS = [8, 12]
FFIP_SHAPE = (8, 64, 8)
# Phase 5a, serving on the ATen route: (arch, policy, backend, the
# quantized GEMM routes a prefill and a decode step).  llama under mixed on
# "aten" (the reference's default backend): every GEMM on the route; llama
# with every site at w=28 on "cuda": depth-3 digits, outside the fused
# windows, every GEMM on the route as a fallback.  2 requests, 4 new
# tokens, twice.
ATEN_PATHS = [("llama3.2-1b", "mixed", "aten", {("aten", "aten"): 113}),
              ("llama3.2-1b", "w28", "cuda",
               {("cuda", "aten_fallback"): 113})]
# "aten" against "cuda" on llama's mixed weights: each prefill logit within
# one bfloat16 ulp of the other route's (the w=12 lm_head is the only fp32
# combine; tests/test_torch_aten_route.py).
ROUTES_RTOL = 2.0 ** -7
# Phase 5m: distributed serving on the card.  (b)'s mesh, its ranks (all on
# cuda:0, gloo), the requests' new tokens, the kernel-level checks' rows,
# llama's wi and its tied lm_head (N = the padded vocab) with their widths,
# granite's experts (E, K, N, capacity, segments), and the seconds the
# parent waits for the ranks.
MESH_ARCH = "llama3.2-1b"
MESH_SHAPE = (2, 2)
MESH_RANKS = 4
MESH_NEW = 4
MESH_ROWS = 4
MESH_DENSE = [("wi", 2048, 8192, 8, "mm1"), ("lm_head", 2048, None, 12,
                                             "kmm2")]
MESH_GROUPED = (40, 1536, 512, 32, 4)
MESH_TIMEOUT = 600
# (a)'s records on the host, for (b)'s ranks to map (removed after).
MESH_PARAMS = ROOT / "build" / "scratch" / "mesh_params.pt"
# (b) serves llama at MESH_PERIODS of its 16 periods (one layer a period,
# so every layer kind), against the unsharded engine the parent serves at
# that depth: at 16 the whole script took 1257.3 s on an NVIDIA H100 80GB
# HBM3 (700 W) whose host ran every other phase 10-40 % slower than
# before (1200 s is its limit), llama's (b) ~24 s of it.
MESH_PERIODS = 4
# Phase 5d: training under a mesh.  (a) full-depth llama, TRAIN_MESH_STEPS
# steps on a world of one (NCCL) against no mesh; (b) MESH_RANKS gloo ranks
# sharing cuda:0 on MESH_SHAPE, llama at TRAIN_MESH_PERIODS of its periods
# (5t's restart-gate depth), TRAIN_MESH_STEPS steps, against the unsharded
# step at that depth.  (b)'s gates, on step 1 against the unsharded step 1
# and its AdamW update: the loss within TRAIN_MESH_LOSS_RTOL, the grad norm
# within TRAIN_MESH_NORM_RTOL (a replicated leaf counted on every rank moves
# it by far more), every gradient leaf within TRAIN_MESH_GRAD_TOL of its
# largest entry; mu (the clipped gradient scaled) and nu (its square) within
# the gates that follow from those two; each param within
# TRAIN_MESH_PARAM_TOL lr (tests/test_torch_train.py's step bound) where the
# unsharded gradient passes 2 TRAIN_MESH_GRAD_TOL of its leaf's largest, so
# that the gradient gate leaves the sign of Adam's first update as it was,
# and within 2 lr (a sign flipped) plus that elsewhere; each rank's params
# + mu + nu at most TRAIN_MESH_RESIDENT of the unsharded.  The bf16 copy's
# gradients round to bf16 in another order than unsharded: a weight's after
# its fp32 sum over the data ranks (one ulp is at most 2^-7 = 7.8e-3 of the
# leaf's largest entry), but also between layers and in the embedding's
# per-rank bf16 scatter-add, roundings that compound, so the gates are
# measured.  On an NVIDIA H100 80GB HBM3 (700 W), init seeds 0, 1, 2 at 2
# periods and seed 0 at 3: gradients 6.07e-3, 6.83e-3, 6.20e-3 and 8.33e-3
# of a leaf's largest entry (gate 1e-2), the grad norm 4.0e-6, 1.2e-6,
# 5.7e-7 and 8.0e-8 relative (gate 1e-5), params 1.19e-3 lr at most (the
# fp32 ulp of a norm scale at 1.0), the loss equal to the bit.
# The unsharded step 1 (step1.pt) and the ranks' checkpoint lie in
# TRAIN_MESH_DIR (removed after).
TRAIN_MESH_STEPS = 2
TRAIN_MESH_PERIODS = 2
TRAIN_MESH_SEED = 0
TRAIN_MESH_LOSS_RTOL = 1e-5
TRAIN_MESH_GRAD_TOL = 1e-2
TRAIN_MESH_NORM_RTOL = 1e-5
TRAIN_MESH_PARAM_TOL = 1e-2
TRAIN_MESH_RESIDENT = 0.3
TRAIN_MESH_TIMEOUT = 600
TRAIN_MESH_DIR = ROOT / "build" / "scratch" / "train_mesh"
# MoE under a mesh (5m and 5d): granite, expert-parallel (its 40 experts
# over the model axis).  5m (a) serves it at full width and depth; (b)
# serves it at MESH_MOE_PERIODS of its 32 periods against the unsharded
# engine the parent serves at that depth, whose records it saves to
# MESH_MOE_PARAMS.  Every period is one layer of one kind (attention and
# MoE), so one period holds every layer kind; 2 is the fewest that also
# shard the stacked routers' period dim over model (the expert rule puts
# it there where model divides it, as at full depth), which the model call
# gathers once (``dist.sharding.periods_whole``).  The cut is the time
# limit's: at full depth the whole script took 1119.8 s on an NVIDIA H100
# 80GB HBM3 (700 W) whose host ran the untouched phases 10-40 % slower
# than before, with rwkv6-3b's 5t at 8 periods.  5d (b) trains it at
# TRAIN_MESH_MOE_PERIODS periods with TRAIN_MESH_MOE_MICRO microbatches of 2
# sequences.  Its step-1 gates are llama's, and besides: every layer's aux
# loss a microbatch within TRAIN_MESH_MOE_AUX_RTOL of the unsharded (the
# global means reorder fp32 sums); the expert leaves' gradients (router,
# wi, wg, wo) within TRAIN_MESH_MOE_GRAD_TOL of their largest entry.  On an
# NVIDIA H100 80GB HBM3 (700 W), init seeds 0, 1, 2: the aux losses equal
# to the bit, the loss 0 to 1.07e-7 relative, the grad norm 6.1e-7 to
# 6.0e-6 (gate 1e-5), the expert leaves 1.8e-3 to 2.9e-3 (their bf16
# copy's ulp after the reordered fp32 sums; gate 5e-3), params 4.1e-4 lr
# at most.  The worst leaf is embed, not an expert: 5.74e-3 at seed 0 but
# 1.013e-2 and 1.015e-2 at seeds 1 and 2, so the 1e-2 gate (llama's, which
# caps it) fails at 2 of 3 seeds.  The gap is the bf16 compute copy's
# rounding, not the mesh's embed or lm_head gradient: --train-mesh-study
# (the same step, the same card) reads every leaf within 9.2e-7 (embed
# 3.9e-7 to 4.7e-7) in fp32 compute without the copy at seeds 0-2, and
# embed 6.4e-3 to 7.6e-3 with the copy at 2 microbatches, where the tied
# table's bf16 gradients round half as often.  The script runs seed 0,
# TRAIN_MESH_SEED, which llama's gates were read at before these.
MESH_MOE_ARCH = "granite-moe-3b-a800m"
MESH_MOE_PARAMS = ROOT / "build" / "scratch" / "mesh_moe_params.pt"
MESH_MOE_PERIODS = 2
TRAIN_MESH_MOE_PERIODS = 2
TRAIN_MESH_MOE_MICRO = 4
TRAIN_MESH_MOE_AUX_RTOL = 1e-6
TRAIN_MESH_MOE_GRAD_TOL = 5e-3
# --train-mesh-study's init seeds (train_mesh_study_models)
TRAIN_MESH_STUDY_SEEDS = (0, 1, 2)
# The recurrent blocks under a mesh (5m (c), 5d (c)): rwkv6-3b's WKV
# recurrence head-parallel (its 40 heads over the model axis, 20 a rank)
# and jamba's mamba conv and scan channel-parallel (d_inner 8192, 4096 a
# rank; its 16 experts expert-parallel, 8 a rank).  5m (a) serves rwkv6-3b
# at full depth and jamba at MESH_JAMBA_PERIODS of its 4 periods (one
# period holds every layer kind: 7 mamba, 1 attention, 4 MoE; ~13 GB of
# the model's 52.7 GB of records) on the world of one, with and without
# mesh=, 2 requests of MESH_RECURRENT_PROMPTS tokens; (b) serves rwkv6-3b
# at MESH_RWKV_PERIODS of its 32 periods (every layer kind) and jamba at
# MESH_JAMBA_PERIODS on the 2x2 gloo ranks against the unsharded engine at
# that depth (jamba's is (a)'s), tokens and every logits row torch.equal.
# No records file: each rank draws its blocks of the records leaf by leaf
# from the generator seeded 0 (lm.init_params(mesh=)), as the parent's
# leaf-wise init draws the whole, the ranks in turn (a leaf is whole on
# the card only while it is drawn).
MESH_RWKV_ARCH = "rwkv6-3b"
MESH_JAMBA_ARCH = "jamba-v0.1-52b"
MESH_RWKV_PERIODS = 2
MESH_JAMBA_PERIODS = 1
MESH_RECURRENT_PROMPTS = (8, 64)
MESH_RECURRENT = (("rwkv", MESH_RWKV_ARCH, MESH_RWKV_PERIODS),
                  ("jamba", MESH_JAMBA_ARCH, MESH_JAMBA_PERIODS))
# 5m (d), the prefix cache under a mesh: llama at MESH_PERIODS and rwkv6-3b
# at MESH_RWKV_PERIODS on records drawn leaf by leaf, prefill chunks of
# PREFIX_CHUNK, the prefix cache on, 4 slots (2 a data rank);
# PREFIX_REQUESTS greedy prompts of PREFIX_LENS tokens whose first
# PREFIX_SHARED are shared, PREFIX_NEW new tokens each.  Snapshots sit at
# 64 tokens (lcm(page 64, chunk 32, bucket 8)): the four requests admitted
# first miss, each later one restores its data rank's snapshot.  (a) the
# unsharded engine against the world of one (NCCL, graphed), torch.equal;
# (b) on the 2x2 ranks after (c), tokens and every row of a request's data
# rank torch.equal to (a)'s unsharded engine, a hit on every data rank,
# the hits and misses adding up to its.
MESH_PREFIX = (("prefix_llama", MESH_ARCH, MESH_PERIODS),
               ("prefix_rwkv", MESH_RWKV_ARCH, MESH_RWKV_PERIODS))
PREFIX_CHUNK, PREFIX_REQUESTS, PREFIX_SHARED, PREFIX_NEW = 32, 8, 80, 8
PREFIX_LENS = (90, 120)
# 5m (d), the front ends on the 2x2 ranks after the prefix cache: llava at
# 2 of its 32 periods (2 streams of 576 patch embeddings and MESH_VISION_TEXT
# tokens) and seamless at 2 + 2 of its 12 + 12 (2 streams of
# MESH_ENCDEC_FRAMES frames and MESH_ENCDEC_PROMPT tokens), records drawn
# leaf by leaf, through lm.prefill and MESH_FRONT_NEW greedy decode_steps
# on each data rank's stream; its tokens and logits rows torch.equal to
# the unsharded calls at that depth, which (a) makes; launches exact.
# (what, arch, periods, encoder periods)
MESH_FRONTENDS = (("vision", VISION_ARCH, 2, 0), ("encdec", ENCDEC_ARCH, 2, 2))
MESH_VISION_TEXT, MESH_ENCDEC_FRAMES, MESH_ENCDEC_PROMPT = 16, 512, 4
MESH_FRONT_STREAMS, MESH_FRONT_NEW = 2, 4
# 5m (d)'s logits rows, which the ranks write and the parent compares (too
# large for chiprun_out/; removed after the gates)
MESH_ROWS_DIR = ROOT / "build" / "scratch" / "mesh_rows"
# 5d (c): (a) rwkv6-3b at TRAIN_MESH_RWKV_PERIODS, TRAIN_MESH_STEPS steps,
# no mesh against the world of one, deterministic; (b) the same depth on
# the 2x2 gloo ranks, its 4 microbatches of 2 sequences (one a data rank),
# against the unsharded step 1 under llama's gates, every WKV and WKV
# backward launch over 20 heads; and one full-width jamba mamba layer (5t's
# block) fwd + bwd on 2x2, 2 sequences of TRAIN_SEQ (one a data rank),
# against the unsharded block on the same rank: y and every gradient within
# BWD_TOL of the largest entry.  The block runs in fp32 compute without
# the bf16 copy: the mesh reorders the fp32 sums of dW and dx, and a bf16
# gradient would round those reorderings to whole ulps (2^-8 of an entry).
TRAIN_MESH_RWKV_PERIODS = 2
# Phase 5d (d): llava and seamless (its encoder too) at
# TRAIN_MESH_FRONT_PERIODS periods, at most TRAIN_MESH_FRONT_MICRO
# microbatches, 5t's batch of TRAIN_SEQ text tokens (after llava's 576
# patch embeddings; beside seamless's TRAIN_SEQ frames): (a) on the world
# of one against no mesh, torch.equal; (b) in the --train-mesh-rank
# processes after rwkv, step 1 alone (TRAIN_MESH_STEP1_ONLY) against the
# unsharded step: its loss torch.equal to the unsharded loss, every
# gradient under 5d (b)'s gate, the grad norm within
# TRAIN_MESH_FRONT_NORM_RTOL, and mu, nu and params under the gates that
# follow (5d (b)'s) for the leaves of TRAIN_MESH_UPDATE_LEAVES (the
# projector, the encoder and the cross-attention): the unsharded step-1
# file keeps the update of those alone, since the decoder's and the
# tables' in fp32 (llava's 2.9 GB a part) would pass the machine's budget
# of disk writes, and 5d (b)'s llama gates that code on those leaves.  No
# checkpoint (that budget too; the checkpoint of the projector and
# encoder leaves is held on the CPU, tests/test_torch_frontend_mesh.py).
# The grad-norm gate is read over --train-mesh-study's init seeds, as
# llama's, granite's and rwkv's were: on an NVIDIA H100 80GB HBM3 (700 W),
# seeds 0, 1, 2 read 9.63e-6, 3.01e-6, 1.19e-5 (llava) and 1.22e-5,
# 4.23e-6, 7.84e-6 (seamless), past llama's 1e-5 and spread 4x, so the
# gate is 4x their largest; on the front-end leaves gradients and mu at
# most 7.14e-3, nu 9.98e-3, params 2.76e-3 lr where the sign is safe.
TRAIN_MESH_FRONT_PERIODS = 2
TRAIN_MESH_FRONT_MICRO = 4
TRAIN_MESH_STEP1_ONLY = ("vision", "encdec")
TRAIN_MESH_FRONT_NORM_RTOL = 5e-5
TRAIN_MESH_UPDATE_LEAVES = ("/frontend/", "/encoder/", "/enc_ln_f/",
                            "/xattn/", "/lnx/")


def front_update_leaf(key: str) -> bool:
    """Whether 5d (d)'s step-1 file keeps ``key``'s update (params, mu,
    nu): a leaf under a name of TRAIN_MESH_UPDATE_LEAVES."""
    return any(k in f"/{key}" for k in TRAIN_MESH_UPDATE_LEAVES)


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
              + QWEN_MM1_KN for m in ROWS]
             + [("kmm2", 12, m, k, n) for k, n in KMM2_KN + GRANITE_KMM2_KN
                + QWEN_KMM2_KN + JAMBA_KMM2_KN for m in ROWS]
             + [("mm1", 8, m, k, n) for k, n in JAMBA_MM1_KN for m in ROWS]
             + [("mm1", 8) + RAGGED, ("kmm2", 12) + RAGGED]
             + [("mm1", 8, m, k, n) for k, n in RWKV_MM1_KN
                for m in RWKV_ROWS]
             + [("mm1", 8) + shape for shape in MM1_EXTRA]
             + [("kmm2", 12, m, k, n) for k, n in RWKV_KMM2_KN
                for m in RWKV_ROWS]
             + [(mode, w, m, k, n) for mode, w in WIDE_MODES
                for k, n in every_kn for m in ROWS]
             + [(mode, w) + RAGGED for mode, w in WIDE_MODES]
             + [("mm1", 8) + shape for shape in LLAVA_MM1 + SEAMLESS_MM1]
             + [("kmm2", 12, m, k, n) for k, n in ENCDEC_KMM2_KN
                for m in ENCDEC_KMM2_ROWS])
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


def routed_counts(torch, gen, c: int, seg: int, n_seg: int, tokens: int,
                  n_experts: int = N_EXPERTS, top_k: int = TOP_K):
    """(E, n_seg) live rows per expert and segment, as the MoE dispatch
    makes them: each of ``tokens`` tokens per segment picks ``top_k``
    distinct experts at random, and each expert keeps at most ``seg`` of
    them.  ``tokens`` 0 gives the edge case: experts 0-3 get no token, the
    others cycle through seg, seg - 1, 1 and 0 live rows."""
    counts = torch.zeros((n_experts, n_seg), dtype=torch.int64)
    for s in range(n_seg):
        if tokens == 0:
            for e in range(4, n_experts):
                counts[e, s] = (seg, seg - 1, 1, 0)[(e + s) % 4]
            continue
        picks = torch.stack([torch.randperm(n_experts, generator=gen)[:top_k]
                             for _ in range(tokens)])
        counts[:, s] = torch.bincount(picks.reshape(-1),
                                      minlength=n_experts).clamp(max=seg)
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
    """Phase 3 and the per-shape half of phase 6 for the grouped kernel:
    granite's expert GEMMs in every mode, qwen3's at 128 experts and
    jamba's 16 experts of 4096 x 14336 in mm1."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(2)
    rows = []
    models = [("granite", mode, w, GROUPED_KN, GROUPED_CASES, N_EXPERTS,
               TOP_K) for mode, w in [("mm1", 8), ("kmm2", 12)] + WIDE_MODES]
    models.append(("qwen3", "mm1", 8, QWEN_GROUPED_KN, QWEN_GROUPED_CASES,
                   QWEN_EXPERTS, QWEN_TOP_K))
    models.append(("jamba", "mm1", 8, JAMBA_GROUPED_KN, JAMBA_GROUPED_CASES,
                   JAMBA_EXPERTS, JAMBA_TOP_K))
    for model, mode, w, grouped_kn, cases, e, top_k in models:
        _, h, z, _ = fg.resolve(w, mode=mode)
        for k, n in grouped_kn:
            block_k = min(256, 1 << max(3, (k - 1).bit_length()))
            kp = fg.padded_k(k, block_k)
            for label, c, seg, n_seg, tokens in cases:
                a, b = operands(torch, fg, gen, mode, w, (e, c, k), (e, k, n))
                sx = torch.rand((e, c, 1), generator=gen, device=dev) * 1e-3 \
                    + 1e-4
                sw = torch.rand((e, 1, n), generator=gen, device=dev) * 1e-3 \
                    + 1e-4
                counts = routed_counts(torch, cpu_gen, c, seg, n_seg,
                                       tokens, e, top_k).to(dev)
                live = fg.ragged_row_mask(counts, seg, c)[..., 0]
                row = {"model": model, "mode": mode, "w": w, "case": label,
                       "E": e, "C": c,
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
                log(f"  grouped {mode:4s} w={w} E={e:<3d} {label:<13s} "
                    f"C={c:<3d} K={k:<5d} N={n:<5d} live rows "
                    f"{row['live_rows']:<4d} experts "
                    f"{row['live_experts']:<3d} equal | kernel "
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
    """Every kernel wrapper's launch count and the quantized GEMM's route
    counts set to 0."""
    from repro_torch.kernels import rowinv, ssm_scan, wkv_gemm
    from repro_torch.quant import qmatmul
    fg.reset_launches()
    for mod in (wkv_gemm, rowinv, ssm_scan) + staged_modules():
        mod.reset_launches()
    qmatmul.reset_gemm_routes()


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


def ssm_bound_ms(b: int, s: int, di: int, ds: int, z_bytes: int,
                 mask: bool):
    """Least time for one selective scan: x, delta, z, b, c, a, d_skip
    and the mask read once, y written once, the state read and written
    once, at the card's memory rate; or its fp32 operations at the fp32
    peak outside the tensor cores: per (row, channel, step) 5 a state
    (exp, the decay's two products, the input product, the sum) and 2 a
    state for the read-out, and 7 more (delta x, the skip's product and
    add, SiLU's exp, add and division, the gate)."""
    nbytes = (b * s * di * (4 + 4 + z_bytes + 4) + 2 * 4 * b * s * ds
              + 4 * di * (ds + 1) + 2 * 4 * b * di * ds
              + (b * s if mask else 0))
    ops = b * s * di * (7 * ds + 7)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssm_checks(torch):
    """Phase 3s and the scan's half of phase 6: the selective-scan kernel
    against its plain version (allclose within SSM_TOL on y and the final
    state) at every SSM_CASES entry, timed where marked."""
    from repro_torch.kernels import ssm_scan as K
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = []
    for label, b, s, di, ds, warm, masked, zdt, timed in SSM_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, z = rnd(b, s, di), rnd(b, s, di).to(getattr(torch, zdt))
        delta = torch.nn.functional.softplus(rnd(b, s, di) - 2.0)
        bm, cm = rnd(b, s, ds), rnd(b, s, ds)
        a = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device="cuda").repeat(di, 1)
        d_skip = torch.ones(di, device="cuda")
        h0 = (rnd(b, di, ds) * 0.3 if warm
              else torch.zeros((b, di, ds), device="cuda"))
        mask = None
        if masked:
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 device="cuda")
            mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
        h = h0.clone()

        def kernel():
            # the state it leaves stays in h: timed calls carry it on
            return K.ssm_scan(x, delta, bm, cm, z, a, d_skip, h, mask)

        def plain():
            return K.ssm_scan_reference(x, delta, bm, cm, z, a, d_skip, h0,
                                        mask)

        y = kernel()
        y_ref, h_ref = plain()
        torch.cuda.synchronize()
        errs = [(y - y_ref).abs().max().item(),
                (h - h_ref).abs().max().item()]
        what = f"ssm_scan {label} B={b} S={s} di={di} ds={ds} z {zdt}"
        for got, want in ((y, y_ref), (h, h_ref)):
            if got.shape != want.shape or not torch.isfinite(got).all() or \
                    not torch.allclose(got, want, rtol=SSM_TOL, atol=SSM_TOL):
                fail(f"{what}: kernel != plain version (max abs err {errs}, "
                     f"tolerance {SSM_TOL})")
        row = {"case": label, "B": b, "S": s, "d_inner": di, "d_state": ds,
               "state0": "random" if warm else "zero", "masked": masked,
               "z_dtype": zdt, "max_abs_err_y": errs[0],
               "max_abs_err_state": errs[1], "max_abs_err": max(errs)}
        if timed:
            # as the WKV kernel's: the host's enqueueing outlasts the
            # kernel, so the device time is taken behind a sleep lead
            row["host_ms"] = cuda_ms(torch, kernel)
            row["ms"] = cuda_ms(torch, kernel,
                                lead_ms=2 * 20 * row["host_ms"] + 1)
            row["plain_host_ms"] = cuda_ms(torch, plain, iters=3, warmup=1)
            row["plain_ms"] = cuda_ms(torch, plain, iters=3, warmup=1,
                                      lead_ms=2 * 3 * row["plain_host_ms"]
                                      + 1)
            row["bound_ms"], row["bound_by"] = ssm_bound_ms(
                b, s, di, ds, z.element_size(), masked)
        rows.append(row)
        log(f"  {what}: allclose ({SSM_TOL}), max abs err y {errs[0]:.3e}, "
            f"state {errs[1]:.3e}"
            + (f" | kernel {row['ms']:.4f} ms (host-bound back to back: "
               f"{row['host_ms']:.4f}) | "
               f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}) | plain "
               f"{row['plain_ms']:.3f} ms ({row['plain_host_ms']:.3f})"
               if timed else ""))
    return rows


def bwd_close(torch, got, want) -> tuple:
    """(within BWD_TOL, max abs err): allclose at rtol BWD_TOL (one bf16
    ulp for bf16 outputs) and atol BWD_TOL x the largest entry, finite."""
    g, w = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else BWD_TOL
    err = float((g - w).abs().max())
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all())
          and bool(torch.allclose(g, w, rtol=rtol,
                                  atol=BWD_TOL * float(w.abs().max()))))
    return ok, err


def wkv_bwd_bound_ms(b: int, s: int, h: int, d: int, scratch: bool = False):
    """Least time for one WKV backward: r, k, v, w, dy read and dr, dk, dv,
    dw written once (u and du beside them) at the card's memory rate, or its
    ~20 fp32 operations a state element and step (the forward's update
    again, then dr, dk, dv, dw, dS) at the fp32 peak.  With ``scratch``,
    the bound of this design, whose state scratch (every S_{t-1}, B H S D^2
    floats) is written and read once besides: not the function's."""
    nbytes = 4 * (9 * b * s * h * d + 2 * h * d
                  + (2 * b * h * s * d * d if scratch else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 20 * b * h * s * d * d / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssm_bwd_bound_ms(b: int, s: int, di: int, ds: int, z_bytes: int,
                     scratch: bool = False):
    """Least time for one scan backward: x, delta, z, dy, b, c, a and
    d_skip read once and dx, d delta, dz, db, dc, da and d d_skip written
    once at the card's memory rate, or its ~18 DS + 20 fp32 operations a
    (row, channel, step) at the fp32 peak.  With ``scratch``, the bound of
    this design, whose state scratch (every h_t, B S di DS floats) is
    written and read once besides: not the function's."""
    nbytes = (b * s * di * (5 * 4 + 2 * z_bytes) + 4 * 4 * b * s * ds
              + 2 * 4 * di * (ds + 1)
              + (2 * 4 * b * s * di * ds if scratch else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = b * s * di * (18 * ds + 20) / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_case(torch, what: str, names, kernel, plain, timed: bool,
             bound, scratch_bound) -> dict:
    """One backward check: the kernel's gradients against the plain
    version's (:func:`bwd_close`), a second launch torch.equal to the first
    (no float atomics), timed where asked behind a sleep lead; ``bound`` is
    the function's, ``scratch_bound`` this design's with its state
    scratch."""
    got, want = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    errs = {}
    for name, g, p in zip(names, got, want):
        ok, errs[name] = bwd_close(torch, g, p)
        if not ok:
            fail(f"{what}: {name} of the kernel differs from its plain "
                 f"version (max abs err {errs[name]}, tolerance {BWD_TOL})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what}: a second launch differs from the first")
    row = {"max_abs_err": errs, "repeats_bit_for_bit": True}
    if timed:
        row["host_ms"] = cuda_ms(torch, kernel, iters=10)
        row["ms"] = cuda_ms(torch, kernel, iters=10,
                            lead_ms=2 * 10 * row["host_ms"] + 1)
        row["plain_host_ms"] = cuda_ms(torch, plain, iters=2, warmup=1)
        row["plain_ms"] = cuda_ms(torch, plain, iters=2, warmup=1,
                                  lead_ms=2 * 2 * row["plain_host_ms"] + 1)
        row["bound_ms"], row["bound_by"] = bound
        row["scratch_bound_ms"] = scratch_bound[0]
    log(f"  {what}: allclose ({BWD_TOL}), max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; repeats bit for bit"
        + (f" | kernel {row['ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
           f"({row['bound_by']}; {row['ms'] / row['bound_ms']:.1f}x), with "
           f"this design's state scratch {row['scratch_bound_ms']:.4f} ms "
           f"| plain {row['plain_ms']:.2f} ms" if timed else ""))
    return row


def wkv_bwd_checks(torch):
    """Phase 3w's backward half: the WKV backward kernel against its plain
    version (:func:`bwd_case`) at every WKV_BWD_CASES entry."""
    from repro_torch.kernels import wkv_gemm as W
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for label, b, s, h, d, timed in WKV_BWD_CASES:
        shape = (b, s, h, d)
        r, k, v = (torch.randn(shape, generator=gen, device="cuda") * 0.5
                   for _ in range(3))
        w = torch.rand(shape, generator=gen, device="cuda") * 0.199 + 0.8
        u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
        dy = torch.randn(shape, generator=gen, device="cuda")
        row = bwd_case(
            torch, f"wkv_bwd {label} B={b} S={s} H={h} D={d}",
            ("dr", "dk", "dv", "dw", "du"),
            lambda: W._bwd_launch(r, k, v, w, u, dy),
            lambda: W.wkv_vjp_reference(r, k, v, w, u, dy), timed,
            wkv_bwd_bound_ms(b, s, h, d),
            wkv_bwd_bound_ms(b, s, h, d, scratch=True))
        row.update({"case": label, "B": b, "S": s, "H": h, "D": d})
        rows.append(row)
    return rows


def ssm_bwd_checks(torch):
    """Phase 3s's backward half: the scan's backward kernel against its
    plain version (:func:`bwd_case`) at every SSM_BWD_CASES entry."""
    from repro_torch.kernels import ssm_scan as K
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rows = []
    for label, b, s, di, ds, zdt, timed in SSM_BWD_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, z = rnd(b, s, di), rnd(b, s, di).to(getattr(torch, zdt))
        delta = torch.nn.functional.softplus(rnd(b, s, di) - 2.0)
        bm, cm, dy = rnd(b, s, ds), rnd(b, s, ds), rnd(b, s, di)
        a = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device="cuda").repeat(di, 1)
        d_skip = torch.ones(di, device="cuda")
        ops = (x, delta, bm, cm, z, a, d_skip, dy)
        row = bwd_case(
            torch,
            f"ssm_scan_bwd {label} B={b} S={s} di={di} ds={ds} z {zdt}",
            ("dx", "ddelta", "db", "dc", "dz", "da", "dd_skip"),
            lambda: K._bwd_launch(*ops),
            lambda: K.ssm_scan_vjp_reference(*ops), timed,
            ssm_bwd_bound_ms(b, s, di, ds, z.element_size()),
            ssm_bwd_bound_ms(b, s, di, ds, z.element_size(), scratch=True))
        row.update({"case": label, "B": b, "S": s, "d_inner": di,
                    "d_state": ds, "z_dtype": zdt})
        rows.append(row)
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
    """Phase 4: the smoke-size model on the card against the CPU.  A
    vision model's prefill also takes a prefix of patch embeddings, and
    an encoder-decoder's prefill takes frames and its greedy tokens come
    from ``SMOKE_STEPS`` decode steps on the returned memory (the engine
    refuses it)."""
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
    extra = {}
    if cfg.frontend == "vision":
        extra["frontend_embeds"] = rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim))
    elif cfg.is_encdec:
        extra["enc_frames"] = rng.standard_normal((2, 16, cfg.frontend_dim))
    extra = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in extra.items()}
    t0 = toks.shape[1] + (cfg.frontend_tokens if cfg.frontend == "vision"
                          else 0)
    logits, tokens = {}, {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), params_cpu)
        cache = lm.init_cache(cfg, 2, 32, device=dev)
        with torch.inference_mode():
            out, cache, mem = lm.prefill(
                params, cfg, toks.to(dev), cache,
                **{k: v.to(dev) for k, v in extra.items()})
            logits[dev] = out.float().cpu()
            if cfg.is_encdec:
                picks = []
                for i in range(SMOKE_STEPS):
                    picks.append(torch.argmax(out, -1))
                    out, cache = lm.decode_step(params, cfg, picks[-1],
                                                cache, t0 + i, mem=mem)
                tokens[dev] = torch.stack(picks, 1).cpu().tolist()
                continue
        eng = Engine(cfg, params, max_seq=32, batch_size=2, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
        eng.generate(reqs)
        tokens[dev] = [r.generated for r in reqs]
    diff = (logits["cpu"] - logits["cuda"]).abs()[:, :cfg.vocab_size].max()
    if not torch.isfinite(logits["cuda"]).all() or diff > 1e-4:
        fail(f"{arch} smoke logits on the card differ from the CPU by {diff}")
    if tokens["cpu"] != tokens["cuda"]:
        fail(f"{arch} smoke greedy tokens differ: {tokens}")
    log(f"  {arch} smoke float32"
        + "".join(f", {k} {tuple(v.shape)}" for k, v in extra.items())
        + f": prefill logits max |cuda - cpu| = {float(diff)}; greedy "
        + (f"tokens equal over {SMOKE_STEPS} decode steps on the memory"
           if cfg.is_encdec else "tokens equal on 3 requests"))
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
    integer GEMMs', the WKV recurrence's, the selective scan's and the
    row-invariant kernels'."""
    out = {f"dense_{m}": c for m, c in dense.items()}
    out.update({f"grouped_{m}": c for m, c in grouped.items()})
    if WKV_PER_CALL.get(arch):
        out["wkv"] = WKV_PER_CALL[arch]
    if SSM_PER_CALL.get(arch):
        out["ssm_scan"] = SSM_PER_CALL[arch]
    return out | rowinv_per_call(arch)


def serve_counted(torch, fg, eng, reqs, graphs: bool = True):
    """One ``generate`` with every launch count set to 0 just before and
    read just after, decode graphed or eager; also the run's quantized GEMM
    routes, its prefill calls (the script wraps the executor's entry to
    count them) and graph replays."""
    from repro_torch.kernels import launch_counts
    from repro_torch.quant import qmatmul
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
            "routes": qmatmul.gemm_routes(),
            "replays": nonzero(replays), "prefills": n_prefill[0],
            "graphs": graphs, "tokens": [r.generated for r in reqs]}


def check_counted(what: str, eng, run: dict, per_call: dict,
                  routes: Optional[dict] = None) -> dict:
    """The exact launch gates of one counted run.  Graphed: the host
    counters hold prefills x per-call launches (a replay launches through
    no wrapper), replays equal decode steps and every width's graph
    captured exactly the per-call launches.  Eager: (prefills + decode
    steps) x per-call.  Graphed, every width's graph also holds exactly
    those kernels as nodes (``check_graph_nodes``).  The quantized GEMMs'
    routes, counted the same way, must be ``routes`` a call where given;
    elsewhere no GEMM may leave the kernels (no ATen route).  Returns the
    run's wrapper launches by kind and, graphed, the kernels the replays
    launched by profile bucket (``replayed``)."""
    stats = run["stats"]
    out = {"host": run["host"], "routes": {
        f"{b}/{r}": c for (b, r), c in run["routes"].items()}}
    calls = run["prefills"] + (0 if run["graphs"] else stats.decode_steps)
    want = {k: c * calls for k, c in per_call.items()}
    if run["host"] != want:
        fail(f"{what}: launches {run['host']} over {calls} calls, expected "
             f"{want}: a quantized GEMM bypassed the kernels")
    if routes is not None:
        want_routes = {k: c * calls for k, c in routes.items()}
        if run["routes"] != want_routes:
            fail(f"{what}: quantized GEMM routes {run['routes']} over "
                 f"{calls} calls, expected {want_routes}")
    elif set(run["routes"]) - {("cuda", "cuda")}:
        fail(f"{what}: quantized GEMMs took the ATen route: "
             f"{run['routes']}")
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


def serve_dense(torch, np, fg, arch: str, dense: dict, per_call_too: bool,
                grouped: dict):
    """Phase 5n: one dense, MoE or hybrid config at full width and depth
    under mixed.
    With ``per_call_too`` (gemma) its fp32 tree from a generator seeded 0
    serves per call, eager and graphed (one step graphed against eager),
    is prequantized, and is freed; then the leaf-wise init builds the
    records from a generator seeded 0 (its peak memory gated), equal leaf
    for leaf to ``prequantize(init_params)``, and they serve graphed: the
    per-call run's tokens and full-width prefill logits (torch.equal).
    Every run is counted under the exact launch gates (wrappers and decode
    graph nodes), twice, greedy streams repeating; the records path is
    profiled over its decode steps (device busy ms, kernels a step).  With
    mamba blocks (jamba) phase 5b runs on the records too: the block-level
    chunked gate and the model-level chunked report; with a vision front
    end (llava) phase 5v."""
    from repro_torch.models import lm
    from repro_torch.quant.prequant import prequantize
    from repro_torch.serve.engine import Request

    t_start = time.monotonic()
    pcfg = path_config(arch, "mixed")
    per_call = path_per_call(arch, dense, grouped)
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
    # the per-call reads beside the records: a tied lm_head's embed, an
    # MoE router (fp32, quantized every call); a text decode step reads no
    # front-end record
    read = (rbytes - record_bytes(qparams.get("frontend", {}))
            + (qparams["embed"].numel() * 4 if pcfg.tie_embeddings else 0)
            + router_bytes(qparams))
    rec = serve_mode(torch, fg, pcfg, qparams, requests, f"{arch} records",
                     per_call, True, 2, True, prompts, check_eager=True,
                     uncopied=True, moe=bool(grouped))
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
    if grouped:
        # the experts the profiled steps routed: their records, and every
        # other record and router, read once a step
        live = rec.pop("live_experts")
        expert = expert_bytes(qparams)
        routed = (read - expert["all"]
                  + expert["one"] * sum(live) / rec["profiled_steps"])
        rec.update({
            "live_experts_per_layer_step": {
                "mean": sum(live) / len(live), "max": max(live),
                "min": min(live)},
            "expert_record_bytes": expert["all"],
            "bytes_read_a_step_routed": routed,
            "bound_ms_routed": routed / PEAK_BYTES_PER_S * 1e3})
    rec.update({
        "record_bytes": rbytes, "bytes_read_a_step": read,
        "bound_ms": read / PEAK_BYTES_PER_S * 1e3,
        "gemm_ms_a_step": nonzero(prof["gemm_ms_per_step"]),
        "top_kernels": prof["by_kernel"][:12],
        "device_busy_ms": prof["device_busy_ms_per_step"],
        "kernels_a_step": prof["kernels_per_step"],
        "launches_per_profiled_step": prof["launches_per_step"],
        "idle_share": prof["idle_share"]})
    out["records"] = rec
    if any(b.kind == "mamba" for b in pcfg.pattern):
        out["mamba_chunk_gate"] = mamba_chunk_gate(torch, pcfg, qparams)
        out["chunked_report"] = chunked_report(torch, np, pcfg, qparams)
    if pcfg.frontend == "vision":
        out["vision_prefix"] = vision_prefix(torch, fg, pcfg, qparams)
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
        f"({read / 1e9:.2f} GB read a step)"
        + (f", {rec['bound_ms_routed']:.3f} ms on the routed experts "
           f"({rec['bytes_read_a_step_routed'] / 1e9:.2f} GB; "
           f"{rec['live_experts_per_layer_step']['mean']:.1f} live experts "
           f"a layer)" if grouped else "")
        + f", peak serving "
        f"{rec['peak_mem_gb']:.2f} GB; launches {per_call} a call "
        f"({out['seconds']:.1f} s)")
    return out


def greedy_run(torch, fg, pcfg, params, toks, extra: dict, new: int,
               max_seq: int, what: str, prefill_counts: dict,
               step_counts: dict, mesh=None) -> dict:
    """One prefill of ``toks`` (B, S) with ``extra`` (a vision prefix's
    ``frontend_embeds`` or an encoder's ``enc_frames``) and ``new`` greedy
    decode steps through ``lm.prefill`` / ``lm.decode_step`` (eager; the
    engine takes neither input), the launch counts set to 0 before the
    prefill and before the steps and read after each: exactly
    ``prefill_counts``, then ``new`` x ``step_counts``, every GEMM on the
    kernels.  Under ``mesh`` (the ambient one) ``toks`` and ``extra`` are
    this data rank's rows and the cache its block.  Returns the tokens (B,
    new + 1: the prefill's pick and each step's), the prefill's and each
    step's logits, the memory, the first decode position, the counted
    launches and the timings."""
    from repro_torch.dist import sharding as S
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm
    from repro_torch.quant import qmatmul
    b, s = toks.shape
    t0 = s + (pcfg.frontend_tokens if "frontend_embeds" in extra else 0)
    counts, routes = [], []
    reset_all(fg)
    torch.cuda.synchronize()
    with torch.inference_mode(), (S.use_mesh(mesh) if mesh is not None
                                  else contextlib.nullcontext()):
        if mesh is None:
            cache = lm.init_cache(pcfg, b, max_seq, device="cuda")
        else:       # this rank's block of the global batch's cache
            n = b * S.data_size(mesh)
            whole = lm.init_cache(pcfg, n, max_seq, device="meta")
            specs = S.cache_sharding(whole, mesh, batch=n)
            cache = {pos: {k: torch.zeros(
                S.local_block(t, specs[pos][k], mesh).shape, dtype=t.dtype,
                device="cuda") for k, t in leaves.items()}
                for pos, leaves in whole.items()}
        tic = time.monotonic()
        logits, cache, mem = lm.prefill(params, pcfg, toks, cache, **extra)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - tic
        counts.append(nonzero(launch_counts()))
        routes.append(qmatmul.gemm_routes())
        reset_all(fg)
        first = logits
        picks, steps = [torch.argmax(logits, -1)], []
        tic = time.monotonic()
        for i in range(new):
            logits, cache = lm.decode_step(params, pcfg, picks[-1], cache,
                                           t0 + i, mem=mem)
            steps.append(logits)
            picks.append(torch.argmax(logits, -1))
        torch.cuda.synchronize()
        decode_s = time.monotonic() - tic
    counts.append(nonzero(launch_counts()))
    routes.append(qmatmul.gemm_routes())
    wants = (prefill_counts, {k: c * new for k, c in step_counts.items()})
    for label, got, want, route in zip(
            ("the prefill", f"{new} decode steps"), counts, wants, routes):
        if got != want:
            fail(f"{what}: {label} launched {got}, expected {want}")
        if set(route) - {("cuda", "cuda")}:
            fail(f"{what}: {label}'s quantized GEMMs took the ATen route: "
                 f"{route}")
    host = {k: counts[0].get(k, 0) + counts[1].get(k, 0)
            for k in counts[0].keys() | counts[1].keys()}
    return {"tokens": torch.stack(picks, 1), "prefill_logits": first,
            "steps": steps, "mem": mem, "t0": t0,
            "launches": {"host": host},
            "prefill_ms": prefill_s * 1e3,
            "decode_step_ms": decode_s / new * 1e3,
            "decode_tokens_per_s": b * new / decode_s}


def continuation(torch, pcfg, params, toks, extra: dict, run: dict, at,
                 max_seq: int, what: str) -> dict:
    """Decode against prefill: for each step ``i`` in ``at``, its logits
    against a fresh prefill of ``toks`` extended by the ``i`` tokens that
    step had consumed.  The largest |logit difference|, and the greedy
    tokens, which must be equal wherever the prefill's top-2 gap exceeds
    CONTINUE_GAP."""
    from repro_torch.models import lm
    b, v = toks.shape[0], pcfg.vocab_size
    out = {}
    for i in at:
        seq = torch.cat([toks, run["tokens"][:, :i]], dim=1)
        with torch.inference_mode():
            ref, _, _ = lm.prefill(
                params, pcfg, seq,
                lm.init_cache(pcfg, b, max_seq, device="cuda"), **extra)
        r = ref[:, :v].float()
        g = run["steps"][i - 1][:, :v].float()
        top2 = r.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > CONTINUE_GAP
        same = r.argmax(-1) == g.argmax(-1)
        if not bool(same[decided].all()):
            fail(f"{what}: decode step {i}'s token differs from a fresh "
                 f"prefill's where its top-2 gap exceeds {CONTINUE_GAP}")
        out[i] = {"max_abs_logit_diff": float((r - g).abs().max()),
                  "rows_decided": int(decided.sum()),
                  "tokens_equal": int(same.sum()), "rows": b}
    return out


def repeat_and_continue(torch, fg, pcfg, params, toks, extra, new,
                        max_seq, what, prefill_counts, step_counts) -> dict:
    """Phases 5v and 5e's gates: two counted greedy runs (``greedy_run``)
    whose tokens must be torch.equal, and the continuation check at the
    first and the last decode step.  Returns the last run's tokens,
    launches and timings, and the check."""
    runs = [greedy_run(torch, fg, pcfg, params, toks, extra, new, max_seq,
                       what, prefill_counts, step_counts)
            for _ in range(2)]
    if not torch.equal(runs[0]["tokens"], runs[1]["tokens"]):
        fail(f"{what}: greedy tokens changed on an identical run")
    run = runs[-1]
    cont = continuation(torch, pcfg, params, toks, extra, run, (1, new),
                        max_seq, what)
    out = {k: run[k] for k in ("t0", "launches", "prefill_ms",
                               "decode_step_ms", "decode_tokens_per_s")}
    out.update({"tokens": run["tokens"].tolist(), "continuation": cont,
                "prefill_launches": prefill_counts,
                "step_launches": step_counts})
    log(f"  {what}: {new} greedy steps from position {run['t0']}, twice, "
        f"tokens equal; prefill {run['prefill_ms']:.1f} ms, decode "
        f"{run['decode_step_ms']:.2f} ms a step (eager, "
        f"{run['decode_tokens_per_s']:.1f} tokens/s); launches "
        f"{prefill_counts} a prefill, {step_counts} a step; decode against "
        f"a fresh prefill: "
        + "; ".join(f"step {i} max |d| {c['max_abs_logit_diff']:.4f}, "
                    f"{c['tokens_equal']}/{c['rows']} tokens equal"
                    for i, c in cont.items()))
    return out


def vision_prefix(torch, fg, pcfg, qparams) -> dict:
    """Phase 5v: llava on its leaf-wise records with a vision prefix
    (VISION_STREAMS streams of frontend_tokens seeded patch embeddings and
    VISION_TEXT text tokens, VISION_NEW greedy decode steps), under the
    exact launch, repeat and continuation gates."""
    tic = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    toks = torch.randint(1, pcfg.vocab_size, (VISION_STREAMS, VISION_TEXT),
                         generator=gen, device="cuda")
    extra = {"frontend_embeds": torch.randn(
        (VISION_STREAMS, pcfg.frontend_tokens, pcfg.frontend_dim),
        generator=gen, device="cuda")}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = repeat_and_continue(
        torch, fg, pcfg, qparams, toks, extra, VISION_NEW, VISION_MAX_SEQ,
        f"{pcfg.name} vision prefix ({VISION_STREAMS} streams of "
        f"{pcfg.frontend_tokens} patch embeddings + {VISION_TEXT} tokens)",
        VISION_PREFILL, VISION_STEP)
    out.update({"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "seconds": time.monotonic() - tic})
    log(f"  peak {out['peak_mem_gb']:.2f} GB ({out['seconds']:.1f} s)")
    return out


def serve_encdec(torch, fg) -> dict:
    """Phase 5e: seamless-m4t-medium under mixed on records from the
    leaf-wise init (its peak memory gated): ENCDEC_STREAMS streams of
    ENCDEC_FRAMES seeded fbank frames and ENCDEC_PROMPT decoder tokens,
    ENCDEC_NEW greedy decode steps on the memory, under the exact launch,
    repeat and continuation gates; then ENCDEC_PROFILED_STEPS decode steps
    profiled (device busy ms, kernels a step), beside the step's byte
    bound (the decoder's records, the tied lm_head's fp32 embed, which it
    quantizes every call, and the memory)."""
    from repro_torch.models import lm
    tic = time.monotonic()
    pcfg = path_config(ENCDEC_ARCH, "mixed")
    qparams, init = leafwise_init(torch, pcfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    toks = torch.randint(1, pcfg.vocab_size, (ENCDEC_STREAMS, ENCDEC_PROMPT),
                         generator=gen, device="cuda")
    extra = {"enc_frames": torch.randn(
        (ENCDEC_STREAMS, ENCDEC_FRAMES, pcfg.frontend_dim), generator=gen,
        device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    out = repeat_and_continue(
        torch, fg, pcfg, qparams, toks, extra, ENCDEC_NEW, ENCDEC_MAX_SEQ,
        f"{ENCDEC_ARCH} records ({ENCDEC_STREAMS} streams of "
        f"{ENCDEC_FRAMES} frames + {ENCDEC_PROMPT} tokens)",
        ENCDEC_PREFILL, ENCDEC_STEP)
    with torch.inference_mode():
        cache = lm.init_cache(pcfg, ENCDEC_STREAMS, ENCDEC_MAX_SEQ,
                              device="cuda")
        logits, cache, mem = lm.prefill(qparams, pcfg, toks, cache, **extra)
    mem_bytes = sum(t.numel() * t.element_size()
                    for kv in mem.values() for t in kv)
    read = (record_bytes(qparams["blocks"]) + mem_bytes
            + qparams["embed"].numel() * qparams["embed"].element_size())
    state = {"tok": torch.argmax(logits, -1), "t": out["t0"]}

    def step():
        with torch.inference_mode():
            logits, _ = lm.decode_step(qparams, pcfg, state["tok"], cache,
                                       state["t"], mem=mem)
        state["tok"], state["t"] = torch.argmax(logits, -1), state["t"] + 1

    prof = profile_steps(torch, step, ENCDEC_PROFILED_STEPS,
                         out["decode_step_ms"], lanes=ENCDEC_STREAMS)
    out.update({
        "arch": ENCDEC_ARCH, "init": init,
        "parameters": param_count(qparams), "memory_bytes": mem_bytes,
        "bytes_read_a_step": read,
        "bound_ms": read / PEAK_BYTES_PER_S * 1e3,
        "device_busy_ms": prof["device_busy_ms_per_step"],
        "kernels_a_step": prof["kernels_per_step"],
        "gemm_ms_a_step": nonzero(prof["gemm_ms_per_step"]),
        "launches_per_profiled_step": prof["launches_per_step"],
        "idle_share": prof["idle_share"],
        "top_kernels": prof["by_kernel"][:12],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del qparams, mem, cache
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - tic
    log(f"  {ENCDEC_ARCH} mixed: {out['parameters']} parameters; leaf-wise "
        f"init {init['init_s']:.1f} s, peak {init['init_peak_gb']:.2f} GB "
        f"for {init['records_gb']:.2f} GB of records; device busy "
        f"{out['device_busy_ms']:.2f} ms and {out['kernels_a_step']:.0f} "
        f"kernels a decode step at {ENCDEC_STREAMS} lanes, bound "
        f"{out['bound_ms']:.3f} ms ({read / 1e9:.3f} GB read a step: "
        f"decoder records, fp32 embed, memory {mem_bytes / 1e6:.1f} MB); "
        f"peak {out['peak_mem_gb']:.2f} GB ({out['seconds']:.1f} s)")
    return out


def aten_ms(torch, fn, timing: list) -> float:
    """Device ms of a host-bound ATen call, as :func:`device_ms` times it
    (queued behind a sleep lead covering the host's enqueueing), the lead
    sized from one synchronised call's host time, over ATEN_ITERS
    iterations, ATEN_FEW_ITERS where that passes ATEN_SLOW_HOST_MS; its
    seconds added to ``timing[0]``."""
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3
    iters = ATEN_FEW_ITERS if host_ms > ATEN_SLOW_HOST_MS else ATEN_ITERS
    ms = cuda_ms(torch, fn, iters=iters, warmup=1,
                 lead_ms=2 * iters * host_ms + 1)
    timing[0] += time.monotonic() - t0
    return ms


def aten_checks(torch, fg):
    """Phase 3k: the ATen route on the card, each result torch.equal to the
    same call on the CPU (which the test suite holds to JAX) at every
    ATEN_ROWS, and timed in device time beside the fused kernel at the
    same width at ATEN_TIMED_ROWS (:func:`aten_ms`).  Returns the rows and
    the seconds the timing took (``timing_s``; the rest is the
    comparisons')."""
    from repro_torch.core.context import ExecContext
    from repro_torch.core.dispatch import ExecPlan, analytic_plan, select_mode
    from repro_torch.core.kmm import kmm_n, mm_n
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffip import ffip_gemm_literal
    from repro_torch.quant.qmatmul import quantized_matmul
    from repro_torch.quant.quantize import carrier_dtype

    gen = torch.Generator()
    gen.manual_seed(11)
    k, n = ATEN_KN
    half = ATEN_CPU_COLS // 2
    cols = torch.cat([torch.arange(half), torch.arange(n - half, n)])
    timing = [0.0]

    def codes(w, shape):
        q = 2 ** (w - 1) - 1
        return torch.randint(-q, q + 1, shape, generator=gen,
                             dtype=torch.int32)

    def same(got, want, what):
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            fail(f"ATen route {what}: card != CPU (max abs err "
                 f"{(got.cpu().double() - want.double()).abs().max()})")

    out = {"recursion": [], "quantized_matmul": [], "strassen": []}
    for m in ATEN_ROWS:
        timed = m in ATEN_TIMED_ROWS
        for w in ATEN_WIDTHS:
            a, b = codes(w, (m, k)), codes(w, (k, n))
            ad, bd = a.cuda(), b.cuda()
            digits = select_mode(w).digits
            row = {"M": m, "K": k, "N": n, "w": w, "n": digits}
            for name, fn in (("kmm_n", kmm_n), ("mm_n", mm_n)):
                def call(x, y, fn=fn):
                    return fn(x, y, w=w, n=digits,
                              combine_dtype=torch.float32)
                same(call(ad, bd)[:, cols.cuda()], call(a, b[:, cols]),
                     f"{name} w={w} n={digits} M={m}")
                if timed:
                    row[f"{name}_ms"] = aten_ms(torch, lambda: call(ad, bd),
                                                timing)
            if timed and w <= 26:      # the fused kernel on the same codes
                plan = dataclasses.replace(analytic_plan(w), block_k=256)
                ac, bc = ad.to(carrier_dtype(w)), bd.to(carrier_dtype(w))
                row["fused_ms"] = aten_ms(
                    torch, lambda: ops.run_plan(ac, bc, plan=plan), timing)
            out["recursion"].append(row)
            log(f"  kmm_n / mm_n w={w} n={digits} M={m} K={k} N={n}: card "
                f"== CPU" + (f" | {row['kmm_n_ms']:.3f} / "
                             f"{row['mm_n_ms']:.3f} ms" if timed else "")
                + (f" | fused {row['fused_ms']:.4f} ms"
                   if "fused_ms" in row else ""))
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
        wm = torch.randn((k, n), generator=gen) * 0.02
        xd, wd = x.cuda(), wm.cuda()
        for w in ATEN_QMM_WIDTHS:
            aten = ExecContext(backend="aten")
            got = quantized_matmul(xd, wd, w, context=aten)
            same(got[:, cols.cuda()], quantized_matmul(
                x, wm[:, cols], w, context=aten), f"quantized_matmul w={w}")
            row = {"M": m, "K": k, "N": n, "w": w}
            if timed:
                row["ms"] = aten_ms(torch, lambda: quantized_matmul(
                    xd, wd, w, context=aten), timing)
                if w <= 26:
                    row["fused_ms"] = aten_ms(
                        torch, lambda: quantized_matmul(xd, wd, w), timing)
            out["quantized_matmul"].append(row)
            log(f"  quantized_matmul on aten w={w} M={m}: card == CPU"
                + (f" | {row['ms']:.3f} ms" if timed else "")
                + (f" | on the kernels {row['fused_ms']:.4f} ms"
                   if "fused_ms" in row else ""))
    m, k2, n2 = STRASSEN_SHAPE
    for w in STRASSEN_WIDTHS:
        a, b = codes(w, (m, k2)), codes(w, (k2, n2))
        ad, bd = a.cuda(), b.cuda()
        plans = {"xla_ref": ExecPlan("xla_ref", w, backend="aten",
                                     combine_int32=True, depth=0),
                 "strassen": ExecPlan("strassen", w, backend="aten",
                                      combine_int32=True),
                 "strassen+kmm2": ExecPlan("strassen+kmm2", w,
                                           combine_int32=True)}
        want = ops.run_plan(a, b, plan=plans["xla_ref"])
        row = {"M": m, "K": k2, "N": n2, "w": w}
        for name, plan in plans.items():
            before = dict(fg.launches)
            got = ops.run_plan(ad, bd, plan=plan)
            launched = {md: c - before[md] for md, c in fg.launches.items()
                        if c != before[md]}
            if launched != ({"kmm2": 7} if name == "strassen+kmm2" else {}):
                fail(f"{name} w={w}: fused launches {launched}")
            same(got, want, f"{name} w={w}")
            row[f"{name}_ms"] = aten_ms(
                torch, lambda: ops.run_plan(ad, bd, plan=plan), timing)
        out["strassen"].append(row)
        log(f"  strassen w={w} {m}x{k2}x{n2}: card == CPU, == xla_ref "
            f"(strassen+kmm2: 7 fused kmm2 launches) | xla_ref "
            f"{row['xla_ref_ms']:.3f}, strassen {row['strassen_ms']:.3f}, "
            f"strassen+kmm2 {row['strassen+kmm2_ms']:.3f} ms")
    m, k3, n3 = FFIP_SHAPE
    a, b = codes(8, (m, k3)), codes(8, (k3, n3))
    same(ffip_gemm_literal(a.cuda(), b.cuda()), ffip_gemm_literal(a, b),
         f"ffip {FFIP_SHAPE}")
    log(f"  ffip_gemm_literal {m}x{k3}x{n3}: card == CPU")
    out["timing_s"] = timing[0]
    return out


def serve_aten(torch, np, fg):
    """Phase 5a: llama3.2-1b per call (fp32 weights from a generator seeded
    0) on the ATen route, each path on its own warmed engine (graphed
    decode), 2 requests of 4 new tokens, twice: every quantized GEMM on the
    route, counted per prefill through ``qmatmul.gemm_routes`` and in each
    decode width's capture (its eager warm-up step and the capture, twice
    the per-call routes), no integer-GEMM kernel in the wrappers' counts or
    in any decode graph's kernel nodes, greedy streams repeating; on
    "aten" the full-width prefill logits within ROUTES_RTOL of the
    "cuda" route on the same weights."""
    from repro_torch.models import lm
    from repro_torch.quant import qmatmul
    from repro_torch.serve.engine import Request
    from repro_torch.serve.executor import Executor

    out = {}
    cfg, params, prompts = serve_inputs(torch, np, "llama3.2-1b")
    inner = Executor._capture
    for arch, policy, backend, routes in ATEN_PATHS:
        pcfg = path_config(arch, policy)
        pcfg = pcfg.with_quant(dataclasses.replace(pcfg.quant,
                                                   backend=backend))
        per_call = path_per_call(arch, {}, {})
        label = f"{arch} {policy} on {backend}"
        captured = {}

        def spy(self, d):
            before = qmatmul.gemm_routes()
            inner(self, d)
            after = qmatmul.gemm_routes()
            captured[int(d.toks.shape[0])] = {
                r: c - before.get(r, 0) for r, c in after.items()
                if c != before.get(r, 0)}

        def requests():
            return [Request(prompt=p, max_new_tokens=DENSE_NEW)
                    for p in prompts[:DENSE_REQUESTS]]

        Executor._capture = spy
        try:
            run = serve_mode(torch, fg, pcfg, params, requests, label,
                             per_call, True, 2, False, prompts,
                             routes=routes)
        finally:
            Executor._capture = inner
        want = {r: 2 * c for r, c in routes.items()}
        if not captured or any(got != want for got in captured.values()):
            fail(f"{label}: decode captures took the routes {captured}, "
                 f"expected {want} each")
        run.pop("first")
        logits = run.pop("logits")
        if backend == "aten":
            with torch.inference_mode():
                ref, _, _ = lm.prefill(params, cfg, torch.tensor(
                    [prompts[0]], device="cuda"), lm.init_cache(
                        cfg, 1, 256, device="cuda"))
            a = logits[:, :cfg.vocab_size].float()
            c = ref[:, :cfg.vocab_size].float()
            diff = (a - c).abs()
            if not (diff <= ROUTES_RTOL * torch.maximum(a.abs(),
                                                        c.abs())).all():
                fail(f"{label}: prefill logits differ from the cuda route "
                     f"by up to {float(diff.max())}")
            run["max_abs_logit_diff_vs_cuda"] = float(diff.max())
            run["logits_equal_to_cuda"] = bool(torch.equal(a, c))
        run["captured_routes"] = {w: {f"{b}/{r}": c for (b, r), c in
                                      got.items()}
                                  for w, got in captured.items()}
        out[f"{policy} {backend}"] = run
        log(f"  {label}: {routes} a call, captures {want} each, no GEMM "
            f"kernel; {run['decode_step_ms']:.2f} ms a decode step "
            f"({run['decode_tokens_per_s']:.1f} tokens/s), prefill "
            f"{run['prefill_tokens_per_s']:.1f} tokens/s, peak "
            f"{run['peak_mem_gb']:.2f} GB"
            + (f"; prefill logits max |aten - cuda| "
               f"{run['max_abs_logit_diff_vs_cuda']}"
               if backend == "aten" else ""))
        gc.collect()
        torch.cuda.empty_cache()
    del params
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
               uncopied: bool = False, routes: Optional[dict] = None,
               moe: bool = False):
    """One path on one engine, decode graphed or eager: ``n_runs``
    identical counted runs (greedy streams repeat), each gated; timings
    from the last; peak device memory from the engine's construction on;
    with ``check_eager`` one step graphed against eager on the same pool
    state, with ``witness`` a profiler count of the kernels replayed, with
    ``uncopied`` the records' codes followed to the kernel, and with
    ``profile`` a device-time profile.  ``routes``: the quantized GEMM
    routes a call (default: every GEMM on the kernels).  With ``moe`` and
    ``profile``, the profiled steps run again eagerly to count the experts
    each layer routed (``live_experts``)."""
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
        launches = check_counted(label, eng, runs[-1], per_call, routes)
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
        if moe:
            out["profiled_steps"] = out["profile"]["steps"]
            out["live_experts"] = live_experts(torch, eng, prompts,
                                               out["profiled_steps"])
    out["seconds"] = time.monotonic() - t0
    return out


def live_experts(torch, eng, prompts, n: int):
    """The experts each MoE layer routed in the ``n`` decode steps
    ``profile_decode`` traces (the same four requests, greedy, after the
    same first step), run again eagerly with ``moe.route`` spied on: one
    count a layer and step, read from the dispatch's live counts on the
    host, outside any graph."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import Request
    route, seen, on = moe.route, [], [False]

    def spy(*args, **kw):
        r = route(*args, **kw)
        if on[0]:
            seen.append(int((r.counts.sum(dim=1) > 0).sum()))
        return r

    moe.route, eng.executor.graphs = spy, False
    try:
        for p in prompts[:4]:
            eng.submit(Request(prompt=p, max_new_tokens=n + 2))
        eng.step()
        on[0] = True
        for _ in range(n):
            eng.step()
        on[0] = False
        while eng.num_active:
            eng.step()
    finally:
        moe.route, eng.executor.graphs = route, True
    return seen


def router_bytes(tree) -> int:
    """Bytes of the fp32 MoE router leaves (no record: quantized every
    call, as in the reference)."""
    return sum(t.numel() * t.element_size() for path, t in _paths(tree)
               if path[-1] == "router")


def expert_bytes(tree) -> dict:
    """Record bytes of the MoE experts: all of them (``all``) and one
    expert's wi, wg and wo in one layer, averaged over the MoE layers
    (``one``; a pattern may hold several MoE positions, each stacked over
    the periods)."""
    from repro_torch.quant.prequant import is_prequantized
    total = experts = 0

    def walk(node, key):
        nonlocal total, experts
        if is_prequantized(node):
            if key in ("wi", "wg", "wo") and node["q"].dim() == 4:
                total += sum(t.numel() * t.element_size()
                             for t in node.values())
                if key == "wi":         # one a layer: (periods, experts)
                    experts += node["q"].shape[0] * node["q"].shape[1]
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)

    walk(tree, None)
    return {"all": total, "one": total // max(experts, 1)}


def records_uncopied(torch, fg, eng, prompts, label: str) -> int:
    """Every record's codes reach the kernel as stored, with no
    weight-sized cast or copy: two short requests run eagerly with the
    fused kernel's launch spied on, and the storage of every record (each
    period's slice of a stacked one) must be a B operand the kernel got;
    but a vision front end's, which the engine (text only) never runs.
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
                if k != "frontend":
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
    first bit for bit; and for each engine the (token, choice) pairs the
    MoE dispatch dropped (0 without MoE)."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine, Request

    engines = {}
    for label, kw in (("chunked", dict(prefill_chunk=CHUNK)),
                      ("unchunked", {})):
        eng = engines[label] = Engine(pcfg, qparams, max_seq=256,
                                      batch_size=2, device="cuda", **kw)
        eng.warm()

    def serve(eng, prompts, label):
        """Greedy tokens by request, and the logits row each token was
        sampled from, by (request, step); the (token, choice) pairs the
        MoE dispatch dropped in the prefills (pads included) add to
        ``drops[label]``."""
        rows, ex = {}, eng.executor
        inner = ex.sample
        route = moe.route

        def counted_route(*args, **kw):
            r = route(*args, **kw)
            drops[label] += int((~r.keep).sum())
            return r

        def keep(seed, logits, temps, rids, steps):
            # a padding lane (request id 0, step 0) comes after the real
            # (0, 0) row, which the engine samples at prefill
            for lane, (rid, step) in enumerate(zip(rids, steps)):
                rows.setdefault((int(rid), int(step)),
                                logits[lane].float().cpu())
            return inner(seed, logits, temps, rids, steps)

        ex.sample, moe.route = keep, counted_route
        reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts]
        try:
            eng.generate(reqs)
        finally:
            del ex.sample
            moe.route = route
        return [r.generated for r in reqs], {
            (i, j): rows[(r.stats.rid, j)] for i, r in enumerate(reqs)
            for j in range(len(r.generated))}

    out = {}
    for seed in (5, 6):
        prompts = shared_head_prompts(np, pcfg, seed)
        drops = {label: 0 for label in engines}
        done = [{label: serve(eng, prompts, label)
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
        out[f"seed {seed}"] = {"streams": streams,
                               "moe_dropped_pairs": drops}
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


def mamba_chunk_gate(torch, pcfg, qparams) -> dict:
    """Phase 5b's gate: the first mamba block (period 0, position 0) of the
    full-width records, MAMBA_GATE_TOKENS random bf16 inputs (a generator
    seeded 11) from a zero state, run as the engine runs a prompt — in
    chunks of CHUNK, the last one padded to a multiple of 8 with a mask
    and ``last_idx`` — and as one padded shot: output rows, conv tail and
    SSM state torch.equal, and one scan launch a call."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import lm, ssm
    t0 = time.monotonic()
    p = lm._period(qparams["blocks"], 0)["pos0"]["mamba"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = torch.randn((1, MAMBA_GATE_TOKENS, pcfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def run(step):
        cache = ssm.mamba_cache_init(pcfg, 1, torch.bfloat16, device="cuda")
        outs = []
        for lo in range(0, MAMBA_GATE_TOKENS, step):
            n = min(step, MAMBA_GATE_TOKENS - lo)
            width = -(-n // 8) * 8
            xc = torch.zeros((1, width, pcfg.d_model), dtype=x.dtype,
                             device="cuda")
            xc[:, :n] = x[:, lo:lo + n]
            with torch.inference_mode():
                out, _ = ssm.mamba_apply_stateful(
                    p, xc, cache, pcfg, pcfg.quant, "blk0.mamba",
                    mask=torch.arange(width, device="cuda")[None] < n,
                    last_idx=torch.tensor([n - 1], device="cuda"))
            outs.append(out[:, :n])
        return torch.cat(outs, dim=1), cache

    ssm_scan.reset_launches()
    one, one_cache = run(MAMBA_GATE_TOKENS)
    chunked, cache = run(CHUNK)
    torch.cuda.synchronize()
    calls = 1 + -(-MAMBA_GATE_TOKENS // CHUNK)
    equal = {"output": torch.equal(chunked, one),
             **{leaf: torch.equal(cache[leaf], one_cache[leaf])
                for leaf in ("conv", "ssm")}}
    if not all(equal.values()) or not torch.isfinite(one.float()).all():
        fail(f"{pcfg.name}: a mamba block in chunks of {CHUNK} differs from "
             f"one shot ({equal})")
    if ssm_scan.launches["ssm_scan"] != calls:
        fail(f"{pcfg.name}: {ssm_scan.launches} scan launches for {calls} "
             f"block calls")
    out = {"tokens": MAMBA_GATE_TOKENS, "chunk": CHUNK, "equal": equal,
           "scan_launches": calls, "seconds": time.monotonic() - t0}
    log(f"  {pcfg.name} mamba block (period 0, pos 0), {MAMBA_GATE_TOKENS} "
        f"tokens in chunks of {CHUNK} against one shot: output, conv tail "
        f"and SSM state equal, {calls} scan launches "
        f"({out['seconds']:.1f} s)")
    return out


def chunked_report(torch, np, pcfg, qparams) -> dict:
    """Phase 5b's report: the whole model's chunked prefill against a
    single shot on the records (``chunk_compare``), with the MoE
    dispatch's dropped pairs in each engine.  Not gated: a chunk's MoE
    capacity comes from the chunk's length, by the reference's rule, so
    a chunked prefill may drop what the single shot keeps."""
    t0 = time.monotonic()
    out = chunk_compare(torch, np, pcfg, qparams)
    for seed, rec in out.items():
        log(f"  {pcfg.name} chunked (chunk {CHUNK}) against single-shot "
            f"prefill, {seed}: {describe_streams(rec['streams'])}; MoE "
            f"dropped pairs {rec['moe_dropped_pairs']}")
    out["seconds"] = time.monotonic() - t0
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
    rowinv_norm_kernel<T>; ssm_scan_kernel<DS, Z>."""
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
    if "ssm_scan_kernel<" in name:
        return "ssm_scan"
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

    for p in prompts[:4]:
        eng.submit(Request(prompt=p, max_new_tokens=n + 2))
    eng.step()                          # admit + prefill + first decode
    torch.cuda.synchronize()
    out = profile_steps(torch, eng.step, n, step_ms, lanes=4)
    while eng.num_active:
        eng.step()
    return out


def profile_steps(torch, step, n: int, step_ms, lanes: int):
    """``profile_decode``'s trace and table over ``n`` calls of ``step``
    (one decode step each, on ``lanes`` lanes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a kernel the profiler sees first (dropped from the rows below),
        # so the traced steps start with its device tracing under way
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
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
    counts = {"wkv": 0, "ssm_scan": 0, **{k: 0 for k in gemm},
              **{k: 0 for k in ROWINV_KEYS}}
    for r in rows:
        key = kernel_bucket(r["name"])
        if key is not None:
            gemm[key] = gemm.get(key, 0.0) + r["ms_per_step"]
            counts[key] += r["count"]
    out = {"steps": n, "lanes": lanes, "device_busy_ms_per_step": busy,
           "gemm_ms_per_step": gemm,
           "launches_per_step": {k: c / n for k, c in counts.items()},
           "kernels_per_step": sum(r["per_step"] for r in rows),
           "profiled_step_wall_ms": wall_ms, "step_ms": step_ms,
           "idle_share": 1 - busy / step_ms if step_ms else None,
           "by_kernel": rows[:30]}
    if step_ms is None:
        return out
    log(f"  profile, {n} decode steps at {lanes} lanes: device busy "
        f"{busy:.2f} "
        f"ms/step (integer GEMM, WKV, scan and row-invariant kernels "
        + ", ".join(
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
                   wkv_rows, rowinv_rows, ssm_rows, wkv_bwd_rows,
                   ssm_bwd_rows):
    """One entry per kernel (dense and grouped; mm1, kmm2, mm2 and kmm4)
    for the result line.  ``launches`` sums the wrapper's counts over the
    last counted run of every serve path and phase 5t's counted train
    runs (``launches_by_path`` has each):
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
               and r["model"] == "granite"
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
        if mode == "mm1":
            # qwen3's experts on 4 lanes beside granite's (E=128, wi/wg)
            row = next(r for r in grouped_rows if r["model"] == "qwen3"
                       and r["case"] == "decode W=4" and r["K"] == 2048)
            out[-1].update({
                "qwen3_ms": row["ms_dequant_bf16"],
                "qwen3_plain_ms": row["plain_ms"],
                "qwen3_bound_ms": row["bound_ms"],
                "qwen3_bound_by": row["bound_by"],
                "qwen3_shape": f"w=8 E={row['E']} C={row['C']} K={row['K']} "
                               f"N={row['N']}, {row['live_rows']} live rows "
                               f"in {row['live_experts']} experts"})
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
    # The selective scan, port-only (the reference's mamba scan is jnp), at
    # jamba's decode on 4 lanes (d_inner 8192, d_state 16, bf16 z), the
    # shape of each mamba layer's decode launch; its 64-token masked
    # prefill beside it.  No single library call computes the recurrence.
    row = next(r for r in ssm_rows if r["case"] == "decode W=4")
    pre = next(r for r in ssm_rows if r["case"] == "prefill S=64 masked")
    out.append({
        "name": "ssm_scan", "route": "cuda", "source": SSM_SOURCE,
        "replaces": "src/repro/models/ssm.py:139 (mamba_apply_stateful's "
                    "associative scan and einsum in jnp; no TPU kernel)",
        "launches": sum(c["host"].get("ssm_scan", 0)
                        for c in launches_by_path.values()),
        "launches_in_graph_replays": replayed("ssm_scan",
                                              launches_by_path.values()),
        "max_abs_err": max(r["max_abs_err"] for r in ssm_rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "prefill_ms": pre["ms"], "prefill_plain_ms": pre["plain_ms"],
        "prefill_bound_ms": pre["bound_ms"],
        "shape": f"B={row['B']} S={row['S']} d_inner={row['d_inner']} "
                 f"d_state={row['d_state']}, bf16 z, state in and out "
                 f"(B=1 S=64 masked as prefill_*)",
    })
    # The backward kernels, port-only (the TPU kernel has no backward; the
    # reference differentiates its jnp scans), at the train shapes:
    # rwkv6-3b's microbatch (2 x 256, 40 heads of 64) and jamba's (1 x 256,
    # d_inner 8192, d_state 16, bf16 z); launches over phase 5t's counted
    # runs.  No library call computes either.
    for name, rows, replaces, shape in (
            ("wkv_bwd", wkv_bwd_rows,
             "src/repro/models/rwkv.py:143 (XLA's autodiff of the jnp "
             "scan; the TPU kernel wkv_gemm.py:33 has no backward)",
             "B={B} S={S} H={H} D={D}, fp32, from a zero state"),
            ("ssm_scan_bwd", ssm_bwd_rows,
             "src/repro/models/ssm.py:136 (XLA's autodiff of the "
             "associative scan; no TPU kernel)",
             "B={B} S={S} d_inner={d_inner} d_state={d_state}, {z_dtype} "
             "z, from a zero state")):
        row = next(r for r in rows if "ms" in r)
        out.append({
            "name": name, "route": "cuda",
            "source": WKV_SOURCE if name == "wkv_bwd" else SSM_SOURCE,
            "replaces": replaces,
            "launches": sum(c["host"].get(name, 0)
                            for c in launches_by_path.values()),
            "max_abs_err": max(max(r["max_abs_err"].values())
                               for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": shape.format(**row),
            "scratch_bound_ms": row["scratch_bound_ms"],
        })
    return out


# Phase 5o, observability on the card (repro_torch.obs): the metric names
# of the reference that the port registers (all but the distribution
# port's shard-GEMM fallback counter), the spans a served run must record,
# the launcher's run (requests, new tokens), the llama records run (the
# requests of DENSE_PROMPTS, new tokens) and the MoE run (granite on
# records; requests, new tokens).
OBS_METRICS = (
    "repro_moe_dropped_tokens_total", "repro_moe_tokens_per_expert",
    "repro_pallas_fallback_total", "repro_plans_selected_total",
    "repro_quant_gemm_routes_total", "repro_serve_admitted_total",
    "repro_serve_decode_lane_width_total", "repro_serve_decode_step_seconds",
    "repro_serve_finished_total", "repro_serve_occupancy",
    "repro_serve_prefix_cache_total", "repro_serve_queue_depth",
    "repro_serve_retraces_total", "repro_serve_ttft_seconds")
OBS_SPANS = {"engine_step", "decode_step", "prefill_chunk", "request",
             "run_plan"}
OBS_LAUNCHER = (4, 8)
OBS_NEW = 16
OBS_MOE = (4, 8)
OBS_NCU_METRICS = "dram__bytes_read.sum,dram__bytes_write.sum"


def ncu_probe():
    """Start Nsight Compute on a one-matmul program, asking for the DRAM
    byte counters the measured traffic needs; ``ncu_result`` reads it."""
    import shutil
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not Path(ncu).exists():
        return None
    prog = ("import torch; a = torch.ones(1024, 1024, device='cuda'); "
            "print(float((a @ a).sum()))")
    return subprocess.Popen(
        [ncu, "--metrics", OBS_NCU_METRICS, "--target-processes", "all",
         sys.executable, "-c", prog], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def ncu_result(proc) -> dict:
    """Whether ncu read the DRAM byte counters, and its errors."""
    if proc is None:
        return {"ncu": None, "counters": False,
                "errors": ["ncu is not installed"]}
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    lines = out.splitlines()
    return {"ncu": proc.args[0], "returncode": proc.returncode,
            "counters": any("dram__bytes_read.sum" in ln for ln in lines)
            and not any("==ERROR==" in ln for ln in lines),
            "errors": [ln for ln in lines if "==ERROR==" in ln][:4]}


def obs_launcher() -> dict:
    """The launcher on the card with --metrics-out / --trace-out: its files
    parse, the snapshot holds every OBS_METRICS name with the run's
    admissions, finishes and TTFTs, and the trace every OBS_SPANS span."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    m_path, t_path = out_dir / "obs_metrics.json", out_dir / "obs_trace.json"
    n_req, new = OBS_LAUNCHER
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3.2-1b", "--quant", "mixed", "--full-size", "--requests",
           str(n_req), "--max-new", str(new), "--metrics-out", str(m_path),
           "--trace-out", str(t_path)]
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")})
    if res.returncode != 0:
        fail(f"the launcher with --metrics-out / --trace-out failed:\n"
             f"{res.stderr[-3000:]}")
    snap = json.loads(m_path.read_text())
    events = json.loads(t_path.read_text())["traceEvents"]
    missing = set(OBS_METRICS) - set(snap)
    spans = {e["name"] for e in events}
    if missing or not OBS_SPANS <= spans:
        fail(f"launcher: metrics {sorted(missing)} or spans "
             f"{sorted(OBS_SPANS - spans)} missing")
    vals = {k: snap[k]["values"] for k in OBS_METRICS}
    if (vals["repro_serve_admitted_total"].get("") != n_req
            or sum(vals["repro_serve_finished_total"].values()) != n_req
            or vals["repro_serve_ttft_seconds"][""]["count"] != n_req
            or set(vals["repro_quant_gemm_routes_total"])
            != {"backend=cuda,route=cuda"}):
        fail(f"launcher: admitted / finished / ttft / routes off: {vals}")
    return {"seconds": time.monotonic() - t0, "events": len(events),
            "spans": sorted(spans), "metrics": len(snap),
            "stdout_tail": res.stdout.splitlines()[-3:]}


def obs_requests(cfg, n: int, new: int):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=DENSE_PROMPTS[i % len(DENSE_PROMPTS)])],
        max_new_tokens=new) for i in range(n)]


def obs_run(torch, fg, cfg, qparams, per_call, on: bool, what: str,
            n: int, new: int):
    """One warmed graphed engine on ``qparams`` with metrics and tracing
    enabled before it is built (``on``) or disabled, one counted run under
    the exact launch and graph-node gates; with ``on`` the registry is
    reset after warm() (the MoE accumulators drained of the warm-up's
    dispatches) and read after the run."""
    from repro_torch.obs import disable_all, enable_all, metrics, trace
    metrics.reset()
    trace.clear()
    (enable_all if on else disable_all)()
    try:
        eng = serve_engine(torch, cfg, qparams)
        retraces = metrics.snapshot()["repro_serve_retraces_total"]["values"]
        metrics.reset()
        trace.clear()
        run = serve_counted(torch, fg, eng, obs_requests(cfg, n, new))
        snap, events = metrics.snapshot(), trace.events()
    finally:
        disable_all()
        metrics.reset()
        trace.clear()
    gates = check_counted(f"{what} obs {'on' if on else 'off'}", eng, run,
                          per_call)
    stats = run["stats"]
    out = {"tokens": run["tokens"], "replays": run["replays"],
           "prefills": run["prefills"], "decode_steps": stats.decode_steps,
           "decode_step_ms": stats.decode_s / stats.decode_steps * 1e3,
           "graph_nodes": gates["graph_nodes"],
           "n_traces": eng.executor.n_traces(), "retraces": retraces}
    if on:
        out.update(snapshot=snap, spans=sorted({e["name"] for e in events}),
                   events=len(events))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_obs_counts(what: str, run: dict, n: int) -> None:
    """The host-loop counters of an obs-on run against the run itself."""
    v = {k: run["snapshot"][k]["values"] for k in OBS_METRICS}
    want_retraces = {f"kind={k}": float(c) for k, c in run["n_traces"].items()}
    if (v["repro_serve_admitted_total"].get("") != n
            or sum(v["repro_serve_finished_total"].values()) != n
            or v["repro_serve_ttft_seconds"][""]["count"] != n
            or v["repro_serve_decode_step_seconds"][""]["count"]
            != run["decode_steps"]
            or sum(v["repro_serve_decode_lane_width_total"].values())
            != run["decode_steps"]
            or run["retraces"] != want_retraces):
        fail(f"{what}: obs counters disagree with the run: admitted / "
             f"finished / ttft / decode steps {run['decode_steps']} / "
             f"retraces {run['retraces']} vs n_traces {run['n_traces']}: {v}")
    if not OBS_SPANS <= set(run["spans"]):
        fail(f"{what}: spans {run['spans']}, expected {sorted(OBS_SPANS)}")


def serve_obs(torch, fg, card: str, launches_by_path: dict) -> dict:
    """Phase 5o: the launcher with --metrics-out / --trace-out, llama on
    mixed records with observability on and off (tokens torch.equal, the
    exact launch and graph-node gates, the host-loop counters against the
    run, decode-step ms beside each other), granite on records with the MoE
    dispatch counted through the decode graphs' replays; the ncu probe runs
    beside the launcher."""
    t0 = time.monotonic()
    probe = ncu_probe()
    out = {"launcher": obs_launcher()}
    out["ncu"] = ncu_result(probe)
    log(f"  launcher: {out['launcher']['metrics']} metrics, "
        f"{out['launcher']['events']} trace events, "
        f"{out['launcher']['seconds']:.1f} s; ncu {out['ncu']['ncu']}: "
        f"DRAM byte counters "
        f"{'read' if out['ncu']['counters'] else 'not readable'} "
        f"{out['ncu']['errors'][:2]}")

    arch = "llama3.2-1b"
    cfg = path_config(arch, "mixed")
    qparams, _ = leafwise_init(torch, cfg)
    per_call = path_per_call(arch, {"mm1": 112, "kmm2": 1}, {})
    n = len(DENSE_PROMPTS)
    on = obs_run(torch, fg, cfg, qparams, per_call, True, arch, n, OBS_NEW)
    off = obs_run(torch, fg, cfg, qparams, per_call, False, arch, n,
                  OBS_NEW)
    del qparams
    if on["tokens"] != off["tokens"]:
        fail(f"{arch}: tokens differ with observability on and off")
    check_obs_counts(arch, on, n)
    if on["graph_nodes"] != off["graph_nodes"]:
        fail(f"{arch}: decode graphs' kernel nodes with obs on "
             f"{on['graph_nodes']} differ from off {off['graph_nodes']}")
    base = launches_by_path.get(f"{arch} mixed prequantized", {})
    if base and base["graph_nodes"] != off["graph_nodes"]:
        fail(f"{arch}: obs-off decode graphs hold {off['graph_nodes']}, "
             f"phase 5p's {base['graph_nodes']}")
    out[arch] = {k: on[k] if k != "decode_step_ms" else
                 {"on": on[k], "off": off[k]}
                 for k in ("decode_steps", "decode_step_ms", "replays",
                           "spans", "events", "graph_nodes")}
    out[arch]["snapshot"] = {k: on["snapshot"][k]["values"]
                             for k in OBS_METRICS}
    log(f"  {arch} mixed records, graphed, {n} requests x {OBS_NEW} tokens: "
        f"decode step {on['decode_step_ms']:.3f} ms with obs on, "
        f"{off['decode_step_ms']:.3f} ms off ({card}); tokens equal, "
        f"launch and graph-node gates as in 5g/5p"
        + ("" if base else " (5p not run: its graphs not compared)"))

    arch = "granite-moe-3b-a800m"
    cfg = path_config(arch, "mixed")
    qparams, _ = leafwise_init(torch, cfg)
    per_call = path_per_call(arch, {"mm1": 128, "kmm2": 33}, {"mm1": 96})
    n, new = OBS_MOE
    on = obs_run(torch, fg, cfg, qparams, per_call, True, arch, n, new)
    off = obs_run(torch, fg, cfg, qparams, per_call, False, arch, n, new)
    del qparams
    if on["tokens"] != off["tokens"]:
        fail(f"{arch}: tokens differ with observability on and off")
    check_obs_counts(arch, on, n)
    base = launches_by_path.get(f"{arch} mixed prequantized", {})
    if base and base["graph_nodes"] != off["graph_nodes"]:
        fail(f"{arch}: obs-off decode graphs hold {off['graph_nodes']}, "
             f"phase 5p's {base['graph_nodes']}")
    # every dispatch observed once a layer: E observations a prefill (one
    # sequence) and width x E a replayed decode step, over n_periods layers
    # sharing the block's name
    e = cfg.n_experts
    dispatched = on["prefills"] + sum(w * c for w, c in
                                      on["replays"].items())
    hist = on["snapshot"]["repro_moe_tokens_per_expert"]["values"]
    want = {f"layer=blk{i}.moe": cfg.n_periods * e * dispatched
            for i, b in enumerate(cfg.pattern) if b.moe}
    got = {k: v["count"] for k, v in hist.items()}
    if got != want:
        fail(f"{arch}: tokens_per_expert counted {got}, the host dispatched "
             f"{want} (prefills {on['prefills']}, replays {on['replays']})")
    extra = {w: on["graph_nodes"][w]["all"] - off["graph_nodes"][w]["all"]
             for w in on["graph_nodes"]}
    out[arch] = {"decode_steps": on["decode_steps"],
                 "decode_step_ms": {"on": on["decode_step_ms"],
                                    "off": off["decode_step_ms"]},
                 "replays": on["replays"], "prefills": on["prefills"],
                 "observations": got,
                 "dropped": on["snapshot"]["repro_moe_dropped_tokens_total"]
                 ["values"], "extra_graph_nodes_on": extra}
    log(f"  {arch} mixed records, graphed: tokens_per_expert {got} = "
        f"(prefills {on['prefills']} + replays x width "
        f"{on['replays']}) x {e} experts x {cfg.n_periods} layers; tokens "
        f"equal to obs off; decode step {on['decode_step_ms']:.3f} ms on, "
        f"{off['decode_step_ms']:.3f} ms off; accumulator nodes a graph "
        f"{extra}")
    out["seconds"] = time.monotonic() - t0
    return out


# Phase 5t, training.  Full-width llama3.2-1b under mixed and
# granite-moe-3b-a800m cut to TRAIN_GRANITE_PERIODS of its 32 periods (its
# 3.30 B params would need 52.8 GB for fp32 params, grads and AdamW state
# before activations), at the reference's train shape: seq 256, global
# batch 8, each config's microbatches.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 256, 8, 4
TRAIN_GRANITE_PERIODS, TRAIN_GRANITE_STEPS = 4, 2
# rwkv6-3b cut to 4 of its 32 periods: a step peaks at ~30 bytes a param
# (NVIDIA H100 80GB HBM3, 700 W: 47.26 GB at 16 periods, 1.600 B params;
# 67.14 GB at 24, 2.232 B), so its 2.86 B params would need ~85 GB; 24
# periods fit, but their checks took the whole script past its time limit
# on a slower machine (the step at 24 takes 2.1x the step at 16), and so
# did 16 and then 8 once the recurrent blocks under a mesh joined 5m and
# 5d (1372.3 s at 16 and 1220.1 s at 8 on a machine that ran the other
# phases ~1.3x slower than one that took 1044.9 s at 16; 5t took 174.2 s
# at 16 and 118.5 s at 8 there).  The step-1 gates hold at any depth (the
# distance grows with it: 4.16e-2 of TRAIN_PLAIN_GRAD_RTOL's 0.1 at 8).
# 2 counted steps, its 4 microbatches.
TRAIN_RWKV_PERIODS, TRAIN_RWKV_STEPS = 4, 2
# llama's restart gate (a checkpoint and a resumed run bit-exact to the
# straight run) on TRAIN_RESTART_PERIODS of its 16 periods: the property
# does not depend on depth, and at full depth the 14.8 GB checkpoint's
# write and read took ~100 s.
TRAIN_RESTART_PERIODS = 2
# jamba trains no whole step on one card (one 8-layer period alone holds
# ~12.8 B params, ~400 GB of training state): one full-width mamba layer's
# mamba_apply, forward and backward at seq 256 on one sequence (a
# microbatch of jamba's 8), timed over JAMBA_BLOCK_RUNS runs.
JAMBA_BLOCK_RUNS = 3
# The smoke models in float32, card against CPU: the loss within
# TRAIN_SMOKE_LOSS_RTOL relative, every gradient leaf within
# TRAIN_SMOKE_TOL of its largest entry.  The norm kernel and ATen's norm
# round their sums apart and the backward's fp32 matmuls sum in other
# orders (~1e-6 of a leaf; tests/test_torch_train.py holds the CPU to JAX
# at 1e-5), and an ulp at a rounding boundary flips a w=8 activation code
# (a step of amax/127).  On an NVIDIA H100 80GB HBM3 (700 W) granite's
# expert input does, and its worst leaf, moe.wo, is 1.21e-3 of its
# largest entry from the CPU (moe.wi 5.7e-4), the same with the kernels'
# plain versions on the card: ATen's rounding on the card, not a kernel.
# The card repeats itself: a second card run in one process gave
# bit-identical gradients (the script prints that distance), and three
# runs gave the same 1.21e-3.  The gate leaves 4x of room.
# A gradient cut at a kernel is off by order 1.
TRAIN_SMOKE_LOSS_RTOL = 1e-4
TRAIN_SMOKE_TOL = 5e-3
# Step 1 with the kernels against their plain versions at full width, bf16
# compute: the fused kernels are torch.equal to theirs (phase 3), the norm
# kernel within one bf16 ulp of its plain version (5r); a norm output one
# ulp apart can flip a w=8 activation code (a step of amax/127), and the
# flips feed the later layers, so the loss is held relative and each
# gradient leaf by its relative L2 distance.  A card run (NVIDIA H100
# 80GB HBM3, 700 W) measured 1.0e-4 / 3.6e-5 (loss) and 2.1e-2 / 3.0e-2 (worst leaf: llama's
# blk mlp.wg, granite's router) for llama / granite; the gates leave 10x
# and 3x of room.  rwkv6-3b at 24 periods measured 1.0e-4 (loss) and
# 7.08e-2 (blk w_lora_b; every leaf 3-7e-2, 5.68e-2 at 16 periods): 1.4x
# of room.  That distance is the chain's, not a kernel's: w=8 codes and
# bf16 roundings carry any last-bit difference this far at this depth.
# The kernels' own step with only the WKV output moved, one ulp on half
# its entries (wkv_output_jitter), lands 3.4e-2 (median leaf 2.9e-2)
# from it, half the kernels' distance for a smaller change than theirs,
# and in fp32 compute the kernels sit 5.0e-6 from their plain versions
# (below).  The reading is a fixed function of
# the seeds on deterministic kernels (two card runs gave 7.075e-2 to the
# digit), so it does not wander across the gate; the gate is for faults of
# order 1, and TRAIN_FP32_* below hold the recurrent kernels to 1e-4.  A
# gradient cut at a kernel (zero, or missing a path) is off by order 1.
TRAIN_PLAIN_LOSS_RTOL = 1e-3
TRAIN_PLAIN_GRAD_RTOL = 0.1
# rwkv6-3b's step 1 again under quant none (the same params and batch),
# kernels against plain versions, where no code can flip.  In bf16 compute
# it is held to the gates above: a bf16 rounding carries the kernels' last
# bits as a code flip does, and the card (NVIDIA H100 80GB HBM3, 700 W)
# read 7.9e-5 (loss) and 2.8e-2 at 24 periods (blk rwkv.mix), so the codes
# add the rest of mixed's 7.08e-2.  In fp32 compute nothing carries them:
# the card read 5.0e-6 (rwkv.u) and a loss equal to the bit, so
# TRAIN_FP32_* hold the recurrent kernels to 20x that, far below a fault
# of order 1.
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_GRAD_RTOL = 1e-4


def train_launches(cfg, steps: int, seq: int) -> dict:
    """The kernel launches of ``steps`` train steps, by launch-count key:
    per microbatch each period's quantized GEMMs, norms, LoRA products and
    scan forwards run twice under remat (forward and the backward's
    recompute) and its scan backwards once, the head's GEMM twice a loss
    chunk (its checkpoint), ln_f once; a front end's projector GEMMs once;
    an encoder-decoder's encoder periods as the decoder's (twice under
    remat), enc_ln_f once, each decoder period's cross-attention norm and
    its wq and wo as its other sites, its memory's wk and wv once; the
    microbatches multiply."""
    from repro_torch.kernels import fused_gemm as fg
    from repro_torch.models import lm

    def mode(name):
        return fg.resolve(cfg.quant.bits_for(name), cfg.quant.m)[0]

    out: dict = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n

    remat = 2 if cfg.remat else 1
    per = remat * cfg.n_periods
    for pos, spec in enumerate(cfg.pattern):
        add("rowinv_norm", 2 * per)                  # ln1, ln2
        if spec.kind == "attn":
            names = [f"blk{pos}.attn.w{p}" for p in "qkvo"]
        elif spec.kind == "rwkv":
            names = [f"blk{pos}.rwkv.w{p}" for p in "rkvgo"]
            add("rowinv_norm", per)                  # ln_x
            add("rowinv_matmul", 2 * per)            # the decay's LoRA
            add("wkv", per)
            add("wkv_bwd", cfg.n_periods)
        elif spec.kind == "mamba":
            names = [f"blk{pos}.mamba.{p}" for p in
                     ("in_proj", "x_proj", "dt_proj", "out_proj")]
            add("ssm_scan", per)
            add("ssm_scan_bwd", cfg.n_periods)
        else:
            raise ValueError(f"no training launches for {spec.kind}")
        if spec.moe:
            names.append(f"blk{pos}.moe.router")
            for p in ("wi", "wg", "wo") if cfg.glu else ("wi", "wo"):
                add(f"grouped_{mode(f'blk{pos}.moe.{p}')}", per)
        else:
            names += [f"blk{pos}.mlp.{p}" for p in (
                ("wi", "wg", "wo") if cfg.glu else ("wi", "wo"))]
        for name in names:
            add(f"dense_{mode(name)}", per)
    if cfg.frontend != "none":
        for name in ("frontend.w1", "frontend.w2"):
            add(f"dense_{mode(name)}", 1)
    if cfg.is_encdec:
        enc = remat * cfg.encoder_periods
        for pos, spec in enumerate(cfg.pattern):
            add("rowinv_norm", 2 * enc + per)         # ln1, ln2; lnx
            for p in ("wq", "wk", "wv", "wo"):
                add(f"dense_{mode(f'blk{pos}.attn.{p}')}", enc)
            for p in ("wi", "wg", "wo") if cfg.glu else ("wi", "wo"):
                add(f"dense_{mode(f'blk{pos}.mlp.{p}')}", enc)
            for p, n in (("wq", per), ("wo", per), ("wk", cfg.n_periods),
                         ("wv", cfg.n_periods)):
                add(f"dense_{mode(f'blk{pos}.xattn.{p}')}", n)
        add("rowinv_norm", 1)                        # enc_ln_f
    chunk = min(lm.LOSS_CHUNK, seq)
    while seq % chunk:
        chunk //= 2
    add(f"dense_{mode('lm_head')}", 2 * (seq // chunk))
    add("rowinv_norm", 1)                            # ln_f
    micro = max(cfg.n_microbatches, 1) * steps
    return {k: n * micro for k, n in out.items()}


def plain_launch(fg):
    """The fused GEMM's plain version with ``fg._launch``'s signature."""
    def launch(a, b, sx, sw, counts, *, seg, **kw):
        if a.dim() == 3:
            return fg.fused_gemm_grouped_reference(
                a, b, sx, sw, counts, seg=seg if counts is not None
                else None, **kw)
        return fg.fused_gemm_reference(a, b, sx, sw, **kw)
    return launch


def launch_seams(fg) -> list:
    """Every kernel launch seam of the train path, (name, module,
    attribute, the plain version with the seam's signature, its gate, the
    indices of the states it writes in place): the fused GEMM (dense
    and grouped; torch.equal), the norm and the LoRA matmul (5r's
    tolerance), the WKV and scan forwards (3w's and 3s's) and backwards
    (BWD_TOL)."""
    from repro_torch.kernels import rowinv, ssm_scan, wkv_gemm

    def wkv_plain(r, k, v, w, u, state0, state_out, kernel=None):
        b, _, h, d = r.shape
        st0 = state0 if state0 is not None else r.new_zeros((b, h, d, d))
        y, st = wkv_gemm.wkv_stateful_reference(r, k, v, w, u, st0)
        if state_out is not None:
            state_out.copy_(st)
        return y

    def scan_plain(x, delta, b, c, z, a, d_skip, h, mask):
        y, st = ssm_scan.ssm_scan_reference(x, delta, b, c, z, a, d_skip,
                                            h, mask)
        h.copy_(st)
        return y

    return [("fused", fg, "_launch", plain_launch(fg), "equal", ()),
            ("rowinv_norm", rowinv, "_norm_launch",
             rowinv.rowinv_norm_reference, "norm", ()),
            ("rowinv_matmul", rowinv, "_matmul_launch",
             rowinv.rowinv_matmul_reference, ROWINV_TOL, ()),
            ("wkv", wkv_gemm, "_launch", wkv_plain, (WKV_TOL, WKV_TOL),
             (6,)),
            ("wkv_bwd", wkv_gemm, "_bwd_launch", wkv_gemm.wkv_vjp_reference,
             "bwd", ()),
            ("ssm_scan", ssm_scan, "_launch", scan_plain,
             (SSM_TOL, SSM_TOL), (7,)),
            ("ssm_scan_bwd", ssm_scan, "_bwd_launch",
             ssm_scan.ssm_scan_vjp_reference, "bwd", ())]


@contextlib.contextmanager
def plain_kernels(fg):
    """Every kernel launch of the train path replaced by the kernel's plain
    version on the same CUDA tensors (counting nothing)."""
    seams = launch_seams(fg)
    saved = [getattr(mod, attr) for _, mod, attr, *_ in seams]
    for _, mod, attr, plain, *_ in seams:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for (_, mod, attr, *_), fn in zip(seams, saved):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def checked_kernels(torch, fg, what: str):
    """Every kernel launch of the train path also runs the kernel's plain
    version on the same operands (a state written in place given to each
    as it was) and fails on a difference: a fused GEMM's output must be
    torch.equal to its plain version's (phase 3's gate), a norm's within
    ROWINV_TOL (fp32 rows) or one bf16 ulp (bf16 rows), 5r's gate, the LoRA
    matmul's within ROWINV_TOL, the WKV and scan forwards' (y and the
    state) within WKV_TOL and SSM_TOL, their backwards' gradients within
    BWD_TOL (:func:`bwd_close`); rtol with an atol of that fraction of the
    output's largest entry.  Yields {(kernel, shape): launches checked};
    the plain versions count nothing, the kernels count as they always
    do."""
    seams = launch_seams(fg)
    saved = [getattr(mod, attr) for _, mod, attr, *_ in seams]
    seen: dict = {}

    def close(out, ref, gate):
        if gate == "equal":
            return torch.equal(out, ref), int((out != ref).sum())
        if gate == "bwd":
            return bwd_close(torch, out, ref)
        if gate == "norm":
            rtol, atol = ROWINV_TOL
            if out.dtype == torch.bfloat16:
                rtol = 2.0 ** -7
            diff = (out.float() - ref.float()).abs()
            return (not int((diff > rtol * ref.float().abs() + atol).sum()),
                    float(diff.max()))
        rtol, atol = gate
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), ref.float(), rtol=rtol,
            atol=atol * float(ref.abs().max()))
        return ok, float((out.float() - ref.float()).abs().max())

    def checked(name, kernel, plain, gate, written):
        def run(*args, **kw):
            # the states the kernel writes in place: the plain version gets
            # copies (wherever it is passed them), and both are compared
            copies = {id(args[i]): args[i].clone() for i in written
                      if args[i] is not None}
            mine = [copies.get(id(a), a) if isinstance(a, torch.Tensor)
                    else a for a in args]
            out = kernel(*args, **kw)
            ref = plain(*mine, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            outs += tuple(args[i] for i in written if args[i] is not None)
            refs += tuple(mine[i] for i in written if args[i] is not None)
            kind, shape = name, tuple(args[0].shape)
            if name == "fused":
                kind = ("grouped_" if args[0].dim() == 3 else "dense_") + \
                    kw["mode"]
                shape += (args[1].shape[-1],)
            elif name == "rowinv_norm":
                kind = f"rowinv_norm_{args[3]}"
            for o, r in zip(outs, refs):
                ok, err = close(o, r, gate)
                if not ok:
                    fail(f"{what}: {kind} at {shape} differs from its "
                         f"plain version ({err}; gate {gate})")
            seen[(kind, shape)] = seen.get((kind, shape), 0) + 1
            return out
        return run

    for (name, mod, attr, plain, gate, written), fn in zip(seams, saved):
        setattr(mod, attr, checked(name, fn, plain, gate, written))
    try:
        yield seen
    finally:
        for (_, mod, attr, *_), fn in zip(seams, saved):
            setattr(mod, attr, fn)


def train_batch(torch, cfg, step: int = 0, seq: int = TRAIN_SEQ,
                batch: int = TRAIN_BATCH, device="cuda"):
    from repro_torch.data.pipeline import DataIterator
    return {k: torch.from_numpy(v).to(device)
            for k, v in DataIterator(data_config(cfg, seq, batch)).peek(
                step).items()}


def data_config(cfg, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH):
    """5t's and 5d's data: ``batch`` sequences of ``seq`` text tokens from
    seed 0, with a vision model's patch embeddings or an encoder-decoder's
    ``seq`` frames."""
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, frontend=cfg.frontend,
                      frontend_dim=cfg.frontend_dim,
                      frontend_tokens=cfg.frontend_tokens,
                      encdec=cfg.is_encdec, seed=0)


def grads_by_leaf(grads) -> dict:
    return {".".join(path): g for path, g in _paths(grads)}


def check_grads(what: str, torch, grads) -> dict:
    """Every gradient leaf finite with a nonzero norm; their norms."""
    norms = {}
    for name, g in grads_by_leaf(grads).items():
        n = float(torch.linalg.vector_norm(g.float()))
        if not torch.isfinite(g).all() or n == 0.0:
            fail(f"{what}: the gradient of {name} is not finite or zero "
                 f"(norm {n}): a kernel cut the gradient")
        norms[name] = n
    return norms


def train_smoke_parity(torch, fg, arch: str) -> dict:
    """Phase 5t's smoke half: loss and gradients of the smoke model in
    float32 under mixed, card against CPU."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(4), cfg,
                            device="cpu")
    batch = train_batch(torch, cfg, seq=32, batch=2, device="cpu")
    out = {}
    for dev in ("cpu", "cuda", "cuda again", "plain"):
        on = "cpu" if dev == "cpu" else "cuda"
        with (plain_kernels(fg) if dev == "plain"
              else contextlib.nullcontext()):
            out[dev] = steps.loss_and_grads(
                cfg, tree_map(lambda t: t.to(on), params),
                {k: v.to(on) for k, v in batch.items()})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    # the same on the card with the kernels' plain versions: what is left
    # of the difference when the norm rounds as on the CPU
    plain = grads_by_leaf(out["plain"][1])
    check_grads(f"{arch} smoke train on the card", torch, gg)
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    cpu = grads_by_leaf(gc)
    errs = {name: float((g.cpu() - cpu[name]).abs().max()
                        / cpu[name].abs().max())
            for name, g in grads_by_leaf(gg).items()}
    worst = max(errs, key=errs.get)
    plain_err = max(float((g.cpu() - cpu[name]).abs().max()
                          / cpu[name].abs().max())
                    for name, g in plain.items())
    # the card against itself: the backwards of the embedding's gather and
    # of the MoE combine's torch.gather add with atomics, in no fixed order
    again = grads_by_leaf(out["cuda again"][1])
    rerun = {name: float((g - again[name]).abs().max()
                         / cpu[name].abs().max())
             for name, g in grads_by_leaf(gg).items()}
    rerun_worst = max(rerun, key=rerun.get)
    log(f"  {arch} smoke float32 mixed: loss {float(lg):.6f} (|cuda - cpu| "
        f"{loss_err:.2e} relative), {len(cpu)} gradient leaves within "
        f"{errs[worst]:.2e} of their largest entry ({worst}); with the "
        f"kernels' plain versions on the card {plain_err:.2e}; a second "
        f"card run differs from the first by {rerun[rerun_worst]:.2e} "
        f"({rerun_worst}), its loss by "
        f"{abs(float(out['cuda again'][0]) - float(lg)):.2e}")
    if errs[worst] > TRAIN_SMOKE_TOL:
        fail(f"{arch} smoke train: the gradient of {worst} on the card "
             f"differs from the CPU by {errs[worst]} of its largest entry")
    if loss_err > TRAIN_SMOKE_LOSS_RTOL:
        fail(f"{arch} smoke train: loss {float(lg)} on the card, "
             f"{float(lc)} on the CPU")
    return {"loss": float(lg), "loss_rel_err": loss_err,
            "grad_max_rel_err": errs, "plain_on_card_max_rel_err": plain_err,
            "card_rerun_max_rel_err": rerun}


def train_vs_plain(torch, fg, what: str, cfg, params, batch,
                   floor: bool = False) -> dict:
    """Step 1 at the train shapes with every kernel launch held against its
    plain version on the same operands (:func:`checked_kernels`), and its
    loss and gradients against the same step run on the plain versions;
    every kernel-run leaf finite and nonzero.  With ``floor``, the kernels'
    step again under :func:`wkv_output_jitter`, its distance from the
    kernels' step reported beside (the distance a last-bit difference
    makes)."""
    from repro_torch.launch import steps
    t0 = time.monotonic()
    with checked_kernels(torch, fg, what) as seen:
        loss_k, grads_k = steps.mean_loss_and_grads(cfg, params, batch)
    norms = check_grads(what, torch, grads_k)
    t_k = time.monotonic() - t0
    if not seen:
        fail(f"{what}: step 1 launched no kernel")
    log(f"  {what} step 1: every kernel launch held against its plain "
        f"version on the same operands (fused GEMMs torch.equal, norms and "
        f"LoRA products within 5r's tolerance, the scans within 3w's and "
        f"3s's, their backwards within BWD_TOL), {sum(seen.values())} "
        f"launches at "
        + ", ".join(f"{k} {'x'.join(map(str, sh))} ({n})"
                    for (k, sh), n in sorted(seen.items())))
    t0 = time.monotonic()
    with plain_kernels(fg):
        loss_p, grads_p = steps.mean_loss_and_grads(cfg, params, batch)
    t_p = time.monotonic() - t0
    loss_err, errs, worst = step_distance(torch, loss_k, grads_k, loss_p,
                                          grads_p)
    log(f"  {what} step 1, kernels vs plain versions on the card: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} ({loss_err:.2e} "
        f"relative); gradients' relative L2 distance at most "
        f"{errs[worst]:.2e} ({worst}); {len(errs)} leaves finite and "
        f"nonzero (smallest norm {min(norms.values()):.3e}); "
        f"{t_k:.1f} s with the kernels (each launch checked), {t_p:.1f} s "
        f"plain")
    if loss_err > TRAIN_PLAIN_LOSS_RTOL:
        fail(f"{what}: step 1's loss with the kernels {float(loss_k)} vs "
             f"{float(loss_p)} with their plain versions")
    if errs[worst] > TRAIN_PLAIN_GRAD_RTOL:
        fail(f"{what}: the gradient of {worst} with the kernels is "
             f"{errs[worst]} (relative L2) from the plain versions'")
    del grads_p
    out = {"loss": float(loss_k), "plain_loss": float(loss_p),
           "loss_rel_err": loss_err, "grad_rel_l2": errs,
           "grad_norms": norms, "s_kernels_checked": t_k, "s_plain": t_p,
           "checked_launches": {f"{k} {'x'.join(map(str, sh))}": n
                                for (k, sh), n in sorted(seen.items())}}
    if floor:
        with wkv_output_jitter(torch):
            loss_j, grads_j = steps.mean_loss_and_grads(cfg, params, batch)
        j_loss, j_errs, j_worst = step_distance(torch, loss_j, grads_j,
                                                loss_k, grads_k)
        log(f"  {what} step 1, the kernels' step with the WKV forward's "
            f"output one fp32 ulp off on half its entries, against the "
            f"kernels' step: loss {j_loss:.2e} relative; gradients' "
            f"relative L2 distance at most {j_errs[j_worst]:.2e} "
            f"({j_worst}), median "
            f"{statistics.median(j_errs.values()):.2e} (kernels vs plain: "
            f"median {statistics.median(errs.values()):.2e})")
        out["jitter_floor"] = {"loss_rel_err": j_loss, "grad_rel_l2": j_errs}
        del grads_j
    del grads_k
    return out


def step_distance(torch, loss_k, grads_k, loss_p, grads_p):
    """(the loss's relative error, {leaf: relative L2 distance}, the worst
    leaf) of a step's loss and gradients against another run's."""
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    plain = grads_by_leaf(grads_p)
    errs = {}
    for name, g in grads_by_leaf(grads_k).items():
        ref = plain[name]
        errs[name] = float(torch.linalg.vector_norm(g - ref)
                           / torch.linalg.vector_norm(ref))
    return loss_err, errs, max(errs, key=errs.get)


@contextlib.contextmanager
def wkv_output_jitter(torch):
    """The WKV forward kernel's output moved one fp32 ulp, up or down, on a
    random half of its entries (the same entries at every call of a shape,
    so remat's recompute sees what the forward saw): a change smaller than
    the kernel's distance from its plain version (phase 3w), to read how
    far the train step carries a last-bit difference."""
    from repro_torch.kernels import wkv_gemm
    launch = wkv_gemm._launch

    def jittered(*args, **kw):
        y = launch(*args, **kw)
        gen = torch.Generator(device=y.device).manual_seed(1)
        pick = torch.rand(y.shape, generator=gen, device=y.device) < 0.5
        up = torch.rand(y.shape, generator=gen, device=y.device) < 0.5
        inf = torch.full_like(y, float("inf"))
        return torch.where(pick, torch.nextafter(
            y, torch.where(up, inf, -inf)), y)

    wkv_gemm._launch = jittered
    try:
        yield
    finally:
        wkv_gemm._launch = launch


def train_none_vs_plain(torch, fg, what: str, cfg, params, batch,
                        loss_rtol: float, grad_rtol: float) -> dict:
    """Step 1 under quant none with the kernels (unchecked: the WKV forward
    and backward, the LoRA products, the norms) against the same step on
    their plain versions, the loss within ``loss_rtol`` relative and every
    leaf within ``grad_rtol`` relative L2.  Nothing is quantized, so no
    activation code can flip: what is left is the kernels' own fp32 orders,
    carried through the config's compute dtype."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps
    reset_all(fg)
    t0 = time.monotonic()
    loss_k, grads_k = steps.mean_loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    t_k = time.monotonic() - t0
    ran = {k: n for k, n in launch_counts().items() if n}
    if not all(ran.get(k) for k in ("wkv", "wkv_bwd", "rowinv_matmul",
                                    "rowinv_norm")):
        fail(f"{what}: step 1 did not launch every recurrent kernel: {ran}")
    t0 = time.monotonic()
    with plain_kernels(fg):
        loss_p, grads_p = steps.mean_loss_and_grads(cfg, params, batch)
    t_p = time.monotonic() - t0
    loss_err, errs, worst = step_distance(torch, loss_k, grads_k, loss_p,
                                          grads_p)
    log(f"  {what} step 1, kernels vs plain versions on the card (no code "
        f"can flip): loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
        f"({loss_err:.2e} relative); gradients' relative L2 distance at "
        f"most {errs[worst]:.2e} ({worst}; gate {grad_rtol}); launches "
        f"{ran}; {t_k:.1f} s with the kernels, {t_p:.1f} s plain")
    if loss_err > loss_rtol:
        fail(f"{what}: step 1's loss with the kernels {float(loss_k)} vs "
             f"{float(loss_p)} with their plain versions")
    if errs[worst] > grad_rtol:
        fail(f"{what}: the gradient of {worst} with the kernels is "
             f"{errs[worst]} (relative L2) from the plain versions'")
    del grads_k, grads_p
    return {"compute_dtype": cfg.compute_dtype, "loss": float(loss_k),
            "plain_loss": float(loss_p), "loss_rel_err": loss_err,
            "grad_rel_l2": errs, "launches": ran, "s_kernels": t_k,
            "s_plain": t_p}


def counted(torch, fg, fn, device="cuda"):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, launches, routes, seconds)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.quant import qmatmul
    if device == "cuda":
        torch.cuda.synchronize()
    reset_all(fg)
    t0 = time.monotonic()
    res = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return (res, nonzero(launch_counts()), qmatmul.gemm_routes(),
            time.monotonic() - t0)


def check_train_counts(what: str, host: dict, routes: dict,
                       expect: dict) -> None:
    """Exactly ``expect`` launches, every quantized GEMM on the kernels."""
    gemms = sum(n for k, n in expect.items()
                if k.startswith(("dense_", "grouped_")))
    if host != expect:
        fail(f"{what}: launches {host}, expected {expect}: a quantized "
             f"GEMM or a norm bypassed its kernel")
    if routes != {("cuda", "cuda"): gemms}:
        fail(f"{what}: quantized GEMM routes {routes}, expected "
             f"{gemms} on the kernels and none on the ATen route")


def counted_training(torch, fg, what: str, cfg, tc, dcfg, expect: dict):
    """One ``run_training`` with every launch count set to 0 just before
    and read just after: exactly ``expect`` launches, every quantized GEMM
    on the kernels.  Returns the result, the launches and the timing."""
    from repro_torch.train.loop import run_training
    torch.cuda.reset_peak_memory_stats()
    res, host, routes, wall = counted(
        torch, fg, lambda: run_training(cfg, tc, dcfg, device="cuda"))
    check_train_counts(what, host, routes, expect)
    steady = res.step_seconds[1:] or res.step_seconds
    step_s = statistics.mean(steady)
    tokens = dcfg.seq_len * dcfg.global_batch
    out = {"launches": {"host": host},
           "routes": {f"{b}/{r}": c for (b, r), c in routes.items()},
           "losses": res.losses, "wall_s": wall,
           "step_ms": [1e3 * s for s in res.step_seconds],
           "steady_step_ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {what}: {len(res.step_seconds)} steps, losses "
        + ", ".join(f"{v:.4f}" for v in res.losses.values())
        + f"; launches {host} (derived, exact), routes "
        f"{out['routes']}; step {out['steady_step_ms']:.1f} ms after the "
        f"first ({out['step_ms'][0]:.1f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_gb']:.2f} GB")
    return res, out


def ragged_ste_check(torch, fg, cfg, seq: int) -> dict:
    """The ragged STE core at the model's expert shape on the card (its
    capacity at ``seq`` tokens, one sequence a microbatch): the forward
    torch.equal to the plain version, dead rows' dx exactly zero, dw
    torch.equal to x^T @ (g on live rows)."""
    from repro_torch.models import moe
    from repro_torch.quant import qmatmul
    e, d = cfg.n_experts, cfg.d_model
    fe = cfg.d_ff_expert or cfg.d_ff
    cap = moe._capacity(seq, cfg.top_k, e, cfg.capacity_factor)
    gen = torch.Generator("cuda").manual_seed(9)
    x = torch.randn((e, cap, d), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    w = (0.05 * torch.randn((e, d, fe), generator=gen, device="cuda")).to(
        torch.bfloat16).requires_grad_()
    counts = torch.randint(0, cap + 1, (e, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    counts[:3] = torch.tensor([[0], [cap], [1]], dtype=torch.int32)
    g = torch.randn((e, cap, fe), generator=gen, device="cuda").to(
        torch.bfloat16)
    bits = cfg.quant.bits_for("blk0.moe.wi")
    out = qmatmul.quantized_matmul_batched(x, w, bits, counts=counts,
                                           seg=cap)
    out.backward(g)
    with torch.no_grad(), plain_kernels(fg):
        ref = qmatmul.quantized_matmul_batched(x, w, bits, counts=counts,
                                               seg=cap)
    live = (torch.arange(cap, device="cuda")[None, :, None]
            < counts[:, :, None])
    gl = torch.where(live, g.float(), torch.zeros((), device="cuda"))
    dw = torch.bmm(x.detach().float().transpose(1, 2), gl).to(w.dtype)
    dead = int((~live).sum())
    if not torch.equal(out, ref):
        fail("ragged STE: the grouped kernel's forward differs from its "
             "plain version")
    if bool(x.grad.masked_select(~live).any()):
        fail("ragged STE: a dead row got a nonzero gradient")
    if not torch.equal(w.grad, dw):
        fail("ragged STE: dw differs from x^T @ (g on live rows)")
    log(f"  ragged STE at E={e} C={cap} K={d} N={fe} (w={bits}): forward "
        f"torch.equal to the plain version, {dead} dead rows with dx "
        f"exactly 0, dw torch.equal to x^T g on the live rows")
    return {"E": e, "C": cap, "K": d, "N": fe, "dead_rows": dead}


def deterministic(torch):
    """A context under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` that records the ops warning they have no
    deterministic kernel."""
    import warnings

    @contextlib.contextmanager
    def ctx():
        seen = []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield seen
            seen.extend(sorted({str(w.message).split(" does not have")[0]
                                for w in caught
                                if "deterministic" in str(w.message)}))
        finally:
            torch.use_deterministic_algorithms(False)

    return ctx()


def mamba_block_train(torch, fg) -> dict:
    """Phase 5t, jamba: one full-width mamba layer (d 4096, d_inner 8192,
    d_state 16, dt rank 256) under mixed, fp32 params from a seeded
    generator and their bf16 compute copy, ``mamba_apply`` forward and
    backward on one sequence of TRAIN_SEQ: every launch against its plain
    version (:func:`checked_kernels`), the gradients against the same run
    on the plain versions (TRAIN_PLAIN_GRAD_RTOL), every gradient finite
    and nonzero, exactly one launch of each GEMM, the scan and its
    backward a run; fwd + bwd ms and peak GB over JAMBA_BLOCK_RUNS runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import ssm as S

    cfg = get_config("jamba-v0.1-52b", quant="mixed")
    name = "blk0.mamba"
    gen = torch.Generator("cuda").manual_seed(5)
    params = S.mamba_init(gen, cfg, torch.float32, "cuda")
    x0 = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    g = torch.randn(x0.shape, generator=gen, device="cuda").to(
        torch.bfloat16)

    def run():
        leaves = {k: t.detach().requires_grad_() for k, t in params.items()}
        x = x0.clone().requires_grad_()
        tree = steps.cast_params(cfg, {"mamba": leaves})["mamba"]
        out = S.mamba_apply(tree, x, cfg, cfg.quant, name)
        grads = torch.autograd.grad(out, [x] + list(leaves.values()), g)
        return {"x": grads[0], **dict(zip(leaves, grads[1:]))}

    def mode(p):
        return fg.resolve(cfg.quant.bits_for(f"{name}.{p}"), cfg.quant.m)[0]

    expect: dict = {"ssm_scan": 1, "ssm_scan_bwd": 1}
    for p in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        expect[f"dense_{mode(p)}"] = expect.get(f"dense_{mode(p)}", 0) + 1
    what = "jamba mamba block train (full width, seq 256)"
    with checked_kernels(torch, fg, what) as seen:
        grads_k = run()
    norms = check_grads(what, torch, grads_k)
    with plain_kernels(fg):
        grads_p = run()
    errs = {k: float(torch.linalg.vector_norm(v.float() - p.float())
                     / torch.linalg.vector_norm(p.float()))
            for (k, v), p in zip(grads_k.items(), grads_p.values())}
    worst = max(errs, key=errs.get)
    if errs[worst] > TRAIN_PLAIN_GRAD_RTOL:
        fail(f"{what}: the gradient of {worst} with the kernels is "
             f"{errs[worst]} (relative L2) from the plain versions'")
    del grads_k, grads_p
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(JAMBA_BLOCK_RUNS):
        reset_all(fg)
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.monotonic() - t0))
        host = nonzero(launch_counts())
        if host != expect:
            fail(f"{what}: launches {host}, expected {expect}")
    out = {"launches": {"host": host}, "ms": times,
           "steady_ms": statistics.mean(times[1:]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grad_rel_l2": errs, "grad_norms": norms,
           "checked_launches": {f"{k} {'x'.join(map(str, sh))}": n
                                for (k, sh), n in sorted(seen.items())}}
    log(f"  {what}: every launch held against its plain version ("
        + ", ".join(f"{k} {'x'.join(map(str, sh))} ({n})"
                    for (k, sh), n in sorted(seen.items()))
        + f"); gradients vs the plain versions' at most {errs[worst]:.2e} "
        f"relative L2 ({worst}), {len(norms)} finite and nonzero; launches "
        f"{host} a run (exact); fwd + bwd {out['steady_ms']:.1f} ms after "
        f"the first ({times[0]:.1f}), peak {out['peak_gb']:.2f} GB.  No "
        f"whole jamba step trains on one card: one 8-layer period holds "
        f"~12.8 B params, ~400 GB of training state")
    return out


def train_phase(torch, fg) -> dict:
    """Phase 5t (see the module docstring)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.loop import TrainConfig, run_training

    report: dict = {"smoke": {a: train_smoke_parity(torch, fg, a) for a in
                              ("llama3.2-1b", "granite-moe-3b-a800m",
                               "rwkv6-3b", "jamba-v0.1-52b")}}
    ocfg = optim.AdamWConfig(lr=1e-4, warmup_steps=1,
                             total_steps=TRAIN_STEPS)
    for arch, periods, n_steps in (
            ("llama3.2-1b", None, TRAIN_STEPS),
            ("granite-moe-3b-a800m", TRAIN_GRANITE_PERIODS,
             TRAIN_GRANITE_STEPS),
            ("rwkv6-3b", TRAIN_RWKV_PERIODS, TRAIN_RWKV_STEPS)):
        cfg = get_config(arch, quant="mixed")
        what = f"{arch} train mixed"
        if periods:
            cfg = dataclasses.replace(cfg, n_periods=periods)
            what += f", {periods} periods"
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
        rep = report[arch] = {"n_periods": cfg.n_periods,
                              "microbatches": cfg.n_microbatches}
        if cfg.n_experts:
            rep["ragged_ste"] = ragged_ste_check(
                torch, fg, cfg, TRAIN_SEQ)
        params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                                device="cuda")
        rep["params"] = param_count(params)
        rep["step1"] = train_vs_plain(torch, fg, what, cfg, params,
                                      train_batch(torch, cfg),
                                      floor=arch == "rwkv6-3b")
        if arch == "rwkv6-3b":
            # where step 1's distance comes from: quant none in bf16 (no
            # code flips) and in fp32 (no bf16 rounding to carry it)
            for dtype, gates in (("bfloat16", (TRAIN_PLAIN_LOSS_RTOL,
                                               TRAIN_PLAIN_GRAD_RTOL)),
                                 ("float32", (TRAIN_FP32_LOSS_RTOL,
                                              TRAIN_FP32_GRAD_RTOL))):
                ncfg = dataclasses.replace(
                    get_config(arch, quant="none"), n_periods=cfg.n_periods,
                    compute_dtype=dtype,
                    bf16_cast_params=dtype == "bfloat16")
                rep[f"step1_none_{dtype}"] = train_none_vs_plain(
                    torch, fg, f"{arch} train none {dtype}, {periods} "
                    f"periods", ncfg, params, train_batch(torch, ncfg),
                    *gates)
        del params
        torch.cuda.empty_cache()
        expect = train_launches(cfg, n_steps, TRAIN_SEQ)
        log(f"  {what}: derived launches for {n_steps} steps of "
            f"{cfg.n_microbatches} microbatches: {expect}")
        tc = TrainConfig(steps=n_steps, log_every=1, optimizer=ocfg)
        # the counted, timed run as users run it: not deterministic (its
        # params and state are dropped here, not held through the next
        # config's run)
        rep["counted"] = counted_training(
            torch, fg, what, cfg, tc, dcfg, expect)[1]
        gc.collect()
        torch.cuda.empty_cache()
        if arch != "llama3.2-1b":
            continue
        cfg = dataclasses.replace(cfg, n_periods=TRAIN_RESTART_PERIODS)
        what += f", {TRAIN_RESTART_PERIODS} periods"
        with deterministic(torch) as nondet:
            # the restart gate, under deterministic algorithms: 4 straight
            # steps; 2 steps and the run's checkpoint, then a fresh run
            # resuming from it for the other 2
            torch.cuda.synchronize()
            t0 = time.monotonic()
            straight = run_training(cfg, tc, dcfg, device="cuda")
            torch.cuda.synchronize()
            det_s = time.monotonic() - t0
            det_steady = straight.step_seconds[1:] or straight.step_seconds
            rep["deterministic_step_ms"] = 1e3 * statistics.mean(det_steady)
            log(f"  {what}: the same {n_steps} steps under deterministic "
                f"algorithms (the restart gate's reference, not the "
                f"user-facing time): step {rep['deterministic_step_ms']:.1f}"
                f" ms after the first, {det_s:.1f} s in all")
            ck = ROOT / "build" / "scratch" / "train_ckpt"
            shutil.rmtree(ck, ignore_errors=True)
            t0 = time.monotonic()
            half = dataclasses.replace(tc, steps=n_steps // 2,
                                       ckpt_dir=str(ck), ckpt_keep=1)
            run_training(cfg, half, dcfg, device="cuda")
            half_s = time.monotonic() - t0
            resumed = run_training(cfg, dataclasses.replace(
                half, steps=n_steps), dcfg, device="cuda")
            restart_s = time.monotonic() - t0
            shutil.rmtree(ck, ignore_errors=True)
        if resumed.restored_from != n_steps // 2:
            fail(f"{what}: the fresh run resumed from "
                 f"{resumed.restored_from}, not step {n_steps // 2}")
        mine = {"params": straight.params, "mu": straight.opt_state.mu,
                "nu": straight.opt_state.nu,
                "step": straight.opt_state.step}
        theirs = {"params": resumed.params, "mu": resumed.opt_state.mu,
                  "nu": resumed.opt_state.nu,
                  "step": resumed.opt_state.step}
        diff = [".".join(p) for (p, a), (_, b) in zip(_paths(mine),
                                                      _paths(theirs))
                if not torch.equal(a, b)]
        if diff:
            fail(f"{what}: after a restart at step {n_steps // 2}, "
                 f"{len(diff)} leaves differ from {n_steps} straight "
                 f"steps ({diff[:4]}); ops without a deterministic kernel: "
                 f"{nondet or 'none'}")
        rep["restart"] = {"bit_exact": True, "seconds": restart_s,
                          "first_run_s": half_s,
                          "nondeterministic_ops": nondet}
        log(f"  {what}: 2 steps + checkpoint + a resumed run of 2: params, "
            f"mu, nu and step torch.equal to {n_steps} straight steps "
            f"(deterministic algorithms; ops without a deterministic "
            f"kernel: {nondet or 'none'}); {restart_s:.1f} s, the first run "
            f"and its save {half_s:.1f} s")
        del straight, resumed, mine, theirs
        gc.collect()
        torch.cuda.empty_cache()
    report["jamba-v0.1-52b"] = {"mamba_block": mamba_block_train(torch, fg)}
    return report


# ---------------------------------------------------------------------------
# Phase 5m: distributed serving.
# ---------------------------------------------------------------------------


def mesh_requests(np, cfg, prompts=DENSE_PROMPTS):
    """Phase 5m's requests: ``prompts``' lengths (DENSE_PROMPTS': 4
    requests, two to each data rank of a 2 x 2 mesh), MESH_NEW new tokens;
    admitted into slots 0, 1, ... in order."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab_size,
                                                         n)],
                    max_new_tokens=MESH_NEW)
            for n in prompts]


@contextlib.contextmanager
def sampled_rows(rows: dict):
    """Record the logits row every sample draws from, by (request id,
    step), the first one only (a padding lane samples as request 0, step
    0, after request 0's own first sample)."""
    from repro_torch.serve import executor as ex
    inner = ex.Executor.sample

    def recording(self, seed, logits, temps, rids, steps):
        for lane, (rid, step) in enumerate(zip(rids, steps)):
            rows.setdefault((int(rid), int(step)), logits[lane].clone())
        return inner(self, seed, logits, temps, rids, steps)

    ex.Executor.sample = recording
    try:
        yield rows
    finally:
        ex.Executor.sample = inner


@contextlib.contextmanager
def grouped_experts(fg):
    """The expert count of every grouped kernel launch while entered (the
    launch seam ``fg._launch``; its B operand is (E, K, N))."""
    seen = []
    inner = fg._launch

    def spy(a, b, *args, **kw):
        if a.dim() == 3:
            seen.append(int(b.shape[0]))
        return inner(a, b, *args, **kw)

    fg._launch = spy
    try:
        yield seen
    finally:
        fg._launch = inner


# The launch seams of the recurrent kernels (kernels.wkv_gemm,
# kernels.ssm_scan) and the operand dim holding a launch's heads or
# channels: a stream's (B, S, H, D) dim 2, x's (B, S, d_inner) dim 2.
RECURRENT_SEAMS = (("wkv_gemm", "_launch", "wkv"),
                   ("wkv_gemm", "_bwd_launch", "wkv_bwd"),
                   ("ssm_scan", "_launch", "ssm_scan"),
                   ("ssm_scan", "_bwd_launch", "ssm_scan_bwd"))


@contextlib.contextmanager
def recurrent_widths():
    """The heads (WKV) or channels (the scan) of every launch of the
    recurrent kernels and their backwards while entered, by launch key."""
    import importlib
    seen: dict = {key: set() for _, _, key in RECURRENT_SEAMS}
    saved = []
    for mod_name, attr, key in RECURRENT_SEAMS:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        inner = getattr(mod, attr)
        saved.append((mod, attr, inner))

        def spy(x, *args, _inner=inner, _key=key, **kw):
            seen[_key].add(int(x.shape[2]))
            return _inner(x, *args, **kw)

        setattr(mod, attr, spy)
    try:
        yield seen
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def mesh_widths(cfg, model: int, train: bool) -> dict:
    """The heads or channels every launch of each recurrent kernel runs
    over on a rank of a ``model``-way mesh (its block where ``model``
    divides them), by launch key; none for a model without the block, and
    none for the backwards where not ``train``."""
    def block(n):
        return n // model if n % model == 0 else n

    kinds = {spec.kind for spec in cfg.pattern}
    out = {key: [] for _, _, key in RECURRENT_SEAMS}
    for kind, key, n in (("rwkv", "wkv", cfg.d_model // cfg.rwkv_head_dim),
                         ("mamba", "ssm_scan", cfg.expand * cfg.d_model)):
        if kind in kinds:
            out[key] = [block(n)]
            if train:
                out[f"{key}_bwd"] = [block(n)]
    return out


def widths_of(seen: dict) -> dict:
    return {k: sorted(v) for k, v in seen.items()}


def world_of_one_pair(torch, np, fg, what: str, pcfg, qparams, mesh,
                      per_call, prompts=DENSE_PROMPTS, requests=None,
                      **engine_kw) -> tuple:
    """The engine without a mesh and with ``mesh`` (a world of one), each
    warmed and graphed, under the exact launch and graph-node gates:
    tokens and every sampled logits row torch.equal.  ``requests(np,
    pcfg)`` makes the requests where given (else :func:`mesh_requests` of
    ``prompts``), ``engine_kw`` go to both engines (the prefix cache's:
    its stats reported).  Returns the report and the unsharded run's
    rows."""
    from repro_torch.serve.engine import Engine
    out, runs = {}, {}
    for label, m in (("no mesh", None), ("mesh 1x1", mesh)):
        eng = Engine(pcfg, qparams, max_seq=256, batch_size=4,
                     device="cuda", mesh=m, **engine_kw)
        if not eng.executor.graphs:
            fail(f"5m (a) {what} {label}: decode is not graphed")
        eng.warm()
        reqs = (requests(np, pcfg) if requests is not None
                else mesh_requests(np, pcfg, prompts))
        with sampled_rows({}) as rows:
            run = serve_counted(torch, fg, eng, reqs)
        run["launches"] = check_counted(f"5m (a) {what} {label}", eng, run,
                                        per_call)
        run["rows"] = rows
        runs[label] = run
        out[label] = {"launches": run["launches"],
                      "decode_s": run["stats"].decode_s,
                      "decode_steps": run["stats"].decode_steps,
                      "tokens": run["tokens"]}
        if eng.prefix is not None:
            out[label]["prefix"] = eng.prefix.stats()
        del eng
    base, got = runs["no mesh"], runs["mesh 1x1"]
    if got["tokens"] != base["tokens"] or base["rows"].keys() != \
            got["rows"].keys() or not all(
                torch.equal(got["rows"][k], base["rows"][k])
                for k in base["rows"]):
        fail(f"5m (a) {what}: the engine on the world of one differs from "
             f"the engine without a mesh (tokens or logits)")
    log(f"  (a) {what} on a world of one (NCCL): graphed, "
        f"{len(base['rows'])} logits rows and every token torch.equal to "
        f"the engine without a mesh; launches exact "
        f"({nonzero(per_call)} a call)")
    return out, base["rows"]


def save_records(torch, qparams, path: Path) -> None:
    """Records to the host file (b)'s ranks map, key paths joined by /;
    then its ready file, which releases the ranks."""
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"/".join(p): leaf.cpu() for p, leaf in _paths(qparams)},
               path)
    ready_file(path).touch()


def mesh_world_of_one(torch, np, fg) -> dict:
    """Phase 5m (a): the engine on a world of one (NCCL) against the engine
    without a mesh, both warmed and graphed, llama then granite; and an
    NCCL collective captured in a CUDA graph.  Saves (b)'s records."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_backend, single_device_mesh

    pcfg = path_config(MESH_ARCH, "mixed")
    per_call = full_per_call(MESH_ARCH)
    qparams, init = leafwise_init(torch, pcfg)
    mesh = single_device_mesh(device="cuda")
    if mesh_backend(mesh) != "nccl":
        fail(f"the world of one runs {mesh_backend(mesh)!r}, not NCCL")
    out = {"init": init, "backend": "nccl"}
    pair, base_rows = world_of_one_pair(torch, np, fg, MESH_ARCH, pcfg,
                                        qparams, mesh, per_call)
    out.update(pair)
    # an NCCL all-gather and all-reduce captured and replayed
    group = mesh.get_group("data")
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    gathered = torch.empty(8, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        dist.all_gather_into_tensor(gathered, x, group=group)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dist.all_gather_into_tensor(gathered, x * 2, group=group)
        reduced = x.clone()
        dist.all_reduce(reduced, group=group)
    x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(gathered, 2 * x) and torch.equal(reduced, x)):
        fail("5m (a): an NCCL collective captured in a CUDA graph replayed "
             "wrong values")
    out["nccl_in_graph"] = True
    log("  (a) an NCCL all-gather and all-reduce replay in a CUDA graph")
    del qparams, base_rows
    gc.collect()
    torch.cuda.empty_cache()
    out["cut"] = mesh_cut_reference(torch, np, fg,
                                    *cut_config(MESH_ARCH, MESH_PERIODS),
                                    MESH_PARAMS)
    # granite, full width and depth
    mcfg, m_call = (path_config(MESH_MOE_ARCH, "mixed"),
                    full_per_call(MESH_MOE_ARCH))
    qparams, minit = leafwise_init(torch, mcfg)
    pair, _ = world_of_one_pair(torch, np, fg, MESH_MOE_ARCH, mcfg,
                                qparams, mesh, m_call)
    out["moe"] = {"init": minit, **pair}
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_cut"] = mesh_cut_reference(torch, np, fg, *cut_config(
        MESH_MOE_ARCH, MESH_MOE_PERIODS),
                                        MESH_MOE_PARAMS)
    t0 = time.monotonic()
    out.update(recurrent_world_of_one(torch, np, fg, mesh))
    out["recurrent_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out.update(prefix_world_of_one(torch, np, fg, mesh))
    out["prefix_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["frontends"] = frontend_references(torch, fg)
    out["frontends_s"] = time.monotonic() - t0
    dist.destroy_process_group()
    return out


def recurrent_world_of_one(torch, np, fg, mesh) -> dict:
    """Phase 5m (a) (c): rwkv6-3b at full depth on the world of one against
    the engine without a mesh, then (b)'s unsharded rwkv engine at
    MESH_RWKV_PERIODS; jamba at MESH_JAMBA_PERIODS the same way, whose
    engine without a mesh is (b)'s reference.  Requests of
    MESH_RECURRENT_PROMPTS tokens."""
    out = {}
    rcfg = path_config(MESH_RWKV_ARCH, "mixed")
    qparams, init = leafwise_init(torch, rcfg)
    pair, _ = world_of_one_pair(torch, np, fg, MESH_RWKV_ARCH, rcfg, qparams,
                                mesh, full_per_call(MESH_RWKV_ARCH),
                                MESH_RECURRENT_PROMPTS)
    out["rwkv"] = {"init": init, **pair}
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["rwkv_cut"] = mesh_cut_reference(
        torch, np, fg, *cut_config(MESH_RWKV_ARCH, MESH_RWKV_PERIODS), None,
        MESH_RECURRENT_PROMPTS)
    jcfg, j_call = cut_config(MESH_JAMBA_ARCH, MESH_JAMBA_PERIODS)
    qparams, init = leafwise_init(torch, jcfg)
    pair, rows = world_of_one_pair(torch, np, fg, MESH_JAMBA_ARCH, jcfg,
                                   qparams, mesh, j_call,
                                   MESH_RECURRENT_PROMPTS)
    out["jamba"] = {"init": init, **pair}
    out["jamba_cut"] = {"init": init, "launches": pair["no mesh"]["launches"],
                        "tokens": pair["no mesh"]["tokens"],
                        "rows": {f"{k[0]}/{k[1]}": v.cpu()
                                 for k, v in rows.items()}}
    del qparams, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefix_requests(np, cfg):
    """5m (d)'s requests: PREFIX_REQUESTS greedy prompts of PREFIX_LENS
    tokens, the first PREFIX_SHARED of every one the same, PREFIX_NEW new
    tokens each."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(3)
    head = [int(t) for t in rng.integers(1, cfg.vocab_size, PREFIX_SHARED)]
    lo, hi = PREFIX_LENS
    return [Request(prompt=head + [int(t) for t in rng.integers(
        1, cfg.vocab_size, int(n) - PREFIX_SHARED)],
                    max_new_tokens=PREFIX_NEW)
            for n in rng.integers(lo, hi + 1, PREFIX_REQUESTS)]


PREFIX_ENGINE = {"prefill_chunk": PREFIX_CHUNK, "prefix_cache": True}


@contextlib.contextmanager
def admitted_slots():
    """The slot every request is admitted into while entered, by request
    id."""
    from repro_torch.serve.engine import Engine
    slots = {}
    inner = Engine._init_slot

    def admitted(self, idx, req):
        slots[req.stats.rid] = idx
        return inner(self, idx, req)

    Engine._init_slot = admitted
    try:
        yield slots
    finally:
        Engine._init_slot = inner


def prefix_world_of_one(torch, np, fg, mesh) -> dict:
    """Phase 5m (a) (d): each MESH_PREFIX model at its depth on records
    from the leaf-wise init, chunked with the prefix cache on, without a
    mesh and on the world of one (graphed, torch.equal); the unsharded
    run is (b)'s reference (its tokens, rows and prefix stats)."""
    out = {}
    for what, arch, periods in MESH_PREFIX:
        cfg, per_call = cut_config(arch, periods)
        qparams, init = leafwise_init(torch, cfg)
        pair, rows = world_of_one_pair(
            torch, np, fg, f"{arch} prefix cache", cfg, qparams, mesh,
            per_call, requests=prefix_requests, **PREFIX_ENGINE)
        base = pair["no mesh"]
        if base["prefix"]["hits"] < 1:
            fail(f"5m (a) {arch}: the prefix cache never hit: "
                 f"{base['prefix']}")
        out[what] = {"init": init, **pair,
                     "rows": {f"{k[0]}/{k[1]}": v.cpu()
                              for k, v in rows.items()}}
        log(f"  (a) {arch} at {periods} periods, chunks of {PREFIX_CHUNK} "
            f"and the prefix cache: {base['prefix']}")
        del qparams, rows
        gc.collect()
        torch.cuda.empty_cache()
    return out


def frontend_cut(arch: str, periods: int, encoder: int):
    """A front end's model under mixed at ``periods`` (and ``encoder``
    encoder periods, where it has an encoder)."""
    cfg = dataclasses.replace(path_config(arch, "mixed"), n_periods=periods)
    if encoder:
        cfg = dataclasses.replace(cfg, encoder_periods=encoder)
    return cfg


def frontend_per_call(cfg) -> tuple:
    """(a prefill's, a decode step's) launches of llava or seamless under
    mixed at ``cfg``'s depth, as VISION_* and ENCDEC_* count them at full
    depth: the projector's 2 GEMMs in the prefill; a llava period 7 GEMMs
    and 2 norms; a seamless encoder period 6 GEMMs and 2 norms (enc_ln_f
    once), a decoder period 8 GEMMs (its memory's wk and wv 2 more in the
    prefill) and 3 norms; the w=12 head and ln_f once."""
    p = cfg.n_periods
    if cfg.is_encdec:
        e = cfg.encoder_periods
        pre = {"dense_mm1": 2 + 6 * e + 10 * p, "rowinv_norm": 2 * e + 3 * p
               + 2}
        step = {"dense_mm1": 8 * p, "rowinv_norm": 3 * p + 1}
    else:
        pre = {"dense_mm1": 2 + 7 * p, "rowinv_norm": 2 * p + 1}
        step = {"dense_mm1": 7 * p, "rowinv_norm": 2 * p + 1}
    return pre | {"dense_kmm2": 1}, step | {"dense_kmm2": 1}


def frontend_inputs(torch, cfg):
    """5m (d)'s streams, drawn on the card from a seeded generator (the
    same on every process): tokens, the vision prefix's patch embeddings
    or the encoder's frames, and the cache length."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    b = MESH_FRONT_STREAMS
    if cfg.is_encdec:
        toks = torch.randint(1, cfg.vocab_size, (b, MESH_ENCDEC_PROMPT),
                             generator=gen, device="cuda")
        return toks, {"enc_frames": torch.randn(
            (b, MESH_ENCDEC_FRAMES, cfg.frontend_dim), generator=gen,
            device="cuda")}, ENCDEC_MAX_SEQ
    toks = torch.randint(1, cfg.vocab_size, (b, MESH_VISION_TEXT),
                         generator=gen, device="cuda")
    return toks, {"frontend_embeds": torch.randn(
        (b, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
        device="cuda")}, VISION_MAX_SEQ


def frontend_serve(torch, fg, cfg, params, mesh=None) -> dict:
    """One 5m (d) front-end run: :func:`greedy_run` of the streams (under
    ``mesh``, this data rank's) for MESH_FRONT_NEW steps, launches exactly
    :func:`frontend_per_call`'s.  Returns every logits row (streams, calls,
    vocab) on the host, the streams' range, the tokens, the launches, the
    host-clock timings and the memory's shape."""
    from repro_torch.dist import sharding as S
    toks, extra, max_seq = frontend_inputs(torch, cfg)
    b = toks.shape[0]
    lo, hi = 0, b
    if mesh is not None:
        d, n = S.axes_index(mesh, S.data_axes(mesh))
        lo, hi = d * b // n, (d + 1) * b // n
    run = greedy_run(torch, fg, cfg, params, toks[lo:hi],
                     {k: v[lo:hi] for k, v in extra.items()},
                     MESH_FRONT_NEW, max_seq, f"5m (d) {cfg.name}"
                     + (" on the mesh" if mesh is not None else ""),
                     *frontend_per_call(cfg), mesh=mesh)
    mem = run["mem"]
    return {"logits": torch.stack([run["prefill_logits"]] + run["steps"],
                                  1).cpu(),
            "rows": [lo, hi], "tokens": run["tokens"].tolist(),
            "launches": run["launches"], "prefill_ms": run["prefill_ms"],
            "decode_step_ms": run["decode_step_ms"],
            "memory_shape": (list(mem["pos0"][0].shape) if mem is not None
                             else None)}


def frontend_references(torch, fg) -> dict:
    """Phase 5m (a) (d): each MESH_FRONTENDS model at its cut depth on
    records from the leaf-wise init, served unsharded
    (:func:`frontend_serve`): (b)'s reference."""
    out = {}
    for what, arch, periods, encoder in MESH_FRONTENDS:
        cfg = frontend_cut(arch, periods, encoder)
        qparams, init = leafwise_init(torch, cfg)
        out[what] = {"init": init, **frontend_serve(torch, fg, cfg, qparams)}
        log(f"  (a) {arch} at {periods}"
            + (f" + {encoder}" if encoder else "") + " periods, unsharded: "
            f"tokens {out[what]['tokens']}; prefill "
            f"{out[what]['prefill_ms']:.1f} ms, a decode step "
            f"{out[what]['decode_step_ms']:.1f} ms (host clock)")
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_frontend(torch, fg, mesh, what: str, cfg, rows_path: str) -> dict:
    """One 5m (d) front end on this rank: its blocks of the records drawn
    leaf by leaf (:func:`drawn_blocks`; the resident bytes those the
    abstract specs place), then :func:`frontend_serve` on its data rank's
    stream under ``mesh``; the logits rows written to ``rows_path``."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import steps
    from repro_torch.models import lm
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qparams = drawn_blocks(torch, mesh, cfg)
    planned = steps.local_bytes(steps.abstract_params(cfg, mesh,
                                                      prequant=True), mesh)
    resident = S.resident_bytes(qparams)
    if resident != planned:
        fail(f"5m (d) {cfg.name} rank {torch.distributed.get_rank()}: its "
             f"drawn blocks hold {resident} bytes, the specs place "
             f"{planned}")
    load_s = time.monotonic() - t0
    run = frontend_serve(torch, fg, cfg, qparams, mesh)
    torch.save(run.pop("logits"), rows_path)
    out = dict(run, load_s=load_s, resident_bytes=resident,
               whole_bytes=S.resident_bytes(lm.init_params(
                   torch.Generator(), cfg, device="meta",
                   prequant=cfg.quant)),
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               seconds=time.monotonic() - t0)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gloo_p2p_probe(rank: int, port: int) -> int:
    """``--gloo-p2p-probe``: one of two gloo ranks on cuda:0 sending a CUDA
    tensor to the other with ``batch_isend_irecv``; exits 0 where gloo
    moves it.  Run by phase 5m in processes of its own: gloo aborts the
    process on a CUDA tensor it cannot send."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    t = torch.full((4,), float(rank + 1), device="cuda")
    got = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, 1 - rank),
           dist.P2POp(dist.irecv, got, 1 - rank)]
    try:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
    except RuntimeError as exc:     # a probe: the error is the answer
        print(f"{type(exc).__name__}: {str(exc).splitlines()[0][:300]}",
              flush=True)
        return 1
    return 0 if float(got[0]) == float(2 - rank) else 1


def gloo_cuda_ops(torch, world: int) -> dict:
    """Which gloo collectives run on CUDA tensors, each tried once on
    every rank: "ok" (values right), or the error it raised."""
    import torch.distributed as dist
    rank = dist.get_rank()
    t = torch.full((4,), float(rank + 1), device="cuda")
    want_sum = float(sum(range(1, world + 1)))

    def gather():
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return [float(p[0]) for p in parts] == [float(r + 1)
                                                 for r in range(world)]

    def gather_into(dtype):
        def run():
            o = torch.empty(world * 4, dtype=dtype, device="cuda")
            dist.all_gather_into_tensor(o, t.to(dtype))
            return float(o[4 * (world - 1)]) == float(world)
        return run

    def reduce(dtype, op, want):
        def run():
            x = t.to(dtype).clone()
            dist.all_reduce(x, op=op)
            return float(x[0]) == want
        return run

    def reduce_scatter():
        x = torch.arange(4 * world, dtype=torch.float32, device="cuda") + rank
        o = torch.empty(4, device="cuda")
        dist.reduce_scatter_tensor(o, x)
        want = world * torch.arange(4 * world, dtype=torch.float32) \
            + world * (world - 1) / 2
        return torch.equal(o.cpu(), want[4 * rank:4 * rank + 4])

    def bcast():
        x = t.clone()
        dist.broadcast(x, src=0)
        return float(x[0]) == 1.0

    probes = {"all_gather": gather,
              "all_gather_into_tensor": gather_into(torch.float32),
              # the records' int8 codes; int16 codes travel as uint8
              "all_gather_into_tensor_i8": gather_into(torch.int8),
              "all_gather_into_tensor_u8": gather_into(torch.uint8),
              # the bf16 compute copy's weight gathers in training
              "all_gather_into_tensor_bf16": gather_into(torch.bfloat16),
              "all_reduce_sum_f32": reduce(torch.float32,
                                           dist.ReduceOp.SUM, want_sum),
              "all_reduce_sum_i32": reduce(torch.int32, dist.ReduceOp.SUM,
                                           want_sum),
              "all_reduce_sum_i64": reduce(torch.int64, dist.ReduceOp.SUM,
                                           want_sum),
              "all_reduce_max_f64": reduce(torch.float64,
                                           dist.ReduceOp.MAX, float(world)),
              "all_reduce_sum_bf16": reduce(torch.bfloat16,
                                            dist.ReduceOp.SUM, want_sum),
              "broadcast": bcast,
              # the gradients' reduce-scatter over the data axes
              "reduce_scatter_tensor": reduce_scatter}
    out = {}
    for name, fn in probes.items():
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong values"
        except RuntimeError as exc:       # a probe: the error is the answer
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        dist.barrier()
    return out


def held_blocks(torch, whole, sharded, mesh) -> int:
    """Every leaf of ``sharded`` (an engine's parameters) is this rank's
    ``leaf_spec`` block of ``whole``, bit for bit, and nothing more.
    Returns the bytes the blocks hold."""
    from repro_torch.dist import sharding as S
    total = 0
    for path, leaf in _paths(whole):
        node = sharded
        for k in path:
            node = node[k]
        spec = S.leaf_spec(path, leaf, mesh)
        local = node.to_local() if S.is_dtensor(node) else node
        if local.device.type != "cuda":
            fail(f"5m (b): {'/'.join(path)} lies on {local.device}")
        local = local.cpu()
        want = S.local_block(leaf, spec, mesh)
        if S.is_dtensor(node) != S.is_sharded(spec) or \
                local.shape != want.shape or not torch.equal(local, want):
            fail(f"5m (b) rank {torch.distributed.get_rank()}: "
                 f"{'/'.join(path)} holds {tuple(local.shape)}, not its "
                 f"leaf_spec {spec} block {tuple(want.shape)}")
        total += local.numel() * local.element_size()
    return total


def mesh_kernel_checks(torch, mesh) -> dict:
    """Phase 5m (b)'s kernel level on one rank: every rank holds the same
    global operands (generators seeded alike); the sharded call must equal
    the unsharded one on this rank, each launching once here."""
    from repro_torch.core.context import ExecContext
    from repro_torch.core.dispatch import ExecPlan, GemmShardSpec
    from repro_torch.dist import collectives as C
    from repro_torch.dist import shard_gemm as sg
    from repro_torch.kernels import launch_counts, ops
    from repro_torch.quant.prequant import record
    from repro_torch.quant.qmatmul import prequant_matmul
    from repro_torch.quant.quantize import quantize_symmetric
    rank = torch.distributed.get_rank()
    ctx = ExecContext(mesh=mesh)
    pcfg = path_config(MESH_ARCH, "mixed")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    out = {}

    def launched(fn):
        """``fn()`` run once to warm up (a group's first collective sets
        up its connections), then once counted and timed."""
        fn()
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        y = fn()
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        after = launch_counts()
        return y, ms, {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}

    for name, k, n, w, mode in MESH_DENSE:
        n = n or pcfg.padded_vocab
        x = torch.randn((MESH_ROWS, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        rec = record(torch.randn((k, n), generator=gen, device="cuda") *
                     k ** -0.5, w)
        want, plain_ms, _ = launched(lambda: prequant_matmul(x, rec, w))
        got, ms, counts = launched(
            lambda: prequant_matmul(x, rec, w, context=ctx))
        if not torch.equal(got, want) or counts != {f"dense_{mode}": 1}:
            fail(f"5m (b) rank {rank}: sharded {name} ({k}x{n}, w={w}) "
                 f"differs from unsharded or launched {counts}")
        out[name] = {"K": k, "N": n, "w": w, "equal": True,
                     "launches": counts, "host_ms": ms,
                     "unsharded_host_ms": plain_ms}
        del rec
    # K-sharded staged mm1 at wi: int32 partials all-reduced over model
    k, n = MESH_DENSE[0][1:3]
    a = rand_bits(torch, gen, 8, (MESH_ROWS, k))
    b = rand_bits(torch, gen, 8, (k, n))
    plan = ExecPlan("mm1", 8, block_k=256, combine_int32=True, depth=0,
                    shard=GemmShardSpec(m_axes=("data",),
                                        k_axes=("model",)))
    got, ms, counts = launched(
        lambda: sg.sharded_run_plan(a, b, plan=plan, mesh=mesh))
    oracle = (a.cpu().to(torch.int64) @ b.cpu().to(torch.int64))
    if not torch.equal(got.cpu().to(torch.int64), oracle) or \
            counts != {"mm1_gemm": 1}:
        fail(f"5m (b) rank {rank}: the K-sharded staged mm1 differs from "
             f"the int64 oracle or launched {counts}")
    out["k_sharded_mm1"] = {"K": k, "N": n, "equal": True,
                            "launches": counts, "host_ms": ms}
    # granite's experts, ragged, the expert dim over model
    e, k, n, cap, segs = MESH_GROUPED
    x = torch.randn((e, cap, k), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rec = record(torch.randn((e, k, n), generator=gen, device="cuda") *
                 k ** -0.5, 8)
    counts_e = torch.randint(0, cap // segs + 1, (e, segs), generator=gen,
                             device="cuda", dtype=torch.int32)
    kw = dict(batched=True, counts=counts_e, seg=cap // segs)
    want, plain_ms, _ = launched(lambda: prequant_matmul(x, rec, 8, **kw))
    got, ms, counts = launched(
        lambda: prequant_matmul(x, rec, 8, context=ctx, **kw))
    if not torch.equal(got, want) or counts != {"grouped_mm1": 1}:
        fail(f"5m (b) rank {rank}: sharded grouped experts differ from "
             f"unsharded or launched {counts}")
    out["grouped_experts"] = {"E": e, "K": k, "N": n, "equal": True,
                              "launches": counts, "host_ms": ms,
                              "unsharded_host_ms": plain_ms}
    # the ring all-gather matmul at w=8, its hops through the host
    group = mesh.get_group("model")
    me, size = C.rank_of(group), C.group_size(group)
    k, n = MESH_DENSE[0][1:3]
    xs = torch.randn((size * MESH_ROWS, k), generator=gen, device="cuda")
    wr = torch.randn((k, n), generator=gen, device="cuda")
    got, ms, counts = launched(lambda: C.ring_ag_matmul(
        xs[me * MESH_ROWS:(me + 1) * MESH_ROWS], wr, group, w_bits=8,
        context=ctx))
    qb, sb = quantize_symmetric(wr, 8)
    want = []
    for i in range(size):       # each chunk's product, as the ring forms it
        qa, sa = quantize_symmetric(xs[i * MESH_ROWS:(i + 1) * MESH_ROWS], 8)
        want.append(ops.int_gemm(qa, qb, w=8) * sa * sb)
    want = torch.cat(want)
    if not torch.equal(got, want):
        fail(f"5m (b) rank {rank}: ring_ag_matmul at w=8 differs from the "
             f"unsharded chunk products")
    out["ring_ag_matmul_w8"] = {"rows": size * MESH_ROWS, "K": k, "N": n,
                                "equal": True, "launches": counts,
                                "host_ms": ms}
    return out


def mesh_rank(rank: int, world: int, port: int, out_dir: str) -> int:
    """``--mesh-rank``: one rank of phase 5m (b), on cuda:0 over gloo.
    Writes ``mesh_rank{rank}.json`` (and its logits rows) to ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import sharding as S
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_gemm as fg
    from repro_torch.launch.mesh import make_mesh, mesh_backend

    torch.cuda.set_device(0)
    missing = [n for n in build.SOURCES if not build.library_path(n).exists()]
    if missing:
        fail(f"5m (b) rank {rank}: the libraries {missing} are not built; "
             f"the parent builds them before it starts the ranks")
    t_start = time.monotonic()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = {"rank": rank, "gloo_cuda_ops": gloo_cuda_ops(torch, world)}
    mesh = make_mesh(MESH_SHAPE, device="cuda")
    if mesh_backend(mesh) != "gloo":
        fail(f"5m (b): the mesh runs {mesh_backend(mesh)!r}, not gloo")
    out["coord"] = S.coordinate(mesh)
    t0 = time.monotonic()
    out["kernels"] = mesh_kernel_checks(torch, mesh)
    out["kernel_s"] = time.monotonic() - t0
    out.update(rank_engine(torch, np, fg, mesh,
                           *cut_config(MESH_ARCH, MESH_PERIODS),
                           MESH_PARAMS,
                           os.path.join(out_dir, f"mesh_rows{rank}.pt")))
    out["moe"] = rank_engine(
        torch, np, fg, mesh, *cut_config(MESH_MOE_ARCH, MESH_MOE_PERIODS),
        MESH_MOE_PARAMS,
        os.path.join(out_dir, f"mesh_moe_rows{rank}.pt"))
    for what, arch, periods in MESH_RECURRENT:
        t0 = time.monotonic()
        # the last of them (jamba) draws the largest whole leaves: once its
        # load is done, what this rank holds on the card is small
        out[what] = rank_engine(
            torch, np, fg, mesh, *cut_config(arch, periods), None,
            os.path.join(out_dir, f"mesh_{what}_rows{rank}.pt"),
            MESH_RECURRENT_PROMPTS, loaded=light_mark(out_dir, rank) if (
                what == MESH_RECURRENT[-1][0]) else None)
        out[what]["seconds"] = time.monotonic() - t0
    for what, arch, periods in MESH_PREFIX:
        t0 = time.monotonic()
        out[what] = rank_engine(
            torch, np, fg, mesh, *cut_config(arch, periods), None,
            str(MESH_ROWS_DIR / f"mesh_{what}_rows{rank}.pt"),
            requests=prefix_requests, **PREFIX_ENGINE)
        out[what]["seconds"] = time.monotonic() - t0
    for what, arch, periods, encoder in MESH_FRONTENDS:
        out[what] = rank_frontend(
            torch, fg, mesh, what, frontend_cut(arch, periods, encoder),
            str(MESH_ROWS_DIR / f"mesh_{what}_rows{rank}.pt"))
    out["seconds"] = time.monotonic() - t_start
    with open(os.path.join(out_dir, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(out, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def drawn_blocks(torch, mesh, cfg):
    """This rank's blocks of ``cfg``'s mixed records, drawn leaf by leaf
    from a generator seeded 0 as :func:`leafwise_init` draws the whole
    (``lm.init_params(mesh=...)``: a leaf is whole only while it is drawn),
    the ranks in turn, so that one rank's whole leaf is on the card at a
    time beside the others' blocks."""
    from repro_torch.models import lm
    dist = torch.distributed
    params = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params = lm.init_params(gen, cfg, device="cuda",
                                    prequant=cfg.quant, mesh=mesh)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def rank_engine(torch, np, fg, mesh, pcfg, per_call,
                records: Optional[Path], rows_path: str,
                prompts=DENSE_PROMPTS, requests=None,
                loaded: Optional[Path] = None, **engine_kw) -> dict:
    """One 5m (b) engine on this rank: once the parent has written them,
    the records mapped from the host file, each rank's blocks alone copied
    to the card (held to its ``leaf_spec`` blocks of the whole); or, with
    no ``records``, the rank's blocks drawn on the card
    (:func:`drawn_blocks`; resident bytes those the abstract specs place,
    every block on the card); then the requests served eagerly (gloo),
    counted: exact launches a model call, every grouped launch's experts
    and every recurrent launch's heads or channels reported.  ``requests``
    and ``engine_kw`` as :func:`world_of_one_pair` takes them (with the
    prefix cache, each data rank's prefix stats reported).  Writes the
    logits rows of the requests this data rank's slots served to
    ``rows_path``; touches ``loaded`` once the load's memory (a drawn
    whole leaf beside the blocks) is given back to the card."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    rank = torch.distributed.get_rank()
    if records is not None:
        parent = os.getppid()
        deadline = time.monotonic() + MESH_TIMEOUT
        while not ready_file(records).exists():
            if os.getppid() != parent or time.monotonic() > deadline:
                fail(f"5m (b) rank {rank}: no {pcfg.name} records from the "
                     f"parent")
            time.sleep(0.2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    if records is None:
        qparams = drawn_blocks(torch, mesh, pcfg)
        whole = S.resident_bytes(lm.init_params(
            torch.Generator(), pcfg, device="meta", prequant=pcfg.quant))
        planned = steps.local_bytes(steps.abstract_params(
            pcfg, mesh, prequant=True), mesh)
        off = [p for p, t in _paths(qparams)
               if S.local(t).device.type != "cuda"]
        if S.resident_bytes(qparams) != planned or off:
            fail(f"5m (b) rank {rank}: {pcfg.name}'s drawn blocks hold "
                 f"{S.resident_bytes(qparams)} bytes (the specs place "
                 f"{planned}), {off[:4]} off the card")
    else:
        flat = torch.load(records, mmap=True, weights_only=True)
        qparams = {}
        for key, leaf in flat.items():      # the whole records, on the host
            node = qparams
            *parents, last = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = leaf
        whole = S.resident_bytes(qparams)
        del flat
    eng = Engine(pcfg, qparams, max_seq=256, batch_size=4, device="cuda",
                 mesh=mesh, **engine_kw)
    torch.cuda.synchronize()
    out = {"load_s": time.monotonic() - t0,
           "load_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "whole_bytes": whole,
           "resident_bytes": S.resident_bytes(eng.params),
           "drawn": records is None}
    if records is not None and held_blocks(
            torch, qparams, eng.params, mesh) != out["resident_bytes"]:
        fail(f"5m (b) rank {rank}: resident bytes are not its blocks'")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    if loaded is not None:
        loaded.touch()
    if eng.executor.graphs:
        fail("5m (b): decode is graphed under a gloo mesh")
    reqs = (requests(np, pcfg) if requests is not None
            else mesh_requests(np, pcfg, prompts))
    with sampled_rows({}) as rows, grouped_experts(fg) as experts, \
            recurrent_widths() as widths, admitted_slots() as slot_of:
        run = serve_counted(torch, fg, eng, reqs, graphs=False)
    out["launches"] = check_counted(f"5m (b) {pcfg.name} rank {rank}", eng,
                                    run, per_call)
    st = run["stats"]
    out.update({"tokens": run["tokens"], "prefill_calls": run["prefills"],
                "decode_steps": st.decode_steps, "decode_s": st.decode_s,
                "prefill_s": st.prefill_s, "wall_s": run["wall"],
                "step_ms": 1e3 * st.decode_s / max(st.decode_steps, 1),
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "grouped_experts": sorted(set(experts)),
                "widths": widths_of(widths)})
    if eng.prefix is not None:
        out["prefix"] = eng.prefix.stats_by_rank()
    # the rows of the requests this data rank's slots served
    d, per = eng.pool.data_rank, eng.pool.slots_per_rank
    mine = {f"{rid}/{step}": v.cpu() for (rid, step), v in rows.items()
            if slot_of[rid] // per == d and step < len(run["tokens"][rid])}
    out["slot_of"] = slot_of
    torch.save(mine, rows_path)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def full_per_call(arch: str) -> dict:
    """``arch``'s launches a model call under mixed at full depth (its
    mixed path of PATHS, else of DENSE_PATHS)."""
    path = next((p[5:] for p in PATHS if p[:2] == (arch, "mixed")), None)
    if path is None:
        path = next((p[1], p[3]) for p in DENSE_PATHS if p[0] == arch)
    return path_per_call(arch, *path)


def cut_config(arch: str, periods: int):
    """``arch`` under mixed at ``periods`` of its periods, and its launches
    a model call: each period's as at full depth, the w=12 head and ln_f
    once."""
    full = path_config(arch, "mixed")
    cfg = dataclasses.replace(full, n_periods=periods)
    once = {"dense_kmm2": 1, "rowinv_norm": 1}         # the head, ln_f
    return cfg, {k: (n - once.get(k, 0)) // full.n_periods * periods
                 + once.get(k, 0) if n else 0
                 for k, n in full_per_call(arch).items()}


def mesh_cut_reference(torch, np, fg, cfg, per_call, records: Optional[Path],
                       prompts=DENSE_PROMPTS) -> dict:
    """A 5m (b) engine's reference: the unsharded engine of ``cfg`` (cut in
    depth) on mixed records from the leaf-wise init, warmed and graphed,
    exact launches; its tokens and sampled rows; its records saved for the
    ranks (``records``, where given: else the ranks draw their own)."""
    from repro_torch.serve.engine import Engine
    qparams, init = leafwise_init(torch, cfg)
    eng = Engine(cfg, qparams, max_seq=256, batch_size=4, device="cuda")
    eng.warm()
    with sampled_rows({}) as rows:
        run = serve_counted(torch, fg, eng, mesh_requests(np, cfg, prompts))
    launches = check_counted(f"5m (b) {cfg.name} at {cfg.n_periods} "
                             f"periods, no mesh", eng, run, per_call)
    if records is not None:
        save_records(torch, qparams, records)
    del eng, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"init": init, "launches": launches, "tokens": run["tokens"],
            "rows": {f"{k[0]}/{k[1]}": v.cpu() for k, v in rows.items()}}


def ready_file(records: Path) -> Path:
    """The file the parent writes once ``records`` is whole on disk."""
    return records.with_suffix(".ready")


def light_mark(out_dir, rank: int) -> Path:
    """The file a 5m rank touches once its last large load is done."""
    return Path(out_dir) / f"mesh_light{rank}"


def mesh_phase(torch, np, fg, beside=None) -> dict:
    """Phase 5m: the gloo point-to-point probe and (b)'s ranks started as
    child processes first (the ranks run their collective and kernel checks
    and then wait for each model's records, MESH_PARAMS and
    MESH_MOE_PARAMS, which (a) writes), (a) in this process meanwhile, then
    ``beside()`` (5d) while the ranks serve on, once every rank has loaded
    its last large model (:func:`light_mark`: the card's memory would not
    hold both before); every process stopped before it returns."""
    import shutil
    out_dir = ROOT / "chiprun_out" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(MESH_ROWS_DIR, ignore_errors=True)
    MESH_ROWS_DIR.mkdir(parents=True)
    for path in (MESH_PARAMS, MESH_MOE_PARAMS):
        path.unlink(missing_ok=True)
        ready_file(path).unlink(missing_ok=True)
    for r in range(MESH_RANKS):
        light_mark(out_dir, r).unlink(missing_ok=True)
    script = str(ROOT / "chip_smoke.py")

    def start(args):
        return subprocess.Popen([sys.executable, script, *args],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(procs, timeout):
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [p.returncode for p in procs], logs

    t_ranks = time.monotonic()
    port = free_port()
    probes = [start(["--gloo-p2p-probe", str(r), str(port)]) for r in (0, 1)]
    port = free_port()
    procs = [start(["--mesh-rank", str(r), str(MESH_RANKS), str(port),
                    str(out_dir)]) for r in range(MESH_RANKS)]
    try:
        t0 = time.monotonic()
        out = {"world_of_one": mesh_world_of_one(torch, np, fg)}
        out["world_of_one_s"] = time.monotonic() - t0
    except BaseException:           # (a) failed: stop the children first
        finish(probes + procs, 0)
        raise
    base_rows = out["world_of_one"]["cut"].pop("rows")
    base_tokens = out["world_of_one"]["cut"]["tokens"]
    moe_rows = out["world_of_one"]["moe_cut"].pop("rows")
    moe_tokens = out["world_of_one"]["moe_cut"]["tokens"]
    recurrent_refs = {what: out["world_of_one"][f"{what}_cut"].pop("rows")
                      for what, _, _ in MESH_RECURRENT}
    prefix_refs = {what: out["world_of_one"][what].pop("rows")
                   for what, _, _ in MESH_PREFIX}
    frontend_refs = {what: out["world_of_one"]["frontends"][what].pop(
        "logits") for what, _, _, _ in MESH_FRONTENDS}
    codes, logs = finish(probes, 60)
    out["gloo_p2p_cuda"] = {"exit_codes": codes, "last_line": [
        (log_.strip().splitlines() or [""])[-1][:200] for log_ in logs]}
    log(f"  gloo batch_isend_irecv on CUDA tensors: exit codes {codes}")
    if beside is not None:
        deadline = time.monotonic() + MESH_TIMEOUT
        while not all(light_mark(out_dir, r).exists()
                      for r in range(MESH_RANKS)):
            if any(p.poll() is not None for p in procs):
                break               # a rank ended early: its code fails below
            if time.monotonic() > deadline:
                finish(procs, 0)
                fail("5m (b): the ranks did not load their last model in "
                     f"{MESH_TIMEOUT} s")
            time.sleep(0.2)
        else:
            try:
                beside()
            except BaseException:   # it failed: stop the ranks first
                finish(procs, 0)
                raise
    t0 = time.monotonic()
    codes, logs = finish(procs, MESH_TIMEOUT)
    out["ranks_s"] = time.monotonic() - t0
    out["ranks_started_s"] = time.monotonic() - t_ranks
    for path in (MESH_PARAMS, MESH_MOE_PARAMS):
        path.unlink()
        ready_file(path).unlink()
    for r in range(MESH_RANKS):
        light_mark(out_dir, r).unlink(missing_ok=True)
    for r, (code, text) in enumerate(zip(codes, logs)):
        if code != 0:
            print(text[-6000:], file=sys.stderr)
            fail(f"5m (b): rank {r} exited with {code}")
    ranks = [json.loads((out_dir / f"mesh_rank{r}.json").read_text())
             for r in range(MESH_RANKS)]
    ops = ranks[0]["gloo_cuda_ops"]
    from repro_torch.dist.collectives import GLOO_CUDA_OPS
    used = {"all_gather_into_tensor": ("all_gather_into_tensor",
                                       "all_gather_into_tensor_i8",
                                       "all_gather_into_tensor_u8",
                                       "all_gather_into_tensor_bf16"),
            "all_reduce": ("all_reduce_sum_f32",), "broadcast": ("broadcast",),
            "reduce_scatter_tensor": ("reduce_scatter_tensor",)}
    if any(ops[p] != "ok" for op in GLOO_CUDA_OPS for p in used[op]) or any(
            r["gloo_cuda_ops"] != ops for r in ranks):
        fail(f"5m (b): gloo does not run {sorted(GLOO_CUDA_OPS)} on CUDA "
             f"tensors on every rank: {[r['gloo_cuda_ops'] for r in ranks]}")
    diffs = []
    for r, rank in enumerate(ranks):
        if [list(t) for t in rank["tokens"]] != \
                [list(t) for t in base_tokens]:
            fail(f"5m (b) rank {r}: tokens {rank['tokens']} differ from the "
                 f"unsharded engine's {base_tokens}")
        rows = torch.load(out_dir / f"mesh_rows{r}.pt")
        for key, row in rows.items():
            diffs.append(float((row.float() - base_rows[key].float())
                               .abs().max()))
    out["ranks"] = ranks
    out["logits_rows_compared"] = len(diffs)
    out["logits_max_abs_diff"] = max(diffs) if diffs else None
    out["logits_rows_equal"] = sum(d == 0.0 for d in diffs)
    for rank in ranks:
        log(f"  (b) rank {rank['rank']} {rank['coord']}: resident "
            f"{rank['resident_bytes'] / 1e9:.3f} GB of "
            f"{rank['whole_bytes'] / 1e9:.3f} GB, device peak "
            f"{rank['load_peak_gb']:.3f} GB at load and "
            f"{rank['peak_gb']:.3f} GB serving; launches "
            f"{rank['launches']['host']} over {rank['prefill_calls']} "
            f"prefill calls and {rank['decode_steps']} decode steps; step "
            f"{rank['step_ms']:.1f} ms (host clock, gloo on one card)")
    log(f"  (b) gloo on CUDA tensors: {ops}; {MESH_ARCH} at {MESH_PERIODS} "
        f"periods: tokens torch.equal to the unsharded engine on every "
        f"rank; logits rows equal "
        f"{out['logits_rows_equal']} of {len(diffs)}, max |diff| "
        f"{out['logits_max_abs_diff']}")
    # granite, expert-parallel: its experts over the model axis
    experts = path_config(MESH_MOE_ARCH, "mixed").n_experts // MESH_SHAPE[1]
    diffs = []
    for r, rank in enumerate(ranks):
        moe = rank["moe"]
        if [list(t) for t in moe["tokens"]] != \
                [list(t) for t in moe_tokens]:
            fail(f"5m (b) {MESH_MOE_ARCH} rank {r}: tokens {moe['tokens']} "
                 f"differ from the unsharded engine's {moe_tokens}")
        if moe["grouped_experts"] != [experts]:
            fail(f"5m (b) {MESH_MOE_ARCH} rank {r}: grouped launches over "
                 f"{moe['grouped_experts']} experts, not {experts}")
        rows = torch.load(out_dir / f"mesh_moe_rows{r}.pt")
        for key, row in rows.items():
            diffs.append(float((row.float() - moe_rows[key].float())
                               .abs().max()))
    moe = out["moe"] = {
        "logits_rows_compared": len(diffs),
        "logits_max_abs_diff": max(diffs) if diffs else None,
        "logits_rows_equal": sum(d == 0.0 for d in diffs),
        "peak_gb": max(r["moe"]["peak_gb"] for r in ranks),
        "step_ms": [r["moe"]["step_ms"] for r in ranks],
        "resident_bytes": [r["moe"]["resident_bytes"] for r in ranks],
        "whole_bytes": ranks[0]["moe"]["whole_bytes"]}
    for rank in ranks:
        m = rank["moe"]
        log(f"  (b) {MESH_MOE_ARCH} rank "
            f"{rank['rank']} {rank['coord']}: resident "
            f"{m['resident_bytes'] / 1e9:.3f} GB of "
            f"{m['whole_bytes'] / 1e9:.3f} GB, device peak "
            f"{m['load_peak_gb']:.3f} GB at load and {m['peak_gb']:.3f} GB "
            f"serving; launches {m['launches']['host']} over "
            f"{m['prefill_calls']} prefill calls and {m['decode_steps']} "
            f"decode steps, every grouped launch over {experts} experts; "
            f"step {m['step_ms']:.1f} ms (host clock, gloo on one card)")
    log(f"  (b) {MESH_MOE_ARCH} at {MESH_MOE_PERIODS} periods: tokens "
        f"torch.equal to the unsharded engine on every rank; logits rows "
        f"equal "
        f"{moe['logits_rows_equal']} of {len(diffs)}, max |diff| "
        f"{moe['logits_max_abs_diff']}; ranks' peak {moe['peak_gb']:.3f} GB")
    for what, arch, periods in MESH_RECURRENT:
        out[what] = check_recurrent_ranks(
            torch, what, arch, periods, ranks, out_dir, recurrent_refs[what],
            out["world_of_one"][f"{what}_cut"]["tokens"])
    for what, arch, periods in MESH_PREFIX:
        out[what] = check_prefix_ranks(
            torch, what, arch, periods, ranks, MESH_ROWS_DIR,
            prefix_refs[what], out["world_of_one"][what]["no mesh"])
    for what, arch, _, _ in MESH_FRONTENDS:
        out[what] = check_frontend_ranks(
            torch, what, arch, ranks, MESH_ROWS_DIR, frontend_refs[what],
            out["world_of_one"]["frontends"][what])
    shutil.rmtree(MESH_ROWS_DIR)
    return out


def check_prefix_ranks(torch, what: str, arch: str, periods: int, ranks,
                       out_dir: Path, ref_rows: dict, ref: dict) -> dict:
    """5m (b) (d)'s gates on one prefix-cache model: every rank's tokens
    those of (a)'s unsharded engine with the prefix cache, every row of a
    request on the ranks of the data rank whose slot served it torch.equal
    to its row there (each on MESH_SHAPE[1] ranks); every rank keeps the
    same prefix stats of every data rank, each data rank hit at least
    once, and their hits and misses add up to the unsharded engine's."""
    by_rank = ranks[0][what]["prefix"]
    for r, rank in enumerate(ranks):
        if rank[what]["prefix"] != by_rank:
            fail(f"5m (d) {arch} rank {r}: prefix stats "
                 f"{rank[what]['prefix']}, rank 0's {by_rank}")
    n_rows = rows_equal_on_ranks(torch, f"5m (d) {arch}", what, ranks,
                                 out_dir, ref_rows, ref["tokens"])
    want = MESH_SHAPE[1] * sum(len(t) for t in ref["tokens"])
    if n_rows != want:
        fail(f"5m (d) {arch}: {n_rows} logits rows compared, {want} "
             f"expected")
    total = {k: sum(s[k] for s in by_rank) for k in ("hits", "misses")}
    if any(s["hits"] < 1 for s in by_rank) or total != {
            k: ref["prefix"][k] for k in total}:
        fail(f"5m (d) {arch}: prefix stats by data rank {by_rank}, the "
             f"unsharded engine's {ref['prefix']}")
    res = {"logits_rows_equal": n_rows, "prefix_by_data_rank": by_rank,
           "unsharded_prefix": ref["prefix"],
           "step_ms": [r[what]["step_ms"] for r in ranks],
           "seconds": [r[what]["seconds"] for r in ranks],
           "prefill_calls": ranks[0][what]["prefill_calls"],
           "decode_steps": ranks[0][what]["decode_steps"],
           "resident_bytes": [r[what]["resident_bytes"] for r in ranks],
           "whole_bytes": ranks[0][what]["whole_bytes"],
           "peak_gb": max(r[what]["peak_gb"] for r in ranks)}
    log(f"  (d) {arch} at {periods} periods, chunks of {PREFIX_CHUNK}, the "
        f"prefix cache on: tokens and {n_rows} logits rows torch.equal to "
        f"the unsharded engine on every rank; hits by data rank "
        f"{[s['hits'] for s in by_rank]} (unsharded {ref['prefix']}); "
        f"{res['prefill_calls']} prefill calls and {res['decode_steps']} "
        f"decode steps a rank; step "
        + ", ".join(f"{v:.0f}" for v in res["step_ms"])
        + " ms (host clock, gloo on one card); "
        + ", ".join(f"{v:.1f}" for v in res["seconds"]) + " s")
    return res


def check_frontend_ranks(torch, what: str, arch: str, ranks, out_dir: Path,
                         ref_logits, ref: dict) -> dict:
    """5m (b) (d)'s gates on one front end: every rank's tokens and logits
    rows (its data rank's streams, the prefill's and every step's)
    torch.equal to the unsharded calls' (a); an encoder-decoder's memory
    its data rank's streams."""
    d = MESH_SHAPE[0]
    for r, rank in enumerate(ranks):
        res = rank[what]
        lo, hi = res["rows"]
        if hi - lo != MESH_FRONT_STREAMS // d or \
                res["tokens"] != ref["tokens"][lo:hi]:
            fail(f"5m (d) {arch} rank {r}: streams {lo}:{hi}, tokens "
                 f"{res['tokens']}, the unsharded calls' {ref['tokens']}")
        got = torch.load(out_dir / f"mesh_{what}_rows{r}.pt")
        want = ref_logits[lo:hi]
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs().amax((0, 2))
            fail(f"5m (d) {arch} rank {r}: logits rows differ from the "
                 f"unsharded calls' by {diff.tolist()} (the prefill's, "
                 f"then each step's)")
        if ref["memory_shape"] is not None and res["memory_shape"] != [
                ref["memory_shape"][0], hi - lo] + ref["memory_shape"][2:]:
            fail(f"5m (d) {arch} rank {r}: memory {res['memory_shape']}")
    out = {"logits_rows_equal": sum(r[what]["rows"][1] - r[what]["rows"][0]
                                    for r in ranks) * (MESH_FRONT_NEW + 1),
           "resident_bytes": [r[what]["resident_bytes"] for r in ranks],
           "whole_bytes": ranks[0][what]["whole_bytes"],
           "prefill_ms": [r[what]["prefill_ms"] for r in ranks],
           "decode_step_ms": [r[what]["decode_step_ms"] for r in ranks],
           "peak_gb": max(r[what]["peak_gb"] for r in ranks),
           "seconds": [r[what]["seconds"] for r in ranks],
           "launches": ranks[0][what]["launches"],
           "unsharded": ref}
    log(f"  (d) {arch}: tokens and {out['logits_rows_equal']} logits rows "
        f"(the prefill's and {MESH_FRONT_NEW} steps', each data rank's "
        f"stream) torch.equal to the unsharded calls on every rank; "
        f"resident "
        + ", ".join(f"{b / 1e9:.3f}" for b in out["resident_bytes"])
        + f" GB of {out['whole_bytes'] / 1e9:.3f} GB; prefill "
        + ", ".join(f"{v:.0f}" for v in out["prefill_ms"])
        + " ms, a decode step "
        + ", ".join(f"{v:.0f}" for v in out["decode_step_ms"])
        + " ms (host clock, gloo on one card); launches "
        f"{out['launches']['host']} a rank (exact)")
    return out


def rows_equal_on_ranks(torch, label: str, what: str, ranks, rows_dir: Path,
                        ref_rows: dict, ref_tokens) -> int:
    """Every rank's tokens of ``what`` those of ``ref_tokens``, and every
    logits row it wrote (``rows_dir``) torch.equal to its row in
    ``ref_rows``; the rows compared."""
    n_rows = 0
    for r, rank in enumerate(ranks):
        res = rank[what]
        if [list(t) for t in res["tokens"]] != [list(t) for t in ref_tokens]:
            fail(f"{label} rank {r}: tokens {res['tokens']} differ from the "
                 f"unsharded engine's {ref_tokens}")
        rows = torch.load(rows_dir / f"mesh_{what}_rows{r}.pt")
        for key, row in rows.items():
            if not torch.equal(row, ref_rows[key]):
                diff = (row.float() - ref_rows[key].float()).abs().max()
                fail(f"{label} rank {r}: the logits row {key} differs from "
                     f"the unsharded engine's by {float(diff)}")
        n_rows += len(rows)
    return n_rows


def check_recurrent_ranks(torch, what: str, arch: str, periods: int, ranks,
                          out_dir: Path, ref_rows: dict, ref_tokens) -> dict:
    """5m (b) (c)'s gates on one recurrent model's rank results: tokens and
    every logits row of the data rank owning the requests torch.equal to
    the unsharded engine's, every WKV launch over its block of the heads,
    every scan over its block of the channels, every grouped launch over
    its block of the experts."""
    cfg = cut_config(arch, periods)[0]
    model = MESH_SHAPE[1]
    widths = mesh_widths(cfg, model, train=False)
    experts = [cfg.n_experts // model] if cfg.n_experts else []
    for r, rank in enumerate(ranks):
        res = rank[what]
        if res["widths"] != widths or res["grouped_experts"] != experts:
            fail(f"5m (b) {arch} rank {r}: recurrent launches over "
                 f"{res['widths']} heads or channels (expected {widths}), "
                 f"grouped launches over {res['grouped_experts']} experts "
                 f"(expected {experts})")
    n_rows = rows_equal_on_ranks(torch, f"5m (b) {arch}", what, ranks,
                                 out_dir, ref_rows, ref_tokens)
    if not n_rows:
        fail(f"5m (b) {arch}: no logits rows compared")
    res = {"logits_rows_equal": n_rows,
           "peak_gb": max(r[what]["peak_gb"] for r in ranks),
           "load_peak_gb": max(r[what]["load_peak_gb"] for r in ranks),
           "step_ms": [r[what]["step_ms"] for r in ranks],
           "seconds": [r[what]["seconds"] for r in ranks],
           "resident_bytes": [r[what]["resident_bytes"] for r in ranks],
           "whole_bytes": ranks[0][what]["whole_bytes"], "widths": widths,
           "grouped_experts": experts}
    for rank in ranks:
        m = rank[what]
        log(f"  (b) {arch} rank {rank['rank']} {rank['coord']}: its blocks "
            f"drawn leaf by leaf, resident {m['resident_bytes'] / 1e9:.3f} "
            f"GB of {m['whole_bytes'] / 1e9:.3f} GB, device peak "
            f"{m['load_peak_gb']:.3f} GB drawing and {m['peak_gb']:.3f} GB "
            f"serving; launches {m['launches']['host']} over "
            f"{m['prefill_calls']} prefill calls and {m['decode_steps']} "
            f"decode steps; step {m['step_ms']:.1f} ms (host clock, gloo on "
            f"one card); {m['seconds']:.1f} s")
    log(f"  (b) {arch} at {periods} of its "
        f"{path_config(arch, 'mixed').n_periods} periods: tokens and "
        f"{n_rows} logits rows "
        f"torch.equal to the unsharded engine on every rank; recurrent "
        f"launches over {nonzero(widths)}, grouped over {experts} experts")
    return res


# ---------------------------------------------------------------------------
# Phase 5d: training under a mesh.
# ---------------------------------------------------------------------------


def train_mesh_setup(periods: Optional[int] = None, arch: str = MESH_ARCH,
                     micro: Optional[int] = None):
    """(config, data config, optimizer config) of phase 5d: ``arch`` under
    mixed (``periods`` of its periods, ``micro`` microbatches where given),
    5t's batch (with a front end's inputs) and optimizer; an
    encoder-decoder's encoder cut to ``periods`` too."""
    from repro_torch.configs import get_config
    from repro_torch.train import optim
    cfg = get_config(arch, quant="mixed")
    if periods:
        cfg = dataclasses.replace(cfg, n_periods=periods)
        if cfg.is_encdec:
            cfg = dataclasses.replace(cfg, encoder_periods=periods)
    if micro:
        cfg = dataclasses.replace(cfg, n_microbatches=micro)
    return cfg, data_config(cfg), optim.AdamWConfig(
        lr=1e-4, warmup_steps=1, total_steps=TRAIN_MESH_STEPS)


def moe_train_setup():
    """5d (b)'s granite: TRAIN_MESH_MOE_PERIODS periods, TRAIN_MESH_MOE_MICRO
    microbatches of the global batch (each of 2 sequences, one a data
    rank on 2x2)."""
    return train_mesh_setup(TRAIN_MESH_MOE_PERIODS, MESH_MOE_ARCH,
                            TRAIN_MESH_MOE_MICRO)


def rwkv_train_setup():
    """5d (c)'s rwkv6-3b: TRAIN_MESH_RWKV_PERIODS periods, its 4
    microbatches of the global batch (each of 2 sequences, one a data rank
    on 2x2)."""
    return train_mesh_setup(TRAIN_MESH_RWKV_PERIODS, MESH_RWKV_ARCH)


def frontend_train_setups():
    """5d (d)'s llava and seamless: TRAIN_MESH_FRONT_PERIODS periods (the
    encoder's too), TRAIN_MESH_FRONT_MICRO microbatches where the config
    has more (llava's 8 would leave a microbatch of one sequence, which
    does not split over 2 data ranks)."""
    from repro_torch.configs import get_config
    return {what: train_mesh_setup(
        TRAIN_MESH_FRONT_PERIODS, arch, min(
            get_config(arch).n_microbatches, TRAIN_MESH_FRONT_MICRO))
        for what, arch in (("vision", VISION_ARCH), ("encdec", ENCDEC_ARCH))}


# 5d (b)'s models by tag: their arch
TRAIN_MESH_ARCHS = {"llama": MESH_ARCH, "moe": MESH_MOE_ARCH,
                    "rwkv": MESH_RWKV_ARCH, "vision": VISION_ARCH,
                    "encdec": ENCDEC_ARCH}


# (what, setup, init seed, the unsharded step-1 file, the ranks'
# checkpoint, the parent's release file) of 5d (b)'s models, in the order
# the ranks run them; with ``study`` (an arch), those of
# --train-mesh-study.  rwkv6-3b writes no checkpoint: the script runs
# under a 45 GiB budget of disk writes, and rwkv's step-1 file (7.9 GB:
# its untied 65536-row embed and lm_head in fp32, with their gradients, mu
# and nu) and checkpoint (5.9 GB) brought its writes near that; the
# checkpoint's code is the one llama's and granite's runs gate.
def train_mesh_models(study: str = ""):
    if study:
        return tuple(
            (what, setup, seed, TRAIN_MESH_DIR / f"step1_{what}.pt",
             TRAIN_MESH_DIR / f"ckpt_{what}", TRAIN_MESH_DIR / f"ready_{what}")
            for what, setup, seed in train_mesh_study_models(study))
    return (("llama", train_mesh_setup(TRAIN_MESH_PERIODS), TRAIN_MESH_SEED,
             TRAIN_MESH_DIR / "step1.pt", TRAIN_MESH_DIR / "ckpt",
             TRAIN_MESH_DIR / "ready"),
            ("moe", moe_train_setup(), TRAIN_MESH_SEED,
             TRAIN_MESH_DIR / "step1_moe.pt", TRAIN_MESH_DIR / "ckpt_moe",
             TRAIN_MESH_DIR / "ready_moe"),
            ("rwkv", rwkv_train_setup(), TRAIN_MESH_SEED,
             TRAIN_MESH_DIR / "step1_rwkv.pt", None,
             TRAIN_MESH_DIR / "ready_rwkv")) + tuple(
        (what, setup, TRAIN_MESH_SEED, TRAIN_MESH_DIR / f"step1_{what}.pt",
         None, TRAIN_MESH_DIR / f"ready_{what}")
        for what, setup in frontend_train_setups().items())


def train_mesh_study_models(arch: str):
    """--train-mesh-study's runs, (tag, setup, init seed): for 5d (b)'s
    granite, at each of TRAIN_MESH_STUDY_SEEDS, the step as 5d (b) runs it
    (the bf16 compute copy, TRAIN_MESH_MOE_MICRO microbatches), with 2
    microbatches, and in fp32 compute without the bf16 copy; for 5d (c)'s
    rwkv6-3b and 5d (d)'s llava and seamless, the step as it runs there at
    each seed (llava's and seamless's step-1 files hold the front-end
    leaves alone, 0.3 GB or 0.5 GB: the grad norm, and those leaves'
    gradients and update, are what their study reads).  One arch a call:
    each run's step-1 file is 4.4 GB (granite) or 7.9 GB (rwkv), and the
    script's runs have a 45 GiB budget of disk writes."""
    if arch == MESH_RWKV_ARCH:
        return [(f"rwkv_seed{seed}", rwkv_train_setup(), seed)
                for seed in TRAIN_MESH_STUDY_SEEDS]
    if arch in (VISION_ARCH, ENCDEC_ARCH):
        what = {a: w for w, a in TRAIN_MESH_ARCHS.items()}[arch]
        return [(f"{what}_seed{seed}", frontend_train_setups()[what], seed)
                for seed in TRAIN_MESH_STUDY_SEEDS]
    out = []
    for seed in TRAIN_MESH_STUDY_SEEDS:
        cfg, dcfg, ocfg = moe_train_setup()
        two = train_mesh_setup(TRAIN_MESH_MOE_PERIODS, MESH_MOE_ARCH, 2)
        fp32 = dataclasses.replace(cfg, compute_dtype="float32",
                                   bf16_cast_params=False)
        out += [(f"seed{seed}_micro{cfg.n_microbatches}_bf16",
                 (cfg, dcfg, ocfg), seed),
                (f"seed{seed}_micro2_bf16", two, seed),
                (f"seed{seed}_micro{cfg.n_microbatches}_fp32",
                 (fp32, dcfg, ocfg), seed)]
    return out


def state_tree(res_params, state) -> dict:
    return {"params": res_params, "mu": state.mu, "nu": state.nu,
            "step": state.step}


@contextlib.contextmanager
def aux_losses():
    """Every MoE layer's load-balance loss a forward computes while
    entered (not a remat recompute's), as floats."""
    from repro_torch.models import moe
    vals = []
    inner = moe.load_balance_loss

    def spy(r, n):
        v = inner(r, n)
        if not moe._in_backward():
            vals.append(float(v.detach()))
        return v

    moe.load_balance_loss = spy
    try:
        yield vals
    finally:
        moe.load_balance_loss = inner


def world_of_one_training(torch, fg, what: str, setup, mesh,
                          device="cuda") -> dict:
    """TRAIN_MESH_STEPS steps through ``run_training`` with no mesh and
    with ``mesh`` (a world of one): losses and every leaf of params, mu,
    nu and step torch.equal, launches exact and equal."""
    from repro_torch.train.loop import TrainConfig, run_training
    cfg, dcfg, ocfg = setup
    tc = TrainConfig(steps=TRAIN_MESH_STEPS, log_every=1, optimizer=ocfg)
    expect = train_launches(cfg, TRAIN_MESH_STEPS, TRAIN_SEQ)
    out, runs = {"n_periods": cfg.n_periods}, {}
    for label, m in (("no mesh", None), ("mesh 1x1", mesh)):
        res, host, routes, wall = counted(
            torch, fg, lambda: run_training(cfg, tc, dcfg, device=device,
                                            mesh=m), device)
        check_train_counts(f"5d (a) {what} {label}", host, routes, expect)
        runs[label] = res
        out[label] = {"launches": {"host": host}, "losses": res.losses,
                      "wall_s": wall,
                      "step_ms": [1e3 * t for t in res.step_seconds]}
    base = state_tree(runs["no mesh"].params, runs["no mesh"].opt_state)
    got = runs["mesh 1x1"]
    diff = [".".join(p) for (p, a), (_, b) in zip(
        _paths(base), _paths(state_tree(got.params, got.opt_state)))
        if not torch.equal(a, b)]
    if got.losses != out["no mesh"]["losses"] or diff:
        fail(f"5d (a) {what}: the world of one differs from no mesh: "
             f"losses {got.losses} vs {out['no mesh']['losses']}, leaves "
             f"{diff[:4]}")
    log(f"  (a) {what} at {cfg.n_periods} periods: {TRAIN_MESH_STEPS} steps,"
        f" losses " + ", ".join(f"{v:.6f}" for v in got.losses.values())
        + f" and every leaf of params, mu, nu torch.equal to no mesh; "
        f"launches {out['mesh 1x1']['launches']['host']} (exact, equal)")
    del runs, got, base
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def train_world_of_one(torch, fg, device="cuda") -> dict:
    """Phase 5d (a): full-depth llama, then granite at
    TRAIN_GRANITE_PERIODS, rwkv6-3b at TRAIN_MESH_RWKV_PERIODS and llava
    and seamless at TRAIN_MESH_FRONT_PERIODS, each
    for TRAIN_MESH_STEPS steps through
    ``run_training`` with no mesh and with ``mesh=`` a world of one (NCCL
    on the card), under deterministic algorithms
    (:func:`world_of_one_training`)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_backend, single_device_mesh

    mesh = single_device_mesh(device=device)
    if device == "cuda" and mesh_backend(mesh) != "nccl":
        fail(f"5d (a): the world of one runs {mesh_backend(mesh)!r}, not "
             f"NCCL")
    out = {"backend": mesh_backend(mesh)}
    with deterministic(torch) as nondet:
        out.update(world_of_one_training(torch, fg, MESH_ARCH,
                                         train_mesh_setup(), mesh, device))
        out["moe"] = world_of_one_training(
            torch, fg, MESH_MOE_ARCH, train_mesh_setup(
                TRAIN_GRANITE_PERIODS, MESH_MOE_ARCH), mesh, device)
        t0 = time.monotonic()
        out["rwkv"] = world_of_one_training(
            torch, fg, MESH_RWKV_ARCH, rwkv_train_setup(), mesh, device)
        out["rwkv"]["seconds"] = time.monotonic() - t0
        for what, setup in frontend_train_setups().items():
            t0 = time.monotonic()
            out[what] = world_of_one_training(
                torch, fg, TRAIN_MESH_ARCHS[what], setup, mesh, device)
            out[what]["seconds"] = time.monotonic() - t0
    out["nondeterministic_ops"] = nondet
    log(f"  (a) on {out['backend']}, deterministic algorithms; ops without a "
        f"deterministic kernel: {nondet or 'none'}")
    dist.destroy_process_group()
    return out


def train_mesh_reference(torch, setup, seed: int, path: Path,
                         device="cuda", update_of=None, only=None) -> dict:
    """Phase 5d (b)'s reference on the card: the unsharded step 1 of
    ``setup`` from the init at ``seed`` — its loss, its MoE aux losses, its
    gradients and the AdamW update's params, mu, nu and grad norm, saved
    whole for the ranks (``path``; with ``update_of``, a test of a leaf's
    key, the params, mu and nu of the leaves it passes alone, as 5d (d)
    compares them; with ``only``, nothing of the leaves it fails) — each
    saved gradient leaf's largest |entry|, the keys whose update was
    saved, the unsharded params' bytes."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import optim
    cfg, _, ocfg = setup
    params = lm.init_params(torch.Generator(device).manual_seed(seed), cfg,
                            device=device)
    with aux_losses() as aux:
        loss, grads = steps.mean_loss_and_grads(cfg, params,
                                                train_batch(torch, cfg,
                                                            device=device))
    state_bytes = 3 * sum(t.numel() * t.element_size()
                          for t in _leaves(params))
    n_params = param_count(params)
    params, state, metrics = optim.update(ocfg, grads, optim.init(params),
                                          params)
    flat = {}
    for part, tree in (("grads", grads), ("params", params),
                       ("mu", state.mu), ("nu", state.nu)):
        for p, t in _paths(tree):
            key = "/".join(p)
            if only is not None and not only(key) or (
                    part != "grads" and update_of is not None
                    and not update_of(key)):
                continue
            flat[f"{part}/{'/'.join(p)}"] = t.cpu()
            flat[f"max/{part}/{'/'.join(p)}"] = t.abs().max().cpu()
    flat["grad_norm"] = metrics["grad_norm"].cpu()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(flat, path)
    out = {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
           "aux": aux, "params": n_params, "state_bytes": state_bytes,
           "n_periods": cfg.n_periods, "microbatches": cfg.n_microbatches,
           "grad_max": {k[len("max/grads/"):]: float(g)
                        for k, g in flat.items()
                        if k.startswith("max/grads/")},
           "update_keys": sorted(k[len("params/"):] for k in flat
                                 if k.startswith("params/"))}
    del params, grads, state, flat
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def sha256_all(blocks: dict) -> dict:
    """SHA-256 of every host tensor of ``blocks`` (by key), eight at a time
    (hashlib lets go of the GIL on large buffers)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def one(t):
        return hashlib.sha256(t.contiguous().numpy().data).hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(blocks, pool.map(one, blocks.values())))


def block_digests(tree) -> dict:
    """SHA-256 of every leaf's local block, by path."""
    from repro_torch.dist import sharding as S
    return sha256_all({"/".join(p): S.local(t).detach().cpu()
                       for p, t in _paths(tree)})


def step1_distances(torch, S, mesh, grads, params, state, lr,
                    step1: Path) -> dict:
    """A rank's step 1 against the unsharded one (``step1``), on the
    rank's block of every leaf: each gradient's, mu's and nu's largest
    distance over the leaf's largest unsharded |entry|; each param's in
    units of lr, over the entries whose unsharded gradient exceeds
    2 TRAIN_MESH_GRAD_TOL of the leaf's largest (``param_safe``: there the
    gradient gate leaves the sign of the gradient, hence of Adam's first
    update, as unsharded) and over all (``param_all``); of the leaves
    whose update the file holds (5d (d)'s: the front ends')."""
    whole = torch.load(step1, mmap=True, weights_only=True)

    def block(key, like):
        """The rank's block of the unsharded leaf, on the rank's device."""
        return S.local_block(whole[key], S.dtensor_spec(like), mesh).to(
            S.local(like).device)

    out = {"ref_grad_norm": float(whole["grad_norm"]),
           **{k: {} for k in ("grad_rel", "mu_rel", "nu_rel", "param_safe",
                             "param_all")}}
    for part, tree in (("grad", grads), ("mu", state.mu), ("nu", state.nu)):
        src = "grads" if part == "grad" else part
        for path, t in _paths(tree):
            key = "/".join(path)
            if f"{src}/{key}" not in whole:
                continue
            err = (S.local(t) - block(f"{src}/{key}", t)).abs().max()
            out[f"{part}_rel"][key] = float(err) / max(
                float(whole[f"max/{src}/{key}"]), 1e-30)
    for path, p in _paths(params):
        key = "/".join(path)
        if f"params/{key}" not in whole:
            continue
        g = block(f"grads/{key}", p)
        gmax = float(whole[f"max/grads/{key}"])
        diff = (S.local(p) - block(f"params/{key}", p)).abs() / lr
        safe = g.abs() > 2 * TRAIN_MESH_GRAD_TOL * gmax
        out["param_all"][key] = float(diff.max())
        out["param_safe"][key] = float(diff[safe].max()) if bool(
            safe.any()) else 0.0
    return out


def rank_train_steps(torch, fg, S, mesh, setup, seed: int, step1: Path,
                     ckpt_dir: Optional[Path], device: str,
                     step1_only: bool = False) -> dict:
    """One model of 5d (b) on this rank: what ``run_training``'s loop runs
    a step — step 1 from the init at ``seed`` (``mean_loss_and_grads``,
    its gradients' blocks held to the unsharded ones, its MoE aux losses,
    and the AdamW update), the AsyncCheckpointer's save of its state, and
    step 2 through ``make_train_step`` (not with ``step1_only``), each
    step counted, every grouped launch's experts and every recurrent
    launch's heads or channels reported; no checkpoint where ``ckpt_dir``
    is None."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    t_start = time.monotonic()
    cfg, _, ocfg = setup
    out = {"n_periods": cfg.n_periods, "microbatches": cfg.n_microbatches}
    with S.use_mesh(mesh):
        # the seeded init, each rank's blocks (as run_training draws it)
        params = lm.init_params(torch.Generator(device).manual_seed(seed),
                                cfg, device=device, mesh=mesh)
        state = optim.init(params)
        abs_p = steps.abstract_params(cfg, mesh)
        abs_s = steps.abstract_opt_state(abs_p, mesh)
        out["resident_bytes"] = S.resident_bytes(
            {"p": params, "mu": state.mu, "nu": state.nu})
        out["planned_bytes"] = steps.local_bytes((abs_p, abs_s.mu, abs_s.nu),
                                                 mesh)
        batch0 = train_batch(torch, cfg, device=device)

        def first():
            with aux_losses() as aux:
                loss, grads = steps.mean_loss_and_grads(cfg, params, batch0)
            return (loss, grads, aux) + optim.update(ocfg, grads, state,
                                                     params)

        with grouped_experts(fg) as experts, recurrent_widths() as widths:
            (loss, grads, aux, params, state, metrics), host, routes, wall = \
                counted(torch, fg, first, device)
    out["step1"] = {"launches": host, "routes": {
        f"{b}/{r}": c for (b, r), c in routes.items()},
        "loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
        "aux": aux, "step_ms": 1e3 * wall,
        "grouped_experts": sorted(set(experts)),
        "widths": widths_of(widths)}
    out.update(step1_distances(torch, S, mesh, grads, params, state,
                               ocfg.lr, step1))
    del grads
    if step1_only:
        del params, state
        gc.collect()
        out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if device == "cuda" else 0.0)
        out["seconds"] = time.monotonic() - t_start
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        return out
    if ckpt_dir is not None:
        # the loop's checkpoint of step 1: leaves gathered on every rank,
        # rank 0 writes
        t0 = time.monotonic()
        saver = ckpt.AsyncCheckpointer(str(ckpt_dir), keep=1, mesh=mesh)
        saver.save(1, (params, state), meta={"arch": cfg.name})
        saver.wait()
        torch.distributed.barrier()
        out["checkpoint_s"] = time.monotonic() - t0
        out["digests"] = block_digests(state_tree(params, state))
    step = steps.make_train_step(cfg, ocfg)
    batch1 = train_batch(torch, cfg, step=1, device=device)

    def second():
        with S.use_mesh(mesh):
            _, _, metrics = step(params, state, batch1)
        return float(metrics["loss"])

    with recurrent_widths() as widths:
        loss2, host2, routes2, wall2 = counted(torch, fg, second, device)
    out["step2"] = {"launches": host2, "routes": {
        f"{b}/{r}": c for (b, r), c in routes2.items()},
        "loss": loss2, "step_ms": 1e3 * wall2, "widths": widths_of(widths)}
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if device == "cuda" else 0.0)
    out["seconds"] = time.monotonic() - t_start
    del params, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def mamba_block_mesh(torch, fg, S, mesh, device: str) -> dict:
    """5d (c)'s jamba mamba layer on this rank: 5t's block (full width,
    mixed, a seeded generator) in fp32 compute, forward and backward of 2
    sequences of TRAIN_SEQ against a seeded cotangent, first unsharded on
    this rank, then under ``mesh`` on the rank's blocks of the parameters
    and its data rank's sequence (counted: its launches and the scan's
    channels); the gradients summed over the data axes as the train step
    sums them.  Returns the distances of y, dx and every gradient leaf's
    block from the unsharded run's, each over that tensor's largest
    |entry|."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import ssm as SSM
    cfg = dataclasses.replace(get_config(MESH_JAMBA_ARCH, quant="mixed"),
                              compute_dtype="float32",
                              bf16_cast_params=False)
    name = "blk0.mamba"
    gen = torch.Generator(device).manual_seed(5)
    whole = SSM.mamba_init(gen, cfg, torch.float32, device)
    x0 = torch.randn((2, TRAIN_SEQ, cfg.d_model), generator=gen,
                     device=device)
    g = torch.randn(x0.shape, generator=gen, device=device)

    def run(params, x, cot, mesh_):
        leaves = {k: S.local(t).detach().requires_grad_()
                  for k, t in params.items()}
        tree = {k: S.like(params[k], leaves[k]) for k in params}
        xl = x.clone().requires_grad_()
        with (S.use_mesh(mesh_) if mesh_ is not None
              else contextlib.nullcontext()):
            y = SSM.mamba_apply(tree, xl, cfg, cfg.quant, name)
            grads = torch.autograd.grad(y, [xl] + list(leaves.values()), cot)
        return y.detach(), grads[0], dict(zip(leaves, grads[1:]))

    y0, dx0, dw0 = run(whole, x0, g, None)
    held = {k: S.shard_leaf(t, S.leaf_spec(("blocks", "pos0", "mamba", k),
                                           t, mesh), mesh, device)
            for k, t in whole.items()}
    d, _ = S.axes_index(mesh, S.data_axes(mesh))
    rows = slice(d, d + 1)
    with recurrent_widths() as widths:
        (y, dx, dw), host, routes, wall = counted(
            torch, fg, lambda: run(held, x0[rows], g[rows], mesh), device)
    steps._sum_over_data(dw, held, mesh)

    def rel(got, want):
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    out = {"launches": host, "routes": {f"{b}/{r}": c
                                        for (b, r), c in routes.items()},
           "widths": widths_of(widths), "ms": 1e3 * wall,
           "y_equal": bool(torch.equal(y, y0[rows])),
           "rel": {"y": rel(y, y0[rows]), "x": rel(dx, dx0[rows]),
                   **{k: rel(dw[k], S.local_block(
                       dw0[k], S.dtensor_spec(held[k]), mesh))
                      for k in dw}},
           "blocks": {k: list(S.local(t).shape) for k, t in held.items()}}
    del whole, held, dw, dw0
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def check_mamba_block_mesh(parts: list) -> dict:
    """5d (c)'s gates on the ranks' mamba layers: y and every gradient
    within BWD_TOL of the unsharded layer's largest entry, 4 w=8 GEMM
    launches on the kernels, one scan and one scan backward over the
    rank's block of the channels."""
    from repro_torch.configs import get_config
    cfg = get_config(MESH_JAMBA_ARCH, quant="mixed")
    widths = mesh_widths(cfg, MESH_SHAPE[1], train=True)
    expect = {"dense_mm1": 4, "ssm_scan": 1, "ssm_scan_bwd": 1}
    worst: dict = {}
    for p_ in parts:
        r = p_["rank"]
        block = p_["mamba_block"]
        check_train_counts(f"5d (c) jamba mamba layer rank {r}",
                           block["launches"],
                           {tuple(k.split("/")): c
                            for k, c in block["routes"].items()}, expect)
        if block["widths"] != widths:
            fail(f"5d (c) jamba mamba layer rank {r}: scans over "
                 f"{block['widths']} channels, expected {widths}")
        for k, v in block["rel"].items():
            worst[k] = max(worst.get(k, 0.0), v)
    bad = {k: v for k, v in worst.items() if not v <= BWD_TOL}
    if bad:
        fail(f"5d (c) jamba mamba layer on the mesh: past {BWD_TOL} of the "
             f"unsharded layer's largest entry: {bad}")
    top = max(worst, key=worst.get)
    log(f"  (c) jamba's mamba layer (d_inner 8192) fwd + bwd on the 2x2 "
        f"ranks, fp32: y torch.equal on "
        f"{sum(p_['mamba_block']['y_equal'] for p_ in parts)} of "
        f"{len(parts)} ranks; y, dx and every gradient leaf within "
        f"{worst[top]:.3g} ({top}) of the unsharded layer's largest entry "
        f"(gate {BWD_TOL}); launches {expect} a rank (exact), the scans "
        f"over {widths['ssm_scan']} channels; "
        + ", ".join(f"{p_['mamba_block']['ms']:.0f}" for p_ in parts)
        + " ms a rank (host clock)")
    return {"rel_max": worst, "gate": BWD_TOL, "expect": expect,
            "widths": widths, "ranks": parts}


def train_mesh_rank(rank: int, world: int, port: int, out_dir: str,
                    device: str = "cuda", study: str = "") -> int:
    """``--train-mesh-rank``: one rank of phase 5d (b) on cuda:0 over gloo.
    It joins the mesh while the parent runs (a), then for llama, granite
    and rwkv6-3b waits for the parent's unsharded step (its release file)
    and runs :func:`rank_train_steps`, then writes its results
    (``train_mesh_{llama|moe|rwkv}{rank}.json``); then jamba's mamba layer
    (:func:`mamba_block_mesh`, ``train_mesh_mamba{rank}.json``).  With
    ``study`` (an arch), --train-mesh-study's runs of it instead, step 1
    alone."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import sharding as S
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_gemm as fg
    from repro_torch.launch.mesh import make_mesh, mesh_backend

    parent = os.getppid()
    if device == "cuda":
        torch.cuda.set_device(0)
        missing = [n for n in build.SOURCES
                   if not build.library_path(n).exists()]
        if missing:
            fail(f"5d (b) rank {rank}: the libraries {missing} are not "
                 f"built; the parent builds them before it starts the ranks")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh(MESH_SHAPE, device=device)
    if mesh_backend(mesh) != "gloo":
        fail(f"5d (b): the mesh runs {mesh_backend(mesh)!r}, not gloo")
    out = {"rank": rank, "coord": S.coordinate(mesh)}
    for what, setup, seed, step1, ckpt_dir, ready in \
            train_mesh_models(study):
        deadline = time.monotonic() + TRAIN_MESH_TIMEOUT
        while not ready.exists():
            if os.getppid() != parent or time.monotonic() > deadline:
                fail(f"5d (b) rank {rank}: no unsharded {what} step from "
                     f"the parent")
            time.sleep(0.2)
        res = rank_train_steps(torch, fg, S, mesh, setup, seed, step1,
                               ckpt_dir, device, bool(study)
                               or what in TRAIN_MESH_STEP1_ONLY)
        path = Path(out_dir) / f"train_mesh_{what}{rank}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(dict(out, **res), indent=1))
        tmp.rename(path)                # whole when the parent sees it
    if not study:
        t0 = time.monotonic()
        res = mamba_block_mesh(torch, fg, S, mesh, device)
        res["seconds"] = time.monotonic() - t0
        path = Path(out_dir) / f"train_mesh_mamba{rank}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(dict(out, mamba_block=res), indent=1))
        tmp.rename(path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


class _RankCoord:
    """A ``MESH_SHAPE`` mesh's names and sizes at one rank's coordinate,
    enough for ``dist.sharding``'s rules and ``local_block``."""
    axis_names = ("data", "model")

    def __init__(self, coord: dict):
        self.shape = dict(zip(self.axis_names, MESH_SHAPE))
        self.coord = [coord[a] for a in self.axis_names]

    def get_coordinate(self):
        return self.coord


def checkpoint_digests(torch, ranks, cfg, ckpt_dir: Path) -> int:
    """The ranks' step-1 checkpoint of ``cfg`` loaded here with no mesh:
    each rank's ``leaf_spec`` block of every leaf hashed, against the
    rank's own digests of what it held.  Returns the leaves compared."""
    from repro_torch.dist import sharding as S
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    shapes = lm.init_params(torch.Generator(), cfg, device="meta")
    like = optim.tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                          shapes)
    mu = optim.tree_map(lambda a: torch.empty(a.shape), shapes)
    like_state = optim.OptState(step=torch.zeros((), dtype=torch.int32),
                                mu=mu, nu=optim.tree_map(torch.empty_like,
                                                         mu))
    step, (params, state), _ = ckpt.load(str(ckpt_dir), (like, like_state))
    if step != 1:
        fail(f"5d (b): the ranks' checkpoint holds step {step}, not 1")
    tree = state_tree(params, state)
    n = 0
    for rank in ranks:
        mesh = _RankCoord(rank["coord"])
        got = sha256_all({"/".join(path): S.local_block(
            leaf, S.leaf_spec(path[1:] or path, leaf, mesh), mesh)
            for path, leaf in _paths(tree)})
        diff = [k for k, d in got.items() if d != rank["digests"][k]]
        if diff or got.keys() != rank["digests"].keys():
            fail(f"5d (b): rank {rank['rank']}'s {diff[:4]} differ from its "
                 f"blocks of the checkpoint loaded with no mesh")
        n += len(got)
    return n


def check_train_mesh(torch, what: str, parts: list, ref: dict, setup,
                     ckpt_dir: Optional[Path],
                     exact_loss: bool = False) -> dict:
    """5d (b)'s gates on one model's rank results ``parts`` (one a rank)
    against the unsharded step ``ref``: exact launches both steps, resident
    bytes the specs' and at most TRAIN_MESH_RESIDENT of the unsharded,
    every rank's losses equal and step 1's near the unsharded, the grad
    norm, every leaf's gradient, mu, nu and param within their gates, the
    MoE aux losses, expert gradients and grouped launches, every
    recurrent launch's heads or channels, the checkpoint's blocks (where
    the ranks wrote one).  With ``exact_loss`` (5d (d): step 1 alone)
    the loss must be the unsharded step's to the bit, the grad norm is
    held to TRAIN_MESH_FRONT_NORM_RTOL, mu, nu and params are compared on
    the leaves whose update the unsharded file holds (``update_keys``),
    and the worst projector and encoder leaves are named."""
    grad_tol = TRAIN_MESH_GRAD_TOL
    norm_rtol = (TRAIN_MESH_FRONT_NORM_RTOL if exact_loss
                 else TRAIN_MESH_NORM_RTOL)
    cfg = setup[0]
    expect = train_launches(cfg, 1, TRAIN_SEQ)
    worst = {k: {} for k in ("grad_rel", "mu_rel", "nu_rel", "param_safe",
                             "param_all")}
    norm_rel = 0.0
    aux_rel = 0.0
    experts = cfg.n_experts // MESH_SHAPE[1] if cfg.n_experts else None
    widths = mesh_widths(cfg, MESH_SHAPE[1], train=True)
    ran = [p for p in ("step1", "step2") if p in parts[0]]
    for part_ in parts:
        r = part_["rank"]
        for part in ran:
            check_train_counts(
                f"5d (b) {what} rank {r} {part}", part_[part]["launches"],
                {tuple(k.split("/")): c for k, c in
                 part_[part]["routes"].items()}, expect)
            if part_[part]["widths"] != widths:
                fail(f"5d (b) {what} rank {r} {part}: recurrent launches "
                     f"over {part_[part]['widths']} heads or channels, "
                     f"expected {widths}")
        if part_["resident_bytes"] != part_["planned_bytes"] or \
                part_["resident_bytes"] > TRAIN_MESH_RESIDENT * \
                ref["state_bytes"]:
            fail(f"5d (b) {what} rank {r}: resident "
                 f"{part_['resident_bytes']} bytes (the specs place "
                 f"{part_['planned_bytes']}) of {ref['state_bytes']} "
                 f"unsharded")
        for p, by_leaf in worst.items():
            for key, v in part_[p].items():
                by_leaf[key] = max(by_leaf.get(key, 0.0), v)
        norm_rel = max(norm_rel, abs(part_["step1"]["grad_norm"]
                                     - ref["grad_norm"]) / ref["grad_norm"])
        aux = part_["step1"]["aux"]
        if len(aux) != len(ref["aux"]):
            fail(f"5d (b) {what} rank {r}: {len(aux)} aux losses, the "
                 f"unsharded step {len(ref['aux'])}")
        for a, b in zip(aux, ref["aux"]):
            aux_rel = max(aux_rel, abs(a - b) / abs(b))
        if part_["step1"]["grouped_experts"] != ([experts] if experts
                                                 else []):
            fail(f"5d (b) {what} rank {r}: grouped launches over "
                 f"{part_['step1']['grouped_experts']} experts, not "
                 f"{experts}")
    if aux_rel > TRAIN_MESH_MOE_AUX_RTOL:
        fail(f"5d (b) {what}: step 1's aux losses are {aux_rel:.3g} from the "
             f"unsharded (gate {TRAIN_MESH_MOE_AUX_RTOL})")
    for part in ran:
        if len({p[part]["loss"] for p in parts}) != 1:
            fail(f"5d (b) {what}: the ranks' {part} losses differ: "
                 f"{[p[part]['loss'] for p in parts]}")
    loss1 = parts[0]["step1"]["loss"]
    rel_loss = abs(loss1 - ref["loss"]) / abs(ref["loss"])
    if exact_loss and loss1 != ref["loss"]:
        fail(f"5d (d) {what}: step 1's loss {loss1!r} is not the unsharded "
             f"step's {ref['loss']!r} to the bit")
    if rel_loss > TRAIN_MESH_LOSS_RTOL:
        fail(f"5d (b) {what}: step 1's loss {loss1} is {rel_loss:.3g} from "
             f"the unsharded {ref['loss']} (gate {TRAIN_MESH_LOSS_RTOL})")
    if not norm_rel <= norm_rtol:
        fail(f"5d (b) {what}: step 1's grad norm is {norm_rel:.3g} from the "
             f"unsharded {ref['grad_norm']} (gate {norm_rtol})")
    # mu = (1 - b1) clip g and nu = (1 - b2) (clip g)^2 at step 1: their
    # gates follow from the gradient's and the norm's (the clip factor)
    mu_tol = grad_tol * (1 + norm_rtol) + norm_rtol
    gates = {"grad_rel": grad_tol, "mu_rel": mu_tol,
             "nu_rel": (1 + mu_tol) ** 2 - 1,
             "param_safe": TRAIN_MESH_PARAM_TOL,
             "param_all": 2 + TRAIN_MESH_PARAM_TOL}
    for part, gate in gates.items():
        bad = {k: v for k, v in worst[part].items() if not v <= gate}
        if bad or len(worst[part]) != len(
                ref["grad_max"] if part == "grad_rel" else ref["update_keys"]):
            fail(f"5d (b) {what}: step 1's {part} past its gate {gate:.3g}: "
                 f"{bad}")
    experts = {k: v for k, v in worst["grad_rel"].items() if "/moe/" in k}
    bad = {k: v for k, v in experts.items()
           if not v <= TRAIN_MESH_MOE_GRAD_TOL}
    if bad:
        fail(f"5d (b) {what}: step 1's expert gradients past their gate "
             f"{TRAIN_MESH_MOE_GRAD_TOL}: {bad}")
    # the worst projector and encoder leaves (5d (d)'s models)
    grad = worst["grad_rel"]
    leaves = {kind: max((k for k in grad if k.startswith(prefix)),
                        key=grad.get, default=None)
              for kind, prefix in (("projector", "frontend/"),
                                   ("encoder", "enc"))}
    named = {kind: (k, grad[k]) for kind, k in leaves.items() if k}
    t0 = time.monotonic()
    compared = (checkpoint_digests(torch, parts, cfg, ckpt_dir)
                if ckpt_dir is not None else 0)
    out = {"checkpoint_compare_s": time.monotonic() - t0,
           "loss_rel": rel_loss, "norm_rel": norm_rel, "aux_rel": aux_rel,
           "step1_rel": worst, "step1_gates": gates,
           "step1_rel_max": {k: max(worst[k].values()) for k in gates},
           "checkpoint_leaves_compared": compared, "expect_per_step": expect,
           "n_periods": cfg.n_periods, "microbatches": cfg.n_microbatches,
           "widths": widths, "worst_leaves": named,
           "loss_equal": loss1 == ref["loss"]}
    for part_ in parts:
        part_.pop("digests", None)
        log(f"  (b) {what} rank {part_['rank']}: resident "
            f"{part_['resident_bytes'] / 1e9:.3f} GB of "
            f"{ref['state_bytes'] / 1e9:.3f} GB unsharded; step ms "
            + " and ".join(f"{part_[p]['step_ms']:.0f}" for p in ran)
            + " (host clock, four gloo ranks on one card)"
            + (f", the checkpoint {part_['checkpoint_s']:.1f} s"
               if "checkpoint_s" in part_ else "") + "; "
            f"device peak {part_['peak_gb']:.2f} GB; launches a step "
            f"{part_[ran[-1]]['launches']} (exact)")
    log(f"  (b) {what} at {cfg.n_periods} periods, {cfg.n_microbatches} "
        f"microbatches: losses "
        + " / ".join(f"{parts[0][p]['loss']:.6f}" for p in ran)
        + f" on every rank; step 1 {rel_loss:.3g} from the unsharded step"
        + (" (torch.equal)" if loss1 == ref["loss"] else "") + ", its "
        f"grad norm {norm_rel:.3g} (gate {norm_rtol}), aux losses "
        f"{aux_rel:.3g} (gate {TRAIN_MESH_MOE_AUX_RTOL}); largest distances "
        "(gate): " + ", ".join(f"{k} {max(worst[k].values()):.3g} ({g:.3g})"
                               for k, g in gates.items())
        + (f"; the step-1 checkpoint loaded with no mesh equals every "
           f"rank's blocks ({compared} leaf blocks)" if compared else "")
        + (f"; recurrent launches over {nonzero(widths)}"
           if nonzero(widths) else "")
        + "".join(f"; the worst {kind} leaf {k} {v:.3g}"
                  for kind, (k, v) in named.items()))
    return out


def train_mesh_study(torch, fg, arch: str) -> dict:
    """--train-mesh-study ARCH: 5d (b)'s granite or 5d (c)'s rwkv6-3b step 1
    on the MESH_RANKS gloo ranks against the unsharded step, for each of
    :func:`train_mesh_study_models` — the distances 5d (b)'s gates are
    read from, with each leaf's largest unsharded gradient entry (the
    gates' scale), reported with no gate applied.  Every process stopped
    before it returns."""
    import shutil
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    TRAIN_MESH_DIR.mkdir(parents=True)
    out_dir = ROOT / "chiprun_out" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in out_dir.glob("train_mesh_*.json"):
        path.unlink()
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-mesh-rank",
         str(r), str(MESH_RANKS), str(port), str(out_dir), "cuda", arch],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    models = train_mesh_models(study=arch)
    refs, out = {}, {}
    try:
        for what, setup, seed, step1, _, ready in models:
            front = (front_update_leaf if arch in (VISION_ARCH, ENCDEC_ARCH)
                     else None)
            refs[what] = train_mesh_reference(torch, setup, seed, step1,
                                              update_of=front, only=front)
            ready.touch()
        deadline = time.monotonic() + TRAIN_MESH_TIMEOUT
        for what, setup, seed, _, _, _ in models:
            parts = [rank_results(out_dir / f"train_mesh_{what}{r}.json",
                                  procs, deadline)
                     for r in range(MESH_RANKS)]
            ref = refs[what]
            worst = {}
            for part in ("grad_rel", "mu_rel", "nu_rel", "param_safe",
                         "param_all"):
                worst[part] = {}
                for p_ in parts:
                    for key, v in p_[part].items():
                        worst[part][key] = max(worst[part].get(key, 0.0), v)
            grad = worst["grad_rel"]
            top = max(grad, key=grad.get)
            cfg = setup[0]
            res = out[what] = {
                "seed": seed, "microbatches": cfg.n_microbatches,
                "compute_dtype": cfg.compute_dtype,
                "bf16_cast_params": cfg.bf16_cast_params,
                "loss_rel": abs(parts[0]["step1"]["loss"] - ref["loss"])
                / abs(ref["loss"]),
                "norm_rel": max(abs(p_["step1"]["grad_norm"]
                                    - ref["grad_norm"]) / ref["grad_norm"]
                                for p_ in parts),
                "aux_rel": max((abs(a - b) / abs(b) for p_ in parts
                                for a, b in zip(p_["step1"]["aux"],
                                                ref["aux"])), default=0.0),
                "worst_leaf": top, "expert_grad_rel": max(
                    (v for key, v in grad.items() if "/moe/" in key),
                    default=None),
                "grad_max": ref["grad_max"],
                "step1_rel": worst,
                "step1_rel_max": {k: max(v.values())
                                  for k, v in worst.items()}}
            small = min(ref["grad_max"], key=ref["grad_max"].get)
            log(f"  {what}: gradients at most {grad[top]:.4g} of a leaf's "
                f"largest entry ({top}, whose largest is "
                f"{ref['grad_max'][top]:.4g}), embed {grad.get('embed')}, "
                f"expert leaves {res['expert_grad_rel']}; grad norm "
                f"{res['norm_rel']:.3g}, loss {res['loss_rel']:.3g}, aux "
                f"{res['aux_rel']:.3g} relative; the smallest leaf's "
                f"largest gradient entry {ref['grad_max'][small]:.4g} "
                f"({small})")
        for r, p in enumerate(procs):
            text = p.communicate(timeout=max(deadline - time.monotonic(),
                                             1))[0]
            if p.returncode != 0:
                print(text[-6000:], file=sys.stderr)
                fail(f"--train-mesh-study: rank {r} exited with "
                     f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    return out


def rank_results(path: Path, procs, deadline: float) -> dict:
    """A rank's results file once it is written; fails where a rank exited
    with an error or the deadline passed first."""
    while not path.exists():
        for r, p in enumerate(procs):
            if p.poll() not in (None, 0):
                print(p.communicate()[0][-6000:], file=sys.stderr)
                fail(f"5d (b): rank {r} exited with {p.returncode}")
        if time.monotonic() > deadline:
            fail(f"5d (b): no {path.name} from the ranks")
        time.sleep(0.2)
    return json.loads(path.read_text())


def train_mesh_phase(torch, fg, device="cuda",
                     world_of_one: Optional[dict] = None) -> dict:
    """Phase 5d: (b)'s ranks started first (they join their mesh and
    wait), then (b)'s unsharded steps here, each releasing the ranks for
    its model, then (a) in this process while the ranks run (unless
    ``world_of_one``, its result, was run before); then each model's gates
    as soon as every rank wrote its results (llama's while the ranks train
    granite); every process stopped before it returns."""
    import shutil
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    TRAIN_MESH_DIR.mkdir(parents=True)
    out_dir = ROOT / "chiprun_out" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in out_dir.glob("train_mesh_*.json"):
        path.unlink()
    port = free_port()
    t_ranks = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-mesh-rank",
         str(r), str(MESH_RANKS), str(port), str(out_dir), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    refs, out = {}, {}
    try:
        for what, setup, seed, step1, _, ready in train_mesh_models():
            t0 = time.monotonic()
            refs[what] = train_mesh_reference(
                torch, setup, seed, step1, device,
                update_of=(front_update_leaf if what in TRAIN_MESH_STEP1_ONLY
                           else None))
            ready.touch()
            out[f"unsharded_{what}"] = {k: v for k, v in refs[what].items()
                                        if k != "grad_max"}
            out[f"unsharded_{what}_s"] = time.monotonic() - t0
        if world_of_one is None:
            t0 = time.monotonic()
            world_of_one = train_world_of_one(torch, fg, device)
            out["world_of_one_s"] = time.monotonic() - t0
        out["world_of_one"] = world_of_one
        deadline = time.monotonic() + TRAIN_MESH_TIMEOUT
        for what, setup, _, _, ckpt_dir, _ in train_mesh_models():
            t0 = time.monotonic()
            parts = [rank_results(out_dir / f"train_mesh_{what}{r}.json",
                                  procs, deadline)
                     for r in range(MESH_RANKS)]
            out[f"ranks_{what}_s"] = time.monotonic() - t_ranks
            res = out[what] = check_train_mesh(
                torch, TRAIN_MESH_ARCHS[what], parts, refs[what], setup,
                ckpt_dir, exact_loss=what in TRAIN_MESH_STEP1_ONLY)
            res["ranks"] = parts
            res["check_s"] = time.monotonic() - t0
        parts = [rank_results(out_dir / f"train_mesh_mamba{r}.json", procs,
                              deadline) for r in range(MESH_RANKS)]
        out["ranks_mamba_s"] = time.monotonic() - t_ranks
        out["mamba_block"] = check_mamba_block_mesh(parts)
        for r, p in enumerate(procs):
            text = p.communicate(timeout=max(deadline - time.monotonic(),
                                             1))[0]
            if p.returncode != 0:
                print(text[-6000:], file=sys.stderr)
                fail(f"5d (b): rank {r} exited with {p.returncode}")
        out["ranks_started_s"] = time.monotonic() - t_ranks
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    llama = out.pop("llama")
    out.update(llama)
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--train-mesh-rank":
        return train_mesh_rank(*(int(a) for a in sys.argv[2:5]),
                               sys.argv[5], *sys.argv[6:8])
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        return mesh_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-p2p-probe":
        return gloo_p2p_probe(int(sys.argv[2]), int(sys.argv[3]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short serve run with torch.profiler")
    ap.add_argument("--chunk-study", action="store_true",
                    help="only build and compare chunked with single-shot "
                    "prefill at full width, two prompt sets, two runs "
                    "(writes chiprun_out/chunk_study.json)")
    ap.add_argument("--train-mesh-study", nargs="?", const=MESH_MOE_ARCH,
                    choices=(MESH_MOE_ARCH, MESH_RWKV_ARCH, VISION_ARCH,
                             ENCDEC_ARCH), metavar="ARCH",
                    help="only build and run phase 5d (b)'s step 1 of ARCH "
                    f"({MESH_MOE_ARCH}, the default: over init seeds, "
                    f"microbatches and compute dtypes; {MESH_RWKV_ARCH}, "
                    f"{VISION_ARCH} or {ENCDEC_ARCH}: 5d (c)'s or 5d (d)'s, "
                    "over init seeds) on the 2x2 gloo ranks "
                    "against the unsharded step, no gate applied (writes "
                    "chiprun_out/train_mesh_study_ARCH.json)")
    ap.add_argument("--profile-path", metavar="ARCH:POLICY[:forced]",
                    help="only build, serve this one path of PATHS (with "
                    ":forced, of TABLE_PATHS under its forcing table) once "
                    "and trace its decode steps (writes "
                    "chiprun_out/profile_ARCH_POLICY[_forced].json)")
    args = ap.parse_args()

    # Phase 5t's restart gate runs under torch.use_deterministic_algorithms,
    # whose cuBLAS half needs this before CUDA starts (it sizes cuBLAS's
    # workspace; it moves no value of a non-deterministic run).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    if args.train_mesh_study:
        arch = args.train_mesh_study
        log(f"[5d] study: {arch}'s step 1 on the 2x2 gloo ranks against the "
            "unsharded step")
        study = train_mesh_study(torch, fg, arch)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"train_mesh_study_{arch}.json").write_text(json.dumps(
            {"card": card, "arch": arch, "study": study}, indent=1))
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
    log(f"[3w] WKV backward kernel vs plain version (allclose, rtol "
        f"{BWD_TOL}, atol {BWD_TOL} x the largest entry)")
    wkv_bwd_rows = wkv_bwd_checks(torch)
    seconds["wkv_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log(f"[3s] selective-scan kernel vs plain version (allclose, rtol = "
        f"atol = {SSM_TOL})")
    ssm_rows = ssm_checks(torch)
    log(f"[3s] selective-scan backward kernel vs plain version (allclose, "
        f"rtol {BWD_TOL}, atol {BWD_TOL} x the largest entry)")
    ssm_bwd_rows = ssm_bwd_checks(torch)
    seconds["ssm_checks"] = time.monotonic() - t0
    t0 = time.monotonic()
    log("[3k] the ATen route (digit recursion on ATen leaf products): card "
        "vs CPU, timed beside the fused kernel")
    aten_rows = aten_checks(torch, fg)
    seconds["aten_checks"] = time.monotonic() - t0
    seconds["aten_checks: timing"] = aten_rows["timing_s"]
    seconds["aten_checks: comparisons"] = (seconds["aten_checks"]
                                           - aten_rows["timing_s"])
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
    smoke_diff = {arch: smoke_parity(torch, np, arch)
                  for arch in archs + ["jamba-v0.1-52b", VISION_ARCH,
                                       ENCDEC_ARCH]}
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

    for arch, dense, per_call_too, grouped in DENSE_PATHS:
        log(f"[5n] serve full-width {arch} under mixed"
            + (", per call and" if per_call_too else "")
            + " on records from the leaf-wise init")
        t0 = time.monotonic()
        engines[arch] = serve_dense(torch, np, fg, arch, dense, per_call_too,
                                    grouped)
        seconds[f"serve {arch}"] = time.monotonic() - t0
        launches_by_path[f"{arch} mixed records"] = \
            engines[arch]["records"]["launches"]
        if per_call_too:
            for mode, run in engines[arch]["per_call"].items():
                launches_by_path[f"{arch} mixed {mode}"] = run["launches"]
        if "vision_prefix" in engines[arch]:
            launches_by_path[f"{arch} vision prefix"] = \
                engines[arch]["vision_prefix"]["launches"]
        torch.cuda.empty_cache()

    log(f"[5e] {ENCDEC_ARCH} under mixed on records from the leaf-wise "
        f"init: prefill on frames, decode on the memory")
    t0 = time.monotonic()
    engines[ENCDEC_ARCH] = serve_encdec(torch, fg)
    seconds[f"serve {ENCDEC_ARCH}"] = time.monotonic() - t0
    launches_by_path[f"{ENCDEC_ARCH} mixed records"] = \
        engines[ENCDEC_ARCH]["launches"]
    torch.cuda.empty_cache()

    log("[5a] serve full-width llama3.2-1b on the ATen route: mixed on "
        "'aten', every site at w=28 on 'cuda'")
    t0 = time.monotonic()
    aten_serve = serve_aten(torch, np, fg)
    seconds["serve aten"] = time.monotonic() - t0
    for path, run in aten_serve.items():
        launches_by_path[f"llama3.2-1b {path}"] = run["launches"]
    torch.cuda.empty_cache()

    log("[5o] observability: the launcher with --metrics-out / --trace-out, "
        "llama and granite on records with obs on and off")
    t0 = time.monotonic()
    obs = serve_obs(torch, fg, card, launches_by_path)
    seconds["serve obs"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    log("[5t] training: the smoke models card vs CPU, full-width llama "
        f"(4 steps; restart at {TRAIN_RESTART_PERIODS} periods), granite at "
        f"4 periods and rwkv6-3b at {TRAIN_RWKV_PERIODS} under "
        "mixed; one full-width jamba mamba block")
    t0 = time.monotonic()
    train = train_phase(torch, fg)
    seconds["train"] = time.monotonic() - t0
    for arch in ("llama3.2-1b", "granite-moe-3b-a800m", "rwkv6-3b"):
        launches_by_path[f"{arch} train mixed"] = \
            train[arch]["counted"]["launches"]
    launches_by_path["jamba-v0.1-52b mamba block train"] = \
        train["jamba-v0.1-52b"]["mamba_block"]["launches"]
    torch.cuda.empty_cache()

    log(f"[5d] training under a mesh: full-depth {MESH_ARCH}, "
        f"{MESH_MOE_ARCH} at {TRAIN_GRANITE_PERIODS} periods and "
        f"{MESH_RWKV_ARCH} at {TRAIN_MESH_RWKV_PERIODS} on a world of one "
        f"(NCCL) against no mesh here; then, beside 5m's ranks, "
        f"{MESH_RANKS} gloo ranks on this card ({MESH_SHAPE[0]}x"
        f"{MESH_SHAPE[1]}), {MESH_ARCH} at {TRAIN_MESH_PERIODS} periods, "
        f"{MESH_MOE_ARCH} at {TRAIN_MESH_MOE_PERIODS} and {MESH_RWKV_ARCH} "
        f"at {TRAIN_MESH_RWKV_PERIODS}, {VISION_ARCH} and {ENCDEC_ARCH} at "
        f"{TRAIN_MESH_FRONT_PERIODS} (step 1), against the unsharded steps, "
        f"and {MESH_JAMBA_ARCH}'s mamba layer against the unsharded layer")
    t0 = time.monotonic()
    train_woo = train_world_of_one(torch, fg)
    train_woo_s = time.monotonic() - t0
    seconds["train mesh: world of one (a)"] = train_woo_s
    torch.cuda.empty_cache()

    log("[5m] distributed serving: a world of one on NCCL, graphed, then "
        f"{MESH_RANKS} gloo ranks on this card ({MESH_SHAPE[0]}x"
        f"{MESH_SHAPE[1]}): sharded kernels and the full-width engines "
        f"({MESH_ARCH}, then {MESH_MOE_ARCH} expert-parallel, then "
        f"{MESH_RWKV_ARCH} head-parallel and {MESH_JAMBA_ARCH} "
        f"channel-parallel; then the prefix cache, {MESH_ARCH} and "
        f"{MESH_RWKV_ARCH}, and the front ends, {VISION_ARCH} and "
        f"{ENCDEC_ARCH})")
    side = {}

    def train_beside():
        """Phase 5d's ranks and unsharded steps, run while 5m's ranks serve
        (both are gloo ranks on this card whose times are transport
        checks, and neither waits on the other)."""
        torch.cuda.empty_cache()        # what 5m (a) left cached
        t = time.monotonic()
        side["train_mesh"] = train_mesh_phase(torch, fg,
                                              world_of_one=train_woo)
        side["seconds"] = time.monotonic() - t

    t0 = time.monotonic()
    mesh = mesh_phase(torch, np, fg, beside=train_beside)
    if "train_mesh" not in side:
        fail("5d did not run beside 5m's ranks")
    # "mesh" is 5m's own wall time, "train mesh" 5d's, whose part (b) ran
    # inside it beside 5m's ranks
    seconds["train mesh"] = train_woo_s + side["seconds"]
    seconds["mesh"] = time.monotonic() - t0 - side["seconds"]
    woo = mesh["world_of_one"]
    # parts of "mesh": (c)'s (a) in this process, (c)'s (b) on the ranks
    # (which ran beside (a))
    seconds["mesh: recurrent (a)"] = woo["recurrent_s"]
    seconds["mesh: recurrent (b), ranks"] = max(
        sum(r[what]["seconds"] for what, _, _ in MESH_RECURRENT)
        for r in mesh["ranks"])
    for arch, runs in ((MESH_ARCH, woo), (MESH_MOE_ARCH, woo["moe"]),
                       (MESH_RWKV_ARCH, woo["rwkv"]),
                       (MESH_JAMBA_ARCH, woo["jamba"])):
        for label in ("no mesh", "mesh 1x1"):
            launches_by_path[f"{arch} mixed records {label}"] = \
                runs[label]["launches"]
    launches_by_path[f"{MESH_ARCH} mixed records, {MESH_PERIODS} periods"] = \
        woo["cut"]["launches"]
    launches_by_path[f"{MESH_MOE_ARCH} mixed records, {MESH_MOE_PERIODS} "
                     f"periods"] = woo["moe_cut"]["launches"]
    launches_by_path[f"{MESH_RWKV_ARCH} mixed records, {MESH_RWKV_PERIODS} "
                     f"periods"] = woo["rwkv_cut"]["launches"]
    for rank in mesh["ranks"]:
        for what, arch in (("", MESH_ARCH), ("moe", MESH_MOE_ARCH),
                           ("rwkv", MESH_RWKV_ARCH),
                           ("jamba", MESH_JAMBA_ARCH)):
            launches_by_path[f"{arch} mesh 2x2 rank {rank['rank']}"] = \
                (rank[what] if what else rank)["launches"]
    # 5m (d): the prefix cache's (a) here and (b) on the ranks, the front
    # ends' references here and (b) on the ranks
    seconds["mesh: prefix cache (a)"] = woo["prefix_s"]
    seconds["mesh: front ends (a)"] = woo["frontends_s"]
    seconds["mesh: prefix cache (b), ranks"] = max(
        sum(r[what]["seconds"] for what, _, _ in MESH_PREFIX)
        for r in mesh["ranks"])
    seconds["mesh: front ends (b), ranks"] = max(
        sum(r[what]["seconds"] for what, _, _, _ in MESH_FRONTENDS)
        for r in mesh["ranks"])
    for what, arch, periods in MESH_PREFIX:
        for label in ("no mesh", "mesh 1x1"):
            launches_by_path[f"{arch} prefix cache, {periods} periods, "
                             f"{label}"] = woo[what][label]["launches"]
        for rank in mesh["ranks"]:
            launches_by_path[f"{arch} prefix cache mesh 2x2 rank "
                             f"{rank['rank']}"] = rank[what]["launches"]
    for what, arch, _, _ in MESH_FRONTENDS:
        launches_by_path[f"{arch} front end, cut, no mesh"] = \
            woo["frontends"][what]["launches"]
        for rank in mesh["ranks"]:
            launches_by_path[f"{arch} front end mesh 2x2 rank "
                             f"{rank['rank']}"] = rank[what]["launches"]
    torch.cuda.empty_cache()

    train_mesh = side["train_mesh"]
    woo = train_mesh["world_of_one"]
    # parts of "train mesh": (c)'s unsharded step and (a) in this process,
    # (c)'s (b) and the mamba layer on the ranks (beside (a))
    seconds["train mesh: rwkv unsharded step"] = \
        train_mesh["unsharded_rwkv_s"]
    seconds["train mesh: rwkv (a)"] = woo["rwkv"]["seconds"]
    seconds["train mesh: rwkv (b), ranks"] = max(
        r["seconds"] for r in train_mesh["rwkv"]["ranks"])
    seconds["train mesh: mamba layer, ranks"] = max(
        r["mamba_block"]["seconds"]
        for r in train_mesh["mamba_block"]["ranks"])
    # 5d (d)'s parts: the unsharded steps and (a) here, (b) on the ranks
    for what in TRAIN_MESH_STEP1_ONLY:
        seconds[f"train mesh: {what} unsharded step"] = \
            train_mesh[f"unsharded_{what}_s"]
        seconds[f"train mesh: {what} (a)"] = woo[what]["seconds"]
        seconds[f"train mesh: {what} (b), ranks"] = max(
            r["seconds"] for r in train_mesh[what]["ranks"])
    for arch, runs in ((MESH_ARCH, woo), (MESH_MOE_ARCH, woo["moe"]),
                       (MESH_RWKV_ARCH, woo["rwkv"]),
                       (VISION_ARCH, woo["vision"]),
                       (ENCDEC_ARCH, woo["encdec"])):
        for label in ("no mesh", "mesh 1x1"):
            launches_by_path[f"{arch} train mixed {label}"] = \
                runs[label]["launches"]

    def both_steps(part):
        ran = [p for p in ("step1", "step2") if p in part]
        return {"host": {k: sum(part[p]["launches"].get(k, 0) for p in ran)
                         for p_ in ran for k in part[p_]["launches"]}}

    # each rank's parts: llama, granite, rwkv, llava, seamless, mamba layer
    train_ranks = list(zip(*(train_mesh[what]["ranks"] if what else
                             train_mesh["ranks"] for what in (
                                 "", "moe", "rwkv", "vision", "encdec",
                                 "mamba_block"))))
    for parts in train_ranks:
        for arch, part in zip((MESH_ARCH, MESH_MOE_ARCH, MESH_RWKV_ARCH,
                               VISION_ARCH, ENCDEC_ARCH), parts):
            launches_by_path[f"{arch} train mesh 2x2 rank {part['rank']}"] \
                = both_steps(part)
        launches_by_path[f"{MESH_JAMBA_ARCH} mamba layer train mesh 2x2 "
                         f"rank {parts[-1]['rank']}"] = {
            "host": parts[-1]["mamba_block"]["launches"]}
    torch.cuda.empty_cache()

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_shapes": rows,
              "grouped_shapes": grouped_rows, "kmm4_sweep": sweep_rows,
              "split_sweep": split_rows,
              "kmm4_w22_w23": route_rows, "staged_shapes": staged_rows,
              "staged_sweep": sweep_staged,
              "staged_depth2": depth2_rows, "run_plan_classes": class_rows,
              "kmm2_vs_mm2": kvm_rows, "wkv_shapes": wkv_rows,
              "ssm_scan_shapes": ssm_rows, "wkv_bwd_shapes": wkv_bwd_rows,
              "ssm_scan_bwd_shapes": ssm_bwd_rows,
              "tuner": tuner,
              "smoke_max_abs_logit_diff": smoke_diff, "engines": engines,
              "launches_by_path": launches_by_path,
              "rowinv": rowinv_rows, "aten_route": aten_rows,
              "aten_serve": aten_serve, "obs": obs, "train": train,
              "mesh": mesh, "train_mesh": train_mesh,
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
    entries = kernel_entries(
        rows, grouped_rows, sweep_rows, split_rows, launches_by_path,
        staged_rows, sweep_staged, table_runs, wkv_rows, rowinv_rows,
        ssm_rows, wkv_bwd_rows, ssm_bwd_rows)
    # each rank's own launches in phase 5m (b)'s engine runs, 5m (d)'s
    # prefix-cache engines and front ends, phase 5d (b)'s train steps a
    # model (5d (d)'s step 1) and 5d (c)'s mamba layer (in the launches
    # above too): the kernels ran on every rank's block, the grouped one on
    # its experts, WKV on its heads, the scan on its channels
    keys = {"fused_gemm_mm1": "dense_mm1", "fused_gemm_kmm2": "dense_kmm2",
            "fused_gemm_grouped_mm1": "grouped_mm1",
            "rowinv_norm": "rowinv_norm", "rowinv_matmul": "rowinv_matmul",
            "wkv": "wkv", "wkv_bwd": "wkv_bwd", "ssm_scan": "ssm_scan",
            "ssm_scan_bwd": "ssm_scan_bwd"}

    def rank_launches(serve, train):
        runs = [serve["launches"]["host"]] + [
            serve[what]["launches"]["host"]
            for what in ("moe",) + tuple(w for w, _, _ in MESH_RECURRENT)
            + tuple(w for w, _, _ in MESH_PREFIX)
            + tuple(w for w, *_ in MESH_FRONTENDS)]
        runs += [both_steps(part)["host"] for part in train[:-1]]
        return runs + [train[-1]["mamba_block"]["launches"]]

    for e in entries:
        if e["name"] in keys:
            key = keys[e["name"]]
            e["mesh_launches_per_rank"] = [
                sum(run.get(key, 0) for run in rank_launches(r, t))
                for r, t in zip(mesh["ranks"], train_ranks)]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
