#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also trace four decode steps

Phases, each fatal on failure (non-zero exit, no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, started together);
  3. hold each kernel to its plain PyTorch version on the card with
     ``torch.equal``, at the shapes the serve paths give it: the dense
     fused GEMM in mode mm1 (every w=8 projection of llama3.2-1b and
     granite-moe-3b-a800m) and kmm2 (lm_head and the MoE router at w=12),
     and the grouped ragged fused GEMM (granite's 40 expert GEMMs, mm1 at
     w=8 and kmm2 at w=12, at the decode and prefill capacities, with
     router-like live counts and an edge case of zero-count experts and
     full segments), raw and dequantized outputs;
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
     step; a second identical run must repeat every greedy stream; then a
     short granite serve under w12 (2 requests, 4 new tokens) must launch
     the grouped kmm2 kernel for every expert GEMM;
  6. time each kernel against its bound, its plain version and the
     library call that computes the same product where there is one (CUDA
     events, warm-up excluded), and each model's prefill and decode
     tokens/s, step ms and peak device memory.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json`` beside this script.
"""
from __future__ import annotations

import argparse
import json
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

# granite's grouped expert GEMMs: (K, N) of wi/wg and of wo, 40 experts,
# top-8 routing
GROUPED_KN = [(1536, 512), (512, 1536)]
N_EXPERTS, TOP_K = 40, 8
# (label, C, seg, segments, tokens per segment): decode at widths 1, 2, 4
# (capacity 8 per lane, S = 1), a prefill bucket of 8-32 tokens (capacity
# 8) and of 64 tokens (capacity 16, overflow drops), and an edge case
# (tokens 0: zero-count experts, full segments, counts seg - 1 and 1).
GROUPED_CASES = [("decode W=1", 8, 8, 1, 1), ("decode W=2", 16, 8, 2, 1),
                 ("decode W=4", 32, 8, 4, 1), ("prefill S=32", 8, 8, 1, 32),
                 ("prefill S=64", 16, 16, 1, 64), ("edge", 32, 8, 4, 0)]

# The serve paths: (arch, policy, requests, new tokens, identical runs,
# launches per prefill and per decode step: dense, grouped).  llama's 16
# layers have 7 w=8 projections each and w=12 lm_head; granite's 32 have
# 4 attention projections, the w=12 router, and 3 expert GEMMs (wi, wg,
# wo) as grouped launches; under w12 every one of them is kmm2.
PATHS = [
    ("llama3.2-1b", "mixed", 6, 16, 2, {"mm1": 112, "kmm2": 1}, {}),
    ("granite-moe-3b-a800m", "mixed", 6, 16, 2, {"mm1": 128, "kmm2": 33},
     {"mm1": 96}),
    ("granite-moe-3b-a800m", "w12", 2, 4, 1, {"kmm2": 161}, {"kmm2": 96}),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gemm_bound_ms(mode: str, m: int, k: int, n: int, out_bytes: int,
                  dequant: bool):
    """Least time for one fused GEMM: each input read once, the output
    written once, at the card's memory rate; or its int8 tensor-core
    operations (1 pass for mm1, 3 for kmm2) at the int8 peak."""
    carrier = 1 if mode == "mm1" else 2
    nbytes = (m * k + k * n) * carrier + m * n * out_bytes
    if dequant:
        nbytes += 4 * (m + n)
    ops = 2 * m * k * n * (1 if mode == "mm1" else 3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(torch, fg):
    """Phase 3 and the per-shape half of phase 6."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    cases = ([("mm1", 8, m, k, n) for k, n in MM1_KN + GRANITE_MM1_KN
              for m in ROWS]
             + [("kmm2", 12, m, k, n) for k, n in KMM2_KN + GRANITE_KMM2_KN
                for m in ROWS]
             + [("mm1", 8) + RAGGED, ("kmm2", 12) + RAGGED])
    for mode, w, m, k, n in cases:
        q = 2 ** (w - 1) - 1
        _, h, z, carrier = fg.resolve(w)
        a = torch.randint(-q, q + 1, (m, k), generator=gen, device=dev,
                          dtype=torch.int32).to(carrier)
        b = torch.randint(-q, q + 1, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(carrier)
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
            got = fg.fused_gemm(a, b, s_x, s_w, w=w, block_k=block_k,
                                out_dtype=out_dtype)
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
            row[f"ms_{label}"] = cuda_ms(torch, lambda: fg.fused_gemm(
                a, b, s_x, s_w, w=w, block_k=block_k, out_dtype=out_dtype))
            if label == "dequant_bf16":
                def plain():
                    return fg.fused_gemm_reference(
                        a, b, sx, sw, mode=mode, h=h, z=z, kp=kp,
                        combine_int32=False, out_dtype=torch.bfloat16)
                row["plain_ms"] = cuda_ms(torch, plain, iters=5, warmup=1)
                row["bound_ms"], row["bound_by"] = gemm_bound_ms(
                    mode, m, k, n, 2, True)
        row["bound_ms_raw"], _ = gemm_bound_ms(mode, m, k, n, 4, False)
        # torch._int_mm computes the raw mm1 product (int8 x int8 -> int32);
        # it takes only M > 16 and K, N multiples of 8.  No single library
        # call computes the kmm2 function.
        row["library_ms_raw"] = None
        if mode == "mm1" and m > 16 and k % 8 == 0 and n % 8 == 0:
            row["library_ms_raw"] = library_int_mm_ms(torch, fg, a, b)
        rows.append(row)
        log(f"  {mode} w={w} M={m:<3d} K={k:<5d} N={n:<6d} equal | "
            f"kernel {row['ms_dequant_bf16']:.4f} ms (raw "
            f"{row['ms_raw']:.4f}) | bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) | plain {row['plain_ms']:.3f} ms | "
            f"_int_mm raw {row['library_ms_raw']}")
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


def grouped_bound_ms(mode: str, live, k: int, n: int, out_bytes: int,
                     dequant: bool):
    """Least time for one ragged grouped GEMM with these live rows (E, C):
    the live rows of A and the B of every expert with a live row, each
    read once, the whole (E, C, N) output written once, at the card's
    memory rate; or the live rows' int8 tensor-core operations at the
    int8 peak."""
    e, c = live.shape
    rows = int(live.sum())
    experts = int(live.any(dim=1).sum())
    carrier = 1 if mode == "mm1" else 2
    nbytes = (rows * k + experts * k * n) * carrier + e * c * n * out_bytes
    if dequant:
        nbytes += 4 * (rows + experts * n)
    ops = 2 * rows * k * n * (1 if mode == "mm1" else 3)
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
    for mode, w in (("mm1", 8), ("kmm2", 12)):
        q = 2 ** (w - 1) - 1
        _, h, z, carrier = fg.resolve(w)
        for k, n in GROUPED_KN:
            block_k = min(256, 1 << max(3, (k - 1).bit_length()))
            kp = fg.padded_k(k, block_k)
            for label, c, seg, n_seg, tokens in GROUPED_CASES:
                e = N_EXPERTS
                a = torch.randint(-q, q + 1, (e, c, k), generator=gen,
                                  device=dev, dtype=torch.int32).to(carrier)
                b = torch.randint(-q, q + 1, (e, k, n), generator=gen,
                                  device=dev, dtype=torch.int32).to(carrier)
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
                            a, b, s_x, s_w, counts, w=w, seg=seg,
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
                    row[f"ms_{out_label}"] = cuda_ms(torch, kernel)
                    if scales:
                        row["plain_ms"] = cuda_ms(
                            torch, lambda: fg.fused_gemm_grouped_reference(
                                a, b, sx, sw, counts, seg=seg, mode=mode,
                                h=h, z=z, kp=kp, combine_int32=False,
                                out_dtype=torch.bfloat16),
                            iters=5, warmup=1)
                        row["bound_ms"], row["bound_by"] = grouped_bound_ms(
                            mode, live, k, n, 2, True)
                row["library_ms"] = None      # no single call computes it
                rows.append(row)
                log(f"  grouped {mode} w={w} {label:<13s} C={c:<3d} "
                    f"K={k:<5d} N={n:<5d} live rows {row['live_rows']:<4d} "
                    f"experts {row['live_experts']:<3d} equal | kernel "
                    f"{row['ms_dequant_bf16']:.4f} ms (raw "
                    f"{row['ms_raw']:.4f}) | bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}) | plain {row['plain_ms']:.3f} ms")
    return rows


def library_int_mm_ms(torch, fg, a, b):
    """Time of ``torch._int_mm`` on the same int8 operands (the yardstick;
    the port never calls it), after checking it computes the same product.
    cuBLASLt may refuse a row-major B; the same values column-major are the
    same inputs.  None, with the reason printed, if it takes neither."""
    want = fg.fused_gemm(a, b, w=8)
    for b_lib in (b, b.t().contiguous().t()):
        try:
            got = torch._int_mm(a, b_lib)
        except RuntimeError as exc:
            log(f"  torch._int_mm refused B strides {b_lib.stride()}: "
                f"{str(exc).splitlines()[0]}")
            continue
        if not torch.equal(got, want):
            fail(f"torch._int_mm disagrees with the kernel at "
                 f"{tuple(a.shape)} x {tuple(b.shape)}")
        return cuda_ms(torch, lambda: torch._int_mm(a, b_lib))
    return None


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


def expected_launches(fg, per_call: dict, calls: int) -> dict:
    return {mode: per_call.get(mode, 0) * calls for mode in fg.PORTED_MODES}


def serve_full(torch, np, fg, arch: str, profile: bool):
    """Phase 5 and the engine half of phase 6 for every path of ``arch``:
    one set of full-width weights, each path's runs with the launch counts
    set to 0 just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    paths = [p for p in PATHS if p[0] == arch]
    cfg = get_config(arch, quant=paths[0][1])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = lm.init_params(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {arch} full width: {n_params} parameters (fp32, "
        f"{time.monotonic() - t0:.1f} s to init on the card)")
    rng = np.random.default_rng(0)
    lens = [8, 64] + [int(x) for x in rng.integers(8, 65, size=4)]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in lens]
    temps = [0.0, 0.0, 0.0, 0.8, 0.0, 0.0]
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": arch, "parameters": n_params,
           "param_gb": sum(t.numel() * t.element_size()
                           for t in _leaves(params)) / 1e9}
    launches_by_path = {}
    for _, policy, n_req, new, n_runs, dense, grouped in paths:
        pcfg = get_config(arch, quant=policy)
        eng = Engine(pcfg, params, max_seq=256, batch_size=4, device="cuda")
        runs = []
        for _ in range(n_runs):
            reqs = [Request(prompt=p, max_new_tokens=new, temperature=t)
                    for p, t in zip(prompts[:n_req], temps)]
            fg.reset_launches()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            stats = eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            runs.append((reqs, stats, dict(fg.launches),
                         dict(fg.grouped_launches), wall))
        reqs, stats, got_dense, got_grouped, wall = runs[0]
        calls = len(reqs) + stats.decode_steps   # prefills + decode steps
        want_dense = expected_launches(fg, dense, calls)
        want_grouped = expected_launches(fg, grouped, calls)
        log(f"  {arch} {policy} run 1: {stats.generated_tokens} tokens, "
            f"{stats.decode_steps} decode steps, launches dense {got_dense} "
            f"grouped {got_grouped} (expected {want_dense}, {want_grouped})")
        for kind, per_call, got in (("dense", dense, got_dense),
                                    ("grouped", grouped, got_grouped)):
            if any(got[mode] <= 0 for mode in per_call):
                fail(f"{arch} {policy}: the serve path did not launch every "
                     f"{kind} kernel: {got}")
        if got_dense != want_dense or got_grouped != want_grouped:
            fail(f"{arch} {policy}: a quantized GEMM bypassed the kernels: "
                 f"dense {got_dense}, grouped {got_grouped}")
        for r in reqs:
            if len(r.generated) != new or not all(
                    0 <= t < cfg.vocab_size for t in r.generated):
                fail(f"{arch} {policy}: bad token stream {r.generated}")
        if n_runs > 1:
            for r1, r2, t in zip(reqs, runs[1][0], temps):
                if t == 0.0 and r1.generated != r2.generated:
                    fail(f"{arch} {policy}: greedy output changed on an "
                         f"identical second run")
        launches_by_path[f"{arch} {policy}"] = {"dense": got_dense,
                                                "grouped": got_grouped}
        if policy != "mixed":
            out[f"{policy}_run"] = {"calls": calls, "wall_s": wall,
                                    "launches": launches_by_path[
                                        f"{arch} {policy}"]}
            continue
        # full-width logits: finite, padded vocab masked
        with torch.inference_mode():
            cache = lm.init_cache(pcfg, 1, 256, device="cuda")
            logits, _, _ = lm.prefill(eng.params, pcfg, torch.tensor(
                [prompts[0]], device="cuda"), cache)
        if tuple(logits.shape) != (1, cfg.padded_vocab) or not \
                torch.isfinite(logits[:, :cfg.vocab_size].float()).all():
            fail(f"{arch}: full-width logits bad: {tuple(logits.shape)}")
        if not (logits[:, cfg.vocab_size:].float() < -1e29).all():
            fail(f"{arch}: padded vocab columns are not masked")
        stats2, wall2 = runs[1][1], runs[1][4]
        prompt_tokens = sum(lens)
        decode_tokens = stats2.generated_tokens - len(reqs)
        out.update({
            "requests": len(reqs), "prompt_tokens": prompt_tokens,
            "generated_tokens": stats2.generated_tokens,
            "decode_steps": stats2.decode_steps,
            "prefill_s": stats2.prefill_s, "decode_s": stats2.decode_s,
            "prefill_tokens_per_s": prompt_tokens / stats2.prefill_s,
            "decode_tokens_per_s": decode_tokens / stats2.decode_s,
            "decode_step_ms": stats2.decode_s / stats2.decode_steps * 1e3,
            "prefill_ms_per_request": stats2.prefill_s / len(reqs) * 1e3,
            "wall_s_run1": wall, "wall_s_run2": wall2,
            "launches_run1": launches_by_path[f"{arch} {policy}"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        })
        log(f"  {arch} run 2 (warm): prefill "
            f"{out['prefill_tokens_per_s']:.1f} tok/s, decode "
            f"{out['decode_tokens_per_s']:.1f} tok/s "
            f"({out['decode_step_ms']:.2f} ms/step at <= 4 lanes), wall "
            f"{wall2:.2f} s, peak {out['peak_mem_gb']:.2f} GB; greedy "
            f"streams repeat")
        if profile:
            out["profile"] = profile_decode(torch, eng, prompts,
                                            out["decode_step_ms"])
    return out, launches_by_path


def profile_decode(torch, eng, prompts, step_ms: float):
    """Device time by kernel over decode steps only (torch.profiler): four
    requests are admitted and prefilled first, then ``n`` engine steps at 4
    live lanes are traced.  Only GPU kernel events are summed (the
    profiler also lists each ATen op with its kernels' time).  The device's
    idle share is 1 - busy / ``step_ms``, the un-profiled decode step."""
    from repro_torch.serve.engine import Request
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 4
    for p in prompts[:4]:
        eng.submit(Request(prompt=p, max_new_tokens=n + 2))
    eng.step()                          # admit + prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / n
    while eng.num_active:
        eng.step()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append({"name": ev.key[:120], "ms_per_step": dev_us / 1e3 / n,
                     "per_step": ev.count / n})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    gemm = {f"{kind}{mode}": sum(
        r["ms_per_step"] for r in rows
        if f"fused_gemm_kernel<{acc}," in r["name"]
        and r["name"].split(">")[0].endswith(flag))
        for mode, acc in (("mm1", 1), ("kmm2", 3))
        for kind, flag in (("", "false"), ("grouped_", "true"))}
    out = {"steps": n, "lanes": 4, "device_busy_ms_per_step": busy,
           "fused_gemm_ms_per_step": gemm,
           "kernels_per_step": sum(r["per_step"] for r in rows),
           "profiled_step_wall_ms": wall_ms, "step_ms": step_ms,
           "idle_share": 1 - busy / step_ms, "by_kernel": rows[:30]}
    log(f"  profile, {n} decode steps at 4 lanes: device busy {busy:.2f} "
        f"ms/step (fused_gemm " + ", ".join(
            f"{k} {v:.2f}" for k, v in gemm.items()) + f"), "
        f"{out['kernels_per_step']:.0f} kernels/step; idle share "
        f"{out['idle_share']:.2f} of the {step_ms:.2f} ms step")
    for r in rows[:10]:
        log(f"    {r['ms_per_step']:8.3f} ms/step  x{r['per_step']:<6.0f} "
            f"{r['name'][:90]}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernel_entries(rows, grouped_rows, launches_by_path):
    """One entry per kernel for the result line; ``launches`` sums the
    first run of every serve path (``launches_by_path`` has each).

    Dense mm1 at the prefill shape of llama's wi/wg (M=64, where
    torch._int_mm, which needs M > 16, can run on the same inputs); dense
    kmm2 at decode on 4 lanes (llama's lm_head); the grouped kernel at
    granite's decode on 4 lanes (wi/wg, C=32).  No library call computes
    the kmm2 function or the ragged grouped product."""
    def total(kind, mode):
        return sum(p[kind][mode] for p in launches_by_path.values())

    def entry(name, kind, mode, row, all_rows, shape, library_ms):
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_gemm.cu",
            "replaces": ("src/repro/kernels/fused_gemm.py:119"
                         if kind == "dense" else
                         "src/repro/kernels/fused_gemm.py:437"),
            "launches": total(kind, mode),
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
        }

    out = []
    pick = {"mm1": (64, 2048, 8192), "kmm2": (4, 2048, 128512)}
    for mode, (m, k, n) in pick.items():
        row = next(r for r in rows if r["mode"] == mode
                   and (r["M"], r["K"], r["N"]) == (m, k, n))
        out.append(entry(f"fused_gemm_{mode}", "dense", mode, row, rows,
                         f"M={m} K={k} N={n}, dequant to bf16",
                         row["library_ms_raw"]))
    for mode in ("mm1", "kmm2"):
        row = next(r for r in grouped_rows if r["mode"] == mode
                   and r["case"] == "decode W=4" and r["K"] == 1536)
        out.append(entry(
            f"fused_gemm_grouped_{mode}", "grouped", mode, row, grouped_rows,
            f"E={row['E']} C={row['C']} K={row['K']} N={row['N']}, "
            f"{row['live_rows']} live rows in {row['live_experts']} "
            f"experts, dequant to bf16", None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a short serve run with torch.profiler")
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

    log("[3] kernels vs plain versions (torch.equal) at the paths' shapes")
    rows = kernel_checks(torch, fg)
    grouped_rows = grouped_checks(torch, fg)

    archs = list(dict.fromkeys(p[0] for p in PATHS))
    log("[4] smoke-size models: card vs CPU")
    smoke_diff = {arch: smoke_parity(torch, np, arch) for arch in archs}

    engines, launches_by_path = {}, {}
    for arch in archs:
        log(f"[5] serve full-width {arch} ("
            + ", then ".join(p[1] for p in PATHS if p[0] == arch)
            + " policy)")
        engines[arch], by_path = serve_full(torch, np, fg, arch,
                                            args.profile)
        launches_by_path.update(by_path)
        torch.cuda.empty_cache()

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_shapes": rows,
              "grouped_shapes": grouped_rows,
              "smoke_max_abs_logit_diff": smoke_diff, "engines": engines,
              "launches_by_path": launches_by_path,
              "seconds": time.monotonic() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[6] details in chiprun_out/chip_smoke.json; "
        f"{report['seconds']:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_entries(rows, grouped_rows,
                                                launches_by_path)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
