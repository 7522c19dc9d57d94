#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole check, one card
    python3 chip_smoke.py --profile   # also trace four decode steps

Phases, each fatal on failure (non-zero exit, no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per build unit of every source, started together);
  3. hold each kernel to its plain PyTorch version on the card with
     ``torch.equal``, at the shapes the serve paths give it: the dense
     fused GEMM in mode mm1 (every w=8 projection of llama3.2-1b and
     granite-moe-3b-a800m), kmm2 (lm_head and the MoE router at w=12), and
     mm2 and kmm4 (every one of those GEMMs at w=16, and at w=20 and w=24,
     kmm4's two digit layouts), and the grouped ragged fused GEMM
     (granite's 40 expert GEMMs in every mode and layout, at the decode and
     prefill capacities, with router-like live counts and an edge case of
     zero-count experts and full segments), raw and dequantized outputs;
     then kmm4 at every width 17-26 (both layouts), with +-2^25 operands at
     w=26 and, at w=24, rows whose int32 sums wrap as the reference's do;
     and the two kmm4 layouts timed side by side from decode to a
     compute-bound prefill (M = 4 to 2048);
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
     twice, greedy streams repeating) and w20 (kmm4, s8 pre-adders), and
     granite under w12 (kmm2), w16 (mm2), w20 (kmm4, s8 pre-adders) and
     w24 (kmm4, split pre-adders), 2 requests of 4 new tokens each, every
     dense and grouped GEMM of a step launching that width's mode and no
     other;
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
# Under w16 (mm2), w20 and w24 (kmm4) every one of those GEMMs runs at that
# width.  kmm4 is two kernel instances a entry: s8 pre-adders through w=22
# (h <= 11) and split pre-adders from w=23; w20 and w24 hold one each.  The
# kmm4 width sweep covers both and the +-2^(w-1) edge.
WIDE_MODES = [("mm2", 16), ("kmm4", 20), ("kmm4", 24)]
KMM4_WIDTHS = [17, 20, 22, 23, 24, 25, 26]
SWEEP_SHAPES = [(4, 2048, 8192), (64, 1536, 512), RAGGED]
# The two kmm4 layouts side by side (w=22 s8, w=23 split) at llama's wi/wg
# (K, N) from decode to a compute-bound prefill.
ROUTE_ROWS = [4, 64, 512, 2048]
ROUTE_KN = (2048, 8192)

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
# wo) as grouped launches; under one width every GEMM runs in that width's
# mode (w12 kmm2, w16 mm2, w20 kmm4 on s8 pre-adders, w24 kmm4 on split
# ones), so each path's kmm4 launches all go to one of its two instances.
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


# Operand bytes of each mode's carrier (int8, int16 through w=16, int32).
CARRIER_BYTES = {"mm1": 1, "kmm2": 2, "mm2": 2, "kmm4": 4}


def instance(fg, mode: str, w: int) -> str:
    """The kernel instance that ``mode`` launches at width ``w``: kmm4 is
    two, on s8 pre-adders through h = 11 (w <= 22) and on split ones
    above, as ``fused_gemm.cu`` picks them."""
    if mode == "kmm4" and fg.resolve(w, mode=mode)[1] >= 12:
        return "kmm4_split"
    return mode


def passes(mode: str, w: int) -> int:
    """s8 tensor-core products per output element and K step: 1, 3, 4, or
    9 for kmm4 — 12 from w=23, where the three nested pre-adder products
    do not fit s8 and each costs its leaves' cross products."""
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
            row[f"ms_{label}"] = cuda_ms(torch, lambda: fg.fused_gemm(
                a, b, s_x, s_w, w=w, mode=mode, block_k=block_k,
                out_dtype=out_dtype))
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
        # it takes only M > 16 and K, N multiples of 8.  No single library
        # call computes the kmm2, mm2 or kmm4 function.
        row["library_ms_raw"] = None
        if mode == "mm1" and m > 16 and k % 8 == 0 and n % 8 == 0:
            row["library_ms_raw"] = library_int_mm_ms(torch, fg, a, b)
        rows.append(row)
        log(f"  {mode:4s} w={w} M={m:<3d} K={k:<5d} N={n:<6d} equal | "
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
                    row[f"ms_{out_label}"] = cuda_ms(torch, kernel)
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
    """Phase 3 for every kmm4 width (both digit routes): dense kernel ==
    plain version, raw and bf16, at a few shapes, timed at llama's wi/wg
    decode shape; then the +-2^(w-1) operands at w=26 (the quantizer's
    one-past-qmax values) and, at w=24, rows of +-2^22 over K=8192, whose
    int32 row sums wrap in the reference and must wrap the same way here."""
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
                row[f"ms_{label}"] = cuda_ms(torch, kernel)
        rows.append(row)
        return got

    for w in KMM4_WIDTHS:
        for m, k, n in SWEEP_SHAPES:
            a, b = operands(torch, fg, gen, "kmm4", w, (m, k), (k, n))
            check("sweep", w, a, b, min(256, 1 << max(3, (k - 1).bit_length())),
                  timed=(m, k, n) == SWEEP_SHAPES[0])
        r = rows[-len(SWEEP_SHAPES)]
        log(f"  kmm4 w={w} ({'split' if w >= 23 else 's8'} pre-adders): "
            f"equal at {len(SWEEP_SHAPES)} shapes | {r['M']}x{r['K']}x"
            f"{r['N']} {r['ms_dequant_bf16']:.4f} ms (raw {r['ms_raw']:.4f})")
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


def route_timing(torch, fg):
    """The two kmm4 instances side by side on the same shapes: w=22 (s8
    pre-adders, 9 MMAs a 16-deep step) and w=23 (split pre-adders, 12
    MMAs), from decode to a compute-bound prefill, dequant to bf16; each
    held to its plain version before it is timed."""
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
            inst = instance(fg, "kmm4", w)
            row[f"{inst}_w"] = w
            row[f"{inst}_ms"] = cuda_ms(torch, kernel)
            row[f"{inst}_bound_ms"], row[f"{inst}_bound_by"] = \
                gemm_bound_ms("kmm4", w, m, k, n, 2, True)
        rows.append(row)
        log(f"  kmm4 layouts at M={m:<4d} K={k} N={n}: s8 (w=22) "
            f"{row['kmm4_ms']:.4f} ms, split (w=23) "
            f"{row['kmm4_split_ms']:.4f} ms; bounds "
            f"{row['kmm4_bound_ms']:.4f} / {row['kmm4_split_bound_ms']:.4f}"
            f" ms ({row['kmm4_bound_by']} / {row['kmm4_split_bound_by']})")
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
    return {mode: per_call.get(mode, 0) * calls for mode in fg.MODES}


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


def serve_full(torch, np, fg, arch: str, profile: bool):
    """Phase 5 and the engine half of phase 6 for every path of ``arch``:
    one set of full-width weights, each path's runs with the launch counts
    set to 0 just before and read just after."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    paths = [p for p in PATHS if p[0] == arch]
    cfg = path_config(arch, paths[0][1])
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
        pcfg = path_config(arch, policy)
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
            stats_w, wall_w = runs[-1][1], runs[-1][4]
            out[f"{policy}_run"] = {
                "calls": calls, "wall_s": wall, "wall_s_last": wall_w,
                "decode_steps": stats_w.decode_steps,
                "decode_step_ms": stats_w.decode_s / stats_w.decode_steps
                * 1e3,
                "prefill_ms_per_request": stats_w.prefill_s / len(reqs) * 1e3,
                "launches": launches_by_path[f"{arch} {policy}"]}
            log(f"  {arch} {policy} run {len(runs)}: "
                f"{out[f'{policy}_run']['decode_step_ms']:.2f} ms a decode "
                f"step, {out[f'{policy}_run']['prefill_ms_per_request']:.1f}"
                f" ms a prefill" + ("; greedy streams repeat"
                                    if n_runs > 1 else ""))
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
    # kernel names carry the digit layout: 1 mm1, 2 kmm2 (the mixed path)
    gemm = {f"{kind}{mode}": sum(
        r["ms_per_step"] for r in rows
        if f"fused_gemm_kernel<{layout}," in r["name"]
        and r["name"].split(">")[0].endswith(flag))
        for mode, layout in (("mm1", 1), ("kmm2", 2))
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


def kernel_entries(fg, rows, grouped_rows, sweep_rows, launches_by_path):
    """One entry per kernel instance (dense and grouped; mm1, kmm2, mm2 and
    kmm4's two layouts) for the result line.  ``launches`` sums the first
    run of every serve path (``launches_by_path`` has each); a path runs
    every GEMM at one width, so its kmm4 launches all belong to the
    instance that width picks.

    Dense mm1 at the prefill shape of llama's wi/wg (M=64, where
    torch._int_mm, which needs M > 16, can run on the same inputs); dense
    kmm2, mm2 (w=16) and kmm4 (w=20 s8, w=24 split) at decode on 4 lanes
    (llama's lm_head); the grouped kernel at granite's decode on 4 lanes
    (wi/wg, C=32).  No library call computes the kmm2, mm2 or kmm4
    function or the ragged grouped product."""
    def total(kind, inst):
        n = 0
        for key, counts in launches_by_path.items():
            got = counts[kind][inst.split("_")[0]]
            if got and inst.startswith("kmm4") and instance(
                    fg, "kmm4", int(key.split()[-1][1:])) != inst:
                continue
            n += got
        return n

    def entry(name, kind, inst, row, all_rows, shape, library_ms):
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_gemm.cu",
            "replaces": ("src/repro/kernels/fused_gemm.py:119"
                         if kind == "dense" else
                         "src/repro/kernels/fused_gemm.py:437"),
            "launches": total(kind, inst),
            "max_abs_err": max(max(r["max_abs_err_dequant_bf16"],
                                   r["max_abs_err_raw"])
                               for r in all_rows
                               if instance(fg, r["mode"], r["w"]) == inst),
            "ms": row["ms_dequant_bf16"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": library_ms,
            "shape": shape,
            "ms_raw": row["ms_raw"],
        }

    out = []
    pick = {"mm1": (64, 2048, 8192), "kmm2": (4, 2048, 128512),
            "mm2": (4, 2048, 128512), "kmm4": (4, 2048, 128512),
            "kmm4_split": (4, 2048, 128512)}
    for inst, (m, k, n) in pick.items():
        row = next(r for r in rows
                   if instance(fg, r["mode"], r["w"]) == inst
                   and (r["M"], r["K"], r["N"]) == (m, k, n))
        out.append(entry(f"fused_gemm_{inst}", "dense", inst, row,
                         rows + sweep_rows,
                         f"w={row['w']} M={m} K={k} N={n}, dequant to bf16",
                         row["library_ms_raw"]))
    for inst in pick:
        row = next(r for r in grouped_rows
                   if instance(fg, r["mode"], r["w"]) == inst
                   and r["case"] == "decode W=4" and r["K"] == 1536)
        out.append(entry(
            f"fused_gemm_grouped_{inst}", "grouped", inst, row, grouped_rows,
            f"w={row['w']} E={row['E']} C={row['C']} K={row['K']} "
            f"N={row['N']}, "
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
    sweep_rows = width_sweep(torch, fg)
    route_rows = route_timing(torch, fg)

    archs = list(dict.fromkeys(p[0] for p in PATHS))
    log("[4] smoke-size models: card vs CPU")
    smoke_diff = {arch: smoke_parity(torch, np, arch) for arch in archs}

    engines, launches_by_path = {}, {}
    for arch in archs:
        log(f"[5] serve full-width {arch} ("
            + ", then ".join(p[1] for p in PATHS if p[0] == arch)
            + " policies)")
        engines[arch], by_path = serve_full(torch, np, fg, arch,
                                            args.profile)
        launches_by_path.update(by_path)
        torch.cuda.empty_cache()

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_shapes": rows,
              "grouped_shapes": grouped_rows, "kmm4_sweep": sweep_rows,
              "kmm4_layouts": route_rows,
              "smoke_max_abs_logit_diff": smoke_diff, "engines": engines,
              "launches_by_path": launches_by_path,
              "seconds": time.monotonic() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[6] details in chiprun_out/chip_smoke.json; "
        f"{report['seconds']:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_entries(
        fg, rows, grouped_rows, sweep_rows, launches_by_path)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
