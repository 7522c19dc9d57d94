"""Time this checkout's dense fused GEMM against another checkout's, in
turns on one card.

    python -m repro_torch.kernels.compare --base path/to/other/checkout

Builds ``csrc/fused_gemm.cu`` of both checkouts (this one as the port
builds it, the other one whole, in one nvcc, into ``build/kernels/`` under
its own name), checks at each shape that the two libraries'
``fused_gemm_launch`` give equal outputs, and times them with CUDA events
in the order base, this, this, base, after printing how long each build
took (this checkout's in its parallel units; the other's whole, in one
nvcc).  Shapes are the dense serve-path GEMMs
of llama3.2-1b and granite-moe-3b-a800m at decode (M=4) and prefill
(M=64), dequantized to bf16, in every mode: mm1 and kmm2 at the widths the
mixed policy gives them, mm2 at w=16 and kmm4 at w=20 and w=24.  mm2 and
kmm4 against a checkout whose kernel refuses them (one from before they
were ported) are timed for this checkout alone; any other failed launch
raises.  Prints a table and the card, and writes
``chiprun_out/compare_fused_gemm.json``.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_gemm as fg

# (mode, w, K, N): llama (wq, wi, mlp.wo, lm_head), granite (wq, wk, router,
# lm_head)
SHAPES = [("mm1", 8, 2048, 2048), ("mm1", 8, 2048, 8192),
          ("mm1", 8, 8192, 2048), ("kmm2", 12, 2048, 128512),
          ("mm1", 8, 1536, 1536), ("mm1", 8, 1536, 512),
          ("kmm2", 12, 1536, 40), ("kmm2", 12, 1536, 49664),
          ("mm2", 16, 2048, 8192), ("mm2", 16, 2048, 128512),
          ("kmm4", 20, 2048, 8192), ("kmm4", 20, 2048, 128512),
          ("kmm4", 24, 2048, 8192), ("kmm4", 24, 2048, 128512)]
ROWS = (4, 64)
# Modes an older checkout's kernel may lack (ported after mm1 and kmm2).
LATER_MODES = ("mm2", "kmm4")


def _library(src: Path, tag: str):
    """The dense entry of ``src`` built whole into its own library."""
    out = build.BUILD_DIR / f"libfused_gemm-{tag}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).fused_gemm_launch
    n_ptr, n_int = fg._SIGNATURES["fused_gemm_launch"]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    return fn


def _call(fn, a, b, sx, sw, out, mode, h, z, kp) -> int:
    """One launch; the CUDA error code (0 on success)."""
    m_dim, k_dim = a.shape
    return fn(a.data_ptr(), b.data_ptr(), sx.data_ptr(), sw.data_ptr(),
              out.data_ptr(), m_dim, k_dim, b.shape[1], kp,
              fg._MODE_ID[mode], h, z, 0, fg._OUT_KIND[out.dtype],
              torch.cuda.current_stream().cuda_stream)


def _launch(fn, *args) -> None:
    err = _call(fn, *args)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the checkout to compare against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    base_src = (args.base / "src" / "repro_torch" / "kernels" / "csrc"
                / build.SOURCES["fused_gemm"])
    t0 = time.monotonic()
    this = fg._kernel("fused_gemm_launch")
    t1 = time.monotonic()
    libs = {"base": _library(base_src, "base"), "this": this}
    builds = {"this_units_s": t1 - t0, "base_whole_s": time.monotonic() - t1}
    print(f"build: this checkout {builds['this_units_s']:.1f} s "
          f"({build.UNITS['fused_gemm'][1]} units in parallel, then linked; "
          f"0 if it was built already), base {builds['base_whole_s']:.1f} s "
          f"(whole, one nvcc)", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for mode, w, k, n in SHAPES:
        for m in ROWS:
            _, h, z, carrier = fg.resolve(w, mode=mode)
            q = 2 ** (w - 1) - 1
            a = torch.randint(-q, q + 1, (m, k), generator=gen,
                              device="cuda", dtype=torch.int32).to(carrier)
            b = torch.randint(-q, q + 1, (k, n), generator=gen,
                              device="cuda", dtype=torch.int32).to(carrier)
            sx = torch.rand((m, 1), generator=gen, device="cuda") + 1e-3
            sw = torch.rand((1, n), generator=gen, device="cuda") + 1e-3
            kp = fg.padded_k(k, min(256, 1 << max(3, (k - 1).bit_length())))
            outs = {tag: torch.empty((m, n), dtype=torch.bfloat16,
                                     device="cuda") for tag in libs}
            args = (a, b, sx, sw)
            _launch(libs["this"], *args, outs["this"], mode, h, z, kp)
            tags = ["this", "this"]
            err = _call(libs["base"], *args, outs["base"], mode, h, z, kp)
            if err and mode not in LATER_MODES:
                raise RuntimeError(f"base launch failed for {mode}: CUDA "
                                   f"error {err}")
            if not err:
                torch.cuda.synchronize()
                if not torch.equal(outs["base"], outs["this"]):
                    raise SystemExit(f"{mode} {m}x{k}x{n}: outputs differ")
                tags = ["base", "this", "this", "base"]
            times = {"base": [], "this": []}
            for tag in tags:
                times[tag].append(_ms(lambda: _launch(
                    libs[tag], *args, outs[tag], mode, h, z, kp)))
            row = {"mode": mode, "w": w, "M": m, "K": k, "N": n,
                   "base_ms": times["base"], "this_ms": times["this"]}
            rows.append(row)
            base = (" ".join(f"{t:.4f}" for t in times["base"]) + " ms"
                    if times["base"] else "refuses this mode")
            print(f"{mode:4s} w={w:<2d} M={m:<3d} K={k:<5d} N={n:<6d} base "
                  f"{base} | this {times['this'][0]:.4f} "
                  f"{times['this'][1]:.4f} ms", flush=True)
    out_dir = build.BUILD_DIR.parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "compare_fused_gemm.json").write_text(
        json.dumps({"card": card, "builds": builds, "rows": rows},
                   indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
