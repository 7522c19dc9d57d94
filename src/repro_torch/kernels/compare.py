"""Time this checkout's fused GEMM, staged and WKV kernels against another
checkout's, in turns on one card.

    python -m repro_torch.kernels.compare --base path/to/other/checkout \
        [--kernels fused|staged|wkv|all]

Builds the other checkout's fused GEMM sources whole, one nvcc each, into
``build/kernels/`` under their own names, and calls their C entry points:
``csrc/fused_gemm.cu``, where it has one (checkouts before kmm4 moved to
``fused_split.cu``), through ``fused_gemm_launch`` and
``fused_gemm_grouped_launch`` with the signatures they have had since the
grouped entry came in (5 pointers and 9 ints; 6 and 12), mode ids 1-4;
``csrc/fused_mm1.cu`` for mode mm1 through ``fused_mm1_launch`` /
``fused_mm1_grouped_launch`` (7 pointers and 9 ints; 8 and 12); and
``csrc/fused_split.cu`` for kmm2 and mm2, and for kmm4 where it has no
``fused_gemm.cu``, through ``fused_split_launch`` /
``fused_split_grouped_launch`` (7 and 14; 8 and 17), on this checkout's
split-K plans and workspace.  This checkout runs through its wrappers
(``fused_gemm.fused_gemm`` / ``fused_gemm_grouped``), so mode mm1 runs on
``csrc/fused_mm1.cu`` and kmm2, mm2 and kmm4 on ``csrc/fused_split.cu``.
At each shape
it checks that both give equal outputs, then times them in the order base,
this, this, base, and ``torch._int_mm`` on the same int8 operands beside
mm1 (A zero-padded to 32 rows where M <= 16, which it refuses).  Every
time is device time: the calls queue behind a device sleep that covers
their host work (``torch.cuda._sleep``), so the events measure the
kernels, not the wrappers.

The staged kernels (``--kernels staged`` or ``all``): the base's
``csrc/staged_gemm.cu``, where it has one, built whole, through
``staged_gemm_launch`` (5 pointers and 7 ints; layout ids 1 mm1, 2 kmm2
on s8 pre-adders, 3 kmm2 split, 4 mm2, on row-major planes; checkouts
after mm1 and kmm2 moved to ``staged_pipe.cu`` keep only 4), against this
checkout's wrappers (``mm1_gemm``, ``kmm2_gemm_planes``,
``mm2_gemm_planes``, all on ``csrc/staged_pipe.cu``) on the same planes
with B row-major and K-major; outputs equal, then base, this, this, base
(each "this" both layouts), ``torch._int_mm`` beside mm1 (B row-major and
column-major).  A layout the base refuses is timed for this checkout
alone.  Shapes (STAGED): mm1 at llama's wi and wd at M 4, 64 and 2048,
its lm_head and granite's expert GEMMs at M 8 and 32; kmm2 at w=12 on
int8 planes at llama's and granite's lm_head, the router and wi; on the
int16 branch planes of w=20 (s8 route) and w=24 (split route) at llama's
lm_head, wi, wq and wd; mm2 at w=16 at llama's lm_head and wi at M 4 and
64, and wi at M=2048.

The WKV kernel (``--kernels wkv`` or ``all``): the base's ``csrc/wkv.cu``,
built whole, through ``wkv_launch`` (8 pointers and 9 ints), against this
checkout's ``wkv_gemm.wkv_stateful`` / ``wkv_apply`` on the same inputs,
outputs within 1e-5 of each other (the kernels sum in different orders),
then base, this, this, base, at the three shapes ``chip_smoke.py`` times
(WKV): decode on 4 lanes x 40 heads from a random state, prefill of 1 x 40
heads over 64 steps, ``wkv_apply`` at (160, 256, 64).

Shapes: every dense mm1 GEMM of llama3.2-1b, granite-moe-3b-a800m and
rwkv6-3b at decode (M=4) and prefill (M=64), llama's wi and wd also at
M=256 and 2048, an unaligned decode shape (4x2050x8200); in the split
modes (kmm2 at w=12, mm2 at w=16, kmm4 at w=20 and 24) llama's, granite's
and rwkv's lm_head, llama's wi and granite's router at M=4 and 64, and
wi with M=2048; granite's grouped expert GEMMs in every mode (40
experts, decode capacities 8/16/32 and the prefill bucket of 16,
router-like live counts).  Split modes against a checkout
whose kernel refuses them are timed for this checkout alone; any other
failed launch raises.  Prints a table and the card, and writes
``chiprun_out/compare_fused_gemm.json`` (with ``--kernels staged`` or
``wkv`` alone, ``compare_staged.json`` or ``compare_wkv.json``).  Needs a
GPU.
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
from repro_torch.kernels import (kmm_gemm, mm1_gemm, mm1_plan, mm2_gemm,
                                 ops, wkv_gemm)

# (mode, w, M, K, N)
MM1_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
          (1536, 1536), (1536, 512), (2560, 2560), (2560, 8960),
          (8960, 2560)]
DENSE = ([("mm1", 8, m, k, n) for k, n in MM1_KN for m in (4, 64)]
         + [("mm1", 8, m, k, n) for k, n in ((2048, 8192), (8192, 2048))
            for m in (256, 2048)]
         + [("mm1", 8, 4, 2050, 8200)]
         + [(mode, w, m, k, n)
            for mode, w in (("kmm2", 12), ("mm2", 16), ("kmm4", 20),
                            ("kmm4", 24))
            for k, n in ((2048, 128512), (2048, 8192), (1536, 49664),
                         (2560, 65536), (1536, 40))
            for m in (4, 64)]
         + [(mode, w, 2048, 2048, 8192) for mode, w in (("kmm2", 12),
                                                         ("mm2", 16),
                                                         ("kmm4", 20),
                                                         ("kmm4", 24))])
# (mode, w, label, E, C, seg, segments, K, N): granite's grouped expert
# GEMMs
GROUPED = [(mode, w, label, 40, c, seg, n_seg, k, n)
           for mode, w in (("mm1", 8), ("kmm2", 12), ("mm2", 16),
                           ("kmm4", 20), ("kmm4", 24))
           for label, c, seg, n_seg in (("decode W=1", 8, 8, 1),
                                        ("decode W=2", 16, 8, 2),
                                        ("decode W=4", 32, 8, 4),
                                        ("prefill S=64", 16, 16, 1))
           for k, n in ((1536, 512), (512, 1536))]
TOP_K = 8
# Modes an older checkout's kernel may lack (ported after mm1 and kmm2).
LATER_MODES = ("mm2", "kmm4")
# The base's C entry points by source: (pointers, ints), then the stream.
BASE_SIGNATURES = {
    "fused_gemm.cu": {"fused_gemm_launch": (5, 9),
                      "fused_gemm_grouped_launch": (6, 12)},
    "fused_mm1.cu": {"fused_mm1_launch": (7, 9),
                     "fused_mm1_grouped_launch": (8, 12)},
    "fused_split.cu": {"fused_split_launch": (7, 14),
                       "fused_split_grouped_launch": (8, 17)},
    "staged_gemm.cu": {"staged_gemm_launch": (5, 7)},
    "wkv.cu": {"wkv_launch": (8, 9)}}
ORDER = ("base", "this", "this", "base")
# The staged kernels: (kernel, w, M, K, N); kmm2 at w <= 14 on int8
# centered planes, above on the int16 planes of the depth-2 middle branch
# (the s8 route at w=20, the split route at w=24).
STAGED = ([("mm1_gemm", 8, m, k, n)
           for k, n in ((2048, 8192), (8192, 2048)) for m in (4, 64, 2048)]
          + [("mm1_gemm", 8, 4, 2048, 128512)]
          + [("mm1_gemm", 8, m, k, n) for k, n in ((1536, 512), (512, 1536))
             for m in (8, 32)]
          + [("kmm2_gemm_planes", 12, m, k, n)
             for k, n in ((2048, 128512), (2048, 8192)) for m in (4, 64)]
          + [("kmm2_gemm_planes", 12, 2048, 2048, 8192),
             ("kmm2_gemm_planes", 12, 4, 1536, 49664),
             ("kmm2_gemm_planes", 12, 4, 1536, 40)]
          + [("kmm2_gemm_planes", w, 4, k, n) for w in (20, 24)
             for k, n in ((2048, 128512), (2048, 8192), (2048, 2048),
                          (8192, 2048))]
          + [("mm2_gemm_planes", 16, m, k, n)
             for k, n in ((2048, 128512), (2048, 8192)) for m in (4, 64)]
          + [("mm2_gemm_planes", 16, 2048, 2048, 8192)])
# staged_gemm.cu's layout ids
STAGED_LAYOUT = {"mm1": 1, "kmm2": 2, "kmm2_split": 3, "mm2": 4}
# The WKV shapes: (label, B or BH, S, H, D, entry).
WKV = [("decode W=4", 4, 1, 40, 64, "stateful"),
       ("prefill S=64", 1, 64, 40, 64, "stateful"),
       ("apply", 160, 256, 1, 64, "apply")]
WKV_TOL = 1e-5


def _libraries(csrc: Path, tag: str):
    """The C entry points of the base's sources (each of BASE_SIGNATURES'
    that it has), each built whole into its own library, the nvcc
    processes started together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in BASE_SIGNATURES:
        if not (csrc / src).exists():
            continue
        out = build.BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"
        jobs.append((src, out, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(csrc / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for src, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the base's {src}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for name, (n_ptr, n_int) in BASE_SIGNATURES[src].items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fns[name] = fn
    return fns


def _base_call(fns, a, b, sx, sw, counts, seg, out, mode, h, z, kp) -> int:
    """One launch of the base kernel; the CUDA error code (0 on success)."""
    stream = torch.cuda.current_stream().cuda_stream
    # a base with fused_gemm.cu runs kmm4 there
    old_kmm4 = mode == "kmm4" and "fused_gemm_launch" in fns
    if mode in mm1_plan.SPLIT_ACCS and "fused_split_launch" in fns \
            and not old_kmm4:
        return fg._launch_split(a, b, sx, sw, counts, out, seg, stream,
                                mode=mode, h=h, z=z, kp=kp,
                                combine_int32=False, kernel=fns.__getitem__)
    if mode == "mm1" and "fused_mm1_launch" in fns:
        return fg._launch_mm1(a, b, sx, sw, counts, out, seg, stream,
                              kernel=fns.__getitem__)
    tail = (fg._MODE_ID[mode], h, z, 0, fg._OUT_KIND[out.dtype], stream)
    if a.dim() == 3:
        return fns["fused_gemm_grouped_launch"](
            a.data_ptr(), b.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            counts.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
            a.shape[2], b.shape[2], kp, seg, counts.shape[1], *tail)
    return fns["fused_gemm_launch"](
        a.data_ptr(), b.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), a.shape[0], a.shape[1], b.shape[1], kp, *tail)


def _events_ms(fn, iters: int, lead_ms: float) -> float:
    torch.cuda.synchronize()
    if lead_ms > 0:
        torch.cuda._sleep(int(lead_ms * 2e6))   # at most 2 GHz of clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn``: warm up, measure its host time back to
    back, then time ``iters`` calls queued behind a device sleep twice that
    long, so they run back to back on the device."""
    for _ in range(3):
        fn()
    host = _events_ms(fn, iters, 0.0)
    return _events_ms(fn, iters, 2 * iters * host + 1)


def _int_mm_ms(a, b, b_layout: str = "col"):
    """torch._int_mm on the same int8 operands, B as it is ("row") or laid
    out column-major ("col", which cuBLASLt takes); A zero-padded to 32
    rows where M <= 16, which it refuses.  None where K or N is not a
    multiple of 8 or it refuses the layout."""
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        return None
    if m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, k))])
    if b_layout == "col":
        b = b.t().contiguous().t()
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        return None
    return device_ms(lambda: torch._int_mm(a, b))


def _routed_counts(gen, n_exp, seg, n_seg, tokens):
    """(E, n_seg) live rows: ``tokens`` tokens a segment each pick TOP_K
    distinct experts at random; each expert keeps at most ``seg``."""
    counts = torch.zeros((n_exp, n_seg), dtype=torch.int64)
    for s in range(n_seg):
        picks = torch.stack([torch.randperm(n_exp, generator=gen)[:TOP_K]
                             for _ in range(tokens)])
        counts[:, s] = torch.bincount(picks.reshape(-1),
                                      minlength=n_exp).clamp(max=seg)
    return counts.to(torch.int32)


def _rand(gen, w, shape, carrier):
    q = 2 ** (w - 1) - 1
    return torch.randint(-q, q + 1, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(carrier)


def _compare(base, what, mode, a, b, sx, sw, counts, seg, h, z, kp,
             this_fn, out_shape):
    """Equal outputs, then base/this in turns; the row's times."""
    out = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
    got = this_fn()
    err = _base_call(base, a, b, sx, sw, counts, seg, out, mode, h, z, kp)
    if err and mode not in LATER_MODES:
        raise RuntimeError(f"{what}: base launch failed: CUDA error {err}")
    times = {"base": [], "this": []}
    order = ("this", "this")
    if not err:
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise SystemExit(f"{what}: outputs differ")
        order = ORDER
    for tag in order:
        fn = this_fn if tag == "this" else (lambda: _base_call(
            base, a, b, sx, sw, counts, seg, out, mode, h, z, kp))
        times[tag].append(device_ms(fn))
    return times


def _staged_planes(gen, kernel, w, m, k, n):
    """(planes, h, layout) of one STAGED case: int8 codes for mm1;
    centered int8 planes at h = ceil(w/2) for mm2 and for kmm2 at w <= 14;
    the int16 planes of the depth-2 middle branch (A1 + A0bar) above."""
    a = _rand(gen, w, (m, k), torch.int32)
    b = _rand(gen, w, (k, n), torch.int32)
    if kernel == "mm1_gemm":
        return (a.to(torch.int8), b.to(torch.int8)), 0, "mm1"
    h = -(-w // 2)
    if kernel == "mm2_gemm_planes" or w <= 14:
        planes = ops._planes(a, h)[:2] + ops._planes(b, h)[:2]
        return planes, h, ("mm2" if kernel == "mm2_gemm_planes" else
                           "kmm2")
    z = 1 << (h - 1)
    h2 = -(-(h + 1) // 2)
    m2 = (1 << h2) - 1
    av = (a >> h) + ((a & ((1 << h) - 1)) - z)
    bv = (b >> h) + ((b & ((1 << h) - 1)) - z)
    planes = tuple(t.to(torch.int16) for t in (av >> h2, av & m2, bv >> h2,
                                               bv & m2))
    return planes, h2, ("kmm2_split" if kmm_gemm.route(torch.int16, h2)
                        == "split" else "kmm2")


def _staged_base(fns, planes, h, layout, out) -> int:
    """One launch of the base's staged_gemm.cu on row-major planes (fp32
    combine); the CUDA error code (``cudaErrorInvalidValue`` without
    one)."""
    if "staged_gemm_launch" not in fns:
        return 1
    a1, b1 = planes[0], planes[len(planes) // 2]
    a0, b0 = (planes[1], planes[3]) if len(planes) == 4 else (None, None)
    m, k = a1.shape
    return fns["staged_gemm_launch"](
        a1.data_ptr(), fg._ptr(a0), b1.data_ptr(), fg._ptr(b0),
        out.data_ptr(), m, k, b1.shape[1], STAGED_LAYOUT[layout],
        a1.element_size(), h, 0, torch.cuda.current_stream().cuda_stream)


def compare_staged(base, gen):
    """The STAGED rows: outputs equal (base, this on B row-major and
    K-major), then base, this, this, base in device time."""
    rows = []
    for kernel, w, m, k, n in STAGED:
        planes, h, layout = _staged_planes(gen, kernel, w, m, k, n)
        half = len(planes) // 2
        k_major = planes[:half] + tuple(t.t().contiguous().t()
                                        for t in planes[half:])
        wrapper = {"mm1_gemm": lambda *p: mm1_gemm.mm1_gemm(*p),
                   "kmm2_gemm_planes": lambda *p: kmm_gemm.kmm2_gemm_planes(
                       *p, h=h),
                   "mm2_gemm_planes": lambda *p: mm2_gemm.mm2_gemm_planes(
                       *p, h=h)}[kernel]
        this = {lay: (lambda p=p: wrapper(*p))
                for lay, p in (("b_row_major", planes),
                               ("b_k_major", k_major))}
        got = {lay: fn() for lay, fn in this.items()}
        out = torch.empty_like(got["b_row_major"])
        what = f"{kernel} ({layout}) w={w} {m}x{k}x{n}"
        err = _staged_base(base, planes, h, layout, out)
        torch.cuda.synchronize()
        times = {"base": [], "b_row_major": [], "b_k_major": []}
        if not all(torch.equal(g, got["b_row_major"]) for g in got.values()):
            raise SystemExit(f"{what}: B row-major and K-major differ")
        if err:
            print(f"{what}: the base refuses it (CUDA error {err}); this "
                  f"checkout alone", flush=True)
        elif not torch.equal(out, got["b_row_major"]):
            raise SystemExit(f"{what}: outputs differ from the base")
        for tag in (ORDER if not err else ("this", "this")):
            if tag == "base":
                times["base"].append(device_ms(lambda: _staged_base(
                    base, planes, h, layout, out)))
            else:
                for lay, fn in this.items():
                    times[lay].append(device_ms(fn))
        row = {"kind": "staged", "kernel": kernel, "layout": layout, "w": w,
               "M": m, "K": k, "N": n, "plane_dtype": str(planes[0].dtype),
               "base_ms": times["base"],
               "this_ms_b_row_major": times["b_row_major"],
               "this_ms_b_k_major": times["b_k_major"]}
        if kernel == "mm1_gemm":
            row["int_mm_ms"] = _int_mm_ms(planes[0], planes[1], "row")
            row["int_mm_ms_b_col_major"] = _int_mm_ms(planes[0], planes[1])
            row["int_mm_padded_to_32_rows"] = m <= 16
        rows.append(row)
        fmt = " ".join
        print(f"staged  {layout:10s} w={w:<2d} M={m:<4d} K={k:<5d} N={n:<6d} "
              f"base {fmt(f'{t:.4f}' for t in row['base_ms'])} ms | this B "
              f"row-major {fmt(f'{t:.4f}' for t in times['b_row_major'])}, "
              f"K-major {fmt(f'{t:.4f}' for t in times['b_k_major'])} ms"
              + (f" | _int_mm {row['int_mm_ms']} [B column-major "
                 f"{row['int_mm_ms_b_col_major']}]"
                 if kernel == "mm1_gemm" else ""), flush=True)
    return rows


def _wkv_inputs(gen, b, s, h, d, entry):
    """Streams, bonus and initial state (stateful: random, as a decode
    step's carried state) in the entry's layout."""
    shape = (b, s, h, d) if entry == "stateful" else (b, s, d)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda") * 0.5
               for _ in range(3))
    w = torch.rand(shape, generator=gen, device="cuda") * 0.199 + 0.8
    u = torch.randn((h, d) if entry == "stateful" else (b, d),
                    generator=gen, device="cuda") * 0.1
    st0 = (torch.randn((b, h, d, d), generator=gen, device="cuda") * 0.2
           if entry == "stateful" else None)
    return r, k, v, w, u, st0


def compare_wkv(base, gen):
    """The WKV rows: this checkout's wrappers against the base's
    ``wkv_launch`` on the same inputs (y and the final state within
    WKV_TOL), then base, this, this, base in device time."""
    rows = []
    for label, b, s, h, d, entry in WKV:
        r, k, v, w, u, st0 = _wkv_inputs(gen, b, s, h, d, entry)
        if entry == "stateful":
            def this():
                return wkv_gemm.wkv_stateful(r, k, v, w, u, st0)
            streams, ub, st_out = (r, k, v, w), u, torch.empty_like(st0)
        else:
            def this():
                return (wkv_gemm.wkv_apply(r, k, v, w, u),)
            streams = tuple(t[:, :, None] for t in (r, k, v, w))
            ub, st_out = u[:, None], None

        def base_call():
            return wkv_gemm._launch(*streams, ub, st0, st_out,
                                    kernel=base["wkv_launch"])

        got = this()
        y_base = base_call()
        torch.cuda.synchronize()
        want = (y_base.reshape(got[0].shape),) + ((st_out,) if st0 is
                                                  not None else ())
        errs = [(g - p).abs().max().item() for g, p in zip(got, want)]
        if not all(torch.allclose(g, p, rtol=WKV_TOL, atol=WKV_TOL)
                   for g, p in zip(got, want)):
            raise SystemExit(f"wkv {label}: outputs differ from the base "
                             f"by {errs}")
        times = {"base": [], "this": []}
        for tag in ORDER:
            times[tag].append(device_ms(this if tag == "this" else
                                        base_call))
        row = {"kind": "wkv", "case": label, "B": b, "S": s, "H": h, "D": d,
               "entry": entry, "max_abs_diff": max(errs),
               "base_ms": times["base"], "this_ms": times["this"]}
        rows.append(row)
        print(f"wkv     {label:12s} B={b:<3d} S={s:<3d} H={h:<2d} D={d} "
              f"base {' '.join(f'{t:.4f}' for t in row['base_ms'])} ms | "
              f"this {' '.join(f'{t:.4f}' for t in row['this_ms'])} ms | "
              f"max |this - base| {max(errs):.2e}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--kernels", choices=("fused", "staged", "wkv", "all"),
                    default="all", help="which kernels to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    base_csrc = args.base / "src" / "repro_torch" / "kernels" / "csrc"
    t0 = time.monotonic()
    build.build(["fused_mm1", "fused_split", "staged_pipe", "wkv"])
    t1 = time.monotonic()
    base = _libraries(base_csrc, "base")
    builds = {"this_units_s": t1 - t0, "base_whole_s": time.monotonic() - t1,
              "base_sources": sorted({src for src, sig in
                                      BASE_SIGNATURES.items()
                                      if set(sig) & set(base)})}
    print(f"build: this checkout {builds['this_units_s']:.1f} s (fused_mm1, "
          f"fused_split, staged_pipe and wkv units in parallel, then "
          f"linked; 0 if built already), base {builds['base_whole_s']:.1f} s "
          f"({', '.join(builds['base_sources'])}, whole, one nvcc each)",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(0)
    rows = []
    if args.kernels in ("staged", "all"):
        rows += compare_staged(base, gen)
    if args.kernels in ("wkv", "all"):
        rows += compare_wkv(base, gen)
    fused = args.kernels in ("fused", "all")
    for mode, w, m, k, n in (DENSE if fused else ()):
        _, h, z, carrier = fg.resolve(w, mode=mode)
        a = _rand(gen, w, (m, k), carrier)
        b = _rand(gen, w, (k, n), carrier)
        sx = torch.rand((m, 1), generator=gen, device="cuda") + 1e-3
        sw = torch.rand((1, n), generator=gen, device="cuda") + 1e-3
        block_k = min(256, 1 << max(3, (k - 1).bit_length()))
        kp = fg.padded_k(k, block_k)
        times = _compare(
            base, f"{mode} {m}x{k}x{n}", mode, a, b, sx, sw, None, 0, h, z,
            kp, lambda: fg.fused_gemm(a, b, sx, sw, w=w, mode=mode,
                                      block_k=block_k,
                                      out_dtype=torch.bfloat16), (m, n))
        row = {"kind": "dense", "mode": mode, "w": w, "M": m, "K": k,
               "N": n, "base_ms": times["base"], "this_ms": times["this"]}
        if mode == "mm1":
            row["int_mm_ms"] = _int_mm_ms(a, b)
            row["int_mm_padded_to_32_rows"] = m <= 16
        rows.append(row)
        _print(row)
    for mode, w, label, e, c, seg, n_seg, k, n in (
            GROUPED if fused else ()):
        _, h, z, carrier = fg.resolve(w, mode=mode)
        a = _rand(gen, w, (e, c, k), carrier)
        b = _rand(gen, w, (e, k, n), carrier)
        sx = torch.rand((e, c, 1), generator=gen, device="cuda") + 1e-3
        sw = torch.rand((e, 1, n), generator=gen, device="cuda") + 1e-3
        tokens = 64 if label.startswith("prefill") else 1
        counts = _routed_counts(cpu_gen, e, seg, n_seg, tokens).cuda()
        kp = fg.padded_k(k, 256)
        times = _compare(
            base, f"grouped {mode} {label} {k}x{n}", mode, a, b, sx, sw,
            counts, seg, h, z, kp,
            lambda: fg.fused_gemm_grouped(a, b, sx, sw, counts, w=w,
                                          mode=mode, seg=seg, block_k=256,
                                          out_dtype=torch.bfloat16),
            (e, c, n))
        live = fg.ragged_row_mask(counts, seg, c)[..., 0]
        row = {"kind": "grouped", "mode": mode, "w": w, "case": label,
               "E": e, "C": c, "K": k, "N": n, "seg": seg,
               "live_rows": int(live.sum()),
               "live_experts": int(live.any(dim=1).sum()),
               "base_ms": times["base"], "this_ms": times["this"]}
        rows.append(row)
        _print(row)
    out_dir = build.BUILD_DIR.parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = {"staged": "compare_staged.json", "wkv": "compare_wkv.json"}.get(
        args.kernels, "compare_fused_gemm.json")
    (out_dir / name).write_text(
        json.dumps({"card": card, "builds": builds, "order": ORDER,
                    "timing": "device time (calls queued behind a sleep)",
                    "rows": rows}, indent=1))
    print(card)
    return 0


def _print(row) -> None:
    shape = (f"M={row['M']:<4d}" if row["kind"] == "dense" else
             f"{row['case']:<12s} C={row['C']:<3d}")
    base = (" ".join(f"{t:.4f}" for t in row["base_ms"]) + " ms"
            if row["base_ms"] else "refuses this mode")
    lib = row.get("int_mm_ms")
    print(f"{row['kind']:7s} {row['mode']:4s} w={row['w']:<2d} {shape} "
          f"K={row['K']:<5d} N={row['N']:<6d} base {base} | this "
          + " ".join(f"{t:.4f}" for t in row["this_ms"]) + " ms"
          + (f" | _int_mm{' (A padded to 32 rows)' if row['M'] <= 16 else ''}"
             f" {lib:.4f} ms" if lib is not None else ""), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
