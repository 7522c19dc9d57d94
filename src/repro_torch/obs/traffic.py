"""Memory-traffic accounting for the GEMM execution paths (port of the
analytic half of ``repro.obs.traffic``; pure Python, no torch).

The paper's fused-kernel claim is a *traffic* argument — one HBM round trip
instead of the staged pipeline's ~6 passes.  :func:`analytic_bytes` prices
each path's HBM bytes with the same asymmetry
:func:`repro_torch.tune.space.cost_prior` ranks candidates by, as the
reference does:

  * ``fused``:  no digit planes in HBM; each operand tile's raw carrier
    (int8 when ``w <= m``, int16 above, int32 past w = 16) is re-read once
    per reuse across the other grid axis, plus one fp32 output write.
  * ``staged``: plane build reads the int32 operands, writes 4 s8 digit
    planes, the kernel re-reads the planes per grid reuse, the zero-point
    correction re-reads both operands, and the core + correction +
    combine account ~3 fp32-output-sized passes.
  * ``xla``:    one pass over the operands and the output (the ideal
    single-dot floor).
  * ``strassen_kmm2`` / ``strassen_xla``: one tile-level Strassen split —
    7 half-shape sub-GEMMs at w+1 through the fused kernel / the digit
    recursion, plus the tile-add plane traffic of the 10 pre-adds and the
    8-term output combine.

The kind names, tiles and formulas are the reference's, so both packages
price a path identically (pinned by ``tests/test_torch_analytic.py``).
:func:`analytic_rows` gives the per-(kind, shape) analytic rows and the
analytic pair rows (``analytic_bytes_ratio``, the committed Strassen
claim); :func:`traffic_checks` is the reference's verdict function over
any rows, measured or analytic.

**The measured side is not ported.**  The reference reads bytes accessed
from XLA's ``cost_analysis`` of the lowered program; ATen has no compiled
program to ask, and the counterpart on the card — Nsight Compute's
``dram__bytes_read.sum`` / ``dram__bytes_write.sum`` — needs ``ncu`` with
access to the GPU's performance counters.  On the H100 machine the port is
measured on, ``ncu`` is installed but its counter library does not load
(``chip_smoke.py``'s phase 5o probes it and reports the error), so there
is nothing to read.  :func:`measure_costs`,
:func:`measure_plan_bytes` and :func:`traffic_rows` therefore raise
``NotImplementedError`` with that reason: none of them returns 0.0 in
place of a measurement.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Shape = Tuple[int, int, int]            # (M, K, N)

# The reference's tuned deep-K bench geometry: ((M, K, N), block_k) at
# w=12, bm = bn = 128.
DEFAULT_SHAPES: Tuple[Tuple[Shape, int], ...] = (
    ((128, 4096, 128), 1024), ((128, 8192, 128), 2048))
SMOKE_SHAPES: Tuple[Tuple[Shape, int], ...] = (
    ((64, 256, 64), 64), ((64, 512, 64), 128))
DEFAULT_W = 12

# Per-row sanity window on measured/analytic, and the cross-shape
# consistency bound per path (max/min ratio over the swept shapes).
RATIO_WINDOW = (0.25, 32.0)
CONSISTENCY_MAX = 2.0

TRAFFIC_KINDS = ("fused", "staged", "xla")

# The kernel windows, each priced at a representative width: fused_mm2 vs
# the staged MM2 pipeline at w = 15 (the 2m-1 boundary), fused depth-2
# (kmm4) vs staged kmm2-depth-2 at w = 20.  Each (fused, staged) pair
# shares a width so the bytes ratio is apples-to-apples.
EXTENDED_KINDS: Tuple[Tuple[str, int], ...] = (
    ("fused_mm2", 15), ("staged_mm2", 15),
    ("fused_d2", 20), ("staged_d2", 20))
FUSED_PAIRS = (("fused", "staged"), ("fused_mm2", "staged_mm2"),
               ("fused_d2", "staged_d2"))
# Tile-level Strassen composition (core/strassen.py): both variants at
# w = 9, where (256, 4096, 256) sits exactly at the composed K bound
# 2**(30 - 2w) = 4096.
STRASSEN_W = 9
STRASSEN_SHAPES: Tuple[Tuple[Shape, int], ...] = (
    ((128, 4096, 128), 2048), ((256, 4096, 256), 2048))
STRASSEN_KINDS = ("strassen_kmm2", "strassen_xla")
# The committed Strassen pairwise claim is on ANALYTIC bytes.
ANALYTIC_PAIRS = (("strassen_kmm2", "strassen_xla"),)
GROUPED_W = 12
GROUPED_EXPERTS = 4

_FUSED_KINDS = ("fused", "fused_mm2", "fused_d2")
_STAGED_KINDS = ("staged", "staged_mm2", "staged_d2")

_NOT_MEASURED = (
    "measured traffic is not ported: the reference reads XLA's "
    "cost_analysis, which ATen has no counterpart of, and the card's "
    "counterpart (ncu's dram__bytes_read.sum / dram__bytes_write.sum) needs "
    "GPU performance counters, whose library ncu cannot load on the "
    "measuring machine; use analytic_bytes / analytic_rows")


def _pad(dim: int, block: int) -> int:
    return -(-dim // block) * block


def _carrier_bytes(w: int, m: int) -> int:
    """Per-element bytes of the fused kernel's raw operand carrier."""
    return 1 if w <= m else (2 if w <= 16 else 4)


def analytic_bytes(kind: str, shape: Shape, *, w: int = DEFAULT_W,
                   m: int = 8, tiles: Tuple[int, int, int] = None,
                   n_experts: int = 1) -> float:
    """Analytic HBM bytes of one GEMM path (the cost_prior traffic terms,
    priced in bytes).  ``tiles`` = (bm, bn, bk); required for the kernel
    paths (grid reuse factors), ignored for ``xla``.  ``grouped`` prices
    ``n_experts`` independent fused launches plus the ragged counts read."""
    M, K, N = shape
    if kind == "xla":
        return 4.0 * (M * K + K * N) + 4.0 * M * N
    if kind in STRASSEN_KINDS:
        # One tile-split level: 7 sub-GEMMs on the (M/2, K/2, N/2)
        # quadrants at w + 1, plus the tile-add planes — 10 operand
        # pre-adds each read two int32 quadrant planes and write one (15
        # element-passes over the operand quadrants), and the 8-term output
        # combine reads 7 int32 products and writes 4 quadrants (11 passes
        # of M/2 x N/2).
        Ms, Ks, Ns = -(-M // 2), -(-K // 2), -(-N // 2)
        adds = 60.0 * (Ms * Ks + Ks * Ns) + 44.0 * Ms * Ns
        if kind == "strassen_kmm2":
            per = analytic_bytes("fused", (Ms, Ks, Ns), w=w + 1, m=m,
                                 tiles=tiles)
        else:
            # digit-recursion sub-GEMM: plane build + three digit products
            # + zero-point sums put ~5 int32 passes over each operand and
            # ~4 over the output.
            per = 20.0 * (Ms * Ks + Ks * Ns) + 16.0 * Ms * Ns
        return 7.0 * per + adds
    bm, bn, bk = tiles
    Mp, Np, Kp = _pad(M, bm), _pad(N, bn), _pad(K, bk)
    ra, rb = Np // bn, Mp // bm         # reuse of A-tiles / B-tiles
    if kind in _FUSED_KINDS:
        opd = _carrier_bytes(w, m)
        return opd * (Mp * Kp * ra + Kp * Np * rb) + 4.0 * Mp * Np
    if kind == "grouped":
        opd = _carrier_bytes(w, m)
        per = opd * (Mp * Kp * ra + Kp * Np * rb) + 4.0 * Mp * Np
        return n_experts * per + 4.0 * n_experts  # + (E, S) int32 counts
    if kind in _STAGED_KINDS:
        # Depth 2 stages two levels of digit planes: scale the plane
        # write/read terms by digits // 2, as cost_prior prices them.
        lv = 2.0 if kind == "staged_d2" else 1.0
        return (4.0 * (M * K + K * N)           # plane build reads (int32)
                + lv * 2.0 * (Mp * Kp + Kp * Np)  # digit-plane writes
                + lv * 2.0 * (Mp * Kp * ra + Kp * Np * rb)  # plane reads
                + 4.0 * (M * K + K * N)         # correction rowsum/colsum
                + 3.0 * 4.0 * Mp * Np)          # core + corr + combine out
    raise ValueError(f"unknown traffic kind {kind!r}")


def analytic_rows(shapes: Sequence[Tuple[Shape, int]] = DEFAULT_SHAPES,
                  *, w: int = DEFAULT_W, m: int = 8,
                  kinds: Sequence[str] = TRAFFIC_KINDS) -> List[Dict]:
    """The analytic half of the reference's ``traffic_rows``: one row per
    (kind, shape) with ``analytic_bytes`` (named and tiled as the
    reference's rows), plus one ``analytic_bytes_ratio`` row per shape for
    every analytic pair among ``kinds``."""
    rows: List[Dict] = []
    for (shape, bk) in shapes:
        M, K, N = shape
        tiles = (min(128, M), min(128, N), bk)
        tag = f"{M}x{K}x{N}"
        analytic: Dict[str, float] = {}
        for kind in kinds:
            ana = analytic_bytes(kind, shape, w=w, m=m, tiles=tiles)
            analytic[kind] = ana
            rows.append({
                "bench": "roofline",
                "name": f"roofline/traffic_{kind}_w{w}_{tag}",
                "kind": kind, "shape": tag, "w": w,
                "tiles": "x".join(str(t) for t in tiles),
                "analytic_bytes": ana,
            })
        for fk, sk in ANALYTIC_PAIRS:
            if analytic.get(fk) and analytic.get(sk):
                rows.append({
                    "bench": "roofline",
                    "name": (f"roofline/traffic_{fk}_over_{sk}_bytes"
                             f"_w{w}_{tag}"),
                    "shape": tag, "w": w,
                    "analytic_bytes_ratio":
                        round(analytic[fk] / analytic[sk], 4),
                    "expect": "< 1.0 analytic (7 fused sub-GEMMs vs 7 "
                              "digit-recursion sub-GEMMs)",
                })
    return rows


def measure_costs(*args, **kwargs) -> Dict[str, float]:
    """Not ported: raises ``NotImplementedError`` (module docstring)."""
    raise NotImplementedError(_NOT_MEASURED)


def measure_plan_bytes(*args, **kwargs) -> float:
    """Not ported: raises ``NotImplementedError`` (module docstring)."""
    raise NotImplementedError(_NOT_MEASURED)


def traffic_rows(*args, **kwargs) -> List[Dict]:
    """Not ported: raises ``NotImplementedError`` (module docstring);
    :func:`analytic_rows` gives the analytic half."""
    raise NotImplementedError(_NOT_MEASURED)


def traffic_checks(rows: Sequence[Dict]) -> List[Tuple[str, bool, str]]:
    """Pass/fail verdicts over traffic rows, the reference's function:
    fused below staged in measured bytes, each analytic pair ratio below
    1, each row's measured/analytic inside RATIO_WINDOW and consistent
    across shapes.  On analytic rows alone the measured checks have no
    rows and the first verdict says so (0 measured)."""
    checks: List[Tuple[str, bool, str]] = []
    measured = [r for r in rows if "measured_bytes" in r]
    errors = [r for r in rows if r.get("dominant") == "ERROR"]
    checks.append(("traffic harness produced measured rows",
                   bool(measured) and not errors,
                   f"{len(measured)} measured, {len(errors)} errors"))
    by_shape: Dict[str, Dict[str, float]] = {}
    by_kind: Dict[str, List[float]] = {}
    for r in measured:
        by_shape.setdefault(r["shape"], {})[r["kind"]] = r["measured_bytes"]
        by_kind.setdefault(r["kind"], []).append(r["measured_over_analytic"])
    for tag, kinds in sorted(by_shape.items()):
        for fk, sk in FUSED_PAIRS:
            if fk in kinds and sk in kinds:
                ratio = kinds[fk] / kinds[sk] if kinds[sk] else 0
                checks.append(
                    (f"{fk} measured bytes <= {sk} at {tag}",
                     0 < kinds[fk] <= kinds[sk],
                     f"{fk}/{sk} = {ratio:.3f}"))
    for r in rows:
        if "analytic_bytes_ratio" in r:
            checks.append(
                (f"analytic bytes ratio < 1.0 for "
                 f"{r['name'].rsplit('/', 1)[-1]}",
                 0 < r["analytic_bytes_ratio"] < 1.0,
                 f"ratio {r['analytic_bytes_ratio']}"))
    lo, hi = RATIO_WINDOW
    for r in measured:
        checks.append(
            (f"measured/analytic within [{lo}, {hi}] for "
             f"{r['kind']} at {r['shape']}",
             lo <= r["measured_over_analytic"] <= hi,
             f"ratio {r['measured_over_analytic']} ({r['method']})"))
    for kind, ratios in sorted(by_kind.items()):
        if len(ratios) > 1 and min(ratios) > 0:
            spread = max(ratios) / min(ratios)
            checks.append(
                (f"{kind} measured/analytic consistent across shapes "
                 f"(max/min <= {CONSISTENCY_MAX})",
                 spread <= CONSISTENCY_MAX, f"spread {spread:.3f}"))
    return checks
