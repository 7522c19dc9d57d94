"""Offline benchmark loop: time every pruned candidate, gate it for
correctness, record the winner (port of ``repro.tune.runner``).

Each candidate is gated through :func:`repro_torch.kernels.ops.run_plan`,
the seam production uses.  Correctness is a gate, not a tolerance:
exact-int candidates must equal the int64 oracle, fp32 candidates the
``use_ref_kernels`` mirror (identical padding and correction around the
kernels' plain versions), bit for bit.  A candidate the seam refuses
(``ValueError``, ``NotImplementedError``) or whose output fails its gate
is rejected and counted; any other error — a failed CUDA launch among
them — propagates, since every candidate that passes ``space.validate``
must run and be exact.

Each candidate is timed as serving runs it: on operands in the carrier
dtype the quantized matmul stores w-bit codes in, followed by the dequant
(:func:`repro_torch.quant.qmatmul.run_plan_dequant`), so the numbers are
the ones dispatch will get.  On the card a candidate is timed with CUDA
events; on the CPU, where every kernel runs its plain version, with the
host clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import ExecPlan, analytic_plan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_int_gemm_i64
from repro_torch.quant.quantize import carrier_dtype
from repro_torch.tune import space as tune_space
from repro_torch.tune.space import Shape


@dataclass
class Measurement:
    plan: ExecPlan
    us: float = float("inf")
    ok: bool = False
    error: str = ""


@dataclass
class TuneResult:
    shape: Shape
    w: int
    backend: str
    winner: Optional[ExecPlan]
    winner_us: float
    default_us: float
    measurements: List[Measurement] = field(default_factory=list)

    @property
    def speedup_vs_default(self) -> float:
        if not self.winner or not np.isfinite(self.default_us) \
                or self.winner_us <= 0:
            return 1.0
        return self.default_us / self.winner_us


def make_operands(shape: Shape, w: int, seed: int = 0, device="cpu",
                  m: int = 8):
    """Random signed w-bit operands for an (M, K) x (K, N) problem, from a
    seeded numpy generator, in the carrier dtype the quantized matmul
    stores w-bit codes in (``carrier_dtype(w, m)``)."""
    rows, k, n = shape
    rng = np.random.default_rng(seed)
    lim = 2 ** (w - 1)
    a = rng.integers(-lim, lim, size=(rows, k)).astype(np.int32)
    b = rng.integers(-lim, lim, size=(k, n)).astype(np.int32)
    carrier = carrier_dtype(w, m)
    return (torch.from_numpy(a).to(device=device, dtype=carrier),
            torch.from_numpy(b).to(device=device, dtype=carrier))


def exact_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer product as int64 on the operands' device: a
    float64 matmul when every partial sum stays below 2^53 (exact there),
    else the numpy int64 oracle."""
    bound = (a.to(torch.int64).abs().max().item()
             * b.to(torch.int64).abs().max().item() * a.shape[1]
             if a.numel() and b.numel() else 0)
    if bound < 2 ** 53:
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int64)
    return torch.from_numpy(ref_int_gemm_i64(a.cpu(), b.cpu())).to(a.device)


def check_plan(plan: ExecPlan, a: torch.Tensor, b: torch.Tensor, *,
               oracle: Optional[torch.Tensor] = None) -> Tuple[bool, str]:
    """Bit-exact correctness gate for one candidate: exact-int plans
    against the int64 oracle (``oracle``, the :func:`exact_product` of the
    operands, computed here when not given), fp32 plans against the
    ``use_ref_kernels`` mirror."""
    try:
        out = ops.run_plan(a, b, plan=plan)
    except (ValueError, NotImplementedError) as e:
        return False, f"execution failed: {type(e).__name__}: {e}"
    if plan.is_exact_int:
        if oracle is None:
            oracle = exact_product(a, b)
        if not torch.equal(out.to(torch.int64), oracle):
            return False, "exact-int candidate != int64 oracle"
        return True, ""
    mirror = ops.run_plan(a, b, plan=plan, use_ref_kernels=True)
    if not torch.equal(out, mirror):
        return False, "fp32 candidate != ref-kernel mirror"
    return True, ""


def bench_plan(plan: ExecPlan, a: torch.Tensor, b: torch.Tensor, *,
               iters: int = 3) -> float:
    """Steady-state microseconds a call, one warm-up call excluded: CUDA
    events on the card, the host clock on the CPU.  The call is the one
    serving makes, the plan with its dequant to bfloat16
    (``qmatmul.run_plan_dequant``: in the fused kernel's epilogue, or after
    a staged plan's ``run_plan``), on per-row and per-column fp32 scales."""
    # qmatmul imports tune, so it is imported here, not with the module.
    from repro_torch.quant.qmatmul import run_plan_dequant
    sx = torch.full((a.shape[0], 1), 1e-3, device=a.device)
    sw = torch.full((1, b.shape[1]), 1e-3, device=a.device)

    def fn():
        return run_plan_dequant(a, b, sx, sw, plan, torch.bfloat16)

    iters = max(iters, 1)
    fn()
    if a.device.type == "cuda":
        torch.cuda.synchronize(a.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def tune_shape(shape: Shape, w: int, *, m: int = 8, backend: str = "cuda",
               iters: int = 3, seed: int = 0,
               tile_choices: Optional[Sequence[int]] = None,
               max_candidates: Optional[int] = None,
               verbose: bool = False, context=None,
               device="cuda") -> TuneResult:
    """Sweep the pruned space for one (shape, w) problem on ``device``.

    Returns the fastest correct candidate and the time of the analytic
    default plan (what runs with no table), each timed as serving runs it
    (:func:`bench_plan`), so a table can report its speedup honestly.  ``max_candidates`` truncates the prior-ordered
    space; the result's measurement count shows it.
    """
    if context is not None:
        backend = context.backend
    a, b = make_operands(shape, w, seed=seed, device=device, m=m)
    cands = tune_space.pruned_space(shape, w, m=m, backend=backend,
                                    tile_choices=tile_choices)
    if max_candidates is not None:
        cands = cands[:max_candidates]
    oracle = None
    if any(p.is_exact_int for p in cands):
        oracle = exact_product(a, b)
    measurements: List[Measurement] = []
    winner: Optional[ExecPlan] = None
    winner_us = float("inf")
    for plan in cands:
        ok, err = check_plan(plan, a, b, oracle=oracle)
        if not ok:
            measurements.append(Measurement(plan, ok=False, error=err))
            continue
        us = bench_plan(plan, a, b, iters=iters)
        measurements.append(Measurement(plan, us=us, ok=True))
        if us < winner_us:
            winner, winner_us = plan, us
        if verbose:
            print(f"    {plan.variant:9s} block_k={plan.block_k:<3d} "
                  f"int32={int(plan.combine_int32)} depth={plan.depth}: "
                  f"{us:9.1f} us")
    default = analytic_plan(w, m, backend=backend)
    try:
        default_us = bench_plan(default, a, b, iters=iters)
    except NotImplementedError:    # w >= 27: the analytic plan is not ported
        default_us = float("nan")
    return TuneResult(shape=shape, w=w, backend=backend, winner=winner,
                      winner_us=winner_us, default_us=default_us,
                      measurements=measurements)


def device_label(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(device)}"
    return "cpu/plain"
