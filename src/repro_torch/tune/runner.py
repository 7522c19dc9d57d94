"""Offline benchmark loop: time every candidate that serving would run as
it is, gate it for correctness, record the winner (port of
``repro.tune.runner``).

Each candidate is gated through :func:`repro_torch.kernels.ops.run_plan`,
the seam production uses.  Correctness is a gate, not a tolerance:
exact-int candidates must equal the int64 oracle, fp32 candidates the
``use_ref_kernels`` mirror (identical padding and correction around the
kernels' plain versions), bit for bit.  A candidate the seam refuses
(``ValueError``, ``NotImplementedError``) or whose output fails its gate
is rejected and counted; any other error — a failed CUDA launch among
them — propagates, since every candidate that passes ``space.validate``
must run and be exact.

Which candidates are timed (:func:`served_candidates`; the search space
itself is the reference's, ``space.pruned_space``): only those that
``core.dispatch.select_plan`` serves as they are from a table — the
analytic plan's numerics class and, for fp32 plans, its padded K — so the
recorded winner is what a table makes serving run; and of those, one per
distinct launch: on CUDA ``block_k`` only fixes the padded K, so plans of
one variant, depth and combine that pad K alike launch the same kernel
(and fused mm1 never reads the padded K at all).  The analytic default
comes first, so where it ties with another plan's launch, it is the one
timed.

Each candidate is timed as serving runs it: on operands in the carrier
dtype the quantized matmul stores w-bit codes in, followed by the dequant
(:func:`repro_torch.quant.qmatmul.run_plan_dequant`).  On the card that is
device time (:func:`device_time_us`): the calls are queued behind a device
sleep longer than the host takes to enqueue them, so CUDA events measure
the kernels, not the host, over enough calls to time at least
``MIN_DEVICE_MS``.  On the CPU, where every kernel runs its plain version,
it is the host clock.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import ExecPlan, analytic_plan, select_plan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_int_gemm_i64
from repro_torch.quant.quantize import carrier_dtype
from repro_torch.tune import space as tune_space
from repro_torch.tune.space import Shape


# A device measurement covers at least this much device time; its lead
# (the device sleep queued first) is this many times the host time of
# enqueuing the timed calls, at least LEAD_FLOOR_MS, and lengthened up to
# LEAD_TRIES times where the host outran it.
MIN_DEVICE_MS = 0.1
LEAD_MARGIN, LEAD_FLOOR_MS, LEAD_TRIES = 2.0, 1.0, 4
# torch.cuda._sleep counts clock cycles: at most 2 GHz on the card.
SLEEP_CYCLES_PER_MS = 2e6
# A winner that beats the analytic default by more than RETIME_MARGIN in
# the sweep (chip_smoke.py's TUNE_SLOWER) is timed again, RETIME_ROUNDS
# times each in turns with the default, before it is recorded, and the
# medians are recorded: one outlying time of the default must not make a
# slower plan the winner.
RETIME_MARGIN, RETIME_ROUNDS = 0.03, 3


@dataclass
class Measurement:
    plan: ExecPlan
    us: float = float("inf")
    ok: bool = False
    error: str = ""
    # device timing only: the lead's ms and the calls timed behind it
    lead_ms: Optional[float] = None
    iters: Optional[int] = None


@dataclass
class TuneResult:
    shape: Shape
    w: int
    backend: str
    winner: Optional[ExecPlan]
    winner_us: float
    default_us: float
    measurements: List[Measurement] = field(default_factory=list)
    # winner_us and default_us are re-timed medians (RETIME_MARGIN)
    retimed: bool = False

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


def launch_key(plan: ExecPlan, k: int) -> tuple:
    """What a plan launches at K: its kernel and padded K (fused mm1, the
    MM1 window, never reads the padded K)."""
    if plan.variant == "fused" and plan.w <= plan.m:
        return ("fused", 0, True)
    return (plan.variant, plan.depth, plan.combine_int32,
            -(-k // plan.block_k) * plan.block_k)


def served_as_is(plan: ExecPlan, shape: Shape) -> bool:
    """Whether ``select_plan`` serves ``plan`` unchanged from a table that
    records it for ``shape`` (its rule, ``core/dispatch.py``: the analytic
    plan's numerics class and, for fp32 plans, its padded K)."""
    from repro_torch.tune.table import TuningTable
    table = TuningTable()
    table.put(plan.backend, shape, plan.w, plan)
    got = select_plan(shape, plan.w, m=plan.m, backend=plan.backend,
                      table=table)
    return all(getattr(got, f) == getattr(plan, f)
               for f in ("variant", "block_k", "combine_int32", "depth"))


def served_candidates(shape: Shape, w: int, *, m: int = 8,
                      backend: str = "cuda",
                      tile_choices: Optional[Sequence[int]] = None
                      ) -> List[ExecPlan]:
    """The candidates worth timing for one problem: the analytic default
    (where it is a valid table entry: not at K < 128, where its block_k of
    256 is oversized), then the pruned space in prior order, keeping a
    plan only if ``select_plan`` serves it as it is and no plan kept
    before launches the same kernel on the same padded K
    (:func:`launch_key`)."""
    default = analytic_plan(w, m, backend=backend)
    out, seen = [], set()
    for plan in [default] + tune_space.pruned_space(
            shape, w, m=m, backend=backend, tile_choices=tile_choices):
        key = launch_key(plan, shape[1])
        if key in seen or tune_space.validate(plan, shape) is not None \
                or not served_as_is(plan, shape):
            continue
        seen.add(key)
        out.append(plan)
    return out


def device_time_us(fn, iters: int = 3, *, cuda=None,
                   clock=time.perf_counter) -> Tuple[float, Dict]:
    """Mean device microseconds of ``fn`` on the card (already warm): the
    host time of enqueuing a call is taken first, then the calls are timed
    with CUDA events behind a device sleep (the lead) ``LEAD_MARGIN`` times
    longer than enqueuing them takes, at least ``LEAD_FLOOR_MS``, over at
    least ``iters`` calls and enough to cover ``MIN_DEVICE_MS``.  The host
    time of the timed enqueue is checked against the lead: where the host
    outran it (a slow call, a pause), the events timed the host, and the
    measurement is taken again behind a longer lead.  Returns the mean and
    what was chosen (``lead_ms``, ``iters``, ``host_us`` a call)."""
    cuda = cuda or torch.cuda
    cuda.synchronize()
    n = max(iters, 1)
    t0 = clock()
    for _ in range(n):
        fn()
    host_ms = (clock() - t0) * 1e3 / n
    cuda.synchronize()

    def timed(calls: int) -> Tuple[float, float]:
        lead = max(LEAD_FLOOR_MS, LEAD_MARGIN * calls * host_ms)
        for _ in range(LEAD_TRIES):
            cuda._sleep(int(lead * SLEEP_CYCLES_PER_MS))
            start = cuda.Event(enable_timing=True)
            end = cuda.Event(enable_timing=True)
            start.record()
            t0 = clock()
            for _ in range(calls):
                fn()
            enqueue_ms = (clock() - t0) * 1e3
            end.record()
            end.synchronize()
            if enqueue_ms < lead:
                return start.elapsed_time(end) / calls, lead
            lead = LEAD_MARGIN * enqueue_ms
        raise RuntimeError(f"device_time_us: the host outran a {lead:.3f} ms "
                           f"lead {LEAD_TRIES} times")

    ms, lead = timed(n)
    if ms * n < MIN_DEVICE_MS:
        n = math.ceil(MIN_DEVICE_MS / max(ms, 1e-6))
        ms, lead = timed(n)
    return ms * 1e3, {"lead_ms": lead, "iters": n, "host_us": host_ms * 1e3}


def bench_plan(plan: ExecPlan, a: torch.Tensor, b: torch.Tensor, *,
               iters: int = 3, detail: Optional[Dict] = None) -> float:
    """Steady-state microseconds a call, one warm-up call excluded: device
    time on the card (:func:`device_time_us`; its lead and call count go
    into ``detail`` when one is given), the host clock on the CPU.  The
    call is the one serving makes, the plan with its dequant to bfloat16
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
        with torch.cuda.device(a.device):
            us, info = device_time_us(fn, iters)
        if detail is not None:
            detail.update(info)
        return us
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
    """Sweep one (shape, w) problem on ``device``: every candidate of
    :func:`served_candidates`, gated and timed as serving runs it
    (:func:`bench_plan`).

    Returns the fastest correct candidate, which a table makes serving run
    as it is, and the time of the analytic default plan (what runs with no
    table; the first candidate), so a table can report its speedup
    honestly.  A winner that beats the default by more than
    ``RETIME_MARGIN`` is re-timed in turns with it (:func:`_retime`) first:
    the medians are the times returned, and where the default is not the
    slower one then, the default is the winner.  ``max_candidates``
    truncates the candidates; the result's measurement count shows it.
    Under ``context.mesh`` on ``"cuda"`` the sweep runs the per-rank local
    shape: the sharded kernel runs it, and ``select_plan`` looks it up.
    """
    if context is not None:
        backend = context.backend
        if context.mesh is not None and backend == "cuda":
            shape = context.local_gemm_shape(shape)
    a, b = make_operands(shape, w, seed=seed, device=device, m=m)
    cands = served_candidates(shape, w, m=m, backend=backend,
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
        detail: Dict = {}
        us = bench_plan(plan, a, b, iters=iters, detail=detail)
        measurements.append(Measurement(plan, us=us, ok=True,
                                        lead_ms=detail.get("lead_ms"),
                                        iters=detail.get("iters")))
        if us < winner_us:
            winner, winner_us = plan, us
        if verbose:
            lead = (f" (lead {detail['lead_ms']:.3f} ms, "
                    f"{detail['iters']} calls)" if detail else "")
            print(f"    {plan.variant:9s} block_k={plan.block_k:<3d} "
                  f"int32={int(plan.combine_int32)} depth={plan.depth}: "
                  f"{us:9.1f} us{lead}")
    default = analytic_plan(w, m, backend=backend)
    timed = [r for r in measurements if r.ok and r.plan == default]
    if timed:
        default_us = timed[0].us
    else:
        try:
            default_us = bench_plan(default, a, b, iters=iters)
        except NotImplementedError:  # w >= 27: the analytic plan is not ported
            default_us = float("nan")
    retimed = bool(timed) and winner is not None and winner != default \
        and winner_us * (1 + RETIME_MARGIN) < default_us
    if retimed:
        winner_us, default_us = _retime(winner, default, a, b, iters)
        if default_us <= winner_us:
            winner, winner_us = default, default_us
    return TuneResult(shape=shape, w=w, backend=backend, winner=winner,
                      winner_us=winner_us, default_us=default_us,
                      measurements=measurements, retimed=retimed)


def _retime(winner: ExecPlan, default: ExecPlan, a, b,
            iters: int) -> Tuple[float, float]:
    """(winner us, default us): the medians of RETIME_ROUNDS timings each,
    the default and the winner in turns."""
    times: Dict[str, List[float]] = {"winner": [], "default": []}
    for _ in range(RETIME_ROUNDS):
        for label, plan in (("default", default), ("winner", winner)):
            times[label].append(bench_plan(plan, a, b, iters=iters))
    return statistics.median(times["winner"]), \
        statistics.median(times["default"])


def device_label(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(device)}"
    return "cpu/plain"
