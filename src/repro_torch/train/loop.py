"""Training loop with fault tolerance: auto-resume, async checkpoints,
deterministic skip-ahead data and a step-time straggler watchdog (port of
``repro.train.loop``).

``run_training(cfg, tc, data_cfg, hooks, device=..., mesh=...)`` draws
the fp32 parameters from a ``torch.Generator`` seeded with ``tc.seed``
(on the device), resumes from the newest checkpoint under ``tc.ckpt_dir``
when there is one (params, optimizer state and the data position: batch
n is a pure function of (seed, n)), and runs ``make_train_step`` to
``tc.steps``.  A non-finite loss raises ``FloatingPointError``;
``hooks["inject_fault"](step)`` runs after each step (tests raise from it
to exercise the supervised restart).  Checkpoints are saved every
``tc.ckpt_every`` steps and at the end through an
:class:`~repro_torch.train.checkpoint.AsyncCheckpointer`.  The result also
carries the final params and optimizer state (the reference's jitted loop
keeps them on its mesh).

With ``mesh`` (the reference's mesh argument; ``launch.mesh.make_mesh``)
the run is one rank of the mesh: the parameters are drawn leaf by leaf
and each rank keeps its blocks (``lm.init_params(mesh=...)``, placed by
the ``leaf_spec`` rules ``launch.steps.abstract_params`` gives, whose
per-rank bytes the result reports beside the resident ones), the optimizer state follows them, the
step runs under the mesh as the ambient one (each data rank takes its
rows of every microbatch of the global batch), and checkpoints hold the
logical arrays, so a run may resume on another mesh shape.  Every rank
takes every decision alike, since a rank that raised alone would leave
the others waiting in a collective: the resume step is rank 0's, and the
fault hook's outcome, the non-finite check and the watchdog's step time
(the slowest rank's) are agreed by an all-reduce before any rank acts.
Every model trains under a mesh: dense and MoE attention decoders, mamba
and RWKV blocks, a vision prefix and the encoder-decoder.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.context import ExecContext, resolve_device
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.dist.sharding import resident_bytes, use_mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    seed: int = 0
    straggler_factor: float = 3.0   # watchdog: step > factor x median -> warn
    optimizer: optim.AdamWConfig = field(default_factory=optim.AdamWConfig)
    # How quantized GEMMs run; its tuning table (numerics-pinned: it
    # changes which kernels run, never a value) is installed for the run.
    context: Optional[ExecContext] = None


@dataclass
class TrainResult:
    final_step: int
    losses: Dict[int, float]
    restored_from: Optional[int]
    straggler_events: int
    params: Any = None
    opt_state: Optional[optim.OptState] = None
    step_seconds: list = field(default_factory=list)
    # this rank's bytes of params, mu and nu: held, and as the abstract
    # specs place them (equal)
    resident_bytes: int = 0
    planned_bytes: int = 0


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _agree_max(mesh, value: float) -> float:
    """The largest ``value`` over the mesh's world (every rank must call
    it); ``value`` itself without a mesh."""
    if mesh is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64)
    if dist.get_backend() != "gloo":
        t = t.to(mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _run_hook(hooks, step: int, mesh) -> None:
    """``hooks["inject_fault"](step)`` on this rank; under a mesh every
    rank raises when any rank's hook did."""
    if "inject_fault" not in hooks:
        return
    err = None
    try:
        hooks["inject_fault"](step)
    except Exception as e:      # agreed on below, then raised
        err = e
    if _agree_max(mesh, float(err is not None)) and err is None:
        raise RuntimeError(f"a fault on another rank at step {step}")
    if err is not None:
        raise err


def run_training(cfg: ModelConfig, tc: TrainConfig,
                 data_cfg: Optional[DataConfig] = None,
                 hooks: Optional[Dict[str, Callable]] = None, *,
                 device=None, mesh=None) -> TrainResult:
    hooks = hooks or {}
    dev = resolve_device(device)
    if mesh is not None:
        if torch.device(mesh.device_type).type != dev.type:
            raise ValueError(f"the mesh computes on {mesh.device_type!r}, "
                             f"the run on {dev.type!r}")
    ctx = tc.context or ExecContext()
    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        frontend_tokens=cfg.frontend_tokens, encdec=cfg.is_encdec,
        seed=tc.seed)

    with ctx.activate(), (use_mesh(mesh) if mesh is not None
                          else contextlib.nullcontext()):
        gen = torch.Generator(dev).manual_seed(tc.seed)
        params = lm.init_params(gen, cfg, device=dev, mesh=mesh)
        opt_state = optim.init(params)
        planned = resident = 0
        if mesh is not None:
            abs_params = steps_mod.abstract_params(cfg, mesh)
            abs_state = steps_mod.abstract_opt_state(abs_params, mesh)
            planned = steps_mod.local_bytes(
                (abs_params, abs_state.mu, abs_state.nu), mesh)
            resident = resident_bytes(
                {"p": params, "mu": opt_state.mu, "nu": opt_state.nu})
            log.info("resident per rank: %d bytes of params and AdamW state "
                     "(the specs place %d)", resident, planned)

        restored_from = None
        if tc.ckpt_dir:
            last = ckpt.latest_step(tc.ckpt_dir, mesh=mesh)
            if last is not None:
                _, (params, opt_state), _ = ckpt.load(
                    tc.ckpt_dir, (params, opt_state), step=last)
                restored_from = last
                log.info("resumed from step %d", last)

        start_step = int(opt_state.step)
        train_step = steps_mod.make_train_step(cfg, tc.optimizer)
        it = DataIterator(data_cfg, start_step=start_step)   # skip-ahead
        saver = (ckpt.AsyncCheckpointer(tc.ckpt_dir, keep=tc.ckpt_keep,
                                        mesh=mesh)
                 if tc.ckpt_dir else None)

        losses: Dict[int, float] = {}
        step_times = []
        straggler_events = 0
        for step in range(start_step, tc.steps):
            batch = _to_device(next(it), dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch)
            _run_hook(hooks, step, mesh)
            loss = float(metrics["loss"])
            dt = _agree_max(mesh, time.perf_counter() - t0)
            step_times.append(dt)
            if len(step_times) > 5:
                median = float(np.median(step_times[-50:]))
                if dt > tc.straggler_factor * median:
                    straggler_events += 1
                    log.warning("straggler: step %d took %.3fs (median "
                                "%.3fs)", step, dt, median)
            if _agree_max(mesh, float(not np.isfinite(loss))):
                raise FloatingPointError(f"non-finite loss at step {step}")
            if step % tc.log_every == 0 or step == tc.steps - 1:
                losses[step] = loss
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if saver and (step + 1) % tc.ckpt_every == 0:
                saver.save(step + 1, (params, opt_state),
                           meta={"arch": cfg.name})
        if saver:
            saver.save(tc.steps, (params, opt_state),
                       meta={"arch": cfg.name})
            saver.wait()
    return TrainResult(tc.steps, losses, restored_from, straggler_events,
                       params=params, opt_state=opt_state,
                       step_seconds=step_times, resident_bytes=resident,
                       planned_bytes=planned)
