"""Training loop with fault tolerance: auto-resume, async checkpoints,
deterministic skip-ahead data and a step-time straggler watchdog (port of
``repro.train.loop``, on one device: the reference's mesh argument and
its sharding constraints wait for the distribution item, ROADMAP queue 1
item 4).

``run_training(cfg, tc, data_cfg, hooks, device=...)`` draws the fp32
parameters from a ``torch.Generator`` seeded with ``tc.seed`` (on the
device), resumes from the newest checkpoint under ``tc.ckpt_dir`` when
there is one (params, optimizer state and the data position: batch n is a
pure function of (seed, n)), and runs ``make_train_step`` to ``tc.steps``.
A non-finite loss raises ``FloatingPointError``; ``hooks["inject_fault"]
(step)`` runs after each step (tests raise from it to exercise the
supervised restart).  Checkpoints are saved every ``tc.ckpt_every`` steps
and at the end through an :class:`~repro_torch.train.checkpoint.
AsyncCheckpointer`.  The result also carries the final params and
optimizer state (the reference's jitted loop keeps them on its mesh).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.context import ExecContext, resolve_device
from repro_torch.data.pipeline import DataConfig, DataIterator
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


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run_training(cfg: ModelConfig, tc: TrainConfig,
                 data_cfg: Optional[DataConfig] = None,
                 hooks: Optional[Dict[str, Callable]] = None, *,
                 device=None) -> TrainResult:
    hooks = hooks or {}
    dev = resolve_device(device)
    ctx = tc.context or ExecContext()
    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        frontend_tokens=cfg.frontend_tokens, encdec=cfg.is_encdec,
        seed=tc.seed)

    with ctx.activate():
        gen = torch.Generator(dev).manual_seed(tc.seed)
        params = lm.init_params(gen, cfg, device=dev)
        opt_state = optim.init(params)

        restored_from = None
        if tc.ckpt_dir:
            last = ckpt.latest_step(tc.ckpt_dir)
            if last is not None:
                _, (params, opt_state), _ = ckpt.load(
                    tc.ckpt_dir, (params, opt_state), step=last)
                restored_from = last
                log.info("resumed from step %d", last)

        start_step = int(opt_state.step)
        train_step = steps_mod.make_train_step(cfg, tc.optimizer)
        it = DataIterator(data_cfg, start_step=start_step)   # skip-ahead
        saver = (ckpt.AsyncCheckpointer(tc.ckpt_dir, keep=tc.ckpt_keep)
                 if tc.ckpt_dir else None)

        losses: Dict[int, float] = {}
        step_times = []
        straggler_events = 0
        for step in range(start_step, tc.steps):
            batch = _to_device(next(it), dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch)
            if "inject_fault" in hooks:
                hooks["inject_fault"](step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step_times.append(dt)
            if len(step_times) > 5:
                median = float(np.median(step_times[-50:]))
                if dt > tc.straggler_factor * median:
                    straggler_events += 1
                    log.warning("straggler: step %d took %.3fs (median "
                                "%.3fs)", step, dt, median)
            if not np.isfinite(loss):
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
                       step_seconds=step_times)
