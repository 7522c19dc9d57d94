"""Continuous-batching serve engine (port of ``repro.serve.engine``): the
orchestrator over the scheduler, the paged KV pool and the executor.

Prompts are right-padded to power-of-two buckets with ``pad_mask`` and
``last_idx`` threaded into :func:`repro_torch.models.lm.prefill`; decode
runs on the smallest power-of-two bucket covering the live slots with a
per-slot position vector.  Admission order and per-(request, step) sampling
seeds make the output token-identical to sequential single-request
generation, whatever the slot count and bucket width.

Every quantized GEMM goes through the CUDA kernels (the context's
``"cuda"`` backend): the fused kernel, or under a tuning table
(``ExecContext(tuning_table=...)``, installed process-wide as the reference
does) the plan the table picks within the same numerics, so the tokens do
not change.  The engine runs on CUDA unless ``device="cpu"`` is passed;
then each GEMM runs the kernels' plain PyTorch versions.  Chunked prefill
(``prefill_chunk``), prefix sharing (``prefix_cache``) and meshes are not
ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.context import ExecContext, resolve_device
from repro_torch.serve.cache import PagedCachePool, default_page_size
from repro_torch.serve.executor import Executor
from repro_torch.serve.scheduler import (MIN_BUCKET, Request, RequestStats,
                                         Scheduler, ServeStats, SlotState,
                                         prompt_buckets_for)

__all__ = ["Engine", "Request", "RequestStats", "ServeStats", "SlotState",
           "prompt_buckets_for", "MIN_BUCKET"]

Params = Any


class Engine:
    """Continuous-batching engine over ``batch_size`` decode slots."""

    def __init__(self, cfg, params: Params, max_seq: int = 512,
                 batch_size: int = 4, rng_seed: int = 0,
                 context: Optional[ExecContext] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 device: Optional[str | torch.device] = None):
        if prefill_chunk is not None or prefix_cache:
            raise NotImplementedError(
                "chunked prefill and prefix sharing are not ported yet "
                "(ROADMAP: serve/cache.PrefixCache and chunked prefill)")
        self.device = resolve_device(device)
        ctx = context if context is not None else ExecContext(
            backend=cfg.quant.backend, force_mode=cfg.quant.force_mode)
        if (ctx.backend != cfg.quant.backend
                or ctx.force_mode != cfg.quant.force_mode):
            cfg = cfg.with_quant(dataclasses.replace(
                cfg.quant, backend=ctx.backend, force_mode=ctx.force_mode))
        if ctx.tuning_table is not None:
            # Process-wide, as the reference installs it: every GEMM of the
            # model resolves its plan against it.  Tables are
            # numerics-pinned: they change speed, never tokens.
            from repro_torch.tune.table import set_active_table
            set_active_table(ctx.tuning_table)
        self.context = ctx
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = max_seq
        self.batch = batch_size
        self.rng_seed = rng_seed
        self.prompt_buckets = prompt_buckets_for(max_seq)
        self.page_size = page_size = default_page_size(max_seq)

        self.scheduler = Scheduler(batch_size, max_seq)
        self.pool = PagedCachePool(cfg, batch_size, max_seq, page_size,
                                   device=self.device)
        self.executor = Executor(cfg, self.params, self.pool, self.device)

        self._next_rid = 0
        self._clock0 = time.monotonic()
        self._stats = ServeStats()
        self._admitted_done: List[Request] = []

    # -- infrastructure -----------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._clock0

    def _sync(self) -> None:
        """Wait for the device, so host timers measure finished work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket "
                         f"{self.prompt_buckets[-1]}")

    # -- scheduling ---------------------------------------------------------

    def submit(self, req: Request, arrival_s: Optional[float] = None):
        """Enqueue a request; it is admitted when a slot frees up."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new({req.max_new_tokens}) "
                f"exceeds max_seq={self.max_seq}")
        if len(req.prompt) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds max prompt "
                f"bucket {self.prompt_buckets[-1]}")
        rid = self._next_rid
        self._next_rid += 1
        req.stats = RequestStats(
            rid=rid, prompt_len=len(req.prompt),
            arrival_s=self._now() if arrival_s is None else arrival_s)
        req.generated = []
        self.scheduler.enqueue(req)

    @property
    def num_active(self) -> int:
        return self.scheduler.num_active

    @property
    def num_pending(self) -> int:
        return self.scheduler.num_pending

    def _finish(self, idx: int, reason: str):
        req = self.scheduler.slots[idx].req
        req.stats.finish_s = self._now()
        req.stats.n_tokens = len(req.generated)
        req.stats.stop_reason = reason
        self._stats.requests.append(req.stats)
        self.scheduler.finish(idx)

    def _check_done(self, slot: SlotState, tok: int) -> Optional[str]:
        req = slot.req
        if tok in req.stop_tokens:
            return "stop_token"
        if len(req.generated) >= req.max_new_tokens:
            return "length"
        if slot.pos >= self.max_seq:
            return "max_seq"
        return None

    # -- prefill ------------------------------------------------------------

    def _run_prefill(self, idx: int) -> Optional[Request]:
        """Prefill one admitted slot's whole prompt and sample its first
        token.  Returns the request if it finished at admission."""
        slot = self.scheduler.slots[idx]
        req = slot.req
        # recurrent state is not masked by position: a reused slot must not
        # start from the previous request's state
        self.pool.zero_slot_state(idx)
        plen = len(req.prompt)
        width = self._bucket(plen)
        toks = np.zeros((1, width), np.int32)
        toks[0, :plen] = req.prompt                         # right-pad
        last = np.array([plen - 1], np.int32)
        stats = self._stats
        t0 = time.monotonic()
        logits = self.executor.prefill(idx, toks, 0, last)
        tok = int(self.executor.sample(
            self.rng_seed, logits, [req.temperature], [req.stats.rid],
            [0])[0])
        stats.prefill_s += time.monotonic() - t0
        self.scheduler.prefill_done(idx, tok)
        req.generated.append(tok)
        req.stats.first_token_s = self._now()
        stats.generated_tokens += 1
        reason = self._check_done(slot, tok)
        if reason is not None:      # e.g. max_new_tokens=1 or instant EOS
            self._finish(idx, reason)
            return req
        return None

    # -- decode -------------------------------------------------------------

    def _decode_step(self) -> List[Request]:
        n_live, lanes = self.scheduler.decode_lanes()
        if not n_live:
            return []
        slots = self.scheduler.slots
        toks = np.array([slots[j].last_tok if j is not None else 0
                         for j in lanes], np.int32)
        # park free/padding lanes at a harmless position (their writes land
        # in dead slot rows or the pool's parking pages)
        pos = np.array([min(slots[j].pos, self.max_seq - 1)
                        if j is not None else 0 for j in lanes], np.int32)
        temps = [slots[j].req.temperature
                 if j is not None and slots[j].decoding else 0.0
                 for j in lanes]
        rids = [slots[j].rid if j is not None else 0 for j in lanes]
        steps = [slots[j].n_tokens if j is not None else 0 for j in lanes]
        stats = self._stats
        t0 = time.monotonic()
        logits = self.executor.decode(lanes, toks, pos)
        nxt = self.executor.sample(self.rng_seed, logits, temps, rids, steps)
        stats.decode_s += time.monotonic() - t0
        stats.decode_steps += 1
        stats.occupancy_sum += n_live / self.batch
        finished: List[Request] = []
        for lane, idx in enumerate(lanes[:n_live]):     # live lanes first
            slot = slots[idx]
            tok = int(nxt[lane])
            slot.pos += 1
            slot.last_tok = tok
            slot.n_tokens += 1
            slot.req.generated.append(tok)
            stats.generated_tokens += 1
            reason = self._check_done(slot, tok)
            if reason is not None:
                req = slot.req
                self._finish(idx, reason)
                finished.append(req)
        return finished

    # -- step / driver ------------------------------------------------------

    def step(self) -> List[Request]:
        """Admit what fits, prefill the admitted prompts, then run one
        bucketed decode step.  Returns the requests that finished."""
        t0 = time.monotonic()
        self.scheduler.admit(self._now())
        for idx in self.scheduler.prefilling():
            req = self._run_prefill(idx)
            if req is not None:
                self._admitted_done.append(req)
        finished = self._admitted_done
        self._admitted_done = []
        finished += self._decode_step()
        self._stats.busy_s += time.monotonic() - t0
        return finished

    def generate(self, requests: List[Request],
                 arrival_s: Optional[Sequence[float]] = None) -> ServeStats:
        """Serve ``requests`` to completion; fills ``req.generated`` and
        returns the run's :class:`ServeStats`.  ``arrival_s`` (seconds from
        now) replays an arrival trace."""
        self._stats = ServeStats()
        self._clock0 = time.monotonic()
        if arrival_s is None:
            for r in requests:
                self.submit(r)
        else:
            order = sorted(range(len(requests)), key=lambda i: arrival_s[i])
            for i in order:
                self.submit(requests[i], arrival_s=float(arrival_s[i]))
        sched = self.scheduler
        while sched.num_pending or sched.num_active:
            if not sched.num_active and sched.num_pending:
                wait = sched.next_arrival_s - self._now()
                if wait > 0:
                    time.sleep(min(wait, 0.01))
            self.step()
        self._sync()
        return self._stats
