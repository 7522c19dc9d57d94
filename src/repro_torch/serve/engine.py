"""Continuous-batching serve engine (port of ``repro.serve.engine``): the
orchestrator over the scheduler, the paged KV pool and the executor.

  * :mod:`repro_torch.serve.scheduler` — admission and step policy.  Decode
    runs on the smallest power-of-two bucket covering the live slots, one
    CUDA graph per bucket width (:mod:`repro_torch.serve.executor`), which
    :meth:`Engine.warm` captures ahead of a measured run.  With
    ``prefill_chunk=`` long prompts prefill in fixed-size chunks, one chunk
    an engine step, interleaved with decode steps.
  * :mod:`repro_torch.serve.cache` — the paged K/V and recurrent-state pool
    with optional prompt-prefix sharing (``prefix_cache=True``): a repeated
    prompt prefix restores a page and state snapshot instead of being
    computed again, exact against a cold prefill.
  * :mod:`repro_torch.serve.executor` — gather, model and scatter over the
    pool.

Prompts (or chunks) are right-padded to power-of-two buckets with
``pad_mask`` and ``last_idx`` threaded into
:func:`repro_torch.models.lm.prefill` (``start=`` resumes a chunk at its
offset); decode runs a per-slot position vector.  Admission order and
per-(request, step) sampling seeds make the output token-identical to
sequential single-request generation, whatever the slot count, bucket
width, prefill chunking and prefix-cache hits.

Every quantized GEMM goes through the CUDA kernels (the context's
``"cuda"`` backend): the fused kernel, or under a tuning table
(``ExecContext(tuning_table=...)``, installed process-wide as the reference
does, before any graph is captured) the plan the table picks within the
same numerics, so the tokens do not change.  Parameters may hold
pre-quantized weight records (:func:`repro_torch.quant.prequant.prequantize`).
As in the reference, an encoder-decoder model is refused
(``NotImplementedError``) and a vision model is served text-only: a
request carries no image, and the ragged prefill refuses a vision prefix.
The engine runs on CUDA unless ``device="cpu"`` is passed; then each GEMM
runs the kernels' plain PyTorch versions and decode runs its static
buffers without a graph.  Meshes are not ported yet.

Observability (:mod:`repro_torch.obs`, enabled before the engine is built
and warmed, as the launcher's ``--metrics-out`` / ``--trace-out`` do): the
reference's serve instruments — ``repro_serve_ttft_seconds``,
``repro_serve_decode_step_seconds`` (taken after the sampled tokens reach
the host, so device-complete), ``repro_serve_occupancy`` and
``repro_serve_finished_total`` — and spans ``request`` (async, submit to
finish), ``prefill_chunk``, ``decode_step`` and ``engine_step``.  All are
host-side around the executor's calls; disabled (the default), each site
costs a flag test and no token changes either way.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.context import ExecContext, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.cache import (PagedCachePool, PrefixCache,
                                     default_page_size)
from repro_torch.serve.executor import Executor
from repro_torch.serve.scheduler import (MIN_BUCKET, Request, RequestStats,
                                         Scheduler, ServeStats, SlotState,
                                         prompt_buckets_for)

__all__ = ["Engine", "Request", "RequestStats", "ServeStats", "SlotState",
           "prompt_buckets_for", "MIN_BUCKET"]

Params = Any

_TTFT = obs_metrics.histogram(
    "repro_serve_ttft_seconds", "arrival to first token, per request")
_DECODE_STEP = obs_metrics.histogram(
    "repro_serve_decode_step_seconds", "wall time of one bucketed decode step")
_OCCUPANCY = obs_metrics.gauge(
    "repro_serve_occupancy", "live slots / total slots at the last decode step")
_FINISHED = obs_metrics.counter(
    "repro_serve_finished_total", "finished requests by stop reason",
    labels=("reason",))


class Engine:
    """Continuous-batching engine over ``batch_size`` decode slots."""

    def __init__(self, cfg, params: Params, max_seq: int = 512,
                 batch_size: int = 4, rng_seed: int = 0,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 context: Optional[ExecContext] = None,
                 page_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_snapshots: int = 4,
                 device: Optional[str | torch.device] = None):
        if cfg.is_encdec:
            raise NotImplementedError(
                "continuous batching does not support encoder-decoder models")
        self.device = resolve_device(device)
        ctx = context if context is not None else ExecContext(
            backend=cfg.quant.backend, force_mode=cfg.quant.force_mode)
        if (ctx.backend != cfg.quant.backend
                or ctx.force_mode != cfg.quant.force_mode):
            cfg = cfg.with_quant(dataclasses.replace(
                cfg.quant, backend=ctx.backend, force_mode=ctx.force_mode))
        if ctx.tuning_table is not None:
            # Process-wide, as the reference installs it, before any decode
            # graph is captured: every GEMM of the model resolves its plan
            # against it.  Tables are numerics-pinned: they change speed,
            # never tokens.
            from repro_torch.tune.table import set_active_table
            set_active_table(ctx.tuning_table)
        self.context = ctx
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = max_seq
        self.batch = batch_size
        self.rng_seed = rng_seed
        if prompt_buckets is None:
            prompt_buckets = prompt_buckets_for(max_seq)
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))

        # -- chunked prefill / paging knobs ---------------------------------
        if page_size is None:
            page_size = default_page_size(max_seq)
        if max_seq % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={max_seq}")
        if prefix_cache and prefill_chunk is None:
            # a prefix restore resumes prefill mid-prompt, which needs the
            # chunked entry; pick a chunk covering at least one page
            prefill_chunk = max(page_size, MIN_BUCKET)
        if prefill_chunk is not None and (
                prefill_chunk < MIN_BUCKET
                or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk={prefill_chunk} must be a power "
                             f"of two >= {MIN_BUCKET}")
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self._chunk_buckets = (prompt_buckets_for(prefill_chunk)
                               if prefill_chunk is not None else None)

        self.scheduler = Scheduler(batch_size, max_seq)
        self.pool = PagedCachePool(
            cfg, batch_size, max_seq, page_size,
            snapshot_slots=prefix_snapshots if prefix_cache else 0,
            device=self.device)
        self.executor = Executor(cfg, self.params, self.pool, self.device)
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix = PrefixCache(
                self.pool, math.lcm(page_size, prefill_chunk, MIN_BUCKET))

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

    def _bucket(self, n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket "
                         f"{buckets[-1]}")

    def n_traces(self) -> Dict[str, int]:
        """Steady-state monitoring: ``decode`` counts one CUDA graph per
        decode-bucket width (on the CPU, one static entry), ``prefill``
        the prefill chunk or bucket widths run so far."""
        return self.executor.n_traces()

    def warm(self) -> None:
        """Capture every decode-bucket width's graph and run every prefill
        chunk or bucket width once, so that a measured run sees the steady
        state.  Warm calls run on the pool's parking rows only — no slot
        state is touched — and need an idle engine."""
        if self.scheduler.num_active or self.scheduler.num_pending:
            raise RuntimeError("warm() requires an idle engine")
        for w in self.scheduler.decode_widths:
            z = np.zeros((w,), np.int32)
            logits = self.executor.decode([None] * w, z, z)
            self.executor.sample(self.rng_seed, logits, [0.0] * w, z, z)
        for w in self._chunk_buckets or self.prompt_buckets:
            toks = np.zeros((1, w), np.int32)
            logits = self.executor.prefill(None, toks, 0,
                                           np.array([w - 1], np.int32))
            self.executor.sample(self.rng_seed, logits, [0.0], [0], [0])
        self._sync()

    # -- scheduling ---------------------------------------------------------

    def submit(self, req: Request, arrival_s: Optional[float] = None):
        """Enqueue a request; it is admitted when a slot frees up."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new({req.max_new_tokens}) "
                f"exceeds max_seq={self.max_seq}")
        if self.prefill_chunk is None \
                and len(req.prompt) > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds max prompt "
                f"bucket {self.prompt_buckets[-1]}")
        rid = self._next_rid
        self._next_rid += 1
        req.stats = RequestStats(
            rid=rid, prompt_len=len(req.prompt),
            arrival_s=self._now() if arrival_s is None else arrival_s)
        req.generated = []
        obs_trace.begin_async("request", rid, prompt_len=len(req.prompt),
                              max_new=req.max_new_tokens)
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
        _FINISHED.inc(reason)
        obs_trace.end_async("request", req.stats.rid, reason=reason,
                            n_tokens=req.stats.n_tokens)
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

    def _init_slot(self, idx: int, req: Request) -> None:
        """Initialize an admitted slot's pool rows and prefill plan: zero
        its recurrent state (a reused slot must not start from the previous
        request's), then restore the longest cached prompt prefix."""
        slot = self.scheduler.slots[idx]
        self.pool.zero_slot_state(idx)
        if self.prefix is not None:
            slot.prefill.snap_at = self.prefix.boundary_for(len(req.prompt))
            hit_len, hit = self.prefix.lookup(req.prompt)
            if hit:
                self.prefix.restore(idx, req.prompt, hit_len)
                slot.prefill.off = hit_len
                slot.prefill.from_prefix = True

    def _run_prefill_chunk(self, idx: int) -> Optional[Request]:
        """Advance one slot's prefill by one chunk (the whole remaining
        prompt when chunking is off).  Returns the request if it finished
        at admission (a 1-token budget or an instant stop token)."""
        slot = self.scheduler.slots[idx]
        req, ps = slot.req, slot.prefill
        plen = len(req.prompt)
        if self.prefill_chunk is None:
            take = plen - ps.off
            width = self._bucket(take, self.prompt_buckets)
        else:
            take = min(self.prefill_chunk, plen - ps.off)
            width = self._bucket(take, self._chunk_buckets)
        toks = np.zeros((1, width), np.int32)
        toks[0, :take] = req.prompt[ps.off:ps.off + take]   # right-pad
        last = np.array([take - 1], np.int32)
        stats = self._stats
        t0 = time.monotonic()
        with obs_trace.span("prefill_chunk", slot=idx, rid=req.stats.rid,
                            off=ps.off, width=width):
            logits = self.executor.prefill(idx, toks, ps.off, last)
            done = ps.off + take >= plen
            if done:
                # prompt complete: the first token from the last chunk's
                # logits at its last real position
                tok = int(self.executor.sample(
                    self.rng_seed, logits, [req.temperature],
                    [req.stats.rid], [0])[0])
            else:
                self._sync()
        stats.prefill_s += time.monotonic() - t0
        ps.off += take
        if not done:
            # a snapshot boundary lies before the prompt's last token
            if self.prefix is not None and ps.off == ps.snap_at:
                self.prefix.store(idx, req.prompt, ps.snap_at)
            return None
        self.scheduler.prefill_done(idx, tok)
        req.generated.append(tok)
        req.stats.first_token_s = self._now()
        _TTFT.observe(req.stats.ttft_s)
        stats.generated_tokens += 1
        reason = self._check_done(slot, tok)
        if reason is not None:      # e.g. max_new_tokens=1 or instant EOS
            self._finish(idx, reason)
            return req
        return None

    def _prefill_step(self) -> None:
        """Prefill policy for one engine step: with chunking off, complete
        every admitted prompt; with chunking on, advance one prefilling
        slot by one chunk, so prompts interleave with decode steps."""
        idxs = self.scheduler.prefilling()
        if self.prefill_chunk is not None:
            idxs = idxs[:1]
        for idx in idxs:
            req = self._run_prefill_chunk(idx)
            if req is not None:
                self._admitted_done.append(req)

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
        with obs_trace.span("decode_step", n_live=n_live, width=len(lanes)):
            logits = self.executor.decode(lanes, toks, pos)
            nxt = self.executor.sample(self.rng_seed, logits, temps, rids,
                                       steps)
        dt = time.monotonic() - t0
        stats.decode_s += dt
        stats.decode_steps += 1
        stats.occupancy_sum += n_live / self.batch
        _DECODE_STEP.observe(dt)
        _OCCUPANCY.set(n_live / self.batch)
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
        """Admit what fits, advance prefill (every admitted prompt whole, or
        one chunk of one prompt), then run one bucketed decode step.
        Returns the requests that finished, those that finished at
        admission included."""
        t0 = time.monotonic()
        with obs_trace.span("engine_step"):
            for idx, req in self.scheduler.admit(self._now()):
                self._init_slot(idx, req)
            self._prefill_step()
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
