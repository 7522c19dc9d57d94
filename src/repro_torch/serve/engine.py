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
buffers without a graph.

Under a mesh (``mesh=``, or ``context.mesh``; a ``DeviceMesh`` from
:mod:`repro_torch.launch.mesh`, one process a rank, every rank running the
same engine on the same requests): each rank holds exactly its
``dist.sharding.leaf_spec`` block of every parameter
(``dist.sharding.shard_params``: ``params`` may lie on the host, and only
each block is copied to the device; or they are already each rank's blocks,
drawn leaf by leaf by ``lm.init_params(mesh=...)``, so that no process
holds the whole model) and its ``page_pool_sharding`` block of
the pool; every rank keeps the whole scheduler, so all agree on every
slot's state.  Slot ``s`` belongs to data rank ``s * D // batch_size`` (D:
the product of the data axes' sizes), and each data rank prefills and
decodes only its slots' lanes, on a decode width common to the data ranks
(the bucket covering the most lanes any of them has) and in prefill rounds
where a data rank with no prompt left runs a parking-row prefill, so every
rank makes the same collectives.  The model runs under the ambient mesh:
its GEMMs shard-mapped (M over data, N over ``model``), attention
head-parallel over ``model`` where the kv heads divide, an RWKV layer's
recurrence head-parallel and a mamba layer's conv and scan
channel-parallel on the pool's ``model`` block of their state (the
``wkv`` heads, the ``conv`` / ``ssm`` inner channels; all of them where
``model`` does not divide), and an MoE layer's
expert GEMMs expert-parallel (each ``model`` rank launches the grouped
kernel over its own experts; E % model != 0 sends them to the ATen route,
counted).  An MoE layer's capacity is per sequence and every prefill is
one slot at its own bucket, so a data rank's routing of a row is the
unsharded engine's and the tokens equal its tokens.  Sampled tokens
are all-gathered over the data axes in slot order, so every scheduler
advances identically; sampling draws from one generator per (request,
step), so the lane grouping moves no draw.  The recurrent blocks' heads
and channels are independent, so a rank's block of the state holds the
unsharded engine's bits.  Admission reads a clock the
ranks agree on (the latest of theirs).  Under a mesh ``batch_size`` must
split over the data ranks (``ValueError``).  With ``prefix_cache`` each
data rank keeps its own snapshots, of its own slots, in its own region of
the pool (:mod:`repro_torch.serve.cache`): every rank keeps every data
rank's index and free lists, so all take the same hit, miss, store and
evict decisions, and only a slot's own ranks copy its rows; a restored
slot resumes its chunked prefill at the snapshot's length.  A data
rank's parking-row prefill runs at the narrowest width :meth:`warm` ran
(the first chunk bucket under chunking) and routes no request, so the
MoE dispatch metrics do not observe it.  Training under a mesh is
``train.loop.run_training(mesh=...)``: the same rules and GEMMs, the
backward through them.

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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_map
from repro_torch.core.context import (ExecContext, resolve_context,
                                      resolve_device)
from repro_torch.dist import collectives as dist_coll
from repro_torch.dist import sharding as dist_sharding
from repro_torch.models import moe
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


def _check_mesh(mesh, batch_size: int, device: torch.device) -> None:
    """What the engine needs of a mesh (module docstring)."""
    d = dist_sharding.data_size(mesh)
    if batch_size % d:
        raise ValueError(f"batch_size={batch_size} does not split over the "
                         f"mesh's {d} data ranks")
    if torch.device(mesh.device_type).type != device.type:
        raise ValueError(f"the mesh computes on {mesh.device_type!r}, the "
                         f"engine on {device.type!r}")


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
                 device: Optional[str | torch.device] = None,
                 mesh=None):
        if cfg.is_encdec:
            raise NotImplementedError(
                "continuous batching does not support encoder-decoder models")
        self.device = resolve_device(device)
        ctx = resolve_context(context, what="Engine", mesh=mesh,
                              _defaults=ExecContext(
                                  backend=cfg.quant.backend,
                                  force_mode=cfg.quant.force_mode))
        self.mesh = mesh = ctx.mesh
        if mesh is not None:
            _check_mesh(mesh, batch_size, self.device)
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
        if mesh is None:
            self.params = tree_map(lambda t: t.to(self.device), params)
        else:
            self.params = dist_sharding.shard_params(params, mesh,
                                                     self.device)
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
            device=self.device, mesh=mesh)
        self.executor = Executor(cfg, self.params, self.pool, self.device,
                                 mesh=mesh)
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

    def _agreed_now(self) -> float:
        """The admission clock: under a mesh the latest of every rank's, so
        all ranks admit the same requests at the same step."""
        now = self._now()
        if self.mesh is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        axes = dist_sharding.axis_names(self.mesh)
        return float(dist_coll.all_reduce(t, self.mesh, axes,
                                          torch.distributed.ReduceOp.MAX)[0])

    def _gather_data(self, vals: np.ndarray) -> np.ndarray:
        """Every data rank's int64 ``vals`` (one length on all),
        concatenated in data-rank order."""
        t = torch.as_tensor(vals, dtype=torch.int64).to(self.device)
        out = dist_coll.all_gather(t, self.mesh,
                                   dist_sharding.data_axes(self.mesh), 0)
        return out.cpu().numpy()

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
            hit_len, hit = self.prefix.lookup(req.prompt, idx)
            if hit:
                self.prefix.restore(idx, req.prompt, hit_len)
                slot.prefill.off = hit_len
                slot.prefill.from_prefix = True

    def _chunk_take(self, idx: int) -> Tuple[int, int]:
        """(tokens, bucket width) of slot ``idx``'s next prefill chunk (the
        whole remaining prompt when chunking is off)."""
        slot = self.scheduler.slots[idx]
        left = len(slot.req.prompt) - slot.prefill.off
        if self.prefill_chunk is None:
            return left, self._bucket(left, self.prompt_buckets)
        take = min(self.prefill_chunk, left)
        return take, self._bucket(take, self._chunk_buckets)

    def _prefill_compute(self, idx: int) -> int:
        """Run slot ``idx``'s next prefill chunk; its first sampled token
        when the chunk completes the prompt, else -1."""
        slot = self.scheduler.slots[idx]
        req, ps = slot.req, slot.prefill
        take, width = self._chunk_take(idx)
        toks = np.zeros((1, width), np.int32)
        toks[0, :take] = req.prompt[ps.off:ps.off + take]   # right-pad
        last = np.array([take - 1], np.int32)
        with obs_trace.span("prefill_chunk", slot=idx, rid=req.stats.rid,
                            off=ps.off, width=width):
            logits = self.executor.prefill(idx, toks, ps.off, last)
            if ps.off + take >= len(req.prompt):
                # prompt complete: the first token from the last chunk's
                # logits at its last real position
                return int(self.executor.sample(
                    self.rng_seed, logits, [req.temperature],
                    [req.stats.rid], [0])[0])
            self._sync()
        return -1

    def _run_prefill_chunk(self, idx: int) -> Optional[Request]:
        """Advance one slot's prefill by one chunk.  Returns the request if
        it finished at admission (a 1-token budget or an instant stop
        token)."""
        t0 = time.monotonic()
        tok = self._prefill_compute(idx)
        self._stats.prefill_s += time.monotonic() - t0
        return self._prefill_advance(idx, tok)

    def _prefill_advance(self, idx: int, tok: int) -> Optional[Request]:
        """The bookkeeping of one prefill chunk of slot ``idx``, ``tok``
        its first token if the chunk completed the prompt."""
        slot = self.scheduler.slots[idx]
        req, ps = slot.req, slot.prefill
        stats = self._stats
        take, _ = self._chunk_take(idx)
        done = ps.off + take >= len(req.prompt)
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
        if self.mesh is not None:
            toks = self._prefill_rounds(idxs)
            for idx in idxs:
                req = self._prefill_advance(idx, toks[idx])
                if req is not None:
                    self._admitted_done.append(req)
            return
        for idx in idxs:
            req = self._run_prefill_chunk(idx)
            if req is not None:
                self._admitted_done.append(req)

    def _prefill_rounds(self, idxs: List[int]) -> Dict[int, int]:
        """Under a mesh: every data rank prefills its own slots of ``idxs``
        one a round (a parking-row prefill where it has none left), and
        the (slot, first token) pairs of each round are all-gathered.
        Returns slot -> first token (-1: prompt not complete)."""
        pool = self.pool
        mine = [i for i in idxs if pool.owns(i)]
        n_rounds = max(sum(1 for i in idxs if pool.owner(i) == d)
                       for d in range(pool.n_data))
        out: Dict[int, int] = {}
        t0 = time.monotonic()
        for r in range(n_rounds):
            if r < len(mine):
                pair = np.array([mine[r], self._prefill_compute(mine[r])])
            else:
                # the narrowest width warm() ran
                w = (self._chunk_buckets or self.prompt_buckets)[0]
                # it serves no request: kept out of the dispatch metrics
                saved = (moe.save_dispatch_metrics()
                         if obs_metrics.enabled() else None)
                self.executor.prefill(None, np.zeros((1, w), np.int32), 0,
                                      np.array([w - 1], np.int32))
                if saved is not None:
                    moe.restore_dispatch_metrics(saved)
                pair = np.array([-1, -1])
            got = self._gather_data(pair).reshape(-1, 2)
            out.update((int(s), int(t)) for s, t in got if s >= 0)
        self._stats.prefill_s += time.monotonic() - t0
        return out

    # -- decode -------------------------------------------------------------

    def _decode_step(self) -> List[Request]:
        n_live, lanes = self.scheduler.decode_lanes()
        if not n_live:
            return []
        live = lanes[:n_live]
        if self.mesh is not None:
            lanes = self._mesh_lanes(live)
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
            if self.mesh is None:
                tok_of = dict(zip(live, nxt))
            else:
                tok_of = self._gather_tokens(lanes, nxt, live)
        dt = time.monotonic() - t0
        stats.decode_s += dt
        stats.decode_steps += 1
        stats.occupancy_sum += n_live / self.batch
        _DECODE_STEP.observe(dt)
        _OCCUPANCY.set(n_live / self.batch)
        finished: List[Request] = []
        for idx in live:                    # in slot order
            slot = slots[idx]
            tok = int(tok_of[idx])
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

    def _mesh_lanes(self, live: List[int]) -> List[Optional[int]]:
        """This data rank's decode lanes: its live slots, padded to the
        width covering the most live slots any data rank has, with its own
        free slots first and its parking rows after."""
        pool, slots = self.pool, self.scheduler.slots
        most = max(sum(1 for i in live if pool.owner(i) == d)
                   for d in range(pool.n_data))
        width = next(w for w in self.scheduler.decode_widths if w >= most)
        lanes: List[Optional[int]] = [i for i in live if pool.owns(i)]
        free = [i for i, s in enumerate(slots)
                if not s.active and pool.owns(i)]
        lanes += free[:width - len(lanes)]
        return lanes + [None] * (width - len(lanes))

    def _gather_tokens(self, lanes, nxt: np.ndarray,
                       live: List[int]) -> Dict[int, int]:
        """Every data rank's sampled tokens, all-gathered over the data
        axes in slot order; slot -> token for the live slots."""
        pool = self.pool
        base = pool.data_rank * pool.slots_per_rank
        mine = np.full((pool.slots_per_rank,), -1, np.int64)
        for lane, idx in enumerate(lanes):
            if idx is not None and idx in live:
                mine[idx - base] = nxt[lane]
        every = self._gather_data(mine)
        return {idx: int(every[idx]) for idx in live}

    # -- step / driver ------------------------------------------------------

    def step(self) -> List[Request]:
        """Admit what fits, advance prefill (every admitted prompt whole, or
        one chunk of one prompt), then run one bucketed decode step.
        Returns the requests that finished, those that finished at
        admission included."""
        t0 = time.monotonic()
        with obs_trace.span("engine_step"):
            for idx, req in self.scheduler.admit(self._agreed_now()):
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
