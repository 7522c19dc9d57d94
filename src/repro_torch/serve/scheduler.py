"""Admission + step policy for the continuous-batching serve engine.

Pure host-side scheduling state: which request sits in which decode slot,
which slots are mid-(chunked-)prefill, and how a decode step is batched.
Port of ``repro.serve.scheduler``, near verbatim: pure host code.  The
engine wires the scheduler's decisions into the executor, and tests drive
scheduling through this API instead of poking engine internals.  Its
signals go to the metrics registry as the reference's do: the
``repro_serve_queue_depth`` gauge on every enqueue and admission, and
``repro_serve_admitted_total``.

Bucketed decode (the slot-scaling-cliff fix): decode runs on the smallest
power-of-two *slot bucket* that covers the live slots — the same ladder
shape as the prompt buckets, anchored at 1 (``decode_widths_for``).  A
64-slot engine with 3 live requests decodes a 4-wide batch; the lanes
padding a bucket are distinct *free* slots first (their pool rows are dead
and admission re-initializes them) and the pool's parking rows after that,
so padded lanes can never alias a live slot, a mid-prefill slot, or a
prefix snapshot.

Chunked prefill: an admitted request holds its slot in a *prefilling*
state; each engine step advances every prefilling slot by one chunk, so
long prompts interleave with decode steps and TTFT of concurrent requests
stops being hostage to the longest prompt.  Slots are decodable only once
their prefill is complete.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics

MIN_BUCKET = 8

_QUEUE_DEPTH = obs_metrics.gauge(
    "repro_serve_queue_depth", "pending requests awaiting a decode slot")
_ADMITTED = obs_metrics.counter(
    "repro_serve_admitted_total", "requests admitted into decode slots")


def prompt_buckets_for(max_seq: int,
                       min_bucket: int = MIN_BUCKET) -> Tuple[int, ...]:
    """Default prompt-bucket ladder: powers of two up to ``max_seq``.

    """
    buckets = []
    b = min_bucket
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return tuple(sorted(set(buckets)))


def decode_widths_for(n_slots: int) -> Tuple[int, ...]:
    """Decode-batch bucket ladder: the prompt ladder anchored at width 1."""
    return prompt_buckets_for(n_slots, min_bucket=1)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    generated: List[int] = field(default_factory=list)
    stats: Optional["RequestStats"] = None


@dataclass
class RequestStats:
    rid: int
    prompt_len: int
    arrival_s: float
    first_token_s: float = 0.0
    finish_s: float = 0.0
    n_tokens: int = 0
    stop_reason: str = ""

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    busy_s: float = 0.0            # wall-clock span of engine activity
    decode_steps: int = 0          # batched engine steps
    generated_tokens: int = 0      # actual tokens produced across requests
    occupancy_sum: float = 0.0     # sum over decode steps of live/slots
    requests: List[RequestStats] = field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        """Serving throughput: *generated tokens* (counting every request in
        flight — not engine steps) over engine-busy wall-clock time.

        ``busy_s`` is the span the engine actually spent admitting,
        prefilling and decoding; once prefill chunks interleave with decode
        steps, ``prefill_s + decode_s`` would double-count overlapped work
        conceptually belonging to the same span.  Stats built by hand (no
        measured busy span) fall back to the legacy ``prefill_s +
        decode_s`` denominator so the old accounting keeps working."""
        busy = self.busy_s or (self.prefill_s + self.decode_s)
        return self.generated_tokens / busy if busy else 0.0

    @property
    def occupancy_pct(self) -> float:
        """Mean live-slot occupancy (%) across decode steps."""
        if not self.decode_steps:
            return 0.0
        return 100.0 * self.occupancy_sum / self.decode_steps


@dataclass
class _PrefillState:
    off: int = 0                    # next prompt offset to run
    snap_at: int = 0                # prefix-snapshot boundary (0: none)
    from_prefix: bool = False       # restored from a prefix-cache hit


class SlotState:
    """Per-slot scheduling state (no cache data — that lives in the pool)."""

    __slots__ = ("req", "pos", "last_tok", "rid", "n_tokens", "prefill")

    def __init__(self):
        self.req: Optional[Request] = None
        self.pos = 0          # next cache write index
        self.last_tok = 0
        self.rid = 0
        self.n_tokens = 0     # tokens generated so far (sampling-key index)
        self.prefill: Optional[_PrefillState] = None

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def decoding(self) -> bool:
        return self.req is not None and self.prefill is None


class Scheduler:
    """Slot admission + step policy; owns no device state."""

    def __init__(self, n_slots: int, max_seq: int):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.decode_widths = decode_widths_for(n_slots)
        self.slots = [SlotState() for _ in range(n_slots)]
        self._pending: deque = deque()
        self._rr = 0    # round-robin cursor over prefilling slots

    # -- queue --------------------------------------------------------------

    def enqueue(self, req: Request):
        self._pending.append(req)
        _QUEUE_DEPTH.set(len(self._pending))

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    @property
    def next_arrival_s(self) -> Optional[float]:
        return self._pending[0].stats.arrival_s if self._pending else None

    def admit(self, now: float) -> List[Tuple[int, Request]]:
        """Move arrived pending requests into free slots (FIFO, respecting
        the arrival trace); returns ``(slot_idx, request)`` assignments.
        The engine initializes the slot's pool rows and prefill plan."""
        out: List[Tuple[int, Request]] = []
        while self._pending:
            if self._pending[0].stats.arrival_s > now:
                break
            free = next((i for i, s in enumerate(self.slots)
                         if not s.active), None)
            if free is None:
                break
            req = self._pending.popleft()
            slot = self.slots[free]
            slot.req = req
            slot.pos = 0
            slot.last_tok = 0
            slot.rid = req.stats.rid
            slot.n_tokens = 0
            slot.prefill = _PrefillState()
            out.append((free, req))
        if out:
            _ADMITTED.inc(by=len(out))
            _QUEUE_DEPTH.set(len(self._pending))
        return out

    # -- prefill ------------------------------------------------------------

    def prefilling(self) -> List[int]:
        """Slots mid-prefill, round-robin rotated so interleaved chunking
        shares engine steps fairly across concurrent prompts."""
        idxs = [i for i, s in enumerate(self.slots)
                if s.active and s.prefill is not None]
        if not idxs:
            return idxs
        r = self._rr % len(idxs)
        self._rr += 1
        return idxs[r:] + idxs[:r]

    def prefill_done(self, idx: int, first_token: int):
        """Transition a slot from prefilling to decoding."""
        slot = self.slots[idx]
        slot.prefill = None
        slot.pos = len(slot.req.prompt)
        slot.last_tok = first_token
        slot.n_tokens = 1

    # -- decode batching ----------------------------------------------------

    def decode_lanes(self) -> Tuple[int, List[Optional[int]]]:
        """Bucketed decode batch: ``(n_live, lanes)`` where ``lanes`` is the
        live slots padded to the smallest covering bucket width — first
        with distinct free slots (dead rows), then with ``None`` (the
        pool's parking rows).  Mid-prefill slots are never used as padding:
        their pool rows hold real partial state."""
        live = [i for i, s in enumerate(self.slots) if s.decoding]
        if not live:
            return 0, []
        width = next(w for w in self.decode_widths if w >= len(live))
        free = [i for i, s in enumerate(self.slots) if not s.active]
        lanes: List[Optional[int]] = list(live)
        lanes += free[:width - len(lanes)]
        lanes += [None] * (width - len(lanes))
        return len(live), lanes

    def finish(self, idx: int):
        self.slots[idx].req = None
        self.slots[idx].prefill = None
