"""Paged KV / recurrent-state pool and prompt-prefix sharing for the serve
engine (port of ``repro.serve.cache``).

Every cache leaf lives in a pool with a row dimension at axis 1, and the
mapping from decode slots to pool rows is data, not layout:

  * attention K/V leaves are split into fixed-size **pages** of
    ``page_size`` tokens: pool layout ``(n_periods, n_pages, page, K, D)``,
    slot -> pages through a ``(n_slots, pages_per_slot)`` page table.
  * recurrent leaves (rwkv shift/wkv) are a single state row per slot:
    pool layout ``(n_periods, n_states, ...)``, slot -> row through a
    ``(n_slots,)`` state table.

Beyond the slot rows the pool keeps

  * a **snapshot region** (``snapshot_slots`` extra slots' worth of pages
    and state rows) backing :class:`PrefixCache` prompt-prefix snapshots,
    allocated and freed through explicit free lists, and
  * one **parking** row set: decode lanes that pad a bucketed batch beyond
    the free-slot supply gather from (and scatter garbage into) the parking
    rows, so padded lanes never touch a live slot or a snapshot.

Stale K/V is masked by position, never zeroed; recurrent state is not
masked, so the engine zeroes a slot's state rows
(:meth:`PagedCachePool.zero_slot_state`) before it prefills a new request
there.  Every operation updates the pool tensors in place: their addresses
never change, which is what lets the executor's CUDA graphs read and write
them.

Under a mesh (``mesh=``, a ``DeviceMesh``) the pool follows the
reference's ``page_pool_sharding``: the page and state-row axis is split
over the data axes and attention K/V's kv-head axis over ``model`` where
it divides (``dist.sharding.CACHE_MODEL_AXES``), and each rank allocates
only its block.  Slots split over the data ranks (slot ``s`` belongs to
data rank ``s * D // n_slots``), and each data shard holds its own slots'
pages and state rows and its own parking set, so every page a rank's
lanes gather lies in its own block: ``n_pages = D * (n_slots / D +
snapshot_slots + 1) * pages_per_slot`` (the reference rounds ``(n_slots +
snapshot_slots + 1) * pages_per_slot`` up to a multiple of D and shares
one parking set, which its cross-shard gathers can read and a rank's
local gather cannot).  Page and state tables hold global row numbers;
:meth:`PagedCachePool.lane_rows` returns the rank's local ones.

A prefix snapshot lives on its slot's data rank: it is taken from the
slot's rows into that data rank's snapshot region and restored only into
that data rank's slots.  Every rank runs the whole scheduler, so every
rank keeps the free lists of every data rank's snapshot region and
:class:`PrefixCache` keeps one index a data rank, and all of them take
the same hit, miss, store and evict decisions; only the owner's ranks
copy rows, each its block of them (its ``model`` block of the K/V heads
and of the ``wkv`` / ``conv`` / ``ssm`` state).

Prefix sharing is copy-on-reference: a snapshot stores a copy of the slot's
first ``L / page_size`` pages plus its recurrent state row captured exactly
at position ``L`` (a chunk boundary, so the state is exact), and a hit
copies the snapshot back into the new slot's rows before prefill resumes at
offset ``L``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import sharding as dist_sharding
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics

# Prefix-cache traffic (host-side; PrefixCache also keeps its own hits /
# misses ints for stats() — the counter is the scrapeable form).
_PREFIX_EVENTS = obs_metrics.counter(
    "repro_serve_prefix_cache_total",
    "prompt-prefix cache events (hit/miss/store/evict)",
    labels=("event",))

# Cache leaves that carry a per-token Smax axis and therefore page.
PAGED_LEAVES = ("k", "v")

Handle = Tuple[Tuple[int, ...], int]
# a prefix index: prompt prefix -> (its snapshot's handle, its length)
_Index = "OrderedDict[Tuple[int, ...], Tuple[Handle, int]]"


def default_page_size(max_seq: int, preferred: int = 64) -> int:
    """Largest power of two <= ``preferred`` dividing ``max_seq``."""
    p = preferred
    while p > 1 and max_seq % p:
        p //= 2
    return p


class PagedCachePool:
    """Fixed-size page and state-row pools, slot tables and free lists."""

    def __init__(self, cfg, n_slots: int, max_seq: int, page_size: int, *,
                 snapshot_slots: int = 0, device=None, mesh=None):
        if max_seq % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={max_seq}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = pps = max_seq // page_size
        self.mesh = mesh
        n_data, me = 1, 0
        if mesh is not None:
            n_data = dist_sharding.data_size(mesh)
            me = dist_sharding.axes_index(
                mesh, dist_sharding.data_axes(mesh))[0]
            if n_slots % n_data:
                raise ValueError(f"{n_slots} slots do not split over "
                                 f"{n_data} data ranks")
        self.n_data, self.data_rank = n_data, me
        self.slots_per_rank = per = n_slots // n_data
        # each data shard: its slots' rows, its snapshot region and one
        # slot's worth of parking rows (padded decode lanes land there)
        self.shard_pages = (per + snapshot_slots + 1) * pps
        self.shard_states = per + snapshot_slots + 1
        self.n_pages = n_data * self.shard_pages
        self.n_states = n_data * self.shard_states
        shapes = lm.init_cache(cfg, 1, max_seq, device="meta")
        self.global_shapes: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        for pos, leaves in shapes.items():
            self.global_shapes[pos] = {}
            for name, leaf in leaves.items():
                if name in PAGED_LEAVES:
                    shape = ((leaf.shape[0], self.n_pages, page_size)
                             + tuple(leaf.shape[3:]))
                else:
                    shape = (leaf.shape[0], self.n_states) + tuple(
                        leaf.shape[2:])
                self.global_shapes[pos][name] = shape
        self.sharding = None
        if mesh is not None:
            self.sharding = dist_sharding.page_pool_sharding(
                {pos: {n: torch.empty(sh, device="meta")
                       for n, sh in leaves.items()}
                 for pos, leaves in self.global_shapes.items()}, mesh)
        self.pools: Dict[str, Dict[str, torch.Tensor]] = {}
        for pos, leaves in shapes.items():
            self.pools[pos] = {}
            for name, leaf in leaves.items():
                shape = self.global_shapes[pos][name]
                if mesh is not None:
                    shape = dist_sharding.local_block(
                        torch.empty(shape, device="meta"),
                        self.sharding[pos][name], mesh).shape
                self.pools[pos][name] = torch.zeros(shape, dtype=leaf.dtype,
                                                    device=device)
        # Slot rows are fixed for the engine's lifetime; the snapshot
        # region cycles through the free lists.
        self.page_table = np.stack([
            self._page_base(s // per)
            + np.arange((s % per) * pps, (s % per + 1) * pps)
            for s in range(n_slots)]).astype(np.int64).reshape(n_slots, pps)
        base = self._page_base(me)
        self.parking_pages = np.arange(base + per * pps,
                                       base + (per + 1) * pps,
                                       dtype=np.int64)
        self.state_table = np.array(
            [(s // per) * self.shard_states + s % per
             for s in range(n_slots)], np.int64)
        self.parking_state = self._state_base(me) + per
        # each data rank's free snapshot rows (every rank keeps them all)
        self._free_pages: List[List[int]] = [list(range(
            self._page_base(d) + (per + 1) * pps,
            self._page_base(d) + self.shard_pages)) for d in range(n_data)]
        self._free_states: List[List[int]] = [list(range(
            self._state_base(d) + per + 1,
            self._state_base(d) + self.shard_states)) for d in range(n_data)]

    def _page_base(self, data_rank: int) -> int:
        return data_rank * self.shard_pages

    def _state_base(self, data_rank: int) -> int:
        return data_rank * self.shard_states

    def owner(self, slot: int) -> int:
        """The data rank whose shard holds ``slot``'s rows."""
        return slot // self.slots_per_rank

    def owns(self, slot: int) -> bool:
        return self.owner(slot) == self.data_rank

    def _leaves(self):
        for leaves in self.pools.values():
            yield from leaves.items()

    def zero_slot_state(self, slot: int) -> None:
        """Zero the slot's state row in every recurrent pool (slot
        (re)init); K/V pages are left as they are."""
        if not self.owns(slot):
            return
        row = int(self.state_table[slot]) - self._state_base(self.data_rank)
        for name, pool in self._leaves():
            if name not in PAGED_LEAVES:
                pool[:, row].zero_()

    def _copy_rows(self, src_pages, dst_pages, src_state: int,
                   dst_state: int) -> None:
        """Copy page rows and one state row (snapshot take / restore), all
        of them this data rank's, given by their global numbers."""
        dev = next(iter(self._leaves()))[1].device
        base = self._page_base(self.data_rank)
        src = torch.as_tensor(np.asarray(src_pages, np.int64) - base,
                              device=dev)
        dst = torch.as_tensor(np.asarray(dst_pages, np.int64) - base,
                              device=dev)
        sbase = self._state_base(self.data_rank)
        for name, pool in self._leaves():
            if name in PAGED_LEAVES:
                pool[:, dst] = pool[:, src]
            else:
                pool[:, dst_state - sbase] = pool[:, src_state - sbase]

    def take_snapshot(self, slot: int, n_pages: int) -> Optional[Handle]:
        """Allocate snapshot rows in the slot's data rank's region and copy
        the slot's first ``n_pages`` pages and its state row into them (on
        that data rank's ranks; the others only allocate); returns
        ``(page_rows, state_row)`` or None when the region is exhausted
        (the caller evicts and retries)."""
        pages = self._free_pages[self.owner(slot)]
        states = self._free_states[self.owner(slot)]
        if len(pages) < n_pages or not states:
            return None
        rows = tuple(pages.pop(0) for _ in range(n_pages))
        srow = states.pop(0)
        if self.owns(slot):
            self._copy_rows(self.page_table[slot, :n_pages], rows,
                            int(self.state_table[slot]), srow)
        return rows, srow

    def restore_snapshot(self, slot: int, handle: Handle) -> None:
        """Copy-on-reference: snapshot rows -> the slot's own rows (a
        snapshot of the slot's data rank, copied on its ranks)."""
        rows, srow = handle
        if self.owns(slot):
            self._copy_rows(rows, self.page_table[slot, :len(rows)], srow,
                            int(self.state_table[slot]))

    def release_snapshot(self, handle: Handle) -> None:
        rows, srow = handle
        d = srow // self.shard_states
        self._free_pages[d].extend(rows)
        self._free_states[d].append(srow)

    @property
    def n_free_pages(self) -> int:
        """Free snapshot pages, over every data rank's region."""
        return sum(len(p) for p in self._free_pages)

    @property
    def n_free_states(self) -> int:
        """Free snapshot state rows, over every data rank's region."""
        return sum(len(s) for s in self._free_states)

    def lane_rows(self, lane_slots: Sequence[Optional[int]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(page rows (W, pps), state rows (W,)) for a decode/prefill lane
        list; ``None`` entries map to the parking rows.  Rows are this
        rank's local ones: under a mesh every lane slot must be one of
        this data rank's."""
        foreign = [i for i in lane_slots if i is not None and not self.owns(i)]
        if foreign:
            raise ValueError(f"slots {foreign} belong to other data ranks "
                             f"than {self.data_rank}")
        prows = np.stack([self.page_table[i] if i is not None
                          else self.parking_pages for i in lane_slots])
        srows = np.array([self.state_table[i] if i is not None
                          else self.parking_state for i in lane_slots],
                         np.int64)
        return (prows - self._page_base(self.data_rank),
                srows - self._state_base(self.data_rank))


class PrefixCache:
    """LRU prompt-prefix snapshots over a :class:`PagedCachePool`.

    Keys are ``tuple(prompt[:L])`` with ``L`` a multiple of ``align``
    (the lcm of page size, prefill chunk and the smallest bucket, so a
    snapshot sits on a page and a chunk boundary and the recurrent state is
    captured exactly).  One index a data rank of the pool (one without a
    mesh), each of at most ``max_entries`` snapshots in its data rank's
    region: a slot looks up, restores and stores in its owner's index
    alone.
    """

    def __init__(self, pool: PagedCachePool, align: int,
                 max_entries: int = 16):
        self.pool = pool
        self.align = align
        self.max_entries = max_entries
        self._indexes: List[_Index] = [OrderedDict()
                                       for _ in range(pool.n_data)]
        self._hits = [0] * pool.n_data
        self._misses = [0] * pool.n_data

    @property
    def hits(self) -> int:
        return sum(self._hits)

    @property
    def misses(self) -> int:
        return sum(self._misses)

    def boundary_for(self, prompt_len: int) -> int:
        """Longest snapshot boundary usable for this prompt (0: none).  At
        least one token must remain to prefill (the first sampled token
        comes from the prefill logits), hence ``<= prompt_len - 1``."""
        return ((prompt_len - 1) // self.align) * self.align \
            if prompt_len > self.align else 0

    def lookup(self, prompt: Sequence[int], slot: int) -> Tuple[int, bool]:
        """Longest prefix of ``prompt`` cached in ``slot``'s data rank's
        index (without a mesh, the one index); restores nothing itself.
        Returns ``(L, hit)`` with ``L == 0`` on a miss."""
        d = self.pool.owner(slot)
        entries = self._indexes[d]
        n = self.boundary_for(len(prompt))
        while n > 0:
            key = tuple(prompt[:n])
            if key in entries:
                entries.move_to_end(key)
                self._hits[d] += 1
                _PREFIX_EVENTS.inc("hit")
                return n, True
            n -= self.align
        self._misses[d] += 1
        _PREFIX_EVENTS.inc("miss")
        return 0, False

    def restore(self, slot: int, prompt: Sequence[int], n: int) -> None:
        entries = self._indexes[self.pool.owner(slot)]
        handle, _ = entries[tuple(prompt[:n])]
        self.pool.restore_snapshot(slot, handle)

    def store(self, slot: int, prompt: Sequence[int], n: int) -> None:
        """Snapshot the slot's first ``n`` positions (``n`` page- and
        chunk-aligned; the slot's prefill must sit exactly at offset n)
        into its data rank's index."""
        entries = self._indexes[self.pool.owner(slot)]
        key = tuple(prompt[:n])
        if n == 0 or key in entries:
            return
        n_pages = n // self.pool.page_size
        handle = self.pool.take_snapshot(slot, n_pages)
        while handle is None and entries:
            _, (old, _) = entries.popitem(last=False)   # LRU evict
            self.pool.release_snapshot(old)
            _PREFIX_EVENTS.inc("evict")
            handle = self.pool.take_snapshot(slot, n_pages)
        if handle is None:
            return
        entries[key] = (handle, n)
        _PREFIX_EVENTS.inc("store")
        while len(entries) > self.max_entries:
            _, (old, _) = entries.popitem(last=False)
            self.pool.release_snapshot(old)
            _PREFIX_EVENTS.inc("evict")

    def __len__(self) -> int:
        return sum(len(e) for e in self._indexes)

    def stats(self) -> Dict[str, int]:
        """Entries, hits and misses over every data rank's index."""
        return {"entries": len(self), "hits": self.hits,
                "misses": self.misses}

    def stats_by_rank(self) -> List[Dict[str, int]]:
        """:meth:`stats` of each data rank's index, in data-rank order."""
        return [{"entries": len(e), "hits": h, "misses": m}
                for e, h, m in zip(self._indexes, self._hits, self._misses)]
