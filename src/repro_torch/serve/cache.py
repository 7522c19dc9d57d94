"""Paged KV / recurrent-state pool for the serve engine (port of
``repro.serve.cache``'s ``PagedCachePool``).

Every cache leaf lives in a pool with a row dimension at axis 1, and the
mapping from decode slots to pool rows is data, not layout:

  * attention K/V leaves are split into fixed-size **pages** of
    ``page_size`` tokens: pool layout ``(n_periods, n_pages, page, K, D)``,
    slot -> pages through a ``(n_slots, pages_per_slot)`` page table.
  * recurrent leaves (rwkv shift/wkv) are a single state row per slot:
    pool layout ``(n_periods, n_states, ...)``, slot -> row through a
    ``(n_slots,)`` state table.

One extra set of *parking* pages and one parking state row back decode
lanes that pad a bucketed batch beyond the free-slot supply, so padded
lanes never touch a live slot.  Stale K/V is masked by position, never
zeroed; recurrent state is not masked, so the engine zeroes a slot's state
rows (:meth:`PagedCachePool.zero_slot_state`) before it prefills a new
request there.  The reference's snapshot region and ``PrefixCache`` wait
for their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import lm

# Cache leaves that carry a per-token Smax axis and therefore page.
PAGED_LEAVES = ("k", "v")


def default_page_size(max_seq: int, preferred: int = 64) -> int:
    """Largest power of two <= ``preferred`` dividing ``max_seq``."""
    p = preferred
    while p > 1 and max_seq % p:
        p //= 2
    return p


class PagedCachePool:
    """Fixed-size page and state-row pools plus the slot tables."""

    def __init__(self, cfg, n_slots: int, max_seq: int, page_size: int, *,
                 device=None):
        if max_seq % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={max_seq}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = pps = max_seq // page_size
        # +1 slot's worth of parking rows (padded decode lanes land there)
        self.n_pages = (n_slots + 1) * pps
        self.n_states = n_slots + 1
        shapes = lm.init_cache(cfg, 1, max_seq, device="meta")
        self.pools: Dict[str, Dict[str, torch.Tensor]] = {}
        for pos, leaves in shapes.items():
            self.pools[pos] = {}
            for name, leaf in leaves.items():
                if name in PAGED_LEAVES:
                    shape = ((leaf.shape[0], self.n_pages, page_size)
                             + tuple(leaf.shape[3:]))
                else:
                    shape = (leaf.shape[0], self.n_states) + tuple(
                        leaf.shape[2:])
                self.pools[pos][name] = torch.zeros(shape, dtype=leaf.dtype,
                                                    device=device)
        pages = np.arange(self.n_pages, dtype=np.int64)
        self.page_table = pages[:n_slots * pps].reshape(n_slots, pps)
        self.parking_pages = pages[n_slots * pps:]
        self.state_table = np.arange(n_slots, dtype=np.int64)
        self.parking_state = n_slots

    def zero_slot_state(self, slot: int) -> None:
        """Zero the slot's state row in every recurrent pool (slot
        (re)init); K/V pages are left as they are."""
        row = int(self.state_table[slot])
        for leaves in self.pools.values():
            for name, pool in leaves.items():
                if name not in PAGED_LEAVES:
                    pool[:, row].zero_()

    def lane_rows(self, lane_slots: Sequence[Optional[int]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(page rows (W, pps), state rows (W,)) for a decode/prefill lane
        list; ``None`` entries map to the parking rows."""
        prows = np.stack([self.page_table[i] if i is not None
                          else self.parking_pages for i in lane_slots])
        srows = np.array([self.state_table[i] if i is not None
                          else self.parking_state for i in lane_slots],
                         np.int64)
        return prows, srows
