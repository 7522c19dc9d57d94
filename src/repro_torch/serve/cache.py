"""Paged KV pool for the serve engine (port of ``repro.serve.cache``'s
``PagedCachePool``, attention K/V leaves).

Every cache leaf lives in a pool split into fixed-size pages of
``page_size`` tokens, laid out ``(n_periods, n_pages, page, K, D)``; a slot
maps to its pages through a ``(n_slots, pages_per_slot)`` page table.  One
extra set of *parking* pages backs decode lanes that pad a bucketed batch
beyond the free-slot supply, so padded lanes never touch a live slot.

Stale K/V is masked by position, never zeroed, so admitting a request needs
no pool write.  The reference's recurrent-state rows (mamba, rwkv), the
snapshot region and ``PrefixCache`` wait for their ROADMAP items.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import lm

PAGED_LEAVES = ("k", "v")


def default_page_size(max_seq: int, preferred: int = 64) -> int:
    """Largest power of two <= ``preferred`` dividing ``max_seq``."""
    p = preferred
    while p > 1 and max_seq % p:
        p //= 2
    return p


class PagedCachePool:
    """Fixed-size page pools plus the slot page table."""

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
        # +1 slot's worth of parking pages (padded decode lanes land there)
        self.n_pages = (n_slots + 1) * pps
        shapes = lm.init_cache(cfg, 1, max_seq, device="meta")
        self.pools: Dict[str, Dict[str, torch.Tensor]] = {}
        for pos, leaves in shapes.items():
            self.pools[pos] = {}
            for name, leaf in leaves.items():
                if name not in PAGED_LEAVES:
                    raise NotImplementedError(
                        f"cache leaf {name!r} is not paged; recurrent state "
                        f"rows are not ported yet")
                shape = ((leaf.shape[0], self.n_pages, page_size)
                         + tuple(leaf.shape[3:]))
                self.pools[pos][name] = torch.zeros(shape, dtype=leaf.dtype,
                                                    device=device)
        pages = np.arange(self.n_pages, dtype=np.int64)
        self.page_table = pages[:n_slots * pps].reshape(n_slots, pps)
        self.parking_pages = pages[n_slots * pps:]

    def lane_rows(self, lane_slots: Sequence[Optional[int]]) -> np.ndarray:
        """Page rows (W, pps) for a decode/prefill lane list; ``None``
        entries map to the parking pages."""
        return np.stack([self.page_table[i] if i is not None
                         else self.parking_pages for i in lane_slots])
