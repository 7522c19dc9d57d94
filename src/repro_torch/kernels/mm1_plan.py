"""Tile and split-K plan of the fused GEMM's mm1 kernel (``csrc/fused_mm1.cu``).

The kernel computes one ``bm`` x ``BN`` output tile of one group per block,
over a K range read through a ring of ``STAGES`` shared-memory stages of
``BK`` deep.  Where the (N-tile x M-tile x group) grid cannot fill the card,
K is split across blocks: each split sums its own range into exact int32
partials, and the last block to arrive on a tile adds them (modulo 2^32,
so the order of arrival changes no bit) and runs the epilogue.  This module
picks the tile, the split count and each split's K range; the C entry takes
the result.  It is plain Python so the CPU tests reach it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

BN = 128            # output columns per block (four 32-column warp spans)
BK = 64             # K depth of one shared-memory stage
STAGES = 4          # ring depth: stages in flight per block
TILE_M = (16, 64)   # decode tile (one m16 MMA row block) and prefill tile
# Rows up to which the 16-row tile is used.  Through a serve prefill bucket
# (M <= 64) its grid, four times the 64-row tile's, keeps more copies in
# flight than the larger tile's fewer, longer blocks; the 64-row tile wins
# where the MMAs become the limit (M = 256 and up at N >= 8192).
DECODE_MAX_M = 64
# Each split covers at least this many stages, so its copies fill the ring,
# and at least 8 bm deep, so the int32 partials it writes and the last block
# reads (2 x bm x BN x 4 bytes) are no more bytes than its slice of B.
MIN_SPLIT_STAGES = STAGES
# Split until the grid holds about this many blocks per SM (two waves keep
# twice the copies in flight on every SM).
BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class Mm1Plan:
    bm: int              # output rows per block: 16 (decode) or 64
    tiles_m: int
    tiles_n: int
    groups: int
    split: int           # blocks per output tile along K
    k_split: int         # K depth of every split but the last (multiple of BK)
    k: int

    @property
    def tiles(self) -> int:
        return self.groups * self.tiles_m * self.tiles_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    @property
    def ws_ints(self) -> int:
        """int32 partials the workspace must hold: one bm x BN tile per
        split of every tile (none without a split)."""
        return self.tiles * self.split * self.bm * BN if self.split > 1 else 0

    @property
    def n_counters(self) -> int:
        """Arrival counters, one a tile (none without a split)."""
        return self.tiles if self.split > 1 else 0

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[start, end) of each split's K range, in split order."""
        return [(s * self.k_split, min(self.k, (s + 1) * self.k_split))
                for s in range(self.split)]


@functools.lru_cache(maxsize=4096)     # planned once per shape: host time
def plan_mm1(groups: int, m: int, k: int, n: int, num_sms: int) -> Mm1Plan:
    """The plan for a (groups, m, k) x (groups, k, n) mm1 launch on a card
    with ``num_sms`` SMs.

    The 16-row tile serves m <= DECODE_MAX_M (decode, the ragged expert
    GEMMs, prefill buckets), the 64-row tile larger m.  K is split only when the tile grid
    holds fewer blocks than the card has SMs; then into as many splits as
    bring the grid to BLOCKS_PER_SM blocks an SM, each at least
    MIN_SPLIT_STAGES stages and 8 bm deep.  Every split is a whole number
    of stages except the last, which ends at k."""
    if min(groups, m, n, num_sms) < 1 or k < 0:
        raise ValueError(f"bad mm1 problem: groups={groups} m={m} k={k} "
                         f"n={n} num_sms={num_sms}")
    bm = TILE_M[0] if m <= DECODE_MAX_M else TILE_M[1]
    tiles_m, tiles_n = -(-m // bm), -(-n // BN)
    tiles = groups * tiles_m * tiles_n
    stages = max(1, -(-k // BK))
    split = 1
    if tiles < num_sms:
        min_stages = max(MIN_SPLIT_STAGES, 8 * bm // BK)
        split = max(1, min(-(-BLOCKS_PER_SM * num_sms // tiles),
                           stages // min_stages))
    per = -(-stages // split)            # stages a split
    split = -(-stages // per)            # no empty split
    k_split = per * BK if split > 1 else max(k, BK)
    return Mm1Plan(bm=bm, tiles_m=tiles_m, tiles_n=tiles_n, groups=groups,
                   split=split, k_split=k_split, k=k)
