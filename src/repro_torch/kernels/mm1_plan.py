"""Tile and split-K plan of the pipelined GEMM kernels: the fused GEMM's
mm1 (``csrc/fused_mm1.cu``) and split modes kmm2, mm2 and kmm4
(``csrc/fused_split.cu``), and the staged MM1, KMM2 and MM2 digit-plane
kernels (``csrc/staged_pipe.cu``).

Each kernel computes one ``bm`` x ``BN`` output tile of one group per block,
over a K range read through a ring of ``STAGES`` shared-memory stages of
``BK`` deep.  Where the (N-tile x M-tile x group) grid cannot fill the card,
K is split across blocks: each split sums its own range into exact int32
partials (the split modes also their row and column sums), and the last
block to arrive on a tile adds them (modulo 2^32, so the order of arrival
changes no bit) and runs the epilogue.  This module picks the tile, the
split count and each split's K range — one rule for every kernel, over K
for mm1 and the staged kernels and over the logical padded K ``kp`` for
the split modes; the C entries take the result.  It is plain Python so
the CPU tests reach it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

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
# and deep enough that the int32 partials it writes and the last block
# reads (2 x accs x bm x BN x 4 bytes) are no more bytes than its slice of B
# (depth x BN x carrier bytes): 8 bm deep for mm1.
MIN_SPLIT_STAGES = STAGES
# The split modes' accumulators (kmm2 three digit products, mm2 four, kmm4
# nine) and carrier bytes (int16; int32 for kmm4); the K depth of their
# stages by tile rows.
SPLIT_ACCS = {"kmm2": 3, "mm2": 4, "kmm4": 9}
SPLIT_CARRIER = {"kmm2": 2, "mm2": 2, "kmm4": 4}
SPLIT_BK = {16: 32, 32: 32, 64: 64}
# kmm4's nine accumulators allow one m16 row block a warp, so its larger
# tile has 32 rows (eight warps, one block an SM).  It halves the digit
# split a row against two 16-row tiles, and wins from M = 17 on; the
# 16-row tile stays for ragged launches (it skips dead 16-row tiles) and
# for a single column tile (N <= BN, the router), where the larger tile's
# deeper minimum split leaves too few blocks (PERF.md §6, row 1d).
KMM4_TILE_M = (16, 32)
# Split until the grid holds about this many blocks per SM (two waves keep
# twice the copies in flight on every SM).
BLOCKS_PER_SM = 2
# A ragged grouped launch (the MoE expert GEMMs) with a grid that fills the
# card splits K in pieces of at least this many stages all the same: its
# live tiles are unknown on the host, and at decode a token's top-k leaves
# most of them dead, so the live grid is narrow and each live block's K
# loop is the launch's latency.
RAGGED_SPLIT_STAGES = 16
# The staged kernels (staged_pipe.cu) by layout: int32 accumulators (mm1
# one; kmm2 three, C1, Cs and C0; its split route three, C1, the cross
# products and C0; mm2 four, C1, C10, C01 and C0) and planes an operand.
# Their stages hold 64 bytes of K a row: 64 int8 values or 32 int16 ones.
STAGED_ACCS = {"mm1": 1, "kmm2": 3, "kmm2_split": 3, "mm2": 4}
STAGED_PLANES = {"mm1": 1, "kmm2": 2, "kmm2_split": 2, "mm2": 2}
STAGED_ROW_BYTES = 64
# Blocks of a staged kernel an SM holds at once, by layout and tile rows
# (shared memory bounds them: mm1 37-45 KB at the 16-row tile, 53-60 KB at
# the 64-row one; the two-plane layouts 75-106 KB and 104-138 KB).  A
# split grid past that many blocks runs a second wave that is mostly idle,
# so the split is cut to what one wave holds.
STAGED_BLOCKS_PER_SM = {("mm1", 16): 4, ("mm1", 64): 3,
                        ("kmm2", 16): 2, ("kmm2", 64): 1,
                        ("kmm2_split", 16): 2, ("kmm2_split", 64): 1,
                        ("mm2", 16): 2, ("mm2", 64): 1}
# The two-plane layouts take the 64-row tile above this many rows where N
# spans more than one column tile: with three or four accumulators and two
# B planes a 16-row tile's share of B is dear, and one 64-row tile (row
# blocks past M skipped) reads B once.  A single column tile (the MoE
# router) keeps the 16-row tile, whose shallower minimum split leaves more
# blocks.
STAGED_KMM2_DECODE_MAX_M = 16


@dataclass(frozen=True)
class SplitKPlan:
    bm: int              # output rows per block: 16 (decode), 32 or 64
    tiles_m: int
    tiles_n: int
    groups: int
    split: int           # blocks per output tile along K
    k_split: int         # K depth of every split but the last (multiple of BK)
    k: int               # the K extent the splits cover (kp for split modes)
    tile_ints: int       # workspace int32 a split of a tile

    @property
    def tiles(self) -> int:
        return self.groups * self.tiles_m * self.tiles_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.split

    @property
    def ws_ints(self) -> int:
        """int32 the workspace must hold: one tile's partials per split of
        every tile — bm x BN for each accumulator, and for the split modes
        the bm row and BN column sums (none without a split)."""
        return (self.tiles * self.split * self.tile_ints
                if self.split > 1 else 0)

    @property
    def n_counters(self) -> int:
        """Arrival counters, one a tile (none without a split)."""
        return self.tiles if self.split > 1 else 0

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[start, end) of each split's K range, in split order."""
        return [(s * self.k_split, min(self.k, (s + 1) * self.k_split))
                for s in range(self.split)]


def tile_rows(m: int) -> int:
    """Output rows per block for an m-row launch: the 16-row tile through
    DECODE_MAX_M, the 64-row tile above."""
    return TILE_M[0] if m <= DECODE_MAX_M else TILE_M[1]


def split_tile_rows(mode: str, m: int, n: int, ragged: bool = False) -> int:
    """Output rows per block of a split-mode launch: :func:`tile_rows` for
    kmm2 and mm2; for kmm4 the 32-row tile where m > 16, N spans more than
    one column tile and the launch is not ragged, else the 16-row tile."""
    if mode != "kmm4":
        return tile_rows(m)
    wide = m > KMM4_TILE_M[0] and n > BN and not ragged
    return KMM4_TILE_M[1] if wide else KMM4_TILE_M[0]


def plan_split_k(groups: int, m: int, k: int, n: int, num_sms: int, *,
                 accs: int = 1, carrier_bytes: int = 1, sums: bool = False,
                 bk: int = BK, ragged: bool = False,
                 bm: Optional[int] = None,
                 split: Optional[int] = None) -> SplitKPlan:
    """The plan for a (groups, m, k) x (groups, k, n) launch on a card with
    ``num_sms`` SMs, of a kernel with ``accs`` int32 accumulators a tile
    element, operands of ``carrier_bytes`` a value and stages ``bk`` deep;
    ``sums`` adds the row and column sums to each split's partials;
    ``ragged`` marks a ragged grouped launch; ``bm`` the tile rows
    (:func:`tile_rows` by default); ``split`` forces the split count
    (at most one split a stage; 1 turns split-K off).

    The 16-row tile serves m <= DECODE_MAX_M (decode, the ragged expert
    GEMMs, prefill buckets), the 64-row tile larger m.  K is split only
    when the tile grid holds fewer blocks than the card has SMs; then into
    as many splits as bring the grid to BLOCKS_PER_SM blocks an SM, each
    at least MIN_SPLIT_STAGES stages and 8 accs bm / carrier_bytes deep.
    A ragged launch whose grid fills the card splits into pieces of at
    least RAGGED_SPLIT_STAGES stages.  Every split is a whole number of
    stages except the last, which ends at k."""
    if min(groups, m, n, num_sms, accs, carrier_bytes, bk) < 1 or k < 0:
        raise ValueError(f"bad split-K problem: groups={groups} m={m} k={k} "
                         f"n={n} num_sms={num_sms} accs={accs}")
    bm = bm or tile_rows(m)
    tiles_m, tiles_n = -(-m // bm), -(-n // BN)
    tiles = groups * tiles_m * tiles_n
    stages = max(1, -(-k // bk))
    if split is not None:
        split = max(1, min(split, stages))
    elif tiles < num_sms:
        min_stages = max(MIN_SPLIT_STAGES,
                         -(-8 * accs * bm // (carrier_bytes * bk)))
        split = max(1, min(-(-BLOCKS_PER_SM * num_sms // tiles),
                           stages // min_stages))
    elif ragged:
        split = max(1, stages // RAGGED_SPLIT_STAGES)
    else:
        split = 1
    per = -(-stages // split)            # stages a split
    split = -(-stages // per)            # no empty split
    k_split = per * bk if split > 1 else max(k, bk)
    tile_ints = accs * bm * BN + (bm + BN if sums else 0)
    return SplitKPlan(bm=bm, tiles_m=tiles_m, tiles_n=tiles_n, groups=groups,
                      split=split, k_split=k_split, k=k, tile_ints=tile_ints)


@functools.lru_cache(maxsize=4096)     # planned once per shape: host time
def plan_mm1(groups: int, m: int, k: int, n: int, num_sms: int) -> SplitKPlan:
    """The plan for a (groups, m, k) x (groups, k, n) mm1 launch: int8
    operands, one accumulator, the splits over [0, k)."""
    return plan_split_k(groups, m, k, n, num_sms)


@functools.lru_cache(maxsize=4096)
def plan_split(mode: str, groups: int, m: int, kp: int, n: int,
               num_sms: int, ragged: bool = False) -> SplitKPlan:
    """The plan for a split-mode launch (kmm2, mm2 on int16 carriers, kmm4
    on int32): its digit accumulators and row and column sums, the splits
    over the logical padded K [0, kp), whose padding positions are digits
    too."""
    bm = split_tile_rows(mode, m, n, ragged)
    return plan_split_k(groups, m, kp, n, num_sms, accs=SPLIT_ACCS[mode],
                        carrier_bytes=SPLIT_CARRIER[mode], sums=True,
                        bk=SPLIT_BK[bm], ragged=ragged, bm=bm)


def staged_tile_rows(layout: str, m: int, n: int) -> int:
    """Output rows per block of a staged launch: mm1 as the fused mm1
    (:func:`tile_rows`); the two-plane layouts (kmm2, kmm2_split, mm2) the
    64-row tile where m > STAGED_KMM2_DECODE_MAX_M and N spans more than
    one column tile, else the 16-row tile."""
    if layout == "mm1":
        return tile_rows(m)
    wide = m > STAGED_KMM2_DECODE_MAX_M and n > BN
    return TILE_M[1] if wide else TILE_M[0]


@functools.lru_cache(maxsize=4096)
def plan_staged(layout: str, m: int, k: int, n: int, num_sms: int,
                plane_bytes: int, split: Optional[int] = None) -> SplitKPlan:
    """The plan for a staged digit-plane launch (``layout`` mm1, kmm2,
    kmm2_split or mm2 on planes of ``plane_bytes`` 1 or 2): its tile, its
    accumulators, B's bytes a K position over all its planes, stages of
    STAGED_ROW_BYTES a row, the splits over [0, k), cut to the blocks one
    wave holds (STAGED_BLOCKS_PER_SM); ``split`` forces the split count."""
    if plane_bytes not in (1, 2):
        raise ValueError(f"staged planes are int8 or int16, got "
                         f"{plane_bytes} bytes")
    bm = staged_tile_rows(layout, m, n)
    kw = dict(accs=STAGED_ACCS[layout],
              carrier_bytes=plane_bytes * STAGED_PLANES[layout],
              bk=STAGED_ROW_BYTES // plane_bytes, bm=bm)
    plan = plan_split_k(1, m, k, n, num_sms, split=split, **kw)
    slots = STAGED_BLOCKS_PER_SM[(layout, bm)] * num_sms
    if split is None and plan.split > 1 and plan.blocks > slots:
        plan = plan_split_k(1, m, k, n, num_sms,
                            split=max(1, slots // plan.tiles), **kw)
    return plan
