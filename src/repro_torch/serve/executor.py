"""Compute layer of the serve engine: paged-pool gather -> model -> scatter
(port of ``repro.serve.executor``).

  * ``decode``  — gather the lane slots' pages and state rows into a dense
    ``(n_periods, W, ...)`` cache (K/V ``(n_periods, W, Smax, K, D)``),
    run :func:`lm.decode_step`, scatter the lanes back.
  * ``prefill`` — the same around a resume-from-offset :func:`lm.prefill`.
  * ``sample``  — greedy argmax, or temperature sampling with one seeded
    ``torch.Generator`` per (request, step).

The port runs eagerly.  Where the reference donates the pool to its jit so
the cache never copies, the port updates the pool in place: the scatter
writes the lanes straight back into the pool tensors.  Sampling cannot
reproduce the reference's PRNG bits; greedy decoding is exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve.cache import PAGED_LEAVES, PagedCachePool

Params = Any

_SEED_MIX = 1_000_003


class Executor:
    """Gather/compute/scatter over a :class:`PagedCachePool`."""

    def __init__(self, cfg, params: Params, pool: PagedCachePool,
                 device: torch.device):
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.device = device

    def _rows(self, lane_slots):
        prows, srows = self.pool.lane_rows(lane_slots)
        return (torch.as_tensor(prows, device=self.device),
                torch.as_tensor(srows, device=self.device))

    def _gather(self, prows: torch.Tensor, srows: torch.Tensor):
        w = prows.shape[0]
        out = {}
        for pos, leaves in self.pool.pools.items():
            out[pos] = {}
            for name, pool in leaves.items():
                if name not in PAGED_LEAVES:      # one state row a lane
                    out[pos][name] = pool[:, srows]
                    continue
                lanes = pool[:, prows]            # (np, W, pps, page, K, D)
                out[pos][name] = lanes.reshape(
                    (pool.shape[0], w, self.pool.max_seq)
                    + tuple(pool.shape[3:]))
        return out

    def _scatter(self, lanes, prows: torch.Tensor,
                 srows: torch.Tensor) -> None:
        w = prows.shape[0]
        pps, page = self.pool.pages_per_slot, self.pool.page_size
        for pos, leaves in self.pool.pools.items():
            for name, pool in leaves.items():
                if name not in PAGED_LEAVES:
                    pool[:, srows] = lanes[pos][name].to(pool.dtype)
                    continue
                pool[:, prows] = lanes[pos][name].reshape(
                    (pool.shape[0], w, pps, page)
                    + tuple(pool.shape[3:])).to(pool.dtype)

    @torch.inference_mode()
    def decode(self, lane_slots, toks: np.ndarray,
               pos: np.ndarray) -> torch.Tensor:
        rows = self._rows(lane_slots)
        lanes = self._gather(*rows)
        logits, lanes = lm.decode_step(
            self.params, self.cfg,
            torch.as_tensor(toks, device=self.device), lanes,
            torch.as_tensor(pos, dtype=torch.int32, device=self.device))
        self._scatter(lanes, *rows)
        return logits

    @torch.inference_mode()
    def prefill(self, slot, toks: np.ndarray, start: int,
                last: np.ndarray) -> torch.Tensor:
        rows = self._rows([slot])
        lanes = self._gather(*rows)
        toks_t = torch.as_tensor(toks, device=self.device)
        last_t = torch.as_tensor(last, device=self.device)
        iota = torch.arange(toks_t.shape[1], device=self.device)[None, :]
        mask = iota <= last_t[:, None]
        logits, lanes, _ = lm.prefill(self.params, self.cfg, toks_t, lanes,
                                      pad_mask=mask, last_idx=last_t,
                                      start=start)
        self._scatter(lanes, *rows)
        return logits

    @torch.inference_mode()
    def sample(self, seed: int, logits: torch.Tensor, temps, rids,
               steps) -> np.ndarray:
        """One token per lane: argmax where the temperature is 0, else a
        draw from softmax(logits / T) with a generator seeded from
        (seed, request id, step) — independent of lane and batch width."""
        out = torch.argmax(logits, dim=-1).to(torch.int64).cpu().numpy()
        for lane, tmp in enumerate(temps):
            if tmp <= 0:
                continue
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(((seed * _SEED_MIX + int(rids[lane])) * _SEED_MIX
                             + int(steps[lane])) % (2 ** 63))
            scaled = logits[lane].to(torch.float32) / max(float(tmp), 1e-6)
            probs = torch.softmax(scaled, dim=-1)
            out[lane] = int(torch.multinomial(probs, 1, generator=gen))
        return out.astype(np.int32)
