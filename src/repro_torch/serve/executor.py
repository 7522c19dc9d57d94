"""Compute layer of the serve engine: paged-pool gather -> model -> scatter
(port of ``repro.serve.executor``).

  * ``decode``  — gather the lane slots' pages and state rows into a dense
    ``(n_periods, W, ...)`` cache (K/V ``(n_periods, W, Smax, K, D)``),
    run :func:`lm.decode_step`, scatter the lanes back.  One CUDA graph per
    decode-bucket width ``W``, the counterpart of the reference's one jit
    trace per width (below).
  * ``prefill`` — the same around a resume-from-offset :func:`lm.prefill`,
    run eagerly (its widths are recorded for :meth:`Executor.n_traces`).
  * ``sample``  — greedy argmax, or temperature sampling with one seeded
    ``torch.Generator`` per (request, step).

The graphed decode.  Each width holds static device buffers for its inputs
— tokens, positions, page rows and state rows — filled with ``copy_``
before every step; the gather, the model and the scatter read them, and the
logits are the step's static output, valid until the next decode of that
width (the engine samples from them, outside the graph, before then).  On
CUDA a width is captured the first time it decodes (``Engine.warm()``
decodes every width): first one eager step on the executor's capture
stream on the parking rows, which builds and loads every kernel and grows
every split-K workspace of that stream (``kernels.fused_gemm``) to what
the width needs, then the capture on the same stream.  The graph keeps a
reference to the workspace tensors it captured, so a later width that
grows the workspace cannot free them; a capture that finds the workspace
grown raises.  Each graph also keeps its ``cudaGraph_t`` beside the
instantiated executable, so its kernel nodes — what every replay launches
— can be listed (:attr:`Executor.decode_graphs`).  The kernels' launch
counters are host-side: they count during the warm-up and the capture,
never at a replay, so each width records the launches it captured
(``captured``) and its replays (``replays``).  On the CPU, and with
``graphs`` set False, the same static buffers run eagerly.

Metrics (:mod:`repro_torch.obs.metrics`, host-side):
``repro_serve_retraces_total`` counts one ``decode`` per decode width set
up (on CUDA, the width's graph capture) and one ``prefill`` per new
prefill width — the reference's one jit trace each — so after
``Engine.warm()`` its ``decode`` count equals ``n_traces()["decode"]``;
``repro_serve_decode_lane_width_total`` counts every decode call by width,
host code before the replay.  The MoE dispatch accumulators
(:mod:`repro_torch.models.moe`) keep the capture's eager warm-up step out
of their counts, as the reference observes each executed step once.

Under a mesh (``mesh=``) each rank runs its own data rank's lanes over its
block of the pool, the model under the ambient mesh
(``dist.sharding.use_mesh``), whose activations are this data rank's rows,
so its GEMMs run sharded and its attention head-parallel.  A CUDA graph
cannot capture a gloo collective, so under a gloo mesh (ranks sharing one
card, or the CPU) ``graphs`` is False and decode runs the static buffers
eagerly: a property of the mesh's backend, set here, not a fallback on
failure.  Under NCCL decode is captured with its collectives; a world of
one has none (every group is one rank), and no run has yet captured an
engine step with NCCL collectives of several ranks.

Where the reference donates the pool to its jit so the cache never copies,
the port updates the pool in place: the scatter writes the lanes straight
back into the pool tensors, whose addresses never change.  Sampling cannot
reproduce the reference's PRNG bits; greedy decoding is exact.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.dist import sharding as dist_sharding
from repro_torch.kernels import fused_gemm, launch_counts
from repro_torch.launch.mesh import mesh_backend
from repro_torch.models import lm, moe
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.cache import PAGED_LEAVES, PagedCachePool

Params = Any

_SEED_MIX = 1_000_003

_RETRACES = obs_metrics.counter(
    "repro_serve_retraces_total",
    "decode widths set up (on CUDA each one's graph capture) and new "
    "prefill widths, by kind: the reference's jit (re)compiles",
    labels=("kind",))
_LANE_WIDTHS = obs_metrics.counter(
    "repro_serve_decode_lane_width_total",
    "decode calls by bucketed lane width",
    labels=("width",))


class _Decoder:
    """One decode width's static inputs, its logits and, on CUDA, its
    graph."""

    def __init__(self, width: int, pool: PagedCachePool, device):
        self.toks = torch.zeros((width,), dtype=torch.int32, device=device)
        self.pos = torch.zeros((width,), dtype=torch.int32, device=device)
        self.prows = torch.empty((width, pool.pages_per_slot),
                                 dtype=torch.int64, device=device)
        self.srows = torch.empty((width,), dtype=torch.int64, device=device)
        self.park(pool)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.workspace = ()     # split-K workspace the graph captured
        self.launches: Dict[str, int] = {}
        self.replays = 0

    def park(self, pool: PagedCachePool) -> None:
        """Point every lane at the parking rows."""
        self.prows.copy_(torch.from_numpy(
            np.tile(pool.parking_pages, (self.prows.shape[0], 1))))
        self.srows.fill_(pool.parking_state)


class Executor:
    """Gather/compute/scatter over a :class:`PagedCachePool`."""

    def __init__(self, cfg, params: Params, pool: PagedCachePool,
                 device: torch.device, mesh=None):
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.device = device
        self.mesh = mesh
        # Decode through one CUDA graph per width; False runs the static
        # buffers eagerly (the CPU's path, and a gloo mesh's: gloo cannot
        # be captured), and for A/B checks on the card.
        self.graphs = device.type == "cuda" and (
            mesh is None or mesh_backend(mesh) != "gloo")
        self._decoders: Dict[int, _Decoder] = {}
        self._prefill_widths: set = set()
        self._stream = None

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

    def _mesh(self):
        """The ambient mesh of a model call, or none."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return dist_sharding.use_mesh(self.mesh)

    def _step(self, d: _Decoder) -> torch.Tensor:
        """One decode step on ``d``'s buffers: what a graph captures."""
        lanes = self._gather(d.prows, d.srows)
        with self._mesh():
            logits, lanes = lm.decode_step(self.params, self.cfg, d.toks,
                                           lanes, d.pos)
        self._scatter(lanes, d.prows, d.srows)
        return logits

    def _capture(self, d: _Decoder) -> None:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        current = torch.cuda.current_stream(self.device)
        d.park(self.pool)       # the warm-up step touches no slot's rows
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            saved = (moe.save_dispatch_metrics() if obs_metrics.enabled()
                     else None)
            self._step(d)       # eager: kernel builds, workspace growth
            if saved is not None:
                moe.restore_dispatch_metrics(saved)
        dev = d.toks.device         # indexed, as the launches' devices
        before_ws = fused_gemm.workspace_tensors(dev, stream.cuda_stream)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream):
            d.logits = self._step(d)
        graph.instantiate()
        after = launch_counts()
        current.wait_stream(stream)
        after_ws = fused_gemm.workspace_tensors(dev, stream.cuda_stream)
        if len(before_ws) != len(after_ws) or any(
                a is not b for a, b in zip(before_ws, after_ws)):
            raise RuntimeError("a split-K workspace grew during the decode "
                               "graph's capture")
        d.graph = graph
        d.workspace = before_ws
        d.launches = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}

    # -- entry points (update pool.pools in place) --------------------------

    @torch.inference_mode()
    def decode(self, lane_slots, toks: np.ndarray,
               pos: np.ndarray) -> torch.Tensor:
        """Logits (W, V) of one decode step over ``lane_slots``; on the
        graphed path a static tensor, overwritten by the next decode of
        the same width."""
        width = len(lane_slots)
        _LANE_WIDTHS.inc(width)
        d = self._decoders.get(width)
        if d is None:
            d = self._decoders[width] = _Decoder(width, self.pool,
                                                 self.device)
            _RETRACES.inc("decode")
        if self.graphs and d.graph is None:
            self._capture(d)
        prows, srows = self.pool.lane_rows(lane_slots)
        for buf, val in ((d.toks, toks), (d.pos, pos), (d.prows, prows),
                         (d.srows, srows)):
            buf.copy_(torch.from_numpy(np.asarray(val)))
        if not self.graphs:
            return self._step(d)
        d.graph.replay()
        d.replays += 1
        return d.logits

    @torch.inference_mode()
    def prefill(self, slot, toks: np.ndarray, start: int,
                last: np.ndarray) -> torch.Tensor:
        if int(toks.shape[1]) not in self._prefill_widths:
            self._prefill_widths.add(int(toks.shape[1]))
            _RETRACES.inc("prefill")
        rows = self._rows([slot])
        lanes = self._gather(*rows)
        toks_t = torch.as_tensor(toks, device=self.device)
        last_t = torch.as_tensor(last, device=self.device)
        iota = torch.arange(toks_t.shape[1], device=self.device)[None, :]
        mask = iota <= last_t[:, None]
        with self._mesh():
            logits, lanes, _ = lm.prefill(self.params, self.cfg, toks_t,
                                          lanes, pad_mask=mask,
                                          last_idx=last_t, start=start)
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

    # -- steady-state monitoring --------------------------------------------

    def n_traces(self) -> Dict[str, int]:
        """``decode``: the widths with a decode graph (CPU: static
        entries); ``prefill``: the prefill widths run so far."""
        return {"decode": len(self._decoders),
                "prefill": len(self._prefill_widths)}

    @property
    def replays(self) -> Dict[int, int]:
        """Graph replays by decode width."""
        return {w: d.replays for w, d in self._decoders.items()}

    @property
    def decode_graphs(self) -> Dict[int, "torch.cuda.CUDAGraph"]:
        """Each width's CUDA graph; it keeps its ``cudaGraph_t``
        (``raw_cuda_graph()``), so what a replay launches can be listed."""
        return {w: d.graph for w, d in self._decoders.items()
                if d.graph is not None}

    @property
    def captured(self) -> Dict[int, Dict[str, int]]:
        """Kernel launches each width's graph captured, by kernel."""
        return {w: dict(d.launches) for w, d in self._decoders.items()}
