"""Collectives on ``torch.distributed`` (port of ``repro.dist.collectives``)
and the mesh-axis communication the sharded GEMMs and the engine use.

The reference's primitives, each taking a process group where the
reference takes an ``axis_name``:

  * :func:`ef_compressed_psum`: an int8-quantized all-reduce with the
    error-feedback residual carried across steps — one shared scale by a
    max all-reduce, then an int32 all-reduce of the codes;
  * :func:`ring_ag_matmul`: the ring all-gather matmul, one point-to-point
    hop (``batch_isend_irecv``) a step, each chunk GEMM on the paper's
    integer GEMM when ``w_bits`` is set;
  * :func:`splitk_decode_attention`: decode attention over a sequence-
    sharded KV cache, the (m, l, o) partials merged by a max and two sum
    all-reduces.

Below them, the axis helpers (:func:`all_gather`, :func:`all_reduce`,
:func:`reduce_scatter`, :func:`gather_dtensor`) run a collective over one
or more mesh axes, the innermost first, so a gather over ("pod", "data")
concatenates pod-major.  A group of one rank is the identity.

Training differentiates through them.  Where autograd records, each
collective a train step runs in its forward has the backward its use
needs, which GSPMD derives for the reference:

  * :func:`gather_dtensor` (a weight's shards gathered): over the data
    axes the gradient is reduce-scattered (each data rank's gradient is
    its own rows' part), over ``model`` this rank's block is taken back
    (every model rank computed the same whole);
  * :func:`all_gather_grad_take` (heads gathered over ``model``): this
    rank's block of the replicated downstream gradient, no sum;
  * :func:`all_reduce_grad_pass` (a sum of partials, replicated after):
    the gradient passes unchanged;
  * :func:`replicate_grad_sum` (a replicated tensor each rank then uses
    apart, as head-parallel attention uses q/k/v): identity forward, the
    gradient all-reduced.

Gradients are reduced in fp32 (the STE backward's products are fp32);
the bf16 compute copy's weight gathers move bf16.  Where the group's
backend cannot run a collective on CUDA tensors (gloo, for the ops outside
:data:`GLOO_CUDA_OPS`), :func:`_run` moves the operands through host
memory and back; it decides by the group's backend name, never by catching
an error.  Several ranks sharing one card run gloo (NCCL refuses two ranks
on one device), so this is the path of the one-card mesh check.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import records_grad

# Collectives gloo runs on CUDA tensors itself (torch 2.11+cu128 on an
# H100; chip_smoke.py phase 5m probes them on every run, in the dtypes the
# port sends, and fails where one does not work).  The others, gather and
# point-to-point among them, move their operands through the host.
GLOO_CUDA_OPS = frozenset({"all_gather_into_tensor", "all_reduce",
                           "broadcast", "reduce_scatter_tensor"})


def _through_host(group, op: str, tensors: Sequence[torch.Tensor]) -> bool:
    return (dist.get_backend(group) == "gloo" and op not in GLOO_CUDA_OPS
            and any(t.is_cuda for t in tensors))


def _run(group, op: str, fn: Callable, outs: List[torch.Tensor],
         ins: List[torch.Tensor]) -> None:
    """``fn(outs, ins)`` on the group, through host copies where the
    backend cannot take the device's tensors; results land in ``outs``."""
    if not _through_host(group, op, outs + ins):
        fn(outs, ins)
        return
    h_outs = [o.cpu() for o in outs]
    h_ins = [i.cpu() for i in ins]
    fn(h_outs, h_ins)
    for o, h in zip(outs, h_outs):
        o.copy_(h)


def group_size(group) -> int:
    return dist.get_world_size(group)


def _gather_one(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order: one ``all_gather_into_tensor`` along dim 0, viewed as (n,
    *x.shape), its rank axis then moved next to ``dim`` and merged into
    it."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.dtype == torch.int16:
        # neither gloo nor NCCL moves int16 (the w 9-16 codes): their
        # bytes travel as uint8, the last dim doubled
        return _gather_one(x.view(torch.uint8), group, dim).view(torch.int16)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run(group, "all_gather_into_tensor",
         lambda o, i: dist.all_gather_into_tensor(o[0], i[0], group=group),
         [out], [x])
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over the mesh ``axes``
    (major first; gathered innermost first)."""
    for a in reversed(tuple(axes)):
        x = _gather_one(x, mesh.get_group(a), dim)
    return x


def all_reduce_group(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                     ) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is untouched)."""
    out = x.clone()
    if group_size(group) == 1:
        return out
    _run(group, "all_reduce",
         lambda o, i: dist.all_reduce(o[0], op=op, group=group), [out], [])
    return out


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    for a in reversed(tuple(axes)):
        x = all_reduce_group(x, mesh.get_group(a), op)
    return x


def _take_one(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``group`` (a copy)."""
    n = group_size(group)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, rank_of(group) * size, size).clone()


def _reduce_scatter_one(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` summed, this rank's block of the sum
    along ``dim`` (one ``reduce_scatter_tensor`` along dim 0)."""
    n = group_size(group)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run(group, "reduce_scatter_tensor",
         lambda o, i: dist.reduce_scatter_tensor(o[0], i[0], group=group),
         [out], [xm])
    return out.movedim(0, dim).contiguous()


def gather_to_first(x: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` (one shape everywhere) on world rank 0, in rank
    order; None on the other ranks.  One ``gather``, through the host on
    gloo."""
    x = x.contiguous()
    first = dist.get_rank() == 0
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())] \
        if first else []
    _run(None, "gather",
         lambda o, i: dist.gather(i[0], o if first else None, dst=0),
         parts, [x])
    return parts if first else None


def reduce_scatter(x: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
    """Every rank's ``x`` summed over the mesh ``axes``, and this rank's
    block of the sum along ``dim`` (blocks major first, as
    :func:`all_gather` concatenates them: the outermost axis scatters
    first)."""
    for a in tuple(axes):
        x = _reduce_scatter_one(x, mesh.get_group(a), dim)
    return x


# ---------------------------------------------------------------------------
# The same collectives, differentiable (training under a mesh).
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """All-gather over one group; the backward sums (reduce-scatter) or
    takes this rank's block back."""

    @staticmethod
    def forward(ctx, x, group, dim, grad_sum):
        ctx.group, ctx.dim, ctx.grad_sum = group, dim, grad_sum
        return _gather_one(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32) if ctx.grad_sum else g
        fn = _reduce_scatter_one if ctx.grad_sum else _take_one
        return fn(g.contiguous(), ctx.group, ctx.dim), None, None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over one group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_group(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    """Identity; the gradient all-reduced (sum) over one group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_group(g.to(torch.float32), ctx.group).to(g.dtype), \
            None


def _gather_ad(x, group, dim: int, grad_sum: bool) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    if not records_grad(x):
        return _gather_one(x, group, dim)
    return _Gather.apply(x, group, dim, grad_sum)


def all_gather_grad_take(x: torch.Tensor, mesh, axes: Sequence[str],
                         dim: int) -> torch.Tensor:
    """:func:`all_gather` whose gradient is this rank's block of the
    downstream one, which every rank of ``axes`` holds whole (the heads
    gathered over ``model`` before ``wo``): no sum."""
    for a in reversed(tuple(axes)):
        x = _gather_ad(x, mesh.get_group(a), dim, False)
    return x


def all_reduce_grad_pass(x: torch.Tensor, mesh,
                         axes: Sequence[str]) -> torch.Tensor:
    """:func:`all_reduce` (sum) of partials whose sum every rank then uses
    alike (the vocab-parallel lookup, the loss's token sum): the gradient
    passes to every rank's partial unchanged."""
    for a in reversed(tuple(axes)):
        group = mesh.get_group(a)
        if group_size(group) == 1:
            continue
        x = _Reduce.apply(x, group) if records_grad(x) else \
            all_reduce_group(x, group)
    return x


def replicate_grad_sum(x: torch.Tensor, mesh,
                       axes: Sequence[str]) -> torch.Tensor:
    """``x`` unchanged, its gradient summed over ``axes``: where every rank
    holds the same ``x`` and each uses its own part of it (head-parallel
    attention's q/k/v), the pieces' gradients are put back together."""
    for a in tuple(axes):
        group = mesh.get_group(a)
        if group_size(group) > 1 and records_grad(x):
            x = _Replicate.apply(x, group)
    return x


def gather_dtensor(x, keep: Dict[int, Tuple[str, ...]]) -> torch.Tensor:
    """A DTensor's local block with every mesh-dim shard gathered except
    those ``keep`` names (tensor dim -> the mesh axes it stays sharded
    over, as at rest), as a plain tensor.  ``keep={}``: the whole
    tensor.

    Where autograd records it is a weight's gather: its gradient is summed
    over the data axes (each data rank's part comes from its own rows) and
    cut back over the others (every rank there computed the same)."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import BATCH_AXES
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    local = x.to_local()
    # innermost mesh dim first, so a dim over several axes gathers in order
    for i in reversed(range(len(names))):
        pl = x.placements[i]
        if not isinstance(pl, Shard):
            continue
        if names[i] in keep.get(pl.dim, ()):
            continue
        local = _gather_ad(local, mesh.get_group(names[i]), pl.dim,
                           names[i] in BATCH_AXES)
    return local


def dtensor_axes(x) -> Dict[int, Tuple[str, ...]]:
    """tensor dim -> the mesh axes a DTensor shards it over at rest."""
    from torch.distributed.tensor import Shard
    out: Dict[int, Tuple[str, ...]] = {}
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            out[pl.dim] = out.get(pl.dim, ()) + (name,)
    return out


def rank_of(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


# ---------------------------------------------------------------------------
# Error-feedback compressed all-reduce.
# ---------------------------------------------------------------------------


def ef_compress(x: torch.Tensor, err: torch.Tensor, *, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``x + err`` to signed ``bits`` with a per-tensor scale.

    Returns ``(q, scale, new_err)`` with ``q * scale + new_err == x + err``
    and ``|new_err| <= scale / 2`` (round to nearest): the residual the
    wire drops this round is put back next round."""
    y = (x + err).to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.max(torch.abs(y)) / qmax
    scale = torch.maximum(scale, torch.tensor(1e-30, dtype=torch.float32,
                                              device=y.device))
    q = torch.clamp(torch.round(y / scale), -qmax, qmax)
    q = q.to(torch.int8 if bits <= 8 else torch.int32)
    new_err = y - q.to(torch.float32) * scale
    return q, scale, new_err


def ef_compressed_psum(x: torch.Tensor, err: torch.Tensor, group, *,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce ``x`` over ``group`` through integer codes.

    One shared scale (a max all-reduce of each rank's ``amax / qmax``) puts
    every rank on the same grid, so the all-reduced payload is the codes in
    int32 plus one fp32 scalar.  Returns ``(total, new_err)``; the caller
    threads ``new_err`` into the next step (error feedback)."""
    y = (x + err).to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    scale = all_reduce_group(torch.max(torch.abs(y)) / qmax, group,
                             dist.ReduceOp.MAX)
    scale = torch.maximum(scale, torch.tensor(1e-30, dtype=torch.float32,
                                              device=y.device))
    q = torch.clamp(torch.round(y / scale), -qmax, qmax)
    new_err = y - q * scale
    total = all_reduce_group(q.to(torch.int32), group)
    return (total.to(torch.float32) * scale).to(x.dtype), new_err


# ---------------------------------------------------------------------------
# Ring all-gather matmul.
# ---------------------------------------------------------------------------


def _prep_rhs(w: torch.Tensor, w_bits: Optional[int]):
    """Quantize the loop-invariant RHS once, outside the ring."""
    if w_bits is None:
        return w.to(torch.float32), None
    from repro_torch.quant.quantize import quantize_symmetric
    return quantize_symmetric(w, w_bits)


def _shard_matmul(a: torch.Tensor, qb: torch.Tensor, sb, w_bits, context
                  ) -> torch.Tensor:
    """One ring chunk's GEMM; the paper's integer GEMM when a width is
    given, on the backend ``context`` names with its mesh stripped (the
    chunk is this rank's own: re-entering the sharded GEMM would shard it
    again)."""
    if w_bits is None:
        return a.to(torch.float32) @ qb
    from repro_torch.kernels.ops import int_gemm
    from repro_torch.quant.quantize import quantize_symmetric
    if context is not None and context.mesh is not None:
        context = context.replace(mesh=None)
    qa, sa = quantize_symmetric(a, w_bits)
    return int_gemm(qa, qb, w=w_bits, context=context) * sa * sb


def _hop(block: torch.Tensor, group) -> torch.Tensor:
    """``block`` sent to the next rank of the ring; the previous rank's
    received."""
    n = group_size(group)
    me = rank_of(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    recv = torch.empty_like(block)

    def send_recv(outs, ins):
        ops = [dist.P2POp(dist.isend, ins[0], nxt, group=group),
               dist.P2POp(dist.irecv, outs[0], prv, group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(group, "p2p", send_recv, [recv], [block.contiguous()])
    return recv


def ring_ag_matmul(x_shard: torch.Tensor, w: torch.Tensor, group, *,
                   w_bits: Optional[int] = None, context=None
                   ) -> torch.Tensor:
    """``concat_ranks(x) @ w`` without gathering x first: each of the n ring
    steps multiplies the block in hand by ``w`` while the block moves on to
    the next rank.  ``x_shard``: this rank's rows; ``w``: replicated.  With
    ``w_bits`` each chunk GEMM runs the paper's integer GEMM on the backend
    ``context`` picks.  Returns the whole ``(rows_total, n)`` product on
    every rank."""
    n = group_size(group)
    idx = rank_of(group)
    rows = x_shard.shape[0]
    out_dtype = torch.promote_types(x_shard.dtype, w.dtype)
    out = torch.zeros((n * rows, w.shape[1]), dtype=torch.float32,
                      device=x_shard.device)
    qb, sb = _prep_rhs(w, w_bits)
    block = x_shard
    for i in range(n):
        # the block in hand came from rank (idx - i) mod n
        src = (idx - i) % n
        out[src * rows:(src + 1) * rows] = _shard_matmul(block, qb, sb,
                                                         w_bits, context)
        if i + 1 < n:
            block = _hop(block, group)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Split-K decode attention.
# ---------------------------------------------------------------------------

_NEG_INF = -1e30


def splitk_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid: torch.Tensor,
                            group) -> torch.Tensor:
    """One-token decode attention with K/V sharded over ``group`` along
    the sequence.  ``q``: (B, H, D) replicated; ``k``/``v``: (B, S_local,
    KH, D), this rank's sequence slice; ``valid``: (B, S_local) bool.  Each
    rank forms its flash-attention partials; they merge exactly and stably
    as m* = max(m), l* = sum(l e^(m - m*)), o* = sum(o e^(m - m*)).
    Returns (B, H, D) on every rank; GQA with H % KH == 0."""
    b, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qv = q.reshape(b, kh, g, d).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qv, kf) * (d ** -0.5)
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m_local = scores.amax(dim=-1)
    # floored at _NEG_INF by the mask, so an all-invalid shard never sees
    # inf - inf below
    m_global = all_reduce_group(m_local, group, dist.ReduceOp.MAX)
    p = torch.exp(scores - m_global[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l_tot = all_reduce_group(p.sum(dim=-1), group)
    o_tot = all_reduce_group(torch.einsum("bkgs,bskd->bkgd", p, vf), group)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)
