"""The train step and the abstract inputs of every step (port of
``repro.launch.steps``).

``make_train_step(cfg, ocfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``: the mean loss and gradient over
``cfg.n_microbatches`` microbatches of the global batch (gradients summed
in fp32 from zero, then divided, as the reference's scan does), then one
AdamW update (``train.optim.update``).  The loss is
``models.lm.loss_fn`` on the ``bf16_cast_params`` compute copy
(:func:`cast_params`); gradients flow back through the casts to the fp32
masters.

Under a mesh (the ambient one, ``dist.sharding.use_mesh``, as
``train.loop.run_training`` sets it) ``params`` and the optimizer state
are each rank's blocks (``lm.init_params(mesh=...)``) and ``batch`` is
the global batch: microbatch i is its rows ``[i*mb, (i+1)*mb)``, as
unsharded, each data rank taking its share of them, so the
per-microbatch means are the reference's.  The compute copy casts each
rank's shard, so the weights' FSDP gathers move bf16.  Each gradient
comes out of the backward cut to its leaf's block (``dist.collectives``,
``quant.qmatmul._mesh_ste``); a leaf whose blocks do not differ over a
data axis is then summed over it here, once a microbatch.  An MoE
layer's expert GEMMs run expert-parallel (``quant.qmatmul._mesh_bste``:
an expert leaf, dim 0 over ``model`` and its K rows over the data axes,
gets its gradient reduce-scattered there), and its load-balance loss
enters the loss as without a mesh, its means over the global microbatch
(``models.moe.load_balance_loss``).  RWKV's recurrence runs
head-parallel and mamba's conv and scan channel-parallel over ``model``
where it divides their heads or channels (``models.rwkv``,
``models.ssm``), their replicated leaves' gradients summed over ``model``
in the backward.  A vision model's ``frontend_embeds`` and an
encoder-decoder's ``enc_frames`` are cut to the same rows as ``tokens``;
the projector, the bidirectional encoder and the cross-attention run on
those rows with their GEMMs sharded as the decoder's, every head on every
``model`` rank (each gets the whole gradient of its replicated output,
so no sum over ``model`` is needed there).

The abstract helpers (:func:`abstract_params`, :func:`abstract_opt_state`,
:func:`train_batch_specs`, :func:`abstract_cache`, :func:`abstract_mem`,
:func:`decode_token_specs`, :func:`input_specs`) give each leaf of a
cell's inputs as an :class:`Abstract` — global shape, dtype and the spec
``dist.sharding``'s rules give it on a mesh — the reference's
``ShapeDtypeStruct`` with its ``NamedSharding``, built on the meta device
(no memory).  ``Abstract.local_bytes`` is a rank's share.  The
reference's ``make_decode_step`` / ``make_prefill_step`` are the serve
executor's (``serve/executor.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ShapeCell
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim

Params = Any

# Leaves the bf16 compute copy keeps in fp32 whatever their size (the
# recurrent blocks' decay, bonus and token-shift mixes).
_KEEP_FP32 = ("a_log", "u", "mix")


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The bf16 compute copy (``cfg.bf16_cast_params``): every fp32 leaf
    with ``ndim >= 2`` and more than 65536 elements (the whole leaf's
    count), whose name is not ``a_log``, ``u`` or ``mix``, cast to bf16
    (differentiably; a sharded leaf's block alone); the rest as they
    are."""
    if not cfg.bf16_cast_params:
        return params

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if (tree.dtype == torch.float32 and tree.dim() >= 2
                and tree.numel() > 65536 and name not in _KEEP_FP32):
            return S.to_dtype(tree, torch.bfloat16)
        return tree

    return walk(params, "")


def _sum_over_data(grads: Params, params: Params, mesh) -> None:
    """Each gradient (this rank's block, fp32) summed in place over the
    data axes its leaf's blocks do not differ over, where each data rank's
    part came from its own rows: one all-reduce of the leaves' flattened
    gradients per set of axes."""
    daxes = S.data_axes(mesh)
    groups: Dict[Tuple[str, ...], list] = {}
    for g, p in zip(optim.tree_leaves(grads), optim.tree_leaves(params)):
        held = S.sharded_axes(p)
        axes = tuple(a for a in daxes if a not in held)
        if S.axes_size(mesh, axes) > 1:
            groups.setdefault(axes, []).append(g)
    for axes, gs in groups.items():
        flat = C.all_reduce(torch.cat([g.reshape(-1) for g in gs]), mesh,
                            axes)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def loss_and_grads(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]):
    """(loss, gradient tree in fp32) of ``loss_fn`` on the compute copy of
    ``params`` (each leaf's block a fresh autograd leaf); an unused leaf's
    gradient is zeros.  Under a mesh ``batch`` is this data rank's rows
    and each gradient is its leaf's block of the global gradient, held as
    the leaf is."""
    leaves = []

    def leaf(p):
        t = S.local(p).detach().requires_grad_(True)
        leaves.append(t)
        return S.like(p, t)

    req = optim.tree_map(leaf, params)
    with torch.enable_grad():
        loss = lm.loss_fn(cast_params(cfg, req), cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    order = iter(leaves)

    def grad_of(_p):
        g, t = next(grads), next(order)
        return torch.zeros_like(t, dtype=torch.float32) if g is None else g

    local = optim.tree_map(grad_of, params)
    mesh = S.current_mesh()
    if mesh is not None:
        _sum_over_data(local, params, mesh)
    return loss.detach(), optim.tree_map(S.like, params, local)


def _microbatch_rows(batch: Dict[str, torch.Tensor], k: int, mesh):
    """Microbatch i's rows for this rank: rows ``[i*mb, (i+1)*mb)`` of the
    global batch, and under a mesh this data rank's share of them, the
    same rows of every input (``tokens``, ``labels``, ``mask``, a vision
    model's ``frontend_embeds``, an encoder-decoder's ``enc_frames``)."""
    rows = next(iter(batch.values())).shape[0]
    d, idx = 1, 0
    if mesh is not None:
        idx, d = S.axes_index(mesh, S.data_axes(mesh))
    if rows % (k * d):
        raise ValueError(
            f"global batch {rows} does not split into {k} microbatches"
            + (f" x {d} data ranks" if d > 1 else ""))
    mb = rows // k
    share = mb // d

    def micro(i):
        lo = i * mb + idx * share
        return {key: v[lo:lo + share] for key, v in batch.items()}

    return micro


def mean_loss_and_grads(cfg: ModelConfig, params: Params,
                        batch: Dict[str, torch.Tensor]):
    """The train step's loss and gradient: over ``cfg.n_microbatches``
    consecutive slices of the global batch's leading axis, summed in fp32
    from zero and divided by their number (one microbatch: taken
    straight).  Peak activation memory scales down by the factor while the
    optimizer sees the same mean gradient.  Under a mesh each data rank
    runs its share of each microbatch's rows."""
    mesh = S.current_mesh()
    k = max(cfg.n_microbatches, 1)
    micro = _microbatch_rows(batch, k, mesh)
    if k == 1:
        return loss_and_grads(cfg, params, batch if mesh is None
                              else micro(0))
    device = S.local(optim.tree_leaves(params)[0]).device
    gsum = optim.tree_map(lambda p: torch.zeros(
        S.local(p).shape, dtype=torch.float32, device=device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(k):
        loss_i, g = loss_and_grads(cfg, params, micro(i))
        optim.tree_map(lambda a, b: a.add_(S.local(b)), gsum, g)
        lsum = lsum + loss_i
        del g
    div = torch.full((), k, dtype=torch.float32, device=device)
    return lsum / div, optim.tree_map(lambda p, g: S.like(p, g / div),
                                      params, gsum)


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig):
    """Train step: :func:`mean_loss_and_grads`, then one AdamW update."""

    def train_step(params, opt_state, batch):
        loss, grads = mean_loss_and_grads(cfg, params, batch)
        new_params, new_state, metrics = optim.update(ocfg, grads, opt_state,
                                                      params)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Abstract inputs (shape, dtype and spec; no allocation).
# ---------------------------------------------------------------------------


class Abstract(NamedTuple):
    """One leaf of a step's inputs, unallocated: its global shape, dtype
    and spec (``dist.sharding``'s tuple, as ``tuple(PartitionSpec)``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Any, ...]

    def local_shape(self, mesh) -> Tuple[int, ...]:
        """A rank's block of the leaf on ``mesh``."""
        out = list(self.shape)
        for d, entry in enumerate(self.spec):
            out[d] //= S.axes_size(mesh, S.entry_axes(entry))
        return tuple(out)

    def local_bytes(self, mesh) -> int:
        n = 1
        for s in self.local_shape(mesh):
            n *= s
        return n * torch.empty((), dtype=self.dtype).element_size()


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, Abstract):
        return fn(*trees)
    if isinstance(first, (tuple, list)):
        parts = [_tree_map(fn, *p) for p in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else type(first)(parts)
    return fn(*trees)


def local_bytes(tree, mesh) -> int:
    """A rank's bytes of an abstract tree on ``mesh``."""
    total = 0

    def add(a):
        nonlocal total
        total += a.local_bytes(mesh)

    _tree_map(add, tree)
    return total


def _abstract(metas, specs):
    return _tree_map(lambda m, s: Abstract(tuple(m.shape), m.dtype, s),
                     metas, specs)


def abstract_params(cfg: ModelConfig, mesh, prequant: bool = False):
    """Every parameter leaf (with ``prequant``: the records) as an
    :class:`Abstract` under ``dist.sharding.leaf_spec`` on ``mesh``."""
    metas = lm.init_params(torch.Generator(), cfg, device="meta",
                           prequant=cfg.quant if prequant else None)
    return _abstract(metas, S.param_sharding(metas, mesh))


def abstract_opt_state(params_abs, mesh) -> optim.OptState:
    """AdamW's state: fp32 mu and nu held as their parameters, the step a
    replicated int32 scalar."""
    like = lambda p: Abstract(p.shape, torch.float32, p.spec)  # noqa: E731
    return optim.OptState(step=Abstract((), torch.int32, ()),
                          mu=_tree_map(like, params_abs),
                          nu=_tree_map(like, params_abs))


def _batch_entry(mesh):
    spec = S.batch_spec(mesh)
    return spec[0] if len(spec) else None


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh
                      ) -> Dict[str, Abstract]:
    """A train (or prefill) cell's batch, dim 0 over the data axes."""
    b, s = cell.global_batch, cell.seq_len
    bspec = _batch_entry(mesh)
    txt = s - cfg.frontend_tokens if cfg.frontend == "vision" else s
    out = {
        "tokens": Abstract((b, txt), torch.int32, (bspec,)),
        "labels": Abstract((b, txt), torch.int32, (bspec,)),
        "mask": Abstract((b, txt), torch.float32, (bspec,)),
    }
    if cfg.frontend == "vision":
        out["frontend_embeds"] = Abstract(
            (b, cfg.frontend_tokens, cfg.frontend_dim), torch.float32,
            (bspec,))
    if cfg.is_encdec:
        out["enc_frames"] = Abstract((b, s, cfg.frontend_dim),
                                     torch.float32, (bspec,))
    return out


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_seq: int):
    """The decode cache under ``dist.sharding.cache_sharding``."""
    metas = lm.init_cache(cfg, batch, max_seq, device="meta")
    return _abstract(metas, S.cache_sharding(metas, mesh, batch=batch))


def abstract_mem(cfg: ModelConfig, mesh, params_abs, batch: int,
                 enc_len: int):
    """An encoder-decoder's cross-attention memory for decode: {"posN":
    (k, v)}, each (n_periods, batch, enc_len, kv heads, head_dim) in the
    compute dtype, dim 1 over the data axes; None for other models."""
    if not cfg.is_encdec:
        return None
    bspec = _batch_entry(mesh)
    dtype = lm._cdtype(cfg)
    shape = (cfg.n_periods, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    leaf = Abstract(shape, dtype, (None, bspec, None, None, None))
    return {f"pos{pos}": (leaf, leaf) for pos in range(len(cfg.pattern))}


def decode_token_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """(the decode tokens (B,), the write index t ())."""
    b = cell.global_batch
    bspec = None if b == 1 else _batch_entry(mesh)
    return (Abstract((b,), torch.int32, (bspec,)),
            Abstract((), torch.int32, ()))


ENC_MEM_LEN = 4096  # cross-attention memory length for enc-dec decode cells


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                ocfg: Optional[optim.AdamWConfig] = None,
                prequant: bool = False) -> Dict[str, Any]:
    """All abstract inputs of the cell's step function."""
    params_abs = abstract_params(cfg, mesh,
                                 prequant=prequant and cell.kind != "train")
    if cell.kind == "train":
        return {"params": params_abs,
                "opt_state": abstract_opt_state(params_abs, mesh),
                "batch": train_batch_specs(cfg, cell, mesh)}
    cache = abstract_cache(cfg, mesh, cell.global_batch, cell.seq_len)
    if cell.kind == "prefill":
        return {"params": params_abs, "cache": cache,
                "batch": train_batch_specs(cfg, cell, mesh)}
    token, t = decode_token_specs(cfg, cell, mesh)
    out = {"params": params_abs, "cache": cache, "token": token, "t": t}
    mem = abstract_mem(cfg, mesh, params_abs, cell.global_batch, ENC_MEM_LEN)
    if mem is not None:
        out["mem"] = mem
    return out
