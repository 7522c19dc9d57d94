"""Decoder assembly for serving (port of ``repro.models.lm``, attention and
RWKV blocks with a dense or an MoE MLP): parameters, embeddings and head,
the cache (K/V for attention, the carried state for RWKV), ``prefill`` and
``decode_step``.

Parameters keep the reference's tree: ``{"embed", "ln_f", "blocks":
{"pos0": {...}}}`` with block parameters stacked over periods on axis 0
(plus ``"lm_head"`` for untied models).  The reference's ``lax.scan`` over
periods is a Python loop over that axis here.  Cache tensors are updated
in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models.config import ModelConfig
from repro_torch.quant.prequant import is_weight_leaf, record
from repro_torch.quant.qmatmul import maybe_quantized_matmul

Params = Dict[str, Any]

PREFILL_CHUNK = 2048

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "rwkv"):
            raise NotImplementedError(
                f"block {spec} is not ported yet (ROADMAP: recurrent and "
                f"multimodal families)")


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                prequant=None) -> Params:
    """Random parameters from ``gen`` (a seeded ``torch.Generator`` on
    ``device``).  They do not reproduce the reference's ``jax.random``
    values; tests carry the reference's parameters over with
    :func:`repro_torch.bridge.params_from_jax` instead.

    With ``prequant`` (a ``QuantConfig``) the result is
    ``prequantize(init_params(gen, cfg, device=device), prequant)``, built
    leaf by leaf so the fp32 tree never exists: each period's tensors are
    drawn from ``gen`` in the same order, each weight leaf becomes its
    record at once and is written into a preallocated stacked record (a
    stack of per-period records is the stacked leaf's record: the scale
    axis ``ndim - 2`` makes the period axis a batch axis), and an untied
    ``lm_head`` is drawn whole, as ``init_params`` draws it, and quantized
    a chunk of columns at a time (``prequant.record``).  Other leaves are
    as ``init_params`` makes them."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    n = cfg.n_periods
    d = cfg.d_model

    def convert(tree, path):
        """One period's tree with its weight leaves as records."""
        if isinstance(tree, dict):
            return {k: convert(v, path + (k,)) for k, v in tree.items()}
        if prequant is None or not is_weight_leaf(path[-1], tree.dim() + 1):
            return tree
        return record(tree, prequant.bits_for(".".join(path)))

    def put(dst, src, i):
        """``src`` written into period ``i`` of ``dst`` (made at the first
        period)."""
        if isinstance(src, dict):
            dst = dst or {}
            return {k: put(dst.get(k), v, i) for k, v in src.items()}
        if dst is None:
            dst = src.new_empty((n,) + tuple(src.shape))
        dst[i].copy_(src)
        return dst

    def stacked(path, make):
        """``n`` periods of ``make()``, stacked on axis 0: each period's
        leaves (records) written into the stack as they are made."""
        out = None
        for i in range(n):
            out = put(out, convert(make(), path), i)
        return out

    blocks = {}
    for pos, spec in enumerate(cfg.pattern):
        path = ("blocks", f"pos{pos}")
        blk = blocks[f"pos{pos}"] = {
            "ln1": stacked(path + ("ln1",), lambda: L.norm_init(d, device)),
            "ln2": stacked(path + ("ln2",), lambda: L.norm_init(d, device)),
        }
        if spec.kind == "rwkv":
            blk["rwkv"] = stacked(path + ("rwkv",), lambda: R.rwkv_init(
                gen, cfg, dtype, device))
        else:
            blk["attn"] = stacked(path + ("attn",), lambda: L.attn_init(
                gen, cfg, dtype, device))
        if spec.moe:
            blk["moe"] = stacked(path + ("moe",), lambda: M.moe_init(
                gen, cfg, dtype, device))
        else:
            blk["mlp"] = stacked(path + ("mlp",), lambda: L.mlp_init(
                gen, d, cfg.d_ff, cfg.glu, dtype, device))
    params: Params = {
        "embed": L._normal(gen, (cfg.padded_vocab, d), d ** -0.5, dtype,
                           device),
        "blocks": blocks,
        "ln_f": L.norm_init(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(gen, (d, cfg.padded_vocab), d ** -0.5,
                                      dtype, device)
        if prequant is not None:
            params["lm_head"] = record(params["lm_head"],
                                       prequant.bits_for("lm_head"))
    return params


# ---------------------------------------------------------------------------
# Embedding / head.
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    cd = _cdtype(cfg)
    x = params["embed"][tokens.long()].to(cd)
    # the scale rounded to the compute dtype, filled on the device (no
    # host-to-device copy, so a CUDA graph can capture the step)
    return x * torch.full((), cfg.d_model ** 0.5, dtype=cd, device=x.device)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = L.norm_apply(params["ln_f"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = maybe_quantized_matmul(x, w, cfg.quant, "lm_head")
    return _mask_padded_vocab(cfg, out)


def _mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    iota = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(iota < cfg.vocab_size, logits,
                       torch.full_like(logits, -1e30))


# ---------------------------------------------------------------------------
# Cache / blocks.
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device) -> Params:
    """Zeroed cache, every leaf stacked over periods: attention blocks
    {"k", "v"} of (n_periods, B, Smax, K, D) in the compute dtype; RWKV
    blocks {"shift": (n_periods, B, 1, d) in the compute dtype, "wkv":
    (n_periods, B, H, D, D) fp32}."""
    _check_ported(cfg)
    n = cfg.n_periods
    cache = {}
    for pos, spec in enumerate(cfg.pattern):
        if spec.kind == "rwkv":
            cache[f"pos{pos}"] = {
                name: leaf[None].repeat((n,) + (1,) * leaf.dim())
                for name, leaf in R.rwkv_cache_init(
                    cfg, batch, _cdtype(cfg), device=device).items()}
            continue
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        cache[f"pos{pos}"] = {
            "k": torch.zeros(shape, dtype=_cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_cdtype(cfg), device=device)}
    return cache


def _period(tree, i: int):
    """Period ``i``'s slice of a period-stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, pos: int
         ) -> torch.Tensor:
    h = L.norm_apply(p["ln2"], x)
    if cfg.pattern[pos].moe:
        return x + M.moe_apply(p["moe"], h, cfg, cfg.quant, f"blk{pos}.moe")
    return x + L.mlp_apply(p["mlp"], h, cfg.act, cfg.glu, cfg.quant,
                           f"blk{pos}.mlp")


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, t, positions=None,
                kv_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: (B,) int; returns (logits (B, V), cache).

    ``t`` is the KV-cache write index: a scalar, or a (B,) vector for
    continuous batching where every slot sits at its own depth.
    ``positions`` optionally gives distinct RoPE positions; ``kv_valid``
    (B, Smax) masks pad cache slots.  RWKV blocks step their carried state
    and ignore all three."""
    _check_ported(cfg)
    x = _embed(params, cfg, token[:, None])
    for i in range(cfg.n_periods):
        pp = _period(params["blocks"], i)
        pc = _period(cache, i)
        for pos, spec in enumerate(cfg.pattern):
            p = pp[f"pos{pos}"]
            name = f"blk{pos}.{spec.kind}"
            h = L.norm_apply(p["ln1"], x)
            if spec.kind == "rwkv":
                y, _ = R.rwkv_decode(p["rwkv"], h, pc[f"pos{pos}"], cfg,
                                     cfg.quant, name)
            else:
                y, _ = L.attn_decode(p["attn"], h, pc[f"pos{pos}"], t, cfg,
                                     cfg.quant, name, positions=positions,
                                     kv_valid=kv_valid)
            x = _mlp(p, x + y, cfg, pos)
    logits = _logits(params, cfg, x)
    return logits[:, 0, :], cache


def _attn_max_seq(cfg: ModelConfig, cache: Params) -> Optional[int]:
    """Smax of the attention KV cache, or None for attention-free models."""
    for pos, spec in enumerate(cfg.pattern):
        if spec.kind == "attn":
            return cache[f"pos{pos}"]["k"].shape[2]
    return None


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params, chunk_size: int = PREFILL_CHUNK,
            positions: Optional[torch.Tensor] = None,
            pad_mask: Optional[torch.Tensor] = None,
            last_idx: Optional[torch.Tensor] = None,
            start: Optional[int] = None):
    """Prefill ``tokens`` (B, S) into ``cache``; returns (logits at each
    row's last real position (B, V), cache, None).

    Ragged calls (``positions``, ``pad_mask``, ``last_idx`` or ``start``
    given) run as one chunk: ``pad_mask`` (B, S) marks real tokens, masks
    pad keys and freezes the recurrent state on pads, ``positions`` (B, S)
    overrides RoPE positions, ``last_idx`` (B,) picks the logits row (and
    the carried token shift), and ``start`` resumes at that cache offset
    (cache contents below it are valid earlier keys; the recurrent state
    sits at ``start``).  Plain calls run
    ``chunk_size`` tokens at a time and return the last position's logits.
    The third element mirrors the reference's cross-attention memory, which
    dense models do not have.
    """
    _check_ported(cfg)
    ragged = (positions is not None or pad_mask is not None
              or last_idx is not None or start is not None)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    off = 0 if start is None else int(start)
    kv_valid = None
    smax = _attn_max_seq(cfg, cache)
    if pad_mask is not None and smax is not None:
        kvpos = torch.arange(smax, device=x.device)[None, :]
        rel = (kvpos - off).clamp(0, s - 1)
        in_chunk = (kvpos >= off) & (kvpos < off + s)
        chunk_valid = torch.gather(pad_mask.bool(), 1, rel.expand(b, smax))
        kv_valid = torch.where(in_chunk, chunk_valid,
                               torch.ones_like(chunk_valid))

    def run_chunk(xc, offset, pos_c, mask_c, li):
        """One chunk through all periods; pos_c/mask_c/li are the ragged
        extras (None on the plain path)."""
        for i in range(cfg.n_periods):
            pp = _period(params["blocks"], i)
            pc = _period(cache, i)
            for pos, spec in enumerate(cfg.pattern):
                p = pp[f"pos{pos}"]
                name = f"blk{pos}.{spec.kind}"
                h = L.norm_apply(p["ln1"], xc)
                if spec.kind == "rwkv":
                    y, _ = R.rwkv_apply_stateful(
                        p["rwkv"], h, pc[f"pos{pos}"], cfg, cfg.quant, name,
                        mask=mask_c, last_idx=li)
                else:
                    y, _ = L.attn_prefill_chunk(
                        p["attn"], h, pc[f"pos{pos}"], offset, cfg,
                        cfg.quant, name, positions=pos_c, kv_valid=kv_valid)
                xc = _mlp(p, xc + y, cfg, pos)
        return xc

    if ragged:
        li = (last_idx.to(torch.int64) if last_idx is not None
              else torch.full((b,), s - 1, dtype=torch.int64,
                              device=x.device))
        xall = run_chunk(x, off, positions, pad_mask, li)
        last_h = torch.gather(xall, 1, li[:, None, None].expand(
            b, 1, xall.shape[-1]))
        return _logits(params, cfg, last_h)[:, 0, :], cache, None

    cs = min(chunk_size, s)
    while s % cs:
        cs //= 2
    last = None
    for ci in range(s // cs):
        last = run_chunk(x[:, ci * cs:(ci + 1) * cs], ci * cs, None, None,
                         None)[:, -1]
    return _logits(params, cfg, last[:, None, :])[:, 0, :], cache, None
