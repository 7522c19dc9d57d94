"""Model assembly (port of ``repro.models.lm``): attention, mamba and RWKV
blocks with a dense or an MoE MLP, a vision front end's prefix and the
encoder-decoder; parameters, embeddings and head, the cache (K/V for
attention, the carried state for mamba and RWKV), ``prefill`` and
``decode_step`` for serving, and the training forward: ``forward_hidden``,
``forward_train`` (logits and the MoE aux loss) and ``loss_fn`` (next-token
cross-entropy with a sequence-chunked, recomputing head).  Training runs
every block kind: attention (dense, MoE, the vision prefix, the
encoder-decoder), mamba and RWKV, the recurrent ones through their scan
kernels' backward kernels.

Parameters keep the reference's tree: ``{"embed", "ln_f", "blocks":
{"pos0": {...}}}`` with block parameters stacked over periods on axis 0
(plus ``"lm_head"`` for untied models, ``"frontend": {"w1", "w2"}`` for a
model with a front end, and for an encoder-decoder an ``"encoder"`` stack
of ``encoder_periods``, ``"enc_ln_f"``, and ``"lnx"`` / ``"xattn"`` in
every decoder block).  The reference's ``lax.scan`` over periods is a
Python loop over that axis here.  Cache tensors are updated in place and
returned.

Parameters may be one rank's shards (``dist.sharding.shard_params``, the
serve engine under a mesh; ``init_params(mesh=...)``, training under one):
the embedding is looked up vocab-parallel
(``dist.sharding.embed_lookup``) and the tied head quantizes only this
rank's vocab columns, the table's FSDP columns gathered once a serve call
(``dist.sharding.vocab_block``), the GEMMs gather their weights' FSDP rows
(``quant.qmatmul``), and attention runs head-parallel on the pool's kv-head
block, or in training on the ``model`` axis's block of the kv heads
(``models.layers``); RWKV's recurrence likewise on its block of the heads
and mamba's conv and scan on its block of ``d_inner`` (``models.rwkv``,
``models.ssm``), each layer handed its blocks of the state by the cache
it is given.  Training differentiates through all of it: the
collectives' backwards (``dist.collectives``) and the quantized GEMMs'
(``quant.qmatmul._mesh_ste``) reduce each gradient to its shard, and
``loss_fn`` takes the global token mean.  A vision model's projector
and an encoder-decoder's encoder, memory and cross-attention run under
the mesh on this data rank's rows of ``frontend_embeds`` / ``enc_frames``
(and of ``mem`` in decode), their GEMMs sharded as the decoder's and
every head on every ``model`` rank (the GEMMs gather their outputs, so
each rank's gradient of a replicated activation is already the whole
one).  ``constrain_batch_dim`` stands
where the reference constrains an activation's batch dim; it moves no
value.

The front ends are the reference's stubs: a vision model takes
precomputed patch embeddings (``frontend_embeds``, (B, frontend_tokens,
frontend_dim)), projected by a two-GEMM GELU projector into a prefix of
the decoder's sequence; an encoder-decoder takes precomputed frames
(``enc_frames``, (B, T, frontend_dim), projected the same way when
``frontend == "audio"``), runs them through the bidirectional encoder and
projects each decoder block's cross-attention K/V from the encoder output
once a request (``mem``).  As in the reference the encoder has no pad
mask: every frame is attended, so a batch is served on frames of one
length.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (constrain_batch_dim, current_mesh,
                                      data_axes, embed_lookup, leaf_spec,
                                      local_block, periods_whole, select,
                                      transpose, vocab_block, wrap_block)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.quant.prequant import is_weight_leaf, record
from repro_torch.quant.qmatmul import maybe_quantized_matmul

Params = Dict[str, Any]

PREFILL_CHUNK = 2048
AUX_COEF = 0.01
LOSS_CHUNK = 512

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.kind not in ("attn", "mamba", "rwkv"):
            raise NotImplementedError(
                f"block {spec} is not a kind the reference has (attn, "
                f"mamba, rwkv)")
    if cfg.frontend not in ("none", "vision", "audio"):
        raise NotImplementedError(
            f"front end {cfg.frontend!r} is not a kind the reference has "
            f"(none, vision, audio)")


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                prequant=None, mesh=None) -> Params:
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
    a chunk of columns at a time (``prequant.record``); so are the front
    end's ``w1`` and ``w2``.  Other leaves are as ``init_params`` makes
    them.

    With ``mesh`` (training under a mesh) every leaf is drawn as above, in
    the same order, and cut at once to this rank's block under
    ``dist.sharding.leaf_spec`` (a period's leaf to its block of the
    stacked leaf's spec): a leaf is whole only while it is drawn, and the
    tree holds each rank's blocks as ``dist.sharding.shard_params`` lays
    them out — the same logical values as without ``mesh``, from the same
    generator."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    d = cfg.d_model
    metas = None
    if mesh is not None:
        # the global shapes, which place the blocks (no memory)
        metas = init_params(torch.Generator(), cfg, device="meta",
                            prequant=prequant)

    def meta_at(path):
        node = metas
        for k in path:
            node = node[k]
        return node

    def place(tree, path, stacked: bool):
        """With a mesh, each leaf of ``tree`` (a period's when
        ``stacked``) cut to this rank's block of its leaf."""
        if mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: place(v, path + (k,), stacked)
                    for k, v in tree.items()}
        spec = leaf_spec(path, meta_at(path), mesh)
        block = local_block(tree, spec[1:] if stacked else spec, mesh)
        return block if stacked else block.clone()

    def wrap(tree, path, stacked: bool = False):
        """With a mesh, each leaf of ``tree`` held as its DTensor; a
        ``stacked`` leaf, whose periods :func:`place` left whole, cut to
        this rank's periods where its spec shards them (an MoE router)."""
        if mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: wrap(v, path + (k,), stacked)
                    for k, v in tree.items()}
        meta = meta_at(path)
        spec = leaf_spec(path, meta, mesh)
        if stacked and spec and spec[0] is not None:
            tree = local_block(tree, spec[:1], mesh).clone()
        return wrap_block(tree, spec, mesh, meta.shape)

    def convert(tree, path, batch_axes: int = 1):
        """A tree with its weight leaves as records; ``batch_axes``: the
        axes a leaf of ``tree`` lacks against the stacked leaf."""
        if isinstance(tree, dict):
            return {k: convert(v, path + (k,), batch_axes)
                    for k, v in tree.items()}
        if prequant is None or not is_weight_leaf(
                path[-1], tree.dim() + batch_axes):
            return tree
        return record(tree, prequant.bits_for(".".join(path)))

    def put(dst, src, i, n):
        """``src`` written into period ``i`` of ``dst`` (made at the first
        period)."""
        if isinstance(src, dict):
            dst = dst or {}
            return {k: put(dst.get(k), v, i, n) for k, v in src.items()}
        if dst is None:
            dst = src.new_empty((n,) + tuple(src.shape))
        dst[i].copy_(src)
        return dst

    def stacked(path, make, n):
        """``n`` periods of ``make()``, stacked on axis 0: each period's
        leaves (records) written into the stack as they are made."""
        out = None
        for i in range(n):
            out = put(out, place(convert(make(), path), path, True), i, n)
        return wrap(out, path, True)

    def block_stack(root, n, cross_attn):
        """The reference's ``_stack_init``: {posN: blocks stacked over
        ``n`` periods}, with cross-attention (``lnx``, ``xattn``) in the
        decoder blocks of an encoder-decoder."""
        out = {}
        for pos, spec in enumerate(cfg.pattern):
            path = (root, f"pos{pos}")
            blk = out[f"pos{pos}"] = {
                "ln1": stacked(path + ("ln1",),
                               lambda: L.norm_init(d, device), n),
                "ln2": stacked(path + ("ln2",),
                               lambda: L.norm_init(d, device), n),
            }
            if spec.kind == "rwkv":
                blk["rwkv"] = stacked(path + ("rwkv",), lambda: R.rwkv_init(
                    gen, cfg, dtype, device), n)
            elif spec.kind == "mamba":
                blk["mamba"] = stacked(path + ("mamba",),
                                       lambda: S.mamba_init(gen, cfg, dtype,
                                                            device), n)
            else:
                blk["attn"] = stacked(path + ("attn",), lambda: L.attn_init(
                    gen, cfg, dtype, device), n)
            if cross_attn:
                blk["lnx"] = stacked(path + ("lnx",),
                                     lambda: L.norm_init(d, device), n)
                blk["xattn"] = stacked(path + ("xattn",),
                                       lambda: L.attn_init(gen, cfg, dtype,
                                                           device), n)
            if spec.moe:
                blk["moe"] = stacked(path + ("moe",), lambda: M.moe_init(
                    gen, cfg, dtype, device), n)
            else:
                blk["mlp"] = stacked(path + ("mlp",), lambda: L.mlp_init(
                    gen, d, cfg.d_ff, cfg.glu, dtype, device), n)
        return out

    def whole(path, tree):
        """An unstacked leaf (or tree) drawn whole, cut to its blocks."""
        return wrap(place(tree, path, False), path)

    blocks = block_stack("blocks", cfg.n_periods, cfg.is_encdec)
    params: Params = {
        "embed": whole(("embed",), L._normal(
            gen, (cfg.padded_vocab, d), d ** -0.5, dtype, device)),
        "blocks": blocks,
        "ln_f": whole(("ln_f",), L.norm_init(d, device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = whole(("lm_head",), convert(L._normal(
            gen, (d, cfg.padded_vocab), d ** -0.5, dtype, device),
            ("lm_head",), 0))
    if cfg.is_encdec:
        params["encoder"] = block_stack("encoder", cfg.encoder_periods,
                                        False)
        params["enc_ln_f"] = whole(("enc_ln_f",), L.norm_init(d, device))
    if cfg.frontend != "none":
        fd = cfg.frontend_dim
        params["frontend"] = whole(("frontend",), convert({
            "w1": L._normal(gen, (fd, d), fd ** -0.5, dtype, device),
            "w2": L._normal(gen, (d, d), d ** -0.5, dtype, device)},
            ("frontend",), 0))
    return params


# ---------------------------------------------------------------------------
# Embedding / head / front end.
# ---------------------------------------------------------------------------


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    cd = _cdtype(cfg)
    x = embed_lookup(params["embed"], tokens.long()).to(cd)
    # the scale rounded to the compute dtype, filled on the device (no
    # host-to-device copy, so a CUDA graph can capture the step)
    return x * torch.full((), cfg.d_model ** 0.5, dtype=cd, device=x.device)


def _call_params(params: Params) -> Params:
    """``params`` as one model call uses them: a sharded embedding table's
    FSDP columns gathered once, for the lookup and the tied head
    (``dist.sharding.vocab_block``), and a stacked leaf sharded on its
    period dim (an MoE router) gathered once over its periods
    (``dist.sharding.periods_whole``), so that each period indexes a local
    block."""
    return {**params, "embed": vocab_block(params["embed"]),
            "blocks": _periods_whole(params["blocks"])}


def _periods_whole(tree):
    if isinstance(tree, dict):
        return {k: _periods_whole(v) for k, v in tree.items()}
    return periods_whole(tree)


def _frontend_project(params: Params, cfg: ModelConfig,
                      embeds: torch.Tensor) -> torch.Tensor:
    """The front end's projector: the embeddings cast to the compute dtype,
    then ``w1``, GELU (tanh form) and ``w2``."""
    f = params["frontend"]
    h = maybe_quantized_matmul(embeds.to(_cdtype(cfg)), f["w1"], cfg.quant,
                               "frontend.w1")
    h = L._act(h, "gelu")
    return maybe_quantized_matmul(h, f["w2"], cfg.quant, "frontend.w2")


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = L.norm_apply(params["ln_f"], x)
    w = transpose(params["embed"]) if cfg.tie_embeddings \
        else params["lm_head"]
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
    {"k", "v"} of (n_periods, B, Smax, K, D) in the compute dtype; mamba
    blocks {"conv": (n_periods, B, conv_width - 1, d_inner) in the compute
    dtype, "ssm": (n_periods, B, d_inner, d_state) fp32}; RWKV blocks
    {"shift": (n_periods, B, 1, d) in the compute dtype, "wkv":
    (n_periods, B, H, D, D) fp32}."""
    _check_ported(cfg)
    n = cfg.n_periods
    cache = {}
    for pos, spec in enumerate(cfg.pattern):
        if spec.kind in ("mamba", "rwkv"):
            init = (S.mamba_cache_init if spec.kind == "mamba"
                    else R.rwkv_cache_init)
            cache[f"pos{pos}"] = {
                name: leaf[None].repeat((n,) + (1,) * leaf.dim())
                for name, leaf in init(cfg, batch, _cdtype(cfg),
                                       device=device).items()}
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
    return select(tree, i)


def _tail(p: Params, x: torch.Tensor, cfg: ModelConfig, pos: int,
          mem=None, with_aux: bool = False):
    """A block after its mixer's residual: the cross-attention residual
    over ``mem`` ((k, v) of this period, enc-dec decoder blocks), then the
    MLP's (dense or MoE).  With ``with_aux`` (training) the pair (x, the
    MoE aux loss, 0 for a dense MLP)."""
    if mem is not None:
        h = L.norm_apply(p["lnx"], x)
        x = x + L.xattn_apply(p["xattn"], h, mem[0], mem[1], cfg, cfg.quant,
                              f"blk{pos}.xattn")
    h = L.norm_apply(p["ln2"], x)
    if cfg.pattern[pos].moe:
        y = M.moe_apply(p["moe"], h, cfg, cfg.quant, f"blk{pos}.moe",
                        with_aux=with_aux)
    else:
        y = L.mlp_apply(p["mlp"], h, cfg.act, cfg.glu, cfg.quant,
                        f"blk{pos}.mlp")
        if with_aux:
            y = (y, torch.zeros((), dtype=torch.float32, device=x.device))
    if with_aux:
        return x + y[0], y[1]
    return x + y


def _period_mem(mem, i: int, pos: int):
    """Period ``i``'s cross-attention (k, v) at pattern position ``pos``,
    or None without a memory."""
    if mem is None:
        return None
    k, v = mem[f"pos{pos}"]
    return k[i], v[i]


# ---------------------------------------------------------------------------
# Encoder (full-sequence blocks) and cross-attention memory.
# ---------------------------------------------------------------------------


def _attn_bidir(p: Params, x: torch.Tensor, cfg: ModelConfig, quant,
                name: str) -> torch.Tensor:
    """Encoder (non-causal) attention over the whole sequence."""
    b, s, _ = x.shape
    q, k, v = L._qkv(p, x, cfg, quant, name)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    out = L.chunked_attention(q, k, v, causal=False)
    out = out.reshape(b, s, cfg.q_dim)
    return maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")


def _block_train(p: Params, x: torch.Tensor, spec, cfg: ModelConfig,
                 pos: int, mem=None, causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over a whole sequence: attention, causal (training's
    decoder) or bidirectional (the encoder), mamba or RWKV, then
    :func:`_tail`.  Returns (x, the block's MoE aux loss, 0 for a dense
    MLP)."""
    name = f"blk{pos}.{spec.kind}"
    h = L.norm_apply(p["ln1"], x)
    if spec.kind == "attn":
        attn = L.attn_train if causal else _attn_bidir
        y = attn(p["attn"], h, cfg, cfg.quant, name)
    elif spec.kind == "mamba":
        y = S.mamba_apply(p["mamba"], h, cfg, cfg.quant, name)
    else:
        y = R.rwkv_apply(p["rwkv"], h, cfg, cfg.quant, name)
    return _tail(p, x + y, cfg, pos, mem, with_aux=True)


def _scan_blocks(stack: Params, x: torch.Tensor, cfg: ModelConfig,
                 mem=None, causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The period-stacked blocks of ``stack`` (its depth is its leading
    axis) over the whole sequence ``x``; ``mem`` is period-stacked like
    the blocks.  Returns (x, the MoE aux losses summed in block order).
    Under ``cfg.remat``, where autograd records, each period runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, so its quantized GEMMs launch twice a
    step."""
    def period(x, aux, pp, i):
        x = constrain_batch_dim(x)
        for pos, spec in enumerate(cfg.pattern):
            x, a = _block_train(pp[f"pos{pos}"], x, spec, cfg, pos,
                                mem=_period_mem(mem, i, pos), causal=causal)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(stack["pos0"]["ln1"]["scale"].shape[0]):
        pp = _period(stack, i)
        if remat:
            x, aux = checkpoint(period, x, aux, pp, i, use_reentrant=False)
        else:
            x, aux = period(x, aux, pp, i)
    return x, aux


def _encdec_memory(params: Params, cfg: ModelConfig, ex: torch.Tensor
                   ) -> Params:
    """Every decoder block's cross-attention K/V, projected from the
    encoder output ``ex`` (B, T, d) once: {"posN": (k, v)}, each
    (n_periods, B, T, K, D)."""
    out = {}
    for pos in range(len(cfg.pattern)):
        stack = params["blocks"][f"pos{pos}"]["xattn"]
        kv = [L.xattn_mem(_period(stack, i), ex, cfg, cfg.quant,
                          f"blk{pos}.xattn") for i in range(cfg.n_periods)]
        out[f"pos{pos}"] = (torch.stack([k for k, _ in kv]),
                            torch.stack([v for _, v in kv]))
    return out


def _encode(params: Params, cfg: ModelConfig, enc_frames: torch.Tensor
            ) -> Params:
    """The encoder's frames (B, T, frontend_dim), projected when the front
    end is audio (cast otherwise), through the encoder and its final norm,
    to the decoder's cross-attention memory (:func:`_encdec_memory`)."""
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs "
                         f"enc_frames")
    ex = (_frontend_project(params, cfg, enc_frames)
          if cfg.frontend == "audio" else enc_frames.to(_cdtype(cfg)))
    ex, _ = _scan_blocks(params["encoder"], ex, cfg, causal=False)
    ex = L.norm_apply(params["enc_ln_f"], ex)
    return _encdec_memory(params, cfg, ex)


# ---------------------------------------------------------------------------
# Train path.
# ---------------------------------------------------------------------------


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frontend_embeds: Optional[torch.Tensor] = None,
                   enc_frames: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_txt) -> (final hidden (B, S, d), aux loss): a vision
    model's projected ``frontend_embeds`` go before the tokens (S =
    frontend_tokens + S_txt); an encoder-decoder runs ``enc_frames``
    through the encoder (its aux loss counted too) to every decoder
    block's cross-attention memory."""
    _check_ported(cfg)
    x = constrain_batch_dim(_embed(params, cfg, tokens))
    if cfg.frontend == "vision" and frontend_embeds is not None:
        fx = _frontend_project(params, cfg, frontend_embeds)
        x = constrain_batch_dim(torch.cat([fx.to(x.dtype), x], dim=1))
    mem = None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: training "
                             f"needs enc_frames")
        ex = (_frontend_project(params, cfg, enc_frames)
              if cfg.frontend == "audio" else enc_frames.to(_cdtype(cfg)))
        ex, aux_e = _scan_blocks(params["encoder"], ex, cfg, causal=False)
        ex = L.norm_apply(params["enc_ln_f"], ex)
        aux_total = aux_total + aux_e
        mem = _encdec_memory(params, cfg, ex)
    x, aux = _scan_blocks(params["blocks"], x, cfg, mem=mem, causal=True)
    return x, aux_total + aux


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None,
                  enc_frames: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S_txt) -> (logits (B, S, V), aux loss)."""
    params = _call_params(params)
    x, aux = forward_hidden(params, cfg, tokens,
                            frontend_embeds=frontend_embeds,
                            enc_frames=enc_frames)
    return _logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy (mean over ``mask``) + ``AUX_COEF`` x the
    MoE aux loss, with a sequence-chunked, recomputing head.

    The (B, S, V) logits are never materialized: the head GEMM and the CE
    reduce run per sequence chunk of at most ``LOSS_CHUNK`` under
    ``torch.utils.checkpoint`` where autograd records, so the backward
    recomputes each chunk's logits (the head's GEMM launches twice a
    chunk).  The gold logit is an ``iota == label`` select, as the
    reference's.  A vision prefix's positions are stripped before the
    head.

    Under a mesh (the ambient one: ``batch`` holds this data rank's rows)
    the mean is the global one: every data rank's token sum over every
    data rank's mask count, the sum all-reduced with its gradient passed
    to each rank's own rows.  The tied head and the lookup share the
    table's vocab block (``dist.sharding.vocab_block``), so both
    gradients land in the one shard of ``embed``."""
    params = _call_params(params)
    x, aux = forward_hidden(
        params, cfg, batch["tokens"],
        frontend_embeds=batch.get("frontend_embeds"),
        enc_frames=batch.get("enc_frames"))
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:        # vision prefix tokens: strip
        x = x[:, -labels.shape[1]:, :]
    x = L.norm_apply(params["ln_f"], x)
    w = transpose(params["embed"]) if cfg.tie_embeddings \
        else params["lm_head"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    iota = torch.arange(cfg.padded_vocab, dtype=labels.dtype,
                        device=labels.device)[None, None, :]

    def chunk_ce(xc, lc, mc):
        logits = maybe_quantized_matmul(xc, w, cfg.quant, "lm_head")
        logits = _mask_padded_vocab(cfg, logits).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.where(iota == lc[..., None], logits,
                           torch.zeros((), dtype=torch.float32,
                                       device=logits.device)).sum(-1)
        return ((logz - gold) * mc).sum()

    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    while s % chunk:
        chunk //= 2
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        args = (x[:, sl], labels[:, sl], mask[:, sl])
        total = total + (checkpoint(chunk_ce, *args, use_reentrant=False)
                         if remat else chunk_ce(*args))
    count = mask.sum()
    mesh = current_mesh()
    if mesh is not None:
        total = C.all_reduce_grad_pass(total, mesh, data_axes(mesh))
        count = C.all_reduce(count, mesh, data_axes(mesh))
    ce = total / count.clamp_min(1.0)
    return ce + AUX_COEF * aux


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, t, positions=None,
                kv_valid: Optional[torch.Tensor] = None,
                mem: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: (B,) int; returns (logits (B, V), cache).

    ``t`` is the KV-cache write index: a scalar, or a (B,) vector for
    continuous batching where every slot sits at its own depth.
    ``positions`` optionally gives distinct RoPE positions; ``kv_valid``
    (B, Smax) masks pad cache slots.  Mamba and RWKV blocks step their
    carried state and ignore all three.  ``mem`` is an encoder-decoder's
    cross-attention memory, as :func:`prefill` returns it; after a vision
    prefix ``t`` counts the prefix's positions too."""
    _check_ported(cfg)
    params = _call_params(params)
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
            elif spec.kind == "mamba":
                y, _ = S.mamba_decode(p["mamba"], h, pc[f"pos{pos}"], cfg,
                                      cfg.quant, name)
            else:
                y, _ = L.attn_decode(p["attn"], h, pc[f"pos{pos}"], t, cfg,
                                     cfg.quant, name, positions=positions,
                                     kv_valid=kv_valid)
            x = _tail(p, x + y, cfg, pos, _period_mem(mem, i, pos))
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
            start: Optional[int] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None):
    """Prefill ``tokens`` (B, S) into ``cache``; returns (logits at each
    row's last real position (B, V), cache, mem).

    Ragged calls (``positions``, ``pad_mask``, ``last_idx`` or ``start``
    given) run as one chunk: ``pad_mask`` (B, S) marks real tokens, masks
    pad keys and freezes the recurrent state on pads, ``positions`` (B, S)
    overrides RoPE positions, ``last_idx`` (B,) picks the logits row (and
    the carried token shift), and ``start`` resumes at that cache offset
    (cache contents below it are valid earlier keys; the recurrent state
    sits at ``start``).  Plain calls run
    ``chunk_size`` tokens at a time and return the last position's logits.

    A vision model's ``frontend_embeds`` (B, frontend_tokens, frontend_dim)
    are projected and put before the tokens (plain calls only; a ragged
    call with them raises ``NotImplementedError``, as the reference's
    does), so the cache must hold frontend_tokens + S positions.  An
    encoder-decoder's ``enc_frames`` (B, T, frontend_dim) run through the
    encoder (no pad mask: every frame is attended) to the cross-attention
    memory, returned as ``mem`` ({"posN": (k, v)}, each (n_periods, B, T,
    K, D); None for other models) for :func:`decode_step`.
    """
    _check_ported(cfg)
    ragged = (positions is not None or pad_mask is not None
              or last_idx is not None or start is not None)
    if ragged and cfg.frontend == "vision" and frontend_embeds is not None:
        raise NotImplementedError(
            "ragged prefill does not support vision prefix tokens")
    params = _call_params(params)
    x = constrain_batch_dim(_embed(params, cfg, tokens))
    if cfg.frontend == "vision" and frontend_embeds is not None:
        fx = _frontend_project(params, cfg, frontend_embeds)
        x = constrain_batch_dim(torch.cat([fx.to(x.dtype), x], dim=1))
    mem = _encode(params, cfg, enc_frames) if cfg.is_encdec else None
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
                elif spec.kind == "mamba":
                    y, _ = S.mamba_apply_stateful(
                        p["mamba"], h, pc[f"pos{pos}"], cfg, cfg.quant, name,
                        mask=mask_c, last_idx=li)
                else:
                    y, _ = L.attn_prefill_chunk(
                        p["attn"], h, pc[f"pos{pos}"], offset, cfg,
                        cfg.quant, name, positions=pos_c, kv_valid=kv_valid)
                xc = _tail(p, xc + y, cfg, pos, _period_mem(mem, i, pos))
        return xc

    if ragged:
        li = (last_idx.to(torch.int64) if last_idx is not None
              else torch.full((b,), s - 1, dtype=torch.int64,
                              device=x.device))
        xall = run_chunk(x, off, positions, pad_mask, li)
        last_h = torch.gather(xall, 1, li[:, None, None].expand(
            b, 1, xall.shape[-1]))
        return _logits(params, cfg, last_h)[:, 0, :], cache, mem

    cs = min(chunk_size, s)
    while s % cs:
        cs //= 2
    last = None
    for ci in range(s // cs):
        last = run_chunk(x[:, ci * cs:(ci + 1) * cs], ci * cs, None, None,
                         None)[:, -1]
    return _logits(params, cfg, last[:, None, :])[:, 0, :], cache, mem
