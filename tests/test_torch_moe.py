"""The port's MoE path against the JAX reference on the Pallas route:
granite-moe-3b-a800m's smoke config under the mixed policy in float32
compute, with the reference's parameters carried over by
``bridge.params_from_jax``.

  * ``quantized_matmul_batched``: ``array_equal`` (dense and ragged, fp32
    and bf16 inputs, w = 8 and 12);
  * ``moe_apply``: the same expert ids and live counts (with capacity
    drops), outputs within ``MOE_ATOL``, and the load-balance loss;
  * ``prefill`` / ``decode_step`` logits within ``F32_ATOL`` and greedy
    tokens identical to the JAX ``Engine``, with no CUDA launch.

Tolerances: the quantized GEMMs are bit-exact, but softmax, SiLU, RMSNorm
and attention come from XLA and ATen kernels a few ulp apart.  Outputs of
one MoE layer (magnitude ~1) differ by ~1e-7, so ``MOE_ATOL`` = 1e-5 would
still catch one wrong gate or one activation on another quantization step
(~1e-2).  Logits use the 1e-4 of test_torch_lm.py for the same reason.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.quant.qmatmul import maybe_quantized_matmul as jax_mqm  # noqa: E402
from repro.quant.qmatmul import \
    quantized_matmul_batched as jax_qbmm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import (array_to_numpy, array_to_torch,  # noqa: E402
                                params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.quant.qmatmul import quantized_matmul_batched  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "granite-moe-3b-a800m"
MOE_ATOL = 1e-5
F32_ATOL = 1e-4
MAX_SEQ = 32
NO_LAUNCH = {mode: 0 for mode in fg.MODES}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    tcfg = get_config(ARCH, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _np(t):
    return np.asarray(array_to_numpy(t)).astype(np.float32)


def test_configs_match_reference():
    for smoke in (False, True):
        ref = jax_get_config(ARCH, smoke=smoke)
        got = get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name == "pattern":
                assert [dataclasses.astuple(b) for b in got.pattern] == \
                    [dataclasses.astuple(b) for b in ref.pattern]
            elif f.name != "quant":
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
    full = get_config(ARCH)
    assert (full.padded_vocab, full.n_layers) == (49664, 32)


def test_params_from_jax_carries_the_moe_tree(models):
    """The reference's MoE subtree crosses the bridge unchanged, with the
    port's own init giving the same tree, shapes and dtypes."""
    jcfg, jparams, tcfg, tparams = models
    got = tparams["blocks"]["pos0"]["moe"]
    e, d, fe = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    n = tcfg.n_periods
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        "router": ((n, d, e), torch.float32),
        "wi": ((n, e, d, fe), torch.float32),
        "wg": ((n, e, d, fe), torch.float32),
        "wo": ((n, e, fe, d), torch.float32)}
    np.testing.assert_array_equal(
        got["wo"].numpy(), np.asarray(jparams["blocks"]["pos0"]["moe"]["wo"]))
    gen = torch.Generator()
    gen.manual_seed(0)
    own = lm.init_params(gen, tcfg, device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    own_shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), own)
    assert own_shapes == shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 12])
def test_quantized_matmul_batched_matches_jax(bits, dtype):
    fg.reset_launches()
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    wm = (rng.standard_normal((4, 64, 40)) * 0.1).astype(np.float32)
    x[2] = 0.0                              # a zero-token expert buffer
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16))
    counts = np.array([[3, 0, 4], [4, 4, 4], [0, 0, 0], [1, 2, 0]],
                      np.int32)
    jctx = JaxContext(backend="pallas")
    for c in (None, counts):
        kw = {} if c is None else {"counts": c, "seg": 4}
        ref = jax_qbmm(jnp.asarray(x), jnp.asarray(wm), bits, context=jctx,
                       **{k: jnp.asarray(v) if k == "counts" else v
                          for k, v in kw.items()})
        got = quantized_matmul_batched(
            array_to_torch(x), array_to_torch(wm), bits,
            context=ExecContext(),
            **{k: torch.from_numpy(v) if k == "counts" else v
               for k, v in kw.items()})
        assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(got), np.asarray(
            ref.astype(jnp.float32)), err_msg=f"ragged={c is not None}")
    assert fg.grouped_launches == NO_LAUNCH


def test_batched_outside_fused_window_takes_the_aten_route():
    """w=27 and force_mode="mm2" on the grouped GEMM take the ATen route,
    as the reference's take XLA: equal to JAX's "pallas" context, ragged
    too; counts without a seg still raise."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    wm = rng.standard_normal((2, 32, 8)).astype(np.float32)
    counts = np.array([[3], [0]], np.int32)
    for bits, mode in ((27, "auto"), (8, "mm2"), (12, "mm2")):
        for c in (None, counts):
            kw = {} if c is None else {"seg": 4}
            ref = jax_qbmm(jnp.asarray(x), jnp.asarray(wm), bits,
                           context=JaxContext(backend="pallas",
                                              force_mode=mode),
                           counts=None if c is None else jnp.asarray(c),
                           **kw)
            got = quantized_matmul_batched(
                torch.from_numpy(x), torch.from_numpy(wm), bits,
                context=ExecContext(force_mode=mode),
                counts=None if c is None else torch.from_numpy(c), **kw)
            np.testing.assert_array_equal(_np(got), np.asarray(ref))
    with pytest.raises(ValueError):
        quantized_matmul_batched(torch.from_numpy(x), torch.from_numpy(wm),
                                 8, counts=torch.ones(2, 1))


def _skewed_input(cfg, router, seed, b=2, s=16):
    """Tokens leaning towards expert 0, so its capacity overflows and the
    drop path runs."""
    rng = np.random.default_rng(seed)
    r0 = router[:, 0] / np.linalg.norm(router[:, 0])
    x = rng.standard_normal((b, s, cfg.d_model)) + 3.0 * r0
    return x.astype(np.float32)


def _jax_routing(jcfg, p, x):
    """Expert ids (ascending per token) and live counts (E, B) as the
    reference's dispatch computes them."""
    logits = jax_mqm(jnp.asarray(x), p["router"], jcfg.quant, "blk0.moe.router")
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.top_k)
    ids = np.sort(np.asarray(ids), axis=-1)
    s = x.shape[1]
    cap = jax_moe._capacity(s, jcfg.top_k, jcfg.n_experts,
                            jcfg.capacity_factor)
    sizes = np.stack([np.bincount(row.reshape(-1), minlength=jcfg.n_experts)
                      for row in ids])
    return ids, np.minimum(sizes, cap).T, np.asarray(probs)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_matches_jax(models, seed):
    jcfg, jparams, tcfg, tparams = models
    jp = jax.tree.map(lambda a: a[seed], jparams["blocks"]["pos0"]["moe"])
    tp = {k: v[seed] for k, v in tparams["blocks"]["pos0"]["moe"].items()}
    x = _skewed_input(tcfg, np.asarray(jp["router"]), seed)
    ids, counts, _ = _jax_routing(jcfg, jp, x)
    ref, aux = jax.jit(lambda p, xx: jax_moe.moe_apply(
        p, xx, jcfg, jcfg.quant, "blk0.moe"))(jp, jnp.asarray(x))
    fg.reset_launches()
    xt = torch.from_numpy(x)
    r = moe.route(tp, xt, tcfg, tcfg.quant, "blk0.moe")
    got = moe.moe_apply(tp, xt, tcfg, tcfg.quant, "blk0.moe")
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.counts.numpy(), counts)
    b, s, _ = x.shape
    assert int(r.counts.sum()) < b * s * tcfg.top_k     # capacity drops ran
    assert int(r.keep.sum()) == int(r.counts.sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=MOE_ATOL)
    np.testing.assert_allclose(
        float(moe.load_balance_loss(r, tcfg.n_experts)), float(aux),
        rtol=1e-6)
    assert fg.grouped_launches == NO_LAUNCH and fg.launches == NO_LAUNCH


def test_moe_capacity_matches_reference():
    for tokens in (1, 8, 16, 31, 32, 64, 2048):
        for k, e in ((8, 40), (2, 8)):
            assert moe._capacity(tokens, k, e, 1.25) == \
                jax_moe._capacity(tokens, k, e, 1.25)
    assert [moe._capacity(t, 8, 40, 1.25) for t in (1, 8, 32, 64)] == \
        [8, 8, 8, 16]


def _inputs(cfg, lengths=(16, 11)):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(lengths)[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    return toks, mask, np.array(lengths, np.int32) - 1


def test_prefill_and_decode_logits_match_jax(models):
    """Ragged prefill, one decode step on its greedy tokens, and a plain
    prefill in two 8-token chunks (each chunk dispatches on its own)."""
    jcfg, jparams, tcfg, tparams = models
    toks, mask, last = _inputs(tcfg)
    cache = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    logits, cache, _ = jax.jit(lambda p, t, c, m, li: jax_lm.prefill(
        p, jcfg, t, c, pad_mask=m, last_idx=li))(
        jparams, jnp.asarray(toks), cache, jnp.asarray(mask),
        jnp.asarray(last))
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    dlogits, _ = jax.jit(lambda p, t, c, pos: jax_lm.decode_step(
        p, jcfg, t, c, pos))(jparams, nxt, cache, jnp.asarray(last + 1))
    plogits, _, _ = jax.jit(lambda p, t, c: jax_lm.prefill(
        p, jcfg, t, c, chunk_size=8))(jparams, jnp.asarray(toks),
                                      jax_lm.init_cache(jcfg, 2, MAX_SEQ))

    fg.reset_launches()
    with torch.inference_mode():
        tcache = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
        tlog, tcache, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks), tcache,
            pad_mask=torch.from_numpy(mask), last_idx=torch.from_numpy(last))
        tnxt = torch.argmax(tlog, dim=-1)
        tdlog, _ = lm.decode_step(tparams, tcfg, tnxt, tcache,
                                  torch.from_numpy(last + 1))
        tplog, _, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"), chunk_size=8)
    assert fg.grouped_launches == NO_LAUNCH and fg.launches == NO_LAUNCH
    v = tcfg.vocab_size
    for name, r, g in (("ragged prefill", logits, tlog),
                       ("decode", dlogits, tdlog),
                       ("chunked prefill", plogits, tplog)):
        r = np.asarray(r)[:, :v]
        g = g.numpy()[:, :v]
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=F32_ATOL,
                                   err_msg=name)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


GREEDY = [(5, 4), (9, 3), (3, 5)]


def test_greedy_tokens_match_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size, size=n)]
               for n, _ in GREEDY]
    eng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=2,
                    rng_seed=5, context=JaxContext(backend="pallas"))
    reqs = [JaxRequest(prompt=p, max_new_tokens=m)
            for p, (_, m) in zip(prompts, GREEDY)]
    eng.generate(reqs)
    ref = [r.generated for r in reqs]
    fg.reset_launches()
    teng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2, rng_seed=5,
                  device="cpu")
    treqs = [Request(prompt=p, max_new_tokens=m)
             for p, (_, m) in zip(prompts, GREEDY)]
    teng.generate(treqs)
    got = [r.generated for r in treqs]
    assert got == ref
    assert [len(g) for g in got] == [4, 3, 5]
    assert fg.grouped_launches == NO_LAUNCH and fg.launches == NO_LAUNCH
