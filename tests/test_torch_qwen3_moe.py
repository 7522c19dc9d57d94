"""qwen3-moe-30b-a3b (128 experts top-8, expert d_ff 768, GQA 32 q / 4 kv
heads of 128, untied vocab 151936, rope theta 1e6) against the JAX
reference on the Pallas route, with the reference's parameters carried
over by ``bridge.params_from_jax``:

  * the registered config equals the reference's, field for field;
  * ``SMOKE`` (8 experts top-2) under mixed in float32: ragged prefill,
    decode and chunked prefill logits within ``F32_ATOL`` of JAX, greedy
    tokens equal to the JAX engine's;
  * a narrow config that keeps 128 experts and top-8 (d_model 64, expert
    d_ff 32, 2 layers): the same logits, and one MoE layer's expert ids,
    live counts (with capacity drops) and output against JAX, so the
    dispatch, the drops and the combine order run at 128 experts;
  * records from the leaf-wise init equal ``prequantize(init_params)``.

Tolerances are test_torch_moe.py's: the quantized GEMMs are bit-exact, the
ops around them come from XLA and ATen kernels a few ulp apart.
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
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import array_to_numpy, params_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.quant.prequant import prequantize  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
F32_ATOL = 1e-4
MOE_ATOL = 1e-5
MAX_SEQ = 32
LENGTHS = (16, 11)
GREEDY = [(5, 4), (9, 3), (3, 5)]     # (prompt length, new tokens)
# Full width's expert count and top-k on a narrow model.
NARROW = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
              d_ff_expert=32, n_experts=128, top_k=8, vocab_size=512,
              n_periods=2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _configs(narrow: bool):
    jcfg = jax_get_config(ARCH, smoke=True, quant="mixed")
    tcfg = get_config(ARCH, smoke=True, quant="mixed")
    if narrow:
        jcfg = jax_get_config(ARCH, quant="mixed").scaled_down(
            n_microbatches=1, **NARROW)
        tcfg = get_config(ARCH, quant="mixed").scaled_down(**NARROW)
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    return (jcfg.scaled_down(compute_dtype="float32"),
            tcfg.scaled_down(compute_dtype="float32"))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    return (np.where(mask, toks, 0).astype(np.int32), mask,
            np.array(LENGTHS, np.int32) - 1)


def _run_jax(jcfg, jparams, toks, mask, last):
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
    return [np.asarray(x.astype(jnp.float32))
            for x in (logits, dlogits, plogits)]


def _run_torch(tcfg, tparams, toks, mask, last):
    with torch.inference_mode():
        cache = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
        logits, cache, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks), cache,
            pad_mask=torch.from_numpy(mask), last_idx=torch.from_numpy(last))
        dlogits, _ = lm.decode_step(tparams, tcfg, torch.argmax(logits, -1),
                                    cache, torch.from_numpy(last + 1))
        plogits, _, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"), chunk_size=8)
    return [x.to(torch.float32).numpy() for x in (logits, dlogits, plogits)]


@pytest.fixture(scope="module", params=[False, True],
                ids=["smoke", "narrow-128-experts"])
def both(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks, mask, last = _inputs(tcfg)
    got = _run_torch(tcfg, tparams, toks, mask, last)
    assert not any(launch_counts().values())      # CPU: plain versions
    return jcfg, jparams, tcfg, tparams, _run_jax(jcfg, jparams, toks, mask,
                                                  last), got


def test_config_is_registered_with_the_reference_widths():
    assert ARCH in list_archs()
    for smoke in (False, True):
        ref = jax_get_config(ARCH, smoke=smoke)
        got = get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(got):
            if f.name == "pattern":
                assert [(b.kind, b.moe) for b in got.pattern] == \
                    [(b.kind, b.moe) for b in ref.pattern]
            elif f.name != "quant":
                assert getattr(got, f.name) == getattr(ref, f.name), \
                    (smoke, f.name)
    full = get_config(ARCH)
    assert (full.n_experts, full.top_k, full.d_ff_expert, full.n_layers,
            full.tie_embeddings) == (128, 8, 768, 48, False)


def test_prefill_and_decode_logits_match_jax(both):
    _, _, tcfg, _, ref, got = both
    v = tcfg.vocab_size
    for name, r, g in zip(("ragged prefill", "decode", "chunked prefill"),
                          ref, got):
        assert g.shape == r.shape == (2, tcfg.padded_vocab)
        assert np.isfinite(g[:, :v]).all()
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0, atol=F32_ATOL,
                                   err_msg=f"{name} logits")
        np.testing.assert_array_equal(g[:, :v].argmax(-1),
                                      r[:, :v].argmax(-1))


def test_moe_layer_matches_jax_at_128_experts(both):
    """One MoE layer on tokens leaning towards expert 0 (so its capacity
    overflows and drops ride the residual): the reference's expert ids and
    live counts, and its output within MOE_ATOL."""
    jcfg, jparams, tcfg, tparams, _, _ = both
    pj = jax.tree.map(lambda t: t[0], jparams["blocks"]["pos0"]["moe"])
    pt = {k: v[0] for k, v in tparams["blocks"]["pos0"]["moe"].items()}
    router = np.asarray(pj["router"])
    rng = np.random.default_rng(3)
    r0 = router[:, 0] / np.linalg.norm(router[:, 0])
    x = (rng.standard_normal((2, 16, tcfg.d_model)) + 3.0 * r0).astype(
        np.float32)
    logits = jax_mqm(jnp.asarray(x), pj["router"], jcfg.quant,
                     "blk0.moe.router")
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.top_k)
    ids = np.sort(np.asarray(ids), axis=-1)
    cap = jax_moe._capacity(16, jcfg.top_k, jcfg.n_experts,
                            jcfg.capacity_factor)
    per_seq = np.stack([np.bincount(ids[b].ravel(),
                                    minlength=jcfg.n_experts)
                        for b in range(2)])
    counts = np.minimum(per_seq, cap).T
    assert per_seq.max() > cap                   # drops happen
    ref, _ = jax.jit(lambda p, xx: jax_moe.moe_apply(
        p, xx, jcfg, jcfg.quant, "blk0.moe"))(pj, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        r = moe.route(pt, xt, tcfg, tcfg.quant, "blk0.moe")
        got = moe.moe_apply(pt, xt, tcfg, tcfg.quant, "blk0.moe")
    assert r.cap == cap
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.counts.numpy(), counts)
    np.testing.assert_allclose(array_to_numpy(got), np.asarray(ref), rtol=0,
                               atol=MOE_ATOL)


def test_greedy_tokens_match_jax_engine():
    jcfg, tcfg = _configs(False)
    jparams = jax_lm.init_params(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size, size=n)]
               for n, _ in GREEDY]
    jeng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=2,
                     rng_seed=5, context=JaxContext(backend="pallas"))
    jreqs = [JaxRequest(prompt=p, max_new_tokens=m)
             for p, (_, m) in zip(prompts, GREEDY)]
    jeng.generate(jreqs)
    eng = Engine(tcfg, params_from_jax(jax.tree.map(np.asarray, jparams)),
                 max_seq=MAX_SEQ, batch_size=2, rng_seed=5, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, (_, m) in zip(prompts, GREEDY)]
    eng.generate(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in reqs] == [m for _, m in GREEDY]


@pytest.mark.parametrize("narrow", [False, True])
def test_leafwise_records_equal_prequantized_init(narrow):
    cfg = _configs(narrow)[1]
    gen = torch.Generator()
    gen.manual_seed(0)
    want = dict(_leaves(prequantize(lm.init_params(gen, cfg, device="cpu"),
                                    cfg.quant)))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = dict(_leaves(lm.init_params(gen, cfg, device="cpu",
                                      prequant=cfg.quant)))
    assert got.keys() == want.keys()
    assert ("lm_head", "q") in got
    assert any(p[-2:] == ("wi", "q") and want[p].dim() == 4 for p in got)
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
