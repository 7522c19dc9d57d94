"""llava-next-mistral-7b, the vision-language model (Mistral-7B's 32
layers at d_model 4096, GQA with 8 KV heads, an untied lm_head over 32000
tokens, and a prefix of 576 precomputed CLIP patch embeddings of dimension
1024 that a two-GEMM GELU projector maps into the decoder's stream),
against the JAX reference on the Pallas route with the reference's
parameters carried over by ``bridge.params_from_jax``, at its ``SMOKE``
widths in float32:

  * the registered config equals the reference's, field for field, and
    the port registers all ten of the reference's architectures;
  * ``prefill(frontend_embeds=)`` logits and 3 greedy decode steps at
    ``t = frontend_tokens + S``, unquantized and under mixed: logits
    within ``F32_ATOL`` (test_torch_dense_configs.py's), greedy tokens
    identical;
  * a ragged prefill that carries vision embeddings raises
    ``NotImplementedError``, as the reference's does;
  * the engine serves the model text-only and gives the JAX engine's
    greedy tokens;
  * records from the leaf-wise init equal ``prequantize(init_params)``,
    the front end's ``w1`` and ``w2`` included.

On the CPU no kernel launches: every launch counter stays zero.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant.prequant import prequantize  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "llava-next-mistral-7b"
F32_ATOL = 1e-4
MAX_SEQ = 32
TOKENS, STEPS = 8, 3
GREEDY = [(5, 4), (9, 3), (3, 5)]     # (prompt length, new tokens)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _configs(quant):
    jcfg = jax_get_config(ARCH, smoke=True, quant=quant)
    if quant != "none":
        jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant,
                                                   backend="pallas"))
    return (jcfg.scaled_down(compute_dtype="float32"),
            get_config(ARCH, smoke=True, quant=quant).scaled_down(
                compute_dtype="float32"))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, TOKENS)).astype(np.int32)
    embeds = rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return toks, embeds


def _run_jax(jcfg, jparams, toks, embeds):
    logits, cache, mem = jax.jit(lambda p, t, c, e: jax_lm.prefill(
        p, jcfg, t, c, frontend_embeds=e))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, MAX_SEQ),
            jnp.asarray(embeds))
    assert mem is None
    step = jax.jit(lambda p, t, c, pos: jax_lm.decode_step(
        p, jcfg, t, c, pos))
    t0 = jcfg.frontend_tokens + TOKENS
    out = [np.asarray(logits)]
    for i in range(STEPS):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = step(jparams, nxt, cache, jnp.int32(t0 + i))
        out.append(np.asarray(logits))
    return out


def _run_torch(tcfg, tparams, toks, embeds):
    t0 = tcfg.frontend_tokens + TOKENS
    with torch.inference_mode():
        logits, cache, mem = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
            frontend_embeds=torch.from_numpy(embeds))
        assert mem is None
        out = [logits.numpy().copy()]
        for i in range(STEPS):
            logits, cache = lm.decode_step(
                tparams, tcfg, torch.argmax(logits, -1), cache, t0 + i)
            out.append(logits.numpy().copy())
    return out


@pytest.fixture(scope="module", params=["none", "mixed"])
def both(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks, embeds = _inputs(tcfg)
    got = _run_torch(tcfg, tparams, toks, embeds)
    assert not any(launch_counts().values())      # CPU: plain versions
    return (request.param, tcfg, _run_jax(jcfg, jparams, toks, embeds), got,
            tparams)


def test_config_is_registered_with_the_reference_widths():
    assert list_archs() == jax_list_archs()
    for smoke in (False, True):
        ref = jax_get_config(ARCH, smoke=smoke)
        got = get_config(ARCH, smoke=smoke)
        assert got.frontend == "vision" and not got.is_encdec
        for f in dataclasses.fields(got):
            if f.name == "pattern":
                assert [(b.kind, b.moe) for b in got.pattern] == \
                    [(b.kind, b.moe) for b in ref.pattern]
            elif f.name != "quant":
                assert getattr(got, f.name) == getattr(ref, f.name), \
                    (smoke, f.name)


def test_prefill_and_decode_logits_match_jax(both):
    quant, tcfg, ref, got, _ = both
    v = tcfg.vocab_size
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape == (2, tcfg.padded_vocab)
        assert np.isfinite(g[:, :v]).all()
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0,
                                   atol=F32_ATOL, err_msg=f"{quant} call {i}")
        np.testing.assert_array_equal(g[:, :v].argmax(-1),
                                      r[:, :v].argmax(-1))


def test_ragged_prefill_with_vision_embeddings_raises(both):
    _, tcfg, _, _, tparams = both
    toks, embeds = _inputs(tcfg)
    mask = np.ones(toks.shape, bool)
    with pytest.raises(NotImplementedError):
        lm.prefill(tparams, tcfg, torch.from_numpy(toks),
                   lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                   pad_mask=torch.from_numpy(mask),
                   frontend_embeds=torch.from_numpy(embeds))


def test_engine_serves_text_only_like_the_jax_engine():
    jcfg, tcfg = _configs("mixed")
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
    assert not any(launch_counts().values())


def test_leafwise_records_equal_prequantized_init():
    cfg = get_config(ARCH, smoke=True, quant="mixed")
    gen = torch.Generator()
    gen.manual_seed(0)
    want = dict(_leaves(prequantize(lm.init_params(gen, cfg, device="cpu"),
                                    cfg.quant)))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = dict(_leaves(lm.init_params(gen, cfg, device="cpu",
                                      prequant=cfg.quant)))
    assert got.keys() == want.keys()
    assert got[("frontend", "w1", "q")].shape == (cfg.frontend_dim,
                                                  cfg.d_model)
    assert got[("frontend", "w2", "q")].shape == (cfg.d_model, cfg.d_model)
    assert ("lm_head", "q") in got
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
