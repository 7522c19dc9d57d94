"""The dense configurations beside llama: gemma-2b (GeGLU, MQA with one KV
head, head_dim 256 at full width, tied embeddings), stablelm-12b (SwiGLU,
GQA, head_dim 160, untied) and nemotron-4-15b (squared ReLU without a
GLU, untied), each at the reference's ``SMOKE`` widths under the mixed
policy, against the JAX reference on the Pallas route with the reference's
parameters carried over by ``bridge.params_from_jax``.

Tolerances are ``test_torch_lm.py``'s, for the same reasons: every
quantized GEMM is bit-exact, the ops around it differ by a few ulp between
XLA and ATen, so float32 logits are held within 1e-4 and bfloat16 logits
within 0.125 (a few bf16 ulps at magnitude 4-8); greedy tokens must be
identical in float32, and in bfloat16 wherever the reference's top-2 gap
exceeds twice that tolerance.  The smoke engine (float32) must give the
JAX engine's greedy tokens.

Leaf-wise init (``lm.init_params(..., prequant=)``) must give exactly the
records ``prequantize(init_params(...))`` gives, and a stack of per-period
records must equal the record of the stacked leaf (the property the
leaf-wise init rests on), ``torch.equal`` both.
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
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import prequant  # noqa: E402
from repro_torch.quant.prequant import prequantize, record  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCHS = ["gemma-2b", "stablelm-12b", "nemotron-4-15b"]
F32_ATOL = 1e-4
BF16_ATOL = 0.125
MAX_SEQ = 32
LENGTHS = (16, 11)
GREEDY = [(5, 4), (9, 3), (3, 5)]     # (prompt length, new tokens)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _configs(arch, compute_dtype):
    jcfg = jax_get_config(arch, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype=compute_dtype)
    tcfg = get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype=compute_dtype)
    return jcfg, tcfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    return (np.where(mask, toks, 0).astype(np.int32), mask,
            np.array(LENGTHS, np.int32) - 1)


def _run_jax(jcfg, jparams, toks, mask, last):
    """Ragged prefill, one decode step on its greedy tokens, and the plain
    two-chunk prefill, as the reference computes them."""
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


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    arch, dtype = request.param
    jcfg, tcfg = _configs(arch, dtype)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks, mask, last = _inputs(tcfg)
    got = _run_torch(tcfg, tparams, toks, mask, last)
    assert not any(launch_counts().values())      # CPU: plain versions
    return dtype, tcfg, _run_jax(jcfg, jparams, toks, mask, last), got


def test_configs_are_registered_with_the_reference_widths():
    for arch in ARCHS:
        assert arch in list_archs()
        for smoke in (False, True):
            ref = jax_get_config(arch, smoke=smoke)
            got = get_config(arch, smoke=smoke)
            for f in dataclasses.fields(got):
                if f.name == "pattern":
                    assert [(b.kind, b.moe) for b in got.pattern] == \
                        [(b.kind, b.moe) for b in ref.pattern]
                elif f.name != "quant":
                    assert getattr(got, f.name) == getattr(ref, f.name), \
                        (arch, smoke, f.name)


def test_prefill_and_decode_logits_match_jax(both):
    dtype, tcfg, ref, got = both
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    v = tcfg.vocab_size
    for name, r, g in zip(("ragged prefill", "decode", "chunked prefill"),
                          ref, got):
        assert g.shape == r.shape == (2, tcfg.padded_vocab)
        assert np.isfinite(g[:, :v]).all()
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0, atol=atol,
                                   err_msg=f"{dtype} {name} logits")


def test_greedy_tokens_match_jax(both):
    dtype, tcfg, ref, got = both
    v = tcfg.vocab_size
    for r, g in zip(ref, got):
        r, g = r[:, :v], g[:, :v]
        top2 = np.sort(r, axis=-1)[:, -2:]
        decided = (np.ones(len(r), bool) if dtype == "float32"
                   else top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL)
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      r.argmax(-1)[decided])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    jcfg, tcfg = _configs(arch, "float32")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_leafwise_records_equal_prequantized_init(arch):
    cfg = get_config(arch, smoke=True, quant="mixed")
    gen = torch.Generator()
    gen.manual_seed(0)
    want = dict(_leaves(prequantize(lm.init_params(gen, cfg, device="cpu"),
                                    cfg.quant)))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = dict(_leaves(lm.init_params(gen, cfg, device="cpu",
                                      prequant=cfg.quant)))
    assert got.keys() == want.keys()
    assert any(p[-1] == "q" for p in got)
    assert ((("lm_head", "q") in got) == (not cfg.tie_embeddings))
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_records_equal_the_stacked_leafs_record(arch, monkeypatch):
    """A stack of per-period records is the stacked leaf's record, at w=8
    (int8) and w=12 (int16), and so is a record quantized in column
    chunks."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator()
    gen.manual_seed(1)
    params = lm.init_params(gen, cfg, device="cpu")
    for bits in (8, 12):
        for _, leaf in _leaves(params["blocks"]):
            if leaf.dim() != 3:
                continue
            whole = record(leaf, bits)
            parts = [record(leaf[i], bits) for i in range(leaf.shape[0])]
            for key in ("q", "scale"):
                assert torch.equal(torch.stack([p[key] for p in parts]),
                                   whole[key])
            with monkeypatch.context() as mp:
                mp.setattr(prequant, "RECORD_COLUMNS", 5)
                chunked = record(leaf, bits)
            assert all(torch.equal(chunked[k], whole[k]) for k in whole)
