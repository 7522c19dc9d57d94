"""jamba-v0.1-52b's ``SMOKE`` config through the port's engine against the
JAX engine, float32 compute, the reference's parameters carried over by
``bridge.params_from_jax``: greedy tokens identical plain (2 slots),
chunked prefill of 8 (1 slot) and chunked with prefix-cache hits (prompts
with a 20-token shared head, pages of 16, 1 slot, so every later request
restores a 16-token snapshot, its conv and SSM rows included; the prefix
statistics equal too).

Plain and chunked run under the mixed policy on the Pallas route.  The
prefix prompts run unquantized: under mixed, the second request's second
token is a near tie in the reference which the activation code flips that
tests/test_torch_jamba.py traces decide the other way in every mode,
plain included; the port's own prefix engine is held to its chunked and
plain engines under mixed instead, token for token.  A reused slot starts from zeroed conv and
SSM rows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "jamba-v0.1-52b"
MAX_SEQ = 32
GREEDY = [(5, 4), (9, 3), (3, 5)]     # (prompt length, new tokens)
NEW = [m for _, m in GREEDY]
MODES = {"plain": (2, {}), "chunked": (1, dict(prefill_chunk=8)),
         "prefix": (1, dict(prefill_chunk=8, prefix_cache=True,
                            page_size=16))}


def _models(quant):
    jcfg = jax_get_config(ARCH, smoke=True, quant=quant)
    if quant != "none":
        jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant,
                                                   backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    tcfg = get_config(ARCH, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _prompts(vocab, mode="plain", lengths=None):
    shared, seed = (20, 1) if mode == "prefix" else (0, 0)
    lengths = [n for n, _ in GREEDY] if lengths is None else lengths
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(1, vocab, size=shared)]
    return [head + [int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _port(tcfg, tparams, prompts, mode):
    slots, kw = MODES[mode]
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=slots,
                 rng_seed=5, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, NEW)]
    eng.generate(reqs)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("quant,mode", [("mixed", "plain"),
                                        ("mixed", "chunked"),
                                        ("none", "prefix")])
def test_engine_matches_jax_engine(quant, mode):
    jcfg, jparams, tcfg, tparams = _models(quant)
    prompts = _prompts(tcfg.vocab_size, mode)
    slots, kw = MODES[mode]
    jeng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=slots,
                     rng_seed=5, context=JaxContext(backend="pallas"), **kw)
    jreqs = [JaxRequest(prompt=p, max_new_tokens=m)
             for p, m in zip(prompts, NEW)]
    jeng.generate(jreqs)
    got, eng = _port(tcfg, tparams, prompts, mode)
    assert got == [r.generated for r in jreqs]
    assert [len(g) for g in got] == NEW
    assert not any(launch_counts().values())      # CPU: plain versions
    if mode == "prefix":
        assert eng.prefix.stats() == jeng.prefix.stats()
        assert eng.prefix.stats()["hits"] >= 2


def test_mixed_prefix_engine_equals_chunked_and_plain():
    """Under mixed, prefix-cache hits (restored conv and SSM rows) give the
    chunked engine's tokens, and those the plain engine's."""
    _, _, tcfg, tparams = _models("mixed")
    prompts = _prompts(tcfg.vocab_size, "prefix")
    runs = {mode: _port(tcfg, tparams, prompts, mode) for mode in MODES}
    assert runs["prefix"][0] == runs["chunked"][0] == runs["plain"][0]
    assert runs["prefix"][1].prefix.stats()["hits"] >= 2


def test_reused_slot_starts_from_zero_state():
    """A request served in a slot that held another request gives the
    tokens it gives on a fresh engine: its conv and SSM rows are zeroed at
    admission."""
    tcfg = get_config(ARCH, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init_params(gen, tcfg, device="cpu")
    first, second = _prompts(tcfg.vocab_size, lengths=(9, 4))
    eng = Engine(tcfg, params, max_seq=MAX_SEQ, batch_size=1, device="cpu")
    reqs = [Request(prompt=first, max_new_tokens=6),
            Request(prompt=second, max_new_tokens=5)]
    eng.generate(reqs)
    row = eng.pool.state_table[0]
    for leaf in ("conv", "ssm"):                  # the slot held a request
        assert eng.pool.pools["pos0"][leaf][:, row].abs().sum() > 0
    fresh = Engine(tcfg, params, max_seq=MAX_SEQ, batch_size=1, device="cpu")
    req = Request(prompt=second, max_new_tokens=5)
    fresh.generate([req])
    assert reqs[1].generated == req.generated and len(req.generated) == 5
