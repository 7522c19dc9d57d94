"""The port's continuous-batching Engine: greedy tokens identical to the JAX
Engine on the Pallas route (llama3.2-1b smoke, mixed policy, float32
compute, 3 ragged requests on 2 slots), and continuous batching equal to
sequential generation inside the port with a temperature request (sampling
seeds are per (request, step), so neither the slot count nor the decode
bucket width may change a token).
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
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import Block  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

# (prompt length, max_new_tokens, temperature)
GREEDY = [(5, 4, 0.0), (9, 3, 0.0), (3, 5, 0.0)]
MIXED_TEMPS = [(3, 6, 0.0), (9, 1, 0.0), (5, 8, 0.7), (12, 4, 0.0),
               (2, 5, 0.9)]


def _prompts(spec, vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n, _, _ in spec]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3.2-1b", smoke=True, quant="mixed")
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = get_config("llama3.2-1b", smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _run_port(tcfg, tparams, spec, slots):
    eng = Engine(tcfg, tparams, max_seq=32, batch_size=slots, rng_seed=5,
                 device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=m, temperature=t)
            for p, (_, m, t) in zip(_prompts(spec, tcfg.vocab_size), spec)]
    stats = eng.generate(reqs)
    assert stats.generated_tokens == sum(len(r.generated) for r in reqs)
    return [r.generated for r in reqs]


def test_greedy_tokens_match_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models
    eng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=2, rng_seed=5,
                    context=JaxContext(backend="pallas"))
    reqs = [JaxRequest(prompt=p, max_new_tokens=m, temperature=t)
            for p, (_, m, t) in zip(_prompts(GREEDY, jcfg.vocab_size),
                                    GREEDY)]
    eng.generate(reqs)
    ref = [r.generated for r in reqs]
    fg.reset_launches()
    got = _run_port(tcfg, tparams, GREEDY, slots=2)
    assert got == ref
    assert [len(g) for g in got] == [4, 3, 5]
    assert fg.launches == {m: 0 for m in fg.MODES}    # CPU: plain version


def test_continuous_matches_sequential_with_temperature(models):
    _, _, tcfg, tparams = models
    batched = _run_port(tcfg, tparams, MIXED_TEMPS, slots=3)
    sequential = _run_port(tcfg, tparams, MIXED_TEMPS, slots=1)
    assert batched == sequential
    assert [len(g) for g in batched] == [6, 1, 8, 4, 5]
    assert all(0 <= t < tcfg.vocab_size for g in batched for t in g)


def test_engine_refuses_mamba_and_serves_force_mode_mm2(models):
    """What the port still lacks raises rather than changing route: a block
    kind it has not ported, in the engine and in the model; a mamba block
    (jamba's pattern), ported since, gets its state rows instead
    (tests/test_torch_ssm.py, tests/test_torch_jamba.py).  The
    reference's force_mode="mm2" baseline is served on the ATen route: the
    JAX engine's greedy tokens under the same context, every GEMM counted
    there."""
    jcfg, jparams, tcfg, tparams = models
    jamba_like = dataclasses.replace(
        tcfg, pattern=(Block("attn"), Block("mamba", moe=True)))
    cache = lm.init_cache(jamba_like, 1, 32, device="cpu")
    assert set(cache["pos1"]) == {"conv", "ssm"}
    unported = dataclasses.replace(
        tcfg, pattern=(Block("attn"), Block("xattn")))
    with pytest.raises(NotImplementedError, match="xattn"):
        Engine(unported, tparams, max_seq=32, device="cpu")
    with pytest.raises(NotImplementedError, match="xattn"):
        lm.init_cache(unported, 1, 32, device="cpu")
    jeng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=2, rng_seed=5,
                     context=JaxContext(backend="pallas", force_mode="mm2"))
    jreqs = [JaxRequest(prompt=p, max_new_tokens=m, temperature=t)
             for p, (_, m, t) in zip(_prompts(GREEDY, jcfg.vocab_size),
                                     GREEDY)]
    jeng.generate(jreqs)
    eng = Engine(tcfg, tparams, max_seq=32, batch_size=2, rng_seed=5,
                 device="cpu", context=ExecContext(force_mode="mm2"))
    reqs = [Request(prompt=p, max_new_tokens=m, temperature=t)
            for p, (_, m, t) in zip(_prompts(GREEDY, tcfg.vocab_size),
                                    GREEDY)]
    qmatmul.reset_gemm_routes()
    eng.generate(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert set(qmatmul.gemm_routes()) == {("cuda", "aten")}


def test_engine_runs_on_cuda_unless_asked_for_cpu(models):
    """No automatic CPU fallback: without a card, the default device
    raises instead of quietly running the plain versions."""
    _, _, tcfg, tparams = models
    if torch.cuda.is_available():
        eng = Engine(tcfg, tparams, max_seq=32)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(tcfg, tparams, max_seq=32)
