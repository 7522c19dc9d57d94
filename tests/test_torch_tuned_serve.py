"""Serving under a tuning table: the port's quantized matmuls and engine
with a *forcing* table — the staged plan of each width's numerics class
(mm1, kmm2, mm2, kmm2 at depth 2) at every key the model hits — against
the JAX package under the same table (``backend="pallas"``, staged kernels
in interpret mode) and against the port without a table.

A table changes how a GEMM runs, never its value: the staged redirect
(``ops.run_plan`` then the dequant, per expert for batched GEMMs) equals
the fused kernel's epilogue bit for bit, so the quantized matmuls are
``array_equal`` to JAX and to the untabled port, greedy tokens are
identical, prefill logits under the table equal the untabled ones in each
package, and float32 logits agree with JAX within 1e-4 on the inputs of
the port's logit gate (``tests/test_torch_lm.py``: the ops around the
GEMMs differ by a few ulp between XLA and ATen, which can flip an
activation code on other inputs, with or without a table).  At the smoke
configs' K = 64 the fp32 classes keep the fused kernel — no K tile pads
64 to the unclamped 256 that pins their rounding, in either package — so
the models exercise the exact class (mm1, dense and per expert); the fp32
redirects are held at K = 256.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.core.dispatch import ExecPlan as JaxPlan  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant.qmatmul import quantized_matmul as jax_qmm  # noqa: E402
from repro.quant.qmatmul import \
    quantized_matmul_batched as jax_qbmm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.tune import table as jax_table  # noqa: E402
from repro_torch.bridge import (array_to_numpy, array_to_torch,  # noqa: E402
                                params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.core.dispatch import ExecPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant.qmatmul import (quantized_matmul,  # noqa: E402
                                       quantized_matmul_batched)
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.tune import table as port_table  # noqa: E402

F32_ATOL = 1e-4
MAX_SEQ = 32
M_BUCKETS = (8, 16, 32, 64)
GREEDY = [(5, 4), (9, 3), (3, 5)]


def _staged(w: int):
    """(variant, depth, combine_int32) of the staged plan in the numerics
    class of w's analytic plan."""
    if w <= 8:
        return "mm1", 0, True
    if w <= 14:
        return "kmm2", 1, False
    if w <= 16:
        return "mm2", 1, False
    return "kmm2", 2, False


def _forcing_tables(kns, widths):
    """The same forcing table for both packages: the staged plan at every
    (M bucket, K, N, w) key, with block_k 256 where K allows it (the fp32
    classes keep the unclamped padded K only so), 32 below."""
    jt, tt = jax_table.TuningTable(), port_table.TuningTable()
    for m in M_BUCKETS:
        for k, n in kns:
            for w in widths:
                variant, depth, ci = _staged(w)
                bk = 256 if k >= 128 else 32
                jt.put("pallas", (m, k, n), w, JaxPlan(
                    variant, w, backend="pallas", block_m=32,
                    block_n=32 if n < 128 else 128, block_k=bk,
                    combine_int32=ci, depth=depth))
                tt.put("cuda", (m, k, n), w, ExecPlan(
                    variant, w, block_k=bk, combine_int32=ci, depth=depth))
    return jt, tt


@pytest.fixture
def staged_calls(monkeypatch):
    """Counts the staged plans ``ops.run_plan`` runs, by variant."""
    calls = {}
    real = ops.run_plan

    def spy(a, b, *, plan, use_ref_kernels=False):
        calls[plan.variant, plan.depth] = calls.get(
            (plan.variant, plan.depth), 0) + 1
        return real(a, b, plan=plan, use_ref_kernels=use_ref_kernels)

    monkeypatch.setattr(ops, "run_plan", spy)
    yield calls
    jax_table.set_active_table(None)
    port_table.set_active_table(None)


def _np(t):
    return np.asarray(array_to_numpy(t)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 12, 16, 24])
def test_quantized_matmul_under_forcing_table(bits, dtype, staged_calls):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    wm = (rng.standard_normal((256, 96)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16))
    jt, tt = _forcing_tables([(256, 96)], [bits])
    ref = jax_qmm(jnp.asarray(x), jnp.asarray(wm), bits,
                  context=JaxContext(backend="pallas", tuning_table=jt))
    plain = quantized_matmul(array_to_torch(x), array_to_torch(wm), bits)
    assert not staged_calls
    got = quantized_matmul(array_to_torch(x), array_to_torch(wm), bits,
                           context=ExecContext(tuning_table=tt))
    variant, depth, _ = _staged(bits)
    assert staged_calls == {(variant, depth): 1}
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    np.testing.assert_array_equal(_np(got), np.asarray(
        ref.astype(jnp.float32)))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bits", [8, 12])
def test_quantized_matmul_batched_under_forcing_table(bits, staged_calls):
    """The per-expert redirect, dense and ragged: dead rows exact zeros."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((4, 12, 256)).astype(np.float32)
    wm = (rng.standard_normal((4, 256, 40)) * 0.1).astype(np.float32)
    counts = np.array([[3, 0, 4], [4, 4, 4], [0, 0, 0], [1, 2, 0]],
                      np.int32)
    jt, tt = _forcing_tables([(256, 40)], [bits])
    for c in (None, counts):
        kw = {} if c is None else {"counts": c, "seg": 4}
        ref = jax_qbmm(jnp.asarray(x), jnp.asarray(wm), bits,
                       context=JaxContext(backend="pallas", tuning_table=jt),
                       **{k: jnp.asarray(v) if k == "counts" else v
                          for k, v in kw.items()})
        tkw = {k: torch.from_numpy(v) if k == "counts" else v
               for k, v in kw.items()}
        plain = quantized_matmul_batched(array_to_torch(x),
                                         array_to_torch(wm), bits, **tkw)
        staged_calls.clear()
        got = quantized_matmul_batched(array_to_torch(x), array_to_torch(wm),
                                       bits,
                                       context=ExecContext(tuning_table=tt),
                                       **tkw)
        variant, depth, _ = _staged(bits)
        assert staged_calls == {(variant, depth): 4}         # per expert
        np.testing.assert_array_equal(_np(got), np.asarray(
            ref.astype(jnp.float32)), err_msg=f"ragged={c is not None}")
        assert torch.equal(got, plain)
        if c is not None:
            live = np.arange(12)[None, :] % 4 < np.repeat(c, 4, axis=1)
            assert not got.numpy()[~live].any()


def _smoke(arch):
    jcfg = jax_get_config(arch, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    tcfg = get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    d, v = tcfg.d_model, tcfg.padded_vocab
    kns = [(d, tcfg.q_dim), (d, tcfg.kv_dim), (tcfg.q_dim, d), (d, v)]
    if tcfg.n_experts:
        fe = tcfg.d_ff_expert
        kns += [(d, tcfg.n_experts), (d, fe), (fe, d)]
    else:
        kns += [(d, tcfg.d_ff), (tcfg.d_ff, d)]
    return jcfg, jparams, tcfg, tparams, _forcing_tables(kns, (8, 12))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n, _ in GREEDY]


def _port_tokens(tcfg, tparams, prompts, table):
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2, rng_seed=5,
                 context=ExecContext(tuning_table=table), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, (_, m) in zip(prompts, GREEDY)]
    eng.generate(reqs)
    port_table.set_active_table(None)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_smoke_model_serves_jax_tokens_under_forcing_table(arch,
                                                           staged_calls):
    jcfg, jparams, tcfg, tparams, (jt, tt) = _smoke(arch)
    prompts = _prompts(tcfg.vocab_size)
    eng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=2,
                    rng_seed=5,
                    context=JaxContext(backend="pallas", tuning_table=jt))
    reqs = [JaxRequest(prompt=p, max_new_tokens=m)
            for p, (_, m) in zip(prompts, GREEDY)]
    eng.generate(reqs)
    ref = [r.generated for r in reqs]
    staged_calls.clear()
    plain = _port_tokens(tcfg, tparams, prompts, None)
    assert not staged_calls
    got = _port_tokens(tcfg, tparams, prompts, tt)
    assert got == ref == plain
    assert [len(g) for g in got] == [m for _, m in GREEDY]
    # every w=8 GEMM took the staged mm1 path (per expert in MoE layers);
    # lm_head at w=12, K=64 kept the fused kernel
    assert set(staged_calls) == {("mm1", 0)}
    per_call = (7 * tcfg.n_periods if not tcfg.n_experts else
                (4 + 3 * tcfg.n_experts) * tcfg.n_periods)
    assert staged_calls["mm1", 0] % per_call == 0

    # Prefill logits under the table equal the untabled ones in each
    # package, and the port's are within F32_ATOL of JAX's on the inputs
    # of the port's logit gate (tests/test_torch_lm.py: two right-padded
    # prompts of 16 and 11 tokens).
    rng = np.random.default_rng(0)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array([16, 11])[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    last = np.array([15, 10], np.int32)
    jlogs = []
    for table in (jt, None):
        with jax_table.use_table(table):
            jlog, _, _ = jax.jit(lambda p, t, c, m, li: jax_lm.prefill(
                p, jcfg, t, c, pad_mask=m, last_idx=li))(
                jparams, jnp.asarray(toks),
                jax_lm.init_cache(jcfg, 2, MAX_SEQ), jnp.asarray(mask),
                jnp.asarray(last))
        jlogs.append(np.asarray(jlog))
    np.testing.assert_array_equal(jlogs[0], jlogs[1])
    outs = []
    for table in (tt, None):
        with port_table.use_table(table), torch.inference_mode():
            tlog, _, _ = lm.prefill(
                tparams, tcfg, torch.from_numpy(toks),
                lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                pad_mask=torch.from_numpy(mask),
                last_idx=torch.from_numpy(last))
        outs.append(tlog)
    assert torch.equal(outs[0], outs[1])
    v = tcfg.vocab_size
    np.testing.assert_allclose(outs[0].numpy()[:, :v], jlogs[0][:, :v],
                               rtol=0, atol=F32_ATOL)
