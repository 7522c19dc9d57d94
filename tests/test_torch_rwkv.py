"""The port's RWKV path (repro_torch.models.rwkv, its branches of
repro_torch.models.lm, the pool's recurrent state rows and the engine)
against the JAX reference, rwkv6-3b smoke config under the mixed policy,
float32 compute, with the reference's parameters carried over by
``bridge.params_from_jax``.

Tolerances: every quantized GEMM is bit-exact and the recurrence agrees to
fp32 rounding (test_torch_wkv.py); the ops around them (LayerNorm, the
token-shift blend, the decay's exp/tanh, SiLU) are computed by XLA and by
ATen a few ulp apart.  ``F32_ATOL`` = 1e-4 on logits, block outputs and
carried state leaves room for that and still catches an activation code
that flips to the next quantization step (~1e-2 on logits).  Greedy tokens
must be identical to the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import wkv_gemm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.serve.cache import PagedCachePool  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "rwkv6-3b"
F32_ATOL = 1e-4
MAX_SEQ = 32
LENGTHS = (16, 11)    # ragged, right-padded prompts
# (prompt length, max_new_tokens, temperature): 5 requests on 2 slots, so
# slots are reused
GREEDY = [(5, 4, 0.0), (9, 3, 0.0), (3, 5, 0.0), (12, 4, 0.0), (7, 2, 0.0)]
MIXED_TEMPS = [(3, 6, 0.0), (9, 1, 0.0), (5, 8, 0.7), (12, 4, 0.0),
               (2, 5, 0.9)]


def _jax_cfg():
    jcfg = jax_get_config(ARCH, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    return jcfg.scaled_down(compute_dtype="float32")


def _torch_cfg():
    return get_config(ARCH, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = _jax_cfg()
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jparams, _torch_cfg(),
            params_from_jax(jax.tree.map(np.asarray, jparams)))


def _np(x):
    return np.asarray(x, np.float32)


def test_config_matches_reference():
    for smoke in (False, True):
        ref = jax_get_config(ARCH, smoke=smoke)
        got = get_config(ARCH, smoke=smoke)
        for f in ("d_model", "n_heads", "head_dim", "d_ff", "vocab_size",
                  "n_periods", "act", "glu", "tie_embeddings",
                  "rwkv_head_dim", "param_dtype", "compute_dtype",
                  "padded_vocab", "n_layers", "attn_free", "sub_quadratic"):
            assert getattr(got, f) == getattr(ref, f), f
        assert [b.kind for b in got.pattern] == [b.kind for b in ref.pattern]
    llama = get_config("llama3.2-1b", smoke=True)
    assert not llama.attn_free and not llama.sub_quadratic


def test_init_params_tree_matches_reference(models):
    """The port's seeded init makes the reference's tree: same keys,
    shapes and dtypes (fp32 mix, w0, u, ln_x), which the bridge carries
    over unchanged."""
    jcfg, jparams, tcfg, tparams = models
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = lm.init_params(gen, tcfg, device="cpu")

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert sig(mine) == sig(tparams)
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert sig(tparams) == ref
    blk = tparams["blocks"]["pos0"]["rwkv"]
    assert set(blk["ln_x"]) == {"scale", "bias"}
    assert "lm_head" in tparams          # untied


def test_layer_norm_and_relu2_mlp_match_jax():
    """LayerNorm with bias (ln_x, over all of d_model) and the plain
    (non-GLU) relu^2 MLP at rwkv's smoke widths, quantized (mixed) and
    not."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    ref = jax_layers.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                kind="ln")
    got = L.norm_apply(params_from_jax(p), torch.from_numpy(x), kind="ln")
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    mp = {"wi": rng.standard_normal((64, 128)).astype(np.float32) * 0.125,
          "wo": rng.standard_normal((128, 64)).astype(np.float32) * 0.09}
    jcfg, tcfg = _jax_cfg(), _torch_cfg()
    for quant_j, quant_t in ((jcfg.quant, tcfg.quant), (None, None)):
        ref = jax_layers.mlp_apply(jax.tree.map(jnp.asarray, mp),
                                   jnp.asarray(x), "relu2", False, quant_j,
                                   "blk0.mlp")
        got = L.mlp_apply(params_from_jax(mp), torch.from_numpy(x), "relu2",
                          False, quant_t, "blk0.mlp")
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0,
                                   atol=F32_ATOL)


def _block_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, s, d = 2, 16, cfg.d_model
    hd = cfg.rwkv_head_dim
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.arange(s)[None, :] < np.array(LENGTHS)[:, None]
    last = np.array(LENGTHS, np.int32) - 1
    cache = {"shift": rng.standard_normal((b, 1, d)).astype(np.float32),
             "wkv": rng.standard_normal((b, d // hd, hd, hd)).astype(
                 np.float32) * 0.2}
    return x, mask, last, cache


def test_block_prefill_and_decode_match_jax(models):
    """``rwkv_apply_stateful`` from a nonzero carried state on right-padded
    rows (``mask``/``last_idx``), then ``rwkv_decode`` from the state it
    left: outputs and carried state against the reference."""
    jcfg, jparams, tcfg, tparams = models
    x, mask, last, cache = _block_inputs(tcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["rwkv"])
    tp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["pos0"]["rwkv"].items()}
    out_j, c_j = jax_rwkv.rwkv_apply_stateful(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), jcfg,
        jcfg.quant, "blk0.rwkv", mask=jnp.asarray(mask),
        last_idx=jnp.asarray(last))
    tcache = params_from_jax(cache)
    wkv_gemm.reset_launches()
    out_t, c_t = R.rwkv_apply_stateful(
        tp, torch.from_numpy(x), tcache, tcfg, tcfg.quant, "blk0.rwkv",
        mask=torch.from_numpy(mask), last_idx=torch.from_numpy(last))
    assert c_t["wkv"] is tcache["wkv"]            # updated in place
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=0,
                               atol=F32_ATOL)
    for leaf in ("shift", "wkv"):
        np.testing.assert_allclose(c_t[leaf].numpy(), _np(c_j[leaf]), rtol=0,
                                   atol=F32_ATOL, err_msg=leaf)

    xd = np.random.default_rng(1).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32)
    dout_j, dc_j = jax_rwkv.rwkv_decode(jp, jnp.asarray(xd), c_j, jcfg,
                                        jcfg.quant, "blk0.rwkv")
    dout_t, dc_t = R.rwkv_decode(tp, torch.from_numpy(xd), c_t, tcfg,
                                 tcfg.quant, "blk0.rwkv")
    np.testing.assert_allclose(dout_t.numpy(), _np(dout_j), rtol=0,
                               atol=F32_ATOL)
    for leaf in ("shift", "wkv"):
        np.testing.assert_allclose(dc_t[leaf].numpy(), _np(dc_j[leaf]),
                                   rtol=0, atol=F32_ATOL, err_msg=leaf)
    assert wkv_gemm.launches["wkv"] == 0          # CPU: plain version


def _run_jax(jcfg, jparams, toks, mask, last):
    cache = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    logits, cache, _ = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), cache,
                                      pad_mask=jnp.asarray(mask),
                                      last_idx=jnp.asarray(last))
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    dlogits, cache = jax_lm.decode_step(jparams, jcfg, nxt, cache,
                                        jnp.asarray(last + 1))
    plogits, _, _ = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks),
                                   jax_lm.init_cache(jcfg, 2, MAX_SEQ),
                                   chunk_size=8)
    return (_np(logits), _np(dlogits), _np(plogits),
            jax.tree.map(_np, cache))


def _run_torch(tcfg, tparams, toks, mask, last):
    cache = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    logits, cache, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks),
                                  cache, pad_mask=torch.from_numpy(mask),
                                  last_idx=torch.from_numpy(last))
    nxt = torch.argmax(logits, dim=-1)
    dlogits, cache = lm.decode_step(tparams, tcfg, nxt, cache,
                                    torch.from_numpy(last + 1))
    plogits, _, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks),
                               lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                               chunk_size=8)
    return (logits.numpy(), dlogits.numpy(), plogits.numpy(),
            tree_to_numpy(cache))


@pytest.fixture(scope="module")
def lm_runs(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    last = np.array(LENGTHS, np.int32) - 1
    fg.reset_launches()
    with torch.inference_mode():
        got = _run_torch(tcfg, tparams, toks, mask, last)
    assert fg.launches == {m: 0 for m in fg.MODES}    # CPU: plain version
    return _run_jax(jcfg, jparams, toks, mask, last), got


def test_lm_prefill_and_decode_logits_match_jax(lm_runs):
    ref, got = lm_runs
    for name, r, g in zip(("ragged prefill", "decode", "chunked prefill"),
                          ref[:3], got[:3]):
        assert g.shape == r.shape == (2, 512)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=F32_ATOL,
                                   err_msg=f"{name} logits")
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))


def test_lm_cache_matches_jax(lm_runs):
    """The carried state after the ragged prefill and one decode step:
    (n_periods, B, ...) shift and wkv leaves, as the reference's."""
    ref, got = lm_runs
    for leaf in ("shift", "wkv"):
        r, g = ref[3]["pos0"][leaf], got[3]["pos0"][leaf]
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=F32_ATOL, err_msg=leaf)


@pytest.mark.parametrize("length", [1, 5, 8])
def test_padded_prefill_matches_unpadded(models, length):
    """A right-padded prompt (bucket 8 and 16) gives the unpadded prompt's
    logits and carried state: pads are zeroed before the shift, freeze the
    state, and the shift is taken at the last real token."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(length)
    prompt = rng.integers(1, tcfg.vocab_size, size=length)
    with torch.inference_mode():
        c0 = lm.init_cache(tcfg, 1, MAX_SEQ, device="cpu")
        ref, c0, _ = lm.prefill(tparams, tcfg,
                                torch.from_numpy(prompt[None]), c0)
        for width in (8, 16):
            toks = np.zeros((1, width), np.int64)
            toks[0, :length] = prompt
            c1 = lm.init_cache(tcfg, 1, MAX_SEQ, device="cpu")
            got, c1, _ = lm.prefill(
                tparams, tcfg, torch.from_numpy(toks), c1,
                pad_mask=torch.arange(width)[None] < length,
                last_idx=torch.tensor([length - 1]))
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=F32_ATOL)
            for leaf in ("shift", "wkv"):
                np.testing.assert_allclose(c1["pos0"][leaf].numpy(),
                                           c0["pos0"][leaf].numpy(), rtol=0,
                                           atol=F32_ATOL, err_msg=leaf)


def test_pool_state_rows(models):
    """Recurrent leaves get one state row per slot plus a parking row;
    ``zero_slot_state`` clears one slot's rows only."""
    _, _, tcfg, _ = models
    pool = PagedCachePool(tcfg, 3, MAX_SEQ, 8, device="cpu")
    d, hd = tcfg.d_model, tcfg.rwkv_head_dim
    wkv, shift = pool.pools["pos0"]["wkv"], pool.pools["pos0"]["shift"]
    assert wkv.shape == (tcfg.n_periods, 4, d // hd, hd, hd)
    assert shift.shape == (tcfg.n_periods, 4, 1, d)
    assert wkv.dtype == torch.float32 and shift.dtype == torch.float32
    prows, srows = pool.lane_rows([2, None, 0])
    assert srows.tolist() == [2, 3, 0] and prows.shape == (3, 4)
    wkv.fill_(1.0)
    shift.fill_(1.0)
    pool.zero_slot_state(1)
    assert not wkv[:, 1].any() and not shift[:, 1].any()
    assert wkv[:, [0, 2, 3]].eq(1).all() and shift[:, [0, 2, 3]].eq(1).all()


def _prompts(spec, vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n, _, _ in spec]


def _run_port(tcfg, tparams, spec, slots):
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=slots,
                 rng_seed=5, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=m, temperature=t)
            for p, (_, m, t) in zip(_prompts(spec, tcfg.vocab_size), spec)]
    eng.generate(reqs)
    return [r.generated for r in reqs]


def test_greedy_tokens_match_jax_engine(models):
    """5 requests on 2 slots (slots are reused, so each admission must start
    from a zeroed state) against the reference engine."""
    jcfg, jparams, tcfg, tparams = models
    eng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=2, rng_seed=5,
                    context=JaxContext(backend="pallas"))
    reqs = [JaxRequest(prompt=p, max_new_tokens=m, temperature=t)
            for p, (_, m, t) in zip(_prompts(GREEDY, jcfg.vocab_size),
                                    GREEDY)]
    eng.generate(reqs)
    ref = [r.generated for r in reqs]
    wkv_gemm.reset_launches()
    got = _run_port(tcfg, tparams, GREEDY, slots=2)
    assert got == ref
    assert [len(g) for g in got] == [4, 3, 5, 4, 2]
    assert wkv_gemm.launches["wkv"] == 0          # CPU: plain version


def test_continuous_matches_sequential_with_temperature(models):
    _, _, tcfg, tparams = models
    batched = _run_port(tcfg, tparams, MIXED_TEMPS, slots=3)
    sequential = _run_port(tcfg, tparams, MIXED_TEMPS, slots=1)
    assert batched == sequential
    assert [len(g) for g in batched] == [6, 1, 8, 4, 5]


def test_reused_slot_starts_from_zero_state(models):
    """A request served in a slot that held another request gives the
    tokens it gives on a fresh engine."""
    _, _, tcfg, tparams = models
    spec = [(9, 6, 0.0), (4, 5, 0.0)]
    after = _run_port(tcfg, tparams, spec, slots=1)[1]
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=1, rng_seed=5,
                 device="cpu")
    req = Request(prompt=_prompts(spec, tcfg.vocab_size)[1],
                  max_new_tokens=5)
    eng.generate([req])
    assert after == req.generated and len(after) == 5


def test_launcher_serves_rwkv_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch rwkv6-3b`` (smoke
    config, plain versions on the CPU) serves every request."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "rwkv6-3b", "--quant", "mixed", "--requests", "3",
         "--batch", "2", "--max-new", "3", "--max-seq", "64"],
        capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert sum(line.startswith("req") for line in lines) == 3
    assert "9 tokens" in lines[-1] and "device=cpu" in lines[-1]
