"""seamless-m4t-medium, the encoder-decoder (12 encoder and 12 decoder
layers at d_model 1024, fbank frames of 160 projected into the encoder,
cross-attention in every decoder block, a tied lm_head over 256206
tokens), against the JAX reference on the Pallas route with the
reference's parameters carried over by ``bridge.params_from_jax``, at its
``SMOKE`` widths in float32 on T = 16 frames and S = 8 decoder tokens:

  * the registered config equals the reference's, field for field, and so
    do the quant policies;
  * ``xattn_mem`` / ``xattn_apply`` and the memory (k, v) of every period
    that ``prefill`` returns;
  * prefill logits and 3 greedy decode steps on that memory: unquantized
    within ``F32_ATOL``; under mixed with JAX's codes and scales forced in
    at every quantizer within ``F32_ATOL`` too (every quantized GEMM is
    exact), and unforced with identical greedy tokens and logits within
    ``MIXED_ATOL``.  That gap is a code flip inside the reference: jitted,
    its weight scale ``amax / 127`` comes out an ulp away from the same
    expression run op by op, and on these inputs one code of the
    encoder's first ``mlp.wo`` flips; the port's scales and codes are the
    op-by-op ones;
  * a right-padded ragged prefill against the same JAX call;
  * records from the leaf-wise init equal ``prequantize(init_params)``,
    the encoder, cross-attention and front-end leaves included;
  * the engine refuses the model, as the reference's does.

On the CPU no kernel launches: every launch counter stays zero.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.models.layers as jax_layers  # noqa: E402
import repro.quant.qmatmul as jax_qmatmul  # noqa: E402
import repro_torch.models.layers as torch_layers  # noqa: E402
import repro_torch.quant.qmatmul as torch_qmatmul  # noqa: E402

from repro.configs import QUANT_POLICIES as JAX_POLICIES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import QUANT_POLICIES, get_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import xattn_apply, xattn_mem  # noqa: E402
from repro_torch.quant.prequant import prequantize  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

ARCH = "seamless-m4t-medium"
F32_ATOL = 1e-4
MIXED_ATOL = 0.03
MAX_SEQ = 32
FRAMES, TOKENS, STEPS = 16, 8, 3


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _models(quant, seed=0):
    jcfg = jax_get_config(ARCH, smoke=True, quant=quant)
    if quant != "none":
        jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant,
                                                   backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    tcfg = get_config(ARCH, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, TOKENS)).astype(np.int32)
    frames = rng.standard_normal((2, FRAMES, cfg.frontend_dim)).astype(
        np.float32)
    return toks, frames


def _run_jax(jcfg, jparams, toks, frames):
    """The reference's prefill on the frames and STEPS greedy decode steps
    on its memory: (logits of each call, greedy tokens, memory)."""
    logits, cache, mem = jax.jit(lambda p, t, c, f: jax_lm.prefill(
        p, jcfg, t, c, enc_frames=f))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, MAX_SEQ),
            jnp.asarray(frames))
    step = jax.jit(lambda p, t, c, pos, m: jax_lm.decode_step(
        p, jcfg, t, c, pos, m))
    out, picks = [np.asarray(logits)], []
    for i in range(STEPS):
        picks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
        logits, cache = step(jparams, jnp.asarray(picks[-1]), cache,
                             jnp.int32(TOKENS + i), mem)
        out.append(np.asarray(logits))
    return out, picks, jax.tree.map(np.asarray, mem)


def _run_torch(tcfg, tparams, toks, frames):
    """The port's prefill and STEPS greedy decode steps on its memory."""
    with torch.inference_mode():
        logits, cache, mem = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
            enc_frames=torch.from_numpy(frames))
        out = [logits.numpy().copy()]
        for i in range(STEPS):
            logits, cache = lm.decode_step(tparams, tcfg,
                                           torch.argmax(logits, -1), cache,
                                           TOKENS + i, mem=mem)
            out.append(logits.numpy().copy())
    return out, mem


@pytest.fixture(scope="module", params=["none", "mixed"])
def both(request):
    jcfg, jparams, tcfg, tparams = _models(request.param)
    toks, frames = _inputs(tcfg)
    ref, picks, jmem = _run_jax(jcfg, jparams, toks, frames)
    got, mem = _run_torch(tcfg, tparams, toks, frames)
    assert not any(launch_counts().values())      # CPU: plain versions
    return request.param, tcfg, (ref, picks, jmem), (got, mem)


def test_config_is_registered_with_the_reference_widths():
    assert ARCH in list_archs()
    for smoke in (False, True):
        ref = jax_get_config(ARCH, smoke=smoke)
        got = get_config(ARCH, smoke=smoke)
        assert got.is_encdec and ref.is_encdec
        for f in dataclasses.fields(got):
            if f.name == "pattern":
                assert [(b.kind, b.moe) for b in got.pattern] == \
                    [(b.kind, b.moe) for b in ref.pattern]
            elif f.name != "quant":
                assert getattr(got, f.name) == getattr(ref, f.name), \
                    (smoke, f.name)


def test_quant_policies_equal_the_reference():
    assert QUANT_POLICIES.keys() == JAX_POLICIES.keys()
    for name, ref in JAX_POLICIES.items():
        got = QUANT_POLICIES[name]
        for f in ("enabled", "default_bits", "m", "force_mode", "overrides"):
            assert getattr(got, f) == getattr(ref, f), (name, f)


@pytest.mark.parametrize("quant", ["none", "w8"])
def test_cross_attention_matches_jax(quant):
    jcfg, _, tcfg, _ = _models("none")
    q = jcfg.quant if quant == "none" else JAX_POLICIES[quant]
    jq = dataclasses.replace(q, backend="pallas") if q.enabled else q
    tq = tcfg.quant if quant == "none" else QUANT_POLICIES[quant]
    d = tcfg.d_model
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    enc = rng.standard_normal((2, FRAMES, d)).astype(np.float32)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jk, jv = jax.jit(lambda p, e: jax_layers.xattn_mem(
        p, e, jcfg, jq, "blk0.xattn"))(jp, jnp.asarray(enc))
    jy = jax.jit(lambda p, x, k, v: jax_layers.xattn_apply(
        p, x, k, v, jcfg, jq, "blk0.xattn"))(jp, jnp.asarray(x), jk, jv)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tk, tv = xattn_mem(tp, torch.from_numpy(enc), tcfg, tq, "blk0.xattn")
    ty = xattn_apply(tp, torch.from_numpy(x), tk, tv, tcfg, tq, "blk0.xattn")
    assert tk.shape == (2, FRAMES, tcfg.n_kv_heads, tcfg.head_dim)
    for r, g in ((jk, tk), (jv, tv), (jy, ty)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=F32_ATOL)
    assert not any(launch_counts().values())


def test_memory_of_every_period_matches_jax(both):
    quant, tcfg, (_, _, jmem), (_, mem) = both
    assert set(mem) == set(jmem) == {"pos0"}
    for r, g in zip(jmem["pos0"], mem["pos0"]):
        assert g.shape == r.shape == (tcfg.n_periods, 2, FRAMES,
                                      tcfg.n_kv_heads, tcfg.head_dim)
        for i in range(tcfg.n_periods):
            np.testing.assert_allclose(
                g[i].numpy(), r[i], rtol=0,
                atol=F32_ATOL if quant == "none" else MIXED_ATOL,
                err_msg=f"{quant} period {i}")


def test_prefill_and_decode_logits_match_jax(both):
    quant, tcfg, (ref, picks, _), (got, _) = both
    v = tcfg.vocab_size
    atol = F32_ATOL if quant == "none" else MIXED_ATOL
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape == (2, tcfg.padded_vocab)
        assert np.isfinite(g[:, :v]).all()
        assert (g[:, v:] < -1e29).all()
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0, atol=atol,
                                   err_msg=f"{quant} call {i}")
        np.testing.assert_array_equal(g[:, :v].argmax(-1),
                                      r[:, :v].argmax(-1))


def _named(module, current):
    """Wrap ``module.maybe_quantized_matmul`` so ``current[0]`` holds the
    site name while it runs."""
    inner = module.maybe_quantized_matmul

    def wrapped(x, w, quant, name):
        current[0] = name
        return inner(x, w, quant, name)

    return wrapped


def test_mixed_logits_with_jax_codes_forced_in(monkeypatch):
    """Under mixed, JAX's prefill and decode steps record every operand
    they quantize (codes and scale, and the input) by site name and axis
    (activations per token, weights per output channel); the port runs the
    same calls with those codes and scales forced in at its quantizers (a
    site's k-th quantization takes JAX's k-th; the memory's projections,
    vmapped over periods in JAX, quantize the encoder output once and
    each period's weight as one stacked operand).  Forced, every call's
    logits agree within F32_ATOL: the mixed gap is code flips, not a GEMM.
    The forced activations' inputs stay within a hundredth of a code step
    of JAX's."""
    jcfg, jparams, tcfg, tparams = _models("mixed")
    toks, frames = _inputs(tcfg)
    jname, tname = [None], [None]
    for mod in (jax_layers, jax_lm):
        monkeypatch.setattr(mod, "maybe_quantized_matmul", _named(mod, jname))
    for mod in (torch_layers, lm):
        monkeypatch.setattr(mod, "maybe_quantized_matmul", _named(mod, tname))
    jrec = collections.defaultdict(list)
    jax_quantize = jax_qmatmul._quantize

    def record(x, w, axis):
        q, s = jax_quantize(x, w, axis)
        key = (jname[0], axis == -1)
        jax.debug.callback(lambda *v: jrec[key].append(
            [np.array(t) for t in v]), x, q, s, ordered=True)
        return q, s

    monkeypatch.setattr(jax_qmatmul, "_quantize", record)
    logits, cache, mem = jax.jit(lambda p, t, c, f: jax_lm.prefill(
        p, jcfg, t, c, enc_frames=f))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, MAX_SEQ),
            jnp.asarray(frames))
    jax.effects_barrier()
    ref, picks, calls = [np.asarray(logits)], [], [dict(jrec)]
    step = jax.jit(lambda p, t, c, pos, m: jax_lm.decode_step(
        p, jcfg, t, c, pos, m))
    for i in range(STEPS):
        jrec.clear()
        picks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
        logits, cache = step(jparams, jnp.asarray(picks[i]), cache,
                             jnp.int32(TOKENS + i), mem)
        jax.effects_barrier()
        ref.append(np.asarray(logits))
        calls.append(dict(jrec))

    torch_quantize = torch_qmatmul._quantize
    current, seen, steps = [None], collections.Counter(), []

    def forced(x, w, axis, carrier):
        q, s = torch_quantize(x, w, axis, carrier)
        key = (tname[0], axis == -1)
        recs, k = current[0][key], seen[key]
        seen[key] += 1
        if len(recs) == 1 and recs[0][0].ndim == x.dim() + 1:
            xj, qj, sj = (t[k] for t in recs[0])     # vmapped weights
        else:
            xj, qj, sj = recs[min(k, len(recs) - 1)]
        assert xj.shape == tuple(x.shape), key
        if axis == -1:
            steps.append(float(np.abs(x.numpy() - xj).max() / sj.max()))
        return torch.from_numpy(qj).to(q.dtype), torch.from_numpy(sj)

    monkeypatch.setattr(torch_qmatmul, "_quantize", forced)
    got = []
    with torch.inference_mode():
        cache_t = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
        for i in range(STEPS + 1):
            current[0] = calls[i]
            seen.clear()
            if i == 0:
                out, cache_t, mem_t = lm.prefill(
                    tparams, tcfg, torch.from_numpy(toks), cache_t,
                    enc_frames=torch.from_numpy(frames))
            else:
                out, cache_t = lm.decode_step(
                    tparams, tcfg, torch.from_numpy(picks[i - 1]), cache_t,
                    TOKENS + i - 1, mem=mem_t)
            got.append(out.numpy().copy())
    v = tcfg.vocab_size
    assert max(steps) < 0.01, max(steps)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0,
                                   atol=F32_ATOL, err_msg=f"call {i}")


def test_right_padded_ragged_prefill_matches_jax():
    jcfg, jparams, tcfg, tparams = _models("none")
    toks, frames = _inputs(tcfg)
    lengths = np.array([TOKENS, 5], np.int32)
    mask = np.arange(TOKENS)[None, :] < lengths[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    ref, _, jmem = jax.jit(lambda p, t, c, m, li, f: jax_lm.prefill(
        p, jcfg, t, c, enc_frames=f, pad_mask=m, last_idx=li))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, MAX_SEQ),
            jnp.asarray(mask), jnp.asarray(lengths - 1), jnp.asarray(frames))
    with torch.inference_mode():
        got, _, mem = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
            pad_mask=torch.from_numpy(mask),
            last_idx=torch.from_numpy(lengths - 1),
            enc_frames=torch.from_numpy(frames))
    v = tcfg.vocab_size
    np.testing.assert_allclose(got.numpy()[:, :v], np.asarray(ref)[:, :v],
                               rtol=0, atol=F32_ATOL)
    for r, g in zip(jmem["pos0"], mem["pos0"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=F32_ATOL)


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
    for leaf in (("frontend", "w1"), ("frontend", "w2"),
                 ("encoder", "pos0", "attn", "wq"),
                 ("encoder", "pos0", "mlp", "wo"),
                 ("blocks", "pos0", "xattn", "wk"),
                 ("blocks", "pos0", "xattn", "wo")):
        assert leaf + ("q",) in got and leaf + ("scale",) in got, leaf
    assert ("blocks", "pos0", "lnx", "scale") in got
    assert ("enc_ln_f", "scale") in got
    assert got[("encoder", "pos0", "attn", "wq", "q")].shape[0] == \
        cfg.encoder_periods
    assert not any(p[0] == "lm_head" for p in got)        # tied: embed.T
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path


def test_engine_refuses_encoder_decoder():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError):
        Engine(cfg, params={}, max_seq=16, batch_size=1, device="cpu")
