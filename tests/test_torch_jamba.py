"""jamba-v0.1-52b (a period of 8 layers: attention at offset 4, mamba
elsewhere, MoE with 16 experts top-2 on every odd layer; d_model 4096,
vocab 65536, untied) against the JAX reference, with the reference's
parameters carried over by ``bridge.params_from_jax``:

  * the registered config equals the reference's, field for field;
  * ``SMOKE`` unquantized in float32 and bfloat16: ragged prefill, decode
    and chunked prefill logits within ``F32_ATOL`` / ``BF16_ATOL`` of JAX
    (test_torch_dense_configs.py's tolerances, greedy tokens identical, in
    bfloat16 where the reference's top-2 gap exceeds twice the tolerance);
  * the same under the mixed policy on the Pallas route: greedy tokens
    identical, logits within ``MIXED_ATOL``.  That gap is activation code
    flips, as test_torch_wide_serve.py shows for w16: on these inputs the
    first code that flips is ``blk4.mlp.wi``'s (and ``wg``'s, the same
    input), where the port's input is a few ulp from JAX's (under a
    hundredth of a code step) and sits on a rounding boundary; every GEMM
    downstream then sees inputs a step apart.  With JAX's codes and scales
    forced in at every activation quantizer, the logits agree to
    ``FORCED_ATOL``;
  * records from the leaf-wise init equal ``prequantize(init_params)``,
    and a large leaf recorded an index of its first axis at a time equals
    its whole record;
  * the padded ragged prefill (right and left padding) against the
    reference's padded call.  Both take the MoE capacity from the padded
    length, so the padded call is the oracle, not an unpadded one: the
    reference's own unpadded rows differ from its padded ones where the
    capacity differs (``repro.models.moe._capacity``), which is why its
    ``test_ragged_prefill_matches_unpadded_recurrent[*-jamba-v0.1-52b]``
    fails; with every MoE off they agree (tests/test_torch_ssm.py).

The engine is tests/test_torch_jamba_serve.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.quant.qmatmul as jax_qmatmul  # noqa: E402
import repro_torch.quant.qmatmul as torch_qmatmul  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import prequant  # noqa: E402
from repro_torch.quant.prequant import prequantize  # noqa: E402

ARCH = "jamba-v0.1-52b"
F32_ATOL = 1e-4
BF16_ATOL = 0.125
MIXED_ATOL = 0.03
FORCED_ATOL = 1e-4
MAX_SEQ = 32
LENGTHS = (16, 11)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _configs(quant, compute_dtype="float32"):
    jcfg = jax_get_config(ARCH, smoke=True, quant=quant)
    if quant != "none":
        jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant,
                                                   backend="pallas"))
    return (jcfg.scaled_down(compute_dtype=compute_dtype),
            get_config(ARCH, smoke=True, quant=quant).scaled_down(
                compute_dtype=compute_dtype))


def _models(quant, compute_dtype="float32", seed=0):
    jcfg, tcfg = _configs(quant, compute_dtype)
    jparams = jax_lm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    return (np.where(mask, toks, 0).astype(np.int32), mask,
            np.array(LENGTHS, np.int32) - 1)


def _run_jax(jcfg, jparams, toks, mask, last):
    """Ragged prefill, one decode step on its greedy tokens, and the plain
    two-chunk prefill, as the reference computes them; and those greedy
    tokens."""
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
            for x in (logits, dlogits, plogits)], np.array(nxt)


def _run_torch(tcfg, tparams, toks, mask, last, nxt):
    """The same, the decode step on the reference's greedy tokens (in
    bfloat16 a near tie may pick another token)."""
    with torch.inference_mode():
        cache = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
        logits, cache, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks), cache,
            pad_mask=torch.from_numpy(mask), last_idx=torch.from_numpy(last))
        dlogits, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt),
                                    cache, torch.from_numpy(last + 1))
        plogits, _, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"), chunk_size=8)
    return [x.to(torch.float32).numpy() for x in (logits, dlogits, plogits)]


CASES = [("none", "float32"), ("none", "bfloat16"), ("mixed", "float32")]
ATOL = {CASES[0]: F32_ATOL, CASES[1]: BF16_ATOL, CASES[2]: MIXED_ATOL}


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    jcfg, jparams, tcfg, tparams = _models(*request.param)
    toks, mask, last = _inputs(tcfg)
    ref, nxt = _run_jax(jcfg, jparams, toks, mask, last)
    got = _run_torch(tcfg, tparams, toks, mask, last, nxt)
    assert not any(launch_counts().values())      # CPU: plain versions
    return request.param, tcfg, ref, got


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
    assert [b.kind for b in full.pattern].count("mamba") == 7
    assert (full.n_layers, full.n_experts, full.top_k, full.d_state,
            full.conv_width, full.expand, full.sub_quadratic,
            full.attn_free) == (32, 16, 2, 16, 4, 2, True, False)


def test_prefill_and_decode_logits_match_jax(both):
    case, tcfg, ref, got = both
    v = tcfg.vocab_size
    for name, r, g in zip(("ragged prefill", "decode", "chunked prefill"),
                          ref, got):
        assert g.shape == r.shape == (2, tcfg.padded_vocab)
        assert np.isfinite(g[:, :v]).all()
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0,
                                   atol=ATOL[case],
                                   err_msg=f"{case} {name} logits")


def test_greedy_tokens_match_jax(both):
    case, tcfg, ref, got = both
    v = tcfg.vocab_size
    for r, g in zip(ref, got):
        r, g = r[:, :v], g[:, :v]
        top2 = np.sort(r, axis=-1)[:, -2:]
        decided = (np.ones(len(r), bool) if case[1] == "float32"
                   else top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL)
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      r.argmax(-1)[decided])


def test_mixed_logit_gap_is_activation_code_flips(monkeypatch):
    """Where the mixed logit gap comes from.  JAX's ragged prefill records
    every activation it quantizes (input, codes, scale) in program order
    (ordered callbacks); the port runs the same prefill with those codes and
    scales forced in at its quantizers, in the same order.  Forced, the
    logits agree to FORCED_ATOL; unforced, the first site whose codes
    differ is blk4's MLP input, whose float input is within a hundredth of
    a code step of JAX's: the flip is a rounding boundary, not a wrong
    GEMM."""
    jcfg, jparams, tcfg, tparams = _models("mixed")
    toks, mask, last = _inputs(tcfg)
    jrec = []
    jax_quantize = jax_qmatmul._quantize

    def record(x, w, axis):
        q, s = jax_quantize(x, w, axis)
        if axis == -1:                  # activations; weights are axis 0/1
            jax.debug.callback(lambda *v: jrec.append(
                [np.array(t) for t in v]), x, q, s, ordered=True)
        return q, s

    monkeypatch.setattr(jax_qmatmul, "_quantize", record)
    ref, _, _ = jax.jit(lambda p, t, c, m, li: jax_lm.prefill(
        p, jcfg, t, c, pad_mask=m, last_idx=li))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, 2, MAX_SEQ),
            jnp.asarray(mask), jnp.asarray(last))
    jax.effects_barrier()
    ref = np.asarray(ref)[:, :tcfg.vocab_size]

    torch_quantize = torch_qmatmul._quantize
    force, sites = [False], []

    def forced(x, w, axis, carrier):
        q, s = torch_quantize(x, w, axis, carrier)
        if axis != -1:
            return q, s
        xj, qj, sj = jrec[len(sites)]
        assert xj.shape == tuple(x.shape)
        sites.append((int(np.abs(q.numpy().astype(np.int64) - qj).max()),
                      float(np.abs(x.numpy() - xj).max() / sj.max())))
        if not force[0]:
            return q, s
        return torch.from_numpy(qj).to(q.dtype), torch.from_numpy(sj)

    monkeypatch.setattr(torch_qmatmul, "_quantize", forced)
    gaps = []
    for force[0] in (False, True):
        sites.clear()
        with torch.inference_mode():
            got, _, _ = lm.prefill(
                tparams, tcfg, torch.from_numpy(toks),
                lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                pad_mask=torch.from_numpy(mask),
                last_idx=torch.from_numpy(last))
        assert len(sites) == len(jrec)
        gaps.append(np.abs(got.numpy()[:, :tcfg.vocab_size] - ref).max())
        if not force[0]:
            first = next((i for i, (d, _) in enumerate(sites) if d), None)
            if first is not None:
                assert sites[first][1] < 0.01, sites[first]
    # the 4 projections of each of blk0-3's mamba, blk1/3's router and 3
    # expert GEMMs, blk0/2's dense MLP, blk4's wq/wk/wv and wo; then
    # blk4's mlp.wi, the first site whose codes differ on these inputs
    assert first in (None, 4 * 4 + 2 * 4 + 2 * 3 + 4), first
    assert gaps[0] <= MIXED_ATOL and gaps[1] <= FORCED_ATOL, gaps


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
    for leaf in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert ("blocks", "pos0", "mamba", leaf, "q") in got
    assert ("blocks", "pos0", "mamba", "a_log") in got
    assert ("lm_head", "q") in got
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path


@pytest.mark.parametrize("bits", [8, 12])
def test_large_leaf_records_an_index_at_a_time(bits, monkeypatch):
    """A leaf with a batch axis past ``RECORD_ELEMS`` (jamba's (16, 4096,
    14336) experts at full width) is quantized one index of its first axis
    at a time: the same record as the whole leaf's, at w=8 (int8) and
    w=12 (int16), for the stacked (P, E, K, N) expert leaves and a
    (P, K, N) stack."""
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = lm.init_params(gen, cfg, device="cpu")
    leaves = [params["blocks"]["pos1"]["moe"]["wi"],
              params["blocks"]["pos0"]["mamba"]["in_proj"]]
    for leaf in leaves:
        whole = prequant.record(leaf, bits)
        with monkeypatch.context() as mp:
            mp.setattr(prequant, "RECORD_ELEMS", leaf[0].numel() - 1)
            parts = prequant.record(leaf, bits)
        assert all(torch.equal(parts[k], whole[k]) for k in whole)
        assert parts["q"].dtype == whole["q"].dtype


@pytest.mark.parametrize("pad", ["right", "left"])
def test_padded_ragged_prefill_matches_jax(pad):
    """The reference's ragged-prefill inputs (4 prompts of 3-12 tokens in a
    16-wide call, right- or left-padded, explicit positions) through both
    padded calls, unquantized in float32: every row's logits within
    F32_ATOL."""
    jcfg, jparams, tcfg, tparams = _models("none", seed=3)
    rng = np.random.default_rng(1)
    lens = [3, 9, 5, 12]
    s, b = 16, len(lens)
    toks = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    mask = np.zeros((b, s), bool)
    last = np.zeros((b,), np.int32)
    for i, n in enumerate(lens):
        p = rng.integers(1, tcfg.vocab_size, size=n)
        if pad == "right":
            toks[i, :n], pos[i], mask[i, :n], last[i] = p, np.arange(s), \
                True, n - 1
        else:
            toks[i, s - n:], pos[i, s - n:], mask[i, s - n:], last[i] = \
                p, np.arange(n), True, s - 1
    ref, _, _ = jax.jit(lambda p, t, c, ps, m, li: jax_lm.prefill(
        p, jcfg, t, c, positions=ps, pad_mask=m, last_idx=li))(
            jparams, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, MAX_SEQ),
            jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(last))
    with torch.inference_mode():
        got, _, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks),
            lm.init_cache(tcfg, b, MAX_SEQ, device="cpu"),
            positions=torch.from_numpy(pos), pad_mask=torch.from_numpy(mask),
            last_idx=torch.from_numpy(last))
    v = tcfg.vocab_size
    np.testing.assert_allclose(got.numpy()[:, :v], np.asarray(ref)[:, :v],
                               rtol=0, atol=F32_ATOL)
