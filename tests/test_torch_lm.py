"""The port's dense decoder (repro_torch.models.lm) against the JAX
reference on the Pallas route, llama3.2-1b smoke config under the mixed
policy, with the reference's parameters carried over by
``bridge.params_from_jax``.

Tolerances, and why they are not zero: every quantized GEMM is bit-exact
(see test_torch_qmatmul.py), but the ops around it — RMSNorm's mean, rsqrt,
RoPE's pow/sin/cos, softmax's exp, the attention matmuls — are computed by
XLA and by ATen with different kernels and summation orders, a few ulp
apart.  In float32 compute the logits (magnitude < 8) differ by about
1e-6; ``F32_ATOL`` = 1e-4 leaves room for that and would still catch a
single activation that flips to the next quantization step (that moves
logits by ~1e-2).  In bfloat16 compute every op outside the GEMM also
rounds to 8 mantissa bits at different places in the two frameworks: the
logits differ by a few bf16 ulps (0.03125 at magnitude 4-8), so the gate is
``BF16_ATOL`` = 0.125.  Greedy tokens must be identical in float32, and in
bfloat16 wherever the reference's top-2 gap exceeds twice that tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.bridge import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.models import lm  # noqa: E402

F32_ATOL = 1e-4
BF16_ATOL = 0.125
MAX_SEQ = 32
LENGTHS = (16, 11)    # ragged, right-padded prompts


def _configs(compute_dtype):
    jcfg = jax_get_config("llama3.2-1b", smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype=compute_dtype)
    tcfg = get_config("llama3.2-1b", smoke=True, quant="mixed").scaled_down(
        compute_dtype=compute_dtype)
    return jcfg, tcfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    last = np.array(LENGTHS, np.int32) - 1
    return toks, mask, last


def _run_jax(jcfg, jparams, toks, mask, last):
    """Ragged prefill, one decode step on its greedy tokens, and the plain
    two-chunk prefill — as the reference computes them."""
    cache = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    prefill = jax.jit(lambda p, t, c, m, li: jax_lm.prefill(
        p, jcfg, t, c, pad_mask=m, last_idx=li))
    logits, cache, _ = prefill(jparams, jnp.asarray(toks), cache,
                               jnp.asarray(mask), jnp.asarray(last))
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    decode = jax.jit(lambda p, t, c, pos: jax_lm.decode_step(
        p, jcfg, t, c, pos))
    dlogits, cache = decode(jparams, nxt, cache, jnp.asarray(last + 1))
    plain = jax.jit(lambda p, t, c: jax_lm.prefill(p, jcfg, t, c,
                                                   chunk_size=8))
    plogits, _, _ = plain(jparams, jnp.asarray(toks),
                          jax_lm.init_cache(jcfg, 2, MAX_SEQ))
    as_np = lambda x: np.asarray(x.astype(jnp.float32))   # noqa: E731
    return (as_np(logits), as_np(dlogits), as_np(plogits),
            jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                         cache))


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
    as_np = lambda x: x.to(torch.float32).numpy()   # noqa: E731
    return (as_np(logits), as_np(dlogits), as_np(plogits),
            {pos: {k: v.astype(np.float32) for k, v in leaves.items()}
             for pos, leaves in tree_to_numpy(cache).items()})


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks, mask, last = _inputs(tcfg)
    fg.reset_launches()
    with torch.inference_mode():
        got = _run_torch(tcfg, tparams, toks, mask, last)
    assert fg.launches == {m: 0 for m in fg.MODES}    # CPU: plain version
    return request.param, _run_jax(jcfg, jparams, toks, mask, last), got


def _vocab_logits(x):
    # padded-vocab columns hold -1e30 in both packages
    return x[..., :512]


def test_prefill_and_decode_logits_match_jax(both):
    dtype, ref, got = both
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for name, r, g in zip(("ragged prefill", "decode", "chunked prefill"),
                          ref[:3], got[:3]):
        assert g.shape == r.shape == (2, 512)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(_vocab_logits(g), _vocab_logits(r),
                                   rtol=0, atol=atol,
                                   err_msg=f"{dtype} {name} logits")


def test_greedy_tokens_match_jax(both):
    dtype, ref, got = both
    for r, g in zip(ref[:3], got[:3]):
        r, g = _vocab_logits(r), _vocab_logits(g)
        top2 = np.sort(r, axis=-1)[:, -2:]
        decided = (np.ones(len(r), bool) if dtype == "float32"
                   else top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL)
        assert decided.any()
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      r.argmax(-1)[decided])


def test_kv_cache_matches_jax(both):
    """The cache after prefill + one decode step: same slots written, same
    values within the logits tolerance (K/V are GEMM outputs after RoPE)."""
    dtype, ref, got = both
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    for leaf in ("k", "v"):
        r, g = ref[3]["pos0"][leaf], got[3]["pos0"][leaf]
        assert g.shape == r.shape
        np.testing.assert_array_equal(g == 0, r == 0)
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal):
    """Whole-sequence attention (the reference's train/encoder path), with
    more than one query chunk and GQA groups."""
    from repro.models.layers import chunked_attention as jax_attention
    from repro_torch.models.layers import chunked_attention

    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, chunk=8)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=F32_ATOL)
