"""The port's pre-quantized weight records (repro_torch.quant.prequant) and
their GEMM (qmatmul.prequant_matmul) against the JAX reference on the
Pallas route (interpret mode).

  * records: ``array_equal`` (codes, their int8/int16 storage dtype, and
    scales) to JAX's ``prequantize`` on the bridged smoke llama3.2-1b,
    granite-moe-3b-a800m and rwkv6-3b trees at the mixed policy, w12, w16
    and w20.  At w = 20 the codes do not fit int16: XLA's conversion
    saturates where ``Tensor.to(torch.int16)`` wraps, and the port clamps
    to reproduce the reference's records;
  * leaves outside the reference's set — norms, the MoE router, the tied
    lm_head (``embed``) — stay the input's tensors;
  * ``prequant_matmul`` dense, batched and ragged: ``array_equal`` to JAX's;
  * a prequantized model's prefill and decode logits: ``torch.equal`` to
    the port's per-call path (the records are the per-call codes through
    w = 16), and within ``F32_ATOL`` of JAX's prequantized run (float32
    compute; ops outside the GEMMs are XLA's and ATen's, a few ulp apart,
    as in test_torch_lm.py).
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
from repro.quant import policy as jax_policy  # noqa: E402
from repro.quant.prequant import prequantize as jax_prequantize  # noqa: E402
from repro.quant.qmatmul import prequant_matmul as jax_pqmm  # noqa: E402
from repro_torch.bridge import (array_to_numpy, array_to_torch,  # noqa: E402
                                params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import policy  # noqa: E402
from repro_torch.quant.prequant import (is_prequantized,  # noqa: E402
                                        prequantize, storage_dtype)
from repro_torch.quant.qmatmul import prequant_matmul  # noqa: E402
from repro_torch.quant.quantize import quantize_symmetric  # noqa: E402

F32_ATOL = 1e-4
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "rwkv6-3b")
# (name, the reference's policy, the port's)
POLICIES = {
    "mixed": (jax_policy.POLICY_MIXED, policy.POLICY_MIXED),
    "w12": (jax_policy.POLICY_W12, policy.POLICY_W12),
    "w16": (jax_policy.QuantConfig(enabled=True, default_bits=16),
            policy.POLICY_W16),
    "w20": (jax_policy.QuantConfig(enabled=True, default_bits=20),
            policy.QuantConfig(enabled=True, default_bits=20)),
}
NO_LAUNCH = {mode: 0 for mode in fg.MODES}


def _np(t):
    return np.asarray(array_to_numpy(t)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    """Each arch's smoke parameters: the reference's and the bridged
    port's."""
    out = {}
    for arch in ARCHS:
        jparams = jax_lm.init_params(jax.random.PRNGKey(0),
                                     jax_get_config(arch, smoke=True))
        out[arch] = (jparams, params_from_jax(jax.tree.map(np.asarray,
                                                           jparams)))
    return out


def _records(tree, path=()):
    """(dotted path, record) of every record in a prequantized tree."""
    if is_prequantized(tree):
        yield ".".join(path), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _records(v, path + (k,))


@pytest.mark.parametrize("pol", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_records_match_jax_prequantize(trees, arch, pol):
    jparams, tparams = trees[arch]
    jquant, tquant = POLICIES[pol]
    want = dict(_records(jax.tree.map(np.asarray,
                                      jax_prequantize(jparams, jquant))))
    got = dict(_records(prequantize(tparams, tquant)))
    assert sorted(got) == sorted(want) and got
    for path, rec in got.items():
        bits = tquant.bits_for(path)
        assert rec["q"].dtype == storage_dtype(bits) == (
            torch.int8 if bits <= 8 else torch.int16), path
        assert str(want[path]["q"].dtype) == str(rec["q"].dtype)[6:]
        np.testing.assert_array_equal(rec["q"].numpy(), want[path]["q"],
                                      err_msg=path)
        np.testing.assert_array_equal(rec["scale"].numpy(),
                                      want[path]["scale"], err_msg=path)
        # the scale axis is K (ndim - 2): one per (period[, expert], column)
        shape = list(rec["q"].shape)
        shape[-2] = 1
        assert list(rec["scale"].shape) == shape, path


def test_w20_records_pin_the_reference_saturation(trees):
    """Above w = 16 the reference stores int16 codes, which XLA saturates;
    a plain ``to(torch.int16)`` would wrap them instead."""
    jparams, tparams = trees["llama3.2-1b"]
    jquant, tquant = POLICIES["w20"]
    leaf = tparams["blocks"]["pos0"]["mlp"]["wi"]
    want = np.asarray(jax_prequantize(jparams, jquant)
                      ["blocks"]["pos0"]["mlp"]["wi"]["q"])
    got = prequantize(tparams, tquant)["blocks"]["pos0"]["mlp"]["wi"]["q"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 32767).any() and (want == -32768).any()
    wrapped, _ = quantize_symmetric(leaf, 20, axis=1, keepdims=True,
                                    storage_dtype=torch.int16)
    assert not torch.equal(wrapped, got)
    codes, _ = quantize_symmetric(leaf, 20, axis=1, keepdims=True)
    assert torch.equal(codes.clamp(-32768, 32767).to(torch.int16), got)


def test_other_leaves_stay_tensors(trees):
    """Norms, the router and the tied lm_head (``embed``, read as embed.T)
    are not in the reference's leaf set: the same tensors come back."""
    for arch in ARCHS:
        _, tparams = trees[arch]
        q = prequantize(tparams, policy.POLICY_MIXED)
        assert q["embed"] is tparams["embed"]
        assert q["ln_f"]["scale"] is tparams["ln_f"]["scale"]
        pos0 = q["blocks"]["pos0"]
        assert pos0["ln1"]["scale"] is tparams["blocks"]["pos0"]["ln1"][
            "scale"]
        if arch == "granite-moe-3b-a800m":
            assert torch.is_tensor(pos0["moe"]["router"])
            assert is_prequantized(pos0["moe"]["wi"])
        if arch == "llama3.2-1b":
            assert "lm_head" not in q
        if arch == "rwkv6-3b":
            assert q["lm_head"]["q"].dtype == torch.int16     # w=12
            assert torch.is_tensor(pos0["rwkv"]["w_lora_a"])


def _jax_rec(wm, bits):
    q = jax_prequantize({"wi": jnp.asarray(wm)},
                        jax_policy.QuantConfig(enabled=True,
                                               default_bits=bits))["wi"]
    return q, {k: array_to_torch(np.asarray(v)) for k, v in q.items()}


@pytest.mark.parametrize("bits", [8, 12, 16, 20])
def test_prequant_matmul_dense_matches_jax(bits):
    fg.reset_launches()
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 5, 70)).astype(np.float32)
    wm = (rng.standard_normal((70, 40)) * 0.1).astype(np.float32)
    jrec, trec = _jax_rec(wm, bits)
    ref = jax_pqmm(jnp.asarray(x), jrec, bits,
                   context=JaxContext(backend="pallas"))
    got = prequant_matmul(array_to_torch(x), trec, bits,
                          context=ExecContext())
    assert tuple(got.shape) == tuple(ref.shape) == (2, 5, 40)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert fg.launches == NO_LAUNCH


@pytest.mark.parametrize("bits", [8, 12])
def test_prequant_matmul_batched_and_ragged_match_jax(bits):
    fg.reset_launches()
    rng = np.random.default_rng(bits + 1)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    wm = (rng.standard_normal((4, 64, 40)) * 0.1).astype(np.float32)
    x[2] = 0.0                              # a zero-token expert buffer
    counts = np.array([[3, 0, 4], [4, 4, 4], [0, 0, 0], [1, 2, 0]],
                      np.int32)
    jrec, trec = _jax_rec(wm, bits)
    jctx = JaxContext(backend="pallas")
    for c in (None, counts):
        ref = jax_pqmm(jnp.asarray(x), jrec, bits, batched=True,
                       context=jctx, seg=None if c is None else 4,
                       counts=None if c is None else jnp.asarray(c))
        got = prequant_matmul(
            array_to_torch(x), trec, bits, batched=True,
            context=ExecContext(), seg=None if c is None else 4,
            counts=None if c is None else torch.from_numpy(c))
        np.testing.assert_array_equal(_np(got), np.asarray(ref),
                                      err_msg=f"ragged={c is not None}")
    assert fg.grouped_launches == NO_LAUNCH
    with pytest.raises(ValueError, match="batched"):
        prequant_matmul(array_to_torch(x[0]), trec, bits,
                        counts=torch.from_numpy(counts), seg=4)


@pytest.mark.parametrize("bits", [8, 12, 16, 20])
def test_records_reach_the_kernel_uncopied(monkeypatch, bits):
    """Through w = 16 the record's codes are the kernel's B operand as
    stored (no weight-sized cast or copy); above it they are converted to
    the int32 carrier, as the reference's ``astype(int32)``."""
    seen = []
    for name in ("fused_gemm_reference", "fused_gemm_grouped_reference"):
        fn = getattr(fg, name)

        def spy(a, b, *args, fn=fn, **kw):
            seen.append((b.data_ptr(), b.dtype))
            return fn(a, b, *args, **kw)
        monkeypatch.setattr(fg, name, spy)
    rng = np.random.default_rng(bits)
    wm = (rng.standard_normal((3, 64, 40)) * 0.1).astype(np.float32)
    rec = prequantize({"wi": array_to_torch(wm)},
                      policy.QuantConfig(enabled=True,
                                         default_bits=bits))["wi"]
    x = torch.from_numpy(rng.standard_normal((3, 8, 64)).astype(np.float32))
    dense = {k: v[1] for k, v in rec.items()}
    prequant_matmul(x[1], dense, bits)
    prequant_matmul(x, rec, bits, batched=True)
    ptrs = [dense["q"].data_ptr(), rec["q"].data_ptr()]
    got = {p for p, _ in seen}
    if bits <= 16:
        assert set(ptrs) <= got
        assert {d for _, d in seen} == {rec["q"].dtype}
    else:
        assert {d for _, d in seen} == {torch.int32}
        assert not got & set(ptrs)


def _tokens(cfg):
    rng = np.random.default_rng(1)
    return rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)


def _port_logits(cfg, params, toks):
    """Prefill, then one greedy decode step, on the port (CPU)."""
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    with torch.inference_mode():
        logits, cache, _ = lm.prefill(params, cfg, torch.from_numpy(toks),
                                      cache, chunk_size=8)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        dlogits, _ = lm.decode_step(params, cfg, nxt, cache,
                                    torch.full((2,), 16, dtype=torch.int32))
    return logits, dlogits


@pytest.mark.parametrize("arch", ARCHS)
def test_prequantized_logits_equal_per_call(trees, arch):
    _, tparams = trees[arch]
    cfg = get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32")
    toks = _tokens(cfg)
    per_call = _port_logits(cfg, tparams, toks)
    pre = _port_logits(cfg, prequantize(tparams, cfg.quant), toks)
    for a, b in zip(per_call, pre):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def _jax_prefill(arch, pol, params, toks):
    jcfg = jax_get_config(arch, smoke=True, quant=pol)
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype="float32")
    fn = jax.jit(lambda p, t, c: jax_lm.prefill(p, jcfg, t, c))
    per_call, _, _ = fn(params, jnp.asarray(toks),
                        jax_lm.init_cache(jcfg, 2, 32))
    pre, _, _ = fn(jax_prequantize(params, jcfg.quant), jnp.asarray(toks),
                   jax_lm.init_cache(jcfg, 2, 32))
    return np.asarray(per_call), np.asarray(pre)


@pytest.mark.parametrize("arch,pol", [("llama3.2-1b", "mixed"),
                                      ("rwkv6-3b", "mixed"),
                                      ("llama3.2-1b", "w12")])
def test_prequantized_prefill_matches_jax(trees, arch, pol):
    """Prequantized prefill logits: in each package equal to its own
    per-call run, and the port's within ``F32_ATOL`` of JAX's.  At w12 on
    these tokens one activation code flips between XLA's and ATen's
    float32 ops outside the GEMMs (ROADMAP.md section 3), per call as with
    records (8e-4): there the gate is that the records add no difference,
    in either package."""
    jparams, tparams = trees[arch]
    cfg = get_config(arch, smoke=True, quant=pol).scaled_down(
        compute_dtype="float32")
    toks = _tokens(cfg)
    jax_per_call, jax_pre = _jax_prefill(arch, pol, jparams, toks)
    np.testing.assert_array_equal(jax_pre, jax_per_call)
    got = {}
    for name, params in (("per_call", tparams),
                         ("pre", prequantize(tparams, cfg.quant))):
        cache = lm.init_cache(cfg, 2, 32, device="cpu")
        with torch.inference_mode():
            got[name], _, _ = lm.prefill(params, cfg, torch.from_numpy(toks),
                                         cache)
    assert torch.equal(got["pre"], got["per_call"])
    v = cfg.vocab_size
    if pol == "mixed":
        np.testing.assert_allclose(_np(got["pre"])[:, :v], jax_pre[:, :v],
                                   atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(_np(got["pre"]) - jax_pre,
                                      _np(got["per_call"]) - jax_per_call)
