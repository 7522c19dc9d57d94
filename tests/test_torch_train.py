"""The port's training path (STE cores, ``loss_fn`` and its gradients, AdamW,
the data pipeline, checkpoints, the train step, loop and launcher) against
the JAX reference on the CPU, with the reference's parameters carried over
by ``bridge.params_from_jax``.  The reference runs on its ``"xla"`` route,
whose forward is ``array_equal`` to its Pallas route (the port's ATen-route
tests hold that); the port's wrappers run the kernels' plain versions.

Tolerances, and why they are not zero.  The STE backward is the same fp32
product on both sides (``g @ W^T``, ``x^T @ g``) summed in another order by
XLA and by ATen: relative differences of a few fp32 ulps, so ``STE_RTOL`` =
1e-5 of the largest entry.  Through a whole model the forward already
differs by a few ulps outside the quantized GEMMs (RMSNorm, RoPE, softmax,
logsumexp: other kernels, other orders; see test_torch_lm.py), and the
backward adds its own reorderings: every leaf's gradient agrees to about
1e-6 of its largest entry (1.2e-6 at worst over the six cases), so
gradients in fp32 compute are held per leaf to ``GRAD_TOL`` = 1e-5 of the
leaf's largest entry and the loss to 1e-5 relative.  Under ``mixed`` a
few-ulp difference can also flip an activation's quantization code, which
moves that GEMM's output by one code step (~1e-2 of it); the STE gradient
does not see codes (it uses the unquantized x and W), but the downstream
activations do.  No code flips at these inputs (the mixed cases also agree
to 1e-6), and ``GRAD_TOL_Q`` = 1e-4 leaves room for a rounding change
in a code's neighbourhood while a flipped code, or a gradient lost at a
kernel, would still fail it.  The optimizer's leaf arithmetic is identical, bar
XLA's and ATen's ``pow``/``sqrt``/``cos`` and the global norm's sum order:
``OPT_RTOL`` = 1e-5.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant.qmatmul import quantized_matmul as jax_qmm  # noqa: E402
from repro.quant.qmatmul import (  # noqa: E402
    quantized_matmul_batched as jax_qbmm)
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.bridge import array_to_torch, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import rowinv  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.quant.policy import POLICY_MIXED  # noqa: E402
from repro_torch.quant.prequant import record  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

STE_RTOL = 1e-5
GRAD_TOL = 1e-5
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
OPT_RTOL = 1e-5
B, S = 2, 16


def _np(t):
    return np.asarray(bridge.array_to_numpy(t)).astype(np.float32)


def _close_to_max(got, ref, tol, what):
    """|got - ref| <= tol * max|ref| elementwise (and both finite)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _jax_tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


# ---------------------------------------------------------------------------
# The three STE cores against the reference's custom_vjp.
# ---------------------------------------------------------------------------


def _ste_inputs(shape_x, shape_w, shape_g, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = (rng.standard_normal(shape_w) * 0.1).astype(np.float32)
    g = rng.standard_normal(shape_g).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("bits,transpose", [(8, False), (12, True)])
def test_ste_dense_core_matches_reference(bits, transpose):
    """Dense core at w=8 (mm1) and at w=12 (kmm2) on a transposed weight
    view, as the tied lm_head passes ``embed.T``: the view's gradient
    reaches the tensor it views."""
    x, w, g = _ste_inputs((2, 5, 70), (70, 48), (2, 5, 48), seed=bits)
    wj = jnp.asarray(w)
    out_j, vjp = jax.vjp(lambda a, b: jax_qmm(
        a, b, bits, context=JaxContext(backend="xla")), jnp.asarray(x), wj)
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = array_to_torch(x).requires_grad_()
    base = array_to_torch(np.ascontiguousarray(w.T)).requires_grad_()
    wt = base.T if transpose else array_to_torch(w).requires_grad_()
    fg.reset_launches()
    out = qmatmul.quantized_matmul(xt, wt, bits, context=ExecContext())
    assert out.grad_fn is not None
    out.backward(array_to_torch(g))
    np.testing.assert_array_equal(_np(out), np.asarray(out_j))
    _close_to_max(_np(xt.grad), dx_j, STE_RTOL, "dx")
    dw = base.grad.T if transpose else wt.grad
    _close_to_max(_np(dw), dw_j, STE_RTOL, "dw")
    assert fg.launches == {mode: 0 for mode in fg.MODES}


def test_ste_bf16_core_rounds_like_reference():
    """bf16 x and W: the forward equal, dx and dw rounded to bf16 from the
    same fp32 products, so within one bf16 ulp (2^-8 relative)."""
    x, w, g = _ste_inputs((3, 64), (64, 40), (3, 40), seed=3)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    out_j, vjp = jax.vjp(lambda a, b: jax_qmm(
        a, b, 8, context=JaxContext(backend="xla")), xb, wb)
    dx_j, dw_j = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = array_to_torch(np.asarray(xb)).requires_grad_()
    wt = array_to_torch(np.asarray(wb)).requires_grad_()
    out = qmatmul.quantized_matmul(xt, wt, 8, context=ExecContext())
    out.backward(array_to_torch(np.asarray(jnp.asarray(g, jnp.bfloat16))))
    assert xt.grad.dtype == torch.bfloat16 == wt.grad.dtype
    np.testing.assert_array_equal(_np(out), np.asarray(out_j, np.float32))
    _close_to_max(_np(xt.grad), dx_j, 2.0 ** -8, "dx")
    _close_to_max(_np(wt.grad), dw_j, 2.0 ** -8, "dw")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("bits", [8, 12])
def test_ste_batched_cores_match_reference(bits, ragged):
    """Batched and ragged batched cores, (E, C, K) x (E, K, N): the ragged
    core's dead rows are exact zeros forward and get exactly zero dx, and
    no gradient reaches ``counts``."""
    e, seg, n_seg, k, n = 3, 4, 2, 24, 16
    x, w, g = _ste_inputs((e, seg * n_seg, k), (e, k, n),
                          (e, seg * n_seg, n), seed=10 * bits + ragged)
    counts = np.array([[4, 1], [0, 3], [2, 0]], np.int32)
    kw = dict(counts=jnp.asarray(counts), seg=seg) if ragged else {}
    out_j, vjp = jax.vjp(lambda a, b: jax_qbmm(
        a, b, bits, context=JaxContext(backend="xla"), **kw),
        jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = array_to_torch(x).requires_grad_()
    wt = array_to_torch(w).requires_grad_()
    tkw = dict(counts=torch.from_numpy(counts), seg=seg) if ragged else {}
    out = qmatmul.quantized_matmul_batched(xt, wt, bits,
                                           context=ExecContext(), **tkw)
    out.backward(array_to_torch(g))
    np.testing.assert_array_equal(_np(out), np.asarray(out_j))
    _close_to_max(_np(xt.grad), dx_j, STE_RTOL, "dx")
    _close_to_max(_np(wt.grad), dw_j, STE_RTOL, "dw")
    if ragged:
        live = (np.arange(seg * n_seg)[None, :] % seg
                < np.repeat(counts, seg, axis=1))
        assert not live.all()
        assert (xt.grad.numpy()[~live] == 0).all()
        assert (np.asarray(dx_j)[~live] == 0).all()


def test_prequant_matmul_refuses_gradients():
    w = torch.randn(32, 16)
    rec = record(w, 8)
    x = torch.randn(3, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        qmatmul.prequant_matmul(x, rec, 8)
    with torch.no_grad():
        assert qmatmul.prequant_matmul(x, rec, 8).shape == (3, 16)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_rowinv_norm_backward_is_the_norms_vjp(kind):
    """The norm Function's backward equals autograd of its plain version
    (fp32 and bf16 rows), and the forward is unchanged."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 5, 64, generator=gen).to(dtype)
        scale = 1 + 0.1 * torch.randn(64, generator=gen)
        bias = 0.1 * torch.randn(64, generator=gen) if kind == "ln" else None
        g = torch.randn(3, 5, 64, generator=gen).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (x, scale)] + (
            [bias.clone().requires_grad_()] if bias is not None else [])
        out = rowinv.rowinv_norm(*leaves[:2], *leaves[2:], kind=kind)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, g)
        ref_leaves = [t.clone().requires_grad_() for t in leaves]
        ref = rowinv.rowinv_norm_reference(
            ref_leaves[0], ref_leaves[1],
            ref_leaves[2] if bias is not None else None, kind, 1e-6)
        want = torch.autograd.grad(ref, ref_leaves, g)
        assert torch.equal(out, ref)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            _close_to_max(a.float().numpy(), b.float().numpy(), tol, kind)


# ---------------------------------------------------------------------------
# loss_fn and its gradients against jax.value_and_grad(lm.loss_fn).
# ---------------------------------------------------------------------------


def _configs(arch, quant, **kw):
    jcfg = jax_get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", **kw)
    tcfg = get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", **kw)
    return jcfg, tcfg


def _data_cfg(cfg, seed=0, batch=B, seq=S):
    return data.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, frontend=cfg.frontend,
                           frontend_dim=cfg.frontend_dim,
                           frontend_tokens=cfg.frontend_tokens,
                           encdec=cfg.is_encdec, seed=seed)


LOSS_CASES = [("llama3.2-1b", "none"), ("llama3.2-1b", "mixed"),
              ("granite-moe-3b-a800m", "none"),
              ("granite-moe-3b-a800m", "mixed"),
              ("llava-next-mistral-7b", "none"),
              ("seamless-m4t-medium", "none")]


@pytest.fixture(scope="module")
def loss_refs():
    """Each case's reference loss and gradients, computed once."""
    out = {}
    for arch, quant in LOSS_CASES:
        jcfg, tcfg = _configs(arch, quant)
        jparams = jax_lm.init_params(jax.random.PRNGKey(3), jcfg)
        batch = data.DataIterator(_data_cfg(tcfg, seed=7)).peek(0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm.loss_fn(p, jcfg, jbatch)))(jparams)
        out[(arch, quant)] = (tcfg, jax.tree.map(np.asarray, jparams), batch,
                              float(loss), _jax_tree_np(grads))
    return out


@pytest.mark.parametrize("arch,quant", LOSS_CASES)
def test_loss_and_grads_match_reference(loss_refs, arch, quant):
    tcfg, jparams, batch, ref_loss, ref_grads = loss_refs[(arch, quant)]
    params = params_from_jax(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fg.reset_launches()
    # lm.loss_fn itself, as the reference differentiates it: no bf16 copy
    loss, grads = steps.loss_and_grads(
        dataclasses.replace(tcfg, bf16_cast_params=False), params, tbatch)
    assert fg.launches == {mode: 0 for mode in fg.MODES}
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL)
    tol = GRAD_TOL if quant == "none" else GRAD_TOL_Q
    ref_flat = dict(_flat(ref_grads))
    got_flat = dict(_flat(grads))
    assert sorted(got_flat) == sorted(ref_flat)
    for name, g in got_flat.items():
        assert g.dtype == torch.float32
        assert float(g.abs().max()) > 0, name
        _close_to_max(g.numpy(), ref_flat[name], tol, name)


def test_forward_train_matches_reference(loss_refs):
    """``forward_train``'s logits and the MoE aux loss (granite, mixed)."""
    tcfg, jparams, batch, _, _ = loss_refs[("granite-moe-3b-a800m", "mixed")]
    jcfg = jax_get_config("granite-moe-3b-a800m", smoke=True,
                          quant="mixed").scaled_down(compute_dtype="float32")
    jp = jax.tree.map(jnp.asarray, jparams)
    logits_j, aux_j = jax_lm.forward_train(jp, jcfg,
                                           jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        logits, aux = lm.forward_train(params_from_jax(jparams), tcfg,
                                       torch.from_numpy(batch["tokens"]))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    _close_to_max(logits.numpy(), np.asarray(logits_j), 1e-4, "logits")


def test_remat_and_chunking_leave_values_unchanged():
    """``remat`` on and off, and a loss over several head chunks, give the
    same loss and gradients bit for bit; with remat each period's GEMMs
    run twice, and each head chunk's always does (its recompute is the
    reference's unconditional ``jax.checkpoint``): the chip's launch
    gate."""
    _, tcfg = _configs("llama3.2-1b", "mixed")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(gen, tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.DataIterator(
        _data_cfg(tcfg, seq=32)).peek(0).items()}
    calls = []
    plain = fg.fused_gemm_reference

    def counted(*a, **kw):
        calls.append(kw["mode"])
        return plain(*a, **kw)

    runs = {}
    old_chunk = lm.LOSS_CHUNK
    try:
        fg.fused_gemm_reference = counted
        lm.LOSS_CHUNK = 8                      # 4 head chunks of 8
        for remat in (True, False):
            cfg = dataclasses.replace(tcfg, remat=remat)
            calls.clear()
            runs[remat] = steps.loss_and_grads(cfg, params, batch)
            runs[remat] += (list(calls),)
    finally:
        fg.fused_gemm_reference = plain
        lm.LOSS_CHUNK = old_chunk
    (l1, g1, c1), (l0, g0, c0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for a, b in zip(optim.tree_leaves(g1), optim.tree_leaves(g0)):
        assert torch.equal(a, b)
    per_forward = 7 * tcfg.n_layers           # q k v o wi wg wo, mm1 (w=8)
    assert c0.count("mm1") == per_forward and c0.count("kmm2") == 2 * 4
    assert c1.count("mm1") == 2 * per_forward and c1.count("kmm2") == 2 * 4


# ---------------------------------------------------------------------------
# AdamW, the train step, data and checkpoints.
# ---------------------------------------------------------------------------


def _opt_trees(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "blk": {"scale": rng.standard_normal(5).astype(np.float32),
                      "wo": rng.standard_normal((2, 5, 3)).astype(
                          np.float32)}}
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                    * grad_scale).astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # clip off / on
def test_optim_update_matches_reference(grad_scale):
    """Two AdamW steps from one state: the reference's first step's state
    carried over by the bridge, then both optimizers' second step."""
    ocfg = dict(lr=1e-2, warmup_steps=3, total_steps=10)
    jo, to = jax_optim.AdamWConfig(**ocfg), optim.AdamWConfig(**ocfg)
    params, grads = _opt_trees(0, grad_scale)
    jp = jax.tree.map(jnp.asarray, params)
    jp, jstate, _ = jax_optim.update(jo, jax.tree.map(jnp.asarray, grads),
                                     jax_optim.init(jp), jp)
    params2, grads2 = _opt_trees(1, grad_scale)
    state = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    new_p, new_s, metrics = optim.update(to, params_from_jax(grads2), state,
                                         tp)
    ref_p, ref_s, ref_m = jax_optim.update(
        jo, jax.tree.map(jnp.asarray, grads2), jstate, jp)
    for got, ref in ((new_p, ref_p), (new_s.mu, ref_s.mu),
                     (new_s.nu, ref_s.nu)):
        for (name, a), (_, b) in zip(_flat(got), _flat(_jax_tree_np(ref))):
            np.testing.assert_allclose(a.numpy(), b, rtol=OPT_RTOL,
                                       atol=1e-7, err_msg=name)
    back = bridge.opt_state_to_numpy(new_s)
    assert int(back[0]) == int(ref_s.step) == 2
    rebuilt = jax_optim.OptState(*back)
    assert jax.tree.structure(rebuilt.mu) == jax.tree.structure(ref_s.mu)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=OPT_RTOL)
    for s in (0, 1, 2, 3, 7, 10, 12):
        np.testing.assert_allclose(
            float(optim.lr_at(to, torch.tensor(s, dtype=torch.int32))),
            float(jax_optim.lr_at(jo, jnp.asarray(s, jnp.int32))),
            rtol=1e-6)


def test_cast_params_leaf_rule():
    """The bf16 compute copy casts fp32 leaves with ndim >= 2 and more
    than 65536 elements, except ``a_log``, ``u`` and ``mix``."""
    big = torch.zeros(300, 300)
    tree = {"a": big, "a_log": big, "u": big, "mix": big,
            "small": torch.zeros(200, 200), "vec": torch.zeros(70000),
            "bf": big.to(torch.bfloat16), "blk": {"wq": big}}
    cfg = get_config("llama3.2-1b", smoke=True)
    out = steps.cast_params(cfg, tree)
    cast = {k for k, v in _flat(out) if v.dtype == torch.bfloat16}
    assert cast == {"a", "bf", "blk.wq"}
    off = dataclasses.replace(cfg, bf16_cast_params=False)
    assert steps.cast_params(off, tree) is tree


def test_train_step_matches_reference():
    """One microbatched train step (2 microbatches, mixed, fp32 compute)
    against the reference's ``make_train_step``: loss, grad norm and the
    new params."""
    jcfg, tcfg = _configs("llama3.2-1b", "mixed", n_microbatches=2)
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jparams = jax_lm.init_params(jax.random.PRNGKey(5), jcfg)
    batch = data.DataIterator(_data_cfg(tcfg, seed=3, batch=4)).peek(2)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax_optim.AdamWConfig(**ocfg)))
    jnew, _, jm = jstep(jparams, jax_optim.init(jparams),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tstep = steps.make_train_step(tcfg, optim.AdamWConfig(**ocfg))
    new, state, m = tstep(params, optim.init(params),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(state.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL_Q)
    ref_flat = dict(_flat(_jax_tree_np(jnew)))
    for name, p in _flat(new):
        # Adam's first step moves each entry by lr * g / (|g| + eps): on
        # entries whose |g| is a few orders above eps = 1e-8, the absolute
        # gradient differences (1e-6 of the leaf's largest entry) are
        # large relative ones, and they reach the update there; the bound
        # is a hundredth of lr (5e-3 of it seen), far below an update.
        err = float(np.abs(p.numpy() - ref_flat[name]).max())
        assert err <= 1e-2 * ocfg["lr"], (name, err)


@pytest.mark.parametrize("frontend", ["none", "vision", "audio"])
def test_data_iterator_matches_reference(frontend):
    kw = dict(vocab_size=500, seq_len=40, global_batch=3, seed=11)
    if frontend == "vision":
        kw.update(frontend="vision", frontend_dim=8, frontend_tokens=4)
    if frontend == "audio":
        kw.update(frontend="audio", frontend_dim=6, encdec=True)
    mine = data.DataIterator(data.DataConfig(**kw), start_step=2)
    ref = jax_data.DataIterator(jax_data.DataConfig(**kw), start_step=2)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(mine.peek(9)["tokens"],
                                  ref.peek(9)["tokens"])


def test_checkpoint_layout_and_round_trip(tmp_path):
    """The reference's layout (``step_N/arrays.npz`` + ``manifest.json``,
    keys joined by ``||``): the port reads a checkpoint the reference
    wrote, writes the same keys, restores bit for bit, and prunes."""
    _, tcfg = _configs("llama3.2-1b", "none")
    params = lm.init_params(torch.Generator().manual_seed(1), tcfg,
                            device="cpu")
    state = optim.init(params)
    state = state._replace(step=torch.tensor(5, dtype=torch.int32),
                           mu=optim.tree_map(torch.randn_like, state.mu))
    jtree = (jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params)),
             jax_optim.OptState(*bridge.opt_state_to_numpy(state)))
    jax_ckpt.save(str(tmp_path / "ref"), 5, jtree)
    step, (p2, s2), _ = ckpt.load(str(tmp_path / "ref"), (params, state))
    assert step == 5 and isinstance(s2, optim.OptState)
    for a, b in zip(optim.tree_leaves(params) + optim.tree_leaves(state.mu),
                    optim.tree_leaves(p2) + optim.tree_leaves(s2.mu)):
        assert torch.equal(a, b)
    assert torch.equal(s2.step, state.step)
    saver = ckpt.AsyncCheckpointer(str(tmp_path / "mine"), keep=2)
    for n in (1, 2, 3):
        saver.save(n, (params, state), meta={"arch": tcfg.name})
    saver.wait()
    assert sorted(os.listdir(tmp_path / "mine")) == ["step_00000002",
                                                     "step_00000003"]
    assert ckpt.latest_step(str(tmp_path / "mine")) == 3
    with np.load(tmp_path / "mine" / "step_00000003" / "arrays.npz") as z:
        mine_keys = set(z.files)
    with np.load(tmp_path / "ref" / "step_00000005" / "arrays.npz") as z:
        assert mine_keys == set(z.files)
    assert "1||mu||embed" in mine_keys and "0||ln_f||scale" in mine_keys


def _tiny_train_config():
    cfg = get_config("llama3.2-1b", smoke=True, quant="mixed")
    return cfg, _data_cfg(cfg, seed=0, batch=4, seq=16)


def test_restart_is_bit_exact(tmp_path):
    """2 steps, a checkpoint, a fresh run resuming for 2 more: params and
    optimizer state equal to 4 straight steps; the loss falls."""
    cfg, dcfg = _tiny_train_config()
    ocfg = optim.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    straight = run_training(cfg, TrainConfig(steps=4, log_every=1,
                                             optimizer=ocfg), dcfg,
                            device="cpu")
    d = str(tmp_path / "ck")
    run_training(cfg, TrainConfig(steps=2, ckpt_dir=d, optimizer=ocfg), dcfg,
                 device="cpu")
    resumed = run_training(cfg, TrainConfig(steps=4, ckpt_dir=d,
                                            log_every=1, optimizer=ocfg),
                           dcfg, device="cpu")
    assert resumed.restored_from == 2 and sorted(resumed.losses) == [2, 3]
    assert resumed.losses[3] == straight.losses[3]
    assert straight.losses[3] < straight.losses[0]
    for a, b in zip(optim.tree_leaves({"p": straight.params,
                                       "mu": straight.opt_state.mu,
                                       "nu": straight.opt_state.nu}),
                    optim.tree_leaves({"p": resumed.params,
                                       "mu": resumed.opt_state.mu,
                                       "nu": resumed.opt_state.nu})):
        assert torch.equal(a, b)
    assert torch.equal(straight.opt_state.step, resumed.opt_state.step)


def test_fault_injection_then_resume_and_non_finite(tmp_path):
    cfg, dcfg = _tiny_train_config()
    d = str(tmp_path / "ck")
    tc = TrainConfig(steps=3, ckpt_dir=d, ckpt_every=1)

    def fault(step):
        if step == 1:
            raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        run_training(cfg, tc, dcfg, {"inject_fault": fault}, device="cpu")
    assert ckpt.latest_step(d) == 1
    res = run_training(cfg, tc, dcfg, device="cpu")
    assert res.restored_from == 1 and res.final_step == 3
    bad = dataclasses.replace(tc, ckpt_dir=None, optimizer=optim.AdamWConfig(
        lr=float("nan")))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        run_training(cfg, bad, dcfg, device="cpu")


def test_launcher_smoke_cpu(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--quant", "mixed", "--steps", "2",
            "--seq-len", "16", "--global-batch", "2", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "1"]
    assert train_launcher.main(args) == 0
    assert "done: step=2" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
    # a mesh of 8 outside torchrun: refused at once, waiting for no rank
    with pytest.raises(RuntimeError, match="needs the process group"):
        train_launcher.main(["--smoke", "--device", "cpu", "--mesh", "2x4"])


def test_mixed_policy_and_gradients_reach_every_leaf():
    """Under mixed every leaf of a smoke MoE model gets a nonzero, finite
    gradient (ln scales, the router, embed through the tied head), and
    the router's GEMM is the w=12 kmm2 site."""
    assert POLICY_MIXED.bits_for("blk0.moe.router") == 12
    _, tcfg = _configs("granite-moe-3b-a800m", "mixed")
    params = lm.init_params(torch.Generator().manual_seed(2), tcfg,
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.DataIterator(
        _data_cfg(tcfg)).peek(0).items()}
    _, grads = steps.loss_and_grads(tcfg, params, batch)
    for name, g in _flat(grads):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0, name
