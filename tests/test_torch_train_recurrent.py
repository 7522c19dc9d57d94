"""Recurrent training in the port (rwkv6-3b's RWKV block, jamba's mamba
block) against the JAX reference on the CPU, the reference's parameters
carried over by ``bridge.params_from_jax``; the port's wrappers run the
kernels' plain versions (``chip_smoke.py`` holds the CUDA kernels to them on
the card):

  * kernel level: ``wkv_vjp_reference`` against autograd through
    ``wkv_stateful_reference`` and against ``jax.vjp`` of the reference's
    ``wkv_reference``; ``ssm_scan_vjp_reference`` against autograd through
    ``ssm_scan_reference`` (z fp32 and bf16); ``rowinv_matmul``'s Function
    against autograd of ``x @ w``; each Function's output carries its
    ``grad_fn`` and the train entries refuse what training never passes;
  * block level: ``rwkv_apply`` and ``mamba_apply``, output and every
    parameter's and the input's gradient against ``jax.vjp`` of the
    reference's, SMOKE widths, quant none and mixed;
  * model level: ``lm.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` for SMOKE rwkv6-3b (none, mixed) and
    jamba-v0.1-52b (mixed) in fp32 compute, every leaf nonzero; jamba's
    reference runs on the port's codes (below);
  * remat on and off equal, the WKV forward counted twice under remat and
    its backward once; the launcher's CPU smoke for rwkv6-3b.

Tolerances.  The plain VJPs and autograd compute the same fp32 products in
other orders: within ``VJP_TOL`` = 1e-5 of each gradient's largest entry
(measured ~4e-7).  Blocks and models use test_torch_train.py's gates: fp32
gradients within ``GRAD_TOL`` = 1e-5 of each leaf's largest entry, under
mixed ``GRAD_TOL_Q`` = 1e-4 (room for a rounding change near an
activation's code boundary), the loss within ``LOSS_RTOL`` = 1e-5.  The
reference sums mamba's state by an associative scan and the port by a
sequential one, and its RWKV scan runs under ``jax.checkpoint``: the
worst leaves measured are 2.0e-6 (rwkv, none; ``w_lora_b``), 1.2e-6
(rwkv, mixed; ``wv``) and 1.3e-6 (jamba, mixed; ``a_log``) of their
largest entries, inside the unchanged gates.  Under mixed, jamba's codes
flip unforced: the jitted reference's weight scale ``amax / 127`` can
land an ulp from the op-by-op one (one of an expert's weight codes here),
and the activations downstream then sit a code step apart (loss 7e-5,
``dt_bias`` 7 %).  So the reference runs on the port's activation and
weight codes and scales, each quantized operand matched to the port's by
value, and every operand must lie within a hundredth of a code step of
the port's: a code that differs is a rounding boundary, not a wrong
gradient.  The port's codes and scales are themselves held to the
reference's quantizer, run eagerly on each operand the port quantized:
scales within an ulp, a differing code only within 1e-3 of a step from
its rounding boundary (measured: 1,685,248 codes, none differ, every scale
bit-equal), so a fault in the port's quantizer cannot ride into the
forced run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import wkv_gemm as jax_wkv_gemm  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.quant import qmatmul as jax_qmatmul  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.kernels import rowinv, ssm_scan, wkv_gemm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.quant import qmatmul as torch_qmatmul  # noqa: E402
from repro_torch.train import optim  # noqa: E402

VJP_TOL = 1e-5
GRAD_TOL = 1e-5
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
B, SEQ = 2, 16
jax_quantize = jax_qmatmul._quantize


def _close_to_max(got, ref, tol, what):
    """|got - ref| <= tol * max|ref| elementwise (and both finite)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _np(t):
    return np.asarray(bridge.array_to_numpy(t.detach())).astype(np.float32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


# ---------------------------------------------------------------------------
# Kernel level: the plain VJPs and the Functions.
# ---------------------------------------------------------------------------


def _wkv_inputs(rng, b, s, h, d):
    shape = (b, s, h, d)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, shape).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.1
    dy = rng.standard_normal(shape).astype(np.float32)
    return r, k, v, w, u, dy


@pytest.mark.parametrize("d", [4, 16])
def test_wkv_vjp_reference_matches_autograd_and_jax(d):
    """Against autograd through the model's per-step plain version, and
    against ``jax.vjp`` of the reference's oracle (B = 1, its BH rows the
    port's heads, so the bonus is per row as the oracle's)."""
    rng = np.random.default_rng(d)
    r, k, v, w, u, dy = _wkv_inputs(rng, 1, 13, 3, d)
    got = wkv_gemm.wkv_vjp_reference(*map(torch.from_numpy,
                                          (r, k, v, w, u, dy)))
    leaves = _leaves(r, k, v, w, u)
    y, _ = wkv_gemm.wkv_stateful_reference(*leaves,
                                           torch.zeros((1, 3, d, d)))
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    names = ("dr", "dk", "dv", "dw", "du")
    for name, a, b in zip(names, got, want):
        _close_to_max(a.numpy(), b.numpy(), VJP_TOL, f"{name} vs autograd")

    def rows(t):                                 # (1, S, H, D) -> (H, S, D)
        return jnp.asarray(np.ascontiguousarray(t[0].transpose(1, 0, 2)))

    _, vjp = jax.vjp(jax_wkv_gemm.wkv_reference, rows(r), rows(k), rows(v),
                     rows(w), jnp.asarray(u))
    ref = vjp(rows(dy))
    for name, a, b in zip(names, got, ref):
        b = np.asarray(b)
        if name != "du":
            b = b.transpose(1, 0, 2)[None]
        _close_to_max(a.numpy(), b, VJP_TOL, f"{name} vs jax.vjp")


@pytest.mark.parametrize("zdt", ["float32", "bfloat16"])
def test_ssm_scan_vjp_reference_matches_autograd(zdt):
    rng = np.random.default_rng(3)
    b, s, di, ds = 2, 11, 24, 8
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 1.0)).astype(
        np.float32)
    bm, cm = (rng.standard_normal((b, s, ds)).astype(np.float32)
              for _ in range(2))
    z = torch.from_numpy(rng.standard_normal((b, s, di)).astype(
        np.float32)).to(getattr(torch, zdt))
    a = -np.exp(rng.standard_normal((di, ds)) * 0.3).astype(np.float32)
    d_skip = rng.standard_normal(di).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((b, s, di)).astype(np.float32))
    plain = [torch.from_numpy(t) for t in (x, delta, bm, cm)]
    got = ssm_scan.ssm_scan_vjp_reference(
        *plain, z, torch.from_numpy(a), torch.from_numpy(d_skip), dy)
    leaves = _leaves(x, delta, bm, cm)
    leaves.insert(4, z.clone().requires_grad_())
    leaves += _leaves(a, d_skip)
    y, _ = ssm_scan.ssm_scan_reference(*leaves, torch.zeros((b, di, ds)))
    want = torch.autograd.grad(y, leaves, dy)
    for name, g, w_ in zip(("dx", "ddelta", "db", "dc", "dz", "da",
                            "dd_skip"), got, want):
        assert g.dtype == w_.dtype, name
        tol = VJP_TOL if g.dtype == torch.float32 else 2.0 ** -8
        _close_to_max(g.float().numpy(), w_.float().numpy(), tol, name)


def test_rowinv_matmul_function_matches_autograd():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 70), generator=gen).requires_grad_()
    w = torch.randn((70, 64), generator=gen).requires_grad_()
    g = torch.randn((2, 5, 64), generator=gen)
    out = rowinv.rowinv_matmul(x, w)
    assert type(out.grad_fn).__name__ == "_MatmulFunctionBackward"
    got = torch.autograd.grad(out, (x, w), g)
    x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
    ref = x2 @ w2
    want = torch.autograd.grad(ref, (x2, w2), g)
    assert torch.equal(out, ref)
    for a, b in zip(got, want):
        _close_to_max(a.numpy(), b.numpy(), VJP_TOL, "rowinv_matmul")


def test_train_entries_go_through_their_functions():
    """A grad-recording call of each train entry runs its Function (its
    output's ``grad_fn``), and its gradients are the plain VJP's exactly;
    without autograd the same values come back with no graph; the scan's
    train entry refuses a pad mask."""
    rng = np.random.default_rng(5)
    r, k, v, w, u, dy = _wkv_inputs(rng, 2, 7, 2, 8)
    leaves = _leaves(r, k, v, w, u)
    y = wkv_gemm.wkv_train(*leaves)
    assert type(y.grad_fn).__name__ == "_WKVFunctionBackward"
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = wkv_gemm.wkv_vjp_reference(*map(torch.from_numpy,
                                           (r, k, v, w, u, dy)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        assert torch.equal(wkv_gemm.wkv_train(*leaves), y)

    b, s, di, ds = 2, 5, 16, 4
    ops = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
           for shape in ((b, s, di), (b, s, di), (b, s, ds), (b, s, ds),
                         (b, s, di))]
    ops[1] = ops[1].abs()
    ops += [-torch.rand((di, ds)) - 0.5, torch.ones(di)]
    ops = [t.requires_grad_() for t in ops]
    y = ssm_scan.ssm_scan_train(*ops)
    assert type(y.grad_fn).__name__ == "_ScanFunctionBackward"
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, ops, g)
    want = ssm_scan.ssm_scan_vjp_reference(*[t.detach() for t in ops], g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="pad mask"):
        ssm_scan.ssm_scan_train(*ops, mask=torch.ones((b, s), dtype=bool))


# ---------------------------------------------------------------------------
# Block level: rwkv_apply and mamba_apply against jax.vjp.
# ---------------------------------------------------------------------------


def _configs(arch, quant):
    jcfg = jax_get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32")
    tcfg = get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32")
    return jcfg, tcfg


BLOCKS = [("rwkv6-3b", "rwkv", "none"), ("rwkv6-3b", "rwkv", "mixed"),
          ("jamba-v0.1-52b", "mamba", "none"),
          ("jamba-v0.1-52b", "mamba", "mixed")]
APPLY = {"rwkv": (jax_rwkv.rwkv_apply, R.rwkv_apply),
         "mamba": (jax_ssm.mamba_apply, S.mamba_apply)}


@pytest.mark.parametrize("arch,kind,quant", BLOCKS)
def test_block_apply_and_grads_match_reference(arch, kind, quant):
    """The block at period 0, position 0 on the reference's parameters:
    its output and the gradient of every parameter and of the input for
    one cotangent."""
    jcfg, tcfg = _configs(arch, quant)
    jparams = jax_lm.init_params(jax.random.PRNGKey(1), jcfg)
    pj = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"][kind])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, SEQ, tcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((B, SEQ, tcfg.d_model)).astype(np.float32)
    name = f"blk0.{kind}"
    japply, tapply = APPLY[kind]
    out_j, vjp = jax.vjp(lambda p, xx: japply(p, xx, jcfg, jcfg.quant, name),
                         pj, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))

    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    leaves = {k: t.requires_grad_() for k, t in pt.items()
              if not isinstance(t, dict)}
    for k, sub in pt.items():
        if isinstance(sub, dict):
            leaves.update({f"{k}.{kk}": t.requires_grad_()
                           for kk, t in sub.items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = tapply(pt, xt, tcfg, tcfg.quant, name)
    tol = GRAD_TOL if quant == "none" else GRAD_TOL_Q
    _close_to_max(_np(out), np.asarray(out_j), tol, "out")
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()),
                                torch.from_numpy(g))
    _close_to_max(_np(grads[0]), np.asarray(dx_j), tol, "dx")
    ref = {n: np.asarray(a) for n, a in _flat(dp_j)}
    assert sorted(ref) == sorted(leaves)
    for (n, _), gr in zip(leaves.items(), grads[1:]):
        assert float(gr.abs().max()) > 0, n
        _close_to_max(_np(gr), ref[n], tol, n)


# ---------------------------------------------------------------------------
# Model level: loss_fn and every gradient leaf against jax.value_and_grad.
# ---------------------------------------------------------------------------


def _data_cfg(cfg, seq=SEQ):
    return data.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=B, seed=7)


# (arch, quant, the reference run on the port's codes)
LOSS_CASES = [("rwkv6-3b", "none", False), ("rwkv6-3b", "mixed", False),
              ("jamba-v0.1-52b", "mixed", True)]


def _port_loss(tcfg, jparams, batch):
    """lm.loss_fn itself and its gradients, as the reference differentiates
    it: no bf16 copy."""
    return steps.loss_and_grads(
        dataclasses.replace(tcfg, bf16_cast_params=False),
        params_from_jax(jparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})


def _on_port_codes(records, far):
    """A stand-in for the reference's quantizer that returns the port's
    codes and scales: each call's operand is matched, by value, to the
    nearest operand the port quantized at the same width, axis and shape
    (the two programs quantize in other orders, and the reference's jitted
    ``amax / 127`` can round a weight scale an ulp apart); the distance,
    in code steps, goes to ``far``."""
    def lookup(x, bits, axis):
        x = np.asarray(x)
        cands = [r for r in records if r[:3] == (bits, axis, x.shape)]
        _, _, _, xp, q, sc = min(cands, key=lambda r: np.abs(r[3] - x).max())
        far.append(float((np.abs(xp - x) / np.maximum(sc, 1e-30)).max()))
        return q.astype(np.int32), sc.astype(np.float32)

    def quantize(x, w, axis):
        q0, sc0 = jax_quantize(x, w, axis)
        out = (jax.ShapeDtypeStruct(q0.shape, jnp.int32),
               jax.ShapeDtypeStruct(sc0.shape, sc0.dtype))
        q, sc = jax.pure_callback(
            lambda xx: lookup(xx, w, axis % x.ndim), out, x)
        return q.astype(q0.dtype), sc

    return quantize


def _quantizer_agrees(records):
    """The reference's quantizer run eagerly on every operand the port
    quantized: (codes compared, codes that differ, the largest scale gap in
    ulps, the largest distance of a differing code's operand from its
    rounding boundary in code steps)."""
    n = n_diff = 0
    ulps = boundary = 0.0
    for bits, axis, _, xp, q, sc in records:
        qj, scj = (np.asarray(a) for a in jax_quantize(jnp.asarray(xp), bits,
                                                        axis))
        ulps = max(ulps, float((np.abs(scj - sc) / np.spacing(sc)).max()))
        diff = qj != q
        n, n_diff = n + q.size, n_diff + int(diff.sum())
        if diff.any():
            frac = np.abs(xp / sc)[diff] % 1.0
            boundary = max(boundary, float(np.abs(frac - 0.5).max()))
    return n, n_diff, ulps, boundary


@pytest.fixture(scope="module")
def loss_refs():
    """Each case's reference loss and gradients, computed once; where the
    reference runs on the port's codes, the port's run too."""
    out = {}
    for arch, quant, forced in LOSS_CASES:
        jcfg, tcfg = _configs(arch, quant)
        jparams = jax_lm.init_params(jax.random.PRNGKey(3), jcfg)
        np_params = jax.tree.map(np.asarray, jparams)
        batch = data.DataIterator(_data_cfg(tcfg)).peek(0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        port, far, agree = None, [], None
        if forced:
            records, plain = [], torch_qmatmul._quantize

            def record(x, w, axis, carrier):
                q, sc = plain(x, w, axis, carrier)
                records.append((w, axis % x.dim(), tuple(x.shape),
                                _np(x), q.numpy(), sc.numpy()))
                return q, sc

            torch_qmatmul._quantize = record
            try:
                port = _port_loss(tcfg, np_params, batch)
            finally:
                torch_qmatmul._quantize = plain
            agree = _quantizer_agrees(records)
            jax_qmatmul._quantize = _on_port_codes(records, far)
        try:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jax_lm.loss_fn(p, jcfg, jbatch)))(jparams)
        finally:
            jax_qmatmul._quantize = jax_quantize
        out[(arch, quant)] = (tcfg, np_params, batch, float(loss),
                              {n: np.asarray(a, np.float32)
                               for n, a in _flat(grads)}, port, far,
                              agree)
    return out


@pytest.mark.parametrize("arch,quant,forced", LOSS_CASES)
def test_recurrent_loss_and_grads_match_reference(loss_refs, arch, quant,
                                                  forced):
    """Where ``forced``, the reference ran on the port's activation and
    weight codes, and every operand it quantized was within a hundredth
    of a code step of the port's: a code that differs unforced sits on a
    rounding boundary; and the reference's quantizer on the port's own
    operands gives the port's scales (an ulp apart at most) and codes (a
    rounding boundary apart at most)."""
    tcfg, jparams, batch, ref_loss, ref_grads, port, far, agree = loss_refs[
        (arch, quant)]
    loss, grads = port or _port_loss(tcfg, jparams, batch)
    if forced:
        assert far and max(far) < 0.01, max(far)
        n, n_diff, ulps, boundary = agree
        assert n > 0 and ulps <= 1.0, agree
        assert n_diff == 0 or boundary < 1e-3, agree
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL)
    tol = GRAD_TOL if quant == "none" else GRAD_TOL_Q
    got = dict(_flat(grads))
    assert sorted(got) == sorted(ref_grads)
    for name, g in got.items():
        assert g.dtype == torch.float32
        assert float(g.abs().max()) > 0, name
        _close_to_max(g.numpy(), ref_grads[name], tol, name)


def test_rwkv_remat_equal_and_counts():
    """remat on and off give equal loss and gradients for SMOKE rwkv6-3b;
    under remat each layer's WKV forward runs twice (the recompute) and its
    backward once, without it once each: the chip's launch gate."""
    _, tcfg = _configs("rwkv6-3b", "mixed")
    params = lm.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.DataIterator(
        _data_cfg(tcfg)).peek(0).items()}
    calls = []
    fwd, bwd = wkv_gemm.wkv_stateful_reference, wkv_gemm.wkv_vjp_reference

    def counted(kind, fn):
        def call(*a, **kw):
            calls.append(kind)
            return fn(*a, **kw)
        return call

    runs = {}
    try:
        wkv_gemm.wkv_stateful_reference = counted("fwd", fwd)
        wkv_gemm.wkv_vjp_reference = counted("bwd", bwd)
        for remat in (True, False):
            calls.clear()
            cfg = dataclasses.replace(tcfg, remat=remat)
            runs[remat] = steps.loss_and_grads(cfg, params, batch) + (
                list(calls),)
    finally:
        wkv_gemm.wkv_stateful_reference = fwd
        wkv_gemm.wkv_vjp_reference = bwd
    (l1, g1, c1), (l0, g0, c0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    for a, b in zip(optim.tree_leaves(g1), optim.tree_leaves(g0)):
        assert torch.equal(a, b)
    layers = tcfg.n_layers
    assert c0.count("fwd") == layers and c0.count("bwd") == layers
    assert c1.count("fwd") == 2 * layers and c1.count("bwd") == layers


def test_launcher_smoke_cpu_rwkv(tmp_path, capsys):
    args = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--quant",
            "mixed", "--steps", "2", "--seq-len", "16", "--global-batch",
            "2", "--ckpt-dir", str(tmp_path / "ck")]
    assert train_launcher.main(args) == 0
    assert "done: step=2" in capsys.readouterr().out
