"""The ATen route (backend ``"aten"``, the reference's ``"xla"``) against
the JAX reference on the same numpy inputs:

  * ``quantized_matmul``, ``quantized_matmul_batched`` (dense and ragged)
    and ``prequant_matmul`` on ``"aten"`` ``array_equal`` to JAX's
    ``"xla"`` at w 8, 12, 16, 20, 27 and 28, fp32 and bf16 inputs, and
    with ``force_mode="mm2"``; on ``"cuda"`` the GEMMs the fused kernel
    cannot take (w >= 27, a K past its bounds) equal to JAX's ``"pallas"``
    route, which falls back to XLA the same way;
  * every route counted as the reference's ``_GEMM_ROUTES`` counts it;
  * ``run_plan`` / ``int_gemm`` on ``"aten"`` (mm1 / kmm2 / mm2 at every
    depth, xla_ref, ffip, both combines) equal to JAX's, and
    ``analytic_plan`` / ``validate`` on ``"aten"`` to the reference's on
    ``"xla"``;
  * the smoke llama on ``"aten"`` against the JAX engine on ``"xla"``:
    prefill and decode logits within 1e-4 (test_torch_lm.py's tolerance),
    greedy tokens identical, and every GEMM on the route;
  * the same smoke model on ``"cuda"`` against ``"aten"``, float32 and
    bfloat16 compute: their fp32 combines differ by design (the kernel's
    padded K and centered digits against the recursion's raw digits), but
    under mixed only the w=12 ``lm_head`` runs one (every w=8 GEMM is
    exact on both routes, so every activation is the same), and the logits
    round that difference once: each logit within ``ROUTES_RTOL`` (one
    bfloat16 ulp) of the other route's, the gate chip_smoke.py's phase 5a
    holds the card's full-width llama to.  Here they come out identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import dispatch as jax_dispatch  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant import qmatmul as jax_qmm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.tune import space as jax_space  # noqa: E402
from repro_torch.bridge import (array_to_numpy, array_to_torch,  # noqa: E402
                                params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.core.dispatch import ExecPlan, analytic_plan  # noqa: E402
from repro_torch.kernels import launch_counts, ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.quant.prequant import record  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.tune import space  # noqa: E402

WIDTHS = [8, 12, 16, 20, 27, 28]
F32_ATOL = 1e-4
# "cuda" against "aten" on the same weights under mixed: one bfloat16 ulp
# of the larger logit.
ROUTES_RTOL = 2.0 ** -7
MAX_SEQ = 32
LENGTHS = (16, 11)
GREEDY = [(5, 4), (9, 3), (3, 5)]


def _np(t):
    return np.asarray(array_to_numpy(t)).astype(np.float32)


def _same(got, ref, msg=""):
    assert str(ref.dtype) == str(got.dtype).replace("torch.", ""), msg
    np.testing.assert_array_equal(_np(got), np.asarray(
        ref.astype(jnp.float32)), err_msg=msg)


def _inputs(shape_x, shape_w, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    wm = (rng.standard_normal(shape_w) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16))
    return x, wm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", WIDTHS)
def test_quantized_matmul_on_aten_matches_jax_xla(bits, dtype):
    launch0 = launch_counts()
    for i, (sx_, sw_, transpose) in enumerate(
            [((2, 5, 64), (64, 48), False), ((3, 1, 70), (40, 70), True)]):
        x, wm = _inputs(sx_, sw_, dtype, seed=100 * bits + i)
        jw = jnp.asarray(wm).T if transpose else jnp.asarray(wm)
        tw = array_to_torch(wm).T if transpose else array_to_torch(wm)
        for mode in ("auto", "mm2"):
            ref = jax_qmm.quantized_matmul(
                jnp.asarray(x), jw, bits,
                context=JaxContext(backend="xla", force_mode=mode))
            got = qmatmul.quantized_matmul(
                array_to_torch(x), tw, bits,
                context=ExecContext(backend="aten", force_mode=mode))
            _same(got, ref, f"{sx_} x {sw_} {mode}")
            # force_mode on the kernels' backend takes the same route
            got = qmatmul.quantized_matmul(
                array_to_torch(x), tw, bits,
                context=ExecContext(backend="cuda", force_mode=mode))
            if mode == "mm2":
                _same(got, ref, f"{sx_} x {sw_} cuda {mode}")
    assert launch_counts() == launch0


@pytest.mark.parametrize("bits", WIDTHS)
def test_quantized_matmul_batched_on_aten_matches_jax_xla(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((4, 12, 64)).astype(np.float32)
    wm = (rng.standard_normal((4, 64, 40)) * 0.1).astype(np.float32)
    x[2] = 0.0
    counts = np.array([[3, 0, 4], [4, 4, 4], [0, 0, 0], [1, 2, 0]],
                      np.int32)
    for c in (None, counts):
        for mode in ("auto", "mm2"):
            kw = {} if c is None else {"seg": 4}
            ref = jax_qmm.quantized_matmul_batched(
                jnp.asarray(x), jnp.asarray(wm), bits,
                context=JaxContext(backend="xla", force_mode=mode),
                counts=None if c is None else jnp.asarray(c), **kw)
            got = qmatmul.quantized_matmul_batched(
                torch.from_numpy(x), torch.from_numpy(wm), bits,
                context=ExecContext(backend="aten", force_mode=mode),
                counts=None if c is None else torch.from_numpy(c), **kw)
            _same(got, ref, f"ragged={c is not None} {mode}")
            if c is not None:
                dead = ~np.asarray(qmatmul.ragged_row_mask(
                    torch.from_numpy(c), 4, 12))[..., 0]
                assert (_np(got)[dead] == 0).all()


@pytest.mark.parametrize("bits", WIDTHS)
def test_prequant_matmul_on_aten_matches_jax_xla(bits):
    """Records (codes stored in int8 / int16, saturated above w=16 as the
    reference's) on the ATen route, dense and batched-ragged."""
    rng = np.random.default_rng(bits + 50)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    wm = (rng.standard_normal((64, 24)) * 0.1).astype(np.float32)
    xe = rng.standard_normal((3, 8, 64)).astype(np.float32)
    we = (rng.standard_normal((3, 64, 16)) * 0.1).astype(np.float32)
    counts = np.array([[2, 4], [0, 3], [4, 4]], np.int32)
    for xx, ww, kw in ((x, wm, {}),
                       (xe, we, {"batched": True, "seg": 4})):
        rec = record(torch.from_numpy(ww), bits)
        jrec = {k: jnp.asarray(v.numpy()) for k, v in rec.items()}
        cnt = counts if kw else None
        ref = jax_qmm.prequant_matmul(
            jnp.asarray(xx), jrec, bits, context=JaxContext(backend="xla"),
            counts=None if cnt is None else jnp.asarray(cnt), **kw)
        got = qmatmul.prequant_matmul(
            torch.from_numpy(xx), rec, bits,
            context=ExecContext(backend="aten"),
            counts=None if cnt is None else torch.from_numpy(cnt), **kw)
        _same(got, ref, f"batched={bool(kw)}")


def test_kernels_fall_back_to_the_aten_route_as_the_reference():
    """On "cuda" (JAX: "pallas") a GEMM outside the fused windows (w >= 27)
    or past the kernel's bounds (w=14 digit accumulators at K=2^16) takes
    the ATen route (JAX: XLA); the results equal JAX's and the route is
    counted as a fallback."""
    x, wm = _inputs((2, 3, 64), (64, 16), "float32", 5)
    xk = np.random.default_rng(6).standard_normal((1, 1 << 16)).astype(
        np.float32)
    wk = (np.random.default_rng(7).standard_normal((1 << 16, 4)) * 0.1
          ).astype(np.float32)
    qmatmul.reset_gemm_routes()
    for xx, ww, bits in ((x, wm, 27), (x, wm, 28), (xk, wk, 14)):
        ref = jax_qmm.quantized_matmul(jnp.asarray(xx), jnp.asarray(ww),
                                       bits, context=JaxContext(
                                           backend="pallas"))
        got = qmatmul.quantized_matmul(torch.from_numpy(xx),
                                       torch.from_numpy(ww), bits)
        _same(got, ref, f"w={bits} K={xx.shape[-1]}")
    assert qmatmul.gemm_routes() == {("cuda", "aten_fallback"): 3}


def test_gemm_routes_count_every_gemm():
    x, wm = _inputs((2, 3, 32), (32, 8), "float32", 1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wm)
    qmatmul.reset_gemm_routes()
    qmatmul.quantized_matmul(xt, wt, 8)
    qmatmul.quantized_matmul(xt, wt, 12)
    qmatmul.quantized_matmul(xt, wt, 28)
    qmatmul.quantized_matmul(xt, wt, 12, context=ExecContext(
        force_mode="mm2"))
    qmatmul.quantized_matmul(xt, wt, 12, context=ExecContext(
        backend="aten"))
    qmatmul.quantized_matmul_batched(xt[None, 0], wt[None], 8,
                                     context=ExecContext(backend="aten"))
    assert qmatmul.gemm_routes() == {
        ("cuda", "cuda"): 2, ("cuda", "aten_fallback"): 1,
        ("cuda", "aten"): 1, ("aten", "aten"): 2}
    qmatmul.reset_gemm_routes()
    assert qmatmul.gemm_routes() == {}


@pytest.mark.parametrize("w", [4, 8, 9, 12, 14, 15, 16, 17, 20, 24, 27, 28])
def test_analytic_plan_and_run_plan_on_aten_match_jax_xla(w):
    """The analytic "aten" plan is the reference's "xla" rule, and
    run_plan / int_gemm on it (and on its int32-combine twin, and on a
    deeper recursion) equal JAX's, exact and fp32."""
    got = analytic_plan(w, backend="aten")
    ref = jax_dispatch.analytic_plan(w, backend="xla")
    assert (got.variant, got.depth, got.combine_int32, got.digits) == \
        (ref.variant, ref.depth, ref.combine_int32, ref.digits)
    rng = np.random.default_rng(w)
    lim = 1 << (w - 1)
    k = 40
    a = rng.integers(-lim, lim, (5, k)).astype(np.int32)
    b = rng.integers(-lim, lim, (k, 7)).astype(np.int32)
    plans = [got, ExecPlan(got.variant, w, backend="aten",
                           combine_int32=True, depth=got.depth)]
    if got.variant == "kmm2" and got.depth < 3:
        plans.append(ExecPlan("kmm2", w, backend="aten", depth=got.depth + 1))
    for plan in plans:
        jplan = jax_dispatch.ExecPlan(plan.variant, w, backend="xla",
                                      combine_int32=plan.combine_int32,
                                      depth=plan.depth)
        out = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                           plan=plan)
        want = jax_ops.run_plan_jit(jnp.asarray(a), jnp.asarray(b), jplan)
        assert str(out.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want),
                                      err_msg=str(plan))
    for exact in (False, True):
        if exact and ops.max_exact_k(w) < k:
            continue
        out = ops.int_gemm(torch.from_numpy(a), torch.from_numpy(b), w=w,
                           backend="aten", exact=exact)
        want = jax_ops.int_gemm(jnp.asarray(a), jnp.asarray(b), w=w,
                                backend="xla", exact=exact)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_xla_ref_and_ffip_variants_match_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (8, 64)).astype(np.int32)
    b = rng.integers(-128, 128, (64, 8)).astype(np.int32)
    for variant in ("xla_ref", "ffip"):
        for backend, jbackend in (("aten", "xla"), ("cuda", "pallas")):
            plan = ExecPlan(variant, 8, backend=backend, combine_int32=True,
                            depth=0)
            assert space.validate(plan, (8, 64, 8)) is None
            out = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                               plan=plan)
            want = jax_ops.run_plan_jit(jnp.asarray(a), jnp.asarray(b),
                                        jax_dispatch.ExecPlan(
                                            variant, 8, backend=jbackend,
                                            combine_int32=True, depth=0))
            np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_validate_on_aten_matches_reference_on_xla():
    shapes = [(16, 64, 16), (4, 2048, 8192), (1, 40, 5), (64, 300, 130)]
    n = 0
    for w in (4, 8, 9, 12, 14, 15, 16, 20, 27, 28):
        for variant in ("mm1", "kmm2", "mm2", "fused", "fused_mm2",
                        "xla_ref", "ffip", "strassen", "strassen+kmm2"):
            for depth in (0, 1, 2, 3, 4):
                for ci in (False, True):
                    plan = ExecPlan(variant, w, backend="aten",
                                    combine_int32=ci, depth=depth)
                    jplan = jax_dispatch.ExecPlan(variant, w, backend="xla",
                                                  combine_int32=ci,
                                                  depth=depth)
                    for shape in shapes:
                        got = space.validate(plan, shape)
                        ref = jax_space.validate(jplan, shape)
                        assert (got is None) == (ref is None), \
                            (plan, shape, got, ref)
                        n += got is None
    assert n > 100
    assert "unknown backend" in space.validate(
        ExecPlan("kmm2", 12, backend="xla"), (8, 8, 8))


def _configs(backend):
    jcfg = jax_get_config("llama3.2-1b", smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(
        jcfg.quant, backend={"aten": "xla", "cuda": "pallas"}[backend]))
    tcfg = get_config("llama3.2-1b", smoke=True, quant="mixed")
    tcfg = tcfg.with_quant(dataclasses.replace(tcfg.quant, backend=backend))
    return (jcfg.scaled_down(compute_dtype="float32"),
            tcfg.scaled_down(compute_dtype="float32"))


def _prefill_decode(tcfg, tparams, toks, mask, last):
    with torch.inference_mode():
        cache = lm.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
        logits, cache, _ = lm.prefill(
            tparams, tcfg, torch.from_numpy(toks), cache,
            pad_mask=torch.from_numpy(mask), last_idx=torch.from_numpy(last))
        dlogits, _ = lm.decode_step(tparams, tcfg, torch.argmax(logits, -1),
                                    cache, torch.from_numpy(last + 1))
    return [x.to(torch.float32).numpy() for x in (logits, dlogits)]


@pytest.fixture(scope="module")
def smoke_llama():
    jcfg, tcfg = _configs("aten")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, tcfg.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array(LENGTHS)[:, None]
    toks = np.where(mask, toks, 0).astype(np.int32)
    last = np.array(LENGTHS, np.int32) - 1
    return jcfg, jparams, tcfg, tparams, (toks, mask, last)


def test_smoke_llama_on_aten_matches_jax_xla(smoke_llama):
    jcfg, jparams, tcfg, tparams, (toks, mask, last) = smoke_llama
    cache = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    logits, cache, _ = jax.jit(lambda p, t, c, m, li: jax_lm.prefill(
        p, jcfg, t, c, pad_mask=m, last_idx=li))(
            jparams, jnp.asarray(toks), cache, jnp.asarray(mask),
            jnp.asarray(last))
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    dlogits, _ = jax.jit(lambda p, t, c, pos: jax_lm.decode_step(
        p, jcfg, t, c, pos))(jparams, nxt, cache, jnp.asarray(last + 1))
    qmatmul.reset_gemm_routes()
    launch0 = launch_counts()
    got = _prefill_decode(tcfg, tparams, toks, mask, last)
    n_gemm = 7 * tcfg.n_layers + 1
    assert qmatmul.gemm_routes() == {("aten", "aten"): 2 * n_gemm}
    assert launch_counts() == launch0
    v = tcfg.vocab_size
    for name, r, g in zip(("prefill", "decode"), (logits, dlogits), got):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g[:, :v], r[:, :v], rtol=0, atol=F32_ATOL,
                                   err_msg=name)
        np.testing.assert_array_equal(g[:, :v].argmax(-1),
                                      r[:, :v].argmax(-1))


def test_smoke_llama_engine_on_aten_matches_jax_engine(smoke_llama):
    jcfg, jparams, tcfg, tparams, _ = smoke_llama
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, tcfg.vocab_size, size=n)]
               for n, _ in GREEDY]
    jeng = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, batch_size=2,
                     rng_seed=5, context=JaxContext(backend="xla"))
    jreqs = [JaxRequest(prompt=p, max_new_tokens=m)
             for p, (_, m) in zip(prompts, GREEDY)]
    jeng.generate(jreqs)
    eng = Engine(tcfg, tparams, max_seq=MAX_SEQ, batch_size=2, rng_seed=5,
                 context=ExecContext(backend="aten"), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, (_, m) in zip(prompts, GREEDY)]
    eng.generate(reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routes_agree_within_the_stated_tolerance(smoke_llama, dtype):
    """The same weights on "cuda" (fused kernel numerics) and "aten"
    (digit recursion numerics): the gate chip_smoke.py holds the card's
    full-width llama to."""
    _, _, tcfg, tparams, inputs = smoke_llama
    aten = _prefill_decode(tcfg.scaled_down(compute_dtype=dtype), tparams,
                           *inputs)
    cuda = _prefill_decode(_configs("cuda")[1].scaled_down(
        compute_dtype=dtype), tparams, *inputs)
    v = tcfg.vocab_size
    for a, c in zip(aten, cuda):
        a, c = a[:, :v], c[:, :v]
        assert (np.abs(a - c) <= ROUTES_RTOL * np.maximum(np.abs(a),
                                                          np.abs(c))).all()
