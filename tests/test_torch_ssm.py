"""The port's mamba block (repro_torch.models.ssm) and its selective-scan
kernel's plain version (repro_torch.kernels.ssm_scan) against the JAX
reference, on jamba-v0.1-52b's narrow config (``SMOKE`` at d_model 64,
d_ff 128, vocab 256: the config of the reference's chunked-prefill test)
under the mixed policy in float32 compute, the reference's parameters
carried over by ``bridge.params_from_jax``:

  * ``mamba_init`` makes the reference's leaves, in its order;
  * ``mamba_apply_stateful`` from a zero and from a carried state, with
    right- and left-padded rows (``mask``, ``last_idx``), and
    ``mamba_decode`` over several steps: outputs and both state leaves
    within ``MOE_ATOL`` of JAX;
  * chunked resumes at boundaries 1, 3, 4 and 9 (below, at and past
    ``conv_width - 1``) equal to a single shot in the port
    (``torch.equal``) and within ``MOE_ATOL`` of JAX chunked the same way;
  * ``ssm_scan_reference`` within ``EMU_TOL`` (relative and absolute) of
    a numpy emulation of ``csrc/ssm_scan.cu``'s order (sequential t,
    s-ordered sum, every op rounded apart; numpy's exp and ATen's are an
    ulp apart);
  * padded prefill equal to unpadded in the port on jamba's pattern with
    every MoE off (the reference's own padded run differs from its
    unpadded one only through the MoE capacity, which it takes from the
    padded length);
  * the paged pool's state rows carry the conv tail (compute dtype) and
    the SSM state (fp32): slot zeroing, prefix snapshots, the decode
    gather and scatter, and warm() on the parking rows.

Tolerances: the quantized GEMMs are bit-exact, the conv, SiLU, softplus
and exp are XLA's and ATen's a few ulp apart, and the reference's
associative scan adds in another order than the sequential recurrence;
the block's outputs and states agree to ~1e-6, held to ``MOE_ATOL`` =
1e-5 (test_torch_qwen3_moe.py's MoE tolerance).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts, ssm_scan  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.config import Block  # noqa: E402
from repro_torch.serve.cache import PagedCachePool  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.executor import Executor  # noqa: E402

ARCH = "jamba-v0.1-52b"
NARROW = dict(d_model=64, d_ff=128, vocab_size=256)
MOE_ATOL = 1e-5
EMU_TOL = 1e-6
NAME = "blk0.mamba"
B, SEQ = 2, 12
LENGTHS = (12, 7)


def _cfgs(compute_dtype="float32", moe=True):
    jcfg = jax_get_config(ARCH, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant, backend="pallas"))
    jcfg = jcfg.scaled_down(compute_dtype=compute_dtype, **NARROW)
    tcfg = get_config(ARCH, smoke=True, quant="mixed").scaled_down(
        compute_dtype=compute_dtype, **NARROW)
    if not moe:
        jcfg = dataclasses.replace(jcfg, pattern=tuple(
            dataclasses.replace(b, moe=False) for b in jcfg.pattern))
        tcfg = dataclasses.replace(tcfg, pattern=tuple(
            Block(b.kind) for b in tcfg.pattern))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def block():
    """The reference's parameters of one mamba block (period 0, pos 0),
    on both sides."""
    jcfg, tcfg = _cfgs()
    jparams = jax_lm.init_params(jax.random.PRNGKey(1), jcfg)
    pj = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["mamba"])
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _x(cfg, seed=0, s=SEQ):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _state(cfg, seed):
    di = cfg.expand * cfg.d_model
    if seed is None:
        return {"conv": np.zeros((B, cfg.conv_width - 1, di), np.float32),
                "ssm": np.zeros((B, di, cfg.d_state), np.float32)}
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal(
                (B, cfg.conv_width - 1, di)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, di, cfg.d_state)).astype(np.float32) * 0.3}


def _jax_block(jcfg, pj, x, state, mask=None, last=None):
    out, c = jax_ssm.mamba_apply_stateful(
        pj, jnp.asarray(x), jax.tree.map(jnp.asarray, state), jcfg,
        jcfg.quant, NAME, chunk=8,
        mask=None if mask is None else jnp.asarray(mask),
        last_idx=None if last is None else jnp.asarray(last))
    return np.asarray(out), {k: np.asarray(v) for k, v in c.items()}


def _port_block(tcfg, pt, x, state, mask=None, last=None):
    cache = params_from_jax(state)
    with torch.inference_mode():
        out, c = S.mamba_apply_stateful(
            pt, torch.from_numpy(x), cache, tcfg, tcfg.quant, NAME,
            mask=None if mask is None else torch.from_numpy(mask),
            last_idx=None if last is None else torch.from_numpy(last))
    assert c is cache                              # updated in place
    return out, c


def _close(got_out, got_cache, want_out, want_cache, what):
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=0,
                               atol=MOE_ATOL, err_msg=f"{what} output")
    for leaf in ("conv", "ssm"):
        np.testing.assert_allclose(got_cache[leaf].numpy(), want_cache[leaf],
                                   rtol=0, atol=MOE_ATOL,
                                   err_msg=f"{what} {leaf}")


def test_mamba_init_makes_the_reference_leaves():
    """The reference's leaves in its order, its shapes and dtypes; the
    constant leaves equal to its values (a_log = log(1..ds) to XLA's and
    ATen's log, a few ulp apart)."""
    _, tcfg = _cfgs()
    ref = jax_ssm.mamba_init(jax.random.PRNGKey(0), tcfg, jnp.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = S.mamba_init(gen, tcfg, torch.float32, "cpu")
    assert list(mine) == list(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == torch.float32, k
    for k in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(mine["a_log"].numpy(), np.asarray(ref["a_log"]),
                               rtol=1e-6, atol=0)
    assert S._dt_rank(4096) == 256 and S._dt_rank(64) == 4


@pytest.mark.parametrize("state", [None, 3], ids=["zero", "carried"])
def test_block_matches_jax(block, state):
    """One sequence from a zero and from a random carried state, the
    second row right-padded (mask, last_idx): output, conv tail and SSM
    state against the reference; no kernel launch on the CPU."""
    jcfg, tcfg, pj, pt = block
    x, st = _x(tcfg), _state(tcfg, state)
    mask = np.arange(SEQ)[None, :] < np.array(LENGTHS)[:, None]
    last = np.array(LENGTHS, np.int32) - 1
    want = _jax_block(jcfg, pj, x, st, mask, last)
    got = _port_block(tcfg, pt, x, st, mask, last)
    _close(*got, *want, f"state {state}")
    assert not any(launch_counts().values())


def test_decode_steps_match_jax(block):
    """Five decode steps from a carried state, each step's output and
    state against the reference's ``mamba_decode``."""
    jcfg, tcfg, pj, pt = block
    st = _state(tcfg, 4)
    cj = jax.tree.map(jnp.asarray, st)
    ct = params_from_jax(st)
    for step in range(5):
        x = _x(tcfg, seed=10 + step, s=1)
        oj, cj = jax_ssm.mamba_decode(pj, jnp.asarray(x), cj, jcfg,
                                      jcfg.quant, NAME)
        with torch.inference_mode():
            ot, c2 = S.mamba_decode(pt, torch.from_numpy(x), ct, tcfg,
                                    tcfg.quant, NAME)
        assert c2 is ct
        _close(ot, ct, np.asarray(oj), {k: np.asarray(v)
                                        for k, v in cj.items()},
               f"decode step {step}")


@pytest.mark.parametrize("pad", ["right", "left"])
def test_ragged_padding_matches_jax(block, pad):
    """Right padding from a carried state (the tail taken at
    ``last_idx``) and left padding from a zero one (a sequence start: pads
    first, the state frozen on them, the tail at the last position) against
    the reference's padded call; and each row equals its own unpadded run
    in the port."""
    jcfg, tcfg, pj, pt = block
    x, st = _x(tcfg, seed=5), _state(tcfg, 6 if pad == "right" else None)
    lens = np.array(LENGTHS)
    if pad == "right":
        mask = np.arange(SEQ)[None, :] < lens[:, None]
        last = lens.astype(np.int32) - 1
    else:
        mask = np.arange(SEQ)[None, :] >= SEQ - lens[:, None]
        last = np.full(B, SEQ - 1, np.int32)
    want = _jax_block(jcfg, pj, x, st, mask, last)
    got_out, got_cache = _port_block(tcfg, pt, x, st, mask, last)
    _close(got_out, got_cache, *want, f"{pad}-padded")
    for i in range(B):
        real = np.flatnonzero(mask[i])
        row = {k: v[i:i + 1] for k, v in st.items()}
        cache = params_from_jax(row)
        with torch.inference_mode():
            out, _ = S.mamba_apply_stateful(
                pt, torch.from_numpy(x[i:i + 1, real]), cache, tcfg,
                tcfg.quant, NAME)
        np.testing.assert_allclose(got_out[i, real].numpy(), out[0].numpy(),
                                   rtol=0, atol=MOE_ATOL)
        for leaf in ("conv", "ssm"):
            np.testing.assert_allclose(got_cache[leaf][i].numpy(),
                                       cache[leaf][0].numpy(), rtol=0,
                                       atol=MOE_ATOL, err_msg=leaf)


@pytest.mark.parametrize("cut", [1, 3, 4, 9])
def test_chunked_resume_equals_single_shot(block, cut):
    """A 12-token sequence from a carried state in two chunks cut at
    ``cut`` (a first chunk shorter than, equal to and longer than the conv
    tail's 3 tokens): output and state torch.equal to the single shot in
    the port, and within MOE_ATOL of the reference chunked the same way."""
    jcfg, tcfg, pj, pt = block
    x, st = _x(tcfg, seed=7), _state(tcfg, 8)
    one_out, one_cache = _port_block(tcfg, pt, x, st)
    cache = params_from_jax(st)
    cj = jax.tree.map(jnp.asarray, st)
    outs, outs_j = [], []
    for lo, hi in ((0, cut), (cut, SEQ)):
        with torch.inference_mode():
            o, _ = S.mamba_apply_stateful(
                pt, torch.from_numpy(x[:, lo:hi]), cache, tcfg, tcfg.quant,
                NAME)
        oj, cj = jax_ssm.mamba_apply_stateful(
            pj, jnp.asarray(x[:, lo:hi]), cj, jcfg, jcfg.quant, NAME,
            chunk=8)
        outs.append(o)
        outs_j.append(np.asarray(oj))
    chunked = torch.cat(outs, dim=1)
    assert torch.equal(chunked, one_out)
    for leaf in ("conv", "ssm"):
        assert torch.equal(cache[leaf], one_cache[leaf]), leaf
    _close(chunked, cache, np.concatenate(outs_j, axis=1),
           {k: np.asarray(v) for k, v in cj.items()}, f"cut {cut}")


def _emulate(x, delta, b, c, z, a, d_skip, h, mask):
    """numpy float32, csrc/ssm_scan.cu's order: per step, da = exp(dt a),
    h = da h + (dt x) b, y = h[0] c[0] + h[1] c[1] + ... in s order, y +=
    x d_skip, y *= z / (1 + exp(-z)); every op rounded apart (no fma)."""
    f = np.float32
    bsz, s, di = x.shape
    ds = a.shape[1]
    h = h.copy()
    y = np.zeros((bsz, s, di), f)
    for t in range(s):
        dt, xt = delta[:, t], x[:, t]
        live = mask[:, t] if mask is not None else np.ones(bsz, bool)
        dx = (dt * xt).astype(f)
        for j in range(ds):
            da = np.exp((dt * a[None, :, j]).astype(f)).astype(f)
            new = ((da * h[:, :, j]).astype(f)
                   + (dx * b[:, t, None, j]).astype(f)).astype(f)
            h[:, :, j] = np.where(live[:, None], new, h[:, :, j])
        acc = (h[:, :, 0] * c[:, t, None, 0]).astype(f)
        for j in range(1, ds):
            acc = (acc + (h[:, :, j] * c[:, t, None, j]).astype(f)).astype(f)
        acc = (acc + (xt * d_skip).astype(f)).astype(f)
        zt = z[:, t]
        silu = (zt / (f(1) + np.exp(-zt).astype(f))).astype(f)
        y[:, t] = (acc * silu).astype(f)
    return y, h


@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_scan_reference_matches_kernel_order(ds, masked):
    """The plain version against a numpy emulation of the kernel's order,
    from a carried state, at the configs' state sizes; the CPU wrapper
    writes the final state into h in place and counts no launch."""
    rng = np.random.default_rng(ds)
    bsz, s, di = 3, 9, 40
    f = np.float32
    x = rng.standard_normal((bsz, s, di)).astype(f)
    delta = np.log1p(np.exp(rng.standard_normal((bsz, s, di)))).astype(f)
    b, c = (rng.standard_normal((bsz, s, ds)).astype(f) for _ in range(2))
    z = rng.standard_normal((bsz, s, di)).astype(f)
    a = -np.tile(np.arange(1, ds + 1, dtype=f), (di, 1))
    d_skip = rng.standard_normal(di).astype(f)
    h0 = rng.standard_normal((bsz, di, ds)).astype(f) * 0.3
    mask = (rng.random((bsz, s)) > 0.3) if masked else None
    want_y, want_h = _emulate(x, delta, b, c, z, a, d_skip, h0, mask)
    tt = [torch.from_numpy(v) for v in (x, delta, b, c, z, a, d_skip)]
    tmask = None if mask is None else torch.from_numpy(mask)
    y, h = ssm_scan.ssm_scan_reference(*tt, torch.from_numpy(h0), tmask)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=EMU_TOL,
                               atol=EMU_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=EMU_TOL,
                               atol=EMU_TOL)
    h_io = torch.from_numpy(h0.copy())
    ssm_scan.reset_launches()
    y2 = ssm_scan.ssm_scan(*tt, h_io, tmask)
    assert torch.equal(y2, y) and torch.equal(h_io, h)
    assert ssm_scan.launches == {"ssm_scan": 0, "ssm_scan_bwd": 0}


def test_scan_wrapper_refuses_bad_operands():
    f32 = torch.float32
    x = torch.zeros((1, 2, 4), dtype=f32)
    b = torch.zeros((1, 2, 8), dtype=f32)
    a, d_skip = torch.zeros((4, 8), dtype=f32), torch.zeros(4, dtype=f32)
    h = torch.zeros((1, 4, 8), dtype=f32)
    ok = (x, x, b, b, x, a, d_skip, h)
    ssm_scan.ssm_scan(*ok)
    with pytest.raises(ValueError, match="d_state"):
        ssm_scan.ssm_scan(x, x, b[..., :6], b[..., :6], x, a[:, :6],
                          d_skip, h[..., :6])
    with pytest.raises(TypeError, match="z"):
        ssm_scan.ssm_scan(x, x, b, b, x.to(torch.float16), a, d_skip, h)
    with pytest.raises(ValueError, match="h's last axis"):
        ssm_scan.ssm_scan(x, x, b, b, x, a, d_skip,
                          torch.zeros((1, 8, 4), dtype=f32).transpose(1, 2))
    with pytest.raises(ValueError, match="mask"):
        ssm_scan.ssm_scan(*ok, mask=torch.ones((1, 3), dtype=torch.bool))


@pytest.mark.parametrize("length", [1, 5, 8])
def test_padded_prefill_equals_unpadded_without_moe(length):
    """jamba's pattern with every MoE off: a right-padded prompt (buckets 8
    and 16) gives the unpadded prompt's logits and every mamba state leaf
    in the port (with MoE on, the capacity depends on the padded length,
    in the reference as here)."""
    _, tcfg = _cfgs(moe=False)
    gen = torch.Generator()
    gen.manual_seed(length)
    params = lm.init_params(gen, tcfg, device="cpu")
    prompt = np.random.default_rng(length).integers(1, tcfg.vocab_size,
                                                    size=length)
    with torch.inference_mode():
        c0 = lm.init_cache(tcfg, 1, 32, device="cpu")
        ref, c0, _ = lm.prefill(params, tcfg, torch.from_numpy(prompt[None]),
                                c0)
        for width in (8, 16):
            toks = np.zeros((1, width), np.int64)
            toks[0, :length] = prompt
            c1 = lm.init_cache(tcfg, 1, 32, device="cpu")
            got, c1, _ = lm.prefill(
                params, tcfg, torch.from_numpy(toks), c1,
                pad_mask=torch.arange(width)[None] < length,
                last_idx=torch.tensor([length - 1]))
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=MOE_ATOL)
            for pos, spec in enumerate(tcfg.pattern):
                if spec.kind != "mamba":
                    continue
                for leaf in ("conv", "ssm"):
                    np.testing.assert_allclose(
                        c1[f"pos{pos}"][leaf].numpy(),
                        c0[f"pos{pos}"][leaf].numpy(), rtol=0, atol=MOE_ATOL,
                        err_msg=f"pos{pos} {leaf} width {width}")


def test_pool_carries_both_state_leaves():
    """The mamba leaves are state rows of the pool (no new code): the conv
    tail in the compute dtype and the SSM state in fp32, one row a slot,
    the snapshot rows and a parking row; ``zero_slot_state`` clears one
    slot's rows of both, a snapshot takes and restores both, and the decode
    gather / scatter moves both rows and dtypes unchanged."""
    _, tcfg = _cfgs(compute_dtype="bfloat16")
    di, ds, cw = 2 * 64, tcfg.d_state, tcfg.conv_width
    pool = PagedCachePool(tcfg, 3, 32, 8, snapshot_slots=1, device="cpu")
    conv, ssm = pool.pools["pos0"]["conv"], pool.pools["pos0"]["ssm"]
    assert conv.shape == (1, 5, cw - 1, di) and conv.dtype == torch.bfloat16
    assert ssm.shape == (1, 5, di, ds) and ssm.dtype == torch.float32
    assert set(pool.pools["pos4"]) == {"k", "v"}
    gen = torch.Generator()
    gen.manual_seed(0)
    for t in (conv, ssm):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = {k: t.clone() for k, t in (("conv", conv), ("ssm", ssm))}
    pool.zero_slot_state(1)
    for k, t in (("conv", conv), ("ssm", ssm)):
        assert not t[:, 1].any()
        assert torch.equal(t[:, [0, 2, 3, 4]], before[k][:, [0, 2, 3, 4]])
    handle = pool.take_snapshot(0, 1)
    assert handle is not None and handle[1] == 4
    pool.zero_slot_state(0)
    pool.restore_snapshot(2, handle)
    for k, t in (("conv", conv), ("ssm", ssm)):
        assert torch.equal(t[:, 2], before[k][:, 0]) and not t[:, 0].any()
    ex = Executor(tcfg, {}, pool, torch.device("cpu"))
    prows, srows = (torch.as_tensor(v) for v in pool.lane_rows([2, None]))
    assert srows.tolist() == [2, pool.parking_state]
    lanes = ex._gather(prows, srows)
    assert lanes["pos0"]["conv"].dtype == torch.bfloat16
    assert torch.equal(lanes["pos0"]["ssm"][:, 0], ssm[:, 2])
    lanes["pos0"]["ssm"][:, 0] += 1.0
    lanes["pos0"]["conv"][:, 0] = 2.0
    ex._scatter(lanes, prows, srows)
    assert torch.equal(ssm[:, 2], before["ssm"][:, 0] + 1.0)
    assert conv[:, 2].eq(2.0).all()


def test_warm_runs_on_the_parking_rows_only():
    """``Engine.warm()`` decodes every width and prefills every bucket on
    the parking rows: every slot's conv and SSM rows stay as they were,
    and the parking row's state moved (the rows a captured decode graph
    writes for padded lanes)."""
    jcfg, tcfg = _cfgs()
    jparams = jax_lm.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    eng = Engine(tcfg, tparams, max_seq=32, batch_size=2, device="cpu",
                 prompt_buckets=(8, 16))
    ssm = eng.pool.pools["pos0"]["ssm"]
    before = ssm.clone()
    eng.warm()
    slots = eng.pool.state_table.tolist()
    assert torch.equal(ssm[:, slots], before[:, slots])
    assert ssm[:, eng.pool.parking_state].abs().sum() > 0
