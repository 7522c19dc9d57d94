"""MoE under a mesh on four gloo ranks on the CPU (one launch for the
module: the ranks run ``tests/_torch_moe_mesh_ranks.py`` as subprocesses,
on a 2x2 and then a 1x4 mesh, and import no JAX), held to the port's
unsharded runs and, for the engine's greedy tokens, to the reference's
meshless JAX engine (the reference's own mesh paths fail under jax 0.9.0,
so they are not the oracle; its oracles are computed here while the ranks
run).  Smoke granite and qwen3: 8 experts top-2, 2 kv heads.

  * ``quantized_matmul_batched``, ragged, at w=8 and w=12 on an expert leaf
    held at rest (dim 0 over ``model``, its K rows over ``data``): the
    forward ``torch.equal`` to the unsharded call, every grouped launch over
    E / model experts; under the ambient mesh the STE backward on blocks —
    dx ``torch.equal`` to the unsharded call's rows, dead rows exactly 0,
    dW (this rank's block, reduce-scattered over ``data``) within 1e-6 of
    the leaf's largest entry;
  * the engine with ``mesh=`` on both models: tokens and every sampled
    logits row ``torch.equal`` to the unsharded engine, greedy tokens equal
    to the JAX engine's, every GEMM on the kernels (no fallback), every
    grouped launch over E / model experts, every leaf its ``leaf_spec``
    block; the MoE dispatch metrics count each data rank's rows and no
    parking-row prefill; 6 experts on 1x4 (4 does not divide them) take the
    ATen route, counted, with the unsharded tokens;
  * granite's train step 1 from the reference's params and a nonzero AdamW
    state through ``bridge.params_from_jax(mesh=)`` /
    ``opt_state_from_jax(mesh=)`` (fp32, 2 microbatches) against the port's
    meshless step from the same inputs: the loss, every layer's aux loss
    (its means over the global microbatch), the grad norm, every gradient
    leaf, params, mu and nu within ``tests/test_torch_train_mesh.py``'s
    tolerances; with the bf16 compute copy on, its measured gate;
  * a 2x2 restart ``torch.equal``; its step-2 checkpoint reloaded on 1x4
    and 2x2 (expert leaves held as their specs place them) and here with no
    mesh, equal to the logical arrays.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_moe_mesh_ranks as R  # noqa: E402

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# tests/test_torch_train_mesh.py's tolerances (tests/test_torch_train.py
# states their reasons): the mesh reorders fp32 sums (the model axis's
# all-reduced dx, the data axes' reduce-scattered dW), 1.1e-6 of a leaf's
# largest entry at worst measured here
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
# the STE backward's dW on blocks against the unsharded call's: the same
# products, the rows' sum split over the data ranks (measured 1.5e-7)
DW_TOL = 1e-6
# With the bf16 compute copy (the expert leaves pass its 65536-element
# rule) each weight's gradient rounds to bf16 after its fp32 sums, which
# the mesh reorders: one bf16 ulp is at most 2^-7 = 7.8e-3 of a leaf's
# largest entry (measured 1.08e-3, moe.wo); test_torch_train_mesh.py's
# bf16 gate.
BF16_GRAD_TOL = 1e-2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def _jcfg(arch, **kw):
    return jax_get_config(arch, smoke=True, quant="mixed").scaled_down(
        compute_dtype="float32", **kw)


def _inputs():
    """The reference's params for both smoke models (seed 0) as the port's
    tensors, granite's for training (seed 5) with a nonzero AdamW state as
    numpy, and the global batch; the reference's params too."""
    inp, jparams = {}, {}
    for arch in R.ARCHS:
        jparams[arch] = jax_lm.init_params(jax.random.PRNGKey(0), _jcfg(arch))
        inp[f"params/{arch}"] = bridge.params_from_jax(
            jax.tree.map(np.asarray, jparams[arch]))
    jcfg = _jcfg(R.ARCHS[0], n_microbatches=2)
    params = jax.tree.map(np.asarray, jax_lm.init_params(
        jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape))
                      .astype(np.float32), params)
    nu = jax.tree.map(lambda a: (1e-6 * np.abs(rng.standard_normal(
        a.shape))).astype(np.float32), params)
    inp["train_params"] = params
    inp["train_state"] = (np.int32(0), mu, nu)
    inp["batch"] = jax_data.DataIterator(jax_data.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=R.SEQ, global_batch=R.BATCH,
        seed=3)).peek(2)
    return inp, jparams


def _jax_engine_tokens(jparams):
    """The reference's meshless engine on the ranks' requests."""
    out = {}
    for arch in R.ARCHS:
        jcfg = _jcfg(arch)
        reqs = [JaxRequest(prompt=p, max_new_tokens=m, temperature=t)
                for p, m, t in R.engine_requests(jcfg.vocab_size)]
        JaxEngine(jcfg, jparams[arch], max_seq=32, batch_size=8, rng_seed=3,
                  context=JaxContext(backend="pallas")).generate(reqs)
        out[arch] = [r.generated for r in reqs]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks, run the reference's engines meanwhile; return
    (every rank's outputs, the JAX engines' tokens, seconds the ranks
    took)."""
    work = str(tmp_path_factory.mktemp("moe_mesh"))
    inputs, jparams = _inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_moe_mesh_ranks.py"),
         str(r), str(WORLD), str(port), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        tokens = _jax_engine_tokens(jparams)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.monotonic() - t0
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return outs, tokens, seconds


def _close_to_max(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def test_ranks_ran_on_two_meshes(ranks, record_property):
    outs, _, seconds = ranks
    record_property("ranks_seconds", seconds)     # reported, not gated
    for tag, shape in MESHES.items():
        coords = sorted((o["coord"][tag]["data"], o["coord"][tag]["model"])
                        for o in outs)
        assert coords == sorted((d, m) for d in range(shape[0])
                                for m in range(shape[1])), tag


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_grouped_forward_equals_unsharded_on_own_experts(ranks, mesh, bits):
    outs, _, _ = ranks
    per_rank = R.E // MESHES[mesh][1]
    for o in outs:
        assert o[f"{mesh}/w{bits}/fwd_equal"]
        assert o[f"{mesh}/w{bits}/fwd_experts"] == [per_rank]


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_grouped_backward_on_blocks(ranks, mesh, bits):
    outs, _, _ = ranks
    d, m = MESHES[mesh]
    for o in outs:
        key = f"{mesh}/w{bits}"
        assert o[f"{key}/bwd_experts"] == [R.E // m]
        assert o[f"{key}/bwd_fwd_equal"]
        assert o[f"{key}/dx_equal"] and o[f"{key}/dx_dead_zero"]
        assert o[f"{key}/dw_err"] <= DW_TOL, o[f"{key}/dw_err"]
        # the block at rest: its experts, its data rank's K rows
        assert o[f"{key}/dw_shape"] == (R.E // m, R.KE // d, R.NE)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_weight_grad_on_an_expert_leaf(ranks, mesh):
    """``shard_gemm.weight_grad`` on a leaf whose dim 0 (experts) is held
    over ``model`` and dim 1 (K rows) over ``data``: each rank's dW of its
    experts from its own rows, summed over the data ranks and cut to the
    rows the rank holds."""
    outs, _, _ = ranks
    assert all(o[f"{mesh}/weight_grad_equal"] for o in outs)


def _greedy(tokens):
    return [t for t, (_, _, temp) in zip(tokens, R.engine_requests(512))
            if temp == 0.0]


def _engine_rows_equal(outs, got, d):
    """Every request's logits rows from the ranks of the data rank owning
    its slot (request i sits in slot i) equal the unsharded engine's;
    returns the rows compared."""
    n_rows = 0
    for o, g in zip(outs, got):
        for (rid, step), row in g["logits"].items():
            if rid * d // 8 != g["data_rank"] or step >= len(
                    g["tokens"][rid]):
                continue
            assert torch.equal(row, g["plain"]["logits"][(rid, step)]), \
                (rid, step)
            n_rows += 1
    return n_rows


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_equals_unsharded_and_jax(ranks, mesh, arch):
    outs, jax_tokens, _ = ranks
    d, m = MESHES[mesh]
    got = [o[f"{mesh}/engine/{arch}"] for o in outs]
    tokens = got[0]["tokens"]
    for g in got:
        assert g["tokens"] == tokens == g["plain"]["tokens"]
        assert g["experts"] == [R.E // m]
        assert g["plain"]["experts"] == [R.E]
        assert set(g["routes"]) == {("cuda", "cuda")}
        assert g["fallbacks"] == {}
        assert g["blocks_ok"]
    n_rows = _engine_rows_equal(outs, got, d)
    # every model rank of a data rank holds the same rows
    assert n_rows == sum(len(t) for t in tokens) * m
    assert _greedy(tokens) == _greedy(jax_tokens[arch])
    assert sum(len(t) for t in tokens) > len(tokens)    # decode ran


def test_dispatch_metrics_count_own_rows_not_parking(ranks):
    """Each rank's registry observes E x periods a lane of its own data
    rank's real prefills and decode steps (its parking-row prefills
    none); the model ranks of a data rank agree."""
    outs, _, _ = ranks
    by_data = {}
    for o in outs:
        res = o["2x2/metrics"]
        want = res["per_lane"] * (res["calls"]["prefill"]
                                  + res["calls"]["lanes"])
        assert res["counts"] and all(c == want for c in
                                     res["counts"].values()), res
        by_data.setdefault(o["coord"]["2x2"]["data"], []).append(
            (res["counts"], res["sums"]))
    assert all(v[0] == v[1] for v in by_data.values())
    assert len(by_data) == 2


def test_indivisible_experts_take_aten_route_counted(ranks):
    outs, _, _ = ranks
    for o in outs:
        g = o["1x4/indivisible"]
        assert g["tokens"] == g["plain"]["tokens"]
        assert g["experts"] == []              # no grouped kernel launch
        # the expert GEMMs, and the router (N = 6 experts, M this data
        # rank's rows): both shapes the mesh cannot tile
        grouped = {key for key in g["fallbacks"]
                   if key[2] == "expert dim 6 not divisible by model axis "
                   "(4)"}
        assert grouped and all(key[0][2] == 6 for key in
                               set(g["fallbacks"]) - grouped)
        assert g["routes"][("cuda", "aten_fallback")] == \
            sum(g["fallbacks"].values()) > 0
        assert g["routes"][("cuda", "cuda")] > 0
    assert _engine_rows_equal(outs, [o["1x4/indivisible"] for o in outs],
                              1) > 0


def _step_pair(outs, key):
    res = [o[key] for o in outs]
    for r in res:
        assert r["mesh"]["loss"] == res[0]["mesh"]["loss"]   # every rank
        assert r["mesh"]["grad_norm"] == res[0]["mesh"]["grad_norm"]
    return res[0]["mesh"], res[0]["plain"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_one_matches_meshless_port(ranks, mesh):
    outs, _, _ = ranks
    got, ref = _step_pair(outs, f"{mesh}/step")
    assert got["dtensors"] > 0 and got["step"] == ref["step"] == 1
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert got["grad_loss"] == got["loss"]
    # one aux loss a layer a microbatch, twice (the grads, then the step)
    assert len(got["aux"]) == len(ref["aux"]) == 2 * 2 * 2
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=GRAD_TOL_Q)
    assert got["experts"] == [R.E // MESHES[mesh][1]]
    assert set(got["routes"]) == {("cuda", "cuda")}
    for part in ("grads", "mu", "nu"):
        mine, theirs = dict(_flat(got[part])), dict(_flat(ref[part]))
        assert mine.keys() == theirs.keys()
        for name, g in mine.items():
            _close_to_max(g.numpy(), theirs[name].numpy(), GRAD_TOL_Q,
                          f"{mesh} {part} {name}")
    theirs = dict(_flat(ref["params"]))
    for name, p in _flat(got["params"]):
        # as tests/test_torch_train.py's step test bounds it
        err = float((p - theirs[name]).abs().max())
        assert err <= 1e-2 * R.OCFG["lr"], (mesh, name, err)


def test_step_one_with_bf16_copy_against_meshless_port(ranks):
    outs, _, _ = ranks
    got, ref = _step_pair(outs, "2x2/step_bf16")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-6)
    theirs = dict(_flat(ref["grads"]))
    for name, g in _flat(got["grads"]):
        _close_to_max(g.numpy(), theirs[name].numpy(), BF16_GRAD_TOL,
                      f"bf16 grad {name}")


def test_restart_on_mesh_is_bit_exact(ranks):
    outs, _, _ = ranks
    for o in outs:
        assert o["restart/restored_from"] == 2
        assert o["restart/equal"]
        straight, resumed = o["restart/losses"]
        assert sorted(resumed) == [2, 3]
        assert resumed[3] == straight[3]
        assert o["restart/resident"] == o["restart/planned"]


def test_elastic_checkpoint_with_expert_leaves(ranks):
    """The 2x2 run's step-2 checkpoint: the logical arrays the ranks
    gathered, read back on 1x4 and 2x2 (each expert leaf held as its spec
    places it) and here with no mesh."""
    outs, _, _ = ranks
    o = outs[0]
    d = o["ckpt_dir"]
    with np.load(os.path.join(d, "step_00000002", "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    first = dict(_flat(o["restart/first_params"]))
    for k, p in first.items():
        assert np.array_equal(arrays["0||" + k.replace(".", "||")],
                              p.numpy()), k
    mesh_meta = {"1x4": (1, 4), "2x2": (2, 2)}
    for tag, (dd, mm) in mesh_meta.items():
        el = o[f"{tag}/elastic"]
        assert el["step"] == 2
        for k, p in _flat(el["params"]):
            assert torch.equal(p, first[k]), (tag, k)
        for part in ("mu", "nu"):
            want = dict(_flat(o["restart/first_state"][part]))
            for k, p in _flat(el[part]):
                assert torch.equal(p, want[k]), (tag, k)
        specs = el["expert_specs"]
        assert specs["blocks/pos0/moe/wi"] == (
            None, "model", "data" if dd > 1 else None, None)
    cfg = R.train_config()
    like = lm.init_params(torch.Generator().manual_seed(9), cfg,
                          device="cpu")
    step, (params, state), _ = ckpt.load(d, (like, optim.init(like)),
                                         step=2)
    assert step == 2 and int(state.step) == 2
    for k, p in _flat(params):
        assert torch.equal(p, first[k]), k
    assert any("moe" in k for k in first)
    assert not any(S.is_dtensor(t) for t in optim.tree_leaves(params))
