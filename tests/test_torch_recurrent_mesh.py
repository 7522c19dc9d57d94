"""RWKV and mamba under a mesh on four gloo ranks on the CPU (one launch for
the module: the ranks run ``tests/_torch_recurrent_mesh_ranks.py`` as
subprocesses, on a 2x2 and then a 1x4 mesh, and import no JAX), held to
the port's unsharded runs and, for the engine's greedy tokens, to the
reference's meshless JAX engine (the reference's own mesh paths fail under
jax 0.9.0, so they are not the oracle; its oracles are computed here while
the ranks run).  Smoke rwkv6-3b (4 heads of 16) and smoke jamba (one
period: 7 mamba layers of d_inner 128, 1 attention layer of 2 kv heads, 4
MoE layers of 4 experts), fp32 compute, mixed.

  * the engine with ``mesh=``: tokens and every sampled logits row
    ``torch.equal`` to the unsharded engine, greedy tokens equal to the JAX
    engine's, every WKV launch over H / model heads and every scan over
    d_inner / model channels, every parameter leaf a copy of its
    ``leaf_spec`` block and every pool leaf its ``page_pool_sharding``
    block (on 1x4 jamba's 2 kv heads do not divide: attention whole);
  * step 1 from the reference's params and a nonzero AdamW state through
    ``bridge.params_from_jax(mesh=)`` / ``opt_state_from_jax(mesh=)`` (2
    microbatches) against the port's meshless step from the same inputs:
    the loss, the grad norm, every gradient leaf — ``u``, ``a_log`` and the
    other leaves every model rank cuts its block from among them — params,
    mu and nu in fp32, and the gradients with the bf16 compute copy on;
    the backward kernels' plain versions over the rank's heads and
    channels;
  * where ``model`` does not divide the heads (3 heads on 2x2) every rank
    runs them all, with the unsharded tokens and gradients;
  * a 2x2 restart of jamba ``torch.equal``; its step-2 checkpoint reloaded
    on 1x4.
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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_recurrent_mesh_ranks as R  # noqa: E402

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# tests/test_torch_train_mesh.py's tolerances (tests/test_torch_train.py
# states their reasons): the mesh reorders fp32 sums (the model axis's
# all-reduced dx and cut tensors' gradients, the data axes' reduce-scattered
# dW)
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
# With the bf16 compute copy each cast weight's gradient rounds to bf16
# after its fp32 sums, which the mesh reorders: one bf16 ulp is at most
# 2^-7 = 7.8e-3 of a leaf's largest entry (test_torch_train_mesh.py's
# bf16 gate).
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
    tensors and the reference's own; for training (seed 5; the bf16 runs
    with the MLPs widened) numpy params and a nonzero AdamW state; the
    global batch."""
    inp, jparams = {}, {}
    rng = np.random.default_rng(0)
    for arch in R.ARCHS:
        jparams[arch] = jax_lm.init_params(jax.random.PRNGKey(0), _jcfg(arch))
        inp[f"params/{arch}"] = bridge.params_from_jax(
            jax.tree.map(np.asarray, jparams[arch]))
        for suffix, kw in (("", {}), ("/bf16", dict(d_ff=R.BF16_D_FF))):
            params = jax.tree.map(np.asarray, jax_lm.init_params(
                jax.random.PRNGKey(5), _jcfg(arch, **kw)))
            mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
                a.shape)).astype(np.float32), params)
            nu = jax.tree.map(lambda a: (1e-6 * np.abs(rng.standard_normal(
                a.shape))).astype(np.float32), params)
            inp[f"train_params/{arch}{suffix}"] = params
            inp[f"train_state/{arch}{suffix}"] = (np.int32(0), mu, nu)
    jcfg = _jcfg(R.ARCHS[0])
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
    work = str(tmp_path_factory.mktemp("recurrent_mesh"))
    inputs, jparams = _inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_recurrent_mesh_ranks.py"),
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


def _blocks(arch, m):
    """(WKV heads, scan channels, grouped experts, attention kv heads) a
    model rank runs at ``model`` = m: each a block where m divides it."""
    cfg = R.config(arch)
    div = lambda n: n // m if n % m == 0 else n  # noqa: E731
    if arch == "rwkv6-3b":
        return [div(cfg.d_model // cfg.rwkv_head_dim)], [], [], None
    return [], [div(cfg.expand * cfg.d_model)], [div(cfg.n_experts)], \
        div(cfg.n_kv_heads)


def test_ranks_ran_on_two_meshes(ranks, record_property):
    outs, _, seconds = ranks
    record_property("ranks_seconds", seconds)     # reported, not gated
    for tag, shape in MESHES.items():
        coords = sorted((o["coord"][tag]["data"], o["coord"][tag]["model"])
                        for o in outs)
        assert coords == sorted((d, m) for d in range(shape[0])
                                for m in range(shape[1])), tag


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
    heads, channels, experts, _ = _blocks(arch, m)
    got = [o[f"{mesh}/engine/{arch}"] for o in outs]
    tokens = got[0]["tokens"]
    for g in got:
        assert g["tokens"] == tokens == g["plain"]["tokens"]
        assert g["widths"]["wkv"] == heads
        assert g["widths"]["ssm_scan"] == channels
        assert g["widths"]["grouped"] == experts
        # the unsharded engine runs every head, channel and expert
        assert g["plain"]["widths"]["wkv"] == _blocks(arch, 1)[0]
        assert g["plain"]["widths"]["ssm_scan"] == _blocks(arch, 1)[1]
        assert set(g["routes"]) == {("cuda", "cuda")}
        assert g["fallbacks"] == {}
        assert g["blocks_ok"]
    n_rows = _engine_rows_equal(outs, got, d)
    # every model rank of a data rank holds the same rows
    assert n_rows == sum(len(t) for t in tokens) * m
    assert _greedy(tokens) == _greedy(jax_tokens[arch])
    assert sum(len(t) for t in tokens) > len(tokens)    # decode ran


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_on_blocks_drawn_leaf_by_leaf(ranks, mesh, arch):
    """Records drawn leaf by leaf as each rank's blocks
    (``lm.init_params(mesh=..., prequant=)``; the engine keeps them as
    they are held) serve the unsharded engine's tokens and logits rows on
    the whole records from the same generator; each leaf its block of
    those, the resident bytes those the abstract specs place."""
    outs, _, _ = ranks
    d, _ = MESHES[mesh]
    got = [o[f"{mesh}/drawn/{arch}"] for o in outs]
    for g in got:
        assert g["tokens"] == g["plain"]["tokens"]
        assert g["blocks_ok"]
        assert g["resident"] == g["planned"]
    assert _engine_rows_equal(outs, got, d) > 0


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_pool_holds_its_blocks(ranks, mesh, arch):
    """Each rank's pool: its data rank's rows, and its ``model`` block of
    the recurrent state — rwkv's heads, mamba's inner channels, attention's
    kv heads where they divide (on 1x4 jamba's 2 kv heads do not, so the
    K/V pages hold both); the token shift whole."""
    outs, _, _ = ranks
    d, m = MESHES[mesh]
    heads, channels, _, kv = _blocks(arch, m)
    for o in outs:
        g = o[f"{mesh}/engine/{arch}"]
        for key, shape in g["pool"].items():
            name = key.rsplit("/", 1)[1]
            want = list(g["pool_global"][key])
            want[1] //= d
            if name == "wkv":
                want[2] = heads[0]
            elif name == "ssm":
                want[2] = channels[0]
            elif name == "conv":
                want[3] = channels[0]
            elif name in ("k", "v"):
                want[3] = kv
            else:
                assert name == "shift", key
            assert shape == tuple(want), (key, shape, want)
    if arch == "jamba-v0.1-52b" and mesh == "1x4":
        assert kv == R.config(arch).n_kv_heads


def test_indivisible_heads_run_whole_on_every_rank(ranks):
    """A smoke rwkv6-3b of 3 heads on 2x2 (``model`` 2 does not divide
    them): the pool's ``wkv`` leaf and every WKV launch hold all 3 heads on
    every rank, in serving and in training, and the tokens, logits rows,
    loss and gradients are the unsharded ones."""
    outs, _, _ = ranks
    got = [o["2x2/indivisible"] for o in outs]
    for g in got:
        assert g["tokens"] == g["plain"]["tokens"]
        assert g["widths"]["wkv"] == [3]
        assert all(shape[2] == 3 for key, shape in g["pool"].items()
                   if key.endswith("/wkv"))
        step = g["step"]
        assert step["mesh"]["widths"]["wkv"] == \
            step["mesh"]["widths"]["wkv_bwd"] == [3]
        np.testing.assert_allclose(step["mesh"]["loss"],
                                   step["plain"]["loss"], rtol=LOSS_RTOL)
        theirs = dict(_flat(step["plain"]["grads"]))
        for name, t in _flat(step["mesh"]["grads"]):
            _close_to_max(t.numpy(), theirs[name].numpy(), GRAD_TOL_Q,
                          f"3 heads {name}")
    assert _engine_rows_equal(outs, got, 2) > 0


def _step_pair(outs, key):
    res = [o[key] for o in outs]
    for r in res:
        assert r["mesh"]["loss"] == res[0]["mesh"]["loss"]   # every rank
        assert r["mesh"]["grad_norm"] == res[0]["mesh"]["grad_norm"]
    return res[0]["mesh"], res[0]["plain"]


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_one_matches_meshless_port(ranks, mesh, arch):
    outs, _, _ = ranks
    got, ref = _step_pair(outs, f"{mesh}/step/{arch}")
    assert got["dtensors"] > 0 and got["step"] == ref["step"] == 1
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert got["grad_loss"] == got["loss"]
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=GRAD_TOL_Q)
    heads, channels, experts, _ = _blocks(arch, MESHES[mesh][1])
    assert got["widths"]["wkv"] == got["widths"]["wkv_bwd"] == heads
    assert got["widths"]["ssm_scan"] == got["widths"]["ssm_scan_bwd"] \
        == channels
    assert got["widths"]["grouped"] == experts
    assert set(got["routes"]) == {("cuda", "cuda")}
    cut = {"u"} if arch == "rwkv6-3b" else {"a_log", "d_skip", "dt_bias",
                                            "conv_w", "conv_b"}
    seen = set()
    for part in ("grads", "mu", "nu"):
        mine, theirs = dict(_flat(got[part])), dict(_flat(ref[part]))
        assert mine.keys() == theirs.keys()
        for name, g in mine.items():
            seen.add(name.rsplit(".", 1)[-1])
            _close_to_max(g.numpy(), theirs[name].numpy(), GRAD_TOL_Q,
                          f"{mesh} {part} {name}")
    assert cut <= seen
    theirs = dict(_flat(ref["params"]))
    for name, p in _flat(got["params"]):
        # as tests/test_torch_train.py's step test bounds it
        err = float((p - theirs[name]).abs().max())
        assert err <= 1e-2 * R.OCFG["lr"], (mesh, name, err)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_step_one_with_bf16_copy_against_meshless_port(ranks, arch):
    outs, _, _ = ranks
    got, ref = _step_pair(outs, f"2x2/step/{arch}/bf16")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
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


def test_elastic_checkpoint_reloads_on_1x4(ranks):
    """The 2x2 run's step-2 checkpoint (jamba): the logical arrays the
    ranks gathered, read back on 1x4 with every leaf held as its spec
    places it there."""
    outs, _, _ = ranks
    o = outs[0]
    with np.load(os.path.join(o["ckpt_dir"], "step_00000002",
                              "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    first = dict(_flat(o["restart/first_params"]))
    for k, p in first.items():
        assert np.array_equal(arrays["0||" + k.replace(".", "||")],
                              p.numpy()), k
    el = o["1x4/elastic"]
    assert el["step"] == 2
    for k, p in _flat(el["params"]):
        assert torch.equal(p, first[k]), k
    for part in ("mu", "nu"):
        want = dict(_flat(o["restart/first_state"][part]))
        for k, p in _flat(el[part]):
            assert torch.equal(p, want[k]), (part, k)
    specs = el["specs"]
    # a mamba layer's in_proj: its d_model rows over no data axis (1x4),
    # its 2 x d_inner columns over model; the replicated leaves whole
    assert specs["blocks/pos0/mamba/in_proj"] == (None, None, "model")
    assert specs["blocks/pos0/mamba/a_log"] == (None, None, None)
