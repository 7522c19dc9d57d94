"""The vision prefix and the encoder-decoder under a mesh on four gloo ranks
on the CPU (one launch for the module: the ranks run
``tests/_torch_frontend_mesh_ranks.py`` as subprocesses, on a 2x2, a 4x1
and a 1x4 mesh, and import no JAX), held to the port's unsharded runs and
to the reference's meshless functions (its own mesh paths fail under jax
0.9.0; its oracles are computed here while the ranks run).  Smoke
llava-next-mistral-7b (8 patch embeddings of 32, 2 kv heads) and smoke
seamless-m4t-medium (2 encoder and 2 decoder periods, 4 kv heads,
32-wide frames), fp32 compute.

  * each rank's blocks drawn leaf by leaf (``init_params(mesh=)``) — the
    projector's ``frontend.w1`` / ``w2``, the encoder's stacks and the
    decoder's ``xattn`` among them — copies of their blocks of the
    unsharded init, the bytes the abstract specs place;
  * step 1 from the reference's params and a nonzero AdamW state through
    the bridge (2 microbatches, each data rank its rows of ``tokens`` and
    of ``frontend_embeds`` / ``enc_frames``) against the port's meshless
    step under mixed (loss, grad norm, every gradient, params, mu, nu) and
    against the reference's meshless mean loss and gradient under quant
    none (``tests/test_torch_train.py``'s tolerances);
  * ``lm.prefill`` (patch embeddings then a prompt; frames to the memory
    then a prompt) and 3 greedy ``decode_step``s on each data rank's
    streams: tokens and every logits row ``torch.equal`` to the unsharded
    calls under mixed and quant none, and under none the reference's
    meshless logits within 1e-4 of their largest entry and its greedy
    tokens;
  * a 2x2 seamless restart ``torch.equal`` to straight steps; its step-2
    checkpoint reloaded on 1x4, the projector, encoder and cross-attention
    leaves among those it holds.
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
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_frontend_mesh_ranks as R  # noqa: E402

WORLD = 4
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# tests/test_torch_train.py's tolerances (its reasons stated there); the
# mesh reorders fp32 sums (the model axis's all-reduced dx and cut heads'
# gradients, the data axes' reduce-scattered dW)
GRAD_TOL = 1e-5
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
# The reference's serve in fp32 (quant none): the logits of the same
# function in another order of sums (tests/test_torch_llava.py and
# tests/test_torch_seamless.py hold them within 1e-4)
SERVE_TOL = 1e-4
# Quant none against the unsharded port: its GEMMs are fp32 matmuls, whose
# CPU kernels block their sums by the row count, which a data rank cuts
# (under mixed every GEMM is an exact integer product, so the rows are
# torch.equal there); 1e-5 of the largest entry is ~20 fp32 ulps of it
NONE_TOL = 1e-5


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


def _jcfg(arch, quant="mixed", **kw):
    return jax_get_config(arch, smoke=True, quant=quant).scaled_down(
        compute_dtype="float32", **kw)


def _inputs():
    """For each model: the reference's params (seed 0) for serving, its
    training params (seed 5) with a nonzero AdamW state, the global batch
    and the serve inputs, as numpy."""
    inp, jparams = {}, {}
    rng = np.random.default_rng(0)
    for arch in R.ARCHS:
        jcfg = _jcfg(arch)
        jparams[arch] = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
        inp[f"params/{arch}"] = jax.tree.map(np.asarray, jparams[arch])
        params = jax.tree.map(np.asarray, jax_lm.init_params(
            jax.random.PRNGKey(5), jcfg))
        mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
            a.shape)).astype(np.float32), params)
        nu = jax.tree.map(lambda a: (1e-6 * np.abs(rng.standard_normal(
            a.shape))).astype(np.float32), params)
        inp[f"train_params/{arch}"] = params
        inp[f"train_state/{arch}"] = (np.int32(0), mu, nu)
        inp[f"batch/{arch}"] = jax_data.DataIterator(jax_data.DataConfig(
            vocab_size=jcfg.vocab_size, seq_len=R.SEQ, global_batch=R.BATCH,
            frontend=jcfg.frontend, frontend_dim=jcfg.frontend_dim,
            frontend_tokens=jcfg.frontend_tokens, encdec=jcfg.is_encdec,
            seed=3)).peek(2)
        serve = {"tokens": rng.integers(1, jcfg.vocab_size, (
            R.STREAMS, R.PROMPT)).astype(np.int32)}
        if jcfg.frontend == "vision":
            serve["frontend_embeds"] = rng.standard_normal(
                (R.STREAMS, jcfg.frontend_tokens, jcfg.frontend_dim)
            ).astype(np.float32)
        else:
            serve["enc_frames"] = rng.standard_normal(
                (R.STREAMS, R.FRAMES, jcfg.frontend_dim)).astype(np.float32)
        inp[f"serve/{arch}"] = serve
    return inp


def _oracles(inp):
    """The reference's meshless mean loss and gradient over the 2
    microbatches (quant none) and its serve (quant none): the prefill's and
    every greedy step's logits and tokens."""
    out = {}
    for arch in R.ARCHS:
        jcfg = _jcfg(arch, "none")
        jp = jax.tree.map(jnp.asarray, inp[f"train_params/{arch}"])
        jb = {k: jnp.asarray(v) for k, v in inp[f"batch/{arch}"].items()}
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jax_lm.loss_fn(p, jcfg, b)))
        half = R.BATCH // 2
        loss, grads = 0.0, None
        for i in range(2):
            li, g = vg(jp, {k: v[i * half:(i + 1) * half]
                            for k, v in jb.items()})
            loss += float(li) / 2
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        out[f"step/{arch}"] = {
            "loss": loss, "grads": jax.tree.map(
                lambda g: np.asarray(g / 2, np.float32), grads)}
        sp = jax.tree.map(jnp.asarray, inp[f"params/{arch}"])
        serve = {k: jnp.asarray(v) for k, v in inp[f"serve/{arch}"].items()}
        extra = {k: v for k, v in serve.items() if k != "tokens"}
        logits, cache, mem = jax.jit(lambda p, t, c, e: jax_lm.prefill(
            p, jcfg, t, c, **e))(sp, serve["tokens"],
                                 jax_lm.init_cache(jcfg, R.STREAMS,
                                                   R.MAX_SEQ), extra)
        step = jax.jit(lambda p, t, c, pos, m: jax_lm.decode_step(
            p, jcfg, t, c, pos, m))
        res = {"logits": [np.asarray(logits)],
               "tokens": [np.asarray(jnp.argmax(logits, -1))]}
        t = R.PROMPT + (jcfg.frontend_tokens if jcfg.frontend == "vision"
                        else 0)
        for i in range(R.NEW):
            logits, cache = step(sp, jnp.asarray(res["tokens"][-1]), cache,
                                 jnp.int32(t + i), mem)
            res["logits"].append(np.asarray(logits))
            res["tokens"].append(np.asarray(jnp.argmax(logits, -1)))
        out[f"serve/{arch}"] = res
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks, compute the reference's oracles meanwhile;
    return (every rank's outputs, the oracles, seconds the ranks took)."""
    work = str(tmp_path_factory.mktemp("frontend_mesh"))
    inputs = _inputs()
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_frontend_mesh_ranks.py"),
         str(r), str(WORLD), str(port), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        oracles = _oracles(inputs)
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
    return outs, oracles, seconds


def _close_to_max(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def test_ranks_ran_on_three_meshes(ranks, record_property):
    outs, _, seconds = ranks
    record_property("ranks_seconds", seconds)     # reported, not gated
    for tag, shape in MESHES.items():
        coords = sorted((o["coord"][tag]["data"], o["coord"][tag]["model"])
                        for o in outs)
        assert coords == sorted((d, m) for d in range(shape[0])
                                for m in range(shape[1])), tag


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_draws_the_front_end_leaves_as_blocks(ranks, mesh, arch):
    outs, _, _ = ranks
    for o in outs:
        got = o[f"{mesh}/init/{arch}"]
        assert got["bad"] == []
        assert got["resident"] == got["planned"]
    if mesh == "2x2":
        sharded = set(outs[0][f"{mesh}/init/{arch}"]["sharded"])
        assert {"frontend/w1", "frontend/w2"} <= sharded
        if arch == "seamless-m4t-medium":
            assert {"encoder/pos0/attn/wq", "encoder/pos0/mlp/wi",
                    "blocks/pos0/xattn/wk", "blocks/pos0/xattn/wo"} \
                <= sharded


def _step(outs, key):
    res = [o[key] for o in outs]
    for r in res:
        assert r["mesh"]["loss"] == res[0]["mesh"]["loss"]   # every rank
        assert r["mesh"]["grad_norm"] == res[0]["mesh"]["grad_norm"]
    return res[0]["mesh"], res[0]["plain"]


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_one_matches_meshless_port(ranks, mesh, arch):
    outs, _, _ = ranks
    got, ref = _step(outs, f"{mesh}/step/{arch}")
    assert got["step"] == ref["step"] == 1
    assert got["grad_loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=GRAD_TOL_Q)
    assert set(got["routes"]) == {("cuda", "cuda")}
    if mesh != "4x1":
        assert "frontend/w1" in got["dtensors"]
    seen = set()
    for part in ("grads", "mu", "nu"):
        mine, theirs = dict(_flat(got[part])), dict(_flat(ref[part]))
        assert mine.keys() == theirs.keys()
        for name, g in mine.items():
            seen.add(name.split(".")[0])
            _close_to_max(g.numpy(), theirs[name].numpy(), GRAD_TOL_Q,
                          f"{mesh} {part} {name}")
    assert "frontend" in seen
    if arch == "seamless-m4t-medium":
        assert {"encoder", "enc_ln_f"} <= seen
    theirs = dict(_flat(ref["params"]))
    for name, p in _flat(got["params"]):
        # as tests/test_torch_train.py's step test bounds it
        err = float((p - theirs[name]).abs().max())
        assert err <= 1e-2 * R.OCFG["lr"], (mesh, name, err)


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_one_matches_meshless_reference(ranks, mesh, arch):
    """Quant none: the mean loss and every gradient leaf against the
    reference's meshless ``value_and_grad`` of ``loss_fn`` over the same 2
    microbatches."""
    outs, oracles, _ = ranks
    got, _ = _step(outs, f"{mesh}/step/{arch}")
    ref = oracles[f"step/{arch}"]
    np.testing.assert_allclose(got["none"]["loss"], ref["loss"],
                               rtol=LOSS_RTOL)
    theirs = dict(_flat(ref["grads"]))
    mine = dict(_flat(got["none"]["grads"]))
    assert mine.keys() == theirs.keys()
    for name, g in mine.items():
        assert float(g.abs().max()) > 0, name
        _close_to_max(g.numpy(), theirs[name], GRAD_TOL, f"{mesh} {name}")


@pytest.mark.parametrize("quant", ["mixed", "none"])
@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_equals_unsharded(ranks, mesh, arch, quant):
    """Each rank's prefill and decode on its data rank's streams: tokens
    equal to the unsharded calls' rows, every logits row ``torch.equal``
    under mixed (within NONE_TOL under quant none); seamless's memory this
    data rank's rows, every head."""
    outs, oracles, _ = ranks
    d, m = MESHES[mesh]
    cfg = R.config(arch)
    for o in outs:
        got = o[f"{mesh}/serve/{arch}/{quant}"]
        lo, hi = got["rows"]
        assert hi - lo == R.STREAMS // d
        for a, b in zip(got["logits"], got["plain"]["logits"]):
            if quant == "mixed":
                assert torch.equal(a, b[lo:hi])
            else:
                _close_to_max(a.numpy(), b[lo:hi].numpy(), NONE_TOL,
                              f"{mesh} {arch} unquantized logits")
        for a, b in zip(got["tokens"], got["plain"]["tokens"]):
            assert torch.equal(a, b[lo:hi])
        if cfg.is_encdec:
            assert got["mem_shape"] == (cfg.n_periods, R.STREAMS // d,
                                        R.FRAMES, cfg.n_kv_heads,
                                        cfg.head_dim)
        assert got["cache_kv_heads"] == (cfg.n_kv_heads // m if
                                         cfg.n_kv_heads % m == 0 else
                                         cfg.n_kv_heads)
        if quant == "none":
            ref = oracles[f"serve/{arch}"]
            for a, b in zip(got["logits"], ref["logits"]):
                _close_to_max(a.numpy(), b[lo:hi], SERVE_TOL,
                              f"{mesh} {arch} logits")
            for a, b in zip(got["tokens"], ref["tokens"]):
                np.testing.assert_array_equal(a.numpy(), b[lo:hi])


def test_restart_on_mesh_is_bit_exact(ranks):
    outs, _, _ = ranks
    for o in outs:
        assert o["restart/restored_from"] == 2
        assert o["restart/equal"]
        straight, resumed = o["restart/losses"]
        assert sorted(resumed) == [2]
        assert resumed[2] == straight[2]


def test_elastic_checkpoint_reloads_on_1x4(ranks):
    """The 2x2 run's step-2 checkpoint (seamless): the logical arrays the
    ranks gathered — the projector's, the encoder's and the
    cross-attention's among them — read back on 1x4 with every leaf held
    as its spec places it there."""
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
    # the projector's first GEMM: its 32 frame features over no data axis
    # (1x4), its d_model columns over model; the encoder's and the
    # cross-attention's projections as the decoder's
    assert specs["frontend/w1"] == (None, "model")
    assert specs["encoder/pos0/attn/wq"] == (None, None, "model")
    assert specs["blocks/pos0/xattn/wk"] == (None, None, "model")
    assert specs["enc_ln_f/scale"] == (None,)
