"""Training under a mesh on four gloo ranks on the CPU (one launch for the
module: the ranks run ``tests/_torch_train_mesh_ranks.py`` as
subprocesses, on a 2x2, a 4x1 and a 1x4 mesh, and import no JAX), held to
the reference's meshless functions and to the port's unsharded runs.  The
reference's own mesh paths fail under jax 0.9.0, so its oracle is always
its meshless ``make_train_step``, computed here while the ranks run.

  * init under a mesh: every leaf's gathered blocks ``torch.equal`` to the
    unsharded init from the same seed; each rank's params + mu + nu the
    bytes the abstract specs place, at most 0.3 of the unsharded on 2x2;
  * step 1 from the reference's params and AdamW state carried over
    through the bridge onto each mesh (smoke llama, fp32 compute, 2
    microbatches, quant none and mixed): the loss, grad norm, every
    gradient leaf and the new params within ``tests/test_torch_train.py``'s
    tolerances of the reference (their reasons are stated there; the mesh
    adds the sums over ranks, a reordering of fp32 sums: measured 5.5e-7
    of a leaf's largest entry at worst against the unsharded port), every
    rank reporting the same loss; the mu and nu that come back gathered to
    the logical layout;
  * step 1 with the bf16 compute copy on (a wider smoke llama, whose
    matrices pass the 65536-element rule) against the unsharded port;
  * a 2x2 restart ``torch.equal`` to straight steps; its checkpoint
    reloaded on 1x4 and on 2x2, and here with no mesh by the port and by
    the reference's ``checkpoint.load``, equal to the logical arrays;
  * a fault injected on every rank, then a resume; a fault on one rank
    raising on every rank;
  * ``launch.train --mesh 2x2 --device cpu --smoke`` under
    ``torch.distributed.run``;
  * smoke granite (MoE) trains under ``run_training(mesh=)`` on 2x2; with 6
    experts on 1x4 its grouped GEMMs take the ATen route, counted
    (``tests/test_torch_moe_mesh.py`` holds MoE under a mesh to the
    unsharded port);
  * every model admitted under a mesh, each data rank cutting the same
    rows of a vision model's ``frontend_embeds`` and an encoder-decoder's
    ``enc_frames`` as of its tokens (``tests/test_torch_recurrent_mesh.py``
    and ``tests/test_torch_frontend_mesh.py`` train them); the refusal of a
    batch that does not split over microbatches x data ranks.
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
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _torch_train_mesh_ranks as R  # noqa: E402

WORLD = 4
MESHES = ["2x2", "4x1", "1x4"]
# tests/test_torch_train.py's tolerances, its reasons stated there
GRAD_TOL = 1e-5
GRAD_TOL_Q = 1e-4
LOSS_RTOL = 1e-5
# Step 1 with the bf16 compute copy against the unsharded port: the same
# function on both sides, rounded to bf16 in another order.  A weight's
# gradient is rounded once after its fp32 sum over the data ranks, where
# one bf16 ulp is at most 2^-7 = 7.8e-3 of the leaf's largest entry; but
# the bf16 gradients passed between layers, and the embedding's bf16
# scatter-add on each rank's rows, round too, and those roundings compound,
# so no ulp count bounds the distance: the gates are measured.  Over 4 init
# seeds x 2 depths (2 and 3 periods, 2x2): the loss within 1.9e-7
# relative, the grad norm 4.9e-6 to 2.7e-5, the worst leaf 4.1e-3 to
# 7.6e-3 of its largest entry (embed in 7 of 8; this case 6.4e-3).
BF16_LOSS_RTOL = 1e-5
BF16_NORM_RTOL = 1e-4
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


def _jax_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _inputs():
    """The reference's params (smoke llama, seed 5), an AdamW state with
    nonzero moments, and the global batch, as numpy."""
    jcfg = jax_get_config("llama3.2-1b", smoke=True).scaled_down(
        compute_dtype="float32", n_microbatches=2)
    jparams = jax_lm.init_params(jax.random.PRNGKey(5), jcfg)
    params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape))
                      .astype(np.float32), params)
    nu = jax.tree.map(lambda a: (1e-6 * np.abs(rng.standard_normal(
        a.shape))).astype(np.float32), params)
    batch = jax_data.DataIterator(jax_data.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=R.SEQ, global_batch=R.BATCH,
        seed=3)).peek(2)
    return params, (np.int32(0), mu, nu), batch


def _oracles(params, state, batch):
    """The reference's meshless step 1 and its mean gradient over the 2
    microbatches, for quant none and mixed."""
    out = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_optim.OptState(*jax.tree.map(jnp.asarray, state))
    for quant in ("none", "mixed"):
        jcfg = jax_get_config("llama3.2-1b", smoke=True,
                              quant=quant).scaled_down(
            compute_dtype="float32", n_microbatches=2)
        step = jax.jit(jax_steps.make_train_step(
            jcfg, jax_optim.AdamWConfig(**R.OCFG)))
        new, new_state, metrics = step(jparams, jstate, jb)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jax_lm.loss_fn(p, jcfg, b)))
        half = R.BATCH // 2
        grads = None
        for i in range(2):
            _, g = vg(jparams, {k: v[i * half:(i + 1) * half]
                                for k, v in jb.items()})
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        out[quant] = {"params": _jax_np(new), "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "grads": _jax_np(jax.tree.map(lambda g: g / 2, grads)),
                      "mu": _jax_np(new_state.mu),
                      "nu": _jax_np(new_state.nu)}
    return out


def _launcher(port):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(port), "-m", "repro_torch.launch.train",
         "--mesh", "2x2", "--device", "cpu", "--smoke", "--quant", "mixed",
         "--steps", "2", "--seq-len", "16", "--global-batch", "4"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks (and the launcher), compute the reference's
    oracles meanwhile; return (every rank's outputs, the oracles, the
    launcher's (code, stdout, stderr), seconds the ranks took)."""
    work = str(tmp_path_factory.mktemp("train_mesh"))
    params, state, batch = _inputs()
    torch.save({"params": params, "state": state, "batch": batch},
               os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_train_mesh_ranks.py"),
         str(r), str(WORLD), str(port), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    launcher = _launcher(_free_port())
    try:
        oracles = _oracles(params, state, batch)
        logs = [p.communicate(timeout=600)[0] for p in procs]
        seconds = time.monotonic() - t0
        lout, lerr = launcher.communicate(timeout=600)
    finally:
        for p in procs + [launcher]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return outs, oracles, (launcher.returncode, lout, lerr), seconds


def _close_to_max(got, ref, tol, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def test_ranks_ran_on_three_meshes(ranks, record_property):
    outs, _, _, seconds = ranks
    record_property("ranks_seconds", seconds)     # reported, not gated
    for tag, shape in (("2x2", (2, 2)), ("4x1", (4, 1)), ("1x4", (1, 4))):
        coords = sorted((o["coord"][tag]["data"], o["coord"][tag]["model"])
                        for o in outs)
        assert coords == sorted((d, m) for d in range(shape[0])
                                for m in range(shape[1])), tag


@pytest.mark.parametrize("mesh", MESHES)
def test_init_under_mesh_is_the_unsharded_init(ranks, mesh):
    outs, _, _, _ = ranks
    for o in outs:
        assert o[f"{mesh}/init_equal"]
        assert o[f"{mesh}/dtensors"] > 0
        assert o[f"{mesh}/resident"] == o[f"{mesh}/planned"]
    if mesh == "2x2":
        for o in outs:
            assert o["2x2/resident"] <= 0.3 * o["2x2/whole"], \
                (o["2x2/resident"], o["2x2/whole"])


@pytest.mark.parametrize("quant", ["none", "mixed"])
@pytest.mark.parametrize("mesh", MESHES)
def test_step_one_matches_reference(ranks, mesh, quant):
    outs, oracles, _, _ = ranks
    ref = oracles[quant]
    key = f"{mesh}/{quant}"
    losses = {o[f"{key}/loss"] for o in outs}
    assert len(losses) == 1, losses                  # every rank alike
    assert {o[f"{key}/grad_norm"] for o in outs} == \
        {outs[0][f"{key}/grad_norm"]}
    o = outs[0]
    np.testing.assert_allclose(o[f"{key}/loss"], ref["loss"],
                               rtol=LOSS_RTOL)
    assert o[f"{key}/grad_loss"] == o[f"{key}/loss"]
    np.testing.assert_allclose(o[f"{key}/grad_norm"], ref["grad_norm"],
                               rtol=GRAD_TOL_Q)
    tol = GRAD_TOL if quant == "none" else GRAD_TOL_Q
    ref_grads = dict(_flat(ref["grads"]))
    grads = dict(_flat(o[f"{key}/grads"]))
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        _close_to_max(g.numpy(), ref_grads[name], tol, f"{key} grad {name}")
    ref_params = dict(_flat(ref["params"]))
    for name, p in _flat(o[f"{key}/params"]):
        # as tests/test_torch_train.py's step test bounds it
        err = float(np.abs(p.numpy() - ref_params[name]).max())
        assert err <= 1e-2 * R.OCFG["lr"], (key, name, err)
    step, mu, nu = o[f"{key}/state"]
    assert int(step) == 1
    for got, want in ((mu, ref["mu"]), (nu, ref["nu"])):
        for (name, a), (_, b) in zip(_flat(got), _flat(want)):
            _close_to_max(a, b, tol, f"{key} state {name}")


def test_step_one_with_bf16_copy_against_unsharded_port(ranks):
    outs, _, _, _ = ranks
    res = outs[0]["2x2/bf16"]
    np.testing.assert_allclose(res["loss"], res["loss0"],
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(res["grad_norm"], res["grad_norm0"],
                               rtol=BF16_NORM_RTOL)
    worst = max(res["grad_dist"].values())
    assert worst <= BF16_GRAD_TOL, res["grad_dist"]
    assert len(res["grad_dist"]) == len(list(_flat(lm.init_params(
        torch.Generator(), R.bf16_config(), device="meta"))))


def test_restart_on_mesh_is_bit_exact(ranks):
    outs, _, _, _ = ranks
    for o in outs:
        assert o["restart/restored_from"] == 2
        assert o["restart/equal"]
        straight, resumed = o["restart/losses"]
        assert sorted(resumed) == [2, 3]
        assert resumed[3] == straight[3]
        assert straight[3] < straight[0]
        assert o["restart/resident"] == o["restart/planned"]


def _saved_arrays(d, step):
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_elastic_reload_on_other_meshes_and_without_one(ranks):
    """The 2x2 run's step-2 checkpoint: the logical arrays the ranks
    gathered, read back on 1x4 and 2x2, here by the port with no mesh and
    by the reference's ``checkpoint.load``."""
    outs, _, _, _ = ranks
    o = outs[0]
    d = o["ckpt_dir"]
    arrays = _saved_arrays(d, 2)
    saved = {"0||" + k.replace(".", "||"): p.numpy()
             for k, p in _flat(o["restart/first_params"])}
    for part in ("mu", "nu"):
        saved.update({f"1||{part}||" + k.replace(".", "||"): p.numpy()
                      for k, p in _flat(o["restart/first_state"][part])})
    assert int(arrays["1||step"]) == 2
    for key, want in saved.items():
        assert np.array_equal(arrays[key], want), key
    for tag in ("1x4", "2x2"):
        el = o[f"{tag}/elastic"]
        assert el["step"] == 2 and el["dtensors"] > 0
        for k, p in _flat(el["params"]):
            assert np.array_equal(p.numpy(), arrays["0||" +
                                                    k.replace(".", "||")]), k
        for part in ("mu", "nu"):
            for k, p in _flat(el["state"][part]):
                assert np.array_equal(
                    p.numpy(), arrays[f"1||{part}||" + k.replace(".", "||")])
    cfg = R.config("mixed")
    like = lm.init_params(torch.Generator().manual_seed(9), cfg,
                          device="cpu")
    step, (params, state), _ = ckpt.load(d, (like, optim.init(like)),
                                         step=2)
    assert step == 2 and int(state.step) == 2
    first = dict(_flat(o["restart/first_params"]))
    for k, p in _flat(params):
        assert torch.equal(p, first[k]), k
    jlike = (jax.tree.map(np.asarray, bridge.tree_to_numpy(like)),
             jax_optim.OptState(*bridge.opt_state_to_numpy(optim.init(like))))
    jstep, (jparams, jstate), _ = jax_ckpt.load(d, jlike, step=2)
    assert jstep == 2 and int(jstate.step) == 2
    for k, a in _flat(jparams):
        assert np.array_equal(np.asarray(a), arrays["0||" +
                                                    k.replace(".", "||")]), k


def test_fault_on_every_rank_then_resume(ranks):
    outs, _, _, _ = ranks
    for o in outs:
        assert o["fault/raised"] == "injected"
        assert o["fault/latest"] == 1
        assert o["fault/resumed"] == (1, 3)


def test_fault_on_one_rank_raises_on_every_rank(ranks):
    outs, _, _, _ = ranks
    for r, o in enumerate(outs):
        want = "injected on rank 3" if r == 3 else \
            "a fault on another rank at step 0"
        assert o["fault/one"] == want


def test_launcher_trains_on_a_2x2_mesh(ranks):
    _, _, (code, out, err), _ = ranks
    assert code == 0, err[-4000:]
    done = [ln for ln in out.splitlines() if ln.startswith("done:")]
    assert len(done) == 4, out
    assert all("step=2" in ln and "mesh=2x2" in ln for ln in done)
    assert {ln.split("loss=")[1].split()[0] for ln in done} != {"None"}
    assert len({ln.split("loss=")[1].split()[0] for ln in done}) == 1


def test_batch_that_does_not_split_is_refused(ranks):
    outs, _, _, _ = ranks
    for o in outs:
        assert "does not split into 2 microbatches x 2 data ranks" in \
            o["refusal/batch"]


class _Mesh:
    """A mesh's names and sizes at one data coordinate (what a batch's cut
    reads)."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}
    device_type = "cpu"

    def __init__(self, data: int = 0):
        self.coord = [data, 0]

    def get_coordinate(self):
        return self.coord


def test_granite_trains_under_a_mesh(ranks):
    outs, _, _, _ = ranks
    losses = outs[0]["moe/losses"]
    assert sorted(losses) == [0, 1]
    assert all(np.isfinite(v) for v in losses.values())
    for o in outs:
        assert o["moe/losses"] == losses            # every rank alike
        assert o["moe/resident"][0] == o["moe/resident"][1]


def test_indivisible_experts_train_on_aten_route_counted(ranks):
    outs, _, _, _ = ranks
    for o in outs:
        odd = o["moe/odd"]
        np.testing.assert_allclose(odd["loss"], odd["loss0"], rtol=LOSS_RTOL)
        grouped = sum(n for key, n in odd["fallbacks"].items()
                      if key[2] == "expert dim 6 not divisible by model "
                      "axis (4)")
        # 3 expert GEMMs a layer, 2 layers, each twice under remat (the
        # forward and the backward's recompute), one microbatch
        assert grouped == 3 * 2 * 2
        assert odd["routes"][("cuda", "aten_fallback")] == \
            sum(odd["fallbacks"].values())
        assert odd["routes"][("cuda", "cuda")] > 0
        # the backward with the experts whole on every model rank (each
        # forms every expert's dW, cut to its block at rest): each gradient
        # leaf, dx through the loss in the leaves upstream of the expert
        # GEMMs, against the meshless step's in fp32 (6.0e-7 of a leaf's
        # largest entry at worst, moe.wo, measured here)
        experts = [k for k in odd["grad_dist"] if "moe" in k]
        assert {k.rsplit(".", 1)[-1] for k in experts} >= {"wi", "wo",
                                                           "router"}
        for name, d in odd["grad_dist"].items():
            assert d <= GRAD_TOL_Q, (name, d)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_other_models_under_a_mesh_are_refused(arch):
    """No model is refused under a training mesh any more (queue 1 item
    4.2(c) is ported: the recurrent models train in
    tests/test_torch_recurrent_mesh.py, llava and seamless in
    tests/test_torch_frontend_mesh.py); on each data rank of a 2x2 mesh
    every microbatch takes the same rows of every input — a vision model's
    ``frontend_embeds`` and an encoder-decoder's ``enc_frames`` with its
    ``tokens``."""
    from repro_torch.data.pipeline import DataConfig, DataIterator
    cfg = get_config(arch, smoke=True)
    assert not hasattr(steps, "check_mesh")
    batch = {k: torch.from_numpy(v) for k, v in DataIterator(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=R.SEQ, global_batch=R.BATCH,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
        frontend_tokens=cfg.frontend_tokens, encdec=cfg.is_encdec,
        seed=3)).peek(0).items()}
    extra = {"llava-next-mistral-7b": "frontend_embeds",
             "seamless-m4t-medium": "enc_frames"}.get(arch)
    assert set(batch) == {"tokens", "labels", "mask"} | (
        {extra} if extra else set())
    mb, share = R.BATCH // 2, R.BATCH // 4
    for d in range(2):
        micro = steps._microbatch_rows(batch, 2, _Mesh(d))
        for i in range(2):
            got = micro(i)
            assert got.keys() == batch.keys()
            lo = i * mb + d * share
            for key, v in got.items():
                assert torch.equal(v, batch[key][lo:lo + share]), key
